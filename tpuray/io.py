"""Image I/O + golden-image comparison.

``write_png``/``read_png`` are the analog of png_dump (cpu_ray.c:108-165)
and the wrapper's PNG loader (opencl_wrap.c:241-320), written with ``zlib``
and numpy alone: 8-bit RGB out; 8-bit grey, grey+alpha, RGB, RGBA and
palette images in (alpha dropped), non-interlaced.

``image_diff_stats`` quantifies closeness of two renders, e.g. a render and
the reference's committed ``out/scene.png`` (SURVEY.md §4).
"""
from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass

import numpy as np

_PNG_SIG = b"\x89PNG\r\n\x1a\n"
# colour type -> samples per pixel (PNG spec §11.2.2)
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(img_u8: np.ndarray) -> bytes:
    """[H, W, 3] u8 -> PNG bytes (8-bit RGB, filter 0 on every row)."""
    img = np.ascontiguousarray(np.asarray(img_u8, np.uint8))
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"expected an [H, W, 3] image, got {img.shape}")
    h, w, _ = img.shape
    raw = np.zeros((h, 1 + 3 * w), np.uint8)
    raw[:, 1:] = img.reshape(h, 3 * w)
    return (_PNG_SIG
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + _chunk(b"IEND", b""))


def _unfilter(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row PNG filters (spec §9.2)."""
    rows = raw.reshape(h, 1 + stride)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        kind = rows[y, 0]
        line = rows[y, 1:].astype(np.int32)
        if kind == 0:
            cur = line
        elif kind == 2:                                   # Up
            cur = (line + prev) & 0xFF
        elif kind == 1:                                   # Sub
            cur = (np.cumsum(line.reshape(-1, bpp), axis=0)
                   .reshape(-1)) & 0xFF
        elif kind in (3, 4):                              # Average, Paeth
            cur = line.copy()
            for x in range(stride):
                a = cur[x - bpp] if x >= bpp else 0
                b = prev[x]
                if kind == 3:
                    pred = (a + b) >> 1
                else:
                    c = prev[x - bpp] if x >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (
                        b if pb <= pc else c)
                cur[x] = (cur[x] + pred) & 0xFF
        else:
            raise ValueError(f"bad PNG filter type {kind}")
        out[y] = cur
        prev = cur
    return out


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> [H, W, 3] u8 RGB."""
    if data[:8] != _PNG_SIG:
        raise ValueError("not a PNG file")
    pos, idat, palette, hdr = 8, [], None, None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    w, h, depth, ctype, _, _, interlace = hdr
    if depth != 8 or interlace or ctype not in _CHANNELS:
        raise ValueError(f"unsupported PNG: bit depth {depth}, colour type "
                         f"{ctype}, interlace {interlace} (8-bit, "
                         "non-interlaced only)")
    ch = _CHANNELS[ctype]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    px = _unfilter(raw, h, w * ch, ch).reshape(h, w, ch)
    if ctype == 3:
        return palette[px[..., 0]]
    if ch <= 2:
        return np.repeat(px[..., :1], 3, axis=-1)
    return np.ascontiguousarray(px[..., :3])


def write_png(path: str, img_u8: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(img_u8))


def read_png(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_png(f.read())


@dataclass
class DiffStats:
    mean_abs: float          # mean |a-b| over all channels, 0..255 scale
    max_abs: float
    frac_within_1: float     # fraction of channel values within +-1
    frac_within_4: float
    frac_within_8: float
    psnr: float

    def __str__(self):
        return (f"mean|d|={self.mean_abs:.3f} max|d|={self.max_abs:.0f} "
                f"<=1:{self.frac_within_1:.4f} <=4:{self.frac_within_4:.4f} "
                f"<=8:{self.frac_within_8:.4f} psnr={self.psnr:.1f}dB")


def image_diff_stats(a: np.ndarray, b: np.ndarray) -> DiffStats:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.shape != b.shape:
        raise ValueError(f"shape mismatch {a.shape} vs {b.shape}")
    d = np.abs(a - b)
    mse = float(np.mean(d * d))
    psnr = 99.0 if mse == 0 else 10.0 * np.log10(255.0 ** 2 / mse)
    return DiffStats(mean_abs=float(d.mean()), max_abs=float(d.max()),
                     frac_within_1=float((d <= 1).mean()),
                     frac_within_4=float((d <= 4).mean()),
                     frac_within_8=float((d <= 8).mean()),
                     psnr=psnr)
