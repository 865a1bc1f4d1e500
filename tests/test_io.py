"""Image I/O, generated assets and the compile-cache setting."""
import os
import struct
import zlib

import jax
import numpy as np
import pytest

from tpuray.io import decode_png, encode_png, read_png, write_png
from tpuray.textures import seeded_assets
from tpuray.utils.compile_cache import REPO_CACHE_DIR, enable_compile_cache


def test_png_roundtrip(tmp_path):
    img = np.random.default_rng(3).integers(0, 256, (17, 29, 3),
                                            dtype=np.uint8)
    path = str(tmp_path / "x.png")
    write_png(path, img)
    with open(path, "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"
    np.testing.assert_array_equal(read_png(path), img)


def _png(rows: bytes, w: int, h: int, ctype: int, extra=b"") -> bytes:
    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data)))
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0,
                                         0))
            + extra + chunk(b"IDAT", zlib.compress(rows))
            + chunk(b"IEND", b""))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


@pytest.mark.parametrize("ctype", [2, 6])
def test_png_decodes_every_row_filter(ctype):
    """Rows filtered None, Sub, Up, Average and Paeth (PNG spec §9.2), as
    other encoders write them, decode to the original pixels."""
    ch = 3 if ctype == 2 else 4
    w, h = 7, 5
    img = np.random.default_rng(ctype).integers(0, 256, (h, w, ch),
                                                dtype=np.uint8)
    flat = img.reshape(h, w * ch).astype(int)
    rows = b""
    for y in range(h):
        kind = y % 5
        out = []
        for x in range(w * ch):
            a = flat[y, x - ch] if x >= ch else 0
            b = flat[y - 1, x] if y else 0
            c = flat[y - 1, x - ch] if y and x >= ch else 0
            pred = [0, a, b, (a + b) >> 1, _paeth(a, b, c)][kind]
            out.append((flat[y, x] - pred) & 0xFF)
        rows += bytes([kind] + out)
    got = decode_png(_png(rows, w, h, ctype))
    np.testing.assert_array_equal(got, img[..., :3])


def test_png_decodes_palette_and_grey():
    pal = np.array([[10, 20, 30], [200, 100, 0]], np.uint8)
    rows = bytes([0, 0, 1, 1]) + bytes([0, 1, 0, 0])
    plte = (struct.pack(">I", 6) + b"PLTE" + pal.tobytes()
            + struct.pack(">I", zlib.crc32(b"PLTE" + pal.tobytes())))
    got = decode_png(_png(rows, 3, 2, 3, plte))
    np.testing.assert_array_equal(got, pal[[[0, 1, 1], [1, 0, 0]]])
    grey = decode_png(_png(bytes([0, 7, 250]), 2, 1, 0))
    np.testing.assert_array_equal(grey, [[[7] * 3, [250] * 3]])
    with pytest.raises(ValueError, match="not a PNG"):
        decode_png(b"GIF89a")
    assert encode_png(np.zeros((1, 1, 3), np.uint8))[:4] == b"\x89PNG"


def test_seeded_assets_are_deterministic_at_reference_sizes():
    a = seeded_assets(7)
    b = seeded_assets(7)
    c = seeded_assets(8)
    assert a.textures.shape == (4, 256, 256, 3)
    assert a.skybox.shape == (3072, 4096, 3)
    assert a.textures.dtype == a.skybox.dtype == np.uint8
    np.testing.assert_array_equal(np.asarray(a.textures),
                                  np.asarray(b.textures))
    np.testing.assert_array_equal(np.asarray(a.skybox), np.asarray(b.skybox))
    assert (np.asarray(a.skybox) != np.asarray(c.skybox)).mean() > 0.5
    # no two neighbouring texels alike: a wrong texel index shows
    assert (np.diff(np.asarray(a.skybox[:64].astype(int)), axis=1)
            != 0).mean() > 0.9
    with pytest.raises(ValueError, match="4x3"):
        seeded_assets(0, skybox_shape=(100, 100))


@pytest.fixture
def restore_cache_dir():
    old = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", old)


def test_compile_cache_follows_the_environment(monkeypatch, tmp_path,
                                               restore_cache_dir):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    jax.config.update("jax_compilation_cache_dir", "/untouched")
    assert enable_compile_cache() == str(tmp_path)
    # JAX reads the variable itself; the helper sets nothing
    assert jax.config.jax_compilation_cache_dir == "/untouched"


def test_compile_cache_defaults_to_the_repo(monkeypatch, restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert enable_compile_cache() == REPO_CACHE_DIR
    assert jax.config.jax_compilation_cache_dir == REPO_CACHE_DIR
    assert os.path.basename(REPO_CACHE_DIR) == ".jax_cache"
    assert os.path.isfile(os.path.join(os.path.dirname(REPO_CACHE_DIR),
                                       "tpuray", "config.py"))
