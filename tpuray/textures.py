"""Plane-texture atlas + cubemap skybox.

The analog of ``cl_wrap_load_images`` (opencl_wrap.c:189-349), which loads
N same-size RGB8 PNGs into one OpenCL ``image2d_array``.  Here the atlas is
a single ``[N, H, W, 3] uint8`` device array; texel fetches are gathers, and
the u8 -> float normalization (/255) happens after the gather exactly like
the reference's manual cast (raytracing.cl:71-76, primitives.cl:250-256).

The skybox is a 4x3 horizontal-cross cubemap in a single image
(face_size = width/4, raytracing.cl:62-63); the direction -> texel mapping
lives in :mod:`tpuray.kernels.primitives` (``map_to_cube``).

:func:`seeded_assets` makes images at the reference's sizes from a seed, so
every entry point runs without the reference's asset files;
:func:`load_default_assets` reads those files from a reference checkout.
"""
from __future__ import annotations

import os
from typing import NamedTuple, Sequence

import jax.numpy as jnp
import numpy as np

from .config import reference_path

# Texture load order used by both reference apps (raypng.c:74-78,
# rayinteractive.c:170-174): the ground plane's texture_id=2 is check.png.
DEFAULT_TEXTURES = ("cobblestone.png", "sand.png", "check.png", "grass.png")
DEFAULT_SKYBOX = "bg/stormydays.png"

# The reference's asset sizes (SURVEY.md §1): 256x256 RGB8 textures and a
# 4096x3072 horizontal-cross skybox.
TEXTURE_SIZE = 256
SKYBOX_SHAPE = (3072, 4096)


class SceneAssets(NamedTuple):
    """Device-resident image data for one render."""
    textures: jnp.ndarray  # [N, H, W, 3] u8 plane-texture atlas
    skybox: jnp.ndarray    # [Hs, Ws, 3] u8 4x3-cross cubemap


def _read_png_rgb(path: str) -> np.ndarray:
    from .io import read_png
    return read_png(path)


def load_textures(paths: Sequence[str]) -> jnp.ndarray:
    """Load same-size RGB8 PNGs into a [N, H, W, 3] u8 atlas."""
    imgs = [_read_png_rgb(p) for p in paths]
    shape = imgs[0].shape
    for p, im in zip(paths, imgs):
        if im.shape != shape:
            raise ValueError(f"texture size mismatch: {p} has {im.shape}, "
                             f"expected {shape} (all atlas layers must match, "
                             "as in opencl_wrap.c:223-231)")
    return jnp.asarray(np.stack(imgs))


def load_skybox(path: str) -> jnp.ndarray:
    im = _read_png_rgb(path)
    if im.shape[1] % 4 or im.shape[0] * 4 != im.shape[1] * 3:
        raise ValueError(f"skybox {path} is {im.shape[1]}x{im.shape[0]}; "
                         "expected a 4x3 horizontal-cross cubemap layout")
    return jnp.asarray(im)


def load_default_assets(asset_dir: str = None,
                        skybox: str = DEFAULT_SKYBOX) -> SceneAssets:
    """The exact asset set the reference apps bind (raypng.c:74-81), read
    from a reference checkout (``config.REFERENCE_DIR``/assets by default).

    ``skybox``: cross-layout cubemap path relative to ``asset_dir`` —
    the reference ships two (``bg/stormydays.png``, used, and
    ``bg/lake.png``, the unused alternative; both load here)."""
    if asset_dir is None:
        asset_dir = reference_path("assets")
    tex = load_textures([os.path.join(asset_dir, t) for t in DEFAULT_TEXTURES])
    sky = load_skybox(os.path.join(asset_dir, skybox))
    return SceneAssets(textures=tex, skybox=sky)


def seeded_assets(seed: int = 0, tex_size: int = TEXTURE_SIZE,
                  skybox_shape=SKYBOX_SHAPE) -> SceneAssets:
    """Generated RGB8 images at the reference's sizes, made from ``seed``.

    Four ``tex_size``² textures and one ``skybox_shape`` (rows, cols) cross
    cubemap.  The same seed gives the same bytes."""
    rows, cols = skybox_shape
    if cols % 4 or rows * 4 != cols * 3:
        raise ValueError(f"skybox shape {skybox_shape} is not a 4x3 cross")
    rng = np.random.default_rng(seed)

    def image(shape):
        # 16x16-texel colour patches plus per-texel noise: coarse structure
        # like a photograph, and no two neighbouring texels alike
        coarse = rng.integers(0, 224, shape[:-3] + (-(-shape[-3] // 16),
                                                    -(-shape[-2] // 16), 3))
        coarse = coarse.repeat(16, -3).repeat(16, -2)
        coarse = coarse[..., :shape[-3], :shape[-2], :]
        return (coarse + rng.integers(0, 32, shape)).astype(np.uint8)

    tex = image((len(DEFAULT_TEXTURES), tex_size, tex_size, 3))
    sky = image((rows, cols, 3))
    return SceneAssets(textures=jnp.asarray(tex), skybox=jnp.asarray(sky))


def solid_assets(n_textures: int = 1, tex_size: int = 8,
                 sky_face: int = 4, rgb=(0, 0, 0)) -> SceneAssets:
    """Minimal flat-color assets for tests/scenes without textures."""
    col = np.asarray(rgb, np.uint8)
    tex = np.broadcast_to(col, (n_textures, tex_size, tex_size, 3))
    sky = np.broadcast_to(col, (sky_face * 3, sky_face * 4, 3))
    return SceneAssets(textures=jnp.asarray(np.ascontiguousarray(tex)),
                       skybox=jnp.asarray(np.ascontiguousarray(sky)))
