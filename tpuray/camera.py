"""Camera model and perspective-basis math.

The equivalent of the reference's host camera layer (cpu_ray.{h,c}):
``rinit_camera`` (cpu_ray.c:24-35), ``rlookat`` (cpu_ray.c:37-39) and
``rgen_perspective`` (cpu_ray.c:42-106), plus the spherical-angle camera
controls of the GUI app (rayinteractive.c:85-92).

The perspective construction is reproduced formula-for-formula in float32
(including the *unnormalized* right/up basis vectors — the reference builds
them with raw cross products and never normalizes, cpu_ray.c:82-91 — and
the world-up (0,1,0) convention), so that ray directions match the OpenCL
``raygen`` kernel (raygen.cl:16-21) to float32 rounding.

All math is jnp so the basis is differentiable w.r.t. camera parameters and
can be traced under jit; validation (fov range, gimbal lock) runs on concrete
values only.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import jax.numpy as jnp
import numpy as np

_FLT_EPSILON = np.float32(1.1920929e-07)


@dataclasses.dataclass
class Camera:
    """Position + look direction + intrinsics (cpu_ray.h:19-26)."""
    origin: Tuple[float, float, float]
    lookdir: Tuple[float, float, float]   # normalized on construction
    fov: float = 90.0                     # degrees
    focal_length: float = 1.0

    def __post_init__(self):
        d = np.asarray(self.lookdir, np.float32)
        n = np.float32(1.0) / np.float32(np.sqrt(np.float32(
            d[0] * d[0] + d[1] * d[1] + d[2] * d[2])))
        self.lookdir = tuple(np.float32(x * n) for x in d)

    def lookat(self, direction) -> "Camera":
        """rlookat (cpu_ray.c:37-39): replace the look direction."""
        return Camera(self.origin, tuple(direction), self.fov,
                      self.focal_length)

    def with_spherical(self, x_rot: float, y_rot: float) -> "Camera":
        """Spherical-angle look direction, y-up (rayinteractive.c:85-92)."""
        d = (np.sin(x_rot) * np.cos(y_rot), np.cos(x_rot),
             np.sin(x_rot) * np.sin(y_rot))
        return self.lookat(d)

    def moved(self, delta) -> "Camera":
        o = tuple(np.float32(a + b) for a, b in zip(self.origin, delta))
        return Camera(o, self.lookdir, self.fov, self.focal_length)


class PerspectiveBasis(NamedTuple):
    """The six quantities the reference uploads as raygen kernel args
    (raypng.c:50-57)."""
    corner: jnp.ndarray    # [3] vector to image left-TOP corner
    origin: jnp.ndarray    # [3] camera origin
    up: jnp.ndarray        # [3] (unnormalized)
    right: jnp.ndarray     # [3] (unnormalized)
    w_factor: jnp.ndarray  # [] image-plane step per pixel column
    h_factor: jnp.ndarray  # [] image-plane step per pixel row


def _cross(a, b):
    return jnp.stack([
        a[1] * b[2] - a[2] * b[1],
        a[2] * b[0] - a[0] * b[2],
        a[0] * b[1] - a[1] * b[0],
    ])


def perspective_basis(camera: Camera, width: int, height: int,
                      validate: bool = True) -> PerspectiveBasis:
    """rgen_perspective (cpu_ray.c:42-106), float32 throughout.

    Rejects fov ~ 180 deg / ~ 0 deg and a look direction equal to world-up
    (gimbal lock) exactly as the reference does (cpu_ray.c:58-62).
    """
    fov = np.float32(camera.fov)
    if validate:
        is_180 = (fov - np.float32(180.0) <= _FLT_EPSILON
                  and fov - np.float32(180.0) >= 0)
        if is_180 or fov <= _FLT_EPSILON or tuple(camera.lookdir) == (0.0, 1.0, 0.0):
            raise ValueError(
                f"invalid camera: fov={camera.fov} lookdir={camera.lookdir} "
                "(fov must be in (0, 180) and lookdir must not equal world-up)")

    f32 = jnp.float32
    origin = jnp.asarray(camera.origin, f32)
    lookdir = jnp.asarray(camera.lookdir, f32)
    top = jnp.array([0.0, 1.0, 0.0], f32)

    half_fov = (fov / f32(360.0)) * f32(np.pi)
    aspect = f32(height) / f32(width)
    fov_tan = jnp.tan(half_fov).astype(f32)

    image_width = fov_tan * f32(camera.focal_length) * 2
    image_height = aspect * image_width

    w_factor = image_width / f32(width)
    h_factor = image_height / f32(height)

    forward = -lookdir
    right = _cross(top, forward)
    up = _cross(forward, right)

    image_center = -forward * f32(camera.focal_length)
    corner = image_center - right * (image_width / 2) + up * (image_height / 2)
    return PerspectiveBasis(corner=corner, origin=origin, up=up, right=right,
                            w_factor=w_factor, h_factor=h_factor)


def generate_rays(basis: PerspectiveBasis, width: int, height: int,
                  row0=0.0):
    """Per-pixel primary rays — the raygen kernel (raygen.cl:5-25) as one
    vectorized jnp expression.

    Pixel id -> (col, row) = (id % width, id // width); the ray direction is
    ``normalize(corner + right*w_factor*col - up*h_factor*row)`` sampled at
    integer pixel offsets (no half-pixel centering), matching raygen.cl:13-16.

    ``row0``: global image row of the first generated row — row-sharded
    rendering generates each shard's rays at their GLOBAL row indices so
    the sharded render is bit-identical to the unsharded one (mirrors the
    GPU kernel's row0, pallas_trace.py).

    Returns (origins [H*W, 3], dirs [H*W, 3]).
    """
    f32 = jnp.float32
    w = jnp.arange(width, dtype=f32)[None, :]    # [1, W]
    h = jnp.arange(height, dtype=f32)[:, None] + row0   # [H, 1]
    vec = (basis.corner[None, None, :]
           + basis.right[None, None, :] * (basis.w_factor * w)[..., None]
           - basis.up[None, None, :] * (basis.h_factor * h)[..., None])
    norm = jnp.sqrt(jnp.sum(vec * vec, axis=-1, keepdims=True))
    dirs = (vec / norm).reshape(-1, 3)
    origins = jnp.broadcast_to(basis.origin, (height * width, 3))
    return origins, dirs
