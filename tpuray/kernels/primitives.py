"""Vectorized geometry + shading primitives.

A re-design of the reference's OpenCL primitives library
(src/cl/primitives.cl).  Every function here operates on *batches* of rays
— shape [P] / [P, 3] lanes — instead of one ray per work-item, and every
data-dependent branch of the OpenCL source becomes a lane-wise ``jnp.where``
select.  NaN-signalling (the reference's TIR channel,
primitives.cl:138-139) is replaced by explicit boolean masks so gradients
stay clean.

All formulas are reproduced operation-for-operation in float32 (including
the reference's quirks, flagged inline) so the forward render matches the
C/OpenCL renderer to float32 rounding.  Citations point into the
reference's sources.
"""
from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp
import numpy as np

F32 = jnp.float32
INV_PI = np.float32(1.0 / np.pi)       # INVERSE_SQUARE_LIGHT, primitives.cl:6
TWO_PI = np.float32(2.0 * np.pi)
PI = np.float32(np.pi)


# ---------------------------------------------------------------------------
# small vector helpers ([..., 3] layout)
# ---------------------------------------------------------------------------

def dot3(a, b):
    return jnp.sum(a * b, axis=-1)


def length3(v):
    return jnp.sqrt(dot3(v, v))


def normalize3(v):
    """OpenCL normalize(); guarded against zero-length for gradient safety."""
    n2 = dot3(v, v)
    inv = jnp.where(n2 > 0, 1.0 / jnp.sqrt(jnp.where(n2 > 0, n2, 1.0)), 0.0)
    return v * inv[..., None]


def distance3(a, b):
    return length3(a - b)


def take_rows(table, idx):
    """``table[clip(idx)]`` per lane: [N, ...] at idx [P] -> [P, ...].

    An ordinary gather (its gradient a scatter-add into the table); an
    empty table gives zeros."""
    n = table.shape[0]
    if n == 0:
        return jnp.zeros(idx.shape + table.shape[1:], table.dtype)
    return jnp.take(table, jnp.clip(idx, 0, n - 1), axis=0)


def cross3(a, b):
    return jnp.stack([
        a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0],
    ], axis=-1)


# ---------------------------------------------------------------------------
# PRNG — xorshift32, bit-exact vs primitives.cl:116-125
# ---------------------------------------------------------------------------

def xorshift32(state: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """One xorshift32 step per lane.

    Returns (new_state u32, sample f32).  The sample reproduces the
    reference's ``((float)x)/2147483648.0f*2.0f`` (primitives.cl:124): note
    this maps the full u32 range onto **[0, 4)**, not [0, 1) — the soft
    shadow angles therefore over-rotate exactly like the original.
    """
    x = state.astype(jnp.uint32)
    x = x ^ (x << jnp.uint32(13))
    x = x ^ (x >> jnp.uint32(17))
    x = x ^ (x << jnp.uint32(5))
    sample = x.astype(F32) / F32(2147483648.0) * F32(2.0)
    return x, sample


# ---------------------------------------------------------------------------
# reflection / refraction / Fresnel — primitives.cl:127-160
# ---------------------------------------------------------------------------

def sqrt_pos(x):
    """sqrt(max(x, 0)) whose gradient is ZERO (not NaN) where x <= 0.

    ``sqrt(clip(x, 0))`` backward-evaluates to 0 * inf = NaN on clamped
    lanes (TIR rays, degenerate quadratics on dead lanes); the double
    where keeps those cotangents finite."""
    pos = x > 0
    return jnp.where(pos, jnp.sqrt(jnp.where(pos, x, 1.0)), 0.0)


def reflect(incident, normal):
    """primitives.cl:127-130."""
    cos_i = -dot3(normal, incident)
    return incident + (2.0 * cos_i)[..., None] * normal


def refract(n1, n2, incident, normal):
    """primitives.cl:132-144 with the NaN TIR signal replaced by a mask.

    Returns (refracted_dir, tir) where ``tir`` marks total internal
    reflection lanes (whose direction output is unspecified, as the
    reference's is NaN).
    """
    n = n1 / n2
    cos_i = -dot3(normal, incident)
    sin_t2 = n * n * (1.0 - cos_i * cos_i)
    tir = sin_t2 > 1.0
    cos_t = sqrt_pos(1.0 - sin_t2)
    out = n[..., None] * incident + (n * cos_i - cos_t)[..., None] * normal
    return out, tir


def schlick(n1, n2, incident, normal):
    """Schlick Fresnel approximation, primitives.cl:146-160 (including the
    n1 > n2 transmission-angle substitution and the TIR -> 1.0 early-out)."""
    r0 = (n1 - n2) / (n1 + n2)
    r0 = r0 * r0
    cos_x = -dot3(normal, incident)

    n = n1 / n2
    sin_t2 = n * n * (1.0 - cos_x * cos_x)
    tir = sin_t2 > 1.0
    cos_trans = sqrt_pos(1.0 - sin_t2)

    use_trans = n1 > n2
    cos_x = jnp.where(use_trans, cos_trans, cos_x)
    x = 1.0 - cos_x
    fr = r0 + (1.0 - r0) * x * x * x * x * x
    return jnp.where(use_trans & tir, 1.0, fr)


# ---------------------------------------------------------------------------
# intersections — primitives.cl:170-215 + Möller–Trumbore (mesh extension)
# ---------------------------------------------------------------------------

def intersect_sphere(o, d, center, radius):
    """Quadratic sphere test with the reference's far-root fallback
    (primitives.cl:170-195): if the near root is behind the origin the far
    root is used — this is what makes refracted rays exit spheres.

    o, d: [..., 3]; center: [..., 3]; radius: [...].
    Returns (hit mask, t) with t meaningful only where hit.
    """
    v = o - center
    a = dot3(d, d)
    b = dot3(2.0 * v, d)
    c = dot3(v, v) - radius * radius
    disc = b * b - 4.0 * a * c
    has_root = disc >= 0
    sq = jnp.sqrt(jnp.where(has_root, disc, 0.0))
    two_a = 2.0 * a
    t_near = (-b - sq) / two_a
    t_far = (-b + sq) / two_a
    t = jnp.where(t_near < 0, t_far, t_near)
    hit = has_root & (t > 0)
    return hit, t


def intersect_plane(o, d, normal, point):
    """Infinite-plane test, primitives.cl:197-215 (exact b == 0 reject)."""
    b = dot3(d, normal)
    safe_b = jnp.where(b == 0, 1.0, b)
    t = dot3(point - o, normal) / safe_b
    hit = (b != 0) & (t > 0)
    return hit, t


def intersect_triangle(o, d, v0, v1, v2, eps=1e-7):
    """Möller–Trumbore ray/triangle test (extension: the reference has no
    triangles).  Double-faced, no backface culling.  Returns (hit, t)."""
    e1 = v1 - v0
    e2 = v2 - v0
    pvec = cross3(d, e2)
    det = dot3(e1, pvec)
    ok = jnp.abs(det) > eps
    inv_det = 1.0 / jnp.where(ok, det, 1.0)
    tvec = o - v0
    u = dot3(tvec, pvec) * inv_det
    qvec = cross3(tvec, e1)
    v = dot3(d, qvec) * inv_det
    t = dot3(e2, qvec) * inv_det
    hit = ok & (u >= 0) & (v >= 0) & (u + v <= 1.0) & (t > 0)
    return hit, t


# ---------------------------------------------------------------------------
# cubemap direction -> texel (skybox), primitives.cl:14-109
# ---------------------------------------------------------------------------

def _cube_face_coords(x, y, z, face_size: int):
    """Shared core of the cubemap mapping on direction components: per-lane
    fractional in-face coordinates (fu, fv) in [0, 1] plus the face's
    integer texel shifts."""
    ax, ay, az = jnp.abs(x), jnp.abs(y), jnp.abs(z)
    xp, yp, zp = x > 0, y > 0, z > 0

    fs = np.int32(face_size)
    fsf = F32(face_size)

    max_axis = jnp.ones_like(x)
    uc = jnp.zeros_like(x)
    vc = jnp.zeros_like(x)
    shift_u = jnp.zeros_like(x, jnp.int32)
    shift_v = jnp.zeros_like(x, jnp.int32)

    def apply(cond, m, u, v, su, sv, state):
        max_axis, uc, vc, shift_u, shift_v = state
        return (jnp.where(cond, m, max_axis), jnp.where(cond, u, uc),
                jnp.where(cond, v, vc),
                jnp.where(cond, np.int32(su), shift_u),
                jnp.where(cond, np.int32(sv), shift_v))

    state = (max_axis, uc, vc, shift_u, shift_v)
    # order matters — identical to primitives.cl:33-99
    state = apply(xp & (ax >= ay) & (ax >= az), ax, -z, y, fs * 2, fs, state)
    state = apply(~xp & (ax >= ay) & (ax >= az), ax, z, y, 0, fs, state)
    state = apply(yp & (ay >= ax) & (ay >= az), ay, x, -z, fs, fs * 2, state)
    state = apply(~yp & (ay >= ax) & (ay >= az), ay, x, z, fs, 0, state)
    state = apply(zp & (az >= ax) & (az >= ay), az, x, y, fs, fs, state)
    state = apply(~zp & (az >= ax) & (az >= ay), az, -x, y, fs * 3, fs, state)
    max_axis, uc, vc, shift_u, shift_v = state

    safe = jnp.where(max_axis != 0, max_axis, 1.0)
    fu = 0.5 * (uc / safe + 1.0)
    fv = 0.5 * (vc / safe + 1.0)
    return fu, fv, shift_u, shift_v, fsf


def map_to_cube(d, face_size: int):
    """Direction -> integer texel coords in the 4x3 horizontal-cross cubemap.

    Reproduces the reference's six *non-exclusive* if-blocks in source order
    (primitives.cl:33-99): when |x| == |z| etc., the later block wins —
    replicated here by applying the selects in the same order so later
    conditions overwrite earlier ones.
    """
    return map_to_cube_xyz(d[..., 0], d[..., 1], d[..., 2], face_size)


def map_to_cube_xyz(x, y, z, face_size: int):
    """:func:`map_to_cube` on direction components (the GPU kernel's form)."""
    fu, fv, shift_u, shift_v, fsf = _cube_face_coords(x, y, z, face_size)
    u = shift_u + (fu * fsf).astype(jnp.int32)
    v = shift_v + (fv * fsf).astype(jnp.int32)
    return u, v


def map_to_cube_float(d, face_size: int):
    """Continuous cubemap coords (uf, vf): the bilinear-filter analog of
    :func:`map_to_cube` (truncating them reproduces the nearest fetch).
    Differentiable w.r.t. the direction within a face."""
    return map_to_cube_float_xyz(d[..., 0], d[..., 1], d[..., 2], face_size)


def map_to_cube_float_xyz(x, y, z, face_size: int):
    """:func:`map_to_cube_float` on direction components."""
    fu, fv, shift_u, shift_v, fsf = _cube_face_coords(x, y, z, face_size)
    return (shift_u.astype(F32) + fu * fsf,
            shift_v.astype(F32) + fv * fsf)


def bilinear_taps(u, v, w: int, h: int, wrap: bool):
    """4 bilinear taps for continuous texel coords (u, v) with texel values
    located at integer coordinates: returns [(xi, yi, weight)] * 4 with
    integer coords wrapped (euclidean modulo, tiled plane textures) or
    clamped (skybox edges).  No reference analog (primitives.cl:250-256 is
    a nearest integer fetch); the fractional weights are differentiable
    w.r.t. (u, v), which is what gives texture lookups spatial gradients.
    """
    u0f = jnp.floor(u)
    v0f = jnp.floor(v)
    fu = u - u0f
    fv = v - v0f
    u0 = u0f.astype(jnp.int32)
    v0 = v0f.astype(jnp.int32)
    taps = []
    for du, dv, wgt in ((0, 0, (1 - fu) * (1 - fv)),
                        (1, 0, fu * (1 - fv)),
                        (0, 1, (1 - fu) * fv),
                        (1, 1, fu * fv)):
        xi, yi = u0 + du, v0 + dv
        if wrap:
            xi = jnp.mod(xi, np.int32(w))
            yi = jnp.mod(yi, np.int32(h))
        else:
            xi = jnp.clip(xi, 0, np.int32(w - 1))
            yi = jnp.clip(yi, 0, np.int32(h - 1))
        taps.append((xi, yi, wgt))
    return taps


# ---------------------------------------------------------------------------
# plane texture basis + texel coords, primitives.cl:217-259
# ---------------------------------------------------------------------------

def plane_texture_basis(normal):
    """Per-plane tangent basis (primitives.cl:219-235): the first of the
    three axis unit vectors whose cross with the normal has nonzero
    component-sum supplies basis[0] = cross(e_i, n); basis[1] = cross(n, b0).

    normal: [P, 3] -> (b0 [P, 3], b1 [P, 3]).
    """
    ones = jnp.ones(normal.shape[:-1] + (3,), normal.dtype)
    eye = jnp.eye(3, dtype=normal.dtype)
    cr0 = cross3(jnp.broadcast_to(eye[0], normal.shape), normal)
    cr1 = cross3(jnp.broadcast_to(eye[1], normal.shape), normal)
    cr2 = cross3(jnp.broadcast_to(eye[2], normal.shape), normal)
    ok0 = dot3(ones, cr0) != 0
    ok1 = dot3(ones, cr1) != 0
    b0 = jnp.where(ok0[..., None], cr0, jnp.where(ok1[..., None], cr1, cr2))
    b1 = cross3(normal, b0)
    return b0, b1


def texture_texel_coords(b0, b1, point, scale, tex_h: int, tex_w: int):
    """(ui, vi) -> wrapped integer texel coords (primitives.cl:237-248).

    C truncation-toward-zero for the (int) casts, then euclidean modulo
    (primitives.cl:162-168); jnp's float->int32 convert truncates toward
    zero and ``jnp.mod`` with a positive modulus is already euclidean.
    """
    ui = dot3(b0, point) * scale
    vi = dot3(b1, point) * scale
    ui = jnp.where(jnp.isfinite(ui), ui, 0.0)
    vi = jnp.where(jnp.isfinite(vi), vi, 0.0)
    xi = jnp.mod(ui.astype(jnp.int32), np.int32(tex_w))
    yi = jnp.mod(vi.astype(jnp.int32), np.int32(tex_h))
    return xi, yi
