"""The Whitted ray tracer as a vectorized, masked depth-first traversal.

A re-design of the ``raytracer`` OpenCL kernel
(src/cl/raytracing.cl:14-195).  The reference gives every pixel its own
work-item running a *recursive-descent* loop over an explicit ray stack
(``rray ray_stack[MAX_DEPTH]``, raytracing.cl:28-39): reflection continues
in place (raytracing.cl:156-159) and dielectric refraction pushes a child
ray (raytracing.cl:161-179), depth-first.

XLA has no per-lane control flow, so here the exact same traversal runs as
one ``lax.while_loop`` over a *batch of pixel lanes*: each iteration performs
one node-visit-or-pop of the reference's DFS for every still-active lane,
with lane-wise ``where`` masks in place of branches.  The traversal order —
and therefore the per-pixel xorshift32 soft-shadow sample sequence
(raytracing.cl:32-34, 96-110) — is reproduced exactly, which is what makes
the 800x600 golden render match the committed ``out/scene.png``.

Key transformation vs the reference stack machine: the top-of-stack ray
lives in flat per-lane registers; the stack arrays hold only *saved parent
continuations* (written on refraction-push, read on pop).  Pop adds the
child's accumulated rgb to the restored parent register
(ray_stack[n-2].rgb += ray_stack[n-1].rgb, raytracing.cl:188), so stack rgb
never needs read-modify-write.

Two loop modes (config.loop):
* ``while`` — lax.while_loop, exits when every lane finished; fast forward
  path (not reverse-differentiable).
* ``scan`` — fixed-trip lax.scan with no-op iterations after a lane
  finishes; reverse-mode differentiable for inverse rendering.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import RenderConfig
from ..scene import Materials, Scene
from ..textures import SceneAssets
from . import primitives as pr

F32 = jnp.float32
I32 = jnp.int32
INF = np.float32(np.inf)


_take = pr.take_rows


class LaneMaterial(NamedTuple):
    """Winning primitive's material, one row per lane."""
    rgb: jnp.ndarray
    ambient: jnp.ndarray
    diffuse: jnp.ndarray
    specular: jnp.ndarray
    shininess: jnp.ndarray
    transparent: jnp.ndarray
    dielectric: jnp.ndarray
    n: jnp.ndarray
    reflectivity: jnp.ndarray
    texture_id: jnp.ndarray
    texture_scale: jnp.ndarray


def _concat_materials(scene: Scene) -> Materials:
    """Sphere + plane + triangle material tables concatenated in the same
    order primitives are tested (spheres first: primitives.cl:337-354, then
    planes: primitives.cl:357-383, then our triangle extension)."""
    parts = [scene.sphere_mat, scene.plane_mat, scene.tri_mat]
    return Materials(*[jnp.concatenate([getattr(p, f) for p in parts], axis=0)
                       for f in Materials._fields])


# ---------------------------------------------------------------------------
# closest-hit / occlusion queries (findSolidIntersection & friends)
# ---------------------------------------------------------------------------

def _sphere_ts(scene: Scene, o, d):
    """[P, S] sphere hit/ts (batched intersect_sphere)."""
    if scene.num_spheres == 0:
        p = o.shape[0]
        return jnp.zeros((p, 0), bool), jnp.zeros((p, 0), F32)
    return pr.intersect_sphere(o[:, None, :], d[:, None, :],
                               scene.sphere_origin[None],
                               scene.sphere_radius[None])


def _plane_ts(scene: Scene, o, d):
    if scene.num_planes == 0:
        p = o.shape[0]
        return jnp.zeros((p, 0), bool), jnp.zeros((p, 0), F32)
    return pr.intersect_plane(o[:, None, :], d[:, None, :],
                              scene.plane_normal[None],
                              scene.plane_point[None])


_TRI_TILE = 512
_TRI_NO_ID = I32(2 ** 30)

def _tri_shard(scene: Scene, tri_axis: str, tri_shards: int):
    """This device's triangle range under scene parallelism.

    Returns (v0, v1, v2, transp [Ts], gid0 traced, n_valid traced): the
    FULL (replicated) triangle tables are padded to ``tri_shards`` equal
    _TRI_TILE-aligned ranges and each device dynamic-slices its own —
    the O(P*T) intersection work is what scene parallelism divides; the
    tables themselves are tiny and stay replicated (SURVEY.md §2
    scene-parallel row: shard primitives, psum the min-reductions)."""
    t_count = scene.num_triangles
    ts = -(-t_count // tri_shards)
    if ts > _TRI_TILE:
        # tile-align big shards so _tri_*_arrays' scan reshape divides;
        # small shards stay fine-grained — rounding them up to a whole
        # 512 tile would idle most devices on small meshes (and make the
        # 8-shard tests exercise a degenerate one-device layout)
        ts = -(-ts // _TRI_TILE) * _TRI_TILE
    pad = tri_shards * ts - t_count
    ai = jax.lax.axis_index(tri_axis)
    gid0 = ai * I32(ts)

    def sl(a):
        widths = ((0, pad),) + ((0, 0),) * (a.ndim - 1)
        return jax.lax.dynamic_slice_in_dim(
            jnp.pad(a, widths), gid0, ts, 0)

    n_valid = jnp.minimum(jnp.maximum(I32(t_count) - gid0, 0), I32(ts))
    return (sl(scene.tri_v0), sl(scene.tri_v1), sl(scene.tri_v2),
            sl(scene.tri_mat.transparent), gid0, n_valid)


def _tri_closest_arrays(v0, v1, v2, n_valid, o, d):
    """Closest hit over one triangle array (padded to _TRI_TILE): returns
    (t_best [P] (inf on miss), idx_best [P] into this array)."""
    p = o.shape[0]
    total = v0.shape[0]

    if total <= _TRI_TILE:
        hit, ts = pr.intersect_triangle(o[:, None, :], d[:, None, :],
                                        v0[None], v1[None], v2[None])
        valid = hit & (jnp.arange(total, dtype=I32)[None, :] < n_valid)
        tsm = jnp.where(valid, ts, INF)
        idx = jnp.argmin(tsm, axis=1).astype(I32)
        return jnp.min(tsm, axis=1), idx

    n_tiles = total // _TRI_TILE
    tiles = (v0.reshape(n_tiles, _TRI_TILE, 3),
             v1.reshape(n_tiles, _TRI_TILE, 3),
             v2.reshape(n_tiles, _TRI_TILE, 3),
             jnp.arange(n_tiles, dtype=I32))

    def body(carry, tile):
        t_best, i_best = carry
        tv0, tv1, tv2, k = tile
        hit, ts = pr.intersect_triangle(o[:, None, :], d[:, None, :],
                                        tv0[None], tv1[None], tv2[None])
        valid = hit & (jnp.arange(_TRI_TILE, dtype=I32)[None, :]
                       + k * _TRI_TILE < n_valid)
        tsm = jnp.where(valid, ts, INF)
        loc = jnp.argmin(tsm, axis=1).astype(I32)
        tmin = jnp.min(tsm, axis=1)
        better = tmin < t_best
        return (jnp.where(better, tmin, t_best),
                jnp.where(better, loc + k * _TRI_TILE, i_best)), None

    (t_best, i_best), _ = jax.lax.scan(
        body, (jnp.full((p,), INF, F32), jnp.zeros((p,), I32)), tiles)
    return t_best, i_best


def _tri_closest(scene: Scene, o, d, tri_axis=None,
                 tri_shards: int = 1) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Closest triangle hit: (t_best [P] (inf on miss), idx_best [P]).

    Tiled scan over triangles so the [P, T] intermediate never materializes
    in device memory for large meshes (BVH-free brute force per the north star).
    With ``tri_axis`` (scene parallelism) each device tests only its
    triangle shard and the winner is reduced with two collectives: a
    pmin of t, then a pmin of the winning GLOBAL id among the devices
    holding that t — lowest id wins exact ties, matching the
    single-device first-in-order rule."""
    t_count = scene.num_triangles
    p = o.shape[0]
    if t_count == 0:
        return jnp.full((p,), INF, F32), jnp.zeros((p,), I32)

    if tri_axis is not None and tri_shards > 1:
        v0, v1, v2, _, gid0, n_valid = _tri_shard(scene, tri_axis,
                                                  tri_shards)
        t_loc, i_loc = _tri_closest_arrays(v0, v1, v2, n_valid, o, d)
        t_g = jax.lax.pmin(t_loc, tri_axis)
        gwin = jnp.where((t_loc == t_g) & jnp.isfinite(t_g),
                         i_loc + gid0, _TRI_NO_ID)
        i_g = jax.lax.pmin(gwin, tri_axis)
        return t_g, jnp.clip(i_g, 0, t_count - 1)

    pad = (-t_count) % _TRI_TILE if t_count > _TRI_TILE else 0
    v0 = jnp.pad(scene.tri_v0, ((0, pad), (0, 0)))
    v1 = jnp.pad(scene.tri_v1, ((0, pad), (0, 0)))
    v2 = jnp.pad(scene.tri_v2, ((0, pad), (0, 0)))
    return _tri_closest_arrays(v0, v1, v2, I32(t_count), o, d)


def _tri_blocker_arrays(v0, v1, v2, transp, n_valid, o, d, tmax,
                        inclusive: bool):
    """(blocked [P] bool, transparent_crossings [P] i32) over one padded
    triangle array."""
    p = o.shape[0]
    total = v0.shape[0]

    def tile_fn(v0t, v1t, v2t, trt, validt):
        hit, ts = pr.intersect_triangle(o[:, None, :], d[:, None, :],
                                        v0t[None], v1t[None], v2t[None])
        within = ts <= tmax[:, None] if inclusive else ts < tmax[:, None]
        rel = hit & within & validt[None, :]
        blocked = jnp.any(rel & ~trt[None, :], axis=1)
        cnt = jnp.sum((rel & trt[None, :]).astype(I32), axis=1)
        return blocked, cnt

    ids = jnp.arange(total, dtype=I32)
    if total <= _TRI_TILE:
        return tile_fn(v0, v1, v2, transp, ids < n_valid)

    n_tiles = total // _TRI_TILE
    tiles = (v0.reshape(n_tiles, _TRI_TILE, 3),
             v1.reshape(n_tiles, _TRI_TILE, 3),
             v2.reshape(n_tiles, _TRI_TILE, 3),
             transp.reshape(n_tiles, _TRI_TILE),
             (ids < n_valid).reshape(n_tiles, _TRI_TILE))

    def body(carry, tile):
        blocked, cnt = carry
        b, c = tile_fn(*tile)
        return (blocked | b, cnt + c), None

    (blocked, cnt), _ = jax.lax.scan(
        body, (jnp.zeros((p,), bool), jnp.zeros((p,), I32)), tiles)
    return blocked, cnt


def _tri_any_blocker(scene: Scene, o, d, tmax, inclusive: bool,
                     tri_axis=None, tri_shards: int = 1):
    """(blocked [P], transparent_crossings_opacity [P]) for shadow/occlusion
    rays against triangles, transparent rule matching the sphere rule
    (primitives.cl:408-424).  Opacity is 0.8^crossings (one 0.8 factor
    per transparent triangle crossed — computed from the crossing COUNT
    so scene-parallel shards combine with one psum).  With ``tri_axis`` the
    blocked flag pmax-reduces and the count psum-reduces."""
    t_count = scene.num_triangles
    p = o.shape[0]
    if t_count == 0:
        return jnp.zeros((p,), bool), jnp.ones((p,), F32)

    if tri_axis is not None and tri_shards > 1:
        v0, v1, v2, transp, _, n_valid = _tri_shard(scene, tri_axis,
                                                    tri_shards)
        blocked, cnt = _tri_blocker_arrays(v0, v1, v2, transp, n_valid, o,
                                           d, tmax, inclusive)
        blocked = jax.lax.pmax(blocked.astype(I32), tri_axis) > 0
        cnt = jax.lax.psum(cnt, tri_axis)
    else:
        pad = (-t_count) % _TRI_TILE if t_count > _TRI_TILE else 0
        v0 = jnp.pad(scene.tri_v0, ((0, pad), (0, 0)))
        v1 = jnp.pad(scene.tri_v1, ((0, pad), (0, 0)))
        v2 = jnp.pad(scene.tri_v2, ((0, pad), (0, 0)))
        transp = jnp.pad(scene.tri_mat.transparent, (0, pad))
        blocked, cnt = _tri_blocker_arrays(v0, v1, v2, transp,
                                           I32(t_count), o, d, tmax,
                                           inclusive)
    opac = jnp.power(F32(0.8), cnt.astype(F32))
    return blocked, opac


def find_light_hit(scene: Scene, o, d, tri_axis=None, tri_shards=1):
    """findLightIntersection (primitives.cl:262-318), lane-vectorized.

    Nearest light hit; occluded if any *non-transparent* sphere or any plane
    (or opaque triangle — extension) lies at t' <= t_light.  The returned
    color reproduces the reference's ``(1/d*d)`` precedence quirk
    (primitives.cl:287): visible lights shine at rgb*I/pi regardless of
    distance.
    """
    num_l = scene.num_lights
    p = o.shape[0]
    if num_l == 0:
        return jnp.zeros((p,), bool), jnp.zeros((p, 3), F32)
    hit_l, t_l = pr.intersect_sphere(o[:, None, :], d[:, None, :],
                                     scene.light_origin[None],
                                     scene.light_radius[None])
    tsm = jnp.where(hit_l, t_l, INF)
    win = jnp.argmin(tsm, axis=1).astype(I32)
    t = jnp.min(tsm, axis=1)
    any_hit = jnp.isfinite(t)
    t_safe = jnp.where(any_hit, t, 1.0)

    interpoint = o + d * t_safe[:, None]
    dd = pr.distance3(o, interpoint)
    dd = jnp.where(dd > 0, dd, 1.0)
    lrgb = _take(scene.light_rgb, win)
    lint = _take(scene.light_intensity, win)
    # literal reproduction of primitives.cl:287 — (1/d*d) == 1
    color = lrgb * (lint * pr.INV_PI * (1.0 / dd * dd))[:, None]

    hs, ts = _sphere_ts(scene, o, d)
    sph_block = jnp.any(hs & (ts <= t[:, None])
                        & ~scene.sphere_mat.transparent[None, :], axis=1) \
        if scene.num_spheres else jnp.zeros((p,), bool)
    hp, tp = _plane_ts(scene, o, d)
    pl_block = jnp.any(hp & (tp <= t[:, None]), axis=1) \
        if scene.num_planes else jnp.zeros((p,), bool)
    tri_block, _ = _tri_any_blocker(scene, o, d, t, inclusive=True,
                                    tri_axis=tri_axis,
                                    tri_shards=tri_shards)

    return any_hit & ~sph_block & ~pl_block & ~tri_block, color


def find_solid_hit(scene: Scene, assets: SceneAssets, o, d,
                   cfg: RenderConfig, tri_axis=None, tri_shards=1):
    """findSolidIntersection (primitives.cl:322-394), lane-vectorized.

    Closest hit over spheres then planes then triangles, first-in-order
    winning exact ties (the reference's strict ``_t >= t`` skip).  Returns
    (hit, eps-offset intersection, normal, LaneMaterial) — with textured
    planes' material.rgb replaced by the texel at the pre-offset hit point
    (primitives.cl:374-377), and sphere hit points offset along the normal
    by EPSILON (primitives.cl:350, 380).
    """
    num_s, num_p = scene.num_spheres, scene.num_planes
    p_lanes = o.shape[0]

    cand = []
    hs, ts = _sphere_ts(scene, o, d)
    if num_s:
        cand.append(jnp.where(hs, ts, INF))
    hp, tp = _plane_ts(scene, o, d)
    if num_p:
        cand.append(jnp.where(hp, tp, INF))
    if cand:
        t_cat = jnp.concatenate(cand, axis=1)
        win = jnp.argmin(t_cat, axis=1).astype(I32)
        t = jnp.min(t_cat, axis=1)
    else:
        win = jnp.zeros((p_lanes,), I32)
        t = jnp.full((p_lanes,), INF, F32)

    t_tri, i_tri = _tri_closest(scene, o, d, tri_axis=tri_axis,
                                tri_shards=tri_shards)
    tri_better = t_tri < t
    t = jnp.where(tri_better, t_tri, t)
    win = jnp.where(tri_better, num_s + num_p + i_tri, win)

    hit = jnp.isfinite(t)
    t_safe = jnp.where(hit, t, 0.0)
    point = o + d * t_safe[:, None]

    # normals
    is_sph = win < num_s
    is_pl = (win >= num_s) & (win < num_s + num_p)
    center = _take(scene.sphere_origin, jnp.clip(win, 0, max(num_s - 1, 0)))
    n_sph = pr.normalize3(point - center)
    pl_idx = jnp.clip(win - num_s, 0, max(num_p - 1, 0))
    n_pl = _take(scene.plane_normal, pl_idx)
    if scene.num_triangles:
        fn = pr.normalize3(pr.cross3(scene.tri_v1 - scene.tri_v0,
                                     scene.tri_v2 - scene.tri_v0))
        n_tri = _take(fn, i_tri)
        # double-faced: orient the geometric normal against the ray
        n_tri = jnp.where((pr.dot3(n_tri, d) > 0)[:, None], -n_tri, n_tri)
    else:
        n_tri = jnp.zeros_like(n_sph)
    normal = jnp.where(is_sph[:, None], n_sph,
                       jnp.where(is_pl[:, None], n_pl, n_tri))

    mats = _concat_materials(scene)
    mat = LaneMaterial(*[_take(getattr(mats, f), win)
                         for f in LaneMaterial._fields])

    # plane texture fetch at the PRE-offset hit point (primitives.cl:377)
    if num_p and assets.textures.size:
        b0_all, b1_all = pr.plane_texture_basis(scene.plane_normal)
        b0 = _take(b0_all, pl_idx)
        b1 = _take(b1_all, pl_idx)
        tex_h, tex_w = assets.textures.shape[1], assets.textures.shape[2]
        tid = jnp.clip(mat.texture_id, 0, assets.textures.shape[0] - 1)
        flat = assets.textures.reshape(-1, 3)
        if cfg.filter == "bilinear":
            ui = pr.dot3(b0, point) * mat.texture_scale
            vi = pr.dot3(b1, point) * mat.texture_scale
            ui = jnp.where(jnp.isfinite(ui), ui, 0.0)
            vi = jnp.where(jnp.isfinite(vi), vi, 0.0)
            tex_rgb = jnp.zeros_like(point)
            for xi, yi, wgt in pr.bilinear_taps(ui, vi, tex_w, tex_h,
                                                wrap=True):
                texel = jnp.take(flat, (tid * tex_h + yi) * tex_w + xi,
                                 axis=0)
                tex_rgb = tex_rgb + wgt[:, None] * texel.astype(F32)
            tex_rgb = tex_rgb / F32(255.0)
        else:
            xi, yi = pr.texture_texel_coords(b0, b1, point,
                                             mat.texture_scale, tex_h, tex_w)
            texel = jnp.take(flat, (tid * tex_h + yi) * tex_w + xi, axis=0)
            tex_rgb = texel.astype(F32) / F32(255.0)
        textured = is_pl & (mat.texture_id >= 0)
        mat = mat._replace(rgb=jnp.where(textured[:, None], tex_rgb, mat.rgb))

    point = point + normal * F32(cfg.epsilon)
    return hit, point, normal, mat


def test_shadow(scene: Scene, sample, point, cfg: RenderConfig,
                tri_axis=None, tri_shards=1):
    """testShadowPath (primitives.cl:396-442), lane-vectorized.

    Shadow feeler from ``point`` toward ``sample`` on the light sphere.
    Each *transparent* sphere crossed multiplies throughput by 0.8
    (TRANSPERENT_THROUGH); any opaque sphere or any plane strictly before
    the light sample fully blocks.  Comparisons are strict ``t' < distance``
    against the unmodified total distance, as in the reference.
    """
    sdir = pr.normalize3(sample - point)
    tmax = pr.distance3(sample, point)

    p_lanes = point.shape[0]
    blocked = jnp.zeros((p_lanes,), bool)
    opacity = jnp.ones((p_lanes,), F32)

    hs, ts = _sphere_ts(scene, point, sdir)
    if scene.num_spheres:
        rel = hs & (ts < tmax[:, None])
        transp = scene.sphere_mat.transparent[None, :]
        blocked |= jnp.any(rel & ~transp, axis=1)
        opacity *= jnp.prod(jnp.where(rel & transp,
                                      F32(cfg.transparent_through),
                                      F32(1.0)), axis=1)
    hp, tp = _plane_ts(scene, point, sdir)
    if scene.num_planes:
        blocked |= jnp.any(hp & (tp < tmax[:, None]), axis=1)
    tri_block, tri_opac = _tri_any_blocker(scene, point, sdir, tmax,
                                           inclusive=False,
                                           tri_axis=tri_axis,
                                           tri_shards=tri_shards)
    blocked |= tri_block
    opacity *= tri_opac
    return jnp.where(blocked, 0.0, opacity)


def sample_skybox(skybox: jnp.ndarray, d, filter: str = "nearest"):
    """Skybox fetch on ray miss (raytracing.cl:61-78): map_to_cube on the
    ray direction, then a v-flipped texel read (raytracing.cl:67 fetches
    row ``height - v``; clamped here where the reference reads out of
    bounds at the seam).  ``filter='bilinear'`` interpolates the 4
    neighboring texels of the continuous cubemap coordinate (no reference
    analog; gives sky radiance a derivative w.r.t. the ray direction)."""
    sky_h, sky_w = skybox.shape[0], skybox.shape[1]
    flat = skybox.reshape(-1, 3)
    if filter == "bilinear":
        uf, vf = pr.map_to_cube_float(d, sky_w // 4)
        yf = jnp.clip(F32(sky_h) - vf, 0.0, F32(sky_h - 1))
        xf = jnp.clip(uf, 0.0, F32(sky_w - 1))
        texel = jnp.zeros(d.shape[:-1] + (3,), F32)
        for xi, yi, wgt in pr.bilinear_taps(xf, yf, sky_w, sky_h,
                                            wrap=False):
            tap = jnp.take(flat, yi * sky_w + xi, axis=0)
            texel = texel + wgt[..., None] * tap.astype(F32)
        return texel / F32(255.0)
    u, v = pr.map_to_cube(d, sky_w // 4)
    y = jnp.clip(sky_h - v, 0, sky_h - 1)
    x = jnp.clip(u, 0, sky_w - 1)
    texel = jnp.take(flat, y * sky_w + x, axis=0)
    return texel.astype(F32) / F32(255.0)


# ---------------------------------------------------------------------------
# the DFS state machine
# ---------------------------------------------------------------------------

class TraceState(NamedTuple):
    # top-of-stack ray, flat registers (one per lane)
    o: jnp.ndarray        # [P, 3] origin
    d: jnp.ndarray        # [P, 3] direction
    c: jnp.ndarray        # [P, 3] accumulated rgb of current ray
    dep: jnp.ndarray      # [P] i32 bounce depth
    f: jnp.ndarray        # [P] throughput (f_stack top, raytracing.cl:30)
    n1: jnp.ndarray       # [P] current medium IoR (n_stack top)
    sp: jnp.ndarray       # [P] i32 stack size
    rng: jnp.ndarray      # [P] u32 xorshift32 state (seeded with pixel id)
    done: jnp.ndarray     # [P] bool
    result: jnp.ndarray   # [P, 3] final color once done
    # saved parent continuations (write on push, read on pop).  Vector
    # stacks are [D, 3, P] — lanes minor — so every stack plane is one
    # contiguous run over the lanes
    s_o: jnp.ndarray      # [D, 3, P]
    s_d: jnp.ndarray      # [D, 3, P]
    s_c: jnp.ndarray      # [D, 3, P]
    s_dep: jnp.ndarray    # [D, P] i32
    s_f: jnp.ndarray      # [D, P]
    s_n: jnp.ndarray      # [D, P]
    it: jnp.ndarray       # [] i32 iteration counter


def _stack_set(arr, lvl, val, mask):
    """arr [D,P]|[D,3,P]; val [P]|[P,3]; write where mask at level lvl."""
    depth = arr.shape[0]
    oh = (jnp.arange(depth, dtype=I32)[:, None] == lvl[None, :]) \
        & mask[None, :]                                    # [D, P]
    if arr.ndim == 3:
        return jnp.where(oh[:, None, :], val.T[None], arr)
    return jnp.where(oh, val[None], arr)


def _stack_get(arr, lvl):
    depth = arr.shape[0]
    oh = jnp.arange(depth, dtype=I32)[:, None] == lvl[None, :]
    if arr.ndim == 3:
        picked = jnp.where(oh[:, None, :], arr, jnp.zeros((), arr.dtype))
        return picked.sum(axis=0).T                        # [P, 3]
    return jnp.where(oh, arr, jnp.zeros((), arr.dtype)).sum(axis=0)


def _init_state(o, d, pixel_ids, cfg: RenderConfig) -> TraceState:
    p = o.shape[0]
    depth = cfg.max_depth
    # every per-lane zero derives from the (possibly manually-sharded) ray
    # inputs, so the scan carry has consistent varying-axis types under
    # shard_map (a plain jnp.zeros literal would be typed as replicated)
    z3 = o.astype(F32) * F32(0.0)                    # [P, 3]
    z1 = jnp.sum(z3, axis=-1)                        # [P]
    zi = z1.astype(I32)
    zd3 = jnp.broadcast_to(z3.T[None], (depth, 3, p))  # [D, 3, P]
    zd1 = jnp.broadcast_to(z1[None], (depth, p))
    return TraceState(
        o=o.astype(F32), d=d.astype(F32), c=z3,
        dep=zi,
        f=z1 + F32(1.0),
        n1=z1 + F32(cfg.default_n),
        sp=zi + I32(1),
        rng=pixel_ids.astype(jnp.uint32),
        done=zi != 0,
        result=z3,
        s_o=zd3,
        s_d=zd3,
        s_c=zd3,
        s_dep=zd1.astype(I32),
        s_f=zd1,
        s_n=zd1,
        it=jnp.zeros((), I32),
    )


def _trace_step(scene: Scene, assets: SceneAssets, cfg: RenderConfig,
                st: TraceState, tri_axis=None,
                tri_shards=1) -> TraceState:
    """One DFS node-visit-or-pop per active lane — the body of the
    reference's nested whiles (raytracing.cl:41-191) flattened into a single
    masked step."""
    active = ~st.done
    overdepth = st.dep >= cfg.max_depth          # inner while cond, :42
    do_work = active & ~overdepth

    light_hit, light_color = find_light_hit(scene, st.o, st.d,
                                            tri_axis, tri_shards)
    solid_hit, point, normal, mat = find_solid_hit(scene, assets, st.o, st.d,
                                                   cfg, tri_axis, tri_shards)
    is_light = do_work & light_hit               # raytracing.cl:48-54
    is_miss = do_work & ~light_hit & ~solid_hit  # :61-81
    is_solid = do_work & ~light_hit & solid_hit

    # skybox gather only when some lane missed (it is the big 50 MB gather)
    # both branches derive from st.d so their outputs carry identical
    # varying-axis types under shard_map manual sharding
    sky = jax.lax.cond(
        jnp.any(is_miss),
        lambda d_: sample_skybox(assets.skybox, d_, cfg.filter),
        lambda d_: d_ * F32(0.0),
        st.d)

    # --- accumulate color in the reference's addition order ---
    c2 = st.c + jnp.where(is_light[:, None], st.f[:, None] * light_color, 0.0)
    c2 = c2 + jnp.where(is_miss[:, None], st.f[:, None] * sky, 0.0)
    c2 = c2 + jnp.where(is_solid[:, None],
                        st.f[:, None] * mat.rgb * mat.ambient[:, None], 0.0)

    # --- direct lighting with stochastic soft shadows (:87-136) ---
    rng = st.rng
    num_l = scene.num_lights
    for i in range(num_l):
        lo = scene.light_origin[i]
        lrad = scene.light_radius[i]
        shadow_dir = pr.normalize3(lo[None, :] - point)
        soft = jnp.zeros_like(st.f)
        for _ in range(cfg.shadow_samples):
            rng, r1 = pr.xorshift32(rng)
            theta = pr.TWO_PI * r1
            rng, r2 = pr.xorshift32(rng)
            phi = pr.PI * r2
            sin_phi = jnp.sin(phi)
            offset = jnp.stack([lrad * sin_phi * jnp.cos(theta),
                                lrad * sin_phi * jnp.sin(theta),
                                lrad * jnp.cos(phi)], axis=-1)
            sample = lo[None, :] + offset
            soft = soft + test_shadow(scene, sample, point, cfg,
                                      tri_axis, tri_shards)
        # shadow_samples == 0 -> unshadowed direct lighting (smooth; used by
        # gradient tests and the 256x256 d1 "diffuse only" stage)
        ssr = (soft / F32(cfg.shadow_samples) if cfg.shadow_samples
               else soft + F32(1.0))
        dd = pr.distance3(lo[None, :], point)
        dd = jnp.where(dd > 0, dd, 1.0)
        # ((rgb*I)*(1/pi)) * 1/(d*d), then *= ssr  (raytracing.cl:118-120)
        lr = (scene.light_rgb[i][None, :] * scene.light_intensity[i]
              * pr.INV_PI) * (1.0 / (dd * dd))[:, None]
        lr = lr * ssr[:, None]
        v = pr.normalize3(st.o - point)
        half = pr.normalize3(v + shadow_dir)
        spec_f = jnp.power(jnp.maximum(0.0, pr.dot3(normal, half)),
                           mat.shininess)
        c2 = c2 + jnp.where(is_solid[:, None],
                            (st.f * mat.specular)[:, None] * lr
                            * spec_f[:, None], 0.0)
        diff_f = jnp.maximum(0.0, pr.dot3(normal, shadow_dir))
        c2 = c2 + jnp.where(is_solid[:, None],
                            (st.f * mat.diffuse)[:, None] * lr
                            * diff_f[:, None], 0.0)
    rng = jnp.where(is_solid, rng, st.rng)  # RNG advances only on solid hits

    # --- reflect / refract continuation (:138-179) ---
    incident = st.d
    n2 = jnp.where(st.n1 == F32(cfg.default_n), mat.n, F32(cfg.default_n))
    fr = pr.schlick(st.n1, n2, incident, normal)
    reflect_amount = jnp.where(mat.dielectric,
                               mat.reflectivity
                               + (1.0 - mat.reflectivity) * fr,
                               mat.reflectivity)
    f_cont = st.f * reflect_amount
    refl_dir = pr.reflect(st.d, normal)
    dep1 = st.dep + 1

    push_try = (is_solid & mat.transparent & (st.sp < cfg.max_depth)
                & (reflect_amount < 1.0))
    entering = st.n1 < n2
    child_o = jnp.where(entering[:, None],
                        point - F32(2.0 * cfg.epsilon) * normal, point)
    refr_normal = jnp.where(entering[:, None], normal, -normal)
    refr_dir, tir = pr.refract(st.n1, n2, incident, refr_normal)
    push = push_try & ~tir

    pop = active & (overdepth | is_light | is_miss)
    finish = pop & (st.sp == 1)
    popm = pop & (st.sp > 1)
    cont = is_solid & ~push  # in-place reflection continuation (incl. TIR)

    # --- stack write (push saves the parent's reflected continuation) ---
    lvl_push = st.sp - 1
    s_o = _stack_set(st.s_o, lvl_push, point, push)
    s_d = _stack_set(st.s_d, lvl_push, refl_dir, push)
    s_c = _stack_set(st.s_c, lvl_push, c2, push)
    s_dep = _stack_set(st.s_dep, lvl_push, dep1, push)
    s_f = _stack_set(st.s_f, lvl_push, f_cont, push)
    s_n = _stack_set(st.s_n, lvl_push, st.n1, push)

    # --- stack read (pop restores the parent, merging child rgb: :188) ---
    lvl_pop = st.sp - 2
    r_o = _stack_get(s_o, lvl_pop)
    r_d = _stack_get(s_d, lvl_pop)
    r_c = _stack_get(s_c, lvl_pop)
    r_dep = _stack_get(s_dep, lvl_pop)
    r_f = _stack_get(s_f, lvl_pop)
    r_n = _stack_get(s_n, lvl_pop)

    def pick(mask, a, b):
        return jnp.where(mask[:, None] if a.ndim == 2 else mask, a, b)

    child_f = st.f * (1.0 - reflect_amount)
    new_o = pick(push, child_o, pick(popm, r_o, pick(cont, point, st.o)))
    new_d = pick(push, refr_dir, pick(popm, r_d, pick(cont, refl_dir, st.d)))
    new_c = pick(push, jnp.zeros_like(c2),
                 pick(popm, r_c + c2, pick(cont | finish, c2, st.c)))
    new_dep = jnp.where(push | cont, dep1, jnp.where(popm, r_dep, st.dep))
    new_f = jnp.where(push, child_f,
                      jnp.where(popm, r_f, jnp.where(cont, f_cont, st.f)))
    new_n1 = jnp.where(push, n2, jnp.where(popm, r_n, st.n1))
    new_sp = st.sp + push.astype(I32) - popm.astype(I32)
    new_done = st.done | finish
    new_result = jnp.where(finish[:, None], c2, st.result)

    return TraceState(o=new_o, d=new_d, c=new_c, dep=new_dep, f=new_f,
                      n1=new_n1, sp=new_sp, rng=rng, done=new_done,
                      result=new_result, s_o=s_o, s_d=s_d, s_c=s_c,
                      s_dep=s_dep, s_f=s_f, s_n=s_n, it=st.it + 1)


def trace_rays(scene: Scene, assets: SceneAssets, o, d, pixel_ids,
               cfg: RenderConfig, tri_axis=None,
               tri_shards: int = 1) -> jnp.ndarray:
    """Trace a batch of rays to completion.  Returns linear rgb [P, 3]
    (unclamped, as accumulated by the reference before the final clamp at
    raytracing.cl:193).

    ``tri_axis`` / ``tri_shards``: scene parallelism (SURVEY.md §2) —
    under ``shard_map`` over a mesh axis of that name, each device tests
    only its 1/tri_shards of the triangles on EVERY query and the
    min/any/count reductions combine across the axis (pmin/pmax/psum);
    rays and all non-triangle work are replicated.  Divides the
    dominant O(rays * triangles) brute-force cost for large meshes; the
    (tiny) scene tables stay replicated.  Composes with pixel row
    sharding on a 2D mesh (parallel/shard.py render_sharded_2d)."""
    st = _init_state(o, d, pixel_ids, cfg)

    if cfg.loop == "while":
        def cond(s: TraceState):
            return jnp.any(~s.done) & (s.it < cfg.max_iters)

        st = jax.lax.while_loop(
            cond, lambda s: _trace_step(scene, assets, cfg, s, tri_axis,
                                        tri_shards), st)
    elif cfg.loop == "scan":
        def body(s, _):
            return _trace_step(scene, assets, cfg, s, tri_axis,
                               tri_shards), None

        st, _ = jax.lax.scan(body, st, None,
                             length=cfg.resolved_scan_iters())
    else:
        raise ValueError(f"unknown loop mode {cfg.loop!r}")

    # lanes that hit the safety cap report their partial accumulation
    return jnp.where(st.done[:, None], st.result, st.c)


def quantize_image(rgb, width: int, height: int) -> jnp.ndarray:
    """clamp to [0,1], scale by 255 and truncate — the reference's output
    packing (raytracing.cl:193-194) minus the 0RGB word packing, as u8
    [H, W, 3] ready for PNG dump (cpu_ray.c:146-150)."""
    q = jnp.clip(rgb, 0.0, 1.0) * F32(255.0)
    return q.astype(jnp.uint8).reshape(height, width, 3)
