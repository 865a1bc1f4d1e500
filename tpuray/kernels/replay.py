"""Saved-path replay tracer: the differentiable backward path of the GPU
kernel.

The kernel's record mode (pallas_trace.py, ``record=True``) emits one
compact record per DFS node — hit code + parent slot + branch bit, the
per-light soft-shadow ratios, and the texel the node fetched.  Those records
freeze every *discrete* decision of the traversal: which primitive each ray
hit, which light was seen, where refraction branched, which texel was read,
and what fraction of each area light was occluded (the only RNG-dependent
quantities; all piecewise-constant w.r.t. scene parameters, so recording
them is exact for a.e. gradients).

This module replays the trace densely in pure JAX: for each record slot it
recomputes — differentiably, with no primitive search, no shadow-feeler
storm and no while loop — the hit point from the *recorded* winner id, the
normal, the Phong shading against the recorded shadow ratios, the
Schlick-blended throughput, and both child-ray candidates.  Children find
their parent's ray/throughput via the recorded parent slot.  Summing every
node's local radiance weighted by its throughput reproduces the kernel's
image (tested), and ``jax.grad`` of that replay is the kernel's backward
pass (wired up as a ``jax.custom_vjp`` in tpuray/diff.py).

Reference analog: none — gradients are the north-star extension; the
forward math replayed here is raytracing.cl:41-191 node-for-node.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..camera import PerspectiveBasis, generate_rays
from ..config import RenderConfig
from ..scene import Scene
from ..textures import SceneAssets
from . import primitives as pr

F32 = jnp.float32
INV_PI = np.float32(1.0 / np.pi)
_normalize = pr.normalize3


_sqrt_pos = pr.sqrt_pos
take = pr.take_rows


def _sphere_t(o, d, center, radius, active):
    """Recorded-winner sphere t (far-root rule, primitives.cl:170-195)
    with dead-lane-safe gradients: inactive lanes get a unit ray so the
    quadratic never divides by zero, and the discriminant sqrt is
    gradient-guarded."""
    d = jnp.where(active[:, None], d, jnp.asarray([0.0, 0.0, 1.0], F32))
    v = o - center
    a = pr.dot3(d, d)
    a = jnp.where(a > 0, a, 1.0)
    # dot(2v, d), the op order of primitives.intersect_sphere and the
    # kernel: grazing hits (disc ~ 1e-4 out of b^2 ~ 1e2) amplify any
    # op-order rounding delta ~10x through the Schlick chain (PARITY.md)
    b = pr.dot3(2.0 * v, d)
    c = pr.dot3(v, v) - radius * radius
    sq = _sqrt_pos(b * b - 4.0 * a * c)
    two_a = 2.0 * a
    t_near = (-b - sq) / two_a
    t_far = (-b + sq) / two_a
    return jnp.where(t_near < 0, t_far, t_near)


_MAT_FIELDS = ("ambient", "diffuse", "specular", "shininess",
               "transparent", "dielectric", "n", "reflectivity",
               "texture_id", "texture_scale")


def _solid_tables(scene: Scene):
    """Per-solid parameter tables, spheres first then planes (matching the
    kernel's winner index space: 0..ns-1 spheres, ns..ns+npl-1 planes)."""
    sm, pm = scene.sphere_mat, scene.plane_mat
    rgb = jnp.concatenate([sm.rgb, pm.rgb], axis=0)
    fields = {}
    for f in _MAT_FIELDS:
        a = getattr(sm, f)
        b = getattr(pm, f)
        fields[f] = jnp.concatenate([a.astype(F32), b.astype(F32)])
    return rgb, fields


def replay_render(scene: Scene, assets: SceneAssets,
                  basis: PerspectiveBasis, records: dict,
                  cfg: RenderConfig, row0=0.0) -> jnp.ndarray:
    """Dense differentiable replay of a recorded kernel trace.

    Returns float32 linear rgb [H, W, 3]; equals the kernel render of the
    same (scene, basis) wherever no record slot overflowed.  ``row0`` must
    match the record forward's (row-sharded replay).
    """
    ns, npl, nl = scene.num_spheres, scene.num_planes, scene.num_lights
    if scene.num_triangles:
        raise ValueError("the replay covers spheres, planes and lights; "
                         "differentiate triangle scenes through the tracer")
    if ns + npl > 64 or 64 + nl > 127:
        raise ValueError("replay hit-code space requires <= 64 solids and "
                         "<= 63 lights (code 127 = miss)")
    width, height = cfg.width, cfg.height
    n_pix = width * height
    eps = np.float32(cfg.epsilon)
    default_n = np.float32(cfg.default_n)
    bilin = cfg.filter == "bilinear"

    rec = records["rec"]          # [Krec, n_pix] i32
    ssr = records["ssr"]          # [Krec, nl, n_pix] f32
    picks = records["pick"]       # [Krec, n_pix] i32 recorded texel picks
    Krec = rec.shape[0]

    o0, d0 = generate_rays(basis, width, height, row0)   # [n_pix, 3]

    rgb_tab, mat = _solid_tables(scene)
    sky = assets.skybox.astype(F32) / F32(255.0)    # [Hs, Ws, 3]
    tex = assets.textures.astype(F32) / F32(255.0)  # [N, Ht, Wt, 3]
    sky_h, sky_w = sky.shape[0], sky.shape[1]
    tex_h, tex_w = tex.shape[1], tex.shape[2]
    sky_flat = sky.reshape(-1, 3)
    tex_flat = tex.reshape(-1, 3)

    # plane tangent bases (ray-independent, as in the kernel)
    pb0, pb1 = pr.plane_texture_basis(scene.plane_normal)  # [npl, 3] each

    # per-node child-candidate records: refl (o3 d3 f n1) ++ refr
    # (o3 d3 f n1), one [n_pix, 16] entry per slot (a python list, not a
    # stacked buffer: .at[s].set on a [Krec, n_pix, 16] array costs a
    # whole-buffer copy per slot, and its AD another)
    bufs = []
    img = jnp.zeros((n_pix, 3), F32)

    for s in range(Krec):
        code = rec[s] & np.int32(0xFF)
        pbyte = (rec[s] >> np.int32(8)) & np.int32(0xFF)
        written = rec[s] >= 0

        if s == 0:
            o, d = o0, d0
            f = jnp.where(written, F32(1.0), F32(0.0))
            n1 = jnp.full((n_pix,), default_n)
            valid = written
        else:
            has_par = (pbyte & 0x80) != 0
            branch = (pbyte >> 6) & 1          # 0 = reflect, 1 = refract
            pslot = jnp.clip(pbyte & 0x3F, 0, Krec - 1)
            # Parent-slot structure (the kernel's continuation logic): a
            # node CONTINUING in place — the refract child when the parent
            # pushed, else the reflect child — always lands in the very
            # next record slot (pslot == s-1), while a POPPED node is
            # always the stacked REFLECTED child of an earlier node
            # (pslot <= s-2, branch == 0: the kernel stacks pc_refl only).
            # So the common case is a direct read of bufs[s-1], and only
            # popped reflect children need the masked one-hot sum over the
            # 8-wide reflect half of slots <= s-2 (a one-hot sum instead of
            # a full-width sum over all earlier slots keeps the cost
            # linear in Krec per slot).
            in_place = pslot == np.int32(s - 1)
            par_prev = bufs[s - 1]
            side_prev = jnp.where((branch == 1)[:, None],
                                  par_prev[:, 8:16], par_prev[:, 0:8])
            old = jnp.zeros((n_pix, 8), F32)
            for k in range(s - 1):
                old = old + jnp.where((pslot == k)[:, None],
                                      bufs[k][:, 0:8], 0.0)
            side = jnp.where(in_place[:, None], side_prev, old)
            o = side[:, 0:3]
            d = side[:, 3:6]
            f = side[:, 6]
            n1 = side[:, 7]
            valid = written & has_par
            f = jnp.where(valid, f, 0.0)

        is_sphere = code < ns if ns else jnp.zeros_like(valid)
        is_plane = (code >= ns) & (code < ns + npl)
        is_solid = (is_sphere | is_plane) & valid
        is_light = (code >= 64) & (code < 64 + nl) & valid
        is_miss = (code == 127) & valid

        # ---- light-hit radiance (primitives.cl:262-318 + the (1/d*d)==1
        # quirk at :287 — no distance falloff) ----
        l_rgb = take(scene.light_rgb, code - 64)
        l_i = take(scene.light_intensity, code - 64)
        img = img + jnp.where(is_light, f * l_i * INV_PI, 0.0)[:, None] \
            * l_rgb

        # ---- recorded-winner solid hit, recomputed differentiably ----
        # the recorded winner's rows: every lane reads some row, and the
        # hit-kind masks below keep only the right kind's
        m = {k: take(v, code) for k, v in mat.items()}
        m_rgb = take(rgb_tab, code)

        center = take(scene.sphere_origin, code)
        radius = take(scene.sphere_radius, code)
        t_sph = _sphere_t(o, d, center, radius, is_sphere)
        p_nrm = take(scene.plane_normal, code - ns)
        p_pt = take(scene.plane_point, code - ns)
        _, t_pl = pr.intersect_plane(o, d, p_nrm, p_pt)
        t = jnp.where(is_sphere, t_sph, jnp.where(is_plane, t_pl, 0.0))
        t = jnp.where(is_solid, t, 0.0)
        hit = o + t[:, None] * d
        n_vec = jnp.where(is_sphere[:, None],
                          _normalize(hit - center), p_nrm)
        ph = hit + eps * n_vec

        # ---- texel colours: sky on miss (raytracing.cl:61-81) and plane
        # texture on a textured hit (primitives.cl:217-259).  Texel values
        # are constants; only the weights carry gradients.
        # Nearest: the texel the kernel recorded, so texel-boundary pixels
        # match it exactly.  Bilinear: the 4 taps are recomputed, and their
        # fractional weights give the spatial texture/sky gradient.
        textured = is_solid & is_plane & (m["texture_id"] > -0.5)
        if not bilin:
            pick = jnp.clip(picks[s], 0, None)
            sky_rgb = jnp.take(sky_flat, jnp.minimum(pick, sky_h * sky_w - 1),
                               axis=0)
            texel = jnp.take(tex_flat, jnp.minimum(pick, tex_flat.shape[0]
                                                   - 1), axis=0)
        else:
            b0 = take(pb0, code - ns)
            b1 = take(pb1, code - ns)
            tid = jnp.clip(m["texture_id"].astype(jnp.int32), 0, None)
            ufs, vfs = pr.map_to_cube_float(d, sky_w // 4)
            yfs = jnp.clip(F32(sky_h) - vfs, 0.0, F32(sky_h - 1))
            xfs = jnp.clip(ufs, 0.0, F32(sky_w - 1))
            uif = pr.dot3(b0, hit) * m["texture_scale"]
            vif = pr.dot3(b1, hit) * m["texture_scale"]
            uif = jnp.where(jnp.isfinite(uif), uif, 0.0)
            vif = jnp.where(jnp.isfinite(vif), vif, 0.0)
            sky_rgb = jnp.zeros((n_pix, 3), F32)
            texel = jnp.zeros((n_pix, 3), F32)
            for (sxt, syt, swt), (txt, tyt, twt) in zip(
                    pr.bilinear_taps(xfs, yfs, sky_w, sky_h, wrap=False),
                    pr.bilinear_taps(uif, vif, tex_w, tex_h, wrap=True)):
                sky_rgb = sky_rgb + swt[:, None] * sky[syt, sxt]
                texel = texel + twt[:, None] * tex[tid, tyt, txt]
        img = img + jnp.where(is_miss, f, 0.0)[:, None] * sky_rgb

        # ambient (raytracing.cl:83-84); the texel colour is constant,
        # f/ambient stay differentiable
        amb_rgb = jnp.where(textured[:, None], texel, m_rgb)
        img = img + jnp.where(is_solid, f * m["ambient"], 0.0)[:, None] \
            * amb_rgb

        # direct Phong lighting against recorded shadow ratios
        # (raytracing.cl:87-136 with ssr frozen)
        v_dir = _normalize(o - ph)
        for li in range(nl):
            lo = scene.light_origin[li]
            sd = _normalize(lo[None, :] - ph)
            # gradient-guarded distance: a light landing exactly on the
            # eps-offset hit point must not NaN the backward (sqrt'(0))
            dd2 = pr.dot3(lo[None, :] - ph, lo[None, :] - ph)
            dd = _sqrt_pos(dd2)
            dd = jnp.where(dd2 > 0, dd, 1.0)
            fall = INV_PI * scene.light_intensity[li] / (dd * dd) \
                * ssr[s, li]
            half = _normalize(v_dir + sd)
            ndh = jnp.maximum(0.0, pr.dot3(n_vec, half))
            # the 1e-30 floor keeps pow's gradient finite where ndh == 0
            spec = jnp.power(jnp.maximum(ndh, F32(1e-30)),
                             m["shininess"]) * m["specular"] * f
            ndl = jnp.maximum(0.0, pr.dot3(n_vec, sd))
            diff = ndl * m["diffuse"] * f
            w = jnp.where(is_solid, spec + diff, 0.0) * fall
            img = img + w[:, None] * scene.light_rgb[li][None, :]

        # ---- child candidates (raytracing.cl:138-179) ----
        n2 = jnp.where(n1 == default_n, m["n"], default_n)
        n2 = jnp.where(n2 != 0, n2, 1.0)   # dead-lane guard for n1/n2
        ra_f = pr.schlick(n1, n2, d, n_vec)
        ra = jnp.where(m["dielectric"] > 0.5,
                       m["reflectivity"] + (1.0 - m["reflectivity"]) * ra_f,
                       m["reflectivity"])
        refl_d = pr.reflect(d, n_vec)
        f_refl = jnp.where(is_solid, f * ra, 0.0)

        entering = n1 < n2
        co = jnp.where(entering[:, None], ph - 2.0 * eps * n_vec, ph)
        rn = jnp.where(entering[:, None], n_vec, -n_vec)
        refr_d, tir = pr.refract(n1, n2, d, rn)
        can_refr = is_solid & (m["transparent"] > 0.5) & (ra < 1.0) & ~tir
        f_refr = jnp.where(can_refr, f * (1.0 - ra), 0.0)

        bufs.append(jnp.concatenate([
            ph, refl_d, f_refl[:, None], n1[:, None],
            co, refr_d, f_refr[:, None], n2[:, None]], axis=1))

    return img.reshape(height, width, 3)
