"""Pallas kernel for the GPU: the full Whitted DFS for a block of pixels.

One program of a 1-D grid owns ``BLOCK`` consecutive pixels and runs the
reference's whole per-pixel traversal (raytracing.cl:14-195) to the end:
primary-ray generation (raygen.cl:5-25), the depth-first reflect/refract
stack machine, Phong direct lighting with xorshift32 soft shadows, and the
plane-texture and skybox texel fetches.  It is the shape of the reference's
OpenCL kernel (one work-item per pixel with an explicit ray stack) written
in Triton's block model: the lanes of a block step together through a
masked ``while_loop`` that ends when the block's own last lane finishes, so
a straggler pixel holds up its block and not, as in the XLA tracer's
whole-chunk loop, every pixel of the chunk.

Data layout:

* the scene and camera basis are one flat f32 table (:func:`pack_uniforms`),
  read as scalars and as per-lane gathers (the winning primitive's material
  and geometry);
* textures and the skybox stay u8 in device memory; a texel fetch is an
  ordinary gather;
* each lane's saved parent rays (11 f32 fields and a depth per level) live
  in a scratch output indexed ``[field * D + level, pixel]``, so lanes at
  one level touch adjacent words.  (One-hot-selected ``[D, BLOCK]`` register
  arrays measured slower at depth 15: they spill.)

The arithmetic follows the XLA tracer (kernels/trace.py) operation for
operation, so the two engines differ only in the last bits of ``sqrt``,
``pow``, ``sin`` and ``cos``.  ``record=True`` also writes the per-node
records that the replay VJP (kernels/replay.py) differentiates.

The kernel is compiled through Triton (``backend="triton"``);
``interpret=True`` runs the same kernel on the CPU, which is how the tests
reach it.
"""
from __future__ import annotations

from typing import Dict, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..camera import PerspectiveBasis
from ..config import RenderConfig
from ..scene import Scene
from ..textures import SceneAssets
from . import primitives as pr

F32 = jnp.float32
I32 = jnp.int32
U32 = jnp.uint32
INF = np.float32(np.inf)

BLOCK = 128        # pixels per program
NUM_WARPS = 4
NF = 11            # f32 stack fields: origin(3), dir(3), rgb(3), f, n

_MAT_FIELDS = ("rgb0", "rgb1", "rgb2", "ambient", "diffuse", "specular",
               "shininess", "transparent", "dielectric", "n", "reflectivity",
               "texture_id", "texture_scale")


# ---------------------------------------------------------------------------
# scene + camera -> one flat f32 table
# ---------------------------------------------------------------------------

def _mat_columns(mat) -> Dict[str, jnp.ndarray]:
    return {"rgb0": mat.rgb[:, 0], "rgb1": mat.rgb[:, 1],
            "rgb2": mat.rgb[:, 2], "ambient": mat.ambient,
            "diffuse": mat.diffuse, "specular": mat.specular,
            "shininess": mat.shininess, "transparent": mat.transparent,
            "dielectric": mat.dielectric, "n": mat.n,
            "reflectivity": mat.reflectivity, "texture_id": mat.texture_id,
            "texture_scale": mat.texture_scale}


def pack_uniforms(scene: Scene, basis: PerspectiveBasis,
                  row0=0.0) -> Tuple[jnp.ndarray, Dict[str, int]]:
    """Flatten scene + basis into one f32 table.

    Returns ``(table, offsets)``: offsets are Python ints taken from the
    static shapes, so value changes reuse the compiled kernel.  Materials
    are indexed by solid id (spheres, then planes).  ``row0`` is the global
    image row of this render's first row (row-sharded rendering keeps ray
    directions and the per-pixel RNG seed identical to the whole image)."""
    npl = scene.num_planes
    if npl:
        b0, b1 = pr.plane_texture_basis(scene.plane_normal)
    else:
        b0 = b1 = jnp.zeros((0, 3), F32)
    sm, pm = _mat_columns(scene.sphere_mat), _mat_columns(scene.plane_mat)
    parts = [("basis", jnp.concatenate([
                 basis.corner, basis.origin, basis.up, basis.right,
                 jnp.stack([basis.w_factor, basis.h_factor])])),
             ("row0", jnp.reshape(jnp.asarray(row0, F32), (1,))),
             ("sph_o", scene.sphere_origin), ("sph_r", scene.sphere_radius),
             ("pl_nrm", scene.plane_normal), ("pl_pt", scene.plane_point),
             ("pl_b0", b0), ("pl_b1", b1)]
    parts += [("mat_" + f, jnp.concatenate([sm[f].astype(F32),
                                            pm[f].astype(F32)]))
              for f in _MAT_FIELDS]
    parts += [("li_o", scene.light_origin), ("li_r", scene.light_radius),
              ("li_i", scene.light_intensity), ("li_rgb", scene.light_rgb)]
    off, flat, cur = {}, [], 0
    for name, arr in parts:
        arr = jnp.asarray(arr, F32).reshape(-1)
        off[name] = cur
        cur += arr.shape[0]
        flat.append(arr)
    return jnp.concatenate(flat), off


# ---------------------------------------------------------------------------
# per-lane math on component vectors (kernel-side forms of primitives.py)
# ---------------------------------------------------------------------------

def _dot(ax, ay, az, bx, by, bz):
    return ax * bx + ay * by + az * bz


def _normalize(x, y, z):
    """primitives.normalize3 on components."""
    n2 = _dot(x, y, z, x, y, z)
    inv = jnp.where(n2 > 0, 1.0 / jnp.sqrt(jnp.where(n2 > 0, n2, 1.0)), 0.0)
    return x * inv, y * inv, z * inv


def _sphere_hit(c, r, px, py, pz, qx, qy, qz):
    """primitives.intersect_sphere (far-root rule, primitives.cl:170-195)."""
    vx, vy, vz = px - c[0], py - c[1], pz - c[2]
    a = _dot(qx, qy, qz, qx, qy, qz)
    b = _dot(2.0 * vx, 2.0 * vy, 2.0 * vz, qx, qy, qz)
    cc = _dot(vx, vy, vz, vx, vy, vz) - r * r
    disc = b * b - 4.0 * a * cc
    has = disc >= 0
    sq = jnp.sqrt(jnp.where(has, disc, 0.0))
    two_a = 2.0 * a
    t_near = (-b - sq) / two_a
    t_far = (-b + sq) / two_a
    t = jnp.where(t_near < 0, t_far, t_near)
    return has & (t > 0), t


def _plane_hit(nrm, pt, px, py, pz, qx, qy, qz):
    """primitives.intersect_plane (primitives.cl:197-215)."""
    b = _dot(qx, qy, qz, *nrm)
    safe_b = jnp.where(b == 0, 1.0, b)
    t = _dot(pt[0] - px, pt[1] - py, pt[2] - pz, *nrm) / safe_b
    return (b != 0) & (t > 0), t


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------

def _make_kernel(off, counts, tex_shape, sky_shape, cfg: RenderConfig,
                 width: int, n_pix: int, record: bool, krec: int,
                 block: int):
    ns, npl, nl = counts
    nsol = ns + npl
    n_tex, tex_h, tex_w = tex_shape
    sky_h, sky_w = sky_shape
    face = sky_w // 4
    D = cfg.max_depth
    eps = np.float32(cfg.epsilon)
    two_eps = np.float32(2.0 * cfg.epsilon)
    through = np.float32(cfg.transparent_through)
    default_n = np.float32(cfg.default_n)
    n_samples = cfg.shadow_samples
    bilinear = cfg.filter == "bilinear"
    textures_on = bool(npl and n_tex)
    n_int = 2 if record else 1               # depth (+ parent code) planes

    def kernel(uni, tex, sky, *outs):
        if record:
            rgb_out, rec_out, ssr_out, pick_out, cnt_out = outs[:5]
            outs = outs[5:]
        else:
            rgb_out = outs[0]
            outs = outs[1:]
        stk_f, stk_i = outs

        base = pl.program_id(0) * block
        pix = base + jnp.arange(block, dtype=I32)
        blk = pl.ds(base, block)

        def u(name, i=0):
            """Static scalar from the table."""
            return uni[off[name] + i]

        def gather(name, idx):
            """Per-lane table read at ``name[idx]``."""
            return plgpu.load(uni.at[off[name] + idx])

        def texel(ref, idx, mask):
            """u8 RGB texel ``idx`` (flat texel index) as f32 0..255."""
            return tuple(plgpu.load(ref.at[idx * 3 + c], mask=mask,
                                    other=0).astype(F32) for c in range(3))

        # ---- raygen (raygen.cl:10-24; camera.generate_rays) ----
        row = pix // width
        col = pix - row * width
        row_f = row.astype(F32) + u("row0")
        w_s = u("basis", 12) * col.astype(F32)
        h_s = u("basis", 13) * row_f
        v = [u("basis", k) + u("basis", 9 + k) * w_s - u("basis", 6 + k) * h_s
             for k in range(3)]
        norm = jnp.sqrt(_dot(*v, *v))
        dx, dy, dz = v[0] / norm, v[1] / norm, v[2] / norm
        zero = jnp.zeros((block,), F32)
        izero = jnp.zeros((block,), I32)
        ox, oy, oz = (zero + u("basis", 3 + k) for k in range(3))
        pid = (row + u("row0").astype(I32)) * width + col

        if record:
            for k in range(krec):
                plgpu.store(rec_out.at[k, blk], izero - 1)
                plgpu.store(pick_out.at[k, blk], izero - 1)
                for li in range(nl):
                    plgpu.store(ssr_out.at[k * nl + li, blk], zero)

        def stack_push(lvl, push, fvals, ivals):
            lc = jnp.maximum(lvl, 0)
            for j, val in enumerate(fvals):
                plgpu.store(stk_f.at[j * D + lc, pix], val, mask=push)
            for j, val in enumerate(ivals):
                plgpu.store(stk_i.at[j * D + lc, pix], val, mask=push)

        def stack_pop(lvl, popm):
            lc = jnp.maximum(lvl, 0)
            fv = [plgpu.load(stk_f.at[j * D + lc, pix], mask=popm,
                             other=0.0) for j in range(NF)]
            iv = [plgpu.load(stk_i.at[j * D + lc, pix], mask=popm, other=0)
                  for j in range(n_int)]
            return fv + iv

        def step(st):
            (ox, oy, oz, dx, dy, dz, cx, cy, cz, f, n1, dep, sp, rng, done,
             it, rec_cnt, pcode) = st
            active = done == 0
            overdepth = dep >= D
            do_work = active & ~overdepth

            # --- findLightIntersection (primitives.cl:262-318) ---
            lt = zero + INF
            lwin = izero
            for i in range(nl):
                c = [u("li_o", 3 * i + k) for k in range(3)]
                h, t = _sphere_hit(c, u("li_r", i), ox, oy, oz, dx, dy, dz)
                tm = jnp.where(h, t, INF)
                better = tm < lt
                lt = jnp.where(better, tm, lt)
                lwin = jnp.where(better, np.int32(i), lwin)
            light_any = lt < INF

            sph = [_sphere_hit([u("sph_o", 3 * i + k) for k in range(3)],
                               u("sph_r", i), ox, oy, oz, dx, dy, dz)
                   for i in range(ns)]
            pln = [_plane_hit([u("pl_nrm", 3 * i + k) for k in range(3)],
                              [u("pl_pt", 3 * i + k) for k in range(3)],
                              ox, oy, oz, dx, dy, dz)
                   for i in range(npl)]
            lblock = izero != 0
            for i, (h, t) in enumerate(sph):
                lblock |= h & (t <= lt) & ~(u("mat_transparent", i) > 0.5)
            for h, t in pln:
                lblock |= h & (t <= lt)
            light_hit = light_any & ~lblock

            # light colour with the (1/d*d)==1 quirk (primitives.cl:287)
            lts = jnp.where(light_any, lt, 1.0)
            ex, ey, ez = (ox - (ox + dx * lts), oy - (oy + dy * lts),
                          oz - (oz + dz * lts))
            ldd = jnp.sqrt(_dot(ex, ey, ez, ex, ey, ez))
            ldd = jnp.where(ldd > 0, ldd, 1.0)
            lsc = gather("li_i", lwin) * pr.INV_PI * (1.0 / ldd * ldd)
            lcol = [gather("li_rgb", 3 * lwin + k) * lsc for k in range(3)]

            # --- findSolidIntersection (primitives.cl:322-394) ---
            bt = zero + INF
            bwin = izero
            for i, (h, t) in enumerate(sph + pln):
                tm = jnp.where(h, t, INF)
                better = tm < bt
                bt = jnp.where(better, tm, bt)
                bwin = jnp.where(better, np.int32(i), bwin)
            solid_hit = bt < INF
            ts = jnp.where(solid_hit, bt, 0.0)
            hx, hy, hz = ox + dx * ts, oy + dy * ts, oz + dz * ts

            win = jnp.clip(bwin, 0, max(nsol - 1, 0))
            m = {k: gather("mat_" + k, win) for k in _MAT_FIELDS}
            is_sph = bwin < ns
            is_pl = (bwin >= ns) & (bwin < nsol)
            si = jnp.clip(bwin, 0, max(ns - 1, 0))
            pi_ = jnp.clip(bwin - ns, 0, max(npl - 1, 0))
            if ns:
                sn = _normalize(hx - gather("sph_o", 3 * si),
                                hy - gather("sph_o", 3 * si + 1),
                                hz - gather("sph_o", 3 * si + 2))
            else:
                sn = (zero, zero, zero)
            if npl:
                pn = [gather("pl_nrm", 3 * pi_ + k) for k in range(3)]
            else:
                pn = [zero, zero, zero]
            nx, ny, nz = (jnp.where(is_sph, sn[k], jnp.where(is_pl, pn[k],
                                                             0.0))
                          for k in range(3))

            is_light = do_work & light_hit
            is_miss = do_work & ~light_hit & ~solid_hit
            is_solid = do_work & ~light_hit & solid_hit

            # plane texture at the pre-offset hit point (primitives.cl:377)
            mrgb = [m["rgb0"], m["rgb1"], m["rgb2"]]
            textured = izero != 0
            tex_pick = izero - 1
            if textures_on:
                textured = is_solid & is_pl & (m["texture_id"] > -0.5)
                tid = jnp.clip(m["texture_id"].astype(I32), 0, n_tex - 1)
                b0 = [gather("pl_b0", 3 * pi_ + k) for k in range(3)]
                b1 = [gather("pl_b1", 3 * pi_ + k) for k in range(3)]
                ui = _dot(*b0, hx, hy, hz) * m["texture_scale"]
                vi = _dot(*b1, hx, hy, hz) * m["texture_scale"]
                ui = jnp.where(jnp.isfinite(ui), ui, 0.0)
                vi = jnp.where(jnp.isfinite(vi), vi, 0.0)
                layer = tid * tex_h
                if bilinear:
                    acc = [zero, zero, zero]
                    for xi, yi, wgt in pr.bilinear_taps(ui, vi, tex_w, tex_h,
                                                        wrap=True):
                        tx = texel(tex, (layer + yi) * tex_w + xi, textured)
                        acc = [a + wgt * t for a, t in zip(acc, tx)]
                else:
                    xi = jnp.mod(ui.astype(I32), np.int32(tex_w))
                    yi = jnp.mod(vi.astype(I32), np.int32(tex_h))
                    tex_pick = (layer + yi) * tex_w + xi
                    acc = texel(tex, tex_pick, textured)
                mrgb = [jnp.where(textured, a / np.float32(255.0), r)
                        for a, r in zip(acc, mrgb)]

            # eps-offset hit point (primitives.cl:350,380)
            px, py, pz = hx + nx * eps, hy + ny * eps, hz + nz * eps

            # --- skybox on miss (raytracing.cl:61-78) ---
            if bilinear:
                uf, vf = pr.map_to_cube_float_xyz(dx, dy, dz, face)
                yf = jnp.clip(np.float32(sky_h) - vf, 0.0,
                              np.float32(sky_h - 1))
                xf = jnp.clip(uf, 0.0, np.float32(sky_w - 1))
                skyc = [zero, zero, zero]
                for xi, yi, wgt in pr.bilinear_taps(xf, yf, sky_w, sky_h,
                                                    wrap=False):
                    tx = texel(sky, yi * sky_w + xi, is_miss)
                    skyc = [a + wgt * t for a, t in zip(skyc, tx)]
                sky_pick = izero - 1
            else:
                uu, vv = pr.map_to_cube_xyz(dx, dy, dz, face)
                sy = jnp.clip(sky_h - vv, 0, sky_h - 1)
                sx = jnp.clip(uu, 0, sky_w - 1)
                sky_pick = sy * sky_w + sx
                skyc = texel(sky, sky_pick, is_miss)
            skyc = [s / np.float32(255.0) for s in skyc]

            # --- colour in the tracer's addition order ---
            c2 = [c + jnp.where(is_light, f * lc, 0.0)
                  for c, lc in zip((cx, cy, cz), lcol)]
            c2 = [c + jnp.where(is_miss, f * s, 0.0) for c, s in zip(c2, skyc)]
            c2 = [c + jnp.where(is_solid, f * r * m["ambient"], 0.0)
                  for c, r in zip(c2, mrgb)]

            # --- direct light with stochastic soft shadows (:87-136) ---
            vx_, vy_, vz_ = _normalize(ox - px, oy - py, oz - pz)
            rng_s = rng
            ssrs = []
            for i in range(nl):
                lo = [u("li_o", 3 * i + k) for k in range(3)]
                lrad = u("li_r", i)
                sdx, sdy, sdz = _normalize(lo[0] - px, lo[1] - py,
                                           lo[2] - pz)
                soft = zero
                for _ in range(n_samples):
                    rng_s, r1 = pr.xorshift32(rng_s)
                    theta = pr.TWO_PI * r1
                    rng_s, r2 = pr.xorshift32(rng_s)
                    phi = pr.PI * r2
                    sin_phi = jnp.sin(phi)
                    smp = (lo[0] + lrad * sin_phi * jnp.cos(theta),
                           lo[1] + lrad * sin_phi * jnp.sin(theta),
                           lo[2] + lrad * jnp.cos(phi))
                    # testShadowPath (primitives.cl:396-442)
                    ex, ey, ez = smp[0] - px, smp[1] - py, smp[2] - pz
                    qx, qy, qz = _normalize(ex, ey, ez)
                    tmax = jnp.sqrt(_dot(ex, ey, ez, ex, ey, ez))
                    blocked = izero != 0
                    opac = zero + 1.0
                    for j in range(ns):
                        h, t = _sphere_hit(
                            [u("sph_o", 3 * j + k) for k in range(3)],
                            u("sph_r", j), px, py, pz, qx, qy, qz)
                        rel = h & (t < tmax)
                        transp = u("mat_transparent", j) > 0.5
                        blocked |= rel & ~transp
                        opac = opac * jnp.where(rel & transp, through, 1.0)
                    for j in range(npl):
                        h, t = _plane_hit(
                            [u("pl_nrm", 3 * j + k) for k in range(3)],
                            [u("pl_pt", 3 * j + k) for k in range(3)],
                            px, py, pz, qx, qy, qz)
                        blocked |= h & (t < tmax)
                    soft = soft + jnp.where(blocked, 0.0, opac)
                ssr = (soft / np.float32(n_samples) if n_samples
                       else soft + 1.0)
                ssrs.append(ssr)
                ex, ey, ez = lo[0] - px, lo[1] - py, lo[2] - pz
                dd = jnp.sqrt(_dot(ex, ey, ez, ex, ey, ez))
                dd = jnp.where(dd > 0, dd, 1.0)
                inv_d2 = 1.0 / (dd * dd)
                lr = [u("li_rgb", 3 * i + k) * u("li_i", i) * pr.INV_PI
                      * inv_d2 * ssr for k in range(3)]
                hvx, hvy, hvz = _normalize(vx_ + sdx, vy_ + sdy, vz_ + sdz)
                spec_f = jnp.power(
                    jnp.maximum(0.0, _dot(nx, ny, nz, hvx, hvy, hvz)),
                    m["shininess"])
                c2 = [c + jnp.where(is_solid, f * m["specular"] * l * spec_f,
                                    0.0) for c, l in zip(c2, lr)]
                diff_f = jnp.maximum(0.0, _dot(nx, ny, nz, sdx, sdy, sdz))
                c2 = [c + jnp.where(is_solid, f * m["diffuse"] * l * diff_f,
                                    0.0) for c, l in zip(c2, lr)]
            rng = jnp.where(is_solid, rng_s, rng)

            # --- node record for the replay VJP ---
            if record:
                slot = rec_cnt
                can = do_work & (slot < krec)
                sc = jnp.minimum(slot, krec - 1)
                code = jnp.where(is_light, np.int32(64) + lwin,
                                 jnp.where(is_miss, np.int32(127), bwin))
                plgpu.store(rec_out.at[sc, pix], code | (pcode << 8),
                            mask=can)
                for li in range(nl):
                    plgpu.store(ssr_out.at[sc * nl + li, pix],
                                jnp.where(is_solid, ssrs[li], 0.0), mask=can)
                if not bilinear:
                    pick = jnp.where(is_miss, sky_pick,
                                     jnp.where(textured, tex_pick, -1))
                    plgpu.store(pick_out.at[sc, pix], pick, mask=can)
                # children of an overflowed node are parentless (code 0):
                # the replay drops their subtree
                ok_par = slot < krec
                pc_refl = jnp.where(ok_par, np.int32(0x80) | slot, 0)
                pc_refr = jnp.where(ok_par, np.int32(0xC0) | slot, 0)
                rec_cnt = rec_cnt + do_work.astype(I32)
            else:
                pc_refl = pc_refr = pcode

            # --- reflect / refract continuation (:138-179) ---
            n2 = jnp.where(n1 == default_n, m["n"], default_n)
            # schlick (primitives.cl:146-160)
            r0 = (n1 - n2) / (n1 + n2)
            r0 = r0 * r0
            cos_i = -_dot(nx, ny, nz, dx, dy, dz)
            nr = n1 / n2
            sin_t2 = nr * nr * (1.0 - cos_i * cos_i)
            s_tir = sin_t2 > 1.0
            cos_tr = jnp.sqrt(jnp.maximum(1.0 - sin_t2, 0.0))
            use_tr = n1 > n2
            xs = 1.0 - jnp.where(use_tr, cos_tr, cos_i)
            fr = r0 + (1.0 - r0) * xs * xs * xs * xs * xs
            fr = jnp.where(use_tr & s_tir, 1.0, fr)
            refl = m["reflectivity"]
            ra = jnp.where(m["dielectric"] > 0.5,
                           refl + (1.0 - refl) * fr, refl)
            f_cont = f * ra
            # reflect (primitives.cl:127-130)
            rdx = dx + (2.0 * cos_i) * nx
            rdy = dy + (2.0 * cos_i) * ny
            rdz = dz + (2.0 * cos_i) * nz
            dep1 = dep + 1

            push_try = (is_solid & (m["transparent"] > 0.5) & (sp < D)
                        & (ra < 1.0))
            entering = n1 < n2
            cox = jnp.where(entering, px - two_eps * nx, px)
            coy = jnp.where(entering, py - two_eps * ny, py)
            coz = jnp.where(entering, pz - two_eps * nz, pz)
            rnx = jnp.where(entering, nx, -nx)
            rny = jnp.where(entering, ny, -ny)
            rnz = jnp.where(entering, nz, -nz)
            # refract (primitives.cl:132-144) against rn
            cos_i2 = -_dot(rnx, rny, rnz, dx, dy, dz)
            sin2 = nr * nr * (1.0 - cos_i2 * cos_i2)
            tir = sin2 > 1.0
            cos_t = jnp.sqrt(jnp.maximum(1.0 - sin2, 0.0))
            k2 = nr * cos_i2 - cos_t
            tdx, tdy, tdz = nr * dx + k2 * rnx, nr * dy + k2 * rny, \
                nr * dz + k2 * rnz
            push = push_try & ~tir

            pop = active & (overdepth | is_light | is_miss)
            finish = pop & (sp == 1)
            popm = pop & (sp > 1)
            cont = is_solid & ~push

            # push saves the parent's reflected continuation; pop restores
            # it and merges the child's rgb (raytracing.cl:188)
            ivals = [dep1, pc_refl] if record else [dep1]
            stack_push(sp - 1, push,
                       [px, py, pz, rdx, rdy, rdz, *c2, f_cont, n1], ivals)
            rs = stack_pop(sp - 2, popm)

            def pick4(push_v, pop_v, cont_v, keep):
                return jnp.where(push, push_v, jnp.where(
                    popm, pop_v, jnp.where(cont, cont_v, keep)))

            new_c = [jnp.where(push, 0.0, jnp.where(
                popm, r + c, jnp.where(cont | finish, c, c_old)))
                for r, c, c_old in zip(rs[6:9], c2, (cx, cy, cz))]
            new_pc = pick4(pc_refr, rs[NF + 1], pc_refl, pcode) \
                if record else pcode
            return (pick4(cox, rs[0], px, ox), pick4(coy, rs[1], py, oy),
                    pick4(coz, rs[2], pz, oz), pick4(tdx, rs[3], rdx, dx),
                    pick4(tdy, rs[4], rdy, dy), pick4(tdz, rs[5], rdz, dz),
                    *new_c,
                    jnp.where(push, f * (1.0 - ra), jnp.where(
                        popm, rs[9], jnp.where(cont, f_cont, f))),
                    jnp.where(push, n2, jnp.where(popm, rs[10], n1)),
                    jnp.where(push | cont, dep1, jnp.where(popm, rs[NF],
                                                            dep)),
                    sp + push.astype(I32) - popm.astype(I32),
                    rng, done | finish.astype(I32), it + 1, rec_cnt, new_pc)

        def cond(st):
            live = jnp.max(jnp.where(st[14] == 0, 1, 0))
            return (live > 0) & (st[15] < cfg.max_iters)

        init = (ox, oy, oz, dx, dy, dz, zero, zero, zero, zero + 1.0,
                zero + default_n, izero, izero + 1, pid.astype(U32),
                (pix >= n_pix).astype(I32), np.int32(0), izero, izero)
        final = jax.lax.while_loop(cond, step, init)
        for k in range(3):
            plgpu.store(rgb_out.at[k, blk], final[6 + k])
        if record:
            plgpu.store(cnt_out.at[blk], final[16])

    return kernel


def _forward(scene: Scene, assets: SceneAssets, basis: PerspectiveBasis,
             cfg: RenderConfig, interpret: bool, row0, record: bool):
    if scene.num_triangles:
        raise ValueError(
            "the GPU kernel renders spheres, planes and lights only; "
            f"this scene has {scene.num_triangles} triangles — render it "
            "with engine='xla' (render.choose_engine picks it for 'auto')")
    width, height = cfg.width, cfg.height
    n_pix = width * height
    n_blk = -(-n_pix // BLOCK)
    n_pad = n_blk * BLOCK
    D = cfg.max_depth
    uni, off = pack_uniforms(scene, basis, row0)
    counts = (scene.num_spheres, scene.num_planes, scene.num_lights)
    nl = max(scene.num_lights, 1)
    krec = cfg.resolved_record_slots() if record else 0
    tex, sky = assets.textures, assets.skybox
    kernel = _make_kernel(off, counts, tex.shape[:3], sky.shape[:2], cfg,
                          width, n_pix, record, krec, BLOCK)

    shapes = [((3, n_pad), F32)]
    if record:
        shapes += [((krec, n_pad), I32), ((krec * nl, n_pad), F32),
                   ((krec, n_pad), I32), ((n_pad,), I32)]
    # the per-lane ray stacks: written and read only inside the kernel
    shapes += [((NF * D, n_pad), F32),
               (((2 if record else 1) * D, n_pad), I32)]
    outs = pl.pallas_call(
        kernel,
        grid=(n_blk,),
        out_shape=tuple(jax.ShapeDtypeStruct(s, d) for s, d in shapes),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=1),
        interpret=interpret,
        name="whitted_dfs_record" if record else "whitted_dfs",
    )(uni, tex.reshape(-1), sky.reshape(-1))
    img = outs[0][:, :n_pix].T.reshape(height, width, 3)
    if not record:
        return img
    rec, ssr, pick, cnt = outs[1:5]
    records = {"rec": rec[:, :n_pix],
               "ssr": ssr.reshape(krec, nl, n_pad)[:, :scene.num_lights,
                                                   :n_pix],
               "pick": pick[:, :n_pix],
               "max_nodes": jnp.max(cnt[:n_pix])}
    return img, records


def render_pallas(scene: Scene, assets: SceneAssets, basis: PerspectiveBasis,
                  cfg: RenderConfig, interpret: bool = False,
                  row0=0.0) -> jnp.ndarray:
    """Forward render through the GPU kernel: float32 linear rgb [H, W, 3].

    Same semantics as the XLA tracer for scenes without triangles.
    ``row0``: global image row of the first rendered row (row-sharded
    rendering).  ``interpret=True`` runs the kernel on the CPU."""
    return _forward(scene, assets, basis, cfg, interpret, row0, False)


def render_pallas_record(scene: Scene, assets: SceneAssets,
                         basis: PerspectiveBasis, cfg: RenderConfig,
                         interpret: bool = False, row0=0.0):
    """Forward render plus the per-node records of the replay VJP.

    Returns ``(img [H, W, 3] f32, records)``; ``records`` holds
      * ``rec``  [Krec, n_pix] i32 — hit code (sphere/plane id, 64 + light
        id, 127 for a miss) | parent byte << 8 (6-bit parent slot, 0x40
        refract branch, 0x80 has-parent); -1 marks an unused slot;
      * ``ssr``  [Krec, nl, n_pix] f32 — per-light soft-shadow ratio of each
        solid hit (the only RNG-dependent quantities);
      * ``pick`` [Krec, n_pix] i32 — the nearest-filter texel each node
        fetched (skybox texel on a miss, texture texel on a textured
        plane, -1 otherwise), so the replay reuses the kernel's discrete
        picks;
      * ``max_nodes`` — the largest node count of any pixel (> Krec means
        the replay drops some subtrees; raise ``cfg.record_slots``).
    """
    return _forward(scene, assets, basis, cfg, interpret, row0, True)
