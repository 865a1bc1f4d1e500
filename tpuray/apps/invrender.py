"""Inverse rendering: recover render.map's material parameters and light
positions from a target image by gradient descent.

No reference analog (the reference is forward-only); this is the
north-star differentiable-rendering demo.  The target is a render of the
TRUE canonical render.map scene (the scene behind the reference's golden
image) with textures and skybox generated from a seed; the optimization
starts from perturbed material parameters (rgb/ambient/diffuse/specular/
reflectivity of every sphere and plane) and perturbed light positions, and
recovers them by adam on the L2 image loss.

Two gradient engines, picked by render.choose_engine for ``--engine auto``:
  * ``pallas`` (GPU): the kernel's custom VJP — record-mode forward +
    saved-path replay backward (diff.render_pallas_diff);
  * ``xla``: reverse-mode AD through the scan tracer (the FD-validated
    oracle; works anywhere).
``--engine pallas --interpret`` runs the kernel in interpret mode (CPU
testing).

    python -m tpuray.apps.invrender [--steps 300] [--width 128 --height 96]
        [--engine auto] [--checkpoint out/invrender.npz] [--resume]
"""
from __future__ import annotations

import argparse
import time

import jax
import jax.numpy as jnp
import jax.tree_util as jtu
import numpy as np
import optax

from .. import diff
from ..camera import Camera, perspective_basis
from ..config import (GOLDEN_CAMERA_FOCAL, GOLDEN_CAMERA_FOV,
                      GOLDEN_CAMERA_LOOKDIR, GOLDEN_CAMERA_ORIGIN,
                      RenderConfig)
from ..render import choose_engine, render_from_basis_xla
from ..scene import canonical_scene_spec
from ..textures import seeded_assets
from ..utils.checkpoint import load_pytree, save_pytree
from ..utils.compile_cache import enable_compile_cache

# "material params + light position": every shading-weight field of every
# sphere/plane material, plus light origins.
# Geometry, IoR, shininess exponents and texture ids/scales stay frozen.
OPT_MAT_FIELDS = ("rgb", "ambient", "diffuse", "specular", "reflectivity")


def optimize_mask(params):
    """Bool pytree (same structure as the float-partitioned scene) marking
    the leaves the optimization may move."""
    def pick(path, leaf):
        names = [p.name for p in path if isinstance(p, jtu.GetAttrKey)]
        if not names:
            return False
        if names[0] == "light_origin":
            return True
        if names[0] in ("sphere_mat", "plane_mat") \
                and names[-1] in OPT_MAT_FIELDS:
            return True
        return False
    return jtu.tree_map_with_path(pick, params)


def perturb(params, mask, seed=0, mat_scale=0.5, light_shift=0.5):
    """Multiplicative noise on optimized material leaves, additive on
    light origins — the recovery starting point."""
    key = jax.random.PRNGKey(seed)
    flat, treedef = jtu.tree_flatten(params)
    mflat = jtu.tree_leaves(mask)
    keys = jax.random.split(key, len(flat))
    out = []
    paths = [p for p, _ in jtu.tree_flatten_with_path(params)[0]]
    for leaf, m, k, path in zip(flat, mflat, keys, paths):
        if not m:
            out.append(leaf)
            continue
        names = [p.name for p in path if isinstance(p, jtu.GetAttrKey)]
        if names[0] == "light_origin":
            out.append(leaf + jax.random.uniform(
                k, leaf.shape, minval=-light_shift, maxval=light_shift))
        else:
            fac = jax.random.uniform(k, leaf.shape, minval=1.0 - mat_scale,
                                     maxval=1.0 + mat_scale)
            out.append(jnp.clip(leaf * fac + 0.05, 0.0, None))
    return jtu.tree_unflatten(treedef, out)


def param_error(params, truth_params, mask, group=None):
    """Mean |recovered - truth| over the optimized leaves.

    ``group``: None = all optimized leaves, 'light' = light origins only,
    'mat' = material leaves only."""
    errs, n = 0.0, 0
    flat = jtu.tree_flatten_with_path(params)[0]
    for (path, p), t, m in zip(flat, jtu.tree_leaves(truth_params),
                               jtu.tree_leaves(mask)):
        if not m:
            continue
        is_light = any(getattr(q, "name", None) == "light_origin"
                       for q in path)
        if group == "light" and not is_light:
            continue
        if group == "mat" and is_light:
            continue
        errs += float(jnp.abs(p - t).sum())
        n += int(np.prod(p.shape))
    return errs / max(n, 1)


def observable_error(params, truth_params, static):
    """Mean |recovered − truth| over the OBSERVABLE parameterization.

    Material ``rgb`` enters the image only through the ambient term
    ``f * rgb * ambient`` (raytracing.cl:83-84); the diffuse/specular
    terms scale the LIGHT's rgb, not the material's
    (raytracing.cl:118-134).  So (rgb*ambient, diffuse, specular,
    reflectivity, light origin) is the identifiable parameterization and
    raw (rgb, ambient) carries a per-material gauge freedom no image
    loss can resolve — at convergence (loss ~5e-5) the raw error is
    dominated by motion along that null space (r5 full-size run: raw
    31% of start, lights at 2e-4, ALL residual in rgb/ambient)."""
    from .. import diff as _diff
    rec = _diff.combine(params, static)
    tru = _diff.combine(truth_params, static)
    errs, n = 0.0, 0
    for mat_r, mat_t in ((rec.sphere_mat, tru.sphere_mat),
                         (rec.plane_mat, tru.plane_mat)):
        pairs = [(mat_r.rgb * mat_r.ambient[:, None],
                  mat_t.rgb * mat_t.ambient[:, None]),
                 (mat_r.diffuse, mat_t.diffuse),
                 (mat_r.specular, mat_t.specular),
                 (mat_r.reflectivity, mat_t.reflectivity)]
        for a, b in pairs:
            errs += float(jnp.abs(a - b).sum())
            n += int(np.prod(a.shape))
    errs += float(jnp.abs(rec.light_origin - tru.light_origin).sum())
    n += int(np.prod(rec.light_origin.shape))
    return errs / max(n, 1)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--width", type=int, default=128)
    ap.add_argument("--height", type=int, default=96)
    ap.add_argument("--depth", type=int, default=3)
    ap.add_argument("--shadow-samples", type=int, default=0,
                    help="soft-shadow samples in the optimization loss. "
                         "Default 0 (shadows off in target AND render): "
                         "shadow boundaries are discontinuities whose "
                         "motion is invisible to AD (gradient a.e. zero), "
                         "so with shadows on, light-position steps jump "
                         "the loss unpredictably; without edge-sampling "
                         "the smooth falloff/highlight terms are the "
                         "well-posed light-position signal")
    ap.add_argument("--lr", type=float, default=1e-2)
    ap.add_argument("--lr-alpha", type=float, default=0.05,
                    help="cosine-decay floor as a fraction of --lr; adam "
                         "at a constant lr plateaus in an oscillation "
                         "band around the minimum, the decay converges "
                         "the tail (r5: full-size recovery 67%% -> 80%%+)")
    ap.add_argument("--light-lr-scale", type=float, default=0.25,
                    help="light-origin step size relative to --lr")
    ap.add_argument("--mat-scale", type=float, default=0.5,
                    help="multiplicative material perturbation")
    ap.add_argument("--light-shift", type=float, default=0.3,
                    help="additive light-origin perturbation (world units)")
    ap.add_argument("--phase1-frac", type=float, default=0.4,
                    help="fraction of steps fitting materials only before "
                         "lights unfreeze (shadow moves are invisible to "
                         "AD, so a joint cold start lets lights wander; "
                         "fitting materials first anchors the basin)")
    ap.add_argument("--engine", default="auto",
                    choices=("auto", "pallas", "xla"))
    ap.add_argument("--interpret", action="store_true",
                    help="with --engine pallas: run the GPU kernel in "
                         "Pallas interpret mode (CPU testing)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the perturbation and of the generated "
                         "textures and skybox")
    ap.add_argument("--checkpoint", default="out/invrender.npz")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--every", type=int, default=25)
    args = ap.parse_args(argv)
    enable_compile_cache()

    cfg = RenderConfig(width=args.width, height=args.height,
                       max_depth=args.depth, chunk_size=0, loop="scan",
                       shadow_samples=args.shadow_samples)
    assets = seeded_assets(args.seed)
    cam = Camera(GOLDEN_CAMERA_ORIGIN, GOLDEN_CAMERA_LOOKDIR,
                 GOLDEN_CAMERA_FOV, GOLDEN_CAMERA_FOCAL)
    basis = perspective_basis(cam, cfg.width, cfg.height)

    truth = canonical_scene_spec().to_scene()
    interp = args.interpret
    if interp and args.engine != "pallas":
        raise SystemExit("--interpret runs the GPU kernel: pass it with "
                         "--engine pallas")
    engine = ("pallas" if interp
              else choose_engine(truth, cfg.replace(engine=args.engine)))
    truth_params, static = diff.partition(truth)
    mask = optimize_mask(truth_params)
    # material weights are projected back to >= 0 after each update; light
    # origins are unconstrained
    clip_mask = jtu.tree_map_with_path(
        lambda path, m: m and not any(
            getattr(p, "name", None) == "light_origin" for p in path),
        mask)

    # the loss compares DISPLAY-space images (clamped to [0, 1], exactly
    # what the reference's output path shows, raytracing.cl:193): linear
    # radiance at directly-visible light pixels is I/pi (~16 for the white
    # light) and the blob's position is a step function of light origin —
    # unclamped L2 is dominated by those AD-invisible terms and pushes the
    # optimizer off the basin; clamping saturates blob interiors so the
    # smooth falloff/highlight signals drive the fit
    if engine == "pallas":
        # preflight: size the node-record buffer to the scene's actual
        # worst-case DFS path count, so the replay backward loses no
        # subtree gradients
        from ..kernels.pallas_trace import render_pallas_record
        _, rec0 = render_pallas_record(truth, assets, basis, cfg,
                                       interpret=interp)
        need = int(rec0["max_nodes"])
        if need > cfg.resolved_record_slots():
            if need > 64:
                print(f"warning: scene needs {need} record slots > the "
                      "64-slot cap; deep-path gradients will be dropped")
            cfg = cfg.replace(record_slots=min(need, 64))
            print(f"record preflight: record_slots -> "
                  f"{cfg.resolved_record_slots()}")
        render = lambda s: jnp.clip(  # noqa: E731
            diff.render_pallas_diff(s, assets, basis, cfg, 0.0, interp),
            0.0, 1.0)
    else:
        render = lambda s: jnp.clip(  # noqa: E731
            render_from_basis_xla(s, assets, basis, cfg), 0.0, 1.0)
    # the target comes from a jitted program like the training renders: an
    # op-by-op render may round differently (no fused multiply-adds) and
    # flip measure-zero texel picks, e.g. along the horizon row, leaving a
    # loss floor no parameter can remove
    target = jax.lax.stop_gradient(jax.jit(render)(truth))

    params = perturb(truth_params, mask, args.seed,
                     mat_scale=args.mat_scale, light_shift=args.light_shift)
    err0 = param_error(params, truth_params, mask)
    obs0 = observable_error(params, truth_params, static)
    light_mask = jax.tree.map(lambda a, b: a and not b, mask, clip_mask)

    # zero_nans: a boundary-degenerate step (grazing hit, light touching a
    # surface) must not poison the run; clip: the L2-sum loss has stiff
    # directions (specular powers) that can otherwise blow past minima
    lr_sched = optax.cosine_decay_schedule(
        init_value=args.lr, decay_steps=max(args.steps, 1),
        alpha=args.lr_alpha)
    opt = optax.chain(optax.zero_nans(), optax.clip_by_global_norm(5.0),
                      optax.adam(lr_sched))
    opt_state = opt.init(params)
    step0 = 0
    if args.resume:
        import os
        if os.path.exists(args.checkpoint):
            (params, opt_state), step0 = load_pytree(args.checkpoint,
                                                     (params, opt_state))
            print(f"resumed from {args.checkpoint} @ step {step0}")

    # lights_on is traced, not static: both phases share one compiled step
    @jax.jit
    def train_step(params, opt_state, lights_on):
        def loss_fn(p):
            img = render(diff.combine(p, static))
            return diff.l2_image_loss(img, target)

        loss, g = jax.value_and_grad(loss_fn)(params)
        # frozen leaves keep zero gradient; in phase 1 lights are frozen
        # too; optimized weights stay physical via the projection below
        g = jax.tree.map(
            lambda gi, m, isl: (jnp.where(lights_on, gi, 0.0) if isl else gi)
            if m else jnp.zeros_like(gi), g, mask, light_mask)
        updates, opt_state = opt.update(g, opt_state)
        # lights take smaller steps than materials (world units vs [0,1])
        updates = jax.tree.map(
            lambda u, isl: u * args.light_lr_scale if isl else u,
            updates, light_mask)
        params = optax.apply_updates(params, updates)
        params = jax.tree.map(
            lambda p, m: jnp.clip(p, 0.0, None) if m else p,
            params, clip_mask)
        return params, opt_state, loss

    print(f"engine={engine}  {cfg.width}x{cfg.height} depth={cfg.max_depth}"
          f"  start param err={err0:.4f}")
    phase1_end = int(args.steps * args.phase1_frac)
    t0 = time.time()
    for step in range(step0, args.steps):
        params, opt_state, loss = train_step(params, opt_state,
                                             jnp.asarray(step >= phase1_end))
        if step % args.every == 0 or step == args.steps - 1:
            err = param_error(params, truth_params, mask)
            err_l = param_error(params, truth_params, mask, "light")
            err_m = param_error(params, truth_params, mask, "mat")
            print(f"step {step:4d}  loss {float(loss):.5f}  "
                  f"param err {err:.4f} (light {err_l:.4f} mat {err_m:.4f})"
                  f"  ({time.time() - t0:.1f}s)")

    import os
    os.makedirs(os.path.dirname(args.checkpoint) or ".", exist_ok=True)
    save_pytree(args.checkpoint, (params, opt_state), args.steps)

    err1 = param_error(params, truth_params, mask)
    obs1 = observable_error(params, truth_params, static)
    rec = diff.combine(params, static)
    print(f"\nparam error: {err0:.4f} -> {err1:.4f} "
          f"({err1 / max(err0, 1e-9):.1%} of start)")
    print(f"observable param error: {obs0:.4f} -> {obs1:.4f} "
          f"({obs1 / max(obs0, 1e-9):.1%} of start; rgb*ambient product "
          f"instead of the gauge-free raw pair — see observable_error)")
    print("recovered vs truth:")
    print("  light origins\n", np.asarray(rec.light_origin), "\nvs\n",
          np.asarray(truth.light_origin))
    print("  sphere ambient", np.asarray(rec.sphere_mat.ambient),
          "vs", np.asarray(truth.sphere_mat.ambient))
    return err0, err1, obs0, obs1


if __name__ == "__main__":
    main()
