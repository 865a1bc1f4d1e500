#!/usr/bin/env python
"""Headline benchmark: Mrays/s at 1080p, depth 4, on the render.map scene.

Prints ONE JSON line: {"metric", "value", "unit", "engine", "device"} where
"device" names the platform, device kind, device count and — on a GPU —
the card and its power limit, as nvidia-smi reports them.

The scene is the canonical render.map scene with textures and skybox
generated from a seed at the reference's sizes; the engine is the one
render.choose_engine picks (the GPU kernel on a GPU, else the XLA tracer).

Timing: N renders are chained *inside one jitted program*
(``lax.fori_loop`` with a per-iteration camera perturbation so no stage can
be cached) and the per-render time is the slope (t_N - t_1)/(N - 1), with a
scalar host readback as the sync point.
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

N_CHAIN = 5


def main():
    import functools

    import jax
    import jax.numpy as jnp

    from tpuray.camera import Camera, perspective_basis
    from tpuray.config import (GOLDEN_CAMERA_LOOKDIR, GOLDEN_CAMERA_ORIGIN,
                               RenderConfig)
    from tpuray.render import (choose_engine, render_from_basis_pallas,
                               render_from_basis_xla)
    from tpuray.scene import canonical_scene_spec
    from tpuray.textures import seeded_assets
    from tpuray.utils.compile_cache import enable_compile_cache
    from tpuray.utils.metrics import device_info

    enable_compile_cache()
    scene = canonical_scene_spec().to_scene()
    assets = seeded_assets(0)
    cam = Camera(GOLDEN_CAMERA_ORIGIN, GOLDEN_CAMERA_LOOKDIR, 90.0, 1.0)
    cfg = RenderConfig(width=1920, height=1080, max_depth=4, chunk_size=0)
    basis = perspective_basis(cam, cfg.width, cfg.height)

    engine = choose_engine(scene, cfg)
    render = (render_from_basis_pallas if engine == "pallas"
              else render_from_basis_xla)
    inner = render.__wrapped__  # un-jitted; we jit the whole chain

    @functools.partial(jax.jit, static_argnames=("n",))
    def render_n(basis, n):
        def body(i, acc):
            b = basis._replace(
                origin=basis.origin + i.astype(jnp.float32) * 1e-6)
            return acc + jnp.sum(inner(scene, assets, b, cfg))
        return jax.lax.fori_loop(0, n, body, jnp.float32(0.0))

    for n in (1, N_CHAIN):           # compile both chain lengths
        float(render_n(basis, n))

    def best_of(n, reps=3):
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            float(render_n(basis, n))   # scalar readback = true sync
            best = min(best, time.perf_counter() - t0)
        return best

    per_render = (best_of(N_CHAIN) - best_of(1)) / (N_CHAIN - 1)
    mrays = cfg.num_pixels / per_render / 1e6
    print(json.dumps({
        "metric": "primary_mrays_per_s_1080p_depth4",
        "value": mrays,
        "unit": "Mrays/s",
        "engine": engine,
        "device": device_info(),
    }))


if __name__ == "__main__":
    main()
