"""Staged benchmark suite: six render configurations.

Prints one JSON line per stage with the engine render.choose_engine picks
for it and the device it ran on (platform, device kind, count, and the
card's name and power limit).  Same timing methodology as bench.py
(chained in-jit renders, scalar-readback sync, slope).

    python benchmarks/stages.py [--stages 1,2,3] [--chain 4]
"""
import argparse
import functools
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def measure(render_inner, scene, assets, basis, cfg, chain):
    import jax
    import jax.numpy as jnp

    @functools.partial(jax.jit, static_argnames=("n",))
    def render_n(basis, n):
        def body(i, acc):
            b = basis._replace(
                origin=basis.origin + i.astype(jnp.float32) * 1e-6)
            return acc + jnp.sum(render_inner(scene, assets, b, cfg))
        return jax.lax.fori_loop(0, n, body, jnp.float32(0.0))

    for n in (1, chain):
        float(render_n(basis, n))

    def best_of(n, reps=3):
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            float(render_n(basis, n))
            best = min(best, time.perf_counter() - t0)
        return best

    per = (best_of(chain) - best_of(1)) / (chain - 1)
    # fast renders need a longer chain than the default 4 for the slope
    # to rise above timer jitter (a noisy chain-4 slope can read several
    # ms high OR negative), so any sub-8ms estimate is re-measured at
    # chain 64
    if per < 8e-3 and chain < 64:
        for n in (1, 64):
            float(render_n(basis, n))
        per = (best_of(64) - best_of(1)) / 63
    return per


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--stages", default="1,2,3")
    ap.add_argument("--chain", type=int, default=4)
    args = ap.parse_args(argv)
    stages = {int(s) for s in args.stages.split(",")}

    from tpuray.camera import Camera, perspective_basis
    from tpuray.config import (GOLDEN_CAMERA_LOOKDIR, GOLDEN_CAMERA_ORIGIN,
                               RenderConfig)
    from tpuray.meshes import mesh_benchmark_scene
    from tpuray.render import (choose_engine, render_from_basis_pallas,
                               render_from_basis_xla)
    from tpuray.scene import canonical_scene_spec
    from tpuray.textures import seeded_assets
    from tpuray.utils.compile_cache import enable_compile_cache
    from tpuray.utils.metrics import device_info

    enable_compile_cache()
    renders = {"pallas": render_from_basis_pallas.__wrapped__,
               "xla": render_from_basis_xla.__wrapped__}
    scene = canonical_scene_spec().to_scene()
    assets = seeded_assets(0)
    cam = Camera(GOLDEN_CAMERA_ORIGIN, GOLDEN_CAMERA_LOOKDIR, 90.0, 1.0)
    device = device_info()

    # (stage, name, scene, cfg)
    defs = {
        1: ("256x256_depth1_diffuse", scene,
            RenderConfig(width=256, height=256, max_depth=1,
                         shadow_samples=0, chunk_size=0)),
        2: ("800x600_depth15_reference", scene,
            RenderConfig(width=800, height=600, max_depth=15, chunk_size=0)),
        3: ("1920x1080_depth4", scene,
            RenderConfig(width=1920, height=1080, max_depth=4,
                         chunk_size=0)),
        4: ("3840x2160_depth6", scene,
            RenderConfig(width=3840, height=2160, max_depth=6,
                         chunk_size=0)),
        5: ("512x384_depth3_mesh7k", mesh_benchmark_scene(4).to_scene(),
            RenderConfig(width=512, height=384, max_depth=3, chunk_size=0)),
        6: ("3840x2160_depth6_mesh10k",
            mesh_benchmark_scene(4, torus_res=(64, 40)).to_scene(),
            RenderConfig(width=3840, height=2160, max_depth=6,
                         chunk_size=0)),
    }

    for s in sorted(stages):
        name, sc, cfg = defs[s]
        engine = choose_engine(sc, cfg)
        basis = perspective_basis(cam, cfg.width, cfg.height)
        per = measure(renders[engine], sc, assets, basis, cfg, args.chain)
        print(json.dumps({
            "stage": s, "config": name, "engine": engine,
            "ms_per_render": per * 1e3,
            "mrays_per_s": cfg.num_pixels / per / 1e6,
            "device": device,
        }), flush=True)


if __name__ == "__main__":
    main()
