"""Multi-device scaling-efficiency harness.

Measures the pixel-sharded forward render (and optionally the
scene-parallel mesh render) over growing mesh sizes 1, 2, 4, ... N and
reports throughput + efficiency vs the 1-device run.  Prints one JSON
line per mesh size:

    {"layout": "pixel", "engine": "pallas", "devices": 4,
     "ms_per_render": .., "mrays_per_s": .., "efficiency": 0.97,
     "device": {...}}

``--layout pixel`` shards image rows with the engine render.choose_engine
picks (the GPU kernel per shard on GPUs, the tracer elsewhere);
``--layout scene`` shards the triangles of a mesh scene (tracer).  On the
virtual-device CPU rig the wall times are a plumbing check, not a scaling
claim; every line names the device it ran on.

    python benchmarks/scaling.py [--max-devices 8] [--layout pixel|scene]
    [--width 1920 --height 1080 --depth 4]

Same slope-timing methodology as bench.py (chained in-jit renders,
scalar readback, per-render time from the chain slope).
"""
import argparse
import functools
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def measure(render, basis, chain=4):
    import jax
    import jax.numpy as jnp

    @functools.partial(jax.jit, static_argnames=("n",))
    def render_n(basis, n):
        def body(i, acc):
            b = basis._replace(
                origin=basis.origin + i.astype(jnp.float32) * 1e-6)
            return acc + jnp.sum(render(b))
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

    return (best_of(chain) - best_of(1)) / (chain - 1)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--max-devices", type=int, default=None)
    ap.add_argument("--layout", default="pixel",
                    choices=("pixel", "scene"))
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--depth", type=int, default=4)
    ap.add_argument("--mesh-order", type=int, default=4,
                    help="icosphere order for --layout scene")
    args = ap.parse_args(argv)

    import jax

    from tpuray.camera import Camera, perspective_basis
    from tpuray.config import (GOLDEN_CAMERA_LOOKDIR, GOLDEN_CAMERA_ORIGIN,
                               RenderConfig)
    from tpuray.meshes import mesh_benchmark_scene
    from tpuray.parallel.shard import (make_mesh, render_scene_parallel,
                                       render_sharded, render_sharded_pallas)
    from tpuray.render import choose_engine
    from tpuray.scene import canonical_scene_spec
    from tpuray.textures import seeded_assets
    from tpuray.utils.compile_cache import enable_compile_cache
    from tpuray.utils.metrics import device_info

    enable_compile_cache()
    n_avail = len(jax.devices())
    n_max = min(args.max_devices or n_avail, n_avail)
    device = device_info()

    cfg = RenderConfig(width=args.width, height=args.height,
                       max_depth=args.depth, chunk_size=0)
    if args.layout == "scene":
        scene = mesh_benchmark_scene(args.mesh_order).to_scene()
        engine, render_fn = "xla", render_scene_parallel
    else:
        scene = canonical_scene_spec().to_scene()
        engine = choose_engine(scene, cfg)
        render_fn = (render_sharded_pallas if engine == "pallas"
                     else render_sharded)
    assets = seeded_assets(0)
    basis = perspective_basis(
        Camera(GOLDEN_CAMERA_ORIGIN, GOLDEN_CAMERA_LOOKDIR, 90.0, 1.0),
        cfg.width, cfg.height)

    base_rate = None
    n = 1
    while n <= n_max:
        mesh = make_mesh(n)
        per = measure(
            lambda b: render_fn.__wrapped__(scene, assets, b, cfg, mesh),
            basis)
        rate = cfg.num_pixels / per / 1e6
        if base_rate is None:
            base_rate = rate
        print(json.dumps({
            "layout": args.layout, "engine": engine, "devices": n,
            "ms_per_render": per * 1e3, "mrays_per_s": rate,
            "efficiency": rate / (base_rate * n), "device": device,
        }), flush=True)
        n *= 2


if __name__ == "__main__":
    main()
