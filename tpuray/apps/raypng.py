"""Offline renderer CLI — the ``raypng`` equivalent (raypng.c:11-106).

Renders a scene with the reference camera (raypng.c:17-21), reports
wall-clock + Mrays/s (the reference prints "Done, took: N ms",
raypng.c:92-96), writes a PNG, and can diff against the reference's
committed golden image.

By default the scene is the canonical ``render.map`` scene
(scene.canonical_scene_spec) and the textures and skybox are generated
from ``--seed`` at the reference's sizes, so nothing outside the package is
read.  ``--scene`` renders a scene archive; ``--compare-golden`` renders
with the reference's own assets and diffs against its ``out/scene.png``,
both read from a reference checkout (config.REFERENCE_DIR).

    python -m tpuray.apps.raypng [--scene render.map] [--out out/scene.png]
        [--width 800 --height 600] [--depth 15] [--compare-golden]
"""
from __future__ import annotations

import argparse
import contextlib
import os
import time

from ..camera import Camera
from ..config import (GOLDEN_CAMERA_FOCAL, GOLDEN_CAMERA_FOV,
                      GOLDEN_CAMERA_LOOKDIR, GOLDEN_CAMERA_ORIGIN,
                      RenderConfig, reference_path)
from ..io import image_diff_stats, read_png, write_png
from ..render import choose_engine, render_u8
from ..scene import canonical_scene_spec
from ..sceneio import load_scene
from ..textures import load_default_assets, seeded_assets
from ..utils.compile_cache import enable_compile_cache
from ..utils.metrics import RenderReport, profile_trace


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--scene", default=None,
                    help="scene archive to render (default: the canonical "
                         "render.map scene, built in)")
    ap.add_argument("--out", default="out/scene.png")
    ap.add_argument("--width", type=int, default=800)
    ap.add_argument("--height", type=int, default=600)
    ap.add_argument("--depth", type=int, default=15)
    ap.add_argument("--shadow-samples", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the generated textures and skybox")
    ap.add_argument("--chunk-size", type=int, default=65536)
    ap.add_argument("--compare-golden", action="store_true",
                    help="render with the reference's assets and diff the "
                         "output against its committed out/scene.png")
    ap.add_argument("--repeat", type=int, default=1,
                    help="timed re-renders after the compile pass")
    ap.add_argument("--engine", default="auto",
                    choices=("auto", "pallas", "xla"))
    ap.add_argument("--profile", default=None, metavar="LOGDIR",
                    help="wrap the timed render in a jax.profiler trace "
                         "(view with xprof/tensorboard)")
    ap.add_argument("--selfcheck", action="store_true",
                    help="assert the rendered image is finite (NaN guard)")
    args = ap.parse_args(argv)
    enable_compile_cache()

    if args.scene:
        scene = load_scene(args.scene).to_scene()
    else:
        scene = canonical_scene_spec().to_scene()
    golden = None
    if args.compare_golden:
        golden = read_png(reference_path("out", "scene.png"))
        assets = load_default_assets()
    else:
        assets = seeded_assets(args.seed)
    cam = Camera(GOLDEN_CAMERA_ORIGIN, GOLDEN_CAMERA_LOOKDIR,
                 GOLDEN_CAMERA_FOV, GOLDEN_CAMERA_FOCAL)
    cfg = RenderConfig(width=args.width, height=args.height,
                       max_depth=args.depth,
                       shadow_samples=args.shadow_samples,
                       chunk_size=args.chunk_size, engine=args.engine)
    print(f"engine: {choose_engine(scene, cfg)}")

    t0 = time.perf_counter()
    img = render_u8(scene, assets, cam, cfg)
    compile_s = time.perf_counter() - t0

    profile_ctx = (profile_trace(args.profile) if args.profile
                   else contextlib.nullcontext())
    best = compile_s
    with profile_ctx:
        for _ in range(max(0, args.repeat - 1)):
            t0 = time.perf_counter()
            img = render_u8(scene, assets, cam, cfg)
            best = min(best, time.perf_counter() - t0)

    if args.selfcheck:
        from ..utils.debug import check_finite
        check_finite(img, "render")
        print("selfcheck: image finite")

    report = RenderReport(width=cfg.width, height=cfg.height,
                          max_depth=cfg.max_depth, seconds=best,
                          compile_seconds=compile_s)
    print(report)
    print(f"Done, took: {best * 1000.0:.0f} ms")  # raypng.c:96 format

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    write_png(args.out, img)
    print(f"wrote {args.out}")

    if golden is not None:
        print(f"golden diff: {image_diff_stats(img, golden)}")


if __name__ == "__main__":
    main()
