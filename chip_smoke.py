#!/usr/bin/env python
"""Smoke test of the main path on one NVIDIA GPU (or four, ``--four-cards``).

    python chip_smoke.py                # one card: every phase below
    python chip_smoke.py --four-cards   # four cards: the multi-card paths

One card, phases in order:

1. ``forward_800x600_d15`` and ``forward_1920x1080_d4`` — render_from_basis
   (the dispatch rule picks the GPU kernel) against the XLA tracer at
   ``highest`` matmul precision, both on the card, on the canonical
   render.map scene with seeded assets at the reference's sizes.  Bars:
   mean |d| <= 0.5/255, >= 99% of channels within +-8, PSNR >= 45 dB.
   Then ``python -m tpuray.apps.raypng`` at the same size, whose PNG must
   meet the same bars against the kernel's image.
2. ``tracer_gpu_vs_cpu`` — the tracer on the card against the tracer on
   the CPU, on every 64th pixel at 800x600 d15; the same bars.
3. ``replay_grads_64x48_d3`` — the replay VJP's scene gradients against
   the scan tracer's, on the card, within 2e-2 of each leaf's scale (the
   bar of tests/test_pallas_vjp.py).
4. ``invrender`` — three optimisation steps of ``tpuray.apps.invrender
   --engine auto`` (the kernel's custom VJP on a GPU); the loss must be
   finite and falling.
5. ``triangles_512x384_d3`` — the 7k-triangle mesh scene through
   render_from_basis (the dispatch rule sends it to the tracer) against
   the same scene on the CPU, on every 64th pixel; the same bars.

Four cards: render_sharded_pallas at 1080p d4,
loss_and_scene_grad_sharded_pallas at 128x96 d3 and render_scene_parallel
on the mesh scene, each against its one-card result, and a check that the
shards sat on four different cards.

Every phase prints one JSON line (compile seconds, median times and Mrays/s
from ``block_until_ready``, diff statistics).  A failed check raises and the
script exits non-zero; without a GPU it exits non-zero at once.  The last
line is ``{"ok": true, "device": {"platform", "kind", "count"}}``.
"""
import argparse
import contextlib
import io
import json
import os
import re
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

REPS = 10                        # timed repetitions per measurement
BARS = {"mean_abs": 0.5, "frac_within_8": 0.99, "psnr": 45.0}
# (width, height, depth) of each phase; the mesh phases add the
# icosphere order of meshes.mesh_benchmark_scene
FORWARD = ((800, 600, 15), (1920, 1080, 4))
GRADS = (64, 48, 3)
MESH = (512, 384, 3, 4)
INVRENDER = ["--steps", "3", "--every", "1", "--engine", "auto"]
FOUR_FORWARD = (1920, 1080, 4)
FOUR_GRADS = (128, 96, 3)


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def emit(**row):
    print(json.dumps(row), flush=True)


def compiled(fn, *args):
    """(result, seconds) of the first call — compilation included."""
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    return out, time.perf_counter() - t0


def median_ms(fn, *args, reps=REPS):
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return float(np.median(times)) * 1e3


def u8(img):
    if np.asarray(img).dtype == np.uint8:
        return np.asarray(img)
    return (np.clip(np.asarray(img), 0.0, 1.0) * 255.0).astype(np.uint8)


def diff_check(name, a, b):
    from tpuray.io import image_diff_stats
    s = image_diff_stats(u8(a), u8(b))
    stats = {"mean_abs": s.mean_abs, "max_abs": s.max_abs,
             "frac_within_1": s.frac_within_1,
             "frac_within_8": s.frac_within_8, "psnr_db": s.psnr}
    check(s.mean_abs <= BARS["mean_abs"]
          and s.frac_within_8 >= BARS["frac_within_8"]
          and s.psnr >= BARS["psnr"], f"{name}: {s} misses the bars {BARS}")
    return stats


def camera_basis(width, height):
    from tpuray.camera import Camera, perspective_basis
    from tpuray.config import (GOLDEN_CAMERA_FOCAL, GOLDEN_CAMERA_FOV,
                               GOLDEN_CAMERA_LOOKDIR, GOLDEN_CAMERA_ORIGIN)
    cam = Camera(GOLDEN_CAMERA_ORIGIN, GOLDEN_CAMERA_LOOKDIR,
                 GOLDEN_CAMERA_FOV, GOLDEN_CAMERA_FOCAL)
    return perspective_basis(cam, width, height)


def tracer_on_cpu(scene, assets, basis, cfg, stride=64):
    """The tracer on the CPU device for every ``stride``-th pixel."""
    from tpuray.camera import generate_rays
    from tpuray.kernels.trace import trace_rays
    cpu = jax.devices("cpu")[0]
    ids = np.arange(cfg.num_pixels, dtype=np.uint32)[::stride]
    o, d = generate_rays(jax.device_put(basis, cpu), cfg.width, cfg.height)
    put = lambda x: jax.device_put(x, cpu)  # noqa: E731
    rgb = jax.jit(lambda s, a, o_, d_, i_: trace_rays(
        s, a, o_, d_, i_, cfg.replace(chunk_size=0)))(
        put(scene), put(assets), put(o[ids]), put(d[ids]), put(ids))
    return ids, np.asarray(rgb)


def phase_forward(scene, assets, width, height, depth):
    from tpuray.config import RenderConfig
    from tpuray.render import (choose_engine, render_from_basis,
                               render_from_basis_xla)
    cfg = RenderConfig(width=width, height=height, max_depth=depth)
    basis = camera_basis(width, height)
    engine = choose_engine(scene, cfg)
    check(engine == "pallas", f"render_from_basis picked {engine} on a GPU")
    kern = lambda s, b: render_from_basis(s, assets, b, cfg)  # noqa: E731
    img, kc = compiled(kern, scene, basis)
    k_ms = median_ms(kern, scene, basis)
    with jax.default_matmul_precision("highest"):
        trc = jax.jit(lambda s, b: render_from_basis_xla(s, assets, b, cfg))
        ref, tc = compiled(trc, scene, basis)
        t_ms = median_ms(trc, scene, basis)
    check(np.isfinite(np.asarray(img)).all(), "kernel image not finite")
    check(img.shape == (height, width, 3), f"kernel image {img.shape}")
    n = width * height
    emit(phase=f"forward_{width}x{height}_d{depth}",
         kernel={"compile_s": kc, "median_ms": k_ms,
                 "mrays_per_s": n / k_ms / 1e3},
         tracer={"compile_s": tc, "median_ms": t_ms,
                 "mrays_per_s": n / t_ms / 1e3},
         speedup=t_ms / k_ms,
         diff_vs_tracer=diff_check("kernel vs tracer", img, ref))
    return img, ref


def phase_raypng(kernel_img, width, height, depth, tmpdir):
    """The offline app at the same size; its PNG against the kernel image."""
    from tpuray.apps import raypng
    from tpuray.io import read_png
    path = os.path.join(tmpdir, f"raypng_{width}x{height}.png")
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        raypng.main(["--width", str(width), "--height", str(height),
                     "--depth", str(depth), "--repeat", "3", "--out", path])
    text = out.getvalue()
    check("engine: pallas" in text, "raypng did not take the kernel on the "
          "GPU:\n" + text)
    png = read_png(path)
    check(png.shape == (height, width, 3), f"raypng wrote {png.shape}")
    took = re.findall(r"Done, took: ([0-9]+) ms", text)
    emit(phase=f"raypng_{width}x{height}_d{depth}",
         seconds=time.perf_counter() - t0,
         best_ms=float(took[-1]) if took else None,
         diff_vs_kernel=diff_check("raypng vs kernel", png,
                                   u8(kernel_img)))


def phase_tracer_cpu(scene, assets, ref_gpu, width, height, depth):
    from tpuray.config import RenderConfig
    cfg = RenderConfig(width=width, height=height, max_depth=depth)
    t0 = time.perf_counter()
    ids, rgb_cpu = tracer_on_cpu(scene, assets,
                                 camera_basis(width, height), cfg)
    sub_gpu = np.asarray(ref_gpu).reshape(-1, 3)[ids]
    emit(phase=f"tracer_gpu_vs_cpu_{width}x{height}_d{depth}",
         pixels=int(ids.size),
         cpu_seconds=time.perf_counter() - t0,
         diff=diff_check("tracer gpu vs cpu", sub_gpu, rgb_cpu))


def phase_replay_grads(scene, width, height, depth):
    from tpuray import diff
    from tpuray.config import RenderConfig
    from tpuray.kernels.pallas_trace import render_pallas_record
    from tpuray.kernels.replay import replay_render
    from tpuray.render import render_from_basis_xla
    from tpuray.textures import seeded_assets
    assets = seeded_assets(0)
    cfg = RenderConfig(width=width, height=height, max_depth=depth,
                       loop="scan", chunk_size=0)
    basis = camera_basis(width, height)
    t0 = time.perf_counter()
    img_k, records = jax.jit(lambda s: render_pallas_record(
        s, assets, basis, cfg))(scene)
    with jax.default_matmul_precision("highest"):
        img_x = render_from_basis_xla(scene, assets, basis, cfg)
        agree = np.abs(np.asarray(img_k) - np.asarray(img_x)).max(-1) < 1e-4
        check(agree.mean() > 0.25, f"only {agree.mean():.3f} of pixels "
              "agree between kernel and tracer")
        w = jax.random.uniform(jax.random.PRNGKey(0), (height, width, 3)) \
            * jnp.asarray(agree)[..., None]
        d_scene, rest = diff.partition(scene)
        g_rep = jax.jit(jax.grad(lambda d: jnp.sum(replay_render(
            diff.combine(d, rest), assets, basis, records, cfg) * w)))(
            d_scene)
        g_scan = jax.jit(jax.grad(lambda d: jnp.sum(render_from_basis_xla(
            diff.combine(d, rest), assets, basis, cfg) * w)))(d_scene)
    worst = 0.0
    for (path, lr), ls in zip(jax.tree_util.tree_flatten_with_path(g_rep)[0],
                              jax.tree.leaves(g_scan)):
        lr, ls = np.asarray(lr), np.asarray(ls)
        if lr.size == 0:
            continue
        check(np.isfinite(lr).all() and np.isfinite(ls).all(),
              f"non-finite gradient at {jax.tree_util.keystr(path)}")
        rel = float(np.abs(lr - ls).max() / max(np.abs(ls).max(), 1e-3))
        check(rel <= 2e-2, f"{jax.tree_util.keystr(path)}: replay vs scan "
              f"gradient differs by {rel:.3g} of scale")
        worst = max(worst, rel)
    emit(phase=f"replay_grads_{width}x{height}_d{depth}",
         seconds=time.perf_counter() - t0,
         agree_frac=float(agree.mean()), worst_rel_err=worst)


def phase_invrender(tmpdir):
    from tpuray.apps import invrender
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        invrender.main(INVRENDER + ["--checkpoint",
                                    os.path.join(tmpdir, "inv.npz")])
    text = out.getvalue()
    losses = [float(x) for x in re.findall(r"loss ([0-9.eE+-]+)", text)]
    check("engine=pallas" in text, "invrender --engine auto did not take "
          "the kernel on the GPU:\n" + text)
    check(len(losses) == 3 and np.isfinite(losses).all()
          and losses[-1] < losses[0], f"invrender losses {losses}")
    emit(phase="invrender", steps=3, seconds=time.perf_counter() - t0,
         losses=losses)


def phase_triangles(assets, width, height, depth, order):
    from tpuray.config import RenderConfig
    from tpuray.meshes import mesh_benchmark_scene
    from tpuray.render import choose_engine, render_from_basis
    scene = mesh_benchmark_scene(order).to_scene()
    cfg = RenderConfig(width=width, height=height, max_depth=depth)
    basis = camera_basis(width, height)
    engine = choose_engine(scene, cfg)
    check(engine == "xla", f"triangle scene dispatched to {engine}")
    with jax.default_matmul_precision("highest"):
        fn = lambda s, b: render_from_basis(s, assets, b, cfg)  # noqa: E731
        img, c_s = compiled(fn, scene, basis)
        ms = median_ms(fn, scene, basis, reps=3)
    ids, rgb_cpu = tracer_on_cpu(scene, assets, basis, cfg)
    emit(phase=f"triangles_{width}x{height}_d{depth}",
         triangles=scene.num_triangles,
         engine=engine, compile_s=c_s, median_ms=ms,
         mrays_per_s=cfg.num_pixels / ms / 1e3,
         diff_vs_cpu=diff_check("triangles gpu vs cpu",
                                np.asarray(img).reshape(-1, 3)[ids],
                                rgb_cpu))


def one_card():
    import tempfile

    from tpuray.scene import canonical_scene_spec
    from tpuray.textures import seeded_assets
    scene = canonical_scene_spec().to_scene()
    assets = seeded_assets(0)
    with tempfile.TemporaryDirectory() as tmp:
        refs = []
        for cell in FORWARD:
            img, ref = phase_forward(scene, assets, *cell)
            phase_raypng(img, *cell, tmp)
            refs.append(ref)
        phase_tracer_cpu(scene, assets, refs[0], *FORWARD[0])
        phase_replay_grads(scene, *GRADS)
        phase_invrender(tmp)
    phase_triangles(assets, *MESH)


def shard_devices(x):
    return {s.device.id for s in x.addressable_shards}


def four_cards():
    from tpuray import diff
    from tpuray.config import RenderConfig
    from tpuray.kernels.pallas_trace import render_pallas
    from tpuray.meshes import mesh_benchmark_scene
    from tpuray.parallel.shard import (loss_and_scene_grad_sharded_pallas,
                                       make_mesh, render_scene_parallel,
                                       render_sharded_pallas)
    from tpuray.render import render_from_basis, render_from_basis_xla
    from tpuray.scene import canonical_scene_spec
    from tpuray.textures import seeded_assets
    check(len(jax.devices()) >= 4, f"{len(jax.devices())} GPUs, need 4")
    mesh = make_mesh(4)
    scene = canonical_scene_spec().to_scene()
    assets = seeded_assets(0)

    width, height, depth = FOUR_FORWARD
    cfg = RenderConfig(width=width, height=height, max_depth=depth)
    basis = camera_basis(width, height)
    one = lambda s, b: render_from_basis(s, assets, b, cfg)  # noqa: E731
    ref, _ = compiled(one, scene, basis)
    one_ms = median_ms(one, scene, basis)
    four = jax.jit(lambda s, b: render_sharded_pallas(s, assets, b, cfg,
                                                      mesh))
    img, c_s = compiled(four, scene, basis)
    four_ms = median_ms(four, scene, basis)
    devs = shard_devices(img)
    check(len(devs) == 4 and not img.sharding.is_fully_replicated,
          f"row shards sat on devices {devs}")
    emit(phase=f"render_sharded_pallas_{width}x{height}_d{depth}",
         devices=sorted(devs),
         compile_s=c_s, one_card_ms=one_ms, four_card_ms=four_ms,
         mrays_per_s=cfg.num_pixels / four_ms / 1e3,
         max_abs_vs_one_card=float(np.abs(np.asarray(img)
                                          - np.asarray(ref)).max()),
         diff_vs_one_card=diff_check("4-card vs 1-card", img, ref))

    width, height, depth = FOUR_GRADS
    gcfg = RenderConfig(width=width, height=height, max_depth=depth,
                        loop="scan", shadow_samples=0)
    gbasis = camera_basis(width, height)
    target = jnp.clip(render_pallas(scene, assets, gbasis, gcfg), 0.0,
                      1.0) * 0.9
    t0 = time.perf_counter()
    ploss, pgrads = loss_and_scene_grad_sharded_pallas(
        scene, assets, gbasis, target, gcfg, mesh)
    jax.block_until_ready(pgrads)
    p_s = time.perf_counter() - t0

    def single(s):
        img1 = jnp.clip(diff.render_pallas_diff(s, assets, gbasis, gcfg),
                        0.0, 1.0)
        return jnp.sum((img1 - target) ** 2)

    sloss, sgrads = jax.jit(lambda s: diff.value_and_scene_grad(
        single, s))(scene)
    check(abs(float(ploss) - float(sloss)) <= 1e-4 * abs(float(sloss)),
          f"sharded loss {float(ploss)} vs one card {float(sloss)}")
    worst = 0.0
    for pg, sg in zip(jax.tree.leaves(pgrads), jax.tree.leaves(sgrads)):
        pg, sg = np.asarray(pg), np.asarray(sg)
        if pg.size:
            err = float(np.abs(pg - sg).max() / max(np.abs(sg).max(), 1e-3))
            worst = max(worst, err)
    check(worst <= 5e-3, f"sharded grads differ by {worst:.3g} of scale")
    emit(phase=f"loss_and_scene_grad_sharded_pallas_{width}x{height}"
               f"_d{depth}",
         seconds_with_compile=p_s, loss=float(ploss),
         one_card_loss=float(sloss), worst_rel_grad_err=worst)

    width, height, depth, order = MESH
    tscene = mesh_benchmark_scene(order).to_scene()
    tcfg = RenderConfig(width=width, height=height, max_depth=depth)
    tbasis = camera_basis(width, height)
    with jax.default_matmul_precision("highest"):
        tref = render_from_basis_xla(tscene, assets, tbasis, tcfg)
        sp = jax.jit(lambda s, b: render_scene_parallel(s, assets, b, tcfg,
                                                        mesh))
        timg, c_s = compiled(sp, tscene, tbasis)
        sp_ms = median_ms(sp, tscene, tbasis, reps=3)
    devs = shard_devices(timg)
    check(len(devs) == 4, f"scene-parallel result on devices {devs}")
    emit(phase=f"render_scene_parallel_{width}x{height}_d{depth}",
         triangles=tscene.num_triangles, devices=sorted(devs),
         compile_s=c_s, median_ms=sp_ms,
         diff_vs_one_card=diff_check("scene-parallel vs 1-card", timg,
                                     tref))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the multi-card paths, on 4 GPUs")
    args = ap.parse_args(argv)

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"chip_smoke: JAX found no GPU (platform {dev.platform!r})")

    from tpuray.utils.compile_cache import enable_compile_cache
    from tpuray.utils.metrics import card_info
    enable_compile_cache()
    card = card_info()
    check(card is not None, "nvidia-smi did not report the card")
    print(card, flush=True)
    emit(device_kind=dev.device_kind, devices=len(jax.devices()),
         jax=jax.__version__, card=card)

    if args.four_cards:
        four_cards()
    else:
        one_card()
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))


if __name__ == "__main__":
    main()
