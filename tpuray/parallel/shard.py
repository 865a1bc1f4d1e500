"""Multi-device SPMD rendering: pixel sharding over a device Mesh.

The reference's only parallelism is a single-device 1-D NDRange with one
work-item per pixel (opencl_wrap.c:368-374, raygen.cl:10).  The
generalization here (SURVEY.md §2 parallelism table):

* **Forward**: the image is sharded by pixel blocks across a 1-D ``Mesh``
  axis ``"tiles"`` via ``shard_map`` — the renderer's data/context
  parallelism.  Rays are independent, the scene is tiny and replicated, so
  the forward pass needs **zero** cross-chip communication.
* **Backward**: every chip's pixels contribute gradients to the *same*
  shared scene parameters, so the backward pass ends in one
  ``jax.lax.psum`` of the scene-gradient pytree over the mesh — the
  renderer's gradient all-reduce.  XLA schedules it after the local
  backward compute and hands it to NCCL on GPUs.

Works unchanged on the GPUs of one host or on N virtual CPU devices
(``--xla_force_host_platform_device_count``).
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from .. import diff
from ..camera import PerspectiveBasis, generate_rays
from ..config import RenderConfig
from ..kernels.trace import trace_rays
from ..render import choose_engine
from ..scene import Scene
from ..textures import SceneAssets

AXIS = "tiles"


def make_mesh(n_devices: Optional[int] = None) -> Mesh:
    """1-D mesh over the first n_devices (default: all).

    Raises when fewer devices are available than requested — a silently
    degraded 1-device mesh would make sharding tests pass without testing
    sharding (tests force an 8-virtual-device CPU backend in conftest.py).
    """
    devs = jax.devices()
    if n_devices is not None:
        if len(devs) < n_devices:
            raise ValueError(
                f"requested a {n_devices}-device mesh but only {len(devs)} "
                f"device(s) are available on backend "
                f"{jax.default_backend()!r}; for CPU testing set "
                f"JAX_PLATFORMS=cpu and "
                f"XLA_FLAGS=--xla_force_host_platform_device_count="
                f"{n_devices}")
        devs = devs[:n_devices]
    return Mesh(np.asarray(devs), (AXIS,))


def _pad_pixels(n_pix: int, n_shards: int) -> int:
    per = -(-n_pix // n_shards)
    return per * n_shards


@functools.partial(jax.jit, static_argnames=("cfg", "mesh"))
def render_sharded(scene: Scene, assets: SceneAssets, basis: PerspectiveBasis,
                   cfg: RenderConfig, mesh: Mesh) -> jnp.ndarray:
    """Forward render with the pixel dimension sharded over ``mesh``.

    Returns float32 linear rgb [H, W, 3] (replicated output).
    """
    n = mesh.devices.size
    n_pix = cfg.num_pixels
    padded = _pad_pixels(n_pix, n)

    origins, dirs = generate_rays(basis, cfg.width, cfg.height)
    ids = jnp.arange(n_pix, dtype=jnp.uint32)
    pad = padded - n_pix
    origins = jnp.pad(origins, ((0, pad), (0, 0)))
    dirs = jnp.pad(dirs, ((0, pad), (0, 0)))
    # padded lanes trace a throwaway ray (dir 0 -> miss), masked out below
    ids = jnp.pad(ids, (0, pad))

    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P(None), P(None), P(AXIS), P(AXIS), P(AXIS)),
        out_specs=P(AXIS))
    def shard_trace(scene_, assets_, o, d, pid):
        return trace_rays(scene_, assets_, o, d, pid, cfg)

    rgb = shard_trace(scene, assets, origins, dirs, ids)
    return rgb[:n_pix].reshape(cfg.height, cfg.width, 3)


TRI_AXIS = "tri"


@functools.partial(jax.jit, static_argnames=("cfg", "mesh"))
def render_scene_parallel(scene: Scene, assets: SceneAssets,
                          basis: PerspectiveBasis, cfg: RenderConfig,
                          mesh: Mesh) -> jnp.ndarray:
    """Scene-parallel forward render: TRIANGLES sharded over ``mesh``.

    The renderer's tensor parallelism (SURVEY.md §2 scene-parallel row):
    every device traces ALL rays but tests only its 1/N of the
    triangles on each closest-hit / shadow-feeler query; the per-query
    reductions combine across the mesh axis (pmin of t + pmin of the
    winning global id, pmax of blocked, psum of transparent-crossing
    counts — see kernels/trace.py ``_tri_closest``/``_tri_any_blocker``).
    The scene tables are tiny and stay replicated; what scene
    parallelism divides is the dominant O(rays x triangles) brute-force
    intersection work.  Output is replicated and matches the
    single-device tracer up to one-ulp closest-hit ties (per-shard
    padding can change XLA's rounding on the pair math; the collectives
    preserve the first-in-order rule for exactly-equal t).  For
    mesh-heavy scenes this is the multi-chip scaling axis that pixel
    sharding cannot provide when the image is small.
    """
    if len(mesh.axis_names) != 1:
        raise ValueError(
            f"render_scene_parallel shards over a 1-D mesh; got axes "
            f"{mesh.axis_names} — use render_sharded_2d for pixels x "
            f"triangles")
    axis = mesh.axis_names[0]
    n = mesh.shape[axis]
    origins, dirs = generate_rays(basis, cfg.width, cfg.height)
    ids = jnp.arange(cfg.num_pixels, dtype=jnp.uint32)

    # check_vma=False: the tiled triangle scans (kernels/trace.py) start
    # from replicated carries and fold in this device's own triangle shard
    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P(), P(), P(None), P(None), P(None)),
        out_specs=P(None), check_vma=False)
    def shard_trace(scene_, assets_, o, d, pid):
        return trace_rays(scene_, assets_, o, d, pid, cfg,
                          tri_axis=axis, tri_shards=n)

    rgb = shard_trace(scene, assets, origins, dirs, ids)
    return rgb.reshape(cfg.height, cfg.width, 3)


@functools.partial(jax.jit, static_argnames=("cfg", "mesh"))
def render_sharded_2d(scene: Scene, assets: SceneAssets,
                      basis: PerspectiveBasis, cfg: RenderConfig,
                      mesh: Mesh) -> jnp.ndarray:
    """2-D parallel forward render: pixels x triangles over a 2-D mesh.

    ``mesh`` must have axes (AXIS, TRI_AXIS) = ("tiles", "tri"): the
    pixel dimension shards over "tiles" (zero communication, as in
    :func:`render_sharded`) and each pixel shard's triangle queries
    split over "tri" with pmin/pmax/psum reductions riding that axis
    only: the DP x TP layout of a renderer.  The GPUs of one host are
    joined all to all (NVLink), so any assignment of devices to the two
    axes is as good as another; only the axis sizes matter.
    """
    n_tiles = mesh.shape[AXIS]
    n_tri = mesh.shape[TRI_AXIS]
    n_pix = cfg.num_pixels
    padded = _pad_pixels(n_pix, n_tiles)

    origins, dirs = generate_rays(basis, cfg.width, cfg.height)
    ids = jnp.arange(n_pix, dtype=jnp.uint32)
    pad = padded - n_pix
    origins = jnp.pad(origins, ((0, pad), (0, 0)))
    dirs = jnp.pad(dirs, ((0, pad), (0, 0)))
    ids = jnp.pad(ids, (0, pad))

    # check_vma=False: as in render_scene_parallel
    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P(), P(), P(AXIS), P(AXIS), P(AXIS)),
        out_specs=P(AXIS), check_vma=False)
    def shard_trace(scene_, assets_, o, d, pid):
        return trace_rays(scene_, assets_, o, d, pid, cfg,
                          tri_axis=TRI_AXIS, tri_shards=n_tri)

    rgb = shard_trace(scene, assets, origins, dirs, ids)
    return rgb[:n_pix].reshape(cfg.height, cfg.width, 3)


def _check_kernel(scene: Scene, cfg: RenderConfig) -> None:
    """Raise, as render.choose_engine does for engine='pallas', where the
    compiled kernel cannot run (triangles, or no GPU)."""
    choose_engine(scene, cfg.replace(engine="pallas"))


@functools.partial(jax.jit, static_argnames=("cfg", "mesh", "interpret"))
def render_sharded_pallas(scene: Scene, assets: SceneAssets,
                          basis: PerspectiveBasis, cfg: RenderConfig,
                          mesh: Mesh, interpret: bool = False) -> jnp.ndarray:
    """Forward render on the GPU kernel with image ROWS sharded over
    ``mesh`` (scene + assets replicated — they are small next to the ray
    state, exactly the reference's everything-on-one-device model scaled
    out, SURVEY.md §2 parallelism table).

    Each device renders a contiguous row block with its own kernel launch,
    passing the shard's first global row as the kernel's ``row0`` —
    ray directions and the per-pixel RNG seed are computed from the GLOBAL
    row index, so the sharded render is bit-identical to the unsharded one.
    Zero cross-device communication in the forward pass.  ``interpret=True``
    runs the kernel in Pallas interpret mode (CPU meshes / virtual-device
    tests).
    """
    from ..kernels.pallas_trace import render_pallas

    if not interpret:
        _check_kernel(scene, cfg)
    n = mesh.devices.size
    rows_per = -(-cfg.height // n)
    sub_cfg = cfg.replace(height=rows_per)

    # check_vma=False: every input is replicated and the per-device output
    # varies only through axis_index (row0), which the varying-mesh-axes
    # checker cannot see through a pallas_call's ShapeDtypeStructs
    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P(), P(), P()),
        out_specs=P(AXIS), check_vma=False)
    def shard_render(scene_, assets_, basis_):
        row0 = (jax.lax.axis_index(AXIS) * rows_per).astype(jnp.float32)
        return render_pallas(scene_, assets_, basis_, sub_cfg,
                             interpret=interpret, row0=row0)

    img = shard_render(scene, assets, basis)
    return img[:cfg.height]


def _local_loss(scene: Scene, assets: SceneAssets, o, d, pid, target,
                cfg: RenderConfig):
    rgb = trace_rays(scene, assets, o, d, pid, cfg)
    return jnp.sum((rgb - target) ** 2)


@functools.partial(jax.jit, static_argnames=("cfg", "mesh"))
def loss_and_scene_grad_sharded(
        scene: Scene, assets: SceneAssets, basis: PerspectiveBasis,
        target: jnp.ndarray, cfg: RenderConfig,
        mesh: Mesh) -> Tuple[jnp.ndarray, Scene]:
    """L2 image loss + gradient w.r.t. every float leaf of ``scene``,
    computed with pixels sharded over the mesh and one psum of the scene
    gradients (the renderer's gradient all-reduce).

    ``target`` is [H*W, 3] float32 linear rgb.  Requires cfg.loop == 'scan'
    (the reverse-differentiable trace).
    """
    n = mesh.devices.size
    n_pix = cfg.num_pixels
    padded = _pad_pixels(n_pix, n)
    pad = padded - n_pix

    origins, dirs = generate_rays(basis, cfg.width, cfg.height)
    origins = jnp.pad(origins, ((0, pad), (0, 0)))
    dirs = jnp.pad(dirs, ((0, pad), (0, 0)))
    ids = jnp.pad(jnp.arange(n_pix, dtype=jnp.uint32), (0, pad))
    # padded lanes are excluded from the loss via the `valid` mask
    # (jnp.arange(padded) < n_pix); their target is just zero-padded.
    target = jnp.pad(target.reshape(-1, 3), ((0, pad), (0, 0)))
    valid = (jnp.arange(padded) < n_pix).astype(jnp.float32)[:, None]

    def local_loss(scene_, assets_, o, d, pid, tgt, val):
        rgb = trace_rays(scene_, assets_, o, d, pid, cfg)
        return jnp.sum(val * (rgb - tgt) ** 2)

    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P(None), P(None), P(AXIS), P(AXIS), P(AXIS), P(AXIS),
                  P(AXIS)),
        out_specs=(P(), P()))
    def shard_grad(scene_, assets_, o, d, pid, tgt, val):
        loss, g = diff.value_and_scene_grad(
            local_loss, scene_, assets_, o, d, pid, tgt, val)
        # the gradient all-reduce: every chip's pixels -> shared scene params
        return (jax.lax.psum(loss, AXIS),
                jax.tree.map(lambda x: jax.lax.psum(x, AXIS), g))

    return shard_grad(scene, assets, origins, dirs, ids, target, valid)


@functools.partial(jax.jit, static_argnames=("cfg", "mesh", "interpret"))
def loss_and_scene_grad_sharded_pallas(
        scene: Scene, assets: SceneAssets, basis: PerspectiveBasis,
        target: jnp.ndarray, cfg: RenderConfig, mesh: Mesh,
        interpret: bool = False) -> Tuple[jnp.ndarray, Scene]:
    """L2 loss + scene gradient on the GPU kernel, image rows sharded over
    ``mesh`` — multi-device inverse rendering at kernel speed.

    Each device runs the record-mode kernel forward on its row block (the
    saved-path replay custom VJP, diff.render_pallas_diff, with the
    shard's first global row as ``row0``), backward replays locally, and
    the scene-gradient pytree is psum'd over the mesh — the same one
    all-reduce as the XLA path (loss_and_scene_grad_sharded), but with
    the forward on the kernel.  ``target`` is [H, W, 3] float32
    linear rgb.  The loss is display-space (clipped to [0, 1]) to match
    apps/invrender.py's objective.
    """
    if not interpret:
        _check_kernel(scene, cfg)
    n = mesh.devices.size
    rows_per = -(-cfg.height // n)
    sub_cfg = cfg.replace(height=rows_per)

    # pad target rows to n * rows_per; padded rows are masked from the loss
    pad = n * rows_per - cfg.height
    target = jnp.pad(target, ((0, pad), (0, 0), (0, 0)))

    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P(), P(), P(), P(AXIS)),
        out_specs=(P(), P()), check_vma=False)
    def shard_grad(scene_, assets_, basis_, tgt):
        row0 = (jax.lax.axis_index(AXIS) * rows_per).astype(jnp.float32)

        def local_loss(s):
            img = diff.render_pallas_diff(s, assets_, basis_, sub_cfg,
                                          row0, interpret)
            img = jnp.clip(img, 0.0, 1.0)
            # rows past the true image height carry zero loss
            gr = row0 + jnp.arange(rows_per, dtype=jnp.float32)
            valid = (gr < cfg.height).astype(jnp.float32)[:, None, None]
            return jnp.sum(valid * (img - tgt) ** 2)

        loss, g = diff.value_and_scene_grad(lambda s_: local_loss(s_),
                                            scene_)
        return (jax.lax.psum(loss, AXIS),
                jax.tree.map(lambda x: jax.lax.psum(x, AXIS), g))

    return shard_grad(scene, assets, basis, target)


def dryrun(n_devices: int) -> None:
    """Compile + execute one sharded forward, one sharded forward+grad
    step, and one kernel-under-shard_map render over an ``n_devices`` mesh
    on tiny shapes.  On a CPU mesh (the virtual-device rig) the kernel runs
    in interpret mode.  Also exercises the multi-host bootstrap path (a
    no-op single-process, SURVEY.md §5 distributed backend)."""
    from ..camera import Camera, perspective_basis
    from ..config import (GOLDEN_CAMERA_LOOKDIR, GOLDEN_CAMERA_ORIGIN)
    from ..scene import canonical_scene_spec
    from ..textures import solid_assets
    from . import distributed

    distributed.ensure_initialized()
    mesh = make_mesh(n_devices)
    scene = canonical_scene_spec().to_scene()
    assets = solid_assets()
    cfg = RenderConfig(width=32, height=16, max_depth=2, chunk_size=0,
                       loop="scan", scan_iters=10)
    cam = Camera(GOLDEN_CAMERA_ORIGIN, GOLDEN_CAMERA_LOOKDIR, 90.0, 1.0)
    basis = perspective_basis(cam, cfg.width, cfg.height)

    img = render_sharded(scene, assets, basis, cfg, mesh)
    img.block_until_ready()
    assert img.shape == (cfg.height, cfg.width, 3)

    interp = jax.default_backend() == "cpu"
    pimg = render_sharded_pallas(scene, assets, basis, cfg, mesh,
                                 interpret=interp)
    pimg.block_until_ready()
    assert pimg.shape == (cfg.height, cfg.width, 3)

    target = jnp.zeros((cfg.num_pixels, 3), jnp.float32)
    loss, grads = loss_and_scene_grad_sharded(scene, assets, basis, target,
                                              cfg, mesh)
    loss.block_until_ready()
    assert np.isfinite(float(loss))

    # sharded replay-VJP (kernel fwd + replay bwd per row shard)
    ptarget = jnp.zeros((cfg.height, cfg.width, 3), jnp.float32)
    ploss, _ = loss_and_scene_grad_sharded_pallas(
        scene, assets, basis, ptarget, cfg, mesh, interpret=interp)
    ploss.block_until_ready()
    assert np.isfinite(float(ploss))

    # scene parallelism (triangles sharded, pmin/pmax/psum reductions)
    # and the 2-D pixels x triangles mesh
    from ..meshes import mesh_benchmark_scene
    tscene = mesh_benchmark_scene(order=0, torus_res=(8, 4)).to_scene()
    simg = render_scene_parallel(tscene, assets, basis, cfg, mesh)
    simg.block_until_ready()
    assert simg.shape == (cfg.height, cfg.width, 3)
    if n_devices % 2 == 0:
        mesh2d = Mesh(
            np.asarray(jax.devices()[:n_devices]).reshape(
                n_devices // 2, 2), (AXIS, TRI_AXIS))
        img2d = render_sharded_2d(tscene, assets, basis, cfg, mesh2d)
        img2d.block_until_ready()
        assert img2d.shape == (cfg.height, cfg.width, 3)
