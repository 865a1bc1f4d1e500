"""Public forward-rendering API.

The analog of the reference's whole host pipeline (raypng.c:11-100):
camera perspective -> raygen -> raytracer -> image, except the "runtime
wrapper" layer (opencl_wrap.c) is subsumed by ``jax.jit`` — the first call
traces + compiles (the analog of clBuildProgram, opencl_wrap.c:85-105) and
subsequent calls with new camera/scene *values* reuse the executable, which
is what makes interactive param-swap re-render cheap (rayinteractive.c
re-binds 6 camera scalars per keypress; here we re-call the jitted function
with a new ``PerspectiveBasis`` pytree).

Two engines: the GPU kernel (kernels/pallas_trace.py) and the XLA tracer
(kernels/trace.py); :func:`choose_engine` holds the one rule between them.
The tracer runs chunked: rays are traced in ``cfg.chunk_size`` pixel blocks
via ``lax.map`` so device memory stays bounded and each chunk's DFS
while-loop terminates on its own worst case.
"""
from __future__ import annotations

import functools
import jax
import jax.numpy as jnp
import numpy as np

from .camera import Camera, PerspectiveBasis, generate_rays, perspective_basis
from .config import RenderConfig
from .kernels.trace import quantize_image, trace_rays
from .scene import Scene
from .textures import SceneAssets


def _pad_to(x, n, axis=0):
    pad = n - x.shape[axis]
    if pad <= 0:
        return x
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, pad)
    return jnp.pad(x, widths)


def choose_engine(scene: Scene, cfg: RenderConfig,
                  backend: str = None) -> str:
    """The engine that renders ``scene`` on ``backend`` (default: JAX's
    default backend): ``"pallas"`` (the GPU kernel) or ``"xla"`` (the
    tracer).

    ``cfg.engine='auto'`` takes the kernel on a GPU for scenes without
    triangles and the tracer for everything else.  ``'pallas'`` on a scene
    or backend the kernel cannot take raises instead of falling back;
    ``'xla'`` always takes the tracer."""
    backend = backend or jax.default_backend()
    if cfg.engine == "xla":
        return "xla"
    if cfg.engine not in ("auto", "pallas"):
        raise ValueError(f"unknown engine {cfg.engine!r}")
    why = None
    if scene.num_triangles:
        why = (f"the scene has {scene.num_triangles} triangles and the "
               "kernel renders spheres, planes and lights only")
    elif backend != "gpu":
        why = (f"the kernel is compiled for the GPU and the backend is "
               f"{backend!r} (tests run it with interpret=True through "
               "kernels.pallas_trace.render_pallas)")
    if why is None:
        return "pallas"
    if cfg.engine == "pallas":
        raise ValueError(f"engine='pallas' cannot render here: {why}; "
                         "use engine='auto' or 'xla'")
    return "xla"


@functools.partial(jax.jit, static_argnames=("cfg",))
def render_from_basis_xla(scene: Scene, assets: SceneAssets,
                          basis: PerspectiveBasis, cfg: RenderConfig):
    """Jitted end-to-end render: basis -> primary rays -> traced rgb.

    Returns float32 linear rgb [H, W, 3] (pre-quantization)."""
    width, height = cfg.width, cfg.height
    n_pix = width * height
    origins, dirs = generate_rays(basis, width, height)
    pixel_ids = jnp.arange(n_pix, dtype=jnp.uint32)

    chunk = cfg.chunk_size or n_pix
    chunk = min(chunk, n_pix)
    n_chunks = -(-n_pix // chunk)
    padded = n_chunks * chunk

    origins = _pad_to(origins, padded).reshape(n_chunks, chunk, 3)
    dirs = _pad_to(dirs, padded).reshape(n_chunks, chunk, 3)
    pixel_ids = _pad_to(pixel_ids, padded).reshape(n_chunks, chunk)

    def run(args):
        o, d, ids = args
        return trace_rays(scene, assets, o, d, ids, cfg)

    if n_chunks == 1:
        rgb = run((origins[0], dirs[0], pixel_ids[0]))
    else:
        rgb = jax.lax.map(run, (origins, dirs, pixel_ids)).reshape(-1, 3)
        rgb = rgb[:n_pix]
    return rgb.reshape(height, width, 3)


@functools.partial(jax.jit, static_argnames=("cfg",))
def render_from_basis_pallas(scene: Scene, assets: SceneAssets,
                             basis: PerspectiveBasis, cfg: RenderConfig):
    from .kernels.pallas_trace import render_pallas
    return render_pallas(scene, assets, basis, cfg)


def render_from_basis(scene: Scene, assets: SceneAssets,
                      basis: PerspectiveBasis, cfg: RenderConfig):
    """Forward render on the engine :func:`choose_engine` picks."""
    if choose_engine(scene, cfg) == "pallas":
        return render_from_basis_pallas(scene, assets, basis, cfg)
    return render_from_basis_xla(scene, assets, basis, cfg)


def render(scene: Scene, assets: SceneAssets, camera: Camera,
           cfg: RenderConfig) -> jnp.ndarray:
    """Render to float32 linear rgb [H, W, 3]."""
    basis = perspective_basis(camera, cfg.width, cfg.height)
    return render_from_basis(scene, assets, basis, cfg)


def render_u8(scene: Scene, assets: SceneAssets, camera: Camera,
              cfg: RenderConfig) -> np.ndarray:
    """Render and quantize exactly like the reference output path
    (clamp * 255, truncate; raytracing.cl:193-194)."""
    rgb = render(scene, assets, camera, cfg)
    img = quantize_image(rgb.reshape(-1, 3), cfg.width, cfg.height)
    return np.asarray(jax.device_get(img))
