"""Differentiable-rendering utilities.

The reference has no gradient analog (SURVEY.md §4); differentiability is a
north-star extension.  The ``Scene`` pytree mixes float leaves (geometry,
materials, lights — all differentiable) with int/bool leaves (texture ids,
material flags — structural).  These helpers split/rejoin the two so
``jax.grad`` sees a floats-only pytree.
"""
from __future__ import annotations

import functools
from typing import Any, Callable, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .camera import PerspectiveBasis
from .config import RenderConfig
from .scene import Scene
from .textures import SceneAssets


def _is_float_leaf(x) -> bool:
    return hasattr(x, "dtype") and jnp.issubdtype(x.dtype, jnp.floating)


def partition(tree) -> Tuple[Any, Any]:
    """Split a pytree into (float_leaves, other_leaves); each side keeps the
    full structure with ``None`` in the other side's positions."""
    diff = jax.tree.map(lambda x: x if _is_float_leaf(x) else None, tree)
    rest = jax.tree.map(lambda x: None if _is_float_leaf(x) else x, tree)
    return diff, rest


def combine(diff, rest):
    """Inverse of :func:`partition`."""
    return jax.tree.map(lambda a, b: a if a is not None else b, diff, rest,
                        is_leaf=lambda x: x is None)


def value_and_scene_grad(fn: Callable[..., jnp.ndarray], scene: Scene,
                         *args, **kw):
    """(value, grad) of ``fn(scene, *args)`` w.r.t. every float leaf of
    ``scene``.  The returned grad pytree has Scene structure with ``None``
    in non-differentiable positions."""
    diff, rest = partition(scene)

    def wrapped(d):
        return fn(combine(d, rest), *args, **kw)

    return jax.value_and_grad(wrapped)(diff)


def l2_image_loss(rendered: jnp.ndarray, target: jnp.ndarray) -> jnp.ndarray:
    return jnp.sum((rendered - target) ** 2)


# ---------------------------------------------------------------------------
# GPU-kernel custom VJP: record-mode forward, saved-path replay backward
# ---------------------------------------------------------------------------

def _zero_cotangent(tree):
    """Cotangent pytree for a primal that carries no gradient: float leaves
    get zeros, integer/bool leaves get float0 (JAX's unit tangent type)."""
    def leaf(x):
        if jnp.issubdtype(jnp.result_type(x), jnp.floating):
            return jnp.zeros_like(x)
        return np.zeros(jnp.shape(x), jax.dtypes.float0)
    return jax.tree.map(leaf, tree)


@functools.partial(jax.custom_vjp, nondiff_argnums=(3, 5))
def render_pallas_diff(scene: Scene, assets: SceneAssets,
                       basis: PerspectiveBasis, cfg: RenderConfig,
                       row0=0.0, interpret: bool = False):
    """Differentiable render on the GPU kernel.

    Forward: the kernel in record mode (kernels/pallas_trace.py — the same
    image, plus per-node path records).  Backward: AD through the dense
    replay tracer (kernels/replay.py), which reshades the recorded paths
    analytically — no primitive search, no shadow feelers, no while loop.
    Gradients flow to every float leaf of ``scene`` and to the camera
    ``basis``; the u8 texture/skybox ``assets`` get zero cotangents (they
    are inputs, not parameters).  The scan-tracer equivalence is tested in
    tests/test_pallas_vjp.py.  Scenes with triangles raise (the kernel has
    none; differentiate them through the scan tracer).

    ``row0`` is the shard's first global image row (row-sharded inverse
    rendering, parallel/shard.py) — a traced value with no gradient.
    """
    from .kernels.pallas_trace import render_pallas
    return render_pallas(scene, assets, basis, cfg, interpret=interpret,
                         row0=row0)


def _rpd_fwd(scene, assets, basis, cfg, row0, interpret):
    from .kernels.pallas_trace import render_pallas_record
    img, records = render_pallas_record(scene, assets, basis, cfg,
                                        interpret=interpret, row0=row0)
    return img, (scene, assets, basis, records, row0)


def _rpd_bwd(cfg, interpret, res, g):
    from .kernels.replay import replay_render
    scene, assets, basis, records, row0 = res
    d_scene, d_rest = partition(scene)

    def replay(d, b):
        return replay_render(combine(d, d_rest), assets, b, records, cfg,
                             row0)

    _, vjp = jax.vjp(replay, d_scene, basis)
    gd_scene, g_basis = vjp(g)
    g_scene = combine(gd_scene, _zero_cotangent(d_rest))
    return g_scene, _zero_cotangent(assets), g_basis, _zero_cotangent(
        jnp.asarray(row0, jnp.float32))


render_pallas_diff.defvjp(_rpd_fwd, _rpd_bwd)
