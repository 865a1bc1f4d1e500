"""Triangle-mesh extension tests.

The reference has no triangles; meshes are validated against analytic
scenes (SURVEY.md §6): a high-order icosphere must render like the sphere
it approximates.
"""
import numpy as np
import jax.numpy as jnp

from tpuray.camera import Camera, generate_rays, perspective_basis
from tpuray.config import RenderConfig
from tpuray.meshes import add_mesh, icosphere, mesh_benchmark_scene
from tpuray.kernels.trace import trace_rays
from tpuray.scene import (PLASTIC, LightSpec, PlaneSpec, SceneSpec,
                          SphereSpec)
from tpuray.sceneio import dumps_scene, loads_scene
from tpuray.textures import solid_assets


def _cam():
    return Camera((0.0, 1.0, -4.0), (0.0, 0.0, 1.0), 90.0, 1.0)


def test_icosphere_counts():
    for order, n in [(0, 20), (1, 80), (2, 320), (3, 1280)]:
        v, f = icosphere(order)
        assert f.shape == (n, 3)
        np.testing.assert_allclose(np.linalg.norm(v, axis=1), 1.0,
                                   atol=1e-12)


def test_icosphere_renders_like_analytic_sphere():
    mat = PLASTIC.replace(rgb=(0.9, 0.2, 0.2))
    base = SceneSpec(
        planes=[PlaneSpec((0, 1, 0), (0, -1, 0), PLASTIC)],
        lights=[LightSpec((2.0, 4.0, -2.0), 0.1, 30.0, (1, 1, 1))])
    analytic = SceneSpec(spheres=[SphereSpec((0.0, 1.0, 1.0), 1.0, mat)],
                         planes=base.planes, lights=base.lights)
    v, f = icosphere(4)  # 5120 tris ~ sphere to ~0.1% radius error
    meshed = SceneSpec(planes=base.planes, lights=base.lights)
    add_mesh(meshed, v, f, mat, scale=1.0, offset=(0.0, 1.0, 1.0))

    W, H = 48, 32
    cfg = RenderConfig(width=W, height=H, max_depth=2, chunk_size=0,
                       shadow_samples=0)
    basis = perspective_basis(_cam(), W, H)
    o, d = generate_rays(basis, W, H)
    ids = jnp.arange(W * H, dtype=jnp.uint32)
    assets = solid_assets()

    img_a = np.asarray(trace_rays(analytic.to_scene(), assets, o, d, ids,
                                  cfg)).reshape(H, W, 3)
    img_m = np.asarray(trace_rays(meshed.to_scene(), assets, o, d, ids,
                                  cfg)).reshape(H, W, 3)
    diff = np.abs(img_a - img_m)
    # agreement everywhere except the silhouette ring (faceting)
    assert (diff.max(-1) < 0.05).mean() > 0.93, \
        f"mesh-vs-analytic agreement {(diff.max(-1) < 0.05).mean()}"


def test_mesh_scene_archive_roundtrip():
    spec = mesh_benchmark_scene(order=2)
    n_tris = len(spec.triangles)
    assert n_tris > 2000
    buf = dumps_scene(spec)
    back = loads_scene(buf)
    assert len(back.triangles) == n_tris
    np.testing.assert_allclose(
        np.asarray(back.triangles[7].v1, np.float32),
        np.asarray(spec.triangles[7].v1, np.float32))
