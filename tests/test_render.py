"""End-to-end render tests: golden parity, sharding, and gradients.

The golden test validates against the reference's only correctness artifact,
its committed 800x600 render ``out/scene.png`` (raypng.c:100), read from a
reference checkout, on a subsampled pixel grid (CPU CI uses every Nth pixel
to stay fast).  The soft-shadow RNG is seeded by absolute pixel id
(raytracing.cl:32-34), so a traced subset reproduces those exact pixels.
"""
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from tpuray.camera import Camera, generate_rays, perspective_basis
from tpuray.config import (GOLDEN_CAMERA_FOCAL, GOLDEN_CAMERA_FOV,
                           GOLDEN_CAMERA_LOOKDIR, GOLDEN_CAMERA_ORIGIN,
                           RenderConfig)
from tpuray import diff
from tpuray.io import read_png
from tpuray.kernels.trace import trace_rays
from tpuray.scene import (GLASS, PLASTIC, LightSpec, PlaneSpec, SceneSpec,
                          SphereSpec, canonical_scene_spec)
from tpuray.textures import load_default_assets, seeded_assets, solid_assets


def _golden_camera():
    return Camera(GOLDEN_CAMERA_ORIGIN, GOLDEN_CAMERA_LOOKDIR,
                  GOLDEN_CAMERA_FOV, GOLDEN_CAMERA_FOCAL)


def _tiny_scene() -> SceneSpec:
    return SceneSpec(
        spheres=[
            SphereSpec((0.0, 1.0, 3.0), 1.0,
                       PLASTIC.replace(rgb=(1.0, 0.2, 0.2))),
            SphereSpec((1.5, 0.7, 2.0), 0.7, GLASS),
        ],
        planes=[PlaneSpec((0.0, 1.0, 0.0), (0.0, 0.0, 0.0),
                          PLASTIC.replace(rgb=(0.4, 0.4, 0.4)))],
        lights=[LightSpec((2.0, 4.0, 0.0), 0.1, 30.0, (1.0, 1.0, 1.0))],
    )


class TestRowOffsetRays:
    def test_row0_generates_the_global_row_block(self):
        """generate_rays(row0=r) must equal rows [r, r+h) of the full-image
        rays — the contract row-sharded rendering and the sharded replay
        VJP rely on (parallel/shard.py, kernels/replay.py)."""
        basis = perspective_basis(_golden_camera(), 64, 48)
        o_full, d_full = generate_rays(basis, 64, 48)
        o_shard, d_shard = generate_rays(basis, 64, 16, row0=24.0)
        np.testing.assert_array_equal(
            np.asarray(d_shard),
            np.asarray(d_full).reshape(48, 64, 3)[24:40].reshape(-1, 3))
        np.testing.assert_array_equal(np.asarray(o_shard),
                                      np.asarray(o_full)[:16 * 64])


class TestBilinearMegakernel:
    def test_megakernel_bilinear_matches_tracer(self):
        """cfg.filter='bilinear' on the GPU kernel (4 taps per fetch,
        primitives.bilinear_taps) must reproduce the XLA tracer's bilinear
        render on the textured/skyboxed render.map scene."""
        from tpuray.kernels.pallas_trace import render_pallas
        from tpuray.render import render_from_basis_xla
        scene = canonical_scene_spec().to_scene()
        assets = seeded_assets(0, tex_size=64, skybox_shape=(96, 128))
        W, H = 128, 32
        cfg = RenderConfig(width=W, height=H, max_depth=3, chunk_size=0,
                           filter="bilinear")
        basis = perspective_basis(_golden_camera(), W, H)
        a = np.asarray(render_pallas(scene, assets, basis, cfg,
                                     interpret=True))
        b = np.asarray(render_from_basis_xla(scene, assets, basis, cfg))
        d = np.abs(a - b).max(-1)
        assert not np.isnan(a).any()
        assert (d < 1e-2).mean() > 0.995, f"mismatch {(d >= 1e-2).mean()}"
        # bilinear must actually differ from nearest somewhere (the sky
        # gradient bands / texture edges), or the mode silently no-ops
        nearest = np.asarray(render_pallas(
            scene, assets, basis, cfg.replace(filter="nearest"),
            interpret=True))
        assert np.abs(a - nearest).max() > 1e-3


class TestGoldenParity:
    STRIDE = 331  # prime: samples all over the image

    def test_subsampled_pixels_match_reference_render(self, reference):
        scene = canonical_scene_spec().to_scene()
        assets = load_default_assets()
        cfg = RenderConfig(chunk_size=0)
        basis = perspective_basis(_golden_camera(), cfg.width, cfg.height)
        o, d = generate_rays(basis, cfg.width, cfg.height)
        ids = np.arange(cfg.num_pixels, dtype=np.uint32)[::self.STRIDE]
        rgb = trace_rays(scene, assets, jnp.asarray(o)[ids],
                         jnp.asarray(d)[ids], jnp.asarray(ids), cfg)
        ours = np.asarray(jnp.clip(rgb, 0.0, 1.0) * 255.0).astype(np.uint8)

        gold = read_png(os.path.join(reference, "out", "scene.png")
                        ).reshape(-1, 3)[ids]
        d8 = np.abs(ours.astype(np.int32) - gold.astype(np.int32))
        # float32-rounding tolerance: the vast majority of subpixels must be
        # within +-1 of the OpenCL render; a tiny fraction may fall on
        # soft-shadow / silhouette boundaries
        assert (d8 <= 1).mean() > 0.93, f"within-1 frac {(d8 <= 1).mean()}"
        assert (d8 <= 8).mean() > 0.99, f"within-8 frac {(d8 <= 8).mean()}"
        assert d8.mean() < 2.0, f"mean |diff| {d8.mean()}"


class TestShardedRender:
    """Sharding on the 8 virtual CPU devices conftest.py configures.

    Every check compares a sharded program with its single-device
    counterpart; make_mesh raises when fewer devices exist, so a 1-device
    backend cannot pass these by accident."""

    CFG = RenderConfig(width=64, height=32, max_depth=3, chunk_size=0)

    @classmethod
    def _common(cls):
        if not hasattr(cls, "_cache"):
            from tpuray.parallel.shard import make_mesh
            scene = _tiny_scene().to_scene()
            assets = solid_assets()
            cfg = cls.CFG
            basis = perspective_basis(_golden_camera(), cfg.width,
                                      cfg.height)
            o, d = generate_rays(basis, cfg.width, cfg.height)
            ids = jnp.arange(cfg.num_pixels, dtype=jnp.uint32)
            ref = trace_rays(scene, assets, o, d, ids, cfg).reshape(
                cfg.height, cfg.width, 3)
            cls._cache = (make_mesh(8), scene, assets, basis, ref)
        return cls._cache

    @staticmethod
    def _mesh_scene():
        from tpuray.meshes import mesh_benchmark_scene
        tscene = mesh_benchmark_scene(order=1, torus_res=(12, 8)).to_scene()
        cfg = RenderConfig(width=32, height=16, max_depth=2, chunk_size=0)
        basis = perspective_basis(_golden_camera(), cfg.width, cfg.height)
        o, d = generate_rays(basis, cfg.width, cfg.height)
        ids = jnp.arange(cfg.num_pixels, dtype=jnp.uint32)
        ref = trace_rays(tscene, solid_assets(), o, d, ids, cfg).reshape(
            cfg.height, cfg.width, 3)
        return tscene, cfg, basis, ref

    def test_mesh_has_8_devices(self):
        mesh = self._common()[0]
        assert mesh.devices.size == 8
        assert len({d.id for d in mesh.devices.flat}) == 8

    def test_sharded_matches_single_device(self):
        from tpuray.parallel.shard import render_sharded
        mesh, scene, assets, basis, ref = self._common()
        img = render_sharded(scene, assets, basis, self.CFG, mesh)
        np.testing.assert_allclose(np.asarray(img), np.asarray(ref),
                                   atol=1e-5)

    def test_sharded_grad_runs_and_is_finite(self):
        from tpuray.parallel.shard import loss_and_scene_grad_sharded
        mesh, scene, assets, _, _ = self._common()
        gcfg = RenderConfig(width=32, height=16, max_depth=2, chunk_size=0,
                            loop="scan", scan_iters=8)
        gbasis = perspective_basis(_golden_camera(), gcfg.width, gcfg.height)
        target = jnp.zeros((gcfg.num_pixels, 3), jnp.float32)
        loss, grads = loss_and_scene_grad_sharded(scene, assets, gbasis,
                                                  target, gcfg, mesh)
        assert np.isfinite(float(loss)) and float(loss) > 0
        leaves = [g for g in jax.tree.leaves(grads) if g is not None]
        assert leaves and all(np.all(np.isfinite(np.asarray(g)))
                              for g in leaves)
        assert np.any(np.asarray(grads.light_intensity) != 0)

    def test_megakernel_under_shard_map(self):
        """The GPU kernel (interpret mode) under shard_map: rows sharded,
        scene replicated, each shard's first global row as ``row0``."""
        from tpuray.parallel.shard import render_sharded_pallas
        mesh, scene, assets, basis, ref = self._common()
        img = render_sharded_pallas(scene, assets, basis, self.CFG, mesh,
                                    interpret=True)
        np.testing.assert_allclose(np.asarray(img), np.asarray(ref),
                                   atol=5e-4)

    def test_scene_parallel_matches_single_device(self):
        """Triangles sharded over the mesh, rays replicated, pmin/pmax/psum
        per query — equal to the single-device tracer (tie rule kept; atol
        covers closest-hit ties one ulp of t apart across the pmin)."""
        from tpuray.parallel.shard import render_scene_parallel
        mesh = self._common()[0]
        tscene, tcfg, tbasis, tref = self._mesh_scene()
        img = render_scene_parallel(tscene, solid_assets(), tbasis, tcfg,
                                    mesh)
        np.testing.assert_allclose(np.asarray(img), np.asarray(tref),
                                   atol=1e-4)

    def test_2d_mesh_pixels_x_triangles(self):
        from jax.sharding import Mesh

        from tpuray.parallel.shard import AXIS, TRI_AXIS, render_sharded_2d
        tscene, tcfg, tbasis, tref = self._mesh_scene()
        mesh2d = Mesh(np.asarray(jax.devices()[:8]).reshape(4, 2),
                      (AXIS, TRI_AXIS))
        img = render_sharded_2d(tscene, solid_assets(), tbasis, tcfg, mesh2d)
        np.testing.assert_allclose(np.asarray(img), np.asarray(tref),
                                   atol=1e-4)

    def test_scene_parallel_tiled_shards(self):
        """Triangle shards larger than one scan tile (1,472 triangles over
        2 devices: two 512-triangle tiles each) take the tiled-scan path
        under scene parallelism."""
        from tpuray.meshes import mesh_benchmark_scene
        from tpuray.parallel.shard import make_mesh, render_scene_parallel
        tscene = mesh_benchmark_scene(order=3, torus_res=(12, 8)).to_scene()
        assert tscene.num_triangles == 1472
        cfg = RenderConfig(width=16, height=8, max_depth=2, chunk_size=0)
        basis = perspective_basis(_golden_camera(), cfg.width, cfg.height)
        o, d = generate_rays(basis, cfg.width, cfg.height)
        ids = jnp.arange(cfg.num_pixels, dtype=jnp.uint32)
        ref = trace_rays(tscene, solid_assets(), o, d, ids, cfg)
        img = render_scene_parallel(tscene, solid_assets(), basis, cfg,
                                    make_mesh(2))
        np.testing.assert_allclose(np.asarray(img).reshape(-1, 3),
                                   np.asarray(ref), atol=1e-4)

    def test_sharded_replay_vjp_matches_single_device(self):
        """Kernel record forward + replay backward per row shard, scene
        grads psum'd — equal to the single-device custom VJP's loss and
        grads (same records, same replay math)."""
        from tpuray.parallel.shard import loss_and_scene_grad_sharded_pallas
        mesh, scene, assets, basis, ref = self._common()
        cfg = self.CFG
        target = jnp.clip(ref, 0.0, 1.0) * 0.9
        ploss, pgrads = loss_and_scene_grad_sharded_pallas(
            scene, assets, basis, target, cfg, mesh, interpret=True)

        def single_loss(s):
            img = jnp.clip(diff.render_pallas_diff(s, assets, basis, cfg,
                                                   0.0, True), 0.0, 1.0)
            return jnp.sum((img - target) ** 2)

        sloss, sgrads = diff.value_and_scene_grad(single_loss, scene)
        np.testing.assert_allclose(float(ploss), float(sloss), rtol=1e-5)
        # grads differ only by float reduction order (8 per-shard sums +
        # psum vs one full-image sum)
        for pg, sg in zip(jax.tree.leaves(pgrads), jax.tree.leaves(sgrads)):
            np.testing.assert_allclose(np.asarray(pg), np.asarray(sg),
                                       rtol=5e-3, atol=5e-5)
        assert np.any(np.asarray(pgrads.light_intensity) != 0)

    def test_distributed_bootstrap_single_process(self):
        from tpuray.parallel import distributed
        assert distributed.ensure_initialized() is False  # no-op here
        gm = distributed.global_mesh()
        assert gm.devices.size == jax.device_count() == 8
        info = distributed.runtime_info()
        assert info["process_count"] == 1


def _get(tree, path):
    cur = tree
    for part in path.split("."):
        cur = getattr(cur, part)
    return cur


def _perturbed(scene, field, idx, delta):
    arr = np.asarray(_get(scene, field)).copy()
    arr[idx] += delta
    parts = field.split(".")
    if len(parts) == 1:
        return scene._replace(**{field: jnp.asarray(arr)})
    mat = _get(scene, parts[0])._replace(**{parts[1]: jnp.asarray(arr)})
    return scene._replace(**{parts[0]: mat})


class TestGradients:
    """Analytic grads vs central finite differences (north-star gate).

    Hit/miss boundaries are step functions, so analytic (select-based)
    gradients are compared to FD *away from silhouettes*: geometry-parameter
    tests weight the loss by an interior-pixel mask (rays whose sphere-hit
    discriminant is comfortably positive), exactly the regime in which the
    north star requires parity.
    """

    CFG = RenderConfig(width=32, height=24, max_depth=2, chunk_size=0,
                       loop="scan", scan_iters=8,
                       shadow_samples=0)  # smooth direct lighting

    @classmethod
    def _build(cls, spec):
        """One jitted weighted loss + its full scene-grad; FD re-evals reuse
        the same executable (weights are an argument, not a constant)."""
        scene = spec.to_scene()
        assets = solid_assets()
        cfg = cls.CFG
        basis = perspective_basis(_golden_camera(), cfg.width, cfg.height)
        o, d = generate_rays(basis, cfg.width, cfg.height)
        ids = jnp.arange(cfg.num_pixels, dtype=jnp.uint32)

        @jax.jit
        def loss(s, w):
            rgb = trace_rays(s, assets, o, d, ids, cfg)
            return jnp.sum(w * rgb * jnp.array([[0.3, 0.5, 0.2]]))

        grad_fn = jax.jit(
            lambda s, w: diff.value_and_scene_grad(loss, s, w)[1])
        return scene, np.asarray(o), np.asarray(d), loss, grad_fn

    @classmethod
    def appearance(cls):
        if not hasattr(cls, "_appearance"):
            cls._appearance = cls._build(_tiny_scene())
        return cls._appearance

    @classmethod
    def geometry(cls):
        if not hasattr(cls, "_geometry"):
            spec = SceneSpec(
                spheres=[SphereSpec((0.0, 1.0, 3.0), 1.0,
                                    PLASTIC.replace(rgb=(1.0, 0.2, 0.2)))],
                planes=[PlaneSpec((0.0, 1.0, 0.0), (0.0, 0.0, 0.0),
                                  PLASTIC.replace(rgb=(0.4, 0.4, 0.4)))],
                lights=[LightSpec((2.0, 4.0, 0.0), 0.1, 30.0,
                                  (1.0, 1.0, 1.0))],
            )
            cls._geometry = cls._build(spec)
        return cls._geometry

    @staticmethod
    def _sphere_disc(scene, i, o, d):
        v = o - np.asarray(scene.sphere_origin[i])
        b = 2.0 * (v * d).sum(-1)
        return (b * b - 4.0 * (d * d).sum(-1)
                * ((v * v).sum(-1) - float(scene.sphere_radius[i]) ** 2))

    def _check(self, built, w, field, idx, eps, rel=2e-2):
        scene, _, _, loss, grad_fn = built
        w = jnp.asarray(w, jnp.float32)
        grads = grad_fn(scene, w)
        g = float(np.asarray(_get(grads, field))[idx])
        lp = float(loss(_perturbed(scene, field, idx, +eps), w))
        lm = float(loss(_perturbed(scene, field, idx, -eps), w))
        fd = (lp - lm) / (2 * eps)
        assert np.isfinite(g)
        tol = max(rel * max(abs(fd), abs(g)), 1e-3)
        assert abs(g - fd) <= tol, f"{field}{idx}: analytic {g} vs fd {fd}"

    # eps sized so the loss delta clears float32 cancellation noise
    @pytest.mark.parametrize("field,idx,eps", [
        ("light_intensity", (0,), 1e-1),
        ("light_origin", (0, 1), 1e-2),
        ("sphere_mat.rgb", (0, 0), 1e-1),
        ("sphere_mat.reflectivity", (0,), 2e-2),
        ("sphere_mat.ambient", (0,), 5e-2),
    ])
    def test_appearance_grad_matches_fd(self, field, idx, eps):
        """Light/material params: smooth everywhere -> full-image loss."""
        built = self.appearance()
        w = np.ones((self.CFG.num_pixels, 1), np.float32)
        self._check(built, w, field, idx, eps)

    @pytest.mark.parametrize("field,idx,eps", [
        ("sphere_origin", (0, 2), 1e-3),
        ("sphere_origin", (0, 0), 1e-3),
        ("sphere_radius", (0,), 1e-3),
    ])
    def test_geometry_grad_matches_fd_interior(self, field, idx, eps):
        """Geometry params: FD vs analytic on silhouette-free pixels
        (interior mask = sphere-hit discriminant comfortably positive)."""
        built = self.geometry()
        scene, o, d = built[0], built[1], built[2]
        disc = self._sphere_disc(scene, 0, o, d)
        w = (disc > 0.3).astype(np.float32)[:, None]
        assert w.sum() >= 3, "interior mask too small for this setup"
        self._check(built, w, field, idx, eps)

    def test_plane_point_grad_matches_fd(self):
        """Plane offset: loss over plane-hit pixels that miss the sphere."""
        built = self.geometry()
        scene, o, d = built[0], built[1], built[2]
        miss = self._sphere_disc(scene, 0, o, d) < -0.3
        ground = d[:, 1] < -0.05
        w = (miss & ground).astype(np.float32)[:, None]
        assert w.sum() >= 10
        self._check(built, w, "plane_point", (0, 1), 1e-3)


class TestBilinearFilter:
    """cfg.filter='bilinear' (no reference analog; the reference fetch is a
    nearest integer read, primitives.cl:250-256).  Bilinear weights give the
    texture lookup a spatial derivative, so hit-point motion produces
    texture gradients that match finite differences."""

    def _setup(self):
        tex = np.zeros((1, 8, 8, 3), np.uint8)
        tex[0, :, :, 0] = (np.arange(8)[None, :] * 20).astype(np.uint8)
        tex[0, :, :, 1] = (np.arange(8)[:, None] * 20).astype(np.uint8)
        tex[0, :, :, 2] = 90
        assets = __import__("tpuray.textures", fromlist=["SceneAssets"]) \
            .SceneAssets(textures=jnp.asarray(tex),
                         skybox=jnp.zeros((12, 16, 3), jnp.uint8))
        spec = SceneSpec(
            planes=[PlaneSpec((0.0, 1.0, 0.0), (0.0, 0.0, 0.0),
                              PLASTIC.replace(texture_id=0,
                                              texture_scale=1.0))],
            lights=[LightSpec((2.0, 3.0, 2.0), 0.1, 25.0, (1.0, 1.0, 1.0))],
        )
        cfg = RenderConfig(width=16, height=12, max_depth=1, chunk_size=0,
                           loop="scan", scan_iters=4, shadow_samples=0,
                           filter="bilinear")
        # steep look-down over hit points ~ (2.5, 0, 2.5): texel coords stay
        # inside (1, 4), away from the u=0 / u=8 wrap seams of the ramp
        cam = Camera((2.5, 1.5, 2.5), (0.02, -0.99, 0.02), 40.0, 1.0)
        basis = perspective_basis(cam, cfg.width, cfg.height)
        o, d = generate_rays(basis, cfg.width, cfg.height)
        ids = jnp.arange(cfg.num_pixels, dtype=jnp.uint32)
        scene = spec.to_scene()

        @jax.jit
        def loss(s):
            rgb = trace_rays(s, assets, o, d, ids, cfg)
            return jnp.sum(rgb * jnp.array([[0.3, 0.5, 0.2]]))

        return scene, loss

    def test_textured_plane_spatial_gradient_matches_fd(self):
        scene, loss = self._setup()
        grads = jax.jit(
            lambda s: diff.value_and_scene_grad(loss, s)[1])(scene)
        # moving the ground plane along y shifts every hit point, hence the
        # (u, v) texel coords; with bilinear weights that spatial texture
        # term is part of the analytic gradient
        idx, eps = (0, 1), 3e-4
        g = float(np.asarray(grads.plane_point)[idx])
        lp = float(loss(_perturbed(scene, "plane_point", idx, +eps)))
        lm = float(loss(_perturbed(scene, "plane_point", idx, -eps)))
        fd = (lp - lm) / (2 * eps)
        assert np.isfinite(g) and abs(fd) > 1e-3, (g, fd)
        assert abs(g - fd) <= max(5e-2 * abs(fd), 2e-2), (g, fd)

    def test_bilinear_reduces_to_nearest_on_flat_texture(self):
        from tpuray.kernels.trace import sample_skybox
        sky = jnp.full((12, 16, 3), 77, jnp.uint8)
        d = jnp.asarray(np.random.default_rng(0).normal(size=(32, 3)),
                        jnp.float32)
        d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
        near = sample_skybox(sky, d, "nearest")
        bil = sample_skybox(sky, d, "bilinear")
        np.testing.assert_allclose(np.asarray(bil), np.asarray(near),
                                   atol=1e-6)
