"""GPU kernel tests (kernels/pallas_trace.py).

The kernel runs here in Pallas interpret mode (``interpret=True``): the
same kernel body, executed by XLA on the CPU.  It is checked against the
XLA tracer, whose arithmetic it mirrors.  Tests marked ``gpu`` run the
compiled kernel and skip without a GPU; tests that take ``reference``
compare with the reference's golden render.
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
from tpuray.kernels.pallas_trace import pack_uniforms, render_pallas
from tpuray.render import choose_engine, render_from_basis_xla
from tpuray.scene import (GLASS, MIRROR, PLASTIC, LightSpec, PlaneSpec,
                          SceneSpec, SphereSpec, TriangleSpec,
                          canonical_scene_spec)
from tpuray.textures import load_default_assets, seeded_assets


def _golden_camera():
    return Camera(GOLDEN_CAMERA_ORIGIN, GOLDEN_CAMERA_LOOKDIR,
                  GOLDEN_CAMERA_FOV, GOLDEN_CAMERA_FOCAL)


def _small_assets():
    # the reference's asset layout at test size: 4 textures + a 4x3 cross
    return seeded_assets(0, tex_size=64, skybox_shape=(96, 128))


class TestUniformPacking:
    def test_layout_matches_packed_sizes_and_values(self):
        scene = canonical_scene_spec().to_scene()
        basis = perspective_basis(_golden_camera(), 64, 48)
        uni, o = pack_uniforms(scene, basis, row0=3.0)
        uni = np.asarray(uni)
        assert uni.shape == (o["li_rgb"] + 9,)
        assert uni[o["row0"]] == 3.0
        np.testing.assert_allclose(
            uni[o["pl_nrm"]:o["pl_nrm"] + 6],
            np.asarray(scene.plane_normal).reshape(-1))
        np.testing.assert_allclose(
            uni[o["pl_pt"]:o["pl_pt"] + 6],
            np.asarray(scene.plane_point).reshape(-1))
        np.testing.assert_allclose(
            uni[o["sph_o"]:o["sph_o"] + 12],
            np.asarray(scene.sphere_origin).reshape(-1))
        # materials are indexed by solid id: spheres, then planes
        np.testing.assert_allclose(
            uni[o["mat_n"]:o["mat_n"] + 6],
            np.concatenate([np.asarray(scene.sphere_mat.n),
                            np.asarray(scene.plane_mat.n)]))
        assert uni[o["mat_texture_id"] + 4] == 2.0   # ground plane: check.png
        np.testing.assert_allclose(uni[o["li_i"]:o["li_i"] + 3],
                                   np.asarray(scene.light_intensity))


def _kernel_vs_tracer(spec, cfg, camera, row0=0.0, assets=None):
    scene = spec.to_scene()
    assets = assets or _small_assets()
    full_h = cfg.height if row0 == 0.0 else int(row0) + cfg.height
    basis = perspective_basis(camera, cfg.width, full_h)
    img = np.asarray(jax.jit(
        lambda s, b: render_pallas(s, assets, b, cfg, interpret=True,
                                   row0=row0))(scene, basis))
    o, d = generate_rays(basis, cfg.width, cfg.height, row0)
    ids = (jnp.arange(cfg.num_pixels, dtype=jnp.uint32)
           + np.uint32(int(row0) * cfg.width))
    from tpuray.kernels.trace import trace_rays
    ref = np.asarray(trace_rays(scene, assets, o, d, ids, cfg)).reshape(
        cfg.height, cfg.width, 3)
    return img, ref


def _glass_scene():
    return SceneSpec(
        spheres=[SphereSpec((0.0, 1.0, 3.0), 1.0, GLASS),
                 SphereSpec((1.8, 0.7, 4.5), 0.7,
                            PLASTIC.replace(rgb=(0.9, 0.2, 0.2)))],
        planes=[PlaneSpec((0.0, 1.0, 0.0), (0.0, 0.0, 0.0),
                          PLASTIC.replace(texture_id=1,
                                          texture_scale=4.0)),
                PlaneSpec((0.0, 0.0, -1.0), (0.0, 0.0, 9.0), MIRROR)],
        lights=[LightSpec((2.0, 4.0, 0.0), 0.3, 30.0, (1.0, 1.0, 1.0))])


_LOOK_UP = Camera((0.0, 1.0, -2.0), (0.1, 0.8, 0.6), 90.0, 1.0)
_GLASS_CAM = Camera((0.05, 1.2, -1.5), (0.02, -0.1, 1.0), 70.0, 1.0)

# (scene, cfg, camera, row0): each case puts one feature of the kernel to
# work; the tracer is the reference
_CASES = {
    "nearest": (canonical_scene_spec, RenderConfig(
        width=48, height=24, max_depth=3), _golden_camera(), 0.0),
    "bilinear": (canonical_scene_spec, RenderConfig(
        width=48, height=24, max_depth=3, filter="bilinear"),
        _golden_camera(), 0.0),
    "skybox_miss": (canonical_scene_spec, RenderConfig(
        width=32, height=16, max_depth=2), _LOOK_UP, 0.0),
    "glass": (_glass_scene, RenderConfig(
        width=32, height=24, max_depth=5, shadow_samples=0), _GLASS_CAM,
        0.0),
    "soft_shadows": (_glass_scene, RenderConfig(
        width=32, height=24, max_depth=2, shadow_samples=2), _GLASS_CAM,
        0.0),
    "depth1": (canonical_scene_spec, RenderConfig(
        width=32, height=16, max_depth=1), _golden_camera(), 0.0),
    "depth4": (canonical_scene_spec, RenderConfig(
        width=32, height=16, max_depth=4), _golden_camera(), 0.0),
    "row0": (canonical_scene_spec, RenderConfig(
        width=40, height=8, max_depth=3), _golden_camera(), 24.0),
}


class TestKernelVsTracer:
    @pytest.mark.parametrize("case", sorted(_CASES))
    def test_interpret_matches_tracer(self, case):
        spec, cfg, cam, row0 = _CASES[case]
        img, ref = _kernel_vs_tracer(spec(), cfg.replace(chunk_size=0), cam,
                                     row0)
        assert np.isfinite(img).all()
        d = np.abs(img - ref).max(-1)
        # same arithmetic in both engines, but XLA:CPU may contract a*b+c
        # into an FMA differently in the two programs: last bits move, and
        # a ray that lands exactly on a texel edge (a measure-zero set) may
        # fetch the neighbouring texel — one pixel in a few hundred here
        assert (d < 1e-3).mean() >= 0.99, f"{case}: {(d >= 1e-3).mean()}"
        assert d.mean() < 1e-3, f"{case}: mean |d| {d.mean()}"
        assert img.std() > 1e-3      # rendered something, not a flat fill

    def test_bilinear_differs_from_nearest(self):
        spec, cfg, cam, _ = _CASES["bilinear"]
        bil, _ = _kernel_vs_tracer(spec(), cfg.replace(chunk_size=0), cam)
        near, _ = _kernel_vs_tracer(spec(), cfg.replace(
            chunk_size=0, filter="nearest"), cam)
        assert np.abs(bil - near).max() > 1e-3

    def test_triangle_scene_is_refused(self):
        spec = canonical_scene_spec()
        spec.triangles.append(TriangleSpec((0, 0, 0), (1, 0, 0), (0, 1, 0),
                                           PLASTIC))
        cfg = RenderConfig(width=16, height=8, max_depth=1)
        with pytest.raises(ValueError, match="triangles"):
            render_pallas(spec.to_scene(), _small_assets(),
                          perspective_basis(_golden_camera(), 16, 8), cfg,
                          interpret=True)


class TestDispatch:
    """render.choose_engine: the one rule between the two engines."""

    @staticmethod
    def _scene(triangles: bool):
        spec = canonical_scene_spec()
        if triangles:
            spec.triangles.append(TriangleSpec((0, 0, 0), (1, 0, 0),
                                               (0, 1, 0), PLASTIC))
        return spec.to_scene()

    @pytest.mark.parametrize("engine,triangles,backend,expect", [
        ("auto", False, "cpu", "xla"),
        ("auto", True, "gpu", "xla"),
        ("auto", False, "gpu", "pallas"),
        ("xla", False, "gpu", "xla"),
        ("pallas", False, "gpu", "pallas"),
        ("pallas", True, "gpu", ValueError),
        ("pallas", False, "cpu", ValueError),
    ])
    def test_choose_engine(self, engine, triangles, backend, expect):
        scene = self._scene(triangles)
        cfg = RenderConfig(engine=engine)
        if expect is ValueError:
            with pytest.raises(ValueError, match="engine='pallas'"):
                choose_engine(scene, cfg, backend)
        else:
            assert choose_engine(scene, cfg, backend) == expect

    def test_default_backend_here_is_the_tracer(self):
        assert choose_engine(self._scene(False), RenderConfig()) == "xla"


class TestGoldenSlabInterpret:
    """Kernel vs the reference's golden render without a GPU: a full-width
    row slab of the reference image in interpret mode via ``row0`` (the
    row-sharded rendering contract), compared with the committed
    out/scene.png rows."""

    @pytest.mark.parametrize("row0", [288,   # mid-image: ground + spheres
                                      8])    # top: skybox + mirror wall
    def test_golden_rows_interpret(self, row0, reference):
        from tpuray.io import read_png
        scene = canonical_scene_spec().to_scene()
        assets = load_default_assets()
        full = RenderConfig()     # 800x600 depth 15
        ROWS = 16
        cfg = full.replace(height=ROWS)
        basis = perspective_basis(_golden_camera(), full.width, full.height)
        img = np.asarray(render_pallas(scene, assets, basis, cfg,
                                       interpret=True, row0=float(row0)))
        q = (np.clip(img, 0, 1) * 255).astype(np.uint8)
        gold = read_png(os.path.join(reference, "out", "scene.png"))
        d = np.abs(q.astype(np.int32)
                   - gold[row0:row0 + ROWS].astype(np.int32))
        assert d.mean() < 1.0, f"mean|d|={d.mean()}"
        assert (d <= 8).mean() > 0.99, f"within-8 {(d <= 8).mean()}"


@pytest.mark.gpu
class TestGoldenFullImage:
    """Full 800x600 depth-15 render on the compiled kernel — the
    reference's own raypng configuration (raypng.c:8-21) against its
    committed render (out/scene.png)."""

    def test_full_golden_image(self, gpu, reference):
        from tpuray.io import image_diff_stats, read_png
        scene = canonical_scene_spec().to_scene()
        assets = load_default_assets()
        cfg = RenderConfig(chunk_size=0)
        basis = perspective_basis(_golden_camera(), cfg.width, cfg.height)
        img = np.asarray(jax.jit(render_pallas, static_argnames="cfg")(
            scene, assets, basis, cfg))
        q = (np.clip(img, 0, 1) * 255).astype(np.uint8)
        stats = image_diff_stats(
            q, read_png(os.path.join(reference, "out", "scene.png")))
        assert stats.mean_abs < 0.5, str(stats)
        assert stats.frac_within_8 > 0.995, str(stats)
        assert stats.psnr > 44.0, str(stats)


@pytest.mark.gpu
class TestPallasVsXla:
    def test_matches_xla_tracer(self, gpu):
        from tpuray.io import image_diff_stats
        scene = canonical_scene_spec().to_scene()
        assets = seeded_assets(0)
        cfg = RenderConfig(chunk_size=0)         # 800x600 depth 15
        basis = perspective_basis(_golden_camera(), cfg.width, cfg.height)
        a = np.asarray(jax.jit(render_pallas, static_argnames="cfg")(
            scene, assets, basis, cfg))
        with jax.default_matmul_precision("highest"):
            b = np.asarray(render_from_basis_xla(
                scene, assets, basis, cfg.replace(chunk_size=65536)))
        q = lambda im: (np.clip(im, 0, 1) * 255).astype(np.uint8)  # noqa
        stats = image_diff_stats(q(a), q(b))
        assert stats.mean_abs <= 0.5, str(stats)
        assert stats.frac_within_8 >= 0.99, str(stats)
        assert stats.psnr >= 45.0, str(stats)


class TestKernelMathParity:
    """The kernel's component-form helpers against the tracer's
    [..., 3]-form primitives."""

    def test_map_to_cube_matches_primitives(self):
        from tpuray.kernels import primitives as pr
        rng = np.random.default_rng(11)
        d = rng.normal(size=(16, 128, 3)).astype(np.float32)
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        face = 1024
        u_ref, v_ref = pr.map_to_cube(jnp.asarray(d.reshape(-1, 3)), face)
        u_k, v_k = pr.map_to_cube_xyz(jnp.asarray(d[..., 0]),
                                      jnp.asarray(d[..., 1]),
                                      jnp.asarray(d[..., 2]), face)
        np.testing.assert_array_equal(np.asarray(u_k).reshape(-1),
                                      np.asarray(u_ref))
        np.testing.assert_array_equal(np.asarray(v_k).reshape(-1),
                                      np.asarray(v_ref))

    def test_xorshift_i32_matches_u32(self):
        """The kernel's xorshift32, run inside a Triton-route Pallas kernel
        (interpret mode), must reproduce the reference's u32 sequence
        (primitives.cl:116-125) bit for bit in state and sample."""
        from jax.experimental import pallas as pl
        from tpuray.kernels.primitives import xorshift32

        def ref_step(x):
            x = x ^ ((x << 13) & 0xFFFFFFFF)
            x = x ^ (x >> 17)
            x = x ^ ((x << 5) & 0xFFFFFFFF)
            return x

        def kernel(s_ref, out_ref, samp_ref):
            st = s_ref[...]
            for k in range(8):
                st, samp = xorshift32(st)
                out_ref[k, :] = st
                samp_ref[k, :] = samp

        seeds = np.random.default_rng(5).integers(
            1, 2**32, 256, dtype=np.uint64)
        states, samples = pl.pallas_call(
            kernel, backend="triton", interpret=True,
            out_shape=(jax.ShapeDtypeStruct((8, 256), jnp.uint32),
                       jax.ShapeDtypeStruct((8, 256), jnp.float32)))(
            jnp.asarray(seeds.astype(np.uint32)))
        x = seeds.copy()
        for k in range(8):
            x = ref_step(x)
            np.testing.assert_array_equal(np.asarray(states[k]),
                                          x.astype(np.uint32))
            np.testing.assert_array_equal(
                np.asarray(samples[k]),
                (x.astype(np.float32) / np.float32(2147483648.0)
                 * np.float32(2.0)))

    def test_plane_basis_matches_primitives(self):
        """The kernel reads each plane's texture basis from the packed
        table; it must be primitives.plane_texture_basis's."""
        from tpuray.kernels import primitives as pr
        spec = SceneSpec(planes=[
            PlaneSpec(n, (0.0, 0.0, 0.0), PLASTIC)
            for n in [(0.0, 1.0, 0.0), (0.0, 0.0, -1.0), (1.0, 0.0, 0.0),
                      (0.6, 0.8, 0.0)]])
        scene = spec.to_scene()
        uni, o = pack_uniforms(scene, perspective_basis(_golden_camera(),
                                                        8, 8))
        b0_ref, b1_ref = pr.plane_texture_basis(scene.plane_normal)
        uni = np.asarray(uni)
        np.testing.assert_array_equal(uni[o["pl_b0"]:o["pl_b0"] + 12],
                                      np.asarray(b0_ref).reshape(-1))
        np.testing.assert_array_equal(uni[o["pl_b1"]:o["pl_b1"] + 12],
                                      np.asarray(b1_ref).reshape(-1))
