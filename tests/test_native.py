"""Native C++ runtime library tests: PNG codec + scene-archive codec.

Validated against the pure-Python implementations and, where a reference
checkout exists, the reference's committed artifacts (render.map,
out/scene.png).  The module fixture builds the library
(``make -C tpuray/native``).
"""
import os
import subprocess

import numpy as np
import pytest

from tpuray import native_lib
from tpuray.scene import canonical_scene_spec
from tpuray.io import read_png
from tpuray.sceneio import dump_scene, load_scene


@pytest.fixture(scope="module", autouse=True)
def build_native():
    subprocess.run(["make", "-C", "tpuray/native", "-s"], check=True)
    assert native_lib.available()


class TestPngCodec:
    def test_roundtrip(self, tmp_path):
        img = np.random.default_rng(7).integers(
            0, 256, (33, 41, 3)).astype(np.uint8)
        p = str(tmp_path / "x.png")
        native_lib.write_png(p, img)
        assert (native_lib.read_png(p) == img).all()

    def test_interops_with_python_codec(self, tmp_path):
        """Files written by either codec read back identically through the
        other (tpuray.io is the zlib + numpy one)."""
        from tpuray.io import write_png
        img = np.random.default_rng(8).integers(
            0, 256, (19, 23, 3)).astype(np.uint8)
        p_nat, p_py = str(tmp_path / "n.png"), str(tmp_path / "p.png")
        native_lib.write_png(p_nat, img)
        write_png(p_py, img)
        assert (read_png(p_nat) == img).all()
        assert (native_lib.read_png(p_py) == img).all()

    def test_reads_reference_golden_image(self, reference):
        golden = os.path.join(reference, "out", "scene.png")
        ours = native_lib.read_png(golden)
        ref = read_png(golden)            # the pure-Python decoder
        assert ours.shape == (600, 800, 3)
        assert (ours == ref).all()


class TestSceneCodec:
    def test_reads_reference_archive(self, reference):
        render_map = os.path.join(reference, "scenes", "render.map")
        spheres, planes, lights, tris = native_lib.scene_read(render_map)
        spec = load_scene(render_map)  # python parser as oracle
        assert len(spheres) == len(spec.spheres) == 4
        assert len(planes) == len(spec.planes) == 2
        assert len(lights) == len(spec.lights) == 3
        assert len(tris) == 0
        for i, s in enumerate(spec.spheres):
            np.testing.assert_allclose(spheres["origin"][i], s.origin)
            assert spheres["radius"][i] == np.float32(s.radius)
            np.testing.assert_allclose(spheres["mat"]["rgb"][i],
                                       s.material.rgb)
            assert (spheres["mat"]["texture_id"][i] == s.material.texture_id)
        for i, l in enumerate(spec.lights):
            np.testing.assert_allclose(lights["origin"][i], l.origin)
            assert lights["intensity"][i] == np.float32(l.intensity)

    def test_write_matches_python_writer(self, tmp_path):
        spec = canonical_scene_spec()
        py_path = str(tmp_path / "py.map")
        dump_scene(py_path, spec)

        spheres, planes, lights, tris = native_lib.scene_read(py_path)
        nat_path = str(tmp_path / "nat.map")
        native_lib.scene_write(nat_path, spheres, planes, lights, tris)
        with open(py_path, "rb") as f1, open(nat_path, "rb") as f2:
            assert f1.read() == f2.read()

    def test_triangle_v2_roundtrip(self, tmp_path):
        from tpuray.scene import GLASS, TriangleSpec
        spec = canonical_scene_spec()
        spec.triangles = [TriangleSpec((0, 0, 0), (1, 0, 0), (0, 1, 0),
                                       GLASS)]
        p = str(tmp_path / "v2.map")
        dump_scene(p, spec)
        spheres, planes, lights, tris = native_lib.scene_read(p)
        assert len(tris) == 1
        np.testing.assert_allclose(tris["v1"][0], (1, 0, 0))
        p2 = str(tmp_path / "v2b.map")
        native_lib.scene_write(p2, spheres, planes, lights, tris)
        back = load_scene(p2)
        assert len(back.triangles) == 1
        assert back.triangles[0].material.n == np.float32(GLASS.n)
