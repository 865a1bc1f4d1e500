"""Scene archive tests: parse/round-trip the committed 723-byte render.map
(scenes/render.map in the reference checkout) and regenerate it from source
values (scene_dump.c:8-71)."""
import os

import numpy as np
import pytest

from tpuray import (GLASS, canonical_scene_spec, dumps_scene, loads_scene,
                    sceneio)


@pytest.fixture
def ref_map(reference):
    with open(os.path.join(reference, "scenes", "render.map"), "rb") as f:
        return f.read()

# Byte ranges of uninitialized C struct padding in the reference archive
# (fwrite of padded structs dumps stack garbage there): radius padding in
# rsphere (offsets 16..32 of each struct hold radius@16 then 12 pad bytes)
# and rlight's pad @20..32.


def _zero_padding(buf: bytes) -> bytes:
    """Zero all struct padding bytes so semantically-equal archives compare
    equal regardless of the garbage the reference's fwrite leaked."""
    b = bytearray(buf)
    off = 0
    ns = b[off]; off += 1
    for _ in range(ns):
        for i in range(off + 12, off + 16):      # origin float3 pad
            b[i] = 0
        for i in range(off + 20, off + 32):      # radius pad
            b[i] = 0
        _zero_mat_padding(b, off + 32)
        off += sceneio.SPHERE_SIZE
    npl = b[off]; off += 1
    for _ in range(npl):
        for i in range(off + 12, off + 16):
            b[i] = 0
        for i in range(off + 28, off + 32):
            b[i] = 0
        _zero_mat_padding(b, off + 32)
        off += sceneio.PLANE_SIZE
    nl = b[off]; off += 1
    for _ in range(nl):
        for i in range(off + 12, off + 16):
            b[i] = 0
        for i in range(off + 24, off + 32):
            b[i] = 0
        for i in range(off + 44, off + 48):
            b[i] = 0
        off += sceneio.LIGHT_SIZE
    return bytes(b)


def _zero_mat_padding(b: bytearray, moff: int) -> None:
    for i in range(moff + 12, moff + 16):        # rgb float3 pad
        b[i] = 0
    for i in range(moff + 56, moff + 64):        # tail pad
        b[i] = 0


def test_parse_committed_archive(ref_map):
    spec = loads_scene(ref_map)
    assert len(spec.spheres) == 4
    assert len(spec.planes) == 2
    assert len(spec.lights) == 3
    s0 = spec.spheres[0]
    assert s0.origin == (4.5, 0.5, -1.0) and s0.radius == 0.5
    assert s0.material.rgb == (1.0, 0.0, 0.0)
    # glass preset fields survive (scene_dump.c:22-25 + cpu_obj.c:40-49)
    s2 = spec.spheres[2]
    assert s2.material.transparent and s2.material.dielectric
    assert s2.material.n == np.float32(1.52)
    assert s2.material.reflectivity == np.float32(0.04)
    # ground plane: texture 2 (check.png) at scale 100 (scene_dump.c:36-41)
    p0 = spec.planes[0]
    assert p0.normal == (0.0, 1.0, 0.0)
    assert p0.material.texture_id == 2
    assert p0.material.texture_scale == 100.0
    # back wall mirror
    p1 = spec.planes[1]
    assert p1.material.reflectivity == 1.0 and p1.material.shininess == 150
    # lights (scene_dump.c:55-69)
    assert spec.lights[1].intensity == np.float32(50.3)
    assert spec.lights[2].rgb == (0.0, 0.0, 1.0)


def test_roundtrip_byte_exact_modulo_padding(ref_map):
    buf = ref_map
    rt = dumps_scene(loads_scene(buf))
    assert len(rt) == len(buf) == 723
    assert _zero_padding(rt) == _zero_padding(buf)


def test_canonical_scene_matches_committed_archive(ref_map):
    """Our scenegen (scene.canonical_scene_spec) must regenerate render.map
    byte-exactly modulo uninitialized padding — the same guarantee as the
    reference's `scene` executable (SURVEY.md §3.3)."""
    buf = ref_map
    ours = dumps_scene(canonical_scene_spec())
    assert _zero_padding(ours) == _zero_padding(buf)


def test_triangle_v2_roundtrip():
    from tpuray import TriangleSpec
    spec = canonical_scene_spec()
    spec.triangles.append(TriangleSpec((0, 0, 0), (1, 0, 0), (0, 1, 0),
                                       GLASS))
    buf = dumps_scene(spec)
    spec2 = loads_scene(buf)
    assert len(spec2.triangles) == 1
    assert spec2.triangles[0].v1 == (1.0, 0.0, 0.0)
    assert spec2.triangles[0].material.n == np.float32(1.52)
    # v1 readers (the reference) see a valid v1 prefix: re-parse just the
    # prefix by truncating at the magic
    v1_len = buf.index(sceneio.V2_MAGIC)
    spec3 = loads_scene(buf[:v1_len])
    assert len(spec3.triangles) == 0 and len(spec3.spheres) == 4


def test_scene_pytree_shapes():
    scene = canonical_scene_spec().to_scene()
    assert scene.num_spheres == 4 and scene.num_planes == 2
    assert scene.num_lights == 3 and scene.num_triangles == 0
    assert scene.sphere_origin.shape == (4, 3)
    assert scene.plane_mat.texture_id.shape == (2,)
    assert int(scene.plane_mat.texture_id[0]) == 2
