"""Scene model: materials, spheres, planes, triangles, lights — as JAX pytrees.

The equivalent of the reference's host scene model (cpu_obj.{h,c}:
struct defs at cpu_obj.h:10-48, material presets at cpu_obj.c:6-49).  Instead
of arrays-of-structs we use structure-of-arrays NamedTuples so that the whole
scene is a differentiable pytree that vectorizes over primitives.

Two levels of representation:

* ``MaterialSpec`` / ``SphereSpec`` / ... — host-side scalar dataclasses used
  for scene authoring (the analog of building ``rsphere[]`` on the stack in
  scene_dump.c:8-69).
* ``Scene`` — the SoA pytree consumed by the renderer.  All float fields are
  float32 leaves; gradients flow to every float leaf (geometry, materials,
  lights).  Integer/boolean fields (texture ids, flags) are non-differentiable.

Triangles are an extension over the reference; the reference supports only
spheres + infinite planes.
"""
from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Sequence, Tuple

import jax.numpy as jnp
import numpy as np

Vec3 = Tuple[float, float, float]


# ---------------------------------------------------------------------------
# Host-side authoring specs (scalar, numpy-friendly)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class MaterialSpec:
    """Phong material; field-for-field the reference's rmaterial (types.cl:4-19).

    ``shininess`` is stored as a uint in the reference archive format but used
    as a float in shading (raytracing.cl:128); we keep it as float here and
    round on serialization.
    """
    rgb: Vec3 = (1.0, 1.0, 1.0)
    ambient: float = 0.0
    diffuse: float = 0.0
    specular: float = 0.0
    shininess: float = 0.0
    transparent: bool = False        # reference spelling: "transperent"
    dielectric: bool = False
    n: float = 1.0                   # index of refraction
    reflectivity: float = 0.0
    texture_id: int = -1             # -1: no texture
    texture_scale: float = 0.0

    def replace(self, **kw) -> "MaterialSpec":
        return dataclasses.replace(self, **kw)


# Material presets — values from cpu_obj.c:6-49.
STONE = MaterialSpec(rgb=(1, 1, 1), ambient=0.4, diffuse=0.2, specular=0.6,
                     shininess=50, dielectric=True, n=1.57)
PLASTIC = MaterialSpec(rgb=(1, 1, 1), ambient=0.3, diffuse=0.2, specular=0.6,
                       shininess=50, n=1.4, reflectivity=0.1)
MIRROR = MaterialSpec(rgb=(0.2, 0.2, 0.2), ambient=0.3, diffuse=0.0,
                      specular=0.6, shininess=100, dielectric=True, n=1.0,
                      reflectivity=1.0)
GLASS = MaterialSpec(rgb=(0, 0, 0), ambient=0.1, diffuse=0.0, specular=0.0,
                     shininess=20, transparent=True, dielectric=True, n=1.52,
                     reflectivity=0.04)


@dataclasses.dataclass
class SphereSpec:
    origin: Vec3
    radius: float
    material: MaterialSpec


@dataclasses.dataclass
class PlaneSpec:
    normal: Vec3
    point_in_plane: Vec3
    material: MaterialSpec


@dataclasses.dataclass
class LightSpec:
    """Spherical area light (types.cl:36-42)."""
    origin: Vec3
    radius: float
    intensity: float
    rgb: Vec3


@dataclasses.dataclass
class TriangleSpec:
    v0: Vec3
    v1: Vec3
    v2: Vec3
    material: MaterialSpec


@dataclasses.dataclass
class SceneSpec:
    spheres: List[SphereSpec] = dataclasses.field(default_factory=list)
    planes: List[PlaneSpec] = dataclasses.field(default_factory=list)
    lights: List[LightSpec] = dataclasses.field(default_factory=list)
    triangles: List[TriangleSpec] = dataclasses.field(default_factory=list)

    def to_scene(self) -> "Scene":
        return build_scene(self)


# ---------------------------------------------------------------------------
# Device-side SoA pytrees
# ---------------------------------------------------------------------------

class Materials(NamedTuple):
    """SoA material table, one row per primitive."""
    rgb: jnp.ndarray            # [N, 3] f32
    ambient: jnp.ndarray        # [N] f32
    diffuse: jnp.ndarray        # [N] f32
    specular: jnp.ndarray       # [N] f32
    shininess: jnp.ndarray      # [N] f32
    transparent: jnp.ndarray    # [N] bool
    dielectric: jnp.ndarray     # [N] bool
    n: jnp.ndarray              # [N] f32
    reflectivity: jnp.ndarray   # [N] f32
    texture_id: jnp.ndarray     # [N] i32
    texture_scale: jnp.ndarray  # [N] f32

    @property
    def count(self) -> int:
        return self.ambient.shape[0]


class Scene(NamedTuple):
    """Full scene as a differentiable pytree.

    Counts are static (baked into array shapes), so a jitted renderer is
    specialized per scene topology — the analog of the reference passing
    spheres_num/planes_num as kernel args (raytracing.cl:17) except XLA
    constant-folds the loops.
    """
    sphere_origin: jnp.ndarray    # [S, 3] f32
    sphere_radius: jnp.ndarray    # [S] f32
    sphere_mat: Materials         # fields [S]
    plane_normal: jnp.ndarray     # [P, 3] f32
    plane_point: jnp.ndarray      # [P, 3] f32
    plane_mat: Materials          # fields [P]
    light_origin: jnp.ndarray     # [L, 3] f32
    light_radius: jnp.ndarray     # [L] f32
    light_intensity: jnp.ndarray  # [L] f32
    light_rgb: jnp.ndarray        # [L, 3] f32
    tri_v0: jnp.ndarray           # [T, 3] f32
    tri_v1: jnp.ndarray           # [T, 3] f32
    tri_v2: jnp.ndarray           # [T, 3] f32
    tri_mat: Materials            # fields [T]

    @property
    def num_spheres(self) -> int:
        return self.sphere_radius.shape[0]

    @property
    def num_planes(self) -> int:
        return self.plane_normal.shape[0]

    @property
    def num_lights(self) -> int:
        return self.light_radius.shape[0]

    @property
    def num_triangles(self) -> int:
        return self.tri_v0.shape[0]


def _stack_materials(mats: Sequence[MaterialSpec]) -> Materials:
    n = len(mats)

    def arr(get, dtype=np.float32, shape=()):
        if n == 0:
            return jnp.zeros((0,) + shape, dtype)
        return jnp.asarray(np.array([get(m) for m in mats], dtype=dtype))

    return Materials(
        rgb=arr(lambda m: m.rgb, np.float32, (3,)),
        ambient=arr(lambda m: m.ambient),
        diffuse=arr(lambda m: m.diffuse),
        specular=arr(lambda m: m.specular),
        shininess=arr(lambda m: m.shininess),
        transparent=arr(lambda m: m.transparent, np.bool_),
        dielectric=arr(lambda m: m.dielectric, np.bool_),
        n=arr(lambda m: m.n),
        reflectivity=arr(lambda m: m.reflectivity),
        texture_id=arr(lambda m: m.texture_id, np.int32),
        texture_scale=arr(lambda m: m.texture_scale),
    )


def _morton_argsort(tris: Sequence[TriangleSpec]) -> np.ndarray:
    """Spatial (Morton / Z-order) ordering of triangles by centroid.

    Triangle order is semantically irrelevant to the renderer (closest-hit
    over a set; ties only on shared edges, a measure-zero set), but blocks
    of consecutive triangles (the tracer's scan tiles, a linear BVH built
    on this order) have tight bounds only when neighbours in the list are
    neighbours in space — for ANY mesh order, not just meshes whose
    authoring order happens to be coherent.  10 bits per axis over the
    scene bounding box, stable argsort.
    """
    n = len(tris)
    if n <= 1:
        return np.arange(n)
    v = np.array([[t.v0, t.v1, t.v2] for t in tris], np.float64)  # [T,3,3]
    c = v.mean(axis=1)                                            # [T,3]
    lo = c.min(axis=0)
    span = np.maximum(c.max(axis=0) - lo, 1e-12)
    q = np.minimum((c - lo) / span * 1024.0, 1023.0).astype(np.uint64)

    def part1by2(x):
        x &= np.uint64(0x3FF)
        x = (x | (x << np.uint64(16))) & np.uint64(0x30000FF)
        x = (x | (x << np.uint64(8))) & np.uint64(0x300F00F)
        x = (x | (x << np.uint64(4))) & np.uint64(0x30C30C3)
        x = (x | (x << np.uint64(2))) & np.uint64(0x9249249)
        return x

    code = part1by2(q[:, 0]) | (part1by2(q[:, 1]) << np.uint64(1)) \
        | (part1by2(q[:, 2]) << np.uint64(2))
    return np.argsort(code, kind="stable")


def build_scene(spec: SceneSpec) -> Scene:
    """Convert authoring spec lists into the SoA ``Scene`` pytree."""
    f32 = np.float32

    def vecs(items, get):
        if not items:
            return jnp.zeros((0, 3), f32)
        return jnp.asarray(np.array([get(x) for x in items], dtype=f32))

    def scalars(items, get):
        if not items:
            return jnp.zeros((0,), f32)
        return jnp.asarray(np.array([get(x) for x in items], dtype=f32))

    tris = [spec.triangles[i] for i in _morton_argsort(spec.triangles)]
    return Scene(
        sphere_origin=vecs(spec.spheres, lambda s: s.origin),
        sphere_radius=scalars(spec.spheres, lambda s: s.radius),
        sphere_mat=_stack_materials([s.material for s in spec.spheres]),
        plane_normal=vecs(spec.planes, lambda p: p.normal),
        plane_point=vecs(spec.planes, lambda p: p.point_in_plane),
        plane_mat=_stack_materials([p.material for p in spec.planes]),
        light_origin=vecs(spec.lights, lambda l: l.origin),
        light_radius=scalars(spec.lights, lambda l: l.radius),
        light_intensity=scalars(spec.lights, lambda l: l.intensity),
        light_rgb=vecs(spec.lights, lambda l: l.rgb),
        tri_v0=vecs(tris, lambda t: t.v0),
        tri_v1=vecs(tris, lambda t: t.v1),
        tri_v2=vecs(tris, lambda t: t.v2),
        tri_mat=_stack_materials([t.material for t in tris]),
    )


def canonical_scene_spec() -> SceneSpec:
    """The canonical demo scene, value-for-value from scene_dump.c:8-69.

    Writing this with :func:`tpuray.sceneio.dump_scene` reproduces every
    meaningful byte of the committed ``scenes/render.map``; the only
    differing bytes (19 of 723) are struct-padding regions where the
    reference fwrites uninitialized stack memory (cpu_obj.c:51-74 writes raw
    structs), which we zero.
    """
    spheres = [
        SphereSpec((4.5, 0.5, -1.0), 0.5,
                   PLASTIC.replace(rgb=(1.0, 0.0, 0.0))),
        SphereSpec((-1.0, 1.0, 4.5), 0.8,
                   PLASTIC.replace(rgb=(0.0, 0.0, 1.0))),
        SphereSpec((0.8, 0.8, 1.5), 0.8, GLASS),
        SphereSpec((-0.6, 0.8, -1.0), 0.8,
                   GLASS.replace(rgb=(0.0, 1.0, 0.0), ambient=0.05)),
    ]
    planes = [
        PlaneSpec((0.0, 1.0, 0.0), (0.0, 0.0, 0.0),
                  STONE.replace(rgb=(0.0, 0.0, 0.0), texture_scale=100.0,
                                texture_id=2)),
        PlaneSpec((0.0, 0.0, -1.0), (0.0, 0.0, 7.0),
                  MIRROR.replace(ambient=0.3, shininess=150, specular=0.4,
                                 rgb=(0.3, 0.3, 0.3))),
    ]
    lights = [
        LightSpec((-2.0, 3.0, 2.0), 0.1, 8.0, (0.0, 1.0, 0.0)),
        LightSpec((2.0, 1.5, 0.2), 0.1, 50.3, (1.0, 1.0, 1.0)),
        LightSpec((1.0, 4.0, 3.0), 0.1, 20.5, (0.0, 0.0, 1.0)),
    ]
    return SceneSpec(spheres=spheres, planes=planes, lights=lights)
