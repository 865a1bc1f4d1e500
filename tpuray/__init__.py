"""tpuray — a differentiable Whitted raytracer in JAX, with a Pallas GPU
kernel.

A from-scratch re-design of the capabilities of the reference C/OpenCL
raytracer (monoamine11231/Example-GUI-OpenCL-Raytracer; see SURVEY.md):
spheres + infinite planes (+ triangle meshes as an extension), Phong
materials with reflection and dielectric refraction, stochastic soft
shadows, tiled plane textures and a cubemap skybox — with forward parity
against the reference's golden render, reverse-mode gradients to every
scene parameter, and pixel sharding across devices.

Layer map (reference -> here):
  src/cl/*.cl (device kernels)   -> tpuray.kernels (XLA tracer + GPU kernel)
  src/opencl_wrap.{h,c} (runtime)-> jax.jit / shard_map (+ tpuray.native IO)
  src/cpu_ray.{h,c} (camera/png) -> tpuray.camera, tpuray.io
  src/cpu_obj.{h,c} (scene/ser.) -> tpuray.scene, tpuray.sceneio
  raypng.c / rayinteractive.c /
  scene_dump.c (apps)            -> tpuray.apps.{raypng,rayview,scenegen}
"""

from .camera import Camera, PerspectiveBasis, generate_rays, perspective_basis
from .config import RenderConfig
from .diff import render_pallas_diff
from .render import choose_engine, render, render_from_basis, render_u8
from .scene import (GLASS, MIRROR, PLASTIC, STONE, LightSpec, MaterialSpec,
                    Materials, PlaneSpec, Scene, SceneSpec, SphereSpec,
                    TriangleSpec, build_scene, canonical_scene_spec)
from .sceneio import dump_scene, dumps_scene, load_scene, loads_scene
from .textures import (SceneAssets, load_default_assets, seeded_assets,
                       solid_assets)

__version__ = "0.1.0"
