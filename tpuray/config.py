"""Render configuration.

The reference's config surface is all compile-time ``#define``s: WIDTH/HEIGHT
(raypng.c:8-9), MAX_DEPTH=15 and MAX_SOFT_SHADOWS=2 (raytracing.cl:9-11),
EPSILON=0.001 and TRANSPERENT_THROUGH=0.8 (primitives.cl:5-7).  Here it is a
single frozen dataclass whose defaults equal the reference constants, so the
golden-image comparison runs with an identically configured pipeline.

``RenderConfig`` is hashable and is passed as a static argument to jitted
renderers (a new config triggers a recompile — the analog of rebuilding the
OpenCL program with different #defines).
"""
from __future__ import annotations

import dataclasses
import os

# A checkout of the reference renderer (monoamine11231/Example-GUI-OpenCL-
# Raytracer) beside the package.  Nothing on the main path needs it: only
# ``--scene``/``--compare-golden`` and the golden-parity tests read it.
REFERENCE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "reference")


def reference_path(*parts: str) -> str:
    """Path inside the reference checkout; raises when it is absent."""
    path = os.path.join(REFERENCE_DIR, *parts)
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"{path} not found: the reference checkout is read from "
            f"{REFERENCE_DIR}; the default scene and assets need none "
            "(scene.canonical_scene_spec, textures.seeded_assets)")
    return path


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    width: int = 800                  # raypng.c:8
    height: int = 600                 # raypng.c:9
    max_depth: int = 15               # raytracing.cl:9
    shadow_samples: int = 2           # MAX_SOFT_SHADOWS, raytracing.cl:11
    epsilon: float = 1e-3             # primitives.cl:5
    transparent_through: float = 0.8  # primitives.cl:7
    default_n: float = 1.0            # raytracing.cl:7

    # --- execution knobs (no reference analog) ---
    # Pixels per traced chunk (XLA tracer); chunks run sequentially via
    # lax.map so the device-memory footprint and while-loop straggler cost
    # stay bounded.  0 = whole image.
    chunk_size: int = 65536
    # Hard cap on DFS iterations per chunk (safety only; the while_loop exits
    # as soon as every lane finishes).  Worst-case node visits for a binary
    # reflect/refract tree of depth D is 2^D, and each node costs at most two
    # iterations (visit + pop).
    max_iters: int = 8192
    # 'while' = lax.while_loop fast forward path (not reverse-differentiable);
    # 'scan'  = fixed-trip lax.scan, reverse-mode differentiable.
    loop: str = "while"
    # Iteration count for loop='scan'.  0 = auto (2 * 2^max_depth, capped).
    scan_iters: int = 0
    # Rendering engine: 'pallas' = the GPU kernel (kernels/pallas_trace.py),
    # 'xla' = the whole-image while/scan tracer (differentiable, supports
    # triangles), 'auto' = render.choose_engine's rule.
    engine: str = "auto"
    # Texture/skybox sampling: 'nearest' reproduces the reference's integer
    # texel fetch (primitives.cl:250-256, raytracing.cl:67-76) and is what
    # the golden comparison requires; 'bilinear' interpolates the 4
    # neighboring texels, which also gives texture lookups a spatial
    # derivative (hit-point gradients flow through the fractional weights).
    # Both engines implement both modes.
    filter: str = "nearest"

    # Node-record slots per pixel for the kernel's record-mode forward (the
    # saved-path replay VJP saves one record per DFS node: packed hit id +
    # parent slot + branch, plus per-light soft-shadow ratios).  0 = auto:
    # 2^(max_depth+1)-1 capped at 48 (parent slots are 6-bit, so <= 64).
    # Overflowing nodes lose their subtree's gradient contribution (counted
    # and reported by render_pallas_record).
    record_slots: int = 0

    def resolved_record_slots(self) -> int:
        if self.record_slots:
            if not 1 <= self.record_slots <= 64:
                raise ValueError("record_slots must be in [1, 64] (parent "
                                 "slots are 6-bit)")
            return self.record_slots
        return min(2 ** (self.max_depth + 1) - 1, 48)

    @property
    def num_pixels(self) -> int:
        return self.width * self.height

    def resolved_scan_iters(self) -> int:
        if self.scan_iters:
            return self.scan_iters
        return min(2 * (2 ** self.max_depth), self.max_iters)

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)


# Reference camera for the golden render (raypng.c:17-21).
GOLDEN_CAMERA_ORIGIN = (0.8, 2.5, -8.0)
GOLDEN_CAMERA_LOOKDIR = (0.2, 0.0, 1.0)
GOLDEN_CAMERA_FOV = 90.0
GOLDEN_CAMERA_FOCAL = 1.0
