"""Metrics / observability: structured render reports and profiling hooks.

The reference's observability is a single printf ("Done, took: N ms",
raypng.c:96).  Here every timed render produces a structured report with
primary rays per second (Mrays/s), and ``profile_trace`` wraps
``jax.profiler`` for device tracing (the analog of the reference's
gettimeofday bracket around the kernel launches, raypng.c:15,85-96, but
yielding a full XLA timeline instead of one number).
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import time
from typing import Iterator, Optional

import jax


@dataclasses.dataclass
class RenderReport:
    width: int
    height: int
    max_depth: int
    seconds: float
    compile_seconds: Optional[float] = None

    @property
    def primary_rays(self) -> int:
        return self.width * self.height

    @property
    def mrays_per_s(self) -> float:
        return self.primary_rays / self.seconds / 1e6

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        d["mrays_per_s"] = round(self.mrays_per_s, 3)
        return json.dumps(d)

    def __str__(self) -> str:
        c = (f" (compile {self.compile_seconds:.1f}s)"
             if self.compile_seconds is not None else "")
        return (f"{self.width}x{self.height} depth={self.max_depth}: "
                f"{self.seconds * 1e3:.1f} ms, "
                f"{self.mrays_per_s:.2f} Mrays/s{c}")


@contextlib.contextmanager
def profile_trace(log_dir: str) -> Iterator[None]:
    """jax.profiler trace context; view with tensorboard/xprof."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


@contextlib.contextmanager
def timed(label: str) -> Iterator[None]:
    """Wall-clock bracket with a device sync, the clFinish-equivalent
    (opencl_wrap.c:380)."""
    t0 = time.perf_counter()
    yield
    (jax.device_put(0.0) + 0).block_until_ready()
    print(f"{label}: {(time.perf_counter() - t0) * 1e3:.1f} ms")


def card_info() -> "str | None":
    """The GPU's name and power limit as ``nvidia-smi`` reports them
    (``"NVIDIA H100 80GB HBM3, 700.00 W"``), or None without nvidia-smi.

    A card set below its maximum power runs slower under load, so every
    device time is reported beside this line."""
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    return out.strip().splitlines()[0] if out.strip() else None


def device_info() -> dict:
    """What a measurement ran on: JAX's platform, device kind and count,
    and the card line of :func:`card_info`."""
    dev = jax.devices()[0]
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices()), "card": card_info()}
