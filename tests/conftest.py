"""Test config: run on the CPU with 8 virtual devices.

The standard JAX way to test Mesh/shard_map/psum code without several
devices (SURVEY.md §4): the same test code runs unchanged on real ones.
The settings must land before JAX initializes a backend.

Two fixtures gate tests on what the machine has, decided when the test
runs (never at import, so every pytest-xdist worker collects the same
tests):

* ``gpu`` — the test needs a GPU (tests marked ``gpu``).  They skip on the
  CPU; on the card run ``JAX_PLATFORMS=cuda,cpu python -m pytest tests -m
  gpu``.  ``python chip_smoke.py`` makes the same checks at full size.
* ``reference`` — the test reads the reference checkout
  (config.REFERENCE_DIR: its render.map, assets or golden image).
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import pytest  # noqa: E402

from tpuray.config import REFERENCE_DIR  # noqa: E402
from tpuray.utils.compile_cache import enable_compile_cache  # noqa: E402

# the suite's cost is dominated by XLA:CPU compiles of the traced render
# graphs, which are identical across runs
enable_compile_cache()


@pytest.fixture
def gpu():
    import jax
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU (JAX_PLATFORMS=cuda,cpu on the card)")


@pytest.fixture
def reference():
    if not os.path.isdir(REFERENCE_DIR):
        pytest.skip(f"needs the reference checkout at {REFERENCE_DIR}")
    return REFERENCE_DIR
