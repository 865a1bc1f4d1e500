"""Multi-host bootstrap: jax.distributed + process-count-aware meshes.

The reference is strictly single-device/single-process (SURVEY.md §2: the
only parallelism is a 1-D NDRange on one GPU, opencl_wrap.c:368-374).  For
several processes (one per host, or one per GPU) the equivalent (SURVEY.md
§5 "distributed communication backend") is:

* ``jax.distributed.initialize`` once per process — the coordinator wires
  up cross-process XLA collectives (NCCL on GPUs) and propagates
  coordinator failure, which is the framework's failure-detection story
  for multi-process runs.
* a global 1-D ``Mesh`` over every device of every process; the image's
  pixel-tile axis is sharded over it (``shard.render_sharded`` /
  ``loss_and_scene_grad_sharded`` work unchanged — shard_map addresses the
  global mesh, XLA routes the psum between the processes).

Single-process use (tests, the virtual-device dryrun, the GPUs of one host)
needs no bootstrap: ``ensure_initialized`` is a no-op unless multi-process
environment variables are present or explicit arguments are passed.
"""
from __future__ import annotations

import os
from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh

from .shard import AXIS

# set by cluster launchers (GKE, ray, mpirun wrappers)
_ENV_VARS = ("COORDINATOR_ADDRESS", "JAX_COORDINATOR_ADDRESS")

_initialized = False


def ensure_initialized(coordinator_address: Optional[str] = None,
                       num_processes: Optional[int] = None,
                       process_id: Optional[int] = None) -> bool:
    """Bootstrap jax.distributed for multi-host runs.  Idempotent.

    Returns True when a multi-process runtime was initialized (or already
    was), False for plain single-process execution.  With no arguments it
    initializes only when a coordinator address is found in the
    environment; otherwise it is a no-op so single-process and CPU-test
    paths never pay the bootstrap.
    """
    global _initialized
    if _initialized or jax.process_count() > 1:
        _initialized = True
        return True

    if coordinator_address is None:
        for var in _ENV_VARS:
            if os.environ.get(var):
                coordinator_address = os.environ[var]
                break
    if coordinator_address is None and num_processes is None:
        # no multi-process configuration anywhere: single-process run
        return False

    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)
    _initialized = True
    return True


def global_mesh(n_devices: Optional[int] = None) -> Mesh:
    """1-D render mesh over the global device set (all processes).

    ``jax.devices()`` already returns the global list after
    ``ensure_initialized``; per-process shards are addressed by shard_map
    through the mesh, so callers never index local devices directly.
    """
    devs = jax.devices()
    if n_devices is not None:
        if len(devs) < n_devices:
            raise ValueError(
                f"requested {n_devices} devices, have {len(devs)} "
                f"(process {jax.process_index()}/{jax.process_count()})")
        devs = devs[:n_devices]
    return Mesh(np.asarray(devs), (AXIS,))


def runtime_info() -> dict:
    """Structured snapshot of the distributed runtime (metrics/logging)."""
    return {
        "process_index": jax.process_index(),
        "process_count": jax.process_count(),
        "global_devices": jax.device_count(),
        "local_devices": jax.local_device_count(),
        "backend": jax.default_backend(),
        "distributed_initialized": _initialized or jax.process_count() > 1,
    }
