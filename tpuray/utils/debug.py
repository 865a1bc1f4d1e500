"""Debug / sanitizer hooks — the JAX analog of device-code sanitizers.

The reference has no sanitizers (SURVEY.md §5): its kernels are
embarrassingly parallel and its only checks are print+exit(1) error paths.
In JAX, data races are structurally absent (pure functions); the failure
mode that remains is NaN/Inf propagation (refract/normalize/pow edge
cases).  This module packages the standard countermeasures:

* :func:`nan_guard` — context manager enabling ``jax_debug_nans`` so the
  first NaN-producing primitive raises with a stack trace.
* :func:`check_finite` — assert a pytree of arrays is finite (host-side,
  for tests and app --selfcheck flags).

A Pallas kernel runs in interpret mode when its caller passes
``interpret=True`` (kernels/pallas_trace.py); the tests do.
"""
from __future__ import annotations

import contextlib
from typing import Iterator

import jax
import numpy as np


@contextlib.contextmanager
def nan_guard() -> Iterator[None]:
    """Raise on the first NaN produced inside (jax_debug_nans)."""
    prev = jax.config.jax_debug_nans
    jax.config.update("jax_debug_nans", True)
    try:
        yield
    finally:
        jax.config.update("jax_debug_nans", prev)


def check_finite(tree, label: str = "value") -> None:
    """Host-side finiteness assertion over every array leaf."""
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        arr = np.asarray(leaf)
        if arr.dtype.kind == "f" and not np.isfinite(arr).all():
            bad = (~np.isfinite(arr)).sum()
            raise FloatingPointError(
                f"{label}{jax.tree_util.keystr(path)}: {bad} non-finite "
                f"values (shape {arr.shape})")
