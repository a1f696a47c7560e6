"""Trace-aware validation helpers.

The reference validates every input eagerly and raises (e.g.
``frequency_plan.py:46-74``, ``parameters.py:46-87``).  Under ``jit``/``vmap``
values are tracers and cannot be branched on, so this framework follows the
JAX idiom:

- validation runs eagerly whenever the inputs are *concrete* (the common case
  at the API boundary), raising the same error types as the reference;
- when inputs are traced, scalar-shape checks still apply (shapes are static)
  but value checks are skipped -- numerical failure detection is then handled
  by the masked NaN machinery in the integrator (see ``ops/integrators.py``).
"""

from __future__ import annotations

from typing import Any

import jax
import numpy as np
import jax.numpy as jnp


def is_concrete(*xs: Any) -> bool:
    """True if none of the arguments is a JAX tracer."""
    return not any(isinstance(x, jax.core.Tracer) for x in xs)


def xp(*xs: Any):
    """Array-namespace dispatch: NumPy for concrete (host-side) inputs, jnp
    for traced ones.

    Parameter-construction math (frequency plans, dispersion coefficients,
    delta-beta) is tiny and must be float64-accurate; running it eagerly on an
    accelerator would cost a dispatch per operation.
    Concrete inputs therefore compute on the host in NumPy; inside
    ``jit``/``vmap`` (tracers present) the same code paths emit jnp ops that
    fuse into the surrounding XLA program.
    """
    return np if is_concrete(*xs) else jnp


def to_scalar_float(x: Any, *, name: str) -> float:
    """Coerce a concrete real scalar to float, mirroring reference semantics
    (``dispersion.py:50-57``)."""
    try:
        v = float(x)
    except Exception as e:  # noqa: BLE001 - mirror reference behaviour
        raise TypeError(f"{name} must be a real scalar, got {type(x)!r}") from e
    if not np.isfinite(v):
        raise ValueError(f"{name} must be finite, got {v!r}")
    return v


def validate_positive(x: Any, *, name: str) -> float:
    v = to_scalar_float(x, name=name)
    if v <= 0.0:
        raise ValueError(f"{name} must be > 0, got {v!r}")
    return v


def validate_nonneg(x: Any, *, name: str) -> float:
    v = to_scalar_float(x, name=name)
    if v < 0.0:
        raise ValueError(f"{name} must be >= 0, got {v!r}")
    return v


def check_finite(arr: Any, *, name: str) -> None:
    """Raise if a concrete array contains non-finite values; no-op on tracers."""
    if not is_concrete(arr):
        return
    a = np.asarray(arr)
    if not np.all(np.isfinite(a)):
        raise ValueError(f"{name} must contain only finite values")


def check_positive(arr: Any, *, name: str) -> None:
    if not is_concrete(arr):
        return
    a = np.asarray(arr)
    if not np.all(np.isfinite(a)):
        raise ValueError(f"{name} must contain only finite values")
    if np.any(a <= 0.0):
        raise ValueError(f"{name} must contain only positive values")


def check_nonneg(arr: Any, *, name: str) -> None:
    if not is_concrete(arr):
        return
    a = np.asarray(arr)
    if not np.all(np.isfinite(a)):
        raise ValueError(f"{name} must contain only finite values")
    if np.any(a < 0.0):
        raise ValueError(f"{name} must contain only non-negative values")


def check_last_dim(arr: Any, n: int, *, name: str) -> None:
    """Shape checks are static and therefore always enforceable, even on
    tracers.  Generalizes the reference's hard ``shape == (4,)`` checks
    (``frequency_plan.py:101-109``) to batched ``(..., n)`` arrays."""
    shape = jnp.shape(arr)
    if len(shape) < 1 or shape[-1] != n:
        raise ValueError(f"{name} must have trailing dimension {n}, got shape {shape}")
