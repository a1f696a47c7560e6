"""Precision / dtype policy of the PSA framework.

The reference simulator (``integrators.py``, ``yaman_model.py``) runs NumPy
float64/complex128 everywhere.  This framework is dtype-parametric:

- ``"x64"``  : float64 / complex128.  Bit-compatible with the reference to
  ~1e-12; the reference-parity tier, native on CPUs and GPUs.
- ``"x32"``  : float32 / complex64.  The fast tier (~1e-4 on a 2,500-step
  gain spectrum).
- ``"df32"`` : double-word float32 ("two-float" compensated arithmetic,
  ~49-bit effective mantissa): <=1e-9 relative error vs the f64 reference
  from float32 arithmetic alone; see ``ops/twofloat.py``.

x64 support in JAX is a process-global flag; :func:`enable_x64` flips it and
is called from the package ``__init__`` unless ``PSA_NO_X64=1``.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Tuple

import jax
import jax.numpy as jnp

VALID_PRECISIONS = ("x64", "x32", "df32")


def enable_x64() -> None:
    """Enable 64-bit types globally (idempotent)."""
    jax.config.update("jax_enable_x64", True)


def x64_requested() -> bool:
    return os.environ.get("PSA_NO_X64", "0") != "1"


def real_dtype(precision: str) -> jnp.dtype:
    """Real scalar dtype used for the given precision tier.

    ``df32`` state is carried as *pairs* of float32; its per-word dtype is
    float32.
    """
    if precision == "x64":
        return jnp.dtype(jnp.float64)
    if precision in ("x32", "df32"):
        return jnp.dtype(jnp.float32)
    raise ValueError(f"Unknown precision {precision!r}; use one of {VALID_PRECISIONS}")


def complex_dtype(precision: str) -> jnp.dtype:
    if precision == "x64":
        return jnp.dtype(jnp.complex128)
    if precision in ("x32", "df32"):
        return jnp.dtype(jnp.complex64)
    raise ValueError(f"Unknown precision {precision!r}; use one of {VALID_PRECISIONS}")


def validate_precision(precision: str) -> str:
    p = str(precision).strip().lower()
    if p not in VALID_PRECISIONS:
        raise ValueError(f"Unknown precision {precision!r}; use one of {VALID_PRECISIONS}")
    return p


def require_non_df32(precision: str, *, family: str) -> str:
    """Validate a precision tier for a solver family with no compensated
    (two-float) implementation.

    The df32 tier promises <=1e-9-class parity with the f64 reference;
    silently running such a request at plain f32 (what ``real_dtype('df32')``
    alone would do) quietly degrades it to ~1e-5.  Families without a
    two-float engine must refuse instead: use 'x32' or 'x64'; the df32
    tier covers the 4-wave ODE family
    (``parallel/sweep.solve_batch``) and the N-wave comb
    (``models/nwave.solve_comb_batch``).
    """
    p = validate_precision(precision)
    if p == "df32":
        raise ValueError(
            f"precision='df32' is not implemented for the {family} solvers "
            "(no compensated two-float engine; running it at f32 would "
            "silently miss the <=1e-9 tier). Use 'x32' (fast tier) or "
            "'x64' (reference parity)."
        )
    return p


def dtypes_for(precision: str) -> Tuple[jnp.dtype, jnp.dtype]:
    """(real_dtype, complex_dtype) pair for a precision tier."""
    p = validate_precision(precision)
    return real_dtype(p), complex_dtype(p)


def require_f64_leaves(what: str, **arrays) -> None:
    """Reject inputs already rounded to f32 before a two-float split.

    The df32 tier's <=1e-9 contract needs exact f64 -> (hi, lo) f32
    splitting; feeding it x32-built coeffs/terms (f32 leaves upcast to
    f64) zeroes every lo limb and silently degrades the result to
    f32-class accuracy (the CLAUDE.md 'never cast to device f32 before
    the two-float split' invariant).  Build the object with
    precision='df32' instead."""
    import numpy as np

    for name, a in arrays.items():
        dt = np.asarray(a).dtype
        if dt != np.float64:
            raise ValueError(
                f"{what}: df32 solves need float64 inputs for the exact "
                f"two-float split, but {name} has dtype {dt} -- build it "
                "with precision='df32' (host f64 leaves)"
            )


def compile_cache_dir() -> str:
    """Where JAX's persistent compilation cache lives: the directory named
    by ``JAX_COMPILATION_CACHE_DIR`` when it is set, else ``.jax_cache`` at
    the root of the checkout (a fixed path: the path is part of the cache
    key, so a moving directory would never hit)."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    return str(Path(__file__).resolve().parents[2] / ".jax_cache")


def enable_compile_cache(min_compile_secs: float = 2.0) -> str:
    """Turn on JAX's persistent compilation cache and return its directory.

    With ``JAX_COMPILATION_CACHE_DIR`` set, JAX already reads it and nothing
    is set here; otherwise the cache goes to :func:`compile_cache_dir`.
    Called by ``chip_smoke.py``, the bench scripts and the test conftest."""
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return compile_cache_dir()
    path = compile_cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      float(min_compile_secs))
    return path
