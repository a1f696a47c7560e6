"""Real/imag packing at jit boundaries.

The framework's jitted entry points follow one convention (it once served a
runtime that moved only real/int arrays host<->device; a GPU moves complex
buffers directly, and removing the convention is ROADMAP queue 3 #3):

    EVERY jitted entry point takes and returns real-valued arrays only;
    complex state crosses the boundary as an (..., 2) real/imag pack, and
    flags cross as int32.

``lax.complex`` reconstitutes complex on device; these helpers implement both
directions on host and device.
"""

from __future__ import annotations

import jax
import numpy as np
import jax.numpy as jnp


def ri_pack_host(a, real_dtype) -> np.ndarray:
    """Host: complex array -> (..., 2) real array of ``real_dtype``."""
    a = np.asarray(a)
    out = np.empty(a.shape + (2,), dtype=np.dtype(real_dtype))
    out[..., 0] = a.real
    out[..., 1] = a.imag
    return out


def ri_unpack_host(ri) -> np.ndarray:
    """Host: (..., 2) real array -> complex128 array."""
    ri = np.asarray(ri, dtype=np.float64)
    return ri[..., 0] + 1j * ri[..., 1]


def ri_to_complex(ri: jax.Array) -> jax.Array:
    """Device: (..., 2) real -> complex (c64 for f32, c128 for f64)."""
    return jax.lax.complex(ri[..., 0], ri[..., 1])


def complex_to_ri(y: jax.Array) -> jax.Array:
    """Device: complex -> (..., 2) real of the matching precision."""
    return jnp.stack([y.real, y.imag], axis=-1)
