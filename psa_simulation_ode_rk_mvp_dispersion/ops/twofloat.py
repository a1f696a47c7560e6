"""Double-word float32 ("two-float" / double-double-style) arithmetic.

The BASELINE target demands <=1e-9 relative error against the f64 NumPy
reference.  This module reaches it with float32 arithmetic alone (for
hardware without fast f64): every value is an unevaluated sum
``hi + lo`` of two float32 words (|lo| <= ulp(hi)/2), giving ~49 effective
mantissa bits (~1e-14 relative) at ~5-20 f32 ops per arithmetic op -- still
compute-trivial for this workload.

Algorithms are the classical error-free transforms:
- Knuth TwoSum (branch-free add error),
- Dekker split + TwoProd (multiplication error without FMA; correct -- and
  only *more* accurate -- if XLA contracts sub-expressions to FMA under
  ``--xla_allow_excess_precision``),
- renormalization via Fast2Sum.
References: Dekker 1971; Hida, Li, Bailey, "Library for double-double and
quad-double arithmetic" (QD), 2000.

Complex two-float (:class:`CTF`) composes the real ops; the 4-wave RHS needs
only add/mul/conj/scale -- no division or transcendentals in the rotating
frame (``ops/rhs.rhs_yaman_autonomous``), which is exactly why that frame is
the df32 path.

All functions are shape-polymorphic and jit/vmap-safe.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import numpy as np
import jax.numpy as jnp

_SPLIT = np.float32(4097.0)  # 2^12 + 1 (Dekker split constant for f32)


class TF(NamedTuple):
    """Real two-float: value = hi + lo (both float32 arrays)."""

    hi: jax.Array
    lo: jax.Array


class CTF(NamedTuple):
    """Complex two-float: re + i*im, each a :class:`TF`."""

    re: TF
    im: TF


# ---------------------------------------------------------------------------
# Error-free transforms
# ---------------------------------------------------------------------------

def _quick_two_sum(a, b):
    """(s, err) with s = fl(a+b), assuming |a| >= |b| (Fast2Sum)."""
    s = a + b
    err = b - (s - a)
    return s, err


def _two_sum(a, b):
    """(s, err) with s = fl(a+b), no magnitude assumption (Knuth)."""
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)
    return s, err


def _split(a):
    """Dekker split: a = a_hi + a_lo with a_hi having <=12 mantissa bits."""
    c = _SPLIT * a
    a_hi = c - (c - a)
    a_lo = a - a_hi
    return a_hi, a_lo


def _two_prod(a, b):
    """(p, err) with p = fl(a*b) and p + err = a*b exactly."""
    p = a * b
    a_hi, a_lo = _split(a)
    b_hi, b_lo = _split(b)
    err = ((a_hi * b_hi - p) + a_hi * b_lo + a_lo * b_hi) + a_lo * b_lo
    return p, err


# ---------------------------------------------------------------------------
# Construction / conversion
# ---------------------------------------------------------------------------

def tf_from_f64(x) -> TF:
    """Split host float64 values into (hi, lo) float32 words exactly.

    Non-finite values (nan/inf, incl. f32 overflow) live in ``hi`` alone
    with ``lo = 0`` -- ``inf - inf`` in the residual would otherwise
    poison ``lo`` with nan (seen as a RuntimeWarning from NaN-mask
    tests)."""
    x = np.asarray(x, dtype=np.float64)
    hi = x.astype(np.float32)
    with np.errstate(invalid="ignore"):
        lo = np.where(np.isfinite(hi), x - hi.astype(np.float64),
                      0.0).astype(np.float32)
    return TF(jnp.asarray(hi), jnp.asarray(lo))


def tf_from_f32(x) -> TF:
    x = jnp.asarray(x, dtype=jnp.float32)
    return TF(x, jnp.zeros_like(x))


def tf_to_f64(a: TF) -> np.ndarray:
    return np.asarray(a.hi, dtype=np.float64) + np.asarray(a.lo, dtype=np.float64)


def tf_zeros(shape, ) -> TF:
    z = jnp.zeros(shape, dtype=jnp.float32)
    return TF(z, z)


def ctf_from_c128(x) -> CTF:
    x = np.asarray(x, dtype=np.complex128)
    return CTF(re=tf_from_f64(x.real), im=tf_from_f64(x.imag))


def ctf_to_c128(a: CTF) -> np.ndarray:
    return tf_to_f64(a.re) + 1j * tf_to_f64(a.im)


# ---------------------------------------------------------------------------
# Real two-float arithmetic
# ---------------------------------------------------------------------------

def tf_add(a: TF, b: TF) -> TF:
    """a + b (double-double addition, ~2 ulp of the 49-bit format)."""
    s, e = _two_sum(a.hi, b.hi)
    e = e + (a.lo + b.lo)
    hi, lo = _quick_two_sum(s, e)
    return TF(hi, lo)


def tf_neg(a: TF) -> TF:
    return TF(-a.hi, -a.lo)


def tf_sub(a: TF, b: TF) -> TF:
    return tf_add(a, tf_neg(b))


def tf_mul(a: TF, b: TF) -> TF:
    """a * b."""
    p, e = _two_prod(a.hi, b.hi)
    e = e + (a.hi * b.lo + a.lo * b.hi)
    hi, lo = _quick_two_sum(p, e)
    return TF(hi, lo)


def tf_mul_f32(a: TF, c) -> TF:
    """a * c for a plain f32 value c."""
    p, e = _two_prod(a.hi, c)
    e = e + a.lo * c
    hi, lo = _quick_two_sum(p, e)
    return TF(hi, lo)


def tf_add_f32(a: TF, c) -> TF:
    s, e = _two_sum(a.hi, c)
    e = e + a.lo
    hi, lo = _quick_two_sum(s, e)
    return TF(hi, lo)


# ---------------------------------------------------------------------------
# Complex two-float arithmetic
# ---------------------------------------------------------------------------

def ctf_add(a: CTF, b: CTF) -> CTF:
    return CTF(tf_add(a.re, b.re), tf_add(a.im, b.im))


def ctf_sub(a: CTF, b: CTF) -> CTF:
    return CTF(tf_sub(a.re, b.re), tf_sub(a.im, b.im))


def ctf_neg(a: CTF) -> CTF:
    return CTF(tf_neg(a.re), tf_neg(a.im))


def ctf_conj(a: CTF) -> CTF:
    return CTF(a.re, tf_neg(a.im))


def ctf_mul(a: CTF, b: CTF) -> CTF:
    """(a.re + i a.im)(b.re + i b.im)."""
    re = tf_sub(tf_mul(a.re, b.re), tf_mul(a.im, b.im))
    im = tf_add(tf_mul(a.re, b.im), tf_mul(a.im, b.re))
    return CTF(re, im)


def ctf_mul_real(a: CTF, r: TF) -> CTF:
    return CTF(tf_mul(a.re, r), tf_mul(a.im, r))


def ctf_mul_i_real(a: CTF, r: TF) -> CTF:
    """(i * r) * a for real two-float r: rotates (re, im) -> (-r*im, r*re)."""
    return CTF(tf_neg(tf_mul(a.im, r)), tf_mul(a.re, r))


def ctf_abs2(a: CTF) -> TF:
    """|a|^2 = re^2 + im^2."""
    return tf_add(tf_mul(a.re, a.re), tf_mul(a.im, a.im))


def ctf_scale_f32(a: CTF, c) -> CTF:
    return CTF(tf_mul_f32(a.re, c), tf_mul_f32(a.im, c))


# ---------------------------------------------------------------------------
# Shared solver helpers (per-step NaN freeze contract + TF comparisons) --
# one definition for every df32 engine (df32_solver, df32_comb; the adaptive
# engine's scalar-lane variants live with its controller)
# ---------------------------------------------------------------------------

def ctf_all_finite(y: CTF) -> jax.Array:
    """Per-instance all-finite flag over the trailing (state) axis (checking
    the hi words suffices: lo words are bounded by ulp(hi))."""
    return (
        jnp.all(jnp.isfinite(y.re.hi), axis=-1)
        & jnp.all(jnp.isfinite(y.im.hi), axis=-1)
    )


def ctf_freeze(ok, new: CTF, old: CTF) -> CTF:
    """Masked per-lane freeze: lanes with ok False keep the old state (the
    framework-wide per-step NaN-freeze contract)."""
    w = lambda n_, o: jnp.where(ok[..., None], n_, o)  # noqa: E731
    return CTF(
        re=TF(w(new.re.hi, old.re.hi), w(new.re.lo, old.re.lo)),
        im=TF(w(new.im.hi, old.im.hi), w(new.im.lo, old.im.lo)),
    )


def tf_gt(a: TF, b: TF) -> jax.Array:
    """Exact elementwise ``a > b`` for normalized two-float values.

    A collapsed ``(a.hi + a.lo) > (b.hi + b.lo)`` compare has only f32
    resolution: ``hi + lo`` rounds straight back to ``hi`` (normalization
    means ``|lo| <= ulp(hi)/2``), so candidates within ~2^-24 relative of
    each other compare as equal and a running max can keep the wrong one
    (a ~3e-8 P_max error observed in practice).  The lexicographic
    (hi, then lo) compare is exact: normalization gives ``hi = fl(hi+lo)``
    and ``fl`` is monotone, so ``a.hi > b.hi`` implies ``a > b``, while
    equal ``hi`` reduces the compare to the exact f32 ``lo`` difference.
    """
    return (a.hi > b.hi) | ((a.hi == b.hi) & (a.lo > b.lo))


def tf_max(a: TF, b: TF) -> TF:
    """Elementwise max of two TF values (exact two-float compare)."""
    take_a = tf_gt(a, b)
    return TF(jnp.where(take_a, a.hi, b.hi), jnp.where(take_a, a.lo, b.lo))


# ---------------------------------------------------------------------------
# Two-float circular functions (the GNLSE Kerr rotation exp(i theta) needs a
# runtime sin/cos of a state-dependent angle at ~49-bit accuracy; f32
# sin/cos intrinsics stop at 2^-24)
# ---------------------------------------------------------------------------

# Taylor coefficients 1/(2k)! and 1/(2k+1)! split exactly from f64; with
# |reduced theta| <= pi/4 the k=8 truncation terms (theta^18/18!,
# theta^19/19!) are < 2e-18, far below the 2^-49 format.
_COS_COEFFS = [1.0, -0.5]
_SIN_COEFFS = [1.0, -1.0 / 6.0]
_f = 2.0
for _k in range(2, 9):
    _f *= (2 * _k - 1) * (2 * _k)
    _COS_COEFFS.append((-1.0) ** _k / _f)
    _SIN_COEFFS.append((-1.0) ** _k / (_f * (2 * _k + 1)))
del _f, _k

_TWO_PI_64 = 2.0 * np.pi
_HALF_PI_64 = 0.5 * np.pi


def _tf_poly(u: TF, coeffs) -> TF:
    """Horner evaluation sum_k c_k u^k with f64-split TF coefficients."""
    p = tf_from_f64(np.float64(coeffs[-1]))
    for c in coeffs[-2::-1]:
        p = tf_add(tf_mul(u, p), tf_from_f64(np.float64(c)))
    return p


def tf_sin_cos(theta: TF):
    """(sin theta, cos theta) in two-float arithmetic.

    Payne-Hanek-free range reduction: theta mod 2*pi via an f32 integer
    multiple of a TF 2*pi (exact for the small per-step Kerr phases this
    serves -- n = 0 almost always; for |theta| up to ~1e3 the reduction
    error is ~|n| * 1.4e-14 absolute), then quadrant folding by pi/2 and a
    k<=8 Taylor pair on |theta| <= pi/4.  Non-finite angles propagate to
    non-finite outputs (the solver freeze contract detects them)."""
    two_pi = tf_from_f64(_TWO_PI_64)
    half_pi = tf_from_f64(_HALF_PI_64)
    n = jnp.round(theta.hi * np.float32(1.0 / _TWO_PI_64))
    t1 = tf_sub(theta, tf_mul_f32(two_pi, n))
    q = jnp.round(t1.hi * np.float32(1.0 / _HALF_PI_64))
    t2 = tf_sub(t1, tf_mul_f32(half_pi, q))
    u = tf_mul(t2, t2)
    c0 = _tf_poly(u, _COS_COEFFS)
    s0 = tf_mul(t2, _tf_poly(u, _SIN_COEFFS))
    k = jnp.mod(q, np.float32(4.0))
    # quadrant rotation: k=0 -> (s, c); 1 -> (c, -s); 2 -> (-s, -c); 3 -> (-c, s)
    swap = (k == 1.0) | (k == 3.0)
    neg_s = (k == 2.0) | (k == 3.0)
    neg_c = (k == 1.0) | (k == 2.0)
    pick = lambda m, a_, b_: TF(jnp.where(m, a_.hi, b_.hi),  # noqa: E731
                                jnp.where(m, a_.lo, b_.lo))
    sgn = lambda m, a_: TF(jnp.where(m, -a_.hi, a_.hi),  # noqa: E731
                           jnp.where(m, -a_.lo, a_.lo))
    s = sgn(neg_s, pick(swap, c0, s0))
    c = sgn(neg_c, pick(swap, s0, c0))
    return s, c
