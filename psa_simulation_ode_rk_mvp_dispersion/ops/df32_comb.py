"""Matched-tolerance (df32) N-wave comb solver: two-float FFT coupling.

BASELINE config 5's correctness bar is the f64 reference semantics
(/root/reference/integrators.py:25-61 -- f64 RK4), <=1e-9 relative.  The
x32 comb engines top out at ~1e-4 after 1000 cascaded steps (f32 state
rounding amplified by the cascade): any f32-valued partial sum of the DFT
contraction rounds at 2^-24 relative.  This module therefore evaluates the
coupling entirely in two-float (double-word f32, ~49-bit) arithmetic:

    T = IFFT( F^2 conj(F) ),   F = FFT(A, L)        [models/nwave.py]

with a radix-2 iterative Cooley-Tukey FFT over :class:`~.twofloat.CTF`
state -- O(L log L) two-float butterflies instead of O(N L) two-float MACs
(11x fewer compensated ops than a two-float DFT matmul), all stages
unrolled at trace time (7 for L=128), twiddles split exactly from f64.

The RK4 stepper, chunked save-decimation scan, per-step NaN freeze, and the
(P_max, A_last, ok) reduce contract mirror ``ops/df32_solver`` (the 4-wave
df32 engine) and ``models/nwave.solve_comb_batch``.  Expected accuracy vs
the f64 reference: ~1e-11 relative over 10^3 steps (verified in
tests/test_df32_comb.py against the x64 CPU solver).

XLA:CPU compiles two-float loop bodies pathologically slowly (CLAUDE.md
constraint 4), so jitted-solver tests are opt-in; CPU coverage drives
the eager component lane (tf_fft vs numpy f64 FFT, polarization vs x64).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import jax
import numpy as np
import jax.numpy as jnp
from jax import lax

from .twofloat import (
    CTF,
    TF,
    ctf_abs2,
    ctf_add,
    ctf_from_c128,
    ctf_mul,
    ctf_mul_i_real,
    ctf_mul_real,
    ctf_scale_f32,
    ctf_sub,
    ctf_to_c128,
    tf_from_f64,
    tf_neg,
)


# ---------------------------------------------------------------------------
# Two-float complex FFT (radix-2 DIT, power-of-2 length, trace-time unrolled)
# ---------------------------------------------------------------------------

def _bit_reverse_perm(L: int) -> np.ndarray:
    bits = L.bit_length() - 1
    idx = np.arange(L)
    rev = np.zeros(L, dtype=np.int64)
    for b in range(bits):
        rev |= ((idx >> b) & 1) << (bits - 1 - b)
    return rev


@functools.lru_cache(maxsize=16)
def _fft_twiddles(L: int, sign: int):
    """Per-stage twiddle factors w_k = exp(sign * 2i pi k / M) for
    M = 2, 4, ..., L, split exactly from f64 into TF pairs.

    Leaves are HOST numpy f32 (lifted as constants wherever they are
    used): jnp arrays created inside a jit trace are tracers, and caching
    a tracer leaks it into every later trace (UnexpectedTracerError when a
    second solver jit reuses the cache)."""
    def split(x):
        hi = x.astype(np.float32)
        return TF(hi, (x - hi.astype(np.float64)).astype(np.float32))

    out = []
    m = 2
    while m <= L:
        k = np.arange(m // 2)
        ang = sign * 2.0 * np.pi * k / m
        out.append((split(np.cos(ang)), split(np.sin(ang))))
        m *= 2
    return tuple(out)


def _ctf_gather_last(x: CTF, idx: np.ndarray) -> CTF:
    i = jnp.asarray(idx)
    return CTF(
        TF(x.re.hi[..., i], x.re.lo[..., i]),
        TF(x.im.hi[..., i], x.im.lo[..., i]),
    )


def _ctf_reshape(x: CTF, shape) -> CTF:
    return CTF(
        TF(x.re.hi.reshape(shape), x.re.lo.reshape(shape)),
        TF(x.im.hi.reshape(shape), x.im.lo.reshape(shape)),
    )


def _ctf_concat_last(a: CTF, b: CTF) -> CTF:
    cat = lambda u, v: jnp.concatenate([u, v], axis=-1)  # noqa: E731
    return CTF(
        TF(cat(a.re.hi, b.re.hi), cat(a.re.lo, b.re.lo)),
        TF(cat(a.im.hi, b.im.hi), cat(a.im.lo, b.im.lo)),
    )


def _ctf_slice_last(x: CTF, lo: int, hi: int) -> CTF:
    return CTF(
        TF(x.re.hi[..., lo:hi], x.re.lo[..., lo:hi]),
        TF(x.im.hi[..., lo:hi], x.im.lo[..., lo:hi]),
    )


def tf_fft(x: CTF, *, inverse: bool = False) -> CTF:
    """Two-float complex FFT over the last axis (length must be a power of
    two).  ``inverse=True`` computes the unnormalized inverse transform
    (caller scales by 1/L -- exact for power-of-two L)."""
    L = x.re.hi.shape[-1]
    if L & (L - 1):
        raise ValueError(f"tf_fft length must be a power of 2, got {L}")
    if L == 1:
        return x
    x = _ctf_gather_last(x, _bit_reverse_perm(L))
    sign = 1 if inverse else -1
    twiddles = _fft_twiddles(L, sign)
    lead = x.re.hi.shape[:-1]
    m = 2
    for (w_re, w_im) in twiddles:
        # view as (..., L/m, m); butterfly even/odd halves of each group
        g = _ctf_reshape(x, lead + (L // m, m))
        ev = _ctf_slice_last(g, 0, m // 2)
        od = _ctf_slice_last(g, m // 2, m)
        # t = w * odd (w broadcast over the group axis)
        w = CTF(TF(w_re.hi, w_re.lo), TF(w_im.hi, w_im.lo))
        t = ctf_mul(od, w)
        upper = ctf_add(ev, t)
        lower = ctf_sub(ev, t)
        x = _ctf_reshape(_ctf_concat_last(upper, lower), lead + (L,))
        m *= 2
    return x


def tf_ifft(x: CTF) -> CTF:
    """Normalized two-float inverse FFT (1/L scaling is exact: L = 2^k)."""
    L = x.re.hi.shape[-1]
    y = tf_fft(x, inverse=True)
    return ctf_scale_f32(y, np.float32(1.0 / L))


def _ctf_pad_last(x: CTF, total: int) -> CTF:
    pad = total - x.re.hi.shape[-1]
    cfg = [(0, 0)] * (x.re.hi.ndim - 1) + [(0, pad)]
    p = lambda u: jnp.pad(u, cfg)  # noqa: E731
    return CTF(TF(p(x.re.hi), p(x.re.lo)), TF(p(x.im.hi), p(x.im.lo)))


def fwm_polarization_df32(a: CTF) -> CTF:
    """Two-float T_j = sum_{k+l-m=j} A_k A_l A_m^* via padded FFTs
    (the df32 rendering of ``nwave.fwm_polarization``)."""
    from ..models.nwave import _fft_len

    n = a.re.hi.shape[-1]
    L = _fft_len(n)
    F = tf_fft(_ctf_pad_last(a, L))
    # F^2 conj(F) = F |F|^2
    G = ctf_mul_real(F, ctf_abs2(F))
    T = tf_ifft(G)
    return _ctf_slice_last(T, 0, n)


# ---------------------------------------------------------------------------
# df32 comb RHS + RK4 + chunked reduce solver
# ---------------------------------------------------------------------------

@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class DF32CombCoeffs:
    """Two-float comb coefficients: gamma/alpha (B,) TF, beta_lin (B, N) TF."""

    gamma: TF
    neg_half_alpha: TF
    beta: TF


def make_df32_comb_coeffs(gamma, alpha, beta_lin) -> DF32CombCoeffs:
    g = np.asarray(gamma, dtype=np.float64)[..., None]       # (B, 1)
    a = np.asarray(alpha, dtype=np.float64)[..., None]
    return DF32CombCoeffs(
        gamma=tf_from_f64(g),
        neg_half_alpha=tf_from_f64(-0.5 * a),
        beta=tf_from_f64(np.asarray(beta_lin, dtype=np.float64)),
    )


def rhs_comb_df32(a: CTF, c: DF32CombCoeffs) -> CTF:
    """dA = (-alpha/2) A + i beta A + i gamma T(A), all two-float."""
    T = fwm_polarization_df32(a)
    lin = ctf_add(
        ctf_mul_real(a, c.neg_half_alpha),
        ctf_mul_i_real(a, c.beta),
    )
    return ctf_add(lin, ctf_mul_i_real(T, c.gamma))


class _StepConsts(NamedTuple):
    half_dz: TF
    dz: TF
    dz_over_6: TF


def _make_consts(dz_m: float) -> _StepConsts:
    return _StepConsts(
        half_dz=tf_from_f64(0.5 * float(dz_m)),
        dz=tf_from_f64(float(dz_m)),
        dz_over_6=tf_from_f64(float(dz_m) / 6.0),
    )


def rk4_step_comb_df32(y: CTF, consts: _StepConsts, c: DF32CombCoeffs) -> CTF:
    k1 = rhs_comb_df32(y, c)
    k2 = rhs_comb_df32(ctf_add(y, ctf_mul_real(k1, consts.half_dz)), c)
    k3 = rhs_comb_df32(ctf_add(y, ctf_mul_real(k2, consts.half_dz)), c)
    k4 = rhs_comb_df32(ctf_add(y, ctf_mul_real(k3, consts.dz)), c)
    incr = ctf_add(
        ctf_add(k1, k4), ctf_scale_f32(ctf_add(k2, k3), jnp.float32(2.0))
    )
    return ctf_add(y, ctf_mul_real(incr, consts.dz_over_6))


from .twofloat import ctf_all_finite as _finite  # noqa: E402
from .twofloat import ctf_freeze as _freeze  # noqa: E402
from .twofloat import tf_max as _tf_max  # noqa: E402


@functools.lru_cache(maxsize=32)
def _df32_comb_solver(n_steps: int, save_every: int):
    """Jitted batched df32 comb solve: (B, N) CTF state -> reductions.

    Returns f32-only leaves (fetch-safe): (pmax_hi, pmax_lo, re_hi, re_lo,
    im_hi, im_lo, ok_i32); P_max over saved samples (incl. z=0), state at
    the last saved grid point, per-lane finite flag (per-step freeze,
    saved-grid convention -- the solve_comb_batch contract).
    """
    n_chunks = n_steps // save_every
    remainder = n_steps - n_chunks * save_every

    def run(y0: CTF, coeffs: DF32CombCoeffs, consts: _StepConsts):
        P0 = ctf_abs2(y0)
        ok0 = _finite(y0)

        def inner(carry, _):
            y, ok = carry
            y_new = rk4_step_comb_df32(y, consts, coeffs)
            ok_new = ok & _finite(y_new)
            return (_freeze(ok_new, y_new, y), ok_new), None

        def chunk(carry, _):
            y, ok, pmax, _last = carry
            (y, ok), _ = lax.scan(inner, (y, ok), None, length=save_every)
            pmax = _tf_max(ctf_abs2(y), pmax)
            return (y, ok, pmax, y), None

        carry = (y0, ok0, P0, y0)
        if n_chunks > 0:
            carry, _ = lax.scan(chunk, carry, None, length=n_chunks)
        y, ok, pmax, last = carry
        if remainder > 0:
            (y, ok), _ = lax.scan(inner, (y, ok), None, length=remainder)
        return (
            pmax.hi, pmax.lo,
            last.re.hi, last.re.lo, last.im.hi, last.im.lo,
            ok.astype(jnp.int32),
        )

    return jax.jit(run)


@dataclasses.dataclass(frozen=True)
class DF32CombResult:
    P_max: np.ndarray   # (B, N) f64
    A_end: np.ndarray   # (B, N) c128 (last saved grid point)
    ok: np.ndarray      # (B,) bool


def solve_comb_batch_df32(
    A0: np.ndarray,
    gamma,
    alpha,
    beta_lin,
    *,
    dz_m: float,
    n_steps: int,
    save_every: int,
    mesh=None,
) -> DF32CombResult:
    """Batched matched-tolerance comb solve; per-meter f64 inputs.

    Contract mirrors ``nwave.solve_comb_batch`` (rk4): P_max over saved
    samples, state at the last saved grid point, per-lane ok.  Pass ``mesh``
    to shard the batch axis (embarrassingly SPMD; NamedSharding on every
    two-float leaf).
    """
    A0 = np.asarray(A0, dtype=np.complex128)
    if A0.ndim != 2:
        raise ValueError(f"A0 must have shape (B, N), got {A0.shape}")
    B, n = A0.shape
    gamma = np.broadcast_to(np.asarray(gamma, dtype=np.float64), (B,))
    alpha = np.broadcast_to(np.asarray(alpha, dtype=np.float64), (B,))
    beta = np.broadcast_to(np.asarray(beta_lin, dtype=np.float64), (B, n))

    n_orig = B
    if mesh is not None:
        from ..parallel.mesh import batch_sharding, pad_batch

        ndev = int(np.prod(list(mesh.shape.values())))
        A0, n_orig = pad_batch(A0, ndev)
        gamma, _ = pad_batch(gamma, ndev)
        alpha, _ = pad_batch(alpha, ndev)
        beta, _ = pad_batch(beta, ndev)

    y0 = ctf_from_c128(A0)
    coeffs = make_df32_comb_coeffs(gamma, alpha, beta)
    consts = _make_consts(dz_m)
    if mesh is not None:
        from ..parallel.mesh import batch_sharding, put_global_tree

        sh = batch_sharding(mesh)
        y0 = put_global_tree(jax.tree_util.tree_map(np.asarray, y0), sh)
        coeffs = put_global_tree(
            jax.tree_util.tree_map(np.asarray, coeffs), sh
        )

    solver = _df32_comb_solver(int(n_steps), int(save_every))
    out = jax.block_until_ready(solver(y0, coeffs, consts))
    if mesh is not None:
        from ..parallel.mesh import fetch_global

        out = tuple(fetch_global(x) for x in out)
    (pmax_hi, pmax_lo, re_hi, re_lo, im_hi, im_lo, ok) = out

    f64 = np.float64
    P_max = (np.asarray(pmax_hi, f64) + np.asarray(pmax_lo, f64))[:n_orig]
    A_end = (
        np.asarray(re_hi, f64) + np.asarray(re_lo, f64)
        + 1j * (np.asarray(im_hi, f64) + np.asarray(im_lo, f64))
    )[:n_orig]
    return DF32CombResult(
        P_max=P_max, A_end=A_end,
        ok=np.asarray(ok, dtype=np.int32)[:n_orig].astype(bool),
    )
