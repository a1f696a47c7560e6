"""Matched-tolerance (df32) GNLSE split-step solver: two-float SSFM.

Closes the last family without a ~1e-9-class float32 path (the comb gained one
in ``ops/df32_comb.py``): the correctness bar is the f64 reference
semantics (/root/reference/integrators.py:25-61 -- f64 stepping; the
reference has no field model, so the oracle is this framework's own x64
CPU split-step).  The x32 SSFM engines top out at ~1e-3 relative after
10^3 steps (f32 FFT + state rounding compounding through the cascade);
this module evaluates the whole Strang step in two-float (double-word f32,
~49-bit) arithmetic:

- linear substep: the radix-2 two-float FFT (``ops/df32_comb.tf_fft``)
  and a host-precomputed CTF factor exp((-alpha/2 + i phi) h) split
  exactly from f64 -- per-instance/spectral loss and arbitrary-order
  dispersion phase all collapse into the factor planes;
- nonlinear substep: the exact Kerr rotation exp(i gamma h |A|^2) with the
  angle, sin and cos all in two-float (``twofloat.tf_sin_cos``: range
  reduction + Taylor pair; f32 sin/cos intrinsics stop at 2^-24 and would
  cap the whole integration at x32 quality).

Chunked save-decimation scan, per-chunk NaN lane freeze, running
max-over-saved-samples peak and the ONE-stacked-f32-buffer fetch contract
all mirror ``models/gnlse._gnlse_reduce_solver`` (reference
save-decimation semantics: /root/reference/integrators.py:137-140).

XLA:CPU compiles two-float programs pathologically slowly (CLAUDE.md
constraint 4), so jitted-solver tests are opt-in; CPU coverage drives
the eager component lane (``run_reduce_eager`` below) -- the same split as
the other df32 engines.

The generalized Raman/self-steepening nonlinearity (round 3, session 4)
runs the same RK4 on the two-float operator that the x64 engine uses
(``_nl_m_df32`` / ``nl_rk4_df32``): the Raman convolution and the shock
derivative each cost a tf_fft pair per RK4 stage, so this tier is for
verification-grade accuracy, not the throughput record.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import numpy as np
import jax.numpy as jnp
from jax import lax

from .df32_comb import tf_fft, tf_ifft
from .twofloat import (
    CTF,
    TF,
    ctf_abs2,
    ctf_add,
    ctf_all_finite,
    ctf_freeze,
    ctf_from_c128,
    ctf_mul,
    ctf_mul_i_real,
    ctf_mul_real,
    ctf_scale_f32,
    ctf_sub,
    tf_add,
    tf_from_f64,
    tf_max,
    tf_mul,
    tf_sin_cos,
    tf_zeros,
)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class DF32GNLSECoeffs:
    """Two-float split-step operators: CTF half-/full-step frequency-domain
    linear factors ((1, T) shared or (B, T) per-instance) and the TF Kerr
    angle scale gamma*h ((B, 1))."""

    lin_half: CTF
    lin_full: CTF
    gamma_h: TF


def make_df32_gnlse_coeffs(gamma, alpha, lin_phase, *, dz_m: float,
                           B: int, T: int) -> DF32GNLSECoeffs:
    """Build the two-float operators from per-meter f64 inputs.

    ``gamma`` broadcasts to (B,); ``alpha`` is flat (scalar / (B,)) or
    spectral ((T,) / (B, T), fft-ordered); ``lin_phase`` is (T,) or (B, T)
    [rad/m].  Factors shared across the batch stay (1, T) (broadcast
    device-side)."""
    g = np.broadcast_to(np.asarray(gamma, dtype=np.float64), (B,))
    al = np.asarray(alpha, dtype=np.float64)
    if al.ndim == 2 or (al.ndim == 1 and al.shape[0] == T and T != B):
        al = np.broadcast_to(al, (B, T)) if al.ndim == 2 else al[None, :]
    else:
        al = np.broadcast_to(al, (B,))[:, None]
    ph = np.asarray(lin_phase, dtype=np.float64)
    ph = ph[None, :] if ph.ndim == 1 else np.broadcast_to(ph, (B, T))
    shared = al.shape[0] == 1 or (al.shape[1] == 1 and np.all(al == al[0]))
    shared = shared and ph.shape[0] == 1
    if shared:
        al = al[:1]          # (1, T) or (1, 1): one factor plane, broadcast
    else:
        al = np.broadcast_to(al, (B, T))
        ph = np.broadcast_to(ph, (B, T))

    def factor(h):
        # a runaway-gain lane (alpha < 0 large) overflows to inf here by
        # design: the solver's finite check then freezes that lane
        with np.errstate(over="ignore", invalid="ignore"):
            return ctf_from_c128(np.exp((-0.5 * al + 1j * ph) * h))

    return DF32GNLSECoeffs(
        lin_half=factor(0.5 * dz_m),
        lin_full=factor(dz_m),
        gamma_h=tf_from_f64((g * dz_m)[:, None]),
    )


def kerr_rotation_df32(y: CTF, gamma_h: TF) -> CTF:
    """Exact time-domain Kerr rotation A * exp(i gamma h |A|^2), all
    two-float (the df32 rendering of ``models/gnlse._kerr_step``)."""
    s, c = tf_sin_cos(tf_mul(gamma_h, ctf_abs2(y)))
    return ctf_mul(y, CTF(c, s))


def _lin(y: CTF, L: CTF) -> CTF:
    return tf_ifft(ctf_mul(tf_fft(y), L))


def _np_tf_split(x: np.ndarray) -> TF:
    """Exact host f64 -> (hi, lo) f32 split as NUMPY leaves (no device
    commit: the planes are jit-lifted once per solver, and the sharded
    path device_puts them replicated without a device->host round trip)."""
    hi = x.astype(np.float32)
    return TF(hi, (x - hi.astype(np.float64)).astype(np.float32))


def make_df32_nl_planes(nl) -> "tuple[CTF, TF]":
    """Split a host-f64 ``models.gnlse.NLTerms`` (built with
    precision='df32', which keeps numpy leaves) into the engine's
    two-float planes: (conj(H_R) CTF (T,), omega TF (T,)).  Rejects
    f32-built terms: upcasting them would zero every lo limb and silently
    degrade the <=1e-9 tier to f32-class accuracy."""
    from ..utils.precision import require_f64_leaves

    require_f64_leaves("make_df32_nl_planes", hr_re=nl.hr_re,
                       hr_im=nl.hr_im, omega=nl.omega)
    hr_re = np.asarray(nl.hr_re, dtype=np.float64)
    hr_im = np.asarray(nl.hr_im, dtype=np.float64)
    return (
        CTF(_np_tf_split(hr_re), _np_tf_split(-hr_im)),
        _np_tf_split(np.asarray(nl.omega, dtype=np.float64)),
    )


def _nl_m_df32(y: CTF, gamma_h: TF, nlp, f_r: float, inv_w0: float) -> CTF:
    """h-scaled generalized nonlinear operator, all two-float -- the df32
    rendering of ``models/gnlse._nl_rhs`` times the step.  As implemented
    (this module's time axis is the REVERSE of Agrawal's retarded time,
    see ``_nl_rhs``'s t = -T note -- the shock derivative is SUBTRACTED):

        M(A) = i gamma h [ W - (i/w0) dW/dt ],
        W    = A ((1-f_R) P + f_R conj(H_R)-convolved P).

    ``nlp`` is ``(hrc CTF (T,), omega TF (T,))`` from
    :func:`make_df32_nl_planes`; ``f_r`` / ``inv_w0`` are STATIC floats
    (disabled terms drop their transforms at trace time, matching the
    x64 path's math exactly: the full-complex two-float FFT of the real
    power waveform computes the identical convolution the scan engine's
    rfft pair does)."""
    hrc, omega = nlp
    P = ctf_abs2(y)
    if f_r > 0.0:
        S = ctf_mul(tf_fft(CTF(P, tf_zeros(P.hi.shape))), hrc)
        R = tf_ifft(S).re
        fac = tf_add(tf_mul(tf_from_f64(1.0 - np.float64(f_r)), P),
                     tf_mul(tf_from_f64(np.float64(f_r)), R))
    else:
        fac = P
    W = ctf_mul_real(y, fac)
    out = W
    if inv_w0 != 0.0:
        V = tf_ifft(ctf_mul_i_real(tf_fft(W), omega))    # dW/dt
        out = ctf_sub(W, ctf_mul_i_real(V, tf_from_f64(np.float64(inv_w0))))
    return ctf_mul_i_real(out, gamma_h)                  # i gamma h (...)


def nl_rk4_df32(y: CTF, gamma_h: TF, nlp, f_r: float, inv_w0: float) -> CTF:
    """RK4 substep on the generalized operator, two-float -- the df32
    rendering of ``models/gnlse._nl_substep`` (nl is not None).  Exact
    f32 stage scales (0.5, 2.0) + a two-float 1/6: matched METHOD, so
    df32-vs-x64 differs only by rounding."""
    m1 = _nl_m_df32(y, gamma_h, nlp, f_r, inv_w0)
    m2 = _nl_m_df32(ctf_add(y, ctf_scale_f32(m1, 0.5)), gamma_h, nlp,
                    f_r, inv_w0)
    m3 = _nl_m_df32(ctf_add(y, ctf_scale_f32(m2, 0.5)), gamma_h, nlp,
                    f_r, inv_w0)
    m4 = _nl_m_df32(ctf_add(y, m3), gamma_h, nlp, f_r, inv_w0)
    acc = ctf_add(ctf_add(m1, m4), ctf_scale_f32(ctf_add(m2, m3), 2.0))
    return ctf_add(y, ctf_mul_real(acc, tf_from_f64(np.float64(1.0) / 6.0)))


def ssfm_steps_df32(y: CTF, co: DF32GNLSECoeffs, k: int,
                    unroll: bool = False, nlp=None,
                    f_r: float = 0.0, inv_w0: float = 0.0) -> CTF:
    """k fused symmetric split steps Lh (K Lf)^(k-1) K Lh (the
    ``models/gnlse._chunk_stepper`` contract).  ``unroll=True`` avoids
    lax.scan for the eager CPU lane.  ``nlp`` (with static ``f_r`` /
    ``inv_w0``) switches the nonlinear substep from the exact Kerr
    rotation to the two-float RK4 on the generalized operator."""
    if k == 0:
        return y

    if nlp is None:
        def sub(c):
            return kerr_rotation_df32(c, co.gamma_h)
    else:
        def sub(c):
            return nl_rk4_df32(c, co.gamma_h, nlp, f_r, inv_w0)

    y = _lin(y, co.lin_half)

    def body(c, _):
        return _lin(sub(c), co.lin_full), None

    if k > 1:
        if unroll:
            for _ in range(k - 1):
                y, _ = body(y, None)
        else:
            y, _ = lax.scan(body, y, None, length=k - 1)
    return _lin(sub(y), co.lin_half)


def _peak(y: CTF) -> TF:
    """(B,) TF max over time samples of |A|^2 (pairwise tree reduction --
    T is a power of two for tf_fft)."""
    P = ctf_abs2(y)
    while P.hi.shape[-1] > 1:
        h = P.hi.shape[-1] // 2
        P = tf_max(TF(P.hi[..., :h], P.lo[..., :h]),
                   TF(P.hi[..., h:], P.lo[..., h:]))
    return TF(P.hi[..., 0], P.lo[..., 0])


def run_reduce_eager(y0: CTF, co: DF32GNLSECoeffs, n_steps: int,
                     save_every: int, nlp=None, f_r: float = 0.0,
                     inv_w0: float = 0.0):
    """Eager (op-by-op) reduce-mode solve for the CPU test lane: identical
    chunk/freeze/peak semantics to the jitted solver, python loops instead
    of scans.  Returns (pk TF (B,), y CTF, ok bool (B,))."""
    n_chunks = n_steps // save_every
    remainder = n_steps - n_chunks * save_every
    kw = dict(unroll=True, nlp=nlp, f_r=f_r, inv_w0=inv_w0)
    ok = ctf_all_finite(y0)
    pk = _peak(y0)
    y = y0
    for _ in range(n_chunks):
        y_new = ssfm_steps_df32(y, co, save_every, **kw)
        ok = ok & ctf_all_finite(y_new)
        y = ctf_freeze(ok, y_new, y)
        pk = tf_max(pk, _peak(y))
    if remainder > 0:
        y_new = ssfm_steps_df32(y, co, remainder, **kw)
        ok = ok & ctf_all_finite(y_new)
    return pk, y, ok


@functools.lru_cache(maxsize=32)
def _df32_gnlse_solver(n_steps: int, save_every: int,
                       f_r: float = 0.0, inv_w0: float = 0.0,
                       has_nl: bool = False):
    """Jitted batched df32 SSFM reduce solve: (B, T) CTF state -> ONE
    stacked (B, 4T + 3) f32 buffer [pk_hi | pk_lo | re_hi | re_lo | im_hi |
    im_lo | ok] (a single f32 output buffer)."""
    n_chunks = n_steps // save_every
    remainder = n_steps - n_chunks * save_every

    def run(y0: CTF, co: DF32GNLSECoeffs, nlp=None):
        kw = dict(nlp=nlp, f_r=f_r, inv_w0=inv_w0) if has_nl else {}
        ok0 = ctf_all_finite(y0)

        def chunk(carry, _):
            y, pk, ok = carry
            y_new = ssfm_steps_df32(y, co, save_every, **kw)
            ok_new = ok & ctf_all_finite(y_new)
            y_out = ctf_freeze(ok_new, y_new, y)
            pk = tf_max(pk, _peak(y_out))
            return (y_out, pk, ok_new), None

        carry = (y0, _peak(y0), ok0)
        if n_chunks > 0:
            carry, _ = lax.scan(chunk, carry, None, length=n_chunks)
        y, pk, ok = carry
        if remainder > 0:
            y_new = ssfm_steps_df32(y, co, remainder, **kw)
            ok = ok & ctf_all_finite(y_new)
        return jnp.concatenate(
            [pk.hi[:, None], pk.lo[:, None],
             y.re.hi, y.re.lo, y.im.hi, y.im.lo,
             ok.astype(jnp.float32)[:, None]], axis=1)

    return jax.jit(run)


@functools.lru_cache(maxsize=16)
def _df32_gnlse_traj_solver(n_steps: int, save_every: int,
                            f_r: float = 0.0, inv_w0: float = 0.0,
                            has_nl: bool = False):
    """Jitted trajectory-mode df32 SSFM: per-chunk saved states.

    Returns ``(ys (S, B, 4T) f32 [re_hi | re_lo | im_hi | im_lo],
    ok (B,) i32)`` -- rows are the saved grid WITHOUT z=0 (the caller
    already holds the input), frozen-lane semantics as in reduce mode."""
    n_chunks = n_steps // save_every
    remainder = n_steps - n_chunks * save_every

    def run(y0: CTF, co: DF32GNLSECoeffs, nlp=None):
        kw = dict(nlp=nlp, f_r=f_r, inv_w0=inv_w0) if has_nl else {}
        ok0 = ctf_all_finite(y0)

        def chunk(carry, _):
            y, ok = carry
            y_new = ssfm_steps_df32(y, co, save_every, **kw)
            ok_new = ok & ctf_all_finite(y_new)
            y_out = ctf_freeze(ok_new, y_new, y)
            row = jnp.concatenate(
                [y_out.re.hi, y_out.re.lo, y_out.im.hi, y_out.im.lo],
                axis=-1)
            return (y_out, ok_new), row

        if n_chunks > 0:
            (y, ok), ys = lax.scan(chunk, (y0, ok0), None, length=n_chunks)
        else:
            y, ok = y0, ok0
            ys = jnp.zeros((0, y0.re.hi.shape[0], 4 * y0.re.hi.shape[1]),
                           dtype=jnp.float32)
        if remainder > 0:
            y_new = ssfm_steps_df32(y, co, remainder, **kw)
            ok = ok & ctf_all_finite(y_new)
        return ys, ok.astype(jnp.int32)

    return jax.jit(run)


def run_gnlse_traj_df32(
    A0: np.ndarray,
    gamma,
    alpha,
    lin_phase,
    *,
    dz_m: float,
    n_steps: int,
    save_every: int,
    nl=None,
):
    """Matched-tolerance trajectory solve for ``run_gnlse_simulation``'s
    df32 tier: ``A0`` is (B, T) c128; returns host ``(A_saved (S+1, B, T)
    c128 incl. the z=0 row, ok (B,) bool)``.  ``nl`` (a host-f64
    ``NLTerms``) switches the substep to the two-float RK4 on the
    generalized operator."""
    A0 = np.asarray(A0, dtype=np.complex128)
    B, T = A0.shape
    if T & (T - 1):
        raise ValueError(
            f"T={T} must be a power of two for the two-float FFT"
        )
    co = make_df32_gnlse_coeffs(gamma, alpha, lin_phase,
                                dz_m=float(dz_m), B=B, T=T)
    nlp = None
    f_r = inv_w0 = 0.0
    if nl is not None:
        nlp = make_df32_nl_planes(nl)
        f_r = float(np.asarray(nl.f_r))
        inv_w0 = float(np.asarray(nl.inv_w0))
    solver = _df32_gnlse_traj_solver(int(n_steps), int(save_every),
                                     f_r, inv_w0, nl is not None)
    ys, ok = jax.block_until_ready(solver(ctf_from_c128(A0), co, nlp))
    ys = np.asarray(ys, dtype=np.float64)
    A_saved = np.concatenate([
        A0[None],
        (ys[..., :T] + ys[..., T:2 * T])
        + 1j * (ys[..., 2 * T:3 * T] + ys[..., 3 * T:]),
    ], axis=0)
    return A_saved, np.asarray(ok).astype(bool)


def solve_gnlse_batch_df32(
    A0: np.ndarray,
    gamma,
    alpha,
    lin_phase,
    *,
    dz_m: float,
    n_steps: int,
    save_every: int,
    mesh=None,
    nl=None,
):
    """Batched matched-tolerance SSFM solve; per-meter f64 inputs.

    Contract mirrors ``models/gnlse.solve_gnlse_batch`` (fixed-step reduce
    mode): returns host ``(peak_max (B,) f64, A_last (B, T) c128, ok (B,)
    bool)`` -- peak over saved samples incl. z=0, state at the last saved
    grid point, per-chunk NaN lane freeze.  T must be a power of two
    (``tf_fft``).  Pass ``mesh`` to shard the batch axis (embarrassingly
    SPMD; NamedSharding on every two-float leaf)."""
    A0 = np.asarray(A0, dtype=np.complex128)
    if A0.ndim != 2:
        raise ValueError(f"A0 must have shape (B, T), got {A0.shape}")
    B, T = A0.shape
    if T & (T - 1):
        raise ValueError(
            f"T={T} must be a power of two for the two-float FFT"
        )

    n_orig = B
    if mesh is not None:
        from ..parallel.mesh import (
            batch_sharding,
            fetch_global,
            pad_batch,
            put_global_tree,
            replicated_sharding,
        )

        # pad any B-carrying input before building the operators so the
        # padded lanes get valid (replicated-last) coefficients
        ndev = int(np.prod(list(mesh.shape.values())))
        A0, n_orig = pad_batch(A0, ndev)
        B = A0.shape[0]
        g = np.asarray(gamma, dtype=np.float64)
        if g.ndim == 1:
            g, _ = pad_batch(g, ndev)
        al = np.asarray(alpha, dtype=np.float64)
        if al.ndim == 2 or (al.ndim == 1 and not (
                al.shape[0] == T and T != n_orig)):
            al, _ = pad_batch(np.broadcast_to(
                al, (n_orig, T) if al.ndim == 2 else (n_orig,)), ndev)
            if al.ndim == 1:
                # (B, 1): unambiguous per-instance rank after padding (a
                # padded B can coincide with T)
                al = al[:, None]
        ph = np.asarray(lin_phase, dtype=np.float64)
        if ph.ndim == 2:
            ph, _ = pad_batch(ph, ndev)
        gamma, alpha, lin_phase = g, al, ph

    co = make_df32_gnlse_coeffs(gamma, alpha, lin_phase,
                                dz_m=float(dz_m), B=B, T=T)
    nlp = None
    f_r = inv_w0 = 0.0
    if nl is not None:
        nlp = make_df32_nl_planes(nl)
        f_r = float(np.asarray(nl.f_r))
        inv_w0 = float(np.asarray(nl.inv_w0))
    if mesh is not None:
        sh_b = batch_sharding(mesh)
        sh_r = replicated_sharding(mesh)
        y0 = put_global_tree(
            jax.tree_util.tree_map(np.asarray, ctf_from_c128(A0)), sh_b)
        # shared (1, T) factor planes replicate; per-instance leaves shard
        co = jax.tree_util.tree_map(
            lambda x: jax.device_put(
                np.asarray(x), sh_b if x.shape[0] == B else sh_r),
            co,
        )
        if nlp is not None:
            nlp = jax.tree_util.tree_map(
                lambda x: jax.device_put(np.asarray(x), sh_r), nlp)
    else:
        y0 = ctf_from_c128(A0)

    solver = _df32_gnlse_solver(int(n_steps), int(save_every),
                                f_r, inv_w0, nl is not None)
    out = jax.block_until_ready(solver(y0, co, nlp))
    if mesh is not None:
        out = fetch_global(out)
    out = np.asarray(out, dtype=np.float64)

    pk = out[:, 0] + out[:, 1]
    re = out[:, 2:2 + T] + out[:, 2 + T:2 + 2 * T]
    im = out[:, 2 + 2 * T:2 + 3 * T] + out[:, 2 + 3 * T:2 + 4 * T]
    ok = out[:, 4 * T + 2] > 0.0
    return pk[:n_orig], (re + 1j * im)[:n_orig], ok[:n_orig]
