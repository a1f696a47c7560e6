"""Matched-tolerance (df32) vector-GNLSE split-step solver.

Two-float rendering of ``models/vgnlse``'s couplings.  For the incoherent
models (CNLSE b=2/3 and Manakov b=1) the nonlinear substep is the exact
coupled rotation exp(i gamma (P_self + b P_other) h) -- both powers are
invariants of the incoherent flow, so the df32 step needs only
``tf_sin_cos`` on a two-float angle, like the scalar engine
(``ops/df32_gnlse.py``).  The coherent c-term (``coherent != 0``, the full
isotropic Kerr tensor) is NOT a rotation (it exchanges power pointwise);
its substep is the same RK4 on the pointwise operator that the x64 engine
uses (``models/vgnlse._v_nl_substep``), evaluated entirely in two-float
arithmetic -- matched METHOD, so df32-vs-x64 differs only by rounding,
not truncation.

The generalized Raman/self-steepening nonlinearity (isotropic-Raman
approximation, ``models/vgnlse._v_nl_rhs_gen``) runs the same two-float
RK4 treatment as the scalar engine: ``_v_nl_m_gen_df32`` /
``v_nl_rk4_gen_df32`` below, with the delayed response convolved against
the TOTAL power via one two-float FFT pair per stage.

State is a (B, 2, T) CTF; the linear substep reuses the scalar engine's
``_lin`` (the two-float FFT transforms the trailing axis, batching over
(B, 2)).  Chunk/freeze/peak semantics mirror ``models/vgnlse._vgnlse_solver``
(reduce mode): per-instance (not per-polarization) NaN freeze, running
max-over-saved-samples peak per polarization, ONE stacked f32 output
buffer.  Same CPU-eager / opt-in jitted test split as every df32 engine
(CLAUDE.md constraint 4).
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import numpy as np
import jax.numpy as jnp
from jax import lax

from .df32_comb import tf_fft, tf_ifft
from .df32_gnlse import _lin, make_df32_nl_planes
from .twofloat import (
    CTF,
    TF,
    ctf_abs2,
    ctf_add,
    ctf_conj,
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
    tf_neg,
    tf_sin_cos,
    tf_zeros,
)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class DF32VGNLSECoeffs:
    """Two-float vector split-step operators: CTF half-/full-step linear
    factors ((1 or B, 2, T)), the TF Kerr angle scale gamma*h ((B, 1, 1))
    and the TF cross-phase ratio b (scalar)."""

    lin_half: CTF
    lin_full: CTF
    gamma_h: TF
    b_xpm: TF


def make_df32_vgnlse_coeffs(gamma, alpha, b_xpm, lin_phase, *, dz_m: float,
                            B: int, T: int) -> DF32VGNLSECoeffs:
    """Build the operators from per-meter f64 inputs.  ``gamma`` broadcasts
    to (B,); ``alpha`` is flat (scalar / (B,)) or spectral ((2, T) /
    (B, 2, T)); ``lin_phase`` is (2, T) or (B, 2, T) [rad/m] (the
    birefringent splitting already folded in, as in
    :func:`~..models.vgnlse.make_vgnlse_coeffs`)."""
    g = np.broadcast_to(np.asarray(gamma, dtype=np.float64), (B,))
    al = np.asarray(alpha, dtype=np.float64)
    if al.ndim >= 2:
        al = al[None] if al.ndim == 2 else np.broadcast_to(al, (B, 2, T))
    else:
        al = np.broadcast_to(al, (B,))[:, None, None]
    ph = np.asarray(lin_phase, dtype=np.float64)
    ph = ph[None] if ph.ndim == 2 else np.broadcast_to(ph, (B, 2, T))
    shared = (al.shape[0] == 1 or np.all(al == al[:1])) and ph.shape[0] == 1
    if shared:
        al = al[:1]
    else:
        al = np.broadcast_to(al, (B, 2, T))
        ph = np.broadcast_to(ph, (B, 2, T))

    def factor(h):
        # runaway-gain overflow to inf is by design (freeze contract)
        with np.errstate(over="ignore", invalid="ignore"):
            return ctf_from_c128(np.exp((-0.5 * al + 1j * ph) * h))

    return DF32VGNLSECoeffs(
        lin_half=factor(0.5 * dz_m),
        lin_full=factor(dz_m),
        gamma_h=tf_from_f64((g * dz_m)[:, None, None]),
        b_xpm=tf_from_f64(np.float64(b_xpm)),
    )


def _tf_flip_pol(P: TF) -> TF:
    return TF(jnp.flip(P.hi, axis=-2), jnp.flip(P.lo, axis=-2))


def xpm_kerr_rotation_df32(y: CTF, gamma_h: TF, b: TF) -> CTF:
    """Exact coupled rotation exp(i gamma h (P_self + b P_other)) per
    polarization, all two-float (the df32 rendering of
    ``models/vgnlse._xpm_kerr_step``)."""
    P = ctf_abs2(y)                                  # (B, 2, T) TF
    ang = tf_mul(gamma_h, tf_add(P, tf_mul(b, _tf_flip_pol(P))))
    s, c = tf_sin_cos(ang)
    return ctf_mul(y, CTF(c, s))


def _ctf_flip_pol(y: CTF) -> CTF:
    return CTF(_tf_flip_pol(y.re), _tf_flip_pol(y.im))


def _v_nl_m_df32(y: CTF, gamma_h: TF, b: TF, c: TF) -> CTF:
    """h-scaled coherent vector operator, all two-float:
    M(A)_p = i gamma h [ (P_p + b P_q) A_p + c A_p* A_q^2 ],  q = other pol
    (``models/vgnlse._v_nl_rhs`` times the step; RK4 below uses the scaled
    form so only the gamma*h product the coeffs already carry is needed)."""
    P = ctf_abs2(y)
    t_inc = ctf_mul_real(y, tf_add(P, tf_mul(b, _tf_flip_pol(P))))
    y_q = _ctf_flip_pol(y)
    coh = ctf_mul(ctf_conj(y), ctf_mul(y_q, y_q))
    s = ctf_mul_real(ctf_add(t_inc, ctf_mul_real(coh, c)), gamma_h)
    return CTF(tf_neg(s.im), s.re)                       # i * s


def v_nl_rk4_df32(y: CTF, gamma_h: TF, b: TF, coherent: float) -> CTF:
    """RK4 substep on the full (coherent) vector operator, two-float --
    the df32 rendering of ``models/vgnlse._v_nl_substep`` (coherent != 0).
    Stage combinations use exact f32 scales (0.5, 2.0) and a two-float
    1/6, so the only df32-vs-x64 difference is rounding."""
    c = tf_from_f64(np.float64(coherent))
    sixth = tf_from_f64(np.float64(1.0) / 6.0)
    m1 = _v_nl_m_df32(y, gamma_h, b, c)
    m2 = _v_nl_m_df32(ctf_add(y, ctf_scale_f32(m1, 0.5)), gamma_h, b, c)
    m3 = _v_nl_m_df32(ctf_add(y, ctf_scale_f32(m2, 0.5)), gamma_h, b, c)
    m4 = _v_nl_m_df32(ctf_add(y, m3), gamma_h, b, c)
    acc = ctf_add(ctf_add(m1, m4), ctf_scale_f32(ctf_add(m2, m3), 2.0))
    return ctf_add(y, ctf_mul_real(acc, sixth))


def _v_nl_m_gen_df32(y: CTF, gamma_h: TF, b: TF, c: float, nlp,
                     f_r: float, inv_w0: float) -> CTF:
    """h-scaled GENERALIZED vector operator, all two-float -- the df32
    rendering of ``models/vgnlse._v_nl_rhs_gen`` times the step
    (isotropic-Raman approximation: the scalar delayed response acts on
    the total power P_x + P_y):

        M(A)_p = i gamma h [ W_p - (i/w0) dW_p/dt ],
        W_p = (1-f_R) [ (P_p + b P_q) A_p + c A_p* A_q^2 ]
              + f_R A_p (conj(H_R)-convolved (P_x + P_y)).

    ``nlp`` is ``(hrc CTF (T,), omega TF (T,))`` from
    :func:`~.df32_gnlse.make_df32_nl_planes`; ``c`` / ``f_r`` / ``inv_w0``
    are STATIC floats (disabled terms drop their transforms at trace
    time, matching the x64 path's math)."""
    hrc, omega = nlp
    P = ctf_abs2(y)
    K = ctf_mul_real(y, tf_add(P, tf_mul(b, _tf_flip_pol(P))))
    if c != 0.0:
        y_q = _ctf_flip_pol(y)
        coh = ctf_mul(ctf_conj(y), ctf_mul(y_q, y_q))
        K = ctf_add(K, ctf_mul_real(coh, tf_from_f64(np.float64(c))))
    if f_r > 0.0:
        # total power on ONE pol row (the response is a scalar; R then
        # broadcasts back over the pol axis) -- half the transforms
        Ps = tf_add(P, _tf_flip_pol(P))
        Pt = TF(Ps.hi[..., :1, :], Ps.lo[..., :1, :])
        S = ctf_mul(tf_fft(CTF(Pt, tf_zeros(Pt.hi.shape))), hrc)
        R = tf_ifft(S).re
        W = ctf_add(
            ctf_mul_real(K, tf_from_f64(np.float64(1.0 - f_r))),
            ctf_mul_real(ctf_mul_real(y, R),
                         tf_from_f64(np.float64(f_r))),
        )
    else:
        W = K
    out = W
    if inv_w0 != 0.0:
        V = tf_ifft(ctf_mul_i_real(tf_fft(W), omega))    # dW/dt
        out = ctf_sub(W, ctf_mul_i_real(V, tf_from_f64(np.float64(inv_w0))))
    return ctf_mul_i_real(out, gamma_h)                  # i gamma h (...)


def v_nl_rk4_gen_df32(y: CTF, gamma_h: TF, b: TF, coherent: float, nlp,
                      f_r: float, inv_w0: float) -> CTF:
    """RK4 substep on the generalized vector operator, two-float (df32
    rendering of ``models/vgnlse._v_nl_substep`` with nl present).  Exact
    f32 stage scales + a two-float 1/6: matched METHOD vs x64."""
    def m(v):
        return _v_nl_m_gen_df32(v, gamma_h, b, coherent, nlp, f_r, inv_w0)

    m1 = m(y)
    m2 = m(ctf_add(y, ctf_scale_f32(m1, 0.5)))
    m3 = m(ctf_add(y, ctf_scale_f32(m2, 0.5)))
    m4 = m(ctf_add(y, m3))
    acc = ctf_add(ctf_add(m1, m4), ctf_scale_f32(ctf_add(m2, m3), 2.0))
    return ctf_add(y, ctf_mul_real(acc, tf_from_f64(np.float64(1.0) / 6.0)))


def vssfm_steps_df32(y: CTF, co: DF32VGNLSECoeffs, k: int,
                     unroll: bool = False, coherent: float = 0.0,
                     nlp=None, f_r: float = 0.0,
                     inv_w0: float = 0.0) -> CTF:
    """k fused symmetric split steps (``_chunk_stepper_v`` contract);
    ``coherent`` (trace-time constant) selects the nonlinear substep;
    ``nlp`` (with static ``f_r`` / ``inv_w0``) switches it to the
    two-float RK4 on the generalized Raman/steepening operator."""
    if k == 0:
        return y

    if nlp is not None:
        def sub(c):
            return v_nl_rk4_gen_df32(c, co.gamma_h, co.b_xpm, coherent,
                                     nlp, f_r, inv_w0)
    elif coherent == 0.0:
        def sub(c):
            return xpm_kerr_rotation_df32(c, co.gamma_h, co.b_xpm)
    else:
        def sub(c):
            return v_nl_rk4_df32(c, co.gamma_h, co.b_xpm, coherent)

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


def _v_finite(y: CTF) -> jax.Array:
    """(B,) per-instance all-finite over (pol, time)."""
    return (
        jnp.all(jnp.isfinite(y.re.hi), axis=(-2, -1))
        & jnp.all(jnp.isfinite(y.im.hi), axis=(-2, -1))
    )


def _v_peak(y: CTF) -> TF:
    """(B, 2) TF per-polarization max over time of |A|^2."""
    P = ctf_abs2(y)
    while P.hi.shape[-1] > 1:
        h = P.hi.shape[-1] // 2
        P = tf_max(TF(P.hi[..., :h], P.lo[..., :h]),
                   TF(P.hi[..., h:], P.lo[..., h:]))
    return TF(P.hi[..., 0], P.lo[..., 0])


def run_v_reduce_eager(y0: CTF, co: DF32VGNLSECoeffs, n_steps: int,
                       save_every: int, coherent: float = 0.0,
                       nlp=None, f_r: float = 0.0, inv_w0: float = 0.0):
    """Eager reduce-mode solve for the CPU test lane (python loops)."""
    n_chunks = n_steps // save_every
    remainder = n_steps - n_chunks * save_every
    ok = _v_finite(y0)
    pk = _v_peak(y0)
    y = y0
    for _ in range(n_chunks):
        y_new = vssfm_steps_df32(y, co, save_every, unroll=True,
                                 coherent=coherent, nlp=nlp, f_r=f_r,
                                 inv_w0=inv_w0)
        ok = ok & _v_finite(y_new)
        y = ctf_freeze(ok[..., None], y_new, y)
        pk = tf_max(pk, _v_peak(y))
    if remainder > 0:
        y_new = vssfm_steps_df32(y, co, remainder, unroll=True,
                                 coherent=coherent, nlp=nlp, f_r=f_r,
                                 inv_w0=inv_w0)
        ok = ok & _v_finite(y_new)
    return pk, y, ok


@functools.lru_cache(maxsize=16)
def _df32_vgnlse_solver(n_steps: int, save_every: int,
                        coherent: float = 0.0, f_r: float = 0.0,
                        inv_w0: float = 0.0):
    """Jitted batched df32 vector SSFM reduce solve: ONE stacked
    (B, 4 + 8T + 1) f32 buffer [pk_hi (2) | pk_lo (2) | re_hi | re_lo |
    im_hi | im_lo (each (2T) flattened pol-major) | ok]."""
    n_chunks = n_steps // save_every
    remainder = n_steps - n_chunks * save_every

    def run(y0: CTF, co: DF32VGNLSECoeffs, nlp=None):
        ok0 = _v_finite(y0)

        def chunk(carry, _):
            y, pk, ok = carry
            y_new = vssfm_steps_df32(y, co, save_every, coherent=coherent,
                                     nlp=nlp, f_r=f_r, inv_w0=inv_w0)
            ok_new = ok & _v_finite(y_new)
            y_out = ctf_freeze(ok_new[..., None], y_new, y)
            pk = tf_max(pk, _v_peak(y_out))
            return (y_out, pk, ok_new), None

        carry = (y0, _v_peak(y0), ok0)
        if n_chunks > 0:
            carry, _ = lax.scan(chunk, carry, None, length=n_chunks)
        y, pk, ok = carry
        if remainder > 0:
            y_new = vssfm_steps_df32(y, co, remainder, coherent=coherent,
                                     nlp=nlp, f_r=f_r, inv_w0=inv_w0)
            ok = ok & _v_finite(y_new)
        B = y.re.hi.shape[0]
        flat = lambda a: a.reshape(B, -1)  # noqa: E731
        return jnp.concatenate(
            [pk.hi, pk.lo,
             flat(y.re.hi), flat(y.re.lo), flat(y.im.hi), flat(y.im.lo),
             ok.astype(jnp.float32)[:, None]], axis=1)

    return jax.jit(run)


@functools.lru_cache(maxsize=8)
def _df32_vgnlse_traj_solver(n_steps: int, save_every: int,
                             coherent: float = 0.0, f_r: float = 0.0,
                             inv_w0: float = 0.0):
    """Jitted trajectory-mode df32 vector SSFM: per-chunk saved states
    ``(ys (S, B, 2, 4T) f32 [re_hi | re_lo | im_hi | im_lo], ok (B,) i32)``
    -- rows exclude z=0 (the caller holds the input)."""
    n_chunks = n_steps // save_every
    remainder = n_steps - n_chunks * save_every

    def run(y0: CTF, co: DF32VGNLSECoeffs, nlp=None):
        ok0 = _v_finite(y0)

        def chunk(carry, _):
            y, ok = carry
            y_new = vssfm_steps_df32(y, co, save_every, coherent=coherent,
                                     nlp=nlp, f_r=f_r, inv_w0=inv_w0)
            ok_new = ok & _v_finite(y_new)
            y_out = ctf_freeze(ok_new[..., None], y_new, y)
            row = jnp.concatenate(
                [y_out.re.hi, y_out.re.lo, y_out.im.hi, y_out.im.lo],
                axis=-1)
            return (y_out, ok_new), row

        if n_chunks > 0:
            (y, ok), ys = lax.scan(chunk, (y0, ok0), None, length=n_chunks)
        else:
            y, ok = y0, ok0
            s = y0.re.hi.shape
            ys = jnp.zeros((0, s[0], 2, 4 * s[-1]), dtype=jnp.float32)
        if remainder > 0:
            y_new = vssfm_steps_df32(y, co, remainder, coherent=coherent,
                                     nlp=nlp, f_r=f_r, inv_w0=inv_w0)
            ok = ok & _v_finite(y_new)
        return ys, ok.astype(jnp.int32)

    return jax.jit(run)


def run_vgnlse_traj_df32(
    A0: np.ndarray,
    gamma,
    alpha,
    b_xpm,
    lin_phase,
    *,
    dz_m: float,
    n_steps: int,
    save_every: int,
    coherent: float = 0.0,
    nl=None,
):
    """Matched-tolerance trajectory solve for ``run_vgnlse_simulation``'s
    df32 tier: ``A0`` is (B, 2, T) c128; returns host ``(A_saved
    (S+1, B, 2, T) c128 incl. the z=0 row, ok (B,) bool)``.  ``nl`` (a
    host-f64 ``models.gnlse.NLTerms``) enables the generalized
    Raman/steepening operator (isotropic-Raman approximation)."""
    A0 = np.asarray(A0, dtype=np.complex128)
    B, _, T = A0.shape
    if T & (T - 1):
        raise ValueError(
            f"T={T} must be a power of two for the two-float FFT"
        )
    co = make_df32_vgnlse_coeffs(gamma, alpha, b_xpm, lin_phase,
                                 dz_m=float(dz_m), B=B, T=T)
    nlp, f_r, inv_w0 = (None, 0.0, 0.0) if nl is None else (
        make_df32_nl_planes(nl), float(nl.f_r), float(nl.inv_w0))
    solver = _df32_vgnlse_traj_solver(int(n_steps), int(save_every),
                                      float(coherent), f_r, inv_w0)
    args = (ctf_from_c128(A0), co) + (() if nlp is None else (nlp,))
    ys, ok = jax.block_until_ready(solver(*args))
    ys = np.asarray(ys, dtype=np.float64)
    A_saved = np.concatenate([
        A0[None],
        (ys[..., :T] + ys[..., T:2 * T])
        + 1j * (ys[..., 2 * T:3 * T] + ys[..., 3 * T:]),
    ], axis=0)
    return A_saved, np.asarray(ok).astype(bool)


def solve_vgnlse_batch_df32(
    A0: np.ndarray,
    gamma,
    alpha,
    b_xpm,
    lin_phase,
    *,
    dz_m: float,
    n_steps: int,
    save_every: int,
    mesh=None,
    coherent: float = 0.0,
    nl=None,
):
    """Batched matched-tolerance vector SSFM solve; per-meter f64 inputs.

    Contract mirrors ``models/vgnlse.solve_vgnlse_batch`` (fixed-step
    reduce mode): returns host ``(peak_max (B, 2) f64, A_last (B, 2, T)
    c128, ok (B,) bool)``.  T must be a power of two.  Pass ``mesh`` to
    shard the batch axis.  ``nl`` (a host-f64 ``models.gnlse.NLTerms``)
    enables the generalized Raman/steepening operator."""
    A0 = np.asarray(A0, dtype=np.complex128)
    if A0.ndim != 3 or A0.shape[1] != 2:
        raise ValueError(f"A0 must have shape (B, 2, T), got {A0.shape}")
    B, _, T = A0.shape
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

        ndev = int(np.prod(list(mesh.shape.values())))
        A0, n_orig = pad_batch(A0, ndev)
        B = A0.shape[0]
        g = np.asarray(gamma, dtype=np.float64)
        if g.ndim == 1:
            g, _ = pad_batch(g, ndev)
        al = np.asarray(alpha, dtype=np.float64)
        if al.ndim == 3 or al.ndim == 1:
            al, _ = pad_batch(np.broadcast_to(
                al, (n_orig, 2, T) if al.ndim == 3 else (n_orig,)), ndev)
        ph = np.asarray(lin_phase, dtype=np.float64)
        if ph.ndim == 3:
            ph, _ = pad_batch(ph, ndev)
        gamma, alpha, lin_phase = g, al, ph

    co = make_df32_vgnlse_coeffs(gamma, alpha, b_xpm, lin_phase,
                                 dz_m=float(dz_m), B=B, T=T)
    nlp, f_r, inv_w0 = (None, 0.0, 0.0) if nl is None else (
        make_df32_nl_planes(nl), float(nl.f_r), float(nl.inv_w0))
    if mesh is not None:
        sh_b = batch_sharding(mesh)
        sh_r = replicated_sharding(mesh)
        y0 = put_global_tree(
            jax.tree_util.tree_map(np.asarray, ctf_from_c128(A0)), sh_b)
        co = jax.tree_util.tree_map(
            lambda x: jax.device_put(
                np.asarray(x),
                sh_b if x.ndim and x.shape[0] == B else sh_r),
            co,
        )
        if nlp is not None:
            nlp = jax.tree_util.tree_map(
                lambda x: jax.device_put(np.asarray(x), sh_r), nlp)
    else:
        y0 = ctf_from_c128(A0)

    solver = _df32_vgnlse_solver(int(n_steps), int(save_every),
                                 float(coherent), f_r, inv_w0)
    args = (y0, co) + (() if nlp is None else (nlp,))
    out = jax.block_until_ready(solver(*args))
    if mesh is not None:
        out = fetch_global(out)
    out = np.asarray(out, dtype=np.float64)

    pk = out[:, 0:2] + out[:, 2:4]
    base = 4
    sz = 2 * T
    planes = [out[:, base + i * sz:base + (i + 1) * sz].reshape(-1, 2, T)
              for i in range(4)]
    ok = out[:, base + 4 * sz] > 0.0
    A_last = (planes[0] + planes[1]) + 1j * (planes[2] + planes[3])
    return pk[:n_orig], A_last[:n_orig], ok[:n_orig]
