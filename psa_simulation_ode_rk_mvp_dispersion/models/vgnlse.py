"""Vector (two-polarization) GNLSE: coupled NLSE and the Manakov limit.

Extends ``models/gnlse`` to a two-component field ``A(z, t) = (A_x, A_y)``
on the same periodic time window, realizing the polarization physics the
reference only gestures at (its stale test encodes polarization-averaged
Kerr factors, /root/reference/tests.py:256-269; the 4-wave model already
offers that averaging as a Kerr variant -- this model family propagates the
actual vector field).  In the co-moving frame:

    dA_x/dz = -alpha/2 A_x
              + i [ +dbeta0/2 + (dbeta1/2) omega + sum_{n>=2} beta_n omega^n/n! ] A_x
              + i gamma (|A_x|^2 + b |A_y|^2) A_x
    dA_y/dz =  (same with dbeta0, dbeta1 negated and x <-> y)

- ``b = 2/3``: the incoherent coupled NLSE of a linearly birefringent fiber
  (Agrawal ch. 6; the coherent four-wave term is averaged out by the
  birefringent phase mismatch).
- ``b = 1`` with ``gamma -> (8/9) gamma``: the Manakov equation (random
  birefringence averaged over the Poincare sphere) -- the integrable vector
  soliton limit.

Both nonlinearities leave |A_x|^2, |A_y|^2 invariant, so the nonlinear split
substep is an EXACT pair of phase rotations -- the vector solver runs in the
same cost class as the scalar Kerr path (the FFTs batch over the trailing
polarization x time axes).  Solver structure, save-decimation contract,
NaN-masking, (B, ...) batching, shard_map sharding, and f32/i32 jit
boundaries all mirror ``models/gnlse`` (which see for the design notes).

Oracles (tests/test_vgnlse.py): exact XPM phases on CW, reduction to the
scalar solver when one polarization is empty, the Manakov vector soliton
(shape-invariant at any polarization angle), exact group-velocity walk-off
by circular shift, and birefringent phase rotation.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional, Tuple

import jax
import numpy as np
import jax.numpy as jnp
from jax import lax

from ..config import SimulationConfig, validate_config, reject_multistep
from ..ops.dispersion import DispersionParams
from ..ops.integrators import rk4ip_step
from ..utils.packing import (
    complex_to_ri,
    ri_pack_host,
    ri_to_complex,
    ri_unpack_host,
)
from ..utils.precision import real_dtype, require_non_df32, validate_precision
from .gnlse import (NLTerms, TimeGrid, _adaptive_method, _lane_finite,
                    _split_reduce_pack, _ssfm_method)

XPM_LINEAR_BIREFRINGENT = 2.0 / 3.0
MANAKOV_GAMMA_FACTOR = 8.0 / 9.0


@dataclasses.dataclass(frozen=True)
class VGNLSECoeffs:
    """Per-instance vector-GNLSE coefficients.

    ``lin_phase`` is the omega-domain phase rate per polarization
    [(2, T) or (B, 2, T), rad/m] INCLUDING the birefringent +-dbeta0/2 and
    +-(dbeta1/2) omega terms; ``gamma`` [1/(W m)] is the effective Kerr
    coefficient (already scaled by 8/9 for Manakov); ``b_xpm`` the
    cross-phase coupling ratio; ``alpha`` [1/m] -- flat (scalar /
    per-instance (B,)) or FREQUENCY-RESOLVED on the fft-ordered grid
    ((2, T) / (B, 2, T); applied in the frequency domain alongside the
    dispersion phase).  Rank disambiguates: 1-D alpha is always
    per-instance; spectral alpha is always at least 2-D (a shared (T,)
    profile is normalized to (2, T) by :func:`make_vgnlse_coeffs`).

    ``coherent`` (STATIC pytree metadata) is the coherent four-wave
    polarization-coupling ratio c in ``i gamma c A_self* A_other^2``: 0
    for the incoherent models (exact-rotation nonlinear substep), 1/3 for
    the full isotropic Kerr tensor of a low-birefringence fiber (RK4
    substep; enables polarization instability).
    """

    gamma: jax.Array      # () or (B,)
    alpha: jax.Array      # () or (B,)
    b_xpm: jax.Array      # ()
    lin_phase: jax.Array  # (2, T) or (B, 2, T)
    coherent: float = 0.0  # static: selects the nonlinear substep at trace


jax.tree_util.register_dataclass(
    VGNLSECoeffs,
    data_fields=["gamma", "alpha", "b_xpm", "lin_phase"],
    meta_fields=["coherent"],
)


def make_vgnlse_coeffs(
    grid: TimeGrid,
    dispersion: Optional[DispersionParams] = None,
    *,
    gamma_W_m: float,
    alpha_1_m: float = 0.0,
    alpha_spec_1_m=None,
    dbeta0_1_m: float = 0.0,
    dbeta1_s_m: float = 0.0,
    coupling: str = "cnlse",
    max_order: Optional[int] = None,
    precision: str = "x64",
) -> VGNLSECoeffs:
    """Build :class:`VGNLSECoeffs`.

    ``coupling='cnlse'`` is the linearly birefringent incoherent model
    (b = 2/3, gamma as given); ``'manakov'`` the randomly birefringent limit
    (b = 1, gamma scaled by 8/9).  ``dbeta0_1_m``/``dbeta1_s_m`` are the
    full phase- and group-birefringence splittings (x gets +half, y -half).
    Orders 0 and 1 of ``dispersion`` are ignored (co-moving gauge, as in
    :func:`~.gnlse.make_gnlse_coeffs`).

    ``alpha_spec_1_m`` (optional) adds a frequency-dependent loss profile on
    top of the flat ``alpha_1_m``: ``(T,)`` on the fft-ordered
    ``grid.omega()`` frequencies (shared by both polarizations) or
    ``(2, T)`` for polarization-dependent loss (e.g. a polarizing fiber).
    """
    rdt = real_dtype(validate_precision(precision))
    coh = 0.0
    if coupling == "cnlse":
        b, g_eff = XPM_LINEAR_BIREFRINGENT, float(gamma_W_m)
    elif coupling == "isotropic":
        # full isotropic Kerr tensor (low-birefringence fiber): incoherent
        # b=2/3 PLUS the coherent four-wave term c=1/3 -- the
        # rotation-invariant nonlinearity (Agrawal ch. 6.1)
        b, g_eff, coh = XPM_LINEAR_BIREFRINGENT, float(gamma_W_m), 1.0 / 3.0
    elif coupling == "manakov":
        b, g_eff = 1.0, MANAKOV_GAMMA_FACTOR * float(gamma_W_m)
    else:
        raise ValueError(
            f"coupling must be 'cnlse', 'isotropic' or 'manakov', "
            f"got {coupling!r}"
        )
    om = grid.omega()
    common = np.zeros_like(om)
    if dispersion is not None:
        cf = np.asarray(dispersion.coeffs, dtype=np.float64)
        hi = len(cf) if max_order is None else min(len(cf), int(max_order) + 1)
        for n in range(2, hi):
            common = common + (cf[n] / math.factorial(n)) * om ** n
    bire = 0.5 * float(dbeta0_1_m) + 0.5 * float(dbeta1_s_m) * om
    phase = np.stack([common + bire, common - bire])
    if not np.all(np.isfinite(phase)):
        raise ValueError("dispersion phase must be finite on the grid")
    if alpha_spec_1_m is None:
        alpha_np = np.float64(alpha_1_m)
    else:
        sp = np.asarray(alpha_spec_1_m, dtype=np.float64)
        if sp.shape not in (om.shape, (2,) + om.shape):
            raise ValueError(
                f"alpha_spec_1_m must have shape {om.shape} or "
                f"{(2,) + om.shape} (the fft-ordered frequency grid, "
                f"optionally per polarization), got {sp.shape}"
            )
        if not np.all(np.isfinite(sp)):
            raise ValueError("alpha_spec_1_m must be finite")
        alpha_np = np.float64(alpha_1_m) + np.broadcast_to(sp, (2,) + om.shape)
    if validate_precision(precision) == "df32":
        # matched-tolerance tier: keep HOST f64 leaves for the exact
        # two-float split (ops/df32_vgnlse.py).  All couplings: incoherent
        # models get the exact two-float rotation, the coherent c-term
        # the two-float RK4 (ops/df32_vgnlse.v_nl_rk4_df32).
        return VGNLSECoeffs(
            gamma=np.float64(g_eff),
            alpha=alpha_np,
            b_xpm=np.float64(b),
            lin_phase=phase,
            coherent=coh,
        )
    return VGNLSECoeffs(
        gamma=jnp.asarray(g_eff, dtype=rdt),
        alpha=jnp.asarray(alpha_np, dtype=rdt),
        b_xpm=jnp.asarray(b, dtype=rdt),
        lin_phase=jnp.asarray(phase, dtype=rdt),
        coherent=coh,
    )


def polarized_pulse(A: np.ndarray, theta_rad: float,
                    phi_rad: float = 0.0) -> np.ndarray:
    """Split a scalar envelope (T,) onto the two polarization axes:
    ``(cos theta, sin theta e^{i phi}) A`` -> (2, T)."""
    A = np.asarray(A, dtype=np.complex128)
    jones = np.array(
        [np.cos(float(theta_rad)),
         np.sin(float(theta_rad)) * np.exp(1j * float(phi_rad))]
    )
    return jones[:, None] * A[None, :]


def manakov_soliton_peak_power(beta2_s2_m: float, gamma_W_m: float,
                               t0_s: float) -> float:
    """TOTAL peak power of the Manakov vector soliton:
    ``|beta2| / ((8/9) gamma T0^2)`` [W] (any polarization split)."""
    if beta2_s2_m >= 0:
        raise ValueError("solitons require anomalous dispersion (beta2 < 0)")
    return abs(float(beta2_s2_m)) / (
        MANAKOV_GAMMA_FACTOR * float(gamma_W_m) * float(t0_s) ** 2
    )


# ---------------------------------------------------------------------------
# Solver core (state (B, 2, T) complex; FFTs batch over (B, 2))
# ---------------------------------------------------------------------------

def _lin_factor_v(coeffs: VGNLSECoeffs, h, rdt):
    """``alpha`` rank rule (normalized by the public runners): rank >= 2 is
    a spectral (2, T) / (B, 2, T) loss profile used as-is; rank 1 is
    per-instance (B,) and gains the (pol, time) axes; rank 0 is flat."""
    al = jnp.asarray(coeffs.alpha, dtype=rdt)
    ph = jnp.asarray(coeffs.lin_phase, dtype=rdt)
    if al.ndim == 1:
        al = al[..., None, None]  # (B,) -> broadcast over (B, 2, T)
    decay = jnp.exp(-0.5 * al * h)
    ang = ph * h
    return lax.complex(decay * jnp.cos(ang), decay * jnp.sin(ang))


def _xpm_kerr_step(y, gamma, b, h):
    """Exact coupled rotation exp(i gamma (P_self + b P_other) h) per pol
    (both powers are invariants of the incoherent nonlinear flow)."""
    P = y.real * y.real + y.imag * y.imag            # (..., 2, T)
    P_other = jnp.flip(P, axis=-2)
    ang = gamma * (P + b * P_other) * h
    return y * lax.complex(jnp.cos(ang), jnp.sin(ang))


def _times_i_v(z):
    return lax.complex(-z.imag, z.real)


def _v_nl_rhs(y, gamma, b, c):
    """Full vector nonlinear operator
    N(A)_p = i gamma [ (P_p + b P_q) A_p + c A_p* A_q^2 ],  q = other pol
    (the c-term exchanges power pointwise between polarizations; the total
    |A_x|^2 + |A_y|^2 is conserved -- tests pin this)."""
    P = y.real * y.real + y.imag * y.imag
    P_other = jnp.flip(P, axis=-2)
    y_other = jnp.flip(y, axis=-2)
    coh = jnp.conj(y) * y_other * y_other
    return _times_i_v(gamma * ((P + b * P_other) * y + c * coh))


def _v_nl_rhs_gen(y, gamma, b, c, nl):
    """Generalized vector nonlinear operator with the delayed Raman
    response and self-steepening (isotropic-Raman approximation: the
    delayed response is a SCALAR acting on the total power P_x + P_y,
    the dominant parallel component h_a of silica's Raman tensor --
    Lin & Agrawal's vector SRS theory reduced to a single response):

        N(A)_p = i gamma (1 + (i/omega_0) d/dt) W_p,
        W_p = (1 - f_R) [ (P_p + b P_q) A_p + c A_p* A_q^2 ]
              + f_R A_p (h_R * (P_p + P_q)).

    With A_q = 0 this reduces EXACTLY to the scalar ``gnlse._nl_rhs``
    (the empty-pol parity test pins it).  Time-axis sign conventions
    (correlation form of the convolution, flipped shock derivative)
    follow the scalar operator -- see ``gnlse._nl_rhs``'s docstring."""
    P = y.real * y.real + y.imag * y.imag            # (..., 2, T)
    P_other = jnp.flip(P, axis=-2)
    y_other = jnp.flip(y, axis=-2)
    K = (P + b * P_other) * y
    if c != 0.0:
        K = K + c * (jnp.conj(y) * y_other * y_other)
    T = P.shape[-1]
    hl = T // 2 + 1
    HRc_half = lax.complex(nl.hr_re[..., :hl], -nl.hr_im[..., :hl]).astype(
        jnp.complex64 if y.dtype == jnp.complex64 else jnp.complex128
    )
    # total power on ONE row (both pols see the same scalar response --
    # half the transforms), broadcast back over the pol axis by R * y
    Pt = jnp.sum(P, axis=-2, keepdims=True)
    R = jnp.fft.irfft(HRc_half * jnp.fft.rfft(Pt, axis=-1), n=T, axis=-1)
    W = (1.0 - nl.f_r) * K + nl.f_r * (R * y)
    dWdt = jnp.fft.ifft(_times_i_v(nl.omega * jnp.fft.fft(W, axis=-1)),
                        axis=-1)
    return _times_i_v(gamma * (W - nl.inv_w0 * _times_i_v(dWdt)))


def _v_nl_substep(y, gamma, b, h, coherent, nl=None):
    """One nonlinear split substep: exact rotation for the incoherent
    models (coherent == 0, a trace-time constant), RK4 on the coherent
    operator or (``nl`` present) the generalized Raman/steepening
    operator otherwise."""
    if nl is None and coherent == 0.0:
        return _xpm_kerr_step(y, gamma, b, h)
    c = coherent
    rhs = (functools.partial(_v_nl_rhs_gen, nl=nl) if nl is not None
           else _v_nl_rhs)
    k1 = rhs(y, gamma, b, c)
    k2 = rhs(y + (0.5 * h) * k1, gamma, b, c)
    k3 = rhs(y + (0.5 * h) * k2, gamma, b, c)
    k4 = rhs(y + h * k3, gamma, b, c)
    return y + (h / 6.0) * (k1 + 2.0 * (k2 + k3) + k4)


def _chunk_stepper_v(k: int, coherent: float = 0.0):
    """k fused symmetric split steps over (B, 2, T) state."""

    def run(y, Lh, Lf, gamma, b, h, nl=None):
        if k == 0:
            return y
        y = jnp.fft.ifft(Lh * jnp.fft.fft(y, axis=-1), axis=-1)

        def body(carry, _):
            c = _v_nl_substep(carry, gamma, b, h, coherent, nl)
            c = jnp.fft.ifft(Lf * jnp.fft.fft(c, axis=-1), axis=-1)
            return c, None

        if k > 1:
            y, _ = lax.scan(body, y, None, length=k - 1)
        y = _v_nl_substep(y, gamma, b, h, coherent, nl)
        return jnp.fft.ifft(Lh * jnp.fft.fft(y, axis=-1), axis=-1)

    return run


def _chunk_stepper_v_rk4ip(k: int, coherent: float = 0.0):
    """k fused RK4IP steps over (B, 2, T) state -- the vector counterpart
    of ``gnlse._chunk_stepper_rk4ip`` (Hult 2007; O(dz^4) vs Strang's
    O(dz^2)).  Same ``run`` signature as :func:`_chunk_stepper_v`; only
    the half-step linear factor ``Lh`` is used."""

    def run(y, Lh, Lf, gamma, b, h, nl=None):
        if k == 0:
            return y

        def lin(a):
            return jnp.fft.ifft(Lh * jnp.fft.fft(a, axis=-1), axis=-1)

        def N(a):
            if nl is not None:
                return _v_nl_rhs_gen(a, gamma, b, coherent, nl)
            return _v_nl_rhs(a, gamma, b, coherent)

        def body(carry, _):
            return rk4ip_step(lin, N, carry, h), None

        y, _ = lax.scan(body, y, None, length=k)
        return y

    return run


_STEPPERS_V = {"strang": _chunk_stepper_v, "rk4ip": _chunk_stepper_v_rk4ip}


@functools.lru_cache(maxsize=64)
def _vgnlse_solver(n_steps: int, save_every: int, rdt_name: str,
                   reduce_mode: bool, method: str = "strang"):
    """Jitted batched vector SSFM over (B, 2, T, 2) packs.

    reduce_mode=True returns ONE stacked ``(B, 2 + 4T + 1)`` rdt buffer
    ``[peak_max (2 cols) | y_final flat | ok]`` (split with
    ``gnlse._split_reduce_pack(T'=2T)`` then reshaped); reduce_mode=False
    returns the trajectory tuple ``(y_saved (S+1, B, 2, T, 2), y_final,
    ok)``.
    """
    rdt = jnp.dtype(rdt_name)
    n_chunks = n_steps // save_every
    remainder = n_steps - n_chunks * save_every
    make_stepper = _STEPPERS_V[method]

    def peak(y):
        return jnp.max(y.real * y.real + y.imag * y.imag, axis=-1)  # (B, 2)

    def solve(y0_ri, coeffs: VGNLSECoeffs, dz, nl=None):
        from .gnlse import _cast_nl

        y0 = ri_to_complex(y0_ri)                    # (B, 2, T)
        h = jnp.asarray(dz, dtype=rdt)
        gamma = jnp.asarray(coeffs.gamma, dtype=rdt)
        if gamma.ndim:
            gamma = gamma[..., None, None]
        b = jnp.asarray(coeffs.b_xpm, dtype=rdt)
        nl = _cast_nl(nl, rdt)
        Lh = _lin_factor_v(coeffs, 0.5 * h, rdt)
        Lf = _lin_factor_v(coeffs, h, rdt)
        ok0 = _lane_finite(y0)
        stepper = make_stepper(save_every, coeffs.coherent)

        def chunk(carry, _):
            y, pk, ok = carry
            y_new = stepper(y, Lh, Lf, gamma, b, h, nl)
            ok_new = ok & _lane_finite(y_new)
            y_out = jnp.where(ok_new[..., None, None], y_new, y)
            pk = jnp.maximum(pk, peak(y_out))
            out = None if reduce_mode else complex_to_ri(y_out)
            return (y_out, pk, ok_new), out

        if n_chunks > 0:
            (y, pk, ok), ys = lax.scan(
                chunk, (y0, peak(y0), ok0), None, length=n_chunks
            )
        else:
            y, pk, ok = y0, peak(y0), ok0
            ys = None if reduce_mode else jnp.zeros(
                (0,) + y0.shape + (2,), dtype=rdt
            )
        # trailing partial steps: integrated (they can flip ok) but unsaved;
        # y_final stays at the last SAVED grid point in both modes (the
        # framework-wide saved-grid convention)
        if remainder > 0:
            y_new = make_stepper(remainder, coeffs.coherent)(
                y, Lh, Lf, gamma, b, h, nl)
            ok = ok & _lane_finite(y_new)
        y_final = complex_to_ri(y).astype(rdt)
        if reduce_mode:
            # ONE stacked output
            return jnp.concatenate(
                [pk.astype(rdt), y_final.reshape(y_final.shape[0], -1),
                 ok.astype(rdt)[:, None]], axis=1)
        first = jnp.concatenate([complex_to_ri(y0)[None], ys], axis=0)
        return first, y_final, ok.astype(jnp.int32)

    return jax.jit(solve)


# ---------------------------------------------------------------------------
# Adaptive split-step (integrator='rk45'): shares the scalar GNLSE's
# rank-generic step-doubling controller (models/gnlse._gnlse_advance_segment)
# ---------------------------------------------------------------------------

def _v_doubling_attempt(y, coeffs, gamma, b, hb, rdt, nl=None):
    """(coarse h step, fused fine h/2 pair) for the vector state -- the same
    structure as gnlse._doubling_attempt, incl. its round-5 sharing: ONE
    factor build (exp(L h/2) = exp(L h/4)^2 exactly) and a shared forward
    FFT between the coarse and fine first transforms."""
    def lfft(L, a):
        return jnp.fft.ifft(L * jnp.fft.fft(a, axis=-1), axis=-1)

    coh = coeffs.coherent
    Lf = _lin_factor_v(coeffs, 0.25 * hb, rdt)
    Lc = Lf * Lf
    fy = jnp.fft.fft(y, axis=-1)
    yc = lfft(Lc, _v_nl_substep(jnp.fft.ifft(Lc * fy, axis=-1), gamma, b,
                                hb, coh, nl))
    yf = _v_nl_substep(jnp.fft.ifft(Lf * fy, axis=-1), gamma, b, 0.5 * hb,
                       coh, nl)
    yf = _v_nl_substep(lfft(Lc, yf), gamma, b, 0.5 * hb, coh, nl)
    return yc, lfft(Lf, yf)


def _v_doubling_attempt_rk4ip(y, coeffs, gamma, b, hb, rdt, nl=None):
    """Vector step-doubling attempt on the RK4IP step
    (``integrator='rk4ip45'``) -- the (B, 2, T) counterpart of
    ``gnlse._doubling_attempt_rk4ip``; controller runs with order=4."""
    def lfft(L, a):
        return jnp.fft.ifft(L * jnp.fft.fft(a, axis=-1), axis=-1)

    coh = coeffs.coherent

    def N(a):
        if nl is not None:
            return _v_nl_rhs_gen(a, gamma, b, coh, nl)
        return _v_nl_rhs(a, gamma, b, coh)

    def ip_step(y, L, h, Ny):
        return rk4ip_step(lambda a: lfft(L, a), N, y, h, Ny)

    Lf = _lin_factor_v(coeffs, 0.25 * hb, rdt)
    Lc = Lf * Lf                               # exact square (round 5)
    Ny = N(y)
    yc = ip_step(y, Lc, hb, Ny)
    yf = ip_step(y, Lf, 0.5 * hb, Ny)
    yf = ip_step(yf, Lf, 0.5 * hb, N(yf))
    return yc, yf


_V_ADAPTIVE_ATTEMPTS = {
    "strang": (_v_doubling_attempt, 2),
    "rk4ip": (_v_doubling_attempt_rk4ip, 4),
}


@functools.lru_cache(maxsize=64)
def _vgnlse_adaptive_solver(rdt_name: str, rtol: float, atol: float,
                            max_steps: int, reduce_mode: bool,
                            method: str = "strang", has_tail: bool = False):
    """Adaptive vector SSFM over a save grid: (B, 2, T, 2) pack + (S+1,)
    grid.  reduce_mode=True returns ONE stacked ``(B, 2 + 4T + 3)`` buffer
    ``[peak_max | y_final flat | ok | n_accepted | n_rejected]``;
    reduce_mode=False the trajectory tuple.  ``method``: 'strang'
    (integrator='rk45') or 'rk4ip' (integrator='rk4ip45').

    ``has_tail`` realizes the save-decimation contract for the trailing
    ``n_steps % save_every`` partial span (same as the scalar solver): one
    extra unsaved segment ``[z_grid[-1], z_end]`` folds into
    ``ok``/``n_acc``/``n_rej`` ONLY."""
    from .gnlse import _gnlse_advance_segment

    rdt = jnp.dtype(rdt_name)
    attempt_fn, order = _V_ADAPTIVE_ATTEMPTS[method]

    def solve(y0_ri, coeffs: VGNLSECoeffs, z_grid, dt0, nl=None, z_end=None):
        from .gnlse import _cast_nl

        y0 = ri_to_complex(y0_ri)                    # (B, 2, T)
        gamma = jnp.asarray(coeffs.gamma, dtype=rdt)
        if gamma.ndim:
            gamma = gamma[..., None, None]
        b = jnp.asarray(coeffs.b_xpm, dtype=rdt)
        nl = _cast_nl(nl, rdt)
        B = y0.shape[0]
        ok0 = _lane_finite(y0)
        dt_init = jnp.full((B,), dt0, dtype=rdt)
        n0 = jnp.zeros((B,), jnp.int32)

        def attempt(y, hb):
            return attempt_fn(y, coeffs, gamma, b, hb, rdt, nl)

        def peak(y):
            return jnp.max(y.real * y.real + y.imag * y.imag, axis=-1)

        def seg(carry, z_pair):
            y, dt, ok, pk, na, nr = carry
            z_a, z_b = z_pair
            z = jnp.full((B,), z_a, dtype=rdt)
            y, _z, dt, ok, na_s, nr_s = _gnlse_advance_segment(
                y, z, dt, ok, z_a, z_b, attempt, rdt,
                rtol=rtol, atol=atol, max_steps=max_steps, order=order,
            )
            pk = jnp.maximum(pk, peak(y))
            out = None if reduce_mode else complex_to_ri(y)
            return (y, dt, ok, pk, na + na_s, nr + nr_s), out

        (y, dt, ok, pk, na, nr), ys = lax.scan(
            seg, (y0, dt_init, ok0, peak(y0), n0, n0),
            (z_grid[:-1], z_grid[1:]),
        )
        y_final = complex_to_ri(y).astype(rdt)
        if has_tail:
            z = jnp.full((B,), z_grid[-1], dtype=rdt)
            _yt, _zt, _dtt, ok, na_t, nr_t = _gnlse_advance_segment(
                y, z, dt, ok, z_grid[-1], z_end, attempt, rdt,
                rtol=rtol, atol=atol, max_steps=max_steps, order=order,
            )
            na = na + na_t
            nr = nr + nr_t
        if reduce_mode:
            # ONE stacked output
            return jnp.concatenate(
                [pk.astype(rdt), y_final.reshape(y_final.shape[0], -1),
                 ok.astype(rdt)[:, None], na.astype(rdt)[:, None],
                 nr.astype(rdt)[:, None]], axis=1)
        first = jnp.concatenate([complex_to_ri(y0)[None], ys], axis=0)
        return first, y_final, ok.astype(jnp.int32), na, nr

    return jax.jit(solve)


def _nl_replicated_spec():
    """Replicated shard_map spec for an NLTerms pytree (shared planes)."""
    from jax.sharding import PartitionSpec

    from .gnlse import NLTerms

    rep = PartitionSpec()
    return NLTerms(f_r=rep, inv_w0=rep, omega=rep, hr_re=rep, hr_im=rep)


@functools.lru_cache(maxsize=16)
def _vgnlse_adaptive_reduce_solver_sharded(rdt_name: str, rtol: float,
                                           atol: float, max_steps: int, mesh,
                                           coherent: float = 0.0,
                                           has_nl: bool = False,
                                           method: str = "strang",
                                           has_tail: bool = False):
    from jax.sharding import PartitionSpec

    inner = _vgnlse_adaptive_solver(rdt_name, rtol, atol, max_steps, True,
                                    method, has_tail)
    axes = tuple(mesh.axis_names)
    ax = axes if len(axes) > 1 else axes[0]
    # a leading-axis spec shards axis 0 and replicates the rest, so it
    # covers (B,) flat AND (B, 2, T) spectral alpha alike
    b = PartitionSpec(ax)
    return jax.jit(
        jax.shard_map(
            lambda y0, c, zg, dt0, ze, nl=None: inner(y0, c, zg, dt0, nl,
                                                      ze),
            mesh=mesh,
            in_specs=(
                PartitionSpec(ax, None, None, None),
                VGNLSECoeffs(gamma=b, alpha=b, b_xpm=PartitionSpec(),
                             lin_phase=PartitionSpec(ax, None, None),
                             coherent=coherent),
                PartitionSpec(), PartitionSpec(), PartitionSpec(),
            ) + ((_nl_replicated_spec(),) if has_nl else ()),
            out_specs=PartitionSpec(ax, None),
            check_vma=False,
        )
    )


@functools.lru_cache(maxsize=16)
def _vgnlse_reduce_solver_sharded(n_steps: int, save_every: int,
                                  rdt_name: str, mesh,
                                  coherent: float = 0.0,
                                  has_nl: bool = False,
                                  method: str = "strang"):
    from jax.sharding import PartitionSpec

    inner = _vgnlse_solver(n_steps, save_every, rdt_name, True, method)
    axes = tuple(mesh.axis_names)
    ax = axes if len(axes) > 1 else axes[0]
    # leading-axis spec: covers flat (B,) and spectral (B, 2, T) alpha alike
    b = PartitionSpec(ax)
    return jax.jit(
        jax.shard_map(
            lambda y0, c, dz, nl=None: inner(y0, c, dz, nl),
            mesh=mesh,
            in_specs=(
                PartitionSpec(ax, None, None, None),
                VGNLSECoeffs(gamma=b, alpha=b, b_xpm=PartitionSpec(),
                             lin_phase=PartitionSpec(ax, None, None),
                             coherent=coherent),
                PartitionSpec(),
            ) + ((_nl_replicated_spec(),) if has_nl else ()),
            out_specs=PartitionSpec(ax, None),
            check_vma=False,
        )
    )


# ---------------------------------------------------------------------------
# Public runners (contracts mirror models/gnlse)
# ---------------------------------------------------------------------------

def run_vgnlse_simulation(
    cfg: SimulationConfig,
    coeffs: VGNLSECoeffs,
    A0: np.ndarray,
    *,
    length_unit: str = "m",
    z0: float = 0.0,
    nl: Optional[NLTerms] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Integrate one vector envelope (2, T) over [z0, z0 + z_max]; returns
    host ``(z_saved, A_saved (S+1, 2, T))`` on the decimated save grid.
    Raises ``FloatingPointError`` on NaN/Inf when ``cfg.check_nan``.
    ``cfg.integrator='rk45'`` dispatches to the adaptive split-step (the
    scalar GNLSE's step-doubling controller) on the same save grid.
    ``nl`` (:func:`~.gnlse.make_nl_terms`, shared with the scalar family)
    enables the delayed Raman response + self-steepening in the
    isotropic-Raman approximation (the scalar response acts on the total
    power; see ``_v_nl_rhs_gen``).

    Checkpoint/resume: pass the last saved row as ``A0`` and its coordinate
    as ``z0`` (in ``length_unit``); the co-moving vector GNLSE is autonomous
    in z, so a resumed fixed-step run continues the uninterrupted trajectory
    bitwise from any saved grid point (rk45: to tolerance).  ``z0`` only
    offsets the returned z grid (contract mirrors
    :func:`~.gnlse.run_gnlse_simulation`)."""
    from ..utils.units import length_scale_to_m

    validate_config(cfg)
    reject_multistep(cfg, "the vector GNLSE solvers")
    scale = length_scale_to_m(length_unit)
    prec = validate_precision(cfg.precision)
    rdt = real_dtype(prec)
    z0 = float(z0)
    if not np.isfinite(z0):
        raise ValueError("z0 must be finite")

    A0 = np.asarray(A0, dtype=np.complex128)
    if A0.shape[:1] != (2,) or A0.ndim != 2:
        raise ValueError(f"A0 must be a (2, T) vector envelope, got {A0.shape}")
    if (np.ndim(coeffs.lin_phase) > 2 or np.ndim(coeffs.gamma) > 0
            or np.ndim(coeffs.alpha) not in (0, 2)):
        raise ValueError(
            "run_vgnlse_simulation takes unbatched coeffs (scalar or (2, T) "
            "spectral alpha, scalar gamma, (2, T) lin_phase); use "
            "solve_vgnlse_batch for batches"
        )
    dz_m = float(cfg.dz) * scale
    n_steps = int(round(float(cfg.z_max) * scale / dz_m))
    n_chunks = n_steps // int(cfg.save_every)

    if prec == "df32":
        # matched-tolerance two-float trajectory solve (ops/df32_vgnlse.py)
        if cfg.integrator.lower() != "rk4":
            raise ValueError(
                "precision='df32' vector-GNLSE solves are fixed-step rk4 "
                "(Strang) only (use x32 for rk45/rk4ip, or x64 on CPU)"
            )
        from ..utils.precision import require_f64_leaves

        require_f64_leaves(
            "vector-GNLSE df32", gamma=coeffs.gamma, alpha=coeffs.alpha,
            lin_phase=coeffs.lin_phase)
        from ..ops.df32_vgnlse import run_vgnlse_traj_df32

        A_saved, ok = run_vgnlse_traj_df32(
            A0[None], np.asarray(coeffs.gamma, dtype=float),
            np.asarray(coeffs.alpha, dtype=float),
            float(np.asarray(coeffs.b_xpm)),
            np.asarray(coeffs.lin_phase, dtype=float),
            dz_m=dz_m, n_steps=n_steps, save_every=int(cfg.save_every),
            coherent=float(coeffs.coherent), nl=nl,
        )
        if cfg.check_nan and not bool(ok[0]):
            raise FloatingPointError(
                "NaN or Inf detected during vector-GNLSE integration"
            )
        z = z0 + np.arange(n_chunks + 1, dtype=np.float64) * (
            int(cfg.save_every) * dz_m
        ) / scale
        return z, A_saved[:, 0]

    if cfg.integrator.lower() in ("rk45", "rk4ip45"):
        # trailing n_steps % save_every partial span integrated but unsaved
        # (folds into ok only -- the framework-wide decimation contract)
        remainder = n_steps - n_chunks * int(cfg.save_every)
        z_grid = np.arange(n_chunks + 1, dtype=np.float64) * (
            int(cfg.save_every) * dz_m
        )
        solver = _vgnlse_adaptive_solver(
            np.dtype(rdt).name, float(cfg.rtol), float(cfg.atol),
            int(cfg.max_steps), False, _adaptive_method(cfg), remainder > 0,
        )
        ys, yf, ok, _na, _nr = jax.block_until_ready(
            solver(ri_pack_host(A0[None], rdt), coeffs,
                   jnp.asarray(z_grid, dtype=rdt),
                   jnp.asarray(dz_m, dtype=rdt), nl,
                   jnp.asarray(n_steps * dz_m, dtype=rdt))
        )
        if cfg.check_nan and int(np.asarray(ok)[0]) == 0:
            raise FloatingPointError(
                "NaN/Inf or step-size underflow during adaptive "
                f"({cfg.integrator}) vector-GNLSE integration"
            )
        return z0 + z_grid / scale, ri_unpack_host(np.asarray(ys))[:, 0]

    solver = _vgnlse_solver(n_steps, int(cfg.save_every),
                            np.dtype(rdt).name, False, _ssfm_method(cfg))
    ys, yf, ok = jax.block_until_ready(
        solver(ri_pack_host(A0[None], rdt), coeffs,
               jnp.asarray(dz_m, dtype=rdt), nl)
    )
    if cfg.check_nan and int(np.asarray(ok)[0]) == 0:
        raise FloatingPointError(
            "NaN or Inf detected during vector-GNLSE integration"
        )
    z = z0 + np.arange(n_chunks + 1, dtype=np.float64) * (
        int(cfg.save_every) * dz_m
    ) / scale
    return z, ri_unpack_host(np.asarray(ys))[:, 0]


def solve_vgnlse_batch(
    cfg: SimulationConfig,
    coeffs: VGNLSECoeffs,
    A0: np.ndarray,
    *,
    length_unit: str = "m",
    mesh=None,
    nl: Optional[NLTerms] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Solve B independent vector envelopes (B, 2, T) in one XLA program
    (reduce mode).  Returns host ``(peak_max (B, 2), A_last (B, 2, T),
    ok (B,))`` -- per-polarization running peak power over saved samples and
    the field at the last saved grid point.  ``mesh`` shards the batch axis
    via ``shard_map`` (per-shard local FFTs).  ``cfg.integrator='rk45'``
    dispatches to the adaptive split-step (lockstep batched lanes; the
    reduction covers the same saved grid, integration stops at the last
    saved grid point).

    ``nl`` (:func:`~.gnlse.make_nl_terms`, shared with the scalar family)
    enables Raman + self-steepening in the isotropic-Raman approximation
    (see ``_v_nl_rhs_gen``).

    Checkpoint/resume: ``A_last`` is the restart state (autonomous
    equation) -- feed it back as ``A0`` to continue bitwise (fixed-step;
    rk45 to tolerance); combine segment peaks with ``np.maximum``."""
    from ..utils.units import length_scale_to_m

    validate_config(cfg)
    reject_multistep(cfg, "the vector GNLSE solvers")
    scale = length_scale_to_m(length_unit)
    prec = validate_precision(cfg.precision)

    A0 = np.asarray(A0, dtype=np.complex128)
    if A0.ndim != 3 or A0.shape[1] != 2:
        raise ValueError(f"A0 must have shape (B, 2, T), got {A0.shape}")
    B, _, T = A0.shape
    dz_m = float(cfg.dz) * scale
    n_steps = int(round(float(cfg.z_max) * scale / dz_m))

    if prec == "df32":
        # matched-tolerance two-float SSFM (ops/df32_vgnlse.py): exact
        # coupled rotation (incoherent) / two-float RK4 (coherent c-term)
        if cfg.integrator.lower() != "rk4":
            raise ValueError(
                "precision='df32' vector-GNLSE solves are fixed-step rk4 "
                "(Strang) only (use x32 for rk45/rk4ip, or x64 on CPU)"
            )
        from ..utils.precision import require_f64_leaves

        require_f64_leaves(
            "vector-GNLSE df32", gamma=coeffs.gamma, alpha=coeffs.alpha,
            lin_phase=coeffs.lin_phase)
        from ..ops.df32_vgnlse import solve_vgnlse_batch_df32

        return solve_vgnlse_batch_df32(
            A0, np.asarray(coeffs.gamma, dtype=float),
            np.asarray(coeffs.alpha, dtype=float),
            float(np.asarray(coeffs.b_xpm)),
            np.asarray(coeffs.lin_phase, dtype=float),
            dz_m=dz_m, n_steps=n_steps, save_every=int(cfg.save_every),
            mesh=mesh, coherent=float(coeffs.coherent), nl=nl,
        )
    rdt = real_dtype(require_non_df32(cfg.precision, family="vector-GNLSE split-step"))

    gamma = np.broadcast_to(np.asarray(coeffs.gamma, dtype=float), (B,))
    al = np.asarray(coeffs.alpha, dtype=float)
    # spectral alpha is always >= 2-D ((2, T) / (B, 2, T)); 1-D is
    # per-instance (B,) -- see VGNLSECoeffs
    if al.ndim >= 2:
        alpha = np.broadcast_to(al, (B, 2, T))
    else:
        alpha = np.broadcast_to(al, (B,))
    phase = np.broadcast_to(
        np.asarray(coeffs.lin_phase, dtype=float), (B, 2, T)
    )

    n_orig = B
    if mesh is not None:
        from ..parallel.mesh import pad_batch

        ndev = int(np.prod(list(mesh.shape.values())))
        A0, n_orig = pad_batch(A0, ndev)
        gamma, _ = pad_batch(gamma, ndev)
        alpha, _ = pad_batch(alpha, ndev)
        phase, _ = pad_batch(phase, ndev)

    y0_ri = ri_pack_host(A0, rdt)

    use_rk45 = cfg.integrator.lower() in ("rk45", "rk4ip45")
    if use_rk45:
        n_chunks = n_steps // int(cfg.save_every)
        rk45_tail = (n_steps - n_chunks * int(cfg.save_every)) > 0
        z_grid = jnp.asarray(
            np.arange(n_chunks + 1, dtype=np.float64)
            * (int(cfg.save_every) * dz_m),
            dtype=rdt,
        )
        dt0 = jnp.asarray(dz_m, dtype=rdt)
        z_end = jnp.asarray(n_steps * dz_m, dtype=rdt)

    if mesh is None:
        cof = VGNLSECoeffs(
            gamma=jnp.asarray(gamma, dtype=rdt),
            alpha=jnp.asarray(alpha, dtype=rdt),
            b_xpm=jnp.asarray(coeffs.b_xpm, dtype=rdt),
            lin_phase=jnp.asarray(phase, dtype=rdt),
            coherent=float(coeffs.coherent),
        )
        if use_rk45:
            solver = _vgnlse_adaptive_solver(
                np.dtype(rdt).name, float(cfg.rtol), float(cfg.atol),
                int(cfg.max_steps), True, _adaptive_method(cfg), rk45_tail,
            )
            out = jax.block_until_ready(
                solver(jnp.asarray(y0_ri), cof, z_grid, dt0, nl, z_end)
            )
            pk, y_ri, ok, _na, _nr = _split_reduce_pack(out, 2 * T,
                                                        counters=True)
        else:
            solver = _vgnlse_solver(n_steps, int(cfg.save_every),
                                    np.dtype(rdt).name, True,
                                    _ssfm_method(cfg))
            out = jax.block_until_ready(
                solver(jnp.asarray(y0_ri), cof,
                       jnp.asarray(dz_m, dtype=rdt), nl)
            )
            pk, y_ri, ok = _split_reduce_pack(out, 2 * T, counters=False)
        y_ri = y_ri.reshape(-1, 2, T, 2)
    else:
        from ..parallel.mesh import batch_sharding, fetch_global, put_global

        sh = batch_sharding(mesh)
        cof_dev = VGNLSECoeffs(
            gamma=put_global(np.asarray(gamma, dtype=rdt), sh),
            alpha=put_global(np.asarray(alpha, dtype=rdt), sh),
            b_xpm=jnp.asarray(coeffs.b_xpm, dtype=rdt),
            lin_phase=put_global(np.asarray(phase, dtype=rdt), sh),
            coherent=float(coeffs.coherent),
        )
        y0_dev = put_global(y0_ri, sh)
        nl_args = () if nl is None else (nl,)
        if use_rk45:
            solver = _vgnlse_adaptive_reduce_solver_sharded(
                np.dtype(rdt).name, float(cfg.rtol), float(cfg.atol),
                int(cfg.max_steps), mesh, float(coeffs.coherent),
                nl is not None, _adaptive_method(cfg), rk45_tail,
            )
            out = fetch_global(jax.block_until_ready(
                solver(y0_dev, cof_dev, z_grid, dt0, z_end, *nl_args)
            ))
            pk, y_ri, ok, _na, _nr = _split_reduce_pack(out, 2 * T,
                                                        counters=True)
        else:
            solver = _vgnlse_reduce_solver_sharded(
                n_steps, int(cfg.save_every), np.dtype(rdt).name, mesh,
                float(coeffs.coherent), nl is not None, _ssfm_method(cfg),
            )
            out = fetch_global(jax.block_until_ready(
                solver(y0_dev, cof_dev, jnp.asarray(dz_m, dtype=rdt),
                       *nl_args)
            ))
            pk, y_ri, ok = _split_reduce_pack(out, 2 * T, counters=False)
        y_ri = y_ri.reshape(-1, 2, T, 2)

    peak = np.asarray(pk, dtype=np.float64)[:n_orig]
    A_last = ri_unpack_host(np.asarray(y_ri))[:n_orig]
    return peak, A_last, np.asarray(ok)[:n_orig].astype(bool)


def solve_vgnlse_batch_trajectories(
    cfg: SimulationConfig,
    coeffs: VGNLSECoeffs,
    A0: np.ndarray,
    *,
    length_unit: str = "m",
    z0: float = 0.0,
    nl: Optional[NLTerms] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Batched solve returning full decimated trajectories
    ``(z (S+1,), A (B, S+1, 2, T) complex, ok (B,))`` (vector analog of
    ``gnlse.solve_gnlse_batch_trajectories``; unsharded -- trajectories are
    a moderate-B tool, use :func:`solve_vgnlse_batch` for large sweeps).
    ``nl`` enables Raman + self-steepening (isotropic-Raman approximation,
    see ``_v_nl_rhs_gen``)."""
    from ..utils.units import length_scale_to_m

    validate_config(cfg)
    reject_multistep(cfg, "the vector GNLSE solvers")
    scale = length_scale_to_m(length_unit)
    prec = validate_precision(cfg.precision)
    A0 = np.asarray(A0, dtype=np.complex128)
    if A0.ndim != 3 or A0.shape[1] != 2:
        raise ValueError(f"A0 must have shape (B, 2, T), got {A0.shape}")
    B, _, T = A0.shape
    dz_m = float(cfg.dz) * scale
    n_steps = int(round(float(cfg.z_max) * scale / dz_m))
    n_chunks = n_steps // int(cfg.save_every)

    if prec == "df32":
        # matched-tolerance two-float trajectory solve (ops/df32_vgnlse.py)
        if cfg.integrator.lower() != "rk4":
            raise ValueError(
                "precision='df32' vector-GNLSE solves are fixed-step rk4 "
                "(Strang) only (use x32 for rk45/rk4ip, or x64 on CPU)"
            )
        from ..utils.precision import require_f64_leaves

        require_f64_leaves(
            "vector-GNLSE df32", gamma=coeffs.gamma, alpha=coeffs.alpha,
            lin_phase=coeffs.lin_phase)
        from ..ops.df32_vgnlse import run_vgnlse_traj_df32

        A_saved, ok = run_vgnlse_traj_df32(
            A0, np.asarray(coeffs.gamma, dtype=float),
            np.asarray(coeffs.alpha, dtype=float),
            float(np.asarray(coeffs.b_xpm)),
            np.asarray(coeffs.lin_phase, dtype=float),
            dz_m=dz_m, n_steps=n_steps, save_every=int(cfg.save_every),
            coherent=float(coeffs.coherent), nl=nl,
        )
        zg = float(z0) + np.arange(n_chunks + 1, dtype=np.float64) * (
            int(cfg.save_every) * dz_m
        ) / scale
        return zg, np.swapaxes(A_saved, 0, 1), ok
    rdt = real_dtype(require_non_df32(cfg.precision,
                                      family="vector-GNLSE split-step"))

    al = np.asarray(coeffs.alpha, dtype=float)
    cof = VGNLSECoeffs(
        gamma=jnp.asarray(
            np.broadcast_to(np.asarray(coeffs.gamma, float), (B,)), dtype=rdt),
        # spectral alpha is always >= 2-D; 1-D is per-instance (B,)
        alpha=jnp.asarray(
            np.broadcast_to(al, (B, 2, T) if al.ndim >= 2 else (B,)),
            dtype=rdt),
        b_xpm=jnp.asarray(coeffs.b_xpm, dtype=rdt),
        lin_phase=jnp.asarray(
            np.broadcast_to(np.asarray(coeffs.lin_phase, float), (B, 2, T)),
            dtype=rdt),
        coherent=float(coeffs.coherent),
    )
    z = float(z0) + np.arange(n_chunks + 1, dtype=np.float64) * (
        int(cfg.save_every) * dz_m
    ) / scale
    y0_ri = ri_pack_host(A0, rdt)
    if cfg.integrator.lower() in ("rk45", "rk4ip45"):
        rk45_tail = (n_steps - n_chunks * int(cfg.save_every)) > 0
        z_grid = jnp.asarray(
            np.arange(n_chunks + 1, dtype=np.float64)
            * (int(cfg.save_every) * dz_m), dtype=rdt)
        solver = _vgnlse_adaptive_solver(
            np.dtype(rdt).name, float(cfg.rtol), float(cfg.atol),
            int(cfg.max_steps), False, _adaptive_method(cfg), rk45_tail,
        )
        ys, _yf, ok, _na, _nr = jax.block_until_ready(
            solver(jnp.asarray(y0_ri), cof, z_grid,
                   jnp.asarray(dz_m, dtype=rdt), nl,
                   jnp.asarray(n_steps * dz_m, dtype=rdt))
        )
    else:
        solver = _vgnlse_solver(n_steps, int(cfg.save_every),
                                np.dtype(rdt).name, False,
                                _ssfm_method(cfg))
        ys, _yf, ok = jax.block_until_ready(
            solver(jnp.asarray(y0_ri), cof, jnp.asarray(dz_m, dtype=rdt), nl)
        )
    A = ri_unpack_host(np.asarray(ys)).transpose(1, 0, 2, 3)
    return z, A, np.asarray(ok).astype(bool)


# ---------------------------------------------------------------------------
# Derived quantities
# ---------------------------------------------------------------------------

def stokes_parameters(A: np.ndarray) -> np.ndarray:
    """Time-resolved Stokes vector (S0, S1, S2, S3) of a (..., 2, T) field."""
    A = np.asarray(A)
    ax, ay = A[..., 0, :], A[..., 1, :]
    s0 = np.abs(ax) ** 2 + np.abs(ay) ** 2
    s1 = np.abs(ax) ** 2 - np.abs(ay) ** 2
    cross = ax * np.conj(ay)
    return np.stack([s0, s1, 2.0 * cross.real, -2.0 * cross.imag], axis=-2)


def degree_of_polarization(grid: TimeGrid, A: np.ndarray) -> np.ndarray:
    """Energy-weighted DOP of a (..., 2, T) field: |<(S1,S2,S3)>| / <S0>."""
    s = stokes_parameters(A)
    tot = s.sum(axis=-1) * grid.dt_s       # (..., 4)
    s0 = tot[..., 0]
    vec = np.sqrt((tot[..., 1:] ** 2).sum(axis=-1))
    return vec / np.maximum(s0, 1e-300)
