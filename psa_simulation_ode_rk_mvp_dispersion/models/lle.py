"""Lugiato-Lefever equation (LLE): driven-damped Kerr-cavity combs.

The mean-field model of a CW-pumped Kerr microresonator (or fiber ring
cavity) -- the driven, damped, detuned cousin of the GNLSE that the comb
(``models/nwave.py``) and pulse (``models/gnlse.py``) families already
cover.  In the standard normalization (photon-lifetime slow time ``t``,
fast time ``tau`` around the resonator; Coen & Erkintalo, Opt. Lett. 38,
1790 (2013); Chembo & Menyuk, PRA 87, 053852 (2013)):

    dpsi/dt = -(1 + i Delta) psi + i |psi|^2 psi + i phi_d(omega_hat) psi + F

with ``Delta`` the pump-resonance detuning (in half-linewidths), ``F`` the
(real, CW) normalized pump amplitude and ``phi_d(omega) = sum_{n>=2}
d_n omega^n / n!`` the cavity dispersion operator in the SAME sign
convention as the GNLSE family's ``lin_phase`` (``d2 < 0`` = anomalous,
bright solitons).  Physical units map onto this by measuring slow time in
photon lifetimes, field in nonlinear units and fast time in the ``d2``
normalization -- the equation itself is the universal object, so the
framework solves the normalized form; :func:`normalize_ring_cavity` maps
physical fiber-ring / microresonator parameters onto it (and back, via
the unit scales it returns).

Capability lineage: the reference stops at single-pass waveguide FWM
(/root/reference/simulation.py run_single_simulation; cascaded-comb
roadmap gesture in tests.py) -- the LLE is the resonator-closed version of
exactly that physics and reuses this framework's split-step machinery.

Design notes (same rules as ``models/gnlse.py``):

- The linear+drive step is EXACT and affine: in the frequency domain
  ``dA^/dt = Lam(omega) A^ + F^`` with ``F`` constant in tau, so only the
  DC bin is driven and the exact one-step update is
  ``A <- ifft(e^{Lam h} fft(A)) + F (e^{Lam0 h} - 1)/Lam0`` with
  ``Lam0 = Lam(0) = -(1 + i Delta)`` -- a constant (in tau) complex offset
  added in the time domain.  No inhomogeneous-term splitting error beyond
  the Strang commutator.
- Kerr substep is the exact rotation ``exp(i |psi|^2 h)``.
- ``integrator='rk4'`` is the Strang split (reference-parity slot name);
  ``'rk4ip'`` runs interaction-picture RK4 with the drive folded into the
  nonlinear operator ``N(a) = i |a|^2 a + F - (drive handled exactly by
  the IP change of frame applying only to the linear part)``.
- Detuning RAMPS (the experimental soliton-generation protocol: scan the
  laser across the resonance) cost nothing extra: the per-step linear
  factor is the fixed dispersion factor times the SCALAR phase
  ``e^{-i Delta_j h}``, recomputed per step from an i32 scan index.
- Batch axis = the detuning/pump scan (``solve_lle_batch`` /
  ``detuning_scan``), sharded over a device mesh via ``shard_map`` with
  per-shard local FFTs; jit boundaries move real/imag packs
  (``utils/packing.py``).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import jax
import numpy as np
import jax.numpy as jnp
from jax import lax

from ..config import SimulationConfig, validate_config
from ..ops.integrators import rk4ip_step
from ..utils.packing import (
    complex_to_ri,
    ri_pack_host,
    ri_to_complex,
    ri_unpack_host,
)
from ..utils.precision import real_dtype, require_non_df32, validate_precision
from .gnlse import TimeGrid, _finite_mask, _split_reduce_pack, _times_i


# ---------------------------------------------------------------------------
# Coefficients
# ---------------------------------------------------------------------------

@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class LLECoeffs:
    """Normalized LLE coefficients (broadcastable over a leading B axis).

    ``detuning`` and ``pump`` are the scan axes (scalar or (B,));
    ``lin_phase`` is the DISPERSION-ONLY frequency-domain phase rate
    ``phi_d(omega)`` on the fft-ordered grid ((T,) or (B, T)) -- the
    detuning is kept separate so ramps stay a scalar per-step phase.
    ``pump`` may be complex-valued via its (re, im) pair ``(pump_re,
    pump_im)`` -- a real CW pump has ``pump_im = 0``.
    """

    detuning: jax.Array   # () or (B,)
    pump_re: jax.Array    # () or (B,)
    pump_im: jax.Array    # () or (B,)
    lin_phase: jax.Array  # (T,) or (B, T)


def make_lle_coeffs(
    grid: TimeGrid,
    *,
    detuning,
    pump,
    d2: Optional[float] = None,
    dispersion_coeffs=None,
    precision: str = "x64",
) -> LLECoeffs:
    """Build :class:`LLECoeffs` on ``grid`` (fast-time window = one
    resonator round trip in normalized units).

    ``detuning`` (Delta) and ``pump`` (F, real or complex) broadcast over a
    leading batch axis.  Dispersion: either a bare ``d2`` (second order
    only; ``d2 < 0`` = anomalous) or explicit ``dispersion_coeffs``
    ``[d2, d3, ...]`` starting at order 2, combined as
    ``phi_d = sum d_n omega^n / n!`` like :func:`gnlse.make_gnlse_coeffs`.
    """
    import math

    prec = validate_precision(precision)
    om = grid.omega()
    phase = np.zeros_like(om)
    if d2 is not None and dispersion_coeffs is not None:
        raise ValueError("pass d2 OR dispersion_coeffs, not both")
    if d2 is not None:
        dispersion_coeffs = [float(d2)]
    if dispersion_coeffs is not None:
        for n, dn in enumerate(np.asarray(dispersion_coeffs, dtype=float),
                               start=2):
            phase = phase + (dn / math.factorial(n)) * om ** n
    if not np.all(np.isfinite(phase)):
        raise ValueError("dispersion phase must be finite on the grid")
    det = np.asarray(detuning, dtype=np.float64)
    F = np.asarray(pump, dtype=np.complex128)
    if det.ndim > 1 or F.ndim > 1:
        raise ValueError("detuning/pump must be scalar or (B,)")
    if prec == "df32":
        # matched-tolerance tier: keep HOST f64 leaves -- the two-float
        # engine (ops/df32_lle.py) splits them exactly on the host
        return LLECoeffs(
            detuning=det, pump_re=F.real.copy(), pump_im=F.imag.copy(),
            lin_phase=phase,
        )
    rdt = real_dtype(prec)
    return LLECoeffs(
        detuning=jnp.asarray(det, dtype=rdt),
        pump_re=jnp.asarray(F.real, dtype=rdt),
        pump_im=jnp.asarray(F.imag, dtype=rdt),
        lin_phase=jnp.asarray(phase, dtype=rdt),
    )


# ---------------------------------------------------------------------------
# Analytic CW (homogeneous) solutions -- oracles and seeds
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LLENormalization:
    """Normalized LLE parameters + the unit scales that map the solution
    back to a physical fiber-ring / microresonator cavity (host f64).

    The physical mean-field ring equation (Leo et al., Nat. Photon. 4,
    471 (2010); Coen & Erkintalo, Opt. Lett. 38, 1790 (2013))

        t_R dE/dt = [-alpha - i delta0 - i (beta2 L / 2) d^2/dtau_p^2
                     + i gamma L |E|^2] E + sqrt(theta) E_in

    maps onto the framework's normalized form via ``t' = alpha t / t_R``
    (slow time in photon lifetimes ``t_R/alpha``), ``tau = tau_p /
    tau_scale_s`` with ``tau_scale_s = sqrt(|beta2| L / alpha)``,
    ``psi = E / field_scale_sqrtW`` with ``field_scale_sqrtW =
    sqrt(alpha / (gamma L))``, ``Delta = delta0/alpha``,
    ``F = sqrt(gamma L theta P_in / alpha^3)`` and ``d2 = sign(beta2)``.
    """

    detuning: float           # Delta = delta0 / alpha
    pump: float               # F = sqrt(gamma L theta P_in / alpha^3)
    d2: float                 # sign(beta2): -1 anomalous, +1 normal
    photon_lifetime_s: float  # t_R / alpha (one unit of slow time)
    tau_scale_s: float        # sqrt(|beta2| L / alpha) (one unit of tau)
    field_scale_sqrtW: float  # sqrt(alpha / (gamma L)): E = psi * this


def normalize_ring_cavity(
    *,
    round_trip_length_m: float,
    t_roundtrip_s: float,
    gamma_W_m: float,
    beta2_s2_m: float,
    alpha_half_loss: float,
    coupling_theta: float,
    detuning_phase_rad: float,
    pump_power_W: float,
) -> LLENormalization:
    """Physical ring-cavity parameters -> :class:`LLENormalization`.

    ``alpha_half_loss`` is half the total round-trip power loss including
    the coupler (``alpha = (alpha_i L + theta) / 2``), ``coupling_theta``
    the input coupler power transmission, ``detuning_phase_rad`` the
    round-trip phase detuning ``delta0`` (positive = red-detuned in the
    soliton convention).  Consistency oracle: mapping the normalized cubic
    roots back to physical powers reproduces the physical bistability
    relation ``(alpha^2 + (delta0 - gamma L P)^2) P = theta P_in`` exactly
    (tests/test_lle.py)."""
    L = float(round_trip_length_m)
    a = float(alpha_half_loss)
    g = float(gamma_W_m)
    b2 = float(beta2_s2_m)
    th = float(coupling_theta)
    for name, v in (("round_trip_length_m", L), ("t_roundtrip_s",
                    float(t_roundtrip_s)), ("gamma_W_m", g),
                    ("alpha_half_loss", a), ("coupling_theta", th)):
        if not (v > 0.0 and np.isfinite(v)):
            raise ValueError(f"{name} must be positive and finite")
    if b2 == 0.0:
        raise ValueError("beta2_s2_m must be nonzero (sets the tau scale)")
    if float(pump_power_W) < 0.0:
        raise ValueError("pump_power_W must be >= 0")
    return LLENormalization(
        detuning=float(detuning_phase_rad) / a,
        pump=float(np.sqrt(g * L * th * float(pump_power_W) / a ** 3)),
        d2=float(np.sign(b2)),
        photon_lifetime_s=float(t_roundtrip_s) / a,
        tau_scale_s=float(np.sqrt(abs(b2) * L / a)),
        field_scale_sqrtW=float(np.sqrt(a / (g * L))),
    )


def cw_steady_states(detuning: float, pump: float) -> np.ndarray:
    """Intracavity powers ``rho = |psi_s|^2`` of the homogeneous steady
    states: real roots of ``rho^3 - 2 Delta rho^2 + (1 + Delta^2) rho =
    F^2`` (1 or 3 of them; bistable for ``Delta > sqrt(3)``).  Host f64."""
    d, f2 = float(detuning), float(pump) ** 2
    r = np.roots([1.0, -2.0 * d, 1.0 + d * d, -f2])
    r = r[np.abs(r.imag) < 1e-9 * np.maximum(1.0, np.abs(r.real))].real
    return np.sort(r[r >= 0.0])


def cw_state(detuning: float, pump: float, rho: float) -> complex:
    """The complex CW field ``psi_s = F / (1 + i (Delta - rho))`` on the
    branch with intracavity power ``rho`` (a root of
    :func:`cw_steady_states`)."""
    return complex(pump) / (1.0 + 1j * (float(detuning) - float(rho)))


def soliton_ansatz(grid: TimeGrid, detuning: float, pump: float,
                   d2: float, *, t0: float = 0.0) -> np.ndarray:
    """Approximate bright dissipative-soliton seed for ``Delta >> 1``
    (anomalous ``d2 < 0``): CW lower branch + ``sqrt(2 Delta)
    sech(sqrt(2 Delta / |d2|) (tau - t0)) e^{i phi0}``,
    ``cos phi0 = sqrt(8 Delta) / (pi F)`` (Herr et al., Nat. Photon. 8,
    145 (2014)).  A seed, not an exact solution -- propagate to converge."""
    if d2 >= 0:
        raise ValueError("bright solitons need anomalous dispersion (d2 < 0)")
    rho = cw_steady_states(detuning, pump)[0]
    psi0 = cw_state(detuning, pump, rho)
    arg = np.sqrt(8.0 * detuning) / (np.pi * pump)
    if not (0.0 < arg <= 1.0):
        raise ValueError(
            f"no soliton at detuning={detuning}, pump={pump}: "
            f"cos(phi0) = {arg:.3f} outside (0, 1]"
        )
    phi0 = np.arccos(arg)
    tau = grid.t()
    sech = 1.0 / np.cosh(np.sqrt(2.0 * detuning / abs(d2)) * (tau - t0))
    return psi0 + np.sqrt(2.0 * detuning) * sech * np.exp(1j * phi0)


def mi_gain_peak(detuning: float, rho: float) -> Tuple[float, float]:
    """Modulation-instability peak of a CW state with power ``rho``:
    returns ``(growth_rate, phi_d_at_peak)`` -- the MI growth rate
    ``rho - 1`` (positive above the universal ``rho = 1`` threshold) at
    the resonant sideband where ``phi_d(k) = 2 rho - Delta`` (reachable in
    anomalous dispersion when ``2 rho > Delta``)."""
    return float(rho) - 1.0, 2.0 * float(rho) - float(detuning)


# ---------------------------------------------------------------------------
# Steppers
# ---------------------------------------------------------------------------

def _lle_lin_factor(coeffs: LLECoeffs, h, rdt):
    """Dispersion+loss one-step factor ``exp((-1 + i phi_d) h)`` (detuning
    excluded -- applied as a scalar phase so ramps stay cheap)."""
    ph = jnp.asarray(coeffs.lin_phase, dtype=rdt)
    decay = jnp.exp(jnp.asarray(-h, dtype=rdt))
    ang = ph * h
    return lax.complex(decay * jnp.cos(ang), decay * jnp.sin(ang))


def _det_phase(det, h, rdt):
    """Scalar detuning factor ``exp(-i Delta h)`` (per-instance)."""
    ang = -jnp.asarray(det, dtype=rdt) * h
    return lax.complex(jnp.cos(ang), jnp.sin(ang))


def _drive_offset(coeffs: LLECoeffs, det, h, rdt):
    """Exact affine drive term ``F (e^{Lam0 h} - 1) / Lam0`` with
    ``Lam0 = -(1 + i Delta)`` -- the DC-bin response of the linear step."""
    one = jnp.asarray(1.0, rdt)
    lam0 = lax.complex(-one, -jnp.asarray(det, dtype=rdt) * one)
    F = lax.complex(jnp.asarray(coeffs.pump_re, dtype=rdt),
                    jnp.asarray(coeffs.pump_im, dtype=rdt))
    return F * (jnp.exp(lam0 * h) - 1.0) / lam0


def _kerr_rot(y, h):
    """Exact Kerr rotation ``exp(i |psi|^2 h)`` (unit gamma -- normalized)."""
    P = y.real * y.real + y.imag * y.imag
    ang = P * h
    return y * lax.complex(jnp.cos(ang), jnp.sin(ang))


def _bcast_tail(x, y):
    """Broadcast a per-instance () / (B,) leaf against the (.., T) state."""
    x = jnp.asarray(x)
    return x[..., None] if x.ndim else x


def _lle_chunk_strang(k: int):
    """k fused Strang steps: exact affine half linear, exact Kerr, then
    k-1 interior (Kerr, exact affine FULL linear) pairs, closing with the
    trailing half.  The half-step affine maps compose EXACTLY into the
    full-step map (the drive lives only in the DC bin and ``phi_d(0)=0``:
    ``M_h(M_h a + dF_h) + dF_h = M_{2h} a + dF_{2h}`` bin-by-bin), so the
    interior fusion — same trick as the GNLSE stepper — halves the FFT
    round trips per step (k+1 transforms instead of 2k)."""

    def run(y, Lh, det_ph_h, dF_h, Lf, det_ph_f, dF_f, h):
        # (Lh, det_ph_h, dF_h): dispersion+loss factor, per-instance scalar
        # detuning phase and exact drive offset for h/2; (Lf, det_ph_f,
        # dF_f): the same for the full step h.
        if k == 0:
            return y
        dp_h = _bcast_tail(det_ph_h, y)
        dF_hb = _bcast_tail(dF_h, y)
        dp_f = _bcast_tail(det_ph_f, y)
        dF_fb = _bcast_tail(dF_f, y)

        def lin_half(a):
            return jnp.fft.ifft(Lh * jnp.fft.fft(a, axis=-1), axis=-1) \
                * dp_h + dF_hb

        def lin_full(a):
            return jnp.fft.ifft(Lf * jnp.fft.fft(a, axis=-1), axis=-1) \
                * dp_f + dF_fb

        def body(carry, _):
            y = carry
            y = _kerr_rot(y, h)
            y = lin_full(y)
            return y, None

        y = lin_half(y)
        y, _ = lax.scan(body, y, None, length=k - 1)
        y = _kerr_rot(y, h)
        y = lin_half(y)
        return y

    return run


def _lle_chunk_rk4ip(k: int):
    """k fused RK4IP steps: the IP frame absorbs dispersion+loss+detuning
    (all linear); the nonlinear operator ``N(a) = i|a|^2 a + F`` carries
    the drive (Hult 2007 structure, O(h^4))."""

    def run(y, Lh, det_ph_h, dF_h, h, F):
        if k == 0:
            return y
        dp = _bcast_tail(det_ph_h, y)
        Fb = _bcast_tail(F, y)

        def lin(a):   # exp((D - 1 - i Delta) h/2), NO drive (it lives in N)
            return jnp.fft.ifft(Lh * jnp.fft.fft(a, axis=-1), axis=-1) * dp

        def N(a):
            P = a.real * a.real + a.imag * a.imag
            return _times_i(P * a) + Fb

        def body(carry, _):
            return rk4ip_step(lin, N, carry, h), None

        y, _ = lax.scan(body, y, None, length=k)
        return y

    return run


# ---------------------------------------------------------------------------
# Adaptive split-step (integrator='rk45'): step-doubling local-error control
# on the driven-damped Strang step -- the LLE realization of the GNLSE
# family's Sinkin controller (models/gnlse._gnlse_advance_segment is
# state-rank-generic and shared; only the attempt differs).
# ---------------------------------------------------------------------------

def _lle_affine_lin(ph, det_b, F_b, y, s, rdt):
    """Exact affine linear map for a per-lane step ``s`` (rank-matched
    ``(B, 1)``): frequency-domain multiply by ``exp((-1 + i ph) s)``, then
    the scalar detuning rotation ``exp(-i Delta s)`` and the exact drive
    offset ``F (e^{Lam0 s} - 1)/Lam0`` in the time domain (the per-lane-h
    generalization of ``_lle_lin_factor``/``_det_phase``/``_drive_offset``)."""
    decay = jnp.exp(-s)
    ang = ph * s
    L = lax.complex(decay * jnp.cos(ang), decay * jnp.sin(ang))
    angd = -det_b * s
    dp = lax.complex(jnp.cos(angd), jnp.sin(angd))
    lam0 = lax.complex(-jnp.ones_like(det_b), -det_b)
    dF = F_b * (jnp.exp(lam0 * s) - 1.0) / lam0
    return jnp.fft.ifft(L * jnp.fft.fft(y, axis=-1), axis=-1) * dp + dF


def _lle_doubling_attempt(y, ph, det_b, F_b, hb, rdt):
    """One step-doubling attempt on the LLE Strang step: (coarse h, two
    fused fine h/2 steps) -- the two middle fine quarter-linears compose
    EXACTLY into one half-step affine map (drive lives in the DC bin), the
    same fusion as the fixed-step chunk.

    Round-5 cost structure (VERDICT r4 #4): ONE transcendental (B, T)
    factor build per attempt -- the quarter-step dispersion factor; the
    half-step factor is its exact square (1-ulp class, far below the
    O(h^3) split error the controller measures) -- and the coarse/fine
    first transforms share one forward FFT.  9 FFTs + 1 plane build per
    attempt (was 10 + 5)."""
    half = 0.5 * hb
    quarter = 0.25 * hb
    decay_q = jnp.exp(-quarter)
    ang_q = ph * quarter
    Lq = lax.complex(decay_q * jnp.cos(ang_q), decay_q * jnp.sin(ang_q))
    Lh = Lq * Lq
    angd_q = -det_b * quarter
    dp_q = lax.complex(jnp.cos(angd_q), jnp.sin(angd_q))
    dp_h = dp_q * dp_q
    lam0 = lax.complex(-jnp.ones_like(det_b), -det_b)
    dF_q = F_b * (jnp.exp(lam0 * quarter) - 1.0) / lam0
    dF_h = F_b * (jnp.exp(lam0 * half) - 1.0) / lam0
    fy = jnp.fft.fft(y, axis=-1)          # shared forward transform

    def aff_h(F):
        return jnp.fft.ifft(Lh * F, axis=-1) * dp_h + dF_h

    def aff_q(F):
        return jnp.fft.ifft(Lq * F, axis=-1) * dp_q + dF_q

    yc = aff_h(jnp.fft.fft(_kerr_rot(aff_h(fy), hb), axis=-1))
    yf = _kerr_rot(aff_q(fy), half)
    yf = _kerr_rot(aff_h(jnp.fft.fft(yf, axis=-1)), half)
    yf = aff_q(jnp.fft.fft(yf, axis=-1))
    return yc, yf


def _lle_doubling_attempt_rk4ip(y, ph, det_b, F_b, hb, rdt):
    """Step-doubling attempt on the LLE RK4IP step (``integrator=
    'rk4ip45'``): the interaction picture absorbs dispersion + loss +
    detuning (all linear), the nonlinear operator ``N(a) = i|a|^2 a + F``
    carries the drive (the ``_lle_chunk_rk4ip`` structure, Hult 2007).
    Local error is O(h^5) -> controller ``order=4`` (exponent 1/5,
    Richardson 16/15), so equal tolerance costs ~tol^(2/15) fewer steps
    than the Strang doubling -- the expected equal-tolerance win of the
    rk4ip45 lanes (not yet measured on the H100).  One transcendental
    factor build: ``exp(L h/2) = exp(L h/4)^2`` exactly."""
    half = 0.5 * hb
    quarter = 0.25 * hb
    ang_q = (ph - det_b) * quarter
    decay_q = jnp.exp(-quarter)
    Lq = lax.complex(decay_q * jnp.cos(ang_q), decay_q * jnp.sin(ang_q))
    Lh = Lq * Lq

    def lin_h(a):
        return jnp.fft.ifft(Lh * jnp.fft.fft(a, axis=-1), axis=-1)

    def lin_q(a):
        return jnp.fft.ifft(Lq * jnp.fft.fft(a, axis=-1), axis=-1)

    def N(a):
        P = a.real * a.real + a.imag * a.imag
        return _times_i(P * a) + F_b

    Ny = N(y)
    yc = rk4ip_step(lin_h, N, y, hb, Ny)
    yf = rk4ip_step(lin_q, N, y, half, Ny)
    yf = rk4ip_step(lin_q, N, yf, half, N(yf))
    return yc, yf


@functools.lru_cache(maxsize=32)
def _lle_adaptive_solver(rdt_name: str, rtol: float, atol: float,
                         max_steps: int, reduce_mode: bool,
                         has_tail: bool = False, method: str = "strang"):
    """Jitted adaptive LLE evolution over a save grid (same contracts as
    ``gnlse._gnlse_adaptive_solver``: reduce mode returns ONE stacked
    ``(B, 1 + 2T + 3)`` buffer ``[peak | psi_final | ok | n_acc | n_rej]``,
    trajectory mode the ``(y_saved, y_final, ok, na, nr)`` tuple).

    ``has_tail`` realizes the framework-wide save-decimation contract for
    trailing ``n_steps % save_every`` partial steps: one extra unsaved
    segment ``[t_grid[-1], t_end]`` is integrated after the save grid and
    folded into ``ok``/``n_acc``/``n_rej`` ONLY — the saved trajectory,
    ``psi_final`` and ``peak`` stay at the last saved point, exactly like
    the fixed-step ``_lle_solver`` remainder block."""
    from .gnlse import _gnlse_advance_segment

    rdt = jnp.dtype(rdt_name)
    order = 4 if method == "rk4ip" else 2

    def solve(y0_ri, coeffs: LLECoeffs, t_grid, dt0, t_end):
        y0 = ri_to_complex(y0_ri)                      # (B, T)
        det = jnp.asarray(coeffs.detuning, dtype=rdt)
        det_b = _bcast_tail(det, y0)
        F_b = _bcast_tail(
            lax.complex(jnp.asarray(coeffs.pump_re, dtype=rdt),
                        jnp.asarray(coeffs.pump_im, dtype=rdt)), y0)
        ph = jnp.asarray(coeffs.lin_phase, dtype=rdt)
        B = y0.shape[0]
        ok0 = _finite_mask(y0)
        dt_init = jnp.full((B,), dt0, dtype=rdt)
        n0 = jnp.zeros((B,), jnp.int32)

        if method == "rk4ip":
            def attempt(y, hb):
                return _lle_doubling_attempt_rk4ip(y, ph, det_b, F_b, hb,
                                                   rdt)
        else:
            def attempt(y, hb):
                return _lle_doubling_attempt(y, ph, det_b, F_b, hb, rdt)

        def peak(y):
            return jnp.max(y.real * y.real + y.imag * y.imag, axis=-1)

        def seg(carry, t_pair):
            y, dt, ok, pk, na, nr = carry
            t_a, t_b = t_pair
            t = jnp.full((B,), t_a, dtype=rdt)
            y, _t, dt, ok, na_s, nr_s = _gnlse_advance_segment(
                y, t, dt, ok, t_a, t_b, attempt, rdt,
                rtol=rtol, atol=atol, max_steps=max_steps, order=order,
            )
            pk = jnp.maximum(pk, peak(y))
            out = None if reduce_mode else complex_to_ri(y)
            return (y, dt, ok, pk, na + na_s, nr + nr_s), out

        (y, dt, ok, pk, na, nr), ys = lax.scan(
            seg, (y0, dt_init, ok0, peak(y0), n0, n0),
            (t_grid[:-1], t_grid[1:]),
        )
        y_final = complex_to_ri(y).astype(rdt)
        if has_tail:
            t = jnp.full((B,), t_grid[-1], dtype=rdt)
            _yt, _tt, _dtt, ok, na_t, nr_t = _gnlse_advance_segment(
                y, t, dt, ok, t_grid[-1], t_end, attempt, rdt,
                rtol=rtol, atol=atol, max_steps=max_steps, order=order,
            )
            na = na + na_t
            nr = nr + nr_t
        if reduce_mode:
            return jnp.concatenate(
                [pk.astype(rdt)[:, None],
                 y_final.reshape(y_final.shape[0], -1),
                 ok.astype(rdt)[:, None], na.astype(rdt)[:, None],
                 nr.astype(rdt)[:, None]], axis=1)
        first = jnp.concatenate([complex_to_ri(y0)[None], ys], axis=0)
        return first, y_final, ok.astype(jnp.int32), na, nr

    return jax.jit(solve)


@functools.lru_cache(maxsize=16)
def _lle_adaptive_reduce_solver_sharded(rdt_name: str, rtol: float,
                                        atol: float, max_steps: int, mesh,
                                        phase_rank: int,
                                        has_tail: bool = False,
                                        method: str = "strang"):
    """shard_map wrapper of the adaptive reduce-mode solver (batch axis
    over the mesh; the save grid is replicated)."""
    from jax.sharding import PartitionSpec

    inner = _lle_adaptive_solver(rdt_name, rtol, atol, max_steps, True,
                                 has_tail, method)
    axes = tuple(mesh.axis_names)
    ax = axes if len(axes) > 1 else axes[0]
    b = PartitionSpec(ax)
    spec = LLECoeffs(
        detuning=b, pump_re=b, pump_im=b,
        lin_phase=(PartitionSpec(ax, None) if phase_rank == 2
                   else PartitionSpec()),
    )
    return jax.jit(
        jax.shard_map(
            lambda y0, c, tg, dt0, te: inner(y0, c, tg, dt0, te),
            mesh=mesh,
            in_specs=(PartitionSpec(ax, None, None), spec, PartitionSpec(),
                      PartitionSpec(), PartitionSpec()),
            out_specs=PartitionSpec(ax, None),
            check_vma=False,
        )
    )


# ---------------------------------------------------------------------------
# Solvers
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=64)
def _lle_solver(n_steps: int, save_every: int, rdt_name: str, method: str,
                reduce_mode: bool):
    """Jitted batched LLE evolution: (B, T, 2) pack -> trajectory or ONE
    stacked reduce buffer ``(B, 1 + 2T + 1)`` ``[peak | psi_last | ok]``
    (same contracts as the GNLSE solvers; NaN lanes freeze at chunk
    boundaries)."""
    rdt = jnp.dtype(rdt_name)
    n_chunks = n_steps // save_every
    remainder = n_steps - n_chunks * save_every

    def solve(y0_ri, coeffs: LLECoeffs, dt):
        y0 = ri_to_complex(y0_ri)           # (B, T)
        h = jnp.asarray(dt, dtype=rdt)
        det = jnp.asarray(coeffs.detuning, dtype=rdt)
        Lh = _lle_lin_factor(coeffs, 0.5 * h, rdt)
        dp_h = _det_phase(det, 0.5 * h, rdt)
        dF_h = _drive_offset(coeffs, det, 0.5 * h, rdt)
        F = lax.complex(jnp.asarray(coeffs.pump_re, dtype=rdt),
                        jnp.asarray(coeffs.pump_im, dtype=rdt))
        ok0 = _finite_mask(y0)
        if method == "rk4ip":
            stepper = _lle_chunk_rk4ip(save_every)
            args = (Lh, dp_h, dF_h, h, F)
            rem_args = args
            rem_stepper = _lle_chunk_rk4ip(remainder)
        else:
            Lf = _lle_lin_factor(coeffs, h, rdt)
            dp_f = _det_phase(det, h, rdt)
            dF_f = _drive_offset(coeffs, det, h, rdt)
            stepper = _lle_chunk_strang(save_every)
            args = (Lh, dp_h, dF_h, Lf, dp_f, dF_f, h)
            rem_args = args
            rem_stepper = _lle_chunk_strang(remainder)

        def peak(y):
            return jnp.max(y.real * y.real + y.imag * y.imag, axis=-1)

        def chunk(carry, _):
            y, pk, ok = carry
            y_new = stepper(y, *args)
            ok_new = ok & _finite_mask(y_new)
            keep = ok_new[:, None]
            y_out = jnp.where(keep, y_new, y)
            pk = jnp.maximum(pk, peak(y_out))
            out = None if reduce_mode else complex_to_ri(y_out).astype(rdt)
            return (y_out, pk, ok_new), out

        (y, pk, ok), ys = lax.scan(
            chunk, (y0, peak(y0), ok0), None, length=n_chunks)
        if remainder > 0:
            y_new = rem_stepper(y, *rem_args)
            ok = ok & _finite_mask(y_new)
        y_ri = complex_to_ri(y).astype(rdt)
        if reduce_mode:
            return jnp.concatenate(
                [pk.astype(rdt)[:, None], y_ri.reshape(y_ri.shape[0], -1),
                 ok.astype(rdt)[:, None]], axis=1)
        first = complex_to_ri(y0).astype(rdt)[None]
        ys = first if n_chunks == 0 else jnp.concatenate([first, ys], axis=0)
        return ys, ok.astype(jnp.int32)

    return jax.jit(solve)


@functools.lru_cache(maxsize=16)
def _lle_ramp_solver(n_steps: int, save_every: int, rdt_name: str):
    """Detuning-ramp evolution (Strang): ``Delta_j = start + j (end -
    start)/n_steps`` recomputed per step from the i32 index -- the
    dispersion factor is fixed, only the scalar detuning phase and the
    drive offset change.  Returns the saved trajectory + the saved
    detuning grid (host-reconstructable, but returned for convenience)
    + ok.  Trailing ``n_steps % save_every`` partial steps are integrated
    but unsaved (the framework-wide save-decimation contract), so the ramp
    always reaches ``detuning_end`` and NaNs there still flip ``ok``."""
    rdt = jnp.dtype(rdt_name)
    n_chunks = n_steps // save_every
    remainder = n_steps - n_chunks * save_every

    def solve(y0_ri, coeffs: LLECoeffs, dt, det_start, det_step, step0):
        # ``step0`` (i32) is the GLOBAL index of the first step -- a ramp
        # resume passes the original schedule's (det_start, det_step)
        # unchanged plus the restart step, so the per-step detunings
        # ``det_start + det_step * (step0 + j)`` are BITWISE those of the
        # uninterrupted run (SURVEY §5 checkpoint/resume).
        y0 = ri_to_complex(y0_ri)
        h = jnp.asarray(dt, dtype=rdt)
        Lh = _lle_lin_factor(coeffs, 0.5 * h, rdt)
        F = lax.complex(jnp.asarray(coeffs.pump_re, dtype=rdt),
                        jnp.asarray(coeffs.pump_im, dtype=rdt))
        ok0 = _finite_mask(y0)

        def step(carry, j):
            y, ok = carry
            det = det_start + det_step * j.astype(rdt)
            dp = _det_phase(det, 0.5 * h, rdt)
            one = jnp.asarray(1.0, rdt)
            lam0 = lax.complex(-one, -det * one)
            dF = F * (jnp.exp(lam0 * (0.5 * h)) - 1.0) / lam0

            def lin_half(a):
                return jnp.fft.ifft(Lh * jnp.fft.fft(a, axis=-1),
                                    axis=-1) * dp + dF

            y_new = lin_half(_kerr_rot(lin_half(y), h))
            ok_new = ok & _finite_mask(y_new)
            y_out = jnp.where(ok_new[:, None], y_new, y)
            return (y_out, ok_new), None

        def chunk(carry, c):
            j0 = step0 + c * jnp.int32(save_every)
            carry, _ = lax.scan(
                step, carry, j0 + jnp.arange(save_every, dtype=jnp.int32))
            y, ok = carry
            return carry, complex_to_ri(y).astype(rdt)

        (y, ok), ys = lax.scan(
            chunk, (y0, ok0), jnp.arange(n_chunks, dtype=jnp.int32))
        if remainder > 0:
            j0 = step0 + jnp.int32(n_chunks * save_every)
            (y, ok), _ = lax.scan(
                step, (y, ok),
                j0 + jnp.arange(remainder, dtype=jnp.int32))
        first = complex_to_ri(y0).astype(rdt)[None]
        ys = first if n_chunks == 0 else jnp.concatenate([first, ys], axis=0)
        return ys, ok.astype(jnp.int32)

    return jax.jit(solve)


@functools.lru_cache(maxsize=16)
def _lle_reduce_solver_sharded(n_steps: int, save_every: int, rdt_name: str,
                               mesh, method: str, phase_rank: int):
    """shard_map wrapper of the reduce-mode solver (batch axis over the
    mesh; per-shard local FFTs)."""
    from jax.sharding import PartitionSpec

    inner = _lle_solver(n_steps, save_every, rdt_name, method, True)
    axes = tuple(mesh.axis_names)
    ax = axes if len(axes) > 1 else axes[0]
    b = PartitionSpec(ax)
    spec = LLECoeffs(
        detuning=b, pump_re=b, pump_im=b,
        lin_phase=(PartitionSpec(ax, None) if phase_rank == 2
                   else PartitionSpec()),
    )
    return jax.jit(
        jax.shard_map(
            lambda y0, c, dt: inner(y0, c, dt),
            mesh=mesh,
            in_specs=(PartitionSpec(ax, None, None), spec, PartitionSpec()),
            out_specs=PartitionSpec(ax, None),
            check_vma=False,
        )
    )


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------

def _lle_method(cfg: SimulationConfig) -> str:
    integ = cfg.integrator.lower()
    if integ == "rk4":
        return "strang"
    if integ == "rk4ip":
        return "rk4ip"
    if integ == "rk45":
        return "rk45"
    if integ == "rk4ip45":
        return "rk4ip45"
    raise ValueError(
        f"integrator={cfg.integrator!r} is not supported by the LLE solvers; "
        "use 'rk4' (Strang split, exact affine drive), 'rk4ip' "
        "(interaction-picture RK4), 'rk45' (adaptive step-doubling Strang) "
        "or 'rk4ip45' (adaptive step-doubling RK4IP)"
    )


def _lle_adaptive_family(method: str) -> str:
    """'rk45' -> 'strang' doubling, 'rk4ip45' -> 'rk4ip' doubling."""
    return "rk4ip" if method == "rk4ip45" else "strang"


def _lle_df32_args(cfg, coeffs: LLECoeffs, method: str):
    """Validate + unpack the matched-tolerance tier: Strang only, host f64
    coefficient leaves required (``make_lle_coeffs(precision='df32')``)."""
    from ..utils.precision import require_f64_leaves

    if method != "strang":
        raise ValueError(
            "precision='df32' LLE solves are fixed-step Strang "
            "(integrator='rk4') only (use x32/x64 for rk4ip/rk45/rk4ip45)"
        )
    require_f64_leaves(
        "LLE df32", detuning=coeffs.detuning, pump_re=coeffs.pump_re,
        pump_im=coeffs.pump_im, lin_phase=coeffs.lin_phase)
    det = np.asarray(coeffs.detuning, dtype=np.float64)
    F = (np.asarray(coeffs.pump_re, dtype=np.float64)
         + 1j * np.asarray(coeffs.pump_im, dtype=np.float64))
    ph = np.asarray(coeffs.lin_phase, dtype=np.float64)
    return det, F, ph


def _lle_df32_traj(cfg, coeffs: LLECoeffs, psi0: np.ndarray, method: str):
    from ..ops.df32_lle import run_lle_traj_df32

    det, F, ph = _lle_df32_args(cfg, coeffs, method)
    dt = float(cfg.dz)
    return run_lle_traj_df32(
        psi0, det, F, ph, dt=dt,
        n_steps=int(round(float(cfg.z_max) / dt)),
        save_every=int(cfg.save_every),
    )


def _norm_batch(coeffs: LLECoeffs, B: int, T: int, rdt):
    det = np.broadcast_to(np.asarray(coeffs.detuning, dtype=float), (B,))
    fr = np.broadcast_to(np.asarray(coeffs.pump_re, dtype=float), (B,))
    fi = np.broadcast_to(np.asarray(coeffs.pump_im, dtype=float), (B,))
    ph = np.broadcast_to(np.asarray(coeffs.lin_phase, dtype=float), (B, T))
    return det, fr, fi, ph


def run_lle_simulation(
    cfg: SimulationConfig,
    coeffs: LLECoeffs,
    psi0: np.ndarray,
    *,
    t0: float = 0.0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Evolve one intracavity field over ``[t0, t0 + z_max]`` photon
    lifetimes of slow time (``cfg.dz`` = slow-time step, ``cfg.save_every``
    decimation; the config's z slot IS the LLE slow time -- normalized
    units).  Returns host ``(t_saved, psi_saved (S+1, T))``.

    ``t0`` supports checkpoint/resume (SURVEY §5): the fixed-detuning LLE
    is autonomous, so ``t0`` only offsets the returned time grid -- pass
    the last saved row as ``psi0`` and its coordinate as ``t0`` to
    continue, with BITWISE restart parity on the fixed-step methods (same
    contract as ``gnlse.run_gnlse_simulation(z0=)``; a detuning RAMP is
    not autonomous -- resume those via ``run_lle_ramp(t0=)``).

    Raises ``FloatingPointError`` on NaN/Inf when ``cfg.check_nan``
    (eager single-run parity with the other families)."""
    validate_config(cfg)
    method = _lle_method(cfg)
    psi0 = np.asarray(psi0, dtype=np.complex128)
    if psi0.ndim != 1:
        raise ValueError(f"psi0 must be a 1-D field (T,), got {psi0.shape}")
    t0 = float(t0)
    if not np.isfinite(t0):
        raise ValueError("t0 must be finite")
    dt = float(cfg.dz)
    n_steps = int(round(float(cfg.z_max) / dt))
    n_chunks = n_steps // int(cfg.save_every)
    t = t0 + np.arange(n_chunks + 1, dtype=np.float64) * (
        int(cfg.save_every) * dt)
    if validate_precision(cfg.precision) == "df32":
        psi_saved, ok = _lle_df32_traj(cfg, coeffs, psi0[None], method)
        if cfg.check_nan and not bool(ok[0]):
            raise FloatingPointError(
                "NaN or Inf detected during LLE evolution")
        return t, psi_saved[:, 0, :]
    rdt = real_dtype(cfg.precision)
    if method in ("rk45", "rk4ip45"):
        remainder = n_steps - n_chunks * int(cfg.save_every)
        solver = _lle_adaptive_solver(
            np.dtype(rdt).name, float(cfg.rtol), float(cfg.atol),
            int(cfg.max_steps), False, remainder > 0,
            _lle_adaptive_family(method))
        ys, _yf, ok, _na, _nr = jax.block_until_ready(
            solver(ri_pack_host(psi0[None], rdt), coeffs,
                   jnp.asarray(t, dtype=rdt), jnp.asarray(dt, dtype=rdt),
                   jnp.asarray(n_steps * dt, dtype=rdt))
        )
        if cfg.check_nan and int(np.asarray(ok)[0]) == 0:
            raise FloatingPointError(
                "NaN/Inf or step-size underflow during adaptive (rk45) "
                "LLE evolution"
            )
        return t, ri_unpack_host(np.asarray(ys))[:, 0, :]
    solver = _lle_solver(n_steps, int(cfg.save_every), np.dtype(rdt).name,
                         method, False)
    ys, ok = jax.block_until_ready(
        solver(ri_pack_host(psi0[None], rdt), coeffs,
               jnp.asarray(dt, dtype=rdt))
    )
    if cfg.check_nan and int(np.asarray(ok)[0]) == 0:
        raise FloatingPointError("NaN or Inf detected during LLE evolution")
    return t, ri_unpack_host(np.asarray(ys))[:, 0, :]


def solve_lle_batch(
    cfg: SimulationConfig,
    coeffs: LLECoeffs,
    psi0: np.ndarray,
    *,
    mesh=None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Evolve B fields in one XLA program (reduce mode): returns host
    ``(peak_max (B,), psi_last (B, T), ok (B,))`` -- the detuning/pump scan
    engine.  Pass ``mesh`` to shard the batch axis (``shard_map``).

    ``cfg.precision='df32'`` dispatches the matched-tolerance two-float
    engine (``ops/df32_lle.py``, <=1e-9 vs the x64 solver; build coeffs with ``make_lle_coeffs(precision='df32')``)."""
    validate_config(cfg)
    method = _lle_method(cfg)
    psi0 = np.asarray(psi0, dtype=np.complex128)
    if psi0.ndim != 2:
        raise ValueError(f"psi0 must have shape (B, T), got {psi0.shape}")
    B, T = psi0.shape
    dt = float(cfg.dz)
    n_steps = int(round(float(cfg.z_max) / dt))
    if validate_precision(cfg.precision) == "df32":
        from ..ops.df32_lle import solve_lle_batch_df32

        det, F, ph = _lle_df32_args(cfg, coeffs, method)
        return solve_lle_batch_df32(
            psi0, det, F, ph, dt=dt, n_steps=n_steps,
            save_every=int(cfg.save_every), mesh=mesh,
        )
    rdt = real_dtype(cfg.precision)

    use_rk45 = method in ("rk45", "rk4ip45")
    if use_rk45:
        n_chunks = n_steps // int(cfg.save_every)
        rk45_tail = (n_steps - n_chunks * int(cfg.save_every)) > 0
        t_grid = jnp.asarray(
            np.arange(n_chunks + 1, dtype=np.float64)
            * (int(cfg.save_every) * dt), dtype=rdt)
        dt0 = jnp.asarray(dt, dtype=rdt)
        t_end = jnp.asarray(n_steps * dt, dtype=rdt)

    det, fr, fi, ph = _norm_batch(coeffs, B, T, rdt)
    n_orig = B
    if mesh is None:
        cof = LLECoeffs(
            detuning=jnp.asarray(det, dtype=rdt),
            pump_re=jnp.asarray(fr, dtype=rdt),
            pump_im=jnp.asarray(fi, dtype=rdt),
            lin_phase=jnp.asarray(ph, dtype=rdt),
        )
        if use_rk45:
            solver = _lle_adaptive_solver(
                np.dtype(rdt).name, float(cfg.rtol), float(cfg.atol),
                int(cfg.max_steps), True, rk45_tail,
                _lle_adaptive_family(method))
            out = jax.block_until_ready(
                solver(jnp.asarray(ri_pack_host(psi0, rdt)), cof,
                       t_grid, dt0, t_end)
            )
        else:
            solver = _lle_solver(n_steps, int(cfg.save_every),
                                 np.dtype(rdt).name, method, True)
            out = jax.block_until_ready(
                solver(jnp.asarray(ri_pack_host(psi0, rdt)), cof,
                       jnp.asarray(dt, dtype=rdt))
            )
    else:
        from ..parallel.mesh import (
            batch_sharding, fetch_global, pad_batch, put_global,
        )

        ndev = int(np.prod(list(mesh.shape.values())))
        psi0_p, n_orig = pad_batch(psi0, ndev)
        det_p, _ = pad_batch(det, ndev)
        fr_p, _ = pad_batch(fr, ndev)
        fi_p, _ = pad_batch(fi, ndev)
        ph_p, _ = pad_batch(ph, ndev)
        sh = batch_sharding(mesh)
        cof = LLECoeffs(
            detuning=put_global(det_p.astype(rdt), sh),
            pump_re=put_global(fr_p.astype(rdt), sh),
            pump_im=put_global(fi_p.astype(rdt), sh),
            lin_phase=put_global(ph_p.astype(rdt), sh),
        )
        if use_rk45:
            solver = _lle_adaptive_reduce_solver_sharded(
                np.dtype(rdt).name, float(cfg.rtol), float(cfg.atol),
                int(cfg.max_steps), mesh, 2, rk45_tail,
                _lle_adaptive_family(method))
            out = fetch_global(jax.block_until_ready(
                solver(put_global(ri_pack_host(psi0_p, rdt), sh), cof,
                       t_grid, dt0, t_end)
            ))
        else:
            solver = _lle_reduce_solver_sharded(
                n_steps, int(cfg.save_every), np.dtype(rdt).name, mesh,
                method, 2)
            out = fetch_global(jax.block_until_ready(
                solver(put_global(ri_pack_host(psi0_p, rdt), sh), cof,
                       jnp.asarray(dt, dtype=rdt))
            ))
    if use_rk45:
        pk, y_ri, ok, _na, _nr = _split_reduce_pack(out, T, counters=True)
    else:
        pk, y_ri, ok = _split_reduce_pack(out, T, counters=False)
    return (np.asarray(pk[:, 0], dtype=np.float64)[:n_orig],
            ri_unpack_host(np.asarray(y_ri))[:n_orig],
            np.asarray(ok)[:n_orig].astype(bool))


def solve_lle_batch_trajectories(
    cfg: SimulationConfig,
    coeffs: LLECoeffs,
    psi0: np.ndarray,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Batched evolution returning decimated trajectories
    ``(t (S+1,), psi (B, S+1, T), ok (B,))``."""
    validate_config(cfg)
    method = _lle_method(cfg)
    psi0 = np.asarray(psi0, dtype=np.complex128)
    if psi0.ndim != 2:
        raise ValueError(f"psi0 must have shape (B, T), got {psi0.shape}")
    B, T = psi0.shape
    dt = float(cfg.dz)
    n_steps = int(round(float(cfg.z_max) / dt))
    n_chunks = n_steps // int(cfg.save_every)
    if validate_precision(cfg.precision) == "df32":
        psi_saved, ok = _lle_df32_traj(cfg, coeffs, psi0, method)
        t = np.arange(n_chunks + 1, dtype=np.float64) * (
            int(cfg.save_every) * dt)
        return t, np.swapaxes(psi_saved, 0, 1), ok
    rdt = real_dtype(cfg.precision)
    det, fr, fi, ph = _norm_batch(coeffs, B, T, rdt)
    cof = LLECoeffs(
        detuning=jnp.asarray(det, dtype=rdt),
        pump_re=jnp.asarray(fr, dtype=rdt),
        pump_im=jnp.asarray(fi, dtype=rdt),
        lin_phase=jnp.asarray(ph, dtype=rdt),
    )
    t = np.arange(n_chunks + 1, dtype=np.float64) * (
        int(cfg.save_every) * dt)
    if method in ("rk45", "rk4ip45"):
        remainder = n_steps - n_chunks * int(cfg.save_every)
        solver = _lle_adaptive_solver(
            np.dtype(rdt).name, float(cfg.rtol), float(cfg.atol),
            int(cfg.max_steps), False, remainder > 0,
            _lle_adaptive_family(method))
        ys, _yf, ok, _na, _nr = jax.block_until_ready(
            solver(jnp.asarray(ri_pack_host(psi0, rdt)), cof,
                   jnp.asarray(t, dtype=rdt), jnp.asarray(dt, dtype=rdt),
                   jnp.asarray(n_steps * dt, dtype=rdt))
        )
        A = ri_unpack_host(np.asarray(ys)).transpose(1, 0, 2)
        return t, A, np.asarray(ok).astype(bool)
    solver = _lle_solver(n_steps, int(cfg.save_every), np.dtype(rdt).name,
                         method, False)
    ys, ok = jax.block_until_ready(
        solver(jnp.asarray(ri_pack_host(psi0, rdt)), cof,
               jnp.asarray(dt, dtype=rdt))
    )
    A = ri_unpack_host(np.asarray(ys)).transpose(1, 0, 2)
    return t, A, np.asarray(ok).astype(bool)


def run_lle_ramp(
    cfg: SimulationConfig,
    coeffs: LLECoeffs,
    psi0: np.ndarray,
    *,
    detuning_start: float,
    detuning_end: float,
    t0: float = 0.0,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Laser-scan protocol: evolve with the detuning ramped linearly from
    ``detuning_start`` to ``detuning_end`` over ``cfg.z_max`` lifetimes
    (``coeffs.detuning`` is ignored).  Returns ``(t_saved, detuning_saved,
    psi_saved (S+1, T))`` -- the soliton-step trace is
    ``mean |psi_saved|^2`` vs ``detuning_saved``.

    Checkpoint/resume (SURVEY §5): the detuning SCHEDULE is not autonomous,
    so a resume keeps the FULL ramp definition -- same ``cfg.z_max`` (total
    ramp duration), same endpoints -- and passes ``t0`` = the saved time to
    restart from plus ``psi0`` = the field saved there.  Integration covers
    ``[t0, z_max]``; the per-step detunings are computed from the GLOBAL
    step index, so the resumed saved rows are BITWISE those of the
    uninterrupted run when ``t0`` sits on a save boundary.

    Strang only (the ramp stepper recomputes the scalar detuning phase per
    step; the dispersion factor stays fixed)."""
    validate_config(cfg)
    if cfg.integrator.lower() != "rk4":
        raise ValueError("the LLE ramp protocol is integrator='rk4' only")
    rdt = real_dtype(require_non_df32(cfg.precision, family="LLE ramp"))
    psi0 = np.asarray(psi0, dtype=np.complex128)
    if psi0.ndim != 1:
        raise ValueError(f"psi0 must be a 1-D field (T,), got {psi0.shape}")
    dt = float(cfg.dz)
    n_total = int(round(float(cfg.z_max) / dt))
    t0 = float(t0)
    step0 = int(round(t0 / dt))
    if not (0 <= step0 <= n_total) or not np.isfinite(t0):
        raise ValueError(
            f"t0={t0} must lie inside the ramp [0, z_max={cfg.z_max}]"
        )
    n_steps = n_total - step0
    n_chunks = n_steps // int(cfg.save_every)
    det_step = (float(detuning_end) - float(detuning_start)) / max(n_total, 1)
    solver = _lle_ramp_solver(n_steps, int(cfg.save_every),
                              np.dtype(rdt).name)
    ys, ok = jax.block_until_ready(
        solver(ri_pack_host(psi0[None], rdt), coeffs,
               jnp.asarray(dt, dtype=rdt),
               jnp.asarray(float(detuning_start), dtype=rdt),
               jnp.asarray(det_step, dtype=rdt),
               jnp.asarray(step0, dtype=jnp.int32))
    )
    if cfg.check_nan and int(np.asarray(ok)[0]) == 0:
        raise FloatingPointError("NaN or Inf detected during LLE ramp")
    steps = (step0
             + np.arange(n_chunks + 1, dtype=np.float64) * int(cfg.save_every))
    t = steps * dt
    det = float(detuning_start) + det_step * steps
    return t, det, ri_unpack_host(np.asarray(ys))[:, 0, :]


def detuning_scan(
    cfg: SimulationConfig,
    grid: TimeGrid,
    *,
    detunings,
    pump: float,
    d2: float,
    psi0: Optional[np.ndarray] = None,
    seed: Optional[int] = 0,
    noise_amplitude: float = 1e-3,
    mesh=None,
    precision: Optional[str] = None,
):
    """Batched steady-state scan over a detuning grid at fixed pump: each
    lane evolves independently for ``cfg.z_max`` lifetimes from ``psi0``
    (default: the CW lower branch + small complex noise to let MI/solitons
    develop).  Returns ``(detunings, mean_power (B,), peak_power (B,),
    psi_last (B, T), ok (B,))``."""
    det = np.asarray(list(detunings), dtype=float)
    if det.ndim != 1 or det.size == 0:
        raise ValueError("detunings must be a non-empty 1-D grid")
    prec = precision if precision is not None else cfg.precision
    # The override must govern BOTH coefficient construction and engine
    # dispatch (solve_lle_batch dispatches on cfg.precision) — otherwise
    # precision='df32' with an x32 cfg would silently run the x32 engine
    # on df32-layout coeffs.
    if precision is not None:
        cfg = dataclasses.replace(cfg, precision=prec)
    coeffs = make_lle_coeffs(grid, detuning=det, pump=pump, d2=d2,
                             precision=prec)
    if psi0 is None:
        rho = np.array([cw_steady_states(d, pump)[0] for d in det])
        base = np.array([cw_state(d, pump, r) for d, r in zip(det, rho)])
        rng = np.random.default_rng(seed)
        T = int(grid.n_samples)
        noise = noise_amplitude * (rng.standard_normal((det.size, T))
                                   + 1j * rng.standard_normal((det.size, T)))
        psi0 = base[:, None] + noise
    pk, psi_last, ok = solve_lle_batch(cfg, coeffs, psi0, mesh=mesh)
    mean_p = np.mean(np.abs(psi_last) ** 2, axis=-1)
    return det, mean_p, pk, psi_last, ok


def comb_spectrum(psi: np.ndarray) -> np.ndarray:
    """Comb line powers ``|fft(psi)|^2 / T^2`` (line 0 = pump; fft order --
    pair with ``TimeGrid.omega()`` for the frequency axis)."""
    psi = np.asarray(psi)
    T = psi.shape[-1]
    return np.abs(np.fft.fft(psi, axis=-1) / T) ** 2
