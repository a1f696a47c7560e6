"""N-wave cascaded four-wave-mixing comb model.

BASELINE.json config 5: "N-wave cascaded FWM comb: many interacting frequency
lines (dense coupling in the RHS) with adaptive RK45 stepping".  The reference
only gestures at this (its 4-wave model is the hand-truncated special case;
higher-order dispersion hooks at ``dispersion.py:171-173``); this module is
the general model, designed for batched accelerators.

Physics: N lines on a uniform angular-frequency grid
``omega_j = omega_0 + j * domega``.  Coupled-mode (non-rotating-frame)
equations [cf. Hansson et al., "On the numerical simulation of Kerr frequency
combs using coupled mode equations", arXiv:1307.3428 -- listed in PAPERS.md]:

    dA_j/dz = (-alpha/2 + i beta_j) A_j
              + i gamma * sum_{k,l,m : k+l-m=j} A_k A_l A_m^*

The ordered double sum automatically contains SPM (|A_j|^2 A_j), XPM
(2|A_k|^2 A_j) and every cascaded mixing product with the correct degeneracy
factors; the linear ``i beta_j`` term carries phase mismatch exactly (no
explicit exp(i dbeta z) factors -- the autonomous-form generalization of the
4-wave rotating frame).  The energy-conservation constraint k+l-m=j holds
exactly on the uniform grid.

Evaluation of the O(N^3) sum: it is a convolution-correlation,

    S = A * A                (autoconvolution, length 2N-1)
    T_j = sum_m S_{j+m} A_m^*  (cross-correlation)
      ==> T = IFFT( FFT(A,L)^2 * conj(FFT(A,L)) )[0:N],  L >= 2N-1

three length-L FFT passes instead of an N^3 loop: O(N log N) work, fully
batched and XLA-fusable.  A direct ``einsum`` reference path exists for
validation.  Gauge freedom: ``beta_j`` may have its constant and linear parts
removed (``remove_linear=True``) -- a per-line phase rotation that leaves all
powers and gains invariant while shrinking the stiff linear rotation rates.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import jax
import numpy as np
import jax.numpy as jnp

from ..config import SimulationConfig, validate_config, reject_non_ode
from ..ops.adaptive import integrate_adaptive_grid
from ..ops.dispersion import DispersionParams, beta_taylor
from ..ops.integrators import integrate_fixed_grid, integrate_reduce
from ..utils.packing import complex_to_ri, ri_pack_host, ri_to_complex, ri_unpack_host
from ..utils.precision import real_dtype, validate_precision


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class NWaveCoeffs:
    """Lowered comb coefficients (batchable pytree).

    ``beta_lin`` is the per-line linear propagation constant [1/m] (possibly
    gauge-reduced); ``gamma`` [1/(W m)] and ``alpha`` [1/m] broadcast.
    """

    gamma: jax.Array      # scalar or (...,)
    alpha: jax.Array      # scalar or (...,)
    beta_lin: jax.Array   # (..., N)


def _fft_len(n_waves: int) -> int:
    """Smallest power of two >= 2N-1: alias-free for the kept outputs.

    The circular triple product aliases only when k+l-m-j = +-L; with
    k,l,m,j in [0, N-1] that combination spans [-(2N-2), 2N-2], so any
    L >= 2N-1 is exact for T[0:N]."""
    need = max(2 * n_waves - 1, 1)
    return 1 << (need - 1).bit_length()


def fwm_polarization(a: jax.Array) -> jax.Array:
    """T_j = sum_{k+l-m=j} A_k A_l A_m^* via padded FFTs (O(N log N))."""
    n = a.shape[-1]
    L = _fft_len(n)
    F = jnp.fft.fft(a, n=L, axis=-1)
    T = jnp.fft.ifft(F * F * jnp.conj(F), axis=-1)
    return T[..., :n]


@functools.lru_cache(maxsize=32)
def _dft_mats(n_waves: int, rdt_name: str):
    """Host-precomputed DFT / inverse-DFT matrix factors (real/imag pairs).

    Forward maps the N physical lines into L >= 2N-1 bins ((N, L) slice of
    the DFT); inverse keeps only the N physical outputs ((L, N) slice,
    including the 1/L normalization).  f32 pairs, combined on device with
    ``lax.complex`` (no weak-c128 constants)."""
    L = _fft_len(n_waves)
    jj = np.arange(L)
    ang_f = (-2.0 * np.pi / L) * np.outer(np.arange(n_waves), jj)
    ang_i = (2.0 * np.pi / L) * np.outer(jj, np.arange(n_waves))
    return (
        np.cos(ang_f).astype(rdt_name), np.sin(ang_f).astype(rdt_name),
        (np.cos(ang_i) / L).astype(rdt_name), (np.sin(ang_i) / L).astype(rdt_name),
    )


def fwm_polarization_dft(a: jax.Array) -> jax.Array:
    """Same cubic sum as :func:`fwm_polarization`, with the transforms as
    dense DFT *matmuls* instead of FFT passes.

    O(N*L) per transform instead of O(L log L), but the work becomes
    (B, N) @ (N, L) / (B, L) @ (L, N) matrix products, and it partitions
    cleanly under GSPMD (XLA:CPU's FFT thunk cannot run on sharded
    buffers)."""
    n = a.shape[-1]
    rdt = jnp.finfo(a.dtype).dtype
    fr, fi, ir, ii = _dft_mats(int(n), np.dtype(rdt).name)
    Wf = jax.lax.complex(jnp.asarray(fr), jnp.asarray(fi)).astype(a.dtype)
    Wi = jax.lax.complex(jnp.asarray(ir), jnp.asarray(ii)).astype(a.dtype)
    F = jnp.matmul(a, Wf, precision=jax.lax.Precision.HIGHEST)
    G = F * F * jnp.conj(F)
    return jnp.matmul(G, Wi, precision=jax.lax.Precision.HIGHEST)


def fwm_polarization_direct(a: jax.Array) -> jax.Array:
    """Reference O(N^3) evaluation of the same sum (validation / tiny N)."""
    n = a.shape[-1]
    idx = np.arange(n)
    k = idx[:, None, None]
    l = idx[None, :, None]
    m = idx[None, None, :]
    j = k + l - m
    valid = (j >= 0) & (j < n)
    j_safe = np.clip(j, 0, n - 1)
    # scatter A_k A_l conj(A_m) into line j
    prod = (
        a[..., :, None, None] * a[..., None, :, None] * jnp.conj(a)[..., None, None, :]
    )
    prod = jnp.where(jnp.asarray(valid), prod, 0.0)
    onehot = jnp.asarray(
        (j_safe[..., None] == idx[None, None, None, :]) & valid[..., None],
        dtype=a.dtype,
    )
    # HIGHEST: a float32 contraction would otherwise run in TF32 on a GPU
    return jnp.einsum("...klm,klmj->...j", prod, onehot,
                      precision=jax.lax.Precision.HIGHEST)


VALID_COUPLINGS = ("fft", "dft", "einsum")

_COUPLING_FNS = {
    "fft": fwm_polarization,
    "dft": fwm_polarization_dft,
    "einsum": fwm_polarization_direct,
}


def make_rhs_nwave(coupling: str = "fft"):
    """Comb RHS factory over ``(..., N)`` complex state; autonomous.

    ``coupling`` selects the evaluation of the cubic sum: 'fft'
    (O(N log N), default), 'dft' (dense DFT matrix products -- GSPMD-
    partitionable), or 'einsum' (O(N^3) reference)."""
    if coupling not in VALID_COUPLINGS:
        raise ValueError(f"coupling must be one of {VALID_COUPLINGS}, got {coupling!r}")
    pol = _COUPLING_FNS[coupling]

    def rhs(z, a: jax.Array, p: NWaveCoeffs) -> jax.Array:
        nb = a.ndim - 1
        g = jnp.asarray(p.gamma)
        al = jnp.asarray(p.alpha)
        if g.ndim > 0:
            g = g.reshape(g.shape + (1,) * (1 + nb - g.ndim))
        if al.ndim > 0:
            al = al.reshape(al.shape + (1,) * (1 + nb - al.ndim))

        rdt = jnp.finfo(a.dtype).dtype
        beta = jnp.asarray(p.beta_lin).astype(rdt)

        T = pol(a)
        # (-alpha/2) A + i beta A + i gamma T, built via lax.complex to avoid
        # weak-c128 constants (see ops/rhs.py)
        lin_re = (-0.5 * al.astype(rdt)) * a.real - beta * a.imag
        lin_im = (-0.5 * al.astype(rdt)) * a.imag + beta * a.real
        lin = jax.lax.complex(lin_re, lin_im).astype(a.dtype)
        gT = g.astype(rdt) * T
        nonlin = jax.lax.complex(-gT.imag, gT.real).astype(a.dtype)
        return lin + nonlin

    rhs.__name__ = f"rhs_nwave_{coupling}"
    return rhs


rhs_nwave = make_rhs_nwave("fft")
rhs_nwave_direct = make_rhs_nwave("einsum")


# ---------------------------------------------------------------------------
# Parameter construction
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CombGrid:
    """Uniform comb frequency grid: omega_j = omega_0 + j * domega."""

    omega_0: float     # [rad/s] first line
    domega: float      # [rad/s] line spacing
    n_waves: int

    def omegas(self) -> np.ndarray:
        return self.omega_0 + np.arange(self.n_waves) * self.domega

    @classmethod
    def centered(cls, omega_c: float, domega: float, n_waves: int) -> "CombGrid":
        """Grid centered on omega_c (line index n_waves//2 at omega_c)."""
        return cls(
            omega_0=float(omega_c) - (n_waves // 2) * float(domega),
            domega=float(domega),
            n_waves=int(n_waves),
        )


def comb_beta_lin(
    grid: CombGrid,
    dispersion: DispersionParams,
    *,
    max_order: int = 4,
    remove_linear: bool = True,
) -> np.ndarray:
    """Per-line beta(omega_j) [1/m] from the Taylor dispersion model.

    ``remove_linear=True`` subtracts the constant and group-delay terms
    (beta_0 + beta_1*(omega_j - omega_ref)): a gauge transformation that
    leaves every |A_j| and every energy-conserving mixing product's phase
    mismatch invariant, while removing the fastest (physically irrelevant)
    phase rotations -- essential conditioning for f32 and for step size.
    """
    om = grid.omegas()
    beta = np.asarray(beta_taylor(om, dispersion, max_order=max_order), dtype=float)
    if remove_linear:
        dw = om - float(np.asarray(dispersion.omega_ref))
        b0 = float(np.asarray(dispersion.get_beta_n(0)))
        b1 = float(np.asarray(dispersion.get_beta_n(1)))
        beta = beta - (b0 + b1 * dw)
    return beta


def make_comb_coeffs(
    grid: CombGrid,
    dispersion: DispersionParams,
    *,
    gamma_W_m: float,
    alpha_1_m: float = 0.0,
    max_order: int = 4,
    remove_linear: bool = True,
    precision: str = "x64",
) -> NWaveCoeffs:
    rdt = real_dtype(validate_precision(precision))
    return NWaveCoeffs(
        gamma=jnp.asarray(float(gamma_W_m), dtype=rdt),
        alpha=jnp.asarray(float(alpha_1_m), dtype=rdt),
        beta_lin=jnp.asarray(
            comb_beta_lin(grid, dispersion, max_order=max_order,
                          remove_linear=remove_linear),
            dtype=rdt,
        ),
    )


def seed_comb(
    grid: CombGrid,
    *,
    pump_lines: dict,
    noise_floor_W: float = 0.0,
    seed: int = 0,
) -> np.ndarray:
    """Initial comb state: ``pump_lines`` maps line index -> power [W] (or
    (power, phase) tuples); optionally a random-phase noise floor seeds the
    remaining lines (cascade growth needs nonzero seeds in a coherent model).
    """
    n = grid.n_waves
    A0 = np.zeros(n, dtype=np.complex128)
    if noise_floor_W > 0.0:
        rng = np.random.default_rng(seed)
        A0 += np.sqrt(noise_floor_W) * np.exp(2j * np.pi * rng.random(n))
    for j, spec in pump_lines.items():
        if not (0 <= int(j) < n):
            raise ValueError(f"pump line index {j} outside comb of {n} lines")
        if isinstance(spec, (tuple, list)):
            p, ph = float(spec[0]), float(spec[1])
        else:
            p, ph = float(spec), 0.0
        if p < 0:
            raise ValueError("pump line power must be >= 0")
        A0[int(j)] = np.sqrt(p) * np.exp(1j * ph)
    return A0


# ---------------------------------------------------------------------------
# Solvers
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=64)
def _comb_fixed_solver(n_steps: int, save_every: int, check_nan: bool, unroll: int,
                       coupling: str = "fft", method: str = "rk4"):
    rhs = make_rhs_nwave(coupling)

    def run(y0_ri, coeffs, dz):
        # real/imag packing at the jit boundary (utils/packing.py)
        res = integrate_fixed_grid(
            rhs, ri_to_complex(y0_ri), coeffs, z0=jnp.zeros((), dz.dtype),
            dz=dz, n_steps=n_steps, save_every=save_every, check_nan=check_nan,
            unroll=unroll, method=method,
        )
        return (
            res.z_saved,
            complex_to_ri(res.y_saved).astype(y0_ri.dtype),
            res.ok.astype(jnp.int32),
        )
    return jax.jit(run)


@functools.lru_cache(maxsize=64)
def _comb_adaptive_solver(rtol: float, atol: float, max_steps: int,
                          coupling: str = "fft", has_tail: bool = False):
    rhs = make_rhs_nwave(coupling)

    def run(y0_ri, coeffs, z_grid, z_final):
        res = integrate_adaptive_grid(
            rhs, ri_to_complex(y0_ri), coeffs, z_grid=z_grid, rtol=rtol,
            atol=atol, max_steps_per_segment=max_steps,
            z_final=z_final if has_tail else None,
        )
        return (
            complex_to_ri(res.y_saved).astype(y0_ri.dtype),
            res.ok.astype(jnp.int32),
        )
    return jax.jit(run)


def run_comb_simulation(
    cfg: SimulationConfig,
    coeffs: NWaveCoeffs,
    A0: np.ndarray,
    *,
    length_unit: str = "m",
    unroll: int = 2,
    coupling: str = "fft",
    z0: float = 0.0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Integrate a comb over [z0, z0 + z_max]; returns host ``(z, A (S+1, N))``.

    ``cfg.integrator`` selects fixed RK4 or adaptive RK45 (the latter with
    dense output on the decimated save grid -- the recommended mode for wide,
    stiff combs).

    ``z0`` (in ``length_unit``) supports checkpoint/resume (SURVEY §5): the
    rotating-frame comb equation is autonomous, so ``z0`` only offsets the
    returned z grid -- pass the last saved row as ``A0`` and its coordinate
    as ``z0`` to continue, with BITWISE restart parity on the fixed-step
    methods (same contract as ``gnlse.run_gnlse_simulation(z0=)``).
    """
    from ..utils.units import length_scale_to_m

    validate_config(cfg)
    reject_non_ode(cfg, "the comb engines")
    scale = length_scale_to_m(length_unit)
    z0 = float(z0)
    if not np.isfinite(z0):
        raise ValueError("z0 must be finite")
    precision = validate_precision(cfg.precision)
    rdt = real_dtype(precision)

    z_max_m = float(cfg.z_max) * scale
    dz_m = float(cfg.dz) * scale
    n_steps = int(round(z_max_m / dz_m))
    A0 = np.asarray(A0)
    if A0.ndim != 1:
        raise ValueError("A0 must be a 1-D array of N complex line amplitudes")
    if precision == "df32":
        raise ValueError(
            "precision='df32' is reduce-mode only for combs: use "
            "solve_comb_batch (the two-float engine computes P_max/A_end, "
            "not trajectories); for trajectories use 'x64' (CPU) or 'x32'"
        )

    if cfg.integrator.lower() == "rk45":
        n_chunks = n_steps // cfg.save_every
        z_grid = np.arange(n_chunks + 1, dtype=np.float64) * (cfg.save_every * dz_m)

        # trailing n_steps % save_every partial span integrated but unsaved
        # (folds into ok only -- the framework-wide decimation contract)
        solver = _comb_adaptive_solver(
            float(cfg.rtol), float(cfg.atol), int(cfg.max_steps), coupling,
            (n_steps % int(cfg.save_every)) > 0,
        )
        y_ri, ok_i = solver(
            jnp.asarray(ri_pack_host(A0, rdt)), coeffs, jnp.asarray(z_grid, dtype=rdt),
            jnp.asarray(n_steps * dz_m, dtype=rdt)
        )
        ok = int(np.asarray(ok_i)) != 0
        z_out = z_grid / scale
    else:
        solver = _comb_fixed_solver(
            n_steps, int(cfg.save_every), bool(cfg.check_nan), unroll, coupling,
            cfg.integrator.lower(),
        )
        z_dev, y_ri, ok_i = solver(
            jnp.asarray(ri_pack_host(A0, rdt)), coeffs, jnp.asarray(dz_m, dtype=rdt)
        )
        ok = int(np.asarray(ok_i)) != 0
        z_out = np.asarray(z_dev, dtype=np.float64) / scale

    if cfg.check_nan and not ok:
        raise FloatingPointError("NaN or Inf detected during comb integration")
    return z0 + np.asarray(z_out, dtype=float), ri_unpack_host(np.asarray(y_ri))


@functools.lru_cache(maxsize=64)
def _comb_batch_traj_solver(n_steps: int, save_every: int, unroll: int,
                            coupling: str, method: str = "rk4"):
    rhs = make_rhs_nwave(coupling)

    def one(y0, coeffs, dz):
        res = integrate_fixed_grid(
            rhs, y0, coeffs, z0=jnp.zeros((), dz.dtype), dz=dz,
            n_steps=n_steps, save_every=save_every, check_nan=True,
            unroll=unroll, method=method,
        )
        return complex_to_ri(res.y_saved), res.ok

    def batch(y0_ri, coeffs_b, dz):
        ys, ok = jax.vmap(one, in_axes=(0, 0, None))(
            ri_to_complex(y0_ri), coeffs_b, dz
        )
        return ys.astype(y0_ri.dtype), ok.astype(jnp.int32)

    return jax.jit(batch)


@functools.lru_cache(maxsize=64)
def _comb_batch_adaptive_traj_solver(rtol: float, atol: float,
                                     max_steps: int, coupling: str,
                                     has_tail: bool = False):
    rhs = make_rhs_nwave(coupling)

    def one(y0, coeffs, z_grid, z_final):
        res = integrate_adaptive_grid(
            rhs, y0, coeffs, z_grid=z_grid, rtol=rtol, atol=atol,
            max_steps_per_segment=max_steps,
            z_final=z_final if has_tail else None,
        )
        return complex_to_ri(res.y_saved), res.ok

    def batch(y0_ri, coeffs_b, z_grid, z_final):
        ys, ok = jax.vmap(one, in_axes=(0, 0, None, None))(
            ri_to_complex(y0_ri), coeffs_b, z_grid, z_final
        )
        return ys.astype(y0_ri.dtype), ok.astype(jnp.int32)

    return jax.jit(batch)


def solve_comb_batch_trajectories(
    cfg: SimulationConfig,
    coeffs: NWaveCoeffs,
    A0: np.ndarray,
    *,
    length_unit: str = "m",
    unroll: int = 2,
    coupling: str = "fft",
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Batched comb solve returning full decimated trajectories
    ``(z (S+1,), A (B, S+1, N) complex, ok (B,))`` -- the comb analog of
    ``sweep.solve_batch_trajectories`` (use :func:`solve_comb_batch` for
    large sweeps; trajectories materialize S+1 copies of the batch state).
    ``cfg.integrator`` selects fixed RK4 or adaptive RK45 (dense output on
    the decimated save grid); unsharded by design (moderate B).
    """
    from ..utils.units import length_scale_to_m

    validate_config(cfg)
    reject_non_ode(cfg, "the comb engines")
    scale = length_scale_to_m(length_unit)
    precision = validate_precision(cfg.precision)
    if precision == "df32":
        raise ValueError(
            "precision='df32' is reduce-mode only for combs "
            "(solve_comb_batch); trajectories run 'x64' (CPU) or 'x32'"
        )
    rdt = real_dtype(precision)

    A0 = np.asarray(A0, dtype=np.complex128)
    if A0.ndim != 2:
        raise ValueError(f"A0 must have shape (B, N), got {A0.shape}")
    B, N = A0.shape
    dz_m = float(cfg.dz) * scale
    n_steps = int(round(float(cfg.z_max) * scale / dz_m))
    n_chunks = n_steps // int(cfg.save_every)

    coeffs_b = NWaveCoeffs(
        gamma=jnp.asarray(
            np.broadcast_to(np.asarray(coeffs.gamma, float), (B,)),
            dtype=rdt),
        alpha=jnp.asarray(
            np.broadcast_to(np.asarray(coeffs.alpha, float), (B,)),
            dtype=rdt),
        beta_lin=jnp.asarray(
            np.broadcast_to(np.asarray(coeffs.beta_lin, float), (B, N)),
            dtype=rdt),
    )
    y0_ri = jnp.asarray(ri_pack_host(A0, rdt))
    z = np.arange(n_chunks + 1, dtype=np.float64) * (
        int(cfg.save_every) * dz_m
    ) / scale
    if cfg.integrator.lower() == "rk45":
        z_grid = jnp.asarray(z * scale, dtype=rdt)
        solver = _comb_batch_adaptive_traj_solver(
            float(cfg.rtol), float(cfg.atol), int(cfg.max_steps), coupling,
            (n_steps % int(cfg.save_every)) > 0,
        )
        ys, ok = jax.block_until_ready(
            solver(y0_ri, coeffs_b, z_grid,
                   jnp.asarray(n_steps * dz_m, dtype=rdt)))
    else:
        solver = _comb_batch_traj_solver(
            n_steps, int(cfg.save_every), int(unroll), coupling,
            cfg.integrator.lower(),
        )
        ys, ok = jax.block_until_ready(
            solver(y0_ri, coeffs_b, jnp.asarray(dz_m, dtype=rdt))
        )
    A = ri_unpack_host(np.asarray(ys))
    return z, A, np.asarray(ok).astype(bool)


def comb_spectrum_db(A: np.ndarray, *, floor_dbw: float = -200.0) -> np.ndarray:
    """Per-line power spectrum in dBW with a floor (for plotting)."""
    P = np.abs(A) ** 2
    return 10.0 * np.log10(np.maximum(P, 10 ** (floor_dbw / 10.0)))


# ---------------------------------------------------------------------------
# Batched comb solves (sweeps over pump power / dispersion / gamma grids)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=64)
def _comb_batch_solver(n_steps: int, save_every: int, check_nan: bool, unroll: int,
                       coupling: str = "fft", method: str = "rk4"):
    rhs = make_rhs_nwave(coupling)

    def one(y0, coeffs, dz):
        P0 = y0.real * y0.real + y0.imag * y0.imag

        def red(acc, y):
            pmax, _ = acc
            P = y.real * y.real + y.imag * y.imag
            return jnp.maximum(pmax, P), y

        res = integrate_reduce(
            rhs, y0, coeffs,
            z0=jnp.zeros((), dz.dtype), dz=dz,
            n_steps=n_steps, save_every=save_every,
            reduce_init=(P0, y0), reduce_fn=red,
            check_nan=check_nan, unroll=unroll, method=method,
        )
        # A_final at the last SAVED grid point (framework-wide saved-grid
        # convention, matching the 4-wave sweep / df32 / pallas engines);
        # trailing partial steps are still integrated and reflected in ok.
        pmax, y_last = res.reduction
        return pmax, y_last, res.ok

    def batch(y0_ri, coeffs_b, dz):
        y0_b = ri_to_complex(y0_ri)
        pmax, yf, ok = jax.vmap(one, in_axes=(0, 0, None))(y0_b, coeffs_b, dz)
        # ONE stacked (B, 3N+1) output: a single device->host fetch
        rdt = y0_ri.dtype
        yf_ri = complex_to_ri(yf).astype(rdt)
        return jnp.concatenate(
            [pmax.astype(rdt), yf_ri.reshape(yf_ri.shape[0], -1),
             ok.astype(rdt)[:, None]], axis=1)

    return jax.jit(batch)


@functools.lru_cache(maxsize=64)
def _comb_batch_adaptive_solver(rtol: float, atol: float, max_steps: int,
                                coupling: str = "fft",
                                has_tail: bool = False):
    rhs = make_rhs_nwave(coupling)

    def one(y0, coeffs, z_grid, z_final):
        res = integrate_adaptive_grid(
            rhs, y0, coeffs, z_grid=z_grid, rtol=rtol, atol=atol,
            max_steps_per_segment=max_steps,
            z_final=z_final if has_tail else None,
        )
        P = res.y_saved.real ** 2 + res.y_saved.imag ** 2
        return jnp.max(P, axis=0), res.y_final, res.ok

    def batch(y0_ri, coeffs_b, z_grid, z_final):
        y0_b = ri_to_complex(y0_ri)
        pmax, yf, ok = jax.vmap(one, in_axes=(0, 0, None, None))(
            y0_b, coeffs_b, z_grid, z_final)
        # ONE stacked (B, 3N+1) output: a single device->host fetch
        rdt = y0_ri.dtype
        yf_ri = complex_to_ri(yf).astype(rdt)
        return jnp.concatenate(
            [pmax.astype(rdt), yf_ri.reshape(yf_ri.shape[0], -1),
             ok.astype(rdt)[:, None]], axis=1)

    return jax.jit(batch)


def solve_comb_batch(
    cfg: SimulationConfig,
    coeffs: NWaveCoeffs,
    A0: np.ndarray,
    *,
    length_unit: str = "m",
    mesh=None,
    unroll: int = 2,
    coupling: str = "fft",
):
    """Solve B independent combs in one XLA program.

    ``A0`` is ``(B, N)`` complex; ``coeffs`` fields broadcast or carry a
    leading B axis (``beta_lin`` must be ``(B, N)`` or ``(N,)``).  Returns
    host ``(P_max (B, N), A_final (B, N), ok (B,))`` -- per-line running max
    power over saved samples and the comb state at the last saved grid point
    (row 0 + every ``save_every``-th step; trailing partial steps are
    integrated -- they can flip ``ok`` under rk4 -- but unobserved, the
    framework-wide saved-grid convention).  Pass ``mesh`` to shard the batch
    axis.  ``cfg.integrator`` selects fixed RK4 or adaptive
    RK45 (dense output on the decimated save grid; note the adaptive P_max
    includes the initial state row, like the fixed path).

    ADAPTIVE (rk45) ACCURACY CONTRACT (x32 tolerance study,
    `scripts/study_comb_tolerance.py`): on the
    cascading-comb workload the error is tolerance-controlled down to an
    f32 ACCUMULATION FLOOR -- per-step rounding integrated against the
    cascade's parametric gain, growing with ``gamma*P*z`` (NOT chaotic
    divergence: a 1e-7 seed perturbation amplifies only ~65-330x over
    0.5-2 km in x64).  Measured p99 signal-line floors vs x64 truth:
    scan ~2e-4 (500 m) / ~7e-3 (2000 m).  Practical rules: rtol >= 1e-5
    is tolerance-class at bench-scale spans; below the
    floor, per-trajectory weak-line powers need ``precision='df32'``
    (the matched-tolerance engines), while ensemble/spectral observables
    (total power, centroid, bandwidth) remain converged in x32 one to
    two orders below the per-line p99.
    """
    from ..utils.units import length_scale_to_m

    validate_config(cfg)
    reject_non_ode(cfg, "the comb engines")
    scale = length_scale_to_m(length_unit)
    precision = validate_precision(cfg.precision)
    rdt = real_dtype(precision)

    A0 = np.asarray(A0, dtype=np.complex128)
    if A0.ndim != 2:
        raise ValueError(f"A0 must have shape (B, N), got {A0.shape}")
    B, N = A0.shape
    dz_m = float(cfg.dz) * scale
    n_steps = int(round(float(cfg.z_max) * scale / dz_m))

    gamma = np.broadcast_to(np.asarray(coeffs.gamma, dtype=float), (B,))
    alpha = np.broadcast_to(np.asarray(coeffs.alpha, dtype=float), (B,))
    beta = np.broadcast_to(np.asarray(coeffs.beta_lin, dtype=float), (B, N))

    if precision == "df32":
        # matched-tolerance tier: compensated two-float FFT coupling
        # (ops/df32_comb.py; ~1e-11 vs the f64 reference over 10^3 steps)
        if cfg.integrator.lower() != "rk4":
            raise ValueError(
                "precision='df32' comb solves are fixed-step rk4 only "
                "(the compensated engine has no adaptive controller)"
            )
        from ..ops.df32_comb import solve_comb_batch_df32

        r = solve_comb_batch_df32(
            A0, gamma, alpha, beta,
            dz_m=dz_m, n_steps=n_steps, save_every=int(cfg.save_every),
            mesh=mesh,
        )
        return r.P_max, r.A_end, r.ok
    n_orig = B
    if mesh is not None:
        from ..parallel.mesh import pad_batch

        ndev = int(np.prod(list(mesh.shape.values())))
        A0, n_orig = pad_batch(A0, ndev)
        gamma, _ = pad_batch(gamma, ndev)
        alpha, _ = pad_batch(alpha, ndev)
        beta, _ = pad_batch(beta, ndev)

    y0_ri = jnp.asarray(ri_pack_host(A0, rdt))
    coeffs_dev = NWaveCoeffs(
        gamma=jnp.asarray(gamma, dtype=rdt),
        alpha=jnp.asarray(alpha, dtype=rdt),
        beta_lin=jnp.asarray(beta, dtype=rdt),
    )
    if mesh is not None:
        from ..parallel.mesh import batch_sharding, put_global, put_global_tree

        sh = batch_sharding(mesh)
        y0_ri = put_global(np.asarray(y0_ri), sh)
        coeffs_dev = put_global_tree(
            jax.tree_util.tree_map(np.asarray, coeffs_dev), sh
        )

    if cfg.integrator.lower() == "rk45":
        n_chunks = n_steps // cfg.save_every
        z_grid = np.arange(n_chunks + 1, dtype=np.float64) * (cfg.save_every * dz_m)
        solver = _comb_batch_adaptive_solver(
            float(cfg.rtol), float(cfg.atol), int(cfg.max_steps), coupling,
            (n_steps % int(cfg.save_every)) > 0,
        )
        out = jax.block_until_ready(
            solver(y0_ri, coeffs_dev, jnp.asarray(z_grid, dtype=rdt),
                   jnp.asarray(n_steps * dz_m, dtype=rdt))
        )
    else:
        solver = _comb_batch_solver(
            n_steps, int(cfg.save_every), bool(cfg.check_nan), unroll, coupling,
            cfg.integrator.lower(),
        )
        out = jax.block_until_ready(
            solver(y0_ri, coeffs_dev, jnp.asarray(dz_m, dtype=rdt))
        )
    if mesh is not None:
        from ..parallel.mesh import fetch_global

        out = fetch_global(out)
    out = np.asarray(out)[:n_orig]        # ONE fetch of (B, 3N+1)
    Np = out.shape[1] // 3
    P_max = out[:, :Np].astype(np.float64)
    A_final = ri_unpack_host(out[:, Np:3 * Np].reshape(-1, Np, 2))
    return P_max, A_final, out[:, -1] > 0.5
