"""The dual-pump 4-wave FWM / phase-sensitive-amplifier model: parameter
containers, lowering, and the single-run orchestrator.

Capability parity:

- parameter containers -- reference ``parameters.py``: ``WAVE_ORDER`` (:43),
  ``WavesParams`` (:90-163), ``FiberParams`` (:166-206), ``SimulationGrid``
  (:209-221), ``PhaseMatchingParams`` (:224-233), ``CacheParams`` (:236-251),
  ``ModelParams`` (:254-267), factories (:270-293);
- runner -- reference ``simulation.py``: unit boundary (:58-67),
  ``make_initial_amplitudes`` (:103-123), dispersion/phase-matching rescaling
  (:126-175), default phase-matching choice (:178-213),
  ``run_single_simulation`` (:220-364), examples (:371-447).

Batch-first architecture: the rich containers are *host-side* frozen dataclasses
(validated eagerly, like the reference); nothing here crosses the jit
boundary.  :func:`lower_params` distills them ONCE into the small
:class:`~..ops.rhs.RHSCoeffs` device pytree consumed by the RHS -- hoisting
the reference's per-RHS-call duck-typed extraction (``yaman_model.py:59-116``,
run 4x per RK4 step) entirely out of the hot loop.  The solve itself is a
cached-jit ``lax.scan`` program from ``ops/integrators.py``.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import jax
import numpy as np
import jax.numpy as jnp

from ..config import SimulationConfig, validate_config, reject_non_ode
from ..ops.dispersion import DispersionParams
from ..ops.frequency_plan import SymmetricPlan
from ..ops.integrators import integrate_fixed_grid
from ..ops.phase_matching import (
    PhaseMatchingConfig,
    PhaseMatchingMethod,
    PhaseMatchingResult,
    compute_phase_mismatch,
)
from ..ops.rhs import RHSCoeffs, rhs_yaman, rhs_yaman_autonomous, rotating_to_lab
from ..utils.checks import to_scalar_float, validate_nonneg, validate_positive
from ..utils.packing import complex_to_ri, ri_pack_host, ri_to_complex, ri_unpack_host
from ..utils.precision import complex_dtype, real_dtype, validate_precision
from ..utils.units import length_scale_to_m

WAVE_ORDER: Tuple[str, str, str, str] = ("pump1", "pump2", "signal", "idler")

VALID_FRAMES = ("lab", "rotating")


# ---------------------------------------------------------------------------
# Input validation helpers (reference simulation.py:70-100)
# ---------------------------------------------------------------------------

def _to_omega_array(omega: Sequence[float]) -> np.ndarray:
    om = np.asarray(list(omega), dtype=float)
    if om.shape != (4,):
        raise ValueError(f"omega must have shape (4,), got {om.shape}")
    if not np.all(np.isfinite(om)):
        raise ValueError("omega must be finite")
    if np.any(om <= 0.0):
        raise ValueError("omega must be positive (rad/s)")
    return om


def _to_power_array(p_in: Sequence[float]) -> np.ndarray:
    p = np.asarray(list(p_in), dtype=float)
    if p.shape != (4,):
        raise ValueError(f"p_in must have shape (4,), got {p.shape}")
    if not np.all(np.isfinite(p)):
        raise ValueError("p_in must be finite")
    if np.any(p < 0.0):
        raise ValueError("p_in must be non-negative (W)")
    return p


def _to_phase_array(phase_in: Optional[Sequence[float]]) -> np.ndarray:
    if phase_in is None:
        return np.zeros(4, dtype=float)
    ph = np.asarray(list(phase_in), dtype=float)
    if ph.shape != (4,):
        raise ValueError(f"phase_in must have shape (4,), got {ph.shape}")
    if not np.all(np.isfinite(ph)):
        raise ValueError("phase_in must be finite")
    return ph


def make_initial_amplitudes(
    p_in: Sequence[float],
    phase_in: Optional[Sequence[float]] = None,
) -> np.ndarray:
    """A0_j = sqrt(P_j) * exp(i phi_j), complex128 shape (4,).
    Parity: reference ``simulation.py:103-123``."""
    p = _to_power_array(p_in)
    ph = _to_phase_array(phase_in)
    amp = np.sqrt(p).astype(np.complex128, copy=False)
    if np.any(ph != 0.0):
        amp = amp * np.exp(1j * ph)
    return amp


# ---------------------------------------------------------------------------
# Parameter containers (host-side; reference parameters.py)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class WavesParams:
    """Optical wave frequency plan; ``omega`` is (4,) in project wave order."""

    omega: np.ndarray
    symmetric: Optional[SymmetricPlan] = None

    def __post_init__(self):
        om = _to_omega_array(self.omega)
        object.__setattr__(self, "omega", om)
        if self.symmetric is not None:
            if not isinstance(self.symmetric, SymmetricPlan):
                raise TypeError("symmetric must be SymmetricPlan or None")
            om_sym = np.asarray(self.symmetric.omegas())
            if not np.allclose(om, om_sym, rtol=1e-12, atol=0.0):
                raise ValueError(
                    "Provided symmetric plan is inconsistent with omega. "
                    f"omega={om}, omega(sym)={om_sym}"
                )

    @property
    def omega1(self) -> float:
        return float(self.omega[0])

    @property
    def omega2(self) -> float:
        return float(self.omega[1])

    @property
    def omega3(self) -> float:
        return float(self.omega[2])

    @property
    def omega4(self) -> float:
        return float(self.omega[3])

    @classmethod
    def from_symmetry(cls, omega_c: float, omega_d: float, Omega: float) -> "WavesParams":
        sp = SymmetricPlan(
            omega_c=jnp.asarray(float(omega_c)),
            omega_d=jnp.asarray(float(omega_d)),
            Omega=jnp.asarray(float(Omega)),
        )
        return cls(omega=np.asarray(sp.omegas()), symmetric=sp)

    @classmethod
    def from_omegas(
        cls, omega1: float, omega2: float, omega3: float, omega4: Optional[float] = None
    ) -> "WavesParams":
        from ..ops.frequency_plan import plan_from_omegas

        om = np.asarray(plan_from_omegas(omega1, omega2, omega3, omega4))
        return cls(omega=om, symmetric=None)

    @classmethod
    def from_wavelengths(
        cls,
        lambda1_m: float,
        lambda2_m: float,
        lambda3_m: float,
        lambda4_m: Optional[float] = None,
    ) -> "WavesParams":
        from ..ops.frequency_plan import plan_from_wavelengths

        om = np.asarray(plan_from_wavelengths(lambda1_m, lambda2_m, lambda3_m, lambda4_m))
        return cls(omega=om, symmetric=None)


@dataclass(frozen=True)
class FiberParams:
    """Fiber / waveguide parameters (per-meter units)."""

    length_m: float
    gamma_W_m: float
    alpha_1_m: float = 0.0
    dispersion: Optional[DispersionParams] = None
    beta_legacy_1_m: Optional[np.ndarray] = None

    def __post_init__(self):
        object.__setattr__(self, "length_m", validate_positive(self.length_m, name="length_m"))
        object.__setattr__(self, "gamma_W_m", to_scalar_float(self.gamma_W_m, name="gamma_W_m"))
        object.__setattr__(self, "alpha_1_m", validate_nonneg(self.alpha_1_m, name="alpha_1_m"))
        if self.dispersion is not None and not isinstance(self.dispersion, DispersionParams):
            raise TypeError("dispersion must be DispersionParams or None")
        if self.beta_legacy_1_m is not None:
            bl = np.asarray(list(self.beta_legacy_1_m), dtype=float)
            if bl.shape != (4,):
                raise ValueError(f"beta_legacy_1_m must have shape (4,), got {bl.shape}")
            if not np.all(np.isfinite(bl)):
                raise ValueError("beta_legacy_1_m must contain finite values")
            object.__setattr__(self, "beta_legacy_1_m", bl)


@dataclass(frozen=True)
class SimulationGrid:
    """Discretization parameters (meters)."""

    dz_m: float
    z0_m: float = 0.0

    def __post_init__(self):
        object.__setattr__(self, "dz_m", validate_positive(self.dz_m, name="dz_m"))
        object.__setattr__(self, "z0_m", to_scalar_float(self.z0_m, name="z0_m"))


@dataclass(frozen=True)
class PhaseMatchingParams:
    config: PhaseMatchingConfig

    def __post_init__(self):
        if not isinstance(self.config, PhaseMatchingConfig):
            raise TypeError("config must be a PhaseMatchingConfig")


@dataclass
class CacheParams:
    """Computed-phase-mismatch slot, filled at simulation start.

    Kept mutable for API parity with the reference's runtime cache
    (``parameters.py:236-251``); the functional alternative is
    :func:`with_phase_mismatch`.
    """

    delta_beta_1_m: Optional[float] = None
    symmetric: Optional[SymmetricPlan] = None

    def set_phase_mismatch(
        self, delta_beta_1_m: float, symmetric: Optional[SymmetricPlan] = None
    ) -> None:
        self.delta_beta_1_m = to_scalar_float(delta_beta_1_m, name="delta_beta_1_m")
        self.symmetric = symmetric


@dataclass(frozen=True)
class ModelParams:
    """Aggregated model parameters."""

    waves: WavesParams
    fiber: FiberParams
    grid: SimulationGrid
    phase_matching: PhaseMatchingParams
    cache: CacheParams

    def __post_init__(self):
        if not isinstance(self.cache, CacheParams):
            raise TypeError("cache must be a CacheParams (mutable cache object)")


def make_default_phase_matching_params(
    *, method: PhaseMatchingMethod = PhaseMatchingMethod.SYMMETRIC_EVEN
) -> PhaseMatchingParams:
    cfg = PhaseMatchingConfig(
        method=method, max_order=4, even_orders=(2, 4), atol=0.0, rtol=1e-12
    )
    return PhaseMatchingParams(config=cfg)


def make_model_params(
    *,
    waves: WavesParams,
    fiber: FiberParams,
    grid: SimulationGrid,
    phase_matching: Optional[PhaseMatchingParams] = None,
) -> ModelParams:
    pm = phase_matching if phase_matching is not None else make_default_phase_matching_params()
    cache = CacheParams(delta_beta_1_m=None, symmetric=waves.symmetric)
    return ModelParams(waves=waves, fiber=fiber, grid=grid, phase_matching=pm, cache=cache)


def with_phase_mismatch(
    params: ModelParams, delta_beta_1_m: float, symmetric: Optional[SymmetricPlan] = None
) -> ModelParams:
    """Functional alternative to ``params.cache.set_phase_mismatch``."""
    cache = CacheParams(
        delta_beta_1_m=to_scalar_float(delta_beta_1_m, name="delta_beta_1_m"),
        symmetric=symmetric,
    )
    return ModelParams(
        waves=params.waves,
        fiber=params.fiber,
        grid=params.grid,
        phase_matching=params.phase_matching,
        cache=cache,
    )


# ---------------------------------------------------------------------------
# Lowering: rich containers -> device coefficients (once per run)
# ---------------------------------------------------------------------------

def lower_params(params: ModelParams, *, precision: str = "x64") -> RHSCoeffs:
    """Extract (gamma, alpha, delta_beta) with the reference's priority rules
    (``yaman_model.py:59-116``): cached delta_beta, else legacy per-wave betas
    (dbeta = b3+b4-b1-b2).  Runs ONCE per solve, not once per RHS eval.
    """
    fiber = params.fiber
    gamma = float(fiber.gamma_W_m)
    alpha = float(fiber.alpha_1_m)

    dbeta: Optional[float] = None
    if params.cache is not None and params.cache.delta_beta_1_m is not None:
        dbeta = float(params.cache.delta_beta_1_m)
    elif fiber.beta_legacy_1_m is not None:
        b = np.asarray(fiber.beta_legacy_1_m, dtype=float)
        dbeta = float((b[2] + b[3]) - (b[0] + b[1]))
    else:
        raise ValueError(
            "Phase mismatch dbeta is not available. Expected "
            "params.cache.delta_beta_1_m to be set (preferred), or "
            "fiber.beta_legacy_1_m for fallback."
        )

    rdt = real_dtype(validate_precision(precision))
    return RHSCoeffs(
        gamma=jnp.asarray(gamma, dtype=rdt),
        alpha=jnp.asarray(alpha, dtype=rdt),
        delta_beta=jnp.asarray(dbeta, dtype=rdt),
    )


# ---------------------------------------------------------------------------
# Cached jitted solvers
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=256)
def _fixed_solver(n_steps: int, save_every: int, check_nan: bool, frame: str, unroll: int,
                  method: str = "rk4"):
    rhs = rhs_yaman if frame == "lab" else rhs_yaman_autonomous

    def run(y0_ri, coeffs, z0, dz):
        # real/imag packing at the jit boundary (utils/packing.py)
        res = integrate_fixed_grid(
            rhs, ri_to_complex(y0_ri), coeffs,
            z0=z0, dz=dz, n_steps=n_steps,
            save_every=save_every, check_nan=check_nan, unroll=unroll,
            method=method,
        )
        y_saved = res.y_saved
        if frame == "rotating":
            y_saved = rotating_to_lab(res.z_saved, y_saved, coeffs)
        return (
            complex_to_ri(y_saved).astype(y0_ri.dtype),
            res.ok.astype(jnp.int32),
            res.bad_step,
        )

    return jax.jit(run)


def _default_phase_matching_cfg(
    *,
    dispersion: Optional[DispersionParams],
    beta_legacy: Optional[np.ndarray],
) -> PhaseMatchingConfig:
    """Default dbeta strategy (reference ``simulation.py:178-213``):
    dispersion -> SYMMETRIC_EVEN(2,4); legacy betas -> PROVIDED."""
    if dispersion is not None:
        return PhaseMatchingConfig(
            method=PhaseMatchingMethod.SYMMETRIC_EVEN,
            max_order=4,
            even_orders=(2, 4),
            atol=0.0,
            rtol=1e-12,
            provided_delta_beta=None,
        )
    if beta_legacy is not None:
        b = np.asarray(beta_legacy, dtype=float)
        if b.shape != (4,):
            raise ValueError("beta_legacy must have shape (4,)")
        db = float((b[2] + b[3]) - (b[0] + b[1]))
        return PhaseMatchingConfig(
            method=PhaseMatchingMethod.PROVIDED,
            max_order=0,
            even_orders=(2,),
            atol=0.0,
            rtol=1e-12,
            provided_delta_beta=db,
        )
    raise ValueError(
        "Provide either dispersion or beta_legacy (or an explicit phase_matching_cfg)."
    )


# ---------------------------------------------------------------------------
# Core single-run API (reference simulation.py:220-364)
# ---------------------------------------------------------------------------

def run_single_simulation(
    cfg: SimulationConfig,
    *,
    gamma: float,
    alpha: float,
    omega: Sequence[float],
    p_in: Sequence[float],
    phase_in: Optional[Sequence[float]] = None,
    dispersion: Optional[DispersionParams] = None,
    phase_matching_cfg: Optional[PhaseMatchingConfig] = None,
    beta_legacy: Optional[Sequence[float]] = None,
    length_unit: str = "m",
    return_length_unit: Optional[str] = None,
    frame: str = "lab",
    z0: float = 0.0,
    A_init: Optional[Sequence[complex]] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Run a single scalar 4-wave FWM simulation; returns host arrays
    ``(z_out, A)`` with ``A`` complex of shape ``(N_saved, 4)``.

    Signature and unit semantics match the reference runner
    (``simulation.py:220-364``): ``cfg.z_max``/``cfg.dz``, ``gamma``,
    ``alpha``, dispersion coefficients, and a PROVIDED dbeta are interpreted
    per ``length_unit`` and converted to internal meters; ``return_length_unit``
    controls the output z unit.

    Framework extensions: ``cfg.precision`` selects the dtype tier;
    ``frame='rotating'`` integrates the autonomous rotating-frame system (same
    powers, better f32 conditioning) and converts saved states back to lab
    frame; ``z0``/``A_init`` support checkpoint/resume -- pass the last saved
    (z, A) row to continue an integration over [z0, z0 + z_max] with exact
    lab-frame phase continuity (z0 in ``length_unit``).
    """
    validate_config(cfg)
    reject_non_ode(cfg, "the 4-wave runner")
    if frame not in VALID_FRAMES:
        raise ValueError(f"frame must be one of {VALID_FRAMES}, got {frame!r}")

    scale_to_m = length_scale_to_m(length_unit)

    om = _to_omega_array(omega)
    if A_init is not None:
        A0 = np.asarray(list(A_init), dtype=np.complex128)
        if A0.shape != (4,):
            raise ValueError(f"A_init must have shape (4,), got {A0.shape}")
        if not np.all(np.isfinite(A0)):
            raise ValueError("A_init must be finite")
    else:
        p = _to_power_array(p_in)
        A0 = make_initial_amplitudes(p, phase_in)
    z0_m = to_scalar_float(z0, name="z0") * scale_to_m

    beta_leg_m = None
    if beta_legacy is not None:
        b = np.asarray(list(beta_legacy), dtype=float)
        if b.shape != (4,):
            raise ValueError(f"beta_legacy must have shape (4,), got {b.shape}")
        if not np.all(np.isfinite(b)):
            raise ValueError("beta_legacy must be finite")
        beta_leg_m = b / scale_to_m

    disp_m = None
    if dispersion is not None:
        if not isinstance(dispersion, DispersionParams):
            raise TypeError("dispersion must be DispersionParams or None")
        disp_m = dispersion.scaled(scale_to_m)

    if phase_matching_cfg is not None:
        if not isinstance(phase_matching_cfg, PhaseMatchingConfig):
            raise TypeError("phase_matching_cfg must be PhaseMatchingConfig or None")
        # user-supplied PROVIDED dbeta is in 1/length_unit -> convert
        pm_cfg = phase_matching_cfg.scaled(scale_to_m)
    else:
        # the default is built from ALREADY-converted per-meter inputs and
        # must NOT be rescaled.  (The reference double-scales here -- an
        # uncatalogued defect: simulation.py:305-312 builds the default from
        # beta_leg_m [1/m] and then divides the derived dbeta by the unit
        # scale again, so beta_legacy with length_unit='km' runs with a
        # dbeta 1000x too small.  Not replicated.)
        pm_cfg = _default_phase_matching_cfg(dispersion=disp_m, beta_legacy=beta_leg_m)

    fiber = FiberParams(
        length_m=float(cfg.z_max) * scale_to_m,
        gamma_W_m=float(gamma) / scale_to_m,
        alpha_1_m=float(alpha) / scale_to_m,
        dispersion=disp_m,
        beta_legacy_1_m=beta_leg_m,
    )
    waves = WavesParams(omega=om, symmetric=None)
    grid = SimulationGrid(dz_m=float(cfg.dz) * scale_to_m, z0_m=z0_m)
    params = make_model_params(
        waves=waves, fiber=fiber, grid=grid,
        phase_matching=PhaseMatchingParams(config=pm_cfg),
    )

    # Compute and cache dbeta once per run (reference simulation.py:338-346).
    res: PhaseMatchingResult = compute_phase_mismatch(
        params.waves.omega,
        params.fiber.dispersion,
        params.phase_matching.config,
        symmetric_hint=params.waves.symmetric,
    )
    params.cache.set_phase_mismatch(float(np.asarray(res.delta_beta)), symmetric=res.symmetric)

    precision = validate_precision(cfg.precision)
    coeffs = lower_params(params, precision=precision)
    cdt = complex_dtype(precision)
    rdt = real_dtype(precision)

    n_steps = int(round(params.fiber.length_m / params.grid.dz_m))

    if frame == "rotating" and z0_m != 0.0:
        # enter the rotating frame at z0 (A = B on sidebands; pumps rotated)
        db0 = float(params.cache.delta_beta_1_m)
        A0 = A0.copy()
        A0[:2] *= np.exp(-0.5j * db0 * z0_m)

    if cfg.integrator.lower() == "rk45":
        from ..ops.adaptive import run_adaptive_trajectory

        return run_adaptive_trajectory(
            cfg, params, coeffs, A0,
            frame=frame, length_unit=length_unit,
            return_length_unit=return_length_unit,
            z0_m=z0_m,
        )

    solver = _fixed_solver(n_steps, int(cfg.save_every), bool(cfg.check_nan), frame, 4,
                           cfg.integrator.lower())
    y_ri, ok_i, bad_i = solver(
        jnp.asarray(ri_pack_host(A0, rdt)),
        coeffs,
        jnp.asarray(z0_m, dtype=rdt),
        jnp.asarray(params.grid.dz_m, dtype=rdt),
    )

    if cfg.check_nan and int(np.asarray(ok_i)) == 0:
        bad = int(np.asarray(bad_i))
        raise FloatingPointError(
            f"NaN or Inf detected at step {bad}, "
            f"z = {z0_m + bad * params.grid.dz_m} m"
        )

    y_saved = ri_unpack_host(np.asarray(y_ri))

    # Output unit conversion (reference simulation.py:359-363); z is rebuilt
    # on the host in f64 so x32 runs still report exact grid locations.
    out_unit = length_unit if return_length_unit is None else return_length_unit
    out_scale = length_scale_to_m(out_unit)
    n_saved = y_saved.shape[0]
    z_m = z0_m + (np.arange(n_saved) * cfg.save_every) * params.grid.dz_m
    z_out = z_m / out_scale

    if cfg.verbose:
        # the reference declares this flag but never reads it (SURVEY.md 8.8)
        P_out = np.abs(y_saved[-1]) ** 2
        print(
            f"[run_single_simulation] {n_steps} RK4 steps ({frame} frame, "
            f"{cfg.precision}), dbeta = {params.cache.delta_beta_1_m:.6g} 1/m, "
            f"z_end = {z_out[-1]:.6g} {out_unit}, "
            f"P_out [W] = {np.array2string(P_out, precision=6)}"
        )

    return z_out, y_saved


# ---------------------------------------------------------------------------
# Example simulations (reference simulation.py:371-447)
# ---------------------------------------------------------------------------

def example_zero_signal() -> Tuple[np.ndarray, np.ndarray]:
    """Two pumps, zero signal/idler at input, dbeta forced to 0 (PROVIDED)."""
    from ..config import default_simulation_config
    from ..constants import c as c0

    cfg = default_simulation_config()
    length_unit = "km"
    gamma = 1.3  # 1/(W km)
    alpha = 0.0  # 1/km
    omega0 = 2.0 * np.pi * c0 / 1.55e-6
    om = np.array([omega0, omega0, omega0, omega0], dtype=float)
    p_in = np.array([0.5, 0.5, 0.0, 0.0], dtype=float)
    pm_cfg = PhaseMatchingConfig(
        method=PhaseMatchingMethod.PROVIDED, provided_delta_beta=0.0
    )
    return run_single_simulation(
        cfg,
        gamma=gamma,
        alpha=alpha,
        omega=om,
        p_in=p_in,
        phase_in=None,
        dispersion=None,
        phase_matching_cfg=pm_cfg,
        beta_legacy=None,
        length_unit=length_unit,
        return_length_unit=length_unit,
    )


def custom_seeded_signal() -> Tuple[np.ndarray, np.ndarray]:
    """Seeded signal/idler with dbeta specified explicitly (PROVIDED)."""
    from ..config import custom_simulation_config
    from ..constants import c as c0

    cfg = custom_simulation_config(z_max=0.5, dz=1e-4)
    length_unit = "km"
    gamma = 10.0  # 1/(W km)
    alpha = 0.0
    omega0 = 2.0 * np.pi * c0 / 1.55e-6
    om = np.array([omega0, omega0, omega0, omega0], dtype=float)
    P1 = 1e-1
    p_in = np.array([P1, P1, 1e-4, 1e-6], dtype=float)
    phase_in = np.zeros(4, dtype=float)
    pm_cfg = PhaseMatchingConfig(
        method=PhaseMatchingMethod.PROVIDED, provided_delta_beta=0.0
    )
    return run_single_simulation(
        cfg,
        gamma=gamma,
        alpha=alpha,
        omega=om,
        p_in=p_in,
        phase_in=phase_in,
        dispersion=None,
        phase_matching_cfg=pm_cfg,
        beta_legacy=None,
        length_unit=length_unit,
        return_length_unit=length_unit,
    )
