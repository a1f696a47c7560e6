"""Numerical simulation configuration (two-tier config split: numerics here,
physics in ``models/fwm4.py`` parameter pytrees -- the separation the
reference established in ``config.py`` vs ``parameters.py``).

Capability parity: reference ``config.py`` (``SimulationConfig`` :7-30,
``default_simulation_config`` :33-47, ``custom_simulation_config`` :49-70,
``validate_config`` :73-93).  Extensions over the reference:

- ``integrator`` accepts ``'rk4'`` (fixed step), ``'rk45'`` (embedded
  adaptive Dormand-Prince), and the fixed-step Adams throughput methods
  ``'ab4'``/``'abm4'`` (4th order at 1 / 2 RHS evaluations per step vs
  RK4's 4; supported by the comb engines (models/nwave.py incl. the fused
  pallas kernel) and the 4-wave family (runner, sweeps incl. the df32
  scan + grouped pallas engines); the SSFM families (GNLSE/vector) raise
  instead of silently degrading) -- the reference validated the slot but
  only ever dispatched rk4 (``config.py:89``).  NOTE on accuracy: a
  different stepper at the same dz is a different trajectory (AB4's error
  constant is ~40x RK4's); the <=1e-9 matched-tolerance claim is
  *same-method* parity (df32-ab4 vs x64-ab4), not vs the reference's rk4.
- ``integrator='rk4ip'`` (interaction-picture RK4, Hult 2007) is the
  4th-order fixed-step method for the split-step families (GNLSE +
  vector; scalar/vector, scan paths, batch + sharded): O(dz^4) vs the
  Strang split's O(dz^2) at ~2x the per-step transform cost -- the
  equal-accuracy throughput integrator for pulse runs.  ODE families
  (4-wave, comb, SBS) refuse it loudly (``reject_non_ode``).
- ``integrator='rk4ip45'`` is the ADAPTIVE interaction-picture RK4 for
  the same families: step-doubling local-error control at
  ``rtol``/``atol`` (like ``'rk45'``) but on the 4th-order RK4IP step --
  O(h^5) local error, controller exponent 1/5, order-4 Richardson
  acceptance state.  At tight tolerances it takes far larger steps than
  the 2nd-order Strang controller.
- ``precision`` selects the dtype tier (``'x64'`` reference-parity f64,
  ``'x32'`` f32, ``'df32'`` compensated two-float32; see
  ``utils/precision.py``).

``z_max``/``dz`` are in whatever length unit the runner is told
(``length_unit``, reference ``simulation.py:240``); internally everything is
converted to meters.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

VALID_INTEGRATORS = ("rk4", "rk45", "ab4", "abm4", "rk4ip", "rk4ip45")
MULTISTEP_INTEGRATORS = ("ab4", "abm4")
SSFM_INTEGRATORS = ("rk4ip", "rk4ip45")   # split-step families only
ADAPTIVE_INTEGRATORS = ("rk45", "rk4ip45")  # use cfg.rtol/atol/max_steps


def reject_multistep(cfg: "SimulationConfig", where: str) -> None:
    """Families without an Adams path must refuse loudly, not silently run
    rk4 (the round-1 silent-integrator bug class).  This guard covers ONLY
    ab4/abm4 — a non-split-step family must ALSO call
    :func:`reject_non_ode` to refuse rk4ip/rk4ip45."""
    integ = cfg.integrator.lower()
    if integ in MULTISTEP_INTEGRATORS:
        raise ValueError(
            f"integrator={cfg.integrator!r} is not supported by {where}; "
            "multistep (ab4/abm4) is available for the comb engines "
            "(models/nwave.py) and the 4-wave family (models/fwm4.py, "
            "parallel/sweep.py) -- use 'rk4' or 'rk45' here"
        )


def reject_non_ode(cfg: "SimulationConfig", where: str) -> None:
    """ODE families (4-wave, comb, SBS): refuse the split-step-only
    'rk4ip' loudly -- it has no meaning without a linear/nonlinear split."""
    if cfg.integrator.lower() in SSFM_INTEGRATORS:
        raise ValueError(
            f"integrator={cfg.integrator!r} is not supported by {where}; "
            "rk4ip/rk4ip45 (interaction-picture RK4, fixed/adaptive) apply "
            "to the split-step families (models/gnlse.py, models/vgnlse.py) "
            "-- use 'rk4', 'rk45' or ab4/abm4 here"
        )


@dataclass(frozen=True)
class SimulationConfig:
    # ---- Geometry (in the runner's length_unit) ----
    z_max: float
    dz: float

    # ---- Numerical method ----
    integrator: str = "rk4"

    # ---- Evaluation control ----
    save_every: int = 10
    check_nan: bool = True
    verbose: bool = False

    # ---- Precision tier (framework extension) ----
    precision: str = "x64"

    # ---- Adaptive (rk45) controls; ignored for rk4 ----
    rtol: float = 1e-9
    atol: float = 1e-12
    max_steps: int = 1_000_000


def default_simulation_config() -> SimulationConfig:
    """Reference defaults (``config.py:33-47``): z_max=0.5, dz=1e-3,
    save_every=10 -- interpreted in the runner's length_unit."""
    return SimulationConfig(
        z_max=0.5,
        dz=1e-3,
        integrator="rk4",
        save_every=10,
        check_nan=True,
        verbose=False,
    )


def custom_simulation_config(
    *,
    z_max: float = 1.0,
    dz: float = 1e-3,
    integrator: str = "rk4",
    save_every: int = 10,
    check_nan: bool = True,
    verbose: bool = False,
    precision: str = "x64",
    rtol: float = 1e-9,
    atol: float = 1e-12,
    max_steps: int = 1_000_000,
) -> SimulationConfig:
    return SimulationConfig(
        z_max=z_max,
        dz=dz,
        integrator=integrator,
        save_every=save_every,
        check_nan=check_nan,
        verbose=verbose,
        precision=precision,
        rtol=rtol,
        atol=atol,
        max_steps=max_steps,
    )


def validate_config(cfg: SimulationConfig) -> None:
    """Raise ``ValueError`` for invalid configs (reference ``config.py:73-93``)."""
    if cfg.z_max <= 0.0:
        raise ValueError("z_max must be positive")

    if cfg.dz <= 0.0:
        raise ValueError("dz must be positive")

    if cfg.dz > cfg.z_max:
        raise ValueError("dz must be smaller than z_max")

    if cfg.integrator.lower() not in VALID_INTEGRATORS:
        raise ValueError(f"Unsupported integrator: {cfg.integrator}")

    if cfg.save_every <= 0:
        raise ValueError("save_every must be a positive integer")

    from .utils.precision import validate_precision

    validate_precision(cfg.precision)

    if cfg.integrator.lower() in ADAPTIVE_INTEGRATORS:
        if cfg.rtol <= 0.0 or cfg.atol < 0.0:
            raise ValueError(
                f"{cfg.integrator} requires rtol > 0 and atol >= 0")
        if cfg.max_steps <= 0:
            raise ValueError("max_steps must be positive")


def with_updates(cfg: SimulationConfig, **kwargs) -> SimulationConfig:
    return replace(cfg, **kwargs)
