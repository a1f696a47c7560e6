"""Phase-matching strategy layer: how the phase mismatch dbeta is computed.

Capability parity with reference ``phase_matching.py``: the
``PhaseMatchingMethod`` enum (:50-53), ``PhaseMatchingConfig`` (:77-138),
``PhaseMatchingResult`` (:141-147), ``compute_phase_mismatch`` (:150-215) and
``PhaseMismatchCalculator`` (:218-243).

Design notes:

- The method and order selection are *static* Python values; dispatch happens
  at trace time, so the chosen formula compiles to a single fused expression.
- ``compute_phase_mismatch`` is batch-aware: pass ``omegas`` with shape
  ``(B, 4)`` (or any leading batch shape) and the mismatch comes back with the
  batch shape, computed in one vectorized evaluation -- this is what lets the
  sweep engine evaluate an entire spectrum's dbeta in one shot instead of the
  reference's per-point Python loop (``scan_mismtach.py:694-706``).
"""

from __future__ import annotations

import dataclasses
from enum import Enum
from typing import Optional, Tuple

import jax
import numpy as np
import jax.numpy as jnp

from ..utils.checks import check_last_dim, check_positive, is_concrete, to_scalar_float, xp
from .dispersion import DispersionParams, delta_beta_from_omegas, delta_beta_symmetric
from .frequency_plan import SymmetricPlan, infer_symmetry_from_omegas


class PhaseMatchingMethod(str, Enum):
    GENERAL_TAYLOR = "general_taylor"
    SYMMETRIC_EVEN = "symmetric_even"
    PROVIDED = "provided"


@dataclasses.dataclass(frozen=True)
class PhaseMatchingConfig:
    """Configuration for dbeta computation (static / hashable; lives on the
    host side of the jit boundary).

    - ``GENERAL_TAYLOR``: dbeta from beta(omega_j) Taylor model up to
      ``max_order``.
    - ``SYMMETRIC_EVEN``: even-order closed form over ``even_orders``.
    - ``PROVIDED``: use ``provided_delta_beta`` (scalar or batch array).
    """

    method: PhaseMatchingMethod = PhaseMatchingMethod.SYMMETRIC_EVEN
    max_order: int = 4
    even_orders: Tuple[int, ...] = (2, 4)
    atol: float = 0.0
    rtol: float = 1e-12
    provided_delta_beta: Optional[object] = None  # float or array for batches

    def __post_init__(self):
        if not isinstance(self.method, PhaseMatchingMethod):
            try:
                object.__setattr__(self, "method", PhaseMatchingMethod(str(self.method)))
            except Exception as e:  # noqa: BLE001
                raise ValueError(f"Invalid method {self.method!r}") from e

        if not isinstance(self.max_order, int) or self.max_order < 0:
            raise ValueError(f"max_order must be int >= 0, got {self.max_order!r}")

        ev = tuple(self.even_orders)
        if len(ev) == 0:
            raise ValueError("even_orders must not be empty (e.g., (2,4))")
        for n in ev:
            if not isinstance(n, int):
                raise TypeError("even_orders must contain ints")
            if n < 2 or (n % 2) != 0:
                raise ValueError(f"even_orders must contain even ints >= 2, got {n!r}")
        object.__setattr__(self, "even_orders", ev)

        a = to_scalar_float(self.atol, name="atol")
        r = to_scalar_float(self.rtol, name="rtol")
        if a < 0.0 or r < 0.0:
            raise ValueError("atol and rtol must be >= 0")
        object.__setattr__(self, "atol", a)
        object.__setattr__(self, "rtol", r)

        if self.method == PhaseMatchingMethod.PROVIDED:
            if self.provided_delta_beta is None:
                raise ValueError("provided_delta_beta must be set when method == 'provided'")

    def scaled(self, length_scale_to_m: float) -> "PhaseMatchingConfig":
        """Rescale a PROVIDED dbeta from 1/length_unit to 1/m (parity:
        reference ``simulation.py:153-175``); other methods pass through."""
        if self.method != PhaseMatchingMethod.PROVIDED:
            return self
        s = float(length_scale_to_m)
        if s == 1.0:
            return self
        pdb = np.asarray(self.provided_delta_beta, dtype=float) / s
        return dataclasses.replace(
            self, provided_delta_beta=pdb if pdb.ndim else float(pdb)
        )


@dataclasses.dataclass(frozen=True)
class PhaseMatchingResult:
    """dbeta (scalar or batch array) plus the symmetric variables when the
    symmetric route was used.  Parity: reference ``phase_matching.py:141-147``."""

    delta_beta: jax.Array
    symmetric: Optional[SymmetricPlan] = None


def compute_phase_mismatch(
    omegas,
    disp: Optional[DispersionParams],
    cfg: PhaseMatchingConfig,
    *,
    symmetric_hint: Optional[SymmetricPlan] = None,
) -> PhaseMatchingResult:
    """Compute dbeta for ``omegas`` of shape ``(..., 4)``.

    Parity: reference ``phase_matching.py:150-215``; batch-aware.
    """
    om = xp(omegas).asarray(omegas)
    check_last_dim(om, 4, name="omegas")
    check_positive(om, name="omegas")

    if cfg.method == PhaseMatchingMethod.PROVIDED:
        pdb = cfg.provided_delta_beta
        db = xp(pdb).asarray(pdb, dtype=np.float64 if is_concrete(pdb) else jnp.float64)
        return PhaseMatchingResult(delta_beta=db, symmetric=None)

    if disp is None:
        raise ValueError("disp must be provided unless method == 'provided'")

    if cfg.method == PhaseMatchingMethod.GENERAL_TAYLOR:
        db = delta_beta_from_omegas(
            om, disp, max_order=cfg.max_order, atol=cfg.atol, rtol=cfg.rtol
        )
        return PhaseMatchingResult(delta_beta=db, symmetric=None)

    if cfg.method == PhaseMatchingMethod.SYMMETRIC_EVEN:
        sp = symmetric_hint
        if sp is None:
            sp = infer_symmetry_from_omegas(
                om[..., 0], om[..., 1], om[..., 2], om[..., 3],
                atol=cfg.atol, rtol=cfg.rtol,
            )
        db = delta_beta_symmetric(
            sp.omega_c, sp.omega_d, sp.Omega, disp, even_orders=cfg.even_orders
        )
        return PhaseMatchingResult(delta_beta=db, symmetric=sp)

    raise ValueError(f"Unsupported phase-matching method: {cfg.method!r}")


@dataclasses.dataclass(frozen=True)
class PhaseMismatchCalculator:
    """Callable computing dbeta repeatedly with fixed config/dispersion.
    Parity: reference ``phase_matching.py:218-243``."""

    disp: Optional[DispersionParams]
    cfg: PhaseMatchingConfig

    def __call__(
        self, omegas, *, symmetric_hint: Optional[SymmetricPlan] = None
    ) -> PhaseMatchingResult:
        return compute_phase_mismatch(
            omegas, self.disp, self.cfg, symmetric_hint=symmetric_hint
        )


def dispersion_at_pump_center(lambda_p1, lambda_p2, lambda_signal0, *, D, S):
    """Build :class:`~.dispersion.DispersionParams` from D/S expanded at the
    pump-center frequency omega_c -- the expansion point the SYMMETRIC_EVEN
    delta-beta formula assumes (beta(omega) is evaluated at +-omega_d and
    +-Omega AROUND omega_c, so D and S must be referenced there; expanding
    anywhere else silently shifts every computed mismatch).  This is the
    parity default the experiment entry points share (reference analog:
    main.py:224-231, where dispersion_params_from_D_S is always called at
    the inferred omega_c).

    Returns ``(omega (4,), symmetric_plan, dispersion)`` for the plan built
    from the two pumps and the first signal wavelength.
    """
    from .dispersion import dispersion_params_from_D_S
    from .frequency_plan import lambda_from_omega, plan_from_wavelengths

    omega = np.asarray(
        plan_from_wavelengths(lambda_p1, lambda_p2, lambda_signal0)
    )
    sp = infer_symmetry_from_omegas(omega[0], omega[1], omega[2], omega[3])
    disp = dispersion_params_from_D_S(
        lambda_ref_m=float(lambda_from_omega(sp.omega_c)),
        D=D, S=S, dSdlmbd=0,
        D_units="ps/nm/km", S_units="ps/nm^2/km", dSdlmbd_units="ps/nm^3/km",
        omega_ref=float(np.asarray(sp.omega_c)),
    )
    return omega, sp, disp
