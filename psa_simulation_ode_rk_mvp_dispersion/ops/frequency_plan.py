"""Frequency-plan utilities for four-wave mixing, vectorized for batching.

Capability parity with reference ``frequency_plan.py`` (lambda/f/omega
conversions :89-98, ``SymmetricPlan`` :134-199, energy conservation :112-131,
``infer_symmetry_from_omegas`` :215-255, ``plan_from_*`` builders :202-327,
``describe_plan`` :330-350) -- re-designed so every function broadcasts over
arbitrary batch shapes: the sweep engine builds a whole spectrum's worth of
frequency plans as one ``(B, 4)`` array in a single traced expression.

Wave order across the project:
    [pump1, pump2, signal, idler] -> [omega1, omega2, omega3, omega4]

Symmetric parametrization:
    omega_c = (omega1 + omega2)/2,  omega_d = (omega1 - omega2)/2,
    Omega   = omega3 - omega_c
    omega1 = omega_c + omega_d, omega2 = omega_c - omega_d,
    omega3 = omega_c + Omega,   omega4 = omega_c - Omega

Energy conservation: omega1 + omega2 = omega3 + omega4.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import numpy as np

from ..constants import c, TWO_PI
from ..utils.checks import (
    check_finite,
    check_last_dim,
    check_positive,
    is_concrete,
    xp,
)

WAVE_ORDER: Tuple[str, str, str, str] = ("pump1", "pump2", "signal", "idler")


# ---------------------------------------------------------------------------
# Scalar/array conversions (broadcast over any shape)
# ---------------------------------------------------------------------------

def omega_from_f(f_hz):
    """f [Hz] -> omega [rad/s]."""
    check_positive(f_hz, name="f_hz")
    return TWO_PI * xp(f_hz).asarray(f_hz)


def f_from_omega(omega):
    """omega [rad/s] -> f [Hz]."""
    check_positive(omega, name="omega")
    return xp(omega).asarray(omega) / TWO_PI


def omega_from_lambda(lambda_m):
    """Vacuum wavelength [m] -> omega [rad/s]: omega = 2*pi*c/lambda."""
    check_positive(lambda_m, name="lambda_m")
    return TWO_PI * c / xp(lambda_m).asarray(lambda_m)


def lambda_from_omega(omega):
    """omega [rad/s] -> vacuum wavelength [m]: lambda = 2*pi*c/omega."""
    check_positive(omega, name="omega")
    return TWO_PI * c / xp(omega).asarray(omega)


# ---------------------------------------------------------------------------
# Energy conservation
# ---------------------------------------------------------------------------

def energy_conservation_residual(omega):
    """(omega1 + omega2) - (omega3 + omega4) over the trailing wave axis."""
    om = xp(omega).asarray(omega)
    check_last_dim(om, 4, name="omega")
    return (om[..., 0] + om[..., 1]) - (om[..., 2] + om[..., 3])


def enforce_energy_conservation(omega, *, atol: float = 0.0, rtol: float = 1e-12) -> None:
    """Validate omega1+omega2 == omega3+omega4 within tolerance.

    Raises ``ValueError`` on concrete inputs (reference
    ``frequency_plan.py:112-131``); silently skipped on tracers (the sweep
    engine masks invalid instances instead).
    """
    om = omega
    check_last_dim(om, 4, name="omega")
    if not is_concrete(om):
        return
    a = np.asarray(om)
    lhs = a[..., 0] + a[..., 1]
    rhs = a[..., 2] + a[..., 3]
    bad = ~np.isclose(lhs, rhs, atol=atol, rtol=rtol)
    if np.any(bad):
        i = np.argwhere(np.atleast_1d(bad))[0]
        lhs_b = float(np.atleast_1d(lhs)[tuple(i)])
        rhs_b = float(np.atleast_1d(rhs)[tuple(i)])
        raise ValueError(
            "Energy conservation violated: omega1+omega2 != omega3+omega4. "
            f"(lhs={lhs_b:.16e}, rhs={rhs_b:.16e}, diff={(lhs_b - rhs_b):.16e})"
        )


# ---------------------------------------------------------------------------
# Symmetric plan
# ---------------------------------------------------------------------------

@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class SymmetricPlan:
    """Symmetric frequency-plan parameters (batchable pytree).

    Fields may be scalars or arrays of a common batch shape; all derived
    quantities broadcast.  Parity: reference ``frequency_plan.py:134-199``.
    """

    omega_c: jax.Array  # (omega1 + omega2)/2  [rad/s]
    omega_d: jax.Array  # (omega1 - omega2)/2  [rad/s]
    Omega: jax.Array    # omega3 - omega_c     [rad/s]

    def __post_init__(self):
        if is_concrete(self.omega_c, self.omega_d, self.Omega):
            oc = np.asarray(self.omega_c, dtype=float)
            od = np.asarray(self.omega_d, dtype=float)
            if not (np.all(np.isfinite(oc)) and np.all(oc > 0.0)):
                raise ValueError("omega_c must be finite and > 0 (rad/s)")
            check_finite(od, name="omega_d")
            check_finite(np.asarray(self.Omega, dtype=float), name="Omega")
            if np.any(np.abs(od) >= oc):
                raise ValueError(
                    "Invalid symmetric plan: |omega_d| must be < omega_c to keep "
                    "omega1, omega2 positive."
                )

    @property
    def omega1(self):
        m = xp(self.omega_c, self.omega_d)
        return m.asarray(self.omega_c) + m.asarray(self.omega_d)

    @property
    def omega2(self):
        m = xp(self.omega_c, self.omega_d)
        return m.asarray(self.omega_c) - m.asarray(self.omega_d)

    @property
    def omega3(self):
        m = xp(self.omega_c, self.Omega)
        return m.asarray(self.omega_c) + m.asarray(self.Omega)

    @property
    def omega4(self):
        m = xp(self.omega_c, self.Omega)
        return m.asarray(self.omega_c) - m.asarray(self.Omega)

    def omegas(self) -> jax.Array:
        """Stack to project wave order ``(..., 4)``; validates positivity on
        concrete inputs (reference ``frequency_plan.py:184-199``)."""
        m = xp(self.omega_c, self.omega_d, self.Omega)
        om = m.stack(
            m.broadcast_arrays(self.omega1, self.omega2, self.omega3, self.omega4),
            axis=-1,
        )
        if is_concrete(om):
            a = np.asarray(om)
            if np.any(a <= 0.0):
                raise ValueError(
                    "This symmetric plan produces non-positive omega for "
                    "signal/idler. Adjust Omega and/or omega_c."
                )
            enforce_energy_conservation(om)
        return om


def plan_from_symmetry(omega_c, omega_d, Omega) -> jax.Array:
    """Build ``(..., 4)`` omegas from symmetric parameters."""
    m = xp(omega_c, omega_d, Omega)
    return SymmetricPlan(
        omega_c=m.asarray(omega_c), omega_d=m.asarray(omega_d), Omega=m.asarray(Omega)
    ).omegas()


def infer_symmetry_from_omegas(
    omega1,
    omega2,
    omega3,
    omega4=None,
    *,
    atol: float = 0.0,
    rtol: float = 1e-12,
) -> SymmetricPlan:
    """Infer (omega_c, omega_d, Omega) from omega1..3 (+ optional omega4 check).

    Parity: reference ``frequency_plan.py:215-255``.  Broadcasts over batch
    shapes.
    """
    m = xp(omega1, omega2, omega3, omega4)
    w1 = m.asarray(omega1)
    w2 = m.asarray(omega2)
    w3 = m.asarray(omega3)
    check_positive(w1, name="omega1")
    check_positive(w2, name="omega2")
    check_positive(w3, name="omega3")

    omega_c = 0.5 * (w1 + w2)
    omega_d = 0.5 * (w1 - w2)
    Omega = w3 - omega_c
    sp = SymmetricPlan(omega_c=omega_c, omega_d=omega_d, Omega=Omega)

    if omega4 is None:
        w4 = w1 + w2 - w3
        check_positive(w4, name="omega4(inferred)")
    else:
        w4 = m.asarray(omega4)
        check_positive(w4, name="omega4")
        if is_concrete(w1, w2, w3, w4):
            om = np.stack(np.broadcast_arrays(
                np.asarray(w1), np.asarray(w2), np.asarray(w3), np.asarray(w4)), axis=-1)
            enforce_energy_conservation(om, atol=atol, rtol=rtol)
            om4_sym = np.asarray(sp.omega4)
            if not np.allclose(om4_sym, np.asarray(w4), atol=atol, rtol=max(rtol, 1e-12)):
                raise ValueError(
                    "Inferred symmetric parameters are inconsistent with omega4."
                )
    return sp


def plan_from_omegas(
    omega1,
    omega2,
    omega3,
    omega4=None,
    *,
    atol: float = 0.0,
    rtol: float = 1e-12,
) -> jax.Array:
    """Build ``(..., 4)`` omegas; omega4 inferred from energy conservation when
    omitted.  Parity: reference ``frequency_plan.py:258-288``."""
    m = xp(omega1, omega2, omega3, omega4)
    w1 = m.asarray(omega1)
    w2 = m.asarray(omega2)
    w3 = m.asarray(omega3)
    check_positive(w1, name="omega1")
    check_positive(w2, name="omega2")
    check_positive(w3, name="omega3")

    if omega4 is None:
        w4 = w1 + w2 - w3
        check_positive(w4, name="omega4(inferred)")
    else:
        w4 = m.asarray(omega4)
        check_positive(w4, name="omega4")

    om = m.stack(m.broadcast_arrays(w1, w2, w3, w4), axis=-1)
    enforce_energy_conservation(om, atol=atol, rtol=rtol)
    return om


def plan_from_wavelengths(
    lambda1_m,
    lambda2_m,
    lambda3_m,
    lambda4_m=None,
    *,
    atol: float = 0.0,
    rtol: float = 1e-12,
) -> jax.Array:
    """Build ``(..., 4)`` omegas from vacuum wavelengths [m].

    Energy conservation is exact in omega-space (reference
    ``frequency_plan.py:291-327``), so conversion happens first, then the
    missing wave is inferred in omega.  ``lambda3_m`` may be a batch array --
    the primary entry point for gain-spectrum sweeps.
    """
    w1 = omega_from_lambda(lambda1_m)
    w2 = omega_from_lambda(lambda2_m)
    w3 = omega_from_lambda(lambda3_m)
    w4 = None if lambda4_m is None else omega_from_lambda(lambda4_m)
    return plan_from_omegas(w1, w2, w3, w4, atol=atol, rtol=rtol)


def describe_plan(omega) -> str:
    """Human-readable multi-line description of a single (4,) plan.

    Parity: reference ``frequency_plan.py:330-350``.
    """
    om = np.asarray(omega, dtype=float)
    if om.shape != (4,):
        raise ValueError(f"omega must have shape (4,), got {om.shape}")
    check_positive(om, name="omega")
    lam = TWO_PI * c / om
    f = om / TWO_PI

    lines = ["Frequency plan (wave order: pump1, pump2, signal, idler):"]
    for i, label in enumerate(WAVE_ORDER):
        lines.append(
            f"  {label:6s}: "
            f"omega={om[i]: .16e} rad/s, "
            f"f={f[i]: .16e} Hz, "
            f"lambda={lam[i]: .16e} m"
        )
    lines.append(
        f"  Check: omega1+omega2 - (omega3+omega4) = {(om[0] + om[1]) - (om[2] + om[3]): .16e} rad/s"
    )
    return "\n".join(lines)
