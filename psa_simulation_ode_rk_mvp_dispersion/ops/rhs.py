"""Right-hand side of the scalar 4-wave FWM (Yaman-style) ODE system.

Capability parity with reference ``yaman_model.py``: ``rhs_yaman_simplified``
(:10-52), loss/Kerr/FWM term groups (:123-186) -- re-designed for batching:

- State is ``(..., 4)`` complex (wave order [pump1, pump2, signal, idler]);
  every term broadcasts over arbitrary leading batch axes, so one trace serves
  the single run and the 10^4-instance sweep alike.
- Coefficients arrive *pre-extracted* in a small :class:`RHSCoeffs` pytree.
  The reference re-runs duck-typed attribute extraction on every RHS call --
  4x per RK4 step (``yaman_model.py:46``, ``:59-116``); here lowering happens
  once, outside the hot loop (see ``models/fwm4.lower_params``).
- A *rotating-frame* (autonomous) variant removes the explicit
  ``exp(+-i dbeta z)`` factors by the substitution
  ``A_{1,2} = B_{1,2} exp(+i dbeta z / 2)``, ``A_{3,4} = B_{3,4}``,
  which adds ``-i dbeta/2 B`` to the pump equations and leaves all powers
  identical.  With no large ``dbeta*z`` phase argument, this form is far
  better conditioned in float32 -- the preferred fast path.

Model (lab frame; reference ``yaman_model.py:21-27``):
    dA1/dz = -a/2 A1 + i g[(P1 + 2(P2+P3+P4))A1 + 2 A2* A3 A4 e^{+i db z}]
    dA2/dz = -a/2 A2 + i g[(P2 + 2(P1+P3+P4))A2 + 2 A1* A3 A4 e^{+i db z}]
    dA3/dz = -a/2 A3 + i g[(P3 + 2(P1+P2+P4))A3 + 2 A4* A1 A2 e^{-i db z}]
    dA4/dz = -a/2 A4 + i g[(P4 + 2(P1+P2+P3))A4 + 2 A3* A1 A2 e^{-i db z}]
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from ..utils.checks import check_last_dim


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class RHSCoeffs:
    """Lowered per-instance physics coefficients consumed by the RHS.

    Fields are scalars or arrays of a common batch shape (broadcast against
    the state's leading axes).  Units are per-meter (the internal unit system,
    reference ``simulation.py:13-16``).
    """

    gamma: jax.Array       # Kerr coefficient [1/(W m)]
    alpha: jax.Array       # power attenuation [1/m]
    delta_beta: jax.Array  # phase mismatch [1/m]


def _expand(coef, batch_ndim: int):
    """Broadcast a scalar-or-(batch,) coefficient against (..., 4) state."""
    c = jnp.asarray(coef)
    if c.ndim == 0:
        return c
    return c.reshape(c.shape + (1,) * (1 + batch_ndim - c.ndim))


def _imag_times(x, a):
    """(i * x) * a for real x and complex a, without materializing a complex
    constant ``1j`` (a weak complex128 in eager mode, which would promote
    float32 work to complex128)."""
    ix = jax.lax.complex(jnp.zeros_like(x), x)
    return ix.astype(a.dtype) * a


def kerr_factors(a: jax.Array, self_coef: float = 1.0, cross_coef: float = 2.0) -> jax.Array:
    """SPM/XPM factors F_j = self*P_j + cross * sum_{k != j} P_k
    = cross*P_total + (self - cross)*P_j (a single fused reduction).

    Defaults (1, 2) are the co-polarized model the reference implements
    (``yaman_model.py:135-156``); the polarization-averaged variant the
    reference's test suite encodes (tests.py:256-269: (2/3)P + (4/3)sum) is
    available via :func:`make_rhs_yaman`.
    """
    P = a.real * a.real + a.imag * a.imag
    total = jnp.sum(P, axis=-1, keepdims=True)
    return cross_coef * total + (self_coef - cross_coef) * P


def rhs_yaman(z, a: jax.Array, p: RHSCoeffs) -> jax.Array:
    """Lab-frame RHS with explicit exp(+-i dbeta z) phase factors.

    Numerically matches the reference discretization step-for-step (the
    validation / parity path).  ``z`` is a scalar (shared across the batch --
    all instances integrate the same z-grid); ``a`` is ``(..., 4)`` complex.
    """
    check_last_dim(a, 4, name="a")
    nb = a.ndim - 1
    g = _expand(p.gamma, nb)
    al = _expand(p.alpha, nb)
    db = _expand(p.delta_beta, nb)

    cdt = a.dtype
    rdt = jnp.finfo(cdt).dtype

    F = kerr_factors(a)
    g = g.astype(rdt)
    kerr = _imag_times(g, F * a)
    loss = (-0.5 * al.astype(rdt)) * a

    theta = (db * jnp.asarray(z)).astype(rdt)
    ph = jax.lax.complex(jnp.cos(theta), jnp.sin(theta)).astype(cdt)  # e^{+i db z}
    phc = jnp.conj(ph)

    a1 = a[..., 0:1]
    a2 = a[..., 1:2]
    a3 = a[..., 2:3]
    a4 = a[..., 3:4]
    s34 = a3 * a4
    s12 = a1 * a2
    fwm = _imag_times(2.0 * g, jnp.concatenate(
        [
            ph * (jnp.conj(a2) * s34),
            ph * (jnp.conj(a1) * s34),
            phc * (jnp.conj(a4) * s12),
            phc * (jnp.conj(a3) * s12),
        ],
        axis=-1,
    ))
    return loss + kerr + fwm


def rhs_yaman_autonomous(z, b: jax.Array, p: RHSCoeffs) -> jax.Array:
    """Rotating-frame (autonomous) RHS: no explicit z dependence.

    Substitution ``A_{1,2} = B_{1,2} e^{+i db z/2}``, ``A_{3,4} = B_{3,4}``
    maps the lab-frame system to

        dB1/dz = -a/2 B1 + i g[(F1 - db/(2g)) B1 + 2 B2* B3 B4]
        dB2/dz = -a/2 B2 + i g[(F2 - db/(2g)) B2 + 2 B1* B3 B4]
        dB3/dz = -a/2 B3 + i g[ F3 B3 + 2 B4* B1 B2]
        dB4/dz = -a/2 B4 + i g[ F4 B4 + 2 B3* B1 B2]

    All powers |B_j|^2 == |A_j|^2 exactly; signal/idler phases are unchanged;
    pump phases differ by the known rotation db*z/2.  Preferred in float32:
    the phase argument ``db*z`` (which can reach 10^2-10^3 rad) never has to
    be represented, removing the dominant f32 rounding amplifier.
    """
    check_last_dim(b, 4, name="b")
    nb = b.ndim - 1
    g = _expand(p.gamma, nb)
    al = _expand(p.alpha, nb)
    db = _expand(p.delta_beta, nb)

    rdt = jnp.finfo(b.dtype).dtype
    F = kerr_factors(b)
    g = g.astype(rdt)
    kerr = _imag_times(g, F * b)
    loss = (-0.5 * al.astype(rdt)) * b

    b1 = b[..., 0:1]
    b2 = b[..., 1:2]
    b3 = b[..., 2:3]
    b4 = b[..., 3:4]
    s34 = b3 * b4
    s12 = b1 * b2
    fwm = _imag_times(2.0 * g, jnp.concatenate(
        [
            jnp.conj(b2) * s34,
            jnp.conj(b1) * s34,
            jnp.conj(b4) * s12,
            jnp.conj(b3) * s12,
        ],
        axis=-1,
    ))
    # Pump-only detuning term -i db/2 * B_{1,2}
    neg_half_db = (-0.5) * db.astype(rdt)
    detune = jnp.concatenate(
        [
            _imag_times(neg_half_db, b1),
            _imag_times(neg_half_db, b2),
            jnp.zeros_like(b3),
            jnp.zeros_like(b4),
        ],
        axis=-1,
    )
    return loss + kerr + fwm + detune


def rotating_to_lab(z, b: jax.Array, p: RHSCoeffs) -> jax.Array:
    """Map rotating-frame state B back to lab-frame amplitudes A at z.

    ``z`` broadcasts against ``b``'s *leading* axes (scalar for a single
    state, ``(S,)`` for a trajectory whose state is ``(S, 4)``); the wave axis
    is appended here.
    """
    rdt = jnp.finfo(b.dtype).dtype
    theta = (0.5 * jnp.asarray(p.delta_beta) * jnp.asarray(z)).astype(rdt)
    rot = jax.lax.complex(jnp.cos(theta), jnp.sin(theta)).astype(b.dtype)
    ones = jnp.ones_like(rot)
    factors = jnp.stack(jnp.broadcast_arrays(rot, rot, ones, ones), axis=-1)
    return b * factors


# Reference-named alias (``yaman_model.py:10``): params here is RHSCoeffs.
rhs_yaman_simplified = rhs_yaman


def make_rhs_yaman(
    *,
    frame: str = "lab",
    kerr_self: float = 1.0,
    kerr_cross: float = 2.0,
):
    """Build a 4-wave RHS with custom Kerr SPM/XPM coefficients.

    ``(kerr_self, kerr_cross)``:
    - (1, 2): co-polarized scalar model (reference yaman_model.py:139-151;
      the default everywhere in this framework);
    - (2/3, 4/3): polarization-averaged (Manakov-style) variant -- the model
      the reference's own test suite encodes (tests.py:256-269) but its
      implementation never offered.

    Returns an ``f(z, a, p)`` usable with every integrator in this package.
    """
    if frame not in ("lab", "rotating"):
        raise ValueError("frame must be 'lab' or 'rotating'")
    base = rhs_yaman if frame == "lab" else rhs_yaman_autonomous
    if (kerr_self, kerr_cross) == (1.0, 2.0):
        return base

    def rhs(z, a, p):
        out = base(z, a, p)
        # replace the default Kerr term with the custom-coefficient one
        g = _expand(p.gamma, a.ndim - 1).astype(jnp.finfo(a.dtype).dtype)
        F_default = kerr_factors(a)
        F_custom = kerr_factors(a, kerr_self, kerr_cross)
        return out + _imag_times(g, (F_custom - F_default) * a)

    return rhs
