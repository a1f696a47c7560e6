"""RHS physics-term tests (parity with reference tests.py:229-278 TestYamanModel,
plus rotating-frame equivalence and batch broadcasting)."""

import numpy as np
import jax.numpy as jnp
import pytest

from psa_simulation_ode_rk_mvp_dispersion.ops import integrators as integ
from psa_simulation_ode_rk_mvp_dispersion.ops.rhs import (
    RHSCoeffs,
    kerr_factors,
    rhs_yaman,
    rhs_yaman_autonomous,
    rotating_to_lab,
)


def _coeffs(gamma=1.3, alpha=0.0, dbeta=0.0):
    return RHSCoeffs(
        gamma=jnp.asarray(gamma), alpha=jnp.asarray(alpha), delta_beta=jnp.asarray(dbeta)
    )


def test_rhs_shape_and_dtype():
    a = jnp.asarray([0.5 + 0.1j, 0.4 - 0.2j, 0.01 + 0j, 0.0 + 0j], dtype=jnp.complex128)
    out = rhs_yaman(0.0, a, _coeffs())
    assert out.shape == (4,)
    assert out.dtype == jnp.complex128


def test_rhs_rejects_wrong_shape():
    with pytest.raises(ValueError):
        rhs_yaman(0.0, jnp.zeros(3, dtype=jnp.complex128), _coeffs())


def test_kerr_term_closed_form():
    """F_j = P_j + 2 sum_{k != j} P_k (reference yaman_model.py:135-156)."""
    rng = np.random.default_rng(1)
    a = rng.normal(size=4) + 1j * rng.normal(size=4)
    P = np.abs(a) ** 2
    expected = np.array([P[j] + 2 * (P.sum() - P[j]) for j in range(4)])
    got = np.asarray(kerr_factors(jnp.asarray(a)))
    np.testing.assert_allclose(got, expected, rtol=1e-14)


def test_kerr_only_dynamics():
    """With signal=idler=0 and no loss, pump powers are conserved and phases
    rotate at gamma*F_j (pure SPM/XPM): A_j(z) = A_j(0) e^{i gamma F_j z}."""
    gamma = 1.3
    a0 = np.array([np.sqrt(0.5), np.sqrt(0.3), 0.0, 0.0], dtype=np.complex128)
    P = np.abs(a0) ** 2
    F = np.array([P[j] + 2 * (P.sum() - P[j]) for j in range(4)])
    res = integ.integrate_fixed_grid(
        rhs_yaman, jnp.asarray(a0), _coeffs(gamma=gamma),
        z0=0.0, dz=1e-3, n_steps=1000, save_every=1000,
    )
    a_end = np.asarray(res.y_final)
    expected = a0 * np.exp(1j * gamma * F * 1.0)
    np.testing.assert_allclose(a_end, expected, rtol=1e-10, atol=1e-12)


def test_fwm_terms_vanish_when_sidebands_zero_and_idler_growth():
    """With A3=A4=0, dA3/dz = dA4/dz = 0 only if A1*A2=0; with both pumps on,
    the FWM source term drives the sidebands (reference tests.py:271-278
    intent, corrected: signal/idler growth requires the pump product)."""
    # Only pump1 on: no FWM source anywhere.
    a = jnp.asarray([1.0 + 0j, 0.0, 0.0, 0.0])
    out = np.asarray(rhs_yaman(0.3, a, _coeffs(gamma=2.0, dbeta=1.0)))
    # dA1 has only SPM; dA2..4 must vanish
    np.testing.assert_allclose(out[1:], 0.0, atol=1e-15)
    # Both pumps on: sidebands stay zero-derivative (A3*, A4* factors are 0)
    a = jnp.asarray([1.0 + 0j, 1.0 + 0j, 0.0, 0.0])
    out = np.asarray(rhs_yaman(0.3, a, _coeffs(gamma=2.0, dbeta=1.0)))
    np.testing.assert_allclose(out[2:], 0.0, atol=1e-15)
    # Seeded signal: idler must now be driven (conj(A3) A1 A2 term)
    a = jnp.asarray([1.0 + 0j, 1.0 + 0j, 1e-3 + 0j, 0.0])
    out = np.asarray(rhs_yaman(0.3, a, _coeffs(gamma=2.0, dbeta=1.0)))
    assert abs(out[3]) > 0.0


def test_linear_loss_only():
    """gamma=0: pure attenuation, A(z) = A0 e^{-alpha z / 2} exactly."""
    alpha = 0.21
    a0 = np.array([0.7, 0.6, 0.01, 0.002], dtype=np.complex128)
    res = integ.integrate_fixed_grid(
        rhs_yaman, jnp.asarray(a0), _coeffs(gamma=0.0, alpha=alpha),
        z0=0.0, dz=1e-2, n_steps=100, save_every=100,
    )
    np.testing.assert_allclose(
        np.asarray(res.y_final), a0 * np.exp(-alpha / 2.0), rtol=1e-12
    )


def test_total_power_conserved_lossless():
    """Manley-Rowe / energy: sum_j |A_j|^2 is invariant when alpha=0."""
    a0 = np.array([0.6, 0.55, 0.01, 0.0], dtype=np.complex128)
    res = integ.integrate_fixed_grid(
        rhs_yaman, jnp.asarray(a0), _coeffs(gamma=9.0, dbeta=2.0),
        z0=0.0, dz=1e-3, n_steps=2000, save_every=100,
    )
    P_tot = np.sum(np.abs(np.asarray(res.y_saved)) ** 2, axis=-1)
    np.testing.assert_allclose(P_tot, P_tot[0], rtol=1e-9)


def test_total_power_tracks_exp_alpha_z():
    """With loss, sum_j |A_j|^2 = P_tot(0) e^{-alpha z} (measured invariant of
    the reference run, SURVEY.md section 6)."""
    alpha = 0.05
    a0 = np.array([0.6, 0.55, 0.01, 0.0], dtype=np.complex128)
    res = integ.integrate_fixed_grid(
        rhs_yaman, jnp.asarray(a0), _coeffs(gamma=9.0, alpha=alpha, dbeta=2.0),
        z0=0.0, dz=1e-3, n_steps=2000, save_every=200,
    )
    P_tot = np.sum(np.abs(np.asarray(res.y_saved)) ** 2, axis=-1)
    z = np.asarray(res.z_saved)
    np.testing.assert_allclose(P_tot, P_tot[0] * np.exp(-alpha * z), rtol=1e-10)


def test_rotating_frame_equivalence():
    """Rotating-frame solve converted back to lab frame agrees with the
    lab-frame solve to RK4 discretization accuracy; powers agree tightly."""
    a0 = np.array([np.sqrt(0.5), np.sqrt(0.5), 1e-3, 1e-4], dtype=np.complex128)
    p = _coeffs(gamma=10.0, alpha=0.02, dbeta=3.0)

    lab = integ.integrate_fixed_grid(
        rhs_yaman, jnp.asarray(a0), p, z0=0.0, dz=1e-3, n_steps=2000, save_every=200
    )
    rot = integ.integrate_fixed_grid(
        rhs_yaman_autonomous, jnp.asarray(a0), p,
        z0=0.0, dz=1e-3, n_steps=2000, save_every=200,
    )
    A_rot = np.asarray(rotating_to_lab(rot.z_saved, rot.y_saved, p))
    A_lab = np.asarray(lab.y_saved)
    # The two frames are different (equally valid) RK4 discretizations of the
    # same ODE; they agree to truncation error, not to rounding error.
    np.testing.assert_allclose(np.abs(A_rot) ** 2, np.abs(A_lab) ** 2, rtol=1e-6)
    np.testing.assert_allclose(A_rot, A_lab, rtol=1e-6, atol=1e-12)


def test_batched_rhs_broadcasts():
    rng = np.random.default_rng(2)
    a = jnp.asarray(rng.normal(size=(5, 4)) + 1j * rng.normal(size=(5, 4)))
    gammas = jnp.asarray(rng.uniform(1.0, 3.0, size=5))
    p = RHSCoeffs(gamma=gammas, alpha=jnp.zeros(5), delta_beta=jnp.asarray(rng.normal(size=5)))
    out = np.asarray(rhs_yaman(0.7, a, p))
    assert out.shape == (5, 4)
    for i in range(5):
        pi = RHSCoeffs(
            gamma=gammas[i], alpha=jnp.asarray(0.0), delta_beta=p.delta_beta[i]
        )
        np.testing.assert_allclose(
            out[i], np.asarray(rhs_yaman(0.7, a[i], pi)), rtol=1e-14
        )


def test_polarization_averaged_kerr_variant():
    """make_rhs_yaman((2/3, 4/3)) implements the Manakov-style Kerr variant
    the reference's test suite encodes (tests.py:256-269 intent)."""
    from psa_simulation_ode_rk_mvp_dispersion.ops.rhs import make_rhs_yaman

    rng = np.random.default_rng(5)
    a = rng.normal(size=4) + 1j * rng.normal(size=4)
    gamma = 1.7
    p = _coeffs(gamma=gamma, alpha=0.0, dbeta=0.0)
    rhs = make_rhs_yaman(kerr_self=2.0 / 3.0, kerr_cross=4.0 / 3.0)
    out = np.asarray(rhs(0.0, jnp.asarray(a), p))
    # subtract FWM part (from the default rhs minus its Kerr) to isolate Kerr
    P = np.abs(a) ** 2
    F = (2.0 / 3.0) * P + (4.0 / 3.0) * (P.sum() - P)
    kerr_expected = 1j * gamma * F * a
    default = np.asarray(rhs_yaman(0.0, jnp.asarray(a), p))
    F_def = np.array([P[j] + 2 * (P.sum() - P[j]) for j in range(4)])
    fwm_part = default - 1j * gamma * F_def * a
    np.testing.assert_allclose(out, fwm_part + kerr_expected, rtol=1e-12)
    # default coefficients return the standard functions unchanged
    assert make_rhs_yaman() is rhs_yaman
