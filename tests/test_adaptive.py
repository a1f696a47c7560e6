"""Adaptive RK45 (Dormand-Prince) integrator tests: analytic accuracy,
agreement with fixed RK4 on the FWM model, vmapped per-lane adaptivity,
failure masking, and the rk45 runner path."""

import jax
import numpy as np
import jax.numpy as jnp
import pytest

import psa
from psa_simulation_ode_rk_mvp_dispersion.ops import adaptive as ad
from psa_simulation_ode_rk_mvp_dispersion.ops import integrators as integ
from psa_simulation_ode_rk_mvp_dispersion.ops.rhs import RHSCoeffs, rhs_yaman


def _rhs_exp(z, y, params):
    return params * y


def test_rk45_step_order():
    """Single DP step on y' = y: 5th-order local error."""
    for dz in (0.1, 0.05):
        y5, err = ad.rk45_step(_rhs_exp, 0.0, jnp.asarray([1.0]), dz, 1.0)
        local = abs(float(y5[0]) - np.exp(dz))
        assert local < 2.0 * dz**6 + 1e-14
        assert abs(float(err[0])) < 1e-5


def test_adaptive_grid_vs_exp():
    zg = np.linspace(0.0, 2.0, 9)
    res = ad.integrate_adaptive_grid(
        _rhs_exp, jnp.asarray([1.0]), 1.0, z_grid=zg, rtol=1e-10, atol=1e-12
    )
    assert bool(res.ok)
    np.testing.assert_allclose(
        np.asarray(res.y_saved)[:, 0], np.exp(zg), rtol=1e-8
    )
    assert int(res.n_accepted) > 0
    # adaptivity: far fewer steps than a fixed grid at this accuracy
    assert int(res.n_accepted) < 2000


def test_adaptive_matches_rk4_on_fwm():
    """rk45 at tight tolerance agrees with a fine fixed-step RK4 solve."""
    coef = RHSCoeffs(
        gamma=jnp.asarray(10.0), alpha=jnp.asarray(0.05), delta_beta=jnp.asarray(3.0)
    )
    y0 = jnp.asarray([np.sqrt(0.5), np.sqrt(0.5), 1e-3, 0.0], dtype=jnp.complex128)
    fine = integ.integrate_fixed_grid(
        rhs_yaman, y0, coef, z0=0.0, dz=1e-4, n_steps=10000, save_every=10000
    )
    zg = np.linspace(0.0, 1.0, 5)
    res = ad.integrate_adaptive_grid(
        rhs_yaman, y0, coef, z_grid=zg, rtol=1e-11, atol=1e-14
    )
    assert bool(res.ok)
    np.testing.assert_allclose(
        np.asarray(res.y_final), np.asarray(fine.y_final), rtol=1e-9
    )


def test_adaptive_tolerance_controls_step_count():
    zg = np.linspace(0.0, 1.0, 3)
    coarse = ad.integrate_adaptive_grid(
        _rhs_exp, jnp.asarray([1.0]), 1.0, z_grid=zg, rtol=1e-4, atol=1e-8
    )
    tight = ad.integrate_adaptive_grid(
        _rhs_exp, jnp.asarray([1.0]), 1.0, z_grid=zg, rtol=1e-11, atol=1e-14
    )
    assert int(tight.n_accepted) > int(coarse.n_accepted)


def test_adaptive_vmap_per_lane_step_counts():
    """Each lane adapts independently: stiffer lanes take more steps, and the
    batched results match unbatched solves."""
    lams = jnp.asarray([1.0, 20.0, 5.0])
    y0 = jnp.ones((3, 1))
    zg = np.linspace(0.0, 1.0, 4)

    def solve(y0_i, lam):
        return ad.integrate_adaptive_grid(
            _rhs_exp, y0_i, lam, z_grid=zg, rtol=1e-9, atol=1e-12
        )

    batched = jax.vmap(solve)(y0, lams)
    assert bool(np.all(np.asarray(batched.ok)))
    counts = np.asarray(batched.n_accepted)
    assert counts[1] > counts[0]  # stiffer lane took more steps
    for i in range(3):
        single = solve(y0[i], lams[i])
        np.testing.assert_allclose(
            np.asarray(batched.y_final[i]), np.asarray(single.y_final), rtol=1e-12
        )
    np.testing.assert_allclose(
        np.asarray(batched.y_final)[:, 0], np.exp(np.asarray(lams)), rtol=1e-7
    )


def test_adaptive_failure_masked_per_lane():
    """A blowing-up lane is flagged, without poisoning its batch mates."""

    def rhs(z, y, lam):
        return lam * y * y  # finite-time blow-up for lam>0 at z=1/lam

    lams = jnp.asarray([0.1, 3.0])  # second lane blows up inside [0, 1]
    y0 = jnp.ones((2, 1))
    zg = np.linspace(0.0, 1.0, 3)

    def solve(y0_i, lam):
        r = ad.integrate_adaptive_grid(
            rhs, y0_i, lam, z_grid=zg, rtol=1e-8, atol=1e-10,
            max_steps_per_segment=2000,
        )
        return r.ok, r.y_final

    ok, yf = jax.vmap(solve)(y0, lams)
    ok = np.asarray(ok)
    assert ok[0] and not ok[1]
    # healthy lane's answer: y = 1/(1 - 0.1 z) at z=1
    assert float(np.real(yf[0, 0])) == pytest.approx(1.0 / 0.9, rel=1e-7)


def test_run_single_simulation_rk45_matches_rk4():
    """End-to-end: the rk45 runner path reproduces the rk4 result on the
    seeded-signal example to tolerance, on the same output grid."""
    omega0 = 2 * np.pi * psa.constants.c / 1.55e-6
    omega = np.full(4, omega0)
    pm = psa.PhaseMatchingConfig(
        method=psa.PhaseMatchingMethod.PROVIDED, provided_delta_beta=0.8
    )
    p_in = np.array([0.1, 0.1, 1e-4, 1e-6])
    common = dict(
        gamma=10.0, alpha=0.2, omega=omega, p_in=p_in,
        phase_matching_cfg=pm, length_unit="km", return_length_unit="km",
    )
    cfg4 = psa.custom_simulation_config(z_max=0.5, dz=1e-4)
    z4, A4 = psa.run_single_simulation(cfg4, **common)
    cfg45 = psa.custom_simulation_config(
        z_max=0.5, dz=1e-4, integrator="rk45", rtol=1e-11, atol=1e-14
    )
    z45, A45 = psa.run_single_simulation(cfg45, **common)
    assert A45.shape == A4.shape
    np.testing.assert_allclose(z45, z4, rtol=1e-12)
    np.testing.assert_allclose(A45, A4, rtol=1e-7, atol=1e-12)


def test_rk45_resume_split_equals_full():
    """z0/A_init checkpoint-resume must work on the rk45 path too."""
    omega0 = 2 * np.pi * psa.constants.c / 1.55e-6
    kw = dict(
        gamma=10.0, alpha=0.05, omega=np.full(4, omega0),
        p_in=[0.1, 0.1, 1e-5, 0.0],
        phase_matching_cfg=psa.PhaseMatchingConfig(
            method=psa.PhaseMatchingMethod.PROVIDED, provided_delta_beta=0.8
        ),
        length_unit="m",
    )
    mk = lambda z: psa.custom_simulation_config(  # noqa: E731
        z_max=z, dz=0.01, save_every=10, integrator="rk45",
        rtol=1e-11, atol=1e-14,
    )
    z_full, A_full = psa.run_single_simulation(mk(4.0), **kw)
    z1, A1 = psa.run_single_simulation(mk(2.0), **kw)
    z2, A2 = psa.run_single_simulation(mk(2.0), z0=float(z1[-1]), A_init=A1[-1], **kw)
    assert z2[0] == pytest.approx(2.0) and z2[-1] == pytest.approx(4.0)
    np.testing.assert_allclose(
        np.concatenate([A1, A2[1:]]), A_full, rtol=1e-7, atol=1e-13
    )


def test_rk45_atol_zero_with_dark_waves():
    """atol=0 with identically-zero signal/idler components must not poison
    the error norm (0/0 -> 0, not NaN)."""
    omega0 = 2 * np.pi * psa.constants.c / 1.55e-6
    cfg = psa.custom_simulation_config(
        z_max=1.0, dz=0.01, integrator="rk45", rtol=1e-9, atol=0.0
    )
    z, A = psa.run_single_simulation(
        cfg, gamma=5.0, alpha=0.0, omega=np.full(4, omega0),
        p_in=[0.2, 0.2, 0.0, 0.0],
        phase_matching_cfg=psa.PhaseMatchingConfig(
            method=psa.PhaseMatchingMethod.PROVIDED, provided_delta_beta=0.0
        ),
        length_unit="m",
    )
    assert np.all(np.isfinite(A))
    np.testing.assert_array_equal(np.abs(A[:, 2]), 0.0)
