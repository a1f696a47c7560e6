"""Integrator tests: analytic-solution accuracy (the reference's most valuable
test pattern, tests.py:145-227), save decimation, masked NaN semantics, vmap."""

import jax
import numpy as np
import jax.numpy as jnp
import pytest

from psa_simulation_ode_rk_mvp_dispersion.ops import integrators as integ


def _rhs_exp(z, y, params):
    return y  # y' = y -> y = exp(z)


def test_rk4_single_step_vs_exp():
    dz = 0.01
    y0 = jnp.asarray([1.0 + 0j])
    y1 = integ.rk4_step(_rhs_exp, 0.0, y0, dz, None)
    assert float(np.abs(y1[0])) == pytest.approx(np.exp(dz), rel=1e-10)


def test_integrate_interval_vs_exp():
    z, y = integ.integrate_interval(_rhs_exp, 1.0, 1e-3, np.array([1.0 + 0j]), None)
    assert z.shape == y.shape[:1]
    np.testing.assert_allclose(np.real(y[:, 0]), np.exp(z), atol=3e-6, rtol=1e-9)
    assert z[0] == 0.0
    assert z[-1] == pytest.approx(1.0)


def test_save_every_decimation_shapes():
    n_steps, save_every = 1000, 10
    res = integ.integrate_fixed_grid(
        _rhs_exp, jnp.array([1.0 + 0j]), None,
        z0=0.0, dz=1e-3, n_steps=n_steps, save_every=save_every,
    )
    assert res.y_saved.shape == (n_steps // save_every + 1, 1)
    assert res.z_saved.shape == (n_steps // save_every + 1,)
    # saved grid positions
    np.testing.assert_allclose(
        np.asarray(res.z_saved), np.arange(101) * 10 * 1e-3, rtol=1e-12
    )


def test_partial_trailing_steps_integrated_but_not_saved():
    # 25 steps with save_every=10 -> rows at steps 0, 10, 20; final state at 25
    res = integ.integrate_fixed_grid(
        _rhs_exp, jnp.array([1.0 + 0j]), None,
        z0=0.0, dz=0.01, n_steps=25, save_every=10,
    )
    assert res.y_saved.shape[0] == 3
    assert float(np.abs(res.y_final[0])) == pytest.approx(np.exp(0.25), rel=1e-9)
    assert float(np.abs(res.y_saved[-1, 0])) == pytest.approx(np.exp(0.20), rel=1e-9)


def test_integrate_interval_input_validation():
    with pytest.raises(ValueError):
        integ.integrate_interval(_rhs_exp, -1.0, 0.1, np.array([1.0]), None)
    with pytest.raises(ValueError):
        integ.integrate_interval(_rhs_exp, 1.0, -0.1, np.array([1.0]), None)
    with pytest.raises(ValueError):
        integ.integrate_interval(_rhs_exp, 1.0, 0.1, np.array([1.0]), None, save_every=0)


def _rhs_blowup(z, y, params):
    # Finite-time blow-up: y' = y^2, y(0)=1 -> diverges at z=1
    return y * y


def test_nan_detection_raises_with_step_info():
    with pytest.raises(FloatingPointError, match="step"):
        integ.integrate_interval(
            _rhs_blowup, 2.0, 0.01, np.array([1.0]), None, check_nan=True
        )


def test_nan_check_skippable():
    z, y = integ.integrate_interval(
        _rhs_blowup, 2.0, 0.01, np.array([1.0]), None, check_nan=False
    )
    assert not np.all(np.isfinite(y))


def test_masked_nan_freezes_state_and_records_step():
    res = integ.integrate_fixed_grid(
        _rhs_blowup, jnp.array([1.0]), None,
        z0=0.0, dz=0.01, n_steps=200, save_every=1, check_nan=True,
    )
    assert not bool(res.ok)
    bad = int(res.bad_step)
    assert 0 < bad < 200
    # frozen final state is finite (last good value)
    assert np.all(np.isfinite(np.asarray(res.y_final)))


def test_vmap_batch_matches_single():
    """A batch of instances integrated under vmap must match per-instance
    solves exactly (the core sweep-engine invariant)."""

    def rhs(z, y, lam):
        return -lam * y

    lams = jnp.asarray([0.5, 1.0, 2.0, 4.0])
    y0 = jnp.ones((4, 1), dtype=jnp.complex128)

    def solve(y0_i, lam_i):
        return integ.integrate_fixed_grid(
            rhs, y0_i, lam_i, z0=0.0, dz=0.01, n_steps=100, save_every=10
        ).y_saved

    batched = jax.vmap(solve)(y0, lams)
    for i in range(4):
        single = solve(y0[i], lams[i])
        np.testing.assert_array_equal(np.asarray(batched[i]), np.asarray(single))
    # and the analytic answer
    np.testing.assert_allclose(
        np.real(np.asarray(batched[:, -1, 0])), np.exp(-np.asarray(lams)), rtol=1e-6
    )


def test_vmap_nan_masking_is_per_instance():
    """One diverging instance must not poison its batch mates (replaces the
    reference's exception-per-point, scan_mismtach.py:736-738)."""

    def rhs(z, y, lam):
        return lam * y * y

    lams = jnp.asarray([0.1, 50.0, 0.2])  # middle one blows up
    y0 = jnp.ones((3, 1))

    def solve(y0_i, lam_i):
        res = integ.integrate_fixed_grid(
            rhs, y0_i, lam_i, z0=0.0, dz=0.05, n_steps=100, save_every=100
        )
        return res.ok, res.y_final

    ok, yf = jax.vmap(solve)(y0, lams)
    assert list(np.asarray(ok)) == [True, False, True]
    assert np.all(np.isfinite(np.asarray(yf)))
    assert float(np.real(yf[0, 0])) == pytest.approx(1.0 / (1.0 - 0.1 * 5.0), rel=1e-6)


def test_integrate_reduce_matches_trajectory_max():
    def rhs(z, y, p):
        return 1j * y  # |y| constant, oscillating components

    y0 = jnp.asarray([1.0 + 0j, 2.0 + 0j])
    traj = integ.integrate_fixed_grid(
        rhs, y0, None, z0=0.0, dz=0.01, n_steps=500, save_every=10
    )
    Pmax_traj = np.max(np.abs(np.asarray(traj.y_saved)) ** 2, axis=0)

    red = integ.integrate_reduce(
        rhs, y0, None, z0=0.0, dz=0.01, n_steps=500, save_every=10,
        reduce_init=jnp.zeros(2),
        reduce_fn=lambda acc, y: jnp.maximum(acc, jnp.abs(y) ** 2),
    )
    np.testing.assert_allclose(np.asarray(red.reduction), Pmax_traj, rtol=1e-12)
    np.testing.assert_array_equal(np.asarray(red.y_final), np.asarray(traj.y_final))


def test_nonuniform_grid_rejected():
    zg = np.array([0.0, 0.1, 0.3])
    with pytest.raises(ValueError, match="uniform"):
        integ.integrate_fixed_step(_rhs_exp, zg, np.array([1.0]), None)
