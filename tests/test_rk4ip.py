"""RK4IP (interaction-picture RK4, ``cfg.integrator='rk4ip'``) tests.

The method (Hult, J. Lightwave Technol. 25(12):3770, 2007) is the 4th-order
fixed-step integrator for the split-step families: change frame to the
dispersion interaction picture at the step midpoint and run classic RK4 on
the transformed nonlinear operator.  Reference capability analog: the
reference validates an ``integrator`` config slot but only ever dispatches
rk4 (/root/reference/config.py:89); this is the framework's high-order
fixed-step member of that slot for the pulse-propagation families.

Oracles: measured convergence order (vs a fine-dz Strang solution -- both
methods converge to the same continuous solution), equal-dz accuracy
dominance over Strang, scalar<->vector consistency, and the framework-wide
save/NaN/reduce contracts.
"""

import math

import numpy as np
import pytest

import psa
from psa_simulation_ode_rk_mvp_dispersion.models import gnlse as g
from psa_simulation_ode_rk_mvp_dispersion.models import vgnlse as vg
from psa_simulation_ode_rk_mvp_dispersion.ops.dispersion import DispersionParams

W0 = 2 * np.pi * 3e8 / 1550e-9
T0 = 50e-15
BETA2 = -1e-26
GAMMA = 0.01


def _soliton_setup(n_samples=256):
    grid = g.TimeGrid.for_pulse(T0, n_samples=n_samples)
    P0 = g.soliton_peak_power(BETA2, GAMMA, T0)
    A0 = g.sech_pulse(grid, peak_W=P0, t0_s=T0)
    disp = DispersionParams.from_betas(W0, beta2=BETA2)
    co = g.make_gnlse_coeffs(grid, disp, gamma_W_m=GAMMA)
    return grid, co, A0


def _run(cfg, co, A0, nl=None):
    _, A = g.run_gnlse_simulation(cfg, co, A0, nl=nl)
    return A[-1]


def _rel_err(a, ref):
    return np.max(np.abs(a - ref)) / np.max(np.abs(ref))


def test_rk4ip_convergence_order_generalized():
    """Measured order on the Raman+steepening operator: Strang ~2, RK4IP
    >= 3.5 (measured 2.00 / ~4-5 on this setup)."""
    grid, co, A0 = _soliton_setup()
    nl = g.make_nl_terms(grid, omega0=W0)
    z_max = 2.0
    # fine oracle runs rk4ip itself: a Strang oracle's own O(dz^2) floor
    # (~1e-5 at dz=1e-3) would contaminate the rk4ip error at fine dz --
    # both methods converge to the same continuous solution
    ref = _run(psa.custom_simulation_config(
        z_max=z_max, dz=0.002, save_every=1000, integrator="rk4ip"),
        co, A0, nl)

    errs = {}
    for integ in ("rk4", "rk4ip"):
        for dz in (0.04, 0.01):
            cfg = psa.custom_simulation_config(
                z_max=z_max, dz=dz, save_every=int(round(z_max / dz)),
                integrator=integ)
            errs[(integ, dz)] = _rel_err(_run(cfg, co, A0, nl), ref)
    p_strang = math.log(errs[("rk4", 0.04)] / errs[("rk4", 0.01)]) / math.log(4)
    p_ip = math.log(errs[("rk4ip", 0.04)] / errs[("rk4ip", 0.01)]) / math.log(4)
    assert 1.6 < p_strang < 2.4, (p_strang, errs)
    assert p_ip > 3.5, (p_ip, errs)
    # equal-dz accuracy dominance (the point of the method)
    assert errs[("rk4ip", 0.01)] < errs[("rk4", 0.01)] / 20.0, errs


def test_rk4ip_soliton_beats_strang_at_equal_dz():
    """Fundamental soliton (pure Kerr): rk4ip at dz=0.05 is >= 10x closer
    to the fine-dz solution than Strang at the same dz."""
    grid, co, A0 = _soliton_setup()
    ref = _run(psa.custom_simulation_config(
        z_max=10.0, dz=0.002, save_every=5000), co, A0)
    out = {}
    for integ in ("rk4", "rk4ip"):
        cfg = psa.custom_simulation_config(
            z_max=10.0, dz=0.05, save_every=200, integrator=integ)
        out[integ] = _rel_err(_run(cfg, co, A0), ref)
    assert out["rk4ip"] < out["rk4"] / 10.0, out


def test_rk4ip_reduce_matches_trajectories():
    """solve_gnlse_batch (reduce) peak/A_last == trajectory-mode rows under
    rk4ip, both save-grid contracts included."""
    grid, co, A0 = _soliton_setup()
    B = 3
    A0b = np.stack([A0 * s for s in (1.0, 0.8, 1.2)])
    cfg = psa.custom_simulation_config(
        z_max=1.0, dz=0.01, save_every=25, integrator="rk4ip")
    z, A, ok = g.solve_gnlse_batch_trajectories(cfg, co, A0b)
    assert ok.all()
    pk, A_last, ok2 = g.solve_gnlse_batch(cfg, co, A0b)
    assert ok2.all()
    np.testing.assert_allclose(
        pk, np.max(np.abs(A) ** 2, axis=(1, 2)), rtol=1e-12)
    np.testing.assert_allclose(A_last, A[:, -1], rtol=1e-12, atol=1e-18)


def test_rk4ip_sharded_matches_unsharded():
    """Batch-axis shard_map on the CPU mesh reproduces the unsharded rk4ip
    solve (trajectory + reduce modes)."""
    from psa_simulation_ode_rk_mvp_dispersion.parallel.mesh import default_mesh

    grid, co, A0 = _soliton_setup(n_samples=128)
    B = 8
    rng = np.random.default_rng(7)
    A0b = A0[None, :] * rng.uniform(0.7, 1.3, (B, 1))
    cfg = psa.custom_simulation_config(
        z_max=0.5, dz=0.01, save_every=25, integrator="rk4ip")
    mesh = default_mesh()
    pk_u, Al_u, ok_u = g.solve_gnlse_batch(cfg, co, A0b)
    pk_s, Al_s, ok_s = g.solve_gnlse_batch(cfg, co, A0b, mesh=mesh)
    np.testing.assert_allclose(pk_s, pk_u, rtol=1e-12)
    np.testing.assert_allclose(Al_s, Al_u, rtol=1e-12, atol=1e-18)
    np.testing.assert_array_equal(ok_s, ok_u)
    z_u, A_u, _ = g.solve_gnlse_batch_trajectories(cfg, co, A0b)
    z_s, A_s, _ = g.solve_gnlse_batch_trajectories(cfg, co, A0b, mesh=mesh)
    np.testing.assert_allclose(A_s, A_u, rtol=1e-12, atol=1e-18)


def test_rk4ip_vector_empty_pol_matches_scalar():
    """vgnlse rk4ip with an empty y polarization reproduces the scalar
    rk4ip trajectory on the x row."""
    grid, co, A0 = _soliton_setup(n_samples=128)
    cfg = psa.custom_simulation_config(
        z_max=1.0, dz=0.02, save_every=10, integrator="rk4ip")
    z_s, A_s = g.run_gnlse_simulation(cfg, co, A0)

    vco = vg.make_vgnlse_coeffs(
        grid, DispersionParams.from_betas(W0, beta2=BETA2),
        gamma_W_m=GAMMA, coupling="cnlse")
    A0v = vg.polarized_pulse(A0, 0.0)
    z_v, A_v = vg.run_vgnlse_simulation(cfg, vco, A0v)
    # rounding-level agreement: same scheme, different op order/batching
    # (atol covers the far pulse tails ~1e-7 of the ~20 W^0.5 peak)
    np.testing.assert_allclose(A_v[:, 0, :], A_s, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(A_v[:, 1, :], 0.0, atol=1e-14)


def test_rk4ip_vector_coherent_energy_conservation():
    """The isotropic (coherent c=1/3) vector model under rk4ip conserves
    pulse energy without loss (truncation-limited, not split-limited)."""
    grid, _, A0 = _soliton_setup(n_samples=128)
    vco = vg.make_vgnlse_coeffs(
        grid, DispersionParams.from_betas(W0, beta2=BETA2),
        gamma_W_m=GAMMA, coupling="isotropic")
    A0v = vg.polarized_pulse(A0, np.pi / 5)
    cfg = psa.custom_simulation_config(
        z_max=1.0, dz=0.01, save_every=100, integrator="rk4ip")
    z, A = vg.run_vgnlse_simulation(cfg, vco, A0v)
    E = (np.abs(A) ** 2).sum(axis=(1, 2))
    # RK4 truncation, not exact invariance: ~7e-9 relative drift measured
    # at this dz (the exact-rotation Strang substep conserves E exactly,
    # the coherent c-term RK4 only to O(dz^4))
    np.testing.assert_allclose(E, E[0], rtol=1e-7)


def test_rk4ip_nan_freeze_contract():
    """A non-finite lane freezes (ok=False) without contaminating others."""
    grid, co, A0 = _soliton_setup(n_samples=128)
    A0b = np.stack([A0, A0 * np.nan, A0 * 0.9])
    cfg = psa.custom_simulation_config(
        z_max=0.2, dz=0.01, save_every=10, integrator="rk4ip")
    pk, A_last, ok = g.solve_gnlse_batch(cfg, co, A0b)
    assert not ok[1] and ok[0] and ok[2]
    cfg_ok = psa.custom_simulation_config(
        z_max=0.2, dz=0.01, save_every=10, integrator="rk4ip")
    pk2, A_last2, _ = g.solve_gnlse_batch(cfg_ok, co, A0b[[0, 2]])
    np.testing.assert_allclose(A_last[[0, 2]], A_last2, rtol=1e-12)


def test_rk4ip_rejected_by_ode_families():
    """The ODE families refuse rk4ip loudly (no silent rk4/rk45)."""
    from psa_simulation_ode_rk_mvp_dispersion.parallel import sweep as sw
    from psa_simulation_ode_rk_mvp_dispersion.ops.rhs import RHSCoeffs
    from psa_simulation_ode_rk_mvp_dispersion.models import nwave

    cfg = psa.custom_simulation_config(z_max=0.5, dz=1e-3, integrator="rk4ip")
    omega = np.asarray(psa.plan_from_wavelengths(1550e-9, 1560e-9, 1555e-9))
    with pytest.raises(ValueError, match="rk4ip"):
        psa.run_single_simulation(
            cfg, gamma=0.0115, alpha=0.0, omega=omega,
            p_in=np.array([0.5, 0.5, 1e-5, 1e-5]), phase_in=np.zeros(4),
            beta_legacy=[0.0, 0.0, 0.0, 0.0], length_unit="m",
        )
    with pytest.raises(ValueError, match="rk4ip"):
        sw.solve_batch(
            cfg, RHSCoeffs(gamma=np.ones(2) * 0.01, alpha=np.zeros(2),
                           delta_beta=np.zeros(2)),
            np.ones((2, 4), complex),
        )
    with pytest.raises(ValueError, match="rk4ip"):
        nwave.run_comb_simulation(
            cfg, nwave.NWaveCoeffs(gamma=0.01, alpha=0.0,
                                   beta_lin=np.zeros(8)),
            np.ones(8, complex),
        )


def test_rk4ip_runner_matches_batch_single():
    """run_gnlse_simulation rk4ip equals the B=1 batched trajectory."""
    grid, co, A0 = _soliton_setup(n_samples=128)
    nl = g.make_nl_terms(grid, omega0=W0)
    cfg = psa.custom_simulation_config(
        z_max=0.5, dz=0.01, save_every=10, integrator="rk4ip")
    z1, A1 = g.run_gnlse_simulation(cfg, co, A0, nl=nl)
    z2, A2, ok = g.solve_gnlse_batch_trajectories(cfg, co, A0[None], nl=nl)
    assert ok.all()
    np.testing.assert_allclose(A1, A2[0], rtol=1e-12, atol=1e-18)
    np.testing.assert_allclose(z1, z2, rtol=1e-13)


def test_rk4ip_vector_reduce_matches_trajectories():
    """Vector reduce mode == vector trajectory rows under rk4ip."""
    grid, _, A0 = _soliton_setup(n_samples=128)
    vco = vg.make_vgnlse_coeffs(
        grid, DispersionParams.from_betas(W0, beta2=BETA2),
        gamma_W_m=GAMMA, coupling="manakov")
    B = 2
    A0v = np.stack([vg.polarized_pulse(A0, th) for th in (0.3, 1.0)])
    cfg = psa.custom_simulation_config(
        z_max=0.5, dz=0.01, save_every=10, integrator="rk4ip")
    z, A, ok = vg.solve_vgnlse_batch_trajectories(cfg, vco, A0v)
    assert ok.all()
    pk, A_last, ok2 = vg.solve_vgnlse_batch(cfg, vco, A0v)
    assert ok2.all()
    np.testing.assert_allclose(
        pk, np.max(np.abs(A) ** 2, axis=(1, 3)), rtol=1e-12)
    np.testing.assert_allclose(A_last, A[:, -1], rtol=1e-12, atol=1e-18)


# ---------------------------------------------------------------------------
# Adaptive RK4IP (integrator='rk4ip45'): step-doubling on the 4th-order step
# ---------------------------------------------------------------------------

def _adaptive_counters(method, rtol, A0, co, n_samples):
    """Accepted/rejected step counts from the reduce-mode adaptive solver."""
    import jax.numpy as jnp
    from psa_simulation_ode_rk_mvp_dispersion.utils.packing import (
        ri_pack_host,
    )

    sol = g._gnlse_adaptive_solver("float64", rtol, 0.0, 1_000_000, True,
                                   method)
    zg = jnp.asarray(np.linspace(0.0, 2.0, 11))
    cof = g.GNLSECoeffs(
        gamma=jnp.asarray(co.gamma), alpha=jnp.asarray(co.alpha),
        lin_phase=jnp.asarray(co.lin_phase))
    out = sol(jnp.asarray(ri_pack_host(A0[None], np.float64)), cof, zg,
              jnp.asarray(0.01), None)
    _pk, _y, ok, na, nr = g._split_reduce_pack(
        np.asarray(out), n_samples, counters=True)
    assert ok.all()
    return int(na[0]), int(nr[0])


def test_rk4ip45_meets_tolerance_with_far_fewer_steps():
    """At rtol=1e-9 the 4th-order controller reaches the same accuracy as
    the Strang controller in >= 4x fewer accepted steps (measured 410 vs
    3460, 8.4x, on this soliton setup) -- the point of the method."""
    grid, co, A0 = _soliton_setup()
    ref_cfg = psa.custom_simulation_config(
        z_max=2.0, dz=0.002, save_every=1000, integrator="rk4ip")
    ref = _run(ref_cfg, co, A0)
    for integ in ("rk45", "rk4ip45"):
        cfg = psa.custom_simulation_config(
            z_max=2.0, dz=0.01, save_every=200, integrator=integ,
            rtol=1e-9, atol=0.0)
        err = _rel_err(_run(cfg, co, A0), ref)
        # global error within ~100x the local tolerance target
        assert err < 1e-7, (integ, err)
    na_s, _ = _adaptive_counters("strang", 1e-9, A0, co, grid.n_samples)
    na_ip, nr_ip = _adaptive_counters("rk4ip", 1e-9, A0, co, grid.n_samples)
    assert na_ip * 4 < na_s, (na_ip, na_s)
    assert nr_ip < 0.2 * na_ip + 5, (nr_ip, na_ip)  # controller is stable


def test_rk4ip45_generalized_nl_matches_fine_reference():
    """Adaptive rk4ip45 on the Raman+steepening operator lands on the
    fine-dz fixed-step solution within the tolerance class."""
    grid, co, A0 = _soliton_setup()
    nl = g.make_nl_terms(grid, omega0=W0)
    ref_cfg = psa.custom_simulation_config(
        z_max=2.0, dz=0.002, save_every=1000, integrator="rk4ip")
    ref = _run(ref_cfg, co, A0, nl)
    cfg = psa.custom_simulation_config(
        z_max=2.0, dz=0.01, save_every=200, integrator="rk4ip45",
        rtol=1e-8, atol=0.0)
    assert _rel_err(_run(cfg, co, A0, nl), ref) < 1e-6


def test_rk4ip45_reduce_matches_trajectories():
    grid, co, A0 = _soliton_setup(n_samples=128)
    A0b = np.stack([A0 * s for s in (1.0, 0.8, 1.2)])
    cfg = psa.custom_simulation_config(
        z_max=1.0, dz=0.01, save_every=25, integrator="rk4ip45",
        rtol=1e-8, atol=0.0)
    z, A, ok = g.solve_gnlse_batch_trajectories(cfg, co, A0b)
    assert ok.all()
    pk, A_last, ok2 = g.solve_gnlse_batch(cfg, co, A0b)
    assert ok2.all()
    np.testing.assert_allclose(
        pk, np.max(np.abs(A) ** 2, axis=(1, 2)), rtol=1e-12)
    np.testing.assert_allclose(A_last, A[:, -1], rtol=1e-12, atol=1e-18)


def test_rk4ip45_sharded_matches_unsharded():
    """Per-lane controllers are independent, so the shard_map program is
    bit-identical per lane to the unsharded batch."""
    from psa_simulation_ode_rk_mvp_dispersion.parallel.mesh import default_mesh

    grid, co, A0 = _soliton_setup(n_samples=128)
    rng = np.random.default_rng(7)
    A0b = A0[None, :] * rng.uniform(0.7, 1.3, (8, 1))
    cfg = psa.custom_simulation_config(
        z_max=0.5, dz=0.01, save_every=25, integrator="rk4ip45",
        rtol=1e-8, atol=0.0)
    mesh = default_mesh()
    pk_u, Al_u, ok_u = g.solve_gnlse_batch(cfg, co, A0b)
    pk_s, Al_s, ok_s = g.solve_gnlse_batch(cfg, co, A0b, mesh=mesh)
    np.testing.assert_allclose(pk_s, pk_u, rtol=1e-12)
    np.testing.assert_allclose(Al_s, Al_u, rtol=1e-12, atol=1e-18)
    np.testing.assert_array_equal(ok_s, ok_u)


def test_rk4ip45_vector_matches_fine_reference():
    """Vector (Manakov) adaptive rk4ip45 lands on the fine fixed-step
    vector solution; empty-pol x row stays near the scalar one."""
    grid, co, A0 = _soliton_setup(n_samples=128)
    vco = vg.make_vgnlse_coeffs(
        grid, DispersionParams.from_betas(W0, beta2=BETA2),
        gamma_W_m=GAMMA, coupling="manakov")
    A0v = vg.polarized_pulse(A0, 0.4)
    ref_cfg = psa.custom_simulation_config(
        z_max=1.0, dz=0.002, save_every=500, integrator="rk4ip")
    _, Aref = vg.run_vgnlse_simulation(ref_cfg, vco, A0v)
    cfg = psa.custom_simulation_config(
        z_max=1.0, dz=0.01, save_every=100, integrator="rk4ip45",
        rtol=1e-8, atol=0.0)
    _, Aa = vg.run_vgnlse_simulation(cfg, vco, A0v)
    err = np.max(np.abs(Aa[-1] - Aref[-1])) / np.max(np.abs(Aref[-1]))
    assert err < 1e-6, err
    # batch reduce == trajectory under the vector adaptive path
    pk, A_last, ok = vg.solve_vgnlse_batch(cfg, vco, A0v[None])
    z, At, ok2 = vg.solve_vgnlse_batch_trajectories(cfg, vco, A0v[None])
    assert ok.all() and ok2.all()
    np.testing.assert_allclose(A_last, At[:, -1], rtol=1e-12, atol=1e-18)


def test_rk4ip45_rejected_by_ode_families():
    cfg = psa.custom_simulation_config(z_max=0.5, dz=1e-3,
                                       integrator="rk4ip45")
    omega = np.asarray(psa.plan_from_wavelengths(1550e-9, 1560e-9, 1555e-9))
    with pytest.raises(ValueError, match="rk4ip"):
        psa.run_single_simulation(
            cfg, gamma=0.0115, alpha=0.0, omega=omega,
            p_in=np.array([0.5, 0.5, 1e-5, 1e-5]), phase_in=np.zeros(4),
            beta_legacy=[0.0, 0.0, 0.0, 0.0], length_unit="m",
        )


def test_rk4ip45_validates_tolerances():
    with pytest.raises(ValueError, match="rtol"):
        psa.validate_config(psa.custom_simulation_config(
            z_max=1.0, dz=0.01, integrator="rk4ip45", rtol=-1.0))
