"""FWM + SBS two-point boundary-value model tests: decoupled limits,
undepleted-pump analytics, convergence, energy bookkeeping."""

from pathlib import Path

import numpy as np
import pytest

import psa
from psa_simulation_ode_rk_mvp_dispersion.models import sbs


def _run(g_B, p_stokes=1e-6, alpha=0.0, gamma=2.0, db=0.5, z_max=10.0,
         dz=0.01, p_in=(0.1, 0.1, 1e-5, 0.0), iters=20):
    cfg = psa.custom_simulation_config(z_max=z_max, dz=dz, save_every=10)
    return sbs.run_sbs_simulation(
        cfg, gamma=gamma, alpha=alpha, g_B=g_B, delta_beta=db,
        p_in=list(p_in), p_stokes_seed=[0.0, 0.0, p_stokes, 0.0],
        length_unit="m", n_iterations=iters,
    )


def test_gb_zero_forward_equals_plain_fwm():
    """With g_B=0 the forward waves must match the plain 4-wave solver."""
    res = _run(g_B=0.0, alpha=0.01)
    pm = psa.PhaseMatchingConfig(
        method=psa.PhaseMatchingMethod.PROVIDED, provided_delta_beta=0.5
    )
    omega0 = 2 * np.pi * psa.constants.c / 1.55e-6
    cfg = psa.custom_simulation_config(z_max=10.0, dz=0.01, save_every=10)
    z, A = psa.run_single_simulation(
        cfg, gamma=2.0, alpha=0.01, omega=np.full(4, omega0),
        p_in=[0.1, 0.1, 1e-5, 0.0], phase_matching_cfg=pm, length_unit="m",
        frame="rotating",
    )
    np.testing.assert_allclose(res.z, z, rtol=1e-12)
    np.testing.assert_allclose(res.A, A, rtol=1e-9, atol=1e-14)


def test_gb_zero_backward_is_analytic():
    """g_B=0: B decouples, dB/dz = (alpha/2) B, B(L) given
    -> |B(z)|^2 = P_L e^{alpha (z - L)}."""
    alpha, L, P_L = 0.05, 10.0, 1e-6
    res = _run(g_B=0.0, alpha=alpha, p_stokes=P_L)
    P_B = np.abs(res.B[:, 2]) ** 2
    np.testing.assert_allclose(
        P_B, P_L * np.exp(alpha * (res.z - L)), rtol=1e-7
    )


def test_undepleted_pump_stokes_gain():
    """Weak Stokes on a strong quasi-constant forward wave: Brillouin
    amplification |B(0)|^2 = P_L e^{(gB P_A - alpha) L} to first order."""
    gB, PA, L = 0.4, 0.2, 10.0
    # single strong forward wave (others off), FWM inert (signal/idler zero)
    res = _run(g_B=gB, gamma=0.0, db=0.0, p_in=(PA, 0.0, 0.0, 0.0),
               p_stokes=0.0, z_max=L)
    # seed the Stokes on wave 0 instead
    cfg = psa.custom_simulation_config(z_max=L, dz=0.01, save_every=10)
    res = sbs.run_sbs_simulation(
        cfg, gamma=0.0, alpha=0.0, g_B=gB, delta_beta=0.0,
        p_in=[PA, 0.0, 0.0, 0.0], p_stokes_seed=[1e-8, 0.0, 0.0, 0.0],
        length_unit="m", n_iterations=25,
    )
    got = np.abs(res.B[0, 0]) ** 2
    expected = 1e-8 * np.exp(gB * PA * L)  # undepleted: gain over full span
    assert got == pytest.approx(expected, rel=0.02)
    assert res.residual < 1e-10


def test_pump_depletion_energy_bookkeeping():
    """Strong SBS: the forward wave loses exactly the power the Stokes gains
    (lossless medium, photon-energy-degenerate approximation):
    d/dz (P_A - P_B) = 0 along z."""
    cfg = psa.custom_simulation_config(z_max=5.0, dz=0.005, save_every=20)
    res = sbs.run_sbs_simulation(
        cfg, gamma=0.0, alpha=0.0, g_B=2.0, delta_beta=0.0,
        p_in=[0.5, 0.0, 0.0, 0.0], p_stokes_seed=[2e-3, 0.0, 0.0, 0.0],
        length_unit="m", n_iterations=90,
    )
    P_A = np.abs(res.A[:, 0]) ** 2
    P_B = np.abs(res.B[:, 0]) ** 2
    invariant = P_A - P_B
    np.testing.assert_allclose(invariant, invariant[0], rtol=1e-5)
    # real depletion happened
    assert P_A[-1] < 0.95 * P_A[0]
    assert res.residual < 1e-8
    assert res.reflectivity[0] > 0.05


def test_convergence_residual_reported():
    r5 = _run(g_B=1.0, p_stokes=1e-5, iters=3)
    r20 = _run(g_B=1.0, p_stokes=1e-5, iters=20)
    assert r20.residual <= r5.residual
    assert r20.residual < 1e-10


def test_strong_coupling_requires_damping_and_converges():
    """Above the SBS threshold (gB*P*L = 10) plain alternating sweeps
    oscillate; under-relaxation restores convergence with heavy pump
    depletion and conserved P_A - P_B."""
    cfg = psa.custom_simulation_config(z_max=10.0, dz=0.01, save_every=10)
    common = dict(
        gamma=0.0, alpha=0.0, g_B=2.0, delta_beta=0.0,
        p_in=[0.5, 0, 0, 0], p_stokes_seed=[2e-3, 0, 0, 0], length_unit="m",
    )
    undamped = sbs.run_sbs_simulation(cfg, n_iterations=60, **common)
    assert undamped.residual > 1e-2  # oscillating, reported honestly

    damped = sbs.run_sbs_simulation(cfg, n_iterations=400, damping=0.3, **common)
    assert damped.residual < 1e-10
    assert damped.reflectivity[0] > 0.5  # strong Stokes conversion
    P_A = np.abs(damped.A[:, 0]) ** 2
    P_B = np.abs(damped.B[:, 0]) ** 2
    inv = P_A - P_B
    np.testing.assert_allclose(inv, inv[0], rtol=1e-5)


def test_damping_validation():
    cfg = psa.custom_simulation_config(z_max=1.0, dz=0.01)
    with pytest.raises(ValueError, match="damping"):
        sbs.run_sbs_simulation(
            cfg, gamma=0.0, alpha=0.0, g_B=1.0, delta_beta=0.0,
            p_in=[0.1, 0, 0, 0], p_stokes_seed=[1e-6, 0, 0, 0],
            damping=0.0,
        )


def test_run_sbs_batch_matches_singles():
    """Batched SBS relaxation (vmapped BVP) matches per-instance solves."""
    B = 3
    gB = np.array([0.0, 0.5, 1.0])
    P_in = np.broadcast_to([0.1, 0.1, 1e-5, 0.0], (B, 4)).copy()
    P_st = np.broadcast_to([0.0, 0.0, 1e-6, 0.0], (B, 4)).copy()
    cfg = psa.custom_simulation_config(z_max=5.0, dz=0.01, save_every=10)
    z, A, Bw, resid, refl, ok, n_iters = sbs.run_sbs_batch(
        cfg, gamma=2.0, alpha=0.01, g_B=gB, delta_beta=0.5,
        P_in=P_in, P_stokes_seed=P_st, length_unit="m", n_iterations=20,
    )
    assert A.shape == (B, len(z), 4) and Bw.shape == A.shape
    for i in range(B):
        res_i = sbs.run_sbs_simulation(
            cfg, gamma=2.0, alpha=0.01, g_B=float(gB[i]), delta_beta=0.5,
            p_in=list(P_in[i]), p_stokes_seed=list(P_st[i]),
            length_unit="m", n_iterations=20,
        )
        np.testing.assert_allclose(A[i], res_i.A, rtol=1e-10, atol=1e-14)
        np.testing.assert_allclose(Bw[i], res_i.B, rtol=1e-10, atol=1e-14)
    assert np.all(resid < 1e-8)
    assert np.all(ok)


def test_fully_coupled_depleted_matches_solve_bvp_golden():
    """Independent oracle: scipy.integrate.solve_bvp (tol=1e-10, FWM part
    executed from the reference) on a fully-coupled, pump-depleted BVP
    (54% pump depletion, 63% Stokes reflectivity).  Relaxation must agree
    to <= 1e-6 (target); observed ~1e-7, limited by the frozen-field RK4
    interpolation."""
    g = np.load(Path(__file__).parent / "golden" / "golden_sbs_bvp.npz")
    cfg = psa.custom_simulation_config(z_max=float(g["L"]), dz=0.002, save_every=50)
    res = sbs.run_sbs_simulation(
        cfg, gamma=float(g["gamma"]), alpha=float(g["alpha"]),
        g_B=float(g["g_B"]), delta_beta=float(g["delta_beta"]),
        p_in=g["p_in"], p_stokes_seed=g["p_stokes"], length_unit="m",
        damping=0.5, tol=1e-13, max_iterations=2000,
    )
    A_ref = g["A_re"] + 1j * g["A_im"]
    B_ref = g["B_re"] + 1j * g["B_im"]
    np.testing.assert_allclose(res.z, g["z"], atol=1e-12)
    assert res.residual < 1e-12          # converged, not budget-capped
    assert res.n_iterations < 2000
    assert np.max(np.abs(res.A - A_ref)) < 1e-6
    assert np.max(np.abs(res.B - B_ref)) < 1e-6


def test_tol_stops_iteration_early():
    """tol > 0 stops as soon as the residual drops below it; the loose solve
    uses strictly fewer sweeps and still reports its actual residual."""
    cfg = psa.custom_simulation_config(z_max=5.0, dz=0.01, save_every=10)
    common = dict(
        gamma=0.5, alpha=0.01, g_B=1.0, delta_beta=0.0,
        p_in=[0.2, 0.1, 1e-5, 0.0], p_stokes_seed=[1e-4, 0, 0, 0],
        length_unit="m",
    )
    tight = sbs.run_sbs_simulation(cfg, tol=1e-12, max_iterations=100, **common)
    loose = sbs.run_sbs_simulation(cfg, tol=1e-4, max_iterations=100, **common)
    assert tight.residual <= 1e-12
    assert loose.n_iterations < tight.n_iterations
    assert loose.residual <= 1e-4
    # both converged to the same physics at their tolerances
    np.testing.assert_allclose(loose.A, tight.A, atol=1e-3)


def test_batch_convergence_masking_matches_singles():
    """Lanes converging at different sweep counts under one while_loop must
    be bit-identical to solving each alone (self-masking body)."""
    B = 3
    gB = np.array([0.1, 1.0, 2.0])  # very different convergence speeds
    P_in = np.broadcast_to([0.2, 0.1, 1e-5, 0.0], (B, 4)).copy()
    P_st = np.broadcast_to([1e-3, 0.0, 0.0, 0.0], (B, 4)).copy()
    cfg = psa.custom_simulation_config(z_max=3.0, dz=0.01, save_every=30)
    z, A, Bw, resid, refl, ok, n_iters = sbs.run_sbs_batch(
        cfg, gamma=0.5, alpha=0.01, g_B=gB, delta_beta=0.2,
        P_in=P_in, P_stokes_seed=P_st, length_unit="m",
        tol=1e-11, max_iterations=200,
    )
    assert np.all(ok)
    assert n_iters[0] != n_iters[2]  # genuinely different lane schedules
    for i in range(B):
        res_i = sbs.run_sbs_simulation(
            cfg, gamma=0.5, alpha=0.01, g_B=float(gB[i]), delta_beta=0.2,
            p_in=list(P_in[i]), p_stokes_seed=list(P_st[i]), length_unit="m",
            tol=1e-11, max_iterations=200,
        )
        assert int(n_iters[i]) == res_i.n_iterations
        np.testing.assert_array_equal(A[i], res_i.A)
        np.testing.assert_array_equal(Bw[i], res_i.B)


def test_run_sbs_batch_sharded_matches_unsharded():
    """The batch of BVPs sharded over the 8-device mesh must equal the
    single-device batch exactly (embarrassingly SPMD relaxation)."""
    import jax

    from psa_simulation_ode_rk_mvp_dispersion.parallel import mesh as pm

    assert len(jax.devices()) == 8
    B = 11  # not divisible by 8: exercises padding
    gB = np.linspace(0.1, 1.2, B)
    P_in = np.broadcast_to([0.2, 0.1, 1e-5, 0.0], (B, 4)).copy()
    P_st = np.broadcast_to([1e-4, 0.0, 0.0, 0.0], (B, 4)).copy()
    cfg = psa.custom_simulation_config(z_max=3.0, dz=0.01, save_every=30)
    kw = dict(
        gamma=0.5, alpha=0.01, g_B=gB, delta_beta=0.2,
        P_in=P_in, P_stokes_seed=P_st, length_unit="m",
        tol=1e-11, max_iterations=150,
    )
    z1, A1, B1, r1, f1, ok1, n1 = sbs.run_sbs_batch(cfg, **kw)
    mesh = pm.default_mesh()
    z2, A2, B2, r2, f2, ok2, n2 = sbs.run_sbs_batch(cfg, mesh=mesh, **kw)
    np.testing.assert_array_equal(z2, z1)
    # GSPMD partitioning reassociates a few f64 adds (~1e-17); lane schedules
    # (per-lane iteration counts) must still match exactly
    np.testing.assert_allclose(A2, A1, rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(B2, B1, rtol=1e-12, atol=1e-14)
    np.testing.assert_array_equal(n2, n1)
    np.testing.assert_array_equal(ok2, ok1)


def test_df32_rejected_with_clear_error():
    """SBS relaxation has no two-float engine; df32 must raise, not
    silently degrade to f32 (round-3 consistency with the GNLSE family)."""
    import dataclasses as dc

    cfg = dc.replace(
        psa.custom_simulation_config(z_max=10.0, dz=0.5, save_every=1),
        precision="df32",
    )
    with pytest.raises(ValueError, match="df32"):
        sbs.run_sbs_simulation(
            cfg, gamma=1e-3, alpha=0.0, g_B=0.01, delta_beta=0.0,
            p_in=[0.1, 0.1, 0.0, 0.0], p_stokes_seed=[1e-5] * 4,
        )
