"""Checkpoint/resume continuity and observability utilities."""

import json

import numpy as np
import pytest

import psa
from psa_simulation_ode_rk_mvp_dispersion.utils.observability import (
    ThroughputMeter,
    log_run,
)


def _inputs():
    omega = np.asarray(psa.plan_from_wavelengths(1550e-9, 1558e-9, 1553e-9))
    sp = psa.infer_symmetry_from_omegas(omega[0], omega[1], omega[2], omega[3])
    disp = psa.dispersion_params_from_D_S(
        lambda_ref_m=float(psa.lambda_from_omega(sp.omega_c)), D=0.1, S=0.02,
        D_units="ps/nm/km", S_units="ps/nm^2/km",
        omega_ref=float(np.asarray(sp.omega_c)),
    )
    return dict(
        gamma=0.0115, alpha=1.15e-4, omega=omega, dispersion=disp,
        p_in=[0.1, 0.1, 1e-6, 0.0], phase_in=np.zeros(4), length_unit="m",
    )


@pytest.mark.parametrize("frame", ["lab", "rotating"])
def test_split_run_equals_full_run(frame):
    """Integrating [0, 400] in one go == [0, 200] then resuming [200, 400]
    from the saved state (the checkpoint/resume contract)."""
    kw = _inputs()
    cfg_full = psa.custom_simulation_config(z_max=400.0, dz=0.1, save_every=100)
    z_full, A_full = psa.run_single_simulation(cfg_full, frame=frame, **kw)

    cfg_half = psa.custom_simulation_config(z_max=200.0, dz=0.1, save_every=100)
    z1, A1 = psa.run_single_simulation(cfg_half, frame=frame, **kw)
    z2, A2 = psa.run_single_simulation(
        cfg_half, frame=frame, z0=float(z1[-1]), A_init=A1[-1], **kw
    )
    z_joined = np.concatenate([z1, z2[1:]])
    A_joined = np.concatenate([A1, A2[1:]], axis=0)
    np.testing.assert_allclose(z_joined, z_full, rtol=1e-12)
    np.testing.assert_allclose(A_joined, A_full, rtol=1e-10, atol=1e-15)


def test_resume_via_npz_roundtrip(tmp_path):
    """Checkpoint to NPZ, reload, resume -- the full persistence loop."""
    from psa_simulation_ode_rk_mvp_dispersion import io_fwm

    kw = _inputs()
    cfg = psa.custom_simulation_config(z_max=100.0, dz=0.1, save_every=100)
    z1, A1 = psa.run_single_simulation(cfg, **kw)
    p = io_fwm.save_result_npz(tmp_path / "ckpt", z1, A1,
                               metadata={"resume_z": float(z1[-1])})
    z_l, A_l, md = io_fwm.load_result_npz(p)
    z2, A2 = psa.run_single_simulation(
        cfg, z0=md["resume_z"], A_init=A_l[-1], **kw
    )
    assert z2[0] == pytest.approx(100.0)
    assert z2[-1] == pytest.approx(200.0)
    # energy continuity across the seam
    np.testing.assert_allclose(
        np.sum(np.abs(A2[0]) ** 2), np.sum(np.abs(A1[-1]) ** 2), rtol=1e-12
    )


def test_a_init_validation():
    kw = _inputs()
    cfg = psa.custom_simulation_config(z_max=1.0, dz=0.1)
    with pytest.raises(ValueError, match="A_init"):
        psa.run_single_simulation(cfg, A_init=np.ones(3), **kw)


def test_throughput_meter():
    m = ThroughputMeter(label="test")
    m.tick(10)
    m.tick(5)
    assert m.count == 15
    assert m.per_second > 0
    s = m.summary()
    assert "Throughput" in s and "test" in s


def test_log_run(tmp_path):
    p = log_run(tmp_path / "runs.jsonl", {"experiment": "x", "gain_db": 12.5})
    p = log_run(p, {"experiment": "y"})
    lines = p.read_text().strip().splitlines()
    assert len(lines) == 2
    rec = json.loads(lines[0])
    assert rec["experiment"] == "x" and rec["gain_db"] == 12.5
    assert "timestamp_utc" in rec and "backend" in rec


def test_profile_trace_smoke(tmp_path):
    from psa_simulation_ode_rk_mvp_dispersion.utils.observability import (
        profile_trace,
    )
    import jax.numpy as jnp

    with profile_trace(str(tmp_path / "trace")):
        _ = jnp.ones(16) * 2.0
    assert any((tmp_path / "trace").rglob("*"))


def test_checked_rhs_catches_nonfinite():
    """checkify-based in-kernel checks (the sanitizer analog) fire through
    jit/scan and report the failing check."""
    import jax.numpy as jnp

    from psa_simulation_ode_rk_mvp_dispersion.ops.integrators import (
        integrate_fixed_grid,
    )
    from psa_simulation_ode_rk_mvp_dispersion.utils.debug import (
        checked_rhs,
        run_checked,
    )

    def blowup(z, y, p):
        return p * y * y

    rhs_dbg = checked_rhs(blowup, name="blowup")

    def solve(y0, lam):
        return integrate_fixed_grid(
            rhs_dbg, y0, lam, z0=0.0, dz=0.05, n_steps=100, save_every=100,
            check_nan=False,
        ).y_final

    err, out = run_checked(solve, jnp.asarray([1.0]), jnp.asarray(50.0))
    with pytest.raises(Exception, match="blowup|nan|overflow"):
        err.throw()

    # healthy run: no error raised
    err2, out2 = run_checked(solve, jnp.asarray([1.0]), jnp.asarray(0.1))
    err2.throw()
    assert np.isfinite(np.asarray(out2)).all()


# ---------------------------------------------------------------------------
# Checkpoint/resume for the remaining model families (round-3: every family
# restarts from saved state -- reference analog io_fwm.py:297-328 + SURVEY §5)
# ---------------------------------------------------------------------------

def _gnlse_setup(n_samples=128):
    from psa_simulation_ode_rk_mvp_dispersion.models.gnlse import (
        TimeGrid, gaussian_pulse, make_gnlse_coeffs)
    from psa_simulation_ode_rk_mvp_dispersion.ops.dispersion import (
        DispersionParams)

    grid = TimeGrid(n_samples=n_samples, t_window_s=40e-12)
    disp = DispersionParams.from_betas(
        omega_ref=1.2e15, beta2=-2e-26, beta3=1e-40)
    cf = make_gnlse_coeffs(grid, disp, gamma_W_m=1e-2, alpha_1_m=5e-4)
    A0 = gaussian_pulse(grid, peak_W=1.0, t0_s=1e-12)
    return grid, cf, A0


def test_gnlse_resume_bitwise_fixed_step():
    """GNLSE: [0, 10] in one go == [0, 5] + resume [5, 10] BITWISE (the
    co-moving equation is autonomous in z; chunks are not fused across
    save boundaries)."""
    from psa_simulation_ode_rk_mvp_dispersion.models.gnlse import (
        make_nl_terms, run_gnlse_simulation)

    grid, cf, A0 = _gnlse_setup()
    nl = make_nl_terms(grid, omega0=1.2e15)   # raman + steepening too
    cfg = psa.custom_simulation_config(z_max=10.0, dz=0.01, save_every=100)
    cfg_h = psa.custom_simulation_config(z_max=5.0, dz=0.01, save_every=100)
    for terms in (None, nl):
        z_f, A_f = run_gnlse_simulation(cfg, cf, A0, nl=terms)
        z1, A1 = run_gnlse_simulation(cfg_h, cf, A0, nl=terms)
        z2, A2 = run_gnlse_simulation(cfg_h, cf, A1[-1], z0=float(z1[-1]),
                                      nl=terms)
        assert np.array_equal(A_f, np.concatenate([A1, A2[1:]], axis=0))
        np.testing.assert_allclose(np.concatenate([z1, z2[1:]]), z_f,
                                   rtol=1e-12)


def test_gnlse_resume_rk45_to_tolerance():
    """Adaptive path: resume lands on the full run within the controller
    tolerance (the step-size memory restarts, so bitwise is not promised)."""
    import dataclasses

    from psa_simulation_ode_rk_mvp_dispersion.models.gnlse import (
        run_gnlse_simulation)

    _grid, cf, A0 = _gnlse_setup()
    cfg = psa.custom_simulation_config(z_max=10.0, dz=0.05, save_every=20)
    cfg = dataclasses.replace(cfg, integrator="rk45", rtol=1e-9, atol=1e-12)
    cfg_h = dataclasses.replace(cfg, z_max=5.0)
    z_f, A_f = run_gnlse_simulation(cfg, cf, A0)
    z1, A1 = run_gnlse_simulation(cfg_h, cf, A0)
    z2, A2 = run_gnlse_simulation(cfg_h, cf, A1[-1], z0=float(z1[-1]))
    A_res = np.concatenate([A1, A2[1:]], axis=0)
    np.testing.assert_allclose(np.concatenate([z1, z2[1:]]), z_f, rtol=1e-12)
    np.testing.assert_allclose(A_res, A_f, rtol=1e-6, atol=1e-9)


def test_gnlse_batch_resume_and_npz_roundtrip(tmp_path):
    """solve_gnlse_batch: A_last is the restart state; segment peaks combine
    with np.maximum; checkpoint survives an NPZ roundtrip."""
    from psa_simulation_ode_rk_mvp_dispersion import io_fwm
    from psa_simulation_ode_rk_mvp_dispersion.models.gnlse import (
        solve_gnlse_batch)

    _grid, cf, A0 = _gnlse_setup()
    batch = np.stack([A0, 0.5 * A0, 0.25 * A0])
    cfg = psa.custom_simulation_config(z_max=10.0, dz=0.01, save_every=100)
    cfg_h = psa.custom_simulation_config(z_max=5.0, dz=0.01, save_every=100)
    pk_f, Al_f, ok_f = solve_gnlse_batch(cfg, cf, batch)
    pk1, Al1, ok1 = solve_gnlse_batch(cfg_h, cf, batch)
    # one checkpoint row per batch lane (all at the same z)
    p = io_fwm.save_result_npz(tmp_path / "gnlse_ckpt",
                               np.full(len(batch), 5.0), Al1,
                               metadata={"family": "gnlse"})
    _z, Al_loaded, _md = io_fwm.load_result_npz(p)
    pk2, Al2, ok2 = solve_gnlse_batch(cfg_h, cf, Al_loaded)
    assert np.array_equal(Al_f, Al2)
    np.testing.assert_allclose(np.maximum(pk1, pk2), pk_f, rtol=1e-12)
    assert ok_f.all() and ok2.all()


def test_vgnlse_resume_bitwise():
    """Vector GNLSE: split run equals full run bitwise (fixed step)."""
    from psa_simulation_ode_rk_mvp_dispersion.models.gnlse import (
        TimeGrid, gaussian_pulse)
    from psa_simulation_ode_rk_mvp_dispersion.models.vgnlse import (
        make_vgnlse_coeffs, polarized_pulse, run_vgnlse_simulation,
        solve_vgnlse_batch)
    from psa_simulation_ode_rk_mvp_dispersion.ops.dispersion import (
        DispersionParams)

    grid = TimeGrid(n_samples=128, t_window_s=40e-12)
    disp = DispersionParams.from_betas(omega_ref=1.2e15, beta2=-2e-26)
    cf = make_vgnlse_coeffs(grid, disp, gamma_W_m=1e-2, dbeta0_1_m=0.1,
                            coupling="cnlse")
    A0 = polarized_pulse(gaussian_pulse(grid, peak_W=1.0, t0_s=1e-12), 0.4)
    cfg = psa.custom_simulation_config(z_max=10.0, dz=0.01, save_every=100)
    cfg_h = psa.custom_simulation_config(z_max=5.0, dz=0.01, save_every=100)
    z_f, A_f = run_vgnlse_simulation(cfg, cf, A0)
    z1, A1 = run_vgnlse_simulation(cfg_h, cf, A0)
    z2, A2 = run_vgnlse_simulation(cfg_h, cf, A1[-1], z0=float(z1[-1]))
    assert np.array_equal(A_f, np.concatenate([A1, A2[1:]], axis=0))
    np.testing.assert_allclose(np.concatenate([z1, z2[1:]]), z_f, rtol=1e-12)

    # batch: A_last restarts
    pk_f, Al_f, _ = solve_vgnlse_batch(cfg, cf, A0[None])
    pk1, Al1, _ = solve_vgnlse_batch(cfg_h, cf, A0[None])
    pk2, Al2, _ = solve_vgnlse_batch(cfg_h, cf, Al1)
    assert np.array_equal(Al_f, Al2)
    np.testing.assert_allclose(np.maximum(pk1, pk2), pk_f, rtol=1e-12)


def test_sbs_warm_start_resumes_relaxation():
    """SBS: warm-starting from a converged B trajectory reaches the same
    fixed point in fewer sweeps (B alone is the full relaxation state)."""
    from psa_simulation_ode_rk_mvp_dispersion.models.sbs import (
        run_sbs_batch, run_sbs_simulation)

    cfg = psa.custom_simulation_config(z_max=100.0, dz=0.5, save_every=10)
    kw = dict(gamma=3e-3, alpha=2e-4, g_B=0.1, delta_beta=0.05,
              p_in=[0.3, 0.3, 1e-3, 0.0], p_stokes_seed=[1e-4] * 4)
    r1 = run_sbs_simulation(cfg, **kw, tol=1e-12, max_iterations=60,
                            damping=0.7)
    r2 = run_sbs_simulation(cfg, **kw, tol=1e-12, max_iterations=60,
                            damping=0.7, B_init=r1.B)
    assert r2.n_iterations < r1.n_iterations
    np.testing.assert_allclose(r2.A, r1.A, atol=1e-10)
    np.testing.assert_allclose(r2.B, r1.B, atol=1e-10)

    # exact warm start (save_every=1): converged guess re-converges in one
    # sweep
    cfg1 = psa.custom_simulation_config(z_max=100.0, dz=0.5, save_every=1)
    r3 = run_sbs_simulation(cfg1, **kw, tol=1e-12, max_iterations=60,
                            damping=0.7)
    r4 = run_sbs_simulation(cfg1, **kw, tol=1e-12, max_iterations=60,
                            damping=0.7, B_init=r3.B)
    assert r4.n_iterations <= 2
    np.testing.assert_allclose(r4.B, r3.B, atol=1e-11)

    # batch warm start
    P_in = np.tile([0.3, 0.3, 1e-3, 0.0], (3, 1))
    P_st = np.tile([1e-4] * 4, (3, 1))
    bkw = dict(gamma=3e-3, alpha=2e-4, g_B=0.1, delta_beta=0.05,
               P_in=P_in, P_stokes_seed=P_st, tol=1e-12, max_iterations=60,
               damping=0.7)
    z, A, Bw, resid, refl, ok, n_it = run_sbs_batch(cfg, **bkw)
    out2 = run_sbs_batch(cfg, **bkw, B_init=Bw)
    assert (out2[6] < n_it).all()
    np.testing.assert_allclose(out2[1], A, atol=1e-10)
    assert out2[5].all()


def test_sbs_b_init_validation():
    from psa_simulation_ode_rk_mvp_dispersion.models.sbs import (
        run_sbs_simulation)

    cfg = psa.custom_simulation_config(z_max=100.0, dz=0.5, save_every=10)
    kw = dict(gamma=3e-3, alpha=2e-4, g_B=0.1, delta_beta=0.05,
              p_in=[0.3, 0.3, 1e-3, 0.0], p_stokes_seed=[1e-4] * 4)
    with pytest.raises(ValueError, match="B_init"):
        run_sbs_simulation(cfg, **kw, B_init=np.zeros((7, 4)))
    bad = np.full((21, 4), np.nan, dtype=complex)
    with pytest.raises(ValueError, match="finite"):
        run_sbs_simulation(cfg, **kw, B_init=bad)


def test_comb_resume_bitwise_fixed_step():
    """N-wave comb: [0, 100] in one go == [0, 50] + resume [50, 100]
    BITWISE (the rotating-frame comb equation is autonomous in z; round-4
    uniform resume surface, VERDICT r3 #7)."""
    from psa_simulation_ode_rk_mvp_dispersion.models import nwave as nw

    omega_c = 2 * np.pi * 193.1e12
    grid = nw.CombGrid.centered(omega_c, 2 * np.pi * 50e9, 16)
    disp = psa.DispersionParams.from_betas(omega_c, beta2=-1e-27)
    co = nw.make_comb_coeffs(grid, disp, gamma_W_m=10e-3, alpha_1_m=5e-5)
    A0 = nw.seed_comb(grid, pump_lines={6: 0.5, 10: 0.5},
                      noise_floor_W=1e-9, seed=0)
    cfg = psa.custom_simulation_config(z_max=100.0, dz=0.5, save_every=20)
    cfg_h = psa.custom_simulation_config(z_max=50.0, dz=0.5, save_every=20)
    z_f, A_f = nw.run_comb_simulation(cfg, co, A0)
    z1, A1 = nw.run_comb_simulation(cfg_h, co, A0)
    z2, A2 = nw.run_comb_simulation(cfg_h, co, A1[-1], z0=float(z1[-1]))
    assert np.array_equal(A_f, np.concatenate([A1, A2[1:]], axis=0))
    np.testing.assert_allclose(np.concatenate([z1, z2[1:]]), z_f, rtol=1e-12)

    # adaptive path: the controller's step memory restarts, so tolerance
    import dataclasses
    cfg45 = dataclasses.replace(cfg, integrator="rk45", rtol=1e-10,
                                atol=1e-13)
    cfg45_h = dataclasses.replace(cfg45, z_max=50.0)
    z45, A45 = nw.run_comb_simulation(cfg45, co, A0)
    za, Aa = nw.run_comb_simulation(cfg45_h, co, A0)
    zb, Ab = nw.run_comb_simulation(cfg45_h, co, Aa[-1], z0=float(za[-1]))
    np.testing.assert_allclose(np.concatenate([za, zb[1:]]), z45, rtol=1e-12)
    np.testing.assert_allclose(np.concatenate([Aa, Ab[1:]], axis=0), A45,
                               rtol=1e-6, atol=1e-10)

    with pytest.raises(ValueError, match="z0"):
        nw.run_comb_simulation(cfg, co, A0, z0=np.inf)


def test_lle_resume_bitwise_fixed_step():
    """LLE (fixed detuning): split run == full run BITWISE via t0=
    (autonomous; round-4 uniform resume surface, VERDICT r3 #7)."""
    from psa_simulation_ode_rk_mvp_dispersion.models import lle

    grid = lle.TimeGrid(n_samples=128, t_window_s=20.0)
    det, F = 4.0, 2.0
    co = lle.make_lle_coeffs(grid, detuning=det, pump=F, d2=-1.0)
    seed = lle.soliton_ansatz(grid, det, F, -1.0)
    cfg = psa.custom_simulation_config(z_max=2.0, dz=0.01, save_every=50)
    cfg_h = psa.custom_simulation_config(z_max=1.0, dz=0.01, save_every=50)
    for integ in ("rk4", "rk4ip"):
        import dataclasses
        c_f = dataclasses.replace(cfg, integrator=integ)
        c_h = dataclasses.replace(cfg_h, integrator=integ)
        t_f, p_f = lle.run_lle_simulation(c_f, co, seed)
        t1, p1 = lle.run_lle_simulation(c_h, co, seed)
        t2, p2 = lle.run_lle_simulation(c_h, co, p1[-1], t0=float(t1[-1]))
        assert np.array_equal(p_f, np.concatenate([p1, p2[1:]], axis=0))
        np.testing.assert_allclose(np.concatenate([t1, t2[1:]]), t_f,
                                   rtol=1e-12)
    with pytest.raises(ValueError, match="t0"):
        lle.run_lle_simulation(cfg, co, seed, t0=np.nan)


def test_lle_ramp_resume_bitwise():
    """Detuning ramp: the schedule is NOT autonomous -- a resume keeps the
    full ramp definition (same cfg.z_max and endpoints) and restarts at a
    saved (t0, psi) row; per-step detunings come from the GLOBAL step
    index, so the resumed rows are BITWISE the uninterrupted run's."""
    from psa_simulation_ode_rk_mvp_dispersion.models import lle

    grid = lle.TimeGrid(n_samples=128, t_window_s=20.0)
    F = 2.0
    co = lle.make_lle_coeffs(grid, detuning=0.0, pump=F, d2=-1.0)
    rho = lle.cw_steady_states(2.0, F)[0]
    tau = grid.t()
    seed = (lle.cw_state(2.0, F, rho)
            + 1e-3 * np.cos(2 * np.pi * tau / np.ptp(tau)))
    cfg = psa.custom_simulation_config(z_max=2.0, dz=0.01, save_every=50)
    t_f, d_f, p_f = lle.run_lle_ramp(cfg, co, seed, detuning_start=2.0,
                                     detuning_end=4.0)
    k = 2  # resume from the middle save boundary
    t2, d2, p2 = lle.run_lle_ramp(cfg, co, p_f[k], detuning_start=2.0,
                                  detuning_end=4.0, t0=float(t_f[k]))
    assert np.array_equal(p_f[k:], p2)
    np.testing.assert_allclose(t_f[k:], t2, rtol=1e-12)
    np.testing.assert_allclose(d_f[k:], d2, rtol=1e-12)
    # resume at the very end: a single saved row, nothing integrated
    t3, d3, p3 = lle.run_lle_ramp(cfg, co, p_f[-1], detuning_start=2.0,
                                  detuning_end=4.0, t0=float(t_f[-1]))
    assert p3.shape == (1, grid.n_samples) and np.array_equal(p3[0], p_f[-1])
    with pytest.raises(ValueError, match="t0"):
        lle.run_lle_ramp(cfg, co, seed, detuning_start=2.0,
                         detuning_end=4.0, t0=3.0)
