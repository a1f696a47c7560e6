"""Adaptive (rk45) dispatch in the batched sweep engine.

Round-1 verdict: sweeps silently ignored ``cfg.integrator`` (the reference's
reserved slot, /root/reference/config.py:89).  These tests pin the contract:
every sweep API honors integrator='rk45' (matching the rk4 sweep to
tolerance, sharded == unsharded), and combinations that cannot honor it
raise instead of substituting silently.
"""

import dataclasses

import jax
import numpy as np
import pytest

import psa
from psa_simulation_ode_rk_mvp_dispersion.ops.rhs import RHSCoeffs
from psa_simulation_ode_rk_mvp_dispersion.parallel import mesh as pmesh
from psa_simulation_ode_rk_mvp_dispersion.parallel import sweep as sw

from test_sweep import _spectrum_inputs


def _rk45_cfg(cfg, rtol=1e-10, atol=1e-13):
    return dataclasses.replace(cfg, integrator="rk45", rtol=rtol, atol=atol)


def test_gain_spectrum_rk45_matches_rk4():
    kwargs, _ = _spectrum_inputs(n=8, frame="rotating")
    r4 = sw.gain_and_dbeta_spectrum(**kwargs)
    kwargs["cfg"] = _rk45_cfg(kwargs["cfg"])
    r45 = sw.gain_and_dbeta_spectrum(**kwargs)
    np.testing.assert_array_equal(r45.ok, r4.ok)
    np.testing.assert_allclose(r45.gain, r4.gain, rtol=1e-7, atol=1e-7)
    np.testing.assert_allclose(r45.dbeta, r4.dbeta, rtol=1e-12)


def test_gain_spectrum_rk45_sharded_matches_unsharded():
    assert len(jax.devices()) == 8, "conftest should provide 8 CPU devices"
    kwargs, _ = _spectrum_inputs(n=11, frame="rotating")  # not divisible by 8
    kwargs["cfg"] = _rk45_cfg(kwargs["cfg"])
    plain = sw.gain_spectrum(**kwargs)
    mesh = pmesh.default_mesh()
    assert mesh is not None
    sharded = sw.gain_spectrum(**kwargs, mesh=mesh)
    np.testing.assert_allclose(sharded.gain, plain.gain, rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(sharded.ok, plain.ok)


def test_mismatch_scan_rk45_matches_rk4():
    cfg = psa.custom_simulation_config(z_max=0.5, dz=1e-3, save_every=10)
    common = dict(
        gamma=10.0, alpha=0.0, p_in=[0.5, 0.5, 1e-4, 0.0],
        delta_beta_values=np.linspace(-30.0, 10.0, 9),
        gain_mode="end", gain_unit="linear", length_unit="km",
    )
    s4, i4 = sw.mismatch_scan(cfg=cfg, **common)
    s45, i45 = sw.mismatch_scan(cfg=_rk45_cfg(cfg), **common)
    # agreement is limited by rk4's own truncation error at dz=1e-3 km under
    # ~34 dB of gain (rk45 at rtol=1e-10 is the tighter solution)
    np.testing.assert_allclose(s45.gain, s4.gain, rtol=5e-6)
    np.testing.assert_allclose(i45.gain, i4.gain, rtol=5e-6)


def test_psa_phase_sweep_rk45():
    cfg = psa.custom_simulation_config(z_max=0.2, dz=1e-3)
    common = dict(
        gamma=10.0, alpha=0.0, p_in=[0.3, 0.3, 1e-3, 1e-3],
        signal_phases=np.linspace(0.0, 2 * np.pi, 13),
        delta_beta=0.0, gain_unit="dB", length_unit="km",
    )
    r4 = sw.psa_phase_sweep(cfg=cfg, **common)
    r45 = sw.psa_phase_sweep(cfg=_rk45_cfg(cfg), **common)
    np.testing.assert_allclose(r45.gain, r4.gain, rtol=1e-6, atol=1e-6)


def test_solve_batch_trajectories_rk45_matches_rk4():
    cfg = psa.custom_simulation_config(z_max=50.0, dz=0.1, save_every=50)
    B = 5
    rng = np.random.default_rng(7)
    coeffs = RHSCoeffs(
        gamma=np.full(B, 0.01), alpha=np.full(B, 1e-4),
        delta_beta=rng.uniform(-0.5, 0.5, B),
    )
    A0 = (np.sqrt([0.3, 0.3, 1e-5, 0.0])[None, :] * np.ones((B, 1))).astype(
        np.complex128
    )
    z1, A1, ok1 = sw.solve_batch_trajectories(cfg, coeffs, A0, frame="lab")
    z2, A2, ok2 = sw.solve_batch_trajectories(
        _rk45_cfg(cfg), coeffs, A0, frame="lab"
    )
    np.testing.assert_allclose(z2, z1, rtol=0, atol=1e-12)
    assert np.all(ok2)
    np.testing.assert_allclose(A2, A1, rtol=1e-7, atol=1e-9)


def test_rk45_rejects_pallas_engine():
    kwargs, _ = _spectrum_inputs(n=4)
    kwargs["cfg"] = _rk45_cfg(kwargs["cfg"])
    with pytest.raises(ValueError, match="pallas"):
        sw.gain_spectrum(**kwargs, engine="pallas")


def test_rk45_df32_dispatches_to_compensated_engine(monkeypatch):
    """Round 3: integrator='rk45' + precision='df32' no longer raises -- it
    dispatches to the two-float DP45 engine (ops/df32_adaptive.py).  The
    dispatch is verified by stubbing the engine (XLA:CPU two-float compiles
    of its jitted solver are pathological)."""
    from psa_simulation_ode_rk_mvp_dispersion.ops import (
        df32_adaptive as da,
    )
    from psa_simulation_ode_rk_mvp_dispersion.ops.df32_solver import (
        DF32BatchResult,
    )

    calls = []

    def fake(A0, gamma, alpha, dbeta, **kw):
        calls.append(kw)
        B = A0.shape[0]
        P = np.abs(np.asarray(A0)) ** 2
        return DF32BatchResult(P_max=P, A_end=np.asarray(A0).copy(),
                               ok=np.ones(B, dtype=bool))

    monkeypatch.setattr(da, "solve_batch_df32_rk45", fake)
    kwargs, _ = _spectrum_inputs(n=4)
    kwargs["cfg"] = dataclasses.replace(_rk45_cfg(kwargs["cfg"]),
                                        precision="df32")
    res = sw.gain_spectrum(**kwargs)
    assert len(calls) == 1
    assert calls[0]["rtol"] == kwargs["cfg"].rtol
    assert res.gain.shape == (4,)


def test_rk45_trajectories_reject_df32():
    cfg = dataclasses.replace(
        psa.custom_simulation_config(z_max=1.0, dz=0.01, integrator="rk45"),
        precision="df32",
    )
    coeffs = RHSCoeffs(gamma=np.ones(2), alpha=np.zeros(2), delta_beta=np.zeros(2))
    A0 = np.ones((2, 4), dtype=np.complex128)
    # trajectory mode has no two-float engine at ANY integrator, so the
    # generic df32 refusal fires (before the rk45-specific check)
    with pytest.raises(ValueError, match="df32"):
        sw.solve_batch_trajectories(cfg, coeffs, A0)


def test_rk45_save_every_exceeding_steps_matches_rk4():
    """Round-2 review fix: ``max(1, n_chunks)`` made the rk45 sweep integrate
    a whole save_every chunk PAST cfg.z_max when n_steps < save_every.  With
    no saved step beyond row 0, both integrators' saved-grid outputs are the
    initial conditions."""
    cfg = psa.custom_simulation_config(z_max=1.0, dz=0.1, save_every=20)
    B = 5
    A0 = np.sqrt(np.array([0.5, 0.5, 1e-4, 0.0]))[None, :] * np.ones((B, 1))
    A0 = A0.astype(np.complex128)
    coeffs = RHSCoeffs(
        gamma=np.full(B, 10.0), alpha=np.zeros(B),
        delta_beta=np.linspace(-5.0, 5.0, B),
    )
    r4 = sw.solve_batch(cfg, coeffs, A0)
    r45 = sw.solve_batch(_rk45_cfg(cfg), coeffs, A0)
    P0 = np.abs(A0) ** 2
    np.testing.assert_allclose(r4.P_max, P0, rtol=0, atol=0)
    np.testing.assert_allclose(r45.P_max, P0, rtol=0, atol=0)
    np.testing.assert_allclose(r4.A_end, A0, rtol=0, atol=0)
    np.testing.assert_allclose(r45.A_end, A0, rtol=0, atol=0)
    assert np.all(r45.ok)

    # trajectory mode: saved grid is exactly row 0
    z4, A4t, ok4 = sw.solve_batch_trajectories(cfg, coeffs, A0)
    z45, A45t, ok45 = sw.solve_batch_trajectories(_rk45_cfg(cfg), coeffs, A0)
    np.testing.assert_array_equal(z4, [0.0])
    np.testing.assert_array_equal(z45, [0.0])
    np.testing.assert_allclose(A45t, A4t, rtol=0, atol=0)
    assert np.all(ok45)


def test_run_single_rk45_save_every_exceeding_steps():
    """Single-run rk45 with save_every > n_steps: saved grid is row 0 only
    (was a ValueError from a 1-point z_grid before the round-2 fix)."""
    omega0 = 2 * np.pi * psa.constants.c / 1.55e-6
    pm = psa.PhaseMatchingConfig(
        method=psa.PhaseMatchingMethod.PROVIDED, provided_delta_beta=0.0
    )
    common = dict(
        gamma=10.0, alpha=0.0, omega=np.full(4, omega0),
        p_in=np.array([0.1, 0.1, 1e-4, 0.0]), phase_matching_cfg=pm,
        length_unit="km",
    )
    cfg45 = psa.custom_simulation_config(
        z_max=0.01, dz=1e-3, save_every=100, integrator="rk45"
    )
    z45, A45 = psa.run_single_simulation(cfg45, **common)
    cfg4 = psa.custom_simulation_config(z_max=0.01, dz=1e-3, save_every=100)
    z4, A4 = psa.run_single_simulation(cfg4, **common)
    np.testing.assert_array_equal(z45, z4)
    assert A45.shape == A4.shape == (1, 4)
    np.testing.assert_allclose(A45, A4, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# The x32 adaptive scan engine against the x64 truth
# ---------------------------------------------------------------------------

def _adaptive_inputs(B=64):
    gamma = np.full(B, 11.5e-3)
    alpha = np.full(B, 1.15e-4)
    dbeta = np.linspace(-0.5, 0.5, B)
    A0 = np.tile(np.sqrt(np.array([0.5, 0.5, 1e-7, 1e-7])) + 0j, (B, 1))
    return gamma, alpha, dbeta, A0


def test_rk45_x32_scan_within_tolerance_of_x64_truth():
    """integrator='rk45' at x32 (rotating frame) lands within the
    controller tolerance class of a tight x64 truth."""
    gamma, alpha, dbeta, A0 = _adaptive_inputs()
    co = RHSCoeffs(gamma=gamma, alpha=alpha, delta_beta=dbeta)
    n_steps, dz = 500, 1.0
    cfg32 = psa.custom_simulation_config(
        z_max=n_steps * dz, dz=dz, save_every=50, precision="x32",
        integrator="rk45", rtol=1e-6, atol=1e-10)
    rs = sw.solve_batch(cfg32, co, A0, engine="scan")
    cfg64 = dataclasses.replace(cfg32, precision="x64", rtol=1e-11,
                                atol=1e-14)
    rt = sw.solve_batch(cfg64, co, A0, engine="scan")
    assert rs.ok.all() and rt.ok.all()
    assert np.max(np.abs(rs.P_max / rt.P_max - 1)) < 5e-4


def test_rk45_scan_failure_masking_and_edge_cases():
    gamma, alpha, dbeta, A0 = _adaptive_inputs(16)
    co = RHSCoeffs(gamma=gamma, alpha=alpha, delta_beta=dbeta)
    # lane 3: runaway gain (negative loss) -> overflow -> masked, not raised
    alpha = alpha.copy()
    alpha[3] = -50.0
    co_bad = RHSCoeffs(gamma=gamma, alpha=alpha, delta_beta=dbeta)
    mk = lambda n: psa.custom_simulation_config(  # noqa: E731
        z_max=float(n), dz=1.0, save_every=50, precision="x32",
        integrator="rk45", rtol=1e-6, atol=1e-10)
    r = sw.solve_batch(mk(200), co_bad, A0, engine="scan")
    healthy = np.arange(16) != 3
    assert not r.ok[3]
    assert r.ok[healthy].all()
    assert np.isfinite(r.P_max[healthy]).all()

    # n_chunks == 0: saved grid is row 0 only -> ICs come straight back,
    # but the (all-trailing) span IS integrated and can only clear ok
    r0 = sw.solve_batch(mk(5), co, A0, engine="scan")
    np.testing.assert_allclose(r0.A_end, A0, rtol=1e-6, atol=1e-9)
    assert r0.ok.all()

    with pytest.raises(ValueError, match="shape"):
        sw.solve_batch(mk(10), co, A0[:, :3], engine="scan")


def test_rk45_pallas_rejects_unsupported_combos():
    """x64/df32 or lab frame with engine='pallas'+rk45 raise loudly."""
    kwargs, _ = _spectrum_inputs(n=4)
    kwargs["cfg"] = dataclasses.replace(
        _rk45_cfg(kwargs["cfg"]), precision="x64")
    with pytest.raises(ValueError, match="pallas"):
        sw.gain_spectrum(**kwargs, engine="pallas")


def test_rk45_scan_trailing_partial_steps():
    """Scan engine decimation contract (round 4): the trailing
    ``n_steps % save_every`` span is integrated but unsaved -- saved
    summaries match a run ending on the grid, and a blow-up confined to
    the tail still flips ``ok``."""
    gamma, alpha, dbeta, A0 = _adaptive_inputs(8)
    co = RHSCoeffs(gamma=gamma, alpha=alpha, delta_beta=dbeta)
    mk = lambda n: psa.custom_simulation_config(
        z_max=float(n), dz=1.0, save_every=40,
        integrator="rk45", rtol=1e-9, atol=1e-12)
    r_grid = sw.solve_batch(mk(80), co, A0, engine="scan")
    r_tail = sw.solve_batch(mk(100), co, A0, engine="scan")
    np.testing.assert_allclose(r_tail.P_max, r_grid.P_max, rtol=1e-12)
    np.testing.assert_allclose(r_tail.A_end, r_grid.A_end, rtol=1e-12)
    assert r_tail.ok.all()
    # blow-up strictly inside the tail (runaway gain, lane 2)
    alpha2 = alpha.copy()
    alpha2[2] = -2.0
    co_bad = RHSCoeffs(gamma=gamma, alpha=alpha2, delta_beta=dbeta)
    cfg_short = psa.custom_simulation_config(
        z_max=45.0, dz=1.0, save_every=40,
        integrator="rk45", rtol=1e-9, atol=1e-12)
    rb = sw.solve_batch(cfg_short, co_bad, A0, engine="scan")
    assert not rb.ok[2]
    assert rb.ok[np.arange(8) != 2].all()


def test_comb_rk45_trailing_partial_steps():
    """Comb rk45: trailing partial span integrated but unsaved (ok only)."""
    import dataclasses

    from psa_simulation_ode_rk_mvp_dispersion.models import nwave as nw

    omega_c = 2 * np.pi * 193.1e12
    grid = nw.CombGrid.centered(omega_c, 2 * np.pi * 50e9, 8)
    disp = psa.DispersionParams.from_betas(omega_c, beta2=-1e-27)
    co = nw.make_comb_coeffs(grid, disp, gamma_W_m=10e-3, alpha_1_m=5e-5)
    A0 = nw.seed_comb(grid, pump_lines={3: 0.3, 5: 0.3},
                      noise_floor_W=1e-9, seed=0)
    mk = lambda z: psa.custom_simulation_config(
        z_max=z, dz=0.5, save_every=40, integrator="rk45",
        rtol=1e-9, atol=1e-12)
    z_g, A_g = nw.run_comb_simulation(mk(40.0), co, A0)   # 80 steps, 2 chunks
    z_t, A_t = nw.run_comb_simulation(mk(50.0), co, A0)   # +20 trailing
    np.testing.assert_allclose(z_t, z_g, rtol=1e-12)
    np.testing.assert_allclose(A_t, A_g, rtol=1e-12)
    # a runaway-gain tail must raise (check_nan single-run contract)
    co_bad = nw.make_comb_coeffs(grid, disp, gamma_W_m=10e-3, alpha_1_m=-3.0)
    with pytest.raises(FloatingPointError):
        nw.run_comb_simulation(mk(22.5), co_bad, A0)      # 45 steps, 5 tail
