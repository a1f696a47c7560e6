"""Sweep-engine tests: batched solves vs per-point single runs, golden parity
with the executed reference sweep, NaN masking, PSA phase sweep physics,
2-D grids, and mesh sharding on the virtual 8-device CPU mesh."""

from pathlib import Path

import jax
import numpy as np
import pytest

import psa
from psa_simulation_ode_rk_mvp_dispersion.ops.rhs import RHSCoeffs
from psa_simulation_ode_rk_mvp_dispersion.parallel import mesh as pmesh
from psa_simulation_ode_rk_mvp_dispersion.parallel import sweep as sw

GOLDEN_DIR = Path(__file__).parent / "golden"


def _spectrum_inputs(n=8, frame="lab"):
    g = np.load(GOLDEN_DIR / "golden_spectrum.npz")
    disp = psa.dispersion_params_from_D_S(
        lambda_ref_m=float(g["lambda_c"]), D=float(g["D"]), S=float(g["S"]), dSdlmbd=0,
        D_units="ps/nm/km", S_units="ps/nm^2/km", dSdlmbd_units="ps/nm^3/km",
        omega_ref=float(g["omega_c"]), compat_reference_beta4_bug=True,
    )
    pm = psa.PhaseMatchingConfig(
        method=psa.PhaseMatchingMethod.SYMMETRIC_EVEN, even_orders=(2, 4), max_order=4
    )
    cfg = psa.custom_simulation_config(z_max=500.0, dz=0.2)
    return dict(
        cfg=cfg,
        lambda_p1_m=float(g["lam1"]),
        lambda_p2_m=float(g["lam2"]),
        lambda_signal_m=np.asarray(g["lam3"])[:n],
        gamma=float(g["gamma"]),
        alpha=float(g["alpha"]),
        p_in=np.asarray(g["p_in"]),
        phase_in=np.zeros(4),
        dispersion=disp,
        phase_matching_cfg=pm,
        length_unit="m",
        gain_unit="dB",
        frame=frame,
    ), g


def test_gain_and_dbeta_spectrum_matches_reference_golden():
    """Batched sweep reproduces the reference's per-point loop results
    (golden data generated by executing /root/reference)."""
    kwargs, g = _spectrum_inputs(n=16, frame="lab")
    res = sw.gain_and_dbeta_spectrum(**kwargs)
    np.testing.assert_allclose(res.x, np.asarray(g["lam3"]) * 1e9, rtol=1e-12)
    np.testing.assert_allclose(res.gain, np.asarray(g["gain_db"]), rtol=1e-9, atol=1e-8)
    np.testing.assert_allclose(res.dbeta, np.asarray(g["dbeta"]), rtol=1e-9)


def test_gain_spectrum_rotating_frame_matches_lab():
    kwargs, _ = _spectrum_inputs(n=6, frame="lab")
    lab = sw.gain_spectrum(**kwargs)
    kwargs2, _ = _spectrum_inputs(n=6, frame="rotating")
    rot = sw.gain_spectrum(**kwargs2)
    np.testing.assert_allclose(rot.gain, lab.gain, rtol=1e-7, atol=1e-7)


def test_gain_spectrum_matches_per_point_single_runs():
    kwargs, g = _spectrum_inputs(n=5, frame="lab")
    res = sw.gain_spectrum(**kwargs)
    for i, lam3 in enumerate(kwargs["lambda_signal_m"]):
        omega = np.asarray(
            psa.plan_from_wavelengths(kwargs["lambda_p1_m"], kwargs["lambda_p2_m"], float(lam3))
        )
        z, A = psa.run_single_simulation(
            kwargs["cfg"], gamma=kwargs["gamma"], alpha=kwargs["alpha"], omega=omega,
            p_in=kwargs["p_in"], phase_in=kwargs["phase_in"],
            dispersion=kwargs["dispersion"], phase_matching_cfg=kwargs["phase_matching_cfg"],
            length_unit="m",
        )
        gain_i = 10 * np.log10(np.max(np.abs(A[:, 2]) ** 2) / kwargs["p_in"][2])
        assert res.gain[i] == pytest.approx(gain_i, abs=1e-9)


def test_invalid_wavelength_points_masked_nan():
    """Points whose inferred idler frequency would be non-positive produce
    NaN, not an exception (reference scan_mismtach.py:391-392 semantics)."""
    kwargs, _ = _spectrum_inputs(n=4, frame="lab")
    # lambda3 tiny -> omega3 huge -> omega4 = w1+w2-w3 < 0 for the 2nd point
    lam = np.array(kwargs["lambda_signal_m"])
    lam[1] = 600e-9
    kwargs["lambda_signal_m"] = lam
    res = sw.gain_spectrum(**kwargs)
    assert np.isnan(res.gain[1])
    assert not res.ok[1]
    assert np.all(np.isfinite(np.delete(res.gain, 1)))


def test_sweep_requires_signal_seed():
    kwargs, _ = _spectrum_inputs(n=3)
    kwargs["p_in"] = np.array([0.1, 0.1, 0.0, 0.0])
    with pytest.raises(ValueError, match="signal seed"):
        sw.gain_spectrum(**kwargs)


def test_mismatch_scan_peak_location():
    """Parametric gain vs provided dbeta: peak near dbeta = -2*gamma*P_pump
    for a dual-pump PSA (ideal phase matching kappa = dbeta + gamma(P1+P2)+...),
    and the scan is symmetric-ish with a clear best point."""
    cfg = psa.custom_simulation_config(z_max=0.5, dz=1e-3)
    gamma, alpha = 10.0, 0.0
    p_in = [0.05, 0.05, 1e-5, 0.0]
    db = np.linspace(-40.0, 40.0, 81)
    sig, idl = sw.mismatch_scan(
        cfg=cfg, gamma=gamma, alpha=alpha, p_in=p_in, delta_beta_values=db,
        gain_mode="end", gain_unit="linear", length_unit="km",
    )
    assert sig.gain.shape == db.shape
    assert np.all(sig.ok)
    best_db = db[sig.best_index]
    # peak expected around -2*gamma*(P1+P2)/... within grid resolution; just
    # require an interior maximum with real gain
    assert sig.gain[sig.best_index] > 1.0
    assert -40.0 < best_db < 40.0
    # idler grows from zero seed
    assert np.nanmax(idl.gain) > 0.0


def test_mismatch_scan_matches_single_runs():
    cfg = psa.custom_simulation_config(z_max=0.5, dz=1e-3)
    db_vals = np.array([-10.0, 0.0, 15.0])
    sig, _ = sw.mismatch_scan(
        cfg=cfg, gamma=10.0, alpha=0.0, p_in=[0.05, 0.05, 1e-5, 0.0],
        delta_beta_values=db_vals, gain_mode="end", gain_unit="linear",
        length_unit="km", frame="lab",
    )
    omega0 = 2 * np.pi * psa.constants.c / 1.55e-6
    for i, db in enumerate(db_vals):
        pm = psa.PhaseMatchingConfig(
            method=psa.PhaseMatchingMethod.PROVIDED, provided_delta_beta=float(db)
        )
        z, A = psa.run_single_simulation(
            cfg, gamma=10.0, alpha=0.0, omega=np.full(4, omega0),
            p_in=[0.05, 0.05, 1e-5, 0.0], phase_matching_cfg=pm, length_unit="km",
        )
        g = np.abs(A[-1, 2]) ** 2 / 1e-5
        assert sig.gain[i] == pytest.approx(g, rel=1e-10)


def test_psa_phase_sweep_is_phase_sensitive():
    """With a seeded idler, gain must depend on the input signal phase
    (the defining PSA property), with period pi in signal phase."""
    cfg = psa.custom_simulation_config(z_max=0.2, dz=1e-3)
    phases = np.linspace(0, 2 * np.pi, 33)
    res = sw.psa_phase_sweep(
        cfg=cfg, gamma=10.0, alpha=0.0,
        p_in=[0.1, 0.1, 1e-4, 1e-4],   # idler seeded -> phase-sensitive
        signal_phases=phases, delta_beta=0.0, gain_unit="linear",
        length_unit="km",
    )
    g = res.gain
    assert np.all(np.isfinite(g))
    assert g.max() / g.min() > 1.5  # clear phase sensitivity
    # theta enters as phi1+phi2-phi3-phi4: gain is 2pi-periodic in phi3 with
    # a single max/min pair separated by pi
    assert g[0] == pytest.approx(g[-1], rel=1e-9)  # phi=0 vs phi=2pi
    dphi = abs(phases[np.argmax(g)] - phases[np.argmin(g)])
    assert dphi == pytest.approx(np.pi, abs=0.25)


def test_gain_map_power_wavelength_shape_and_monotonicity():
    kwargs, g = _spectrum_inputs(n=6)
    x, pows, gm = sw.gain_map_power_wavelength(
        cfg=kwargs["cfg"],
        lambda_p1_m=kwargs["lambda_p1_m"],
        lambda_p2_m=kwargs["lambda_p2_m"],
        lambda_signal_m=kwargs["lambda_signal_m"],
        pump_powers_W=[0.05, 0.1, 0.2],
        gamma=kwargs["gamma"], alpha=kwargs["alpha"],
        dispersion=kwargs["dispersion"], phase_matching_cfg=kwargs["phase_matching_cfg"],
        length_unit="m", gain_unit="dB",
    )
    assert gm.shape == (3, 6)
    assert np.all(np.isfinite(gm))
    # more pump power -> more max gain at the best wavelength
    assert gm[2].max() > gm[0].max()


def test_solve_batch_trajectories_match_reduce_summaries():
    cfg = psa.custom_simulation_config(z_max=100.0, dz=0.1, save_every=10)
    B = 7
    rng = np.random.default_rng(0)
    coeffs = RHSCoeffs(
        gamma=np.full(B, 0.01), alpha=np.full(B, 1e-4),
        delta_beta=rng.uniform(-0.5, 0.5, B),
    )
    A0 = np.sqrt(np.array([0.3, 0.3, 1e-5, 0.0]))[None, :] * np.ones((B, 1))
    A0 = A0.astype(np.complex128)
    z, A, ok = sw.solve_batch_trajectories(cfg, coeffs, A0, frame="lab")
    assert A.shape == (B, 101, 4)
    assert np.all(ok)
    res = sw.solve_batch(cfg, coeffs, A0, frame="lab")
    np.testing.assert_allclose(
        res.P_max, np.max(np.abs(A) ** 2, axis=1), rtol=1e-12
    )
    np.testing.assert_allclose(res.A_end, A[:, -1], rtol=1e-12)


def test_sharded_sweep_matches_unsharded():
    """The same sweep on an 8-device mesh must agree with single-device."""
    assert len(jax.devices()) == 8, "conftest should provide 8 CPU devices"
    kwargs, _ = _spectrum_inputs(n=13)  # deliberately not divisible by 8
    plain = sw.gain_spectrum(**kwargs)
    mesh = pmesh.default_mesh()
    assert mesh is not None
    sharded = sw.gain_spectrum(**kwargs, mesh=mesh)
    np.testing.assert_allclose(sharded.gain, plain.gain, rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(sharded.ok, plain.ok)


def test_pad_batch():
    a = np.arange(10.0)
    p, n = pmesh.pad_batch(a, 8)
    assert n == 10 and p.shape[0] == 16
    np.testing.assert_array_equal(p[10:], np.full(6, 9.0))
    p2, n2 = pmesh.pad_batch(a[:8], 8)
    assert n2 == 8 and p2.shape[0] == 8


def test_psa_phase_sweep_provided_cfg_without_omega():
    """A PROVIDED phase_matching_cfg needs no omega (regression: previously
    rejected with 'omega is required')."""
    cfg = psa.custom_simulation_config(z_max=0.1, dz=1e-3)
    res = sw.psa_phase_sweep(
        cfg=cfg, gamma=10.0, alpha=0.0, p_in=[0.1, 0.1, 1e-4, 1e-4],
        signal_phases=np.linspace(0, np.pi, 5),
        phase_matching_cfg=psa.PhaseMatchingConfig(
            method=psa.PhaseMatchingMethod.PROVIDED, provided_delta_beta=0.5
        ),
        gain_unit="linear", length_unit="km",
    )
    assert np.all(np.isfinite(res.gain))


def test_solve_batch_trajectories_sharded():
    cfg = psa.custom_simulation_config(z_max=50.0, dz=0.1, save_every=50)
    B = 11  # not divisible by 8
    rng = np.random.default_rng(4)
    coeffs = RHSCoeffs(
        gamma=np.full(B, 0.01), alpha=np.full(B, 1e-4),
        delta_beta=rng.uniform(-0.5, 0.5, B),
    )
    A0 = (np.sqrt([0.3, 0.3, 1e-5, 0.0])[None, :] * np.ones((B, 1))).astype(np.complex128)
    z1, A1, ok1 = sw.solve_batch_trajectories(cfg, coeffs, A0, frame="lab")
    mesh = pmesh.default_mesh()
    z2, A2, ok2 = sw.solve_batch_trajectories(cfg, coeffs, A0, frame="lab", mesh=mesh)
    np.testing.assert_array_equal(z1, z2)
    np.testing.assert_allclose(A2, A1, rtol=1e-12)
    np.testing.assert_array_equal(ok1, ok2)


def test_bench_config_gain_spectrum_golden():
    """The exact configuration bench.py measures, validated against golden
    data from the executed reference -- guards the headline benchmark's
    physics against regressions."""
    g = np.load(GOLDEN_DIR / "golden_bench_config.npz")
    disp = psa.dispersion_params_from_D_S(
        lambda_ref_m=float(g["lambda_c"]), D=float(g["D"]), S=float(g["S"]),
        dSdlmbd=0, D_units="ps/nm/km", S_units="ps/nm^2/km",
        dSdlmbd_units="ps/nm^3/km", omega_ref=float(g["omega_c"]),
        compat_reference_beta4_bug=True,
    )
    res = sw.gain_spectrum(
        cfg=psa.custom_simulation_config(z_max=500.0, dz=0.2),
        lambda_p1_m=float(g["lam1"]), lambda_p2_m=float(g["lam2"]),
        lambda_signal_m=np.asarray(g["lam3"]),
        gamma=float(g["gamma"]), alpha=float(g["alpha"]),
        p_in=np.asarray(g["p_in"]), phase_in=np.zeros(4),
        dispersion=disp,
        phase_matching_cfg=psa.PhaseMatchingConfig(
            method=psa.PhaseMatchingMethod.SYMMETRIC_EVEN,
            even_orders=(2, 4), max_order=4,
        ),
        length_unit="m", gain_unit="dB", frame="lab",
    )
    np.testing.assert_allclose(res.gain, np.asarray(g["gain_db"]), rtol=1e-9,
                               atol=1e-8)


def test_chunked_progress_dispatch_identical_and_reports():
    """progress= triggers chunked dispatch (live instrumentation for long
    scans, reference scan_mismtach.py:162-180); results must be identical to
    the monolithic program, chunks padded to one compile shape."""
    B = 100
    cfg = psa.custom_simulation_config(z_max=5.0, dz=0.1, save_every=10)
    coeffs = RHSCoeffs(
        gamma=np.full(B, 0.0115), alpha=np.full(B, 1e-4),
        delta_beta=np.linspace(-0.5, 0.5, B),
    )
    A0 = np.broadcast_to(
        np.sqrt([0.3, 0.3, 1e-6, 0.0]).astype(np.complex128), (B, 4)
    ).copy()
    plain = sw.solve_batch(cfg, coeffs, A0)
    calls = []
    chunked = sw.solve_batch(
        cfg, coeffs, A0,
        progress=lambda done, total, elapsed: calls.append((done, total)),
        progress_chunk=32,  # B=100 -> 4 chunks, last one padded
    )
    assert calls == [(32, 100), (64, 100), (96, 100), (100, 100)]
    # chunked (B=32-padded) and monolithic (B=100) are separate XLA programs;
    # the stacked-output epilogue can reorder instruction scheduling by one
    # ulp, so identity here is machine-precision, not bitwise
    np.testing.assert_allclose(chunked.P_max, plain.P_max, rtol=1e-14)
    np.testing.assert_allclose(chunked.A_end, plain.A_end, rtol=0,
                               atol=1e-14 * np.abs(plain.A_end).max())
    np.testing.assert_array_equal(chunked.ok, plain.ok)


def test_gain_map_result_dataclass_fields():
    kwargs, g = _spectrum_inputs(n=4)
    gm = sw.gain_map_power_wavelength(
        cfg=kwargs["cfg"], lambda_p1_m=kwargs["lambda_p1_m"],
        lambda_p2_m=kwargs["lambda_p2_m"],
        lambda_signal_m=kwargs["lambda_signal_m"],
        pump_powers_W=[0.1, 0.2], gamma=kwargs["gamma"], alpha=kwargs["alpha"],
        dispersion=kwargs["dispersion"],
        phase_matching_cfg=kwargs["phase_matching_cfg"], length_unit="m",
    )
    assert gm.gain.shape == (2, 4) and gm.ok.shape == (2, 4)
    assert gm.ok.all() and np.isfinite(gm.gain).all()
    ip, il = gm.best_index
    assert gm.gain[ip, il] == np.nanmax(gm.gain)
    x, pows, gain = gm  # tuple-compat
    np.testing.assert_array_equal(gain, gm.gain)


def test_best_index_all_nan_raises_descriptive():
    """Round-2 review fix: np.nanargmax on an all-failed map raised numpy's
    bare 'All-NaN slice encountered'; both result types now raise a
    descriptive ValueError pointing at the ok mask."""
    nanmap = np.full((2, 3), np.nan)
    gm = sw.GainMapResult(
        x=np.arange(3.0), pump_powers=np.arange(2.0), gain=nanmap,
        ok=np.zeros((2, 3), bool), gain_unit="dB", elapsed_s=0.1,
        points_per_s=1.0,
    )
    with pytest.raises(ValueError, match="ok mask"):
        gm.best_index
    sr = sw.SweepResult(
        x=np.arange(3.0), gain=np.full(3, np.nan), dbeta=None,
        ok=np.zeros(3, bool), gain_unit="dB", elapsed_s=0.1, points_per_s=1.0,
    )
    with pytest.raises(ValueError, match="ok mask"):
        sr.best_index
