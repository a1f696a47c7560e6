"""End-to-end golden parity vs the executed reference implementation.

Golden data in tests/golden/ was produced by running the NumPy reference
(/root/reference) -- see tests/golden/generate_golden.py.  Target: <=1e-9
relative error on field evolutions (BASELINE.json); achieved ~1e-13 in x64.
"""

from pathlib import Path

import numpy as np
import pytest

import psa

GOLDEN_DIR = Path(__file__).parent / "golden"
REL_TOL = 1e-9


def _max_rel_err(A, A_ref):
    return float(np.max(np.abs(A - A_ref) / np.maximum(np.abs(A_ref), 1e-30)))


def test_example_zero_signal_golden():
    g = np.load(GOLDEN_DIR / "golden_zero_signal.npz")
    z, A = psa.example_zero_signal()
    np.testing.assert_allclose(z, g["z"], rtol=1e-12)
    assert A.shape == g["A"].shape
    assert _max_rel_err(A, g["A"]) < REL_TOL


def test_example_zero_signal_wave_order_consistent():
    """Signal/idler stay exactly zero when unseeded (parity with reference
    tests.py:318-323)."""
    z, A = psa.example_zero_signal()
    np.testing.assert_array_equal(np.abs(A[:, 2]), 0.0)
    np.testing.assert_array_equal(np.abs(A[:, 3]), 0.0)
    assert np.all(np.abs(A[:, 0]) > 0)


def test_custom_seeded_signal_golden():
    g = np.load(GOLDEN_DIR / "golden_seeded.npz")
    z, A = psa.custom_seeded_signal()
    np.testing.assert_allclose(z, g["z"], rtol=1e-12)
    assert _max_rel_err(A, g["A"]) < REL_TOL


def _anchor_inputs():
    """The main_single_simulation configuration (reference main.py:27-96)."""
    cfg = psa.custom_simulation_config(z_max=1000.0, dz=0.1)
    omega = np.asarray(psa.plan_from_wavelengths(1550e-9, 1560e-9, 1555e-9))
    sp = psa.infer_symmetry_from_omegas(omega[0], omega[1], omega[2], omega[3])
    lambda_c = float(psa.lambda_from_omega(sp.omega_c))
    disp = psa.dispersion_params_from_D_S(
        lambda_ref_m=lambda_c, D=0.02, S=0.02, dSdlmbd=0,
        D_units="ps/nm/km", S_units="ps/nm^2/km", dSdlmbd_units="ps/nm^3/km",
        omega_ref=float(np.asarray(sp.omega_c)),
        compat_reference_beta4_bug=True,  # golden data carries the ref defect
    )
    pm = psa.PhaseMatchingConfig(
        method=psa.PhaseMatchingMethod.SYMMETRIC_EVEN, even_orders=(2, 4), max_order=4
    )
    gamma_m = 11.5 / 1000.0
    alpha_m = (np.log(10.0) / 10.0) * 0.9 / 1000.0
    p_in = np.array([0.5, 0.5, 1e-5, 1e-5])
    return cfg, omega, disp, pm, gamma_m, alpha_m, p_in


def test_anchor_trajectory_golden_10k_steps():
    g = np.load(GOLDEN_DIR / "golden_anchor.npz")
    cfg, omega, disp, pm, gamma_m, alpha_m, p_in = _anchor_inputs()
    z, A = psa.run_single_simulation(
        cfg, gamma=gamma_m, alpha=alpha_m, omega=omega, p_in=p_in,
        phase_in=np.zeros(4), dispersion=disp, phase_matching_cfg=pm,
        length_unit="m", return_length_unit="m",
    )
    np.testing.assert_allclose(z, g["z"], rtol=1e-12)
    assert _max_rel_err(A, g["A"]) < REL_TOL

    gain_db = 10 * np.log10(np.abs(A[-1, 2]) ** 2 / p_in[2])
    assert gain_db == pytest.approx(float(g["gain_db"]), abs=1e-6)
    # BASELINE.md regression anchor: 45.292 dB
    assert gain_db == pytest.approx(45.292, abs=1e-3)


def test_anchor_total_power_tracks_exp_alpha_L():
    """Sum |A|^2 / sum |A0|^2 == e^{-alpha L} (measured reference invariant,
    BASELINE.md)."""
    cfg, omega, disp, pm, gamma_m, alpha_m, p_in = _anchor_inputs()
    z, A = psa.run_single_simulation(
        cfg, gamma=gamma_m, alpha=alpha_m, omega=omega, p_in=p_in,
        phase_in=np.zeros(4), dispersion=disp, phase_matching_cfg=pm,
        length_unit="m", return_length_unit="m",
    )
    ratio = np.sum(np.abs(A[-1]) ** 2) / np.sum(np.abs(A[0]) ** 2)
    assert ratio == pytest.approx(np.exp(-alpha_m * 1000.0), rel=1e-9)


def test_anchor_rotating_frame_powers_match_golden():
    """The rotating-frame fast path reproduces the same gain/powers."""
    g = np.load(GOLDEN_DIR / "golden_anchor.npz")
    cfg, omega, disp, pm, gamma_m, alpha_m, p_in = _anchor_inputs()
    z, A = psa.run_single_simulation(
        cfg, gamma=gamma_m, alpha=alpha_m, omega=omega, p_in=p_in,
        phase_in=np.zeros(4), dispersion=disp, phase_matching_cfg=pm,
        length_unit="m", return_length_unit="m", frame="rotating",
    )
    P = np.abs(A) ** 2
    P_ref = np.abs(g["A"]) ** 2
    np.testing.assert_allclose(P, P_ref, rtol=1e-7, atol=1e-16)


def test_km_units_path():
    """length_unit='km' conversions reproduce the same physics as meters."""
    cfg_m = psa.custom_simulation_config(z_max=500.0, dz=0.5)
    cfg_km = psa.custom_simulation_config(z_max=0.5, dz=0.5e-3)
    omega = np.asarray(psa.plan_from_wavelengths(1550e-9, 1558e-9, 1554e-9))
    pm = psa.PhaseMatchingConfig(
        method=psa.PhaseMatchingMethod.PROVIDED, provided_delta_beta=0.8e-3
    )  # 1/km
    pm_m = psa.PhaseMatchingConfig(
        method=psa.PhaseMatchingMethod.PROVIDED, provided_delta_beta=0.8e-6
    )  # same in 1/m
    p_in = np.array([0.3, 0.3, 1e-5, 0.0])
    z_m, A_m = psa.run_single_simulation(
        cfg_m, gamma=10.0 / 1000, alpha=0.2 / 1000, omega=omega, p_in=p_in,
        phase_matching_cfg=pm_m, length_unit="m", return_length_unit="m",
    )
    z_km, A_km = psa.run_single_simulation(
        cfg_km, gamma=10.0, alpha=0.2, omega=omega, p_in=p_in,
        phase_matching_cfg=pm, length_unit="km", return_length_unit="m",
    )
    np.testing.assert_allclose(z_km, z_m, rtol=1e-12)
    np.testing.assert_allclose(A_km, A_m, rtol=1e-10)


def test_beta_legacy_fallback():
    """beta_legacy-only input defaults to PROVIDED dbeta = b3+b4-b1-b2
    (reference simulation.py:199-211, yaman_model.py:96-112)."""
    cfg = psa.custom_simulation_config(z_max=100.0, dz=0.1)
    omega0 = 2 * np.pi * psa.constants.c / 1.55e-6
    omega = np.full(4, omega0)
    p_in = np.array([0.2, 0.2, 1e-5, 0.0])
    betas = np.array([5.0, 5.0, 5.0, 5.0 + 0.01])
    z1, A1 = psa.run_single_simulation(
        cfg, gamma=0.01, alpha=0.0, omega=omega, p_in=p_in,
        beta_legacy=betas, length_unit="m",
    )
    pm = psa.PhaseMatchingConfig(
        method=psa.PhaseMatchingMethod.PROVIDED, provided_delta_beta=0.01
    )
    z2, A2 = psa.run_single_simulation(
        cfg, gamma=0.01, alpha=0.0, omega=omega, p_in=p_in,
        phase_matching_cfg=pm, length_unit="m",
    )
    np.testing.assert_allclose(A1, A2, rtol=1e-12)


def test_run_requires_some_dbeta_source():
    cfg = psa.custom_simulation_config(z_max=1.0, dz=0.01)
    omega = np.full(4, 1.2e15)
    with pytest.raises(ValueError):
        psa.run_single_simulation(
            cfg, gamma=1.0, alpha=0.0, omega=omega, p_in=np.array([0.1, 0.1, 0, 0]),
            length_unit="m",
        )


def test_input_validation():
    cfg = psa.custom_simulation_config(z_max=1.0, dz=0.01)
    pm = psa.PhaseMatchingConfig(
        method=psa.PhaseMatchingMethod.PROVIDED, provided_delta_beta=0.0
    )
    with pytest.raises(ValueError):
        psa.run_single_simulation(
            cfg, gamma=1.0, alpha=0.0, omega=np.full(3, 1.2e15),
            p_in=np.array([0.1, 0.1, 0, 0]), phase_matching_cfg=pm,
        )
    with pytest.raises(ValueError):
        psa.run_single_simulation(
            cfg, gamma=1.0, alpha=0.0, omega=np.full(4, 1.2e15),
            p_in=np.array([0.1, -0.1, 0, 0]), phase_matching_cfg=pm,
        )
    with pytest.raises(ValueError):
        psa.run_single_simulation(
            cfg, gamma=1.0, alpha=0.0, omega=np.full(4, 1.2e15),
            p_in=np.array([0.1, 0.1, 0, 0]), phase_matching_cfg=pm,
            length_unit="miles",
        )


def test_make_initial_amplitudes():
    p = np.array([0.25, 0.16, 0.0, 1e-6])
    ph = np.array([0.0, np.pi / 2, 0.0, 1.0])
    A0 = psa.make_initial_amplitudes(p, ph)
    np.testing.assert_allclose(np.abs(A0) ** 2, p, rtol=1e-15)
    assert np.angle(A0[1]) == pytest.approx(np.pi / 2)
    with pytest.raises(ValueError):
        psa.make_initial_amplitudes(np.array([0.1, -0.2, 0.0, 0.0]))


def test_beta_legacy_km_units_not_double_scaled():
    """beta_legacy in 1/km with length_unit='km' must produce the SAME physics
    as the equivalent per-meter inputs.  (The reference double-scales the
    derived PROVIDED dbeta here -- an uncatalogued defect, simulation.py:305-312
    combined with :295 -- not replicated.)"""
    omega0 = 2 * np.pi * psa.constants.c / 1.55e-6
    omega = np.full(4, omega0)
    p_in = np.array([0.2, 0.2, 1e-5, 0.0])
    betas_km = np.array([5.0, 5.0, 5.0, 15.0])  # dbeta = 10 / km
    cfg_km = psa.custom_simulation_config(z_max=0.5, dz=5e-4)
    z_km, A_km = psa.run_single_simulation(
        cfg_km, gamma=10.0, alpha=0.0, omega=omega, p_in=p_in,
        beta_legacy=betas_km, length_unit="km", return_length_unit="m",
    )
    cfg_m = psa.custom_simulation_config(z_max=500.0, dz=0.5)
    z_m, A_m = psa.run_single_simulation(
        cfg_m, gamma=0.01, alpha=0.0, omega=omega, p_in=p_in,
        beta_legacy=betas_km / 1000.0, length_unit="m",
    )
    np.testing.assert_allclose(z_km, z_m, rtol=1e-12)
    np.testing.assert_allclose(A_km, A_m, rtol=1e-9)


def test_verbose_flag_is_live(capsys):
    """cfg.verbose prints a run summary (the reference declares but never
    reads its verbose flag, SURVEY.md 8.8)."""
    cfg = psa.custom_simulation_config(z_max=1.0, dz=0.01, verbose=True)
    pm = psa.PhaseMatchingConfig(
        method=psa.PhaseMatchingMethod.PROVIDED, provided_delta_beta=0.3
    )
    psa.run_single_simulation(
        cfg, gamma=1.0, alpha=0.0, omega=np.full(4, 1.2e15),
        p_in=[0.1, 0.1, 0, 0], phase_matching_cfg=pm, length_unit="m",
    )
    out = capsys.readouterr().out
    assert "run_single_simulation" in out and "dbeta = 0.3" in out
