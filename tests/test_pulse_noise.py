"""Pulse-family (GNLSE) quantum noise: fiber Kerr / soliton squeezing by
truncated-Wigner Monte Carlo (``psa.pulse_squeezing_monte_carlo``).

Oracles:

- LINEAR propagation (gamma = 0, dispersion on) is a unitary transform of
  the iid vacuum Gaussians, so the measured ellipse stays the vacuum
  circle (v = 1/4) to MC error;
- dispersion-free KERR has the exact linearized ellipse
  V_min/max = (1/4) (1 + 2 mu^2 -+ 2 mu sqrt(1 + mu^2)), mu = gamma P z
  (CW Kerr squeezing, Agrawal ch. 12) -- every time bin squeezes
  identically and independently, so the flat-mode measurement reproduces
  it to MC error;
- the FUNDAMENTAL SOLITON squeezes below vacuum with the self-adapted
  (mean-field) local oscillator (Carter & Drummond PRL 58, 1841) while
  respecting the uncertainty bound v_min v_max >= 1/16.

Calibration run 2026-08-18 (B=4096): linear (0.2400, 0.2595) vs 0.25;
Kerr v_min 0.0421 vs 0.0429 theory; soliton -6.2 dB at one soliton
period, -12.3 dB at three.
"""

import numpy as np

import psa
from psa_simulation_ode_rk_mvp_dispersion.models import gnlse as gn
from psa_simulation_ode_rk_mvp_dispersion.parallel import mesh as pm

OM0 = 1.2e15
T0 = 1e-12
BETA2 = -2.0e-26
GAMMA = 2e-3


def _grid(n=128):
    return gn.TimeGrid.for_pulse(T0, n_samples=n)


def test_linear_propagation_preserves_vacuum():
    grid = _grid()
    disp = psa.DispersionParams.from_betas(OM0, beta2=BETA2)
    co = gn.make_gnlse_coeffs(grid, disp, gamma_W_m=0.0)
    A0 = np.asarray(psa.sech_pulse(grid, peak_W=1.0, t0_s=T0))
    cfg = psa.custom_simulation_config(z_max=10.0, dz=0.5, save_every=10)
    B = 4096
    r = psa.pulse_squeezing_monte_carlo(cfg, co, A0, grid, omega0=OM0,
                                        n_samples=B, seed=1)
    assert r.ok_fraction == 1.0
    se = 0.25 * np.sqrt(2.0 / B)
    # the trace is an unbiased vacuum estimator; the eigenvalue split is
    # pure sampling noise (biased outward by ~2 SE)
    assert abs(0.5 * (r.stats.v_min + r.stats.v_max) - 0.25) < 4 * se
    assert r.stats.v_max - r.stats.v_min < 8 * se
    assert r.mean_photons > 1e6      # classical pulse, Wigner regime


def test_dispersion_free_kerr_matches_linearized_ellipse():
    grid = _grid()
    co = gn.make_gnlse_coeffs(grid, None, gamma_W_m=GAMMA)
    P, z = 1.0, 500.0
    A0 = np.full(grid.n_samples, np.sqrt(P), dtype=complex)
    # dispersion-free SSFM: the Kerr rotation is exact at any step count
    cfg = psa.custom_simulation_config(z_max=z, dz=z / 4, save_every=1)
    r = psa.pulse_squeezing_monte_carlo(cfg, co, A0, grid, omega0=OM0,
                                        n_samples=4096, seed=2)
    mu = GAMMA * P * z
    root = np.sqrt(1.0 + mu * mu)
    v_min_t = 0.25 * (1.0 + 2 * mu * mu - 2 * mu * root)
    v_max_t = 0.25 * (1.0 + 2 * mu * mu + 2 * mu * root)
    assert abs(r.stats.v_min - v_min_t) < 0.10 * v_min_t
    assert abs(r.stats.v_max - v_max_t) < 0.10 * v_max_t
    # minimum-uncertainty squeezed state: v_min v_max = 1/16 exactly in
    # the linearized limit
    np.testing.assert_allclose(r.stats.uncertainty_product, 1.0 / 16.0,
                               rtol=0.1)


def test_soliton_squeezing_below_vacuum():
    grid = _grid()
    disp = psa.DispersionParams.from_betas(OM0, beta2=BETA2)
    co = gn.make_gnlse_coeffs(grid, disp, gamma_W_m=GAMMA)
    P0 = psa.soliton_peak_power(BETA2, GAMMA, T0)
    A0 = np.asarray(psa.sech_pulse(grid, peak_W=P0, t0_s=T0))
    z0 = 0.5 * np.pi * T0**2 / abs(BETA2)       # soliton period
    cfg = psa.custom_simulation_config(z_max=z0, dz=z0 / 200, save_every=200)
    r = psa.pulse_squeezing_monte_carlo(cfg, co, A0, grid, omega0=OM0,
                                        n_samples=2048, seed=3)
    # calibrated -6.2 dB at B=4096; generous MC margin
    assert r.stats.squeezing_db < -4.0
    assert r.stats.uncertainty_product >= (1.0 / 16.0) * (1.0 - 1e-9)
    # vacuum LO sanity: measuring with the input mode still squeezes
    r_in = psa.pulse_squeezing_monte_carlo(cfg, co, A0, grid, omega0=OM0,
                                           n_samples=2048, seed=3,
                                           lo_mode="mean-input")
    assert r_in.stats.squeezing_db < -2.0


def test_sharded_matches_unsharded_and_validation():
    import jax
    import pytest

    mesh = pm.default_mesh()
    grid = _grid(64)
    disp = psa.DispersionParams.from_betas(OM0, beta2=BETA2)
    co = gn.make_gnlse_coeffs(grid, disp, gamma_W_m=GAMMA)
    A0 = np.asarray(psa.sech_pulse(grid, peak_W=1.0, t0_s=T0))
    cfg = psa.custom_simulation_config(z_max=1.0, dz=0.1, save_every=10)
    B = 16 * len(jax.devices()) - 1   # exercise the pad path (B+1 lanes)
    r = psa.pulse_squeezing_monte_carlo(cfg, co, A0, grid, omega0=OM0,
                                        n_samples=B, seed=5)
    r_s = psa.pulse_squeezing_monte_carlo(cfg, co, A0, grid, omega0=OM0,
                                          n_samples=B, seed=5, mesh=mesh)
    np.testing.assert_allclose(r_s.stats.v_min, r.stats.v_min, rtol=1e-8)
    np.testing.assert_allclose(r_s.stats.v_max, r.stats.v_max, rtol=1e-8)
    with pytest.raises(ValueError, match="n_samples"):
        psa.pulse_squeezing_monte_carlo(cfg, co, A0, grid, omega0=OM0,
                                        n_samples=4)
    with pytest.raises(ValueError, match="lo_mode"):
        psa.pulse_squeezing_monte_carlo(cfg, co, A0, grid, omega0=OM0,
                                        n_samples=64, lo_mode="bogus")


def test_squeezing_evolution_matches_single_shot_and_starts_at_vacuum():
    grid = _grid()
    disp = psa.DispersionParams.from_betas(OM0, beta2=BETA2)
    co = gn.make_gnlse_coeffs(grid, disp, gamma_W_m=GAMMA)
    P0 = psa.soliton_peak_power(BETA2, GAMMA, T0)
    A0 = np.asarray(psa.sech_pulse(grid, peak_W=P0, t0_s=T0))
    zs = 0.5 * np.pi * T0**2 / abs(BETA2)
    cfg = psa.custom_simulation_config(z_max=3 * zs, dz=zs / 200,
                                       save_every=100)
    ev = psa.pulse_squeezing_evolution(cfg, co, A0, grid, omega0=OM0,
                                       n_samples=1024, seed=3)
    # same seed => identical injected noise => the last saved point is the
    # single-shot measurement exactly
    r = psa.pulse_squeezing_monte_carlo(cfg, co, A0, grid, omega0=OM0,
                                        n_samples=1024, seed=3)
    np.testing.assert_allclose(ev.squeezing_db[-1], r.stats.squeezing_db,
                               rtol=0, atol=0)
    # row 0 is the un-propagated input: the vacuum circle to MC error
    se = 0.25 * np.sqrt(2.0 / 1024)
    assert abs(0.5 * (ev.v_min[0] + ev.v_max[0]) - 0.25) < 4 * se
    # squeezing deepens with distance (Carter-Drummond), uncertainty bound
    # respected everywhere
    assert ev.squeezing_db[-1] < ev.squeezing_db[2] < ev.squeezing_db[1]
    assert ev.best_index == ev.z_m.shape[0] - 1
    assert np.all(ev.uncertainty_product >= (1.0 / 16.0) * (1.0 - 1e-9))
    assert ev.z_m[0] == 0.0 and ev.z_m[-1] > 0.0


def test_langevin_loss_preserves_vacuum():
    """Distributed-loss beamsplitter model: a LINEAR lossy channel must
    return the vacuum ellipse exactly (deterministic loss decays to eta/4,
    which is unphysical for a coherent state)."""
    import pytest

    grid = _grid()
    eta = 0.25
    co = gn.make_gnlse_coeffs(grid, None, gamma_W_m=0.0,
                              alpha_1_m=-np.log(eta) / 100.0)
    A0 = np.full(grid.n_samples, 1.0 + 0j)
    cfg = psa.custom_simulation_config(z_max=100.0, dz=1.0, save_every=20)
    B = 4096
    rd = psa.pulse_squeezing_monte_carlo(cfg, co, A0, grid, omega0=OM0,
                                         n_samples=B, seed=1)
    rl = psa.pulse_squeezing_monte_carlo(cfg, co, A0, grid, omega0=OM0,
                                         n_samples=B, seed=1,
                                         loss_model="langevin",
                                         n_loss_segments=10)
    se = 0.25 * np.sqrt(2.0 / B)
    v_det = 0.5 * (rd.stats.v_min + rd.stats.v_max)
    v_lan = 0.5 * (rl.stats.v_min + rl.stats.v_max)
    assert abs(v_det - eta * 0.25) < 4 * se          # decayed (unphysical)
    assert abs(v_lan - 0.25) < 4 * se                # vacuum restored
    # mean field is identical (injection has zero mean; lane 0 noise-free)
    np.testing.assert_allclose(rl.mean_photons, rd.mean_photons, rtol=1e-12)

    # spectral alpha at the same flat value: same physics
    co_sp = gn.make_gnlse_coeffs(
        grid, None, gamma_W_m=0.0,
        alpha_spec_1_m=np.full(grid.n_samples, -np.log(eta) / 100.0))
    rs = psa.pulse_squeezing_monte_carlo(cfg, co_sp, A0, grid, omega0=OM0,
                                         n_samples=B, seed=1,
                                         loss_model="langevin",
                                         n_loss_segments=10)
    v_sp = 0.5 * (rs.stats.v_min + rs.stats.v_max)
    assert abs(v_sp - 0.25) < 4 * se

    with pytest.raises(ValueError, match="loss_model"):
        psa.pulse_squeezing_monte_carlo(cfg, co, A0, grid, omega0=OM0,
                                        n_samples=64, loss_model="bogus")
    with pytest.raises(ValueError, match="n_loss_segments"):
        psa.pulse_squeezing_monte_carlo(cfg, co, A0, grid, omega0=OM0,
                                        n_samples=64,
                                        loss_model="langevin",
                                        n_loss_segments=7)


def test_langevin_evolution_endpoint_matches_mc():
    grid = _grid(64)
    co = gn.make_gnlse_coeffs(grid, None, gamma_W_m=GAMMA,
                              alpha_1_m=5e-3)
    A0 = np.full(grid.n_samples, 1.0 + 0j)
    # 100 steps / save_every 20 -> 5 injection segments
    cfg = psa.custom_simulation_config(z_max=100.0, dz=1.0, save_every=20)
    ev = psa.pulse_squeezing_evolution(cfg, co, A0, grid, omega0=OM0,
                                       n_samples=512, seed=2,
                                       loss_model="langevin")
    r = psa.pulse_squeezing_monte_carlo(cfg, co, A0, grid, omega0=OM0,
                                        n_samples=512, seed=2,
                                        loss_model="langevin",
                                        n_loss_segments=5)
    assert ev.squeezing_db[-1] == r.stats.squeezing_db
    assert ev.z_m.shape == (6,)


def test_vector_squeezing_manakov_u2_oracle():
    """Equal-split CW under dispersion-free Manakov coupling: by U(2)
    invariance the +45deg mode IS a scalar Kerr field with mu =
    gamma_eff P z (linearized ellipse, exact), and the orthogonal -45deg
    mode -- pure XPM acting on vacuum -- stays the exact vacuum circle."""
    import pytest

    grid = _grid(64)
    G, P, z = 2e-3, 1.0, 500.0
    co = psa.make_vgnlse_coeffs(grid, None, gamma_W_m=G, coupling="manakov")
    A0 = np.stack([np.full(64, np.sqrt(P / 2)),
                   np.full(64, np.sqrt(P / 2))]).astype(complex)
    cfg = psa.custom_simulation_config(z_max=z, dz=z / 8, save_every=1)
    ones = np.ones(64, complex)
    B = 4096
    rp = psa.vector_pulse_squeezing_monte_carlo(
        cfg, co, A0, grid, omega0=OM0, n_samples=B, seed=2,
        lo_mode=np.stack([ones, ones]))
    rm = psa.vector_pulse_squeezing_monte_carlo(
        cfg, co, A0, grid, omega0=OM0, n_samples=B, seed=2,
        lo_mode=np.stack([ones, -ones]))
    mu = (8.0 / 9.0) * G * P * z
    root = np.sqrt(1.0 + mu * mu)
    assert rp.stats.v_min == pytest.approx(
        0.25 * (1 + 2 * mu * mu - 2 * mu * root), rel=0.10)
    assert rp.stats.v_max == pytest.approx(
        0.25 * (1 + 2 * mu * mu + 2 * mu * root), rel=0.10)
    se = 0.25 * np.sqrt(2.0 / B)
    assert abs(0.5 * (rm.stats.v_min + rm.stats.v_max) - 0.25) < 4 * se
    assert rm.mean_photons < 1e-12          # orthogonal mode is dark
    # self-adapted LO: the mean output stays +45-polarized, same ellipse
    ro = psa.vector_pulse_squeezing_monte_carlo(
        cfg, co, A0, grid, omega0=OM0, n_samples=B, seed=2)
    np.testing.assert_allclose(ro.stats.v_min, rp.stats.v_min, rtol=1e-10)
    # langevin distributed loss preserves the vacuum on a linear channel
    col = psa.make_vgnlse_coeffs(grid, None, gamma_W_m=0.0,
                                 alpha_1_m=np.log(4.0) / z,
                                 coupling="manakov")
    rl = psa.vector_pulse_squeezing_monte_carlo(
        cfg, col, A0, grid, omega0=OM0, n_samples=B, seed=2,
        loss_model="langevin", n_loss_segments=8, lo_mode="mean-input")
    assert abs(0.5 * (rl.stats.v_min + rl.stats.v_max) - 0.25) < 4 * se
    with pytest.raises(ValueError, match=r"\(2, T\)"):
        psa.vector_pulse_squeezing_monte_carlo(
            cfg, co, A0[0], grid, omega0=OM0, n_samples=64)


def test_photon_statistics_shot_noise_oracle():
    """Wigner-corrected photon statistics: a coherent pulse (linear
    propagation) reads Fano = 1 in every occupied spectral bin and in
    total; a lossless soliton solve conserves each lane's total photon
    number, so total Fano stays at the input's shot noise."""
    import pytest

    grid = _grid()
    disp = psa.DispersionParams.from_betas(OM0, beta2=BETA2)
    P0 = psa.soliton_peak_power(BETA2, GAMMA, T0)
    A0 = np.asarray(psa.sech_pulse(grid, peak_W=P0, t0_s=T0))
    zs = 0.5 * np.pi * T0**2 / abs(BETA2)
    B = 2048
    se = np.sqrt(2.0 / B)

    co_lin = gn.make_gnlse_coeffs(grid, disp, gamma_W_m=0.0)
    cfg = psa.custom_simulation_config(z_max=zs, dz=zs / 100, save_every=100)
    r = psa.pulse_photon_statistics(cfg, co_lin, A0, grid, omega0=OM0,
                                    n_samples=B, seed=0)
    assert abs(r.total_fano - 1.0) < 4 * se
    occ = r.n_mean > 1000
    assert occ.sum() > 20
    assert np.nanmax(np.abs(r.fano[occ] - 1.0)) < 8 * se
    assert r.total_photons == pytest.approx(
        float(np.sum(np.abs(A0) ** 2)) * grid.dt_s / (1.0546e-34 * OM0),
        rel=1e-2)

    co = gn.make_gnlse_coeffs(grid, disp, gamma_W_m=GAMMA)
    cfg3 = psa.custom_simulation_config(z_max=3 * zs, dz=zs / 200,
                                        save_every=200)
    r2 = psa.pulse_photon_statistics(cfg3, co, A0, grid, omega0=OM0,
                                     n_samples=B, seed=1)
    assert abs(r2.total_fano - 1.0) < 4 * se
    # the soliton redistributes noise across bins (excess somewhere)
    assert np.nanmax(r2.fano) > 2.0


def test_photon_statistics_filtered_squeezing():
    """Spectrally-filtered direct detection (Spaelter-style): the
    out-of-sample optimal linear filter measures a bright photon
    observable far below shot noise at one soliton period."""
    import pytest

    grid = _grid()
    disp = psa.DispersionParams.from_betas(OM0, beta2=BETA2)
    co = gn.make_gnlse_coeffs(grid, disp, gamma_W_m=GAMMA)
    P0 = psa.soliton_peak_power(BETA2, GAMMA, T0)
    A0 = np.asarray(psa.sech_pulse(grid, peak_W=P0, t0_s=T0))
    zs = 0.5 * np.pi * T0**2 / abs(BETA2)
    cfg = psa.custom_simulation_config(z_max=zs, dz=zs / 200, save_every=200)
    r = psa.pulse_photon_statistics(cfg, co, A0, grid, omega0=OM0,
                                    n_samples=4096, seed=1,
                                    optimal_filter=True)
    # calibrated 0.124 at B=4096 (out-of-sample halves); generous margin
    assert 0.0 < r.filtered_fano < 0.5
    assert r.filtered_photons > 1e6
    assert r.filter_w is not None and r.filter_w.min() >= 0.0
    assert r.filter_w.max() == pytest.approx(1.0)

    with pytest.raises(ValueError, match="not both"):
        psa.pulse_photon_statistics(cfg, co, A0, grid, omega0=OM0,
                                    n_samples=64, optimal_filter=True,
                                    filter_mask=np.ones(grid.n_samples))
    with pytest.raises(ValueError, match=">="):
        psa.pulse_photon_statistics(cfg, co, A0, grid, omega0=OM0,
                                    n_samples=64, optimal_filter=True)
    with pytest.raises(ValueError, match="filter_mask"):
        psa.pulse_photon_statistics(cfg, co, A0, grid, omega0=OM0,
                                    n_samples=64,
                                    filter_mask=-np.ones(grid.n_samples))


def test_vector_photon_statistics():
    """Vector direct detection: Manakov coupling conserves total photons
    per lane (total Fano at input shot noise); each polarization's
    occupied bins read coherent-state Fano = 1 under linear propagation;
    filter shapes validate."""
    import pytest

    grid = _grid(64)
    B = 2048
    se = np.sqrt(2.0 / B)
    # linear birefringent propagation: coherent in every occupied bin
    co_lin = psa.make_vgnlse_coeffs(grid, None, gamma_W_m=0.0,
                                    dbeta0_1_m=0.5, coupling="manakov")
    A0 = np.stack([np.full(64, 2.0 + 0j), np.full(64, 1.0 + 0j)])
    cfg = psa.custom_simulation_config(z_max=100.0, dz=1.0, save_every=20)
    r = psa.vector_pulse_photon_statistics(cfg, co_lin, A0, grid,
                                           omega0=OM0, n_samples=B, seed=0)
    assert abs(r.total_fano - 1.0) < 4 * se
    occ = r.n_mean > 1000
    assert occ.sum() == 2          # two CW carriers (one per polarization)
    assert np.nanmax(np.abs(r.fano[occ] - 1.0)) < 8 * se
    assert r.n_mean.shape == (2 * 64,)

    # nonlinear Manakov conserves total photons -> shot-noise total Fano
    co = psa.make_vgnlse_coeffs(grid, None, gamma_W_m=GAMMA,
                                coupling="manakov")
    r2 = psa.vector_pulse_photon_statistics(
        cfg, co, A0, grid, omega0=OM0, n_samples=B, seed=1,
        filter_mask=np.ones(64))
    assert abs(r2.total_fano - 1.0) < 4 * se
    np.testing.assert_allclose(r2.filtered_fano, r2.total_fano, rtol=1e-9)
    with pytest.raises(ValueError, match="filter_mask"):
        psa.vector_pulse_photon_statistics(cfg, co, A0, grid, omega0=OM0,
                                           n_samples=64,
                                           filter_mask=np.ones(7))


def test_comb_photon_statistics_pia_oracle():
    """Comb-family quantum noise: a linear comb reads Fano = 1 on every
    seeded line, and the undepleted two-pump PIA configuration (pumps at
    the outer lines, 0+3 == 1+2) reproduces the 4-wave 2 - 1/G law --
    the cross-family consistency oracle."""
    import pytest

    from psa_simulation_ode_rk_mvp_dispersion.models import nwave as nw

    grid = nw.CombGrid.centered(2 * np.pi * 193.1e12, 2 * np.pi * 100e9, 4)
    cfg = psa.custom_simulation_config(z_max=200.0, dz=0.05, save_every=100)
    A0 = nw.seed_comb(grid, pump_lines={0: 0.5, 3: 0.5, 1: 1e-6})

    co0 = nw.NWaveCoeffs(gamma=0.0, alpha=0.0, beta_lin=np.zeros(4))
    B = 4096
    r0 = psa.comb_photon_statistics(cfg, co0, grid, A0, n_samples=B, seed=0)
    seeded = r0.n_mean > 1000
    assert seeded.sum() == 3
    assert np.nanmax(np.abs(r0.fano[seeded] - 1.0)) < 8 * np.sqrt(2.0 / B)
    assert r0.nf_db is None

    co = nw.NWaveCoeffs(gamma=5e-3, alpha=0.0, beta_lin=np.zeros(4))
    r = psa.comb_photon_statistics(cfg, co, grid, A0, n_samples=8192,
                                   seed=1,
                                   noisy_lines=[False, True, True, False],
                                   measure_lines=[1])
    G = 10.0 ** (r.gain_db / 10.0)
    assert G > 1.5
    nf_theory = 10.0 * np.log10(2.0 - 1.0 / G)
    assert abs(r.nf_db - nf_theory) < 4 * r.nf_se_db
    # PIA joint detection: the twin-beam correlation squeezes the photon
    # DIFFERENCE, so the measured SUM is super-poissonian (NF above the
    # single-line 2 - 1/G)
    rj = psa.comb_photon_statistics(cfg, co, grid, A0, n_samples=8192,
                                    seed=1,
                                    noisy_lines=[False, True, True, False],
                                    measure_lines=[1, 2])
    assert rj.nf_db > r.nf_db + 4 * rj.nf_se_db
    # PSA: seed signal AND idler at the max-gain phase (67.5 deg for this
    # config, from a mean-field scan) -> joint detection at the 0 dB
    # quantum limit (measured 0.001 +- 0.001 at 16k samples)
    A0_psa = (nw.seed_comb(grid, pump_lines={0: 0.5, 3: 0.5})
              + np.array([0.0, np.sqrt(5e-7) * np.exp(1j * np.deg2rad(67.5)),
                          np.sqrt(5e-7), 0.0]))
    rp = psa.comb_photon_statistics(cfg, co, grid, A0_psa, n_samples=8192,
                                    seed=2,
                                    noisy_lines=[False, True, True, False],
                                    measure_lines=[1, 2])
    assert 10.0 ** (rp.gain_db / 10.0) > 2.0
    assert abs(rp.nf_db) < max(4 * rp.nf_se_db, 0.05)

    with pytest.raises(ValueError, match="measure_lines"):
        psa.comb_photon_statistics(cfg, co, grid, A0, n_samples=64,
                                   noisy_lines=[False, True, True, False],
                                   measure_lines=[0])
    with pytest.raises(ValueError, match="lines"):
        psa.comb_photon_statistics(cfg, co, grid, A0[:3], n_samples=64)


def test_squeezing_spectrum_oracles():
    """Sideband squeezing spectrum: vacuum at every Omega under linear
    propagation; dispersion-free CW Kerr shows the single-mode linearized
    ellipse in EVERY sideband pair; CW modulation instability (anomalous
    beta2) antisqueezes maximally at Omega_c/sqrt(2) and squeezes below
    vacuum across the MI band at the minimum-uncertainty product."""
    grid = _grid()
    P = 1.0
    A0 = np.full(grid.n_samples, np.sqrt(P), dtype=complex)
    B = 4096
    se = 0.25 * np.sqrt(2.0 / B)

    co0 = gn.make_gnlse_coeffs(
        grid, psa.DispersionParams.from_betas(OM0, beta2=BETA2),
        gamma_W_m=0.0)
    cfg0 = psa.custom_simulation_config(z_max=100.0, dz=1.0, save_every=100)
    r0 = psa.pulse_squeezing_spectrum(cfg0, co0, A0, grid, omega0=OM0,
                                      n_samples=B, seed=0)
    assert np.max(np.abs(r0.v_min - 0.25)) < 5 * se
    assert np.max(np.abs(r0.v_max - 0.25)) < 5 * se

    co1 = gn.make_gnlse_coeffs(grid, None, gamma_W_m=GAMMA)
    z = 500.0
    cfg1 = psa.custom_simulation_config(z_max=z, dz=z / 4, save_every=1)
    r1 = psa.pulse_squeezing_spectrum(cfg1, co1, A0, grid, omega0=OM0,
                                      n_samples=B, seed=1)
    mu = GAMMA * P * z
    root = np.sqrt(1.0 + mu * mu)
    vt_min = 0.25 * (1 + 2 * mu * mu - 2 * mu * root)
    vt_max = 0.25 * (1 + 2 * mu * mu + 2 * mu * root)
    assert np.max(np.abs(r1.v_min - vt_min)) < 0.15 * vt_min
    assert np.max(np.abs(r1.v_max - vt_max)) < 0.15 * vt_max

    co2 = gn.make_gnlse_coeffs(
        grid, psa.DispersionParams.from_betas(OM0, beta2=BETA2),
        gamma_W_m=GAMMA)
    z2 = 3.0 / (GAMMA * P)
    cfg2 = psa.custom_simulation_config(z_max=z2, dz=z2 / 400,
                                        save_every=400)
    r2 = psa.pulse_squeezing_spectrum(cfg2, co2, A0, grid, omega0=OM0,
                                      n_samples=B, seed=2)
    om = grid.omega()
    Oc = np.sqrt(4.0 * GAMMA * P / abs(BETA2))
    k = int(np.nanargmax(r2.antisqueezing_db))
    # peak within one grid bin of the MI gain maximum Omega_c/sqrt(2)
    assert abs(abs(om[k]) - Oc / np.sqrt(2.0)) <= 1.5 * abs(om[1])
    assert r2.antisqueezing_db[k] > 15.0
    assert r2.squeezing_db[k] < -15.0
    inband = (np.abs(om) > 0) & (np.abs(om) < Oc)
    assert (r2.v_min[inband] < 0.25).all()
    np.testing.assert_allclose(r2.uncertainty_product[inband], 1.0 / 16.0,
                               rtol=0.1)
    assert r2.best_index == int(np.nanargmin(r2.squeezing_db))
    assert "SqueezingSpectrumResult" in repr(r2)


def test_spectral_coherence_g12():
    """First-order coherence |g12|: a bright coherent pulse reads ~1 on
    every occupied bin (n/(n + 1/2) under Wigner); the vacuum-amplified
    modulation-instability band reads ~0 while the pump line stays
    coherent -- the Dudley-Coen supercontinuum-stability diagnostic."""
    grid = _grid()
    P = 1.0
    om = grid.omega()
    disp = psa.DispersionParams.from_betas(OM0, beta2=BETA2)

    co0 = gn.make_gnlse_coeffs(grid, disp, gamma_W_m=0.0)
    A0p = np.asarray(psa.sech_pulse(grid, peak_W=1.0, t0_s=T0))
    cfg0 = psa.custom_simulation_config(z_max=100.0, dz=1.0, save_every=100)
    r0 = psa.pulse_coherence_monte_carlo(cfg0, co0, A0p, grid, omega0=OM0,
                                         n_samples=256, seed=0)
    occ = r0.mean_photons > 1e4
    assert occ.sum() > 20
    assert r0.g12[occ].min() > 0.99
    assert r0.g12_avg > 0.99
    assert np.all((r0.g12 >= 0.0) & (r0.g12 <= 1.0))

    co = gn.make_gnlse_coeffs(grid, disp, gamma_W_m=GAMMA)
    A0 = np.full(grid.n_samples, np.sqrt(P), dtype=complex)
    z = 8.0 / (GAMMA * P)
    cfg = psa.custom_simulation_config(z_max=z, dz=z / 800, save_every=800)
    r = psa.pulse_coherence_monte_carlo(cfg, co, A0, grid, omega0=OM0,
                                        n_samples=256, seed=1)
    Oc = np.sqrt(4.0 * GAMMA * P / abs(BETA2))
    band = (np.abs(om) > 0.3 * Oc) & (np.abs(om) < 0.9 * Oc)
    assert r.g12[0] > 0.99                     # pump line coherent
    assert r.mean_photons[band].min() > 1e4    # band IS amplified...
    assert r.g12[band].max() < 0.05            # ...and incoherent


def test_vector_squeezing_evolution():
    """Vector evolution: endpoint bit-matches the vector single-shot MC at
    the same seed; the +45-degree Manakov CW mode deepens its squeezing
    monotonically along z (rotated-basis scalar Kerr)."""
    grid = _grid(64)
    G, P, z = 2e-3, 1.0, 500.0
    co = psa.make_vgnlse_coeffs(grid, None, gamma_W_m=G, coupling="manakov")
    A0 = np.stack([np.full(64, np.sqrt(P / 2)),
                   np.full(64, np.sqrt(P / 2))]).astype(complex)
    cfg = psa.custom_simulation_config(z_max=z, dz=z / 8, save_every=2)
    ev = psa.vector_pulse_squeezing_evolution(cfg, co, A0, grid,
                                              omega0=OM0, n_samples=512,
                                              seed=7)
    r = psa.vector_pulse_squeezing_monte_carlo(cfg, co, A0, grid,
                                               omega0=OM0, n_samples=512,
                                               seed=7)
    np.testing.assert_allclose(ev.squeezing_db[-1], r.stats.squeezing_db,
                               rtol=0, atol=0)
    assert ev.z_m.shape == (5,)
    se = 0.25 * np.sqrt(2.0 / 512)
    assert abs(0.5 * (ev.v_min[0] + ev.v_max[0]) - 0.25) < 5 * se
    assert np.all(np.diff(ev.squeezing_db[1:]) < 0)   # deepens with z


def test_vector_spectral_coherence():
    """Vector |g12|: both polarization carriers coherent under linear
    birefringent propagation; a Manakov-MI-amplified band on the strong
    polarization decoheres while its carrier stays coherent."""
    grid = _grid(64)
    om = grid.omega()
    disp = psa.DispersionParams.from_betas(OM0, beta2=BETA2)
    co_lin = psa.make_vgnlse_coeffs(grid, disp, gamma_W_m=0.0,
                                    dbeta0_1_m=0.3, coupling="manakov")
    A0 = np.stack([np.full(64, 2.0 + 0j), np.full(64, 1.0 + 0j)])
    cfg = psa.custom_simulation_config(z_max=100.0, dz=1.0, save_every=20)
    r = psa.vector_pulse_coherence_monte_carlo(cfg, co_lin, A0, grid,
                                               omega0=OM0, n_samples=128,
                                               seed=0)
    assert r.g12.shape == (2 * 64,)
    occ = r.mean_photons > 1e4
    assert occ.sum() == 2
    assert r.g12[occ].min() > 0.99

    co = psa.make_vgnlse_coeffs(grid, disp, gamma_W_m=GAMMA,
                                coupling="manakov")
    P = 4.0
    A0m = np.stack([np.full(64, np.sqrt(P)), np.zeros(64)]).astype(complex)
    z = 8.0 / ((8.0 / 9.0) * GAMMA * P)
    cfgm = psa.custom_simulation_config(z_max=z, dz=z / 800, save_every=800)
    rm = psa.vector_pulse_coherence_monte_carlo(cfgm, co, A0m, grid,
                                                omega0=OM0, n_samples=128,
                                                seed=1)
    gx = rm.g12[:64]
    nx = rm.mean_photons[:64]
    Oc = np.sqrt(4.0 * (8.0 / 9.0) * GAMMA * P / abs(BETA2))
    band = (np.abs(om) > 0.3 * Oc) & (np.abs(om) < 0.9 * Oc)
    assert gx[0] > 0.99                  # carrier coherent
    assert nx[band].min() > 1e3          # band amplified from vacuum...
    assert gx[band].max() < 0.1          # ...and incoherent


def test_moment_statistics_jitter_laws():
    """Collective-coordinate jitter: per-lane NLSE theorems make the
    ensemble laws exact -- photon number and spectral centroid conserved
    (lossless), and the timing variance follows
    Var_t(z) = Var_t(0) - 2 beta2 z Cov(t,f) + (beta2 z)^2 Var_f
    (this module's reversed-time convention) with NO linearization;
    langevin distributed loss adds frequency diffusion (the Gordon-Haus
    mechanism).  Calibration 2026-08-18 (B=512): conservation 1e-4,
    quadratic law 1.4e-3 rel, f_var growth +45% at alpha=2e-3."""
    grid = _grid(256)
    disp = psa.DispersionParams.from_betas(OM0, beta2=BETA2)
    co = gn.make_gnlse_coeffs(grid, disp, gamma_W_m=GAMMA)
    P0 = psa.soliton_peak_power(BETA2, GAMMA, T0)
    A0 = np.asarray(psa.sech_pulse(grid, peak_W=P0, t0_s=T0))
    zs = 0.5 * np.pi * T0**2 / abs(BETA2)
    cfg = psa.custom_simulation_config(z_max=3 * zs, dz=zs / 200,
                                       save_every=150)
    m = psa.pulse_moment_statistics(cfg, co, A0, grid, omega0=OM0,
                                    n_samples=512, seed=0)
    np.testing.assert_allclose(m.energy_var, m.energy_var[0], rtol=1e-4)
    np.testing.assert_allclose(m.energy_mean, m.energy_mean[0], rtol=1e-6)
    np.testing.assert_allclose(m.f_var, m.f_var[0], rtol=1e-3)
    z = m.z_m
    pred = (m.t_var[0] - 2 * BETA2 * z * m.tf_cov[0]
            + (BETA2 * z) ** 2 * m.f_var[0])
    np.testing.assert_allclose(m.t_var, pred, rtol=5e-3)
    assert m.t_var[-1] > 3.0 * m.t_var[0]          # jitter really grows

    col = gn.make_gnlse_coeffs(grid, disp, gamma_W_m=GAMMA, alpha_1_m=2e-3)
    ml = psa.pulse_moment_statistics(cfg, col, A0, grid, omega0=OM0,
                                     n_samples=512, seed=0,
                                     loss_model="langevin")
    # frequency DIFFUSES under distributed-loss vacuum injection
    assert ml.f_var[-1] > 1.2 * ml.f_var[0]
    assert np.all(np.diff(ml.f_var) > 0)


def test_comb_pair_squeezing_cross_family():
    """Two-mode squeezing through the N-WAVE engine equals the 4-wave
    module's measurement on the same physics (vacuum through a two-pump
    parametric comb): joint +45-degree mode squeezed at the minimum-
    uncertainty product, single line thermal (calibrated -6.34 vs
    -6.43 dB at 8k samples)."""
    import pytest

    from psa_simulation_ode_rk_mvp_dispersion.models import nwave as nw

    grid = nw.CombGrid.centered(2 * np.pi * 193.1e12, 2 * np.pi * 100e9, 4)
    cfg = psa.custom_simulation_config(z_max=150.0, dz=0.05, save_every=50)
    co = nw.NWaveCoeffs(gamma=5e-3, alpha=0.0, beta_lin=np.zeros(4))
    A0 = nw.seed_comb(grid, pump_lines={0: 0.5, 3: 0.5})
    B = 8192
    sig, joint = psa.comb_pair_squeezing_monte_carlo(
        cfg, co, grid, A0, pair=(1, 2), n_samples=B, seed=0,
        noisy_lines=[False, True, True, False])
    assert joint.squeezing_db < -4.0
    np.testing.assert_allclose(joint.uncertainty_product, 1.0 / 16.0,
                               rtol=0.02)
    assert sig.squeezing_db > 1.0                   # thermal single line

    omega = np.asarray(grid.omegas())
    _, joint4 = psa.psa_squeezing_monte_carlo(
        cfg, gamma=5e-3, alpha=0.0, omega=omega[[0, 3, 1, 2]],
        p_pump_W=0.5, n_samples=B, seed=0)
    assert joint.squeezing_db == pytest.approx(joint4.squeezing_db,
                                               abs=0.4)
    with pytest.raises(ValueError, match="pair"):
        psa.comb_pair_squeezing_monte_carlo(cfg, co, grid, A0, pair=(1, 7),
                                            n_samples=64)
