"""Wigner quantum-noise Monte Carlo (parallel/noise.py).

Oracles are the textbook quantum limits of parametric amplification:
an ideal phase-insensitive amplifier (signal in, idler vacuum) has
NF = 2 - 1/G EXACTLY (3 dB at high gain), and an ideal phase-sensitive
amplifier (signal + idler seeded at the max-gain phase, joint detection)
reaches NF = 0 dB.  Monte-Carlo tolerance at n_samples=8192 is ~0.1 dB.
"""

import numpy as np
import pytest

import psa
from psa_simulation_ode_rk_mvp_dispersion.parallel import noise as nz
from psa_simulation_ode_rk_mvp_dispersion.parallel import mesh as pm

OMEGA = np.asarray(psa.plan_from_wavelengths(1550e-9, 1552e-9, 1551.0e-9))
GAMMA, P_PUMP = 5e-3, 0.5


def _cfg(z_max=100.0):
    return psa.custom_simulation_config(z_max=z_max, dz=0.05, save_every=50)


def _pia(n_samples=8192, seed=1, **kw):
    return nz.noise_figure_monte_carlo(
        _cfg(kw.pop("z_max", 100.0)), gamma=GAMMA, alpha=0.0, omega=OMEGA,
        p_in=[P_PUMP, P_PUMP, 1e-6, 0.0], delta_beta=0.0,
        n_samples=n_samples, noisy_waves=(False, False, True, True),
        measure="signal", seed=seed, **kw,
    )


def test_pia_noise_figure_matches_exact_theory():
    """Ideal PIA: NF = 2 - 1/G exactly, at whatever gain the solve gives.

    The tolerance is statistical, not fixed: the estimator carries a
    jackknife SE, and the truth must lie within 4 SE of it (plus a small
    systematic floor for the Wigner symmetric-ordering bias ~1/n)."""
    r = _pia(z_max=200.0)
    G = 10 ** (r.gain_db / 10.0)
    assert G > 1.5  # a real amplifier, not a pass-through
    nf_theory = 10.0 * np.log10(2.0 - 1.0 / G)
    assert 0.0 < r.nf_se_db < 0.2   # 8k samples: a few-percent-dB SE
    assert abs(r.nf_db - nf_theory) < 4.0 * r.nf_se_db + 0.02


def test_pia_high_gain_approaches_3db():
    r = _pia(z_max=400.0, seed=3)
    assert r.gain_db > 10.0
    assert 2.6 < r.nf_db < 3.3


def test_nf_se_shrinks_with_ensemble_size():
    """The jackknife SE must scale ~1/sqrt(B) (consistency check of the
    error bar itself)."""
    r_small = _pia(n_samples=512, seed=11)
    r_big = _pia(n_samples=8192, seed=11)
    assert np.isfinite(r_small.nf_se_db) and np.isfinite(r_big.nf_se_db)
    ratio = r_small.nf_se_db / r_big.nf_se_db
    assert 1.6 < ratio < 10.0   # sqrt(16) = 4 expected, wide MC margin


def test_psa_joint_measurement_quantum_limit():
    """Signal + idler seeded at the max-gain phase, joint detection: the
    phase-sensitive amplifier is noiseless (NF -> 0 dB)."""
    # max-gain total phase found by a mean-field phase scan (cheap):
    from psa_simulation_ode_rk_mvp_dispersion.models.fwm4 import (
        make_initial_amplitudes,
    )
    from psa_simulation_ode_rk_mvp_dispersion.ops.rhs import RHSCoeffs
    from psa_simulation_ode_rk_mvp_dispersion.parallel.sweep import solve_batch

    cfg = _cfg()
    phases = np.linspace(0.0, 2.0 * np.pi, 33)
    A0 = np.stack([
        np.asarray(make_initial_amplitudes([P_PUMP, P_PUMP, 5e-7, 5e-7],
                                           [0, 0, ph, 0]))
        for ph in phases
    ])
    co = RHSCoeffs(gamma=np.full(33, GAMMA), alpha=np.zeros(33),
                   delta_beta=np.zeros(33))
    res = solve_batch(cfg, co, A0)
    ph_max = phases[np.argmax(res.P_end[:, 2] + res.P_end[:, 3])]

    r = nz.noise_figure_monte_carlo(
        cfg, gamma=GAMMA, alpha=0.0, omega=OMEGA,
        p_in=[P_PUMP, P_PUMP, 5e-7, 5e-7], phase_in=[0, 0, ph_max, 0],
        delta_beta=0.0, n_samples=8192,
        noisy_waves=(False, False, True, True),
        measure="signal+idler", seed=2,
    )
    assert r.gain_db > 3.0
    # quantum limit (0 dB) within 4 jackknife SE + small systematic floor
    assert abs(r.nf_db) < 4.0 * r.nf_se_db + 0.05
    # and it genuinely beats the PIA limit
    assert r.nf_db < 1.0


def test_t_mode_invariance():
    """NF must not depend on the arbitrary mode duration (n >> 1)."""
    r1 = _pia(n_samples=4096, seed=5, t_mode_s=1e-9)
    r2 = _pia(n_samples=4096, seed=5, t_mode_s=8e-9)
    assert r1.nf_db == pytest.approx(r2.nf_db, abs=0.3)


def test_sharded_matches_unsharded():
    import jax

    assert len(jax.devices()) == 8
    r = _pia(n_samples=2047, seed=7)  # B=2048 total, pads over the mesh
    r_s = _pia(n_samples=2047, seed=7, mesh=pm.default_mesh())
    # identical host-side draws + deterministic solves -> same statistics
    assert r_s.nf_db == pytest.approx(r.nf_db, abs=1e-6)
    assert r_s.gain_db == pytest.approx(r.gain_db, abs=1e-9)


def test_psa_vacuum_squeezing_minimum_uncertainty():
    """Vacuum through a lossless dual-pump PSA is a pure two-mode squeezer:
    the +45-deg signal/idler superposition squeezes below the vacuum while
    v_min*v_max stays at the minimum-uncertainty 1/16, with symmetric
    squeezing/antisqueezing; a single arm alone is thermal (round, above
    vacuum)."""
    cfg = psa.custom_simulation_config(z_max=200.0, dz=0.05, save_every=50)
    sig, joint = nz.psa_squeezing_monte_carlo(
        cfg, gamma=GAMMA, alpha=0.0, omega=OMEGA, p_pump_W=P_PUMP,
        n_samples=16384, seed=4,
    )
    # joint mode: genuinely squeezed, pure (symmetric), minimum uncertainty
    assert joint.squeezing_db < -3.0
    assert abs(joint.squeezing_db + joint.antisqueezing_db) < 0.3
    assert joint.uncertainty_product == pytest.approx(1.0 / 16.0, rel=0.05)
    # single arm: thermal -- round and above vacuum, no squeezing
    assert sig.v_min > 0.25 and sig.v_max / sig.v_min < 1.1
    # vacuum input sanity through the analyzer itself
    rng = np.random.default_rng(0)
    # each quadrature gets the vacuum variance 1/4 (std 0.5) in photon units
    vac = (rng.standard_normal(50_000) + 1j * rng.standard_normal(50_000))
    vac *= 0.5 * np.sqrt(nz.hbar * OMEGA[2] / 1e-9)
    q = nz.quadrature_stats(vac, OMEGA[2], 1e-9)
    assert q.squeezing_db == pytest.approx(0.0, abs=0.1)
    assert q.uncertainty_product == pytest.approx(1.0 / 16.0, rel=0.03)


def test_nf_spectrum_tracks_gain_dependent_theory():
    """NF(lambda) across a dispersion-shaped gain band: every point must sit
    on the exact PIA law 2 - 1/G(lambda) — ~3 dB in the high-gain region,
    falling to ~0 dB where the amplifier goes transparent."""
    disp = psa.dispersion_params_from_D_S(
        lambda_ref_m=1552.5e-9, D=0.2, S=0.02, dSdlmbd=0,
        D_units="ps/nm/km", S_units="ps/nm^2/km", dSdlmbd_units="ps/nm^3/km")
    cfg = psa.custom_simulation_config(z_max=500.0, dz=0.2, save_every=10)
    lam3 = np.array([1545e-9, 1570e-9, 1600e-9, 1635e-9])
    r = nz.noise_figure_spectrum(
        cfg, lambda_p1_m=1550e-9, lambda_p2_m=1555e-9, lambda_signal_m=lam3,
        gamma=0.0115, alpha=0.0, p_in=[0.5, 0.5, 1e-7, 0.0], dispersion=disp,
        length_unit="m", n_samples=2048, measure="signal", seed=3,
    )
    assert r.ok.all()
    G = 10 ** (r.gain_db / 10.0)
    assert G[0] > 100 and G[-1] < 1.2  # band actually spans gain->transparent
    nf_theory = 10 * np.log10(2.0 - 1.0 / np.maximum(G, 1.0 + 1e-12))
    # per-point statistical tolerance: 4 jackknife SE + systematic floor
    assert np.all(np.isfinite(r.nf_se_db[r.ok]))
    assert np.all(np.abs(r.nf_db - nf_theory)[r.ok]
                  < 4.0 * r.nf_se_db[r.ok] + 0.1)
    assert np.all(np.isfinite(r.dbeta_1_m))


def test_nf_spectrum_validation():
    cfg = _cfg()
    kw = dict(lambda_p1_m=1550e-9, lambda_p2_m=1555e-9,
              lambda_signal_m=[1552e-9], gamma=0.0115, alpha=0.0)
    with pytest.raises(ValueError, match="nonzero input power"):
        nz.noise_figure_spectrum(cfg, p_in=[0.5, 0.5, 0.0, 0.0],
                                 measure="signal", **kw)
    with pytest.raises(ValueError, match="vacuum noise"):
        nz.noise_figure_spectrum(cfg, p_in=[0.5, 0.5, 1e-7, 0.0],
                                 measure="pump1", **kw)


def test_validation():
    cfg = _cfg()
    kw = dict(gamma=GAMMA, alpha=0.0, omega=OMEGA, delta_beta=0.0)
    with pytest.raises(ValueError, match="measure"):
        nz.noise_figure_monte_carlo(cfg, p_in=[0.5, 0.5, 1e-6, 0],
                                    measure="signal+junk", **kw)
    with pytest.raises(ValueError, match="n_samples"):
        nz.noise_figure_monte_carlo(cfg, p_in=[0.5, 0.5, 1e-6, 0],
                                    n_samples=1, **kw)
    with pytest.raises(ValueError, match="t_mode_s"):
        nz.noise_figure_monte_carlo(cfg, p_in=[0.5, 0.5, 1e-6, 0],
                                    t_mode_s=0.0, **kw)
    with pytest.raises(ValueError, match="no input power"):
        nz.noise_figure_monte_carlo(cfg, p_in=[0.5, 0.5, 0.0, 0.0],
                                    measure="signal", n_samples=16, **kw)


def test_mean_field_divergence_raises():
    with pytest.raises(FloatingPointError, match="mean-field"):
        nz.noise_figure_monte_carlo(
            _cfg(), gamma=1e6, alpha=-100.0, omega=OMEGA,
            p_in=[10.0, 10.0, 1.0, 0.0], delta_beta=0.0, n_samples=16,
        )


def test_langevin_pure_loss_channel_nf():
    """A pure-loss channel (gamma = 0, power transmission eta) has the
    textbook NF = 1/eta under the Langevin beamsplitter model; the default
    deterministic loss unphysically reports ~0 dB (variance decays with the
    signal).  Exact for ANY segment count on a linear channel."""
    omega = OMEGA
    L = 100.0
    eta = 0.5
    cfg = psa.custom_simulation_config(z_max=L, dz=0.5, save_every=10)
    common = dict(gamma=0.0, alpha=-np.log(eta) / L, omega=omega,
                  p_in=[0.0, 0.0, 1e-6, 0.0],
                  noisy_waves=(False, False, True, False), measure="signal",
                  t_mode_s=1e-9, n_samples=16384, seed=0)
    r_det = psa.noise_figure_monte_carlo(cfg, **common)
    r_lan = psa.noise_figure_monte_carlo(cfg, loss_model="langevin",
                                         n_loss_segments=20, **common)
    nf_theory = -10.0 * np.log10(eta)                     # +3.010 dB
    assert abs(r_lan.nf_db - nf_theory) < 4 * r_lan.nf_se_db
    assert abs(r_det.nf_db) < 4 * r_det.nf_se_db          # the wrong model
    np.testing.assert_allclose(r_lan.gain_db, 10 * np.log10(eta), atol=1e-6)
    with pytest.raises(ValueError, match="n_loss_segments"):
        psa.noise_figure_monte_carlo(cfg, loss_model="langevin",
                                     n_loss_segments=3, **common)
    with pytest.raises(ValueError, match="loss_model"):
        psa.noise_figure_monte_carlo(cfg, loss_model="nope", **common)


def test_epr_inseparability_twin_beams():
    """CV entanglement verification: the lossless PSA's vacuum-seeded
    twin beams violate the Duan-Simon separability bound 1/2 and reach
    the ideal two-mode-squeezed value exp(-2r)/2 with sinh^2 r inferred
    from the scattered photon number (calibrated 0.1148 vs 0.1144)."""
    cfg = psa.custom_simulation_config(z_max=150.0, dz=0.05, save_every=50)
    r = psa.epr_inseparability_monte_carlo(
        cfg, gamma=5e-3, alpha=0.0, omega=OMEGA, p_pump_W=0.5,
        n_samples=8192, seed=0,
    )
    assert r.entangled and r.duan < 0.2
    assert r.duan == pytest.approx(r.duan_theory, rel=0.05)
    assert r.n_signal > 0.1
    # both superposition modes squeeze (symmetric two-mode squeezing)
    assert r.stats_plus.squeezing_db < -3.0
    assert r.stats_minus.squeezing_db < -3.0
    # the un-pumped control is separable: gamma = 0 keeps vacuum
    r0 = psa.epr_inseparability_monte_carlo(
        cfg, gamma=0.0, alpha=0.0, omega=OMEGA, p_pump_W=0.5,
        n_samples=4096, seed=1,
    )
    assert abs(r0.duan - 0.5) < 4 * 0.5 * np.sqrt(2.0 / 4096)
    with pytest.raises(ValueError, match="n_samples"):
        psa.epr_inseparability_monte_carlo(
            cfg, gamma=5e-3, alpha=0.0, omega=OMEGA, p_pump_W=0.5,
            n_samples=4)


def test_langevin_protects_epr_and_squeezing_from_fake_results():
    """On a LINEAR lossy vacuum channel the deterministic loss decays the
    ensemble below the vacuum floor -- certifying FAKE entanglement
    (duan = eta/2) and fake squeezing (v = eta/4).  The Langevin
    beamsplitter injection restores the exact separable vacuum."""
    L, eta = 100.0, 0.5
    al = -np.log(eta) / L
    cfg = psa.custom_simulation_config(z_max=L, dz=0.5, save_every=10)
    B = 8192
    common = dict(gamma=0.0, alpha=al, omega=OMEGA, p_pump_W=0.5,
                  n_samples=B, seed=0)
    rd = psa.epr_inseparability_monte_carlo(cfg, **common)
    rl = psa.epr_inseparability_monte_carlo(cfg, loss_model="langevin",
                                            n_loss_segments=20, **common)
    se = 0.5 * np.sqrt(2.0 / B)
    assert abs(rd.duan - eta / 2.0) < 4 * se      # the unphysical answer
    assert rd.entangled                            # ...falsely certified
    assert abs(rl.duan - 0.5) < 4 * se             # physical: separable
    assert not rl.entangled

    _, jd = psa.psa_squeezing_monte_carlo(cfg, **dict(common, seed=1))
    _, jl = psa.psa_squeezing_monte_carlo(cfg, loss_model="langevin",
                                          n_loss_segments=20,
                                          **dict(common, seed=1))
    assert abs(0.5 * (jd.v_min + jd.v_max) - eta / 4.0) < 2 * se
    assert abs(0.5 * (jl.v_min + jl.v_max) - 0.25) < 2 * se

    # a lossy PSA stays genuinely entangled, degraded toward the bound
    r = psa.epr_inseparability_monte_carlo(
        cfg, loss_model="langevin", n_loss_segments=20,
        **dict(common, gamma=5e-3, seed=2))
    rless = psa.epr_inseparability_monte_carlo(
        cfg, **dict(common, gamma=5e-3, alpha=0.0, seed=2))
    assert rless.duan < r.duan < 0.5
