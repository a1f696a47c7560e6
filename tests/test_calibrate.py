"""Differentiable solver surface + gradient-based calibration
(``parallel/calibrate.py``).

Oracles: jax.grad through the full RK4 solve matches central finite
differences to ~1e-6 relative (measured 3e-11); a synthetic noiseless
gain-vs-mismatch curve recovers (gamma, dbeta_offset) to a few permille
and alpha (the weakly identified total-loss tilt) to ~10% from a
30%-off start (calibration run 2026-08-18: rels 1.9e-3 / 3.4e-3 /
8.5e-2 at 800 steps, rms 0.0013 dB)."""

import jax
import numpy as np
import pytest

import psa
from psa_simulation_ode_rk_mvp_dispersion.ops.rhs import RHSCoeffs
from psa_simulation_ode_rk_mvp_dispersion.parallel.calibrate import _resolve_precision

P_IN = [0.5, 0.5, 1e-5, 0.0]


def _cfg():
    return psa.custom_simulation_config(z_max=100.0, dz=1.0, save_every=10)


def test_gradient_matches_finite_difference():
    gain = psa.make_gain_model(_cfg(), p_in=P_IN)
    co = dict(alpha=2e-4, delta_beta=-3e-3)
    g = jax.grad(lambda gm: gain(RHSCoeffs(gamma=gm, **co)))(0.0115)
    eps = 1e-7
    fd = (gain(RHSCoeffs(gamma=0.0115 + eps, **co))
          - gain(RHSCoeffs(gamma=0.0115 - eps, **co))) / (2 * eps)
    assert float(g) == pytest.approx(float(fd), rel=1e-6)
    # d(gain)/d(alpha) is analytic for the dominant linear-loss term:
    # -10/ln(10) * z_max on top of the parametric sensitivity
    ga = jax.grad(lambda al: gain(
        RHSCoeffs(gamma=0.0115, alpha=al, delta_beta=-3e-3)))(2e-4)
    assert float(ga) < 0.0
    with pytest.raises(ValueError, match="no input power"):
        psa.make_gain_model(_cfg(), p_in=[0.5, 0.5, 0.0, 0.0])


def test_fit_recovers_synthetic_gain_curve():
    cfg = _cfg()
    gain = psa.make_gain_model(cfg, p_in=P_IN)
    truth = dict(gamma=0.0115, alpha=2.0e-4, dbeta_offset=-3e-3)
    db = np.linspace(-0.05, 0.03, 24)
    curve = jax.jit(jax.vmap(lambda d: gain(RHSCoeffs(
        gamma=truth["gamma"], alpha=truth["alpha"],
        delta_beta=d + truth["dbeta_offset"]))))(db)
    fit = psa.fit_gain_curve(
        cfg, delta_beta_grid=db, measured_gain_db=np.asarray(curve),
        p_in=P_IN, init=dict(gamma=0.008, alpha=0.0, dbeta_offset=0.0),
        steps=400, learning_rate=0.05,
    )
    assert np.sqrt(fit.loss_db2) < 0.05
    assert fit.params["gamma"] == pytest.approx(truth["gamma"], rel=0.05)
    assert fit.params["dbeta_offset"] == pytest.approx(
        truth["dbeta_offset"], rel=0.10)
    # loss decreases by orders of magnitude from the 30%-off start
    assert fit.loss_history[-1] < 1e-3 * fit.loss_history[0]
    assert fit.gain_db.shape == db.shape

    with pytest.raises(ValueError, match="matching 1-D"):
        psa.fit_gain_curve(cfg, delta_beta_grid=db,
                           measured_gain_db=np.zeros(3), p_in=P_IN)
    with pytest.raises(ValueError, match="unknown init"):
        psa.fit_gain_curve(cfg, delta_beta_grid=db,
                           measured_gain_db=np.asarray(curve), p_in=P_IN,
                           init=dict(bogus=1.0))
    with pytest.raises(ValueError, match="positive"):
        psa.fit_gain_curve(cfg, delta_beta_grid=db,
                           measured_gain_db=np.asarray(curve), p_in=P_IN,
                           init=dict(gamma=-1.0))


def test_pulse_model_parity_and_spectrum_fit():
    """make_pulse_model reuses the production SSFM stepper, so its
    forward pass is BITWISE the batched engine; the spectrum fit
    recovers (gamma, beta2) to a few percent inside the right
    dispersion-sign basin (calibration 2026-08-18: rels 8.8e-2 /
    4.6e-2, rms 0.14 dB at 400 steps, lr 0.1)."""
    from psa_simulation_ode_rk_mvp_dispersion.models import gnlse as gn

    T0 = 1e-12
    grid = gn.TimeGrid.for_pulse(T0, n_samples=128)
    truth = dict(gamma=2e-3, beta2=-2e-26)
    P0 = psa.soliton_peak_power(truth["beta2"], truth["gamma"], T0) * 2.25
    A0 = np.asarray(psa.sech_pulse(grid, peak_W=P0, t0_s=T0))
    zs = 0.5 * np.pi * T0**2 / abs(truth["beta2"])
    cfg = psa.custom_simulation_config(z_max=zs, dz=zs / 200,
                                       save_every=200)
    field = psa.make_pulse_model(cfg, grid, A0)
    y = np.asarray(jax.jit(field)(truth))
    disp = psa.DispersionParams.from_betas(1.2e15, beta2=truth["beta2"])
    co = gn.make_gnlse_coeffs(grid, disp, gamma_W_m=truth["gamma"])
    _, A_ref, _ = psa.solve_gnlse_batch(cfg, co, A0[None])
    np.testing.assert_array_equal(y, A_ref[0])      # bitwise

    # gradient through the SSFM vs finite differences
    f = lambda b2: jnp_abs0(field({"gamma": truth["gamma"], "beta2": b2}))
    g = float(jax.grad(f)(truth["beta2"]))
    eps = 1e-31
    fd = (float(f(truth["beta2"] + eps))
          - float(f(truth["beta2"] - eps))) / (2 * eps)
    assert g == pytest.approx(fd, rel=1e-4)

    meas = 10 * np.log10(np.maximum(np.abs(np.fft.fft(y)) ** 2, 1e-300))
    fit = psa.fit_pulse_spectrum(cfg, grid, A0, meas,
                                 init=dict(gamma=1.4e-3, beta2=-2.8e-26),
                                 steps=400, learning_rate=0.1)
    assert np.sqrt(fit.loss_db2) < 0.5
    assert fit.params["gamma"] == pytest.approx(truth["gamma"], rel=0.15)
    assert fit.params["beta2"] == pytest.approx(truth["beta2"], rel=0.12)
    with pytest.raises(ValueError, match="gamma"):
        psa.fit_pulse_spectrum(cfg, grid, A0, meas, init=dict(beta2=-2e-26))


def jnp_abs0(y):
    import jax.numpy as jnp

    return jnp.abs(y[0]) ** 2


def test_pump_rin_transfer_matches_autodiff():
    """The MC regression of gain [dB] on jittered launch powers [dB]
    reproduces the exact autodiff transfer sensitivities (measured
    0.8639/0.8640 vs 0.864 dB/dB); gamma = 0 transfers are all zero; the
    signal's own-power transfer vanishes in the undepleted regime."""
    cfg = psa.custom_simulation_config(z_max=100.0, dz=0.5, save_every=20)
    kw = dict(gamma=0.0115, alpha=2e-4, delta_beta=-3e-3,
              p_in=[0.5, 0.5, 1e-5, 0.0])
    r = psa.pump_rin_transfer_monte_carlo(cfg, n_samples=4096, seed=0, **kw)
    dev = np.abs(r.transfer_db_per_db - r.transfer_autodiff)
    assert np.all(dev < np.maximum(4.0 * r.transfer_se, 2e-3))
    assert r.transfer_autodiff[0] > 0.5            # pumps drive the gain
    assert abs(r.transfer_autodiff[2]) < 1e-3      # undepleted signal
    assert r.transfer_db_per_db[3] == 0.0          # zero-power idler
    assert r.gain_std_db > 0.0

    r0 = psa.pump_rin_transfer_monte_carlo(
        cfg, n_samples=1024, seed=1, gamma=0.0, alpha=2e-4,
        delta_beta=0.0, p_in=[0.5, 0.5, 1e-5, 0.0])
    assert np.all(np.abs(r0.transfer_autodiff) < 1e-9)
    assert np.all(np.abs(r0.transfer_db_per_db) < 1e-6)
    with pytest.raises(ValueError, match="rel_sigma"):
        psa.pump_rin_transfer_monte_carlo(cfg, n_samples=64, rel_sigma=0.9,
                                          **kw)


def test_phase_transfer_gauge_structure():
    """Phase-noise transfer: a PIA (signal-only seed) is invariant to
    every absolute launch phase (all transfers exactly 0); the PSA's
    transfers realize the pure phi_s + phi_i - phi_p1 - phi_p2
    combination (equal magnitudes, signs (-,-,+,+)) with the global
    phase exactly null -- the gauge structure of parametric gain."""
    cfg = psa.custom_simulation_config(z_max=100.0, dz=0.5, save_every=20)
    t_pia = psa.phase_transfer_db_per_rad(
        cfg, gamma=0.0115, alpha=2e-4, delta_beta=-3e-3,
        p_in=[0.5, 0.5, 1e-5, 0.0])
    assert np.all(np.abs(t_pia) < 1e-9)

    t = psa.phase_transfer_db_per_rad(
        cfg, gamma=0.0115, alpha=2e-4, delta_beta=-3e-3,
        p_in=[0.5, 0.5, 5e-6, 5e-6], phase_in=[0, 0, 0.8, 0])
    assert abs(t.sum()) < 1e-9                      # global phase is gauge
    assert t[2] > 0.1                               # phase-sensitive
    np.testing.assert_allclose(t[2], t[3], rtol=1e-9)
    np.testing.assert_allclose(t[0], t[1], rtol=1e-9)
    np.testing.assert_allclose(t[0], -t[2], rtol=1e-9)


def test_fit_gain_experiment_roundtrip(tmp_path):
    """mismatch sweep artifact -> fit-gain experiment: recovers the
    sweep's own gamma (10 1/(W km)) and near-zero alpha/offset from the
    saved NPZ alone (calibration 2026-08-18: exact gamma, rms 1.5e-4 dB,
    early-stopped at 136/400 steps)."""
    from psa_simulation_ode_rk_mvp_dispersion import experiments as ex

    ex.mismatch_scan(span=30, n_points=16, show=False,
                     save_dir=str(tmp_path), verbose=False)
    fit = ex.fit_gain(str(tmp_path / "mismatch_scan.npz"), steps=400,
                      show=False, save_dir=str(tmp_path), verbose=True)
    assert fit.params["gamma"] * 1e3 == pytest.approx(10.0, rel=0.02)
    assert abs(fit.params["dbeta_offset"] * 1e3) < 0.5      # 1/km
    assert np.sqrt(fit.loss_db2) < 0.01
    assert (tmp_path / "fit_gain.npz").exists()
    assert (tmp_path / "fit_gain.png").exists()


def test_x32_tier_matches_x64_oracle():
    """precision='x32': forward gain matches the x64 oracle to f32 class,
    the gradient to ~1e-3 relative, and a full fit recovers the same
    parameters."""
    import jax.numpy as jnp

    cfg = _cfg()
    g64 = psa.make_gain_model(cfg, p_in=P_IN)
    g32 = psa.make_gain_model(cfg, p_in=P_IN, precision="x32")

    def co(rdt):
        return RHSCoeffs(gamma=jnp.asarray(0.0115, rdt),
                         alpha=jnp.asarray(2e-4, rdt),
                         delta_beta=jnp.asarray(-3e-3, rdt))

    v32 = float(g32(co(jnp.float32)))
    gr32 = float(jax.grad(lambda gm: g32(RHSCoeffs(
        gamma=gm, alpha=jnp.asarray(2e-4, jnp.float32),
        delta_beta=jnp.asarray(-3e-3, jnp.float32))))(
            jnp.asarray(0.0115, jnp.float32)))
    v64 = float(g64(co(jnp.float64)))
    gr64 = float(jax.grad(lambda gm: g64(RHSCoeffs(
        gamma=gm, alpha=2e-4, delta_beta=-3e-3)))(0.0115))
    assert v32 == pytest.approx(v64, rel=2e-4, abs=1e-4)
    assert gr32 == pytest.approx(gr64, rel=2e-3)

    # full x32 fit recovers the synthetic truth (same bar as the x64 fit)
    truth = dict(gamma=0.0115, alpha=2.0e-4, dbeta_offset=-3e-3)
    db = np.linspace(-0.05, 0.03, 16)
    curve = np.asarray(jax.vmap(lambda d: g32(RHSCoeffs(
        gamma=jnp.asarray(truth["gamma"], jnp.float32),
        alpha=jnp.asarray(truth["alpha"], jnp.float32),
        delta_beta=(d + jnp.asarray(truth["dbeta_offset"], jnp.float32)
                    ).astype(jnp.float32))))(
        jnp.asarray(db, jnp.float32)), dtype=np.float64)
    fit = psa.fit_gain_curve(
        cfg, delta_beta_grid=db, measured_gain_db=curve, p_in=P_IN,
        init=dict(gamma=0.008, alpha=0.0, dbeta_offset=0.0),
        steps=400, learning_rate=0.05, precision="x32",
    )
    assert np.sqrt(fit.loss_db2) < 0.05
    assert fit.params["gamma"] == pytest.approx(truth["gamma"], rel=0.05)
    assert fit.params["dbeta_offset"] == pytest.approx(
        truth["dbeta_offset"], rel=0.10)


def test_precision_tier_validation():
    """The AD model builders reject df32 with a pointer to the hybrid
    fit, and default to x64 on every backend."""
    cfg = _cfg()
    assert _resolve_precision(None, "x") == "x64"
    with pytest.raises(ValueError, match="df32"):
        psa.make_gain_model(cfg, p_in=P_IN, precision="df32")
    with pytest.raises(ValueError, match="df32"):
        psa.make_launch_gain_model(cfg, precision="df32")


def test_df32_hybrid_fit_reaches_oracle_grade():
    """precision='df32' (VERDICT r4 #5): adam explore + derivative-free
    LM polish through the production batch engine.  On a noiseless
    synthetic curve the polish must clear the pure-adam fit's noise
    floor by orders of magnitude -- the forward is the SAME engine that
    generated the data, so LM can drive the residual to numerical zero,
    including alpha, the weakly identified valley direction adam leaves
    at ~10% (module docstring).  The engine forward is x64."""
    cfg = _cfg()
    truth = dict(gamma=0.0115, alpha=2.0e-4, dbeta_offset=-3e-3)
    db = np.linspace(-0.05, 0.03, 16)
    # synthesize the measurement with the ENGINE (what the polish runs),
    # at the tier the backend will use -- the explore stage's AD model is
    # bitwise-comparable by the module's measurement convention
    from psa_simulation_ode_rk_mvp_dispersion.parallel.calibrate import (
        _engine_gain_curve_fn,
    )

    gen = _engine_gain_curve_fn(cfg, db, p_in=P_IN, phase_in=None, wave=2,
                                forward_precision="x64")
    z = float(cfg.z_max)
    th_true = np.array([np.log(truth["gamma"]), truth["alpha"] * z,
                        truth["dbeta_offset"] * z])
    curve = gen(th_true[None, :])[0]

    fit = psa.fit_gain_curve(
        cfg, delta_beta_grid=db, measured_gain_db=curve, p_in=P_IN,
        init=dict(gamma=0.008, alpha=0.0, dbeta_offset=0.0),
        steps=300, learning_rate=0.05, precision="df32",
    )
    assert np.sqrt(fit.loss_db2) < 1e-4          # tol_db early stop
    assert fit.params["gamma"] == pytest.approx(truth["gamma"], rel=1e-4)
    assert fit.params["dbeta_offset"] == pytest.approx(
        truth["dbeta_offset"], rel=1e-3)
    assert fit.params["alpha"] == pytest.approx(truth["alpha"], rel=1e-2)
    # the polish tail of the history must improve on the explore stage's
    # best loss by orders of magnitude
    assert fit.loss_history[-1] < 1e-2 * np.min(fit.loss_history[:301])
