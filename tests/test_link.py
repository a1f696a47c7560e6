"""Multi-span amplified links (``psa.pulse_link_monte_carlo``).

Oracles (linear spans make every law exact -- no linearization of the
propagation, only the bright-pulse reduction of the energy statistics):

- a transparent chain with the ASE switched OFF is an exact affine
  identity per lane: every collective-coordinate statistic is bitwise
  constant across boundaries (the mechanical control -- physically this
  is the same fake a deterministic-loss squeezing measurement commits);
- with ASE on, the per-time-bin symmetric variance after N transparent
  spans is V_N = 1/2 + N (G-1)(2 n_sp - 1)/2 half-photons, so the
  energy variance follows the EXACT Gaussian law
  Var(E) = 2 n V_N + T V_N^2 and the input-referred NF is the
  Friis-type cascade 1 + N (G-1)(2 n_sp - 1) in the bright limit;
- with dispersion on, each amplifier's frequency kick converts into
  timing spread over the remaining distance: the (Var_t, Cov, Var_f)
  recursion [span: t -> t - beta2 L f; amp: Var_f += sigma_f^2,
  Var_t += sigma_t^2] predicts the whole measured Var_t(z) curve --
  the Gordon-Haus z^3 accumulation.

Calibration 2026-08-18 (B=4096, N=12 spans): GH recursion max rel dev
0.118 (the lossy span makes the soliton breathe, so the kick variances
are only approximately constant); cubic-excess ratio 6.16 (pure-cubic
limit 8; the linear sigma_t^2 term dilutes it).
"""

import numpy as np
import pytest

import psa
from psa_simulation_ode_rk_mvp_dispersion.models import gnlse as gn
from psa_simulation_ode_rk_mvp_dispersion.parallel import mesh as pm

OM0 = 1.2e15
T0 = 1e-12
BETA2 = -2.0e-26


def _grid(n=128):
    return gn.TimeGrid.for_pulse(T0, n_samples=n)


def _span_cfg(z=50.0, steps=20):
    return psa.custom_simulation_config(z_max=z, dz=z / steps,
                                        save_every=steps)


def test_noiseless_transparent_chain_is_identity():
    """gamma=0, beta2=0, loss exactly restored, ase=False: every lane is
    rescaled back to itself each span, so all statistics are constant."""
    grid = _grid()
    co = gn.make_gnlse_coeffs(grid, None, gamma_W_m=0.0, alpha_1_m=5e-3)
    A0 = np.asarray(psa.sech_pulse(grid, peak_W=1.0, t0_s=T0))
    m = psa.pulse_link_monte_carlo(_span_cfg(), co, A0, grid, omega0=OM0,
                                   n_spans=4, ase=False, n_samples=64,
                                   seed=0)
    assert m.ok_fraction == 1.0
    for arr in (m.energy_mean, m.energy_var, m.t_var, m.f_var, m.tf_cov):
        np.testing.assert_allclose(arr, arr[0], rtol=1e-9)


def test_friis_nf_cascade_exact_gaussian_law():
    """Transparent dispersion-free chain: per-bin variance grows by
    (G-1)(2 n_sp - 1)/2 half-photons per amplifier; the measured energy
    variance must ride Var(E) = 2 n V + T V^2 at every boundary."""
    grid = _grid()
    alpha = 5e-3
    co = gn.make_gnlse_coeffs(grid, None, gamma_W_m=0.0, alpha_1_m=alpha)
    A0 = np.asarray(psa.sech_pulse(grid, peak_W=0.01, t0_s=T0))
    cfg = _span_cfg()
    z_span = psa.span_observed_length_m(cfg)
    G = float(np.exp(alpha * z_span))
    assert G > 1.1
    B, N, n_sp = 4096, 8, 1.3
    m = psa.pulse_link_monte_carlo(cfg, co, A0, grid, omega0=OM0,
                                   n_spans=N, n_sp=n_sp, n_samples=B,
                                   seed=1)
    T = grid.t().shape[0]
    n = float(m.energy_mean[0])                  # photons (V_0 correction
    k = np.arange(N + 1)                         # is T/2 << n)
    V = 0.5 + k * (G - 1.0) * (2.0 * n_sp - 1.0) / 2.0
    pred = 2.0 * n * V + T * V ** 2
    se = np.sqrt(2.0 / B)                        # relative SE of a variance
    np.testing.assert_allclose(m.energy_var, pred, rtol=4 * se)
    # input-referred NF cascade (net gain 1): bright-pulse Friis law
    nf = m.energy_var[-1] / m.energy_var[0]
    assert abs(nf - (1.0 + N * (G - 1.0) * (2.0 * n_sp - 1.0))) \
        < 4 * se * nf * np.sqrt(2.0)
    # the mean picks up exactly the injected photons (T/2 per unit V)
    np.testing.assert_allclose(m.energy_mean, n + T * (V - V[0]),
                               rtol=1e-3)


def test_gordon_haus_timing_jitter_accumulation():
    """Soliton link: the exact (Var_t, Cov, Var_f) recursion -- quadratic
    conversion inside each span (the NLSE momentum theorems are per-lane
    exact for ANY field), one frequency + one timing kick per amplifier
    -- predicts the measured timing-variance curve, whose kick-driven
    excess accumulates cubically (Gordon-Haus).  The soliton matters:
    its stationary shape keeps the per-amplifier kick variances constant
    (a linear pulse disperses, so its timing kicks grow with the width)."""
    grid = _grid()
    alpha = 5e-3
    gamma = 2e-3
    disp = psa.DispersionParams.from_betas(OM0, beta2=BETA2)
    co = gn.make_gnlse_coeffs(grid, disp, gamma_W_m=gamma, alpha_1_m=alpha)
    P0 = psa.soliton_peak_power(BETA2, gamma, T0)
    A0 = np.asarray(psa.sech_pulse(grid, peak_W=P0, t0_s=T0))
    cfg = _span_cfg()
    L = psa.span_observed_length_m(cfg)
    B, N = 4096, 12
    m = psa.pulse_link_monte_carlo(cfg, co, A0, grid, omega0=OM0,
                                   n_spans=N, n_samples=B, seed=2)
    # frequency variance: one iid kick per amplifier -> linear growth
    sig_f2 = float(np.mean(np.diff(m.f_var)))
    assert sig_f2 > 0
    np.testing.assert_allclose(m.f_var, m.f_var[0] + np.arange(N + 1)
                               * sig_f2, rtol=0.1)
    # timing kick: boundary 1 minus the in-span dispersive conversion
    def span(vt, cv, vf):
        return (vt - 2 * BETA2 * L * cv + (BETA2 * L) ** 2 * vf,
                cv - BETA2 * L * vf, vf)

    vt1, cv1, vf1 = span(m.t_var[0], m.tf_cov[0], m.f_var[0])
    sig_t2 = float(m.t_var[1]) - vt1
    # full recursion against the measured curve
    vt, cv, vf = m.t_var[0], m.tf_cov[0], m.f_var[0]
    pred = [vt]
    for _ in range(N):
        vt, cv, vf = span(vt, cv, vf)
        vt, vf = vt + sig_t2, vf + sig_f2
        pred.append(vt)
    # rtol covers MC error + the breathing-soliton kick drift (see header)
    np.testing.assert_allclose(m.t_var, pred, rtol=0.2)
    # cubic accumulation: kick-driven excess at N vs N/2 approaches 8x
    vt, cv, vf = m.t_var[0], m.tf_cov[0], m.f_var[0]
    kickfree = [vt]
    for _ in range(N):
        vt, cv, vf = span(vt, cv, vf)
        kickfree.append(vt)
    excess = np.asarray(m.t_var) - np.asarray(kickfree)
    ratio = excess[N] / excess[N // 2]
    assert 5.0 < ratio < 11.0


def test_link_sharded_matches_unsharded():
    grid = _grid()
    disp = psa.DispersionParams.from_betas(OM0, beta2=BETA2)
    co = gn.make_gnlse_coeffs(grid, disp, gamma_W_m=2e-3, alpha_1_m=5e-3)
    A0 = np.asarray(psa.sech_pulse(grid, peak_W=1.0, t0_s=T0))
    kw = dict(omega0=OM0, n_spans=3, n_samples=64, seed=3)
    m0 = psa.pulse_link_monte_carlo(_span_cfg(), co, A0, grid, **kw)
    m1 = psa.pulse_link_monte_carlo(_span_cfg(), co, A0, grid,
                                    mesh=pm.default_mesh(), **kw)
    np.testing.assert_allclose(m1.t_var, m0.t_var, rtol=1e-12)
    np.testing.assert_allclose(m1.energy_var, m0.energy_var, rtol=1e-12)


def test_link_validation():
    grid = _grid()
    co = gn.make_gnlse_coeffs(grid, None, gamma_W_m=0.0)
    A0 = np.asarray(psa.sech_pulse(grid, peak_W=1.0, t0_s=T0))
    with pytest.raises(ValueError, match="n_spans"):
        psa.pulse_link_monte_carlo(_span_cfg(), co, A0, grid, omega0=OM0,
                                   n_spans=0, n_samples=64)
    with pytest.raises(ValueError, match="n_sp"):
        psa.pulse_link_monte_carlo(_span_cfg(), co, A0, grid, omega0=OM0,
                                   n_spans=2, n_sp=0.5, n_samples=64)
    with pytest.raises(ValueError, match="amp_gain"):
        psa.pulse_link_monte_carlo(_span_cfg(), co, A0, grid, omega0=OM0,
                                   n_spans=2, amp_gain=0.5, n_samples=64)
    co_spec = gn.make_gnlse_coeffs(
        grid, None, gamma_W_m=0.0,
        alpha_spec_1_m=np.full(grid.t().shape[0], 1e-3))
    with pytest.raises(ValueError, match="flat scalar"):
        psa.pulse_link_monte_carlo(_span_cfg(), co_spec, A0, grid,
                                   omega0=OM0, n_spans=2, n_samples=64)
