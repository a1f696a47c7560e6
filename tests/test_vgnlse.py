"""Vector (two-polarization) GNLSE (models/vgnlse.py).

Every operator pinned by an exact oracle: CW cross-phase rotation (closed
form), reduction to the scalar solver when one polarization is empty
(bitwise — same FFT program batched over a singleton axis), exact
group-velocity walk-off by circular shift, birefringent phase rotation, and
the Manakov vector soliton (shape-invariant for any polarization angle —
the defining property of the integrable limit).
"""

import numpy as np
import pytest

import psa
from psa_simulation_ode_rk_mvp_dispersion.models import gnlse as gn
from psa_simulation_ode_rk_mvp_dispersion.models import vgnlse as vg
from psa_simulation_ode_rk_mvp_dispersion.parallel import mesh as pm

T0 = 1e-12
BETA2 = -2.0e-26
GAMMA = 2e-3
OMEGA_REF = 1.2e15


def _grid(n=512):
    return gn.TimeGrid.for_pulse(T0, n_samples=n)


def _disp():
    return psa.DispersionParams.from_betas(OMEGA_REF, beta2=BETA2)


def _cfg(**kw):
    base = dict(z_max=10.0, dz=0.05, save_every=50)
    base.update(kw)
    return psa.custom_simulation_config(**base)


def test_cw_xpm_exact_phases():
    """CW in both polarizations: powers are invariants, so the output phases
    are exactly gamma (P_self + b P_other) z for both coupling models."""
    grid = _grid()
    Px, Py, L = 3.0, 1.5, 10.0
    A0 = np.stack([np.full(512, np.sqrt(Px)),
                   np.full(512, np.sqrt(Py))]).astype(complex)
    for coupling, b, geff in (("cnlse", 2.0 / 3.0, GAMMA),
                              ("manakov", 1.0, GAMMA * 8.0 / 9.0)):
        co = vg.make_vgnlse_coeffs(grid, None, gamma_W_m=GAMMA,
                                   coupling=coupling)
        z, A = vg.run_vgnlse_simulation(_cfg(), co, A0)
        refx = np.sqrt(Px) * np.exp(1j * geff * (Px + b * Py) * L)
        refy = np.sqrt(Py) * np.exp(1j * geff * (Py + b * Px) * L)
        np.testing.assert_allclose(A[-1, 0], refx, rtol=0, atol=1e-12)
        np.testing.assert_allclose(A[-1, 1], refy, rtol=0, atol=1e-12)


def test_empty_polarization_reduces_to_scalar_bitwise():
    """All power in x: the vector solve IS the scalar solve (same FFT program
    batched over a singleton pol axis) — bitwise equality, and y stays 0."""
    grid = _grid()
    co_v = vg.make_vgnlse_coeffs(grid, _disp(), gamma_W_m=GAMMA)
    co_s = gn.make_gnlse_coeffs(grid, _disp(), gamma_W_m=GAMMA)
    As = gn.sech_pulse(
        grid, peak_W=2.0 * gn.soliton_peak_power(BETA2, GAMMA, T0), t0_s=T0
    )
    z, Av = vg.run_vgnlse_simulation(_cfg(), co_v,
                                     np.stack([As, np.zeros_like(As)]))
    zs, Ag = gn.run_gnlse_simulation(_cfg(), co_s, As)
    np.testing.assert_array_equal(Av[:, 0, :], Ag)
    assert np.abs(Av[..., 1, :]).max() == 0.0


def test_manakov_vector_soliton_invariant_any_angle():
    """The Manakov soliton (total sech at P_tot = |b2|/((8/9) g T0^2)) is
    shape-invariant for ANY polarization split — the b=1 integrability
    property; the same split under cnlse (b=2/3) is NOT invariant."""
    grid = _grid(1024)
    P0 = vg.manakov_soliton_peak_power(BETA2, GAMMA, T0)
    zper = 0.5 * np.pi * T0**2 / abs(BETA2)
    cfg = psa.custom_simulation_config(z_max=zper, dz=zper / 2000,
                                       save_every=500)
    sech = gn.sech_pulse(grid, peak_W=P0, t0_s=T0)
    for deg in (0.0, 30.0, 45.0, 90.0):
        A0 = vg.polarized_pulse(sech, np.deg2rad(deg), phi_rad=0.3)
        co = vg.make_vgnlse_coeffs(grid, _disp(), gamma_W_m=GAMMA,
                                   coupling="manakov")
        z, A = vg.run_vgnlse_simulation(cfg, co, A0)
        for row in A:
            np.testing.assert_allclose(
                np.abs(row), np.abs(A0), rtol=0, atol=3e-7 * np.sqrt(P0)
            )
    # contrast: cnlse coupling at 45 deg deforms the pulse
    A0 = vg.polarized_pulse(sech, np.deg2rad(45.0))
    co = vg.make_vgnlse_coeffs(grid, _disp(), gamma_W_m=GAMMA)
    z, A = vg.run_vgnlse_simulation(cfg, co, A0)
    assert np.abs(np.abs(A[-1]) - np.abs(A0)).max() > 1e-3 * np.sqrt(P0)


def test_walkoff_exact_circular_shift():
    """dbeta1-only propagation translates the polarizations by exactly
    -+ (dbeta1/2) z on this module's time axis (periodic window => circular
    shift; chosen as an integer number of samples for exactness)."""
    grid = _grid()
    dt = grid.dt_s
    shift = 8
    db1 = 2.0 * shift * dt / 10.0
    co = vg.make_vgnlse_coeffs(grid, None, gamma_W_m=0.0, dbeta1_s_m=db1)
    A = np.asarray(gn.gaussian_pulse(grid, peak_W=1.0, t0_s=T0))
    z, out = vg.run_vgnlse_simulation(_cfg(), co, np.stack([A, A]))
    np.testing.assert_allclose(out[-1, 0], np.roll(A, -shift), rtol=0,
                               atol=1e-13)
    np.testing.assert_allclose(out[-1, 1], np.roll(A, +shift), rtol=0,
                               atol=1e-13)


def test_dbeta0_polarization_rotation():
    """Phase birefringence alone rotates the relative phase by dbeta0*z:
    45-deg linear light traverses the Poincare sphere (S2 -> S3) while the
    per-pol powers stay exactly constant."""
    grid = _grid(64)
    db0 = 0.1
    L = 2.5 * np.pi  # dbeta0 * L = pi/4 (not a multiple of pi/2)
    co = vg.make_vgnlse_coeffs(grid, None, gamma_W_m=0.0, dbeta0_1_m=db0)
    A = np.full(64, 1.0 + 0j)
    cfg = psa.custom_simulation_config(z_max=L, dz=L / 100, save_every=100)
    z, out = vg.run_vgnlse_simulation(cfg, co, vg.polarized_pulse(A, np.pi / 4))
    s = vg.stokes_parameters(out[-1])
    np.testing.assert_allclose(s[0], 1.0, rtol=1e-12)          # S0
    np.testing.assert_allclose(s[1], 0.0, atol=1e-12)          # S1
    # x carries +dbeta0/2, so Ax* Ay ~ e^{-i dbeta0 z}: the Stokes vector
    # rotates about S1 as (S2, S3) = (cos, -sin)
    np.testing.assert_allclose(s[2], np.cos(db0 * L), rtol=1e-9)
    np.testing.assert_allclose(s[3], -np.sin(db0 * L), rtol=1e-9)
    assert vg.degree_of_polarization(grid, out[-1]) == pytest.approx(1.0)


def test_batch_and_sharded_match_single():
    import jax

    grid = _grid(256)
    co = vg.make_vgnlse_coeffs(grid, _disp(), gamma_W_m=GAMMA)
    P0 = vg.manakov_soliton_peak_power(BETA2, GAMMA, T0)
    sech = gn.sech_pulse(grid, peak_W=P0, t0_s=T0)
    A0 = np.stack([
        np.asarray(vg.polarized_pulse(s * sech, th))
        for s, th in zip(np.linspace(0.6, 1.4, 5), np.linspace(0, np.pi / 2, 5))
    ])
    pk, A_last, ok = vg.solve_vgnlse_batch(_cfg(), co, A0)
    assert ok.all() and pk.shape == (5, 2)
    z, A1 = vg.run_vgnlse_simulation(_cfg(), co, A0[3])
    np.testing.assert_allclose(A_last[3], A1[-1], rtol=0, atol=1e-12)
    np.testing.assert_allclose(
        pk[3], np.max(np.abs(A1) ** 2, axis=-1).max(axis=0), rtol=1e-12
    )
    assert len(jax.devices()) == 8, "conftest should provide 8 CPU devices"
    pk_s, A_s, ok_s = vg.solve_vgnlse_batch(_cfg(), co, A0,
                                            mesh=pm.default_mesh())
    np.testing.assert_allclose(pk_s, pk, rtol=1e-11)
    np.testing.assert_allclose(A_s, A_last, rtol=0, atol=1e-11)
    np.testing.assert_array_equal(ok_s, ok)


def test_nan_masking_and_raise():
    grid = _grid(64)
    cfg = psa.custom_simulation_config(z_max=1.0, dz=0.01, save_every=10)
    A = np.asarray(gn.gaussian_pulse(grid, peak_W=1.0, t0_s=T0))
    A0 = np.stack([np.stack([A, A])] * 2)
    co = vg.VGNLSECoeffs(
        gamma=np.full(2, 1e-6), alpha=np.array([-2e4, 0.01]),
        b_xpm=np.asarray(2.0 / 3.0),
        lin_phase=np.zeros((2, 2, grid.n_samples)),
    )
    pk, A_last, ok = vg.solve_vgnlse_batch(cfg, co, A0)
    assert not ok[0] and ok[1]
    assert np.all(np.isfinite(A_last))
    co_bad = vg.make_vgnlse_coeffs(grid, None, gamma_W_m=1e-6,
                                   alpha_1_m=-2e4)
    with pytest.raises(FloatingPointError):
        vg.run_vgnlse_simulation(cfg, co_bad, A0[0])


def test_validation_and_integrator_guard():
    grid = _grid(64)
    co = vg.make_vgnlse_coeffs(grid, None, gamma_W_m=GAMMA)
    A = np.asarray(gn.gaussian_pulse(grid, peak_W=1.0, t0_s=T0))
    with pytest.raises(ValueError, match=r"\(2, T\)"):
        vg.run_vgnlse_simulation(_cfg(), co, A)
    with pytest.raises(ValueError, match=r"\(B, 2, T\)"):
        vg.solve_vgnlse_batch(_cfg(), co, np.stack([A, A]))
    with pytest.raises(ValueError, match="coupling"):
        vg.make_vgnlse_coeffs(grid, None, gamma_W_m=GAMMA, coupling="elliptic")
    co_b = vg.VGNLSECoeffs(gamma=np.full(2, GAMMA), alpha=np.zeros(2),
                           b_xpm=np.asarray(1.0),
                           lin_phase=np.zeros((2, 2, grid.n_samples)))
    with pytest.raises(ValueError, match="unbatched"):
        vg.run_vgnlse_simulation(_cfg(), co_b, np.stack([A, A]))


def test_isotropic_coupling_rotation_invariance():
    """coupling='isotropic' (b=2/3 + coherent c=1/3) is the full isotropic
    Kerr tensor: with no birefringence, propagating a rotated input equals
    rotating the propagated output (machine level) -- and the incoherent
    cnlse model demonstrably violates this (its b=2/3 XPM alone is
    anisotropic).  Also pins pointwise total-power conservation and a real
    polarization power exchange through the coherent term."""
    grid = _grid(256)
    cfg = psa.custom_simulation_config(z_max=10.0, dz=0.01, save_every=100)
    base = np.asarray(gn.sech_pulse(grid, peak_W=8.0, t0_s=T0))
    A0 = np.stack([base, 0.6 * base * np.exp(0.4j)])
    th = 0.7

    def rot(A):
        c, s = np.cos(th), np.sin(th)
        return np.stack([c * A[0] - s * A[1], s * A[0] + c * A[1]])

    co_iso = vg.make_vgnlse_coeffs(grid, None, gamma_W_m=GAMMA,
                                   coupling="isotropic")
    _, A_f = vg.run_vgnlse_simulation(cfg, co_iso, A0)
    _, A_r = vg.run_vgnlse_simulation(cfg, co_iso, rot(A0))
    scale = np.abs(A0).max()
    np.testing.assert_allclose(A_r[-1], rot(A_f[-1]), rtol=0,
                               atol=1e-11 * scale)
    # contrast: the incoherent model is NOT rotation invariant
    co_inc = vg.make_vgnlse_coeffs(grid, None, gamma_W_m=GAMMA)
    _, B_f = vg.run_vgnlse_simulation(cfg, co_inc, A0)
    _, B_r = vg.run_vgnlse_simulation(cfg, co_inc, rot(A0))
    assert np.abs(B_r[-1] - rot(B_f[-1])).max() > 1e-3 * scale
    # coherent term: pointwise total power conserved, per-pol power moves
    Pt0 = (np.abs(A_f[0]) ** 2).sum(axis=0)
    PtL = (np.abs(A_f[-1]) ** 2).sum(axis=0)
    np.testing.assert_allclose(PtL, Pt0, rtol=0, atol=1e-11 * Pt0.max())
    assert np.abs(np.abs(A_f[-1][0]) ** 2
                  - np.abs(A_f[0][0]) ** 2).max() > 0.05


def test_isotropic_batch_shard_and_rk45():
    import jax

    grid = _grid(128)
    co = vg.make_vgnlse_coeffs(grid, _disp(), gamma_W_m=GAMMA,
                               coupling="isotropic")
    base = np.asarray(gn.sech_pulse(grid, peak_W=5.0, t0_s=T0))
    A0 = np.stack([np.asarray(vg.polarized_pulse(s * base, 0.5))
                   for s in np.linspace(0.7, 1.3, 5)])
    cfg = _cfg(dz=0.02, save_every=100)
    pk, A_last, ok = vg.solve_vgnlse_batch(cfg, co, A0)
    assert ok.all()
    _, A1 = vg.run_vgnlse_simulation(cfg, co, A0[2])
    np.testing.assert_allclose(A_last[2], A1[-1], rtol=0, atol=1e-12)
    assert len(jax.devices()) == 8
    pk_s, A_s, ok_s = vg.solve_vgnlse_batch(cfg, co, A0,
                                            mesh=pm.default_mesh())
    np.testing.assert_allclose(A_s, A_last, rtol=0, atol=1e-11)
    # adaptive path with the coherent substep
    cfg45 = _cfg(dz=0.02, save_every=100, integrator="rk45",
                 rtol=1e-8, atol=1e-10)
    pk5, A5, ok5 = vg.solve_vgnlse_batch(cfg45, co, A0)
    assert ok5.all()
    np.testing.assert_allclose(pk5, pk, rtol=1e-5)


def test_rk45_adaptive_matches_fixed_and_shards():
    """cfg.integrator='rk45' on the vector solver: agrees with a 5x-finer
    fixed-step run at tolerance (a breathing cnlse 45-deg split), batch
    matches single, sharded matches unsharded."""
    import jax

    grid = _grid(256)
    co = vg.make_vgnlse_coeffs(grid, _disp(), gamma_W_m=GAMMA)
    P0 = 2.25 * vg.manakov_soliton_peak_power(BETA2, GAMMA, T0)
    A0 = vg.polarized_pulse(gn.sech_pulse(grid, peak_W=P0, t0_s=T0),
                            np.deg2rad(45.0))
    cfg_f = _cfg(dz=0.01, save_every=250)
    z_f, A_f = vg.run_vgnlse_simulation(cfg_f, co, A0)
    cfg_a = _cfg(dz=0.01, save_every=250, integrator="rk45",
                 rtol=1e-8, atol=1e-10)
    z_a, A_a = vg.run_vgnlse_simulation(cfg_a, co, A0)
    np.testing.assert_array_equal(z_a, z_f)
    np.testing.assert_allclose(A_a[-1], A_f[-1], rtol=0,
                               atol=1e-6 * np.sqrt(P0))
    A0b = np.stack([np.asarray(A0), 0.5 * np.asarray(A0), 2.0 * np.asarray(A0)])
    pk, A_last, ok = vg.solve_vgnlse_batch(cfg_a, co, A0b)
    assert ok.all()
    np.testing.assert_allclose(A_last[0], A_a[-1], rtol=0, atol=1e-12)
    assert len(jax.devices()) == 8
    pk_s, A_s, ok_s = vg.solve_vgnlse_batch(cfg_a, co, A0b,
                                            mesh=pm.default_mesh())
    np.testing.assert_allclose(pk_s, pk, rtol=1e-11)
    np.testing.assert_allclose(A_s, A_last, rtol=0, atol=1e-11)
    np.testing.assert_array_equal(ok_s, ok)


def test_x32_precision_path():
    grid = _grid(256)
    P0 = vg.manakov_soliton_peak_power(BETA2, GAMMA, T0)
    sech = gn.sech_pulse(grid, peak_W=P0, t0_s=T0)
    A0 = np.stack([np.asarray(vg.polarized_pulse(sech, 0.5))] * 3)
    co64 = vg.make_vgnlse_coeffs(grid, _disp(), gamma_W_m=GAMMA,
                                 coupling="manakov")
    co32 = vg.make_vgnlse_coeffs(grid, _disp(), gamma_W_m=GAMMA,
                                 coupling="manakov", precision="x32")
    pk64, A64, _ = vg.solve_vgnlse_batch(_cfg(), co64, A0)
    pk32, A32, ok = vg.solve_vgnlse_batch(
        _cfg(precision="x32"), co32, A0
    )
    assert ok.all()
    np.testing.assert_allclose(pk32, pk64, rtol=5e-4)
    assert np.max(np.abs(A32 - A64)) < 5e-4 * np.sqrt(P0)


def test_saved_grid_partial_tail_contract():
    grid = _grid(128)
    co = vg.make_vgnlse_coeffs(grid, _disp(), gamma_W_m=GAMMA)
    A = np.asarray(gn.gaussian_pulse(grid, peak_W=1.0, t0_s=T0))
    A0 = np.stack([np.stack([A, 0.5 * A])] * 2)
    _, A_full, _ = vg.solve_vgnlse_batch(_cfg(z_max=10.0), co, A0)
    _, A_tail, _ = vg.solve_vgnlse_batch(_cfg(z_max=10.5), co, A0)
    np.testing.assert_allclose(A_tail, A_full, rtol=0, atol=1e-13)


def test_batch_trajectories_match_single_runs():
    from psa_simulation_ode_rk_mvp_dispersion.models.gnlse import (
        TimeGrid, gaussian_pulse)

    grid = TimeGrid(n_samples=64, t_window_s=40e-12)
    disp = psa.DispersionParams.from_betas(1.2e15, beta2=-2e-26)
    co = vg.make_vgnlse_coeffs(grid, disp, gamma_W_m=1e-2, dbeta0_1_m=0.1)
    A0 = np.stack([
        np.asarray(vg.polarized_pulse(
            gaussian_pulse(grid, peak_W=p, t0_s=1e-12), 0.3))
        for p in (0.5, 1.0)
    ])
    cfg = psa.custom_simulation_config(z_max=2.0, dz=0.01, save_every=50)
    z_b, A_b, ok_b = vg.solve_vgnlse_batch_trajectories(cfg, co, A0)
    assert ok_b.all() and A_b.shape == (2, 5, 2, 64)
    for i in range(2):
        z_s, A_s = vg.run_vgnlse_simulation(cfg, co, A0[i])
        assert np.array_equal(A_b[i], A_s)
    _pk, A_last, _ok = vg.solve_vgnlse_batch(cfg, co, A0)
    assert np.array_equal(A_b[:, -1], A_last)


def test_spectral_alpha_exact_frequency_dependent_loss_vector():
    """Frequency-dependent loss (round 3): with gamma=0 and no dispersion
    the vector solve is exactly diagonal in omega -- each polarization's
    spectral bins decay as exp(-alpha_pol(omega) z), bin by bin."""
    grid = _grid(128)
    om = grid.omega()
    spec = 5e-3 * (om / np.abs(om).max()) ** 2      # band-edge loss profile
    # polarization-dependent loss: y sees double the spectral profile
    spec2 = np.stack([spec, 2.0 * spec])
    co = vg.make_vgnlse_coeffs(grid, None, gamma_W_m=0.0, alpha_1_m=2e-3,
                               alpha_spec_1_m=spec2)
    A0 = np.stack([gn.gaussian_pulse(grid, peak_W=1.0, t0_s=1e-12),
                   gn.gaussian_pulse(grid, peak_W=0.5, t0_s=2e-12)])
    cfg = _cfg(z_max=100.0, dz=0.5, save_every=40)
    z, A = vg.run_vgnlse_simulation(cfg, co, A0)
    for p in range(2):
        S0 = np.fft.fft(A0[p])
        S1 = np.fft.fft(A[-1, p])
        expected = S0 * np.exp(-0.5 * (2e-3 + spec2[p]) * z[-1])
        np.testing.assert_allclose(S1, expected, rtol=1e-10,
                                   atol=1e-12 * np.abs(S0).max())

    # a shared (T,) profile is normalized to (2, T): both pols match pol-0
    co_sh = vg.make_vgnlse_coeffs(grid, None, gamma_W_m=0.0, alpha_1_m=2e-3,
                                  alpha_spec_1_m=spec)
    assert np.asarray(co_sh.alpha).shape == (2, 128)
    z2, A2 = vg.run_vgnlse_simulation(cfg, co_sh, A0)
    S1y = np.fft.fft(A2[-1, 1])
    expy = np.fft.fft(A0[1]) * np.exp(-0.5 * (2e-3 + spec) * z2[-1])
    np.testing.assert_allclose(S1y, expy, rtol=1e-10,
                               atol=1e-12 * np.abs(expy).max())


def test_spectral_alpha_vector_batch_and_sharded():
    """(2, T) spectral alpha broadcast over the batch equals single runs;
    sharded == unsharded; trajectories API carries it too."""
    grid = _grid(64)
    om = grid.omega()
    spec = np.stack([1e-3 * (om / np.abs(om).max()) ** 2,
                     2e-3 * (om / np.abs(om).max()) ** 2])
    co = vg.make_vgnlse_coeffs(grid, _disp(), gamma_W_m=GAMMA,
                               alpha_spec_1_m=spec)
    A0 = np.stack([
        np.stack([gn.gaussian_pulse(grid, peak_W=p, t0_s=1e-12),
                  gn.gaussian_pulse(grid, peak_W=0.5 * p, t0_s=1e-12)])
        for p in np.linspace(0.4, 1.0, 5)
    ])
    cfg = _cfg(z_max=2.0, dz=0.02, save_every=25)
    pk, Af, ok = vg.solve_vgnlse_batch(cfg, co, A0)
    assert ok.all()
    # batch row i equals its single run
    z1, A1 = vg.run_vgnlse_simulation(cfg, co, A0[2])
    np.testing.assert_allclose(Af[2], A1[-1], rtol=0, atol=1e-12)
    pk_s, Af_s, ok_s = vg.solve_vgnlse_batch(cfg, co, A0,
                                             mesh=pm.default_mesh())
    np.testing.assert_allclose(Af_s, Af, rtol=0, atol=1e-12)
    np.testing.assert_array_equal(ok_s, ok)
    # trajectories API: final saved frame matches the reduce-mode result
    zt, At, okt = vg.solve_vgnlse_batch_trajectories(cfg, co, A0)
    np.testing.assert_allclose(At[:, -1], Af, rtol=0, atol=1e-12)


def test_spectral_alpha_vector_validation():
    grid = _grid(64)
    with pytest.raises(ValueError, match="alpha_spec"):
        vg.make_vgnlse_coeffs(grid, None, gamma_W_m=0.0,
                              alpha_spec_1_m=np.zeros(32))
    with pytest.raises(ValueError, match="finite"):
        vg.make_vgnlse_coeffs(grid, None, gamma_W_m=0.0,
                              alpha_spec_1_m=np.full((2, 64), np.nan))
