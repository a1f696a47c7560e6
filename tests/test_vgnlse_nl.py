"""Generalized (Raman + self-steepening) nonlinearity for the VECTOR
family -- ``models/vgnlse._v_nl_rhs_gen`` (isotropic-Raman approximation:
the scalar delayed response acts on the total power P_x + P_y).

Oracles, all discretization-exact (they pin the discrete map, so grid
resolution is irrelevant):

- empty-pol reduction: with A_y = 0 the vector operator IS the scalar
  generalized operator (itself pinned by the Gordon red-shift and
  shock-centroid physics tests in test_gnlse.py);
- equal-split Manakov equivalence: A_x = A_y = a/sqrt(2) propagates
  exactly as the scalar field a with gamma_eff = (8/9) gamma -- every
  term sees only the total power;
- U(2) rotation invariance of the Manakov + isotropic-Raman flow (the
  whole nonlinearity is a function of P_x + P_y alone).
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


def _grid(n=256):
    return gn.TimeGrid.for_pulse(T0, n_samples=n)


def _nl(grid, **kw):
    kw.setdefault("f_raman", 0.18)
    kw.setdefault("omega0", OMEGA_REF)
    return gn.make_nl_terms(grid, **kw)


def _cfg(**kw):
    base = dict(z_max=2.0, dz=0.02, save_every=20)
    base.update(kw)
    return psa.custom_simulation_config(**base)


def _sech_batch(grid, B, scale=1.0):
    P0 = gn.soliton_peak_power(BETA2, GAMMA, T0)
    return np.stack([
        np.sqrt(p * P0) / np.cosh(grid.t() / T0)
        for p in scale * np.linspace(0.6, 1.4, B)
    ]).astype(np.complex128)


def test_empty_pol_reduces_to_scalar_generalized_operator():
    """All power in x: the vector generalized operator reduces exactly to
    the scalar one (P_y = 0 drops the coupling, the total-power Raman
    convolution sees P_x alone) -- for BOTH couplings, with steepening."""
    grid = _grid()
    disp = psa.DispersionParams.from_betas(OMEGA_REF, beta2=BETA2)
    nl = _nl(grid)
    a = _sech_batch(grid, 3)
    A0 = np.stack([a, np.zeros_like(a)], axis=1)          # (B, 2, T)
    cfg = _cfg()

    co_s = gn.make_gnlse_coeffs(grid, disp, gamma_W_m=GAMMA, alpha_1_m=5e-5)
    pk_s, Af_s, ok_s = gn.solve_gnlse_batch(cfg, co_s, a, nl=nl)

    for coupling in ("cnlse", "isotropic"):
        co_v = vg.make_vgnlse_coeffs(grid, disp, gamma_W_m=GAMMA,
                                     alpha_1_m=5e-5, coupling=coupling)
        pk_v, Af_v, ok_v = vg.solve_vgnlse_batch(cfg, co_v, A0, nl=nl)
        assert ok_v.all() and ok_s.all()
        np.testing.assert_allclose(Af_v[:, 0], Af_s, rtol=0,
                                   atol=1e-12 * np.abs(Af_s).max())
        assert np.abs(Af_v[:, 1]).max() == 0.0
        np.testing.assert_allclose(pk_v[:, 0], pk_s, rtol=1e-12)


def test_equal_split_manakov_matches_scalar_gamma_eff():
    """A_x = A_y = a/sqrt(2) under Manakov + isotropic Raman + steepening
    evolves exactly as the scalar field a with gamma_eff = (8/9) gamma:
    every nonlinear term is a function of the total power |a|^2 alone."""
    grid = _grid()
    disp = psa.DispersionParams.from_betas(OMEGA_REF, beta2=BETA2)
    nl = _nl(grid)
    a = _sech_batch(grid, 2, scale=9.0 / 8.0)  # soliton at gamma_eff
    A0 = np.stack([a, a], axis=1) / np.sqrt(2.0)
    cfg = _cfg()

    co_v = vg.make_vgnlse_coeffs(grid, disp, gamma_W_m=GAMMA,
                                 coupling="manakov")
    pk_v, Af_v, ok_v = vg.solve_vgnlse_batch(cfg, co_v, A0, nl=nl)

    co_s = gn.make_gnlse_coeffs(grid, disp,
                                gamma_W_m=GAMMA * 8.0 / 9.0)
    pk_s, Af_s, ok_s = gn.solve_gnlse_batch(cfg, co_s, a, nl=nl)
    assert ok_v.all() and ok_s.all()
    ref = Af_s / np.sqrt(2.0)
    for p in (0, 1):
        np.testing.assert_allclose(Af_v[:, p], ref, rtol=0,
                                   atol=1e-10 * np.abs(ref).max())


def test_rotation_invariance_manakov_raman():
    """Manakov + isotropic Raman depends on the pol state only through
    P_x + P_y, so propagation commutes with any constant U(2) rotation."""
    rng = np.random.default_rng(11)
    grid = _grid()
    disp = psa.DispersionParams.from_betas(OMEGA_REF, beta2=BETA2)
    nl = _nl(grid)
    a = _sech_batch(grid, 2)
    A0 = np.stack([0.8 * a, 0.6 * a * np.exp(0.7j)], axis=1)
    # random SU(2)
    th, ph1, ph2 = rng.uniform(0, 2 * np.pi, 3)
    U = np.array([
        [np.cos(th) * np.exp(1j * ph1), np.sin(th) * np.exp(1j * ph2)],
        [-np.sin(th) * np.exp(-1j * ph2), np.cos(th) * np.exp(-1j * ph1)],
    ])
    co = vg.make_vgnlse_coeffs(grid, disp, gamma_W_m=GAMMA,
                               coupling="manakov")
    cfg = _cfg()
    _pk, Af, ok = vg.solve_vgnlse_batch(cfg, co, A0, nl=nl)
    _pk2, Af_rot, ok2 = vg.solve_vgnlse_batch(
        cfg, co, np.einsum("pq,bqt->bpt", U, A0), nl=nl)
    assert ok.all() and ok2.all()
    np.testing.assert_allclose(Af_rot, np.einsum("pq,bqt->bpt", U, Af),
                               rtol=0, atol=1e-10 * np.abs(Af).max())


def test_raman_moves_energy_and_red_shifts_both_pols():
    """Physics direction check: with Raman on, the energy-weighted spectral
    centroid of BOTH polarizations moves toward lower frequency (the
    vector Gordon self-frequency shift); without nl it stays put."""
    grid = _grid()
    disp = psa.DispersionParams.from_betas(OMEGA_REF, beta2=BETA2)
    nl = _nl(grid, omega0=None)           # Raman only, no shock term
    a = _sech_batch(grid, 1, scale=8.0 / 9.0 * 4.0)   # strong N~2 soliton
    A0 = np.stack([0.9 * a, 0.45 * a], axis=1)
    cfg = _cfg(z_max=20.0, dz=0.02, save_every=1000)
    co = vg.make_vgnlse_coeffs(grid, disp, gamma_W_m=GAMMA,
                               coupling="manakov")

    def centroid(Af):
        w = np.fft.fftfreq(grid.n_samples, d=grid.dt_s)
        S = np.abs(np.fft.fft(Af, axis=-1)) ** 2
        return (w * S).sum(-1) / S.sum(-1)

    _pk, Af, ok = vg.solve_vgnlse_batch(cfg, co, A0, nl=nl)
    _pk0, Af0, ok0 = vg.solve_vgnlse_batch(cfg, co, A0)
    assert ok.all() and ok0.all()
    c_nl, c_kerr = centroid(Af[0]), centroid(Af0[0])
    # t = -T axis convention: the red shift appears as a POSITIVE drift
    # of the fft-frequency centroid (see gnlse test_gordon_red_shift)
    shift = np.abs(c_nl - c_kerr)
    assert (shift > 1e9).all()            # well above numerical noise
    assert np.sign(c_nl[0] - c_kerr[0]) == np.sign(c_nl[1] - c_kerr[1])


def test_rk45_nl_matches_fine_fixed_step():
    grid = _grid(128)
    disp = psa.DispersionParams.from_betas(OMEGA_REF, beta2=BETA2)
    nl = _nl(grid)
    a = _sech_batch(grid, 2)
    A0 = np.stack([0.8 * a, 0.5 * a], axis=1)
    co = vg.make_vgnlse_coeffs(grid, disp, gamma_W_m=GAMMA,
                               coupling="manakov")
    _pk, Af_ref, _ok = vg.solve_vgnlse_batch(
        _cfg(z_max=2.0, dz=0.002, save_every=1000), co, A0, nl=nl)
    _pk2, Af_ad, ok = vg.solve_vgnlse_batch(
        _cfg(z_max=2.0, dz=0.2, save_every=1, integrator="rk45",
             rtol=1e-9, atol=1e-12), co, A0, nl=nl)
    assert ok.all()
    np.testing.assert_allclose(Af_ad, Af_ref, rtol=0,
                               atol=1e-6 * np.abs(Af_ref).max())


def test_sharded_matches_unsharded_nl():
    import jax

    mesh = pm.default_mesh()
    grid = _grid(128)
    disp = psa.DispersionParams.from_betas(OMEGA_REF, beta2=BETA2)
    nl = _nl(grid)
    B = 2 * len(jax.devices())
    a = _sech_batch(grid, B)
    A0 = np.stack([0.8 * a, 0.5 * a], axis=1)
    co = vg.make_vgnlse_coeffs(grid, disp, gamma_W_m=GAMMA,
                               coupling="manakov")
    cfg = _cfg(z_max=0.5, dz=0.01, save_every=10)
    pk, Af, ok = vg.solve_vgnlse_batch(cfg, co, A0, nl=nl)
    pk_s, Af_s, ok_s = vg.solve_vgnlse_batch(cfg, co, A0, nl=nl, mesh=mesh)
    assert np.array_equal(ok, ok_s)
    np.testing.assert_allclose(Af_s, Af, rtol=0,
                               atol=1e-11 * np.abs(Af).max())
    np.testing.assert_allclose(pk_s, pk, rtol=1e-11)
    # adaptive sharded path with nl terms
    cfg_ad = _cfg(z_max=0.5, dz=0.05, save_every=1, integrator="rk45",
                  rtol=1e-7, atol=1e-10)
    pk_a, Af_a, ok_a = vg.solve_vgnlse_batch(cfg_ad, co, A0, nl=nl)
    pk_as, Af_as, ok_as = vg.solve_vgnlse_batch(cfg_ad, co, A0, nl=nl,
                                                mesh=mesh)
    assert ok_a.all() and np.array_equal(ok_a, ok_as)
    np.testing.assert_allclose(Af_as, Af_a, rtol=0,
                               atol=1e-11 * np.abs(Af_a).max())


def test_vector_supercontinuum_fission_preserves_polarization():
    """Scaled-down polarization-resolved Dudley run
    (experiments.vector_supercontinuum): fission broadens BOTH
    polarizations >5x, and in the Manakov + isotropic-Raman limit the
    dynamics depend only on total power, so the polarization state -- and
    the DOP -- is preserved through the whole supercontinuum."""
    from psa_simulation_ode_rk_mvp_dispersion import experiments as ex
    from psa_simulation_ode_rk_mvp_dispersion.models.vgnlse import (
        degree_of_polarization,
    )

    z, A = ex.vector_supercontinuum(
        n_samples=1024, window_ps=3.0, length_m=0.03, theta_deg=25.0,
        rtol=1e-5, n_saved=10, show=False, verbose=False)
    assert np.all(np.isfinite(A))

    def bw(a):
        S = np.abs(np.fft.fft(a)) ** 2
        keep = np.fft.fftshift(S > S.max() * 1e-3)
        idx = np.nonzero(keep)[0]
        return idx[-1] - idx[0]

    for p in (0, 1):
        assert bw(A[-1][p]) > 5 * bw(A[0][p])
    grid = gn.TimeGrid(n_samples=1024, t_window_s=3.0e-12)
    assert degree_of_polarization(grid, A[-1]) > 0.9999
    # the pol split is exactly preserved (total-power-only dynamics)
    frac = (np.abs(A[-1]) ** 2).sum(-1)
    frac = frac[0] / frac.sum()
    np.testing.assert_allclose(frac, np.cos(np.deg2rad(25.0)) ** 2,
                               rtol=1e-6)


def test_runner_trajectories_and_validation():
    grid = _grid(128)
    disp = psa.DispersionParams.from_betas(OMEGA_REF, beta2=BETA2)
    nl = _nl(grid)
    a = _sech_batch(grid, 2)
    A0 = np.stack([0.8 * a, 0.5 * a], axis=1)
    co = vg.make_vgnlse_coeffs(grid, disp, gamma_W_m=GAMMA,
                               coupling="manakov")
    cfg = _cfg(z_max=0.4, dz=0.01, save_every=10)
    pk, Af, ok = vg.solve_vgnlse_batch(cfg, co, A0, nl=nl)
    # single runner agrees with the batch solve
    z, A = vg.run_vgnlse_simulation(cfg, co, A0[0], nl=nl)
    np.testing.assert_allclose(A[-1], Af[0], rtol=0,
                               atol=1e-13 * np.abs(Af[0]).max())
    # trajectory final row agrees too
    zt, At, okt = vg.solve_vgnlse_batch_trajectories(cfg, co, A0, nl=nl)
    assert okt.all()
    np.testing.assert_allclose(At[:, -1], Af, rtol=0,
                               atol=1e-13 * np.abs(Af).max())
    # the x32 tier runs the nl terms to f32 class against x64
    kw = dict(z_max=0.4, dz=0.01, save_every=10)
    out = {}
    for prec in ("x32", "x64"):
        co_p = vg.make_vgnlse_coeffs(grid, disp, gamma_W_m=GAMMA,
                                     coupling="manakov", precision=prec)
        nl_p = gn.make_nl_terms(grid, f_raman=0.18, omega0=OMEGA_REF,
                                precision=prec)
        out[prec] = vg.solve_vgnlse_batch(
            psa.custom_simulation_config(precision=prec, **kw), co_p, A0,
            nl=nl_p)
    (_pk32, Af32, ok32), (_pk64, Af64, ok64) = out["x32"], out["x64"]
    assert np.array_equal(ok32, ok64)
    np.testing.assert_allclose(Af32, Af64, rtol=0,
                               atol=2e-4 * np.abs(Af64).max())
