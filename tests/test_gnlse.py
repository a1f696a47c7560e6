"""GNLSE split-step Fourier model (models/gnlse.py).

Every operator is pinned by a closed-form oracle (dispersion-only Gaussian
broadening, SPM-only phase, loss-only decay — each EXACT for split-step, so
tolerances are machine-level), their combination by the fundamental soliton,
and the whole solver by an independent cross-oracle: a periodic-window GNLSE
with comb-line initial conditions is the N-wave comb ODE system
(models/nwave.py, fixed-step RK4) — two unrelated integrators on two
unrelated formulations must agree on every significant line.
"""

import numpy as np
import pytest

import psa
from psa_simulation_ode_rk_mvp_dispersion.models import gnlse as gn
from psa_simulation_ode_rk_mvp_dispersion.models import nwave as nw
from psa_simulation_ode_rk_mvp_dispersion.parallel import mesh as pm

T0 = 1e-12
BETA2 = -2.0e-26
OMEGA_REF = 1.2e15


def _grid(n=512):
    return gn.TimeGrid.for_pulse(T0, n_samples=n)


def _disp(beta2=BETA2, **kw):
    return psa.DispersionParams.from_betas(OMEGA_REF, beta2=beta2, **kw)


# ---------------------------------------------------------------------------
# Grids and comb embedding
# ---------------------------------------------------------------------------

def test_time_grid_validation_and_axes():
    with pytest.raises(ValueError):
        gn.TimeGrid(n_samples=1, t_window_s=1.0)
    with pytest.raises(ValueError):
        gn.TimeGrid(n_samples=64, t_window_s=-1.0)
    g = gn.TimeGrid(n_samples=64, t_window_s=6.4e-11)
    assert g.dt_s == pytest.approx(1e-12)
    assert g.t().shape == (64,) and g.omega().shape == (64,)
    assert g.t()[32] == 0.0  # centered


def test_comb_field_roundtrip():
    g = gn.TimeGrid(n_samples=256, t_window_s=1e-10)
    domega = 2 * np.pi * 8 / 1e-10  # 8 bins per line
    rng = np.random.default_rng(0)
    amps = rng.normal(size=9) + 1j * rng.normal(size=9)
    field = gn.comb_to_field(g, amps, domega)
    back = gn.field_to_comb(g, field, 9, domega)
    np.testing.assert_allclose(back, amps, rtol=1e-13, atol=1e-15)
    # line power == |amp|^2 through the spectrum helper's normalization
    om, S = gn.spectrum_dbw(g, field)
    assert S.max() == pytest.approx(10 * np.log10((np.abs(amps) ** 2).max()), abs=1e-9)
    with pytest.raises(ValueError, match="integer multiple"):
        gn.comb_to_field(g, amps, domega * 1.01)


# ---------------------------------------------------------------------------
# Closed-form single-operator oracles (exact for split-step)
# ---------------------------------------------------------------------------

def test_dispersion_only_gaussian_broadening():
    grid = _grid(1024)
    co = gn.make_gnlse_coeffs(grid, _disp(), gamma_W_m=0.0)
    cfg = psa.custom_simulation_config(z_max=100.0, dz=1.0, save_every=100)
    z, A = gn.run_gnlse_simulation(cfg, co, gn.gaussian_pulse(grid, peak_W=1.0, t0_s=T0))
    L = 100.0
    T1 = T0 * np.sqrt(1 + (BETA2 * L / T0**2) ** 2)
    P_ana = (T0 / T1) * np.exp(-((grid.t() / T1) ** 2))
    np.testing.assert_allclose(np.abs(A[-1]) ** 2, P_ana, rtol=0, atol=1e-13)


def test_spm_only_exact_phase():
    grid = _grid()
    co = gn.make_gnlse_coeffs(grid, None, gamma_W_m=2e-3)
    cfg = psa.custom_simulation_config(z_max=100.0, dz=1.0, save_every=100)
    A0 = gn.gaussian_pulse(grid, peak_W=5.0, t0_s=T0, chirp=0.5)
    z, A = gn.run_gnlse_simulation(cfg, co, A0)
    A_ref = A0 * np.exp(1j * 2e-3 * np.abs(A0) ** 2 * 100.0)
    np.testing.assert_allclose(A[-1], A_ref, rtol=0, atol=1e-12)


def test_loss_only_decay():
    grid = _grid()
    co = gn.make_gnlse_coeffs(grid, None, gamma_W_m=0.0, alpha_1_m=0.01)
    cfg = psa.custom_simulation_config(z_max=100.0, dz=1.0, save_every=100)
    A0 = gn.gaussian_pulse(grid, peak_W=2.0, t0_s=T0)
    z, A = gn.run_gnlse_simulation(cfg, co, A0)
    np.testing.assert_allclose(A[-1], A0 * np.exp(-0.5 * 0.01 * 100.0),
                               rtol=0, atol=1e-12)
    # energy tracks exp(-alpha z) on every saved row
    E = gn.pulse_energy(grid, A)
    np.testing.assert_allclose(E / E[0], np.exp(-0.01 * z), rtol=1e-12)


def test_fundamental_soliton_shape_invariant():
    grid = _grid(1024)
    gam = 2e-3
    P0 = gn.soliton_peak_power(BETA2, gam, T0)
    co = gn.make_gnlse_coeffs(grid, _disp(), gamma_W_m=gam)
    zper = 0.5 * np.pi * T0**2 / abs(BETA2)  # soliton period
    cfg = psa.custom_simulation_config(z_max=zper, dz=zper / 1000, save_every=250)
    Asol = gn.sech_pulse(grid, peak_W=P0, t0_s=T0)
    z, A = gn.run_gnlse_simulation(cfg, co, Asol)
    # |A| invariant on EVERY saved row (the defining soliton property)
    for row in A:
        np.testing.assert_allclose(np.abs(row), np.abs(Asol),
                                   rtol=0, atol=3e-7 * np.sqrt(P0))
    with pytest.raises(ValueError, match="anomalous"):
        gn.soliton_peak_power(abs(BETA2), gam, T0)


# ---------------------------------------------------------------------------
# Cross-oracle: periodic-window GNLSE == N-wave comb ODE system
# ---------------------------------------------------------------------------

def test_gnlse_matches_nwave_comb():
    """Two independent solvers of the same physics: split-step Fourier on the
    field vs fixed-step RK4 on the (truncated) line ODEs.  With the comb wide
    enough that truncation is negligible, every significant line must agree.
    Pins the fft sign convention, beta3's odd-order sign, gamma and alpha."""
    omega_c = 2 * np.pi * 193.1e12
    domega = 2 * np.pi * 50e9
    N = 65
    cgrid = nw.CombGrid.centered(omega_c, domega, N)
    gam, al = 10e-3, 5e-5
    c = N // 2
    A0 = nw.seed_comb(cgrid, pump_lines={c - 1: 0.3, c + 1: 0.3, c + 4: 1e-5})
    disp = psa.DispersionParams.from_betas(omega_c, beta2=-1.0e-27, beta3=1.2e-41)
    coeffs = nw.make_comb_coeffs(cgrid, disp, gamma_W_m=gam, alpha_1_m=al)
    L = 60.0
    cfg = psa.custom_simulation_config(z_max=L, dz=0.02, save_every=3000)
    z, Acomb = nw.run_comb_simulation(cfg, coeffs, A0)

    tgrid = gn.TimeGrid(n_samples=1024, t_window_s=2 * np.pi / domega * 8)
    field0 = gn.comb_to_field(tgrid, A0, domega)
    gco = gn.make_gnlse_coeffs(tgrid, disp, gamma_W_m=gam, alpha_1_m=al)
    zg, Af = gn.run_gnlse_simulation(cfg, gco, field0)
    lines = gn.field_to_comb(tgrid, Af[-1], N, domega)

    ref = Acomb[-1]
    sig = np.abs(ref) ** 2 > 1e-9
    assert sig.sum() >= 5  # a real cascade, not just the pumps
    np.testing.assert_allclose(lines[sig], ref[sig], rtol=1e-6)


# ---------------------------------------------------------------------------
# Batch / sharding / failure contracts
# ---------------------------------------------------------------------------

def _batch_setup(B=6, n=256):
    grid = _grid(n)
    gam = 2e-3
    peaks = np.linspace(0.5, 2.0, B) * gn.soliton_peak_power(BETA2, gam, T0)
    A0 = np.stack([np.asarray(gn.sech_pulse(grid, peak_W=p, t0_s=T0)) for p in peaks])
    co = gn.make_gnlse_coeffs(grid, _disp(), gamma_W_m=gam)
    cfg = psa.custom_simulation_config(z_max=10.0, dz=0.05, save_every=50)
    return grid, co, cfg, A0


def test_batch_matches_single():
    grid, co, cfg, A0 = _batch_setup()
    pk, A_last, ok = gn.solve_gnlse_batch(cfg, co, A0)
    assert ok.all()
    z, A1 = gn.run_gnlse_simulation(cfg, co, A0[3])
    np.testing.assert_allclose(A_last[3], A1[-1], rtol=0, atol=1e-12)
    np.testing.assert_allclose(
        pk[3], max((np.abs(r) ** 2).max() for r in A1), rtol=1e-12
    )


def test_batch_sharded_matches_unsharded():
    import jax

    assert len(jax.devices()) == 8, "conftest should provide 8 CPU devices"
    grid, co, cfg, A0 = _batch_setup(B=11)  # not divisible by 8 -> padding
    pk, A_last, ok = gn.solve_gnlse_batch(cfg, co, A0)
    mesh = pm.default_mesh()
    pk_s, A_s, ok_s = gn.solve_gnlse_batch(cfg, co, A0, mesh=mesh)
    np.testing.assert_allclose(pk_s, pk, rtol=1e-11)
    np.testing.assert_allclose(A_s, A_last, rtol=0, atol=1e-11)
    np.testing.assert_array_equal(ok_s, ok)


def test_saved_grid_convention_partial_tail():
    """A_last sits at the last saved grid point; trailing partial steps are
    integrated (they can flip ok) but unobserved."""
    grid, co, _, A0 = _batch_setup(B=2)
    cfg_full = psa.custom_simulation_config(z_max=10.0, dz=0.05, save_every=50)
    cfg_tail = psa.custom_simulation_config(z_max=10.5, dz=0.05, save_every=50)
    _, A_full, _ = gn.solve_gnlse_batch(cfg_full, co, A0)
    _, A_tail, _ = gn.solve_gnlse_batch(cfg_tail, co, A0)
    np.testing.assert_allclose(A_tail, A_full, rtol=0, atol=1e-13)
    # trajectory mode: same saved rows regardless of the tail
    z1, t1 = gn.run_gnlse_simulation(cfg_full, co, A0[0])
    z2, t2 = gn.run_gnlse_simulation(cfg_tail, co, A0[0])
    np.testing.assert_array_equal(z1, z2)
    np.testing.assert_allclose(t2, t1, rtol=0, atol=1e-13)


def test_nan_masking_and_raise():
    # the Kerr operator is a pure phase rotation and the loss factor only
    # decays, so the way to blow up an SSFM solve is runaway GAIN
    # (alpha < 0): the field overflows to inf within a few chunks
    grid = _grid(128)
    co_bad = gn.make_gnlse_coeffs(grid, None, gamma_W_m=1e-6, alpha_1_m=-2e4)
    cfg = psa.custom_simulation_config(z_max=1.0, dz=0.01, save_every=10)
    A0 = np.stack([
        np.asarray(gn.gaussian_pulse(grid, peak_W=1.0, t0_s=T0)),
        np.asarray(gn.gaussian_pulse(grid, peak_W=1.0, t0_s=T0)),
    ])
    co = gn.GNLSECoeffs(gamma=np.full(2, 1e-6), alpha=np.array([-2e4, 0.01]),
                        lin_phase=np.zeros((2, grid.n_samples)))
    pk, A_last, ok = gn.solve_gnlse_batch(cfg, co, A0)
    assert not ok[0] and ok[1]
    assert np.all(np.isfinite(A_last[1]))
    assert np.all(np.isfinite(A_last[0]))  # frozen at the last finite state
    with pytest.raises(FloatingPointError):
        gn.run_gnlse_simulation(cfg, co_bad, A0[0])


def test_x32_precision_path():
    grid, co, cfg, A0 = _batch_setup(B=3)
    import dataclasses

    co32 = gn.make_gnlse_coeffs(grid, _disp(), gamma_W_m=2e-3, precision="x32")
    cfg32 = dataclasses.replace(cfg, precision="x32")
    pk64, A64, _ = gn.solve_gnlse_batch(cfg, co, A0)
    pk32, A32, ok = gn.solve_gnlse_batch(cfg32, co32, A0)
    assert ok.all()
    np.testing.assert_allclose(pk32, pk64, rtol=5e-4)
    assert np.max(np.abs(A32 - A64)) < 5e-4 * np.sqrt(pk64.max())


def test_input_validation():
    grid, co, cfg, A0 = _batch_setup(B=2)
    with pytest.raises(ValueError, match=r"\(B, T\)"):
        gn.solve_gnlse_batch(cfg, co, A0[0])
    with pytest.raises(ValueError, match=r"\(T,\)"):
        gn.run_gnlse_simulation(cfg, co, A0)
    # batched coeffs into the single-envelope runner: error, not a silent
    # B-fold solve returning instance 0
    co_b = gn.GNLSECoeffs(gamma=np.full(2, 1e-3), alpha=np.zeros(2),
                          lin_phase=np.zeros((2, grid.n_samples)))
    with pytest.raises(ValueError, match="unbatched"):
        gn.run_gnlse_simulation(cfg, co_b, A0[0])


# ---------------------------------------------------------------------------
# Extended nonlinearity: Raman response + self-steepening
# ---------------------------------------------------------------------------

def test_nl_pure_kerr_matches_exact_rotation():
    """f_raman=0, no omega0: the RK4 substep integrates i gamma |A|^2 A and
    must match the exact Kerr rotation path to RK4's local error."""
    grid = _grid()
    co = gn.make_gnlse_coeffs(grid, None, gamma_W_m=2e-3)
    cfg = psa.custom_simulation_config(z_max=100.0, dz=1.0, save_every=100)
    A0 = gn.gaussian_pulse(grid, peak_W=5.0, t0_s=T0)
    nl0 = gn.make_nl_terms(grid, f_raman=0.0, omega0=None)
    _, Ak = gn.run_gnlse_simulation(cfg, co, A0)
    _, Ar = gn.run_gnlse_simulation(cfg, co, A0, nl=nl0)
    np.testing.assert_allclose(Ar[-1], Ak[-1], rtol=0, atol=1e-8)


def test_nl_cw_reduces_to_exact_spm():
    """For a CW field the delayed response integrates to H_R(0) = 1 and the
    shock derivative vanishes, so the FULL generalized operator must still
    produce the exact SPM phase — pins the H_R normalization and the
    steepening term's null space at once."""
    grid = _grid()
    gam = 2e-3
    co = gn.make_gnlse_coeffs(grid, None, gamma_W_m=gam)
    cfg = psa.custom_simulation_config(z_max=100.0, dz=1.0, save_every=100)
    Acw = np.full(grid.n_samples, np.sqrt(3.0), dtype=np.complex128)
    nl = gn.make_nl_terms(grid, f_raman=0.18, omega0=OMEGA_REF)
    _, A = gn.run_gnlse_simulation(cfg, co, Acw, nl=nl)
    np.testing.assert_allclose(
        A[-1], Acw * np.exp(1j * gam * 3.0 * 100.0), rtol=0, atol=1e-9
    )


def test_raman_soliton_self_frequency_shift_gordon():
    """Soliton + Raman: the spectral centroid red-shifts at Gordon's rate
    d<omega>/dz = -8 |beta2| T_R / (15 T0^4) (leading-order perturbation;
    10% tolerance).  Pins the SIGN of the Raman correlation on this module's
    time axis — the shift must be toward lower physical frequency."""
    t0 = 1e-13
    grid = gn.TimeGrid.for_pulse(t0, n_samples=1024)
    gam = 2e-3
    P0 = gn.soliton_peak_power(BETA2, gam, t0)
    co = gn.make_gnlse_coeffs(grid, _disp(), gamma_W_m=gam)
    nl = gn.make_nl_terms(grid, f_raman=0.18)  # Raman only, no steepening
    t_r = gn.raman_t_r(grid, nl)
    assert 1e-15 < t_r < 1e-14  # silica-scale first moment (~1.5 fs)
    L = 10.0
    cfg = psa.custom_simulation_config(z_max=L, dz=0.005, save_every=2000)
    _, A = gn.run_gnlse_simulation(cfg, co, gn.sech_pulse(grid, peak_W=P0, t0_s=t0),
                                   nl=nl)
    om = grid.omega()

    def centroid(a):
        S = np.abs(np.fft.fft(a)) ** 2
        return (om * S).sum() / S.sum()

    shift = centroid(A[-1]) - centroid(A[0])
    gordon = -8.0 * abs(BETA2) * t_r / (15.0 * t0**4) * L
    assert shift < 0  # red shift, always
    np.testing.assert_allclose(shift, gordon, rtol=0.1)


def test_self_steepening_centroid_drift_exact():
    """Steepening only (no dispersion, no Raman): the intensity obeys a
    conservation-form shock equation, so the temporal centroid drifts at the
    EXACT rate d<t>/dz = -(3 gamma / (2 omega0)) * int P^2 / int P (minus on
    this module's reversed time axis).  Machine-level oracle for the shock
    term's coefficient and sign."""
    grid = _grid()
    gam, w0 = 2e-3, OMEGA_REF
    co = gn.make_gnlse_coeffs(grid, None, gamma_W_m=gam)
    nl = gn.make_nl_terms(grid, f_raman=0.0, omega0=w0)
    A0 = gn.gaussian_pulse(grid, peak_W=50.0, t0_s=T0)
    L = 20.0
    cfg = psa.custom_simulation_config(z_max=L, dz=0.01, save_every=2000)
    _, A = gn.run_gnlse_simulation(cfg, co, A0, nl=nl)
    t = grid.t()

    def tcent(a):
        P = np.abs(a) ** 2
        return (t * P).sum() / P.sum()

    P0 = np.abs(A0) ** 2
    rate_ana = -(1.5 * gam / w0) * (P0**2).sum() / P0.sum()
    rate_meas = (tcent(A[-1]) - tcent(A[0])) / L
    np.testing.assert_allclose(rate_meas, rate_ana, rtol=1e-9)


def test_nl_batch_and_sharded_match_single():
    import jax

    grid = _grid(256)
    gam = 2e-3
    co = gn.make_gnlse_coeffs(grid, _disp(), gamma_W_m=gam)
    nl = gn.make_nl_terms(grid, f_raman=0.18, omega0=OMEGA_REF)
    peaks = np.linspace(0.5, 2.0, 5) * gn.soliton_peak_power(BETA2, gam, T0)
    A0 = np.stack([np.asarray(gn.sech_pulse(grid, peak_W=p, t0_s=T0)) for p in peaks])
    cfg = psa.custom_simulation_config(z_max=10.0, dz=0.05, save_every=50)
    pk, A_last, ok = gn.solve_gnlse_batch(cfg, co, A0, nl=nl)
    assert ok.all()
    _, A1 = gn.run_gnlse_simulation(cfg, co, A0[2], nl=nl)
    np.testing.assert_allclose(A_last[2], A1[-1], rtol=0, atol=1e-12)
    # and the nl path actually differs from pure Kerr
    _, A_kerr = gn.run_gnlse_simulation(cfg, co, A0[2])
    assert np.max(np.abs(A_kerr[-1] - A1[-1])) > 1e-6
    assert len(jax.devices()) == 8, "conftest should provide 8 CPU devices"
    pk_s, A_s, ok_s = gn.solve_gnlse_batch(cfg, co, A0, nl=nl, mesh=pm.default_mesh())
    np.testing.assert_allclose(pk_s, pk, rtol=1e-11)
    np.testing.assert_allclose(A_s, A_last, rtol=0, atol=1e-11)
    np.testing.assert_array_equal(ok_s, ok)


# ---------------------------------------------------------------------------
# Adaptive split-step (integrator='rk45')
# ---------------------------------------------------------------------------

def test_rk45_matches_fine_fixed_step():
    """Adaptive split-step vs a 5x-finer fixed-step reference on an N=1.5
    (breathing, non-integrable-profile) pulse with Raman: same save grid,
    agreement at the requested tolerance."""
    grid = _grid()
    gam = 2e-3
    co = gn.make_gnlse_coeffs(grid, _disp(), gamma_W_m=gam)
    nl = gn.make_nl_terms(grid, f_raman=0.18)
    A0 = gn.sech_pulse(grid, peak_W=2.25 * gn.soliton_peak_power(BETA2, gam, T0),
                       t0_s=T0)
    zper = 0.5 * np.pi * T0**2 / abs(BETA2)
    cfg_f = psa.custom_simulation_config(z_max=zper, dz=zper / 10000, save_every=2500)
    z_f, A_f = gn.run_gnlse_simulation(cfg_f, co, A0, nl=nl)
    cfg_a = psa.custom_simulation_config(z_max=zper, dz=zper / 10000, save_every=2500,
                                         integrator="rk45", rtol=1e-8, atol=1e-10)
    z_a, A_a = gn.run_gnlse_simulation(cfg_a, co, A0, nl=nl)
    np.testing.assert_array_equal(z_a, z_f)
    scale = np.abs(A0).max()
    np.testing.assert_allclose(A_a[-1], A_f[-1], rtol=0, atol=1e-6 * scale)


def test_rk45_actually_adapts():
    """The controller must open the step up when the dynamics are easy: a
    dispersion-only solve (the split is exact) needs orders of magnitude
    fewer accepted steps than a soliton at the same tolerance."""
    import jax.numpy as jnp

    from psa_simulation_ode_rk_mvp_dispersion.utils.packing import ri_pack_host

    grid = _grid()
    gam = 2e-3
    A0 = gn.sech_pulse(grid, peak_W=2.25 * gn.soliton_peak_power(BETA2, gam, T0),
                       t0_s=T0)
    solver = gn._gnlse_adaptive_solver("float64", 1e-8, 1e-10, 100_000, True)
    zg = jnp.asarray(np.linspace(0.0, 100.0, 5))
    y0 = ri_pack_host(A0[None], np.float64)
    T = grid.n_samples
    co_lin = gn.make_gnlse_coeffs(grid, _disp(), gamma_W_m=0.0)
    _, _, ok_l, na_l, nr_l = gn._split_reduce_pack(
        solver(y0, co_lin, zg, jnp.asarray(0.1), None), T, counters=True)
    co_sol = gn.make_gnlse_coeffs(grid, _disp(), gamma_W_m=gam)
    _, _, ok_s, na_s, _ = gn._split_reduce_pack(
        solver(y0, co_sol, zg, jnp.asarray(0.1), None), T, counters=True)
    assert int(np.asarray(ok_l)[0]) == 1 and int(np.asarray(ok_s)[0]) == 1
    assert int(np.asarray(na_l)[0]) * 20 < int(np.asarray(na_s)[0])
    assert int(np.asarray(nr_l)[0]) == 0  # exact split: nothing to reject


def test_rk45_batch_and_sharded_match_single():
    import dataclasses

    import jax

    grid, co, cfg, A0 = _batch_setup(B=5)
    cfg45 = dataclasses.replace(cfg, integrator="rk45", rtol=1e-8, atol=1e-10)
    pk, A_last, ok = gn.solve_gnlse_batch(cfg45, co, A0)
    assert ok.all()
    z1, A1 = gn.run_gnlse_simulation(cfg45, co, A0[2])
    np.testing.assert_allclose(A_last[2], A1[-1], rtol=0, atol=1e-12)
    np.testing.assert_allclose(
        pk[2], max((np.abs(r) ** 2).max() for r in A1), rtol=1e-12
    )
    # and against the rk4 fixed-step result at tolerance
    pk4, A4, _ = gn.solve_gnlse_batch(cfg, co, A0)
    np.testing.assert_allclose(pk, pk4, rtol=1e-5)
    assert len(jax.devices()) == 8, "conftest should provide 8 CPU devices"
    pk_s, A_s, ok_s = gn.solve_gnlse_batch(cfg45, co, A0, mesh=pm.default_mesh())
    np.testing.assert_allclose(pk_s, pk, rtol=1e-11)
    np.testing.assert_allclose(A_s, A_last, rtol=0, atol=1e-11)
    np.testing.assert_array_equal(ok_s, ok)


def test_rk45_failure_masking_and_raise():
    """Runaway gain: adaptive lanes fail by step-size underflow / non-finite
    states; the batch masks them per-lane, the single-run raises."""
    import dataclasses

    grid = _grid(128)
    cfg = psa.custom_simulation_config(z_max=1.0, dz=0.01, save_every=10,
                                       integrator="rk45", rtol=1e-6, atol=1e-9)
    co = gn.GNLSECoeffs(gamma=np.full(2, 1e-6), alpha=np.array([-2e4, 0.01]),
                        lin_phase=np.zeros((2, grid.n_samples)))
    A0 = np.stack([np.asarray(gn.gaussian_pulse(grid, peak_W=1.0, t0_s=T0))] * 2)
    pk, A_last, ok = gn.solve_gnlse_batch(cfg, co, A0)
    assert not ok[0] and ok[1]
    assert np.all(np.isfinite(A_last[1]))
    co_bad = gn.make_gnlse_coeffs(grid, None, gamma_W_m=1e-6, alpha_1_m=-2e4)
    with pytest.raises(FloatingPointError):
        gn.run_gnlse_simulation(cfg, co_bad, A0[0])
    # check_nan=False: masked, not raised
    cfg_nc = dataclasses.replace(cfg, check_nan=False)
    z, A = gn.run_gnlse_simulation(cfg_nc, co_bad, A0[0])
    assert A.shape[0] == z.shape[0]


def test_rk45_integrates_trailing_partial_steps():
    """rk45 save-decimation contract (advisor r3): the trailing
    ``n_steps % save_every`` span is integrated but unsaved -- saved rows
    are bit-identical to a run ending exactly on the grid; a failure in the
    tail (here: runaway gain with n_chunks==0, so EVERY step is trailing)
    still raises; a NaN A0 with n_chunks==0 keeps the check_nan contract."""
    grid = _grid(128)
    gam = 2e-3
    co = gn.make_gnlse_coeffs(grid, _disp(), gamma_W_m=gam)
    A0 = gn.sech_pulse(grid, peak_W=gn.soliton_peak_power(BETA2, gam, T0),
                       t0_s=T0)
    zper = 0.5 * np.pi * T0**2 / abs(BETA2)
    dz = zper / 100
    cfg_a = psa.custom_simulation_config(z_max=100 * dz, dz=dz, save_every=20,
                                         integrator="rk45", rtol=1e-7,
                                         atol=1e-10)
    z_a, A_a = gn.run_gnlse_simulation(cfg_a, co, A0)
    # n_steps=105 -> n_chunks=5, remainder=5: same saved grid, identical rows
    cfg_b = psa.custom_simulation_config(z_max=105 * dz, dz=dz, save_every=20,
                                         integrator="rk45", rtol=1e-7,
                                         atol=1e-10)
    z_b, A_b = gn.run_gnlse_simulation(cfg_b, co, A0)
    np.testing.assert_array_equal(z_b, z_a)
    np.testing.assert_array_equal(A_b, A_a)
    # n_chunks==0: runaway-gain blow-up confined to the (all-trailing) span
    cfg0 = psa.custom_simulation_config(z_max=5 * dz, dz=dz, save_every=20,
                                        integrator="rk45", rtol=1e-6,
                                        atol=1e-9)
    co_bad = gn.make_gnlse_coeffs(grid, None, gamma_W_m=1e-6, alpha_1_m=-2e9)
    with pytest.raises(FloatingPointError):
        gn.run_gnlse_simulation(cfg0, co_bad, A0)
    with pytest.raises(FloatingPointError):
        gn.run_gnlse_simulation(cfg0, co,
                                np.full(grid.n_samples, np.nan + 0j))
    # healthy n_chunks==0 run: row 0 only
    z0_, A0_out = gn.run_gnlse_simulation(cfg0, co, A0)
    assert z0_.shape == (1,) and A0_out.shape == (1, grid.n_samples)
    np.testing.assert_array_equal(A0_out[0], A0)


def test_nl_terms_validation():
    grid = _grid(64)
    with pytest.raises(ValueError, match="f_raman"):
        gn.make_nl_terms(grid, f_raman=1.0)
    with pytest.raises(ValueError, match="f_raman"):
        gn.make_nl_terms(grid, f_raman=-0.1)
    with pytest.raises(ValueError, match="omega0"):
        gn.make_nl_terms(grid, omega0=0.0)
    # raman_response normalization: discrete integral is exactly 1
    h = gn.raman_response(grid)
    assert h.sum() * grid.dt_s == pytest.approx(1.0, abs=1e-14)


def test_supercontinuum_soliton_fission():
    """Scaled-down Dudley PCF run (experiments.supercontinuum): an N~9
    soliton with beta2..7 + Raman + shock must undergo fission -- output
    -30 dB bandwidth at least 5x the input -- with bounded energy loss
    (Raman transfer only; no linear loss) and finite fields throughout.
    The full-size config reproduces the octave-spanning 507-1285 nm
    spectrum of Dudley et al. RMP 2006 Fig. 3 (run 2026-08-16, 122 s CPU)."""
    from psa_simulation_ode_rk_mvp_dispersion import experiments as ex

    z, A = ex.supercontinuum(n_samples=1024, window_ps=3.0, length_m=0.03,
                             rtol=1e-5, n_saved=20, show=False, verbose=False)
    assert np.all(np.isfinite(A))
    grid_dt = 3.0e-12 / 1024

    def bw(a):
        S = np.abs(np.fft.fft(a)) ** 2
        keep = np.fft.fftshift(S > S.max() * 1e-3)
        idx = np.nonzero(keep)[0]
        return idx[-1] - idx[0]

    assert bw(A[-1]) > 5 * bw(A[0])
    E = (np.abs(A) ** 2).sum(axis=-1) * grid_dt
    assert 0.7 < E[-1] / E[0] <= 1.0 + 1e-9  # Raman drain only, bounded


def test_batched_alpha_shared_phase():
    """alpha (B,) with a shared (T,) lin_phase — the documented independent
    shape combo — must broadcast per instance, not pair alpha_k with
    omega-bin k."""
    grid = _grid(64)
    B = 3
    alphas = np.array([0.0, 0.01, 0.05])
    co = gn.GNLSECoeffs(gamma=np.zeros(B), alpha=alphas,
                        lin_phase=np.asarray(
                            gn.make_gnlse_coeffs(grid, _disp(), gamma_W_m=0.0).lin_phase
                        ))
    cfg = psa.custom_simulation_config(z_max=10.0, dz=0.1, save_every=10)
    A0 = np.stack([np.asarray(gn.gaussian_pulse(grid, peak_W=1.0, t0_s=T0))] * B)
    pk, A_last, ok = gn.solve_gnlse_batch(cfg, co, A0)
    assert ok.all()
    E = gn.pulse_energy(grid, A_last)
    np.testing.assert_allclose(E / E[0], np.exp(-alphas * 10.0), rtol=1e-10)


def test_df32_dispatches_to_two_float_engine():
    """Since round 3 the GNLSE family HAS a two-float engine
    (ops/df32_gnlse.py): a df32 request dispatches instead of raising
    (combination guards live in tests/test_df32_gnlse.py; the jitted
    solver itself is opt-in -- XLA:CPU two-float compiles are
    pathological, CLAUDE.md constraint 4)."""
    import dataclasses as dc

    from psa_simulation_ode_rk_mvp_dispersion.models.gnlse import (
        TimeGrid, make_gnlse_coeffs)

    grid = TimeGrid(n_samples=64, t_window_s=10e-12)
    cf = make_gnlse_coeffs(grid, None, gamma_W_m=1e-3, precision="df32")
    # df32 coeffs keep host f64 leaves for the exact two-float split
    assert isinstance(cf.lin_phase, np.ndarray)
    assert cf.lin_phase.dtype == np.float64
    cfg = dc.replace(
        psa.custom_simulation_config(z_max=1.0, dz=0.1, save_every=1),
        precision="df32",
    )
    # rk45 has no two-float controller in this family: still a clear error
    with pytest.raises(ValueError, match="rk4"):
        psa.gnlse.solve_gnlse_batch(
            dc.replace(cfg, integrator="rk45"), cf, np.ones((1, 64), complex))


def test_batch_trajectories_match_single_runs():
    """solve_gnlse_batch_trajectories == stacked run_gnlse_simulation rows
    (fixed and adaptive), and the last row equals the reduce-mode A_last."""
    import dataclasses as dcl

    grid = gn.TimeGrid(n_samples=128, t_window_s=40e-12)
    disp = psa.DispersionParams.from_betas(1.2e15, beta2=-2e-26)
    co = gn.make_gnlse_coeffs(grid, disp, gamma_W_m=1e-2, alpha_1_m=5e-4)
    A0 = np.stack([
        gn.gaussian_pulse(grid, peak_W=p, t0_s=1e-12) for p in (0.5, 1.0)
    ])
    cfg = psa.custom_simulation_config(z_max=5.0, dz=0.01, save_every=100)

    z_b, A_b, ok_b = gn.solve_gnlse_batch_trajectories(cfg, co, A0)
    assert ok_b.all() and A_b.shape == (2, 6, 128)
    for i in range(2):
        z_s, A_s = gn.run_gnlse_simulation(cfg, co, A0[i])
        np.testing.assert_allclose(z_b, z_s, rtol=1e-12)
        assert np.array_equal(A_b[i], A_s)
    _pk, A_last, _ok = gn.solve_gnlse_batch(cfg, co, A0)
    assert np.array_equal(A_b[:, -1, :], A_last)

    # adaptive path agrees with the single-run adaptive trajectories
    cfg45 = dcl.replace(cfg, integrator="rk45", rtol=1e-8, atol=1e-11)
    z_b, A_b, ok_b = gn.solve_gnlse_batch_trajectories(cfg45, co, A0)
    assert ok_b.all()
    z_s, A_s = gn.run_gnlse_simulation(cfg45, co, A0[0])
    np.testing.assert_allclose(A_b[0], A_s, rtol=1e-6, atol=1e-10)


def test_batch_trajectories_sharded_matches_unsharded():
    z1, A1, ok1 = None, None, None
    grid = gn.TimeGrid(n_samples=64, t_window_s=40e-12)
    co = gn.make_gnlse_coeffs(grid, None, gamma_W_m=1e-3)
    A0 = np.stack([
        gn.gaussian_pulse(grid, peak_W=p, t0_s=1e-12)
        for p in np.linspace(0.3, 1.2, 5)     # pads over the 8-device mesh
    ])
    cfg = psa.custom_simulation_config(z_max=2.0, dz=0.01, save_every=50)
    z1, A1, ok1 = gn.solve_gnlse_batch_trajectories(cfg, co, A0)
    z2, A2, ok2 = gn.solve_gnlse_batch_trajectories(cfg, co, A0,
                                                    mesh=pm.default_mesh())
    assert np.array_equal(ok1, ok2)
    np.testing.assert_allclose(A2, A1, rtol=0, atol=1e-12)


def test_spectral_alpha_exact_frequency_dependent_loss():
    """Frequency-dependent loss (round 3): with gamma=0 and no dispersion
    the solve is exactly diagonal in omega -- every spectral bin must decay
    as exp(-alpha(omega) z), bin by bin."""
    grid = gn.TimeGrid(n_samples=128, t_window_s=20e-12)
    om = grid.omega()
    spec = 5e-3 * (om / np.abs(om).max()) ** 2      # band-edge loss profile
    co = gn.make_gnlse_coeffs(grid, None, gamma_W_m=0.0, alpha_1_m=2e-3,
                              alpha_spec_1_m=spec)
    A0 = gn.gaussian_pulse(grid, peak_W=1.0, t0_s=1e-12)
    cfg = psa.custom_simulation_config(z_max=100.0, dz=0.5, save_every=40)
    z, A = gn.run_gnlse_simulation(cfg, co, A0)
    S0 = np.fft.fft(A[0])
    S1 = np.fft.fft(A[-1])
    expected = S0 * np.exp(-0.5 * (2e-3 + spec) * z[-1])
    # atol floor relative to the spectral peak: empty tail bins carry only
    # f64 roundoff and have no meaningful relative error
    np.testing.assert_allclose(S1, expected, rtol=1e-10,
                               atol=1e-12 * np.abs(S0).max())

    # batch (B, T) spectral alpha: equals per-instance runs; sharded too
    co_b = gn.GNLSECoeffs(gamma=co.gamma, alpha=np.stack([
        np.asarray(co.alpha), np.asarray(co.alpha) * 2.0
    ]), lin_phase=co.lin_phase)
    A0b = np.stack([A0, A0])
    pk, A_last, ok = gn.solve_gnlse_batch(cfg, co_b, A0b)
    assert ok.all()
    pk_s, A_last_s, ok_s = gn.solve_gnlse_batch(cfg, co_b, A0b,
                                                mesh=pm.default_mesh())
    np.testing.assert_allclose(A_last_s, A_last, rtol=0, atol=1e-12)
    # lane 1 decays twice as fast in every bin
    S_l1 = np.fft.fft(A_last[1])
    exp1 = np.fft.fft(A0) * np.exp(-0.5 * 2.0 * (2e-3 + spec) * z[-1])
    np.testing.assert_allclose(S_l1, exp1, rtol=1e-9,
                               atol=1e-12 * np.abs(exp1).max())


def test_spectral_alpha_validation():
    grid = gn.TimeGrid(n_samples=64, t_window_s=20e-12)
    with pytest.raises(ValueError, match="alpha_spec"):
        gn.make_gnlse_coeffs(grid, None, gamma_W_m=0.0,
                             alpha_spec_1_m=np.zeros(32))
    with pytest.raises(ValueError, match="finite"):
        gn.make_gnlse_coeffs(grid, None, gamma_W_m=0.0,
                             alpha_spec_1_m=np.full(64, np.nan))
