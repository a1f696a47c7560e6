"""Adams multistep integrators (ab4 / abm4): order, save-grid contract,
NaN-freeze semantics, and the comb engine wiring.

The multistep path exists for throughput (1-2 RHS evals/step vs RK4's
4 -- the RHS evaluation is the cost); these tests pin the numerics
on CPU x64: 4th-order convergence, trajectory agreement with RK4 far below
the x32 rounding floor, and the exact reference save-decimation contract
(row 0 + every save_every-th step; trailing partial steps integrated but
unsaved) for every bootstrap/save_every alignment.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from psa_simulation_ode_rk_mvp_dispersion.ops.integrators import (
    integrate_fixed_grid,
    integrate_reduce,
)


# ---------------------------------------------------------------------------
# Oracle: plain-numpy AB4/ABM4 with RK4 bootstrap (independent op order)
# ---------------------------------------------------------------------------

def _np_rk4_step(f, z, y, h):
    k1 = f(z, y)
    k2 = f(z + 0.5 * h, y + 0.5 * h * k1)
    k3 = f(z + 0.5 * h, y + 0.5 * h * k2)
    k4 = f(z + h, y + h * k3)
    return y + (h / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)


def _np_ms(f, y0, h, n_steps, save_every, correct):
    y = np.asarray(y0, dtype=complex)
    rows = [y.copy()]
    hist = []
    for step in range(n_steps):
        z = step * h
        if step < 3:
            hist.append(f(z, y))
            y = _np_rk4_step(f, z, y, h)
        else:
            f0 = f(z, y)
            yp = y + (h / 24.0) * (
                55 * f0 - 59 * hist[-1] + 37 * hist[-2] - 9 * hist[-3]
            )
            if correct:
                fp = f(z + h, yp)
                y = y + (h / 24.0) * (9 * fp + 19 * f0 - 5 * hist[-1] + hist[-2])
            else:
                y = yp
            hist.append(f0)
        if (step + 1) % save_every == 0:
            rows.append(y.copy())
    return np.stack(rows[: n_steps // save_every + 1]), y


# Stiff-ish nonlinear test problem: damped rotation + cubic self-coupling
def _rhs_np(z, y):
    return (0.3j - 0.05) * y + 0.2j * y * np.abs(y) ** 2


def _rhs_jax(z, y, params):
    return (0.3j - 0.05) * y + 0.2j * y * jnp.abs(y) ** 2


Y0 = np.array([1.0 + 0.2j, 0.5 - 0.1j, -0.3 + 0.8j])


@pytest.mark.parametrize("method", ["ab4", "abm4"])
def test_fourth_order_convergence(method):
    """Halving dz must shrink the error ~16x (order 4)."""
    z_end = 2.0
    ref = integrate_fixed_grid(
        _rhs_jax, Y0, None, z0=0.0, dz=z_end / 4096, n_steps=4096,
        save_every=4096, method="rk4",
    ).y_final
    errs = []
    for n in (64, 128, 256):
        res = integrate_fixed_grid(
            _rhs_jax, Y0, None, z0=0.0, dz=z_end / n, n_steps=n,
            save_every=n, method=method,
        )
        errs.append(float(np.max(np.abs(np.asarray(res.y_final) - np.asarray(ref)))))
    r1 = errs[0] / errs[1]
    r2 = errs[1] / errs[2]
    assert 10.0 < r1 < 24.0, (errs, r1)
    assert 10.0 < r2 < 24.0, (errs, r2)


@pytest.mark.parametrize("method", ["ab4", "abm4"])
def test_close_to_rk4(method):
    """At a well-resolved dz the Adams trajectory matches RK4 to ~truncation
    (far below x32 rounding)."""
    n = 500
    kw = dict(z0=0.0, dz=2.0 / n, n_steps=n, save_every=50)
    a = integrate_fixed_grid(_rhs_jax, Y0, None, method=method, **kw)
    r = integrate_fixed_grid(_rhs_jax, Y0, None, method="rk4", **kw)
    assert np.allclose(np.asarray(a.y_final), np.asarray(r.y_final),
                       rtol=1e-9, atol=1e-12)
    assert np.allclose(np.asarray(a.y_saved), np.asarray(r.y_saved),
                       rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("method,correct", [("ab4", False), ("abm4", True)])
@pytest.mark.parametrize("n_steps,save_every", [
    (0, 1), (1, 1), (2, 1), (3, 1), (3, 2), (4, 1), (4, 2), (4, 4), (5, 5),
    (7, 2), (7, 3), (7, 5), (10, 2), (10, 3), (12, 4), (13, 5), (9, 100),
])
def test_save_grid_contract_vs_oracle(method, correct, n_steps, save_every):
    """Exact agreement with an independent numpy implementation of the same
    scheme across every bootstrap/save_every alignment (rows, z grid,
    y_final with trailing unsaved steps)."""
    h = 0.05
    res = integrate_fixed_grid(
        _rhs_jax, Y0, None, z0=0.0, dz=h, n_steps=n_steps,
        save_every=save_every, method=method,
    )
    rows_np, y_fin_np = _np_ms(_rhs_np, Y0, h, n_steps, save_every, correct)
    assert res.y_saved.shape == rows_np.shape
    np.testing.assert_allclose(np.asarray(res.y_saved), rows_np,
                               rtol=1e-13, atol=1e-15)
    np.testing.assert_allclose(np.asarray(res.y_final), y_fin_np,
                               rtol=1e-13, atol=1e-15)
    np.testing.assert_allclose(
        np.asarray(res.z_saved),
        np.arange(n_steps // save_every + 1) * save_every * h,
        rtol=1e-13,
    )


@pytest.mark.parametrize("method", ["ab4", "abm4"])
def test_reduce_matches_fixed_grid(method):
    """Reduce-mode saved-sample folds see exactly the trajectory rows."""
    n, se = 23, 4
    kw = dict(z0=0.0, dz=0.05, n_steps=n, save_every=se)
    grid = integrate_fixed_grid(_rhs_jax, Y0, None, method=method, **kw)

    def red(acc, y):
        count, pmax = acc
        return count + 1, jnp.maximum(pmax, jnp.abs(y))

    r = integrate_reduce(
        _rhs_jax, Y0, None, reduce_init=(0, jnp.zeros(3)), reduce_fn=red,
        method=method, **kw,
    )
    count, pmax = r.reduction
    assert int(count) == n // se + 1
    np.testing.assert_allclose(
        np.asarray(pmax),
        np.max(np.abs(np.asarray(grid.y_saved)), axis=0), rtol=1e-13,
    )
    np.testing.assert_allclose(np.asarray(r.y_final),
                               np.asarray(grid.y_final), rtol=1e-13)
    assert bool(r.ok) and int(r.bad_step) == -1


@pytest.mark.parametrize("method", ["ab4", "abm4"])
def test_nan_freeze(method):
    """A blow-up freezes the state at the last good step and records the
    first bad index (same contract as the RK4 path)."""

    def rhs(z, y, params):
        # finite-time blow-up: y' = y^2 from y=1 diverges at z=1
        return y * y

    y0 = jnp.asarray([1.0])
    res = integrate_fixed_grid(
        rhs, y0, None, z0=0.0, dz=0.5, n_steps=40, save_every=40,
        method=method,
    )
    assert not bool(res.ok)
    assert int(res.bad_step) >= 0
    assert np.all(np.isfinite(np.asarray(res.y_final)))


def test_bad_method_raises():
    with pytest.raises(ValueError, match="method"):
        integrate_fixed_grid(
            _rhs_jax, Y0, None, z0=0.0, dz=0.1, n_steps=4, save_every=1,
            method="euler",
        )


# ---------------------------------------------------------------------------
# Comb engine wiring + family guards
# ---------------------------------------------------------------------------

def _comb_setup(B=3):
    import psa
    from psa_simulation_ode_rk_mvp_dispersion.models import nwave as nw

    omega_c = 2.0 * np.pi * 193.1e12
    grid = nw.CombGrid.centered(omega_c, 2.0 * np.pi * 50e9, 16)
    disp = psa.DispersionParams.from_betas(omega_c, beta2=-1.0e-27)
    c1 = nw.make_comb_coeffs(grid, disp, gamma_W_m=10e-3, alpha_1_m=5e-5,
                             precision="x64")
    A0 = nw.seed_comb(grid, pump_lines={6: 0.4, 10: 0.4},
                      noise_floor_W=1e-9, seed=1)
    coeffs = nw.NWaveCoeffs(
        gamma=np.linspace(8e-3, 12e-3, B), alpha=np.full(B, 5e-5),
        beta_lin=np.broadcast_to(np.asarray(c1.beta_lin, float), (B, 16)),
    )
    return nw, np.broadcast_to(A0, (B, 16)).copy(), coeffs


@pytest.mark.parametrize("integrator", ["ab4", "abm4"])
def test_comb_batch_multistep_matches_rk4(integrator):
    import psa

    nw, A0, coeffs = _comb_setup()
    kw = dict(z_max=200.0, dz=0.5, save_every=25, precision="x64")
    cfg4 = psa.custom_simulation_config(**kw)
    cfgm = psa.custom_simulation_config(integrator=integrator, **kw)
    P4, A4, ok4 = nw.solve_comb_batch(cfg4, coeffs, A0, coupling="dft")
    Pm, Am, okm = nw.solve_comb_batch(cfgm, coeffs, A0, coupling="dft")
    assert ok4.all() and okm.all()
    np.testing.assert_allclose(Am, A4, rtol=1e-6, atol=1e-12)
    np.testing.assert_allclose(Pm, P4, rtol=1e-6, atol=1e-12)


def test_comb_trajectories_multistep():
    import psa

    nw, A0, coeffs = _comb_setup()
    kw = dict(z_max=100.0, dz=0.5, save_every=20, precision="x64")
    z4, A4, ok4 = nw.solve_comb_batch_trajectories(
        psa.custom_simulation_config(**kw), coeffs, A0)
    zm, Am, okm = nw.solve_comb_batch_trajectories(
        psa.custom_simulation_config(integrator="abm4", **kw), coeffs, A0)
    assert ok4.all() and okm.all()
    np.testing.assert_allclose(zm, z4)
    np.testing.assert_allclose(Am, A4, rtol=1e-7, atol=1e-12)


def test_run_comb_simulation_multistep():
    import psa

    nw, A0, coeffs = _comb_setup(B=1)
    from psa_simulation_ode_rk_mvp_dispersion.models.nwave import NWaveCoeffs
    c1 = NWaveCoeffs(gamma=10e-3, alpha=5e-5,
                     beta_lin=np.asarray(coeffs.beta_lin[0]))
    kw = dict(z_max=100.0, dz=0.5, save_every=20, precision="x64")
    z4, A4 = nw.run_comb_simulation(psa.custom_simulation_config(**kw), c1, A0[0])
    za, Aa = nw.run_comb_simulation(
        psa.custom_simulation_config(integrator="ab4", **kw), c1, A0[0])
    np.testing.assert_allclose(za, z4)
    np.testing.assert_allclose(Aa, A4, rtol=1e-6, atol=1e-12)


def test_unsupported_families_raise():
    """Families without a multistep path refuse loudly (no silent rk4)."""
    import psa

    from psa_simulation_ode_rk_mvp_dispersion.models.gnlse import (
        run_gnlse_simulation, make_gnlse_coeffs, TimeGrid,
    )
    tg = TimeGrid(n_samples=64, t_window_s=64e-13)
    co = make_gnlse_coeffs(tg, gamma_W_m=1e-3, precision="x64")
    with pytest.raises(ValueError, match="multistep|ab4"):
        run_gnlse_simulation(
            psa.custom_simulation_config(z_max=1.0, dz=0.1, integrator="ab4"),
            co, np.ones(64, complex),
        )


def test_df32_and_pallas_engines_reject_multistep():
    import psa

    nw, A0, coeffs = _comb_setup()
    cfg = psa.custom_simulation_config(
        z_max=10.0, dz=0.5, save_every=5, precision="df32", integrator="ab4")
    with pytest.raises(ValueError, match="rk4"):
        nw.solve_comb_batch(cfg, coeffs, A0)


# ---------------------------------------------------------------------------
# Adams comb solves: the fft and dft couplings agree at x32
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("integrator", ["ab4", "abm4"])
@pytest.mark.parametrize("save_every", [20, 3, 1])
def test_comb_multistep_couplings_agree(integrator, save_every):
    """Adams comb solves with the fft and dft couplings agree (x32) across
    bootstrap/save alignments, incl. boundaries inside the 3-step RK4
    bootstrap."""
    import psa

    nw, A0, coeffs = _comb_setup(B=5)
    kw = dict(z_max=30.0, dz=0.5, save_every=save_every, precision="x32")
    cfg = psa.custom_simulation_config(integrator=integrator, **kw)
    P1, A1, ok1 = nw.solve_comb_batch(cfg, coeffs, A0, coupling="dft")
    P2, A2, ok2 = nw.solve_comb_batch(cfg, coeffs, A0, coupling="fft")
    assert ok1.all() and ok2.all()
    np.testing.assert_allclose(A2, A1, rtol=2e-5, atol=1e-7)
    np.testing.assert_allclose(P2, P1, rtol=2e-5, atol=1e-7)


def test_comb_multistep_trailing_remainder():
    """Trailing partial steps: integrated but unsaved -- A_final is the last
    saved row of the trajectory solve."""
    import psa

    nw, A0, coeffs = _comb_setup(B=3)
    # 47 steps, save_every=10 -> 7 trailing unsaved steps
    kw = dict(z_max=23.5, dz=0.5, save_every=10, precision="x32",
              integrator="abm4")
    cfg = psa.custom_simulation_config(**kw)
    P1, A1, ok1 = nw.solve_comb_batch(cfg, coeffs, A0, coupling="dft")
    _z, At, okt = nw.solve_comb_batch_trajectories(cfg, coeffs, A0,
                                                   coupling="dft")
    assert ok1.all() and okt.all()
    np.testing.assert_allclose(A1, At[:, -1], rtol=2e-5, atol=1e-7)
    np.testing.assert_allclose(P1, np.max(np.abs(At) ** 2, axis=1),
                               rtol=2e-5, atol=1e-7)


def test_comb_multistep_nan_freeze():
    """A blown-up lane freezes + masks identically under both couplings."""
    import psa

    nw, A0, coeffs = _comb_setup(B=4)
    gamma = np.asarray(coeffs.gamma).copy()
    gamma[2] = 1e6          # drive lane 2 to blow up
    bad = nw.NWaveCoeffs(gamma=gamma, alpha=coeffs.alpha,
                         beta_lin=coeffs.beta_lin)
    cfg = psa.custom_simulation_config(
        z_max=30.0, dz=0.5, save_every=10, precision="x32", integrator="ab4")
    P1, A1, ok1 = nw.solve_comb_batch(cfg, bad, A0, coupling="dft")
    P2, A2, ok2 = nw.solve_comb_batch(cfg, bad, A0, coupling="fft")
    np.testing.assert_array_equal(ok2, ok1)
    assert not ok1[2] and ok1[[0, 1, 3]].all()
    np.testing.assert_allclose(A2[ok1], A1[ok1], rtol=2e-5, atol=1e-7)


# ---------------------------------------------------------------------------
# 4-wave family wiring (runner, sweeps, df32 engines)
# ---------------------------------------------------------------------------

def _fwm_kwargs():
    import psa

    omega = np.asarray(psa.plan_from_wavelengths(1550e-9, 1560e-9, 1555e-9))
    return dict(
        gamma=0.0115, alpha=2e-4, omega=omega,
        p_in=np.array([0.5, 0.5, 1e-5, 1e-5]), phase_in=np.zeros(4),
        beta_legacy=[0.0, 0.0, 1e-3, -2e-3], length_unit="m",
    )


@pytest.mark.parametrize("integrator", ["ab4", "abm4"])
def test_run_single_simulation_multistep_vs_oracle(integrator):
    """Runner Adams trajectory == the independent numpy oracle of the same
    scheme on the 4-wave lab-frame RHS (save contract included)."""
    import psa
    from psa_simulation_ode_rk_mvp_dispersion.ops.rhs import (
        RHSCoeffs, rhs_yaman,
    )

    kw = _fwm_kwargs()
    dz, n_steps, save_every = 0.05, 40, 7
    cfg = psa.custom_simulation_config(
        z_max=dz * n_steps, dz=dz, save_every=save_every,
        integrator=integrator,
    )
    z, A = psa.run_single_simulation(cfg, frame="lab", **kw)

    b = kw["beta_legacy"]
    dbeta = (b[2] + b[3]) - (b[0] + b[1])
    co = RHSCoeffs(gamma=jnp.asarray(kw["gamma"]),
                   alpha=jnp.asarray(kw["alpha"]),
                   delta_beta=jnp.asarray(dbeta))

    def f(zz, y):
        return np.asarray(rhs_yaman(jnp.asarray(zz), jnp.asarray(y), co))

    A0 = np.sqrt(kw["p_in"]).astype(complex)
    rows, _yfin = _np_ms(f, A0, dz, n_steps, save_every,
                         integrator == "abm4")
    assert A.shape == rows.shape
    np.testing.assert_allclose(A, rows, rtol=1e-11, atol=1e-14)
    np.testing.assert_allclose(
        z, np.arange(n_steps // save_every + 1) * save_every * dz, rtol=1e-13)


@pytest.mark.parametrize("integrator", ["ab4", "abm4"])
def test_solve_batch_multistep_matches_trajectories(integrator):
    """Reduce-mode Adams summaries == trajectory-mode Adams rows, and both
    frames agree (powers are frame-invariant)."""
    import psa
    from psa_simulation_ode_rk_mvp_dispersion.parallel import sweep as sw
    from psa_simulation_ode_rk_mvp_dispersion.ops.rhs import RHSCoeffs

    cfg = psa.custom_simulation_config(
        z_max=50.0, dz=0.1, save_every=10, integrator=integrator)
    B = 5
    rng = np.random.default_rng(3)
    coeffs = RHSCoeffs(
        gamma=np.full(B, 0.01), alpha=np.full(B, 1e-4),
        delta_beta=rng.uniform(-0.5, 0.5, B),
    )
    A0 = (np.sqrt(np.array([0.3, 0.3, 1e-5, 0.0]))[None, :]
          * np.ones((B, 1))).astype(np.complex128)
    z, A, ok = sw.solve_batch_trajectories(cfg, coeffs, A0, frame="lab")
    assert ok.all()
    res = sw.solve_batch(cfg, coeffs, A0, frame="lab")
    np.testing.assert_allclose(
        res.P_max, np.max(np.abs(A) ** 2, axis=1), rtol=1e-12)
    np.testing.assert_allclose(res.A_end, A[:, -1], rtol=1e-12)
    rot = sw.solve_batch(cfg, coeffs, A0, frame="rotating")
    # frame equivalence holds for the exact ODE, not the discrete stepper:
    # the two frames integrate different (equivalent) equations, so at
    # fixed dz their trajectories agree only to truncation/rounding --
    # ~1e-15 absolute here, which on a ~1e-8 W idler is ~1e-7 relative.
    np.testing.assert_allclose(rot.P_max, res.P_max, rtol=1e-9, atol=1e-13)


def test_gain_spectrum_multistep_close_to_rk4():
    """Public sweep with integrator='ab4': same gains to ~truncation (the
    Adams trajectory is a different 4th-order approximation, not rk4)."""
    import psa
    from psa_simulation_ode_rk_mvp_dispersion.parallel import sweep as sw

    lam3 = np.linspace(1548e-9, 1562e-9, 9)
    disp = psa.dispersion_params_from_D_S(
        lambda_ref_m=1552.5e-9, D=0.5, S=0.02, dSdlmbd=0,
        D_units="ps/nm/km", S_units="ps/nm^2/km", dSdlmbd_units="ps/nm^3/km",
    )
    kw = dict(
        lambda_p1_m=1550e-9, lambda_p2_m=1555e-9, lambda_signal_m=lam3,
        gamma=11.5e-3, alpha=1e-4, p_in=np.array([0.5, 0.5, 1e-7, 1e-7]),
        phase_in=np.zeros(4), dispersion=disp, length_unit="m",
    )
    g4 = sw.gain_spectrum(
        cfg=psa.custom_simulation_config(z_max=50.0, dz=0.2), **kw)
    ga = sw.gain_spectrum(
        cfg=psa.custom_simulation_config(z_max=50.0, dz=0.2,
                                         integrator="ab4"), **kw)
    assert ga.ok.all()
    np.testing.assert_allclose(ga.gain, g4.gain, rtol=1e-7, atol=1e-7)


def test_df32_eager_ab4_steps_match_f64_ab4():
    """Eager (scan-free) df32 Adams steps vs an f64 NumPy implementation of
    the same scheme -- the CPU-runnable validation of the df32 multistep
    path (the jitted df32 solver is opt-in, CLAUDE.md #4)."""
    from psa_simulation_ode_rk_mvp_dispersion.ops import df32_solver as dfs
    from psa_simulation_ode_rk_mvp_dispersion.ops import twofloat as tfm

    gamma, alpha, dbeta, dz = 1.5, 0.02, 0.8, 0.05
    A0 = np.sqrt(np.array([0.3, 0.25, 1e-4, 0.0])).astype(np.complex128)

    def rhs64(a):
        P = np.abs(a) ** 2
        F = 2 * P.sum() - P
        s34, s12 = a[2] * a[3], a[0] * a[1]
        fwm = 2j * gamma * np.array(
            [np.conj(a[1]) * s34, np.conj(a[0]) * s34,
             np.conj(a[3]) * s12, np.conj(a[2]) * s12])
        det = -0.5j * dbeta * np.array([a[0], a[1], 0, 0])
        return -0.5 * alpha * a + 1j * gamma * F * a + fwm + det

    # f64: 3 RK4 bootstrap steps + 3 AB4 + 3 ABM4 continuation
    y64 = A0.copy()
    hist = []
    for _ in range(3):
        k1 = rhs64(y64)
        hist.append(k1)
        k2 = rhs64(y64 + 0.5 * dz * k1)
        k3 = rhs64(y64 + 0.5 * dz * k2)
        k4 = rhs64(y64 + dz * k3)
        y64 = y64 + (dz / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)
    y64_ab = y64.copy()
    h_ab = list(hist)
    for _ in range(3):
        f0 = rhs64(y64_ab)
        y64_ab = y64_ab + (dz / 24.0) * (
            55 * f0 - 59 * h_ab[-1] + 37 * h_ab[-2] - 9 * h_ab[-3])
        h_ab.append(f0)
    y64_abm = y64.copy()
    h_am = list(hist)
    for _ in range(3):
        f0 = rhs64(y64_abm)
        yp = y64_abm + (dz / 24.0) * (
            55 * f0 - 59 * h_am[-1] + 37 * h_am[-2] - 9 * h_am[-3])
        fp = rhs64(yp)
        y64_abm = y64_abm + (dz / 24.0) * (
            9 * fp + 19 * f0 - 5 * h_am[-1] + h_am[-2])
        h_am.append(f0)

    c = dfs.make_df32_coeffs(np.float64(gamma), np.float64(alpha),
                             np.float64(dbeta))
    consts = dfs.make_step_consts(dz)
    adams = dfs.make_adams_consts(dz)
    y = tfm.ctf_from_c128(A0)
    fs = []
    for _ in range(3):
        fs.append(dfs.rhs4_df32(y, c))
        y = dfs.rk4_step_df32(y, consts, c)

    for correct, ref in ((False, y64_ab), (True, y64_abm)):
        yy, hh = y, list(fs)
        for _ in range(3):
            yy, f0 = dfs.ab4_step_df32(yy, hh[-1], hh[-2], hh[-3], adams, c,
                                       correct=correct)
            hh.append(f0)
        got = tfm.ctf_to_c128(yy)
        rel = np.max(np.abs(got - ref) / np.maximum(np.abs(ref), 1e-20))
        assert rel < 1e-12, (correct, rel)
