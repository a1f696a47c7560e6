"""N-wave cascaded FWM comb model tests: FFT coupling vs direct cubic sum,
analytic SPM limit, conservation laws, 4-wave correspondence, rk45 path,
batching."""

import jax
import numpy as np
import jax.numpy as jnp
import pytest

import psa
from psa_simulation_ode_rk_mvp_dispersion.models import nwave as nw
from psa_simulation_ode_rk_mvp_dispersion.ops.dispersion import DispersionParams


def _rand_state(n, b=None, seed=0):
    rng = np.random.default_rng(seed)
    shape = (n,) if b is None else (b, n)
    return rng.normal(size=shape) * 0.3 + 1j * rng.normal(size=shape) * 0.3


@pytest.mark.parametrize("n", [1, 2, 3, 5, 8, 16])
def test_fft_polarization_matches_direct(n):
    a = jnp.asarray(_rand_state(n))
    T_fft = np.asarray(nw.fwm_polarization(a))
    T_dir = np.asarray(nw.fwm_polarization_direct(a))
    np.testing.assert_allclose(T_fft, T_dir, rtol=1e-11, atol=1e-12)


def test_fft_polarization_batched():
    a = jnp.asarray(_rand_state(6, b=4))
    T = np.asarray(nw.fwm_polarization(a))
    for i in range(4):
        np.testing.assert_allclose(
            T[i], np.asarray(nw.fwm_polarization(a[i])), rtol=1e-12
        )


def test_single_line_is_analytic_spm():
    """N=1 comb: dA/dz = (-alpha/2 + i beta + i gamma |A|^2) A with constant
    |A| decay -> closed form via the exponential-loss phase integral."""
    gamma, alpha, beta = 2.0, 0.3, 5.0
    P0 = 0.8
    coeffs = nw.NWaveCoeffs(
        gamma=jnp.asarray(gamma), alpha=jnp.asarray(alpha),
        beta_lin=jnp.asarray([beta]),
    )
    cfg = psa.custom_simulation_config(z_max=1.0, dz=1e-3, save_every=1000)
    z, A = nw.run_comb_simulation(cfg, coeffs, np.array([np.sqrt(P0) + 0j]))
    L = 1.0
    # |A|^2 = P0 e^{-alpha z}; phase = beta z + gamma P0 (1-e^{-alpha z})/alpha
    P_end = P0 * np.exp(-alpha * L)
    phi_end = beta * L + gamma * P0 * (1 - np.exp(-alpha * L)) / alpha
    expected = np.sqrt(P_end) * np.exp(1j * phi_end)
    np.testing.assert_allclose(A[-1, 0], expected, rtol=1e-9)


def test_comb_power_conservation_lossless():
    """The cubic coupling conserves total power exactly; RK4 to ~1e-9."""
    n = 32
    grid = nw.CombGrid.centered(1.2e15, 2 * np.pi * 100e9, n)
    disp = DispersionParams.from_betas(1.2e15, beta2=-2e-26, beta4=1e-52)
    coeffs = nw.make_comb_coeffs(grid, disp, gamma_W_m=10.0, alpha_1_m=0.0)
    A0 = nw.seed_comb(grid, pump_lines={n // 2: 0.5, n // 2 + 1: 0.5},
                      noise_floor_W=1e-9, seed=1)
    cfg = psa.custom_simulation_config(z_max=5.0, dz=1e-3, save_every=500)
    z, A = nw.run_comb_simulation(cfg, coeffs, A0)
    P_tot = np.sum(np.abs(A) ** 2, axis=1)
    np.testing.assert_allclose(P_tot, P_tot[0], rtol=3e-8)
    # cascade actually populated new lines
    P_end = np.abs(A[-1]) ** 2
    side = np.delete(P_end, [n // 2, n // 2 + 1])
    assert side.max() > 100 * 1e-9


def test_comb_reduces_to_4wave_model_when_other_lines_detuned():
    """Rigorous correspondence: give the four active lines beta=0 (phase
    matched) and every other comb line a huge detuning (|beta| ~ 1e4 1/m).
    All mixing products touching a detuned line average out (amplitude
    ~ gamma*P/|beta| ~ 1e-5), so the comb reduces exactly to the truncated
    4-wave model -- and the two must agree to high accuracy.

    (An *un*-detuned comb legitimately differs from the 4-wave truncation:
    Bragg-scattering products of the same perturbative order drain the signal;
    verified separately by test_comb_power_conservation_lossless.)"""
    n = 23
    domega = 2 * np.pi * 200e9
    oc = 1.215e15
    grid = nw.CombGrid.centered(oc, domega, n)
    gamma, alpha = 2.0, 0.0
    i_p1, i_p2, i_s = 10, 12, 9
    i_i = i_p1 + i_p2 - i_s  # 13
    active = {i_p1, i_p2, i_s, i_i}
    Pp, Ps = 0.05, 1e-6
    # detuning magnitude: large enough to suppress unwanted products
    # (second-order gain corrections scale as 1/beta^2), small enough that
    # RK4 stays stable (|beta| dz = 0.2 rad/step)
    beta = np.array(
        [0.0 if j in active else 2000.0 * (1 if j % 2 else -1) for j in range(n)]
    )
    coeffs = nw.NWaveCoeffs(
        gamma=jnp.asarray(gamma), alpha=jnp.asarray(alpha),
        beta_lin=jnp.asarray(beta),
    )
    A0 = nw.seed_comb(grid, pump_lines={i_p1: Pp, i_p2: Pp, i_s: Ps})
    cfg = psa.custom_simulation_config(z_max=20.0, dz=1e-4, save_every=200000)
    z, A = nw.run_comb_simulation(cfg, coeffs, A0)
    comb_gain = np.abs(A[-1, i_s]) ** 2 / Ps

    om = grid.omegas()
    omega4 = np.array([om[i_p1], om[i_p2], om[i_s], om[i_i]])
    pm = psa.PhaseMatchingConfig(
        method=psa.PhaseMatchingMethod.PROVIDED, provided_delta_beta=0.0
    )
    z4, A4 = psa.run_single_simulation(
        psa.custom_simulation_config(z_max=20.0, dz=5e-3),
        gamma=gamma, alpha=alpha, omega=omega4,
        p_in=[Pp, Pp, Ps, 0.0], phase_matching_cfg=pm, length_unit="m",
    )
    gain4 = np.abs(A4[-1, 2]) ** 2 / Ps
    assert gain4 > 10.0  # substantial parametric gain in this regime
    assert comb_gain == pytest.approx(gain4, rel=1e-3)


def test_remove_linear_gauge_invariance():
    """Removing beta0/beta1 must leave all line powers unchanged."""
    n = 16
    grid = nw.CombGrid.centered(1.2e15, 2 * np.pi * 100e9, n)
    # beta1 chosen so beta1*dw stays integrable without the gauge reduction
    # (the whole point of remove_linear is that realistic beta1 values make
    # the un-reduced system impossibly stiff)
    disp = DispersionParams.from_betas(
        1.2e15, beta0=100.0, beta1=1e-13, beta2=-2e-26
    )
    A0 = nw.seed_comb(grid, pump_lines={7: 0.3, 9: 0.3, 6: 1e-5})
    # converged (adaptive, tight-tolerance) solutions: the two gauges are
    # different discretizations of the same physics, so only the converged
    # powers match tightly
    cfg = psa.custom_simulation_config(
        z_max=2.0, dz=1e-3, save_every=2000, integrator="rk45",
        rtol=1e-11, atol=1e-16,
    )
    outs = []
    for rl in (True, False):
        coeffs = nw.make_comb_coeffs(
            grid, disp, gamma_W_m=5.0, remove_linear=rl
        )
        z, A = nw.run_comb_simulation(cfg, coeffs, A0)
        outs.append(np.abs(A[-1]) ** 2)
    np.testing.assert_allclose(outs[0], outs[1], rtol=1e-6, atol=1e-18)


def test_comb_rk45_matches_rk4():
    n = 16
    grid = nw.CombGrid.centered(1.2e15, 2 * np.pi * 100e9, n)
    disp = DispersionParams.from_betas(1.2e15, beta2=-2e-26)
    coeffs = nw.make_comb_coeffs(grid, disp, gamma_W_m=10.0, alpha_1_m=0.01)
    A0 = nw.seed_comb(grid, pump_lines={7: 0.4, 9: 0.4}, noise_floor_W=1e-10)
    cfg4 = psa.custom_simulation_config(z_max=2.0, dz=2e-4, save_every=2500)
    z4, A4 = nw.run_comb_simulation(cfg4, coeffs, A0)
    cfg45 = psa.custom_simulation_config(
        z_max=2.0, dz=2e-4, save_every=2500, integrator="rk45",
        rtol=1e-10, atol=1e-14,
    )
    z45, A45 = nw.run_comb_simulation(cfg45, coeffs, A0)
    np.testing.assert_allclose(z45, z4, rtol=1e-12)
    np.testing.assert_allclose(A45[-1], A4[-1], rtol=1e-6, atol=1e-12)


def test_comb_vmap_batch():
    """Batch of combs with different gamma under vmap matches singles."""
    n = 12
    grid = nw.CombGrid.centered(1.2e15, 2 * np.pi * 100e9, n)
    disp = DispersionParams.from_betas(1.2e15, beta2=-2e-26)
    A0 = jnp.asarray(
        np.stack([nw.seed_comb(grid, pump_lines={5: 0.3, 7: 0.3})] * 3)
    )
    gammas = jnp.asarray([1.0, 5.0, 10.0])
    beta = jnp.asarray(nw.comb_beta_lin(grid, disp))

    def solve(y0, g):
        coeffs = nw.NWaveCoeffs(gamma=g, alpha=jnp.asarray(0.0), beta_lin=beta)
        from psa_simulation_ode_rk_mvp_dispersion.ops.integrators import (
            integrate_fixed_grid,
        )

        return integrate_fixed_grid(
            nw.rhs_nwave, y0, coeffs, z0=0.0, dz=1e-3, n_steps=500,
            save_every=500,
        ).y_final

    batched = jax.vmap(solve)(A0, gammas)
    for i in range(3):
        np.testing.assert_allclose(
            np.asarray(batched[i]), np.asarray(solve(A0[i], gammas[i])), rtol=1e-12
        )


def test_seed_comb_validation():
    grid = nw.CombGrid.centered(1.2e15, 2 * np.pi * 100e9, 8)
    with pytest.raises(ValueError, match="outside"):
        nw.seed_comb(grid, pump_lines={9: 0.1})
    with pytest.raises(ValueError, match=">= 0"):
        nw.seed_comb(grid, pump_lines={2: -0.1})
    A0 = nw.seed_comb(grid, pump_lines={2: (0.25, np.pi / 2)})
    assert A0[2] == pytest.approx(0.5j)


def test_solve_comb_batch_matches_singles_and_shards():
    """Batched comb solves match per-comb runs; sharding over the 8-device
    mesh reproduces the unsharded result."""
    import jax
    from psa_simulation_ode_rk_mvp_dispersion.parallel.mesh import default_mesh

    n = 16
    grid = nw.CombGrid.centered(1.2e15, 2 * np.pi * 100e9, n)
    disp = DispersionParams.from_betas(1.2e15, beta2=-2e-26)
    beta = nw.comb_beta_lin(grid, disp)
    B = 5
    gammas = np.linspace(2.0, 10.0, B)
    A0 = np.stack([nw.seed_comb(grid, pump_lines={7: 0.3, 9: 0.3},
                                noise_floor_W=1e-10, seed=s) for s in range(B)])
    coeffs = nw.NWaveCoeffs(
        gamma=jnp.asarray(gammas), alpha=jnp.asarray(np.zeros(B)),
        beta_lin=jnp.asarray(np.broadcast_to(beta, (B, n))),
    )
    cfg = psa.custom_simulation_config(z_max=1.0, dz=1e-3, save_every=100)
    P_max, A_fin, ok = nw.solve_comb_batch(cfg, coeffs, A0)
    assert P_max.shape == (B, n) and ok.all()
    # per-comb cross-check
    for i in (0, B - 1):
        ci = nw.NWaveCoeffs(gamma=jnp.asarray(gammas[i]), alpha=jnp.asarray(0.0),
                            beta_lin=jnp.asarray(beta))
        z, A = nw.run_comb_simulation(cfg, ci, A0[i])
        np.testing.assert_allclose(A_fin[i], A[-1], rtol=1e-10)
        np.testing.assert_allclose(
            P_max[i], np.max(np.abs(A) ** 2, axis=0), rtol=1e-10
        )
    mesh = default_mesh()
    P_sh, A_sh, ok_sh = nw.solve_comb_batch(cfg, coeffs, A0, mesh=mesh)
    np.testing.assert_allclose(P_sh, P_max, rtol=1e-12)
    np.testing.assert_array_equal(ok_sh, ok)


def test_solve_comb_batch_rk45():
    """solve_comb_batch honors integrator='rk45' (batched adaptive)."""
    n = 12
    grid = nw.CombGrid.centered(1.2e15, 2 * np.pi * 100e9, n)
    disp = DispersionParams.from_betas(1.2e15, beta2=-2e-26)
    beta = nw.comb_beta_lin(grid, disp)
    B = 3
    A0 = np.stack([nw.seed_comb(grid, pump_lines={5: 0.3, 7: 0.3})] * B)
    coeffs = nw.NWaveCoeffs(
        gamma=jnp.asarray(np.linspace(2.0, 8.0, B)),
        alpha=jnp.asarray(np.zeros(B)),
        beta_lin=jnp.asarray(np.broadcast_to(beta, (B, n))),
    )
    cfg45 = psa.custom_simulation_config(
        z_max=1.0, dz=1e-3, save_every=200, integrator="rk45",
        rtol=1e-10, atol=1e-14,
    )
    P45, A45, ok45 = nw.solve_comb_batch(cfg45, coeffs, A0)
    assert ok45.all()
    cfg4 = psa.custom_simulation_config(z_max=1.0, dz=1e-4, save_every=2000)
    P4, A4, ok4 = nw.solve_comb_batch(cfg4, coeffs, A0)
    np.testing.assert_allclose(A45, A4, rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize("n", [1, 2, 5, 16, 33, 64])
def test_dft_polarization_matches_fft(n):
    """The dense DFT-matmul coupling equals the FFT path."""
    a = jnp.asarray(_rand_state(n, seed=3))
    T_fft = np.asarray(nw.fwm_polarization(a))
    T_dft = np.asarray(nw.fwm_polarization_dft(a))
    np.testing.assert_allclose(T_dft, T_fft, rtol=1e-9, atol=1e-10)


def test_make_rhs_nwave_couplings_agree():
    a = jnp.asarray(_rand_state(12, b=3, seed=5))
    coeffs = nw.NWaveCoeffs(
        gamma=jnp.asarray(0.01), alpha=jnp.asarray(1e-4),
        beta_lin=jnp.asarray(np.linspace(-0.3, 0.3, 12)),
    )
    ref = np.asarray(nw.make_rhs_nwave("fft")(0.0, a, coeffs))
    for coupling in ("dft", "einsum"):
        got = np.asarray(nw.make_rhs_nwave(coupling)(0.0, a, coeffs))
        np.testing.assert_allclose(got, ref, rtol=1e-9, atol=1e-11)
    with pytest.raises(ValueError, match="coupling"):
        nw.make_rhs_nwave("bogus")


def test_solve_comb_batch_dft_coupling_end_to_end():
    n = 16
    grid = nw.CombGrid.centered(1.2e15, 2 * np.pi * 100e9, n)
    disp = DispersionParams.from_betas(1.2e15, beta2=-1e-27)
    c1 = nw.make_comb_coeffs(grid, disp, gamma_W_m=0.01, alpha_1_m=0.0)
    A0 = nw.seed_comb(grid, pump_lines={6: 0.4, 10: 0.4}, noise_floor_W=1e-9)
    B = 3
    coeffs = nw.NWaveCoeffs(
        gamma=np.full(B, 0.01), alpha=np.zeros(B),
        beta_lin=np.broadcast_to(np.asarray(c1.beta_lin, float), (B, n)),
    )
    A0b = np.broadcast_to(A0, (B, n)).copy()
    cfg = psa.custom_simulation_config(z_max=50.0, dz=0.05, save_every=100)
    P1, A1, ok1 = nw.solve_comb_batch(cfg, coeffs, A0b, coupling="fft")
    P2, A2, ok2 = nw.solve_comb_batch(cfg, coeffs, A0b, coupling="dft")
    assert np.all(ok1) and np.all(ok2)
    np.testing.assert_allclose(A2, A1, rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(P2, P1, rtol=1e-8, atol=1e-10)


def test_solve_comb_batch_couplings_agree_x32():
    """At x32 the dft and einsum couplings (both pinned to HIGHEST
    contraction precision) track the fft coupling to f32 class."""
    n, B = 8, 4
    rng = np.random.default_rng(2)
    A0 = rng.normal(size=(B, n)) * 0.3 + 1j * rng.normal(size=(B, n)) * 0.3
    coeffs = nw.NWaveCoeffs(
        gamma=np.linspace(0.5, 1.5, B), alpha=np.full(B, 0.02),
        beta_lin=np.broadcast_to(np.linspace(-0.3, 0.3, n), (B, n)),
    )
    cfg = psa.custom_simulation_config(z_max=1.0, dz=0.01, save_every=10,
                                       precision="x32")
    P1, A1, ok1 = nw.solve_comb_batch(cfg, coeffs, A0, coupling="fft")
    for coupling in ("dft", "einsum"):
        P2, A2, ok2 = nw.solve_comb_batch(cfg, coeffs, A0, coupling=coupling)
        assert ok1.all() and ok2.all()
        np.testing.assert_allclose(A2, A1, rtol=2e-5, atol=1e-7)
        np.testing.assert_allclose(P2, P1, rtol=2e-5, atol=1e-7)


def test_solve_comb_batch_validation():
    n, B = 8, 4
    A0 = np.ones((B, n), dtype=np.complex128) * 0.1
    coeffs = nw.NWaveCoeffs(
        gamma=np.full(B, 1.0), alpha=np.zeros(B),
        beta_lin=np.zeros((B, n)),
    )
    cfg_ip = psa.custom_simulation_config(
        z_max=1.0, dz=0.01, precision="x32", integrator="rk4ip"
    )
    # the split-step integrators have no comb path at all
    with pytest.raises(ValueError):
        nw.solve_comb_batch(cfg_ip, coeffs, A0)
    cfg_x64 = psa.custom_simulation_config(z_max=1.0, dz=0.01)
    with pytest.raises(ValueError, match="coupling"):
        nw.solve_comb_batch(cfg_x64, coeffs, A0, coupling="bogus")
    # the comb family has one engine: no engine= option is accepted
    with pytest.raises(TypeError):
        nw.solve_comb_batch(cfg_x64, coeffs, A0, engine="pallas")


def test_solve_comb_batch_engines_agree_on_partial_tail():
    """A_final sits at the last saved grid point (the framework-wide
    saved-grid convention) for every coupling when save_every does not
    divide n_steps."""
    n, B = 8, 3
    rng = np.random.default_rng(5)
    A0 = rng.normal(size=(B, n)) * 0.3 + 1j * rng.normal(size=(B, n)) * 0.3
    coeffs = nw.NWaveCoeffs(
        gamma=np.linspace(0.5, 1.5, B), alpha=np.full(B, 0.02),
        beta_lin=np.broadcast_to(np.linspace(-0.3, 0.3, n), (B, n)),
    )
    # 105 steps, save_every=10: 5 trailing steps are integrated but unsaved
    cfg = psa.custom_simulation_config(z_max=1.05, dz=0.01, save_every=10,
                                       precision="x32")
    P1, A1, ok1 = nw.solve_comb_batch(cfg, coeffs, A0, coupling="dft")
    P2, A2, ok2 = nw.solve_comb_batch(cfg, coeffs, A0, coupling="fft")
    assert ok1.all() and ok2.all()
    np.testing.assert_allclose(A2, A1, rtol=2e-5, atol=1e-7)
    # and the scan A_final equals the last SAVED row of a trajectory solve
    c0 = nw.NWaveCoeffs(
        gamma=float(coeffs.gamma[0]), alpha=float(coeffs.alpha[0]),
        beta_lin=coeffs.beta_lin[0],
    )
    z, Atraj = nw.run_comb_simulation(cfg, c0, A0[0], coupling="dft")
    np.testing.assert_allclose(A1[0], Atraj[-1], rtol=2e-6, atol=1e-8)


def test_degenerate_single_pump_3wave_analytic():
    """BASELINE config 1 ("one pump + signal + idler"): the DEGENERATE
    single-pump parametric amplifier is the N=3 comb (the k+l-m=j sum
    carries the A_p^2 A_s* product with the correct non-degenerate-vs-
    degenerate combinatorics the fixed 4-wave RHS cannot express).  At
    kappa = dbeta + 2 gamma P = 0 the undepleted-pump solution is
    Gs = cosh^2(gamma P L), Gi = sinh^2(gamma P L)."""
    gamma, P, L = 0.01, 0.5, 50.0
    g = gamma * P
    Ps_in = 1e-8
    A0 = np.array([[np.sqrt(Ps_in), np.sqrt(P), 0.0]], dtype=complex)
    beta = np.array([-gamma * P, 0.0, -gamma * P])  # kappa = 0
    cfg = psa.custom_simulation_config(z_max=L, dz=0.01, save_every=100)
    co = nw.NWaveCoeffs(gamma=np.array([gamma]), alpha=np.array([0.0]),
                        beta_lin=beta[None, :])
    _P_max, A_end, ok = nw.solve_comb_batch(cfg, co, A0, coupling="fft")
    assert ok.all()
    Gs = np.abs(A_end[0, 0]) ** 2 / Ps_in
    Gi = np.abs(A_end[0, 2]) ** 2 / Ps_in
    assert Gs == pytest.approx(np.cosh(g * L) ** 2, rel=1e-7)
    assert Gi == pytest.approx(np.sinh(g * L) ** 2, rel=1e-6)


def test_comb_batch_trajectories_match_single_runs():
    import dataclasses as dcl

    grid = nw.CombGrid.centered(1.2e15, 2 * np.pi * 100e9, 16)
    disp = psa.DispersionParams.from_betas(1.2e15, beta2=-1e-27)
    co = nw.make_comb_coeffs(grid, disp, gamma_W_m=5e-3)
    A0 = np.stack([
        nw.seed_comb(grid, pump_lines={7: p, 9: p}, noise_floor_W=1e-10,
                     seed=i)
        for i, p in enumerate((0.2, 0.4))
    ])
    cfg = psa.custom_simulation_config(z_max=10.0, dz=0.05, save_every=40)
    z_b, A_b, ok_b = nw.solve_comb_batch_trajectories(cfg, co, A0)
    assert ok_b.all() and A_b.shape[0] == 2
    for i in range(2):
        z_s, A_s = nw.run_comb_simulation(cfg, co_row(co, i), A0[i])
        np.testing.assert_allclose(z_b, z_s, rtol=1e-12)
        assert np.array_equal(A_b[i], A_s)
    # reduce-mode A_final sits at the last saved row
    _P, A_fin, _ok = nw.solve_comb_batch(cfg, co, A0)
    assert np.array_equal(A_b[:, -1, :], A_fin)

    # adaptive: batch equals per-instance adaptive runs
    cfg45 = dcl.replace(cfg, integrator="rk45", rtol=1e-8, atol=1e-12)
    z_b45, A_b45, ok45 = nw.solve_comb_batch_trajectories(cfg45, co, A0)
    assert ok45.all()
    z_s45, A_s45 = nw.run_comb_simulation(cfg45, co_row(co, 0), A0[0])
    np.testing.assert_allclose(A_b45[0], A_s45, rtol=1e-7, atol=1e-12)

    with pytest.raises(ValueError, match="reduce-mode"):
        cfg_df = dcl.replace(cfg, precision="df32")
        nw.solve_comb_batch_trajectories(cfg_df, co, A0)


def co_row(co, i):
    """Row i of broadcastable comb coeffs (single-run view)."""
    import jax.numpy as jnp

    g = np.broadcast_to(np.asarray(co.gamma, float), (2,))
    a = np.broadcast_to(np.asarray(co.alpha, float), (2,))
    b = np.asarray(co.beta_lin, float)
    return nw.NWaveCoeffs(gamma=jnp.asarray(g[i]), alpha=jnp.asarray(a[i]),
                          beta_lin=jnp.asarray(b))


def test_comb_rk45_scan_sharded_and_failure_masking():
    """integrator='rk45' comb solves: sharded over the 8-device CPU mesh
    equal the unsharded batch, and a runaway-gain lane is masked, not
    raised, with the healthy lanes unaffected."""
    from psa_simulation_ode_rk_mvp_dispersion.parallel import mesh as pm

    omega_c = 2 * np.pi * 193.1e12
    N, B = 16, 16
    grid = nw.CombGrid.centered(omega_c, 2 * np.pi * 50e9, N)
    disp = psa.DispersionParams.from_betas(omega_c, beta2=-1e-27)
    co1 = nw.make_comb_coeffs(grid, disp, gamma_W_m=10e-3, alpha_1_m=5e-5)
    A0 = np.broadcast_to(
        nw.seed_comb(grid, pump_lines={6: 0.4, 10: 0.4},
                     noise_floor_W=1e-9, seed=0), (B, N)).copy()
    gammas = np.linspace(5e-3, 15e-3, B)
    beta = np.broadcast_to(np.asarray(co1.beta_lin, float), (B, N))
    coeffs = nw.NWaveCoeffs(gamma=gammas, alpha=np.full(B, 5e-5),
                            beta_lin=beta)
    cfg32 = psa.custom_simulation_config(
        z_max=300.0, dz=5.0, save_every=20, precision="x32",
        integrator="rk45", rtol=1e-6, atol=1e-12)
    pk1, A1, ok1 = nw.solve_comb_batch(cfg32, coeffs, A0)
    pk2, A2, ok2 = nw.solve_comb_batch(cfg32, coeffs, A0,
                                       mesh=pm.default_mesh())
    assert ok1.all() and ok2.all()
    np.testing.assert_allclose(pk2, pk1, rtol=1e-5, atol=1e-12)
    np.testing.assert_allclose(A2, A1, rtol=1e-4, atol=1e-7)

    al = np.full(B, 5e-5)
    al[5] = -2.0
    bad = nw.NWaveCoeffs(gamma=gammas, alpha=al, beta_lin=beta)
    _pk, _A, okb = nw.solve_comb_batch(cfg32, bad, A0)
    assert not okb[5]
    assert okb[np.arange(B) != 5].all()
