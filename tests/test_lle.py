"""Lugiato-Lefever (driven-damped Kerr cavity) model tests.

Capability lineage: the resonator-closed version of the reference's
cascaded-FWM physics (/root/reference/simulation.py single-pass FWM; the
comb roadmap gesture in tests.py) on this framework's split-step engines.

Oracles are ANALYTIC throughout: the exact linear transient (the affine
drive step is exact, so the no-Kerr evolution must match
``psi_s (1 - e^{-(1+i Delta) t})`` to rounding), the homogeneous cubic
steady states, the universal MI threshold ``rho = 1`` with growth rate
``rho - 1`` at the resonant sideband, the ``Delta >> 1`` soliton ansatz
(peak ~ 2 Delta; Herr et al. 2014), and the steady-state power balance
``<|psi|^2> = Re(F <psi^*>)``.
"""

import numpy as np
import pytest

import psa
from psa_simulation_ode_rk_mvp_dispersion.models import lle

GRID = lle.TimeGrid(n_samples=256, t_window_s=20.0)


def _cfg(z_max, dz, save_every=10**9, **kw):
    save_every = min(save_every, int(round(z_max / dz)))
    return psa.custom_simulation_config(z_max=z_max, dz=dz,
                                        save_every=save_every, **kw)


def test_linear_transient_exact():
    """No Kerr (|psi|^2 ~ 0): Strang's affine linear step is EXACT, so any
    dz reproduces psi(t) = psi_s (1 - e^{-(1+iD)t}) to rounding."""
    det, F = 0.7, 1e-6
    co = lle.make_lle_coeffs(GRID, detuning=det, pump=F, d2=-1.0)
    cfg = _cfg(3.0, 0.05, 10)
    t, psi = lle.run_lle_simulation(cfg, co, np.zeros(GRID.n_samples, complex))
    psi_s = F / (1 + 1j * det)
    ana = psi_s * (1 - np.exp(-(1 + 1j * det) * t))
    assert np.max(np.abs(psi[:, 0] - ana)) / abs(psi_s) < 1e-10
    # field stays flat (no spurious dispersion response to a flat state)
    assert np.max(np.abs(psi[-1] - psi[-1, 0])) < 1e-18


def test_cw_converges_to_cubic_root():
    """The evolved fixed point equals the analytic cubic root.  The
    STEADY STATE of the discrete map carries the splitting bias --
    measured 1.1e-5 at dz=0.01 for Strang (O(dz^2)) vs < 1e-8 for rk4ip
    (O(dz^4)) -- so the tight check runs rk4ip and the Strang check
    asserts its own order."""
    det, F = 1.0, 1.1
    roots = lle.cw_steady_states(det, F)
    assert roots.size == 1
    co = lle.make_lle_coeffs(GRID, detuning=det, pump=F, d2=-1.0)
    cfg = _cfg(120.0, 0.01, 12000, integrator="rk4ip")
    t, psi = lle.run_lle_simulation(
        cfg, co, np.full(GRID.n_samples, 0.1 + 0j))
    np.testing.assert_allclose(abs(psi[-1, 0]) ** 2, roots[0], rtol=1e-8)
    # the analytic complex state, not just its power
    np.testing.assert_allclose(
        psi[-1, 0], lle.cw_state(det, F, roots[0]), rtol=1e-7)
    # Strang's steady-state bias is O(dz^2): quarters when dz halves
    biases = {}
    for dz in (0.02, 0.01):
        cfg_s = _cfg(120.0, dz, int(round(120.0 / dz)))
        _, psi_s = lle.run_lle_simulation(
            cfg_s, co, np.full(GRID.n_samples, 0.1 + 0j))
        biases[dz] = abs(abs(psi_s[-1, 0]) ** 2 - roots[0])
    assert 2.5 < biases[0.02] / biases[0.01] < 5.5, biases


def test_bistability_roots_and_branch_selection():
    """Delta > sqrt(3): three roots; cold start lands on the lower branch,
    a start near the upper branch stays there (both stable)."""
    det, F = 3.0, 1.9
    roots = lle.cw_steady_states(det, F)
    assert roots.size == 3
    co = lle.make_lle_coeffs(GRID, detuning=det, pump=F, d2=-1.0)
    cfg = _cfg(80.0, 0.01, 8000, integrator="rk4ip")
    _, lo = lle.run_lle_simulation(cfg, co,
                                   np.zeros(GRID.n_samples, complex))
    np.testing.assert_allclose(abs(lo[-1, 0]) ** 2, roots[0], rtol=1e-6)
    hi_seed = np.full(GRID.n_samples, lle.cw_state(det, F, roots[2]))
    _, hi = lle.run_lle_simulation(cfg, co, hi_seed)
    np.testing.assert_allclose(abs(hi[-1, 0]) ** 2, roots[2], rtol=1e-6)


def test_mi_threshold_and_growth_rate():
    """A CW state with rho > 1 is MI-unstable with growth rate rho - 1 at
    the resonant sideband phi_d(k) = 2 rho - Delta; a state with rho < 1
    decays perturbations.  Measured via the seeded-sideband energy slope
    over a short window (linearized regime)."""
    d2 = -1.0
    om = GRID.omega()

    def grow(det, F, which):
        roots = lle.cw_steady_states(det, F)
        rho = roots[-1 if which == "upper" else 0]
        psi_s = lle.cw_state(det, F, rho)
        rate, phi_star = lle.mi_gain_peak(det, rho)
        # resonant k on the grid (anomalous: phi_d = |d2| om^2 / 2); below
        # threshold no resonance exists (phi_star < 0) -- probe a mid-band
        # sideband instead (all of them decay)
        k_star = np.sqrt(max(2.0 * phi_star / abs(d2), 0.0))
        k_idx = int(np.argmin(np.abs(om - k_star)))
        if k_idx == 0:
            k_idx = GRID.n_samples // 8
        tau = GRID.t()
        eps = 1e-6
        psi0 = psi_s * (1.0 + eps * np.cos(om[k_idx] * tau))
        co = lle.make_lle_coeffs(GRID, detuning=det, pump=F, d2=d2)
        cfg = _cfg(2.0, 0.005, 40)
        t, psi = lle.run_lle_simulation(cfg, co, psi0)
        spec = np.abs(np.fft.fft(psi - psi[:, :1], axis=-1)) ** 2
        e = np.maximum(spec[:, k_idx] + spec[:, -k_idx % GRID.n_samples],
                       1e-300)
        # log-slope over the later half (transients settled, still linear)
        sl = np.polyfit(t[len(t) // 2:], np.log(e[len(t) // 2:]), 1)[0] / 2.0
        return sl, rate, e

    sl, rate, _ = grow(2.5, 1.8, "upper")   # rho ~ 1.5-2 (unstable)
    assert rate > 0.1
    np.testing.assert_allclose(sl, rate, rtol=0.1)
    _, rate2, e2 = grow(0.5, 0.5, "lower")  # rho < 1 (stable)
    # sideband energy decays ~e^{-2t} (measured 0.018 over t=2, the pure
    # cavity-loss rate): assert a >= 20x drop, not a log-slope (the tail
    # can reach the roundoff floor)
    assert rate2 < 0.0 and e2[-1] < 0.05 * e2[0]


def test_soliton_persistence_and_power_balance():
    det, F = 4.0, 2.0
    seed = lle.soliton_ansatz(GRID, det, F, -1.0)
    co = lle.make_lle_coeffs(GRID, detuning=det, pump=F, d2=-1.0)
    cfg = _cfg(30.0, 0.005, 1000)
    t, psi = lle.run_lle_simulation(cfg, co, seed)
    pk = np.max(np.abs(psi[-1]) ** 2)
    bg = lle.cw_steady_states(det, F)[0]
    assert abs(pk - 2 * det) / (2 * det) < 0.15      # peak ~ 2 Delta
    assert pk > 10 * bg                              # soliton, not CW
    # steady-state power balance <|psi|^2> == Re(F <psi*>)
    m = np.mean(np.abs(psi[-1]) ** 2)
    drv = np.real(F * np.mean(np.conj(psi[-1])))
    np.testing.assert_allclose(m, drv, rtol=1e-4)
    # sech^2 comb: spectrum is even and monotone over the first lines
    spec = lle.comb_spectrum(psi[-1] - np.mean(psi[-1]))
    assert spec[1] > spec[4] > spec[12]


def test_rk4ip_matches_strang_and_converges_faster():
    """Same continuous solution; rk4ip's fixed-dz error is far below
    Strang's at equal dz on the soliton workload."""
    det, F = 4.0, 2.0
    seed = lle.soliton_ansatz(GRID, det, F, -1.0)
    co = lle.make_lle_coeffs(GRID, detuning=det, pump=F, d2=-1.0)
    ref_cfg = _cfg(1.0, 0.0005, 2000, integrator="rk4ip")
    _, psi_ref = lle.run_lle_simulation(ref_cfg, co, seed)
    errs = {}
    for integ in ("rk4", "rk4ip"):
        cfg = _cfg(1.0, 0.02, 50, integrator=integ)
        _, psi = lle.run_lle_simulation(cfg, co, seed)
        errs[integ] = (np.max(np.abs(psi[-1] - psi_ref[-1]))
                       / np.max(np.abs(psi_ref[-1])))
    assert errs["rk4ip"] < errs["rk4"] / 20.0, errs


def test_batch_reduce_matches_trajectories():
    det = np.array([1.0, 2.0, 4.0])
    F = 2.0
    co = lle.make_lle_coeffs(GRID, detuning=det, pump=F, d2=-1.0)
    psi0 = np.stack([
        np.full(GRID.n_samples, 0.1 + 0j),
        np.full(GRID.n_samples, 0.2 + 0j),
        lle.soliton_ansatz(GRID, 4.0, F, -1.0),
    ])
    cfg = _cfg(2.0, 0.01, 50)
    t, A, ok = lle.solve_lle_batch_trajectories(cfg, co, psi0)
    assert ok.all()
    pk, A_last, ok2 = lle.solve_lle_batch(cfg, co, psi0)
    assert ok2.all()
    np.testing.assert_allclose(
        pk, np.max(np.abs(A) ** 2, axis=(1, 2)), rtol=1e-12)
    np.testing.assert_allclose(A_last, A[:, -1], rtol=1e-12, atol=1e-18)


def test_sharded_matches_unsharded():
    from psa_simulation_ode_rk_mvp_dispersion.parallel.mesh import (
        default_mesh,
    )

    det = np.linspace(0.5, 4.0, 8)
    co = lle.make_lle_coeffs(GRID, detuning=det, pump=1.5, d2=-1.0)
    rng = np.random.default_rng(3)
    psi0 = 0.1 + 1e-3 * (rng.standard_normal((8, GRID.n_samples))
                         + 1j * rng.standard_normal((8, GRID.n_samples)))
    cfg = _cfg(1.0, 0.01, 25)
    pk_u, Al_u, ok_u = lle.solve_lle_batch(cfg, co, psi0)
    pk_s, Al_s, ok_s = lle.solve_lle_batch(cfg, co, psi0,
                                           mesh=default_mesh())
    np.testing.assert_allclose(pk_s, pk_u, rtol=1e-12)
    np.testing.assert_allclose(Al_s, Al_u, rtol=1e-12, atol=1e-18)
    np.testing.assert_array_equal(ok_s, ok_u)


def test_detuning_scan_soliton_region():
    """Batched steady-state scan: mean power follows the lower CW branch
    below resonance and jumps onto MI/soliton states past it (mean power
    above the lower branch somewhere in 2 < Delta < 4.5)."""
    cfg = _cfg(40.0, 0.01, 4000)
    det, mean_p, pk, psi_last, ok = lle.detuning_scan(
        cfg, GRID, detunings=np.linspace(-1.0, 4.5, 12), pump=2.0, d2=-1.0,
        seed=0)
    assert ok.all()
    lower = np.array([lle.cw_steady_states(d, 2.0)[0] for d in det])
    # far below resonance: on the CW branch
    np.testing.assert_allclose(mean_p[0], lower[0], rtol=1e-3)
    mid = (det > 1.0) & (det < 4.0)
    assert np.any(pk[mid] > 3.0 * lower[mid])   # structured states formed


def test_ramp_soliton_step():
    """The laser-scan protocol: ramp Delta across the resonance at fixed
    pump from noise; the trace shows the MI peak then relaxes onto a
    low-power step with a localized (high peak/mean contrast) state --
    the soliton step."""
    rng = np.random.default_rng(1)
    T = GRID.n_samples
    psi0 = 1e-3 * (rng.standard_normal(T) + 1j * rng.standard_normal(T))
    cfg = _cfg(100.0, 0.01, 500)
    t, det, psi = lle.run_lle_ramp(cfg,
                                   lle.make_lle_coeffs(GRID, detuning=0.0,
                                                       pump=2.0, d2=-1.0),
                                   psi0, detuning_start=-2.0,
                                   detuning_end=5.0)
    mean_p = np.mean(np.abs(psi) ** 2, axis=-1)
    i_peak = int(np.argmax(mean_p))
    assert 0.0 < det[i_peak] < 4.0          # MI peak inside the resonance
    tail = det > 4.2
    assert np.any(tail)
    # past the step: mean power dropped well below the MI peak, but the
    # field is localized (peak >> mean) -- solitons, not CW
    assert mean_p[tail][-1] < 0.6 * mean_p[i_peak]
    contrast = (np.max(np.abs(psi[tail][-1]) ** 2) / mean_p[tail][-1])
    assert contrast > 4.0


def test_ramp_integrates_trailing_partial_steps():
    """Save-decimation contract on the ramp: the trailing
    ``n_steps % save_every`` steps are integrated (a NaN there flips
    ``ok``) even though they are unsaved.  With ``save_every > n_steps``
    EVERY step is trailing — a diverging psi0 must still raise, and a
    healthy ramp with a remainder must still run clean."""
    co = lle.make_lle_coeffs(GRID, detuning=0.0, pump=1.0, d2=-1.0)
    # n_steps=5, save_every=10 -> n_chunks=0, remainder=5.  |psi0| ~ 1e20
    # overflows the x32 Kerr power (1e40 -> inf -> NaN rotation) at the
    # very first (trailing) step.
    cfg = psa.custom_simulation_config(z_max=0.05, dz=0.01, save_every=10,
                                       precision="x32")
    with pytest.raises(FloatingPointError):
        lle.run_lle_ramp(cfg, co, np.full(GRID.n_samples, 1e20 + 0j),
                         detuning_start=0.0, detuning_end=1.0)
    # healthy ramp with a remainder (105 steps, save_every=10 -> 5
    # trailing) runs clean and keeps the decimated grid contract
    cfg2 = psa.custom_simulation_config(z_max=1.05, dz=0.01, save_every=10)
    t, det, psi = lle.run_lle_ramp(cfg2, co,
                                   np.zeros(GRID.n_samples, complex),
                                   detuning_start=0.0, detuning_end=2.1)
    assert t.shape == (11,) and psi.shape == (11, GRID.n_samples)
    np.testing.assert_allclose(t[-1], 1.0)
    np.testing.assert_allclose(det[-1], 2.0)   # last SAVED detuning


def test_strang_interior_fusion_is_exact():
    """The fused interior full-step affine map must equal the composition
    of the two half-step maps it replaces (drive is DC-only and
    ``phi_d(0)=0``, so the affine maps compose exactly): a decimated run
    (fused interiors) matches a save_every=1 run (pure half steps) to
    rounding."""
    det, F = 3.0, 1.6
    co = lle.make_lle_coeffs(GRID, detuning=det, pump=F, d2=-1.0)
    psi0 = lle.soliton_ansatz(GRID, det, F, -1.0)
    cfg_f = _cfg(2.0, 0.01, 40)    # fused: 39 interior full steps/chunk
    cfg_u = _cfg(2.0, 0.01, 1)     # unfused: half steps only
    _, psi_f = lle.run_lle_simulation(cfg_f, co, psi0)
    _, psi_u = lle.run_lle_simulation(cfg_u, co, psi0)
    assert np.max(np.abs(psi_f[-1] - psi_u[-1])) < 1e-12


def test_nan_freeze_and_check_nan():
    det, F = 1.0, 1.1
    co = lle.make_lle_coeffs(GRID, detuning=np.array([det, det]), pump=F,
                             d2=-1.0)
    psi0 = np.stack([np.full(GRID.n_samples, 0.1 + 0j),
                     np.full(GRID.n_samples, np.nan + 0j)])
    cfg = _cfg(1.0, 0.01, 25)
    pk, A_last, ok = lle.solve_lle_batch(cfg, co, psi0)
    assert ok[0] and not ok[1]
    co1 = lle.make_lle_coeffs(GRID, detuning=det, pump=F, d2=-1.0)
    with pytest.raises(FloatingPointError):
        lle.run_lle_simulation(cfg, co1,
                               np.full(GRID.n_samples, np.nan + 0j))


def test_rk45_adaptive_matches_fixed_step():
    """integrator='rk45' (step-doubling Strang, Sinkin controller) lands on
    the same saved grid and matches a fine fixed-step solution on the
    soliton workload; single-run and batch agree at the endpoint."""
    det, F = 4.0, 2.0
    seed = lle.soliton_ansatz(GRID, det, F, -1.0)
    co = lle.make_lle_coeffs(GRID, detuning=det, pump=F, d2=-1.0)
    ref_cfg = _cfg(1.0, 0.001, 500)
    _, psi_ref = lle.run_lle_simulation(ref_cfg, co, seed)
    cfg = _cfg(1.0, 0.05, 10, integrator="rk45", rtol=1e-8, atol=1e-10)
    t, psi = lle.run_lle_simulation(cfg, co, seed)
    assert psi.shape == psi_ref.shape and np.allclose(t[-1], 1.0)
    err = (np.max(np.abs(psi[-1] - psi_ref[-1]))
           / np.max(np.abs(psi_ref[-1])))
    # rtol bounds the LOCAL step error; the accumulated global error over
    # ~10^2 accepted steps is measured at 2.5e-5 here
    assert err < 1e-4, err
    # batch reduce mode: endpoint equals the trajectory's last saved row
    pk, psi_last, ok = lle.solve_lle_batch(cfg, co, seed[None])
    assert ok[0]
    np.testing.assert_allclose(psi_last[0], psi[-1], rtol=0,
                               atol=1e-12 * np.max(np.abs(psi[-1])))
    assert pk[0] == pytest.approx(np.max(np.abs(psi) ** 2), rel=1e-9)
    # trajectory batch mode matches the single run bitwise
    t2, A2, ok2 = lle.solve_lle_batch_trajectories(cfg, co, seed[None])
    np.testing.assert_array_equal(A2[0], psi)


def test_rk4ip45_adaptive_matches_truth_with_fewer_steps():
    """integrator='rk4ip45' (round 5, VERDICT r4 #4): step-doubling on the
    4th-order interaction-picture step (drive in N).  At equal tolerance
    it must land in the rk45 accuracy class while ACCEPTING far fewer
    steps (h ~ tol^{1/5} vs tol^{1/3}) -- the equal-tolerance speed
    mechanism of the round-5 adaptive lanes."""
    det, F = 4.0, 2.0
    seed = lle.soliton_ansatz(GRID, det, F, -1.0)
    co = lle.make_lle_coeffs(GRID, detuning=det, pump=F, d2=-1.0)
    ref_cfg = _cfg(1.0, 0.001, 500)
    _, psi_ref = lle.run_lle_simulation(ref_cfg, co, seed)
    kw = dict(rtol=1e-8, atol=1e-10)
    cfg_ip = _cfg(1.0, 0.05, 10, integrator="rk4ip45", **kw)
    t, psi = lle.run_lle_simulation(cfg_ip, co, seed)
    assert psi.shape == psi_ref.shape and np.allclose(t[-1], 1.0)
    err = (np.max(np.abs(psi[-1] - psi_ref[-1]))
           / np.max(np.abs(psi_ref[-1])))
    assert err < 1e-4, err
    # step-count comparison through the batch reduce counters
    from psa_simulation_ode_rk_mvp_dispersion.models.lle import (
        _lle_adaptive_solver, _lle_adaptive_family,
    )
    from psa_simulation_ode_rk_mvp_dispersion.utils.packing import (
        ri_pack_host,
    )
    import jax.numpy as jnp

    def n_accepted(integrator):
        cfg = _cfg(1.0, 0.05, 10, integrator=integrator, **kw)
        solver = _lle_adaptive_solver(
            "float64", kw["rtol"], kw["atol"], 100000, False, False,
            _lle_adaptive_family("rk4ip45" if integrator == "rk4ip45"
                                 else "rk45"))
        n_chunks = int(round(1.0 / 0.05)) // 10
        tg = jnp.asarray(np.arange(n_chunks + 1) * (10 * 0.05))
        co_b = lle.make_lle_coeffs(GRID, detuning=np.array([det]),
                                   pump=F, d2=-1.0)
        _ys, _yf, ok, na, _nr = solver(
            ri_pack_host(seed[None], np.float64), co_b, tg,
            jnp.asarray(0.05), jnp.asarray(1.0))
        assert int(np.asarray(ok)[0])
        return int(np.asarray(na)[0])

    na_ip, na_strang = n_accepted("rk4ip45"), n_accepted("rk45")
    assert na_ip * 2 < na_strang, (na_ip, na_strang)
    # batch endpoint equals the single-run last saved row
    pk, psi_last, ok = lle.solve_lle_batch(cfg_ip, co, seed[None])
    assert ok[0]
    np.testing.assert_allclose(psi_last[0], psi[-1], rtol=0,
                               atol=1e-12 * np.max(np.abs(psi[-1])))


def test_rk45_sharded_matches_unsharded():
    from psa_simulation_ode_rk_mvp_dispersion.parallel.mesh import (
        default_mesh,
    )

    dets = np.linspace(3.5, 4.5, 6)
    co = lle.make_lle_coeffs(GRID, detuning=dets, pump=2.2, d2=-1.0)
    psi0 = np.stack([lle.soliton_ansatz(GRID, d, 2.2, -1.0) for d in dets])
    cfg = _cfg(0.5, 0.05, 5, integrator="rk45", rtol=1e-7, atol=1e-10)
    pk, Af, ok = lle.solve_lle_batch(cfg, co, psi0)
    pk_s, Af_s, ok_s = lle.solve_lle_batch(cfg, co, psi0,
                                           mesh=default_mesh())
    assert ok.all() and np.array_equal(ok, ok_s)
    np.testing.assert_allclose(Af_s, Af, rtol=0,
                               atol=1e-9 * np.max(np.abs(Af)))
    np.testing.assert_allclose(pk_s, pk, rtol=1e-9)


def test_rk45_integrates_trailing_partial_steps():
    """rk45 save-decimation contract (advisor r3): the trailing
    ``n_steps % save_every`` partial span is integrated but unsaved — the
    saved rows are bit-identical to a run ending exactly on the grid, a
    blow-up confined to the tail still flips ``ok``, and the ``n_chunks==0``
    case keeps the psi0 NaN check."""
    det, F = 4.0, 2.0
    seed = lle.soliton_ansatz(GRID, det, F, -1.0)
    co = lle.make_lle_coeffs(GRID, detuning=det, pump=F, d2=-1.0)
    cfg_a = _cfg(1.0, 0.01, 20, integrator="rk45", rtol=1e-7, atol=1e-10)
    t_a, psi_a = lle.run_lle_simulation(cfg_a, co, seed)
    # z_max=1.05 -> n_steps=105, n_chunks=5, remainder=5: same saved grid,
    # bit-identical saved rows (the tail runs strictly after the last save)
    cfg_b = psa.custom_simulation_config(z_max=1.05, dz=0.01, save_every=20,
                                         integrator="rk45", rtol=1e-7,
                                         atol=1e-10)
    t_b, psi_b = lle.run_lle_simulation(cfg_b, co, seed)
    np.testing.assert_array_equal(t_b, t_a)
    np.testing.assert_array_equal(psi_b, psi_a)
    # n_chunks==0 (save_every > n_steps): every step is trailing -- a
    # diverging psi0 must still raise, on the single-run AND flip ok in batch
    # rtol must sit above the f32 step-doubling error floor or the healthy
    # lane rejects forever (dt underflow) instead of integrating the tail
    cfg0 = psa.custom_simulation_config(z_max=0.05, dz=0.01, save_every=10,
                                        integrator="rk45", precision="x32",
                                        rtol=1e-4, atol=1e-6)
    with pytest.raises(FloatingPointError):
        lle.run_lle_simulation(cfg0, co, np.full(GRID.n_samples, 1e20 + 0j))
    with pytest.raises(FloatingPointError):
        lle.run_lle_simulation(cfg0, co,
                               np.full(GRID.n_samples, np.nan + 0j))
    _pk, _pl, ok = lle.solve_lle_batch(
        cfg0, lle.make_lle_coeffs(GRID, detuning=np.array([det, det]),
                                  pump=F, d2=-1.0),
        np.stack([seed, np.full(GRID.n_samples, 1e20 + 0j)]))
    assert ok[0] and not ok[1]
    # healthy n_chunks==0 run: row 0 only, trajectory grid is [0]
    t0, psi0_out = lle.run_lle_simulation(cfg0, co, seed.astype(complex))
    assert t0.shape == (1,) and psi0_out.shape == (1, GRID.n_samples)


def test_rejects_unsupported_integrators_and_precision():
    co = lle.make_lle_coeffs(GRID, detuning=1.0, pump=1.0, d2=-1.0)
    psi0 = np.zeros(GRID.n_samples, complex)
    for integ in ("ab4", "abm4"):   # rk4ip45 is supported since round 5
        cfg = _cfg(1.0, 0.01, 25, integrator=integ)
        with pytest.raises(ValueError):
            lle.run_lle_simulation(cfg, co, psi0)
    cfg = _cfg(1.0, 0.01, 25, integrator="rk4ip")
    with pytest.raises(ValueError, match="rk4"):
        lle.run_lle_ramp(cfg, co, psi0, detuning_start=0.0, detuning_end=1.0)
    # the df32 tier is Strang-only, ramp-free, and requires host-f64 coeffs
    co_df = lle.make_lle_coeffs(GRID, detuning=1.0, pump=1.0, d2=-1.0,
                                precision="df32")
    assert isinstance(co_df.lin_phase, np.ndarray)   # host leaves kept
    cfg_df = _cfg(1.0, 0.01, 25, integrator="rk4ip", precision="df32")
    with pytest.raises(ValueError, match="df32"):
        lle.run_lle_simulation(cfg_df, co_df, psi0)
    cfg_df_ramp = _cfg(1.0, 0.01, 25, precision="df32")
    with pytest.raises(ValueError, match="df32"):
        lle.run_lle_ramp(cfg_df_ramp, co_df, psi0,
                         detuning_start=0.0, detuning_end=1.0)
    with pytest.raises(ValueError, match="f64|df32|x64"):
        # f32-built coeffs into the df32 tier: refused, not silently x32
        co32 = lle.make_lle_coeffs(GRID, detuning=1.0, pump=1.0, d2=-1.0,
                                   precision="x32")
        lle.run_lle_simulation(_cfg(1.0, 0.01, 25, precision="df32"),
                               co32, psi0)


def test_soliton_ansatz_validation():
    with pytest.raises(ValueError, match="anomalous"):
        lle.soliton_ansatz(GRID, 4.0, 2.0, 1.0)
    with pytest.raises(ValueError, match="no soliton"):
        lle.soliton_ansatz(GRID, 4.0, 0.5, -1.0)    # pump below existence


def test_physical_normalization_consistency():
    """normalize_ring_cavity: the normalized cubic roots, mapped back to
    physical intracavity powers, satisfy the PHYSICAL bistability relation
    (alpha^2 + (delta0 - gamma L P)^2) P = theta P_in exactly -- the
    algebra of the unit mapping, checked end to end."""
    rng = np.random.default_rng(2)
    for _ in range(20):
        L = float(rng.uniform(10.0, 200.0))           # m
        g = float(rng.uniform(1e-3, 20e-3))           # 1/(W m)
        b2 = float(rng.uniform(-30e-27, -1e-27))      # s^2/m, anomalous
        a = float(rng.uniform(0.05, 0.3))             # half round-trip loss
        th = float(rng.uniform(0.02, 2 * a))          # coupler
        d0 = float(rng.uniform(-0.2, 0.8))            # rad
        P_in = float(rng.uniform(0.01, 5.0))          # W
        nm = lle.normalize_ring_cavity(
            round_trip_length_m=L, t_roundtrip_s=L / 2e8, gamma_W_m=g,
            beta2_s2_m=b2, alpha_half_loss=a, coupling_theta=th,
            detuning_phase_rad=d0, pump_power_W=P_in)
        assert nm.d2 == -1.0
        roots = lle.cw_steady_states(nm.detuning, nm.pump)
        assert roots.size in (1, 3)
        for rho in roots:
            P = rho * nm.field_scale_sqrtW ** 2       # physical |E|^2 [W]
            lhs = (a ** 2 + (d0 - g * L * P) ** 2) * P
            np.testing.assert_allclose(lhs, th * P_in, rtol=1e-10)
    # photon lifetime and tau scale carry the right dimensions
    assert nm.photon_lifetime_s == (L / 2e8) / a
    np.testing.assert_allclose(nm.tau_scale_s, np.sqrt(abs(b2) * L / a))
    with pytest.raises(ValueError, match="beta2"):
        lle.normalize_ring_cavity(
            round_trip_length_m=L, t_roundtrip_s=L / 2e8, gamma_W_m=g,
            beta2_s2_m=0.0, alpha_half_loss=a, coupling_theta=th,
            detuning_phase_rad=d0, pump_power_W=P_in)
