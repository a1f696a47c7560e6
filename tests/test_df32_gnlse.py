"""Matched-tolerance (df32) GNLSE engine: ops/df32_gnlse.py.

CPU coverage is the EAGER component lane (XLA:CPU compiles two-float
programs pathologically slowly -- CLAUDE.md constraint 4): the two-float
sin/cos against numpy f64, the Kerr rotation and eager few-step SSFM
against the x64 scan solver.  The jitted chunked solver (and the public
solve_gnlse_batch df32 dispatch) runs on the opt-in lane: PSA_DF32_FULL=1
(same gating as tests/test_df32_comb.py)."""

import os

import numpy as np
import pytest

import psa
from psa_simulation_ode_rk_mvp_dispersion.models import gnlse as gn
from psa_simulation_ode_rk_mvp_dispersion.ops import df32_gnlse as dg
from psa_simulation_ode_rk_mvp_dispersion.ops.twofloat import (
    ctf_from_c128,
    ctf_to_c128,
    tf_from_f64,
    tf_sin_cos,
    tf_to_f64,
)

_RUN_FULL = os.environ.get("PSA_DF32_FULL", "0") == "1"

needs_full = pytest.mark.skipif(
    not _RUN_FULL,
    reason="jitted df32 solver: XLA:CPU two-float compiles are pathological "
    "(opt in: PSA_DF32_FULL=1)",
)


T0 = 1e-12
BETA2 = -2.0e-26
GAMMA = 2e-3
ALPHA = 5e-5


def _setup(B, T=64, precision="df32", spec=False):
    grid = gn.TimeGrid.for_pulse(T0, n_samples=T)
    disp = psa.DispersionParams.from_betas(1.2e15, beta2=BETA2, beta3=5e-41)
    kw = {}
    if spec:
        om = grid.omega()
        kw["alpha_spec_1_m"] = 1e-4 * (om / np.abs(om).max()) ** 2
    co = gn.make_gnlse_coeffs(grid, disp, gamma_W_m=GAMMA, alpha_1_m=ALPHA,
                              precision=precision, **kw)
    P0 = gn.soliton_peak_power(BETA2, GAMMA, T0)
    scales = np.linspace(0.5, 1.5, B)
    A0 = (np.sqrt(scales * P0)[:, None]
          / np.cosh(grid.t()[None, :] / T0)).astype(np.complex128)
    return grid, co, A0


def _cfg(n_steps=7, save_every=3, zmax=0.07, precision="df32", **kw):
    return psa.custom_simulation_config(
        z_max=zmax, dz=zmax / n_steps, save_every=save_every,
        precision=precision, **kw)


def test_tf_sin_cos_matches_f64():
    """Two-float sin/cos over small, quadrant-crossing and multi-turn
    angles: ~1e-15 absolute (f32 intrinsics stop at ~6e-8)."""
    th = np.concatenate([
        np.linspace(-0.8, 0.8, 41),            # the Kerr-phase regime
        np.linspace(-7.0, 7.0, 37),            # quadrant + 2*pi folding
        np.array([0.0, np.pi / 4, -np.pi / 2, np.pi]),
    ])
    s, c = tf_sin_cos(tf_from_f64(th))
    np.testing.assert_allclose(tf_to_f64(s), np.sin(th), rtol=0, atol=5e-14)
    np.testing.assert_allclose(tf_to_f64(c), np.cos(th), rtol=0, atol=5e-14)
    # large angles: the TF format itself resolves theta only to
    # |theta| * 2^-48 absolute, so the phase (and hence sin/cos) error
    # scales with magnitude -- the algorithm adds nothing on top
    big = np.array([123.456, -987.125, 3000.0])
    sb, cb = tf_sin_cos(tf_from_f64(big))
    tol = np.abs(big) * 2.0 ** -47
    assert np.all(np.abs(tf_to_f64(sb) - np.sin(big)) < tol)
    assert np.all(np.abs(tf_to_f64(cb) - np.cos(big)) < tol)
    # non-finite angles propagate (freeze-contract detectability)
    s_bad, c_bad = tf_sin_cos(tf_from_f64(np.array([np.nan, np.inf])))
    assert not np.any(np.isfinite(tf_to_f64(s_bad)))
    assert not np.any(np.isfinite(tf_to_f64(c_bad)))


def test_kerr_rotation_matches_f64():
    rng = np.random.default_rng(0)
    y = rng.normal(size=(3, 16)) + 1j * rng.normal(size=(3, 16))
    gh = tf_from_f64(np.array([[0.01], [0.3], [1.7]]))
    got = ctf_to_c128(dg.kerr_rotation_df32(ctf_from_c128(y), gh))
    g = np.array([[0.01], [0.3], [1.7]])
    ref = y * np.exp(1j * g * np.abs(y) ** 2)
    assert np.abs(got - ref).max() / np.abs(ref).max() < 1e-13


def test_eager_ssfm_matches_x64_scan():
    """Eager df32 reduce solve vs the x64 scan engine: identical discrete
    map (same Strang chunking, same save grid), so the difference is pure
    roundoff.  Includes a trailing partial chunk (7 steps, save_every=3)."""
    _grid, co, A0 = _setup(B=3)
    cfg = _cfg()
    co_df = dg.make_df32_gnlse_coeffs(
        co.gamma, co.alpha, co.lin_phase,
        dz_m=cfg.dz, B=3, T=A0.shape[1])
    pk, y, ok = dg.run_reduce_eager(ctf_from_c128(A0), co_df, 7, 3)
    assert bool(np.all(np.asarray(ok)))

    _grid, co64, _ = _setup(B=3, precision="x64")
    pk_r, A_r, ok_r = gn.solve_gnlse_batch(_cfg(precision="x64"), co64, A0)
    A_df = ctf_to_c128(y)
    assert np.abs(A_df - A_r).max() / np.abs(A_r).max() < 1e-12
    np.testing.assert_allclose(tf_to_f64(pk), pk_r, rtol=1e-12)


@pytest.mark.parametrize("f_raman,omega0", [
    (0.18, 1.2e15),   # full generalized operator
    (0.18, None),     # Raman only
    (0.0, 1.2e15),    # self-steepening only
])
def test_eager_nl_matches_x64_scan(f_raman, omega0):
    """Eager df32 generalized-nonlinearity solve vs the x64 scan engine:
    the two-float RK4 runs the SAME method (and the full-complex tf_fft of
    the real power waveform computes the identical convolution to the
    scan engine's rfft pair), so the difference is pure roundoff."""
    grid, co, A0 = _setup(B=2, T=32)
    nl = gn.make_nl_terms(grid, f_raman=f_raman, omega0=omega0,
                          precision="df32")
    cfg = _cfg(n_steps=4, save_every=2, zmax=0.04)
    co_df = dg.make_df32_gnlse_coeffs(
        co.gamma, co.alpha, co.lin_phase,
        dz_m=cfg.dz, B=2, T=A0.shape[1])
    nlp = dg.make_df32_nl_planes(nl)
    pk, y, ok = dg.run_reduce_eager(
        ctf_from_c128(A0), co_df, 4, 2, nlp=nlp,
        f_r=float(nl.f_r), inv_w0=float(nl.inv_w0))
    assert bool(np.all(np.asarray(ok)))

    _g, co64, _ = _setup(B=2, T=32, precision="x64")
    nl64 = gn.make_nl_terms(grid, f_raman=f_raman, omega0=omega0,
                            precision="x64")
    cfg64 = _cfg(n_steps=4, save_every=2, zmax=0.04, precision="x64")
    pk_r, A_r, _ok = gn.solve_gnlse_batch(cfg64, co64, A0, nl=nl64)
    A_df = ctf_to_c128(y)
    assert np.abs(A_df - A_r).max() / np.abs(A_r).max() < 1e-11
    np.testing.assert_allclose(tf_to_f64(pk), pk_r, rtol=1e-11)


def test_eager_spectral_alpha_and_freeze():
    """Spectral loss collapses into the factor planes; a runaway lane
    (negative alpha) freezes at its last good chunk like the scan engine."""
    _grid, co, A0 = _setup(B=3, spec=True)
    cfg = _cfg(n_steps=6, save_every=3)
    al = np.asarray(co.alpha)  # (T,) spectral
    co_df = dg.make_df32_gnlse_coeffs(
        co.gamma, al, co.lin_phase, dz_m=cfg.dz, B=3, T=A0.shape[1])
    _pk, y, ok = dg.run_reduce_eager(ctf_from_c128(A0), co_df, 6, 3)
    _g, co64, _ = _setup(B=3, precision="x64", spec=True)
    cfg64 = _cfg(n_steps=6, save_every=3, precision="x64")
    _, A_r, _ = gn.solve_gnlse_batch(cfg64, co64, A0)
    assert np.abs(ctf_to_c128(y) - A_r).max() / np.abs(A_r).max() < 1e-12

    # freeze: lane 1 overflows (huge negative flat alpha = gain)
    alpha_b = np.array([ALPHA, -4.0e5, ALPHA])
    co_bad = dg.make_df32_gnlse_coeffs(
        co.gamma, alpha_b, co.lin_phase, dz_m=0.01, B=3, T=A0.shape[1])
    _pk2, y2, ok2 = dg.run_reduce_eager(ctf_from_c128(A0), co_bad, 6, 2)
    ok2 = np.asarray(ok2)
    assert not ok2[1] and ok2[0] and ok2[2]
    assert np.all(np.isfinite(ctf_to_c128(y2)[[0, 2]]))


def test_df32_dispatch_validation():
    """Public-surface guards: df32 is fixed-step only; T must be a power
    of two; df32 coeffs AND nl terms keep host f64 leaves (round 3: the
    generalized nonlinearity has a two-float rendering now)."""
    _grid, co, A0 = _setup(B=2)
    assert isinstance(co.lin_phase, np.ndarray)
    assert co.lin_phase.dtype == np.float64
    with pytest.raises(ValueError, match="rk4"):
        gn.solve_gnlse_batch(
            _cfg(integrator="rk45", rtol=1e-6, atol=1e-10), co, A0)
    grid = gn.TimeGrid.for_pulse(T0, n_samples=64)
    nl_df = gn.make_nl_terms(grid, f_raman=0.18, omega0=1.2e15,
                             precision="df32")
    assert isinstance(nl_df.hr_re, np.ndarray)
    assert nl_df.hr_re.dtype == np.float64
    assert isinstance(nl_df.omega, np.ndarray)
    # x32-built inputs are REJECTED under a df32 cfg: upcasting f32 leaves
    # would zero the lo limbs and silently degrade the <=1e-9 tier
    nl_x32 = gn.make_nl_terms(grid, f_raman=0.18, omega0=1.2e15,
                              precision="x32")
    with pytest.raises(ValueError, match="two-float split"):
        gn.solve_gnlse_batch(_cfg(), co, A0, nl=nl_x32)
    co_x32 = gn.make_gnlse_coeffs(
        gn.TimeGrid.for_pulse(T0, n_samples=64),
        psa.DispersionParams.from_betas(1.2e15, beta2=BETA2),
        gamma_W_m=GAMMA, precision="x32")
    with pytest.raises(ValueError, match="two-float split"):
        gn.solve_gnlse_batch(_cfg(), co_x32, A0)
    with pytest.raises(ValueError, match="power of two"):
        dg.solve_gnlse_batch_df32(
            np.zeros((2, 48), complex), GAMMA, ALPHA, np.zeros(48),
            dz_m=0.01, n_steps=3, save_every=1)
    # the family has one engine: no engine= option is accepted
    with pytest.raises(TypeError, match="engine"):
        gn.solve_gnlse_batch(_cfg(), co, A0, engine="pallas")


@needs_full
@pytest.mark.parametrize("with_nl", [False, True])
def test_jitted_df32_gnlse_matches_x64_1e9(with_nl):
    """The matched-tolerance bar: jitted df32 SSFM within 1e-9 of the x64
    CPU solver over 200 cascaded split steps (soliton-scale nonlinearity;
    with_nl adds the Raman + self-steepening two-float RK4 substep)."""
    import jax

    B, T, steps = 4, 128, 200
    grid, co, A0 = _setup(B=B, T=T)
    nl = nl64 = None
    if with_nl:
        nl = gn.make_nl_terms(grid, f_raman=0.18, omega0=1.2e15,
                              precision="df32")
    cfg = _cfg(n_steps=steps, save_every=20, zmax=2.0)
    pk, A_last, ok = gn.solve_gnlse_batch(cfg, co, A0, nl=nl)
    assert ok.all()

    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        _g, co64, _ = _setup(B=B, T=T, precision="x64")
        if with_nl:
            nl64 = gn.make_nl_terms(grid, f_raman=0.18, omega0=1.2e15,
                                    precision="x64")
        cfg64 = _cfg(n_steps=steps, save_every=20, zmax=2.0,
                     precision="x64")
        pk_r, A_r, ok_r = gn.solve_gnlse_batch(cfg64, co64, A0, nl=nl64)
    assert np.abs(A_last - A_r).max() / np.abs(A_r).max() < 1e-9
    np.testing.assert_allclose(pk, pk_r, rtol=1e-9)


@needs_full
def test_jitted_df32_trajectory_and_resume():
    """run_gnlse_simulation(precision='df32'): saved trajectory matches the
    x64 CPU trajectory to ~1e-9; a split run resumed from a saved row
    reproduces the uninterrupted tail BITWISE (autonomous equation +
    unfused chunks); batch trajectories agree with reduce mode."""
    import jax

    T = 128
    _grid, co, A0b = _setup(B=2, T=T)
    A0 = A0b[0]
    cfg = _cfg(n_steps=60, save_every=10, zmax=0.6)
    z, A = gn.run_gnlse_simulation(cfg, co, A0)
    assert A.shape == (7, T)

    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        _g, co64, _ = _setup(B=2, T=T, precision="x64")
        z64, A64 = gn.run_gnlse_simulation(
            _cfg(n_steps=60, save_every=10, zmax=0.6, precision="x64"),
            co64, A0)
    assert np.abs(A - A64).max() / np.abs(A64).max() < 1e-9

    # resume: first 30 steps, then 30 more from the saved midpoint
    cfg_h = _cfg(n_steps=30, save_every=10, zmax=0.3)
    z1, A1 = gn.run_gnlse_simulation(cfg_h, co, A0)
    z2, A2 = gn.run_gnlse_simulation(cfg_h, co, A1[-1], z0=float(z1[-1]))
    np.testing.assert_array_equal(
        np.concatenate([A1, A2[1:]]), A)

    # batch trajectories: final frame == reduce-mode A_last
    zt, At, okt = gn.solve_gnlse_batch_trajectories(cfg, co, A0b)
    _pk, A_last, _ok = gn.solve_gnlse_batch(cfg, co, A0b)
    np.testing.assert_array_equal(At[:, -1], A_last)
    np.testing.assert_array_equal(At[0], A)


@needs_full
def test_jitted_df32_gnlse_sharded_matches_unsharded():
    import jax

    from psa_simulation_ode_rk_mvp_dispersion.parallel.mesh import (
        default_mesh,
    )

    if len(jax.devices()) < 2:
        pytest.skip("needs >= 2 devices")
    B, T = 6, 64                    # pads over the mesh
    _grid, co, A0 = _setup(B=B, T=T)
    cfg = _cfg(n_steps=10, save_every=4, zmax=0.1)
    pk, A_last, ok = gn.solve_gnlse_batch(cfg, co, A0)
    pk_s, A_s, ok_s = gn.solve_gnlse_batch(cfg, co, A0, mesh=default_mesh())
    np.testing.assert_allclose(A_s, A_last, rtol=0, atol=0)
    np.testing.assert_allclose(pk_s, pk, rtol=0)
    np.testing.assert_array_equal(ok_s, ok)
