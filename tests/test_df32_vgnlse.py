"""Matched-tolerance (df32) vector-GNLSE engine: ops/df32_vgnlse.py.

Same lane split as every df32 engine (CLAUDE.md constraint 4): eager
component checks on CPU, jitted solvers on the opt-in lane
(PSA_DF32_FULL=1)."""

import os

import numpy as np
import pytest

import psa
from psa_simulation_ode_rk_mvp_dispersion.models import gnlse as gn
from psa_simulation_ode_rk_mvp_dispersion.models import vgnlse as vg
from psa_simulation_ode_rk_mvp_dispersion.ops import df32_vgnlse as dv
from psa_simulation_ode_rk_mvp_dispersion.ops.twofloat import (
    ctf_from_c128,
    ctf_to_c128,
    tf_from_f64,
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


def _setup(B, T=64, precision="df32", coupling="cnlse", spec=False):
    grid = gn.TimeGrid.for_pulse(T0, n_samples=T)
    disp = psa.DispersionParams.from_betas(1.2e15, beta2=BETA2)
    kw = {}
    if spec:
        om = grid.omega()
        kw["alpha_spec_1_m"] = np.stack([
            1e-4 * (om / np.abs(om).max()) ** 2,
            2e-4 * (om / np.abs(om).max()) ** 2,
        ])
    co = vg.make_vgnlse_coeffs(
        grid, disp, gamma_W_m=GAMMA, alpha_1_m=5e-5, coupling=coupling,
        dbeta0_1_m=0.3, dbeta1_s_m=1e-13, precision=precision, **kw)
    P0 = gn.soliton_peak_power(BETA2, GAMMA, T0)
    A0 = np.stack([
        np.stack([
            np.sqrt(0.8 * p * P0) / np.cosh(grid.t() / T0),
            np.sqrt(0.4 * p * P0) / np.cosh(grid.t() / T0) * np.exp(0.3j),
        ])
        for p in np.linspace(0.5, 1.5, B)
    ]).astype(np.complex128)
    return grid, co, A0


def _cfg(n_steps=7, save_every=3, zmax=0.07, precision="df32", **kw):
    return psa.custom_simulation_config(
        z_max=zmax, dz=zmax / n_steps, save_every=save_every,
        precision=precision, **kw)


def test_xpm_rotation_matches_f64():
    rng = np.random.default_rng(0)
    y = rng.normal(size=(2, 2, 16)) + 1j * rng.normal(size=(2, 2, 16))
    gh = tf_from_f64(np.array(0.05)[None, None, None] * np.ones((2, 1, 1)))
    b = tf_from_f64(np.float64(2.0 / 3.0))
    got = ctf_to_c128(dv.xpm_kerr_rotation_df32(ctf_from_c128(y), gh, b))
    P = np.abs(y) ** 2
    ang = 0.05 * (P + (2.0 / 3.0) * P[:, ::-1])
    ref = y * np.exp(1j * ang)
    assert np.abs(got - ref).max() / np.abs(ref).max() < 1e-13


@pytest.mark.parametrize("coupling", ["cnlse", "manakov", "isotropic"])
def test_eager_vssfm_matches_x64_scan(coupling):
    """Eager df32 vector reduce solve vs the x64 scan engine: identical
    discrete map (exact rotation for the incoherent couplings, the SAME
    RK4 on the coherent operator for isotropic), so the difference is
    pure roundoff.  Trailing partial chunk + birefringent splitting +
    polarization-dependent spectral loss."""
    _grid, co, A0 = _setup(B=3, coupling=coupling, spec=True)
    cfg = _cfg()
    co_df = dv.make_df32_vgnlse_coeffs(
        co.gamma, co.alpha, float(co.b_xpm), co.lin_phase,
        dz_m=cfg.dz, B=3, T=A0.shape[-1])
    pk, y, ok = dv.run_v_reduce_eager(ctf_from_c128(A0), co_df, 7, 3,
                                      coherent=float(co.coherent))
    assert bool(np.all(np.asarray(ok)))

    _g, co64, _ = _setup(B=3, precision="x64", coupling=coupling, spec=True)
    pk_r, A_r, ok_r = vg.solve_vgnlse_batch(_cfg(precision="x64"), co64, A0)
    A_df = ctf_to_c128(y)
    assert np.abs(A_df - A_r).max() / np.abs(A_r).max() < 1e-12
    from psa_simulation_ode_rk_mvp_dispersion.ops.twofloat import (
        tf_to_f64,
    )
    np.testing.assert_allclose(tf_to_f64(pk), pk_r, rtol=1e-12)


def test_df32_dispatch_validation():
    """df32 coeffs keep HOST f64 leaves for every coupling (round 3:
    isotropic included -- the coherent c-term runs the two-float RK4);
    rk45 rejected; non-power-of-two T rejected."""
    grid = gn.TimeGrid.for_pulse(T0, n_samples=64)
    co_iso = vg.make_vgnlse_coeffs(grid, None, gamma_W_m=GAMMA,
                                   coupling="isotropic", precision="df32")
    assert isinstance(co_iso.lin_phase, np.ndarray)
    assert co_iso.lin_phase.dtype == np.float64
    assert float(co_iso.coherent) == pytest.approx(1.0 / 3.0)
    _grid, co, A0 = _setup(B=2)
    assert isinstance(co.lin_phase, np.ndarray)
    assert co.lin_phase.dtype == np.float64
    with pytest.raises(ValueError, match="rk4"):
        vg.solve_vgnlse_batch(
            _cfg(integrator="rk45", rtol=1e-6, atol=1e-10), co, A0)
    # x32-built coeffs under a df32 cfg are rejected (upcast f32 leaves
    # would zero the lo limbs -- restores the pre-round-3 fail-fast)
    co_x32 = vg.make_vgnlse_coeffs(grid, None, gamma_W_m=GAMMA,
                                   coupling="isotropic", precision="x32")
    with pytest.raises(ValueError, match="two-float split"):
        vg.solve_vgnlse_batch(_cfg(), co_x32, A0)
    with pytest.raises(ValueError, match="power of two"):
        dv.solve_vgnlse_batch_df32(
            np.zeros((2, 2, 48), complex), GAMMA, 0.0, 2.0 / 3.0,
            np.zeros((2, 48)), dz_m=0.01, n_steps=3, save_every=1)


def test_eager_vssfm_generalized_nl_matches_x64_scan():
    """Eager df32 vector reduce solve with the GENERALIZED operator (Raman
    + self-steepening, isotropic-Raman approximation) vs the x64 scan
    engine: same RK4 on the same discrete operator, so the difference is
    pure roundoff.  Coherent c-term active too (isotropic coupling)."""
    T = 64
    grid = gn.TimeGrid.for_pulse(T0, n_samples=T)
    nl_df = gn.make_nl_terms(grid, f_raman=0.18, omega0=1.2e15,
                             precision="df32")
    _g, co, A0 = _setup(B=3, T=T, coupling="isotropic", spec=True)
    cfg = _cfg()
    from psa_simulation_ode_rk_mvp_dispersion.ops.df32_gnlse import (
        make_df32_nl_planes,
    )

    co_df = dv.make_df32_vgnlse_coeffs(
        co.gamma, co.alpha, float(co.b_xpm), co.lin_phase,
        dz_m=cfg.dz, B=3, T=T)
    pk, y, ok = dv.run_v_reduce_eager(
        ctf_from_c128(A0), co_df, 7, 3, coherent=float(co.coherent),
        nlp=make_df32_nl_planes(nl_df), f_r=float(nl_df.f_r),
        inv_w0=float(nl_df.inv_w0))
    assert bool(np.all(np.asarray(ok)))

    _g, co64, _ = _setup(B=3, T=T, precision="x64", coupling="isotropic",
                         spec=True)
    nl64 = gn.make_nl_terms(grid, f_raman=0.18, omega0=1.2e15,
                            precision="x64")
    _pk_r, A_r, _ok_r = vg.solve_vgnlse_batch(
        _cfg(precision="x64"), co64, A0, nl=nl64)
    A_df = ctf_to_c128(y)
    assert np.abs(A_df - A_r).max() / np.abs(A_r).max() < 1e-11


@needs_full
def test_jitted_df32_vgnlse_generalized_nl_matches_x64_1e9():
    """Matched-tolerance bar for the vector generalized operator: jitted
    df32 with nl terms within 1e-9 of the x64 CPU solver."""
    import jax

    B, T, steps = 2, 128, 100
    grid = gn.TimeGrid.for_pulse(T0, n_samples=T)
    _g, co, A0 = _setup(B=B, T=T, coupling="cnlse")
    nl_df = gn.make_nl_terms(grid, f_raman=0.18, omega0=1.2e15,
                             precision="df32")
    cfg = _cfg(n_steps=steps, save_every=20, zmax=1.0)
    pk, A_last, ok = vg.solve_vgnlse_batch(cfg, co, A0, nl=nl_df)
    assert ok.all()

    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        _g, co64, _ = _setup(B=B, T=T, precision="x64", coupling="cnlse")
        nl64 = gn.make_nl_terms(grid, f_raman=0.18, omega0=1.2e15,
                                precision="x64")
        cfg64 = _cfg(n_steps=steps, save_every=20, zmax=1.0,
                     precision="x64")
        _pk_r, A_r, ok_r = vg.solve_vgnlse_batch(cfg64, co64, A0, nl=nl64)
    assert ok_r.all()
    assert np.abs(A_last - A_r).max() / np.abs(A_r).max() < 1e-9


@needs_full
@pytest.mark.parametrize("coupling", ["cnlse", "isotropic"])
def test_jitted_df32_vgnlse_matches_x64_1e9(coupling):
    """Matched-tolerance bar for the vector family: jitted df32 within
    1e-9 of the x64 CPU solver over 200 split steps (rotation AND
    coherent-RK4 substeps)."""
    import jax

    B, T, steps = 3, 128, 200
    _grid, co, A0 = _setup(B=B, T=T, coupling=coupling)
    cfg = _cfg(n_steps=steps, save_every=20, zmax=2.0)
    pk, A_last, ok = vg.solve_vgnlse_batch(cfg, co, A0)
    assert ok.all()

    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        _g, co64, _ = _setup(B=B, T=T, precision="x64", coupling=coupling)
        cfg64 = _cfg(n_steps=steps, save_every=20, zmax=2.0,
                     precision="x64")
        pk_r, A_r, ok_r = vg.solve_vgnlse_batch(cfg64, co64, A0)
    assert np.abs(A_last - A_r).max() / np.abs(A_r).max() < 1e-9
    np.testing.assert_allclose(pk, pk_r, rtol=1e-9)


@needs_full
def test_jitted_df32_vgnlse_trajectory_and_resume():
    """run_vgnlse_simulation df32: trajectory matches x64 to 1e-9; a split
    run resumed from a saved row reproduces the tail bitwise; batch
    trajectories agree with reduce mode."""
    import jax

    T = 64
    _grid, co, A0b = _setup(B=2, T=T)
    A0 = A0b[0]
    cfg = _cfg(n_steps=60, save_every=10, zmax=0.6)
    z, A = vg.run_vgnlse_simulation(cfg, co, A0)
    assert A.shape == (7, 2, T)

    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        _g, co64, _ = _setup(B=2, T=T, precision="x64")
        _z64, A64 = vg.run_vgnlse_simulation(
            _cfg(n_steps=60, save_every=10, zmax=0.6, precision="x64"),
            co64, A0)
    assert np.abs(A - A64).max() / np.abs(A64).max() < 1e-9

    cfg_h = _cfg(n_steps=30, save_every=10, zmax=0.3)
    z1, A1 = vg.run_vgnlse_simulation(cfg_h, co, A0)
    _z2, A2 = vg.run_vgnlse_simulation(cfg_h, co, A1[-1], z0=float(z1[-1]))
    np.testing.assert_array_equal(np.concatenate([A1, A2[1:]]), A)

    _zt, At, _okt = vg.solve_vgnlse_batch_trajectories(cfg, co, A0b)
    _pk, A_last, _ok = vg.solve_vgnlse_batch(cfg, co, A0b)
    np.testing.assert_array_equal(At[:, -1], A_last)
    np.testing.assert_array_equal(At[0], A)


@needs_full
def test_jitted_df32_vgnlse_sharded_matches_unsharded():
    import jax

    from psa_simulation_ode_rk_mvp_dispersion.parallel.mesh import (
        default_mesh,
    )

    if len(jax.devices()) < 2:
        pytest.skip("needs >= 2 devices")
    B, T = 6, 64
    _grid, co, A0 = _setup(B=B, T=T)
    cfg = _cfg(n_steps=10, save_every=4, zmax=0.1)
    pk, A_last, ok = vg.solve_vgnlse_batch(cfg, co, A0)
    pk_s, A_s, ok_s = vg.solve_vgnlse_batch(cfg, co, A0, mesh=default_mesh())
    np.testing.assert_allclose(A_s, A_last, rtol=0, atol=0)
    np.testing.assert_allclose(pk_s, pk, rtol=0)
    np.testing.assert_array_equal(ok_s, ok)
