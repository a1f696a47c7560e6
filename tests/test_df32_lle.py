"""Matched-tolerance (df32) LLE engine: ops/df32_lle.py.

Same lane split as the other df32 families (tests/test_df32_gnlse.py):
CPU runs the EAGER component checks (XLA:CPU two-float compiles are
pathological -- CLAUDE.md constraint 4); the jitted chunked solver and
the public ``solve_lle_batch`` df32 dispatch run on the opt-in lane
(PSA_DF32_FULL=1).

Oracles: the EXACT no-Kerr affine transient (the linear+drive step is
exact, so eager df32 must match the analytic law at two-float rounding,
~1e-13), and same-method parity against the x64 Strang solver."""

import os

import numpy as np
import pytest

import psa
from psa_simulation_ode_rk_mvp_dispersion.models import lle
from psa_simulation_ode_rk_mvp_dispersion.ops import df32_lle as dl
from psa_simulation_ode_rk_mvp_dispersion.ops.twofloat import (
    ctf_from_c128,
    ctf_to_c128,
    tf_to_f64,
)

_RUN_FULL = os.environ.get("PSA_DF32_FULL", "0") == "1"

needs_full = pytest.mark.skipif(
    not _RUN_FULL,
    reason="jitted df32 solver: XLA:CPU two-float compiles are pathological "
    "(opt in: PSA_DF32_FULL=1)",
)


GRID = lle.TimeGrid(n_samples=64, t_window_s=20.0)


def _x64_oracle(cfg, det, F, psi0):
    """x64 LLE solve pinned to the host CPU (same oracle pattern as
    tests/test_df32_gnlse.py)."""
    import jax

    with jax.default_device(jax.devices("cpu")[0]):
        co = lle.make_lle_coeffs(GRID, detuning=det, pump=F, d2=-1.0,
                                 precision="x64")
        pk, Al, ok = lle.solve_lle_batch(cfg, co, psi0)
    return pk, Al, ok


def test_affine_step_exact_transient_eager():
    """No Kerr (tiny pump): the eager df32 affine evolution matches the
    analytic psi_s (1 - e^{-(1+iD)t}) at two-float rounding."""
    det, F = 0.7, 1e-6
    T = GRID.n_samples
    dt, n = 0.25, 12
    co = dl.make_df32_lle_coeffs(det, F, np.zeros(T), dt=dt, B=1, T=T)
    y = ctf_from_c128(np.zeros((1, T), complex))
    psi_s = F / (1 + 1j * det)
    for j in range(1, n + 1):
        y = dl.lle_steps_df32(y, co, 1, unroll=True)
        ana = psi_s * (1 - np.exp(-(1 + 1j * det) * j * dt))
        got = ctf_to_c128(y)[0, 0]
        # two-float rounding accumulates ~1e-16/step of the scale here
        assert abs(got - ana) / abs(psi_s) < 5e-12, (j, got, ana)


def test_eager_reduce_matches_x64_solver():
    """Eager df32 Strang steps vs the x64 LLE solver: same method, so the
    difference is pure rounding (<=1e-11 over 40 steps on a driven
    nonlinear state)."""
    det, F = 2.0, 1.4
    B, T = 3, GRID.n_samples
    rng = np.random.default_rng(7)
    base = lle.cw_state(det, F, lle.cw_steady_states(det, F)[0])
    psi0 = base + 0.05 * (rng.standard_normal((B, T))
                          + 1j * rng.standard_normal((B, T)))
    dt, n_steps, save_every = 0.02, 40, 10
    cfg = psa.custom_simulation_config(z_max=dt * n_steps, dz=dt,
                                       save_every=save_every)
    pk64, A64, ok64 = _x64_oracle(cfg, det, F, psi0)
    assert ok64.all()

    # same dispersion phase as the oracle (d2 = -1 on this grid)
    ph = np.asarray(lle.make_lle_coeffs(GRID, detuning=det, pump=F,
                                        d2=-1.0,
                                        precision="df32").lin_phase)
    co = dl.make_df32_lle_coeffs(det, F, ph, dt=dt, B=B, T=T)
    pk, y, ok = dl.run_reduce_eager(ctf_from_c128(psi0), co, n_steps,
                                    save_every)
    assert np.all(np.asarray(ok))
    A = ctf_to_c128(y)
    rel_A = np.max(np.abs(A - A64)) / np.max(np.abs(A64))
    rel_pk = np.max(np.abs(tf_to_f64(pk) - pk64) / pk64)
    assert rel_A < 1e-11, rel_A
    assert rel_pk < 1e-11, rel_pk


@needs_full
def test_jitted_batch_df32_matches_x64():
    """Public solve_lle_batch df32 dispatch vs the x64 solver: <=1e-9
    (matched tolerance) over 200 steps of a driven soliton state."""
    det, F = 4.0, 2.0
    seed = lle.soliton_ansatz(GRID, det, F, -1.0)
    B = 4
    psi0 = np.stack([seed * s for s in (1.0, 0.98, 1.02, 0.95)])
    dt, n_steps = 0.01, 200
    cfg = psa.custom_simulation_config(z_max=dt * n_steps, dz=dt,
                                       save_every=50, precision="df32")
    co_df = lle.make_lle_coeffs(GRID, detuning=det, pump=F, d2=-1.0,
                                precision="df32")
    pk, Al, ok = lle.solve_lle_batch(cfg, co_df, psi0)
    assert ok.all()

    cfg64 = psa.custom_simulation_config(z_max=dt * n_steps, dz=dt,
                                         save_every=50, precision="x64")
    pk64, Al64, ok64 = _x64_oracle(cfg64, det, F, psi0)
    assert ok64.all()
    rel_A = np.max(np.abs(Al - Al64)) / np.max(np.abs(Al64))
    rel_pk = np.max(np.abs(pk - pk64) / pk64)
    assert rel_A < 1e-9, rel_A
    assert rel_pk < 1e-9, rel_pk
    # trajectory mode: last row == reduce-mode state bitwise
    t, Atr, ok_t = lle.solve_lle_batch_trajectories(cfg, co_df, psi0)
    assert ok_t.all()
    np.testing.assert_array_equal(Atr[:, -1], Al)
    # runner == B=1 row
    tz, A1 = lle.run_lle_simulation(cfg, co_df, psi0[0])
    np.testing.assert_array_equal(A1[-1], Atr[0, -1])


@needs_full
def test_jitted_df32_sharded_bit_identical():
    from psa_simulation_ode_rk_mvp_dispersion.parallel.mesh import (
        default_mesh,
    )

    det = np.linspace(0.5, 3.5, 8)
    co_df = lle.make_lle_coeffs(GRID, detuning=det, pump=1.5, d2=-1.0,
                                precision="df32")
    rng = np.random.default_rng(3)
    psi0 = 0.1 + 1e-2 * (rng.standard_normal((8, GRID.n_samples))
                         + 1j * rng.standard_normal((8, GRID.n_samples)))
    cfg = psa.custom_simulation_config(z_max=0.4, dz=0.02, save_every=5,
                                       precision="df32")
    pk_u, Al_u, ok_u = lle.solve_lle_batch(cfg, co_df, psi0)
    mesh = default_mesh()
    if mesh is None or int(np.prod(list(mesh.shape.values()))) < 2:
        pytest.skip("needs a multi-device mesh")
    pk_s, Al_s, ok_s = lle.solve_lle_batch(cfg, co_df, psi0, mesh=mesh)
    np.testing.assert_array_equal(pk_s, pk_u)
    np.testing.assert_array_equal(Al_s, Al_u)
    np.testing.assert_array_equal(ok_s, ok_u)
