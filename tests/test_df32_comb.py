"""Matched-tolerance (df32) comb engine: ops/df32_comb.py.

CPU coverage is the EAGER component lane (XLA:CPU compiles two-float loop
bodies pathologically slowly -- CLAUDE.md constraint 4): the two-float FFT
against numpy's f64 FFT, the cubic coupling against the x64 evaluation, and
an eager few-step RK4 against the x64 scan solver.  The jitted chunked
solver (and the public solve_comb_batch df32 dispatch) runs on the opt-in
lane: PSA_DF32_FULL=1 (same gating as tests/test_df32.py).
"""

import os

import numpy as np
import pytest

import psa
from psa_simulation_ode_rk_mvp_dispersion.models import nwave as nw
from psa_simulation_ode_rk_mvp_dispersion.ops import df32_comb as dc
from psa_simulation_ode_rk_mvp_dispersion.ops.twofloat import (
    ctf_from_c128,
    ctf_to_c128,
)

_RUN_FULL = os.environ.get("PSA_DF32_FULL", "0") == "1"

needs_full = pytest.mark.skipif(
    not _RUN_FULL,
    reason="jitted df32 solver: XLA:CPU two-float compiles are pathological "
    "(opt in: PSA_DF32_FULL=1)",
)


def _random_state(b, n, seed=0):
    rng = np.random.default_rng(seed)
    a = (rng.normal(size=(b, n)) + 1j * rng.normal(size=(b, n))) * 1e-4
    a[:, n // 2 - 4] += 0.6
    a[:, n // 2 + 4] += 0.6 * np.exp(0.3j)
    return a




def test_tf_fft_matches_numpy_f64():
    rng = np.random.default_rng(1)
    x = (rng.normal(size=(3, 128)) + 1j * rng.normal(size=(3, 128)))
    x *= 10 ** rng.uniform(-6, 0, (3, 128))      # wide dynamic range
    F = ctf_to_c128(dc.tf_fft(ctf_from_c128(x)))
    ref = np.fft.fft(x, axis=-1)
    assert np.abs(F - ref).max() / np.abs(ref).max() < 1e-13
    # normalized inverse roundtrip
    back = ctf_to_c128(dc.tf_ifft(dc.tf_fft(ctf_from_c128(x))))
    assert np.abs(back - x).max() / np.abs(x).max() < 1e-13


def test_tf_fft_rejects_non_power_of_two():
    x = ctf_from_c128(np.ones(12, dtype=complex))
    with pytest.raises(ValueError, match="power of 2"):
        dc.tf_fft(x)


def test_polarization_df32_matches_x64():
    import jax.numpy as jnp

    a = _random_state(2, 64, seed=2)
    T_df = ctf_to_c128(dc.fwm_polarization_df32(ctf_from_c128(a)))
    T_ref = np.asarray(
        nw.fwm_polarization(jnp.asarray(a, dtype=jnp.complex128))
    )
    assert np.abs(T_df - T_ref).max() / np.abs(T_ref).max() < 1e-13


def test_eager_rk4_steps_match_x64():
    """A few eager compensated RK4 steps against the f64 stepper: the
    per-step arithmetic is double-double quality (~1e-14)."""
    import jax.numpy as jnp

    a = _random_state(2, 32, seed=3)
    gamma = np.array([0.01, 0.012])
    alpha = np.array([5e-5, 1e-4])
    rng = np.random.default_rng(4)
    beta = rng.normal(size=(2, 32)) * 1e-3

    c = dc.make_df32_comb_coeffs(gamma, alpha, beta)
    k = dc._make_consts(0.5)
    y = ctf_from_c128(a)
    for _ in range(3):
        y = dc.rk4_step_comb_df32(y, k, c)
    got = ctf_to_c128(y)

    co = nw.NWaveCoeffs(
        gamma=jnp.asarray(gamma), alpha=jnp.asarray(alpha),
        beta_lin=jnp.asarray(beta),
    )

    def rhs(yv):
        return np.asarray(nw.rhs_nwave(0.0, jnp.asarray(yv), co))

    ref, h = a.copy(), 0.5
    for _ in range(3):
        k1 = rhs(ref)
        k2 = rhs(ref + 0.5 * h * k1)
        k3 = rhs(ref + 0.5 * h * k2)
        k4 = rhs(ref + h * k3)
        ref = ref + (h / 6.0) * (k1 + 2.0 * (k2 + k3) + k4)
    assert np.abs(got - ref).max() / np.abs(ref).max() < 1e-12


def test_df32_dispatch_validation():
    """Public-surface guards: pallas+df32 and rk45+df32 raise; the comb
    trajectory runner rejects df32 (reduce-mode engine only)."""
    import dataclasses as dcl

    cfg = dcl.replace(
        psa.custom_simulation_config(z_max=1.0, dz=0.1, save_every=1),
        precision="df32",
    )
    grid = nw.CombGrid.centered(1.2e15, 2 * np.pi * 100e9, 16)
    disp = psa.DispersionParams.from_betas(1.2e15, beta2=-2e-26)
    co = nw.make_comb_coeffs(grid, disp, gamma_W_m=1e-3, precision="x32")
    A0 = _random_state(2, 16)
    # the comb has one engine: no engine= option is accepted
    with pytest.raises(TypeError, match="engine"):
        nw.solve_comb_batch(cfg, co, A0, engine="pallas")
    cfg45 = dcl.replace(cfg, integrator="rk45")
    with pytest.raises(ValueError, match="rk4"):
        nw.solve_comb_batch(cfg45, co, A0)
    with pytest.raises(ValueError, match="reduce-mode"):
        nw.run_comb_simulation(cfg, co, A0[0])


@needs_full
def test_jitted_df32_comb_matches_x64_1e9():
    """The BASELINE config-5 correctness bar: jitted df32 comb solve within
    1e-9 of the x64 CPU solver over 200 cascaded steps."""
    import dataclasses as dcl

    import jax

    B, N, steps = 4, 32, 200
    grid = nw.CombGrid.centered(1.2e15, 2 * np.pi * 100e9, N)
    disp = psa.DispersionParams.from_betas(1.2e15, beta2=-1e-27,
                                           beta3=1.2e-41)
    beta = nw.comb_beta_lin(grid, disp)
    A0 = _random_state(B, N, seed=5)
    gamma = np.linspace(5.0, 9.0, B)
    alpha = np.full(B, 5e-5)

    r = dc.solve_comb_batch_df32(
        A0, gamma, alpha, np.broadcast_to(beta, (B, N)),
        dz_m=0.005, n_steps=steps, save_every=20,
    )
    assert r.ok.all()

    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        cfg64 = dcl.replace(
            psa.custom_simulation_config(z_max=1.0, dz=0.005, save_every=20),
            precision="x64",
        )
        co = nw.NWaveCoeffs(
            gamma=gamma, alpha=alpha,
            beta_lin=np.broadcast_to(beta, (B, N)),
        )
        P_ref, A_ref, ok_ref = nw.solve_comb_batch(cfg64, co, A0,
                                                   coupling="fft")
    sig = P_ref > 1e-12
    rel = np.abs(r.P_max[sig] / P_ref[sig] - 1.0)
    assert rel.max() < 1e-9
    rel_A = np.abs(r.A_end - A_ref) / np.abs(A_ref).max()
    assert rel_A.max() < 1e-9


@needs_full
def test_jitted_df32_comb_sharded_matches_unsharded():
    import jax

    from psa_simulation_ode_rk_mvp_dispersion.parallel.mesh import (
        default_mesh,
    )

    if len(jax.devices()) < 2:
        pytest.skip("needs >= 2 devices")
    B, N, steps = 6, 32, 50   # pads over the mesh
    grid = nw.CombGrid.centered(1.2e15, 2 * np.pi * 100e9, N)
    disp = psa.DispersionParams.from_betas(1.2e15, beta2=-1e-27)
    beta = nw.comb_beta_lin(grid, disp)
    A0 = _random_state(B, N, seed=6)
    kw = dict(dz_m=0.005, n_steps=steps, save_every=10)
    r1 = dc.solve_comb_batch_df32(A0, 6.0, 5e-5, beta, **kw)
    r2 = dc.solve_comb_batch_df32(A0, 6.0, 5e-5, beta, mesh=default_mesh(),
                                  **kw)
    assert np.array_equal(r1.ok, r2.ok)
    np.testing.assert_array_equal(r1.P_max, r2.P_max)
    np.testing.assert_array_equal(r1.A_end, r2.A_end)


def test_tf_fft_properties():
    """Structural FFT properties at double-double precision: linearity,
    Parseval (energy), and the DC bin as the plain sum."""
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 64)) + 1j * rng.normal(size=(2, 64))
    y = rng.normal(size=(2, 64)) + 1j * rng.normal(size=(2, 64))
    a, b = 1.7, -0.4 + 0.9j

    Fxy = ctf_to_c128(dc.tf_fft(ctf_from_c128(a * x + b * y)))
    Fx = ctf_to_c128(dc.tf_fft(ctf_from_c128(x)))
    Fy = ctf_to_c128(dc.tf_fft(ctf_from_c128(y)))
    assert np.abs(Fxy - (a * Fx + b * Fy)).max() < 1e-12 * np.abs(Fxy).max()

    # Parseval: sum |X|^2 = L * sum |x|^2
    lhs = (np.abs(Fx) ** 2).sum(axis=-1)
    rhs = 64.0 * (np.abs(x) ** 2).sum(axis=-1)
    np.testing.assert_allclose(lhs, rhs, rtol=1e-13)

    # DC bin
    np.testing.assert_allclose(Fx[:, 0], x.sum(axis=-1), rtol=1e-13)
