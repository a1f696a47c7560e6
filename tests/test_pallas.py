"""The fused Triton RK4 kernel (ops/pallas_solver.py) and the engine choice.

On the CPU the kernel runs in the Pallas interpreter against the XLA scan
(``integrate_reduce``'s contract); the compiled kernel runs in the tests
marked ``gpu`` (the GPU lane, see conftest.py), which call the same helpers
as ``chip_smoke.py``.
"""

import jax
import numpy as np
import pytest

import psa
from psa_simulation_ode_rk_mvp_dispersion.ops import pallas_solver as ps
from psa_simulation_ode_rk_mvp_dispersion.ops.rhs import RHSCoeffs
from psa_simulation_ode_rk_mvp_dispersion.parallel import mesh as pmesh
from psa_simulation_ode_rk_mvp_dispersion.parallel import sweep as sw

DTYPES = {"x64": np.float64, "x32": np.float32}
# kernel vs scan: same arithmetic, different operation order / contraction
TOL = {"x64": 1e-12, "x32": 2e-5}


def _case(B=9, seed=0):
    rng = np.random.default_rng(seed)
    p_in = np.array([0.1, 0.1, 1e-6, 1e-7])
    A0 = (np.sqrt(p_in) * np.exp(1j * rng.uniform(0, 2 * np.pi, (B, 4))))
    gamma = np.full(B, 0.0115)
    alpha = np.full(B, 1.15e-4)
    dbeta = rng.uniform(-0.05, 0.05, B)
    return A0, gamma, alpha, dbeta


def _scan(A0, gamma, alpha, dbeta, *, n_steps, save_every, prec, dz=0.2):
    cfg = psa.custom_simulation_config(z_max=n_steps * dz, dz=dz,
                                       save_every=save_every, precision=prec)
    return sw.solve_batch(
        cfg, RHSCoeffs(gamma=gamma, alpha=alpha, delta_beta=dbeta), A0,
        frame="rotating", engine="scan")


def _kernel(A0, gamma, alpha, dbeta, *, n_steps, save_every, prec, dz=0.2,
            **kw):
    return ps.solve_batch_pallas(
        A0, gamma, alpha, dbeta, dz_m=dz, n_steps=n_steps,
        save_every=save_every, dtype=DTYPES[prec], interpret=True, **kw)


def _assert_close(r, s, prec):
    np.testing.assert_array_equal(r.ok, s.ok)
    np.testing.assert_allclose(r.P_max, s.P_max, rtol=TOL[prec], atol=0)
    np.testing.assert_allclose(r.A_end, s.A_end, rtol=TOL[prec],
                               atol=TOL[prec] * np.abs(s.A_end).max())


# ---------------------------------------------------------------------------
# Interpret mode against the scan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("prec", ["x64", "x32"])
@pytest.mark.parametrize("n_steps,save_every", [
    (250, 10),   # whole chunks
    (255, 10),   # trailing remainder: integrated, not observed
    (7, 10),     # no saved step beyond row 0
    (40, 1),     # every step saved
    (30, 7),     # remainder with an odd save grid
])
def test_kernel_matches_scan(prec, n_steps, save_every):
    A0, gamma, alpha, dbeta = _case()
    kw = dict(n_steps=n_steps, save_every=save_every, prec=prec)
    r = _kernel(A0, gamma, alpha, dbeta, **kw)
    s = _scan(A0, gamma, alpha, dbeta, **kw)
    assert r.ok.all()
    _assert_close(r, s, prec)


def test_pallas_matches_x64_scan():
    """The x32 kernel tracks the x64 scan to f32 class over 250 steps."""
    A0, gamma, alpha, dbeta = _case()
    r = _kernel(A0, gamma, alpha, dbeta, n_steps=250, save_every=10,
                prec="x32")
    r64 = _scan(A0, gamma, alpha, dbeta, n_steps=250, save_every=10,
                prec="x64")
    assert np.all(r.ok)
    np.testing.assert_allclose(r.P_max, r64.P_max, rtol=3e-5, atol=1e-12)
    np.testing.assert_allclose(r.A_end, r64.A_end, rtol=1e-4, atol=1e-9)


def test_pallas_nan_lane_masking():
    A0 = np.array([[0.3, 0.3, 1e-3, 0.0], [1e4, 1e4, 1.0, 0.0]],
                  dtype=np.complex128)
    r = ps.solve_batch_pallas(
        A0, gamma=np.array([0.01, 1e3]), alpha=np.zeros(2),
        delta_beta=np.zeros(2), dz_m=0.5, n_steps=40, save_every=10,
        interpret=True,
    )
    assert r.ok[0] and not r.ok[1]
    assert np.all(np.isfinite(r.P_max))


def test_pallas_lane_padding_exact():
    """Batches pad internally and slice back exactly."""
    A0, gamma, alpha, dbeta = _case(B=7, seed=2)
    kw = dict(n_steps=50, save_every=10, prec="x64")
    r7 = _kernel(A0, gamma, alpha, dbeta, **kw)
    r1 = _kernel(A0[:1], gamma[:1], alpha[:1], dbeta[:1], **kw)
    np.testing.assert_allclose(r7.P_max[0], r1.P_max[0], rtol=1e-12)


@pytest.mark.parametrize("B", [1, 127, 129, 1000])
def test_kernel_batch_not_multiple_of_block(B):
    """Batches pad to the lane block with edge-replicated lanes and slice
    back; every lane matches the scan."""
    A0, gamma, alpha, dbeta = _case(B=B, seed=B)
    kw = dict(n_steps=20, save_every=5, prec="x64")
    r = _kernel(A0, gamma, alpha, dbeta, **kw)
    s = _scan(A0, gamma, alpha, dbeta, **kw)
    assert r.P_max.shape == (B, 4) and r.A_end.shape == (B, 4)
    _assert_close(r, s, "x64")


@pytest.mark.parametrize("prec", ["x64", "x32"])
def test_kernel_nan_lane_freezes(prec):
    """A blowing-up lane clears ok and freezes at its last finite state,
    without touching its neighbours -- as the scan does."""
    A0 = np.array([[0.3, 0.3, 1e-3, 0.0], [1e4, 1e4, 1.0, 0.0],
                   [0.2, 0.2, 1e-4, 0.0]], dtype=np.complex128)
    gamma = np.array([0.01, 1e3, 0.02])
    kw = dict(n_steps=40, save_every=10, prec=prec, dz=0.5)
    r = _kernel(A0, gamma, np.zeros(3), np.zeros(3), **kw)
    s = _scan(A0, gamma, np.zeros(3), np.zeros(3), **kw)
    np.testing.assert_array_equal(r.ok, [True, False, True])
    np.testing.assert_array_equal(r.ok, s.ok)
    assert np.all(np.isfinite(r.P_max))
    np.testing.assert_allclose(r.P_max[r.ok], s.P_max[s.ok], rtol=TOL[prec])


@pytest.mark.parametrize("prec", ["x64", "x32"])
def test_kernel_sharded_bit_identical(prec):
    """shard_map over the 8 virtual CPU devices: one launch per device, no
    collectives -- bit-identical to the unsharded kernel."""
    A0, gamma, alpha, dbeta = _case(B=45, seed=3)
    kw = dict(n_steps=30, save_every=10, prec=prec)
    mesh = pmesh.default_mesh()
    assert mesh is not None and mesh.devices.size == 8
    r1 = _kernel(A0, gamma, alpha, dbeta, **kw)
    r2 = _kernel(A0, gamma, alpha, dbeta, mesh=mesh, **kw)
    np.testing.assert_array_equal(r2.P_max, r1.P_max)
    np.testing.assert_array_equal(r2.A_end, r1.A_end)
    np.testing.assert_array_equal(r2.ok, r1.ok)


@pytest.mark.parametrize("block", [32, 64, 128])
def test_kernel_block_size_does_not_change_results(block):
    A0, gamma, alpha, dbeta = _case(B=70, seed=4)
    kw = dict(n_steps=20, save_every=10, prec="x64")
    ref = _kernel(A0, gamma, alpha, dbeta, **kw)
    r = _kernel(A0, gamma, alpha, dbeta, block=block, **kw)
    np.testing.assert_array_equal(r.P_max, ref.P_max)
    np.testing.assert_array_equal(r.A_end, ref.A_end)


@pytest.mark.parametrize("n_lanes,block", [
    (1, 32), (10_000, 32), (264 * 32, 32), (264 * 64, 64),
    (264 * 128, 128), (250_000, 128),
])
def test_lane_block_fills_the_card(n_lanes, block):
    """The largest block that still gives every SM two programs."""
    assert ps.lane_block(n_lanes) == block


def test_kernel_input_validation():
    A0, gamma, alpha, dbeta = _case(B=3)
    with pytest.raises(ValueError, match="shape"):
        ps.solve_batch_pallas(A0[:, :3], gamma, alpha, dbeta, dz_m=0.2,
                              n_steps=2, save_every=1, interpret=True)
    with pytest.raises(ValueError, match="dtype"):
        ps.solve_batch_pallas(A0, gamma, alpha, dbeta, dz_m=0.2, n_steps=2,
                              save_every=1, dtype=np.float16, interpret=True)


# ---------------------------------------------------------------------------
# Engine choice (parallel/sweep.use_kernel)
# ---------------------------------------------------------------------------

def _no_kernel(monkeypatch):
    calls = []
    monkeypatch.setattr(ps, "solve_batch_pallas",
                        lambda *a, **k: calls.append(1))
    return calls


def test_auto_on_cpu_takes_the_scan(monkeypatch):
    calls = _no_kernel(monkeypatch)
    A0, gamma, alpha, dbeta = _case(B=4)
    r = _scan(A0, gamma, alpha, dbeta, n_steps=10, save_every=5, prec="x64")
    cfg = psa.custom_simulation_config(z_max=2.0, dz=0.2, save_every=5)
    a = sw.solve_batch(cfg, RHSCoeffs(gamma=gamma, alpha=alpha,
                                      delta_beta=dbeta), A0, engine="auto")
    assert calls == []
    np.testing.assert_array_equal(a.P_max, r.P_max)


def test_engine_pallas_off_gpu_raises_and_never_interprets(monkeypatch):
    calls = _no_kernel(monkeypatch)
    A0, gamma, alpha, dbeta = _case(B=3)
    cfg = psa.custom_simulation_config(z_max=2.0, dz=0.2, precision="x32")
    with pytest.raises(ValueError, match="GPU"):
        sw.solve_batch(cfg, RHSCoeffs(gamma=gamma, alpha=alpha,
                                      delta_beta=dbeta), A0, engine="pallas")
    assert calls == []


@pytest.mark.parametrize("cfg_kw,frame", [
    (dict(integrator="rk45"), "rotating"),
    (dict(integrator="ab4"), "rotating"),
    (dict(precision="df32"), "rotating"),
    (dict(), "lab"),
])
def test_engine_pallas_outside_the_kernel_contract_raises(cfg_kw, frame):
    A0, gamma, alpha, dbeta = _case(B=3)
    cfg = psa.custom_simulation_config(z_max=2.0, dz=0.2, **cfg_kw)
    with pytest.raises(ValueError, match="pallas"):
        sw.solve_batch(cfg, RHSCoeffs(gamma=gamma, alpha=alpha,
                                      delta_beta=dbeta), A0, frame=frame,
                       engine="pallas")


def test_pallas_engine_validation():
    """engine='pallas' off a GPU raises; so does an unknown engine."""
    A0, gamma, alpha, dbeta = _case(B=3)
    cfg = psa.custom_simulation_config(z_max=2.0, dz=0.2, precision="x64")
    c = RHSCoeffs(gamma=gamma, alpha=alpha, delta_beta=dbeta)
    with pytest.raises(ValueError, match="pallas"):
        sw.solve_batch(cfg, c, A0, frame="rotating", engine="pallas")
    with pytest.raises(ValueError, match="engine"):
        sw.solve_batch(cfg, c, A0, engine="cuda")


def test_engine_name_validated():
    A0, gamma, alpha, dbeta = _case(B=3)
    cfg = psa.custom_simulation_config(z_max=2.0, dz=0.2)
    with pytest.raises(ValueError, match="engine"):
        sw.solve_batch(cfg, RHSCoeffs(gamma=gamma, alpha=alpha,
                                      delta_beta=dbeta), A0, engine="cuda")


@pytest.mark.parametrize("engine,precision,frame,integrator,want", [
    ("auto", "x64", "rotating", "rk4", True),
    ("auto", "x32", "rotating", "rk4", True),
    ("pallas", "x64", "rotating", "rk4", True),
    ("scan", "x64", "rotating", "rk4", False),
    ("auto", "df32", "rotating", "rk4", False),
    ("auto", "x64", "lab", "rk4", False),
    ("auto", "x64", "rotating", "rk45", False),
    ("auto", "x32", "rotating", "abm4", False),
])
def test_use_kernel_on_a_gpu(monkeypatch, engine, precision, frame,
                             integrator, want):
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert sw.use_kernel(engine, precision=precision, frame=frame,
                         integrator=integrator) is want


def _interpreted_kernel(monkeypatch):
    """Pretend to be on a GPU, with the kernel run by the interpreter."""
    real = ps.solve_batch_pallas
    calls = []

    def interpreted(*a, **k):
        calls.append(k.get("mesh"))
        return real(*a, interpret=True, **k)

    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    monkeypatch.setattr(ps, "solve_batch_pallas", interpreted)
    return calls


def _spectrum_kw(prec):
    return dict(
        cfg=psa.custom_simulation_config(z_max=20.0, dz=0.2, save_every=10,
                                         precision=prec),
        lambda_p1_m=1550e-9, lambda_p2_m=1555e-9,
        lambda_signal_m=np.linspace(1540e-9, 1650e-9, 11),
        gamma=11.5e-3, alpha=1.15e-4, p_in=[0.5, 0.5, 1e-7, 1e-7],
        phase_matching_cfg=psa.PhaseMatchingConfig(
            method=psa.PhaseMatchingMethod.PROVIDED,
            provided_delta_beta=0.01),
        gain_unit="linear",
    )


def test_pallas_engine_through_solve_batch(monkeypatch):
    """engine='pallas' through the public solve_batch on a GPU (the kernel
    interpreted here) matches the scan."""
    A0, gamma, alpha, dbeta = _case(B=5, seed=1)
    cfg32 = psa.custom_simulation_config(z_max=20.0, dz=0.2, precision="x32")
    c = RHSCoeffs(gamma=gamma, alpha=alpha, delta_beta=dbeta)
    rs = sw.solve_batch(cfg32, c, A0, frame="rotating", engine="scan")
    calls = _interpreted_kernel(monkeypatch)
    rp = sw.solve_batch(cfg32, c, A0, frame="rotating", engine="pallas")
    assert calls == [None]
    np.testing.assert_allclose(rp.P_max, rs.P_max, rtol=1e-5, atol=1e-12)
    assert np.array_equal(rp.ok, rs.ok)


@pytest.mark.parametrize("prec", ["x64", "x32"])
def test_gain_spectrum_routes_through_the_kernel(monkeypatch, prec):
    """engine='auto' on a GPU: gain_spectrum runs the kernel (interpreted
    here) and agrees with the scan."""
    ref = sw.gain_spectrum(engine="scan", **_spectrum_kw(prec))
    calls = _interpreted_kernel(monkeypatch)
    got = sw.gain_spectrum(engine="auto", **_spectrum_kw(prec))
    assert calls == [None]
    np.testing.assert_allclose(got.gain, ref.gain, rtol=TOL[prec])


def test_sharded_sweep_routes_the_mesh_to_the_kernel(monkeypatch):
    mesh = pmesh.default_mesh()
    ref = sw.gain_spectrum(engine="scan", mesh=mesh, **_spectrum_kw("x64"))
    calls = _interpreted_kernel(monkeypatch)
    got = sw.gain_spectrum(engine="auto", mesh=mesh, **_spectrum_kw("x64"))
    assert calls == [mesh]
    np.testing.assert_allclose(got.gain, ref.gain, rtol=1e-12)


# ---------------------------------------------------------------------------
# The GPU lane: the compiled kernel, through chip_smoke's own phases
# ---------------------------------------------------------------------------

@pytest.mark.gpu
def test_gpu_golden_references():
    import chip_smoke

    chip_smoke.phase_golden(jax, psa)


@pytest.mark.gpu
def test_gpu_headline_kernel_vs_scan():
    import chip_smoke

    chip_smoke.phase_headline(jax, psa)


@pytest.mark.gpu
def test_gpu_families_vs_cpu():
    import chip_smoke

    chip_smoke.phase_families(jax, psa)
