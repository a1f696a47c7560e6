"""Frequency-plan layer tests: conversions, symmetric plan, energy
conservation, batch broadcasting, golden parity with the reference."""

import json
from pathlib import Path

import numpy as np
import pytest

import psa
from psa_simulation_ode_rk_mvp_dispersion.ops import frequency_plan as fp

GOLDEN = json.loads((Path(__file__).parent / "golden" / "golden_scalars.json").read_text())


def test_lambda_omega_roundtrip():
    lam = np.array([1540e-9, 1550e-9, 1565e-9])
    om = np.asarray(fp.omega_from_lambda(lam))
    back = np.asarray(fp.lambda_from_omega(om))
    np.testing.assert_allclose(back, lam, rtol=1e-15)


def test_f_omega_roundtrip():
    f = 193.4e12
    om = float(fp.omega_from_f(f))
    assert float(fp.f_from_omega(om)) == pytest.approx(f, rel=1e-15)


def test_conversion_rejects_nonpositive():
    with pytest.raises(ValueError):
        fp.omega_from_lambda(-1550e-9)
    with pytest.raises(ValueError):
        fp.lambda_from_omega(0.0)


def test_plan_from_wavelengths_golden():
    om = np.asarray(fp.plan_from_wavelengths(1550e-9, 1560e-9, 1555e-9))
    np.testing.assert_allclose(
        om, np.array(GOLDEN["plan_1550_1560_1555_omegas"]), rtol=1e-15
    )


def test_plan_energy_conservation_exact():
    om = np.asarray(fp.plan_from_wavelengths(1550e-9, 1558e-9, 1552e-9))
    assert (om[0] + om[1]) == pytest.approx(om[2] + om[3], rel=1e-15)


def test_plan_from_omegas_validates_conservation():
    om = np.asarray(fp.plan_from_wavelengths(1550e-9, 1560e-9, 1555e-9))
    with pytest.raises(ValueError, match="Energy conservation"):
        fp.plan_from_omegas(om[0], om[1], om[2], om[3] * 1.001)


def test_infer_symmetry_golden():
    om = np.array(GOLDEN["plan_1550_1560_1555_omegas"])
    sp = fp.infer_symmetry_from_omegas(om[0], om[1], om[2], om[3])
    g = GOLDEN["plan_symmetric"]
    assert float(sp.omega_c) == pytest.approx(g["omega_c"], rel=1e-15)
    assert float(sp.omega_d) == pytest.approx(g["omega_d"], rel=1e-12)
    assert float(sp.Omega) == pytest.approx(g["Omega"], rel=1e-12)


def test_symmetric_plan_roundtrip():
    sp = fp.SymmetricPlan(
        omega_c=np.asarray(1.2e15), omega_d=np.asarray(5e11), Omega=np.asarray(-3e11)
    )
    om = np.asarray(sp.omegas())
    sp2 = fp.infer_symmetry_from_omegas(om[0], om[1], om[2], om[3])
    assert float(sp2.omega_c) == pytest.approx(1.2e15, rel=1e-15)
    assert float(sp2.omega_d) == pytest.approx(5e11, rel=1e-12)
    assert float(sp2.Omega) == pytest.approx(-3e11, rel=1e-12)


def test_symmetric_plan_rejects_large_omega_d():
    with pytest.raises(ValueError, match="omega_d"):
        fp.SymmetricPlan(
            omega_c=np.asarray(1.0e15), omega_d=np.asarray(1.5e15), Omega=np.asarray(0.0)
        )


def test_plan_from_wavelengths_batched():
    """The sweep entry point: a (B,) lambda3 grid produces a (B, 4) plan in
    one vectorized call, matching per-point scalar construction."""
    lam3 = np.linspace(1540e-9, 1565e-9, 11)
    om_b = np.asarray(fp.plan_from_wavelengths(1550e-9, 1558e-9, lam3))
    assert om_b.shape == (11, 4)
    for i, l3 in enumerate(lam3):
        om_i = np.asarray(fp.plan_from_wavelengths(1550e-9, 1558e-9, float(l3)))
        np.testing.assert_array_equal(om_b[i], om_i)


def test_describe_plan_mentions_waves():
    om = np.asarray(fp.plan_from_wavelengths(1550e-9, 1560e-9, 1555e-9))
    text = fp.describe_plan(om)
    for w in ("pump1", "pump2", "signal", "idler"):
        assert w in text
