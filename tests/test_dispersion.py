"""Dispersion-layer tests: unit conversions, beta builders, Taylor evaluation,
delta-beta formulas, golden parity with the reference (including the
documented reference beta4 defect, reproduced only under the compat flag)."""

import json
from pathlib import Path

import numpy as np
import pytest

from psa_simulation_ode_rk_mvp_dispersion.ops import dispersion as dm
from psa_simulation_ode_rk_mvp_dispersion.ops import frequency_plan as fp
from psa_simulation_ode_rk_mvp_dispersion.utils import units

GOLDEN = json.loads((Path(__file__).parent / "golden" / "golden_scalars.json").read_text())


def test_unit_conversions():
    assert units.D_ps_nm_km_to_SI(1.0) == pytest.approx(1e-6)
    assert units.S_ps_nm2_km_to_SI(1.0) == pytest.approx(1e3)
    assert units.dSdlmbd_ps_nm3_km_to_SI(1.0) == pytest.approx(1e12)


def test_beta_builders_golden():
    lc = GOLDEN["lambda_c"]
    assert dm.beta2_from_D(lc, 2e-8) == pytest.approx(GOLDEN["beta2_from_D"], rel=1e-15)
    assert dm.beta3_from_D_S(lc, 2e-8, 20.0) == pytest.approx(
        GOLDEN["beta3_from_D_S"], rel=1e-15
    )
    assert dm.beta4_from_D_S(lc, 2e-8, 20.0, 5e11) == pytest.approx(
        GOLDEN["beta4_from_D_S"], rel=1e-15
    )


@pytest.mark.parametrize("case", GOLDEN["dispersion_from_D_S"])
def test_dispersion_from_D_S_compat_matches_reference(case):
    """With the compat flag, the builder reproduces the reference's outputs
    bit-for-bit, including its beta4 defect (reference dispersion.py:455)."""
    oc = GOLDEN["plan_symmetric"]["omega_c"]
    d = dm.dispersion_params_from_D_S(
        lambda_ref_m=GOLDEN["lambda_c"], D=case["D"], S=case["S"], dSdlmbd=case["dSdlmbd"],
        D_units="ps/nm/km", S_units="ps/nm^2/km", dSdlmbd_units="ps/nm^3/km",
        omega_ref=oc, compat_reference_beta4_bug=True,
    )
    assert float(d.beta2) == pytest.approx(case["beta2"], rel=1e-15)
    assert float(d.beta3) == pytest.approx(case["beta3"], rel=1e-15)
    assert float(d.beta4) == pytest.approx(case["beta4"], rel=1e-15)


def test_dispersion_from_D_S_default_fixes_beta4_bug():
    """Default (non-compat) builder keeps the 6D term the reference drops."""
    lc = GOLDEN["lambda_c"]
    oc = GOLDEN["plan_symmetric"]["omega_c"]
    kwargs = dict(
        lambda_ref_m=lc, D=0.2, S=0.06, dSdlmbd=0.0,
        D_units="ps/nm/km", S_units="ps/nm^2/km", dSdlmbd_units="ps/nm^3/km",
        omega_ref=oc,
    )
    d_fixed = dm.dispersion_params_from_D_S(**kwargs)
    expected_b4 = dm.beta4_from_D_S(
        lc, units.D_ps_nm_km_to_SI(0.2), units.S_ps_nm2_km_to_SI(0.06), 0.0
    )
    assert float(d_fixed.beta4) == pytest.approx(expected_b4, rel=1e-15)
    # compat version differs whenever D != dSdlmbd
    d_bug = dm.dispersion_params_from_D_S(**kwargs, compat_reference_beta4_bug=True)
    assert abs(float(d_bug.beta4) / expected_b4 - 1.0) > 1e-6


def test_from_betas_named_access_and_extra():
    d = dm.DispersionParams.from_betas(
        1.2e15, beta0=1.0, beta2=-2e-27, beta4=3e-55, extra={6: 1e-80}
    )
    assert float(d.beta0) == 1.0
    assert float(d.beta1) == 0.0
    assert float(d.beta2) == -2e-27
    assert float(d.beta4) == 3e-55
    assert float(d.get_beta_n(6)) == 1e-80
    assert float(d.get_beta_n(9)) == 0.0
    assert d.available_orders() == (0, 2, 4, 6)


def test_from_betas_validation():
    with pytest.raises(ValueError):
        dm.DispersionParams.from_betas(-1.0, beta2=1e-27)
    with pytest.raises(TypeError):
        dm.DispersionParams.from_betas(1.2e15, extra={"2": 1.0})
    with pytest.raises(ValueError):
        dm.DispersionParams.from_betas(1.2e15, extra={-1: 1.0})


def test_beta_taylor_golden():
    oc = GOLDEN["plan_symmetric"]["omega_c"]
    case = GOLDEN["dispersion_from_D_S"][1]  # D=0.1, S=0.02, dS=0
    d = dm.DispersionParams.from_betas(
        oc, beta2=case["beta2"], beta3=case["beta3"], beta4=case["beta4"]
    )
    om = np.array(GOLDEN["beta_taylor_omegas"])
    vals = np.asarray(dm.beta_taylor(om, d, max_order=4))
    np.testing.assert_allclose(vals, np.array(GOLDEN["beta_taylor_values"]), rtol=1e-12)


def test_beta_taylor_max_order_truncation():
    d = dm.DispersionParams.from_betas(1.0e15, beta1=2.0e-9, beta2=3e-27, beta3=4e-41)
    w = 1.0e15 + 1.0e12
    dw = 1.0e12
    b2 = float(dm.beta_taylor(w, d, max_order=2))
    assert b2 == pytest.approx(2.0e-9 * dw + 0.5 * 3e-27 * dw**2, rel=1e-14)
    b1 = float(dm.beta_taylor(w, d, max_order=1))
    assert b1 == pytest.approx(2.0e-9 * dw, rel=1e-14)


def test_delta_beta_formulas_golden():
    oc = GOLDEN["plan_symmetric"]["omega_c"]
    case = GOLDEN["dispersion_from_D_S"][1]
    d = dm.DispersionParams.from_betas(
        oc, beta2=case["beta2"], beta3=case["beta3"], beta4=case["beta4"]
    )
    om = np.array(GOLDEN["plan_1550_1560_1555_omegas"])
    db_gen = float(dm.delta_beta_from_omegas(om, d, max_order=4))
    assert db_gen == pytest.approx(GOLDEN["delta_beta_from_omegas"], rel=1e-12)
    sym = GOLDEN["plan_symmetric"]
    db_sym = float(
        dm.delta_beta_symmetric(sym["omega_c"], sym["omega_d"], sym["Omega"], d)
    )
    assert db_sym == pytest.approx(GOLDEN["delta_beta_symmetric_24"], rel=1e-12)


def test_delta_beta_symmetric_equals_general_for_even_disp():
    """For a pure even-order dispersion expanded at omega_c, the symmetric
    closed form and the general Taylor assembly agree analytically."""
    oc = 1.216e15
    d = dm.DispersionParams.from_betas(oc, beta2=-2.5e-29, beta4=3e-55)
    rng = np.random.default_rng(0)
    for _ in range(5):
        od = rng.uniform(-3e12, 3e12)
        Om = rng.uniform(-8e12, 8e12)
        sp = fp.SymmetricPlan(
            omega_c=np.asarray(oc), omega_d=np.asarray(od), Omega=np.asarray(Om)
        )
        om = np.asarray(sp.omegas())
        db_g = float(dm.delta_beta_from_omegas(om, d, max_order=4))
        db_s = float(dm.delta_beta_symmetric(oc, od, Om, d))
        assert db_s == pytest.approx(db_g, rel=1e-9, abs=1e-18)


def test_delta_beta_symmetric_batched():
    d = dm.DispersionParams.from_betas(1.2e15, beta2=-2.5e-29, beta4=3e-55)
    Om = np.linspace(-5e12, 5e12, 17)
    db = np.asarray(dm.delta_beta_symmetric(1.2e15, 1e12, Om, d))
    assert db.shape == Om.shape
    for i in range(17):
        assert db[i] == pytest.approx(
            float(dm.delta_beta_symmetric(1.2e15, 1e12, float(Om[i]), d)), rel=1e-15
        )


def test_delta_beta_rejects_energy_violation():
    d = dm.DispersionParams.from_betas(1.2e15, beta2=-2.5e-29)
    om = np.array([1.2e15, 1.2e15, 1.21e15, 1.2e15])  # violates conservation
    with pytest.raises(ValueError, match="Energy conservation"):
        dm.delta_beta_from_omegas(om, d)


def test_scaled_km_to_m():
    d = dm.DispersionParams.from_betas(1.2e15, beta2=-2.5e-26, beta4=3e-52)
    dm_scaled = d.scaled(1000.0)
    assert float(dm_scaled.beta2) == pytest.approx(-2.5e-29, rel=1e-15)
    assert float(dm_scaled.beta4) == pytest.approx(3e-55, rel=1e-15)
