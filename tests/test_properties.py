"""Property-based tests (hypothesis): unit conversions, frequency-plan
invariants, dispersion identities, packing roundtrips.

SURVEY.md section 4 prescribes property tests for unit conversions as part
of the test plan; these cover the algebraic invariants that golden tests
can't sweep.
"""

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

import psa
from psa_simulation_ode_rk_mvp_dispersion.constants import c as C0
from psa_simulation_ode_rk_mvp_dispersion.ops import dispersion as dsp
from psa_simulation_ode_rk_mvp_dispersion.ops import frequency_plan as fp
from psa_simulation_ode_rk_mvp_dispersion.utils.packing import (
    ri_pack_host,
    ri_unpack_host,
)

# optical-band wavelengths [m]; keeps omegas well-conditioned
wavelengths = st.floats(min_value=1.2e-6, max_value=2.0e-6)
powers = st.floats(min_value=0.0, max_value=100.0)
finite_f = st.floats(
    min_value=-1e6, max_value=1e6, allow_nan=False, allow_infinity=False
)


@settings(max_examples=200, deadline=None)
@given(lam=wavelengths)
def test_lambda_omega_roundtrip(lam):
    om = float(np.asarray(fp.omega_from_lambda(lam)))
    lam2 = float(np.asarray(fp.lambda_from_omega(om)))
    assert lam2 == pytest.approx(lam, rel=1e-14)
    assert om > 0


@settings(max_examples=200, deadline=None)
@given(l1=wavelengths, l2=wavelengths, l3=wavelengths)
def test_plan_energy_conservation_invariant(l1, l2, l3):
    """plan_from_wavelengths infers omega4 so that w1 + w2 = w3 + w4 holds to
    machine precision (reference frequency_plan.py:112-131 enforces 1e-12)."""
    om = np.asarray(fp.plan_from_wavelengths(l1, l2, l3))
    w4 = om[0] + om[1] - om[2]
    if w4 <= 0:
        return  # plan builder may legitimately reject; covered elsewhere
    lhs, rhs = om[0] + om[1], om[2] + om[3]
    assert abs(lhs - rhs) <= 1e-12 * max(abs(lhs), abs(rhs))


@settings(max_examples=100, deadline=None)
@given(l1=wavelengths, l2=wavelengths)
def test_symmetric_plan_roundtrip(l1, l2):
    """infer_symmetry_from_omegas inverts the SymmetricPlan parametrization."""
    if abs(l1 - l2) < 1e-12:
        return
    w1 = float(np.asarray(fp.omega_from_lambda(l1)))
    w2 = float(np.asarray(fp.omega_from_lambda(l2)))
    w3 = 0.5 * (w1 + w2) * 1.001
    w4 = w1 + w2 - w3
    sp = fp.infer_symmetry_from_omegas(w1, w2, w3, w4)
    oc = float(np.asarray(sp.omega_c))
    od = float(np.asarray(sp.omega_d))
    Om = float(np.asarray(sp.Omega))
    assert oc + od == pytest.approx(w1, rel=1e-12)
    assert oc - od == pytest.approx(w2, rel=1e-12)
    assert oc + Om == pytest.approx(w3, rel=1e-12)


@settings(max_examples=100, deadline=None)
@given(
    D=st.floats(min_value=-50.0, max_value=50.0),
    S=st.floats(min_value=-1.0, max_value=1.0),
    lam=wavelengths,
)
def test_dispersion_unit_conversion_scaling(D, S, lam):
    """The practical-unit converters are pure scale factors."""
    assert float(np.asarray(dsp.D_ps_nm_km_to_SI(D))) == pytest.approx(
        D * 1e-6, rel=1e-15, abs=1e-300
    )
    assert float(np.asarray(dsp.S_ps_nm2_km_to_SI(S))) == pytest.approx(
        S * 1e3, rel=1e-15, abs=1e-300
    )
    # beta2 from D: beta2 = -lam^2 D / (2 pi c)
    b2 = float(np.asarray(dsp.beta2_from_D(lam, D * 1e-6)))
    assert b2 == pytest.approx(-lam * lam * (D * 1e-6) / (2 * np.pi * C0),
                               rel=1e-12, abs=1e-300)


@settings(max_examples=100, deadline=None)
@given(
    b2=st.floats(min_value=-1e-25, max_value=1e-25),
    b3=st.floats(min_value=-1e-39, max_value=1e-39),
    dw=st.floats(min_value=-5e12, max_value=5e12),
)
def test_delta_beta_symmetric_equals_general(b2, b3, dw):
    """The even-order closed form equals the general 4-point Taylor sum
    (dispersion.py:282 vs :321 in the reference) for any symmetric plan."""
    oc = 2 * np.pi * 193e12
    od = 0.3 * dw
    disp = psa.DispersionParams.from_betas(oc, beta2=b2, beta3=b3, beta4=1e-55)
    om = np.array([oc + od, oc - od, oc + dw, oc - dw])
    general = float(np.asarray(
        dsp.delta_beta_from_omegas(om, disp, max_order=4, rtol=1e-6)
    ))
    symmetric = float(np.asarray(
        dsp.delta_beta_symmetric(oc, od, dw, disp, even_orders=(2, 4))
    ))
    assert symmetric == pytest.approx(general, rel=1e-9, abs=1e-18)


@settings(max_examples=100, deadline=None)
@given(
    re=st.lists(finite_f, min_size=4, max_size=4),
    im=st.lists(finite_f, min_size=4, max_size=4),
)
def test_ri_packing_roundtrip(re, im):
    A = (np.asarray(re) + 1j * np.asarray(im))[None, :]
    packed = ri_pack_host(A, np.float64)
    back = ri_unpack_host(packed)
    np.testing.assert_array_equal(back, A)


@settings(max_examples=50, deadline=None)
@given(
    p=st.lists(powers, min_size=4, max_size=4),
    ph=st.lists(st.floats(min_value=-10.0, max_value=10.0), min_size=4,
                max_size=4),
)
def test_initial_amplitudes_power_phase(p, ph):
    """A = sqrt(P) e^{i phi}: |A|^2 == P and arg(A) == phi (mod 2pi) for
    every nonzero component (reference simulation.py:103-123)."""
    from psa_simulation_ode_rk_mvp_dispersion.models.fwm4 import (
        make_initial_amplitudes,
    )

    A = make_initial_amplitudes(p, ph)
    np.testing.assert_allclose(np.abs(A) ** 2, p, rtol=1e-12, atol=1e-300)
    for k in range(4):
        if p[k] > 0:
            dphi = (np.angle(A[k]) - ph[k]) % (2 * np.pi)
            assert min(dphi, 2 * np.pi - dphi) < 1e-9


@settings(max_examples=50, deadline=None)
@given(scale_unit=st.sampled_from(["m", "km"]), z=st.floats(1e-3, 1e4))
def test_length_unit_boundary(scale_unit, z):
    from psa_simulation_ode_rk_mvp_dispersion.utils.units import (
        length_scale_to_m,
    )

    s = length_scale_to_m(scale_unit)
    assert s == (1.0 if scale_unit == "m" else 1000.0)
    assert z * s / s == pytest.approx(z, rel=1e-15)
