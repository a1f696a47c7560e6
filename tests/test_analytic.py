"""Analytic small-signal oracles vs the numerical solvers (the
undepleted-pump cosh/sinh validation pattern SURVEY.md section 4 calls for)."""

import numpy as np
import pytest

import psa
from psa_simulation_ode_rk_mvp_dispersion.ops import analytic as an
from psa_simulation_ode_rk_mvp_dispersion.parallel import sweep as sw


def _numeric_gain(delta_beta, *, P1=0.05, P2=0.05, gamma=10.0, L=0.2,
                  seed=1e-10, dz=1e-4):
    """Numerical end-gain with pumps >> seed (undepleted regime)."""
    omega0 = 2 * np.pi * psa.constants.c / 1.55e-6
    pm = psa.PhaseMatchingConfig(
        method=psa.PhaseMatchingMethod.PROVIDED, provided_delta_beta=float(delta_beta)
    )
    cfg = psa.custom_simulation_config(z_max=L, dz=dz)
    z, A = psa.run_single_simulation(
        cfg, gamma=gamma, alpha=0.0, omega=np.full(4, omega0),
        p_in=[P1, P2, seed, 0.0], phase_matching_cfg=pm, length_unit="km",
    )
    return np.abs(A[-1, 2]) ** 2 / seed


@pytest.mark.parametrize("delta_beta", [0.0, -2.0, 5.0, 15.0, 40.0])
def test_pia_gain_matches_numeric_undepleted(delta_beta):
    """Closed-form PIA gain vs the RK4 solver across exponential-growth,
    near-matched and oscillatory regimes (kappa^2 vs 4C^2)."""
    P1 = P2 = 0.05
    gamma, L = 10.0, 0.2
    G_num = _numeric_gain(delta_beta, P1=P1, P2=P2, gamma=gamma, L=L)
    G_an = float(an.pia_signal_gain(L, gamma, P1, P2, delta_beta))
    assert G_num == pytest.approx(G_an, rel=2e-3)


def test_pia_gain_regimes():
    C, kappa, g2 = an.parametric_g(10.0, 0.05, 0.05, 0.0)
    assert C == pytest.approx(1.0)
    assert kappa == pytest.approx(1.0)  # SPM/XPM contribution gamma*(P1+P2)
    assert g2 == pytest.approx(1.0 - 0.25)
    # deep oscillatory regime gain stays bounded: 1 <= G <= 1 + (2C/kappa... )
    G = an.pia_signal_gain(10.0, 10.0, 0.05, 0.05, 50.0)
    assert 1.0 <= G < 1.01


def test_psa_extrema_match_numeric():
    """kappa = 0 PSA with equal idler seed: numerical phase sweep extrema
    reproduce e^{+-2Cz} and their product is 1 (squeezing relation)."""
    gamma, P = 10.0, 0.05
    C = 2 * gamma * P  # sqrt(P*P) = P
    kappa0_db = -gamma * (2 * P)  # dbeta s.t. kappa = 0
    L = 0.15
    phases = np.linspace(0, 2 * np.pi, 721)
    res = sw.psa_phase_sweep(
        cfg=psa.custom_simulation_config(z_max=L, dz=1e-4),
        gamma=gamma, alpha=0.0, p_in=[P, P, 1e-10, 1e-10],
        signal_phases=phases, delta_beta=kappa0_db,
        gain_unit="linear", length_unit="km",
    )
    G_max_num, G_min_num = np.max(res.gain), np.min(res.gain)
    G_max_an, G_min_an = an.psa_gain_extrema(L, gamma, P, P)
    assert G_max_num == pytest.approx(float(G_max_an), rel=2e-3)
    assert G_min_num == pytest.approx(float(G_min_an), rel=2e-3)
    assert G_max_num * G_min_num == pytest.approx(1.0, rel=4e-3)
