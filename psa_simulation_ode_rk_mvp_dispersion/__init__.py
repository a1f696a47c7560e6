"""psa_simulation_ode_rk_mvp_dispersion -- a JAX framework for parametric
amplification via four-wave mixing in optical fiber.

A ground-up re-design (NOT a port) of the capabilities of the NumPy reference
``Alxkov/PSA-simulation-ODE-RK-MVP-Dispersion``: the Agrawal/Yaman coupled-wave
ODE system for [pump1, pump2, signal, idler] complex amplitudes, Taylor
dispersion beta(omega), phase-mismatch strategies, fixed-step RK4 (and
embedded adaptive RK45) along z, gain-spectrum / mismatch sweeps,
NPZ/CSV/JSON persistence and plotting -- built on jax/XLA:

- the unit of work is a *batch* of ODE instances (single run = batch of 1);
- the hot loop is ``lax.scan`` compiled into one XLA program;
- sweeps are ``vmap``-batched and sharded across a ``jax.sharding.Mesh``;
- numerical failure is masked per-instance, not raised;
- dtype tiers: x64 (reference parity), x32 (fast), df32 (compensated
  two-float32 reaching <=1e-9 from float32 arithmetic).

Import alias: ``import psa`` (see repo-root ``psa.py``).
"""

from __future__ import annotations

import os as _os

from .utils import precision as _precision

# f64 is the reference-parity default.  Opt out with PSA_NO_X64=1.
if _precision.x64_requested():
    _precision.enable_x64()

from . import constants  # noqa: E402
from .config import (  # noqa: E402
    SimulationConfig,
    custom_simulation_config,
    default_simulation_config,
    validate_config,
)
from .ops import dispersion, frequency_plan, integrators, phase_matching, rhs  # noqa: E402
from .ops.dispersion import (  # noqa: E402
    DispersionParams,
    beta2_from_D,
    beta3_from_D_S,
    beta4_from_D_S,
    beta_taylor,
    delta_beta_from_omegas,
    delta_beta_symmetric,
    dispersion_params_from_D_S,
)
from .ops.frequency_plan import (  # noqa: E402
    SymmetricPlan,
    describe_plan,
    enforce_energy_conservation,
    f_from_omega,
    infer_symmetry_from_omegas,
    lambda_from_omega,
    omega_from_f,
    omega_from_lambda,
    plan_from_omegas,
    plan_from_symmetry,
    plan_from_wavelengths,
)
from .ops.phase_matching import (  # noqa: E402
    PhaseMatchingConfig,
    PhaseMatchingMethod,
    PhaseMatchingResult,
    PhaseMismatchCalculator,
    compute_phase_mismatch,
)
from .ops import df32_solver, pallas_solver, twofloat  # noqa: E402
from .ops.rhs import (  # noqa: E402
    RHSCoeffs,
    kerr_factors,
    make_rhs_yaman,
    rhs_yaman,
    rhs_yaman_autonomous,
    rhs_yaman_simplified,
    rotating_to_lab,
)
from .utils import observability, packing  # noqa: E402
from . import experiments, io_fwm, plotting  # noqa: E402
from .io_fwm import (  # noqa: E402
    load_metadata_json,
    load_result_npz,
    load_sweep_npz,
    make_run_metadata,
    save_metadata_json,
    save_result_npz,
    save_run_bundle,
    save_summary_csv,
    save_sweep_npz,
    save_gain_map_npz,
    load_gain_map_npz,
)
from .parallel import mesh as mesh_utils  # noqa: E402
from .parallel import sweep as sweeps  # noqa: E402
from .parallel import noise as noise  # noqa: E402
from .parallel import calibrate as calibrate  # noqa: E402
from .parallel import fluctuations as fluctuations  # noqa: E402
from .parallel.calibrate import (  # noqa: E402
    FitResult,
    fit_gain_curve,
    fit_pulse_spectrum,
    make_gain_model,
    make_launch_gain_model,
    make_pulse_model,
    phase_transfer_db_per_rad,
    power_transfer_db_per_db,
)
from .parallel.fluctuations import GainRippleResult, gain_ripple_monte_carlo  # noqa: E402
from .parallel.link import pulse_link_monte_carlo, span_observed_length_m  # noqa: E402
from .parallel.noise import (  # noqa: E402
    CoherenceResult,
    CombPhotonStatistics,
    EPRResult,
    NoiseFigureResult,
    NoiseFigureSpectrumResult,
    PulseMomentStatistics,
    PulsePhotonStatistics,
    PulseSqueezingEvolution,
    PulseSqueezingResult,
    QuadratureStats,
    RINTransferResult,
    SqueezingSpectrumResult,
    comb_pair_squeezing_monte_carlo,
    comb_photon_statistics,
    epr_inseparability_monte_carlo,
    noise_figure_monte_carlo,
    noise_figure_spectrum,
    psa_squeezing_monte_carlo,
    pulse_coherence_monte_carlo,
    pulse_moment_statistics,
    pump_rin_transfer_monte_carlo,
    pulse_photon_statistics,
    pulse_squeezing_evolution,
    pulse_squeezing_monte_carlo,
    pulse_squeezing_spectrum,
    vector_pulse_coherence_monte_carlo,
    vector_pulse_photon_statistics,
    vector_pulse_squeezing_evolution,
    vector_pulse_squeezing_monte_carlo,
    quadrature_stats,
)
from .parallel.mesh import (  # noqa: E402
    default_mesh,
    fetch_global,
    initialize_distributed,
    multihost_mesh,
    put_global,
)
from .parallel.sweep import (  # noqa: E402
    BatchSolveResult,
    GainMapResult,
    SweepResult,
    dbeta_spectrum,
    gain_and_dbeta_spectrum,
    gain_map_power_wavelength,
    gain_spectrum,
    mismatch_scan,
    psa_phase_sweep,
    solve_batch,
    solve_batch_trajectories,
)
from .ops import adaptive, analytic  # noqa: E402
from .ops.analytic import pia_signal_gain, psa_gain_extrema  # noqa: E402
from .ops.adaptive import integrate_adaptive_grid, rk45_step  # noqa: E402
from .ops.integrators import (  # noqa: E402
    integrate_fixed_grid,
    integrate_fixed_step,
    integrate_interval,
    integrate_reduce,
    rk4_step,
)
from .models import fwm4, gnlse, lle, nwave, sbs, vgnlse  # noqa: E402
from .models.lle import (  # noqa: E402
    LLECoeffs,
    LLENormalization,
    cw_steady_states,
    detuning_scan,
    make_lle_coeffs,
    normalize_ring_cavity,
    run_lle_ramp,
    run_lle_simulation,
    soliton_ansatz,
    solve_lle_batch,
)
from .models.sbs import SBSCoeffs, SBSResult, run_sbs_batch, run_sbs_simulation  # noqa: E402
from .models.gnlse import (  # noqa: E402
    GNLSECoeffs,
    NLTerms,
    TimeGrid,
    gaussian_pulse,
    make_gnlse_coeffs,
    make_nl_terms,
    raman_response,
    raman_t_r,
    run_gnlse_simulation,
    sech_pulse,
    solve_gnlse_batch,
    soliton_peak_power,
)
from .models.vgnlse import (  # noqa: E402
    VGNLSECoeffs,
    degree_of_polarization,
    make_vgnlse_coeffs,
    manakov_soliton_peak_power,
    polarized_pulse,
    run_vgnlse_simulation,
    solve_vgnlse_batch,
    stokes_parameters,
)
from .models.nwave import (  # noqa: E402
    CombGrid,
    NWaveCoeffs,
    comb_beta_lin,
    make_comb_coeffs,
    rhs_nwave,
    run_comb_simulation,
    seed_comb,
)
from .models.fwm4 import (  # noqa: E402
    CacheParams,
    FiberParams,
    ModelParams,
    PhaseMatchingParams,
    SimulationGrid,
    WAVE_ORDER,
    WavesParams,
    example_zero_signal,
    custom_seeded_signal,
    lower_params,
    make_default_phase_matching_params,
    make_initial_amplitudes,
    make_model_params,
    run_single_simulation,
)

__version__ = "0.1.0"
