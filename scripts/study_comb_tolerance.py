"""Comb rk45 tolerance-vs-error study.

Question: on the strongly-cascading bench workload (BASELINE.json config 5
shape: N=64 lines, two 0.5 W pumps, 500 m), does the rtol knob control the
observable error of the adaptive engine?

Design: separate CONTROLLER quality from CHAOTIC divergence.

  CPU phase (x64, the full-precision laboratory):
    truth      = x64 rk45 @ rtol 1e-11
    curve      = x64 rk45 @ rtol 1e-4 .. 1e-9  -> err(rtol) with NO f32
                 rounding.  If even x64 error saturates above the
                 tolerance, the workload itself amplifies local errors
                 (chaotic cascade) and NO engine can deliver
                 tolerance-controlled trajectories.
    perturb    = truth tolerance, A0 perturbed 1e-7 relative (the f32
                 representation class) -> the intrinsic amplification
                 factor of the workload.
    f32-seed   = truth tolerance, A0 rounded to f32 -> same, non-random.

  x32 phase (on the default device, e.g. a GPU): the scan @ rtol
    1e-4 .. 1e-8, errors vs the SAME x64 truth (saved to an npz by the CPU
    phase).

Metrics per run, lanes x lines pooled: relative power error on signal
lines (truth P > 1e-6 W) at p50/p99; strong lines (P > 1e-3) p99; and
aggregate observables -- total power, spectral centroid, participation
bandwidth -- which can stay converged after trajectory-level divergence.

Run from the repository root:
  JAX_PLATFORMS=cpu PYTHONPATH=. python scripts/study_comb_tolerance.py cpu
  PYTHONPATH=. python scripts/study_comb_tolerance.py x32
"""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import numpy as np

NPZ = Path(__file__).resolve().parents[1] / "out" / "comb_study_truth.npz"
N_LINES = 64
B = 16
Z_MAX_M = 500.0
N_STEPS = 1000
SAVE_EVERY = 100
RTOLS = (1e-4, 1e-5, 1e-6, 1e-7, 1e-8, 1e-9)


def _setup():
    import psa
    from psa_simulation_ode_rk_mvp_dispersion.models import nwave as nw

    omega_c = 2.0 * np.pi * 193.1e12
    domega = 2.0 * np.pi * 50e9
    grid = nw.CombGrid.centered(omega_c, domega, N_LINES)
    disp = psa.DispersionParams.from_betas(omega_c, beta2=-1.0e-27,
                                           beta3=1.2e-41)
    coeffs1 = nw.make_comb_coeffs(grid, disp, gamma_W_m=10e-3,
                                  alpha_1_m=5e-5, precision="x64")
    c = N_LINES // 2
    A0_1 = nw.seed_comb(grid, pump_lines={c - 8: 0.5, c + 8: 0.5},
                        noise_floor_W=1e-9, seed=0)
    gammas = np.linspace(5e-3, 15e-3, B)
    coeffs = nw.NWaveCoeffs(
        gamma=gammas, alpha=np.full(B, 5e-5),
        beta_lin=np.broadcast_to(np.asarray(coeffs1.beta_lin, float),
                                 (B, N_LINES)),
    )
    A0 = np.broadcast_to(A0_1, (B, N_LINES)).copy()
    return psa, nw, coeffs, A0


def _cfg(psa, precision, rtol):
    return psa.custom_simulation_config(
        z_max=Z_MAX_M, dz=Z_MAX_M / N_STEPS, save_every=SAVE_EVERY,
        precision=precision, integrator="rk45",
        rtol=rtol, atol=rtol * 1e-3,
    )


def _metrics(P, P_truth):
    """Pooled error metrics of per-line end powers vs truth."""
    sig = P_truth > 1e-6
    strong = P_truth > 1e-3
    rel = np.abs(P - P_truth) / np.maximum(P_truth, 1e-300)
    tot = P.sum(axis=1)
    tot_t = P_truth.sum(axis=1)
    idx = np.arange(P.shape[1])
    cen = (P * idx).sum(axis=1) / tot
    cen_t = (P_truth * idx).sum(axis=1) / tot_t
    pr = tot ** 2 / (P ** 2).sum(axis=1)        # participation bandwidth
    pr_t = tot_t ** 2 / (P_truth ** 2).sum(axis=1)
    return {
        "p50_sig": float(np.median(rel[sig])),
        "p99_sig": float(np.quantile(rel[sig], 0.99)),
        "p99_strong": float(np.quantile(rel[strong], 0.99)),
        "tot_power_rel": float(np.max(np.abs(tot - tot_t) / tot_t)),
        "centroid_shift_lines": float(np.max(np.abs(cen - cen_t))),
        "bandwidth_rel": float(np.max(np.abs(pr - pr_t) / pr_t)),
    }


def main_cpu() -> None:
    from psa_simulation_ode_rk_mvp_dispersion.utils.precision import (
        enable_compile_cache,
    )

    enable_compile_cache()
    psa, nw, coeffs, A0 = _setup()

    def run(rtol, A0_in):
        t0 = time.perf_counter()
        P_max, A_end, ok = nw.solve_comb_batch(
            _cfg(psa, "x64", rtol), coeffs, A0_in, coupling="dft",
        )
        el = time.perf_counter() - t0
        assert bool(ok.all()), f"lanes failed at rtol={rtol}"
        return np.abs(A_end) ** 2, el

    P_truth, el = run(1e-11, A0)
    print(json.dumps({"phase": "truth", "rtol": 1e-11,
                      "elapsed_s": round(el, 2)}), flush=True)

    for rtol in RTOLS:
        P, el = run(rtol, A0)
        rec = {"engine": "x64_scan", "rtol": rtol,
               "elapsed_s": round(el, 2), **_metrics(P, P_truth)}
        print(json.dumps(rec), flush=True)

    # intrinsic amplification: perturbation at the f32 representation class
    rng = np.random.default_rng(42)
    A0_pert = A0 * (1.0 + 1e-7 * rng.standard_normal(A0.shape))
    P_pert, _ = run(1e-11, A0_pert)
    print(json.dumps({"engine": "x64_perturb_1e-7", "rtol": 1e-11,
                      **_metrics(P_pert, P_truth)}), flush=True)

    A0_f32 = A0.astype(np.complex64).astype(np.complex128)
    P_f32, _ = run(1e-11, A0_f32)
    print(json.dumps({"engine": "x64_f32_seed", "rtol": 1e-11,
                      **_metrics(P_f32, P_truth)}), flush=True)

    NPZ.parent.mkdir(exist_ok=True)
    np.savez(NPZ, P_truth=P_truth, A0=A0)
    print(f"# truth saved to {NPZ}", file=sys.stderr)


def main_x32() -> None:
    import jax

    from psa_simulation_ode_rk_mvp_dispersion.utils.precision import (
        enable_compile_cache,
    )

    enable_compile_cache()
    psa, nw, coeffs, A0 = _setup()
    P_truth = np.load(NPZ)["P_truth"]
    print(f"# backend={jax.default_backend()}", file=sys.stderr)

    for rtol in RTOLS[:-1]:          # 1e-9 ~ f32 floor; skip
        t0 = time.perf_counter()
        P_max, A_end, ok = nw.solve_comb_batch(
            _cfg(psa, "x32", rtol), coeffs, A0, coupling="dft")
        el = time.perf_counter() - t0
        P = np.abs(A_end) ** 2
        rec = {"engine": "x32_scan", "rtol": rtol,
               "elapsed_s": round(el, 2),
               "ok_frac": float(np.mean(ok)),
               **_metrics(P, P_truth)}
        print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    {"cpu": main_cpu, "x32": main_x32}[sys.argv[1]]()
