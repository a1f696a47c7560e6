"""Headline benchmark: 10^4-point gain-spectrum throughput on one GPU.

Reference baseline (BASELINE.md, measured single-core NumPy): the
``main_gain_spectrum`` per-point configuration (z_max=500 m, dz=0.2 m -> 2,500
RK4 steps/point, save_every=10) runs at 0.301 s/point = 3.322 points/s.

This benchmark runs the same physics through ``gain_spectrum`` -- one batched
solve on the card -- and prints ONE JSON line

    {"metric": "gain_spectrum_points_per_s_at_1e-9", "value": ...,
     "unit": "points/s", "vs_baseline": ..., "device": {...}}

Lanes (median of N_REPS calls after a compiling call, end to end from the
caller): x64 on the engine 'auto' picks (the fused Triton kernel on a GPU)
and on the XLA scan, x32, a 250,000-point x64 sweep, and a 4,096-point rk45
sweep at x32.  Accuracy: x64 against the x64 scan on the card, and a
32-point subset against the x64 scan on the CPU device.  It refuses to run
without a GPU.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np

BASELINE_POINTS_PER_S = 1.0 / 0.301  # reference: 0.301 s/point (BASELINE.md)
N_POINTS = 10_000
N_STEADY = 250_000
N_RK45 = 4_096
N_REPS = 5


def median_time(fn, n_reps: int = N_REPS):
    """(result, median seconds, all rep seconds) after one compiling call."""
    fn()
    reps = []
    for _ in range(n_reps):
        t0 = time.perf_counter()
        out = fn()
        reps.append(time.perf_counter() - t0)
    return out, float(np.median(reps)), reps


def main() -> None:
    import chip_smoke as cs

    jax = cs.require_gpu()
    import psa
    from psa_simulation_ode_rk_mvp_dispersion.parallel import sweep as sw
    from psa_simulation_ode_rk_mvp_dispersion.utils.precision import (
        enable_compile_cache,
    )

    enable_compile_cache()

    def lane(n, prec="x64", engine="auto", **cfg_kw):
        kw = cs.headline_kwargs(psa, prec)
        if cfg_kw:
            kw["cfg"] = psa.custom_simulation_config(
                z_max=500.0, dz=0.2, save_every=10, precision=prec, **cfg_kw)
        lam_n = cs.headline_wavelengths(n)
        return median_time(lambda: sw.gain_spectrum(
            lambda_signal_m=lam_n, engine=engine, **kw))

    res, el, reps = lane(N_POINTS)
    res_scan, el_scan, _ = lane(N_POINTS, engine="scan")
    res32, el32, _ = lane(N_POINTS, "x32")
    _, el_ss, _ = lane(N_STEADY)
    res45, el45, _ = lane(N_RK45, "x32", integrator="rk45", rtol=1e-6,
                          atol=1e-10)

    ref = cs.linear_gain(res_scan.gain)
    sub = np.linspace(1541e-9, 1649e-9, 32)
    kw64 = cs.headline_kwargs(psa, "x64")
    gpu_sub = sw.gain_spectrum(lambda_signal_m=sub, **kw64)
    cpu_sub = cs.on_cpu(jax, lambda: sw.gain_spectrum(
        lambda_signal_m=sub, engine="scan", **kw64))
    ref45 = sw.gain_spectrum(lambda_signal_m=cs.headline_wavelengths(N_RK45),
                             **kw64)

    dev = jax.devices()[0]
    meta = {
        "nvidia_smi": cs.nvidia_smi(),
        "n_points": N_POINTS,
        "rk4_steps_per_point": 2500,
        "rep_times_s": reps,
        "scan_x64_points_per_s": N_POINTS / el_scan,
        "x32_points_per_s": N_POINTS / el32,
        "steady_state_points_per_s": N_STEADY / el_ss,
        "rk45_x32_points_per_s": N_RK45 / el45,
        "x64_max_rel_err_vs_scan": cs.max_rel(cs.linear_gain(res.gain), ref),
        "subset_max_rel_err_vs_cpu_x64": cs.max_rel(
            cs.linear_gain(gpu_sub.gain), cs.linear_gain(cpu_sub.gain)),
        "x32_max_rel_err_vs_x64": cs.max_rel(cs.linear_gain(res32.gain), ref),
        "rk45_x32_max_rel_err_vs_x64_rk4": cs.max_rel(
            cs.linear_gain(res45.gain), cs.linear_gain(ref45.gain)),
        "finite_points": int(np.isfinite(res.gain).sum()),
    }
    print(f"# {json.dumps(meta)}", file=sys.stderr)
    pts = N_POINTS / el
    print(json.dumps({
        "metric": "gain_spectrum_points_per_s_at_1e-9",
        "value": pts,
        "unit": "points/s",
        "vs_baseline": pts / BASELINE_POINTS_PER_S,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }))


if __name__ == "__main__":
    main()
