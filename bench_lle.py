"""LLE benchmark: batched Kerr-cavity soliton propagation on one GPU.

B=4,096 normalized LLE cavities (T=256 modes, F=2, d2=-1, detuning
3.6-4.4: Herr et al.'s soliton-existence range, seeded with the soliton
ansatz) integrate 2,000 Strang steps in one batched solve
(``models/lle.solve_lle_batch``).  Median of N_REPS calls after a compiling
call, end to end from the caller, at x64 and x32, plus the adaptive (rk45)
lane at x32; accuracy of the first lanes against the same call on the CPU
device at x64.  Prints ONE JSON line:

    {"metric": "lle_strang_instance_steps_per_s", "value": ...,
     "unit": ..., "vs_baseline": ..., "device": {...}}

vs_baseline divides by the single-core NumPy 4-wave reference's step rate
(~8,600 RK4 steps/s, BASELINE.md); the reference has no cavity model.  It
refuses to run without a GPU.
"""

from __future__ import annotations

import dataclasses
import json
import sys

import numpy as np

from bench import median_time

BASELINE_STEPS_PER_S = 8_600.0


def main() -> None:
    import chip_smoke as cs

    jax = cs.require_gpu()
    import psa
    from psa_simulation_ode_rk_mvp_dispersion.models import lle
    from psa_simulation_ode_rk_mvp_dispersion.utils.precision import (
        enable_compile_cache,
    )

    enable_compile_cache()
    steps, k = cs.LLE["n_steps"], cs.CPU_LANES
    cfg, co, psi0 = cs.lle_workload(psa, "x64", lanes=k)
    ref = cs.on_cpu(jax, lambda: lle.solve_lle_batch(cfg, co, psi0))[1]
    rows = {}
    for prec, integrator in (("x64", "rk4"), ("x32", "rk4"), ("x32", "rk45")):
        cfg, co, psi0 = cs.lle_workload(psa, prec)
        if integrator == "rk45":
            cfg = dataclasses.replace(cfg, integrator="rk45", rtol=1e-6,
                                      atol=1e-9)
        (_pk, A, ok), el, reps = median_time(
            lambda: lle.solve_lle_batch(cfg, co, psi0))
        B = psi0.shape[0]
        rows[f"{integrator}_{prec}"] = {
            "instance_steps_per_s": B * steps / el, "rep_times_s": reps,
            "ok_fraction": float(np.mean(ok)),
            "rel_l2_vs_cpu_x64": cs.rel_l2(np.asarray(A)[:k], ref)}

    best = rows["rk4_x64"]
    dev = jax.devices()[0]
    print(f"# {json.dumps({'nvidia_smi': cs.nvidia_smi(), 'lanes': rows})}",
          file=sys.stderr)
    print(json.dumps({
        "metric": "lle_strang_instance_steps_per_s",
        "value": best["instance_steps_per_s"],
        "unit": f"instance-steps/s (T={cs.LLE['n_samples']}, x64)",
        "vs_baseline": best["instance_steps_per_s"] / BASELINE_STEPS_PER_S,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }))


if __name__ == "__main__":
    main()
