"""Comb benchmark: batched N-wave cascaded-FWM solves on one GPU.

B=4,096 independent N=64-line combs (two 0.5 W pumps, 50 GHz spacing, a
gamma sweep) integrate 1,000 RK4 steps in one batched solve
(``models/nwave.solve_comb_batch``), with the cubic coupling evaluated as
padded FFTs and as dense DFT matrix products.  Median of N_REPS calls after a
compiling call, end to end from the caller, at x64 and x32; accuracy of the
first lanes against the same call on the CPU device at x64.  Prints ONE JSON
line:

    {"metric": "comb_rk4_instance_steps_per_s", "value": ..., "unit": ...,
     "vs_baseline": ..., "device": {...}}

vs_baseline divides by the single-core NumPy 4-wave reference's step rate
(~8,600 RK4 steps/s, BASELINE.md); the reference has no comb model.  It
refuses to run without a GPU.
"""

from __future__ import annotations

import json
import sys

import numpy as np

from bench import median_time

BASELINE_STEPS_PER_S = 8_600.0


def main() -> None:
    import chip_smoke as cs

    jax = cs.require_gpu()
    import psa
    from psa_simulation_ode_rk_mvp_dispersion.models import nwave as nw
    from psa_simulation_ode_rk_mvp_dispersion.utils.precision import (
        enable_compile_cache,
    )

    enable_compile_cache()
    B, steps, k = cs.COMB["batch"], cs.COMB["n_steps"], cs.CPU_LANES
    rows = {}
    for prec in ("x64", "x32"):
        cfg, co, A0 = cs.comb_workload(psa, prec)
        for coupling in ("fft", "dft"):
            (_pk, A, ok), el, reps = median_time(
                lambda: nw.solve_comb_batch(cfg, co, A0, coupling=coupling))
            rows[f"{coupling}_{prec}"] = {
                "instance_steps_per_s": B * steps / el, "rep_times_s": reps,
                "ok_fraction": float(np.mean(ok)), "A_first": np.asarray(A)[:k]}
    cfg, co, A0 = cs.comb_workload(psa, "x64", lanes=k)
    _pk, A_ref, _ok = cs.on_cpu(jax, lambda: nw.solve_comb_batch(cfg, co, A0))
    for row in rows.values():
        row["rel_l2_vs_cpu_x64"] = cs.rel_l2(row.pop("A_first"), A_ref)

    best = max((r for n, r in rows.items() if n.endswith("x64")),
               key=lambda r: r["instance_steps_per_s"])
    dev = jax.devices()[0]
    print(f"# {json.dumps({'nvidia_smi': cs.nvidia_smi(), 'lanes': rows})}",
          file=sys.stderr)
    print(json.dumps({
        "metric": "comb_rk4_instance_steps_per_s",
        "value": best["instance_steps_per_s"],
        "unit": f"instance-steps/s (N={cs.COMB['n_lines']} lines, x64)",
        "vs_baseline": best["instance_steps_per_s"] / BASELINE_STEPS_PER_S,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }))


if __name__ == "__main__":
    main()
