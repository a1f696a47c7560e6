"""GNLSE benchmark: batched split-step Fourier pulse propagation on one GPU.

B=2,048 sech envelopes of T=1,024 samples advance 1,000 symmetric split
steps in one batched solve (``models/gnlse.solve_gnlse_batch``): Kerr only,
and the generalized nonlinearity (silica Raman response + self-steepening);
plus the vector (Manakov) family at B=1,024.  Median of N_REPS calls after a
compiling call, end to end from the caller, at x64 and x32; accuracy of the
first lanes against the same call on the CPU device at x64.  Prints ONE JSON
line:

    {"metric": "gnlse_ssfm_instance_steps_per_s", "value": ..., "unit": ...,
     "vs_baseline": ..., "device": {...}}

vs_baseline divides by the single-core NumPy 4-wave reference's step rate
(~8,600 RK4 steps/s, BASELINE.md); the reference has no pulse model.  It
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
    from psa_simulation_ode_rk_mvp_dispersion.models import gnlse as gn
    from psa_simulation_ode_rk_mvp_dispersion.models import vgnlse as vg
    from psa_simulation_ode_rk_mvp_dispersion.utils.precision import (
        enable_compile_cache,
    )

    enable_compile_cache()
    steps, k = cs.GNLSE["n_steps"], cs.CPU_LANES
    lanes = {
        "kerr": lambda prec, k=None: (gn.solve_gnlse_batch, cs.gnlse_workload(
            psa, prec, lanes=k)),
        "raman_steepening": lambda prec, k=None: (
            gn.solve_gnlse_batch, cs.gnlse_workload(psa, prec, raman=True,
                                                    lanes=k)),
        "manakov": lambda prec, k=None: (vg.solve_vgnlse_batch,
                                         cs.vgnlse_workload(psa, prec, k)),
    }

    def call(solve, args):
        if solve is gn.solve_gnlse_batch:
            cfg, co, A0, nl = args
            return solve(cfg, co, A0, nl=nl)
        return solve(*args)

    rows = {}
    for name, build in lanes.items():
        solve, args = build("x64", k)
        ref = cs.on_cpu(jax, lambda: call(solve, args))[1]
        for prec in ("x64", "x32"):
            solve, args = build(prec)
            (_pk, A, ok), el, reps = median_time(lambda: call(solve, args))
            B = np.asarray(ok).shape[0]
            rows[f"{name}_{prec}"] = {
                "instance_steps_per_s": B * steps / el, "batch": B,
                "rep_times_s": reps, "ok_fraction": float(np.mean(ok)),
                "rel_l2_vs_cpu_x64": cs.rel_l2(np.asarray(A)[:k], ref)}

    best = rows["kerr_x64"]
    dev = jax.devices()[0]
    print(f"# {json.dumps({'nvidia_smi': cs.nvidia_smi(), 'lanes': rows})}",
          file=sys.stderr)
    print(json.dumps({
        "metric": "gnlse_ssfm_instance_steps_per_s",
        "value": best["instance_steps_per_s"],
        "unit": f"instance-steps/s (T={cs.GNLSE['n_samples']}, Kerr, x64)",
        "vs_baseline": best["instance_steps_per_s"] / BASELINE_STEPS_PER_S,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }))


if __name__ == "__main__":
    main()
