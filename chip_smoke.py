#!/usr/bin/env python3
"""Smoke run of the simulator's main path on a GPU, checked against references.

One process drives every phase through the public entry points at the sizes
the reference's users run, on one card:

- the reference's ``main_gain_spectrum`` sweep (10^4 signal wavelengths,
  2,500 RK4 steps per point, x64) through ``gain_spectrum``, on the fused
  Triton kernel and on the XLA scan, plus its x32 tier;
- the executed NumPy reference's golden data: a 16-point bench-config
  spectrum and the 10^4-step single-run anchor trajectory;
- the CLI ``spectrum`` subcommand, called in process;
- a 4,096-point rk45 sweep, the comb, scalar GNLSE (Kerr; Raman with
  self-steepening), vector GNLSE (Manakov) and LLE batch solvers at x64,
  each compared with the same call on the CPU device of this process.

Each phase prints its wall time (first call, with compilation, and a second
call), its error against its reference and the tolerance it is held to.  A
phase that fails raises, and the script exits non-zero.  The last line is
``{"ok": true, "device": {"platform", "kind", "count"}}``.

    python chip_smoke.py             # one GPU, every phase above
    python chip_smoke.py --gpus 4    # only: 250,000 points sharded over 4

Without a GPU the script stops before any work, with a non-zero exit code.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
GOLDEN = ROOT / "tests" / "golden"

# --- tolerances, each with its reason --------------------------------------
# x64 on the GPU against the executed NumPy reference: same arithmetic up to
# operation order and FMA contraction (BASELINE.json's <=1e-9 contract).
TOL_REFERENCE = 1e-9
# The rotating-frame solve (the kernel's frame) against the lab-frame
# reference: RK4 discretizes the two frames differently -- 9.6e-10 on a
# 35 dB point of the golden spectrum, on any device.
TOL_FRAME = 2e-9
# The fused kernel against the XLA scan at x64: same arithmetic, different
# operation order and FMA contraction (measured ~2e-13 on an H100).
TOL_KERNEL_X64 = 1e-9
# x32 against x64 over 2,500 RK4 steps: float32 round-off, amplified by up
# to ~45 dB of parametric gain.  The x32 XLA scan shows the same error as
# the x32 kernel (1.6e-4 and 1.7e-4 at 10^4 points, 2.0e-4 at 2.5e5 points
# on an H100); the bound leaves 2.5x headroom over that.
TOL_X32 = 5e-4
# rk45 at x32 (rtol 1e-6) against fixed-step x64 RK4: controller tolerance
# plus float32 round-off under the same gain.
TOL_RK45_X32 = 2e-3
# Sharded over four cards against one card: per-lane independent programs,
# no collectives in the loop.
TOL_SHARDED = 1e-12
# SSFM/comb families at x64 on the GPU against the same call on the CPU
# (relative L2 of the output field, worst lane): cuFFT and the CPU FFT
# round differently (~1e-16 per transform); the gain and nonlinearity of
# each propagation amplify that over 10^3 steps.
TOL_FAMILY = {
    "comb": 1e-8,
    "gnlse_kerr": 1e-8,
    "gnlse_raman": 1e-8,
    "vgnlse_manakov": 1e-8,
    "lle": 1e-8,
}

# --- sizes the old bench scripts used --------------------------------------
N_HEADLINE = 10_000
N_SHARDED = 250_000
N_RK45 = 4_096
COMB = dict(n_lines=64, batch=4096, n_steps=1000, save_every=100, z_max=500.0)
GNLSE = dict(n_samples=1024, batch=2048, n_steps=1000, save_every=100,
             z_max=10.0, t0=1e-12, beta2=-2.0e-26, gamma=2e-3, omega0=1.2e15)
LLE = dict(n_samples=256, batch=4096, n_steps=2000, save_every=200, dt=0.01,
           pump=2.0, det_lo=3.6, det_hi=4.4)
CPU_LANES = 4


# ---------------------------------------------------------------------------
# Comparison helpers
# ---------------------------------------------------------------------------

def max_rel(a, ref) -> float:
    """Largest elementwise relative error of ``a`` against ``ref``."""
    a, ref = np.asarray(a), np.asarray(ref)
    return float(np.max(np.abs(a - ref) / np.maximum(np.abs(ref), 1e-300)))


def rel_l2(a, ref) -> float:
    """Worst per-lane relative L2 error over the leading (lane) axis."""
    a, ref = np.asarray(a), np.asarray(ref)
    axes = tuple(range(1, a.ndim))
    num = np.sqrt(np.sum(np.abs(a - ref) ** 2, axis=axes))
    den = np.sqrt(np.sum(np.abs(ref) ** 2, axis=axes))
    return float(np.max(num / np.maximum(den, 1e-300)))


def linear_gain(gain_db) -> np.ndarray:
    return 10.0 ** (np.asarray(gain_db, dtype=np.float64) / 10.0)


def check(name: str, err: float, tol: float) -> None:
    """Raise unless ``err`` is a finite number no larger than ``tol``."""
    if not np.isfinite(err) or err > tol:
        raise AssertionError(f"{name}: error {err:.3e} exceeds {tol:.1e}")


def report(phase: str, **fields) -> None:
    print(f"# phase {json.dumps({'phase': phase, **fields})}", flush=True)


def timed_twice(fn):
    """(result, first-call seconds incl. compilation, second-call seconds)."""
    t0 = time.perf_counter()
    fn()
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = fn()
    return out, first, time.perf_counter() - t0


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    if not out:
        raise RuntimeError("nvidia-smi printed nothing")
    return "; ".join(out.splitlines())


def require_gpu():
    """Stop (non-zero exit) unless JAX's default backend is a GPU."""
    import jax

    backend = jax.default_backend()
    if backend != "gpu":
        raise SystemExit(f"chip_smoke: needs a GPU, JAX found {backend!r}")
    return jax


# ---------------------------------------------------------------------------
# Workloads (shared with the bench scripts and the GPU test lane)
# ---------------------------------------------------------------------------

def headline_kwargs(psa, precision: str = "x64") -> dict:
    """``gain_spectrum`` keyword arguments of the reference's
    ``main_gain_spectrum`` configuration (reference main.py:119-203)."""
    lam_p1, lam_p2 = 1550e-9, 1555e-9
    omega = np.asarray(psa.plan_from_wavelengths(lam_p1, lam_p2, 1540e-9))
    sp = psa.infer_symmetry_from_omegas(*omega)
    disp = psa.dispersion_params_from_D_S(
        lambda_ref_m=float(psa.lambda_from_omega(sp.omega_c)),
        D=0.2, S=0.02, dSdlmbd=0,
        D_units="ps/nm/km", S_units="ps/nm^2/km", dSdlmbd_units="ps/nm^3/km",
        omega_ref=float(np.asarray(sp.omega_c)),
    )
    return dict(
        cfg=psa.custom_simulation_config(z_max=500.0, dz=0.2, save_every=10,
                                         precision=precision),
        lambda_p1_m=lam_p1, lambda_p2_m=lam_p2,
        gamma=11.5e-3, alpha=(np.log(10.0) / 10.0) * 0.5e-3,
        p_in=np.array([0.5, 0.5, 1e-7, 1e-7]), phase_in=np.zeros(4),
        dispersion=disp,
        phase_matching_cfg=psa.PhaseMatchingConfig(
            method=psa.PhaseMatchingMethod.SYMMETRIC_EVEN,
            even_orders=(2, 4), max_order=4),
        length_unit="m", gain_unit="dB", frame="rotating",
    )


def headline_wavelengths(n: int) -> np.ndarray:
    return np.linspace(1540e-9, 1650e-9, n)


def comb_workload(psa, precision: str = "x64", lanes: int = None):
    """(cfg, coeffs, A0): two 0.5 W pumps, 50 GHz spacing, N=64 lines, the
    batch a gamma sweep.  ``lanes`` keeps the first lanes of the full batch
    (the same instances, for a reference solve on fewer lanes)."""
    from psa_simulation_ode_rk_mvp_dispersion.models import nwave as nw

    n, batch = COMB["n_lines"], COMB["batch"]
    k = lanes or batch
    omega_c = 2.0 * np.pi * 193.1e12
    grid = nw.CombGrid.centered(omega_c, 2.0 * np.pi * 50e9, n)
    disp = psa.DispersionParams.from_betas(omega_c, beta2=-1.0e-27,
                                           beta3=1.2e-41)
    c1 = nw.make_comb_coeffs(grid, disp, gamma_W_m=10e-3, alpha_1_m=5e-5,
                             precision=precision)
    A0 = nw.seed_comb(grid, pump_lines={n // 2 - 8: 0.5, n // 2 + 8: 0.5},
                      noise_floor_W=1e-9, seed=0)
    coeffs = nw.NWaveCoeffs(
        gamma=np.linspace(5e-3, 15e-3, batch)[:k], alpha=np.full(k, 5e-5),
        beta_lin=np.broadcast_to(np.asarray(c1.beta_lin, float), (k, n)),
    )
    cfg = psa.custom_simulation_config(
        z_max=COMB["z_max"], dz=COMB["z_max"] / COMB["n_steps"],
        save_every=COMB["save_every"], precision=precision)
    return cfg, coeffs, np.broadcast_to(A0, (k, n)).copy()


def gnlse_workload(psa, precision: str = "x64", raman: bool = False,
                   lanes: int = None, batch: int = None):
    """(cfg, coeffs, A0, nl): sech pulses at 0.5-1.5x the fundamental
    soliton power, T=1024 samples, 1,000 split steps; ``lanes`` as in
    :func:`comb_workload`."""
    from psa_simulation_ode_rk_mvp_dispersion.models import gnlse as gn

    g = GNLSE
    batch = batch or g["batch"]
    grid = gn.TimeGrid.for_pulse(g["t0"], n_samples=g["n_samples"])
    disp = psa.DispersionParams.from_betas(g["omega0"], beta2=g["beta2"])
    co = gn.make_gnlse_coeffs(grid, disp, gamma_W_m=g["gamma"],
                              alpha_1_m=5e-5, precision=precision)
    nl = (gn.make_nl_terms(grid, f_raman=0.18, omega0=g["omega0"],
                           precision=precision) if raman else None)
    P0 = gn.soliton_peak_power(g["beta2"], g["gamma"], g["t0"])
    scales = np.linspace(0.5, 1.5, batch)[:lanes or batch]
    A0 = (np.sqrt(scales * P0)[:, None]
          / np.cosh(grid.t()[None, :] / g["t0"])).astype(np.complex128)
    cfg = psa.custom_simulation_config(
        z_max=g["z_max"], dz=g["z_max"] / g["n_steps"],
        save_every=g["save_every"], precision=precision)
    return cfg, co, A0, nl


def vgnlse_workload(psa, precision: str = "x64", lanes: int = None):
    """(cfg, coeffs, A0): half the GNLSE pulses, split 0.4 rad between the
    two polarizations of a Manakov fibre."""
    from psa_simulation_ode_rk_mvp_dispersion.models import gnlse as gn
    from psa_simulation_ode_rk_mvp_dispersion.models import vgnlse as vg

    g = GNLSE
    cfg, _co, A0, _nl = gnlse_workload(psa, precision, lanes=lanes,
                                       batch=g["batch"] // 2)
    grid = gn.TimeGrid.for_pulse(g["t0"], n_samples=g["n_samples"])
    disp = psa.DispersionParams.from_betas(g["omega0"], beta2=g["beta2"])
    co = vg.make_vgnlse_coeffs(grid, disp, gamma_W_m=g["gamma"],
                               alpha_1_m=5e-5, coupling="manakov",
                               precision=precision)
    th = 0.4
    return cfg, co, np.stack([np.cos(th) * A0, np.sin(th) * A0], axis=1)


def lle_workload(psa, precision: str = "x64", lanes: int = None):
    """(cfg, coeffs, psi0): bright cavity solitons over the detuning range
    3.6-4.4 at F=2, d2=-1 (Herr et al.'s existence range), 2,000 steps;
    ``lanes`` as in :func:`comb_workload`."""
    from psa_simulation_ode_rk_mvp_dispersion.models import lle

    p = LLE
    grid = lle.TimeGrid(n_samples=p["n_samples"], t_window_s=20.0)
    det = np.linspace(p["det_lo"], p["det_hi"], p["batch"])[:lanes or p["batch"]]
    coeffs = lle.make_lle_coeffs(grid, detuning=det, pump=p["pump"], d2=-1.0,
                                 precision=precision)
    psi0 = np.stack([lle.soliton_ansatz(grid, d, p["pump"], -1.0)
                     for d in det])
    cfg = psa.custom_simulation_config(
        z_max=p["n_steps"] * p["dt"], dz=p["dt"], save_every=p["save_every"],
        precision=precision)
    return cfg, coeffs, psi0


def on_cpu(jax, fn):
    """Run ``fn`` with the CPU device of this process as the default."""
    with jax.default_device(jax.devices("cpu")[0]):
        return fn()


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------

def phase_golden(jax, psa) -> None:
    from psa_simulation_ode_rk_mvp_dispersion.parallel import sweep as sw

    g = np.load(GOLDEN / "golden_bench_config.npz")
    disp = psa.dispersion_params_from_D_S(
        lambda_ref_m=float(g["lambda_c"]), D=float(g["D"]), S=float(g["S"]),
        dSdlmbd=0, D_units="ps/nm/km", S_units="ps/nm^2/km",
        dSdlmbd_units="ps/nm^3/km", omega_ref=float(g["omega_c"]),
        compat_reference_beta4_bug=True,  # the golden data carries it
    )
    kw = headline_kwargs(psa)
    # the reference's gain is the max over every step: save_every=1
    kw.update(cfg=psa.custom_simulation_config(z_max=500.0, dz=0.2),
              lambda_p1_m=float(g["lam1"]), lambda_p2_m=float(g["lam2"]),
              gamma=float(g["gamma"]), alpha=float(g["alpha"]),
              p_in=np.asarray(g["p_in"]), dispersion=disp)
    ref = linear_gain(g["gain_db"])
    for engine, frame, tol in (("scan", "lab", TOL_REFERENCE),
                               ("auto", "rotating", TOL_FRAME)):
        res, first, run = timed_twice(lambda: sw.gain_spectrum(
            lambda_signal_m=np.asarray(g["lam3"]), engine=engine,
            **{**kw, "frame": frame}))
        err = max_rel(linear_gain(res.gain), ref)
        report(f"fwm4_golden_spectrum_{engine}_{frame}", points=int(ref.size),
               precision="x64", first_s=first, run_s=run,
               metric="max rel err, linear gain vs executed reference",
               err=err, tol=tol)
        check(f"golden spectrum ({engine}, {frame} frame)", err, tol)

    ga = np.load(GOLDEN / "golden_anchor.npz")
    cfg = psa.custom_simulation_config(z_max=1000.0, dz=0.1)
    omega = np.asarray(psa.plan_from_wavelengths(1550e-9, 1560e-9, 1555e-9))
    sp = psa.infer_symmetry_from_omegas(*omega)
    disp = psa.dispersion_params_from_D_S(
        lambda_ref_m=float(psa.lambda_from_omega(sp.omega_c)), D=0.02, S=0.02,
        dSdlmbd=0, D_units="ps/nm/km", S_units="ps/nm^2/km",
        dSdlmbd_units="ps/nm^3/km", omega_ref=float(np.asarray(sp.omega_c)),
        compat_reference_beta4_bug=True,
    )
    p_in = np.asarray(ga["p_in"])
    (z, A), first, run = timed_twice(lambda: psa.run_single_simulation(
        cfg, gamma=11.5e-3, alpha=(np.log(10.0) / 10.0) * 0.9e-3,
        omega=omega, p_in=p_in, phase_in=np.zeros(4), dispersion=disp,
        phase_matching_cfg=kw["phase_matching_cfg"], length_unit="m",
        return_length_unit="m"))
    gain = np.abs(A[:, 2]) ** 2 / p_in[2]
    gain_ref = np.abs(ga["A"][:, 2]) ** 2 / p_in[2]
    err_gain = max_rel(gain, gain_ref)
    err_field = max_rel(A, ga["A"])
    report("fwm4_golden_anchor", steps=10_000, precision="x64",
           first_s=first, run_s=run,
           metric="max rel err vs executed reference (gain; field)",
           err=err_gain, err_field=err_field, tol=TOL_REFERENCE)
    check("anchor gain", err_gain, TOL_REFERENCE)
    check("anchor field", err_field, TOL_REFERENCE)


def phase_headline(jax, psa) -> dict:
    """The 10^4-point x64 sweep: kernel (auto) vs the XLA scan, x32 kernel,
    and a 32-point subset against the CPU device."""
    from psa_simulation_ode_rk_mvp_dispersion.parallel import sweep as sw

    lam3 = headline_wavelengths(N_HEADLINE)
    kw64 = headline_kwargs(psa, "x64")
    runs = {}
    for name, prec, engine in (("kernel_x64", "x64", "auto"),
                               ("scan_x64", "x64", "scan"),
                               ("kernel_x32", "x32", "auto")):
        kw = headline_kwargs(psa, prec)
        res, first, run = timed_twice(lambda: sw.gain_spectrum(
            lambda_signal_m=lam3, engine=engine, **kw))
        runs[name] = (res, first, run)
    ref = linear_gain(runs["scan_x64"][0].gain)
    for name, tol in (("kernel_x64", TOL_KERNEL_X64), ("kernel_x32", TOL_X32),
                      ("scan_x64", TOL_KERNEL_X64)):
        res, first, run = runs[name]
        err = max_rel(linear_gain(res.gain), ref)
        report(f"fwm4_headline_{name}", points=N_HEADLINE, steps=2500,
               first_s=first, run_s=run, points_per_s=N_HEADLINE / run,
               metric="max rel err, linear gain vs x64 XLA scan on the GPU",
               err=err, tol=tol)
        check(f"headline {name}", err, tol)
    if int(np.isfinite(ref).sum()) != N_HEADLINE:
        raise AssertionError("headline: non-finite gains in the x64 scan")

    sub = np.linspace(1541e-9, 1649e-9, 32)
    gpu = sw.gain_spectrum(lambda_signal_m=sub, **kw64)
    cpu = on_cpu(jax, lambda: sw.gain_spectrum(
        lambda_signal_m=sub, engine="scan", **kw64))
    err = max_rel(linear_gain(gpu.gain), linear_gain(cpu.gain))
    report("fwm4_headline_subset_vs_cpu", points=32, precision="x64",
           metric="max rel err, linear gain vs x64 scan on the CPU device",
           err=err, tol=TOL_REFERENCE)
    check("headline subset vs CPU", err, TOL_REFERENCE)
    return runs


def phase_cli(jax, psa) -> None:
    from psa_simulation_ode_rk_mvp_dispersion.__main__ import main as cli

    out = ROOT / "out" / "chip_smoke_cli"
    out.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    rc = cli(["--no-show", "--quiet", "--save-dir", str(out), "spectrum",
              "--points", "256"])
    wall = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"CLI spectrum exited {rc}")
    with np.load(out / "gain_spectrum.npz") as d:
        gain = np.asarray(d["gain"])
    if gain.size != 256 or not np.all(np.isfinite(gain)):
        raise AssertionError("CLI spectrum: missing or non-finite gains")
    report("cli_spectrum", points=256, first_s=wall,
           artifact=str((out / "gain_spectrum.npz").relative_to(ROOT)))


def phase_rk45(jax, psa) -> None:
    from psa_simulation_ode_rk_mvp_dispersion.parallel import sweep as sw

    lam = headline_wavelengths(N_RK45)
    kw = headline_kwargs(psa, "x32")
    kw["cfg"] = psa.custom_simulation_config(
        z_max=500.0, dz=0.2, save_every=10, precision="x32",
        integrator="rk45", rtol=1e-6, atol=1e-10)
    res, first, run = timed_twice(
        lambda: sw.gain_spectrum(lambda_signal_m=lam, **kw))
    ref = sw.gain_spectrum(lambda_signal_m=lam, **headline_kwargs(psa, "x64"))
    err = max_rel(linear_gain(res.gain), linear_gain(ref.gain))
    report("fwm4_rk45_x32", points=N_RK45, rtol=1e-6, first_s=first,
           run_s=run, points_per_s=N_RK45 / run,
           metric="max rel err, linear gain vs fixed-step x64 RK4",
           err=err, tol=TOL_RK45_X32)
    check("rk45 sweep", err, TOL_RK45_X32)


def _family(jax, name: str, solve, build, size: dict) -> None:
    """Time ``solve(*build())`` on the GPU; compare the first CPU_LANES
    lanes of its output field with the same call on the CPU device."""
    args = build()
    out, first, run = timed_twice(lambda: solve(*args))
    ok = np.asarray(out[-1])
    if not ok.all():
        raise AssertionError(f"{name}: {int((~ok).sum())} lanes failed")
    lane_args = build(CPU_LANES)
    ref = on_cpu(jax, lambda: solve(*lane_args))
    err = rel_l2(np.asarray(out[1])[:CPU_LANES], np.asarray(ref[1]))
    report(name, precision="x64", **size, batch=len(ok), first_s=first,
           run_s=run, lanes_per_s=len(ok) / run, cpu_lanes=CPU_LANES,
           metric="rel L2 of the output field vs the CPU device",
           err=err, tol=TOL_FAMILY[name])
    check(name, err, TOL_FAMILY[name])


def phase_families(jax, psa) -> None:
    from psa_simulation_ode_rk_mvp_dispersion.models import gnlse as gn
    from psa_simulation_ode_rk_mvp_dispersion.models import lle
    from psa_simulation_ode_rk_mvp_dispersion.models import nwave as nw
    from psa_simulation_ode_rk_mvp_dispersion.models import vgnlse as vg

    _family(jax, "comb", nw.solve_comb_batch,
            lambda k=None: comb_workload(psa, lanes=k),
            dict(lines=COMB["n_lines"], steps=COMB["n_steps"]))
    for name, raman in (("gnlse_kerr", False), ("gnlse_raman", True)):
        _family(jax, name,
                lambda cfg, co, A0, nl: gn.solve_gnlse_batch(cfg, co, A0,
                                                             nl=nl),
                lambda k=None, raman=raman: gnlse_workload(
                    psa, raman=raman, lanes=k),
                dict(samples=GNLSE["n_samples"], steps=GNLSE["n_steps"]))
    _family(jax, "vgnlse_manakov", vg.solve_vgnlse_batch,
            lambda k=None: vgnlse_workload(psa, lanes=k),
            dict(samples=GNLSE["n_samples"], steps=GNLSE["n_steps"]))
    _family(jax, "lle", lle.solve_lle_batch,
            lambda k=None: lle_workload(psa, lanes=k),
            dict(samples=LLE["n_samples"], steps=LLE["n_steps"]))


def phase_sharded(jax, psa, n_gpus: int) -> None:
    """250,000 x64 points over an n_gpus mesh (scan and kernel) against
    the same points on one card."""
    from psa_simulation_ode_rk_mvp_dispersion.parallel import sweep as sw
    from psa_simulation_ode_rk_mvp_dispersion.parallel.mesh import (
        batch_sharding, default_mesh, put_global)

    mesh = default_mesh(n_gpus)
    if mesh is None or mesh.devices.size != n_gpus:
        raise AssertionError(f"need {n_gpus} devices, have {jax.devices()}")
    probe = put_global(np.arange(8 * n_gpus, dtype=np.float64),
                       batch_sharding(mesh))
    shard_devs = sorted({s.device.id for s in probe.addressable_shards})
    if len(shard_devs) != n_gpus:
        raise AssertionError(f"shards landed on devices {shard_devs}")
    lam = headline_wavelengths(N_SHARDED)
    kw = headline_kwargs(psa, "x64")
    sharded = {}
    for engine in ("scan", "auto"):
        res, first, run = timed_twice(lambda: sw.gain_spectrum(
            lambda_signal_m=lam, engine=engine, mesh=mesh, **kw))
        sharded[engine] = (res, first, run)
    stats = [d.memory_stats() for d in mesh.devices.flat]
    peaks = [(st or {}).get("peak_bytes_in_use") for st in stats]
    if any(st is not None for st in stats) and min(p or 0 for p in peaks) <= 0:
        raise AssertionError(f"a device of the mesh did no work: {peaks}")
    for engine in ("scan", "auto"):
        single, first1, run1 = timed_twice(lambda: sw.gain_spectrum(
            lambda_signal_m=lam, engine=engine, **kw))
        res, first, run = sharded[engine]
        err = max_rel(linear_gain(res.gain), linear_gain(single.gain))
        report(f"fwm4_sharded_{engine}", points=N_SHARDED, gpus=n_gpus,
               shard_devices=shard_devs, peak_bytes_per_device=peaks,
               first_s=first, run_s=run, points_per_s=N_SHARDED / run,
               one_card_first_s=first1, one_card_run_s=run1,
               one_card_points_per_s=N_SHARDED / run1,
               metric="max rel err, linear gain vs the same points on one card",
               err=err, tol=TOL_SHARDED)
        check(f"sharded {engine}", err, TOL_SHARDED)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--gpus", type=int, default=1, choices=(1, 4),
                    help="4: run only the 250,000-point sharded phase")
    args = ap.parse_args(argv)

    jax = require_gpu()
    import psa
    from psa_simulation_ode_rk_mvp_dispersion.utils.precision import (
        enable_compile_cache)

    cache = enable_compile_cache()
    print(f"# nvidia-smi: {nvidia_smi()}", flush=True)
    dev = jax.devices()[0]
    print(f"# jax {jax.__version__}, {len(jax.devices())} x {dev.device_kind},"
          f" compile cache {cache}", flush=True)

    t0 = time.perf_counter()
    if args.gpus == 4:
        phase_sharded(jax, psa, 4)
    else:
        phase_golden(jax, psa)
        phase_headline(jax, psa)
        phase_cli(jax, psa)
        phase_rk45(jax, psa)
        phase_families(jax, psa)
    print(f"# all phases passed in {time.perf_counter() - t0:.1f} s", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
