"""Batched parameter sweeps: the reason this framework exists.

Capability parity with the reference sweep layer ``scan_mismtach.py``:
``plot_max_signal_gain_vs_lambda_signal`` (:262-430),
``plot_dbeta_vs_lambda_signal`` (:473-585),
``plot_max_gain_and_dbeta_vs_lambda_signal`` (:588-783) and the (stale)
``scan_mismatch_seeded_signal`` (:43-259) -- re-designed for an accelerator:

- The reference integrates sweep points one at a time in a serial Python loop
  (~0.3 s/point).  Here the *entire sweep is one batched XLA program*: the
  (B,) parameter grid becomes a batched :class:`~..ops.rhs.RHSCoeffs` pytree,
  ``vmap`` lifts the ``lax.scan`` RK4 solver over the batch, and the running
  gain reduction happens on-device (``integrate_reduce``) so only (B,) f32
  summaries ever cross back to the host.
- Sharding: pass a ``Mesh`` (``parallel.mesh.default_mesh()`` builds one over
  the local devices, ``multihost_mesh()`` over every process) and the
  batch axis is sharded over devices with ``NamedSharding`` -- embarrassingly
  SPMD, no collectives in the hot loop.
- Failure semantics: the reference wraps each point in try/except and records
  NaN (``scan_mismtach.py:391-392``, ``:736-738``).  Here invalid points
  (e.g. inferred idler frequency <= 0) are masked up front, and NaN/Inf during
  integration trips the per-instance ``ok`` flag; both surface as NaN gain.
- Results are returned as data (`SweepResult`); plotting lives separately in
  ``plotting.py`` (same split the reference gestures at but does not make).

Complex states cross the jit boundary as real/imag pairs and are
reassembled on the host (``utils/packing.py``).
"""

from __future__ import annotations

import dataclasses
import functools
import time
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import jax
import numpy as np
import jax.numpy as jnp

from ..config import SimulationConfig, validate_config, reject_non_ode
from ..constants import c as C0, TWO_PI
from ..ops.dispersion import DispersionParams, delta_beta_from_omegas, delta_beta_symmetric
from ..ops.adaptive import integrate_adaptive_reduce
from ..ops.integrators import integrate_fixed_grid, integrate_reduce
from ..ops.phase_matching import PhaseMatchingConfig, PhaseMatchingMethod
from ..ops.rhs import RHSCoeffs, rhs_yaman, rhs_yaman_autonomous, rotating_to_lab
from ..utils.packing import complex_to_ri, ri_pack_host, ri_to_complex, ri_unpack_host
from ..utils.precision import real_dtype, require_non_df32, validate_precision
from ..utils.units import length_scale_to_m, wavelength_scale
from ..models.fwm4 import _to_power_array, _to_phase_array

GainMode = str  # "end" | "max"
VALID_GAIN_MODES = ("end", "max")
VALID_GAIN_UNITS = ("db", "linear")


# ---------------------------------------------------------------------------
# Result containers (host-side data)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class BatchSolveResult:
    """Per-instance summaries of a batched solve (host numpy)."""

    P_max: np.ndarray    # (B, 4) max power over saved samples [W]
    P_end: np.ndarray    # (B, 4) power at last saved sample [W]
    A_end: np.ndarray    # (B, 4) complex lab-frame state at last saved sample
    ok: np.ndarray       # (B,) bool
    elapsed_s: float
    instances_per_s: float


@dataclass(frozen=True)
class GainMapResult:
    """A 2-D (pump power x wavelength) gain map with per-cell ok mask.

    Iterates as ``(x, pump_powers, gain)`` for drop-in use where the bare
    tuple was previously returned."""

    x: np.ndarray             # (Nl,) wavelengths [return_wavelength_unit]
    pump_powers: np.ndarray   # (Np,) [W]
    gain: np.ndarray          # (Np, Nl), NaN where failed/invalid
    ok: np.ndarray            # (Np, Nl) bool
    gain_unit: str
    elapsed_s: float
    points_per_s: float

    def __iter__(self):
        return iter((self.x, self.pump_powers, self.gain))

    @property
    def best_index(self):
        """(ip, il) of the maximum finite gain.

        Raises a descriptive ``ValueError`` when every cell failed (all-NaN
        gain) instead of numpy's bare all-NaN-slice error."""
        if not np.any(np.isfinite(self.gain)):
            raise ValueError(
                "best_index undefined: every gain-map cell failed "
                "(gain is all-NaN; check the ok mask)"
            )
        flat = int(np.nanargmax(self.gain))
        return np.unravel_index(flat, self.gain.shape)


@dataclass(frozen=True)
class SweepResult:
    """A 1-D sweep: x grid + gain (+ optional dbeta) with NaN for failures."""

    x: np.ndarray
    gain: np.ndarray
    dbeta: Optional[np.ndarray]
    ok: np.ndarray
    gain_unit: str
    elapsed_s: float
    points_per_s: float

    @property
    def best_index(self) -> int:
        if not np.any(np.isfinite(self.gain)):
            raise ValueError(
                "best_index undefined: every sweep point failed "
                "(gain is all-NaN; check the ok mask)"
            )
        return int(np.nanargmax(self.gain))


# ---------------------------------------------------------------------------
# The batched solver core
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=256)
def _batch_solver(
    n_steps: int,
    save_every: int,
    check_nan: bool,
    frame: str,
    unroll: int,
    method: str = "rk4",
):
    """Jitted vmapped reduce-mode solver.

    Returns ONE stacked (B, 13) rdt buffer [P_max (4) | A_end ri (8) | ok]
    -- a single device->host fetch.
    """
    rhs = rhs_yaman if frame == "lab" else rhs_yaman_autonomous

    def one(y0, coeffs, z0, dz):
        P0 = y0.real * y0.real + y0.imag * y0.imag

        def red(acc, y):
            pmax, _last = acc
            P = y.real * y.real + y.imag * y.imag
            return (jnp.maximum(pmax, P), y)

        res = integrate_reduce(
            rhs, y0, coeffs,
            z0=z0, dz=dz, n_steps=n_steps, save_every=save_every,
            reduce_init=(P0, y0), reduce_fn=red,
            check_nan=check_nan, unroll=unroll, method=method,
        )
        pmax, y_last = res.reduction
        n_chunks = n_steps // save_every
        z_last = z0 + (n_chunks * save_every) * dz
        if frame == "rotating":
            y_last = rotating_to_lab(z_last, y_last, coeffs)
        return pmax, y_last, res.ok

    def batch(y0_ri, coeffs_b, z0, dz):
        # complex state crosses the jit boundary as (B, 4, 2) real/imag
        # packs, and the three results leave as ONE stacked (B, 13) buffer
        y0_b = ri_to_complex(y0_ri)
        pmax, y_last, ok = jax.vmap(one, in_axes=(0, 0, None, None))(
            y0_b, coeffs_b, z0, dz
        )
        rdt = y0_ri.dtype
        a_ri = complex_to_ri(y_last).astype(rdt)
        return jnp.concatenate(
            [pmax.astype(rdt), a_ri.reshape(a_ri.shape[0], 8),
             ok.astype(rdt)[:, None]],
            axis=1,
        )

    return jax.jit(batch)


@functools.lru_cache(maxsize=64)
def _batch_adaptive_solver(frame: str, rtol: float, atol: float,
                           max_steps: int, has_tail: bool = False):
    """Jitted vmapped reduce-mode RK45 (Dormand-Prince) solver.

    The batched realization of the reference's reserved ``cfg.integrator``
    slot (``/root/reference/config.py:89``) for sweeps: every lane adapts its
    own step size in lockstep (masked while_loop, ``ops/adaptive.py``), with
    dense output reduced on the decimated save grid so only (B, 4) summaries
    cross back to the host.  ``has_tail``: the trailing ``n_steps %
    save_every`` partial span is integrated but unsaved (ok/counters only
    -- the framework-wide decimation contract, round 4).
    """
    rhs = rhs_yaman if frame == "lab" else rhs_yaman_autonomous

    def one(y0, coeffs, z_grid, z_final):
        P0 = y0.real * y0.real + y0.imag * y0.imag

        def red(pmax, y):
            P = y.real * y.real + y.imag * y.imag
            return jnp.maximum(pmax, P)

        res = integrate_adaptive_reduce(
            rhs, y0, coeffs, z_grid=z_grid,
            reduce_init=P0, reduce_fn=red,
            rtol=rtol, atol=atol, max_steps_per_segment=max_steps,
            z_final=z_final if has_tail else None,
        )
        y_last = res.y_final
        if frame == "rotating":
            y_last = rotating_to_lab(z_grid[-1], y_last, coeffs)
        return res.reduction, y_last, res.ok

    def batch(y0_ri, coeffs_b, z_grid, z_final):
        y0_b = ri_to_complex(y0_ri)
        pmax, y_last, ok = jax.vmap(one, in_axes=(0, 0, None, None))(
            y0_b, coeffs_b, z_grid, z_final)
        rdt = y0_ri.dtype
        a_ri = complex_to_ri(y_last).astype(rdt)
        # ONE stacked (B, 13) output
        return jnp.concatenate(
            [pmax.astype(rdt), a_ri.reshape(a_ri.shape[0], 8),
             ok.astype(rdt)[:, None]],
            axis=1,
        )

    return jax.jit(batch)


def _default_progress(done: int, total: int, elapsed: float) -> None:
    """Reference-style live instrumentation (scan_mismtach.py:162-180):
    elapsed total / avg per point / throughput, printed per dispatched chunk."""
    pts = done / elapsed if elapsed > 0 else float("inf")
    avg_ms = 1e3 * elapsed / max(done, 1)
    print(
        f"[sweep {done}/{total}] elapsed {elapsed:8.2f} s | "
        f"avg {avg_ms:7.3f} ms/pt | {pts:10.1f} pt/s",
        flush=True,
    )


def use_kernel(engine: str, *, precision: str, frame: str,
               integrator: str) -> bool:
    """Whether :func:`solve_batch` runs the fused Triton RK4 kernel.

    The kernel covers rk4 in the rotating frame at x64 and x32 and compiles
    for the GPU only.  'auto' takes it wherever it applies on a GPU (on the
    H100 it is 4-9x the scan end to end, PERF.md) and the scan elsewhere;
    'pallas' demands it and raises where it cannot run -- it never falls back
    to the Pallas interpreter; 'scan' never takes it.
    """
    if engine not in ("auto", "scan", "pallas"):
        raise ValueError(f"engine must be 'auto', 'scan' or 'pallas', got {engine!r}")
    if engine == "scan":
        return False
    fits = (integrator == "rk4" and frame == "rotating"
            and precision in ("x64", "x32"))
    on_gpu = jax.default_backend() == "gpu"
    if engine == "pallas":
        if not fits:
            raise ValueError(
                "engine='pallas' (the fused Triton RK4 kernel) needs "
                "integrator='rk4', frame='rotating' and precision 'x64' or "
                f"'x32'; got {integrator!r}, {frame!r}, {precision!r}"
            )
        if not on_gpu:
            raise ValueError(
                "engine='pallas' compiles the Triton kernel for a GPU; the "
                f"{jax.default_backend()!r} backend has none (use 'auto' or "
                "'scan')"
            )
    return fits and on_gpu


def solve_batch(
    cfg: SimulationConfig,
    coeffs: RHSCoeffs,
    A0: np.ndarray,
    *,
    frame: str = "rotating",
    mesh=None,
    unroll: int = 4,
    engine: str = "auto",
    progress=None,
    progress_chunk: int = 16384,
) -> BatchSolveResult:
    """Solve B independent 4-wave instances in one XLA program.

    ``coeffs`` fields and ``A0`` must share the leading batch dimension; all
    quantities in internal per-meter units (``cfg.z_max``/``cfg.dz`` here are
    in meters -- callers handle the unit boundary).

    ``engine``: 'scan' (vmapped lax.scan), 'pallas' (the fused
    single-launch Triton RK4 kernel, ``ops/pallas_solver.py``; GPU only,
    rk4 in the rotating frame at x64 or x32), or 'auto' (the kernel where it
    applies on a GPU, the scan otherwise).  See :func:`use_kernel`.
    """
    validate_config(cfg)
    reject_non_ode(cfg, "the 4-wave sweep engine")
    precision = validate_precision(cfg.precision)
    rdt = real_dtype(precision)

    A0 = np.asarray(A0)
    if A0.ndim != 2 or A0.shape[1] != 4:
        raise ValueError(f"A0 must have shape (B, 4), got {A0.shape}")
    B = A0.shape[0]

    gamma = np.broadcast_to(np.asarray(coeffs.gamma, dtype=float), (B,))
    alpha = np.broadcast_to(np.asarray(coeffs.alpha, dtype=float), (B,))
    dbeta = np.broadcast_to(np.asarray(coeffs.delta_beta, dtype=float), (B,))

    n_steps = int(round(cfg.z_max / cfg.dz))
    integrator = cfg.integrator.lower()
    kernel = use_kernel(engine, precision=precision, frame=frame,
                        integrator=integrator)

    if progress is not None and B > int(progress_chunk):
        # Chunked dispatch: live in-flight instrumentation for long scans
        # (the reference shows tqdm throughput on every sweep,
        # scan_mismtach.py:117-124/:162-180; one monolithic XLA program is a
        # silent black box).  Every chunk is padded to the same shape, so the
        # whole scan still compiles exactly once per engine.
        chunk = int(progress_chunk)
        t0 = time.perf_counter()
        parts = []
        done = 0
        for s in range(0, B, chunk):
            e = min(s + chunk, B)
            n_sub = e - s
            pad = chunk - n_sub
            sl = slice(s, e)

            def padded(x):
                if pad == 0:
                    return x[sl]
                return np.concatenate([x[sl], np.repeat(x[e - 1:e], pad, axis=0)])

            sub = solve_batch(
                cfg,
                RHSCoeffs(gamma=padded(gamma), alpha=padded(alpha),
                          delta_beta=padded(dbeta)),
                padded(A0),
                frame=frame, mesh=mesh, unroll=unroll, engine=engine,
                progress=None,
            )
            parts.append((sub, n_sub))
            done += n_sub
            progress(done, B, time.perf_counter() - t0)
        elapsed = time.perf_counter() - t0
        return BatchSolveResult(
            P_max=np.concatenate([r.P_max[:n] for r, n in parts]),
            P_end=np.concatenate([r.P_end[:n] for r, n in parts]),
            A_end=np.concatenate([r.A_end[:n] for r, n in parts]),
            ok=np.concatenate([r.ok[:n] for r, n in parts]),
            elapsed_s=elapsed,
            instances_per_s=B / elapsed if elapsed > 0 else float("inf"),
        )

    def _result(r, elapsed):
        return BatchSolveResult(
            P_max=r.P_max,
            P_end=np.abs(r.A_end) ** 2,
            A_end=r.A_end,
            ok=r.ok,
            elapsed_s=elapsed,
            instances_per_s=B / elapsed if elapsed > 0 else float("inf"),
        )

    if kernel:
        from ..ops.pallas_solver import solve_batch_pallas

        t0 = time.perf_counter()
        r = solve_batch_pallas(
            A0, gamma, alpha, dbeta,
            dz_m=float(cfg.dz), n_steps=n_steps,
            save_every=int(cfg.save_every), dtype=rdt, mesh=mesh,
        )
        return _result(r, time.perf_counter() - t0)
    if integrator == "rk45":
        # Honor the adaptive slot everywhere (reference config.py:89 only
        # validated it; round-1 sweeps silently ran rk4).
        if precision == "df32":
            # compensated two-float DP45 (ops/df32_adaptive.py).  Like the
            # fixed-step df32 engine it integrates in the rotating
            # (autonomous) frame and restores lab-frame pump phases on the
            # host -- outputs are frame-independent.
            from ..ops.df32_adaptive import solve_batch_df32_rk45

            t0 = time.perf_counter()
            r = solve_batch_df32_rk45(
                A0, gamma, alpha, dbeta,
                dz_m=float(cfg.dz), n_steps=n_steps,
                save_every=int(cfg.save_every),
                rtol=float(cfg.rtol), atol=float(cfg.atol),
                max_steps=int(cfg.max_steps), mesh=mesh,
            )
            return _result(r, time.perf_counter() - t0)
        return _solve_batch_rk45(
            cfg, A0, gamma, alpha, dbeta,
            n_steps=n_steps, frame=frame, mesh=mesh, rdt=rdt,
        )

    if precision == "df32":
        # compensated two-float32 scan engine (rotating frame only); see
        # ops/df32_solver.py
        from ..ops.df32_solver import solve_batch_df32

        t0 = time.perf_counter()
        r = solve_batch_df32(
            A0, gamma, alpha, dbeta,
            dz_m=float(cfg.dz), n_steps=n_steps,
            save_every=int(cfg.save_every), mesh=mesh,
            method=integrator,
        )
        return _result(r, time.perf_counter() - t0)

    solver = _batch_solver(
        n_steps, int(cfg.save_every), bool(cfg.check_nan), frame, unroll,
        integrator,
    )

    y0_dev = jnp.asarray(ri_pack_host(A0, rdt))
    coeffs_dev = RHSCoeffs(
        gamma=jnp.asarray(gamma, dtype=rdt),
        alpha=jnp.asarray(alpha, dtype=rdt),
        delta_beta=jnp.asarray(dbeta, dtype=rdt),
    )

    n_orig = B
    if mesh is not None:
        from .mesh import batch_sharding, pad_batch, put_global

        ndev = int(np.prod(list(mesh.shape.values())))
        A0_p, n_orig = pad_batch(A0, ndev)
        gamma_p, _ = pad_batch(gamma, ndev)
        alpha_p, _ = pad_batch(alpha, ndev)
        dbeta_p, _ = pad_batch(dbeta, ndev)
        sh = batch_sharding(mesh)
        y0_dev = put_global(ri_pack_host(A0_p, rdt), sh)
        coeffs_dev = RHSCoeffs(
            gamma=put_global(np.asarray(gamma_p, dtype=rdt), sh),
            alpha=put_global(np.asarray(alpha_p, dtype=rdt), sh),
            delta_beta=put_global(np.asarray(dbeta_p, dtype=rdt), sh),
        )

    from .mesh import fetch_global

    t0 = time.perf_counter()
    out = jax.block_until_ready(solver(
        y0_dev, coeffs_dev, jnp.asarray(0.0, dtype=rdt), jnp.asarray(cfg.dz, dtype=rdt)
    ))
    elapsed = time.perf_counter() - t0

    out = fetch_global(out)[:n_orig]      # ONE fetch of (B, 13)
    pmax = out[:, 0:4].astype(np.float64)
    a_ri = out[:, 4:12].reshape(-1, 4, 2)
    ok = out[:, 12] > 0.5
    A_end = ri_unpack_host(a_ri)
    # not-ok lanes are frozen at their last finite state, which can be large
    # enough that |A|^2 overflows to inf -- fine (the ok mask governs use)
    with np.errstate(over="ignore"):
        P_end = np.abs(A_end) ** 2

    return BatchSolveResult(
        P_max=pmax,
        P_end=P_end,
        A_end=A_end,
        ok=ok,
        elapsed_s=elapsed,
        instances_per_s=n_orig / elapsed if elapsed > 0 else float("inf"),
    )


def _solve_batch_rk45(
    cfg: SimulationConfig,
    A0: np.ndarray,
    gamma: np.ndarray,
    alpha: np.ndarray,
    dbeta: np.ndarray,
    *,
    n_steps: int,
    frame: str,
    mesh,
    rdt,
) -> BatchSolveResult:
    """Adaptive (rk45) back end of :func:`solve_batch`.

    Output contract matches the rk4 reduce path: P_max over the decimated
    save grid (row 0 + every ``save_every``-th step), A_end at the last
    saved grid point; the trailing ``n_steps % save_every`` partial span is
    integrated but unsaved -- it folds into ``ok`` only (the framework-wide
    decimation contract, round 4).
    """
    B = A0.shape[0]
    n_chunks = n_steps // int(cfg.save_every)
    rk45_tail = (n_steps - n_chunks * int(cfg.save_every)) > 0
    if n_chunks == 0 and not rk45_tail:
        # no steps at all: the saved-grid outputs are the ICs
        P0 = np.abs(np.asarray(A0, dtype=np.complex128)) ** 2
        return BatchSolveResult(
            P_max=P0, P_end=P0, A_end=np.asarray(A0, dtype=np.complex128),
            ok=np.ones(B, dtype=bool), elapsed_s=0.0,
            instances_per_s=float("inf"),
        )
    z_grid = np.arange(n_chunks + 1, dtype=np.float64) * (
        int(cfg.save_every) * float(cfg.dz)
    )
    z_final = jnp.asarray(n_steps * float(cfg.dz), dtype=rdt)

    solver = _batch_adaptive_solver(
        frame, float(cfg.rtol), float(cfg.atol), int(cfg.max_steps),
        rk45_tail,
    )

    y0_dev = jnp.asarray(ri_pack_host(A0, rdt))
    coeffs_dev = RHSCoeffs(
        gamma=jnp.asarray(gamma, dtype=rdt),
        alpha=jnp.asarray(alpha, dtype=rdt),
        delta_beta=jnp.asarray(dbeta, dtype=rdt),
    )

    n_orig = B
    if mesh is not None:
        from .mesh import batch_sharding, pad_batch, put_global

        ndev = int(np.prod(list(mesh.shape.values())))
        A0_p, n_orig = pad_batch(A0, ndev)
        sh = batch_sharding(mesh)
        y0_dev = put_global(ri_pack_host(A0_p, rdt), sh)
        coeffs_dev = RHSCoeffs(
            gamma=put_global(np.asarray(pad_batch(gamma, ndev)[0], dtype=rdt), sh),
            alpha=put_global(np.asarray(pad_batch(alpha, ndev)[0], dtype=rdt), sh),
            delta_beta=put_global(
                np.asarray(pad_batch(dbeta, ndev)[0], dtype=rdt), sh
            ),
        )

    from .mesh import fetch_global

    t0 = time.perf_counter()
    out = jax.block_until_ready(
        solver(y0_dev, coeffs_dev, jnp.asarray(z_grid, dtype=rdt), z_final)
    )
    elapsed = time.perf_counter() - t0

    out = fetch_global(out)[:n_orig]      # ONE fetch of (B, 13)
    pmax = out[:, 0:4].astype(np.float64)
    A_end = ri_unpack_host(out[:, 4:12].reshape(-1, 4, 2))
    ok = out[:, 12] > 0.5
    with np.errstate(over="ignore"):
        P_end = np.abs(A_end) ** 2
    return BatchSolveResult(
        P_max=pmax,
        P_end=P_end,
        A_end=A_end,
        ok=ok,
        elapsed_s=elapsed,
        instances_per_s=n_orig / elapsed if elapsed > 0 else float("inf"),
    )


# ---------------------------------------------------------------------------
# Trajectory-mode batched solve (moderate B; full decimated trajectories)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=64)
def _batch_adaptive_traj_solver(frame: str, rtol: float, atol: float,
                                max_steps: int, has_tail: bool = False):
    from ..ops.adaptive import integrate_adaptive_grid

    rhs = rhs_yaman if frame == "lab" else rhs_yaman_autonomous

    def one(y0, coeffs, z_grid, z_final):
        res = integrate_adaptive_grid(
            rhs, y0, coeffs, z_grid=z_grid, rtol=rtol, atol=atol,
            max_steps_per_segment=max_steps,
            z_final=z_final if has_tail else None,
        )
        y_saved = res.y_saved
        if frame == "rotating":
            y_saved = rotating_to_lab(res.z_saved, y_saved, coeffs)
        return y_saved, res.ok

    def batch(y0_ri, coeffs_b, z_grid, z_final):
        y0_b = ri_to_complex(y0_ri)
        ys, ok = jax.vmap(one, in_axes=(0, 0, None, None))(
            y0_b, coeffs_b, z_grid, z_final)
        return complex_to_ri(ys).astype(y0_ri.dtype), ok.astype(jnp.int32)

    return jax.jit(batch)


@functools.lru_cache(maxsize=64)
def _batch_traj_solver(n_steps: int, save_every: int, check_nan: bool, frame: str, unroll: int,
                       method: str = "rk4"):
    rhs = rhs_yaman if frame == "lab" else rhs_yaman_autonomous

    def one(y0, coeffs, z0, dz):
        res = integrate_fixed_grid(
            rhs, y0, coeffs, z0=z0, dz=dz, n_steps=n_steps,
            save_every=save_every, check_nan=check_nan, unroll=unroll,
            method=method,
        )
        y_saved = res.y_saved
        if frame == "rotating":
            y_saved = rotating_to_lab(res.z_saved, y_saved, coeffs)
        return res.z_saved, y_saved, res.ok

    def batch(y0_ri, coeffs_b, z0, dz):
        y0_b = ri_to_complex(y0_ri)
        z, ys, ok = jax.vmap(one, in_axes=(0, 0, None, None))(y0_b, coeffs_b, z0, dz)
        y_ri = complex_to_ri(ys).astype(y0_ri.dtype)
        return z[0], y_ri, ok.astype(jnp.int32)

    return jax.jit(batch)


def solve_batch_trajectories(
    cfg: SimulationConfig,
    coeffs: RHSCoeffs,
    A0: np.ndarray,
    *,
    frame: str = "rotating",
    mesh=None,
    unroll: int = 4,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Batched solve returning full decimated trajectories
    ``(z (S+1,), A (B, S+1, 4) complex, ok (B,))``.  Pass ``mesh`` to shard
    the batch axis (trajectories gather back to the host).

    ``cfg.integrator`` may be 'rk4', 'rk45' or Adams multistep 'ab4'/'abm4'
    (x64/x32 scan path; same-method parity only)."""
    validate_config(cfg)
    reject_non_ode(cfg, "the 4-wave sweep engine")
    precision = validate_precision(
        require_non_df32(cfg.precision, family="4-wave trajectory mode")
    )
    rdt = real_dtype(precision)
    A0 = np.asarray(A0)
    B = A0.shape[0]
    n_steps = int(round(cfg.z_max / cfg.dz))
    adaptive = cfg.integrator.lower() == "rk45"
    if adaptive:
        if precision == "df32":
            raise ValueError(
                "integrator='rk45' supports precision 'x64'/'x32' only"
            )
        rk45_tail = (n_steps % int(cfg.save_every)) > 0
        solver = _batch_adaptive_traj_solver(
            frame, float(cfg.rtol), float(cfg.atol), int(cfg.max_steps),
            rk45_tail,
        )
    else:
        solver = _batch_traj_solver(
            n_steps, int(cfg.save_every), bool(cfg.check_nan), frame, unroll,
            cfg.integrator.lower(),
        )
    gamma = np.broadcast_to(np.asarray(coeffs.gamma, float), (B,))
    alpha = np.broadcast_to(np.asarray(coeffs.alpha, float), (B,))
    dbeta = np.broadcast_to(np.asarray(coeffs.delta_beta, float), (B,))

    n_orig = B
    y0_ri = jnp.asarray(ri_pack_host(A0, rdt))
    coeffs_dev = RHSCoeffs(
        gamma=jnp.asarray(gamma, dtype=rdt),
        alpha=jnp.asarray(alpha, dtype=rdt),
        delta_beta=jnp.asarray(dbeta, dtype=rdt),
    )
    if mesh is not None:
        from .mesh import batch_sharding, pad_batch, put_global

        ndev = int(np.prod(list(mesh.shape.values())))
        A0_p, n_orig = pad_batch(A0, ndev)
        sh = batch_sharding(mesh)
        y0_ri = put_global(ri_pack_host(A0_p, rdt), sh)
        coeffs_dev = RHSCoeffs(
            gamma=put_global(np.asarray(pad_batch(gamma, ndev)[0], dtype=rdt), sh),
            alpha=put_global(np.asarray(pad_batch(alpha, ndev)[0], dtype=rdt), sh),
            delta_beta=put_global(np.asarray(pad_batch(dbeta, ndev)[0], dtype=rdt), sh),
        )
    from .mesh import fetch_global

    if adaptive:
        n_chunks = n_steps // int(cfg.save_every)
        # trailing n_steps % save_every partial span integrated but unsaved
        # (folds into ok only -- the framework-wide decimation contract)
        z_grid = np.arange(n_chunks + 1, dtype=np.float64) * (
            int(cfg.save_every) * float(cfg.dz)
        )
        y_ri, ok = solver(y0_ri, coeffs_dev, jnp.asarray(z_grid, dtype=rdt),
                          jnp.asarray(n_steps * float(cfg.dz), dtype=rdt))
        z = z_grid
    else:
        z, y_ri, ok = solver(
            y0_ri, coeffs_dev,
            jnp.asarray(0.0, dtype=rdt), jnp.asarray(cfg.dz, dtype=rdt),
        )
        z = fetch_global(z).astype(np.float64)
    A = ri_unpack_host(fetch_global(y_ri))[:n_orig]
    return z, A, fetch_global(ok).astype(bool)[:n_orig]


# ---------------------------------------------------------------------------
# Frequency-plan batching helpers (masked, host-side f64)
# ---------------------------------------------------------------------------

def _batched_plan_from_wavelengths(lam1: float, lam2: float, lam3: np.ndarray):
    """(B,) lambda3 -> ((B, 4) omegas, (B,) valid mask).

    Points whose inferred idler frequency is non-positive are masked instead
    of raised (the batched analog of the reference's per-point try/except ->
    NaN, ``scan_mismtach.py:391-392``).
    """
    w1 = TWO_PI * C0 / float(lam1)
    w2 = TWO_PI * C0 / float(lam2)
    w3 = TWO_PI * C0 / np.asarray(lam3, dtype=float)
    w4 = w1 + w2 - w3
    valid = np.isfinite(w3) & (w3 > 0) & np.isfinite(w4) & (w4 > 0)
    w4_safe = np.where(valid, w4, w3)  # placeholder keeps math finite
    om = np.stack([np.full_like(w3, w1), np.full_like(w3, w2), w3, w4_safe], axis=-1)
    return om, valid


def _batched_delta_beta(
    omegas_m: np.ndarray,
    disp_m: Optional[DispersionParams],
    pm_cfg: PhaseMatchingConfig,
) -> np.ndarray:
    """Vectorized dbeta [1/m] for a (B, 4) plan (host f64)."""
    if pm_cfg.method == PhaseMatchingMethod.PROVIDED:
        return np.broadcast_to(
            np.asarray(pm_cfg.provided_delta_beta, dtype=float), omegas_m.shape[:-1]
        ).copy()
    if disp_m is None:
        raise ValueError("dispersion must be provided unless method == 'provided'")
    if pm_cfg.method == PhaseMatchingMethod.GENERAL_TAYLOR:
        return np.asarray(
            delta_beta_from_omegas(
                omegas_m, disp_m, max_order=pm_cfg.max_order,
                atol=pm_cfg.atol, rtol=max(pm_cfg.rtol, 1e-9),
            )
        )
    if pm_cfg.method == PhaseMatchingMethod.SYMMETRIC_EVEN:
        oc = 0.5 * (omegas_m[..., 0] + omegas_m[..., 1])
        od = 0.5 * (omegas_m[..., 0] - omegas_m[..., 1])
        Om = omegas_m[..., 2] - oc
        return np.asarray(
            delta_beta_symmetric(oc, od, Om, disp_m, even_orders=pm_cfg.even_orders)
        )
    raise ValueError(f"Unsupported phase-matching method: {pm_cfg.method!r}")


def _gain_from_power(
    P_metric: np.ndarray, P3_0: float, ok: np.ndarray, gain_unit: str
) -> np.ndarray:
    g = np.where(ok, P_metric / P3_0, np.nan)
    g = np.where(np.isfinite(g) & (g > 0), g, np.nan)
    if gain_unit == "db":
        with np.errstate(invalid="ignore"):
            return 10.0 * np.log10(g)
    return g


def _norm_gain_unit(gain_unit: str) -> str:
    gu = str(gain_unit).strip().lower()
    if gu not in VALID_GAIN_UNITS:
        raise ValueError("gain_unit must be 'dB' or 'linear'")
    return gu


def _x_wavelength(lam3: np.ndarray, return_wavelength_unit: str) -> np.ndarray:
    return np.asarray(lam3, dtype=float) * wavelength_scale(return_wavelength_unit)


# ---------------------------------------------------------------------------
# Public sweep APIs
# ---------------------------------------------------------------------------

def gain_and_dbeta_spectrum(
    *,
    cfg: SimulationConfig,
    lambda_p1_m: float,
    lambda_p2_m: float,
    lambda_signal_m: Sequence[float],
    gamma: float,
    alpha: float,
    p_in: Sequence[float],
    phase_in: Optional[Sequence[float]] = None,
    dispersion: Optional[DispersionParams] = None,
    phase_matching_cfg: Optional[PhaseMatchingConfig] = None,
    length_unit: str = "m",
    return_wavelength_unit: str = "nm",
    gain_unit: str = "dB",
    gain_mode: GainMode = "max",
    frame: str = "rotating",
    mesh=None,
    compute_dbeta: bool = True,
    verbose: bool = False,
    engine: str = "auto",
) -> SweepResult:
    """Sweep the signal wavelength lambda3, computing max (or end) signal gain
    and (optionally) dbeta(lambda3) -- the batched re-design of reference
    ``plot_max_gain_and_dbeta_vs_lambda_signal`` (``scan_mismtach.py:588-783``)
    and ``plot_max_signal_gain_vs_lambda_signal`` (:262-430).

    All B wavelength points integrate in ONE XLA program; pass ``mesh`` to
    shard the batch over devices.
    """
    validate_config(cfg)
    reject_non_ode(cfg, "the 4-wave sweep engine")
    gu = _norm_gain_unit(gain_unit)
    if gain_mode not in VALID_GAIN_MODES:
        raise ValueError(f"Unknown gain_mode={gain_mode!r}. Use 'end' or 'max'.")

    lam3 = np.asarray(list(lambda_signal_m), dtype=float)
    if lam3.ndim != 1 or lam3.size == 0:
        raise ValueError("lambda_signal_m must be a non-empty 1D sequence")
    if not np.all(np.isfinite(lam3)) or np.any(lam3 <= 0.0):
        raise ValueError("lambda_signal_m must contain finite positive wavelengths (m)")

    p0 = _to_power_array(p_in)
    if p0[2] <= 0.0:
        raise ValueError("p_in[2] (signal seed power) must be > 0 to define gain")
    ph0 = _to_phase_array(phase_in)

    scale_to_m = length_scale_to_m(length_unit)

    disp_m = dispersion.scaled(scale_to_m) if dispersion is not None else None
    pm_cfg = phase_matching_cfg
    if pm_cfg is None:
        if disp_m is None:
            raise ValueError("Provide dispersion or an explicit phase_matching_cfg")
        pm_cfg = PhaseMatchingConfig(
            method=PhaseMatchingMethod.SYMMETRIC_EVEN, max_order=4,
            even_orders=(2, 4), atol=0.0, rtol=1e-12,
        )
    pm_cfg = pm_cfg.scaled(scale_to_m)

    omegas, valid = _batched_plan_from_wavelengths(
        float(lambda_p1_m), float(lambda_p2_m), lam3
    )
    dbeta_m = _batched_delta_beta(omegas, disp_m, pm_cfg)

    B = lam3.size
    A0 = np.broadcast_to(
        np.sqrt(p0).astype(np.complex128) * np.exp(1j * ph0), (B, 4)
    ).copy()

    cfg_m = cfg if scale_to_m == 1.0 else dataclasses.replace(
        cfg, z_max=cfg.z_max * scale_to_m, dz=cfg.dz * scale_to_m
    )
    coeffs = RHSCoeffs(
        gamma=np.full(B, float(gamma) / scale_to_m),
        alpha=np.full(B, float(alpha) / scale_to_m),
        delta_beta=dbeta_m,
    )

    res = solve_batch(
        cfg_m, coeffs, A0, frame=frame, mesh=mesh, engine=engine,
        progress=_default_progress if verbose else None,
    )
    P3_metric = res.P_max[:, 2] if gain_mode == "max" else res.P_end[:, 2]
    ok = res.ok & valid
    elapsed_s = res.elapsed_s
    gain = _gain_from_power(P3_metric, float(p0[2]), ok, gu)

    dbeta_out = None
    if compute_dbeta:
        # report in 1/length_unit (consistent with gamma), like the reference
        dbeta_out = np.where(valid, dbeta_m * scale_to_m, np.nan)

    x = _x_wavelength(lam3, return_wavelength_unit)
    pts = B / elapsed_s if elapsed_s > 0 else float("inf")
    if verbose:
        print(
            f"[sweep] {B} points in {elapsed_s:.3f} s "
            f"({pts:.1f} pt/s, {B * int(round(cfg.z_max / cfg.dz))} RK4 steps total)"
        )
    return SweepResult(
        x=x, gain=gain, dbeta=dbeta_out, ok=ok, gain_unit=gu,
        elapsed_s=elapsed_s, points_per_s=pts,
    )


def gain_spectrum(**kwargs) -> SweepResult:
    """Signal-wavelength gain sweep (no dbeta track): batched re-design of
    reference ``plot_max_signal_gain_vs_lambda_signal`` (scan_mismtach.py:262)."""
    kwargs.setdefault("compute_dbeta", False)
    return gain_and_dbeta_spectrum(**kwargs)


def dbeta_spectrum(
    *,
    lambda_p1_m: float,
    lambda_p2_m: float,
    lambda_signal_m: Sequence[float],
    dispersion: DispersionParams,
    phase_matching_cfg: Optional[PhaseMatchingConfig] = None,
    length_unit: str = "m",
    return_wavelength_unit: str = "nm",
) -> Tuple[np.ndarray, np.ndarray]:
    """dbeta(lambda3) alone -- the *working* re-design of the reference's
    broken ``plot_dbeta_vs_lambda_signal`` helper stack (scan_mismtach.py:433-470
    raises AttributeError and uses an inverted sign convention; see SURVEY.md
    section 8.3).  Sign convention here is the project-wide canonical
    dbeta = beta(w3)+beta(w4)-beta(w1)-beta(w2)."""
    lam3 = np.asarray(list(lambda_signal_m), dtype=float)
    scale_to_m = length_scale_to_m(length_unit)
    disp_m = dispersion.scaled(scale_to_m)
    pm_cfg = phase_matching_cfg or PhaseMatchingConfig(
        method=PhaseMatchingMethod.SYMMETRIC_EVEN, even_orders=(2, 4), max_order=4
    )
    omegas, valid = _batched_plan_from_wavelengths(
        float(lambda_p1_m), float(lambda_p2_m), lam3
    )
    dbeta_m = _batched_delta_beta(omegas, disp_m, pm_cfg.scaled(scale_to_m))
    dbeta_out = np.where(valid, dbeta_m * scale_to_m, np.nan)
    return _x_wavelength(lam3, return_wavelength_unit), dbeta_out


def mismatch_scan(
    *,
    cfg: SimulationConfig,
    gamma: float,
    alpha: float,
    p_in: Sequence[float],
    delta_beta_values: Sequence[float],
    phase_in: Optional[Sequence[float]] = None,
    gain_mode: GainMode = "end",
    gain_unit: str = "linear",
    length_unit: str = "km",
    frame: str = "rotating",
    mesh=None,
    verbose: bool = False,
    engine: str = "auto",
) -> Tuple[SweepResult, SweepResult]:
    """Sweep an explicit list of phase-mismatch values (PROVIDED dbeta per
    instance) and return (signal_gain, idler_transfer) sweeps.

    This is the working, batched realization of what the reference's
    ``scan_mismatch_seeded_signal`` intends (``scan_mismtach.py:43-259`` --
    stale there: it calls ``run_single_simulation(beta=...)`` which no longer
    exists).  Gain definitions follow the reference: Gs = P3_metric/P3(0),
    Gi = P4_metric/P3(0) (idler normalized to the *signal* seed, since the
    idler seed may be zero).
    """
    validate_config(cfg)
    reject_non_ode(cfg, "the 4-wave sweep engine")
    gu = _norm_gain_unit(gain_unit)
    if gain_mode not in VALID_GAIN_MODES:
        raise ValueError(f"Unknown gain_mode={gain_mode!r}. Use 'end' or 'max'.")
    db = np.asarray(list(delta_beta_values), dtype=float)
    if db.ndim != 1 or db.size == 0:
        raise ValueError("delta_beta_values must be a non-empty 1D sequence")
    p0 = _to_power_array(p_in)
    if p0[2] <= 0.0:
        raise ValueError("p_in[2] (signal seed power) must be > 0 to define gain")
    ph0 = _to_phase_array(phase_in)

    scale_to_m = length_scale_to_m(length_unit)
    B = db.size
    A0 = np.broadcast_to(
        np.sqrt(p0).astype(np.complex128) * np.exp(1j * ph0), (B, 4)
    ).copy()
    cfg_m = cfg if scale_to_m == 1.0 else dataclasses.replace(
        cfg, z_max=cfg.z_max * scale_to_m, dz=cfg.dz * scale_to_m
    )
    coeffs = RHSCoeffs(
        gamma=np.full(B, float(gamma) / scale_to_m),
        alpha=np.full(B, float(alpha) / scale_to_m),
        delta_beta=db / scale_to_m,
    )
    res = solve_batch(
        cfg_m, coeffs, A0, frame=frame, mesh=mesh, engine=engine,
        progress=_default_progress if verbose else None,
    )

    P3 = res.P_max[:, 2] if gain_mode == "max" else res.P_end[:, 2]
    P4 = res.P_max[:, 3] if gain_mode == "max" else res.P_end[:, 3]
    gs = _gain_from_power(P3, float(p0[2]), res.ok, gu)
    gi = _gain_from_power(P4, float(p0[2]), res.ok, gu)
    pts = B / res.elapsed_s if res.elapsed_s > 0 else float("inf")
    if verbose:
        print(f"[mismatch_scan] {B} points in {res.elapsed_s:.3f} s ({pts:.1f} pt/s)")
    sig = SweepResult(x=db, gain=gs, dbeta=None, ok=res.ok, gain_unit=gu,
                      elapsed_s=res.elapsed_s, points_per_s=pts)
    idl = SweepResult(x=db, gain=gi, dbeta=None, ok=res.ok, gain_unit=gu,
                      elapsed_s=res.elapsed_s, points_per_s=pts)
    return sig, idl


def psa_phase_sweep(
    *,
    cfg: SimulationConfig,
    gamma: float,
    alpha: float,
    p_in: Sequence[float],
    signal_phases: Sequence[float],
    delta_beta: float = 0.0,
    base_phase_in: Optional[Sequence[float]] = None,
    omega: Optional[Sequence[float]] = None,
    dispersion: Optional[DispersionParams] = None,
    phase_matching_cfg: Optional[PhaseMatchingConfig] = None,
    gain_mode: GainMode = "end",
    gain_unit: str = "dB",
    length_unit: str = "m",
    frame: str = "rotating",
    mesh=None,
    engine: str = "auto",
) -> SweepResult:
    """Phase-sensitive amplification: gain vs input *signal phase* with both
    pumps and (optionally) an idler seed fixed -- BASELINE.json config 3.

    Each phase point is an instance of the same physics with a rotated signal
    seed: A3(0) = sqrt(P3) e^{i phi}.  Batched like every other sweep.
    """
    validate_config(cfg)
    reject_non_ode(cfg, "the 4-wave sweep engine")
    gu = _norm_gain_unit(gain_unit)
    phases = np.asarray(list(signal_phases), dtype=float)
    if phases.ndim != 1 or phases.size == 0:
        raise ValueError("signal_phases must be a non-empty 1D sequence")
    p0 = _to_power_array(p_in)
    if p0[2] <= 0.0:
        raise ValueError("p_in[2] (signal seed power) must be > 0 to define gain")
    ph_base = _to_phase_array(base_phase_in)

    scale_to_m = length_scale_to_m(length_unit)
    if phase_matching_cfg is not None or dispersion is not None:
        pm = (phase_matching_cfg or PhaseMatchingConfig()).scaled(scale_to_m)
        if pm.method == PhaseMatchingMethod.PROVIDED:
            pdb = np.asarray(pm.provided_delta_beta)
            if pdb.size != 1:
                raise ValueError(
                    "psa_phase_sweep needs a scalar provided_delta_beta "
                    f"(all phase instances share one dbeta); got shape {pdb.shape}"
                )
            db_m = float(pdb.reshape(()))
        else:
            if omega is None:
                raise ValueError(
                    "omega is required when using dispersion-aware phase matching"
                )
            om = np.asarray(list(omega), dtype=float)[None, :]
            disp_m = dispersion.scaled(scale_to_m) if dispersion is not None else None
            db_m = float(_batched_delta_beta(om, disp_m, pm)[0])
    else:
        db_m = float(delta_beta) / scale_to_m

    B = phases.size
    ph = np.broadcast_to(ph_base, (B, 4)).copy()
    ph[:, 2] = ph_base[2] + phases
    A0 = np.sqrt(p0)[None, :] * np.exp(1j * ph)

    cfg_m = cfg if scale_to_m == 1.0 else dataclasses.replace(
        cfg, z_max=cfg.z_max * scale_to_m, dz=cfg.dz * scale_to_m
    )
    coeffs = RHSCoeffs(
        gamma=np.full(B, float(gamma) / scale_to_m),
        alpha=np.full(B, float(alpha) / scale_to_m),
        delta_beta=np.full(B, db_m),
    )
    res = solve_batch(cfg_m, coeffs, A0.astype(np.complex128), frame=frame,
                      mesh=mesh, engine=engine)
    P3 = res.P_max[:, 2] if gain_mode == "max" else res.P_end[:, 2]
    gain = _gain_from_power(P3, float(p0[2]), res.ok, gu)
    pts = B / res.elapsed_s if res.elapsed_s > 0 else float("inf")
    return SweepResult(x=phases, gain=gain, dbeta=None, ok=res.ok, gain_unit=gu,
                       elapsed_s=res.elapsed_s, points_per_s=pts)


def gain_map_power_wavelength(
    *,
    cfg: SimulationConfig,
    lambda_p1_m: float,
    lambda_p2_m: float,
    lambda_signal_m: Sequence[float],
    pump_powers_W: Sequence[float],
    gamma: float,
    alpha: float,
    p_seed: Tuple[float, float] = (1e-7, 0.0),
    phase_in: Optional[Sequence[float]] = None,
    dispersion: Optional[DispersionParams] = None,
    phase_matching_cfg: Optional[PhaseMatchingConfig] = None,
    length_unit: str = "m",
    return_wavelength_unit: str = "nm",
    gain_unit: str = "dB",
    gain_mode: GainMode = "max",
    frame: str = "rotating",
    mesh=None,
    engine: str = "auto",
    verbose: bool = False,
) -> GainMapResult:
    """2-D scan: (pump power) x (signal wavelength) -> gain map.

    BASELINE.json config 4: 10^4+ instances batched in one program.  Returns
    a :class:`GainMapResult` (iterable as ``(x, pump_powers, gain)``), with
    the per-cell ``ok`` mask and persistence via
    ``io_fwm.save_gain_map_npz``.
    """
    validate_config(cfg)
    reject_non_ode(cfg, "the 4-wave sweep engine")
    gu = _norm_gain_unit(gain_unit)
    lam3 = np.asarray(list(lambda_signal_m), dtype=float)
    pows = np.asarray(list(pump_powers_W), dtype=float)
    if np.any(pows < 0) or not np.all(np.isfinite(pows)):
        raise ValueError("pump_powers_W must be finite and non-negative")
    p_sig, p_idl = float(p_seed[0]), float(p_seed[1])
    if p_sig <= 0:
        raise ValueError("p_seed[0] (signal seed) must be > 0 to define gain")
    ph0 = _to_phase_array(phase_in)

    scale_to_m = length_scale_to_m(length_unit)
    disp_m = dispersion.scaled(scale_to_m) if dispersion is not None else None
    pm_cfg = phase_matching_cfg or PhaseMatchingConfig(
        method=PhaseMatchingMethod.SYMMETRIC_EVEN, even_orders=(2, 4), max_order=4
    )
    pm_cfg = pm_cfg.scaled(scale_to_m)

    omegas, valid_l = _batched_plan_from_wavelengths(
        float(lambda_p1_m), float(lambda_p2_m), lam3
    )
    dbeta_l = _batched_delta_beta(omegas, disp_m, pm_cfg)

    Np, Nl = pows.size, lam3.size
    B = Np * Nl
    # grid flatten: index = ip * Nl + il
    dbeta_flat = np.tile(dbeta_l, Np)
    valid_flat = np.tile(valid_l, Np)
    p_grid = np.repeat(pows, Nl)

    P0 = np.stack(
        [p_grid, p_grid, np.full(B, p_sig), np.full(B, p_idl)], axis=-1
    )
    A0 = np.sqrt(P0) * np.exp(1j * ph0)[None, :]

    cfg_m = cfg if scale_to_m == 1.0 else dataclasses.replace(
        cfg, z_max=cfg.z_max * scale_to_m, dz=cfg.dz * scale_to_m
    )
    coeffs = RHSCoeffs(
        gamma=np.full(B, float(gamma) / scale_to_m),
        alpha=np.full(B, float(alpha) / scale_to_m),
        delta_beta=dbeta_flat,
    )
    res = solve_batch(
        cfg_m, coeffs, A0.astype(np.complex128), frame=frame,
        mesh=mesh, engine=engine,
        progress=_default_progress if verbose else None,
    )
    P3 = res.P_max[:, 2] if gain_mode == "max" else res.P_end[:, 2]
    ok = res.ok & valid_flat
    gain = _gain_from_power(P3, p_sig, ok, gu)
    pts = B / res.elapsed_s if res.elapsed_s > 0 else float("inf")
    return GainMapResult(
        x=_x_wavelength(lam3, return_wavelength_unit),
        pump_powers=pows,
        gain=gain.reshape(Np, Nl),
        ok=ok.reshape(Np, Nl),
        gain_unit=gu,
        elapsed_s=res.elapsed_s,
        points_per_s=pts,
    )
