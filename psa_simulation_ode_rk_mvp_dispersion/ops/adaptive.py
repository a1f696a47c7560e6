"""Embedded adaptive Runge-Kutta (Dormand-Prince 5(4)) integration.

The reference reserves an ``integrator`` slot but only ever dispatches fixed
RK4 (``config.py:89`` rejects anything else); BASELINE.json's target configs
call for "optional embedded RK45" and adaptive stepping for the N-wave comb.
This module supplies it, batched:

- The controller is a ``lax.while_loop`` with *static* bounds and masked
  updates, so it vmaps: a batch of instances advances in lockstep, each lane
  with its own (z, dt), finished lanes frozen by per-lane ``done`` masks.
  (JAX's vmapped while_loop runs the body while ANY lane is active; the body
  here is explicitly self-masking, which is what makes per-instance adaptive
  stepping sound under batching.)
- Dense output arrives on a *fixed* user grid: an outer ``lax.scan`` over
  output segments, an adaptive while_loop inside each segment.  Output shapes
  stay static -- the XLA requirement -- regardless of how many micro-steps any
  instance takes.
- Failure semantics match the framework's masked-NaN convention
  (``ops/integrators.py``): a lane whose error estimate goes non-finite or
  whose dt underflows is frozen and flagged, never raised.

Error control: standard weighted-RMS norm over real/imag components with
``scale = atol + rtol * max(|y|, |y_new|)``, PI-free step factor
``0.9 * err^(-1/5)`` clipped to [0.2, 5].
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, NamedTuple, Tuple

import jax
import numpy as np
import jax.numpy as jnp
from jax import lax

RHSFunction = Callable[[jax.Array, jax.Array, Any], jax.Array]

# Dormand-Prince 5(4) Butcher tableau (RK45 / MATLAB ode45 / SciPy RK45).
_C = (0.0, 1.0 / 5.0, 3.0 / 10.0, 4.0 / 5.0, 8.0 / 9.0, 1.0, 1.0)
_A = (
    (),
    (1.0 / 5.0,),
    (3.0 / 40.0, 9.0 / 40.0),
    (44.0 / 45.0, -56.0 / 15.0, 32.0 / 9.0),
    (19372.0 / 6561.0, -25360.0 / 2187.0, 64448.0 / 6561.0, -212.0 / 729.0),
    (9017.0 / 3168.0, -355.0 / 33.0, 46732.0 / 5247.0, 49.0 / 176.0, -5103.0 / 18656.0),
    (35.0 / 384.0, 0.0, 500.0 / 1113.0, 125.0 / 192.0, -2187.0 / 6784.0, 11.0 / 84.0),
)
# 5th-order solution weights == last A row + 0 (FSAL property).
_B5 = _A[6] + (0.0,)
# 4th-order embedded weights.
_B4 = (
    5179.0 / 57600.0, 0.0, 7571.0 / 16695.0, 393.0 / 640.0,
    -92097.0 / 339200.0, 187.0 / 2100.0, 1.0 / 40.0,
)

SAFETY = 0.9
MIN_FACTOR = 0.2
MAX_FACTOR = 5.0
ORDER_EXP = -1.0 / 5.0


def rk45_step(f: RHSFunction, z, y, dz, params) -> Tuple[jax.Array, jax.Array]:
    """One Dormand-Prince step: returns (y5, error_estimate_vector)."""
    ks = []
    for i in range(7):
        yi = y
        for j, aij in enumerate(_A[i]):
            if aij != 0.0:
                yi = yi + (dz * aij) * ks[j]
        ks.append(f(z + _C[i] * dz, yi, params))
    y5 = y
    err = jnp.zeros_like(y)
    for i in range(7):
        if _B5[i] != 0.0:
            y5 = y5 + (dz * _B5[i]) * ks[i]
        d = _B5[i] - _B4[i]
        if d != 0.0:
            err = err + (dz * d) * ks[i]
    return y5, err


def _error_norm(err, y, y_new, *, atol, rtol):
    """Weighted RMS of the error estimate (complex-aware)."""

    scale = atol + rtol * jnp.maximum(jnp.abs(y), jnp.abs(y_new))
    # identically-zero components (dark waves) with atol=0 give scale=0 AND
    # err=0: treat 0/0 as 0 instead of poisoning the norm with NaN
    e = jnp.abs(err)
    r = jnp.where(scale > 0, e / jnp.where(scale > 0, scale, 1.0), 0.0)
    return jnp.sqrt(jnp.mean(jnp.square(r)))


class _SegCarry(NamedTuple):
    z: jax.Array
    y: jax.Array
    dt: jax.Array
    ok: jax.Array            # bool: lane healthy
    n_accepted: jax.Array    # int32
    n_rejected: jax.Array    # int32


def _advance_segment(
    f: RHSFunction,
    carry: _SegCarry,
    z_end,
    params,
    *,
    rtol: float,
    atol: float,
    max_steps: int,
    dt_min_factor: float = 1e-12,
):
    """Adaptively advance one lane (or a vmapped batch of lanes) from carry.z
    to z_end.  Self-masking body: finished/failed lanes are no-ops."""
    span = jnp.abs(z_end - carry.z) + jnp.asarray(1.0, carry.z.dtype)

    def cond(state):
        c, it = state
        active = (c.z < z_end) & c.ok & (it < max_steps)
        return active

    def body(state):
        c, it = state
        # Per-lane activity mask: under vmap the loop body runs for every lane
        # while ANY lane's cond holds; finished/failed lanes must be no-ops.
        active = (c.z < z_end) & c.ok

        dt_min = dt_min_factor * span
        # clamp step into the remaining interval; force exact landing
        remaining = z_end - c.z
        dt = jnp.minimum(c.dt, remaining)
        y_new, err = rk45_step(f, c.z, c.y, dt, params)
        enorm = _error_norm(err, c.y, y_new, atol=atol, rtol=rtol)
        finite = jnp.isfinite(enorm) & _finite_state(y_new)

        accept = active & finite & (enorm <= 1.0)
        # step-size update
        factor = jnp.where(
            finite,
            jnp.clip(SAFETY * jnp.power(jnp.maximum(enorm, 1e-16), ORDER_EXP),
                     MIN_FACTOR, MAX_FACTOR),
            jnp.asarray(0.5, c.dt.dtype),
        )
        dt_next = jnp.where(active, jnp.maximum(c.dt * factor, dt_min), c.dt)
        # dt underflow with rejection => lane failed
        failed = active & (~accept) & (dt <= dt_min)

        z_out = jnp.where(accept, c.z + dt, c.z)
        y_out = jnp.where(accept, y_new, c.y)
        ok_out = c.ok & ~failed
        n_acc = c.n_accepted + jnp.where(accept, 1, 0).astype(jnp.int32)
        n_rej = c.n_rejected + jnp.where(active & ~accept, 1, 0).astype(jnp.int32)
        return (_SegCarry(z_out, y_out, dt_next, ok_out, n_acc, n_rej), it + 1)

    (out, _it) = lax.while_loop(cond, body, (carry, jnp.asarray(0, jnp.int32)))
    # A lane that exhausted max_steps without reaching z_end is a failure, not
    # a silent short integration.
    reached = out.z >= z_end
    out = _SegCarry(out.z, out.y, out.dt, out.ok & reached,
                    out.n_accepted, out.n_rejected)
    return out


def _finite_state(y) -> jax.Array:
    if jnp.iscomplexobj(y):
        return jnp.all(jnp.isfinite(y.real) & jnp.isfinite(y.imag))
    return jnp.all(jnp.isfinite(y))


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class AdaptiveResult:
    z_saved: jax.Array      # (S,) the requested output grid
    y_saved: jax.Array      # (S, *state)
    y_final: jax.Array
    ok: jax.Array
    n_accepted: jax.Array
    n_rejected: jax.Array


def integrate_adaptive_grid(
    f: RHSFunction,
    y0,
    params,
    *,
    z_grid,
    rtol: float = 1e-9,
    atol: float = 1e-12,
    dt0=None,
    max_steps_per_segment: int = 10_000,
    z_final=None,
) -> AdaptiveResult:
    """Dormand-Prince 5(4) integration with dense output on ``z_grid``.

    ``z_grid`` is a static-length increasing array (row 0 = initial z).  The
    solver scans over segments [z_i, z_{i+1}], adapting micro-steps inside
    each; output rows land exactly on the grid.  jit/vmap-compatible.

    ``z_final`` (optional, > ``z_grid[-1]``) realizes the framework-wide
    save-decimation contract for trailing ``n_steps % save_every`` partial
    spans: the extra segment ``[z_grid[-1], z_final]`` is integrated but
    UNSAVED -- it folds into ``ok``/``n_accepted``/``n_rejected`` only,
    while ``y_final`` and the saved rows stay at the last grid point
    (matching the fixed-step engines' remainder block).
    """
    y0 = jnp.asarray(y0)
    zg = jnp.asarray(z_grid)
    if zg.ndim != 1 or int(zg.shape[0]) < 1:
        raise ValueError("z_grid must be 1-D with at least 1 point")
    rdt = zg.dtype if jnp.issubdtype(zg.dtype, jnp.floating) else jnp.result_type(float)
    zg = zg.astype(rdt)

    if dt0 is None:
        dt0 = (zg[1] - zg[0]) * 0.1
    carry = _SegCarry(
        z=zg[0],
        y=y0,
        dt=jnp.asarray(dt0, dtype=rdt),
        ok=jnp.asarray(True),
        n_accepted=jnp.asarray(0, jnp.int32),
        n_rejected=jnp.asarray(0, jnp.int32),
    )

    def seg(c: _SegCarry, z_end):
        c = _advance_segment(
            f, c, z_end, params,
            rtol=rtol, atol=atol, max_steps=max_steps_per_segment,
        )
        # land exactly on the grid point for the next segment
        c = _SegCarry(z_end, c.y, c.dt, c.ok, c.n_accepted, c.n_rejected)
        return c, c.y

    c_final, ys = lax.scan(seg, carry, zg[1:])
    y_saved = jnp.concatenate([y0[None], ys], axis=0)

    if z_final is not None:
        tail = _advance_segment(
            f, c_final, jnp.asarray(z_final, dtype=rdt), params,
            rtol=rtol, atol=atol, max_steps=max_steps_per_segment,
        )
        c_final = _SegCarry(c_final.z, c_final.y, c_final.dt, tail.ok,
                            tail.n_accepted, tail.n_rejected)

    return AdaptiveResult(
        z_saved=zg,
        y_saved=y_saved,
        y_final=c_final.y,
        ok=c_final.ok,
        n_accepted=c_final.n_accepted,
        n_rejected=c_final.n_rejected,
    )


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class AdaptiveReduceResult:
    reduction: Any
    y_final: jax.Array
    ok: jax.Array
    n_accepted: jax.Array
    n_rejected: jax.Array


def integrate_adaptive_reduce(
    f: RHSFunction,
    y0,
    params,
    *,
    z_grid,
    reduce_init,
    reduce_fn,
    rtol: float = 1e-9,
    atol: float = 1e-12,
    dt0=None,
    max_steps_per_segment: int = 10_000,
    z_final=None,
) -> AdaptiveReduceResult:
    """Like :func:`integrate_adaptive_grid` but folds each grid-point state
    into a running reduction instead of materializing the trajectory --
    the adaptive analog of ``ops.integrators.integrate_reduce``.  Memory is
    O(state), independent of grid length, so huge batches of sweeps fit in
    HBM.  ``reduce_fn(acc, y) -> acc`` is applied at every grid point after
    the initial one; seed ``reduce_init`` with the z=0 contribution.
    ``z_final``: trailing unsaved span, ok/counters only (see
    :func:`integrate_adaptive_grid`).
    """
    y0 = jnp.asarray(y0)
    zg = jnp.asarray(z_grid)
    if zg.ndim != 1 or int(zg.shape[0]) < 1:
        raise ValueError("z_grid must be 1-D with at least 1 point")
    rdt = zg.dtype if jnp.issubdtype(zg.dtype, jnp.floating) else jnp.result_type(float)
    zg = zg.astype(rdt)

    if dt0 is None:
        dt0 = (zg[1] - zg[0]) * 0.1
    carry = _SegCarry(
        z=zg[0],
        y=y0,
        dt=jnp.asarray(dt0, dtype=rdt),
        ok=jnp.asarray(True),
        n_accepted=jnp.asarray(0, jnp.int32),
        n_rejected=jnp.asarray(0, jnp.int32),
    )

    def seg(state, z_end):
        c, acc = state
        c = _advance_segment(
            f, c, z_end, params,
            rtol=rtol, atol=atol, max_steps=max_steps_per_segment,
        )
        c = _SegCarry(z_end, c.y, c.dt, c.ok, c.n_accepted, c.n_rejected)
        acc = reduce_fn(acc, c.y)
        return (c, acc), None

    (c_final, acc), _ = lax.scan(seg, (carry, reduce_init), zg[1:])
    if z_final is not None:
        tail = _advance_segment(
            f, c_final, jnp.asarray(z_final, dtype=rdt), params,
            rtol=rtol, atol=atol, max_steps=max_steps_per_segment,
        )
        c_final = _SegCarry(c_final.z, c_final.y, c_final.dt, tail.ok,
                            tail.n_accepted, tail.n_rejected)
    return AdaptiveReduceResult(
        reduction=acc,
        y_final=c_final.y,
        ok=c_final.ok,
        n_accepted=c_final.n_accepted,
        n_rejected=c_final.n_rejected,
    )


# ---------------------------------------------------------------------------
# Runner glue: rk45 trajectory with the fixed-RK4 output contract
# ---------------------------------------------------------------------------

def run_adaptive_trajectory(
    cfg,
    model_params,
    coeffs,
    A0,
    *,
    frame: str,
    length_unit: str,
    return_length_unit,
    z0_m: float = 0.0,
):
    """Back end of ``run_single_simulation`` for ``cfg.integrator == 'rk45'``.

    Output contract mirrors the rk4 path: states on the decimated grid
    ``z_k = k * save_every * dz`` (plus z=0), z in ``return_length_unit``.
    """
    from ..utils.precision import real_dtype, validate_precision
    from ..utils.units import length_scale_to_m
    from .rhs import rhs_yaman, rhs_yaman_autonomous, rotating_to_lab

    precision = validate_precision(cfg.precision)
    rdt = real_dtype(precision)

    dz_m = model_params.grid.dz_m
    length_m = model_params.fiber.length_m
    n_steps = int(round(length_m / dz_m))
    n_chunks = n_steps // cfg.save_every
    if n_chunks == 0:
        # saved grid is just row 0 (the ICs); nothing observable to integrate
        from ..utils.units import length_scale_to_m as _scale

        out_unit = length_unit if return_length_unit is None else return_length_unit
        return (
            np.asarray([z0_m]) / _scale(out_unit),
            np.asarray(A0, dtype=np.complex128)[None, :],
        )
    z_grid = z0_m + np.arange(n_chunks + 1, dtype=np.float64) * (cfg.save_every * dz_m)

    rhs = rhs_yaman if frame == "lab" else rhs_yaman_autonomous

    from ..utils.packing import complex_to_ri, ri_pack_host, ri_to_complex, ri_unpack_host

    # trailing n_steps % save_every partial span integrated but unsaved
    # (folds into ok only -- the framework-wide decimation contract)
    solver = _adaptive_traj_solver(
        frame, float(cfg.rtol), float(cfg.atol), int(cfg.max_steps),
        (n_steps % int(cfg.save_every)) > 0,
    )
    y_ri, ok_i = solver(
        jnp.asarray(ri_pack_host(A0, rdt)), coeffs, jnp.asarray(z_grid, dtype=rdt),
        jnp.asarray(z0_m + n_steps * dz_m, dtype=rdt)
    )

    if cfg.check_nan and int(np.asarray(ok_i)) == 0:
        raise FloatingPointError(
            "NaN/Inf or step-size underflow during adaptive (rk45) integration"
        )

    y_saved = ri_unpack_host(np.asarray(y_ri))
    out_unit = length_unit if return_length_unit is None else return_length_unit
    out_scale = length_scale_to_m(out_unit)
    z_out = z_grid / out_scale
    return z_out, y_saved


@functools.lru_cache(maxsize=64)
def _adaptive_traj_solver(frame: str, rtol: float, atol: float,
                          max_steps: int, has_tail: bool = False):
    from .rhs import rhs_yaman, rhs_yaman_autonomous, rotating_to_lab
    from ..utils.packing import complex_to_ri, ri_to_complex

    rhs = rhs_yaman if frame == "lab" else rhs_yaman_autonomous

    def run(y0_ri, p, zg, z_final):
        res = integrate_adaptive_grid(
            rhs, ri_to_complex(y0_ri), p, z_grid=zg, rtol=rtol, atol=atol,
            max_steps_per_segment=max_steps,
            z_final=z_final if has_tail else None,
        )
        y_saved = res.y_saved
        if frame == "rotating":
            y_saved = rotating_to_lab(res.z_saved, y_saved, p)
        return complex_to_ri(y_saved).astype(y0_ri.dtype), res.ok.astype(jnp.int32)

    return jax.jit(run)
