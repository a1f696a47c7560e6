"""Adaptive (Dormand-Prince 5(4)) integration at the matched df32 tolerance.

Round-2 verdict gap #5/#8: ``integrator='rk45'`` + ``precision='df32'``
raised everywhere, capping adaptive sweeps without f64 at x32 accuracy
(~2e-5).  This module supplies the missing engine: the 4-wave rotating-frame
RHS in two-float arithmetic (``ops/df32_solver.rhs4_df32``) driven by the
framework's masked-lockstep DP45 controller (``ops/adaptive.py`` structure),
with the precision-critical pieces kept in two-float:

- Butcher-tableau combinations: the coefficients are split exactly from f64
  into TF pairs; rounding them to single f32 would perturb the order
  conditions at ~6e-8 -- a method error that accumulates past the 1e-9 bar.
- The step size ``h`` is carried as a TF: a segment-boundary-clipped step
  uses the EXACT two-float remainder, so every save-grid landing is exact to
  ~1e-14 relative (an f32 landing slips ~6e-8 of z, worth ~1e-7 of |A| over
  a sweep -- measured round 3 during design).
- z accumulates by error-free TwoSum.

Controller decisions (error norm, accept/reject, step factor) run in plain
f32 on the ``hi`` words: they only pick step sizes.  The f32 embedded
estimate has an ABSOLUTE cancellation floor ~6e-8 * h * |d_i k_i|; when the
true local error sits below it (tiny h / tight tolerance) the floor caps
the accepted step size (the floor grows ~h while the true error grows
~h^6, so acceptance is strictly conservative) -- the engine never accepts a
step the f64 controller would reject, it just takes somewhat smaller steps
than an ideal f64 controller at rtol <= 1e-10.  At rtol 1e-9 the cap binds
around dt ~ 1-2 m on the headline physics, still 5-10x the fixed-step dz.

XLA:CPU compiles two-float loop bodies pathologically slowly (CLAUDE.md
constraint 4) -- jitted-solver tests are opt-in; CPU coverage is eager
(tests/test_df32_adaptive.py).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import numpy as np
import jax.numpy as jnp
from jax import lax

from .adaptive import _A, _B4, _B5, MAX_FACTOR, MIN_FACTOR, ORDER_EXP, SAFETY
from .df32_solver import DF32Coeffs, make_df32_coeffs, rhs4_df32
from .twofloat import (
    CTF,
    TF,
    ctf_abs2,
    ctf_add,
    ctf_from_c128,
    ctf_mul_real,
    tf_from_f64,
    tf_sub,
)


def _tf_const(x: float) -> TF:
    """Split a scalar f64 coefficient exactly into a TF constant."""
    return tf_from_f64(np.float64(x))


@functools.lru_cache(maxsize=1)
def _tableau_tf():
    A = tuple(tuple(_tf_const(a) for a in row) for row in _A)
    B5 = tuple(_tf_const(b) for b in _B5)
    D = tuple(np.float32(b5 - b4) for b5, b4 in zip(_B5, _B4))
    return A, B5, D


def dp45_step_df32(y: CTF, h: TF, coeffs: DF32Coeffs):
    """One Dormand-Prince step on two-float state (autonomous RHS).

    Returns ``(y5 (CTF), err_re, err_im (f32 arrays))`` -- the 5th-order
    solution in two-float and the plain-f32 embedded error estimate.
    """
    A, B5, D = _tableau_tf()
    ks = []
    for i in range(7):
        yi = y
        for j, aij in enumerate(A[i]):
            if _A[i][j] != 0.0:
                yi = ctf_add(yi, ctf_mul_real(ks[j], _h_scale(aij, h)))
        ks.append(rhs4_df32(yi, coeffs))
    y5 = y
    for i in range(7):
        if _B5[i] != 0.0:
            y5 = ctf_add(y5, ctf_mul_real(ks[i], _h_scale(B5[i], h)))
    h_hi = h.hi + h.lo
    err_re = jnp.zeros_like(y.re.hi)
    err_im = jnp.zeros_like(y.im.hi)
    for i in range(7):
        if _B5[i] - _B4[i] != 0.0:
            err_re = err_re + (h_hi * D[i]) * ks[i].re.hi
            err_im = err_im + (h_hi * D[i]) * ks[i].im.hi
    return y5, err_re, err_im


def _h_scale(c: TF, h: TF) -> TF:
    """c * h for TF constant c and TF step h (double-double product)."""
    from .twofloat import tf_mul

    return tf_mul(c, h)


class _LaneCarry(NamedTuple):
    y: CTF
    z: TF              # scalar TF per lane
    dt: jax.Array      # f32 controller step memory
    ok: jax.Array
    landed: jax.Array  # reached the segment end
    n_acc: jax.Array
    n_rej: jax.Array


def _enorm(err_re, err_im, y: CTF, y5: CTF, *, atol, rtol):
    e = jnp.sqrt(err_re * err_re + err_im * err_im)
    ay = jnp.sqrt(y.re.hi**2 + y.im.hi**2)
    ay5 = jnp.sqrt(y5.re.hi**2 + y5.im.hi**2)
    scale = np.float32(atol) + np.float32(rtol) * jnp.maximum(ay, ay5)
    r = jnp.where(scale > 0, e / jnp.where(scale > 0, scale, 1.0), 0.0)
    return jnp.sqrt(jnp.mean(jnp.square(r)))


def _finite(y: CTF) -> jax.Array:
    """Whole-lane all-finite flag (scalar per vmapped lane; reduces EVERY
    axis, unlike twofloat.ctf_all_finite's trailing-axis reduction)."""
    return jnp.all(jnp.isfinite(y.re.hi)) & jnp.all(jnp.isfinite(y.im.hi))


def _freeze_lane(take, new: CTF, old: CTF) -> CTF:
    w = lambda n_, o: jnp.where(take, n_, o)  # noqa: E731
    return CTF(
        re=TF(w(new.re.hi, old.re.hi), w(new.re.lo, old.re.lo)),
        im=TF(w(new.im.hi, old.im.hi), w(new.im.lo, old.im.lo)),
    )


def _advance_segment_df32(carry: _LaneCarry, z_end: TF, coeffs: DF32Coeffs,
                          *, rtol: float, atol: float, max_steps: int,
                          dt_min: float):
    """Advance one lane (vmap lifts batches; self-masking body) from carry.z
    to exactly z_end (two-float landing)."""

    def cond(state):
        c, it = state
        return (~c.landed) & c.ok & (it < max_steps)

    def body(state):
        c, it = state
        active = (~c.landed) & c.ok

        rem = tf_sub(z_end, c.z)               # exact two-float remainder
        rem_f = rem.hi + rem.lo
        clipped = c.dt >= rem_f
        h = TF(
            jnp.where(clipped, rem.hi, c.dt),
            jnp.where(clipped, rem.lo, jnp.float32(0.0)),
        )
        y5, err_re, err_im = dp45_step_df32(c.y, h, coeffs)
        enorm = _enorm(err_re, err_im, c.y, y5, atol=atol, rtol=rtol)
        finite = jnp.isfinite(enorm) & _finite(y5)

        accept = active & finite & (enorm <= 1.0)
        factor = jnp.where(
            finite,
            jnp.clip(
                np.float32(SAFETY)
                * jnp.power(jnp.maximum(enorm, np.float32(1e-16)),
                            np.float32(ORDER_EXP)),
                np.float32(MIN_FACTOR), np.float32(MAX_FACTOR),
            ),
            jnp.float32(0.5),
        )
        h_used = h.hi + h.lo
        # accepted boundary-clipped steps keep the converged dt (tiny final
        # remainders would otherwise inflate dt by MAX_FACTOR)
        base = jnp.where(clipped & accept, c.dt, h_used * factor)
        dt_next = jnp.where(active, jnp.maximum(base, np.float32(dt_min)),
                            c.dt)
        failed = active & (~accept) & (h_used <= np.float32(dt_min))

        from .twofloat import tf_add

        z_new = tf_add(c.z, h)                 # == z_end exactly if clipped
        z_out = TF(
            jnp.where(accept, z_new.hi, c.z.hi),
            jnp.where(accept, z_new.lo, c.z.lo),
        )
        y_out = _freeze_lane(accept, y5, c.y)
        landed = c.landed | (accept & clipped)
        ok_out = c.ok & ~failed
        na = c.n_acc + jnp.where(accept, 1, 0).astype(jnp.int32)
        nr = c.n_rej + jnp.where(active & ~accept, 1, 0).astype(jnp.int32)
        return (_LaneCarry(y_out, z_out, dt_next, ok_out, landed, na, nr),
                it + 1)

    out, _it = lax.while_loop(
        cond, body, (carry, jnp.asarray(0, jnp.int32))
    )
    # max_steps exhausted short of the segment end = failure, not short run
    return out._replace(ok=out.ok & out.landed)


from .twofloat import tf_max as _tf_max  # noqa: E402


@functools.lru_cache(maxsize=64)
def _df32_adaptive_solver(rtol: float, atol: float, max_steps: int,
                          n_segments: int, dt_min: float,
                          has_tail: bool = False):
    """Jitted batched df32 DP45 reduce solve over a save grid.

    Inputs: y0 CTF (B, 4), coeffs (B,)-leaved DF32Coeffs, segment-end TF
    grid ((S+1,) hi/lo pairs), dt0 f32.  Returns f32/i32-only leaves
    (fetch-safe): P_max over saved samples incl. z=0, state at the LAST
    saved grid point, ok, accepted/rejected counters.  ``has_tail``: the
    grid carries ONE extra trailing point (the n_steps % save_every
    partial span) that is integrated but UNSAVED -- it folds into
    ok/counters only (the framework-wide decimation contract).
    """

    def run_one(y0: CTF, coeffs: DF32Coeffs, zg_hi, zg_lo, dt0):
        P0 = ctf_abs2(y0)
        lane = _LaneCarry(
            y=y0, z=TF(zg_hi[0], zg_lo[0]), dt=dt0,
            ok=_finite(y0), landed=jnp.asarray(False),
            n_acc=jnp.asarray(0, jnp.int32), n_rej=jnp.asarray(0, jnp.int32),
        )

        def seg(carry, idx):
            lane_c, pmax = carry
            z_end = TF(zg_hi[idx + 1], zg_lo[idx + 1])
            lane_c = lane_c._replace(landed=jnp.asarray(False))
            lane_c = _advance_segment_df32(
                lane_c, z_end, coeffs,
                rtol=rtol, atol=atol, max_steps=max_steps, dt_min=dt_min,
            )
            pmax = _tf_max(ctf_abs2(lane_c.y), pmax)
            return (lane_c, pmax), None

        (lane, pmax), _ = lax.scan(
            seg, (lane, P0), jnp.arange(n_segments, dtype=jnp.int32)
        )
        if has_tail:
            tail = _advance_segment_df32(
                lane._replace(landed=jnp.asarray(False)),
                TF(zg_hi[n_segments + 1], zg_lo[n_segments + 1]), coeffs,
                rtol=rtol, atol=atol, max_steps=max_steps, dt_min=dt_min,
            )
            lane = lane._replace(ok=tail.ok, n_acc=tail.n_acc,
                                 n_rej=tail.n_rej)
        return (
            pmax.hi, pmax.lo,
            lane.y.re.hi, lane.y.re.lo, lane.y.im.hi, lane.y.im.lo,
            lane.ok.astype(jnp.int32), lane.n_acc, lane.n_rej,
        )

    def batch(y0, coeffs, zg_hi, zg_lo, dt0):
        return jax.vmap(
            run_one, in_axes=(0, 0, None, None, None)
        )(y0, coeffs, zg_hi, zg_lo, dt0)

    return jax.jit(batch)


def solve_batch_df32_rk45(
    A0: np.ndarray,
    gamma,
    alpha,
    delta_beta,
    *,
    dz_m: float,
    n_steps: int,
    save_every: int,
    rtol: float,
    atol: float,
    max_steps: int,
    mesh=None,
):
    """Adaptive matched-tolerance batched solve (rotating frame, per-meter
    f64 inputs); output contract matches the rk45 x32/x64 path of
    ``sweep.solve_batch`` (P_max over the decimated save grid, A_end at the
    last saved grid point, lab-frame pump phases restored on the host).
    """
    from .df32_solver import DF32BatchResult

    A0 = np.asarray(A0, dtype=np.complex128)
    if A0.ndim != 2 or A0.shape[1] != 4:
        raise ValueError(f"A0 must have shape (B, 4), got {A0.shape}")
    B = A0.shape[0]
    gamma = np.broadcast_to(np.asarray(gamma, dtype=np.float64), (B,))
    alpha = np.broadcast_to(np.asarray(alpha, dtype=np.float64), (B,))
    dbeta = np.broadcast_to(np.asarray(delta_beta, dtype=np.float64), (B,))

    n_chunks = int(n_steps) // int(save_every)
    remainder = int(n_steps) - n_chunks * int(save_every)
    if n_chunks == 0:
        # saved grid is row 0 only.  Unlike the x32/x64 tiers this tier
        # does NOT integrate an all-trailing span: the early return is what
        # keeps the CPU lane usable (XLA:CPU compiles two-float programs
        # pathologically slowly, CLAUDE.md #4) -- ok still reflects the
        # input finiteness, and n_chunks >= 1 runs get the full trailing
        # contract below.
        P0 = np.abs(A0) ** 2
        return DF32BatchResult(P_max=P0, A_end=A0.copy(),
                               ok=np.isfinite(A0).all(axis=1))
    z_grid = np.arange(n_chunks + 1, dtype=np.float64) * (
        int(save_every) * float(dz_m)
    )
    zg_full = z_grid
    if remainder > 0:
        # trailing partial span: integrated but unsaved (ok/counters only)
        zg_full = np.concatenate([z_grid, [n_steps * float(dz_m)]])
    zg = tf_from_f64(zg_full)

    n_orig = B
    if mesh is not None:
        from ..parallel.mesh import pad_batch

        ndev = int(np.prod(list(mesh.shape.values())))
        A0, n_orig = pad_batch(A0, ndev)
        gamma, _ = pad_batch(gamma, ndev)
        alpha, _ = pad_batch(alpha, ndev)
        dbeta_p, _ = pad_batch(dbeta, ndev)
    else:
        dbeta_p = dbeta

    y0 = ctf_from_c128(A0)
    coeffs = make_df32_coeffs(gamma, alpha, dbeta_p)
    if mesh is not None:
        from ..parallel.mesh import batch_sharding, put_global_tree

        sh = batch_sharding(mesh)
        y0 = put_global_tree(jax.tree_util.tree_map(np.asarray, y0), sh)
        coeffs = put_global_tree(
            jax.tree_util.tree_map(np.asarray, coeffs), sh
        )

    solver = _df32_adaptive_solver(
        float(rtol), float(atol), int(max_steps), n_chunks,
        float(1e-12 * max(zg_full[-1], 1.0)), remainder > 0,
    )
    out = jax.block_until_ready(
        solver(y0, coeffs, zg.hi, zg.lo, np.float32(dz_m))
    )
    if mesh is not None:
        from ..parallel.mesh import fetch_global

        out = tuple(fetch_global(x) for x in out)
    (pmax_hi, pmax_lo, re_hi, re_lo, im_hi, im_lo, ok, _na, _nr) = out

    f64 = np.float64
    P_max = (np.asarray(pmax_hi, f64) + np.asarray(pmax_lo, f64))[:n_orig]
    A_end_rot = (
        np.asarray(re_hi, f64) + np.asarray(re_lo, f64)
        + 1j * (np.asarray(im_hi, f64) + np.asarray(im_lo, f64))
    )[:n_orig]
    # restore lab-frame pump phases at the last saved z (host, f64)
    rot = np.exp(0.5j * dbeta * z_grid[-1])
    A_end = A_end_rot.copy()
    A_end[:, 0] *= rot
    A_end[:, 1] *= rot
    return DF32BatchResult(
        P_max=P_max, A_end=A_end,
        ok=np.asarray(ok, dtype=np.int32)[:n_orig].astype(bool),
    )
