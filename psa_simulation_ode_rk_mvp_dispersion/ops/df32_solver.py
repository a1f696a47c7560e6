"""Fused double-word-float32 RK4 solver for the 4-wave FWM model.

The float32-only answer to the f64 gap: the full rotating-frame 4-wave RHS
(``ops/rhs.rhs_yaman_autonomous``) and the RK4 stepper re-expressed in
two-float arithmetic (``ops/twofloat``), giving ~1e-12..1e-13 relative
trajectory error vs the f64 reference from float32 arithmetic alone --
far inside the <=1e-9 BASELINE target, at a handful of extra flops per
step.

Design:
- Rotating (autonomous) frame only: no transcendentals in the hot loop, so
  two-float add/mul are the complete op set.  Lab-frame pump phases are
  restored on the host afterwards (powers are frame-invariant).
- State is a :class:`~.twofloat.CTF` pytree of (..., 4) float32 leaves; the
  chunked ``lax.scan`` (save_every decimation + masked NaN freeze) mirrors
  ``ops/integrators.integrate_reduce``.
- Device->host traffic is (hi, lo) float32 pairs, recombined to f64 on the
  host.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import jax
import numpy as np
import jax.numpy as jnp
from jax import lax

from .twofloat import (
    CTF,
    TF,
    ctf_abs2,
    ctf_add,
    ctf_conj,
    ctf_mul,
    ctf_mul_i_real,
    ctf_mul_real,
    ctf_scale_f32,
    tf_add,
    tf_from_f64,
    tf_max,
    tf_mul,
    tf_mul_f32,
    tf_sub,
)


class DF32Coeffs(NamedTuple):
    """Per-instance coefficients, pre-broadcast with a trailing singleton wave
    axis so two-float ops broadcast against (..., 4) states.

    ``detune`` is the per-wave rotating-frame detuning coefficient
    [-db/2, -db/2, 0, 0] (see ``rhs_yaman_autonomous``).
    """

    gamma: TF        # (..., 1)
    two_gamma: TF    # (..., 1)
    neg_half_alpha: TF  # (..., 1)
    detune: TF       # (..., 4)


def make_df32_coeffs(gamma, alpha, delta_beta) -> DF32Coeffs:
    """Host-side constructor from f64 per-instance arrays (shape (...,))."""
    g = np.asarray(gamma, dtype=np.float64)[..., None]
    a = np.asarray(alpha, dtype=np.float64)[..., None]
    db = np.asarray(delta_beta, dtype=np.float64)[..., None]
    det = np.concatenate(
        [-0.5 * db, -0.5 * db, np.zeros_like(db), np.zeros_like(db)], axis=-1
    )
    return DF32Coeffs(
        gamma=tf_from_f64(g),
        two_gamma=tf_from_f64(2.0 * g),
        neg_half_alpha=tf_from_f64(-0.5 * a),
        detune=tf_from_f64(det),
    )


def _ctf_slice(a: CTF, sl) -> CTF:
    return CTF(
        re=TF(a.re.hi[..., sl], a.re.lo[..., sl]),
        im=TF(a.im.hi[..., sl], a.im.lo[..., sl]),
    )


def _ctf_concat(parts) -> CTF:
    return CTF(
        re=TF(
            jnp.concatenate([p.re.hi for p in parts], axis=-1),
            jnp.concatenate([p.re.lo for p in parts], axis=-1),
        ),
        im=TF(
            jnp.concatenate([p.im.hi for p in parts], axis=-1),
            jnp.concatenate([p.im.lo for p in parts], axis=-1),
        ),
    )


def rhs4_df32(y: CTF, c: DF32Coeffs) -> CTF:
    """Rotating-frame 4-wave RHS in two-float arithmetic.

    Identical term structure to ``rhs_yaman_autonomous`` (loss + Kerr + FWM +
    pump detuning), every multiply/add compensated.
    """
    P = ctf_abs2(y)  # TF (..., 4)
    # total power: compensated pairwise sum over the 4 waves
    p0 = TF(P.hi[..., 0:1], P.lo[..., 0:1])
    p1 = TF(P.hi[..., 1:2], P.lo[..., 1:2])
    p2 = TF(P.hi[..., 2:3], P.lo[..., 2:3])
    p3 = TF(P.hi[..., 3:4], P.lo[..., 3:4])
    tot = tf_add(tf_add(p0, p1), tf_add(p2, p3))  # (..., 1)
    F = tf_sub(tf_mul_f32(TF(tot.hi, tot.lo), jnp.float32(2.0)), P)  # (..., 4)

    kerr = ctf_mul_i_real(y, tf_mul(F, c.gamma))
    loss = ctf_mul_real(y, c.neg_half_alpha)
    detune = ctf_mul_i_real(y, c.detune)

    a1 = _ctf_slice(y, slice(0, 1))
    a2 = _ctf_slice(y, slice(1, 2))
    a3 = _ctf_slice(y, slice(2, 3))
    a4 = _ctf_slice(y, slice(3, 4))
    s34 = ctf_mul(a3, a4)
    s12 = ctf_mul(a1, a2)
    t = _ctf_concat([
        ctf_mul(ctf_conj(a2), s34),
        ctf_mul(ctf_conj(a1), s34),
        ctf_mul(ctf_conj(a4), s12),
        ctf_mul(ctf_conj(a3), s12),
    ])
    fwm = ctf_mul_i_real(t, c.two_gamma)

    return ctf_add(ctf_add(loss, kerr), ctf_add(fwm, detune))


class StepConsts(NamedTuple):
    """RK4 step-size constants as two-float scalars."""

    half_dz: TF
    dz: TF
    dz_over_6: TF


def make_step_consts(dz: float) -> StepConsts:
    dz = float(dz)
    return StepConsts(
        half_dz=tf_from_f64(0.5 * dz),
        dz=tf_from_f64(dz),
        dz_over_6=tf_from_f64(dz / 6.0),
    )


def rk4_step_df32(y: CTF, consts: StepConsts, c: DF32Coeffs) -> CTF:
    k1 = rhs4_df32(y, c)
    k2 = rhs4_df32(ctf_add(y, ctf_mul_real(k1, consts.half_dz)), c)
    k3 = rhs4_df32(ctf_add(y, ctf_mul_real(k2, consts.half_dz)), c)
    k4 = rhs4_df32(ctf_add(y, ctf_mul_real(k3, consts.dz)), c)
    incr = ctf_add(
        ctf_add(k1, k4),
        ctf_scale_f32(ctf_add(k2, k3), jnp.float32(2.0)),
    )
    return ctf_add(y, ctf_mul_real(incr, consts.dz_over_6))


class AdamsConsts(NamedTuple):
    """Adams step weights as two-float scalars: ``coef * dz / 24`` split
    exactly from f64 on the host (an in-kernel f32 ``55/24`` would leak a
    2^-25-relative weight error into every step).

    ``b*`` are the AB4 predictor weights (55, -59, 37, -9), ``m*`` the AM4
    corrector weights (9, 19, -5, 1); see ``ops/integrators._ms_chunk``
    (the x64 semantics this mirrors).
    """

    b1: TF
    b2: TF
    b3: TF
    b4: TF
    m0: TF
    m1: TF
    m2: TF
    m3: TF


def make_adams_consts(dz: float) -> AdamsConsts:
    dz = float(dz)
    return AdamsConsts(*(
        tf_from_f64(k * dz / 24.0)
        for k in (55.0, -59.0, 37.0, -9.0, 9.0, 19.0, -5.0, 1.0)
    ))


def ab4_step_df32(y: CTF, f1: CTF, f2: CTF, f3: CTF, adams: AdamsConsts,
                  c: DF32Coeffs, *, correct: bool):
    """One Adams step in two-float arithmetic.

    AB4 (``correct=False``): one RHS evaluation per step (vs RK4's 4);
    ABM4 (``correct=True``): AB4 predictor + AM4 corrector, two evaluations.
    Returns ``(y_new, f0)`` with ``f0 = rhs(y)`` for the history shift.
    """
    f0 = rhs4_df32(y, c)
    incr = ctf_add(
        ctf_add(ctf_mul_real(f0, adams.b1), ctf_mul_real(f1, adams.b2)),
        ctf_add(ctf_mul_real(f2, adams.b3), ctf_mul_real(f3, adams.b4)),
    )
    y_new = ctf_add(y, incr)
    if correct:
        fp = rhs4_df32(y_new, c)
        incr = ctf_add(
            ctf_add(ctf_mul_real(fp, adams.m0), ctf_mul_real(f0, adams.m1)),
            ctf_add(ctf_mul_real(f1, adams.m2), ctf_mul_real(f2, adams.m3)),
        )
        y_new = ctf_add(y, incr)
    return y_new, f0


# ---------------------------------------------------------------------------
# Chunked scan solver with on-device reductions (sweep backend)
# ---------------------------------------------------------------------------

class _Carry(NamedTuple):
    y: CTF
    ok: jax.Array
    pmax: TF          # running max of per-wave powers over saved samples
    y_last: CTF       # last saved state


from .twofloat import ctf_all_finite as _finite  # noqa: E402
from .twofloat import ctf_freeze as _freeze  # noqa: E402


@functools.lru_cache(maxsize=128)
def _df32_solver(n_steps: int, save_every: int, unroll: int):
    """Jitted batched df32 solve: (B,4) hi/lo states -> reductions.

    Outputs are float32/int32 only (fetch-safe): P_max and last-saved state as
    (hi, lo) pairs.
    """
    n_chunks = n_steps // save_every
    remainder = n_steps - n_chunks * save_every

    def run_one(y0: CTF, coeffs: DF32Coeffs, consts: StepConsts):
        P0 = ctf_abs2(y0)
        init = _Carry(y=y0, ok=jnp.asarray(True), pmax=P0, y_last=y0)

        def inner(carry: _Carry, _):
            y_new = rk4_step_df32(carry.y, consts, coeffs)
            # state here is unbatched (4,); vmap lifts the batch axis
            ok_new = carry.ok & _finite(y_new)
            y_out = _freeze(ok_new, y_new, carry.y)
            return _Carry(y_out, ok_new, carry.pmax, carry.y_last), None

        def chunk(carry: _Carry, _):
            carry, _ = lax.scan(inner, carry, None, length=save_every,
                                unroll=min(unroll, save_every))
            # exact two-float compare (tf_gt): a collapsed hi+lo compare has
            # only f32 resolution and can keep the wrong near-tied sample
            pmax = tf_max(ctf_abs2(carry.y), carry.pmax)
            return _Carry(carry.y, carry.ok, pmax, carry.y), None

        carry = init
        if n_chunks > 0:
            carry, _ = lax.scan(chunk, carry, None, length=n_chunks)
        if remainder > 0:
            carry, _ = lax.scan(inner, carry, None, length=remainder)
        return carry

    def batch(y0: CTF, coeffs: DF32Coeffs, consts: StepConsts):
        out = jax.vmap(run_one, in_axes=(0, 0, None))(y0, coeffs, consts)
        return (
            out.pmax.hi, out.pmax.lo,
            out.y_last.re.hi, out.y_last.re.lo,
            out.y_last.im.hi, out.y_last.im.lo,
            out.ok.astype(jnp.int32),
        )

    return jax.jit(batch)


class _MSCarry(NamedTuple):
    y: CTF
    ok: jax.Array
    pmax: TF
    y_last: CTF
    f1: CTF   # rhs at step n-1
    f2: CTF   # rhs at step n-2
    f3: CTF   # rhs at step n-3


@functools.lru_cache(maxsize=128)
def _df32_solver_ms(n_steps: int, save_every: int, unroll: int, correct: bool):
    """Adams (AB4/ABM4) variant of :func:`_df32_solver`: same save-grid /
    NaN-freeze contract, 3 RK4 bootstrap steps then 1 (AB4) or 2 (ABM4) RHS
    evaluations per step.  Mirrors ``ops/integrators._integrate_fixed_grid_ms``
    semantics in two-float arithmetic."""
    n_boot = min(3, n_steps)
    n_chunks = n_steps // save_every

    def run_one(y0: CTF, coeffs: DF32Coeffs, consts):
        step_consts, adams = consts
        pmax = ctf_abs2(y0)
        y, ok, y_last = y0, jnp.asarray(True), y0
        fs = []
        for b in range(n_boot):    # static RK4 bootstrap, recording k1 = f(y)
            f0 = rhs4_df32(y, coeffs)
            k2 = rhs4_df32(
                ctf_add(y, ctf_mul_real(f0, step_consts.half_dz)), coeffs)
            k3 = rhs4_df32(
                ctf_add(y, ctf_mul_real(k2, step_consts.half_dz)), coeffs)
            k4 = rhs4_df32(
                ctf_add(y, ctf_mul_real(k3, step_consts.dz)), coeffs)
            incr = ctf_add(
                ctf_add(f0, k4),
                ctf_scale_f32(ctf_add(k2, k3), jnp.float32(2.0)),
            )
            y_new = ctf_add(y, ctf_mul_real(incr, step_consts.dz_over_6))
            ok_new = ok & _finite(y_new)
            y = _freeze(ok_new, y_new, y)
            ok = ok_new
            fs.append(f0)
            if (b + 1) % save_every == 0:   # static save-boundary check
                pmax = tf_max(ctf_abs2(y), pmax)
                y_last = y

        if n_steps <= n_boot:
            return _Carry(y=y, ok=ok, pmax=pmax, y_last=y_last)

        carry = _MSCarry(y=y, ok=ok, pmax=pmax, y_last=y_last,
                         f1=fs[2], f2=fs[1], f3=fs[0])

        def inner(c: _MSCarry, _):
            y_new, f0 = ab4_step_df32(
                c.y, c.f1, c.f2, c.f3, adams, coeffs, correct=correct)
            ok_new = c.ok & _finite(y_new)
            y_out = _freeze(ok_new, y_new, c.y)
            return _MSCarry(y_out, ok_new, c.pmax, c.y_last,
                            f0, c.f1, c.f2), None

        def save_update(c: _MSCarry) -> _MSCarry:
            return c._replace(pmax=tf_max(ctf_abs2(c.y), c.pmax), y_last=c.y)

        done = n_boot
        boundaries = [k * save_every for k in range(1, n_chunks + 1)
                      if k * save_every > n_boot]
        if boundaries:
            b0 = boundaries[0]
            carry, _ = lax.scan(inner, carry, None, length=b0 - done,
                                unroll=min(unroll, b0 - done))
            carry = save_update(carry)
            n_full = len(boundaries) - 1
            if n_full > 0:
                def chunk(c: _MSCarry, _):
                    c, _ = lax.scan(inner, c, None, length=save_every,
                                    unroll=min(unroll, save_every))
                    return save_update(c), None

                carry, _ = lax.scan(chunk, carry, None, length=n_full)
            done = boundaries[-1]
        rem = n_steps - done
        if rem > 0:
            # trailing partial steps: integrated (can flip ok), unsaved
            carry, _ = lax.scan(inner, carry, None, length=rem,
                                unroll=min(unroll, rem))
        return _Carry(y=carry.y, ok=carry.ok, pmax=carry.pmax,
                      y_last=carry.y_last)

    def batch(y0: CTF, coeffs: DF32Coeffs, consts):
        out = jax.vmap(run_one, in_axes=(0, 0, None))(y0, coeffs, consts)
        return (
            out.pmax.hi, out.pmax.lo,
            out.y_last.re.hi, out.y_last.re.lo,
            out.y_last.im.hi, out.y_last.im.lo,
            out.ok.astype(jnp.int32),
        )

    return jax.jit(batch)


@dataclasses.dataclass(frozen=True)
class DF32BatchResult:
    P_max: np.ndarray   # (B, 4) f64
    A_end: np.ndarray   # (B, 4) c128 (lab frame)
    ok: np.ndarray      # (B,) bool


def solve_batch_df32(
    A0: np.ndarray,
    gamma,
    alpha,
    delta_beta,
    *,
    dz_m: float,
    n_steps: int,
    save_every: int,
    unroll: int = 1,
    mesh=None,
    method: str = "rk4",
) -> DF32BatchResult:
    """Batched rotating-frame df32 solve; inputs in per-meter f64 units.

    Returns f64 per-instance summaries (P_max over saved samples incl. z=0,
    lab-frame last-saved state) -- the df32 backend for ``sweep.solve_batch``.

    ``method``: ``'rk4'`` (reference-parity stepper) or ``'ab4'``/``'abm4'``
    (Adams multistep, 1 / 2 RHS evals per step; same-method x64 parity only
    -- a different stepper is a different trajectory at fixed dz).
    """
    A0 = np.asarray(A0, dtype=np.complex128)
    if A0.ndim != 2 or A0.shape[1] != 4:
        raise ValueError(f"A0 must have shape (B, 4), got {A0.shape}")
    B = A0.shape[0]
    gamma = np.broadcast_to(np.asarray(gamma, dtype=np.float64), (B,))
    alpha = np.broadcast_to(np.asarray(alpha, dtype=np.float64), (B,))
    dbeta = np.broadcast_to(np.asarray(delta_beta, dtype=np.float64), (B,))

    from .twofloat import ctf_from_c128

    n_orig = B
    A0_c, gamma_c, alpha_c, dbeta_c = A0, gamma, alpha, dbeta
    if mesh is not None:
        from ..parallel.mesh import batch_sharding, pad_batch

        ndev = int(np.prod(list(mesh.shape.values())))
        A0_c, n_orig = pad_batch(A0, ndev)
        gamma_c, _ = pad_batch(gamma, ndev)
        alpha_c, _ = pad_batch(alpha, ndev)
        dbeta_c, _ = pad_batch(dbeta, ndev)

    method = method.lower()
    if method not in ("rk4", "ab4", "abm4"):
        raise ValueError(f"method must be 'rk4', 'ab4' or 'abm4', got {method!r}")

    y0 = ctf_from_c128(A0_c)
    coeffs = make_df32_coeffs(gamma_c, alpha_c, dbeta_c)
    consts = make_step_consts(dz_m)
    if method != "rk4":
        consts = (consts, make_adams_consts(dz_m))
    if mesh is not None:
        from ..parallel.mesh import put_global_tree

        sh = batch_sharding(mesh)
        # host-side leaves first: put_global builds non-addressable (multi-
        # process) shardings via make_array_from_callback, which device_put
        # cannot
        y0 = put_global_tree(jax.tree_util.tree_map(np.asarray, y0), sh)
        coeffs = put_global_tree(jax.tree_util.tree_map(np.asarray, coeffs), sh)

    if method == "rk4":
        solver = _df32_solver(int(n_steps), int(save_every), int(unroll))
    else:
        solver = _df32_solver_ms(int(n_steps), int(save_every), int(unroll),
                                 method == "abm4")
    out = jax.block_until_ready(solver(y0, coeffs, consts))
    if mesh is not None:
        from ..parallel.mesh import fetch_global

        out = tuple(fetch_global(x) for x in out)
    (pmax_hi, pmax_lo, re_hi, re_lo, im_hi, im_lo, ok) = out

    P_max = (np.asarray(pmax_hi, np.float64) + np.asarray(pmax_lo, np.float64))[:n_orig]
    A_end_rot = (
        np.asarray(re_hi, np.float64) + np.asarray(re_lo, np.float64)
        + 1j * (np.asarray(im_hi, np.float64) + np.asarray(im_lo, np.float64))
    )[:n_orig]
    ok = np.asarray(ok)[:n_orig]
    # restore lab-frame pump phases at the last saved z (host, f64)
    n_chunks = int(n_steps) // int(save_every)
    z_last = n_chunks * int(save_every) * float(dz_m)
    rot = np.exp(0.5j * dbeta * z_last)
    A_end = A_end_rot.copy()
    A_end[:, 0] *= rot
    A_end[:, 1] *= rot

    return DF32BatchResult(
        P_max=P_max, A_end=A_end, ok=np.asarray(ok).astype(bool)
    )
