"""Matched-tolerance (df32) LLE solver: two-float driven-damped SSFM.

Extends the framework's ~1e-9-class two-float tier (``ops/df32_gnlse.py`` /
``df32_comb.py`` / ``df32_vgnlse.py``) to the Kerr-cavity family
(``models/lle.py``).  The correctness bar is the f64 reference stepping
semantics (/root/reference/integrators.py:25-61; the reference has no
cavity model, so the oracle is this framework's own x64 CPU LLE).

Structure of the Strang step in two-float arithmetic:

- linear+drive substep (EXACT and affine): the radix-2 two-float FFT
  (``df32_comb.tf_fft``) against a host-precomputed CTF factor
  ``exp((-1 + i (phi_d - Delta)) h)`` -- detuning folded into the factor
  planes -- followed by the host-precomputed two-float drive offset
  ``F (e^{Lam0 h} - 1)/Lam0`` added in the time domain (only the DC bin
  is driven; see models/lle.py).  Both constants split exactly from f64.
- nonlinear substep: the exact unit-gamma Kerr rotation
  ``exp(i h |psi|^2)`` reusing ``df32_gnlse.kerr_rotation_df32`` (all
  two-float range reduction + Taylor sin/cos).

Interior full steps fuse exactly: two half-step affine maps compose into
the host-precomputed full-step (factor, offset) pair, so a k-step chunk
is ``Ah (K Af)^(k-1) K Ah`` like the GNLSE df32 engine.

Same chunked save-decimation / NaN-freeze / ONE-stacked-f32-buffer
contracts; same CPU-eager vs opt-in jitted test split (XLA:CPU compiles
two-float programs pathologically slowly -- CLAUDE.md constraint 4).
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import numpy as np
import jax.numpy as jnp
from jax import lax

from .df32_comb import tf_fft, tf_ifft
from .df32_gnlse import _peak, kerr_rotation_df32
from .twofloat import (
    CTF,
    ctf_add,
    ctf_all_finite,
    ctf_freeze,
    ctf_from_c128,
    ctf_mul,
    tf_from_f64,
    tf_max,
)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class DF32LLECoeffs:
    """Two-float LLE step operators: CTF frequency-domain affine factors
    (half/full step; (1, T) when detuning is shared, (B, T) otherwise),
    the matching time-domain drive offsets ((B, 1) CTF), and the TF Kerr
    angle scale h ((1, 1))."""

    lin_half: CTF
    lin_full: CTF
    drive_half: CTF
    drive_full: CTF
    kerr_h: "object"   # TF (1, 1)


def make_df32_lle_coeffs(detuning, pump, lin_phase, *, dt: float,
                         B: int, T: int) -> DF32LLECoeffs:
    """Build the two-float operators from host f64 normalized-LLE inputs.

    ``detuning`` broadcasts to (B,); ``pump`` (real or complex F)
    broadcasts to (B,); ``lin_phase`` is the dispersion-only phi_d(omega)
    ((T,) or (B, T), fft-ordered).  All constants are computed in f64 on
    the host and split exactly into (hi, lo) f32 pairs."""
    det = np.broadcast_to(np.asarray(detuning, dtype=np.float64), (B,))
    F = np.broadcast_to(np.asarray(pump, dtype=np.complex128), (B,))
    ph = np.asarray(lin_phase, dtype=np.float64)
    ph = ph[None, :] if ph.ndim == 1 else np.broadcast_to(ph, (B, T))
    shared = ph.shape[0] == 1 and np.all(det == det[0])
    if shared:
        lam = -1.0 + 1j * (ph - det[0])            # (1, T)
    else:
        lam = -1.0 + 1j * (np.broadcast_to(ph, (B, T)) - det[:, None])
    lam0 = -(1.0 + 1j * det)                       # (B,)

    def factor(h):
        return ctf_from_c128(np.exp(lam * h))

    def offset(h):
        return ctf_from_c128(
            (F * (np.exp(lam0 * h) - 1.0) / lam0)[:, None])

    return DF32LLECoeffs(
        lin_half=factor(0.5 * dt),
        lin_full=factor(dt),
        drive_half=offset(0.5 * dt),
        drive_full=offset(dt),
        kerr_h=tf_from_f64(np.full((1, 1), float(dt))),
    )


def _affine(y: CTF, L: CTF, dF: CTF) -> CTF:
    """Exact linear+drive step: ifft(L fft(y)) + dF."""
    return ctf_add(tf_ifft(ctf_mul(tf_fft(y), L)), dF)


def lle_steps_df32(y: CTF, co: DF32LLECoeffs, k: int,
                   unroll: bool = False) -> CTF:
    """k fused Strang steps ``Ah (K Af)^(k-1) K Ah`` (the affine half
    steps at the boundary, exact full-step affine maps between Kerr
    rotations -- two half-step affine maps compose exactly into the
    host-precomputed full-step pair).  ``unroll=True`` for the eager CPU
    lane."""
    if k == 0:
        return y

    y = _affine(y, co.lin_half, co.drive_half)

    def body(c, _):
        return _affine(kerr_rotation_df32(c, co.kerr_h),
                       co.lin_full, co.drive_full), None

    if k > 1:
        if unroll:
            for _ in range(k - 1):
                y, _ = body(y, None)
        else:
            y, _ = lax.scan(body, y, None, length=k - 1)
    return _affine(kerr_rotation_df32(y, co.kerr_h),
                   co.lin_half, co.drive_half)


def run_reduce_eager(y0: CTF, co: DF32LLECoeffs, n_steps: int,
                     save_every: int):
    """Eager (op-by-op) reduce-mode solve for the CPU test lane: identical
    chunk/freeze/peak semantics to the jitted solver."""
    n_chunks = n_steps // save_every
    remainder = n_steps - n_chunks * save_every
    ok = ctf_all_finite(y0)
    pk = _peak(y0)
    y = y0
    for _ in range(n_chunks):
        y_new = lle_steps_df32(y, co, save_every, unroll=True)
        ok = ok & ctf_all_finite(y_new)
        y = ctf_freeze(ok, y_new, y)
        pk = tf_max(pk, _peak(y))
    if remainder > 0:
        y_new = lle_steps_df32(y, co, remainder, unroll=True)
        ok = ok & ctf_all_finite(y_new)
    return pk, y, ok


@functools.lru_cache(maxsize=16)
def _df32_lle_solver(n_steps: int, save_every: int):
    """Jitted batched df32 LLE reduce solve: (B, T) CTF state -> ONE
    stacked (B, 4T + 3) f32 buffer [pk_hi | pk_lo | re_hi | re_lo |
    im_hi | im_lo | ok]."""
    n_chunks = n_steps // save_every
    remainder = n_steps - n_chunks * save_every

    def run(y0: CTF, co: DF32LLECoeffs):
        ok0 = ctf_all_finite(y0)

        def chunk(carry, _):
            y, pk, ok = carry
            y_new = lle_steps_df32(y, co, save_every)
            ok_new = ok & ctf_all_finite(y_new)
            y_out = ctf_freeze(ok_new, y_new, y)
            pk = tf_max(pk, _peak(y_out))
            return (y_out, pk, ok_new), None

        carry = (y0, _peak(y0), ok0)
        if n_chunks > 0:
            carry, _ = lax.scan(chunk, carry, None, length=n_chunks)
        y, pk, ok = carry
        if remainder > 0:
            y_new = lle_steps_df32(y, co, remainder)
            ok = ok & ctf_all_finite(y_new)
        return jnp.concatenate(
            [pk.hi[:, None], pk.lo[:, None],
             y.re.hi, y.re.lo, y.im.hi, y.im.lo,
             ok.astype(jnp.float32)[:, None]], axis=1)

    return jax.jit(run)


@functools.lru_cache(maxsize=8)
def _df32_lle_traj_solver(n_steps: int, save_every: int):
    """Jitted trajectory-mode df32 LLE: per-chunk saved states
    ``(ys (S, B, 4T) f32, ok (B,) i32)`` -- rows WITHOUT t=0."""
    n_chunks = n_steps // save_every
    remainder = n_steps - n_chunks * save_every

    def run(y0: CTF, co: DF32LLECoeffs):
        ok0 = ctf_all_finite(y0)

        def chunk(carry, _):
            y, ok = carry
            y_new = lle_steps_df32(y, co, save_every)
            ok_new = ok & ctf_all_finite(y_new)
            y_out = ctf_freeze(ok_new, y_new, y)
            row = jnp.concatenate(
                [y_out.re.hi, y_out.re.lo, y_out.im.hi, y_out.im.lo],
                axis=-1)
            return (y_out, ok_new), row

        if n_chunks > 0:
            (y, ok), ys = lax.scan(chunk, (y0, ok0), None, length=n_chunks)
        else:
            y, ok = y0, ok0
            ys = jnp.zeros((0, y0.re.hi.shape[0], 4 * y0.re.hi.shape[1]),
                           dtype=jnp.float32)
        if remainder > 0:
            y_new = lle_steps_df32(y, co, remainder)
            ok = ok & ctf_all_finite(y_new)
        return ys, ok.astype(jnp.int32)

    return jax.jit(run)


def _check_pow2(T: int) -> None:
    if T & (T - 1):
        raise ValueError(
            f"T={T} must be a power of two for the two-float FFT")


def run_lle_traj_df32(
    psi0: np.ndarray,
    detuning,
    pump,
    lin_phase,
    *,
    dt: float,
    n_steps: int,
    save_every: int,
):
    """Matched-tolerance trajectory solve for ``run_lle_simulation``'s
    df32 tier: ``psi0`` is (B, T) c128; returns host ``(psi_saved
    (S+1, B, T) c128 incl. the t=0 row, ok (B,) bool)``."""
    psi0 = np.asarray(psi0, dtype=np.complex128)
    B, T = psi0.shape
    _check_pow2(T)
    co = make_df32_lle_coeffs(detuning, pump, lin_phase, dt=float(dt),
                              B=B, T=T)
    solver = _df32_lle_traj_solver(int(n_steps), int(save_every))
    ys, ok = jax.block_until_ready(solver(ctf_from_c128(psi0), co))
    ys = np.asarray(ys, dtype=np.float64)
    psi_saved = np.concatenate([
        psi0[None],
        (ys[..., :T] + ys[..., T:2 * T])
        + 1j * (ys[..., 2 * T:3 * T] + ys[..., 3 * T:]),
    ], axis=0)
    return psi_saved, np.asarray(ok).astype(bool)


def solve_lle_batch_df32(
    psi0: np.ndarray,
    detuning,
    pump,
    lin_phase,
    *,
    dt: float,
    n_steps: int,
    save_every: int,
    mesh=None,
):
    """Batched matched-tolerance LLE solve (reduce mode); host f64 inputs.

    Contract mirrors ``models/lle.solve_lle_batch``: returns host
    ``(peak_max (B,) f64, psi_last (B, T) c128, ok (B,) bool)``.  T must
    be a power of two (``tf_fft``).  Pass ``mesh`` to shard the batch axis
    (embarrassingly SPMD, NamedSharding on every two-float leaf)."""
    psi0 = np.asarray(psi0, dtype=np.complex128)
    if psi0.ndim != 2:
        raise ValueError(f"psi0 must have shape (B, T), got {psi0.shape}")
    B, T = psi0.shape
    _check_pow2(T)

    n_orig = B
    det = np.broadcast_to(np.asarray(detuning, dtype=np.float64), (B,))
    F = np.broadcast_to(np.asarray(pump, dtype=np.complex128), (B,))
    ph = np.asarray(lin_phase, dtype=np.float64)
    if mesh is not None:
        from ..parallel.mesh import (
            batch_sharding,
            fetch_global,
            pad_batch,
            put_global_tree,
            replicated_sharding,
        )

        ndev = int(np.prod(list(mesh.shape.values())))
        psi0, n_orig = pad_batch(psi0, ndev)
        det, _ = pad_batch(det, ndev)
        F, _ = pad_batch(F, ndev)
        if ph.ndim == 2:
            ph, _ = pad_batch(np.broadcast_to(ph, (n_orig, T)), ndev)
        B = psi0.shape[0]

    co = make_df32_lle_coeffs(det, F, ph, dt=float(dt), B=B, T=T)
    if mesh is not None:
        sh_b = batch_sharding(mesh)
        sh_r = replicated_sharding(mesh)
        y0 = put_global_tree(
            jax.tree_util.tree_map(np.asarray, ctf_from_c128(psi0)), sh_b)
        co = jax.tree_util.tree_map(
            lambda x: jax.device_put(
                np.asarray(x), sh_b if x.shape[0] == B else sh_r),
            co,
        )
    else:
        y0 = ctf_from_c128(psi0)

    solver = _df32_lle_solver(int(n_steps), int(save_every))
    out = jax.block_until_ready(solver(y0, co))
    if mesh is not None:
        out = fetch_global(out)
    out = np.asarray(out, dtype=np.float64)

    pk = out[:, 0] + out[:, 1]
    re = out[:, 2:2 + T] + out[:, 2 + T:2 + 2 * T]
    im = out[:, 2 + 2 * T:2 + 3 * T] + out[:, 2 + 3 * T:2 + 4 * T]
    ok = out[:, 4 * T + 2] > 0.0
    return (pk[:n_orig], (re + 1j * im)[:n_orig], ok[:n_orig])
