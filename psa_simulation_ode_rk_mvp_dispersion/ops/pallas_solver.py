"""Pallas (Triton) kernel: fused batched RK4 solve of the 4-wave FWM system.

Why a kernel when XLA already runs the scan: a 4-wave instance is 8 real
numbers, so one RK4 step of a 10^4-point sweep is ~10^7 flops -- a few
microseconds of card time -- while XLA runs ``lax.scan`` as a device loop
whose every iteration launches one or more kernels.  This kernel runs the
ENTIRE z-integration of a lane in one launch: each lane's state,
coefficients and running reductions stay in registers for all ``n_steps``;
nothing touches device memory between steps and there is no per-step launch.

Layout: one lane (= one sweep point) per thread.  A 1-D grid walks blocks of
``blk`` lanes (a power of two, 32-128); each wave's real and imaginary parts
are their own ``(blk,)`` vectors.  The batch is padded to a multiple of the
block with edge-replicated lanes (benign) and sliced back on the host.

Physics: the rotating-frame (autonomous) RHS -- the term structure of
``ops/rhs.rhs_yaman_autonomous`` -- so the kernel needs no z argument and no
transcendentals.  The contract is ``ops/integrators.integrate_reduce``'s:
samples at step multiples of ``save_every`` plus the initial state feed the
running max power and the last saved state; NaN lanes freeze at their last
finite state; trailing ``n_steps % save_every`` steps are integrated (they
can clear ``ok``) but not observed.  The kernel follows the precision tier:
float64 at x64, float32 at x32.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

# Streaming multiprocessors of an H100; the block shrinks until the grid has
# at least _WAVES_PER_SM programs per SM (or reaches the smallest block).
_SMS = 132
_WAVES_PER_SM = 2
_BLOCKS = (128, 64, 32)

_N_IN = 11   # [gamma, alpha, dbeta, re(p1,p2,s,i), im(p1,p2,s,i)]
_N_OUT = 13  # [P_max (4), re(y_last) (4), im(y_last) (4), ok]


def lane_block(n_lanes: int) -> int:
    """Lanes per program: the largest block that still gives every SM
    ``_WAVES_PER_SM`` programs, else the smallest block."""
    for blk in _BLOCKS:
        if -(-n_lanes // blk) >= _SMS * _WAVES_PER_SM:
            return blk
    return _BLOCKS[-1]


def _kernel_body(n_steps: int, save_every: int, dz: float):
    """The Pallas kernel closed over the static loop bounds and step."""
    n_chunks = n_steps // save_every
    remainder = n_steps - n_chunks * save_every
    half = 0.5 * dz
    sixth = dz / 6.0

    def kernel(*refs):
        ins, outs = refs[:_N_IN], refs[_N_IN:]
        gamma, alpha, dbeta = (r[...] for r in ins[:3])
        y0 = tuple(r[...] for r in ins[3:])
        neg_half_alpha = -0.5 * alpha
        half_db = 0.5 * dbeta
        two_gamma = 2.0 * gamma

        def rhs(y):
            r1, r2, r3, r4, i1, i2, i3, i4 = y
            P = (r1 * r1 + i1 * i1, r2 * r2 + i2 * i2,
                 r3 * r3 + i3 * i3, r4 * r4 + i4 * i4)
            tot2 = 2.0 * (P[0] + P[1] + P[2] + P[3])
            gF = tuple(gamma * (tot2 - p) for p in P)
            s34_re = r3 * r4 - i3 * i4
            s34_im = r3 * i4 + i3 * r4
            s12_re = r1 * r2 - i1 * i2
            s12_im = r1 * i2 + i1 * r2
            # conj(a) * s for each wave's FWM partner product
            t_re = (r2 * s34_re + i2 * s34_im, r1 * s34_re + i1 * s34_im,
                    r4 * s12_re + i4 * s12_im, r3 * s12_re + i3 * s12_im)
            t_im = (r2 * s34_im - i2 * s34_re, r1 * s34_im - i1 * s34_re,
                    r4 * s12_im - i4 * s12_re, r3 * s12_im - i3 * s12_re)
            re, im = (r1, r2, r3, r4), (i1, i2, i3, i4)
            # loss + Kerr + FWM: (-a/2) A + i g F A + i 2g t
            d_re = [neg_half_alpha * re[j] - gF[j] * im[j] - two_gamma * t_im[j]
                    for j in range(4)]
            d_im = [neg_half_alpha * im[j] + gF[j] * re[j] + two_gamma * t_re[j]
                    for j in range(4)]
            # pump detuning: -i (db/2) A on waves 0, 1
            for j in (0, 1):
                d_re[j] = d_re[j] + half_db * im[j]
                d_im[j] = d_im[j] - half_db * re[j]
            return tuple(d_re) + tuple(d_im)

        def axpy(y, h, k):
            return tuple(a + h * b for a, b in zip(y, k))

        def rk4(y):
            k1 = rhs(y)
            k2 = rhs(axpy(y, half, k1))
            k3 = rhs(axpy(y, half, k2))
            k4 = rhs(axpy(y, dz, k3))
            return tuple(
                a + sixth * (b1 + 2.0 * b2 + 2.0 * b3 + b4)
                for a, b1, b2, b3, b4 in zip(y, k1, k2, k3, k4)
            )

        def powers(y):
            return tuple(y[j] * y[j] + y[j + 4] * y[j + 4] for j in range(4))

        def step(_i, carry):
            y, ok = carry
            y_new = rk4(y)
            fin = jnp.isfinite(y_new[0])
            for v in y_new[1:]:
                fin = fin & jnp.isfinite(v)
            alive = fin & (ok > 0.0)
            ok_new = jnp.where(alive, ok, jnp.zeros_like(ok))
            return tuple(jnp.where(alive, a, b) for a, b in zip(y_new, y)), ok_new

        def chunk(_c, carry):
            y, pmax, ok = carry
            y, ok = lax.fori_loop(0, save_every, step, (y, ok))
            pmax = tuple(jnp.maximum(m, p) for m, p in zip(pmax, powers(y)))
            return y, pmax, ok

        ok0 = jnp.ones_like(gamma)
        y, pmax, ok = lax.fori_loop(0, n_chunks, chunk, (y0, powers(y0), ok0))
        if remainder > 0:
            _y, ok = lax.fori_loop(0, remainder, step, (y, ok))
        for ref, val in zip(outs, pmax + y + (ok,)):
            ref[...] = val

    return kernel


def _make_call(n_steps: int, save_every: int, dz: float, blk: int,
               interpret: bool):
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import triton as pltriton

    kernel = _kernel_body(n_steps, save_every, dz)

    def call(x):
        # x: (11, Bp) inputs -> (13, Bp) outputs, Bp a multiple of blk
        Bp = x.shape[1]
        spec = pl.BlockSpec((blk,), lambda i: (i,))
        out = pl.pallas_call(
            kernel,
            grid=(Bp // blk,),
            in_specs=[spec] * _N_IN,
            out_specs=[spec] * _N_OUT,
            out_shape=[jax.ShapeDtypeStruct((Bp,), x.dtype)] * _N_OUT,
            backend="triton",
            compiler_params=pltriton.CompilerParams(
                num_warps=max(1, blk // 32), num_stages=1),
            interpret=interpret,
            name="fwm4_rk4",
        )(*(x[k] for k in range(_N_IN)))
        return jnp.stack(out, axis=0)

    return call


@functools.lru_cache(maxsize=64)
def _solver(n_steps: int, save_every: int, dz: float, blk: int,
            interpret: bool, mesh=None):
    call = _make_call(n_steps, save_every, dz, blk, interpret)
    if mesh is None:
        return jax.jit(call)
    from jax.sharding import PartitionSpec

    axes = tuple(mesh.axis_names)
    spec = PartitionSpec(None, axes if len(axes) > 1 else axes[0])
    return jax.jit(jax.shard_map(call, mesh=mesh, in_specs=spec,
                                 out_specs=spec, check_vma=False))


@dataclasses.dataclass(frozen=True)
class PallasBatchResult:
    P_max: np.ndarray   # (B, 4) f64
    A_end: np.ndarray   # (B, 4) c128 lab frame (last saved sample)
    ok: np.ndarray      # (B,) bool


def solve_batch_pallas(
    A0: np.ndarray,
    gamma,
    alpha,
    delta_beta,
    *,
    dz_m: float,
    n_steps: int,
    save_every: int,
    dtype=np.float64,
    interpret: bool = False,
    block: int = None,
    mesh=None,
) -> PallasBatchResult:
    """Fused single-launch RK4 solve of B rotating-frame instances.

    ``dtype`` is the working precision (float64 or float32).
    ``interpret=True`` runs the kernel in the Pallas interpreter (CPU
    tests); otherwise it compiles through Triton for the GPU.  ``block``
    overrides :func:`lane_block`; ``mesh`` splits the lanes over its
    devices (``shard_map``, one launch per device, no collectives).
    """
    A0 = np.asarray(A0, dtype=np.complex128)
    if A0.ndim != 2 or A0.shape[1] != 4:
        raise ValueError(f"A0 must have shape (B, 4), got {A0.shape}")
    dtype = np.dtype(dtype)
    if dtype not in (np.dtype(np.float64), np.dtype(np.float32)):
        raise ValueError(f"dtype must be float64 or float32, got {dtype}")
    B = A0.shape[0]
    dbeta = np.broadcast_to(np.asarray(delta_beta, dtype=np.float64), (B,))
    rows = np.concatenate([
        np.stack([np.broadcast_to(np.asarray(c, dtype=np.float64), (B,))
                  for c in (gamma, alpha, dbeta)]),
        A0.real.T, A0.imag.T,
    ]).astype(dtype)                                        # (11, B)

    ndev = 1 if mesh is None else int(np.prod(list(mesh.shape.values())))
    blk = int(block) if block else lane_block(-(-B // ndev))
    mult = blk * ndev
    pad = -B % mult
    if pad:
        rows = np.concatenate([rows, np.repeat(rows[:, -1:], pad, axis=1)], axis=1)

    solver = _solver(int(n_steps), int(save_every), float(dz_m), blk,
                     bool(interpret), mesh)
    if mesh is None:
        out = np.asarray(jax.block_until_ready(solver(jnp.asarray(rows))))
    else:
        from jax.sharding import NamedSharding, PartitionSpec

        from ..parallel.mesh import fetch_global, put_global

        axes = tuple(mesh.axis_names)
        sh = NamedSharding(mesh, PartitionSpec(None, axes if len(axes) > 1 else axes[0]))
        out = fetch_global(jax.block_until_ready(solver(put_global(rows, sh))))
    out = np.asarray(out, np.float64)[:, :B]                # ONE fetch of (13, B)

    # lab-frame pump phases at the last saved z (host, f64)
    z_last = (int(n_steps) // int(save_every)) * int(save_every) * float(dz_m)
    A_end = out[4:8].T + 1j * out[8:12].T
    A_end[:, :2] *= np.exp(0.5j * dbeta * z_last)[:, None]
    return PallasBatchResult(P_max=out[:4].T.copy(), A_end=A_end, ok=out[12] > 0.0)
