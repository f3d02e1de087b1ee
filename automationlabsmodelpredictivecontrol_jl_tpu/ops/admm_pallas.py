"""Fused batched ADMM for box-only QPs: one Pallas-Triton kernel per chunk.

The plain engine (ops/admm.py under ``vmap``) spends each ADMM iteration
on about a dozen small XLA ops, and each one streams the lane state
(x, s, y, Ax) through device memory. For a box-only QP — the condensed
input-box MPC, whose constraint matrix is square and diagonal — the only
algorithmically necessary matrix work per iteration is the K-solve. This
kernel runs ``check_interval`` iterations per launch with the lane state
held in registers, so one chunk reads and writes the state once.

Layout (Hopper, through Triton):

- lane-major ``(BLK, n_pad)`` state, ``n`` padded to a power of two; the
  grid runs over independent lane blocks;
- the K-solve is ONE IEEE-fp32 dot per iteration for all R rho-grid
  entries: each lane's right-hand side is masked into its own rho slot of
  a (BLK, R_pad*n_pad) operand and multiplied by the stacked
  [K_0^{-T}; ..; K_{R-1}^{-T}] (R padded to a power of two with zero
  blocks that no lane selects), so the product is already each lane's
  own candidate;
- refinement steps add one dot against the stacked K_r and one against
  the stacked inverses;
- every A-side product is elementwise (A is diagonal), and A x is d * x,
  so x, s and y are the whole loop state.

Padded columns carry zero operator rows/columns, zero bounds and zero
diagonal entries, so they stay exactly zero; padded lanes replicate the
last lane and are sliced off. The between-chunk driver is plain JAX:
exact unscaled residuals, the OSQP rho rule per lane, frozen converged
lanes and the per-lane NaN guard, as in the plain engine.
"""

from __future__ import annotations

import functools
from typing import Any, Optional, Tuple

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from ..types import STATUS_CONVERGED, STATUS_MAX_ITER, STATUS_NUMERIC_ERROR
from ..utils.devices import kernel_route
from .admm import AdmmConfig, AdmmOperator, start_rho_index

Array = Any

_IEEE = jax.lax.Precision.HIGHEST  # Triton lowers HIGHEST f32 dots as IEEE


def _pow2(v: int, floor: int = 1) -> int:
    return max(floor, 1 << max(0, int(v) - 1).bit_length())


def block_config(n_pad: int, R_pad: int) -> Tuple[int, int]:
    """(lanes per program, num_warps) for the chunk kernel.

    Registers bound the block: about ten live (BLK, n_pad) f32 tensors plus
    the (BLK, R_pad*n_pad) spread operand. Measured on an H100 (PERF.md): at
    n_pad=64, R_pad=2 a 64-lane block on 8 warps was the fastest setting
    at 1,024 to 16,384 lanes, 10-20x ahead of the 16- and 32-lane blocks;
    at R_pad=4 with refinement 16 warps ran the 64-lane block fastest."""
    return 64, (8 if R_pad * n_pad <= 128 else 16)


def _chunk_kernel(
    kinv_ref,  # (R_pad*n_pad, n_pad)  [K_0^{-T}; K_1^{-T}; ..]
    kmat_ref,  # (R_pad*n_pad, n_pad)  [K_0^T; ..] (refinement only)
    d_ref,  # (1, n_pad) diag(A_s)
    rhov_ref,  # (R_pad, n_pad)
    rhoi_ref,  # (R_pad, n_pad)
    q_ref,  # (BLK, n_pad) scaled
    l_ref,
    u_ref,
    idx_ref,  # (BLK, 1) int32 rho index per lane
    x_in,
    s_in,
    y_in,
    x_out,
    s_out,
    y_out,
    *,
    R: int,
    R_pad: int,
    chunk: int,
    sigma: float,
    alpha: float,
    refine_steps: int,
):
    q = q_ref[...]
    l = l_ref[...]
    u = u_ref[...]
    d = d_ref[...]  # (1, n_pad)
    idx = idx_ref[...]  # (BLK, 1)
    blk, n_pad = q.shape
    masks = [(idx == r).astype(jnp.float32) for r in range(R)]  # (BLK, 1)
    rho = masks[0] * rhov_ref[0:1, :]
    rho_inv = masks[0] * rhoi_ref[0:1, :]
    for r in range(1, R):
        rho = rho + masks[r] * rhov_ref[r : r + 1, :]
        rho_inv = rho_inv + masks[r] * rhoi_ref[r : r + 1, :]
    # one-hot rho pick per lane, (BLK, R_pad, 1); padded grid slots never match
    onehot = (
        idx[:, :, None] == jax.lax.broadcasted_iota(jnp.int32, (1, R_pad, 1), 1)
    ).astype(jnp.float32)

    def solve_with(stack_ref, v):
        """v @ M_r^T for each lane's own r, as ONE dot: the lane's row is
        spread into its grid slot of a (BLK, R_pad*n_pad) operand (zeros in
        the other slots) against the stacked (R_pad*n_pad, n_pad) matrices."""
        if R_pad > 1:
            v = (onehot * v[:, None, :]).reshape(blk, R_pad * n_pad)
        return jnp.dot(
            v, stack_ref[...], precision=_IEEE,
            preferred_element_type=jnp.float32,
        )

    def body(_, state):
        x, s, y = state
        rhs = sigma * x - q + d * (rho * s - y)
        xt = solve_with(kinv_ref, rhs)
        for _ in range(refine_steps):
            xt = xt + solve_with(kinv_ref, rhs - solve_with(kmat_ref, xt))
        st = d * xt
        x_new = alpha * xt + (1.0 - alpha) * x
        v = alpha * st + (1.0 - alpha) * s
        s_new = jnp.clip(v + rho_inv * y, l, u)
        y_new = y + rho * (v - s_new)
        return x_new, s_new, y_new

    x, s, y = jax.lax.fori_loop(0, chunk, body, (x_in[...], s_in[...], y_in[...]))
    x_out[...] = x
    s_out[...] = s
    y_out[...] = y


def _stacked(mats: Array, n_pad: int, R_pad: int) -> Array:
    """(R, n, n) -> (R_pad*n_pad, n_pad) = [M_0^T; M_1^T; ..] zero-padded."""
    R, n, _ = mats.shape
    out = jnp.zeros((R_pad, n_pad, n_pad), jnp.float32)
    out = out.at[:R, :n, :n].set(jnp.swapaxes(mats, 1, 2))
    return out.reshape(R_pad * n_pad, n_pad)


def _iterate_chunk(
    ops: Tuple[Array, ...],
    q_s: Array,  # (B_pad, n_pad)
    l_s: Array,
    u_s: Array,
    idx: Array,  # (B_pad,)
    x: Array,
    s: Array,
    y: Array,
    *,
    R: int,
    chunk: int,
    config: AdmmConfig,
    block: int,
    num_warps: int,
    interpret: bool,
) -> Tuple[Array, Array, Array]:
    kinv, kmat, d, rhov, rhoi = ops
    B, n_pad = q_s.shape
    R_pad = rhov.shape[0]
    kernel = functools.partial(
        _chunk_kernel,
        R=R,
        R_pad=R_pad,
        chunk=int(chunk),
        sigma=float(config.sigma),
        alpha=float(config.alpha),
        refine_steps=int(config.refine_steps),
    )
    lane = pl.BlockSpec((block, n_pad), lambda i: (i, 0))
    full = lambda a: pl.BlockSpec(a.shape, lambda i: (0, 0))
    state = jax.ShapeDtypeStruct((B, n_pad), jnp.float32)
    return tuple(
        pl.pallas_call(
            kernel,
            grid=(B // block,),
            in_specs=[full(kinv), full(kmat), full(d), full(rhov), full(rhoi)]
            + [lane] * 3
            + [pl.BlockSpec((block, 1), lambda i: (i, 0))]
            + [lane] * 3,
            out_specs=[lane] * 3,
            out_shape=[state] * 3,
            input_output_aliases={9: 0, 10: 1, 11: 2},
            interpret=interpret,
            backend="triton",
            # one pipeline stage: the setting every H100 timing used
            compiler_params=plt.CompilerParams(num_warps=num_warps, num_stages=1),
            name="admm_box_chunk",
        )(kinv, kmat, d, rhov, rhoi, q_s, l_s, u_s, idx[:, None], x, s, y)
    )


def solve_batch_fused(
    op: AdmmOperator,
    q: Array,  # (B, n) unscaled
    l: Array,  # (B, n)
    u: Array,  # (B, n)
    z0: Optional[Array] = None,  # (B, n)
    y0: Optional[Array] = None,  # (B, n)
    config: AdmmConfig = AdmmConfig(),
    interpret: bool = False,
    block: Optional[int] = None,
    num_warps: Optional[int] = None,
):
    """Batched box-only QP solve on the fused chunk kernel; returns the
    same fields as ops.admm.solve (z, y, s, status, iterations, primal /
    dual residuals), each with a leading batch axis.

    Takes only diagonal-A operators without ball rows (``op.diag_a``); any
    other operator raises ``ValueError`` — solve it with the vmapped engine
    (``parallel.solve_batch``). Off the GPU the kernel runs only when the
    caller passes ``interpret=True``. ``block`` / ``num_warps`` override
    :func:`block_config` (the tuning sweep of ``chip_smoke.py
    --time-kernel``)."""
    if op.n_ball or not op.diag_a:
        raise ValueError(
            "the fused ADMM kernel takes only box-only (diagonal-A) QPs "
            "without ball rows; use the vmapped engine (parallel.solve_batch)"
        )
    if not interpret and kernel_route() != "triton":
        raise ValueError(
            f"the fused ADMM kernel compiles only for the GPU (default "
            f"backend: {jax.default_backend()}); use parallel.solve_batch, or "
            "pass interpret=True"
        )
    B, n = q.shape
    dt = jnp.float32
    R = int(op.rho_grid.shape[0])
    n_pad, R_pad = _pow2(n, 16), _pow2(R)
    blk, warps = block_config(n_pad, R_pad)
    blk = block or blk
    warps = num_warps or warps
    B_pad = -(-B // blk) * blk
    ck = max(1, int(config.check_interval))

    def lanes(a, fill=0.0):  # (B, n) -> (B_pad, n_pad): replicate last lane
        a = jnp.concatenate([a, jnp.broadcast_to(a[-1:], (B_pad - B, n))])
        return jnp.pad(a, ((0, 0), (0, n_pad - n)), constant_values=fill)

    def cols(v, fill):  # (n,) -> (n_pad,)
        return jnp.pad(v, (0, n_pad - n), constant_values=fill)

    D, E = cols(op.D, 1.0), cols(op.E, 1.0)
    dvec = cols(jnp.diagonal(op.A_s), 0.0)
    P_s = jnp.pad(op.P_s, ((0, n_pad - n), (0, n_pad - n)))
    rho_vecs = jnp.pad(op.rho_vecs, ((0, R_pad - R), (0, n_pad - n)),
                       constant_values=1.0)
    rho_invs = 1.0 / rho_vecs
    ops = (
        _stacked(op.K_invs, n_pad, R_pad),
        _stacked(op.Ks, n_pad, R_pad),
        dvec[None],
        rho_vecs,
        rho_invs,
    )
    chunk_fn = functools.partial(
        _iterate_chunk, ops, R=R, chunk=ck, config=config, block=blk,
        num_warps=warps, interpret=interpret,
    )

    q_s = op.c * D[None] * lanes(q)
    l_s = E[None] * lanes(l)
    u_s = E[None] * lanes(u)
    x = jnp.zeros_like(q_s) if z0 is None else lanes(z0) / D[None]
    y = jnp.zeros_like(q_s) if y0 is None else op.c * lanes(y0) / E[None]
    idx0 = jnp.full((B_pad,), start_rho_index(config) if R > 1 else 0, jnp.int32)
    s = jnp.clip(dvec * x + rho_invs[idx0] * y, l_s, u_s)

    D_inv, E_inv, c_inv = 1.0 / D, 1.0 / E, 1.0 / op.c
    log_grid = jnp.log(op.rho_grid)
    dual_norm_q = jnp.max(jnp.abs(D_inv * q_s), axis=1)  # loop constant

    def diagnostics(x, s, y):
        ax = dvec * x
        r_prim = jnp.max(jnp.abs(E_inv * (ax - s)), axis=1)
        Px = jnp.matmul(x, P_s, precision=_IEEE)  # P_s symmetric
        Aty = dvec * y
        r_dual = c_inv * jnp.max(jnp.abs(D_inv * (Px + q_s + Aty)), axis=1)
        prim_norm = jnp.maximum(
            jnp.max(jnp.abs(E_inv * ax), axis=1),
            jnp.max(jnp.abs(E_inv * s), axis=1),
        )
        dual_norm = c_inv * jnp.maximum(
            jnp.maximum(
                jnp.max(jnp.abs(D_inv * Px), axis=1),
                jnp.max(jnp.abs(D_inv * Aty), axis=1),
            ),
            dual_norm_q,
        )
        conv = (r_prim <= config.eps_abs + config.eps_rel * prim_norm) & (
            r_dual <= config.eps_abs + config.eps_rel * dual_norm
        )
        ratio = (r_prim / jnp.maximum(prim_norm, 1e-12)) / jnp.maximum(
            r_dual / jnp.maximum(dual_norm, 1e-12), 1e-12
        )
        # per-lane NaN/inf guard: poisoned lanes stop iterating and report a
        # distinct status (NaN comparisons are False so conv can't mask it)
        finite = jnp.isfinite(
            jnp.sum(x, axis=1) + jnp.sum(y, axis=1) + jnp.sum(s, axis=1)
        )
        return r_prim, r_dual, conv, ratio, finite

    def adapt(idx, ratio, done):
        if R == 1 or not config.adapt_interval:
            return idx
        log_target = jnp.take(log_grid, idx) + 0.5 * jnp.log(
            jnp.clip(ratio, 1e-8, 1e8)
        )
        idx_new = jnp.argmin(
            jnp.abs(log_grid[None, :] - log_target[:, None]), axis=1
        ).astype(jnp.int32)
        return jnp.where(done, idx, idx_new)

    def cond(state):
        it, done = state[4], state[7]
        return (~jnp.all(done)) & (it < config.max_iter)

    def body(state):
        x, s, y, idx, it, rp, rd, done, itl, bad = state
        x2, s2, y2 = chunk_fn(q_s, l_s, u_s, idx, x, s, y)
        # frozen lanes keep their converged state (the kernel advances every
        # lane; keeping the first-converged iterate makes iteration counts
        # exact)
        keep = done[:, None]
        x2 = jnp.where(keep, x, x2)
        s2 = jnp.where(keep, s, s2)
        y2 = jnp.where(keep, y, y2)
        rp2, rd2, conv, ratio, finite = diagnostics(x2, s2, y2)
        bad2 = bad | (~finite & ~done)
        done2 = done | conv | ~finite
        itl2 = jnp.where(done, itl, it + ck)
        idx2 = adapt(idx, ratio, done2)
        return (x2, s2, y2, idx2, it + ck, rp2, rd2, done2, itl2, bad2)

    zeros = jnp.zeros((B_pad,), dt)
    state = (
        x, s, y, idx0,
        jnp.asarray(0, jnp.int32),
        zeros + jnp.inf,
        zeros + jnp.inf,
        zeros > 1.0,
        jnp.zeros((B_pad,), jnp.int32),
        zeros > 1.0,
    )
    x, s, y, _, _, rp, rd, done, iters, bad = jax.lax.while_loop(
        cond, body, state
    )
    status = jnp.where(
        bad,
        STATUS_NUMERIC_ERROR,
        jnp.where(done, STATUS_CONVERGED, STATUS_MAX_ITER),
    ).astype(jnp.int32)
    return (
        (D[None] * x)[:B, :n],
        (E[None] * y * c_inv)[:B, :n],
        (E_inv[None] * s)[:B, :n],
        status[:B],
        iters[:B],
        rp[:B],
        rd[:B],
    )
