"""Discrete Algebraic Riccati Equation solver, jit/vmap-friendly.

In-house replacement for ``ControlSystems.are(Discrete, A, B, Q, R)``
(reference design_mpc.jl:327) used for terminal-cost synthesis.

Algorithm: Structure-Preserving Doubling (SDA). Quadratically convergent,
fixed iteration count, only matmuls + small dense solves — ideal for jit
and for vmapped batched terminal synthesis across many linearization points.

    A_{k+1} = A_k (I + G_k H_k)^{-1} A_k
    G_{k+1} = G_k + A_k (I + G_k H_k)^{-1} G_k A_k^T
    H_{k+1} = H_k + A_k^T H_k (I + G_k H_k)^{-1} A_k

with A_0 = A, G_0 = B R^{-1} B^T, H_0 = Q; then P = lim H_k solves

    P = A^T P A - A^T P B (R + B^T P B)^{-1} B^T P A + Q.
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp

# full-precision matmuls: a reduced-precision f32 matmul (TF32 on the GPU)
# is far too loose for a quadratically-convergent Riccati iteration.
HIGHEST = jax.lax.Precision.HIGHEST


def _mm(a, b):
    return jnp.matmul(a, b, precision=HIGHEST)


@partial(jax.jit, static_argnames=("iters",))
def solve_dare(A, B, Q, R, iters: int = 30):
    """Solve the DARE; returns P (nx, nx), symmetric PSD.

    All math in float32; the doubling iteration is
    self-correcting so float32 reaches ~1e-5 relative residual on
    well-conditioned problems. Symmetrize each iterate for stability.
    """
    dtype = jnp.result_type(A, jnp.float32)
    A = jnp.asarray(A, dtype)
    B = jnp.asarray(B, dtype)
    Q = jnp.asarray(Q, dtype)
    R = jnp.asarray(R, dtype)
    nx = A.shape[-1]
    I = jnp.eye(nx, dtype=dtype)

    G0 = _mm(B, jnp.linalg.solve(R, B.T))
    H0 = Q

    def body(carry, _):
        Ak, Gk, Hk = carry
        # W = (I + G H)^{-1}; solve once, reuse.
        W = jnp.linalg.solve(I + _mm(Gk, Hk), jnp.concatenate([Ak, Gk], axis=1))
        WA = W[:, :nx]
        WG = W[:, nx:]
        A1 = _mm(Ak, WA)
        G1 = Gk + _mm(Ak, _mm(WG, Ak.T))
        H1 = Hk + _mm(Ak.T, _mm(Hk, WA))
        G1 = 0.5 * (G1 + G1.T)
        H1 = 0.5 * (H1 + H1.T)
        return (A1, G1, H1), None

    (_, _, H), _ = jax.lax.scan(body, (A, G0, H0), None, length=iters)
    return 0.5 * (H + H.T)


def dare_residual(A, B, Q, R, P):
    """|| A'PA - P - A'PB (R + B'PB)^{-1} B'PA + Q ||_inf — convergence check."""
    PA = _mm(P, A)
    APA = _mm(A.T, PA)
    APB = _mm(A.T, _mm(P, B))
    K = jnp.linalg.solve(R + _mm(B.T, _mm(P, B)), APB.T)
    res = APA - P - _mm(APB, K) + Q
    return jnp.max(jnp.abs(res))


@jax.jit
def lqr_gain(A, B, R, P) -> jnp.ndarray:
    """Infinite-horizon LQR gain K = (R + B'PB)^{-1} B'PA  (u = -K x)."""
    return jnp.linalg.solve(R + _mm(B.T, _mm(P, B)), _mm(B.T, _mm(P, A)))
