"""Traced LTV Riccati QP solver: the multiple-shooting SQP subproblem.

The reference's nonlinear transcription is MULTIPLE shooting — per-step
state decision variables with the dynamics as equality constraints
(fnn/mpc_modeler_implementation_fnn.jl:110-143); its roadmap lists "single
shooting" as the missing variant (CHANGELOG.md). This framework started
from single shooting (solvers/sqp.py); this module supplies the sparse KKT
machinery for the multiple-shooting option:

Gauss-Newton subproblem around an iterate (X̄, Ū) that need NOT satisfy the
dynamics (that is the point — on open-loop-unstable plants a single-
shooting rollout explodes and the condensed QP conditioning collapses):

    min  Σ_k 0.5 δx_k' Qb δx_k + lq_k' δx_k + 0.5 δu_k' Rb δu_k + lu_k' δu_k
    s.t. δx_{k+1} = A_k δx_k + B_k δu_k + c_k      (linearized dynamics,
                                                    c_k = f(x̄_k, ū_k) − x̄_{k+1}
                                                    the shooting DEFECTS)
         δx_0 = 0, boxes / terminal set on (x̄ + δx, ū + δu)

solved by consensus ADMM exactly like ops/riccati.py, except everything is
LTV (per-step A_k, B_k, affine defect feed) and TRACED — the factorization
reruns inside the SQP loop each outer iteration, so it is jnp (lax.scan)
rather than a host/f64 precompute. The w-update's equality-constrained QP
is the affine LTV-LQR: one backward gain scan at factorization time, then
per ADMM iteration only an O(N) affine backward/forward sweep — the same
block-tridiagonal KKT exploitation as the LTI engine (SURVEY §7.5), which
batches over scenario lanes as shared-weight GEMMs under vmap.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import jax
import jax.numpy as jnp

from ..utils.pytrees import pytree_dataclass

Array = Any
H = jax.lax.Precision.HIGHEST


def _mm(a, b):
    return jnp.matmul(a, b, precision=H)


@pytree_dataclass
class LtvFactors:
    """Backward LTV Riccati factorization around one SQP iterate.

    With S_N = Qb_term and for k = N-1..0:
        G_k   = (Rb + B_k' S_{k+1} B_k)^{-1}
        K_k   = G_k B_k' S_{k+1} A_k
        AmBK_k = A_k − B_k K_k
        S_k   = Qb + A_k' S_{k+1} AmBK_k
    ``h_k = S_{k+1} c_k`` feeds the defects into the affine sweep."""

    K: Array  # (N, nu, nx)
    G: Array  # (N, nu, nu)
    AmBK: Array  # (N, nx, nx)
    A: Array  # (N, nx, nx)
    B: Array  # (N, nx, nu)
    c: Array  # (N, nx) shooting defects
    h: Array  # (N, nx) = S_{k+1} c_k


def ltv_factorize(
    As: Array,  # (N, nx, nx)
    Bs: Array,  # (N, nx, nu)
    cs: Array,  # (N, nx)
    Qb: Array,  # (nx, nx) interior-node cost (nodes 1..N-1)
    Rb: Array,  # (nu, nu)
    Qb_term: Array,  # (nx, nx) node-N cost
) -> LtvFactors:
    """Traced backward Riccati over per-step (A_k, B_k); O(N) scan of small
    dense inverses (nu x nu)."""
    dt = jnp.float32
    nu = Bs.shape[2]
    eye_u = jnp.eye(nu, dtype=dt)

    def bwd(S, inp):
        A_k, B_k, c_k = inp
        BtS = _mm(B_k.T, S)
        M = Rb + _mm(BtS, B_k)
        G = jnp.linalg.solve(M, eye_u)
        K = _mm(G, _mm(BtS, A_k))
        AmBK = A_k - _mm(B_k, K)
        S_new = Qb + _mm(A_k.T, _mm(S, AmBK))
        S_new = 0.5 * (S_new + S_new.T)
        h_k = _mm(S, c_k)  # S_{k+1} c_k
        return S_new, (K, G, AmBK, h_k)

    _, (K, G, AmBK, h) = jax.lax.scan(
        bwd, Qb_term.astype(dt), (As, Bs, cs), reverse=True
    )
    return LtvFactors(K=K, G=G, AmBK=AmBK, A=As, B=Bs, c=cs, h=h)


def ltv_affine_solve(
    f: LtvFactors,
    lq: Array,  # (N, nx) linear cost on nodes 0..N-1 (row 0 ignored: δx_0=0)
    lq_term: Array,  # (nx,) linear cost on node N
    lu: Array,  # (N, nu)
) -> Tuple[Array, Array]:
    """Affine sweep against the prefactorized gains:
        ff_k = G_k (B_k'(h_k + g_{k+1}) + lu_k)
        g_k  = lq_k + AmBK_k'(g_{k+1} + h_k) − K_k' lu_k
    then δx_{k+1} = AmBK_k δx_k − B_k ff_k + c_k, δu_k = −K_k δx_k − ff_k.
    Returns (δX (N+1, nx) with δx_0 = 0, δU (N, nu))."""

    def bwd(g_next, inp):
        K_k, G_k, AmBK_k, B_k, h_k, lq_k, lu_k = inp
        gh = g_next + h_k
        ff_k = _mm(G_k, _mm(B_k.T, gh) + lu_k)
        g_k = lq_k + _mm(AmBK_k.T, gh) - _mm(K_k.T, lu_k)
        return g_k, ff_k

    _, ffs = jax.lax.scan(
        bwd,
        lq_term.astype(jnp.float32),
        (f.K, f.G, f.AmBK, f.B, f.h, lq, lu),
        reverse=True,
    )

    def fwd(dx, inp):
        K_k, AmBK_k, B_k, c_k, ff_k = inp
        du_k = -_mm(K_k, dx) - ff_k
        dx_next = _mm(AmBK_k, dx) - _mm(B_k, ff_k) + c_k
        return dx_next, (dx_next, du_k)

    dx0 = jnp.zeros((f.A.shape[1],), jnp.float32)
    _, (dxs, dus) = jax.lax.scan(fwd, dx0, (f.K, f.AmBK, f.B, f.c, ffs))
    dX = jnp.concatenate([dx0[None], dxs], axis=0)
    return dX, dus


def solve_ms_qp(
    factors: LtvFactors,
    lq_nodes: Array,  # (N+1, nx) base linear cost per node (row 0 = 0)
    lu0: Array,  # (N, nu) base linear cost on inputs
    u_lo: Array,  # (N, nu) δu bounds (iterate-relative)
    u_hi: Array,
    x_lo: Optional[Array],  # (N-1, nx) interior δx bounds or None
    x_hi: Optional[Array],
    xN_lo: Optional[Array],  # (nx,) terminal δx box or None
    xN_hi: Optional[Array],
    ball_c: Optional[Array],  # (nx,) contractive: ||δx_N + ball_c|| <= ball_r
    ball_r: Array,
    lamX0: Array,  # (N+1, nx) dual warm start
    lamU0: Array,  # (N, nu)
    rho: Array,
    iters: int,
    soft_mu: Optional[float] = None,
    terminal_is_box: bool = False,  # xN rows are the plain state box (not
    # a terminal-equality pin): they follow the soft/hard box choice
    rho_x: Optional[Array] = None,  # state-row consensus rho (defaults to
    # rho). MUST match the rho the caller folded into Qb/QbT.
):
    """Fixed-iteration consensus ADMM on the multiple-shooting subproblem
    (the inner loop of one SQP iteration — masked convergence happens at the
    SQP level, so this runs a fixed budget and reports its final residual).

    Splitting mirrors ops/riccati.py solve_sparse: w = (δX, δU) via the LTV
    affine solve; v = per-block projections; node 0 (δx_0 = 0) never splits.
    ``soft_mu``: user-declared soft state boxes (mpc_soft_state_constraint):
    the state-box projection becomes the prox of the L1 distance penalty
    mu·dist(v, box) — shrink toward the box by mu/rho instead of clipping
    onto it (the same semantics as the linear path's shrinkage prox,
    ops/admm.py soft_mu). Inputs and the contractive ball stay hard.

    ``rho_x``: the state rows carry their OWN consensus rho. The dual on a
    binding state row must climb to the row's shadow price, and it climbs
    by rho_x·(w−v) per iteration — with rho derived from R (≈0.2 at the
    canonical QTP weights) against a 2·Q ≈ 200 cost curvature the climb is
    ~6.7e-4/iter and the inner loop cannot converge within any realistic
    budget (found r5: MS+soft at an out-of-box x0 stalled at a non-optimum,
    J = 507 vs single shooting's 477 on the identical NLP). Scale-matching
    rho_x to the state-cost curvature restores the contraction.
    Returns (δX, δU, lamX, lamU, rp)."""
    N1, nx = lq_nodes.shape
    N = N1 - 1
    nu = lu0.shape[1]
    dt = jnp.float32
    if rho_x is None:
        rho_x = rho
    split_interior = x_lo is not None
    split_terminal = (
        xN_lo is not None or ball_c is not None or split_interior
    )
    ball = ball_c is not None

    lq_int = lq_nodes[1:-1]  # (N-1, nx) nodes 1..N-1... rows 1..N-1
    lq_term = lq_nodes[-1]

    def _box_prox(V, lo, hi):
        if soft_mu is None:
            return jnp.clip(V, lo, hi)
        k = soft_mu / rho_x
        return V - jnp.clip(V - jnp.clip(V, lo, hi), -k, k)

    def project_X(V):
        out = V
        if split_interior:
            out = out.at[1:-1].set(_box_prox(V[1:-1], x_lo, x_hi))
        if ball:
            w = V[-1] + ball_c
            nrm = jnp.linalg.norm(w)
            scale = jnp.where(
                nrm > ball_r, ball_r / jnp.maximum(nrm, 1e-30), 1.0
            )
            out = out.at[-1].set(w * scale - ball_c)
        elif xN_lo is not None:
            # terminal equality rows (xN_lo == xN_hi) stay exact; a plain
            # terminal state box follows the user's soft/hard choice
            if terminal_is_box:
                out = out.at[-1].set(_box_prox(V[-1], xN_lo, xN_hi))
            else:
                out = out.at[-1].set(jnp.clip(V[-1], xN_lo, xN_hi))
        return out

    dX0 = jnp.zeros((N + 1, nx), dt)
    dU0 = jnp.zeros((N, nu), dt)
    vX0 = project_X(dX0)
    vU0 = jnp.clip(dU0, u_lo, u_hi)

    def admm_iter(i, carry):
        dX, dU, vX, vU, lamX, lamU = carry
        # w-update linear terms: base cost + augmented (−rho v + lam)
        lu = lu0 - rho * vU + lamU
        lq = jnp.zeros((N, nx), dt)
        if split_interior:
            lq = lq.at[1:].set(lq_int - rho_x * vX[1:-1] + lamX[1:-1])
        else:
            lq = lq.at[1:].set(lq_int)
        if split_terminal:
            lqT = lq_term - rho_x * vX[-1] + lamX[-1]
        else:
            lqT = lq_term
        dXn, dUn = ltv_affine_solve(factors, lq, lqT, lu)
        vUn = jnp.clip(dUn + lamU / rho, u_lo, u_hi)
        lamUn = lamU + rho * (dUn - vUn)
        if split_terminal:
            vXn = project_X(dXn + lamX / rho_x)
            lamXn = lamX + rho_x * (dXn - vXn)
            vXn = vXn.at[0].set(dXn[0])
            lamXn = lamXn.at[0].set(0.0)
            if not split_interior:
                vXn = vXn.at[1:-1].set(dXn[1:-1])
                lamXn = lamXn.at[1:-1].set(0.0)
        else:
            vXn = dXn
            lamXn = lamX
        return dXn, dUn, vXn, vUn, lamXn, lamUn

    dX, dU, vX, vU, lamX, lamU = jax.lax.fori_loop(
        0, iters, admm_iter, (dX0, dU0, vX0, vU0, lamX0, lamU0)
    )
    rp = jnp.max(jnp.abs(dU - vU))
    if split_terminal:
        rp = jnp.maximum(rp, jnp.max(jnp.abs(dX[-1] - vX[-1])))
    if split_interior:
        rp = jnp.maximum(rp, jnp.max(jnp.abs(dX[1:-1] - vX[1:-1])))
    # return the projected (feasible-in-the-QP) step
    return dX, jnp.clip(dU, u_lo, u_hi), lamX, lamU, rp
