"""Batched OSQP-style ADMM QP solver in JAX.

In-house replacement for the reference's native OSQP back-end (C, reached
via solver_selection.jl:92-98). Same operator-splitting algorithm
(ADMM with relaxation, Ruiz equilibration, per-row penalty), redesigned for
batched accelerator execution:

- The KKT system (P + sigma*I + A' diag(rho) A) is factorized (inverted)
  ONCE at controller-design time — the iteration body is then nothing but
  dense matvecs, so a vmapped batch of solves compiles to batched GEMMs.
- Fixed-shape, branchless inner loop: `lax.while_loop` whose predicate
  vectorizes under vmap into "run until every lane converged" (adaptive
  mode), or a fixed-cost `fori_loop` with diagnostics hoisted out of the
  loop (lean mode, for throughput benchmarking).
- Per-scenario termination status / iteration count / residuals are
  first-class outputs (a vmapped batch cannot throw; the reference never
  even checks termination status, computation_mpc.jl:38-55).
- Supports a trailing Euclidean-ball block in the constraint rows
  (projection instead of interval clipping) — this is how the
  "contractive" terminal ingredient (design_mpc.jl:333-340) is enforced
  without leaving the QP world (the reference needs a QCQP-capable NLP
  solver for it; here the ball projection is one rsqrt).

Solves:  min 0.5 z'Pz + q'z   s.t.  l <= A z <= u  (box rows)
                                    ||(A z)_ball + c_ball|| <= r_ball

Scaling conventions (OSQP §5): P_s = c D P D, q_s = c D q, A_s = E A D,
l_s = E l, u_s = E u; unscale with z = D z_s, y = E y_s / c.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..types import (
    STATUS_CONVERGED,
    STATUS_DUAL_INFEASIBLE,
    STATUS_MAX_ITER,
    STATUS_NUMERIC_ERROR,
    STATUS_PRIMAL_INFEASIBLE,
)
from ..utils.pytrees import pytree_dataclass, static_field

Array = Any
HIGHEST = jax.lax.Precision.HIGHEST


def _mv(M, v):
    return jnp.matmul(M, v, precision=HIGHEST)


@dataclasses.dataclass(frozen=True)
class AdmmConfig:
    """Solver knobs (static: part of the jit cache key)."""

    max_iter: int = 500
    sigma: float = 1e-6
    alpha: float = 1.6
    rho: float = 0.1
    # OSQP uses 1e3 (in f64); in the f32 hot loop a 1e3 equality-row rho
    # amplifies roundoff past the residual tolerance — 1e2 converges.
    rho_eq_scale: float = 1e2
    # adaptive-rho grid: OSQP refactorizes its KKT on every rho update;
    # here K^{-1} is prefactorized for a log-spaced grid once at design
    # time and the iteration *selects* (per vmap lane) the best operator
    # from the residual ratio — no factorization in the hot loop.
    rho_grid: tuple = (0.01, 0.1, 1.0, 10.0, 100.0)
    adapt_interval: int = 25  # 0 disables rho adaptation
    check_interval: int = 25  # iterations between convergence checks
    eps_abs: float = 1e-6
    eps_rel: float = 1e-6
    eps_infeas: float = 1e-5
    refine_steps: int = 1
    scaling_iters: int = 10
    adaptive: bool = True  # while_loop early exit vs fixed-cost fori_loop


@pytree_dataclass
class AdmmOperator:
    """Design-time-precomputed solver operator for one QP structure.

    All rho-dependent pieces are stacked over the rho grid (leading axis R);
    the iteration selects a grid entry per solve / per vmap lane."""

    P_s: Array  # (n, n) scaled
    A_s: Array  # (m, n) scaled
    Ks: Array  # (R, n, n) = P_s + sigma I + A_s' diag(rho_r) A_s
    K_invs: Array  # (R, n, n)
    rho_vecs: Array  # (R, m)
    rho_invs: Array  # (R, m)
    rho_grid: Array  # (R,) base rho values
    D: Array  # (n,)
    E: Array  # (m,)
    c: Array  # ()
    n_ball: int = static_field()
    # A_s is square and DIAGONAL (box-only QP: every constraint row is a
    # scaled decision-variable bound). Detected at build time; the fused
    # chunk kernel (ops/admm_pallas.py) takes exactly these operators and
    # does every A-side product elementwise — the headline h20 config is
    # this shape.
    diag_a: bool = static_field(default=False)


@pytree_dataclass
class AdmmResult:
    z: Array  # (n,) primal solution (unscaled)
    y: Array  # (m,) dual solution (unscaled)
    s: Array  # (m,) constraint-space solution (unscaled)
    status: Array  # int32
    iterations: Array  # int32
    primal_residual: Array
    dual_residual: Array


def _ruiz_equilibrate(P: np.ndarray, A: np.ndarray, n_ball: int, iters: int):
    """Modified Ruiz equilibration (OSQP §5): diagonals D, E and cost scale c
    bringing the scaled KKT matrix to near-unit row/col inf-norms. Ball rows
    get one uniform scale so balls stay balls. Host-side, float64."""
    n = P.shape[0]
    m = A.shape[0]
    D = np.ones(n)
    E = np.ones(m)
    c = 1.0
    Pc = P.copy()
    Ac = A.copy()
    for _ in range(iters):
        col_norm = np.maximum(np.abs(Pc).max(axis=0), np.abs(Ac).max(axis=0))
        row_norm = np.abs(Ac).max(axis=1)
        if n_ball:
            rows = slice(m - n_ball, m)
            gm = np.exp(np.mean(np.log(np.maximum(row_norm[rows], 1e-12))))
            row_norm[rows] = gm
        # zero-norm columns/rows (unconstrained free directions) keep scale 1;
        # clipping them instead compounds a 1e4 factor per sweep -> inf.
        d = np.where(col_norm > 1e-12, 1.0 / np.sqrt(np.clip(col_norm, 1e-8, 1e8)), 1.0)
        e = np.where(row_norm > 1e-12, 1.0 / np.sqrt(np.clip(row_norm, 1e-8, 1e8)), 1.0)
        Pc = (d[:, None] * Pc) * d[None, :]
        Ac = (e[:, None] * Ac) * d[None, :]
        D *= d
        E *= e
        gamma = min(1.0 / max(np.mean(np.abs(Pc).max(axis=0)), 1e-8), 1e8)
        Pc *= gamma
        c *= gamma
    return Pc, Ac, D, E, c


def _rho_grid(config: AdmmConfig):
    """The rho grid for prefactorized adaptation; always contains config.rho
    (first entry = the starting rho's index is found by value)."""
    if not config.adapt_interval:
        return [float(config.rho)]
    vals = sorted(set(float(r) for r in config.rho_grid) | {float(config.rho)})
    return vals


def start_rho_index(config: AdmmConfig) -> int:
    """Grid index of the configured starting rho."""
    return _rho_grid(config).index(float(config.rho))


def build_operator(
    P: Array,
    A: Array,
    eq_row_mask: Array,
    n_ball: int = 0,
    config: AdmmConfig = AdmmConfig(),
) -> AdmmOperator:
    """Precompute the ADMM operator: equilibration + KKT factorization.

    Host-side, float64 internally (runs once per controller design — the
    analogue of the reference's JuMP model build, SURVEY call stack 3.1),
    stored float32 for the device hot loop.
    """
    P64 = np.asarray(P, np.float64)
    A64 = np.asarray(A, np.float64)
    n = P64.shape[0]
    P_s, A_s, D, E, c = _ruiz_equilibrate(P64, A64, n_ball, config.scaling_iters)

    eq = np.asarray(eq_row_mask, bool)
    grid = _rho_grid(config)
    Ks, K_invs, rho_vecs = [], [], []
    for rho in grid:
        # cap per-row rho: beyond ~1e3 the f32 iteration's roundoff exceeds
        # the residual tolerance (equality rows get rho_eq_scale * rho)
        rho_vec = np.minimum(np.where(eq, rho * config.rho_eq_scale, rho), 1e3)
        K = P_s + config.sigma * np.eye(n) + (A_s.T * rho_vec) @ A_s
        Ks.append(K)
        K_invs.append(np.linalg.inv(K))
        rho_vecs.append(rho_vec)
    rho_vecs = np.stack(rho_vecs)

    m = A64.shape[0]
    diag_a = bool(
        n_ball == 0
        and m == n
        and np.count_nonzero(A_s - np.diag(np.diag(A_s))) == 0
    )
    f32 = lambda x: jnp.asarray(x, jnp.float32)
    return AdmmOperator(
        P_s=f32(P_s),
        A_s=f32(A_s),
        Ks=f32(np.stack(Ks)),
        K_invs=f32(np.stack(K_invs)),
        rho_vecs=f32(rho_vecs),
        rho_invs=f32(1.0 / rho_vecs),
        rho_grid=f32(np.asarray(grid)),
        D=f32(D),
        E=f32(E),
        c=jnp.asarray(c, jnp.float32),
        n_ball=n_ball,
        diag_a=diag_a,
    )


def newton_schulz_inverse(K: Array, iters: int = 40) -> Array:
    """Matmul-only inverse of a (well-posed) small square matrix.

    Newton-Schulz iteration X <- X (2I - K X) from the classic
    X0 = K' / (||K||_1 ||K||_inf) seed: quadratically convergent, and —
    unlike jnp.linalg.inv's column-sequential LU — composed purely of
    dense matmuls, which is what a vmapped batch of small factorizations
    needs (the LU path was the SQP design loop's hottest op).

    Iteration count (r4 review correction — measured, f32): with this
    seed the initial residual spectrum reaches 1 - 1/kappa^2, and the
    f32 iteration saturates at a floor ~kappa*eps rather than
    converging fully (40 and 60 iterations measure the same residual:
    3e-4 at kappa=1e3, 1.9e-2 at 1e4, ~1 at 1e5 — the old default of 18
    left 0.32 at kappa=1e3). 40 iterations reach that floor across the
    practical range; callers MUST pair this inverse with at least one
    iterative-refinement step against the exact K (AdmmConfig
    .refine_steps — SqpConfig keeps it at 1), which contracts the
    K-solve error by the NS residual factor per step: measured 3e-9 at
    kappa=1e3, 1.2e-6 at 1e4, 7.7e-4 at 1e5 after one refine. The exact
    residual diagnostics downstream keep statuses honest regardless.
    """
    n = K.shape[-1]
    eye = jnp.eye(n, dtype=K.dtype)
    n1 = jnp.max(jnp.sum(jnp.abs(K), axis=-2))
    ninf = jnp.max(jnp.sum(jnp.abs(K), axis=-1))
    X0 = K.T / jnp.maximum(n1 * ninf, 1e-30)

    def body(_, X):
        KX = jnp.matmul(K, X, precision=HIGHEST)
        return jnp.matmul(X, 2.0 * eye - KX, precision=HIGHEST)

    return jax.lax.fori_loop(0, iters, body, X0)


def build_operator_traced(
    P: Array,
    A: Array,
    eq_row_mask: Array,
    n_ball: int = 0,
    config: AdmmConfig = AdmmConfig(),
    scaling_iters: int = 3,
    identity_A: bool = False,
) -> AdmmOperator:
    """jit/vmap-friendly operator build (traced, float32).

    Used where the QP matrices are themselves traced values — e.g. the LTV
    Gauss-Newton subproblems inside the SQP loop, re-built every outer
    iteration. Runs a few Ruiz sweeps in jnp and factorizes K with the
    matmul-only Newton-Schulz inverse (jnp.linalg.inv lowers to a
    column-sequential LU — slow for a vmapped batch of small matrices).
    eq_row_mask must be a *static* numpy bool array (row structure is
    static even when values are traced).

    ``identity_A=True`` declares A == I statically (the box-only SQP
    subproblem: input boxes on the decision variables, nothing else);
    Ruiz equilibration is skipped — with identity rows it only rescales
    what the rho grid already absorbs — saving several sweeps of
    reductions per SQP iteration.
    """
    dt = jnp.float32
    P_s = jnp.asarray(P, dt)
    A_s = jnp.asarray(A, dt)
    m, n = A_s.shape
    D = jnp.ones((n,), dt)
    E = jnp.ones((m,), dt)
    c = jnp.asarray(1.0, dt)
    if n_ball:
        ball_sel = jnp.zeros((m,), bool).at[m - n_ball :].set(True)
    for _ in range(0 if identity_A else scaling_iters):
        col_norm = jnp.maximum(
            jnp.max(jnp.abs(P_s), axis=0), jnp.max(jnp.abs(A_s), axis=0)
        )
        row_norm = jnp.max(jnp.abs(A_s), axis=1)
        if n_ball:
            gm = jnp.exp(
                jnp.mean(jnp.log(jnp.maximum(row_norm[m - n_ball :], 1e-12)))
            )
            row_norm = jnp.where(ball_sel, gm, row_norm)
        d = jnp.where(
            col_norm > 1e-12, 1.0 / jnp.sqrt(jnp.clip(col_norm, 1e-8, 1e8)), 1.0
        )
        e = jnp.where(
            row_norm > 1e-12, 1.0 / jnp.sqrt(jnp.clip(row_norm, 1e-8, 1e8)), 1.0
        )
        P_s = d[:, None] * P_s * d[None, :]
        A_s = e[:, None] * A_s * d[None, :]
        D = D * d
        E = E * e
        gamma = jnp.clip(
            1.0 / jnp.maximum(jnp.mean(jnp.max(jnp.abs(P_s), axis=0)), 1e-8),
            a_max=1e8,
        )
        P_s = P_s * gamma
        c = c * gamma

    if identity_A:
        # Even without Ruiz sweeps, keep the gamma cost-normalization of P:
        # the traced operator carries a single rho (R=1), so there is no rho
        # grid to absorb P's scale — with large Q weights the rho/P balance
        # would otherwise drift and box-only SQP subproblems stop certifying.
        # One max-reduction over P; D/E stay identity.
        gamma = jnp.clip(
            1.0 / jnp.maximum(jnp.mean(jnp.max(jnp.abs(P_s), axis=0)), 1e-8),
            a_max=1e8,
        )
        P_s = P_s * gamma
        c = c * gamma

    eq = np.asarray(eq_row_mask, bool)
    # traced operators keep a single-rho grid (R=1): SQP rebuilds the
    # subproblem every outer iteration, so rho adaptation buys little there
    rho_vec = jnp.asarray(
        np.minimum(np.where(eq, config.rho * config.rho_eq_scale, config.rho), 1e3),
        dt,
    )
    if identity_A:
        K = P_s + (config.sigma + rho_vec) * jnp.eye(n, dtype=dt)
    else:
        K = P_s + config.sigma * jnp.eye(n, dtype=dt) + (A_s.T * rho_vec) @ A_s
    K_inv = newton_schulz_inverse(K)
    return AdmmOperator(
        P_s=P_s,
        A_s=A_s,
        Ks=K[None],
        K_invs=K_inv[None],
        rho_vecs=rho_vec[None],
        rho_invs=(1.0 / rho_vec)[None],
        rho_grid=jnp.asarray([config.rho], dt),
        D=D,
        E=E,
        c=c,
        n_ball=n_ball,
        diag_a=bool(identity_A) and n_ball == 0,
    )


def _project(
    op: AdmmOperator,
    v: Array,
    l_s: Array,
    u_s: Array,
    ball_c_s,
    ball_r_s,
    soft_shrink_s=None,
):
    """Prox step onto the scaled constraint set: interval clip on box rows
    (or, for soft rows, the prox of a penalized L1 distance — shrinkage
    toward the interval), and Euclidean-ball projection on the trailing
    ball block."""
    clipped = jnp.clip(v, l_s, u_s)
    if soft_shrink_s is None:
        out = clipped
    else:
        # prox of mu*dist_1(s, [l,u]) at v:  above: max(u, v - mu/rho),
        # below: min(l, v + mu/rho); hard rows have shrink = inf -> clip.
        above = jnp.maximum(u_s, v - soft_shrink_s)
        below = jnp.minimum(l_s, v + soft_shrink_s)
        out = jnp.where(v > u_s, above, jnp.where(v < l_s, below, v))
    if op.n_ball:
        nb = op.n_ball
        w = v[-nb:] + ball_c_s
        nrm = jnp.linalg.norm(w)
        scale = jnp.where(nrm > ball_r_s, ball_r_s / jnp.maximum(nrm, 1e-30), 1.0)
        out = out.at[-nb:].set(w * scale - ball_c_s)
    return out


def solve(
    op: AdmmOperator,
    q: Array,
    l: Array,
    u: Array,
    ball_c: Array,
    ball_r: Array,
    z0: Optional[Array] = None,
    y0: Optional[Array] = None,
    config: AdmmConfig = AdmmConfig(),
    soft_mu: Optional[Array] = None,
) -> AdmmResult:
    """Solve one QP instance (vmap over the leading axis of q/l/u/ball_c/
    ball_r/z0/y0 to batch scenarios; `op` broadcasts).

    Warm start: pass z0 (primal) / y0 (dual), unscaled, from the previous
    receding-horizon step — the explicit warm-start carry the reference only
    gets implicitly from OSQP internals (SURVEY §5).
    """
    n = op.P_s.shape[0]
    m = op.A_s.shape[0]
    dt = op.P_s.dtype
    sigma = jnp.asarray(config.sigma, dt)
    alpha = jnp.asarray(config.alpha, dt)

    q_s = op.c * op.D * q
    l_s = op.E * l
    u_s = op.E * u
    if op.n_ball:
        E_ball = op.E[m - op.n_ball]  # uniform across ball rows by construction
        ball_c_s = E_ball * ball_c
        ball_r_s = E_ball * ball_r
    else:
        ball_c_s = jnp.zeros((0,), dt)
        ball_r_s = jnp.asarray(0.0, dt)

    # soft rows: shrink amount in scaled space (inf -> hard projection)
    def shrink_for(rho_vec):
        return None if soft_mu is None else soft_mu / (op.E * rho_vec)

    R = op.rho_grid.shape[0]
    idx0 = jnp.asarray(start_rho_index(config) if R > 1 else 0, jnp.int32)
    log_grid = jnp.log(op.rho_grid)

    def rho_parts(idx):
        if R == 1:
            return op.K_invs[0], op.Ks[0], op.rho_vecs[0], op.rho_invs[0]
        return (
            jnp.take(op.K_invs, idx, axis=0),
            jnp.take(op.Ks, idx, axis=0),
            jnp.take(op.rho_vecs, idx, axis=0),
            jnp.take(op.rho_invs, idx, axis=0),
        )

    x0_s = jnp.zeros((n,), dt) if z0 is None else z0 / op.D
    y0_s = jnp.zeros((m,), dt) if y0 is None else op.c * y0 / op.E
    Ax0 = _mv(op.A_s, x0_s)
    _, _, rho_vec0, rho_inv0 = rho_parts(idx0)
    s0 = _project(op, Ax0 + rho_inv0 * y0_s, l_s, u_s, ball_c_s, ball_r_s,
                  shrink_for(rho_vec0))

    D_inv = 1.0 / op.D
    E_inv = 1.0 / op.E
    c_inv = 1.0 / op.c

    # A_s' diag(rho_r): (R, n, m), tiny — lets the all-rho x-update run as
    # shared-matrix GEMMs instead of per-lane K_inv gathers (a (B,n,n)
    # gather per iteration is pure device-memory traffic; whether that
    # still holds on the GPU is not measured).
    AtRho = op.A_s.T[None] * op.rho_vecs[:, None, :]

    def step(x, s, y, Ax, idx):
        """One ADMM iteration (scaled space) with the grid-selected rho.

        For R > 1 the candidate x-update is computed for EVERY grid rho with
        shared-weight GEMMs (R x (B,n)@(n,n) under vmap), and the lane's rho
        just *selects* a candidate. R times the FLOPs of one update, but no
        gathered per-lane matrices."""
        if R == 1:
            rho_vec, rho_inv = op.rho_vecs[0], op.rho_invs[0]
            rhs = sigma * x - q_s + _mv(op.A_s.T, rho_vec * s - y)
            xt = _mv(op.K_invs[0], rhs)
            for _ in range(config.refine_steps):
                xt = xt + _mv(op.K_invs[0], rhs - _mv(op.Ks[0], xt))
        else:
            Aty = _mv(op.A_s.T, y)
            base = sigma * x - q_s - Aty  # (n,)
            rhs_r = base[None] + jnp.einsum(
                "rnm,m->rn", AtRho, s, precision=HIGHEST
            )  # (R, n)
            xt_r = jnp.einsum(
                "rnk,rk->rn", op.K_invs, rhs_r, precision=HIGHEST
            )
            for _ in range(config.refine_steps):
                Kxt = jnp.einsum("rnk,rk->rn", op.Ks, xt_r, precision=HIGHEST)
                xt_r = xt_r + jnp.einsum(
                    "rnk,rk->rn", op.K_invs, rhs_r - Kxt, precision=HIGHEST
                )
            xt = jnp.take(xt_r, idx, axis=0)
            rho_vec = jnp.take(op.rho_vecs, idx, axis=0)
            rho_inv = jnp.take(op.rho_invs, idx, axis=0)
        st = _mv(op.A_s, xt)
        x_new = alpha * xt + (1.0 - alpha) * x
        v = alpha * st + (1.0 - alpha) * s  # relax with the projected var (OSQP alg. 1)
        s_new = _project(op, v + rho_inv * y, l_s, u_s, ball_c_s, ball_r_s,
                         shrink_for(rho_vec))
        y_new = y + rho_vec * (v - s_new)
        Ax_new = alpha * st + (1.0 - alpha) * Ax  # true A @ x_new, residuals only
        return x_new, s_new, y_new, Ax_new

    def diagnostics(x, s, y, Ax, x_prev, y_prev):
        """Unscaled residuals, convergence + infeasibility certificates.
        Also returns the normalized residual ratio for rho adaptation."""
        r_prim = jnp.max(jnp.abs(E_inv * (Ax - s)))
        Px = _mv(op.P_s, x)
        Aty = _mv(op.A_s.T, y)
        r_dual = c_inv * jnp.max(jnp.abs(D_inv * (Px + q_s + Aty)))

        prim_norm = jnp.maximum(
            jnp.max(jnp.abs(E_inv * Ax)), jnp.max(jnp.abs(E_inv * s))
        )
        dual_norm = c_inv * jnp.maximum(
            jnp.maximum(
                jnp.max(jnp.abs(D_inv * Px)), jnp.max(jnp.abs(D_inv * Aty))
            ),
            jnp.max(jnp.abs(D_inv * q_s)),
        )
        eps_prim = config.eps_abs + config.eps_rel * prim_norm
        eps_dual = config.eps_abs + config.eps_rel * dual_norm
        converged = (r_prim <= eps_prim) & (r_dual <= eps_dual)
        # OSQP §5.2 rho rule: rho <- rho * sqrt(normalized rp / normalized rd)
        ratio = (r_prim / jnp.maximum(prim_norm, 1e-12)) / jnp.maximum(
            r_dual / jnp.maximum(dual_norm, 1e-12), 1e-12
        )

        # primal infeasibility certificate from the dual delta (OSQP §3.4)
        dys = y - y_prev  # scaled
        dy = op.E * dys * c_inv  # unscaled
        dy_norm = jnp.max(jnp.abs(dy))
        Atdy = c_inv * jnp.max(jnp.abs(D_inv * _mv(op.A_s.T, dys)))
        dy_plus = jnp.maximum(dy, 0.0)
        dy_minus = jnp.minimum(dy, 0.0)
        support = jnp.sum(
            jnp.where(dy_plus > 0, jnp.where(jnp.isfinite(u), u * dy_plus, jnp.inf), 0.0)
            + jnp.where(dy_minus < 0, jnp.where(jnp.isfinite(l), l * dy_minus, jnp.inf), 0.0)
        )
        prim_infeas = (
            (dy_norm > 1e-12)
            & (Atdy <= config.eps_infeas * dy_norm)
            & (support <= -config.eps_infeas * dy_norm)
        )

        # dual infeasibility certificate from the primal delta
        dxs = x - x_prev
        dx = op.D * dxs
        dx_norm = jnp.max(jnp.abs(dx))
        Pdx = c_inv * jnp.max(jnp.abs(D_inv * _mv(op.P_s, dxs)))
        qdx = c_inv * jnp.sum(q_s * dxs)
        Adx = E_inv * _mv(op.A_s, dxs)
        dir_ok = jnp.all(
            jnp.where(jnp.isfinite(u), Adx <= config.eps_infeas * dx_norm, True)
            & jnp.where(jnp.isfinite(l), Adx >= -config.eps_infeas * dx_norm, True)
        )
        dual_infeas = (
            (dx_norm > 1e-12)
            & (Pdx <= config.eps_infeas * dx_norm)
            & (qdx <= -config.eps_infeas * dx_norm)
            & dir_ok
        )

        # NaN/inf guard (SURVEY §5 sanitizer row): a poisoned iterate must
        # surface a distinct status, never "converged-or-not with garbage".
        # NaN comparisons are all False, so `converged` can't mask this.
        finite = jnp.isfinite(jnp.sum(x) + jnp.sum(y) + jnp.sum(s))
        status = jnp.where(
            ~finite,
            STATUS_NUMERIC_ERROR,
            jnp.where(
                converged,
                STATUS_CONVERGED,
                jnp.where(
                    prim_infeas,
                    STATUS_PRIMAL_INFEASIBLE,
                    jnp.where(dual_infeas, STATUS_DUAL_INFEASIBLE, STATUS_MAX_ITER),
                ),
            ),
        ).astype(jnp.int32)
        done = converged | prim_infeas | dual_infeas | ~finite
        return r_prim, r_dual, done, status, ratio

    def adapt_rho(idx, ratio, it, done):
        """Select the grid rho nearest rho_cur * sqrt(ratio) (OSQP rule),
        every adapt_interval iterations."""
        if R == 1 or not config.adapt_interval:
            return idx
        log_target = jnp.take(log_grid, idx) + 0.5 * jnp.log(
            jnp.clip(ratio, 1e-8, 1e8)
        )
        idx_new = jnp.argmin(jnp.abs(log_grid - log_target)).astype(jnp.int32)
        # fires on the first check at/after each adapt_interval boundary
        do = (jnp.mod(it, config.adapt_interval) < config.check_interval) & (~done)
        return jnp.where(do, idx_new, idx)

    if config.adaptive:
        # diagnostics (3 extra matvecs + reductions) run every check_interval
        # iterations, not every iteration — the same economy OSQP applies
        ck = max(1, int(config.check_interval))

        def body(state):
            x, s, y, Ax, idx, it, _, _, _, _ = state
            x_prev, y_prev = x, y

            def inner(i, st):
                xi, si, yi, Axi = st
                return step(xi, si, yi, Axi, idx)

            x_new, s_new, y_new, Ax_new = jax.lax.fori_loop(
                0, ck, inner, (x, s, y, Ax)
            )
            r_prim, r_dual, done, status, ratio = diagnostics(
                x_new, s_new, y_new, Ax_new, x_prev, y_prev
            )
            idx_new = adapt_rho(idx, ratio, it + ck, done)
            return (
                x_new, s_new, y_new, Ax_new, idx_new, it + ck,
                r_prim, r_dual, done, status,
            )

        def cond(state):
            it, done = state[5], state[8]
            return (~done) & (it < config.max_iter)

        # tie the scalar carries to a varying operand so the loop carry types
        # match under shard_map manual axes (constants are otherwise
        # "unvarying" while the diagnostics-derived outputs vary)
        zero = jnp.sum(q_s) * 0.0
        izero = zero.astype(jnp.int32)
        init = (
            x0_s,
            s0,
            y0_s,
            Ax0,
            idx0 + izero,
            izero,
            jnp.inf + zero,
            jnp.inf + zero,
            zero > 1.0,
            STATUS_MAX_ITER + izero,
        )
        x_f, s_f, y_f, Ax_f, _, it_f, rp, rd, done, status = jax.lax.while_loop(
            cond, body, init
        )
    else:
        # lean fixed-cost loop: no diagnostics inside, fixed starting rho,
        # one check at the end
        def body(i, state):
            x, s, y, Ax = state
            return step(x, s, y, Ax, idx0)

        x_p, s_p, y_p, Ax_p = jax.lax.fori_loop(
            0, config.max_iter - 1, body, (x0_s, s0, y0_s, Ax0)
        )
        x_f, s_f, y_f, Ax_f = step(x_p, s_p, y_p, Ax_p, idx0)
        rp, rd, done, status, _ = diagnostics(x_f, s_f, y_f, Ax_f, x_p, y_p)
        it_f = jnp.asarray(config.max_iter, jnp.int32)

    return AdmmResult(
        z=op.D * x_f,
        y=op.E * y_f * (1.0 / op.c),
        s=E_inv * s_f,
        status=status,
        iterations=it_f,
        primal_residual=rp,
        dual_residual=rd,
    )
