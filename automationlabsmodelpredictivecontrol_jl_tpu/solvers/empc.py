"""Economic MPC engine: generic (non-tracking) stage costs.

The reference reserved an ``economic_model_predictive_control`` branch in
its entry point but shipped it dead (main_mpc.jl:54-83 commented out;
``_economic_model_predictive_control_design`` never existed — EMPC was
removed in v0.1.4 per its CHANGELOG). Here the capability is implemented
for real, batched on the device:

  minimize  sum_{k=0..N-1} l(x_k, u_k)  +  Vf(x_N)
  s.t.      x_{k+1} = f(x_k, u_k),  u in U,  [x in X],  [terminal set]

with ``l`` an arbitrary differentiable JAX-traceable stage cost and ``Vf``
an optional terminal cost (default: the quasi-infinite-horizon quadratic
``e_N' P e_N`` with P from the in-house DARE at the reference endpoint —
the standard Amrit/Rawlings/Angeli stabilizing terminal penalty).

Solver: single-shooting SQP in the condensed input space (same shape as
solvers/sqp.py, which covers quadratic tracking costs with a Gauss-Newton
Hessian). A generic economic cost has no Gauss-Newton structure, so each
iteration takes an **exact Newton step on the reduced objective**:

  1. roll the dynamics forward (lax.scan),
  2. g = grad_u J  (reverse mode through the rollout),
  3. H = jacfwd(grad_u J)  — the exact reduced Hessian (n = N*nu is small
     for control problems, so n forward-over-reverse passes are cheap and
     fully fused by XLA),
  4. PSD-project H by eigenvalue clipping (eigh; indefinite economic
     Hessians are expected away from optima),
  5. constraint rows from the trajectory jacobians (jacfwd), solved as a
     box/polytope QP by the batched ADMM engine,
  6. branchless parallel line search on an L1-penalty merit.

Everything is jit/vmap-compatible (fixed iteration bounds, masked
convergence) so fleets of economic controllers batch like tracking ones.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from ..ops import admm as admm_ops
from ..ops.condense import ltv_prediction_matrices
from ..types import (
    STATUS_CONVERGED,
    STATUS_MAX_ITER,
    MpcSolution,
    References,
)
from ..utils.pytrees import pytree_dataclass, static_field

Array = Any
HIGHEST = jax.lax.Precision.HIGHEST


@dataclasses.dataclass(frozen=True)
class EmpcConfig:
    max_sqp_iter: int = 20
    damping: float = 1e-4  # Hessian eigenvalue floor + Levenberg term
    line_search_alphas: Tuple[float, ...] = (1.0, 0.5, 0.25, 0.1, 0.03)
    soft_state_penalty: float = 1e4
    terminal_penalty: float = 1e4
    tol_du: float = 1e-6
    feas_tol: float = 1e-4  # constraint-violation gate on STATUS_CONVERGED
    scaling_iters: int = 2
    admm: admm_ops.AdmmConfig = admm_ops.AdmmConfig(
        max_iter=200, eps_abs=1e-7, eps_rel=1e-7, adaptive=True
    )


@pytree_dataclass
class EmpcEngine:
    """Engine record for the economic path. ``cost_fn(x, u) -> scalar`` is
    the stage cost; ``terminal_cost_fn(x) -> scalar`` the terminal cost
    (None = quadratic DARE penalty from the tuning's terminal ingredient).
    Both are static (they parameterize the traced program)."""

    config: EmpcConfig = static_field()
    cost_fn: Callable = static_field()
    terminal_cost_fn: Optional[Callable] = static_field()
    state_rows: bool = static_field()
    terminal_kind: str = static_field()
    n_terminal_rows: int = static_field()
    m_total: int = static_field()


def build_engine(
    system,
    tuning,
    cost_fn: Callable,
    terminal_cost_fn: Optional[Callable] = None,
    config: Optional[EmpcConfig] = None,
) -> EmpcEngine:
    config = config or EmpcConfig()
    N, nx = tuning.horizon, system.nx
    kind = tuning.terminal.kind
    if kind in ("equality", "contractive"):
        n_term = nx
    elif kind == "neighborhood":
        n_term = int(tuning.terminal.H.shape[0])
    else:
        n_term = 0
    m = N * system.nu + (N * nx if tuning.state_constraint else 0) + n_term
    return EmpcEngine(
        config=config,
        cost_fn=cost_fn,
        terminal_cost_fn=terminal_cost_fn,
        state_rows=bool(tuning.state_constraint),
        terminal_kind=kind,
        n_terminal_rows=n_term,
        m_total=m,
    )


def initial_warm_state(engine: EmpcEngine, tuning) -> Tuple[Array, Array]:
    u0 = tuning.references.u.T.reshape(-1)
    y0 = jnp.zeros((engine.m_total,), jnp.float32)
    return u0, y0


def _dynamics_fn(system, refs: Optional[References] = None):
    """Uniform (f(x, u) -> x_next, per-step affine offsets cs) over neural
    and linear systems.

    A ``LinearDiscreteSystem`` produced by linearization is a *deviation*
    model, valid around the reference trajectory (reference semantics
    linear/...:58-60: dynamics live on e_x). Rolling it out in absolute
    coordinates must therefore restore the affine drift
    ``c_k = x_ref_{k+1} - A x_ref_k - B u_ref_k`` so that the reference
    point is an equilibrium of the prediction model:
    ``x_{k+1} = A x_k + B u_k + c_k``. Neural models are absolute (cs=None).
    """
    if hasattr(system, "apply_fn"):
        return (lambda x, u: system.apply_fn(system.params, x, u)), None
    f = lambda x, u: (
        jnp.matmul(system.A, x, precision=HIGHEST)
        + jnp.matmul(system.B, u, precision=HIGHEST)
    )
    cs = (
        refs.x[:, 1:].T
        - refs.x[:, :-1].T @ system.A.T
        - refs.u.T @ system.B.T
    )  # (N, nx)
    return f, cs


def _rollout(f, x0: Array, us: Array, cs: Optional[Array] = None) -> Array:
    def step(x, inp):
        if cs is None:
            xn = f(x, inp)
        else:
            uk, ck = inp
            xn = f(x, uk) + ck
        return xn, xn

    _, xs = jax.lax.scan(step, x0, us if cs is None else (us, cs))
    return jnp.concatenate([x0[None], xs], axis=0)  # (N+1, nx)


def economic_objective(engine: EmpcEngine, tuning, xs: Array, us: Array) -> Array:
    """J = sum_k l(x_k, u_k) + Vf(x_N). Stage sum runs over k=0..N-1 on the
    *predicted* pairs (x_k, u_k); Vf defaults to the quasi-infinite-horizon
    quadratic e_N' P e_N (P = DARE solution from terminal synthesis)."""
    J = jnp.sum(jax.vmap(engine.cost_fn)(xs[:-1], us))
    if engine.terminal_cost_fn is not None:
        J = J + engine.terminal_cost_fn(xs[-1])
    else:
        e_last = xs[-1] - tuning.references.x[:, -1]
        J = J + e_last @ tuning.terminal.P @ e_last
    return J


def _merit(engine: EmpcEngine, tuning, system, xs: Array, us: Array) -> Array:
    cfg = engine.config
    J = economic_objective(engine, tuning, xs, us)
    if engine.state_rows:
        viol = jnp.sum(
            jax.nn.relu(system.X.lo - xs[1:]) + jax.nn.relu(xs[1:] - system.X.hi)
        )
        J = J + cfg.soft_state_penalty * viol
    ex_last = xs[-1] - tuning.references.x[:, -1]
    if engine.terminal_kind == "equality":
        J = J + cfg.terminal_penalty * jnp.sum(jnp.abs(ex_last))
    elif engine.terminal_kind == "contractive":
        ex0 = xs[0] - tuning.references.x[:, 0]
        J = J + cfg.terminal_penalty * jax.nn.relu(
            jnp.sum(ex_last**2) - 0.9 * jnp.sum(ex0**2)
        )
    elif engine.terminal_kind == "neighborhood":
        J = J + cfg.terminal_penalty * jnp.sum(
            jax.nn.relu(tuning.terminal.H @ ex_last - tuning.terminal.b)
        )
    return J


def _psd_project(H: Array, floor: float) -> Array:
    """Eigenvalue-clipped PSD projection (economic Hessians go indefinite
    away from optima; clipping keeps the Newton step a descent direction)."""
    w, V = jnp.linalg.eigh(H)
    w = jnp.maximum(w, floor)
    return (V * w[None, :]) @ V.T


def solve_economic(
    system,
    tuning,
    engine: EmpcEngine,
    x0: Array,
    u_warm: Array,  # (N*nu,) raw input trajectory
    y_warm: Array,  # (m,) duals
):
    """One full EMPC solve. Returns (MpcSolution, u_final_flat, y_final)."""
    cfg = engine.config
    N = tuning.horizon
    nx, nu = system.nx, system.nu
    n = N * nu
    dt = jnp.float32
    refs: References = tuning.references
    f, cs = _dynamics_fn(system, refs)

    eq_mask = np.zeros((engine.m_total,), bool)
    soft = np.full((engine.m_total,), np.inf)
    off = N * nu
    if engine.state_rows:
        soft[off : off + N * nx] = cfg.soft_state_penalty
        off += N * nx
    if engine.terminal_kind == "equality":
        eq_mask[off : off + nx] = True
    n_ball = nx if engine.terminal_kind == "contractive" else 0
    soft_mu = jnp.asarray(soft, jnp.float32)

    alphas = jnp.asarray(cfg.line_search_alphas, dt)
    u_lo = jnp.tile(system.U.lo.astype(dt), N)
    u_hi = jnp.tile(system.U.hi.astype(dt), N)

    def reduced_objective(u_flat):
        us = u_flat.reshape(N, nu)
        xs = _rollout(f, x0, us, cs)
        return economic_objective(engine, tuning, xs, us)

    grad_fn = jax.grad(reduced_objective)
    hess_fn = jax.jacfwd(grad_fn)

    def jacs(x, u):
        return jax.jacfwd(f, argnums=(0, 1))(x, u)

    def sqp_step(u_flat, y):
        us = u_flat.reshape(N, nu)
        xs = _rollout(f, x0, us, cs)

        # exact reduced Newton model: g + H d, H PSD-projected
        g = grad_fn(u_flat)
        H = hess_fn(u_flat)
        P_qp = _psd_project(0.5 * (H + H.T), cfg.damping) + cfg.damping * jnp.eye(
            n, dtype=dt
        )

        rows_A = [jnp.eye(n, dtype=dt)]
        rows_l = [u_lo - u_flat]
        rows_u = [u_hi - u_flat]
        need_G = engine.state_rows or engine.terminal_kind != "none"
        if need_G:
            As, Bs = jax.vmap(jacs)(xs[:-1], us)
            _, G, _ = ltv_prediction_matrices(As, Bs)
            G_flat = G.transpose(0, 2, 1, 3).reshape(N * nx, N * nu)
        if engine.state_rows:
            xs_tail = xs[1:].reshape(-1)
            rows_A.append(G_flat)
            rows_l.append(jnp.tile(system.X.lo.astype(dt), N) - xs_tail)
            rows_u.append(jnp.tile(system.X.hi.astype(dt), N) - xs_tail)
        ball_c = jnp.zeros((0,), dt)
        ball_r = jnp.asarray(0.0, dt)
        ex_last = xs[-1] - refs.x[:, -1]
        if engine.terminal_kind == "equality":
            rows_A.append(G_flat[-nx:])
            rows_l.append(-ex_last)
            rows_u.append(-ex_last)
        elif engine.terminal_kind == "neighborhood":
            Ht = tuning.terminal.H.astype(dt)
            rows_A.append(jnp.matmul(Ht, G_flat[-nx:], precision=HIGHEST))
            rows_l.append(jnp.full((Ht.shape[0],), -jnp.inf, dt))
            rows_u.append(tuning.terminal.b.astype(dt) - Ht @ ex_last)
        elif engine.terminal_kind == "contractive":
            rows_A.append(G_flat[-nx:])
            rows_l.append(jnp.full((nx,), -jnp.inf, dt))
            rows_u.append(jnp.full((nx,), jnp.inf, dt))
            ball_c = ex_last
            ex0 = x0 - refs.x[:, 0]
            ball_r = jnp.sqrt(0.9) * jnp.linalg.norm(ex0)

        A_qp = jnp.concatenate(rows_A, axis=0)
        l = jnp.concatenate(rows_l, axis=0)
        ub = jnp.concatenate(rows_u, axis=0)

        op = admm_ops.build_operator_traced(
            2.0 * P_qp, A_qp, eq_mask, n_ball, cfg.admm, cfg.scaling_iters
        )
        res = admm_ops.solve(
            op, 2.0 * g, l, ub, ball_c, ball_r, None, y, config=cfg.admm,
            soft_mu=soft_mu,
        )
        du = res.z.reshape(N, nu)

        def cand_merit(a):
            uc = jnp.clip(us + a * du, system.U.lo, system.U.hi)
            xc = _rollout(f, x0, uc, cs)
            return _merit(engine, tuning, system, xc, uc), uc

        merits, ucands = jax.vmap(cand_merit)(alphas)
        merit0 = _merit(engine, tuning, system, xs, us)
        all_merits = jnp.concatenate([merits, merit0[None]])
        all_cands = jnp.concatenate([ucands, us[None]], axis=0)
        u_new = all_cands[jnp.argmin(all_merits)]
        du_norm = jnp.max(jnp.abs(u_new - us))
        return u_new.reshape(-1), res.y, du_norm

    def body(carry):
        u_flat, y, it, done = carry
        u_new, y_new, du_norm = sqp_step(u_flat, y)
        return (u_new, y_new, it + 1, du_norm < cfg.tol_du)

    def cond(carry):
        _, _, it, done = carry
        return (~done) & (it < cfg.max_sqp_iter)

    u_f, y_f, it_f, done_f = jax.lax.while_loop(
        cond,
        body,
        (u_warm.astype(dt), y_warm.astype(dt), jnp.asarray(0, jnp.int32),
         jnp.asarray(False)),
    )

    us = u_f.reshape(N, nu)
    xs = _rollout(f, x0, us, cs)
    ex = xs - refs.x.T
    eu = us - refs.u.T
    # constraint-violation gate: a merit-stalled iterate with unresolved
    # terminal/state violations must NOT report converged with zero
    # residuals (the line search includes the zero step, and tol_du alone
    # cannot see feasibility). The actual violation is surfaced as the
    # primal residual so infeasible stalls are visible to the caller.
    viol = jnp.asarray(0.0, dt)
    if engine.state_rows:
        viol = jnp.maximum(
            viol,
            jnp.max(
                jax.nn.relu(system.X.lo - xs[1:]) + jax.nn.relu(xs[1:] - system.X.hi)
            ),
        )
    ex_last = xs[-1] - refs.x[:, -1]
    if engine.terminal_kind == "equality":
        viol = jnp.maximum(viol, jnp.max(jnp.abs(ex_last)))
    elif engine.terminal_kind == "contractive":
        ex0 = xs[0] - refs.x[:, 0]
        viol = jnp.maximum(
            viol, jax.nn.relu(jnp.sum(ex_last**2) - 0.9 * jnp.sum(ex0**2))
        )
    elif engine.terminal_kind == "neighborhood":
        viol = jnp.maximum(
            viol, jnp.max(jax.nn.relu(tuning.terminal.H @ ex_last - tuning.terminal.b))
        )
    feas = viol <= cfg.feas_tol
    status = jnp.where(done_f & feas, STATUS_CONVERGED, STATUS_MAX_ITER).astype(
        jnp.int32
    )
    sol = MpcSolution(
        x=xs.T,
        e_x=ex.T,
        u=us.T,
        e_u=eu.T,
        status=status,
        iterations=it_f,
        primal_residual=viol,
        dual_residual=jnp.asarray(0.0, dt),
        objective=economic_objective(engine, tuning, xs, us),
    )
    return sol, u_f, y_f
