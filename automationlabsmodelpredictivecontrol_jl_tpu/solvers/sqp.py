"""SQP nonlinear-MPC engine: the in-house Ipopt replacement.

The reference transcribes neural dynamics neuron-by-neuron into JuMP
@NLconstraints and hands the NLP to Ipopt (fnn/...:63-189,
solver_selection.jl:100-106). Batched redesign: single-shooting SQP —

  1. roll the learned model forward (lax.scan; dynamics are matmuls),
  2. linearize along the trajectory with jax.jacfwd (the same derivative
     the reference gets from ForwardDiff, SURVEY §3.3),
  3. build the condensed Gauss-Newton LTV-QP in the input deviations
     (exact expansion: the cost is quadratic, dynamics are the only
     nonlinearity) with Levenberg damping,
  4. solve it with the batched ADMM QP engine (traced operator build,
     K factorized once per SQP iteration),
  5. branchless parallel line search: all step lengths evaluated at once
     via vmap on a merit = true cost + L1 penalty on state-box /
     terminal-set violation,

iterated a fixed maximum number of times with masked convergence — so a
vmapped batch of scenarios compiles to one fused program (BASELINE
config 3/4: Fnn and ResNet/ICNN dynamics with soft state constraints).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from ..ops import admm as admm_ops
from ..ops.condense import (
    _blockdiag_weight,
    _difference_operator,
    ltv_prediction_matrices,
)
from ..types import (
    STATUS_CONVERGED,
    STATUS_MAX_ITER,
    MpcSolution,
    References,
    TerminalIngredient,
    Weights,
)
from ..utils.pytrees import pytree_dataclass, static_field

Array = Any
HIGHEST = jax.lax.Precision.HIGHEST


@dataclasses.dataclass(frozen=True)
class SqpConfig:
    # "single": condensed rollout SQP (the reference roadmap's missing
    # variant, CHANGELOG.md); "multiple": per-step state decision variables
    # with dynamics as equality rows — the reference's own transcription
    # (fnn/mpc_modeler_implementation_fnn.jl:110-143), solved on the sparse
    # LTV Riccati KKT machinery (ops/riccati_ltv.py). Multiple shooting is
    # the robust choice for open-loop-unstable / stiff learned dynamics,
    # where a single-shooting rollout explodes.
    shooting: str = "single"
    max_sqp_iter: int = 12
    # Jacobian freezing (single shooting): the first `full_jacobian_iters`
    # outer iterations relinearize + refactorize the Gauss-Newton operator
    # (jacfwd -> LTV condense -> K factorization); later iterations reuse
    # the frozen operator and only rebuild the gradient/rhs from the
    # CURRENT rollout — a quasi-Newton tail. Near the solution du is small,
    # so the stale Jacobian costs extra (cheap) iterations at most, while
    # the line-search merit and the final status gate always measure the
    # TRUE rollout, so honesty is unaffected. 0 disables freezing.
    full_jacobian_iters: int = 3
    damping: float = 1e-4
    line_search_alphas: Tuple[float, ...] = (1.0, 0.5, 0.25, 0.1)
    soft_state_penalty: float = 1e4  # L1 slack penalty on state boxes
    terminal_penalty: float = 1e4  # merit penalty on terminal-set violation
    defect_penalty: float = 1e4  # merit penalty on shooting defects (MS)
    tol_du: float = 1e-5
    feas_tol: float = 1e-4  # constraint-violation gate on STATUS_CONVERGED
    scaling_iters: int = 2
    # multiple-shooting inner subproblem: fixed ADMM budget + consensus rho
    # (None = auto: matched to the input-weight scale like ops/riccati.py)
    ms_admm_iters: int = 120
    ms_rho: Optional[float] = None
    # refine_steps=1 is the Newton-Schulz safety net: the matmul-only
    # NS inverse saturates at an f32 residual floor ~kappa*eps, and one
    # refinement step against the exact K contracts the K-solve error by
    # that factor (measured: kappa=1e4 residual 1.9e-2 -> 1.2e-6). Weak-R
    # subproblems (the SURVEY weak-convexity sweep) push kappa well past
    # 1e3, so the refinement is required for correct x-updates, not a
    # luxury.
    admm: admm_ops.AdmmConfig = admm_ops.AdmmConfig(
        max_iter=150, eps_abs=1e-6, eps_rel=1e-6, adaptive=True,
        refine_steps=1,
    )


@pytree_dataclass
class SqpEngine:
    """Engine record for the nonlinear path. The subproblem operators are
    rebuilt (traced) every SQP iteration, so the engine only carries
    static row-structure metadata."""

    config: SqpConfig = static_field()
    state_rows: bool = static_field()
    terminal_kind: str = static_field()
    n_terminal_rows: int = static_field()
    m_total: int = static_field()
    shooting: str = static_field()
    # True when the USER declared the state boxes soft
    # (mpc_soft_state_constraint=<penalty>, main.py:89-97): box violation
    # is then a priced objective term, not a feasibility failure — the
    # honest-status gate only measures the hard constraints. False keeps
    # the default semantics (soft_state_penalty=1e4 approximates the
    # reference's HARD state boxes; violation blocks STATUS_CONVERGED).
    soft_boxes: bool = static_field(default=False)


def build_engine(
    system, tuning, config: Optional[SqpConfig], soft_state_penalty=None
) -> SqpEngine:
    config = config or SqpConfig()
    if soft_state_penalty is not None:
        # user-declared soft boxes: their L1 price replaces the quasi-hard
        # default in the subproblem rows and the line-search merit
        config = dataclasses.replace(
            config, soft_state_penalty=float(soft_state_penalty)
        )
    if config.shooting not in ("single", "multiple"):
        raise ValueError(
            f"unknown shooting {config.shooting!r}; available: single|multiple"
        )
    N, nx, nu = tuning.horizon, system.nx, system.nu
    kind = tuning.terminal.kind
    if config.shooting == "multiple":
        if kind == "neighborhood":
            raise ValueError(
                "multiple shooting supports terminal kinds "
                "none/equality/contractive (H-rep rows are not "
                "box/ball-representable per state block); use "
                "shooting='single' for neighborhood sets"
            )
        import numpy as _np

        if _np.any(_np.asarray(tuning.weights.S) != 0.0):
            raise ValueError(
                "multiple shooting requires S=0 (the Δu coupling breaks the "
                "block-tridiagonal KKT); use shooting='single'"
            )
    if kind == "equality" or kind == "contractive":
        n_term = nx
    elif kind == "neighborhood":
        n_term = int(tuning.terminal.H.shape[0])
    else:
        n_term = 0
    if config.shooting == "multiple":
        # consensus duals on every state node + every input
        m = (N + 1) * nx + N * nu
    else:
        m = N * nu + (N * nx if tuning.state_constraint else 0) + n_term
    return SqpEngine(
        config=config,
        state_rows=bool(tuning.state_constraint),
        terminal_kind=kind,
        n_terminal_rows=n_term,
        m_total=m,
        shooting=config.shooting,
        soft_boxes=soft_state_penalty is not None,
    )


def initial_warm_state(engine: SqpEngine, tuning) -> Tuple[Array, Array]:
    """Warm start: u trajectory = input reference; duals = 0.

    Multiple shooting also carries the STATE iterate in warm_z (the state
    trajectory is a decision variable there); it initializes at the state
    reference — no rollout, which is exactly what makes the method usable
    on unstable dynamics."""
    u0 = tuning.references.u.T.reshape(-1)  # (N*nu,) raw inputs
    if engine.shooting == "multiple":
        x0 = tuning.references.x.T.reshape(-1)  # ((N+1)*nx,) raw states
        wz = jnp.concatenate([u0, x0]).astype(jnp.float32)
        return wz, jnp.zeros((engine.m_total,), jnp.float32)
    y0 = jnp.zeros((engine.m_total,), jnp.float32)
    return u0, y0


def _row_masks(engine: SqpEngine, N: int, nx: int, nu: int):
    """Static eq-row mask and soft-penalty vector for the subproblem rows."""
    cfg = engine.config
    m = engine.m_total
    eq = np.zeros((m,), bool)
    soft = np.full((m,), np.inf)
    off = N * nu
    if engine.state_rows:
        soft[off : off + N * nx] = cfg.soft_state_penalty
        off += N * nx
    if engine.terminal_kind == "equality":
        eq[off : off + nx] = True
    n_ball = nx if engine.terminal_kind == "contractive" else 0
    return eq, jnp.asarray(soft, jnp.float32), n_ball


def _rollout(system, x0: Array, us: Array) -> Array:
    def step(x, uk):
        xn = system.apply_fn(system.params, x, uk)
        return xn, xn

    _, xs = jax.lax.scan(step, x0, us)
    return jnp.concatenate([x0[None], xs], axis=0)  # (N+1, nx)


def _trajectory_jacobians(system, xs: Array, us: Array):
    f = lambda x, u: system.apply_fn(system.params, x, u)

    def jacs(x, u):
        return jax.jacfwd(f, argnums=(0, 1))(x, u)

    As, Bs = jax.vmap(jacs)(xs[:-1], us)
    return As, Bs  # (N,nx,nx), (N,nx,nu)


def true_objective(tuning, xs: Array, us: Array) -> Array:
    """Reference-parity objective (design_mpc.jl:436-465): stage sum over
    e_x columns 1..N (Julia) == rows 0..N-1 here, P on the last state,
    R on all inputs, S on input differences."""
    w: Weights = tuning.weights
    term: TerminalIngredient = tuning.terminal
    ex = xs - tuning.references.x.T  # (N+1, nx)
    eu = us - tuning.references.u.T  # (N, nu)
    J = jnp.einsum("ki,ij,kj->", ex[:-1], w.Q, ex[:-1], precision=HIGHEST)
    J += ex[-1] @ term.P @ ex[-1]
    J += jnp.einsum("ki,ij,kj->", eu, w.R, eu, precision=HIGHEST)
    du = us[:-1] - us[1:]
    J += jnp.einsum("ki,ij,kj->", du, w.S, du, precision=HIGHEST)
    return J


def _violation(engine: SqpEngine, tuning, system, xs: Array) -> Array:
    """Max HARD-constraint violation of a rolled-out trajectory: state
    boxes (unless the user declared them soft — engine.soft_boxes — in
    which case their violation is a priced objective term, not a
    feasibility failure) + the terminal set (inputs are clipped to their
    box, so always 0). Surfaced as the solution's primal residual — a
    line-search-stalled iterate with violated hard boxes must never report
    "converged, residual 0" (the status blindness this framework exists to
    fix, computation_mpc.jl:38-55)."""
    viol = jnp.asarray(0.0, xs.dtype)
    if engine.state_rows and not engine.soft_boxes:
        viol = jnp.max(
            jax.nn.relu(system.X.lo - xs[1:]) + jax.nn.relu(xs[1:] - system.X.hi)
        )
    ex_last = xs[-1] - tuning.references.x[:, -1]
    if engine.terminal_kind == "equality":
        viol = jnp.maximum(viol, jnp.max(jnp.abs(ex_last)))
    elif engine.terminal_kind == "contractive":
        ex0 = xs[0] - tuning.references.x[:, 0]
        viol = jnp.maximum(
            viol,
            jax.nn.relu(jnp.sum(ex_last**2) - 0.9 * jnp.sum(ex0**2)),
        )
    elif engine.terminal_kind == "neighborhood":
        viol = jnp.maximum(
            viol,
            jnp.max(jax.nn.relu(tuning.terminal.H @ ex_last - tuning.terminal.b)),
        )
    return viol


def _merit(engine: SqpEngine, tuning, system, xs: Array, us: Array) -> Array:
    """Line-search merit: true objective + L1 penalties on state-box and
    terminal-set violation (keeps the search honest about feasibility)."""
    cfg = engine.config
    J = true_objective(tuning, xs, us)
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


def solve_nonlinear(
    system,
    tuning,
    engine: SqpEngine,
    x0: Array,
    u_warm: Array,  # (N*nu,) raw input trajectory warm start
    y_warm: Array,  # (m,) dual warm start
):
    """One full SQP solve. Returns (MpcSolution, u_final_flat, y_final)."""
    cfg = engine.config
    N = tuning.horizon
    nx, nu = system.nx, system.nu
    n = N * nu
    dt = jnp.float32

    w = tuning.weights
    refs: References = tuning.references
    xref_tail = refs.x.T[1:]  # (N, nx) steps 2..N+1
    uref_stack = refs.u.T.reshape(-1)

    Rbar = jnp.kron(jnp.eye(N, dtype=dt), w.R.astype(dt))
    Dop = _difference_operator(N, nu, dt)
    Sbar = jnp.kron(jnp.eye(N - 1, dtype=dt), w.S.astype(dt))
    DSD = Dop.T @ Sbar @ Dop
    Qbar = _blockdiag_weight(w.Q.astype(dt), tuning.terminal.P.astype(dt), N)

    eq_mask, soft_mu, n_ball = _row_masks(engine, N, nx, nu)
    alphas = jnp.asarray(cfg.line_search_alphas, dt)

    u_lo = jnp.tile(system.U.lo.astype(dt), N)
    u_hi = jnp.tile(system.U.hi.astype(dt), N)

    # box-only subproblem (input boxes on z, no state/terminal rows):
    # A is statically the identity — skip Ruiz in the operator build
    ident = (not engine.state_rows) and engine.terminal_kind == "none"

    def build_parts(u_flat, xs):
        """Relinearize + refactorize the Gauss-Newton operator at the
        current iterate — the expensive phase (jacfwd, LTV condense, K
        factorization); frozen after cfg.full_jacobian_iters."""
        us = u_flat.reshape(N, nu)
        As, Bs = _trajectory_jacobians(system, xs, us)
        F, G, _ = ltv_prediction_matrices(As, Bs)
        G_flat = G.transpose(0, 2, 1, 3).reshape(N * nx, N * nu)
        GtQ = jnp.matmul(G_flat.T, Qbar, precision=HIGHEST)
        P_qp = 2.0 * (
            jnp.matmul(GtQ, G_flat, precision=HIGHEST) + Rbar + DSD
        ) + 2.0 * cfg.damping * jnp.eye(n, dtype=dt)

        rows_A = [jnp.eye(n, dtype=dt)]
        if engine.state_rows:
            rows_A.append(G_flat)
        if engine.terminal_kind == "equality":
            rows_A.append(G_flat[-nx:])
        elif engine.terminal_kind == "neighborhood":
            H = tuning.terminal.H.astype(dt)
            rows_A.append(jnp.matmul(H, G_flat[-nx:], precision=HIGHEST))
        elif engine.terminal_kind == "contractive":
            rows_A.append(G_flat[-nx:])
        A_qp = jnp.concatenate(rows_A, axis=0)
        op = admm_ops.build_operator_traced(
            P_qp, A_qp, eq_mask, n_ball, cfg.admm, cfg.scaling_iters,
            identity_A=ident,
        )
        return op, G_flat, GtQ

    def solve_sub(parts, u_flat, xs, y):
        """One SQP iteration on a given (possibly frozen) operator: rebuild
        the gradient/rhs from the CURRENT rollout, solve the QP, line
        search on the true merit."""
        op, G_flat, GtQ = parts
        us = u_flat.reshape(N, nu)
        ebar = (xs[1:] - xref_tail).reshape(-1)  # (N*nx,)
        eu_bar = u_flat - uref_stack
        q = 2.0 * (GtQ @ ebar + Rbar @ eu_bar + Dop.T @ (Sbar @ (Dop @ u_flat)))

        rows_l = [u_lo - u_flat]
        rows_u = [u_hi - u_flat]
        if engine.state_rows:
            xs_tail = xs[1:].reshape(-1)
            rows_l.append(jnp.tile(system.X.lo.astype(dt), N) - xs_tail)
            rows_u.append(jnp.tile(system.X.hi.astype(dt), N) - xs_tail)
        ball_c = jnp.zeros((0,), dt)
        ball_r = jnp.asarray(0.0, dt)
        ex_last = ebar[-nx:]
        if engine.terminal_kind == "equality":
            rows_l.append(-ex_last)
            rows_u.append(-ex_last)
        elif engine.terminal_kind == "neighborhood":
            H = tuning.terminal.H.astype(dt)
            rows_l.append(jnp.full((H.shape[0],), -jnp.inf, dt))
            rows_u.append(tuning.terminal.b.astype(dt) - H @ ex_last)
        elif engine.terminal_kind == "contractive":
            rows_l.append(jnp.full((nx,), -jnp.inf, dt))
            rows_u.append(jnp.full((nx,), jnp.inf, dt))
            ball_c = ex_last
            ex0 = x0 - refs.x[:, 0]
            ball_r = jnp.sqrt(0.9) * jnp.linalg.norm(ex0)

        l = jnp.concatenate(rows_l, axis=0)
        ub = jnp.concatenate(rows_u, axis=0)
        res = admm_ops.solve(
            op, q, l, ub, ball_c, ball_r, None, y, config=cfg.admm, soft_mu=soft_mu
        )
        du = res.z.reshape(N, nu)

        # branchless parallel line search (alpha = 0 candidate included);
        # each candidate's rollout is kept so the winner's trajectory is
        # carried to the next iteration instead of being re-rolled
        def cand_merit(a):
            uc = jnp.clip(us + a * du, system.U.lo, system.U.hi)
            xc = _rollout(system, x0, uc)
            return _merit(engine, tuning, system, xc, uc), uc, xc

        merits, ucands, xcands = jax.vmap(cand_merit)(alphas)
        merit0 = _merit(engine, tuning, system, xs, us)
        all_merits = jnp.concatenate([merits, merit0[None]])
        all_cands = jnp.concatenate([ucands, us[None]], axis=0)
        all_xs = jnp.concatenate([xcands, xs[None]], axis=0)
        best = jnp.argmin(all_merits)
        u_new = all_cands[best]
        du_norm = jnp.max(jnp.abs(u_new - us))
        return u_new.reshape(-1), all_xs[best], res.y, du_norm, res.status

    u_warm = u_warm.astype(dt)
    y_warm = y_warm.astype(dt)
    xs0 = _rollout(system, x0, u_warm.reshape(N, nu))

    u_f, xs, y_f = u_warm, xs0, y_warm
    it_f = jnp.asarray(0, jnp.int32)
    done_f = jnp.asarray(False)
    admm_status = jnp.asarray(STATUS_MAX_ITER, jnp.int32)

    if int(cfg.full_jacobian_iters) <= 0:
        # freezing disabled: the plain while_loop with a full relinearize
        # + refactorize every iteration (one compiled body, early exit —
        # NOT a static unroll of max_sqp_iter full iterations, which
        # would multiply trace size and lose early exit; r4 review)
        def body0(carry):
            u_flat, xs_c, y, it, done, status = carry
            u_new, xs_new, y_new, du_norm, st = solve_sub(
                build_parts(u_flat, xs_c), u_flat, xs_c, y
            )
            return (u_new, xs_new, y_new, it + 1, du_norm < cfg.tol_du, st)

        def cond0(carry):
            _, _, _, it, done, _ = carry
            return (~done) & (it < cfg.max_sqp_iter)

        u_f, xs, y_f, it_f, done_f, admm_status = jax.lax.while_loop(
            cond0, body0, (u_f, xs, y_f, it_f, done_f, admm_status)
        )
        parts = None
        k_full = int(cfg.max_sqp_iter)
    else:
        # Phase 1 — statically unrolled FULL iterations (relinearize +
        # refactorize each time), masked per lane so iteration counts and
        # early-exit semantics match the plain while_loop exactly.
        k_full = min(int(cfg.full_jacobian_iters), int(cfg.max_sqp_iter))
        parts = None
        for _ in range(k_full):
            parts = build_parts(u_f, xs)
            u2, xs2, y2, du_norm, st = solve_sub(parts, u_f, xs, y_f)
            keep = done_f
            u_f = jnp.where(keep, u_f, u2)
            xs = jnp.where(keep, xs, xs2)
            y_f = jnp.where(keep, y_f, y2)
            admm_status = jnp.where(keep, admm_status, st)
            it_f = it_f + (~keep).astype(jnp.int32)
            done_f = done_f | (du_norm < cfg.tol_du)

    # Phase 2 — quasi-Newton tail on the FROZEN operator (rhs + line
    # search only); loop-invariant `parts` rides into the while_loop.
    if k_full < cfg.max_sqp_iter:
        assert parts is not None

        def body(carry):
            u_flat, xs_c, y, it, done, status = carry
            u_new, xs_new, y_new, du_norm, st = solve_sub(
                parts, u_flat, xs_c, y
            )
            done_new = du_norm < cfg.tol_du
            return (u_new, xs_new, y_new, it + 1, done_new, st)

        def cond(carry):
            _, _, _, it, done, _ = carry
            return (~done) & (it < cfg.max_sqp_iter)

        u_f, xs, y_f, it_f, done_f, admm_status = jax.lax.while_loop(
            cond, body, (u_f, xs, y_f, it_f, done_f, admm_status)
        )

    us = u_f.reshape(N, nu)
    ex = xs - refs.x.T
    eu = us - refs.u.T
    # honest status: tol_du alone cannot see feasibility (the line search
    # includes the zero step) — gate convergence on the MEASURED violation
    # and report it as the primal residual (mirrors EmpcConfig.feas_tol)
    viol = _violation(engine, tuning, system, xs)
    status = jnp.where(
        done_f & (viol <= cfg.feas_tol), STATUS_CONVERGED, STATUS_MAX_ITER
    ).astype(jnp.int32)
    sol = MpcSolution(
        x=xs.T,
        e_x=ex.T,
        u=us.T,
        e_u=eu.T,
        status=status,
        iterations=it_f,
        primal_residual=viol.astype(dt),
        dual_residual=jnp.asarray(0.0, dt),
        objective=true_objective(tuning, xs, us),
    )
    return sol, u_f, y_f


def shift_warm(u_flat: Array, N: int, nu: int) -> Array:
    """Receding-horizon warm-start shift: drop step 0, repeat the last."""
    us = u_flat.reshape(N, nu)
    return jnp.concatenate([us[1:], us[-1:]], axis=0).reshape(-1)


def _defects(system, Xb: Array, Ub: Array) -> Array:
    """Multiple-shooting defects c_k = f(x̄_k, ū_k) − x̄_{k+1} (N, nx)."""
    fvals = jax.vmap(lambda x, u: system.apply_fn(system.params, x, u))(
        Xb[:-1], Ub
    )
    return fvals - Xb[1:]


def _merit_ms(engine: SqpEngine, tuning, system, Xb: Array, Ub: Array) -> Array:
    """Multiple-shooting line-search merit: true objective + L1 penalties on
    the shooting defects and on state-box / terminal violations. Unlike the
    single-shooting merit, states here are decision variables — feasibility
    of the dynamics is part of the merit, not implicit in a rollout."""
    cfg = engine.config
    J = true_objective(tuning, Xb, Ub)
    J = J + cfg.defect_penalty * jnp.sum(jnp.abs(_defects(system, Xb, Ub)))
    if engine.state_rows:
        J = J + cfg.soft_state_penalty * jnp.sum(
            jax.nn.relu(system.X.lo - Xb[1:]) + jax.nn.relu(Xb[1:] - system.X.hi)
        )
    ex_last = Xb[-1] - tuning.references.x[:, -1]
    if engine.terminal_kind == "equality":
        J = J + cfg.terminal_penalty * jnp.sum(jnp.abs(ex_last))
    elif engine.terminal_kind == "contractive":
        ex0 = Xb[0] - tuning.references.x[:, 0]
        J = J + cfg.terminal_penalty * jax.nn.relu(
            jnp.sum(ex_last**2) - 0.9 * jnp.sum(ex0**2)
        )
    return J


def solve_nonlinear_ms(
    system,
    tuning,
    engine: SqpEngine,
    x0: Array,
    warm_z: Array,  # (N*nu + (N+1)*nx,) flat (Ū, X̄) iterate
    warm_y: Array,  # ((N+1)*nx + N*nu,) flat (lamX, lamU) consensus duals
):
    """Multiple-shooting SQP solve (the reference's own transcription,
    fnn/mpc_modeler_implementation_fnn.jl:110-143: per-step state variables
    + dynamics equality constraints). Each outer iteration linearizes the
    dynamics along the (X̄, Ū) iterate — which need NOT satisfy them — and
    solves the sparse LTV Gauss-Newton subproblem on the block-tridiagonal
    Riccati KKT (ops/riccati_ltv.py). Robust where single shooting is not:
    an open-loop-unstable model's rollout (and its condensed QP) explodes
    with the horizon, while the defect formulation stays conditioned.

    Returns (MpcSolution, z_final_flat, y_final)."""
    from ..ops import riccati_ltv

    cfg = engine.config
    N = tuning.horizon
    nx, nu = system.nx, system.nu
    dt = jnp.float32
    w = tuning.weights
    refs: References = tuning.references
    x0 = jnp.asarray(x0, dt)

    if cfg.ms_rho is None:
        rho = jnp.maximum(2.0 * jnp.mean(jnp.diag(w.R.astype(dt))), 1e-6)
        # State rows scale-match their consensus rho to the state-cost
        # curvature (2·Q / 2·P): the dual climbs by rho_x·(w−v) per inner
        # iteration toward the row's shadow price, and with rho from R
        # (≈0.2) against 2·Q ≈ 200 it cannot get there in any budget —
        # see ops/riccati_ltv.solve_ms_qp docstring (r5 stall).
        rho_x = jnp.maximum(
            jnp.maximum(
                2.0 * jnp.mean(jnp.diag(w.Q.astype(dt))),
                2.0 * jnp.mean(jnp.diag(tuning.terminal.P.astype(dt))),
            ),
            rho,
        )
    else:
        rho = rho_x = jnp.asarray(cfg.ms_rho, dt)
    split_interior = engine.state_rows
    kind = engine.terminal_kind
    split_terminal = split_interior or kind in ("equality", "contractive")

    eye_x = jnp.eye(nx, dtype=dt)
    eye_u = jnp.eye(nu, dtype=dt)
    Qb = 2.0 * w.Q.astype(dt) + cfg.damping * eye_x
    if split_interior:
        Qb = Qb + rho_x * eye_x
    QbT = 2.0 * tuning.terminal.P.astype(dt) + cfg.damping * eye_x
    if split_terminal:
        QbT = QbT + rho_x * eye_x
    Rb = 2.0 * w.R.astype(dt) + (cfg.damping) * eye_u + rho * eye_u

    Ub0 = warm_z[: N * nu].reshape(N, nu).astype(dt)
    Xb0 = warm_z[N * nu :].reshape(N + 1, nx).astype(dt).at[0].set(x0)
    lamX0 = warm_y[: (N + 1) * nx].reshape(N + 1, nx).astype(dt)
    lamU0 = warm_y[(N + 1) * nx :].reshape(N, nu).astype(dt)

    ex0 = x0 - refs.x[:, 0]
    ball_r = jnp.sqrt(0.9) * jnp.linalg.norm(ex0)
    alphas = jnp.asarray(cfg.line_search_alphas, dt)
    f = lambda x, u: system.apply_fn(system.params, x, u)

    def sqp_step(Xb, Ub, lamX, lamU):
        As, Bs = jax.vmap(
            lambda x, u: jax.jacfwd(f, argnums=(0, 1))(x, u)
        )(Xb[:-1], Ub)
        cs = _defects(system, Xb, Ub)
        ex = Xb - refs.x.T  # (N+1, nx)
        eu = Ub - refs.u.T

        factors = riccati_ltv.ltv_factorize(As, Bs, cs, Qb, Rb, QbT)
        lq_nodes = jnp.zeros((N + 1, nx), dt)
        lq_nodes = lq_nodes.at[1:-1].set(
            2.0 * jnp.matmul(ex[1:-1], w.Q.astype(dt), precision=HIGHEST)
        )
        lq_nodes = lq_nodes.at[-1].set(
            2.0 * tuning.terminal.P.astype(dt) @ ex[-1]
        )
        lu0 = 2.0 * jnp.matmul(eu, w.R.astype(dt), precision=HIGHEST)

        u_lo = system.U.lo.astype(dt)[None] - Ub
        u_hi = system.U.hi.astype(dt)[None] - Ub
        x_lo = x_hi = None
        if split_interior:
            x_lo = system.X.lo.astype(dt)[None] - Xb[1:-1]
            x_hi = system.X.hi.astype(dt)[None] - Xb[1:-1]
        xN_lo = xN_hi = ball_c = None
        if kind == "equality":
            xN_lo = xN_hi = -ex[-1]
        elif kind == "contractive":
            ball_c = ex[-1]
        elif split_terminal:
            xN_lo = system.X.lo.astype(dt) - Xb[-1]
            xN_hi = system.X.hi.astype(dt) - Xb[-1]

        dX, dU, lamXn, lamUn, rp = riccati_ltv.solve_ms_qp(
            factors, lq_nodes, lu0, u_lo, u_hi, x_lo, x_hi,
            xN_lo, xN_hi, ball_c, ball_r, lamX, lamU, rho,
            int(cfg.ms_admm_iters),
            soft_mu=(
                float(cfg.soft_state_penalty) if engine.soft_boxes else None
            ),
            terminal_is_box=(kind not in ("equality", "contractive")),
            rho_x=rho_x,
        )

        def cand_merit(a):
            Xc = Xb + a * dX
            Uc = jnp.clip(Ub + a * dU, system.U.lo, system.U.hi)
            return _merit_ms(engine, tuning, system, Xc, Uc), Xc, Uc

        merits, Xcands, Ucands = jax.vmap(cand_merit)(alphas)
        merit0 = _merit_ms(engine, tuning, system, Xb, Ub)
        all_m = jnp.concatenate([merits, merit0[None]])
        all_X = jnp.concatenate([Xcands, Xb[None]], axis=0)
        all_U = jnp.concatenate([Ucands, Ub[None]], axis=0)
        best = jnp.argmin(all_m)
        X_new, U_new = all_X[best], all_U[best]
        du_norm = jnp.maximum(
            jnp.max(jnp.abs(X_new - Xb)), jnp.max(jnp.abs(U_new - Ub))
        )
        return X_new, U_new, lamXn, lamUn, du_norm

    def body(carry):
        Xb, Ub, lamX, lamU, it, done = carry
        Xn, Un, lamXn, lamUn, du_norm = sqp_step(Xb, Ub, lamX, lamU)
        # a small step alone is NOT convergence: the line search can take a
        # zero step on a merit plateau while the consensus duals are still
        # climbing (they keep updating through lamXn/lamUn and unlock
        # progress a few iterations later — observed r5). Declare done only
        # when the iterate is also feasible to the solver's own tolerance;
        # infeasible stalls run out the max_sqp_iter budget and report
        # STATUS_MAX_ITER honestly.
        viol_n = jnp.max(jnp.abs(_defects(system, Xn, Un)))
        viol_n = jnp.maximum(viol_n, _violation(engine, tuning, system, Xn))
        done_n = (du_norm < cfg.tol_du) & (viol_n <= cfg.feas_tol)
        return (Xn, Un, lamXn, lamUn, it + 1, done_n)

    def cond(carry):
        _, _, _, _, it, done = carry
        return (~done) & (it < cfg.max_sqp_iter)

    Xb, Ub, lamX, lamU, it_f, done_f = jax.lax.while_loop(
        cond,
        body,
        (Xb0, Ub0, lamX0, lamU0, jnp.asarray(0, jnp.int32), jnp.asarray(False)),
    )

    ex = Xb - refs.x.T
    eu = Ub - refs.u.T
    # honest status: measured violation includes the shooting defects — an
    # iterate whose states do not close the dynamics must not report
    # "converged, residual 0"
    viol = jnp.max(jnp.abs(_defects(system, Xb, Ub)))
    viol = jnp.maximum(viol, _violation(engine, tuning, system, Xb))
    status = jnp.where(
        done_f & (viol <= cfg.feas_tol), STATUS_CONVERGED, STATUS_MAX_ITER
    ).astype(jnp.int32)
    sol = MpcSolution(
        x=Xb.T,
        e_x=ex.T,
        u=Ub.T,
        e_u=eu.T,
        status=status,
        iterations=it_f,
        primal_residual=viol.astype(dt),
        dual_residual=jnp.asarray(0.0, dt),
        objective=true_objective(tuning, Xb, Ub),
    )
    z_f = jnp.concatenate([Ub.reshape(-1), Xb.reshape(-1)])
    y_f = jnp.concatenate([lamX.reshape(-1), lamU.reshape(-1)])
    return sol, z_f, y_f


def shift_warm_ms(z_flat: Array, y_flat: Array, N: int, nx: int, nu: int):
    """Receding-horizon shift of the multiple-shooting carry: inputs,
    state iterate and consensus duals each drop step 0 / repeat the last."""
    U = z_flat[: N * nu].reshape(N, nu)
    X = z_flat[N * nu :].reshape(N + 1, nx)
    lamX = y_flat[: (N + 1) * nx].reshape(N + 1, nx)
    lamU = y_flat[(N + 1) * nx :].reshape(N, nu)
    U_s = jnp.concatenate([U[1:], U[-1:]], axis=0)
    X_s = jnp.concatenate([X[1:], X[-1:]], axis=0)
    lamX_s = jnp.concatenate([lamX[1:], lamX[-1:]], axis=0)
    lamU_s = jnp.concatenate([lamU[1:], lamU[-1:]], axis=0)
    z = jnp.concatenate([U_s.reshape(-1), X_s.reshape(-1)])
    y = jnp.concatenate([lamX_s.reshape(-1), lamU_s.reshape(-1)])
    return z, y
