"""Condensed MPC → QP transcription.

The reference materializes the MPC problem as JuMP scalar constraint rows
(linear/mpc_modeler_implementation_linear.jl:48-102) handed to OSQP/SCIP.
Here we *condense*: eliminate the state trajectory with prediction matrices
so the decision variable is only the stacked input deviation sequence
``z = vec(e_u)`` — the QP data become small dense matrices, every runtime
quantity that depends on the measured state x0 is a tiny matrix-vector
product, and the ADMM iteration is pure batched GEMM.

Semantics parity (deviation-variable formulation, linear/...:58-60):

    e_x[k+1] = A e_x[k] + B e_u[k],  e_x[1] = x0 - x_ref[:,0]
    cost  = e_x[N+1]' P e_x[N+1] + sum_{i=1..N} e_x[i]'Q e_x[i] + e_u[i]'R e_u[i]
            + sum_{i=1..N-1} (u[i]-u[i+1])' S (u[i]-u[i+1])        (design_mpc.jl:436-465)
    boxes: inputs always (linear/...:72-78), states opt-in (linear/...:62-70)
    terminal kinds: none | equality | contractive | neighborhood (design_mpc.jl:330-391)

Stacking convention: step-major, vec order [e_u_1; e_u_2; ...; e_u_N], and
the predicted states cover steps 2..N+1 (e_x_1 is the fixed initial
deviation — it enters the QP only through the affine terms).
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import jax
import jax.numpy as jnp

from ..types import Box, References, TerminalIngredient, Weights, CONTRACTIVE_FACTOR
from ..utils.pytrees import pytree_dataclass, static_field

Array = Any
HIGHEST = jax.lax.Precision.HIGHEST


def ltv_prediction_matrices(
    As: Array, Bs: Array, cs: Optional[Array] = None
) -> Tuple[Array, Array, Array]:
    """Prediction operators for e_{k+1} = A_k e_k + B_k du_k + c_k, k=0..N-1.

    As: (N, nx, nx), Bs: (N, nx, nu), cs: (N, nx) or None.
    Returns
      F: (N, nx, nx)   with e_pred[i] += F[i] @ e_0
      G: (N, N, nx, nu) lower-block-triangular, e_pred[i] += sum_j G[i,j] @ du_j
      h: (N, nx)       affine offset from the residuals cs
    so that e_pred[i] = e_{i+2} in 1-based reference indexing (steps 2..N+1).

    Built with one lax.scan over the horizon (each step is a single batched
    matmul) — jit-friendly, reused per-SQP-iteration for LTV subproblems.
    """
    N, nx, nu = Bs.shape
    dtype = Bs.dtype
    if cs is None:
        cs = jnp.zeros((N, nx), dtype)

    def row(carry, inp):
        Fprev, Gprev, hprev = carry  # (nx,nx), (N,nx,nu), (nx,)
        A_k, B_k, c_k, k = inp
        Gr = jnp.einsum("ab,jbc->jac", A_k, Gprev, precision=HIGHEST)
        Gr = jax.lax.dynamic_update_index_in_dim(Gr, B_k, k, axis=0)
        Fr = jnp.matmul(A_k, Fprev, precision=HIGHEST)
        hr = A_k @ hprev + c_k
        return (Fr, Gr, hr), (Fr, Gr, hr)

    init = (jnp.eye(nx, dtype=dtype), jnp.zeros((N, nx, nu), dtype), jnp.zeros((nx,), dtype))
    _, (F, G, h) = jax.lax.scan(row, init, (As, Bs, cs, jnp.arange(N)))
    return F, G, h


def lti_prediction_matrices(A: Array, B: Array, N: int):
    """LTI specialization: tile A,B across the horizon."""
    As = jnp.broadcast_to(A, (N,) + A.shape)
    Bs = jnp.broadcast_to(B, (N,) + B.shape)
    return ltv_prediction_matrices(As, Bs)


@pytree_dataclass
class CondensedQpData:
    """Everything needed to pose + solve the condensed QP for any x0.

    Static across solves (per controller design); the per-solve
    (x0-dependent) data are produced by :func:`runtime_qp_vectors` as
    4 small GEMVs. Row layout of A: [input-box rows (N*nu)] then
    [state-box rows (N*nx), opt-in] then [terminal rows (nx or m_H or 0)].
    The last ``n_ball`` rows are a Euclidean-ball block (contractive
    terminal set) handled by projection, not by bounds.
    """

    # QP operators (unscaled)
    P: Array  # (n, n)
    A: Array  # (m, n)
    # x0-affine runtime data: q = q_const + q_x0 @ e0, etc.
    q_const: Array  # (n,)
    q_x0: Array  # (n, nx)
    l_const: Array  # (m,)
    u_const: Array  # (m,)
    b_x0: Array  # (m, nx)  shift applied to BOTH l and u rows (0 for input rows)
    ball_c_x0: Array  # (n_ball, nx): ball center = ball_c_x0 @ e0 (+0 const)
    # trajectory reconstruction: e_x[2..N+1] = Gmat z + F e0
    F: Array  # (N, nx, nx)
    G_flat: Array  # (N*nx, n)
    # dimensions / flags (static)
    N: int = static_field()
    nx: int = static_field()
    nu: int = static_field()
    n_ball: int = static_field()  # 0 or nx (contractive)
    ball_radius_sq_factor: float = static_field()  # rho_c in ||e_N+1||^2<=rho_c||e_1||^2


def _blockdiag_weight(Q: Array, P: Array, N: int) -> Array:
    """diag(Q, ..., Q, P) with N blocks (steps 2..N get Q, step N+1 gets P).

    Note cost-index parity: the reference's stage sum runs i=1..N over
    e_x[:,1..N] (design_mpc.jl:440-445) — e_x_1 is constant, steps 2..N
    carry Q, and e_x_{N+1} appears only through P.
    """
    nx = Q.shape[0]
    blocks = jnp.broadcast_to(Q, (N, nx, nx))
    blocks = blocks.at[N - 1].set(P)
    return jax.scipy.linalg.block_diag(*[blocks[i] for i in range(N)])


def _difference_operator(N: int, nu: int, dtype) -> Array:
    """D: ((N-1)*nu, N*nu) with (D z)_i = z_i - z_{i+1} per step.

    Matches delta_u[:, i] == u[:, i] - u[:, i+1] (design_mpc.jl:431).
    """
    eye = jnp.eye(N, dtype=dtype)
    Dstep = eye[:-1] - eye[1:]  # (N-1, N)
    return jnp.kron(Dstep, jnp.eye(nu, dtype=dtype))


def condense(
    A: Array,
    B: Array,
    horizon: int,
    weights: Weights,
    terminal: TerminalIngredient,
    references: References,
    X: Box,
    U: Box,
    state_constraint: bool,
) -> CondensedQpData:
    """Build the condensed QP data for a discrete linear (or linearized)
    system. Runs at design time (jit-compatible; also reused inside SQP).
    """
    dtype = jnp.result_type(B, jnp.float32)
    N = horizon
    nx, nu = B.shape
    n = N * nu

    F, G, _ = lti_prediction_matrices(A.astype(dtype), B.astype(dtype), N)
    G_flat = G.transpose(0, 2, 1, 3).reshape(N * nx, N * nu)
    F_flat = F.reshape(N * nx, nx)

    Qbar = _blockdiag_weight(weights.Q.astype(dtype), terminal.P.astype(dtype), N)
    Rbar = jnp.kron(jnp.eye(N, dtype=dtype), weights.R.astype(dtype))

    GtQ = jnp.matmul(G_flat.T, Qbar, precision=HIGHEST)
    P_qp = 2.0 * (jnp.matmul(GtQ, G_flat, precision=HIGHEST) + Rbar)
    q_x0 = 2.0 * jnp.matmul(GtQ, F_flat, precision=HIGHEST)  # (n, nx)

    uref_stack = references.u.T.reshape(-1)  # (N*nu,) step-major
    xref_stack = references.x.T[1:].reshape(-1)  # steps 2..N+1, (N*nx,)

    q_const = jnp.zeros((n,), dtype)
    # static S check: under tracing (LTV reuse inside jit) the values are
    # abstract, so the Δu term is included unconditionally — it is exact
    # (S=0 makes it vanish) and keeps the function jit-safe.
    if isinstance(weights.S, jax.core.Tracer) or bool(
        jnp.any(jnp.asarray(weights.S) != 0.0)
    ):
        D = _difference_operator(N, nu, dtype)
        Sbar = jnp.kron(jnp.eye(N - 1, dtype=dtype), weights.S.astype(dtype))
        d_vec = D @ uref_stack  # delta of the reference inputs
        P_qp = P_qp + 2.0 * D.T @ Sbar @ D
        q_const = q_const + 2.0 * D.T @ Sbar @ d_vec

    # --- constraint rows ---------------------------------------------------
    rows_A = [jnp.eye(n, dtype=dtype)]
    rows_l = [jnp.tile(U.lo.astype(dtype), N) - uref_stack]
    rows_u = [jnp.tile(U.hi.astype(dtype), N) - uref_stack]
    rows_bx0 = [jnp.zeros((n, nx), dtype)]

    if state_constraint:
        rows_A.append(G_flat)
        rows_l.append(jnp.tile(X.lo.astype(dtype), N) - xref_stack)
        rows_u.append(jnp.tile(X.hi.astype(dtype), N) - xref_stack)
        rows_bx0.append(-F_flat)

    n_ball = 0
    ball_c_x0 = jnp.zeros((0, nx), dtype)
    G_last = G_flat[-nx:]
    F_last = F_flat[-nx:]
    if terminal.kind == "equality":
        rows_A.append(G_last)
        rows_l.append(jnp.zeros((nx,), dtype))
        rows_u.append(jnp.zeros((nx,), dtype))
        rows_bx0.append(-F_last)
    elif terminal.kind == "neighborhood":
        if terminal.H is None or terminal.b is None:
            raise ValueError("neighborhood terminal kind requires H, b")
        H = terminal.H.astype(dtype)
        rows_A.append(jnp.matmul(H, G_last, precision=HIGHEST))
        rows_l.append(jnp.full((H.shape[0],), -jnp.inf, dtype))
        rows_u.append(terminal.b.astype(dtype))
        rows_bx0.append(-jnp.matmul(H, F_last, precision=HIGHEST))
    elif terminal.kind == "contractive":
        # ball block: s = G_last z; require ||s + F_last e0||^2 <= rho_c ||e0||^2
        rows_A.append(G_last)
        rows_l.append(jnp.full((nx,), -jnp.inf, dtype))
        rows_u.append(jnp.full((nx,), jnp.inf, dtype))
        rows_bx0.append(jnp.zeros((nx, nx), dtype))
        n_ball = nx
        ball_c_x0 = F_last

    A_qp = jnp.concatenate(rows_A, axis=0)
    l_const = jnp.concatenate(rows_l, axis=0)
    u_const = jnp.concatenate(rows_u, axis=0)
    b_x0 = jnp.concatenate(rows_bx0, axis=0)

    return CondensedQpData(
        P=P_qp,
        A=A_qp,
        q_const=q_const,
        q_x0=q_x0,
        l_const=l_const,
        u_const=u_const,
        b_x0=b_x0,
        ball_c_x0=ball_c_x0,
        F=F,
        G_flat=G_flat,
        N=N,
        nx=nx,
        nu=nu,
        n_ball=n_ball,
        ball_radius_sq_factor=CONTRACTIVE_FACTOR,
    )


def condense_np(
    A,
    B,
    horizon: int,
    weights: Weights,
    terminal: TerminalIngredient,
    references: References,
    X: Box,
    U: Box,
    state_constraint: bool,
) -> CondensedQpData:
    """Pure-numpy twin of :func:`condense` for the design path.

    Controller design is host-side and once-per-controller; doing it in
    numpy avoids ANY XLA compilation at design time (milliseconds in numpy
    against seconds of compiling for every new design shape).
    Produces bitwise-compatible f32 arrays in the same CondensedQpData.
    """
    import numpy as onp

    N = horizon
    A64 = onp.asarray(A, onp.float64)
    B64 = onp.asarray(B, onp.float64)
    nx, nu = B64.shape
    n = N * nu

    # prediction operators by forward recursion
    F = onp.zeros((N, nx, nx))
    G = onp.zeros((N, N, nx, nu))
    Fk = onp.eye(nx)
    for k in range(N):
        Gk = onp.zeros((N, nx, nu))
        if k > 0:
            Gk = onp.einsum("ab,jbc->jac", A64, G[k - 1])
        Gk[k] = B64
        Fk = A64 @ Fk
        F[k] = Fk
        G[k] = Gk
    G_flat = G.transpose(0, 2, 1, 3).reshape(N * nx, N * nu)
    F_flat = F.reshape(N * nx, nx)

    Q = onp.asarray(weights.Q, onp.float64)
    P_term = onp.asarray(terminal.P, onp.float64)
    R = onp.asarray(weights.R, onp.float64)
    S = onp.asarray(weights.S, onp.float64)
    Qbar = onp.zeros((N * nx, N * nx))
    for i in range(N):
        Qbar[i * nx : (i + 1) * nx, i * nx : (i + 1) * nx] = (
            P_term if i == N - 1 else Q
        )
    Rbar = onp.kron(onp.eye(N), R)

    GtQ = G_flat.T @ Qbar
    P_qp = 2.0 * (GtQ @ G_flat + Rbar)
    q_x0 = 2.0 * (GtQ @ F_flat)

    uref_stack = onp.asarray(references.u).T.reshape(-1)
    xref_stack = onp.asarray(references.x).T[1:].reshape(-1)

    q_const = onp.zeros(n)
    if onp.any(S != 0.0):
        eye = onp.eye(N)
        Dstep = eye[:-1] - eye[1:]
        D = onp.kron(Dstep, onp.eye(nu))
        Sbar = onp.kron(onp.eye(N - 1), S)
        P_qp = P_qp + 2.0 * D.T @ Sbar @ D
        q_const = q_const + 2.0 * D.T @ Sbar @ (D @ uref_stack)

    rows_A = [onp.eye(n)]
    rows_l = [onp.tile(onp.asarray(U.lo, onp.float64), N) - uref_stack]
    rows_u = [onp.tile(onp.asarray(U.hi, onp.float64), N) - uref_stack]
    rows_bx0 = [onp.zeros((n, nx))]
    if state_constraint:
        rows_A.append(G_flat)
        rows_l.append(onp.tile(onp.asarray(X.lo, onp.float64), N) - xref_stack)
        rows_u.append(onp.tile(onp.asarray(X.hi, onp.float64), N) - xref_stack)
        rows_bx0.append(-F_flat)

    n_ball = 0
    ball_c_x0 = onp.zeros((0, nx))
    G_last = G_flat[-nx:]
    F_last = F_flat[-nx:]
    if terminal.kind == "equality":
        rows_A.append(G_last)
        rows_l.append(onp.zeros(nx))
        rows_u.append(onp.zeros(nx))
        rows_bx0.append(-F_last)
    elif terminal.kind == "neighborhood":
        if terminal.H is None or terminal.b is None:
            raise ValueError("neighborhood terminal kind requires H, b")
        H = onp.asarray(terminal.H, onp.float64)
        rows_A.append(H @ G_last)
        rows_l.append(onp.full(H.shape[0], -onp.inf))
        rows_u.append(onp.asarray(terminal.b, onp.float64))
        rows_bx0.append(-(H @ F_last))
    elif terminal.kind == "contractive":
        rows_A.append(G_last)
        rows_l.append(onp.full(nx, -onp.inf))
        rows_u.append(onp.full(nx, onp.inf))
        rows_bx0.append(onp.zeros((nx, nx)))
        n_ball = nx
        ball_c_x0 = F_last

    f32 = lambda a: jnp.asarray(a, jnp.float32)
    return CondensedQpData(
        P=f32(P_qp),
        A=f32(onp.concatenate(rows_A, axis=0)),
        q_const=f32(q_const),
        q_x0=f32(q_x0),
        l_const=f32(onp.concatenate(rows_l)),
        u_const=f32(onp.concatenate(rows_u)),
        b_x0=f32(onp.concatenate(rows_bx0, axis=0)),
        ball_c_x0=f32(ball_c_x0),
        F=f32(F),
        G_flat=f32(G_flat),
        N=N,
        nx=nx,
        nu=nu,
        n_ball=n_ball,
        ball_radius_sq_factor=CONTRACTIVE_FACTOR,
    )


def runtime_qp_vectors(qp: CondensedQpData, e0: Array):
    """Per-solve (x0-dependent) QP vectors — 3 tiny GEMVs + a norm.

    This is the whole runtime analogue of the reference's
    update_initialization! (computation_mpc.jl:17-29): the only thing that
    changes between successive solves is the measured state.
    Returns (q, l, u, ball_c, ball_r).
    """
    # explicit f32 precision: a reduced-precision @ (TF32 on the GPU)
    # perturbs the very QP being solved far above the 1e-4 parity bar;
    # same bug class as the model-zoo precision pin. Batched callers use
    # runtime_qp_vectors_batch — per-lane GEMVs under vmap defeat the
    # shared-operand GEMM.
    mv = lambda M, v: jnp.matmul(M, v, precision=HIGHEST)
    q = qp.q_const + mv(qp.q_x0, e0)
    shift = mv(qp.b_x0, e0)  # b_x0 already carries the sign (-F)
    l = qp.l_const + shift
    u = qp.u_const + shift
    if qp.n_ball:
        ball_c = mv(qp.ball_c_x0, e0)
        ball_r = jnp.sqrt(qp.ball_radius_sq_factor) * jnp.linalg.norm(e0)
    else:
        ball_c = jnp.zeros((0,), q.dtype)
        ball_r = jnp.asarray(0.0, q.dtype)
    return q, l, u, ball_c, ball_r


def runtime_qp_vectors_batch(qp: CondensedQpData, e0s: Array):
    """Batch-major runtime QP vectors: (B, nx) @ (nx, rows) shared-matrix
    GEMMs at full f32 precision.

    Numerically identical role to ``vmap(runtime_qp_vectors)`` but lowers
    to three ordinary GEMMs instead of vmapped per-lane GEMVs (the batched
    (B, n, nx) x (B, nx) form defeats XLA's shared-operand hoisting), at
    the same accuracy."""
    mm = lambda M: jnp.matmul(e0s, M.T, precision=HIGHEST)
    q = qp.q_const[None] + mm(qp.q_x0)
    shift = mm(qp.b_x0)
    l = qp.l_const[None] + shift
    u = qp.u_const[None] + shift
    if qp.n_ball:
        ball_c = mm(qp.ball_c_x0)
        ball_r = jnp.sqrt(qp.ball_radius_sq_factor) * jnp.linalg.norm(
            e0s, axis=1
        )
    else:
        B = e0s.shape[0]
        ball_c = jnp.zeros((B, 0), q.dtype)
        ball_r = jnp.zeros((B,), q.dtype)
    return q, l, u, ball_c, ball_r
