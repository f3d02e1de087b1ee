"""Condensed-QP transcription: prediction operators + structural row layout
(the analogue of the reference's JuMP constraint-count tests,
modeler_implementation_test.jl / SURVEY §4b)."""

import jax
import jax.numpy as jnp
import numpy as np

import automationlabsmodelpredictivecontrol_jl_tpu as mpc
from automationlabsmodelpredictivecontrol_jl_tpu.benchmarks import qtp
from automationlabsmodelpredictivecontrol_jl_tpu.ops.condense import (
    condense,
    lti_prediction_matrices,
    ltv_prediction_matrices,
    runtime_qp_vectors,
)
from automationlabsmodelpredictivecontrol_jl_tpu.terminal import create_terminal_ingredient


def test_prediction_matrices_match_rollout():
    rng = np.random.default_rng(0)
    N, nx, nu = 6, 3, 2
    A = jnp.asarray(rng.normal(size=(nx, nx)) * 0.5, jnp.float32)
    B = jnp.asarray(rng.normal(size=(nx, nu)), jnp.float32)
    F, G, h = lti_prediction_matrices(A, B, N)
    e0 = jnp.asarray(rng.normal(size=nx), jnp.float32)
    du = jnp.asarray(rng.normal(size=(N, nu)), jnp.float32)
    # dense rollout
    e = e0
    expected = []
    for k in range(N):
        e = A @ e + B @ du[k]
        expected.append(np.asarray(e))
    G_flat = G.transpose(0, 2, 1, 3).reshape(N * nx, N * nu)
    pred = (G_flat @ du.reshape(-1) + F.reshape(N * nx, nx) @ e0).reshape(N, nx)
    np.testing.assert_allclose(np.asarray(pred), np.asarray(expected), atol=1e-4)


def test_ltv_affine_offsets():
    rng = np.random.default_rng(1)
    N, nx, nu = 4, 2, 1
    As = jnp.asarray(rng.normal(size=(N, nx, nx)) * 0.4, jnp.float32)
    Bs = jnp.asarray(rng.normal(size=(N, nx, nu)), jnp.float32)
    cs = jnp.asarray(rng.normal(size=(N, nx)), jnp.float32)
    F, G, h = ltv_prediction_matrices(As, Bs, cs)
    e0 = jnp.asarray(rng.normal(size=nx), jnp.float32)
    du = jnp.asarray(rng.normal(size=(N, nu)), jnp.float32)
    e = e0
    expected = []
    for k in range(N):
        e = As[k] @ e + Bs[k] @ du[k] + cs[k]
        expected.append(np.asarray(e))
    G_flat = G.transpose(0, 2, 1, 3).reshape(N * nx, N * nu)
    pred = (
        G_flat @ du.reshape(-1) + F.reshape(N * nx, nx) @ e0 + h.reshape(-1)
    ).reshape(N, nx)
    np.testing.assert_allclose(np.asarray(pred), np.asarray(expected), atol=1e-4)


def _qp(kind, state_constraint, N=5):
    sys = qtp.linearized_discrete_system()
    refs = mpc.design_references(np.full(4, 0.65), np.full(2, 1.2), N)
    w = mpc.create_weights(4, 2, 100.0, 0.1, 0.0)
    term = create_terminal_ingredient(sys, kind, refs, w)
    return condense(sys.A, sys.B, N, w, term, refs, sys.X, sys.U, state_constraint), term


def test_row_layout_counts():
    # structural analogue of the reference's exact constraint counts at N=5
    # (terminal_ingredient_test.jl:160,237,317): rows scale with kind.
    N, nx, nu = 5, 4, 2
    qp_none, _ = _qp("none", False)
    assert qp_none.A.shape == (N * nu, N * nu)
    qp_eq, _ = _qp("equality", False)
    assert qp_eq.A.shape == (N * nu + nx, N * nu)
    qp_con, _ = _qp("contractive", False)
    assert qp_con.A.shape == (N * nu + nx, N * nu)
    assert qp_con.n_ball == nx
    qp_state, _ = _qp("none", True)
    assert qp_state.A.shape == (N * nu + N * nx, N * nu)


def test_runtime_vectors_affine_in_x0():
    qp, _ = _qp("equality", True)
    e0a = jnp.asarray([0.1, 0.0, -0.1, 0.05], jnp.float32)
    qa, la, ua, _, _ = runtime_qp_vectors(qp, e0a)
    q0, l0, u0, _, _ = runtime_qp_vectors(qp, jnp.zeros(4))
    q2, l2, u2, _, _ = runtime_qp_vectors(qp, 2.0 * e0a)
    # affine: f(2 e0) - f(0) == 2 (f(e0) - f(0))
    np.testing.assert_allclose(np.asarray(q2 - q0), 2 * np.asarray(qa - q0), atol=1e-4)
    np.testing.assert_allclose(np.asarray(l2 - l0), 2 * np.asarray(la - l0), atol=1e-4)


def test_qp_objective_matches_true_cost():
    # 0.5 z'Pz + q'z + const == reference cost formula on the rollout
    from automationlabsmodelpredictivecontrol_jl_tpu.solvers.sqp import true_objective

    N = 5
    sys = qtp.linearized_discrete_system()
    refs = mpc.design_references(np.full(4, 0.65), np.full(2, 1.2), N)
    w = mpc.create_weights(4, 2, 100.0, 0.1, 0.5)  # S nonzero too
    term = create_terminal_ingredient(sys, "none", refs, w)
    qp = condense(sys.A, sys.B, N, w, term, refs, sys.X, sys.U, False)

    class T:  # minimal tuning shim for true_objective
        references = refs
        weights = w
        terminal = term

    rng = np.random.default_rng(3)
    x0 = jnp.asarray(0.65 + 0.05 * rng.normal(size=4), jnp.float32)
    e0 = x0 - refs.x[:, 0]
    z = jnp.asarray(rng.normal(size=N * 2) * 0.1, jnp.float32)
    q, *_ = runtime_qp_vectors(qp, e0)

    ex_tail = (qp.G_flat @ z + qp.F.reshape(-1, 4) @ e0).reshape(N, 4)
    xs = jnp.concatenate([x0[None], ex_tail + refs.x.T[1:]], axis=0)
    us = z.reshape(N, 2) + refs.u.T
    J_true = float(true_objective(T, xs, us))

    J_qp = float(0.5 * z @ qp.P @ z + q @ z)
    # constant offset: evaluate at z=0 to extract it
    ex0_tail = (qp.F.reshape(-1, 4) @ e0).reshape(N, 4)
    xs0 = jnp.concatenate([x0[None], ex0_tail + refs.x.T[1:]], axis=0)
    J0_true = float(true_objective(T, xs0, refs.u.T))
    assert abs((J_true - J0_true) - J_qp) < 1e-2 * max(1.0, abs(J_true))
