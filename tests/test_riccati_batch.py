"""The batched Riccati path (vmapped ops/riccati.py engine under
parallel.solve_batch / solve_sharded) vs one-lane runtime.solve_once.

Every lane of a batch runs the same sparse ADMM iteration as a single
solve, so solutions, statuses and the terminal-set behaviour must agree
lane by lane: terminal kinds, the contractive ball, warm start, the
terminal-rho equality boost and infeasibility detection."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import automationlabsmodelpredictivecontrol_jl_tpu as mpc
from automationlabsmodelpredictivecontrol_jl_tpu import parallel
from automationlabsmodelpredictivecontrol_jl_tpu.benchmarks import qtp
from automationlabsmodelpredictivecontrol_jl_tpu.ops.dare import solve_dare
from automationlabsmodelpredictivecontrol_jl_tpu.ops.riccati import (
    RiccatiConfig,
    build_riccati_operator,
    solve_sparse,
)

X_REF = np.full(4, 0.65, np.float32)
U_REF = np.full(2, 1.2, np.float32)
CFG = RiccatiConfig(max_iter=4000, eps_abs=1e-6, eps_rel=1e-6)


def _controller(N, cfg=CFG, **kw):
    return mpc.proceed_controller(
        qtp.linearized_discrete_system(), "model_predictive_control", N, 5.0,
        X_REF, U_REF, engine="riccati", riccati_config=cfg, **kw,
    )


def _x0s(B, seed=0, scale=0.1):
    rng = np.random.default_rng(seed)
    e = np.clip(scale * rng.standard_normal((B, 4)), -0.3, 0.3)
    return jnp.asarray(X_REF + e, jnp.float32)


def _single(c, x0s):
    """Lane-by-lane runtime.solve_once, stacked."""
    sols = [mpc.solve_once(c, x, c.warm_z, c.warm_y)[0] for x in x0s]
    return jax.tree_util.tree_map(lambda *a: jnp.stack(a), *sols)


@pytest.mark.parametrize(
    "state_constraint,terminal_kind",
    [(False, "none"), (True, "none"), (True, "contractive")],
)
def test_batch_matches_single(state_constraint, terminal_kind):
    c = _controller(12, mpc_state_constraint=state_constraint,
                    mpc_terminal_ingredient=terminal_kind)
    x0s = _x0s(8)
    sol_b, _, _, diag = parallel.solve_batch(c, x0s)
    sol_1 = _single(c, x0s)
    np.testing.assert_array_equal(np.asarray(sol_b.status), np.asarray(sol_1.status))
    assert int(diag.n_converged) == 8
    np.testing.assert_allclose(np.asarray(sol_b.u), np.asarray(sol_1.u), atol=5e-5)
    np.testing.assert_allclose(np.asarray(sol_b.x), np.asarray(sol_1.x), atol=5e-5)


def test_contractive_ball_binds():
    """A wide e0 makes the sqrt(0.9)||e0|| terminal ball an active
    constraint; the batched lanes must still satisfy it and match the
    single solves."""
    cfg = RiccatiConfig(max_iter=20000, eps_abs=1e-6, eps_rel=1e-6)
    c = _controller(3, cfg, mpc_terminal_ingredient="contractive")
    x0s = _x0s(8, seed=3, scale=0.25)
    sol_b, _, _, _ = parallel.solve_batch(c, x0s)
    assert np.all(np.asarray(sol_b.status) == 0)
    e0 = np.asarray(x0s) - X_REF
    eN = np.linalg.norm(np.asarray(sol_b.e_x)[:, :, -1], axis=1)
    assert np.all(eN <= np.sqrt(0.9) * np.linalg.norm(e0, axis=1) + 1e-3)
    sol_1 = _single(c, x0s)
    np.testing.assert_allclose(np.asarray(sol_b.u), np.asarray(sol_1.u), atol=2e-4)


def _operator(N, state_constraint):
    sys = qtp.linearized_discrete_system()
    w = mpc.create_weights(4, 2, 100.0, 0.1, 0.0)
    P = solve_dare(sys.A, sys.B, w.Q, w.R)
    lo = lambda box, ref: jnp.asarray(box.lo) - jnp.asarray(ref)
    hi = lambda box, ref: jnp.asarray(box.hi) - jnp.asarray(ref)
    return build_riccati_operator(
        sys.A, sys.B, w.Q, w.R, P, N, lo(qtp.X_BOX, X_REF), hi(qtp.X_BOX, X_REF),
        lo(qtp.U_BOX, U_REF), hi(qtp.U_BOX, U_REF), state_constraint,
    )


def test_warm_start_reduces_iterations():
    """Warm-starting every lane of the vmapped engine from its own solution
    and duals converges in no more iterations than the cold batch."""
    op = _operator(12, True)
    e0s = _x0s(8, seed=1) - X_REF
    X1, U1, st1, it1, _, _, lam1 = jax.vmap(
        lambda e: solve_sparse(op, e, config=CFG)
    )(e0s)
    X2, U2, st2, it2, *_ = jax.vmap(
        lambda e, u, lx, lu: solve_sparse(
            op, e, warm_U=u, warm_lam=(lx, lu), config=CFG
        )
    )(e0s, U1, *lam1)
    assert np.all(np.asarray(st2) == 0)
    assert float(jnp.mean(it2)) <= float(jnp.mean(it1))
    np.testing.assert_allclose(np.asarray(U2), np.asarray(U1), atol=1e-4)


def test_equality_boost_matches_single():
    """Feasible equality solve under the terminal-rho boost
    (rho_eq_scale): batched lanes match the single solves and certify
    convergence from a near-reference x0 (the weakly-reachable regime)."""
    cfg = RiccatiConfig(max_iter=20000, eps_abs=1e-6, eps_rel=1e-6)
    c = _controller(5, cfg, mpc_terminal_ingredient="equality")
    assert c.engine.op.term_rho_scale > 1.0
    x0s = jnp.asarray(
        X_REF + np.asarray(
            [[0.002, -0.002, 0.001, -0.001], [0.001, 0.002, -0.001, 0.0]]
        ),
        jnp.float32,
    )
    sol_b, _, _, _ = parallel.solve_batch(c, x0s)
    sol_1 = _single(c, x0s)
    assert np.all(np.asarray(sol_1.status) == 0)
    np.testing.assert_array_equal(np.asarray(sol_b.status), np.asarray(sol_1.status))
    np.testing.assert_allclose(np.asarray(sol_b.u), np.asarray(sol_1.u), atol=2e-4)
    # the terminal state actually reaches (near) zero deviation
    assert float(np.max(np.abs(np.asarray(sol_b.e_x)[:, :, -1]))) < 1e-4


def test_detects_infeasible_equality_sharded():
    """Equality terminal unreachable in 3 QTP steps from a wide x0: every
    shard of the mesh must flag primal infeasibility, as the single solve
    does."""
    c = _controller(3, RiccatiConfig(max_iter=4000),
                    mpc_terminal_ingredient="equality")
    mesh = parallel.make_mesh(8)
    x0s = jnp.tile(jnp.asarray(X_REF + 0.3, jnp.float32)[None], (8, 1))
    sol_s, _, _, diag = parallel.solve_sharded(c, x0s, mesh)
    sol_1 = _single(c, x0s[:1])
    assert int(sol_1.status[0]) == mpc.STATUS_PRIMAL_INFEASIBLE
    assert np.all(np.asarray(sol_s.status) == mpc.STATUS_PRIMAL_INFEASIBLE)
    assert int(diag.n_infeasible) == 8
