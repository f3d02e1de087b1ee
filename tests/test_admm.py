"""ADMM QP engine vs scipy oracle + status/infeasibility semantics
(the in-house OSQP replacement, SURVEY §2.9)."""

import jax
import jax.numpy as jnp
import numpy as np
from scipy.optimize import LinearConstraint, minimize

import automationlabsmodelpredictivecontrol_jl_tpu as mpc
from automationlabsmodelpredictivecontrol_jl_tpu.ops import admm


def _random_qp(seed, n=8, m=12):
    rng = np.random.default_rng(seed)
    M = rng.normal(size=(n, n))
    P = M @ M.T + 0.1 * np.eye(n)
    q = rng.normal(size=n)
    A = rng.normal(size=(m, n))
    z0 = rng.normal(size=n)
    slack = rng.uniform(0.1, 1.0, size=m)
    Az = A @ z0
    return P, q, A, Az - slack, Az + slack


def _oracle(P, q, A, l, u):
    fun = lambda z: 0.5 * z @ P @ z + q @ z
    jac = lambda z: P @ z + q
    res = minimize(
        fun, np.zeros(P.shape[0]), jac=jac,
        constraints=[LinearConstraint(A, l, u)],
        method="SLSQP", options={"maxiter": 800, "ftol": 1e-14},
    )
    if not res.success:  # SLSQP can stall on ill-conditioned QPs
        res = minimize(
            fun, np.zeros(P.shape[0]), jac=jac, hess=lambda z: P,
            constraints=[LinearConstraint(A, l, u)],
            method="trust-constr", options={"maxiter": 3000, "gtol": 1e-12},
        )
    assert res.success
    return res.x


def _solve(P, q, A, l, u, config=None, **kw):
    config = config or admm.AdmmConfig(max_iter=5000, eps_abs=1e-6, eps_rel=1e-6)
    eq = np.isfinite(l) & np.isfinite(u) & (l == u)
    op = admm.build_operator(P, A, eq, 0, config)
    return admm.solve(
        op, jnp.asarray(q, jnp.float32), jnp.asarray(l, jnp.float32),
        jnp.asarray(u, jnp.float32), jnp.zeros((0,), jnp.float32),
        jnp.asarray(0.0, jnp.float32), config=config, **kw
    )


def test_random_qps_match_oracle():
    for seed in range(4):
        P, q, A, l, u = _random_qp(seed)
        res = _solve(P, q, A, l, u)
        assert int(res.status) == mpc.STATUS_CONVERGED
        z_ref = _oracle(P, q, A, l, u)
        np.testing.assert_allclose(np.asarray(res.z, np.float64), z_ref, atol=2e-3)


def test_equality_rows_respected():
    P, q, A, l, u = _random_qp(5)
    pin = 0.5 * (l[0] + u[0])  # feasible by construction
    l[0] = u[0] = pin
    res = _solve(P, q, A, l, u)
    assert int(res.status) == mpc.STATUS_CONVERGED
    z = np.asarray(res.z, np.float64)
    assert abs(A[0] @ z - pin) < 1e-4


def test_primal_infeasible_detected():
    # contradictory rows: z_0 >= 1 and z_0 <= -1
    n = 4
    P = np.eye(n)
    q = np.zeros(n)
    A = np.zeros((2, n))
    A[0, 0] = 1.0
    A[1, 0] = 1.0
    l = np.asarray([1.0, -np.inf])
    u = np.asarray([np.inf, -1.0])
    res = _solve(P, q, A, l, u)
    assert int(res.status) == mpc.STATUS_PRIMAL_INFEASIBLE


def test_dual_infeasible_detected():
    # unbounded: zero curvature direction with strictly negative slope, no bound
    n = 2
    P = np.diag([1.0, 0.0])
    q = np.asarray([0.0, -1.0])
    A = np.asarray([[1.0, 0.0]])
    l = np.asarray([-1.0])
    u = np.asarray([1.0])
    res = _solve(P, q, A, l, u)
    assert int(res.status) == mpc.STATUS_DUAL_INFEASIBLE


def test_warm_start_reduces_iterations():
    P, q, A, l, u = _random_qp(7)
    cfg = admm.AdmmConfig(max_iter=4000, eps_abs=1e-6, eps_rel=1e-6)
    res_cold = _solve(P, q, A, l, u, config=cfg)
    res_warm = _solve(P, q, A, l, u, config=cfg, z0=res_cold.z, y0=res_cold.y)
    assert int(res_warm.iterations) < int(res_cold.iterations)
    assert int(res_warm.status) == mpc.STATUS_CONVERGED


def test_ball_projection_block():
    # min ||z - z*||^2 s.t. ||z|| <= r with r < ||z*|| -> solution on sphere
    n = 3
    P = 2.0 * np.eye(n)
    zstar = np.asarray([1.0, 1.0, 1.0])
    q = -2.0 * zstar
    A = np.eye(n)
    l = np.full(n, -np.inf)
    u = np.full(n, np.inf)
    cfg = admm.AdmmConfig(max_iter=4000, eps_abs=1e-7, eps_rel=1e-7)
    eq = np.zeros(n, bool)
    op = admm.build_operator(P, A, eq, n_ball=n, config=cfg)
    r = 0.5
    res = admm.solve(
        op, jnp.asarray(q, jnp.float32), jnp.asarray(l, jnp.float32),
        jnp.asarray(u, jnp.float32), jnp.zeros((n,), jnp.float32),
        jnp.asarray(r, jnp.float32), config=cfg,
    )
    z = np.asarray(res.z, np.float64)
    expected = zstar / np.linalg.norm(zstar) * r
    np.testing.assert_allclose(z, expected, atol=1e-3)


def test_vmapped_batch_statuses():
    P, q, A, l, u = _random_qp(9)
    cfg = admm.AdmmConfig(max_iter=2000, eps_abs=1e-6, eps_rel=1e-6)
    eq = np.isfinite(l) & np.isfinite(u) & (l == u)
    op = admm.build_operator(P, A, eq, 0, cfg)
    B = 16
    rng = np.random.default_rng(11)
    qs = jnp.asarray(q[None, :] + 0.1 * rng.normal(size=(B, q.size)), jnp.float32)

    def one(qi):
        return admm.solve(
            op, qi, jnp.asarray(l, jnp.float32), jnp.asarray(u, jnp.float32),
            jnp.zeros((0,), jnp.float32), jnp.asarray(0.0, jnp.float32), config=cfg,
        )

    res = jax.vmap(one)(qs)
    assert res.z.shape == (B, q.size)
    assert np.all(np.asarray(res.status) == mpc.STATUS_CONVERGED)
    # spot check one lane against the oracle
    z_ref = _oracle(P, np.asarray(qs[3], np.float64), A, l, u)
    np.testing.assert_allclose(np.asarray(res.z[3], np.float64), z_ref, atol=1e-3)


def test_nan_poisoned_qp_reports_numeric_error():
    """A NaN in the problem data must surface STATUS_NUMERIC_ERROR, not
    silently converge-or-not (SURVEY §5 sanitizer row; VERDICT r01 weak #8)."""
    P, q, A, l, u = _random_qp(0)
    q = q.copy()
    q[0] = np.nan
    res = _solve(P, q, A, l, u)
    assert int(res.status) == mpc.STATUS_NUMERIC_ERROR


def test_nan_poisoned_fused_kernel_reports_numeric_error():
    """The fused box-QP kernel (Pallas interpreter) keeps the per-lane NaN
    guard: the poisoned lane reports STATUS_NUMERIC_ERROR, the others
    converge."""
    from automationlabsmodelpredictivecontrol_jl_tpu.ops import admm_pallas

    P, q, _, _, _ = _random_qp(1)
    n = q.size
    A = np.eye(n)  # box-only: the operator the kernel takes
    l, u = -np.ones(n), np.ones(n)
    cfg = admm.AdmmConfig(max_iter=500, eps_abs=1e-6, eps_rel=1e-6)
    op = admm.build_operator(P, A, np.zeros(n, bool), 0, cfg)
    assert op.diag_a
    B = 4
    qb = np.tile(q, (B, 1)).astype(np.float32)
    qb[2, 0] = np.nan  # poison one lane only
    lb = np.tile(l, (B, 1)).astype(np.float32)
    ub = np.tile(u, (B, 1)).astype(np.float32)
    z, y, s, status, iters, rp, rd = admm_pallas.solve_batch_fused(
        op, jnp.asarray(qb), jnp.asarray(lb), jnp.asarray(ub),
        config=cfg, interpret=True,
    )
    status = np.asarray(status)
    assert status[2] == mpc.STATUS_NUMERIC_ERROR
    assert all(status[i] == mpc.STATUS_CONVERGED for i in (0, 1, 3))


def test_newton_schulz_inverse_with_refinement_at_high_kappa():
    """Pins the r4 review finding: the f32 Newton-Schulz iteration
    saturates at a residual floor ~kappa*eps (more iterations do NOT
    help), and ONE refinement step against the exact K restores solve
    accuracy — which is why SqpConfig keeps AdmmConfig.refine_steps=1.
    The K-solve (x = K^-1 rhs, then one refine) must be accurate at the
    condition numbers weak-R SQP subproblems actually produce."""
    import numpy as np
    from automationlabsmodelpredictivecontrol_jl_tpu.ops.admm import (
        newton_schulz_inverse,
    )

    rng = np.random.default_rng(0)
    n = 40
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    for kappa in (1e2, 1e3, 1e4):
        lam = np.geomspace(1.0 / kappa, 1.0, n)
        K = ((Q * lam) @ Q.T).astype(np.float32)
        Ki = np.asarray(newton_schulz_inverse(jnp.asarray(K)))
        rhs = rng.standard_normal(n).astype(np.float32)
        x = Ki @ rhs
        x = x + Ki @ (rhs - K @ x)  # refine_steps=1
        x_exact = np.linalg.solve(K.astype(np.float64), rhs)
        rel = np.max(np.abs(x - x_exact)) / np.max(np.abs(x_exact))
        assert rel < 1e-4, (kappa, rel)
