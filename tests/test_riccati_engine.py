"""Product-level Riccati engine: design routing, runtime parity with the
condensed engine at N=5-20, warm-start carry, checkpoint round-trip
(VERDICT r01 next-round item 1 — the engine must be reachable from
design_controller, not dead surface)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import automationlabsmodelpredictivecontrol_jl_tpu as mpc
from automationlabsmodelpredictivecontrol_jl_tpu.benchmarks import qtp
from automationlabsmodelpredictivecontrol_jl_tpu.ops.riccati import RiccatiConfig

X_REF = np.full(4, 0.65)
U_REF = np.full(2, 1.2)
TIGHT = RiccatiConfig(max_iter=6000, eps_abs=1e-6, eps_rel=1e-6)


def _pair(N, *, terminal="none", state_constraint=False):
    """(condensed controller, riccati controller) with tight tolerances."""
    sys = qtp.linearized_discrete_system()
    kw = dict(
        terminal_ingredient=terminal,
        state_constraint=state_constraint,
    )
    c_cond = mpc.design_controller(
        sys, N, 5.0, X_REF, U_REF, engine="condensed",
        admm_config=mpc.AdmmConfig(max_iter=6000, eps_abs=1e-6, eps_rel=1e-6),
        **kw,
    )
    c_ric = mpc.design_controller(
        sys, N, 5.0, X_REF, U_REF, engine="riccati", riccati_config=TIGHT, **kw
    )
    return c_cond, c_ric


def test_design_routes_riccati():
    sys = qtp.linearized_discrete_system()
    c = mpc.design_controller(sys, 10, 5.0, X_REF, U_REF, engine="riccati")
    assert isinstance(c.engine, mpc.RiccatiEngine)
    # auto crossover: horizons past the threshold (design.py
    # RICCATI_AUTO_HORIZON = 500) get the sparse engine
    c_long = mpc.design_controller(
        sys, mpc.design.RICCATI_AUTO_HORIZON + 10, 5.0, X_REF, U_REF
    )
    assert isinstance(c_long.engine, mpc.RiccatiEngine)
    c_short = mpc.design_controller(sys, 60, 5.0, X_REF, U_REF)
    assert isinstance(c_short.engine, mpc.LinearEngine)
    # unsupported features raise when forced, fall back under auto
    with pytest.raises(ValueError, match="riccati"):
        mpc.design_controller(
            sys, 10, 5.0, X_REF, U_REF, engine="riccati", S=0.5
        )
    c_s = mpc.design_controller(
        sys, mpc.design.RICCATI_AUTO_HORIZON + 10, 5.0, X_REF, U_REF, S=0.5
    )
    assert isinstance(c_s.engine, mpc.LinearEngine)


@pytest.mark.parametrize("N", [5, 12, 20])
@pytest.mark.parametrize(
    "terminal,state_constraint",
    [("none", False), ("none", True), ("contractive", False)],
)
def test_riccati_matches_condensed(N, terminal, state_constraint):
    c_cond, c_ric = _pair(N, terminal=terminal, state_constraint=state_constraint)
    x0 = jnp.asarray([0.5, 0.55, 0.6, 0.75])
    _, sol_a = mpc.step(c_cond, x0)
    _, sol_b = mpc.step(c_ric, x0)
    assert int(sol_a.status) == 0
    assert int(sol_b.status) == 0
    np.testing.assert_allclose(
        np.asarray(sol_b.u), np.asarray(sol_a.u), atol=5e-3
    )
    np.testing.assert_allclose(
        np.asarray(sol_b.x), np.asarray(sol_a.x), atol=5e-3
    )


def _double_integrator():
    """Fast, strongly controllable plant: terminal equality reachable in a
    few steps (QTP is too slow for short-horizon equality terminals — the
    condensed engine itself reports primal-infeasible there)."""
    A = np.array([[1.0, 0.5], [0.0, 1.0]], np.float32)
    B = np.array([[0.125], [0.5]], np.float32)
    X = mpc.Box(lo=np.full(2, -5.0, np.float32), hi=np.full(2, 5.0, np.float32))
    U = mpc.Box(lo=np.full(1, -3.0, np.float32), hi=np.full(1, 3.0, np.float32))
    return mpc.LinearDiscreteSystem(A=A, B=B, X=X, U=U)


@pytest.mark.parametrize("N", [5, 12, 20])
def test_riccati_matches_condensed_equality(N):
    sys = _double_integrator()
    xr, ur = np.zeros(2), np.zeros(1)
    c_cond = mpc.design_controller(
        sys, N, 1.0, xr, ur, engine="condensed", terminal_ingredient="equality",
        Q=10.0, R=0.1,
        admm_config=mpc.AdmmConfig(max_iter=8000, eps_abs=1e-6, eps_rel=1e-6),
    )
    c_ric = mpc.design_controller(
        sys, N, 1.0, xr, ur, engine="riccati", terminal_ingredient="equality",
        Q=10.0, R=0.1,
        riccati_config=RiccatiConfig(max_iter=8000, eps_abs=1e-6, eps_rel=1e-6),
    )
    x0 = jnp.asarray([1.0, -0.5])
    _, sol_a = mpc.step(c_cond, x0)
    _, sol_b = mpc.step(c_ric, x0)
    assert int(sol_a.status) == 0
    assert int(sol_b.status) == 0
    np.testing.assert_allclose(np.asarray(sol_b.e_x[:, -1]), 0.0, atol=1e-3)
    np.testing.assert_allclose(
        np.asarray(sol_b.u), np.asarray(sol_a.u), atol=1e-2
    )


def test_infeasible_equality_detected():
    """QTP can't reach e_N = 0 in 5 steps from a large deviation: both
    engines must flag it instead of returning garbage (the reference never
    even checks termination status, computation_mpc.jl:38-55)."""
    from automationlabsmodelpredictivecontrol_jl_tpu.types import (
        STATUS_MAX_ITER,
        STATUS_PRIMAL_INFEASIBLE,
    )

    c_cond, c_ric = _pair(5, terminal="equality")
    x0 = jnp.asarray([0.6, 0.6, 0.7, 0.7])
    _, sol_a = mpc.step(c_cond, x0)
    _, sol_b = mpc.step(c_ric, x0)
    assert int(sol_a.status) == STATUS_PRIMAL_INFEASIBLE
    assert int(sol_b.status) in (STATUS_PRIMAL_INFEASIBLE, STATUS_MAX_ITER)
    assert int(sol_b.status) != 0


def test_contractive_terminal_enforced():
    _, c = _pair(12, terminal="contractive")
    x0 = jnp.asarray([0.6, 0.6, 0.7, 0.7])
    _, sol = mpc.step(c, x0)
    assert int(sol.status) == 0
    e0 = np.asarray(sol.e_x[:, 0])
    eN = np.asarray(sol.e_x[:, -1])
    assert np.sum(eN**2) <= 0.9 * np.sum(e0**2) + 1e-5


def test_warm_start_carry_and_closed_loop():
    sys = qtp.linearized_discrete_system()
    c = mpc.design_controller(
        sys, 50, 5.0, X_REF, U_REF, engine="riccati", riccati_config=TIGHT
    )
    step = jax.jit(mpc.step)
    x = jnp.asarray([0.6] * 4)
    c, sol1 = step(c, x)
    it_cold = int(sol1.iterations)
    for _ in range(6):
        x = qtp.qtp_discrete_step(x, sol1.u[:, 0])
        c, sol1 = step(c, x)
        assert int(sol1.status) == 0
    assert int(sol1.iterations) <= it_cold
    # closing toward the reference on the true plant
    assert np.all(np.abs(np.asarray(x) - 0.65) < 0.5)


def test_riccati_batched_vmap():
    sys = qtp.linearized_discrete_system()
    c = mpc.design_controller(
        sys, 30, 5.0, X_REF, U_REF, engine="riccati", riccati_config=TIGHT
    )
    from automationlabsmodelpredictivecontrol_jl_tpu import parallel

    rng = np.random.default_rng(1)
    x0s = jnp.asarray(
        np.clip(0.65 + 0.1 * rng.standard_normal((8, 4)), 0.3, 1.2), jnp.float32
    )
    sol, wz, wy, diag = parallel.solve_batch(c, x0s)
    assert sol.u.shape == (8, 2, 30)
    assert int(diag.n_converged) == 8


def test_riccati_io_roundtrip(tmp_path):
    import os

    sys = qtp.linearized_discrete_system()
    c = mpc.design_controller(
        sys, 24, 5.0, X_REF, U_REF, engine="riccati",
        riccati_config=RiccatiConfig(max_iter=1234, rho=3.0, rho_grid=(3.0, 30.0)),
    )
    c, _ = mpc.step(c, jnp.asarray([0.6] * 4))
    p = os.path.join(tmp_path, "ric.npz")
    mpc.save_controller(p, c)
    c2 = mpc.load_controller(p)
    assert isinstance(c2.engine, mpc.RiccatiEngine)
    assert c2.engine.config == c.engine.config
    _, sa = mpc.step(c, jnp.asarray([0.61] * 4))
    _, sb = mpc.step(c2, jnp.asarray([0.61] * 4))
    np.testing.assert_array_equal(np.asarray(sa.u), np.asarray(sb.u))


def test_riccati_update_references():
    sys = qtp.linearized_discrete_system()
    c = mpc.design_controller(
        sys, 24, 5.0, X_REF, U_REF, engine="riccati", riccati_config=TIGHT
    )
    c2 = mpc.update_references(c, np.full(4, 0.8), np.full(2, 1.5))
    assert isinstance(c2.engine, mpc.RiccatiEngine)
    assert c2.engine.config == TIGHT
    _, sol = mpc.step(c2, jnp.full(4, 0.75))
    assert int(sol.status) == 0
