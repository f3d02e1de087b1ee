"""Parallel layer: vmap batching + shard_map over the 8-device CPU mesh
(SURVEY §2.10: all-new surface; no reference counterpart)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import automationlabsmodelpredictivecontrol_jl_tpu as mpc
from automationlabsmodelpredictivecontrol_jl_tpu import parallel
from automationlabsmodelpredictivecontrol_jl_tpu.benchmarks import qtp


@pytest.fixture(scope="module")
def controller():
    sys = qtp.linearized_discrete_system()
    return mpc.proceed_controller(
        sys, "model_predictive_control", 5, 5.0, np.full(4, 0.65), np.full(2, 1.2)
    )


def _x0_batch(B, seed=0):
    rng = np.random.default_rng(seed)
    return jnp.asarray(0.6 + 0.05 * rng.standard_normal((B, 4)), jnp.float32)


def test_solve_batch_matches_single(controller):
    x0s = _x0_batch(4)
    sol, wz, wy, diag = parallel.solve_batch(controller, x0s)
    assert sol.u.shape == (4, 2, 5)
    assert int(diag.n_total) == 4
    assert int(diag.n_converged) == 4
    # lane 2 equals a single solve at the same x0
    single, _, _ = mpc.solve_once(
        controller, x0s[2], controller.warm_z, controller.warm_y
    )
    np.testing.assert_allclose(
        np.asarray(sol.u[2]), np.asarray(single.u), atol=2e-4
    )


def test_solve_sharded_matches_batch(controller):
    assert jax.device_count() >= 8, "conftest must provide 8 virtual devices"
    mesh = parallel.make_mesh(8)
    x0s = _x0_batch(16)
    sol_s, _, _, diag_s = parallel.solve_sharded(controller, x0s, mesh)
    sol_b, _, _, diag_b = parallel.solve_batch(controller, x0s)
    np.testing.assert_allclose(
        np.asarray(sol_s.u), np.asarray(sol_b.u), atol=2e-4
    )
    assert int(diag_s.n_total) == 16
    assert int(diag_s.n_converged) == int(diag_b.n_converged)


def test_sharded_batch_size_check(controller):
    mesh = parallel.make_mesh(8)
    with pytest.raises(ValueError, match="divisible"):
        parallel.solve_sharded(controller, _x0_batch(10), mesh)


def test_closed_loop_batch_tracks(controller):
    x0s = _x0_batch(3, seed=1)
    xs, us, statuses = parallel.closed_loop_batch(
        controller, lambda x, u: qtp.qtp_discrete_step(x, u), x0s, n_steps=8
    )
    assert xs.shape == (9, 3, 4)
    assert us.shape == (8, 3, 2)
    # every lane moves toward the setpoint (reference tolerance atol=0.5)
    err0 = np.abs(np.asarray(xs[0]) - 0.65).max()
    errN = np.abs(np.asarray(xs[-1]) - 0.65).max()
    assert errN < max(0.5, err0)


def test_warm_start_carry_improves(controller):
    x0s = _x0_batch(4, seed=2)
    sol1, wz, wy, d1 = parallel.solve_batch(controller, x0s)
    sol2, _, _, d2 = parallel.solve_batch(controller, x0s, wz, wy)
    assert float(d2.mean_iterations) <= float(d1.mean_iterations)


@pytest.fixture(scope="module")
def riccati_controller():
    sys = qtp.linearized_discrete_system()
    return mpc.proceed_controller(
        sys, "model_predictive_control", 8, 5.0, np.full(4, 0.65),
        np.full(2, 1.2), engine="riccati",
    )


def _lean(N=5, **kw):
    from automationlabsmodelpredictivecontrol_jl_tpu.ops.admm import AdmmConfig

    return mpc.proceed_controller(
        qtp.linearized_discrete_system(), "model_predictive_control", N, 5.0,
        np.full(4, 0.65), np.full(2, 1.2),
        admm_config=AdmmConfig(rho=1.0, rho_grid=(1.0, 10.0), refine_steps=0),
        **kw,
    )


def test_fused_route_off_gpu(controller, riccati_controller):
    """Off the GPU every engine and config takes the vmapped engine, and
    solve_batch_auto keeps the solve_batch contract bit for bit."""
    for c in (controller, riccati_controller, _lean()):
        assert not parallel.fused_supported(c)
        assert not parallel.fused_supported(c, "cpu", 16384)
    x0s = _x0_batch(4, seed=3)
    sol_a, wz_a, wy_a, diag = parallel.solve_batch_auto(controller, x0s)
    sol_v, wz_v, wy_v, _ = parallel.solve_batch(controller, x0s)
    assert int(diag.n_total) == 4
    np.testing.assert_array_equal(np.asarray(sol_a.u), np.asarray(sol_v.u))
    np.testing.assert_array_equal(np.asarray(wy_a), np.asarray(wy_v))


def test_fused_route_on_gpu(controller, riccati_controller):
    """On the GPU the kernel takes only lean box-only condensed configs
    at fleet batches; wide grids, refinement, state rows, soft rows, the
    Riccati engine and small batches stay on the vmapped engine."""
    lean = _lean()
    assert parallel.fused_supported(lean, "gpu")
    assert parallel.fused_supported(lean, "gpu", parallel.scenarios.FUSED_MIN_BATCH)
    assert not parallel.fused_supported(
        lean, "gpu", parallel.scenarios.FUSED_MIN_BATCH - 1
    )
    assert not parallel.fused_supported(controller, "gpu")  # R=5, refine 1
    assert not parallel.fused_supported(riccati_controller, "gpu")
    assert not parallel.fused_supported(_lean(mpc_state_constraint=True), "gpu")
    assert not parallel.fused_supported(_lean(mpc_soft_state_constraint=10.0), "gpu")
    assert not parallel.fused_supported(_lean(N=40), "gpu")  # n=80 > 64


def test_make_mesh_raises_instead_of_cpu_fallback(monkeypatch):
    """A one-card GPU host asked for a 4-device mesh raises; it never
    builds the mesh from CPU devices."""

    class FakeGpu:
        platform = "gpu"

    monkeypatch.setattr(jax, "devices", lambda *a: [FakeGpu()])
    with pytest.raises(ValueError, match="1 gpu devices"):
        parallel.make_mesh(4)


def test_riccati_sharded_matches_batch(riccati_controller):
    mesh = parallel.make_mesh(8)
    x0s = _x0_batch(16, seed=3)
    sol_s, wz_s, wy_s, diag_s = parallel.solve_sharded(riccati_controller, x0s, mesh)
    sol_b, wz_b, wy_b, diag_b = parallel.solve_batch(riccati_controller, x0s)
    np.testing.assert_allclose(np.asarray(sol_s.u), np.asarray(sol_b.u), atol=1e-4)
    np.testing.assert_allclose(np.asarray(wz_s), np.asarray(wz_b), atol=1e-4)
    np.testing.assert_allclose(np.asarray(wy_s), np.asarray(wy_b), atol=1e-3)
    assert int(diag_s.n_total) == 16
    assert int(diag_s.n_converged) == int(diag_b.n_converged) == 16


def test_riccati_sharded_diagnostics_psum(riccati_controller):
    """The psum/pmax fleet diagnostics of the sharded Riccati solve equal
    the single-device batch diagnostics."""
    mesh = parallel.make_mesh(4)
    x0s = _x0_batch(8, seed=5)
    _, _, _, d_s = parallel.solve_sharded(riccati_controller, x0s, mesh)
    _, _, _, d_b = parallel.solve_batch(riccati_controller, x0s)
    assert int(d_s.n_total) == int(d_b.n_total) == 8
    assert int(d_s.max_iterations) == int(d_b.max_iterations)
    np.testing.assert_allclose(
        float(d_s.mean_iterations), float(d_b.mean_iterations), rtol=1e-6
    )


def test_condensed_sharded_route_matches_general(controller):
    """The sharded condensed solve on a CPU mesh takes the vmapped engine by
    default and agrees with the explicit fused=False path."""
    mesh = parallel.make_mesh(8)
    x0s = _x0_batch(16, seed=4)
    sol_a, _, _, d_a = parallel.solve_sharded(controller, x0s, mesh)
    sol_g, _, _, d_g = parallel.solve_sharded(controller, x0s, mesh, fused=False)
    np.testing.assert_array_equal(np.asarray(sol_a.u), np.asarray(sol_g.u))
    assert int(d_a.n_converged) == 16


def test_escalated_solver_closes_tail():
    """Two-tier fleet solve: a deliberately starved config leaves
    MAX_ITER stragglers; make_escalated_solver re-dispatches exactly those
    lanes to the full-rho-grid fallback and the merged batch converges
    (VERDICT r1 item 7: kill the non-converged tail)."""
    from automationlabsmodelpredictivecontrol_jl_tpu.ops.admm import AdmmConfig

    sys = qtp.linearized_discrete_system()
    starved = mpc.proceed_controller(
        sys, "model_predictive_control", 10, 5.0,
        np.full(4, 0.65), np.full(2, 1.2),
        admm_config=AdmmConfig(max_iter=30, rho=100.0, rho_grid=(100.0,)),
    )
    x0s = _x0_batch(32, seed=7)
    _, _, _, diag0 = parallel.solve_batch_auto(starved, x0s)
    assert int(diag0.n_max_iter) > 0, "config must actually starve some lanes"

    esc = parallel.make_escalated_solver(starved)
    sol, wz, wy, diag = esc(x0s)
    assert int(diag.n_converged) == 32
    assert int(diag.n_max_iter) == 0
    # escalated lanes agree with a full fallback-controller solve
    fb = parallel.escalation_controller(starved)
    sol_fb, _, _, _ = parallel.solve_batch(fb, x0s)
    np.testing.assert_allclose(np.asarray(sol.u), np.asarray(sol_fb.u), atol=5e-4)


def test_escalated_solver_noop_when_converged(controller):
    """No stragglers -> the fast-pass result is returned unchanged."""
    x0s = _x0_batch(8, seed=8)
    esc = parallel.make_escalated_solver(controller)
    sol, _, _, diag = esc(x0s)
    sol_f, _, _, diag_f = parallel.solve_batch_auto(controller, x0s)
    # (atol: the solver's own jit and the test's separately-jitted call can
    # fuse differently at f32)
    np.testing.assert_allclose(np.asarray(sol.u), np.asarray(sol_f.u), atol=1e-5)
    assert int(diag.n_converged) == int(diag_f.n_converged) == 8


def test_roofline_model_sanity(controller):
    """Roofline accounting: analytic flops/bytes model is positive, padded
    >= useful, and sol_fraction scales inversely with measured time."""
    from automationlabsmodelpredictivecontrol_jl_tpu.utils import roofline

    class H100:
        device_kind = "NVIDIA H100 80GB HBM3"

    op = controller.engine.op
    cfg = controller.engine.config
    n, m, R = int(op.K_invs.shape[1]), int(op.A_s.shape[0]), int(op.rho_grid.shape[0])
    for fused in (False, True):
        it = roofline.admm_iteration_model(n, m, R, 256, fused=fused)
        assert it["executed_flops"] >= it["useful_flops"] > 0
    r1 = roofline.speed_of_light(op, cfg, 256, 50.0, 0.1, device=H100())
    r2 = roofline.speed_of_light(op, cfg, 256, 50.0, 0.2, device=H100())
    assert r1["sol_fraction"] == pytest.approx(2 * r2["sol_fraction"])
    assert r1["bound"] in ("compute", "memory")
    assert r1["mfu"] > 0


def test_escalated_native_tier():
    """Tier 3: when even the fallback engine stalls, stragglers cross to
    the host f64 native oracle and come back converged."""
    from automationlabsmodelpredictivecontrol_jl_tpu.ops.admm import AdmmConfig

    sys = qtp.linearized_discrete_system()
    starved = mpc.proceed_controller(
        sys, "model_predictive_control", 10, 5.0,
        np.full(4, 0.65), np.full(2, 1.2),
        admm_config=AdmmConfig(max_iter=30, rho=100.0, rho_grid=(100.0,)),
    )
    x0s = _x0_batch(16, seed=9)
    # fallback == the starved controller itself: tier 2 cannot converge, so
    # every straggler must ride the native tier
    esc = parallel.make_escalated_solver(starved, fallback=starved)
    sol, wz, wy, diag = esc(x0s)
    assert int(diag.n_converged) == 16
    # native-tier lanes agree with the full-grid jax engine
    fb = parallel.escalation_controller(starved)
    sol_fb, _, _, _ = parallel.solve_batch(fb, x0s)
    np.testing.assert_allclose(np.asarray(sol.u), np.asarray(sol_fb.u), atol=1e-3)
