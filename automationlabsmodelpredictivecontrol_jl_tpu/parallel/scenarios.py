"""Batched + sharded scenario solves: the framework's parallelism layer.

The reference has *no* parallelism of any kind (SURVEY.md §2.10 — zero hits
for Threads/Distributed/CUDA/MPI; it solves one optimization at a time).
This module is the batched surface defined by BASELINE.json:

- **scenario batching** (the data-parallel axis): ``vmap`` over thousands of
  initial conditions per device — the ADMM iteration body becomes batched
  GEMMs; box-only condensed QPs can instead run the fused chunk kernel
  (ops/admm_pallas.py) on the GPU.
- **multi-device sharding**: ``shard_map`` over a ``jax.sharding.Mesh``,
  scenario axis sharded across chips; the controller (QP operators) is
  replicated — it is the same controller solving many initial states.
- **collective aggregation**: ``psum``/``pmax`` over the mesh (NCCL on the
  GPU) — fleet-level convergence counts,
  worst-case residuals and iteration histograms come back replicated so the
  host reads one small struct regardless of pod size.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..design import MpcController
from ..runtime import solve_once
from ..types import STATUS_CONVERGED, MpcSolution
from ..utils.pytrees import pytree_dataclass

Array = Any

SCENARIO_AXIS = "scenario"


@pytree_dataclass
class BatchDiagnostics:
    """Fleet-level solve diagnostics (aggregated with psum/pmax over the
    mesh): the observability surface the reference lacks (SURVEY §5)."""

    n_total: Array  # ()
    n_converged: Array  # ()
    n_max_iter: Array  # ()
    n_infeasible: Array  # ()
    max_primal_residual: Array  # ()
    max_dual_residual: Array  # ()
    mean_iterations: Array  # ()
    max_iterations: Array  # ()


def _diagnostics(sol: MpcSolution) -> BatchDiagnostics:
    status = sol.status
    n = status.shape[0]
    return BatchDiagnostics(
        n_total=jnp.asarray(n, jnp.int32),
        n_converged=jnp.sum(status == STATUS_CONVERGED).astype(jnp.int32),
        n_max_iter=jnp.sum(status == 1).astype(jnp.int32),
        n_infeasible=jnp.sum(status >= 2).astype(jnp.int32),
        max_primal_residual=jnp.max(sol.primal_residual),
        max_dual_residual=jnp.max(sol.dual_residual),
        mean_iterations=jnp.mean(sol.iterations.astype(jnp.float32)),
        max_iterations=jnp.max(sol.iterations).astype(jnp.int32),
    )


def _psum_diagnostics(d: BatchDiagnostics, axis: str) -> BatchDiagnostics:
    total = jax.lax.psum(d.n_total, axis)
    return BatchDiagnostics(
        n_total=total,
        n_converged=jax.lax.psum(d.n_converged, axis),
        n_max_iter=jax.lax.psum(d.n_max_iter, axis),
        n_infeasible=jax.lax.psum(d.n_infeasible, axis),
        max_primal_residual=jax.lax.pmax(d.max_primal_residual, axis),
        max_dual_residual=jax.lax.pmax(d.max_dual_residual, axis),
        mean_iterations=jax.lax.psum(
            d.mean_iterations * d.n_total.astype(jnp.float32), axis
        )
        / total.astype(jnp.float32),
        max_iterations=jax.lax.pmax(d.max_iterations, axis),
    )


def init_warm_batch(controller: MpcController, batch: int) -> Tuple[Array, Array]:
    """Broadcast the controller's warm state over a scenario batch."""
    wz = jnp.broadcast_to(controller.warm_z, (batch,) + controller.warm_z.shape)
    wy = jnp.broadcast_to(controller.warm_y, (batch,) + controller.warm_y.shape)
    return wz, wy


def solve_batch(
    controller: MpcController,
    x0s: Array,  # (B, nx)
    warm_z: Optional[Array] = None,  # (B, n) or None
    warm_y: Optional[Array] = None,  # (B, m) or None
) -> Tuple[MpcSolution, Array, Array, BatchDiagnostics]:
    """vmap-batched scenario solves on one device.

    Returns (solutions with leading batch axis, next warm_z, next warm_y,
    diagnostics). jit-compatible for every engine EXCEPT MilpEngine, whose
    exact-ReLU branch-and-bound runs on the host (threaded native calls) and
    therefore cannot appear under jit / inside lax.scan.
    """
    from ..solvers.milp import MilpEngine

    B = x0s.shape[0]
    if warm_z is None or warm_y is None:
        warm_z, warm_y = init_warm_batch(controller, B)

    if isinstance(controller.engine, MilpEngine):
        # host fleet path: the exact-ReLU B&B runs B lanes in parallel OS
        # threads (native calls release the GIL; solvers/milp.py). Same
        # 4-tuple contract; the MILP engine carries no warm state.
        if isinstance(x0s, jax.core.Tracer):
            raise TypeError(
                "solve_batch with a MILP engine is host-only (the exact-ReLU "
                "branch-and-bound runs native host code): call it outside "
                "jit / lax.scan, e.g. not via closed_loop_batch"
            )
        from ..solvers.milp import solve_milp_batch

        sol = solve_milp_batch(controller.engine, controller.tuning, x0s)
        return sol, warm_z, warm_y, _diagnostics(sol)

    sol, wz, wy = jax.vmap(
        lambda x0, z, y: solve_once(controller, x0, z, y)
    )(x0s, warm_z, warm_y)
    return sol, wz, wy, _diagnostics(sol)


def solve_batch_fused(
    controller: MpcController,
    x0s: Array,  # (B, nx)
    warm_z: Optional[Array] = None,
    warm_y: Optional[Array] = None,
    interpret: bool = False,
) -> Tuple[MpcSolution, Array, Array, BatchDiagnostics]:
    """Batched linear-MPC solves on the fused box-QP chunk kernel
    (ops/admm_pallas.py, Pallas through Triton on the GPU).

    Same results/diagnostics contract as :func:`solve_batch`. Takes only a
    condensed LinearEngine whose operator is box-only (diagonal A, no ball
    or soft rows); anything else raises ``ValueError`` — use
    :func:`solve_batch`. ``interpret=True`` runs the kernel in the Pallas
    interpreter (CPU tests).
    """
    from ..design import LinearEngine
    from ..ops import admm_pallas
    from ..ops.condense import runtime_qp_vectors_batch
    from ..solvers.sqp import true_objective

    engine = controller.engine
    if (
        not isinstance(engine, LinearEngine)
        or engine.soft_mu is not None
        or not engine.op.diag_a
    ):
        raise ValueError(
            "the fused kernel takes only condensed box-only QPs (diagonal A, "
            "no soft or ball rows); use solve_batch"
        )
    B = x0s.shape[0]
    if warm_z is None or warm_y is None:
        warm_z, warm_y = init_warm_batch(controller, B)

    qp = engine.qp
    tuning = controller.tuning
    refs = tuning.references
    e0s = x0s - refs.x[:, 0][None]
    qv, lv, uv, _, _ = runtime_qp_vectors_batch(qp, e0s)

    z, y, _, status, iters, rp, rd = admm_pallas.solve_batch_fused(
        engine.op, qv, lv, uv, warm_z, warm_y,
        config=engine.config, interpret=interpret,
    )

    N, nx, nu = qp.N, qp.nx, qp.nu
    H = jax.lax.Precision.HIGHEST
    ex_tail = (
        jnp.einsum("kn,bn->bk", qp.G_flat, z, precision=H)
        + jnp.einsum("kn,bn->bk", qp.F.reshape(N * nx, nx), e0s, precision=H)
    ).reshape(B, N, nx)
    ex = jnp.concatenate([e0s[:, None], ex_tail], axis=1)  # (B, N+1, nx)
    eu = z.reshape(B, N, nu)
    xs = ex + refs.x.T[None]
    us = eu + refs.u.T[None]
    obj = jax.vmap(lambda xi, ui: true_objective(tuning, xi, ui))(xs, us)

    sol = MpcSolution(
        x=xs.transpose(0, 2, 1),
        e_x=ex.transpose(0, 2, 1),
        u=us.transpose(0, 2, 1),
        e_u=eu.transpose(0, 2, 1),
        status=status,
        iterations=iters,
        primal_residual=rp,
        dual_residual=rd,
        objective=obj,
    )
    wz_next = jnp.concatenate([eu[:, 1:], eu[:, -1:]], axis=1).reshape(B, -1)
    return sol, wz_next, y, _diagnostics(sol)


def make_mesh(n_devices: Optional[int] = None, axis: str = SCENARIO_AXIS) -> Mesh:
    """1-D device mesh over the scenario axis.

    Takes the default backend's devices. When the default backend is the
    CPU (tests, dry runs) the virtual host devices of
    ``--xla_force_host_platform_device_count`` count; on an accelerator with
    fewer devices than requested it raises — never a CPU mesh in place of
    the device, never a silently smaller mesh.
    """
    devs = jax.devices()
    n = n_devices or len(devs)
    if len(devs) < n:
        raise ValueError(
            f"requested a {n}-device mesh but only {len(devs)} "
            f"{devs[0].platform} devices are available"
        )
    return Mesh(np.asarray(devs[:n]), (axis,))


# smallest batch (lanes per device) routed to the fused kernel: the
# smallest at which it was measured to win the lean headline config on an
# H100 (PERF.md: 1,024, 4,096 and 16,384 lanes)
FUSED_MIN_BATCH = 1024


def fused_supported(
    controller: MpcController,
    platform: Optional[str] = None,
    batch: Optional[int] = None,
) -> bool:
    """True when the controller's batch solves default to the fused
    box-QP chunk kernel on ``platform`` (default: the default backend) for
    ``batch`` lanes per device (``None``: any batch).

    The kernel compiles only for the GPU (``utils.devices.kernel_route``)
    and takes only condensed box-only QPs: diagonal A, no ball or soft
    rows. Measured on an H100 (PERF.md), it wins only the lean configs —
    a rho grid of at most 2 entries, no refinement, n <= 64 — at fleet
    batches; with 4 grid entries and 2 refinement steps it lost 4x to the
    vmapped engine. Everything else — state rows, terminal sets, wider
    grids, the Riccati, SQP and economic engines, small batches and every
    platform but the GPU — runs the vmapped XLA engine."""
    from ..design import LinearEngine
    from ..utils.devices import kernel_route

    eng = controller.engine
    return (
        kernel_route(platform) == "triton"
        and isinstance(eng, LinearEngine)
        and eng.soft_mu is None
        and eng.op.n_ball == 0
        and bool(eng.op.diag_a)
        and int(eng.config.refine_steps) == 0
        and int(eng.op.rho_grid.shape[0]) <= 2
        and int(eng.op.A_s.shape[1]) <= 64
        and (batch is None or batch >= FUSED_MIN_BATCH)
    )


def solve_batch_auto(
    controller: MpcController,
    x0s: Array,
    warm_z: Optional[Array] = None,
    warm_y: Optional[Array] = None,
) -> Tuple[MpcSolution, Array, Array, BatchDiagnostics]:
    """Batch solve on the route :func:`fused_supported` picks for this
    controller, platform and batch: the fused kernel or the vmapped XLA
    engine. Same contract as :func:`solve_batch`."""
    if fused_supported(controller, batch=x0s.shape[0]):
        return solve_batch_fused(controller, x0s, warm_z, warm_y)
    return solve_batch(controller, x0s, warm_z, warm_y)


def solve_sharded(
    controller: MpcController,
    x0s: Array,  # (B, nx), B divisible by mesh size
    mesh: Optional[Mesh] = None,
    warm_z: Optional[Array] = None,
    warm_y: Optional[Array] = None,
    fused: Optional[bool] = None,
) -> Tuple[MpcSolution, Array, Array, BatchDiagnostics]:
    """Scenario-sharded batch solve over a device mesh.

    The controller is replicated; x0/warm/solution pytrees are sharded on
    the leading scenario axis; diagnostics are psum-aggregated over the
    mesh so every shard (and the host) sees fleet-level numbers.

    ``fused`` routes each shard's local batch through the fused kernel
    instead of the vmapped engine. Default: :func:`fused_supported` for the
    MESH's platform (a virtual CPU mesh runs the vmapped engine even where
    the process also sees a GPU).
    """
    mesh = mesh or make_mesh()
    axis = mesh.axis_names[0]
    B = x0s.shape[0]
    n_dev = mesh.devices.size
    if B % n_dev:
        raise ValueError(f"batch {B} not divisible by mesh size {n_dev}")
    if warm_z is None or warm_y is None:
        warm_z, warm_y = init_warm_batch(controller, B)
    if fused is None:
        fused = fused_supported(
            controller, mesh.devices.flat[0].platform, B // n_dev
        )

    def shard_body(ctrl, x0_l, wz_l, wy_l):
        if fused:
            sol, wz, wy, diag_l = solve_batch_fused(ctrl, x0_l, wz_l, wy_l)
        else:
            sol, wz, wy = jax.vmap(
                lambda x0, z, y: solve_once(ctrl, x0, z, y)
            )(x0_l, wz_l, wy_l)
            diag_l = _diagnostics(sol)
        diag = _psum_diagnostics(diag_l, axis)
        return sol, wz, wy, diag

    shard = P(axis)
    rep = P()
    f = jax.shard_map(
        shard_body,
        mesh=mesh,
        in_specs=(rep, shard, shard, shard),
        out_specs=(shard, shard, shard, rep),
        # pallas_call outputs carry no varying-mesh-axis metadata; skip the
        # static replication check (the psum-aggregated diag is still
        # replicated by construction)
        check_vma=False,
    )
    return f(controller, x0s, warm_z, warm_y)


def escalation_controller(
    controller: MpcController,
    rho_grid: Tuple[float, ...] = (0.01, 0.1, 1.0, 10.0, 100.0),
    max_iter: int = 4000,
    refine_steps: int = 2,
) -> MpcController:
    """Fallback controller for straggler re-dispatch: same condensed QP,
    full prefactorized rho grid + a deep iteration budget + 2 iterative-
    refinement steps on the K-solve (without refinement, hard lanes hit an
    f32 dual-residual floor above eps). Built once; the escalated solver
    sends only the (few) non-converged lanes here."""
    import dataclasses

    from ..design import LinearEngine
    from ..ops import admm as admm_ops

    eng = controller.engine
    if not isinstance(eng, LinearEngine):
        return controller
    cfg = dataclasses.replace(
        eng.config, rho_grid=tuple(rho_grid), max_iter=int(max_iter),
        adaptive=True, refine_steps=int(refine_steps),
    )
    l_np = np.asarray(eng.qp.l_const)
    u_np = np.asarray(eng.qp.u_const)
    eq_mask = np.isfinite(l_np) & np.isfinite(u_np) & (l_np == u_np)
    op = admm_ops.build_operator(
        eng.qp.P, eng.qp.A, eq_mask, eng.qp.n_ball, cfg
    )
    return controller.replace(
        engine=LinearEngine(qp=eng.qp, op=op, soft_mu=eng.soft_mu, config=cfg)
    )


def _native_lane_solve(controller: MpcController, x0, wz_lane, wy_lane):
    """Tier-3 straggler solve: host f64 via the native C++ oracle
    (native/qpref). Returns numpy pieces for one lane of the batch solution
    (condensed LinearEngine only)."""
    from .. import native_qp
    from ..solvers.sqp import true_objective

    eng = controller.engine
    qp = eng.qp
    refs = controller.tuning.references
    N, nx, nu = qp.N, qp.nx, qp.nu
    e0 = np.asarray(x0, np.float64) - np.asarray(refs.x[:, 0], np.float64)
    q = np.asarray(qp.q_const, np.float64) + np.asarray(qp.q_x0, np.float64) @ e0
    shift = np.asarray(qp.b_x0, np.float64) @ e0
    l = np.asarray(qp.l_const, np.float64) + shift
    u = np.asarray(qp.u_const, np.float64) + shift
    z, y, status, iters, rp, rd = native_qp.solve_qp(
        np.asarray(qp.P, np.float64), q, np.asarray(qp.A, np.float64), l, u,
        z0=np.asarray(wz_lane, np.float64), y0=np.asarray(wy_lane, np.float64),
        eps_abs=1e-7, eps_rel=1e-7,
    )
    eu = z.reshape(N, nu)
    ex_tail = (
        np.asarray(qp.G_flat, np.float64) @ z
        + np.asarray(qp.F, np.float64).reshape(N * nx, nx) @ e0
    ).reshape(N, nx)
    ex = np.concatenate([e0[None], ex_tail], axis=0)  # (N+1, nx)
    xs = ex + np.asarray(refs.x, np.float64).T
    us = eu + np.asarray(refs.u, np.float64).T
    obj = float(
        true_objective(
            controller.tuning,
            jnp.asarray(xs, jnp.float32),
            jnp.asarray(us, jnp.float32),
        )
    )
    wz_next = np.concatenate([eu[1:], eu[-1:]], axis=0).reshape(-1)
    lane_sol = dict(
        x=xs.T, e_x=ex.T, u=us.T, e_u=eu.T, status=status,
        iterations=iters, primal_residual=rp, dual_residual=rd, objective=obj,
    )
    return lane_sol, wz_next.astype(np.float32), y.astype(np.float32)


def solve_batch_escalated(
    controller: MpcController,
    fallback: MpcController,
    x0s: Array,  # (B, nx)
    warm_z: Array,
    warm_y: Array,
    bucket: int = 256,
) -> Tuple[MpcSolution, Array, Array, BatchDiagnostics]:
    """Two-tier batch solve in ONE jitted program (no host round-trips).

    Tier 1 runs the controller's fast fused config; the straggler lanes
    (STATUS_MAX_ITER / STATUS_NUMERIC_ERROR) are gathered ON DEVICE into a
    static ``bucket`` and re-solved on the fallback controller's full-grid
    operator, *continuing from the tier-1 iterate* (sol.e_u is the unshifted
    primal z, the returned wy the raw dual y). Results scatter back only
    over lanes that were actually unconverged.

    Static bucket = compiler-friendly escalation: no host round trip for a
    gather/merge between the tiers. Each tier takes its own route
    (:func:`solve_batch_auto`).
    Lanes beyond the bucket (pathological distributions) stay MAX_ITER and
    are closed by the host tier of :func:`make_escalated_solver`.
    """
    from ..design import LinearEngine

    B = x0s.shape[0]
    bucket = min(bucket, B)
    sol, wz, wy, _ = solve_batch_auto(controller, x0s, warm_z, warm_y)

    bad = (sol.status == 1) | (sol.status == 4)
    # stable partition: unconverged lanes first (False sorts before True)
    gidx = jnp.argsort(~bad)[:bucket]
    bad_g = bad[gidx][:, None]

    if isinstance(controller.engine, LinearEngine):
        z_it = sol.e_u.transpose(0, 2, 1).reshape(B, -1)[gidx]
        y_it = wy[gidx]
        ok = (
            jnp.all(jnp.isfinite(z_it), axis=1)
            & jnp.all(jnp.isfinite(y_it), axis=1)
        )[:, None]
        z0 = jnp.where(ok, z_it, warm_z[gidx])
        y0 = jnp.where(ok, y_it, warm_y[gidx])
    else:
        # Riccati warms are shifted receding-horizon carries, not iterates:
        # tier 2 restarts those lanes from the original warm pair
        z0, y0 = warm_z[gidx], warm_y[gidx]

    sol2, wz2, wy2, _ = solve_batch_auto(fallback, x0s[gidx], z0, y0)
    # tier-2 iteration counts continue tier 1's
    sol2 = sol2.replace(iterations=sol2.iterations + sol.iterations[gidx])

    def merge(old, new):
        flag = bad_g.reshape((bucket,) + (1,) * (new.ndim - 1))
        return old.at[gidx].set(jnp.where(flag, new, old[gidx]))

    sol_m = jax.tree_util.tree_map(merge, sol, sol2)
    wz_m = merge(wz, wz2)
    wy_m = merge(wy, wy2)
    return sol_m, wz_m, wy_m, _diagnostics(sol_m)


def make_escalated_solver(
    controller: MpcController,
    fallback: Optional[MpcController] = None,
    min_bucket: int = 256,
    native_tier: bool = True,
):
    """Tiered batch solver — the production-serving pattern that closes the
    convergence tail without paying the full rho grid on every lane:

    1. the controller's (narrow, calibrated) config on its batch route
       (:func:`solve_batch_auto`);
    2. stragglers (STATUS_MAX_ITER / STATUS_NUMERIC_ERROR) gathered ON
       DEVICE to a static ``min_bucket`` and re-solved with the full
       prefactorized rho grid + deep iteration budget,
       continuing from the tier-1 iterate (tiers 1+2 are one jitted
       program — no host round-trip);
    3. anything still unconverged (typically 0-2 lanes per 16k) crosses to
       the host f64 native oracle (native/qpref) — the same boundary hop
       the reference pays on *every* solve (SURVEY §3.2).

    Returns ``solve(x0s, warm_z=None, warm_y=None) -> (sol, wz, wy, diag)``.
    Host-driven only at the tier-3 boundary: tiers 1+2 run as the single
    jitted program :func:`solve_batch_escalated` (on-device straggler
    gather, no host round-trip between tiers). Infeasibility certificates
    (status 2/3) are never re-dispatched."""
    from ..design import LinearEngine

    fb = fallback if fallback is not None else escalation_controller(controller)
    native_ok = native_tier and isinstance(controller.engine, LinearEngine)
    two_tier = jax.jit(
        lambda x, z, y: solve_batch_escalated(
            controller, fb, x, z, y, bucket=min_bucket
        )
    )

    def _redispatch_idx(status: np.ndarray) -> np.ndarray:
        return np.nonzero((status == 1) | (status == 4))[0]

    def solve(x0s, warm_z=None, warm_y=None):
        B = x0s.shape[0]
        if warm_z is None or warm_y is None:
            warm_z, warm_y = init_warm_batch(controller, B)
        sol, wz, wy, diag = two_tier(x0s, warm_z, warm_y)

        # tier 3: host f64 oracle for the last few lanes (or, pathological
        # case, a straggler population that overflowed the static bucket)
        idx3 = _redispatch_idx(np.asarray(sol.status)) if native_ok else ()
        if len(idx3) == 0:
            return sol, wz, wy, diag

        # gather ONLY the straggler lanes on device (one small transfer
        # instead of the full batch iterate), continuing from the merged
        # tier-2 iterate
        # (sol.e_u = primal z, wy = raw dual for the condensed engine) with
        # a fall back to the original warm pair for non-finite lanes
        li = jnp.asarray(idx3)
        x0_g, z_g, y_g = jax.device_get(
            _gather_tier3(sol, wy, x0s, warm_z, warm_y, li)
        )
        lanes, wz3, wy3 = [], [], []
        for k in range(len(idx3)):
            lane, wzl, wyl = _native_lane_solve(
                controller, x0_g[k], z_g[k], y_g[k]
            )
            lanes.append(lane)
            wz3.append(wzl)
            wy3.append(wyl)

        def stack(key, dt=jnp.float32):
            return jnp.asarray(
                np.stack([ln[key] for ln in lanes]).astype(np.float64), dt
            )

        patch = MpcSolution(
            x=stack("x"),
            e_x=stack("e_x"),
            u=stack("u"),
            e_u=stack("e_u"),
            status=jnp.asarray([ln["status"] for ln in lanes], jnp.int32),
            iterations=jnp.asarray(
                [ln["iterations"] for ln in lanes], jnp.int32
            ),
            primal_residual=stack("primal_residual"),
            dual_residual=stack("dual_residual"),
            objective=stack("objective"),
        )
        # ONE jitted scatter program for the whole patch instead of one
        # eager dispatch per field
        sol, wz, wy, diag = _scatter_native_patch(
            sol, wz, wy, li, patch,
            jnp.asarray(np.stack(wz3)), jnp.asarray(np.stack(wy3)),
        )
        return sol, wz, wy, diag

    return solve


@jax.jit
def _gather_tier3(sol, wy, x0s, warm_z, warm_y, li):
    B = x0s.shape[0]
    z_it = sol.e_u.transpose(0, 2, 1).reshape(B, -1)[li]
    y_it = wy[li]
    ok = (
        jnp.all(jnp.isfinite(z_it), axis=1) & jnp.all(jnp.isfinite(y_it), axis=1)
    )[:, None]
    return (
        x0s[li],
        jnp.where(ok, z_it, warm_z[li]),
        jnp.where(ok, y_it, warm_y[li]),
    )


@jax.jit
def _scatter_native_patch(sol, wz, wy, li, patch, wz3, wy3):
    sol_m = jax.tree_util.tree_map(
        lambda f, p: f.at[li].set(p), sol, patch
    )
    return sol_m, wz.at[li].set(wz3), wy.at[li].set(wy3), _diagnostics(sol_m)


def closed_loop_batch(
    controller: MpcController,
    plant_step,  # (x, u) -> x_next; the true plant
    x0s: Array,  # (B, nx)
    n_steps: int,
) -> Tuple[Array, Array, Array]:
    """Batched receding-horizon closed-loop simulation via lax.scan.

    Returns (states (n_steps+1, B, nx), inputs (n_steps, B, nu),
    statuses (n_steps, B)). The per-step warm-start carry is the designed
    feature the reference only got implicitly from OSQP internals (SURVEY §5).
    """
    B = x0s.shape[0]
    wz0, wy0 = init_warm_batch(controller, B)

    def step_fn(carry, _):
        x, wz, wy = carry
        sol, wz_n, wy_n, _ = solve_batch_auto(controller, x, wz, wy)
        u0 = sol.u[:, :, 0]
        x_next = jax.vmap(plant_step)(x, u0)
        return (x_next, wz_n, wy_n), (x_next, u0, sol.status)

    (_, _, _), (xs, us, statuses) = jax.lax.scan(
        step_fn, (x0s, wz0, wy0), None, length=n_steps
    )
    xs = jnp.concatenate([x0s[None], xs], axis=0)
    return xs, us, statuses
