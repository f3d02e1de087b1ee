"""Smoke run of the batched MPC main path on one GPU.

    python chip_smoke.py                # phases (a)-(e) on one card
    python chip_smoke.py --four-cards   # the sharded fleet on four cards
    python chip_smoke.py --time-kernel  # fused kernel vs XLA engine timing

Phases, all through the user-facing entry points on the QTP plant
(benchmarks/qtp.py, 4 states / 2 inputs):

  (a) single   one controller, one measured state: jax.jit(mpc.step), h20
  (b) fleet    parallel.solve_batch_escalated at B=16,384, h20 (tiers 1+2),
               then the host f64 tier of make_escalated_solver
  (c) loop     parallel.closed_loop_batch, B=4,096, 50 steps, true plant
  (d) riccati  engine="riccati" at h200, B=1,024, via solve_batch_auto
  (e) sqp      SQP over a trained fnn model, h10, B=256

Each phase prints one JSON line with its numbers and checks; times are
wall times ended by block_until_ready, informational only. The last line
is ``{"ok": true, "device": {...}}`` only when every phase and comparison
passed; otherwise the script exits non-zero. Without a GPU it exits
non-zero before any phase runs. The phase functions take their sizes as
arguments, so the CPU tests drive them at tiny sizes.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import traceback

import numpy as np

X_REF = np.full(4, 0.65, np.float32)
U_REF = np.full(2, 1.2, np.float32)
TOL_U = 1e-4  # the repo's parity bar (tests/golden/)


def _timed(fn, reps: int = 1):
    """(seconds per call, last output) of ``reps`` calls after one warm
    call, ended by block_until_ready."""
    import jax

    out = jax.block_until_ready(fn())
    t0 = time.perf_counter()
    for _ in range(reps):
        out = jax.block_until_ready(fn())
    return (time.perf_counter() - t0) / reps, out


def _compile(fn, *args):
    """(seconds, compiled) of lowering + compiling ``jax.jit(fn)``."""
    import jax

    t0 = time.perf_counter()
    compiled = jax.jit(fn).lower(*args).compile()
    return time.perf_counter() - t0, compiled


def _x0s(batch: int, seed: int, spread: float = 0.15):
    rng = np.random.default_rng(seed)
    return np.clip(X_REF + spread * rng.standard_normal((batch, 4)), 0.25, 1.3).astype(
        np.float32
    )


def _controller(horizon: int, **kw):
    import automationlabsmodelpredictivecontrol_jl_tpu as mpc
    from automationlabsmodelpredictivecontrol_jl_tpu.benchmarks import qtp

    return mpc.proceed_controller(
        qtp.linearized_discrete_system(), "model_predictive_control", horizon,
        qtp.SAMPLE_TIME, X_REF, U_REF, **kw,
    )


def headline_controllers(horizon: int = 20, tier1_cap: int = 75,
                         tier2_cap: int = 250):
    """(tier-1 controller, tier-2 fallback) of the headline fleet (bench.py):
    tier 1 a 2-entry rho grid, no refinement, capped at 75 iterations;
    tier 2 four grid entries, 2 refinement steps, 250 iterations."""
    from automationlabsmodelpredictivecontrol_jl_tpu import parallel
    from automationlabsmodelpredictivecontrol_jl_tpu.ops.admm import AdmmConfig

    cfg = AdmmConfig(max_iter=tier1_cap, rho=1.0, rho_grid=(1.0, 10.0),
                     refine_steps=0)
    c = _controller(horizon, admm_config=cfg)
    fb = parallel.escalation_controller(
        c, rho_grid=(0.1, 1.0, 10.0, 100.0), max_iter=tier2_cap, refine_steps=2
    )
    return c, fb


def compare_solutions(sol_a, sol_b) -> dict:
    """Fused kernel (``sol_a``) vs plain engine (``sol_b``): on lanes both
    converged, the largest input and objective differences; infeasibility
    and numeric-error statuses must match exactly, and the kernel must
    certify at least 99% as many lanes as the engine. Status agreement is
    reported: lanes open at the iteration cap, and the few in an f32 limit
    cycle just above the 1e-6 certificate, flip status with the rounding
    of either implementation."""
    st_a, st_b = np.asarray(sol_a.status), np.asarray(sol_b.status)
    both = (st_a == 0) & (st_b == 0)
    du = np.abs(np.asarray(sol_a.u) - np.asarray(sol_b.u))[both]
    oa, ob = np.asarray(sol_a.objective)[both], np.asarray(sol_b.objective)[both]
    dobj = np.abs(oa - ob) / (1.0 + np.abs(ob))
    max_du = float(du.max()) if du.size else 0.0
    max_dobj = float(dobj.max()) if dobj.size else 0.0
    conv_a, conv_b = int(np.sum(st_a == 0)), int(np.sum(st_b == 0))
    hard_equal = bool(np.all((st_a >= 2) == (st_b >= 2)))
    return {
        "status_agree": float(np.mean(st_a == st_b)),
        "converged": [conv_a, conv_b],
        "both_converged": int(both.sum()),
        "max_du": max_du,
        "max_dobj_rel": max_dobj,
        "ok": bool(conv_a >= 0.99 * conv_b and hard_equal and both.any()
                   and max_du <= TOL_U and max_dobj <= TOL_U),
    }


def phase_single(horizon: int = 20, n_steps: int = 12) -> dict:
    """(a) One controller, one measured state, jax.jit(mpc.step) on the
    true nonlinear plant (the reference's deployment)."""
    import jax
    import jax.numpy as jnp

    import automationlabsmodelpredictivecontrol_jl_tpu as mpc
    from automationlabsmodelpredictivecontrol_jl_tpu.benchmarks import qtp

    t0 = time.perf_counter()
    ctrl = _controller(horizon)
    design_s = time.perf_counter() - t0
    x = jnp.asarray([0.6] * 4, jnp.float32)
    step = jax.jit(mpc.step)
    times, statuses = [], []
    err0 = float(jnp.max(jnp.abs(x - X_REF)))
    for _ in range(n_steps):
        t0 = time.perf_counter()
        ctrl, sol = jax.block_until_ready(step(ctrl, x))
        times.append(time.perf_counter() - t0)
        statuses.append(int(sol.status))
        x = qtp.qtp_discrete_step(x, sol.u[:, 0])
    # the first two calls compile (the controller carries no solution yet on
    # the first)
    compile_s = sum(times[:2])
    times = times[2:] or times
    errN = float(jnp.max(jnp.abs(x - X_REF)))
    conv = float(np.mean(np.asarray(statuses) == 0))
    return {
        "design_s": design_s,
        "compile_s": compile_s,
        "step_p50_ms": float(np.percentile(times, 50)) * 1e3,
        "converged_fraction": conv,
        "state_err_first": err0,
        "state_err_last": errN,
        "ok": bool(conv == 1.0 and errN < err0),
    }


def oracle_max_du(controller, x0s, z, status) -> dict:
    """Largest |Δz| between the device solution and the independent f64
    oracle (native/qpref) on lanes the device certified."""
    from automationlabsmodelpredictivecontrol_jl_tpu import native_qp

    qp = controller.engine.qp
    f64 = lambda a: np.asarray(a, np.float64)
    e0 = f64(x0s) - f64(controller.tuning.references.x[:, 0])[None]
    shift = e0 @ f64(qp.b_x0).T
    zo, _, st_o, _ = native_qp.solve_qp_batch(
        f64(qp.P), f64(qp.q_const)[None] + e0 @ f64(qp.q_x0).T, f64(qp.A),
        f64(qp.l_const)[None] + shift, f64(qp.u_const)[None] + shift,
    )
    ok = (np.asarray(status) == 0) & (st_o == 0)
    du = np.abs(np.asarray(z, np.float64) - zo)[ok]
    return {
        "oracle_lanes": int(ok.sum()),
        "oracle_max_du": float(du.max()) if du.size else float("nan"),
    }


def phase_fleet(batch: int = 16384, bucket: int = 512, horizon: int = 20,
                n_oracle: int = 256, reps: int = 3, seed: int = 0) -> dict:
    """(b) The headline fleet: tiers 1+2 as one jitted program, then the
    host f64 tier; the device solution is checked against the f64 oracle
    on ``n_oracle`` lanes."""
    import jax
    import jax.numpy as jnp

    from automationlabsmodelpredictivecontrol_jl_tpu import native_qp, parallel

    t0 = time.perf_counter()
    native_qp._load()  # set-up: builds native/qpref/libqpref.so on first use
    oracle_build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    c, fb = headline_controllers(horizon)
    design_s = time.perf_counter() - t0
    x0s = jnp.asarray(_x0s(batch, seed))
    wz, wy = parallel.init_warm_batch(c, batch)
    fn = lambda x, z, y: parallel.solve_batch_escalated(c, fb, x, z, y, bucket=bucket)
    compile_s, two_tier = _compile(fn, x0s, wz, wy)
    mem = two_tier.memory_analysis()
    dt, (sol, _, _, diag) = _timed(lambda: two_tier(x0s, wz, wy), reps)
    conv = int(diag.n_converged) / batch

    esc = parallel.make_escalated_solver(c, fallback=fb, min_bucket=bucket)
    dt3, (sol3, _, _, diag3) = _timed(lambda: esc(x0s, wz, wy), 1)
    conv3 = int(diag3.n_converged) / batch

    k = min(n_oracle, batch)
    z = np.asarray(sol.e_u[:k]).transpose(0, 2, 1).reshape(k, -1)
    orc = oracle_max_du(c, np.asarray(x0s[:k]), z, sol.status[:k])
    return {
        "tier1_fused": parallel.fused_supported(c, batch=batch),
        "oracle_build_s": oracle_build_s,
        "design_s": design_s,
        "compile_s": compile_s,
        "memory_analysis": str(mem),
        "two_tier_s": dt,
        "solves_per_s": batch / dt,
        "converged_fraction": conv,
        "three_tier_s": dt3,
        "converged_fraction_final": conv3,
        **orc,
        "ok": bool(conv3 == 1.0 and orc["oracle_lanes"] > 0
                   and orc["oracle_max_du"] <= TOL_U),
    }


def phase_kernel_parity(shapes=((16384, 1), (512, 2)), horizon: int = 20,
                        interpret: bool = False, seed: int = 1) -> dict:
    """Fused kernel vs the plain vmapped engine, same inputs and config, at
    the headline tier-1 shape (tier 1 config, cap 75) and the tier-2 bucket
    (fallback config, cap 250); ``shapes`` is ((batch, tier), ...)."""
    import jax
    import jax.numpy as jnp

    from automationlabsmodelpredictivecontrol_jl_tpu import parallel

    ctrls = dict(zip((1, 2), headline_controllers(horizon)))
    out, ok = {}, True
    for batch, tier in shapes:
        c = ctrls[tier]
        x0s = jnp.asarray(_x0s(batch, seed))
        fused = jax.jit(
            lambda x: parallel.solve_batch_fused(c, x, interpret=interpret)[0]
        )(x0s)
        plain = jax.jit(lambda x: parallel.solve_batch(c, x)[0])(x0s)
        cmp = compare_solutions(fused, plain)
        out[f"B{batch}_tier{tier}"] = cmp
        ok = ok and cmp["ok"]
    out["ok"] = ok
    return out


def phase_closed_loop(batch: int = 4096, n_steps: int = 50, horizon: int = 20,
                      seed: int = 2) -> dict:
    """(c) On-device receding horizon: solve -> u0 -> true plant, lax.scan."""
    import jax
    import jax.numpy as jnp

    from automationlabsmodelpredictivecontrol_jl_tpu import parallel
    from automationlabsmodelpredictivecontrol_jl_tpu.benchmarks import qtp

    c = _controller(horizon)
    x0s = jnp.asarray(_x0s(batch, seed))
    fn = lambda x: parallel.closed_loop_batch(c, qtp.qtp_discrete_step, x, n_steps)
    compile_s, loop = _compile(fn, x0s)
    dt, (xs, _, st) = _timed(lambda: loop(x0s), 1)
    conv = float(np.mean(np.asarray(st) == 0))
    err0 = float(np.mean(np.abs(np.asarray(xs[0]) - X_REF)))
    errN = float(np.mean(np.abs(np.asarray(xs[-1]) - X_REF)))
    return {
        "fused": parallel.fused_supported(c, batch=batch),
        "compile_s": compile_s,
        "loop_s": dt,
        "steps_per_s": batch * n_steps / dt,
        "converged_step_fraction": conv,
        "mean_err_first": err0,
        "mean_err_last": errN,
        "ok": bool(conv >= 0.99 and errN < err0),
    }


def phase_riccati(batch: int = 1024, horizon: int = 200, cmp_horizon: int = 50,
                  cmp_batch: int = 64, seed: int = 3) -> dict:
    """(d) The long-horizon Riccati engine through solve_batch_auto, and the
    Riccati vs condensed engines on one controller at ``cmp_horizon``."""
    import jax
    import jax.numpy as jnp

    from automationlabsmodelpredictivecontrol_jl_tpu import parallel
    from automationlabsmodelpredictivecontrol_jl_tpu.ops.admm import AdmmConfig
    from automationlabsmodelpredictivecontrol_jl_tpu.ops.riccati import RiccatiConfig

    t0 = time.perf_counter()
    c = _controller(horizon, engine="riccati")
    design_s = time.perf_counter() - t0
    x0s = jnp.asarray(_x0s(batch, seed, spread=0.05))
    fn = lambda x: parallel.solve_batch_auto(c, x)
    compile_s, solve = _compile(fn, x0s)
    dt, (sol, _, _, diag) = _timed(lambda: solve(x0s), 1)
    conv = int(diag.n_converged) / batch

    # parity-grade configs (tests/test_golden_parity.py) for the comparison
    cr = _controller(cmp_horizon, engine="riccati", riccati_config=RiccatiConfig(
        max_iter=20000, eps_abs=1e-6, eps_rel=1e-6))
    cc = _controller(cmp_horizon, engine="condensed",
                     admm_config=AdmmConfig(max_iter=20000, refine_steps=2))
    xc = jnp.asarray(_x0s(cmp_batch, seed + 1, spread=0.05))
    sr = jax.jit(lambda x: parallel.solve_batch_auto(cr, x)[0])(xc)
    sc = jax.jit(lambda x: parallel.solve_batch_auto(cc, x)[0])(xc)
    both = (np.asarray(sr.status) == 0) & (np.asarray(sc.status) == 0)
    du = np.abs(np.asarray(sr.u) - np.asarray(sc.u))[both]
    max_du = float(du.max()) if du.size else float("nan")
    return {
        "design_s": design_s,
        "compile_s": compile_s,
        "solve_s": dt,
        "solves_per_s": batch / dt,
        "converged_fraction": conv,
        "cmp_lanes": int(both.sum()),
        "riccati_vs_condensed_max_du": max_du,
        "ok": bool(conv > 0.0 and both.sum() > 0 and max_du <= TOL_U),
    }


def phase_sqp(batch: int = 256, horizon: int = 10, n_traj: int = 48,
              n_steps: int = 30, train_steps: int = 600, seed: int = 4) -> dict:
    """(e) Nonlinear MPC over a trained fnn model, single-shooting SQP
    (the nonlinear_mpc_fnn_sqp_h10 configuration)."""
    import jax
    import jax.numpy as jnp

    import automationlabsmodelpredictivecontrol_jl_tpu as mpc
    from automationlabsmodelpredictivecontrol_jl_tpu import parallel
    from automationlabsmodelpredictivecontrol_jl_tpu.benchmarks import qtp, training
    from automationlabsmodelpredictivecontrol_jl_tpu.solvers.sqp import SqpConfig

    t0 = time.perf_counter()
    data = training.generate_qtp_dataset(n_traj=n_traj, n_steps=n_steps, seed=0)
    sys_fnn, rmse = training.trained_system("fnn", data, steps=train_steps)
    c = mpc.proceed_controller(
        sys_fnn, "model_predictive_control", horizon, qtp.SAMPLE_TIME, X_REF,
        U_REF, sqp_config=SqpConfig(max_sqp_iter=8),
    )
    design_s = time.perf_counter() - t0
    x0s = jnp.asarray(_x0s(batch, seed, spread=0.05))
    fn = lambda x: parallel.solve_batch(c, x)
    compile_s, solve = _compile(fn, x0s)
    dt, (_, _, _, diag) = _timed(lambda: solve(x0s), 1)
    conv = int(diag.n_converged) / batch
    return {
        "design_and_training_s": design_s,
        "model_rmse": float(rmse),
        "compile_s": compile_s,
        "solve_s": dt,
        "solves_per_s": batch / dt,
        "converged_fraction": conv,
        "ok": bool(conv >= 0.95),
    }


def phase_four_cards(batch: int = 65536, horizon: int = 20, n_devices: int = 4,
                     seed: int = 5) -> dict:
    """Sharded headline fleet on an ``n_devices`` mesh vs the one-card
    solve_batch_auto of the same lanes, plus the psum diagnostics."""
    import jax
    import jax.numpy as jnp

    from automationlabsmodelpredictivecontrol_jl_tpu import parallel

    c, _ = headline_controllers(horizon)
    mesh = parallel.make_mesh(n_devices)
    x0s = jnp.asarray(_x0s(batch, seed))
    fn = lambda x: parallel.solve_sharded(c, x, mesh)
    compile_s, sharded = _compile(fn, x0s)
    dt, (sol_s, _, _, diag) = _timed(lambda: sharded(x0s), 3)
    one = jax.jit(lambda x: parallel.solve_batch_auto(c, x)[0])
    x1 = jax.device_put(x0s, jax.devices()[0])
    dt1, sol_1 = _timed(lambda: one(x1), 3)
    st_s, st_1 = np.asarray(sol_s.status), np.asarray(sol_1.status)
    both = (st_s == 0) & (st_1 == 0)
    du = np.abs(np.asarray(sol_s.u) - np.asarray(sol_1.u))[both]
    max_du = float(du.max()) if du.size else float("nan")
    return {
        "mesh_platform": mesh.devices.flat[0].platform,
        "fused": parallel.fused_supported(
            c, mesh.devices.flat[0].platform, batch // n_devices),
        "compile_s": compile_s,
        "sharded_s": dt,
        "one_card_s": dt1,
        "n_total": int(diag.n_total),
        "n_converged_psum": int(diag.n_converged),
        "converged": [int(np.sum(st_s == 0)), int(np.sum(st_1 == 0))],
        "status_agree": float(np.mean(st_s == st_1)),
        "both_converged": int(both.sum()),
        "max_du": max_du,
        "ok": bool(int(diag.n_total) == batch
                   and int(diag.n_converged) == int(np.sum(st_s == 0))
                   and both.any() and max_du <= TOL_U),
    }


def time_kernel(shapes=((16384, 1), (4096, 1), (1024, 1), (512, 2)),
                horizon: int = 20, reps: int = 10,
                variants=((None, None),), seed: int = 1) -> dict:
    """Fused kernel vs the vmapped XLA engine at each (batch, tier) shape,
    timed in turns (XLA, kernels, kernels reversed, XLA), then end to end
    inside solve_batch_escalated with both tiers on XLA, with the default
    route, and with both tiers on the kernel."""
    import jax
    import jax.numpy as jnp

    from automationlabsmodelpredictivecontrol_jl_tpu import parallel
    from automationlabsmodelpredictivecontrol_jl_tpu.ops import admm_pallas
    from automationlabsmodelpredictivecontrol_jl_tpu.ops.condense import (
        runtime_qp_vectors_batch,
    )

    def in_turns(runs):
        names = list(runs)
        times = {k: [] for k in names}
        for k in names + names[::-1]:
            times[k].append(_timed(runs[k], reps)[0])
        return {k: min(v) for k, v in times.items()}

    ctrls = dict(zip((1, 2), headline_controllers(horizon)))
    out = {}
    for batch, tier in shapes:
        c = ctrls[tier]
        eng = c.engine
        x0s = jnp.asarray(_x0s(batch, seed))
        e0s = x0s - c.tuning.references.x[:, 0][None]
        q, l, u, _, _ = runtime_qp_vectors_batch(eng.qp, e0s)
        xla = jax.jit(lambda x, c=c: parallel.solve_batch(c, x)[0].u)
        runs = {"xla": lambda xla=xla, x0s=x0s: xla(x0s)}
        for blk, warps in variants:
            kern = jax.jit(lambda q, l, u, blk=blk, warps=warps, eng=eng:
                           admm_pallas.solve_batch_fused(
                               eng.op, q, l, u, config=eng.config, block=blk,
                               num_warps=warps)[0])
            runs[f"kernel_blk{blk}_w{warps}"] = (
                lambda kern=kern, q=q, l=l, u=u: kern(q, l, u))
        out[f"B{batch}_tier{tier}"] = in_turns(runs)

    c, fb = ctrls[1], ctrls[2]
    B = shapes[0][0]
    x0s = jnp.asarray(_x0s(B, seed))
    wz, wy = parallel.init_warm_batch(c, B)

    def escalated(rule):
        def fn(x, z, y):
            orig = parallel.scenarios.fused_supported
            if rule is not None:
                parallel.scenarios.fused_supported = rule
            try:  # the route is read while tracing
                return parallel.solve_batch_escalated(
                    c, fb, x, z, y, bucket=512)[0].u
            finally:
                parallel.scenarios.fused_supported = orig
        f = jax.jit(fn)
        return lambda: f(x0s, wz, wy)

    out["end_to_end"] = in_turns({
        "escalated_xla": escalated(lambda *a, **k: False),
        "escalated_route": escalated(None),
        "escalated_kernel_both": escalated(lambda *a, **k: True),
    })
    out["ok"] = True
    return out


PHASES = {
    "single": phase_single,
    "fleet": phase_fleet,
    "kernel_parity": phase_kernel_parity,
    "closed_loop": phase_closed_loop,
    "riccati": phase_riccati,
    "sqp": phase_sqp,
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded fleet on a 4-GPU mesh")
    ap.add_argument("--time-kernel", action="store_true",
                    help="time the fused kernel against the XLA engine")
    args = ap.parse_args(argv)

    import jax

    from automationlabsmodelpredictivecontrol_jl_tpu.utils.devices import (
        card_name_and_power_limit,
        enable_compile_cache,
    )

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: no GPU (JAX platform {devices[0].platform!r})",
              file=sys.stderr)
        return 1
    print(card_name_and_power_limit(), flush=True)
    print(json.dumps({"compile_cache": enable_compile_cache(),
                      "jax": jax.__version__}), flush=True)

    if args.four_cards:
        phases = {"four_cards": phase_four_cards}
    elif args.time_kernel:
        phases = {"time_kernel": lambda: time_kernel(
            variants=((64, 8), (128, 16), (64, 16), (32, 8), (16, 4)))}
    else:
        phases = PHASES
    failed = []
    for name, fn in phases.items():
        t0 = time.perf_counter()
        try:
            res = fn()
        except Exception:  # reported as a failed phase; the exit code says so
            traceback.print_exc()
            res = {"ok": False, "error": traceback.format_exc(limit=1).strip()}
        res["wall_s"] = time.perf_counter() - t0
        print(json.dumps({"phase": name, **res}, default=str), flush=True)
        if not res["ok"]:
            failed.append(name)
    if failed:
        print(f"chip_smoke: failed phases: {failed}", file=sys.stderr)
        return 1
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
