"""Extra benchmark rows: economic MPC and Takagi-Sugeno fuzzy MPC.

Both are capability surface the reference reserves but never ships (the
economic branch is commented out of main_mpc.jl:54-83 and removed in
v0.1.4; FuzzyProgramming is an orphaned tag, types.jl:223). They are live
engines here, so they get perf rows like every other config. Merges the
rows into ``--out`` (BENCH_SUITE.json, replacing same-named rows).

Run on the GPU: ``python benchmarks_extra.py``; ``--tiny`` rehearses the
mechanics at tiny sizes on any platform.
"""

import argparse
import json
import os
import time

import numpy as np


def _timeit(fn, reps=5):
    import jax

    out = fn()
    jax.block_until_ready(jax.tree_util.tree_leaves(out)[0])
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    jax.block_until_ready(jax.tree_util.tree_leaves(out)[0])
    return (time.perf_counter() - t0) / reps, out


def main(tiny: bool = False, out: str = "BENCH_SUITE.json"):
    import jax
    import jax.numpy as jnp

    import automationlabsmodelpredictivecontrol_jl_tpu as mpc
    from automationlabsmodelpredictivecontrol_jl_tpu import parallel
    from automationlabsmodelpredictivecontrol_jl_tpu.benchmarks import qtp
    from automationlabsmodelpredictivecontrol_jl_tpu.solvers.empc import EmpcConfig

    rng = np.random.default_rng(0)
    x_ref = np.full(4, 0.65, np.float32)
    u_ref = np.full(2, 1.2, np.float32)
    rows = []
    size = lambda b: 16 if tiny else b  # batch per row

    # ---- economic MPC: generic stage cost, exact-Newton SQP --------------
    sys_lin = qtp.linearized_discrete_system()
    xr = jnp.asarray(x_ref)
    ur = jnp.asarray(u_ref)

    def stage_cost(x, u):
        # economic: input-weighted operating cost + soft tracking pull
        ex = x - xr
        return 10.0 * (u @ u) + 50.0 * ex @ ex

    B = size(256)
    N = 10
    c_e = mpc.proceed_controller(
        sys_lin, "economic_model_predictive_control", N, 5.0, x_ref, u_ref,
        mpc_cost_function=stage_cost,
        empc_config=EmpcConfig(max_sqp_iter=15),
    )
    x0s = jnp.asarray(
        np.clip(0.65 + 0.1 * rng.standard_normal((B, 4)), 0.3, 1.3), np.float32
    )
    wz, wy = parallel.init_warm_batch(c_e, B)
    solve_e = jax.jit(lambda x, z, y: parallel.solve_batch(c_e, x, z, y))
    dt, (_, _, _, diag) = _timeit(lambda: solve_e(x0s, wz, wy))
    rows.append({
        "metric": f"economic_mpc_h{N}",
        "value": round(B / dt, 1),
        "unit": "solves/s",
        "batch": B,
        "converged_fraction": round(int(diag.n_converged) / B, 4),
    })
    print(json.dumps(rows[-1]))

    # ---- Takagi-Sugeno fuzzy MPC ------------------------------------------
    lo = qtp.linearized_discrete_system(x_op=np.full(4, 0.4))
    hi = qtp.linearized_discrete_system(x_op=np.full(4, 0.9))
    sys_ts = mpc.takagi_sugeno_system(
        As=jnp.stack([lo.A, hi.A]), Bs=jnp.stack([lo.B, hi.B]),
        centers=jnp.asarray([[0.4] * 4, [0.9] * 4]),
        widths=jnp.asarray([0.25, 0.25]),
        X=qtp.X_BOX, U=qtp.U_BOX,
    )
    c_f = mpc.proceed_controller(
        sys_ts, "model_predictive_control", N, 5.0, x_ref, u_ref,
        mpc_programming_type="fuzzy_linear",
    )
    wz, wy = parallel.init_warm_batch(c_f, B)
    solve_f = jax.jit(lambda x, z, y: parallel.solve_batch(c_f, x, z, y))
    dt, (_, _, _, diag) = _timeit(lambda: solve_f(x0s, wz, wy))
    rows.append({
        "metric": f"fuzzy_ts_mpc_h{N}",
        "value": round(B / dt, 1),
        "unit": "solves/s",
        "batch": B,
        "converged_fraction": round(int(diag.n_converged) / B, 4),
    })
    print(json.dumps(rows[-1]))

    # wide-plant row: 16 states / 8 inputs / horizon 30 — dimensional
    # generality beyond the reference's only fixture (the 4-state QTP),
    # on the default batch route (n = N*nu = 240).
    from automationlabsmodelpredictivecontrol_jl_tpu.benchmarks import big

    sys_big = big.random_stable_system(nx=16, nu=8, seed=0)
    c_big = mpc.proceed_controller(
        sys_big, "model_predictive_control", 30, 1.0,
        np.zeros(16, np.float32), np.zeros(8, np.float32),
        mpc_Q=10.0, mpc_R=0.1,
    )
    B = size(4096)
    x0s_big = jnp.asarray(
        np.clip(0.4 * rng.standard_normal((B, 16)), -0.95, 0.95), np.float32
    )
    wz, wy = parallel.init_warm_batch(c_big, B)
    solve_big = jax.jit(
        lambda x, z, y: parallel.solve_batch_auto(c_big, x, z, y)
    )
    dt, (_, _, _, diag) = _timeit(lambda: solve_big(x0s_big, wz, wy))
    rows.append({
        "metric": "linear_mpc_nx16_nu8_h30",
        "value": round(B / dt, 1),
        "unit": "solves/s",
        "batch": B,
        "converged_fraction": round(int(diag.n_converged) / B, 4),
        "mean_iterations": round(float(diag.mean_iterations), 1),
    })
    print(json.dumps(rows[-1]))

    # wider + longer wide-plant rows: nx32/nu16, and an h100 wide case
    # (n = N*nu reaches 480/800 here) — the dimensional-generality claim
    # should not rest on a single point.
    for nx_w, nu_w, N_w, B_w in ((32, 16, 30, size(2048)), (16, 8, 100, size(1024))):
        sys_w = big.random_stable_system(nx=nx_w, nu=nu_w, seed=0)
        c_w = mpc.proceed_controller(
            sys_w, "model_predictive_control", N_w, 1.0,
            np.zeros(nx_w, np.float32), np.zeros(nu_w, np.float32),
            mpc_Q=10.0, mpc_R=0.1,
        )
        x0s_w = jnp.asarray(
            np.clip(0.4 * rng.standard_normal((B_w, nx_w)), -0.95, 0.95),
            np.float32,
        )
        wz_w, wy_w = parallel.init_warm_batch(c_w, B_w)
        solve_w = jax.jit(
            lambda x, z, y, c=c_w: parallel.solve_batch_auto(c, x, z, y)
        )
        dt, (_, _, _, diag) = _timeit(lambda: solve_w(x0s_w, wz_w, wy_w))
        rows.append({
            "metric": f"linear_mpc_nx{nx_w}_nu{nu_w}_h{N_w}",
            "value": round(B_w / dt, 1),
            "unit": "solves/s",
            "batch": B_w,
            "converged_fraction": round(int(diag.n_converged) / B_w, 4),
            "mean_iterations": round(float(diag.mean_iterations), 1),
        })
        print(json.dumps(rows[-1]))

    # merge into the suite record
    suite = json.load(open(out)) if os.path.exists(out) else []
    names = {r["metric"] for r in rows}
    suite = [r for r in suite if r["metric"] not in names] + rows
    with open(out, "w") as f:
        json.dump(suite, f, indent=1)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tiny", action="store_true",
                    help="tiny sizes: rehearse the mechanics on any platform")
    ap.add_argument("--out", default="BENCH_SUITE.json")
    args = ap.parse_args()
    main(tiny=args.tiny, out=args.out)
