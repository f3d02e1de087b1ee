"""Two-process multi-host dryrun of the sharded solve path.

BASELINE targets >=0.8 scaling efficiency at >=2 HOSTS; this exercises the
multi-process CODE PATH for correctness on the CPU (no accelerator, so the
processes never share a card): ``jax.distributed.initialize`` with two OS processes on
localhost, 4 virtual CPU devices each, one global 8-device mesh spanning
both processes, ``solve_sharded`` with process-spanning psum diagnostics,
and per-process verification that:

- the psum-aggregated BatchDiagnostics replicate identically on every
  process (fleet totals over the full global batch), and
- each process's addressable output shards bit-match a local single-device
  re-solve of the same lanes (the collective layer must not perturb lane
  results).

This covers the class of bugs ``shard_map(check_vma=False)`` can hide in
single-process runs: global-vs-local shape confusion,
sharding-spec mismatches on the controller pytree, psum over a partial
axis, and non-addressable-shard access.

Run with no args to launch both processes and write MULTIHOST.json:
    python multihost_dryrun.py
"""

import json
import os
import subprocess
import sys

PORT = int(os.environ.get("MULTIHOST_PORT", "53421"))
# configurable topology: main() runs BOTH a 2-process x 4-device and a
# 4-process x 2-device layout (more process boundaries crossing the same
# global mesh)
N_PROC = int(os.environ.get("MULTIHOST_PROCS", "2"))
DEV_PER_PROC = int(os.environ.get("MULTIHOST_DEVS", "4"))
B_GLOBAL = 64


def worker(pid: int) -> None:
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + f" --xla_force_host_platform_device_count={DEV_PER_PROC}"
        ).strip()
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.distributed.initialize(
        coordinator_address=f"localhost:{PORT}",
        num_processes=N_PROC,
        process_id=pid,
    )
    import numpy as np
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    import automationlabsmodelpredictivecontrol_jl_tpu as mpc
    from automationlabsmodelpredictivecontrol_jl_tpu import parallel
    from automationlabsmodelpredictivecontrol_jl_tpu.benchmarks import qtp

    n_dev = len(jax.devices())
    assert n_dev == N_PROC * DEV_PER_PROC, (pid, n_dev)
    mesh = Mesh(np.asarray(jax.devices()), (parallel.SCENARIO_AXIS,))

    sys_lin = qtp.linearized_discrete_system()
    controller = mpc.proceed_controller(
        sys_lin, "model_predictive_control", 10, 5.0,
        np.full(4, 0.65, np.float32), np.full(2, 1.2, np.float32),
    )

    # deterministic global scenario set; each process materializes ONLY its
    # local shard (the multi-host data-loading pattern)
    rng = np.random.default_rng(7)
    x0_global = np.clip(
        0.65 + 0.1 * rng.standard_normal((B_GLOBAL, 4)), 0.3, 1.3
    ).astype(np.float32)
    wz_g, wy_g = parallel.init_warm_batch(controller, B_GLOBAL)
    wz_g = np.asarray(wz_g)
    wy_g = np.asarray(wy_g)

    shard = NamedSharding(mesh, P(parallel.SCENARIO_AXIS))
    lo = pid * (B_GLOBAL // N_PROC)
    hi = lo + B_GLOBAL // N_PROC

    def globalize(arr):
        return jax.make_array_from_process_local_data(shard, arr[lo:hi])

    x0s = globalize(x0_global)
    wz = globalize(wz_g)
    wy = globalize(wy_g)

    sol, wz_n, wy_n, diag = parallel.solve_sharded(
        controller, x0s, mesh, wz, wy
    )

    # 1) fleet diagnostics replicate across processes
    n_total = int(jax.device_get(diag.n_total))
    n_conv = int(jax.device_get(diag.n_converged))
    assert n_total == B_GLOBAL, n_total
    assert n_conv == B_GLOBAL, n_conv

    # 2) local addressable shards match a plain single-device re-solve
    local_u = []
    for s in sorted(
        sol.u.addressable_shards, key=lambda s: s.index[0].start or 0
    ):
        local_u.append((s.index[0].start or 0, np.asarray(s.data)))
    ref_sol, _, _, _ = parallel.solve_batch(
        controller,
        jnp.asarray(x0_global),
        jnp.asarray(wz_g),
        jnp.asarray(wy_g),
    )
    ref_u = np.asarray(jax.device_get(ref_sol.u))
    for start, u_blk in local_u:
        np.testing.assert_allclose(
            u_blk, ref_u[start : start + u_blk.shape[0]], atol=5e-5
        )

    print(f"MULTIHOST_PROC_{pid}_OK n_total={n_total} n_conv={n_conv}",
          flush=True)


def run_topology(n_proc: int, dev_per_proc: int, port: int) -> dict:
    env = dict(os.environ)
    env["MULTIHOST_PROCS"] = str(n_proc)
    env["MULTIHOST_DEVS"] = str(dev_per_proc)
    env["MULTIHOST_PORT"] = str(port)
    procs = []
    for pid in range(n_proc):
        procs.append(
            subprocess.Popen(
                [sys.executable, __file__, str(pid)],
                stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT,
                text=True,
                env=env,
            )
        )
    outs = []
    ok = True
    for pid, p in enumerate(procs):
        try:
            out, _ = p.communicate(timeout=900)
        except subprocess.TimeoutExpired:
            p.kill()
            out = "TIMEOUT"
        outs.append(out)
        ok = ok and (f"MULTIHOST_PROC_{pid}_OK" in out)
    if not ok:
        for pid, out in enumerate(outs):
            print(f"--- {n_proc}p process {pid} output ---\n{out[-4000:]}")
    return {
        "ok": ok,
        "processes": n_proc,
        "devices_per_process": dev_per_proc,
        "global_batch": B_GLOBAL,
        "checks": [
            "psum diagnostics replicate across processes",
            "addressable shards match single-device re-solve",
        ],
    }


def main() -> None:
    results = [
        run_topology(2, 4, PORT),
        run_topology(4, 2, PORT + 1),
    ]
    ok = all(r["ok"] for r in results)
    out = {"ok": ok, "topologies": results}
    with open("MULTIHOST.json", "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))
    if not ok:
        sys.exit(1)


if __name__ == "__main__":
    if len(sys.argv) > 1:
        worker(int(sys.argv[1]))
    else:
        main()
