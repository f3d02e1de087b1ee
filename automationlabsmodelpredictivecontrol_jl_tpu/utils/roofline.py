"""Speed-of-light / roofline accounting for the batched ADMM solves.

BASELINE.md north star: "measure rollout + QP kernel speed-of-light per
chip". The reference has no profiling story at all (its entire surface is
wall-clock prints, /root/reference/test/runtests.jl:10-18), so this module
is new surface: an analytic flops/bytes model of a batched ADMM tier,
compared against the device's published peaks to give ``sol_fraction``.

Two flop counts are reported:

- **useful** flops: the algorithmically necessary multiply-adds for ONE rho
  at the true (n, m) problem sizes;
- **executed** flops: what the implementation executes — every rho-grid
  candidate, and on the fused kernel the power-of-two padding of n and R.

The solvers run f32 at IEEE precision (``Precision.HIGHEST``): on the GPU
that is the fp32 rate outside the tensor cores, so the compute ceiling is
the table's ``fp32_flops``. Peaks come from one table keyed by
``device_kind``; a device that is not in it is an error, not a default.
"""

from __future__ import annotations

from typing import Any, Dict

Array = Any

# device_kind -> published peaks. Source: NVIDIA H100 SXM data sheet, dense
# rates without sparsity, at the 700 W power limit. fp32_flops is the rate
# outside the tensor cores (IEEE f32 / Precision.HIGHEST).
_DEVICE_PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "fp32_flops": 67e12,
        "tf32_flops": 495e12,
        "bf16_flops": 989e12,
        "hbm_bytes_per_s": 3.35e12,
    },
}


def device_peaks(device=None) -> Dict[str, Any]:
    """Published peaks of ``device`` (default: the first JAX device).

    Raises ``ValueError`` for a ``device_kind`` that is not in the table."""
    if device is None:
        import jax

        device = jax.devices()[0]
    kind = str(getattr(device, "device_kind", ""))
    for key, peaks in _DEVICE_PEAKS.items():
        if key.lower() == kind.lower():
            return {"device_kind": key, **peaks}
    raise ValueError(
        f"no published peaks for device_kind {kind!r}; known: "
        f"{sorted(_DEVICE_PEAKS)}"
    )


def _pow2(v: int) -> int:
    return 1 << max(0, int(v) - 1).bit_length()


def admm_iteration_model(
    n: int, m: int, R: int, batch: int, refine_steps: int = 0,
    fused: bool = False,
) -> Dict[str, float]:
    """Flops of one ADMM iteration over ``batch`` lanes.

    ``useful``: the single-rho K-solve (n² MACs, plus 2n² per refinement
    step) and, unless A is applied elementwise on the fused box-QP kernel,
    the A-side products A'y, A'ρs and A·x (3mn MACs). ``executed``: the
    R-candidate K-solves as run — on the fused kernel at the padded
    widths n_pad = pow2(n), R_pad = pow2(R)."""
    k = 1 + 2 * refine_steps
    a_side = 0.0 if fused else 3.0 * m * n
    useful = 2.0 * batch * (k * n * n + a_side)
    if fused:
        n_p = max(16, _pow2(n))
        executed = 2.0 * batch * k * n_p * _pow2(R) * n_p
    else:
        executed = 2.0 * batch * (k * R * n * n + a_side)
    return {"useful_flops": useful, "executed_flops": executed}


def admm_bytes_model(
    n: int, m: int, batch: int, iterations: float, chunk: int, fused: bool
) -> float:
    """Least device-memory traffic of a tier.

    Fused kernel: per chunk each lane reads q, l, u, its rho index and the
    state (x, s, y) and writes the state back. Vmapped engine: the state
    (x, s, y, Ax) is read and written at least once per iteration. Both
    add the between-chunk diagnostics' read of the state and the bounds."""
    n_chunks = max(1.0, float(iterations) / max(1, chunk))
    diag = batch * (2 * n + 5 * m + 8) * 4.0 * n_chunks
    if fused:
        n_p = max(16, _pow2(n))
        return batch * (9 * n_p + 1) * 4.0 * n_chunks + diag
    return batch * 2 * (n + 3 * m) * 4.0 * float(iterations) + diag


def _tier_model(op, config, batch: int, iterations: float) -> Dict[str, float]:
    """(useful / executed flops, bytes) for one solver tier running
    ``iterations`` lockstep iterations over ``batch`` lanes; box-only
    operators are modelled on the fused kernel, the rest on the vmapped
    engine."""
    n = int(op.K_invs.shape[1])
    m = int(op.A_s.shape[0])
    R = int(op.rho_grid.shape[0])
    refine = int(getattr(config, "refine_steps", 0))
    fused = bool(getattr(op, "diag_a", False)) and not op.n_ball
    it = admm_iteration_model(n, m, R, batch, refine, fused)
    return {
        "n": n,
        "m": m,
        "R": R,
        "executed_flops": it["executed_flops"] * iterations,
        "useful_flops": it["useful_flops"] * iterations,
        "bytes": admm_bytes_model(
            n, m, batch, iterations, int(config.check_interval), fused
        ),
    }


def _report(tiers, measured_time_s: float, device=None) -> Dict[str, Any]:
    peaks = device_peaks(device)
    flops_executed = sum(t["executed_flops"] for t in tiers)
    flops_useful = sum(t["useful_flops"] for t in tiers)
    bytes_total = sum(t["bytes"] for t in tiers)
    t_compute = flops_executed / peaks["fp32_flops"]
    t_memory = bytes_total / peaks["hbm_bytes_per_s"]
    roofline_t = max(t_compute, t_memory)
    return {
        "device_kind": peaks["device_kind"],
        "n": tiers[0]["n"],
        "m": tiers[0]["m"],
        "rho_grid": tiers[0]["R"],
        "achieved_executed_tflops": flops_executed / measured_time_s / 1e12,
        "achieved_useful_tflops": flops_useful / measured_time_s / 1e12,
        "roofline_time_s": roofline_t,
        "measured_time_s": measured_time_s,
        "bound": "compute" if t_compute >= t_memory else "memory",
        "sol_fraction": roofline_t / measured_time_s,
        "mfu": (flops_useful / measured_time_s) / peaks["fp32_flops"],
    }


def speed_of_light(
    op,
    config,
    batch: int,
    mean_iterations: float,
    measured_time_s: float,
    device=None,
) -> Dict[str, Any]:
    """Roofline report for a measured batched ADMM solve.

    Returns achieved flop/s, the roofline lower-bound time (max of the
    compute and memory limbs), ``sol_fraction`` = roofline_time /
    measured_time (1.0 = running at the hardware ceiling) and ``mfu``
    (useful-flops share of the fp32 peak).

    ``mean_iterations`` should be the iterations the hardware *executed*
    (the while_loop runs all lanes in lockstep until the slowest converges —
    per-lane mean convergence iterations understate the work).
    """
    out = _report(
        [_tier_model(op, config, batch, mean_iterations)],
        measured_time_s,
        device,
    )
    out["mean_iterations"] = float(mean_iterations)
    return out


def speed_of_light_tiered(
    tiers, measured_time_s: float, device=None
) -> Dict[str, Any]:
    """Roofline report for a multi-tier escalated solve: ``tiers`` is a list
    of (op, config, batch, executed_iterations) — e.g. the full batch at the
    tier-1 cap plus the straggler bucket at the tier-2 depth."""
    return _report(
        [_tier_model(op, cfg, b, it) for (op, cfg, b, it) in tiers],
        measured_time_s,
        device,
    )
