"""Observability surface: roofline accounting + latency statistics.

The reference's entire profiling story is wall-clock prints
(/root/reference/test/runtests.jl:10-18); SURVEY §5 and BASELINE.md make
per-kernel speed-of-light accounting new first-class surface here. These
tests pin the analytic model's invariants so the numbers bench.py reports
stay defensible.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import automationlabsmodelpredictivecontrol_jl_tpu as mpc
from automationlabsmodelpredictivecontrol_jl_tpu.benchmarks import qtp
from automationlabsmodelpredictivecontrol_jl_tpu.ops.admm import AdmmConfig
from automationlabsmodelpredictivecontrol_jl_tpu.utils import profiling, roofline


def _controller(N=20):
    return mpc.proceed_controller(
        qtp.linearized_discrete_system(), "model_predictive_control",
        N, 5.0, np.full(4, 0.65, np.float32), np.full(2, 1.2, np.float32),
        admm_config=AdmmConfig(max_iter=100),
    )


class _H100:
    device_kind = "NVIDIA H100 80GB HBM3"


def test_speed_of_light_report_invariants():
    c = _controller()
    rep = roofline.speed_of_light(
        c.engine.op, c.engine.config, batch=512,
        mean_iterations=80.0, measured_time_s=0.01, device=_H100(),
    )
    assert rep["bound"] in ("compute", "memory")
    assert rep["device_kind"] == "NVIDIA H100 80GB HBM3"
    assert 0.0 < rep["sol_fraction"]
    assert rep["roofline_time_s"] > 0.0
    # executed flops bound useful flops (every rho candidate is computed)
    assert rep["achieved_executed_tflops"] >= rep["achieved_useful_tflops"] > 0
    # mfu is the useful-flops utilization: never above SOL fraction
    assert rep["mfu"] <= rep["sol_fraction"] + 1e-12


def test_speed_of_light_scales_with_time():
    """Half the measured time -> double the achieved flop/s and SOL."""
    c = _controller()
    r1 = roofline.speed_of_light(c.engine.op, c.engine.config, 512, 80.0, 0.02,
                                 device=_H100())
    r2 = roofline.speed_of_light(c.engine.op, c.engine.config, 512, 80.0, 0.01,
                                 device=_H100())
    np.testing.assert_allclose(r2["sol_fraction"], 2 * r1["sol_fraction"], rtol=1e-9)
    np.testing.assert_allclose(
        r2["achieved_executed_tflops"], 2 * r1["achieved_executed_tflops"], rtol=1e-9
    )


def test_device_peaks_known_and_unknown():
    peaks = roofline.device_peaks(_H100())
    assert peaks["fp32_flops"] == 67e12 and peaks["tf32_flops"] == 495e12
    assert peaks["bf16_flops"] == 989e12 and peaks["hbm_bytes_per_s"] == 3.35e12


def test_device_peaks_unknown_device_raises():
    """No default peak: the CPU test device, and any kind not in the table,
    is an error rather than a made-up roofline."""
    with pytest.raises(ValueError, match="no published peaks"):
        roofline.device_peaks()  # the tests run on the CPU

    class Other:
        device_kind = "NVIDIA A100-SXM4-80GB"

    with pytest.raises(ValueError, match="A100"):
        roofline.device_peaks(Other())


def test_roofline_models_the_route():
    """A box-only operator is modelled on the fused kernel (padded widths,
    no A-side flops); the same shapes on the vmapped engine count the
    A-side products and stream the state every iteration."""
    f = roofline.admm_iteration_model(40, 40, 2, 1024, fused=True)
    v = roofline.admm_iteration_model(40, 40, 2, 1024, fused=False)
    assert f["useful_flops"] == 2.0 * 1024 * 40 * 40
    assert f["executed_flops"] == 2.0 * 1024 * 64 * 2 * 64
    assert v["useful_flops"] == 2.0 * 1024 * (40 * 40 + 3 * 40 * 40)
    fb = roofline.admm_bytes_model(40, 40, 1024, 75.0, 25, fused=True)
    vb = roofline.admm_bytes_model(40, 40, 1024, 75.0, 25, fused=False)
    assert 0 < fb < vb


def test_latency_benchmark_stats():
    c = _controller(N=5)
    from automationlabsmodelpredictivecontrol_jl_tpu.runtime import solve_once

    x0 = jnp.asarray([0.6] * 4, jnp.float32)
    f = jax.jit(lambda: solve_once(c, x0, c.warm_z, c.warm_y)[0].u)
    stats = profiling.benchmark(f, warmup=1, reps=5)
    assert stats["p50_ms"] > 0
    assert stats["p99_ms"] >= stats["p50_ms"]
    assert profiling.solve_rate(32, stats) > 0
