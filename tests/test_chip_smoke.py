"""chip_smoke.py's phases at tiny sizes on the CPU (the fused kernel in the
Pallas interpreter, the four-card phase on four virtual devices), its
refusal to run without a GPU, and the compile-cache helper it calls."""

import json
import os
import sys

import jax
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from automationlabsmodelpredictivecontrol_jl_tpu.utils import devices  # noqa: E402

PHASES = {
    "single": lambda: chip_smoke.phase_single(horizon=10, n_steps=4),
    "fleet": lambda: chip_smoke.phase_fleet(
        batch=64, bucket=16, horizon=10, n_oracle=16, reps=1),
    "kernel_parity": lambda: chip_smoke.phase_kernel_parity(
        shapes=((64, 1), (16, 2)), horizon=10, interpret=True),
    "closed_loop": lambda: chip_smoke.phase_closed_loop(
        batch=16, n_steps=5, horizon=10),
    "riccati": lambda: chip_smoke.phase_riccati(
        batch=16, horizon=30, cmp_horizon=10, cmp_batch=8),
    "sqp": lambda: chip_smoke.phase_sqp(
        batch=8, n_traj=8, n_steps=10, train_steps=50),
    "four_cards": lambda: chip_smoke.phase_four_cards(
        batch=32, horizon=10, n_devices=4),
}


@pytest.mark.parametrize("name", sorted(PHASES))
def test_phase_at_tiny_size(name):
    res = PHASES[name]()
    json.dumps(res, default=str)  # one printable JSON line
    assert res["ok"], res


def test_main_refuses_without_gpu(capsys):
    """No GPU: non-zero exit before any phase, and no result line."""
    assert chip_smoke.main([]) != 0
    out = capsys.readouterr()
    assert '"ok"' not in out.out and "no GPU" in out.err


@pytest.fixture
def cache_config():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_honours_env(monkeypatch, cache_config):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/some/where/else")
    assert devices.enable_compile_cache() == "/some/where/else"
    assert jax.config.jax_compilation_cache_dir == before  # nothing set


def test_compile_cache_fixed_in_repo_path(monkeypatch, cache_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = devices.enable_compile_cache()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert path == os.path.join(repo, ".jax_cache") == devices.DEFAULT_COMPILE_CACHE_DIR
    assert jax.config.jax_compilation_cache_dir == path
    assert devices.enable_compile_cache() == path  # the same path every time
