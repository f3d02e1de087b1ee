"""Device-placement helpers: the design scope, the kernel route per
platform, and the persistent compile cache.

Controller *design* is a host-side, once-per-controller phase (the analogue
of the reference's JuMP model build, SURVEY §3.1): dozens of small eager
ops on tiny matrices. It runs pinned to the in-process CPU backend and the
finished operator pytree is transferred to the accelerator once, by the
first jitted solve. Whether the pin still pays on the GPU is not measured.
"""

from __future__ import annotations

import contextlib
import os
import subprocess
from typing import Optional

import jax

# fixed in-repo location of the persistent compile cache (listed in
# .gitignore): never derived from a temp name, a pid or the time, so the
# next run from the same checkout finds its entries again
_REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)
DEFAULT_COMPILE_CACHE_DIR = os.path.join(_REPO_ROOT, ".jax_cache")


def cpu_device():
    """The first CPU device, or None if no CPU backend is registered."""
    try:
        return jax.devices("cpu")[0]
    except RuntimeError:
        return None


def design_scope():
    """Context manager pinning eager computation to the CPU backend.

    No-op when the default backend already is the CPU (tests) or when no
    CPU backend exists.
    """
    dev = cpu_device()
    if dev is None or jax.default_backend() == "cpu":
        return contextlib.nullcontext()
    return jax.default_device(dev)


def kernel_route(platform: Optional[str] = None) -> Optional[str]:
    """The Pallas backend this repo's kernels compile through on
    ``platform`` (default: the default backend's): ``"triton"`` on the
    GPU, ``None`` everywhere else — there the plain XLA engines run.
    Interpret mode is never chosen here; a caller asks for it explicitly
    with ``interpret=True``."""
    platform = platform or jax.default_backend()
    return "triton" if platform == "gpu" else None


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache for a benchmark or smoke
    process and return its directory.

    ``JAX_COMPILATION_CACHE_DIR``, when set, is honoured as is (JAX reads
    it itself) and nothing is changed. Otherwise the cache goes to the
    fixed in-repo path :data:`DEFAULT_COMPILE_CACHE_DIR`."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", DEFAULT_COMPILE_CACHE_DIR)
    return DEFAULT_COMPILE_CACHE_DIR


def card_name_and_power_limit() -> str:
    """The GPUs' names and power limits, one line per card, as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    prints them (a child process that stays off JAX). A card set below its
    maximum power runs slower under load, so every timing is reported
    beside this line."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip()
