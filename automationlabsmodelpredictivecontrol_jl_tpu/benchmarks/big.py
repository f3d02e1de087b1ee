"""Synthetic larger plants: dimensional-generality benchmarks.

Every reference fixture is the 4-state/2-input QTP
(modeler_implementation_test.jl:40-62). MPC problems in production span
wider state spaces, and the solver's cost per solve changes shape with
operator size — so the framework's scaling in nx/nu deserves its own
measured row rather than extrapolation from a tiny plant.
"""

from __future__ import annotations

import numpy as np

from ..systems import Box, LinearDiscreteSystem


def random_stable_system(
    nx: int = 16,
    nu: int = 8,
    seed: int = 0,
    spectral_radius: float = 0.95,
) -> LinearDiscreteSystem:
    """Random discrete LTI plant scaled to the given spectral radius, with
    unit state boxes and +-2 input boxes. Deterministic per seed."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((nx, nx)).astype(np.float64) / np.sqrt(nx)
    eig = np.max(np.abs(np.linalg.eigvals(A)))
    A = A * (spectral_radius / max(eig, 1e-9))
    B = rng.standard_normal((nx, nu)).astype(np.float64) / np.sqrt(nx)
    f32 = lambda a: np.asarray(a, np.float32)
    return LinearDiscreteSystem(
        A=f32(A),
        B=f32(B),
        X=Box(lo=f32(np.full(nx, -1.0)), hi=f32(np.full(nx, 1.0))),
        U=Box(lo=f32(np.full(nu, -2.0)), hi=f32(np.full(nu, 2.0))),
    )
