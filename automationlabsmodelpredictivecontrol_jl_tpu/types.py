"""Core type vocabulary of the MPC framework.

Mirrors the capability surface of the reference package's
``src/types/types.jl`` (ReferencesStateInput types.jl:24-27,
WeightsCoefficient types.jl:46-50, TerminalIngredient types.jl:89-92,
ModelPredictiveControlTuning types.jl:114-122, ModelPredictiveControlResults
types.jl:134-139, ModelPredictiveControlController types.jl:151-156) — but as
immutable JAX pytrees so whole controllers can flow through ``jit`` /
``vmap`` / ``shard_map``.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import jax.numpy as jnp

from .utils.pytrees import pytree_dataclass, static_field

Array = Any  # jax.Array; kept loose so numpy arrays also pass through.

# ---------------------------------------------------------------------------
# Solver status codes (first-class outputs; a vmapped batch cannot throw).
# The reference never inspects termination status (computation_mpc.jl:38-55);
# we do better: every solve returns a per-scenario status code.
# ---------------------------------------------------------------------------
STATUS_CONVERGED = 0
STATUS_MAX_ITER = 1
STATUS_PRIMAL_INFEASIBLE = 2
STATUS_DUAL_INFEASIBLE = 3
STATUS_NUMERIC_ERROR = 4  # NaN/inf in the iterates (SURVEY §5 sanitizer row)

STATUS_NAMES = {
    STATUS_CONVERGED: "converged",
    STATUS_MAX_ITER: "max_iterations",
    STATUS_PRIMAL_INFEASIBLE: "primal_infeasible",
    STATUS_DUAL_INFEASIBLE: "dual_infeasible",
    STATUS_NUMERIC_ERROR: "numeric_error",
}


@pytree_dataclass
class Box:
    """Axis-aligned box (hyperrectangle) constraint set.

    In-house replacement for the reference's LazySets.Hyperrectangle
    state/input sets unpacked via vertices_list (linear/...:34-38).
    """

    lo: Array  # (n,)
    hi: Array  # (n,)

    @property
    def n(self) -> int:
        return self.lo.shape[-1]

    def contains(self, x: Array, atol: float = 0.0) -> Array:
        return jnp.all((x >= self.lo - atol) & (x <= self.hi + atol), axis=-1)

    def clip(self, x: Array) -> Array:
        return jnp.clip(x, self.lo, self.hi)


@pytree_dataclass
class References:
    """Reference trajectories (reference types.jl:24-27 ReferencesStateInput).

    x: (nx, N+1) state reference, u: (nu, N) input reference.
    """

    x: Array
    u: Array

    @property
    def horizon(self) -> int:
        return self.u.shape[-1]


def design_references(x_ref: Array, u_ref: Array, horizon: int) -> References:
    """Broadcast setpoint vectors into constant reference trajectories.

    Capability parity with ``_design_reference_mpc`` (main_mpc.jl:105-117):
    x: (nx, N+1), u: (nu, N).
    """
    x_ref = jnp.asarray(x_ref, dtype=jnp.float32)
    u_ref = jnp.asarray(u_ref, dtype=jnp.float32)
    return References(
        x=jnp.tile(x_ref[:, None], (1, horizon + 1)),
        u=jnp.tile(u_ref[:, None], (1, horizon)),
    )


@pytree_dataclass
class Weights:
    """Quadratic weight matrices (reference WeightsCoefficient types.jl:46-50).

    Q: (nx,nx) state deviation weight, R: (nu,nu) input deviation weight,
    S: (nu,nu) input rate-of-change weight.
    """

    Q: Array
    R: Array
    S: Array


TERMINAL_KINDS = ("none", "equality", "contractive", "neighborhood")
CONTRACTIVE_FACTOR = 0.9  # hard-coded in the reference (design_mpc.jl:339)


@pytree_dataclass
class TerminalIngredient:
    """Terminal cost + terminal set (reference TerminalIngredient types.jl:89-92).

    kind: one of TERMINAL_KINDS; P: (nx,nx) terminal cost from the DARE
    (design_mpc.jl:327). For kind == "neighborhood", (H, b) is an
    H-representation of an invariant terminal set: H @ e_x_N <= b
    (the set the reference stubbed at design_mpc.jl:342-385).
    """

    kind: str = static_field()
    P: Array
    H: Optional[Array] = None  # (m, nx) or None
    b: Optional[Array] = None  # (m,) or None


@pytree_dataclass
class MpcSolution:
    """Result of one MPC solve (reference ModelPredictiveControlResults
    types.jl:134-139), extended with solver diagnostics.

    Shapes (single scenario): x,e_x: (nx, N+1); u,e_u: (nu, N).
    Batched solves prepend a leading batch axis.
    """

    x: Array
    e_x: Array
    u: Array
    e_u: Array
    status: Array  # int32 status code (STATUS_*)
    iterations: Array  # int32 iterations actually used until convergence
    primal_residual: Array
    dual_residual: Array
    objective: Array
