"""Dynamical system types + discretization + linearization.

Absorbs, in JAX, the capabilities the reference delegates to external
packages (SURVEY.md §1):

- MathematicalSystems' four dispatched system types
  (ConstrainedLinearControl{Continuous,Discrete}System design_mpc.jl:23,55;
  ConstrainedBlackBoxControl{Discrete,Continuous}System design_mpc.jl:144-147)
  → :class:`LinearContinuousSystem`, :class:`LinearDiscreteSystem`,
  :class:`NeuralDiscreteSystem`, :class:`NeuralContinuousSystem`.
- AutomationLabsSystems.proceed_system_discretization (design_mpc.jl:35)
  → :func:`discretize` (exact zero-order hold via one matrix exponential).
- AutomationLabsSystems.proceed_system_linearization — ForwardDiff jacobians
  of Flux nets (design_mpc.jl:319-323, fnn/...:42-46) → :func:`linearize`
  using ``jax.jacfwd`` / ``jax.jacrev``.
- AutomationLabsSystems.proceed_system_model_evaluation (design_mpc.jl:176)
  → the ``family`` tag carried statically on the neural system types.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

import jax
import jax.numpy as jnp

from .types import Box
from .utils.pytrees import pytree_dataclass, static_field

Array = Any


@pytree_dataclass
class LinearDiscreteSystem:
    """x_{k+1} = A x_k + B u_k with box constraints x in X, u in U."""

    A: Array  # (nx, nx)
    B: Array  # (nx, nu)
    X: Box
    U: Box

    @property
    def nx(self) -> int:
        return self.B.shape[-2]

    @property
    def nu(self) -> int:
        return self.B.shape[-1]

    def step(self, x: Array, u: Array) -> Array:
        return self.A @ x + self.B @ u


@pytree_dataclass
class LinearContinuousSystem:
    """dx/dt = A x + B u with box constraints. Discretized at design time."""

    A: Array
    B: Array
    X: Box
    U: Box

    @property
    def nx(self) -> int:
        return self.B.shape[-2]

    @property
    def nu(self) -> int:
        return self.B.shape[-1]


@pytree_dataclass
class NeuralDiscreteSystem:
    """x_{k+1} = f(params, x_k, u_k), f a learned model of one of the 12
    model families (SURVEY.md §2.3). ``family`` is the model-family tag the
    reference obtains via proceed_system_model_evaluation (design_mpc.jl:176).

    ``activation`` records the activation name when the model was built from
    the zoo registry (checkpoint round-trips rebuild apply_fn from
    (family, activation); None for opaque user callables).
    """

    apply_fn: Callable[..., Array] = static_field()
    family: str = static_field()
    nx: int = static_field()
    nu: int = static_field()
    params: Any
    X: Box
    U: Box
    activation: Optional[str] = static_field(default=None)

    def step(self, x: Array, u: Array) -> Array:
        return self.apply_fn(self.params, x, u)


@pytree_dataclass
class NeuralContinuousSystem:
    """dx/dt = f(params, x, u); integrated with RK4 at ``step`` granularity."""

    apply_fn: Callable[..., Array] = static_field()
    family: str = static_field()
    nx: int = static_field()
    nu: int = static_field()
    params: Any
    X: Box
    U: Box
    activation: Optional[str] = static_field(default=None)

    def deriv(self, x: Array, u: Array) -> Array:
        return self.apply_fn(self.params, x, u)


def discretize(system: LinearContinuousSystem, sample_time: float) -> LinearDiscreteSystem:
    """Exact zero-order-hold discretization.

    Parity with AutomationLabsSystems.proceed_system_discretization as called
    from design_mpc.jl:35. Uses a single matrix exponential of the augmented
    matrix [[A, B], [0, 0]] * Ts (robust even for singular A).
    """
    A = jnp.asarray(system.A, dtype=jnp.float64 if jax.config.jax_enable_x64 else jnp.float32)
    B = jnp.asarray(system.B, dtype=A.dtype)
    nx, nu = B.shape
    M = jnp.zeros((nx + nu, nx + nu), dtype=A.dtype)
    M = M.at[:nx, :nx].set(A).at[:nx, nx:].set(B) * sample_time
    E = jax.scipy.linalg.expm(M)
    Ad = E[:nx, :nx]
    Bd = E[:nx, nx:]
    return LinearDiscreteSystem(A=Ad, B=Bd, X=system.X, U=system.U)


def rk4_step(
    deriv: Callable[[Array, Array], Array], x: Array, u: Array, dt: float
) -> Array:
    """One classic RK4 step with zero-order-held input."""
    k1 = deriv(x, u)
    k2 = deriv(x + 0.5 * dt * k1, u)
    k3 = deriv(x + 0.5 * dt * k2, u)
    k4 = deriv(x + dt * k3, u)
    return x + (dt / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)


def as_discrete(
    system: Any, sample_time: float, substeps: int = 1
) -> Any:
    """Normalize any system to a discrete one.

    - LinearContinuousSystem → exact ZOH discretization (design_mpc.jl:22-41).
    - NeuralContinuousSystem → RK4 integration over the sample time.
    - Discrete systems pass through unchanged.
    """
    if isinstance(system, LinearContinuousSystem):
        return discretize(system, sample_time)
    if isinstance(system, NeuralContinuousSystem):
        dt = sample_time / substeps
        cont = system

        def stepped(params, x, u):
            def body(i, xc):
                return rk4_step(lambda xx, uu: cont.apply_fn(params, xx, uu), xc, u, dt)

            return jax.lax.fori_loop(0, substeps, body, x)

        return NeuralDiscreteSystem(
            apply_fn=stepped,
            family=cont.family,
            nx=cont.nx,
            nu=cont.nu,
            params=cont.params,
            X=cont.X,
            U=cont.U,
            activation=cont.activation,
        )
    return system


def takagi_sugeno_system(
    As: Array,  # (M, nx, nx) local models
    Bs: Array,  # (M, nx, nu)
    centers: Array,  # (M, nx) membership centers
    widths: Array,  # (M,) or (M, nx) Gaussian membership widths
    X: Box,
    U: Box,
) -> "NeuralDiscreteSystem":
    """Takagi-Sugeno multi-model system: x+ = sum_i mu_i(x) (A_i x + B_i u)
    with normalized Gaussian memberships mu_i.

    The reference reserves a FuzzyProgramming tag for this but never
    implements it (types.jl:223 orphaned; CHANGELOG roadmap "Takagi Sugeno
    MPC design"). Here the blended dynamics are just another smooth model —
    the SQP engine handles them natively, and "fuzzy_linear" programming
    routes there (solvers/registry.py)."""
    params = {
        "As": jnp.asarray(As, jnp.float32),
        "Bs": jnp.asarray(Bs, jnp.float32),
        "centers": jnp.asarray(centers, jnp.float32),
        "widths": jnp.asarray(widths, jnp.float32),
    }
    nx = params["As"].shape[-1]
    nu = params["Bs"].shape[-1]

    def apply_fn(p, x, u):
        d2 = jnp.sum(((x[None, :] - p["centers"]) /
                      jnp.atleast_2d(p["widths"].reshape(p["centers"].shape[0], -1)))
                     ** 2, axis=-1)
        w = jax.nn.softmax(-0.5 * d2)
        xs = jnp.einsum("mij,j->mi", p["As"], x) + jnp.einsum(
            "mij,j->mi", p["Bs"], u
        )
        return jnp.einsum("m,mi->i", w, xs)

    return NeuralDiscreteSystem(
        apply_fn=apply_fn, family="takagi_sugeno", nx=int(nx), nu=int(nu),
        params=params, X=X, U=U,
    )


def user_function_system(
    f: Callable[[Array, Array], Array],
    nx: int,
    nu: int,
    X: Box,
    U: Box,
    *,
    discrete: bool = True,
) -> Any:
    """Wrap a user-defined dynamics function f(x, u) -> x_next (discrete) or
    f(x, u) -> dx/dt (continuous) as a system — the reference's "physical"
    model family (src/sub/model_modeler_implementation/physical/, which is
    dead code there: never include'd and with an incomplete NL body,
    SURVEY §2.3; here it is a first-class citizen)."""

    def apply_fn(params, x, u):
        return f(x, u)

    cls = NeuralDiscreteSystem if discrete else NeuralContinuousSystem
    return cls(
        apply_fn=apply_fn, family="physical", nx=nx, nu=nu, params=None, X=X, U=U
    )


def linearize(system: Any, x0: Array, u0: Array) -> Tuple[Array, Array]:
    """Jacobian linearization A = ∂f/∂x, B = ∂f/∂u at (x0, u0).

    In-house replacement for
    AutomationLabsSystems.proceed_system_linearization (ForwardDiff jacobian
    of the Flux net; design_mpc.jl:319-323, fnn/...:42-46) via jax.jacfwd.
    """
    if isinstance(system, (LinearDiscreteSystem, LinearContinuousSystem)):
        return system.A, system.B

    def f(x, u):
        return system.apply_fn(system.params, x, u)

    A = jax.jacfwd(f, argnums=0)(x0, u0)
    B = jax.jacfwd(f, argnums=1)(x0, u0)
    return A, B


def linearize_to_system(system: Any, x0: Array, u0: Array) -> LinearDiscreteSystem:
    """Linearize a (discrete) neural system into a LinearDiscreteSystem,
    keeping the constraint sets — the 3-step "Linear" method every learned
    family shares (fnn/...:38-46 → delegate to the linear modeler)."""
    A, B = linearize(system, x0, u0)
    return LinearDiscreteSystem(A=A, B=B, X=system.X, U=system.U)
