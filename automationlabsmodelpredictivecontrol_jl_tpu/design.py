"""Controller design: the compile-time stage of the MPC engine.

Capability parity with ``_model_predictive_control_design`` (reference
design_mpc.jl:22-225) and its helpers (_create_weights_coefficients
:235-283, _create_terminal_ingredient :298-394, _create_quadratic_cost
:405-468) — but instead of building a JuMP symbolic model, design here
precomputes *numeric solver operators*: condensed QP matrices and a
factorized ADMM KKT system (linear path), or an SQP engine bound to the
learned dynamics (nonlinear path). The analogue of "the JuMP model" is a
pytree of arrays that flows straight into jit/vmap/shard_map.
"""

from __future__ import annotations

from typing import Any, Optional, Union

import numpy as np
import jax.numpy as jnp

from .ops import admm as admm_ops
from .ops import riccati as riccati_ops
from .ops.condense import CondensedQpData, condense_np
from .solvers.registry import engine_for, resolve_solver
from .systems import (
    LinearContinuousSystem,
    LinearDiscreteSystem,
    NeuralContinuousSystem,
    NeuralDiscreteSystem,
    as_discrete,
    linearize_to_system,
)
from .terminal import create_terminal_ingredient
from .types import MpcSolution, References, TerminalIngredient, Weights, design_references
from .utils.pytrees import pytree_dataclass, static_field

Array = Any


@pytree_dataclass
class MpcTuning:
    """Design-time tuning record (reference ModelPredictiveControlTuning
    types.jl:114-122; the JuMP `modeler` field is replaced by the numeric
    engine stored on the controller)."""

    references: References
    weights: Weights
    terminal: TerminalIngredient
    horizon: int = static_field()
    sample_time: float = static_field()
    max_time: float = static_field()
    programming_type: str = static_field()
    solver_name: str = static_field()
    state_constraint: bool = static_field()


@pytree_dataclass
class LinearEngine:
    """Condensed-QP + factorized-ADMM engine (the OSQP-equivalent path).

    soft_mu: per-row L1 penalty for soft rows (inf = hard); None when all
    rows are hard. Covers BASELINE config 4's slack-penalized soft state
    constraints without adding slack variables — the ADMM projection step
    becomes a shrinkage toward the interval."""

    qp: CondensedQpData
    op: admm_ops.AdmmOperator
    soft_mu: Optional[Array]
    config: admm_ops.AdmmConfig = static_field()


@pytree_dataclass
class RiccatiEngine:
    """O(N) sparse engine: Riccati-factorized ADMM over the block-
    tridiagonal KKT system (ops/riccati.py) — the long-horizon path
    (SURVEY §7.5 / BASELINE north star: block-structured KKT factorization
    fused with horizon rollout). Selected by ``design_controller(...,
    engine="riccati")`` or automatically at long horizons."""

    op: riccati_ops.RiccatiOperator
    config: riccati_ops.RiccatiConfig = static_field()


# horizon at which design's engine="auto" switches the linear path from the
# condensed O((N nu)^2) engine to the O(N) Riccati engine. Chosen from
# measurements on another accelerator (QTP nx=4/nu=2, B=1024-4096, auto
# rho), where the condensed engine won every horizon up to 400 and the O(N)
# engine won by 800; a flop count puts the crossover far lower because it
# ignores how well XLA pipelines the big condensed GEMMs against the
# Riccati sweeps' sequential dependency. Not yet measured on the H100.
RICCATI_AUTO_HORIZON = 500


def riccati_supported(terminal_kind: str, S, soft_state_penalty) -> bool:
    """Feature gate for the sparse engine: no Δu coupling (S=0), no soft
    rows, terminal kind box/ball-representable per state block."""
    if soft_state_penalty is not None:
        return False
    if terminal_kind not in ("none", "equality", "contractive"):
        return False
    S_arr = np.asarray(S, np.float64)
    return not np.any(S_arr != 0.0)


@pytree_dataclass
class MpcController:
    """The controller object (reference ModelPredictiveControlController
    types.jl:151-156): system + tuning + engine + mutable-by-replacement
    runtime state (initialization vector, warm start, last results)."""

    system: Any
    tuning: MpcTuning
    engine: Any
    initialization: Array  # (nx,) last fixed initial state
    warm_z: Array  # engine-specific primal warm start
    warm_y: Array  # engine-specific dual warm start
    results: Optional[MpcSolution]

    @property
    def nx(self) -> int:
        return self.system.nx

    @property
    def nu(self) -> int:
        return self.system.nu


def create_weights(
    nx: int, nu: int, q: Any, r: Any, s: Any
) -> Weights:
    """Q = q·I(nx), R = r·I(nu), S = s·I(nu) for scalar q/r/s
    (reference _create_weights_coefficients design_mpc.jl:235-283); full
    matrices pass through unchanged (update_references re-tunes with the
    controller's existing — possibly non-scalar — weight matrices)."""

    def mat(v, n):
        v = jnp.asarray(v, jnp.float32)
        return v if v.ndim == 2 else v * jnp.eye(n, dtype=jnp.float32)

    return Weights(Q=mat(q, nx), R=mat(r, nu), S=mat(s, nu))


def _linear_engine(
    lin_system: LinearDiscreteSystem,
    tuning: MpcTuning,
    admm_config: admm_ops.AdmmConfig,
    soft_state_penalty: Optional[float] = None,
) -> LinearEngine:
    qp = condense_np(
        lin_system.A,
        lin_system.B,
        tuning.horizon,
        tuning.weights,
        tuning.terminal,
        tuning.references,
        lin_system.X,
        lin_system.U,
        tuning.state_constraint,
    )
    l_np = np.asarray(qp.l_const)
    u_np = np.asarray(qp.u_const)
    eq_mask = np.isfinite(l_np) & np.isfinite(u_np) & (l_np == u_np)
    op = admm_ops.build_operator(qp.P, qp.A, eq_mask, qp.n_ball, admm_config)
    soft_mu = None
    if soft_state_penalty is not None and tuning.state_constraint:
        N, nx, nu = qp.N, qp.nx, qp.nu
        mu = np.full(qp.A.shape[0], np.inf, np.float32)
        mu[N * nu : N * nu + N * nx] = float(soft_state_penalty)
        soft_mu = jnp.asarray(mu)
    return LinearEngine(qp=qp, op=op, soft_mu=soft_mu, config=admm_config)


def design_controller(
    system: Any,
    horizon: int,
    sample_time: float,
    x_ref: Array,
    u_ref: Array,
    *,
    programming_type: Optional[str] = None,
    solver: str = "auto",
    terminal_ingredient: str = "none",
    Q: float = 100.0,
    R: float = 0.1,
    S: float = 0.0,
    max_time: float = 30.0,
    state_constraint: bool = False,
    soft_state_penalty: Optional[float] = None,
    admm_config: Optional[admm_ops.AdmmConfig] = None,
    sqp_config: Optional[Any] = None,
    terminal_set_depth: int = 30,
    economic_cost: Optional[Any] = None,
    economic_terminal_cost: Optional[Any] = None,
    empc_config: Optional[Any] = None,
    engine: str = "auto",
    riccati_config: Optional[riccati_ops.RiccatiConfig] = None,
) -> MpcController:
    """Design an MPC controller (defaults mirror
    _DEFAULT_PARAMETERS_MODEL_PREDICTIVE_CONTROL, main_mpc.jl:87-94;
    default programming type is "linear" for linear systems
    (design_mpc.jl:67) and "non_linear" for learned ones (:159)).

    ``economic_cost`` (a JAX-traceable ``l(x, u) -> scalar``) switches the
    controller to the economic-MPC engine (the branch the reference
    reserved at main_mpc.jl:54-83 but never shipped); see solvers/empc.py.

    ``engine``: linear-path engine selection — "condensed" (dense condensed
    QP + factorized ADMM, the short-horizon default), "riccati" (O(N)
    block-tridiagonal Riccati-ADMM, the long-horizon engine; requires S=0,
    hard constraints, terminal kind none/equality/contractive), or "auto"
    (crossover at horizon >= RICCATI_AUTO_HORIZON when supported).

    Runs pinned to the host CPU backend (design is a once-per-controller
    eager phase; see utils/devices.py) — the operator pytree moves to the
    accelerator with the first jitted solve.
    """
    from .solvers import sqp as sqp_mod  # local import to avoid cycle
    from .utils.devices import design_scope

    with design_scope():
        return _design_controller_impl(
            system, horizon, sample_time, x_ref, u_ref,
            programming_type=programming_type, solver=solver,
            terminal_ingredient=terminal_ingredient, Q=Q, R=R, S=S,
            max_time=max_time, state_constraint=state_constraint,
            soft_state_penalty=soft_state_penalty,
            admm_config=admm_config, sqp_config=sqp_config,
            terminal_set_depth=terminal_set_depth, sqp_mod=sqp_mod,
            economic_cost=economic_cost,
            economic_terminal_cost=economic_terminal_cost,
            empc_config=empc_config,
            engine=engine, riccati_config=riccati_config,
        )


def _design_controller_impl(
    system: Any,
    horizon: int,
    sample_time: float,
    x_ref: Array,
    u_ref: Array,
    *,
    programming_type: Optional[str],
    solver: str,
    terminal_ingredient: str,
    Q: float,
    R: float,
    S: float,
    max_time: float,
    state_constraint: bool,
    soft_state_penalty: Optional[float],
    admm_config: Optional[admm_ops.AdmmConfig],
    sqp_config: Optional[Any],
    terminal_set_depth: int,
    sqp_mod,
    economic_cost: Optional[Any] = None,
    economic_terminal_cost: Optional[Any] = None,
    empc_config: Optional[Any] = None,
    engine: str = "auto",
    riccati_config: Optional[riccati_ops.RiccatiConfig] = None,
) -> MpcController:

    sys_d = as_discrete(system, sample_time)
    is_neural = isinstance(sys_d, NeuralDiscreteSystem)
    if economic_cost is not None:
        # economic objectives are generically non-quadratic: always the
        # NLP route, even over a linear plant
        if programming_type is None:
            programming_type = "non_linear"
        solver_name = resolve_solver(programming_type, solver)
        engine_kind = "empc"
    else:
        if programming_type is None:
            programming_type = "non_linear" if is_neural else "linear"
        solver_name = resolve_solver(programming_type, solver)
        engine_kind = engine_for(programming_type)
        if not is_neural and engine_kind == "sqp":
            # nonlinear programming over a linear model degenerates to the QP
            engine_kind = "admm"
            programming_type = "linear"

    nx, nu = sys_d.nx, sys_d.nu
    references = design_references(x_ref, u_ref, horizon)
    weights = create_weights(nx, nu, Q, R, S)
    terminal = create_terminal_ingredient(
        sys_d, terminal_ingredient, references, weights, max_set_depth=terminal_set_depth
    )

    tuning = MpcTuning(
        references=references,
        weights=weights,
        terminal=terminal,
        horizon=horizon,
        sample_time=float(sample_time),
        max_time=float(max_time),
        programming_type=programming_type,
        solver_name=solver_name,
        state_constraint=bool(state_constraint),
    )

    if engine_kind == "empc":
        from .solvers import empc as empc_mod

        engine = empc_mod.build_engine(
            sys_d, tuning, economic_cost, economic_terminal_cost, empc_config
        )
        warm_z, warm_y = empc_mod.initial_warm_state(engine, tuning)
        return MpcController(
            system=sys_d,
            tuning=tuning,
            engine=engine,
            initialization=jnp.zeros((nx,), jnp.float32),
            warm_z=warm_z,
            warm_y=warm_y,
            results=None,
        )

    if engine_kind == "milp":
        from .solvers import milp as milp_mod

        if not is_neural:
            raise ValueError(
                "mixed_linear programming requires a learned ReLU-network "
                "system (the reference's MILP modelers exist only for "
                "fnn/icnn/resnet/densenet/polynet, SURVEY.md §2.3)"
            )
        engine = milp_mod.build_engine(sys_d, tuning)
        return MpcController(
            system=sys_d,
            tuning=tuning,
            engine=engine,
            initialization=jnp.zeros((nx,), jnp.float32),
            warm_z=jnp.zeros((engine.n,), jnp.float32),
            warm_y=jnp.zeros((engine.m,), jnp.float32),
            results=None,
        )

    if engine_kind == "admm":
        # "Linear" programming on a learned family: linearize at the FIRST
        # reference point then delegate to the linear modeler
        # (fnn/...:38-46 and identically in every family).
        lin_sys = (
            linearize_to_system(sys_d, references.x[:, 0], references.u[:, 0])
            if is_neural
            else sys_d
        )
        if engine not in ("auto", "condensed", "riccati"):
            raise ValueError(
                f"unknown engine {engine!r}; available: auto|condensed|riccati"
            )
        use_riccati = engine == "riccati" or (
            engine == "auto"
            and horizon >= RICCATI_AUTO_HORIZON
            and riccati_supported(terminal.kind, weights.S, soft_state_penalty)
        )
        if use_riccati:
            if not riccati_supported(terminal.kind, weights.S, soft_state_penalty):
                raise ValueError(
                    "riccati engine requires S=0, hard constraints and a "
                    "none/equality/contractive terminal kind; use "
                    "engine='condensed' for this configuration"
                )
            # the ENGINE keeps the user's config (auto rho stays None so
            # update_references/checkpoints round-trip identically); the
            # OPERATOR resolves rho/grid against weights.R at build time,
            # and both solvers start from op.rho_grid via _initial_ridx
            riccati_config = riccati_config or riccati_ops.RiccatiConfig()
            x_ref0 = np.asarray(references.x[:, 0], np.float64)
            u_ref0 = np.asarray(references.u[:, 0], np.float64)
            if state_constraint:
                x_lo_dev = np.asarray(lin_sys.X.lo, np.float64) - x_ref0
                x_hi_dev = np.asarray(lin_sys.X.hi, np.float64) - x_ref0
            else:
                x_lo_dev = np.full((nx,), -np.inf)
                x_hi_dev = np.full((nx,), np.inf)
            op = riccati_ops.build_riccati_operator(
                lin_sys.A, lin_sys.B, weights.Q, weights.R, terminal.P,
                horizon,
                x_lo_dev, x_hi_dev,
                np.asarray(lin_sys.U.lo, np.float64) - u_ref0,
                np.asarray(lin_sys.U.hi, np.float64) - u_ref0,
                state_constraint,
                terminal_kind=terminal.kind,
                config=riccati_config,
            )
            eng = RiccatiEngine(op=op, config=riccati_config)
            warm_z = jnp.zeros((horizon * nu,), jnp.float32)
            warm_y = jnp.zeros(((horizon + 1) * nx + horizon * nu,), jnp.float32)
            return MpcController(
                system=sys_d,
                tuning=tuning,
                engine=eng,
                initialization=jnp.zeros((nx,), jnp.float32),
                warm_z=warm_z,
                warm_y=warm_y,
                results=None,
            )
        admm_config = admm_config or admm_ops.AdmmConfig()
        engine = _linear_engine(lin_sys, tuning, admm_config, soft_state_penalty)
        m = engine.op.A_s.shape[0]
        n = engine.op.A_s.shape[1]
        warm_z = jnp.zeros((n,), jnp.float32)
        warm_y = jnp.zeros((m,), jnp.float32)
    else:
        engine = sqp_mod.build_engine(
            sys_d, tuning, sqp_config, soft_state_penalty=soft_state_penalty
        )
        warm_z, warm_y = sqp_mod.initial_warm_state(engine, tuning)

    return MpcController(
        system=sys_d,
        tuning=tuning,
        engine=engine,
        initialization=jnp.zeros((nx,), jnp.float32),
        warm_z=warm_z,
        warm_y=warm_y,
        results=None,
    )
