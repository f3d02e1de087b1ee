"""Model Predictive Control framework in JAX.

A from-scratch JAX/XLA re-design of the capability matrix of
``AutomationLabs-sh/AutomationLabsModelPredictiveControl.jl`` (importable
form of "automationlabsmodelpredictivecontrol.jl_tpu"):

- controller design from linear state-space or learned neural dynamics
  (12 model families), with terminal-ingredient synthesis (DARE terminal
  cost; equality / contractive / neighborhood terminal sets),
- in-house structured solvers instead of OSQP/Ipopt/SCIP: a batched,
  design-time-factorized ADMM QP engine and an SQP engine with jacfwd
  linearization — vmap over thousands of scenarios, shard_map over a
  device mesh.
"""

import os as _os

import jax as _jax

# On the GPU a bare f32 `@` may run in TF32 (about 3 decimal digits) —
# fatal for a solver library whose convergence certificates sit at 1e-6
# and whose parity bar is 1e-4 (the same failure class as 1-pass bf16:
# multiple shooting then stalls with its defects pinned at the rounding
# floor). Hot paths pin precision explicitly; this package-level default
# covers everything else (user cost callables, future code). It is
# skipped when the user already chose a default, and can be opted out
# entirely with MPC_NO_GLOBAL_PRECISION=1 for processes that share
# unrelated matmul-heavy work (the package's own solves stay exact either
# way via the explicit pins).
if (
    _os.environ.get("MPC_NO_GLOBAL_PRECISION") != "1"
    and _jax.config.jax_default_matmul_precision is None
):
    _jax.config.update("jax_default_matmul_precision", "highest")

from .types import (
    Box,
    References,
    Weights,
    TerminalIngredient,
    MpcSolution,
    design_references,
    STATUS_CONVERGED,
    STATUS_MAX_ITER,
    STATUS_PRIMAL_INFEASIBLE,
    STATUS_DUAL_INFEASIBLE,
    STATUS_NUMERIC_ERROR,
    STATUS_NAMES,
)
from .systems import (
    LinearContinuousSystem,
    LinearDiscreteSystem,
    NeuralContinuousSystem,
    NeuralDiscreteSystem,
    as_discrete,
    discretize,
    linearize,
    linearize_to_system,
    takagi_sugeno_system,
    user_function_system,
)
from .design import (
    MpcController,
    MpcTuning,
    LinearEngine,
    RiccatiEngine,
    create_weights,
    design_controller,
)
from .runtime import (
    calculate,
    solve_once,
    step,
    update_and_compute,
    update_initialization,
    update_references,
)
from .main import proceed_controller, DEFAULT_PARAMETERS
from .io import load_controller, save_controller
from .ops.admm import AdmmConfig
from .ops.riccati import RiccatiConfig
from .solvers.empc import EmpcConfig, EmpcEngine
from .solvers.sqp import SqpConfig, SqpEngine
from .terminal import create_terminal_ingredient, invariant_terminal_set
from .models.zoo import MODEL_FAMILIES, init_model, make_system, rollout

__version__ = "0.1.0"

__all__ = [
    "AdmmConfig",
    "Box",
    "DEFAULT_PARAMETERS",
    "EmpcConfig",
    "EmpcEngine",
    "LinearContinuousSystem",
    "LinearDiscreteSystem",
    "LinearEngine",
    "MODEL_FAMILIES",
    "MpcController",
    "MpcSolution",
    "MpcTuning",
    "NeuralContinuousSystem",
    "NeuralDiscreteSystem",
    "References",
    "RiccatiConfig",
    "RiccatiEngine",
    "SqpConfig",
    "SqpEngine",
    "STATUS_CONVERGED",
    "STATUS_DUAL_INFEASIBLE",
    "STATUS_MAX_ITER",
    "STATUS_NAMES",
    "STATUS_NUMERIC_ERROR",
    "STATUS_PRIMAL_INFEASIBLE",
    "TerminalIngredient",
    "Weights",
    "as_discrete",
    "calculate",
    "create_terminal_ingredient",
    "create_weights",
    "design_controller",
    "design_references",
    "discretize",
    "init_model",
    "make_system",
    "invariant_terminal_set",
    "linearize",
    "linearize_to_system",
    "load_controller",
    "proceed_controller",
    "save_controller",
    "rollout",
    "solve_once",
    "step",
    "takagi_sugeno_system",
    "update_and_compute",
    "update_initialization",
    "update_references",
    "user_function_system",
]
