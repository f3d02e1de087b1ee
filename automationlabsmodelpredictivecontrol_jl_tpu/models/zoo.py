"""Learned-dynamics model zoo: the 12 model families of the reference.

Capability parity with the reference's modeler families (SURVEY.md §2.3,
src/sub/model_modeler_implementation/{linear,fnn,icnn,resnet,densenet,rbf,
polynet,neuralode,rknn1,rknn2,rknn4,physical}). The reference *transcribes*
these nets neuron-by-neuron into JuMP constraints (fnn/...:125-144); here
each family is a pure JAX function ``apply(params, x, u) -> x_next`` that
the SQP solver rolls out / linearizes directly — no constraint-row
materialization, dynamics stay as fused matmuls.

Shared architecture convention (mirrors the Flux.params unpacking at
fnn/...:88-107): input layer (nx+nu → n) with bias, ``depth`` hidden blocks
(n → n) with bias, linear output layer (n → nx) without bias.

All params are float32 pytrees of stacked arrays — hidden blocks are scanned
(``lax.scan``) so depth does not unroll the trace.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import jax
import jax.numpy as jnp

from .activations import get_activation

Array = Any

MODEL_FAMILIES = (
    "linear",
    "fnn",
    "icnn",
    "resnet",
    "densenet",
    "rbf",
    "polynet",
    "neuralode",
    "rknn1",
    "rknn2",
    "rknn4",
    "physical",
    # recurrent families — a reference roadmap item (CHANGELOG.md roadmap)
    # shipped here: the cell's recurrent state is the plant state
    "rnn",
    "lstm",
    "gru",
)


def _dense_init(key, n_in, n_out, scale=None):
    scale = scale if scale is not None else 1.0 / jnp.sqrt(n_in)
    return jax.random.uniform(key, (n_out, n_in), jnp.float32, -scale, scale)


def _mlp_params(key, n_in, n_out, hidden, depth) -> Dict[str, Array]:
    """Stacked-MLP parameters: W_in (h,n_in), hidden W (depth,h,h) b (depth,h),
    W_out (n_out,h)."""
    k1, k2, k3, k4, k5 = jax.random.split(key, 5)
    return {
        "W_in": _dense_init(k1, n_in, hidden),
        "b_in": jnp.zeros((hidden,), jnp.float32),
        "W": jax.vmap(lambda k: _dense_init(k, hidden, hidden))(
            jax.random.split(k2, depth)
        ),
        "b": jnp.zeros((depth, hidden), jnp.float32),
        "W_out": _dense_init(k3, hidden, n_out),
    }


# ---------------------------------------------------------------------------
# Family: fnn — plain feedforward net (reference fnn/ modeler)
# ---------------------------------------------------------------------------
def fnn_init(key, nx, nu, hidden=16, depth=2, activation="relu"):
    return _mlp_params(key, nx + nu, nx, hidden, depth)


def fnn_apply(params, x, u, activation="relu"):
    act = get_activation(activation)
    z = jnp.concatenate([x, u], axis=-1)
    h = act(params["W_in"] @ z + params["b_in"])

    def layer(h, Wb):
        W, b = Wb
        return act(W @ h + b), None

    h, _ = jax.lax.scan(layer, h, (params["W"], params["b"]))
    return params["W_out"] @ h


# ---------------------------------------------------------------------------
# Family: icnn — input-convex neural network (reference icnn/ modeler).
# z_{j+1} = act(relu(Wz_j) z_j + Wx_j [x;u] + b_j): nonneg hidden-to-hidden
# weights keep the map convex in the input (the property the family is for;
# the reference's JuMP encoding drops the skip connections, SURVEY §2.3).
# ---------------------------------------------------------------------------
def icnn_init(key, nx, nu, hidden=16, depth=2, activation="relu"):
    k1, k2, k3, k4, k5 = jax.random.split(key, 5)
    n_in = nx + nu
    return {
        "W_in": _dense_init(k1, n_in, hidden),
        "b_in": jnp.zeros((hidden,), jnp.float32),
        "Wz": jax.vmap(lambda k: _dense_init(k, hidden, hidden))(
            jax.random.split(k2, depth)
        ),
        "Wx": jax.vmap(lambda k: _dense_init(k, n_in, hidden))(
            jax.random.split(k3, depth)
        ),
        "b": jnp.zeros((depth, hidden), jnp.float32),
        "W_out": _dense_init(k4, hidden, nx),
        "Wx_out": _dense_init(k5, n_in, nx),
    }


def icnn_apply(params, x, u, activation="relu"):
    act = get_activation(activation)
    z_in = jnp.concatenate([x, u], axis=-1)
    h = act(params["W_in"] @ z_in + params["b_in"])

    def layer(h, wbs):
        Wz, Wx, b = wbs
        return act(jax.nn.relu(Wz) @ h + Wx @ z_in + b), None

    h, _ = jax.lax.scan(layer, h, (params["Wz"], params["Wx"], params["b"]))
    # output stays convex: nonneg weights on the convex hidden state plus an
    # affine input skip (unconstrained-sign W_out would break convexity)
    return jax.nn.relu(params["W_out"]) @ h + params["Wx_out"] @ z_in


# ---------------------------------------------------------------------------
# Family: resnet — residual blocks y_j = y_{j-1} + act(W y_{j-1} + b)
# (reference resnet/...:131-140 hidden-layer encoding)
# ---------------------------------------------------------------------------
resnet_init = fnn_init


def resnet_apply(params, x, u, activation="relu"):
    act = get_activation(activation)
    z = jnp.concatenate([x, u], axis=-1)
    h = act(params["W_in"] @ z + params["b_in"])

    def layer(h, Wb):
        W, b = Wb
        return h + act(W @ h + b), None

    h, _ = jax.lax.scan(layer, h, (params["W"], params["b"]))
    return params["W_out"] @ h


# ---------------------------------------------------------------------------
# Family: densenet — concatenating skip connections; per-depth block widths
# grow (reference densenet/...:119-154). Widths differ per layer so params
# are per-layer lists (depth is static, small).
# ---------------------------------------------------------------------------
def densenet_init(key, nx, nu, hidden=16, depth=2, activation="relu"):
    keys = jax.random.split(key, depth + 2)
    params = {
        "W_in": _dense_init(keys[0], nx + nu, hidden),
        "b_in": jnp.zeros((hidden,), jnp.float32),
        "blocks": [],
    }
    width = hidden
    for j in range(depth):
        params["blocks"].append(
            {
                "W": _dense_init(keys[j + 1], width, hidden),
                "b": jnp.zeros((hidden,), jnp.float32),
            }
        )
        width += hidden
    params["W_out"] = _dense_init(keys[-1], width, nx)
    return params


def densenet_apply(params, x, u, activation="relu"):
    act = get_activation(activation)
    z = jnp.concatenate([x, u], axis=-1)
    h = act(params["W_in"] @ z + params["b_in"])
    for blk in params["blocks"]:
        h = jnp.concatenate([h, act(blk["W"] @ h + blk["b"])], axis=-1)
    return params["W_out"] @ h


# ---------------------------------------------------------------------------
# Family: rbf — radial-basis-function net (reference rbf/ modeler; Fnn-style
# transcription with the RBF activation registered)
# ---------------------------------------------------------------------------
def rbf_init(key, nx, nu, hidden=16, depth=1, activation="gaussian"):
    return _mlp_params(key, nx + nu, nx, hidden, depth)


def rbf_apply(params, x, u, activation="gaussian"):
    return fnn_apply(params, x, u, activation="gaussian")


# ---------------------------------------------------------------------------
# Family: polynet — two-branch poly-inception blocks
# y_j = y_{j-1} + s + act(W2 s + b2), s = act(W1 y_{j-1} + b1)
# (reference polynet/...:117,134-148 branch_poly encoding)
# ---------------------------------------------------------------------------
def polynet_init(key, nx, nu, hidden=16, depth=2, activation="relu"):
    k1, k2, k3, k4 = jax.random.split(key, 4)
    return {
        "W_in": _dense_init(k1, nx + nu, hidden),
        "b_in": jnp.zeros((hidden,), jnp.float32),
        "W1": jax.vmap(lambda k: _dense_init(k, hidden, hidden))(
            jax.random.split(k2, depth)
        ),
        "b1": jnp.zeros((depth, hidden), jnp.float32),
        "W2": jax.vmap(lambda k: _dense_init(k, hidden, hidden))(
            jax.random.split(k3, depth)
        ),
        "b2": jnp.zeros((depth, hidden), jnp.float32),
        "W_out": _dense_init(k4, hidden, nx),
    }


def polynet_apply(params, x, u, activation="relu"):
    act = get_activation(activation)
    z = jnp.concatenate([x, u], axis=-1)
    h = act(params["W_in"] @ z + params["b_in"])

    def layer(h, wbs):
        W1, b1, W2, b2 = wbs
        s = act(W1 @ h + b1)
        return h + s + act(W2 @ s + b2), None

    h, _ = jax.lax.scan(
        layer, h, (params["W1"], params["b1"], params["W2"], params["b2"])
    )
    return params["W_out"] @ h


# ---------------------------------------------------------------------------
# Families: neuralode / rknn1 / rknn2 / rknn4 — continuous MLP vector field
# f_theta(x, u) integrated by an explicit Runge-Kutta scheme with 1/2/4
# stages over the sample time (reference neuralode/ and rknn{1,2,4}/
# modelers; the RK tableau is the family distinction, SURVEY §2.3).
# Params carry "dt" (sample time) as a scalar leaf.
# ---------------------------------------------------------------------------
def _odenet_init(key, nx, nu, hidden=16, depth=2, dt=1.0):
    p = _mlp_params(key, nx + nu, nx, hidden, depth)
    p["dt"] = jnp.asarray(dt, jnp.float32)
    return p


neuralode_init = _odenet_init
rknn1_init = _odenet_init
rknn2_init = _odenet_init
rknn4_init = _odenet_init


def _vector_field(params, x, u, activation):
    return fnn_apply(params, x, u, activation=activation)


def rknn1_apply(params, x, u, activation="tanh"):
    """Explicit Euler (1-stage RK) neural integrator."""
    dt = params["dt"]
    return x + dt * _vector_field(params, x, u, activation)


def rknn2_apply(params, x, u, activation="tanh"):
    """Midpoint (2-stage RK) neural integrator."""
    dt = params["dt"]
    k1 = _vector_field(params, x, u, activation)
    k2 = _vector_field(params, x + 0.5 * dt * k1, u, activation)
    return x + dt * k2


def rknn4_apply(params, x, u, activation="tanh"):
    """Classic RK4 neural integrator."""
    dt = params["dt"]
    f = lambda xx: _vector_field(params, xx, u, activation)
    k1 = f(x)
    k2 = f(x + 0.5 * dt * k1)
    k3 = f(x + 0.5 * dt * k2)
    k4 = f(x + dt * k3)
    return x + (dt / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)


def neuralode_apply(params, x, u, activation="tanh", substeps=4):
    """Neural ODE: RK4 with fixed substeps across the sample interval."""
    dt = params["dt"] / substeps
    f = lambda xx: _vector_field(params, xx, u, activation)

    def body(i, xc):
        k1 = f(xc)
        k2 = f(xc + 0.5 * dt * k1)
        k3 = f(xc + 0.5 * dt * k2)
        k4 = f(xc + dt * k3)
        return xc + (dt / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)

    return jax.lax.fori_loop(0, substeps, body, x)


# ---------------------------------------------------------------------------
# Families: rnn / lstm / gru — recurrent cells as dynamics maps. A roadmap
# item the reference never shipped ("recurrent neural networks",
# CHANGELOG.md roadmap); here the cell's recurrent state IS the plant state,
# so x_{k+1} = cell(x_k, u_k) keeps the common apply contract. For the LSTM
# the state is the concatenation [h; c] (nx must be even).
# ---------------------------------------------------------------------------
def rnn_init(key, nx, nu, hidden=None, depth=None):
    """Elman cell: x' = tanh(Wx x + Wu u + b)."""
    k1, k2 = jax.random.split(key)
    return {
        "Wx": _dense_init(k1, nx, nx),
        "Wu": _dense_init(k2, nu, nx),
        "b": jnp.zeros((nx,), jnp.float32),
    }


def rnn_apply(params, x, u, activation="tanh"):
    act = get_activation(activation)
    return act(params["Wx"] @ x + params["Wu"] @ u + params["b"])


def gru_init(key, nx, nu, hidden=None, depth=None):
    """GRU cell with input u and recurrent state x (gates z, r, candidate n)."""
    ks = jax.random.split(key, 6)
    return {
        "Wz": _dense_init(ks[0], nx, nx), "Uz": _dense_init(ks[1], nu, nx),
        "Wr": _dense_init(ks[2], nx, nx), "Ur": _dense_init(ks[3], nu, nx),
        "Wn": _dense_init(ks[4], nx, nx), "Un": _dense_init(ks[5], nu, nx),
        "bz": jnp.zeros((nx,), jnp.float32),
        "br": jnp.zeros((nx,), jnp.float32),
        "bn": jnp.zeros((nx,), jnp.float32),
    }


def gru_apply(params, x, u, activation="tanh"):
    z = jax.nn.sigmoid(params["Wz"] @ x + params["Uz"] @ u + params["bz"])
    r = jax.nn.sigmoid(params["Wr"] @ x + params["Ur"] @ u + params["br"])
    nvec = jnp.tanh(params["Wn"] @ (r * x) + params["Un"] @ u + params["bn"])
    return (1.0 - z) * nvec + z * x


def lstm_init(key, nx, nu, hidden=None, depth=None):
    """LSTM cell; the plant state stacks [h; c], so nx must be even."""
    if nx % 2 != 0:
        raise ValueError("lstm family needs an even state dimension ([h; c])")
    nh = nx // 2
    ks = jax.random.split(key, 8)
    p = {}
    for i, g in enumerate(("i", "f", "g", "o")):
        p[f"W{g}"] = _dense_init(ks[2 * i], nh, nh)
        p[f"U{g}"] = _dense_init(ks[2 * i + 1], nu, nh)
        p[f"b{g}"] = jnp.zeros((nh,), jnp.float32)
    # forget-gate bias 1.0: the standard stability trick
    p["bf"] = jnp.ones((nh,), jnp.float32)
    return p


def lstm_apply(params, x, u, activation="tanh"):
    nh = x.shape[-1] // 2
    h, c = x[:nh], x[nh:]
    gi = jax.nn.sigmoid(params["Wi"] @ h + params["Ui"] @ u + params["bi"])
    gf = jax.nn.sigmoid(params["Wf"] @ h + params["Uf"] @ u + params["bf"])
    gg = jnp.tanh(params["Wg"] @ h + params["Ug"] @ u + params["bg"])
    go = jax.nn.sigmoid(params["Wo"] @ h + params["Uo"] @ u + params["bo"])
    c_new = gf * c + gi * gg
    h_new = go * jnp.tanh(c_new)
    return jnp.concatenate([h_new, c_new], axis=-1)


# ---------------------------------------------------------------------------
# Registry + constructors
# ---------------------------------------------------------------------------
_INITS = {
    "fnn": fnn_init,
    "icnn": icnn_init,
    "resnet": resnet_init,
    "densenet": densenet_init,
    "rbf": rbf_init,
    "polynet": polynet_init,
    "neuralode": neuralode_init,
    "rknn1": rknn1_init,
    "rknn2": rknn2_init,
    "rknn4": rknn4_init,
    "rnn": rnn_init,
    "gru": gru_init,
    "lstm": lstm_init,
}

_APPLIES = {
    "fnn": fnn_apply,
    "icnn": icnn_apply,
    "resnet": resnet_apply,
    "densenet": densenet_apply,
    "rbf": rbf_apply,
    "polynet": polynet_apply,
    "neuralode": neuralode_apply,
    "rknn1": rknn1_apply,
    "rknn2": rknn2_apply,
    "rknn4": rknn4_apply,
    "rnn": rnn_apply,
    "gru": gru_apply,
    "lstm": lstm_apply,
}


def default_activation(family: str) -> str:
    """Family default activation (the reference's per-family conventions)."""
    return {
        "rbf": "gaussian",
        "neuralode": "tanh",
        "rknn1": "tanh",
        "rknn2": "tanh",
        "rknn4": "tanh",
        "rnn": "tanh",
        "gru": "tanh",
        "lstm": "tanh",
    }.get(family, "relu")


def make_apply(family: str, activation: str = None) -> Tuple[Callable, str]:
    """(apply_fn bound to the activation, resolved activation name) — the
    deterministic rebuild used by checkpoint load (io.py).

    The dynamics evaluate under ``default_matmul_precision("highest")``:
    a reduced-precision ``@`` (TF32 on the GPU, bf16 passes on other
    accelerators) floors the model forward at ~1e-3..1e-2 relative error,
    which pins the multiple-shooting defect residual far above the 1e-4
    feasibility gate. The dynamics model is the physics: its evaluation
    precision bounds every honesty gate downstream (defects, rollout
    violations, merit comparisons), so it is pinned here at the source.
    The matrices are tiny (hidden ~ 8-32); the cost is negligible."""
    act = activation or default_activation(family)
    base_apply = _APPLIES[family]

    def apply_fn(p, x, u):
        with jax.default_matmul_precision("highest"):
            return base_apply(p, x, u, activation=act)

    return apply_fn, act


def init_model(
    family: str,
    key,
    nx: int,
    nu: int,
    hidden: int = 16,
    depth: int = 2,
    activation: str = None,
    sample_time: float = 1.0,
) -> Tuple[Callable, Any]:
    """Create (apply_fn, params) for a model family.

    apply_fn(params, x, u) -> x_next — the common contract every family
    satisfies (single sample; batch via vmap).
    """
    if family not in _INITS:
        raise ValueError(f"unknown model family {family!r}; see MODEL_FAMILIES")
    init = _INITS[family]
    if family in ("neuralode", "rknn1", "rknn2", "rknn4"):
        params = init(key, nx, nu, hidden=hidden, depth=depth, dt=sample_time)
    else:
        params = init(key, nx, nu, hidden=hidden, depth=depth)
    apply_fn, _ = make_apply(family, activation)
    return apply_fn, params


def make_system(
    family: str,
    key,
    nx: int,
    nu: int,
    X,
    U,
    hidden: int = 16,
    depth: int = 2,
    activation: str = None,
    sample_time: float = 1.0,
):
    """Create a NeuralDiscreteSystem of a zoo family with the activation
    recorded on the system (so checkpoints round-trip the exact dynamics,
    not the family default)."""
    from ..systems import NeuralDiscreteSystem

    apply_fn, params = init_model(
        family, key, nx, nu, hidden=hidden, depth=depth,
        activation=activation, sample_time=sample_time,
    )
    _, act = make_apply(family, activation)
    return NeuralDiscreteSystem(
        apply_fn=apply_fn, family=family, nx=nx, nu=nu,
        params=params, X=X, U=U, activation=act,
    )


def rollout(apply_fn: Callable, params: Any, x0: Array, u_seq: Array) -> Array:
    """Roll dynamics forward: u_seq (N, nu) → states (N+1, nx), via lax.scan."""

    def step(x, u):
        xn = apply_fn(params, x, u)
        return xn, xn

    _, xs = jax.lax.scan(step, x0, u_seq)
    return jnp.concatenate([x0[None, :], xs], axis=0)
