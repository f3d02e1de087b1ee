"""Fused box-QP chunk kernel (ops/admm_pallas.py) vs the plain vmapped
engine, in the Pallas interpreter on the CPU, plus the wrapper around it:
padding, block choice, the route per platform and what it refuses. The
Triton compile at the real block config runs on the card (marker ``gpu``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import automationlabsmodelpredictivecontrol_jl_tpu as mpc
from automationlabsmodelpredictivecontrol_jl_tpu import parallel
from automationlabsmodelpredictivecontrol_jl_tpu.benchmarks import qtp
from automationlabsmodelpredictivecontrol_jl_tpu.ops import admm, admm_pallas
from automationlabsmodelpredictivecontrol_jl_tpu.ops.admm import AdmmConfig
from automationlabsmodelpredictivecontrol_jl_tpu.utils import devices

# the headline tier-1 config (n=40, R=2, no refinement) and the tier-2
# escalation config (R=4, 2 refinement steps), at horizon 20
TIER1 = AdmmConfig(max_iter=300, rho=1.0, rho_grid=(1.0, 10.0), refine_steps=0)
TIER2 = AdmmConfig(max_iter=300, rho=1.0, rho_grid=(0.1, 1.0, 10.0, 100.0),
                   refine_steps=2)


def _controller(cfg, N=20, **kw):
    return mpc.proceed_controller(
        qtp.linearized_discrete_system(), "model_predictive_control", N, 5.0,
        np.full(4, 0.65), np.full(2, 1.2), admm_config=cfg, **kw,
    )


@pytest.fixture(scope="module", params=["tier1", "tier2"])
def controller(request):
    return _controller({"tier1": TIER1, "tier2": TIER2}[request.param])


def _x0s(B, seed=0):
    rng = np.random.default_rng(seed)
    return jnp.asarray(
        np.clip(0.65 + 0.1 * rng.standard_normal((B, 4)), 0.3, 1.3), jnp.float32
    )


def _fused(c, x0s, wz=None, wy=None):
    return parallel.solve_batch_fused(c, x0s, wz, wy, interpret=True)


def test_fused_matches_reference_engine(controller):
    assert controller.engine.op.diag_a
    x0s = _x0s(8, seed=1)
    sol_ref, _, _, _ = parallel.solve_batch(controller, x0s)
    sol_f, _, _, diag_f = _fused(controller, x0s)
    assert int(diag_f.n_converged) == 8
    np.testing.assert_allclose(np.asarray(sol_f.u), np.asarray(sol_ref.u), atol=1e-4)
    np.testing.assert_allclose(np.asarray(sol_f.x), np.asarray(sol_ref.x), atol=5e-4)


def test_fused_batch_not_multiple_of_block(controller):
    """B=13 pads to one 64-lane block (last lane replicated) and slices
    back: every output keeps the caller's batch."""
    x0s = _x0s(13, seed=3)
    sol_ref, _, _, _ = parallel.solve_batch(controller, x0s)
    sol_f, wz, wy, diag_f = _fused(controller, x0s)
    assert sol_f.u.shape[0] == 13 and wz.shape[0] == 13 and wy.shape[0] == 13
    assert int(diag_f.n_total) == 13 and int(diag_f.n_converged) == 13
    np.testing.assert_allclose(np.asarray(sol_f.u), np.asarray(sol_ref.u), atol=1e-4)


def test_fused_warm_start(controller):
    x0s = _x0s(8, seed=2)
    sol1, wz, wy, d1 = _fused(controller, x0s)
    sol2, _, _, d2 = _fused(controller, x0s, wz, wy)
    assert float(d2.mean_iterations) <= float(d1.mean_iterations)
    assert int(d2.n_converged) == 8


def test_fused_rejects_non_diag_operator(controller):
    """State rows make A non-diagonal: the kernel refuses and names the
    vmapped engine instead of accepting an operator it does not take."""
    c = _controller(controller.engine.config, N=5, mpc_state_constraint=True)
    assert not c.engine.op.diag_a
    with pytest.raises(ValueError, match="solve_batch"):
        _fused(c, _x0s(8))


def _box_qp(n, seed=0):
    rng = np.random.default_rng(seed)
    M = rng.normal(size=(n, n))
    P = M @ M.T + 0.5 * np.eye(n)
    op = admm.build_operator(P, np.eye(n), np.zeros(n, bool), 0, TIER1)
    return rng, op


def test_padding_of_n_and_batch_slices_back():
    """n=6 pads to 16 columns and B=5 lanes to one 64-lane block; the
    padded columns stay exactly zero, so the sliced result equals the
    plain engine's per lane."""
    n, B = 6, 5
    rng, op = _box_qp(n)
    assert op.diag_a
    q = jnp.asarray(rng.normal(size=(B, n)), jnp.float32)
    l = jnp.full((B, n), -0.5, jnp.float32)
    u = jnp.full((B, n), 0.5, jnp.float32)
    z, y, s, st, it, rp, rd = admm_pallas.solve_batch_fused(
        op, q, l, u, config=TIER1, interpret=True
    )
    assert z.shape == (B, n) and y.shape == (B, n) and s.shape == (B, n)
    assert st.shape == it.shape == rp.shape == (B,)
    ref = jax.vmap(lambda qi: admm.solve(
        op, qi, l[0], u[0], jnp.zeros((0,)), jnp.asarray(0.0), config=TIER1
    ))(q)
    assert np.all(np.asarray(st) == 0) and np.all(np.asarray(ref.status) == 0)
    np.testing.assert_allclose(np.asarray(z), np.asarray(ref.z), atol=1e-4)


def test_stacked_operator_layout():
    """The stacked operand is [M_0^T; M_1^T; ..] with zero-padded rows,
    columns and grid slots: a lane whose row is spread into slot r
    multiplies exactly M_r^T."""
    rng = np.random.default_rng(0)
    mats = jnp.asarray(rng.normal(size=(3, 5, 5)), jnp.float32)
    st = np.asarray(admm_pallas._stacked(mats, 16, 4))
    assert st.shape == (64, 16)
    for r in range(3):
        np.testing.assert_array_equal(st[16 * r:16 * r + 5, :5], np.asarray(mats[r]).T)
        assert not st[16 * r + 5:16 * (r + 1)].any() and not st[16 * r:16 * (r + 1), 5:].any()
    assert not st[48:].any()  # the padded grid slot
    v = rng.normal(size=5).astype(np.float32)
    spread = np.zeros(64, np.float32)
    spread[32:37] = v
    np.testing.assert_allclose(spread @ st, np.pad(v @ np.asarray(mats[2]).T, (0, 11)),
                               rtol=1e-5, atol=1e-6)


def test_block_config_and_padding_widths():
    assert admm_pallas._pow2(40, 16) == 64 and admm_pallas._pow2(6, 16) == 16
    assert admm_pallas._pow2(2) == 2 and admm_pallas._pow2(5) == 8
    assert admm_pallas._pow2(1) == 1
    assert admm_pallas.block_config(64, 2) == (64, 8)  # headline tier 1
    assert admm_pallas.block_config(64, 4) == (64, 16)  # tier-2 grid


def test_route_per_platform(monkeypatch):
    """The kernel route exists only on the GPU; off it the fused solve
    refuses unless the caller asks for the interpreter."""
    assert devices.kernel_route("gpu") == "triton"
    assert devices.kernel_route("cpu") is None
    assert devices.kernel_route() is None  # the tests run on the CPU
    c = _controller(TIER1, N=5)
    with pytest.raises(ValueError, match="interpret=True"):
        parallel.solve_batch_fused(c, _x0s(4))
    assert not parallel.fused_supported(c)
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert devices.kernel_route() == "triton"
    assert parallel.fused_supported(c)


@pytest.mark.gpu
def test_kernel_compiles_on_gpu(gpu):
    """On the card: the Triton compile of the real block config at the
    headline width, compared once with the plain engine."""
    c = _controller(AdmmConfig(max_iter=75, rho=1.0, rho_grid=(1.0, 10.0),
                               refine_steps=0))
    x0s = _x0s(16384, seed=3)
    sol_f = jax.jit(lambda x: parallel.solve_batch_fused(c, x)[0])(x0s)
    sol_v = jax.jit(lambda x: parallel.solve_batch(c, x)[0])(x0s)
    both = (np.asarray(sol_f.status) == 0) & (np.asarray(sol_v.status) == 0)
    assert both.mean() > 0.8
    np.testing.assert_allclose(
        np.asarray(sol_f.u)[both], np.asarray(sol_v.u)[both], atol=1e-4
    )
