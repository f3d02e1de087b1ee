"""ctypes bindings for the native C++ QP reference solver (native/qpref).

The in-house f64 oracle / host fallback mirroring the reference's native
OSQP surface (solver_selection.jl:92-98). Builds the shared library from
native/qpref/qpref.cpp with ``make`` on first use (a C++17 compiler is the
only requirement; the library is not kept in git); no pybind11 needed.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional, Tuple

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)), "native", "qpref")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libqpref.so")

_lib = None


def _build() -> None:
    """Build libqpref.so from qpref.cpp with ``make``. Concurrent processes
    (test workers) serialize on a lock file, and the library is linked
    under a temporary name and renamed into place, so no process ever loads
    a half-written file."""
    import fcntl

    with open(os.path.join(_NATIVE_DIR, ".build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if _stale():
            tmp = f"libqpref.so.{os.getpid()}.tmp"
            subprocess.run(
                ["make", "-C", _NATIVE_DIR, f"OUT={tmp}"],
                check=True, capture_output=True, text=True,
            )
            os.replace(os.path.join(_NATIVE_DIR, tmp), _LIB_PATH)


def _stale() -> bool:
    src = os.path.join(_NATIVE_DIR, "qpref.cpp")
    return not os.path.exists(_LIB_PATH) or (
        os.path.exists(src) and os.path.getmtime(src) > os.path.getmtime(_LIB_PATH)
    )


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    if _stale():
        _build()
    lib = ctypes.CDLL(_LIB_PATH)
    dp = ctypes.POINTER(ctypes.c_double)
    ip = ctypes.POINTER(ctypes.c_int)
    lib.qpref_solve.restype = ctypes.c_int
    lib.qpref_solve.argtypes = [
        ctypes.c_int, ctypes.c_int, dp, dp, dp, dp, dp,
        ctypes.c_int, ctypes.c_double, ctypes.c_double, ctypes.c_double,
        ctypes.c_double, ctypes.c_double, dp, dp, ip, dp, dp,
    ]
    lib.qpref_solve_ipm.restype = ctypes.c_int
    lib.qpref_solve_ipm.argtypes = [
        ctypes.c_int, ctypes.c_int, dp, dp, dp, dp, dp,
        ctypes.c_int, ctypes.c_double, dp, dp, ip, dp, dp,
    ]
    lib.qpref_solve_batch.restype = ctypes.c_int
    lib.qpref_solve_batch.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, dp, dp, dp, dp, dp,
        ctypes.c_int, ctypes.c_double, ctypes.c_double, ctypes.c_double,
        ctypes.c_double, ctypes.c_double, dp, dp, ip, ip, dp, dp,
    ]
    lib.qpref_solve_miqp.restype = ctypes.c_int
    lib.qpref_solve_miqp.argtypes = [
        ctypes.c_int, ctypes.c_int, dp, dp, dp, dp, dp,
        ctypes.c_int, ip, ip,
        ctypes.c_int, ctypes.c_double, ctypes.c_double, ctypes.c_double,
        ctypes.c_double, ctypes.c_double, ctypes.c_int, ctypes.c_double,
        ctypes.c_double,
        dp, dp, dp, ip, ip,
    ]
    lib.qpref_solve_relu_bb.restype = ctypes.c_int
    lib.qpref_solve_relu_bb.argtypes = [
        ctypes.c_int, ctypes.c_int, dp, dp, dp, dp, dp,
        ctypes.c_int, ip, ip, ip, ip, dp, dp, dp,
        ctypes.c_int, ctypes.c_double, ctypes.c_double, ctypes.c_double,
        ctypes.c_double, ctypes.c_double, ctypes.c_int, ctypes.c_double,
        ctypes.c_double, dp,
        dp, dp, dp, ip, ip,
    ]
    _lib = lib
    return lib


def _dp(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def solve_qp(
    P: np.ndarray,
    q: np.ndarray,
    A: np.ndarray,
    l: np.ndarray,
    u: np.ndarray,
    max_iter: int = 20000,
    eps_abs: float = 1e-9,
    eps_rel: float = 1e-9,
    rho: float = 0.1,
    sigma: float = 1e-6,
    alpha: float = 1.6,
    z0: Optional[np.ndarray] = None,
    y0: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray, int, int, float, float]:
    """Solve min 0.5 z'Pz + q'z s.t. l <= Az <= u in f64 via the native lib.

    Returns (z, y, status, iterations, primal_residual, dual_residual);
    status codes match types.STATUS_*.
    """
    lib = _load()
    P = np.ascontiguousarray(P, np.float64)
    q = np.ascontiguousarray(q, np.float64)
    A = np.ascontiguousarray(A, np.float64)
    l = np.ascontiguousarray(l, np.float64)
    u = np.ascontiguousarray(u, np.float64)
    n = P.shape[0]
    m = A.shape[0]
    z = np.zeros(n) if z0 is None else np.ascontiguousarray(z0, np.float64).copy()
    y = np.zeros(m) if y0 is None else np.ascontiguousarray(y0, np.float64).copy()
    iters = ctypes.c_int(0)
    rp = ctypes.c_double(0.0)
    rd = ctypes.c_double(0.0)
    status = lib.qpref_solve(
        n, m, _dp(P), _dp(q), _dp(A), _dp(l), _dp(u),
        max_iter, eps_abs, eps_rel, rho, sigma, alpha,
        _dp(z), _dp(y), ctypes.byref(iters), ctypes.byref(rp), ctypes.byref(rd),
    )
    return z, y, int(status), int(iters.value), float(rp.value), float(rd.value)


def solve_qp_ipm(
    P: np.ndarray,
    q: np.ndarray,
    A: np.ndarray,
    l: np.ndarray,
    u: np.ndarray,
    max_iter: int = 100,
    tol: float = 1e-9,
    x0: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray, int, int, float, float]:
    """Dense Mehrotra predictor-corrector IPM (second-order): the node
    engine of the B&B searches, exposed for tests/direct use. Same problem
    form and status codes as :func:`solve_qp`; ~10-30 Newton iterations
    where the first-order ADMM needs thousands."""
    lib = _load()
    P = np.ascontiguousarray(P, np.float64)
    q = np.ascontiguousarray(q, np.float64)
    A = np.ascontiguousarray(A, np.float64)
    l = np.ascontiguousarray(l, np.float64)
    u = np.ascontiguousarray(u, np.float64)
    n = P.shape[0]
    m = A.shape[0]
    x = np.zeros(n) if x0 is None else np.ascontiguousarray(x0, np.float64).copy()
    y = np.zeros(m)
    iters = ctypes.c_int(0)
    rp = ctypes.c_double(0.0)
    rd = ctypes.c_double(0.0)
    status = lib.qpref_solve_ipm(
        n, m, _dp(P), _dp(q), _dp(A), _dp(l), _dp(u),
        max_iter, tol,
        _dp(x), _dp(y), ctypes.byref(iters), ctypes.byref(rp), ctypes.byref(rd),
    )
    return x, y, int(status), int(iters.value), float(rp.value), float(rd.value)


MIQP_OPTIMAL = 0
MIQP_NODE_LIMIT = 1
MIQP_INFEASIBLE = 2
# tree fully explored but >=1 subtree was cut without a certificate
# (stall-pruned node, or bound-pruned on an approximately-converged
# relaxation): incumbent is exact-ReLU feasible and optimal within the
# pruning slacks, but global optimality is not *certified*
MIQP_OPTIMAL_TOL = 3


def solve_miqp(
    P: np.ndarray,
    q: np.ndarray,
    A: np.ndarray,
    l: np.ndarray,
    u: np.ndarray,
    bin_rows: np.ndarray,
    bin_cols: np.ndarray,
    max_iter: int = 20000,
    eps_abs: float = 1e-9,
    eps_rel: float = 1e-9,
    rho: float = 0.1,
    sigma: float = 1e-6,
    alpha: float = 1.6,
    max_nodes: int = 100000,
    int_tol: float = 1e-5,
    time_limit: float = 0.0,
) -> Tuple[np.ndarray, np.ndarray, int, int, float]:
    """Branch-and-bound MIQP: z[bin_cols] binary, [0,1] boxes at A rows
    ``bin_rows``. The in-house stand-in for the reference's SCIP MILP
    back-end (solver_selection.jl:108-114). ``time_limit`` (seconds, <=0 =
    unlimited) bounds the B&B wall clock — the ``mpc_max_time`` budget the
    reference stored but never forwarded (solver_selection.jl:95).

    Returns (z, y, status in {MIQP_*}, nodes, objective)."""
    lib = _load()
    P = np.ascontiguousarray(P, np.float64)
    q = np.ascontiguousarray(q, np.float64)
    A = np.ascontiguousarray(A, np.float64)
    l = np.ascontiguousarray(l, np.float64)
    u = np.ascontiguousarray(u, np.float64)
    bin_rows = np.ascontiguousarray(bin_rows, np.int32)
    bin_cols = np.ascontiguousarray(bin_cols, np.int32)
    n = P.shape[0]
    m = A.shape[0]
    nb = bin_rows.shape[0]
    z = np.zeros(n)
    y = np.zeros(m)
    obj = ctypes.c_double(0.0)
    nodes = ctypes.c_int(0)
    status = ctypes.c_int(0)
    ip = ctypes.POINTER(ctypes.c_int)
    lib.qpref_solve_miqp(
        n, m, _dp(P), _dp(q), _dp(A), _dp(l), _dp(u),
        nb, bin_rows.ctypes.data_as(ip), bin_cols.ctypes.data_as(ip),
        max_iter, eps_abs, eps_rel, rho, sigma, alpha, max_nodes,
        float(time_limit), int_tol,
        _dp(z), _dp(y), ctypes.byref(obj), ctypes.byref(nodes),
        ctypes.byref(status),
    )
    return z, y, int(status.value), int(nodes.value), float(obj.value)


def solve_relu_bb(
    P: np.ndarray,
    q: np.ndarray,
    A: np.ndarray,
    l: np.ndarray,
    u: np.ndarray,
    row_ge: np.ndarray,
    row_a: np.ndarray,
    row_rbox: np.ndarray,
    col_r: np.ndarray,
    lo_a: np.ndarray,
    hi_a: np.ndarray,
    a_bias: Optional[np.ndarray] = None,
    max_iter: int = 20000,
    eps_abs: float = 1e-9,
    eps_rel: float = 1e-9,
    rho: float = 0.1,
    sigma: float = 1e-6,
    alpha: float = 1.6,
    max_nodes: int = 100000,
    phase_tol: float = 1e-6,
    time_limit: float = 0.0,
    z_init: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray, int, int, float]:
    """Exact-ReLU branch-and-bound (phase branching + triangle relaxation):
    the in-house stand-in for the reference's SCIP big-M MILP back-end
    (solver_selection.jl:108-114). Per unstable neuron: its r>=a row, its
    a-range row, its r box row, the r column, and [lo_a, hi_a] (a-space;
    ``a_bias`` is the affine constant c with row value = a - c).

    ``z_init`` (optional): a FEASIBLE phase-consistent point (e.g. a true
    rollout of the network under a warm input trajectory) that seeds the
    incumbent, so pruning bites from node 1 and limit exits return a
    feasible exact solution.

    Returns (z, y, status in {MIQP_*}, nodes, objective)."""
    lib = _load()
    P = np.ascontiguousarray(P, np.float64)
    q = np.ascontiguousarray(q, np.float64)
    A = np.ascontiguousarray(A, np.float64)
    l = np.ascontiguousarray(l, np.float64)
    u = np.ascontiguousarray(u, np.float64)
    row_ge = np.ascontiguousarray(row_ge, np.int32)
    row_a = np.ascontiguousarray(row_a, np.int32)
    row_rbox = np.ascontiguousarray(row_rbox, np.int32)
    col_r = np.ascontiguousarray(col_r, np.int32)
    lo_a = np.ascontiguousarray(lo_a, np.float64)
    hi_a = np.ascontiguousarray(hi_a, np.float64)
    if a_bias is None:
        a_bias = np.zeros_like(lo_a)
    a_bias = np.ascontiguousarray(a_bias, np.float64)
    n = P.shape[0]
    m = A.shape[0]
    nb = row_ge.shape[0]
    z = np.zeros(n)
    y = np.zeros(m)
    obj = ctypes.c_double(0.0)
    nodes = ctypes.c_int(0)
    status = ctypes.c_int(0)
    ip = ctypes.POINTER(ctypes.c_int)
    if z_init is not None:
        z_init = np.ascontiguousarray(z_init, np.float64)
    lib.qpref_solve_relu_bb(
        n, m, _dp(P), _dp(q), _dp(A), _dp(l), _dp(u),
        nb, row_ge.ctypes.data_as(ip), row_a.ctypes.data_as(ip),
        row_rbox.ctypes.data_as(ip), col_r.ctypes.data_as(ip),
        _dp(lo_a), _dp(hi_a), _dp(a_bias),
        max_iter, eps_abs, eps_rel, rho, sigma, alpha, max_nodes,
        float(time_limit), phase_tol,
        _dp(z_init) if z_init is not None else None,
        _dp(z), _dp(y), ctypes.byref(obj), ctypes.byref(nodes),
        ctypes.byref(status),
    )
    return z, y, int(status.value), int(nodes.value), float(obj.value)


def solve_qp_batch(
    P: np.ndarray,
    qs: np.ndarray,  # (B, n)
    A: np.ndarray,
    ls: np.ndarray,  # (B, m)
    us: np.ndarray,  # (B, m)
    **kw,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Batched solve sharing (P, A): the condensed-MPC runtime pattern.

    Returns (z (B,n), y (B,m), status (B,), iterations (B,))."""
    lib = _load()
    P = np.ascontiguousarray(P, np.float64)
    A = np.ascontiguousarray(A, np.float64)
    qs = np.ascontiguousarray(qs, np.float64)
    ls = np.ascontiguousarray(ls, np.float64)
    us = np.ascontiguousarray(us, np.float64)
    B, n = qs.shape
    m = A.shape[0]
    z = np.zeros((B, n))
    y = np.zeros((B, m))
    status = np.zeros(B, np.int32)
    iters = np.zeros(B, np.int32)
    rp = np.zeros(B)
    rd = np.zeros(B)
    ip = ctypes.POINTER(ctypes.c_int)
    lib.qpref_solve_batch(
        B, n, m, _dp(P), _dp(qs), _dp(A), _dp(ls), _dp(us),
        int(kw.get("max_iter", 20000)), float(kw.get("eps_abs", 1e-9)),
        float(kw.get("eps_rel", 1e-9)), float(kw.get("rho", 0.1)),
        float(kw.get("sigma", 1e-6)), float(kw.get("alpha", 1.6)),
        _dp(z), _dp(y), status.ctypes.data_as(ip), iters.ctypes.data_as(ip),
        _dp(rp), _dp(rd),
    )
    return z, y, status, iters
