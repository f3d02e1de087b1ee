// qpref — in-house dense ADMM QP reference solver (double precision).
//
// The reference package reaches its native code through the OSQP C solver
// (solver_selection.jl:92-98). This is the framework's own native
// counterpart: an operator-splitting QP solver with the same algorithm
// family as the on-device f32 engine (ops/admm.py), but in f64 on the host.
// Roles: (a) independent golden oracle for parity tests, (b) CPU fallback
// runtime where no accelerator/JAX is present.
//
//   minimize   0.5 z'Pz + q'z
//   subject to l <= A z <= u      (rows with l == u are equalities)
//
// C ABI only — consumed via ctypes (no pybind11 in the image).

#include <algorithm>
#include <chrono>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <cstdio>
#include <limits>
#include <cstdlib>
#include <vector>

namespace {

// Dense Cholesky factorization (in place, lower). Returns 0 on success.
int cholesky(std::vector<double>& K, int n) {
  for (int j = 0; j < n; ++j) {
    double d = K[j * n + j];
    for (int k = 0; k < j; ++k) d -= K[j * n + k] * K[j * n + k];
    if (d <= 0.0) return 1;
    const double Ljj = std::sqrt(d);
    K[j * n + j] = Ljj;
    for (int i = j + 1; i < n; ++i) {
      double s = K[i * n + j];
      for (int k = 0; k < j; ++k) s -= K[i * n + k] * K[j * n + k];
      K[i * n + j] = s / Ljj;
    }
  }
  return 0;
}

void chol_solve(const std::vector<double>& L, int n, double* x) {
  for (int i = 0; i < n; ++i) {
    double s = x[i];
    for (int k = 0; k < i; ++k) s -= L[i * n + k] * x[k];
    x[i] = s / L[i * n + i];
  }
  for (int i = n - 1; i >= 0; --i) {
    double s = x[i];
    for (int k = i + 1; k < n; ++k) s -= L[k * n + i] * x[k];
    x[i] = s / L[i * n + i];
  }
}

inline double clamp(double v, double lo, double hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// Dense LU with partial pivoting; solves in place. Returns 0 on success.
int lu_solve(std::vector<double>& M, std::vector<double>& b, int n) {
  std::vector<int> piv(n);
  for (int i = 0; i < n; ++i) piv[i] = i;
  for (int k = 0; k < n; ++k) {
    int p = k;
    double mx = std::fabs(M[k * n + k]);
    for (int i = k + 1; i < n; ++i) {
      const double v = std::fabs(M[i * n + k]);
      if (v > mx) {
        mx = v;
        p = i;
      }
    }
    if (mx < 1e-14) return 1;
    if (p != k) {
      for (int j = 0; j < n; ++j) std::swap(M[k * n + j], M[p * n + j]);
      std::swap(b[k], b[p]);
    }
    const double inv = 1.0 / M[k * n + k];
    for (int i = k + 1; i < n; ++i) {
      const double f = M[i * n + k] * inv;
      if (f == 0.0) continue;
      M[i * n + k] = f;
      for (int j = k + 1; j < n; ++j) M[i * n + j] -= f * M[k * n + j];
      b[i] -= f * b[k];
    }
  }
  for (int i = n - 1; i >= 0; --i) {
    double s = b[i];
    for (int j = i + 1; j < n; ++j) s -= M[i * n + j] * b[j];
    b[i] = s / M[i * n + i];
  }
  return 0;
}

}  // namespace

extern "C" {

// Status codes match the Python engine (types.py STATUS_*).
enum QprefStatus {
  QPREF_CONVERGED = 0,
  QPREF_MAX_ITER = 1,
  QPREF_PRIMAL_INFEASIBLE = 2,
  QPREF_DUAL_INFEASIBLE = 3,
};

// Solve one QP. Arrays are row-major, caller-allocated.
//   P: n*n, q: n, A: m*n, l,u: m, z: n (in: warm start, out: solution),
//   y: m (in: warm start, out: duals).
// Returns a QprefStatus; *iters, *rprim, *rdual report the final state.
int qpref_solve(int n, int m, const double* P_in, const double* q_in,
                const double* A_in, const double* l_in, const double* u_in,
                int max_iter, double eps_abs, double eps_rel, double rho0,
                double sigma, double alpha, double* z, double* y, int* iters,
                double* rprim, double* rdual) {
  const double kEqRhoScale = 1e3;
  const double kEpsInfeas = 1e-7;
  const int kRuizIters = 10;

  // --- modified Ruiz equilibration (OSQP §5): P_s = c D P D, A_s = E A D ---
  std::vector<double> P(P_in, P_in + static_cast<size_t>(n) * n);
  std::vector<double> A(A_in, A_in + static_cast<size_t>(m) * n);
  std::vector<double> D(n, 1.0), E(m, 1.0);
  double c = 1.0;
  {
    std::vector<double> d(n), e(m);
    for (int sweep = 0; sweep < kRuizIters; ++sweep) {
      for (int j = 0; j < n; ++j) {
        double cn = 0.0;
        for (int i = 0; i < n; ++i) cn = std::max(cn, std::fabs(P[i * n + j]));
        for (int r = 0; r < m; ++r) cn = std::max(cn, std::fabs(A[r * n + j]));
        d[j] = cn > 1e-12 ? 1.0 / std::sqrt(clamp(cn, 1e-8, 1e8)) : 1.0;
      }
      for (int r = 0; r < m; ++r) {
        double rn = 0.0;
        for (int j = 0; j < n; ++j) rn = std::max(rn, std::fabs(A[r * n + j]));
        e[r] = rn > 1e-12 ? 1.0 / std::sqrt(clamp(rn, 1e-8, 1e8)) : 1.0;
      }
      for (int i = 0; i < n; ++i)
        for (int j = 0; j < n; ++j) P[i * n + j] *= d[i] * d[j];
      for (int r = 0; r < m; ++r)
        for (int j = 0; j < n; ++j) A[r * n + j] *= e[r] * d[j];
      for (int j = 0; j < n; ++j) D[j] *= d[j];
      for (int r = 0; r < m; ++r) E[r] *= e[r];
      double mean_col = 0.0;
      for (int j = 0; j < n; ++j) {
        double cn = 0.0;
        for (int i = 0; i < n; ++i) cn = std::max(cn, std::fabs(P[i * n + j]));
        mean_col += cn;
      }
      mean_col /= n;
      const double gamma = 1.0 / clamp(std::max(mean_col, 1e-8), 1e-8, 1e8);
      for (size_t i = 0; i < P.size(); ++i) P[i] *= gamma;
      c *= gamma;
    }
  }
  // scaled vectors: q_s = c D q, l_s = E l, u_s = E u
  std::vector<double> q(n), l(m), u(m);
  for (int j = 0; j < n; ++j) q[j] = c * D[j] * q_in[j];
  for (int r = 0; r < m; ++r) {
    l[r] = std::isfinite(l_in[r]) ? E[r] * l_in[r] : l_in[r];
    u[r] = std::isfinite(u_in[r]) ? E[r] * u_in[r] : u_in[r];
  }

  std::vector<bool> is_eq(m);
  for (int i = 0; i < m; ++i)
    is_eq[i] =
        std::isfinite(l[i]) && std::isfinite(u[i]) && l_in[i] == u_in[i];

  // K = P_s + sigma I + A_s' diag(rho) A_s; refactorized when the OSQP-style
  // rho adaptation (§5.2 of the OSQP paper) changes the penalty by >5x —
  // the adaptation is what keeps degenerate node QPs (branch-and-bound
  // subproblems with phase-fixed rows) from crawling.
  double rho_cur = rho0;
  std::vector<double> rho(m), rho_inv(m);
  std::vector<double> K(static_cast<size_t>(n) * n);
  auto factorize = [&]() -> int {
    for (int i = 0; i < m; ++i) {
      rho[i] = is_eq[i] ? rho_cur * kEqRhoScale : rho_cur;
      rho_inv[i] = 1.0 / rho[i];
    }
    for (int i = 0; i < n; ++i)
      for (int j = 0; j < n; ++j) {
        double s = P[i * n + j] + (i == j ? sigma : 0.0);
        for (int r = 0; r < m; ++r) s += A[r * n + i] * rho[r] * A[r * n + j];
        K[i * n + j] = s;
      }
    return cholesky(K, n);
  };
  // factorization-failure exits must still report a stall to the caller:
  // leave z/y untouched but write huge residuals + zero iters so B&B
  // callers never classify the node as a near-converged relaxation.
  auto fail_exit = [&]() -> QprefStatus {
    *iters = 0;
    *rprim = 1e300;
    *rdual = 1e300;
    return QPREF_MAX_ITER;
  };
  if (factorize() != 0) return fail_exit();

  // warm start into scaled space: x_s = z / D, y_s = c y / E
  std::vector<double> x(n), yv(m);
  for (int j = 0; j < n; ++j) x[j] = z[j] / D[j];
  for (int r = 0; r < m; ++r) yv[r] = c * y[r] / E[r];
  std::vector<double> s_vec(m), Ax(m), xt(n), st(m), rhs(n), x_prev(n),
      y_prev(m);

  auto matvec_A = [&](const std::vector<double>& v, std::vector<double>& out) {
    for (int r = 0; r < m; ++r) {
      double acc = 0.0;
      for (int j = 0; j < n; ++j) acc += A[r * n + j] * v[j];
      out[r] = acc;
    }
  };

  matvec_A(x, Ax);
  for (int r = 0; r < m; ++r)
    s_vec[r] = clamp(Ax[r] + rho_inv[r] * yv[r], l[r], u[r]);

  int it = 0;
  int status = QPREF_MAX_ITER;
  double rp = 0.0, rd = 0.0;
  for (it = 1; it <= max_iter; ++it) {
    x_prev = x;
    y_prev = yv;

    // x-update: K xt = sigma x - q + A'(rho .* s - y)
    for (int j = 0; j < n; ++j) rhs[j] = sigma * x[j] - q[j];
    for (int r = 0; r < m; ++r) {
      const double w = rho[r] * s_vec[r] - yv[r];
      for (int j = 0; j < n; ++j) rhs[j] += A[r * n + j] * w;
    }
    xt = rhs;
    chol_solve(K, n, xt.data());
    matvec_A(xt, st);

    for (int j = 0; j < n; ++j) x[j] = alpha * xt[j] + (1.0 - alpha) * x[j];
    for (int r = 0; r < m; ++r) {
      const double v = alpha * st[r] + (1.0 - alpha) * s_vec[r];
      const double sn = clamp(v + rho_inv[r] * yv[r], l[r], u[r]);
      yv[r] += rho[r] * (v - sn);
      s_vec[r] = sn;
    }

    if (it % 10 == 0 || it == max_iter) {
      // all residuals / certificates in UNSCALED quantities
      matvec_A(x, Ax);
      rp = 0.0;
      double ax_n = 0.0, s_n = 0.0;
      for (int r = 0; r < m; ++r) {
        const double ei = 1.0 / E[r];
        rp = std::max(rp, std::fabs(ei * (Ax[r] - s_vec[r])));
        ax_n = std::max(ax_n, std::fabs(ei * Ax[r]));
        s_n = std::max(s_n, std::fabs(ei * s_vec[r]));
      }
      rd = 0.0;
      double px_n = 0.0, aty_n = 0.0, q_n = 0.0;
      for (int j = 0; j < n; ++j) {
        double px = 0.0;
        for (int k = 0; k < n; ++k) px += P[j * n + k] * x[k];
        double aty = 0.0;
        for (int r = 0; r < m; ++r) aty += A[r * n + j] * yv[r];
        const double di = 1.0 / (c * D[j]);
        rd = std::max(rd, std::fabs(di * (px + q[j] + aty)));
        px_n = std::max(px_n, std::fabs(di * px));
        aty_n = std::max(aty_n, std::fabs(di * aty));
        q_n = std::max(q_n, std::fabs(di * q[j]));
      }
      const double eps_p = eps_abs + eps_rel * std::max(ax_n, s_n);
      const double eps_d = eps_abs + eps_rel * std::max(q_n, std::max(px_n, aty_n));
      if (rp <= eps_p && rd <= eps_d) {
        status = QPREF_CONVERGED;
        break;
      }

      // OSQP rho adaptation: rho <- rho sqrt(rp_rel / rd_rel), refactorize
      // only on >5x change
      {
        const double rp_rel = rp / std::max({ax_n, s_n, 1e-12});
        const double rd_rel = rd / std::max({q_n, px_n, aty_n, 1e-12});
        if (rd_rel > 1e-16 && rp_rel > 1e-16) {
          const double scale = std::sqrt(rp_rel / rd_rel);
          if (scale > 5.0 || scale < 0.2) {
            rho_cur = clamp(rho_cur * scale, 1e-6, 1e6);
            // mid-iteration refactorization failure: report the stall with
            // the residuals measured just above (rp/rd are current) and
            // unscale the iterate so the caller never sees scaled-space z/y
            if (factorize() != 0) {
              for (int j = 0; j < n; ++j) z[j] = D[j] * x[j];
              for (int r = 0; r < m; ++r) y[r] = E[r] * yv[r] / c;
              *iters = it;
              *rprim = 1e300;
              *rdual = rd;
              return QPREF_MAX_ITER;
            }
          }
        }
      }

      // primal infeasibility certificate from the unscaled dual delta
      double dy_n = 0.0, atdy = 0.0, support = 0.0;
      bool support_finite = true;
      for (int r = 0; r < m; ++r) {
        const double dy = E[r] * (yv[r] - y_prev[r]) / c;
        dy_n = std::max(dy_n, std::fabs(dy));
        if (dy > 0.0) {
          if (std::isfinite(u_in[r])) support += u_in[r] * dy;
          else support_finite = false;
        } else if (dy < 0.0) {
          if (std::isfinite(l_in[r])) support += l_in[r] * dy;
          else support_finite = false;
        }
      }
      for (int j = 0; j < n; ++j) {
        double acc = 0.0;
        for (int r = 0; r < m; ++r)
          acc += A_in[r * n + j] * E[r] * (yv[r] - y_prev[r]) / c;
        atdy = std::max(atdy, std::fabs(acc));
      }
      if (dy_n > 1e-14 && atdy <= kEpsInfeas * dy_n && support_finite &&
          support <= -kEpsInfeas * dy_n) {
        status = QPREF_PRIMAL_INFEASIBLE;
        break;
      }

      // dual infeasibility certificate from the unscaled primal delta
      double dx_n = 0.0, pdx_n = 0.0, qdx = 0.0;
      bool dir_ok = true;
      std::vector<double> dxu(n);
      for (int j = 0; j < n; ++j) {
        dxu[j] = D[j] * (x[j] - x_prev[j]);
        dx_n = std::max(dx_n, std::fabs(dxu[j]));
        qdx += q_in[j] * dxu[j];
      }
      for (int j = 0; j < n; ++j) {
        double pdx = 0.0;
        for (int k = 0; k < n; ++k) pdx += P_in[j * n + k] * dxu[k];
        pdx_n = std::max(pdx_n, std::fabs(pdx));
      }
      for (int r = 0; r < m && dir_ok; ++r) {
        double adx = 0.0;
        for (int j = 0; j < n; ++j) adx += A_in[r * n + j] * dxu[j];
        if (std::isfinite(u_in[r]) && adx > kEpsInfeas * dx_n) dir_ok = false;
        if (std::isfinite(l_in[r]) && adx < -kEpsInfeas * dx_n) dir_ok = false;
      }
      if (dx_n > 1e-14 && pdx_n <= kEpsInfeas * dx_n &&
          qdx <= -kEpsInfeas * dx_n && dir_ok) {
        status = QPREF_DUAL_INFEASIBLE;
        break;
      }
    }
  }

  // unscale: z = D x_s, y = E y_s / c
  for (int j = 0; j < n; ++j) z[j] = D[j] * x[j];
  for (int r = 0; r < m; ++r) y[r] = E[r] * yv[r] / c;

  // --- polish (OSQP §5.2): exact KKT solve on the detected active set ----
  if (status == QPREF_CONVERGED || status == QPREF_MAX_ITER) {
    std::vector<int> act;   // active row indices
    std::vector<double> bact, sign;  // bound value, +1 upper / -1 lower
    for (int r = 0; r < m; ++r) {
      if (y[r] > 1e-10 && std::isfinite(u_in[r])) {
        act.push_back(r);
        bact.push_back(u_in[r]);
      } else if (y[r] < -1e-10 && std::isfinite(l_in[r])) {
        act.push_back(r);
        bact.push_back(l_in[r]);
      }
    }
    const int ma = static_cast<int>(act.size());
    const int nk = n + ma;
    if (ma <= n) {
      std::vector<double> KKT(static_cast<size_t>(nk) * nk, 0.0), rhs2(nk);
      for (int i = 0; i < n; ++i)
        for (int j = 0; j < n; ++j) KKT[i * nk + j] = P_in[i * n + j];
      for (int a = 0; a < ma; ++a) {
        const int r = act[a];
        for (int j = 0; j < n; ++j) {
          KKT[j * nk + (n + a)] = A_in[r * n + j];
          KKT[(n + a) * nk + j] = A_in[r * n + j];
        }
      }
      for (int j = 0; j < n; ++j) rhs2[j] = -q_in[j];
      for (int a = 0; a < ma; ++a) rhs2[n + a] = bact[a];
      if (lu_solve(KKT, rhs2, nk) == 0) {
        // accept if the polished point has better residuals
        double rp_p = 0.0, rd_p = 0.0;
        std::vector<double> y_p(m, 0.0);
        for (int a = 0; a < ma; ++a) y_p[act[a]] = rhs2[n + a];
        for (int r = 0; r < m; ++r) {
          double az = 0.0;
          for (int j = 0; j < n; ++j) az += A_in[r * n + j] * rhs2[j];
          const double lo = std::isfinite(l_in[r]) ? l_in[r] : -1e300;
          const double hi = std::isfinite(u_in[r]) ? u_in[r] : 1e300;
          rp_p = std::max(rp_p, std::max(lo - az, az - hi));
        }
        for (int j = 0; j < n; ++j) {
          double g = q_in[j];
          for (int k = 0; k < n; ++k) g += P_in[j * n + k] * rhs2[k];
          for (int r = 0; r < m; ++r) g += A_in[r * n + j] * y_p[r];
          rd_p = std::max(rd_p, std::fabs(g));
        }
        if (rp_p <= std::max(rp, eps_abs) && rd_p < rd) {
          std::memcpy(z, rhs2.data(), sizeof(double) * n);
          std::memcpy(y, y_p.data(), sizeof(double) * m);
          rp = std::max(rp_p, 0.0);
          rd = rd_p;
          if (rp <= eps_abs * 10 && rd <= eps_abs * 10)
            status = QPREF_CONVERGED;
        }
      }
    }
  }
  *iters = it > max_iter ? max_iter : it;
  *rprim = rp;
  *rdual = rd;
  return status;
}

// ---------------------------------------------------------------------------
// MIQP branch-and-bound: min 0.5 z'Pz + q'z  s.t. l <= Az <= u,
// z[bin_cols[i]] in {0,1}. This is the framework's in-house counterpart of
// the SCIP branch-and-bound MILP back-end the reference reaches for its
// big-M ReLU transcriptions (solver_selection.jl:108-114, fnn/...:193-330).
// Depth-first best-child-first search; node relaxations solved by the ADMM
// engine above (warm-started, polished). Each binary's [0,1] box must be a
// dedicated row of A, identified by bin_rows[i], which the search tightens
// per node.
//
// Returns: 0 optimal (within tolerances), 1 node-limit hit (best incumbent
// returned), 2 no integer-feasible point found.
// ---------------------------------------------------------------------------

// ---------------------------------------------------------------------------
// Dense Mehrotra predictor-corrector interior-point QP solver.
//
//   minimize   0.5 x'Px + q'x
//   subject to l <= A x <= u   (rows with finite l == u are equalities)
//
// Second-order node engine for the branch-and-bound searches below: a node
// relaxation that costs the ADMM engine tens of thousands of first-order
// iterations converges here in ~10-30 Newton steps (one n*n Cholesky each),
// so the tree closes its gap inside the reference's mpc_max_time budget.
// The ADMM engine stays as the fallback — it carries the infeasibility
// certificates (IPM detects infeasibility only heuristically).
// ---------------------------------------------------------------------------
int qpref_solve_ipm(int n, int m, const double* P, const double* q,
                    const double* A, const double* l, const double* u,
                    int max_iter, double tol, double* x_out, double* y_out,
                    int* iters, double* rprim, double* rdual) {
  const double kInf = std::numeric_limits<double>::infinity();
  // row classification
  std::vector<int> eq, ineq;
  std::vector<int> hasL, hasU;  // per ineq row
  for (int r = 0; r < m; ++r) {
    const bool fl = std::isfinite(l[r]), fu = std::isfinite(u[r]);
    if (fl && fu && l[r] == u[r]) {
      eq.push_back(r);
    } else if (fl || fu) {
      ineq.push_back(r);
      hasL.push_back(fl ? 1 : 0);
      hasU.push_back(fu ? 1 : 0);
    }
  }
  const int me = static_cast<int>(eq.size());
  const int mi = static_cast<int>(ineq.size());
  int mc = 0;  // complementarity pairs
  for (int k = 0; k < mi; ++k) mc += hasL[k] + hasU[k];
  if (mc == 0 && me == 0) {
    // unconstrained QP: one Newton solve
    std::vector<double> H(P, P + static_cast<size_t>(n) * n), rhs(q, q + n);
    for (int j = 0; j < n; ++j) {
      H[j * n + j] += 1e-10;
      rhs[j] = -rhs[j];
    }
    if (lu_solve(H, rhs, n) != 0) return QPREF_MAX_ITER;
    std::memcpy(x_out, rhs.data(), sizeof(double) * n);
    std::fill(y_out, y_out + m, 0.0);
    *iters = 1;
    *rprim = 0.0;
    *rdual = 0.0;
    return QPREF_CONVERGED;
  }

  // scale guard for relative tolerances
  double q_n = 0.0;
  for (int j = 0; j < n; ++j) q_n = std::max(q_n, std::fabs(q[j]));
  double b_n = 1.0;
  for (int r = 0; r < m; ++r) {
    if (std::isfinite(l[r])) b_n = std::max(b_n, std::fabs(l[r]));
    if (std::isfinite(u[r])) b_n = std::max(b_n, std::fabs(u[r]));
  }

  std::vector<double> x(x_out, x_out + n), nu(me, 0.0);
  std::vector<double> sL(mi, 0.0), zL(mi, 0.0), sU(mi, 0.0), zU(mi, 0.0);
  std::vector<double> Ax(m);
  auto matvec_rows = [&](const std::vector<double>& v) {
    for (int r = 0; r < m; ++r) {
      double acc = 0.0;
      for (int j = 0; j < n; ++j) acc += A[static_cast<size_t>(r) * n + j] * v[j];
      Ax[r] = acc;
    }
  };
  matvec_rows(x);
  const double s0 = std::max(1.0, 0.1 * b_n);
  for (int k = 0; k < mi; ++k) {
    const int r = ineq[k];
    if (hasL[k]) {
      sL[k] = std::max(Ax[r] - l[r], s0);
      zL[k] = s0;
    }
    if (hasU[k]) {
      sU[k] = std::max(u[r] - Ax[r], s0);
      zU[k] = s0;
    }
  }

  std::vector<double> H(static_cast<size_t>(n) * n);
  std::vector<double> rd(n), re(me), rl(mi), ru(mi);
  std::vector<double> rhs1(n), hx(n), dx(n), dnu(me);
  std::vector<double> dsL(mi), dzL(mi), dsU(mi), dzU(mi);
  std::vector<double> dsL_a(mi), dzL_a(mi), dsU_a(mi), dzU_a(mi);
  std::vector<double> AeHiAe, Hi_rhs(n), Hi_Ae;
  std::vector<double> Snu;

  int it = 0;
  double rp_inf = kInf, rd_inf = kInf, mu = kInf;
  // every exit path must surface the current iterate (a zero x_out from an
  // early return would read as a spurious stationary point to callers)
  auto finish = [&](int status) {
    std::memcpy(x_out, x.data(), sizeof(double) * n);
    std::fill(y_out, y_out + m, 0.0);
    for (int e = 0; e < me; ++e) y_out[eq[e]] = nu[e];
    for (int k = 0; k < mi; ++k) y_out[ineq[k]] = zU[k] - zL[k];
    *iters = std::min(it, max_iter);
    *rprim = rp_inf;
    *rdual = rd_inf;
    return status;
  };
  for (it = 1; it <= max_iter; ++it) {
    // residuals
    matvec_rows(x);
    rp_inf = 0.0;
    for (int e = 0; e < me; ++e) {
      re[e] = Ax[eq[e]] - l[eq[e]];
      rp_inf = std::max(rp_inf, std::fabs(re[e]));
    }
    for (int k = 0; k < mi; ++k) {
      const int r = ineq[k];
      if (hasL[k]) {
        rl[k] = Ax[r] - sL[k] - l[r];
        rp_inf = std::max(rp_inf, std::fabs(rl[k]));
      }
      if (hasU[k]) {
        ru[k] = Ax[r] + sU[k] - u[r];
        rp_inf = std::max(rp_inf, std::fabs(ru[k]));
      }
    }
    rd_inf = 0.0;
    for (int j = 0; j < n; ++j) {
      double g = q[j];
      for (int k2 = 0; k2 < n; ++k2) g += P[j * n + k2] * x[k2];
      for (int e = 0; e < me; ++e)
        g += A[static_cast<size_t>(eq[e]) * n + j] * nu[e];
      for (int k = 0; k < mi; ++k)
        g += A[static_cast<size_t>(ineq[k]) * n + j] * (zU[k] - zL[k]);
      rd[j] = g;
      rd_inf = std::max(rd_inf, std::fabs(g));
    }
    double gap = 0.0;
    for (int k = 0; k < mi; ++k) gap += sL[k] * zL[k] + sU[k] * zU[k];
    mu = mc > 0 ? gap / mc : 0.0;

    const double eps_p = tol * (1.0 + b_n);
    const double eps_d = tol * (1.0 + q_n);
    if (rp_inf <= eps_p && rd_inf <= eps_d && mu <= tol * (1.0 + q_n)) break;
    // divergence heuristic (infeasible / unbounded node): duals blowing up
    // while the primal residual refuses to close
    double z_n = 0.0;
    for (int k = 0; k < mi; ++k) z_n = std::max({z_n, zL[k], zU[k]});
    for (int e = 0; e < me; ++e) z_n = std::max(z_n, std::fabs(nu[e]));
    if (z_n > 1e12 && rp_inf > eps_p) {
      return finish(QPREF_MAX_ITER);
    }

    // H = P + Ai' W Ai + delta I, one factorization per iteration
    std::memcpy(H.data(), P, sizeof(double) * n * n);
    for (int k = 0; k < mi; ++k) {
      double w = 0.0;
      // clamp slacks away from underflow so W stays finite near convergence
      if (hasL[k]) w += zL[k] / std::max(sL[k], 1e-14);
      if (hasU[k]) w += zU[k] / std::max(sU[k], 1e-14);
      w = std::min(w, 1e14);
      if (w == 0.0) continue;
      const double* ar = A + static_cast<size_t>(ineq[k]) * n;
      for (int i = 0; i < n; ++i) {
        if (ar[i] == 0.0) continue;
        const double wai = w * ar[i];
        for (int j = 0; j < n; ++j) H[i * n + j] += wai * ar[j];
      }
    }
    double reg = 1e-9;
    std::vector<double> Hf;
    for (int attempt = 0; attempt < 4; ++attempt) {
      Hf = H;
      for (int j = 0; j < n; ++j) Hf[j * n + j] += reg;
      if (cholesky(Hf, n) == 0) break;
      reg *= 1e3;
      if (attempt == 3) return finish(QPREF_MAX_ITER);
    }
    // Schur complement over the equality block: S = Ae H^-1 Ae' + delta I
    if (me > 0) {
      Hi_Ae.assign(static_cast<size_t>(me) * n, 0.0);
      for (int e = 0; e < me; ++e) {
        double* col = Hi_Ae.data() + static_cast<size_t>(e) * n;
        const double* ar = A + static_cast<size_t>(eq[e]) * n;
        std::memcpy(col, ar, sizeof(double) * n);
        chol_solve(Hf, n, col);
      }
      Snu.assign(static_cast<size_t>(me) * me, 0.0);
      for (int e = 0; e < me; ++e)
        for (int f = 0; f <= e; ++f) {
          double s = 0.0;
          const double* arf = A + static_cast<size_t>(eq[f]) * n;
          const double* he = Hi_Ae.data() + static_cast<size_t>(e) * n;
          for (int j = 0; j < n; ++j) s += arf[j] * he[j];
          Snu[e * me + f] = s;
          Snu[f * me + e] = s;
        }
      for (int e = 0; e < me; ++e) Snu[e * me + e] += 1e-10;
      if (cholesky(Snu, me) != 0) return finish(QPREF_MAX_ITER);
    }

    // one Newton solve of the reduced system for a given complementarity
    // target rc* (predictor: rc = -s.z; corrector adds sigma*mu - ds.dz)
    auto newton = [&](const std::vector<double>& rcL,
                      const std::vector<double>& rcU) {
      for (int j = 0; j < n; ++j) rhs1[j] = -rd[j];
      for (int k = 0; k < mi; ++k) {
        const int r = ineq[k];
        double t = 0.0;
        if (hasU[k]) t += (rcU[k] + zU[k] * ru[k]) / sU[k];
        if (hasL[k]) t -= (rcL[k] - zL[k] * rl[k]) / sL[k];
        if (t == 0.0) continue;
        const double* ar = A + static_cast<size_t>(r) * n;
        for (int j = 0; j < n; ++j) rhs1[j] -= ar[j] * t;
      }
      if (me == 0) {
        dx = rhs1;
        chol_solve(Hf, n, dx.data());
      } else {
        Hi_rhs = rhs1;
        chol_solve(Hf, n, Hi_rhs.data());
        for (int e = 0; e < me; ++e) {
          double s = re[e];
          const double* ar = A + static_cast<size_t>(eq[e]) * n;
          for (int j = 0; j < n; ++j) s += ar[j] * Hi_rhs[j];
          dnu[e] = s;
        }
        chol_solve(Snu, me, dnu.data());
        dx = rhs1;
        for (int e = 0; e < me; ++e) {
          const double* ar = A + static_cast<size_t>(eq[e]) * n;
          for (int j = 0; j < n; ++j) dx[j] -= ar[j] * dnu[e];
        }
        chol_solve(Hf, n, dx.data());
      }
      for (int k = 0; k < mi; ++k) {
        const int r = ineq[k];
        double adx = 0.0;
        const double* ar = A + static_cast<size_t>(r) * n;
        for (int j = 0; j < n; ++j) adx += ar[j] * dx[j];
        if (hasL[k]) {
          dsL[k] = adx + rl[k];
          dzL[k] = (rcL[k] - zL[k] * dsL[k]) / sL[k];
        }
        if (hasU[k]) {
          dsU[k] = -adx - ru[k];
          dzU[k] = (rcU[k] - zU[k] * dsU[k]) / sU[k];
        }
      }
    };

    auto step_len = [&](double frac) {
      double ap = 1.0, ad = 1.0;
      for (int k = 0; k < mi; ++k) {
        if (hasL[k]) {
          if (dsL[k] < 0.0) ap = std::min(ap, -frac * sL[k] / dsL[k]);
          if (dzL[k] < 0.0) ad = std::min(ad, -frac * zL[k] / dzL[k]);
        }
        if (hasU[k]) {
          if (dsU[k] < 0.0) ap = std::min(ap, -frac * sU[k] / dsU[k]);
          if (dzU[k] < 0.0) ad = std::min(ad, -frac * zU[k] / dzU[k]);
        }
      }
      return std::make_pair(ap, ad);
    };

    // predictor (affine) step
    std::vector<double> rcL(mi, 0.0), rcU(mi, 0.0);
    for (int k = 0; k < mi; ++k) {
      if (hasL[k]) rcL[k] = -sL[k] * zL[k];
      if (hasU[k]) rcU[k] = -sU[k] * zU[k];
    }
    newton(rcL, rcU);
    dsL_a = dsL;
    dzL_a = dzL;
    dsU_a = dsU;
    dzU_a = dzU;
    auto [ap_a, ad_a] = step_len(1.0);
    double gap_aff = 0.0;
    for (int k = 0; k < mi; ++k) {
      if (hasL[k])
        gap_aff += (sL[k] + ap_a * dsL_a[k]) * (zL[k] + ad_a * dzL_a[k]);
      if (hasU[k])
        gap_aff += (sU[k] + ap_a * dsU_a[k]) * (zU[k] + ad_a * dzU_a[k]);
    }
    const double mu_aff = mc > 0 ? gap_aff / mc : 0.0;
    const double ratio = mu > 1e-300 ? mu_aff / mu : 0.0;
    const double sigma_c = clamp(ratio * ratio * ratio, 1e-8, 1.0 - 1e-8);

    // corrector step (same factorization)
    for (int k = 0; k < mi; ++k) {
      if (hasL[k]) rcL[k] = -sL[k] * zL[k] + sigma_c * mu - dsL_a[k] * dzL_a[k];
      if (hasU[k]) rcU[k] = -sU[k] * zU[k] + sigma_c * mu - dsU_a[k] * dzU_a[k];
    }
    newton(rcL, rcU);
    auto [ap, ad] = step_len(0.995);

    for (int j = 0; j < n; ++j) x[j] += ap * dx[j];
    for (int e = 0; e < me; ++e) nu[e] += ad * dnu[e];
    for (int k = 0; k < mi; ++k) {
      if (hasL[k]) {
        sL[k] += ap * dsL[k];
        zL[k] += ad * dzL[k];
      }
      if (hasU[k]) {
        sU[k] += ap * dsU[k];
        zU[k] += ad * dzU[k];
      }
    }
    // stalled steps: complementarity can't move — bail to the fallback
    if (ap < 1e-10 && ad < 1e-10) {
      ++it;
      break;
    }
  }

  const bool ok = rp_inf <= tol * (1.0 + b_n) && rd_inf <= tol * (1.0 + q_n) &&
                  mu <= tol * (1.0 + q_n);
  return finish(ok ? QPREF_CONVERGED : QPREF_MAX_ITER);
}

namespace {

double qp_objective(int n, const double* P, const double* q, const double* z) {
  double obj = 0.0;
  for (int i = 0; i < n; ++i) {
    double pz = 0.0;
    for (int j = 0; j < n; ++j) pz += P[i * n + j] * z[j];
    obj += z[i] * (0.5 * pz + q[i]);
  }
  return obj;
}

// Node relaxation solve for the branch-and-bound searches: IPM first
// (second-order, ~20 Newton steps), ADMM fallback when the IPM stalls or
// suspects infeasibility (the ADMM engine carries rigorous primal/dual
// infeasibility certificates the tree needs for sound pruning).
int solve_node(int n, int m, const double* P, const double* q,
               const double* A, const double* l, const double* u,
               int max_iter, double eps_abs, double eps_rel, double rho0,
               double sigma, double alpha, double ipm_tol,
               std::vector<double>& zn, std::vector<double>& yn, int* iters,
               double* rp, double* rd) {
  std::vector<double> zi = zn, yi = yn;
  int st = qpref_solve_ipm(n, m, P, q, A, l, u, 100, ipm_tol, zi.data(),
                           yi.data(), iters, rp, rd);
  if (st == QPREF_CONVERGED) {
    zn = zi;
    yn = yi;
    return st;
  }
  // fallback exists to *certify* (infeasibility, or the rare IPM stall):
  // certificates fire within a few thousand first-order iterations, so cap
  // the budget — an uncapped fallback can burn tens of seconds on a single
  // infeasible node while costing the tree its whole time limit
  const int fb_iter = std::min(max_iter, 5000);
  st = qpref_solve(n, m, P, q, A, l, u, fb_iter, eps_abs, eps_rel, rho0,
                   sigma, alpha, zn.data(), yn.data(), iters, rp, rd);
  return st;
}

}  // namespace

enum MiqpStatus {
  MIQP_OPTIMAL = 0,
  MIQP_NODE_LIMIT = 1,
  MIQP_INFEASIBLE = 2,
  // tree fully explored but at least one subtree was cut without a
  // certificate (stall-pruned node or bound-pruned on an approximately
  // converged relaxation): the incumbent is exact-feasible and optimal
  // within the pruning slacks, but global optimality is not certified
  MIQP_OPTIMAL_TOL = 3,
};

int qpref_solve_miqp(int n, int m, const double* P, const double* q,
                     const double* A, const double* l_in, const double* u_in,
                     int nb, const int* bin_rows, const int* bin_cols,
                     int max_iter, double eps_abs, double eps_rel, double rho0,
                     double sigma, double alpha, int max_nodes,
                     double time_limit, double int_tol,
                     double* z, double* y, double* obj_out, int* nodes_out,
                     int* status_out) {
  // node = per-binary domain: -1 free in [0,1], 0 fixed 0, 1 fixed 1
  std::vector<std::vector<int8_t>> stack;
  stack.push_back(std::vector<int8_t>(nb, -1));

  std::vector<double> l(l_in, l_in + m), u(u_in, u_in + m);
  std::vector<double> zn(n, 0.0), yn(m, 0.0);
  std::vector<double> z_best, y_best;
  double best = 1e300;
  bool have_incumbent = false;
  int nodes = 0;
  bool node_limit = false;
  const auto t_start = std::chrono::steady_clock::now();
  auto out_of_time = [&] {
    if (time_limit <= 0.0) return false;
    return std::chrono::duration<double>(std::chrono::steady_clock::now() -
                                         t_start).count() > time_limit;
  };

  while (!stack.empty()) {
    if (nodes >= max_nodes || out_of_time()) {
      node_limit = true;
      break;
    }
    std::vector<int8_t> dom = stack.back();
    stack.pop_back();
    ++nodes;

    for (int i = 0; i < nb; ++i) {
      const int r = bin_rows[i];
      l[r] = dom[i] == 1 ? 1.0 : 0.0;
      u[r] = dom[i] == 0 ? 0.0 : 1.0;
    }

    int iters = 0;
    double rp = 0.0, rd = 0.0;
    // warm start from the last solved node (DFS locality)
    const int st = solve_node(n, m, P, q, A, l.data(), u.data(), max_iter,
                              eps_abs, eps_rel, rho0, sigma, alpha, 1e-8, zn,
                              yn, &iters, &rp, &rd);
    if (std::getenv("QPREF_DEBUG")) {
      std::fprintf(stderr, "[miqp] node %d st %d it %d rp %.2e obj %.6f\n",
                   nodes, st, iters, rp,
                   qp_objective(n, P, q, zn.data()));
    }
    if (st == QPREF_PRIMAL_INFEASIBLE || st == QPREF_DUAL_INFEASIBLE) continue;
    // ADMM stalls (rather than certifies) on infeasible nodes whose rows
    // have one-sided infinite bounds (no support-function certificate):
    // a node that maxed out iterations with a large primal residual is
    // treated as infeasible, like a node-LP presolve cutoff would.
    if (st == QPREF_MAX_ITER && rp > 1e-4) {
      zn.assign(n, 0.0);  // poisoned iterate: don't warm-start siblings
      yn.assign(m, 0.0);
      continue;
    }

    const double obj = qp_objective(n, P, q, zn.data());
    const double slack = 1e-6 * (1.0 + std::fabs(obj));
    if (have_incumbent && obj >= best - slack) continue;  // bound prune

    // fractionality check
    int branch_i = -1;
    double worst_frac = int_tol;
    for (int i = 0; i < nb; ++i) {
      if (dom[i] != -1) continue;
      const double v = zn[bin_cols[i]];
      const double frac = std::fabs(v - std::floor(v + 0.5));
      if (frac > worst_frac) {
        worst_frac = frac;
        branch_i = i;
      }
    }

    if (branch_i < 0) {
      // integral (within tol): fix rounded binaries, re-solve exactly
      std::vector<double> lf = l, uf = u, zc = zn, yc = yn;
      for (int i = 0; i < nb; ++i) {
        const double v = dom[i] == -1 ? std::floor(zn[bin_cols[i]] + 0.5)
                                      : static_cast<double>(dom[i]);
        lf[bin_rows[i]] = v;
        uf[bin_rows[i]] = v;
      }
      int it2 = 0;
      double rp2 = 0.0, rd2 = 0.0;
      const int st2 = solve_node(n, m, P, q, A, lf.data(), uf.data(),
                                 max_iter, eps_abs, eps_rel, rho0, sigma,
                                 alpha, 1e-8, zc, yc, &it2, &rp2, &rd2);
      if (st2 == QPREF_CONVERGED ||
          (st2 == QPREF_MAX_ITER && rp2 <= 1e-6)) {
        const double obj_c = qp_objective(n, P, q, zc.data());
        if (!have_incumbent || obj_c < best) {
          best = obj_c;
          z_best = zc;
          y_best = yc;
          have_incumbent = true;
        }
      }
      continue;
    }

    // branch: push the far child first so the near one (the branch the
    // relaxation leans toward) is explored next
    const double v = zn[bin_cols[branch_i]];
    std::vector<int8_t> child0 = dom, child1 = dom;
    child0[branch_i] = 0;
    child1[branch_i] = 1;
    if (v >= 0.5) {
      stack.push_back(child0);
      stack.push_back(child1);
    } else {
      stack.push_back(child1);
      stack.push_back(child0);
    }
  }

  *nodes_out = nodes;
  if (!have_incumbent) {
    // a node/time-limit exit without an incumbent proves nothing;
    // infeasibility is only declared from a fully explored tree
    *obj_out = 1e300;
    *status_out = node_limit ? MIQP_NODE_LIMIT : MIQP_INFEASIBLE;
    return *status_out;
  }
  std::memcpy(z, z_best.data(), sizeof(double) * n);
  std::memcpy(y, y_best.data(), sizeof(double) * m);
  *obj_out = best;
  *status_out = node_limit ? MIQP_NODE_LIMIT : MIQP_OPTIMAL;
  return *status_out;
}

// ---------------------------------------------------------------------------
// ReLU-disjunction branch-and-bound (the exact-MILP capability, modern
// formulation): instead of big-M binaries (whose node QPs are degenerate
// for ADMM), branch directly on each unstable neuron's phase
//   off: r = 0, a <= 0        on: r = a, a >= 0
// with the triangle relaxation at free nodes (the tightest convex hull of
// the ReLU graph on [lo_a, hi_a]). This is how modern NN-verification
// solvers branch; the result is the same global optimum the reference
// obtains from SCIP on its big-M MILP transcription (fnn/...:193-330).
//
// Per unstable neuron instance the caller provides three dedicated rows:
//   row_ge:   r - a        in [0, inf)   (tightened to [0,0] when ON)
//   row_a:    a            in [lo, hi]   (upper->0 when OFF, lower->0 ON)
//   row_rbox: r            in [0, hi+]   (tightened to [0,0] when OFF)
// plus the r column index. The triangle upper row is static.
// ---------------------------------------------------------------------------
int qpref_solve_relu_bb(int n, int m, const double* P, const double* q,
                        const double* A, const double* l_in,
                        const double* u_in, int nb, const int* row_ge,
                        const int* row_a, const int* row_rbox,
                        const int* col_r, const double* lo_a,
                        const double* hi_a, const double* a_bias,
                        int max_iter, double eps_abs,
                        double eps_rel, double rho0, double sigma,
                        double alpha, int max_nodes, double time_limit,
                        double phase_tol, const double* z_init,
                        double* z, double* y, double* obj_out, int* nodes_out,
                        int* status_out) {
  std::vector<std::vector<int8_t>> stack;  // -1 free, 0 off, 1 on
  stack.push_back(std::vector<int8_t>(nb, -1));

  std::vector<double> l(l_in, l_in + m), u(u_in, u_in + m);
  std::vector<double> zn(n, 0.0), yn(m, 0.0);
  std::vector<double> z_best, y_best;
  const double kInf = std::numeric_limits<double>::infinity();
  double best = 1e300;
  bool have_incumbent = false;
  // caller-provided feasible starting point (e.g. a rollout of the true
  // network under a warm input trajectory — always phase-consistent):
  // seeds the incumbent so (a) pruning bites from node 1 and (b) a
  // node/time-limit exit still returns an exact-ReLU feasible solution
  if (z_init != nullptr) {
    z_best.assign(z_init, z_init + n);
    y_best.assign(m, 0.0);
    best = qp_objective(n, P, q, z_init);
    have_incumbent = true;
    zn.assign(z_init, z_init + n);
  }
  int nodes = 0;
  bool node_limit = false;
  bool uncertified_prune = false;  // any subtree cut without a certificate
  const bool debug = std::getenv("QPREF_DEBUG") != nullptr;
  const auto t_start = std::chrono::steady_clock::now();
  auto out_of_time = [&] {
    if (time_limit <= 0.0) return false;
    return std::chrono::duration<double>(std::chrono::steady_clock::now() -
                                         t_start).count() > time_limit;
  };

  auto apply_dom = [&](const std::vector<int8_t>& dom, std::vector<double>& lv,
                       std::vector<double>& uv) {
    for (int i = 0; i < nb; ++i) {
      const double rhi = std::max(hi_a[i], 0.0);
      switch (dom[i]) {
        // the a-row's value is (a - a_bias) and the ge-row's value is
        // (r - a + a_bias): shift all a-space bounds by the bias
        case 0:  // off: r = 0, a <= 0
          lv[row_ge[i]] = a_bias[i];
          uv[row_ge[i]] = kInf;
          lv[row_a[i]] = lo_a[i] - a_bias[i];
          uv[row_a[i]] = std::min(0.0, hi_a[i]) - a_bias[i];
          lv[row_rbox[i]] = 0.0;
          uv[row_rbox[i]] = 0.0;
          break;
        case 1:  // on: r = a, a >= 0
          lv[row_ge[i]] = a_bias[i];
          uv[row_ge[i]] = a_bias[i];
          lv[row_a[i]] = std::max(0.0, lo_a[i]) - a_bias[i];
          uv[row_a[i]] = hi_a[i] - a_bias[i];
          lv[row_rbox[i]] = 0.0;
          uv[row_rbox[i]] = rhi;
          break;
        default:  // free
          lv[row_ge[i]] = a_bias[i];
          uv[row_ge[i]] = kInf;
          lv[row_a[i]] = lo_a[i] - a_bias[i];
          uv[row_a[i]] = hi_a[i] - a_bias[i];
          lv[row_rbox[i]] = 0.0;
          uv[row_rbox[i]] = rhi;
      }
    }
  };

  auto a_value = [&](int i) {
    const int r = row_a[i];
    double acc = a_bias[i];
    for (int j = 0; j < n; ++j) acc += A[static_cast<size_t>(r) * n + j] * zn[j];
    return acc;
  };

  // dive heuristic / incumbent attempt: pin every free neuron to the phase
  // the relaxation point zn leans toward, re-solve the (continuous,
  // disjunction-free) QP, and accept if it lands feasible. Guarantees a
  // feasible exact-ReLU incumbent long before the tree is explored, so a
  // node/time-limit exit still returns a usable (suboptimal) controller
  // move instead of the raw relaxation point.
  auto try_incumbent = [&](const std::vector<int8_t>& dom) {
    std::vector<int8_t> fixed = dom;
    for (int i = 0; i < nb; ++i)
      if (fixed[i] == -1) fixed[i] = a_value(i) >= 0.0 ? 1 : 0;
    std::vector<double> lf(l_in, l_in + m), uf(u_in, u_in + m);
    apply_dom(fixed, lf, uf);
    std::vector<double> zc = zn, yc = yn;
    int it2 = 0;
    double rp2 = 0.0, rd2 = 0.0;
    const int st2 = solve_node(n, m, P, q, A, lf.data(), uf.data(),
                               max_iter, eps_abs, eps_rel, rho0, sigma,
                               alpha, 1e-8, zc, yc, &it2, &rp2, &rd2);
    if (st2 == QPREF_CONVERGED || (st2 == QPREF_MAX_ITER && rp2 <= 1e-6)) {
      const double obj_c = qp_objective(n, P, q, zc.data());
      if (!have_incumbent || obj_c < best) {
        best = obj_c;
        z_best = std::move(zc);
        y_best = std::move(yc);
        have_incumbent = true;
      }
      return true;
    }
    return false;
  };

  while (!stack.empty()) {
    if (nodes >= max_nodes || out_of_time()) {
      node_limit = true;
      break;
    }
    std::vector<int8_t> dom = stack.back();
    stack.pop_back();
    ++nodes;
    apply_dom(dom, l, u);

    int iters = 0;
    double rp = 0.0, rd = 0.0;
    int st = solve_node(n, m, P, q, A, l.data(), u.data(), max_iter,
                        eps_abs, eps_rel, rho0, sigma, alpha, 1e-8, zn, yn,
                        &iters, &rp, &rd);
    if (st == QPREF_MAX_ITER && rp > 1e-2) {
      // suspected stall: retry once, cold-started, with a heavier penalty
      // and a deeper (but still capped) budget before concluding anything
      zn.assign(n, 0.0);
      yn.assign(m, 0.0);
      st = qpref_solve(n, m, P, q, A, l.data(), u.data(),
                       std::min(4 * max_iter, 20000), eps_abs, eps_rel,
                       10.0 * rho0, sigma, alpha, zn.data(), yn.data(),
                       &iters, &rp, &rd);
    }
    if (debug) {
      const double el = std::chrono::duration<double>(
          std::chrono::steady_clock::now() - t_start).count();
      std::fprintf(stderr,
                   "[relu-bb] node %d st %d it %d rp %.2e obj %.6f t %.3f\n",
                   nodes, st, iters, rp, qp_objective(n, P, q, zn.data()), el);
    }
    if (st == QPREF_PRIMAL_INFEASIBLE || st == QPREF_DUAL_INFEASIBLE) continue;
    // an unconverged node with a LARGE primal residual after the retry is
    // treated as infeasible (ADMM stalls rather than certifies when rows
    // have one-sided infinite bounds); small residuals mean "still
    // converging" — branch on the approximate relaxation instead
    if (st == QPREF_MAX_ITER && rp > 1e-2) {
      zn.assign(n, 0.0);  // stalled node: don't warm-start siblings from it
      yn.assign(m, 0.0);
      uncertified_prune = true;  // heuristic cut — no infeasibility cert
      continue;
    }

    const double obj = qp_objective(n, P, q, zn.data());
    const double slack = 1e-6 * (1.0 + std::fabs(obj)) +
                         (st == QPREF_MAX_ITER ? 1e-2 * (1.0 + std::fabs(obj)) : 0.0);
    if (have_incumbent && obj >= best - slack) {
      // bound-pruning off an approximately-converged relaxation (MAX_ITER
      // with small residuals) uses a non-rigorous lower bound
      if (st == QPREF_MAX_ITER) uncertified_prune = true;
      continue;
    }

    // phase consistency: r == relu(a) per unstable neuron
    int branch_i = -1;
    double worst = phase_tol;
    for (int i = 0; i < nb; ++i) {
      if (dom[i] != -1) continue;
      const double a = a_value(i);
      const double viol = std::fabs(zn[col_r[i]] - std::max(a, 0.0));
      if (viol > worst) {
        worst = viol;
        branch_i = i;
      }
    }

    if (branch_i < 0) {
      // phase-consistent: fix every free neuron to its indicated phase and
      // re-solve so the incumbent is exact
      try_incumbent(dom);
      continue;
    }

    // primal dive heuristic: until an incumbent exists (and periodically
    // after), try the phase-rounding of this node's relaxation so limit
    // exits always carry a feasible exact-ReLU solution
    if (!have_incumbent || (nodes & 15) == 0) try_incumbent(dom);

    // branch: explore the phase the relaxation leans toward first
    const double a = a_value(branch_i);
    std::vector<int8_t> child_off = dom, child_on = dom;
    child_off[branch_i] = 0;
    child_on[branch_i] = 1;
    if (a >= 0.0) {
      stack.push_back(child_off);
      stack.push_back(child_on);
    } else {
      stack.push_back(child_on);
      stack.push_back(child_off);
    }
  }

  *nodes_out = nodes;
  if (!have_incumbent) {
    // a node/time-limit exit without an incumbent proves nothing;
    // infeasibility is only declared from a fully explored tree — and only
    // a certified one (uncertified prunes could have cut the feasible set)
    *obj_out = 1e300;
    *status_out = node_limit
                      ? MIQP_NODE_LIMIT
                      : (uncertified_prune ? MIQP_NODE_LIMIT : MIQP_INFEASIBLE);
    return *status_out;
  }
  std::memcpy(z, z_best.data(), sizeof(double) * n);
  std::memcpy(y, y_best.data(), sizeof(double) * m);
  *obj_out = best;
  *status_out = node_limit
                    ? MIQP_NODE_LIMIT
                    : (uncertified_prune ? MIQP_OPTIMAL_TOL : MIQP_OPTIMAL);
  return *status_out;
}

// Batch front-end: solves B independent QPs sharing (P, A) structure with
// per-instance q/l/u — the condensed-MPC runtime pattern (only the vectors
// depend on the measured state). OpenMP-free; callers thread if needed.
int qpref_solve_batch(int B, int n, int m, const double* P, const double* q,
                      const double* A, const double* l, const double* u,
                      int max_iter, double eps_abs, double eps_rel,
                      double rho0, double sigma, double alpha, double* z,
                      double* y, int* status_out, int* iters, double* rprim,
                      double* rdual) {
  for (int b = 0; b < B; ++b) {
    status_out[b] = qpref_solve(
        n, m, P, q + static_cast<size_t>(b) * n, A, l + static_cast<size_t>(b) * m,
        u + static_cast<size_t>(b) * m, max_iter, eps_abs, eps_rel, rho0, sigma,
        alpha, z + static_cast<size_t>(b) * n, y + static_cast<size_t>(b) * m,
        iters + b, rprim + b, rdual + b);
  }
  return 0;
}

}  // extern "C"
