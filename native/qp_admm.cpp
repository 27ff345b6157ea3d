// Native dense ADMM QP solver with OSQP-equivalent semantics.
//
// Role in the framework: the reference depends on the OSQP C library for every
// convex solve (car/driving.py:430-440 etc.); the device compute path replaces
// it with the solvers in riskaversetrajopt_tpu/ops/{admm,ipm}.py. This
// C++ implementation is the framework's native host-side engine: an
// independent oracle for cross-checking the JAX solvers in tests, and a fast
// CPU fallback for host-side estimation QPs (AVaR validation) without any
// third-party solver dependency.
//
// Problem:  min 1/2 x^T P x + q^T x   s.t. l <= A x <= u
// Method:   over-relaxed ADMM with Ruiz equilibration, per-row penalties
//           (equality rows 1e3*rho, loose rows rho_min), adaptive rho,
//           unscaled-residual termination, optional active-set polish.
// Exposed as a C ABI for ctypes (see riskaversetrajopt_tpu/native/__init__.py).

#include <cmath>
#include <cstdlib>
#include <cstring>
#include <vector>
#include <algorithm>
#include <limits>

namespace {

constexpr double RHO_MIN = 1e-6;
constexpr double RHO_MAX = 1e6;
constexpr double LOOSE_RHO = 1e-6;
constexpr double EQ_TOL = 1e-9;
constexpr double MIN_SCALING = 1e-4;
constexpr double MAX_SCALING = 1e4;

struct Dense {
  int rows, cols;
  std::vector<double> a;  // row-major
  Dense(int r, int c) : rows(r), cols(c), a((size_t)r * c, 0.0) {}
  double& at(int i, int j) { return a[(size_t)i * cols + j]; }
  double at(int i, int j) const { return a[(size_t)i * cols + j]; }
};

// y = M x
void matvec(const Dense& M, const double* x, double* y) {
  for (int i = 0; i < M.rows; ++i) {
    double s = 0.0;
    const double* row = &M.a[(size_t)i * M.cols];
    for (int j = 0; j < M.cols; ++j) s += row[j] * x[j];
    y[i] = s;
  }
}

// y = M^T x
void rmatvec(const Dense& M, const double* x, double* y) {
  std::fill(y, y + M.cols, 0.0);
  for (int i = 0; i < M.rows; ++i) {
    const double* row = &M.a[(size_t)i * M.cols];
    for (int j = 0; j < M.cols; ++j) y[j] += row[j] * x[i];
  }
}

// In-place Cholesky (lower). Returns false if not SPD.
bool cholesky(Dense& N) {
  int n = N.rows;
  for (int j = 0; j < n; ++j) {
    double d = N.at(j, j);
    for (int k = 0; k < j; ++k) d -= N.at(j, k) * N.at(j, k);
    if (d <= 0.0 || !std::isfinite(d)) return false;
    double dj = std::sqrt(d);
    N.at(j, j) = dj;
    for (int i = j + 1; i < n; ++i) {
      double s = N.at(i, j);
      for (int k = 0; k < j; ++k) s -= N.at(i, k) * N.at(j, k);
      N.at(i, j) = s / dj;
    }
  }
  return true;
}

void chol_solve(const Dense& L, const double* b, double* x) {
  int n = L.rows;
  std::vector<double> t(n);
  for (int i = 0; i < n; ++i) {
    double s = b[i];
    for (int k = 0; k < i; ++k) s -= L.at(i, k) * t[k];
    t[i] = s / L.at(i, i);
  }
  for (int i = n - 1; i >= 0; --i) {
    double s = t[i];
    for (int k = i + 1; k < n; ++k) s -= L.at(k, i) * x[k];
    x[i] = s / L.at(i, i);
  }
}

double inf_norm(const std::vector<double>& v) {
  double m = 0.0;
  for (double x : v)
    if (std::isfinite(x)) m = std::max(m, std::fabs(x));
  return m;
}

struct Workspace {
  int n, m;
  Dense P, A;
  std::vector<double> q, l, u;
  // scalings
  std::vector<double> D, E;
  double c = 1.0;
  std::vector<double> rho_vec;

  Workspace(int n_, int m_) : n(n_), m(m_), P(n_, n_), A(m_, n_),
                              q(n_), l(m_), u(m_), D(n_, 1.0), E(m_, 1.0) {}

  void ruiz(int iters) {
    for (int it = 0; it < iters; ++it) {
      // column norms of [cDPD; EAD] and row norms of EAD
      std::vector<double> col(n, 0.0), row(m, 0.0);
      for (int i = 0; i < n; ++i)
        for (int j = 0; j < n; ++j)
          col[j] = std::max(col[j], c * D[i] * std::fabs(P.at(i, j)) * D[j]);
      for (int i = 0; i < m; ++i)
        for (int j = 0; j < n; ++j) {
          double v = E[i] * std::fabs(A.at(i, j)) * D[j];
          col[j] = std::max(col[j], v);
          row[i] = std::max(row[i], v);
        }
      for (int j = 0; j < n; ++j) {
        double cl = std::min(std::max(col[j], MIN_SCALING), MAX_SCALING);
        D[j] /= std::sqrt(cl);
      }
      for (int i = 0; i < m; ++i) {
        double rl = std::min(std::max(row[i], MIN_SCALING), MAX_SCALING);
        E[i] /= std::sqrt(rl);
      }
      // cost normalization
      double mean_colP = 0.0, qn = 0.0;
      for (int j = 0; j < n; ++j) {
        double cj = 0.0;
        for (int i = 0; i < n; ++i)
          cj = std::max(cj, c * D[i] * std::fabs(P.at(i, j)) * D[j]);
        mean_colP += cj;
        qn = std::max(qn, std::fabs(c * D[j] * q[j]));
      }
      mean_colP /= std::max(n, 1);
      double denom = std::min(std::max(std::max(mean_colP, qn), MIN_SCALING),
                              MAX_SCALING);
      c /= denom;
    }
  }

  void compute_rho(double rho, std::vector<double>& rv,
                   const std::vector<double>& ls,
                   const std::vector<double>& us_) {
    rv.resize(m);
    for (int i = 0; i < m; ++i) {
      bool loose = std::isinf(-ls[i]) && std::isinf(us_[i]);
      bool eq = (us_[i] - ls[i]) <= EQ_TOL;
      double r = eq ? 1e3 * rho : rho;
      if (loose) r = LOOSE_RHO;
      rv[i] = std::min(std::max(r, RHO_MIN), RHO_MAX);
    }
  }
};

}  // namespace

extern "C" {

// Returns 0 on success (converged), 1 on max_iter, -1 on setup failure.
// x_out (n), y_out (m), info_out[0..2] = {iters, prim_res, dual_res}.
int qp_admm_solve(int n, int m, const double* P_in, const double* q_in,
                  const double* A_in, const double* l_in, const double* u_in,
                  double eps_abs, double eps_rel, int max_iter,
                  double sigma, double rho0, double alpha_relax, int polish,
                  double* x_out, double* y_out, double* info_out) {
  Workspace w(n, m);
  std::memcpy(w.P.a.data(), P_in, sizeof(double) * n * n);
  std::memcpy(w.A.a.data(), A_in, sizeof(double) * m * n);
  std::copy(q_in, q_in + n, w.q.begin());
  std::copy(l_in, l_in + m, w.l.begin());
  std::copy(u_in, u_in + m, w.u.begin());

  w.ruiz(10);

  // scaled problem data
  Dense As(m, n);
  for (int i = 0; i < m; ++i)
    for (int j = 0; j < n; ++j) As.at(i, j) = w.E[i] * w.A.at(i, j) * w.D[j];
  Dense Ps(n, n);
  for (int i = 0; i < n; ++i)
    for (int j = 0; j < n; ++j)
      Ps.at(i, j) = w.c * w.D[i] * w.P.at(i, j) * w.D[j];
  std::vector<double> qs(n), ls(m), us_(m);
  for (int j = 0; j < n; ++j) qs[j] = w.c * w.D[j] * w.q[j];
  for (int i = 0; i < m; ++i) {
    ls[i] = w.E[i] * w.l[i];
    us_[i] = w.E[i] * w.u[i];
  }

  double rho = rho0;
  std::vector<double> rho_vec;
  w.compute_rho(rho, rho_vec, ls, us_);

  auto factorize = [&](const std::vector<double>& rv, Dense& L) -> bool {
    L = Ps;
    for (int j = 0; j < n; ++j) L.at(j, j) += sigma;
    for (int i = 0; i < m; ++i)
      for (int j = 0; j < n; ++j)
        for (int k = 0; k < n; ++k)
          L.at(j, k) += As.at(i, j) * rv[i] * As.at(i, k);
    return cholesky(L);
  };

  Dense L(n, n);
  if (!factorize(rho_vec, L)) return -1;

  std::vector<double> x(n, 0.0), z(m, 0.0), y(m, 0.0);
  std::vector<double> Ax(m), xt(n), zt(m), rhs(n), tmpm(m), tmpn(n);
  matvec(As, x.data(), Ax.data());
  for (int i = 0; i < m; ++i) z[i] = std::min(std::max(Ax[i], ls[i]), us_[i]);

  int iter = 0;
  double prim = 0, dual = 0;
  bool solved = false;
  const int check_every = 25;

  while (iter < max_iter) {
    for (int k = 0; k < check_every; ++k) {
      // rhs = sigma x - q + A^T (rho z - y)
      for (int i = 0; i < m; ++i) tmpm[i] = rho_vec[i] * z[i] - y[i];
      rmatvec(As, tmpm.data(), rhs.data());
      for (int j = 0; j < n; ++j) rhs[j] += sigma * x[j] - qs[j];
      chol_solve(L, rhs.data(), xt.data());
      matvec(As, xt.data(), zt.data());
      for (int j = 0; j < n; ++j)
        x[j] = alpha_relax * xt[j] + (1 - alpha_relax) * x[j];
      for (int i = 0; i < m; ++i) {
        double z_relax = alpha_relax * zt[i] + (1 - alpha_relax) * z[i];
        double z_new = std::min(
            std::max(z_relax + y[i] / rho_vec[i], ls[i]), us_[i]);
        y[i] += rho_vec[i] * (z_relax - z_new);
        z[i] = z_new;
      }
    }
    iter += check_every;

    // unscaled residuals
    matvec(As, x.data(), Ax.data());
    std::vector<double> Axu(m), zu(m), Pxu(n), Atyu(n);
    for (int i = 0; i < m; ++i) {
      Axu[i] = Ax[i] / w.E[i];
      zu[i] = z[i] / w.E[i];
    }
    matvec(Ps, x.data(), tmpn.data());
    for (int j = 0; j < n; ++j) Pxu[j] = tmpn[j] / (w.c * w.D[j]);
    rmatvec(As, y.data(), tmpn.data());
    for (int j = 0; j < n; ++j) Atyu[j] = tmpn[j] / (w.c * w.D[j]);

    prim = 0;
    double maxAx = 0, maxz = 0;
    for (int i = 0; i < m; ++i) {
      prim = std::max(prim, std::fabs(Axu[i] - zu[i]));
      maxAx = std::max(maxAx, std::fabs(Axu[i]));
      maxz = std::max(maxz, std::fabs(zu[i]));
    }
    dual = 0;
    double maxPx = 0, maxAty = 0, maxq = 0;
    for (int j = 0; j < n; ++j) {
      double qj = w.q[j];
      dual = std::max(dual, std::fabs(Pxu[j] + qj + Atyu[j]));
      maxPx = std::max(maxPx, std::fabs(Pxu[j]));
      maxAty = std::max(maxAty, std::fabs(Atyu[j]));
      maxq = std::max(maxq, std::fabs(qj));
    }
    double eps_prim = eps_abs + eps_rel * std::max(maxAx, maxz);
    double eps_dual = eps_abs + eps_rel * std::max(maxq, std::max(maxPx, maxAty));
    if (prim <= eps_prim && dual <= eps_dual) {
      solved = true;
      break;
    }

    // adaptive rho on scaled residual ratio
    double prim_s = 0, dual_s = 0, den_p = 1e-30, den_d = 1e-30;
    matvec(Ps, x.data(), tmpn.data());
    std::vector<double> Aty_s(n);
    rmatvec(As, y.data(), Aty_s.data());
    for (int i = 0; i < m; ++i) {
      prim_s = std::max(prim_s, std::fabs(Ax[i] - z[i]));
      den_p = std::max(den_p, std::max(std::fabs(Ax[i]), std::fabs(z[i])));
    }
    for (int j = 0; j < n; ++j) {
      dual_s = std::max(dual_s, std::fabs(tmpn[j] + qs[j] + Aty_s[j]));
      den_d = std::max(den_d, std::max(std::fabs(tmpn[j]),
                                       std::max(std::fabs(Aty_s[j]),
                                                std::fabs(qs[j]))));
    }
    double ratio = (prim_s / den_p) / (dual_s / den_d + 1e-30);
    double rho_new = rho * std::sqrt(ratio);
    rho_new = std::min(std::max(rho_new, RHO_MIN), RHO_MAX);
    if (rho_new > 5 * rho || rho_new < rho / 5) {
      rho = rho_new;
      w.compute_rho(rho, rho_vec, ls, us_);
      if (!factorize(rho_vec, L)) return -1;
    }
  }

  // unscale
  std::vector<double> xu(n), yu(m);
  for (int j = 0; j < n; ++j) xu[j] = w.D[j] * x[j];
  for (int i = 0; i < m; ++i) yu[i] = w.E[i] * y[i] / w.c;

  if (polish) {
    // active-set polish: stiff-penalty equality solve on active rows
    std::vector<double> wrow(m, 0.0), b(m, 0.0);
    bool any_active = false;
    for (int i = 0; i < m; ++i) {
      if (yu[i] < -1e-10 && std::isfinite(w.l[i])) {
        wrow[i] = 1e7;
        b[i] = w.l[i];
        any_active = true;
      } else if (yu[i] > 1e-10 && std::isfinite(w.u[i])) {
        wrow[i] = 1e7;
        b[i] = w.u[i];
        any_active = true;
      }
    }
    if (any_active) {
      Dense Np(n, n);
      Np = w.P;
      for (int j = 0; j < n; ++j) Np.at(j, j) += 1e-9;
      for (int i = 0; i < m; ++i) {
        if (wrow[i] == 0.0) continue;
        for (int j = 0; j < n; ++j)
          for (int k = 0; k < n; ++k)
            Np.at(j, k) += w.A.at(i, j) * wrow[i] * w.A.at(i, k);
      }
      if (cholesky(Np)) {
        std::vector<double> rhs_p(n), xp(n), Axp(m), wb(m);
        for (int i = 0; i < m; ++i) wb[i] = wrow[i] * b[i];
        rmatvec(w.A, wb.data(), rhs_p.data());
        for (int j = 0; j < n; ++j) rhs_p[j] -= w.q[j];
        chol_solve(Np, rhs_p.data(), xp.data());
        // refinement
        for (int r = 0; r < 3; ++r) {
          matvec(w.A, xp.data(), Axp.data());
          std::vector<double> res(n), dxp(n), tmp(m);
          matvec(w.P, xp.data(), res.data());
          for (int i = 0; i < m; ++i) tmp[i] = wrow[i] * Axp[i];
          std::vector<double> atw(n);
          rmatvec(w.A, tmp.data(), atw.data());
          for (int j = 0; j < n; ++j)
            res[j] = rhs_p[j] - (res[j] + 1e-9 * xp[j] + atw[j]);
          chol_solve(Np, res.data(), dxp.data());
          for (int j = 0; j < n; ++j) xp[j] += dxp[j];
        }
        matvec(w.A, xp.data(), Axp.data());
        std::vector<double> yp(m, 0.0);
        for (int i = 0; i < m; ++i)
          if (wrow[i] != 0.0) yp[i] = wrow[i] * (Axp[i] - b[i]);
        // accept only if both residuals improve
        auto resid = [&](const std::vector<double>& xx,
                         const std::vector<double>& yy, double& pr, double& du) {
          std::vector<double> Axx(m), Pxx(n), Aty(n);
          matvec(w.A, xx.data(), Axx.data());
          pr = 0;
          for (int i = 0; i < m; ++i) {
            double zi = std::min(std::max(Axx[i], w.l[i]), w.u[i]);
            pr = std::max(pr, std::fabs(Axx[i] - zi));
          }
          matvec(w.P, xx.data(), Pxx.data());
          rmatvec(w.A, yy.data(), Aty.data());
          du = 0;
          for (int j = 0; j < n; ++j)
            du = std::max(du, std::fabs(Pxx[j] + w.q[j] + Aty[j]));
        };
        double p0, d0, p1, d1;
        resid(xu, yu, p0, d0);
        resid(xp, yp, p1, d1);
        if (p1 <= std::max(p0, 1e-10) && d1 <= std::max(d0, 1e-10)) {
          xu = xp;
          yu = yp;
        }
      }
    }
  }

  std::copy(xu.begin(), xu.end(), x_out);
  std::copy(yu.begin(), yu.end(), y_out);
  info_out[0] = iter;
  info_out[1] = prim;
  info_out[2] = dual;
  return solved ? 0 : 1;
}

}  // extern "C"
