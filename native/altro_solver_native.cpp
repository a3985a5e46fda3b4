// altro_tpu native runtime, part 2: the FULL single-solve AL-iLQR engine
// in dependency-free C++ — the embedded/host deployment surface (the
// reference ships its whole solver to Teensy-class targets; this is the
// JAX framework's equivalent). Diagonal costs, user dynamics/constraint
// callbacks, conic constraints (equality / inequality / second-order
// cone), projected-dual augmented Lagrangian, strong-Wolfe cubic line
// search with backtracking fallback, adaptive regularization.
//
// Algorithms mirror altro_tpu/{al,linesearch,solver}.py (== the reference
// semantics, solver.cpp:414-511); validated by tests/test_native_solver.py
// against the same exact iteration-count oracles as the JAX solver
// (double integrator goal: 3 iterations; + control bounds: 5).
//
// All heap allocation happens once at solve entry; the iteration loop is
// allocation-free.

#include <cmath>
#include <cstdlib>
#include <cstring>
#include <vector>

extern "C" {
size_t altro_tvlqr_work_size(int n, int m);
int altro_tvlqr_backward(int n, int m, int N, const double* A, const double* B,
                         const double* f, const double* lxx, const double* luu,
                         const double* lux, const double* lx, const double* lu,
                         double reg, double* K, double* d, double* P, double* p,
                         double* dV, double* work);
int altro_cubic_fit(double x1, double y1, double d1, double x2, double y2,
                    double d2, double* coeffs);
int altro_cubic_argmin(const double* coeffs, double* x_min);
}

namespace {

// ------------------------------- cones (port of altro_tpu/cones.py) ----

enum Cone { CONE_ZERO = 0, CONE_IDENTITY = 1, CONE_NEG_ORTHANT = 2, CONE_SOC = 3 };

int dual_cone(int cone) {
  switch (cone) {
    case CONE_ZERO: return CONE_IDENTITY;
    case CONE_IDENTITY: return CONE_ZERO;
    default: return cone;
  }
}

void soc_project(int p, const double* x, double* px) {
  int nv = p - 1;
  double s = x[nv];
  double a = 0;
  for (int i = 0; i < nv; ++i) a += x[i] * x[i];
  a = std::sqrt(a);
  if (a <= -s) {
    for (int i = 0; i < p; ++i) px[i] = 0;
  } else if (a <= s) {
    for (int i = 0; i < p; ++i) px[i] = x[i];
  } else {
    double c = 0.5 * (1.0 + s / a);
    for (int i = 0; i < nv; ++i) px[i] = c * x[i];
    px[nv] = c * a;
  }
}

void cone_project(int cone, int p, const double* x, double* px) {
  switch (cone) {
    case CONE_ZERO:
      for (int i = 0; i < p; ++i) px[i] = 0;
      break;
    case CONE_IDENTITY:
      std::memcpy(px, x, sizeof(double) * p);
      break;
    case CONE_NEG_ORTHANT:
      for (int i = 0; i < p; ++i) px[i] = x[i] < 0 ? x[i] : 0.0;
      break;
    case CONE_SOC:
      soc_project(p, x, px);
      break;
  }
}

// Jacobian dP(x), row-major [p, p]
void cone_project_jac(int cone, int p, const double* x, double* J) {
  std::memset(J, 0, sizeof(double) * p * p);
  switch (cone) {
    case CONE_ZERO:
      break;
    case CONE_IDENTITY:
      for (int i = 0; i < p; ++i) J[i * p + i] = 1.0;
      break;
    case CONE_NEG_ORTHANT:
      for (int i = 0; i < p; ++i) J[i * p + i] = x[i] <= 0 ? 1.0 : 0.0;
      break;
    case CONE_SOC: {
      int nv = p - 1;
      double s = x[nv];
      double a = 0;
      for (int i = 0; i < nv; ++i) a += x[i] * x[i];
      a = std::sqrt(a);
      if (a <= -s) {
        // zero
      } else if (a <= s) {
        for (int i = 0; i < p; ++i) J[i * p + i] = 1.0;
      } else {
        double c = 0.5 * (1.0 + s / a);
        for (int i = 0; i < nv; ++i) {
          for (int j = 0; j < nv; ++j) {
            J[i * p + j] = -0.5 * s / (a * a * a) * x[i] * x[j];
            if (i == j) J[i * p + j] += c;
          }
          J[i * p + nv] = 0.5 * x[i] / a;
          J[nv * p + i] = (-0.5 * s / (a * a) + c / a) * x[i];
        }
        J[nv * p + nv] = 0.5;
      }
      break;
    }
  }
}

// Jacobian of x -> dP(x)^T b (SOC only; zero for linear cones)
void cone_project_hess(int cone, int p, const double* x, const double* b,
                       double* H) {
  std::memset(H, 0, sizeof(double) * p * p);
  if (cone != CONE_SOC) return;
  int nv = p - 1;
  double s = x[nv], bs = b[nv];
  double a = 0, vbv = 0;
  for (int i = 0; i < nv; ++i) {
    a += x[i] * x[i];
    vbv += x[i] * b[i];
  }
  a = std::sqrt(a);
  if (a <= -s || a <= s) return;  // in/below cone: zero
  // h = (I - vv^T/a^2) b_v
  std::vector<double> h(nv);
  for (int i = 0; i < nv; ++i) h[i] = b[i] - x[i] * vbv / (a * a);
  for (int i = 0; i < nv; ++i) {
    for (int j = 0; j < nv; ++j) {
      double val = (-s / (a * a * a)) * (h[i] * x[j] + x[i] * h[j]) +
                   (s * vbv / (a * a * a * a * a)) * x[i] * x[j];
      if (i == j) val += -s * vbv / (a * a * a) + bs / a;
      val += (bs / a) * (-x[i] * x[j] / (a * a));
      H[i * p + j] = 0.5 * val;
    }
    H[i * p + nv] = h[i] / (2 * a);
    H[nv * p + i] = h[i] / (2 * a);
  }
  H[nv * p + nv] = 0.0;
}

}  // namespace

extern "C" {

typedef void (*altro_dyn_fn)(double* xn, const double* x, const double* u,
                             double h, int k, void* ud);
typedef void (*altro_jac_fn)(double* J, const double* x, const double* u,
                             double h, int k, void* ud);  // row-major [n, n+m]
typedef void (*altro_con_fn)(double* c, const double* x, const double* u,
                             int k, void* ud);
typedef void (*altro_conjac_fn)(double* J, const double* x, const double* u,
                                int k, void* ud);  // row-major [p, n+m]

typedef struct {
  int cone;       // Cone enum
  int dim;        // p
  altro_con_fn fn;
  altro_conjac_fn jac;
  const unsigned char* active;  // [N+1]
} altro_constraint_t;

typedef struct {
  int iterations_max;       // default 200
  double tol_stationarity;  // 1e-4
  double tol_feasibility;   // 1e-4
  double tol_merit_grad;    // 1e-8
  double penalty_initial;   // 1.0
  double penalty_scaling;   // 10.0
  double penalty_max;       // 1e8
  int use_backtracking;     // 0
  double ls_c1, ls_c2;      // 1e-4, 0.9
} altro_native_options_t;

typedef struct {
  int status;  // 0 Success, 2 MaxIterations, 7 BpFailed, 8 LsFailed
  int iterations;
  double stationarity;
  double feasibility;
  double objective;  // AL merit value at solution
} altro_native_stats_t;

void altro_native_default_options(altro_native_options_t* o) {
  o->iterations_max = 200;
  o->tol_stationarity = 1e-4;
  o->tol_feasibility = 1e-4;
  o->tol_merit_grad = 1e-8;
  o->penalty_initial = 1.0;
  o->penalty_scaling = 10.0;
  o->penalty_max = 1e8;
  o->use_backtracking = 0;
  o->ls_c1 = 1e-4;
  o->ls_c2 = 0.9;
}

}  // extern "C"

namespace {

struct Workspace {
  int n, m, N;
  altro_dyn_fn dyn;
  altro_jac_fn jac;
  void* user;
  const double *Qd, *Rd, *q, *r, *cc, *h, *x0;
  const altro_constraint_t* cons;
  int ncons;
  altro_native_options_t opt;

  // Reference trajectory (accepted) and candidate
  std::vector<double> x, u, xc, uc, yc;
  // Expansion data at the candidate
  std::vector<double> A, Bm, f0, lx, lu, lxx, luu, lux;
  // Gains / ctg
  std::vector<double> K, d, P, p;
  double dV[2];
  std::vector<double> tvwork;
  // AL state
  std::vector<std::vector<double>> z;       // per (con, knot): [p]
  std::vector<std::vector<double>> convals; // candidate constraint values
  std::vector<std::vector<double>> zproj;   // candidate projected duals
  double rho;
  // scratch
  std::vector<double> Jd, cjac, pj, ph, jt, tmpv, tmpv2, dxda, duda, uzero;

  int max_p() const {
    int mp = 1;
    for (int j = 0; j < ncons; ++j) mp = std::max(mp, cons[j].dim);
    return mp;
  }
};

inline double dotv(const double* a, const double* b, int n) {
  double s = 0;
  for (int i = 0; i < n; ++i) s += a[i] * b[i];
  return s;
}

// AL cost at knot k for (xk, uk); also fills convals[.][k-slot] and zproj.
double al_cost_knot(Workspace& w, int k, const double* xk, const double* uk,
                    bool terminal) {
  const int n = w.n, m = w.m;
  if (terminal) uk = w.uzero.data();  // reference keeps zero u at terminal
  const double* Q = w.Qd + (size_t)k * n;
  const double* qv = w.q + (size_t)k * n;
  double J = 0.5 * [&] {
    double s = 0;
    for (int i = 0; i < n; ++i) s += xk[i] * Q[i] * xk[i];
    return s;
  }() + dotv(qv, xk, n) + w.cc[k];
  if (!terminal) {
    const double* R = w.Rd + (size_t)k * m;
    const double* rv = w.r + (size_t)k * m;
    double s = 0;
    for (int i = 0; i < m; ++i) s += uk[i] * R[i] * uk[i];
    J += 0.5 * s + dotv(rv, uk, m);
  }
  for (int j = 0; j < w.ncons; ++j) {
    const altro_constraint_t& c = w.cons[j];
    int p = c.dim;
    double* cv = w.convals[j].data() + (size_t)k * p;
    double* zp = w.zproj[j].data() + (size_t)k * p;
    c.fn(cv, xk, uk, k, w.user);
    const double* zk = w.z[j].data() + (size_t)k * p;
    for (int i = 0; i < p; ++i) w.tmpv[i] = zk[i] - w.rho * cv[i];
    cone_project(dual_cone(c.cone), p, w.tmpv.data(), zp);
    if (c.active[k]) {
      double s = 0;
      for (int i = 0; i < p; ++i) s += zp[i] * zp[i];
      J += s / (2.0 * w.rho);
    }
  }
  return J;
}

// AL gradient (lx_out[n], lu_out[m]) at knot k; assumes convals/zproj fresh.
void al_grad_knot(Workspace& w, int k, const double* xk, const double* uk,
                  bool terminal, double* lx_out, double* lu_out) {
  const int n = w.n, m = w.m;
  if (terminal) uk = w.uzero.data();
  const double* Q = w.Qd + (size_t)k * n;
  const double* qv = w.q + (size_t)k * n;
  for (int i = 0; i < n; ++i) lx_out[i] = Q[i] * xk[i] + qv[i];
  if (!terminal) {
    const double* R = w.Rd + (size_t)k * m;
    const double* rv = w.r + (size_t)k * m;
    for (int i = 0; i < m; ++i) lu_out[i] = R[i] * uk[i] + rv[i];
  } else if (lu_out) {
    for (int i = 0; i < m; ++i) lu_out[i] = 0;
  }
  for (int j = 0; j < w.ncons; ++j) {
    const altro_constraint_t& c = w.cons[j];
    if (!c.active[k]) continue;
    int p = c.dim;
    const double* cv = w.convals[j].data() + (size_t)k * p;
    const double* zp = w.zproj[j].data() + (size_t)k * p;
    const double* zk = w.z[j].data() + (size_t)k * p;
    for (int i = 0; i < p; ++i) w.tmpv[i] = zk[i] - w.rho * cv[i];  // z_est
    cone_project_jac(dual_cone(c.cone), p, w.tmpv.data(), w.pj.data());
    // jvp = Pj^T zp
    for (int i = 0; i < p; ++i) {
      double s = 0;
      for (int l = 0; l < p; ++l) s += w.pj[l * p + i] * zp[l];
      w.tmpv2[i] = s;
    }
    c.jac(w.cjac.data(), xk, uk, k, w.user);  // [p, n+m]
    for (int i = 0; i < n; ++i) {
      double s = 0;
      for (int l = 0; l < p; ++l) s += w.cjac[l * (n + m) + i] * w.tmpv2[l];
      lx_out[i] -= s;
    }
    if (!terminal) {
      for (int i = 0; i < m; ++i) {
        double s = 0;
        for (int l = 0; l < p; ++l) s += w.cjac[l * (n + m) + n + i] * w.tmpv2[l];
        lu_out[i] -= s;
      }
    }
  }
}

// AL Gauss-Newton Hessian blocks at knot k (diagonal original cost).
void al_hess_knot(Workspace& w, int k, const double* xk, const double* uk,
                  bool terminal, double* lxx, double* luu, double* lux) {
  const int n = w.n, m = w.m;
  if (terminal) uk = w.uzero.data();
  std::memset(lxx, 0, sizeof(double) * n * n);
  const double* Q = w.Qd + (size_t)k * n;
  for (int i = 0; i < n; ++i) lxx[i * n + i] = Q[i];
  if (!terminal) {
    std::memset(luu, 0, sizeof(double) * m * m);
    std::memset(lux, 0, sizeof(double) * m * n);
    const double* R = w.Rd + (size_t)k * m;
    for (int i = 0; i < m; ++i) luu[i * m + i] = R[i];
  }
  const int nm = n + m;
  for (int j = 0; j < w.ncons; ++j) {
    const altro_constraint_t& c = w.cons[j];
    if (!c.active[k]) continue;
    int p = c.dim;
    const double* cv = w.convals[j].data() + (size_t)k * p;
    const double* zp = w.zproj[j].data() + (size_t)k * p;
    const double* zk = w.z[j].data() + (size_t)k * p;
    for (int i = 0; i < p; ++i) w.tmpv[i] = zk[i] - w.rho * cv[i];
    int dc = dual_cone(c.cone);
    cone_project_jac(dc, p, w.tmpv.data(), w.pj.data());
    c.jac(w.cjac.data(), xk, uk, k, w.user);
    // jt = Pj * cjac  [p, nm]
    for (int i = 0; i < p; ++i)
      for (int col = 0; col < nm; ++col) {
        double s = 0;
        for (int l = 0; l < p; ++l) s += w.pj[i * p + l] * w.cjac[l * nm + col];
        w.jt[i * nm + col] = s;
      }
    // Hc = rho * jt^T jt (+ rho * cjac^T Hp cjac for SOC)
    // Accumulate directly into blocks.
    auto acc = [&](int rowg, int colg, int nr, int nc, double* out, int ldout) {
      for (int i = 0; i < nr; ++i)
        for (int jj = 0; jj < nc; ++jj) {
          double s = 0;
          for (int l = 0; l < p; ++l)
            s += w.jt[l * nm + rowg + i] * w.jt[l * nm + colg + jj];
          out[i * ldout + jj] += w.rho * s;
        }
    };
    acc(0, 0, n, n, lxx, n);
    if (!terminal) {
      acc(n, n, m, m, luu, m);
      acc(n, 0, m, n, lux, n);
    }
    if (dc == CONE_SOC) {
      cone_project_hess(dc, p, w.tmpv.data(), zp, w.ph.data());
      // tmp = Hp * cjac stored in jt
      for (int i = 0; i < p; ++i)
        for (int col = 0; col < nm; ++col) {
          double s = 0;
          for (int l = 0; l < p; ++l) s += w.ph[i * p + l] * w.cjac[l * nm + col];
          w.jt[i * nm + col] = s;
        }
      auto acc2 = [&](int rowg, int colg, int nr, int nc, double* out, int ldout) {
        for (int i = 0; i < nr; ++i)
          for (int jj = 0; jj < nc; ++jj) {
            double s = 0;
            for (int l = 0; l < p; ++l)
              s += w.cjac[l * nm + rowg + i] * w.jt[l * nm + colg + jj];
            out[i * ldout + jj] += w.rho * s;
          }
      };
      acc2(0, 0, n, n, lxx, n);
      if (!terminal) {
        acc2(n, n, m, m, luu, m);
        acc2(n, 0, m, n, lux, n);
      }
    }
  }
}

// Merit function: closed-loop rollout from x0 with step alpha.
// Fills candidate xc/uc/yc, convals, zproj, and (if want_grad) A,B,lx,lu.
void merit(Workspace& w, double alpha, bool want_grad, double* phi,
           double* dphi) {
  const int n = w.n, m = w.m, N = w.N;
  std::memcpy(w.xc.data(), w.x0, sizeof(double) * n);
  double ph = 0, dph = 0;
  std::fill(w.dxda.begin(), w.dxda.end(), 0.0);
  for (int k = 0; k < N; ++k) {
    double* xk = w.xc.data() + (size_t)k * n;
    double* uk = w.uc.data() + (size_t)k * m;
    const double* xr = w.x.data() + (size_t)k * n;
    const double* ur = w.u.data() + (size_t)k * m;
    const double* Kk = w.K.data() + (size_t)k * m * n;
    const double* dk = w.d.data() + (size_t)k * m;
    const double* Pk = w.P.data() + (size_t)k * n * n;
    const double* pk = w.p.data() + (size_t)k * n;
    // du = -K dx + alpha d; u = ur + du; y = P dx + p
    for (int i = 0; i < m; ++i) {
      double s = alpha * dk[i];
      for (int jj = 0; jj < n; ++jj) s -= Kk[i * n + jj] * (xk[jj] - xr[jj]);
      uk[i] = ur[i] + s;
    }
    double* yk = w.yc.data() + (size_t)k * n;
    for (int i = 0; i < n; ++i) {
      double s = pk[i];
      for (int jj = 0; jj < n; ++jj) s += Pk[i * n + jj] * (xk[jj] - xr[jj]);
      yk[i] = s;
    }
    w.dyn(w.xc.data() + (size_t)(k + 1) * n, xk, uk, w.h[k], k, w.user);
    ph += al_cost_knot(w, k, xk, uk, false);
    if (want_grad) {
      double* Jd = w.Jd.data();
      w.jac(Jd, xk, uk, w.h[k], k, w.user);  // [n, n+m]
      double* Ak = w.A.data() + (size_t)k * n * n;
      double* Bk = w.Bm.data() + (size_t)k * n * m;
      for (int i = 0; i < n; ++i) {
        for (int jj = 0; jj < n; ++jj) Ak[i * n + jj] = Jd[i * (n + m) + jj];
        for (int jj = 0; jj < m; ++jj) Bk[i * m + jj] = Jd[i * (n + m) + n + jj];
      }
      // du_da = -K dxda + d ; dxda' = A dxda + B du_da
      for (int i = 0; i < m; ++i) {
        double s = dk[i];
        for (int jj = 0; jj < n; ++jj) s -= Kk[i * n + jj] * w.dxda[jj];
        w.duda[i] = s;
      }
      double* lxk = w.lx.data() + (size_t)k * n;
      double* luk = w.lu.data() + (size_t)k * m;
      al_grad_knot(w, k, xk, uk, false, lxk, luk);
      dph += dotv(lxk, w.dxda.data(), n) + dotv(luk, w.duda.data(), m);
      // advance dxda (need temp)
      for (int i = 0; i < n; ++i) {
        double s = 0;
        for (int jj = 0; jj < n; ++jj) s += Ak[i * n + jj] * w.dxda[jj];
        for (int jj = 0; jj < m; ++jj) s += Bk[i * m + jj] * w.duda[jj];
        w.tmpv2[i] = s;
      }
      std::memcpy(w.dxda.data(), w.tmpv2.data(), sizeof(double) * n);
    }
  }
  // terminal
  double* xN = w.xc.data() + (size_t)N * n;
  ph += al_cost_knot(w, N, xN, nullptr, true);
  const double* PN = w.P.data() + (size_t)N * n * n;
  const double* pN = w.p.data() + (size_t)N * n;
  const double* xrN = w.x.data() + (size_t)N * n;
  double* yN = w.yc.data() + (size_t)N * n;
  for (int i = 0; i < n; ++i) {
    double s = pN[i];
    for (int jj = 0; jj < n; ++jj) s += PN[i * n + jj] * (xN[jj] - xrN[jj]);
    yN[i] = s;
  }
  if (want_grad) {
    double* lxN = w.lx.data() + (size_t)N * n;
    al_grad_knot(w, N, xN, nullptr, true, lxN, nullptr);
    dph += dotv(lxN, w.dxda.data(), n);
  }
  *phi = ph;
  if (dphi) *dphi = dph;
}

// Strong-Wolfe cubic line search (port of the reference semantics,
// linesearch.cpp:37-351, try_cubic_first = true).
struct LSResult {
  double alpha, phi, dphi;
  int code;  // 1 MINIMUM_FOUND, 7 HIT_MAX_STEPSIZE, else failure
  };

LSResult wolfe_ls(Workspace& w, double phi0, double dphi0) {
  const double c1 = w.opt.ls_c1, c2 = w.opt.ls_c2;
  const double alpha_max = 2.0, beta_inc = 1.5, beta_dec = 0.5;
  const int max_iters = 25;
  const double min_window = 1e-6;
  LSResult res{0, phi0, dphi0, 0};
  if (dphi0 >= 0) {
    res.code = 3;  // NOT_DESCENT
    return res;
  }
  double alpha = 1.0, alpha_prev = 0.0, phi_prev = phi0, dphi_prev = dphi0;
  bool hit_max = false;
  double phi, dphi;
  auto armijo = [&](double a, double ph) { return ph <= phi0 + c1 * a * dphi0; };
  auto wolfe = [&](double dp) { return std::fabs(dp) <= -c2 * dphi0; };

  double alo = 0, ahi = 0, phi_lo = 0, phi_hi = 0, dphi_lo = 0, dphi_hi = 0;
  bool zooming = false;

  for (int iter = 0; iter < max_iters; ++iter) {
    merit(w, alpha, true, &phi, &dphi);
    bool suff = armijo(alpha, phi);
    bool fnd = phi >= phi_prev;
    if (suff && wolfe(dphi)) {
      res = {alpha, phi, dphi, 1};
      return res;
    }
    if (iter == 0) {
      // try cubic on (0, alpha)
      double coeffs[5], ac;
      if (altro_cubic_fit(0, phi0, dphi0, alpha, phi, dphi, coeffs) == 0 &&
          altro_cubic_argmin(coeffs, &ac) == 0 && std::isfinite(ac)) {
        double phic, dphic;
        merit(w, ac, true, &phic, &dphic);
        ++iter;
        if (armijo(ac, phic) && wolfe(dphic)) {
          res = {ac, phic, dphic, 1};
          return res;
        }
      }
    }
    if (w.opt.use_backtracking) {
      double a = beta_dec;
      for (int bi = 1; bi < max_iters; ++bi) {
        merit(w, a, false, &phi, nullptr);
        if (armijo(a, phi)) {
          res = {a, phi, 0.0, 1};
          return res;
        }
        a *= beta_dec;
      }
      res = {a, phi, 0.0, 0};
      return res;
    }
    if (!suff || (iter > 0 && fnd)) {
      alo = alpha_prev; phi_lo = phi_prev; dphi_lo = dphi_prev;
      ahi = alpha; phi_hi = phi; dphi_hi = dphi;
      zooming = true;
      break;
    }
    if (dphi >= 0) {
      alo = alpha; phi_lo = phi; dphi_lo = dphi;
      ahi = alpha_prev; phi_hi = phi_prev; dphi_hi = dphi_prev;
      zooming = true;
      break;
    }
    alpha_prev = alpha; phi_prev = phi; dphi_prev = dphi;
    alpha *= beta_inc;
    if (alpha > alpha_max) {
      alpha = alpha_max;
      if (hit_max) {
        res = {alpha, phi, dphi, 7};
        return res;
      }
      hit_max = true;
    }
  }
  if (!zooming) {
    res = {alpha, phi, dphi, 0};
    return res;
  }
  // Zoom
  for (int zi = 0; zi < max_iters; ++zi) {
    double a;
    if (std::fabs(alo - ahi) < min_window) {
      a = 0.5 * (alo + ahi);
      merit(w, a, true, &phi, &dphi);
      bool ok = armijo(a, phi) && wolfe(dphi);
      res = {a, phi, dphi, ok ? 1 : 4};
      return res;
    }
    double coeffs[5];
    if (altro_cubic_fit(alo, phi_lo, dphi_lo, ahi, phi_hi, dphi_hi, coeffs) != 0 ||
        altro_cubic_argmin(coeffs, &a) != 0 || !std::isfinite(a)) {
      a = 0.5 * (alo + ahi);
    }
    merit(w, a, true, &phi, &dphi);
    bool suff = armijo(a, phi);
    if (suff && wolfe(dphi)) {
      res = {a, phi, dphi, 1};
      return res;
    }
    if (!suff || phi > phi_lo) {
      ahi = a; phi_hi = phi; dphi_hi = dphi;
    } else {
      if (dphi * (ahi - alo) <= 0) {
        ahi = alo; phi_hi = phi_lo; dphi_hi = dphi_lo;
      }
      alo = a; phi_lo = phi; dphi_lo = dphi;
    }
  }
  res = {alo, phi, dphi, 6};
  return res;
}

}  // namespace

extern "C" {

int altro_solve_native(int n, int m, int N, altro_dyn_fn dyn, altro_jac_fn jac,
                       void* user, const double* Qd, const double* Rd,
                       const double* q, const double* r, const double* cc,
                       const double* h, const double* x0,
                       const altro_constraint_t* cons, int ncons,
                       const altro_native_options_t* opts_in, double* x_io,
                       double* u_io, altro_native_stats_t* stats) {
  Workspace w;
  w.n = n; w.m = m; w.N = N;
  w.dyn = dyn; w.jac = jac; w.user = user;
  w.Qd = Qd; w.Rd = Rd; w.q = q; w.r = r; w.cc = cc; w.h = h; w.x0 = x0;
  w.cons = cons; w.ncons = ncons;
  if (opts_in) w.opt = *opts_in; else altro_native_default_options(&w.opt);

  const size_t sn = (size_t)(N + 1) * n, sm = (size_t)N * m;
  w.x.assign(sn, 0); w.u.assign(sm, 0);
  w.xc.assign(sn, 0); w.uc.assign(sm, 0); w.yc.assign(sn, 0);
  w.A.assign((size_t)N * n * n, 0); w.Bm.assign((size_t)N * n * m, 0);
  w.f0.assign((size_t)N * n, 0);
  w.lx.assign(sn, 0); w.lu.assign(sm, 0);
  w.lxx.assign((size_t)(N + 1) * n * n, 0);
  w.luu.assign((size_t)N * m * m, 0);
  w.lux.assign((size_t)N * m * n, 0);
  w.K.assign((size_t)N * m * n, 0); w.d.assign(sm, 0);
  w.P.assign((size_t)(N + 1) * n * n, 0); w.p.assign(sn, 0);
  w.tvwork.assign(altro_tvlqr_work_size(n, m) / sizeof(double), 0);
  w.z.resize(ncons);
  w.convals.resize(ncons);
  w.zproj.resize(ncons);
  for (int j = 0; j < ncons; ++j) {
    w.z[j].assign((size_t)(N + 1) * cons[j].dim, 0);
    w.convals[j].assign((size_t)(N + 1) * cons[j].dim, 0);
    w.zproj[j].assign((size_t)(N + 1) * cons[j].dim, 0);
  }
  int mp = w.max_p();
  w.Jd.assign((size_t)n * (n + m), 0);
  w.cjac.assign((size_t)mp * (n + m), 0);
  w.pj.assign((size_t)mp * mp, 0);
  w.ph.assign((size_t)mp * mp, 0);
  w.jt.assign((size_t)mp * (n + m), 0);
  w.tmpv.assign(std::max(mp, n + m), 0);
  w.tmpv2.assign(std::max(mp, n + m), 0);
  w.dxda.assign(n, 0);
  w.duda.assign(m, 0);
  w.uzero.assign(m, 0);
  w.rho = w.opt.penalty_initial;

  // Initial guess + open-loop rollout (solver.cpp:420-423)
  std::memcpy(w.u.data(), u_io, sizeof(double) * sm);
  std::memcpy(w.x.data(), x0, sizeof(double) * n);
  for (int k = 0; k < N; ++k)
    dyn(w.x.data() + (size_t)(k + 1) * n, w.x.data() + (size_t)k * n,
        w.u.data() + (size_t)k * m, h[k], k, user);
  std::memcpy(w.xc.data(), w.x.data(), sizeof(double) * sn);
  std::memcpy(w.uc.data(), w.u.data(), sizeof(double) * sm);

  int status = 1;  // Unsolved
  int iter = 0;
  double stat = 1e30, feas = 1e30, phi = 0;
  double reg = 0.0;

  // Seed candidate data (constraints/gradients at the rollout)
  for (int k = 0; k <= N; ++k) {
    const double* xk = w.xc.data() + (size_t)k * n;
    const double* uk = k < N ? w.uc.data() + (size_t)k * m : nullptr;
    al_cost_knot(w, k, xk, uk, k == N);
  }

  for (iter = 0; iter < w.opt.iterations_max; ++iter) {
    // Expansions at the reference trajectory
    for (int k = 0; k <= N; ++k) {
      const double* xk = w.x.data() + (size_t)k * n;
      const double* uk = k < N ? w.u.data() + (size_t)k * m : nullptr;
      bool terminal = (k == N);
      al_cost_knot(w, k, xk, uk, terminal);  // refresh convals/zproj
      al_grad_knot(w, k, xk, uk, terminal, w.lx.data() + (size_t)k * n,
                   terminal ? nullptr : w.lu.data() + (size_t)k * m);
      al_hess_knot(w, k, xk, uk, terminal, w.lxx.data() + (size_t)k * n * n,
                   terminal ? nullptr : w.luu.data() + (size_t)k * m * m,
                   terminal ? nullptr : w.lux.data() + (size_t)k * n * m);
      if (!terminal) {
        w.jac(w.Jd.data(), xk, uk, h[k], k, user);
        double* Ak = w.A.data() + (size_t)k * n * n;
        double* Bk = w.Bm.data() + (size_t)k * n * m;
        for (int i = 0; i < n; ++i) {
          for (int jj = 0; jj < n; ++jj) Ak[i * n + jj] = w.Jd[i * (n + m) + jj];
          for (int jj = 0; jj < m; ++jj)
            Bk[i * m + jj] = w.Jd[i * (n + m) + n + jj];
        }
      }
    }
    // Backward pass with adaptive regularization
    int bp = -2;
    for (int tries = 0; tries <= 12; ++tries) {
      bp = altro_tvlqr_backward(n, m, N, w.A.data(), w.Bm.data(), w.f0.data(),
                                w.lxx.data(), w.luu.data(), w.lux.data(),
                                w.lx.data(), w.lu.data(), reg, w.K.data(),
                                w.d.data(), w.P.data(), w.p.data(), w.dV,
                                w.tvwork.data());
      if (bp == -1) break;
      reg = reg <= 0 ? 1e-8 : reg * 10.0;
    }
    if (bp != -1) { status = 7; break; }

    // Merit at 0 via the expected-decrease identity; line search
    double phi0, dphi0;
    merit(w, 0.0, true, &phi0, &dphi0);
    double alpha;
    bool ls_failed = false;
    if (std::fabs(dphi0) < w.opt.tol_merit_grad) {
      alpha = 0.0;
      merit(w, 0.0, true, &phi, nullptr);
    } else {
      LSResult ls = wolfe_ls(w, phi0, dphi0);
      alpha = ls.alpha;
      ls_failed = !(ls.code == 1 || ls.code == 7) || !std::isfinite(alpha);
      // Final data at the accepted step
      merit(w, alpha, true, &phi, nullptr);
    }

    // Stationarity / feasibility at the candidate
    stat = 0;
    for (int k = 0; k < N; ++k) {
      const double* Ak = w.A.data() + (size_t)k * n * n;
      const double* Bk = w.Bm.data() + (size_t)k * n * m;
      const double* yk = w.yc.data() + (size_t)k * n;
      const double* yn = w.yc.data() + (size_t)(k + 1) * n;
      for (int i = 0; i < n; ++i) {
        double s = w.lx[(size_t)k * n + i] - yk[i];
        for (int jj = 0; jj < n; ++jj) s += Ak[jj * n + i] * yn[jj];
        stat = std::max(stat, std::fabs(s));
      }
      for (int i = 0; i < m; ++i) {
        double s = w.lu[(size_t)k * m + i];
        for (int jj = 0; jj < n; ++jj) s += Bk[jj * m + i] * yn[jj];
        stat = std::max(stat, std::fabs(s));
      }
    }
    for (int i = 0; i < n; ++i)
      stat = std::max(stat, std::fabs(w.lx[(size_t)N * n + i] -
                                      w.yc[(size_t)N * n + i]));
    feas = 0;
    for (int j = 0; j < w.ncons; ++j) {
      int p = w.cons[j].dim;
      for (int k = 0; k <= N; ++k) {
        if (!w.cons[j].active[k]) continue;
        const double* cv = w.convals[j].data() + (size_t)k * p;
        cone_project(w.cons[j].cone, p, cv, w.tmpv.data());
        for (int i = 0; i < p; ++i)
          feas = std::max(feas, std::fabs(w.tmpv[i] - cv[i]));
      }
    }

    // Accept candidate
    std::swap(w.x, w.xc);
    std::swap(w.u, w.uc);

    bool converged = stat < w.opt.tol_stationarity && feas < w.opt.tol_feasibility;
    if (converged) status = 0;

    // Adaptive dual/penalty update (solver.cpp:474-489)
    if (stat < std::sqrt(w.opt.tol_stationarity)) {
      for (int j = 0; j < w.ncons; ++j) {
        int p = w.cons[j].dim;
        for (int k = 0; k <= N; ++k) {
          if (!w.cons[j].active[k]) continue;
          std::memcpy(w.z[j].data() + (size_t)k * p,
                      w.zproj[j].data() + (size_t)k * p, sizeof(double) * p);
        }
      }
      if (feas > w.opt.tol_feasibility)
        w.rho = std::min(w.rho * w.opt.penalty_scaling, w.opt.penalty_max);
    }

    if (converged || ls_failed) {
      if (!converged && ls_failed) status = 8;
      ++iter;
      break;
    }
  }
  if (status == 1) status = 2;  // MaxIterations

  std::memcpy(x_io, w.x.data(), sizeof(double) * sn);
  std::memcpy(u_io, w.u.data(), sizeof(double) * sm);
  if (stats) {
    stats->status = status;
    stats->iterations = iter;
    stats->stationarity = stat;
    stats->feasibility = feas;
    stats->objective = phi;
  }
  return status;
}

}  // extern "C"
