// altro_tpu native runtime: allocation-free TVLQR kernel + cubic line-search
// core for the latency-critical single-solve host path (the JAX framework's
// answer to the reference's embedded/Teensy deployment target,
// /root/reference/src/tvlqr/tvlqr.cpp — re-implemented self-contained,
// dependency-free, row-major, no Eigen).
//
// Design contract (parity with the reference's memory discipline):
//   * the solve path performs ZERO heap allocation — callers provide a
//     workspace sized by altro_tvlqr_work_size()
//   * Cholesky failure returns the failing knot index (>= 0); success
//     returns ALTRO_NATIVE_SUCCESS (-1)
//
// Exposed with a plain C ABI for ctypes (no pybind11 in this image).

#include <cmath>
#include <cstddef>
#include <cstring>

#define ALTRO_NATIVE_SUCCESS (-1)

namespace {

// ---------------------------------------------------------------------------
// Small dense helpers, row-major, no aliasing between out and inputs.
// ---------------------------------------------------------------------------

// out[r,c] = sum_k a[k,r] * b[k,c]   (a^T b), a: [p, r], b: [p, c]
inline void mat_tn(const double* a, const double* b, double* out, int p, int r,
                   int c) {
  for (int i = 0; i < r; ++i)
    for (int j = 0; j < c; ++j) {
      double s = 0.0;
      for (int k = 0; k < p; ++k) s += a[k * r + i] * b[k * c + j];
      out[i * c + j] = s;
    }
}

// out[r,c] += a[r,p] * b[p,c]
inline void mat_nn_acc(const double* a, const double* b, double* out, int r,
                       int p, int c) {
  for (int i = 0; i < r; ++i)
    for (int j = 0; j < c; ++j) {
      double s = 0.0;
      for (int k = 0; k < p; ++k) s += a[i * p + k] * b[k * c + j];
      out[i * c + j] += s;
    }
}

// y = M x (M: [r, c])
inline void matvec(const double* M, const double* x, double* y, int r, int c) {
  for (int i = 0; i < r; ++i) {
    double s = 0.0;
    for (int j = 0; j < c; ++j) s += M[i * c + j] * x[j];
    y[i] = s;
  }
}

// y += M^T x (M: [r, c], x: [r], y: [c])
inline void matTvec_acc(const double* M, const double* x, double* y, int r,
                        int c) {
  for (int j = 0; j < c; ++j) {
    double s = 0.0;
    for (int i = 0; i < r; ++i) s += M[i * c + j] * x[i];
    y[j] += s;
  }
}

inline double dot(const double* a, const double* b, int n) {
  double s = 0.0;
  for (int i = 0; i < n; ++i) s += a[i] * b[i];
  return s;
}

// In-place lower Cholesky of SPD M [m, m]. Returns 0 on success.
inline int cholesky(double* M, int m) {
  for (int j = 0; j < m; ++j) {
    double diag = M[j * m + j];
    for (int k = 0; k < j; ++k) diag -= M[j * m + k] * M[j * m + k];
    if (!(diag > 0.0) || !std::isfinite(diag)) return 1;
    const double ljj = std::sqrt(diag);
    M[j * m + j] = ljj;
    for (int i = j + 1; i < m; ++i) {
      double s = M[i * m + j];
      for (int k = 0; k < j; ++k) s -= M[i * m + k] * M[j * m + k];
      M[i * m + j] = s / ljj;
    }
    for (int k = j + 1; k < m; ++k) M[j * m + k] = 0.0;  // zero upper
  }
  return 0;
}

// Solve (L L^T) X = B in place; L: [m, m] lower, B: [m, nrhs] row-major.
inline void chol_solve(const double* L, double* B, int m, int nrhs) {
  // forward: L Y = B
  for (int i = 0; i < m; ++i)
    for (int j = 0; j < nrhs; ++j) {
      double s = B[i * nrhs + j];
      for (int k = 0; k < i; ++k) s -= L[i * m + k] * B[k * nrhs + j];
      B[i * nrhs + j] = s / L[i * m + i];
    }
  // backward: L^T X = Y
  for (int i = m - 1; i >= 0; --i)
    for (int j = 0; j < nrhs; ++j) {
      double s = B[i * nrhs + j];
      for (int k = i + 1; k < m; ++k) s -= L[k * m + i] * B[k * nrhs + j];
      B[i * nrhs + j] = s / L[i * m + i];
    }
}

}  // namespace

extern "C" {

// Workspace doubles needed by the backward pass for (n, m).
size_t altro_tvlqr_work_size(int n, int m) {
  // AtP[n*n] + BtP[m*n] + t[n] + Quu_chol[m*m] + QuuK[m*n] + KtQux[n*n]
  // + Qxx[n*n] + Quu[m*m] + Qux[m*n] + Qx[n] + Qu[m] + tmpv[m]
  return static_cast<size_t>(3 * n * n + 3 * m * n + 2 * m * m + 2 * n +
                             2 * m) *
         sizeof(double);
}

// Riccati backward pass over stacked row-major arrays:
//   A: [N, n, n], B: [N, n, m], f: [N, n]
//   lxx: [N+1, n, n], luu: [N, m, m], lux: [N, m, n], lx: [N+1, n], lu: [N, m]
// Outputs: K [N, m, n], d [N, m], P [N+1, n, n], p [N+1, n], dV [2].
// Returns ALTRO_NATIVE_SUCCESS or the failing knot index.
int altro_tvlqr_backward(int n, int m, int N, const double* A, const double* B,
                         const double* f, const double* lxx, const double* luu,
                         const double* lux, const double* lx, const double* lu,
                         double reg, double* K, double* d, double* P, double* p,
                         double* dV, double* work) {
  double* AtP = work;
  double* BtP = AtP + n * n;
  double* t = BtP + m * n;
  double* chol = t + n;
  double* QuuK = chol + m * m;
  double* KtQux = QuuK + m * n;
  double* Qxx = KtQux + n * n;
  double* Quu = Qxx + n * n;
  double* Qux = Quu + m * m;
  double* Qx = Qux + m * n;
  double* Qu = Qx + n;
  double* tmpv = Qu + m;

  // Terminal cost-to-go
  std::memcpy(P + static_cast<size_t>(N) * n * n, lxx + static_cast<size_t>(N) * n * n,
              sizeof(double) * n * n);
  std::memcpy(p + static_cast<size_t>(N) * n, lx + static_cast<size_t>(N) * n,
              sizeof(double) * n);
  dV[0] = 0.0;
  dV[1] = 0.0;

  for (int k = N - 1; k >= 0; --k) {
    const double* A_k = A + static_cast<size_t>(k) * n * n;
    const double* B_k = B + static_cast<size_t>(k) * n * m;
    const double* f_k = f + static_cast<size_t>(k) * n;
    const double* Pn = P + static_cast<size_t>(k + 1) * n * n;
    const double* pn = p + static_cast<size_t>(k + 1) * n;
    double* K_k = K + static_cast<size_t>(k) * m * n;
    double* d_k = d + static_cast<size_t>(k) * m;
    double* P_k = P + static_cast<size_t>(k) * n * n;
    double* p_k = p + static_cast<size_t>(k) * n;

    // AtP = A^T P', BtP = B^T P'
    mat_tn(A_k, Pn, AtP, n, n, n);
    mat_tn(B_k, Pn, BtP, n, m, n);

    // Qxx = lxx + AtP A; Quu = luu + BtP B; Qux = lux + BtP A
    std::memcpy(Qxx, lxx + static_cast<size_t>(k) * n * n, sizeof(double) * n * n);
    mat_nn_acc(AtP, A_k, Qxx, n, n, n);
    std::memcpy(Quu, luu + static_cast<size_t>(k) * m * m, sizeof(double) * m * m);
    mat_nn_acc(BtP, B_k, Quu, m, n, m);
    std::memcpy(Qux, lux + static_cast<size_t>(k) * m * n, sizeof(double) * m * n);
    mat_nn_acc(BtP, A_k, Qux, m, n, n);

    // t = P' f + p'; Qx = lx + A^T t; Qu = lu + B^T t
    matvec(Pn, f_k, t, n, n);
    for (int i = 0; i < n; ++i) t[i] += pn[i];
    std::memcpy(Qx, lx + static_cast<size_t>(k) * n, sizeof(double) * n);
    matTvec_acc(A_k, t, Qx, n, n);
    std::memcpy(Qu, lu + static_cast<size_t>(k) * m, sizeof(double) * m);
    matTvec_acc(B_k, t, Qu, n, m);

    // Gains: (Quu + reg I) \ [Qux, -Qu]
    std::memcpy(chol, Quu, sizeof(double) * m * m);
    for (int i = 0; i < m; ++i) chol[i * m + i] += reg;
    if (cholesky(chol, m) != 0) return k;
    std::memcpy(K_k, Qux, sizeof(double) * m * n);
    chol_solve(chol, K_k, m, n);
    for (int i = 0; i < m; ++i) d_k[i] = -Qu[i];
    chol_solve(chol, d_k, m, 1);

    // Cost-to-go: P = Qxx + (Quu K)^T K - K^T Qux - (K^T Qux)^T
    for (int i = 0; i < m; ++i)
      for (int j = 0; j < n; ++j) {
        double s = 0.0;
        for (int kk = 0; kk < m; ++kk) s += Quu[i * m + kk] * K_k[kk * n + j];
        QuuK[i * n + j] = s;
      }
    mat_tn(K_k, Qux, KtQux, m, n, n);
    std::memcpy(P_k, Qxx, sizeof(double) * n * n);
    for (int i = 0; i < n; ++i)
      for (int j = 0; j < n; ++j) {
        double s = 0.0;
        for (int kk = 0; kk < m; ++kk) s += QuuK[kk * n + i] * K_k[kk * n + j];
        P_k[i * n + j] += s - KtQux[i * n + j] - KtQux[j * n + i];
      }

    // p = Qx - (Quu K)^T d - K^T Qu + Qux^T d
    std::memcpy(p_k, Qx, sizeof(double) * n);
    for (int j = 0; j < n; ++j) {
      double s = 0.0;
      for (int i = 0; i < m; ++i)
        s += -QuuK[i * n + j] * d_k[i] - K_k[i * n + j] * Qu[i] +
             Qux[i * n + j] * d_k[i];
      p_k[j] += s;
    }

    // Expected decrease
    matvec(Quu, d_k, tmpv, m, m);
    dV[0] += dot(d_k, Qu, m);
    dV[1] += 0.5 * dot(d_k, tmpv, m);
  }
  return ALTRO_NATIVE_SUCCESS;
}

// Affine closed-loop rollout: u = d - K x; x' = A x + B u + f; y = P x + p.
int altro_tvlqr_forward(int n, int m, int N, const double* A, const double* B,
                        const double* f, const double* K, const double* d,
                        const double* P, const double* p, const double* x0,
                        double* x, double* u, double* y) {
  std::memcpy(x, x0, sizeof(double) * n);
  for (int k = 0; k < N; ++k) {
    const double* A_k = A + static_cast<size_t>(k) * n * n;
    const double* B_k = B + static_cast<size_t>(k) * n * m;
    const double* f_k = f + static_cast<size_t>(k) * n;
    const double* K_k = K + static_cast<size_t>(k) * m * n;
    const double* d_k = d + static_cast<size_t>(k) * m;
    const double* x_k = x + static_cast<size_t>(k) * n;
    double* u_k = u + static_cast<size_t>(k) * m;
    double* x_n = x + static_cast<size_t>(k + 1) * n;

    for (int i = 0; i < m; ++i) {
      double s = d_k[i];
      for (int j = 0; j < n; ++j) s -= K_k[i * n + j] * x_k[j];
      u_k[i] = s;
    }
    for (int i = 0; i < n; ++i) {
      double s = f_k[i];
      for (int j = 0; j < n; ++j) s += A_k[i * n + j] * x_k[j];
      for (int j = 0; j < m; ++j) s += B_k[i * m + j] * u_k[j];
      x_n[i] = s;
    }
    if (y) {
      const double* P_k = P + static_cast<size_t>(k) * n * n;
      const double* p_k = p + static_cast<size_t>(k) * n;
      double* y_k = y + static_cast<size_t>(k) * n;
      matvec(P_k, x_k, y_k, n, n);
      for (int i = 0; i < n; ++i) y_k[i] += p_k[i];
    }
  }
  if (y) {
    const double* P_N = P + static_cast<size_t>(N) * n * n;
    const double* p_N = p + static_cast<size_t>(N) * n;
    const double* x_N = x + static_cast<size_t>(N) * n;
    double* y_N = y + static_cast<size_t>(N) * n;
    matvec(P_N, x_N, y_N, n, n);
    for (int i = 0; i < n; ++i) y_N[i] += p_N[i];
  }
  return ALTRO_NATIVE_SUCCESS;
}

// ---------------------------------------------------------------------------
// Cubic spline line-search core (re-derivation of the semantics of
// /root/reference/src/linesearch/cubicspline.c for the host-side path).
// Spline: y = a + b t + c t^2 + d t^3, t = x - x0. Returns 0 on success.
// ---------------------------------------------------------------------------

int altro_cubic_fit(double x1, double y1, double d1, double x2, double y2,
                    double d2, double* coeffs /* [5]: x0, a, b, c, d */) {
  const double tol = 1e-6;
  const double delta = x2 - x1;
  if (std::fabs(delta) < tol) return 1;
  coeffs[0] = x1;
  coeffs[1] = y1;
  coeffs[2] = d1;
  coeffs[3] = 3.0 * (y2 - y1) / (delta * delta) - (d2 + 2.0 * d1) / delta;
  coeffs[4] = (d2 + d1) / (delta * delta) -
              2.0 * (y2 - y1) / (delta * delta * delta);
  return 0;
}

// Returns 0 and writes *x_min when a strict local minimum exists; 1 otherwise.
int altro_cubic_argmin(const double* coeffs, double* x_min) {
  const double tol = 1e-6;
  const double x0 = coeffs[0], b = coeffs[2], c = coeffs[3], d = coeffs[4];
  const bool quadratic = std::fabs(d) < tol;
  if (quadratic) {
    if (std::fabs(c) < tol) return 1;  // linear/constant
    if (c <= 0.0) return 1;            // concave
    *x_min = -b / (2.0 * c) + x0;
    return 0;
  }
  const double qa = 3.0 * d, qb = 2.0 * c, qc = b;
  double s2 = qb * qb - 4.0 * qa * qc;
  double s = (std::fabs(s2) < tol) ? 0.0 : (s2 < 0.0 ? -1.0 : std::sqrt(s2));
  if (s < 0.0) return 1;  // complex roots
  const double t1 = (-qb + s) / (2.0 * qa);
  const double t2 = (-qb - s) / (2.0 * qa);
  const double curv1 = 2.0 * c + 6.0 * d * t1;
  const double curv2 = 2.0 * c + 6.0 * d * t2;
  if (curv1 > 0.0 && curv2 < 0.0) {
    *x_min = t1 + x0;
    return 0;
  }
  if (curv1 < 0.0 && curv2 > 0.0) {
    *x_min = t2 + x0;
    return 0;
  }
  return 1;  // saddle / degenerate
}

}  // extern "C"
