// neptune_rt — native host solver runtime.
//
// C++ replacement for the role PETSc plays in the reference
// (lib/Runtime/PETSc/NeptunePETScRuntime.cpp): matrix-free Krylov solvers
// (KSP analog: CG / BiCGStab / restarted GMRES) and a residual-only
// Newton–Krylov driver (SNES NEWTONLS + matrix-free J·v analog,
// NeptunePETScRuntime.cpp:449-451) that call back into AOT-compiled stencil
// kernels through a plain function pointer — the direct-call equivalent of
// the reference's dlsym-resolved MatShell callback (:182-230).
//
// Built as libneptune_rt.so by neptune_tpu_torch.runtime.aot; generated kernel
// modules link against it.

#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <algorithm>

static void nrt_warn_unconverged(const char* what, long iters, double resnorm) {
  std::fprintf(stderr,
               "[neptune_rt] WARNING: %s did not converge (iters=%ld "
               "resnorm=%.3e)\n", what, iters, resnorm);
}

extern "C" {

// y = A x; ctx carries the generated module's closure (capture buffers etc.)
typedef void (*neptune_matvec_fn)(const double* x, double* y, void* ctx);
// F(u) -> r with p captures bound in ctx
typedef void (*neptune_residual_fn)(const double* u, double* r, void* ctx);

typedef struct {
  long   iters;
  double resnorm;
  int    converged;
} neptune_solve_stats;

// ---------------------------------------------------------------------------
// BLAS-1 helpers (single-threaded; the host oracle favors determinism)
// ---------------------------------------------------------------------------

static double nrt_dot(const double* a, const double* b, long n) {
  double s = 0.0;
  for (long i = 0; i < n; ++i) s += a[i] * b[i];
  return s;
}

static void nrt_axpy(double alpha, const double* x, double* y, long n) {
  for (long i = 0; i < n; ++i) y[i] += alpha * x[i];
}

static void nrt_scal_assign(double alpha, const double* x, double* y, long n) {
  for (long i = 0; i < n; ++i) y[i] = alpha * x[i];
}

// ---------------------------------------------------------------------------
// CG (Jacobi-optional): reference KSP solver option "cg"
// ---------------------------------------------------------------------------

void neptune_rt_cg(neptune_matvec_fn A, void* ctx, const double* b, double* x,
                   long n, double tol, long maxiter, const double* inv_diag,
                   neptune_solve_stats* stats) {
  double* r  = (double*)std::malloc(sizeof(double) * n);
  double* z  = (double*)std::malloc(sizeof(double) * n);
  double* p  = (double*)std::malloc(sizeof(double) * n);
  double* Ap = (double*)std::malloc(sizeof(double) * n);

  std::memset(x, 0, sizeof(double) * n);
  std::memcpy(r, b, sizeof(double) * n);
  double bnorm  = std::sqrt(nrt_dot(b, b, n));
  double target = tol * (bnorm > 0 ? bnorm : 1.0);

  if (inv_diag) for (long i = 0; i < n; ++i) z[i] = r[i] * inv_diag[i];
  else          std::memcpy(z, r, sizeof(double) * n);
  std::memcpy(p, z, sizeof(double) * n);
  double rz = nrt_dot(r, z, n);
  double rnorm = std::sqrt(nrt_dot(r, r, n));

  long k = 0;
  while (k < maxiter && rnorm > target) {
    A(p, Ap, ctx);
    double pAp = nrt_dot(p, Ap, n);
    double alpha = rz / (pAp != 0 ? pAp : 1.0);
    nrt_axpy(alpha, p, x, n);
    nrt_axpy(-alpha, Ap, r, n);
    if (inv_diag) for (long i = 0; i < n; ++i) z[i] = r[i] * inv_diag[i];
    else          std::memcpy(z, r, sizeof(double) * n);
    double rz_new = nrt_dot(r, z, n);
    double beta = rz_new / (rz != 0 ? rz : 1.0);
    for (long i = 0; i < n; ++i) p[i] = z[i] + beta * p[i];
    rz = rz_new;
    rnorm = std::sqrt(nrt_dot(r, r, n));
    ++k;
  }
  if (rnorm > target) nrt_warn_unconverged("cg", k, rnorm);
  if (stats) { stats->iters = k; stats->resnorm = rnorm; stats->converged = rnorm <= target; }
  std::free(r); std::free(z); std::free(p); std::free(Ap);
}

// ---------------------------------------------------------------------------
// BiCGStab: reference KSP solver option "bicgstab"
// ---------------------------------------------------------------------------

void neptune_rt_bicgstab(neptune_matvec_fn A, void* ctx, const double* b,
                         double* x, long n, double tol, long maxiter,
                         neptune_solve_stats* stats) {
  double *r, *rhat, *p, *v, *s, *t;
  r = (double*)std::malloc(sizeof(double) * n);
  rhat = (double*)std::malloc(sizeof(double) * n);
  p = (double*)std::calloc(n, sizeof(double));
  v = (double*)std::calloc(n, sizeof(double));
  s = (double*)std::malloc(sizeof(double) * n);
  t = (double*)std::malloc(sizeof(double) * n);

  std::memset(x, 0, sizeof(double) * n);
  std::memcpy(r, b, sizeof(double) * n);
  std::memcpy(rhat, b, sizeof(double) * n);
  double bnorm = std::sqrt(nrt_dot(b, b, n));
  double target = tol * (bnorm > 0 ? bnorm : 1.0);
  double rho = 1.0, alpha = 1.0, omega = 1.0;
  double rnorm = std::sqrt(nrt_dot(r, r, n));

  long k = 0;
  while (k < maxiter && rnorm > target) {
    double rho_new = nrt_dot(rhat, r, n);
    double beta = (rho_new / (rho != 0 ? rho : 1.0)) * (alpha / (omega != 0 ? omega : 1.0));
    for (long i = 0; i < n; ++i) p[i] = r[i] + beta * (p[i] - omega * v[i]);
    A(p, v, ctx);
    double denom = nrt_dot(rhat, v, n);
    alpha = rho_new / (denom != 0 ? denom : 1.0);
    for (long i = 0; i < n; ++i) s[i] = r[i] - alpha * v[i];
    A(s, t, ctx);
    double tt = nrt_dot(t, t, n);
    omega = nrt_dot(t, s, n) / (tt != 0 ? tt : 1.0);
    for (long i = 0; i < n; ++i) x[i] += alpha * p[i] + omega * s[i];
    for (long i = 0; i < n; ++i) r[i] = s[i] - omega * t[i];
    rho = rho_new;
    rnorm = std::sqrt(nrt_dot(r, r, n));
    ++k;
  }
  if (rnorm > target) nrt_warn_unconverged("bicgstab", k, rnorm);
  if (stats) { stats->iters = k; stats->resnorm = rnorm; stats->converged = rnorm <= target; }
  std::free(r); std::free(rhat); std::free(p); std::free(v); std::free(s); std::free(t);
}

// ---------------------------------------------------------------------------
// Restarted GMRES(m): the reference KSP default (GMRES + PCNONE,
// NeptunePETScRuntime.cpp:146-149)
// ---------------------------------------------------------------------------

void neptune_rt_gmres(neptune_matvec_fn A, void* ctx, const double* b,
                      double* x, long n, double tol, long maxiter, long restart,
                      neptune_solve_stats* stats) {
  long m = std::min<long>(restart, std::min<long>(maxiter, n));
  double* V  = (double*)std::malloc(sizeof(double) * (m + 1) * n);
  double* H  = (double*)std::calloc((m + 1) * m, sizeof(double));
  double* cs = (double*)std::malloc(sizeof(double) * m);
  double* sn = (double*)std::malloc(sizeof(double) * m);
  double* g  = (double*)std::malloc(sizeof(double) * (m + 1));
  double* w  = (double*)std::malloc(sizeof(double) * n);
  double* y  = (double*)std::malloc(sizeof(double) * m);

  std::memset(x, 0, sizeof(double) * n);
  double bnorm = std::sqrt(nrt_dot(b, b, n));
  double target = tol * (bnorm > 0 ? bnorm : 1.0);

  long total_iters = 0;
  double resnorm = bnorm;
  while (total_iters < maxiter && resnorm > target) {
    // r = b - A x
    A(x, w, ctx);
    double* r = V;  // row 0
    for (long i = 0; i < n; ++i) r[i] = b[i] - w[i];
    double beta = std::sqrt(nrt_dot(r, r, n));
    if (beta <= target) { resnorm = beta; break; }
    nrt_scal_assign(1.0 / beta, r, V, n);
    std::memset(g, 0, sizeof(double) * (m + 1));
    g[0] = beta;

    long j = 0;
    for (; j < m && total_iters < maxiter; ++j, ++total_iters) {
      A(V + j * n, w, ctx);
      for (long i = 0; i <= j; ++i) {
        double hij = nrt_dot(V + i * n, w, n);
        H[i * m + j] = hij;
        nrt_axpy(-hij, V + i * n, w, n);
      }
      double hjp1 = std::sqrt(nrt_dot(w, w, n));
      H[(j + 1) * m + j] = hjp1;
      if (hjp1 != 0.0) nrt_scal_assign(1.0 / hjp1, w, V + (j + 1) * n, n);

      for (long i = 0; i < j; ++i) {
        double h0 = H[i * m + j], h1 = H[(i + 1) * m + j];
        H[i * m + j]       =  cs[i] * h0 + sn[i] * h1;
        H[(i + 1) * m + j] = -sn[i] * h0 + cs[i] * h1;
      }
      double h0 = H[j * m + j], h1 = H[(j + 1) * m + j];
      double d = std::sqrt(h0 * h0 + h1 * h1);
      cs[j] = d != 0 ? h0 / d : 1.0;
      sn[j] = d != 0 ? h1 / d : 0.0;
      H[j * m + j] = cs[j] * h0 + sn[j] * h1;
      H[(j + 1) * m + j] = 0.0;
      g[j + 1] = -sn[j] * g[j];
      g[j]     =  cs[j] * g[j];
      resnorm = std::fabs(g[j + 1]);
      if (resnorm <= target) { ++j; ++total_iters; break; }
    }

    // back substitution on the j x j system
    for (long i = j - 1; i >= 0; --i) {
      double s = g[i];
      for (long kk = i + 1; kk < j; ++kk) s -= H[i * m + kk] * y[kk];
      double Hii = H[i * m + i];
      y[i] = s / (Hii != 0 ? Hii : 1.0);
    }
    for (long i = 0; i < j; ++i) nrt_axpy(y[i], V + i * n, x, n);
  }
  if (resnorm > target) nrt_warn_unconverged("gmres", total_iters, resnorm);
  if (stats) { stats->iters = total_iters; stats->resnorm = resnorm; stats->converged = resnorm <= target; }
  std::free(V); std::free(H); std::free(cs); std::free(sn);
  std::free(g); std::free(w); std::free(y);
}

// ---------------------------------------------------------------------------
// Newton–Krylov (JFNK): SNES NEWTONLS analog. J·v by finite differences —
// exactly the reference's matrix-free mode (SNESSetUseMatrixFree(TRUE,TRUE)).
// ---------------------------------------------------------------------------

typedef struct {
  neptune_residual_fn F;
  void* fctx;
  const double* u;   // linearization point
  const double* Fu;  // F(u)
  double* utmp;
  double* rtmp;
  long n;
} nrt_jfnk_ctx;

static void nrt_jfnk_matvec(const double* v, double* y, void* ctx_) {
  nrt_jfnk_ctx* c = (nrt_jfnk_ctx*)ctx_;
  long n = c->n;
  double vnorm = std::sqrt(nrt_dot(v, v, n));
  if (vnorm == 0.0) { std::memset(y, 0, sizeof(double) * n); return; }
  double unorm = std::sqrt(nrt_dot(c->u, c->u, n));
  double eps = 1e-7 * (unorm / vnorm + 1e-12) + 1e-12;
  for (long i = 0; i < n; ++i) c->utmp[i] = c->u[i] + eps * v[i];
  c->F(c->utmp, c->rtmp, c->fctx);
  double inv = 1.0 / eps;
  for (long i = 0; i < n; ++i) y[i] = (c->rtmp[i] - c->Fu[i]) * inv;
}

void neptune_rt_newton(neptune_residual_fn F, void* fctx, double* u, long n,
                       double tol, long max_iters, double krylov_tol,
                       long krylov_iters, neptune_solve_stats* stats) {
  double* Fu  = (double*)std::malloc(sizeof(double) * n);
  double* rhs = (double*)std::malloc(sizeof(double) * n);
  double* dx  = (double*)std::malloc(sizeof(double) * n);
  double* ut  = (double*)std::malloc(sizeof(double) * n);
  double* rt  = (double*)std::malloc(sizeof(double) * n);
  double* trial = (double*)std::malloc(sizeof(double) * n);

  F(u, Fu, fctx);
  double f0 = std::sqrt(nrt_dot(Fu, Fu, n));
  double target = std::max(tol * f0, 1e-14);
  double fnorm = f0;

  long k = 0;
  long stall = 0;
  while (k < max_iters && fnorm > target && stall < 2) {
    nrt_jfnk_ctx jc = {F, fctx, u, Fu, ut, rt, n};
    for (long i = 0; i < n; ++i) rhs[i] = -Fu[i];
    neptune_rt_gmres(nrt_jfnk_matvec, &jc, rhs, dx, n, krylov_tol,
                     krylov_iters, 30, nullptr);

    // Armijo backtracking with best-lambda fallback
    double lam = 1.0, best_lam = 1.0, min_fn = 1e300, min_lam = 1.0;
    int accepted = 0;
    for (int bt = 0; bt < 25; ++bt) {
      for (long i = 0; i < n; ++i) trial[i] = u[i] + lam * dx[i];
      F(trial, rt, fctx);
      double fn = std::sqrt(nrt_dot(rt, rt, n));
      if (!accepted && fn <= (1.0 - 1e-4 * lam) * fnorm) { best_lam = lam; accepted = 1; }
      if (fn < min_fn) { min_fn = fn; min_lam = lam; }
      if (accepted) break;
      lam *= 0.5;
    }
    double step = accepted ? best_lam : min_lam;
    for (long i = 0; i < n; ++i) u[i] += step * dx[i];
    F(u, Fu, fctx);
    double fnew = std::sqrt(nrt_dot(Fu, Fu, n));
    stall = (fnew >= fnorm) ? stall + 1 : 0;
    fnorm = fnew;
    ++k;
  }
  if (fnorm > target) nrt_warn_unconverged("newton", k, fnorm);
  if (stats) { stats->iters = k; stats->resnorm = fnorm; stats->converged = fnorm <= target; }
  std::free(Fu); std::free(rhs); std::free(dx);
  std::free(ut); std::free(rt); std::free(trial);
}

// ---------------------------------------------------------------------------
// buffer helpers for generated code / Python
// ---------------------------------------------------------------------------

double* neptune_rt_alloc(long n) { return (double*)std::malloc(sizeof(double) * n); }
void neptune_rt_free(void* p) { std::free(p); }

}  // extern "C"
