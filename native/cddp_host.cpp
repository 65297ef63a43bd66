// cddp-tpu native host runtime.
//
// C++ counterpart of the framework's CPU-side numerics, filling the role the
// reference's C++ core plays outside the accelerator compute path:
//
//  - an independent double-precision BoxQP (projected-Newton active-set,
//    same algorithm family as src/cddp_core/boxqp.cpp) used as a
//    cross-language oracle in the test suite and as a host-side fallback;
//  - a dense LQR backward Riccati sweep (the verification oracle for the
//    lax.scan recursions);
//  - a std::thread batched BoxQP driver — the host-runtime analogue of the
//    reference's std::async fan-out (cddp_solver_base.cpp:264-314) for
//    workloads that stay on CPU.
//
// Exposed as a plain C ABI for ctypes (no pybind11 dependency).
// Build: g++ -O3 -march=native -shared -fPIC cddp_host.cpp -o libcddp_host.so

#include <algorithm>
#include <cmath>
#include <complex>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// Solve A x = b for small dense symmetric PD A (n <= 16) via Cholesky.
// Returns false if not PD.
bool chol_solve(const double* A, const double* b, double* x, int n,
                int nrhs, double* work /* n*n */) {
  // Factor A = L L^T into work.
  std::memcpy(work, A, sizeof(double) * n * n);
  for (int j = 0; j < n; ++j) {
    double d = work[j * n + j];
    for (int k = 0; k < j; ++k) d -= work[j * n + k] * work[j * n + k];
    if (!(d > 0.0) || !std::isfinite(d)) return false;
    const double Ljj = std::sqrt(d);
    work[j * n + j] = Ljj;
    for (int i = j + 1; i < n; ++i) {
      double s = work[i * n + j];
      for (int k = 0; k < j; ++k) s -= work[i * n + k] * work[j * n + k];
      work[i * n + j] = s / Ljj;
    }
  }
  // Solve L y = b, L^T x = y for each rhs column (b is n x nrhs, row-major).
  for (int r = 0; r < nrhs; ++r) {
    for (int i = 0; i < n; ++i) {
      double s = b[i * nrhs + r];
      for (int k = 0; k < i; ++k) s -= work[i * n + k] * x[k * nrhs + r];
      x[i * nrhs + r] = s / work[i * n + i];
    }
    for (int i = n - 1; i >= 0; --i) {
      double s = x[i * nrhs + r];
      for (int k = i + 1; k < n; ++k) s -= work[k * n + i] * x[k * nrhs + r];
      x[i * nrhs + r] = s / work[i * n + i];
    }
  }
  return true;
}

double qp_objective(const double* H, const double* g, const double* x, int n) {
  double v = 0.0;
  for (int i = 0; i < n; ++i) {
    double Hx = 0.0;
    for (int j = 0; j < n; ++j) Hx += H[i * n + j] * x[j];
    v += 0.5 * x[i] * Hx + g[i] * x[i];
  }
  return v;
}

}  // namespace

extern "C" {

// Status codes mirror BoxQPStatus (boxqp.hpp:46-54).
// Returns status; writes solution into x (length n) and free mask into
// free_mask (length n, 0/1).
int cddp_boxqp_solve(const double* H, const double* g, const double* lower,
                     const double* upper, const double* x0, int n, double* x,
                     int* free_mask, int max_iterations, double min_grad,
                     double min_rel_improve, double step_dec, double min_step,
                     double armijo) {
  std::vector<double> grad(n), gradc(n), search(n), xnew(n);
  std::vector<double> Hff(n * n), rhs(n), sol(n), work(n * n);
  std::vector<int> clamped(n, 0);

  for (int i = 0; i < n; ++i)
    x[i] = std::min(std::max(x0[i], lower[i]), upper[i]);

  double value = qp_objective(H, g, x, n);
  double old_value = 1e300;
  int status = 1;  // MAX_ITER_EXCEEDED

  for (int iter = 0; iter < max_iterations; ++iter) {
    if (iter > 0 && std::abs(old_value - value) <
                        min_rel_improve * std::abs(old_value)) {
      status = 4;  // SUCCESS
      break;
    }
    old_value = value;

    for (int i = 0; i < n; ++i) {
      double Hx = 0.0;
      for (int j = 0; j < n; ++j) Hx += H[i * n + j] * x[j];
      grad[i] = g[i] + Hx;
    }

    int n_clamped = 0;
    for (int i = 0; i < n; ++i) {
      clamped[i] = ((x[i] == lower[i] && grad[i] > 0) ||
                    (x[i] == upper[i] && grad[i] < 0))
                       ? 1
                       : 0;
      n_clamped += clamped[i];
    }
    if (n_clamped == n) {
      status = 5;  // ALL_CLAMPED
      break;
    }

    // Identity-padded free-block Hessian (same masking trick as the JAX path)
    for (int i = 0; i < n; ++i)
      for (int j = 0; j < n; ++j)
        Hff[i * n + j] = (!clamped[i] && !clamped[j])
                             ? H[i * n + j]
                             : (i == j ? 1.0 : 0.0);

    double gn = 0.0;
    for (int i = 0; i < n; ++i)
      if (!clamped[i]) gn += grad[i] * grad[i];
    gn = std::sqrt(gn);
    if (gn < min_grad) {
      status = 4;
      break;
    }

    for (int i = 0; i < n; ++i) {
      double s = g[i];
      for (int j = 0; j < n; ++j)
        if (clamped[j]) s += H[i * n + j] * x[j];
      gradc[i] = clamped[i] ? 0.0 : -s;
    }
    if (!chol_solve(Hff.data(), gradc.data(), sol.data(), n, 1, work.data())) {
      status = -1;  // HESSIAN_NOT_PD
      break;
    }
    double sdotg = 0.0;
    for (int i = 0; i < n; ++i) {
      search[i] = clamped[i] ? 0.0 : (sol[i] - x[i]);
      sdotg += search[i] * grad[i];
    }
    if (sdotg >= 0) {
      status = 0;  // NO_DESCENT
      break;
    }

    double step = 1.0;
    bool accepted = false;
    while (step > min_step) {
      for (int i = 0; i < n; ++i)
        xnew[i] =
            std::min(std::max(x[i] + step * search[i], lower[i]), upper[i]);
      double vnew = qp_objective(H, g, xnew.data(), n);
      if (vnew - value <= armijo * step * sdotg) {
        accepted = true;
        value = vnew;
        std::memcpy(x, xnew.data(), sizeof(double) * n);
        break;
      }
      step *= step_dec;
    }
    if (!accepted) {
      status = 2;  // MAX_LS_EXCEEDED
      break;
    }
  }

  for (int i = 0; i < n; ++i) free_mask[i] = clamped[i] ? 0 : 1;
  return status;
}

// Batched BoxQP over B problems, fanned out over `threads` std::threads.
// Hs: (B, n, n) row-major; gs/lowers/uppers/x0s: (B, n); xs out (B, n);
// statuses out (B,).
void cddp_boxqp_solve_batch(const double* Hs, const double* gs,
                            const double* lowers, const double* uppers,
                            const double* x0s, int B, int n, double* xs,
                            int* statuses, int threads, int max_iterations,
                            double min_grad, double min_rel_improve,
                            double step_dec, double min_step, double armijo) {
  threads = std::max(1, std::min(threads, B));
  std::vector<std::thread> pool;
  pool.reserve(threads);
  const int chunk = (B + threads - 1) / threads;
  for (int t = 0; t < threads; ++t) {
    const int lo = t * chunk;
    const int hi = std::min(B, lo + chunk);
    if (lo >= hi) break;
    pool.emplace_back([=]() {
      std::vector<int> fm(n);
      for (int b = lo; b < hi; ++b) {
        statuses[b] = cddp_boxqp_solve(
            Hs + (size_t)b * n * n, gs + (size_t)b * n, lowers + (size_t)b * n,
            uppers + (size_t)b * n, x0s + (size_t)b * n, n,
            xs + (size_t)b * n, fm.data(), max_iterations, min_grad,
            min_rel_improve, step_dec, min_step, armijo);
      }
    });
  }
  for (auto& th : pool) th.join();
}

// Dense LQR backward Riccati sweep (oracle for the lax.scan recursion).
// Inputs row-major: Q (N+1, n, n), q (N+1, n), R (N, m, m), r (N, m),
// M (N, n, m), A (N, n, n), Bm (N, n, m).
// Outputs: K (N, m, n), k (N, m). Returns 0 on success, -1 if a Quu is
// not PD.
int cddp_lqr_backward(const double* Q, const double* q, const double* R,
                      const double* r, const double* M, const double* A,
                      const double* Bm, int N, int n, int m, double* K,
                      double* k) {
  std::vector<double> P(n * n), p(n), Pn(n * n);
  std::vector<double> Quu(m * m), Qux(m * n), Qu(m), rhs(m * (n + 1)),
      sol(m * (n + 1)), work(m * m), BtP(m * n);

  // terminal
  for (int i = 0; i < n * n; ++i)
    P[i] = 0.5 * (Q[(size_t)N * n * n + i] +
                  Q[(size_t)N * n * n + (i % n) * n + i / n]);
  for (int i = 0; i < n; ++i) p[i] = q[(size_t)N * n + i];

  for (int t = N - 1; t >= 0; --t) {
    const double* At = A + (size_t)t * n * n;
    const double* Bt = Bm + (size_t)t * n * m;
    const double* Rt = R + (size_t)t * m * m;
    const double* rt = r + (size_t)t * m;
    const double* Mt = M + (size_t)t * n * m;
    const double* Qt = Q + (size_t)t * n * n;
    const double* qt = q + (size_t)t * n;

    // BtP = B^T P
    for (int i = 0; i < m; ++i)
      for (int j = 0; j < n; ++j) {
        double s = 0.0;
        for (int l = 0; l < n; ++l) s += Bt[l * m + i] * P[l * n + j];
        BtP[i * n + j] = s;
      }
    // Quu = sym(R + BtP B)
    for (int i = 0; i < m; ++i)
      for (int j = 0; j < m; ++j) {
        double s = Rt[i * m + j];
        for (int l = 0; l < n; ++l) s += BtP[i * n + l] * Bt[l * m + j];
        Quu[i * m + j] = s;
      }
    for (int i = 0; i < m; ++i)
      for (int j = i + 1; j < m; ++j) {
        double v = 0.5 * (Quu[i * m + j] + Quu[j * m + i]);
        Quu[i * m + j] = Quu[j * m + i] = v;
      }
    // Qux = BtP A + M^T ; Qu = r + B^T p
    for (int i = 0; i < m; ++i) {
      for (int j = 0; j < n; ++j) {
        double s = Mt[j * m + i];
        for (int l = 0; l < n; ++l) s += BtP[i * n + l] * At[l * n + j];
        Qux[i * n + j] = s;
      }
      double s = rt[i];
      for (int l = 0; l < n; ++l) s += Bt[l * m + i] * p[l];
      Qu[i] = s;
    }
    // Solve Quu [k | K] = [Qu | Qux]
    for (int i = 0; i < m; ++i) {
      rhs[i * (n + 1)] = Qu[i];
      for (int j = 0; j < n; ++j) rhs[i * (n + 1) + 1 + j] = Qux[i * n + j];
    }
    if (!chol_solve(Quu.data(), rhs.data(), sol.data(), m, n + 1, work.data()))
      return -1;
    for (int i = 0; i < m; ++i) {
      k[(size_t)t * m + i] = -sol[i * (n + 1)];
      for (int j = 0; j < n; ++j)
        K[(size_t)t * m * n + i * n + j] = -sol[i * (n + 1) + 1 + j];
    }
    // P_t = sym(Q + A^T P A + Qux^T K + K^T Qux + K^T Quu K)
    // p_t = Qx + Qux^T k + K^T Qu + K^T Quu k ; Qx = q + A^T p
    std::vector<double> Kt(m * n), kt(m), Qx(n);
    for (int i = 0; i < m; ++i) {
      kt[i] = k[(size_t)t * m + i];
      for (int j = 0; j < n; ++j) Kt[i * n + j] = K[(size_t)t * m * n + i * n + j];
    }
    for (int i = 0; i < n; ++i) {
      double s = qt[i];
      for (int l = 0; l < n; ++l) s += At[l * n + i] * p[l];
      Qx[i] = s;
    }
    // Pn = A^T P A
    std::vector<double> PA(n * n);
    for (int i = 0; i < n; ++i)
      for (int j = 0; j < n; ++j) {
        double s = 0.0;
        for (int l = 0; l < n; ++l) s += P[i * n + l] * At[l * n + j];
        PA[i * n + j] = s;
      }
    for (int i = 0; i < n; ++i)
      for (int j = 0; j < n; ++j) {
        double s = Qt[i * n + j];
        for (int l = 0; l < n; ++l) s += At[l * n + i] * PA[l * n + j];
        // + Qux^T K + K^T Qux + K^T Quu K
        for (int l = 0; l < m; ++l) s += Qux[l * n + i] * Kt[l * n + j];
        for (int l = 0; l < m; ++l) s += Kt[l * n + i] * Qux[l * n + j];
        for (int l = 0; l < m; ++l) {
          double QuuK = 0.0;
          for (int o = 0; o < m; ++o) QuuK += Quu[l * m + o] * Kt[o * n + j];
          s += Kt[l * n + i] * QuuK;
        }
        Pn[i * n + j] = s;
      }
    for (int i = 0; i < n; ++i)
      for (int j = 0; j < n; ++j)
        P[i * n + j] = 0.5 * (Pn[i * n + j] + Pn[j * n + i]);
    for (int i = 0; i < n; ++i) {
      double s = Qx[i];
      for (int l = 0; l < m; ++l) s += Qux[l * n + i] * kt[l];
      for (int l = 0; l < m; ++l) s += Kt[l * n + i] * Qu[l];
      for (int l = 0; l < m; ++l) {
        double Quuk = 0.0;
        for (int o = 0; o < m; ++o) Quuk += Quu[l * m + o] * kt[o];
        s += Kt[l * n + i] * Quuk;
      }
      p[i] = s;
    }
  }
  return 0;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Full CLDDP solver engine (native CPU execution path).
//
// Mirrors cddp_tpu/solvers/clddp.py (itself clddp_solver.cpp:29-295)
// line-for-line in semantics: Euler linearization A = I + dt*Fx regardless of
// rollout integrator, dt-prescaled quadratic cost with gradient 2*Q*e,
// per-step BoxQP feedforward with masked free-row feedback, sequential
// first-success alpha ladder with Armijo-ratio acceptance, regularization
// x10 on failure / /10 on success in [min, max], early inf_du convergence
// with the |Vx|_1 KKT scaling.
//
// Dynamics come from a built-in registry (model_id) so the engine is fully
// native: 0 = unicycle (nx=3, nu=2), 1 = pendulum (nx=2, nu=1, the
// reference's analytic +m*g*l*sin(theta) sign, pendulum.cpp:40). Euler
// rollout. Status codes match cddp_tpu.solution.Status: 0 max-iterations,
// 1 optimal, 2 acceptable, 3 regularization-limit-not-converged.
// ---------------------------------------------------------------------------

namespace {

// Scalar-generic helpers for the complex-step Jacobian path (models/base.py's
// autodiff default, dynamical_system.cpp:102-117, realized natively: a purely
// imaginary perturbation ih gives Im(f(x+ih))/h == df/dx to machine
// precision, with no subtractive cancellation like finite differences).
using cdouble = std::complex<double>;
inline double real_part(double v) { return v; }
inline double real_part(const cdouble& v) { return v.real(); }
// max(a, b) decided on the real part so the complex-step derivative follows
// the same branch autodiff takes through jnp.maximum.
template <typename T>
inline T branch_max(const T& a, double b) {
  return real_part(a) > b ? a : T(b);
}

constexpr int kMaxNx = 16;  // >= largest registered nx (quadrotor 13)

struct Model {
  int nx, nu;
  int id;      // registry id (see model_id_valid)
  int integ;   // 0 = Euler (f is the continuous rate), 1 = RK4
  double hstep;  // solver step, for RK4 / discrete-map effective rates

  // Continuous dynamics, templated so the same expressions evaluate in
  // double (rollouts) and complex double (complex-step Jacobians).
  //
  // params: unicycle none; pendulum [l, m, b, g] (g as a parameter — same
  // fix as the Python lane functions, which once hardcoded 9.81 too);
  // car [wheelbase d, model timestep h] — the Tassa rolling-distance
  // DISCRETE map (car.cpp:30-50 / cddp_tpu/models/car.py) expressed as the
  // continuous rate (disc(x,u) - x)/h, so the engines' Euler step x + dt*f
  // reproduces the exact discrete map when dt == h;
  // cartpole [mc, mp, l, g, damping] (cartpole.cpp:28-104 damped autodiff
  // form / cddp_tpu/models/cartpole.py);
  // quadrotor [mass, Ixx, Iyy, Izz, arm, g] (quaternion wxyz, per-rotor
  // forces, quadrotor.cpp:33-97 / cddp_tpu/models/quadrotor.py);
  // scalar LTI [a, b, h] — discrete x+ = a x + b u as the effective rate
  // ((a-1)x + bu)/h (lti_system.cpp / cddp_tpu/models/lti_system.py).
  template <typename T>
  void cont(const T* x, const T* u, const double* p, T* out) const {
    switch (id) {
      case 0: {  // unicycle
        out[0] = u[0] * std::cos(x[2]);
        out[1] = u[0] * std::sin(x[2]);
        out[2] = u[1];
        break;
      }
      case 2: {  // car (Tassa discrete map as effective rate)
        const double d = p[0], h = p[1];
        const T th = x[2], v = x[3], de = u[0], a = u[1];
        const T fr = h * v;
        const T sd = std::sin(de), cd = std::cos(de);
        const T root = std::sqrt(d * d - fr * sd * fr * sd);
        const T b = d + fr * cd - root;
        out[0] = (b * std::cos(th)) / h;
        out[1] = (b * std::sin(th)) / h;
        out[2] = std::asin(sd * fr / (T)d) / h;
        out[3] = a;
        break;
      }
      case 3: {  // cartpole: x = [pos, theta, pos_dot, theta_dot], u = [F]
        const double mc = p[0], mp = p[1], l = p[2], g = p[3], damp = p[4];
        const T th = x[1], xd = x[2], w = x[3], F = u[0];
        const T s = std::sin(th), c = std::cos(th);
        const T den = mc + mp * s * s;
        out[0] = xd;
        out[1] = w;
        out[2] = (F + mp * s * (l * w * w + g * c)) / den;
        out[3] = (-F * c - mp * l * w * w * c * s - (mc + mp) * g * s -
                  damp * w) /
                 (l * den);
        break;
      }
      case 4: {  // quadrotor: x = [p(3), q(wxyz), v(3), omega(3)], u = f1..f4
        const double mass = p[0], Ixx = p[1], Iyy = p[2], Izz = p[3],
                     arm = p[4], g = p[5];
        const T* q = x + 3;
        const T* v = x + 7;
        const T* w = x + 10;
        // Normalize with the guard branch the Python model takes
        // (quadrotor.py: where(norm > 1e-6, q / max(norm, 1e-6), e_w)).
        T norm = std::sqrt(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] +
                           q[3] * q[3]);
        T qw, qx, qy, qz;
        if (real_part(norm) > 1e-6) {
          const T inv = T(1.0) / branch_max(norm, 1e-6);
          qw = q[0] * inv; qx = q[1] * inv; qy = q[2] * inv; qz = q[3] * inv;
        } else {
          qw = T(1.0); qx = T(0.0); qy = T(0.0); qz = T(0.0);
        }
        out[0] = v[0]; out[1] = v[1]; out[2] = v[2];
        // q_dot = 0.5 * q ⊗ [0, omega]
        const T wx = w[0], wy = w[1], wz = w[2];
        out[3] = -0.5 * (qx * wx + qy * wy + qz * wz);
        out[4] = 0.5 * (qw * wx + qy * wz - qz * wy);
        out[5] = 0.5 * (qw * wy - qx * wz + qz * wx);
        out[6] = 0.5 * (qw * wz + qx * wy - qy * wx);
        const T thrust = u[0] + u[1] + u[2] + u[3];
        // R @ [0,0,T]: third rotation column only
        out[7] = (thrust / mass) * (2.0 * (qx * qz + qw * qy));
        out[8] = (thrust / mass) * (2.0 * (qy * qz - qw * qx));
        out[9] = (thrust / mass) * (1.0 - 2.0 * (qx * qx + qy * qy)) - g;
        // ang_acc = I^-1 (tau - omega x (I omega)), diagonal inertia
        const T tau0 = arm * (u[0] - u[2]);
        const T tau1 = arm * (u[1] - u[3]);
        const T tau2 = 0.1 * (u[0] - u[1] + u[2] - u[3]);
        out[10] = (tau0 - (wy * (Izz * wz) - wz * (Iyy * wy))) / Ixx;
        out[11] = (tau1 - (wz * (Ixx * wx) - wx * (Izz * wz))) / Iyy;
        out[12] = (tau2 - (wx * (Iyy * wy) - wy * (Ixx * wx))) / Izz;
        break;
      }
      case 5: {  // scalar LTI x+ = a x + b u as effective rate
        const double a = p[0], b = p[1], h = p[2];
        out[0] = ((a - 1.0) * x[0] + b * u[0]) / h;
        break;
      }
      default: {  // 1: pendulum
        const double l = p[0], m = p[1], b = p[2], g = p[3];
        out[0] = x[1];
        out[1] = (u[0] - b * x[1] + m * g * l * std::sin(x[0])) / (m * l * l);
        break;
      }
    }
  }

  // Effective continuous rate: Euler models return cont(); RK4 models
  // return (rk4_step(x, u, hstep) - x) / hstep (ops/integrators.py rk4_step
  // Butcher tableau), so every solver's Euler step x + dt*f and chain
  // A = I + dt*Fx reproduce the discrete RK4 map and its exact Jacobian
  // when dt == hstep — no solver-loop changes, one integration semantic.
  template <typename T>
  void frate(const T* x, const T* u, const double* p, T* out) const {
    if (integ == 0) {
      cont(x, u, p, out);
      return;
    }
    T k1[kMaxNx], k2[kMaxNx], k3[kMaxNx], k4[kMaxNx], tmp[kMaxNx];
    const double dt = hstep;
    cont(x, u, p, k1);
    for (int i = 0; i < nx; ++i) tmp[i] = x[i] + (0.5 * dt) * k1[i];
    cont(tmp, u, p, k2);
    for (int i = 0; i < nx; ++i) tmp[i] = x[i] + (0.5 * dt) * k2[i];
    cont(tmp, u, p, k3);
    for (int i = 0; i < nx; ++i) tmp[i] = x[i] + dt * k3[i];
    cont(tmp, u, p, k4);
    for (int i = 0; i < nx; ++i)
      out[i] = (k1[i] + 2.0 * k2[i] + 2.0 * k3[i] + k4[i]) / 6.0;
  }

  void f(const double* x, const double* u, const double* p, double* out) const {
    frate(x, u, p, out);
  }

  // Jacobians of the CONTINUOUS rate — never of the RK4 effective rate.
  // The reference linearizes the continuous dynamics with an Euler step
  // regardless of which integrator rolls the trajectory
  // (cddp_solver_base.cpp:335-345: F_x = I + dt*Fx_cont, F_u = dt*Fu_cont),
  // and the JAX side replicates that (solvers/base.py discrete_jacobians).
  // Differentiating the exact RK4 map here instead makes the oracle walk a
  // DIFFERENT iterate path on RK4 models (measured: quadrotor golden forks
  // from iteration 1). The original three Euler models keep their
  // hand-derived analytic forms (bit-stable with the pinned parity tests);
  // everything else uses the complex-step derivative of cont(), exact to
  // double rounding.
  void jac(const double* x, const double* u, const double* p, double* Fx,
           double* Fu) const {
    if (id > 2) {
      jac_cstep(x, u, p, Fx, Fu);
      return;
    }
    if (nx == 3) {
      std::memset(Fx, 0, sizeof(double) * 9);
      std::memset(Fu, 0, sizeof(double) * 6);
      Fx[0 * 3 + 2] = -u[0] * std::sin(x[2]);
      Fx[1 * 3 + 2] = u[0] * std::cos(x[2]);
      Fu[0 * 2 + 0] = std::cos(x[2]);
      Fu[1 * 2 + 0] = std::sin(x[2]);
      Fu[2 * 2 + 1] = 1.0;
    } else if (nx == 4) {
      // Continuous-rate Jacobians Fx = (J_disc - I)/h, Fu = Ju_disc/h of the
      // Tassa map; the engines' A = I + dt*Fx then equals J_disc exactly.
      const double d = p[0], h = p[1];
      const double th = x[2], v = x[3], de = u[0];
      const double fr = h * v;
      const double sd = std::sin(de), cd = std::cos(de);
      const double root = std::sqrt(d * d - fr * sd * fr * sd);
      const double b = d + fr * cd - root;
      const double db_df = cd + fr * sd * sd / root;
      const double db_dde = -fr * sd + fr * fr * sd * cd / root;
      const double asin_arg = sd * fr / d;
      const double asin_den = d * std::sqrt(std::max(1.0 - asin_arg * asin_arg,
                                                     1e-300));
      const double dth_df = sd / asin_den;  // (s/d)/sqrt(1-arg^2)
      const double dth_dde = cd * fr / asin_den;
      const double cth = std::cos(th), sth = std::sin(th);
      std::memset(Fx, 0, sizeof(double) * 16);
      std::memset(Fu, 0, sizeof(double) * 8);
      // row 0: x+ = x + b*cos(th)
      Fx[0 * 4 + 2] = (-b * sth) / h;
      Fx[0 * 4 + 3] = (db_df * h * cth) / h;
      Fu[0 * 2 + 0] = (db_dde * cth) / h;
      // row 1: y+ = y + b*sin(th)
      Fx[1 * 4 + 2] = (b * cth) / h;
      Fx[1 * 4 + 3] = (db_df * h * sth) / h;
      Fu[1 * 2 + 0] = (db_dde * sth) / h;
      // row 2: th+ = th + asin(sd*fr/d)
      Fx[2 * 4 + 3] = (dth_df * h) / h;
      Fu[2 * 2 + 0] = dth_dde / h;
      // row 3: v+ = v + h*a
      Fu[3 * 2 + 1] = 1.0;
    } else {
      const double l = p[0], m = p[1], b = p[2], g = p[3];
      Fx[0 * 2 + 0] = 0.0; Fx[0 * 2 + 1] = 1.0;
      Fx[1 * 2 + 0] = g / l * std::cos(x[0]);
      Fx[1 * 2 + 1] = -b / (m * l * l);
      Fu[0] = 0.0;
      Fu[1] = 1.0 / (m * l * l);
    }
  }

  void jac_cstep(const double* x, const double* u, const double* p,
                 double* Fx, double* Fu) const {
    constexpr double h = 1e-100;  // purely imaginary step: no cancellation
    cdouble xc[kMaxNx], uc[kMaxNx], out[kMaxNx];
    for (int i = 0; i < nx; ++i) xc[i] = x[i];
    for (int i = 0; i < nu; ++i) uc[i] = u[i];
    for (int j = 0; j < nx; ++j) {
      xc[j] = cdouble(x[j], h);
      cont(xc, uc, p, out);
      for (int i = 0; i < nx; ++i) Fx[i * nx + j] = out[i].imag() / h;
      xc[j] = x[j];
    }
    for (int j = 0; j < nu; ++j) {
      uc[j] = cdouble(u[j], h);
      cont(xc, uc, p, out);
      for (int i = 0; i < nx; ++i) Fu[i * nu + j] = out[i].imag() / h;
      uc[j] = u[j];
    }
  }
};

// model_id registry: base ids 0 unicycle (3,2), 1 pendulum (2,1),
// 2 car (4,2), 3 cartpole (4,1), 4 quadrotor (13,4), 5 scalar LTI (1,1).
// The hundreds digit selects the integrator: 0 Euler (default), 1 RK4 —
// e.g. model_id 104 = quadrotor, RK4 (same encoding on the Python side,
// cddp_tpu/utils/native.py _model_setup).
inline bool model_id_valid(int id) {
  const int base = id % 100, integ = id / 100;
  return base >= 0 && base <= 5 && (integ == 0 || integ == 1);
}
inline Model make_model(int id, double dt) {
  const int base = id % 100, integ = id / 100;
  int nx = 2, nu = 1;
  if (base == 0) { nx = 3; nu = 2; }
  else if (base == 2) { nx = 4; nu = 2; }
  else if (base == 3) { nx = 4; nu = 1; }
  else if (base == 4) { nx = 13; nu = 4; }
  else if (base == 5) { nx = 1; nu = 1; }
  return Model{nx, nu, base, integ, dt};
}

}  // namespace

extern "C" {

// Direct model-registry probe: evaluates the effective rate f(x, u) (the
// integrator-encoded rate the rollouts step with) and the CONTINUOUS-rate
// Jacobians Fx (nx x nx), Fu (nx x nu) the solvers linearize with, for the
// encoded model_id (base + 100*integrator; see make_model). The solvers'
// discrete step is x + dt*f; their linearization is I + dt*Fx_cont —
// deliberately Euler even for RK4 rollouts, matching the reference
// (cddp_solver_base.cpp:335-345) and the JAX side. Exists so tests can pin
// both halves against JAX (discrete step vs discrete_dynamics; Jacobians
// vs autodiff of continuous_dynamics) without a full solve.
int cddp_model_eval(int model_id, const double* params, double dt,
                    const double* x, const double* u,
                    double* xdot, double* Fx, double* Fu) {
  if (!model_id_valid(model_id)) return -100;
  const Model mdl = make_model(model_id, dt);
  mdl.f(x, u, params, xdot);
  mdl.jac(x, u, params, Fx, Fu);
  return 0;
}

// Solves min sum_t (x-goal)'Qs(x-goal) + u'Rs u + (x_N-goal)'Qf(x_N-goal)
// with Qs = Q*dt, Rs = R*dt prescaled by the CALLER (pass the already-scaled
// matrices, matching QuadraticObjective semantics).
//
// model_id: 0 unicycle, 1 pendulum. params: see Model. lower/upper: control
// bounds (pass +-1e20 for unconstrained). X (N+1 x nx) and U (N x nu) are
// in/out (warm startable). Returns a cddp_tpu.solution.Status code and
// writes [final cost, inf_du, iterations] to out_stats.
int cddp_clddp_solve(
    int model_id, const double* params, int N, double dt,
    const double* Qs, const double* Rs, const double* Qf, const double* goal,
    const double* x0, const double* lower, const double* upper,
    int max_iterations, double tolerance, double acceptable_tolerance,
    double reg_init, double reg_min, double reg_max, double reg_factor,
    double armijo_constant, double scaling_max_factor,
    double* X, double* U, double* out_stats) {
  if (!model_id_valid(model_id)) return -100;  // unknown model
  const Model mdl = make_model(model_id, dt);
  const int nx = mdl.nx, nu = mdl.nu;

  std::vector<double> xdot(nx), Fx(nx * nx), Fu(nx * nu);
  auto rollout = [&](const double* Uc, double* Xc) {
    std::memcpy(Xc, x0, sizeof(double) * nx);
    for (int t = 0; t < N; ++t) {
      mdl.f(&Xc[t * nx], &Uc[t * nu], params, xdot.data());
      for (int i = 0; i < nx; ++i)
        Xc[(t + 1) * nx + i] = Xc[t * nx + i] + dt * xdot[i];
    }
  };
  auto cost_of = [&](const double* Xc, const double* Uc) {
    double J = 0.0;
    for (int t = 0; t < N; ++t) {
      for (int i = 0; i < nx; ++i) {
        double e_i = Xc[t * nx + i] - goal[i];
        for (int j = 0; j < nx; ++j)
          J += e_i * Qs[i * nx + j] * (Xc[t * nx + j] - goal[j]);
      }
      for (int i = 0; i < nu; ++i)
        for (int j = 0; j < nu; ++j)
          J += Uc[t * nu + i] * Rs[i * nu + j] * Uc[t * nu + j];
    }
    for (int i = 0; i < nx; ++i) {
      double e_i = Xc[N * nx + i] - goal[i];
      for (int j = 0; j < nx; ++j)
        J += e_i * Qf[i * nx + j] * (Xc[N * nx + j] - goal[j]);
    }
    return J;
  };

  rollout(U, X);  // ensure dynamic consistency of the seed
  double cost = cost_of(X, U);
  double reg = reg_init;
  double inf_du = 1e300;
  int status = 0;  // MAX_ITERATIONS_REACHED

  std::vector<double> ks(N * nu), Ks(N * nu * nx);
  std::vector<double> Vx(nx), Vxx(nx * nx), work(nx * nx + nu * nu);
  std::vector<double> Qu(nu), Qx(nx), Quu(nu * nu), Qux(nu * nx), Qxx(nx * nx);
  std::vector<double> A(nx * nx), B(nx * nu);
  std::vector<double> Xtry((N + 1) * nx), Utry(N * nu);
  std::vector<double> qp_x(nu), qp_Hfree(nu * nu);
  std::vector<int> qp_free(nu);

  // alpha ladder: a0=1, r=0.5, 11 entries (0.5^10 > 1e-8, so the
  // min-step tail of buildLineSearchAlphas never fires at these defaults)
  std::vector<double> alphas;
  {
    double a = 1.0;
    for (int i = 0; i < 11; ++i) {
      alphas.push_back(a);
      a *= 0.5;
    }
  }

  int it = 0;
  std::vector<double> ks_iter(N * nu);
  for (; it < max_iterations; ++it) {
    // ---- backward pass with regularization retry --------------------------
    double dV0 = 0.0, dV1 = 0.0, norm_Vx = 0.0, Qu_err = 0.0;
    bool bp_ok = false;
    // Snapshot the previous iteration's gains: every retry of the backward
    // pass warm-starts its BoxQPs from these, not from a failed attempt's
    // partial overwrites (matches clddp.py, where bp_body always passes
    // the carry's k).
    std::memcpy(ks_iter.data(), ks.data(), sizeof(double) * N * nu);
    while (true) {
      std::memcpy(ks.data(), ks_iter.data(), sizeof(double) * N * nu);
      // terminal value
      for (int i = 0; i < nx; ++i) {
        double s = 0.0;
        for (int j = 0; j < nx; ++j)
          s += 2.0 * Qf[i * nx + j] * (X[N * nx + j] - goal[j]);
        Vx[i] = s;
        for (int j = 0; j < nx; ++j) Vxx[i * nx + j] = 2.0 * Qf[i * nx + j];
      }
      dV0 = dV1 = Qu_err = 0.0;
      norm_Vx = 0.0;
      for (int i = 0; i < nx; ++i) norm_Vx += std::fabs(Vx[i]);
      bool ok = true;
      for (int t = N - 1; t >= 0 && ok; --t) {
        const double* xt = &X[t * nx];
        const double* ut = &U[t * nu];
        mdl.jac(xt, ut, params, Fx.data(), Fu.data());
        for (int i = 0; i < nx; ++i)
          for (int j = 0; j < nx; ++j)
            A[i * nx + j] = (i == j ? 1.0 : 0.0) + dt * Fx[i * nx + j];
        for (int i = 0; i < nx; ++i)
          for (int j = 0; j < nu; ++j) B[i * nu + j] = dt * Fu[i * nu + j];

        // Q-expansions (lx = 2 Qs e, lu = 2 Rs u, lxx = 2Qs, luu = 2Rs)
        for (int i = 0; i < nx; ++i) {
          double s = 0.0;
          for (int j = 0; j < nx; ++j)
            s += 2.0 * Qs[i * nx + j] * (xt[j] - goal[j]);
          for (int k2 = 0; k2 < nx; ++k2) s += A[k2 * nx + i] * Vx[k2];
          Qx[i] = s;
        }
        for (int i = 0; i < nu; ++i) {
          double s = 0.0;
          for (int j = 0; j < nu; ++j) s += 2.0 * Rs[i * nu + j] * ut[j];
          for (int k2 = 0; k2 < nx; ++k2) s += B[k2 * nu + i] * Vx[k2];
          Qu[i] = s;
        }
        // Qxx = 2Qs + A' Vxx A ; Qux = B' Vxx A ; Quu = 2Rs + B' Vxx B
        std::vector<double> VA(nx * nx), VB(nx * nu);
        for (int i = 0; i < nx; ++i)
          for (int j = 0; j < nx; ++j) {
            double s = 0.0;
            for (int k2 = 0; k2 < nx; ++k2) s += Vxx[i * nx + k2] * A[k2 * nx + j];
            VA[i * nx + j] = s;
          }
        for (int i = 0; i < nx; ++i)
          for (int j = 0; j < nu; ++j) {
            double s = 0.0;
            for (int k2 = 0; k2 < nx; ++k2) s += Vxx[i * nx + k2] * B[k2 * nu + j];
            VB[i * nu + j] = s;
          }
        for (int i = 0; i < nx; ++i)
          for (int j = 0; j < nx; ++j) {
            double s = 2.0 * Qs[i * nx + j];
            for (int k2 = 0; k2 < nx; ++k2) s += A[k2 * nx + i] * VA[k2 * nx + j];
            Qxx[i * nx + j] = s;
          }
        for (int i = 0; i < nu; ++i)
          for (int j = 0; j < nx; ++j) {
            double s = 0.0;
            for (int k2 = 0; k2 < nx; ++k2) s += B[k2 * nu + i] * VA[k2 * nx + j];
            Qux[i * nx + j] = s;
          }
        for (int i = 0; i < nu; ++i)
          for (int j = 0; j < nu; ++j) {
            double s = 2.0 * Rs[i * nu + j];
            for (int k2 = 0; k2 < nx; ++k2) s += B[k2 * nu + i] * VB[k2 * nu + j];
            Quu[i * nu + j] = s;
          }
        std::vector<double> Quu_reg(Quu);
        for (int i = 0; i < nu; ++i) Quu_reg[i * nu + i] += reg;

        // BoxQP feedforward with bounds shifted to the step frame
        std::vector<double> lb(nu), ub(nu);
        for (int i = 0; i < nu; ++i) {
          lb[i] = lower[i] - ut[i];
          ub[i] = upper[i] - ut[i];
        }
        std::vector<double> x0_qp(nu);
        std::memcpy(x0_qp.data(), &ks[t * nu], sizeof(double) * nu);
        int qp_status = cddp_boxqp_solve(
            Quu_reg.data(), Qu.data(), lb.data(), ub.data(), x0_qp.data(), nu,
            qp_x.data(), qp_free.data(), 100, 1e-8, 1e-8, 0.6, 1e-22, 0.1);
        // fail on HESSIAN_NOT_PD (-1) or NO_DESCENT (0), like the JAX path
        if (qp_status <= 0) { ok = false; break; }
        std::memcpy(&ks[t * nu], qp_x.data(), sizeof(double) * nu);
        // identity-padded free-block Hessian for the K solve
        for (int i = 0; i < nu; ++i)
          for (int j = 0; j < nu; ++j)
            qp_Hfree[i * nu + j] =
                (qp_free[i] && qp_free[j]) ? Quu_reg[i * nu + j]
                                           : (i == j ? 1.0 : 0.0);

        // K on free rows: K_free = -Hfree \ Qux_free (identity-padded Hfree)
        std::vector<double> Kt(nu * nx, 0.0), rhs(nu * nx, 0.0);
        for (int i = 0; i < nu; ++i)
          if (qp_free[i])
            for (int j = 0; j < nx; ++j) rhs[i * nx + j] = Qux[i * nx + j];
        if (!chol_solve(qp_Hfree.data(), rhs.data(), Kt.data(), nu, nx,
                        work.data())) { ok = false; break; }
        for (int i = 0; i < nu; ++i)
          for (int j = 0; j < nx; ++j)
            Ks[t * nu * nx + i * nx + j] = qp_free[i] ? -Kt[i * nx + j] : 0.0;

        const double* k_t = &ks[t * nu];
        const double* K_t = &Ks[t * nu * nx];
        // dV += [Qu.k, 0.5 k'Quu k]
        for (int i = 0; i < nu; ++i) dV0 += Qu[i] * k_t[i];
        for (int i = 0; i < nu; ++i)
          for (int j = 0; j < nu; ++j)
            dV1 += 0.5 * k_t[i] * Quu[i * nu + j] * k_t[j];
        // Vx = Qx + K'Quu k + Qux'k + K'Qu ; Vxx = Qxx + K'Quu K + Qux'K + K'Qux
        std::vector<double> Quu_k(nu, 0.0), QuuK(nu * nx, 0.0);
        for (int i = 0; i < nu; ++i)
          for (int j = 0; j < nu; ++j) Quu_k[i] += Quu[i * nu + j] * k_t[j];
        for (int i = 0; i < nu; ++i)
          for (int j = 0; j < nx; ++j) {
            double s = 0.0;
            for (int k2 = 0; k2 < nu; ++k2)
              s += Quu[i * nu + k2] * K_t[k2 * nx + j];
            QuuK[i * nx + j] = s;
          }
        std::vector<double> Vx_new(nx), Vxx_new(nx * nx);
        for (int i = 0; i < nx; ++i) {
          double s = Qx[i];
          for (int k2 = 0; k2 < nu; ++k2) {
            s += K_t[k2 * nx + i] * Quu_k[k2];
            s += Qux[k2 * nx + i] * k_t[k2];
            s += K_t[k2 * nx + i] * Qu[k2];
          }
          Vx_new[i] = s;
        }
        for (int i = 0; i < nx; ++i)
          for (int j = 0; j < nx; ++j) {
            double s = Qxx[i * nx + j];
            for (int k2 = 0; k2 < nu; ++k2) {
              s += K_t[k2 * nx + i] * QuuK[k2 * nx + j];
              s += Qux[k2 * nx + i] * K_t[k2 * nx + j];
              s += K_t[k2 * nx + j] * Qux[k2 * nx + i];
            }
            Vxx_new[i * nx + j] = s;
          }
        for (int i = 0; i < nx; ++i)
          for (int j = 0; j < nx; ++j)
            Vxx[i * nx + j] = 0.5 * (Vxx_new[i * nx + j] + Vxx_new[j * nx + i]);
        std::memcpy(Vx.data(), Vx_new.data(), sizeof(double) * nx);
        for (int i = 0; i < nx; ++i) norm_Vx += std::fabs(Vx[i]);
        for (int i = 0; i < nu; ++i)
          Qu_err = std::max(Qu_err, std::fabs(Qu[i]));
      }
      if (ok) { bp_ok = true; break; }
      reg = std::min(reg * reg_factor, reg_max);
      if (reg >= reg_max) break;
    }
    const double scaling =
        std::max(scaling_max_factor, norm_Vx / (double(N) * nx)) /
        scaling_max_factor;
    inf_du = Qu_err / scaling;
    if (!bp_ok) { status = 3; ++it; break; }  // REG_LIMIT_NOT_CONVERGED

    // early convergence on inf_du (clddp_solver.cpp:206-213)
    if (inf_du < tolerance) { status = 1; ++it; break; }  // OPTIMAL

    // ---- sequential first-success line search -----------------------------
    bool fp_ok = false;
    double J_new = cost;
    for (double a : alphas) {
      std::memcpy(Xtry.data(), x0, sizeof(double) * nx);
      double J = 0.0;
      for (int t = 0; t < N; ++t) {
        const double* xt = &Xtry[t * nx];
        double u_t[kMaxNx];
        for (int i = 0; i < nu; ++i) {
          double du = a * ks[t * nu + i];
          for (int j = 0; j < nx; ++j)
            du += Ks[t * nu * nx + i * nx + j] * (xt[j] - X[t * nx + j]);
          u_t[i] = U[t * nu + i] + du;
          u_t[i] = std::min(std::max(u_t[i], lower[i]), upper[i]);
        }
        for (int i = 0; i < nx; ++i) {
          double e_i = xt[i] - goal[i];
          for (int j = 0; j < nx; ++j)
            J += e_i * Qs[i * nx + j] * (xt[j] - goal[j]);
        }
        for (int i = 0; i < nu; ++i)
          for (int j = 0; j < nu; ++j) J += u_t[i] * Rs[i * nu + j] * u_t[j];
        mdl.f(xt, u_t, params, xdot.data());
        for (int i = 0; i < nx; ++i)
          Xtry[(t + 1) * nx + i] = xt[i] + dt * xdot[i];
        std::memcpy(&Utry[t * nu], u_t, sizeof(double) * nu);
      }
      for (int i = 0; i < nx; ++i) {
        double e_i = Xtry[N * nx + i] - goal[i];
        for (int j = 0; j < nx; ++j)
          J += e_i * Qf[i * nx + j] * (Xtry[N * nx + j] - goal[j]);
      }
      const double dJ = cost - J;
      const double expected = -a * (dV0 + 0.5 * a * dV1);
      const double ratio = expected > 0.0 ? dJ / expected
                                          : (dJ > 0 ? 1.0 : (dJ < 0 ? -1.0 : 0.0));
      if (ratio > armijo_constant) {
        fp_ok = true;
        J_new = J;
        std::memcpy(X, Xtry.data(), sizeof(double) * (N + 1) * nx);
        std::memcpy(U, Utry.data(), sizeof(double) * N * nu);
        break;
      }
    }

    const double dJ = cost - J_new;
    if (fp_ok) {
      cost = J_new;
      reg = std::max(reg / reg_factor, reg_min);
      if (dJ > 0.0 && dJ < acceptable_tolerance) { status = 2; ++it; break; }  // ACCEPTABLE
    } else {
      reg = std::min(reg * reg_factor, reg_max);
      if (reg >= reg_max) { status = 3; ++it; break; }
    }
  }

  out_stats[0] = cost;
  out_stats[1] = inf_du;
  out_stats[2] = double(it);
  return status;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Full IPDDP solver engine (native CPU execution path) — the independent
// cross-language oracle for the condensed path-constraint regime
// (ipddp_solver.cpp:1355-1568 / cddp_tpu/solvers/ipddp.py). iLQR mode,
// cold start, sequential first-success line search, ADAPTIVE barrier.
//
// Constraint stacking matches PathStacker's name-sorted layout for the two
// supported constraint families: an optional BallConstraint row FIRST
// ("BallConstraint" < "ControlConstraint"), then the control box's doubled
// one-sided rows [-u + lb; u - ub] <= 0. All interior-point constants
// (slack offsets, ratio clips, filter rules, mu tiers) mirror the JAX
// implementation, which itself cites the reference line-by-line — so a full
// solve from this engine agreeing with the JAX solve at 1e-6 is a genuine
// two-implementation cross-check, not a shared-code tautology.
// ---------------------------------------------------------------------------

namespace ipddp_native {

// Barrier-ratio cap: f64 value matching cddp_tpu.solvers.ipddp
// MAX_BARRIER_RATIO_F64 (the reference's 1e6 cap is an f32-grade safety
// that binds in late-barrier endgames and stalls norm-constraint duals).
constexpr double kMaxRatio = 1e12;
constexpr double kEpsSlack = 1e-10;  // EPS_SLACK
constexpr double kSlackOffset = 1e-4;

inline double s_safe(double s, double mu) {
  return std::max(s, std::max(mu * 1e-3, kEpsSlack));
}
inline double clip_pos(double num, double den) {
  return std::min(std::max(num / den, 0.0), kMaxRatio);
}
inline double clip_signed(double num, double den) {
  return std::min(std::max(num / den, -kMaxRatio), kMaxRatio);
}

// Fraction-to-boundary re-check with the knife-edge slop. Must match
// cddp_tpu.solvers.base.ftb_ok exactly: at an alpha_pr_max-capped rung the
// binding slack row lands on the bound EXACTLY (realized first-step update
// == the linear prediction that defined the cap for control-affine
// dynamics), so the strict comparison is rounding noise and two valid
// engines can fork whole solves over a 1-ulp margin.
inline bool ftb_ok(double v_new, double v_old, double tau) {
  constexpr double kEps = 2.220446049250313e-16;  // DBL_EPSILON
  const double slop =
      16.0 * kEps * (1.0 + std::abs(v_old) + std::abs(v_new));
  return v_new > 0.0 && v_new >= (1.0 - tau) * v_old - slop;
}

// IPOPT-style filter (solvers/filter.py; interior_point_utils.cpp:79-139).
struct Filter {
  std::vector<double> mf, cv;
  int size() const { return (int)mf.size(); }
  void clear() { mf.clear(); cv.clear(); }
  bool accept(double m, double c) {
    for (int i = 0; i < size(); ++i)
      if (mf[i] <= m && cv[i] <= c) return false;  // candidate dominated
    std::vector<double> m2, c2;
    for (int i = 0; i < size(); ++i)
      if (!(m <= mf[i] && c <= cv[i])) {  // drop points candidate dominates
        m2.push_back(mf[i]);
        c2.push_back(cv[i]);
      }
    m2.push_back(m);
    c2.push_back(c);
    mf.swap(m2);
    cv.swap(c2);
    return true;
  }
  void prune_to_best() {  // keep min-violation, plus min-merit if distinct
    if (mf.empty()) return;
    int ibv = 0, ibm = 0;
    for (int i = 1; i < size(); ++i) {
      if (cv[i] < cv[ibv]) ibv = i;
      if (mf[i] < mf[ibm]) ibm = i;
    }
    const bool distinct = std::fabs(mf[ibm] - mf[ibv]) > 1e-12 ||
                          std::fabs(cv[ibm] - cv[ibv]) > 1e-12;
    std::vector<double> m2{mf[ibv]}, c2{cv[ibv]};
    if (distinct) {
      m2.push_back(mf[ibm]);
      c2.push_back(cv[ibm]);
    }
    mf.swap(m2);
    cv.swap(c2);
  }
  bool back(double* m, double* c) const {
    if (mf.empty()) return false;
    *m = mf.back();
    *c = cv.back();
    return true;
  }
};

}  // namespace ipddp_native

extern "C" {

// Options layout (all doubles):
//  [0] max_iterations [1] tolerance [2] acceptable_tolerance
//  [3] reg_init [4] reg_min [5] reg_max [6] reg_factor
//  [7] ls_max_iterations [8] ls_initial [9] ls_min [10] ls_reduction
//  [11] mu_initial [12] mu_min [13] mu_update_factor [14] mu_update_power
//  [15] min_fraction_to_boundary
//  [16] filter.merit_acceptance [17] filter.violation_acceptance
//  [18] filter.max_violation [19] filter.min_violation_for_armijo
//  [20] filter.armijo_constant
//  [21] dual_var_init_scale [22] slack_var_init_scale
//  [23] barrier_tol_mult [24] theta_0_floor [25] max_filter_size
//  [26] barrier_strategy (0 = ADAPTIVE tiered factors, 1 = MONOTONIC/IPOPT
//       kappa rule: mu decreases when max(inf_pr, w*inf_du, inf_comp)
//       <= kappa_eps * mu — ipddp_solver.cpp:2548-2660 non-adaptive arm)
//  [27] mu_kappa_epsilon [28] barrier_update_dual_weight
//
// Ball constraint: has_ball != 0 enables -||x[:2]-c||^2 <= -r^2 (the
// reference BallConstraint with scale 1) stacked BEFORE the box rows.
// Writes [cost, inf_pr, inf_du, inf_comp, mu, iterations] to out_stats and
// returns a cddp_tpu.solution.Status code.
int cddp_ipddp_solve(
    int model_id, const double* params, int N, double dt,
    const double* Qs, const double* Rs, const double* Qf, const double* goal,
    const double* x0, const double* lower, const double* upper,
    int has_ball, const double* ball_center, double ball_radius,
    const double* opts, const double* U0,
    double* X, double* U, double* out_stats) {
  using namespace ipddp_native;
  if (!model_id_valid(model_id)) return -100;  // unknown model
  const Model mdl = make_model(model_id, dt);
  const int nx = mdl.nx, nu = mdl.nu;
  const int mb = has_ball ? 1 : 0;
  const int m = mb + 2 * nu;

  const int max_iterations = (int)opts[0];
  const double tolerance = opts[1], acceptable_tolerance = opts[2];
  const double reg_init = opts[3], reg_min = opts[4], reg_max = opts[5],
               reg_factor = opts[6];
  const int ls_max = (int)opts[7];
  const double ls_initial = opts[8], ls_min = opts[9], ls_red = opts[10];
  const double mu_initial = opts[11], mu_min = opts[12],
               mu_update_factor = opts[13], mu_update_power = opts[14],
               min_ftb = opts[15];
  const double f_merit_acc = opts[16], f_viol_acc = opts[17],
               f_max_viol = opts[18], f_min_viol_armijo = opts[19],
               f_armijo = opts[20];
  const double y0_scale = opts[21], s0_scale = opts[22];
  const double barrier_tol_mult = opts[23], theta_0_floor = opts[24];
  const int max_filter_size = (int)opts[25];
  const int barrier_strategy = (int)opts[26];
  const double mu_kappa_epsilon = opts[27];
  const double barrier_dual_weight = opts[28];

  // alpha ladder (line_search_alphas, cddp_context_utils.cpp:37-57)
  std::vector<double> alphas;
  {
    double a = ls_initial;
    for (int i = 0; i < std::max(1, ls_max); ++i) {
      alphas.push_back(a);
      a *= ls_red;
      if (a < ls_min && i < ls_max - 1) {
        alphas.push_back(ls_min);
        break;
      }
    }
  }

  // --- constraint stack: g(x,u) - ub, rows [ball; -u+lb; u-ub] ------------
  auto eval_g = [&](const double* x, const double* u, double* g) {
    int r = 0;
    if (has_ball) {
      double d2 = 0.0;
      for (int i = 0; i < 2; ++i) {
        const double di = x[i] - ball_center[i];
        d2 += di * di;
      }
      g[r++] = -d2 + ball_radius * ball_radius;
    }
    for (int i = 0; i < nu; ++i) g[r++] = -u[i] + lower[i];
    for (int i = 0; i < nu; ++i) g[r++] = u[i] - upper[i];
  };
  // Gx (m x nx), Gu (m x nu)
  auto eval_jac = [&](const double* x, double* Gx, double* Gu) {
    std::memset(Gx, 0, sizeof(double) * m * nx);
    std::memset(Gu, 0, sizeof(double) * m * nu);
    int r = 0;
    if (has_ball) {
      for (int i = 0; i < 2; ++i) Gx[r * nx + i] = -2.0 * (x[i] - ball_center[i]);
      r += 1;
    }
    for (int i = 0; i < nu; ++i) Gu[(r + i) * nu + i] = -1.0;
    for (int i = 0; i < nu; ++i) Gu[(r + nu + i) * nu + i] = 1.0;
  };

  std::vector<double> xdot(nx), Fx(nx * nx), Fu(nx * nu);
  auto rollout = [&](const double* Uc, double* Xc) {
    std::memcpy(Xc, x0, sizeof(double) * nx);
    for (int t = 0; t < N; ++t) {
      mdl.f(&Xc[t * nx], &Uc[t * nu], params, xdot.data());
      for (int i = 0; i < nx; ++i)
        Xc[(t + 1) * nx + i] = Xc[t * nx + i] + dt * xdot[i];
    }
  };
  auto run_cost = [&](const double* x, const double* u) {
    double J = 0.0;
    for (int i = 0; i < nx; ++i) {
      double e_i = x[i] - goal[i];
      for (int j = 0; j < nx; ++j) J += e_i * Qs[i * nx + j] * (x[j] - goal[j]);
    }
    for (int i = 0; i < nu; ++i)
      for (int j = 0; j < nu; ++j) J += u[i] * Rs[i * nu + j] * u[j];
    return J;
  };
  auto term_cost = [&](const double* x) {
    double J = 0.0;
    for (int i = 0; i < nx; ++i) {
      double e_i = x[i] - goal[i];
      for (int j = 0; j < nx; ++j) J += e_i * Qf[i * nx + j] * (x[j] - goal[j]);
    }
    return J;
  };

  // --- cold-start init (ipddp_solver.cpp:820-914) -------------------------
  std::memcpy(U, U0, sizeof(double) * N * nu);
  rollout(U, X);
  double mu = mu_initial;
  std::vector<double> G(N * m), S(N * m), Y(N * m);
  for (int t = 0; t < N; ++t) eval_g(&X[t * nx], &U[t * nu], &G[t * m]);
  for (int i = 0; i < N * m; ++i) {
    S[i] = std::max(s0_scale, -G[i] + kSlackOffset);
    Y[i] = mu * y0_scale / std::max(S[i], kEpsSlack);
  }
  std::vector<double> Lambda((N + 1) * nx, 0.0);

  auto barrier_merit = [&](double J, const std::vector<double>& Sv,
                           double mu_) {
    double v = J;
    for (int i = 0; i < N * m; ++i)
      v -= mu_ * std::log(std::max(Sv[i], kEpsSlack));
    return v;
  };
  auto theta_of = [&](const std::vector<double>& Gv,
                      const std::vector<double>& Sv) {
    double total = 0.0, max_entry = 0.0;
    for (int i = 0; i < N * m; ++i) {
      const double r = Gv[i] + Sv[i];
      total += std::fabs(r);
      max_entry = std::max(max_entry, std::fabs(r));
    }
    return std::max(total, max_entry);
  };
  auto primal_comp = [&](const std::vector<double>& Gv,
                         const std::vector<double>& Sv,
                         const std::vector<double>& Yv, double mu_,
                         double* pr, double* comp) {
    *pr = 0.0;
    *comp = 0.0;
    for (int i = 0; i < N * m; ++i) {
      *pr = std::max(*pr, std::fabs(Gv[i] + Sv[i]));
      *comp = std::max(*comp, std::fabs(Yv[i] * Sv[i] - mu_));
    }
  };

  double cost = 0.0;
  for (int t = 0; t < N; ++t) cost += run_cost(&X[t * nx], &U[t * nu]);
  cost += term_cost(&X[N * nx]);

  double inf_pr, inf_comp;
  primal_comp(G, S, Y, mu, &inf_pr, &inf_comp);
  double merit = barrier_merit(cost, S, mu);
  double filter_theta = std::max(theta_of(G, S), 1e-8);
  double theta = std::max(filter_theta, std::max(theta_0_floor, 1e-8));
  Filter filt;  // path-only problems start with an EMPTY filter
  double phi = merit;

  double reg = reg_init;
  double inf_du = 0.0, step_norm = 0.0, alpha_pr_acc = 1.0;
  int status = 0;  // MAX_ITERATIONS_REACHED
  int it = 0;

  // backward-pass buffers
  std::vector<double> k_u(N * nu), K_u(N * nu * nx), k_y(N * m),
      K_y(N * m * nx), k_s(N * m), K_s(N * m * nx), k_lam((N + 1) * nx),
      K_lam((N + 1) * nx * nx);
  std::vector<double> dS(N * m), dY(N * m), dX((N + 1) * nx);
  std::vector<double> Gx(m * nx), Gu(m * nu), A(nx * nx), B(nx * nu);
  std::vector<double> Vx(nx), Vxx(nx * nx), work(std::max(nx, nu) *
                                                 std::max(nx, nu));
  std::vector<double> Xtry((N + 1) * nx), Utry(N * nu), Stry(N * m),
      Ytry(N * m), Gtry(N * m), Lamtry((N + 1) * nx);

  for (it = 0; it < max_iterations;) {
    ++it;
    // ---- backward pass with regularization retry -------------------------
    double dV0 = 0.0, dV1 = 0.0;
    double bp_inf_du = 0.0, bp_inf_pr = 0.0, bp_inf_comp = 0.0,
           bp_step_norm = 0.0;
    bool bp_ok = false, bp_limit = false;
    while (true) {
      bool ok = true;
      dV0 = dV1 = 0.0;
      bp_inf_du = bp_inf_pr = bp_inf_comp = bp_step_norm = 0.0;
      // terminal fold (no terminal constraints): Vx = 2 Qf e, Vxx = 2 Qf
      for (int i = 0; i < nx; ++i) {
        double s = 0.0;
        for (int j = 0; j < nx; ++j)
          s += 2.0 * Qf[i * nx + j] * (X[N * nx + j] - goal[j]);
        Vx[i] = s;
        for (int j = 0; j < nx; ++j) Vxx[i * nx + j] = 2.0 * Qf[i * nx + j];
      }
      std::memcpy(&k_lam[N * nx], Vx.data(), sizeof(double) * nx);
      std::memcpy(&K_lam[N * nx * nx], Vxx.data(), sizeof(double) * nx * nx);

      for (int t = N - 1; t >= 0 && ok; --t) {
        const double* xt = &X[t * nx];
        const double* ut = &U[t * nu];
        const double* gt = &G[t * m];
        const double* st = &S[t * m];
        const double* yt = &Y[t * m];
        mdl.jac(xt, ut, params, Fx.data(), Fu.data());
        for (int i = 0; i < nx; ++i)
          for (int j = 0; j < nx; ++j)
            A[i * nx + j] = (i == j ? 1.0 : 0.0) + dt * Fx[i * nx + j];
        for (int i = 0; i < nx; ++i)
          for (int j = 0; j < nu; ++j) B[i * nu + j] = dt * Fu[i * nu + j];
        eval_jac(xt, Gx.data(), Gu.data());

        // Q-expansions with the constraint duals folded in
        // (_condensed_step_math / ipddp_solver.cpp:1380-1409)
        std::vector<double> Qx(nx), Qu(nu), Qxx(nx * nx), Qux(nu * nx),
            Quu(nu * nu);
        for (int i = 0; i < nx; ++i) {
          double s = 0.0;
          for (int j = 0; j < nx; ++j)
            s += 2.0 * Qs[i * nx + j] * (xt[j] - goal[j]);
          for (int r = 0; r < m; ++r) s += Gx[r * nx + i] * yt[r];
          for (int k2 = 0; k2 < nx; ++k2) s += A[k2 * nx + i] * Vx[k2];
          Qx[i] = s;
        }
        for (int i = 0; i < nu; ++i) {
          double s = 0.0;
          for (int j = 0; j < nu; ++j) s += 2.0 * Rs[i * nu + j] * ut[j];
          for (int r = 0; r < m; ++r) s += Gu[r * nu + i] * yt[r];
          for (int k2 = 0; k2 < nx; ++k2) s += B[k2 * nu + i] * Vx[k2];
          Qu[i] = s;
        }
        std::vector<double> VA(nx * nx), VB(nx * nu);
        for (int i = 0; i < nx; ++i)
          for (int j = 0; j < nx; ++j) {
            double s = 0.0;
            for (int k2 = 0; k2 < nx; ++k2)
              s += Vxx[i * nx + k2] * A[k2 * nx + j];
            VA[i * nx + j] = s;
          }
        for (int i = 0; i < nx; ++i)
          for (int j = 0; j < nu; ++j) {
            double s = 0.0;
            for (int k2 = 0; k2 < nx; ++k2)
              s += Vxx[i * nx + k2] * B[k2 * nu + j];
            VB[i * nu + j] = s;
          }
        for (int i = 0; i < nx; ++i)
          for (int j = 0; j < nx; ++j) {
            double s = 2.0 * Qs[i * nx + j];
            for (int k2 = 0; k2 < nx; ++k2) s += A[k2 * nx + i] * VA[k2 * nx + j];
            Qxx[i * nx + j] = s;
          }
        for (int i = 0; i < nu; ++i)
          for (int j = 0; j < nx; ++j) {
            double s = 0.0;
            for (int k2 = 0; k2 < nx; ++k2) s += B[k2 * nu + i] * VA[k2 * nx + j];
            Qux[i * nx + j] = s;
          }
        for (int i = 0; i < nu; ++i)
          for (int j = 0; j < nu; ++j) {
            double s = 2.0 * Rs[i * nu + j];
            for (int k2 = 0; k2 < nx; ++k2) s += B[k2 * nu + i] * VB[k2 * nu + j];
            Quu[i * nu + j] = s;
          }

        // condensation (_condense_path)
        std::vector<double> sigma(m), pr_res(m), comp_res(m), rhat(m),
            s_inv_rhat(m);
        for (int r = 0; r < m; ++r) {
          const double ss = s_safe(st[r], mu);
          sigma[r] = clip_pos(yt[r], ss);
          pr_res[r] = gt[r] + st[r];
          comp_res[r] = yt[r] * st[r] - mu;
          rhat[r] = yt[r] * pr_res[r] - comp_res[r];
          s_inv_rhat[r] = clip_signed(rhat[r], ss);
          bp_inf_pr = std::max(bp_inf_pr, std::fabs(pr_res[r]));
          bp_inf_comp = std::max(bp_inf_comp, std::fabs(comp_res[r]));
        }

        // Quu_reg = sym(Quu) + Gu' Sigma Gu + reg I ; rhs
        std::vector<double> Quu_reg(nu * nu), rhs_kK(nu * (1 + nx)),
            kK(nu * (1 + nx));
        for (int i = 0; i < nu; ++i)
          for (int j = 0; j < nu; ++j) {
            double s = 0.5 * (Quu[i * nu + j] + Quu[j * nu + i]);
            for (int r = 0; r < m; ++r)
              s += Gu[r * nu + i] * sigma[r] * Gu[r * nu + j];
            Quu_reg[i * nu + j] = s + (i == j ? reg : 0.0);
          }
        std::vector<double> Qu_c(nu);
        for (int i = 0; i < nu; ++i) {
          double s = Qu[i];
          for (int r = 0; r < m; ++r) s += Gu[r * nu + i] * s_inv_rhat[r];
          Qu_c[i] = s;
          rhs_kK[i * (1 + nx) + 0] = s;
        }
        std::vector<double> Qux_c(nu * nx);
        for (int i = 0; i < nu; ++i)
          for (int j = 0; j < nx; ++j) {
            double s = Qux[i * nx + j];
            for (int r = 0; r < m; ++r)
              s += Gu[r * nu + i] * sigma[r] * Gx[r * nx + j];
            Qux_c[i * nx + j] = s;
            rhs_kK[i * (1 + nx) + 1 + j] = s;
          }
        if (!chol_solve(Quu_reg.data(), rhs_kK.data(), kK.data(), nu, 1 + nx,
                        work.data())) {
          ok = false;
          break;
        }
        double* kt = &k_u[t * nu];
        double* Kt = &K_u[t * nu * nx];
        for (int i = 0; i < nu; ++i) {
          kt[i] = -kK[i * (1 + nx) + 0];
          for (int j = 0; j < nx; ++j) Kt[i * nx + j] = -kK[i * (1 + nx) + 1 + j];
        }

        // dual/slack gains (_path_gains)
        std::vector<double> Gu_k(m), GuK(m * nx);
        for (int r = 0; r < m; ++r) {
          double s = 0.0;
          for (int i = 0; i < nu; ++i) s += Gu[r * nu + i] * kt[i];
          Gu_k[r] = s;
          for (int j = 0; j < nx; ++j) {
            double s2 = Gx[r * nx + j];
            for (int i = 0; i < nu; ++i) s2 += Gu[r * nu + i] * Kt[i * nx + j];
            GuK[r * nx + j] = s2;  // Gx + Gu K
          }
        }
        for (int r = 0; r < m; ++r) {
          const double ss = s_safe(st[r], mu);
          k_y[t * m + r] = clip_signed(rhat[r] + yt[r] * Gu_k[r], ss);
          for (int j = 0; j < nx; ++j)
            K_y[(t * m + r) * nx + j] = std::min(
                std::max(sigma[r] * GuK[r * nx + j], -kMaxRatio), kMaxRatio);
          k_s[t * m + r] = -pr_res[r] - Gu_k[r];
          for (int j = 0; j < nx; ++j)
            K_s[(t * m + r) * nx + j] = -GuK[r * nx + j];
        }

        // condensed expansions folded back; dV, value update
        std::vector<double> Qx_c(nx), Qxx_c(nx * nx), Quu_c(nu * nu);
        for (int i = 0; i < nx; ++i) {
          double s = Qx[i];
          for (int r = 0; r < m; ++r) s += Gx[r * nx + i] * s_inv_rhat[r];
          Qx_c[i] = s;
        }
        for (int i = 0; i < nx; ++i)
          for (int j = 0; j < nx; ++j) {
            double s = Qxx[i * nx + j];
            for (int r = 0; r < m; ++r)
              s += Gx[r * nx + i] * sigma[r] * Gx[r * nx + j];
            Qxx_c[i * nx + j] = s;
          }
        for (int i = 0; i < nu; ++i)
          for (int j = 0; j < nu; ++j) {
            double s = Quu[i * nu + j];
            for (int r = 0; r < m; ++r)
              s += Gu[r * nu + i] * sigma[r] * Gu[r * nu + j];
            Quu_c[i * nu + j] = s;
          }
        for (int i = 0; i < nu; ++i) dV0 += kt[i] * Qu_c[i];
        for (int i = 0; i < nu; ++i)
          for (int j = 0; j < nu; ++j)
            dV1 += 0.5 * kt[i] * Quu_c[i * nu + j] * kt[j];

        std::vector<double> Quu_k(nu, 0.0), QuuK(nu * nx, 0.0);
        for (int i = 0; i < nu; ++i)
          for (int j = 0; j < nu; ++j) Quu_k[i] += Quu_c[i * nu + j] * kt[j];
        for (int i = 0; i < nu; ++i)
          for (int j = 0; j < nx; ++j) {
            double s = 0.0;
            for (int k2 = 0; k2 < nu; ++k2)
              s += Quu_c[i * nu + k2] * Kt[k2 * nx + j];
            QuuK[i * nx + j] = s;
          }
        std::vector<double> Vx_new(nx), Vxx_new(nx * nx);
        for (int i = 0; i < nx; ++i) {
          double s = Qx_c[i];
          for (int k2 = 0; k2 < nu; ++k2) {
            s += Kt[k2 * nx + i] * Qu_c[k2];
            s += Qux_c[k2 * nx + i] * kt[k2];
            s += Kt[k2 * nx + i] * Quu_k[k2];
          }
          Vx_new[i] = s;
        }
        for (int i = 0; i < nx; ++i)
          for (int j = 0; j < nx; ++j) {
            double s = Qxx_c[i * nx + j];
            for (int k2 = 0; k2 < nu; ++k2) {
              s += Kt[k2 * nx + i] * QuuK[k2 * nx + j];
              s += Qux_c[k2 * nx + i] * Kt[k2 * nx + j];
              s += Qux_c[k2 * nx + j] * Kt[k2 * nx + i];
            }
            Vxx_new[i * nx + j] = s;
          }
        for (int i = 0; i < nx; ++i)
          for (int j = 0; j < nx; ++j)
            Vxx[i * nx + j] = 0.5 * (Vxx_new[i * nx + j] + Vxx_new[j * nx + i]);
        std::memcpy(Vx.data(), Vx_new.data(), sizeof(double) * nx);
        std::memcpy(&k_lam[t * nx], Vx.data(), sizeof(double) * nx);
        std::memcpy(&K_lam[t * nx * nx], Vxx.data(), sizeof(double) * nx * nx);

        for (int i = 0; i < nu; ++i) {
          bp_inf_du = std::max(bp_inf_du, std::fabs(Qu_c[i]));
          bp_step_norm = std::max(bp_step_norm, std::fabs(kt[i]));
        }
      }
      if (ok) {
        bp_ok = true;
        break;
      }
      const double reg_next = std::min(reg * reg_factor, reg_max);
      if (reg_next >= reg_max && !bp_ok) {
        reg = reg_next;
        bp_limit = true;
        break;
      }
      reg = reg_next;
    }
    inf_pr = bp_inf_pr;
    inf_du = bp_inf_du;
    inf_comp = bp_inf_comp;
    step_norm = bp_step_norm;
    if (bp_limit) {
      status = 3;  // REGULARIZATION_LIMIT_NOT_CONVERGED
      break;
    }

    // ---- early convergence (checkEarlyConvergence, :925-958) -------------
    {
      const double tol = std::max(tolerance, barrier_tol_mult * mu);
      const double accepted_step = std::fabs(alpha_pr_acc) * step_norm;
      if (inf_pr < tol && inf_du < tol && inf_comp < tol &&
          accepted_step < tolerance * 10.0) {
        status = 1;  // OPTIMAL
        break;
      }
    }

    // ---- Newton rollout for dS/dY + fraction-to-boundary steps -----------
    std::memset(dX.data(), 0, sizeof(double) * nx);
    for (int t = 0; t < N; ++t) {
      const double* dxt = &dX[t * nx];
      double du[kMaxNx];
      for (int i = 0; i < nu; ++i) {
        double s = k_u[t * nu + i];
        for (int j = 0; j < nx; ++j) s += K_u[(t * nu + i) * nx + j] * dxt[j];
        du[i] = s;
      }
      // A, B at step t for the linear rollout
      mdl.jac(&X[t * nx], &U[t * nu], params, Fx.data(), Fu.data());
      for (int i = 0; i < nx; ++i) {
        double s = 0.0;
        for (int j = 0; j < nx; ++j)
          s += ((i == j ? 1.0 : 0.0) + dt * Fx[i * nx + j]) * dxt[j];
        for (int j = 0; j < nu; ++j) s += dt * Fu[i * nu + j] * du[j];
        dX[(t + 1) * nx + i] = s;
      }
      for (int r = 0; r < m; ++r) {
        double s1 = k_s[t * m + r], s2 = k_y[t * m + r];
        for (int j = 0; j < nx; ++j) {
          s1 += K_s[(t * m + r) * nx + j] * dxt[j];
          s2 += K_y[(t * m + r) * nx + j] * dxt[j];
        }
        dS[t * m + r] = s1;
        dY[t * m + r] = std::min(std::max(s2, -kMaxRatio), kMaxRatio);
      }
    }
    const double tau = std::max(min_ftb, 1.0 - mu);
    double a_pr_max = 1.0, a_du_max = 1.0;
    for (int i = 0; i < N * m; ++i) {
      if (dS[i] < 0.0) a_pr_max = std::min(a_pr_max, -tau * S[i] / dS[i]);
      if (dY[i] < 0.0) a_du_max = std::min(a_du_max, -tau * Y[i] / dY[i]);
    }
    a_pr_max = std::min(std::max(a_pr_max, 0.0), 1.0);
    a_du_max = std::min(std::max(a_du_max, 0.0), 1.0);

    // ---- sequential first-success filter line search ----------------------
    bool fp_ok = false;
    double J_new = cost, phi_new = 0.0, theta_new = 0.0, fp_inf_pr = 0.0,
           fp_inf_comp = 0.0, alpha_pr = 0.0, alpha_du = 0.0;
    for (double a : alphas) {
      alpha_pr = std::min(a, a_pr_max);
      alpha_du = std::min(a, a_du_max);
      bool feasible = true;
      double J = 0.0;
      std::memcpy(Xtry.data(), x0, sizeof(double) * nx);
      for (int t = 0; t < N && feasible; ++t) {
        const double* xt = &Xtry[t * nx];
        double dx[kMaxNx];
        for (int i = 0; i < nx; ++i) dx[i] = xt[i] - X[t * nx + i];
        // lambda update (carried for fidelity)
        for (int i = 0; i < nx; ++i) {
          double s = Lambda[t * nx + i] + alpha_pr * k_lam[t * nx + i];
          for (int j = 0; j < nx; ++j)
            s += K_lam[(t * nx + i) * nx + j] * dx[j];
          Lamtry[t * nx + i] = s;
        }
        for (int r = 0; r < m; ++r) {
          double sn = S[t * m + r] + alpha_pr * k_s[t * m + r];
          double yn = Y[t * m + r] + alpha_du * k_y[t * m + r];
          for (int j = 0; j < nx; ++j) {
            sn += K_s[(t * m + r) * nx + j] * dx[j];
            yn += K_y[(t * m + r) * nx + j] * dx[j];
          }
          if (!ftb_ok(sn, S[t * m + r], tau) ||
              !ftb_ok(yn, Y[t * m + r], tau) || !std::isfinite(sn) ||
              !std::isfinite(yn)) {
            feasible = false;
            break;
          }
          Stry[t * m + r] = sn;
          Ytry[t * m + r] = yn;
        }
        if (!feasible) break;
        double u_t[kMaxNx];
        for (int i = 0; i < nu; ++i) {
          double s = U[t * nu + i] + alpha_pr * k_u[t * nu + i];
          for (int j = 0; j < nx; ++j)
            s += K_u[(t * nu + i) * nx + j] * dx[j];
          u_t[i] = s;
        }
        J += run_cost(xt, u_t);
        eval_g(xt, u_t, &Gtry[t * m]);
        mdl.f(xt, u_t, params, xdot.data());
        for (int i = 0; i < nx; ++i) {
          const double xn = xt[i] + dt * xdot[i];
          if (!std::isfinite(xn)) feasible = false;
          Xtry[(t + 1) * nx + i] = xn;
        }
        std::memcpy(&Utry[t * nu], u_t, sizeof(double) * nu);
      }
      if (!feasible) continue;
      J += term_cost(&Xtry[N * nx]);
      // terminal lambda
      {
        double dxN[kMaxNx];
        for (int i = 0; i < nx; ++i) dxN[i] = Xtry[N * nx + i] - X[N * nx + i];
        for (int i = 0; i < nx; ++i) {
          double s = Lambda[N * nx + i] + alpha_pr * k_lam[N * nx + i];
          for (int j = 0; j < nx; ++j)
            s += K_lam[(N * nx + i) * nx + j] * dxN[j];
          Lamtry[N * nx + i] = s;
        }
      }
      phi_new = barrier_merit(J, Stry, mu);
      theta_new = theta_of(Gtry, Stry);
      primal_comp(Gtry, Stry, Ytry, mu, &fp_inf_pr, &fp_inf_comp);
      if (!std::isfinite(phi_new) || !std::isfinite(theta_new)) continue;

      // filter acceptance (ipddp_solver.cpp:1784-1839)
      const double expected_improvement = alpha_pr * dV0;
      double f_mf, f_cv;
      const bool nonempty = filt.back(&f_mf, &f_cv);
      const double cv_old = nonempty ? f_cv : 0.0;
      const double high_violation_ref = nonempty ? f_cv : filter_theta;
      bool accept;
      if (theta_new > f_max_viol) {
        accept = theta_new < (1.0 - f_viol_acc) * high_violation_ref;
      } else if (std::max(theta_new, cv_old) < f_min_viol_armijo &&
                 expected_improvement < 0.0) {
        accept = phi_new < merit + f_armijo * expected_improvement;
      } else {
        accept = (phi_new < merit - f_merit_acc * theta_new) ||
                 (theta_new < (1.0 - f_viol_acc) * cv_old);
      }
      if (accept) {
        fp_ok = true;
        J_new = J;
        break;
      }
    }

    if (fp_ok) {
      const double dJ = cost - J_new;
      std::memcpy(X, Xtry.data(), sizeof(double) * (N + 1) * nx);
      std::memcpy(U, Utry.data(), sizeof(double) * N * nu);
      S.swap(Stry);
      Y.swap(Ytry);
      G.swap(Gtry);
      Lambda.swap(Lamtry);
      Stry.resize(N * m);
      Ytry.resize(N * m);
      Gtry.resize(N * m);
      Lamtry.resize((N + 1) * nx);
      cost = J_new;
      merit = phi_new;
      inf_pr = fp_inf_pr;
      inf_comp = fp_inf_comp;
      phi = phi_new;
      filter_theta = theta_new;
      theta = theta_new;
      alpha_pr_acc = alpha_pr;
      (void)alpha_du;
      reg = std::max(reg / reg_factor, reg_min);

      // ---- barrier + filter update (updateBarrierParameters, :2548-2660) --
      const double mu_old = mu;
      if (barrier_strategy == 0) {  // ADAPTIVE tiered factors
        const double kkt = std::max(std::max(inf_pr, inf_du), inf_comp);
        const double threshold = std::max(mu_update_factor * mu_old, 2.0 * mu_old);
        const double ratio = kkt / std::max(mu_old, 1e-20);
        double factor;
        if (mu_old > 1e-20) {
          factor = ratio < 0.01 ? 0.1 * mu_update_factor
                   : ratio < 0.1 ? 0.3 * mu_update_factor
                   : ratio < 0.5 ? 0.6 * mu_update_factor
                                 : mu_update_factor;
        } else {
          factor = mu_update_factor;
        }
        const double linear = factor * mu_old;
        const double superlinear = std::pow(mu_old, mu_update_power);
        const double mu_cand = std::max(std::min(linear, superlinear),
                                        std::max(mu_min, tolerance / 100.0));
        mu = (kkt <= threshold) ? mu_cand : mu_old;
      } else {  // MONOTONIC/IPOPT kappa rule (matches solvers/ipddp.py)
        const double kkt = std::max(
            std::max(inf_pr, inf_du * barrier_dual_weight), inf_comp);
        const double linear = mu_update_factor * mu_old;
        const double superlinear = std::pow(mu_old, mu_update_power);
        const double mu_cand =
            std::max(mu_min, std::min(linear, superlinear));
        mu = (kkt <= mu_kappa_epsilon * mu_old) ? mu_cand : mu_old;
      }
      filter_theta = std::max(theta_of(G, S), 1e-8);
      const bool reset = (mu < mu_old) && (mu > 0.0);
      if (reset) {
        filt.clear();  // no terminal constraints: cleared stays empty
      } else {
        filt.accept(phi, filter_theta);
        if (filt.size() > max_filter_size) filt.prune_to_best();
      }
      primal_comp(G, S, Y, mu, &inf_pr, &inf_comp);
      merit = barrier_merit(cost, S, mu);
      phi = merit;
      theta = std::max(filter_theta, std::max(theta_0_floor, 1e-8));

      // ---- convergence (checkConvergence, :1953-2025) ----------------------
      const double tol2 = std::max(tolerance, barrier_tol_mult * mu);
      if (inf_pr < tol2 && inf_du < tol2 && inf_comp < tol2 &&
          step_norm < tolerance * 10.0) {
        status = 1;  // OPTIMAL
        break;
      }
      if (acceptable_tolerance > 0) {
        const double accept_tol = std::sqrt(acceptable_tolerance);
        const double barrier_accept_tol =
            std::max(mu_min * 100.0, tolerance / 10.0);
        const bool acc_kkt = inf_pr < accept_tol && inf_du < accept_tol &&
                             inf_comp < accept_tol;
        const bool barrier_done = mu <= barrier_accept_tol;
        const bool acc =
            (acc_kkt && barrier_done && it > 10 &&
             std::fabs(dJ) < acceptable_tolerance) ||
            (acc_kkt && barrier_done && it >= 1 &&
             step_norm < tolerance * 10.0 && inf_pr < 1e-4);
        if (acc) {
          status = 2;  // ACCEPTABLE
          break;
        }
      }
    } else {
      // handleForwardPassFailure (:2037-2082)
      reg = std::min(reg * reg_factor, reg_max);
      const bool limit = reg >= reg_max;
      if (limit) {
        const double accept_tol =
            std::max(std::sqrt(std::max(acceptable_tolerance, tolerance)),
                     barrier_tol_mult * mu);
        const bool acceptable = acceptable_tolerance > 0 &&
                                inf_pr < accept_tol && inf_du < accept_tol &&
                                inf_comp < accept_tol;
        status = acceptable ? 2 : 3;
        break;
      }
    }
  }

  out_stats[0] = cost;
  out_stats[1] = inf_pr;
  out_stats[2] = inf_du;
  out_stats[3] = inf_comp;
  out_stats[4] = mu;
  out_stats[5] = double(it);
  return status;
}

// ---------------------------------------------------------------------------
// IPDDP terminal-equality reduced-LQR engine — the independent oracle for
// the hardest backward regime (ipddp_solver.cpp:413-639 /
// cddp_tpu/solvers/ipddp.py _backward_terminal_eq): p+1 perturbed-q LQR
// sweeps, terminal-state sensitivity S = dx_T/dlambda, SVD-floored
// regularized least squares for dlambda with the 5-scale retry ladder, and
// linear gain recombination — plus the optional control-box condensation
// folded into the LQR stage data, the filter forward pass with costate and
// terminal-multiplier updates, and the no-barrier/barrier convergence
// branches. Terminal equality is x_N = target (identity Jacobian, p = nx),
// matching TerminalEqualityConstraint (terminal_constraint.hpp:62-158).
//
// Options layout = cddp_ipddp_solve's [0..25] plus
//  [26] jacobian_regularization_value [27] jacobian_regularization_exponent
// Writes [cost, inf_pr, inf_du, inf_comp, mu, iterations] to out_stats,
// the final terminal multiplier into lambda_T_out (nx), and returns a
// cddp_tpu.solution.Status code.
int cddp_ipddp_terminal_eq_solve(
    int model_id, const double* params, int N, double dt,
    const double* Qs, const double* Rs, const double* Qf, const double* goal,
    const double* x0, int has_box, const double* lower, const double* upper,
    const double* target, const double* opts, const double* U0,
    double* X, double* U, double* lambda_T_out, double* out_stats) {
  using namespace ipddp_native;
  if (!model_id_valid(model_id)) return -100;  // unknown model
  const Model mdl = make_model(model_id, dt);
  const int nx = mdl.nx, nu = mdl.nu;
  const int m = has_box ? 2 * nu : 0;
  const int p = nx;  // terminal-equality rows (identity Jacobian)

  const int max_iterations = (int)opts[0];
  const double tolerance = opts[1], acceptable_tolerance = opts[2];
  const double reg_init = opts[3], reg_min = opts[4], reg_max = opts[5],
               reg_factor = opts[6];
  const int ls_max = (int)opts[7];
  const double ls_initial = opts[8], ls_min = opts[9], ls_red = opts[10];
  const double mu_initial = opts[11], mu_min_value = opts[12],
               mu_update_factor = opts[13], mu_update_power = opts[14],
               min_ftb = opts[15];
  const double f_merit_acc = opts[16], f_viol_acc = opts[17],
               f_max_viol = opts[18], f_min_viol_armijo = opts[19],
               f_armijo = opts[20];
  const double y0_scale = opts[21], s0_scale = opts[22];
  const double barrier_tol_mult = opts[23], theta_0_floor = opts[24];
  const int max_filter_size = (int)opts[25];
  const double jac_reg_value = opts[26], jac_reg_exponent = opts[27];

  std::vector<double> alphas;
  {
    double a = ls_initial;
    for (int i = 0; i < std::max(1, ls_max); ++i) {
      alphas.push_back(a);
      a *= ls_red;
      if (a < ls_min && i < ls_max - 1) {
        alphas.push_back(ls_min);
        break;
      }
    }
  }

  auto eval_g = [&](const double* u, double* g) {
    for (int i = 0; i < nu; ++i) g[i] = -u[i] + lower[i];
    for (int i = 0; i < nu; ++i) g[nu + i] = u[i] - upper[i];
  };

  std::vector<double> xdot(nx), Fx(nx * nx), Fu(nx * nu);
  auto rollout = [&](const double* Uc, double* Xc) {
    std::memcpy(Xc, x0, sizeof(double) * nx);
    for (int t = 0; t < N; ++t) {
      mdl.f(&Xc[t * nx], &Uc[t * nu], params, xdot.data());
      for (int i = 0; i < nx; ++i)
        Xc[(t + 1) * nx + i] = Xc[t * nx + i] + dt * xdot[i];
    }
  };
  auto run_cost = [&](const double* x, const double* u) {
    double J = 0.0;
    for (int i = 0; i < nx; ++i) {
      double e_i = x[i] - goal[i];
      for (int j = 0; j < nx; ++j) J += e_i * Qs[i * nx + j] * (x[j] - goal[j]);
    }
    for (int i = 0; i < nu; ++i)
      for (int j = 0; j < nu; ++j) J += u[i] * Rs[i * nu + j] * u[j];
    return J;
  };
  auto term_cost = [&](const double* x) {
    double J = 0.0;
    for (int i = 0; i < nx; ++i) {
      double e_i = x[i] - goal[i];
      for (int j = 0; j < nx; ++j) J += e_i * Qf[i * nx + j] * (x[j] - goal[j]);
    }
    return J;
  };

  // --- cold-start init: mu = mu_initial (has_te => has_any constraint) ----
  std::memcpy(U, U0, sizeof(double) * N * nu);
  rollout(U, X);
  double mu = mu_initial;
  std::vector<double> G(N * m), S(N * m), Y(N * m);
  for (int t = 0; t < N && m > 0; ++t) eval_g(&U[t * nu], &G[t * m]);
  for (int i = 0; i < N * m; ++i) {
    S[i] = std::max(s0_scale, -G[i] + kSlackOffset);
    Y[i] = mu * y0_scale / std::max(S[i], kEpsSlack);
  }
  std::vector<double> Lambda((N + 1) * nx, 0.0);
  std::vector<double> LamT(p, 0.0);

  auto h_of = [&](const double* xN, double* h) {
    for (int i = 0; i < p; ++i) h[i] = xN[i] - target[i];
  };

  auto barrier_merit = [&](double J, const std::vector<double>& Sv,
                           const std::vector<double>& lamT,
                           const double* h, double mu_) {
    double v = J;
    for (int i = 0; i < N * m; ++i)
      v -= mu_ * std::log(std::max(Sv[i], kEpsSlack));
    for (int i = 0; i < p; ++i) v += lamT[i] * h[i];
    return v;
  };
  auto theta_of = [&](const std::vector<double>& Gv,
                      const std::vector<double>& Sv, const double* h) {
    double total = 0.0, max_entry = 0.0;
    for (int i = 0; i < N * m; ++i) {
      const double r = Gv[i] + Sv[i];
      total += std::fabs(r);
      max_entry = std::max(max_entry, std::fabs(r));
    }
    for (int i = 0; i < p; ++i) {
      total += std::fabs(h[i]);
      max_entry = std::max(max_entry, std::fabs(h[i]));
    }
    return std::max(total, max_entry);
  };
  auto primal_comp = [&](const std::vector<double>& Gv,
                         const std::vector<double>& Sv,
                         const std::vector<double>& Yv, const double* h,
                         double mu_, double* pr, double* comp) {
    *pr = 0.0;
    *comp = 0.0;
    for (int i = 0; i < N * m; ++i) {
      *pr = std::max(*pr, std::fabs(Gv[i] + Sv[i]));
      *comp = std::max(*comp, std::fabs(Yv[i] * Sv[i] - mu_));
    }
    for (int i = 0; i < p; ++i) *pr = std::max(*pr, std::fabs(h[i]));
  };

  double cost = 0.0;
  for (int t = 0; t < N; ++t) cost += run_cost(&X[t * nx], &U[t * nu]);
  cost += term_cost(&X[N * nx]);
  std::vector<double> h_T(p);
  h_of(&X[N * nx], h_T.data());

  double inf_pr, inf_comp;
  primal_comp(G, S, Y, h_T.data(), mu, &inf_pr, &inf_comp);
  double merit = barrier_merit(cost, S, LamT, h_T.data(), mu);
  double filter_theta = std::max(theta_of(G, S, h_T.data()), 1e-8);
  Filter filt;
  filt.accept(merit, filter_theta);  // has_te seeds the filter
  double phi = merit;

  double reg = reg_init;
  double inf_du = 0.0, step_norm = 0.0, alpha_pr_acc = 1.0;
  int status = 0;  // MAX_ITERATIONS_REACHED
  int it = 0;

  // Stage/work buffers.
  const int nv = p + 1;
  std::vector<double> As(N * nx * nx), Bs(N * nx * nu);
  std::vector<double> Qst(N * nx * nx), qst(N * nx), Rst(N * nu * nu),
      rst(N * nu), Mst(N * nx * nu);
  std::vector<double> sigma(N * m), pr_res(N * m), rhat(N * m),
      s_inv_rhat(N * m);
  std::vector<double> Vx(nx), Vxx(nx * nx);
  std::vector<double> k_v(nv * N * nu), p_v(nv * (N + 1) * nx);
  std::vector<double> K0(N * nu * nx), P0((N + 1) * nx * nx);
  std::vector<double> k_u(N * nu), p_comb((N + 1) * nx), dLamT(p);
  std::vector<double> k_y(N * m), K_y(N * m * nx), k_s(N * m), K_s(N * m * nx);
  std::vector<double> dS(N * m), dY(N * m), dX((N + 1) * nx);
  std::vector<double> work(16 * 16);
  std::vector<double> Xtry((N + 1) * nx), Utry(N * nu), Stry(N * m),
      Ytry(N * m), Gtry(N * m), Lamtry((N + 1) * nx), LamTtry(p), htry(p);

  // Cyclic Jacobi eigenvalues of a small symmetric matrix (p <= 16).
  auto sym_eigvals = [&](std::vector<double> Amat, int n,
                         std::vector<double>& ev) {
    for (int sweep = 0; sweep < 60; ++sweep) {
      double off = 0.0;
      for (int i = 0; i < n; ++i)
        for (int j = i + 1; j < n; ++j) off += Amat[i * n + j] * Amat[i * n + j];
      if (off < 1e-30) break;
      for (int i = 0; i < n; ++i)
        for (int j = i + 1; j < n; ++j) {
          const double apq = Amat[i * n + j];
          if (std::fabs(apq) < 1e-300) continue;
          const double app = Amat[i * n + i], aqq = Amat[j * n + j];
          const double theta2 = (aqq - app) / (2.0 * apq);
          const double tsign = theta2 >= 0.0 ? 1.0 : -1.0;
          const double tval =
              tsign / (std::fabs(theta2) + std::sqrt(theta2 * theta2 + 1.0));
          const double c = 1.0 / std::sqrt(tval * tval + 1.0);
          const double s = tval * c;
          for (int k2 = 0; k2 < n; ++k2) {
            const double aik = Amat[k2 * n + i], ajk = Amat[k2 * n + j];
            Amat[k2 * n + i] = c * aik - s * ajk;
            Amat[k2 * n + j] = s * aik + c * ajk;
          }
          for (int k2 = 0; k2 < n; ++k2) {
            const double aki = Amat[i * n + k2], akj = Amat[j * n + k2];
            Amat[i * n + k2] = c * aki - s * akj;
            Amat[j * n + k2] = s * aki + c * akj;
          }
        }
    }
    ev.resize(n);
    for (int i = 0; i < n; ++i) ev[i] = Amat[i * n + i];
  };

  for (it = 0; it < max_iterations;) {
    ++it;
    // ---- backward pass with regularization retry -------------------------
    double bp_inf_du = 0.0, bp_inf_pr = 0.0, bp_inf_comp = 0.0,
           bp_step_norm = 0.0;
    bool bp_limit = false;
    while (true) {
      bool ok = true;
      bp_inf_du = bp_inf_pr = bp_inf_comp = bp_step_norm = 0.0;

      // Stage LQR data (ipddp.py _backward_terminal_eq: Qs/qs/Rs/rs/Ms with
      // the path condensation folded in, then Rs += reg*I).
      for (int t = 0; t < N; ++t) {
        const double* xt = &X[t * nx];
        const double* ut = &U[t * nu];
        mdl.jac(xt, ut, params, Fx.data(), Fu.data());
        for (int i = 0; i < nx; ++i)
          for (int j = 0; j < nx; ++j)
            As[t * nx * nx + i * nx + j] =
                (i == j ? 1.0 : 0.0) + dt * Fx[i * nx + j];
        for (int i = 0; i < nx; ++i)
          for (int j = 0; j < nu; ++j)
            Bs[t * nx * nu + i * nu + j] = dt * Fu[i * nu + j];
        for (int i = 0; i < nx; ++i) {
          double s = 0.0;
          for (int j = 0; j < nx; ++j)
            s += 2.0 * Qs[i * nx + j] * (xt[j] - goal[j]);
          qst[t * nx + i] = s;
          for (int j = 0; j < nx; ++j)
            Qst[t * nx * nx + i * nx + j] = 2.0 * Qs[i * nx + j];
        }
        for (int i = 0; i < nu; ++i) {
          double s = 0.0;
          for (int j = 0; j < nu; ++j) s += 2.0 * Rs[i * nu + j] * ut[j];
          rst[t * nu + i] = s;
          for (int j = 0; j < nu; ++j)
            Rst[t * nu * nu + i * nu + j] = 2.0 * Rs[i * nu + j];
        }
        std::memset(&Mst[t * nx * nu], 0, sizeof(double) * nx * nu);

        if (m > 0) {
          // Box rows: G = [-u+lb; u-ub], Gx = 0, Gu = [-I; I]. Condensation
          // touches only the control blocks (Gx = 0).
          const double* gt = &G[t * m];
          const double* st2 = &S[t * m];
          const double* yt = &Y[t * m];
          for (int r = 0; r < m; ++r) {
            const double ss = s_safe(st2[r], mu);
            sigma[t * m + r] = clip_pos(yt[r], ss);
            pr_res[t * m + r] = gt[r] + st2[r];
            const double comp_r = yt[r] * st2[r] - mu;
            rhat[t * m + r] = yt[r] * pr_res[t * m + r] - comp_r;
            s_inv_rhat[t * m + r] = clip_signed(rhat[t * m + r], ss);
            bp_inf_pr = std::max(bp_inf_pr, std::fabs(pr_res[t * m + r]));
            bp_inf_comp = std::max(bp_inf_comp, std::fabs(comp_r));
          }
          for (int i = 0; i < nu; ++i) {
            // Gu row i (of -I block) and row nu+i (of +I block).
            rst[t * nu + i] +=
                -(Y[t * m + i] + s_inv_rhat[t * m + i]) +
                (Y[t * m + nu + i] + s_inv_rhat[t * m + nu + i]);
            Rst[t * nu * nu + i * nu + i] +=
                sigma[t * m + i] + sigma[t * m + nu + i];
          }
        }
        for (int i = 0; i < nu; ++i) Rst[t * nu * nu + i * nu + i] += reg;
      }

      // Terminal block.
      for (int i = 0; i < nx; ++i) {
        double s = 0.0;
        for (int j = 0; j < nx; ++j)
          s += 2.0 * Qf[i * nx + j] * (X[N * nx + j] - goal[j]);
        Vx[i] = s;
        for (int j = 0; j < nx; ++j) Vxx[i * nx + j] = 2.0 * Qf[i * nx + j];
      }
      h_of(&X[N * nx], h_T.data());
      for (int i = 0; i < p; ++i)
        bp_inf_pr = std::max(bp_inf_pr, std::fabs(h_T[i]));

      // p+1 LQR variants: variant 0 base q_T = Vx + LamT; variant v>0 adds
      // e_{v-1} (H_T row). K/P are variant-independent; recomputed per
      // sweep for simplicity (p <= 4, nx <= 4).
      for (int v = 0; v < nv && ok; ++v) {
        std::vector<double> P(Vxx), pvec(nx);
        for (int i = 0; i < nx; ++i) pvec[i] = Vx[i] + LamT[i];
        if (v > 0) pvec[v - 1] += 1.0;
        std::memcpy(&p_v[(v * (N + 1) + N) * nx], pvec.data(),
                    sizeof(double) * nx);
        if (v == 0)
          std::memcpy(&P0[N * nx * nx], P.data(), sizeof(double) * nx * nx);

        for (int t = N - 1; t >= 0 && ok; --t) {
          const double* A = &As[t * nx * nx];
          const double* B = &Bs[t * nx * nu];
          std::vector<double> BtP(nu * nx);
          for (int i = 0; i < nu; ++i)
            for (int j = 0; j < nx; ++j) {
              double s = 0.0;
              for (int k2 = 0; k2 < nx; ++k2)
                s += B[k2 * nu + i] * P[k2 * nx + j];
              BtP[i * nx + j] = s;
            }
          std::vector<double> Quu(nu * nu), Qux(nu * nx), Qx(nx), Qu(nu);
          for (int i = 0; i < nu; ++i)
            for (int j = 0; j < nu; ++j) {
              double s = Rst[t * nu * nu + i * nu + j];
              for (int k2 = 0; k2 < nx; ++k2)
                s += BtP[i * nx + k2] * B[k2 * nu + j];
              Quu[i * nu + j] = s;
            }
          for (int i = 0; i < nu; ++i)
            for (int j = 0; j < nu; ++j) {
              const double s = 0.5 * (Quu[i * nu + j] + Quu[j * nu + i]);
              Quu[i * nu + j] = s;
              Quu[j * nu + i] = s;
            }
          for (int i = 0; i < nu; ++i)
            for (int j = 0; j < nx; ++j) {
              double s = Mst[t * nx * nu + j * nu + i];  // M' row i col j
              for (int k2 = 0; k2 < nx; ++k2)
                s += BtP[i * nx + k2] * A[k2 * nx + j];
              Qux[i * nx + j] = s;
            }
          const double* p_next = &p_v[(v * (N + 1) + t + 1) * nx];
          for (int i = 0; i < nx; ++i) {
            double s = qst[t * nx + i];
            for (int k2 = 0; k2 < nx; ++k2) s += A[k2 * nx + i] * p_next[k2];
            Qx[i] = s;
          }
          for (int i = 0; i < nu; ++i) {
            double s = rst[t * nu + i];
            for (int k2 = 0; k2 < nx; ++k2) s += B[k2 * nu + i] * p_next[k2];
            Qu[i] = s;
          }
          // Solve Quu [k K] = -[Qu Qux].
          std::vector<double> rhs_kk(nu * (1 + nx)), kK(nu * (1 + nx));
          for (int i = 0; i < nu; ++i) {
            rhs_kk[i * (1 + nx)] = Qu[i];
            for (int j = 0; j < nx; ++j) rhs_kk[i * (1 + nx) + 1 + j] = Qux[i * nx + j];
          }
          if (!chol_solve(Quu.data(), rhs_kk.data(), kK.data(), nu, 1 + nx,
                          work.data())) {
            ok = false;
            break;
          }
          double* kt = &k_v[(v * N + t) * nu];
          std::vector<double> Kt(nu * nx);
          for (int i = 0; i < nu; ++i) {
            kt[i] = -kK[i * (1 + nx)];
            for (int j = 0; j < nx; ++j) Kt[i * nx + j] = -kK[i * (1 + nx) + 1 + j];
          }
          // P_t = sym(Q + A'PA + Qux'K + K'Qux + K'QuuK);
          // p_t = Qx + Qux'k + K'Qu + K'Quu k.
          std::vector<double> PA(nx * nx);
          for (int i = 0; i < nx; ++i)
            for (int j = 0; j < nx; ++j) {
              double s = 0.0;
              for (int k2 = 0; k2 < nx; ++k2) s += P[i * nx + k2] * A[k2 * nx + j];
              PA[i * nx + j] = s;
            }
          std::vector<double> Pn(nx * nx), pn(nx);
          for (int i = 0; i < nx; ++i)
            for (int j = 0; j < nx; ++j) {
              double s = Qst[t * nx * nx + i * nx + j];
              for (int k2 = 0; k2 < nx; ++k2) s += A[k2 * nx + i] * PA[k2 * nx + j];
              for (int r = 0; r < nu; ++r)
                s += Qux[r * nx + i] * Kt[r * nx + j] + Kt[r * nx + i] * Qux[r * nx + j];
              for (int r = 0; r < nu; ++r)
                for (int r2 = 0; r2 < nu; ++r2)
                  s += Kt[r * nx + i] * Quu[r * nu + r2] * Kt[r2 * nx + j];
              Pn[i * nx + j] = s;
            }
          for (int i = 0; i < nx; ++i)
            for (int j = i; j < nx; ++j) {
              const double s = 0.5 * (Pn[i * nx + j] + Pn[j * nx + i]);
              Pn[i * nx + j] = s;
              Pn[j * nx + i] = s;
            }
          for (int i = 0; i < nx; ++i) {
            double s = Qx[i];
            for (int r = 0; r < nu; ++r) s += Qux[r * nx + i] * kt[r];
            for (int r = 0; r < nu; ++r) s += Kt[r * nx + i] * Qu[r];
            for (int r = 0; r < nu; ++r)
              for (int r2 = 0; r2 < nu; ++r2)
                s += Kt[r * nx + i] * Quu[r * nu + r2] * kt[r2];
            pn[i] = s;
          }
          for (double x2 : Pn) if (!std::isfinite(x2)) ok = false;
          for (double x2 : pn) if (!std::isfinite(x2)) ok = false;
          std::memcpy(&p_v[(v * (N + 1) + t) * nx], pn.data(),
                      sizeof(double) * nx);
          if (v == 0) {
            std::memcpy(&K0[t * nu * nx], Kt.data(), sizeof(double) * nu * nx);
            std::memcpy(&P0[t * nx * nx], Pn.data(), sizeof(double) * nx * nx);
          }
          P.swap(Pn);
          pvec.swap(pn);
        }
      }

      if (ok) {
        // xT per variant via the linear rollout dx0 = 0 (K := K0).
        std::vector<double> xT_v(nv * nx);
        for (int v = 0; v < nv; ++v) {
          std::vector<double> dx(nx, 0.0), dxn(nx), du(nu);
          for (int t = 0; t < N; ++t) {
            const double* A = &As[t * nx * nx];
            const double* B = &Bs[t * nx * nu];
            const double* kt = &k_v[(v * N + t) * nu];
            const double* Kt = &K0[t * nu * nx];
            for (int i = 0; i < nu; ++i) {
              double s = kt[i];
              for (int j = 0; j < nx; ++j) s += Kt[i * nx + j] * dx[j];
              du[i] = s;
            }
            for (int i = 0; i < nx; ++i) {
              double s = 0.0;
              for (int j = 0; j < nx; ++j) s += A[i * nx + j] * dx[j];
              for (int j = 0; j < nu; ++j) s += B[i * nu + j] * du[j];
              dxn[i] = s;
            }
            dx.swap(dxn);
          }
          std::memcpy(&xT_v[v * nx], dx.data(), sizeof(double) * nx);
        }

        // Sensitivity + regularized LS for dlambda (:550-617). H = I so
        // A_small = S_mat, rhs = -h_T - xT_0.
        std::vector<double> A_small(nx * p), rhs(p), AtA(p * p), Atb(p);
        for (int i = 0; i < nx; ++i)
          for (int c2 = 0; c2 < p; ++c2)
            A_small[i * p + c2] = xT_v[(c2 + 1) * nx + i] - xT_v[i];
        for (int i = 0; i < p; ++i) rhs[i] = -h_T[i] - xT_v[i];
        for (int i = 0; i < p; ++i)
          for (int j = 0; j < p; ++j) {
            double s = 0.0;
            for (int k2 = 0; k2 < nx; ++k2)
              s += A_small[k2 * p + i] * A_small[k2 * p + j];
            AtA[i * p + j] = s;
          }
        for (int i = 0; i < p; ++i) {
          double s = 0.0;
          for (int k2 = 0; k2 < nx; ++k2) s += A_small[k2 * p + i] * rhs[k2];
          Atb[i] = s;
        }
        double trace = 0.0;
        for (int i = 0; i < p; ++i) trace += AtA[i * p + i];
        const double trace_term = trace > 1.0 ? trace / (double)p : 1.0;
        const double base_floor =
            std::max(1e-10, jac_reg_value *
                                std::pow(std::max(mu, 0.0), jac_reg_exponent));
        const double reg0 = std::max(base_floor, 1e-6 * trace_term);
        std::vector<double> ev;
        sym_eigvals(AtA, p, ev);
        double max_sv = 0.0, min_sv = 1e300;
        for (int i = 0; i < p; ++i) {
          const double sv = std::sqrt(std::max(ev[i], 0.0));
          max_sv = std::max(max_sv, sv);
          min_sv = std::min(min_sv, sv);
        }
        const double svd_reg = std::max(1e-8 * max_sv - min_sv, 0.0);
        const double reg_base = std::max(reg0, svd_reg);
        double rhs_norm = 0.0;
        for (int i = 0; i < p; ++i) rhs_norm += rhs[i] * rhs[i];
        rhs_norm = std::sqrt(rhs_norm);
        const double lambda_cap = 100.0 * (1.0 + rhs_norm);

        const double scales[5] = {1.0, 10.0, 100.0, 1e3, 1e4};
        double best_res = 1e301;
        std::vector<double> best_lambda(p, 0.0), lam(p), shifted(p * p);
        for (int si = 0; si < 5; ++si) {
          const double reg_i = std::max(reg_base * scales[si], 1e-12);
          std::memcpy(shifted.data(), AtA.data(), sizeof(double) * p * p);
          for (int i = 0; i < p; ++i) shifted[i * p + i] += reg_i;
          // chol_solve expects b as (n x nrhs); nrhs = 1.
          if (!chol_solve(shifted.data(), Atb.data(), lam.data(), p, 1,
                          work.data()))
            continue;
          double lam_norm = 0.0;
          bool fin = true;
          for (int i = 0; i < p; ++i) {
            lam_norm += lam[i] * lam[i];
            fin = fin && std::isfinite(lam[i]);
          }
          lam_norm = std::sqrt(lam_norm);
          if (lam_norm > lambda_cap)
            for (int i = 0; i < p; ++i)
              lam[i] *= lambda_cap / std::max(lam_norm, 1e-12);
          double res = 0.0;
          for (int i = 0; i < nx; ++i) {
            double s = -rhs[i];
            for (int j = 0; j < p; ++j) s += A_small[i * p + j] * lam[j];
            res += s * s;
          }
          res = std::sqrt(res);
          if (!fin || !std::isfinite(res)) continue;
          if (res < best_res) {
            best_res = res;
            best_lambda = lam;
          }
        }
        // (JAX: lambda = 0 when every ladder entry failed.)

        // Recombine gains (:619-634): k_u = k0 + sum_i c_i (k_i - k0).
        for (int t = 0; t < N; ++t)
          for (int i = 0; i < nu; ++i) {
            double s = k_v[t * nu + i];
            for (int v = 1; v < nv; ++v)
              s += best_lambda[v - 1] *
                   (k_v[(v * N + t) * nu + i] - k_v[t * nu + i]);
            k_u[t * nu + i] = s;
          }
        for (int t = 0; t <= N; ++t)
          for (int i = 0; i < nx; ++i) {
            double s = p_v[t * nx + i];
            for (int v = 1; v < nv; ++v)
              s += best_lambda[v - 1] *
                   (p_v[(v * (N + 1) + t) * nx + i] - p_v[t * nx + i]);
            p_comb[t * nx + i] = s;
          }
        std::memcpy(dLamT.data(), best_lambda.data(), sizeof(double) * p);

        // inf_du = max |rs_t + B_t' p_comb[t+1]|; step_norm = max|k_u|.
        for (int t = 0; t < N; ++t) {
          const double* B = &Bs[t * nx * nu];
          for (int i = 0; i < nu; ++i) {
            double s = rst[t * nu + i];
            for (int k2 = 0; k2 < nx; ++k2)
              s += B[k2 * nu + i] * p_comb[(t + 1) * nx + k2];
            bp_inf_du = std::max(bp_inf_du, std::fabs(s));
          }
        }
        for (int i = 0; i < N * nu; ++i)
          bp_step_norm = std::max(bp_step_norm, std::fabs(k_u[i]));

        // Combined-gain linear rollout for the dual/slack steps.
        {
          std::vector<double> dx(nx, 0.0), dxn(nx), du(nu);
          for (int t = 0; t < N; ++t) {
            std::memcpy(&dX[t * nx], dx.data(), sizeof(double) * nx);
            const double* A = &As[t * nx * nx];
            const double* B = &Bs[t * nx * nu];
            for (int i = 0; i < nu; ++i) {
              double s = k_u[t * nu + i];
              for (int j = 0; j < nx; ++j) s += K0[t * nu * nx + i * nx + j] * dx[j];
              du[i] = s;
            }
            for (int i = 0; i < nx; ++i) {
              double s = 0.0;
              for (int j = 0; j < nx; ++j) s += A[i * nx + j] * dx[j];
              for (int j = 0; j < nu; ++j) s += B[i * nu + j] * du[j];
              dxn[i] = s;
            }
            dx.swap(dxn);
          }
          std::memcpy(&dX[N * nx], dx.data(), sizeof(double) * nx);
        }

        if (m > 0) {
          // Path gains (Gx = 0, Gu = [-I; I]): temp = Gu k_u.
          for (int t = 0; t < N; ++t) {
            for (int r = 0; r < m; ++r) {
              const int i = r % nu;
              const double gu_sign = r < nu ? -1.0 : 1.0;
              const double temp = gu_sign * k_u[t * nu + i];
              const double ss = s_safe(S[t * m + r], mu);
              k_y[t * m + r] =
                  clip_signed(rhat[t * m + r] + Y[t * m + r] * temp, ss);
              k_s[t * m + r] = -pr_res[t * m + r] - temp;
              for (int j = 0; j < nx; ++j) {
                const double guK = gu_sign * K0[t * nu * nx + i * nx + j];
                K_y[(t * m + r) * nx + j] = std::min(
                    std::max(sigma[t * m + r] * guK, -kMaxRatio), kMaxRatio);
                K_s[(t * m + r) * nx + j] = -guK;
              }
              double ds = k_s[t * m + r], dy = k_y[t * m + r];
              for (int j = 0; j < nx; ++j) {
                ds += K_s[(t * m + r) * nx + j] * dX[t * nx + j];
                dy += K_y[(t * m + r) * nx + j] * dX[t * nx + j];
              }
              dS[t * m + r] = ds;
              dY[t * m + r] = std::min(std::max(dy, -kMaxRatio), kMaxRatio);
            }
          }
        }
        for (double x2 : k_u) if (!std::isfinite(x2)) ok = false;
      }

      if (ok) {
        bp_limit = false;
        break;
      }
      // JAX parity: limit declared when the NEXT reg reaches the cap (the
      // attempt at the cap itself never runs — ipddp.py bp_body).
      const double reg_next = std::min(reg * reg_factor, reg_max);
      reg = reg_next;
      if (reg_next >= reg_max) {
        bp_limit = true;
        break;
      }
    }
    if (bp_limit) {
      status = 3;  // REGULARIZATION_LIMIT_NOT_CONVERGED
      inf_pr = bp_inf_pr;
      inf_du = bp_inf_du;
      inf_comp = bp_inf_comp;
      break;
    }
    inf_pr = bp_inf_pr;
    inf_du = bp_inf_du;
    inf_comp = bp_inf_comp;
    step_norm = bp_step_norm;

    // ---- early convergence ----------------------------------------------
    bool early;
    if (m == 0) {
      early = inf_pr < tolerance && inf_du < tolerance;
    } else {
      const double tolb = std::max(tolerance, barrier_tol_mult * mu);
      early = inf_pr < tolb && inf_du < tolb && inf_comp < tolb &&
              std::fabs(alpha_pr_acc) * step_norm < tolerance * 10.0;
    }
    if (early) {
      status = 1;  // OPTIMAL
      break;
    }

    // ---- fraction-to-boundary max step sizes ----------------------------
    double a_pr_max = 1.0, a_du_max = 1.0;
    const double tau =
        m == 0 ? 1.0 : std::max(min_ftb, 1.0 - mu);
    for (int i = 0; i < N * m; ++i) {
      if (dS[i] < 0.0) a_pr_max = std::min(a_pr_max, -tau * S[i] / dS[i]);
      if (dY[i] < 0.0) a_du_max = std::min(a_du_max, -tau * Y[i] / dY[i]);
    }
    a_pr_max = std::min(std::max(a_pr_max, 0.0), 1.0);
    a_du_max = std::min(std::max(a_du_max, 0.0), 1.0);

    // ---- sequential first-success filter line search ---------------------
    bool any_success = false;
    double J_new = 0.0, phi_new = 0.0, theta_new = 0.0, inf_pr_new = 0.0,
           inf_comp_new = 0.0, alpha_pr_used = 1.0;
    for (double alpha : alphas) {
      const double a_pr = std::min(alpha, a_pr_max);
      const double a_du = std::min(alpha, a_du_max);
      bool feasible = true;
      double J = 0.0;
      std::memcpy(&Xtry[0], x0, sizeof(double) * nx);
      for (int t = 0; t < N && feasible; ++t) {
        const double* xb = &X[t * nx];
        double* xt = &Xtry[t * nx];
        std::vector<double> dx(nx);
        for (int i = 0; i < nx; ++i) dx[i] = xt[i] - xb[i];
        // costate update
        for (int i = 0; i < nx; ++i) {
          double s = Lambda[t * nx + i] + a_pr * p_comb[t * nx + i];
          for (int j = 0; j < nx; ++j)
            s += P0[t * nx * nx + i * nx + j] * dx[j];
          Lamtry[t * nx + i] = s;
          feasible = feasible && std::isfinite(s);
        }
        for (int r = 0; r < m; ++r) {
          const double s_new = S[t * m + r] + a_pr * k_s[t * m + r] +
                               [&] {
                                 double acc = 0.0;
                                 for (int j = 0; j < nx; ++j)
                                   acc += K_s[(t * m + r) * nx + j] * dx[j];
                                 return acc;
                               }();
          const double y_new = Y[t * m + r] + a_du * k_y[t * m + r] +
                               [&] {
                                 double acc = 0.0;
                                 for (int j = 0; j < nx; ++j)
                                   acc += K_y[(t * m + r) * nx + j] * dx[j];
                                 return acc;
                               }();
          Stry[t * m + r] = s_new;
          Ytry[t * m + r] = y_new;
          feasible = feasible && ftb_ok(s_new, S[t * m + r], tau) &&
                     ftb_ok(y_new, Y[t * m + r], tau) &&
                     std::isfinite(s_new) && std::isfinite(y_new);
        }
        double* ut = &Utry[t * nu];
        for (int i = 0; i < nu; ++i) {
          double s = U[t * nu + i] + a_pr * k_u[t * nu + i];
          for (int j = 0; j < nx; ++j)
            s += K0[t * nu * nx + i * nx + j] * dx[j];
          ut[i] = s;
          feasible = feasible && std::isfinite(s);
        }
        J += run_cost(xt, ut);
        if (m > 0) eval_g(ut, &Gtry[t * m]);
        mdl.f(xt, ut, params, xdot.data());
        for (int i = 0; i < nx; ++i) {
          const double xn = xt[i] + dt * xdot[i];
          Xtry[(t + 1) * nx + i] = xn;
          feasible = feasible && std::isfinite(xn);
        }
      }
      if (!feasible) continue;
      J += term_cost(&Xtry[N * nx]);
      // terminal costate + multiplier
      {
        std::vector<double> dxl(nx);
        for (int i = 0; i < nx; ++i)
          dxl[i] = Xtry[N * nx + i] - X[N * nx + i];
        for (int i = 0; i < nx; ++i) {
          double s = Lambda[N * nx + i] + a_pr * p_comb[N * nx + i];
          for (int j = 0; j < nx; ++j)
            s += P0[N * nx * nx + i * nx + j] * dxl[j];
          Lamtry[N * nx + i] = s;
          feasible = feasible && std::isfinite(s);
        }
      }
      for (int i = 0; i < p; ++i) {
        LamTtry[i] = LamT[i] + a_pr * dLamT[i];
        feasible = feasible && std::isfinite(LamTtry[i]);
      }
      h_of(&Xtry[N * nx], htry.data());

      const double phi_t = barrier_merit(J, Stry, LamTtry, htry.data(), mu);
      const double theta_t = theta_of(Gtry, Stry, htry.data());
      double pr_t, comp_t;
      primal_comp(Gtry, Stry, Ytry, htry.data(), mu, &pr_t, &comp_t);
      feasible = feasible && std::isfinite(phi_t) && std::isfinite(theta_t) &&
                 std::isfinite(pr_t) && std::isfinite(comp_t);
      if (!feasible) continue;

      // Filter acceptance (3 branches; expected_improvement = 0 since the
      // terminal-eq backward reports dV = 0, matching the JAX port).
      double f_mf, f_cv;
      const bool nonempty = filt.back(&f_mf, &f_cv);
      const double cv_old = nonempty ? f_cv : 0.0;
      const double high_violation_ref = nonempty ? f_cv : filter_theta;
      const double expected_improvement = 0.0;
      bool accept;
      if (theta_t > f_max_viol) {
        accept = theta_t < (1.0 - f_viol_acc) * high_violation_ref;
      } else if (std::max(theta_t, cv_old) < f_min_viol_armijo &&
                 expected_improvement < 0.0) {
        accept = phi_t < merit + f_armijo * expected_improvement;
      } else {
        accept = phi_t < merit - f_merit_acc * theta_t ||
                 theta_t < (1.0 - f_viol_acc) * cv_old;
      }
      if (accept) {
        any_success = true;
        J_new = J;
        phi_new = phi_t;
        theta_new = theta_t;
        inf_pr_new = pr_t;
        inf_comp_new = comp_t;
        alpha_pr_used = a_pr;
        break;
      }
    }

    if (any_success) {
      const double dJ = cost - J_new;
      std::memcpy(X, Xtry.data(), sizeof(double) * (N + 1) * nx);
      std::memcpy(U, Utry.data(), sizeof(double) * N * nu);
      if (m > 0) {
        S = Stry;
        Y = Ytry;
        G = Gtry;
      }
      Lambda = Lamtry;
      LamT = LamTtry;
      h_of(&X[N * nx], h_T.data());
      cost = J_new;
      merit = phi_new;
      phi = phi_new;
      inf_pr = inf_pr_new;
      inf_comp = inf_comp_new;
      alpha_pr_acc = alpha_pr_used;
      reg = std::max(reg / reg_factor, reg_min);

      // Barrier + filter update (updateBarrierParameters).
      const double mu_old = mu;
      double mu_new = mu_old;
      if (m > 0) {
        const double kkt = std::max(std::max(inf_pr, inf_du), inf_comp);
        const double threshold =
            std::max(mu_update_factor * mu_old, 2.0 * mu_old);
        const double ratio = kkt / std::max(mu_old, 1e-20);
        double factor = mu_update_factor;
        if (mu_old > 1e-20) {
          if (ratio < 0.01) factor = 0.1 * mu_update_factor;
          else if (ratio < 0.1) factor = 0.3 * mu_update_factor;
          else if (ratio < 0.5) factor = 0.6 * mu_update_factor;
        }
        const double linear = factor * mu_old;
        const double superlinear = std::pow(mu_old, mu_update_power);
        const double mu_cand =
            std::max(std::min(linear, superlinear),
                     std::max(mu_min_value, tolerance / 100.0));
        if (kkt <= threshold) mu_new = mu_cand;
      }
      filter_theta = std::max(theta_of(G, S, h_T.data()), 1e-8);
      const bool reset = mu_new < mu_old && mu_new > 0.0;
      if (reset) {
        filt.clear();
        filt.accept(phi, filter_theta);  // has_te
      } else {
        filt.accept(phi, filter_theta);
        if (filt.size() > max_filter_size) filt.prune_to_best();
      }
      mu = mu_new;
      primal_comp(G, S, Y, h_T.data(), mu, &inf_pr, &inf_comp);
      merit = barrier_merit(cost, S, LamT, h_T.data(), mu);

      // ---- convergence ---------------------------------------------------
      bool conv_opt, conv_acc = false;
      if (m == 0) {
        conv_opt = inf_pr < tolerance && inf_du < tolerance;
        if (acceptable_tolerance > 0.0) {
          const double sqrt_atol = std::sqrt(acceptable_tolerance);
          bool acc = inf_pr < sqrt_atol && inf_du < sqrt_atol && it > 50;
          acc = acc || (dJ > 0.0 && dJ < acceptable_tolerance && it > 50 &&
                        inf_pr < sqrt_atol && inf_du < sqrt_atol);
          conv_acc = acc;
        }
      } else {
        const double tol2 = std::max(tolerance, barrier_tol_mult * mu);
        conv_opt = inf_pr < tol2 && inf_du < tol2 && inf_comp < tol2 &&
                   step_norm < tolerance * 10.0;
        if (acceptable_tolerance > 0.0) {
          const double accept_tol = std::sqrt(acceptable_tolerance);
          const double barrier_accept_tol =
              std::max(mu_min_value * 100.0, tolerance / 10.0);
          const bool acc_kkt = inf_pr < accept_tol && inf_du < accept_tol &&
                               inf_comp < accept_tol;
          const bool barrier_done = mu <= barrier_accept_tol;
          bool acc = acc_kkt && barrier_done && it > 10 &&
                     std::fabs(dJ) < acceptable_tolerance;
          acc = acc || (acc_kkt && barrier_done && it >= 1 &&
                        step_norm < tolerance * 10.0 && inf_pr < 1e-4);
          conv_acc = acc;
        }
      }
      if (conv_opt) {
        status = 1;
        break;
      }
      if (conv_acc) {
        status = 2;
        break;
      }
    } else {
      // handleForwardPassFailure: reg escalation (doubled when path
      // constraints AND terminal equalities are both present).
      double reg_n = std::min(reg * reg_factor, reg_max);
      if (m > 0) reg_n = std::min(reg_n * reg_factor, reg_max);
      const bool limit = reg_n >= reg_max;
      bool acceptable = false;
      if (m == 0) {
        const double accept_tol =
            std::sqrt(std::max(acceptable_tolerance, tolerance));
        acceptable = acceptable_tolerance > 0.0 && inf_pr < accept_tol &&
                     inf_du < accept_tol;
      } else {
        const double accept_tol =
            std::max(std::sqrt(std::max(acceptable_tolerance, tolerance)),
                     barrier_tol_mult * mu);
        acceptable = acceptable_tolerance > 0.0 && inf_pr < accept_tol &&
                     inf_du < accept_tol && inf_comp < accept_tol;
      }
      reg = reg_n;
      if (limit) {
        status = acceptable ? 2 : 3;
        break;
      }
    }
  }

  std::memcpy(lambda_T_out, LamT.data(), sizeof(double) * p);
  out_stats[0] = cost;
  out_stats[1] = inf_pr;
  out_stats[2] = inf_du;
  out_stats[3] = inf_comp;
  out_stats[4] = mu;
  out_stats[5] = double(it);
  return status;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Full LogDDP solver engine — relaxed log-barrier DDP with the (merit,
// violation) filter acceptance (logddp_solver.cpp / cddp_tpu/solvers/
// logddp.py semantics). Control-box barrier only (the doubled one-sided
// distances u - lb and ub - u), iLQR, sequential first-success line search.
// With CLDDP and IPDDP this completes the native cross-language oracle for
// three of the four solver strategies.
// ---------------------------------------------------------------------------

namespace logddp_native {

// (beta, beta', beta'') of the relaxed log barrier
// (barrier.hpp:274-296 incl. the z <= 1e-12 log-branch guard).
inline void beta_derivs(double z, double delta, double* b, double* bp,
                        double* bpp) {
  if (z > delta) {
    const double zl = std::max(z, 1e-12);
    *b = -std::log(zl);
    *bp = -1.0 / zl;
    *bpp = 1.0 / (zl * zl);
  } else {
    const double term = (z - 2.0 * delta) / delta;
    *b = 0.5 * (term * term - 1.0) - std::log(delta);
    *bp = term / delta;
    *bpp = 1.0 / (delta * delta);
  }
}

}  // namespace logddp_native

extern "C" {

// Options layout (doubles):
//  [0] max_iterations [1] tolerance [2] acceptable_tolerance
//  [3] reg_init [4] reg_min [5] reg_max [6] reg_factor
//  [7] ls_max_iterations [8] ls_initial [9] ls_min [10] ls_reduction
//  [11] mu_initial [12] mu_min [13] mu_update_factor
//  [14] relaxed_log_barrier_delta
//  [15] filter.merit_acceptance [16] filter.violation_acceptance
//  [17] filter.max_violation [18] filter.min_violation_for_armijo
//  [19] filter.armijo_constant
// Writes [cost, cv (=inf_pr), inf_du, mu, iterations] to out_stats and
// returns a cddp_tpu.solution.Status code.
int cddp_logddp_solve(
    int model_id, const double* params, int N, double dt,
    const double* Qs, const double* Rs, const double* Qf, const double* goal,
    const double* x0, const double* lower, const double* upper,
    const double* opts, const double* U0,
    double* X, double* U, double* out_stats) {
  using logddp_native::beta_derivs;
  if (!model_id_valid(model_id)) return -100;  // unknown model
  const Model mdl = make_model(model_id, dt);
  const int nx = mdl.nx, nu = mdl.nu;

  const int max_iterations = (int)opts[0];
  const double tolerance = opts[1], acceptable_tolerance = opts[2];
  const double reg_init = opts[3], reg_min = opts[4], reg_max = opts[5],
               reg_factor = opts[6];
  const int ls_max = (int)opts[7];
  const double ls_initial = opts[8], ls_min = opts[9], ls_red = opts[10];
  const double mu_initial = opts[11], mu_min = opts[12],
               mu_update_factor = opts[13];
  const double delta = opts[14];
  const double f_merit_acc = opts[15], f_viol_acc = opts[16],
               f_max_viol = opts[17], f_min_viol_armijo = opts[18],
               f_armijo = opts[19];

  std::vector<double> alphas;
  {
    double a = ls_initial;
    for (int i = 0; i < std::max(1, ls_max); ++i) {
      alphas.push_back(a);
      a *= ls_red;
      if (a < ls_min && i < ls_max - 1) {
        alphas.push_back(ls_min);
        break;
      }
    }
  }

  std::vector<double> xdot(nx), Fx(nx * nx), Fu(nx * nu);
  auto rollout = [&](const double* Uc, double* Xc) {
    std::memcpy(Xc, x0, sizeof(double) * nx);
    for (int t = 0; t < N; ++t) {
      mdl.f(&Xc[t * nx], &Uc[t * nu], params, xdot.data());
      for (int i = 0; i < nx; ++i)
        Xc[(t + 1) * nx + i] = Xc[t * nx + i] + dt * xdot[i];
    }
  };
  auto run_cost = [&](const double* x, const double* u) {
    double J = 0.0;
    for (int i = 0; i < nx; ++i) {
      double e_i = x[i] - goal[i];
      for (int j = 0; j < nx; ++j) J += e_i * Qs[i * nx + j] * (x[j] - goal[j]);
    }
    for (int i = 0; i < nu; ++i)
      for (int j = 0; j < nu; ++j) J += u[i] * Rs[i * nu + j] * u[j];
    return J;
  };
  auto term_cost = [&](const double* x) {
    double J = 0.0;
    for (int i = 0; i < nx; ++i) {
      double e_i = x[i] - goal[i];
      for (int j = 0; j < nx; ++j) J += e_i * Qf[i * nx + j] * (x[j] - goal[j]);
    }
    return J;
  };
  // Barrier penalty + l1 violation over the whole trajectory
  // (_merit_and_violation).
  auto barrier_and_violation = [&](const double* Uc, double mu_, double* bc,
                                   double* cv) {
    *bc = 0.0;
    *cv = 0.0;
    for (int t = 0; t < N; ++t)
      for (int j = 0; j < nu; ++j) {
        const double u = Uc[t * nu + j];
        double b, bp, bpp;
        beta_derivs(u - lower[j], delta, &b, &bp, &bpp);
        *bc += mu_ * b;
        beta_derivs(upper[j] - u, delta, &b, &bp, &bpp);
        *bc += mu_ * b;
        *cv += std::max(lower[j] - u, 0.0) + std::max(u - upper[j], 0.0);
      }
  };

  std::memcpy(U, U0, sizeof(double) * N * nu);
  rollout(U, X);
  double cost = 0.0;
  for (int t = 0; t < N; ++t) cost += run_cost(&X[t * nx], &U[t * nu]);
  cost += term_cost(&X[N * nx]);
  double mu = mu_initial;
  double bc0, cv;
  barrier_and_violation(U, mu, &bc0, &cv);
  double merit = cost + bc0;

  double reg = reg_init;
  double inf_du = 1e300;
  int status = 0;  // MAX_ITERATIONS_REACHED
  int it = 0;

  std::vector<double> ks(N * nu), Ks(N * nu * nx);
  std::vector<double> Vx(nx), Vxx(nx * nx),
      work(std::max(nx, nu) * std::max(nx, nu));
  std::vector<double> A(nx * nx), B(nx * nu);
  std::vector<double> Xtry((N + 1) * nx), Utry(N * nu);

  for (it = 0; it < max_iterations;) {
    ++it;
    // preIterationSetup (logddp_solver.cpp:209-214): re-evaluate the
    // nominal merit/violation under the CURRENT mu.
    barrier_and_violation(U, mu, &bc0, &cv);
    merit = cost + bc0;

    // ---- backward pass with regularization retry -------------------------
    double dV0 = 0.0, dV1 = 0.0, Qu_err = 0.0;
    bool bp_ok = false, bp_limit = false;
    while (true) {
      bool ok = true;
      dV0 = dV1 = Qu_err = 0.0;
      for (int i = 0; i < nx; ++i) {
        double s = 0.0;
        for (int j = 0; j < nx; ++j)
          s += 2.0 * Qf[i * nx + j] * (X[N * nx + j] - goal[j]);
        Vx[i] = s;
        for (int j = 0; j < nx; ++j) Vxx[i * nx + j] = 2.0 * Qf[i * nx + j];
      }
      for (int t = N - 1; t >= 0 && ok; --t) {
        const double* xt = &X[t * nx];
        const double* ut = &U[t * nu];
        mdl.jac(xt, ut, params, Fx.data(), Fu.data());
        for (int i = 0; i < nx; ++i)
          for (int j = 0; j < nx; ++j)
            A[i * nx + j] = (i == j ? 1.0 : 0.0) + dt * Fx[i * nx + j];
        for (int i = 0; i < nx; ++i)
          for (int j = 0; j < nu; ++j) B[i * nu + j] = dt * Fu[i * nu + j];

        std::vector<double> Qx(nx), Qu(nu), Qxx(nx * nx), Qux(nu * nx),
            Quu(nu * nu);
        for (int i = 0; i < nx; ++i) {
          double s = 0.0;
          for (int j = 0; j < nx; ++j)
            s += 2.0 * Qs[i * nx + j] * (xt[j] - goal[j]);
          for (int k2 = 0; k2 < nx; ++k2) s += A[k2 * nx + i] * Vx[k2];
          Qx[i] = s;
        }
        // barrier gradient/Hessian in u (box rows only; bx/bxx/bux = 0)
        for (int i = 0; i < nu; ++i) {
          double bL, bLp, bLpp, bU, bUp, bUpp;
          beta_derivs(ut[i] - lower[i], delta, &bL, &bLp, &bLpp);
          beta_derivs(upper[i] - ut[i], delta, &bU, &bUp, &bUpp);
          double s = mu * (bLp - bUp);
          for (int j = 0; j < nu; ++j) s += 2.0 * Rs[i * nu + j] * ut[j];
          for (int k2 = 0; k2 < nx; ++k2) s += B[k2 * nu + i] * Vx[k2];
          Qu[i] = s;
          for (int j = 0; j < nu; ++j) Quu[i * nu + j] = 0.0;
          Quu[i * nu + i] = mu * (bLpp + bUpp);
        }
        std::vector<double> VA(nx * nx), VB(nx * nu);
        for (int i = 0; i < nx; ++i)
          for (int j = 0; j < nx; ++j) {
            double s = 0.0;
            for (int k2 = 0; k2 < nx; ++k2)
              s += Vxx[i * nx + k2] * A[k2 * nx + j];
            VA[i * nx + j] = s;
          }
        for (int i = 0; i < nx; ++i)
          for (int j = 0; j < nu; ++j) {
            double s = 0.0;
            for (int k2 = 0; k2 < nx; ++k2)
              s += Vxx[i * nx + k2] * B[k2 * nu + j];
            VB[i * nu + j] = s;
          }
        for (int i = 0; i < nx; ++i)
          for (int j = 0; j < nx; ++j) {
            double s = 2.0 * Qs[i * nx + j];
            for (int k2 = 0; k2 < nx; ++k2)
              s += A[k2 * nx + i] * VA[k2 * nx + j];
            Qxx[i * nx + j] = s;
          }
        for (int i = 0; i < nu; ++i)
          for (int j = 0; j < nx; ++j) {
            double s = 0.0;
            for (int k2 = 0; k2 < nx; ++k2)
              s += B[k2 * nu + i] * VA[k2 * nx + j];
            Qux[i * nx + j] = s;
          }
        for (int i = 0; i < nu; ++i)
          for (int j = 0; j < nu; ++j) {
            double s = Quu[i * nu + j] + 2.0 * Rs[i * nu + j];
            for (int k2 = 0; k2 < nx; ++k2)
              s += B[k2 * nu + i] * VB[k2 * nu + j];
            Quu[i * nu + j] = s;
          }
        std::vector<double> Quu_reg(Quu), rhs(nu * (1 + nx)), kK(nu * (1 + nx));
        for (int i = 0; i < nu; ++i)
          for (int j = 0; j < nu; ++j)
            Quu_reg[i * nu + j] =
                0.5 * (Quu[i * nu + j] + Quu[j * nu + i]) +
                (i == j ? reg : 0.0);
        for (int i = 0; i < nu; ++i) {
          rhs[i * (1 + nx) + 0] = Qu[i];
          for (int j = 0; j < nx; ++j) rhs[i * (1 + nx) + 1 + j] = Qux[i * nx + j];
        }
        if (!chol_solve(Quu_reg.data(), rhs.data(), kK.data(), nu, 1 + nx,
                        work.data())) {
          ok = false;
          break;
        }
        double* kt = &ks[t * nu];
        double* Kt = &Ks[t * nu * nx];
        for (int i = 0; i < nu; ++i) {
          kt[i] = -kK[i * (1 + nx) + 0];
          for (int j = 0; j < nx; ++j) Kt[i * nx + j] = -kK[i * (1 + nx) + 1 + j];
        }
        for (int i = 0; i < nu; ++i) dV0 += Qu[i] * kt[i];
        for (int i = 0; i < nu; ++i)
          for (int j = 0; j < nu; ++j)
            dV1 += 0.5 * kt[i] * Quu[i * nu + j] * kt[j];

        std::vector<double> Quu_k(nu, 0.0), QuuK(nu * nx, 0.0);
        for (int i = 0; i < nu; ++i)
          for (int j = 0; j < nu; ++j) Quu_k[i] += Quu[i * nu + j] * kt[j];
        for (int i = 0; i < nu; ++i)
          for (int j = 0; j < nx; ++j) {
            double s = 0.0;
            for (int k2 = 0; k2 < nu; ++k2)
              s += Quu[i * nu + k2] * Kt[k2 * nx + j];
            QuuK[i * nx + j] = s;
          }
        std::vector<double> Vx_new(nx), Vxx_new(nx * nx);
        for (int i = 0; i < nx; ++i) {
          double s = Qx[i];
          for (int k2 = 0; k2 < nu; ++k2) {
            s += Kt[k2 * nx + i] * Quu_k[k2];
            s += Qux[k2 * nx + i] * kt[k2];
            s += Kt[k2 * nx + i] * Qu[k2];
          }
          Vx_new[i] = s;
        }
        for (int i = 0; i < nx; ++i)
          for (int j = 0; j < nx; ++j) {
            double s = Qxx[i * nx + j];
            for (int k2 = 0; k2 < nu; ++k2) {
              s += Kt[k2 * nx + i] * QuuK[k2 * nx + j];
              s += Qux[k2 * nx + i] * Kt[k2 * nx + j];
              s += Qux[k2 * nx + j] * Kt[k2 * nx + i];
            }
            Vxx_new[i * nx + j] = s;
          }
        for (int i = 0; i < nx; ++i)
          for (int j = 0; j < nx; ++j)
            Vxx[i * nx + j] = 0.5 * (Vxx_new[i * nx + j] + Vxx_new[j * nx + i]);
        std::memcpy(Vx.data(), Vx_new.data(), sizeof(double) * nx);
        for (int i = 0; i < nu; ++i)
          Qu_err = std::max(Qu_err, std::fabs(Qu[i]));
      }
      if (ok) {
        bp_ok = true;
        break;
      }
      const double reg_next = std::min(reg * reg_factor, reg_max);
      if (reg_next >= reg_max) {
        reg = reg_next;
        bp_limit = true;
        break;
      }
      reg = reg_next;
    }
    inf_du = Qu_err;
    if (bp_limit) {
      status = 4;  // REGULARIZATION_LIMIT_CONVERGED (LogDDP quirk)
      break;
    }

    // ---- sequential first-success filter line search ----------------------
    bool fp_ok = false;
    double J_new = cost, merit_new = merit, cv_new = cv;
    for (double a : alphas) {
      std::memcpy(Xtry.data(), x0, sizeof(double) * nx);
      double J = 0.0;
      bool finite = true;
      for (int t = 0; t < N && finite; ++t) {
        const double* xt = &Xtry[t * nx];
        double u_t[kMaxNx];
        for (int i = 0; i < nu; ++i) {
          double du = a * ks[t * nu + i];
          for (int j = 0; j < nx; ++j)
            du += Ks[t * nu * nx + i * nx + j] * (xt[j] - X[t * nx + j]);
          u_t[i] = U[t * nu + i] + du;  // NOT clamped (logddp rollout)
          if (!std::isfinite(u_t[i])) finite = false;
        }
        J += run_cost(xt, u_t);
        mdl.f(xt, u_t, params, xdot.data());
        for (int i = 0; i < nx; ++i) {
          const double xn = xt[i] + dt * xdot[i];
          if (!std::isfinite(xn)) finite = false;
          Xtry[(t + 1) * nx + i] = xn;
        }
        std::memcpy(&Utry[t * nu], u_t, sizeof(double) * nu);
      }
      if (!finite) continue;
      J += term_cost(&Xtry[N * nx]);
      double bc_t, cv_t;
      barrier_and_violation(Utry.data(), mu, &bc_t, &cv_t);
      const double m_t = J + bc_t;

      // Filter acceptance (logddp_solver.cpp:666-698).
      const double expected_improvement = a * dV0;
      bool accept;
      if (cv_t > f_max_viol) {
        accept = cv_t < (1.0 - f_viol_acc) * cv;
      } else if (std::max(cv_t, cv) < f_min_viol_armijo &&
                 expected_improvement < 0.0) {
        accept = m_t < merit + f_armijo * expected_improvement;
      } else {
        accept = (m_t < merit - f_merit_acc * cv) ||
                 (cv_t < (1.0 - f_viol_acc) * cv);
      }
      if (accept) {
        fp_ok = true;
        J_new = J;
        merit_new = m_t;
        cv_new = cv_t;
        std::memcpy(X, Xtry.data(), sizeof(double) * (N + 1) * nx);
        std::memcpy(U, Utry.data(), sizeof(double) * N * nu);
        break;
      }
    }

    const double dJ = cost - J_new;
    const double dL = merit - merit_new;
    if (fp_ok) {
      cost = J_new;
      merit = merit_new;
      cv = cv_new;
      reg = std::max(reg / reg_factor, reg_min);
    } else {
      reg = std::min(reg * reg_factor, reg_max);
    }
    const bool fp_limit = !fp_ok && reg >= reg_max;

    // Convergence (logddp_solver.cpp:232-259): metric = max(inf_du, cv).
    const double metric = std::max(inf_du, cv);
    const bool conv_opt = fp_ok && metric <= tolerance;
    const bool conv_acc = fp_ok && std::fabs(dJ) < acceptable_tolerance &&
                          std::fabs(dL) < acceptable_tolerance;

    // Barrier update (postIterationUpdate, :264-276).
    mu = fp_ok ? std::max(mu_min, mu * mu_update_factor)
               : std::min(mu_initial, mu * 5.0);

    if (conv_opt) {
      status = 1;
      break;
    }
    if (conv_acc) {
      status = 2;
      break;
    }
    if (fp_limit) {
      status = 3;
      break;
    }
  }

  out_stats[0] = cost;
  out_stats[1] = cv;
  out_stats[2] = inf_du;
  out_stats[3] = mu;
  out_stats[4] = double(it);
  return status;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Full MSIPDDP solver engine — multiple-shooting interior-point DDP
// (msipddp_solver.cpp / cddp_tpu/solvers/msipddp.py semantics): defect-aware
// condensed backward with costates, segment gap-closing "nonlinear" rollout,
// separate dual step-size ladder, l1-defect filter violation, IPOPT
// sd-scaled dual infeasibility, ADAPTIVE barrier with the slow-progress
// rule, filter restoration before regularization. Control box only, iLQR,
// cold start. Completes the native cross-language oracle for all FOUR
// solver strategies.
// ---------------------------------------------------------------------------

extern "C" {

// Options layout (doubles):
//  [0] max_iterations [1] tolerance [2] acceptable_tolerance
//  [3] reg_init [4] reg_min [5] reg_max [6] reg_factor
//  [7] ls_max_iterations [8] ls_initial [9] ls_min [10] ls_reduction
//  [11] mu_initial [12] mu_min [13] mu_update_factor [14] mu_update_power
//  [15] min_fraction_to_boundary
//  [16] filter.merit_acceptance [17] filter.violation_acceptance
//  [18] filter.max_violation(unused) [19] filter.min_violation_for_armijo
//  [20] filter.armijo_constant
//  [21] dual_var_init_scale [22] slack_var_init_scale
//  [23] segment_length [24] costate_var_init_scale
// Writes [cost, inf_pr, inf_du, inf_comp, mu, iterations] to out_stats.
int cddp_msipddp_solve(
    int model_id, const double* params, int N, double dt,
    const double* Qs, const double* Rs, const double* Qf, const double* goal,
    const double* x0, const double* lower, const double* upper,
    const double* opts, const double* U0,
    double* X, double* U, double* out_stats) {
  using ipddp_native::Filter;
  if (!model_id_valid(model_id)) return -100;  // unknown model
  const Model mdl = make_model(model_id, dt);
  const int nx = mdl.nx, nu = mdl.nu;
  const int m = 2 * nu;

  const int max_iterations = (int)opts[0];
  const double tolerance = opts[1], acceptable_tolerance = opts[2];
  const double reg_init = opts[3], reg_min = opts[4], reg_max = opts[5],
               reg_factor = opts[6];
  const int ls_max = (int)opts[7];
  const double ls_initial = opts[8], ls_min = opts[9], ls_red = opts[10];
  const double mu_initial = opts[11], mu_update_factor = opts[13],
               mu_update_power = opts[14], min_ftb = opts[15];
  const double f_merit_acc = opts[16], f_viol_acc = opts[17],
               f_min_viol_armijo = opts[19], f_armijo = opts[20];
  const double y0_scale = opts[21], s0_scale = opts[22];
  const int seg = (int)opts[23];
  const double costate_init = opts[24];

  std::vector<double> alphas;
  {
    double a = ls_initial;
    for (int i = 0; i < std::max(1, ls_max); ++i) {
      alphas.push_back(a);
      a *= ls_red;
      if (a < ls_min && i < ls_max - 1) {
        alphas.push_back(ls_min);
        break;
      }
    }
  }

  auto eval_g = [&](const double* u, double* g) {
    for (int i = 0; i < nu; ++i) g[i] = -u[i] + lower[i];
    for (int i = 0; i < nu; ++i) g[nu + i] = u[i] - upper[i];
  };
  // Gu rows: [-I; I]; Gx = 0.
  std::vector<double> xdot(nx), Fx(nx * nx), Fu(nx * nu);
  auto run_cost = [&](const double* x, const double* u) {
    double J = 0.0;
    for (int i = 0; i < nx; ++i) {
      double e_i = x[i] - goal[i];
      for (int j = 0; j < nx; ++j) J += e_i * Qs[i * nx + j] * (x[j] - goal[j]);
    }
    for (int i = 0; i < nu; ++i)
      for (int j = 0; j < nu; ++j) J += u[i] * Rs[i * nu + j] * u[j];
    return J;
  };
  auto term_cost = [&](const double* x) {
    double J = 0.0;
    for (int i = 0; i < nx; ++i) {
      double e_i = x[i] - goal[i];
      for (int j = 0; j < nx; ++j) J += e_i * Qf[i * nx + j] * (x[j] - goal[j]);
    }
    return J;
  };

  // --- cold-start init (msipddp_solver.cpp:192-265, 644-707) --------------
  std::memcpy(U, U0, sizeof(double) * N * nu);
  std::memcpy(X, x0, sizeof(double) * nx);
  for (int t = 0; t < N; ++t) {
    mdl.f(&X[t * nx], &U[t * nu], params, xdot.data());
    for (int i = 0; i < nx; ++i)
      X[(t + 1) * nx + i] = X[t * nx + i] + dt * xdot[i];
  }
  std::vector<double> F(N * nx);
  std::memcpy(F.data(), &X[nx], sizeof(double) * N * nx);
  double mu = mu_initial;
  std::vector<double> Lambda(N * nx, costate_init);
  std::vector<double> G(N * m), S(N * m), Y(N * m);
  for (int t = 0; t < N; ++t) eval_g(&U[t * nu], &G[t * m]);
  for (int i = 0; i < N * m; ++i) {
    S[i] = std::max(s0_scale, -G[i]);
    Y[i] = std::min(std::max(mu / std::max(S[i], 1e-12), y0_scale * 0.01),
                    y0_scale * 100.0);
  }

  double cost = 0.0;
  for (int t = 0; t < N; ++t) cost += run_cost(&X[t * nx], &U[t * nu]);
  cost += term_cost(&X[N * nx]);

  // resetBarrierFilter quantities (merit, inf_pr incl defects, cv, comp).
  auto reset_quantities = [&](double mu_, double* merit, double* inf_pr,
                              double* inf_comp, double* cv) {
    *merit = cost;
    *inf_pr = 0.0;
    *inf_comp = 0.0;
    *cv = 0.0;
    double inf_defect = 0.0, cv_defect = 0.0;
    for (int i = 0; i < N * m; ++i) {
      *merit -= mu_ * std::log(S[i]);
      const double rp = G[i] + S[i];
      *inf_pr = std::max(*inf_pr, std::fabs(rp));
      *cv += std::fabs(rp);
      *inf_comp = std::max(*inf_comp, std::fabs(Y[i] * S[i] - mu_));
    }
    for (int t = 0; t < N; ++t)
      for (int i = 0; i < nx; ++i) {
        const double d = F[t * nx + i] - X[(t + 1) * nx + i];
        inf_defect = std::max(inf_defect, std::fabs(d));
        cv_defect += std::fabs(d);
      }
    *inf_pr = std::max(*inf_pr, inf_defect);
    *cv += cv_defect;
  };

  double merit, inf_pr, inf_comp, cv;
  reset_quantities(mu, &merit, &inf_pr, &inf_comp, &cv);
  Filter filt;
  filt.accept(merit, cv);

  auto sd_scale = [&](double raw_inf_du) {
    double y_l1 = 0.0, s_l1 = 0.0;
    for (int i = 0; i < N * m; ++i) {
      y_l1 += std::fabs(Y[i]);
      s_l1 += std::fabs(S[i]);
    }
    const double sd =
        std::max(100.0, (y_l1 + s_l1) / double(N * m + N * nu)) / 100.0;
    return raw_inf_du / sd;
  };

  // MSIPDDP filter acceptance (isFilterAcceptable, :789-827).
  auto filter_ok = [&](double mf, double cvn, double expected) {
    if (filt.size() == 0) return true;
    for (int i = 0; i < filt.size(); ++i)
      if (filt.mf[i] <= mf && filt.cv[i] <= cvn) return false;  // dominated
    int ibv = 0;
    for (int i = 1; i < filt.size(); ++i)
      if (filt.cv[i] < filt.cv[ibv]) ibv = i;
    const double best_violation = filt.cv[ibv];
    const double best_merit = filt.mf[ibv];
    const bool violation_improvement =
        cvn < best_violation * (1.0 - f_viol_acc);
    const bool merit_improvement = mf < best_merit - f_merit_acc * cvn;
    if (cvn < f_min_viol_armijo && expected < 0.0)
      return mf < best_merit + f_armijo * expected;
    const bool tiny_ok = (cvn < 1e-6) && (mf <= best_merit * (1.0 + 1e-8));
    return tiny_ok || violation_improvement || merit_improvement;
  };

  double reg = reg_init;
  double inf_du = 0.0, step_norm = 0.0, alpha_pr_acc = 1.0;
  int status = 0;
  int it = 0;

  std::vector<double> k_u(N * nu), K_u(N * nu * nx), k_y(N * m),
      K_y(N * m * nx), k_s(N * m), K_s(N * m * nx), k_lam(N * nx),
      K_lam(N * nx * nx);
  std::vector<double> Vx(nx), Vxx(nx * nx),
      work(std::max(nx, nu) * std::max(nx, nu));
  std::vector<double> A(nx * nx), B(nx * nu);
  std::vector<double> Xtry((N + 1) * nx), Utry(N * nu), Stry(N * m),
      Ytry(N * m), Gtry(N * m), Ftry(N * nx), Lamtry(N * nx),
      dX_real(N * nx);

  for (it = 0; it < max_iterations;) {
    ++it;
    // ---- defect-aware backward with regularization retry -----------------
    double dV0 = 0.0, dV1 = 0.0;
    double bp_inf_du = 0.0, bp_inf_pr = 0.0, bp_inf_comp = 0.0,
           bp_inf_defect = 0.0, bp_step_norm = 0.0;
    bool bp_ok = false, bp_limit = false;
    while (true) {
      bool ok = true;
      dV0 = dV1 = 0.0;
      bp_inf_du = bp_inf_pr = bp_inf_comp = bp_inf_defect = bp_step_norm = 0.0;
      for (int i = 0; i < nx; ++i) {
        double s = 0.0;
        for (int j = 0; j < nx; ++j)
          s += 2.0 * Qf[i * nx + j] * (X[N * nx + j] - goal[j]);
        Vx[i] = s;
        for (int j = 0; j < nx; ++j) Vxx[i * nx + j] = 2.0 * Qf[i * nx + j];
      }
      for (int t = N - 1; t >= 0 && ok; --t) {
        const double* xt = &X[t * nx];
        const double* ut = &U[t * nu];
        const double* gt = &G[t * m];
        const double* st = &S[t * m];
        const double* yt = &Y[t * m];
        double d[kMaxNx];
        for (int i = 0; i < nx; ++i)
          d[i] = F[t * nx + i] - X[(t + 1) * nx + i];
        mdl.jac(xt, ut, params, Fx.data(), Fu.data());
        for (int i = 0; i < nx; ++i)
          for (int j = 0; j < nx; ++j)
            A[i * nx + j] = (i == j ? 1.0 : 0.0) + dt * Fx[i * nx + j];
        for (int i = 0; i < nx; ++i)
          for (int j = 0; j < nu; ++j) B[i * nu + j] = dt * Fu[i * nu + j];

        double drift[kMaxNx];
        for (int i = 0; i < nx; ++i) {
          double s = Vx[i];
          for (int j = 0; j < nx; ++j) s += Vxx[i * nx + j] * d[j];
          drift[i] = s;
        }
        std::vector<double> Qx(nx), Qu(nu), Qxx(nx * nx), Qux(nu * nx),
            Quu(nu * nu);
        for (int i = 0; i < nx; ++i) {
          double s = 0.0;
          for (int j = 0; j < nx; ++j)
            s += 2.0 * Qs[i * nx + j] * (xt[j] - goal[j]);
          for (int k2 = 0; k2 < nx; ++k2) s += A[k2 * nx + i] * drift[k2];
          Qx[i] = s;  // Gx = 0 for the box
        }
        for (int i = 0; i < nu; ++i) {
          double s = 0.0;
          for (int j = 0; j < nu; ++j) s += 2.0 * Rs[i * nu + j] * ut[j];
          // Gu' y rows: -y[i] + y[nu+i]
          s += -yt[i] + yt[nu + i];
          for (int k2 = 0; k2 < nx; ++k2) s += B[k2 * nu + i] * drift[k2];
          Qu[i] = s;
        }
        std::vector<double> VA(nx * nx), VB(nx * nu);
        for (int i = 0; i < nx; ++i)
          for (int j = 0; j < nx; ++j) {
            double s = 0.0;
            for (int k2 = 0; k2 < nx; ++k2)
              s += Vxx[i * nx + k2] * A[k2 * nx + j];
            VA[i * nx + j] = s;
          }
        for (int i = 0; i < nx; ++i)
          for (int j = 0; j < nu; ++j) {
            double s = 0.0;
            for (int k2 = 0; k2 < nx; ++k2)
              s += Vxx[i * nx + k2] * B[k2 * nu + j];
            VB[i * nu + j] = s;
          }
        for (int i = 0; i < nx; ++i)
          for (int j = 0; j < nx; ++j) {
            double s = 2.0 * Qs[i * nx + j];
            for (int k2 = 0; k2 < nx; ++k2)
              s += A[k2 * nx + i] * VA[k2 * nx + j];
            Qxx[i * nx + j] = s;
          }
        for (int i = 0; i < nu; ++i)
          for (int j = 0; j < nx; ++j) {
            double s = 0.0;
            for (int k2 = 0; k2 < nx; ++k2)
              s += B[k2 * nu + i] * VA[k2 * nx + j];
            Qux[i * nx + j] = s;
          }
        for (int i = 0; i < nu; ++i)
          for (int j = 0; j < nu; ++j) {
            double s = 2.0 * Rs[i * nu + j];
            for (int k2 = 0; k2 < nx; ++k2)
              s += B[k2 * nu + i] * VB[k2 * nu + j];
            Quu[i * nu + j] = s;
          }

        // condensation — UNCLIPPED ratios (msipddp_solver.cpp:1330-1345)
        std::vector<double> ys_inv(m), pr_res(m), comp_res(m), rhat(m),
            s_inv_rhat(m);
        for (int r = 0; r < m; ++r) {
          ys_inv[r] = yt[r] / st[r];
          pr_res[r] = gt[r] + st[r];
          comp_res[r] = yt[r] * st[r] - mu;
          rhat[r] = yt[r] * pr_res[r] - comp_res[r];
          s_inv_rhat[r] = rhat[r] / st[r];
          bp_inf_pr = std::max(bp_inf_pr, std::fabs(pr_res[r]));
          bp_inf_comp = std::max(bp_inf_comp, std::fabs(comp_res[r]));
        }
        for (int i = 0; i < nx; ++i)
          bp_inf_defect = std::max(bp_inf_defect, std::fabs(d[i]));

        // Quu_reg = sym(Quu) + Gu' YS^-1 Gu + reg I; Gu'diag rows give
        // diagonal ys_inv[i] + ys_inv[nu+i].
        std::vector<double> Quu_reg(nu * nu), rhs(nu * (1 + nx)),
            kK(nu * (1 + nx));
        for (int i = 0; i < nu; ++i)
          for (int j = 0; j < nu; ++j)
            Quu_reg[i * nu + j] =
                0.5 * (Quu[i * nu + j] + Quu[j * nu + i]) +
                (i == j ? ys_inv[i] + ys_inv[nu + i] + reg : 0.0);
        std::vector<double> Qu_c(nu);
        for (int i = 0; i < nu; ++i) {
          Qu_c[i] = Qu[i] - s_inv_rhat[i] + s_inv_rhat[nu + i];
          rhs[i * (1 + nx) + 0] = Qu_c[i];
          for (int j = 0; j < nx; ++j)
            rhs[i * (1 + nx) + 1 + j] = Qux[i * nx + j];  // Gx = 0
        }
        if (!chol_solve(Quu_reg.data(), rhs.data(), kK.data(), nu, 1 + nx,
                        work.data())) {
          ok = false;
          break;
        }
        double* kt = &k_u[t * nu];
        double* Kt = &K_u[t * nu * nx];
        for (int i = 0; i < nu; ++i) {
          kt[i] = -kK[i * (1 + nx) + 0];
          for (int j = 0; j < nx; ++j)
            Kt[i * nx + j] = -kK[i * (1 + nx) + 1 + j];
        }
        // dual/slack gains (UNCLIPPED)
        for (int r = 0; r < m; ++r) {
          const double gu_k = (r < nu) ? -kt[r] : kt[r - nu];
          k_y[t * m + r] = (rhat[r] + yt[r] * gu_k) / st[r];
          k_s[t * m + r] = -pr_res[r] - gu_k;
          for (int j = 0; j < nx; ++j) {
            const double guK =
                (r < nu) ? -Kt[r * nx + j] : Kt[(r - nu) * nx + j];
            K_y[(t * m + r) * nx + j] = ys_inv[r] * guK;
            K_s[(t * m + r) * nx + j] = -guK;
          }
        }
        // costate gains
        for (int i = 0; i < nx; ++i) {
          k_lam[t * nx + i] = -Lambda[t * nx + i] + drift[i];
          for (int j = 0; j < nx; ++j)
            K_lam[(t * nx + i) * nx + j] =
                0.5 * (Vxx[i * nx + j] + Vxx[j * nx + i]);
        }
        // condensed expansions + value update
        std::vector<double> Qxx_c(Qxx), Quu_c(nu * nu);
        for (int i = 0; i < nu; ++i)
          for (int j = 0; j < nu; ++j)
            Quu_c[i * nu + j] =
                Quu[i * nu + j] +
                (i == j ? ys_inv[i] + ys_inv[nu + i] : 0.0);
        std::vector<double> Qx_c(Qx);  // Gx = 0
        for (int i = 0; i < nu; ++i) dV0 += kt[i] * Qu_c[i];
        for (int i = 0; i < nu; ++i)
          for (int j = 0; j < nu; ++j)
            dV1 += 0.5 * kt[i] * Quu_c[i * nu + j] * kt[j];

        std::vector<double> Quu_k(nu, 0.0), QuuK(nu * nx, 0.0);
        for (int i = 0; i < nu; ++i)
          for (int j = 0; j < nu; ++j) Quu_k[i] += Quu_c[i * nu + j] * kt[j];
        for (int i = 0; i < nu; ++i)
          for (int j = 0; j < nx; ++j) {
            double s = 0.0;
            for (int k2 = 0; k2 < nu; ++k2)
              s += Quu_c[i * nu + k2] * Kt[k2 * nx + j];
            QuuK[i * nx + j] = s;
          }
        std::vector<double> Vx_new(nx), Vxx_new(nx * nx);
        for (int i = 0; i < nx; ++i) {
          double s = Qx_c[i];
          for (int k2 = 0; k2 < nu; ++k2) {
            s += Kt[k2 * nx + i] * Qu_c[k2];
            s += Qux[k2 * nx + i] * kt[k2];
            s += Kt[k2 * nx + i] * Quu_k[k2];
          }
          Vx_new[i] = s;
        }
        for (int i = 0; i < nx; ++i)
          for (int j = 0; j < nx; ++j) {
            double s = Qxx_c[i * nx + j];
            for (int k2 = 0; k2 < nu; ++k2) {
              s += Kt[k2 * nx + i] * QuuK[k2 * nx + j];
              s += Qux[k2 * nx + i] * Kt[k2 * nx + j];
              s += Qux[k2 * nx + j] * Kt[k2 * nx + i];
            }
            Vxx_new[i * nx + j] = s;
          }
        for (int i = 0; i < nx; ++i)
          for (int j = 0; j < nx; ++j)
            Vxx[i * nx + j] = 0.5 * (Vxx_new[i * nx + j] + Vxx_new[j * nx + i]);
        std::memcpy(Vx.data(), Vx_new.data(), sizeof(double) * nx);
        for (int i = 0; i < nu; ++i) {
          bp_inf_du = std::max(bp_inf_du, std::fabs(Qu_c[i]));
          bp_step_norm = std::max(bp_step_norm, std::fabs(kt[i]));
        }
      }
      if (ok) {
        bp_ok = true;
        break;
      }
      const double reg_next = std::min(reg * reg_factor, reg_max);
      if (reg_next >= reg_max) {
        reg = reg_next;
        bp_limit = true;
        break;
      }
      reg = reg_next;
    }
    inf_pr = std::max(bp_inf_pr, bp_inf_defect);
    inf_du = bp_inf_du;
    inf_comp = bp_inf_comp;
    step_norm = bp_step_norm;
    if (bp_limit) {
      status = 3;
      break;
    }

    // ---- sequential first-success line search (nonlinear gap closing) ----
    const double tau = std::max(min_ftb, 1.0 - mu);
    bool fp_ok = false;
    double J_new = cost, merit_new = merit, cv_new = cv, inf_pr_new = inf_pr,
           inf_comp_new = inf_comp, alpha_sel = alphas[0];
    for (double a : alphas) {
      bool s_feasible = true, finite = true;
      std::memcpy(Xtry.data(), x0, sizeof(double) * nx);
      for (int t = 0; t < N && s_feasible && finite; ++t) {
        const double* xt = &Xtry[t * nx];
        double dx[kMaxNx];
        for (int i = 0; i < nx; ++i) dx[i] = xt[i] - X[t * nx + i];
        std::memcpy(&dX_real[t * nx], dx, sizeof(double) * nx);
        for (int r = 0; r < m; ++r) {
          double sn = S[t * m + r] + a * k_s[t * m + r];
          for (int j = 0; j < nx; ++j)
            sn += K_s[(t * m + r) * nx + j] * dx[j];
          if (!ipddp_native::ftb_ok(sn, S[t * m + r], tau)) {
            s_feasible = false;
            break;
          }
          Stry[t * m + r] = sn;
        }
        if (!s_feasible) break;
        double u_t[kMaxNx];
        for (int i = 0; i < nu; ++i) {
          double s = U[t * nu + i] + a * k_u[t * nu + i];
          for (int j = 0; j < nx; ++j)
            s += K_u[(t * nu + i) * nx + j] * dx[j];
          u_t[i] = s;
          if (!std::isfinite(s)) finite = false;
        }
        mdl.f(xt, u_t, params, xdot.data());
        double f_new[kMaxNx];
        for (int i = 0; i < nx; ++i) {
          f_new[i] = xt[i] + dt * xdot[i];
          if (!std::isfinite(f_new[i])) finite = false;
          Ftry[t * nx + i] = f_new[i];
        }
        const bool is_boundary = (seg > 1) && ((t + 1) % seg == 0) && (t + 1 < N);
        for (int i = 0; i < nx; ++i) {
          const double f_old = F[t * nx + i];
          const double xb_next = X[(t + 1) * nx + i];
          const double gap_x =
              xb_next + (f_new[i] - f_old) + a * (f_old - xb_next);
          Xtry[(t + 1) * nx + i] = is_boundary ? gap_x : f_new[i];
        }
        for (int i = 0; i < nx; ++i) {
          double s = Lambda[t * nx + i] + a * k_lam[t * nx + i];
          for (int j = 0; j < nx; ++j)
            s += K_lam[(t * nx + i) * nx + j] * dx[j];
          Lamtry[t * nx + i] = s;
        }
        std::memcpy(&Utry[t * nu], u_t, sizeof(double) * nu);
        eval_g(u_t, &Gtry[t * m]);
      }
      if (!s_feasible || !finite) continue;

      // Separate dual step-size ladder (first feasible alpha_y, :1618-1676).
      bool any_y = false;
      for (double ay : alphas) {
        bool feas = true;
        for (int t = 0; t < N && feas; ++t)
          for (int r = 0; r < m; ++r) {
            double yn = Y[t * m + r] + ay * k_y[t * m + r];
            for (int j = 0; j < nx; ++j)
              yn += K_y[(t * m + r) * nx + j] * dX_real[t * nx + j];
            if (!ipddp_native::ftb_ok(yn, Y[t * m + r], tau)) {
              feas = false;
              break;
            }
            Ytry[t * m + r] = yn;
          }
        if (feas) {
          any_y = true;
          break;
        }
      }
      if (!any_y) continue;

      double J = 0.0;
      for (int t = 0; t < N; ++t) J += run_cost(&Xtry[t * nx], &Utry[t * nu]);
      J += term_cost(&Xtry[N * nx]);
      double m_t = J, cv_t = 0.0, ipr_t = 0.0, ico_t = 0.0, def_t = 0.0;
      for (int i = 0; i < N * m; ++i) {
        m_t -= mu * std::log(Stry[i]);
        const double rp = Gtry[i] + Stry[i];
        cv_t += std::fabs(rp);
        ipr_t = std::max(ipr_t, std::fabs(rp));
        ico_t = std::max(ico_t, std::fabs(Ytry[i] * Stry[i] - mu));
      }
      for (int t = 0; t < N; ++t)
        for (int i = 0; i < nx; ++i) {
          const double dd = Ftry[t * nx + i] - Xtry[(t + 1) * nx + i];
          cv_t += std::fabs(dd);
          def_t = std::max(def_t, std::fabs(dd));
        }
      ipr_t = std::max(ipr_t, def_t);

      if (!filter_ok(m_t, cv_t, a * dV0)) continue;

      fp_ok = true;
      J_new = J;
      merit_new = m_t;
      cv_new = cv_t;
      inf_pr_new = ipr_t;
      inf_comp_new = ico_t;
      alpha_sel = a;
      std::memcpy(X, Xtry.data(), sizeof(double) * (N + 1) * nx);
      std::memcpy(U, Utry.data(), sizeof(double) * N * nu);
      S.swap(Stry);
      Y.swap(Ytry);
      G.swap(Gtry);
      F.swap(Ftry);
      Lambda.swap(Lamtry);
      Stry.resize(N * m);
      Ytry.resize(N * m);
      Gtry.resize(N * m);
      Ftry.resize(N * nx);
      Lamtry.resize(N * nx);
      break;
    }

    if (fp_ok) {
      const double dJ = cost - J_new;
      cost = J_new;
      merit = merit_new;
      cv = cv_new;
      inf_pr = inf_pr_new;
      inf_comp = inf_comp_new;
      alpha_pr_acc = alpha_sel;
      filt.accept(merit, cv);
      reg = std::max(reg / reg_factor, reg_min);

      // Convergence (msipddp_solver.cpp:311-364).
      const double metric =
          std::max(std::max(sd_scale(inf_du), inf_pr), inf_comp);
      if (metric <= tolerance) {
        status = 1;
        break;
      }
      const double sqrt_atol = std::sqrt(acceptable_tolerance);
      const bool acc = (std::fabs(dJ) < acceptable_tolerance && it > 10 &&
                        inf_pr < sqrt_atol && inf_comp < sqrt_atol) ||
                       (step_norm < tolerance * 10.0 && inf_pr < 1e-4);
      if (acc) {
        status = 2;
        break;
      }
    } else {
      // Filter restoration before regularization (:829-862).
      bool bad = filt.size() > 5;
      for (int i = 0; i < filt.size() && !bad; ++i)
        if (!std::isfinite(filt.mf[i]) || !std::isfinite(filt.cv[i]))
          bad = true;
      if (bad) {
        filt.prune_to_best();
      } else {
        reg = std::min(reg * reg_factor, reg_max);
        if (reg >= reg_max) {
          status = 3;
          break;
        }
      }
    }

    // ---- ADAPTIVE barrier update (updateBarrierParameters, :1766-1878) ---
    {
      const double sdu = sd_scale(inf_du);
      const double metric = std::max(std::max(sdu, inf_pr), inf_comp);
      const double threshold =
          (mu < 1e-5) ? std::max(metric * 10.0, mu * 100.0)
                      : std::max(mu_update_factor * mu, mu * 2.0);
      const bool slow_progress = fp_ok && alpha_pr_acc > 0.0 && metric < 1e-3;
      const double ratio = metric / mu;
      double factor;
      if (mu > 1e-12) {
        factor = ratio < 0.01 ? mu_update_factor * 0.1
                 : ratio < 0.1 ? mu_update_factor * 0.3
                 : ratio < 0.5 ? mu_update_factor * 0.6
                               : mu_update_factor;
      } else {
        factor = mu_update_factor;
      }
      const double linear = factor * mu;
      const double superlinear = std::pow(mu, mu_update_power);
      const double cand =
          (slow_progress && mu > tolerance)
              ? std::min(linear, superlinear)
              : std::max(tolerance / 100.0, std::min(linear, superlinear));
      const bool changed = (metric <= threshold) || slow_progress;
      if (changed) {
        mu = cand;
        reset_quantities(mu, &merit, &inf_pr, &inf_comp, &cv);
        filt.clear();
        filt.accept(merit, cv);
      }
    }
  }

  out_stats[0] = cost;
  out_stats[1] = inf_pr;
  out_stats[2] = inf_du;
  out_stats[3] = inf_comp;
  out_stats[4] = mu;
  out_stats[5] = double(it);
  return status;
}

}  // extern "C"
