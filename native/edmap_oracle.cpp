// Native fp64 oracle for the event-driven map.
//
// An independent C++ implementation of the lift -> evolve -> restrict ->
// reduce pipeline (the role Armadillo's CPU path plays for the reference:
// EventDrivenMap.cu:154-240), used to validate the JAX
// paths to 1e-10 and as a fast host-side reference for tests.  Unlike the
// lockstep vmapped JAX ensemble, realisations here run truly independently
// (and in parallel across a thread pool), which also cross-checks that the
// lockstep masking in the JAX evolve loop does not alter semantics.
//
// Deliberately dependency-free (no Armadillo/LAPACK): dense solves at
// n_spikes scale are a tiny Gaussian elimination.
//
// C ABI at the bottom; Python binds via ctypes (armadillocudalinearinterpolation/oracle.py).

#include <cmath>
#include <cstdint>
#include <cstring>
#include <random>
#include <thread>
#include <vector>

namespace {

struct Params {
  int n_neurons;
  int n_real;
  int n_spikes;
  int n_threads;        // worker threads (0 = hardware_concurrency)
  double vth, vr;
  double a1, a2, b1, b2;
  double drive;         // I
  double half_width;    // L
  double t_horizon;     // T
  double root_tol;
  int counter_max;
  double beta_mean;
  double beta_sigma;
  uint64_t seed;
};

double mexhat(const Params& p, double x) {
  const double ax = std::fabs(x);
  return p.a1 * std::exp(-p.b1 * ax) - p.a2 * std::exp(-p.b2 * ax);
}

// Ring coupling table: w[k] = dx * mexhat at index-distance k (the
// sample-then-circshift construction, EventDrivenMap.cu:111-129).
void coupling(const Params& p, std::vector<double>& w) {
  const int n = p.n_neurons;
  const double dx = 2.0 * p.half_width / n;
  w.resize(n);
  for (int k = 0; k < n; ++k) {
    const int d = std::min(k, n - k);
    w[k] = mexhat(p, d * dx) * dx;
  }
}

// Closed-form lift (LiftKernel, EventDrivenMap.cu:505-542), evaluated at the
// mirrored coordinate x_i = L - dx*i, with the mean rate beta.
void lift(const Params& p, const double* U, std::vector<double>& v,
          std::vector<double>& s) {
  const int n = p.n_neurons;
  const double dx = 2.0 * p.half_width / n;
  const double c = U[0];
  const double beta = p.beta_mean;
  v.assign(n, 0.0);
  s.assign(n, 0.0);
  for (int i = 0; i < n; ++i) {
    const double x = p.half_width - dx * i;
    double vacc = 0.0, sacc = 0.0;
    for (int m = 1; m <= p.n_spikes; ++m) {
      const double u = U[m];
      const double cu = c * u;
      double dv;
      if (x - cu > 0.0) {
        double pos = 0.0;
        for (int t = 0; t < 2; ++t) {
          const double a = t == 0 ? p.a1 : p.a2;
          const double b = t == 0 ? p.b1 : p.b2;
          const double cb = c * b;
          const double boundary = (a * beta * c) / ((beta + cb) * (1.0 + cb)) *
                                  std::exp(u * (1.0 + cb)) * std::exp(-b * cu);
          const double homog = (a * beta * c / (1.0 - beta)) *
                               std::exp(beta * u) *
                               (1.0 / (beta + cb) + 1.0 / (cb - beta)) *
                               (std::exp((x / c) * (1.0 - beta)) -
                                std::exp(u * (1.0 - beta)));
          const double partic = (a * beta * c / ((cb - beta) * (1.0 - cb))) *
                                std::exp(b * cu) *
                                (std::exp(x * (1.0 - cb) / c) -
                                 std::exp(cu * (1.0 - cb) / c));
          pos += (t == 0 ? 1.0 : -1.0) * (boundary + homog - partic);
        }
        dv = pos * std::exp(-x / c);
        vacc += dv - std::exp(-(x - cu) / c);  // reset term, :530
      } else {
        double neg = 0.0;
        for (int t = 0; t < 2; ++t) {
          const double a = t == 0 ? p.a1 : p.a2;
          const double b = t == 0 ? p.b1 : p.b2;
          const double cb = c * b;
          neg += (t == 0 ? 1.0 : -1.0) * (a * beta * c) /
                 ((beta + cb) * (1.0 + cb)) * std::exp(x * (1.0 + cb) / c) *
                 std::exp(-b * cu);
        }
        dv = neg * std::exp(-x / c);
        vacc += dv;
      }
      if (cu - x > 0.0) {
        for (int t = 0; t < 2; ++t) {
          const double a = t == 0 ? p.a1 : p.a2;
          const double b = t == 0 ? p.b1 : p.b2;
          const double cb = c * b;
          sacc += (t == 0 ? 1.0 : -1.0) * beta * a * (c / (beta + cb)) *
                  std::exp(b * (x - cu));
        }
      } else {
        for (int t = 0; t < 2; ++t) {
          const double a = t == 0 ? p.a1 : p.a2;
          const double b = t == 0 ? p.b1 : p.b2;
          const double cb = c * b;
          sacc += (t == 0 ? 1.0 : -1.0) *
                  ((2.0 * a / b) * (beta / (1.0 - (beta * beta) / (cb * cb))) *
                       std::exp(-(beta / c) * (x - cu)) -
                   beta * a * (c / (cb - beta)) * std::exp(b * (cu - x)));
        }
      }
    }
    double vi = p.drive + vacc;
    v[i] = vi < p.vth ? vi : 0.0;  // clamp, EventDrivenMap.cu:538
    s[i] = sacc;
  }
}

// Initial spike indices (EventDrivenMap.cu:361-376): spike 0 at the grid
// midpoint; spike m at the largest i with -L + dx*i < -Z[0]*Z[m].
void initial_indices(const Params& p, const double* Z, std::vector<int>& ind) {
  const int n = p.n_neurons;
  const double dx = 2.0 * p.half_width / n;
  ind.assign(p.n_spikes, n / 2);
  for (int m = 1; m < p.n_spikes; ++m) {
    const double pos = -Z[0] * Z[m];
    int i = static_cast<int>(std::ceil((pos + p.half_width) / dx)) - 1;
    if (i < 0) i = 0;
    if (i > n - 1) i = n - 1;
    // The reference scans downward FROM the previous spike's index, so
    // ind[m] <= ind[m-1] always holds (matches lift.py initial_spike_indices).
    if (i > ind[m - 1]) i = ind[m - 1];
    ind[m] = i;
  }
}

double mem_fun(const Params& p, double t, double v, double s, double beta) {
  const double emt = std::exp(-t);
  return v * emt + p.drive * (1.0 - emt) +
         s * emt / (1.0 - beta) * (std::exp((1.0 - beta) * t) - 1.0) - p.vth;
}

double mem_dfun(const Params& p, double t, double v, double s, double beta) {
  const double emt = std::exp(-t);
  const double embt = std::exp(-t * (beta - 1.0));
  return p.drive * emt - v * emt + s * emt * embt +
         (s * emt * (embt - 1.0)) / (beta - 1.0);
}

// eventTime (EventDrivenMap.cu:554-573): closed-form fire decision, Newton
// from t=0, |t| + 100*(1-decision) sentinel.
double event_time(const Params& p, double v0, double s0, double beta) {
  const double base = s0 / (p.vth - p.drive);
  const double q = std::pow(base, 1.0 / beta);  // NaN for s0<0 -> no fire
  const double rhs = p.vth * q + p.drive * (1.0 - q) -
                     (p.vth - p.drive) / (beta - 1.0) * (base - q);
  const bool decision = v0 > rhs;  // false when rhs is NaN
  double t = 0.0;
  double f = decision ? mem_fun(p, t, v0, s0, beta) : 0.0;
  int counter = 0;
  while (std::fabs(f) > p.root_tol && counter < p.counter_max) {
    t -= f / mem_dfun(p, t, v0, s0, beta);
    f = mem_fun(p, t, v0, s0, beta);
    ++counter;
  }
  return std::fabs(t) + 100.0 * (decision ? 0.0 : 1.0);
}

struct RealisationOut {
  std::vector<int> last_ind, crossed_ind;
  std::vector<double> last_t, crossed_t;
  bool accept;
};

// One realisation's event loop (EvolveKernel, EventDrivenMap.cu:575-674).
void evolve_one(const Params& p, const std::vector<double>& w,
                const std::vector<double>& v0, const std::vector<double>& s0,
                const std::vector<double>& beta, const std::vector<int>& init,
                RealisationOut& out) {
  const int n = p.n_neurons;
  const int M = p.n_spikes;
  std::vector<double> v(v0), s(s0), times(n);
  out.last_ind = init;
  out.last_t.assign(M, 0.0);
  out.crossed_ind = init;
  out.crossed_t.assign(M, 2.0 * p.t_horizon);
  std::vector<bool> crossed(M, false);
  int n_crossed = 0;
  double t = 0.0;
  while (n_crossed < M && t < 2.0 * p.t_horizon) {
    int j = 0;
    double dt = 1e300;
    for (int i = 0; i < n; ++i) {
      times[i] = event_time(p, v[i], s[i], beta[i]);
      if (times[i] < dt) { dt = times[i]; j = i; }  // lowest index on ties
    }
    const double emt = std::exp(-dt);
    for (int i = 0; i < n; ++i) {
      v[i] = v[i] * emt + p.drive * (1.0 - emt) +
             s[i] * emt / (1.0 - beta[i]) *
                 (std::exp((1.0 - beta[i]) * dt) - 1.0);
      if (i == j) v[i] = 0.0;
      const int d = i >= j ? i - j : j - i;
      s[i] = s[i] * std::exp(-beta[i] * dt) + beta[i] * w[d];
    }
    t += dt;
    // classify to nearest tracked trajectory (true argmin; SURVEY.md §7
    // documents the reference's sequential-increment quirk we do not copy)
    int m = 0;
    for (int k = 1; k < M; ++k) {
      if (std::abs(j - out.last_ind[k]) < std::abs(j - out.last_ind[m])) m = k;
    }
    if (!crossed[m]) {
      if (t > p.t_horizon) {
        out.crossed_t[m] = t;
        out.crossed_ind[m] = j;
        crossed[m] = true;
        ++n_crossed;
      } else {
        out.last_t[m] = t;
        out.last_ind[m] = j;
      }
    }
  }
  out.accept = n_crossed == M;
}

void compute_f_impl(const Params& p, const double* Z, double* f,
                    double* diag_positions, int* diag_accept) {
  const int M = p.n_spikes;
  // Gauge fixing (ZtoU, EventDrivenMap.cu:388-396).
  std::vector<double> U(M + 1);
  U[0] = Z[0];
  U[1] = 0.0;
  for (int m = 2; m <= M; ++m) U[m] = Z[m - 1];

  std::vector<double> w, v0, s0;
  coupling(p, w);
  lift(p, U.data(), v0, s0);
  std::vector<int> init;
  initial_indices(p, Z, init);

  const int R = p.n_real;
  std::vector<RealisationOut> outs(R);
  int n_threads = p.n_threads > 0
                      ? p.n_threads
                      : static_cast<int>(std::thread::hardware_concurrency());
  if (n_threads < 1) n_threads = 1;
  if (n_threads > R) n_threads = R;

  auto worker = [&](int t0, int t1) {
    std::vector<double> beta(p.n_neurons);
    for (int r = t0; r < t1; ++r) {
      // Per-realisation deterministic heterogeneity: counter-mode seeding so
      // realisation r's draw is independent of the thread partition.
      std::mt19937_64 gen(p.seed * 0x9E3779B97F4A7C15ull + r);
      std::normal_distribution<double> nd(p.beta_mean, p.beta_sigma);
      for (int i = 0; i < p.n_neurons; ++i)
        beta[i] = p.beta_sigma > 0.0 ? nd(gen) : p.beta_mean;
      evolve_one(p, w, v0, s0, beta, init, outs[r]);
    }
  };
  if (n_threads == 1) {
    worker(0, R);
  } else {
    std::vector<std::thread> pool;
    const int chunk = (R + n_threads - 1) / n_threads;
    for (int t = 0; t < n_threads; ++t) {
      const int lo = t * chunk, hi = std::min(R, lo + chunk);
      if (lo < hi) pool.emplace_back(worker, lo, hi);
    }
    for (auto& th : pool) th.join();
  }

  // Restrict + accept-masked mean (EventDrivenMap.cu:769-824, with the
  // count/mask aliasing bug fixed per SURVEY.md §7).
  const double dx = 2.0 * p.half_width / p.n_neurons;
  std::vector<double> mean(M, 0.0);
  int count = 0;
  for (int r = 0; r < R; ++r) {
    const auto& o = outs[r];
    for (int m = 0; m < M; ++m) {
      const double x0 = -p.half_width + dx * o.last_ind[m];
      const double x1 = -p.half_width + dx * o.crossed_ind[m];
      const double xT = x0 + (p.t_horizon - o.last_t[m]) * (x1 - x0) /
                                 (o.crossed_t[m] - o.last_t[m]);
      if (diag_positions) diag_positions[r * M + m] = xT;
      if (o.accept) mean[m] += xT;
    }
    if (o.accept) ++count;
    if (diag_accept) diag_accept[r] = o.accept ? 1 : 0;
  }
  for (int m = 0; m < M; ++m) {
    mean[m] /= count;  // 0/0 -> NaN, matching the division semantics
    f[m] = -U[0] * U[m + 1] - mean[m] + U[0] * p.t_horizon;
  }
}

// Dense Gaussian elimination with partial pivoting (n_spikes-scale systems).
bool solve_dense(int n, std::vector<double> A, std::vector<double> b,
                 double* x) {
  for (int k = 0; k < n; ++k) {
    int piv = k;
    for (int i = k + 1; i < n; ++i)
      if (std::fabs(A[i * n + k]) > std::fabs(A[piv * n + k])) piv = i;
    if (A[piv * n + k] == 0.0) return false;
    if (piv != k) {
      for (int j = 0; j < n; ++j) std::swap(A[k * n + j], A[piv * n + j]);
      std::swap(b[k], b[piv]);
    }
    for (int i = k + 1; i < n; ++i) {
      const double m = A[i * n + k] / A[k * n + k];
      for (int j = k; j < n; ++j) A[i * n + j] -= m * A[k * n + j];
      b[i] -= m * b[k];
    }
  }
  for (int i = n - 1; i >= 0; --i) {
    double acc = b[i];
    for (int j = i + 1; j < n; ++j) acc -= A[i * n + j] * x[j];
    x[i] = acc / A[i * n + i];
  }
  return true;
}

}  // namespace

extern "C" {

// Single residual evaluation.  diag_positions ((n_real, n_spikes) row-major)
// and diag_accept (n_real) may be null.
void edmap_compute_f(const Params* p, const double* Z, double* f,
                     double* diag_positions, int* diag_accept) {
  compute_f_impl(*p, Z, f, diag_positions, diag_accept);
}

// Damped Newton with forward-difference Jacobian (NewtonSolver.cpp:40-197
// semantics).  Returns iterations used; *converged set to 0/1;
// residual_history has space for max_iterations+1 entries (NaN padded).
int edmap_newton_solve(const Params* p, const double* z0, double tol,
                       int max_iterations, double fd_eps, double damping,
                       double* z_out, double* residual_history,
                       int* converged, double* jacobian_out) {
  const int n = p->n_spikes;
  std::vector<double> z(z0, z0 + n), fvec(n), df(n), zp(n);
  // identity, not zeros, when the solve converges at entry (0 iterations
  // never fill jac): mirrors the JAX NewtonResult contract (newton.py) —
  // a zero matrix fed to stability analysis would silently classify the
  // point as having all-zero eigenvalues
  std::vector<double> jac(n * n, 0.0), step(n);
  for (int d = 0; d < n; ++d) jac[d * n + d] = 1.0;
  for (int i = 0; i <= max_iterations; ++i)
    residual_history[i] = std::nan("");

  compute_f_impl(*p, z.data(), fvec.data(), nullptr, nullptr);
  auto norm = [&](const std::vector<double>& v) {
    double acc = 0.0;
    for (double x : v) acc += x * x;
    return std::sqrt(acc);
  };
  double rn = norm(fvec);
  residual_history[0] = rn;
  int it = 0;
  bool ok = rn <= tol;
  while (it < max_iterations && !ok) {
    for (int c = 0; c < n; ++c) {
      zp = z;
      zp[c] += fd_eps;
      compute_f_impl(*p, zp.data(), df.data(), nullptr, nullptr);
      for (int r = 0; r < n; ++r) jac[r * n + c] = (df[r] - fvec[r]) / fd_eps;
    }
    std::vector<double> rhs(n);
    for (int r = 0; r < n; ++r) rhs[r] = -fvec[r];
    if (!solve_dense(n, jac, rhs, step.data())) break;
    for (int r = 0; r < n; ++r) z[r] += damping * step[r];
    compute_f_impl(*p, z.data(), fvec.data(), nullptr, nullptr);
    rn = norm(fvec);
    ++it;
    residual_history[it] = rn;
    ok = rn <= tol;
  }
  std::memcpy(z_out, z.data(), n * sizeof(double));
  if (jacobian_out) std::memcpy(jacobian_out, jac.data(), n * n * sizeof(double));
  *converged = ok ? 1 : 0;
  return it;
}

}  // extern "C"
