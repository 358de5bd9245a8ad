// gmres_qr: GMRES's scalar decisions on the device, one thread, float64.
//
// Replaces no TPU kernel. The JAX package decides its solve loops on the
// device through XLA (ops/gmres.py:136-226: the Givens update as an
// associative scan, the exit test and the back-substitution inside the
// Arnoldi while_loop; :242-259 the restart while_loop with its monotone
// acceptance; ops/ard_implicit.py:394-420 the refinement lax.conds;
// coupling.py:113-175 implicit_inner_chunk's exits and diagnostic rows).
// This kernel takes those decisions on the card so that an implicit step,
// or a chunk of steps, is enqueued with no host read inside it: each mode
// reads the numbers the device work before it left in the state vector S,
// updates S and sets the bool flags F that gate the work after it (CUDA
// graph conditional nodes, csrc/cond_graph.cu; the cycle's end is chosen by
// the step count J, a SWITCH node).
//
// Contract (plain twin: kernels/device_loop.py gmres_qr_plain, the same
// modes in the same order of float64 operations): the host's rotations
// and back-substitution (ops/gmres.py _givens, _back_substitute, whose row
// sum runs one term at a time in ascending order) bit for bit. Python's
// max / min (the first argument unless the second is strictly larger /
// smaller) are kept as written, NaN cases included. -fmad=false keeps
// every product and sum rounded on its own.
//
// What bounds it: latency. A mode is a chain of at most a few thousand
// dependent float64 operations (the back-substitution of m = 50 is 1,275
// products) on one thread, a few microseconds; the alternative it removes
// is a stream sync and a host round trip per Arnoldi step. One thread is
// right for dependent scalar work: a warp would idle 31 lanes and add
// shuffles.
//
// Layout of S for restart length m (kernels/device_loop.py QrLayout mirrors
// it): R [(m+1) x m] column-major, g [m+1], cs [m], sn [m], the Arnoldi
// step's column h [m+1], the coefficients yc [m] (-y, read by
// basis_axpy), kNsc scalars, the trip counters [3 (2m+3) + 5: each cycle
// loop's Arnoldi steps, cycle ends, cycles and accepted restarts, then
// the step's] and the diagnostic rows [cap x 5].

#include "common.cuh"

namespace {

// scalars (offsets from SC); kernels/device_loop.py SCALARS lists them in
// this order
enum Sc {
  J, K, NCYC, TOL, SAFE_B, RES, BETA, RNEW, BN, RN, B64N, REFRES, TOLC,
  DT, NBELOW, LOSS, SOLID, VMAX, CMAX, T, KK, DISSOLVED, MAXRES, NROWS,
  RESSTEP, TOL_MAIN, TOL_FINAL, NCYC_MAIN, T_FINAL, TOTAL0, STEPS_LEFT,
  CAP, BATCH, DIAG_EVERY, OUT_EVERY, COPY, kNsc
};
// restart-cycle loops a step holds: the main solve's and the two
// refinement corrections'; each counts its own trips
constexpr int kCopies = 3;
// flags
enum Fl { ACTIVE, RUNNING, TAKE, GO, STEP };
// modes
enum Mode {
  BEGIN, HEAD, START, ARNOLDI, FINISH, ACCEPT, REF_FIRST, CORRECT, UPDATE,
  TAIL
};

struct Params {
  double t0, T_final, tol_main, tol_final;
  long long ncyc_main, total0, steps_left, cap, batch, diag_every,
      out_every;
};

struct Lay {
  long long R, G, CS, SN, H, YC, SC, TRIPS, ROWS;
  int m;
  __device__ explicit Lay(int m_) : m(m_) {
    R = 0;
    G = R + static_cast<long long>(m + 1) * m;
    CS = G + m + 1;
    SN = CS + m;
    H = SN + m;
    YC = H + m + 1;
    SC = YC + m;
    TRIPS = SC + kNsc;
    ROWS = TRIPS + kCopies * (2 * m + 3) + 5;
  }
  // trip counters of cycle loop c: Arnoldi step j, cycle end after j
  // steps, cycles, accepted restarts; then the step's
  __device__ long long loop(int c) const {
    return TRIPS + static_cast<long long>(c) * (2 * m + 3);
  }
  __device__ long long arn(int c, int j) const { return loop(c) + j; }
  __device__ long long end(int c, int j) const { return loop(c) + m + j; }
  __device__ long long cyc(int c) const { return loop(c) + 2 * m + 1; }
  __device__ long long take(int c) const { return loop(c) + 2 * m + 2; }
  __device__ long long head() const { return loop(kCopies); }
  __device__ long long first() const { return loop(kCopies) + 1; }
  __device__ long long correct() const { return loop(kCopies) + 2; }
  __device__ long long update() const { return loop(kCopies) + 3; }
  __device__ long long tail() const { return loop(kCopies) + 4; }
};

// Python's max(a, b) and min(a, b)
__device__ double py_max(double a, double b) { return b > a ? b : a; }
__device__ double py_min(double a, double b) { return b < a ? b : a; }

// solve start from the norms in BN, RN (gmres.cycles before its loop)
__device__ void init(const Lay& L, double* S, bool* F, double tol,
                     double ncyc) {
  double* s = S + L.SC;
  s[SAFE_B] = py_max(s[BN], 1e-300);
  s[RES] = s[RN] / s[SAFE_B];
  s[K] = 0.0;
  s[NCYC] = ncyc;
  s[TOL] = tol;
  F[ACTIVE] = (0.0 < ncyc) && (s[RES] > tol);
}

// a refinement residual rn: its relative value, the pass flag, tol_c
__device__ void refine(double* s, bool* F, double rn) {
  s[REFRES] = rn / s[B64N];
  const bool go = s[REFRES] > s[TOL_FINAL];
  F[GO] = go;
  if (go)
    s[TOLC] = py_min(py_max(0.5 * s[TOL_FINAL] / py_max(s[REFRES], 1e-300),
                            1e-4), 0.5);
}

__global__ void gmres_qr_kernel(int mode, int j, int m, double* S, bool* F,
                                Params p) {
  const Lay L(m);
  double* s = S + L.SC;
  // the cycle loop under way: 0 the main solve's, 1 and 2 the corrections'
  const int copy = min(max(static_cast<int>(s[COPY]), 0), kCopies - 1);
  double* R = S + L.R;
  double* g = S + L.G;
  double* cs = S + L.CS;
  double* sn = S + L.SN;
  double* h = S + L.H;
  switch (mode) {
    case BEGIN:
      s[T] = p.t0;
      s[KK] = 0.0;
      s[DISSOLVED] = 0.0;
      s[MAXRES] = 0.0;
      s[NROWS] = 0.0;
      s[TOL_MAIN] = p.tol_main;
      s[TOL_FINAL] = p.tol_final;
      s[NCYC_MAIN] = static_cast<double>(p.ncyc_main);
      s[T_FINAL] = p.T_final;
      s[TOTAL0] = static_cast<double>(p.total0);
      s[STEPS_LEFT] = static_cast<double>(p.steps_left);
      s[CAP] = static_cast<double>(p.cap);
      s[BATCH] = static_cast<double>(p.batch);
      s[DIAG_EVERY] = static_cast<double>(p.diag_every);
      s[OUT_EVERY] = static_cast<double>(p.out_every);
      F[STEP] = p.steps_left > 0 && p.cap > 0 && p.t0 < p.T_final;
      F[ACTIVE] = F[RUNNING] = F[TAKE] = F[GO] = false;
      break;
    case HEAD:
      init(L, S, F, s[TOL_MAIN], s[NCYC_MAIN]);
      F[GO] = false;
      s[COPY] = 0.0;
      S[L.head()] += 1.0;
      break;
    case START: {
      const double beta = s[BETA];
      for (int i = 0; i <= m; ++i) g[i] = 0.0;
      g[0] = beta;
      for (int i = 0; i < m; ++i) {
        cs[i] = 1.0;
        sn[i] = 0.0;
      }
      s[J] = 0.0;
      F[RUNNING] = !(beta / s[SAFE_B] < s[TOL]);
      S[L.cyc(copy)] += 1.0;
      break;
    }
    case ARNOLDI: {
      // _givens: the j previous rotations, then a new one
      for (int i = 0; i < j; ++i) {
        const double t = cs[i] * h[i] + sn[i] * h[i + 1];
        h[i + 1] = -sn[i] * h[i] + cs[i] * h[i + 1];
        h[i] = t;
      }
      const double denom = sqrt(h[j] * h[j] + h[j + 1] * h[j + 1]);
      double cj = 1.0, sj = 0.0;
      if (denom > 1e-300) {
        cj = h[j] / denom;
        sj = h[j + 1] / denom;
      }
      h[j] = denom;
      h[j + 1] = 0.0;
      for (int i = 0; i <= j + 1; ++i) R[static_cast<long long>(j) * (m + 1) + i] = h[i];
      cs[j] = cj;
      sn[j] = sj;
      const double g_next = -sj * g[j];
      g[j + 1] = g_next;
      g[j] = cj * g[j];
      s[J] = j + 1;
      F[RUNNING] = !(fabs(g_next) / s[SAFE_B] < s[TOL]) && j + 1 < m;
      S[L.arn(copy, j)] += 1.0;
      break;
    }
    case FINISH: {
      const int n = static_cast<int>(s[J]);
      double* y = S + L.YC;
      // _back_substitute, each row's sum in ascending order, then -y
      for (int i = n - 1; i >= 0; --i) {
        double acc = 0.0;
        for (int k = i + 1; k < n; ++k)
          acc = acc + R[static_cast<long long>(k) * (m + 1) + i] * y[k];
        y[i] = (g[i] - acc) / R[static_cast<long long>(i) * (m + 1) + i];
      }
      for (int i = 0; i < n; ++i) y[i] = -y[i];
      S[L.end(copy, n)] += 1.0;
      break;
    }
    case ACCEPT: {
      const double res_new = s[RNEW] / s[SAFE_B];
      const bool take = res_new < s[RES] && s[J] > 0.0;
      s[RES] = isnan(res_new) ? res_new : py_min(res_new, s[RES]);
      s[K] = s[K] + 1.0;
      F[ACTIVE] = s[K] < s[NCYC] && s[RES] > s[TOL];
      F[TAKE] = take;
      if (take) S[L.take(copy)] += 1.0;
      break;
    }
    case REF_FIRST:
      s[B64N] = py_max(s[BN], 1e-300);
      refine(s, F, s[RN]);
      S[L.first()] += 1.0;
      break;
    case CORRECT:
      init(L, S, F, s[TOLC], 2.0);
      s[COPY] = s[COPY] + 1.0;
      S[L.correct()] += 1.0;
      break;
    case UPDATE:
      refine(s, F, s[RN]);
      S[L.update()] += 1.0;
      break;
    case TAIL: {
      // j: whether the step refined (its residual is the refinement's)
      const double res = j ? s[REFRES] : s[RES];
      s[RESSTEP] = res;
      s[T] = s[T] + s[DT];
      const double kk = s[KK] + 1.0;
      s[KK] = kk;
      const bool dissolved = s[NBELOW] >= s[BATCH];
      s[DISSOLVED] = dissolved ? 1.0 : 0.0;
      const double mr = s[MAXRES];
      s[MAXRES] = (isnan(mr) || isnan(res)) ? NAN : (res > mr ? res : mr);
      const long long step =
          static_cast<long long>(s[TOTAL0]) + static_cast<long long>(kk);
      if (step % static_cast<long long>(s[DIAG_EVERY]) == 0) {
        double* row = S + L.ROWS + 5 * static_cast<long long>(s[NROWS]);
        row[0] = s[T];
        row[1] = s[LOSS];
        row[2] = s[SOLID];
        row[3] = s[VMAX];
        row[4] = s[CMAX];
        s[NROWS] = s[NROWS] + 1.0;
      }
      F[STEP] = kk < s[STEPS_LEFT] && kk < s[CAP] && s[T] < s[T_FINAL] &&
                !dissolved &&
                step % static_cast<long long>(s[OUT_EVERY]) != 0;
      F[GO] = false;
      S[L.tail()] += 1.0;
      break;
    }
  }
}

}  // namespace

PD_EXPORT int pd_gmres_qr(int mode, int j, int m, double* S, bool* F,
                          double t0, double T_final, double tol_main,
                          double tol_final, long long ncyc_main,
                          long long total0, long long steps_left,
                          long long cap, long long batch,
                          long long diag_every, long long out_every,
                          int device, void* stream) {
  if (mode < BEGIN || mode > TAIL || m < 1 || j < 0 || j >= m + 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Params p{t0,     T_final,    tol_main,   tol_final, ncyc_main,
                 total0, steps_left, cap,        batch,     diag_every,
                 out_every};
  gmres_qr_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      mode, j, m, S, F, p);
  return static_cast<int>(cudaGetLastError());
}
