// gmres_qr: GMRES's scalar decisions on the device, one warp, float64.
//
// Replaces no TPU kernel. The JAX package decides its solve loops on the
// device through XLA (ops/gmres.py:136-226: the Givens update as an
// associative scan, the exit test and the back-substitution inside the
// Arnoldi while_loop; :242-259 the restart while_loop with its monotone
// acceptance; ops/ard_implicit.py:394-420 the refinement lax.conds;
// coupling.py:113-175 implicit_inner_chunk's exits and diagnostic rows).
// This kernel takes those decisions on the card so that an implicit step,
// or a chunk of steps, is enqueued with no host read inside it: each mode
// reads the numbers the device work before it left in the state vector S
// (and, for START and ARNOLDI, the raw dot products by pointer), updates S
// and sets the bool flags F that gate the work after it (CUDA graph
// conditional nodes, csrc/cond_graph.cu; the cycle's end is chosen by the
// step count J, a SWITCH node).
//
// Contract (plain twin: kernels/device_loop.py gmres_qr_plain, the same
// modes in the same order of float64 operations): the host's rotations
// and back-substitution (ops/gmres.py _givens, _back_substitute, whose row
// sum runs one term at a time in ascending order) bit for bit, and the
// scalar glue the caller used to launch around them bit for bit: ARNOLDI
// forms h[i] = c1[i] + c2[i] from CGS2's two coefficient vectors and
// h[j+1] = sqrt(<w,w>), START beta = sqrt(<r,r>), ACCEPT RNEW =
// sqrt(<r,r>) from the raw self-dot left in RNEW; START and ARNOLDI write
// the basis vector's scale 1 / max(h, 1e-300) if h > 1e-30 else 0 (a NaN
// gives 0; ops/gmres.py inv_norm) in the basis dtype (rounded to nearest
// for float32), which the caller multiplies into V. Python's max / min
// (the first argument unless the second is strictly larger / smaller) are
// kept as written, NaN cases included. -fmad=false keeps every product
// and sum rounded on its own; no sum is reassociated (no scan, no
// back-substitution by columns).
//
// What bounds it: the latency of a chain of dependent float64 operations
// (FINISH at m = 25: 300 dependent adds, 25 subtractions and 25
// divisions; ARNOLDI at step j: 2 j rotation operations, then the new
// rotation), plus the round trips that feed the chain. The one-thread
// form took each operand from global memory through one un-restricted
// pointer, so every store could alias the next load and each link waited
// on memory. Here a block is one warp: the lanes stage what a mode reads
// (ARNOLDI: cs, sn and h = c1 + c2; FINISH: R's upper triangle, packed,
// and g) into shared memory with asynchronous copies, lane 0 runs the
// chain from shared memory and registers in the twin's order, and the
// lanes write the results back together. In FINISH the lanes also form
// the products R[i,k] y[k] of every row i < k as soon as y[k] is known (a
// product rounds by itself, so forming it early changes no bit), leaving
// lane 0 each row's adds in ascending k and the division. Each mode is a
// template instance; BEGIN, which takes the step's parameters, is a
// kernel of its own.
//
// Layout of S for restart length m (kernels/device_loop.py QrLayout mirrors
// it): R [(m+1) x m] column-major, g [m+1], cs [m], sn [m], the Arnoldi
// step's column h [m+1], the coefficients yc [m] (-y, read by
// basis_axpy), kNsc scalars, the trip counters [3 (2m+3) + 5: each cycle
// loop's Arnoldi steps, cycle ends, cycles and accepted restarts, then
// the step's] and the diagnostic rows [cap x 5].

#include <cuda_pipeline_primitives.h>

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

constexpr int kLanes = 32;
// shared memory a block may take (H100: 227 KB) and the part it gets
// without opting in
constexpr size_t kMaxSmem = 232448;
constexpr size_t kDefaultSmem = 48 * 1024;

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

// shared memory (doubles) of ARNOLDI at step j: h [j+2], cs [j], sn [j]
__host__ __device__ long long arnoldi_smem(int j) { return 3LL * j + 2; }
// of FINISH at restart length m: R's packed upper triangle, g and y
__host__ __device__ long long finish_smem(int m) {
  return static_cast<long long>(m) * (m + 1) / 2 + 2LL * m;
}

// Python's max(a, b) and min(a, b)
__device__ double py_max(double a, double b) { return b > a ? b : a; }
__device__ double py_min(double a, double b) { return b < a ? b : a; }

// ops/gmres.py inv_norm: 1 / h above 1e-30, else 0 (a NaN gives 0), into
// the basis dtype
__device__ void put_scale(void* scale, int f32, double h) {
  const double inv = h > 1e-30 ? 1.0 / py_max(h, 1e-300) : 0.0;
  if (f32)
    *static_cast<float*>(scale) = __double2float_rn(inv);
  else
    *static_cast<double*>(scale) = inv;
}

// an 8-byte asynchronous copy from global into shared memory
__device__ void stage(double* dst, const double* src) {
  __pipeline_memcpy_async(dst, src, sizeof(double));
}

__device__ void staged() {
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncwarp();
}

// the cycle loop under way: 0 the main solve's, 1 and 2 the corrections'
__device__ int copy_of(const double* s) {
  return min(max(static_cast<int>(s[COPY]), 0), kCopies - 1);
}

// solve start from the norms in BN, RN (gmres.cycles before its loop)
__device__ void init(double* s, bool* F, double tol, double ncyc) {
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

// BEGIN: the step's (or chunk's) parameters into S
__global__ void __launch_bounds__(1)
    gmres_qr_kernel(int m, double* __restrict__ S, bool* __restrict__ F,
                    Params p) {
  const Lay L(m);
  double* s = S + L.SC;
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
}

// START: the cycle's g, rotations and exit flag from <r,r>; V[0]'s scale
__device__ void start(const Lay& L, int lane, double* __restrict__ S,
                      bool* __restrict__ F, const double* __restrict__ dot,
                      void* __restrict__ scale, int f32) {
  const int m = L.m;
  double* g = S + L.G;
  for (int i = lane + 1; i <= m; i += kLanes) g[i] = 0.0;
  for (int i = lane; i < m; i += kLanes) {
    S[L.CS + i] = 1.0;
    S[L.SN + i] = 0.0;
  }
  if (lane != 0) return;
  double* s = S + L.SC;
  const double beta = sqrt(dot[0]);
  s[BETA] = beta;
  g[0] = beta;
  put_scale(scale, f32, beta);
  s[J] = 0.0;
  F[RUNNING] = !(beta / s[SAFE_B] < s[TOL]);
  S[L.cyc(copy_of(s))] += 1.0;
}

// ARNOLDI: _givens on h = [c1 + c2, sqrt(<w,w>)], the j previous
// rotations, then a new one; g, R's column j, the exit flag; V[j+1]'s scale
__device__ void arnoldi(const Lay& L, int lane, int j, double* __restrict__ S,
                        bool* __restrict__ F, const double* __restrict__ c1,
                        const double* __restrict__ c2,
                        const double* __restrict__ dot,
                        void* __restrict__ scale, int f32, double* sm) {
  const int m = L.m;
  double* h = sm;             // [j + 2]
  double* cs = h + j + 2;     // [j]
  double* sn = cs + j;        // [j]
  for (int i = lane; i < j; i += kLanes) {
    stage(cs + i, S + L.CS + i);
    stage(sn + i, S + L.SN + i);
  }
  for (int i = lane; i <= j; i += kLanes) h[i] = c1[i] + c2[i];
  staged();
  if (lane == 0) {
    double* s = S + L.SC;
    double* g = S + L.G;
    const double dd = dot[0];
    const double gj = g[j];
    const double safe_b = s[SAFE_B];
    const double tol = s[TOL];
    const int copy = copy_of(s);
    const double hn = sqrt(dd);             // h[j+1]
    put_scale(scale, f32, hn);
    double hi = h[0];                        // h[i], rotated by i - 1
    for (int i = 0; i < j; ++i) {
      const double c = cs[i], sv = sn[i], hb = h[i + 1];
      h[i] = c * hi + sv * hb;
      hi = -sv * hi + c * hb;
    }
    const double denom = sqrt(hi * hi + hn * hn);
    double cj = 1.0, sj = 0.0;
    if (denom > 1e-300) {
      cj = hi / denom;
      sj = hn / denom;
    }
    h[j] = denom;
    h[j + 1] = 0.0;
    S[L.CS + j] = cj;
    S[L.SN + j] = sj;
    const double g_next = -sj * gj;
    g[j + 1] = g_next;
    g[j] = cj * gj;
    s[J] = j + 1;
    F[RUNNING] = !(fabs(g_next) / safe_b < tol) && j + 1 < m;
    S[L.arn(copy, j)] += 1.0;
  }
  __syncwarp();
  double* R = S + L.R + static_cast<long long>(j) * (m + 1);
  for (int i = lane; i <= j + 1; i += kLanes) {
    R[i] = h[i];
    S[L.H + i] = h[i];
  }
}

// FINISH: _back_substitute of R[:n, :n] y = g[:n] (n = J), each row's sum
// in ascending order, then yc = -y
__device__ void finish(const Lay& L, int lane, double* __restrict__ S,
                       double* sm) {
  const int m = L.m;
  double* s = S + L.SC;
  const int n = static_cast<int>(s[J]);
  const int tri = n * (n + 1) / 2;
  // R[i, k] (i <= k < n) at P[k (k+1) / 2 + i]; once y[k] is known the
  // entries i < k of column k hold R[i, k] y[k]
  double* P = sm;
  double* gs = P + tri;
  double* y = gs + n;
  int k = 0, i = lane;                 // entry t = lane of the triangle
  while (i > k) i -= ++k;
  for (int t = lane; t < tri; t += kLanes) {
    stage(P + t, S + L.R + static_cast<long long>(k) * (m + 1) + i);
    i += kLanes;
    while (i > k) i -= ++k;
  }
  for (int q = lane; q < n; q += kLanes) stage(gs + q, S + L.G + q);
  staged();
  for (int r = n - 1; r >= 0; --r) {
    const int col = r * (r + 1) / 2;
    if (lane == 0) {
      double acc = 0.0;
      int at = col + r + (r + 1);      // P[(r+1)(r+2)/2 + r]
#pragma unroll 8
      for (int q = r + 1; q < n; ++q) {
        acc = acc + P[at];
        at += q + 1;
      }
      y[r] = (gs[r] - acc) / P[col + r];
    }
    __syncwarp();
    const double yr = y[r];
    for (int q = lane; q < r; q += kLanes) P[col + q] = P[col + q] * yr;
    __syncwarp();
  }
  for (int q = lane; q < n; q += kLanes) S[L.YC + q] = -y[q];
  if (lane == 0) S[L.end(copy_of(s), n)] += 1.0;
}

template <int MODE>
__global__ void __launch_bounds__(kLanes)
    gmres_qr_kernel(int j, int m, double* __restrict__ S,
                    bool* __restrict__ F, const double* __restrict__ c1,
                    const double* __restrict__ c2,
                    const double* __restrict__ dot, void* __restrict__ scale,
                    int f32) {
  extern __shared__ double sm[];
  const Lay L(m);
  const int lane = threadIdx.x;
  if constexpr (MODE == START) {
    start(L, lane, S, F, dot, scale, f32);
  } else if constexpr (MODE == ARNOLDI) {
    arnoldi(L, lane, j, S, F, c1, c2, dot, scale, f32, sm);
  } else if constexpr (MODE == FINISH) {
    finish(L, lane, S, sm);
  } else {
    // the scalar modes: lane 0 alone
    if (lane != 0) return;
    double* s = S + L.SC;
    if constexpr (MODE == HEAD) {
      init(s, F, s[TOL_MAIN], s[NCYC_MAIN]);
      F[GO] = false;
      s[COPY] = 0.0;
      S[L.head()] += 1.0;
    } else if constexpr (MODE == ACCEPT) {
      // RNEW holds the candidate residual's self-dot until here
      const double rnew = sqrt(s[RNEW]);
      s[RNEW] = rnew;
      const double res_new = rnew / s[SAFE_B];
      const bool take = res_new < s[RES] && s[J] > 0.0;
      s[RES] = isnan(res_new) ? res_new : py_min(res_new, s[RES]);
      s[K] = s[K] + 1.0;
      F[ACTIVE] = s[K] < s[NCYC] && s[RES] > s[TOL];
      F[TAKE] = take;
      if (take) S[L.take(copy_of(s))] += 1.0;
    } else if constexpr (MODE == REF_FIRST) {
      s[B64N] = py_max(s[BN], 1e-300);
      refine(s, F, s[RN]);
      S[L.first()] += 1.0;
    } else if constexpr (MODE == CORRECT) {
      init(s, F, s[TOLC], 2.0);
      s[COPY] = s[COPY] + 1.0;
      S[L.correct()] += 1.0;
    } else if constexpr (MODE == UPDATE) {
      refine(s, F, s[RN]);
      S[L.update()] += 1.0;
    } else if constexpr (MODE == TAIL) {
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
    }
  }
}

template <int MODE>
cudaError_t launch(int j, int m, double* S, bool* F, const double* c1,
                   const double* c2, const double* dot, void* scale, int f32,
                   cudaStream_t st) {
  size_t smem = 0;
  if (MODE == ARNOLDI) smem = sizeof(double) * arnoldi_smem(j);
  if (MODE == FINISH) smem = sizeof(double) * finish_smem(m);
  if (smem > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        gmres_qr_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  gmres_qr_kernel<MODE><<<1, kLanes, smem, st>>>(j, m, S, F, c1, c2, dot,
                                                 scale, f32);
  return cudaGetLastError();
}

// each mode's launch, indexed by mode (BEGIN launches on its own)
using LaunchFn = cudaError_t (*)(int, int, double*, bool*, const double*,
                                 const double*, const double*, void*, int,
                                 cudaStream_t);
constexpr LaunchFn kLaunch[] = {
    nullptr,         launch<HEAD>,      launch<START>,   launch<ARNOLDI>,
    launch<FINISH>,  launch<ACCEPT>,    launch<REF_FIRST>, launch<CORRECT>,
    launch<UPDATE>,  launch<TAIL>};
static_assert(sizeof(kLaunch) / sizeof(kLaunch[0]) == TAIL + 1,
              "a launch for every mode");

}  // namespace

// the largest restart length whose FINISH staging fits a block's shared
// memory (238)
static int max_restart() {
  static const int max_m = [] {
    int m = 1;
    while (sizeof(double) * finish_smem(m + 1) <= kMaxSmem) ++m;
    return m;
  }();
  return max_m;
}

PD_EXPORT int pd_gmres_qr_begin(int m, double* S, bool* F, double t0,
                                double T_final, double tol_main,
                                double tol_final, long long ncyc_main,
                                long long total0, long long steps_left,
                                long long cap, long long batch,
                                long long diag_every, long long out_every,
                                int device, void* stream) {
  if (m < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Params p{t0,     T_final,    tol_main,   tol_final, ncyc_main,
                 total0, steps_left, cap,        batch,     diag_every,
                 out_every};
  gmres_qr_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(m, S, F,
                                                                  p);
  return static_cast<int>(cudaGetLastError());
}

// every mode but BEGIN; c1, c2 (ARNOLDI), dot and scale (START, ARNOLDI)
// may be null otherwise; scale is a float when f32, else a double
PD_EXPORT int pd_gmres_qr(int mode, int j, int m, double* S, bool* F,
                          const double* c1, const double* c2,
                          const double* dot, void* scale, int f32,
                          int device, void* stream) {
  if (mode <= BEGIN || mode > TAIL || m < 1 || m > max_restart() ||
      j < 0 || j >= m + 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((mode == ARNOLDI && (j >= m || !c1 || !c2)) ||
      ((mode == ARNOLDI || mode == START) && (!dot || !scale)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = kLaunch[mode](j, m, S, F, c1, c2, dot, scale, f32,
                      static_cast<cudaStream_t>(stream));
  return static_cast<int>(err);
}
