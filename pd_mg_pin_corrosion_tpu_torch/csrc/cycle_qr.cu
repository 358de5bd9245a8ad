// cycle_qr: the fused coupling cycles' decisions on the device, one thread,
// float64.
//
// Replaces no TPU kernel. The JAX package runs whole coupling cycles as one
// device program (coupling.py:184-433, coupled_cycles_chunk): a
// lax.while_loop over micro-ops chosen by a lax.switch on the phase
// (CYCLE_START: a flow segment of up to 2000 iterations and, once the solve
// is done, the operator's assembly; INNER: a window of implicit steps;
// PHASE_CHANGE), whose exits are launch budgets, the output and flow
// snapshot cadences and a cycle cap, with the flow segment's own
// while_loop (solvers.py:60-150). This kernel takes those decisions on the
// card, so that a launch of such cycles is enqueued with no host read
// inside it: each mode reads the numbers the device work before it left in
// the state vector Y (and, around the implicit steps, gmres_qr's state S),
// updates Y and sets the bool flags CF that gate the work after it (CUDA
// graph conditional nodes, csrc/cond_graph.cu; the phase and the flow
// block's kind are SWITCH values).
//
// Contract (plain twin: kernels/cycle_loop.py cycle_qr_plain, the same
// modes in the same order): every quantity is a whole number or a copy,
// held in float64 (exact below 2^53), so the twin's Python floats give the
// same bits. The mode order and the meaning of each number are JAX
// coupled_cycles_chunk's:
//   BEGIN        the launch's parameters (run constants, the carried phase,
//                inner_k, need_flow, time and flow-segment position) and
//                the loop flag;
//   CYC_START    a cycle start: whether a flow segment runs and, if so, its
//                first iteration, eps, budget and last iteration (JAX
//                :262-278: a fresh solve starts at 1 with eps 1; the
//                run's first solve takes flow_cap_init, a re-solve
//                flow_cap; a segment ends at it0 + 1999 or the budget. The
//                JAX segment also stops at flow_max_iters, so a re-solve
//                cap above it never ends there; the port's host loop runs
//                the cap, and so does this);
//   FLOW_NEXT    the next block of the segment: a check iteration
//                (iterations 1-10 and every 100th), or the largest power of
//                two, at most 64, of plain iterations that ends before the
//                next check and the segment's end (solvers.py:94);
//   FLOW_CHECK   a check iteration's decisions from its numbers (eps, the
//                eps < tol and divergence flags, in the run dtype):
//                converged past iteration 100, diverged, the break (the
//                pre-step buffers are kept), the dt refresh every 200th;
//   FLOW_END     the segment's end: the iterations run, whether the solve
//                is done (converged, diverged or its budget spent), the
//                solve's record and the flow-snapshot exit (JAX
//                :278-316);
//   ASM_END      the operator is assembled: the inner window is next; a
//                packed operator that outgrew its buffers exits the launch;
//   INNER_START  an inner window's start, written into gmres_qr's state
//                (t, the global step count before it, the steps left in
//                the cycle and in the launch's budget) with its step flag;
//   INNER_END    its end, from gmres_qr's t, step count and dissolution
//                flag: the phase change is next on a dissolution, the
//                cycle's step budget or T_final; the output exit (JAX
//                :330-369);
//   PC_END       the phase change's count: the cycle's end (JAX :371-380);
//   OUTER        the loop flag: more & budget & !exits (JAX :382-397).
// Each mode adds one to the trip counter of the body it ends or chooses, so
// the host counts what a graph ran from the counters at its one read.
//
// What bounds it: a launch's latency; each mode is a few dozen dependent
// float64 operations on one thread.
//
// Layout of Y (kernels/cycle_loop.py CycleLayout mirrors it): kNsc scalars,
// kNtrip trip counters, then per-launch records: the implicit steps of each
// cycle [NREC] and each flow solve's (iterations, eps, converged,
// diverged) [NREC x 4].

#include "common.cuh"

namespace {

// scalars; kernels/cycle_loop.py SCALARS lists them in this order. The
// first kParams are BEGIN's parameters.
enum Sc {
  T_FINAL, MAX_CYCLES, MAX_INNER, FLOW_CAP, FLOW_CAP_INIT, STEP_CAP,
  FLOW_ITER_CAP, OUT_EVERY, FLOW_STRIDE, FLOW_SOLVES0, CYCLE_CAP, TOTAL0,
  NREC, T, PHASE, INNER_K, NEED_FLOW, F_IT, F_EPS, F_DT,
  CYCLES, STEPS, DISSOLVED, FLOW_ITERS, FLOW_SOLVES, EPS_LAST, DIVERGED,
  ANY_SOLID, EXIT_OUTPUT, EXIT_FLOW, EXIT_PACK, MICRO_OPS,
  IT, IT0, LIM, CAP_TOTAL, EPS, CONV, DIV, KIND,
  CHK_EPS, CHK_VMAX, CHK_RMIN, CHK_RMAX, CHK_OK, CHK_DIV, N_DISS, N_SOLID,
  OVERFLOW, kNsc
};
constexpr int kParams = F_DT + 1;
// trip counters (kernels/cycle_loop.py TRIPS)
enum Trip {
  TR_PASS, TR_START, TR_FLOW, TR_FLOWPASS, TR_CHECK, TR_B64, TR_B32, TR_B16,
  TR_B8, TR_B4, TR_B2, TR_B1, TR_FIN, TR_ASM, TR_INNER, TR_PC, kNtrip
};
// flags
enum Fl { MORE, FLOW, FRESH, FLOW_GO, BRK, REFRESH, FIN, ASM, kNflag };
enum Mode {
  BEGIN, CYC_START, FLOW_NEXT, FLOW_CHECK, FLOW_END, ASM_END, INNER_START,
  INNER_END, PC_END, OUTER, kNmode
};
enum Phase { PH_START = 0, PH_INNER = 1, PH_PC = 2 };
// gmres_qr's scalars (offsets from its SC, csrc/gmres_qr.cu Sc) and flag
// this kernel reads or writes
enum GSc {
  G_T = 19, G_KK = 20, G_DISSOLVED = 21, G_T_FINAL = 28, G_TOTAL0 = 29,
  G_STEPS_LEFT = 30, G_CAP = 31
};
constexpr int G_STEP = 4;
// flow iterations a segment runs at most (JAX solvers.py FLOW_SEGMENT_ITERS)
constexpr long long kSeg = 2000;
// the largest block of plain flow iterations
constexpr long long kBlock = 64;

struct Params {
  double p[kParams];
};

__device__ long long ll(double v) { return static_cast<long long>(v); }

// JAX coupled_cycles_chunk's loop condition
__device__ bool more(const double* y) {
  const double cap =
      y[CYCLE_CAP] < y[MAX_CYCLES] ? y[CYCLE_CAP] : y[MAX_CYCLES];
  return y[CYCLES] < cap && y[ANY_SOLID] != 0.0 && y[DIVERGED] == 0.0 &&
         (y[T] < y[T_FINAL] || y[PHASE] != PH_START) &&
         y[STEPS] < y[STEP_CAP] && y[FLOW_ITERS] < y[FLOW_ITER_CAP] &&
         y[EXIT_OUTPUT] == 0.0 && y[EXIT_FLOW] == 0.0 &&
         y[EXIT_PACK] == 0.0;
}

__global__ void __launch_bounds__(1)
    cycle_qr_kernel(int mode, double* __restrict__ Y, bool* __restrict__ CF,
                    double* __restrict__ S, bool* __restrict__ F,
                    long long sc, Params prm) {
  double* y = Y;
  double* tr = Y + kNsc;
  double* rec_steps = tr + kNtrip;
  const long long nrec = ll(y[NREC]);
  double* rec_flow = rec_steps + nrec;
  double* g = S + sc;
  switch (mode) {
    case BEGIN: {
      for (int i = 0; i < kParams; ++i) y[i] = prm.p[i];
      for (int i = CYCLES; i < kNsc; ++i) y[i] = 0.0;
      y[ANY_SOLID] = 1.0;
      for (int i = 0; i < kNflag; ++i) CF[i] = false;
      CF[MORE] = more(y);
      break;
    }
    case CYC_START: {
      const bool nf = y[NEED_FLOW] != 0.0;
      CF[FLOW] = nf;
      CF[ASM] = !nf;
      CF[FIN] = false;
      if (nf) {
        const bool fresh = y[F_IT] == 0.0;
        CF[FRESH] = fresh;
        const long long it0 = fresh ? 1 : ll(y[F_IT]);
        y[EPS] = fresh ? 1.0 : y[F_EPS];
        const bool initial = y[FLOW_SOLVES0] + y[FLOW_SOLVES] == 0.0;
        const long long cap = ll(initial ? y[FLOW_CAP_INIT] : y[FLOW_CAP]);
        const long long lim = min(it0 + kSeg - 1, cap);
        y[IT0] = static_cast<double>(it0);
        y[IT] = static_cast<double>(it0);
        y[CAP_TOTAL] = static_cast<double>(cap);
        y[LIM] = static_cast<double>(lim);
        y[CONV] = 0.0;
        y[DIV] = 0.0;
        CF[FLOW_GO] = it0 <= lim;
      }
      tr[TR_START] += 1.0;
      break;
    }
    case FLOW_NEXT: {
      const long long it = ll(y[IT]);
      int kind = 0;
      if (!(it <= 10 || it % 100 == 0)) {
        const long long end = min((it / 100 + 1) * 100 - 1, ll(y[LIM]));
        long long n = end - it + 1;
        if (n > kBlock) n = kBlock;
        long long b = kBlock;
        kind = 1;
        while (b > n) {
          b >>= 1;
          ++kind;
        }
        y[IT] = static_cast<double>(it + b);
        CF[FLOW_GO] = it + b <= ll(y[LIM]);
      }
      y[KIND] = kind;
      tr[TR_FLOWPASS] += 1.0;
      tr[TR_CHECK + kind] += 1.0;
      break;
    }
    case FLOW_CHECK: {
      const long long it = ll(y[IT]);
      const bool conv = y[CHK_OK] != 0.0 && it > 100;
      const bool div = y[CHK_DIV] != 0.0;
      const bool brk = conv || div;
      y[EPS] = y[CHK_EPS];
      y[CONV] = conv ? 1.0 : 0.0;
      y[DIV] = div ? 1.0 : 0.0;
      CF[BRK] = brk;
      CF[REFRESH] = !brk && it % 200 == 0;
      y[IT] = static_cast<double>(it + 1);
      CF[FLOW_GO] = !brk && it + 1 <= ll(y[LIM]);
      break;
    }
    case FLOW_END: {
      const long long it = ll(y[IT]);
      const bool conv = y[CONV] != 0.0, div = y[DIV] != 0.0;
      const bool done = conv || div || it > ll(y[CAP_TOTAL]);
      y[FLOW_ITERS] += static_cast<double>(it - ll(y[IT0]));
      y[F_EPS] = y[EPS];
      if (done) {
        const long long k = ll(y[FLOW_SOLVES]);
        if (k < nrec) {
          double* r = rec_flow + 4 * k;
          r[0] = static_cast<double>((conv || div) ? it - 1 : it);
          r[1] = y[EPS];
          r[2] = conv ? 1.0 : 0.0;
          r[3] = div ? 1.0 : 0.0;
        }
        y[FLOW_SOLVES] = static_cast<double>(k + 1);
        const long long gcount = ll(y[FLOW_SOLVES0]) + k + 1;
        y[EXIT_FLOW] = (gcount - 1) % ll(y[FLOW_STRIDE]) == 0 ? 1.0 : 0.0;
        y[EPS_LAST] = y[EPS];
        if (div) y[DIVERGED] = 1.0;
        y[F_IT] = 0.0;
        y[NEED_FLOW] = 0.0;
        tr[TR_FIN] += 1.0;
      } else {
        y[F_IT] = static_cast<double>(it);
      }
      CF[FIN] = done;
      CF[ASM] = done;
      tr[TR_FLOW] += 1.0;
      break;
    }
    case ASM_END: {
      y[PHASE] = PH_INNER;
      y[INNER_K] = 0.0;
      y[NEED_FLOW] = 0.0;
      y[EXIT_PACK] = y[OVERFLOW] != 0.0 ? 1.0 : 0.0;
      tr[TR_ASM] += 1.0;
      break;
    }
    case INNER_START: {
      const double left = y[MAX_INNER] - y[INNER_K];
      const double cap = y[STEP_CAP] - y[STEPS];
      g[G_T] = y[T];
      g[G_KK] = 0.0;
      g[G_DISSOLVED] = 0.0;
      g[G_TOTAL0] = y[TOTAL0] + y[STEPS];
      g[G_STEPS_LEFT] = left;
      g[G_CAP] = cap;
      F[G_STEP] = left > 0.0 && cap > 0.0 && y[T] < g[G_T_FINAL];
      break;
    }
    case INNER_END: {
      const double kk = g[G_KK];
      y[T] = g[G_T];
      y[STEPS] += kk;
      y[INNER_K] += kk;
      const long long gstep = ll(y[TOTAL0]) + ll(y[STEPS]);
      const bool done = g[G_DISSOLVED] != 0.0 || y[INNER_K] >= y[MAX_INNER] ||
                        y[T] >= y[T_FINAL];
      y[PHASE] = done ? PH_PC : PH_INNER;
      y[EXIT_OUTPUT] = kk > 0.0 && gstep % ll(y[OUT_EVERY]) == 0 ? 1.0 : 0.0;
      tr[TR_INNER] += 1.0;
      break;
    }
    case PC_END: {
      const long long c = ll(y[CYCLES]);
      if (c < nrec) rec_steps[c] = y[INNER_K];
      y[CYCLES] = static_cast<double>(c + 1);
      y[DISSOLVED] += y[N_DISS];
      y[NEED_FLOW] = y[N_DISS] > 0.0 ? 1.0 : 0.0;
      y[ANY_SOLID] = y[N_SOLID] > 0.0 ? 1.0 : 0.0;
      y[PHASE] = PH_START;
      tr[TR_PC] += 1.0;
      break;
    }
    case OUTER: {
      y[MICRO_OPS] += 1.0;
      CF[MORE] = more(y);
      tr[TR_PASS] += 1.0;
      break;
    }
    default:
      break;
  }
}

}  // namespace

// p: BEGIN's kParams parameters (host memory; ignored by the other modes);
// sc: the offset of gmres_qr's scalars in S
PD_EXPORT int pd_cycle_qr(int mode, double* Y, bool* CF, double* S, bool* F,
                          long long sc, const double* p, int n_params,
                          int device, void* stream) {
  if (mode < BEGIN || mode >= kNmode || !Y || !CF || !S || !F || sc < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Params prm{};
  if (mode == BEGIN) {
    if (!p || n_params != kParams)
      return static_cast<int>(cudaErrorInvalidValue);
    for (int i = 0; i < kParams; ++i) prm.p[i] = p[i];
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cycle_qr_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      mode, Y, CF, S, F, sc, prm);
  return static_cast<int>(cudaGetLastError());
}

// the layout's sizes, for the wrapper to check its mirror against
PD_EXPORT void pd_cycle_qr_layout(int* out) {
  out[0] = kNsc;
  out[1] = kNtrip;
  out[2] = kNflag;
  out[3] = kParams;
  out[4] = kNmode;
}
