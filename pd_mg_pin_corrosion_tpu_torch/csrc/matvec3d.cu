// matvec3d: y = diag*x + sum_s W_s * shift_s(x) on unknown rows, 0 elsewhere
// (f32 x, W in f32 or bf16), and slots3d_f64: the float64 slot sum
// sum_s W_s * shift_s(x) (f32 W, f64 x), both on the 3D grid.
//
// Replaces: pd_mg_pin_corrosion_tpu/pallas_kernels.py
//   * _matvec_kernel_3d (body) / matvec_M_pallas_3d_core (entry): the
//     implicit-transport operator M of one coupling cycle. Every GMRES
//     operator application streams the f32 weights; every sweep of the
//     Neumann-4 preconditioner streams the bf16 copy (ops/ard_implicit.py).
//   * _matvec_kernel_3d_ds (body) / matvec_slots_pallas_3d_ds (entry): the
//     f64-accurate slot sum of the refinement residual. The TPU has no f64
//     and emulated it with double-single f32 pairs; here each product is
//     (double)W * x64 and the sum runs in native f64.
//
// Contract (plain twins: kernels/matvec3d.py matvec3d_plain,
// slots3d_f64_plain): x arrives zero-padded by mext on every side (the
// twins' layout), so a neighbour outside the grid reads an exact 0 and
// every slot is visited, as in the twins; slots are accumulated in
// reference stencil order, acc = acc + W_s * x_j (bf16 W widened to f32
// first, f32 W widened to f64 in the f64 sum), matvec3d starting from
// diag*x and slots3d_f64 from 0, so with -fmad=false each result equals
// its plain version bit for bit. matvec3d's rows that are not unknown
// write an exact 0 and read no weights; slots3d_f64 applies no diagonal
// and no mask (the caller does both in f64).
//
// What bounds them on an H100: the weight stream. At the flagship grid
// (1,055,668 nodes, S = 178) W is 751.6 MB in f32 and 375.8 MB in bf16, far
// beyond the 50 MB L2, against ~13 MB of x, diag, unknown and y (x in f64
// for slots3d_f64: ~17 MB). matvec3d reads W only for the 660,600 unknown
// rows (~470 MB f32, ~235 MB bf16: ~140 / ~70 us at 3.35 TB/s);
// slots3d_f64 reads all of it (~224 us). The f64 multiply-add rate
// (67 TFLOP/s) is no limit at 2 flops per 4-byte weight.
//
// Design: one thread per node over the flat index; W is laid out
// [S, Nz, Ny, Nx] (the port's choice: no TPU lane layout), so each slot's
// weight read is one coalesced segment per warp, and x is re-read from
// L1/L2 by the neighbouring threads. The padded layout makes the slot loop
// branch-free: each slot is one flat offset (staged in shared memory), and
// the loop is unrolled by kUnroll with every load of a group issued before
// its products, so each thread keeps several weight loads in flight (a
// first version with a bounds test per slot reached 0.64 TB/s in bf16 and
// 2.08 TB/s in f32 at the flagship shape). W's offsets s * N are formed in
// 64 bits. Streaming W with TMA / cp.async is later work.

#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int kUnroll = 4;

__device__ __forceinline__ float widen(float w) { return w; }
__device__ __forceinline__ float widen(__nv_bfloat16 w) {
  return __bfloat162float(w);
}

struct Geometry {
  int S, nz, ny, nx, mext;
};

// flat slot offsets of the padded layout into shared memory; returns the
// padded flat index of node n
__device__ __forceinline__ int stage(const long long* __restrict__ slot_flat,
                                     const Geometry& g, int* s_off,
                                     long long n) {
  for (int s = threadIdx.x; s < g.S; s += blockDim.x)
    s_off[s] = static_cast<int>(slot_flat[s]);
  __syncthreads();
  const int plane = g.ny * g.nx;
  const int k = static_cast<int>(n / plane);
  const int r = static_cast<int>(n - static_cast<long long>(k) * plane);
  const int j = r / g.nx;
  const int i = r - j * g.nx;
  const int py = g.ny + 2 * g.mext, px = g.nx + 2 * g.mext;
  return ((k + g.mext) * py + (j + g.mext)) * px + (i + g.mext);
}

// acc + sum_s W[s*N + n] * xp[p + off_s] in slot order, each weight
// widened to the accumulator's type AT (= x's type)
template <typename AT, typename WT>
__device__ __forceinline__ AT slot_sum(AT acc, const WT* __restrict__ Wn,
                                       const AT* __restrict__ xp, int p,
                                       const int* s_off, int S, long long N) {
  int s = 0;
  for (; s + kUnroll <= S; s += kUnroll) {
    AT w[kUnroll], xv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      w[u] = static_cast<AT>(widen(__ldg(Wn + (s + u) * N)));
      xv[u] = __ldg(xp + p + s_off[s + u]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) acc = acc + w[u] * xv[u];
  }
  for (; s < S; ++s)
    acc = acc + static_cast<AT>(widen(__ldg(Wn + s * N))) *
                    __ldg(xp + p + s_off[s]);
  return acc;
}

template <typename WT>
__global__ void __launch_bounds__(pd::kThreads)
matvec3d_kernel(const float* __restrict__ xp, const WT* __restrict__ W,
                const float* __restrict__ diag,
                const uint8_t* __restrict__ unknown,
                const long long* __restrict__ slot_flat, Geometry g,
                float* __restrict__ y) {
  __shared__ int s_off[pd::kMaxSlots];
  const long long N = static_cast<long long>(g.nz) * g.ny * g.nx;
  const long long n = static_cast<long long>(blockIdx.x) * blockDim.x
                      + threadIdx.x;
  const int p = stage(slot_flat, g, s_off, n < N ? n : 0);
  if (n >= N) return;
  if (!unknown[n]) {
    y[n] = 0.0f;
    return;
  }
  y[n] = slot_sum(diag[n] * xp[p], W + n, xp, p, s_off, g.S, N);
}

__global__ void __launch_bounds__(pd::kThreads)
slots3d_f64_kernel(const double* __restrict__ xp, const float* __restrict__ W,
                   const long long* __restrict__ slot_flat, Geometry g,
                   double* __restrict__ y) {
  __shared__ int s_off[pd::kMaxSlots];
  const long long N = static_cast<long long>(g.nz) * g.ny * g.nx;
  const long long n = static_cast<long long>(blockIdx.x) * blockDim.x
                      + threadIdx.x;
  const int p = stage(slot_flat, g, s_off, n < N ? n : 0);
  if (n >= N) return;
  y[n] = slot_sum(0.0, W + n, xp, p, s_off, g.S, N);
}

int check_geometry(const Geometry& g) {
  const long long padded = static_cast<long long>(g.nz + 2 * g.mext) *
                           (g.ny + 2 * g.mext) * (g.nx + 2 * g.mext);
  if (g.S < 1 || g.S > pd::kMaxSlots || g.nz < 1 || g.mext < 0 ||
      padded > (1LL << 31) - 1)
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

template <typename WT>
int launch_matvec3d(const float* xp, const WT* W, const float* diag,
                    const uint8_t* unknown, const long long* slot_flat,
                    Geometry g, float* y, int device, void* stream) {
  if (int bad = check_geometry(g)) return bad;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n = static_cast<long long>(g.nz) * g.ny * g.nx;
  matvec3d_kernel<WT><<<pd::blocks_for(n), pd::kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      xp, W, diag, unknown, slot_flat, g, y);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

PD_EXPORT int pd_matvec3d_f32(const float* xp, const float* W,
                              const float* diag, const uint8_t* unknown,
                              const long long* slot_flat, int S, int nz,
                              int ny, int nx, int mext, float* y, int device,
                              void* stream) {
  return launch_matvec3d(xp, W, diag, unknown, slot_flat,
                         Geometry{S, nz, ny, nx, mext}, y, device, stream);
}

PD_EXPORT int pd_matvec3d_bf16(const float* xp, const void* W,
                               const float* diag, const uint8_t* unknown,
                               const long long* slot_flat, int S, int nz,
                               int ny, int nx, int mext, float* y, int device,
                               void* stream) {
  return launch_matvec3d(xp, static_cast<const __nv_bfloat16*>(W), diag,
                         unknown, slot_flat, Geometry{S, nz, ny, nx, mext}, y,
                         device, stream);
}

PD_EXPORT int pd_slots3d_f64(const double* xp, const float* W,
                             const long long* slot_flat, int S, int nz,
                             int ny, int nx, int mext, double* y, int device,
                             void* stream) {
  const Geometry g{S, nz, ny, nx, mext};
  if (int bad = check_geometry(g)) return bad;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n = static_cast<long long>(nz) * ny * nx;
  slots3d_f64_kernel<<<pd::blocks_for(n), pd::kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(xp, W, slot_flat,
                                                            g, y);
  return static_cast<int>(cudaGetLastError());
}
