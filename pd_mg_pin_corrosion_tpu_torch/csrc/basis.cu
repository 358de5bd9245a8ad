// basis_dots / basis_axpy: the whole-basis contractions of GMRES's CGS2
// Arnoldi step (f32 Krylov vectors, f64 coefficients).
//
// Replaces: pd_mg_pin_corrosion_tpu/pallas_kernels.py,
//   _basis_dots_kernel / basis_dots_pallas (and basis_norm_pallas, which is
//   the k = 1 self-dot), and _basis_axpy_kernel / basis_axpy_pallas.
//
//   dots: c[r] = sum_n V[r, n] * w[n] for r < k. Each product is rounded
//         to f32 (as the plain (V * w).sum(dtype=float64) does) and summed
//         in f64. Deterministic two-pass reduction: per-block f64 partials
//         for every row (fixed warp-shuffle and shared-memory tree order),
//         then one block per row adds its partials in a fixed order. No
//         float atomics, so two runs give the same bits.
//   axpy: out[n] = w[n] - sum_r c[r] * V[r, n], rows in order, c in f32
//         (the caller casts, as gmres.py does); w may be null (w = 0, the
//         GMRES solution update). With -fmad=false this equals the plain
//         sequential loop bit for bit.
//
// What bounds them on an H100: streaming the basis. V is [k, N] f32; at the
// fine-calibration slice (restart 25 -> up to k = 26 rows of N = 196,749)
// one full-basis pass is 20.5 MB (~6 us at 3.35 TB/s), and CGS2 makes four
// such passes per Arnoldi step (two dots, two axpys) over the rows 0..j.
//
// Design: V is read exactly once per pass — each thread walks a grid-stride
// range of n and touches every row at that n, so w (dots) or the
// accumulator (axpy) stays in a register across rows and every row read is
// coalesced. Rows are processed in chunks of kRows (registers hold one f64
// partial per row of a chunk); the coefficients sit in shared memory.

#include "common.cuh"

namespace {

constexpr int kRows = 32;   // rows per dots pass (f64 partials in registers)
constexpr int kWarps = pd::kThreads / 32;

__global__ void __launch_bounds__(pd::kThreads)
dots_partial_kernel(const float* __restrict__ V, const float* __restrict__ w,
                    int k, long long n, double* __restrict__ partial) {
  double acc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r] = 0.0;

  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long idx = static_cast<long long>(blockIdx.x) * blockDim.x +
                       threadIdx.x;
       idx < n; idx += stride) {
    const float wv = w[idx];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (r < k) acc[r] += static_cast<double>(V[r * n + idx] * wv);
    }
  }

  __shared__ double s_part[kRows][kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (r < k) {
      double v = acc[r];
      for (int off = 16; off > 0; off >>= 1)
        v += __shfl_down_sync(0xffffffffu, v, off);
      if (lane == 0) s_part[r][warp] = v;
    }
  }
  __syncthreads();
  if (threadIdx.x < k) {
    double s = 0.0;
    for (int q = 0; q < kWarps; ++q) s += s_part[threadIdx.x][q];
    partial[static_cast<long long>(threadIdx.x) * gridDim.x + blockIdx.x] = s;
  }
}

__global__ void __launch_bounds__(pd::kThreads)
dots_final_kernel(const double* __restrict__ partial, int nblocks,
                  double* __restrict__ out) {
  const int r = blockIdx.x;
  double s = 0.0;
  for (int b = threadIdx.x; b < nblocks; b += blockDim.x)
    s += partial[static_cast<long long>(r) * nblocks + b];
  __shared__ double s_red[pd::kThreads];
  s_red[threadIdx.x] = s;
  __syncthreads();
  for (int half = blockDim.x / 2; half > 0; half >>= 1) {
    if (threadIdx.x < half) s_red[threadIdx.x] += s_red[threadIdx.x + half];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[r] = s_red[0];
}

__global__ void __launch_bounds__(pd::kThreads)
axpy_kernel(const float* __restrict__ c, const float* __restrict__ V,
            const float* __restrict__ w, int k, long long n,
            float* __restrict__ out) {
  extern __shared__ float s_c[];
  for (int r = threadIdx.x; r < k; r += blockDim.x) s_c[r] = c[r];
  __syncthreads();
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long idx = static_cast<long long>(blockIdx.x) * blockDim.x +
                       threadIdx.x;
       idx < n; idx += stride) {
    float acc = w ? w[idx] : 0.0f;
    for (int r = 0; r < k; ++r) acc = acc - s_c[r] * V[r * n + idx];
    out[idx] = acc;
  }
}

}  // namespace

// partial: k * nblocks f64 scratch from the caller; out: k f64.
PD_EXPORT int pd_basis_dots(const float* V, const float* w, int k,
                            long long n, int nblocks, double* partial,
                            double* out, int device, void* stream) {
  if (k < 1 || n < 1 || nblocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  for (int r0 = 0; r0 < k; r0 += kRows) {
    const int kc = k - r0 < kRows ? k - r0 : kRows;
    dots_partial_kernel<<<nblocks, pd::kThreads, 0, st>>>(
        V + static_cast<long long>(r0) * n, w, kc, n,
        partial + static_cast<long long>(r0) * nblocks);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  dots_final_kernel<<<k, pd::kThreads, 0, st>>>(partial, nblocks, out);
  return static_cast<int>(cudaGetLastError());
}

PD_EXPORT int pd_basis_axpy(const float* c, const float* V, const float* w,
                            int k, long long n, int nblocks, float* out,
                            int device, void* stream) {
  if (k < 1 || n < 1 || nblocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  axpy_kernel<<<nblocks, pd::kThreads, k * sizeof(float),
                static_cast<cudaStream_t>(stream)>>>(c, V, w, k, n, out);
  return static_cast<int>(cudaGetLastError());
}
