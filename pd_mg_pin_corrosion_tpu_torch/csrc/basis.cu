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
//   axpy: out[n] = w[n] - sum_r c[r] * V[r, n], rows in order; c arrives
//         in f64 and is rounded to f32 (round to nearest even, the bits of
//         Tensor.to(float32)) while it is staged in shared memory; w may be
//         null (w = 0, the GMRES solution update). With -fmad=false each
//         element sees the plain sequential loop's subtractions in its
//         order, so the result equals the twin's bit for bit however the
//         elements are spread over threads.
//
// The basis is [k, n] with a row pitch (floats between the starts of two
// rows) that the caller passes: GMRES allocates it with a pitch that is a
// multiple of 32 floats, so every row starts on a 128-byte line even when n
// is odd (the fine-calibration grid has n = 196,749).
//
// What bounds them on an H100: streaming the basis. At the fine-calibration
// slice (restart 25 -> up to k = 26 rows of n = 196,749) one full-basis
// pass is 20.5 MB, which stays in the 50 MB L2 from one pass to the next;
// at the flagship (n = 1,055,668) it is 110 MB and comes from HBM (~33 us
// at 3.35 TB/s). CGS2 makes four such passes per Arnoldi step (two dots,
// two axpys) over the rows 0..j. A pass has one multiply and one add per
// 4-byte load, so it is the bytes in flight that decide its time.
//
// Design, dots: each thread walks a grid-stride range of n and touches
// every row at that n, so w stays in a register across rows and every row
// read is coalesced; rows in chunks of kRows (one f64 partial per row of a
// chunk in registers).
//
// Design, axpy: each thread owns four consecutive n and reads one 16-byte
// float4 per row (where the pitch and the pointers allow it; a scalar form
// of the same loop otherwise, and for the n % 4 tail). Rows are taken in
// register groups of kAxpyRows: all loads of a group are issued before its
// subtract chain, so a thread keeps kAxpyRows * 16 bytes in flight; the
// last, partial group is predicated, so the loops unroll for every k. The
// grid is sized from the SM count by the wrapper (one float4 per thread
// until the card is full, a grid-stride loop after that).

#include "common.cuh"

namespace {

constexpr int kRows = 32;   // rows per dots pass (f64 partials in registers)
constexpr int kWarps = pd::kThreads / 32;

// rows per register group of the axpy loop (loads in flight per thread)
#ifndef PD_AXPY_ROWS
#define PD_AXPY_ROWS 8
#endif
constexpr int kAxpyRows = PD_AXPY_ROWS;

__global__ void __launch_bounds__(pd::kThreads)
dots_partial_kernel(const float* __restrict__ V, long long pitch,
                    const float* __restrict__ w, int k, long long n,
                    double* __restrict__ partial) {
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
      if (r < k) acc[r] += static_cast<double>(V[r * pitch + idx] * wv);
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

// one element type of the axpy loop: a float (scalar form) or a float4
__device__ __forceinline__ float zero_of(float) { return 0.0f; }
__device__ __forceinline__ float4 zero_of(float4) {
  return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}
__device__ __forceinline__ float sub_scaled(float acc, float c, float v) {
  return acc - c * v;
}
__device__ __forceinline__ float4 sub_scaled(float4 acc, float c, float4 v) {
  return make_float4(acc.x - c * v.x, acc.y - c * v.y, acc.z - c * v.z,
                     acc.w - c * v.w);
}

// out[i] = w[i] - sum_r s_c[r] * V[r * pitch + i] for i in [first, count),
// i counting elements of type T (pitch in units of T too)
template <typename T>
__device__ __forceinline__ void axpy_range(const float* s_c,
                                           const T* __restrict__ V,
                                           long long pitch,
                                           const T* __restrict__ w, int k,
                                           long long first, long long count,
                                           long long stride,
                                           T* __restrict__ out) {
  for (long long i = first; i < count; i += stride) {
    T acc = w ? __ldg(w + i) : zero_of(T{});
    const T* col = V + i;
    int r = 0;
    for (; r + kAxpyRows <= k; r += kAxpyRows) {
      T v[kAxpyRows];
#pragma unroll
      for (int u = 0; u < kAxpyRows; ++u) v[u] = __ldg(col + (r + u) * pitch);
#pragma unroll
      for (int u = 0; u < kAxpyRows; ++u)
        acc = sub_scaled(acc, s_c[r + u], v[u]);
    }
    if (r < k) {
      T v[kAxpyRows];
#pragma unroll
      for (int u = 0; u < kAxpyRows; ++u)
        if (r + u < k) v[u] = __ldg(col + (r + u) * pitch);
#pragma unroll
      for (int u = 0; u < kAxpyRows; ++u)
        if (r + u < k) acc = sub_scaled(acc, s_c[r + u], v[u]);
    }
    out[i] = acc;
  }
}

template <bool kVec>
__global__ void __launch_bounds__(pd::kThreads) axpy_kernel(const double* __restrict__ c,
                            const float* __restrict__ V, long long pitch,
                            const float* __restrict__ w, int k, long long n,
                            float* __restrict__ out) {
  extern __shared__ float s_c[];
  for (int r = threadIdx.x; r < k; r += blockDim.x)
    s_c[r] = static_cast<float>(c[r]);
  __syncthreads();
  const long long tid = static_cast<long long>(blockIdx.x) * blockDim.x +
                        threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  if (kVec) {
    const long long n4 = n / 4;
    axpy_range(s_c, reinterpret_cast<const float4*>(V), pitch / 4,
               reinterpret_cast<const float4*>(w), k, tid, n4, stride,
               reinterpret_cast<float4*>(out));
    // the n % 4 tail, one element per thread of the first block
    axpy_range(s_c, V, pitch, w, k, 4 * n4 + tid, n, stride, out);
  } else {
    axpy_range(s_c, V, pitch, w, k, tid, n, stride, out);
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// V: k rows of n floats, `pitch` floats apart. partial: k * nblocks f64
// scratch from the caller; out: k f64.
PD_EXPORT int pd_basis_dots(const float* V, long long pitch, const float* w,
                            int k, long long n, int nblocks, double* partial,
                            double* out, int device, void* stream) {
  if (k < 1 || n < 1 || nblocks < 1 || pitch < n)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  for (int r0 = 0; r0 < k; r0 += kRows) {
    const int kc = k - r0 < kRows ? k - r0 : kRows;
    dots_partial_kernel<<<nblocks, pd::kThreads, 0, st>>>(
        V + static_cast<long long>(r0) * pitch, pitch, w, kc, n,
        partial + static_cast<long long>(r0) * nblocks);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  dots_final_kernel<<<k, pd::kThreads, 0, st>>>(partial, nblocks, out);
  return static_cast<int>(cudaGetLastError());
}

// c: k f64 coefficients (rounded to f32 in the kernel); V as above; w: n
// floats or null; threads a multiple of 32, at most kThreads. The 16-byte form runs when the
// pitch is a multiple of 4 floats and V, w and out start on 16 bytes.
PD_EXPORT int pd_basis_axpy(const double* c, const float* V, long long pitch,
                            const float* w, int k, long long n, int nblocks,
                            int threads, float* out, int device,
                            void* stream) {
  if (k < 1 || n < 1 || nblocks < 1 || pitch < n || threads < 32 ||
      threads > pd::kThreads || threads % 32 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = pitch % 4 == 0 && aligned16(V) && aligned16(out) &&
                   (w == nullptr || aligned16(w));
  if (vec)
    axpy_kernel<true><<<nblocks, threads, k * sizeof(float), st>>>(
        c, V, pitch, w, k, n, out);
  else
    axpy_kernel<false><<<nblocks, threads, k * sizeof(float), st>>>(
        c, V, pitch, w, k, n, out);
  return static_cast<int>(cudaGetLastError());
}
