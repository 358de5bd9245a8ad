// basis_dots / basis_axpy: the whole-basis contractions of GMRES's CGS2
// Arnoldi step (f32 Krylov vectors, f64 coefficients).
//
// Replaces: pd_mg_pin_corrosion_tpu/pallas_kernels.py,
//   _basis_dots_kernel / basis_dots_pallas (and basis_norm_pallas, which is
//   the k = 1 self-dot), and _basis_axpy_kernel / basis_axpy_pallas.
//
//   dots: c[r] = sum_n V[r, n] * w[n] for r < k. Each product is rounded
//         to f32 (as the plain (V * w).sum(dtype=float64) does) and summed
//         in f64, in an order fixed by (k, n, blocks, parts) alone: a lane
//         adds its own elements in order, a warp its lanes by a shuffle
//         tree, a block a row's parts in order, and the block that finishes
//         last adds the blocks' partials in a fixed order. No float atomics,
//         so two runs give the same bits; the 16-byte and the scalar form
//         give a lane the same elements in the same order, so the bits do
//         not depend on the pitch or on where the pointers start either
//         (kernels/basis.py basis_dots_walk_plain is this order in PyTorch).
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
// pass is 20.5 MB, which stays in the 50 MB L2 from one pass to the next
// (~4 us at the L2's rate); at the flagship (n = 1,055,668) it is 110 MB
// and comes from HBM (~33 us at 3.35 TB/s). CGS2 makes four such passes
// per Arnoldi step (two dots, two axpys) over the rows 0..j, and every
// GMRES norm is a k = 1 dots call over 0.8 or 4.2 MB. A pass has one
// multiply and one add per 4-byte load, so it is the bytes in flight that
// decide its time. For dots at the 2D shape and for every norm, what is
// not the stream is as long as the stream: a launch (2-3 us), and the way
// from a block's partial sums to the result. So a call is ONE launch, the
// sums across threads are kept few, and the last block's loads are issued
// together. The f32 -> f64 converts of dots (one per element, a quarter of
// the f32 rate) are ~1.4 us of a (26, 196,749) call and ~7 us of a
// (26, 1,055,668) one spread over the card, hidden behind the loads.
//
// Design, dots: one launch; a warp owns ONE row over one part of its
// block's share of the vector. The vector is cut into pieces of four
// consecutive n; block b owns `share` pieces, cut into `parts` parts, and
// its warps take the k * parts (row, part) items in turn (the wrapper
// chooses parts so that a warp has about one item: 1 at k = 26, 16 for the
// k = 1 norm). A lane reads the pieces lane, lane + 32, ... of its item,
// one 16-byte load of the row and one of w each (four 4-byte loads where
// the pitch or the pointers do not allow it, and for the n % 4 tail, whose
// missing elements read as 0; w comes from the L1 after the block's first
// row), kDotsUnroll pieces loaded ahead of their multiply - convert - add
// chain, into ONE f64 partial. So a (row, part) costs one shuffle tree,
// where a thread that owned a piece of every row (the form before this
// one: 0.018 ms at (26, 196,749), 0.054 at (26, 1,055,668)) had k partials
// to reduce across each warp, and a warp streams 512 contiguous bytes a
// load. A basis too large for the L2 is read with evict-first loads. The
// grid comes from the SM count (the wrapper: two blocks of 16 warps an SM).
// Each block adds a row's parts in order, writes its k partials to scratch,
// fences, and draws a ticket with an integer atomicAdd; the block that
// draws the last ticket adds the partials of every row in a fixed order
// (16 threads a row, each its blocks in order with the loads issued
// ahead, then a tree), writes c, and sets the ticket back to 0 for the next
// call. Only the ticket is atomic, so the order of arrival never reaches
// the sums. The scratch and the ticket belong to the wrapper, one pair per
// device and stream: two calls that ran at once on one pair would mix
// their partials, and calls on one stream never run at once. The k = 1
// self-dot (w is the row) loads each piece once and squares it.
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

constexpr int kDotsThreads = 1024;  // the largest dots block
constexpr int kMaxItems = 1024;     // (row, part) items of a dots block
constexpr int kFinalLanes = 16;  // threads that share a row of the last sum
constexpr int kFinalBatch = 17;  // their loads in flight (272 blocks: one go)

// pieces a lane of dots loads ahead of their adds
#ifndef PD_DOTS_UNROLL
#define PD_DOTS_UNROLL 4
#endif
constexpr int kDotsUnroll = PD_DOTS_UNROLL;
// dots reads the basis with evict-first loads: 0 never, 1 always, 2 when
// the basis is larger than kStreamBytes (it cannot stay in the L2 anyway)
#ifndef PD_DOTS_STREAM
#define PD_DOTS_STREAM 2
#endif
constexpr long long kStreamBytes = 40ll << 20;

// rows per register group of the axpy loop (loads in flight per thread)
#ifndef PD_AXPY_ROWS
#define PD_AXPY_ROWS 8
#endif
constexpr int kAxpyRows = PD_AXPY_ROWS;

// p[0..3], of which the first `left` exist (the rest read as 0): one
// 16-byte load where the form allows it and the piece is whole; kStream:
// an evict-first load (data read once)
template <bool kVec, bool kStream = false>
__device__ __forceinline__ float4 load_piece(const float* __restrict__ p,
                                             long long left) {
  if (kVec && left >= 4)
    return kStream ? __ldcs(reinterpret_cast<const float4*>(p))
                   : __ldg(reinterpret_cast<const float4*>(p));
  float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (left > 0) v.x = __ldg(p);
  if (left > 1) v.y = __ldg(p + 1);
  if (left > 2) v.z = __ldg(p + 2);
  if (left > 3) v.w = __ldg(p + 3);
  return v;
}

// acc + the four products of a piece, each rounded to f32, in element order
__device__ __forceinline__ double add_products(double acc, float4 v,
                                               float4 w) {
  acc += static_cast<double>(v.x * w.x);
  acc += static_cast<double>(v.y * w.y);
  acc += static_cast<double>(v.z * w.z);
  acc += static_cast<double>(v.w * w.w);
  return acc;
}

__device__ __forceinline__ double warp_sum(double v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  return v;   // lane 0 holds the sum
}

// The end of a dots block, after it has written its k partials to
// partial[k][gridDim.x]: draw a ticket; the block that draws the last one
// adds the blocks' partials: kFinalLanes threads a row, thread q of them
// the blocks q, q + kFinalLanes, ... in order (kFinalBatch loads issued
// ahead of their adds), then a tree over the kFinalLanes; and sets the
// ticket back.
__device__ __forceinline__ void last_block_sums(const double* partial,
                                                unsigned int* ticket, int k,
                                                double* __restrict__ out) {
  __shared__ bool s_last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    s_last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  const int q = threadIdx.x % kFinalLanes;
  const int rows_a_turn = blockDim.x / kFinalLanes;
  const int nb = gridDim.x;
  for (int rb = 0; rb < k; rb += rows_a_turn) {   // the same for a whole warp
    const int r = rb + threadIdx.x / kFinalLanes;
    double s = 0.0;
    if (r < k) {
      const double* row = partial + static_cast<long long>(r) * nb;
      for (int b0 = q; b0 < nb; b0 += kFinalLanes * kFinalBatch) {
        double v[kFinalBatch];
#pragma unroll
        for (int j = 0; j < kFinalBatch; ++j)
          if (b0 + j * kFinalLanes < nb)
            v[j] = __ldcg(row + b0 + j * kFinalLanes);
#pragma unroll
        for (int j = 0; j < kFinalBatch; ++j)
          if (b0 + j * kFinalLanes < nb) s += v[j];
      }
    }
    for (int off = kFinalLanes / 2; off > 0; off >>= 1)
      s += __shfl_xor_sync(0xffffffffu, s, off);
    if (r < k && q == 0) out[r] = s;
  }
  if (threadIdx.x == 0) *ticket = 0u;
}

// A warp owns one row over one part of the block's pieces.
// Block b owns the pieces [b * share, (b + 1) * share) of ceil(n / 4), cut
// into `parts` parts; its warps take the k * parts (row, part) items in
// turn. A lane adds the pieces lane, lane + 32, ... of its item in order
// (kDotsUnroll pieces loaded ahead of their adds), the warp its lanes by a
// tree, the block a row's parts in order.
template <bool kVec, bool kStream>
__global__ void __launch_bounds__(kDotsThreads)
dots_kernel(const float* __restrict__ V, long long pitch,
            const float* __restrict__ w, int k, long long n, long long share,
            int parts, double* partial, unsigned int* ticket,
            double* __restrict__ out) {
  __shared__ double s_item[kMaxItems];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const long long pieces = (n + 3) / 4;
  const long long first = blockIdx.x * share;
  const long long last = first + share < pieces ? first + share : pieces;
  const long long sub = (share + parts - 1) / parts;
  const bool self = k == 1 && V == w;

  for (int it = warp; it < k * parts; it += nwarps) {
    const int r = it / parts, q = it - r * parts;
    const long long a = first + q * sub;
    const long long b = a + sub < last ? a + sub : last;
    const float* row = V + r * pitch;
    double acc = 0.0;
    long long i = a + lane;
    for (; i + 32 * (kDotsUnroll - 1) < b; i += 32 * kDotsUnroll) {
      float4 x[kDotsUnroll], v[kDotsUnroll];
#pragma unroll
      for (int u = 0; u < kDotsUnroll; ++u) {
        const long long e = 4 * (i + 32 * u);
        x[u] = load_piece<kVec>(w + e, n - e);
        v[u] = self ? x[u] : load_piece<kVec, kStream>(row + e, n - e);
      }
#pragma unroll
      for (int u = 0; u < kDotsUnroll; ++u)
        acc = add_products(acc, v[u], x[u]);
    }
    for (; i < b; i += 32) {
      const float4 x = load_piece<kVec>(w + 4 * i, n - 4 * i);
      acc = add_products(
          acc,
          self ? x : load_piece<kVec, kStream>(row + 4 * i, n - 4 * i), x);
    }
    acc = warp_sum(acc);
    if (lane == 0) s_item[it] = acc;
  }
  __syncthreads();
  for (int r = threadIdx.x; r < k; r += blockDim.x) {
    double s = 0.0;
    for (int q = 0; q < parts; ++q) s += s_item[r * parts + q];
    partial[static_cast<long long>(r) * gridDim.x + blockIdx.x] = s;
  }
  last_block_sums(partial, ticket, k, out);
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

// V: k rows of n floats, `pitch` floats apart (any pitch for k = 1).
// partial: k * nblocks f64 of scratch and ticket: one counter, 0 before the
// first call, both the caller's and used by one call at a time; out: k f64;
// threads a multiple of 32, at most kDotsThreads. One launch. The 16-byte form
// runs when the pitch is a multiple of 4 floats and V and w start on 16
// bytes.
PD_EXPORT int pd_basis_dots(const float* V, long long pitch, const float* w,
                            int k, long long n, int nblocks, int threads,
                            int parts, double* partial, unsigned int* ticket,
                            double* out, int device, void* stream) {
  if (k < 1 || n < 1 || nblocks < 1 || (k > 1 && pitch < n) || threads < 32 ||
      threads > kDotsThreads || threads % 32 != 0 || parts < 1 ||
      static_cast<long long>(k) * parts > kMaxItems)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long pieces = (n + 3) / 4;
  const long long share = (pieces + nblocks - 1) / nblocks;
  const bool vec = (k == 1 || pitch % 4 == 0) && aligned16(V) && aligned16(w);
  const bool str = PD_DOTS_STREAM == 1 ||
                   (PD_DOTS_STREAM == 2 && 4 * k * n > kStreamBytes);
  auto kernel = vec ? (str ? dots_kernel<true, true> : dots_kernel<true, false>)
                    : dots_kernel<false, false>;
  kernel<<<nblocks, threads, 0, st>>>(V, pitch, w, k, n, share, parts, partial,
                                      ticket, out);
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
