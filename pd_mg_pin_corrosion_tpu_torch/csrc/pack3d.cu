// pack3d: the packed form of a 3D operator's dense weights, made on the
// device with no host read, into buffers of a fixed capacity.
//
// Replaces no TPU kernel. The JAX package assembles its operator inside
// the fused coupling cycles' program (coupling.py:280-283 and :318-320:
// ops.assemble, whose 3D Pallas matvec streams the dense W). The port's
// matvec3d and slots3d_f64 stream W packed (kernels/matvec3d.py
// pack_stencil): each unknown row's nonzero in-grid weights in ascending
// slot order with a slot byte beside each, rows cut into slices of 32 with
// each slice's length rounded up to a group of 16. pack_stencil sizes its
// output on the host (two scalars read back, a nonzero() of the kept
// bonds), which no CUDA graph can hold; this kernel writes the same bytes
// into the GmresRunner's capacity buffers so the assembly runs inside the
// cycles program.
//
// Contract (plain twin: kernels/matvec3d.py pack3d_plain, this walk in
// PyTorch; pack_stencil is the definition): count, slice_ptr, and the
// first 32 * slice_ptr[-1] entries of slots, the float32 values and the
// bfloat16 values (rounded to nearest even, in the bf16 layout) equal
// pack_stencil's and PackedStencil.to(bfloat16)'s byte for byte, padding
// entries 0. A bond is kept where its weight is not 0, its row is unknown
// and its neighbour lies inside the grid. When the stored entries exceed
// the capacity, status[1] is set to 1 and no value or slot is written
// (count and slice_ptr are); the caller repacks into larger buffers.
// status[0] receives the number of nonzeros (PackedStencil.nnz).
//
// Design, three launches:
//   1. count: a warp per slice, a lane per row, walks the S slots of its
//      row (the dense W read once, coalesced across the warp), writes the
//      row's count, and the warp's largest count rounded up to the group
//      is the slice's length; the nonzeros are summed by one atomic add
//      a warp;
//   2. scan: one block turns the slice lengths into slice_ptr (exclusive,
//      int32), each thread a run of slices then a block-wide scan;
//   3. fill: a thread per row of every slice (rows past N included, whose
//      entries are all padding) walks its slots again and writes its q-th
//      kept bond at the packed index of q, then zeros up to its slice's
//      length.
// What bounds it: reading the dense W twice (S * N * 4 bytes, 1.5 GB at
// the flagship size; ~0.45 ms at 3.35 TB/s), once a coupling cycle.

#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int kSlice = 32;
constexpr int kScanThreads = 1024;

struct Grid3 {
  int S, nz, ny, nx, group;
  long long N;
};

// whether slot s of node n is a kept bond
__device__ bool kept(const float* __restrict__ W, const uint8_t* __restrict__ unk,
                     const int* __restrict__ off, const Grid3& g, int s,
                     long long n, int k, int j, int i) {
  const float w = W[static_cast<long long>(s) * g.N + n];
  if (w == 0.0f || !unk[n]) return false;
  const int kk = k + off[3 * s], jj = j + off[3 * s + 1],
            ii = i + off[3 * s + 2];
  return kk >= 0 && kk < g.nz && jj >= 0 && jj < g.ny && ii >= 0 &&
         ii < g.nx;
}

__global__ void count_kernel(const float* __restrict__ W,
                             const uint8_t* __restrict__ unk,
                             const int* __restrict__ off, Grid3 g,
                             long long n_slices, int16_t* __restrict__ count,
                             int* __restrict__ lens,
                             unsigned long long* __restrict__ nnz) {
  const long long warp =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (warp >= n_slices) return;
  const long long n = warp * kSlice + lane;
  int c = 0;
  if (n < g.N) {
    const int i = static_cast<int>(n % g.nx);
    const int j = static_cast<int>((n / g.nx) % g.ny);
    const int k = static_cast<int>(n / (static_cast<long long>(g.nx) * g.ny));
    if (unk[n])
      for (int s = 0; s < g.S; ++s) c += kept(W, unk, off, g, s, n, k, j, i);
    count[n] = static_cast<int16_t>(c);
  }
  const int mx = __reduce_max_sync(0xffffffffu, c);
  const unsigned total = __reduce_add_sync(0xffffffffu, c);
  if (lane == 0) {
    lens[warp] = (mx + g.group - 1) / g.group * g.group;
    atomicAdd(nnz, static_cast<unsigned long long>(total));
  }
}

// slice_ptr[0] = 0, slice_ptr[t + 1] = lens[0] + ... + lens[t]
__global__ void __launch_bounds__(kScanThreads)
    scan_kernel(const int* __restrict__ lens, long long n,
                int* __restrict__ slice_ptr) {
  __shared__ long long part[kScanThreads];
  const int t = threadIdx.x;
  const long long per = (n + kScanThreads - 1) / kScanThreads;
  const long long lo = min(n, t * per), hi = min(n, lo + per);
  long long s = 0;
  for (long long q = lo; q < hi; ++q) s += lens[q];
  part[t] = s;
  __syncthreads();
  for (int d = 1; d < kScanThreads; d <<= 1) {
    const long long v = t >= d ? part[t - d] : 0;
    __syncthreads();
    part[t] += v;
    __syncthreads();
  }
  long long acc = t == 0 ? 0 : part[t - 1];
  if (t == 0) slice_ptr[0] = 0;
  for (long long q = lo; q < hi; ++q) {
    acc += lens[q];
    slice_ptr[q + 1] = static_cast<int>(acc);
  }
}

// entry of the q-th packed value of lane `lane` of a slice whose rows
// start at value row `base`, c values of a row side by side
__device__ long long at(long long base, int q, int group, int lane, int c) {
  return (base + q - q % group) * kSlice +
         static_cast<long long>((q % group) / c) * (kSlice * c) + lane * c +
         q % c;
}

__global__ void fill_kernel(const float* __restrict__ W,
                            const uint8_t* __restrict__ unk,
                            const int* __restrict__ off, Grid3 g,
                            long long n_slices,
                            const int* __restrict__ slice_ptr,
                            long long capacity, uint8_t* __restrict__ slots,
                            float* __restrict__ vals,
                            __nv_bfloat16* __restrict__ vals16,
                            unsigned long long* __restrict__ status) {
  const long long stored = slice_ptr[n_slices];
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (stored * kSlice > capacity) {
    if (t == 0) status[1] = 1;
    return;
  }
  if (t == 0) status[1] = 0;
  if (t >= n_slices * kSlice) return;
  const long long slice = t / kSlice;
  const int lane = static_cast<int>(t % kSlice);
  const long long base = slice_ptr[slice];
  const int len = slice_ptr[slice + 1] - static_cast<int>(base);
  const long long n = t;
  const int grp = g.group;
  const int c32 = min(grp, 4), c16 = min(grp, 16);
  int q = 0;
  if (n < g.N && unk[n]) {
    const int i = static_cast<int>(n % g.nx);
    const int j = static_cast<int>((n / g.nx) % g.ny);
    const int k = static_cast<int>(n / (static_cast<long long>(g.nx) * g.ny));
    for (int s = 0; s < g.S; ++s) {
      if (!kept(W, unk, off, g, s, n, k, j, i)) continue;
      const float w = W[static_cast<long long>(s) * g.N + n];
      slots[at(base, q, grp, lane, grp)] = static_cast<uint8_t>(s);
      vals[at(base, q, grp, lane, c32)] = w;
      vals16[at(base, q, grp, lane, c16)] = __float2bfloat16_rn(w);
      ++q;
    }
  }
  for (; q < len; ++q) {
    slots[at(base, q, grp, lane, grp)] = 0;
    vals[at(base, q, grp, lane, c32)] = 0.0f;
    vals16[at(base, q, grp, lane, c16)] = __float2bfloat16_rn(0.0f);
  }
}

}  // namespace

// W [S, nz*ny*nx] float32; unknown [N] bool; slot_offsets [S, 3] int32
// (dk, dj, di); count [N] int16, lens [ceil(N/32)] int32 scratch,
// slice_ptr [ceil(N/32) + 1] int32; slots, vals (float32) and vals16
// (bfloat16) of `capacity` entries each; status [2] (nonzeros, overflow)
PD_EXPORT int pd_pack3d(const float* W, const uint8_t* unknown,
                        const int* slot_offsets, int S, int nz, int ny, int nx,
                        int group, int16_t* count, int* lens, int* slice_ptr,
                        uint8_t* slots, float* vals, void* vals16,
                        long long capacity, unsigned long long* status,
                        int device, void* stream) {
  if (S < 1 || S > pd::kMaxSlots || nz < 1 || ny < 1 || nx < 1 || group < 1 ||
      group > 16 || 16 % group != 0 || capacity < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Grid3 g{S, nz, ny, nx, group, static_cast<long long>(nz) * ny * nx};
  const long long n_slices = (g.N + kSlice - 1) / kSlice;
  err = cudaMemsetAsync(status, 0, sizeof(unsigned long long), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  count_kernel<<<pd::blocks_for(n_slices * kSlice), pd::kThreads, 0, st>>>(
      W, unknown, slot_offsets, g, n_slices, count, lens, status);
  scan_kernel<<<1, kScanThreads, 0, st>>>(lens, n_slices, slice_ptr);
  fill_kernel<<<pd::blocks_for(n_slices * kSlice), pd::kThreads, 0, st>>>(
      W, unknown, slot_offsets, g, n_slices, slice_ptr, capacity, slots, vals,
      static_cast<__nv_bfloat16*>(vals16), status);
  return static_cast<int>(cudaGetLastError());
}
