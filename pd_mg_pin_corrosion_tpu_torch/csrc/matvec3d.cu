// matvec3d: y = diag*x + sum_s W_s * shift_s(x) on unknown rows, 0 elsewhere
// (f32 x, W packed in f32 or bf16), and slots3d_f64: the float64 slot sum
// sum_s W_s * shift_s(x) (dense f32 W, f64 x), both on the 3D grid.
//
// Replaces: pd_mg_pin_corrosion_tpu/pallas_kernels.py
//   * _matvec_kernel_3d (body) / matvec_M_pallas_3d_core (entry): the
//     implicit-transport operator M of one coupling cycle. Every GMRES
//     operator application streams the f32 weights; every sweep of the
//     Neumann-4 preconditioner streams the bf16 ones (ops/ard_implicit.py).
//   * _matvec_kernel_3d_ds (body) / matvec_slots_pallas_3d_ds (entry): the
//     f64-accurate slot sum of the refinement residual. The TPU has no f64
//     and emulated it with double-single f32 pairs; here each product is
//     (double)W * x64 and the sum runs in native f64.
//
// Contract (plain twins on the dense [S, Nz, Ny, Nx] weights:
// kernels/matvec3d.py matvec3d_plain, slots3d_f64_plain): a neighbour
// outside the grid reads an exact 0; slots are accumulated in reference
// stencil order, acc = acc + W_s * x_j (bf16 W widened to f32 first, f32 W
// widened to f64 in the f64 sum), matvec3d starting from diag*x and
// slots3d_f64 from 0, with -fmad=false. slots3d_f64 takes x zero-padded by
// mext on every side (the twins' layout), visits every slot and equals its
// twin bit for bit; it applies no diagonal and no mask (the caller does
// both in f64). matvec3d's rows that are not unknown write an exact 0 and
// read no weights.
//
// matvec3d visits only the bonds whose weight is not zero and whose
// neighbour lies inside the grid. A skipped term is acc + 0 * x_j or
// acc + w * 0 = acc for every finite x_j and w, so its result equals the
// dense twin's bit for bit for finite inputs, with one exception that
// torch.equal does not see: a -0.0 accumulator stays -0.0 where the twin's
// acc + (+0.0) gives +0.0. An inf or nan in x no longer spreads through a
// zero weight (0 * inf = nan in the twin).
//
// What bounds them on an H100: the weight stream. At the flagship grid
// (1,055,668 nodes, S = 178) the dense W is 751.6 MB in f32, far beyond the
// 50 MB L2, against ~13 MB of x, diag, unknown and y (x in f64 for
// slots3d_f64: ~17 MB); slots3d_f64 reads all of it (~224 us at
// 3.35 TB/s). About half of the weights of the 660,600 unknown rows are
// exact zeros by construction (the upwind clamp cancels the liquid-liquid
// bonds whose advective weight exceeds the diffusive one; wall, outside
// and solid-solid bonds are masked), so the least matvec3d must move is the
// ~56 M nonzero weights (4 or 2 bytes each), which slots they belong to
// (178 bits per unknown row would do), and the vectors: ~0.25 GB in f32,
// ~0.14 GB in bf16, against 0.48 / 0.25 GB for the dense rows. The f32
// multiply-add rate (67 TFLOP/s) is no limit at 2 flops per weight.
//
// Design, matvec3d: the weights arrive packed (kernels/matvec3d.py
// pack_stencil, once per coupling cycle): per row its nonzero weights in
// ascending slot order, each with its slot number in one byte, and the
// row's count. Rows are cut into slices of 32 consecutive flat nodes, one
// warp each; a slice stores as many value rows as its fullest row has
// nonzeros. A row's nonzeros are taken in groups of kGroup = 16, and a
// group of the slice's 32 rows is one block of 512 entries: one thread per
// row reads per group 16 slot numbers (one 16-byte load) and 16 weights in
// 16-byte loads, laid out so that a warp's load covers a contiguous run of
// whole 32-byte sectors (f32: four loads of 512 B, the rows' chunks of 4
// side by side; bf16: two loads over 1 KB, 32 bytes per row); every load
// of a turn is issued before its adds. x is read from the grid itself at
// one flat offset per slot (staged in shared memory) and comes from L1/L2,
// as neighbouring rows read neighbouring x; the packed streams are loaded
// evict-first so they do not push it out.
//
// Why this layout (H100 80GB HBM3 at 700 W, scripts/sweep_kernels_torch.py
// and PERF.md): a bitmask per row (178 bits) would say which slots a row
// keeps in a quarter of the bytes of the slot numbers, but finding each
// next set bit (__ffs, clear it, step to the next word) costs ~25 issue
// slots per nonzero, and a warp walks as far as its fullest row: that walk
// is bound by instruction issue, the same 0.12 ms for f32 and bf16
// weights, where a byte per nonzero (a shift, a mask, a shared-memory
// load) leaves the kernel bound by bytes. And with a row's 16 f32 weights
// side by side (64 bytes) each 32-byte sector is asked for by two loads:
// as fast in back-to-back calls, 1.4x slower behind any other kernel.
//
// Design, slots3d_f64: one thread per node over the flat index; W is laid
// out [S, Nz, Ny, Nx], so each slot's weight read is one coalesced segment
// per warp; the slot loop is branch-free and unrolled by kUnroll with every
// load of a group issued before its products. W's offsets s * N are formed
// in 64 bits.

#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int kUnroll = 4;   // slots per group of the dense f64 slot sum

// matvec3d: nonzeros of a row per group of the packed layout
// (kernels/matvec3d.py GROUP), and the bytes of weights a thread loads per
// full turn of its row walk (loads in flight): as many groups as make them
// up, at least one
#ifndef PD_MATVEC3D_GROUP
#define PD_MATVEC3D_GROUP 16
#endif
#ifndef PD_MATVEC3D_TURN_BYTES
#define PD_MATVEC3D_TURN_BYTES 64
#endif
constexpr int kGroup = PD_MATVEC3D_GROUP;
static_assert(kGroup == 4 || kGroup == 8 || kGroup == 16,
              "whole 16-byte loads");
template <typename WT>
constexpr int kTurnGroups =
    PD_MATVEC3D_TURN_BYTES / (kGroup * static_cast<int>(sizeof(WT))) > 1
        ? PD_MATVEC3D_TURN_BYTES / (kGroup * static_cast<int>(sizeof(WT)))
        : 1;
static_assert(pd::kMaxSlots <= 256, "a slot number is one byte");

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

// The kGroup packed weights of one row's group, widened to f32, in 16-byte
// loads. f32 weights lie in chunks of 4 per row, the chunks of a slice's
// 32 rows side by side, so each load of a warp is one contiguous 512-byte
// run and no 32-byte sector is asked for twice; bf16 weights lie 16 (32
// bytes) side by side per row (a bf16 is the upper half of the f32 of the
// same value). The packed streams are read once: __ldcs marks their lines
// evict-first, so they do not push x out of L1.
template <typename WT>
constexpr int kLaneChunk = sizeof(WT) >= 4 ? 4 : kGroup;

__device__ __forceinline__ void load_group(const float* p,
                                           float (&w)[kGroup]) {
#pragma unroll
  for (int h = 0; h < kGroup / 4; ++h) {
    const float4 t = __ldcs(reinterpret_cast<const float4*>(p + h * (32 * 4)));
    w[4 * h] = t.x, w[4 * h + 1] = t.y, w[4 * h + 2] = t.z, w[4 * h + 3] = t.w;
  }
}
__device__ __forceinline__ void load_group(const __nv_bfloat16* p,
                                           float (&w)[kGroup]) {
  uint32_t t[kGroup / 2];
  if constexpr (kGroup == 4) {
    const uint2 q = __ldcs(reinterpret_cast<const uint2*>(p));
    t[0] = q.x, t[1] = q.y;
  } else {
#pragma unroll
    for (int h = 0; h < kGroup / 8; ++h) {
      const uint4 q = __ldcs(reinterpret_cast<const uint4*>(p) + h);
      t[4 * h] = q.x, t[4 * h + 1] = q.y, t[4 * h + 2] = q.z, t[4 * h + 3] = q.w;
    }
  }
#pragma unroll
  for (int h = 0; h < kGroup / 2; ++h) {
    w[2 * h] = __uint_as_float(t[h] << 16);
    w[2 * h + 1] = __uint_as_float(t[h] & 0xffff0000u);
  }
}
// the kGroup slot numbers beside them, four to a word
__device__ __forceinline__ void load_slots(const uint8_t* p,
                                           uint32_t (&sb)[kGroup / 4]) {
  if constexpr (kGroup == 16) {
    const uint4 q = __ldcs(reinterpret_cast<const uint4*>(p));
    sb[0] = q.x, sb[1] = q.y, sb[2] = q.z, sb[3] = q.w;
  } else if constexpr (kGroup == 8) {
    const uint2 q = __ldcs(reinterpret_cast<const uint2*>(p));
    sb[0] = q.x, sb[1] = q.y;
  } else {
    sb[0] = __ldcs(reinterpret_cast<const uint32_t*>(p));
  }
}

// acc + the next kGroups groups of a row's nonzeros, of which the first
// `live` entries exist (all of them unless kTail): every load of the turn
// is issued before its adds
template <int kGroups, bool kTail, typename WT>
__device__ __forceinline__ float add_groups(float acc,
                                            const WT* __restrict__ v,
                                            const uint8_t* __restrict__ sl,
                                            const float* __restrict__ xn,
                                            const int* s_off, int live) {
  float w[kGroups][kGroup], xv[kGroups][kGroup];
  uint32_t sb[kGroups][kGroup / 4];
#pragma unroll
  for (int u = 0; u < kGroups; ++u) {
    load_group(v + u * (32 * kGroup), w[u]);
    load_slots(sl + u * (32 * kGroup), sb[u]);
  }
#pragma unroll
  for (int u = 0; u < kGroups; ++u)
#pragma unroll
    for (int i = 0; i < kGroup; ++i)
      if (!kTail || u * kGroup + i < live)
        xv[u][i] = __ldg(xn + s_off[(sb[u][i / 4] >> (8 * (i % 4))) & 0xffu]);
#pragma unroll
  for (int u = 0; u < kGroups; ++u)
#pragma unroll
    for (int i = 0; i < kGroup; ++i)
      if (!kTail || u * kGroup + i < live) acc = acc + w[u][i] * xv[u][i];
  return acc;
}

// One thread per row. vals / slots: the packed weights and their slot
// numbers, count: nonzeros per row, slice_ptr: [ceil(N / 32) + 1] value
// rows before each slice (kernels/matvec3d.py PackedStencil). x is the
// grid itself: no packed weight belongs to a neighbour outside it.
template <typename WT>
__global__ void __launch_bounds__(pd::kThreads)
matvec3d_kernel(const float* __restrict__ x, const WT* __restrict__ vals,
                const uint8_t* __restrict__ slots,
                const int16_t* __restrict__ count,
                const int* __restrict__ slice_ptr,
                const float* __restrict__ diag,
                const uint8_t* __restrict__ unknown,
                const int* __restrict__ slot_offsets, Geometry g,
                float* __restrict__ y) {
  __shared__ int s_off[pd::kMaxSlots];
  for (int s = threadIdx.x; s < g.S; s += blockDim.x)
    s_off[s] = (slot_offsets[3 * s] * g.ny + slot_offsets[3 * s + 1]) * g.nx
               + slot_offsets[3 * s + 2];
  __syncthreads();
  const long long N = static_cast<long long>(g.nz) * g.ny * g.nx;
  const long long n = static_cast<long long>(blockIdx.x) * blockDim.x
                      + threadIdx.x;
  if (n >= N) return;
  if (!unknown[n]) {
    y[n] = 0.0f;
    return;
  }
  const int cnt = __ldg(count + n);
  const long long first = static_cast<long long>(__ldg(slice_ptr + (n >> 5)))
                          * 32;
  const WT* v = vals + first + (n & 31) * kLaneChunk<WT>;
  const uint8_t* sl = slots + first + (n & 31) * kGroup;
  const float* xn = x + n;
  float acc = diag[n] * xn[0];
  constexpr int kStep = kGroup * kTurnGroups<WT>;   // nonzeros per full turn
  int q = 0;
  for (; q + kStep <= cnt; q += kStep) {
    acc = add_groups<kTurnGroups<WT>, false>(acc, v, sl, xn, s_off, kStep);
    v += 32 * kStep, sl += 32 * kStep;
  }
  for (; q + kGroup <= cnt; q += kGroup) {
    acc = add_groups<1, false>(acc, v, sl, xn, s_off, kGroup);
    v += 32 * kGroup, sl += 32 * kGroup;
  }
  if (q < cnt) acc = add_groups<1, true>(acc, v, sl, xn, s_off, cnt - q);
  y[n] = acc;
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
int launch_matvec3d(const float* x, const WT* vals, const uint8_t* slots,
                    const int16_t* count, const int* slice_ptr,
                    const float* diag, const uint8_t* unknown,
                    const int* slot_offsets, Geometry g, int group, float* y,
                    int device, void* stream) {
  if (int bad = check_geometry(g)) return bad;
  if (group != kGroup) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n = static_cast<long long>(g.nz) * g.ny * g.nx;
  matvec3d_kernel<WT><<<pd::blocks_for(n), pd::kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      x, vals, slots, count, slice_ptr, diag, unknown, slot_offsets, g, y);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: [nz, ny, nx] (not padded); vals: the packed f32 values, slots: their
// slot numbers (uint8), count: [N] int16, slice_ptr: [ceil(N / 32) + 1]
// int32, group: the layout's GROUP (kernels/matvec3d.py pack_stencil);
// slot_offsets: [S, 3] int32 (dk, dj, di)
PD_EXPORT int pd_matvec3d_f32(const float* x, const float* vals,
                              const uint8_t* slots, const int16_t* count,
                              const int* slice_ptr, const float* diag,
                              const uint8_t* unknown, const int* slot_offsets,
                              int S, int nz, int ny, int nx, int group,
                              float* y, int device, void* stream) {
  return launch_matvec3d(x, vals, slots, count, slice_ptr, diag, unknown,
                         slot_offsets, Geometry{S, nz, ny, nx, 0}, group, y,
                         device, stream);
}

// the same with the packed values in bf16
PD_EXPORT int pd_matvec3d_bf16(const float* x, const void* vals,
                               const uint8_t* slots, const int16_t* count,
                               const int* slice_ptr, const float* diag,
                               const uint8_t* unknown,
                               const int* slot_offsets, int S, int nz, int ny,
                               int nx, int group, float* y, int device,
                               void* stream) {
  return launch_matvec3d(x, static_cast<const __nv_bfloat16*>(vals), slots,
                         count, slice_ptr, diag, unknown, slot_offsets,
                         Geometry{S, nz, ny, nx, 0}, group, y, device, stream);
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
