// matvec3d: y = diag*x + sum_s W_s * shift_s(x) on unknown rows, 0 elsewhere
// (f32 x, W packed in f32 or bf16), and slots3d_f64: the float64 slot sum
// sum_s W_s * shift_s(x) (packed f32 W, f64 x), both on the 3D grid.
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
// kernels/matvec3d.py matvec3d_plain, slots3d_f64_plain; on the packed
// weights: matvec3d_packed_plain, slots3d_f64_packed_plain): a neighbour
// outside the grid reads an exact 0; slots are accumulated in reference
// stencil order, acc = acc + W_s * x_j (bf16 W widened to f32 first, f32 W
// widened to f64 in the f64 sum), matvec3d starting from diag*x and
// slots3d_f64 from +0, with -fmad=false. matvec3d's rows that are not
// unknown write an exact 0 and read no weights. slots3d_f64 applies no
// diagonal and no mask (the caller does both in f64); a row the packing
// holds no weight of (every row that is not unknown) writes +0.
//
// Both kernels visit only the bonds whose weight is not zero and whose
// neighbour lies inside the grid (the packed form holds no other). A
// skipped term is acc + 0 * x_j or acc + w * 0, an exact +-0, so for finite
// x_j and w it leaves acc as it was, and the result equals the dense twin's
// bit for bit: an accumulator that starts at +0 is never -0 (+0 + -0 is
// +0, and a sum of two nonzero values that cancels is +0 under
// round-to-nearest), and x + (+-0) is x for every other x. matvec3d's
// accumulator starts at diag*x, which may be -0.0: there a skipped term
// leaves -0.0 where the twin's acc + (+0.0) gives +0.0, a difference
// torch.equal does not see. An inf or nan in x no longer spreads through a
// zero weight (0 * inf = nan in the twin). slots3d_f64 equals its dense
// twin only where the dense W is zero off the unknown rows, as assemble
// makes it (ops/ard_implicit.py masks W to unknown rows; the caller masks
// the result to them too).
//
// What bounds them on an H100: the weight stream. At the flagship grid
// (1,055,668 nodes, S = 178) the dense W is 751.6 MB in f32, far beyond the
// 50 MB L2. About half of the weights of the 660,600 unknown rows are
// exact zeros by construction (the upwind clamp cancels the liquid-liquid
// bonds whose advective weight exceeds the diffusive one; wall, outside
// and solid-solid bonds are masked), so the least either must move is the
// ~56 M nonzero weights (4 or 2 bytes each), which slots they belong to
// (178 bits per unknown row would do), and the vectors: matvec3d ~0.25 GB
// in f32 and ~0.14 GB in bf16 (x, diag, unknown, y: 13 B/node);
// slots3d_f64 ~0.26 GB (x and y in f64: 16 B/node), 0.077 ms at 3.35 TB/s.
// The multiply-add rates (67 TFLOP/s f32, 34 f64) are no limit at 2 flops
// per weight. slots3d_f64 walked the dense W before (0.77 GB with its
// vectors, 0.29 ms); over the packed weights it takes 0.13 ms back to back
// and 0.14 ms behind another kernel (H100 80GB HBM3, 700 W; PERF.md), about
// matvec3d's f32 time: the f64 x is gathered from the L2 as the f32 one is.
//
// Design: the weights arrive packed (kernels/matvec3d.py pack_stencil,
// once per coupling cycle): per row its nonzero weights in ascending slot
// order, each with its slot number in one byte, and the row's count. Rows
// are cut into slices of 32 consecutive flat nodes, one warp each; a slice
// stores as many value rows as its fullest row has nonzeros. A row's
// nonzeros are taken in groups of kGroup = 16, and a group of the slice's
// 32 rows is one block of 512 entries: one thread per row reads per group
// 16 slot numbers (one 16-byte load) and 16 weights in 16-byte loads, laid
// out so that a warp's load covers a contiguous run of whole 32-byte
// sectors (f32: four loads of 512 B, the rows' chunks of 4 side by side;
// bf16: two loads over 1 KB, 32 bytes per row); every load of a turn is
// issued before its adds. x is read from the grid itself at one flat
// offset per slot (staged in shared memory) and comes from L1/L2, as
// neighbouring rows read neighbouring x (8.45 MB in f64, 4.2 MB in f32: both
// stay in the L2); the packed streams are loaded evict-first so they do
// not push it out. One template walks all three: the accumulator and x
// type (f32, or f64 for slots3d_f64, which reads the f32 weights that
// matvec3d's f32 launch streams), the weight type, and whether a diagonal
// and the unknown mask come in.
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

#include <cuda_bf16.h>

#include "common.cuh"

namespace {

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

struct Geometry {
  int S, nz, ny, nx;
};

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
// `live` entries exist (all of them unless kTail), each weight widened to
// the accumulator's type AT (= x's type): every load of the turn is issued
// before its adds
template <int kGroups, bool kTail, typename AT, typename WT>
__device__ __forceinline__ AT add_groups(AT acc, const WT* __restrict__ v,
                                         const uint8_t* __restrict__ sl,
                                         const AT* __restrict__ xn,
                                         const int* s_off, int live) {
  float w[kGroups][kGroup];
  AT xv[kGroups][kGroup];
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
      if (!kTail || u * kGroup + i < live)
        acc = acc + static_cast<AT>(w[u][i]) * xv[u][i];
  return acc;
}

// One thread per row. vals / slots: the packed weights and their slot
// numbers, count: nonzeros per row, slice_ptr: [ceil(N / 32) + 1] value
// rows before each slice (kernels/matvec3d.py PackedStencil). x is the
// grid itself: no packed weight belongs to a neighbour outside it. With
// kDiag (matvec3d) a row starts from diag*x and rows that are not unknown
// write 0; without (slots3d_f64) every row starts from +0 and a row with
// no stored weight writes it.
template <typename AT, typename WT, bool kDiag>
__global__ void __launch_bounds__(pd::kThreads)
stencil_kernel(const AT* __restrict__ x, const WT* __restrict__ vals,
               const uint8_t* __restrict__ slots,
               const int16_t* __restrict__ count,
               const int* __restrict__ slice_ptr,
               const float* __restrict__ diag,
               const uint8_t* __restrict__ unknown,
               const int* __restrict__ slot_offsets, Geometry g,
               AT* __restrict__ y) {
  __shared__ int s_off[pd::kMaxSlots];
  for (int s = threadIdx.x; s < g.S; s += blockDim.x)
    s_off[s] = (slot_offsets[3 * s] * g.ny + slot_offsets[3 * s + 1]) * g.nx
               + slot_offsets[3 * s + 2];
  __syncthreads();
  const long long N = static_cast<long long>(g.nz) * g.ny * g.nx;
  const long long n = static_cast<long long>(blockIdx.x) * blockDim.x
                      + threadIdx.x;
  if (n >= N) return;
  if (kDiag && !unknown[n]) {
    y[n] = AT(0);
    return;
  }
  const int cnt = __ldg(count + n);
  const long long first = static_cast<long long>(__ldg(slice_ptr + (n >> 5)))
                          * 32;
  const WT* v = vals + first + (n & 31) * kLaneChunk<WT>;
  const uint8_t* sl = slots + first + (n & 31) * kGroup;
  const AT* xn = x + n;
  AT acc = AT(0);
  if constexpr (kDiag) acc = diag[n] * xn[0];
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

template <typename AT, typename WT, bool kDiag>
int launch(const AT* x, const WT* vals, const uint8_t* slots,
           const int16_t* count, const int* slice_ptr, const float* diag,
           const uint8_t* unknown, const int* slot_offsets, Geometry g,
           int group, AT* y, int device, void* stream) {
  const long long n = static_cast<long long>(g.nz) * g.ny * g.nx;
  if (g.S < 1 || g.S > pd::kMaxSlots || g.nz < 1 || g.ny < 1 || g.nx < 1 ||
      n > (1LL << 31) - 1 || group != kGroup)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  stencil_kernel<AT, WT, kDiag><<<pd::blocks_for(n), pd::kThreads, 0,
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
  return launch<float, float, true>(x, vals, slots, count, slice_ptr, diag,
                                    unknown, slot_offsets,
                                    Geometry{S, nz, ny, nx}, group, y, device,
                                    stream);
}

// the same with the packed values in bf16
PD_EXPORT int pd_matvec3d_bf16(const float* x, const void* vals,
                               const uint8_t* slots, const int16_t* count,
                               const int* slice_ptr, const float* diag,
                               const uint8_t* unknown,
                               const int* slot_offsets, int S, int nz, int ny,
                               int nx, int group, float* y, int device,
                               void* stream) {
  return launch<float, __nv_bfloat16, true>(
      x, static_cast<const __nv_bfloat16*>(vals), slots, count, slice_ptr,
      diag, unknown, slot_offsets, Geometry{S, nz, ny, nx}, group, y, device,
      stream);
}

// the f64 slot sum over the packed f32 weights (the arrays of
// pd_matvec3d_f32, no diag, no unknown); x and y: [nz, ny, nx] float64
PD_EXPORT int pd_slots3d_f64(const double* x, const float* vals,
                             const uint8_t* slots, const int16_t* count,
                             const int* slice_ptr, const int* slot_offsets,
                             int S, int nz, int ny, int nx, int group,
                             double* y, int device, void* stream) {
  return launch<double, float, false>(x, vals, slots, count, slice_ptr,
                                      nullptr, nullptr, slot_offsets,
                                      Geometry{S, nz, ny, nx}, group, y,
                                      device, stream);
}
