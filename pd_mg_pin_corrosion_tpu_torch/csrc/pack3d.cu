// pack3d: the packed 3D implicit-transport operator of a state, built on
// the device from the per-node fields with no host read and no dense
// weights, into buffers of a fixed capacity.
//
// Replaces no TPU kernel. The JAX package assembles the operator's dense
// W [S, N] in XLA inside its fused coupling cycles
// (pd_mg_pin_corrosion_tpu/coupling.py:283 and :320, through
// pd_mg_pin_corrosion_tpu/ops/ard_implicit.py:61-177), and its 3D Pallas
// matvec streams that W. The port's matvec3d and slots3d_f64 stream the
// weights packed (kernels/matvec3d.py pack_stencil: each unknown row's
// nonzero in-grid weights in ascending slot order with a slot byte beside
// each, rows cut into slices of 32, each slice's length rounded up to a
// group of 16). These kernels form each bond's weight from the per-node
// fields in the launch that packs it, so no dense W is written or read
// (751.6 MB of float32 at the flagship size).
//
// Contract (plain twin: kernels/matvec3d.py pack3d_plain, the dense
// assembly of ops/ard_implicit.py followed by this packing walk in
// PyTorch): diag, unknown, count, slice_ptr, and the first
// 32 * slice_ptr[-1] entries of slots, the float32 values and the
// bfloat16 values (rounded to nearest even, in the bf16 layout) equal the
// dense assembly's and pack_stencil's / PackedStencil.to(bfloat16)'s byte
// for byte, padding entries 0. Each weight is formed by the dense
// assembly's float32 operations in its order (the scalar constants
// rounded to float32 as PyTorch rounds a Python scalar against a float32
// tensor; built with -fmad=false, so no product is contracted into an
// add), and the diagonal subtracts every slot's weight in slot order from
// +0. A bond is kept where its weight is not 0, its row is unknown and its
// neighbour lies inside the grid. When the stored entries exceed the
// capacity, status[1] is set to 1 and no value or slot is written (diag,
// unknown, count and slice_ptr are); the caller repacks into larger
// buffers. status[0] receives the number of nonzeros.
//
// Design, four launches (pd_pack3d_count: 1-3; pd_pack3d_fill: 4):
//   1. code: a thread per node packs its node type, GB and precipitate
//      flags and its salt blocking (a SOLID_MG node with a FLUID
//      neighbour at C >= C_sat) into one byte, so that a bond reads one
//      byte of its neighbour;
//   2. count: a warp per slice of 32 rows, a lane per row, walks the S
//      slots in order (the slot table in shared memory, the neighbours'
//      bytes coalesced across the warp), forms each weight, subtracts it
//      from the diagonal, and sets a bit per kept bond in a
//      [ceil(S / 32), rows] mask; the warp's largest count rounded up to
//      the group is the slice's length, the nonzeros one atomic add a
//      warp;
//   3. scan: one block turns the slice lengths into slice_ptr;
//   4. fill: a warp per slice; for each group of 16 entries every lane
//      forms the weights of its next 16 kept bonds (found in the mask; a
//      third of the slots at the flagship) or padding, holds them in
//      registers and stores them as 16-byte stores: 16 slot bytes, 4 x 4
//      float32 and 16 bfloat16 values a lane, each store of the warp one
//      contiguous run of 512 bytes.
// What bounds it: bytes. The stored entries, 7 bytes each (613 MB at the
// flagship), are written once; the per-node fields (~21 MB) are read from
// HBM once and then from the 50 MB L2, as is the mask (25 MB). The bond
// arithmetic (~25 float32 operations, twice for a kept bond) issues on
// the CUDA cores beside those stores.
//
// pd_pack3d_dense packs a given dense W with the same count, scan and
// fill (the weights read from W instead of formed): the route this kernel
// set replaced, kept as a yardstick for chip_smoke.py.

#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int kSlice = 32;
constexpr int kGroup = 16;
constexpr int kScanThreads = 1024;

// NodeType values (grid.py) besides common.cuh's
constexpr int kSolid = 1, kWall = 2, kInlet = 3, kOutlet = 4, kFict = 6;
// a node's code byte: its node type (clamped to 15: every value the
// assembly compares with is below), then three flags
constexpr uint8_t kTypeBits = 15, kGb = 16, kPrecip = 32, kBlocked = 64;
// an out-of-grid neighbour reads as the dense assembly's pads do
constexpr uint8_t kOutsideCode = pd::kOutside;

struct Grid3 {
  int S, nz, ny, nx;
  long long N;
};

// the assembly's float32 constants: beta_lap, D_liquid, 2 D_liquid (a
// double product rounded once), D_gb, D_precip, D_grain, C_sat, 1e-30 and
// alpha / V_H (a double quotient rounded once)
struct Consts {
  float beta, D_liquid, two_D_liquid, D_gb, D_precip, D_grain, C_sat, tiny,
      adv;
};

// the stencil in shared memory: offsets (dk, dj, di), the flat offset and
// (without a dense W) 1/xi, 1/xi^2, e_x, e_y, e_z and vol
struct Slots {
  int dk[pd::kMaxSlots], dj[pd::kMaxSlots], di[pd::kMaxSlots];
  int flat[pd::kMaxSlots];
  float ixi[pd::kMaxSlots], ixi2[pd::kMaxSlots], ex[pd::kMaxSlots],
      ey[pd::kMaxSlots], ez[pd::kMaxSlots], vol[pd::kMaxSlots];
};

__device__ void load_slots(Slots& t, const int* __restrict__ off,
                           const float* __restrict__ coefs, const Grid3& g) {
  for (int s = threadIdx.x; s < g.S; s += blockDim.x) {
    t.dk[s] = off[3 * s];
    t.dj[s] = off[3 * s + 1];
    t.di[s] = off[3 * s + 2];
    t.flat[s] = (t.dk[s] * g.ny + t.dj[s]) * g.nx + t.di[s];
    if (coefs != nullptr) {
      t.ixi[s] = coefs[s];
      t.ixi2[s] = coefs[g.S + s];
      t.ex[s] = coefs[2 * g.S + s];
      t.ey[s] = coefs[3 * g.S + s];
      t.ez[s] = coefs[4 * g.S + s];
      t.vol[s] = coefs[5 * g.S + s];
    }
  }
  __syncthreads();
}

struct Row {
  long long n;
  int k, j, i;
  bool fluid, solid, blocked;
  float Ds, vx, vy, vz;
};

// the solid-side micro-diffusivity of a code: GB > precipitate > grain,
// times the volume-loss factor (ops/ard.py solid_diffusivity)
__device__ __forceinline__ float solid_D(uint8_t code, const Consts& c,
                                         float decay) {
  return ((code & kGb) ? c.D_gb
                       : ((code & kPrecip) ? c.D_precip : c.D_grain)) *
         decay;
}

__device__ __forceinline__ Row make_row(long long n, const Grid3& g,
                                        uint8_t code,
                                        const float* __restrict__ vel,
                                        const Consts& c, float decay) {
  Row r;
  r.n = n;
  r.i = static_cast<int>(n % g.nx);
  r.j = static_cast<int>((n / g.nx) % g.ny);
  r.k = static_cast<int>(n / (static_cast<long long>(g.nx) * g.ny));
  const int nt = code & kTypeBits;
  r.fluid = nt == pd::kFluid;
  r.solid = nt == kSolid;
  r.blocked = (code & kBlocked) != 0;
  r.Ds = solid_D(code, c, decay);
  r.vx = r.fluid && vel != nullptr ? vel[3 * n] : 0.0f;
  r.vy = r.fluid && vel != nullptr ? vel[3 * n + 1] : 0.0f;
  r.vz = r.fluid && vel != nullptr ? vel[3 * n + 2] : 0.0f;
  return r;
}

__device__ __forceinline__ bool in_grid(const Row& r, const Slots& t, int s,
                                        const Grid3& g) {
  const int kk = r.k + t.dk[s], jj = r.j + t.dj[s], ii = r.i + t.di[s];
  return kk >= 0 && kk < g.nz && jj >= 0 && jj < g.ny && ii >= 0 &&
         ii < g.nx;
}

// the weight of slot s of the unknown row r (ops/ard_implicit.py
// _dense_weights, pd_ard_implicit.cpp:254-288), each operation the dense
// assembly's in its order; a select of the dense form whose other branch
// is never taken is not evaluated
__device__ __forceinline__ float bond(const Row& r, const Slots& t, int s,
                                      bool inside,
                                      const uint8_t* __restrict__ code,
                                      const Consts& c, float decay) {
  const uint8_t cj = inside ? code[r.n + t.flat[s]] : kOutsideCode;
  const int nt = cj & kTypeBits;
  const bool jf = nt == pd::kFluid || nt == kInlet || nt == kOutlet ||
                  nt == kFict;
  const bool js = nt == kSolid;
  if (r.solid && js) return 0.0f;  // solid-solid bonds are skipped
  const float V_j =
      t.vol[s] * (nt != kWall && nt != pd::kOutside ? 1.0f : 0.0f);
  const bool ll = r.fluid && jf;
  float D_avg = 0.0f;
  if (ll) {
    D_avg = c.D_liquid;
  } else if ((r.fluid && js) || (r.solid && jf)) {
    const float sD = r.solid ? r.Ds : solid_D(cj, c, decay);
    const bool blocked = r.solid ? r.blocked : (cj & kBlocked) != 0;
    D_avg = blocked ? 0.0f
                    : (c.two_D_liquid * sD) / ((c.D_liquid + sD) + c.tiny);
  }
  const float w_diff = ((c.beta * D_avg) * t.ixi2[s]) * V_j;
  if (!ll) return w_diff;
  // advection and the per-bond upwind clamp on liquid-liquid bonds
  const float v_dot_e = ((r.vx * t.ex[s]) + (r.vy * t.ey[s])) +
                        (r.vz * t.ez[s]);
  const float w_adv = ((c.adv * v_dot_e) * t.ixi[s]) * V_j;
  const float d = w_adv - w_diff;
  const float w_stab = isnan(d) ? d : fmaxf(d, 0.0f);  // torch.clamp(min=0)
  return (w_diff + w_stab) - w_adv;
}

// 1. each node's code byte, its salt blocking included
// (ops/ard.py compute_salt_blocked)
__global__ void __launch_bounds__(pd::kThreads)
    code_kernel(const uint8_t* __restrict__ node_type,
                const float* __restrict__ C, const uint8_t* __restrict__ gb,
                const uint8_t* __restrict__ precip,
                const int* __restrict__ off, Grid3 g, float C_sat,
                uint8_t* __restrict__ code) {
  __shared__ Slots t;
  load_slots(t, off, nullptr, g);
  const long long n =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (n >= g.N) return;
  const uint8_t nt = node_type[n];
  bool blocked = false;
  if (nt == kSolid) {
    Row r;
    r.i = static_cast<int>(n % g.nx);
    r.j = static_cast<int>((n / g.nx) % g.ny);
    r.k = static_cast<int>(n / (static_cast<long long>(g.nx) * g.ny));
    for (int s = 0; s < g.S && !blocked; ++s) {
      if (!in_grid(r, t, s, g)) continue;
      const long long m = n + t.flat[s];
      blocked = node_type[m] == pd::kFluid && C[m] >= C_sat;
    }
  }
  code[n] = static_cast<uint8_t>(
      (nt < kTypeBits ? nt : kTypeBits) | (gb[n] ? kGb : 0) |
      (precip[n] ? kPrecip : 0) | (blocked ? kBlocked : 0));
}

// what the count and fill launches read: the slot offsets, and the
// state's code bytes, velocities, volume-loss factor and slot
// coefficients, or a dense W with its unknown mask
struct Source {
  const int* off;
  const uint8_t* code;
  const float* vel;
  const float* decay;
  const float* coefs;
  const float* W;
  const uint8_t* unknown;
};

template <bool kDense>
__device__ __forceinline__ Row source_row(const Source& src, long long n,
                                          const Grid3& g, const Consts& c,
                                          float decay, bool& unknown) {
  if constexpr (kDense) {
    unknown = src.unknown[n] != 0;
    return make_row(n, g, 0, nullptr, c, decay);
  }
  const uint8_t code = src.code[n];
  const int nt = code & kTypeBits;
  unknown = nt == pd::kFluid || nt == kSolid;
  return make_row(n, g, code, src.vel, c, decay);
}

template <bool kDense>
__device__ __forceinline__ float weight(const Source& src, const Row& r,
                                        const Slots& t, int s, bool inside,
                                        const Grid3& g, const Consts& c,
                                        float decay) {
  if constexpr (kDense) return src.W[static_cast<long long>(s) * g.N + r.n];
  return bond(r, t, s, inside, src.code, c, decay);
}

// 2. counts, the diagonal and unknown mask (from the state), the
// kept-bond mask, the slice lengths and the nonzeros
template <bool kDense>
__global__ void __launch_bounds__(pd::kThreads)
    count_kernel(Source src, Grid3 g, Consts c, long long n_slices,
                 uint32_t* __restrict__ mask, float* __restrict__ diag,
                 uint8_t* __restrict__ unknown, int16_t* __restrict__ count,
                 int* __restrict__ lens,
                 unsigned long long* __restrict__ nnz) {
  __shared__ Slots t;
  load_slots(t, src.off, kDense ? nullptr : src.coefs, g);
  const long long warp =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (warp >= n_slices) return;
  const long long n_pad = n_slices * kSlice;
  const long long n = warp * kSlice + lane;
  const float decay = kDense ? 1.0f : *src.decay;
  int cnt = 0;
  if (n < g.N) {
    bool unk;
    const Row r = source_row<kDense>(src, n, g, c, decay, unk);
    float d = 0.0f;
    if (unk) {
      uint32_t bits = 0;
      for (int s = 0; s < g.S; ++s) {
        const bool inside = in_grid(r, t, s, g);
        const float w = weight<kDense>(src, r, t, s, inside, g, c, decay);
        d = d - w;
        const bool kept = w != 0.0f && inside;
        bits |= static_cast<uint32_t>(kept) << (s & 31);
        cnt += kept;
        if ((s & 31) == 31 || s == g.S - 1) {
          mask[(s >> 5) * n_pad + n] = bits;
          bits = 0;
        }
      }
    }
    count[n] = static_cast<int16_t>(cnt);
    if constexpr (!kDense) {
      diag[n] = d;
      unknown[n] = unk;
    }
  }
  const int mx = __reduce_max_sync(0xffffffffu, cnt);
  const unsigned total = __reduce_add_sync(0xffffffffu, cnt);
  if (lane == 0) {
    lens[warp] = (mx + kGroup - 1) / kGroup * kGroup;
    atomicAdd(nnz, static_cast<unsigned long long>(total));
  }
}

// 3. slice_ptr[0] = 0, slice_ptr[t + 1] = lens[0] + ... + lens[t]
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

__device__ __forceinline__ uint32_t bf16_pair(float lo, float hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(lo))) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(hi)))
          << 16);
}

// 4. every slice's entries, a group of 16 a lane at a time: the q-th entry
// of lane l of a slice whose value rows start at `base` lies at
// (base + q - q % 16) * 32 + (q % 16) / c * (32 * c) + l * c + q % c,
// c = 16 for the slot bytes and the bfloat16 values, 4 for the float32
// values (kernels/matvec3d.py PackedStencil)
template <bool kDense>
__global__ void __launch_bounds__(pd::kThreads)
    fill_kernel(Source src, Grid3 g, Consts c, long long n_slices,
                const uint32_t* __restrict__ mask,
                const int16_t* __restrict__ count,
                const int* __restrict__ slice_ptr, long long capacity,
                uint8_t* __restrict__ slots, float* __restrict__ vals,
                uint16_t* __restrict__ vals16,
                unsigned long long* __restrict__ status) {
  __shared__ Slots t;
  load_slots(t, src.off, kDense ? nullptr : src.coefs, g);
  const long long stored = slice_ptr[n_slices];
  const long long tid =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (stored * kSlice > capacity) {
    if (tid == 0) status[1] = 1;
    return;
  }
  if (tid == 0) status[1] = 0;
  const long long warp = tid / 32;
  const int lane = threadIdx.x % 32;
  if (warp >= n_slices) return;
  const long long n_pad = n_slices * kSlice;
  const long long n = warp * kSlice + lane;
  const long long base = slice_ptr[warp];
  const int len = slice_ptr[warp + 1] - static_cast<int>(base);
  const float decay = kDense ? 1.0f : *src.decay;
  const int cnt = n < g.N ? count[n] : 0;
  bool unk = false;
  Row r{};
  if (cnt > 0) r = source_row<kDense>(src, n, g, c, decay, unk);
  int word = -1;
  uint32_t bits = 0;
  for (int q0 = 0; q0 < len; q0 += kGroup) {
    float v[kGroup];
    uint32_t sl[kGroup / 4] = {0, 0, 0, 0};
#pragma unroll
    for (int e = 0; e < kGroup; ++e) {
      float w = 0.0f;
      uint32_t s = 0;
      if (q0 + e < cnt) {
        while (bits == 0) bits = mask[++word * n_pad + n];
        s = static_cast<uint32_t>(word * 32 + __ffs(bits) - 1);
        bits &= bits - 1;
        w = weight<kDense>(src, r, t, static_cast<int>(s), true, g, c,
                           decay);
      }
      v[e] = w;
      sl[e / 4] |= s << (8 * (e % 4));
    }
    const long long at = (base + q0) * kSlice;
    *reinterpret_cast<uint4*>(slots + at + lane * kGroup) =
        make_uint4(sl[0], sl[1], sl[2], sl[3]);
#pragma unroll
    for (int j = 0; j < kGroup / 4; ++j)
      *reinterpret_cast<float4*>(vals + at + j * (kSlice * 4) + lane * 4) =
          make_float4(v[4 * j], v[4 * j + 1], v[4 * j + 2], v[4 * j + 3]);
    uint4* h = reinterpret_cast<uint4*>(vals16 + at + lane * kGroup);
    h[0] = make_uint4(bf16_pair(v[0], v[1]), bf16_pair(v[2], v[3]),
                      bf16_pair(v[4], v[5]), bf16_pair(v[6], v[7]));
    h[1] = make_uint4(bf16_pair(v[8], v[9]), bf16_pair(v[10], v[11]),
                      bf16_pair(v[12], v[13]), bf16_pair(v[14], v[15]));
  }
}

bool bad_grid(int S, int nz, int ny, int nx, long long capacity) {
  return S < 1 || S > pd::kMaxSlots || nz < 1 || ny < 1 || nx < 1 ||
         capacity < 0;
}

Consts consts_of(const float* k) {
  return Consts{k[0], k[1], k[2], k[3], k[4], k[5], k[6], k[7], k[8]};
}

template <bool kDense>
cudaError_t count_and_scan(const Source& src, const Grid3& g,
                           const Consts& c, uint32_t* mask, float* diag,
                           uint8_t* unknown, int16_t* count, int* lens,
                           int* slice_ptr, unsigned long long* status,
                           cudaStream_t st) {
  const long long n_slices = (g.N + kSlice - 1) / kSlice;
  cudaError_t err =
      cudaMemsetAsync(status, 0, sizeof(unsigned long long), st);
  if (err != cudaSuccess) return err;
  count_kernel<kDense><<<pd::blocks_for(n_slices * kSlice), pd::kThreads, 0,
                         st>>>(src, g, c, n_slices, mask, diag, unknown,
                               count, lens, status);
  scan_kernel<<<1, kScanThreads, 0, st>>>(lens, n_slices, slice_ptr);
  return cudaGetLastError();
}

template <bool kDense>
cudaError_t fill(const Source& src, const Grid3& g, const Consts& c,
                 const uint32_t* mask, const int16_t* count,
                 const int* slice_ptr, long long capacity, uint8_t* slots,
                 float* vals, void* vals16, unsigned long long* status,
                 cudaStream_t st) {
  const long long n_slices = (g.N + kSlice - 1) / kSlice;
  fill_kernel<kDense><<<pd::blocks_for(n_slices * kSlice), pd::kThreads, 0,
                        st>>>(src, g, c, n_slices, mask, count, slice_ptr,
                              capacity, slots, vals,
                              static_cast<uint16_t*>(vals16), status);
  return cudaGetLastError();
}

}  // namespace

// node_type [N] uint8, vel [N, 3] float32, C [N] float32, is_gb and
// is_precip [N] bool, decay a float32 on the device; slot_offsets [S, 3]
// int32 (dk, dj, di), slot_coefs [6, S] float32 (1/xi, 1/xi^2, e_x, e_y,
// e_z, vol); consts 9 float32 on the host (Consts); code [N] uint8 and
// mask [ceil(S / 32), 32 * ceil(N / 32)] uint32 scratch that the fill
// reads; diag [N] float32, unknown [N] bool, count [N] int16, lens
// [ceil(N / 32)] int32 scratch, slice_ptr [ceil(N / 32) + 1] int32,
// status [2] (nonzeros, overflow). Launches 1-3.
PD_EXPORT int pd_pack3d_count(const uint8_t* node_type, const float* vel,
                              const float* C, const uint8_t* is_gb,
                              const uint8_t* is_precip, const float* decay,
                              const int* slot_offsets,
                              const float* slot_coefs, int S, int nz, int ny,
                              int nx, const float* consts, uint8_t* code,
                              uint32_t* mask, float* diag, uint8_t* unknown,
                              int16_t* count, int* lens, int* slice_ptr,
                              unsigned long long* status, int device,
                              void* stream) {
  if (bad_grid(S, nz, ny, nx, 0)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Grid3 g{S, nz, ny, nx, static_cast<long long>(nz) * ny * nx};
  const Consts c = consts_of(consts);
  code_kernel<<<pd::blocks_for(g.N), pd::kThreads, 0, st>>>(
      node_type, C, is_gb, is_precip, slot_offsets, g, c.C_sat, code);
  const Source src{slot_offsets, code, vel, decay, slot_coefs, nullptr,
                   nullptr};
  return static_cast<int>(count_and_scan<false>(
      src, g, c, mask, diag, unknown, count, lens, slice_ptr, status, st));
}

// launch 4 over pd_pack3d_count's code, mask, count and slice_ptr: slots,
// vals (float32) and vals16 (bfloat16) of `capacity` entries each
PD_EXPORT int pd_pack3d_fill(const float* vel, const float* decay,
                             const int* slot_offsets, const float* slot_coefs,
                             int S, int nz, int ny, int nx,
                             const float* consts, const uint8_t* code,
                             const uint32_t* mask, const int16_t* count,
                             const int* slice_ptr, long long capacity,
                             uint8_t* slots, float* vals, void* vals16,
                             unsigned long long* status, int device,
                             void* stream) {
  if (bad_grid(S, nz, ny, nx, capacity))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Grid3 g{S, nz, ny, nx, static_cast<long long>(nz) * ny * nx};
  const Source src{slot_offsets, code, vel, decay, slot_coefs, nullptr,
                   nullptr};
  return static_cast<int>(fill<false>(
      src, g, consts_of(consts), mask, count, slice_ptr, capacity, slots,
      vals, vals16, status, static_cast<cudaStream_t>(stream)));
}

// the yardstick: a dense W [S, N] float32 and its unknown [N] bool packed
// by the same count, scan and fill (no diag or unknown written)
PD_EXPORT int pd_pack3d_dense(const float* W, const uint8_t* unknown,
                              const int* slot_offsets, int S, int nz, int ny,
                              int nx, uint32_t* mask, int16_t* count,
                              int* lens, int* slice_ptr, long long capacity,
                              uint8_t* slots, float* vals, void* vals16,
                              unsigned long long* status, int device,
                              void* stream) {
  if (bad_grid(S, nz, ny, nx, capacity))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Grid3 g{S, nz, ny, nx, static_cast<long long>(nz) * ny * nx};
  const Consts c{};
  const Source src{slot_offsets, nullptr, nullptr, nullptr, nullptr, W,
                   unknown};
  err = count_and_scan<true>(src, g, c, mask, nullptr, nullptr, count, lens,
                             slice_ptr, status, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(fill<true>(src, g, c, mask, count, slice_ptr,
                                     capacity, slots, vals, vals16, status,
                                     st));
}
