// ard2d: one explicit forward-Euler 2D transport step (f32).
//
// Replaces: pd_mg_pin_corrosion_tpu/pallas_kernels.py, _ard_kernel (body)
// and ard_step_pallas (entry); math of ops/ard.py ard_step (reference
// src/pd_ard.cpp:55-191).
//
// Contract (plain twin: kernels/ard2d.py ard2d_plain; the staged walk below
// in PyTorch: ard2d_staged_plain):
//   * only FLUID and SOLID_MG nodes are updated, every other node is copied
//     through; the centre velocity and |v| are FLUID-masked, the
//     neighbour's |v| is raw;
//   * Ds (solid-side micro-diffusivity, volume-loss factor included) and
//     the salt-blocking flags come from the wrapper, as the TPU kernel's
//     inputs did;
//   * every per-bond term is the plain version's expression, operation for
//     operation, summed in stencil order (acc = acc + term) from +0, so with
//     FMA contraction off (-fmad=false) the result equals the plain PyTorch
//     version bit for bit for finite inputs;
//   * C_new = max(C_i + dt (diff - alpha/V_H adv), 0), a NaN kept;
//   * dt is read from device memory (a 0-d float32 tensor), so a CUDA
//     graph that captures the launch reads the dt of each replay (the
//     explicit step's graph, coupling.ExplicitRunner) and the wrapper
//     reads nothing back from the device.
//
// Bond classes by selects, every slot's terms added. The twin's terms of a
// bond to an off-grid, WALL or OUTSIDE neighbour (V_j = 0), of a
// solid-solid bond (bond_on = 0) and the advection term of a bond that is
// not liquid-liquid are exact zeros of either sign. Here such a bond's
// diffusivity is selected as +0 (and off positions are staged with C =
// +0), so its diffusion term is beta * 0 * dC * ... = +-0 too, and its
// advection term is selected as +0. Adding them leaves both sums' bits:
// a sum starts at +0, +0 + -0 is +0 and a sum of two nonzero floats that
// cancels is +0 under round-to-nearest, so no sum is ever -0, and x + (+-0)
// is x for every other x. That holds while C, |v| and Dsol are finite
// (selects never multiply an inf into a sum; the twin's products with 0
// would turn one into a nan). Selects keep the class tests out of branches:
// a warp's threads at the wire's interface and its SOLID centres take the
// same path as the FLUID ones.
//
// What bounds it on an H100: arithmetic issue. At the fine-calibration grid
// (567 x 347 = 196,749 nodes, S = 36) a call must move ~26 B/node of unique
// data (C, vel[2], |v|, Ds, node_type, salt in; C out), ~5.1 MB, ~1.5 us of
// HBM time, against ~6.6 M liquid-liquid bonds x 17 flops (interface bonds
// 6-10), ~0.11 GFLOP, ~1.7 us at 67 TFLOP/s and ~3.4 us of issue slots as
// unfused instructions on 132 SMs at 1.98 GHz. The one-thread-per-node form
// before this one spent ~25 more issue slots a bond (seven shared table
// words, four bounds compares, a node_type byte, |v|, Ds and salt loads and
// a division per FLUID-SOLID bond) and ran at 0.0283 ms (H100 80GB HBM3,
// 700 W; PERF.md).
//
// Design: ns2d's staged form (csrc/ns2d.cu).
//   * A block owns a tile of kTX x kTY nodes and stages the tile and its
//     halo of kHalo = 3 in shared memory as three planar float fields and a
//     byte plane: C (+0 at off positions), |v| (raw at liquid positions, +0
//     elsewhere), Dsol = salt ? 0 : 2 D_L Ds / (D_L + Ds + 1e-30) at SOLID
//     positions (+0 elsewhere; the twin's expression, so its bits), and the
//     class (off: off-grid, WALL, OUTSIDE; liquid: FLUID, INLET, OUTLET,
//     FICTITIOUS; solid: SOLID_MG). The bounds compares, the node_type,
//     Ds and salt loads and the interface division leave the bond loop.
//     Tiles without a FLUID or SOLID node leave after the staging.
//   * The slot table is ns2d's (kernels/ns2d.py ns2d_tables: 1/xi, 1/xi^2,
//     e_x, e_y, vol and an offset inside the tile per slot; the runs of one
//     dj with consecutive di, 8 at S = 36).
//   * A thread owns kR consecutive x nodes of one row and walks a run along
//     x with a window of kR positions in registers: each step loads one new
//     position (4 shared loads and the liquid test), loads the slot's
//     coefficients and serves its kR nodes. Each node still adds its terms
//     in slot order.
//   * A warp covers kWX x (32 / kWX) threads; the row pitch is padded
//     (PD_ARD2D_PAD) to an odd number of words.
// The tile's sizes are compile-time constants (#ifndef, swept by
// scripts/sweep_kernels_torch.py ard2d); pd_ard2d_geometry reports them to
// the wrapper, which builds the table for them.

#include "common.cuh"

namespace {

#ifndef PD_ARD2D_R
#define PD_ARD2D_R 2       // consecutive x nodes a thread owns
#endif
#ifndef PD_ARD2D_TX
#define PD_ARD2D_TX 32     // tile extent in x (the contiguous axis), in nodes
#endif
#ifndef PD_ARD2D_TY
#define PD_ARD2D_TY 16     // tile extent in y
#endif
#ifndef PD_ARD2D_WX
#define PD_ARD2D_WX 16     // a warp covers WX x (32 / WX) threads
#endif
#ifndef PD_ARD2D_PAD
#define PD_ARD2D_PAD 1     // floats added to the tile's row pitch
#endif
#ifndef PD_ARD2D_BLOCKS
#define PD_ARD2D_BLOCKS 3  // blocks an SM should hold (caps the registers)
#endif

constexpr uint8_t kSolid = 1, kInlet = 3, kOutlet = 4;
constexpr uint8_t kFictitious = 6;
// a staged position's class
constexpr uint8_t kOff = 0, kLiquid = 1, kSolidClass = 2;

constexpr int kHalo = 3;
constexpr int kR = PD_ARD2D_R;
constexpr int kTX = PD_ARD2D_TX, kTY = PD_ARD2D_TY;
constexpr int kXT = kTX / kR;                 // threads along x
constexpr int kWX = PD_ARD2D_WX, kWY = 32 / kWX;
constexpr int kNWX = kXT / kWX;               // warps along x
constexpr int kArdThreads = kXT * kTY;
constexpr int kEX = kTX + 2 * kHalo;          // staged extents
constexpr int kEY = kTY + 2 * kHalo;
constexpr int kPitch = kEX + PD_ARD2D_PAD;    // floats between two rows
constexpr int kField = kPitch * kEY;          // floats of one staged field
constexpr int kFields = 3;                    // C, |v|, Dsol; then the class
constexpr int kMaxDevices = 64;

static_assert(kR >= 1 && kR <= 8 && kTX % kR == 0, "nodes per thread");
static_assert(32 % kWX == 0 && kXT % kWX == 0 && kTY % kWY == 0,
              "a tile is a whole number of warps");
static_assert(kArdThreads % 32 == 0 && kArdThreads <= 1024, "block size");

// one staged position as a neighbour
struct Nb {
  float c, vm, ds;
  bool lq;
};

// a node's own values: C, the FLUID-masked velocity and |v|, its Dsol
struct Own {
  float c, vx, vy, vm, ds;
};

__device__ __forceinline__ Nb load_nb(const float* t, const uint8_t* cls) {
  Nb e;
  e.c = t[0], e.vm = t[kField], e.ds = t[2 * kField];
  e.lq = *cls == kLiquid;
  return e;
}

// one bond's diffusion and advection terms, in the twin's operations: the
// bond's D_avg + D_art is D_L + alpha |v|_max dx (liquid-liquid), the
// solid side's Dsol (interface) or +0 (solid-solid, off neighbour)
__device__ __forceinline__ void add_bond(float& diff, float& adv, const Nb& e,
                                         const Own& o, bool fi, float4 c,
                                         float vol, float beta, float D_L,
                                         float alpha_art, float dx) {
  const float ixi = c.x, ixi2 = c.y, ex = c.z, ey = c.w;
  const float vmax = o.vm > e.vm ? o.vm : e.vm;
  const float d_ll = D_L + alpha_art * vmax * dx;
  const float D = e.lq ? (fi ? d_ll : o.ds) : (fi ? e.ds : 0.0f);
  const float dC = e.c - o.c;
  diff = diff + beta * D * dC * ixi2 * vol;
  const float vde = o.vx * ex + o.vy * ey;
  const float t = dC * vde * ixi * vol;
  adv = adv + ((fi && e.lq) ? t : 0.0f);
}

__global__ void __launch_bounds__(kArdThreads, PD_ARD2D_BLOCKS)
ard2d_kernel(const float* __restrict__ C, const float2* __restrict__ vel,
             const float* __restrict__ vmag, const uint8_t* __restrict__ nt,
             const float* __restrict__ Ds, const uint8_t* __restrict__ salt,
             const float* __restrict__ dt_ptr,
             const int* __restrict__ slot_off,
             const float4* __restrict__ slot_coef,
             const int2* __restrict__ runs, int S, int nruns, int ny, int nx,
             float beta, float D_L, float two_D_L, float alpha_art, float dx,
             float div_coeff, float* __restrict__ C_out) {
  // [S][2] float4 coefficients (1/xi, 1/xi^2, e_x, e_y | vol, -, -, -),
  // [nruns] (first slot, length), 3 fields of kField floats, [S] offsets,
  // kField class bytes
  extern __shared__ float4 smem4[];
  float4* s_coef = smem4;
  int2* s_run = reinterpret_cast<int2*>(smem4 + 2 * S);
  float* tile = reinterpret_cast<float*>(s_run + nruns);
  int* s_off = reinterpret_cast<int*>(tile + kFields * kField);
  uint8_t* s_cls = reinterpret_cast<uint8_t*>(s_off + S);

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int tx = (warp % kNWX) * kWX + lane % kWX;   // thread column
  const int ty = (warp / kNWX) * kWY + lane / kWX;   // tile row
  const int x0 = blockIdx.x * kTX, y0 = blockIdx.y * kTY;
  const int i0 = x0 + tx * kR, j = y0 + ty;

  // own nodes: copy the ones that are neither FLUID nor SOLID_MG through,
  // note the others and load the FLUID ones' velocity (+0 elsewhere)
  unsigned active = 0u, fluid = 0u;
  float2 v_own[kR];
#pragma unroll
  for (int q = 0; q < kR; ++q) {
    v_own[q] = make_float2(0.0f, 0.0f);
    if (j < ny && i0 + q < nx) {
      const int n = j * nx + i0 + q;
      const uint8_t t = nt[n];
      if (t == pd::kFluid || t == kSolid) {
        active |= 1u << q;
        if (t == pd::kFluid) {
          fluid |= 1u << q;
          v_own[q] = vel[n];
        }
      } else {
        C_out[n] = C[n];
      }
    }
  }

  // the tables
  for (int s = tid; s < S; s += kArdThreads) {
    s_coef[2 * s] = slot_coef[2 * s];
    s_coef[2 * s + 1] = slot_coef[2 * s + 1];
    s_off[s] = slot_off[s];
  }
  for (int r = tid; r < nruns; r += kArdThreads) s_run[r] = runs[r];

  // the tile and its halo
  for (int e = tid; e < kEX * kEY; e += kArdThreads) {
    const int ex = e % kEX, ey = e / kEX;
    const int gx = x0 + ex - kHalo, gy = y0 + ey - kHalo;
    const bool inside = gx >= 0 && gx < nx && gy >= 0 && gy < ny;
    const int m = inside ? gy * nx + gx : 0;
    const uint8_t t = inside ? nt[m] : pd::kOutside;
    const bool liq = t == pd::kFluid || t == kInlet || t == kOutlet ||
                     t == kFictitious;
    const bool sol = t == kSolid;
    const float c = C[m], v = vmag[m], d = Ds[m];
    const bool blocked = salt[m] != 0;
    float* f = tile + ey * kPitch + ex;
    f[0] = (liq || sol) ? c : 0.0f;
    f[kField] = liq ? v : 0.0f;
    f[2 * kField] =
        (sol && !blocked) ? two_D_L * d / (D_L + d + 1e-30f) : 0.0f;
    s_cls[ey * kPitch + ex] = liq ? kLiquid : (sol ? kSolidClass : kOff);
  }
  // one barrier for the own nodes' loads, the tables and the staging, so
  // their loads are in flight together; tiles without a FLUID or SOLID_MG
  // node (none at the fine-calibration grid) leave here
  if (!__syncthreads_or(active != 0u) || active == 0u) return;

  // the tile index of this thread's first node, less the halo (the table's
  // offsets carry it), and the own nodes' values
  const int base = ty * kPitch + tx * kR;
  Own own[kR];
  bool fi[kR];
  float diff[kR], adv[kR];
#pragma unroll
  for (int q = 0; q < kR; ++q) {
    const int at = base + kHalo * (kPitch + 1) + q;
    fi[q] = (fluid >> q) & 1u;
    Own& o = own[q];
    o.c = tile[at];
    o.ds = tile[2 * kField + at];
    o.vm = fi[q] ? tile[kField + at] : 0.0f;
    o.vx = v_own[q].x, o.vy = v_own[q].y;
    diff[q] = 0.0f, adv[q] = 0.0f;
  }

  for (int r = 0; r < nruns; ++r) {
    const int s0 = s_run[r].x, len = s_run[r].y;
    // element e of the run's row is the neighbour of node q under slot
    // s0 + e - q; the window holds elements t .. t + kR - 1, element e in
    // register e % kR
    const int row = base + s_off[s0];
    Nb win[kR];
#pragma unroll
    for (int e = 0; e < kR - 1; ++e)
      win[e] = load_nb(tile + row + e, s_cls + row + e);
    for (int t = 0; t < len; t += kR) {   // t % kR == 0
#pragma unroll
      for (int u = 0; u < kR; ++u) {
        if (t + u < len) {
          const int at = row + t + u + kR - 1;
          win[(u + kR - 1) % kR] = load_nb(tile + at, s_cls + at);
          const int s = s0 + t + u;
          const float4 c = s_coef[2 * s];
          const float vol = s_coef[2 * s + 1].x;
#pragma unroll
          for (int q = 0; q < kR; ++q)
            add_bond(diff[q], adv[q], win[(u + q) % kR], own[q], fi[q], c,
                     vol, beta, D_L, alpha_art, dx);
        }
      }
    }
  }

  const float dt = *dt_ptr;
#pragma unroll
  for (int q = 0; q < kR; ++q) {
    if (active & (1u << q)) {
      const float cn = own[q].c + dt * (diff[q] - div_coeff * adv[q]);
      C_out[j * nx + i0 + q] = cn < 0.0f ? 0.0f : cn;
    }
  }
}

size_t smem_bytes(int S, int nruns) {
  return 2 * S * sizeof(float4) + nruns * sizeof(int2) +
         kFields * kField * sizeof(float) + S * sizeof(int) + kField;
}

}  // namespace

// (TX, TY, R, halo, row pitch, threads a block, staged positions a block,
// shared-memory bytes of the staged fields and class bytes): what the
// wrapper builds the slot table for
PD_EXPORT void pd_ard2d_geometry(int* out) {
  const int g[8] = {kTX, kTY, kR, kHalo, kPitch, kArdThreads, kEX * kEY,
                    static_cast<int>(kFields * kField * sizeof(float) +
                                     kField)};
  for (int a = 0; a < 8; ++a) out[a] = g[a];
}

// vel: [ny, nx, 2] (8-byte aligned); salt: [ny, nx] bool (one byte); dt:
// one float on the device; slot_off, slot_coef, runs: kernels/ns2d.py
// ns2d_tables for this tile's pitch (slot_coef 16-byte aligned).
PD_EXPORT int pd_ard2d(const float* C, const float* vel, const float* vmag,
                       const uint8_t* node_type, const float* Ds,
                       const uint8_t* salt, const float* dt,
                       const int* slot_off,
                       const float* slot_coef, const int* runs, int S,
                       int nruns, int ny, int nx, float beta, float D_L,
                       float two_D_L, float alpha_art, float dx,
                       float div_coeff, float* C_out, int device,
                       void* stream) {
  if (S < 1 || S > pd::kMaxSlots || nruns < 1 || nruns > S || ny < 1 ||
      nx < 1 || (ny + kTY - 1) / kTY > 65535 || device < 0 ||
      device >= kMaxDevices ||
      reinterpret_cast<uintptr_t>(slot_coef) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(vel) % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t bytes = smem_bytes(S, nruns);
  // the most dynamic shared memory asked for so far, per device
  static size_t allowed[kMaxDevices] = {};
  if (bytes > allowed[device]) {
    err = cudaFuncSetAttribute(ard2d_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    allowed[device] = bytes;
  }
  const dim3 grid((nx + kTX - 1) / kTX, (ny + kTY - 1) / kTY);
  ard2d_kernel<<<grid, kArdThreads, bytes,
                 static_cast<cudaStream_t>(stream)>>>(
      C, reinterpret_cast<const float2*>(vel), vmag, node_type, Ds, salt, dt,
      slot_off, reinterpret_cast<const float4*>(slot_coef),
      reinterpret_cast<const int2*>(runs), S, nruns, ny, nx, beta, D_L,
      two_D_L, alpha_art, dx, div_coeff, C_out);
  return static_cast<int>(cudaGetLastError());
}
