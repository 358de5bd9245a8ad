// ns2d: one explicit 2D peridynamic Navier-Stokes step (f32).
//
// Replaces: pd_mg_pin_corrosion_tpu/pallas_kernels.py, _ns_kernel (body)
// and ns_step_pallas (entry); math of ops/ns.py ns_step (reference
// src/pd_ns.cpp:78-180).
//
// Contract (plain twin: kernels/ns2d.py ns2d_plain; the staged walk below in
// PyTorch: ns2d_staged_plain):
//   * neighbours are weighted by V = vol * act_j, act = (node_type !=
//     OUTSIDE); a neighbour outside the grid counts as act = 0;
//   * a FLUID node's 8 accumulators take one term per slot in reference
//     stencil order, every term is the plain version's expression, operation
//     for operation, and every accumulator is acc = acc + term, so with FMA
//     contraction off (-fmad=false) the result equals the plain PyTorch
//     version bit for bit. How nodes are spread over threads and what is
//     staged where does not enter a node's sum;
//   * terms scaled by an exactly-zero bond-direction component (axis bonds)
//     are skipped: the plain version adds an exact +-0 there. An OUTSIDE or
//     off-grid neighbour is staged as +0 with act = 0 (a select on
//     node_type, not a multiply: an inf or nan stored in an OUTSIDE node
//     never reaches a sum), so its terms are exact zeros of either sign.
//     Adding them leaves every accumulator's bits: an accumulator starts at
//     +0, +0 + -0 is +0 and a sum of two nonzero floats that cancels is +0
//     under round-to-nearest, so none is ever -0, and x + (+-0) is x for
//     every other x. Both hold for finite values: the twin multiplies an
//     OUTSIDE neighbour's own values by 0 (an inf there gives a nan in the
//     twin), and a zero e component times an inf is a nan in the twin;
//   * rho is clamped to [rho_lo, rho_hi] = [0.5, 2] rho_f; only FLUID
//     nodes are updated, every other node is copied through.
//
// What bounds it on an H100: arithmetic issue. At the fine-calibration grid
// (567 x 347 = 196,749 nodes, 185,280 FLUID, S = 36) a call streams 29
// B/node of unique data (rho, vel[2], p, node_type in; rho, vel[2] out),
// 5.7 MB, ~2 us of HBM time, and does ~45 flops per bond, 318 MFLOP as
// chip_smoke.py counts them: 4.8 us at the 67 TFLOP/s peak, which counts a
// fused multiply-add as two. With contraction off (the contract above) each
// counted flop is one instruction, so ~9.5 us of issue slots on 132 SMs at
// 1.98 GHz is the floor of this arithmetic, before any load. The
// one-thread-per-node form before this one spent about as many issue slots
// again a bond on seven shared-memory table words, four bounds compares and
// an index rebuild, a node_type byte and four field loads (vel 8 bytes
// apart), and ran at 32 us; this one runs at 20 us back to back, 23 us
// behind another kernel (H100 80GB HBM3, 700 W; PERF.md). Its code spends
// 47 instructions a bond and node with both e components (34 on an axis
// bond) and 22 a window step (5 loads, the six products, the table, the
// form's test), and issues at ~60 % of the peak: what is left of the floor
// is the window's overhead, issue efficiency and the one wave's ramp, not
// the tile (scripts/sweep_kernels_torch.py ns2d: R = 1, 2 and 4 and tiles
// of 16 x 16 to 64 x 16 all land within 19.6-25.4 us; the bonds' full
// two-component form, without the zero-e branches, measured the same).
//
// Design: ns3d's staged form (csrc/ns3d.cu) in 2D.
//   * A block owns a tile of kTX x kTY nodes and stages the tile and its
//     halo of kHalo = 3 (every offset of an m_ratio = 3 stencil) in shared
//     memory as five planar fields (rho, vx, vy, p, act), masked as above;
//     the de-interleave of vel happens in the staging loads (one 8-byte load
//     a position). The bounds compares, the node_type loads and the strided
//     velocity reads leave the bond loop. Tiles without a FLUID node leave
//     after the copy-through.
//   * The slot table (built once per kit by kernels/ns2d.py ns2d_tables)
//     holds per slot one int, its offset inside the tile, and two float4,
//     its five coefficients; and the runs: maximal stretches of slots of
//     one dj whose di are consecutive (the kit's order is dj outer, di
//     inner: 8 runs at S = 36, dj = 0 split by the hole at di = 0).
//   * A thread owns kR consecutive x nodes of one row and walks a run along
//     x with a window of kR positions in registers: each step loads one new
//     position (5 loads), forms its six j-side products once (m = rho v and
//     the four m v) for the kR nodes that use it, loads the slot's
//     coefficients and serves its kR nodes. The walk is unrolled kR steps so
//     the window rotates by renaming, not by moves. Each node still adds its
//     terms in slot order; a slot's zero e component picks one of three
//     forms of the bond (uniform across the block, so no divergence).
//   * A warp covers kWX x (32 / kWX) threads of the tile: threads adjacent
//     in x read shared memory kR words apart, so the row pitch is padded
//     (PD_NS2D_PAD) to an odd number of words, which puts the warp's rows
//     into other banks than its columns.
//   * Defaults (the sweep's best): tiles of 32 x 16, 2 x nodes a thread, 256
//     threads, 80 registers, 3 blocks an SM: the 396 tiles of the
//     fine-calibration grid are one wave on 132 SMs.
// The tile's sizes are compile-time constants (#ifndef, swept by
// scripts/sweep_kernels_torch.py ns2d); pd_ns2d_geometry reports them to
// the wrapper, which builds the table for them.

#include "common.cuh"

namespace {

#ifndef PD_NS2D_R
#define PD_NS2D_R 2       // consecutive x nodes a thread owns
#endif
#ifndef PD_NS2D_TX
#define PD_NS2D_TX 32     // tile extent in x (the contiguous axis), in nodes
#endif
#ifndef PD_NS2D_TY
#define PD_NS2D_TY 16     // tile extent in y
#endif
#ifndef PD_NS2D_WX
#define PD_NS2D_WX 16     // a warp covers WX x (32 / WX) threads
#endif
#ifndef PD_NS2D_PAD
#define PD_NS2D_PAD 1     // floats added to the tile's row pitch
#endif
#ifndef PD_NS2D_BLOCKS
#define PD_NS2D_BLOCKS 3  // blocks an SM should hold (caps the registers)
#endif

constexpr int kHalo = 3;
constexpr int kR = PD_NS2D_R;
constexpr int kTX = PD_NS2D_TX, kTY = PD_NS2D_TY;
constexpr int kXT = kTX / kR;                 // threads along x
constexpr int kWX = PD_NS2D_WX, kWY = 32 / kWX;
constexpr int kNWX = kXT / kWX;               // warps along x
constexpr int kNsThreads = kXT * kTY;
constexpr int kEX = kTX + 2 * kHalo;          // staged extents
constexpr int kEY = kTY + 2 * kHalo;
constexpr int kPitch = kEX + PD_NS2D_PAD;     // floats between two rows
constexpr int kField = kPitch * kEY;          // floats of one staged field
constexpr int kFields = 5;                    // rho, vx, vy, p, act
constexpr int kMaxDevices = 64;

static_assert(kR >= 1 && kR <= 8 && kTX % kR == 0, "nodes per thread");
static_assert(32 % kWX == 0 && kXT % kWX == 0 && kTY % kWY == 0,
              "a tile is a whole number of warps");
static_assert(kNsThreads % 32 == 0 && kNsThreads <= 1024, "block size");

// one staged position as a neighbour: its fields and the j-side products
// of the plain version (mx = rho vx, my = rho vy, then mx vx, mx vy, my vx,
// my vy), formed once for the kR nodes that use it
struct Nb {
  float r, vx, vy, p, act, mx, my, qxx, qxy, qyx, qyy;
};

// a node's own values and its i-side products, formed as the plain version
// forms them
struct Own {
  float r, vx, vy, p, mx, my, qxx, qxy, qyx, qyy;
};

__device__ __forceinline__ Nb load_nb(const float* t) {
  Nb e;
  e.r = t[0], e.vx = t[kField], e.vy = t[2 * kField];
  e.p = t[3 * kField], e.act = t[4 * kField];
  e.mx = e.r * e.vx, e.my = e.r * e.vy;
  e.qxx = e.mx * e.vx, e.qxy = e.mx * e.vy;
  e.qyx = e.my * e.vx, e.qyy = e.my * e.vy;
  return e;
}

// one bond's 8 terms (mass conv, mass diff, conv xy, pres xy, visc xy) into
// a node's accumulators, in the plain version's operations; kForm 0: both e
// components nonzero, 1: e_y = 0, 2: e_x = 0 (the zero component's terms
// are exact +-0 in the plain version and are skipped)
template <int kForm>
__device__ __forceinline__ void add_bond(float (&a)[8], const Nb& e,
                                         const Own& n, float4 c, float vol,
                                         float dens) {
  const float ixi = c.x, ixi2 = c.y, ex = c.z, ey = c.w;
  const float V = vol * e.act;
  float flux, tx, ty;
  if constexpr (kForm == 0) {
    flux = (e.mx - n.mx) * ex + (e.my - n.my) * ey;
    tx = (e.qxx - n.qxx) * ex + (e.qxy - n.qxy) * ey;
    ty = (e.qyx - n.qyx) * ex + (e.qyy - n.qyy) * ey;
  } else if constexpr (kForm == 1) {
    flux = (e.mx - n.mx) * ex;
    tx = (e.qxx - n.qxx) * ex;
    ty = (e.qyx - n.qyx) * ex;
  } else {
    flux = (e.my - n.my) * ey;
    tx = (e.qxy - n.qxy) * ey;
    ty = (e.qyy - n.qyy) * ey;
  }
  a[0] = a[0] + flux * ixi * V;
  a[1] = a[1] + dens * (e.r - n.r) * ixi2 * V;
  a[2] = a[2] + tx * ixi * V;
  a[3] = a[3] + ty * ixi * V;
  const float dp = e.p - n.p;
  if (kForm != 2) a[4] = a[4] + dp * ex * ixi * V;
  if (kForm != 1) a[5] = a[5] + dp * ey * ixi * V;
  a[6] = a[6] + (e.vx - n.vx) * ixi2 * V;
  a[7] = a[7] + (e.vy - n.vy) * ixi2 * V;
}

// one slot for the kR nodes: node q's neighbour is window register
// (u + q) % kR
template <int kForm>
__device__ __forceinline__ void add_slot(float (&acc)[kR][8],
                                         const Nb (&win)[kR],
                                         const Own (&own)[kR], int u,
                                         float4 c, float vol, float dens) {
#pragma unroll
  for (int q = 0; q < kR; ++q)
    add_bond<kForm>(acc[q], win[(u + q) % kR], own[q], c, vol, dens);
}

__global__ void __launch_bounds__(kNsThreads, PD_NS2D_BLOCKS)
ns2d_kernel(const float* __restrict__ rho, const float2* __restrict__ vel,
            const float* __restrict__ p, const uint8_t* __restrict__ nt,
            const float* __restrict__ dt_ptr,
            const int* __restrict__ slot_off,
            const float4* __restrict__ slot_coef,
            const int2* __restrict__ runs, int S, int nruns, int ny, int nx,
            float dens, float a_inv_vh, float visc, float rho_lo,
            float rho_hi, float* __restrict__ rho_out,
            float2* __restrict__ vel_out) {
  // [S][2] float4 coefficients (1/xi, 1/xi^2, e_x, e_y | vol, -, -, -),
  // [nruns] (first slot, length), 5 fields of kField floats, [S] offsets
  extern __shared__ float4 smem4[];
  float4* s_coef = smem4;
  int2* s_run = reinterpret_cast<int2*>(smem4 + 2 * S);
  float* tile = reinterpret_cast<float*>(s_run + nruns);
  int* s_off = reinterpret_cast<int*>(tile + kFields * kField);

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int tx = (warp % kNWX) * kWX + lane % kWX;   // thread column
  const int ty = (warp / kNWX) * kWY + lane / kWX;   // tile row
  const int x0 = blockIdx.x * kTX, y0 = blockIdx.y * kTY;
  const int i0 = x0 + tx * kR, j = y0 + ty;

  // own nodes: copy the ones that are not FLUID through, note the others
  unsigned fluid = 0u;
  if (j < ny) {
#pragma unroll
    for (int q = 0; q < kR; ++q) {
      if (i0 + q < nx) {
        const int n = j * nx + i0 + q;
        if (nt[n] == pd::kFluid) {
          fluid |= 1u << q;
        } else {
          rho_out[n] = rho[n];
          vel_out[n] = vel[n];
        }
      }
    }
  }
  if (!__syncthreads_or(fluid != 0u)) return;

  // the tables
  for (int s = tid; s < S; s += kNsThreads) {
    s_coef[2 * s] = slot_coef[2 * s];
    s_coef[2 * s + 1] = slot_coef[2 * s + 1];
    s_off[s] = slot_off[s];
  }
  for (int r = tid; r < nruns; r += kNsThreads) s_run[r] = runs[r];

  // the tile and its halo: OUTSIDE and off-grid positions read as +0, act 0
  for (int e = tid; e < kEX * kEY; e += kNsThreads) {
    const int ex = e % kEX, ey = e / kEX;
    const int gx = x0 + ex - kHalo, gy = y0 + ey - kHalo;
    const bool inside = gx >= 0 && gx < nx && gy >= 0 && gy < ny;
    const int m = inside ? gy * nx + gx : 0;
    const bool act = inside && nt[m] != pd::kOutside;
    const float r = rho[m], pm = p[m];
    const float2 v = vel[m];
    float* t = tile + ey * kPitch + ex;
    t[0] = act ? r : 0.0f;
    t[kField] = act ? v.x : 0.0f;
    t[2 * kField] = act ? v.y : 0.0f;
    t[3 * kField] = act ? pm : 0.0f;
    t[4 * kField] = act ? 1.0f : 0.0f;
  }
  __syncthreads();
  if (fluid == 0u) return;

  // the tile index of this thread's first node, less the halo (the table's
  // offsets carry it), and the own nodes' values
  const float* base = tile + ty * kPitch + tx * kR;
  Own own[kR];
#pragma unroll
  for (int q = 0; q < kR; ++q) {
    const float* c = base + kHalo * (kPitch + 1) + q;
    Own& o = own[q];
    o.r = c[0], o.vx = c[kField], o.vy = c[2 * kField], o.p = c[3 * kField];
    o.mx = o.r * o.vx, o.my = o.r * o.vy;
    o.qxx = o.mx * o.vx, o.qxy = o.mx * o.vy;
    o.qyx = o.my * o.vx, o.qyy = o.my * o.vy;
  }
  float acc[kR][8];
#pragma unroll
  for (int q = 0; q < kR; ++q)
#pragma unroll
    for (int a = 0; a < 8; ++a) acc[q][a] = 0.0f;

  for (int r = 0; r < nruns; ++r) {
    const int s0 = s_run[r].x, len = s_run[r].y;
    // element e of the run's row is the neighbour of node q under slot
    // s0 + e - q; the window holds elements t .. t + kR - 1, element e in
    // register e % kR
    const float* row = base + s_off[s0];
    Nb win[kR];
#pragma unroll
    for (int e = 0; e < kR - 1; ++e) win[e] = load_nb(row + e);
    for (int t = 0; t < len; t += kR) {   // t % kR == 0
#pragma unroll
      for (int u = 0; u < kR; ++u) {
        if (t + u < len) {
          win[(u + kR - 1) % kR] = load_nb(row + t + u + kR - 1);
          const int s = s0 + t + u;
          const float4 c = s_coef[2 * s];
          const float vol = s_coef[2 * s + 1].x;
          if (c.z != 0.0f && c.w != 0.0f)
            add_slot<0>(acc, win, own, u, c, vol, dens);
          else if (c.z != 0.0f)
            add_slot<1>(acc, win, own, u, c, vol, dens);
          else
            add_slot<2>(acc, win, own, u, c, vol, dens);
        }
      }
    }
  }

  const float dt = *dt_ptr;
  const float neg_a = -a_inv_vh;
#pragma unroll
  for (int q = 0; q < kR; ++q) {
    if (fluid & (1u << q)) {
      const int n = j * nx + i0 + q;
      const Own& o = own[q];
      float rn = o.r + dt * (neg_a * acc[q][0] + acc[q][1]);
      // clip that keeps a NaN (the flow solve's divergence check looks for
      // it)
      rn = rn < rho_lo ? rho_lo : rn;
      rn = rn > rho_hi ? rho_hi : rn;
      const float scale = dt * (1.0f / o.r);
      rho_out[n] = rn;
      vel_out[n] = make_float2(
          o.vx + scale * ((neg_a * acc[q][2] - a_inv_vh * acc[q][4]) +
                          visc * acc[q][6]),
          o.vy + scale * ((neg_a * acc[q][3] - a_inv_vh * acc[q][5]) +
                          visc * acc[q][7]));
    }
  }
}

size_t smem_bytes(int S, int nruns) {
  return 2 * S * sizeof(float4) + nruns * sizeof(int2) +
         kFields * kField * sizeof(float) + S * sizeof(int);
}

}  // namespace

// (TX, TY, R, halo, row pitch, threads a block, staged positions a block,
// shared-memory bytes of the staged fields): what the wrapper builds the
// slot table for
PD_EXPORT void pd_ns2d_geometry(int* out) {
  const int g[8] = {kTX, kTY, kR, kHalo, kPitch, kNsThreads, kEX * kEY,
                    static_cast<int>(kFields * kField * sizeof(float))};
  for (int a = 0; a < 8; ++a) out[a] = g[a];
}

// vel, vel_out: [ny, nx, 2] (8-byte aligned); slot_off: [S] int, each
// slot's offset in the tile from a node's own position less the halo, (dj +
// halo) * pitch + di + halo; slot_coef: [S][8] float (16-byte aligned):
// 1/xi, 1/xi^2, e_x, e_y, vol, 0, 0, 0; runs: [nruns][2] int (first slot,
// length), the slots of a run one apart in slot_off.
PD_EXPORT int pd_ns2d(const float* rho, const float* vel, const float* p,
                      const uint8_t* node_type, const float* dt,
                      const int* slot_off, const float* slot_coef,
                      const int* runs, int S, int nruns, int ny, int nx,
                      float dens, float a_inv_vh, float visc, float rho_lo,
                      float rho_hi, float* rho_out, float* vel_out,
                      int device, void* stream) {
  if (S < 1 || S > pd::kMaxSlots || nruns < 1 || nruns > S || ny < 1 ||
      nx < 1 || (ny + kTY - 1) / kTY > 65535 || device < 0 ||
      device >= kMaxDevices ||
      reinterpret_cast<uintptr_t>(slot_coef) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(vel) % 8 != 0 ||
      reinterpret_cast<uintptr_t>(vel_out) % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t bytes = smem_bytes(S, nruns);
  // the most dynamic shared memory asked for so far, per device
  static size_t allowed[kMaxDevices] = {};
  if (bytes > allowed[device]) {
    err = cudaFuncSetAttribute(ns2d_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    allowed[device] = bytes;
  }
  const dim3 grid((nx + kTX - 1) / kTX, (ny + kTY - 1) / kTY);
  ns2d_kernel<<<grid, kNsThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      rho, reinterpret_cast<const float2*>(vel), p, node_type, dt, slot_off,
      reinterpret_cast<const float4*>(slot_coef),
      reinterpret_cast<const int2*>(runs), S, nruns, ny, nx, dens, a_inv_vh,
      visc, rho_lo, rho_hi, rho_out, reinterpret_cast<float2*>(vel_out));
  return static_cast<int>(cudaGetLastError());
}

PD_EXPORT const char* pd_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
