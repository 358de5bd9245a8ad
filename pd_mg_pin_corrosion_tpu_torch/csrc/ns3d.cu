// ns3d: one explicit 3D peridynamic Navier-Stokes step (f32).
//
// Replaces: pd_mg_pin_corrosion_tpu/pallas_kernels.py, _ns_kernel_3d
// (body) and ns_step_pallas_3d (entry); physics of ops/ns.py ns_step in its
// 3D form (reference src/pd_ns.cpp:78-180).
//
// Form: the TPU kernel's act-static form, not the XLA form's term-by-term
// bond differences. act = (node_type != OUTSIDE) never changes over a run,
// so every bond term c_s act_j (f_j - f_i) splits into a j-side sum
// sum_s c_s (act f)_j, accumulated here, and an i-side term f_i B[c] taken
// once at the end from the precomputed pure-act sums B = (B2, Bx, By, Bz)
// (kit.actconv3d). Why this form: in float32 the two forms round
// differently, and the flagship's slowly converging flow is sensitive to
// it. With the XLA form the flow at config/params_3d.cfg stopped 100
// iterations before the banked run and C_max_fluid sat 5.9 % below it;
// with this form the flow stops where the banked run's did, at the same
// eps, and C_max_fluid agrees to 1e-4 (PERF.md). It is also half the
// arithmetic per bond.
//
// Contract (plain twin: kernels/ns3d.py ns3d_plain; the staged walk below in
// PyTorch: ns3d_staged_plain):
//   * a FLUID node's 11 accumulators take one term per slot, in
//     kit.ns_slots order (the TPU kernel's: grouped by (dj, di), dk
//     ascending within a group), with the coefficients kit.ns_coefs =
//     (vol/xi^2, e_x vol/xi, e_y vol/xi, e_z vol/xi);
//   * every per-bond term is the plain version's expression, operation for
//     operation (zero e components included: x * 0 is an exact +-0), and
//     every accumulator is acc = acc + term, so with FMA contraction off
//     (-fmad=false) the result equals the plain PyTorch version bit for bit.
//     How nodes are spread over threads and what is staged where does not
//     enter a node's sum;
//   * a neighbour outside the grid or OUTSIDE contributes nothing. Here its
//     five field values are staged as +0 (a select on node_type, not a
//     multiply, so an inf or nan stored in an OUTSIDE node never reaches a
//     sum: it is dropped, as the twin's torch.where drops it), and its
//     terms are then exact zeros of either sign. Adding them leaves every
//     accumulator's bits as skipping them would: an accumulator starts at
//     +0, +0 + -0 is +0, and a sum of two nonzero floats that cancels is +0
//     under round-to-nearest, so no accumulator is ever -0, and x + (+-0)
//     is x for every other x, inf and nan included. An inf or nan in a node
//     that is not OUTSIDE takes part in its neighbours' sums, as in the
//     twin;
//   * rho is clamped to [rho_lo, rho_hi] = [0.5, 2] rho_f; only FLUID
//     nodes are updated, every other node is copied through.
//
// What bounds it on an H100: arithmetic issue. At the flagship grid (157 x
// 82 x 82 = 1,055,668 nodes, 629,000 FLUID, S = 178) a call streams 53
// B/node of unique data (56 MB, ~17 us of HBM time) and does 29 flops per
// bond, 3.25 GFLOP: 49 us at the 67 TFLOP/s peak, which counts a fused
// multiply-add as two. With contraction off (the contract above) the 29
// flops are 29 instructions, so ~0.1 ms of issue slots on 132 SMs at
// 1.98 GHz is the floor of this arithmetic, before any load. Whatever else
// a bond costs is issue slots too: the one-thread-per-node form before this
// one spent ~25 more of them a bond (seven table words, six bounds
// compares, an index rebuild, a node_type byte and five field loads, three
// of them 12 bytes apart) and ran at 0.59 ms. This form runs at 0.23 ms
// (H100 80GB HBM3, 700 W), 42 % of that floor; what is left, by the
// sweep's evidence (tile shapes, 2 to 8 nodes a thread and 1 to 4 blocks an
// SM all land within 0.23-0.30 ms): lanes of part-FLUID warps at the tube's
// round wall, the last wave of tiles (920 tiles with a FLUID node over 264
// resident blocks), the staging of 4.2 positions per node of a tile, and
// the share of the issue peak that unfused f32 code reaches.
//
// Design: fields staged once, a two-word table, and z walked in registers.
//   * A block owns a tile of kTX x kTY x kTZ nodes and stages the tile and
//     its halo of kHalo = 3 (every offset of an m_ratio = 3 stencil) in
//     shared memory as five planar fields (rho, vx, vy, vz, p), masked as
//     above. The bounds compares, the node_type loads and the strided
//     velocity reads leave the bond loop; the de-interleave of vel happens
//     in the staging loads. Tiles without a FLUID node leave after the
//     copy-through.
//   * The slot table (built once per kit by kernels/ns3d.py ns3d_tables)
//     holds per slot one int, its offset inside the tile, and one float4,
//     its four coefficients; and the runs: maximal stretches of slots of
//     one (dj, di) whose dk are consecutive (37 groups give 38 runs at
//     S = 178: the centre group has a hole at dk = 0).
//   * A thread owns kR consecutive z of one (y, x) column and walks a run
//     along z with a window of kR values per field in registers: each step
//     loads one new value per field (5 loads) and one float4 of
//     coefficients and serves its kR nodes, so a bond costs (5 + 1) / kR
//     loads plus the window's refill at the start of a run, instead of 13.
//     The walk is unrolled kR steps so the window rotates by renaming, not
//     by moves. Each node still adds its terms in slot order.
//   * A warp covers kWX x (32 / kWX) columns of a z plane and the tile's
//     row pitch is padded (kPad) so that its rows fall into different
//     shared-memory banks; compact warps also leave the tube's round
//     cross-section with fewer part-FLUID warps than 32 x 1 ones.
// The tile's sizes are compile-time constants (#ifndef, swept by
// scripts/sweep_kernels_torch.py); pd_ns3d_geometry reports them to the
// wrapper, which builds the table for them.

#include "common.cuh"

namespace {

#ifndef PD_NS3D_R
#define PD_NS3D_R 4       // consecutive z nodes a thread owns
#endif
#ifndef PD_NS3D_TX
#define PD_NS3D_TX 16     // tile extent in x (the contiguous axis)
#endif
#ifndef PD_NS3D_TY
#define PD_NS3D_TY 8      // tile extent in y
#endif
#ifndef PD_NS3D_ZT
#define PD_NS3D_ZT 2      // threads along z; the tile holds ZT * R planes
#endif
#ifndef PD_NS3D_WX
#define PD_NS3D_WX 8      // a warp covers WX x (32 / WX) columns
#endif
#ifndef PD_NS3D_PAD
#define PD_NS3D_PAD 2     // floats added to the tile's row pitch
#endif
#ifndef PD_NS3D_BLOCKS
#define PD_NS3D_BLOCKS 2  // blocks an SM should hold (caps the registers)
#endif

constexpr int kHalo = 3;
constexpr int kR = PD_NS3D_R;
constexpr int kTX = PD_NS3D_TX, kTY = PD_NS3D_TY, kZT = PD_NS3D_ZT;
constexpr int kTZ = kZT * kR;
constexpr int kWX = PD_NS3D_WX, kWY = 32 / kWX;
constexpr int kNWX = kTX / kWX, kNWY = kTY / kWY;
constexpr int kNsThreads = kTX * kTY * kZT;
constexpr int kEX = kTX + 2 * kHalo;          // staged extents
constexpr int kEY = kTY + 2 * kHalo;
constexpr int kEZ = kTZ + 2 * kHalo;
constexpr int kPitch = kEX + PD_NS3D_PAD;     // floats between two rows
constexpr int kPlane = kPitch * kEY;          // floats between two z planes
constexpr int kField = kPlane * kEZ;          // floats of one staged field
constexpr int kFields = 5;                    // rho, vx, vy, vz, p
constexpr int kMaxDevices = 64;

static_assert(32 % kWX == 0 && kTX % kWX == 0 && kTY % kWY == 0,
              "a tile is a whole number of warps");
static_assert(kNsThreads % 32 == 0 && kNsThreads <= 1024, "block size");
static_assert(kR >= 1 && kR <= 8, "nodes per thread");

// one bond's terms into a node's accumulators (mass conv, mass diff, conv
// xyz, pres xyz, visc xyz), in the plain version's operations
__device__ __forceinline__ void add_bond(float (&a)[11], float rj, float vxj,
                                         float vyj, float vzj, float pj,
                                         float4 c) {
  const float c2 = c.x, ex = c.y, ey = c.z, ez = c.w;
  const float fdj = ((rj * vxj) * ex + (rj * vyj) * ey) + (rj * vzj) * ez;
  a[0] = a[0] + fdj;
  a[1] = a[1] + rj * c2;
  a[2] = a[2] + vxj * fdj;
  a[3] = a[3] + vyj * fdj;
  a[4] = a[4] + vzj * fdj;
  a[5] = a[5] + pj * ex;
  a[6] = a[6] + pj * ey;
  a[7] = a[7] + pj * ez;
  a[8] = a[8] + vxj * c2;
  a[9] = a[9] + vyj * c2;
  a[10] = a[10] + vzj * c2;
}

__global__ void __launch_bounds__(kNsThreads, PD_NS3D_BLOCKS)
ns3d_kernel(const float* __restrict__ rho, const float* __restrict__ vel,
            const float* __restrict__ p, const uint8_t* __restrict__ nt,
            const float* __restrict__ dt_ptr,
            const int* __restrict__ slot_off,
            const float4* __restrict__ slot_coef,
            const int2* __restrict__ runs, const float* __restrict__ actconv,
            int S, int nruns, int nz, int ny, int nx, float dens,
            float a_inv_vh, float visc, float rho_lo, float rho_hi,
            float* __restrict__ rho_out, float* __restrict__ vel_out) {
  // [S] float4 coefficients, [nruns] (first slot, length), 5 fields of
  // kField floats, [S] tile offsets
  extern __shared__ float4 smem4[];
  float4* s_coef = smem4;
  int2* s_run = reinterpret_cast<int2*>(smem4 + S);
  float* tile = reinterpret_cast<float*>(s_run + nruns);
  int* s_off = reinterpret_cast<int*>(tile + kFields * kField);

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int tx = (warp % kNWX) * kWX + lane % kWX;
  const int ty = ((warp / kNWX) % kNWY) * kWY + lane / kWX;
  const int tz = warp / (kNWX * kNWY);
  const int x0 = blockIdx.x * kTX, y0 = blockIdx.y * kTY;
  const int z0 = blockIdx.z * kTZ;
  const int i = x0 + tx, j = y0 + ty, k0 = z0 + tz * kR;
  const int plane = ny * nx;

  // own nodes: copy the ones that are not FLUID through, note the others
  unsigned fluid = 0u;
  if (i < nx && j < ny) {
#pragma unroll
    for (int q = 0; q < kR; ++q) {
      if (k0 + q < nz) {
        const int n = (k0 + q) * plane + j * nx + i;
        if (nt[n] == pd::kFluid) {
          fluid |= 1u << q;
        } else {
          rho_out[n] = rho[n];
          vel_out[3 * n] = vel[3 * n];
          vel_out[3 * n + 1] = vel[3 * n + 1];
          vel_out[3 * n + 2] = vel[3 * n + 2];
        }
      }
    }
  }
  if (!__syncthreads_or(fluid != 0u)) return;

  // the tables
  for (int s = tid; s < S; s += kNsThreads) {
    s_coef[s] = slot_coef[s];
    s_off[s] = slot_off[s];
  }
  for (int r = tid; r < nruns; r += kNsThreads) s_run[r] = runs[r];

  // the tile and its halo: OUTSIDE and off-grid positions read as +0
  for (int e = tid; e < kEX * kEY * kEZ; e += kNsThreads) {
    const int ex = e % kEX, ey = (e / kEX) % kEY, ez = e / (kEX * kEY);
    const int gx = x0 + ex - kHalo, gy = y0 + ey - kHalo;
    const int gz = z0 + ez - kHalo;
    const bool inside = gx >= 0 && gx < nx && gy >= 0 && gy < ny && gz >= 0 &&
                        gz < nz;
    const int m = inside ? gz * plane + gy * nx + gx : 0;
    const bool act = inside && nt[m] != pd::kOutside;
    const float r = rho[m], pm = p[m];
    const float vx = vel[3 * m], vy = vel[3 * m + 1], vz = vel[3 * m + 2];
    float* t = tile + ez * kPlane + ey * kPitch + ex;
    t[0] = act ? r : 0.0f;
    t[kField] = act ? vx : 0.0f;
    t[2 * kField] = act ? vy : 0.0f;
    t[3 * kField] = act ? vz : 0.0f;
    t[4 * kField] = act ? pm : 0.0f;
  }
  __syncthreads();
  if (fluid == 0u) return;

  // the tile index of this thread's first node, less the halo (the table's
  // offsets carry it)
  const float* own = tile + (tz * kR) * kPlane + ty * kPitch + tx;
  float acc[kR][11];
#pragma unroll
  for (int q = 0; q < kR; ++q)
#pragma unroll
    for (int a = 0; a < 11; ++a) acc[q][a] = 0.0f;

  for (int r = 0; r < nruns; ++r) {
    const int s0 = s_run[r].x, len = s_run[r].y;
    // element e of the run's column is the neighbour of node q under slot
    // s0 + e - q; the window holds elements t .. t + kR - 1, element e in
    // register e % kR
    const float* col = own + s_off[s0];
    const float4* coef = s_coef + s0;
    float win[kFields][kR];
#pragma unroll
    for (int e = 0; e < kR - 1; ++e)
#pragma unroll
      for (int f = 0; f < kFields; ++f)
        win[f][e] = col[f * kField + e * kPlane];
    for (int t = 0; t < len; t += kR) {   // t % kR == 0
#pragma unroll
      for (int u = 0; u < kR; ++u) {
        if (t + u < len) {
#pragma unroll
          for (int f = 0; f < kFields; ++f)
            win[f][(u + kR - 1) % kR] =
                col[f * kField + (t + u + kR - 1) * kPlane];
          const float4 c = coef[t + u];
#pragma unroll
          for (int q = 0; q < kR; ++q)
            add_bond(acc[q], win[0][(u + q) % kR], win[1][(u + q) % kR],
                     win[2][(u + q) % kR], win[3][(u + q) % kR],
                     win[4][(u + q) % kR], c);
        }
      }
    }
  }

  // the i-side terms, once per FLUID node
  const size_t N = static_cast<size_t>(nz) * plane;
  const float dt = *dt_ptr;
  const float neg_a = -a_inv_vh;
  const float* centre = own + kHalo * (kPlane + kPitch + 1);
#pragma unroll
  for (int q = 0; q < kR; ++q) {
    if (fluid & (1u << q)) {
      const int n = (k0 + q) * plane + j * nx + i;
      const float* c = centre + q * kPlane;
      const float ri = c[0], vxi = c[kField], vyi = c[2 * kField];
      const float vzi = c[3 * kField], pi = c[4 * kField];
      const float b2 = actconv[n], bx = actconv[N + n];
      const float by = actconv[2 * N + n], bz = actconv[3 * N + n];
      const float F = (ri * vxi * bx + ri * vyi * by) + ri * vzi * bz;
      const float mass_conv = acc[q][0] - F;
      const float mass_diff = acc[q][1] - ri * b2;
      float rn = ri + dt * (neg_a * mass_conv + dens * mass_diff);
      // clip that keeps a NaN (the flow solve's divergence check looks for
      // it)
      rn = rn < rho_lo ? rho_lo : rn;
      rn = rn > rho_hi ? rho_hi : rn;
      const float scale = dt * (1.0f / ri);
      rho_out[n] = rn;
      vel_out[3 * n] =
          vxi + scale * (neg_a * ((acc[q][2] - vxi * F) +
                                  (acc[q][5] - pi * bx)) +
                         visc * (acc[q][8] - vxi * b2));
      vel_out[3 * n + 1] =
          vyi + scale * (neg_a * ((acc[q][3] - vyi * F) +
                                  (acc[q][6] - pi * by)) +
                         visc * (acc[q][9] - vyi * b2));
      vel_out[3 * n + 2] =
          vzi + scale * (neg_a * ((acc[q][4] - vzi * F) +
                                  (acc[q][7] - pi * bz)) +
                         visc * (acc[q][10] - vzi * b2));
    }
  }
}

size_t smem_bytes(int S, int nruns) {
  return S * sizeof(float4) + nruns * sizeof(int2) +
         kFields * kField * sizeof(float) + S * sizeof(int);
}

}  // namespace

// (TX, TY, TZ, R, halo, row pitch, plane pitch, threads a block, staged
// elements a block, shared-memory bytes a block without the tables): what
// the wrapper builds the slot table for
PD_EXPORT void pd_ns3d_geometry(int* out) {
  const int g[10] = {kTX, kTY, kTZ, kR, kHalo, kPitch, kPlane, kNsThreads,
                     kEX * kEY * kEZ,
                     static_cast<int>(kFields * kField * sizeof(float))};
  for (int a = 0; a < 10; ++a) out[a] = g[a];
}

// slot_off: [S] int, each slot's offset in the tile from a node's own
// position less the halo, (dk + halo) * plane + (dj + halo) * pitch + di +
// halo; slot_coef: [S][4] float (16-byte aligned); runs: [nruns][2] int
// (first slot, length), the slots of a run kPlane apart in slot_off.
PD_EXPORT int pd_ns3d(const float* rho, const float* vel, const float* p,
                      const uint8_t* node_type, const float* dt,
                      const int* slot_off, const float* slot_coef,
                      const int* runs, const float* actconv, int S, int nruns,
                      int nz, int ny, int nx, float dens, float a_inv_vh,
                      float visc, float rho_lo, float rho_hi, float* rho_out,
                      float* vel_out, int device, void* stream) {
  if (S < 1 || S > pd::kMaxSlots || nruns < 1 || nruns > S || nz < 1 ||
      ny < 1 || nx < 1 || (nz + kTZ - 1) / kTZ > 65535 ||
      (ny + kTY - 1) / kTY > 65535 || device < 0 || device >= kMaxDevices ||
      reinterpret_cast<uintptr_t>(slot_coef) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t bytes = smem_bytes(S, nruns);
  // the most dynamic shared memory asked for so far, per device
  static size_t allowed[kMaxDevices] = {};
  if (bytes > allowed[device]) {
    err = cudaFuncSetAttribute(ns3d_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    // the L1 serves only the staging loads: give shared memory the rest, so
    // that PD_NS3D_BLOCKS blocks fit an SM
    err = cudaFuncSetAttribute(ns3d_kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return static_cast<int>(err);
    allowed[device] = bytes;
  }
  const dim3 grid((nx + kTX - 1) / kTX, (ny + kTY - 1) / kTY,
                  (nz + kTZ - 1) / kTZ);
  ns3d_kernel<<<grid, kNsThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      rho, vel, p, node_type, dt, slot_off,
      reinterpret_cast<const float4*>(slot_coef),
      reinterpret_cast<const int2*>(runs), actconv, S, nruns, nz, ny, nx, dens,
      a_inv_vh, visc, rho_lo, rho_hi, rho_out, vel_out);
  return static_cast<int>(cudaGetLastError());
}
