// ns3d_chunked: the slot-chunked and j-static variants of the 3D
// peridynamic Navier-Stokes step (f32), four forms of one kernel.
//
// Replaces: scripts/exp_ns3d_chunked.py, _ns_kernel_chunked (body) /
// ns_step_chunked (entry) in its three forms, and _ns_kernel_jstat (body) /
// ns_step_jstat (entry):
//   kXla      ns_step_chunked(factored=False): per-bond f_j - f_i, the XLA
//             form of ops/ns.py, 11 accumulators;
//   kFactored ns_step_chunked(factored=True): the momentum-convection
//             factoring, conv_d = v_jd (e.m_j) - v_id (e.m_i), 11
//             accumulators;
//   kJconv    ns_step_chunked(factored="jconv"): j-side sums only plus the
//             pure-act sums B2, B accumulated in the kernel, the i-side
//             terms taken once at the end, 15 accumulators;
//   kJstat    ns_step_jstat: j-side sums of pre-masked fields, the pure-act
//             sums B = (B2, Bx, By, Bz) an input (compute_actconv), 11
//             accumulators.
//
// Contract (plain twin: kernels/ns3d_chunked.py ns3d_chunked_plain /
// ns3d_jstat_plain; the staged walk below in PyTorch:
// ns3d_chunked_staged_plain):
//   * slots are visited in kit.ns_slots order (grouped by (dj, di), dk
//     order within a group); the groups are split into nchunk contiguous
//     chunks (the script's _group_chunks). Per chunk every accumulator
//     starts at 0, sums the chunk's slots in order, and is then added into
//     the running sum: the TPU kernel's sequential grid axis over chunks
//     (acc_ref[k] += a) is this loop inside the thread;
//   * every per-bond term is the twin's expression, operation for
//     operation, zero e components included (x * 0 is an exact +-0), and
//     every accumulator is acc = acc + term, so with FMA contraction off
//     (-fmad=false) the result equals the plain PyTorch version bit for bit
//     for finite inputs;
//   * p is Tait(rho), formed by the caller (the TPU kernel formed it per
//     window in its prologue); rho is clamped to [0.5, 2] rho_f; only FLUID
//     nodes are updated, every other node is copied through (the TPU
//     chunked kernel's in-kernel select; jstat's select after the kernel).
//
// Neighbours that are OUTSIDE or off the grid. Every position is staged
// masked (+0 for all five fields, a select on node_type) with its act (1 or
// 0) beside it, and every slot's terms are added. In the XLA and factored
// forms each term carries the twin's own factor act_j (V = vol act_j, w2 =
// c2 act_j, (...) act_j), so an OUTSIDE neighbour's term is an exact +-0
// even where it holds an i-side part ((0 - r_i v_i) e is not zero; times
// act_j = 0 it is). In the j-side forms the masked fields make every
// j-side term of such a neighbour +-0 by themselves, so jconv keeps act_j
// only where the twin sums act alone (w2 = c2 act_j, u = e vol/xi act_j)
// and drops the twin's fdj act_j, R w2 and P u for fdj, R c2 and P e vol/xi,
// which equal them at act_j = 1 and are +-0 like them at act_j = 0. Adding
// +-0 leaves every accumulator's bits: an accumulator starts at +0, +0 + -0
// is +0 and a sum of two nonzero floats that cancels is +0 under
// round-to-nearest, so none is ever -0, and x + (+-0) is x for every other
// x. That holds while the fields are finite: the twin multiplies an OUTSIDE
// neighbour's own values by 0.
//
// What bounds it on an H100: arithmetic issue. At the flagship grid (157 x
// 82 x 82 = 1,055,668 nodes, 629,000 FLUID, S = 178) a call must move 37
// B/node of unique data (rho, vel[3], p, node_type in; rho, vel[3] out;
// jstat 16 B/node more for B), ~39 MB, ~12 us of HBM time, against 29-85
// flops a bond (form-dependent), 3.3-9.6 GFLOP, 50-143 us at 67 TFLOP/s and
// twice that as unfused instructions on 132 SMs at 1.98 GHz. The
// one-thread-per-node form before this one spent ~25 more issue slots a
// bond (the table, bounds compares, a node_type byte and five field loads)
// and ran at 0.47-0.75 ms (H100 80GB HBM3, 700 W; PERF.md).
//
// Design: ns3d's staged form (csrc/ns3d.cu), one template over the form
// and the z extent of the tile.
//   * The ladder's BZ (the TPU kernel's VMEM block height) is the tile's z
//     extent: a block owns a tile of kTX x kTY x BZ nodes and stages it
//     with its halo of kHalo = 3 as five planar float fields (rho, vx, vy,
//     vz, p, masked) and, but for jstat, a byte plane of act. The
//     cross-section and the threads along z are chosen per BZ (Rung<BZ>)
//     so the staged tile fits the 227 KB a block may have: BZ = 32 stages
//     38 planes, so its cross-section is smaller. Tiles without a FLUID
//     node leave after the copy-through.
//   * The slot table (kernels/ns3d_chunked.py ns3d_chunked_tables): per
//     slot an int, its offset in the tile, and one float4 of coefficients
//     (c2, e_x vol/xi, e_y vol/xi, e_z vol/xi; the XLA form two: 1/xi,
//     1/xi^2, e_x, e_y | e_z, vol); the runs of one (dj, di) with
//     consecutive dk (ns3d's); and each chunk's end as a run index: a chunk
//     is a run of whole (dj, di) groups, so every chunk end is a run end.
//   * A thread owns kR consecutive z of one (y, x) column and walks a run
//     along z with a window of kR positions in registers, as ns3d does;
//     the block's kZT z rows of threads cover the tile's BZ planes in
//     BZ / (kZT kR) passes. part[] is reset at a chunk's first run and
//     added into acc[] after its last, the twin's order. The i-side values
//     the XLA and factored forms use (r v, r v v) are formed once per node.
//   * Registers set the shape: part[] and acc[] are 22 floats a node (jconv
//     30), so a thread holds 4 nodes only in jstat (128 registers, a
//     56-byte stack) and 2 in the other forms (85-123 registers); at 128
//     registers an SM holds 512 threads, and two blocks of 256 beat one of
//     512, which cannot overlap one tile's staging with another's walk.
//     Hence BZ = 8 and 16 take two blocks of 256 an SM (16 x 8 x 8, 99 KB;
//     8 x 8 x 16, 104 KB, whose 16-float row pitch costs two-way bank
//     conflicts and still beat 16 x 8 x 16 at one block an SM by 10-15 %),
//     and BZ = 32 (8 x 8 x 32, 179 KB) one block of 512.
// The cross-sections, nodes a thread and staging unroll are compile-time
// constants (#ifndef, swept by scripts/sweep_kernels_torch.py
// ns3d_chunked; the defaults are its best, H100 80GB HBM3 at 700 W,
// PERF.md); pd_ns3d_chunked_geometry reports them to the wrapper, which
// builds the table for them.

#include "common.cuh"

namespace {

enum Form { kXla = 0, kFactored = 1, kJconv = 2, kJstat = 3 };

// consecutive z nodes a thread owns, per form (jstat's 22 accumulators a
// node leave room for 4; the others' 22-30 and i-side values for 2)
#ifndef PD_NS3DC_R_XLA
#define PD_NS3DC_R_XLA 2
#endif
#ifndef PD_NS3DC_R_FACTORED
#define PD_NS3DC_R_FACTORED 2
#endif
#ifndef PD_NS3DC_R_JCONV
#define PD_NS3DC_R_JCONV 2
#endif
#ifndef PD_NS3DC_R_JSTAT
#define PD_NS3DC_R_JSTAT 4
#endif
// per rung (BZ = 8, 16, 32): tile extent in x and y, threads along z
#ifndef PD_NS3DC_TX_8
#define PD_NS3DC_TX_8 16
#endif
#ifndef PD_NS3DC_TY_8
#define PD_NS3DC_TY_8 8
#endif
#ifndef PD_NS3DC_ZT_8
#define PD_NS3DC_ZT_8 2
#endif
#ifndef PD_NS3DC_TX_16
#define PD_NS3DC_TX_16 8
#endif
#ifndef PD_NS3DC_TY_16
#define PD_NS3DC_TY_16 8
#endif
#ifndef PD_NS3DC_ZT_16
#define PD_NS3DC_ZT_16 4
#endif
#ifndef PD_NS3DC_TX_32
#define PD_NS3DC_TX_32 8
#endif
#ifndef PD_NS3DC_TY_32
#define PD_NS3DC_TY_32 8
#endif
#ifndef PD_NS3DC_ZT_32
#define PD_NS3DC_ZT_32 8
#endif
#ifndef PD_NS3DC_WX
#define PD_NS3DC_WX 8       // a warp covers WX x (32 / WX) columns
#endif
#ifndef PD_NS3DC_PAD
#define PD_NS3DC_PAD 2      // floats added to the tile's row pitch
#endif
#ifndef PD_NS3DC_UNROLL
#define PD_NS3DC_UNROLL 4   // staged positions a thread loads at once
#endif

constexpr int kHalo = 3;
constexpr int kStageUnroll = PD_NS3DC_UNROLL;
constexpr int kMaxChunks = 64;
constexpr int kMaxDevices = 64;

template <int BZ> struct Rung;
template <> struct Rung<8> {
  static constexpr int kTX = PD_NS3DC_TX_8, kTY = PD_NS3DC_TY_8,
                       kZT = PD_NS3DC_ZT_8;
};
template <> struct Rung<16> {
  static constexpr int kTX = PD_NS3DC_TX_16, kTY = PD_NS3DC_TY_16,
                       kZT = PD_NS3DC_ZT_16;
};
template <> struct Rung<32> {
  static constexpr int kTX = PD_NS3DC_TX_32, kTY = PD_NS3DC_TY_32,
                       kZT = PD_NS3DC_ZT_32;
};

// the tile of one form at one rung
template <int FORM, int BZ>
struct Geo {
  static constexpr int kTX = Rung<BZ>::kTX, kTY = Rung<BZ>::kTY;
  static constexpr int kZT = Rung<BZ>::kZT;
  static constexpr int kR = FORM == kXla        ? PD_NS3DC_R_XLA
                            : FORM == kFactored ? PD_NS3DC_R_FACTORED
                            : FORM == kJconv    ? PD_NS3DC_R_JCONV
                                                : PD_NS3DC_R_JSTAT;
  static constexpr int kPasses = BZ / (kZT * kR);
  static constexpr int kWX = PD_NS3DC_WX, kWY = 32 / kWX;
  static constexpr int kNWX = kTX / kWX, kNWY = kTY / kWY;
  static constexpr int kThreads = kTX * kTY * kZT;
  static constexpr int kEX = kTX + 2 * kHalo, kEY = kTY + 2 * kHalo;
  static constexpr int kEZ = BZ + 2 * kHalo;
  static constexpr int kPitch = kEX + PD_NS3DC_PAD;
  static constexpr int kPlane = kPitch * kEY;
  static constexpr int kField = kPlane * kEZ;
  static constexpr int kActBytes = FORM == kJstat ? 0 : kField;
  static constexpr int kNC = FORM == kXla ? 2 : 1;     // float4 a slot
  static constexpr int kNA = FORM == kJconv ? 15 : 11;  // accumulators
  // 128 registers a thread: 2 blocks of 256 threads or 1 of 512 an SM
  static constexpr int kMinBlocks = kThreads >= 512 ? 1 : 512 / kThreads;
  static_assert(kR >= 1 && kR <= 8 && BZ % (kZT * kR) == 0 &&
                    kPasses * kR <= 32,
                "a tile's z extent is a whole number of thread passes");
  static_assert(32 % kWX == 0 && kTX % kWX == 0 && kTY % kWY == 0,
                "a tile is a whole number of warps");
  static_assert(kThreads % 32 == 0 && kThreads <= 1024, "block size");

  static size_t smem_bytes(int S, int nruns, int nchunk) {
    return S * kNC * sizeof(float4) + nruns * sizeof(int2) +
           5 * kField * sizeof(float) + (S + nchunk) * sizeof(int) +
           kActBytes;
  }
};

// a node's own values and the i-side products of the XLA and factored
// forms: m = r v, q[d][e] = (r v_d) v_e, as the twin forms them
struct Own {
  float r, v[3], p, m[3], q[3][3];
};

// one bond's terms into a node's accumulators; f = the neighbour's (rho,
// vx, vy, vz, p) masked and its act; c0, c1 the slot's coefficients
template <int FORM, int NA>
__device__ __forceinline__ void add_bond(float (&a)[NA], const float (&f)[6],
                                         const Own& o, float4 c0, float4 c1) {
  const float rj = f[0], vj[3] = {f[1], f[2], f[3]}, pj = f[4], act = f[5];
  if constexpr (FORM == kXla) {
    const float ixi = c0.x, ixi2 = c0.y;
    const float e[3] = {c0.z, c0.w, c1.x};
    const float V = c1.y * act;
    const float mj[3] = {rj * vj[0], rj * vj[1], rj * vj[2]};
    const float fd = ((mj[0] - o.m[0]) * e[0] + (mj[1] - o.m[1]) * e[1]) +
                     (mj[2] - o.m[2]) * e[2];
    a[0] = a[0] + fd * ixi * V;
    a[1] = a[1] + (rj - o.r) * ixi2 * V;
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      const float conv = ((mj[d] * vj[0] - o.q[d][0]) * e[0] +
                          (mj[d] * vj[1] - o.q[d][1]) * e[1]) +
                         (mj[d] * vj[2] - o.q[d][2]) * e[2];
      a[2 + d] = a[2 + d] + conv * ixi * V;
      a[5 + d] = a[5 + d] + (pj - o.p) * e[d] * ixi * V;
      a[8 + d] = a[8 + d] + (vj[d] - o.v[d]) * ixi2 * V;
    }
  } else {
    const float c2 = c0.x, et[3] = {c0.y, c0.z, c0.w};
    const float fdj = ((rj * vj[0]) * et[0] + (rj * vj[1]) * et[1]) +
                      (rj * vj[2]) * et[2];
    if constexpr (FORM == kFactored) {
      const float fdi = (o.m[0] * et[0] + o.m[1] * et[1]) + o.m[2] * et[2];
      const float w2 = c2 * act;
      const float dpw = (pj - o.p) * act;
      a[0] = a[0] + (fdj - fdi) * act;
      a[1] = a[1] + (rj - o.r) * w2;
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        a[2 + d] = a[2 + d] + (vj[d] * fdj - o.v[d] * fdi) * act;
        a[5 + d] = a[5 + d] + dpw * et[d];
        a[8 + d] = a[8 + d] + (vj[d] - o.v[d]) * w2;
      }
    } else if constexpr (FORM == kJconv) {
      a[0] = a[0] + fdj;
      a[1] = a[1] + rj * c2;
      a[2] = a[2] + c2 * act;
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        a[3 + d] = a[3 + d] + et[d] * act;
        a[6 + d] = a[6 + d] + vj[d] * fdj;
        a[9 + d] = a[9 + d] + pj * et[d];
        a[12 + d] = a[12 + d] + vj[d] * c2;
      }
    } else {  // kJstat
      a[0] = a[0] + fdj;
      a[1] = a[1] + rj * c2;
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        a[2 + d] = a[2 + d] + vj[d] * fdj;
        a[5 + d] = a[5 + d] + pj * et[d];
        a[8 + d] = a[8 + d] + vj[d] * c2;
      }
    }
  }
}

template <int FORM, int BZ>
__global__ void __launch_bounds__(Geo<FORM, BZ>::kThreads,
                                  Geo<FORM, BZ>::kMinBlocks)
ns3d_chunked_kernel(const float* __restrict__ rho,
                    const float* __restrict__ vel,
                    const float* __restrict__ p,
                    const uint8_t* __restrict__ nt,
                    const float* __restrict__ actconv,
                    const float* __restrict__ dt_ptr,
                    const int* __restrict__ slot_off,
                    const float4* __restrict__ slot_coef,
                    const int2* __restrict__ runs,
                    const int* __restrict__ chunk_end, int nchunk, int S,
                    int nruns, int nz, int ny, int nx, float dens,
                    float a_inv_vh, float visc, float rho_lo, float rho_hi,
                    float* __restrict__ rho_out,
                    float* __restrict__ vel_out) {
  using G = Geo<FORM, BZ>;
  constexpr int kR = G::kR, kNA = G::kNA, kNC = G::kNC;
  constexpr int kField = G::kField, kPlane = G::kPlane, kPitch = G::kPitch;
  // [S][kNC] float4 coefficients, [nruns] (first slot, length), 5 fields
  // of kField floats, [S] tile offsets, [nchunk] chunk ends (runs), act
  // bytes
  extern __shared__ float4 smem4[];
  float4* s_coef = smem4;
  int2* s_run = reinterpret_cast<int2*>(smem4 + kNC * S);
  float* tile = reinterpret_cast<float*>(s_run + nruns);
  int* s_off = reinterpret_cast<int*>(tile + 5 * kField);
  int* s_end = s_off + S;
  uint8_t* s_act = reinterpret_cast<uint8_t*>(s_end + nchunk);

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int tx = (warp % G::kNWX) * G::kWX + lane % G::kWX;
  const int ty = ((warp / G::kNWX) % G::kNWY) * G::kWY + lane / G::kWX;
  const int tz = warp / (G::kNWX * G::kNWY);
  const int x0 = blockIdx.x * G::kTX, y0 = blockIdx.y * G::kTY;
  const int z0 = blockIdx.z * BZ;
  const int i = x0 + tx, j = y0 + ty;
  const int plane = ny * nx;

  // own nodes, pass by pass: copy the ones that are not FLUID through,
  // note the others (bit pass * kR + q)
  unsigned fluid = 0u;
  if (i < nx && j < ny) {
#pragma unroll
    for (int ps = 0; ps < G::kPasses; ++ps) {
#pragma unroll
      for (int q = 0; q < kR; ++q) {
        const int k = z0 + (ps * G::kZT + tz) * kR + q;
        if (k < nz) {
          const int n = k * plane + j * nx + i;
          if (nt[n] == pd::kFluid) {
            fluid |= 1u << (ps * kR + q);
          } else {
            rho_out[n] = rho[n];
            vel_out[3 * n] = vel[3 * n];
            vel_out[3 * n + 1] = vel[3 * n + 1];
            vel_out[3 * n + 2] = vel[3 * n + 2];
          }
        }
      }
    }
  }
  if (!__syncthreads_or(fluid != 0u)) return;

  // the tables
  for (int s = tid; s < S; s += G::kThreads) {
#pragma unroll
    for (int w = 0; w < kNC; ++w) s_coef[kNC * s + w] = slot_coef[kNC * s + w];
    s_off[s] = slot_off[s];
  }
  for (int r = tid; r < nruns; r += G::kThreads) s_run[r] = runs[r];
  for (int c = tid; c < nchunk; c += G::kThreads) s_end[c] = chunk_end[c];

  // the tile and its halo: OUTSIDE and off-grid positions read as +0, act 0
#pragma unroll (kStageUnroll)
  for (int e = tid; e < G::kEX * G::kEY * G::kEZ; e += G::kThreads) {
    const int ex = e % G::kEX, ey = (e / G::kEX) % G::kEY;
    const int ez = e / (G::kEX * G::kEY);
    const int gx = x0 + ex - kHalo, gy = y0 + ey - kHalo;
    const int gz = z0 + ez - kHalo;
    const bool inside = gx >= 0 && gx < nx && gy >= 0 && gy < ny && gz >= 0 &&
                        gz < nz;
    const int m = inside ? gz * plane + gy * nx + gx : 0;
    const bool act = inside && nt[m] != pd::kOutside;
    const float r = rho[m], pm = p[m];
    const float vx = vel[3 * m], vy = vel[3 * m + 1], vz = vel[3 * m + 2];
    const int at = ez * kPlane + ey * kPitch + ex;
    float* t = tile + at;
    t[0] = act ? r : 0.0f;
    t[kField] = act ? vx : 0.0f;
    t[2 * kField] = act ? vy : 0.0f;
    t[3 * kField] = act ? vz : 0.0f;
    t[4 * kField] = act ? pm : 0.0f;
    if constexpr (G::kActBytes > 0) s_act[at] = act;
  }
  __syncthreads();
  if (fluid == 0u) return;

  const size_t N = static_cast<size_t>(nz) * plane;
  const float dt = *dt_ptr;
  const float neg_a = -a_inv_vh;
  for (int ps = 0; ps < G::kPasses; ++ps) {
    const unsigned mine = (fluid >> (ps * kR)) & ((1u << kR) - 1u);
    if (mine == 0u) continue;
    const int zl = (ps * G::kZT + tz) * kR;       // local z of node 0
    // the tile index of node 0, less the halo (the table's offsets carry
    // it), and of its centre
    const int own_at = zl * kPlane + ty * kPitch + tx;
    const int centre = own_at + kHalo * (kPlane + kPitch + 1);
    Own own[kR];
#pragma unroll
    for (int q = 0; q < kR; ++q) {
      const float* c = tile + centre + q * kPlane;
      Own& o = own[q];
      o.r = c[0], o.v[0] = c[kField], o.v[1] = c[2 * kField];
      o.v[2] = c[3 * kField], o.p = c[4 * kField];
#pragma unroll
      for (int d = 0; d < 3; ++d) o.m[d] = o.r * o.v[d];
#pragma unroll
      for (int d = 0; d < 3; ++d)
#pragma unroll
        for (int e = 0; e < 3; ++e) o.q[d][e] = o.m[d] * o.v[e];
    }
    float acc[kR][kNA];
#pragma unroll
    for (int q = 0; q < kR; ++q)
#pragma unroll
      for (int a = 0; a < kNA; ++a) acc[q][a] = 0.0f;

    int r = 0;
    for (int ch = 0; ch < nchunk; ++ch) {
      float part[kR][kNA];
#pragma unroll
      for (int q = 0; q < kR; ++q)
#pragma unroll
        for (int a = 0; a < kNA; ++a) part[q][a] = 0.0f;
      for (const int rend = s_end[ch]; r < rend; ++r) {
        const int s0 = s_run[r].x, len = s_run[r].y;
        // element e of the run's column is the neighbour of node q under
        // slot s0 + e - q; the window holds elements t .. t + kR - 1,
        // element e in register e % kR
        const int col = own_at + s_off[s0];
        float win[kR][6];
#pragma unroll
        for (int e = 0; e < kR - 1; ++e) {
#pragma unroll
          for (int f = 0; f < 5; ++f)
            win[e][f] = tile[f * kField + col + e * kPlane];
          win[e][5] = G::kActBytes > 0 && s_act[col + e * kPlane] ? 1.0f
                                                                  : 0.0f;
        }
        for (int t = 0; t < len; t += kR) {   // t % kR == 0
#pragma unroll
          for (int u = 0; u < kR; ++u) {
            if (t + u < len) {
              const int at = col + (t + u + kR - 1) * kPlane;
              const int slot = (u + kR - 1) % kR;
#pragma unroll
              for (int f = 0; f < 5; ++f)
                win[slot][f] = tile[f * kField + at];
              win[slot][5] = G::kActBytes > 0 && s_act[at] ? 1.0f : 0.0f;
              const int s = s0 + t + u;
              const float4 c0 = s_coef[kNC * s];
              const float4 c1 = kNC > 1 ? s_coef[kNC * s + 1] : c0;
#pragma unroll
              for (int q = 0; q < kR; ++q)
                add_bond<FORM>(part[q], win[(u + q) % kR], own[q], c0, c1);
            }
          }
        }
      }
#pragma unroll
      for (int q = 0; q < kR; ++q)
#pragma unroll
        for (int a = 0; a < kNA; ++a) acc[q][a] = acc[q][a] + part[q][a];
    }

#pragma unroll
    for (int q = 0; q < kR; ++q) {
      if (!(mine & (1u << q))) continue;
      const Own& o = own[q];
      const float (&a)[kNA] = acc[q];
      const int n = (z0 + zl + q) * plane + j * nx + i;
      // (mass_conv, mass_diff, conv[3], pres[3], visc[3])
      float mc, md, conv[3], pres[3], vis[3];
      if constexpr (FORM == kXla || FORM == kFactored) {
        mc = a[0];
        md = a[1];
#pragma unroll
        for (int d = 0; d < 3; ++d) {
          conv[d] = a[2 + d];
          pres[d] = a[5 + d];
          vis[d] = a[8 + d];
        }
      } else {
        float B2, B[3];
        int c0, p0, v0;  // first conv / pres / visc accumulator
        if constexpr (FORM == kJconv) {
          B2 = a[2];
          B[0] = a[3];
          B[1] = a[4];
          B[2] = a[5];
          c0 = 6, p0 = 9, v0 = 12;
        } else {
          B2 = actconv[n];
          B[0] = actconv[N + n];
          B[1] = actconv[2 * N + n];
          B[2] = actconv[3 * N + n];
          c0 = 2, p0 = 5, v0 = 8;
        }
        const float F = (o.m[0] * B[0] + o.m[1] * B[1]) + o.m[2] * B[2];
        mc = a[0] - F;
        md = a[1] - o.r * B2;
#pragma unroll
        for (int d = 0; d < 3; ++d) {
          conv[d] = a[c0 + d] - o.v[d] * F;
          pres[d] = a[p0 + d] - o.p * B[d];
          vis[d] = a[v0 + d] - o.v[d] * B2;
        }
      }
      float rn = o.r + dt * (neg_a * mc + dens * md);
      // clip that keeps a NaN (the flow solve's divergence check looks for
      // it)
      rn = rn < rho_lo ? rho_lo : rn;
      rn = rn > rho_hi ? rho_hi : rn;
      const float scale = dt * (1.0f / o.r);
      rho_out[n] = rn;
#pragma unroll
      for (int d = 0; d < 3; ++d)
        vel_out[3 * n + d] =
            o.v[d] + scale * (neg_a * (conv[d] + pres[d]) + visc * vis[d]);
    }
  }
}

template <int FORM, int BZ>
int launch(const float* rho, const float* vel, const float* p,
           const uint8_t* node_type, const float* actconv, const float* dt,
           const int* slot_off, const float* slot_coef, const int* runs,
           const int* chunk_end, int nchunk, int S, int nruns, int nz, int ny,
           int nx, float dens, float a_inv_vh, float visc, float rho_lo,
           float rho_hi, float* rho_out, float* vel_out, int device,
           cudaStream_t stream) {
  using G = Geo<FORM, BZ>;
  const size_t bytes = G::smem_bytes(S, nruns, nchunk);
  // the most dynamic shared memory asked for so far, per device
  static size_t allowed[kMaxDevices] = {};
  cudaError_t err;
  if (bytes > allowed[device]) {
    err = cudaFuncSetAttribute(ns3d_chunked_kernel<FORM, BZ>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaFuncSetAttribute(ns3d_chunked_kernel<FORM, BZ>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return static_cast<int>(err);
    allowed[device] = bytes;
  }
  if ((nz + BZ - 1) / BZ > 65535 || (ny + G::kTY - 1) / G::kTY > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((nx + G::kTX - 1) / G::kTX, (ny + G::kTY - 1) / G::kTY,
                  (nz + BZ - 1) / BZ);
  ns3d_chunked_kernel<FORM, BZ><<<grid, G::kThreads, bytes, stream>>>(
      rho, vel, p, node_type, actconv, dt, slot_off,
      reinterpret_cast<const float4*>(slot_coef),
      reinterpret_cast<const int2*>(runs), chunk_end, nchunk, S, nruns, nz,
      ny, nx, dens, a_inv_vh, visc, rho_lo, rho_hi, rho_out, vel_out);
  return static_cast<int>(cudaGetLastError());
}

template <int FORM, int BZ>
void geometry(int* out) {
  using G = Geo<FORM, BZ>;
  const int g[10] = {G::kTX, G::kTY, BZ, G::kR, kHalo, G::kPitch, G::kPlane,
                     G::kThreads, G::kEX * G::kEY * G::kEZ,
                     static_cast<int>(5 * G::kField * sizeof(float) +
                                      G::kActBytes)};
  for (int a = 0; a < 10; ++a) out[a] = g[a];
}

template <int FORM>
bool geometry_of(int bz, int* out) {
  switch (bz) {
    case 8: geometry<FORM, 8>(out); return true;
    case 16: geometry<FORM, 16>(out); return true;
    case 32: geometry<FORM, 32>(out); return true;
    default: return false;
  }
}

}  // namespace

// (TX, TY, TZ = BZ, R, halo, row pitch, plane pitch, threads a block,
// staged positions a block, shared-memory bytes of the staged fields and
// act bytes) of one form at one rung; returns 0, or -1 for a form or BZ
// the library has no kernel for
PD_EXPORT int pd_ns3d_chunked_geometry(int form, int bz, int* out) {
  bool ok = false;
  switch (form) {
    case kXla: ok = geometry_of<kXla>(bz, out); break;
    case kFactored: ok = geometry_of<kFactored>(bz, out); break;
    case kJconv: ok = geometry_of<kJconv>(bz, out); break;
    case kJstat: ok = geometry_of<kJstat>(bz, out); break;
    default: break;
  }
  return ok ? 0 : -1;
}

// slot_off: [S] int, each slot's offset in the tile from a node's own
// position less the halo, (dk + halo) * plane + (dj + halo) * pitch + di +
// halo, for this form's and rung's tile; slot_coef: [S][4] float (XLA
// form: [S][8]), 16-byte aligned; runs: [nruns][2] int (first slot,
// length); chunk_end: [nchunk] int, the run after each chunk's last.
PD_EXPORT int pd_ns3d_chunked(int form, const float* rho, const float* vel,
                              const float* p, const uint8_t* node_type,
                              const float* actconv, const float* dt,
                              const int* slot_off, const float* slot_coef,
                              const int* runs, const int* chunk_end,
                              int nchunk, int S, int nruns, int nz, int ny,
                              int nx, int bz, float dens, float a_inv_vh,
                              float visc, float rho_lo, float rho_hi,
                              float* rho_out, float* vel_out, int device,
                              void* stream) {
  if (S < 1 || S > pd::kMaxSlots || nruns < 1 || nruns > S || nchunk < 1 ||
      nchunk > kMaxChunks || nchunk > nruns || nz < 1 || ny < 1 || nx < 1 ||
      device < 0 || device >= kMaxDevices ||
      (form == kJstat) != (actconv != nullptr) ||
      reinterpret_cast<uintptr_t>(slot_coef) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PD_LAUNCH(F, B)                                                      \
  return launch<F, B>(rho, vel, p, node_type, actconv, dt, slot_off,         \
                      slot_coef, runs, chunk_end, nchunk, S, nruns, nz, ny,  \
                      nx, dens, a_inv_vh, visc, rho_lo, rho_hi, rho_out,     \
                      vel_out, device, st)
#define PD_RUNGS(F)                  \
  switch (bz) {                      \
    case 8: PD_LAUNCH(F, 8);         \
    case 16: PD_LAUNCH(F, 16);       \
    case 32: PD_LAUNCH(F, 32);       \
    default: break;                  \
  }                                  \
  break
  switch (form) {
    case kXla: PD_RUNGS(kXla);
    case kFactored: PD_RUNGS(kFactored);
    case kJconv: PD_RUNGS(kJconv);
    case kJstat: PD_RUNGS(kJstat);
    default: break;
  }
#undef PD_RUNGS
#undef PD_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}
