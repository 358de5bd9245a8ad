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
// Contract (plain twin: kernels/ns3d.py ns3d_plain):
//   * slots are visited in kit.ns_slots order (the TPU kernel's: grouped by
//     (dj, di), dk order within a group), with offs = kit.ns_offsets and
//     coefs = kit.ns_coefs = (vol/xi^2, e_x vol/xi, e_y vol/xi, e_z vol/xi)
//     in that order;
//   * a neighbour outside the grid or OUTSIDE is skipped: its masked values
//     are 0 and its terms exact zeros, which leave every sum unchanged;
//   * every per-bond term is the plain version's expression, operation for
//     operation (zero e components included: x * 0 is an exact +-0), and
//     every accumulator is acc = acc + term, so with FMA contraction off
//     (-fmad=false) the result equals the plain PyTorch version bit for bit;
//   * rho is clamped to [rho_lo, rho_hi] = [0.5, 2] rho_f; only FLUID
//     nodes are updated, every other node is copied through.
//
// What bounds it on an H100: at the flagship grid (157 x 82 x 82 =
// 1,055,668 nodes, S = 178) a call streams 53 B/node of unique data
// (rho, vel[3], p, node_type, B[4] in; rho, vel[3] out), 56 MB, ~17 us of
// HBM time. Each FLUID node reads 178 x (5 floats + 1 byte) of neighbours
// (~3.7 KB) from L1/L2 and does ~30 flops per bond, so the kernel is bound
// by load issue and L1 bandwidth, not by HBM.
//
// Design: one thread per node; blocks of 32 x 8 threads over (x, y) of one
// z plane, so a warp reads 32 consecutive x of a row and the neighbour
// loads of one slot are coalesced row segments shared through L1 by the
// block's 8 rows. The slot table (dk, dj, di and four coefficients; 5 KB
// at S = 178) is staged once per block in shared memory. Non-FLUID threads
// leave after the copy. Tiling the neighbourhood through shared memory or
// streaming along z (a 2.5D scheme) is later work.

#include "common.cuh"

namespace {

constexpr int kBx = 32;
constexpr int kBy = 8;

__global__ void __launch_bounds__(kBx * kBy)
ns3d_kernel(const float* __restrict__ rho, const float* __restrict__ vel,
            const float* __restrict__ p, const uint8_t* __restrict__ nt,
            const float* __restrict__ dt_ptr, const int* __restrict__ offs,
            const float* __restrict__ coefs, const float* __restrict__ actconv,
            int S, int nz, int ny, int nx, float dens, float a_inv_vh,
            float visc, float rho_lo, float rho_hi, float* __restrict__ rho_out,
            float* __restrict__ vel_out) {
  __shared__ int s_dk[pd::kMaxSlots], s_dj[pd::kMaxSlots], s_di[pd::kMaxSlots];
  __shared__ float s_c2[pd::kMaxSlots], s_ex[pd::kMaxSlots];
  __shared__ float s_ey[pd::kMaxSlots], s_ez[pd::kMaxSlots];
  const int tid = threadIdx.y * kBx + threadIdx.x;
  for (int s = tid; s < S; s += kBx * kBy) {
    s_dk[s] = offs[3 * s];
    s_dj[s] = offs[3 * s + 1];
    s_di[s] = offs[3 * s + 2];
    s_c2[s] = coefs[s];
    s_ex[s] = coefs[S + s];
    s_ey[s] = coefs[2 * S + s];
    s_ez[s] = coefs[3 * S + s];
  }
  __syncthreads();

  const int i = blockIdx.x * kBx + threadIdx.x;
  const int j = blockIdx.y * kBy + threadIdx.y;
  const int k = blockIdx.z;
  if (i >= nx || j >= ny) return;
  const int n = (k * ny + j) * nx + i;
  const float ri = rho[n];
  const float vxi = vel[3 * n], vyi = vel[3 * n + 1], vzi = vel[3 * n + 2];
  if (nt[n] != pd::kFluid) {
    rho_out[n] = ri;
    vel_out[3 * n] = vxi;
    vel_out[3 * n + 1] = vyi;
    vel_out[3 * n + 2] = vzi;
    return;
  }

  float mass_conv = 0.0f, mass_diff = 0.0f;
  float conv_x = 0.0f, conv_y = 0.0f, conv_z = 0.0f;
  float pres_x = 0.0f, pres_y = 0.0f, pres_z = 0.0f;
  float visc_x = 0.0f, visc_y = 0.0f, visc_z = 0.0f;
  for (int s = 0; s < S; ++s) {
    const int kk = k + s_dk[s];
    const int jj = j + s_dj[s];
    const int ii = i + s_di[s];
    if (kk < 0 || kk >= nz || jj < 0 || jj >= ny || ii < 0 || ii >= nx)
      continue;
    const int m = (kk * ny + jj) * nx + ii;
    if (nt[m] == pd::kOutside) continue;
    const float c2 = s_c2[s];
    const float ex = s_ex[s], ey = s_ey[s], ez = s_ez[s];
    const float rj = rho[m];
    const float vxj = vel[3 * m], vyj = vel[3 * m + 1], vzj = vel[3 * m + 2];
    const float pj = p[m];

    const float fdj = ((rj * vxj) * ex + (rj * vyj) * ey) + (rj * vzj) * ez;
    mass_conv = mass_conv + fdj;
    mass_diff = mass_diff + rj * c2;
    conv_x = conv_x + vxj * fdj;
    conv_y = conv_y + vyj * fdj;
    conv_z = conv_z + vzj * fdj;
    pres_x = pres_x + pj * ex;
    pres_y = pres_y + pj * ey;
    pres_z = pres_z + pj * ez;
    visc_x = visc_x + vxj * c2;
    visc_y = visc_y + vyj * c2;
    visc_z = visc_z + vzj * c2;
  }

  // the i-side terms, once
  const size_t N = static_cast<size_t>(nz) * ny * nx;
  const float b2 = actconv[n], bx = actconv[N + n];
  const float by = actconv[2 * N + n], bz = actconv[3 * N + n];
  const float pi = p[n];
  const float F = (ri * vxi * bx + ri * vyi * by) + ri * vzi * bz;
  mass_conv = mass_conv - F;
  mass_diff = mass_diff - ri * b2;

  const float dt = *dt_ptr;
  const float neg_a = -a_inv_vh;
  float rn = ri + dt * (neg_a * mass_conv + dens * mass_diff);
  // clip that keeps a NaN (the flow solve's divergence check looks for it)
  rn = rn < rho_lo ? rho_lo : rn;
  rn = rn > rho_hi ? rho_hi : rn;
  const float scale = dt * (1.0f / ri);
  rho_out[n] = rn;
  vel_out[3 * n] = vxi + scale * (neg_a * ((conv_x - vxi * F) + (pres_x - pi * bx))
                                  + visc * (visc_x - vxi * b2));
  vel_out[3 * n + 1] = vyi + scale * (neg_a * ((conv_y - vyi * F) + (pres_y - pi * by))
                                      + visc * (visc_y - vyi * b2));
  vel_out[3 * n + 2] = vzi + scale * (neg_a * ((conv_z - vzi * F) + (pres_z - pi * bz))
                                      + visc * (visc_z - vzi * b2));
}

}  // namespace

PD_EXPORT int pd_ns3d(const float* rho, const float* vel, const float* p,
                      const uint8_t* node_type, const float* dt,
                      const int* offs, const float* coefs,
                      const float* actconv, int S, int nz, int ny, int nx,
                      float dens, float a_inv_vh, float visc, float rho_lo,
                      float rho_hi, float* rho_out, float* vel_out, int device,
                      void* stream) {
  if (S < 1 || S > pd::kMaxSlots || nz < 1 || nz > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 block(kBx, kBy);
  const dim3 grid((nx + kBx - 1) / kBx, (ny + kBy - 1) / kBy, nz);
  ns3d_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      rho, vel, p, node_type, dt, offs, coefs, actconv, S, nz, ny, nx, dens,
      a_inv_vh, visc, rho_lo, rho_hi, rho_out, vel_out);
  return static_cast<int>(cudaGetLastError());
}
