// ns2d: one explicit 2D peridynamic Navier-Stokes step (f32).
//
// Replaces: pd_mg_pin_corrosion_tpu/pallas_kernels.py, _ns_kernel (body)
// and ns_step_pallas (entry); math of ops/ns.py ns_step (reference
// src/pd_ns.cpp:78-180).
//
// Contract (plain twin: kernels/ns2d.py ns2d_plain):
//   * neighbours are masked by act = (node_type != OUTSIDE); a neighbour
//     outside the grid counts as act = 0;
//   * slots are visited in reference stencil order and every accumulator
//     is a plain a + b*c*d chain in the same order as ops/ns.py, so with
//     FMA contraction off (-fmad=false) the result equals the plain
//     PyTorch version bit for bit;
//   * terms scaled by an exactly-zero bond-direction component (axis
//     bonds) are skipped, and so are masked neighbours: both contribute an
//     exact zero in the plain version;
//   * rho is clamped to [rho_lo, rho_hi] = [0.5, 2] rho_f; only FLUID
//     nodes are updated, every other node is copied through.
//
// What bounds it on an H100: at the fine-calibration grid (567 x 347 =
// 196,749 nodes, S = 36) a call streams ~29 B/node of unique data
// (rho, vel[2], p, node_type in; rho, vel[2] out), ~5.7 MB, i.e. ~2 us of
// HBM time. The 36 neighbour reads per node (~0.6 KB/node) come from L1/L2
// and the ~50 flops per bond (~350 MFLOP per call) make it an L1 and
// issue-bound kernel, not an HBM-bound one.
//
// Design: one thread per node, 256-thread blocks over the flat node index,
// so a warp reads 32 consecutive nodes of one row and every neighbour load
// of a slot is a coalesced, cache-resident row segment. The slot table
// (offsets, 1/xi, 1/xi^2, e_x, e_y, vol) is staged once per block in
// shared memory. Non-FLUID threads leave after the copy. Tiling the window
// through shared memory (or TMA) is later work.

#include "common.cuh"

namespace {

__global__ void __launch_bounds__(pd::kThreads)
ns2d_kernel(const float* __restrict__ rho, const float* __restrict__ vel,
            const float* __restrict__ p, const uint8_t* __restrict__ nt,
            const float* __restrict__ dt_ptr, const int* __restrict__ offs,
            const float* __restrict__ coefs, int S, int ny, int nx,
            float dens, float a_inv_vh, float visc, float rho_lo,
            float rho_hi, float* __restrict__ rho_out,
            float* __restrict__ vel_out) {
  __shared__ int s_dj[pd::kMaxSlots], s_di[pd::kMaxSlots];
  __shared__ float s_ixi[pd::kMaxSlots], s_ixi2[pd::kMaxSlots];
  __shared__ float s_ex[pd::kMaxSlots], s_ey[pd::kMaxSlots];
  __shared__ float s_vol[pd::kMaxSlots];
  for (int s = threadIdx.x; s < S; s += blockDim.x) {
    s_dj[s] = offs[2 * s];
    s_di[s] = offs[2 * s + 1];
    s_ixi[s] = coefs[s];
    s_ixi2[s] = coefs[S + s];
    s_ex[s] = coefs[2 * S + s];
    s_ey[s] = coefs[3 * S + s];
    s_vol[s] = coefs[4 * S + s];
  }
  __syncthreads();

  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= ny * nx) return;
  const float ri = rho[n];
  const float vxi = vel[2 * n];
  const float vyi = vel[2 * n + 1];
  if (nt[n] != pd::kFluid) {
    rho_out[n] = ri;
    vel_out[2 * n] = vxi;
    vel_out[2 * n + 1] = vyi;
    return;
  }
  const int j = n / nx;
  const int i = n - j * nx;
  const float pi = p[n];
  // i-side momentum / flux products, formed exactly as the plain version
  const float mxi = ri * vxi, myi = ri * vyi;
  const float qxxi = mxi * vxi, qxyi = mxi * vyi;
  const float qyxi = myi * vxi, qyyi = myi * vyi;

  float mass_conv = 0.0f, mass_diff = 0.0f;
  float conv_x = 0.0f, conv_y = 0.0f, pres_x = 0.0f, pres_y = 0.0f;
  float visc_x = 0.0f, visc_y = 0.0f;
  for (int s = 0; s < S; ++s) {
    const int jj = j + s_dj[s];
    const int ii = i + s_di[s];
    if (jj < 0 || jj >= ny || ii < 0 || ii >= nx) continue;
    const int m = jj * nx + ii;
    if (nt[m] == pd::kOutside) continue;
    const float V = s_vol[s];
    const float ex = s_ex[s], ey = s_ey[s];
    const float ixi = s_ixi[s], ixi2 = s_ixi2[s];
    const float rj = rho[m];
    const float vxj = vel[2 * m];
    const float vyj = vel[2 * m + 1];
    const float pj = p[m];
    const float mxj = rj * vxj, myj = rj * vyj;

    float flux, tx, ty;
    if (ex != 0.0f && ey != 0.0f) {
      flux = (mxj - mxi) * ex + (myj - myi) * ey;
      tx = (mxj * vxj - qxxi) * ex + (mxj * vyj - qxyi) * ey;
      ty = (myj * vxj - qyxi) * ex + (myj * vyj - qyyi) * ey;
    } else if (ex != 0.0f) {
      flux = (mxj - mxi) * ex;
      tx = (mxj * vxj - qxxi) * ex;
      ty = (myj * vxj - qyxi) * ex;
    } else {
      flux = (myj - myi) * ey;
      tx = (mxj * vyj - qxyi) * ey;
      ty = (myj * vyj - qyyi) * ey;
    }
    mass_conv = mass_conv + flux * ixi * V;
    mass_diff = mass_diff + dens * (rj - ri) * ixi2 * V;
    conv_x = conv_x + tx * ixi * V;
    conv_y = conv_y + ty * ixi * V;
    const float dp = pj - pi;
    if (ex != 0.0f) pres_x = pres_x + dp * ex * ixi * V;
    if (ey != 0.0f) pres_y = pres_y + dp * ey * ixi * V;
    visc_x = visc_x + (vxj - vxi) * ixi2 * V;
    visc_y = visc_y + (vyj - vyi) * ixi2 * V;
  }

  const float dt = *dt_ptr;
  const float neg_a = -a_inv_vh;
  float rn = ri + dt * (neg_a * mass_conv + mass_diff);
  // clip that keeps a NaN (the flow solve's divergence check looks for it)
  rn = rn < rho_lo ? rho_lo : rn;
  rn = rn > rho_hi ? rho_hi : rn;
  const float scale = dt * (1.0f / ri);
  rho_out[n] = rn;
  vel_out[2 * n] =
      vxi + scale * ((neg_a * conv_x - a_inv_vh * pres_x) + visc * visc_x);
  vel_out[2 * n + 1] =
      vyi + scale * ((neg_a * conv_y - a_inv_vh * pres_y) + visc * visc_y);
}

}  // namespace

PD_EXPORT int pd_ns2d(const float* rho, const float* vel, const float* p,
                      const uint8_t* node_type, const float* dt,
                      const int* offs, const float* coefs, int S, int ny,
                      int nx, float dens, float a_inv_vh, float visc,
                      float rho_lo, float rho_hi, float* rho_out,
                      float* vel_out, int device, void* stream) {
  if (S < 1 || S > pd::kMaxSlots) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n = static_cast<long long>(ny) * nx;
  ns2d_kernel<<<pd::blocks_for(n), pd::kThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(
      rho, vel, p, node_type, dt, offs, coefs, S, ny, nx, dens, a_inv_vh,
      visc, rho_lo, rho_hi, rho_out, vel_out);
  return static_cast<int>(cudaGetLastError());
}

PD_EXPORT const char* pd_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
