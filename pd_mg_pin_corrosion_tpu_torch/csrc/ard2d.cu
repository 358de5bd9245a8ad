// ard2d: one explicit forward-Euler 2D transport step (f32).
//
// Replaces: pd_mg_pin_corrosion_tpu/pallas_kernels.py, _ard_kernel (body)
// and ard_step_pallas (entry); math of ops/ard.py ard_step (reference
// src/pd_ard.cpp:55-191).
//
// Contract (plain twin: kernels/ard2d.py ard2d_plain):
//   * only FLUID and SOLID_MG nodes are updated, every other node is copied
//     through; the centre velocity and |v| are FLUID-masked, the
//     neighbour's |v| is raw;
//   * a neighbour outside the grid, WALL or OUTSIDE has V_j = 0 and a
//     solid-solid bond has bond_on = 0: their terms are exact zeros, so
//     they are skipped; so is the advection term of a bond that is not
//     liquid-liquid;
//   * Ds (solid-side micro-diffusivity, volume-loss factor included) and
//     the salt-blocking flags come from the wrapper, as the TPU kernel's
//     inputs did;
//   * every per-bond term is the plain version's expression, operation for
//     operation, summed in stencil order (acc = acc + term), so with FMA
//     contraction off (-fmad=false) the result equals the plain PyTorch
//     version bit for bit;
//   * C_new = max(C_i + dt (diff - alpha/V_H adv), 0), a NaN kept.
//
// What bounds it on an H100: at the fine-calibration grid (567 x 347 =
// 196,749 nodes, S = 36) a call must move ~26 B/node of unique data (C,
// vel[2], |v|, Ds, node_type, salt in; C out), ~5.1 MB, ~1.5 us of HBM
// time, against ~6.6 M liquid-liquid bonds x 17 flops (interface bonds
// 6-10), ~0.11 GFLOP, ~1.7 us at 67 TFLOP/s. Each active node reads 36
// neighbours' node type, C, |v|, Ds and salt from L1/L2, so like ns2d
// (0.0326 ms on an H100 80GB HBM3 at 700 W) it is bound by load issue, not
// by HBM or flops.
//
// Design: ns2d's: one thread per node, 256-thread blocks over the flat
// node index, so a warp's neighbour loads of one slot are one coalesced,
// cache-resident row segment; the slot table (offsets, 1/xi, 1/xi^2, e,
// vol) staged once per block in shared memory. The bond classes are
// branches on the neighbour's type instead of mask products.

#include "common.cuh"

namespace {

constexpr uint8_t kSolid = 1, kWall = 2, kInlet = 3, kOutlet = 4;
constexpr uint8_t kFictitious = 6;

__global__ void __launch_bounds__(pd::kThreads)
ard2d_kernel(const float* __restrict__ C, const float* __restrict__ vel,
             const float* __restrict__ vmag, const uint8_t* __restrict__ nt,
             const float* __restrict__ Ds, const uint8_t* __restrict__ salt,
             float dt, const int* __restrict__ offs,
             const float* __restrict__ coefs, int S, int ny, int nx,
             float beta, float D_L, float two_D_L, float alpha_art, float dx,
             float div_coeff, float* __restrict__ C_out) {
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
  const uint8_t ti = nt[n];
  const float ci = C[n];
  const bool fi = ti == pd::kFluid;
  if (!fi && ti != kSolid) {
    C_out[n] = ci;
    return;
  }
  const int j = n / nx;
  const int i = n - j * nx;
  const float vxi = fi ? vel[2 * n] : 0.0f;
  const float vyi = fi ? vel[2 * n + 1] : 0.0f;
  const float vmi = fi ? vmag[n] : 0.0f;
  // a SOLID centre: its interface diffusivity is the same for every bond
  float D_solid_i = 0.0f;
  if (!fi) {
    const float dsi = Ds[n];
    D_solid_i = salt[n] ? 0.0f : two_D_L * dsi / (D_L + dsi + 1e-30f);
  }

  float diff = 0.0f, adv = 0.0f;
  for (int s = 0; s < S; ++s) {
    const int jj = j + s_dj[s];
    const int ii = i + s_di[s];
    if (jj < 0 || jj >= ny || ii < 0 || ii >= nx) continue;
    const int m = jj * nx + ii;
    const uint8_t tj = nt[m];
    if (tj == kWall || tj == pd::kOutside) continue;
    const bool jf = tj == pd::kFluid || tj == kInlet || tj == kOutlet ||
                    tj == kFictitious;
    const bool js = tj == kSolid;
    float D;  // D_avg + D_art of this bond
    if (fi && jf) {  // liquid-liquid
      const float vmj = vmag[m];
      D = D_L + alpha_art * (vmi > vmj ? vmi : vmj) * dx;
    } else if (fi && js) {  // interface, solid side j
      const float dsj = Ds[m];
      D = salt[m] ? 0.0f : two_D_L * dsj / (D_L + dsj + 1e-30f);
    } else if (!fi && jf) {  // interface, solid side i
      D = D_solid_i;
    } else {  // solid-solid: skipped
      continue;
    }
    const float V = s_vol[s];
    const float dC = C[m] - ci;
    diff = diff + beta * D * dC * s_ixi2[s] * V;
    if (fi && jf) {
      const float vde = vxi * s_ex[s] + vyi * s_ey[s];
      adv = adv + dC * vde * s_ixi[s] * V;
    }
  }
  const float cn = ci + dt * (diff - div_coeff * adv);
  C_out[n] = cn < 0.0f ? 0.0f : cn;
}

}  // namespace

PD_EXPORT int pd_ard2d(const float* C, const float* vel, const float* vmag,
                       const uint8_t* node_type, const float* Ds,
                       const uint8_t* salt, float dt, const int* offs,
                       const float* coefs, int S, int ny, int nx, float beta,
                       float D_L, float two_D_L, float alpha_art, float dx,
                       float div_coeff, float* C_out, int device,
                       void* stream) {
  if (S < 1 || S > pd::kMaxSlots) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n = static_cast<long long>(ny) * nx;
  ard2d_kernel<<<pd::blocks_for(n), pd::kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      C, vel, vmag, node_type, Ds, salt, dt, offs, coefs, S, ny, nx, beta,
      D_L, two_D_L, alpha_art, dx, div_coeff, C_out);
  return static_cast<int>(cudaGetLastError());
}
