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
// Contract (plain twin: kernels/ns3d_chunked.py ns3d_chunked_plain):
//   * slots are visited in kit.ns_slots order (grouped by (dj, di), dk
//     order within a group); the groups are split into nchunk contiguous
//     chunks (chunk_end, the script's _group_chunks). Per chunk every
//     accumulator starts at 0, sums the chunk's slots in order, and is
//     then added into the running sum: the TPU kernel's sequential grid
//     axis over chunks (acc_ref[k] += a) is this loop inside the thread;
//   * a neighbour outside the grid or OUTSIDE has act = 0 and only exact
//     zero terms, so it is skipped; for the others act = 1 and the
//     script's "* act_j" is exact and left out;
//   * every per-bond term is the script's expression, operation for
//     operation, zero e components included (x * 0 is an exact +-0), and
//     every accumulator is acc = acc + term, so with FMA contraction off
//     (-fmad=false) the result equals the plain PyTorch version bit for
//     bit;
//   * p is Tait(rho), formed by the caller (the TPU kernel formed it per
//     window in its prologue); rho is clamped to [0.5, 2] rho_f; only FLUID
//     nodes are updated, every other node is copied through (the TPU
//     chunked kernel's in-kernel select; jstat's select after the kernel).
//
// What bounds it on an H100: at the flagship grid (157 x 82 x 82 =
// 1,055,668 nodes, S = 178) a call must move 37 B/node of unique data
// (rho, vel[3], p, node_type in; rho, vel[3] out; jstat 16 B/node more for
// B), ~39 MB, ~12 us of HBM time, against 629,000 FLUID nodes x 178 bonds
// x 29-85 flops (form-dependent), 3.3-9.6 GFLOP, 50-143 us at 67 TFLOP/s.
// Each FLUID node reads 178 x (5 floats + 1 byte) of neighbours from
// L1/L2, so like ns3d it is bound by load issue, not by HBM.
//
// Design: one thread per node. The TPU kernel's BZ (a VMEM block height,
// no effect on the numbers) is kept as the thread block's z extent:
// blocks of (256 / BZ) x 1 x BZ threads over (flat y-x plane index, z), so
// the ladder of scripts/exp_ns3d_chunked_torch.py still times launch
// shapes. The slot table and the chunk ends are staged once per block in
// shared memory. Non-FLUID threads leave after the copy.

#include "common.cuh"

namespace {

enum Form { kXla = 0, kFactored = 1, kJconv = 2, kJstat = 3 };

constexpr int kMaxChunks = 64;

template <int FORM>
struct Acc {
  static constexpr int n = FORM == kJconv ? 15 : 11;
};

template <int FORM>
__global__ void __launch_bounds__(pd::kThreads)
ns3d_chunked_kernel(const float* __restrict__ rho,
                    const float* __restrict__ vel,
                    const float* __restrict__ p,
                    const uint8_t* __restrict__ nt,
                    const float* __restrict__ actconv,
                    const float* __restrict__ dt_ptr,
                    const int* __restrict__ offs,
                    const float* __restrict__ coefs,
                    const int* __restrict__ chunk_end, int nchunk, int S,
                    int nz, int ny, int nx, float dens, float a_inv_vh,
                    float visc, float rho_lo, float rho_hi,
                    float* __restrict__ rho_out,
                    float* __restrict__ vel_out) {
  constexpr int NA = Acc<FORM>::n;
  __shared__ int s_dk[pd::kMaxSlots], s_dj[pd::kMaxSlots], s_di[pd::kMaxSlots];
  // the XLA form's rows 0-5 of the table (vol, 1/xi, 1/xi^2, e_x, e_y,
  // e_z), or the other forms' rows 6-9 (vol/xi^2, e_x vol/xi, e_y vol/xi,
  // e_z vol/xi)
  constexpr int kRow0 = FORM == kXla ? 0 : 6;
  constexpr int kRows = FORM == kXla ? 6 : 4;
  __shared__ float s_c[kRows][pd::kMaxSlots];
  __shared__ int s_end[kMaxChunks];
  const int tid = threadIdx.z * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.z;
  for (int s = tid; s < S; s += nthreads) {
    s_dk[s] = offs[3 * s];
    s_dj[s] = offs[3 * s + 1];
    s_di[s] = offs[3 * s + 2];
    for (int r = 0; r < kRows; ++r) s_c[r][s] = coefs[(kRow0 + r) * S + s];
  }
  for (int c = tid; c < nchunk; c += nthreads) s_end[c] = chunk_end[c];
  __syncthreads();

  const int plane = ny * nx;
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  const int k = blockIdx.z * blockDim.z + threadIdx.z;
  if (q >= plane || k >= nz) return;
  const int j = q / nx;
  const int i = q - j * nx;
  const int n = k * plane + q;
  const float ri = rho[n];
  const float vi[3] = {vel[3 * n], vel[3 * n + 1], vel[3 * n + 2]};
  if (nt[n] != pd::kFluid) {
    rho_out[n] = ri;
    vel_out[3 * n] = vi[0];
    vel_out[3 * n + 1] = vi[1];
    vel_out[3 * n + 2] = vi[2];
    return;
  }
  const float pi = p[n];
  const float mi[3] = {ri * vi[0], ri * vi[1], ri * vi[2]};

  float acc[NA];
#pragma unroll
  for (int a = 0; a < NA; ++a) acc[a] = 0.0f;
  int s = 0;
  for (int c = 0; c < nchunk; ++c) {
    float part[NA];
#pragma unroll
    for (int a = 0; a < NA; ++a) part[a] = 0.0f;
    for (const int send = s_end[c]; s < send; ++s) {
      const int kk = k + s_dk[s];
      const int jj = j + s_dj[s];
      const int ii = i + s_di[s];
      if (kk < 0 || kk >= nz || jj < 0 || jj >= ny || ii < 0 || ii >= nx)
        continue;
      const int m = (kk * ny + jj) * nx + ii;
      if (nt[m] == pd::kOutside) continue;
      const float rj = rho[m];
      const float vj[3] = {vel[3 * m], vel[3 * m + 1], vel[3 * m + 2]};
      const float pj = p[m];
      if constexpr (FORM == kXla) {
        const float V = s_c[0][s], ixi = s_c[1][s], ixi2 = s_c[2][s];
        const float e[3] = {s_c[3][s], s_c[4][s], s_c[5][s]};
        const float fd = ((rj * vj[0] - ri * vi[0]) * e[0] +
                          (rj * vj[1] - ri * vi[1]) * e[1]) +
                         (rj * vj[2] - ri * vi[2]) * e[2];
        part[0] = part[0] + fd * ixi * V;
        part[1] = part[1] + (rj - ri) * ixi2 * V;
#pragma unroll
        for (int d = 0; d < 3; ++d) {
          const float conv = ((rj * vj[d] * vj[0] - ri * vi[d] * vi[0]) * e[0] +
                              (rj * vj[d] * vj[1] - ri * vi[d] * vi[1]) * e[1]) +
                             (rj * vj[d] * vj[2] - ri * vi[d] * vi[2]) * e[2];
          part[2 + d] = part[2 + d] + conv * ixi * V;
          part[5 + d] = part[5 + d] + (pj - pi) * e[d] * ixi * V;
          part[8 + d] = part[8 + d] + (vj[d] - vi[d]) * ixi2 * V;
        }
      } else {
        const float c2 = s_c[0][s];
        const float et[3] = {s_c[1][s], s_c[2][s], s_c[3][s]};
        const float fdj = ((rj * vj[0]) * et[0] + (rj * vj[1]) * et[1]) +
                          (rj * vj[2]) * et[2];
        if constexpr (FORM == kFactored) {
          const float fdi = (mi[0] * et[0] + mi[1] * et[1]) + mi[2] * et[2];
          part[0] = part[0] + (fdj - fdi);
          part[1] = part[1] + (rj - ri) * c2;
          const float dp = pj - pi;
#pragma unroll
          for (int d = 0; d < 3; ++d) {
            part[2 + d] = part[2 + d] + (vj[d] * fdj - vi[d] * fdi);
            part[5 + d] = part[5 + d] + dp * et[d];
            part[8 + d] = part[8 + d] + (vj[d] - vi[d]) * c2;
          }
        } else if constexpr (FORM == kJconv) {
          part[0] = part[0] + fdj;
          part[1] = part[1] + rj * c2;
          part[2] = part[2] + c2;
#pragma unroll
          for (int d = 0; d < 3; ++d) {
            part[3 + d] = part[3 + d] + et[d];
            part[6 + d] = part[6 + d] + vj[d] * fdj;
            part[9 + d] = part[9 + d] + pj * et[d];
            part[12 + d] = part[12 + d] + vj[d] * c2;
          }
        } else {  // kJstat
          part[0] = part[0] + fdj;
          part[1] = part[1] + rj * c2;
#pragma unroll
          for (int d = 0; d < 3; ++d) {
            part[2 + d] = part[2 + d] + vj[d] * fdj;
            part[5 + d] = part[5 + d] + pj * et[d];
            part[8 + d] = part[8 + d] + vj[d] * c2;
          }
        }
      }
    }
#pragma unroll
    for (int a = 0; a < NA; ++a) acc[a] = acc[a] + part[a];
  }

  // (mass_conv, mass_diff, conv[3], pres[3], visc[3])
  float mc, md, conv[3], pres[3], vis[3];
  if constexpr (FORM == kXla || FORM == kFactored) {
    mc = acc[0];
    md = acc[1];
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      conv[d] = acc[2 + d];
      pres[d] = acc[5 + d];
      vis[d] = acc[8 + d];
    }
  } else {
    float B2, B[3];
    int c0, p0, v0;  // first conv / pres / visc accumulator
    if constexpr (FORM == kJconv) {
      B2 = acc[2];
      B[0] = acc[3];
      B[1] = acc[4];
      B[2] = acc[5];
      c0 = 6, p0 = 9, v0 = 12;
    } else {
      const size_t N = static_cast<size_t>(nz) * plane;
      B2 = actconv[n];
      B[0] = actconv[N + n];
      B[1] = actconv[2 * N + n];
      B[2] = actconv[3 * N + n];
      c0 = 2, p0 = 5, v0 = 8;
    }
    const float F = (mi[0] * B[0] + mi[1] * B[1]) + mi[2] * B[2];
    mc = acc[0] - F;
    md = acc[1] - ri * B2;
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      conv[d] = acc[c0 + d] - vi[d] * F;
      pres[d] = acc[p0 + d] - pi * B[d];
      vis[d] = acc[v0 + d] - vi[d] * B2;
    }
  }

  const float dt = *dt_ptr;
  const float neg_a = -a_inv_vh;
  float rn = ri + dt * (neg_a * mc + dens * md);
  // clip that keeps a NaN (the flow solve's divergence check looks for it)
  rn = rn < rho_lo ? rho_lo : rn;
  rn = rn > rho_hi ? rho_hi : rn;
  const float scale = dt * (1.0f / ri);
  rho_out[n] = rn;
#pragma unroll
  for (int d = 0; d < 3; ++d)
    vel_out[3 * n + d] =
        vi[d] + scale * (neg_a * (conv[d] + pres[d]) + visc * vis[d]);
}

}  // namespace

PD_EXPORT int pd_ns3d_chunked(int form, const float* rho, const float* vel,
                              const float* p, const uint8_t* node_type,
                              const float* actconv, const float* dt,
                              const int* offs, const float* coefs,
                              const int* chunk_end, int nchunk, int S, int nz,
                              int ny, int nx, int bz, float dens,
                              float a_inv_vh, float visc, float rho_lo,
                              float rho_hi, float* rho_out, float* vel_out,
                              int device, void* stream) {
  if (S < 1 || S > pd::kMaxSlots || nchunk < 1 || nchunk > kMaxChunks ||
      bz < 1 || bz > 64 || pd::kThreads % bz != 0 ||
      (form == kJstat) != (actconv != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int bx = pd::kThreads / bz;
  const dim3 block(bx, 1, bz);
  const dim3 grid((ny * nx + bx - 1) / bx, 1, (nz + bz - 1) / bz);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PD_LAUNCH(F)                                                        \
  ns3d_chunked_kernel<F><<<grid, block, 0, st>>>(                           \
      rho, vel, p, node_type, actconv, dt, offs, coefs, chunk_end, nchunk, \
      S, nz, ny, nx, dens, a_inv_vh, visc, rho_lo, rho_hi, rho_out, vel_out)
  switch (form) {
    case kXla: PD_LAUNCH(kXla); break;
    case kFactored: PD_LAUNCH(kFactored); break;
    case kJconv: PD_LAUNCH(kJconv); break;
    case kJstat: PD_LAUNCH(kJstat); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef PD_LAUNCH
  return static_cast<int>(cudaGetLastError());
}
