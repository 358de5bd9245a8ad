// matvec2d: y = diag*x + sum_s W_s * shift_s(x) on unknown rows, 0 elsewhere
// (f32) — the implicit-transport operator M of one coupling cycle.
//
// Replaces: pd_mg_pin_corrosion_tpu/pallas_kernels.py, _matvec_kernel
// (body) and matvec_M_pallas (entry); math of ops/ard_implicit.py matvec_M.
// Called by every GMRES operator application, every Neumann-2
// preconditioner sweep and compute_adaptive_dt.
//
// Contract (plain twin: kernels/matvec2d.py matvec2d_plain): slots are
// accumulated in reference stencil order, acc = (acc + W_s*x_j), starting
// from diag*x, so with -fmad=false the result equals the plain version bit
// for bit. A neighbour outside the grid reads x = 0 (its W is 0 as well);
// rows that are not unknown write an exact 0 and read no weights.
//
// What bounds it on an H100: the weight stack. At 196,749 nodes and S = 36
// W is 28.3 MB of f32 per call against ~2.4 MB for x, diag, unknown and y,
// so a call is ~31 MB of HBM traffic (~9 us at 3.35 TB/s); W fits the 50 MB
// L2, so back-to-back calls inside one GMRES cycle may run from L2.
//
// Design: one thread per node over the flat index; W is laid out [S, Ny, Nx]
// so each slot's weight read is one coalesced row segment per warp, and x
// is re-read from L1/L2 by the 36 neighbouring threads. Slot offsets are
// staged in shared memory per block. Tiling x through shared memory and
// streaming W with TMA / cp.async is later work.

#include "common.cuh"

namespace {

__global__ void __launch_bounds__(pd::kThreads)
matvec2d_kernel(const float* __restrict__ x, const float* __restrict__ W,
                const float* __restrict__ diag,
                const uint8_t* __restrict__ unknown,
                const int* __restrict__ offs, int S, int ny, int nx,
                float* __restrict__ y) {
  __shared__ int s_dj[pd::kMaxSlots], s_di[pd::kMaxSlots];
  for (int s = threadIdx.x; s < S; s += blockDim.x) {
    s_dj[s] = offs[2 * s];
    s_di[s] = offs[2 * s + 1];
  }
  __syncthreads();

  const int N = ny * nx;
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  if (!unknown[n]) {
    y[n] = 0.0f;
    return;
  }
  const int j = n / nx;
  const int i = n - j * nx;
  float acc = diag[n] * x[n];
  for (int s = 0; s < S; ++s) {
    const int jj = j + s_dj[s];
    const int ii = i + s_di[s];
    if (jj < 0 || jj >= ny || ii < 0 || ii >= nx) continue;
    acc = acc + W[static_cast<long long>(s) * N + n] * x[jj * nx + ii];
  }
  y[n] = acc;
}

}  // namespace

PD_EXPORT int pd_matvec2d(const float* x, const float* W, const float* diag,
                          const uint8_t* unknown, const int* offs, int S,
                          int ny, int nx, float* y, int device,
                          void* stream) {
  if (S < 1 || S > pd::kMaxSlots) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n = static_cast<long long>(ny) * nx;
  matvec2d_kernel<<<pd::blocks_for(n), pd::kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      x, W, diag, unknown, offs, S, ny, nx, y);
  return static_cast<int>(cudaGetLastError());
}
