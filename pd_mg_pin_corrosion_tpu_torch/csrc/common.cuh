// Shared helpers of the port's hand-written CUDA kernels (sm_90a).
//
// Every C entry point takes raw device pointers (torch data_ptr()), the
// CUDA device index and the caller's stream, launches asynchronously on
// that stream, and returns cudaGetLastError() so the Python wrapper can
// raise on a refused launch. Nothing here allocates or synchronises.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define PD_EXPORT extern "C" __attribute__((visibility("default")))

namespace pd {

// NodeType values (grid.py; reference src/grid.h:9-17)
constexpr uint8_t kFluid = 0;
constexpr uint8_t kOutside = 5;

// upper bound on stencil slots a launch may carry in shared memory
// (2D: m_ratio = 3 gives 36 slots, m_ratio = 5 gives 88; 3D: m_ratio = 3
// gives 178)
constexpr int kMaxSlots = 256;

constexpr int kThreads = 256;

inline int blocks_for(long long n, int threads = kThreads) {
  return static_cast<int>((n + threads - 1) / threads);
}

}  // namespace pd
