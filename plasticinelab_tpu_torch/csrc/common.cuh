// Helpers shared by the kernels of plasticinelab_tpu_torch.
#pragma once

#include <cuda_runtime.h>

namespace plb {

// max/min that propagate NaN from either operand, like the reference's
// elementwise maximum/minimum (fmaxf/fminf would drop a NaN).
__device__ __forceinline__ float jmax(float a, float b) { return (a > b || a != a) ? a : b; }
__device__ __forceinline__ float jmin(float a, float b) { return (a < b || a != a) ? a : b; }

__device__ __forceinline__ float sq(float a) { return a * a; }

constexpr int kThreads = 256;

inline unsigned int blocks_for(long long n, int threads = kThreads) {
  return static_cast<unsigned int>((n + threads - 1) / threads);
}

}  // namespace plb
