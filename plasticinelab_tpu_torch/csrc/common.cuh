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

// A block's rows [first, first + rows) of an (n, W) float32 array are one
// contiguous slab of W rows floats: the whole block writes it from shared
// memory s, 16 bytes a thread where it is 16-byte aligned. Stored by each
// thread at a 12- or 36-byte stride instead, every warp's store instruction
// touches ~32 sectors for 128 bytes: the L2 then takes up to ~9x the write
// transactions (the stress kernels, K5: PERF.md).
template <int W>
__device__ __forceinline__ void store_rows(float* __restrict__ g, long long first, int rows,
                                           const float* s) {
  float* dst = g + first * W;
  const int m = rows * W;
  int done = 0;
  if ((reinterpret_cast<unsigned long long>(dst) & 15) == 0) {
    done = m & ~3;
    for (int i = threadIdx.x; i < (m >> 2); i += blockDim.x)
      reinterpret_cast<float4*>(dst)[i] = reinterpret_cast<const float4*>(s)[i];
  }
  for (int i = done + threadIdx.x; i < m; i += blockDim.x) dst[i] = s[i];
}

}  // namespace plb
