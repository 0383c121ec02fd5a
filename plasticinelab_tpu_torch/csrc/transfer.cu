// Particle<->grid transfer kernels on the full G^3 grid, one thread per
// particle over its 27-cell quadratic B-spline stencil.
//
// p2g_kernel<false>: port of plasticinelab_tpu/engine/pallas_local.py
//   _p2g_fwd_kernel (K3): mom_s += W (p_mass v_s + dx affine_s . dpos),
//   mass += W p_mass, by atomicAdd into a zeroed (G^3, 4) grid.
// p2g_kernel<true>: the mass-only form, port of _mass_fwd_kernel (K7
//   forward), into a zeroed (G^3,) grid.
// g2p_kernel: port of _g2p_fwd_kernel (K5): v = sum W g,
//   C = 4 inv_dx sum W g dpos^T, and the advection clamp (:272-281).
//
// The stencil follows plasticinelab_tpu/engine/transfer.py:99-119 with the
// crop edge D = G and offset 0: base = floor(px - 0.5) clamped to
// [0, G-3], weights from the unclamped fraction, dpos = cell - px in grid
// units. Flat cell index (i * G + j) * G + k, in 64 bits.
#include "common.cuh"

namespace {

using plb::jmax;
using plb::jmin;

struct Stencil {
  float px[3];
  int base[3];
  float w[3][3];  // w[tap][axis]
};

__device__ __forceinline__ Stencil make_stencil(const float* __restrict__ x, long long p, int G,
                                                float inv_dx) {
  Stencil s;
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const float px = x[p * 3 + d] * inv_dx;
    const float b = floorf(px - 0.5f);
    const float fx = px - b;
    const int bi = static_cast<int>(b);
    s.px[d] = px;
    s.base[d] = bi < 0 ? 0 : (bi > G - 3 ? G - 3 : bi);
    s.w[0][d] = 0.5f * plb::sq(1.5f - fx);
    s.w[1][d] = 0.75f - plb::sq(fx - 1.0f);
    s.w[2][d] = 0.5f * plb::sq(fx - 0.5f);
  }
  return s;
}

template <bool MASS_ONLY>
__global__ void p2g_kernel(const float* __restrict__ x, const float* __restrict__ v,
                           const float* __restrict__ aff, float* __restrict__ grid, long long n,
                           int G, float inv_dx, float dx, float p_mass) {
  const long long p = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (p >= n) return;
  const Stencil s = make_stencil(x, p, G, inv_dx);
  float vp[3] = {0.0f, 0.0f, 0.0f}, A[3][3] = {};
  if (!MASS_ONLY) {
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      vp[i] = v[p * 3 + i];
#pragma unroll
      for (int j = 0; j < 3; ++j) A[i][j] = aff[p * 9 + i * 3 + j];
    }
  }
  const long long GG = G;
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int b = 0; b < 3; ++b)
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float W = s.w[a][0] * s.w[b][1] * s.w[c][2];
        const int ci = s.base[0] + a, cj = s.base[1] + b, ck = s.base[2] + c;
        const long long cell = (ci * GG + cj) * GG + ck;
        if (MASS_ONLY) {
          atomicAdd(grid + cell, W * p_mass);
        } else {
          const float dp[3] = {ci - s.px[0], cj - s.px[1], ck - s.px[2]};
#pragma unroll
          for (int i = 0; i < 3; ++i) {
            const float mom = p_mass * vp[i] + dx * (A[i][0] * dp[0] + A[i][1] * dp[1] + A[i][2] * dp[2]);
            atomicAdd(grid + cell * 4 + i, W * mom);
          }
          atomicAdd(grid + cell * 4 + 3, W * p_mass);
        }
      }
}

__global__ void g2p_kernel(const float* __restrict__ x, const float* __restrict__ grid_v,
                           float* __restrict__ new_v, float* __restrict__ new_C,
                           float* __restrict__ new_x, long long n, int G, float inv_dx, float dt,
                           float x_hi) {
  const long long p = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (p >= n) return;
  const Stencil s = make_stencil(x, p, G, inv_dx);
  float vel[3] = {0.0f, 0.0f, 0.0f}, M[3][3] = {};
  const long long GG = G;
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int b = 0; b < 3; ++b)
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float W = s.w[a][0] * s.w[b][1] * s.w[c][2];
        const int ci = s.base[0] + a, cj = s.base[1] + b, ck = s.base[2] + c;
        const long long cell = (ci * GG + cj) * GG + ck;
        const float dp[3] = {ci - s.px[0], cj - s.px[1], ck - s.px[2]};
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          const float g = __ldg(grid_v + cell * 3 + i);
          vel[i] += W * g;
#pragma unroll
          for (int j = 0; j < 3; ++j) M[i][j] += W * g * dp[j];
        }
      }
  const float c4 = 4.0f * inv_dx;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    new_v[p * 3 + i] = vel[i];
#pragma unroll
    for (int j = 0; j < 3; ++j) new_C[p * 9 + i * 3 + j] = c4 * M[i][j];
    // advection with the domain clamp (pallas_local.py:272-281)
    new_x[p * 3 + i] = jmax(jmin(x[p * 3 + i] + dt * vel[i], x_hi), 0.0f);
  }
}

}  // namespace

extern "C" int plb_p2g(const float* x, const float* v, const float* affine, float* grid4,
                       long long n, int G, float inv_dx, float dx, float p_mass, int device,
                       void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n > 0) {
    p2g_kernel<false><<<plb::blocks_for(n), plb::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        x, v, affine, grid4, n, G, inv_dx, dx, p_mass);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int plb_grid_mass(const float* x, float* grid_m, long long n, int G, float inv_dx,
                             float p_mass, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n > 0) {
    p2g_kernel<true><<<plb::blocks_for(n), plb::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        x, nullptr, nullptr, grid_m, n, G, inv_dx, 0.0f, p_mass);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int plb_g2p(const float* x, const float* grid_v, float* new_v, float* new_C,
                       float* new_x, long long n, int G, float inv_dx, float dt, float x_hi,
                       int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n > 0) {
    g2p_kernel<<<plb::blocks_for(n), plb::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        x, grid_v, new_v, new_C, new_x, n, G, inv_dx, dt, x_hi);
  }
  return static_cast<int>(cudaGetLastError());
}
