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
// p2g_bwd_kernel<false>: port of _p2g_bwd_kernel (K4, :288): the VJP of K3,
//   a gather of the (G^3, 4) cotangent over the 27 cells -> dx, dv, daffine.
// p2g_bwd_kernel<true>: port of _mass_bwd_kernel (K7 backward, :970): d/dx
//   of the mass-only P2G.
// g2p_bwd_kernel: port of _g2p_bwd_kernel (K6, :388): the VJP of K5 ->
//   d grid_v by atomicAdd into a zeroed (G^3, 3) grid, and dx, with the
//   strict advection mask lo < x + dt v < hi of :450-477.
// The backward kernels gather without atomics (K4, K7) or scatter like K3
// (K6); the grids stay in L2. d/dx runs through the spline weights
// (dW/dpx, chained by inv_dx) and through dpos = cell - px (d/dpx = -1).
//
// The stencil follows plasticinelab_tpu/engine/transfer.py:99-119 with the
// crop edge D = G and offset 0: base = floor(px - 0.5) clamped to
// [0, G-3], weights from the unclamped fraction, dpos = cell - px in grid
// units. Flat cell index (i * G + j) * G + k, in 64 bits.
//
// Every kernel takes a batch of B envs of n particles each, env-major:
// particle p belongs to env p / n and scatters into, or gathers from, that
// env's grid at grid + env G^3 C. They replace the batched grids of the same
// TPU kernels too (pallas_local.py:725 transfer_fns_batched: K3-b :767,
// K4-b :780, K5-b :793, K6-b :805; :865 mass_fns_batched: K7-fwd-b :892,
// K7-bwd-b :904). One env is B = 1.
#include "common.cuh"

namespace {

using plb::jmax;
using plb::jmin;

struct Stencil {
  float px[3];
  int base[3];
  float w[3][3];   // w[tap][axis]
  float dw[3][3];  // dw/dpx[tap][axis]
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
    s.dw[0][d] = fx - 1.5f;
    s.dw[1][d] = -2.0f * (fx - 1.0f);
    s.dw[2][d] = fx - 0.5f;
  }
  return s;
}

// grid + env G^3 channels: the grid of the env that particle p belongs to
__device__ __forceinline__ long long env_grid(long long p, long long n_env, int G, int channels) {
  const long long GG = G;
  return (p / n_env) * GG * GG * GG * channels;
}

template <bool MASS_ONLY>
__global__ void p2g_kernel(const float* __restrict__ x, const float* __restrict__ v,
                           const float* __restrict__ aff, float* __restrict__ grid, long long n,
                           long long total, int G, float inv_dx, float dx, float p_mass) {
  const long long p = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (p >= total) return;
  grid += env_grid(p, n, G, MASS_ONLY ? 1 : 4);
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
                           float* __restrict__ new_x, long long n, long long total, int G,
                           float inv_dx, float dt, float x_hi) {
  const long long p = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (p >= total) return;
  grid_v += env_grid(p, n, G, 3);
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

template <bool MASS_ONLY>
__global__ void p2g_bwd_kernel(const float* __restrict__ x, const float* __restrict__ v,
                               const float* __restrict__ aff, const float* __restrict__ ct,
                               float* __restrict__ gx, float* __restrict__ gv,
                               float* __restrict__ gaff, long long n, long long total, int G,
                               float inv_dx, float dx, float p_mass) {
  const long long p = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (p >= total) return;
  ct += env_grid(p, n, G, MASS_ONLY ? 1 : 4);
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
  float gpx[3] = {0.0f, 0.0f, 0.0f}, gvp[3] = {0.0f, 0.0f, 0.0f}, gA[3][3] = {};
  const long long GG = G;
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int b = 0; b < 3; ++b)
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float W = s.w[a][0] * s.w[b][1] * s.w[c][2];
        const float dW[3] = {s.dw[a][0] * s.w[b][1] * s.w[c][2], s.w[a][0] * s.dw[b][1] * s.w[c][2],
                             s.w[a][0] * s.w[b][1] * s.dw[c][2]};
        const int ci = s.base[0] + a, cj = s.base[1] + b, ck = s.base[2] + c;
        const long long cell = (ci * GG + cj) * GG + ck;
        if (MASS_ONLY) {
          const float t = p_mass * __ldg(ct + cell);
#pragma unroll
          for (int d = 0; d < 3; ++d) gpx[d] += dW[d] * t;
        } else {
          const float dp[3] = {ci - s.px[0], cj - s.px[1], ck - s.px[2]};
          const float cm = __ldg(ct + cell * 4 + 3);
          float S = p_mass * cm;  // sum over channels of contribution x cotangent
          float cs[3];
#pragma unroll
          for (int i = 0; i < 3; ++i) {
            cs[i] = __ldg(ct + cell * 4 + i);
            const float mom = p_mass * vp[i] + dx * (A[i][0] * dp[0] + A[i][1] * dp[1] + A[i][2] * dp[2]);
            S += mom * cs[i];
            gvp[i] += W * p_mass * cs[i];
#pragma unroll
            for (int j = 0; j < 3; ++j) gA[i][j] += W * dx * dp[j] * cs[i];
          }
#pragma unroll
          for (int d = 0; d < 3; ++d) {
            // through the weights, and through dpos_d (d dpos_d / dpx_d = -1)
            const float through_dpos = cs[0] * A[0][d] + cs[1] * A[1][d] + cs[2] * A[2][d];
            gpx[d] += dW[d] * S - W * dx * through_dpos;
          }
        }
      }
#pragma unroll
  for (int d = 0; d < 3; ++d) gx[p * 3 + d] = inv_dx * gpx[d];
  if (!MASS_ONLY) {
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      gv[p * 3 + i] = gvp[i];
#pragma unroll
      for (int j = 0; j < 3; ++j) gaff[p * 9 + i * 3 + j] = gA[i][j];
    }
  }
}

__global__ void g2p_bwd_kernel(const float* __restrict__ x, const float* __restrict__ grid_v,
                               const float* __restrict__ ct_v, const float* __restrict__ ct_C,
                               const float* __restrict__ ct_x, float* __restrict__ gx,
                               float* __restrict__ g_grid, long long n, long long total, int G,
                               float inv_dx, float dt, float x_hi) {
  const long long p = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (p >= total) return;
  grid_v += env_grid(p, n, G, 3);
  g_grid += env_grid(p, n, G, 3);
  const Stencil s = make_stencil(x, p, G, inv_dx);
  const long long GG = G;
  // the forward velocity, for the advection mask
  float vel[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int b = 0; b < 3; ++b)
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float W = s.w[a][0] * s.w[b][1] * s.w[c][2];
        const long long cell = ((s.base[0] + a) * GG + s.base[1] + b) * GG + s.base[2] + c;
#pragma unroll
        for (int i = 0; i < 3; ++i) vel[i] += W * __ldg(grid_v + cell * 3 + i);
      }
  // effective cotangents: v gets the advection's dt * ct_x where the clamp
  // is inactive; C's cotangent carries the 4 inv_dx factor
  float adv[3], cv[3], cM[3][3];
  const float c4 = 4.0f * inv_dx;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float xa = x[p * 3 + i] + dt * vel[i];
    adv[i] = (xa > 0.0f && xa < x_hi) ? 1.0f : 0.0f;
    cv[i] = ct_v[p * 3 + i] + dt * adv[i] * ct_x[p * 3 + i];
#pragma unroll
    for (int j = 0; j < 3; ++j) cM[i][j] = c4 * ct_C[p * 9 + i * 3 + j];
  }
  float gpx[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int b = 0; b < 3; ++b)
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float W = s.w[a][0] * s.w[b][1] * s.w[c][2];
        const float dW[3] = {s.dw[a][0] * s.w[b][1] * s.w[c][2], s.w[a][0] * s.dw[b][1] * s.w[c][2],
                             s.w[a][0] * s.w[b][1] * s.dw[c][2]};
        const int ci = s.base[0] + a, cj = s.base[1] + b, ck = s.base[2] + c;
        const long long cell = (ci * GG + cj) * GG + ck;
        const float dp[3] = {ci - s.px[0], cj - s.px[1], ck - s.px[2]};
        float ge = 0.0f, gM[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          const float g = __ldg(grid_v + cell * 3 + i);
          const float e = cv[i] + cM[i][0] * dp[0] + cM[i][1] * dp[1] + cM[i][2] * dp[2];
          atomicAdd(g_grid + cell * 3 + i, W * e);
          ge += g * e;
#pragma unroll
          for (int d = 0; d < 3; ++d) gM[d] += g * cM[i][d];
        }
#pragma unroll
        for (int d = 0; d < 3; ++d) gpx[d] += dW[d] * ge - W * gM[d];
      }
#pragma unroll
  for (int d = 0; d < 3; ++d) gx[p * 3 + d] = inv_dx * gpx[d] + adv[d] * ct_x[p * 3 + d];
}

}  // namespace

// Every entry point takes B envs of n particles each (x (B, n, 3), grids and
// their cotangents (B, G^3, C)); one env is B = 1.
extern "C" int plb_p2g(const float* x, const float* v, const float* affine, float* grid4,
                       long long n, int B, int G, float inv_dx, float dx, float p_mass,
                       int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long total = n * B;
  if (total > 0) {
    p2g_kernel<false><<<plb::blocks_for(total), plb::kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(x, v, affine, grid4, n, total, G,
                                                             inv_dx, dx, p_mass);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int plb_grid_mass(const float* x, float* grid_m, long long n, int B, int G,
                             float inv_dx, float p_mass, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long total = n * B;
  if (total > 0) {
    p2g_kernel<true><<<plb::blocks_for(total), plb::kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(x, nullptr, nullptr, grid_m, n, total,
                                                            G, inv_dx, 0.0f, p_mass);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int plb_g2p(const float* x, const float* grid_v, float* new_v, float* new_C,
                       float* new_x, long long n, int B, int G, float inv_dx, float dt,
                       float x_hi, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long total = n * B;
  if (total > 0) {
    g2p_kernel<<<plb::blocks_for(total), plb::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        x, grid_v, new_v, new_C, new_x, n, total, G, inv_dx, dt, x_hi);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int plb_p2g_bwd(const float* x, const float* v, const float* affine, const float* ct,
                           float* gx, float* gv, float* gaffine, long long n, int B, int G,
                           float inv_dx, float dx, float p_mass, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long total = n * B;
  if (total > 0) {
    p2g_bwd_kernel<false><<<plb::blocks_for(total), plb::kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(x, v, affine, ct, gx, gv,
                                                                 gaffine, n, total, G, inv_dx, dx,
                                                                 p_mass);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int plb_grid_mass_bwd(const float* x, const float* ct, float* gx, long long n, int B,
                                 int G, float inv_dx, float p_mass, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long total = n * B;
  if (total > 0) {
    p2g_bwd_kernel<true><<<plb::blocks_for(total), plb::kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(x, nullptr, nullptr, ct, gx,
                                                                nullptr, nullptr, n, total, G,
                                                                inv_dx, 0.0f, p_mass);
  }
  return static_cast<int>(cudaGetLastError());
}

// g_grid (B, G^3, 3) comes in zeroed
extern "C" int plb_g2p_bwd(const float* x, const float* grid_v, const float* ct_v,
                           const float* ct_C, const float* ct_x, float* gx, float* g_grid,
                           long long n, int B, int G, float inv_dx, float dt, float x_hi,
                           int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long total = n * B;
  if (total > 0) {
    g2p_bwd_kernel<<<plb::blocks_for(total), plb::kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(x, grid_v, ct_v, ct_C, ct_x, gx, g_grid,
                                                          n, total, G, inv_dx, dt, x_hi);
  }
  return static_cast<int>(cudaGetLastError());
}
