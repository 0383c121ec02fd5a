// Particle<->grid transfer kernels on the full G^3 grid, one thread per
// particle over its 27-cell quadratic B-spline stencil.
//
// p2g_kernel<false>: port of plasticinelab_tpu/engine/pallas_local.py
//   _p2g_fwd_kernel (K3): mom_s += W (p_mass v_s + dx affine_s . dpos),
//   mass += W p_mass, summed into a zeroed (G^3, 4) grid.
// p2g_kernel<true>: the mass-only form, port of _mass_fwd_kernel (K7
//   forward), into a zeroed (G^3,) grid.
// g2p_kernel: port of _g2p_fwd_kernel (K5): v = sum W g,
//   C = 4 inv_dx sum W g dpos^T, and the advection clamp (:272-281).
// p2g_bwd_kernel<false>: port of _p2g_bwd_kernel (K4, :288): the VJP of K3,
//   a gather of the (G^3, 4) cotangent over the 27 cells -> dx, dv, daffine.
// p2g_bwd_kernel<true>: port of _mass_bwd_kernel (K7 backward, :970): d/dx
//   of the mass-only P2G.
// g2p_bwd_kernel: port of _g2p_bwd_kernel (K6, :388): the VJP of K5 ->
//   d grid_v summed into a zeroed (G^3, 3) grid like K3, and dx, a gather,
//   with the strict advection mask lo < x + dt v < hi of :450-477.
// d/dx runs through the spline weights (dW/dpx, chained by inv_dx) and
// through dpos = cell - px (d/dpx = -1).
//
// The stencil follows plasticinelab_tpu/engine/transfer.py:99-119 with the
// crop edge D = G and offset 0: base = floor(px - 0.5) clamped to
// [0, G-3], weights from the unclamped fraction, dpos = cell - px in grid
// units. Flat cell index (i * G + j) * G + k, in 64 bits.
//
// Every kernel takes a batch of B envs of n particles each, env-major:
// a particle of env b scatters into, or gathers from, that env's grid at
// grid + b G^3 C. They replace the batched grids of the same TPU kernels too
// (pallas_local.py:725 transfer_fns_batched: K3-b :767, K4-b :780, K5-b
// :793, K6-b :805; :865 mass_fns_batched: K7-fwd-b :892, K7-bwd-b :904).
// One env is B = 1.
//
// The scatters (K3, K7 forward, K6's d grid_v). A cloud touches about one
// cell in a hundred, so one float atomicAdd per particle, cell and channel
// lands some hundred adds on every touched address, which the L2 serialises:
// the L2's atomic unit, not bytes or arithmetic, bounds them. They therefore
// reduce on the SM first:
// - blocks of kScatterThreads consecutive entries of one env's particle
//   order (grid: blocks x envs, so no warp mixes envs). The caller passes a
//   permutation of each env's particles sorted by base cell
//   (`engine/transfer.py` cell_order, computed once per env step), so the
//   lanes of a warp hold runs of particles of one base cell. The state keeps
//   its order: thread t reads particle order[t].
// - lanes of a warp whose particles share a base cell share all 27 cells:
//   they are found once with __match_any_sync, every contribution is summed
//   over them with shuffles along a schedule built once per thread (a binary
//   tree over the lanes of the group), and the group's first lane alone adds
//   to global memory: about one add in six is left on a sorted cloud.
// - a lane whose neighbours lie in other cells is a group of its own. So any
//   order gives the same sums, a stale or no order (nullptr: the particles
//   as they lie) only more global atomics.
// - the add is a predicated `red`, never a branch (red_add_if).
// Measured slower on the H100 and left out (PERF.md): a shared-memory tile
// per block under the groups (its shared float atomics cost more than the
// global ones they save), and the 4 channels of a cell as one 16-byte
// vector atomic (dear where few lanes add to cells that neighbouring warps
// add to at the same time).
// Sums are taken in a run-dependent order: not bitwise reproducible.
//
// The gathers (K5, K4, K7 backward) read the grid, or its cotangent, under
// each particle's stencil and write the particle's rows; no atomics, and
// each particle's sums run in a fixed order, so its outputs are the same
// bits for any B and launch shape. The cells under the stencils of even 32
// envs fit the L2 (~23 MB); what moved their time on the H100 was each
// thread's chain and the particles' own rows (measured, PERF.md):
// - they walk each env's particles as they lie: blocks of consecutive
//   particles, grid (blocks, envs). Walking the scatters' cell order lets
//   the lanes of a warp share cells, but puts every particle's 24 to 120
//   bytes of rows at permuted addresses: K5 and K4 1.4-2.4x slower.
// - K5 and K4 sum each plane a of the stencil alone, into accumulators of
//   its own, and add the three planes at the end (stencil_sums): three
//   chains of 9 cells, up to 1.7x faster than one running sum over 27,
//   which K7 backward keeps (as fast there).
// - K5 reads each k-run of 3 cells (9 floats) as the three aligned 16-byte
//   loads that cover it, K4 each cotangent cell (16 bytes) as one load.
// - K5 stores through shared memory, one slab per output array written 16
//   bytes a thread, from kSlabFrom particles of all envs on.
// Measured and left out: three lanes per particle, one plane each, combined
// by shuffles (as fast as one thread per particle at 10,000 particles,
// slower from 40,000 on), and registers capped at 64-96 for K4.
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

// ---------------------------------------------------------------------------
// the scatters' reduction on the SM (see the header)
// ---------------------------------------------------------------------------

constexpr int kScatterThreads = 256;  // entries of an env's order per block
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kPeerRounds = 5;  // a group is at most a warp: 2^5 lanes

// The particle a thread of a scatter block works on: entry `slot` of env
// blockIdx.y's order (the identity without one). A thread past the env's
// last particle is not `valid`: it computes on the env's first particle, so
// that it can take part in the warp's shuffles, and adds and stores nothing.
struct Slot {
  bool valid;
  long long q;  // index into the (B n) particle arrays
};

__device__ __forceinline__ Slot block_slot(const int* __restrict__ order, long long n) {
  const long long env = blockIdx.y;
  const long long slot = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  Slot s;
  s.valid = slot < n;
  const long long local = s.valid ? (order != nullptr ? order[env * n + slot] : slot) : 0;
  s.q = env * n + local;
  return s;
}

// The lanes of a warp whose particles share a base cell, and the schedule
// by which their values are summed into the group's first lane, which
// `adds` for all: in round r a lane whose rank in the group is a multiple of
// 2^(r+1) adds the value of the lane of rank + 2^r, src[r] (-1: none).
// `rounds` is the depth of the warp's largest group, so every lane shuffles
// alike. A lane without a valid particle is a group of its own that adds
// nothing.
struct Peers {
  int src[kPeerRounds];
  int rounds;
  bool adds;
};

__device__ __forceinline__ Peers make_peers(const Slot& me, const int base[3], int G) {
  const unsigned lane = threadIdx.x & 31;
  const int key = me.valid ? (base[0] * G + base[1]) * G + base[2] : -1 - static_cast<int>(lane);
  const unsigned peers = __match_any_sync(kFullMask, key);
  const int rank = __popc(peers & ((1u << lane) - 1u));
  Peers g;
  g.adds = rank == 0 && me.valid;
  const int largest = __reduce_max_sync(kFullMask, __popc(peers));
  g.rounds = 32 - __clz(largest - 1);
  unsigned above = peers & ~((2u << lane) - 1u);  // the group's lanes above this one
#pragma unroll
  for (int r = 0; r < kPeerRounds; ++r) {
    // `above` has lost its 2^r - 1 lowest lanes: its lowest is rank + 2^r
    g.src[r] = ((rank & ((2 << r) - 1)) == 0 && above != 0u) ? __ffs(above) - 1 : -1;
#pragma unroll
    for (int drop = 0; drop < (1 << r); ++drop) above &= above - 1u;
  }
  return g;
}

// One global add of `val` by the lanes whose `adds` is set, as a predicated
// `red` with no branch: a branch on `adds` would let the compiler split the
// unrolled stencil loop into a copy per kind of lane, the warp would run
// the copies diverged, and every shuffle of `peer_sum` would first have to
// bring the warp together again (measured: 5x the kernel's time).
__device__ __forceinline__ void red_add_if(bool adds, float* dst, float val) {
  asm volatile(
      "{\n"
      "  .reg .pred p;\n"
      "  setp.ne.s32 p, %0, 0;\n"
      "  @p red.global.add.f32 [%1], %2;\n"
      "}" ::"r"(static_cast<int>(adds)),
      "l"(__cvta_generic_to_global(dst)), "f"(val));
}

// the sum of x over the lane's group, in its first lane
__device__ __forceinline__ float peer_sum(const Peers& g, float x) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int r = 0; r < kPeerRounds; ++r) {
    if (r < g.rounds) {
      const float other = __shfl_sync(kFullMask, x, g.src[r] < 0 ? lane : g.src[r]);
      x += g.src[r] >= 0 ? other : 0.0f;
    }
  }
  return x;
}

// grid: zeroed. Blocks of kScatterThreads, grid (blocks over n, B).
template <bool MASS_ONLY>
__global__ void __launch_bounds__(kScatterThreads)
p2g_kernel(const float* __restrict__ x, const float* __restrict__ v,
           const float* __restrict__ aff, const int* __restrict__ order,
           float* __restrict__ grid, long long n, int G, float inv_dx, float dx, float p_mass) {
  constexpr int C = MASS_ONLY ? 1 : 4;
  const long long GG = G;
  grid += blockIdx.y * GG * GG * GG * C;
  const Slot me = block_slot(order, n);
  const long long p = me.q;
  const Stencil s = make_stencil(x, p, G, inv_dx);
  const Peers g = make_peers(me, s.base, G);
  float vp[3] = {0.0f, 0.0f, 0.0f}, A[3][3] = {};
  if (!MASS_ONLY) {
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      vp[i] = v[p * 3 + i];
#pragma unroll
      for (int j = 0; j < 3; ++j) A[i][j] = aff[p * 9 + i * 3 + j];
    }
  }
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int b = 0; b < 3; ++b)
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float W = s.w[a][0] * s.w[b][1] * s.w[c][2];
        const int ci = s.base[0] + a, cj = s.base[1] + b, ck = s.base[2] + c;
        float* dst = grid + ((ci * GG + cj) * GG + ck) * C;
        if (!MASS_ONLY) {
          const float dp[3] = {ci - s.px[0], cj - s.px[1], ck - s.px[2]};
#pragma unroll
          for (int i = 0; i < 3; ++i) {
            const float mom = p_mass * vp[i] + dx * (A[i][0] * dp[0] + A[i][1] * dp[1] + A[i][2] * dp[2]);
            red_add_if(g.adds, dst + i, peer_sum(g, W * mom));
          }
        }
        red_add_if(g.adds, dst + C - 1, peer_sum(g, W * p_mass));
      }
}

// ---------------------------------------------------------------------------
// the gathers (K5, K4, K7 backward; see the header)
// ---------------------------------------------------------------------------

// A gather block: THREADS consecutive particles of env blockIdx.y, as they
// lie. A thread past the env's last particle computes on the block's first
// and stores nothing.
struct GatherRow {
  long long first;  // the block's first particle, an index into the (B n) arrays
  int rows;         // the block's particles
  bool valid;
  long long p;      // this thread's particle
};

template <int THREADS>
__device__ __forceinline__ GatherRow gather_row(long long n) {
  GatherRow g;
  const long long start = static_cast<long long>(blockIdx.x) * THREADS;
  g.first = blockIdx.y * n + start;
  g.rows = static_cast<int>(n - start < THREADS ? n - start : THREADS);
  g.valid = static_cast<int>(threadIdx.x) < g.rows;
  g.p = g.first + (g.valid ? threadIdx.x : 0);
  return g;
}

// the k-run of 3 cells [cell, cell + 3) of a (G^3, 3) grid, 9 floats: from
// the three 16-byte loads that cover it (RUNS: the grid 16-byte aligned and
// its 3 G^3 floats a multiple of 4, so no load leaves it) or 9 scalar loads
template <bool RUNS>
__device__ __forceinline__ void load_run(const float* __restrict__ g, long long cell, float (&r)[9]) {
  if (RUNS) {
    const long long f = cell * 3;
    const float4* q = reinterpret_cast<const float4*>(g) + (f >> 2);
    const int sh = static_cast<int>(f & 3);
    const float4 q0 = __ldg(q), q1 = __ldg(q + 1), q2 = __ldg(q + 2);
    const float w[12] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z, q1.w, q2.x, q2.y, q2.z, q2.w};
    float t[10];
#pragma unroll
    for (int i = 0; i < 10; ++i) t[i] = (sh & 2) ? w[i + 2] : w[i];
#pragma unroll
    for (int i = 0; i < 9; ++i) r[i] = (sh & 1) ? t[i + 1] : t[i];
  } else {
#pragma unroll
    for (int i = 0; i < 9; ++i) r[i] = __ldg(g + cell * 3 + i);
  }
}

// A particle's sums over its stencil, a plane at a time: `plane(a, sums)`
// adds plane a's 9 cells (base + (a, *, *)) to sums in (b, c) order. PLANES:
// each plane into accumulators of its own, then P0 + P1, then + P2, three
// independent chains of 9 adds where one running sum over the 27 cells is
// one chain (that measured up to 1.7x slower for K4 and K5, PERF.md).
// Without: the running sum, which K7 backward's 3 sums take as fast.
template <bool PLANES, int N, class Plane>
__device__ __forceinline__ void stencil_sums(float (&total)[N], Plane plane) {
#pragma unroll
  for (int k = 0; k < N; ++k) total[k] = 0.0f;
  plane(0, total);
  if (PLANES) {
    float next[N];
#pragma unroll
    for (int k = 0; k < N; ++k) next[k] = 0.0f;
    plane(1, next);
#pragma unroll
    for (int k = 0; k < N; ++k) total[k] += next[k];
#pragma unroll
    for (int k = 0; k < N; ++k) next[k] = 0.0f;
    plane(2, next);
#pragma unroll
    for (int k = 0; k < N; ++k) total[k] += next[k];
  } else {
    plane(1, total);
    plane(2, total);
  }
}

// Blocks of THREADS, grid (blocks over n, B). SLAB: the outputs leave
// through shared memory, one slab per array.
template <int THREADS, bool RUNS, bool SLAB>
__global__ void __launch_bounds__(THREADS)
g2p_kernel(const float* __restrict__ x, const float* __restrict__ grid_v,
           float* __restrict__ new_v, float* __restrict__ new_C, float* __restrict__ new_x,
           long long n, int G, float inv_dx, float dt, float x_hi) {
  __shared__ __align__(16) float stage[SLAB ? THREADS * 15 : 1];
  const long long GG = G;
  grid_v += blockIdx.y * GG * GG * GG * 3;
  const GatherRow me = gather_row<THREADS>(n);
  const long long p = me.p;
  const Stencil s = make_stencil(x, p, G, inv_dx);
  // sums[0..2]: v = sum W g; sums[3 + 3 i + j]: sum W g_i dpos_j
  float sums[12];
  stencil_sums<true>(sums, [&](int a, float (&o)[12]) {
    const int ci = s.base[0] + a;
#pragma unroll
    for (int b = 0; b < 3; ++b) {
      const int cj = s.base[1] + b;
      float r[9];
      load_run<RUNS>(grid_v, (ci * GG + cj) * GG + s.base[2], r);
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float W = s.w[a][0] * s.w[b][1] * s.w[c][2];
        const float dp[3] = {ci - s.px[0], cj - s.px[1], s.base[2] + c - s.px[2]};
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          const float Wg = W * r[3 * c + i];
          o[i] += Wg;
#pragma unroll
          for (int j = 0; j < 3; ++j) o[3 + 3 * i + j] += Wg * dp[j];
        }
      }
    }
  });
  const float c4 = 4.0f * inv_dx;
  float xo[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    // advection with the domain clamp (pallas_local.py:272-281)
    xo[i] = jmax(jmin(x[p * 3 + i] + dt * sums[i], x_hi), 0.0f);
  }
  if constexpr (SLAB) {
    const int t = threadIdx.x;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      stage[t * 3 + i] = sums[i];
      stage[THREADS * 3 + t * 3 + i] = xo[i];
#pragma unroll
      for (int j = 0; j < 3; ++j) stage[THREADS * 6 + t * 9 + i * 3 + j] = c4 * sums[3 + 3 * i + j];
    }
    __syncthreads();
    plb::store_rows<3>(new_v, me.first, me.rows, stage);
    plb::store_rows<3>(new_x, me.first, me.rows, stage + THREADS * 3);
    plb::store_rows<9>(new_C, me.first, me.rows, stage + THREADS * 6);
  } else if (me.valid) {
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      new_v[p * 3 + i] = sums[i];
      new_x[p * 3 + i] = xo[i];
#pragma unroll
      for (int j = 0; j < 3; ++j) new_C[p * 9 + i * 3 + j] = c4 * sums[3 + 3 * i + j];
    }
  }
}

// Blocks of THREADS, grid (blocks over n, B). The cotangent cell of the
// momentum form is one 16-byte load.
template <int THREADS, bool MASS_ONLY>
__global__ void __launch_bounds__(THREADS)
p2g_bwd_kernel(const float* __restrict__ x, const float* __restrict__ v,
               const float* __restrict__ aff, const float* __restrict__ ct,
               float* __restrict__ gx, float* __restrict__ gv, float* __restrict__ gaff,
               long long n, int G, float inv_dx, float dx, float p_mass) {
  constexpr int C = MASS_ONLY ? 1 : 4;
  constexpr int N = MASS_ONLY ? 3 : 15;
  const long long GG = G;
  ct += blockIdx.y * GG * GG * GG * C;
  const GatherRow me = gather_row<THREADS>(n);
  if (!me.valid) return;
  const long long p = me.p;
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
  // sums[0..2]: d/dpx (grid units); sums[3..5]: dv; sums[6 + 3 i + j]: daffine
  float sums[N];
  stencil_sums<!MASS_ONLY>(sums, [&](int a, float (&o)[N]) {
    const int ci = s.base[0] + a;
#pragma unroll
    for (int b = 0; b < 3; ++b)
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float W = s.w[a][0] * s.w[b][1] * s.w[c][2];
        const float dW[3] = {s.dw[a][0] * s.w[b][1] * s.w[c][2], s.w[a][0] * s.dw[b][1] * s.w[c][2],
                             s.w[a][0] * s.w[b][1] * s.dw[c][2]};
        const int cj = s.base[1] + b, ck = s.base[2] + c;
        const long long cell = (ci * GG + cj) * GG + ck;
        if (MASS_ONLY) {
          const float t = p_mass * __ldg(ct + cell);
#pragma unroll
          for (int d = 0; d < 3; ++d) o[d] += dW[d] * t;
        } else {
          const float dp[3] = {ci - s.px[0], cj - s.px[1], ck - s.px[2]};
          const float4 cell_ct = __ldg(reinterpret_cast<const float4*>(ct) + cell);
          const float cs[3] = {cell_ct.x, cell_ct.y, cell_ct.z};
          float S = p_mass * cell_ct.w;  // sum over channels of contribution x cotangent
#pragma unroll
          for (int i = 0; i < 3; ++i) {
            const float mom = p_mass * vp[i] + dx * (A[i][0] * dp[0] + A[i][1] * dp[1] + A[i][2] * dp[2]);
            S += mom * cs[i];
            o[3 + i] += W * p_mass * cs[i];
#pragma unroll
            for (int j = 0; j < 3; ++j) o[6 + 3 * i + j] += W * dx * dp[j] * cs[i];
          }
#pragma unroll
          for (int d = 0; d < 3; ++d) {
            // through the weights, and through dpos_d (d dpos_d / dpx_d = -1)
            const float through_dpos = cs[0] * A[0][d] + cs[1] * A[1][d] + cs[2] * A[2][d];
            o[d] += dW[d] * S - W * dx * through_dpos;
          }
        }
      }
  });
#pragma unroll
  for (int d = 0; d < 3; ++d) gx[p * 3 + d] = inv_dx * sums[d];
  if (!MASS_ONLY) {
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      gv[p * 3 + i] = sums[3 + i];
#pragma unroll
      for (int j = 0; j < 3; ++j) gaff[p * 9 + i * 3 + j] = sums[6 + 3 * i + j];
    }
  }
}

// g_grid: zeroed. Blocks of kScatterThreads, grid (blocks over n, B). dx is
// a gather per particle and does not depend on the order or on B.
// Two blocks per SM cap it at 128 registers (it takes 255 uncapped and then
// runs one block per SM: 0.1975 against 0.1432 ms at 32 envs on the H100).
__global__ void __launch_bounds__(kScatterThreads, 2)
g2p_bwd_kernel(const float* __restrict__ x, const float* __restrict__ grid_v,
               const float* __restrict__ ct_v, const float* __restrict__ ct_C,
               const float* __restrict__ ct_x, const int* __restrict__ order,
               float* __restrict__ gx, float* __restrict__ g_grid, long long n, int G,
               float inv_dx, float dt, float x_hi) {
  const long long GG = G;
  grid_v += blockIdx.y * GG * GG * GG * 3;
  g_grid += blockIdx.y * GG * GG * GG * 3;
  const Slot me = block_slot(order, n);
  const long long p = me.q;
  const Stencil s = make_stencil(x, p, G, inv_dx);
  const Peers g = make_peers(me, s.base, G);
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
        float ge = 0.0f, gM[3] = {0.0f, 0.0f, 0.0f}, val[3];
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          const float gv = __ldg(grid_v + cell * 3 + i);
          const float e = cv[i] + cM[i][0] * dp[0] + cM[i][1] * dp[1] + cM[i][2] * dp[2];
          val[i] = W * e;
          ge += gv * e;
#pragma unroll
          for (int d = 0; d < 3; ++d) gM[d] += gv * cM[i][d];
        }
#pragma unroll
        for (int i = 0; i < 3; ++i) val[i] = peer_sum(g, val[i]);
#pragma unroll
        for (int i = 0; i < 3; ++i) red_add_if(g.adds, g_grid + cell * 3 + i, val[i]);
#pragma unroll
        for (int d = 0; d < 3; ++d) gpx[d] += dW[d] * ge - W * gM[d];
      }
  if (me.valid) {
#pragma unroll
    for (int d = 0; d < 3; ++d) gx[p * 3 + d] = inv_dx * gpx[d] + adv[d] * ct_x[p * 3 + d];
  }
}

// blocks of kScatterThreads entries of one env's order x envs
inline dim3 scatter_grid(long long n, int B) {
  return dim3(static_cast<unsigned int>((n + kScatterThreads - 1) / kScatterThreads),
              static_cast<unsigned int>(B));
}

// The gathers' launch shapes (measured on the H100, PERF.md): K4 in blocks
// of kGatherThreads, K7 backward of kMassThreads; K5 in blocks of
// kGatherThreads below kSlabFrom particles of all envs, from there on of
// kSlabThreads whose outputs leave as slabs.
constexpr int kGatherThreads = 128, kSlabThreads = 256, kMassThreads = 256;
constexpr long long kSlabFrom = 20000;

template <int THREADS>
inline dim3 gather_grid(long long n, int B) {
  return dim3(static_cast<unsigned int>((n + THREADS - 1) / THREADS), static_cast<unsigned int>(B));
}

template <int THREADS, bool SLAB>
void launch_g2p(const float* x, const float* grid_v, float* new_v, float* new_C, float* new_x,
                long long n, int B, int G, float inv_dx, float dt, float x_hi, cudaStream_t s) {
  // 16-byte runs need the grids 16-byte aligned, each env's 3 G^3 floats a
  // multiple of 4
  if (G % 2 == 0 && (reinterpret_cast<unsigned long long>(grid_v) & 15) == 0) {
    g2p_kernel<THREADS, true, SLAB><<<gather_grid<THREADS>(n, B), THREADS, 0, s>>>(
        x, grid_v, new_v, new_C, new_x, n, G, inv_dx, dt, x_hi);
  } else {
    g2p_kernel<THREADS, false, SLAB><<<gather_grid<THREADS>(n, B), THREADS, 0, s>>>(
        x, grid_v, new_v, new_C, new_x, n, G, inv_dx, dt, x_hi);
  }
}

template <bool MASS_ONLY>
int p2g_bwd_entry(const float* x, const float* v, const float* affine, const float* ct,
                  float* gx, float* gv, float* gaffine, long long n, int B, int G, float inv_dx,
                  float dx, float p_mass, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int threads = MASS_ONLY ? kMassThreads : kGatherThreads;
  if (n > 0 && B > 0) {
    p2g_bwd_kernel<threads, MASS_ONLY><<<gather_grid<threads>(n, B), threads, 0,
                                         static_cast<cudaStream_t>(stream)>>>(
        x, v, affine, ct, gx, gv, gaffine, n, G, inv_dx, dx, p_mass);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Every entry point takes B envs of n particles each (x (B, n, 3), grids and
// their cotangents (B, G^3, C)); one env is B = 1.
// `order` (B, n) int32: per env a permutation of its particles, or nullptr
// for the particles as they lie; any permutation gives the same sums.
extern "C" int plb_p2g(const float* x, const float* v, const float* affine, const int* order,
                       float* grid4, long long n, int B, int G, float inv_dx, float dx,
                       float p_mass, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n > 0 && B > 0) {
    p2g_kernel<false><<<scatter_grid(n, B), kScatterThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(x, v, affine, order, grid4, n, G,
                                                             inv_dx, dx, p_mass);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int plb_grid_mass(const float* x, const int* order, float* grid_m, long long n, int B,
                             int G, float inv_dx, float p_mass, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n > 0 && B > 0) {
    p2g_kernel<true><<<scatter_grid(n, B), kScatterThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(x, nullptr, nullptr, order, grid_m, n,
                                                            G, inv_dx, 0.0f, p_mass);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int plb_g2p(const float* x, const float* grid_v, float* new_v, float* new_C,
                       float* new_x, long long n, int B, int G, float inv_dx, float dt,
                       float x_hi, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n > 0 && B > 0) {
    if (n * B < kSlabFrom) {
      launch_g2p<kGatherThreads, false>(x, grid_v, new_v, new_C, new_x, n, B, G, inv_dx, dt,
                                        x_hi, s);
    } else {
      launch_g2p<kSlabThreads, true>(x, grid_v, new_v, new_C, new_x, n, B, G, inv_dx, dt, x_hi,
                                     s);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int plb_p2g_bwd(const float* x, const float* v, const float* affine, const float* ct,
                           float* gx, float* gv, float* gaffine, long long n, int B, int G,
                           float inv_dx, float dx, float p_mass, int device, void* stream) {
  return p2g_bwd_entry<false>(x, v, affine, ct, gx, gv, gaffine, n, B, G, inv_dx, dx, p_mass,
                              device, stream);
}

extern "C" int plb_grid_mass_bwd(const float* x, const float* ct, float* gx, long long n, int B,
                                 int G, float inv_dx, float p_mass, int device, void* stream) {
  return p2g_bwd_entry<true>(x, nullptr, nullptr, ct, gx, nullptr, nullptr, n, B, G, inv_dx,
                             0.0f, p_mass, device, stream);
}

// g_grid (B, G^3, 3) comes in zeroed; `order` as in plb_p2g
extern "C" int plb_g2p_bwd(const float* x, const float* grid_v, const float* ct_v,
                           const float* ct_C, const float* ct_x, const int* order, float* gx,
                           float* g_grid, long long n, int B, int G, float inv_dx, float dt,
                           float x_hi, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n > 0 && B > 0) {
    g2p_bwd_kernel<<<scatter_grid(n, B), kScatterThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        x, grid_v, ct_v, ct_C, ct_x, order, gx, g_grid, n, G, inv_dx, dt, x_hi);
  }
  return static_cast<int>(cudaGetLastError());
}
