// Voxelizer K9 for B envs: per voxel, the min over nearby particles of the
// packed value (quantised distance << 24) + colour.
//
// Port of plasticinelab_tpu/engine/renderer/pallas_voxelize.py _kernel (:69),
// which the TPU package also runs vmapped over the envs of a batched rgb
// rollout (plasticinelab_tpu/parallel/rollout.py:148). The function is the
// reference's scatter (renderer.py _scatter_packed :439-491): voxel v of env
// b takes the unsigned min of (q << 24) + colour[i] over every particle i of
// env b and every offset o of the culled table (`cuda_voxelize.offsets`)
// with trunc(p_i) + o == v inside the volume; 0xFFFFFFFF where none reaches.
// Min is exact in any order, so the kernel equals its plain version bit for
// bit, and per env a B = 1 launch.
//
// What bounds it: same-address atomics in L2. A written cell takes ~190-280
// updates (Move-v1's cloud at the frame and the observation grid), and one
// global atomicMin per update serialises on the cell's L2 slice. Where the
// launch has the particles to fill the card (B n >= 2 chunks of 256 an SM:
// the batched observation from B = 7), the min is privatised in shared
// memory, over the box of cells that a chunk of nearby particles reaches,
// and each written cell of the box leaves as one global atomicMin. One
// launch runs, in order on B envs at once:
// - `voxel_bin_kernel` (privatised launches), a block an env: a counting
//   sort of the env's particles by coarse cell (cell >> s, Morton order, so
//   that particles next in the order lie near each other): shared
//   histogram, block scan, scatter of x y z and colour bits, a float4 each;
// - `voxel_fill_kernel`: 0xFFFFFFFF into every cell, 16-byte stores;
// - `voxel_chunk_kernel`: a block takes a chunk of particles (one a thread,
//   loaded at once); a warp takes its particles one after another, its
//   lanes on consecutive offsets (distinct cells and banks; the offset
//   table in shared memory; no division in the loop). Privatised: the
//   chunk's 256 sorted particles, the box of their stencils in shared
//   memory, shared atomicMin, then the box's written cells into the volume
//   (a box too large for shared memory, a chunk across distant coarse
//   cells, goes to the volume directly). Else: 8 particles as they lie, one
//   a warp, straight into the volume, a block for every 8 so that one env's
//   10,000 particles fill the card.
// Both orders give the same min. A variant that owned output tiles in shared
// memory measured slower at every B: 99% of Move-v1's updates fall in a few
// dozen tiles, which a block each cannot spread over the card (PERF.md).
//
// The distance keeps the reference package's operation order, which XLA
// compiles on the CPU to a chain of fused multiply-adds:
// sqrt(fma(dz, dz, fma(dy, dy, dx * dx))), then times the float32 constant
// 255 * dist_scale; every step is written with its rounding intrinsic so that
// nvcc contracts nothing else.
//
// p (B, n, 3) float32 positions in voxel units; color (n,) int32 in
// [0, 2^24), shared by the envs; offs (m, 3) int32; vol (B, rx * ry * rz)
// uint32 bits.
#include <algorithm>

#include "common.cuh"

namespace {

constexpr int kBinThreads = 1024;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBits = 4;                    // coarse cells per axis: 2^kBits at most
constexpr int kBins = 1 << (3 * kBits);     // Morton keys
constexpr int kBoxCells = 16384;            // a chunk's box in shared memory, 64 KB
constexpr int kBinUnroll = 4;               // particles a thread loads before it bins them
constexpr unsigned int kFull = 0xffffffffu;

struct VoxGeo {
  int rx, ry, rz;  // the volume
  int lo, hi;      // the offsets' range on each axis
  int shift;       // coarse cell: cell >> shift, fewer than 2^kBits an axis
};

// The sort key of a particle: the Morton code of its coarse cell, or -1 when
// its stencil misses the volume (or it is not finite: the plain version's int
// cast then leaves the volume too).
__device__ __forceinline__ int bin_key(float px, float py, float pz, const VoxGeo& g) {
  if (!(fabsf(px) < 1.0e9f && fabsf(py) < 1.0e9f && fabsf(pz) < 1.0e9f)) return -1;
  const int c[3] = {static_cast<int>(px), static_cast<int>(py), static_cast<int>(pz)};
  const int r[3] = {g.rx, g.ry, g.rz};
  int key = 0;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    if (c[a] + g.hi < 0 || c[a] + g.lo >= r[a]) return -1;
    const int coarse = min(max(c[a], 0), r[a] - 1) >> g.shift;
#pragma unroll
    for (int bit = 0; bit < kBits; ++bit) key |= ((coarse >> bit) & 1) << (3 * bit + 2 - a);
  }
  return key;
}

// In place exclusive scan of a[0, nb) in shared memory by the whole block,
// blockDim entries a pass, a thread on consecutive entries (no bank
// conflicts); returns the total. Ends with a barrier.
__device__ int block_exclusive_scan(int* a, int nb) {
  __shared__ int warp_sum[32];
  __shared__ int carry;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) carry = 0;
  __syncthreads();
  for (int k0 = 0; k0 < nb; k0 += blockDim.x) {
    const int k = k0 + threadIdx.x;
    const int own = k < nb ? a[k] : 0;
    int incl = own;
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl += v;
    }
    if (lane == 31) warp_sum[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      const int w = lane < static_cast<int>(blockDim.x >> 5) ? warp_sum[lane] : 0;
      int wi = w;
      for (int d = 1; d < 32; d <<= 1) {
        const int v = __shfl_up_sync(kFull, wi, d);
        if (lane >= d) wi += v;
      }
      warp_sum[lane] = wi - w;
    }
    __syncthreads();
    if (k < nb) a[k] = carry + warp_sum[warp] + incl - own;
    __syncthreads();
    if (threadIdx.x == blockDim.x - 1) carry += warp_sum[warp] + incl;
    __syncthreads();
  }
  return carry;
}

// Adds one to the count of each lane's bin (key >= 0) and returns the count
// before it; a warp whose lanes share one bin adds 32 as one (a cloud packed
// in one voxel would otherwise serialise 32 lanes on one address).
__device__ __forceinline__ int bin_add(int* hist, int key) {
  const int key0 = __shfl_sync(kFull, key, 0);
  if (__all_sync(kFull, key == key0)) {
    int base = 0;
    if ((threadIdx.x & 31) == 0 && key0 >= 0) base = atomicAdd(&hist[key0], 32);
    return __shfl_sync(kFull, base, 0) + (threadIdx.x & 31);
  }
  return key >= 0 ? atomicAdd(&hist[key], 1) : 0;
}

// One block an env: counting sort of the env's particles whose stencil meets
// the volume into sorted (B, n) float4 (x, y, z, colour bits), their count
// at count[b]. Each thread loads kBinUnroll particles before it bins them,
// so that their loads overlap.
__global__ void __launch_bounds__(kBinThreads)
    voxel_bin_kernel(const float* __restrict__ p, const int* __restrict__ color,
                     float4* __restrict__ sorted, int* __restrict__ count, int n, VoxGeo g) {
  extern __shared__ int hist[];
  const int b = blockIdx.x;
  const float* pb = p + static_cast<long long>(b) * n * 3;
  for (int k = threadIdx.x; k < kBins; k += blockDim.x) hist[k] = 0;
  __syncthreads();
  const int step = kBinUnroll * blockDim.x;
  for (int first = 0; first < n; first += step) {
    float q[kBinUnroll][3];
#pragma unroll
    for (int u = 0; u < kBinUnroll; ++u) {
      const int i = first + u * blockDim.x + threadIdx.x;
      for (int a = 0; a < 3; ++a) q[u][a] = i < n ? pb[i * 3 + a] : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kBinUnroll; ++u) {
      const int i = first + u * blockDim.x + threadIdx.x;
      bin_add(hist, i < n ? bin_key(q[u][0], q[u][1], q[u][2], g) : -1);
    }
  }
  __syncthreads();
  const int binned = block_exclusive_scan(hist, kBins);
  if (threadIdx.x == 0) count[b] = binned;
  float4* sb = sorted + static_cast<long long>(b) * n;
  for (int first = 0; first < n; first += step) {
    float q[kBinUnroll][3];
    int col[kBinUnroll];
#pragma unroll
    for (int u = 0; u < kBinUnroll; ++u) {
      const int i = first + u * blockDim.x + threadIdx.x;
      for (int a = 0; a < 3; ++a) q[u][a] = i < n ? pb[i * 3 + a] : 0.0f;
      col[u] = i < n ? color[i] : 0;
    }
#pragma unroll
    for (int u = 0; u < kBinUnroll; ++u) {
      const int i = first + u * blockDim.x + threadIdx.x;
      const int key = i < n ? bin_key(q[u][0], q[u][1], q[u][2], g) : -1;
      const int at = bin_add(hist, key);
      if (key >= 0) sb[at] = make_float4(q[u][0], q[u][1], q[u][2], __int_as_float(col[u]));
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    voxel_fill_kernel(unsigned int* __restrict__ vol, long long cells) {
  const long long quads = cells >> 2;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long first = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  for (long long k = first; k < quads; k += stride)
    reinterpret_cast<uint4*>(vol)[k] = make_uint4(kFull, kFull, kFull, kFull);
  for (long long k = (quads << 2) + first; k < cells; k += stride) vol[k] = kFull;
}

// The min and max of v over the block (all threads get them); red: 64 ints of
// shared memory. Ends with a barrier.
__device__ __forceinline__ void block_min_max(int& lo, int& hi, int* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int d = 16; d; d >>= 1) {
    lo = min(lo, __shfl_xor_sync(kFull, lo, d));
    hi = max(hi, __shfl_xor_sync(kFull, hi, d));
  }
  if (lane == 0) {
    red[warp] = lo;
    red[32 + warp] = hi;
  }
  __syncthreads();
  lo = red[0];
  hi = red[32];
  for (int w = 1; w < kWarps; ++w) {
    lo = min(lo, red[w]);
    hi = max(hi, red[32 + w]);
  }
  __syncthreads();
}

// Chunks of `chunk` particles (a multiple of 8, at most kThreads), the i-th
// chunk of every env before the (i + 1)-th; thread t holds particle
// (t % 32) kWarps + t / 32 of the chunk, so that a chunk of 8 gives each
// warp one. sorted: the sort's order, whose chunks privatise their box (the
// top of the file); null: the particles as they lie, every update straight
// into the volume (a launch too small to fill the card with sorted chunks).
__global__ void __launch_bounds__(kThreads)
    voxel_chunk_kernel(const float4* __restrict__ sorted, const int* __restrict__ count,
                       const float* __restrict__ p, const int* __restrict__ color,
                       const int* __restrict__ offs, unsigned int* __restrict__ vol, int n, int B,
                       int m, int chunk, VoxGeo g, float scale) {
  extern __shared__ __align__(16) unsigned int smem[];
  int* ox = reinterpret_cast<int*>(smem);  // ox[m], oy[m], oz[m], then the box
  int* oy = ox + m;
  int* oz = oy + m;
  unsigned int* box = smem + 3 * m;
  __shared__ int red[64];
  for (int k = threadIdx.x; k < 3 * m; k += blockDim.x) ox[(k % 3) * m + k / 3] = offs[k];
  const int lane = threadIdx.x & 31;
  const long long cells = static_cast<long long>(g.rx) * g.ry * g.rz;
  const bool privatise = sorted != nullptr;
  int most = privatise ? 0 : n;  // particles of the fullest env
  for (int b = 0; privatise && b < B; ++b) most = max(most, count[b]);
  const int chunks = (most + chunk - 1) / chunk;
  const int mine = (lane * kWarps) + (threadIdx.x >> 5);  // this thread's particle of a chunk
  __syncthreads();
  for (int job = blockIdx.x; job < chunks * B; job += gridDim.x) {
    const int ci = job / B, b = job - ci * B;
    const int first = ci * chunk, last = min(first + chunk, privatise ? count[b] : n);
    if (first >= last) continue;
    const bool has = mine < last - first;
    float4 q = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (has && privatise) {
      q = sorted[static_cast<long long>(b) * n + first + mine];
    } else if (has) {
      const float* pi = p + (static_cast<long long>(b) * n + first + mine) * 3;
      q = make_float4(pi[0], pi[1], pi[2], __int_as_float(color[first + mine]));
    }
    // a cell beyond int range (or NaN) lies outside the volume, as in the
    // plain version's int cast (the sort leaves such particles out)
    const bool live = has && fabsf(q.x) < 1.0e9f && fabsf(q.y) < 1.0e9f && fabsf(q.z) < 1.0e9f;
    // truncation toward zero, as the plain version's cast to int32
    const int cx = live ? static_cast<int>(q.x) : 0, cy = live ? static_cast<int>(q.y) : 0;
    const int cz = live ? static_cast<int>(q.z) : 0;
    int x0 = 0, y0 = 0, z0 = 0, dx = 0, dy = 0, dz = 0;
    bool in_box = false;
    if (privatise) {  // the box of the chunk's stencils
      int x1 = live ? cx : -0x3fffffff, y1 = live ? cy : -0x3fffffff;
      int z1 = live ? cz : -0x3fffffff;
      x0 = live ? cx : 0x3fffffff;
      y0 = live ? cy : 0x3fffffff;
      z0 = live ? cz : 0x3fffffff;
      block_min_max(x0, x1, red);
      block_min_max(y0, y1, red);
      block_min_max(z0, z1, red);
      x0 = max(x0 + g.lo, 0);
      y0 = max(y0 + g.lo, 0);
      z0 = max(z0 + g.lo, 0);
      dx = min(x1 + g.hi, g.rx - 1) - x0 + 1;
      dy = min(y1 + g.hi, g.ry - 1) - y0 + 1;
      dz = min(z1 + g.hi, g.rz - 1) - z0 + 1;
      in_box = static_cast<long long>(dx) * dy * dz <= kBoxCells;
    }
    const int nbox = in_box ? dx * dy * dz : 0;
    for (int k = threadIdx.x; k < nbox; k += blockDim.x) box[k] = kFull;
    __syncthreads();
    unsigned int* vb = vol + b * cells;
    // a warp its lanes' particles, one after another, lanes on the offsets
    for (unsigned int todo = __ballot_sync(kFull, live); todo; todo &= todo - 1) {
      const int src = __ffs(todo) - 1;
      const float px = __shfl_sync(kFull, q.x, src), py = __shfl_sync(kFull, q.y, src);
      const float pz = __shfl_sync(kFull, q.z, src);
      const unsigned int col = __float_as_uint(__shfl_sync(kFull, q.w, src));
      const int bx = __shfl_sync(kFull, cx, src), by = __shfl_sync(kFull, cy, src);
      const int bz = __shfl_sync(kFull, cz, src);
      for (int k = lane; k < m; k += 32) {
        const int ix = bx + ox[k], iy = by + oy[k], iz = bz + oz[k];
        if (ix < 0 || ix >= g.rx || iy < 0 || iy >= g.ry || iz < 0 || iz >= g.rz) continue;
        const float ddx = __fsub_rn(static_cast<float>(ix), px);
        const float ddy = __fsub_rn(static_cast<float>(iy), py);
        const float ddz = __fsub_rn(static_cast<float>(iz), pz);
        const float d2 = __fmaf_rn(ddz, ddz, __fmaf_rn(ddy, ddy, __fmul_rn(ddx, ddx)));
        const float qd = fminf(fmaxf(__fmul_rn(__fsqrt_rn(d2), scale), 0.0f), 255.0f);
        const unsigned int packed = (static_cast<unsigned int>(qd) << 24) + col;
        if (in_box)
          atomicMin(box + ((ix - x0) * dy + iy - y0) * dz + iz - z0, packed);
        else
          atomicMin(vb + (static_cast<long long>(ix) * g.ry + iy) * g.rz + iz, packed);
      }
    }
    __syncthreads();
    // the box's written cells into the volume
    for (int k = threadIdx.x; k < nbox; k += blockDim.x) {
      const unsigned int v = box[k];
      if (v == kFull) continue;
      const int row = k / dz, lz = k - row * dz;
      const int lx = row / dy, ly = row - lx * dy;
      atomicMin(vb + (static_cast<long long>(x0 + lx) * g.ry + y0 + ly) * g.rz + z0 + lz, v);
    }
    __syncthreads();
  }
}

// Per device, what a launch asks of the runtime only once: the SM count, the
// shared memory the two kernels may take, and the chunk kernel's blocks an
// SM at that size (host calls that cost a launch as much again).
struct DeviceSetup {
  int sms = 0, bin_smem = 0, chunk_smem = 0, per_sm = 0;
};

int device_setup(int device, int chunk_smem, DeviceSetup& d) {
  cudaError_t err = cudaSuccess;
  if (d.sms == 0) err = cudaDeviceGetAttribute(&d.sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess && d.bin_smem == 0) {
    d.bin_smem = kBins * static_cast<int>(sizeof(int));
    err = cudaFuncSetAttribute(voxel_bin_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               d.bin_smem);
  }
  if (err == cudaSuccess && d.chunk_smem != chunk_smem) {
    err = cudaFuncSetAttribute(voxel_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               chunk_smem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&d.per_sm, voxel_chunk_kernel,
                                                          kThreads, chunk_smem);
    d.chunk_smem = err == cudaSuccess ? chunk_smem : 0;
  }
  return static_cast<int>(err);
}

}  // namespace

// p (B, n, 3), color (n,), offs (m, 3) int32 spanning [lo, hi] on each axis;
// vol (B, rx * ry * rz) int32, written whole; chunk: particles a block takes
// (a multiple of 8, at most 256); sort: whether to sort (then shift: the
// coarse cells are cell >> shift, fewer than 2^kBits an axis; scratch sorted
// (B, n, 4) float32 and count (B,) int32); scale is 255 * dist_scale.
// Launches the sort (if asked), the fill and the scatter on the stream.
extern "C" int plb_voxelize(const float* p, const int* color, const int* offs, float* sorted,
                            int* count, int* vol, int n, int B, int m, int rx, int ry, int rz,
                            int lo, int hi, int sort, int shift, int chunk, float scale,
                            int device, void* stream) {
  static DeviceSetup setups[64];
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device < 0 || device >= 64 || chunk < 8 || chunk > kThreads || chunk % 8 ||
      (sort && std::max(std::max(rx, ry), rz) - 1 >> shift >= 1 << kBits))
    return static_cast<int>(cudaErrorInvalidValue);
  const int chunk_smem = (3 * m + (sort ? kBoxCells : 0)) * static_cast<int>(sizeof(int));
  DeviceSetup& d = setups[device];
  const int setup_err = device_setup(device, chunk_smem, d);
  if (setup_err != 0) return setup_err;
  const VoxGeo g{rx, ry, rz, lo, hi, shift};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* out = reinterpret_cast<unsigned int*>(vol);
  auto* ordered = sort ? reinterpret_cast<float4*>(sorted) : nullptr;
  if (sort) {
    voxel_bin_kernel<<<B, kBinThreads, d.bin_smem, s>>>(p, color, ordered, count, n, g);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long cells = static_cast<long long>(B) * rx * ry * rz;
  const long long fill_blocks = (cells / 4 + kThreads - 1) / kThreads;
  const int fill_grid = static_cast<int>(std::max(1LL, std::min(fill_blocks, 8LL * d.sms)));
  voxel_fill_kernel<<<fill_grid, kThreads, 0, s>>>(out, cells);
  err = cudaGetLastError();
  if (err != cudaSuccess || n == 0 || m == 0) return static_cast<int>(err);
  const int jobs = B * ((n + chunk - 1) / chunk);
  const int grid = std::max(1, std::min(jobs, std::max(d.per_sm, 1) * d.sms));
  voxel_chunk_kernel<<<grid, kThreads, chunk_smem, s>>>(ordered, count, p, color, offs, out, n, B,
                                                        m, chunk, g, scale);
  return static_cast<int>(cudaGetLastError());
}
