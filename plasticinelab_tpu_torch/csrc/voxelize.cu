// Voxelizer K9: per-voxel min over nearby particles of the packed value
// (quantised distance << 24) | colour, as an atomicMin scatter.
//
// Port of plasticinelab_tpu/engine/renderer/pallas_voxelize.py _kernel (:69).
// The TPU kernel sorts particles into 8x8 xy block-columns and min-reduces
// each chunk over a window of a VMEM-resident volume, because scatter-min is
// slow on the TPU. On Hopper the reference's own formulation is the natural
// kernel (plasticinelab_tpu/engine/renderer/renderer.py _scatter_packed
// :439-491, the reference build_sdf_from_particles): one thread per
// (particle, offset) pair, where the offsets are the cube
// range(-bake_size - 1, bake_size + 1)^3 culled to those within the
// saturation radius 1 / dist_scale of the unit cube (720 of 2744 for a frame,
// 160 of 512 for an observation: the renderer's dist_scale, 0.2 * dx * 150,
// is 0.20000000000000004 in double, so the shell at radius 5 falls outside);
// each thread computes its packed value and
// atomicMin's it into the volume. Min is order-independent, so the result
// is deterministic and equals the plain version's bit for bit.
//
// Bound: the volume is written once (4 B per cell, 19 MB at 168^3) and the
// particles read once (16 B each); the atomics resolve in the 50 MB L2,
// which holds the whole volume. The arithmetic per update is ~20 flops.
//
// The distance keeps the reference package's operation order, which XLA
// compiles on the CPU to a chain of fused multiply-adds:
// sqrt(fma(dz, dz, fma(dy, dy, dx * dx))), then times the float32 constant
// 255 * dist_scale; every step is written with its rounding intrinsic so that
// nvcc contracts nothing else.
//
// p (n, 3) float32 particle positions in voxel units; color (n,) int32 in
// [0, 2^24); offs (m, 3) int32; vol (rx * ry * rz,) filled with 0xFFFFFFFF
// by the caller.
#include "common.cuh"

namespace {

__global__ void voxelize_kernel(const float* __restrict__ p, const int* __restrict__ color,
                                const int* __restrict__ offs, unsigned int* __restrict__ vol,
                                long long n, int m, int rx, int ry, int rz, float scale) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= n * m) return;
  const long long i = t / m;
  const int o = static_cast<int>(t - i * m);
  const float px = p[i * 3 + 0], py = p[i * 3 + 1], pz = p[i * 3 + 2];
  // truncation toward zero, as the plain version's cast to int32
  const int ix = static_cast<int>(px) + offs[o * 3 + 0];
  const int iy = static_cast<int>(py) + offs[o * 3 + 1];
  const int iz = static_cast<int>(pz) + offs[o * 3 + 2];
  if (ix < 0 || ix >= rx || iy < 0 || iy >= ry || iz < 0 || iz >= rz) return;
  const float dx = __fsub_rn(static_cast<float>(ix), px);
  const float dy = __fsub_rn(static_cast<float>(iy), py);
  const float dz = __fsub_rn(static_cast<float>(iz), pz);
  const float d2 = __fmaf_rn(dz, dz, __fmaf_rn(dy, dy, __fmul_rn(dx, dx)));
  const float q = fminf(fmaxf(__fmul_rn(__fsqrt_rn(d2), scale), 0.0f), 255.0f);
  const unsigned int packed =
      (static_cast<unsigned int>(q) << 24) + static_cast<unsigned int>(color[i]);
  const long long flat = (static_cast<long long>(ix) * ry + iy) * rz + iz;
  atomicMin(vol + flat, packed);
}

}  // namespace

// vol: (rx * ry * rz,) int32 holding -1 (0xFFFFFFFF) on entry; scale is
// 255 * dist_scale.
extern "C" int plb_voxelize(const float* p, const int* color, const int* offs, int* vol,
                            long long n, int m, int rx, int ry, int rz, float scale, int device,
                            void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long work = n * static_cast<long long>(m);
  if (work > 0) {
    voxelize_kernel<<<plb::blocks_for(work), plb::kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
        p, color, offs, reinterpret_cast<unsigned int*>(vol), n, m, rx, ry, rz, scale);
  }
  return static_cast<int>(cudaGetLastError());
}
