// Grid update kernel, one thread per cell of the full G^3 grid: mass
// normalise, gravity, per-primitive SDF contact at poses f and f+1, walls,
// ground friction, velocity clamp.
//
// Port of the forward of plasticinelab_tpu/engine/pallas_gridop.py
// (_fwd_kernel, K8), which runs plasticinelab_tpu/engine/mpm.py:grid_op_core
// (:193-255) with the primitive math of primitives_cm.py (itself the
// component form of primitives.py:29-246). The order of operations follows
// grid_op_core, including the 1e-30 ground-friction tie-breakers (normal
// floats in f32).
//
// grid4 (G^3, 4) [mom x, y, z, mass]; poses (k, 16) rows [pos_f 3, rot_f 4,
// gap_f, pos_f1 3, rot_f1 4, gap_f1]; out (G^3, 3).
#include "common.cuh"

#define PLB_MAX_PRIMS 8

// Static primitive parameters, passed by value (engine/cuda_build.py
// PrimTable). param: friction, radius, h, r, tx, ty, size x/y/z, minimal_gap.
struct PrimTable {
  int k;
  int shape[PLB_MAX_PRIMS];
  float param[PLB_MAX_PRIMS][10];
};

namespace {

using plb::jmax;
using plb::jmin;

enum Shape { kSphere = 0, kCapsule = 1, kChopsticks = 2, kCylinder = 3, kTorus = 4, kBox = 5 };

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ float len3(float x, float y, float z, float eps = 1e-14f) {
  return sqrtf(x * x + y * y + z * z + eps);
}
__device__ __forceinline__ float len2(float x, float y, float eps = 1e-14f) {
  return sqrtf(x * x + y * y + eps);
}

// rotate v by the quaternion (qw, qx, qy, qz) (primitives_cm._qrot)
__device__ __forceinline__ V3 qrot(const float* q, V3 v) {
  const float qw = q[0], qx = q[1], qy = q[2], qz = q[3];
  const float tx = 2.0f * (qy * v.z - qz * v.y);
  const float ty = 2.0f * (qz * v.x - qx * v.z);
  const float tz = 2.0f * (qx * v.y - qy * v.x);
  return {v.x + qw * tx + (qy * tz - qz * ty), v.y + qw * ty + (qz * tx - qx * tz),
          v.z + qw * tz + (qx * ty - qy * tx)};
}

__device__ __forceinline__ V3 qrot_conj(const float* q, V3 v) {
  const float c[4] = {q[0], -q[1], -q[2], -q[3]};
  return qrot(c, v);
}

struct Prim {
  int shape;
  float friction, radius, h, r, tx, ty, sx, sy, sz;
};

__device__ __forceinline__ float capsule_y(const Prim& P, float py) {
  float y = py + P.h / 2;
  return y - jmin(jmax(y, 0.0f), P.h);
}

__device__ __forceinline__ float capsule_sdf(const Prim& P, V3 p) {
  return len3(p.x, capsule_y(P, p.y), p.z) - P.r;
}

__device__ __forceinline__ V3 capsule_normal(const Prim& P, V3 p) {
  const float y = capsule_y(P, p.y);
  const float l = len3(p.x, y, p.z);
  return {p.x / l, y / l, p.z / l};
}

__device__ __forceinline__ float cylinder_sdf(const Prim& P, V3 p) {
  // the reference swaps roles: h is the radial extent, r the half-height
  const float d0 = fabsf(len2(p.x, p.z)) - P.h;
  const float d1 = fabsf(p.y) - P.r;
  const float d0c = jmax(d0, 0.0f), d1c = jmax(d1, 0.0f);
  return jmin(jmax(d0, d1), 0.0f) + sqrtf(d0c * d0c + d1c * d1c + 1e-14f);
}

__device__ __forceinline__ V3 cylinder_normal(const Prim& P, V3 p) {
  const float l = len2(p.x, p.z);
  const float d0 = l - P.h;
  const float d1 = fabsf(p.y) - P.r;
  const float f = d0 > d1 ? 1.0f : 0.0f;
  const float inside = jmax(d0, d1) <= 0.0f ? 1.0f : 0.0f;
  float n20 = jmax(d0, 0.0f) + inside * f;
  float n21 = jmax(d1, 0.0f) + inside * (1.0f - f);
  const float nl = len2(n20, n21);
  n20 = n20 / nl;
  n21 = n21 / nl;
  const float ysign = p.y >= 0.0f ? 1.0f : -1.0f;
  const float nx = (p.x / l) * n20, ny = n21 * ysign, nz = (p.z / l) * n20;
  const float nl3 = len3(nx, ny, nz);
  return {nx / nl3, ny / nl3, nz / nl3};
}

__device__ __forceinline__ float torus_sdf(const Prim& P, V3 p) {
  const float q0 = len2(p.x, p.z) - P.tx;
  return len2(q0, p.y) - P.ty;
}

__device__ __forceinline__ V3 torus_normal(const Prim& P, V3 p) {
  const float l = len2(p.x, p.z);
  const float q0 = l - P.tx;
  const float ql = len2(q0, p.y);
  const float n20 = q0 / ql, n21 = p.y / ql;
  const float nx = (p.x / l) * n20, ny = n21, nz = (p.z / l) * n20;
  const float nl3 = len3(nx, ny, nz);
  return {nx / nl3, ny / nl3, nz / nl3};
}

__device__ __forceinline__ float box_sdf(const Prim& P, V3 p) {
  const float qx = fabsf(p.x) - P.sx, qy = fabsf(p.y) - P.sy, qz = fabsf(p.z) - P.sz;
  const float out = len3(jmax(qx, 0.0f), jmax(qy, 0.0f), jmax(qz, 0.0f));
  return out + jmin(jmax(qx, jmax(qy, qz)), 0.0f);
}

__device__ __forceinline__ V3 box_normal(const Prim& P, V3 p) {
  // central finite differences with d = 1e-4 (reference primitives.py:240-251)
  const float d = 1e-4f, s = 5000.0f;
  const float nx = (box_sdf(P, {p.x + d, p.y, p.z}) - box_sdf(P, {p.x - d, p.y, p.z})) * s;
  const float ny = (box_sdf(P, {p.x, p.y + d, p.z}) - box_sdf(P, {p.x, p.y - d, p.z})) * s;
  const float nz = (box_sdf(P, {p.x, p.y, p.z + d}) - box_sdf(P, {p.x, p.y, p.z - d})) * s;
  const float nl = len3(nx, ny, nz);
  return {nx / nl, ny / nl, nz / nl};
}

// the two sticks of Chopsticks, each a capsule (primitives_cm._chopsticks_parts)
__device__ __forceinline__ void chopsticks_parts(const Prim& P, V3 p, float gap, V3& a, V3& b) {
  const float half = gap / 2;
  const float py2 = p.y + P.h / 2;
  a = {p.x - half, py2, p.z};
  b = {p.x + half, py2, p.z};
}

// world-frame signed distance (primitives_cm.sdf_cm)
__device__ float prim_sdf(const Prim& P, const float* pos, const float* rot, float gap, V3 gp) {
  const V3 d = {gp.x - pos[0], gp.y - pos[1], gp.z - pos[2]};
  if (P.shape == kSphere) return len3(d.x, d.y, d.z) - P.radius;
  const V3 p = qrot_conj(rot, d);
  switch (P.shape) {
    case kCapsule:
      return capsule_sdf(P, p);
    case kChopsticks: {
      V3 a, b;
      chopsticks_parts(P, p, gap, a, b);
      return jmin(capsule_sdf(P, a), capsule_sdf(P, b));
    }
    case kCylinder:
      return cylinder_sdf(P, p);
    case kTorus:
      return torus_sdf(P, p);
    default:
      return box_sdf(P, p);
  }
}

// world-frame outward normal (primitives_cm.normal_cm)
__device__ V3 prim_normal(const Prim& P, const float* pos, const float* rot, float gap, V3 gp) {
  const V3 d = {gp.x - pos[0], gp.y - pos[1], gp.z - pos[2]};
  if (P.shape == kSphere) {
    const float l = len3(d.x, d.y, d.z);
    return {d.x / l, d.y / l, d.z / l};
  }
  const V3 p = qrot_conj(rot, d);
  V3 n;
  switch (P.shape) {
    case kCapsule:
      n = capsule_normal(P, p);
      break;
    case kChopsticks: {
      V3 a, b;
      chopsticks_parts(P, p, gap, a, b);
      n = capsule_sdf(P, a) <= capsule_sdf(P, b) ? capsule_normal(P, a) : capsule_normal(P, b);
      break;
    }
    case kCylinder:
      n = cylinder_normal(P, p);
      break;
    case kTorus:
      n = torus_normal(P, p);
      break;
    default:
      n = box_normal(P, p);
  }
  return qrot(rot, n);
}

// softness-weighted friction contact (primitives_cm.collide_cm, reference
// primive_base.py:91-115); v is left as it is where the contact condition
// does not hold
__device__ void collide(const Prim& P, const float* pose, float softness, float inv_dt, V3 gp,
                        V3& v) {
  const float* pos_f = pose;
  const float* rot_f = pose + 3;
  const float gap_f = pose[7];
  const float* pos_f1 = pose + 8;
  const float* rot_f1 = pose + 11;
  const float dist = prim_sdf(P, pos_f, rot_f, gap_f, gp);
  const float influence = jmin(expf(-dist * softness), 1.0f);
  const bool cond = (softness > 0.0f && influence > 0.1f) || dist <= 0.0f;
  if (!cond) return;
  const V3 D = prim_normal(P, pos_f, rot_f, gap_f, gp);
  // collider surface velocity (primitives_cm.collider_v_cm)
  const V3 rel = qrot_conj(rot_f, {gp.x - pos_f[0], gp.y - pos_f[1], gp.z - pos_f[2]});
  const V3 np = qrot(rot_f1, rel);
  const V3 cv = {(np.x + pos_f1[0] - gp.x) * inv_dt, (np.y + pos_f1[1] - gp.y) * inv_dt,
                 (np.z + pos_f1[2] - gp.z) * inv_dt};
  const V3 iv = {v.x - cv.x, v.y - cv.y, v.z - cv.z};
  const float nc = iv.x * D.x + iv.y * D.y + iv.z * D.z;
  const float ncm = jmin(nc, 0.0f);
  V3 t = {iv.x - ncm * D.x, iv.y - ncm * D.y, iv.z - ncm * D.z};
  const float tnorm = len3(t.x, t.y, t.z, 1e-8f);
  const float scale = jmax(0.0f, tnorm + nc * P.friction) / tnorm;
  const bool flag = nc < 0.0f && sqrtf(t.x * t.x + t.y * t.y + t.z * t.z) > 1e-30f;
  const float s_eff = flag ? scale : 1.0f;
  t = {t.x * s_eff, t.y * s_eff, t.z * s_eff};
  const float keep = 1.0f - influence;
  v = {cv.x + iv.x * keep + t.x * influence, cv.y + iv.y * keep + t.y * influence,
       cv.z + iv.z * keep + t.z * influence};
}

__global__ void grid_op_kernel(const float* __restrict__ grid4, const float* __restrict__ poses,
                               float* __restrict__ out, PrimTable table, int G, float dx, float dt,
                               float softness, float g30x, float g30y, float g30z,
                               float ground_friction, float vmax) {
  const long long GG = G;
  const long long cell = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (cell >= GG * GG * GG) return;
  const float m = grid4[cell * 4 + 3];
  if (!(m > 1e-12f)) {
    // cells with no mass keep zero velocity
    out[cell * 3 + 0] = 0.0f;
    out[cell * 3 + 1] = 0.0f;
    out[cell * 3 + 2] = 0.0f;
    return;
  }
  const int ci = static_cast<int>(cell / (GG * GG));
  const int cj = static_cast<int>((cell / GG) % GG);
  const int ck = static_cast<int>(cell % GG);
  const float inv_m = 1.0f / m;
  float v[3] = {grid4[cell * 4 + 0] * inv_m + g30x, grid4[cell * 4 + 1] * inv_m + g30y,
                grid4[cell * 4 + 2] * inv_m + g30z};
  const float cf[3] = {static_cast<float>(ci), static_cast<float>(cj), static_cast<float>(ck)};
  const V3 gp = {cf[0] * dx, cf[1] * dx, cf[2] * dx};

  const float inv_dt = 1.0f / dt;
  for (int i = 0; i < table.k; ++i) {
    const float* pr = table.param[i];
    const Prim P = {table.shape[i], pr[0], pr[1], pr[2], pr[3], pr[4], pr[5], pr[6], pr[7], pr[8]};
    V3 vv = {v[0], v[1], v[2]};
    collide(P, poses + i * 16, softness, inv_dt, gp, vv);
    v[0] = vv.x;
    v[1] = vv.y;
    v[2] = vv.z;
  }

  const int bound = 3;
  const int c[3] = {ci, cj, ck};
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const bool low = c[d] < bound && v[d] < 0.0f;
    if (d != 1 || ground_friction == 0.0f) {
      if (low) v[d] = 0.0f;
    } else if (ground_friction < 10.0f) {
      // Coulomb-like ground friction with the 1e-30 tie-breakers
      const float lin = v[1] + 1e-30f;
      float vit[3];
#pragma unroll
      for (int e = 0; e < 3; ++e) vit[e] = v[e] - cf[e] * 1e-30f;
      vit[1] = vit[1] - lin;
      const float lit = sqrtf(vit[0] * vit[0] + vit[1] * vit[1] + vit[2] * vit[2] + 1e-8f);
      const float scale = jmax(1.0f + ground_friction * lin / lit, 0.0f);
      if (low) {
        v[0] = scale * (vit[0] + cf[0] * 1e-30f);
        v[1] = 0.0f;
        v[2] = scale * (vit[2] + cf[2] * 1e-30f);
      }
    } else if (low) {
      v[0] = v[1] = v[2] = 0.0f;
    }
    if (c[d] > G - bound && v[d] > 0.0f) v[d] = 0.0f;
  }

  if (vmax > 0.0f) {
#pragma unroll
    for (int d = 0; d < 3; ++d) v[d] = jmin(jmax(v[d], -vmax), vmax);
  }
  out[cell * 3 + 0] = v[0];
  out[cell * 3 + 1] = v[1];
  out[cell * 3 + 2] = v[2];
}

}  // namespace

extern "C" int plb_grid_op(const float* grid4, const float* poses, float* grid_v, PrimTable table,
                           int G, float dx, float dt, float softness, float g30x, float g30y,
                           float g30z, float ground_friction, float vmax, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (table.k < 0 || table.k > PLB_MAX_PRIMS) return static_cast<int>(cudaErrorInvalidValue);
  const long long cells = static_cast<long long>(G) * G * G;
  if (cells > 0) {
    grid_op_kernel<<<plb::blocks_for(cells), plb::kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(grid4, poses, grid_v, table, G, dx, dt,
                                                          softness, g30x, g30y, g30z,
                                                          ground_friction, vmax);
  }
  return static_cast<int>(cudaGetLastError());
}
