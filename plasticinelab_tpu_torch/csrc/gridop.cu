// Grid update kernels over the full G^3 grid of each env: mass normalise,
// gravity, per-primitive SDF contact at poses f and f+1, walls, ground
// friction, velocity clamp.
//
// grid_op_kernel: port of the forward of plasticinelab_tpu/engine/
//   pallas_gridop.py (_fwd_kernel, K8), which runs plasticinelab_tpu/engine/
//   mpm.py:grid_op_core (:193-255) with the primitive math of primitives.py
//   (:29-246; primitives_cm.py is its component form). The order of
//   operations follows grid_op_core, including the 1e-30 ground-friction
//   tie-breakers (normal floats in f32). The inverse rotation uses the
//   renormalised conjugate quaternion, as primitives.inv_trans does.
// grid_op_bwd_kernel: port of pallas_gridop.py _bwd_kernel (K8 backward,
//   :97), which runs the reference's autodiff (vjp) of grid_op_core inside
//   the kernel. Hopper has no in-kernel autodiff, so the adjoint is written
//   by hand: each cell recomputes its forward and runs it backwards. The
//   Jacobians of the 7 shapes' local SDF and normal with respect to the
//   local point (and the Chopsticks gap) come from the same templated shape
//   code instantiated on a forward-mode dual number with 4 tangents; the
//   quaternion and position chain rule is written out. The pose cotangents
//   are summed in the same launch, in an order fixed by the grid alone.
//
// grid4 (G^3, 4) [mom x, y, z, mass]; poses (k, 16) rows [pos_f 3, rot_f 4,
// gap_f, pos_f1 3, rot_f1 4, gap_f1]; out (G^3, 3). Both directions take B
// envs, grid4 (B, G^3, 4), each env with its own poses row block (B, k, 16)
// and its own softness from a (B,) device tensor; one env is B = 1. Both
// launch a 2-D grid (blocks of one env's cells, env). They also replace the
// batched grids of the same TPU kernels (pallas_gridop.py:205
// grid_op_fns_batched, K8-fwd-b :234 and K8-bwd-b :247).
//
// What bounds them on the H100: bytes. The forward reads 16 B and writes
// 12 B per cell, the backward reads 16 B (and 12 B of cotangent where the
// cell has mass) and writes 16 B; the outputs stay dense. The arithmetic
// (SDF, normal, contact response and its adjoint with dual-number
// Jacobians) runs only in the cells with mass, ~1% of Move-v1's grid, and
// within them only where a primitive touches. So a warp without mass loads
// its 32 rows as 16-byte loads, votes, and writes zeros as 16-byte stores;
// the heavy path and its registers are paid where it runs.
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

// Per-cell pose cotangent of one primitive: pos_f 3, the renormalised
// conjugate of rot_f 4 (mapped to rot_f after the reduction), rot_f 4,
// gap_f 1, pos_f1 3, rot_f1 4.
constexpr int kPG = 19;
enum PG { kPosF = 0, kConjF = 3, kRotF = 7, kGapF = 11, kPosF1 = 12, kRotF1 = 15 };

// ---------------------------------------------------------------------------
// forward-mode dual number: value and 4 tangents (local point x, y, z, gap)
// ---------------------------------------------------------------------------
struct Dual {
  float v, d[4];
  __device__ Dual() {}
  __device__ Dual(float c) : v(c), d{0.0f, 0.0f, 0.0f, 0.0f} {}
};
__device__ __forceinline__ Dual seed(float c, int i) {
  Dual r(c);
  r.d[i] = 1.0f;
  return r;
}
__device__ __forceinline__ Dual operator+(const Dual& a, const Dual& b) {
  Dual r;
  r.v = a.v + b.v;
#pragma unroll
  for (int i = 0; i < 4; ++i) r.d[i] = a.d[i] + b.d[i];
  return r;
}
__device__ __forceinline__ Dual operator-(const Dual& a, const Dual& b) {
  Dual r;
  r.v = a.v - b.v;
#pragma unroll
  for (int i = 0; i < 4; ++i) r.d[i] = a.d[i] - b.d[i];
  return r;
}
__device__ __forceinline__ Dual operator*(const Dual& a, const Dual& b) {
  Dual r;
  r.v = a.v * b.v;
#pragma unroll
  for (int i = 0; i < 4; ++i) r.d[i] = a.d[i] * b.v + a.v * b.d[i];
  return r;
}
__device__ __forceinline__ Dual operator/(const Dual& a, const Dual& b) {
  // the value an IEEE division, the tangents through one reciprocal: each
  // IEEE division is a checked branch that serialises the chain (PERF.md)
  Dual r;
  r.v = a.v / b.v;
  const float inv = 1.0f / b.v;
#pragma unroll
  for (int i = 0; i < 4; ++i) r.d[i] = (a.d[i] - r.v * b.d[i]) * inv;
  return r;
}
__device__ __forceinline__ float val(float a) { return a; }
__device__ __forceinline__ float val(const Dual& a) { return a.v; }
__device__ __forceinline__ float dsqrt(float a) { return sqrtf(a); }
__device__ __forceinline__ Dual dsqrt(const Dual& a) {
  Dual r;
  r.v = sqrtf(a.v);
  const float k = 0.5f / r.v;
#pragma unroll
  for (int i = 0; i < 4; ++i) r.d[i] = a.d[i] * k;
  return r;
}
__device__ __forceinline__ float dabs(float a) { return fabsf(a); }
__device__ __forceinline__ Dual dabs(const Dual& a) {
  // d|a| = sign(a) da, 0 at a = 0 (as torch.abs)
  const float s = a.v > 0.0f ? 1.0f : (a.v < 0.0f ? -1.0f : 0.0f);
  Dual r;
  r.v = fabsf(a.v);
#pragma unroll
  for (int i = 0; i < 4; ++i) r.d[i] = s * a.d[i];
  return r;
}
// max/min selecting by value; NaN propagates like plb::jmax/jmin
template <class T>
__device__ __forceinline__ T tmax(const T& a, const T& b) {
  return (val(a) > val(b) || val(a) != val(a)) ? a : b;
}
template <class T>
__device__ __forceinline__ T tmin(const T& a, const T& b) {
  return (val(a) < val(b) || val(a) != val(a)) ? a : b;
}

template <class T>
struct Vec3 {
  T x, y, z;
};
using V3 = Vec3<float>;

template <class T>
__device__ __forceinline__ T len3(const T& x, const T& y, const T& z, float eps = 1e-14f) {
  return dsqrt(x * x + y * y + z * z + T(eps));
}
template <class T>
__device__ __forceinline__ T len2(const T& x, const T& y, float eps = 1e-14f) {
  return dsqrt(x * x + y * y + T(eps));
}

// ---------------------------------------------------------------------------
// quaternions (w, x, y, z): rotation and its adjoint
// ---------------------------------------------------------------------------
// v + w t + qv x t, t = 2 qv x v (primitives_cm._qrot, quat.qrot)
__device__ __forceinline__ V3 qrot(const float* q, V3 v) {
  const float qw = q[0], qx = q[1], qy = q[2], qz = q[3];
  const float tx = 2.0f * (qy * v.z - qz * v.y);
  const float ty = 2.0f * (qz * v.x - qx * v.z);
  const float tz = 2.0f * (qx * v.y - qy * v.x);
  return {v.x + qw * tx + (qy * tz - qz * ty), v.y + qw * ty + (qz * tx - qx * tz),
          v.z + qw * tz + (qx * ty - qy * tx)};
}

// cotangents of qrot(q, v) given the output's g: gq += dq, returns dv
__device__ __forceinline__ V3 qrot_bwd(const float* q, V3 v, V3 g, float* gq) {
  const float qw = q[0], qx = q[1], qy = q[2], qz = q[3];
  const float tx = 2.0f * (qy * v.z - qz * v.y);
  const float ty = 2.0f * (qz * v.x - qx * v.z);
  const float tz = 2.0f * (qx * v.y - qy * v.x);
  // gt = w g + g x qv
  const float gtx = qw * g.x + (g.y * qz - g.z * qy);
  const float gty = qw * g.y + (g.z * qx - g.x * qz);
  const float gtz = qw * g.z + (g.x * qy - g.y * qx);
  gq[0] += g.x * tx + g.y * ty + g.z * tz;
  // gqv = t x g + 2 v x gt
  gq[1] += (ty * g.z - tz * g.y) + 2.0f * (v.y * gtz - v.z * gty);
  gq[2] += (tz * g.x - tx * g.z) + 2.0f * (v.z * gtx - v.x * gtz);
  gq[3] += (tx * g.y - ty * g.x) + 2.0f * (v.x * gty - v.y * gtx);
  // gv = g + 2 gt x qv
  return {g.x + 2.0f * (gty * qz - gtz * qy), g.y + 2.0f * (gtz * qx - gtx * qz),
          g.z + 2.0f * (gtx * qy - gty * qx)};
}

// conj(q) / |q| (quat.quat_conj)
__device__ __forceinline__ void conj_normalized(const float* q, float* c) {
  const float s = sqrtf(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3]);
  c[0] = q[0] / s;
  c[1] = -q[1] / s;
  c[2] = -q[2] / s;
  c[3] = -q[3] / s;
}

// ---------------------------------------------------------------------------
// local-frame SDF and normal per shape, on float or Dual
// ---------------------------------------------------------------------------
struct Prim {
  int shape;
  float friction, radius, h, r, tx, ty, sx, sy, sz;
};

template <class T>
__device__ __forceinline__ T capsule_y(const Prim& P, const T& py) {
  const T y = py + T(P.h / 2);
  return y - tmin(tmax(y, T(0.0f)), T(P.h));
}

template <class T>
__device__ __forceinline__ T capsule_sdf(const Prim& P, const Vec3<T>& p) {
  return len3(p.x, capsule_y(P, p.y), p.z) - T(P.r);
}

template <class T>
__device__ __forceinline__ Vec3<T> capsule_normal(const Prim& P, const Vec3<T>& p) {
  const T y = capsule_y(P, p.y);
  const T l = len3(p.x, y, p.z);
  return {p.x / l, y / l, p.z / l};
}

template <class T>
__device__ __forceinline__ T cylinder_sdf(const Prim& P, const Vec3<T>& p) {
  // the reference swaps roles: h is the radial extent, r the half-height
  const T d0 = dabs(len2(p.x, p.z)) - T(P.h);
  const T d1 = dabs(p.y) - T(P.r);
  const T d0c = tmax(d0, T(0.0f)), d1c = tmax(d1, T(0.0f));
  return tmin(tmax(d0, d1), T(0.0f)) + dsqrt(d0c * d0c + d1c * d1c + T(1e-14f));
}

template <class T>
__device__ __forceinline__ Vec3<T> cylinder_normal(const Prim& P, const Vec3<T>& p) {
  const T l = len2(p.x, p.z);
  const T d0 = l - T(P.h);
  const T d1 = dabs(p.y) - T(P.r);
  const float f = val(d0) > val(d1) ? 1.0f : 0.0f;
  const float inside = val(tmax(d0, d1)) <= 0.0f ? 1.0f : 0.0f;
  T n20 = tmax(d0, T(0.0f)) + T(inside * f);
  T n21 = tmax(d1, T(0.0f)) + T(inside * (1.0f - f));
  const T nl = len2(n20, n21);
  n20 = n20 / nl;
  n21 = n21 / nl;
  const float ysign = val(p.y) >= 0.0f ? 1.0f : -1.0f;
  const T nx = (p.x / l) * n20, ny = n21 * T(ysign), nz = (p.z / l) * n20;
  const T nl3 = len3(nx, ny, nz);
  return {nx / nl3, ny / nl3, nz / nl3};
}

template <class T>
__device__ __forceinline__ T torus_sdf(const Prim& P, const Vec3<T>& p) {
  const T q0 = len2(p.x, p.z) - T(P.tx);
  return len2(q0, p.y) - T(P.ty);
}

template <class T>
__device__ __forceinline__ Vec3<T> torus_normal(const Prim& P, const Vec3<T>& p) {
  const T l = len2(p.x, p.z);
  const T q0 = l - T(P.tx);
  const T ql = len2(q0, p.y);
  const T n20 = q0 / ql, n21 = p.y / ql;
  const T nx = (p.x / l) * n20, ny = n21, nz = (p.z / l) * n20;
  const T nl3 = len3(nx, ny, nz);
  return {nx / nl3, ny / nl3, nz / nl3};
}

template <class T>
__device__ __forceinline__ T box_sdf(const Prim& P, const Vec3<T>& p) {
  const T qx = dabs(p.x) - T(P.sx), qy = dabs(p.y) - T(P.sy), qz = dabs(p.z) - T(P.sz);
  const T out = len3(tmax(qx, T(0.0f)), tmax(qy, T(0.0f)), tmax(qz, T(0.0f)));
  return out + tmin(tmax(qx, tmax(qy, qz)), T(0.0f));
}

template <class T>
__device__ __forceinline__ Vec3<T> box_normal(const Prim& P, const Vec3<T>& p) {
  // central finite differences with d = 1e-4 (reference primitives.py:240-251)
  const float d = 1e-4f, s = 5000.0f;
  const T nx = (box_sdf(P, Vec3<T>{p.x + T(d), p.y, p.z}) - box_sdf(P, Vec3<T>{p.x - T(d), p.y, p.z})) * T(s);
  const T ny = (box_sdf(P, Vec3<T>{p.x, p.y + T(d), p.z}) - box_sdf(P, Vec3<T>{p.x, p.y - T(d), p.z})) * T(s);
  const T nz = (box_sdf(P, Vec3<T>{p.x, p.y, p.z + T(d)}) - box_sdf(P, Vec3<T>{p.x, p.y, p.z - T(d)})) * T(s);
  const T nl = len3(nx, ny, nz);
  return {nx / nl, ny / nl, nz / nl};
}

// the two sticks of Chopsticks, each a capsule (primitives._chopsticks_parts)
template <class T>
__device__ __forceinline__ void chopsticks_parts(const Prim& P, const Vec3<T>& p, const T& gap,
                                                 Vec3<T>& a, Vec3<T>& b) {
  const T half = gap * T(0.5f);
  const T py2 = p.y + T(P.h / 2);
  a = {p.x - half, py2, p.z};
  b = {p.x + half, py2, p.z};
}

template <class T>
__device__ __forceinline__ T local_sdf(const Prim& P, const Vec3<T>& p, const T& gap) {
  switch (P.shape) {
    case kCapsule:
      return capsule_sdf(P, p);
    case kChopsticks: {
      Vec3<T> a, b;
      chopsticks_parts(P, p, gap, a, b);
      return tmin(capsule_sdf(P, a), capsule_sdf(P, b));
    }
    case kCylinder:
      return cylinder_sdf(P, p);
    case kTorus:
      return torus_sdf(P, p);
    default:
      return box_sdf(P, p);
  }
}

template <class T>
__device__ __forceinline__ Vec3<T> local_normal(const Prim& P, const Vec3<T>& p, const T& gap) {
  switch (P.shape) {
    case kCapsule:
      return capsule_normal(P, p);
    case kChopsticks: {
      Vec3<T> a, b;
      chopsticks_parts(P, p, gap, a, b);
      return val(capsule_sdf(P, a)) <= val(capsule_sdf(P, b)) ? capsule_normal(P, a)
                                                             : capsule_normal(P, b);
    }
    case kCylinder:
      return cylinder_normal(P, p);
    case kTorus:
      return torus_normal(P, p);
    default:
      return box_normal(P, p);
  }
}
// ---------------------------------------------------------------------------
// contact response (primitives.collide, reference primive_base.py:91-115)
// ---------------------------------------------------------------------------
// One primitive's poses at f and f+1, read from the block's shared copy.
struct PrimPose {
  const float *pos_f, *rot_f, *pos_f1, *rot_f1;
  const float* conj_f;  // conj(rot_f) / |rot_f|
  float gap_f;
};

// An env's primitives staged in shared memory: parameters, poses, and each
// rotation's renormalised conjugate, computed once per block, not per cell.
struct PoseSmem {
  Prim prim[PLB_MAX_PRIMS];
  float pose[PLB_MAX_PRIMS][16];
  float conj[PLB_MAX_PRIMS][4];
};

__device__ __forceinline__ Prim prim_of(const PrimTable& table, int i) {
  const float* pr = table.param[i];
  return {table.shape[i], pr[0], pr[1], pr[2], pr[3], pr[4], pr[5], pr[6], pr[7], pr[8]};
}

// Thread i < k stages primitive i; the caller's barrier publishes it.
__device__ __forceinline__ void stage_pose(const PrimTable& table, const float* __restrict__ poses,
                                           PoseSmem& s) {
  const int i = threadIdx.x;
  if (i >= table.k) return;
  s.prim[i] = prim_of(table, i);
#pragma unroll
  for (int j = 0; j < 16; ++j) s.pose[i][j] = poses[i * 16 + j];
  conj_normalized(s.pose[i] + 3, s.conj[i]);
}

__device__ __forceinline__ PrimPose prim_pose(const PoseSmem& s, int i) {
  return {s.pose[i], s.pose[i] + 3, s.pose[i] + 8, s.pose[i] + 11, s.conj[i], s.pose[i][7]};
}

// What the contact response of one cell needs from the geometry: the
// distance and, where the contact condition holds, the normal; in the
// backward also their Jacobians with respect to the local point and the gap.
struct Contact {
  V3 d0;            // gp - pos_f
  V3 local;         // conj_f applied to d0 (the collider's rest frame)
  float l;          // sphere: |d0|
  float dist;       // signed distance
  float influence;  // min(exp(-dist softness), 1)
  V3 nl;            // normal, local frame (non-spheres)
  V3 D;             // normal, world frame
  float sd[4];      // d dist / d (local x, y, z, gap)  [backward]
  float J[3][4];    // d nl_i / d (local x, y, z, gap)  [backward]
};

// SPHERES: the kernels of a scene whose primitives are all spheres (Move-v1,
// TripleMove-v1), compiled without the other shapes' code: fewer registers
// and a third of the instructions, measured faster than the all-shapes
// kernels on such scenes (PERF.md).
template <bool SPHERES>
__device__ __forceinline__ bool is_sphere(const Prim& P) {
  return SPHERES || P.shape == kSphere;
}

template <bool SPHERES>
__device__ __forceinline__ void contact_frame(const Prim& P, const PrimPose& pp, V3 gp, Contact& c) {
  c.d0 = {gp.x - pp.pos_f[0], gp.y - pp.pos_f[1], gp.z - pp.pos_f[2]};
  c.local = qrot(pp.conj_f, c.d0);
  if (is_sphere<SPHERES>(P)) c.l = len3(c.d0.x, c.d0.y, c.d0.z);
}

// The float SDF and the contact condition; the normal only where it holds.
template <bool SPHERES>
__device__ __forceinline__ bool contact_geometry(const Prim& P, const PrimPose& pp, V3 gp,
                                                 float softness, Contact& c) {
  contact_frame<SPHERES>(P, pp, gp, c);
  const bool sphere = is_sphere<SPHERES>(P);
  c.dist = sphere ? c.l - P.radius : local_sdf(P, c.local, pp.gap_f);
  c.influence = jmin(expf(-c.dist * softness), 1.0f);
  if (!((softness > 0.0f && c.influence > 0.1f) || c.dist <= 0.0f)) return false;
  if (sphere) {
    c.D = {c.d0.x / c.l, c.d0.y / c.l, c.d0.z / c.l};
    return true;
  }
  if (SPHERES) return true;
  c.nl = local_normal(P, c.local, pp.gap_f);
  c.D = qrot(pp.rot_f, c.nl);
  return true;
}

// The backward's geometry of a cell where the contact condition holds (the
// forward pass tested it on the float SDF): distance, normal and, for the
// non-spheres, their Jacobians from the dual-number SDF and normal.
template <bool SPHERES>
__device__ __forceinline__ void contact_jacobians(const Prim& P, const PrimPose& pp, V3 gp,
                                                  float softness, Contact& c) {
  contact_frame<SPHERES>(P, pp, gp, c);
  if (is_sphere<SPHERES>(P)) {
    c.dist = c.l - P.radius;
    c.D = {c.d0.x / c.l, c.d0.y / c.l, c.d0.z / c.l};
  } else if (!SPHERES) {
    const Vec3<Dual> p = {seed(c.local.x, 0), seed(c.local.y, 1), seed(c.local.z, 2)};
    const Dual gap = seed(pp.gap_f, 3);
    const Dual sdf = local_sdf(P, p, gap);
    c.dist = sdf.v;
#pragma unroll
    for (int j = 0; j < 4; ++j) c.sd[j] = sdf.d[j];
    const Vec3<Dual> n = local_normal(P, p, gap);
    c.nl = {n.x.v, n.y.v, n.z.v};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      c.J[0][j] = n.x.d[j];
      c.J[1][j] = n.y.d[j];
      c.J[2][j] = n.z.d[j];
    }
    c.D = qrot(pp.rot_f, c.nl);
  }
  c.influence = jmin(expf(-c.dist * softness), 1.0f);
}

// Intermediates of one contact response.
struct Response {
  V3 cv, iv, t, ts;
  float influence, nc, ncm, tnorm, num, s_eff;
  bool flag;
};

__device__ __forceinline__ Response respond(const Prim& P, const PrimPose& pp, const Contact& c,
                                            float inv_dt, V3 gp, V3 v) {
  Response r;
  r.influence = c.influence;
  // collider surface velocity (primitives.collider_v)
  const V3 np = qrot(pp.rot_f1, c.local);
  r.cv = {(np.x + pp.pos_f1[0] - gp.x) * inv_dt, (np.y + pp.pos_f1[1] - gp.y) * inv_dt,
          (np.z + pp.pos_f1[2] - gp.z) * inv_dt};
  r.iv = {v.x - r.cv.x, v.y - r.cv.y, v.z - r.cv.z};
  const V3 D = c.D;
  r.nc = r.iv.x * D.x + r.iv.y * D.y + r.iv.z * D.z;
  r.ncm = jmin(r.nc, 0.0f);
  r.t = {r.iv.x - r.ncm * D.x, r.iv.y - r.ncm * D.y, r.iv.z - r.ncm * D.z};
  r.tnorm = len3(r.t.x, r.t.y, r.t.z, 1e-8f);
  r.num = r.tnorm + r.nc * P.friction;
  const float scale = jmax(0.0f, r.num) / r.tnorm;
  r.flag = r.nc < 0.0f && sqrtf(r.t.x * r.t.x + r.t.y * r.t.y + r.t.z * r.t.z) > 1e-30f;
  r.s_eff = r.flag ? scale : 1.0f;
  r.ts = {r.t.x * r.s_eff, r.t.y * r.s_eff, r.t.z * r.s_eff};
  return r;
}

__device__ __forceinline__ V3 response_v(const Response& r) {
  const float keep = 1.0f - r.influence, in = r.influence;
  return {r.cv.x + r.iv.x * keep + r.ts.x * in, r.cv.y + r.iv.y * keep + r.ts.y * in,
          r.cv.z + r.iv.z * keep + r.ts.z * in};
}

// forward: v is left as it is where the contact condition does not hold;
// true where it holds
template <bool SPHERES>
__device__ __forceinline__ bool collide(const Prim& P, const PrimPose& pp, float softness,
                                        float inv_dt, V3 gp, V3& v) {
  Contact c;
  if (!contact_geometry<SPHERES>(P, pp, gp, softness, c)) return false;
  v = response_v(respond(P, pp, c, inv_dt, gp, v));
  return true;
}

// backward of collide where the contact condition holds, given the output's
// cotangent g (in/out: the input v's cotangent); adds the cell's pose
// cotangents to pg
template <bool SPHERES>
__device__ __forceinline__ void collide_bwd(const Prim& P, const PrimPose& pp, float softness,
                                            float inv_dt, V3 gp, V3 v, V3& g, float (&pg)[kPG]) {
  Contact c;
  contact_jacobians<SPHERES>(P, pp, gp, softness, c);
  const Response r = respond(P, pp, c, inv_dt, gp, v);
  const V3 D = c.D;
  const float influence = c.influence, keep = 1.0f - influence;

  V3 g_cv = g;
  V3 g_iv = {g.x * keep, g.y * keep, g.z * keep};
  const V3 g_ts = {g.x * influence, g.y * influence, g.z * influence};
  const float g_infl = (g.x * r.ts.x + g.y * r.ts.y + g.z * r.ts.z) -
                       (g.x * r.iv.x + g.y * r.iv.y + g.z * r.iv.z);
  V3 g_t = {g_ts.x * r.s_eff, g_ts.y * r.s_eff, g_ts.z * r.s_eff};
  float g_nc = 0.0f;
  if (r.flag) {
    // ts = t * max(num, 0) / tnorm, num = tnorm + nc * friction; the adjoint
    // multiplies by one reciprocal of tnorm (PERF.md)
    const float inv_tn = 1.0f / r.tnorm;
    const float g_seff = g_ts.x * r.t.x + g_ts.y * r.t.y + g_ts.z * r.t.z;
    const float numc = jmax(0.0f, r.num);
    float g_tnorm = -g_seff * numc * inv_tn * inv_tn;
    if (r.num >= 0.0f) {
      const float g_num = g_seff * inv_tn;
      g_tnorm += g_num;
      g_nc += g_num * P.friction;
    }
    const float gi = g_tnorm * inv_tn;
    g_t.x += gi * r.t.x;
    g_t.y += gi * r.t.y;
    g_t.z += gi * r.t.z;
  }
  // t = iv - min(nc, 0) D
  g_iv = {g_iv.x + g_t.x, g_iv.y + g_t.y, g_iv.z + g_t.z};
  const float g_ncm = -(g_t.x * D.x + g_t.y * D.y + g_t.z * D.z);
  V3 g_D = {-r.ncm * g_t.x, -r.ncm * g_t.y, -r.ncm * g_t.z};
  if (r.nc <= 0.0f) g_nc += g_ncm;
  // nc = iv . D
  g_iv = {g_iv.x + g_nc * D.x, g_iv.y + g_nc * D.y, g_iv.z + g_nc * D.z};
  g_D = {g_D.x + g_nc * r.iv.x, g_D.y + g_nc * r.iv.y, g_D.z + g_nc * r.iv.z};
  // iv = v - cv
  g = g_iv;
  g_cv = {g_cv.x - g_iv.x, g_cv.y - g_iv.y, g_cv.z - g_iv.z};
  // influence = min(exp(-dist softness), 1)
  const float e = expf(-c.dist * softness);
  const float g_dist = e <= 1.0f ? -g_infl * e * softness : 0.0f;
  // cv = (qrot(rot_f1, local) + pos_f1 - gp) / dt
  const V3 g_np = {g_cv.x * inv_dt, g_cv.y * inv_dt, g_cv.z * inv_dt};
  pg[kPosF1 + 0] += g_np.x;
  pg[kPosF1 + 1] += g_np.y;
  pg[kPosF1 + 2] += g_np.z;
  V3 g_local = qrot_bwd(pp.rot_f1, c.local, g_np, pg + kRotF1);
  V3 g_d0 = {0.0f, 0.0f, 0.0f};
  if (is_sphere<SPHERES>(P)) {
    // dist = |d0| - radius, D = d0 / |d0|: g_d0 = (g_dist d0 + g_D - D (D . g_D)) / |d0|
    const float inv_l = 1.0f / c.l;
    const float dg = (c.d0.x * g_D.x + c.d0.y * g_D.y + c.d0.z * g_D.z) * inv_l * inv_l;
    g_d0 = {(g_dist * c.d0.x + g_D.x - c.d0.x * dg) * inv_l,
            (g_dist * c.d0.y + g_D.y - c.d0.y * dg) * inv_l,
            (g_dist * c.d0.z + g_D.z - c.d0.z * dg) * inv_l};
  } else if (!SPHERES) {
    // D = qrot(rot_f, nl(local, gap)), dist = sdf(local, gap)
    const V3 g_nl = qrot_bwd(pp.rot_f, c.nl, g_D, pg + kRotF);
    float gl[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      gl[j] = g_dist * c.sd[j] + g_nl.x * c.J[0][j] + g_nl.y * c.J[1][j] + g_nl.z * c.J[2][j];
    g_local = {g_local.x + gl[0], g_local.y + gl[1], g_local.z + gl[2]};
    pg[kGapF] += gl[3];
  }
  // local = qrot(conj_f, d0), d0 = gp - pos_f
  const V3 g_d0r = qrot_bwd(pp.conj_f, c.d0, g_local, pg + kConjF);
  g_d0 = {g_d0.x + g_d0r.x, g_d0.y + g_d0r.y, g_d0.z + g_d0r.z};
  pg[kPosF + 0] -= g_d0.x;
  pg[kPosF + 1] -= g_d0.y;
  pg[kPosF + 2] -= g_d0.z;
}

struct CellCtx {
  int c[3];
  float cf[3];
  V3 gp;
};

__device__ __forceinline__ CellCtx cell_ctx(int cell, int G, float dx) {
  CellCtx x;
  if ((G & (G - 1)) == 0) {  // shifts and masks, not run-time divisions
    const int s = __ffs(G) - 1;
    x.c[0] = cell >> (2 * s);
    x.c[1] = (cell >> s) & (G - 1);
    x.c[2] = cell & (G - 1);
  } else {
    x.c[0] = cell / (G * G);
    x.c[1] = (cell / G) % G;
    x.c[2] = cell % G;
  }
#pragma unroll
  for (int d = 0; d < 3; ++d) x.cf[d] = static_cast<float>(x.c[d]);
  x.gp = {x.cf[0] * dx, x.cf[1] * dx, x.cf[2] * dx};
  return x;
}

// Walls and ground, step d of the boundary loop (grid_op_core :227-249):
// first the low side (wall, or ground friction for d = 1), then the high
// side, which tests v[d] as the low side left it.
__device__ __forceinline__ void wall_low(int d, const CellCtx& x, float gf, float (&v)[3]) {
  if (!(x.c[d] < 3 && v[d] < 0.0f)) return;
  if (d != 1 || gf == 0.0f) {
    v[d] = 0.0f;
  } else if (gf < 10.0f) {
    // Coulomb-like ground friction with the 1e-30 tie-breakers
    const float lin = v[1] + 1e-30f;
    float vit[3];
#pragma unroll
    for (int e = 0; e < 3; ++e) vit[e] = v[e] - x.cf[e] * 1e-30f;
    vit[1] = vit[1] - lin;
    const float lit = sqrtf(vit[0] * vit[0] + vit[1] * vit[1] + vit[2] * vit[2] + 1e-8f);
    const float scale = jmax(1.0f + gf * lin / lit, 0.0f);
    v[0] = scale * (vit[0] + x.cf[0] * 1e-30f);
    v[1] = 0.0f;
    v[2] = scale * (vit[2] + x.cf[2] * 1e-30f);
  } else {
    v[0] = v[1] = v[2] = 0.0f;
  }
}

__device__ __forceinline__ void wall_step(int d, const CellCtx& x, int G, float gf, float (&v)[3]) {
  wall_low(d, x, gf, v);
  if (x.c[d] > G - 3 && v[d] > 0.0f) v[d] = 0.0f;
}

// Backward of wall_step given v before it and the cotangent g of v after it.
__device__ __forceinline__ void wall_step_bwd(int d, const CellCtx& x, int G, float gf,
                                              const float (&v)[3], float (&g)[3]) {
  float mid[3] = {v[0], v[1], v[2]};
  wall_low(d, x, gf, mid);
  if (x.c[d] > G - 3 && mid[d] > 0.0f) g[d] = 0.0f;
  if (!(x.c[d] < 3 && v[d] < 0.0f)) return;
  if (d != 1 || gf == 0.0f) {
    g[d] = 0.0f;
  } else if (gf < 10.0f) {
    const float lin = v[1] + 1e-30f;
    float vit[3];
#pragma unroll
    for (int e = 0; e < 3; ++e) vit[e] = v[e] - x.cf[e] * 1e-30f;
    vit[1] = vit[1] - lin;
    const float lit = sqrtf(vit[0] * vit[0] + vit[1] * vit[1] + vit[2] * vit[2] + 1e-8f);
    const float rr = 1.0f + gf * lin / lit;
    const float scale = jmax(rr, 0.0f);
    const float a0 = vit[0] + x.cf[0] * 1e-30f, a2 = vit[2] + x.cf[2] * 1e-30f;
    const float g_scale = g[0] * a0 + g[2] * a2;
    float g_vit[3] = {g[0] * scale, 0.0f, g[2] * scale};
    float g_lin = 0.0f;
    if (rr >= 0.0f) {  // scale = max(rr, 0)
      g_lin += g_scale * gf / lit;
      const float g_lit = -g_scale * gf * lin / (lit * lit);
#pragma unroll
      for (int e = 0; e < 3; ++e) g_vit[e] += g_lit * vit[e] / lit;
    }
    // vit = v - lin e_y - cf 1e-30, lin = v_y + 1e-30
    g_lin -= g_vit[1];
    g[0] = g_vit[0];
    g[1] = g_vit[1] + g_lin;
    g[2] = g_vit[2];
  } else {
    g[0] = g[1] = g[2] = 0.0f;
  }
}

// The scalar arguments of the grid kernels that all envs share.
struct GridConsts {
  int G;
  float dx, dt, g30[3], ground_friction, vmax;
};

// A cell's velocity after gravity, every primitive's contact, the walls and
// the clamp (grid_op_core), from its grid4 row of non-zero mass.
template <bool SPHERES>
__device__ __forceinline__ void cell_fwd(float4 row, int cell, const PoseSmem& ps, int kk,
                                         const GridConsts& k, float softness, float (&v)[3]) {
  const CellCtx x = cell_ctx(cell, k.G, k.dx);
  const float inv_m = 1.0f / row.w;
  V3 vv = {row.x * inv_m + k.g30[0], row.y * inv_m + k.g30[1], row.z * inv_m + k.g30[2]};
  const float inv_dt = 1.0f / k.dt;
  for (int i = 0; i < kk; ++i)
    collide<SPHERES>(ps.prim[i], prim_pose(ps, i), softness, inv_dt, x.gp, vv);
  v[0] = vv.x;
  v[1] = vv.y;
  v[2] = vv.z;
#pragma unroll
  for (int d = 0; d < 3; ++d) wall_step(d, x, k.G, k.ground_friction, v);
  if (k.vmax > 0.0f) {
#pragma unroll
    for (int d = 0; d < 3; ++d) v[d] = jmin(jmax(v[d], -k.vmax), k.vmax);
  }
}

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = plb::kThreads / 32;

// Launch shapes (PERF.md): each block walks TILES tiles of kThreads
// consecutive cells of one env, every tile's grid4 rows loaded (before the
// block's pose staging) before the first is used; min blocks per SM for the
// register cap. The forward takes kFwdTilesWide tiles a block from
// kFwdWideFrom envs (fewer, fuller blocks once B envs fill the card).
constexpr int kFwdTiles = 1;
constexpr int kFwdTilesWide = 4;
constexpr int kFwdWideFrom = 4;
constexpr int kFwdMinBlocks = 4;
constexpr int kBwdTiles = 8;
constexpr int kBwdMinBlocks = 2;
// bit words of one env's block flags that the last block stages (G <= 406
// at kBwdTiles = 8)
constexpr int kMaxFlagWords = 1024;

// row[t] of a register array at a run-time t, without local memory
template <int N>
__device__ __forceinline__ float4 pick(const float4 (&row)[N], int t) {
  float4 r = row[0];
#pragma unroll
  for (int u = 1; u < N; ++u)
    if (t == u) r = row[u];
  return r;
}

// grid (ceil(G^3 / (TILES kThreads)), B): block (x, env) holds cells of
// env alone. A warp without mass writes its 32 zero rows as 16-byte stores;
// a warp with mass stages its rows in shared memory and writes them so too
// (a 12-byte stride per thread multiplies the L2's write transactions,
// common.cuh).
template <int TILES, bool SPHERES>
__global__ void __launch_bounds__(plb::kThreads, kFwdMinBlocks)
    grid_op_kernel(const float* __restrict__ grid4, const float* __restrict__ poses,
                   const float* __restrict__ softness, float* __restrict__ out, PrimTable table,
                   GridConsts k) {
  __shared__ PoseSmem ps;
  __shared__ __align__(16) float slab[kWarps][32 * 3];
  const int cells = k.G * k.G * k.G;
  const long long env = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float4* g4 = reinterpret_cast<const float4*>(grid4) + env * cells;
  float* o = out + env * cells * 3;
  const int first = blockIdx.x * (TILES * plb::kThreads) + threadIdx.x;
  float4 row[TILES];
#pragma unroll
  for (int t = 0; t < TILES; ++t) {
    const int cell = first + t * plb::kThreads;
    row[t] = cell < cells ? __ldg(g4 + cell) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  stage_pose(table, poses + env * table.k * 16, ps);
  __syncthreads();
  const float soft = softness[env];
#pragma unroll 1
  for (int t = 0; t < TILES; ++t) {
    const int cell = first + t * plb::kThreads;
    const int row0 = cell - lane;
    const float4 rt = pick(row, t);
    const bool active = cell < cells && rt.w > 1e-12f;
    float v[3] = {0.0f, 0.0f, 0.0f};  // cells with no mass keep zero velocity
    const bool any = __ballot_sync(kFull, active) != 0;
    if (active) cell_fwd<SPHERES>(rt, cell, ps, table.k, k, soft, v);
    float* dst = o + static_cast<long long>(row0) * 3;
    if (row0 + 32 <= cells && (reinterpret_cast<unsigned long long>(dst) & 15) == 0) {
      if (!any) {
        if (lane < 24) reinterpret_cast<float4*>(dst)[lane] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        continue;
      }
#pragma unroll
      for (int d = 0; d < 3; ++d) slab[warp][lane * 3 + d] = v[d];
      __syncwarp();
      if (lane < 24)
        reinterpret_cast<float4*>(dst)[lane] = reinterpret_cast<const float4*>(slab[warp])[lane];
      __syncwarp();
    } else if (cell < cells) {
#pragma unroll
      for (int d = 0; d < 3; ++d) dst[lane * 3 + d] = v[d];
    }
  }
}

// The adjoint of one cell of non-zero mass, up to the primitive loop:
// recomputes the cell's forward, noting which primitives it touches (the
// contact condition depends on the cell and the poses, not on the
// velocity), and runs the clamp and the walls backwards. The kernel then
// runs each touching primitive backwards, last first, the velocity entering
// it recomputed from v0 through the touching primitives before it: no
// per-primitive array (one indexed at run time lives in local memory).
struct CellAdjoint {
  V3 v0;          // velocity after gravity
  float g[3];     // cotangent of the velocity entering the primitive loop
  unsigned hits;  // bit i: the contact condition holds for primitive i
  CellCtx x;
};

template <bool SPHERES>
__device__ __forceinline__ void cell_adjoint_walls(float4 row, int cell, const float* __restrict__ ct,
                                                   const PoseSmem& ps, int kk, const GridConsts& k,
                                                   float softness, CellAdjoint& a) {
  float ctc[3];  // loaded first: their latency overlaps the forward recompute
#pragma unroll
  for (int d = 0; d < 3; ++d) ctc[d] = __ldg(ct + static_cast<long long>(cell) * 3 + d);
  a.x = cell_ctx(cell, k.G, k.dx);
  const float inv_m = 1.0f / row.w;
  a.v0 = {row.x * inv_m + k.g30[0], row.y * inv_m + k.g30[1], row.z * inv_m + k.g30[2]};
  const float inv_dt = 1.0f / k.dt;
  V3 vv = a.v0;
  a.hits = 0;
  for (int i = 0; i < kk; ++i)
    if (collide<SPHERES>(ps.prim[i], prim_pose(ps, i), softness, inv_dt, a.x.gp, vv))
      a.hits |= 1u << i;
  float vwall[3][3];
  float v[3] = {vv.x, vv.y, vv.z};
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    vwall[d][0] = v[0];
    vwall[d][1] = v[1];
    vwall[d][2] = v[2];
    wall_step(d, a.x, k.G, k.ground_friction, v);
  }
  // the clamp passes the cotangent inside [-vmax, vmax]
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    a.g[d] = ctc[d];
    if (k.vmax > 0.0f && !(v[d] >= -k.vmax && v[d] <= k.vmax)) a.g[d] = 0.0f;
  }
#pragma unroll
  for (int d = 2; d >= 0; --d) wall_step_bwd(d, a.x, k.G, k.ground_friction, vwall[d], a.g);
}

// The adjoint of a pass of a warp's cells with mass, one a lane (`active`):
// each lane's d grid4 row; per primitive touched by some lane, the
// lanes' pose cotangents are summed by a shuffle tree into lane 0, which
// adds them to the warp's slot; `touched` where some lane touched one.
struct WarpAdjoint {
  float4 out;
  bool touched;
};

template <bool SPHERES>
__device__ __forceinline__ WarpAdjoint warp_adjoint(float4 row, int cell, bool active,
                                                    const float* __restrict__ ct,
                                                    const PoseSmem& ps, int kk, GridConsts k,
                                                    float soft, float (*slot)[kPG]) {
  WarpAdjoint r = {make_float4(0.0f, 0.0f, 0.0f, 0.0f), false};
  const float inv_dt = 1.0f / k.dt;
  CellAdjoint a;
  a.hits = 0;
  if (active) cell_adjoint_walls<SPHERES>(row, cell, ct, ps, kk, k, soft, a);
  for (int i = kk - 1; i >= 0; --i) {
    const bool hit = (a.hits >> i) & 1u;
    if (__ballot_sync(kFull, hit) == 0) continue;
    float pg[kPG];
#pragma unroll
    for (int j = 0; j < kPG; ++j) pg[j] = 0.0f;
    if (hit) {
      V3 vin = a.v0;
      for (int j = 0; j < i; ++j)
        if ((a.hits >> j) & 1u)
          collide<SPHERES>(ps.prim[j], prim_pose(ps, j), soft, inv_dt, a.x.gp, vin);
      V3 gv = {a.g[0], a.g[1], a.g[2]};
      collide_bwd<SPHERES>(ps.prim[i], prim_pose(ps, i), soft, inv_dt, a.x.gp, vin, gv, pg);
      a.g[0] = gv.x;
      a.g[1] = gv.y;
      a.g[2] = gv.z;
    }
    // 19 independent trees, one level at a time; a sphere's rot_f and gap
    // terms are zero
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
#pragma unroll
      for (int j = 0; j < kPG; ++j)
        if (!(SPHERES && (j == kGapF || (j >= kRotF && j < kRotF + 4))))
          pg[j] += __shfl_down_sync(kFull, pg[j], off);
    if ((threadIdx.x & 31) == 0) {
#pragma unroll
      for (int j = 0; j < kPG; ++j) slot[i][j] += pg[j];
    }
    r.touched = true;
  }
  if (active) {
    // v0_s = mom_s / m + gravity_s
    const float inv_m = 1.0f / row.w;
    r.out.x = a.g[0] * inv_m;
    r.out.y = a.g[1] * inv_m;
    r.out.z = a.g[2] * inv_m;
    r.out.w = -(a.g[0] * row.x * inv_m * inv_m) - a.g[1] * row.y * inv_m * inv_m -
              a.g[2] * row.z * inv_m * inv_m;
  }
  return r;
}

// One primitive's (16,) pose cotangent row from its summed kPG components:
// the renormalised conjugate's cotangent g_c maps back to rot_f through
// c = conj(q) / |q| (staged per block): g_q = sign * (g_c - c (c . g_c)) / |q|.
__device__ __forceinline__ void pose_row(const float* tot, const float* q, const float* c,
                                         float* out) {
  const float inv_nq = 1.0f / sqrtf(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3]);
  const float* gc = tot + kConjF;
  const float cg = c[0] * gc[0] + c[1] * gc[1] + c[2] * gc[2] + c[3] * gc[3];
  const float sign[4] = {1.0f, -1.0f, -1.0f, -1.0f};
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    out[j] = tot[kPosF + j];
    out[8 + j] = tot[kPosF1 + j];
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    out[3 + j] = tot[kRotF + j] + sign[j] * (gc[j] - c[j] * cg) * inv_nq;
    out[11 + j] = tot[kRotF1 + j];
  }
  out[7] = tot[kGapF];
  out[15] = 0.0f;  // gap_f1 does not enter the grid update
}

// Grid (ceil(G^3 / (kBwdTiles kThreads)), B): block (x, env) holds cells
// of env alone, a partition that depends on G alone, not on B or the card.
// Each warp writes the d grid4 zeros of its cells without mass as 16-byte
// stores, and packs its cells with mass from all its tiles, in cell order,
// into passes of 32 lanes. Pose cotangents are summed where they arise: per
// primitive, a pass with a cell in contact sums the cells' 19 components by
// a shuffle tree into lane 0, which adds them to the warp's own slot in
// shared memory (passes in order); after one barrier the block sums its
// warps' slots in warp order into its row of `partials` (B, nblocks, k, kPG)
// and sets its flag. The env's last block to finish (a counter per env) sums the flagged
// rows in block order and writes the env's (k, 16) pose cotangents; which
// block is last does not reach the result. done: per env, a flag per block
// then the counter, zero between launches (the last block resets them).
template <bool SPHERES>
__global__ void __launch_bounds__(plb::kThreads, kBwdMinBlocks)
    grid_op_bwd_kernel(const float* __restrict__ grid4, const float* __restrict__ poses,
                       const float* __restrict__ softness, const float* __restrict__ ct,
                       float* __restrict__ dgrid4, float* __restrict__ dposes,
                       float* __restrict__ partials, unsigned int* __restrict__ done,
                       PrimTable table, GridConsts k) {
  __shared__ PoseSmem ps;
  __shared__ float slot[kWarps][PLB_MAX_PRIMS][kPG];
  __shared__ unsigned int flags[kMaxFlagWords];  // the last block's copy of the env's flags
  __shared__ int cells_with_mass[kWarps][kBwdTiles * 32];
  const int cells = k.G * k.G * k.G;
  const int nblocks = gridDim.x, nwords = (nblocks + 31) / 32;
  const long long env = blockIdx.y;
  const int kk = table.k;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float4* g4 = reinterpret_cast<const float4*>(grid4) + env * cells;
  float4* dg4 = reinterpret_cast<float4*>(dgrid4) + env * cells;
  const float* cte = ct + env * cells * 3;
  const int first = blockIdx.x * (kBwdTiles * plb::kThreads) + threadIdx.x;
  float4 row[kBwdTiles];
#pragma unroll
  for (int t = 0; t < kBwdTiles; ++t) {
    const int cell = first + t * plb::kThreads;
    row[t] = cell < cells ? __ldg(g4 + cell) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  stage_pose(table, poses + env * kk * 16, ps);
  for (int j = lane; j < kk * kPG; j += 32) slot[warp][j / kPG][j % kPG] = 0.0f;
  __syncthreads();
  const float soft = softness[env];
  // a warp's cells with mass, tile by tile in cell order, packed into passes
  // of 32 lanes; the other cells' d grid4 rows are zero
  int n = 0;
#pragma unroll
  for (int t = 0; t < kBwdTiles; ++t) {
    const int cell = first + t * plb::kThreads;
    const bool active = cell < cells && row[t].w > 1e-12f;
    const unsigned int bal = __ballot_sync(kFull, active);
    if (active)
      cells_with_mass[warp][n + __popc(bal & ((1u << lane) - 1u))] = cell;
    else if (cell < cells)
      dg4[cell] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    n += __popc(bal);
  }
  __syncwarp();
  bool contributed = false;  // uniform over the warp
  for (int p = 0; p < n; p += 32) {
    const bool active = p + lane < n;
    const int cell = active ? cells_with_mass[warp][p + lane] : 0;
    const float4 rt = active ? __ldg(g4 + cell) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    const WarpAdjoint w =
        warp_adjoint<SPHERES>(rt, cell, active, cte, ps, kk, k, soft, slot[warp]);
    contributed |= w.touched;
    if (active) dg4[cell] = w.out;
  }
  if (kk == 0) return;
  // the block's row of partials and its flag, then the env's counter
  const bool any = __syncthreads_or(contributed);
  float* part = partials + env * nblocks * kk * kPG;
  unsigned int* flag = done + env * (nblocks + 1);  // nblocks flags, then the counter
  if (any) {
    if (threadIdx.x < kk * kPG) {
      float s = 0.0f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) s += slot[w][threadIdx.x / kPG][threadIdx.x % kPG];
      part[static_cast<long long>(blockIdx.x) * kk * kPG + threadIdx.x] = s;
    }
    if (threadIdx.x == 0) flag[blockIdx.x] = 1u;
    __threadfence();
    __syncthreads();
  }
  if (warp != 0) return;
  unsigned int last = 0;
  if (lane == 0) last = atomicAdd(flag + nblocks, 1u) == static_cast<unsigned int>(nblocks - 1);
  if (!__shfl_sync(kFull, last, 0)) return;
  // the env's last block, warp 0: the flags as bit words (eight words' loads
  // in flight at a time), each flag and the counter reset to zero
  __threadfence();
  for (int w0 = 0; w0 < nwords; w0 += 8) {
    unsigned int f[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int b = (w0 + u) * 32 + lane;
      f[u] = b < nblocks ? __ldcg(flag + b) : 0u;
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      if (f[u]) flag[(w0 + u) * 32 + lane] = 0u;
      const unsigned int bits = __ballot_sync(kFull, f[u] != 0u);
      if (lane == 0 && w0 + u < nwords) flags[w0 + u] = bits;
    }
  }
  if (lane == 0) flag[nblocks] = 0u;
  __syncwarp();
  // lane l sums components l + 32 r, r < ceil(k kPG / 32), over the flagged
  // blocks, eight rows' loads in flight at a time
  constexpr int R = (PLB_MAX_PRIMS * kPG + 31) / 32;
  float tot[R];
#pragma unroll
  for (int r = 0; r < R; ++r) tot[r] = 0.0f;
  int w = 0;
  unsigned int bits = 0u;
  while (true) {
    int b[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      while (bits == 0u && w < nwords) bits = flags[w++];
      b[u] = bits ? (w - 1) * 32 + __ffs(bits) - 1 : -1;
      bits &= bits - 1u;
    }
    if (b[0] < 0) break;
    float val[8][R];
#pragma unroll
    for (int u = 0; u < 8; ++u)
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int c = lane + 32 * r;
        val[u][r] = b[u] >= 0 && c < kk * kPG
                        ? __ldcg(part + static_cast<long long>(b[u]) * kk * kPG + c)
                        : 0.0f;
      }
#pragma unroll
    for (int u = 0; u < 8; ++u)
      if (b[u] >= 0) {
#pragma unroll
        for (int r = 0; r < R; ++r) tot[r] += val[u][r];
      }
  }
  // stage the totals in this warp's slots, then one lane per primitive
  // maps them to its (16,) row
  float* sum = &slot[0][0][0];
#pragma unroll
  for (int r = 0; r < R; ++r)
    if (lane + 32 * r < kk * kPG) sum[lane + 32 * r] = tot[r];
  __syncwarp();
  if (lane < kk)
    pose_row(sum + lane * kPG, ps.pose[lane] + 3, ps.conj[lane], dposes + (env * kk + lane) * 16);
}

bool all_spheres(const PrimTable& table) {
  for (int i = 0; i < table.k; ++i)
    if (table.shape[i] != kSphere) return false;
  return true;
}

}  // namespace

// B envs: grid4 (B, G^3, 4), poses (B, k, 16), softness (B,) on the device,
// grid_v (B, G^3, 3); one env is B = 1.
extern "C" int plb_grid_op(const float* grid4, const float* poses, const float* softness,
                           float* grid_v, PrimTable table, int B, int G, float dx, float dt,
                           float g30x, float g30y, float g30z, float ground_friction, float vmax,
                           int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (table.k < 0 || table.k > PLB_MAX_PRIMS) return static_cast<int>(cudaErrorInvalidValue);
  const long long cells = static_cast<long long>(G) * G * G;
  const GridConsts k = {G, dx, dt, {g30x, g30y, g30z}, ground_friction, vmax};
  if (cells > 0 && B > 0) {
    const bool wide = B >= kFwdWideFrom, spheres = all_spheres(table);
    const dim3 grid(plb::blocks_for(cells, (wide ? kFwdTilesWide : kFwdTiles) * plb::kThreads), B);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (wide && spheres)
      grid_op_kernel<kFwdTilesWide, true><<<grid, plb::kThreads, 0, s>>>(grid4, poses, softness,
                                                                        grid_v, table, k);
    else if (wide)
      grid_op_kernel<kFwdTilesWide, false><<<grid, plb::kThreads, 0, s>>>(grid4, poses, softness,
                                                                         grid_v, table, k);
    else if (spheres)
      grid_op_kernel<kFwdTiles, true><<<grid, plb::kThreads, 0, s>>>(grid4, poses, softness,
                                                                    grid_v, table, k);
    else
      grid_op_kernel<kFwdTiles, false><<<grid, plb::kThreads, 0, s>>>(grid4, poses, softness,
                                                                     grid_v, table, k);
  }
  return static_cast<int>(cudaGetLastError());
}

// Per-env blocks of the backward: ceil(G^3 / kBwdCells).
constexpr int kBwdCells = kBwdTiles * plb::kThreads;

// partials: scratch of B x nblocks x k x 19 floats; done: B x (nblocks + 1)
// ints, zero (nblocks = ceil(G^3 / kBwdCells); the kernel leaves them zero).
// One stream: two launches that share them must not overlap.
extern "C" int plb_grid_op_bwd(const float* grid4, const float* poses, const float* softness,
                               const float* ct, float* dgrid4, float* dposes, float* partials,
                               int* done, PrimTable table, int B, int G, float dx,
                               float dt, float g30x, float g30y, float g30z,
                               float ground_friction, float vmax, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (table.k < 0 || table.k > PLB_MAX_PRIMS) return static_cast<int>(cudaErrorInvalidValue);
  const long long cells = static_cast<long long>(G) * G * G;
  if (cells <= 0 || B <= 0) return static_cast<int>(cudaGetLastError());
  const unsigned int nblocks = plb::blocks_for(cells, kBwdCells);
  if ((nblocks + 31) / 32 > static_cast<unsigned int>(kMaxFlagWords))
    return static_cast<int>(cudaErrorInvalidValue);
  const GridConsts k = {G, dx, dt, {g30x, g30y, g30z}, ground_friction, vmax};
  const dim3 grid(nblocks, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned int* d = reinterpret_cast<unsigned int*>(done);
  if (all_spheres(table))
    grid_op_bwd_kernel<true><<<grid, plb::kThreads, 0, s>>>(grid4, poses, softness, ct, dgrid4,
                                                           dposes, partials, d, table, k);
  else
    grid_op_bwd_kernel<false><<<grid, plb::kThreads, 0, s>>>(grid4, poses, softness, ct, dgrid4,
                                                            dposes, partials, d, table, k);
  return static_cast<int>(cudaGetLastError());
}
