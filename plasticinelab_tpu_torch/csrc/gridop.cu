// Grid update kernels, one thread per cell of the full G^3 grid: mass
// normalise, gravity, per-primitive SDF contact at poses f and f+1, walls,
// ground friction, velocity clamp.
//
// grid_op_kernel: port of the forward of plasticinelab_tpu/engine/
//   pallas_gridop.py (_fwd_kernel, K8), which runs plasticinelab_tpu/engine/
//   mpm.py:grid_op_core (:193-255) with the primitive math of primitives.py
//   (:29-246; primitives_cm.py is its component form). The order of
//   operations follows grid_op_core, including the 1e-30 ground-friction
//   tie-breakers (normal floats in f32). The inverse rotation uses the
//   renormalised conjugate quaternion, as primitives.inv_trans does.
// grid_op_bwd_kernel + grid_op_pose_reduce_kernel: port of pallas_gridop.py
//   _bwd_kernel (K8 backward, :97), which runs the reference's autodiff
//   (vjp) of grid_op_core inside the kernel. Hopper has no in-kernel
//   autodiff, so the adjoint is written by hand: each thread recomputes its
//   cell's forward and runs it backwards. The Jacobians of the 7 shapes' local SDF and normal with
//   respect to the local point (and the Chopsticks gap) come from the same
//   templated shape code instantiated on a forward-mode dual number with 4
//   tangents; the quaternion and position chain rule is written out. The
//   pose cotangents are reduced deterministically: per-block sums (blocks
//   with no contact write zeros without reducing), then one block per
//   (primitive, env) sums that env's block partials in a fixed order.
//
// grid4 (G^3, 4) [mom x, y, z, mass]; poses (k, 16) rows [pos_f 3, rot_f 4,
// gap_f, pos_f1 3, rot_f1 4, gap_f1]; out (G^3, 3). The pass reads 16 B and
// writes 12 B per cell, a few MB that stay in L2; the cost is the SDF,
// normal and contact arithmetic per primitive, in a thin shell around each.
//
// Both directions take B envs, grid4 (B, G^3, 4), each env with its own
// poses row block (B, k, 16) and its own softness from a (B,) device tensor;
// one env is B = 1. The forward runs one thread per (env, cell) of the flat
// grids. The backward launches a 2-D grid (blocks of one env's cells, env),
// so no block holds cells of two envs and each env's pose cotangents are
// summed in the order a B = 1 launch sums them. They also replace the
// batched grids of the same TPU kernels (pallas_gridop.py:205
// grid_op_fns_batched, K8-fwd-b :234 and K8-bwd-b :247).
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
  Dual r;
  r.v = a.v / b.v;
#pragma unroll
  for (int i = 0; i < 4; ++i) r.d[i] = (a.d[i] - r.v * b.d[i]) / b.v;
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
__device__ T local_sdf(const Prim& P, const Vec3<T>& p, const T& gap) {
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
__device__ Vec3<T> local_normal(const Prim& P, const Vec3<T>& p, const T& gap) {
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
struct PrimPose {
  const float *pos_f, *rot_f, *pos_f1, *rot_f1;
  float gap_f;
  float conj_f[4];  // conj(rot_f) / |rot_f|
};

__device__ __forceinline__ PrimPose prim_pose(const float* pose) {
  PrimPose pp;
  pp.pos_f = pose;
  pp.rot_f = pose + 3;
  pp.gap_f = pose[7];
  pp.pos_f1 = pose + 8;
  pp.rot_f1 = pose + 11;
  conj_normalized(pp.rot_f, pp.conj_f);
  return pp;
}

// What the contact response of one cell needs from the geometry: the
// distance and, where the contact condition holds, the normal; with DERIV
// also their Jacobians with respect to the local point and the gap.
struct Contact {
  V3 d0;           // gp - pos_f
  V3 local;        // conj_f applied to d0 (the collider's rest frame)
  float l;         // sphere: |d0|
  float dist;      // signed distance
  float influence;  // min(exp(-dist softness), 1)
  V3 nl;           // normal, local frame (non-spheres)
  V3 D;            // normal, world frame
  float sd[4];     // d dist / d (local x, y, z, gap)  [DERIV]
  float J[3][4];   // d nl_i / d (local x, y, z, gap)  [DERIV]
};

template <bool DERIV>
__device__ __forceinline__ bool contact_geometry(const Prim& P, const PrimPose& pp, V3 gp,
                                                 float softness, Contact& c) {
  c.d0 = {gp.x - pp.pos_f[0], gp.y - pp.pos_f[1], gp.z - pp.pos_f[2]};
  c.local = qrot(pp.conj_f, c.d0);
  const bool sphere = P.shape == kSphere;
  Vec3<Dual> p;
  Dual gap;
  if (sphere) {
    c.l = len3(c.d0.x, c.d0.y, c.d0.z);
    c.dist = c.l - P.radius;
  } else if (DERIV) {
    p = {seed(c.local.x, 0), seed(c.local.y, 1), seed(c.local.z, 2)};
    gap = seed(pp.gap_f, 3);
    const Dual sdf = local_sdf(P, p, gap);
    c.dist = sdf.v;
#pragma unroll
    for (int j = 0; j < 4; ++j) c.sd[j] = sdf.d[j];
  } else {
    c.dist = local_sdf(P, c.local, pp.gap_f);
  }
  c.influence = jmin(expf(-c.dist * softness), 1.0f);
  if (!((softness > 0.0f && c.influence > 0.1f) || c.dist <= 0.0f)) return false;
  if (sphere) {
    c.D = {c.d0.x / c.l, c.d0.y / c.l, c.d0.z / c.l};
    return true;
  }
  if (DERIV) {
    const Vec3<Dual> n = local_normal(P, p, gap);
    c.nl = {n.x.v, n.y.v, n.z.v};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      c.J[0][j] = n.x.d[j];
      c.J[1][j] = n.y.d[j];
      c.J[2][j] = n.z.d[j];
    }
  } else {
    c.nl = local_normal(P, c.local, pp.gap_f);
  }
  c.D = qrot(pp.rot_f, c.nl);
  return true;
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

// forward: v is left as it is where the contact condition does not hold
__device__ __forceinline__ void collide(const Prim& P, const PrimPose& pp, float softness,
                                        float inv_dt, V3 gp, V3& v) {
  Contact c;
  if (contact_geometry<false>(P, pp, gp, softness, c)) v = response_v(respond(P, pp, c, inv_dt, gp, v));
}

// backward of collide given the output's cotangent g (in/out: the input
// v's cotangent); adds the cell's pose cotangents to pg. False where the
// contact condition does not hold (then nothing changes).
__device__ bool collide_bwd(const Prim& P, const PrimPose& pp, float softness, float inv_dt, V3 gp,
                            V3 v, V3& g, float (&pg)[kPG]) {
  Contact c;
  if (!contact_geometry<true>(P, pp, gp, softness, c)) return false;
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
    // ts = t * max(num, 0) / tnorm, num = tnorm + nc * friction
    const float g_seff = g_ts.x * r.t.x + g_ts.y * r.t.y + g_ts.z * r.t.z;
    const float numc = jmax(0.0f, r.num);
    float g_tnorm = -g_seff * numc / (r.tnorm * r.tnorm);
    if (r.num >= 0.0f) {
      const float g_num = g_seff / r.tnorm;
      g_tnorm += g_num;
      g_nc += g_num * P.friction;
    }
    g_t.x += g_tnorm * r.t.x / r.tnorm;
    g_t.y += g_tnorm * r.t.y / r.tnorm;
    g_t.z += g_tnorm * r.t.z / r.tnorm;
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
  if (P.shape == kSphere) {
    // dist = |d0| - radius, D = d0 / |d0|
    const float l = c.l, dg = c.d0.x * g_D.x + c.d0.y * g_D.y + c.d0.z * g_D.z;
    const float l3 = l * l * l;
    g_d0 = {g_dist * c.d0.x / l + g_D.x / l - c.d0.x * dg / l3,
            g_dist * c.d0.y / l + g_D.y / l - c.d0.y * dg / l3,
            g_dist * c.d0.z / l + g_D.z / l - c.d0.z * dg / l3};
  } else {
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
  return true;
}

__device__ __forceinline__ Prim prim_of(const PrimTable& table, int i) {
  const float* pr = table.param[i];
  return {table.shape[i], pr[0], pr[1], pr[2], pr[3], pr[4], pr[5], pr[6], pr[7], pr[8]};
}

struct CellCtx {
  int c[3];
  float cf[3];
  V3 gp;
};

__device__ __forceinline__ CellCtx cell_ctx(long long cell, int G, float dx) {
  const long long GG = G;
  CellCtx x;
  x.c[0] = static_cast<int>(cell / (GG * GG));
  x.c[1] = static_cast<int>((cell / GG) % GG);
  x.c[2] = static_cast<int>(cell % GG);
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

// idx runs over (env, cell) of B envs' grids; grid4 and out are indexed by
// idx itself, since the envs' grids are contiguous.
__global__ void grid_op_kernel(const float* __restrict__ grid4, const float* __restrict__ poses,
                               const float* __restrict__ softness, float* __restrict__ out,
                               PrimTable table, GridConsts k, int B) {
  const long long GG = k.G;
  const long long cells = GG * GG * GG;
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= cells * B) return;
  const long long env = idx / cells;
  const long long cell = idx - env * cells;
  const float m = grid4[idx * 4 + 3];
  if (!(m > 1e-12f)) {
    // cells with no mass keep zero velocity
    out[idx * 3 + 0] = 0.0f;
    out[idx * 3 + 1] = 0.0f;
    out[idx * 3 + 2] = 0.0f;
    return;
  }
  const CellCtx x = cell_ctx(cell, k.G, k.dx);
  const float inv_m = 1.0f / m;
  V3 vv = {grid4[idx * 4 + 0] * inv_m + k.g30[0], grid4[idx * 4 + 1] * inv_m + k.g30[1],
           grid4[idx * 4 + 2] * inv_m + k.g30[2]};
  const float inv_dt = 1.0f / k.dt;
  const float soft = softness[env];
  const float* env_poses = poses + env * table.k * 16;
  for (int i = 0; i < table.k; ++i)
    collide(prim_of(table, i), prim_pose(env_poses + i * 16), soft, inv_dt, x.gp, vv);
  float v[3] = {vv.x, vv.y, vv.z};
#pragma unroll
  for (int d = 0; d < 3; ++d) wall_step(d, x, k.G, k.ground_friction, v);
  if (k.vmax > 0.0f) {
#pragma unroll
    for (int d = 0; d < 3; ++d) v[d] = jmin(jmax(v[d], -k.vmax), k.vmax);
  }
  out[idx * 3 + 0] = v[0];
  out[idx * 3 + 1] = v[1];
  out[idx * 3 + 2] = v[2];
}

// The adjoint of one cell: recomputes its forward, keeping the velocity
// entering each primitive and each wall step, then runs it backwards and
// writes d grid4. sink(i, hit, pg) takes the cell's pose cotangents of
// primitive i, last primitive first; every thread calls it table.k times,
// whether or not its cell is in the grid, has mass, or touches primitive i.
template <class Sink>
__device__ __forceinline__ void cell_bwd(const float* __restrict__ grid4,
                                         const float* __restrict__ poses,
                                         const float* __restrict__ ct, float* __restrict__ dgrid4,
                                         const PrimTable& table, const GridConsts& k,
                                         float softness, long long cell, Sink& sink) {
  const long long GG = k.G;
  const bool in_grid = cell < GG * GG * GG;
  const float m = in_grid ? grid4[cell * 4 + 3] : 0.0f;
  const bool active = m > 1e-12f;
  const CellCtx x = cell_ctx(in_grid ? cell : 0, k.G, k.dx);
  const float inv_m = active ? 1.0f / m : 0.0f;
  const float inv_dt = 1.0f / k.dt;

  float vin[PLB_MAX_PRIMS][3];
  float g[3] = {0.0f, 0.0f, 0.0f};
  if (active) {
    V3 vv = {grid4[cell * 4 + 0] * inv_m + k.g30[0], grid4[cell * 4 + 1] * inv_m + k.g30[1],
             grid4[cell * 4 + 2] * inv_m + k.g30[2]};
    for (int i = 0; i < table.k; ++i) {
      vin[i][0] = vv.x;
      vin[i][1] = vv.y;
      vin[i][2] = vv.z;
      collide(prim_of(table, i), prim_pose(poses + i * 16), softness, inv_dt, x.gp, vv);
    }
    float vwall[3][3];
    float v[3] = {vv.x, vv.y, vv.z};
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      vwall[d][0] = v[0];
      vwall[d][1] = v[1];
      vwall[d][2] = v[2];
      wall_step(d, x, k.G, k.ground_friction, v);
    }
    // the clamp passes the cotangent inside [-vmax, vmax]
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      g[d] = ct[cell * 3 + d];
      if (k.vmax > 0.0f && !(v[d] >= -k.vmax && v[d] <= k.vmax)) g[d] = 0.0f;
    }
#pragma unroll
    for (int d = 2; d >= 0; --d) wall_step_bwd(d, x, k.G, k.ground_friction, vwall[d], g);
  }
  for (int i = table.k - 1; i >= 0; --i) {
    float pg[kPG];
#pragma unroll
    for (int j = 0; j < kPG; ++j) pg[j] = 0.0f;
    bool hit = false;
    if (active) {
      V3 gv = {g[0], g[1], g[2]};
      hit = collide_bwd(prim_of(table, i), prim_pose(poses + i * 16), softness, inv_dt, x.gp,
                        V3{vin[i][0], vin[i][1], vin[i][2]}, gv, pg);
      g[0] = gv.x;
      g[1] = gv.y;
      g[2] = gv.z;
    }
    sink(i, hit, pg);
  }
  if (!in_grid) return;
  if (!active) {
#pragma unroll
    for (int s = 0; s < 4; ++s) dgrid4[cell * 4 + s] = 0.0f;
    return;
  }
  // v0_s = mom_s / m + gravity_s
  float gm = 0.0f;
#pragma unroll
  for (int s = 0; s < 3; ++s) {
    dgrid4[cell * 4 + s] = g[s] * inv_m;
    gm -= g[s] * grid4[cell * 4 + s] * inv_m * inv_m;
  }
  dgrid4[cell * 4 + 3] = gm;
}

// Sum of kPG values over the block in a fixed order; thread j < kPG ends up
// holding the block's sum of component j in sum_out.
__device__ __forceinline__ void block_sum(const float (&x)[kPG], float (*smem)[kPG],
                                          float& sum_out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < kPG; ++j) {
    float s = x[j];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
    if (lane == 0) smem[warp][j] = s;
  }
  __syncthreads();
  if (threadIdx.x < kPG) {
    float s = 0.0f;
    for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w) s += smem[w][threadIdx.x];
    sum_out = s;
  }
  __syncthreads();
}

// Writes the block's sum of each primitive's pose cotangents to its row of
// its env's partials (nblocks, k, kPG); a block where no cell touches the
// primitive writes zeros without reducing.
struct BlockSink {
  float* partials;
  float (*smem)[kPG];
  int k;
  __device__ __forceinline__ void operator()(int i, bool hit, const float (&pg)[kPG]) {
    float* part = partials + (static_cast<long long>(blockIdx.x) * k + i) * kPG;
    if (__syncthreads_or(hit)) {
      float s = 0.0f;
      block_sum(pg, smem, s);
      if (threadIdx.x < kPG) part[threadIdx.x] = s;
    } else if (threadIdx.x < kPG) {
      part[threadIdx.x] = 0.0f;
    }
  }
};

// Grid (blocks_for(G^3), B): block (x, env) holds cells of env alone;
// partials is (B, nblocks, k, kPG).
__global__ void grid_op_bwd_kernel(const float* __restrict__ grid4,
                                   const float* __restrict__ poses,
                                   const float* __restrict__ softness,
                                   const float* __restrict__ ct, float* __restrict__ dgrid4,
                                   float* __restrict__ partials, PrimTable table, GridConsts k) {
  __shared__ float smem[plb::kThreads / 32][kPG];
  const long long GG = k.G;
  const long long cells = GG * GG * GG;
  const long long env = blockIdx.y;
  BlockSink sink{partials + env * gridDim.x * table.k * kPG, smem, table.k};
  const long long cell = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  cell_bwd(grid4 + env * cells * 4, poses + env * table.k * 16, ct + env * cells * 3,
           dgrid4 + env * cells * 4, table, k, softness[env], cell, sink);
}

// One primitive's (16,) pose cotangent row from its summed kPG components:
// the renormalised conjugate's cotangent g_c maps back to rot_f through
// c = conj(q) / |q|: g_q = sign * (g_c - c (c . g_c)) / |q|.
__device__ __forceinline__ void pose_row(const float* tot, const float* q, float* out) {
  float c[4];
  conj_normalized(q, c);
  const float nq = sqrtf(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3]);
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
    out[3 + j] = tot[kRotF + j] + sign[j] * (gc[j] - c[j] * cg) / nq;
    out[11 + j] = tot[kRotF1 + j];
  }
  out[7] = tot[kGapF];
  out[15] = 0.0f;  // gap_f1 does not enter the grid update
}

// Grid (k, B), one block per (primitive, env): sums the env's per-block
// partials in a fixed order and writes its row of the (B, k, 16) pose
// cotangents.
__global__ void grid_op_pose_reduce_kernel(const float* __restrict__ partials,
                                           const float* __restrict__ poses,
                                           float* __restrict__ dposes, int nblocks, int k) {
  __shared__ float smem[plb::kThreads / 32][kPG];
  __shared__ float tot[kPG];
  const int i = blockIdx.x;
  const long long env = blockIdx.y;
  partials += env * nblocks * k * kPG;
  poses += env * k * 16;
  dposes += env * k * 16;
  float acc[kPG];
#pragma unroll
  for (int j = 0; j < kPG; ++j) acc[j] = 0.0f;
  for (int b = threadIdx.x; b < nblocks; b += blockDim.x) {
    const float* part = partials + (static_cast<long long>(b) * k + i) * kPG;
#pragma unroll
    for (int j = 0; j < kPG; ++j) acc[j] += part[j];
  }
  float s = 0.0f;
  block_sum(acc, smem, s);
  if (threadIdx.x < kPG) tot[threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.x == 0) pose_row(tot, poses + i * 16 + 3, dposes + i * 16);
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
  const long long total = static_cast<long long>(G) * G * G * B;
  const GridConsts k = {G, dx, dt, {g30x, g30y, g30z}, ground_friction, vmax};
  if (total > 0) {
    grid_op_kernel<<<plb::blocks_for(total), plb::kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(grid4, poses, softness, grid_v, table,
                                                          k, B);
  }
  return static_cast<int>(cudaGetLastError());
}

// partials: scratch of B x blocks_for(G^3) x k x 19 floats
extern "C" int plb_grid_op_bwd(const float* grid4, const float* poses, const float* softness,
                               const float* ct, float* dgrid4, float* dposes, float* partials,
                               PrimTable table, int B, int G, float dx, float dt, float g30x,
                               float g30y, float g30z, float ground_friction, float vmax,
                               int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (table.k < 0 || table.k > PLB_MAX_PRIMS) return static_cast<int>(cudaErrorInvalidValue);
  const long long cells = static_cast<long long>(G) * G * G;
  if (cells <= 0 || B <= 0) return static_cast<int>(cudaGetLastError());
  const GridConsts k = {G, dx, dt, {g30x, g30y, g30z}, ground_friction, vmax};
  const unsigned int nblocks = plb::blocks_for(cells);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  grid_op_bwd_kernel<<<dim3(nblocks, B), plb::kThreads, 0, s>>>(grid4, poses, softness, ct,
                                                                dgrid4, partials, table, k);
  err = cudaGetLastError();
  if (err != cudaSuccess || table.k == 0) return static_cast<int>(err);
  grid_op_pose_reduce_kernel<<<dim3(table.k, B), plb::kThreads, 0, s>>>(
      partials, poses, dposes, static_cast<int>(nblocks), table.k);
  return static_cast<int>(cudaGetLastError());
}
