// Particle stress kernels, one thread per particle, the chain in registers.
//
// stress_affine_kernel: F-update, 3x3 Jacobi SVD, von Mises return map,
//   stress and APIC affine. Port of plasticinelab_tpu/engine/pallas_stress.py
//   _fwd_kernel (K1), whose math is _forward_core (:70-194); every step of
//   forward_core below follows it in order.
// stress_affine_bwd_kernel: the hand-derived adjoint of the whole chain with
//   the damped-eigengap SVD cotangent. Port of pallas_stress.py _bwd_kernel
//   (K2, :222-330): it recomputes the forward from C and F (forward_core,
//   shared with K1) and applies the adjoint term by term.
// In/out are (n, 3, 3) row-major float32: 72 B in and out per particle, K2
// 144 B in. On the H100 one thread's dependent chain bounds them where a
// launch is a fraction of a wave (Move-v1's 10,000 particles), and the
// chain's instructions and the 36-byte-strided stores where it is many
// waves (the batched path's 320,000). So:
// - the chain is short: the Jacobi rotation's angle takes one approximate
//   reciprocal and two rsqrt (MUFU.RCP, MUFU.RSQ) instead of five IEEE
//   divisions and three square roots, then one Newton step makes it a
//   rotation to float32 rounding; the Gram-Schmidt norms take rsqrt; the
//   log, exp and every division of the return map, the stress and the
//   adjoint stay IEEE;
// - a block's outputs leave through shared memory, one contiguous slab per
//   array written 16 bytes a thread (the inputs are read straight: the L1
//   serves a warp's strided loads from the sectors its first load brought);
// - blocks are small, so that a launch of 10,000 particles reaches every SM.
#include "common.cuh"

namespace {

using plb::jmax;

// MUFU.RCP and MUFU.RSQ alone (relative error ~2^-23): the callers' arguments
// are normal numbers, so flushing subnormals changes nothing, and rounding
// moves a rotation's angle or a normalisation's length, not its result's
// orthogonality beyond float32 rounding.
__device__ __forceinline__ float rcp_approx(float x) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ float rsqrt_approx(float x) {
  float r;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

// One Jacobi rotation zeroing a[P][Q] of the symmetric matrix a (upper
// triangle used), accumulated into v (_forward_core :86-119). The angle is
// the reference's, t = atan2(2 apq, aqq - app) / 2, by the half-angle
// identities:
//   cos 2t, sin 2t from (aqq - app, 2 apq) scaled by a reciprocal of the
//   larger magnitude m (the scale cancels in the angle; m is clamped to the
//   normal range [2^-126, 2^126] so that the reciprocal is normal too, and
//   the rsqrt argument stays in [2^-46, 32]);
//   u = (1 + |cos 2t|) / 2 in [0.5, 1] is cos^2 t (cos 2t >= 0) or sin^2 t;
//   the larger of (c, s) is sqrt(u) = u rsqrt(u), the other
//   |sin 2t| / (2 sqrt(u)), stable where |cos 2t| ~ 1;
//   then (c, s) times k = (3 - c^2 - s^2) / 2, one Newton step of
//   rsqrt(c^2 + s^2) from 1: the approximate ops leave c^2 + s^2 off 1 by up
//   to ~5e-7, k brings it to float32 rounding. The angle may stay off by
//   ~1e-7: another rotation. A scale left in V instead accumulates over the
//   18 rotations into the singular values, and the backward's damped
//   eigengap multiplies it by up to 1 / eps^2 at near-equal ones (PERF.md:
//   K2 on a yielding cloud). The sign follows atan2's: where sin 2t underflows
// to 0 beside cos 2t = -1 the rotation is t = +-pi/2. fmaxf in place of the
// NaN-propagating jmax: a NaN in a reaches cos 2t or sin 2t all the same.
template <int P, int Q>
__device__ __forceinline__ void jacobi_rotation(float (&a)[3][3], float (&v)[3][3]) {
  constexpr int R = 3 - P - Q;
  constexpr int PR0 = P < R ? P : R, PR1 = P < R ? R : P;
  constexpr int QR0 = Q < R ? Q : R, QR1 = Q < R ? R : Q;
  const float app = a[P][P], aqq = a[Q][Q], apq = a[P][Q];
  const float y = 2.0f * apq;
  const float z = aqq - app;
  const bool ok = fabsf(y) > 0.0f;  // apq == 0: the identity rotation
  const float m = fminf(fmaxf(fmaxf(fabsf(y), fabsf(z)), 1.17549435e-38f), 8.50705917e37f);
  const float inv_m = rcp_approx(m);
  const float ym = y * inv_m;
  const float zm = z * inv_m;
  const float rinv = rsqrt_approx(fmaxf(ym * ym + zm * zm, 1e-30f));
  const float cos2t = zm * rinv;
  const float sin2t = ym * rinv;
  const float u = (1.0f + fabsf(cos2t)) * 0.5f;
  const float h = rsqrt_approx(u);
  const float big = u * h;
  const float hs = sin2t * 0.5f * h;  // sign(sin 2t) |sin 2t| / (2 sqrt(u))
  const bool pos = cos2t >= 0.0f;
  const float c0 = ok ? (pos ? big : fabsf(hs)) : 1.0f;
  const float s0 = ok ? (pos ? hs : copysignf(big, sin2t)) : 0.0f;
  const float k = fmaf(-0.5f, fmaf(c0, c0, s0 * s0), 1.5f);
  const float c = c0 * k, s = s0 * k;
  const float cc = c * c, ss = s * s, cs = c * s;
  const float apr = a[PR0][PR1], aqr = a[QR0][QR1];
  a[P][P] = cc * app - 2.0f * cs * apq + ss * aqq;
  a[Q][Q] = ss * app + 2.0f * cs * apq + cc * aqq;
  a[P][Q] = cs * (app - aqq) + (cc - ss) * apq;
  a[PR0][PR1] = c * apr - s * aqr;
  a[QR0][QR1] = s * apr + c * aqr;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float vip = v[i][P], viq = v[i][Q];
    v[i][P] = c * vip - s * viq;
    v[i][Q] = s * vip + c * viq;
  }
}

// Sort step of the descending 3-element sort network (_forward_core :124-136).
template <int I, int J>
__device__ __forceinline__ void cswap(float (&w)[3], float (&V)[3][3]) {
  const bool swap = w[I] < w[J];
  const float wi = swap ? w[J] : w[I];
  const float wj = swap ? w[I] : w[J];
  w[I] = wi;
  w[J] = wj;
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    const float vi = swap ? V[r][J] : V[r][I];
    const float vj = swap ? V[r][I] : V[r][J];
    V[r][I] = vi;
    V[r][J] = vj;
  }
}

__device__ __forceinline__ float dot3(const float (&x)[3], const float (&y)[3]) {
  return x[0] * y[0] + x[1] * y[1] + x[2] * y[2];
}

__device__ __forceinline__ void cross3(const float (&x)[3], const float (&y)[3], float (&o)[3]) {
  o[0] = x[1] * y[2] - x[2] * y[1];
  o[1] = x[2] * y[0] - x[0] * y[2];
  o[2] = x[0] * y[1] - x[1] * y[0];
}

// x / |x| where |x|^2 > 1e-16, else the fallback (_forward_core :145-149,
// which also takes rsqrt).
__device__ __forceinline__ void safe_normalize(const float (&x)[3], const float (&fb)[3],
                                               float (&o)[3]) {
  const float n2 = dot3(x, x);
  const bool okn = n2 > 1e-16f;
  const float inv = rsqrt_approx(okn ? n2 : 1.0f);
#pragma unroll
  for (int i = 0; i < 3; ++i) o[i] = okn ? x[i] * inv : fb[i];
}

// A = B C (mode 0), A = B C^T (mode 1), A = B^T C (mode 2)
template <int MODE>
__device__ __forceinline__ void mm3(const float (&B)[3][3], const float (&C)[3][3],
                                    float (&A)[3][3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      float s = 0.0f;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const float b = MODE == 2 ? B[k][i] : B[i][k];
        const float c = MODE == 1 ? C[j][k] : C[k][j];
        s += b * c;
      }
      A[i][j] = s;
    }
}

// Every forward intermediate the adjoint needs (_forward_core's dict).
struct StressFwd {
  float Ft[3][3], U[3][3], V[3][3], sig[3], sc[3], eh[3], f[3], nF[3][3];
  float ehn, J;
  bool yields;
};

// cy = yield_stress / (2 mu), computed once on the host.
__device__ __forceinline__ void forward_core(const float (&C)[3][3], const float (&F)[3][3],
                                             float dt, float cy, StressFwd& o) {
  // Ft = (I + dt C) F
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      float s = 0.0f;
#pragma unroll
      for (int k = 0; k < 3; ++k) s += ((i == k ? 1.0f : 0.0f) + dt * C[i][k]) * F[k][j];
      o.Ft[i][j] = s;
    }

  // Jacobi eigendecomposition of A = Ft^T Ft
  float a[3][3];
  float(&V)[3][3] = o.V;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      a[i][j] = o.Ft[0][i] * o.Ft[0][j] + o.Ft[1][i] * o.Ft[1][j] + o.Ft[2][i] * o.Ft[2][j];
      V[i][j] = i == j ? 1.0f : 0.0f;
    }
#pragma unroll
  for (int sweep = 0; sweep < 6; ++sweep) {
    jacobi_rotation<0, 1>(a, V);
    jacobi_rotation<0, 2>(a, V);
    jacobi_rotation<1, 2>(a, V);
  }
  float w[3] = {a[0][0], a[1][1], a[2][2]};
  cswap<0, 1>(w, V);
  cswap<0, 2>(w, V);
  cswap<1, 2>(w, V);

  // det(V) = +1
  {
    const float c0[3] = {V[0][0], V[1][0], V[2][0]};
    const float c1[3] = {V[0][1], V[1][1], V[2][1]};
    const float c2[3] = {V[0][2], V[1][2], V[2][2]};
    float cr[3];
    cross3(c0, c1, cr);
    const float flip = dot3(cr, c2) < 0.0f ? -1.0f : 1.0f;
#pragma unroll
    for (int r = 0; r < 3; ++r) V[r][2] *= flip;
  }

  // U by Gram-Schmidt of the columns of Ft V
  float FV[3][3];
  mm3<0>(o.Ft, V, FV);
  const float e0[3] = {1.0f, 0.0f, 0.0f}, e1[3] = {0.0f, 1.0f, 0.0f}, e2[3] = {0.0f, 0.0f, 1.0f};
  const float fv0[3] = {FV[0][0], FV[1][0], FV[2][0]};
  float u0[3], u1[3], u2[3];
  safe_normalize(fv0, e0, u0);
  float raw1[3] = {FV[0][1], FV[1][1], FV[2][1]};
  const float d01 = dot3(raw1, u0);
#pragma unroll
  for (int i = 0; i < 3; ++i) raw1[i] = raw1[i] - d01 * u0[i];
  const bool near = fabsf(u0[1]) < 0.9f;
  float alt[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) alt[i] = near ? e1[i] : e2[i];
  const float dalt = dot3(alt, u0);
#pragma unroll
  for (int i = 0; i < 3; ++i) alt[i] = alt[i] - dalt * u0[i];
  float alt_n[3];
  safe_normalize(alt, e1, alt_n);
  safe_normalize(raw1, alt_n, u1);
  cross3(u0, u1, u2);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    o.U[i][0] = u0[i];
    o.U[i][1] = u1[i];
    o.U[i][2] = u2[i];
  }
#pragma unroll
  for (int j = 0; j < 3; ++j)
    o.sig[j] = FV[0][j] * o.U[0][j] + FV[1][j] * o.U[1][j] + FV[2][j] * o.U[2][j];

  // von Mises return mapping
  float eps[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    o.sc[k] = jmax(o.sig[k], 0.05f);
    eps[k] = logf(o.sc[k]);
  }
  const float mean = (eps[0] + eps[1] + eps[2]) / 3.0f;
#pragma unroll
  for (int k = 0; k < 3; ++k) o.eh[k] = eps[k] - mean;
  o.ehn = sqrtf(o.eh[0] * o.eh[0] + o.eh[1] * o.eh[1] + o.eh[2] * o.eh[2] + 1e-8f);
  const float dg = o.ehn - cy;
  o.yields = dg > 0.0f;
  const float fac = dg / o.ehn;
#pragma unroll
  for (int k = 0; k < 3; ++k) o.f[k] = expf(eps[k] - fac * o.eh[k]);
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float fvm = o.U[i][0] * o.f[0] * V[j][0] + o.U[i][1] * o.f[1] * V[j][1] +
                        o.U[i][2] * o.f[2] * V[j][2];
      o.nF[i][j] = o.yields ? fvm : o.Ft[i][j];
    }
  float cr[3];
  cross3(o.nF[0], o.nF[1], cr);
  o.J = dot3(cr, o.nF[2]);
}

__device__ __forceinline__ void load33(const float* __restrict__ g, long long p, float (&M)[3][3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) M[i][j] = g[p * 9 + i * 3 + j];
}

// Launch shapes: threads per block, and the least blocks per SM, which caps
// the registers (K1 at 64 a thread, K2 at 128; neither spills). 10,000
// particles make 157 blocks of K1 and 79 of K2.
constexpr int kFwdThreads = 64, kFwdMinBlocks = 16;
constexpr int kBwdThreads = 128, kBwdMinBlocks = 4;

template <int THREADS, int MIN_BLOCKS>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
    stress_affine_kernel(const float* __restrict__ Cg, const float* __restrict__ Fg,
                         float* __restrict__ newFg, float* __restrict__ affg, long long n,
                         float dt, float mu, float lam, float cy, float coeff, float p_mass) {
  // newF and affine out through shared memory; C and F straight in
  __shared__ __align__(16) float sA[THREADS * 9], sN[THREADS * 9];
  const long long p0 = static_cast<long long>(blockIdx.x) * THREADS;
  const int rows = static_cast<int>(n - p0 < THREADS ? n - p0 : THREADS);
  const int t = threadIdx.x;
  if (t < rows) {
    float C[3][3], F[3][3];
    load33(Cg, p0 + t, C);
    load33(Fg, p0 + t, F);
    StressFwd o;
    forward_core(C, F, dt, cy, o);

    // stress 2 mu (F - R) F^T + lam J (J - 1) I, scaled, plus p_mass C
    const float lamJ = lam * o.J * (o.J - 1.0f);
    float FmR[3][3];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j)
        FmR[i][j] = o.nF[i][j] -
                    (o.U[i][0] * o.V[j][0] + o.U[i][1] * o.V[j][1] + o.U[i][2] * o.V[j][2]);
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const float S = FmR[i][0] * o.nF[j][0] + FmR[i][1] * o.nF[j][1] + FmR[i][2] * o.nF[j][2];
        float val = 2.0f * mu * S + (i == j ? lamJ : 0.0f);
        sA[t * 9 + i * 3 + j] = coeff * val + p_mass * C[i][j];
        sN[t * 9 + i * 3 + j] = o.nF[i][j];
      }
  }
  __syncthreads();
  plb::store_rows<9>(affg, p0, rows, sA);
  plb::store_rows<9>(newFg, p0, rows, sN);
}

// Inverse eigengap of the SVD backward (svd3.py:211-220): 0 = the
// reference's 1/clamp(gap, 1e-6), 1 = damped gap / (gap^2 + eps^2), 2 = zero.
__device__ __forceinline__ float inv_gap(float gap, int mode, float eps) {
  if (mode == 0) {
    const float c = gap >= 0.0f ? jmax(gap, 1e-6f) : plb::jmin(gap, -1e-6f);
    return 1.0f / c;
  }
  if (mode == 1) return gap / (gap * gap + eps * eps);
  return 0.0f;
}

template <int THREADS, int MIN_BLOCKS>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
    stress_affine_bwd_kernel(const float* __restrict__ Cg, const float* __restrict__ Fg,
                             const float* __restrict__ gNFg, const float* __restrict__ gAffg,
                             float* __restrict__ gCg, float* __restrict__ gFg, long long n,
                             float dt, float mu, float lam, float cy, float coeff, float p_mass,
                             int gap_mode, float gap_eps) {
  // gC and gF out through shared memory; the inputs straight in
  __shared__ __align__(16) float sC[THREADS * 9], sF[THREADS * 9];
  const long long p0 = static_cast<long long>(blockIdx.x) * THREADS;
  const int rows = static_cast<int>(n - p0 < THREADS ? n - p0 : THREADS);
  const int t = threadIdx.x;
  if (t < rows) {
    const long long p = p0 + t;
    float C[3][3], F[3][3], gNF[3][3], gAff[3][3];
    load33(Cg, p, C);
    load33(Fg, p, F);
    StressFwd o;
    forward_core(C, F, dt, cy, o);
    load33(gNFg, p, gNF);
    load33(gAffg, p, gAff);
    const float(&U)[3][3] = o.U;
    const float(&V)[3][3] = o.V;

    // ---- stress / affine adjoint ----
    float gS[3][3];
    float trg = 0.0f;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
      for (int j = 0; j < 3; ++j) gS[i][j] = 2.0f * mu * coeff * gAff[i][j];
      trg += coeff * gAff[i][i];
    }
    const float gJ = lam * (2.0f * o.J - 1.0f) * trg;
    // S = (newF - R) newF^T
    float FmR[3][3];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j)
        FmR[i][j] = o.nF[i][j] - (U[i][0] * V[j][0] + U[i][1] * V[j][1] + U[i][2] * V[j][2]);
    float gS_nF[3][3], gSt_FmR[3][3];
    mm3<0>(gS, o.nF, gS_nF);
    mm3<2>(gS, FmR, gSt_FmR);
    // cofactor of newF: rows are cross products of the other two rows
    float cof[3][3];
    cross3(o.nF[1], o.nF[2], cof[0]);
    cross3(o.nF[2], o.nF[0], cof[1]);
    cross3(o.nF[0], o.nF[1], cof[2]);
    float gNewF[3][3], gR[3][3];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        gNewF[i][j] = gNF[i][j] + gS_nF[i][j] + gSt_FmR[i][j] + gJ * cof[i][j];
        gR[i][j] = -gS_nF[i][j];
      }

    // ---- von Mises adjoint (yielding lanes) ----
    float gNFV[3][3], gNFtU[3][3];
    mm3<0>(gNewF, V, gNFV);
    mm3<2>(gNewF, U, gNFtU);
    // gep_k = f_k (U^T gNewF V)_kk = f_k sum_i (gNewF^T U)_ik V_ik
    float gep[3];
#pragma unroll
    for (int k = 0; k < 3; ++k)
      gep[k] = (gNFtU[0][k] * V[0][k] + gNFtU[1][k] * V[1][k] + gNFtU[2][k] * V[2][k]) * o.f[k];
    // eps_p = mean + (cy / ehn) eh
    const float sum_gep = gep[0] + gep[1] + gep[2];
    const float inv_ehn = 1.0f / o.ehn;
    const float dot_eh_gep = o.eh[0] * gep[0] + o.eh[1] * gep[1] + o.eh[2] * gep[2];
    const float proj = dot_eh_gep * inv_ehn * inv_ehn;
    float geh[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) geh[k] = cy * inv_ehn * (gep[k] - o.eh[k] * proj);
    const float mean_geh = (geh[0] + geh[1] + geh[2]) / 3.0f;
    const float mean_gep = sum_gep / 3.0f;
    float gsig[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float geps = geh[k] - mean_geh + mean_gep;
      // eps = log(max(sig, 0.05)): no gradient below the clamp
      const float gsig_vm = o.sig[k] > 0.05f ? geps / o.sc[k] : 0.0f;
      gsig[k] = o.yields ? gsig_vm : 0.0f;
    }
    // the R path flows in every lane
    float gR_V[3][3], gRt_U[3][3], gU[3][3], gV[3][3];
    mm3<0>(gR, V, gR_V);
    mm3<2>(gR, U, gRt_U);
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        gU[i][j] = (o.yields ? gNFV[i][j] * o.f[j] : 0.0f) + gR_V[i][j];
        gV[i][j] = (o.yields ? gNFtU[i][j] * o.f[j] : 0.0f) + gRt_U[i][j];
      }

    // ---- SVD adjoint, damped eigengap (svd3.py:205-235) ----
    float s2[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) s2[k] = o.sig[k] * o.sig[k];
    float UtgU[3][3], VtgV[3][3];
    mm3<2>(U, gU, UtgU);
    mm3<2>(V, gV, VtgV);
    // Fm[i][j] = inv_gap(s2[j] - s2[i]); the damped form is odd in the gap,
    // so its lower triangle is the upper one negated (bit for bit)
    float Fm[3][3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      Fm[i][i] = 0.0f;
#pragma unroll
      for (int j = i + 1; j < 3; ++j) {
        Fm[i][j] = inv_gap(s2[j] - s2[i], gap_mode, gap_eps);
        Fm[j][i] = gap_mode == 1 ? -Fm[i][j] : inv_gap(s2[i] - s2[j], gap_mode, gap_eps);
      }
    }
    float mid[3][3];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const float inner_u = Fm[i][j] * (UtgU[i][j] - UtgU[j][i]);
        const float inner_v = Fm[i][j] * (VtgV[i][j] - VtgV[j][i]);
        mid[i][j] = inner_u * o.sig[j] + o.sig[i] * inner_v + (i == j ? gsig[i] : 0.0f);
      }
    float Umid[3][3], gFt[3][3];
    mm3<0>(U, mid, Umid);
    mm3<1>(Umid, V, gFt);
    // non-yielding lanes route gNewF straight to Ft
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) gFt[i][j] += o.yields ? 0.0f : gNewF[i][j];

    // ---- Ft = (I + dt C) F adjoint ----
    float gFtFt[3][3];
    mm3<1>(gFt, F, gFtFt);  // gFt F^T
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        float gf = 0.0f;  // ((I + dt C)^T gFt)_ij
#pragma unroll
        for (int k = 0; k < 3; ++k) gf += ((k == i ? 1.0f : 0.0f) + dt * C[k][i]) * gFt[k][j];
        sC[t * 9 + i * 3 + j] = p_mass * gAff[i][j] + dt * gFtFt[i][j];
        sF[t * 9 + i * 3 + j] = gf;
      }
  }
  __syncthreads();
  plb::store_rows<9>(gCg, p0, rows, sC);
  plb::store_rows<9>(gFg, p0, rows, sF);
}

}  // namespace

extern "C" int plb_stress_affine(const float* C, const float* F, float* newF, float* affine,
                                 long long n, float dt, float mu, float lam, float ys,
                                 float coeff, float p_mass, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n > 0) {
    stress_affine_kernel<kFwdThreads, kFwdMinBlocks>
        <<<plb::blocks_for(n, kFwdThreads), kFwdThreads, 0, static_cast<cudaStream_t>(stream)>>>(
            C, F, newF, affine, n, dt, mu, lam, ys / (2.0f * mu), coeff, p_mass);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int plb_stress_affine_bwd(const float* C, const float* F, const float* gNewF,
                                     const float* gAffine, float* gC, float* gF, long long n,
                                     float dt, float mu, float lam, float ys, float coeff,
                                     float p_mass, int gap_mode, float gap_eps, int device,
                                     void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (gap_mode < 0 || gap_mode > 2) return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0) {
    stress_affine_bwd_kernel<kBwdThreads, kBwdMinBlocks>
        <<<plb::blocks_for(n, kBwdThreads), kBwdThreads, 0, static_cast<cudaStream_t>(stream)>>>(
            C, F, gNewF, gAffine, gC, gF, n, dt, mu, lam, ys / (2.0f * mu), coeff, p_mass,
            gap_mode, gap_eps);
  }
  return static_cast<int>(cudaGetLastError());
}
