// Particle stress kernel: F-update, 3x3 Jacobi SVD, von Mises return map,
// stress and APIC affine, one thread per particle, all in registers.
//
// Port of plasticinelab_tpu/engine/pallas_stress.py:_fwd_kernel (K1), whose
// math is _forward_core (:70-194); every step below follows it in order.
// In/out are (n, 3, 3) row-major float32.
#include "common.cuh"

namespace {

using plb::jmax;

// One Jacobi rotation zeroing a[P][Q] of the symmetric matrix a (upper
// triangle used), accumulated into v (_forward_core :86-119).
template <int P, int Q>
__device__ __forceinline__ void jacobi_rotation(float (&a)[3][3], float (&v)[3][3]) {
  constexpr int R = 3 - P - Q;
  constexpr int PR0 = P < R ? P : R, PR1 = P < R ? R : P;
  constexpr int QR0 = Q < R ? Q : R, QR1 = Q < R ? R : Q;
  const float app = a[P][P], aqq = a[Q][Q], apq = a[P][Q];
  const float y = 2.0f * apq;
  const float z = aqq - app;
  // scale-invariant hypot normalization
  const float mm = jmax(fabsf(y), fabsf(z));
  const bool ok = fabsf(y) > 0.0f;
  const float mm_safe = mm > 0.0f ? mm : 1.0f;
  const float ym = y / mm_safe;
  const float zm = z / mm_safe;
  const float rinv = 1.0f / sqrtf(jmax(ym * ym + zm * zm, 1e-30f));
  const float cos2t = zm * rinv;
  const float sin2t = ym * rinv;
  // stable half-angles
  const float c_raw = sqrtf(jmax((1.0f + cos2t) * 0.5f, 1e-30f));
  const float s_raw = sqrtf(jmax((1.0f - cos2t) * 0.5f, 1e-30f));
  const bool pos_b = cos2t >= 0.0f;
  const float sgn = sin2t > 0.0f ? 1.0f : (sin2t < 0.0f ? -1.0f : 0.0f);
  float c = pos_b ? c_raw : fabsf(sin2t) * 0.5f / s_raw;
  float s = pos_b ? sin2t * 0.5f / c_raw : sgn * s_raw;
  c = ok ? c : 1.0f;
  s = ok ? s : 0.0f;
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

// x / |x| where |x|^2 > 1e-16, else the fallback (_forward_core :145-149).
__device__ __forceinline__ void safe_normalize(const float (&x)[3], const float (&fb)[3],
                                               float (&o)[3]) {
  const float n2 = dot3(x, x);
  const bool okn = n2 > 1e-16f;
  const float inv = 1.0f / sqrtf(okn ? n2 : 1.0f);
#pragma unroll
  for (int i = 0; i < 3; ++i) o[i] = okn ? x[i] * inv : fb[i];
}

__global__ void stress_affine_kernel(const float* __restrict__ Cg, const float* __restrict__ Fg,
                                     float* __restrict__ newFg, float* __restrict__ affg,
                                     long long n, float dt, float mu, float lam, float ys,
                                     float coeff, float p_mass) {
  const long long p = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (p >= n) return;
  float C[3][3], F[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      C[i][j] = Cg[p * 9 + i * 3 + j];
      F[i][j] = Fg[p * 9 + i * 3 + j];
    }

  // Ft = (I + dt C) F
  float Ft[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      float s = 0.0f;
#pragma unroll
      for (int k = 0; k < 3; ++k) s += ((i == k ? 1.0f : 0.0f) + dt * C[i][k]) * F[k][j];
      Ft[i][j] = s;
    }

  // Jacobi eigendecomposition of A = Ft^T Ft
  float a[3][3], V[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      a[i][j] = Ft[0][i] * Ft[0][j] + Ft[1][i] * Ft[1][j] + Ft[2][i] * Ft[2][j];
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
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) FV[i][j] = Ft[i][0] * V[0][j] + Ft[i][1] * V[1][j] + Ft[i][2] * V[2][j];
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
  float U[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    U[i][0] = u0[i];
    U[i][1] = u1[i];
    U[i][2] = u2[i];
  }
  float sig[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) sig[j] = FV[0][j] * U[0][j] + FV[1][j] * U[1][j] + FV[2][j] * U[2][j];

  // von Mises return mapping
  float eps[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) eps[k] = logf(jmax(sig[k], 0.05f));
  const float mean = (eps[0] + eps[1] + eps[2]) / 3.0f;
  float eh[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) eh[k] = eps[k] - mean;
  const float ehn = sqrtf(eh[0] * eh[0] + eh[1] * eh[1] + eh[2] * eh[2] + 1e-8f);
  const float cy = ys / (2.0f * mu);
  const float dg = ehn - cy;
  const bool yields = dg > 0.0f;
  const float fac = dg / ehn;
  float f[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) f[k] = expf(eps[k] - fac * eh[k]);
  float nF[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float fvm = U[i][0] * f[0] * V[j][0] + U[i][1] * f[1] * V[j][1] + U[i][2] * f[2] * V[j][2];
      nF[i][j] = yields ? fvm : Ft[i][j];
    }

  // stress 2 mu (F - R) F^T + lam J (J - 1) I, scaled, plus p_mass C
  float cr[3];
  cross3(nF[0], nF[1], cr);
  const float J = dot3(cr, nF[2]);
  const float lamJ = lam * J * (J - 1.0f);
  float FmR[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      FmR[i][j] = nF[i][j] - (U[i][0] * V[j][0] + U[i][1] * V[j][1] + U[i][2] * V[j][2]);
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float S = FmR[i][0] * nF[j][0] + FmR[i][1] * nF[j][1] + FmR[i][2] * nF[j][2];
      float val = 2.0f * mu * S + (i == j ? lamJ : 0.0f);
      val = coeff * val + p_mass * C[i][j];
      affg[p * 9 + i * 3 + j] = val;
      newFg[p * 9 + i * 3 + j] = nF[i][j];
    }
}

}  // namespace

extern "C" int plb_stress_affine(const float* C, const float* F, float* newF, float* affine,
                                 long long n, float dt, float mu, float lam, float ys,
                                 float coeff, float p_mass, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n > 0) {
    stress_affine_kernel<<<plb::blocks_for(n), plb::kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(C, F, newF, affine, n, dt, mu,
                                                                lam, ys, coeff, p_mass);
  }
  return static_cast<int>(cudaGetLastError());
}
