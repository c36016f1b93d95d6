// Device code shared by the solver kernels (pose_lm.cu, local_ba.cu): the
// pinhole stereo reprojection with its Jacobian (solver/factors.py
// reproj_residuals, geom/camera.py project_stereo and project_stereo_jac)
// and the SE(3) exponential of geom/lie.py, each written to round and to
// carry a non-finite value the way the PyTorch expressions do.
#pragma once

#include <cuda_runtime.h>

namespace tc2li {

constexpr float kChi2Mono = 5.991f;     // solver/factors.py CHI2_MONO
constexpr float kChi2Stereo = 7.815f;   // CHI2_STEREO
constexpr float kEps = 5e-3f;           // geom/lie.py _EPS: Taylor branches below it

struct Cam {
  float fx, fy, cx, cy, bf;
};

__device__ __forceinline__ float z_safe(float z) { return fabsf(z) < 1e-9f ? 1e-9f : z; }

// One observation of the world point (x, y, zw) from the pose T (row-major
// 4x4, the top three rows read): the camera point Xc, the residual
// r = (u, v, u_r) - uv with its third row 0 for mono, and a = d(u, v, u_r)/dXc
// with its mono row 0 (selected, not multiplied, as the PyTorch where).
struct Reproj {
  float xc, yc, zc;
  float r[3];
  float a[3][3];
};

__device__ __forceinline__ Reproj reproject(const float* T, float x, float y, float zw,
                                            const float* uv, bool st, const Cam& cam) {
  Reproj o;
  o.xc = T[0] * x + T[1] * y + T[2] * zw + T[3];
  o.yc = T[4] * x + T[5] * y + T[6] * zw + T[7];
  o.zc = T[8] * x + T[9] * y + T[10] * zw + T[11];
  const float z = z_safe(o.zc);
  const float u = cam.fx * o.xc / z + cam.cx;
  const float v = cam.fy * o.yc / z + cam.cy;
  o.r[0] = u - uv[0];
  o.r[1] = v - uv[1];
  o.r[2] = st ? (u - cam.bf / z) - uv[2] : 0.f;
  const float iz = 1.f / z;
  const float iz2 = iz * iz;
  o.a[0][0] = cam.fx * iz;
  o.a[0][1] = 0.f;
  o.a[0][2] = -cam.fx * o.xc * iz2;
  o.a[1][0] = 0.f;
  o.a[1][1] = cam.fy * iz;
  o.a[1][2] = -cam.fy * o.yc * iz2;
  o.a[2][0] = st ? cam.fx * iz : 0.f;
  o.a[2][1] = 0.f;
  o.a[2][2] = st ? (-cam.fx * o.xc + cam.bf) * iz2 : 0.f;
  return o;
}

// J = a [I | -hat(Xc)], the zeros of [I | -hat(Xc)] multiplied in as in the
// PyTorch product, so that a non-finite entry of `a` spreads the same way.
__device__ __forceinline__ void pose_jacobian(const Reproj& o, float J[3][6]) {
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    J[k][0] = o.a[k][0];
    J[k][1] = o.a[k][1];
    J[k][2] = o.a[k][2];
    J[k][3] = o.a[k][0] * 0.f + o.a[k][1] * (-o.zc) + o.a[k][2] * o.yc;
    J[k][4] = o.a[k][0] * o.zc + o.a[k][1] * 0.f + o.a[k][2] * (-o.xc);
    J[k][5] = o.a[k][0] * (-o.yc) + o.a[k][1] * o.xc + o.a[k][2] * 0.f;
  }
}

// Huber weight of factors.huber_weight; a NaN chi2 stays NaN through the
// clamp, as torch.clamp
__device__ __forceinline__ float huber(float chi2, float thr) {
  return chi2 <= thr ? 1.f : sqrtf(thr / (chi2 < 1e-12f ? 1e-12f : chi2));
}

__device__ __forceinline__ float sinc(float x) {
  const float x2 = x * x;
  return fabsf(x) < kEps ? 1.f - x2 / 6.f + x2 * x2 / 120.f : sinf(x) / x;
}

__device__ __forceinline__ float cosc(float x) {
  const float x2 = x * x;
  return fabsf(x) < kEps ? 0.5f - x2 / 24.f + x2 * x2 / 720.f : (1.f - cosf(x)) / (x * x);
}

__device__ __forceinline__ float sinc3(float x) {
  const float x2 = x * x;
  return fabsf(x) < kEps ? 1.f / 6.f - x2 / 120.f + x2 * x2 / 5040.f
                         : (x - sinf(x)) / (x * x * x);
}

// se3_exp(xi) for xi = (rho, phi) (geom/lie.py se3_exp): the coefficients,
// then one row of the 4x4 at a time, so that one thread can take the whole
// product (se3_exp_left) or a lane one entry of it, with the same arithmetic.
struct Se3Exp {
  float rho[3];
  float W[3][3];   // hat(phi)
  float sa, ca, s3;
};

__device__ __forceinline__ Se3Exp se3_exp_coef(const float* xi) {
  Se3Exp e;
  const float p0 = xi[3], p1 = xi[4], p2 = xi[5];
  float th2 = p0 * p0 + p1 * p1 + p2 * p2;
  th2 = th2 < 1e-24f ? 1e-24f : th2;
  const float th = sqrtf(th2);
  e.sa = sinc(th);
  e.ca = cosc(th);
  e.s3 = sinc3(th);
  e.rho[0] = xi[0];
  e.rho[1] = xi[1];
  e.rho[2] = xi[2];
  e.W[0][0] = 0.f; e.W[0][1] = -p2; e.W[0][2] = p1;
  e.W[1][0] = p2; e.W[1][1] = 0.f; e.W[1][2] = -p0;
  e.W[2][0] = -p1; e.W[2][1] = p0; e.W[2][2] = 0.f;
  return e;
}

// row i of exp(xi) = [[R, V rho], [0, 1]]
__device__ __forceinline__ void se3_exp_row(const Se3Exp& e, int i, float E[4]) {
  if (i == 3) {
    E[0] = E[1] = E[2] = 0.f;
    E[3] = 1.f;
    return;
  }
  float V[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const float W2 = e.W[i][0] * e.W[0][j] + e.W[i][1] * e.W[1][j] + e.W[i][2] * e.W[2][j];
    const float I = i == j ? 1.f : 0.f;
    E[j] = I + e.sa * e.W[i][j] + e.ca * W2;
    V[j] = I + e.ca * e.W[i][j] + e.s3 * W2;
  }
  E[3] = V[0] * e.rho[0] + V[1] * e.rho[1] + V[2] * e.rho[2];
}

// entry (i, j) of se3_exp(xi) T, T row-major 4x4
__device__ __forceinline__ float se3_exp_left_entry(const Se3Exp& e, const float* T, int i,
                                                    int j) {
  float E[4];
  se3_exp_row(e, i, E);
  return E[0] * T[j] + E[1] * T[4 + j] + E[2] * T[8 + j] + E[3] * T[12 + j];
}

// Tn = se3_exp(xi) T; T and Tn row-major 4x4.
__device__ __forceinline__ void se3_exp_left(const float* xi, const float* T, float* Tn) {
  const Se3Exp e = se3_exp_coef(xi);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) Tn[4 * i + j] = se3_exp_left_entry(e, T, i, j);
}

}  // namespace tc2li
