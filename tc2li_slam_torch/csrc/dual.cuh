// Forward-mode dual numbers (a value and one tangent, torch.func.jacfwd's
// rules) and geom/lie.py's SO(3) chains over them, shared by the kernels that
// take a Jacobian as jacfwd takes it (inertial_init.cu, pose_graph.cu): a
// thread carries one tangent through the expression as PyTorch writes it,
// Taylor branches and clamps included (a branch is taken by the value; a
// clamp passes the tangent where the value lies inside it, bounds included,
// as torch's clamp does).
#pragma once

#include <cuda_runtime.h>

#include "imu_factor.cuh"   // kEps, kPi

namespace {

// ---------------------------------------------------------------------------
// forward-mode dual numbers (torch.func.jacfwd's rules)
// ---------------------------------------------------------------------------

struct Dual {
  double v, d;
};

__device__ __forceinline__ Dual operator+(Dual a, Dual b) { return {a.v + b.v, a.d + b.d}; }
__device__ __forceinline__ Dual operator-(Dual a, Dual b) { return {a.v - b.v, a.d - b.d}; }
__device__ __forceinline__ Dual operator-(Dual a) { return {-a.v, -a.d}; }
__device__ __forceinline__ Dual operator*(Dual a, Dual b) { return {a.v * b.v, a.d * b.v + a.v * b.d}; }
__device__ __forceinline__ Dual operator/(Dual a, Dual b) {
  const double q = a.v / b.v;
  return {q, (a.d - b.d * q) / b.v};
}
__device__ __forceinline__ Dual operator+(Dual a, double b) { return {a.v + b, a.d}; }
__device__ __forceinline__ Dual operator+(double a, Dual b) { return {a + b.v, b.d}; }
__device__ __forceinline__ Dual operator-(Dual a, double b) { return {a.v - b, a.d}; }
__device__ __forceinline__ Dual operator-(double a, Dual b) { return {a - b.v, -b.d}; }
__device__ __forceinline__ Dual operator*(Dual a, double b) { return {a.v * b, a.d * b}; }
__device__ __forceinline__ Dual operator*(double a, Dual b) { return {a * b.v, a * b.d}; }
__device__ __forceinline__ Dual operator/(double a, Dual b) {
  const double q = a / b.v;
  return {q, -b.d * q / b.v};
}
__device__ __forceinline__ Dual operator/(Dual a, double b) { return {a.v / b, a.d / b}; }

__device__ __forceinline__ double val(double a) { return a; }
__device__ __forceinline__ double val(Dual a) { return a.v; }
__device__ __forceinline__ double dsin(double a) { return sin(a); }
__device__ __forceinline__ Dual dsin(Dual a) {
  double s, c;
  sincos(a.v, &s, &c);
  return {s, a.d * c};
}
__device__ __forceinline__ double dcos(double a) { return cos(a); }
__device__ __forceinline__ Dual dcos(Dual a) {
  double s, c;
  sincos(a.v, &s, &c);
  return {c, -a.d * s};
}
__device__ __forceinline__ double dsqrt(double a) { return sqrt(a); }
__device__ __forceinline__ Dual dsqrt(Dual a) {
  const double r = sqrt(a.v);
  return {r, a.d / (2.0 * r)};
}
__device__ __forceinline__ double dexp(double a) { return exp(a); }
__device__ __forceinline__ Dual dexp(Dual a) {
  const double e = exp(a.v);
  return {e, a.d * e};
}
__device__ __forceinline__ double dlog(double a) { return log(a); }
__device__ __forceinline__ Dual dlog(Dual a) { return {log(a.v), a.d / a.v}; }
__device__ __forceinline__ double datan2(double y, double x) { return atan2(y, x); }
__device__ __forceinline__ Dual datan2(Dual y, Dual x) {
  return {atan2(y.v, x.v), (y.d * x.v - x.d * y.v) / (y.v * y.v + x.v * x.v)};
}
// torch.clamp(a, min=lo) and torch.clamp(a, lo, hi): the tangent passes
// where the value lies inside (bounds included); a NaN stays NaN
__device__ __forceinline__ double dclamp_min(double a, double lo) { return a < lo ? lo : a; }
__device__ __forceinline__ Dual dclamp_min(Dual a, double lo) {
  return a.v >= lo ? a : (a.v < lo ? Dual{lo, 0.0} : Dual{a.v, 0.0});
}
__device__ __forceinline__ double dclamp(double a, double lo, double hi) {
  return a < lo ? lo : (a > hi ? hi : a);
}
__device__ __forceinline__ Dual dclamp(Dual a, double lo, double hi) {
  if (a.v >= lo && a.v <= hi) return a;
  return {a.v < lo ? lo : (a.v > hi ? hi : a.v), 0.0};
}

template <class T> __device__ __forceinline__ T lift(double v, bool seed);
template <> __device__ __forceinline__ double lift<double>(double v, bool) { return v; }
template <> __device__ __forceinline__ Dual lift<Dual>(double v, bool seed) {
  return {v, seed ? 1.0 : 0.0};
}

// ---------------------------------------------------------------------------
// geom/lie.py so3_exp and so3_log over T (imu_factor.cuh's so3_exp_d and
// so3_log_d, the branch taken by the value)
// ---------------------------------------------------------------------------

template <class T>
__device__ __forceinline__ T sinc_t(T x) {
  const T x2 = x * x;
  if (fabs(val(x)) < kEps) return (1.0 - x2 * (1.0 / 6.0)) + x2 * x2 * (1.0 / 120.0);
  return dsin(x) / x;
}

template <class T>
__device__ __forceinline__ T cosc_t(T x) {
  const T x2 = x * x;
  if (fabs(val(x)) < kEps) return (0.5 - x2 * (1.0 / 24.0)) + x2 * x2 * (1.0 / 720.0);
  return (1.0 - dcos(x)) / (x * x);
}

template <class T>
__device__ void so3_exp_t(const T w[3], T R[9]) {
  const T th = dsqrt(dclamp_min((w[0] * w[0] + w[1] * w[1]) + w[2] * w[2], 1e-24));
  const T sa = sinc_t(th), ca = cosc_t(th);
  const T zero = lift<T>(0.0, false);
  const T W[9] = {zero, -w[2], w[1], w[2], zero, -w[0], -w[1], w[0], zero};
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const T w2 = (W[3 * i] * W[j] + W[3 * i + 1] * W[3 + j]) + W[3 * i + 2] * W[6 + j];
      R[3 * i + j] = ((i == j ? 1.0 : 0.0) + sa * W[3 * i + j]) + ca * w2;
    }
}

template <class T>
__device__ void so3_log_t(const T R[9], T w[3]) {
  const T tr = (R[0] + R[4]) + R[8];
  const T c = dclamp((tr - 1.0) * 0.5, -1.0, 1.0);
  const T ws[3] = {R[7] - R[5], R[2] - R[6], R[3] - R[1]};
  const T s = 0.5 * dsqrt(dclamp_min((ws[0] * ws[0] + ws[1] * ws[1]) + ws[2] * ws[2], 1e-24));
  const T th = datan2(s, c);
  if (!(val(th) > kPi - 1e-3)) {
    const T f = 0.5 / sinc_t(th);
#pragma unroll
    for (int k = 0; k < 3; ++k) w[k] = f * ws[k];
    return;
  }
  // near pi: the axis from the diagonal of (R + I) / 2
  T dg[3], ax[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    dg[k] = dclamp_min((R[4 * k] + 1.0) * 0.5, 0.0);
    ax[k] = dsqrt(dg[k]);
  }
  int k = 0;
  if (val(ax[1]) > val(ax[k])) k = 1;
  if (val(ax[2]) > val(ax[k])) k = 2;
  T row[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) row[j] = j == k ? dg[k] : R[3 * k + j] * 0.5;
  const T den = val(ax[k]) < 1e-12 ? lift<T>(1.0, false) : ax[k];
#pragma unroll
  for (int j = 0; j < 3; ++j) row[j] = row[j] / den;
  const T nd = dclamp_min(dsqrt((row[0] * row[0] + row[1] * row[1]) + row[2] * row[2]), 1e-12);
#pragma unroll
  for (int j = 0; j < 3; ++j) w[j] = row[j] / nd * th;
}

}  // namespace
