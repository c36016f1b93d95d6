// The float64 IMU pair factor shared by the kernels that hold IMU
// preintegration factors (pose_inertial.cu, lvi_ba.cu): the SO(3) chains of
// geom/lie.py in float64 (exp, log, the right Jacobian's inverse), the
// residual of solver/factors.py imu_residual and the entries of its two
// Jacobians. Each kernel keeps the intermediates in a work struct of its
// own with the members imu_pre, j1_entry and j2_entry read and write (pre,
// grav, r, rw, R1, R2, eR, iJ, Rdv, Rdp).
#pragma once

#include <cuda_runtime.h>

namespace {

constexpr double kEps = 5e-3;   // geom/lie.py _EPS
constexpr double kPi = 3.14159265358979323846;

struct State {
  double T[16];   // T_wb, row-major
  double v[3], bg[3], ba[3];
};

struct Pre {
  double dR[9], dV[3], dP[3], JRg[9], JVg[9], JVa[9], JPg[9], JPa[9], dt, bg[3], ba[3];
};

// geom/lie.py's sin(x) / x with its Taylor branch below kEps (the series'
// divisions by constants as products with their reciprocals; the branches
// are taken, not both computed and selected: these chains run on one thread)
__device__ __forceinline__ double sinc_d(double x) {
  const double x2 = x * x;
  if (fabs(x) < kEps) return 1.0 - x2 * (1.0 / 6.0) + x2 * x2 * (1.0 / 120.0);
  return sin(x) / x;
}

__device__ __forceinline__ void hat_d(const double v[3], double W[9]) {
  W[0] = 0.0;   W[1] = -v[2]; W[2] = v[1];
  W[3] = v[2];  W[4] = 0.0;   W[5] = -v[0];
  W[6] = -v[1]; W[7] = v[0];  W[8] = 0.0;
}

// C = A B and C = A^T B for row-major 3x3; y = A x and y = A^T x
__device__ __forceinline__ void mm(const double* A, const double* B, double* C) {
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      C[3 * i + j] = A[3 * i] * B[j] + A[3 * i + 1] * B[3 + j] + A[3 * i + 2] * B[6 + j];
}

__device__ __forceinline__ void mtm(const double* A, const double* B, double* C) {
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      C[3 * i + j] = A[i] * B[j] + A[3 + i] * B[3 + j] + A[6 + i] * B[6 + j];
}

__device__ __forceinline__ void mv(const double* A, const double* x, double* y) {
  for (int i = 0; i < 3; ++i) y[i] = A[3 * i] * x[0] + A[3 * i + 1] * x[1] + A[3 * i + 2] * x[2];
}

__device__ __forceinline__ void mtv(const double* A, const double* x, double* y) {
  for (int i = 0; i < 3; ++i) y[i] = A[i] * x[0] + A[3 + i] * x[1] + A[6 + i] * x[2];
}

__device__ __forceinline__ double theta_of(const double w[3]) {
  const double t2 = w[0] * w[0] + w[1] * w[1] + w[2] * w[2];
  return sqrt(t2 < 1e-24 ? 1e-24 : t2);
}

// geom/lie.py so3_exp (R) and so3_left_jacobian (V) of w
__device__ void so3_exp_d(const double w[3], double R[9], double* V) {
  const double th = theta_of(w);
  double W[9], W2[9];
  hat_d(w, W);
  mm(W, W, W2);
  const double t2 = th * th;
  double sa, ca, s3;   // sin(th) / th, (1 - cos th) / th^2, (th - sin th) / th^3
  if (fabs(th) < kEps) {
    sa = 1.0 - t2 * (1.0 / 6.0) + t2 * t2 * (1.0 / 120.0);
    ca = 0.5 - t2 * (1.0 / 24.0) + t2 * t2 * (1.0 / 720.0);
    s3 = 1.0 / 6.0 - t2 * (1.0 / 120.0) + t2 * t2 * (1.0 / 5040.0);
  } else {
    double sn, cs;
    sincos(th, &sn, &cs);
    const double it2 = 1.0 / t2;
    sa = sn / th;
    ca = (1.0 - cs) * it2;
    s3 = (th - sn) * (it2 / th);
  }
  for (int e = 0; e < 9; ++e) {
    const double I = (e % 4 == 0) ? 1.0 : 0.0;
    R[e] = (I + sa * W[e]) + ca * W2[e];
    if (V) V[e] = (I + ca * W[e]) + s3 * W2[e];
  }
}

// geom/lie.py so3_log: atan2 of sin and cos; near pi the axis from the
// diagonal of (R + I) / 2
__device__ void so3_log_d(const double R[9], double w[3]) {
  const double tr = R[0] + R[4] + R[8];
  double c = (tr - 1.0) * 0.5;
  c = c < -1.0 ? -1.0 : (c > 1.0 ? 1.0 : c);
  const double ws[3] = {R[7] - R[5], R[2] - R[6], R[3] - R[1]};
  const double ss = ws[0] * ws[0] + ws[1] * ws[1] + ws[2] * ws[2];
  const double s = 0.5 * sqrt(ss < 1e-24 ? 1e-24 : ss);
  const double th = atan2(s, c);
  if (!(th > kPi - 1e-3)) {
    const double f = 0.5 / sinc_d(th);
    for (int k = 0; k < 3; ++k) w[k] = f * ws[k];
    return;
  }
  double dg[3], ax[3];
  for (int k = 0; k < 3; ++k) {
    const double v = (R[4 * k] + 1.0) * 0.5;
    dg[k] = v < 0.0 ? 0.0 : v;
    ax[k] = sqrt(dg[k]);
  }
  int k = 0;
  if (ax[1] > ax[k]) k = 1;
  if (ax[2] > ax[k]) k = 2;
  double row[3];
  for (int j = 0; j < 3; ++j) row[j] = j == k ? dg[k] : (R[3 * k + j] + (k == j ? 1.0 : 0.0)) * 0.5;
  const double den = ax[k] < 1e-12 ? 1.0 : ax[k];
  for (int j = 0; j < 3; ++j) row[j] /= den;
  const double nn = sqrt(row[0] * row[0] + row[1] * row[1] + row[2] * row[2]);
  const double nd = nn < 1e-12 ? 1e-12 : nn;
  for (int j = 0; j < 3; ++j) w[j] = row[j] / nd * th;
}

// geom/lie.py so3_right_jacobian_inv(w) = so3_left_jacobian_inv(-w)
__device__ void jr_inv_d(const double w[3], double J[9]) {
  const double v[3] = {-w[0], -w[1], -w[2]};
  const double th = theta_of(v);
  double W[9], W2[9];
  hat_d(v, W);
  mm(W, W, W2);
  const double t2 = th * th;
  double cot;
  if (th < kEps) {
    cot = 1.0 / 12.0 + t2 * (1.0 / 720.0) + t2 * t2 * (1.0 / 30240.0);
  } else {
    double sn, cs;
    sincos(th, &sn, &cs);
    cot = 1.0 / t2 - sn / (2.0 * th * (1.0 - cs));
  }
  for (int e = 0; e < 9; ++e) {
    const double I = (e % 4 == 0) ? 1.0 : 0.0;
    J[e] = (I - 0.5 * W[e]) + cot * W2[e];
  }
}

// s <- s (+) dx: T_wb exp(dx[0:6]) (rho, phi), v, bg, ba + the rest
__device__ void apply_d(const State& s, const double* dx, State& o) {
  double R[9], V[9], t[3];
  so3_exp_d(dx + 3, R, V);
  mv(V, dx, t);
  double E[16] = {R[0], R[1], R[2], t[0], R[3], R[4], R[5], t[1],
                  R[6], R[7], R[8], t[2], 0.0, 0.0, 0.0, 1.0};
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 4; ++j)
      o.T[4 * i + j] = s.T[4 * i] * E[j] + s.T[4 * i + 1] * E[4 + j] + s.T[4 * i + 2] * E[8 + j] +
                       s.T[4 * i + 3] * E[12 + j];
  for (int k = 0; k < 3; ++k) {
    o.v[k] = s.v[k] + dx[6 + k];
    o.bg[k] = s.bg[k] + dx[9 + k];
    o.ba[k] = s.ba[k] + dx[12 + k];
  }
}

__device__ __forceinline__ void rot_of(const State& s, double R[9], double p[3]) {
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j) R[3 * i + j] = s.T[4 * i + j];
    p[i] = s.T[4 * i + 3];
  }
}

__device__ __forceinline__ double hat_at(const double v[3], int i, int j) {
  // hat(v)[i][j]
  if (i == j) return 0.0;
  const int k = 3 - i - j;   // the third index
  const double s = ((i + 1) % 3 == j) ? -1.0 : 1.0;
  return s * v[k];
}

// The IMU pair factor (anchor a -> frame s; solver/factors.py imu_residual
// and _imu_pair_terms): the residual r [9], the random walk's residuals and
// the intermediates J1 and J2 are made of, in two parts on two threads:
// `rot` the rotation's chain (Exp of the bias correction, the residual
// rotation, its Log and Jr^-1), else the velocity's and position's rows.
template <class W>
__device__ void imu_pre(W& wk, const State& a, const State& s, bool rot) {
  const Pre& q = wk.pre;
  double R1[9], p1[3], R2[9], p2[3];
  rot_of(a, R1, p1);
  rot_of(s, R2, p2);
  double dbg[3], dba[3], tmp[3], tmp2[3];
  for (int k = 0; k < 3; ++k) {
    dbg[k] = s.bg[k] - q.bg[k];
    dba[k] = s.ba[k] - q.ba[k];
  }
  if (rot) {
    double Eb[9], dRc[9];
    mv(q.JRg, dbg, tmp);
    so3_exp_d(tmp, Eb, nullptr);
    mm(q.dR, Eb, dRc);
    // eR = dR_c^T R1^T R2
    double M1[9], eR[9], er[3];
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j)
        M1[3 * i + j] = dRc[i] * R1[3 * j] + dRc[3 + i] * R1[3 * j + 1] + dRc[6 + i] * R1[3 * j + 2];
    mm(M1, R2, eR);
    so3_log_d(eR, er);
    double iJ[9];
    jr_inv_d(er, iJ);
    for (int k = 0; k < 3; ++k) wk.r[k] = er[k];
    for (int e = 0; e < 9; ++e) {
      wk.R1[e] = R1[e];
      wk.R2[e] = R2[e];
      wk.eR[e] = eR[e];
      wk.iJ[e] = iJ[e];
    }
    return;
  }
  double dVc[3], dPc[3];
  mv(q.JVg, dbg, tmp);
  mv(q.JVa, dba, tmp2);
  for (int k = 0; k < 3; ++k) dVc[k] = (q.dV[k] + tmp[k]) + tmp2[k];
  mv(q.JPg, dbg, tmp);
  mv(q.JPa, dba, tmp2);
  for (int k = 0; k < 3; ++k) dPc[k] = (q.dP[k] + tmp[k]) + tmp2[k];
  const double dt = q.dt;
  double dvw[3], dpw[3], Rdv[3], Rdp[3];
  for (int k = 0; k < 3; ++k) {
    dvw[k] = (s.v[k] - a.v[k]) - wk.grav[k] * dt;
    dpw[k] = ((p2[k] - p1[k]) - a.v[k] * dt) - (0.5 * wk.grav[k] * dt) * dt;
  }
  mtv(R1, dvw, Rdv);
  mtv(R1, dpw, Rdp);
  for (int k = 0; k < 3; ++k) {
    wk.r[3 + k] = Rdv[k] - dVc[k];
    wk.r[6 + k] = Rdp[k] - dPc[k];
    wk.Rdv[k] = Rdv[k];
    wk.Rdp[k] = Rdp[k];
    wk.rw[k] = s.bg[k] - a.bg[k];
    wk.rw[3 + k] = s.ba[k] - a.ba[k];
  }
}

// entry (i, j) of J1 [9, 15] (rows er, ev, ep; columns rho1, phi1, v1, bg1,
// ba1): rho1 (ep: -I), phi1 (er: -Jr^-1 R2^T R1, ev: hat(R1^T dv), ep:
// hat(R1^T dp)), v1 (ev: -R1^T, ep: -R1^T dt)
template <class W>
__device__ double j1_entry(const W& wk, int i, int j) {
  const int bi = i / 3, ii = i % 3, bj = j / 3, jj = j % 3;
  if (bj == 0) return bi == 2 && ii == jj ? -1.0 : 0.0;
  if (bj == 1) {
    if (bi == 1) return hat_at(wk.Rdv, ii, jj);
    if (bi == 2) return hat_at(wk.Rdp, ii, jj);
    double a = 0.0;   // (Jr^-1 (R2^T R1))[ii][jj]
    for (int k = 0; k < 3; ++k) {
      const double r21 = (wk.R2[k] * wk.R1[jj] + wk.R2[3 + k] * wk.R1[3 + jj]) +
                         wk.R2[6 + k] * wk.R1[6 + jj];
      a += wk.iJ[3 * ii + k] * r21;
    }
    return -a;
  }
  if (bj == 2) {
    if (bi == 1) return -wk.R1[3 * jj + ii];
    if (bi == 2) return -wk.R1[3 * jj + ii] * wk.pre.dt;
  }
  return 0.0;
}

// entry (i, j) of J2 [9, 15]: rho2 (ep: R1^T R2), phi2 (er: Jr^-1), v2 (ev:
// R1^T), bg (er: -Jr^-1 eR^T JRg, ev: -JVg, ep: -JPg), ba (ev: -JVa, ep:
// -JPa)
template <class W>
__device__ double j2_entry(const W& wk, int i, int j) {
  const int bi = i / 3, ii = i % 3, bj = j / 3, jj = j % 3;
  const Pre& q = wk.pre;
  switch (bj) {
    case 0:
      return bi == 2 ? (wk.R1[ii] * wk.R2[jj] + wk.R1[3 + ii] * wk.R2[3 + jj]) +
                           wk.R1[6 + ii] * wk.R2[6 + jj]
                     : 0.0;
    case 1: return bi == 0 ? wk.iJ[3 * ii + jj] : 0.0;
    case 2: return bi == 1 ? wk.R1[3 * jj + ii] : 0.0;
    case 3: {
      if (bi == 1) return -q.JVg[3 * ii + jj];
      if (bi == 2) return -q.JPg[3 * ii + jj];
      double a = 0.0;   // ((-Jr^-1 eR^T) JRg)[ii][jj]
      for (int k = 0; k < 3; ++k) {
        const double m2 = (-wk.iJ[3 * ii] * wk.eR[3 * k] - wk.iJ[3 * ii + 1] * wk.eR[3 * k + 1]) -
                          wk.iJ[3 * ii + 2] * wk.eR[3 * k + 2];
        a += m2 * q.JRg[3 * k + jj];
      }
      return a;
    }
    default:
      if (bi == 1) return -q.JVa[3 * ii + jj];
      if (bi == 2) return -q.JPa[3 * ii + jj];
      return 0.0;
  }
}

}  // namespace
