// Visual-inertial refinement of one frame (PoseInertialOptimizationLastKeyFrame
// and ...LastFrame), all rounds and iterations in one launch.
//
// Replaces tc2li_slam_tpu/solver/pose_inertial.py:205 (optimize_last_kf,
// its lax.scan :249) and :263 (optimize_last_frame, :316): on the TPU each a
// jit-compiled program. Eager PyTorch ran a call as ~12,000-17,000 small ops
// (2 rounds x (1 + 6 x 2) + 1 evaluations of a ~600-op quadratic).
//
// What it computes is the plain version's (ops/kernels/pose_inertial.py:
// optimize_last_kf_plain, optimize_last_frame_plain), with NF free dims:
// 15 (the frame; the last keyframe's state is a fixed anchor) or 30 ([prev |
// cur]; prev is held by its marginalization prior). An evaluation at a state
// sums the frame's reprojection rows (body poses, right-multiplicative
// update; the 6x6 pose block, its 6-vector and the cost), adds the IMU pair
// factor to the anchor or prev (9 residual rows, J1 and J2 [9, 15], the
// preintegration corrected at the frame's biases) with the bias random walk,
// and for NF 30 the prior on prev. For each of `rounds` rounds (the gate on
// chi2 from the second on): lam = 1e-2 and the cost at the state, then
// `iters` times the step -(H + lam diag(H) + 1e-6 I)^-1 g, Jacobi
// preconditioned, applied through se3_exp and accepted on a strictly lower
// cost (lam x 0.5, else x 4). A last evaluation under the gate gives H and
// the inlier flags; for NF 30 prev is Schur-marginalized out of H. The
// weight w = inv_sigma2 * huber * active is a product: a masked row whose
// point is not finite makes every sum NaN and no step is accepted, as there.
//
// Numbers: the rows' terms, their sums, the IMU and prior terms, the solve
// and the costs run in float64 from the float32 inputs; the state is kept
// in float64 and rounded once at the end. The IMU information is O(1e6)
// beside the visual O(1) in one system, and near convergence a float32 cost
// is noisier than the changes the accept test decides: the kernel takes the
// decisions of the plain version run in float64. C9^-1 is inverted once a
// call (Gauss-Jordan, partial pivoting), the damped preconditioned system
// is solved by Cholesky (positive definite after lam diag(H) + 1e-6 I; a
// non-positive pivot would give a NaN step, which the accept test rejects).
//
// Bound on the H100: latency. A call over 2,000 rows reads 60 KB and does
// ~6 M float64 operations, a multiply-add counted as one (under a
// microsecond of either); its 2 (1 + 6) + 1 evaluations are serial, each a
// reduction over the rows and a dense solve.
// Design: a cluster of 8 blocks of 256 threads, an eighth of the rows each
// (read from device memory, cached). A pass evaluates every row at the
// candidate pose, a thread its block's rows tid, tid + 256, ..., and
// reduces the 28 sums in float64: each warp by a reduce-scatter (lane k ends
// with sum k), warp 0 adds the warps in order and writes the block's sums
// into every block's slot (distributed shared memory); after one cluster
// barrier every block's warp 0 adds the 8 slots in block order, so all
// blocks hold the same sums. Warp 0 of every block then takes the same
// step: lane 0 the residuals and Jacobians of the IMU and prior factors,
// the lanes the products J^T I J (entries spread over the lanes), the
// Cholesky factor (a row a lane), the two triangular solves (shuffles) and
// lane 0 the update. The pass at the candidate gives its cost and, if it is
// accepted, the next step's H and g: one pass an iteration. No atomics and
// no host sync: the same bits on every call.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

using tc2li::Cam;

constexpr int kBlocks = 8;     // blocks of the cluster, a share of the rows each
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kH = 21;          // upper triangle of the 6x6 pose block, row-major
constexpr int kCost = kH + 6;   // after g
constexpr int kCount = 32;      // a slot's inlier count
constexpr double kEps = 5e-3;   // geom/lie.py _EPS
constexpr double kPi = 3.14159265358979323846;

// device pointers of the inputs, in the order of tc2li_pose_inertial_lm's
// table
struct In {
  const float* T_cb;                                  // [4, 4]
  const float *s0_T, *s0_v, *s0_bg, *s0_ba;           // the frame's initial state
  const float *an_T, *an_v, *an_bg, *an_ba;           // the anchor (15) or prev (30)
  const float *pr_T, *pr_v, *pr_bg, *pr_ba;           // the prior's state (30)
  const float *pr_H, *pr_w;                           // [15, 15], [] (30)
  const float *dR, *dV, *dP, *JRg, *JVg, *JVa, *JPg, *JPa, *dt, *bgl, *bal, *C;   // pre
  const float *grav, *info_bg, *info_ba;
  const float *X, *uv, *s2;                           // [O, 3], [O, 3], [O]
  const uint8_t *stereo, *valid;                      // [O]
};
constexpr int kPtrs = 35;
static_assert(sizeof(In) == kPtrs * sizeof(void*), "In is a table of pointers");

struct State {
  double T[16];   // T_wb, row-major
  double v[3], bg[3], ba[3];
};

struct Pre {
  double dR[9], dV[3], dP[3], JRg[9], JVg[9], JVa[9], JPg[9], JPa[9], dt, bg[3], ba[3];
};

template <int NF>
struct Work {
  double H[2][NF * NF];   // assembled at the accepted state and at the candidate
  double g[2][NF];
  double A[NF * NF];      // the damped, preconditioned system and its factor
  double d[NF];           // the preconditioner
  double J1[135], J2[135], IJ1[135], IJ2[135];   // [9, 15], I = C9^-1
  double r[9];
  double info[81];
  double aug[9 * 18];     // [C9 | I] for the inverse
  double Hw[225], Jp[225], PH[225];   // the prior's H * weight, its Jacobian, Jp^T Hw
  double rp[15], Hr[15];
  double rw[6];           // the bias random walk's residuals
  double dx[30];          // the step
  double Xs[225];         // H11^-1 H12 (Schur)
  double vis[32];         // the pass's sums, in block order
  double cost_if;         // the evaluation's IMU (and prior) cost
  double slot[2][kBlocks][33];   // each block's sums by pass parity (33: the count)
  double part[kWarps][33];
  double pose[12];        // the pass's T_bw, top rows
  double tcb[12];         // T_cb, top rows
  Pre pre;
  State st[2][2];         // [accepted, candidate][prev or anchor, cur]
  State prior;
  double grav[3], info_bg, info_ba;
  unsigned part_n[kWarps];
  int n_act;
};

__device__ __forceinline__ double sinc_d(double x) {
  const double x2 = x * x;
  return fabs(x) < kEps ? 1.0 - x2 / 6.0 + x2 * x2 / 120.0 : sin(x) / x;
}

__device__ __forceinline__ double cosc_d(double x) {
  const double x2 = x * x;
  return fabs(x) < kEps ? 0.5 - x2 / 24.0 + x2 * x2 / 720.0 : (1.0 - cos(x)) / (x * x);
}

__device__ __forceinline__ double sinc3_d(double x) {
  const double x2 = x * x;
  return fabs(x) < kEps ? 1.0 / 6.0 - x2 / 120.0 + x2 * x2 / 5040.0 : (x - sin(x)) / (x * x * x);
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
  const double sa = sinc_d(th), ca = cosc_d(th), s3 = sinc3_d(th);
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
  const double cot = th < kEps ? 1.0 / 12.0 + t2 / 720.0 + t2 * t2 / 30240.0
                               : 1.0 / (th * th) - sin(th) / (2.0 * th * (1.0 - cos(th)));
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

// The IMU pair factor (anchor a -> frame s; solver/factors.py imu_residual
// and _imu_pair_terms): r [9], J1 and J2 [9, 15] in the state order (rho,
// phi, v, bg, ba), and the random walk's residuals. Lane 0 only.
template <int NF>
__device__ void imu_rows(Work<NF>& wk, const State& a, const State& s, double rbg[3],
                         double rba[3]) {
  const Pre& q = wk.pre;
  double R1[9], p1[3], R2[9], p2[3];
  rot_of(a, R1, p1);
  rot_of(s, R2, p2);
  double dbg[3], dba[3], tmp[3], tmp2[3];
  for (int k = 0; k < 3; ++k) {
    dbg[k] = s.bg[k] - q.bg[k];
    dba[k] = s.ba[k] - q.ba[k];
    rbg[k] = s.bg[k] - a.bg[k];
    rba[k] = s.ba[k] - a.ba[k];
  }
  double Eb[9], dRc[9];
  mv(q.JRg, dbg, tmp);
  so3_exp_d(tmp, Eb, nullptr);
  mm(q.dR, Eb, dRc);
  double dVc[3], dPc[3];
  mv(q.JVg, dbg, tmp);
  mv(q.JVa, dba, tmp2);
  for (int k = 0; k < 3; ++k) dVc[k] = (q.dV[k] + tmp[k]) + tmp2[k];
  mv(q.JPg, dbg, tmp);
  mv(q.JPa, dba, tmp2);
  for (int k = 0; k < 3; ++k) dPc[k] = (q.dP[k] + tmp[k]) + tmp2[k];
  // eR = dR_c^T R1^T R2
  double M1[9], eR[9], er[3];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      M1[3 * i + j] = dRc[i] * R1[3 * j] + dRc[3 + i] * R1[3 * j + 1] + dRc[6 + i] * R1[3 * j + 2];
  mm(M1, R2, eR);
  so3_log_d(eR, er);
  const double dt = q.dt;
  double dvw[3], dpw[3], ev[3], ep[3], Rdv[3], Rdp[3];
  for (int k = 0; k < 3; ++k) {
    dvw[k] = (s.v[k] - a.v[k]) - wk.grav[k] * dt;
    dpw[k] = ((p2[k] - p1[k]) - a.v[k] * dt) - (0.5 * wk.grav[k] * dt) * dt;
  }
  mtv(R1, dvw, Rdv);
  mtv(R1, dpw, Rdp);
  for (int k = 0; k < 3; ++k) {
    ev[k] = Rdv[k] - dVc[k];
    ep[k] = Rdp[k] - dPc[k];
    wk.r[k] = er[k];
    wk.r[3 + k] = ev[k];
    wk.r[6 + k] = ep[k];
  }
  double iJ[9];
  jr_inv_d(er, iJ);
  for (int e = 0; e < 135; ++e) wk.J1[e] = wk.J2[e] = 0.0;
  double R21[9], A1[9], hv[9], hp[9], R12[9], Bg[9], M2[9];
  mtm(R2, R1, R21);
  mm(iJ, R21, A1);
  hat_d(Rdv, hv);
  hat_d(Rdp, hp);
  mtm(R1, R2, R12);
  // (-invJr) eR^T JRg
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      M2[3 * i + j] = -iJ[3 * i] * eR[3 * j] - iJ[3 * i + 1] * eR[3 * j + 1] -
                      iJ[3 * i + 2] * eR[3 * j + 2];
  mm(M2, q.JRg, Bg);
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j) {
      const double I = i == j ? 1.0 : 0.0;
      // J1: rho1 (ep: -I), phi1 (er, ev, ep), v1 (ev, ep)
      wk.J1[15 * (6 + i) + j] = -I;
      wk.J1[15 * i + 3 + j] = -A1[3 * i + j];
      wk.J1[15 * (3 + i) + 3 + j] = hv[3 * i + j];
      wk.J1[15 * (6 + i) + 3 + j] = hp[3 * i + j];
      wk.J1[15 * (3 + i) + 6 + j] = -R1[3 * j + i];
      wk.J1[15 * (6 + i) + 6 + j] = -R1[3 * j + i] * dt;
      // J2: rho2 (ep), phi2 (er), v2 (ev), bg (er, ev, ep), ba (ev, ep)
      wk.J2[15 * (6 + i) + j] = R12[3 * i + j];
      wk.J2[15 * i + 3 + j] = iJ[3 * i + j];
      wk.J2[15 * (3 + i) + 6 + j] = R1[3 * j + i];
      wk.J2[15 * i + 9 + j] = Bg[3 * i + j];
      wk.J2[15 * (3 + i) + 9 + j] = -q.JVg[3 * i + j];
      wk.J2[15 * (6 + i) + 9 + j] = -q.JPg[3 * i + j];
      wk.J2[15 * (3 + i) + 12 + j] = -q.JVa[3 * i + j];
      wk.J2[15 * (6 + i) + 12 + j] = -q.JPa[3 * i + j];
    }
  }
}

// The prior on prev (EdgePriorPoseImu, _prior_terms): rp [15], Jp [15, 15].
// Lane 0 only.
template <int NF>
__device__ void prior_rows(Work<NF>& wk, const State& s) {
  double R[9], p[3], Rl[9], pl[3];
  rot_of(s, R, p);
  rot_of(wk.prior, Rl, pl);
  double M[9], er[3], dp[3], ep[3], iJ[9];
  mtm(Rl, R, M);
  so3_log_d(M, er);
  for (int k = 0; k < 3; ++k) dp[k] = p[k] - pl[k];
  mtv(Rl, dp, ep);
  jr_inv_d(er, iJ);
  for (int k = 0; k < 3; ++k) {
    wk.rp[k] = er[k];
    wk.rp[3 + k] = ep[k];
    wk.rp[6 + k] = s.v[k] - wk.prior.v[k];
    wk.rp[9 + k] = s.bg[k] - wk.prior.bg[k];
    wk.rp[12 + k] = s.ba[k] - wk.prior.ba[k];
  }
  for (int e = 0; e < 225; ++e) {
    const int i = e / 15, j = e % 15;
    double v = (i == j && i >= 6) ? 1.0 : 0.0;
    if (i < 3 && j >= 3 && j < 6) v = iJ[3 * i + j - 3];
    if (i >= 3 && i < 6 && j < 3) v = M[3 * (i - 3) + j];
    wk.Jp[e] = v;
  }
}

// index of the upper-triangle entry (j, k), j <= k, of the 6x6 pose block
__device__ __forceinline__ int tri6(int j, int k) { return j * 6 - j * (j - 1) / 2 + (k - j); }

// The quadratic at the state (sp, sc) from the pass's sums in wk.vis: H, g
// into the buffers and the cost (returned on every lane). Warp 0.
template <int NF>
__device__ double assemble(Work<NF>& wk, const State& sp, const State& sc, double* H, double* g) {
  const int lane = threadIdx.x & 31;
  constexpr bool kPrev = NF == 30;
  constexpr int o2 = NF - 15;   // the frame's offset
  if (lane == 0) {
    double rbg[3], rba[3];
    imu_rows(wk, sp, sc, rbg, rba);
    // r I r + info_bg |rbg|^2 + info_ba |rba|^2
    double ci = 0.0;
    for (int j = 0; j < 9; ++j) {
      double ri = 0.0;
      for (int i = 0; i < 9; ++i) ri += wk.r[i] * wk.info[9 * i + j];
      ci += ri * wk.r[j];
    }
    ci = (ci + wk.info_bg * (rbg[0] * rbg[0] + rbg[1] * rbg[1] + rbg[2] * rbg[2])) +
         wk.info_ba * (rba[0] * rba[0] + rba[1] * rba[1] + rba[2] * rba[2]);
    for (int k = 0; k < 3; ++k) {
      wk.rw[k] = rbg[k];
      wk.rw[3 + k] = rba[k];
    }
    wk.cost_if = ci;
    if (kPrev) prior_rows(wk, sp);
  }
  __syncwarp();
  // I J1, I J2; Jp^T Hw and Hw rp
  for (int e = lane; e < 135; e += 32) {
    const int i = e / 15, j = e % 15;
    double a = 0.0, b = 0.0;
    for (int k = 0; k < 9; ++k) {
      a += wk.info[9 * i + k] * wk.J1[15 * k + j];
      b += wk.info[9 * i + k] * wk.J2[15 * k + j];
    }
    wk.IJ1[e] = a;
    wk.IJ2[e] = b;
  }
  if (kPrev) {
    for (int e = lane; e < 225; e += 32) {
      const int i = e / 15, j = e % 15;
      double a = 0.0;
      for (int k = 0; k < 15; ++k) a += wk.Jp[15 * k + i] * wk.Hw[15 * k + j];
      wk.PH[e] = a;
    }
    if (lane < 15) {
      double a = 0.0;
      for (int k = 0; k < 15; ++k) a += wk.Hw[15 * lane + k] * wk.rp[k];
      wk.Hr[lane] = a;
    }
  }
  __syncwarp();
  // H22 = J2^T I J2 + diag(0, info_bg, info_ba) + the pose block of the rows
  for (int e = lane; e < 225; e += 32) {
    const int i = e / 15, j = e % 15;
    double a = 0.0;
    for (int k = 0; k < 9; ++k) a += wk.J2[15 * k + i] * wk.IJ2[15 * k + j];
    if (i == j && i >= 9) a += i < 12 ? wk.info_bg : wk.info_ba;
    if (i < 6 && j < 6) a += wk.vis[i <= j ? tri6(i, j) : tri6(j, i)];
    H[NF * (o2 + i) + o2 + j] = a;
  }
  if (kPrev) {
    // H11 = J1^T I J1 + Jp^T Hw Jp; H12 = J1^T I J2 (and its transpose)
    for (int e = lane; e < 225; e += 32) {
      const int i = e / 15, j = e % 15;
      double a = 0.0, b = 0.0, c = 0.0;
      for (int k = 0; k < 9; ++k) {
        a += wk.J1[15 * k + i] * wk.IJ1[15 * k + j];
        c += wk.J1[15 * k + i] * wk.IJ2[15 * k + j];
      }
      for (int k = 0; k < 15; ++k) b += wk.PH[15 * i + k] * wk.Jp[15 * k + j];
      H[NF * i + j] = a + b;
      H[NF * i + 15 + j] = c;
      H[NF * (15 + j) + i] = c;
    }
  }
  if (lane < 15) {
    const int i = lane;
    double b2 = 0.0;
    for (int k = 0; k < 9; ++k) b2 += wk.IJ2[15 * k + i] * wk.r[k];
    if (i >= 9) b2 += (i < 12 ? wk.info_bg : wk.info_ba) * wk.rw[i - 9];
    if (i < 6) b2 += wk.vis[kH + i];
    g[o2 + i] = b2;
    if (kPrev) {
      double b1 = 0.0, bp = 0.0;
      for (int k = 0; k < 9; ++k) b1 += wk.IJ1[15 * k + i] * wk.r[k];
      for (int k = 0; k < 15; ++k) bp += wk.Jp[15 * k + i] * wk.Hr[k];
      g[i] = b1 + bp;
    }
  }
  double cost = 0.0;
  if (lane == 0) {
    cost = wk.vis[kCost] + wk.cost_if;
    if (kPrev) {
      double cp = 0.0;
      for (int j = 0; j < 15; ++j) {
        double a = 0.0;
        for (int i = 0; i < 15; ++i) a += wk.rp[i] * wk.Hw[15 * i + j];
        cp += a * wk.rp[j];
      }
      cost = cost + cp;
    }
  }
  __syncwarp();
  return __shfl_sync(0xffffffffu, cost, 0);
}

// In-place Cholesky A = L L^T of the leading n x n of A (stride lda), L in
// the lower triangle (its diagonal included); a row a lane. Warp 0.
__device__ void cholesky(double* A, int lda, int n) {
  const int lane = threadIdx.x & 31;
  for (int c = 0; c < n; ++c) {
    __syncwarp();
    const double piv = sqrt(A[lda * c + c]);
    if (lane > c && lane < n) A[lda * lane + c] /= piv;
    __syncwarp();
    if (lane == c) A[lda * c + c] = piv;
    if (lane > c && lane < n) {
      const double l = A[lda * lane + c];
      for (int k = c + 1; k <= lane; ++k) A[lda * lane + k] -= l * A[lda * k + c];
    }
  }
  __syncwarp();
}

// L L^T x = b, lane i holding b_i (i < n) on entry and x_i on return
__device__ double chol_solve(const double* A, int lda, int n, double b) {
  const int lane = threadIdx.x & 31;
  for (int c = 0; c < n; ++c) {
    const double y = __shfl_sync(0xffffffffu, b, c) / A[lda * c + c];
    if (lane == c) b = y;
    if (lane > c && lane < n) b -= A[lda * lane + c] * y;
  }
  for (int c = n - 1; c >= 0; --c) {
    const double x = __shfl_sync(0xffffffffu, b, c) / A[lda * c + c];
    if (lane == c) b = x;
    if (lane < c) b -= A[lda * c + lane] * x;
  }
  return b;
}

// The step from (H, g) at lam: dx = -(Hn^-1 (g / d)) / d with Haug = H +
// lam diag(H) + 1e-6 I and Hn = Haug / (d d^T), d = sqrt(|diag Haug|);
// the candidate into wk.st[1]. Warp 0.
template <int NF>
__device__ void lm_step(Work<NF>& wk, const double* H, const double* g, double lam) {
  const int lane = threadIdx.x & 31;
  if (lane < NF) {
    const double h = H[NF * lane + lane];
    const double ha = (h + lam * h) + 1e-6;
    const double a = fabs(ha);
    wk.d[lane] = sqrt(a < 1e-12 ? 1e-12 : a);
  }
  __syncwarp();
  if (lane < NF) {
    const int i = lane;
    for (int j = 0; j < NF; ++j) {
      double h = H[NF * i + j];
      if (i == j) h = (h + lam * h) + 1e-6;
      wk.A[NF * i + j] = h / (wk.d[i] * wk.d[j]);
    }
  }
  cholesky(wk.A, NF, NF);
  const double b = lane < NF ? g[lane] / wk.d[lane] : 0.0;
  const double x = chol_solve(wk.A, NF, NF, b);
  if (lane < NF) wk.dx[lane] = -(x / wk.d[lane]);
  __syncwarp();
  if (lane == 0) {
    if (NF == 30) {
      apply_d(wk.st[0][0], wk.dx, wk.st[1][0]);
    } else {
      wk.st[1][0] = wk.st[0][0];
    }
    apply_d(wk.st[0][1], wk.dx + NF - 15, wk.st[1][1]);
  }
  __syncwarp();
}

// the pass's pose: T_bw = T_wb^-1 of the frame state, top rows
template <int NF>
__device__ void set_pose(Work<NF>& wk, const State& s) {
  const int lane = threadIdx.x & 31;
  if (lane < 3) {
    const int i = lane;   // row i of R^T and -(R^T t)_i
    for (int j = 0; j < 3; ++j) wk.pose[4 * i + j] = s.T[4 * j + i];
    wk.pose[4 * i + 3] = -(s.T[i] * s.T[3] + s.T[4 + i] * s.T[7] + s.T[8 + i] * s.T[11]);
  }
}

// one step of the reduce-scatter (pose_lm.cu), in float64
template <int O>
__device__ __forceinline__ void scatter_step(double (&v)[32], int lane) {
  const bool up = (lane & O) != 0;
#pragma unroll
  for (int i = 0; i < O; ++i) {
    const double send = up ? v[i] : v[i + O];
    const double keep = up ? v[i + O] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, O);
  }
}

// One row at the pass's pose into the thread's sums (solver/inertial_ba.py
// body_reprojection, _visual_terms); returns the inlier flag.
template <int NF>
__device__ __forceinline__ bool add_row(const Work<NF>& wk, const In& in, const Cam& cam, int i,
                                        bool gate, double (&acc)[32]) {
  const double X[3] = {in.X[3 * i], in.X[3 * i + 1], in.X[3 * i + 2]};
  const double uv[3] = {in.uv[3 * i], in.uv[3 * i + 1], in.uv[3 * i + 2]};
  const double is2 = in.s2[i];
  const bool st = in.stereo[i] != 0, va = in.valid[i] != 0;
  const double* P = wk.pose;
  double Xb[3], Xc[3];
  for (int k = 0; k < 3; ++k)
    Xb[k] = ((X[0] * P[4 * k] + X[1] * P[4 * k + 1]) + X[2] * P[4 * k + 2]) + P[4 * k + 3];
  const double* C = wk.tcb;
  for (int k = 0; k < 3; ++k)
    Xc[k] = ((Xb[0] * C[4 * k] + Xb[1] * C[4 * k + 1]) + Xb[2] * C[4 * k + 2]) + C[4 * k + 3];
  const double fx = cam.fx, fy = cam.fy, cx = cam.cx, cy = cam.cy, bf = cam.bf;
  const double z = fabs(Xc[2]) < 1e-9 ? 1e-9 : Xc[2];
  const double u = fx * Xc[0] / z + cx, v = fy * Xc[1] / z + cy;
  double r[3] = {u - uv[0], v - uv[1], st ? (u - bf / z) - uv[2] : 0.0};
  const double iz = 1.0 / z, iz2 = iz * iz;
  const double a[3][3] = {{fx * iz, 0.0, -fx * Xc[0] * iz2},
                          {0.0, fy * iz, -fy * Xc[1] * iz2},
                          {st ? fx * iz : 0.0, 0.0, st ? (-fx * Xc[0] + bf) * iz2 : 0.0}};
  // J = (a R_cb) [-I | hat(X_b)]
  double JR[3][3], J[3][6];
  for (int k = 0; k < 3; ++k)
    for (int j = 0; j < 3; ++j)
      JR[k][j] = a[k][0] * C[j] + a[k][1] * C[4 + j] + a[k][2] * C[8 + j];
  for (int k = 0; k < 3; ++k) {
    J[k][0] = -JR[k][0];
    J[k][1] = -JR[k][1];
    J[k][2] = -JR[k][2];
    J[k][3] = JR[k][1] * Xb[2] - JR[k][2] * Xb[1];
    J[k][4] = -JR[k][0] * Xb[2] + JR[k][2] * Xb[0];
    J[k][5] = JR[k][0] * Xb[1] - JR[k][1] * Xb[0];
  }
  const double rr = (r[0] * r[0] + r[1] * r[1]) + r[2] * r[2];
  const double chi2 = is2 * rr;
  // the thresholds are float32 constants in both plain runs (torch.where of
  // two Python scalars)
  const double thr = st ? static_cast<double>(tc2li::kChi2Stereo)
                        : static_cast<double>(tc2li::kChi2Mono);
  bool act = va && Xc[2] > 0.05;
  const bool inl = act && chi2 <= thr;
  if (gate) act = inl;
  // (a NaN chi2 stays NaN through the clamp, as torch.clamp)
  const double hub = chi2 <= thr ? 1.0 : sqrt(thr / (chi2 < 1e-12 ? 1e-12 : chi2));
  const double w = is2 * hub * (act ? 1.0 : 0.0);
  acc[kCost] += w * rr;
  int idx = 0;
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    const double w0 = J[0][j] * w, w1 = J[1][j] * w, w2 = J[2][j] * w;
#pragma unroll
    for (int k = j; k < 6; ++k) acc[idx++] += (w0 * J[0][k] + w1 * J[1][k]) + w2 * J[2][k];
    acc[kH + j] += (w0 * r[0] + w1 * r[1]) + w2 * r[2];
  }
  return inl;
}

template <int NF>
__global__ void __launch_bounds__(kThreads, 1)
pose_inertial_kernel(const In in, int O, const Cam cam, int rounds, int iters,
                     float* __restrict__ out, uint8_t* __restrict__ inliers,
                     int* __restrict__ n_inliers) {
  extern __shared__ double smem_raw[];
  Work<NF>& wk = *reinterpret_cast<Work<NF>*>(smem_raw);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool w0 = warp == 0;
  const int per = (O + kBlocks - 1) / kBlocks;
  const int r0 = min(rank * per, O), nr = min(per, O - r0);

  // the call's constants, in float64
  if (w0) {
    for (int e = lane; e < 12; e += 32) wk.tcb[e] = in.T_cb[e];
    if (lane == 0) {
      Pre& q = wk.pre;
      for (int k = 0; k < 9; ++k) {
        q.dR[k] = in.dR[k];
        q.JRg[k] = in.JRg[k];
        q.JVg[k] = in.JVg[k];
        q.JVa[k] = in.JVa[k];
        q.JPg[k] = in.JPg[k];
        q.JPa[k] = in.JPa[k];
      }
      for (int k = 0; k < 3; ++k) {
        q.dV[k] = in.dV[k];
        q.dP[k] = in.dP[k];
        q.bg[k] = in.bgl[k];
        q.ba[k] = in.bal[k];
        wk.grav[k] = in.grav[k];
      }
      q.dt = in.dt[0];
      wk.info_bg = in.info_bg[0];
      wk.info_ba = in.info_ba[0];
      State* init[3] = {&wk.st[0][1], &wk.st[0][0], &wk.prior};
      const float* Ts[3] = {in.s0_T, in.an_T, in.pr_T};
      const float* vs[3] = {in.s0_v, in.an_v, in.pr_v};
      const float* gs[3] = {in.s0_bg, in.an_bg, in.pr_bg};
      const float* as[3] = {in.s0_ba, in.an_ba, in.pr_ba};
      for (int m = 0; m < (NF == 30 ? 3 : 2); ++m) {
        for (int k = 0; k < 16; ++k) init[m]->T[k] = Ts[m][k];
        for (int k = 0; k < 3; ++k) {
          init[m]->v[k] = vs[m][k];
          init[m]->bg[k] = gs[m][k];
          init[m]->ba[k] = as[m][k];
        }
      }
    }
    if (NF == 30) {
      const double pw = in.pr_w[0];
      for (int e = lane; e < 225; e += 32) wk.Hw[e] = static_cast<double>(in.pr_H[e]) * pw;
    }
    // [C9 + 1e-10 I | I], then Gauss-Jordan with the first largest pivot
    for (int e = lane; e < 162; e += 32) {
      const int i = e / 18, j = e % 18;
      wk.aug[e] = j < 9 ? static_cast<double>(in.C[15 * i + j]) + (i == j ? 1e-10 : 0.0)
                        : (j - 9 == i ? 1.0 : 0.0);
    }
    __syncwarp();
    for (int c = 0; c < 9; ++c) {
      int p = c;
      double best = fabs(wk.aug[18 * c + c]);
      for (int rr = c + 1; rr < 9; ++rr) {
        if (fabs(wk.aug[18 * rr + c]) > best) {
          best = fabs(wk.aug[18 * rr + c]);
          p = rr;
        }
      }
      double f[9];
      for (int rr = 0; rr < 9; ++rr) f[rr] = wk.aug[18 * rr + c];
      const double fp = f[p], fc = f[c];
      f[p] = fc;
      f[c] = fp;
      __syncwarp();
      if (lane < 18) {   // column `lane`: swap, scale, eliminate
        const int j = lane;
        const double vc = wk.aug[18 * c + j], vp = wk.aug[18 * p + j];
        const double piv = vp / fp;
        wk.aug[18 * p + j] = vc;
        wk.aug[18 * c + j] = piv;
        for (int rr = 0; rr < 9; ++rr)
          if (rr != c) wk.aug[18 * rr + j] -= f[rr] * piv;
      }
      __syncwarp();
    }
    for (int e = lane; e < 81; e += 32) wk.info[e] = wk.aug[18 * (e / 9) + 9 + e % 9];
  }
  __syncthreads();
  cluster.sync();   // every block runs before any writes into another

  int par = 0;
  // a pass over this block's rows at wk.pose, then the blocks' sums in
  // block order into every block's wk.vis (warp 0); `flags` writes the
  // inlier flags and counts them
  auto all_pass = [&](bool gate, bool flags) {
    double acc[32];
#pragma unroll
    for (int k = 0; k < 32; ++k) acc[k] = 0.0;
    unsigned cnt = 0;
    for (int i = r0 + tid; i < r0 + nr; i += kThreads) {
      const bool inl = add_row(wk, in, cam, i, gate, acc);
      if (flags) {
        inliers[i] = inl;
        cnt += inl;
      }
    }
    scatter_step<16>(acc, lane);
    scatter_step<8>(acc, lane);
    scatter_step<4>(acc, lane);
    scatter_step<2>(acc, lane);
    scatter_step<1>(acc, lane);
    wk.part[warp][lane] = acc[0];
    if (flags) {
      cnt = __reduce_add_sync(0xffffffffu, cnt);
      if (lane == 0) wk.part_n[warp] = cnt;
    }
    __syncthreads();
    if (w0) {
      double s = 0.0;
      for (int w = 0; w < kWarps; ++w) s += wk.part[w][lane];
      unsigned c = 0;
      for (int w = 0; w < kWarps; ++w) c += wk.part_n[w];
      for (int q = 0; q < kBlocks; ++q) {
        double* dst = cluster.map_shared_rank(&wk.slot[par][rank][0], q);
        dst[lane] = s;
        if (lane == 0) dst[kCount] = flags ? static_cast<double>(c) : 0.0;
      }
    }
    cluster.sync();
    if (w0) {
      double tot = 0.0, cn = 0.0;
      for (int q = 0; q < kBlocks; ++q) {
        tot += wk.slot[par][q][lane];
        cn += wk.slot[par][q][kCount];
      }
      wk.vis[lane] = tot;
      if (lane == 0) wk.n_act = static_cast<int>(cn);
      __syncwarp();
    }
    par ^= 1;
  };

  int cur = 0;         // which H / g buffer holds the accepted state's
  double cost = 0.0, lam = 1e-2;
  for (int rnd = 0; rnd < rounds; ++rnd) {
    const bool gate = rnd > 0;
    if (w0) set_pose(wk, wk.st[0][1]);
    __syncthreads();
    all_pass(gate, false);
    if (w0) {
      cost = assemble(wk, wk.st[0][0], wk.st[0][1], wk.H[cur], wk.g[cur]);
      lam = 1e-2;
    }
    for (int it = 0; it < iters; ++it) {
      if (w0) {
        lm_step(wk, wk.H[cur], wk.g[cur], lam);
        set_pose(wk, wk.st[1][1]);
      }
      __syncthreads();
      all_pass(gate, false);
      if (w0) {
        const double c_new = assemble(wk, wk.st[1][0], wk.st[1][1], wk.H[cur ^ 1], wk.g[cur ^ 1]);
        if (c_new < cost) {   // NaN rejects
          if (lane == 0) {
            wk.st[0][0] = wk.st[1][0];
            wk.st[0][1] = wk.st[1][1];
          }
          cur ^= 1;
          cost = c_new;
          lam *= 0.5;
        } else {
          lam *= 4.0;
        }
        __syncwarp();
      }
    }
  }
  // the last evaluation, gated: H and the inlier flags
  if (w0) set_pose(wk, wk.st[0][1]);
  __syncthreads();
  all_pass(true, true);
  if (!w0 || rank != 0) return;
  double* H = wk.H[cur];
  assemble(wk, wk.st[0][0], wk.st[0][1], H, wk.g[cur]);
  if (NF == 30) {
    // H* = H22 - H12^T (H11 + 1e-6 I)^-1 H12, symmetrized
    for (int e = lane; e < 225; e += 32) {
      const int i = e / 15, j = e % 15;
      wk.A[15 * i + j] = H[NF * i + j] + (i == j ? 1e-6 : 0.0);
    }
    cholesky(wk.A, 15, 15);
    if (lane < 15) {   // column `lane` of H11^-1 H12
      double y[15];
      for (int c = 0; c < 15; ++c) {
        double b = H[NF * c + 15 + lane];
        for (int k = 0; k < c; ++k) b -= wk.A[15 * c + k] * y[k];
        y[c] = b / wk.A[15 * c + c];
      }
      for (int c = 14; c >= 0; --c) {
        double b = y[c];
        for (int k = c + 1; k < 15; ++k) b -= wk.A[15 * k + c] * y[k];
        y[c] = b / wk.A[15 * c + c];
      }
      for (int c = 0; c < 15; ++c) wk.Xs[15 * c + lane] = y[c];
    }
    __syncwarp();
    for (int e = lane; e < 225; e += 32) {
      const int i = e / 15, j = e % 15;
      double a = 0.0;
      for (int k = 0; k < 15; ++k) a += H[NF * k + 15 + i] * wk.Xs[15 * k + j];
      wk.PH[e] = H[NF * (15 + i) + 15 + j] - a;
    }
    __syncwarp();
    for (int e = lane; e < 225; e += 32) {
      const int i = e / 15, j = e % 15;
      out[25 + e] = static_cast<float>(0.5 * (wk.PH[e] + wk.PH[15 * j + i]));
    }
  } else {
    for (int e = lane; e < 225; e += 32) out[25 + e] = static_cast<float>(H[e]);
  }
  if (lane == 0) {
    const State& s = wk.st[0][1];
    for (int k = 0; k < 16; ++k) out[k] = static_cast<float>(s.T[k]);
    for (int k = 0; k < 3; ++k) {
      out[16 + k] = static_cast<float>(s.v[k]);
      out[19 + k] = static_cast<float>(s.bg[k]);
      out[22 + k] = static_cast<float>(s.ba[k]);
    }
    out[250] = static_cast<float>(cost);
    out[251] = 1.f;
    *n_inliers = wk.n_act;
  }
}

template <int NF>
int launch(const In& in, int O, const Cam& cam, int rounds, int iters, float* out,
           uint8_t* inliers, int* n_inliers, cudaStream_t stream) {
  const size_t smem = sizeof(Work<NF>);
  int rc = static_cast<int>(cudaFuncSetAttribute(
      pose_inertial_kernel<NF>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
  if (rc != 0) return rc;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kBlocks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kBlocks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  rc = static_cast<int>(cudaLaunchKernelEx(&cfg, pose_inertial_kernel<NF>, in, O, cam, rounds,
                                           iters, out, inliers, n_inliers));
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// ptrs: kPtrs device pointers in the order of struct In (float32 unless
// named; every tensor contiguous): T_cb [4, 4]; the frame's initial state
// (T_wb [4, 4], vel, bg, ba [3]); the anchor's (nf 15) or prev's (nf 30);
// the prior's state, its H [15, 15] and weight [] (nf 30; any valid
// pointers for nf 15); the preintegration's dR, dV, dP, JRg, JVg, JVa, JPg,
// JPa, dt, bg, ba, C [15, 15]; gravity [3], info_bg, info_ba []; X [O, 3],
// uv [O, 3], inv_sigma2 [O], stereo, valid [O] uint8. nf: 15 or 30.
// Outputs: out [252] float32 (T_wb [16], vel, bg, ba [3], the next prior's
// H [15, 15], cost, weight 1), inliers [O] uint8, n_inliers int32. Launches
// on `stream`, returns the first CUDA error code that is not cudaSuccess.
extern "C" int tc2li_pose_inertial_lm(const uint64_t* ptrs, int n_ptrs, int nf, int O, float fx,
                                      float fy, float cx, float cy, float bf, int rounds,
                                      int iters, float* out, uint8_t* inliers, int* n_inliers,
                                      void* stream) {
  if (n_ptrs != kPtrs || (nf != 15 && nf != 30) || O < 0 || rounds < 0 || iters < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  In in;
  const void** dst = reinterpret_cast<const void**>(&in);
  for (int k = 0; k < kPtrs; ++k) dst[k] = reinterpret_cast<const void*>(ptrs[k]);
  const Cam cam{fx, fy, cx, cy, bf};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return nf == 30 ? launch<30>(in, O, cam, rounds, iters, out, inliers, n_inliers, st)
                  : launch<15>(in, O, cam, rounds, iters, out, inliers, n_inliers, st);
}
