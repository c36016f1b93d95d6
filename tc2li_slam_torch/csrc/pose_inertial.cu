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
// reduction over the rows and a dense solve, and between the reductions
// the work is a few thousand operations on dependent steps.
// Design: a cluster of 8 blocks of 256 threads, an eighth of the rows each
// (read from device memory, cached). A pass evaluates every row at the
// candidate pose, a thread its block's rows tid, tid + 256, ..., and
// reduces the 28 sums in float64: each warp by a reduce-scatter (lane k ends
// with sum k), warp 0 adds the warps in order and writes the block's sums
// into every block's slot (distributed shared memory); after one cluster
// barrier every block's warp 0 adds the 8 slots in block order, so all
// blocks hold the same sums and take the same step, with no broadcast. What
// lies between two passes runs on the whole block, phases split by block
// barriers:
// - the IMU factor's and the prior's shared intermediates (the corrected
//   preintegration, Exp, Log and Jr^-1 of the residual rotations), on three
//   threads of warps 1 to 3 while the pass's rows are summed; then the
//   entries of J1, J2 (9x15) and Jp (15x15) and the residuals' products
//   I r, Hw rp, a thread an entry;
// - the products I J1, I J2, Jp^T Hw over the Jacobians' non-zero rows,
//   then H22, H11 + Jp^T Hw Jp on their upper triangles (mirrored) and H12,
//   the gradient as J^T (I r), the cost;
// - the step: the Jacobi-scaled lower triangle of Haug, its right-looking
//   Cholesky (see factor: an entry of a column pair's trailing update a
//   thread, one block barrier a pair), the two triangular solves on warp 0 by shuffles
//   with the pivots' inverses, and prev's and cur's se3_exp updates on two
//   threads side by side.
// C9's Gauss-Jordan runs on warp 0 while the other warps sum the first
// pass's rows. The pass at the candidate gives its cost and, if it is
// accepted, the next step's H and g: one pass an iteration. No atomics and
// no host sync: the same bits on every call.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "imu_factor.cuh"

#ifdef TC2LI_LAPS   // clock laps of a phase split (laps.cuh, tools/vi_kernels.py)
#define TC2LI_LAP_TAG pose_inertial
#include "laps.cuh"
#else
#define TC2LI_LAP_START
#define TC2LI_LAP(k)
#endif

namespace cg = cooperative_groups;

namespace {

using tc2li::Cam;

constexpr int kBlocks = 8;     // blocks of the cluster, a share of the rows each
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kH = 21;          // upper triangle of the 6x6 pose block, row-major
constexpr int kCost = kH + 6;   // after g
constexpr int kCount = 32;      // a slot's inlier count
constexpr unsigned kFull = 0xffffffffu;

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

template <int NF>
struct Work {
  double H[2][NF * NF];   // assembled at the accepted state and at the candidate
  double g[2][NF];
  double A[NF * (NF | 1)];   // the damped, scaled system's lower triangle and its
                            // factor, rows kLd(NF) apart
  double dinv[NF];        // the Jacobi scaling 1 / d
  double linv[NF];        // the factor's inverse pivots 1 / L_cc
  double rpiv[NF];        // the factor's 1 / a_cc of each pivot
  unsigned short trail[2][435];   // the factor's trailing entries (i << 8 | j), columns
                                  // from the last, for 15 rows (the 15-dim step, the
                                  // 30-dim Schur step) and 30
  double dx[30];          // the step
  double J1[135], J2[135], IJ1[135], IJ2[135];   // [9, 15], I = C9^-1
  double r[9], Ir[9];     // the IMU residual and I r
  double rw[6];           // the bias random walk's residuals
  double info[81];
  double aug[9 * 18];     // [C9 | I] for the inverse
  double Hw[225], Jp[225], PH[225];   // the prior's H * weight, its Jacobian, Jp^T Hw
  double rp[15], Hr[15];
  double R1[9], R2[9], eR[9], iJ[9], Rdv[3], Rdp[3];   // the IMU factor's intermediates
  double Mp[9], iJp[9];   // the prior's
  double Xs[225];         // H11^-1 H12 (Schur)
  double vis[32];         // the pass's sums, in block order
  double cost_eval;       // the evaluation's cost
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

// The prior on prev (EdgePriorPoseImu, _prior_terms): rp [15] and the
// blocks of Jp. One thread.
template <int NF>
__device__ void prior_pre(Work<NF>& wk, const State& s) {
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
  for (int e = 0; e < 9; ++e) {
    wk.Mp[e] = M[e];
    wk.iJp[e] = iJ[e];
  }
}

// entry (i, j) of the prior's Jacobian Jp [15, 15]: Jr^-1 in (phi, phi)'s
// place of the log, R_l^T R in (p, phi)'s... as _prior_terms: rows (er, ep,
// v, bg, ba), columns (rho, phi, v, bg, ba)
template <int NF>
__device__ double jp_entry(const Work<NF>& wk, int i, int j) {
  if (i < 3 && j >= 3 && j < 6) return wk.iJp[3 * i + j - 3];
  if (i >= 3 && i < 6 && j < 3) return wk.Mp[3 * (i - 3) + j];
  return i == j && i >= 6 ? 1.0 : 0.0;
}

// the rows [lo, hi) of J1 and J2 that can be non-zero in column block b
__device__ __forceinline__ void j1_rows(int b, int& lo, int& hi) {
  lo = b == 0 ? 6 : (b == 2 ? 3 : 0);
  hi = b <= 2 ? 9 : 0;
}
__device__ __forceinline__ void j2_rows(int b, int& lo, int& hi) {
  lo = b == 0 ? 6 : (b == 2 || b == 4 ? 3 : 0);
  hi = b == 1 ? 3 : (b == 2 ? 6 : 9);
}
// ... and of Jp in column j
__device__ __forceinline__ void jp_rows(int j, int& lo, int& hi) {
  lo = j < 3 ? 3 : (j < 6 ? 0 : j);
  hi = j < 3 ? 6 : (j < 6 ? 3 : j + 1);
}

// (p, q) of entry e of a lower triangle stored row by row: p >= q
__device__ __forceinline__ void lower_of(int e, int& p, int& q) {
  int r = static_cast<int>((sqrtf(8.f * e + 1.f) - 1.f) * 0.5f);
  if ((r + 1) * (r + 2) / 2 <= e) ++r;
  if (r * (r + 1) / 2 > e) --r;
  p = r;
  q = e - r * (r + 1) / 2;
}

// (i, j) of entry e of the upper triangle of a 15x15 stored row by row
__device__ __forceinline__ void upper15_of(int e, int& i, int& j) {
  i = 0;
  while (e >= 15 - i) {
    e -= 15 - i;
    ++i;
  }
  j = i + e;
}

// index of the upper-triangle entry (j, k), j <= k, of the 6x6 pose block
__device__ __forceinline__ int tri6(int j, int k) { return j * 6 - j * (j - 1) / 2 + (k - j); }

// The quadratic at the pass's state from its sums in wk.vis and the IMU and
// prior terms' intermediates (imu_pre, prior_pre, computed during the pass):
// H, g into the buffers and the cost into wk.cost_eval (returned). The whole
// block; ends on a barrier.
template <int NF>
__device__ double assemble(Work<NF>& wk, double* H, double* g) {
  constexpr bool kPrev = NF == 30;
  constexpr int o2 = NF - 15;   // the frame's offset
  const int tid = threadIdx.x;
  // the Jacobians' entries (J1 at 30 free dims only); I r and Hw rp
  for (int e = tid + (kPrev ? 0 : 135); e < 519; e += kThreads) {
    if (e < 135) {
      wk.J1[e] = j1_entry(wk, e / 15, e % 15);
    } else if (e < 270) {
      wk.J2[e - 135] = j2_entry(wk, (e - 135) / 15, (e - 135) % 15);
    } else if (e < 279) {
      const int i = e - 270;
      double a = 0.0;
      for (int k = 0; k < 9; ++k) a += wk.info[9 * i + k] * wk.r[k];
      wk.Ir[i] = a;
    } else if (!kPrev) {
      break;
    } else if (e < 294) {
      const int i = e - 279;
      double a = 0.0;
      for (int k = 0; k < 15; ++k) a += wk.Hw[15 * i + k] * wk.rp[k];
      wk.Hr[i] = a;
    } else {
      const int f = e - 294;
      wk.Jp[f] = jp_entry(wk, f / 15, f % 15);
    }
  }
  __syncthreads();
  TC2LI_LAP(4);
  // I J1, I J2 over the Jacobians' non-zero rows; Jp^T Hw
  for (int e = tid; e < (kPrev ? 495 : 135); e += kThreads) {
    if (e < 135 || (kPrev && e < 270)) {
      const bool two = !kPrev || e < 135;
      const int f = kPrev ? (e < 135 ? e : e - 135) : e;
      const int i = f / 15, j = f % 15;
      int lo, hi;
      const double* J = two ? wk.J2 : wk.J1;
      if (two) j2_rows(j / 3, lo, hi); else j1_rows(j / 3, lo, hi);
      double a = 0.0;
      for (int k = lo; k < hi; ++k) a += wk.info[9 * i + k] * J[15 * k + j];
      (two ? wk.IJ2 : wk.IJ1)[f] = a;
    } else {
      const int f = e - 270, i = f / 15, j = f % 15;
      int lo, hi;
      jp_rows(i, lo, hi);
      double a = 0.0;
      for (int k = lo; k < hi; ++k) a += wk.Jp[15 * k + i] * wk.Hw[15 * k + j];
      wk.PH[f] = a;
    }
  }
  __syncthreads();
  // H22, H11 on their upper triangles (mirrored), H12 and its transpose, g,
  // the cost
  constexpr int kItems = kPrev ? 496 : 136;
  for (int e = tid; e < kItems; e += kThreads) {
    if (e < 120) {   // H22 = J2^T I J2 + diag(0, info_bg, info_ba) + the pose block of the rows
      int i, j, lo, hi;
      upper15_of(e, i, j);
      j2_rows(i / 3, lo, hi);
      double a = 0.0;
      for (int k = lo; k < hi; ++k) a += wk.J2[15 * k + i] * wk.IJ2[15 * k + j];
      if (i == j && i >= 9) a += i < 12 ? wk.info_bg : wk.info_ba;
      if (j < 6) a += wk.vis[tri6(i, j)];
      H[NF * (o2 + i) + o2 + j] = a;
      H[NF * (o2 + j) + o2 + i] = a;
    } else if (e < 135) {   // g2 = J2^T (I r) + the walk + the rows'
      const int i = e - 120;
      int lo, hi;
      j2_rows(i / 3, lo, hi);
      double b = 0.0;
      for (int k = lo; k < hi; ++k) b += wk.J2[15 * k + i] * wk.Ir[k];
      if (i >= 9) b += (i < 12 ? wk.info_bg : wk.info_ba) * wk.rw[i - 9];
      if (i < 6) b += wk.vis[kH + i];
      g[o2 + i] = b;
    } else if (e == 135) {   // r I r + the walk + the rows' (+ rp Hw rp)
      double ci = 0.0;
      for (int k = 0; k < 9; ++k) ci += wk.r[k] * wk.Ir[k];
      const double* rw = wk.rw;
      ci = (ci + wk.info_bg * (rw[0] * rw[0] + rw[1] * rw[1] + rw[2] * rw[2])) +
           wk.info_ba * (rw[3] * rw[3] + rw[4] * rw[4] + rw[5] * rw[5]);
      double cost = wk.vis[kCost] + ci;
      if (kPrev) {
        double cp = 0.0;
        for (int k = 0; k < 15; ++k) cp += wk.rp[k] * wk.Hr[k];
        cost = cost + cp;
      }
      wk.cost_eval = cost;
    } else if (e < 256) {   // H11 = J1^T I J1 + (Jp^T Hw) Jp, upper
      int i, j, lo, hi;
      upper15_of(e - 136, i, j);
      j1_rows(i / 3, lo, hi);
      double a = 0.0, b = 0.0;
      for (int k = lo; k < hi; ++k) a += wk.J1[15 * k + i] * wk.IJ1[15 * k + j];
      jp_rows(j, lo, hi);
      for (int k = lo; k < hi; ++k) b += wk.PH[15 * i + k] * wk.Jp[15 * k + j];
      H[NF * i + j] = a + b;
      H[NF * j + i] = a + b;
    } else if (e < 271) {   // g1 = J1^T (I r) + Jp^T (Hw rp)
      const int i = e - 256;
      int lo, hi;
      j1_rows(i / 3, lo, hi);
      double b = 0.0, bp = 0.0;
      for (int k = lo; k < hi; ++k) b += wk.J1[15 * k + i] * wk.Ir[k];
      jp_rows(i, lo, hi);
      for (int k = lo; k < hi; ++k) bp += wk.Jp[15 * k + i] * wk.Hr[k];
      g[i] = b + bp;
    } else {   // H12 = J1^T I J2, and H21
      const int f = e - 271, i = f / 15, j = f % 15;
      int lo, hi;
      j1_rows(i / 3, lo, hi);
      double c = 0.0;
      for (int k = lo; k < hi; ++k) c += wk.J1[15 * k + i] * wk.IJ2[15 * k + j];
      H[NF * i + 15 + j] = c;
      H[NF * (15 + j) + i] = c;
    }
  }
  __syncthreads();
  TC2LI_LAP(5);
  return wk.cost_eval;
}

// rows of the factored matrix are kLd(N) doubles apart: odd, so a column's
// entries fall in different shared-memory banks
__host__ __device__ constexpr int kLd(int n) { return n | 1; }

// the trailing entries (i, j), 1 <= j <= i < N, columns from the last, rows
// in order within one: column c's update is the first (N - 1 - c) (N - c) / 2
__device__ __forceinline__ unsigned short trail_entry(int N, int k) {
  int p, q;
  lower_of(k, p, q);
  const int j = N - 1 - p;
  return static_cast<unsigned short>(((j + q) << 8) | j);
}

// In-place Cholesky of the lower triangle of the N x N matrix A (rows
// kLd(N) apart): L below the diagonal, the inverse pivots 1 / L_cc in linv
// (A's diagonal keeps the pivots before their root). Right-looking, column
// by column: column c's trailing update a_ij -= a_ic (a_jc / a_cc) for
// i >= j > c, the reciprocal taken once (rpiv), then every column scaled by
// its pivot's inverse root, two columns a block barrier. Each thread takes
// entries (i, j), j > c + 1, of the pair (c, c + 1)'s trailing update and
// forms column c + 1's a_i,c+1 - a_ic (a_c+1,c / a_cc) itself; column c + 1
// is written in the next pair's phase (nothing reads it then), and one
// thread updates the next pair's 2x2 block (which it reads, so no other
// thread writes it in the phase) and forms its two pivots' reciprocals. (A
// row a lane of warp 0 in registers, the columns' entries by shuffles, is
// as fast at 15 rows and slower at 30: PERF.md.) The whole block; ends on a
// barrier.
template <int N>
__device__ void factor(double* A, double* linv, double* rpiv, const unsigned short* trail) {
  constexpr int LD = kLd(N);
  const int tid = threadIdx.x;
  constexpr int kLead = kThreads - 1;   // the thread that forms the next pivots
  // (i, j) after column c's update, and column c + 1's entry of row i
  auto after1 = [&](int i, int j, int c) {
    return A[LD * i + j] - A[LD * i + c] * (A[LD * j + c] * rpiv[c]);
  };
  if (tid == 0) {
    rpiv[0] = 1.0 / A[0];
    if (N > 1) rpiv[1] = 1.0 / after1(1, 1, 0);
  }
  __syncthreads();
  for (int c = 0; c < N; c += 2) {
    const int m = c + 2 < N ? (N - 2 - c) * (N - 1 - c) / 2 : 0;   // entries j > c + 1
    if (tid == kLead) {   // the next pair's 2x2 block, its pivots and reciprocals
      if (c + 2 < N) {
        const int n2 = c + 3 < N ? 3 : 1;
        const int ij[3][2] = {{c + 2, c + 2}, {c + 3, c + 2}, {c + 3, c + 3}};
        double v[3];
        for (int e = 0; e < n2; ++e) {
          const int i = ij[e][0], j = ij[e][1];
          const double ti = after1(i, c + 1, c), tj = after1(j, c + 1, c);
          v[e] = after1(i, j, c) - ti * (tj * rpiv[c + 1]);
        }
        for (int e = 0; e < n2; ++e) A[LD * ij[e][0] + ij[e][1]] = v[e];
        rpiv[c + 2] = 1.0 / v[0];
        if (c + 3 < N) rpiv[c + 3] = 1.0 / (v[2] - v[1] * (v[1] * rpiv[c + 2]));
      }
    } else {
      for (int k = tid; k < m; k += kLead) {
        const int i = trail[k] >> 8, j = trail[k] & 255;
        if (i <= c + 3) continue;   // the next pair's 2x2 block: the lead thread's
        const double ti = after1(i, c + 1, c), tj = after1(j, c + 1, c);
        A[LD * i + j] = after1(i, j, c) - ti * (tj * rpiv[c + 1]);
      }
      // the previous pair's second column, now that nothing reads it
      if (c >= 2 && tid < N - (c - 1)) {
        const int i = c - 1 + tid;
        A[LD * i + c - 1] = after1(i, c - 1, c - 2);
      }
    }
    __syncthreads();
  }
  // the last pair's second column (of N even): its one entry, the pivot
  if (N % 2 == 0 && tid == 0) A[LD * (N - 1) + N - 1] = after1(N - 1, N - 1, N - 2);
  __syncthreads();
  if (tid < N) linv[tid] = 1.0 / sqrt(A[LD * tid + tid]);
  __syncthreads();
  for (int e = tid; e < N * (N - 1) / 2; e += kThreads) {
    int p, q;
    lower_of(e, p, q);
    A[LD * (p + 1) + q] *= linv[q];
  }
  __syncthreads();
}

// L L^T x = b from factor's output; lane i holds b_i (i < N) on entry and
// x_i on return. Warp 0.
template <int N>
__device__ double chol_solve(const double* A, const double* linv, double b) {
  constexpr int LD = kLd(N);
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int c = 0; c < N; ++c) {
    const double y = __shfl_sync(kFull, b, c) * linv[c];
    if (lane == c) b = y;
    if (lane > c && lane < N) b -= A[LD * lane + c] * y;
  }
#pragma unroll
  for (int c = N - 1; c >= 0; --c) {
    const double x = __shfl_sync(kFull, b, c) * linv[c];
    if (lane == c) b = x;
    if (lane < c) b -= A[LD * c + lane] * x;
  }
  return b;
}

// the pass's pose: T_bw = T_wb^-1 of the frame state, top rows
__device__ __forceinline__ void pose_row(const State& s, double* pose, int i) {
  for (int j = 0; j < 3; ++j) pose[4 * i + j] = s.T[4 * j + i];
  pose[4 * i + 3] = -(s.T[i] * s.T[3] + s.T[4 + i] * s.T[7] + s.T[8 + i] * s.T[11]);
}

// The step from (H, g) at lam: dx = -((Hn^-1 (g / d)) / d) with Haug = H +
// lam diag(H) + 1e-6 I and Hn = Haug / (d d^T), d = sqrt(|diag Haug|);
// the candidate into wk.st[1] and its pose into wk.pose. The whole block;
// ends on a barrier.
template <int NF>
__device__ void lm_step(Work<NF>& wk, const double* H, const double* g, double lam) {
  const int tid = threadIdx.x;
  if (tid < NF) {
    const double h = H[NF * tid + tid];
    const double ha = (h + lam * h) + 1e-6;
    const double a = fabs(ha);
    wk.dinv[tid] = 1.0 / sqrt(a < 1e-12 ? 1e-12 : a);
  }
  __syncthreads();
  for (int e = tid; e < NF * (NF + 1) / 2; e += kThreads) {
    int i, j;
    lower_of(e, i, j);
    double h = H[NF * i + j];
    if (i == j) h = (h + lam * h) + 1e-6;
    const double a = (h * wk.dinv[i]) * wk.dinv[j];
    wk.A[kLd(NF) * i + j] = a;
  }
  __syncthreads();
  factor<NF>(wk.A, wk.linv, wk.rpiv, wk.trail[NF == 30]);
  TC2LI_LAP(6);
  if (tid < 32) {
    const double b = tid < NF ? g[tid] * wk.dinv[tid] : 0.0;
    const double x = chol_solve<NF>(wk.A, wk.linv, b);
    if (tid < NF) wk.dx[tid] = -(x * wk.dinv[tid]);
  }
  __syncthreads();
  // prev's update (30) and cur's with its pose, side by side
  if (tid == 0) {
    if (NF == 30) {
      apply_d(wk.st[0][0], wk.dx, wk.st[1][0]);
    } else {
      wk.st[1][0] = wk.st[0][0];
    }
  }
  if (tid == 32) {
    apply_d(wk.st[0][1], wk.dx + NF - 15, wk.st[1][1]);
    for (int i = 0; i < 3; ++i) pose_row(wk.st[1][1], wk.pose, i);
  }
  __syncthreads();
  TC2LI_LAP(7);
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

// the call's constants, in float64, a thread an entry
template <int NF>
__device__ void load_constants(Work<NF>& wk, const In& in) {
  Pre& q = wk.pre;
  struct Seg {
    const float* src;
    double* dst;
    int n;
  };
  const Seg seg[] = {
      {in.T_cb, wk.tcb, 12}, {in.dR, q.dR, 9}, {in.JRg, q.JRg, 9}, {in.JVg, q.JVg, 9},
      {in.JVa, q.JVa, 9}, {in.JPg, q.JPg, 9}, {in.JPa, q.JPa, 9}, {in.dV, q.dV, 3},
      {in.dP, q.dP, 3}, {in.bgl, q.bg, 3}, {in.bal, q.ba, 3}, {in.grav, wk.grav, 3},
      {in.dt, &q.dt, 1}, {in.info_bg, &wk.info_bg, 1}, {in.info_ba, &wk.info_ba, 1},
      {in.s0_T, wk.st[0][1].T, 16}, {in.s0_v, wk.st[0][1].v, 3}, {in.s0_bg, wk.st[0][1].bg, 3},
      {in.s0_ba, wk.st[0][1].ba, 3}, {in.an_T, wk.st[0][0].T, 16}, {in.an_v, wk.st[0][0].v, 3},
      {in.an_bg, wk.st[0][0].bg, 3}, {in.an_ba, wk.st[0][0].ba, 3},
      {in.pr_T, wk.prior.T, NF == 30 ? 16 : 0}, {in.pr_v, wk.prior.v, NF == 30 ? 3 : 0},
      {in.pr_bg, wk.prior.bg, NF == 30 ? 3 : 0}, {in.pr_ba, wk.prior.ba, NF == 30 ? 3 : 0}};
  int e = threadIdx.x;
  for (const Seg& s : seg) {
    if (e < s.n) {
      s.dst[e] = s.src[e];
      break;
    }
    e -= s.n;
  }
  for (int k = threadIdx.x; k < 435; k += kThreads) {
    wk.trail[1][k] = trail_entry(30, k);
    if (k < 105) wk.trail[0][k] = trail_entry(15, k);
  }
  if (NF == 30) {
    const double pw = in.pr_w[0];
    for (int f = threadIdx.x; f < 225; f += kThreads)
      wk.Hw[f] = static_cast<double>(in.pr_H[f]) * pw;
  }
}

// C9^-1: [C9 + 1e-10 I | I], then Gauss-Jordan with the first largest pivot,
// a column of [C9 | I] a lane. Warp 0.
template <int NF>
__device__ void c9_inverse(Work<NF>& wk, const In& in) {
  const int lane = threadIdx.x & 31;
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
  TC2LI_LAP_START

  load_constants(wk, in);
  __syncthreads();
  if (tid < 3) pose_row(wk.st[0][1], wk.pose, tid);
  cluster.sync();   // the constants and the pose are in place; every block runs
  TC2LI_LAP(0);
  if (w0) c9_inverse(wk, in);   // (info is first read in assemble, after the pass)
  TC2LI_LAP(1);

  int par = 0;
  // a pass over this block's rows at wk.pose, then the blocks' sums in
  // block order into every block's wk.vis (warp 0); `flags` writes the
  // inlier flags and counts them. The IMU factor's two parts and the
  // prior's one-thread chains at (sp, sc) run beside the rows, on warps 1, 3
  // and 2.
  auto all_pass = [&](bool gate, bool flags, const State& sp, const State& sc) {
    if (tid == 32 || tid == 96) imu_pre(wk, sp, sc, tid == 32);
    if (NF == 30 && tid == 64) prior_pre(wk, sp);
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
      cnt = __reduce_add_sync(kFull, cnt);
      if (lane == 0) wk.part_n[warp] = cnt;
    }
    __syncthreads();
    TC2LI_LAP(2);
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
    }
    TC2LI_LAP(3);
    par ^= 1;
  };

  int cur = 0;         // which H / g buffer holds the accepted state's
  double cost = 0.0, lam = 1e-2;
  for (int rnd = 0; rnd < rounds; ++rnd) {
    const bool gate = rnd > 0;
    if (rnd > 0) {
      if (tid < 3) pose_row(wk.st[0][1], wk.pose, tid);
      __syncthreads();
    }
    all_pass(gate, false, wk.st[0][0], wk.st[0][1]);
    cost = assemble(wk, wk.H[cur], wk.g[cur]);
    lam = 1e-2;
    for (int it = 0; it < iters; ++it) {
      lm_step(wk, wk.H[cur], wk.g[cur], lam);
      all_pass(gate, false, wk.st[1][0], wk.st[1][1]);
      const double c_new = assemble(wk, wk.H[cur ^ 1], wk.g[cur ^ 1]);
      if (c_new < cost) {   // NaN rejects
        double* dst = wk.st[0][0].T;   // st[0][0..1] <- st[1][0..1]
        const double* src = wk.st[1][0].T;
        constexpr int kN = 2 * sizeof(State) / sizeof(double);
        if (tid < kN) dst[tid] = src[tid];
        cur ^= 1;
        cost = c_new;
        lam *= 0.5;
      } else {
        lam *= 4.0;
      }
      __syncthreads();
    }
  }
  // the last evaluation, gated: H and the inlier flags
  if (tid < 3) pose_row(wk.st[0][1], wk.pose, tid);
  __syncthreads();
  all_pass(true, true, wk.st[0][0], wk.st[0][1]);
  if (rank != 0) return;
  double* H = wk.H[cur];
  cost = assemble(wk, H, wk.g[cur]);
  if (NF == 30) {
    // H* = H22 - H12^T (H11 + 1e-6 I)^-1 H12, its upper triangle mirrored
    for (int e = tid; e < 120; e += kThreads) {
      int i, j;
      lower_of(e, i, j);
      const double a = H[NF * i + j] + (i == j ? 1e-6 : 0.0);
      wk.A[15 * i + j] = a;
    }
    __syncthreads();
    factor<15>(wk.A, wk.linv, wk.rpiv, wk.trail[0]);
    if (tid < 15) {   // column `tid` of H11^-1 H12
      double y[15];
#pragma unroll
      for (int c = 0; c < 15; ++c) {
        double b = H[NF * c + 15 + tid];
#pragma unroll
        for (int k = 0; k < c; ++k) b -= wk.A[15 * c + k] * y[k];
        y[c] = b * wk.linv[c];
      }
#pragma unroll
      for (int c = 14; c >= 0; --c) {
        double b = y[c];
#pragma unroll
        for (int k = c + 1; k < 15; ++k) b -= wk.A[15 * k + c] * y[k];
        y[c] = b * wk.linv[c];
      }
#pragma unroll
      for (int c = 0; c < 15; ++c) wk.Xs[15 * c + tid] = y[c];
    }
    __syncthreads();
    for (int e = tid; e < 120; e += kThreads) {
      int i, j;
      upper15_of(e, i, j);
      double a = 0.0;
      for (int k = 0; k < 15; ++k) a += H[NF * k + 15 + i] * wk.Xs[15 * k + j];
      const float v = static_cast<float>(H[NF * (15 + i) + 15 + j] - a);
      out[25 + 15 * i + j] = v;
      out[25 + 15 * j + i] = v;
    }
  } else {
    for (int e = tid; e < 225; e += kThreads) out[25 + e] = static_cast<float>(H[e]);
  }
  if (tid == 0) {
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
  TC2LI_LAP(8);
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
