// The visual-inertial(-LiDAR) window bundle adjustment (LocalLVIBA and the
// FullInertialBA): every LM iteration of one call on the device, no host
// sync.
//
// Replaces tc2li_slam_tpu/solver/inertial_ba.py:191 (lvi_ba): on the TPU one
// jit-compiled program whose iterations are a lax.scan (:335). Eager PyTorch
// ran a pass as ~8,300 device events (4e's window: P 6, 6 iterations, the
// BALM term): a [P, P, 15, 15] accumulate, one-hot einsums and a dense solve
// an iteration.
//
// What it computes is the plain version's (ops/kernels/lvi_ba.py:
// lvi_ba_plain). The window's P keyframe states [T_wb | v | bg | ba] (15
// dims, the pose tangent (rho, phi) on the right, T_wb <- T_wb exp(xi)),
// the landmarks X [L] and their observation table [L, K] seen through the
// camera-from-body extrinsic T_cb; the P - 1 IMU preintegration factors with
// their bias random walks between consecutive states; optionally the BALM
// eigen-factor over the first NL poses as a dense pose quadratic Hb, gb, cb
// linearised at the entry (the wrapper computes it). The cost at the entry
// (visual + IMU + cb), lam = 1e-3, then `iters` times
//   - per observation the reprojection residual X_c = T_cb T_bw X, its pose
//     Jacobian Jproj R_cb [-I | hat(X_b)] and landmark Jacobian
//     Jproj R_cb R_bw, the weight w = inv_sigma2 * huber * (valid & depth
//     ok); per landmark Hll, gl and B_k, the damped block Hll + lam diag(Hll)
//     + 1e-6 I inverted in closed form, times valid_lm (as local_ba.cu);
//   - the reduced system over the free states: the 6x6 visual blocks
//     Hpp - sum_l B Hll^-1 B^T and gp - sum_l B Hll^-1 gl in each pose's
//     first six rows, plus each IMU factor's 15x15 blocks (i, i), (i, i + 1),
//     (i + 1, i), (i + 1, i + 1) with its bias random walk, plus Hb and
//     gb + Hb xi on the BALM poses; only then lam |diag| + 1e-8 on the
//     diagonal (the plain version's order: the abs and the IMU blocks inside
//     the damping change the step). Fixed states' rows, zero but for a unit
//     diagonal there, are left out: that changes the free states' step only
//     by rounding. Padded slots are fixed: their state is copied through
//     T exp(0) = T, bit for bit;
//   - the Jacobi-scaled system solved by Gauss-Jordan elimination with
//     partial pivoting (local_ba.cu's solve on 15-dim blocks), dx = -x on
//     free states, the candidate T exp(dx_pose), v + dv, bg + dbg, ba + dba,
//     xi + dx_pose on the BALM poses; dl = -Hll^-1 (gl + sum_k B_k^T dp_k);
//   - the candidate's cost, visual + IMU + cb + gb xi + xi^T Hb xi / 2,
//     accepted when strictly lower (lam x 0.5), else lam x 4;
// then the inlier flags (active and chi2 <= its gate) at the final state.
// There is no exit revert: the plain version has none. A non-finite input
// makes the entry cost NaN and no candidate is accepted: the result is the
// entry state.
// Precision: each observation's terms are float32, as there; the sums over
// observations and landmarks, the 3x3 inverses, the IMU factors (residual,
// Jacobians and blocks from the float32 state; imu_factor.cuh, the chain
// pose_inertial.cu uses), the assembly, the elimination and every cost are
// float64. IMU information of 1e6 and more sits beside O(1) visual terms in
// one system: the float32 plain version is farther from the float64 truth
// than this kernel (chip_smoke.vi_agreement's rule holds it).
//
// Bound on the H100: latency. At P 6, L 8192, K 8 an iteration reads
// ~1.4 MB of observations and does ~60 M operations (a few microseconds of
// either); its steps are serial and the solve's columns are too.
// Design: a fixed sequence of launches on the caller's stream, every sum in
// an order that depends only on the inputs (the same bits on every call):
//   init (landmark grid + P - 1 factor blocks): X = X0 and the entry
//        visual cost's per-block sums; a block a factor: the factor's
//        blocks, gradient and cost at the entry state (IMU slot 0);
//   commit: the entry state and cost;
//   per iteration
//   build (observation grid, G lanes a landmark): as local_ba.cu, with the
//        body-frame Jacobians;
//   reduce (a warp a chunk of local_ba.pair_table): local_ba.cu's
//        (schur.cuh reduce_chunks);
//   solve (a cluster of 8 blocks): the free states numbered by a prefix sum
//        over `fixed`; each entry of the damped system read from the visual
//        blocks' folded rows, the accepted IMU slot's factor blocks and Hb;
//        Gauss-Jordan with partial pivoting, in block 0 alone up to 96 free
//        rows, else as row slabs over the cluster (one cluster barrier a
//        column); block 0 takes the candidate state and the BALM model cost;
//   eval (landmark grid + P - 1 factor blocks): dl, X_new, the candidate's
//        visual cost per block; the factors at the candidate into the IMU
//        slot the accepted state does not use;
//   commit (landmark grid): every block adds the per-block visual sums and
//        the factors' costs in order (the same bits in every block), decides
//        and moves its landmarks; block 0 writes the next state (two slots)
//        with the IMU slot it uses, and the outputs; the last commit writes
//        the inlier flags at the final state.
// 2 + 5 iters launches a call. The solve's shared memory grows with 15P and
// caps P at kMaxPoses (27): a larger window is refused and reported.

#include <climits>
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "imu_factor.cuh"
#include "schur.cuh"

namespace cg = cooperative_groups;

namespace {

using tc2li::Cam;

constexpr int kLmThreads = 128;
constexpr int kReduceWarps = 4;  // warps a block of the reduce launch
constexpr int kSolveThreads = 512;
constexpr int kCluster = 8;      // blocks of the solve's cluster
constexpr int kSharedD = 96;     // free rows up to which block 0 solves alone
constexpr int kDim = 15;         // a state's dims: (rho, phi), v, bg, ba
constexpr int kMaxPoses = 27;    // the solve's shared memory (lvi_ba.py MAX_POSES)
constexpr int kBlk = kDim * kDim;
// a factor's row of the table (ops/kernels/lvi_ba.py: FACTOR_FIELDS)
constexpr int kFdR = 0, kFdV = 9, kFdP = 12, kFJRg = 15, kFJVg = 24, kFJVa = 33, kFJPg = 42,
              kFJPa = 51, kFdt = 60, kFC = 61, kFbg = 142, kFba = 145, kFig = 148, kFia = 149,
              kFvalid = 150, kFac = 151;

struct Problem {
  const float* T0;        // [P, 4, 4] T_wb
  const float* V0;        // [P, 3]
  const float* BG0;       // [P, 3]
  const float* BA0;       // [P, 3]
  const float* X0;        // [L, 3]
  const int* pidx;        // [L, K]
  const float* uv;        // [L, K, 3]
  const float* is2;       // [L, K]
  const uint8_t* stereo;  // [L, K]
  const uint8_t* valid;   // [L, K]
  const uint8_t* fixed;   // [P]
  const uint8_t* vlm;     // [L]
  const float* Tcb;       // [4, 4]
  const float* fac;       // [P - 1, kFac]
  const float* grav;      // [3]
  const float* Hb;        // [6 NL, 6 NL] or null
  const float* gb;        // [6 NL]
  const float* cb;        // [1]
  int L, K, P, D, NL;     // D = 15 P; NL the BALM poses (0 without)
  int G;                  // lanes a landmark in the build: the power of two >= K
  int gridL;              // landmark blocks of the init, eval and commit launches
  int oV, oBG, oBA, oXi, oLam, S;   // a state slot's layout (floats)
  Cam cam;
};


// a state slot (floats): T [16 P], v, bg, ba [3 P] each, xi [6 max(NL, 1)],
// lam; its cost in float64 beside it (Work::cost) and the IMU slot that holds
// its factors' terms (Work::sel)
struct Work {
  double* part;     // [chunks, kPart] each chunk's sums
  double* Hinv;     // [L, 9]
  double* gl;       // [L, 3]
  double* W;        // [L, K, 18] B Hll^-1 (0 where w = 0 or the landmark is invalid)
  double* gd;       // [L, K, 6] gp - W gl (0 where w = 0)
  double* partial;  // [gridL] per-block visual cost sums
  float* B;         // [L, K, 18]
  float* Hd;        // [L, K, 36] Hpp's term (0 where w = 0)
  float* X;         // [L, 3] the accepted landmarks (the output)
  float* Xc;        // [L, 3] the candidate's
  float* dx;        // [D] the candidate's step
  float* cand;      // [S] the candidate state (a slot's layout; lam unused)
  double* model;    // [1] the candidate's BALM model cost
  double* imuH[2];  // [P - 1, 3, 225] a factor's blocks (i, i), (i, i + 1), (i + 1, i + 1)
  double* imug[2];  // [P - 1, 30] its gradient at i, then at i + 1
  double* imuc[2];  // [P - 1] its cost
  float* state[2];
  double* cost[2];  // [1] with state[i]
  int* sel;         // [2] the IMU slot of state[i]
  float* T_out;     // [16 P]
  float* V_out;     // [3 P]
  float* BG_out;    // [3 P]
  float* BA_out;    // [3 P]
  float* scal;      // [1] the cost
  uint8_t* inlier;  // [L, K]
  uint8_t* live;    // [L, K] w != 0 (NaN counts as live)
  int* done;        // [nb] chunks of each block summed so far (0 between launches)
};


// T_bw = se3_inverse(T_wb) of each pose, its top rows (12 a pose), float32
// as geom/lie.py computes it; and T_cb's top rows. The whole block; ends on a
// barrier.
__device__ void body_poses(const Problem& pr, const float* Tw, float* Tbw, float* Tcb) {
  for (int p = threadIdx.x; p < pr.P; p += blockDim.x) {
    const float* T = Tw + 16 * p;
    float* A = Tbw + 12 * p;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
      for (int j = 0; j < 3; ++j) A[4 * i + j] = T[4 * j + i];
      A[4 * i + 3] = -(T[i] * T[3] + T[4 + i] * T[7] + T[8 + i] * T[11]);
    }
  }
  for (int e = threadIdx.x; e < 12; e += blockDim.x) Tcb[e] = pr.Tcb[e];
  __syncthreads();
}

// ... the same in float64 from the float32 T_wb (the costs)
__device__ void body_poses_d(const Problem& pr, const float* Tw, double* Tbw) {
  for (int p = threadIdx.x; p < pr.P; p += blockDim.x) {
    const float* T = Tw + 16 * p;
    double* A = Tbw + 12 * p;
    for (int i = 0; i < 3; ++i) {
      for (int j = 0; j < 3; ++j) A[4 * i + j] = T[4 * j + i];
      A[4 * i + 3] = -(static_cast<double>(T[i]) * T[3] + static_cast<double>(T[4 + i]) * T[7] +
                       static_cast<double>(T[8 + i]) * T[11]);
    }
  }
}

// One observation: residual, weight and Jacobians.
struct Obs {
  float r[3];
  float w;
  float zc, chi2, thr;
  float J[3][6];
  float Jl[3][3];
};

// body_reprojection: X_b = T_bw X, X_c = T_cb X_b; J_pose = JR [-I |
// hat(X_b)] and J_lm = JR R_bw with JR = Jproj R_cb (the mono row 0)
__device__ __forceinline__ void observe(const Problem& pr, const float* Tbw, const float* Tcb, int o,
                                        float x, float y, float z, Obs& ob) {
  const float* A = Tbw + 12 * clamp_pose(pr.pidx[o], pr.P);
  const float xb = A[0] * x + A[1] * y + A[2] * z + A[3];
  const float yb = A[4] * x + A[5] * y + A[6] * z + A[7];
  const float zb = A[8] * x + A[9] * y + A[10] * z + A[11];
  const bool st = pr.stereo[o] != 0;
  const tc2li::Reproj rp = tc2li::reproject(Tcb, xb, yb, zb, pr.uv + 3 * o, st, pr.cam);
  const float is2 = pr.is2[o];
  ob.chi2 = is2 * (rp.r[0] * rp.r[0] + rp.r[1] * rp.r[1] + rp.r[2] * rp.r[2]);
  ob.thr = st ? tc2li::kChi2Stereo : tc2li::kChi2Mono;
  ob.zc = rp.zc;
  const bool active = pr.valid[o] != 0 && rp.zc > 0.05f;
  ob.w = is2 * tc2li::huber(ob.chi2, ob.thr) * (active ? 1.f : 0.f);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    ob.r[k] = rp.r[k];
    float JR[3];
#pragma unroll
    for (int m = 0; m < 3; ++m)
      JR[m] = rp.a[k][0] * Tcb[m] + rp.a[k][1] * Tcb[4 + m] + rp.a[k][2] * Tcb[8 + m];
    ob.J[k][0] = -JR[0];
    ob.J[k][1] = -JR[1];
    ob.J[k][2] = -JR[2];
    ob.J[k][3] = JR[0] * 0.f + JR[1] * zb + JR[2] * (-yb);
    ob.J[k][4] = JR[0] * (-zb) + JR[1] * 0.f + JR[2] * xb;
    ob.J[k][5] = JR[0] * yb + JR[1] * (-xb) + JR[2] * 0.f;
#pragma unroll
    for (int j = 0; j < 3; ++j) ob.Jl[k][j] = JR[0] * A[j] + JR[1] * A[4 + j] + JR[2] * A[8 + j];
  }
}

// the visual cost w |r|^2 of one landmark's observations, in float64 from
// the float32 state (Tbw in float64 from the float32 T_wb)
__device__ double landmark_cost(const Problem& pr, const double* Tbw, const float* Tcb, int l,
                                float x, float y, float z) {
  using D = double;
  D c = 0.0;
  for (int k = 0; k < pr.K; ++k) {
    const int o = l * pr.K + k;
    const bool st = pr.stereo[o] != 0;
    const D* A = Tbw + 12 * clamp_pose(pr.pidx[o], pr.P);
    const D xb = A[0] * x + A[1] * y + A[2] * z + A[3];
    const D yb = A[4] * x + A[5] * y + A[6] * z + A[7];
    const D zb = A[8] * x + A[9] * y + A[10] * z + A[11];
    const D xc = D(Tcb[0]) * xb + D(Tcb[1]) * yb + D(Tcb[2]) * zb + D(Tcb[3]);
    const D yc = D(Tcb[4]) * xb + D(Tcb[5]) * yb + D(Tcb[6]) * zb + D(Tcb[7]);
    const D zc = D(Tcb[8]) * xb + D(Tcb[9]) * yb + D(Tcb[10]) * zb + D(Tcb[11]);
    const D zs = fabs(zc) < 1e-9 ? 1e-9 : zc;
    const D u = D(pr.cam.fx) * xc / zs + D(pr.cam.cx);
    const D v = D(pr.cam.fy) * yc / zs + D(pr.cam.cy);
    const float* uv = pr.uv + 3 * o;
    const D r0 = u - uv[0], r1 = v - uv[1];
    const D r2 = st ? (u - D(pr.cam.bf) / zs) - uv[2] : 0.0;
    const D is2 = pr.is2[o];
    const D rr = r0 * r0 + r1 * r1 + r2 * r2;
    const D chi2 = is2 * rr;
    const D thr = st ? D(tc2li::kChi2Stereo) : D(tc2li::kChi2Mono);
    const bool active = pr.valid[o] != 0 && zc > 0.05;
    const D hub = chi2 <= thr ? 1.0 : sqrt(thr / (chi2 < 1e-12 ? 1e-12 : chi2));
    c += is2 * hub * (active ? 1.0 : 0.0) * rr;
  }
  return c;
}


// ---------------------------------------------------------------------------
// the IMU factors (a block of kLmThreads a factor)
// ---------------------------------------------------------------------------

// the intermediates imu_factor.cuh's imu_pre, j1_entry and j2_entry use,
// and the factor's products, in shared memory
struct ImuWork {
  Pre pre;
  double grav[3];
  double r[9], rw[6], R1[9], R2[9], eR[9], iJ[9], Rdv[3], Rdp[3];
  double J1[135], J2[135], IJ1[135], IJ2[135], info[81], Ir[9];
  double rb[6];     // the random walks' residuals bg_{i+1} - bg_i, ba_{i+1} - ba_i
  double wg, wa;    // their information times the factor's validity
  State a, s2;      // state i; state i + 1 with state i's biases
  float row[kFac];  // the factor's row of the table
};

__device__ void load_state(const Problem& pr, const float* st, int p, State& o) {
  for (int e = 0; e < 16; ++e) o.T[e] = st[16 * p + e];
  for (int k = 0; k < 3; ++k) {
    o.v[k] = st[pr.oV + 3 * p + k];
    o.bg[k] = st[pr.oBG + 3 * p + k];
    o.ba[k] = st[pr.oBA + 3 * p + k];
  }
}

// Factor f between states f and f + 1 of the slot `st` (solver/inertial_ba.py
// _imu_terms): the residual corrected at state f's biases, J1 [9, 15] on
// state f (its bias columns J_bg, J_ba), J2 on state f + 1 (no bias
// columns), info = C^-1 valid; H[0] = J1^T I J1 + Hrw, H[1] = J1^T I J2 - Hrw,
// H[2] = J2^T I J2 + Hrw; g[0:15] = (I J1)^T r - grw, g[15:30] = (I J2)^T r
// + grw; c = r^T I r + wg |rbg|^2 + wa |rba|^2. The whole block.
__device__ void imu_factor(const Problem& pr, const float* st, int f, ImuWork& wk, double* H,
                           double* g, double* c) {
  const int tid = threadIdx.x;
  const float* row = pr.fac + static_cast<size_t>(f) * kFac;
  for (int e = tid; e < kFac; e += blockDim.x) wk.row[e] = row[e];
  __syncthreads();
  if (tid == 0) {
    const float* q = wk.row;
    Pre& p = wk.pre;
    for (int e = 0; e < 9; ++e) {
      p.dR[e] = q[kFdR + e];
      p.JRg[e] = q[kFJRg + e];
      p.JVg[e] = q[kFJVg + e];
      p.JVa[e] = q[kFJVa + e];
      p.JPg[e] = q[kFJPg + e];
      p.JPa[e] = q[kFJPa + e];
    }
    for (int k = 0; k < 3; ++k) {
      p.dV[k] = q[kFdV + k];
      p.dP[k] = q[kFdP + k];
      p.bg[k] = q[kFbg + k];
      p.ba[k] = q[kFba + k];
      wk.grav[k] = pr.grav[k];
    }
    p.dt = q[kFdt];
    const double w = q[kFvalid];
    wk.wg = static_cast<double>(q[kFig]) * w;
    wk.wa = static_cast<double>(q[kFia]) * w;
    load_state(pr, st, f, wk.a);
    load_state(pr, st, f + 1, wk.s2);
    for (int k = 0; k < 3; ++k) {
      wk.rb[k] = wk.s2.bg[k] - wk.a.bg[k];
      wk.rb[3 + k] = wk.s2.ba[k] - wk.a.ba[k];
      wk.s2.bg[k] = wk.a.bg[k];
      wk.s2.ba[k] = wk.a.ba[k];
    }
  }
  __syncthreads();
  if (tid == 0 || tid == 32) imu_pre(wk, wk.a, wk.s2, tid == 0);
  __syncthreads();
  for (int e = tid; e < 2 * 135 + 81; e += blockDim.x) {
    if (e < 135) {
      const int i = e / kDim, j = e % kDim;
      wk.J1[e] = j < 9 ? j1_entry(wk, i, j) : j2_entry(wk, i, j);
    } else if (e < 270) {
      const int i = (e - 135) / kDim, j = (e - 135) % kDim;
      wk.J2[e - 135] = j < 9 ? j2_entry(wk, i, j) : 0.0;
    } else {
      wk.info[e - 270] = static_cast<double>(wk.row[kFC + e - 270]) * wk.row[kFvalid];
    }
  }
  __syncthreads();
  for (int e = tid; e < 2 * 135 + 9; e += blockDim.x) {
    if (e < 270) {
      const double* J = e < 135 ? wk.J1 : wk.J2;
      const int i = (e % 135) / kDim, j = (e % 135) % kDim;
      double s = 0.0;
      for (int m = 0; m < 9; ++m) s += wk.info[9 * i + m] * J[kDim * m + j];
      double* IJ = e < 135 ? wk.IJ1 : wk.IJ2;
      IJ[e % 135] = s;
    } else {
      const int i = e - 270;
      double s = 0.0;
      for (int m = 0; m < 9; ++m) s += wk.info[9 * i + m] * wk.r[m];
      wk.Ir[i] = s;
    }
  }
  __syncthreads();
  for (int e = tid; e < 3 * kBlk + 30; e += blockDim.x) {
    if (e < 3 * kBlk) {
      const int b = e / kBlk, j = (e % kBlk) / kDim, k = (e % kBlk) % kDim;
      const double* Ja = b == 2 ? wk.J2 : wk.J1;
      const double* IJ = b == 0 ? wk.IJ1 : wk.IJ2;
      double s = 0.0;
      for (int i = 0; i < 9; ++i) s += Ja[kDim * i + j] * IJ[kDim * i + k];
      const double rw = j != k ? 0.0 : (j >= 12 ? wk.wa : (j >= 9 ? wk.wg : 0.0));
      H[e] = b == 1 ? s - rw : s + rw;
    } else {
      const int b = (e - 3 * kBlk) / kDim, j = (e - 3 * kBlk) % kDim;
      const double* IJ = b == 0 ? wk.IJ1 : wk.IJ2;
      double s = 0.0;
      for (int i = 0; i < 9; ++i) s += IJ[kDim * i + j] * wk.r[i];
      const double grw = j >= 12 ? wk.wa * wk.rb[j - 9] : (j >= 9 ? wk.wg * wk.rb[j - 9] : 0.0);
      g[e - 3 * kBlk] = b == 0 ? s - grw : s + grw;
    }
  }
  if (tid == 0) {
    double s = 0.0;
    for (int i = 0; i < 9; ++i) s += wk.r[i] * wk.Ir[i];
    double rg = 0.0, ra = 0.0;
    for (int k = 0; k < 3; ++k) {
      rg += wk.rb[k] * wk.rb[k];
      ra += wk.rb[3 + k] * wk.rb[3 + k];
    }
    *c = (s + wk.wg * rg) + wk.wa * ra;
  }
}

__device__ __forceinline__ void imu_slot_of(const Work& wk, int s, int f,
                                            double*& H, double*& g, double*& c) {
  H = wk.imuH[s] + static_cast<size_t>(f) * 3 * kBlk;
  g = wk.imug[s] + static_cast<size_t>(f) * 30;
  c = wk.imuc[s] + f;
}

// ---------------------------------------------------------------------------
// the launches
// ---------------------------------------------------------------------------

// (init) X = X0 and the entry's per-block visual cost sums; a factor a block
// past the landmark grid, at the entry state, into IMU slot 0
__global__ void __launch_bounds__(kLmThreads) init_kernel(const Problem pr, Work wk) {
  extern __shared__ double smd[];
  __shared__ double red[kLmThreads / 32];
  if (static_cast<int>(blockIdx.x) >= pr.gridL) {   // a factor
    const int f = blockIdx.x - pr.gridL;
    double *H, *g, *c;
    imu_slot_of(wk, 0, f, H, g, c);
    // the entry state's slot: the inputs (T0, V0, BG0, BA0 in a slot's layout)
    float* st = reinterpret_cast<float*>(reinterpret_cast<ImuWork*>(smd) + 1);
    for (int e = threadIdx.x; e < 16 * pr.P; e += blockDim.x) st[e] = pr.T0[e];
    for (int e = threadIdx.x; e < 3 * pr.P; e += blockDim.x) {
      st[pr.oV + e] = pr.V0[e];
      st[pr.oBG + e] = pr.BG0[e];
      st[pr.oBA + e] = pr.BA0[e];
    }
    __syncthreads();
    imu_factor(pr, st, f, *reinterpret_cast<ImuWork*>(smd), H, g, c);
    return;
  }
  double* Tbw = smd;
  float* Tcb = reinterpret_cast<float*>(Tbw + 12 * pr.P);
  body_poses_d(pr, pr.T0, Tbw);
  for (int e = threadIdx.x; e < 12; e += blockDim.x) Tcb[e] = pr.Tcb[e];
  __syncthreads();
  double c = 0.0;
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l < pr.L) {
    const float x = pr.X0[3 * l], y = pr.X0[3 * l + 1], z = pr.X0[3 * l + 2];
    wk.X[3 * l] = x;
    wk.X[3 * l + 1] = y;
    wk.X[3 * l + 2] = z;
    c = landmark_cost(pr, Tbw, Tcb, l, x, y, z);
  }
  const double s = block_sum(c, red);
  if (threadIdx.x == 0) wk.partial[blockIdx.x] = s;
  for (int b = l; b < pr.P * (pr.P + 1) / 2; b += pr.gridL * blockDim.x) wk.done[b] = 0;
}

// (build) each landmark's normal equations at the accepted state and the
// per-observation terms of the reduced system (local_ba.cu's build with the
// body-frame observation)
__global__ void __launch_bounds__(kLmThreads) build_kernel(const Problem pr, Work wk, int slot) {
  extern __shared__ float sm[];
  float* Tbw = sm;
  float* Tcb = sm + 12 * pr.P;
  const float* st = wk.state[slot];
  body_poses(pr, st, Tbw, Tcb);
  const float lam = st[pr.oLam];
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int l = t / pr.G, k = t % pr.G;   // G divides 32: a landmark's lanes share a warp
  const bool on = l < pr.L && k < pr.K;
  const int o = on ? l * pr.K + k : 0;
  double Hll[9] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
  double gl[3] = {0.0, 0.0, 0.0};
  float B[18];
  double gp[6];
  bool live = false, listed = false;
  if (on) {
    Obs ob;
    observe(pr, Tbw, Tcb, o, wk.X[3 * l], wk.X[3 * l + 1], wk.X[3 * l + 2], ob);
    float Jp[3][6];
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
      for (int j = 0; j < 6; ++j) Jp[r][j] = ob.J[r][j] * ob.w;
    live = !(ob.w == 0.f);   // NaN counts as live
    wk.live[o] = live;
    listed = pr.valid[o] != 0 && !pr.fixed[clamp_pose(pr.pidx[o], pr.P)];
#pragma unroll
    for (int j = 0; j < 6; ++j) {
#pragma unroll
      for (int m = 0; m < 3; ++m)
        B[3 * j + m] = Jp[0][j] * ob.Jl[0][m] + Jp[1][j] * ob.Jl[1][m] + Jp[2][j] * ob.Jl[2][m];
      gp[j] = static_cast<double>(Jp[0][j] * ob.r[0] + Jp[1][j] * ob.r[1] + Jp[2][j] * ob.r[2]);
    }
    float2* Bo = reinterpret_cast<float2*>(wk.B + static_cast<size_t>(o) * 18);
#pragma unroll
    for (int q = 0; q < 9; ++q) Bo[q] = make_float2(B[2 * q], B[2 * q + 1]);
    if (listed) {
      float H[36];
#pragma unroll
      for (int j = 0; j < 6; ++j)
#pragma unroll
        for (int c = 0; c < 6; ++c) {
          const float v = Jp[0][j] * ob.J[0][c] + Jp[1][j] * ob.J[1][c] + Jp[2][j] * ob.J[2][c];
          H[6 * j + c] = live ? v : 0.f;
        }
      float4* Ho = reinterpret_cast<float4*>(wk.Hd + static_cast<size_t>(o) * 36);
#pragma unroll
      for (int q = 0; q < 9; ++q) Ho[q] = make_float4(H[4 * q], H[4 * q + 1], H[4 * q + 2], H[4 * q + 3]);
    }
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float w0 = ob.Jl[0][j] * ob.w, w1 = ob.Jl[1][j] * ob.w, w2 = ob.Jl[2][j] * ob.w;
#pragma unroll
      for (int m = 0; m < 3; ++m) Hll[3 * j + m] = w0 * ob.Jl[0][m] + w1 * ob.Jl[1][m] + w2 * ob.Jl[2][m];
      gl[j] = w0 * ob.r[0] + w1 * ob.r[1] + w2 * ob.r[2];
    }
  }
#pragma unroll
  for (int e = 0; e < 12; ++e) {
    double v = e < 9 ? Hll[e] : gl[e - 9];
    for (int d = pr.G >> 1; d > 0; d >>= 1) v += __shfl_xor_sync(0xffffffffu, v, d);
    if (e < 9) Hll[e] = v; else gl[e - 9] = v;
  }
  if (!on) return;
  double A[9];
#pragma unroll
  for (int e = 0; e < 9; ++e) A[e] = Hll[e];
#pragma unroll
  for (int j = 0; j < 3; ++j) A[4 * j] = Hll[4 * j] + (lam * Hll[4 * j] + 1e-6);
  const double a = A[0], b = A[1], c = A[2], d = A[3], e = A[4], f = A[5];
  const double g_ = A[6], h = A[7], i = A[8];
  const double A00 = e * i - f * h, A01 = c * h - b * i, A02 = b * f - c * e;
  const double A10 = f * g_ - d * i, A11 = a * i - c * g_, A12 = c * d - a * f;
  const double A20 = d * h - e * g_, A21 = b * g_ - a * h, A22 = a * e - b * d;
  const double det = a * A00 + b * A10 + c * A20;
  const double inv_det = 1.0 / (fabs(det) > 1e-20 ? det : 1.0);
  const bool vl = pr.vlm[l] != 0;
  const double lmw = vl ? 1.0 : 0.0;
  const double Hi[9] = {A00 * inv_det * lmw, A01 * inv_det * lmw, A02 * inv_det * lmw,
                        A10 * inv_det * lmw, A11 * inv_det * lmw, A12 * inv_det * lmw,
                        A20 * inv_det * lmw, A21 * inv_det * lmw, A22 * inv_det * lmw};
  if (k == 0) {
#pragma unroll
    for (int q = 0; q < 9; ++q) wk.Hinv[9 * l + q] = Hi[q];
#pragma unroll
    for (int q = 0; q < 3; ++q) wk.gl[3 * l + q] = gl[q];
  }
  if (!listed) return;
  const bool schur = live && vl;
  double W[18];
#pragma unroll
  for (int r = 0; r < 6; ++r)
#pragma unroll
    for (int m = 0; m < 3; ++m) {
      const double v = B[3 * r] * Hi[m] + B[3 * r + 1] * Hi[3 + m] + B[3 * r + 2] * Hi[6 + m];
      W[3 * r + m] = schur ? v : 0.0;
    }
  double2* Wo = reinterpret_cast<double2*>(wk.W + static_cast<size_t>(o) * 18);
#pragma unroll
  for (int q = 0; q < 9; ++q) Wo[q] = make_double2(W[2 * q], W[2 * q + 1]);
  double gd[6];
#pragma unroll
  for (int r = 0; r < 6; ++r) {
    const double v = gp[r] - (W[3 * r] * gl[0] + W[3 * r + 1] * gl[1] + W[3 * r + 2] * gl[2]);
    gd[r] = live ? v : 0.0;
  }
  double2* go = reinterpret_cast<double2*>(wk.gd + static_cast<size_t>(o) * 6);
#pragma unroll
  for (int q = 0; q < 3; ++q) go[q] = make_double2(gd[2 * q], gd[2 * q + 1]);
}

// (reduce) a warp a chunk of the pair table (schur.cuh reduce_chunks)
__global__ void __launch_bounds__(kReduceWarps * 32) reduce_kernel(const Table tb, Work wk) {
  reduce_chunks<kReduceWarps>(tb, wk);
}

// the solve's view of the assembled system: free row r (15 a free state)
struct Assembly {
  const double* part;
  const long long* cstart;
  const int* fpose;   // [free states] the state of each free index
  const double* H;    // the accepted IMU slot's blocks [P - 1, 3, 225]
  const double* g;    // ... and gradients [P - 1, 30]
  const float* Hb;    // [6 NL, 6 NL] or null
  const float* gb;
  const double* xi;   // [6 NL] the accepted tangent of the BALM poses
  int P, NL;
  double lam;

  // entry (i, j) of the visual block (pa, pb), or its row 36 + i of g (j < 0)
  __device__ double vis(int pa, int pb, int i, int j) const {
    if (pa > pb) {   // the lower blocks are the upper ones transposed
      const int t = pa; pa = pb; pb = t;
      const int u = i; i = j; j = u;
    }
    const int b = block_of(pa, pb, P);
    return cstart[b] < cstart[b + 1] ? part[static_cast<size_t>(cstart[b]) * kPart + 6 * i + j] : 0.0;
  }
  // the undamped entry (r, c): IMU blocks, then the visual block, then Hb,
  // as the plain version adds them
  __device__ double A(int r, int c) const {
    const int pa = fpose[r / kDim], pb = fpose[c / kDim], i = r % kDim, j = c % kDim;
    double a = 0.0;
    if (pa == pb) {
      if (pa < P - 1) a = a + H[(static_cast<size_t>(pa) * 3) * kBlk + kDim * i + j];
      if (pa > 0) a = a + H[(static_cast<size_t>(pa - 1) * 3 + 2) * kBlk + kDim * i + j];
    } else if (pb == pa + 1) {
      a = H[(static_cast<size_t>(pa) * 3 + 1) * kBlk + kDim * i + j];
    } else if (pa == pb + 1) {
      a = H[(static_cast<size_t>(pb) * 3 + 1) * kBlk + kDim * j + i];
    }
    if (i < 6 && j < 6) a = a + vis(pa, pb, i, j);
    if (Hb && pa < NL && pb < NL && i < 6 && j < 6)
      a = a + static_cast<double>(Hb[(6 * pa + i) * 6 * NL + 6 * pb + j]);
    return a;
  }
  // the damped entry: + lam |a| + 1e-8 on the diagonal
  __device__ double M(int r, int c) const {
    double a = A(r, c);
    if (r == c) {
      a = a + lam * fabs(a);
      a = a + 1e-8;
    }
    return a;
  }
  __device__ double rhs(int r) const {
    const int p = fpose[r / kDim], i = r % kDim;
    double s = 0.0;
    if (p < P - 1) s = s + g[static_cast<size_t>(p) * 30 + i];
    if (p > 0) s = s + g[static_cast<size_t>(p - 1) * 30 + kDim + i];
    if (i < 6) {
      const int b = block_of(p, p, P);
      s = s + (cstart[b] < cstart[b + 1] ? part[static_cast<size_t>(cstart[b]) * kPart + 36 + i] : 0.0);
    }
    if (Hb && p < NL && i < 6) {
      const int R = 6 * p + i;
      double gx = 0.0;
      for (int c = 0; c < 6 * NL; ++c) gx += static_cast<double>(Hb[R * 6 * NL + c]) * xi[c];
      s = s + (static_cast<double>(gb[R]) + gx);
    }
    return s;
  }
};

// (solve) local_ba.cu's cluster solve on 15-dim blocks: the free states'
// damped system, Jacobi-scaled, reduced by Gauss-Jordan elimination with
// partial pivoting (schur.cuh gauss_jordan: the first largest |a| by
// position among the rows not yet pivots; a NaN never wins); block 0 then
// takes the candidate state and its BALM model cost. Up to kSharedD free rows block 0 holds the whole system;
// beyond, block q holds rows [q R, q R + R) and each column takes one
// cluster barrier (the candidate rows exchanged through distributed shared
// memory). (A thread an entry of the trailing columns, in place of a warp a
// row, was slower on an H100 80GB HBM3 at 700 W: 0.99 against 0.72 ms for a
// call's 6 solves of 75 rows, 11.7 against 7.6 for 10 of 285.)
__global__ void __launch_bounds__(kSolveThreads) solve_kernel(const Problem pr, const Table tb,
                                                              Work wk, int slot) {
  extern __shared__ double smd[];
  __shared__ double red[kSolveThreads / 32];
  __shared__ int fpose[32], fidx[32];
  __shared__ int s_nf;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const float* st = wk.state[slot];
  const int D = pr.D, NX = 6 * (pr.NL > 0 ? pr.NL : 1), tid = threadIdx.x, lane = tid & 31,
            warp = tid >> 5;
  const float* xi_cur = st + pr.oXi;
  const int rows_max = (D + kCluster - 1) / kCluster, cw = D + 5;
  const int m_elems = max(kSharedD * (kSharedD + 1), rows_max * (D + 1));
  double* M = smd;
  double* cand = M + m_elems;
  double* dsc = cand + 2 * kCluster * cw;
  double* x = dsc + D;
  double* xi = x + D;
  int* pos2row = reinterpret_cast<int*>(xi + NX);
  int* row2pos = pos2row + D;
  for (int p = tid; p < pr.P; p += blockDim.x) fidx[p] = pr.fixed[p];
  for (int e = tid; e < NX; e += blockDim.x) xi[e] = xi_cur[e];
  __syncthreads();
  if (tid == 0) {   // the free states, numbered by a prefix sum over `fixed`
    int n = 0;
    for (int p = 0; p < pr.P; ++p) {
      const bool fixed = fidx[p] != 0;
      fidx[p] = fixed ? -1 : n;
      if (!fixed) fpose[n++] = p;
    }
    s_nf = n;
  }
  __syncthreads();
  const int Df = kDim * s_nf, Wd = Df + 1;
  const bool multi = Df > kSharedD;
  if (!multi && rank != 0) return;
  const int R = multi ? (Df + kCluster - 1) / kCluster : Df;
  const int r0 = multi ? rank * R : 0, nloc = max(min(r0 + R, Df) - r0, 0);
  const int isel = wk.sel[slot];
  const Assembly as{wk.part, tb.cstart, fpose, wk.imuH[isel], wk.imug[isel], pr.Hb, pr.gb, xi,
                    pr.P, pr.NL, static_cast<double>(st[pr.oLam])};
  for (int r = tid; r < Df; r += blockDim.x) {   // every block scales every column
    const double a = fabs(as.M(r, r));
    dsc[r] = sqrt(a < 1e-12 ? 1e-12 : a);   // Jacobi scaling (lm.precond_solve)
    pos2row[r] = r;
    row2pos[r] = r;
  }
  __syncthreads();
  for (int i = warp; i < nloc; i += kSolveThreads / 32) {   // local row i is row r0 + i
    const int r = r0 + i;
    for (int c = lane; c < Wd; c += 32)
      M[i * Wd + c] = c < Df ? as.M(r, c) / (dsc[r] * dsc[c]) : as.rhs(r) / dsc[r];
  }
  __syncthreads();
  gauss_jordan<kSolveThreads, kCluster>(cluster, M, cand, pos2row, row2pos, Df, cw, r0,
                                       nloc, multi, rank);
  double* x0 = multi ? cluster.map_shared_rank(x, 0) : x;
  for (int i = tid; i < nloc; i += blockDim.x) {
    const int c = row2pos[r0 + i];
    x0[c] = M[i * Wd + Df] / M[i * Wd + c];
  }
  if (multi) {
    cluster.sync();   // x is whole in block 0
    if (rank != 0) return;
  } else {
    __syncthreads();
  }
  // the step (0 on fixed states), then the candidate state
  for (int r = tid; r < D; r += blockDim.x) {
    const int f = fidx[r / kDim];
    wk.dx[r] = f < 0 ? 0.f
                     : static_cast<float>(-(x[kDim * f + r % kDim] / dsc[kDim * f + r % kDim]));
  }
  __syncthreads();
  float* cs = wk.cand;
  for (int e = tid; e < 16 * pr.P; e += blockDim.x) {   // T_wb exp(dx_pose), an entry a thread
    const int p = e / 16, i = (e % 16) / 4, j = e % 4;
    const tc2li::Se3Exp ex = tc2li::se3_exp_coef(wk.dx + kDim * p);
    const float* T = st + 16 * p;
    float E[4][4];
#pragma unroll
    for (int k = 0; k < 4; ++k) tc2li::se3_exp_row(ex, k, E[k]);
    cs[e] = T[4 * i] * E[0][j] + T[4 * i + 1] * E[1][j] + T[4 * i + 2] * E[2][j] + T[4 * i + 3] * E[3][j];
  }
  for (int e = tid; e < 3 * pr.P; e += blockDim.x) {
    const int p = e / 3, k = e % 3;
    cs[pr.oV + e] = st[pr.oV + e] + wk.dx[kDim * p + 6 + k];
    cs[pr.oBG + e] = st[pr.oBG + e] + wk.dx[kDim * p + 9 + k];
    cs[pr.oBA + e] = st[pr.oBA + e] + wk.dx[kDim * p + 12 + k];
  }
  for (int e = tid; e < NX; e += blockDim.x)
    cs[pr.oXi + e] = pr.NL > 0 ? xi_cur[e] + wk.dx[kDim * (e / 6) + e % 6] : xi_cur[e];
  if (pr.Hb) {   // cb + gb . xi + xi^T Hb xi / 2 at the candidate
    __syncthreads();
    const int n = 6 * pr.NL;
    double part = 0.0, lin = 0.0;
    for (int r = tid; r < n; r += blockDim.x) {
      double hx = 0.0;
      for (int c = 0; c < n; ++c) hx += static_cast<double>(pr.Hb[r * n + c]) * cs[pr.oXi + c];
      part += cs[pr.oXi + r] * hx;
      lin += static_cast<double>(pr.gb[r]) * cs[pr.oXi + r];
    }
    const double q = block_sum(part, red);
    __syncthreads();
    const double gx = block_sum(lin, red);
    if (tid == 0) *wk.model = pr.cb[0] + gx + 0.5 * q;
  } else if (tid == 0) {
    *wk.model = 0.0;
  }
}

// (eval) the candidate's landmarks and the per-block sums of its visual
// cost; a factor a block past the landmark grid, at the candidate, into the
// IMU slot the accepted state does not use
__global__ void __launch_bounds__(kLmThreads) eval_kernel(const Problem pr, Work wk, int slot) {
  extern __shared__ double smd[];
  __shared__ double red[kLmThreads / 32];
  if (static_cast<int>(blockIdx.x) >= pr.gridL) {
    const int f = blockIdx.x - pr.gridL;
    double *H, *g, *c;
    imu_slot_of(wk, 1 - wk.sel[slot], f, H, g, c);
    imu_factor(pr, wk.cand, f, *reinterpret_cast<ImuWork*>(smd), H, g, c);
    return;
  }
  double* Tbw = smd;
  float* Tcb = reinterpret_cast<float*>(Tbw + 12 * pr.P);
  float* dp = Tcb + 12;
  body_poses_d(pr, wk.cand, Tbw);
  for (int e = threadIdx.x; e < 12; e += blockDim.x) Tcb[e] = pr.Tcb[e];
  for (int e = threadIdx.x; e < 6 * pr.P; e += blockDim.x) dp[e] = wk.dx[kDim * (e / 6) + e % 6];
  __syncthreads();
  double c = 0.0;
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l < pr.L) {
    double bt[3] = {0.0, 0.0, 0.0};
    for (int k = 0; k < pr.K; ++k) {
      const int o = l * pr.K + k;
      const int p = clamp_pose(pr.pidx[o], pr.P);
      const float* Bo = wk.B + static_cast<size_t>(o) * 18;
#pragma unroll
      for (int m = 0; m < 3; ++m) {
        double s = 0.0;
#pragma unroll
        for (int i = 0; i < 6; ++i) s += static_cast<double>(Bo[3 * i + m]) * dp[6 * p + i];
        bt[m] += s;
      }
    }
    const double* Hi = wk.Hinv + 9 * l;
    const double* gl = wk.gl + 3 * l;
    const double rhs[3] = {gl[0] + bt[0], gl[1] + bt[1], gl[2] + bt[2]};
    const double lmw = pr.vlm[l] ? 1.0 : 0.0;
    float Xn[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const double dl = -(Hi[3 * i] * rhs[0] + Hi[3 * i + 1] * rhs[1] + Hi[3 * i + 2] * rhs[2]) * lmw;
      Xn[i] = static_cast<float>(wk.X[3 * l + i] + dl);
      wk.Xc[3 * l + i] = Xn[i];
    }
    c = landmark_cost(pr, Tbw, Tcb, l, Xn[0], Xn[1], Xn[2]);
  }
  const double s = block_sum(c, red);
  if (threadIdx.x == 0) wk.partial[blockIdx.x] = s;
}

// (commit) accept or reject; slot `from` is read, the other written. init:
// the entry state from the inputs and the entry cost. last: the inlier
// flags at the state decided here.
__global__ void __launch_bounds__(kLmThreads) commit_kernel(const Problem pr, Work wk, int from,
                                                            int init, int last) {
  extern __shared__ float sm[];
  __shared__ double s_cand;
  __shared__ int s_acc;
  const float* cur = wk.state[from];
  float* nxt = wk.state[from ^ 1];
  const int src = init ? 0 : 1 - wk.sel[from];   // the IMU slot of the candidate
  if (threadIdx.x == 0) {
    double vis = 0.0;
    for (int b = 0; b < pr.gridL; ++b) vis += wk.partial[b];
    double imu = 0.0;
    for (int f = 0; f < pr.P - 1; ++f) imu += wk.imuc[src][f];
    const double c = vis + imu;
    s_cand = init ? (pr.Hb ? c + static_cast<double>(pr.cb[0]) : c) : c + *wk.model;
    s_acc = init ? 1 : (s_cand < wk.cost[from][0]);   // NaN rejects
  }
  __syncthreads();
  const bool acc = s_acc != 0;
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (!init && acc && l < pr.L)
    for (int i = 0; i < 3; ++i) wk.X[3 * l + i] = wk.Xc[3 * l + i];
  if (last) {   // the inlier flags at the final state
    float* Tbw = sm;
    float* Tcb = sm + 12 * pr.P;
    body_poses(pr, init ? pr.T0 : (acc ? wk.cand : cur), Tbw, Tcb);
    if (l < pr.L) {
      const float x = wk.X[3 * l], y = wk.X[3 * l + 1], z = wk.X[3 * l + 2];
      for (int k = 0; k < pr.K; ++k) {
        const int o = l * pr.K + k;
        Obs ob;
        observe(pr, Tbw, Tcb, o, x, y, z, ob);
        wk.inlier[o] = pr.valid[o] != 0 && ob.zc > 0.05f && ob.chi2 <= ob.thr;
      }
    }
  }
  if (blockIdx.x != 0) return;
  const float* from_st = init ? nullptr : (acc ? wk.cand : cur);
  for (int e = threadIdx.x; e < 16 * pr.P; e += blockDim.x) {
    const float t = init ? pr.T0[e] : from_st[e];
    nxt[e] = t;
    wk.T_out[e] = t;
  }
  for (int e = threadIdx.x; e < 3 * pr.P; e += blockDim.x) {
    const float v = init ? pr.V0[e] : from_st[pr.oV + e];
    const float bg = init ? pr.BG0[e] : from_st[pr.oBG + e];
    const float ba = init ? pr.BA0[e] : from_st[pr.oBA + e];
    nxt[pr.oV + e] = v;
    nxt[pr.oBG + e] = bg;
    nxt[pr.oBA + e] = ba;
    wk.V_out[e] = v;
    wk.BG_out[e] = bg;
    wk.BA_out[e] = ba;
  }
  for (int e = threadIdx.x; e < pr.oLam - pr.oXi; e += blockDim.x)
    nxt[pr.oXi + e] = init ? 0.f : from_st[pr.oXi + e];
  if (threadIdx.x == 0) {
    const double cost = acc ? s_cand : wk.cost[from][0];
    nxt[pr.oLam] = init ? 1e-3f : (acc ? cur[pr.oLam] * 0.5f : cur[pr.oLam] * 4.f);
    wk.cost[from ^ 1][0] = cost;
    wk.sel[from ^ 1] = init ? 0 : (acc ? src : wk.sel[from]);
    wk.scal[0] = static_cast<float>(cost);
  }
}

int grid_of(int L) { return L < 1 ? 1 : (L + kLmThreads - 1) / kLmThreads; }

size_t solve_smem(int P, int NL) {
  const int D = kDim * P, rows_max = (D + kCluster - 1) / kCluster;
  const int m_elems = rows_max * (D + 1) > kSharedD * (kSharedD + 1) ? rows_max * (D + 1)
                                                                     : kSharedD * (kSharedD + 1);
  const int NX = 6 * (NL > 0 ? NL : 1);
  return sizeof(double) * (static_cast<size_t>(m_elems) + 2 * kCluster * (D + 5) + 2 * D + NX) +
         sizeof(int) * 2 * D;
}

struct Layout {
  size_t Hinv, gl, W, gd, partial, B, Hd, Xc, dx, cand, model, imuH0, imuH1, imug0, imug1, imuc0,
      imuc1, state0, state1, cost0, cost1, sel, done, live, total;
};

Layout layout(int L, int K, int P, int NL) {
  const size_t D = kDim * static_cast<size_t>(P), LK = static_cast<size_t>(L) * K;
  const size_t F = P > 1 ? static_cast<size_t>(P - 1) : 1;
  const size_t slot = 25 * static_cast<size_t>(P) + 6 * static_cast<size_t>(NL > 0 ? NL : 1) + 1;
  size_t off = 0;
  auto take = [&off](size_t bytes) {
    const size_t at = off;
    off += (bytes + 15) / 16 * 16;
    return at;
  };
  Layout y;
  y.Hinv = take(8 * 9 * static_cast<size_t>(L));
  y.gl = take(8 * 3 * static_cast<size_t>(L));
  y.W = take(8 * 18 * LK);
  y.gd = take(8 * 6 * LK);
  y.partial = take(8 * static_cast<size_t>(grid_of(L)));
  y.B = take(4 * 18 * LK);
  y.Hd = take(4 * 36 * LK);
  y.Xc = take(4 * 3 * static_cast<size_t>(L));
  y.dx = take(4 * D);
  y.cand = take(4 * slot);
  y.model = take(8);
  y.imuH0 = take(8 * 3 * kBlk * F);
  y.imuH1 = take(8 * 3 * kBlk * F);
  y.imug0 = take(8 * 30 * F);
  y.imug1 = take(8 * 30 * F);
  y.imuc0 = take(8 * F);
  y.imuc1 = take(8 * F);
  y.state0 = take(4 * slot);
  y.state1 = take(4 * slot);
  y.cost0 = take(8);
  y.cost1 = take(8);
  y.sel = take(4 * 2);
  y.done = take(4 * (static_cast<size_t>(P) * (P + 1) / 2));
  y.live = take(LK);
  y.total = off;
  return y;
}

}  // namespace

// bytes of scratch a call takes (see tc2li_lvi_ba_lm)
extern "C" long long tc2li_lvi_ba_scratch(int L, int K, int P, int NL) {
  return static_cast<long long>(layout(L, K, P, NL).total);
}

// T0 [P, 4, 4], V0, BG0, BA0 [P, 3], X0 [L, 3], uv [L, K, 3], is2 [L, K],
// Tcb [4, 4], fac [P - 1, 151] (ops/kernels/lvi_ba.py: FACTOR_FIELDS), grav
// [3] float32; pidx [L, K] int32; stereo, valid [L, K], fixed [P], valid_lm
// [L] uint8 (0 or 1); Hb [6 NL, 6 NL], gb [6 NL], cb [1] float32 or all three
// null (NL 0); the pair table (ops/kernels/local_ba.py: pair_table) order
// [E], start, cstart [P (P + 1) / 2 + 1] int64, a block cut into at most
// `max_chunks` chunks of at least `chunk` pairs, and part [n_chunks, 42]
// float64 with n_chunks at least cstart's last entry; scratch of
// tc2li_lvi_ba_scratch(L, K, P, NL) bytes, 16-byte aligned; outputs T_out
// [P, 4, 4], V_out, BG_out, BA_out [P, 3], X_out [L, 3], scal [1] (the cost)
// float32, inlier [L, K] uint8. All contiguous on the device. Launches
// 2 + 5 iters kernels on `stream`; returns the first CUDA error code that is
// not cudaSuccess (a refused launch included: P above kMaxPoses).
extern "C" int tc2li_lvi_ba_lm(const float* T0, const float* V0, const float* BG0,
                               const float* BA0, const float* X0, const int* pidx,
                               const float* uv, const float* is2, const uint8_t* stereo,
                               const uint8_t* valid, const uint8_t* fixed,
                               const uint8_t* valid_lm, const float* Tcb, const float* fac,
                               const float* grav, const float* Hb, const float* gb,
                               const float* cb, const long long* pair_order,
                               const long long* pair_start, const long long* chunk_start,
                               double* part, int L, int K, int P, int NL, int n_chunks, int chunk,
                               int max_chunks, float fx, float fy, float cx, float cy, float bf,
                               int iters, void* scratch, float* T_out, float* V_out,
                               float* BG_out, float* BA_out, float* X_out, float* scal,
                               uint8_t* inlier, void* stream) {
  if (K < 1 || K > 32 || P < 1 || P > kMaxPoses || L < 0 || iters < 0 || chunk < 1 ||
      max_chunks < 1 || n_chunks < 0 || NL < 0 || NL > P || (NL > 0) != (Hb != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int G = 1;
  while (G < K) G <<= 1;
  const int gridL = grid_of(L);
  const int NX = 6 * (NL > 0 ? NL : 1);
  Problem pr{T0, V0, BG0, BA0, X0, pidx, uv, is2, stereo, valid, fixed,
             valid_lm, Tcb, fac, grav, Hb, gb, cb, L, K, P, kDim * P, NL, G, gridL,
             16 * P, 19 * P, 22 * P, 25 * P, 25 * P + NX, 25 * P + NX + 1, Cam{fx, fy, cx, cy, bf}};
  const Table tb{pair_order, pair_start, chunk_start, P * (P + 1) / 2, chunk, max_chunks, K};
  const Layout y = layout(L, K, P, NL);
  char* base = static_cast<char*>(scratch);
  auto at = [base](size_t off) { return static_cast<void*>(base + off); };
  Work wk;
  wk.part = part;
  wk.Hinv = static_cast<double*>(at(y.Hinv));
  wk.gl = static_cast<double*>(at(y.gl));
  wk.W = static_cast<double*>(at(y.W));
  wk.gd = static_cast<double*>(at(y.gd));
  wk.partial = static_cast<double*>(at(y.partial));
  wk.B = static_cast<float*>(at(y.B));
  wk.Hd = static_cast<float*>(at(y.Hd));
  wk.X = X_out;
  wk.Xc = static_cast<float*>(at(y.Xc));
  wk.dx = static_cast<float*>(at(y.dx));
  wk.cand = static_cast<float*>(at(y.cand));
  wk.model = static_cast<double*>(at(y.model));
  wk.imuH[0] = static_cast<double*>(at(y.imuH0));
  wk.imuH[1] = static_cast<double*>(at(y.imuH1));
  wk.imug[0] = static_cast<double*>(at(y.imug0));
  wk.imug[1] = static_cast<double*>(at(y.imug1));
  wk.imuc[0] = static_cast<double*>(at(y.imuc0));
  wk.imuc[1] = static_cast<double*>(at(y.imuc1));
  wk.state[0] = static_cast<float*>(at(y.state0));
  wk.state[1] = static_cast<float*>(at(y.state1));
  wk.cost[0] = static_cast<double*>(at(y.cost0));
  wk.cost[1] = static_cast<double*>(at(y.cost1));
  wk.sel = static_cast<int*>(at(y.sel));
  wk.done = static_cast<int*>(at(y.done));
  wk.live = static_cast<uint8_t*>(at(y.live));
  wk.T_out = T_out;
  wk.V_out = V_out;
  wk.BG_out = BG_out;
  wk.BA_out = BA_out;
  wk.scal = scal;
  wk.inlier = inlier;
  const int n_fac = P - 1;
  const int build_grid = grid_of(L * G);
  const int reduce_grid = n_chunks < 1 ? 1 : (n_chunks + kReduceWarps - 1) / kReduceWarps;
  // the landmark blocks' poses (float32 and float64, T_cb, the step) and a
  // factor block's work with the entry slot beside it share one size
  const size_t sm_lm = sizeof(double) * 12 * P + sizeof(float) * (12 + 6 * P);
  const size_t sm_fac = sizeof(ImuWork) + sizeof(float) * (25 * P);
  const size_t sm_le = sm_lm > sm_fac ? sm_lm : sm_fac;
  const size_t sm_T = sizeof(float) * (12 * P + 12);
  const size_t sm_solve = solve_smem(P, NL);
  int rc;
  if ((rc = static_cast<int>(cudaFuncSetAttribute(
           solve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
           static_cast<int>(sm_solve)))) != 0)
    return rc;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster);
  cfg.blockDim = dim3(kSolveThreads);
  cfg.dynamicSmemBytes = sm_solve;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  init_kernel<<<gridL + n_fac, kLmThreads, sm_le, s>>>(pr, wk);
  if ((rc = static_cast<int>(cudaGetLastError())) != 0) return rc;
  commit_kernel<<<gridL, kLmThreads, sm_T, s>>>(pr, wk, 1, 1, iters == 0);
  if ((rc = static_cast<int>(cudaGetLastError())) != 0) return rc;
  int slot = 0;
  for (int it = 0; it < iters; ++it) {
    build_kernel<<<build_grid, kLmThreads, sm_T, s>>>(pr, wk, slot);
    if ((rc = static_cast<int>(cudaGetLastError())) != 0) return rc;
    reduce_kernel<<<reduce_grid, kReduceWarps * 32, 0, s>>>(tb, wk);
    if ((rc = static_cast<int>(cudaGetLastError())) != 0) return rc;
    if ((rc = static_cast<int>(cudaLaunchKernelEx(&cfg, solve_kernel, pr, tb, wk, slot))) != 0)
      return rc;
    if ((rc = static_cast<int>(cudaGetLastError())) != 0) return rc;
    eval_kernel<<<gridL + n_fac, kLmThreads, sm_le, s>>>(pr, wk, slot);
    if ((rc = static_cast<int>(cudaGetLastError())) != 0) return rc;
    commit_kernel<<<gridL, kLmThreads, sm_T, s>>>(pr, wk, slot, 0, it == iters - 1);
    if ((rc = static_cast<int>(cudaGetLastError())) != 0) return rc;
    slot ^= 1;
  }
  return 0;
}
