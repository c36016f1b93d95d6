// The Schur-complement Levenberg-Marquardt of the window bundle adjustment:
// every iteration of one call on the device, no host sync.
//
// Replaces tc2li_slam_tpu/solver/lm.py:194 (local_ba): on the TPU one
// jit-compiled program whose iterations are a lax.scan (:329). Eager PyTorch
// ran each iteration as ~60 small ops and a dense solve.
//
// What it computes is the plain version's (ops/kernels/local_ba.py:
// local_ba_plain) up to the exit check, which stays in the wrapper. With the
// window poses T [P] (T <- exp(d) T), the landmarks X [L] and their
// observation table [L, K]: the cost at the entry (visual, plus c_e0 of the
// optional dense pose quadratic H_e0, g_e0, c_e0), lam = 1e-4, then `iters`
// times
//   - per observation the reprojection residual, its pose and landmark
//     Jacobians, the weight w = inv_sigma2 * huber * (valid & depth_ok);
//     per landmark Hll, gl and B_k = Jp^T w Jl, the damped block
//     Hll + lam diag(Hll) + 1e-6 I inverted in closed form (the 1e-20
//     determinant guard), times valid_lm;
//   - the reduced camera system S = Hpp - sum_l B Hll^-1 B^T and
//     g = gp - sum_l B Hll^-1 gl over the free poses (the fixed poses' rows
//     and columns, zero but for a unit diagonal in the plain version, are
//     left out: that changes the free poses' step only by rounding),
//     lam diag(S) + 1e-8 I added, then H_e0 and g_e0 + H_e0 xi;
//   - the Jacobi-scaled system solved by elimination with partial pivoting
//     (S + H_e0 need not be positive definite), dp = -x on free poses,
//     T_new = exp(dp) T, dl = -Hll^-1 (gl + sum_k B_k^T dp_k) on valid
//     landmarks, xi_new = xi + dp;
//   - the candidate's cost, visual plus c_e0 + g_e0 xi + xi^T H_e0 xi / 2;
//     accepted when strictly lower (lam x 0.5), else lam x 4.
// Weights are multiplied in, as there. Where an input is not finite the
// entry cost is NaN and no candidate is accepted, as there: the result is
// the entry state whatever the sums in between held, so the Schur sums
// select away the observations whose weight is exactly 0.
// Precision: each observation's terms of the normal equations are float32,
// as there; the sums over observations and landmarks (Hll, gl, S, g), the
// 3x3 inverses, B Hll^-1, the elimination and the back-substitution are
// float64. The global BA (P 64, 8192 landmarks) is ill-conditioned enough
// that float32 sums in another order than the plain version's move poses by
// ~2e-4 and landmarks seen at small parallax by decimetres. The costs (the
// entry's and each candidate's) are evaluated in float64 from the float32
// state, observation by observation, and kept in float64: the accept test
// of the last iterations compares costs that differ by ~5e-4 on a window
// cost of ~907, below the ~1e-3 noise of a float32 evaluation, so a float32
// cost decided those steps by its rounding (tools/balm_windows.py --trace 8
// on an NVIDIA H100 80GB HBM3 at 700 W: the float32 evaluation rejected at
// iteration 3 the step the float64 run accepts, and left landmarks 2 cm
// from it; in float64 the kernel takes the float64 run's decisions).
//
// Bound on the H100: a 6-iteration call at L 8192, K 8, P 6 reads ~1.4 MB
// of observations a pass and does ~60 M operations an iteration (~12 us of
// either all told); latency: 5 dependent launches an iteration.
// Design: a fixed sequence of launches on the caller's stream, every sum in
// an order that depends only on the inputs (the same bits on every call):
//   init (landmark grid): X = X0, the entry cost's per-block sums;
//   commit: the entry state;
//   per iteration
//   build (observation grid): a thread an observation, G (the power of two
//        >= K) lanes a landmark summing its Hll and gl by a fixed shuffle
//        tree, no atomics. It keeps Hll^-1, gl and B for the
//        back-substitution and writes, for each observation of the pair
//        table, its Hpp term, gp - W gl and W = B Hll^-1 (float64, 6x3),
//        each selected to 0 where w = 0;
//   reduce (a warp a chunk): the pair table, built once a call by the
//        wrapper (pair_table), lists for each upper 6x6 block (p1 <= p2) of
//        S the observation pairs (l, k1, k2) of one landmark on those two
//        free poses, in landmark order, cut into at most 32 chunks of at
//        least 32 pairs. A lane takes every 32nd pair of its warp's chunk
//        and keeps the 42 float64 sums of the block in registers (minus
//        W_k1 B_k2^T, plus the Hpp and gradient terms on k1 = k2), the next
//        pair's loads in flight; a fixed shuffle tree adds the lanes; the
//        block's last chunk adds the chunks in chunk order. (Lanes owning
//        the block's sums, which read each pair's operands from a tile in
//        shared memory, with plain FMAs or with the float64 tensor cores'
//        mma.m8n8k4, were slower on the H100: the walk over the tile, not
//        the loads, took the time.)
//   solve (a cluster of 8 blocks): the free poses numbered by a prefix
//        sum over `fixed`; S and g read from each block's folded row;
//        Gauss-Jordan elimination with partial pivoting (the first
//        largest |a| at or below the diagonal, as before), then x = b / diag
//        with no back-substitution. Up to 48 free rows block 0 holds the
//        system in its shared memory; beyond, the [D, D + 1] system lives in
//        the 8 blocks' shared memory as row slabs and each column takes one
//        cluster barrier: every block sends its best candidate row to every
//        block (distributed shared memory) before it, and picks the same
//        winner after it (an exchange by mbarriers, one arrival from each
//        block, was slower on the H100). Block 0 takes T_new, xi_new and
//        the candidate's model cost;
//   eval (landmark grid): dl, X_new and the per-block float64 sums of the
//        candidate's visual cost;
//   commit (landmark grid): every block adds the per-block sums in block
//        order (the same bits in every block), decides (candidate strictly
//        below the accepted cost, both float64), and moves its landmarks;
//        block 0 writes the next state (two slots, read one, write the
//        other) and the outputs, and the iteration's trace where asked.
// 2 + 5 iters launches a call. The solve's shared memory grows with 6P and
// caps P at 67: a larger window's launch is refused and reported.

#include <climits>
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "schur.cuh"

namespace cg = cooperative_groups;

namespace {

using tc2li::Cam;

constexpr int kLmThreads = 128;
constexpr int kReduceWarps = 4;  // warps a block of the reduce launch
constexpr int kSolveThreads = 512;
constexpr int kCluster = 8;      // blocks of the solve's cluster
constexpr int kSharedD = 48;     // free rows up to which block 0 solves alone

struct Problem {
  const float* T0;        // [P, 4, 4]
  const float* X0;        // [L, 3]
  const int* pidx;        // [L, K]
  const float* uv;        // [L, K, 3]
  const float* is2;       // [L, K]
  const uint8_t* stereo;  // [L, K]
  const uint8_t* valid;   // [L, K]
  const uint8_t* fixed;   // [P]
  const uint8_t* vlm;     // [L]
  const float* He;        // [D, D] or null
  const float* ge;        // [D]
  const float* ce;        // [1]
  int L, K, P, D;
  int G;                  // lanes a landmark in the build: the power of two >= K
  Cam cam;
};


// a state slot: T [16 P], xi [D], then lam; its costs in float64 beside it (Work::cost)
struct Work {
  double* part;     // [chunks, kPart] each chunk's sums
  double* Hinv;     // [L, 9]
  double* gl;       // [L, 3]
  double* W;        // [L, K, 18] B Hll^-1 (0 where w = 0 or the landmark is invalid)
  double* gd;       // [L, K, 6] gp - W gl (0 where w = 0)
  double* partial;  // [grid] per-block visual cost sums
  float* B;         // [L, K, 18]
  float* Hd;        // [L, K, 36] Hpp's term (0 where w = 0)
  float* X;         // [L, 3] the accepted landmarks (the output)
  float* Xc;        // [L, 3] the candidate's
  float* dp;        // [D]
  float* Tc;        // [16 P] the candidate's poses
  float* xic;       // [D]
  double* model;    // [1] the candidate's quadratic-model cost
  float* state[2];  // T [16 P], xi [D], lam
  double* cost[2];  // with state[i]: the cost, the visual cost, the entry cost
  float* T_out;     // [16 P]
  float* scal;      // [3] cost, visual cost, entry cost
  uint8_t* live;    // [L, K] w != 0 (NaN counts as live)
  int* done;        // [nb] chunks of each block summed so far (0 between launches)
  double* trace;    // [iters, 4] or null: candidate cost, cost after, lam, accepted
};

__device__ __forceinline__ int lam_at(const Problem& pr) { return 16 * pr.P + pr.D; }


// One observation: residual, weight and Jacobians.
struct Obs {
  float r[3];
  float w;
  float J[3][6];
  float Jl[3][3];
};

__device__ __forceinline__ void observe(const Problem& pr, const float* Ts, int o, float x,
                                        float y, float z, Obs& ob) {
  const float* T = Ts + 16 * clamp_pose(pr.pidx[o], pr.P);
  const bool st = pr.stereo[o] != 0;
  const tc2li::Reproj rp = tc2li::reproject(T, x, y, z, pr.uv + 3 * o, st, pr.cam);
  const float is2 = pr.is2[o];
  const float chi2 = is2 * (rp.r[0] * rp.r[0] + rp.r[1] * rp.r[1] + rp.r[2] * rp.r[2]);
  const float thr = st ? tc2li::kChi2Stereo : tc2li::kChi2Mono;
  const bool active = pr.valid[o] != 0 && rp.zc > 0.05f;
  ob.w = is2 * tc2li::huber(chi2, thr) * (active ? 1.f : 0.f);
#pragma unroll
  for (int k = 0; k < 3; ++k) ob.r[k] = rp.r[k];
  tc2li::pose_jacobian(rp, ob.J);
  // J_lm = a R
#pragma unroll
  for (int k = 0; k < 3; ++k)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      ob.Jl[k][j] = rp.a[k][0] * T[j] + rp.a[k][1] * T[4 + j] + rp.a[k][2] * T[8 + j];
}

// the visual cost w |r|^2 of one landmark's observations, in float64 from
// the float32 state: the cost decides whether a step is accepted, and a
// float32 evaluation is noisier (~1e-3 on a 900 cost) than the steps that
// decide the last iterations
__device__ double landmark_cost(const Problem& pr, const float* Ts, int l, float x, float y,
                                float z) {
  using D = double;
  D c = 0.0;
  for (int k = 0; k < pr.K; ++k) {
    const int o = l * pr.K + k;
    const bool st = pr.stereo[o] != 0;
    const float* T = Ts + 16 * clamp_pose(pr.pidx[o], pr.P);
    const D xc = D(T[0]) * x + D(T[1]) * y + D(T[2]) * z + D(T[3]);
    const D yc = D(T[4]) * x + D(T[5]) * y + D(T[6]) * z + D(T[7]);
    const D zc = D(T[8]) * x + D(T[9]) * y + D(T[10]) * z + D(T[11]);
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


// (init) X = X0, the entry cost's per-block sums
__global__ void __launch_bounds__(kLmThreads) init_kernel(const Problem pr, Work wk) {
  extern __shared__ float sm[];
  __shared__ double red[kLmThreads / 32];
  for (int e = threadIdx.x; e < 16 * pr.P; e += blockDim.x) sm[e] = pr.T0[e];
  __syncthreads();
  double c = 0.0;
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l < pr.L) {
    const float x = pr.X0[3 * l], y = pr.X0[3 * l + 1], z = pr.X0[3 * l + 2];
    wk.X[3 * l] = x;
    wk.X[3 * l + 1] = y;
    wk.X[3 * l + 2] = z;
    c = landmark_cost(pr, sm, l, x, y, z);
  }
  const double s = block_sum(c, red);
  if (threadIdx.x == 0) wk.partial[blockIdx.x] = s;
  for (int b = l; b < pr.P * (pr.P + 1) / 2; b += gridDim.x * blockDim.x) wk.done[b] = 0;
}

// (build) each landmark's normal equations at the accepted state and the
// per-observation terms of the reduced system; no sums across landmarks.
// A thread an observation, G (a power of two >= K) lanes a landmark: the
// landmark's Hll and gl are summed over its lanes by a fixed shuffle tree,
// and every lane inverts the damped block itself.
__global__ void __launch_bounds__(kLmThreads) build_kernel(const Problem pr, Work wk, int slot) {
  extern __shared__ float Ts[];
  const float* st = wk.state[slot];
  for (int e = threadIdx.x; e < 16 * pr.P; e += blockDim.x) Ts[e] = st[e];
  __syncthreads();
  const float lam = st[lam_at(pr)];
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
    observe(pr, Ts, o, wk.X[3 * l], wk.X[3 * l + 1], wk.X[3 * l + 2], ob);
    float Jp[3][6];
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
      for (int j = 0; j < 6; ++j) Jp[r][j] = ob.J[r][j] * ob.w;
    live = !(ob.w == 0.f);   // NaN counts as live
    wk.live[o] = live;
    // only the observations of the pair table need the pose terms
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
  // the landmark's sums over its G lanes, the same tree in every lane
#pragma unroll
  for (int e = 0; e < 12; ++e) {
    double v = e < 9 ? Hll[e] : gl[e - 9];
    for (int d = pr.G >> 1; d > 0; d >>= 1) v += __shfl_xor_sync(0xffffffffu, v, d);
    if (e < 9) Hll[e] = v; else gl[e - 9] = v;
  }
  if (!on) return;
  // damped block, inverted in closed form (lm.inv3x3), masked by valid_lm
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
  // W = B Hll^-1 and gp - W gl
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

// the solve's view of the assembled system: free row r (6 a free pose) of
// the reduced system, its chunk sums added in chunk order
struct Assembly {
  const double* part;
  const long long* cstart;
  const int* fpose;   // [free poses] the pose of each free index
  const double* xi;   // [D] the accepted tangent
  const float* He;
  const float* ge;
  int P, D;
  double lam;

  __device__ __forceinline__ int full(int r) const { return 6 * fpose[r / 6] + r % 6; }
  __device__ double S(int r, int c) const {
    int pa = fpose[r / 6], pb = fpose[c / 6], i = r % 6, j = c % 6;
    if (pa > pb) {   // the lower blocks are the upper ones transposed
      const int t = pa; pa = pb; pb = t;
      const int u = i; i = j; j = u;
    }
    const int b = block_of(pa, pb, P);
    return cstart[b] < cstart[b + 1] ? part[static_cast<size_t>(cstart[b]) * kPart + 6 * i + j] : 0.0;
  }
  // the damped system's entry (r, c), as the plain version forms it
  __device__ double M(int r, int c) const {
    double a = S(r, c);
    if (r == c) {
      a = a + lam * a;
      a = a + 1e-8;
    }
    if (He) a = a + static_cast<double>(He[full(r) * D + full(c)]);
    return a;
  }
  __device__ double rhs(int r) const {
    const int p = fpose[r / 6], b = block_of(p, p, P);
    double s = cstart[b] < cstart[b + 1] ? part[static_cast<size_t>(cstart[b]) * kPart + 36 + r % 6] : 0.0;
    if (He) {
      const int R = full(r);
      double gx = 0.0;
      for (int c = 0; c < D; ++c) gx += static_cast<double>(He[R * D + c]) * xi[c];
      s = s + (ge[R] + gx);
    }
    return s;
  }
};

// (solve) a cluster of kCluster blocks: the free poses' damped reduced
// system, Jacobi-scaled, reduced by Gauss-Jordan elimination with partial
// pivoting (schur.cuh gauss_jordan); block 0 then takes the candidate's
// poses and model cost. Up to kSharedD free rows block 0 holds the whole
// system and the other blocks return; beyond, block q holds rows
// [q R, q R + R) of it.
__global__ void __launch_bounds__(kSolveThreads) solve_kernel(const Problem pr, const Table tb,
                                                              Work wk, int slot) {
  extern __shared__ double smd[];
  __shared__ double red[kSolveThreads / 32];
  __shared__ int fpose[128], fidx[128];
  __shared__ int s_nf;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const float* st = wk.state[slot];
  const int D = pr.D, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* xi_cur = st + 16 * pr.P;
  // shared memory: this block's rows, the candidates' slots [2][kCluster]
  // (a row's entries, then |a|, position, row and 1 / a at D + 1 .. D + 4),
  // the Jacobi scale, x and xi; then the row at each position and the
  // position of each row
  const int rows_max = (D + kCluster - 1) / kCluster, cw = D + 5;
  const int m_elems = max(kSharedD * (kSharedD + 1), rows_max * (D + 1));
  double* M = smd;
  double* cand = M + m_elems;
  double* dsc = cand + 2 * kCluster * cw;
  double* x = dsc + D;
  double* xi = x + D;
  int* pos2row = reinterpret_cast<int*>(xi + D);
  int* row2pos = pos2row + D;
  for (int p = tid; p < pr.P; p += blockDim.x) fidx[p] = pr.fixed[p];
  for (int e = tid; e < D; e += blockDim.x) xi[e] = xi_cur[e];
  __syncthreads();
  if (tid == 0) {   // the free poses, numbered by a prefix sum over `fixed`
    int n = 0;
    for (int p = 0; p < pr.P; ++p) {
      const bool fixed = fidx[p] != 0;
      fidx[p] = fixed ? -1 : n;
      if (!fixed) fpose[n++] = p;
    }
    s_nf = n;
  }
  __syncthreads();
  const int Df = 6 * s_nf, Wd = Df + 1;
  const bool multi = Df > kSharedD;
  if (!multi && rank != 0) return;
  const int R = multi ? (Df + kCluster - 1) / kCluster : Df;
  const int r0 = multi ? rank * R : 0, nloc = max(min(r0 + R, Df) - r0, 0);
  const Assembly as{wk.part, tb.cstart, fpose, xi, pr.He, pr.ge, pr.P, D,
                    static_cast<double>(st[lam_at(pr)])};
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
  for (int r = tid; r < D; r += blockDim.x) {
    const int f = fidx[r / 6];
    const float dp = f < 0 ? 0.f : static_cast<float>(-(x[6 * f + r % 6] / dsc[6 * f + r % 6]));
    wk.dp[r] = dp;
    wk.xic[r] = xi_cur[r] + dp;
  }
  __syncthreads();
  for (int p = tid; p < pr.P; p += blockDim.x) tc2li::se3_exp_left(wk.dp + 6 * p, st + 16 * p, wk.Tc + 16 * p);
  if (pr.He) {   // c_e0 + g_e0 . xi + xi^T H_e0 xi / 2 at the candidate
    __syncthreads();
    double part = 0.0, lin = 0.0;
    for (int r = tid; r < D; r += blockDim.x) {
      double hx = 0.0;
      for (int c = 0; c < D; ++c) hx += static_cast<double>(pr.He[r * D + c]) * wk.xic[c];
      part += wk.xic[r] * hx;
      lin += static_cast<double>(pr.ge[r]) * wk.xic[r];
    }
    const double q = block_sum(part, red);
    __syncthreads();
    const double gx = block_sum(lin, red);
    if (tid == 0) *wk.model = pr.ce[0] + gx + 0.5 * q;
  } else if (tid == 0) {
    *wk.model = 0.0;
  }
}

// (eval) the candidate's landmarks and the per-block sums of its visual cost
__global__ void __launch_bounds__(kLmThreads) eval_kernel(const Problem pr, Work wk) {
  extern __shared__ float sm[];
  __shared__ double red[kLmThreads / 32];
  float* Ts = sm;
  float* dp = sm + 16 * pr.P;
  for (int e = threadIdx.x; e < 16 * pr.P; e += blockDim.x) Ts[e] = wk.Tc[e];
  for (int e = threadIdx.x; e < pr.D; e += blockDim.x) dp[e] = wk.dp[e];
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
    c = landmark_cost(pr, Ts, l, Xn[0], Xn[1], Xn[2]);
  }
  const double s = block_sum(c, red);
  if (threadIdx.x == 0) wk.partial[blockIdx.x] = s;
}

// (commit) accept or reject; slot `from` is read, the other written.
// init: the entry state from T0 and the entry cost.
__global__ void __launch_bounds__(kLmThreads) commit_kernel(const Problem pr, Work wk, int from,
                                                            int init, int it) {
  __shared__ double s_vis, s_cand;
  __shared__ int s_acc;
  const float* cur = wk.state[from];
  float* nxt = wk.state[from ^ 1];
  const double* ccur = wk.cost[from];
  double* cnxt = wk.cost[from ^ 1];
  const int li = lam_at(pr);
  if (threadIdx.x == 0) {
    double vis = 0.0;
    for (int b = 0; b < static_cast<int>(gridDim.x); ++b) vis += wk.partial[b];
    s_vis = vis;
    s_cand = init ? vis : vis + *wk.model;
    s_acc = init ? 1 : (s_cand < ccur[0]);   // NaN rejects
  }
  __syncthreads();
  const double vis = s_vis;
  const bool acc = s_acc != 0;
  if (!init && acc) {
    const int l = blockIdx.x * blockDim.x + threadIdx.x;
    if (l < pr.L)
      for (int i = 0; i < 3; ++i) wk.X[3 * l + i] = wk.Xc[3 * l + i];
  }
  if (blockIdx.x != 0) return;
  for (int e = threadIdx.x; e < 16 * pr.P; e += blockDim.x) {
    const float t = init ? pr.T0[e] : (acc ? wk.Tc[e] : cur[e]);
    nxt[e] = t;
    wk.T_out[e] = t;
  }
  for (int e = threadIdx.x; e < pr.D; e += blockDim.x)
    nxt[16 * pr.P + e] = init ? 0.f : (acc ? wk.xic[e] : cur[16 * pr.P + e]);
  if (threadIdx.x == 0) {
    float lam;
    double cost, v, cost0;
    if (init) {
      lam = 1e-4f;
      cost = pr.He ? vis + static_cast<double>(pr.ce[0]) : vis;
      v = vis;
      cost0 = cost;
    } else {
      lam = acc ? cur[li] * 0.5f : cur[li] * 4.f;
      cost = acc ? s_cand : ccur[0];
      v = acc ? vis : ccur[1];
      cost0 = ccur[2];
    }
    nxt[li] = lam;
    cnxt[0] = cost;
    cnxt[1] = v;
    cnxt[2] = cost0;
    wk.scal[0] = static_cast<float>(cost);
    wk.scal[1] = static_cast<float>(v);
    wk.scal[2] = static_cast<float>(cost0);
    if (wk.trace && !init) {
      double* tr = wk.trace + 4 * it;
      tr[0] = s_cand;
      tr[1] = cost;
      tr[2] = cur[li];
      tr[3] = acc ? 1.0 : 0.0;
    }
  }
}

int grid_of(int L) { return L < 1 ? 1 : (L + kLmThreads - 1) / kLmThreads; }

size_t solve_smem(int P) {
  const int D = 6 * P, rows_max = (D + kCluster - 1) / kCluster;
  const int m_elems = rows_max * (D + 1) > kSharedD * (kSharedD + 1) ? rows_max * (D + 1)
                                                                     : kSharedD * (kSharedD + 1);
  return sizeof(double) * (static_cast<size_t>(m_elems) + 2 * kCluster * (D + 5) + 3 * D) +
         sizeof(int) * 2 * D;
}

// the scratch's arrays, each at a 16-byte boundary (the build's vector stores)
struct Layout {
  size_t Hinv, gl, W, gd, partial, B, Hd, Xc, dp, Tc, xic, model, state0, state1, cost0, cost1,
      done, live, total;
};

Layout layout(int L, int K, int P) {
  const size_t D = 6 * static_cast<size_t>(P), LK = static_cast<size_t>(L) * K;
  const size_t slot = 16 * static_cast<size_t>(P) + D + 1;
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
  y.dp = take(4 * D);
  y.Tc = take(4 * 16 * static_cast<size_t>(P));
  y.xic = take(4 * D);
  y.model = take(8);
  y.state0 = take(4 * slot);
  y.state1 = take(4 * slot);
  y.cost0 = take(8 * 3);
  y.cost1 = take(8 * 3);
  y.done = take(4 * (static_cast<size_t>(P) * (P + 1) / 2));
  y.live = take(LK);
  y.total = off;
  return y;
}

}  // namespace

// bytes of scratch a call takes (see tc2li_local_ba_lm)
extern "C" long long tc2li_local_ba_scratch(int L, int K, int P) {
  return static_cast<long long>(layout(L, K, P).total);
}

// T0 [P, 4, 4], X0 [L, 3], uv [L, K, 3], is2 [L, K] float32; pidx [L, K]
// int32; stereo, valid [L, K], fixed [P], valid_lm [L] uint8 (0 or 1);
// He [6P, 6P], ge [6P], ce [1] float32 or all three null; the pair table
// (ops/kernels/local_ba.py: pair_table) order [E], start, cstart
// [P (P + 1) / 2 + 1] int64, a block cut into at most `max_chunks` chunks of
// at least `chunk` pairs, and part [n_chunks, 42] float64 with n_chunks at
// least cstart's last entry; scratch of
// tc2li_local_ba_scratch(L, K, P) bytes, 16-byte aligned; outputs T_out [P, 4,
// 4], X_out [L, 3], scal [3] (cost, visual cost, entry cost) float32; trace
// [iters, 4] float64 or null (each iteration's candidate cost, cost after
// the decision, lam and 1 where accepted). All
// contiguous on the device. Launches 2 + 5 iters kernels on `stream`;
// returns the first CUDA error code that is not cudaSuccess (a refused
// launch included: P above 67 exceeds the solve's shared memory).
extern "C" int tc2li_local_ba_lm(const float* T0, const float* X0, const int* pidx,
                                 const float* uv, const float* is2, const uint8_t* stereo,
                                 const uint8_t* valid, const uint8_t* fixed,
                                 const uint8_t* valid_lm, const float* He, const float* ge,
                                 const float* ce, const long long* pair_order,
                                 const long long* pair_start, const long long* chunk_start,
                                 double* part,
                                 int L, int K, int P, int n_chunks, int chunk, int max_chunks,
                                 float fx,
                                 float fy, float cx, float cy, float bf, int iters,
                                 void* scratch, float* T_out, float* X_out, float* scal,
                                 double* trace, void* stream) {
  if (K < 1 || K > 32 || P < 1 || P > 128 || L < 0 || iters < 0 || chunk < 1 ||
      max_chunks < 1 || n_chunks < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int G = 1;
  while (G < K) G <<= 1;
  Problem pr{T0, X0, pidx, uv, is2, stereo, valid, fixed, valid_lm, He, ge, ce, L, K, P, 6 * P,
             G, Cam{fx, fy, cx, cy, bf}};
  const Table tb{pair_order, pair_start, chunk_start, P * (P + 1) / 2, chunk, max_chunks, K};
  const int D = 6 * P;
  const Layout y = layout(L, K, P);
  char* base = static_cast<char*>(scratch);
  Work wk;
  wk.part = part;
  wk.Hinv = reinterpret_cast<double*>(base + y.Hinv);
  wk.gl = reinterpret_cast<double*>(base + y.gl);
  wk.W = reinterpret_cast<double*>(base + y.W);
  wk.gd = reinterpret_cast<double*>(base + y.gd);
  wk.partial = reinterpret_cast<double*>(base + y.partial);
  wk.B = reinterpret_cast<float*>(base + y.B);
  wk.Hd = reinterpret_cast<float*>(base + y.Hd);
  wk.Xc = reinterpret_cast<float*>(base + y.Xc);
  wk.dp = reinterpret_cast<float*>(base + y.dp);
  wk.Tc = reinterpret_cast<float*>(base + y.Tc);
  wk.xic = reinterpret_cast<float*>(base + y.xic);
  wk.model = reinterpret_cast<double*>(base + y.model);
  wk.state[0] = reinterpret_cast<float*>(base + y.state0);
  wk.state[1] = reinterpret_cast<float*>(base + y.state1);
  wk.cost[0] = reinterpret_cast<double*>(base + y.cost0);
  wk.cost[1] = reinterpret_cast<double*>(base + y.cost1);
  wk.done = reinterpret_cast<int*>(base + y.done);
  wk.live = reinterpret_cast<uint8_t*>(base + y.live);
  wk.X = X_out;
  wk.T_out = T_out;
  wk.scal = scal;
  wk.trace = trace;
  const int grid = grid_of(L);
  const int build_grid = grid_of(L * G);
  const int reduce_grid = n_chunks < 1 ? 1 : (n_chunks + kReduceWarps - 1) / kReduceWarps;
  const size_t sm_T = sizeof(float) * 16 * P;
  const size_t sm_eval = sm_T + sizeof(float) * D;
  const size_t sm_solve = solve_smem(P);
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
  init_kernel<<<grid, kLmThreads, sm_T, s>>>(pr, wk);
  if ((rc = static_cast<int>(cudaGetLastError())) != 0) return rc;
  commit_kernel<<<grid, kLmThreads, 0, s>>>(pr, wk, 1, 1, 0);
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
    eval_kernel<<<grid, kLmThreads, sm_eval, s>>>(pr, wk);
    if ((rc = static_cast<int>(cudaGetLastError())) != 0) return rc;
    commit_kernel<<<grid, kLmThreads, 0, s>>>(pr, wk, slot, 0, it);
    if ((rc = static_cast<int>(cudaGetLastError())) != 0) return rc;
    slot ^= 1;
  }
  return 0;
}
