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
//     g = gp - sum_l B Hll^-1 gl, the fixed poses' rows and columns zeroed
//     and their diagonal 1, lam diag(S) + 1e-8 I added, then H_e0 (fixed
//     rows masked) and g_e0 + H_e0 xi;
//   - the Jacobi-scaled system solved by Gaussian elimination with partial
//     pivoting (S + H_e0 need not be positive definite), dp = -x on free poses,
//     T_new = exp(dp) T, dl = -Hll^-1 (gl + sum_k B_k^T dp_k) on valid
//     landmarks, xi_new = xi + dp;
//   - the candidate's cost, visual plus c_e0 + g_e0 xi + xi^T H_e0 xi / 2;
//     accepted when strictly lower (lam x 0.5), else lam x 4.
// Weights are multiplied in, as there. Where an input is not finite the
// entry cost is NaN and no candidate is accepted, as there: the result is
// the entry state whatever the sums in between held, so the Schur sums may
// skip the observations whose weight is exactly 0.
// Precision: each observation's terms are float32, as there; the sums over
// observations and landmarks (Hll, gl, S, g, the costs), the 3x3 inverses,
// the back-substitution and the elimination are float64. The global BA
// (P 64, 8192 landmarks) is ill-conditioned enough that float32 sums in
// another order than the plain version's move poses by ~2e-4 and landmarks
// seen at small parallax by decimetres; in float64 the result lies nearer
// the plain version run in float64 than the float32 plain version does.
//
// Bound on the H100: a 6-iteration call at L 8192, K 8, P 6 reads ~1.4 MB
// of observations a pass and does ~60 M float operations an iteration
// (~12 us of either all told); latency: 4 dependent launches an iteration,
// one of them a single block that solves the 6P system.
// Design: a fixed sequence of launches on the caller's stream,
//   init (landmark grid): X = X0, the accumulators zeroed, the entry cost's
//        per-block sums;            commit: the entry state;
//   per iteration
//   build (landmark grid): a thread a landmark (dealt to the blocks in
//        turn); Hpp, gp and the Schur terms of the blocks on and above the
//        diagonal added into S and g (shared memory per block, then device
//        atomics, for 6P <= 48; device atomics beyond), Hll^-1, gl, B kept
//        for the back-substitution;
//   solve (one block): S and g assembled as above, elimination in shared
//        memory up to 6P = 48 and in device memory beyond (6P = 384 for
//        the global BA), T_new, xi_new and the candidate's model cost; the
//        accumulators zeroed for the next build;
//   eval (landmark grid): dl, X_new and the per-block sums of the candidate's
//        visual cost;
//   commit (landmark grid): every block adds the per-block sums in block
//        order (the same bits in every block), decides, and moves its
//        landmarks; block 0 writes the next state (two slots, read one,
//        write the other) and the outputs.
// 2 + 4 iters launches a call. The S sums use float64 atomics, so their
// order, and a result's last float32 bits, can change from run to run.

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using tc2li::Cam;

constexpr int kLmThreads = 128;
constexpr int kSolveThreads = 1024;
constexpr int kSharedD = 48;   // 6P up to which S and the elimination live in shared memory

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
  Cam cam;
};

// a state slot: T [16 P], xi [D], then lam, cost, visual cost, entry cost
struct Work {
  double* S;        // [D, D] accumulators, 0 between iterations
  double* g;        // [D]
  double* Hinv;     // [L, 9]
  double* gl;       // [L, 3]
  float* B;         // [L, K, 18]
  float* X;         // [L, 3] the accepted landmarks (the output)
  float* Xc;        // [L, 3] the candidate's
  float* dp;        // [D]
  float* Tc;        // [16 P] the candidate's poses
  float* xic;       // [D]
  float* model;     // [1] the candidate's quadratic-model cost
  double* partial;  // [grid] per-block visual cost sums
  float* state[2];
  double* A;        // [D, D + 1] elimination scratch beyond kSharedD
  float* T_out;     // [16 P]
  float* scal;      // [3] cost, visual cost, entry cost
};

__device__ __forceinline__ int lam_at(const Problem& pr) { return 16 * pr.P + pr.D; }

// One observation: residual, weight and Jacobians. Returns w.
struct Obs {
  float r[3];
  float w;
  float J[3][6];
  float Jl[3][3];
};

__device__ __forceinline__ void observe(const Problem& pr, const float* Ts, int o, float x,
                                        float y, float z, Obs& ob) {
  int p = pr.pidx[o];
  p = p < 0 ? 0 : (p > pr.P - 1 ? pr.P - 1 : p);
  const float* T = Ts + 16 * p;
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

// the visual cost w |r|^2 of one landmark's observations
__device__ float landmark_cost(const Problem& pr, const float* Ts, int l, float x, float y,
                               float z) {
  float c = 0.f;
  for (int k = 0; k < pr.K; ++k) {
    const int o = l * pr.K + k;
    int p = pr.pidx[o];
    p = p < 0 ? 0 : (p > pr.P - 1 ? pr.P - 1 : p);
    const bool st = pr.stereo[o] != 0;
    const tc2li::Reproj rp = tc2li::reproject(Ts + 16 * p, x, y, z, pr.uv + 3 * o, st, pr.cam);
    const float is2 = pr.is2[o];
    const float rr = rp.r[0] * rp.r[0] + rp.r[1] * rp.r[1] + rp.r[2] * rp.r[2];
    const float thr = st ? tc2li::kChi2Stereo : tc2li::kChi2Mono;
    const bool active = pr.valid[o] != 0 && rp.zc > 0.05f;
    const float w = is2 * tc2li::huber(is2 * rr, thr) * (active ? 1.f : 0.f);
    c += w * rr;
  }
  return c;
}

// block sum in a fixed order (warps by shuffles, then the warps in order);
// the result in thread 0
__device__ double block_sum(double v, double* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  double s = 0.0;
  if (threadIdx.x == 0)
    for (int k = 0; k < static_cast<int>(blockDim.x >> 5); ++k) s += red[k];
  return s;
}

// (init) X = X0, accumulators zeroed, the entry cost's per-block sums
__global__ void __launch_bounds__(kLmThreads) init_kernel(const Problem pr, Work wk) {
  extern __shared__ float sm[];
  __shared__ double red[kLmThreads / 32];
  for (int e = threadIdx.x; e < 16 * pr.P; e += blockDim.x) sm[e] = pr.T0[e];
  const int gtid = blockIdx.x * blockDim.x + threadIdx.x;
  for (int e = gtid; e < pr.D * pr.D + pr.D; e += gridDim.x * blockDim.x) {
    if (e < pr.D * pr.D) wk.S[e] = 0.0; else wk.g[e - pr.D * pr.D] = 0.0;
  }
  __syncthreads();
  float c = 0.f;
  const int l = gtid;
  if (l < pr.L) {
    const float x = pr.X0[3 * l], y = pr.X0[3 * l + 1], z = pr.X0[3 * l + 2];
    wk.X[3 * l] = x;
    wk.X[3 * l + 1] = y;
    wk.X[3 * l + 2] = z;
    c = landmark_cost(pr, sm, l, x, y, z);
  }
  const double s = block_sum(c, red);
  if (threadIdx.x == 0) wk.partial[blockIdx.x] = s;
}

// (build) normal equations at the accepted state, reduced by the landmarks
__global__ void __launch_bounds__(kLmThreads) build_kernel(const Problem pr, Work wk, int slot) {
  extern __shared__ double smd[];
  const float* st = wk.state[slot];
  const int D = pr.D;
  const bool shared_acc = D <= kSharedD;
  double* S = shared_acc ? smd : wk.S;
  double* g = shared_acc ? smd + D * D : wk.g;
  float* Ts = reinterpret_cast<float*>(smd + (shared_acc ? D * D + D : 0));
  for (int e = threadIdx.x; e < 16 * pr.P; e += blockDim.x) Ts[e] = st[e];
  if (shared_acc)
    for (int e = threadIdx.x; e < D * D + D; e += blockDim.x) S[e] = 0.0;
  __syncthreads();
  const float lam = st[lam_at(pr)];
  // landmarks dealt to the blocks in turn: the active ones come first in
  // the table, and a block of them alone would hold the work on a few SMs
  const int l = threadIdx.x * gridDim.x + blockIdx.x;
  if (l < pr.L) {
    const float x = wk.X[3 * l], y = wk.X[3 * l + 1], z = wk.X[3 * l + 2];
    double Hll[9] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
    double gl[3] = {0.0, 0.0, 0.0};
    unsigned live = 0u;   // observations of non-zero weight (K <= 32)
    // each lane starts at another slot: neighbouring landmarks' slots tend to
    // hold the same poses, and lanes adding into one address serialise
    const int rot = (threadIdx.x & 31) % pr.K;
    for (int kk = 0; kk < pr.K; ++kk) {
      const int k = (kk + rot) % pr.K;
      const int o = l * pr.K + k;
      Obs ob;
      observe(pr, Ts, o, x, y, z, ob);
      float Jp[3][6];
#pragma unroll
      for (int r = 0; r < 3; ++r)
#pragma unroll
        for (int j = 0; j < 6; ++j) Jp[r][j] = ob.J[r][j] * ob.w;
      const bool is_live = !(ob.w == 0.f);   // NaN counts as live
      live |= (is_live ? 1u : 0u) << k;
      int p = pr.pidx[o];
      p = p < 0 ? 0 : (p > pr.P - 1 ? pr.P - 1 : p);
      float* Bo = wk.B + static_cast<size_t>(o) * 18;
#pragma unroll
      for (int j = 0; j < 6; ++j) {
        if (is_live) {
#pragma unroll
          for (int c = 0; c < 6; ++c)
            atomicAdd(S + (6 * p + j) * D + 6 * p + c,
                      static_cast<double>(Jp[0][j] * ob.J[0][c] + Jp[1][j] * ob.J[1][c] +
                                          Jp[2][j] * ob.J[2][c]));
          atomicAdd(g + 6 * p + j, static_cast<double>(Jp[0][j] * ob.r[0] + Jp[1][j] * ob.r[1] +
                                                       Jp[2][j] * ob.r[2]));
        }
#pragma unroll
        for (int m = 0; m < 3; ++m)
          Bo[3 * j + m] = Jp[0][j] * ob.Jl[0][m] + Jp[1][j] * ob.Jl[1][m] + Jp[2][j] * ob.Jl[2][m];
      }
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const float w0 = ob.Jl[0][j] * ob.w, w1 = ob.Jl[1][j] * ob.w, w2 = ob.Jl[2][j] * ob.w;
#pragma unroll
        for (int m = 0; m < 3; ++m) Hll[3 * j + m] += w0 * ob.Jl[0][m] + w1 * ob.Jl[1][m] + w2 * ob.Jl[2][m];
        gl[j] += w0 * ob.r[0] + w1 * ob.r[1] + w2 * ob.r[2];
      }
    }
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
    const double lmw = pr.vlm[l] ? 1.0 : 0.0;
    const double Hi[9] = {A00 * inv_det * lmw, A01 * inv_det * lmw, A02 * inv_det * lmw,
                          A10 * inv_det * lmw, A11 * inv_det * lmw, A12 * inv_det * lmw,
                          A20 * inv_det * lmw, A21 * inv_det * lmw, A22 * inv_det * lmw};
#pragma unroll
    for (int k = 0; k < 9; ++k) wk.Hinv[9 * l + k] = Hi[k];
#pragma unroll
    for (int k = 0; k < 3; ++k) wk.gl[3 * l + k] = gl[k];
    if (pr.vlm[l]) {
      // Schur terms of the live observation pairs
      for (int i1 = 0; i1 < pr.K; ++i1) {
        const int k1 = (i1 + rot) % pr.K;
        if (!((live >> k1) & 1u)) continue;
        const int o1 = l * pr.K + k1;
        int p1 = pr.pidx[o1];
        p1 = p1 < 0 ? 0 : (p1 > pr.P - 1 ? pr.P - 1 : p1);
        const float* B1 = wk.B + static_cast<size_t>(o1) * 18;
        double BH[18];
#pragma unroll
        for (int r = 0; r < 6; ++r)
#pragma unroll
          for (int m = 0; m < 3; ++m)
            BH[3 * r + m] = B1[3 * r] * Hi[m] + B1[3 * r + 1] * Hi[3 + m] + B1[3 * r + 2] * Hi[6 + m];
#pragma unroll
        for (int r = 0; r < 6; ++r)
          atomicAdd(g + 6 * p1 + r, -(BH[3 * r] * gl[0] + BH[3 * r + 1] * gl[1] + BH[3 * r + 2] * gl[2]));
        for (int i2 = 0; i2 < pr.K; ++i2) {
          const int k2 = (i2 + rot) % pr.K;
          if (!((live >> k2) & 1u)) continue;
          const int o2 = l * pr.K + k2;
          int p2 = pr.pidx[o2];
          p2 = p2 < 0 ? 0 : (p2 > pr.P - 1 ? pr.P - 1 : p2);
          if (p1 > p2) continue;   // S is symmetric: its lower blocks are read transposed
          const float* B2 = wk.B + static_cast<size_t>(o2) * 18;
          double b2[18];
#pragma unroll
          for (int q = 0; q < 18; ++q) b2[q] = B2[q];
#pragma unroll
          for (int r = 0; r < 6; ++r)
#pragma unroll
            for (int c2 = 0; c2 < 6; ++c2)
              atomicAdd(S + (6 * p1 + r) * D + 6 * p2 + c2,
                        -(BH[3 * r] * b2[3 * c2] + BH[3 * r + 1] * b2[3 * c2 + 1] +
                          BH[3 * r + 2] * b2[3 * c2 + 2]));
        }
      }
    }
  }
  if (shared_acc) {
    __syncthreads();
    for (int e = threadIdx.x; e < D * D + D; e += blockDim.x) {
      const double v = S[e];
      if (v != 0.0 || v != v) {
        if (e < D * D) atomicAdd(wk.S + e, v); else atomicAdd(wk.g + e - D * D, v);
      }
    }
  }
}

// (solve) one block: the damped reduced system, Jacobi-scaled, by Gaussian
// elimination with partial pivoting; the candidate's poses and model cost
__global__ void __launch_bounds__(kSolveThreads) solve_kernel(const Problem pr, Work wk,
                                                              int slot) {
  extern __shared__ double smd[];
  __shared__ double red[kSolveThreads / 32];
  __shared__ int piv;
  const float* st = wk.state[slot];
  const int D = pr.D, Wd = D + 1, tid = threadIdx.x;
  double* M = D <= kSharedD ? smd : wk.A;              // [D, D + 1], the right-hand side last
  double* dsc = (D <= kSharedD ? smd + D * Wd : smd);  // [D] the Jacobi scale
  double* x = dsc + D;                                 // [D]
  double* xi = x + D;                                  // [D] the accepted tangent
  const float lam = st[lam_at(pr)];
  const float* xi_cur = st + 16 * pr.P;
  for (int e = tid; e < D; e += blockDim.x) xi[e] = xi_cur[e];
  __syncthreads();
  for (int e = tid; e < D * D; e += blockDim.x) {
    const int r = e / D, c = e % D;
    const double fr = pr.fixed[r / 6] ? 0.0 : 1.0, fc = pr.fixed[c / 6] ? 0.0 : 1.0;
    // the Schur sums fill the blocks on and above the diagonal
    double a = (r / 6 > c / 6 ? wk.S[c * D + r] : wk.S[e]) * fr * fc;
    if (r == c) {
      a = a + (1.0 - fr);
      a = a + lam * a;
      a = a + 1e-8;
    }
    if (pr.He) a = a + static_cast<double>(pr.He[e]) * fr * fc;
    M[r * Wd + c] = a;
  }
  for (int r = tid; r < D; r += blockDim.x) {
    const double fr = pr.fixed[r / 6] ? 0.0 : 1.0;
    double b = wk.g[r] * fr;
    if (pr.He) {
      double ge = 0.0;
      for (int c = 0; c < D; ++c) ge += static_cast<double>(pr.He[r * D + c]) * xi[c];
      b = b + (pr.ge[r] + ge) * fr;
    }
    M[r * Wd + D] = b;
  }
  __syncthreads();
  // the accumulators are read: zero them for the next build
  for (int e = tid; e < D * D + D; e += blockDim.x) {
    if (e < D * D) wk.S[e] = 0.0; else wk.g[e - D * D] = 0.0;
  }
  // Jacobi scaling (lm.precond_solve)
  for (int r = tid; r < D; r += blockDim.x) {
    const double a = fabs(M[r * Wd + r]);
    dsc[r] = sqrt(a < 1e-12 ? 1e-12 : a);
  }
  __syncthreads();
  for (int e = tid; e < D * Wd; e += blockDim.x) {
    const int r = e / Wd, c = e % Wd;
    M[e] = c < D ? M[e] / (dsc[r] * dsc[c]) : M[e] / dsc[r];
  }
  __syncthreads();
  const int lane = tid & 31, warp = tid >> 5;
  for (int c = 0; c < D; ++c) {
    if (warp == 0) {   // the first largest |a| of column c at or below the diagonal
      double best = -1.0;
      int bi = c;
      for (int r = c + lane; r < D; r += 32) {
        const double v = fabs(M[r * Wd + c]);
        if (v > best) {
          best = v;
          bi = r;
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        const double ob = __shfl_xor_sync(0xffffffffu, best, o);
        const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
        if (ob > best || (ob == best && oi < bi)) {
          best = ob;
          bi = oi;
        }
      }
      if (lane == 0) piv = bi;
    }
    __syncthreads();
    const int p = piv;
    if (p != c) {
      for (int k = c + tid; k < Wd; k += blockDim.x) {
        const double t = M[c * Wd + k];
        M[c * Wd + k] = M[p * Wd + k];
        M[p * Wd + k] = t;
      }
      __syncthreads();
    }
    const double inv = 1.0 / M[c * Wd + c];
    const int rows = D - c - 1, cols = Wd - c - 1;
    for (int e = tid; e < rows * cols; e += blockDim.x) {
      const int r = c + 1 + e / cols, k = c + 1 + e % cols;
      const double l = M[r * Wd + c] * inv;
      M[r * Wd + k] -= l * M[c * Wd + k];
    }
    __syncthreads();
  }
  if (warp == 0) {   // back substitution
    for (int r = D - 1; r >= 0; --r) {
      double acc = 0.0;
      for (int k = r + 1 + lane; k < D; k += 32) acc += M[r * Wd + k] * x[k];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
      if (lane == 0) x[r] = (M[r * Wd + D] - acc) / M[r * Wd + r];
      __syncwarp();
    }
  }
  __syncthreads();
  for (int r = tid; r < D; r += blockDim.x) {
    const float fr = pr.fixed[r / 6] ? 0.f : 1.f;
    const float dp = static_cast<float>(-(x[r] / dsc[r])) * fr;
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
    if (tid == 0) *wk.model = static_cast<float>(pr.ce[0] + gx + 0.5 * q);
  } else if (tid == 0) {
    *wk.model = 0.f;
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
  float c = 0.f;
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l < pr.L) {
    double bt[3] = {0.0, 0.0, 0.0};
    for (int k = 0; k < pr.K; ++k) {
      const int o = l * pr.K + k;
      int p = pr.pidx[o];
      p = p < 0 ? 0 : (p > pr.P - 1 ? pr.P - 1 : p);
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
                                                            int init) {
  __shared__ float s_tot;
  __shared__ int s_acc;
  const float* cur = wk.state[from];
  float* nxt = wk.state[from ^ 1];
  const int li = lam_at(pr);
  if (threadIdx.x == 0) {
    double vis = 0.0;
    for (int b = 0; b < static_cast<int>(gridDim.x); ++b) vis += wk.partial[b];
    s_tot = static_cast<float>(vis);
    s_acc = init ? 1 : ((vis + *wk.model) < cur[li + 1]);   // NaN rejects
  }
  __syncthreads();
  const float vis = s_tot;
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
    float lam, cost, v, cost0;
    if (init) {
      lam = 1e-4f;
      cost = pr.He ? vis + pr.ce[0] : vis;
      v = vis;
      cost0 = cost;
    } else {
      lam = acc ? cur[li] * 0.5f : cur[li] * 4.f;
      cost = acc ? vis + *wk.model : cur[li + 1];
      v = acc ? vis : cur[li + 2];
      cost0 = cur[li + 3];
    }
    nxt[li] = lam;
    nxt[li + 1] = cost;
    nxt[li + 2] = v;
    nxt[li + 3] = cost0;
    wk.scal[0] = cost;
    wk.scal[1] = v;
    wk.scal[2] = cost0;
  }
}

int grid_of(int L) { return L < 1 ? 1 : (L + kLmThreads - 1) / kLmThreads; }

}  // namespace

// bytes of scratch a call takes: the float64 arrays of Work, then its
// float32 ones (see tc2li_local_ba_lm)
extern "C" long long tc2li_local_ba_scratch(int L, int K, int P) {
  const long long D = 6LL * P;
  const long long slot = 16LL * P + D + 4;
  const long long n64 = D * D + D + 9LL * L + 3LL * L + grid_of(L) + (D > kSharedD ? D * (D + 1) : 0);
  const long long n32 = 18LL * L * K + 3LL * L + D + 16LL * P + D + 1 + 2 * slot;
  return 8 * n64 + 4 * n32;
}

// T0 [P, 4, 4], X0 [L, 3], uv [L, K, 3], is2 [L, K] float32; pidx [L, K]
// int32; stereo, valid [L, K], fixed [P], valid_lm [L] uint8 (0 or 1);
// He [6P, 6P], ge [6P], ce [1] float32 or all three null; scratch of
// tc2li_local_ba_scratch(L, K, P) bytes, 8-byte aligned; outputs T_out [P, 4, 4], X_out
// [L, 3], scal [3] (cost, visual cost, entry cost) float32. All contiguous
// on the device. Launches 2 + 4 iters kernels on `stream`; returns the first
// cudaGetLastError() that is not cudaSuccess.
extern "C" int tc2li_local_ba_lm(const float* T0, const float* X0, const int* pidx,
                                 const float* uv, const float* is2, const uint8_t* stereo,
                                 const uint8_t* valid, const uint8_t* fixed,
                                 const uint8_t* valid_lm, const float* He, const float* ge,
                                 const float* ce, int L, int K, int P, float fx, float fy,
                                 float cx, float cy, float bf, int iters, void* scratch,
                                 float* T_out, float* X_out, float* scal, void* stream) {
  if (K < 1 || K > 32 || P < 1 || L < 0 || iters < 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  Problem pr{T0, X0, pidx, uv, is2, stereo, valid, fixed, valid_lm, He, ge, ce, L, K, P, 6 * P,
             Cam{fx, fy, cx, cy, bf}};
  const int D = 6 * P;
  Work wk;
  double* q8 = static_cast<double*>(scratch);
  wk.S = q8; q8 += static_cast<size_t>(D) * D;
  wk.g = q8; q8 += D;
  wk.Hinv = q8; q8 += 9LL * L;
  wk.gl = q8; q8 += 3LL * L;
  wk.partial = q8; q8 += grid_of(L);
  wk.A = nullptr;
  if (D > kSharedD) {
    wk.A = q8;
    q8 += static_cast<size_t>(D) * (D + 1);
  }
  float* q = reinterpret_cast<float*>(q8);
  wk.B = q; q += 18LL * L * K;
  wk.Xc = q; q += 3LL * L;
  wk.dp = q; q += D;
  wk.Tc = q; q += 16 * P;
  wk.xic = q; q += D;
  wk.model = q; q += 1;
  wk.state[0] = q; q += 16 * P + D + 4;
  wk.state[1] = q;
  wk.X = X_out;
  wk.T_out = T_out;
  wk.scal = scal;
  const int grid = grid_of(L);
  const size_t sm_T = sizeof(float) * 16 * P;
  const size_t sm_build = sm_T + (D <= kSharedD ? sizeof(double) * (D * D + D) : 0);
  const size_t sm_solve = sizeof(double) * ((D <= kSharedD ? D * (D + 1) : 0) + 3 * D);
  const size_t sm_eval = sm_T + sizeof(float) * D;
  int rc;
  init_kernel<<<grid, kLmThreads, sm_T, s>>>(pr, wk);
  if ((rc = static_cast<int>(cudaGetLastError())) != 0) return rc;
  commit_kernel<<<grid, kLmThreads, 0, s>>>(pr, wk, 1, 1);
  if ((rc = static_cast<int>(cudaGetLastError())) != 0) return rc;
  int slot = 0;
  for (int it = 0; it < iters; ++it) {
    build_kernel<<<grid, kLmThreads, sm_build, s>>>(pr, wk, slot);
    if ((rc = static_cast<int>(cudaGetLastError())) != 0) return rc;
    solve_kernel<<<1, kSolveThreads, sm_solve, s>>>(pr, wk, slot);
    if ((rc = static_cast<int>(cudaGetLastError())) != 0) return rc;
    eval_kernel<<<grid, kLmThreads, sm_eval, s>>>(pr, wk);
    if ((rc = static_cast<int>(cudaGetLastError())) != 0) return rc;
    commit_kernel<<<grid, kLmThreads, 0, s>>>(pr, wk, slot, 0);
    if ((rc = static_cast<int>(cudaGetLastError())) != 0) return rc;
    slot ^= 1;
  }
  return 0;
}
