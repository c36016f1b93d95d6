// Pose-only Levenberg-Marquardt of one frame, all rounds and iterations in
// one launch.
//
// Replaces tc2li_slam_tpu/solver/lm.py:92 (pose_only_optimize): on the TPU
// one jit-compiled program whose LM iterations are a lax.scan (:139) inside
// 4 unrolled chi2 re-gating rounds. Eager PyTorch ran the same computation
// as ~11,600 small ops a call (4 x 10), each at least one launch.
//
// What it computes is the plain version's (ops/kernels/pose_lm.py:
// pose_only_plain). For each of `rounds` rounds: lam = 1e-3 and the cost at
// T; then `iters` times H = sum w J^T J and g = sum w J^T r at T over the
// active observations, delta = -(H + lam diag(H) + 1e-8 I)^-1 g,
// T_new = exp(delta) T, accepted on a strictly lower cost (lam x 0.5, else
// x 4); after the round the active set is re-gated from `valid` by chi2 and
// depth at T. The weight w = inv_sigma2 * huber * active * depth_ok is a
// product, as there, so a masked row whose point is not finite makes every
// sum NaN and no step is accepted: the reference's behaviour.
//
// Bound on the H100: neither bytes nor operations. A 4 x 10 call at
// N = 2000 reads 60 KB (from L2 after the first pass) and does ~15 M float
// operations, ~0.5 us at the float32 rate; the limit is latency: 40 serial
// iterations, each a block-wide reduction of 28 sums and a 6x6 solve.
// Design: one block of 1024 threads, a strided loop over any N. A pass
// evaluates every observation at one pose and reduces the cost, H (its 21
// unique entries) and g in float32: registers, warp shuffles, then shared
// memory. The pass at the candidate pose T_new gives its cost and, where the
// step is accepted, the next iteration's H and g: at an unchanged pose they
// are the same numbers, so one pass an iteration does the plain version's
// two. The pass that re-gates the active set after a round is also the next
// round's first. One thread solves by Gaussian elimination with partial
// pivoting, takes se3_exp and the 4x4 product, and leaves T_new in shared
// memory. 1 + rounds * (iters + 1) passes a call, no host sync.

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using tc2li::Cam;

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kH = 21;             // upper triangle of H, row-major
constexpr int kCost = kH + 6;      // after g
constexpr int kSums = kCost + 1;

// how a pass finds each observation's active flag
enum Mode { kKeep = 0, kInit = 1, kRegate = 2 };

// Evaluate every observation at the pose T (row-major 4x4 in shared memory)
// and leave the block's sums of H, g and the cost in `out`. kKeep reads the
// active flags; kInit sets them to `valid`, kRegate to valid & chi2 <= thr &
// depth_ok at T, both counting them into *n_active. Called by every thread;
// ends with a barrier.
__device__ void pass(const float* T, const float* __restrict__ X, const float* __restrict__ uv,
                     const float* __restrict__ inv_s2, const uint8_t* __restrict__ stereo,
                     const uint8_t* __restrict__ valid, uint8_t* active, int N, const Cam cam,
                     const int mode, float (*part)[kSums + 1], unsigned* part_n, float* out,
                     int* n_active) {
  float acc[kSums];
#pragma unroll
  for (int k = 0; k < kSums; ++k) acc[k] = 0.f;
  unsigned cnt = 0;

  for (int i = threadIdx.x; i < N; i += kThreads) {
    const bool st = stereo[i] != 0;
    const tc2li::Reproj o = tc2li::reproject(T, X[3 * i], X[3 * i + 1], X[3 * i + 2],
                                             uv + 3 * i, st, cam);
    const float* r = o.r;
    const float rr = r[0] * r[0] + r[1] * r[1] + r[2] * r[2];
    const float is2 = inv_s2[i];
    const float chi2 = is2 * rr;
    const bool depth_ok = o.zc > 0.05f;
    const float thr = st ? tc2li::kChi2Stereo : tc2li::kChi2Mono;
    bool act;
    if (mode == kKeep) {
      act = active[i] != 0;
    } else {
      act = valid[i] != 0 && (mode == kInit || (chi2 <= thr && depth_ok));
      active[i] = act;
      cnt += act;
    }
    const float w = is2 * tc2li::huber(chi2, thr) * (act ? 1.f : 0.f) * (depth_ok ? 1.f : 0.f);
    acc[kCost] += w * rr;

    float J[3][6];
    tc2li::pose_jacobian(o, J);
    // (w J)^T J and (w J)^T r, the weight applied to J first as the plain
    // version does (0 * a large J stays 0)
    int idx = 0;
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      const float w0 = J[0][j] * w, w1 = J[1][j] * w, w2 = J[2][j] * w;
#pragma unroll
      for (int k = j; k < 6; ++k) acc[idx++] += w0 * J[0][k] + w1 * J[1][k] + w2 * J[2][k];
      acc[kH + j] += w0 * r[0] + w1 * r[1] + w2 * r[2];
    }
  }

  // reduce: each warp by shuffles, then the warps' partials in shared memory
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < kSums; ++k) {
    float s = acc[k];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) part[warp][k] = s;
  }
  if (mode != kKeep) {
    cnt = __reduce_add_sync(0xffffffffu, cnt);
    if (lane == 0) part_n[warp] = cnt;
  }
  __syncthreads();
  for (int k = warp; k <= kSums; k += kWarps) {
    if (k == kSums) {
      if (mode != kKeep) {
        unsigned c = lane < kWarps ? part_n[lane] : 0u;
        c = __reduce_add_sync(0xffffffffu, c);
        if (lane == 0) *n_active = static_cast<int>(c);
      }
    } else {
      float s = lane < kWarps ? part[lane][k] : 0.f;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      if (lane == 0) out[k] = s;
    }
  }
  __syncthreads();
}

// One LM step on one thread: solve (H + lam diag(H) + 1e-8 I) x = g from
// the sums `s`, then Tn = se3_exp(-x) T (geom/lie.py se3_exp).
__device__ void lm_step(const float* s, float lam, const float* T, float* Tn) {
  float A[6][6], b[6];
  int idx = 0;
#pragma unroll
  for (int j = 0; j < 6; ++j) {
#pragma unroll
    for (int k = j; k < 6; ++k) {
      A[j][k] = s[idx];
      A[k][j] = s[idx];
      ++idx;
    }
    b[j] = s[kH + j];
  }
#pragma unroll
  for (int j = 0; j < 6; ++j) A[j][j] = A[j][j] + lam * A[j][j] + 1e-8f;

  // Gaussian elimination with partial pivoting (the first largest |a|, as
  // LAPACK's getrf); rows swapped by selects so that A stays in registers
#pragma unroll
  for (int c = 0; c < 6; ++c) {
    int p = c;
    float best = fabsf(A[c][c]);
#pragma unroll
    for (int r = c + 1; r < 6; ++r) {
      if (fabsf(A[r][c]) > best) {
        best = fabsf(A[r][c]);
        p = r;
      }
    }
#pragma unroll
    for (int r = c + 1; r < 6; ++r) {
      if (r == p) {
#pragma unroll
        for (int k = c; k < 6; ++k) {
          const float tmp = A[r][k];
          A[r][k] = A[c][k];
          A[c][k] = tmp;
        }
        const float tmp = b[r];
        b[r] = b[c];
        b[c] = tmp;
      }
    }
    const float inv = 1.f / A[c][c];
#pragma unroll
    for (int r = c + 1; r < 6; ++r) {
      const float l = A[r][c] * inv;
#pragma unroll
      for (int k = c + 1; k < 6; ++k) A[r][k] -= l * A[c][k];
      b[r] -= l * b[c];
    }
  }
  float x[6];
#pragma unroll
  for (int r = 5; r >= 0; --r) {
    float acc = b[r];
#pragma unroll
    for (int k = r + 1; k < 6; ++k) acc -= A[r][k] * x[k];
    x[r] = acc / A[r][r];
  }

  const float xi[6] = {-x[0], -x[1], -x[2], -x[3], -x[4], -x[5]};
  tc2li::se3_exp_left(xi, T, Tn);
}

__global__ void __launch_bounds__(kThreads, 1)
pose_lm_kernel(const float* __restrict__ T0, const float* __restrict__ X,
               const float* __restrict__ uv, const float* __restrict__ inv_s2,
               const uint8_t* __restrict__ stereo, const uint8_t* __restrict__ valid, int N,
               const Cam cam, int rounds, int iters, float* __restrict__ T_out, uint8_t* active,
               int* __restrict__ n_inliers, float* __restrict__ cost_out) {
  __shared__ float sT[16];      // the accepted pose
  __shared__ float sTn[16];     // the candidate
  __shared__ float sums[kSums];
  __shared__ float part[kWarps][kSums + 1];   // odd row stride: no bank conflicts
  __shared__ unsigned part_n[kWarps];
  __shared__ int n_active;
  if (threadIdx.x < 16) sT[threadIdx.x] = T0[threadIdx.x];
  __syncthreads();

  // thread 0's state: the sums at the accepted pose, lam, the round's cost
  float cur[kSums];
  float lam = 1e-3f, cost = 0.f;
  pass(sT, X, uv, inv_s2, stereo, valid, active, N, cam, kInit, part, part_n, sums, &n_active);
  for (int round = 0; round < rounds; ++round) {
    if (threadIdx.x == 0) {
#pragma unroll
      for (int k = 0; k < kSums; ++k) cur[k] = sums[k];
      lam = 1e-3f;
    }
    for (int it = 0; it < iters; ++it) {
      if (threadIdx.x == 0) lm_step(cur, lam, sT, sTn);
      __syncthreads();
      pass(sTn, X, uv, inv_s2, stereo, valid, active, N, cam, kKeep, part, part_n, sums, &n_active);
      if (threadIdx.x == 0) {
        if (sums[kCost] < cur[kCost]) {   // NaN rejects
#pragma unroll
          for (int k = 0; k < 16; ++k) sT[k] = sTn[k];
#pragma unroll
          for (int k = 0; k < kSums; ++k) cur[k] = sums[k];
          lam *= 0.5f;
        } else {
          lam *= 4.f;
        }
      }
    }
    if (threadIdx.x == 0) cost = cur[kCost];
    __syncthreads();
    pass(sT, X, uv, inv_s2, stereo, valid, active, N, cam, kRegate, part, part_n, sums, &n_active);
  }
  if (threadIdx.x < 16) T_out[threadIdx.x] = sT[threadIdx.x];
  if (threadIdx.x == 0) {
    *n_inliers = n_active;
    *cost_out = cost;
  }
}

}  // namespace

// T0 [4, 4], X [N, 3], uv [N, 3] (u, v, u_r), inv_s2 [N] float32; stereo,
// valid [N] uint8 (0 or 1); outputs T_out [4, 4] float32, inliers [N] uint8
// (also the active set between rounds), n_inliers int32, cost float32; all
// contiguous on the device. Launches on `stream`, returns cudaGetLastError().
extern "C" int tc2li_pose_only_lm(const float* T0, const float* X, const float* uv,
                                  const float* inv_s2, const uint8_t* stereo,
                                  const uint8_t* valid, int N, float fx, float fy, float cx,
                                  float cy, float bf, int rounds, int iters, float* T_out,
                                  uint8_t* inliers, int* n_inliers, float* cost, void* stream) {
  const Cam cam{fx, fy, cx, cy, bf};
  pose_lm_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      T0, X, uv, inv_s2, stereo, valid, N, cam, rounds, iters, T_out, inliers, n_inliers, cost);
  return static_cast<int>(cudaGetLastError());
}
