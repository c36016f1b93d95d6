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

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kH = 21;             // upper triangle of H, row-major
constexpr int kCost = kH + 6;      // after g
constexpr int kSums = kCost + 1;
constexpr float kChi2Mono = 5.991f;     // solver/factors.py CHI2_MONO
constexpr float kChi2Stereo = 7.815f;   // CHI2_STEREO
constexpr float kEps = 5e-3f;           // geom/lie.py _EPS: Taylor branches below it

// how a pass finds each observation's active flag
enum Mode { kKeep = 0, kInit = 1, kRegate = 2 };

struct Cam {
  float fx, fy, cx, cy, bf;
};

__device__ __forceinline__ float z_safe(float z) { return fabsf(z) < 1e-9f ? 1e-9f : z; }

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
  const float R00 = T[0], R01 = T[1], R02 = T[2], t0 = T[3];
  const float R10 = T[4], R11 = T[5], R12 = T[6], t1 = T[7];
  const float R20 = T[8], R21 = T[9], R22 = T[10], t2 = T[11];
  float acc[kSums];
#pragma unroll
  for (int k = 0; k < kSums; ++k) acc[k] = 0.f;
  unsigned cnt = 0;

  for (int i = threadIdx.x; i < N; i += kThreads) {
    const float x = X[3 * i], y = X[3 * i + 1], zw = X[3 * i + 2];
    const float xc = R00 * x + R01 * y + R02 * zw + t0;
    const float yc = R10 * x + R11 * y + R12 * zw + t1;
    const float zc = R20 * x + R21 * y + R22 * zw + t2;
    const float z = z_safe(zc);
    const bool st = stereo[i] != 0;
    // residual (predicted - observed); the third row selected to 0 for mono
    const float u = cam.fx * xc / z + cam.cx;
    const float v = cam.fy * yc / z + cam.cy;
    const float r[3] = {u - uv[3 * i], v - uv[3 * i + 1],
                        st ? (u - cam.bf / z) - uv[3 * i + 2] : 0.f};
    const float rr = r[0] * r[0] + r[1] * r[1] + r[2] * r[2];
    const float is2 = inv_s2[i];
    const float chi2 = is2 * rr;
    const bool depth_ok = zc > 0.05f;
    const float thr = st ? kChi2Stereo : kChi2Mono;
    bool act;
    if (mode == kKeep) {
      act = active[i] != 0;
    } else {
      act = valid[i] != 0 && (mode == kInit || (chi2 <= thr && depth_ok));
      active[i] = act;
      cnt += act;
    }
    // Huber weight; a NaN chi2 stays NaN through the clamp, as torch.clamp
    const float huber = chi2 <= thr ? 1.f : sqrtf(thr / (chi2 < 1e-12f ? 1e-12f : chi2));
    const float w = is2 * huber * (act ? 1.f : 0.f) * (depth_ok ? 1.f : 0.f);
    acc[kCost] += w * rr;

    // d(u, v, u_r)/dXc, its mono row selected to 0; then J = a [I | -hat(Xc)],
    // the zeros of [I | -hat(Xc)] multiplied in as in the plain version's
    // product, so a non-finite entry of `a` spreads the same way
    const float iz = 1.f / z;
    const float iz2 = iz * iz;
    const float a[3][3] = {{cam.fx * iz, 0.f, -cam.fx * xc * iz2},
                           {0.f, cam.fy * iz, -cam.fy * yc * iz2},
                           {st ? cam.fx * iz : 0.f, 0.f, st ? (-cam.fx * xc + cam.bf) * iz2 : 0.f}};
    float J[3][6];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      J[k][0] = a[k][0];
      J[k][1] = a[k][1];
      J[k][2] = a[k][2];
      J[k][3] = a[k][0] * 0.f + a[k][1] * (-zc) + a[k][2] * yc;
      J[k][4] = a[k][0] * zc + a[k][1] * 0.f + a[k][2] * (-xc);
      J[k][5] = a[k][0] * (-yc) + a[k][1] * xc + a[k][2] * 0.f;
    }
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

  // se3_exp of xi = -x = (rho, phi)
  const float rho[3] = {-x[0], -x[1], -x[2]};
  const float p0 = -x[3], p1 = -x[4], p2 = -x[5];
  float th2 = p0 * p0 + p1 * p1 + p2 * p2;
  th2 = th2 < 1e-24f ? 1e-24f : th2;
  const float th = sqrtf(th2);
  const float sa = sinc(th), ca = cosc(th), s3 = sinc3(th);
  const float W[3][3] = {{0.f, -p2, p1}, {p2, 0.f, -p0}, {-p1, p0, 0.f}};
  float E[4][4];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    float V[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float W2 = W[i][0] * W[0][j] + W[i][1] * W[1][j] + W[i][2] * W[2][j];
      const float I = i == j ? 1.f : 0.f;
      E[i][j] = I + sa * W[i][j] + ca * W2;
      V[j] = I + ca * W[i][j] + s3 * W2;
    }
    E[i][3] = V[0] * rho[0] + V[1] * rho[1] + V[2] * rho[2];
  }
  E[3][0] = E[3][1] = E[3][2] = 0.f;
  E[3][3] = 1.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      Tn[4 * i + j] = E[i][0] * T[j] + E[i][1] * T[4 + j] + E[i][2] * T[8 + j] + E[i][3] * T[12 + j];
    }
  }
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
