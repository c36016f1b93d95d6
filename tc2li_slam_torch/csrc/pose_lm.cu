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
// N = 2000 reads 60 KB and does ~15 M float operations, ~0.5 us at the
// float32 rate; the limit is latency: 45 serial passes, each a reduction
// of 28 sums over the cluster and a 6x6 solve.
// Design: a cluster of 8 blocks of 512 threads, an eighth of the rows each.
// A block stages its rows (point, observation, inv_sigma2, the stereo,
// valid and active flags: 31 bytes) once a call in shared memory, up to
// kStageBytes (7,096 rows); rows beyond stream from device memory. A pass
// evaluates every row at one pose, a thread taking its block's rows tid,
// tid + 512, ..., and reduces the cost, H (its 21 unique entries) and g in
// float32: each warp by a reduce-scatter (31 shuffle-adds leave sum k in
// lane k), then warp 0's lane k adds the 16 warps' sum k in warp order and
// writes it into every block's slot (distributed shared memory); after one
// cluster barrier every block's warp 0 adds the 8 slots in block order, so
// all blocks hold the same sums. Warp 0 of every block keeps the state
// (lane k the accepted sum k, lam) and takes the same step: every lane
// solves the 6x6 by Gaussian elimination with partial pivoting (the first
// largest |a|, as before) in its registers, and lanes 0..15 take one entry
// each of se3_exp(-x) T. The pass at the candidate pose gives its cost and,
// where the step is accepted, the next iteration's H and g: at an
// unchanged pose they are the same numbers, so one pass an iteration does
// the plain version's two. The pass that re-gates the active set after a
// round is also the next round's first. 1 + rounds * (iters + 1) passes a
// call, no host sync. (In one block the rows ran at one SM's issue rate,
// ~60% of a pass at N 2000.)

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

using tc2li::Cam;

constexpr int kBlocks = 8;     // blocks of the cluster, a share of the rows each
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kH = 21;             // upper triangle of H, row-major
constexpr int kCost = kH + 6;      // after g
constexpr int kRowBytes = 31;      // X, uv, inv_sigma2 (float32), stereo, valid, active
constexpr int kStageBytes = 220000;
constexpr int kStageRows = kStageBytes / kRowBytes;

// how a pass finds each observation's active flag
enum Mode { kKeep = 0, kInit = 1, kRegate = 2 };

// the rows: [0, ns) in shared memory, the rest in device memory
struct Rows {
  const float* X;         // device [N, 3]
  const float* uv;        // [N, 3]
  const float* s2;        // [N]
  const uint8_t* stereo;  // [N]
  const uint8_t* valid;   // [N]
  uint8_t* active;        // [N] (the inlier output)
  float* sX;              // shared [ns, 3]
  float* suv;             // [ns, 3]
  float* ss2;             // [ns]
  uint8_t* sst;           // [ns]
  uint8_t* sva;           // [ns]
  uint8_t* sact;          // [ns]
  int N, ns;
};

// one step of the reduce-scatter: a lane keeps the half of its 2 O values
// on its side of bit O and adds the partner's copy of that half (the loop
// bound a template constant, so that v stays in registers)
template <int O>
__device__ __forceinline__ void scatter_step(float (&v)[32], int lane) {
  const bool up = (lane & O) != 0;
#pragma unroll
  for (int i = 0; i < O; ++i) {
    const float send = up ? v[i] : v[i + O];
    const float keep = up ? v[i + O] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, O);
  }
}

// lane k ends with the warp's sum of v[k]: 16 + 8 + 4 + 2 + 1 shuffle-adds,
// in a fixed order
__device__ __forceinline__ float reduce_scatter(float (&v)[32], int lane) {
  scatter_step<16>(v, lane);
  scatter_step<8>(v, lane);
  scatter_step<4>(v, lane);
  scatter_step<2>(v, lane);
  scatter_step<1>(v, lane);
  return v[0];
}

// One row at the pose T into the thread's sums: the residual, its gates
// and weight, the Jacobian; kShared reads the staged copy of the row.
template <bool kShared>
__device__ __forceinline__ void add_row(const float* T, const Rows& rw, const Cam cam,
                                        const int mode, const int i, float (&acc)[32],
                                        unsigned& cnt) {
  const float* Xi = kShared ? rw.sX + 3 * i : rw.X + 3 * i;
  const float* uvi = kShared ? rw.suv + 3 * i : rw.uv + 3 * i;
  const bool st = (kShared ? rw.sst[i] : rw.stereo[i]) != 0;
  uint8_t* acti = kShared ? rw.sact + i : rw.active + i;
  const tc2li::Reproj o = tc2li::reproject(T, Xi[0], Xi[1], Xi[2], uvi, st, cam);
  const float* r = o.r;
  const float rr = r[0] * r[0] + r[1] * r[1] + r[2] * r[2];
  const float is2 = kShared ? rw.ss2[i] : rw.s2[i];
  const float chi2 = is2 * rr;
  const bool depth_ok = o.zc > 0.05f;
  const float thr = st ? tc2li::kChi2Stereo : tc2li::kChi2Mono;
  bool act;
  if (mode == kKeep) {
    act = *acti != 0;
  } else {
    const bool va = (kShared ? rw.sva[i] : rw.valid[i]) != 0;
    act = va && (mode == kInit || (chi2 <= thr && depth_ok));
    *acti = act;
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

// Evaluate every row at the pose T (row-major 4x4 in shared memory). Warp
// 0's lane k returns the block's sum k (H, g, the cost), lane 0 also the
// active count in *n_active where the mode sets the flags; other threads
// return 0. kKeep reads the active flags; kInit sets them to `valid`,
// kRegate to valid & chi2 <= thr & depth_ok at T. Called by every thread;
// its one barrier follows the warps' partial sums.
__device__ __forceinline__ float pass(const float* T, const Rows& rw, const Cam cam,
                                      const int mode, float (*part)[33], unsigned* part_n,
                                      int* n_active) {
  float acc[32];
#pragma unroll
  for (int k = 0; k < 32; ++k) acc[k] = 0.f;
  unsigned cnt = 0;
  float Tr[12];   // the pose's top rows in registers (the rows' flag stores may alias it)
#pragma unroll
  for (int k = 0; k < 12; ++k) Tr[k] = T[k];
  for (int i = threadIdx.x; i < rw.N; i += kThreads) {
    if (i < rw.ns)
      add_row<true>(Tr, rw, cam, mode, i, acc, cnt);
    else
      add_row<false>(Tr, rw, cam, mode, i, acc, cnt);
  }

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  part[warp][lane] = reduce_scatter(acc, lane);
  if (mode != kKeep) {
    cnt = __reduce_add_sync(0xffffffffu, cnt);
    if (lane == 0) part_n[warp] = cnt;
  }
  __syncthreads();
  float s = 0.f;
  if (warp == 0) {   // the warps' partials in warp order
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += part[w][lane];
    if (mode != kKeep && lane == 0) {
      unsigned c = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) c += part_n[w];
      *n_active = static_cast<int>(c);
    }
  }
  return s;
}

// One LM step on warp 0: solve (H + lam diag(H) + 1e-8 I) x = g from the
// sums (lane k holds sum k), then Tn = se3_exp(-x) T (geom/lie.py se3_exp).
// Every lane gathers the 28 sums and eliminates the whole 6x6 in its own
// registers (Gaussian elimination with partial pivoting, the first largest
// |a| as LAPACK's getrf, rows swapped by selects); lanes 0..15 then take one
// entry each of the 4x4 product. (Rows on lanes, with the pivot search and
// the swaps by shuffles, was slower on the H100: each column's shuffles lie
// on the critical path.)
__device__ void lm_step(float sum, float lam, const float* T, float* Tn) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  float A[6][6], b[6];
  int idx = 0;
#pragma unroll
  for (int j = 0; j < 6; ++j) {
#pragma unroll
    for (int k = j; k < 6; ++k) {
      const float v = __shfl_sync(full, sum, idx++);
      A[j][k] = v;
      A[k][j] = v;
    }
  }
#pragma unroll
  for (int j = 0; j < 6; ++j) b[j] = __shfl_sync(full, sum, kH + j);
#pragma unroll
  for (int j = 0; j < 6; ++j) A[j][j] = A[j][j] + lam * A[j][j] + 1e-8f;
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
  const tc2li::Se3Exp e = tc2li::se3_exp_coef(xi);
  float v = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float vi = tc2li::se3_exp_left_entry(e, T, i, lane & 3);
    if (i == lane >> 2) v = vi;
  }
  if (lane < 16) Tn[lane] = v;
}

__global__ void __launch_bounds__(kThreads, 1)
pose_lm_kernel(const float* __restrict__ T0, const float* __restrict__ X,
               const float* __restrict__ uv, const float* __restrict__ inv_s2,
               const uint8_t* __restrict__ stereo, const uint8_t* __restrict__ valid, int N,
               int ns, const Cam cam, int rounds, int iters, float* __restrict__ T_out,
               uint8_t* active, int* __restrict__ n_inliers, float* __restrict__ cost_out) {
  extern __shared__ float stage[];
  __shared__ float sT[16];      // the accepted pose
  __shared__ float sTn[16];     // the candidate
  __shared__ float part[kWarps][33];   // odd row stride: no bank conflicts
  __shared__ unsigned part_n[kWarps];
  __shared__ int n_active;
  __shared__ float slot[2][kBlocks][33];   // each block's sums (and count), by pass parity
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  // this block's rows: [r0, r0 + nr), the first ns of them staged
  const int per = (N + kBlocks - 1) / kBlocks;
  const int r0 = min(rank * per, N), nr = min(per, N - r0), nsb = min(ns, nr);
  Rows rw{X + 3 * r0, uv + 3 * r0, inv_s2 + r0, stereo + r0, valid + r0, active + r0,
          stage, stage + 3 * nsb, stage + 6 * nsb, reinterpret_cast<uint8_t*>(stage + 7 * nsb),
          nullptr, nullptr, nr, nsb};
  rw.sva = rw.sst + nsb;
  rw.sact = rw.sva + nsb;
  for (int e = threadIdx.x; e < 3 * nsb; e += kThreads) {
    rw.sX[e] = rw.X[e];
    rw.suv[e] = rw.uv[e];
  }
  for (int e = threadIdx.x; e < nsb; e += kThreads) {
    rw.ss2[e] = rw.s2[e];
    rw.sst[e] = rw.stereo[e];
    rw.sva[e] = rw.valid[e];
  }
  if (threadIdx.x < 16) sT[threadIdx.x] = T0[threadIdx.x];
  __syncthreads();
  cluster.sync();   // every block runs before any writes into another

  const int lane = threadIdx.x & 31;
  const bool w0 = threadIdx.x < 32;
  int par = 0;
  // a pass over this block's rows, then the blocks' sums in block order in
  // every block's warp 0 (lane k: sum k; n_active the count)
  auto all_pass = [&](const float* T, int mode) {
    const float mine = pass(T, rw, cam, mode, part, part_n, &n_active);
    if (w0) {
      for (int q = 0; q < kBlocks; ++q) {
        float* dst = cluster.map_shared_rank(&slot[par][rank][0], q);
        dst[lane] = mine;
        if (lane == 0) dst[32] = __int_as_float(n_active);
      }
    }
    cluster.sync();
    float tot = 0.f;
    if (w0) {
      int cnt = 0;
      for (int q = 0; q < kBlocks; ++q) {
        tot += slot[par][q][lane];
        cnt += __float_as_int(slot[par][q][32]);
      }
      if (lane == 0 && mode != kKeep) n_active = cnt;
    }
    par ^= 1;
    return tot;
  };
  // warp 0's state: lane k's sum at the accepted pose, lam, the round's cost
  float cur = 0.f, lam = 1e-3f, cost = 0.f;
  float s = all_pass(sT, kInit);
  for (int round = 0; round < rounds; ++round) {
    if (w0) {
      cur = s;
      lam = 1e-3f;
    }
    for (int it = 0; it < iters; ++it) {
      if (w0) lm_step(cur, lam, sT, sTn);
      __syncthreads();
      s = all_pass(sTn, kKeep);
      if (w0) {
        const float c_new = __shfl_sync(0xffffffffu, s, kCost);
        const float c_cur = __shfl_sync(0xffffffffu, cur, kCost);
        if (c_new < c_cur) {   // NaN rejects
          if (lane < 16) sT[lane] = sTn[lane];
          __syncwarp();
          cur = s;
          lam *= 0.5f;
        } else {
          lam *= 4.f;
        }
      }
    }
    if (w0) cost = __shfl_sync(0xffffffffu, cur, kCost);
    __syncthreads();
    s = all_pass(sT, kRegate);
  }
  for (int e = threadIdx.x; e < nsb; e += kThreads) rw.active[e] = rw.sact[e];
  __syncthreads();
  if (rank != 0) return;
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
// contiguous on the device. Launches on `stream`, returns the first CUDA
// error code that is not cudaSuccess (a refused launch included).
extern "C" int tc2li_pose_only_lm(const float* T0, const float* X, const float* uv,
                                  const float* inv_s2, const uint8_t* stereo,
                                  const uint8_t* valid, int N, float fx, float fy, float cx,
                                  float cy, float bf, int rounds, int iters, float* T_out,
                                  uint8_t* inliers, int* n_inliers, float* cost, void* stream) {
  const Cam cam{fx, fy, cx, cy, bf};
  const int per = (N < 0 ? 0 : N + kBlocks - 1) / kBlocks;   // rows a block
  const int ns = per < kStageRows ? per : kStageRows;
  // 7 floats a row, then its 3 flags
  const size_t smem = sizeof(float) * 7 * static_cast<size_t>(ns) + 3 * static_cast<size_t>(ns);
  int rc = static_cast<int>(cudaFuncSetAttribute(
      pose_lm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)));
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
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  rc = static_cast<int>(cudaLaunchKernelEx(&cfg, pose_lm_kernel, T0, X, uv, inv_s2, stereo, valid,
                                           N, ns, cam, rounds, iters, T_out, inliers, n_inliers,
                                           cost));
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
