// Device code shared by the two Schur-complement window BAs (local_ba.cu,
// lvi_ba.cu): the pair table of the reduced system's 6x6 visual blocks
// (ops/kernels/local_ba.py: pair_table) and its reduction a warp a chunk, a
// block's sum in a fixed order, and the solve's Gauss-Jordan elimination
// with partial pivoting over one block or a cluster. Each kernel keeps its
// work struct with the members the reduction reads and writes (part, W, B,
// Hd, gd, live, done).
#pragma once

#include <climits>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace {

constexpr int kPart = 42;        // a chunk's sums: its 6x6 block of S, then 6 of g

// the pair table (ops/kernels/local_ba.py: pair_table), block b of the
// upper blocks (p1 <= p2) numbered row by row
struct Table {
  const long long* order;   // [E] each pair's l K K + k1 K + k2
  const long long* start;   // [nb + 1] each block's first pair
  const long long* cstart;  // [nb + 1] each block's first chunk
  int nb;
  int chunk;                // pairs a chunk at least
  int max_chunks;           // chunks a block at most
  int K;
};

__device__ __forceinline__ int block_of(int p1, int p2, int P) {
  return p1 * P - p1 * (p1 - 1) / 2 + (p2 - p1);
}

__device__ __forceinline__ int clamp_pose(int p, int P) { return p < 0 ? 0 : (p > P - 1 ? P - 1 : p); }

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

// (reduce) a warp a chunk of the pair table. A block of S (p1 <= p2) is cut
// into at most tb.max_chunks chunks of at least tb.chunk pairs. Lane l takes
// the chunk's pairs l, l + 32, ... in order: it reads the pair's W (9
// double2) and B (9 float2), the next pair's already in flight, and adds
// the pair's term into its 42 float64 sums (the block of S row by row, then
// g): minus W_k1 B_k2^T where the second observation's weight is not 0, plus
// Hpp and gp - W gl on a diagonal pair (k1 = k2). The lanes' sums are then
// added by a fixed shuffle tree. The last warp to finish a block of S (a
// counter a block) adds the block's chunk rows in chunk order into its first
// chunk's row: the solve reads one row a block.
struct PairData {
  double W[18];
  float B[18];
  int o1;
  bool live2, diag, here;
};

template <class W>
__device__ __forceinline__ void load_pair(const Table& tb, const W& wk, int e, bool here,
                                          PairData& d) {
  d.here = here;
  if (!here) return;
  const int ord = static_cast<int>(__ldg(tb.order + e));   // L K K < 2^31
  const int lk1 = ord / tb.K;                              // l K + k1
  const int o1 = lk1, o2 = lk1 - lk1 % tb.K + ord % tb.K;
  const double2* W1 = reinterpret_cast<const double2*>(wk.W + static_cast<size_t>(o1) * 18);
  const float2* B2 = reinterpret_cast<const float2*>(wk.B + static_cast<size_t>(o2) * 18);
#pragma unroll
  for (int q = 0; q < 9; ++q) {
    const double2 w = __ldg(W1 + q);
    const float2 b = __ldg(B2 + q);
    d.W[2 * q] = w.x;
    d.W[2 * q + 1] = w.y;
    d.B[2 * q] = b.x;
    d.B[2 * q + 1] = b.y;
  }
  d.o1 = o1;
  d.live2 = __ldg(wk.live + o2) != 0;
  d.diag = o1 == o2;
}
template <int kWarps, class W>
__device__ __forceinline__ void reduce_chunks(const Table& tb, W& wk) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const int w = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (w >= tb.cstart[tb.nb]) return;   // the whole warp
  int lo = 0, hi = tb.nb - 1;          // the last block whose first chunk is <= w
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (tb.cstart[mid] <= w) lo = mid; else hi = mid - 1;
  }
  const int b0 = static_cast<int>(tb.start[lo]), cnt = static_cast<int>(tb.start[lo + 1]) - b0;
  const int len = max(tb.chunk, (cnt + tb.max_chunks - 1) / tb.max_chunks);
  const int e0 = b0 + (w - static_cast<int>(tb.cstart[lo])) * len;
  const int e1 = min(e0 + len, b0 + cnt);
  double acc[kPart];
#pragma unroll
  for (int q = 0; q < kPart; ++q) acc[q] = 0.0;
  PairData cur, nxt;
  load_pair(tb, wk, e0 + lane, e0 + lane < e1, cur);
  for (int e = e0 + lane; e - lane < e1; e += 32) {
    load_pair(tb, wk, e + 32, e + 32 < e1, nxt);
    if (cur.here) {
#pragma unroll
      for (int r = 0; r < 6; ++r)
#pragma unroll
        for (int c = 0; c < 6; ++c) {
          const double v = cur.W[3 * r] * cur.B[3 * c] + cur.W[3 * r + 1] * cur.B[3 * c + 1] +
                           cur.W[3 * r + 2] * cur.B[3 * c + 2];
          acc[6 * r + c] -= cur.live2 ? v : 0.0;
        }
      if (cur.diag) {
        const float4* H1 = reinterpret_cast<const float4*>(wk.Hd + static_cast<size_t>(cur.o1) * 36);
        const double2* G1 = reinterpret_cast<const double2*>(wk.gd + static_cast<size_t>(cur.o1) * 6);
#pragma unroll
        for (int q = 0; q < 9; ++q) {
          const float4 h = __ldg(H1 + q);
          acc[4 * q] += static_cast<double>(h.x);
          acc[4 * q + 1] += static_cast<double>(h.y);
          acc[4 * q + 2] += static_cast<double>(h.z);
          acc[4 * q + 3] += static_cast<double>(h.w);
        }
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          const double2 gv = __ldg(G1 + q);
          acc[36 + 2 * q] += gv.x;
          acc[36 + 2 * q + 1] += gv.y;
        }
      }
    }
    cur = nxt;
  }
  // the lanes' sums by a fixed shuffle tree; lane q keeps sum q (and q + 32)
  double* out = wk.part + static_cast<size_t>(w) * kPart;
#pragma unroll
  for (int q = 0; q < kPart; ++q) {
    double v = acc[q];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(full, v, o);
    if (lane == (q & 31)) out[q] = v;
  }
  // the block's last chunk to finish adds them all, in chunk order
  __threadfence();
  int last = 0;
  if (lane == 0) last = atomicAdd(wk.done + lo, 1) == tb.cstart[lo + 1] - tb.cstart[lo] - 1;
  if (!__shfl_sync(full, last, 0)) return;
  __threadfence();
  const int ch0 = static_cast<int>(tb.cstart[lo]), nch = static_cast<int>(tb.cstart[lo + 1]) - ch0;
  const double* rows = wk.part + static_cast<size_t>(ch0) * kPart;
  const int q1 = lane + 32;
  double t0 = 0.0, t1 = 0.0;
#pragma unroll 8
  for (int ch = 0; ch < nch; ++ch) {
    t0 += __ldcg(rows + static_cast<size_t>(ch) * kPart + lane);
    t1 += __ldcg(rows + static_cast<size_t>(ch) * kPart + (q1 < kPart ? q1 : lane));
  }
  double* first = wk.part + static_cast<size_t>(ch0) * kPart;
  first[lane] = t0;
  if (q1 < kPart) first[q1] = t1;
  if (lane == 0) wk.done[lo] = 0;
}

// The solve's Gauss-Jordan elimination with partial pivoting of the scaled
// system [Df, Df + 1] (the right-hand side in column Df, rows Wd = Df + 1
// doubles apart): in one block (multi false: M holds every row, r0 0) or in
// a cluster of kClusterN blocks (this block's rows [r0, r0 + nloc), M's row
// i is row r0 + i). The rows stay where they are: every block keeps the same
// permutation (position <-> row: pos2row, row2pos, the identity at entry),
// so the pivot of column c is the first largest |a| by position among the
// rows not yet pivots, as with swapped rows. A column: warp 0 finds its
// block's best candidate row; alone, the block updates its rows but that
// one; in the cluster, the block writes it, with its |a|, position, row and
// 1 / a, into its slot in every block (`cand`: [2][kClusterN] slots of cw
// doubles, the scalars at cw - 4 .. cw - 1; distributed shared memory), one
// cluster barrier, then each block picks the winner from its own slots and
// updates its rows but the pivot row. On return, row r's pivot sits in
// column row2pos[r].
template <int kThreads, int kClusterN>
__device__ void gauss_jordan(cooperative_groups::cluster_group& cluster, double* M, double* cand,
                             int* pos2row, int* row2pos, int Df, int cw, int r0, int nloc,
                             bool multi, int rank) {
  __shared__ int s_row, s_pos;
  __shared__ double s_best;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, Wd = Df + 1, D = cw - 5;
  // this block's candidate for the pivot of column c, in every lane of the
  // calling warp: the first largest |a| by position among the rows not yet
  // pivots; a NaN never wins; the row at position c stands in, |a| -1,
  // where no row has a number (the serial rule's start)
  auto candidate = [&](int c, double& best, int& bpos, int& brow) {
    const int rc = pos2row[c];
    const bool owns_c = rc >= r0 && rc < r0 + nloc;
    best = -1.0;
    bpos = owns_c ? c : INT_MAX;
    brow = owns_c ? rc : -1;
    for (int i = lane; i < nloc; i += 32) {
      const int pos = row2pos[r0 + i];
      const double v = fabs(M[i * Wd + c]);
      if (pos >= c && (v > best || (v == best && pos < bpos))) {
        best = v;
        bpos = pos;
        brow = r0 + i;
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const double ob = __shfl_xor_sync(0xffffffffu, best, o);
      const int op = __shfl_xor_sync(0xffffffffu, bpos, o);
      const int orw = __shfl_xor_sync(0xffffffffu, brow, o);
      if (ob > best || (ob == best && op < bpos)) {
        best = ob;
        bpos = op;
        brow = orw;
      }
    }
  };
  // positions c and wpos swap their rows (p the pivot row)
  auto swap_positions = [&](int c, int wpos, int p) {
    const int rc = pos2row[c];
    pos2row[c] = p;
    pos2row[wpos] = rc;
    row2pos[p] = c;
    row2pos[rc] = wpos;
  };
  if (!multi) {
    // block 0 holds every row: the pivot row read where it is (its step
    // leaves it as it is)
    for (int c = 0; c < Df; ++c) {
      if (warp == 0) {
        double best;
        int bpos, brow;
        candidate(c, best, bpos, brow);
        if (lane == 0) {
          s_pos = bpos;
          s_row = brow;
        }
      }
      __syncthreads();
      const int p = s_row, wpos = s_pos;
      const double* prow = M + p * Wd;
      const double inv = __drcp_rn(prow[c]);   // 1 / a, correctly rounded
      for (int i = warp; i < nloc; i += kThreads / 32) {   // a warp a row
        if (i == p) continue;
        const double l = M[i * Wd + c] * inv;
        for (int k = c + 1 + lane; k < Wd; k += 32) M[i * Wd + k] -= l * prow[k];
      }
      if (tid == 0) swap_positions(c, wpos, p);
      __syncthreads();
    }
  } else {
    cluster.sync();   // every block runs before any writes into another
    for (int c = 0; c < Df; ++c) {
      const int par = c & 1;
      if (warp == 0) {
        double best;
        int bpos, brow;
        candidate(c, best, bpos, brow);
        if (lane == 0) {
          s_best = best;
          s_pos = bpos;
          s_row = brow;
        }
      }
      __syncthreads();
      // the candidate into slot [par][rank] of every block, then one barrier
      const int brow = s_row;
      for (int q = 0; q < kClusterN; ++q) {
        double* dst = cluster.map_shared_rank(cand, q) + (par * kClusterN + rank) * cw;
        if (brow >= 0)
          for (int k = c + tid; k < Wd; k += blockDim.x) dst[k] = M[(brow - r0) * Wd + k];
      }
      if (tid < kClusterN) {   // the scalars, a thread a block
        double* dst = cluster.map_shared_rank(cand, tid) + (par * kClusterN + rank) * cw;
        dst[D + 1] = s_best;
        dst[D + 2] = s_pos;
        dst[D + 3] = brow;
        dst[D + 4] = brow >= 0 ? __drcp_rn(M[(brow - r0) * Wd + c]) : 0.0;
      }
      cluster.sync();
      // the winner over the blocks, in every warp, from this block's slots:
      // lane q < kClusterN reads slot q; (largest, first) is associative
      double wbest = -1.0;
      int wq = lane, wpos = INT_MAX;
      if (lane < kClusterN) {
        const double* sq = cand + (par * kClusterN + lane) * cw;
        wbest = sq[D + 1];
        wpos = static_cast<int>(sq[D + 2]);
      }
#pragma unroll
      for (int o = 4; o > 0; o >>= 1) {
        const double ob = __shfl_xor_sync(0xffffffffu, wbest, o);
        const int op = __shfl_xor_sync(0xffffffffu, wpos, o), oq = __shfl_xor_sync(0xffffffffu, wq, o);
        if (ob > wbest || (ob == wbest && op < wpos)) {
          wbest = ob;
          wpos = op;
          wq = oq;
        }
      }
      wpos = __shfl_sync(0xffffffffu, wpos, 0);   // lanes 0..7's answer
      wq = __shfl_sync(0xffffffffu, wq, 0);
      const double* prow = cand + (par * kClusterN + wq) * cw;   // entries c .. Df
      const int p = static_cast<int>(prow[D + 3]);
      const double inv = prow[D + 4];
      for (int i = warp; i < nloc; i += kThreads / 32) {   // a warp a row
        if (r0 + i == p) continue;
        const double l = M[i * Wd + c] * inv;
        for (int k = c + 1 + lane; k < Wd; k += 32) M[i * Wd + k] -= l * prow[k];
      }
      if (tid == 0) swap_positions(c, wpos, p);
      __syncthreads();
    }
  }
}

}  // namespace
