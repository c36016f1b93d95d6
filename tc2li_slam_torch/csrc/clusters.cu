// The BALM voxel clusters of a window's LiDAR keyframes, in one launch over a
// thread-block cluster.
//
// Replaces tc2li_slam_tpu/solver/balm.py:110 (build_clusters, jit-compiled
// there, with _cluster_pass :62 and _plane_test :101). Eager PyTorch ran it
// as hundreds of small ops a call: three sorts, nine fixed-order scatter-adds
// (tensors.sum_rows), the plane tests' einsums.
//
// What it computes is the plain version's (solver/balm.py
// build_clusters_plain), from the same three tensor ops (the world points,
// the sum and the count of the valid ones): the root key of every point,
// floor((p - center) * (1 / voxel)) as PyTorch's division by a scalar
// computes it on the card; a stable sort of the keys; segment heads and
// voxel ids (ranks past max_voxels and invalid points go to a dump slot);
// per (voxel, keyframe) cell the count, the mean and the centred scatter,
// per voxel the centre; the plane test (_total_cov and the closed-form
// smallest_two_eigvals_sym3 in float32); the child keys of splittable roots
// (key * 8 + octant); the same pass over them; and the compaction to
// max_voxels slots, planar roots, then planar children, then the rest, each
// in slot order, as the plain version's stable sort of ~valid.
//
// Sums in the plain version's order: the input is [W, M] keyframe-major and
// the sort is stable, so a cell's points are one run in sorted order, in
// their original order, and sum_rows (index_put_ with accumulate, which
// sorts its indices stably and adds each run in order) adds them one at a
// time. Here a warp takes a voxel: its lanes hold the accumulators (3 for a
// cell's sum, 3 for the voxel's world sum, then 9 for a cell's scatter) and
// walk the voxel's run in order from shared memory, a chunk of 32 points
// staged while the previous one is walked, with separate roundings
// (__fadd_rn, __fmul_rn: no contraction into an FMA), so N, mean, Pc and
// center are bit-equal to the plain version on the card. The planar flags
// may differ where lambda0 / (ratio lambda1) rounds across 1.
//
// Bound on the H100: latency. A call moves ~0.4 MB at W 6 and M 2048 and
// does ~1 M operations; what takes the time is the chain of dependent steps:
// the sorts' passes and the longest voxel's run added in order. Design: one
// cluster of 16 blocks of 1024 threads (8 where 16 do not fit), scratch in
// device memory (any W, M and max_voxels). The sorts are stable counting
// passes over the cluster: a warp counts the digits of its own contiguous
// items in shared memory (__match_any_sync groups equal digits), the counts
// are scanned in (digit, block, warp) order through distributed shared
// memory, and each item goes to its digit's next place, so the permutation
// is the stable one. A sort takes only the bits its keys need, plus one
// that puts the items not kept after the rest (invalid points; points of no
// splittable root), at most 10 a pass: the root key's rank in the box of
// the window's occupied cells (two passes for a box below 2^19 cells, three
// at most); for the children the root's voxel id (its key's rank) and the
// octant, ceil(log2(8 V)) bits (two passes), whose order is that of
// key_root * 8 + octant. A warp builds a voxel's row in its shared memory
// (the plane test's per-keyframe terms one lane a keyframe, their sums on
// one lane in order); rows are written only where a voxel holds points (an
// empty row is zero in the output, without a read), and the copy to the
// output slots goes a warp a slot. No float atomics: the same inputs give
// the same bits on every call.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#ifndef TC2LI_STAMP   // clock stamps and laps of a phase split (tools/balm_kernels.py)
#define TC2LI_STAMP(k)
#define TC2LI_LAP_START
#define TC2LI_LAP(k)
#endif

namespace cg = cooperative_groups;

namespace {

constexpr int kT = 1024;                   // threads a block
constexpr int kWarps = kT / 32;
constexpr unsigned kBigKey = 0x7FFFFFFFu;  // solver/balm.py BIG_KEY
constexpr int kDigitBits = 10;             // at most, a counting pass
constexpr int kMaxDigits = 1 << kDigitBits;
constexpr int kStage = 7 * 32;             // a warp's chunk: LiDAR and world xyz, keyframe
constexpr int kRowW = 16;                  // keyframes up to which a warp keeps its row in shared
constexpr int kRow = 13 * kRowW + 4;       // ... memory: N, mean, Pc of each cell, the centre
constexpr int kSmem = sizeof(int) * (kWarps * (kMaxDigits + kStage + kRow) + 2 * kMaxDigits);
inline size_t align16(size_t x) { return (x + 15) & ~static_cast<size_t>(15); }

// the scratch buffer, carved the same way on the host (its size; also
// ops/kernels/clusters.scratch_bytes) and here
struct Scratch {
  unsigned *kA, *vA, *kB, *vB;   // [P] sort keys and original indices (kB the raw root keys first)
  float *sl, *sw;                // [P, 3] points in sorted order (LiDAR, world)
  int *kf_s, *vox_s;             // [P] sorted order: keyframe, voxel id
  int *vox_pos;                  // [V + 1] start of each voxel's run
  float *cN, *cMean, *cPc;       // rows [2V] of [W], [W, 3], [W, 3, 3]: roots, then children
  float *cCenter;                // [2V, 3]
  int *planar;                   // [2V]
  int *split;                    // [V] splittable roots
  int *src;                      // [V] the row of [2V] each output slot takes
  size_t total;
};

template <typename T>
T* take(char* base, size_t& off, size_t bytes) {
  T* p = base ? reinterpret_cast<T*>(base + off) : nullptr;
  off = align16(off + bytes);
  return p;
}

// the buffer's pointers (base null: the size alone)
inline Scratch layout(char* base, long long P, long long V, long long W) {
  Scratch s;
  size_t off = 0;
  s.kA = take<unsigned>(base, off, 4 * P);
  s.vA = take<unsigned>(base, off, 4 * P);
  s.kB = take<unsigned>(base, off, 4 * P);
  s.vB = take<unsigned>(base, off, 4 * P);
  s.sl = take<float>(base, off, 12 * P);
  s.sw = take<float>(base, off, 12 * P);
  s.kf_s = take<int>(base, off, 4 * P);
  s.vox_s = take<int>(base, off, 4 * P);
  s.vox_pos = take<int>(base, off, 4 * (V + 1));
  s.cN = take<float>(base, off, 4 * 2 * V * W);
  s.cMean = take<float>(base, off, 4 * 2 * V * W * 3);
  s.cPc = take<float>(base, off, 4 * 2 * V * W * 9);
  s.cCenter = take<float>(base, off, 4 * 2 * V * 3);
  s.planar = take<int>(base, off, 4 * 2 * V);
  s.split = take<int>(base, off, 4 * V);
  s.src = take<int>(base, off, 4 * V);
  s.total = off;
  return s;
}

struct Params {
  const float* pts_l;   // [P, 3] LiDAR-frame points, original order
  const float* pw;      // [P, 3] world points
  const uint8_t* val;   // [P]
  const float* wsum;    // [3] sum of the valid world points
  const int* wcount;    // [1] their count
  const float* T;       // [W, 4, 4] poses of the plane test
  int P, W, M, V, min_points;
  float inv_voxel, plane_ratio, child_ratio;
  float *N, *mean, *Pc, *center;   // outputs [V, W], [V, W, 3], [V, W, 3, 3], [V, 3]
  uint8_t* valid;                  // [V]
};

// exclusive prefix of x over the block (thread order); *total the sum
__device__ int block_scan(int x, int* total) {
  __shared__ int warp_sums[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int v = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xFFFFFFFFu, v, o);
    if (lane >= o) v += y;
  }
  if (lane == 31) warp_sums[warp] = v;
  __syncthreads();
  if (warp == 0) {
    int w = warp_sums[lane];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xFFFFFFFFu, w, o);
      if (lane >= o) w += y;
    }
    warp_sums[lane] = w;
  }
  __syncthreads();
  const int excl = v - x + (warp ? warp_sums[warp - 1] : 0);
  *total = warp_sums[kWarps - 1];
  __syncthreads();
  return excl;
}

// exclusive prefix of x over the cluster (block rank, then thread order);
// *total the sum. Ends in a cluster barrier's wake: the blocks' totals are
// read from each other's shared memory.
__device__ int cluster_scan(int x, int* total) {
  __shared__ int pub, pre[2];
  cg::cluster_group cl = cg::this_cluster();
  int btot;
  const int excl = block_scan(x, &btot);
  if (threadIdx.x == 0) pub = btot;
  cl.sync();
  if (threadIdx.x < 32) {
    const int r = threadIdx.x, me = static_cast<int>(cl.block_rank());
    int v = r < static_cast<int>(cl.num_blocks()) ? *cl.map_shared_rank(&pub, r) : 0;
    int before = r < me ? v : 0;
#pragma unroll
    for (int o = 16; o; o >>= 1) {
      v += __shfl_xor_sync(0xFFFFFFFFu, v, o);
      before += __shfl_xor_sync(0xFFFFFFFFu, before, o);
    }
    if (r == 0) {
      pre[0] = before;
      pre[1] = v;
    }
  }
  __syncthreads();
  *total = pre[1];
  return excl + pre[0];
}

// One stable counting pass of n items over the cluster: load(i, key, value)
// gives item i, digit(key) its digit (< D); it is written to (dk, dv) at its
// place in a stable sort by digit. Global warp g (block rank, then warp)
// owns the items [g S, (g + 1) S), S a multiple of 32, and counts their
// digits in its row of hist (shared, [kWarps][D]; btot [D] the block's
// totals, read by the other blocks, and after them [D] each digit's first
// place in the block); places follow (digit,
// block, warp, item). Returns the count of digits below `cut`. Ends with a
// cluster barrier: the next pass may read what this one wrote.
template <class Load, class Digit>
__device__ int counting_pass(int n, int D, int cut, int* hist, int* btot, Load load,
                             Digit digit, unsigned* dk, unsigned* dv) {
  int* off = btot + kMaxDigits;
  cg::cluster_group cl = cg::this_cluster();
  __shared__ int below_cut;
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int nb = static_cast<int>(cl.num_blocks()), me = static_cast<int>(cl.block_rank());
  const int G = nb * kWarps;
  const int S = 32 * ((n + 32 * G - 1) / (32 * G));
  const int lo = min(n, (me * kWarps + warp) * S), hi = min(n, lo + S);
  const unsigned below = (1u << lane) - 1u;
  TC2LI_LAP_START
  int* h = hist + warp * D;
  for (int d = lane; d < D; d += 32) h[d] = 0;
  __syncwarp();
  for (int b = lo; b < hi; b += 32) {
    const int i = b + lane;
    unsigned k = 0, v = 0;
    if (i < hi) load(i, k, v);
    const int d = i < hi ? digit(k) : -1 - lane;   // a lane past the end: no digit, no peer
    const unsigned peers = __match_any_sync(0xFFFFFFFFu, d);
    if (i < hi && (peers & below) == 0) h[d] += __popc(peers);
    __syncwarp();
  }
  TC2LI_LAP(0);
  __syncthreads();
  // a thread a digit: its count before each warp of the block, the block's
  // total (8 counters in flight at a time)
  for (int d = t; d < D; d += kT) {
    int run = 0;
    for (int w0 = 0; w0 < kWarps; w0 += 8) {
      int c[8];
#pragma unroll
      for (int w = 0; w < 8; ++w) c[w] = hist[(w0 + w) * D + d];
#pragma unroll
      for (int w = 0; w < 8; ++w) {
        hist[(w0 + w) * D + d] = run;
        run += c[w];
      }
    }
    btot[d] = run;
  }
  TC2LI_LAP(1);
  cl.sync();
  TC2LI_LAP(2);
  // ... before this block in the cluster, over the cluster; digits in order:
  // off[d] the place of the block's first item of digit d
  int before = 0, tot = 0;
  if (t < D) {
    for (int r0 = 0; r0 < nb; r0 += 8) {
      int c[8];
#pragma unroll
      for (int r = 0; r < 8; ++r) c[r] = r0 + r < nb ? *cl.map_shared_rank(&btot[t], r0 + r) : 0;
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        before += r0 + r < me ? c[r] : 0;
        tot += c[r];
      }
    }
  }
  TC2LI_LAP(6);
  int all;
  const int base = block_scan(t < D ? tot : 0, &all);
  TC2LI_LAP(7);
  if (t < D) off[t] = base + before;
  if (t == min(cut, D - 1)) below_cut = cut < D ? base : all;
  __syncthreads();
  TC2LI_LAP(3);
  for (int b = lo; b < hi; b += 32) {
    const int i = b + lane;
    unsigned k = 0, v = 0;
    if (i < hi) load(i, k, v);
    const int d = i < hi ? digit(k) : -1 - lane;
    const unsigned peers = __match_any_sync(0xFFFFFFFFu, d);
    if (i < hi) {
      const int p = off[d] + h[d] + __popc(peers & below);
      dk[p] = k;
      dv[p] = v;
    }
    __syncwarp();
    if (i < hi && (peers & below) == 0) h[d] += __popc(peers);
    __syncwarp();
  }
  const int n_cut = below_cut;
  TC2LI_LAP(4);
  cl.sync();
  TC2LI_LAP(5);
  return n_cut;
}

// A stable sort of n items by keys of `bits` bits, the items not kept (keep
// false) after them with the key 2^bits: LSD counting passes of at most
// kDigitBits over bits + 1 bits, from load(i, key, value, keep) in the first
// pass (written to (kA, vA), or (kB, vB) where `into_b`), between the two
// pairs after it. Returns the count kept; *k, *v the sorted keys and
// original indices of those first.
template <class Load>
__device__ int sort_keys(const Scratch& s, int* hist, int* btot, int n, int bits, Load first,
                         bool into_b, const unsigned** k, const unsigned** v, bool root) {
  const int all_bits = bits + 1;
  const int passes = (all_bits + kDigitBits - 1) / kDigitBits;
  const int per = (all_bits + passes - 1) / passes;
  const unsigned none = 1u << bits;   // the key of an item not kept
  unsigned *sk = nullptr, *sv = nullptr, *dk = into_b ? s.kB : s.kA, *dv = into_b ? s.vB : s.vA;
  int kept = 0;
  for (int shift = 0; shift < all_bits; shift += per) {
    const int D = 1 << min(per, all_bits - shift);
    const auto digit = [=](unsigned key) { return static_cast<int>((key >> shift) & (D - 1)); };
    const int cut = static_cast<int>(none >> shift);   // the last pass: the first digit not kept
    if (shift == 0) {
      kept = counting_pass(n, D, cut, hist, btot, [&](int i, unsigned& kk, unsigned& vv) {
        bool keep;
        first(i, kk, vv, keep);
        kk = keep ? kk : none;
      }, digit, dk, dv);
    } else {
      kept = counting_pass(n, D, cut, hist, btot, [=](int i, unsigned& kk, unsigned& vv) {
        kk = __ldcg(sk + i);
        vv = __ldcg(sv + i);
      }, digit, dk, dv);
    }
    sk = dk;
    sv = dv;
    dk = dk == s.kA ? s.kB : s.kA;
    dv = dv == s.vA ? s.vB : s.vA;
  }
  TC2LI_STAMP(root ? 3 : 13);
  *k = sk;
  *v = sv;
  return kept;
}

// the voxel centre of the root keys: sum / max(count, 1), a true division
__device__ __forceinline__ float centre(const Params& a, int c) {
  const int n = a.wcount[0];
  return __fdiv_rn(a.wsum[c], static_cast<float>(n < 1 ? 1 : n));
}

__device__ __forceinline__ float rel(const Params& a, long long i, int c, float ctr) {
  return __fmul_rn(__fsub_rn(a.pw[3 * i + c], ctr), a.inv_voxel);
}

// root key of point i: floor(rel) + 256 in [0, 512) on each axis, of valid points
__device__ unsigned root_key(const Params& a, int i, const float* ctr) {
  if (!a.val[i]) return kBigKey;
  int r[3];
  bool in = true;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const int f = static_cast<int>(floorf(rel(a, i, c, ctr[c])));
    r[c] = static_cast<int>(static_cast<unsigned>(f) + 256u);   // int32 wraps, as torch
    in = in && r[c] >= 0 && r[c] < 512;
  }
  return in ? static_cast<unsigned>((r[0] << 18) | (r[1] << 9) | r[2]) : kBigKey;
}

// One cell's terms of _total_cov (ops/plane_fit.py) in float32, in the
// plain version's order of operations: the keyframe's cluster (N, mean m,
// scatter Pc) moved by its pose T (row-major 4x4) to the voxel-centred world
// frame (centre ctr): out = (N, N mw, R Pc R^T + N mw mw^T)
__device__ void cell_terms(const float* T, float Nw, const float* m, const float* Pc,
                           const float* ctr, float* out) {
  float mw[3], RP[9];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float Rm = __fadd_rn(__fadd_rn(__fmul_rn(T[4 * i], m[0]), __fmul_rn(T[4 * i + 1], m[1])),
                               __fmul_rn(T[4 * i + 2], m[2]));
    mw[i] = __fadd_rn(Rm, __fsub_rn(T[4 * i + 3], ctr[i]));
#pragma unroll
    for (int k = 0; k < 3; ++k)
      RP[3 * i + k] = __fadd_rn(__fadd_rn(__fmul_rn(T[4 * i], Pc[k]), __fmul_rn(T[4 * i + 1], Pc[3 + k])),
                                __fmul_rn(T[4 * i + 2], Pc[6 + k]));
  }
  out[0] = Nw;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    out[1 + i] = __fmul_rn(Nw, mw[i]);
#pragma unroll
    for (int l = 0; l < 3; ++l) {
      const float rpr = __fadd_rn(__fadd_rn(__fmul_rn(RP[3 * i], T[4 * l]), __fmul_rn(RP[3 * i + 1], T[4 * l + 1])),
                                  __fmul_rn(RP[3 * i + 2], T[4 * l + 2]));
      out[4 + 3 * i + l] = __fadd_rn(rpr, __fmul_rn(Nw, __fmul_rn(mw[i], mw[l])));
    }
  }
}

// adds one cell's terms to the row's sums (N_tot, S, P), in keyframe order
__device__ __forceinline__ void add_terms(float* acc, const float* t) {
#pragma unroll
  for (int e = 0; e < 13; ++e) acc[e] = __fadd_rn(acc[e], t[e]);
}

// the plane test of a row's sums acc = (N_tot, S [3], P [9]):
// smallest_two_eigvals_sym3 of the covariance, lambda0 < ratio lambda1
__device__ bool planar_of(const Params& a, const float* acc, float ratio) {
  const float nt = acc[0];
  if (!(nt >= static_cast<float>(a.min_points))) return false;
  const float n = nt < 1.f ? 1.f : nt;
  float mu[3], A[9];
#pragma unroll
  for (int i = 0; i < 3; ++i) mu[i] = __fdiv_rn(acc[1 + i], n);
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int l = 0; l < 3; ++l)
      A[3 * i + l] = __fadd_rn(__fsub_rn(__fdiv_rn(acc[4 + 3 * i + l], n), __fmul_rn(mu[i], mu[l])),
                               i == l ? 1e-9f : 0.f);
  // _trig_parts(A, 0): the scalar divisions as PyTorch's multiply by the reciprocal
  const float q = __fmul_rn(__fadd_rn(__fadd_rn(A[0], A[4]), A[8]), 1.f / 3.f);
  float B[9], p2 = 0.f;
#pragma unroll
  for (int e = 0; e < 9; ++e) {
    B[e] = __fsub_rn(A[e], (e % 4 == 0) ? q : 0.f);
    p2 = __fadd_rn(p2, __fmul_rn(B[e], B[e]));
  }
  p2 = __fmul_rn(p2, 1.f / 6.f);
  const float p = sqrtf(p2 < 1e-30f ? 1e-30f : p2);
#pragma unroll
  for (int e = 0; e < 9; ++e) B[e] = __fdiv_rn(B[e], p);
  const float det = B[0] * (B[4] * B[8] - B[5] * B[7]) - B[1] * (B[3] * B[8] - B[5] * B[6]) +
                    B[2] * (B[3] * B[7] - B[4] * B[6]);
  float r = __fmul_rn(det, 0.5f);
  r = r < -1.f ? -1.f : (r > 1.f ? 1.f : r);
  const float phi = __fmul_rn(acosf(r), 1.f / 3.f);
  const float lmax = __fadd_rn(q, __fmul_rn(__fmul_rn(2.f, p), cosf(phi)));
  const float lmin = __fadd_rn(q, __fmul_rn(__fmul_rn(2.f, p), cosf(__fadd_rn(phi, 2.0943951023931953f))));
  float lmid = __fsub_rn(__fsub_rn(__fmul_rn(3.f, q), lmax), lmin);
  lmid = lmid < 1e-9f ? 1e-9f : lmid;
  return lmin < __fmul_rn(ratio, lmid);
}

// the plane test of a row without points (every cell zero), one thread
__device__ bool empty_planar(const Params& a, float ratio) {
  if (a.min_points > 0) return false;   // N_tot 0, below the test's minimum
  float acc[13], t[13];
  const float zero[9] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int e = 0; e < 13; ++e) acc[e] = 0.f;
  for (int w = 0; w < a.W; ++w) {
    cell_terms(a.T + 16LL * w, 0.f, zero, zero, zero, t);
    add_terms(acc, t);
  }
  return planar_of(a, acc, ratio);
}

// lane j of the warp loads item b + j of [b, end): LiDAR and (if world)
// world xyz and keyframe
__device__ __forceinline__ void load_item(const Scratch& s, int i, int end, bool world,
                                          float* pl, float* pw, int& kf) {
  if (i >= end) return;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    pl[c] = __ldcg(s.sl + 3LL * i + c);
    if (world) pw[c] = __ldcg(s.sw + 3LL * i + c);
  }
  kf = __ldcg(s.kf_s + i);
}

__device__ __forceinline__ void stage_item(float* bl, float* bw, int* bk, int lane, bool world,
                                           const float* pl, const float* pw, int kf) {
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    bl[3 * lane + c] = pl[c];
    if (world) bw[3 * lane + c] = pw[c];
  }
  bk[lane] = kf;
}

// the cell starts among a staged chunk of cnt items (bit j: item j starts a
// cell), cur the keyframe of the cell open before it
__device__ __forceinline__ unsigned cell_starts(const int* bk, int cnt, int cur, int lane) {
  const bool st = lane < cnt && bk[lane] != (lane ? bk[lane - 1] : cur);
  return __ballot_sync(0xFFFFFFFFu, st);
}

// One warp, voxel v of the pass: its row row0 + v of the cell arrays (each
// cell's N, mean and centred scatter, zero where a keyframe has no point),
// its centre, its plane test. The run [vox_pos[v], vox_pos[v + 1]) holds the
// voxel's points in order, its cells one after another (keyframe-major).
// The row is built in the warp's shared memory (up to kRowW keyframes, then
// copied out) or in place; the walks add each cell's run between its
// boundaries, found a chunk at a time by a ballot.
__device__ void voxel_row(const Params& a, const Scratch& s, int v, int row0, float ratio,
                          bool root, float* stage, float* rbuf) {
  const int lane = threadIdx.x & 31, W = a.W, row = row0 + v;
  TC2LI_LAP_START
  const int i0 = __ldcg(s.vox_pos + v), i1 = __ldcg(s.vox_pos + v + 1);
  const bool local = W <= kRowW;
  float* gN = s.cN + static_cast<long long>(row) * W;
  float* gMean = s.cMean + 3LL * row * W;
  float* gPc = s.cPc + 9LL * row * W;
  float* gCenter = s.cCenter + 3LL * row;
  float* rN = local ? rbuf : gN;
  float* rMean = local ? rbuf + W : gMean;
  float* rPc = local ? rbuf + 4 * W : gPc;
  float* rCenter = local ? rbuf + 13 * W : gCenter;
  for (int e = lane; e < 13 * W; e += 32) {
    if (e < W) {
      rN[e] = 0.f;
    } else if (e < 4 * W) {
      rMean[e - W] = 0.f;
    } else {
      rPc[e - 4 * W] = 0.f;
    }
  }
  float* bl = stage;
  float* bw = stage + 96;
  int* bk = reinterpret_cast<int*>(stage + 192);
  float pl[3] = {0.f, 0.f, 0.f}, pw[3] = {0.f, 0.f, 0.f};
  int pk = 0;
  load_item(s, i0 + lane, i1, true, pl, pw, pk);
  const bool one_chunk = i1 - i0 <= 32;

  // walk 1: lanes 0-2 a cell's LiDAR sum, lanes 3-5 the voxel's world sum
  const float* src = lane < 3 ? bl + lane : (lane < 6 ? bw + lane - 3 : bl);
  float acc = 0.f;
  int cell_kf = -1, cell0 = i0;
  for (int b = i0; b < i1; b += 32) {
    __syncwarp();
    stage_item(bl, bw, bk, lane, true, pl, pw, pk);
    __syncwarp();
    load_item(s, b + 32 + lane, i1, true, pl, pw, pk);   // the next chunk, in flight
    const int cnt = min(32, i1 - b);
    if (b == i0) cell_kf = bk[0];
    unsigned starts = cell_starts(bk, cnt, cell_kf, lane);
    int j = 0;
    while (true) {
      const int stop = starts ? __ffs(starts) - 1 : cnt;
#pragma unroll 4
      for (; j < stop; ++j) acc = __fadd_rn(acc, src[3 * j]);
      if (stop == cnt) break;
      // the cell ends before item stop
      if (lane < 3) rMean[3 * cell_kf + lane] = __fdiv_rn(acc, static_cast<float>(b + stop - cell0));
      if (lane == 0) rN[cell_kf] = static_cast<float>(b + stop - cell0);
      if (lane < 3) acc = 0.f;
      cell_kf = bk[stop];
      cell0 = b + stop;
      starts &= starts - 1;
    }
  }
  if (lane < 3) rMean[3 * cell_kf + lane] = __fdiv_rn(acc, static_cast<float>(i1 - cell0));
  if (lane == 0) rN[cell_kf] = static_cast<float>(i1 - cell0);
  if (lane >= 3 && lane < 6) rCenter[lane - 3] = __fdiv_rn(acc, static_cast<float>(i1 - i0));
  __syncwarp();
  TC2LI_LAP(8);

  // walk 2: lane e < 9 the scatter entry (e / 3, e % 3) of each cell
  const int er = (lane % 9) / 3, ec = lane % 3;
  float q = 0.f;
  if (!one_chunk) load_item(s, i0 + lane, i1, false, pl, pw, pk);
  for (int b = i0; b < i1; b += 32) {
    if (!one_chunk) {   // one chunk: still staged from walk 1
      __syncwarp();
      stage_item(bl, bw, bk, lane, false, pl, pw, pk);
      __syncwarp();
      load_item(s, b + 32 + lane, i1, false, pl, pw, pk);
    }
    const int cnt = min(32, i1 - b);
    if (b == i0) cell_kf = bk[0];
    float mr = rMean[3 * cell_kf + er], mc = rMean[3 * cell_kf + ec];
    unsigned starts = cell_starts(bk, cnt, cell_kf, lane);
    int j = 0;
    while (true) {
      const int stop = starts ? __ffs(starts) - 1 : cnt;
#pragma unroll 4
      for (; j < stop; ++j)
        q = __fadd_rn(q, __fmul_rn(__fsub_rn(bl[3 * j + er], mr), __fsub_rn(bl[3 * j + ec], mc)));
      if (stop == cnt) break;
      if (lane < 9) rPc[9 * cell_kf + lane] = q;
      q = 0.f;
      cell_kf = bk[stop];
      mr = rMean[3 * cell_kf + er];
      mc = rMean[3 * cell_kf + ec];
      starts &= starts - 1;
    }
  }
  if (lane < 9) rPc[9 * cell_kf + lane] = q;
  __syncwarp();
  TC2LI_LAP(9);
  // the plane test: lane w < 16 a cell's terms, lane 0 their sums in order
  float sums[13];
#pragma unroll
  for (int e = 0; e < 13; ++e) sums[e] = 0.f;
  for (int w0 = 0; w0 < W; w0 += 16) {
    const int w = w0 + lane;
    if (lane < 16 && w < W)
      cell_terms(a.T + 16LL * w, rN[w], rMean + 3 * w, rPc + 9 * w, rCenter, stage + 13 * lane);
    __syncwarp();
    if (lane == 0)
      for (int k = 0; k < 16 && w0 + k < W; ++k) add_terms(sums, stage + 13 * k);
    __syncwarp();
  }
  if (lane == 0) {
    const bool planar = planar_of(a, sums, ratio);
    s.planar[row] = planar;
    if (root) s.split[v] = !planar && sums[0] >= static_cast<float>(a.min_points);
  }
  TC2LI_LAP(10);
  if (local) {   // the row out to device memory, the centre after it
    for (int e = lane; e < 13 * W + 3; e += 32) {
      const float x = rbuf[e];
      if (e < W) {
        gN[e] = x;
      } else if (e < 4 * W) {
        gMean[e - W] = x;
      } else if (e < 13 * W) {
        gPc[e - 4 * W] = x;
      } else {
        gCenter[e - 13 * W] = x;
      }
    }
  }
  __syncwarp();   // the row buffer and the stage are free for the next voxel
  TC2LI_LAP(11);
}

// One voxelisation of n sorted items (keys k, original indices v): the
// points in sorted order, voxel ids and runs, then the rows [row0, row0 + V)
// of the cell arrays, a warp a voxel that holds points. Returns the number of
// such voxels (rows past it are empty). Items go to warps as in
// counting_pass: a warp's contiguous share, 32 at a time, a lane an item.
__device__ int cluster_pass(const Params& a, const Scratch& s, const unsigned* k,
                            const unsigned* v, int n, int row0, float ratio, bool root,
                            float* stage, float* rbuf) {
  cg::cluster_group cl = cg::this_cluster();
  const int V = a.V, nb = static_cast<int>(cl.num_blocks());
  const int me = static_cast<int>(cl.block_rank());
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int G = nb * kWarps, gw = me * kWarps + warp;
  const int S = 32 * ((n + 32 * G - 1) / (32 * G));
  const int lo = min(n, gw * S), hi = min(n, lo + S);
  const unsigned below = (1u << lane) - 1u;
  int heads = 0;
  for (int b = lo; b < hi; b += 32) {
    const int i = b + lane;
    bool head = false;
    if (i < hi) {
      const long long o = __ldcg(v + i);
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        s.sl[3LL * i + c] = a.pts_l[3 * o + c];
        s.sw[3LL * i + c] = a.pw[3 * o + c];
      }
      s.kf_s[i] = static_cast<int>(o / a.M);
      head = i == 0 || __ldcg(k + i) != __ldcg(k + i - 1);
    }
    heads += __popc(__ballot_sync(0xFFFFFFFFu, head));
  }
  int n_heads;
  int run = __shfl_sync(0xFFFFFFFFu, cluster_scan(lane == 0 ? heads : 0, &n_heads), 0);
  // voxel ids: the rank of the key (ranks past V to the dump slot V); the
  // run of voxel r starts at its head, vox_pos[min(heads, V)] ends the last
  for (int b = lo; b < hi; b += 32) {
    const int i = b + lane;
    const bool head = i < hi && (i == 0 || __ldcg(k + i) != __ldcg(k + i - 1));
    const unsigned heads_here = __ballot_sync(0xFFFFFFFFu, head);
    if (i < hi) {
      const int r = run + __popc(heads_here & below) + head - 1;
      s.vox_s[i] = r < V ? r : V;
      if (head && r <= V) s.vox_pos[r] = i;
    }
    run += __popc(heads_here);
  }
  if (gw == 0 && lane == 0 && n_heads <= V) s.vox_pos[n_heads] = n;
  const int n_vox = n_heads < V ? n_heads : V;
  cl.sync();
  TC2LI_STAMP(root ? 5 : 15);
  for (int vx = gw; vx < n_vox; vx += G)
    voxel_row(a, s, vx, row0, ratio, root, stage + warp * kStage, rbuf + warp * kRow);
  for (int vx = n_vox + me * kT + static_cast<int>(threadIdx.x); vx < V; vx += nb * kT) {
    const bool planar = empty_planar(a, ratio);
    s.planar[row0 + vx] = planar;
    if (root) s.split[vx] = !planar && 0.f >= static_cast<float>(a.min_points);
  }
  cl.sync();
  TC2LI_STAMP(root ? 9 : 19);
  return n_vox;
}

// the root key of every point into kB, and box = (lo x, y, z, hi x, y, z)
// of the valid keys' fields over the cluster (lo > hi: no valid key)
__device__ void key_box(const Params& a, const Scratch& s, const float* ctr, int* box) {
  __shared__ int bbox[6], cbox[6];
  cg::cluster_group cl = cg::this_cluster();
  const int nb = static_cast<int>(cl.num_blocks()), NT = nb * kT;
  const int gt = static_cast<int>(cl.block_rank()) * kT + static_cast<int>(threadIdx.x);
  if (threadIdx.x < 6) bbox[threadIdx.x] = threadIdx.x < 3 ? 511 : 0;
  __syncthreads();
  int lo[3] = {511, 511, 511}, hi[3] = {0, 0, 0};
  for (int i = gt; i < a.P; i += NT) {
    const unsigned key = root_key(a, i, ctr);
    s.kB[i] = key;
    if (key != kBigKey) {
      const int f[3] = {static_cast<int>(key >> 18), static_cast<int>(key >> 9 & 511u),
                        static_cast<int>(key & 511u)};
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        lo[c] = min(lo[c], f[c]);
        hi[c] = max(hi[c], f[c]);
      }
    }
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    lo[c] = __reduce_min_sync(0xFFFFFFFFu, lo[c]);
    hi[c] = __reduce_max_sync(0xFFFFFFFFu, hi[c]);
  }
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      atomicMin(&bbox[c], lo[c]);
      atomicMax(&bbox[3 + c], hi[c]);
    }
  }
  cl.sync();
  if (threadIdx.x < 32) {
    const int r = threadIdx.x;
#pragma unroll
    for (int c = 0; c < 6; ++c) {
      const int x = r < nb ? *cl.map_shared_rank(&bbox[c], r) : (c < 3 ? 511 : 0);
      const int y = c < 3 ? __reduce_min_sync(0xFFFFFFFFu, x) : __reduce_max_sync(0xFFFFFFFFu, x);
      if (r == 0) cbox[c] = y;
    }
  }
  __syncthreads();
#pragma unroll
  for (int c = 0; c < 6; ++c) box[c] = cbox[c];
}

// the launches of clusters_kernel that ran to their end, counted on the
// device (tc2li_clusters_ran): a launch count that does not rest on the
// profiler's record of cluster launches
__device__ unsigned long long clusters_ran = 0;

__global__ void __launch_bounds__(kT, 1) clusters_kernel(Params a, Scratch s) {
  extern __shared__ int smem[];
  int* hist = smem;                                                  // [kWarps][kMaxDigits]
  float* stage = reinterpret_cast<float*>(smem + kWarps * kMaxDigits);  // [kWarps][kStage]
  float* rbuf = stage + kWarps * kStage;                             // [kWarps][kRow]
  int* btot = reinterpret_cast<int*>(rbuf + kWarps * kRow);          // [2][kMaxDigits]
  cg::cluster_group cl = cg::this_cluster();
  const int V = a.V;
  TC2LI_STAMP(0);
  const float ctr[3] = {centre(a, 0), centre(a, 1), centre(a, 2)};

  // roots: the points' keys (kept in kB) and the box of the valid ones'
  // cells; the valid keys to the front, sorted by their rank in the box
  // (x, then y, then z, as the 27-bit key x << 18 | y << 9 | z), in as
  // many bits as the box has cells
  int box[6];
  key_box(a, s, ctr, box);
  TC2LI_STAMP(1);
  const unsigned ny = box[4] - box[1] + 1, nz = box[5] - box[2] + 1;
  const unsigned cells = box[0] <= box[3] ? (box[3] - box[0] + 1) * ny * nz : 1u;
  const int root_bits = cells > 1 ? 32 - __clz(static_cast<int>(cells - 1)) : 0;
  const unsigned *k, *v;
  const int n_valid = sort_keys(
      s, hist, btot, a.P, root_bits,
      [&](int i, unsigned& kk, unsigned& vv, bool& keep) {
        const unsigned raw = __ldcg(s.kB + i);
        keep = raw != kBigKey;
        kk = keep ? (((raw >> 18) - box[0]) * ny + ((raw >> 9 & 511u) - box[1])) * nz +
                        ((raw & 511u) - box[2])
                  : 0u;
        vv = static_cast<unsigned>(i);
      },
      false, &k, &v, true);
  const int n_root = cluster_pass(a, s, k, v, n_valid, 0, a.plane_ratio, true, stage, rbuf);

  // children: the points of splittable roots, in root-sorted order, by the
  // root's voxel id (its key's rank) and the octant
  const unsigned* rv = v;
  const int cbits = 32 - __clz(8 * V - 1);
  const int n_split = sort_keys(
      s, hist, btot, n_valid, cbits,
      [&](int i, unsigned& kk, unsigned& vv, bool& keep) {
        const unsigned o = __ldcg(rv + i);
        const int vx = __ldcg(s.vox_s + i);
        vv = o;
        kk = 0;
        keep = vx < V && __ldcg(s.split + vx);
        if (keep) {
          int oct = 0;
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            const float x = rel(a, o, c, ctr[c]);
            oct |= (__fsub_rn(x, floorf(x)) >= 0.5f) << c;
          }
          kk = static_cast<unsigned>(vx) * 8u + static_cast<unsigned>(oct);
        }
      },
      rv == s.vA, &k, &v, false);   // into the pair the root order is not in
  const int n_child = cluster_pass(a, s, k, v, n_split, V, a.child_ratio, false, stage, rbuf);

  // compaction: rows [0, 2V) with planar first, each group in row order;
  // every block finds each row's slot; block r copies the slots r, r + nb,
  // ..., a warp a slot (an empty row is written as zeros, without a read)
  const int t = threadIdx.x, lane = t & 31, R = 2 * V, W = a.W;
  const int nb = static_cast<int>(cl.num_blocks()), me = static_cast<int>(cl.block_rank());
  const int per = (R + kT - 1) / kT;
  const int lo = min(R, t * per), hi = min(R, lo + per);
  int trues = 0;
  for (int j = lo; j < hi; ++j) trues += __ldcg(s.planar + j);
  int n_true;
  int before = block_scan(trues, &n_true);
  for (int j = lo; j < hi; ++j) {
    const int pl = __ldcg(s.planar + j);
    const int pos = pl ? before : n_true + (j - before);
    before += pl;
    if (pos < V && pos % nb == me) s.src[pos] = j;
  }
  __syncthreads();
  for (int pos = me + nb * (t >> 5); pos < V; pos += nb * kWarps) {
    const int j = __ldcg(s.src + pos);
    const bool filled = j < V ? j < n_root : j - V < n_child;
    const long long c0 = static_cast<long long>(j) * W, o0 = static_cast<long long>(pos) * W;
    for (int e = lane; e < 13 * W + 3; e += 32) {
      if (e < W) {
        a.N[o0 + e] = filled ? __ldcg(s.cN + c0 + e) : 0.f;
      } else if (e < 4 * W) {
        a.mean[3 * o0 + e - W] = filled ? __ldcg(s.cMean + 3 * c0 + e - W) : 0.f;
      } else if (e < 13 * W) {
        a.Pc[9 * o0 + e - 4 * W] = filled ? __ldcg(s.cPc + 9 * c0 + e - 4 * W) : 0.f;
      } else {
        a.center[3LL * pos + e - 13 * W] = filled ? __ldcg(s.cCenter + 3LL * j + e - 13 * W) : 0.f;
      }
    }
    if (lane == 0) a.valid[pos] = static_cast<uint8_t>(__ldcg(s.planar + j));
  }
  TC2LI_STAMP(23);
  // one a launch that ran to its end (launches on one stream run one at a
  // time, so a plain increment by one thread is exact)
  if (cl.block_rank() == 0 && threadIdx.x == 0) ++clusters_ran;
}

// blocks of the cluster: 16 where the card schedules a cluster of 16, else 8
int cluster_blocks() {
  static int nb = 0;
  if (nb) return nb;
  if (cudaFuncSetAttribute(clusters_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1) !=
          cudaSuccess ||
      cudaFuncSetAttribute(clusters_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem) !=
          cudaSuccess)
    return 0;
  const int sizes[2] = {16, 8};
  for (int c : sizes) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(c);
    cfg.blockDim = dim3(kT);
    cfg.dynamicSmemBytes = kSmem;
    cudaLaunchAttribute at;
    at.id = cudaLaunchAttributeClusterDimension;
    at.val.clusterDim.x = c;
    at.val.clusterDim.y = 1;
    at.val.clusterDim.z = 1;
    cfg.attrs = &at;
    cfg.numAttrs = 1;
    int n = 0;
    if (cudaOccupancyMaxActiveClusters(&n, clusters_kernel, &cfg) == cudaSuccess && n > 0) {
      nb = c;
      return nb;
    }
    cudaGetLastError();
  }
  return 0;
}

}  // namespace

// the device's count of clusters_kernel launches that ran to their end, into
// *out (a synchronous copy: call it after the launches' stream has drained)
extern "C" int tc2li_clusters_ran(unsigned long long* out) {
  return static_cast<int>(cudaMemcpyFromSymbol(out, clusters_ran, sizeof(*out)));
}

// bytes of scratch a call takes (see tc2li_balm_clusters)
extern "C" long long tc2li_clusters_scratch(int P, int V, int W) {
  return static_cast<long long>(layout(nullptr, P, V, W).total);
}

// pts_l, pw [P, 3] float32 (P = W M, keyframe-major), val [P] uint8, wsum [3]
// float32, wcount [1] int32, T [W, 4, 4] float32; scratch of
// tc2li_clusters_scratch(P, V, W) bytes, 16-byte aligned; outputs N [V, W],
// mean [V, W, 3], Pc [V, W, 3, 3], center [V, 3] float32, valid [V] uint8.
// All contiguous on the device. One launch of one cluster on `stream`;
// returns cudaGetLastError().
extern "C" int tc2li_balm_clusters(const float* pts_l, const float* pw, const uint8_t* val,
                                   const float* wsum, const int* wcount, const float* T, int W,
                                   int M, int V, int min_points, float inv_voxel,
                                   float plane_ratio, float child_ratio, void* scratch, float* N,
                                   float* mean, float* Pc, float* center, uint8_t* valid,
                                   void* stream) {
  if (W < 0 || M < 0 || V < 1 || V > (1 << 27) || (W > 0 && M > 0x7FFFFFFF / 16 / W))
    return static_cast<int>(cudaErrorInvalidValue);
  const int nb = cluster_blocks();
  if (!nb) return static_cast<int>(cudaErrorNotSupported);
  Params a{pts_l, pw, val, wsum, wcount, T, W * M, W, M < 1 ? 1 : M, V, min_points,
           inv_voxel, plane_ratio, child_ratio, N, mean, Pc, center, valid};
  const Scratch s = layout(static_cast<char*>(scratch), a.P, V, W);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nb);
  cfg.blockDim = dim3(kT);
  cfg.dynamicSmemBytes = kSmem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute at;
  at.id = cudaLaunchAttributeClusterDimension;
  at.val.clusterDim.x = nb;
  at.val.clusterDim.y = 1;
  at.val.clusterDim.z = 1;
  cfg.attrs = &at;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, clusters_kernel, a, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
