// The BALM voxel clusters of a window's LiDAR keyframes, in one launch.
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
// time. Here one thread takes a cell's run and adds in the same order, with
// separate roundings (__fadd_rn, __fmul_rn: no contraction into an FMA), so
// N, mean, Pc and center are bit-equal to the plain version on the card.
// The planar flags may differ where lambda0 / (ratio lambda1) rounds across 1.
//
// Bound on the H100: latency. At W 6 and M 2048 a call moves ~0.4 MB and
// does ~1 M operations; what takes the time is the serial work: the two
// sorts and a cell's run added in order. Design: one block of 1024 threads
// over scratch in device memory (any W, M and max_voxels fit); the sorts are
// a stable partition of the valid keys to the front, then stable LSD radix
// sorts of those alone, 4 bits a pass, each thread a contiguous segment
// with its own 16 counters in shared memory (a thread's items stay in order,
// and thread t's come before thread t + 1's); every other step is a loop
// over points, cells or voxels between block barriers. No float atomics:
// the same inputs give the same bits on every call.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kT = 1024;               // threads of the one block
constexpr int kBigKey = 0x7FFFFFFF;    // solver/balm.py BIG_KEY
constexpr int kRadixBits = 4;
constexpr int kDigits = 1 << kRadixBits;
constexpr int kPasses = 32 / kRadixBits;   // even: the sorted pairs end in (kA, vA)
constexpr int kBatch = 8;                  // a thread's segment items loaded at once

inline size_t align16(size_t x) { return (x + 15) & ~static_cast<size_t>(15); }

// the scratch buffer, carved the same way on the host (its size) and here
struct Scratch {
  unsigned *kA, *vA, *kB, *vB;   // [P] sort keys and original indices
  int *key_root, *slot;          // [P] original order: root key, root voxel id
  float *sl, *sw;                // [P, 3] points in sorted order (LiDAR, world)
  int *kf_s, *vox_s;             // [P] sorted order: keyframe, voxel id
  int *cell_pos;                 // [P + 1] start of each cell's run
  int *vox_pos;                  // [V + 1] start of each voxel's run
  float *cN, *cMean, *cPc;       // [2V, W], [2V, W, 3], [2V, W, 3, 3]: roots, then children
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
  s.key_root = take<int>(base, off, 4 * P);
  s.slot = take<int>(base, off, 4 * P);
  s.sl = take<float>(base, off, 12 * P);
  s.sw = take<float>(base, off, 12 * P);
  s.kf_s = take<int>(base, off, 4 * P);
  s.vox_s = take<int>(base, off, 4 * P);
  s.cell_pos = take<int>(base, off, 4 * (P + 1));
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
  __shared__ int warp_sums[kT / 32];
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
  *total = warp_sums[kT / 32 - 1];
  __syncthreads();
  return excl;
}

// this thread's contiguous segment [lo, hi) of n items
__device__ __forceinline__ void segment(int n, int& lo, int& hi) {
  const int per = (n + kT - 1) / kT;
  lo = min(n, static_cast<int>(threadIdx.x) * per);
  hi = min(n, lo + per);
}

// stable sort of the first P pairs of (kA, vA) by kA, through (kB, vB); cnt
// [kDigits * kT] shared
__device__ void sort_pairs(const Scratch& s, int P, int* cnt) {
  const int t = threadIdx.x;
  int lo, hi;
  segment(P, lo, hi);
  for (int pass = 0; pass < kPasses; ++pass) {
    const int shift = kRadixBits * pass;
    const unsigned* sk = pass & 1 ? s.kB : s.kA;
    const unsigned* sv = pass & 1 ? s.vB : s.vA;
    unsigned* dk = pass & 1 ? s.kA : s.kB;
    unsigned* dv = pass & 1 ? s.vA : s.vB;
#pragma unroll
    for (int d = 0; d < kDigits; ++d) cnt[d * kT + t] = 0;
    for (int b = lo; b < hi; b += kBatch) {   // a batch of loads in flight
      unsigned k[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) k[u] = b + u < hi ? sk[b + u] : 0u;
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        if (b + u < hi) ++cnt[((k[u] >> shift) & (kDigits - 1)) * kT + t];
    }
    __syncthreads();
    // exclusive scan of the counters in (digit, thread) order
    int local[kDigits];
    int sum = 0;
#pragma unroll
    for (int e = 0; e < kDigits; ++e) {
      local[e] = cnt[kDigits * t + e];
      sum += local[e];
    }
    int total;
    int run = block_scan(sum, &total);
#pragma unroll
    for (int e = 0; e < kDigits; ++e) {
      cnt[kDigits * t + e] = run;
      run += local[e];
    }
    __syncthreads();
    for (int b = lo; b < hi; b += kBatch) {
      unsigned k[kBatch], v[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        k[u] = b + u < hi ? sk[b + u] : 0u;
        v[u] = b + u < hi ? sv[b + u] : 0u;
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        if (b + u < hi) {
          const int p = cnt[((k[u] >> shift) & (kDigits - 1)) * kT + t]++;
          dk[p] = k[u];
          dv[p] = v[u];
        }
    }
    __syncthreads();
  }
}

// stable partition of the keys (kB, vB) into (kA, vA), those below kBigKey
// first; returns their count. A stable sort of them then gives the order of
// a stable sort of all P keys: kBigKey is the largest, and those keys keep
// their original order at the end.
__device__ int partition_valid(const Scratch& s, int P) {
  int lo, hi;
  segment(P, lo, hi);
  int mine = 0;
  for (int i = lo; i < hi; ++i) mine += s.kB[i] != static_cast<unsigned>(kBigKey);
  int n_valid;
  int pv = block_scan(mine, &n_valid);
  int pb = n_valid + (lo - pv);
  for (int i = lo; i < hi; ++i) {
    const unsigned k = s.kB[i];
    const int p = k != static_cast<unsigned>(kBigKey) ? pv++ : pb++;
    s.kA[p] = k;
    s.vA[p] = s.vB[i];
  }
  __syncthreads();
  return n_valid;
}

// the voxel centre of the root keys: sum / max(count, 1), a true division
__device__ __forceinline__ float centre(const Params& a, int c) {
  const int n = a.wcount[0];
  return __fdiv_rn(a.wsum[c], static_cast<float>(n < 1 ? 1 : n));
}

__device__ __forceinline__ float rel(const Params& a, long long i, int c, float ctr) {
  return __fmul_rn(__fsub_rn(a.pw[3 * i + c], ctr), a.inv_voxel);
}

// _total_cov + smallest_two_eigvals_sym3 (ops/plane_fit.py) of voxel row v
// of the cell arrays, in float32 in the plain version's order of operations
__device__ bool plane_test(const Params& a, const Scratch& s, int v, float ratio, float* n_tot) {
  const int W = a.W;
  float nt = 0.f, S[3] = {0.f, 0.f, 0.f}, Pt[9];
#pragma unroll
  for (int e = 0; e < 9; ++e) Pt[e] = 0.f;
  const float* ctr = s.cCenter + 3LL * v;
  for (int w = 0; w < W; ++w) {
    const float* T = a.T + 16LL * w;
    const long long cell = static_cast<long long>(v) * W + w;
    const float Nw = s.cN[cell];
    const float* m = s.cMean + 3 * cell;
    const float* Pc = s.cPc + 9 * cell;
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
    nt = __fadd_rn(nt, Nw);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      S[i] = __fadd_rn(S[i], __fmul_rn(Nw, mw[i]));
#pragma unroll
      for (int l = 0; l < 3; ++l) {
        const float rpr = __fadd_rn(__fadd_rn(__fmul_rn(RP[3 * i], T[4 * l]), __fmul_rn(RP[3 * i + 1], T[4 * l + 1])),
                                    __fmul_rn(RP[3 * i + 2], T[4 * l + 2]));
        Pt[3 * i + l] = __fadd_rn(Pt[3 * i + l], __fadd_rn(rpr, __fmul_rn(Nw, __fmul_rn(mw[i], mw[l]))));
      }
    }
  }
  *n_tot = nt;
  if (!(nt >= static_cast<float>(a.min_points))) return false;
  const float n = nt < 1.f ? 1.f : nt;
  float mu[3], A[9];
#pragma unroll
  for (int i = 0; i < 3; ++i) mu[i] = __fdiv_rn(S[i], n);
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int l = 0; l < 3; ++l)
      A[3 * i + l] = __fadd_rn(__fsub_rn(__fdiv_rn(Pt[3 * i + l], n), __fmul_rn(mu[i], mu[l])),
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

// one voxelisation: sort the keys in (kB, vB), then the cells, voxels and
// plane tests into rows [row0, row0 + V) of the cell arrays
__device__ void cluster_pass(const Params& a, const Scratch& s, int row0, float ratio, bool root,
                             int* cnt) {
  const int t = threadIdx.x, P = a.P, W = a.W, V = a.V;
  sort_pairs(s, partition_valid(s, P), cnt);
  for (int i = t; i < P; i += kT) {
    const long long o = s.vA[i];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      s.sl[3LL * i + c] = a.pts_l[3 * o + c];
      s.sw[3LL * i + c] = a.pw[3 * o + c];
    }
    s.kf_s[i] = static_cast<int>(o / a.M);
  }
  const long long cells = static_cast<long long>(V) * W;
  float* cN = s.cN + static_cast<long long>(row0) * W;
  float* cMean = s.cMean + 3LL * row0 * W;
  float* cPc = s.cPc + 9LL * row0 * W;
  float* cCenter = s.cCenter + 3LL * row0;
  for (long long e = t; e < cells; e += kT) cN[e] = 0.f;
  for (long long e = t; e < 3 * cells; e += kT) cMean[e] = 0.f;
  for (long long e = t; e < 9 * cells; e += kT) cPc[e] = 0.f;
  for (long long e = t; e < 3LL * V; e += kT) cCenter[e] = 0.f;

  // segment heads and voxel ids (cumsum of the heads - 1; invalid keys and
  // ranks past V to the dump slot V)
  int lo, hi;
  segment(P, lo, hi);
  int heads = 0;
  for (int i = lo; i < hi; ++i)
    heads += s.kA[i] != static_cast<unsigned>(kBigKey) && (i == 0 || s.kA[i] != s.kA[i - 1]);
  int n_heads;
  int run = block_scan(heads, &n_heads);
  int inside = 0;
  for (int i = lo; i < hi; ++i) {
    const unsigned k = s.kA[i];
    const bool head = k != static_cast<unsigned>(kBigKey) && (i == 0 || k != s.kA[i - 1]);
    run += head;
    int vx = k != static_cast<unsigned>(kBigKey) ? run - 1 : V;
    vx = vx < 0 ? 0 : (vx > V ? V : vx);
    s.vox_s[i] = vx;
    if (root) s.slot[s.vA[i]] = vx;
    if (head && vx < V) s.vox_pos[vx] = i;
    inside += vx < V;
  }
  int n_in;
  block_scan(inside, &n_in);
  const int n_vox = n_heads < V ? n_heads : V;
  // cells: runs of one (voxel, keyframe) inside [0, n_in)
  int starts = 0;
  for (int i = lo; i < hi; ++i)
    starts += s.vox_s[i] < V &&
              (i == 0 || s.vox_s[i] != s.vox_s[i - 1] || s.kf_s[i] != s.kf_s[i - 1]);
  int n_cells;
  run = block_scan(starts, &n_cells);
  for (int i = lo; i < hi; ++i)
    if (s.vox_s[i] < V && (i == 0 || s.vox_s[i] != s.vox_s[i - 1] || s.kf_s[i] != s.kf_s[i - 1]))
      s.cell_pos[run++] = i;
  if (t == 0) {
    s.cell_pos[n_cells] = n_in;
    s.vox_pos[n_vox] = n_in;
  }
  __syncthreads();

  // a thread a cell: N, mean, then the centred scatter, each run in order
  for (int c = t; c < n_cells; c += kT) {
    const int i0 = s.cell_pos[c], i1 = s.cell_pos[c + 1];
    const long long cell = static_cast<long long>(s.vox_s[i0]) * W + s.kf_s[i0];
    float S0 = 0.f, S1 = 0.f, S2 = 0.f;
    for (int i = i0; i < i1; ++i) {
      S0 = __fadd_rn(S0, s.sl[3LL * i]);
      S1 = __fadd_rn(S1, s.sl[3LL * i + 1]);
      S2 = __fadd_rn(S2, s.sl[3LL * i + 2]);
    }
    const float n = static_cast<float>(i1 - i0);
    const float m0 = __fdiv_rn(S0, n), m1 = __fdiv_rn(S1, n), m2 = __fdiv_rn(S2, n);
    float Q[9];
#pragma unroll
    for (int e = 0; e < 9; ++e) Q[e] = 0.f;
    for (int i = i0; i < i1; ++i) {
      const float d[3] = {__fsub_rn(s.sl[3LL * i], m0), __fsub_rn(s.sl[3LL * i + 1], m1),
                          __fsub_rn(s.sl[3LL * i + 2], m2)};
#pragma unroll
      for (int e = 0; e < 9; ++e) Q[e] = __fadd_rn(Q[e], __fmul_rn(d[e / 3], d[e % 3]));
    }
    cN[cell] = n;
    cMean[3 * cell] = m0;
    cMean[3 * cell + 1] = m1;
    cMean[3 * cell + 2] = m2;
#pragma unroll
    for (int e = 0; e < 9; ++e) cPc[9 * cell + e] = Q[e];
  }
  // a thread a voxel: the world-point sum over its run, over its count
  for (int v = t; v < n_vox; v += kT) {
    const int i0 = s.vox_pos[v], i1 = s.vox_pos[v + 1];
    float S0 = 0.f, S1 = 0.f, S2 = 0.f;
    for (int i = i0; i < i1; ++i) {
      S0 = __fadd_rn(S0, s.sw[3LL * i]);
      S1 = __fadd_rn(S1, s.sw[3LL * i + 1]);
      S2 = __fadd_rn(S2, s.sw[3LL * i + 2]);
    }
    const float n = static_cast<float>(i1 - i0);
    cCenter[3LL * v] = __fdiv_rn(S0, n);
    cCenter[3LL * v + 1] = __fdiv_rn(S1, n);
    cCenter[3LL * v + 2] = __fdiv_rn(S2, n);
  }
  __syncthreads();
  for (int v = t; v < V; v += kT) {
    float n_tot;
    const bool planar = plane_test(a, s, row0 + v, ratio, &n_tot);
    s.planar[row0 + v] = planar;
    if (root) s.split[v] = !planar && n_tot >= static_cast<float>(a.min_points);
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kT, 1) clusters_kernel(Params a, Scratch s) {
  extern __shared__ int cnt[];   // [kDigits * kT]
  const int t = threadIdx.x, P = a.P, V = a.V, W = a.W;
  const float ctr[3] = {centre(a, 0), centre(a, 1), centre(a, 2)};

  // root keys: floor(rel) + 256 in [0, 512) on each axis, of valid points
  for (int i = t; i < P; i += kT) {
    int key = kBigKey;
    if (a.val[i]) {
      int r[3];
      bool in = true;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const int f = static_cast<int>(floorf(rel(a, i, c, ctr[c])));
        r[c] = static_cast<int>(static_cast<unsigned>(f) + 256u);   // int32 wraps, as torch
        in = in && r[c] >= 0 && r[c] < 512;
      }
      if (in) key = (r[0] << 18) | (r[1] << 9) | r[2];
    }
    s.key_root[i] = key;
    s.kB[i] = static_cast<unsigned>(key);
    s.vB[i] = static_cast<unsigned>(i);
  }
  __syncthreads();
  cluster_pass(a, s, 0, a.plane_ratio, true, cnt);

  // child keys: the octant of the points of splittable roots
  for (int i = t; i < P; i += kT) {
    const int kr = s.key_root[i], sl = s.slot[i];
    int key = kBigKey;
    if (sl < V && s.split[sl] && kr != kBigKey) {
      int oct = 0;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float x = rel(a, i, c, ctr[c]);
        oct |= (__fsub_rn(x, floorf(x)) >= 0.5f) << c;
      }
      key = kr * 8 + oct;
    }
    s.kB[i] = static_cast<unsigned>(key);
    s.vB[i] = static_cast<unsigned>(i);
  }
  __syncthreads();
  cluster_pass(a, s, V, a.child_ratio, false, cnt);

  // compaction: rows [0, 2V) with planar first, each group in row order
  int lo, hi;
  segment(2 * V, lo, hi);
  int trues = 0;
  for (int j = lo; j < hi; ++j) trues += s.planar[j];
  int n_true;
  int before = block_scan(trues, &n_true);
  for (int j = lo; j < hi; ++j) {
    const int pos = s.planar[j] ? before : n_true + (j - before);
    before += s.planar[j];
    if (pos < V) s.src[pos] = j;
  }
  __syncthreads();
  const long long cells = static_cast<long long>(V) * W;
  for (long long e = t; e < cells; e += kT)
    a.N[e] = s.cN[static_cast<long long>(s.src[e / W]) * W + e % W];
  for (long long e = t; e < 3 * cells; e += kT)
    a.mean[e] = s.cMean[static_cast<long long>(s.src[e / (3 * W)]) * 3 * W + e % (3 * W)];
  for (long long e = t; e < 9 * cells; e += kT)
    a.Pc[e] = s.cPc[static_cast<long long>(s.src[e / (9 * W)]) * 9 * W + e % (9 * W)];
  for (long long e = t; e < 3LL * V; e += kT) a.center[e] = s.cCenter[3LL * s.src[e / 3] + e % 3];
  for (int v = t; v < V; v += kT) a.valid[v] = static_cast<uint8_t>(s.planar[s.src[v]]);
}

}  // namespace

// bytes of scratch a call takes (see tc2li_balm_clusters)
extern "C" long long tc2li_clusters_scratch(int P, int V, int W) {
  return static_cast<long long>(layout(nullptr, P, V, W).total);
}

// pts_l, pw [P, 3] float32 (P = W M, keyframe-major), val [P] uint8, wsum [3]
// float32, wcount [1] int32, T [W, 4, 4] float32; scratch of
// tc2li_clusters_scratch(P, V, W) bytes, 16-byte aligned; outputs N [V, W],
// mean [V, W, 3], Pc [V, W, 3, 3], center [V, 3] float32, valid [V] uint8.
// All contiguous on the device. One launch on `stream`; returns
// cudaGetLastError().
extern "C" int tc2li_balm_clusters(const float* pts_l, const float* pw, const uint8_t* val,
                                   const float* wsum, const int* wcount, const float* T, int W,
                                   int M, int V, int min_points, float inv_voxel,
                                   float plane_ratio, float child_ratio, void* scratch, float* N,
                                   float* mean, float* Pc, float* center, uint8_t* valid,
                                   void* stream) {
  if (W < 0 || M < 0 || V < 1 || (W > 0 && M > 0x7FFFFFFF / 16 / W))
    return static_cast<int>(cudaErrorInvalidValue);
  Params a{pts_l, pw, val, wsum, wcount, T, W * M, W, M < 1 ? 1 : M, V, min_points,
           inv_voxel, plane_ratio, child_ratio, N, mean, Pc, center, valid};
  const Scratch s = layout(static_cast<char*>(scratch), a.P, V, W);
  const int smem = static_cast<int>(sizeof(int) * kDigits * kT);
  cudaError_t e = cudaFuncSetAttribute(clusters_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  clusters_kernel<<<1, kT, smem, static_cast<cudaStream_t>(stream)>>>(a, s);
  return static_cast<int>(cudaGetLastError());
}
