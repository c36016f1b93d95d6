// Fused mask-first best-two descriptor matcher.
//
// Replaces tc2li_slam_tpu/ops/matching.py:_masked_best2 / match_descriptors
// over hamming_matrix_mxu, which XLA fused on the TPU: a dense [N, M]
// Hamming matrix, a dense [N, M] predicate, and three row reductions. In
// eager PyTorch nothing fuses them, so the 32768 x 2000 tracking match moved
// ~5 GB through device memory for a 0.15 ms matrix kernel. Here [N, M] never
// exists: per row (and, for the mutual test, per column) only the result is
// written.
//
// Bound on the H100: operations, and they depend on the data. Inputs are
// ~1.7 MB at 32768 x 2000 (0.5 us). Every tested (valid row, column) pair
// costs a mask test of ~8 simple operations; only a pair that passes it
// costs the 8 XOR + 8 __popc of a distance. Four kernels:
//
// window_grid_kernel (the window mode, SearchByProjection: the tracking and
// fuse matches of every frame). A window of 15 px x 1.2^level in a
// 1241 x 376 image holds ~4 to 50 of 2,000 keypoints, so a row that tests
// every column does ~98% of its work on columns its window cannot admit.
// One launch, blocks of 32 warps:
// - Each block keeps side 2's columns that a window can admit (valid, u
//   and v finite) in shared memory, 16 bytes a column (u, v, level, the
//   next column of its cell), and the head of each cell's list: 16-px
//   cells, floor(x / 16) wrapped to a 128 x 32 grid (2048 x 512 px before
//   a cell repeats), 16 KB. A column joins its cell's list by one shared
//   atomicExch: no counts, no scan, two block barriers. No other block
//   waits for it.
// - A row visits only the cells that [u1 - r, u1 + r] x [v1 - r, v1 + r]
//   overlaps. The bounds are widened by 2^-20 (|u1| + r), which exceeds the
//   rounding of u1 -+ r and of the comparison: every column that
//   |u1 - u2| < r and |v1 - v2| < r admit in float32 lies between them, so
//   a cell is added exactly where rounding could move a bound across a
//   cell's edge. The cell index scales by a power of two and floors, both
//   monotone, so the column's cell lies in the bounds' range; the range
//   wraps like the columns' cells. A row whose position is not finite, or
//   whose radius is NaN or not positive, admits nothing and visits
//   nothing; an infinite radius visits every cell. Each visited column is
//   tested with the plain chain's comparisons.
// - A warp takes 4 rows, 8 lanes a row, a lane every 8th cell of the
//   row's range (grid row by grid row) and each such cell's list. Up to
//   4,480 columns the block also copies side 2's descriptors to shared
//   memory (32 bytes a column, coalesced); above that an admitted column's
//   descriptor is one 32-byte L2 sector. The 8 lanes' key pairs merge by
//   three shuffles. A warp's first rows and a thread's first two columns
//   are loaded before the grid is built (one strided loop after the
//   barrier in their place was 7-9% slower); an invalid row reads only its
//   valid flag.
// - The results are minima over unique keys, so the visit order changes no
//   bit; the mutual test's per-column atomicMin is order-free as below.
//
// match_best2_stereo_kernel (the stereo mode, match_stereo's mask: the
// frame build's match of every frame). The mask's band gate |v1 - v2| <=
// band[m] (2 x 1.2^level px) admits ~4% of the columns in a 376-row image,
// so a row that tests every column does ~96% of its work on columns it
// cannot admit. One launch of 512-thread blocks, a warp a row (N = 2,000:
// 125 blocks, one an SM):
// - Each block sorts side 2's columns that a row can admit by their band
//   into row bins in its shared memory, after it has issued its rows'
//   loads. A column whose v and band are finite (band >= 0) is binned by
//   bin(v) = clamp(floor((v - vmin) x scale), 0, 1023), scale a power of
//   two over the binned columns' v extent (the extent and the largest band
//   reduced over each warp before one shared atomic): counts by shared
//   atomics, an exclusive scan, a scatter into a CSR layout (u, v, band,
//   level and the column, 20 bytes). A column whose band is +inf can meet a
//   row at any v (|v1 - v2| <= inf holds but for a NaN difference): it goes
//   to a list after the bins that every valid row walks. Any other column
//   (invalid, band NaN or below 0, v not finite at a finite band) admits
//   nothing. The reach of every row is the largest band of a binned column.
// - A row visits the bins that [v1 - reach - e, v1 + reach + e] overlaps,
//   e = 2^-20 (|v1| + reach): e exceeds the rounding of v1 -+ reach and of
//   the comparison, so every binned column that |v1 - v2| <= band admits
//   lies between the bounds, and bin() is monotone (a subtraction, a
//   scaling by a positive power of two, a floor and a clamp), so its bin
//   lies in the range. Consecutive bins are one contiguous range of the CSR
//   layout: a row walks [start[b0], start[b1 + 1]) and the +inf list, a
//   lane every 32nd column in batches of 4 (the admitted columns'
//   descriptors loaded before any key: a load after an atomicMin is not
//   hoisted above it), and tests each with the plain chain's comparisons. A
//   row whose v1 is not finite can meet no binned column and walks the
//   list alone. The rounding of the bounds and bins is pinned (__fsub_rn,
//   __fmul_rn) so that tests/test_torch_stereo_bins_emulation.py repeats it.
// - Why each block builds: the build is a chain of latencies (loads, four
//   barriers, shared atomics; ~8k of block 0's ~10.6k lapped cycles), not
//   of work. On an NVIDIA H100 80GB HBM3 at 700 W, 2,000 x 2,000: as a
//   launch of its own (one 1,024-thread block, the rows its programmatic
//   dependent) it held 5.6 us of an 18.2 us call, the rows waiting on it
//   and on a second launch; shared by the 8 blocks of a cluster through
//   distributed shared memory, the call took 29.8 us; built by every block
//   beside its rows' loads, 11.4 us a call (the kernel 6.2 us, the rest the
//   column-best fill and the launch), the walk in local shared memory.
//
// match_best2_epipolar_kernel (the epipolar mode, the triangulation match
// of each keyframe pair: tc2li_slam_tpu/ops/matching.py:185 epipolar_mask
// with _masked_best2 and match_descriptors, :62, :79). The plain chain
// builds a dense bool [F, F] mask by ~8 eager ops over [N, M] float32
// temporaries (16 MB each at 2,000 x 2,000), and the staged kernel then
// read a mask byte a pair. Here the gate is evaluated per pair from the
// rows' epipolar lines (x1 F12^T, one tensor op before the launch, as the
// plain chain computes them) and each column's position and sigma2. A line
// is not a band in v, so every valid pair is tested: the bound is the
// gate's ~8 operations a valid pair and a distance an admitted pair. One
// launch of 32-warp blocks, two warps a row (125 blocks at N 2,000, one an
// SM; smaller blocks were slower, each block staging all of side 2, and so
// were a warp or four a row: PERF.md, section 6):
// - each block stages side 2's valid columns, 16 bytes each (u2, v2,
//   thresh x sigma2, the column) and, up to 4,821 columns, their 32-byte
//   descriptors, compacted by a warp ballot and a shared atomicAdd, every
//   load in flight before the first store; a block without a valid row
//   stages nothing, an invalid row reads only its flag;
// - a lane tests every 64th staged column in batches of 2, then takes the
//   admitted columns' descriptors (from shared memory, or above 4,821
//   columns one 32-byte L2 sector each), then their keys and atomics; the
//   row's two warps merge their pairs through shared memory; the walk is
//   latency bound (~10 valid rows an SM). The gate repeats the
//   plain chain's rounding one operation at a time (__fmul_rn, __fadd_rn,
//   __fdiv_rn, no contraction, the clamp of l0^2 + l1^2 at 1e-12 that keeps
//   NaN), so every admitted pair is the plain chain's
//   (tests/test_torch_epipolar_emulation.py).
//
// match_best2_dense_kernel (the dense mode: no mask, or a bool [N, M]; the
// pool against a frame in global tracking, a frame against the pool in
// relocalization, a keyframe pair in loop verification, the public
// match_descriptors). Few rows and columns are valid there (a pool of
// 32,768 slots holds hundreds of landmarks; relocalization keeps one
// keyframe's), and the staged kernel it replaces staged all of side 2 in
// every block, walked every column from every row group holding a valid
// row, made a device atomic an admitted pair, and took side 2 in column
// chunks of 6,456 (six launches and eager merges a relocalization
// candidate). One launch for any M up to the 16-bit column key, of at most
// one 16-warp block an SM:
// - each block reads side 2's valid flags into a bit a column and scans
//   their counts, then stages only the valid columns' descriptors
//   (word-major, with their columns) in tiles of shared memory, a tile
//   ~5,000 columns; the walk loops over the tiles and keeps each row's two
//   keys in shared memory across them;
// - it compacts its valid rows (rows b, b + G, ...: a landmark pool fills
//   from slot 0) in row order; a warp takes 4 valid rows and a slice of the
//   tile's columns, so that a block's warps share its few groups; an
//   invalid row is written without a walk;
// - the mutual test takes each column's minimum over a warp's 4 rows in
//   registers, then over the block by shared atomics, and makes one device
//   atomic a staged column that a row of the block admitted.
//
// All: the mask is tested first, XOR/__popc runs only on admitted pairs.
// Each lane keeps its two smallest keys (distance << 16 | column) per row;
// keys are unique per column, so the smallest is the first column of the
// minimum and the second smallest holds the minimum over the other
// columns. A shuffle tree merges the lanes' pairs. For the mutual test
// each column's packed 64-bit (distance << 32 | row) takes atomicMin in
// device memory (an admitted pair's in the window, stereo and epipolar
// modes; a block's minimum in the dense mode), which gives the first row
// of the column's minimum whatever the block order.
//
// The pair tests are the plain chain's comparisons and subtractions, and
// the distances XOR and popcount: every output is equal to the plain
// PyTorch chain.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#ifdef TC2LI_LAPS   // clock laps of a phase split (laps.cuh, tools/match_kernels.py)
#define TC2LI_LAP_TAG match
#include "laps.cuh"
#else
#define TC2LI_LAP_START
#define TC2LI_LAP(k)
#endif

namespace {

constexpr int kWords = 8;
constexpr int kRows = 4;            // rows per warp
constexpr int kThreads = 1024;      // 32 warps: one block fills an SM
constexpr int kWarps = kThreads / 32;
constexpr int kBig = 1 << 20;       // distance of "no admitted column"
constexpr int kNoKey = INT_MAX;
constexpr int kMaxSmem = 232448;    // bytes a block may use on sm_90
constexpr unsigned kFull = 0xffffffffu;

enum Mode { kWindow = 0, kStereo = 1, kDense = 2, kEpipolar = 3 };

// programmatic dependent launch: a kernel launched as a dependent of the
// one before it waits for that kernel's writes here (a no-op in a kernel
// launched without the attribute)
__device__ __forceinline__ void pdl_wait() { asm volatile("griddepcontrol.wait;" ::: "memory"); }

struct Args {
  const uint32_t* d1;      // [N, 8]
  const uint8_t* valid1;   // [N]
  const uint32_t* d2;      // [M, 8]
  const uint8_t* valid2;   // [M]
  const float* uv1;        // [N, 2]   window, stereo
  const int* lvl1;         // [N]      window, stereo
  const float* radius;     // [N]      window
  const float* uv2;        // [M, 2]   window, stereo
  const int* lvl2;         // [M]      window, stereo
  const float* band;       // [M]      stereo
  const uint8_t* dense;    // [N, M] or null   dense
  const float* lines;      // [N, 3]   epipolar: the rows' epipolar lines in view 2
  const float* sigma2;     // [M]      epipolar: the columns' squared level sigma
  int lo, hi;              // level gate lo <= lvl2 - lvl1 <= hi
  float max_d;             // stereo: -2 <= u1 - u2 <= max_d
  float thresh;            // epipolar: d2 < thresh x sigma2
  long long* idx;          // [N]
  int* best;               // [N]
  int* second;             // [N]
  unsigned long long* colbest;   // [M] or null (mutual)
  int N, M;
  int tile;                // dense: the valid columns a tile of shared memory holds
};

__device__ __forceinline__ void keep_two(int& k1, int& k2, int k) {
  k2 = min(k2, max(k1, k));
  k1 = min(k1, k);
}


// ---------------------------------------------------------------------------
// the dense mode: valid rows and columns compacted, the columns in tiles
// ---------------------------------------------------------------------------

constexpr int kDenseThreads = 512;    // 16 warps: one block an SM
constexpr int kDenseWarps = kDenseThreads / 32;
constexpr int kDenseBatch = kDenseThreads;   // rows a block compacts at once, one a thread
constexpr int kDenseRowsPerBlock = 8;        // the grid: a block per 8 rows, at most one an SM
constexpr int kDenseStage = 2;               // columns a thread stages with their loads in flight
constexpr int kDenseFlagWords = 4;           // words of 32 column flags a thread reads
// a staged column in dynamic shared memory: its 8 words, its column and,
// for the mutual test, the block's smallest (distance << 16 | row slot)
constexpr int kDenseColBytes = 4 * (kWords + 2);
constexpr int kDenseMaxColumns = 65535;      // the 16-bit column of a row key
constexpr unsigned kNoCol = 0xffffffffu;     // a staged column no row of the block admitted

static_assert(kRows * kWords == 32, "a warp holds its rows' descriptors one word a lane");
static_assert(kDenseFlagWords * 32 * kDenseThreads > kDenseMaxColumns, "every flag read");

struct DenseShared {
  int rows[kDenseBatch];        // the batch's valid rows, in row order
  int rk1[kDenseBatch];         // each one's two smallest keys over the tiles walked so far
  int rk2[kDenseBatch];
  uint32_t rdesc[kDenseWarps][kRows * kWords];   // each warp's 4 rows' descriptors
  int wsum[2][kDenseWarps];     // each warp's valid rows and valid columns, then their prefix
  int n_rows, n_cols;
};

// bit k: byte k of x is not 0
__device__ __forceinline__ unsigned nonzero_bytes(unsigned x) {
  return ((__vcmpne4(x, 0u) & 0x01010101u) * 0x10204080u) >> 28;
}
__device__ __forceinline__ unsigned nonzero_bytes(uint4 q) {
  return nonzero_bytes(q.x) | nonzero_bytes(q.y) << 4 | nonzero_bytes(q.z) << 8
         | nonzero_bytes(q.w) << 12;
}

// the position of b's k-th set bit (k from 0; b has more than k)
__device__ __forceinline__ int select_bit(unsigned b, int k) {
  int pos = 0;
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) {
    const int c = __popc(b & ((1u << s) - 1u));
    if (k >= c) {
      k -= c;
      b >>= s;
      pos += s;
    }
  }
  return pos;
}

// A warp's exclusive prefix of v over its lanes; the warp's total in `total`.
__device__ __forceinline__ int warp_prefix(int v, int lane, int& total) {
  int x = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int o = __shfl_up_sync(kFull, x, off);
    if (lane >= off) x += o;
  }
  total = __shfl_sync(kFull, x, 31);
  return x - v;
}

// A row key k into a row's two smallest (*k1, *k2) in shared memory, in any
// order beside other inserts: the key a minimum displaces, or k itself where
// it displaces none, goes on to *k2. Every key but the final *k1 reaches
// *k2, so both end as the two smallest of all inserted keys.
__device__ __forceinline__ void insert_key(int* k1, int* k2, int k) {
  const int old = atomicMin(k1, k);
  atomicMin(k2, max(old, k));
}

// Block b takes rows b, b + G, b + 2G, ... (G blocks: a landmark pool fills
// from slot 0, so neighbouring rows go to different blocks), a batch of
// kDenseBatch at a time, and compacts the valid ones in row order by a warp
// ballot and a scan; an invalid row gets (0, BIG, BIG) written at once.
// Every block reads side 2's valid flags (eight 16-byte loads a thread, in
// flight before the first use) into a bit a column and scans the bits'
// counts, so the r-th valid column is known to every thread. The valid
// columns go to shared memory in tiles of `a.tile` (all of them in one tile
// up to ~5,000 columns), word-major with their columns: a thread stages
// ranks tid, tid + 512, ... of the tile, finding each rank's word by a
// binary search over the counts, kDenseStage columns' loads in flight. A
// warp takes 4 valid rows and 1/S of the tile's columns (S slices: the
// block's 16 warps spread over its groups of rows), a lane every (32 S)th
// staged column, the mask's byte read only for a valid row and a staged
// column; its lanes' two smallest keys (distance << 16 | column) merge by a
// shuffle tree and go into the rows' keys in shared memory by insert_key,
// which keeps them across slices and tiles. For the mutual test a lane
// takes its column's minimum over the warp's 4 rows of (distance << 16 |
// row slot) in registers, then one shared atomicMin a column; after the
// tile each column that a row of the block admitted makes one atomicMin of
// (distance << 32 | row) in device memory. Minima over unique keys do not
// depend on the order of the visits, the inserts or the blocks, and the
// slots are in row order, so every output is the plain chain's.
template <bool MUTUAL>
__global__ void __launch_bounds__(kDenseThreads)
match_best2_dense_kernel(const Args a) {
  extern __shared__ uint32_t dense_smem[];
  __shared__ DenseShared sh;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned below = (1u << lane) - 1u;
  const int M = a.M, nw = (M + 31) >> 5, cap = a.tile;
  uint32_t* bits = dense_smem;                                   // [nw] a bit a valid column
  int* pre = reinterpret_cast<int*>(dense_smem + nw);            // [nw + 1] valid before word w
  uint32_t* tdesc = dense_smem + 2 * nw + 1;                     // [8][cap] staged descriptors
  int* tcol = reinterpret_cast<int*>(tdesc + kWords * cap);      // [cap] their columns
  unsigned* tmin = reinterpret_cast<unsigned*>(tcol + cap);      // [cap] (mutual) block minima
  const uint4* d2v = reinterpret_cast<const uint4*>(a.d2);
  TC2LI_LAP_START

  // the first batch's row flag, and side 2's flags as this thread's words
  // of bits: columns [128 tid, 128 tid + 128) as eight 16-byte loads, a
  // ragged last piece by bytes; every load issued before any is used
  const long long r0 = (long long)tid * gridDim.x + blockIdx.x;
  const bool ok0 = r0 < a.N && a.valid1[r0] != 0;
  unsigned fb[kDenseFlagWords];
  {
    uint4 fq[2 * kDenseFlagWords];
#pragma unroll
    for (int k = 0; k < 2 * kDenseFlagWords; ++k) {
      const int c0 = 32 * kDenseFlagWords * tid + 16 * k;
      fq[k] = c0 + 16 <= M ? reinterpret_cast<const uint4*>(a.valid2)[c0 >> 4]
                           : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int w = 0; w < kDenseFlagWords; ++w) {
      fb[w] = nonzero_bytes(fq[2 * w]) | nonzero_bytes(fq[2 * w + 1]) << 16;
    }
#pragma unroll
    for (int k = 0; k < 2 * kDenseFlagWords; ++k) {
      const int c0 = 32 * kDenseFlagWords * tid + 16 * k;
      if (c0 < M && c0 + 16 > M) {
        for (int i = 0; i < M - c0; ++i) {
          fb[k >> 1] |= (unsigned)(a.valid2[c0 + i] != 0) << (16 * (k & 1) + i);
        }
      }
    }
  }

  for (int j0 = 0; (long long)j0 * gridDim.x + blockIdx.x < a.N; j0 += kDenseBatch) {
    const bool first = j0 == 0;
    const long long r = (long long)(j0 + tid) * gridDim.x + blockIdx.x;
    const bool ok = first ? ok0 : r < a.N && a.valid1[r] != 0;
    int cpre = 0, ctot = 0;
    if (first) {   // the bits to shared memory, their counts' prefix over the warp
#pragma unroll
      for (int w = 0; w < kDenseFlagWords; ++w) {
        const int wi = kDenseFlagWords * tid + w;
        if (wi < nw) bits[wi] = fb[w];
        cpre += __popc(fb[w]);
      }
      cpre = warp_prefix(cpre, lane, ctot);
      if (lane == 0) sh.wsum[1][warp] = ctot;
    }
    const unsigned bal = __ballot_sync(kFull, ok);
    if (lane == 0) sh.wsum[0][warp] = __popc(bal);
    if (r < a.N && !ok) {
      a.idx[r] = 0;
      a.best[r] = kBig;
      a.second[r] = kBig;
    }
    __syncthreads();
    if (warp == 0) {   // the warps' prefixes: rows, and in the first batch columns
      int tot;
      const int p = warp_prefix(lane < kDenseWarps ? sh.wsum[0][lane] : 0, lane, tot);
      if (lane < kDenseWarps) sh.wsum[0][lane] = p;
      if (lane == 0) sh.n_rows = tot;
      if (first) {
        const int q = warp_prefix(lane < kDenseWarps ? sh.wsum[1][lane] : 0, lane, tot);
        if (lane < kDenseWarps) sh.wsum[1][lane] = q;
        if (lane == 0) sh.n_cols = tot;
      }
    }
    __syncthreads();
    if (ok) {
      const int p = sh.wsum[0][warp] + __popc(bal & below);
      sh.rows[p] = static_cast<int>(r);
      sh.rk1[p] = sh.rk2[p] = kNoKey;
    }
    if (first) {
      int c = sh.wsum[1][warp] + cpre;
#pragma unroll
      for (int w = 0; w < kDenseFlagWords; ++w) {
        const int wi = kDenseFlagWords * tid + w;
        if (wi < nw) pre[wi] = c;
        c += __popc(fb[w]);
      }
      if (tid == 0) pre[nw] = sh.n_cols;
    }
    const int R = sh.n_rows, V = sh.n_cols;
    __syncthreads();
    TC2LI_LAP(15);
    if (R == 0) continue;   // (block-uniform; every barrier above is behind it)

    const int groups = (R + kRows - 1) / kRows;
    for (int base = 0; base < V; base += cap) {
      const int C = min(cap, V - base);
      // warps' items (a group of 4 rows, a slice of the columns)
      const int S = max(1, min((kDenseWarps + groups - 1) / groups, (C + 31) >> 5));
      const int items = groups * S;
      auto row_word = [&](int it) -> uint32_t {
        const int pr = kRows * (it / S) + (lane >> 3);
        return pr < R ? __ldg(&a.d1[(size_t)sh.rows[pr] * kWords + (lane & 7)]) : 0u;
      };
      uint32_t rw = warp < items ? row_word(warp) : 0u;   // in flight beside the staging
      // stage the tile: ranks [base, base + C)
      for (int t0 = tid; t0 < C; t0 += kDenseStage * kDenseThreads) {
        int col[kDenseStage];
        uint4 g0[kDenseStage], g1[kDenseStage];
#pragma unroll
        for (int k = 0; k < kDenseStage; ++k) {
          const int t = t0 + k * kDenseThreads;
          col[k] = -1;
          if (t < C) {
            const int rank = base + t;
            int lo = 0, hi = nw;   // the last word with pre[w] <= rank
            while (hi - lo > 1) {
              const int mid = (lo + hi) >> 1;
              if (pre[mid] <= rank) lo = mid;
              else hi = mid;
            }
            col[k] = 32 * lo + select_bit(bits[lo], rank - pre[lo]);
            g0[k] = __ldg(&d2v[2 * col[k]]);
            g1[k] = __ldg(&d2v[2 * col[k] + 1]);
          }
        }
#pragma unroll
        for (int k = 0; k < kDenseStage; ++k) {
          const int t = t0 + k * kDenseThreads;
          if (col[k] >= 0) {
            tdesc[0 * cap + t] = g0[k].x;
            tdesc[1 * cap + t] = g0[k].y;
            tdesc[2 * cap + t] = g0[k].z;
            tdesc[3 * cap + t] = g0[k].w;
            tdesc[4 * cap + t] = g1[k].x;
            tdesc[5 * cap + t] = g1[k].y;
            tdesc[6 * cap + t] = g1[k].z;
            tdesc[7 * cap + t] = g1[k].w;
            tcol[t] = col[k];
            if (MUTUAL) tmin[t] = kNoCol;
          }
        }
      }
      __syncthreads();
      TC2LI_LAP(17);

      for (int it = warp; it < items; it += kDenseWarps) {
        if (it != warp) rw = row_word(it);
        const int g = it / S, s = it - g * S, p0 = kRows * g;
        sh.rdesc[warp][lane] = rw;
        __syncwarp();
        const uint32_t* q = sh.rdesc[warp];
        bool rv[kRows];
        int row[kRows], k1[kRows], k2[kRows];
#pragma unroll
        for (int j = 0; j < kRows; ++j) {
          rv[j] = p0 + j < R;
          row[j] = rv[j] ? sh.rows[p0 + j] : 0;
          k1[j] = k2[j] = kNoKey;
        }
        for (int t = 32 * s + lane; t < C; t += 32 * S) {
          uint32_t cw[kWords];
#pragma unroll
          for (int w = 0; w < kWords; ++w) cw[w] = tdesc[w * cap + t];
          const int m = tcol[t];
          bool adm[kRows];
#pragma unroll
          for (int j = 0; j < kRows; ++j) {
            adm[j] = rv[j] && (a.dense == nullptr || a.dense[(size_t)row[j] * M + m] != 0);
          }
          unsigned cm = kNoCol;
#pragma unroll
          for (int j = 0; j < kRows; ++j) {
            if (adm[j]) {
              int dist = 0;
#pragma unroll
              for (int w = 0; w < kWords; ++w) dist += __popc(q[j * kWords + w] ^ cw[w]);
              keep_two(k1[j], k2[j], (dist << 16) | m);
              if (MUTUAL) cm = min(cm, ((unsigned)dist << 16) | (unsigned)(p0 + j));
            }
          }
          if (MUTUAL && cm != kNoCol) atomicMin(&tmin[t], cm);
        }
#pragma unroll
        for (int j = 0; j < kRows; ++j) {
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) {
            const int o1 = __shfl_xor_sync(kFull, k1[j], off);
            const int o2 = __shfl_xor_sync(kFull, k2[j], off);
            k2[j] = min(max(k1[j], o1), min(k2[j], o2));
            k1[j] = min(k1[j], o1);
          }
        }
        if (lane < kRows && p0 + lane < R) {
          int c1 = kNoKey, c2 = kNoKey;
#pragma unroll
          for (int j = 0; j < kRows; ++j) {
            if (lane == j) {
              c1 = k1[j];
              c2 = k2[j];
            }
          }
          if (c1 != kNoKey) insert_key(&sh.rk1[p0 + lane], &sh.rk2[p0 + lane], c1);
          if (c2 != kNoKey) insert_key(&sh.rk1[p0 + lane], &sh.rk2[p0 + lane], c2);
        }
        __syncwarp();   // all lanes are done with rdesc before the next item's words land
      }
      __syncthreads();
      TC2LI_LAP(18);
      if (MUTUAL) {   // the block's column minima, one device atomic a column it admitted
        for (int t = tid; t < C; t += kDenseThreads) {
          const unsigned v = tmin[t];
          if (v != kNoCol) {
            atomicMin(&a.colbest[tcol[t]],
                      ((unsigned long long)(v >> 16) << 32) | (unsigned)sh.rows[v & 0xffffu]);
          }
        }
      }
      __syncthreads();   // the tile's space is free for the next one
      TC2LI_LAP(19);
    }
    for (int p = tid; p < R; p += kDenseThreads) {
      const int row = sh.rows[p], k1 = sh.rk1[p], k2 = sh.rk2[p];
      a.idx[row] = k1 == kNoKey ? 0 : (k1 & 0xffff);
      a.best[row] = k1 == kNoKey ? kBig : (k1 >> 16);
      a.second[row] = k2 == kNoKey ? kBig : (k2 >> 16);
    }
    __syncthreads();   // the batch's rows and keys are free for the next batch
    TC2LI_LAP(20);
  }
}


// ---------------------------------------------------------------------------
// the stereo mode: side 2 in row bins, built by each block
// ---------------------------------------------------------------------------

constexpr int kBinsLog2 = 10;
constexpr int kBins = 1 << kBinsLog2;   // row bins over the binned columns' v extent
constexpr int kStereoThreads = 512;     // 16 warps, a warp a row
constexpr int kStereoWarps = kStereoThreads / 32;
constexpr int kBinCols = 10;            // columns a build thread holds in registers
constexpr int kStereoMaxColumns = kStereoThreads * kBinCols;   // 5,120
constexpr int kStereoBatch = 4;         // columns a lane loads before it tests them

static_assert(kBins == 2 * kStereoThreads, "the scan gives two bins to a thread");

struct StereoBins {        // the build's head, in shared memory
  int start[kBins + 1];    // counts, then bin b's columns at [start[b], start[b + 1]);
                           // start[kBins] = the binned columns, then the +inf list
  int n_wide;              // columns of band +inf, after the binned ones
  float vmin, scale;       // bin(v) = clamp(floor((v - vmin) x scale), 0, kBins - 1)
  float reach;             // the largest band of a binned column, or -1 (none)
  unsigned vlo, vhi;       // the binned columns' v extent, as order keys
  int band_bits;           // the largest band's bits
  int warp_sum[kStereoWarps];
};

// a float's bits as an unsigned key in the order of the floats
__device__ __forceinline__ unsigned order_key(float v) {
  const unsigned u = __float_as_uint(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}
__device__ __forceinline__ float from_key(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7FFFFFFFu) : ~k);
}

// A power of two with extent x scale < kBins (within a factor of two of the
// largest such); the bins' exactness does not depend on it, only their
// width: any positive finite scale keeps bin() monotone.
__device__ __forceinline__ float bin_scale(float extent) {
  if (!(extent > 0.f)) return 1.f;
  if (!isfinite(extent)) return 0x1p-126f;
  int ex;
  frexpf(extent, &ex);   // extent < 2^ex
  return ldexpf(1.f, max(-126, min(kBinsLog2 - ex, 126)));
}

// the bin of a row coordinate: monotone in v for any finite vmin and
// positive finite scale (every step rounds monotonically; fmaxf takes 0 for
// a NaN, which no finite v and vmin make)
__device__ __forceinline__ int bin_of(float v, float vmin, float scale) {
  const float f = floorf(__fmul_rn(__fsub_rn(v, vmin), scale));
  return static_cast<int>(fminf(fmaxf(f, 0.f), static_cast<float>(kBins - 1)));
}

// The block's build: side 2 in CSR order in `rec` / `col` (u, v, band,
// level bits; the column), `sb` its head.
__device__ __forceinline__ void build_bins(const Args& a, StereoBins& sb, float4* rec,
                                           int* col) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // 1. each thread's columns, loads first
  float2 p[kBinCols];
  float bnd[kBinCols];
  int lv[kBinCols];
  bool ok[kBinCols];
#pragma unroll
  for (int k = 0; k < kBinCols; ++k) {
    const int m = tid + k * kStereoThreads;
    ok[k] = false;
    if (m < a.M) {
      ok[k] = a.valid2[m] != 0;
      p[k] = reinterpret_cast<const float2*>(a.uv2)[m];
      lv[k] = a.lvl2[m];
    }
  }
  // chained behind the stereo prep launch (csrc/stereo.cu), which writes the
  // bands and fills the column-best buffer: everything above is older. The
  // dependent (the refine launch) is let start only as these blocks exit:
  // started at the wait, its blocks crowded the few SMs that no block of
  // this launch holds and slowed its own tail (PERF.md, section 6)
  pdl_wait();
#pragma unroll
  for (int k = 0; k < kBinCols; ++k) {
    const int m = tid + k * kStereoThreads;
    if (m < a.M) bnd[k] = a.band[m];
  }
  sb.start[2 * tid] = sb.start[2 * tid + 1] = 0;
  if (tid == 0) {
    sb.vlo = 0xFFFFFFFFu;
    sb.vhi = 0u;
    sb.band_bits = -1;
    sb.n_wide = 0;
  }
  __syncthreads();
  // 2. classes: binned (v, band finite, band >= 0), the +inf list, none;
  // the v extent and the largest band reduced over the warp first
  int cls[kBinCols], rank[kBinCols], bin[kBinCols];
  unsigned klo = 0xFFFFFFFFu, khi = 0u;
  int top = -1;
#pragma unroll
  for (int k = 0; k < kBinCols; ++k) {
    cls[k] = 0;
    if (ok[k] && isfinite(p[k].y) && isfinite(bnd[k]) && bnd[k] >= 0.f) {
      cls[k] = 1;
      klo = min(klo, order_key(p[k].y));
      khi = max(khi, order_key(p[k].y));
      top = max(top, __float_as_int(bnd[k] + 0.f));   // (-0 as +0: bits order as floats)
    } else if (ok[k] && bnd[k] == INFINITY) {
      cls[k] = 2;
      rank[k] = atomicAdd(&sb.n_wide, 1);
    }
  }
  klo = __reduce_min_sync(kFull, klo);
  khi = __reduce_max_sync(kFull, khi);
  top = __reduce_max_sync(kFull, top);
  if (lane == 0) {
    atomicMin(&sb.vlo, klo);
    atomicMax(&sb.vhi, khi);
    atomicMax(&sb.band_bits, top);
  }
  __syncthreads();
  TC2LI_LAP(7);
  const bool any = sb.vlo <= sb.vhi;
  const float vmin = any ? from_key(sb.vlo) : 0.f;
  const float scale = any ? bin_scale(__fsub_rn(from_key(sb.vhi), vmin)) : 1.f;
#pragma unroll
  for (int k = 0; k < kBinCols; ++k) {
    if (cls[k] == 1) {
      bin[k] = bin_of(p[k].y, vmin, scale);
      rank[k] = atomicAdd(&sb.start[bin[k]], 1);
    }
  }
  __syncthreads();
  TC2LI_LAP(8);
  // 3. exclusive scan of the counts, two bins a thread
  const int c0 = sb.start[2 * tid], c1 = sb.start[2 * tid + 1];
  int incl = c0 + c1;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int o = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += o;
  }
  if (lane == 31) sb.warp_sum[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int w = lane < kStereoWarps ? sb.warp_sum[lane] : 0;
#pragma unroll
    for (int off = 1; off < kStereoWarps; off <<= 1) {
      const int o = __shfl_up_sync(kFull, w, off);
      if (lane >= off) w += o;
    }
    if (lane < kStereoWarps) sb.warp_sum[lane] = w;   // inclusive over warps
  }
  __syncthreads();
  const int first = incl - c0 - c1 + (warp > 0 ? sb.warp_sum[warp - 1] : 0);
  const int n_binned = sb.warp_sum[kStereoWarps - 1];
  sb.start[2 * tid] = first;   // (only this thread read its two counts)
  sb.start[2 * tid + 1] = first + c0;
  if (tid == 0) {
    sb.start[kBins] = n_binned;
    sb.vmin = vmin;
    sb.scale = scale;
    sb.reach = sb.band_bits < 0 ? -1.f : __int_as_float(sb.band_bits);
  }
  __syncthreads();
  TC2LI_LAP(9);
  // 4. the scatter into the CSR layout
#pragma unroll
  for (int k = 0; k < kBinCols; ++k) {
    if (cls[k] != 0) {
      const int pos = cls[k] == 1 ? sb.start[bin[k]] + rank[k] : n_binned + rank[k];
      rec[pos] = make_float4(p[k].x, p[k].y, bnd[k], __int_as_float(lv[k]));
      col[pos] = tid + k * kStereoThreads;
    }
  }
  TC2LI_LAP(10);
}

template <bool MUTUAL>
__global__ void __launch_bounds__(kStereoThreads)
match_best2_stereo_kernel(const Args a) {
  extern __shared__ float4 rec[];       // [M] records in CSR order, then int [M] columns
  __shared__ StereoBins sb;             // the build's head
  const int* col = reinterpret_cast<const int*>(rec + a.M);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // a warp a row; neighbouring rows go to different blocks
  const int row = warp * gridDim.x + blockIdx.x;
  const uint4* d2v = reinterpret_cast<const uint4*>(a.d2);
  TC2LI_LAP_START
  // the row's inputs, loaded before the build
  const bool ok = row < a.N && a.valid1[row] != 0;
  float2 p1 = make_float2(0.f, 0.f);
  int l1 = 0;
  uint4 q0 = make_uint4(0, 0, 0, 0), q1 = q0;
  if (ok) {
    p1 = reinterpret_cast<const float2*>(a.uv1)[row];
    l1 = a.lvl1[row];
    q0 = reinterpret_cast<const uint4*>(a.d1)[2 * row];
    q1 = reinterpret_cast<const uint4*>(a.d1)[2 * row + 1];
  }
  build_bins(a, sb, rec, reinterpret_cast<int*>(rec + a.M));
  __syncthreads();
  TC2LI_LAP(11);
  int k1 = kNoKey, k2 = kNoKey;
  if (ok) {
    int p0 = 0, n_bin = 0;
    const float r = sb.reach;
    if (isfinite(p1.y) && r >= 0.f) {
      const float vmin = sb.vmin, sc = sb.scale;
      const float e = __fmul_rn(__fadd_rn(fabsf(p1.y), r), 0x1p-20f);
      const int b0 = bin_of(__fsub_rn(__fsub_rn(p1.y, r), e), vmin, sc);
      const int b1 = bin_of(__fadd_rn(__fadd_rn(p1.y, r), e), vmin, sc);
      p0 = sb.start[b0];
      n_bin = sb.start[b1 + 1] - p0;
    }
    const int w0 = sb.start[kBins];
    const int total = n_bin + sb.n_wide;
    // a batch: the lane's next kStereoBatch columns loaded, then tested, then
    // the admitted ones' descriptors loaded, then their keys and atomics
    for (int t0 = lane; t0 < total; t0 += 32 * kStereoBatch) {
      float4 c[kStereoBatch];
      int m[kStereoBatch];
#pragma unroll
      for (int j = 0; j < kStereoBatch; ++j) {
        const int t = t0 + 32 * j;
        c[j] = make_float4(0.f, 0.f, 0.f, 0.f);
        m[j] = 0;
        if (t < total) {
          const int pos = t < n_bin ? p0 + t : w0 + (t - n_bin);
          c[j] = rec[pos];
          m[j] = col[pos];
        }
      }
      bool adm[kStereoBatch];
      uint4 w0v[kStereoBatch], w1v[kStereoBatch];
#pragma unroll
      for (int j = 0; j < kStereoBatch; ++j) {
        const int dl = __float_as_int(c[j].w) - l1;
        const float disp = p1.x - c[j].x;
        adm[j] = t0 + 32 * j < total && fabsf(p1.y - c[j].y) <= c[j].z && disp >= -2.0f
                 && disp <= a.max_d && dl >= a.lo && dl <= a.hi;
        if (adm[j]) {
          w0v[j] = __ldg(&d2v[2 * m[j]]);
          w1v[j] = __ldg(&d2v[2 * m[j] + 1]);
        }
      }
#pragma unroll
      for (int j = 0; j < kStereoBatch; ++j) {
        if (adm[j]) {
          const int dist = __popc(q0.x ^ w0v[j].x) + __popc(q0.y ^ w0v[j].y)
                           + __popc(q0.z ^ w0v[j].z) + __popc(q0.w ^ w0v[j].w)
                           + __popc(q1.x ^ w1v[j].x) + __popc(q1.y ^ w1v[j].y)
                           + __popc(q1.z ^ w1v[j].z) + __popc(q1.w ^ w1v[j].w);
          keep_two(k1, k2, (dist << 16) | m[j]);
          if (MUTUAL) {
            atomicMin(&a.colbest[m[j]], ((unsigned long long)dist << 32) | (unsigned)row);
          }
        }
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const int o1 = __shfl_xor_sync(kFull, k1, off);
    const int o2 = __shfl_xor_sync(kFull, k2, off);
    k2 = min(max(k1, o1), min(k2, o2));
    k1 = min(k1, o1);
  }
  if (lane == 0 && row < a.N) {
    a.idx[row] = k1 == kNoKey ? 0 : (k1 & 0xffff);
    a.best[row] = k1 == kNoKey ? kBig : (k1 >> 16);
    a.second[row] = k2 == kNoKey ? kBig : (k2 >> 16);
  }
  TC2LI_LAP(12);
}


// ---------------------------------------------------------------------------
// the epipolar mode: the triangulation match's gate evaluated per pair
// ---------------------------------------------------------------------------

constexpr int kEpiWarps = 32;                 // warps a block
constexpr int kEpiRowWarps = 2;               // warps a row: a lane every (32 x this)th column
constexpr int kEpiRows = kEpiWarps / kEpiRowWarps;   // rows a block
constexpr int kEpiThreads = 32 * kEpiWarps;
constexpr int kEpiBatch = 2;                  // columns a lane tests before their keys
constexpr int kEpiStage = 2;                  // columns a thread loads before it stages them
static_assert(kEpiWarps % kEpiRowWarps == 0, "a block holds whole rows");
// columns a launch takes: 16 bytes a staged column in dynamic shared memory;
// up to kEpiDescColumns the block also stages their descriptors (32 bytes)
constexpr int kEpiMaxColumns = (kMaxSmem - 1024) / 16;
constexpr int kEpiDescColumns = (kMaxSmem - 1024) / 48;

// The plain chain's gate of one pair (ops/kernels/match.py epipolar_gate):
// num = |(l0 u2 + l1 v2) + l2|, d2 = num^2 / max(l0^2 + l1^2, 1e-12) (NaN
// kept), admitted where d2 < thresh x sigma2; each operation rounded alone,
// as eager PyTorch computes it, so no multiply-add is contracted. (A quick
// decision by n2 x (1 / den) against widened margins, with the division
// only near the gate, was exact but 13% slower on the card: its branches
// cost more than the division's few instructions.)
__device__ __forceinline__ bool epi_admits(float l0, float l1, float l2, float den,
                                           const float4& c) {
  const float num = fabsf(__fadd_rn(__fadd_rn(__fmul_rn(l0, c.x), __fmul_rn(l1, c.y)), l2));
  return __fdiv_rn(__fmul_rn(num, num), den) < c.z;
}

// Each block stages side 2's valid columns once, 16 bytes each (u2, v2,
// thresh x sigma2, the column) and, with SDESC, their descriptors, compacted
// in any order by a warp ballot and a shared counter: an invalid column
// costs its loads alone and no row walks it. A row takes kEpiRowWarps of
// the block's warps; an invalid row reads only its flag, and a block
// without a valid row stages nothing. A lane tests every (32 kEpiRowWarps)th
// staged column in batches of kEpiBatch, then takes the admitted ones'
// descriptors (from
// shared memory with SDESC, else one L2 sector each, loaded before any key:
// a load after an atomicMin is not hoisted above it), their keys and
// atomics; the row's warps merge their pairs through shared memory. The
// keys are unique per column, so neither the staging order nor the split of
// a row between warps changes a bit.
template <bool MUTUAL, bool SDESC>
__global__ void __launch_bounds__(kEpiThreads)
match_best2_epipolar_kernel(const Args a) {
  extern __shared__ uint4 epi_smem[];
  float4* ecol = reinterpret_cast<float4*>(epi_smem);   // [M] at most: the valid columns
  uint4* edesc = epi_smem + a.M;                        // [M][2] their descriptors (SDESC)
  __shared__ int n_cols;
  __shared__ int2 part[kEpiWarps];                      // each warp's two keys
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int sub = warp % kEpiRowWarps;                  // the warp's share of its row
  const int row = blockIdx.x * kEpiRows + warp / kEpiRowWarps;
  const uint4* d2v = reinterpret_cast<const uint4*>(a.d2);
  TC2LI_LAP_START
  if (threadIdx.x == 0) n_cols = 0;
  // the row's inputs first
  const bool ok = row < a.N && a.valid1[row] != 0;
  float l0 = 0.f, l1 = 0.f, l2 = 0.f;
  uint4 q0 = make_uint4(0, 0, 0, 0), q1 = q0;
  if (ok) {
    l0 = a.lines[3 * row];
    l1 = a.lines[3 * row + 1];
    l2 = a.lines[3 * row + 2];
    q0 = reinterpret_cast<const uint4*>(a.d1)[2 * row];
    q1 = reinterpret_cast<const uint4*>(a.d1)[2 * row + 1];
  }
  int k1 = kNoKey, k2 = kNoKey;
  if (__syncthreads_or(ok)) {
    // side 2's valid columns to shared memory: kEpiStage columns a thread,
    // every load issued before any is used (the loop bound is the warp's,
    // so that every lane takes the ballots)
    for (int w0 = 32 * warp; w0 < a.M; w0 += kEpiStage * kEpiThreads) {
      const int m0 = w0 + lane;
      bool v[kEpiStage];
      float2 p[kEpiStage];
      float s2[kEpiStage];
      uint4 g0[kEpiStage], g1[kEpiStage];
#pragma unroll
      for (int j = 0; j < kEpiStage; ++j) {
        const int m = m0 + j * kEpiThreads;
        v[j] = false;
        if (m < a.M) {
          v[j] = a.valid2[m] != 0;
          p[j] = reinterpret_cast<const float2*>(a.uv2)[m];
          s2[j] = a.sigma2[m];
          if (SDESC) {
            g0[j] = __ldg(&d2v[2 * m]);
            g1[j] = __ldg(&d2v[2 * m + 1]);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < kEpiStage; ++j) {
        const unsigned mask = __ballot_sync(kFull, v[j]);
        int base = 0;
        if (lane == 0 && mask) base = atomicAdd(&n_cols, __popc(mask));
        base = __shfl_sync(kFull, base, 0);
        if (v[j]) {
          const int t = base + __popc(mask & ((1u << lane) - 1u));
          ecol[t] = make_float4(p[j].x, p[j].y, __fmul_rn(a.thresh, s2[j]),
                                __int_as_float(m0 + j * kEpiThreads));
          if (SDESC) {
            edesc[2 * t] = g0[j];
            edesc[2 * t + 1] = g1[j];
          }
        }
      }
    }
    __syncthreads();
    TC2LI_LAP(13);
    if (ok) {
      const float den2 = __fadd_rn(__fmul_rn(l0, l0), __fmul_rn(l1, l1));
      const float den = den2 < 1e-12f ? 1e-12f : den2;   // torch.clamp(min=1e-12); NaN stays
      const int total = n_cols;
      constexpr int kStride = 32 * kEpiRowWarps;   // a row's lanes
      for (int t0 = 32 * sub + lane; t0 < total; t0 += kStride * kEpiBatch) {
        float4 c[kEpiBatch];
        bool adm[kEpiBatch];
#pragma unroll
        for (int j = 0; j < kEpiBatch; ++j) {
          const int t = t0 + kStride * j;
          c[j] = ecol[t < total ? t : 0];
          adm[j] = t < total && epi_admits(l0, l1, l2, den, c[j]);
        }
        uint4 w0v[kEpiBatch], w1v[kEpiBatch];
#pragma unroll
        for (int j = 0; j < kEpiBatch; ++j) {
          if (adm[j]) {
            const int t = t0 + kStride * j;
            const int m = __float_as_int(c[j].w);
            w0v[j] = SDESC ? edesc[2 * t] : __ldg(&d2v[2 * m]);
            w1v[j] = SDESC ? edesc[2 * t + 1] : __ldg(&d2v[2 * m + 1]);
          }
        }
#pragma unroll
        for (int j = 0; j < kEpiBatch; ++j) {
          if (adm[j]) {
            const int m = __float_as_int(c[j].w);
            const int dist = __popc(q0.x ^ w0v[j].x) + __popc(q0.y ^ w0v[j].y)
                             + __popc(q0.z ^ w0v[j].z) + __popc(q0.w ^ w0v[j].w)
                             + __popc(q1.x ^ w1v[j].x) + __popc(q1.y ^ w1v[j].y)
                             + __popc(q1.z ^ w1v[j].z) + __popc(q1.w ^ w1v[j].w);
            keep_two(k1, k2, (dist << 16) | m);
            if (MUTUAL) {
              atomicMin(&a.colbest[m], ((unsigned long long)dist << 32) | (unsigned)row);
            }
          }
        }
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const int o1 = __shfl_xor_sync(kFull, k1, off);
      const int o2 = __shfl_xor_sync(kFull, k2, off);
      k2 = min(max(k1, o1), min(k2, o2));
      k1 = min(k1, o1);
    }
    if (kEpiRowWarps > 1) {   // the row's warps' pairs, merged on its first warp
      if (lane == 0) part[warp] = make_int2(k1, k2);
      __syncthreads();
      if (sub == 0) {
#pragma unroll
        for (int h = 1; h < kEpiRowWarps; ++h) {
          const int2 o = part[warp + h];
          k2 = min(max(k1, o.x), min(k2, o.y));
          k1 = min(k1, o.x);
        }
      }
    }
    TC2LI_LAP(14);
  }
  if (lane == 0 && sub == 0 && row < a.N) {
    a.idx[row] = k1 == kNoKey ? 0 : (k1 & 0xffff);
    a.best[row] = k1 == kNoKey ? kBig : (k1 >> 16);
    a.second[row] = k2 == kNoKey ? kBig : (k2 >> 16);
  }
}


// ---------------------------------------------------------------------------
// the window mode: a column grid
// ---------------------------------------------------------------------------

constexpr int kGX = 128, kGY = 32, kCells = kGX * kGY;  // 16-px cells, 2048 x 512 px, wrapped
constexpr float kCellScale = 0.0625f;                   // 1 / 16 px: a power of two
constexpr int kRowLanes = 8;                            // lanes a row
constexpr int kRowsPerWarp = 32 / kRowLanes;
constexpr int kPre = 2;                                 // columns a thread keeps in registers

struct GridCol {   // a column of side 2 in shared memory, in column order
  float u, v;
  int lvl;
  int next;        // the next column of its cell's list, or -1
};

// A coordinate's cell index along an axis before wrapping, floor(x / 16 px):
// the scaling by a power of two is exact (but for subnormals) and both
// steps are monotone, so x <= y gives cell(x) <= cell(y) for every float.
__device__ __forceinline__ float cell_f(float x) { return floorf(x * kCellScale); }

// A cell index wrapped to [0, n): exact for any integer-valued float.
__device__ __forceinline__ int wrap(float f, int n) {
  return static_cast<int>(f - floorf(f / static_cast<float>(n)) * static_cast<float>(n));
}

__device__ __forceinline__ int cell_of(float2 p) {
  return wrap(cell_f(p.y), kGY) * kGX + wrap(cell_f(p.x), kGX);
}

// A column a window can admit: valid and at a finite position (|u1 - u2| <
// r is false for an infinite u2 whatever r and u1, and for NaN).
__device__ __forceinline__ bool on_grid(const Args& a, int m, float2& p) {
  if (m >= a.M) return false;
  p = reinterpret_cast<const float2*>(a.uv2)[m];
  return a.valid2[m] != 0 && isfinite(p.x) && isfinite(p.y);
}

// The cells a row's window can reach along one axis, before wrapping:
// [f0, f1] from the bounds x -+ r widened by 2^-20 (|x| + r). That exceeds
// the rounding of x -+ r and of the comparison |x - x2| < r, so it adds a
// cell exactly where rounding could move a bound across a cell's edge.
// Returns the first cell wrapped and the number of cells (n: all).
__device__ __forceinline__ void cell_range(float x, float r, int n, int& c0, int& nc) {
  const float m = (fabsf(x) + r) * 0x1p-20f;
  const float f0 = cell_f(x - r - m), f1 = cell_f(x + r + m);
  const bool all = !(f1 - f0 < static_cast<float>(n - 1));   // (an infinite r too)
  c0 = all ? 0 : wrap(f0, n);
  nc = all ? n : static_cast<int>(f1 - f0) + 1;
}

// a row's inputs (a row that is not valid, or whose position is not finite
// or whose radius is not positive, admits nothing: ok false); an invalid
// row reads only its valid flag
struct RowIn {
  bool ok;
  float2 p;
  float r;
  int lvl;
  uint4 q0, q1;
};

__device__ __forceinline__ RowIn load_row(const Args& a, int row) {
  RowIn in{false};
  if (row < a.N && a.valid1[row] != 0) {
    in.p = reinterpret_cast<const float2*>(a.uv1)[row];
    in.r = a.radius[row];
    in.lvl = a.lvl1[row];
    in.q0 = reinterpret_cast<const uint4*>(a.d1)[2 * row];
    in.q1 = reinterpret_cast<const uint4*>(a.d1)[2 * row + 1];
    in.ok = isfinite(in.p.x) && isfinite(in.p.y) && in.r > 0.f;
  }
  return in;
}

// SDESC: side 2's descriptors are copied to shared memory (M <=
// kDescColumns), else read from L2
template <bool MUTUAL, bool SDESC>
__global__ void __launch_bounds__(kThreads)
window_grid_kernel(const Args a) {
  extern __shared__ uint4 smem4[];
  GridCol* cols = reinterpret_cast<GridCol*>(smem4);             // [M]
  int* head = reinterpret_cast<int*>(cols + a.M);                 // [kCells]
  uint4* sdesc = reinterpret_cast<uint4*>(head + kCells);         // [M][2] SDESC
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int M = a.M;
  const uint4* d2v = reinterpret_cast<const uint4*>(a.d2);
  TC2LI_LAP_START

  // the loads that need no grid, first: this warp's first 4 rows and this
  // thread's first kPre columns
  const int sub = lane % kRowLanes;
  const int n_groups = (a.N + kRowsPerWarp - 1) / kRowsPerWarp;
  // neighbouring groups go to different blocks: valid rows cluster (a
  // landmark pool fills from slot 0) and would otherwise load a few SMs
  const int g0 = warp * gridDim.x + blockIdx.x;
  RowIn in = load_row(a, g0 * kRowsPerWarp + lane / kRowLanes);
  float2 cp[kPre];
  bool con[kPre];
  int cl[kPre];
#pragma unroll
  for (int k = 0; k < kPre; ++k) {   // (independent loads, issued together)
    const int m = tid + k * kThreads;
    con[k] = false;
    if (m < M) {
      cp[k] = reinterpret_cast<const float2*>(a.uv2)[m];
      cl[k] = a.lvl2[m];
      con[k] = a.valid2[m] != 0;
    }
  }
#pragma unroll
  for (int k = 0; k < kPre; ++k) {
    con[k] = con[k] && isfinite(cp[k].x) && isfinite(cp[k].y);
    if (con[k]) cols[tid + k * kThreads] = GridCol{cp[k].x, cp[k].y, cl[k], -1};
  }
  for (int m = tid + kPre * kThreads; m < M; m += kThreads) {
    float2 p;
    if (on_grid(a, m, p)) cols[m] = GridCol{p.x, p.y, a.lvl2[m], -1};
  }
  if (SDESC) {   // four loads in flight a thread, then their stores
    for (int e0 = tid; e0 < 2 * M; e0 += 4 * kThreads) {
      uint4 w[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (e0 + k * kThreads < 2 * M) w[k] = d2v[e0 + k * kThreads];
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (e0 + k * kThreads < 2 * M) sdesc[e0 + k * kThreads] = w[k];
      }
    }
  }
  for (int c = tid; c < kCells; c += kThreads) head[c] = -1;
  __syncthreads();
  TC2LI_LAP(3);

  // 1. each column to the front of its cell's list
#pragma unroll
  for (int k = 0; k < kPre; ++k) {
    if (con[k]) {
      const int m = tid + k * kThreads;
      cols[m].next = atomicExch(&head[cell_of(cp[k])], m);
    }
  }
  for (int m = tid + kPre * kThreads; m < M; m += kThreads) {
    float2 p;
    if (on_grid(a, m, p)) cols[m].next = atomicExch(&head[cell_of(p)], m);
  }
  __syncthreads();
  TC2LI_LAP(5);

  // 2. rows: a warp 4 rows, 8 lanes a row, a lane every 8th cell of the
  // row's range
  for (int g = g0; g < n_groups; g += gridDim.x * kWarps) {
    const int row = g * kRowsPerWarp + lane / kRowLanes;
    if (g != g0) in = load_row(a, row);
    int k1 = kNoKey, k2 = kNoKey;
    if (in.ok) {
      int cx0, ncx, cy0, ncy;
      cell_range(in.p.x, in.r, kGX, cx0, ncx);
      cell_range(in.p.y, in.r, kGY, cy0, ncy);
      for (int t = sub; t < ncx * ncy; t += kRowLanes) {
        const int y = t / ncx, x = t - y * ncx;
        const int cy = cy0 + y < kGY ? cy0 + y : cy0 + y - kGY;
        const int cx = cx0 + x < kGX ? cx0 + x : cx0 + x - kGX;
        for (int j = head[cy * kGX + cx]; j >= 0;) {
          const GridCol c = cols[j];
          const int dl = c.lvl - in.lvl;
          if (fabsf(in.p.x - c.u) < in.r && fabsf(in.p.y - c.v) < in.r && dl >= a.lo
              && dl <= a.hi) {
            const uint4 w0 = SDESC ? sdesc[2 * j] : __ldg(&d2v[2 * j]);
            const uint4 w1 = SDESC ? sdesc[2 * j + 1] : __ldg(&d2v[2 * j + 1]);
            const int dist = __popc(in.q0.x ^ w0.x) + __popc(in.q0.y ^ w0.y)
                             + __popc(in.q0.z ^ w0.z) + __popc(in.q0.w ^ w0.w)
                             + __popc(in.q1.x ^ w1.x) + __popc(in.q1.y ^ w1.y)
                             + __popc(in.q1.z ^ w1.z) + __popc(in.q1.w ^ w1.w);
            keep_two(k1, k2, (dist << 16) | j);
            if (MUTUAL) {
              atomicMin(&a.colbest[j], ((unsigned long long)dist << 32) | (unsigned)row);
            }
          }
          j = c.next;
        }
      }
    }
#pragma unroll
    for (int off = 1; off < kRowLanes; off <<= 1) {
      const int o1 = __shfl_xor_sync(kFull, k1, off);
      const int o2 = __shfl_xor_sync(kFull, k2, off);
      k2 = min(max(k1, o1), min(k2, o2));
      k1 = min(k1, o1);
    }
    if (sub == 0 && row < a.N) {
      a.idx[row] = k1 == kNoKey ? 0 : (k1 & 0xffff);
      a.best[row] = k1 == kNoKey ? kBig : (k1 >> 16);
      a.second[row] = k2 == kNoKey ? kBig : (k2 >> 16);
    }
  }
  TC2LI_LAP(6);
}

// dynamic shared memory of the window mode at M columns, with or without
// the descriptors' copy: the columns (16 bytes), the cells' list heads,
// the descriptors (32 bytes)
constexpr int window_smem(int M, bool sdesc) { return (sdesc ? 48 : 16) * M + 4 * kCells; }
// (the window kernel's static shared memory: 1 KB at most)
constexpr int kDescColumns = (kMaxSmem - 1024 - 4 * kCells) / 48;

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess
        || cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess
        || n <= 0) {
      n = 132;
    }
  }
  return n;
}

template <bool MUTUAL, bool SDESC>
int launch_grid(const Args& a, cudaStream_t stream) {
  const int smem = window_smem(a.M, SDESC);
  cudaError_t err = cudaFuncSetAttribute(window_grid_kernel<MUTUAL, SDESC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  // a warp for each group of 4 rows, as far as the card has SMs
  const int n_groups = (a.N + kRowsPerWarp - 1) / kRowsPerWarp;
  int blocks = (n_groups + kWarps - 1) / kWarps;
  if (blocks > sm_count()) blocks = sm_count();
  window_grid_kernel<MUTUAL, SDESC><<<blocks, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <bool MUTUAL>
int launch_window(const Args& a, cudaStream_t stream) {
  return a.M <= kDescColumns ? launch_grid<MUTUAL, true>(a, stream)
                             : launch_grid<MUTUAL, false>(a, stream);
}

// The dynamic shared memory a dense-mode block may take (its static part
// read once), or a negative CUDA error.
template <bool MUTUAL>
int dense_room() {
  static int room = -1;
  if (room < 0) {
    cudaFuncAttributes fa;
    cudaError_t e = cudaFuncGetAttributes(&fa, match_best2_dense_kernel<MUTUAL>);
    if (e != cudaSuccess) return -static_cast<int>(e);
    const int r = kMaxSmem - static_cast<int>(fa.sharedSizeBytes);
    e = cudaFuncSetAttribute(match_best2_dense_kernel<MUTUAL>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, r);
    if (e != cudaSuccess) return -static_cast<int>(e);
    room = r;
  }
  return room;
}

// the bytes of side 2's flag bits and their counts' prefix (8 bytes a word
// of 32 columns) at M columns
constexpr int dense_flag_bytes(int M) { return 4 * (2 * ((M + 31) / 32) + 1); }

// a block per kDenseRowsPerBlock rows, at most one an SM; its dynamic shared
// memory holds side 2's flag bits and their counts' prefix and a tile of
// valid columns, as many as the rest holds
template <bool MUTUAL>
int launch_dense(const Args& a0, cudaStream_t stream) {
  const int room = dense_room<MUTUAL>();
  if (room < 0) return -room;
  Args a = a0;
  a.tile = min(a.M, (room - dense_flag_bytes(a.M)) / kDenseColBytes);
  const int smem = dense_flag_bytes(a.M) + kDenseColBytes * a.tile;
  int blocks = (a.N + kDenseRowsPerBlock - 1) / kDenseRowsPerBlock;
  if (blocks > sm_count()) blocks = sm_count();
  match_best2_dense_kernel<MUTUAL><<<blocks, kDenseThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// `kernel` on `blocks` x `threads` with `smem` bytes of dynamic shared
// memory; `chained`: as a programmatic dependent of the launch before it
template <typename K>
int launch(K kernel, const Args& a, int blocks, int threads, int smem, bool chained,
           cudaStream_t stream) {
  cudaLaunchAttribute at;
  at.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  at.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = &at;
  cfg.numAttrs = chained ? 1 : 0;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, a);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

// a block a 16 rows; its dynamic shared memory holds side 2 in CSR order
// (20 bytes a column)
template <bool MUTUAL>
int launch_stereo(const Args& a, bool chained, cudaStream_t stream) {
  static int smem_set = 0;
  const int smem = 20 * a.M;
  if (smem > smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        match_best2_stereo_kernel<MUTUAL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        20 * kStereoMaxColumns);
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_set = 20 * kStereoMaxColumns;
  }
  const int blocks = (a.N + kStereoWarps - 1) / kStereoWarps;
  return launch(match_best2_stereo_kernel<MUTUAL>, a, blocks, kStereoThreads, smem, chained,
                stream);
}

// a block kEpiRows rows; its dynamic shared memory holds side 2's valid
// columns (16 bytes a column) and, up to kEpiDescColumns, their descriptors
template <bool MUTUAL, bool SDESC>
int launch_epi(const Args& a, cudaStream_t stream) {
  static int smem_set = 0;
  const int smem = (SDESC ? 48 : 16) * a.M;
  if (smem > smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        match_best2_epipolar_kernel<MUTUAL, SDESC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMaxSmem - 1024);
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_set = kMaxSmem - 1024;
  }
  const int blocks = (a.N + kEpiRows - 1) / kEpiRows;
  return launch(match_best2_epipolar_kernel<MUTUAL, SDESC>, a, blocks, kEpiThreads, smem, false,
                stream);
}

template <bool MUTUAL>
int launch_epipolar(const Args& a, cudaStream_t stream) {
  return a.M <= kEpiDescColumns ? launch_epi<MUTUAL, true>(a, stream)
                                : launch_epi<MUTUAL, false>(a, stream);
}

}  // namespace

// The most columns (M) a launch takes in `mode`: 0 window, the grid's
// columns in shared memory; 1 stereo, the build's registers (10 a thread);
// 2 dense, the 16-bit column key (the valid columns go through shared
// memory in tiles); 3 epipolar, the valid columns staged in shared memory;
// each also bounded by the 16-bit column key.
extern "C" int tc2li_match_max_columns(int mode) {
  // (the window kernel's static shared memory: 1 KB at most)
  const int fit = mode == kWindow   ? (kMaxSmem - 1024 - window_smem(0, false)) / 16
                  : mode == kStereo ? kStereoMaxColumns
                  : mode == kDense  ? kDenseMaxColumns
                                    : kEpiMaxColumns;
  return fit < 65535 ? fit : 65535;
}

// The valid columns a tile of the dense mode's shared memory holds at M
// columns (1 <= M <= 65,535), or a negative CUDA error.
extern "C" int tc2li_match_dense_tile(int M) {
  const int room = dense_room<true>();
  if (room < 0) return room;
  return min(M, (room - dense_flag_bytes(M)) / kDenseColBytes);
}

// registers, local (spill) bytes, static shared bytes and the largest block
// of the matcher's kernels: which 0 window, 1 window mutual (both with the
// descriptors in shared memory), 2 stereo mutual, 3 dense mutual, 4
// epipolar mutual
extern "C" int tc2li_match_func_attrs(int which, int* out) {
  cudaFuncAttributes a;
  const void* fns[5] = {reinterpret_cast<const void*>(window_grid_kernel<false, true>),
                        reinterpret_cast<const void*>(window_grid_kernel<true, true>),
                        reinterpret_cast<const void*>(match_best2_stereo_kernel<true>),
                        reinterpret_cast<const void*>(match_best2_dense_kernel<true>),
                        reinterpret_cast<const void*>(match_best2_epipolar_kernel<true, true>)};
  if (which < 0 || which > 4) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t e = cudaFuncGetAttributes(&a, fns[which]);
  out[0] = a.numRegs;
  out[1] = static_cast<int>(a.localSizeBytes);
  out[2] = static_cast<int>(a.sharedSizeBytes);
  out[3] = a.maxThreadsPerBlock;
  return static_cast<int>(e);
}

// Row-wise best two admitted columns. All pointers are contiguous device
// arrays of the shapes in `Args`; those a mode does not use may be null.
// colbest (mutual != 0) must hold (1 << 20) << 32 on entry and receives
// min over admitted rows of (distance << 32 | row). N, M > 0 and
// M <= tc2li_match_max_columns(mode). The window, stereo and epipolar modes
// read d1, d2 as 16-byte and uv1, uv2 as 8-byte words, the dense mode d2 and
// valid2 as 16-byte words: those pointers must be aligned. `chained` (the
// stereo mode only): the launch is a programmatic dependent of the one
// before it on `stream`, which may still be writing
// `band` and `colbest` (csrc/stereo.cu's prep launch). Launches on
// `stream`; returns cudaGetLastError() or the error of the shared-memory
// attribute call.
extern "C" int tc2li_match_best2(
    int mode, int mutual, int chained, const uint32_t* d1, const uint8_t* valid1,
    const uint32_t* d2, const uint8_t* valid2, const float* uv1, const int* lvl1,
    const float* radius, const float* uv2, const int* lvl2, const float* band,
    const uint8_t* dense, const float* lines, const float* sigma2, int lo, int hi, float max_d,
    float thresh, long long* idx, int* best, int* second, unsigned long long* colbest, int N,
    int M, void* stream) {
  if (N <= 0 || M <= 0 || mode < 0 || mode > 3 || M > tc2li_match_max_columns(mode)
      || (mutual && colbest == nullptr) || (chained && mode != kStereo)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{d1, valid1, d2, valid2, uv1, lvl1, radius, uv2, lvl2, band, dense, lines,
               sigma2, lo, hi, max_d, thresh, idx, best, second, colbest, N, M};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode * 2 + (mutual ? 1 : 0)) {
    case 0: return launch_window<false>(a, s);
    case 1: return launch_window<true>(a, s);
    case 2: return launch_stereo<false>(a, chained != 0, s);
    case 3: return launch_stereo<true>(a, chained != 0, s);
    case 4: return launch_dense<false>(a, s);
    case 5: return launch_dense<true>(a, s);
    case 6: return launch_epipolar<false>(a, s);
    default: return launch_epipolar<true>(a, s);
  }
}
