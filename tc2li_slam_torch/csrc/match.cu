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
// costs the 8 XOR + 8 __popc of a distance. Two kernels:
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
// match_best2_kernel (the stereo and dense modes): all of side 2
// (descriptors word-major, so a warp's lanes hit distinct banks; u, v,
// level and band, or validity) is staged once per block in dynamic shared
// memory, 48 or 36 bytes a column. A grid of at most one 32-warp block per
// SM walks groups of 4 rows. A warp owns a group: the rows' positions sit
// in registers, their descriptors in a 128-byte slot of shared memory that
// the warp fills with one load, the lanes stride the columns, and each
// column's data is read from shared memory once for the 4 rows. An invalid
// column carries u = NaN, so it fails the disparity comparison at no extra
// cost.
//
// Both: the mask is tested first, XOR/__popc runs only on admitted pairs.
// Each lane keeps its two smallest keys (distance << 16 | column) per row;
// keys are unique per column, so the smallest is the first column of the
// minimum and the second smallest holds the minimum over the other
// columns. A shuffle tree merges the lanes' pairs. For the mutual test
// every admitted pair also does atomicMin on a packed 64-bit (distance <<
// 32 | row) per column, which gives the first row of the column's minimum
// whatever the block order.
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

enum Mode { kWindow = 0, kStereo = 1, kDense = 2 };

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
  int lo, hi;              // level gate lo <= lvl2 - lvl1 <= hi
  float max_d;             // stereo: -2 <= u1 - u2 <= max_d
  long long* idx;          // [N]
  int* best;               // [N]
  int* second;             // [N]
  unsigned long long* colbest;   // [M] or null (mutual)
  int N, M;
};

__host__ __device__ constexpr int words_per_column(int mode) {
  // stereo, dense: descriptor words + (u, v, level, band) or validity
  return kWords + (mode == kStereo ? 4 : 1);
}

__device__ __forceinline__ void keep_two(int& k1, int& k2, int k) {
  k2 = min(k2, max(k1, k));
  k1 = min(k1, k);
}

static_assert(kRows * kWords == 32, "a warp stages its rows' descriptors one word a lane");

template <int MODE, bool MUTUAL>
__global__ void __launch_bounds__(kThreads)
match_best2_kernel(const Args a) {
  extern __shared__ uint32_t smem[];
  __shared__ uint32_t srow[kWarps][kRows * kWords];   // each warp's row descriptors
  const int M = a.M;
  uint32_t* sdesc = smem;                                     // [8][M]
  float* su = reinterpret_cast<float*>(smem + kWords * M);    // [M]
  float* sv = su + M;                                         // [M]
  int* slvl = reinterpret_cast<int*>(sv + M);                 // [M]
  float* sband = reinterpret_cast<float*>(slvl + M);          // [M]
  int* svalid = reinterpret_cast<int*>(smem + kWords * M);    // [M] dense
  TC2LI_LAP_START

  for (int i = threadIdx.x; i < M * kWords; i += kThreads) {
    const int m = i / kWords;
    const int w = i - m * kWords;
    sdesc[w * M + m] = a.d2[i];
  }
  for (int m = threadIdx.x; m < M; m += kThreads) {
    const bool ok = a.valid2[m] != 0;
    if (MODE == kDense) {
      svalid[m] = ok;
    } else {
      su[m] = ok ? a.uv2[2 * m] : NAN;
      sv[m] = a.uv2[2 * m + 1];
      slvl[m] = a.lvl2[m];
      sband[m] = a.band[m];
    }
  }
  __syncthreads();
  TC2LI_LAP(0);

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_groups = (a.N + kRows - 1) / kRows;
  // neighbouring groups go to different blocks: valid rows cluster (a
  // landmark pool fills from slot 0) and would otherwise load a few SMs
  for (int g = warp * gridDim.x + blockIdx.x; g < n_groups; g += gridDim.x * kWarps) {
    const int r0 = g * kRows;
    bool rv[kRows];
    bool any = false;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      rv[r] = r0 + r < a.N && a.valid1[r0 + r] != 0;
      any = any || rv[r];
    }
    int k1[kRows], k2[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) k1[r] = k2[r] = kNoKey;

    if (any) {
      const size_t word = (size_t)r0 * kWords + lane;
      srow[warp][lane] = word < (size_t)a.N * kWords ? a.d1[word] : 0u;
      __syncwarp();
      float u1[kRows], v1[kRows];
      int l1[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int row = rv[r] ? r0 + r : 0;   // an invalid row reads row 0, admits nothing
        if (MODE != kDense) {
          u1[r] = a.uv1[2 * row];
          v1[r] = a.uv1[2 * row + 1];
          l1[r] = a.lvl1[row];
        }
      }
#pragma unroll 2
      for (int m = lane; m < M; m += 32) {
        float u2, v2, bnd;
        int l2, ok2;
        if (MODE == kDense) {
          ok2 = svalid[m];
        } else {
          u2 = su[m];
          v2 = sv[m];
          l2 = slvl[m];
          bnd = sband[m];
        }
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          bool admit = rv[r];
          if (MODE == kStereo) {
            const int dl = l2 - l1[r];
            const float disp = u1[r] - u2;
            admit = admit && fabsf(v1[r] - v2) <= bnd && disp >= -2.0f && disp <= a.max_d
                    && dl >= a.lo && dl <= a.hi;
          } else {
            admit = admit && ok2 != 0
                    && (a.dense == nullptr || a.dense[(size_t)(r0 + r) * M + m] != 0);
          }
          if (admit) {
            int dist = 0;
#pragma unroll
            for (int w = 0; w < kWords; ++w) {
              dist += __popc(srow[warp][r * kWords + w] ^ sdesc[w * M + m]);
            }
            keep_two(k1[r], k2[r], (dist << 16) | m);
            if (MUTUAL) {
              atomicMin(&a.colbest[m],
                        ((unsigned long long)dist << 32) | (unsigned)(r0 + r));
            }
          }
        }
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          const int o1 = __shfl_xor_sync(0xffffffffu, k1[r], off);
          const int o2 = __shfl_xor_sync(0xffffffffu, k2[r], off);
          k2[r] = min(max(k1[r], o1), min(k2[r], o2));
          k1[r] = min(k1[r], o1);
        }
      }
      __syncwarp();   // all lanes are done with srow before the next group's words land
    }
    if (lane < kRows && r0 + lane < a.N) {
      int b1 = kNoKey, b2 = kNoKey;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (lane == r) {
          b1 = k1[r];
          b2 = k2[r];
        }
      }
      a.idx[r0 + lane] = b1 == kNoKey ? 0 : (b1 & 0xffff);
      a.best[r0 + lane] = b1 == kNoKey ? kBig : (b1 >> 16);
      a.second[r0 + lane] = b2 == kNoKey ? kBig : (b2 >> 16);
    }
  }
  TC2LI_LAP(1);
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

template <int MODE, bool MUTUAL>
int launch(const Args& a, cudaStream_t stream) {
  const int smem = words_per_column(MODE) * a.M * (int)sizeof(uint32_t);
  cudaError_t err = cudaFuncSetAttribute(match_best2_kernel<MODE, MUTUAL>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  // at least ~4 row groups a block, so a small N still spreads over the card
  const int n_groups = (a.N + kRows - 1) / kRows;
  int blocks = (n_groups + 3) / 4;
  if (blocks > sm_count()) blocks = sm_count();
  match_best2_kernel<MODE, MUTUAL><<<blocks, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The most columns (M) whose side fits one block's shared memory in `mode`
// (0 window: the grid; 1 stereo, 2 dense: side 2 staged); also bounded by
// the 16-bit column key.
extern "C" int tc2li_match_max_columns(int mode) {
  // (the window kernel's static shared memory: 1 KB at most)
  const int fit = mode == kWindow
                      ? (kMaxSmem - 1024 - window_smem(0, false)) / 16
                      : kMaxSmem / (words_per_column(mode) * (int)sizeof(uint32_t));
  return fit < 65535 ? fit : 65535;
}

// registers, local (spill) bytes, static shared bytes and the largest block
// of the matcher's kernels: which 0 window, 1 window mutual (both with the
// descriptors in shared memory), 2 stereo mutual, 3 dense mutual
extern "C" int tc2li_match_func_attrs(int which, int* out) {
  cudaFuncAttributes a;
  const void* fns[4] = {reinterpret_cast<const void*>(window_grid_kernel<false, true>),
                        reinterpret_cast<const void*>(window_grid_kernel<true, true>),
                        reinterpret_cast<const void*>(match_best2_kernel<kStereo, true>),
                        reinterpret_cast<const void*>(match_best2_kernel<kDense, true>)};
  if (which < 0 || which > 3) return static_cast<int>(cudaErrorInvalidValue);
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
// M <= tc2li_match_max_columns(mode). Launches on `stream`; returns
// cudaGetLastError() or the error of the shared-memory attribute call.
extern "C" int tc2li_match_best2(
    int mode, int mutual, const uint32_t* d1, const uint8_t* valid1, const uint32_t* d2,
    const uint8_t* valid2, const float* uv1, const int* lvl1, const float* radius,
    const float* uv2, const int* lvl2, const float* band, const uint8_t* dense, int lo,
    int hi, float max_d, long long* idx, int* best, int* second,
    unsigned long long* colbest, int N, int M, void* stream) {
  if (N <= 0 || M <= 0 || mode < 0 || mode > 2 || M > tc2li_match_max_columns(mode)
      || (mutual && colbest == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{d1, valid1, d2, valid2, uv1, lvl1, radius, uv2, lvl2, band, dense,
               lo, hi, max_d, idx, best, second, colbest, N, M};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode * 2 + (mutual ? 1 : 0)) {
    case 0: return launch_window<false>(a, s);
    case 1: return launch_window<true>(a, s);
    case 2: return launch<kStereo, false>(a, s);
    case 3: return launch<kStereo, true>(a, s);
    case 4: return launch<kDense, false>(a, s);
    default: return launch<kDense, true>(a, s);
  }
}
