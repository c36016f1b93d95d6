// ORB after FAST: the pyramid and blur planes, the grid top-k and
// orientation with rBRIEF, for every plane or every keypoint of one or two
// images: one launch each, the grid top-k two.
//
// Replaces the jit-compiled body of tc2li_slam_tpu/ops/orb.py:extract
// around the FAST kernel: jax.image.resize(..., "linear") with
// gaussian_blur7 and the stack writes (:419-433, :275), select_topk_grid
// (:204) and compute_orientation_stacked / compute_descriptors_stacked
// (:369, :377; there the rBRIEF taps are a one-hot bf16 contraction for the
// TPU's matrix unit, here they are read directly). In eager PyTorch the
// same work was ~1,500 small ops a stereo pair.
//
// Every kernel repeats its plain PyTorch version's arithmetic (ops/kernels/
// orb.py) operation for operation, with __fmul_rn / __fadd_rn where the
// plain version multiplies and then adds, so that nvcc's contraction into
// FMAs cannot change a bit: the outputs are bit-equal to the plain version.
//
// orb_level_planes. Bound: bytes (the padded planes of both stacks, ~27.8 MB
// for two 1241x376 images, ~8.3 us at 3.35 TB/s). A block takes a tile of
// 32 x 64 pixels of one level (the wrapper's level_tiles lists them) and
// writes its part of both stacks: the tile, and where the tile lies on the
// plane's edge the replicated border beside it, so every pixel of a padded
// region is written by one block, from level pixels it has computed. The
// tile and the blur's 3-pixel halo are built in shared memory in the halo's
// reflected coordinates (REFLECT_101 once a pixel; the blur loops read
// without clamps): level 0 copies the image; a resized level runs a warp a
// level row, the vertical pass over the image columns the tile reads into
// the warp's own row buffer, then the horizontal pass, with no block
// barrier between rows; the tap count is a template parameter (a switch on
// the plane's count), so an output's loads are issued together. The
// vertical blur takes a run of 4 rows a thread, the horizontal blur a run of
// 4 columns, each from 10 loads. ~30 KB of shared memory and at most 80
// registers a thread (3 blocks an SM); the halo adds 30% to a whole tile's
// level pixels. The wrapper orders the grid top level first: a tile's
// resize reads more image pixels the higher its level, and started first
// the long tiles no longer trail the launch. On an NVIDIA H100 80GB HBM3 at
// 700 W (tools/orb_kernels.py, a KITTI pair): 0.072 ms in level order, 0.049
// top level first, 0.046 with the templated taps; loads of a group of taps
// under a runtime count, narrower tiles at the top levels and 16 warps a
// block were each slower.
//
// orb_select_grid, two launches. Bound: bytes (the score planes, ~3.5 us for
// a KITTI pair). (1) The cell pass, a warp a 16x16 cell, over the cells of
// every plane: the cell's top m_cand by rounds of warp arg-max (ties to the
// lower in-cell index), each written as a key (rank descending, then the
// candidate index ascending; ~0 where the slot keeps no candidate) and its
// pixel, at the candidate's own slot cell x m_cand + slot: no atomics, no
// position that depends on the schedule. (2) A block a plane takes its
// first k keys in order: a radix select of the k-th smallest key, 8 bits a
// pass (integer histograms in shared memory: their counts do not depend on
// the order of the adds), then each selected key's slot by a rank count
// among the k. A plane's keys lie in scratch in device memory (the
// wrapper's torch.empty), held in shared memory as far as they fit, so a
// plane takes any number of candidates. The launch boundary is the barrier
// between a plane's cells, which many blocks compute, and its selection.
//
// orb_describe. Bound: bytes (4,000 keypoints a stereo pair; the distinct
// pixels the patches and taps read, ~2.7 us). Two keypoints a warp, side by
// side, 8 a block: a lane loads its 32 pattern coordinates beside the
// keypoints' indices, then its two patch columns' 62 pixels at once, and
// runs the four float64 chains of the moments (column dx over its rows in
// order, fma(p, u, s): p u is exact, so it rounds where the plain
// version's add does); lanes 2 k and 2 k + 1 add keypoint k's column sums
// in column order from shared memory; the moments are rounded to float32
// before atan2f; then a lane gathers its 16 blurred pixels of each
// keypoint (8 of the 256 tests, rintf, half to even, as torch.round), all
// 32 in flight before the first compare, a ballot packs each word and lane
// 8 k + w stores word w of keypoint k. The parent's form (a warp a
// keypoint, a pattern load before each of eight tap rounds) took 0.0119 ms
// on a KITTI pair; this one 0.0096 (NVIDIA H100 80GB HBM3, 700 W,
// tools/orb_kernels.py --describe-only); block 0's warp spends ~5k cycles
// on the patch and ~3k on the gathers. Staging each keypoint's 37 x 40 blur
// window in shared memory by cp.async, so that no tap is read from L2 after
// the angle, was slower (0.0128-0.0158 ms): it reads the whole window where
// the gathers read only the sectors the taps touch.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#ifdef TC2LI_LAPS   // clock laps of a phase split (laps.cuh, tools/orb_kernels.py)
#define TC2LI_LAP_TAG orb
#include "laps.cuh"
#else
#define TC2LI_LAP_START
#define TC2LI_LAP(k)
#endif

namespace {

constexpr int kMaxPlanes = 32;

// ---------------------------------------------------------------------------
// orb_level_planes
// ---------------------------------------------------------------------------

constexpr int kTileH = 32;                   // level rows of a tile (a lane a row below)
constexpr int kTileW = 64;                   // level columns of a tile
constexpr int kHalo = 3;                     // blur radius
constexpr int kLH = kTileH + 2 * kHalo;      // rows of the tile with its halo
constexpr int kLW = kTileW + 2 * kHalo;      // columns of the tile with its halo
constexpr int kLPitch = kLW + 1;             // odd: a lane a row reads distinct banks
constexpr int kBPitch = kTileW + 1;
constexpr int kMaxSpan = 320;                // image columns a tile's resize reads
constexpr int kMaxTaps = 16;                 // taps an output of the resize
constexpr int kLevelWarps = 8;
constexpr int kLevelThreads = 32 * kLevelWarps;
constexpr int kRun = 4;                      // outputs a thread of each blur pass
static_assert(kTileH == 32, "the horizontal blur takes a lane a row");
static_assert(kTileH * kBPitch <= kLevelWarps * kMaxSpan, "the blurred tile in the row buffers");

struct LevelPlane {
  int img;        // image of the plane
  int H, W;       // level shape
  int resize;     // 0: the level is the image itself
  int fr, wr;     // row table: first tap index at first[fr + y], weights at w[wr + y * tr]
  int fc, wc;     // column table, likewise
  int tr, tc;     // taps per output row / column
  int out_off;    // offset (floats) of the plane's padded pixel (0, 0) in the stacks
  int tile0;      // first tile of the plane in the flat grid
  int tiles_x;    // tiles per row of the level
};

struct LevelTable {
  LevelPlane p[kMaxPlanes];
  int n;
  int pad;
  int in_H, in_W;   // image shape
  int stride;       // row stride of the stacks
  float gk[7];      // blur taps
};

__device__ __forceinline__ int reflect101(int i, int n) {
  return i < 0 ? -i : (i >= n ? 2 * (n - 1) - i : i);
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// A resized level row in two passes, T taps an output (a template
// parameter: the T loads of an output are issued together, none waits on
// the sum). Each output adds its taps in order from the first product, as
// the plain version does.
template <int T>
__device__ __forceinline__ float tap_sum(const float (&w)[T], const float (&x)[T]) {
  float acc = __fmul_rn(w[0], x[0]);
#pragma unroll
  for (int k = 1; k < T; ++k) acc = __fadd_rn(acc, __fmul_rn(w[k], x[k]));
  return acc;
}

// vertical pass: buf[c] over the image rows col, col + stride, ...
template <int T>
__device__ void vertical_row(float* buf, const float* __restrict__ w,
                             const float* __restrict__ col, int stride, int nc, int lane) {
  float wv[T];
#pragma unroll
  for (int k = 0; k < T; ++k) wv[k] = w[k];
#pragma unroll 2
  for (int c = lane; c < nc; c += 32) {
    float x[T];
#pragma unroll
    for (int k = 0; k < T; ++k) x[k] = col[static_cast<size_t>(k) * stride + c];
    buf[c] = tap_sum(wv, x);
  }
}

// horizontal pass: the tile's level columns (halo reflected) from buf
template <int T>
__device__ void horizontal_row(float* Lrow, const float* buf, const float* __restrict__ wc,
                               const int* __restrict__ fcol, int c0, int sx0, int W, int nlx,
                               int lane) {
  for (int j = lane; j < nlx; j += 32) {
    const int lx = reflect101(sx0 - kHalo + j, W);
    const float* tp = buf + (fcol[lx] - c0);
    float wv[T], x[T];
#pragma unroll
    for (int k = 0; k < T; ++k) {
      wv[k] = wc[lx * T + k];
      x[k] = tp[k];
    }
    Lrow[j] = tap_sum(wv, x);
  }
}

// fn<n>(args) for a tap count n of 1 .. kMaxTaps (the wrapper checks n)
#define TAPS_CASE(n, fn, args) \
  case n:                      \
    fn<n> args;                \
    break;
#define TAPS_DISPATCH(n, fn, args)                                                       \
  switch (n) {                                                                           \
    TAPS_CASE(1, fn, args) TAPS_CASE(2, fn, args) TAPS_CASE(3, fn, args)                 \
    TAPS_CASE(4, fn, args) TAPS_CASE(5, fn, args) TAPS_CASE(6, fn, args)                 \
    TAPS_CASE(7, fn, args) TAPS_CASE(8, fn, args) TAPS_CASE(9, fn, args)                 \
    TAPS_CASE(10, fn, args) TAPS_CASE(11, fn, args) TAPS_CASE(12, fn, args)              \
    TAPS_CASE(13, fn, args) TAPS_CASE(14, fn, args) TAPS_CASE(15, fn, args)              \
    TAPS_CASE(16, fn, args)                                                              \
    default:                                                                             \
      break;                                                                             \
  }
static_assert(kMaxTaps == 16, "TAPS_DISPATCH lists 1 .. 16 taps");

__global__ void __launch_bounds__(kLevelThreads, 3)
level_planes_kernel(const float* __restrict__ img, float* __restrict__ img_stack,
                    float* __restrict__ blur_stack, const int* __restrict__ first,
                    const float* __restrict__ wts, const LevelTable t) {
  __shared__ float L[kLH][kLPitch];              // level pixels, halo rows and columns reflected
  __shared__ float V[kTileH][kLPitch];           // the vertical blur
  __shared__ float S[kLevelWarps * kMaxSpan];    // the warps' row buffers, then both blurs
  float(*Bs)[kBPitch] = reinterpret_cast<float(*)[kBPitch]>(S);

  int pi = 0;
  for (int i = 1; i < t.n; ++i) {
    if (static_cast<int>(blockIdx.x) >= t.p[i].tile0) pi = i;
  }
  const LevelPlane pl = t.p[pi];
  const int local = blockIdx.x - pl.tile0;
  const int ty = local / pl.tiles_x, tx = local - ty * pl.tiles_x;
  const int sy0 = ty * kTileH, sx0 = tx * kTileW;
  const int nsy = min(kTileH, pl.H - sy0), nsx = min(kTileW, pl.W - sx0);
  const int nly = nsy + 2 * kHalo, nlx = nsx + 2 * kHalo;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float* src = img + static_cast<size_t>(pl.img) * t.in_H * t.in_W;

  if (!pl.resize) {
    for (int i = warp; i < nly; i += kLevelWarps) {
      const float* row = src + static_cast<size_t>(reflect101(sy0 - kHalo + i, pl.H)) * t.in_W;
      for (int j = lane; j < nlx; j += 32) L[i][j] = row[reflect101(sx0 - kHalo + j, pl.W)];
    }
  } else {
    // a warp a level row: the vertical pass over the image columns the
    // tile's columns read, into the warp's buffer, then the horizontal pass
    float* buf = S + warp * kMaxSpan;
    const int* fcol = first + pl.fc;
    const int lxa = max(0, sx0 - kHalo), lxb = min(pl.W - 1, sx0 + nsx - 1 + kHalo);
    const int c0 = fcol[lxa];
    const int nc = fcol[lxb] + pl.tc - c0;
    for (int i = warp; i < nly; i += kLevelWarps) {
      const int ly = reflect101(sy0 - kHalo + i, pl.H);
      const float* w = wts + pl.wr + ly * pl.tr;
      const float* col = src + static_cast<size_t>(first[pl.fr + ly]) * t.in_W + c0;
      TAPS_DISPATCH(pl.tr, vertical_row, (buf, w, col, t.in_W, nc, lane));
      __syncwarp();
      TAPS_DISPATCH(pl.tc, horizontal_row, (L[i], buf, wts + pl.wc, fcol, c0, sx0, pl.W, nlx, lane));
      __syncwarp();
    }
  }
  float g[7];
#pragma unroll
  for (int k = 0; k < 7; ++k) g[k] = t.gk[k];
  __syncthreads();
  // vertical blur: a run of kRun rows of one column a thread
  for (int item = threadIdx.x; item < (kTileH / kRun) * kLW; item += kLevelThreads) {
    const int rb = item / kLW, j = item - rb * kLW;
    const int r0 = rb * kRun;
    if (r0 >= nsy || j >= nlx) continue;
    float x[kRun + 6];
#pragma unroll
    for (int q = 0; q < kRun + 6; ++q) x[q] = L[r0 + q][j];
#pragma unroll
    for (int q = 0; q < kRun; ++q) {
      float acc = __fmul_rn(x[q], g[0]);
#pragma unroll
      for (int k = 1; k < 7; ++k) acc = __fadd_rn(acc, __fmul_rn(x[q + k], g[k]));
      V[r0 + q][j] = acc;
    }
  }
  __syncthreads();
  // horizontal blur: a lane a row, a run of kRun columns a warp and step
  for (int run = warp; run < kTileW / kRun; run += kLevelWarps) {
    const int x0 = run * kRun;
    if (lane >= nsy || x0 >= nsx) continue;
    float x[kRun + 6];
#pragma unroll
    for (int q = 0; q < kRun + 6; ++q) x[q] = V[lane][x0 + q];
#pragma unroll
    for (int q = 0; q < kRun; ++q) {
      float acc = __fmul_rn(x[q], g[0]);
#pragma unroll
      for (int k = 1; k < 7; ++k) acc = __fadd_rn(acc, __fmul_rn(x[q + k], g[k]));
      Bs[lane][x0 + q] = acc;
    }
  }
  __syncthreads();
  // the tile's part of the padded region: the tile, and on the plane's
  // edge the border beside it (each pixel its clamped level pixel)
  const int pad = t.pad;
  const int ry0 = sy0 == 0 ? 0 : sy0 + pad;
  const int ry1 = sy0 + nsy == pl.H ? pl.H + 2 * pad : sy0 + nsy + pad;
  const int rx0 = sx0 == 0 ? 0 : sx0 + pad;
  const int rx1 = sx0 + nsx == pl.W ? pl.W + 2 * pad : sx0 + nsx + pad;
  for (int py = ry0 + warp; py < ry1; py += kLevelWarps) {
    const int ly = clampi(py - pad, sy0, sy0 + nsy - 1) - sy0;
    const size_t o = static_cast<size_t>(pl.out_off) + static_cast<size_t>(py) * t.stride;
    for (int px = rx0 + lane; px < rx1; px += 32) {
      const int lx = clampi(px - pad, sx0, sx0 + nsx - 1) - sx0;
      img_stack[o + px] = L[ly + kHalo][lx + kHalo];
      blur_stack[o + px] = Bs[ly][lx];
    }
  }
}

// ---------------------------------------------------------------------------
// orb_select_grid
// ---------------------------------------------------------------------------

constexpr int kCell = 16;
constexpr int kCellWarps = 8;                       // cells a block of the cell pass
constexpr int kSelectThreads = 1024;
constexpr int kSelectSmem = 192 * 1024;             // dynamic shared memory of a plane's block
constexpr unsigned long long kNoKey = ~0ull;        // a slot that keeps no candidate

struct SelectPlane {
  int in_off;     // offset (floats) of the plane's pixel (0, 0) in the score stack
  int H, W;
  int cells_x;
  int n_cells;
  int m;          // candidates a cell
  int k;          // keypoints of the level
  int out_off;    // first output slot
  int lvl;
  float scale;    // scale ** lvl, rounded to float32
  int cell0;      // first cell of the plane in the cell pass's grid
  int key0;       // first key of the plane in the scratch
};

struct SelectTable {
  SelectPlane p[kMaxPlanes];
  int n;
  int stride;     // row stride of the score stack
  int cells;      // cells of all planes
  int k_max;      // the largest k
};

// (1) a warp a cell: its top m keys and pixels at the cell's own slots
__global__ void __launch_bounds__(32 * kCellWarps)
select_cells_kernel(const float* __restrict__ scores, unsigned long long* __restrict__ keys,
                    unsigned char* __restrict__ pix, const SelectTable t) {
  const int lane = threadIdx.x & 31;
  const int g = blockIdx.x * kCellWarps + (threadIdx.x >> 5);
  if (g >= t.cells) return;   // the whole warp
  int pi = 0;
  for (int i = 1; i < t.n; ++i) {
    if (g >= t.p[i].cell0) pi = i;
  }
  const SelectPlane pl = t.p[pi];
  const int cell = g - pl.cell0;
  const float* sc = scores + pl.in_off;
  const int cy = cell / pl.cells_x, cx = cell - cy * pl.cells_x;
  float v[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int q = lane + 32 * j;
    const int y = cy * kCell + (q >> 4), x = cx * kCell + (q & 15);
    v[j] = (y < pl.H && x < pl.W) ? sc[static_cast<size_t>(y) * t.stride + x] : -INFINITY;
  }
  unsigned long long* kc = keys + pl.key0 + static_cast<size_t>(cell) * pl.m;
  unsigned char* pc = pix + pl.key0 + static_cast<size_t>(cell) * pl.m;
  unsigned picked = 0;
  int slot = 0;
  for (; slot < pl.m; ++slot) {
    // the lane's largest unpicked value, ties to its lower index
    float bv = -INFINITY;
    int bq = 1 << 30;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (!(picked & (1u << j)) && (v[j] > bv || bq == (1 << 30))) {
        bv = v[j];
        bq = lane + 32 * j;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
      const int oq = __shfl_xor_sync(0xffffffffu, bq, off);
      if (ov > bv || (ov == bv && oq < bq)) {
        bv = ov;
        bq = oq;
      }
    }
    // the rest of the cell cannot be emitted once its best is not > 0
    if (!(bv > 0.0f)) break;
    if ((bq & 31) == lane) picked |= 1u << (bq >> 5);
    if (lane == 0) {
      const float rank = slot == 0 ? __fadd_rn(bv, 1e6f) : bv;
      kc[slot] = bv < INFINITY
                     ? (static_cast<unsigned long long>(~__float_as_uint(rank)) << 32)
                           | static_cast<unsigned>(cell * pl.m + slot)
                     : kNoKey;
      pc[slot] = static_cast<unsigned char>(bq);
    }
  }
  for (int s = slot + lane; s < pl.m; s += 32) kc[s] = kNoKey;
}

// (2) a block a plane: the first k keys in order
__global__ void __launch_bounds__(kSelectThreads)
select_top_kernel(const float* __restrict__ scores,
                  const unsigned long long* __restrict__ keys,
                  const unsigned char* __restrict__ pix, int* __restrict__ rows,
                  int* __restrict__ cols, float* __restrict__ out_score,
                  int* __restrict__ level, float* __restrict__ scale, const SelectTable t,
                  int cache_n) {
  extern __shared__ unsigned long long smem[];   // [k_max] selected keys, [cache_n] keys
  __shared__ int hist[2][256];
  __shared__ int s_pos, s_sel, s_digit, s_rank, s_count;
  const SelectPlane pl = t.p[blockIdx.x];
  if (pl.k == 0) return;   // the whole block
  unsigned long long* sel = smem;
  unsigned long long* cache = smem + t.k_max;
  const unsigned long long* gk = keys + pl.key0;
  const int n = pl.n_cells * pl.m;
  const int nc = min(n, cache_n);
  const int tid = threadIdx.x;
  if (tid == 0) s_pos = s_sel = 0;
  for (int i = tid; i < 512; i += kSelectThreads) hist[i >> 8][i & 255] = 0;
  __syncthreads();
  int pos = 0;
  for (int i = tid; i < n; i += kSelectThreads) {
    const unsigned long long key = gk[i];
    if (i < nc) cache[i] = key;
    pos += key != kNoKey;
  }
  pos = __reduce_add_sync(0xffffffffu, pos);
  if ((tid & 31) == 0 && pos) atomicAdd(&s_pos, pos);
  __syncthreads();
  const int k = pl.k;
  const bool all = s_pos <= k;   // every kept candidate is selected
  unsigned long long prefix = 0, mask = 0;
  if (!all) {
    // radix select of the key of rank k - 1: the bits above 32 (the rank),
    // then those of the candidate index that a key of this plane can set
    int rank = k - 1;
    const int cb = n > 1 ? 32 - __clz(n - 1) : 0;
    int par = 0;
    for (int s = 56; s >= 0; s -= 8) {
      if (s < 32 && s >= cb) continue;
      int* h = hist[par];
      if (tid < 256) hist[par ^ 1][tid] = 0;
      for (int i = tid; i < n; i += kSelectThreads) {
        const unsigned long long key = i < nc ? cache[i] : gk[i];
        if ((key & mask) == prefix) atomicAdd(&h[(key >> s) & 255], 1);
      }
      __syncthreads();
      if (tid < 32) {   // lane l scans bins 8 l .. 8 l + 7
        int c[8], sum = 0;
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          c[q] = h[8 * tid + q];
          sum += c[q];
        }
        int incl = sum;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const int u = __shfl_up_sync(0xffffffffu, incl, o);
          if (tid >= o) incl += u;
        }
        int before = incl - sum;
        if (before <= rank && rank < incl) {
#pragma unroll
          for (int q = 0; q < 8; ++q) {
            if (before <= rank && rank < before + c[q]) {
              s_digit = 8 * tid + q;
              s_rank = rank - before;
              s_count = c[q];
            }
            before += c[q];
          }
        }
      }
      __syncthreads();
      prefix |= static_cast<unsigned long long>(s_digit) << s;
      mask |= 255ull << s;
      rank = s_rank;
      par ^= 1;
      if (s_count == rank + 1) break;   // the whole group is selected
    }
  }
  for (int i = tid; i < n; i += kSelectThreads) {
    const unsigned long long key = i < nc ? cache[i] : gk[i];
    if (all ? key != kNoKey : (key & mask) <= prefix) sel[atomicAdd(&s_sel, 1)] = key;
  }
  __syncthreads();
  const int ns = s_sel;   // min(k, kept candidates); their order in sel is the schedule's
  for (int i = tid; i < ns; i += kSelectThreads) {
    const unsigned long long key = sel[i];
    int r = 0;
#pragma unroll 8
    for (int j = 0; j < ns; ++j) r += sel[j] < key;
    const int cand = static_cast<int>(key & 0xffffffffu);
    const int cell = cand / pl.m;
    const int q = pix[pl.key0 + cand];
    const int cy = cell / pl.cells_x;
    const int y = cy * kCell + (q >> 4), x = (cell - cy * pl.cells_x) * kCell + (q & 15);
    const int o = pl.out_off + r;
    rows[o] = y;
    cols[o] = x;
    out_score[o] = scores[pl.in_off + static_cast<size_t>(y) * t.stride + x];
  }
  for (int i = tid; i < k; i += kSelectThreads) {
    const int o = pl.out_off + i;
    if (i >= ns) {
      rows[o] = 0;
      cols[o] = 0;
      out_score[o] = 0.0f;
    }
    level[o] = pl.lvl;
    scale[o] = pl.scale;
  }
}

// ---------------------------------------------------------------------------
// orb_describe
// ---------------------------------------------------------------------------

constexpr int kHalfPatch = 15;
constexpr int kTapRadius = 19;                  // the pattern's clip radius
constexpr int kDescKp = 2;                      // keypoints a warp, side by side
constexpr int kDescWarps = 4;                   // 8 keypoints a block
constexpr int kSumStride = 33;                  // doubles a row of column sums

struct DescArgs {
  int n;              // keypoints
  int per_image;      // keypoints of one image
  int n_levels;
  int pad;
  int stride;         // row stride of the stacks
  int plane;          // floats a plane
  int umax[kHalfPatch + 1];
};

// kDescKp keypoints a warp, side by side: kp0 + k for k < kDescKp (past
// the last keypoint a warp repeats it and stores nothing).
__global__ void __launch_bounds__(32 * kDescWarps)
describe_kernel(const float* __restrict__ img_stack, const float* __restrict__ blur_stack,
                const int* __restrict__ rows, const int* __restrict__ cols,
                const int* __restrict__ level, const float* __restrict__ pattern,
                float* __restrict__ angle, int* __restrict__ desc, const DescArgs a) {
  constexpr int KP = kDescKp;
  __shared__ double sum_rows[kDescWarps][2 * KP][kSumStride];   // the column sums
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int kp0 = (blockIdx.x * kDescWarps + warp) * KP;
  TC2LI_LAP_START
  if (kp0 >= a.n) return;
  // the lane's pattern taps, the same for every keypoint, loaded beside the
  // indices: test j = 32 w + lane compares tap j with tap j + 256 (x at
  // [0, 512), y at [512, 1024))
  float px[8][2], py[8][2];
#pragma unroll
  for (int w = 0; w < 8; ++w)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      px[w][h] = __ldg(pattern + 32 * w + lane + 256 * h);
      py[w][h] = __ldg(pattern + 512 + 32 * w + lane + 256 * h);
    }
  long long base[KP];   // the keypoint's pixel in the stacks (a flat index)
#pragma unroll
  for (int k = 0; k < KP; ++k) {
    const int kp = min(kp0 + k, a.n - 1);
    const int plane = (kp / a.per_image) * a.n_levels + __ldg(level + kp);
    base[k] = static_cast<long long>(plane) * a.plane
              + static_cast<long long>(__ldg(rows + kp) + a.pad) * a.stride + __ldg(cols + kp) + a.pad;
  }
  TC2LI_LAP(0);
  // column sums of the two moments in float64, rows in order: lane dx <= 30
  // takes column u = dx - 15 (lane 31 repeats column 15, never read); the
  // patches' 31 KP loads a lane all in flight first. p u and p v are exact in
  // float64 (24 + 4 bits), so the fma rounds once where the plain
  // version's add does.
  const int u = min(lane, 2 * kHalfPatch) - kHalfPatch;
  float p[KP][2 * kHalfPatch + 1];
#pragma unroll
  for (int k = 0; k < KP; ++k)
#pragma unroll
    for (int dy = 0; dy <= 2 * kHalfPatch; ++dy)
      p[k][dy] = __ldg(img_stack + base[k] + static_cast<long long>(dy - kHalfPatch) * a.stride + u);
  double s10[KP], s01[KP];
#pragma unroll
  for (int k = 0; k < KP; ++k) s10[k] = s01[k] = 0.0;
#pragma unroll
  for (int dy = 0; dy <= 2 * kHalfPatch; ++dy) {
    const int v = dy - kHalfPatch;
    const bool in = abs(u) <= a.umax[v < 0 ? -v : v];
    const double wu = in ? static_cast<double>(u) : 0.0, wv = in ? static_cast<double>(v) : 0.0;
#pragma unroll
    for (int k = 0; k < KP; ++k) {
      const double q = static_cast<double>(p[k][dy]);
      s10[k] = __fma_rn(q, wu, s10[k]);
      s01[k] = __fma_rn(q, wv, s01[k]);
    }
  }
  TC2LI_LAP(1);
  // the columns added in order: lane 2 k the m10 of keypoint k, lane 2 k + 1
  // its m01, each from the warp's row of column sums in shared memory
#pragma unroll
  for (int k = 0; k < KP; ++k) {
    sum_rows[warp][2 * k][lane] = s10[k];
    sum_rows[warp][2 * k + 1][lane] = s01[k];
  }
  __syncwarp();
  const double* srow = sum_rows[warp][min(lane, 2 * KP - 1)];
  double m = 0.0;
#pragma unroll
  for (int dx = 0; dx <= 2 * kHalfPatch; ++dx) m = __dadd_rn(m, srow[dx]);
  TC2LI_LAP(2);
  // lane k < KP: keypoint k's angle, its cosine and sine
  const int kq = min(lane, KP - 1);
  const double m10 = __shfl_sync(0xffffffffu, m, 2 * kq), m01 = __shfl_sync(0xffffffffu, m, 2 * kq + 1);
  const float ang = atan2f(static_cast<float>(m01), static_cast<float>(m10));
  if (lane < KP && kp0 + lane < a.n) angle[kp0 + lane] = ang;
  const float ca_l = cosf(ang), sb_l = sinf(ang);
  TC2LI_LAP(3);
  // the taps: a lane's 16 KP blurred pixels all loaded before any compare
  const float R = static_cast<float>(kTapRadius);
  float tap[KP][8][2];
#pragma unroll
  for (int k = 0; k < KP; ++k) {
    const float ca = __shfl_sync(0xffffffffu, ca_l, k), sb = __shfl_sync(0xffffffffu, sb_l, k);
#pragma unroll
    for (int w = 0; w < 8; ++w)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float x = px[w][h], y = py[w][h];
        const int ro = static_cast<int>(fminf(fmaxf(rintf(__fadd_rn(__fmul_rn(x, sb), __fmul_rn(y, ca))), -R), R));
        const int co = static_cast<int>(fminf(fmaxf(rintf(__fsub_rn(__fmul_rn(x, ca), __fmul_rn(y, sb))), -R), R));
        tap[k][w][h] = __ldg(blur_stack + base[k] + static_cast<long long>(ro) * a.stride + co);
      }
  }
  // a ballot a word; lane 8 k + w keeps word w of keypoint k and stores it
  int word = 0;
#pragma unroll
  for (int k = 0; k < KP; ++k)
#pragma unroll
    for (int w = 0; w < 8; ++w) {
      const unsigned b = __ballot_sync(0xffffffffu, rintf(tap[k][w][0]) < rintf(tap[k][w][1]));
      if (lane == 8 * k + w) word = static_cast<int>(b);
    }
  if (lane < 8 * KP && kp0 + (lane >> 3) < a.n) desc[static_cast<long long>(kp0) * 8 + lane] = word;
  TC2LI_LAP(4);
}

}  // namespace

// Pyramid and blur planes. img: float32 [B, in_H, in_W]; img_stack,
// blur_stack: float32 stacks with row stride `stride`; first, wts: the
// resize tap tables on the device; planes: host array of n x 13 ints (the
// fields of LevelPlane in order; tiles of kTileH x kTileW level pixels,
// each resized tile's columns reading at most kMaxSpan image columns: the
// wrapper checks); gk: 7 floats. Returns cudaGetLastError(), or
// cudaErrorInvalidValue for a table the kernel does not take.
extern "C" int tc2li_orb_level_planes(const float* img, float* img_stack, float* blur_stack,
                                      const int* first, const float* wts, const int* planes,
                                      int n, int pad, int in_H, int in_W, int stride,
                                      const float* gk, void* stream) {
  if (n < 1 || n > kMaxPlanes || pad < 0) return static_cast<int>(cudaErrorInvalidValue);
  LevelTable t;
  int tiles = 0;
  for (int i = 0; i < n; ++i) {
    const int* r = planes + 13 * i;
    LevelPlane& p = t.p[i];
    p = LevelPlane{r[0], r[1], r[2], r[3], r[4], r[5], r[6], r[7], r[8], r[9], r[10], r[11], r[12]};
    if (p.H < 4 || p.W < 4 || p.tr < 1 || p.tc < 1 || p.tr > kMaxTaps || p.tc > kMaxTaps ||
        p.tile0 != tiles ||
        p.tiles_x != (p.W + kTileW - 1) / kTileW) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    tiles += p.tiles_x * ((p.H + kTileH - 1) / kTileH);
  }
  t.n = n;
  t.pad = pad;
  t.in_H = in_H;
  t.in_W = in_W;
  t.stride = stride;
  for (int k = 0; k < 7; ++k) t.gk[k] = gk[k];
  level_planes_kernel<<<tiles, kLevelThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      img, img_stack, blur_stack, first, wts, t);
  return static_cast<int>(cudaGetLastError());
}

// Grid top-k of every plane, in two launches. scores: float32 stack with
// row stride `stride`; planes: host array of n x 12 values (the fields of
// SelectPlane in order, the scale as its float32 bits); keys, pix: scratch
// of 8 and 1 bytes for each of the planes' candidates (sum of n_cells x m);
// outputs of the total slot count. The largest k a plane must fit the
// shared memory of its block with room to spare (k at most kSelectSmem / 16).
extern "C" int tc2li_orb_select_grid(const float* scores, void* keys, void* pix, int* rows,
                                     int* cols, float* out_score, int* level, float* scale,
                                     const int* planes, int n, int stride, void* stream) {
  if (n < 1 || n > kMaxPlanes) return static_cast<int>(cudaErrorInvalidValue);
  SelectTable t;
  int cells = 0, n_keys = 0, n_max = 0, k_max = 0;
  for (int i = 0; i < n; ++i) {
    const int* r = planes + 12 * i;
    SelectPlane& p = t.p[i];
    p.in_off = r[0];
    p.H = r[1];
    p.W = r[2];
    p.cells_x = r[3];
    p.n_cells = r[4];
    p.m = r[5];
    p.k = r[6];
    p.out_off = r[7];
    p.lvl = r[8];
    const unsigned bits = static_cast<unsigned>(r[9]);
    float s;
    static_assert(sizeof(s) == sizeof(bits), "float32 bits");
    __builtin_memcpy(&s, &bits, sizeof(s));
    p.scale = s;
    p.cell0 = r[10];
    p.key0 = r[11];
    if (p.m < 1 || p.m > kCell * kCell || p.k < 0 || p.n_cells < 1 || p.cell0 != cells ||
        p.key0 != n_keys || 8LL * p.k > kSelectSmem / 2) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    cells += p.n_cells;
    n_keys += p.n_cells * p.m;
    n_max = p.n_cells * p.m > n_max ? p.n_cells * p.m : n_max;
    k_max = p.k > k_max ? p.k : k_max;
  }
  t.n = n;
  t.stride = stride;
  t.cells = cells;
  t.k_max = k_max;
  const int room = kSelectSmem / 8 - k_max;
  const int cache_n = n_max < room ? n_max : room;
  const int smem = 8 * (k_max + cache_n);
  int rc = static_cast<int>(cudaFuncSetAttribute(
      select_top_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
  if (rc != 0) return rc;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* kp = static_cast<unsigned long long*>(keys);
  auto* pp = static_cast<unsigned char*>(pix);
  select_cells_kernel<<<(cells + kCellWarps - 1) / kCellWarps, 32 * kCellWarps, 0, st>>>(
      scores, kp, pp, t);
  if ((rc = static_cast<int>(cudaGetLastError())) != 0) return rc;
  select_top_kernel<<<n, kSelectThreads, smem, st>>>(scores, kp, pp, rows, cols, out_score,
                                                     level, scale, t, cache_n);
  return static_cast<int>(cudaGetLastError());
}

// Orientation and rBRIEF of n keypoints (per_image of each image in turn).
// pattern: float32 [2, 512] (x of the 512 taps, then y), clipped to
// kTapRadius = radius; umax: 16 ints.
extern "C" int tc2li_orb_describe(const float* img_stack, const float* blur_stack,
                                  const int* rows, const int* cols, const int* level,
                                  const float* pattern, float* angle, int* desc, int n,
                                  int per_image, int n_levels, int pad, int stride,
                                  int plane, int radius, const int* umax, void* stream) {
  if (n < 1 || per_image < 1 || n_levels < 1 || pad < kHalfPatch || pad < radius ||
      radius != kTapRadius) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  DescArgs a;
  a.n = n;
  a.per_image = per_image;
  a.n_levels = n_levels;
  a.pad = pad;
  a.stride = stride;
  a.plane = plane;
  for (int i = 0; i <= kHalfPatch; ++i) a.umax[i] = umax[i];
  constexpr int per_block = kDescWarps * kDescKp;
  describe_kernel<<<(n + per_block - 1) / per_block, 32 * kDescWarps, 0,
                    static_cast<cudaStream_t>(stream)>>>(img_stack, blur_stack, rows, cols, level,
                                                         pattern, angle, desc, a);
  return static_cast<int>(cudaGetLastError());
}
