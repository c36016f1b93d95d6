// ORB after FAST: the pyramid and blur planes, the grid top-k and
// orientation with rBRIEF, each in one launch for every plane or every
// keypoint of one or two images.
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
// for two 1241x376 images, ~8.3 us at 3.35 TB/s; 0.095 ms on an NVIDIA H100
// 80GB HBM3 at 700 W, chip_smoke.py, with the halo recomputation and the
// level-7 taps). The grid is the flat list of 32x32 tiles of every plane's
// padded region; a tile maps, by edge
// clamping, onto at most 32x32 level pixels, and the block computes those
// (and a 3-pixel halo for the blur) from the image in shared memory: the
// row pass of the resize (only the nonzero taps of each output row, from a
// precomputed table), then the column pass, the vertical and the horizontal
// 7-tap REFLECT_101 blur. Each tile recomputes its halo, so no pass waits
// for another block and nothing but the two stacks is written. What lies
// outside each plane's padded region is not written (no reader looks there).
//
// orb_select_grid. Bound: bytes (the 16 score planes, ~3.5 us), but one
// block a plane runs level 0 alone on one SM (0.146 ms a stereo pair on the
// same card). A warp takes a 16x16
// cell at a time and picks its top m_cand by rounds of warp arg-max (ties to
// the lower in-cell index); the positive candidates are keyed (rank
// descending, candidate index ascending) and bitonic-sorted in shared
// memory (at most 4,096: KITTI's level 0 has 1,872 cells of 2); the first k
// are written. Only comparisons and the one float add of the slot-0 boost.
//
// orb_describe. Bound: bytes (4,000 keypoints a stereo pair, 1,473 reads
// each, ~7 us; 0.012 ms on the same card). A warp a keypoint: lane dx sums
// its patch column of both moments in float64 (every product of two
// floats is exact there), the columns are
// added in order, the moments rounded to float32 before atan2f; then each
// lane takes 8 of the 256 tests (rintf, half to even, as torch.round) and a
// ballot packs each word.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxPlanes = 32;
constexpr int kTile = 32;
constexpr int kHalo = 3;                    // blur radius
constexpr int kSrc = kTile + 2 * kHalo;     // level pixels a tile side needs
constexpr int kMaxSpan = 192;               // image columns a tile's resize reads
constexpr int kMaxTaps = 16;
constexpr int kLevelThreads = 256;

// ---------------------------------------------------------------------------
// orb_level_planes
// ---------------------------------------------------------------------------

struct LevelPlane {
  int img;        // image of the plane
  int H, W;       // level shape
  int resize;     // 0: the level is the image itself
  int fr, wr;     // row table: first tap index at first[fr + y], weights at w[wr + y * tr]
  int fc, wc;     // column table, likewise
  int tr, tc;     // taps per output row / column
  int out_off;    // offset (floats) of the plane's padded pixel (0, 0) in the stacks
  int tile0;      // first tile of the plane in the flat grid
  int tiles_x;    // tiles per row of the padded region
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

__global__ void __launch_bounds__(kLevelThreads)
level_planes_kernel(const float* __restrict__ img, float* __restrict__ img_stack,
                    float* __restrict__ blur_stack, const int* __restrict__ first,
                    const float* __restrict__ wts, const LevelTable t) {
  __shared__ float tmp[kSrc][kMaxSpan + 1];   // row pass of the resize
  __shared__ float L[kSrc][kSrc + 1];         // level pixels with the blur halo
  __shared__ float V[kTile][kSrc + 1];        // vertical blur
  __shared__ float B[kTile][kTile + 1];       // both blurs

  int pi = 0;
  for (int i = 1; i < t.n; ++i) {
    if (static_cast<int>(blockIdx.x) >= t.p[i].tile0) pi = i;
  }
  const LevelPlane pl = t.p[pi];
  const int local = blockIdx.x - pl.tile0;
  const int ty0 = (local / pl.tiles_x) * kTile;
  const int tx0 = (local % pl.tiles_x) * kTile;
  const int Hp = pl.H + 2 * t.pad, Wp = pl.W + 2 * t.pad;
  // level pixels of the tile (edge clamping) and of its blur halo
  const int sy0 = clampi(ty0 - t.pad, 0, pl.H - 1);
  const int sy1 = clampi(min(ty0 + kTile, Hp) - 1 - t.pad, 0, pl.H - 1);
  const int sx0 = clampi(tx0 - t.pad, 0, pl.W - 1);
  const int sx1 = clampi(min(tx0 + kTile, Wp) - 1 - t.pad, 0, pl.W - 1);
  const int ly0 = max(0, sy0 - kHalo), ly1 = min(pl.H - 1, sy1 + kHalo);
  const int lx0 = max(0, sx0 - kHalo), lx1 = min(pl.W - 1, sx1 + kHalo);
  const int nly = ly1 - ly0 + 1, nlx = lx1 - lx0 + 1;
  const int tid = threadIdx.x;
  const float* src = img + static_cast<size_t>(pl.img) * t.in_H * t.in_W;

  if (!pl.resize) {
    for (int i = tid; i < nly * nlx; i += kLevelThreads) {
      const int y = i / nlx, x = i - (i / nlx) * nlx;
      L[y][x] = src[static_cast<size_t>(ly0 + y) * t.in_W + lx0 + x];
    }
  } else {
    // row pass over the image columns the tile's output columns read
    const int c0 = first[pl.fc + lx0];
    const int nc = first[pl.fc + lx1] + pl.tc - c0;
    for (int i = tid; i < nly * nc; i += kLevelThreads) {
      const int y = i / nc, c = i - (i / nc) * nc;
      const int r0 = first[pl.fr + ly0 + y];
      const float* w = wts + pl.wr + (ly0 + y) * pl.tr;
      const float* col = src + static_cast<size_t>(r0) * t.in_W + c0 + c;
      float acc = __fmul_rn(w[0], col[0]);
      for (int k = 1; k < pl.tr; ++k) {
        acc = __fadd_rn(acc, __fmul_rn(w[k], col[static_cast<size_t>(k) * t.in_W]));
      }
      tmp[y][c] = acc;
    }
    __syncthreads();
    for (int i = tid; i < nly * nlx; i += kLevelThreads) {
      const int y = i / nlx, x = i - (i / nlx) * nlx;
      const int j0 = first[pl.fc + lx0 + x] - c0;
      const float* w = wts + pl.wc + (lx0 + x) * pl.tc;
      float acc = __fmul_rn(w[0], tmp[y][j0]);
      for (int k = 1; k < pl.tc; ++k) acc = __fadd_rn(acc, __fmul_rn(w[k], tmp[y][j0 + k]));
      L[y][x] = acc;
    }
  }
  __syncthreads();
  // vertical blur of the tile's rows over the halo's columns
  const int nsy = sy1 - sy0 + 1, nsx = sx1 - sx0 + 1;
  for (int i = tid; i < nsy * nlx; i += kLevelThreads) {
    const int y = i / nlx, x = i - (i / nlx) * nlx;
    const int ly = sy0 + y;
    float acc = __fmul_rn(L[reflect101(ly - 3, pl.H) - ly0][x], t.gk[0]);
    for (int k = 1; k < 7; ++k) {
      acc = __fadd_rn(acc, __fmul_rn(L[reflect101(ly - 3 + k, pl.H) - ly0][x], t.gk[k]));
    }
    V[y][x] = acc;
  }
  __syncthreads();
  for (int i = tid; i < nsy * nsx; i += kLevelThreads) {
    const int y = i / nsx, x = i - (i / nsx) * nsx;
    const int lx = sx0 + x;
    float acc = __fmul_rn(V[y][reflect101(lx - 3, pl.W) - lx0], t.gk[0]);
    for (int k = 1; k < 7; ++k) {
      acc = __fadd_rn(acc, __fmul_rn(V[y][reflect101(lx - 3 + k, pl.W) - lx0], t.gk[k]));
    }
    B[y][x] = acc;
  }
  __syncthreads();
  // the tile of the padded region, each pixel its clamped level pixel
  const int ny = min(kTile, Hp - ty0), nx = min(kTile, Wp - tx0);
  for (int i = tid; i < ny * nx; i += kLevelThreads) {
    const int y = i / nx, x = i - (i / nx) * nx;
    const int sy = clampi(ty0 + y - t.pad, 0, pl.H - 1);
    const int sx = clampi(tx0 + x - t.pad, 0, pl.W - 1);
    const size_t o = static_cast<size_t>(pl.out_off) + static_cast<size_t>(ty0 + y) * t.stride
                     + tx0 + x;
    img_stack[o] = L[sy - ly0][sx - lx0];
    blur_stack[o] = B[sy - sy0][sx - sx0];
  }
}

// ---------------------------------------------------------------------------
// orb_select_grid
// ---------------------------------------------------------------------------

constexpr int kCell = 16;
constexpr int kMaxCand = 4096;
constexpr int kSelectThreads = 1024;

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
};

struct SelectTable {
  SelectPlane p[kMaxPlanes];
  int n;
  int stride;     // row stride of the score stack
};

__global__ void __launch_bounds__(kSelectThreads)
select_grid_kernel(const float* __restrict__ scores, int* __restrict__ rows,
                   int* __restrict__ cols, float* __restrict__ out_score,
                   int* __restrict__ level, float* __restrict__ scale, const SelectTable t) {
  __shared__ unsigned long long key[kMaxCand];
  __shared__ unsigned char pix[kMaxCand];
  __shared__ int n_pos;
  const SelectPlane pl = t.p[blockIdx.x];
  const float* sc = scores + pl.in_off;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) n_pos = 0;
  __syncthreads();

  for (int cell = warp; cell < pl.n_cells; cell += kSelectThreads / 32) {
    const int cy = cell / pl.cells_x, cx = cell - (cell / pl.cells_x) * pl.cells_x;
    float v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int q = lane + 32 * j;
      const int y = cy * kCell + (q >> 4), x = cx * kCell + (q & 15);
      v[j] = (y < pl.H && x < pl.W) ? sc[static_cast<size_t>(y) * t.stride + x] : -INFINITY;
    }
    unsigned picked = 0;
    for (int slot = 0; slot < pl.m; ++slot) {
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
      if (lane == 0 && bv < INFINITY) {
        const int cand = cell * pl.m + slot;
        const float rank = slot == 0 ? __fadd_rn(bv, 1e6f) : bv;
        const int at = atomicAdd(&n_pos, 1);
        key[at] = (static_cast<unsigned long long>(~__float_as_uint(rank)) << 32)
                  | static_cast<unsigned>(cand);
        pix[cand] = static_cast<unsigned char>(bq);
      }
    }
  }
  __syncthreads();
  const int n = n_pos;
  int size = 1;
  while (size < n) size <<= 1;
  for (int i = n + threadIdx.x; i < size; i += kSelectThreads) key[i] = ~0ull;
  __syncthreads();
  // bitonic sort, ascending: rank descending, then candidate index ascending
  for (int k = 2; k <= size; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < size; i += kSelectThreads) {
        const int ixj = i ^ j;
        if (ixj > i) {
          const unsigned long long a = key[i], b = key[ixj];
          const bool up = (i & k) == 0;
          if ((a > b) == up) {
            key[i] = b;
            key[ixj] = a;
          }
        }
      }
      __syncthreads();
    }
  }
  for (int i = threadIdx.x; i < pl.k; i += kSelectThreads) {
    int r = 0, c = 0;
    float s = 0.0f;
    if (i < n) {
      const int cand = static_cast<int>(key[i] & 0xffffffffu);
      const int cell = cand / pl.m;
      const int q = pix[cand];
      r = (cell / pl.cells_x) * kCell + (q >> 4);
      c = (cell - (cell / pl.cells_x) * pl.cells_x) * kCell + (q & 15);
      s = sc[static_cast<size_t>(r) * t.stride + c];
    }
    const int o = pl.out_off + i;
    rows[o] = r;
    cols[o] = c;
    out_score[o] = s;
    level[o] = pl.lvl;
    scale[o] = pl.scale;
  }
}

// ---------------------------------------------------------------------------
// orb_describe
// ---------------------------------------------------------------------------

constexpr int kHalfPatch = 15;
constexpr int kDescWarps = 8;

struct DescArgs {
  int n;              // keypoints
  int per_image;      // keypoints of one image
  int n_levels;
  int pad;
  int stride;         // row stride of the stacks
  int plane;          // floats a plane
  int radius;         // pattern radius
  int umax[kHalfPatch + 1];
};

__global__ void __launch_bounds__(32 * kDescWarps)
describe_kernel(const float* __restrict__ img_stack, const float* __restrict__ blur_stack,
                const int* __restrict__ rows, const int* __restrict__ cols,
                const int* __restrict__ level, const float* __restrict__ pattern,
                float* __restrict__ angle, int* __restrict__ desc, const DescArgs a) {
  const int lane = threadIdx.x & 31;
  const int kp = blockIdx.x * kDescWarps + (threadIdx.x >> 5);
  if (kp >= a.n) return;
  const int plane = (kp / a.per_image) * a.n_levels + level[kp];
  const int r = rows[kp] + a.pad, c = cols[kp] + a.pad;
  // column sums of the two moments, in float64, rows in order
  double s10 = 0.0, s01 = 0.0;
  if (lane <= 2 * kHalfPatch) {
    const int u = lane - kHalfPatch;
    const float* base = img_stack + static_cast<size_t>(plane) * a.plane
                        + static_cast<size_t>(r - kHalfPatch) * a.stride + c + u;
    for (int dy = 0; dy <= 2 * kHalfPatch; ++dy) {
      const int v = dy - kHalfPatch;
      const bool in = abs(u) <= a.umax[abs(v)];
      const double p = static_cast<double>(base[static_cast<size_t>(dy) * a.stride]);
      s10 = __dadd_rn(s10, __dmul_rn(p, in ? static_cast<double>(u) : 0.0));
      s01 = __dadd_rn(s01, __dmul_rn(p, in ? static_cast<double>(v) : 0.0));
    }
  }
  double m10 = 0.0, m01 = 0.0;
  for (int dx = 0; dx <= 2 * kHalfPatch; ++dx) {
    m10 = __dadd_rn(m10, __shfl_sync(0xffffffffu, s10, dx));
    m01 = __dadd_rn(m01, __shfl_sync(0xffffffffu, s01, dx));
  }
  const float ang = atan2f(static_cast<float>(m01), static_cast<float>(m10));
  if (lane == 0) angle[kp] = ang;
  const float ca = cosf(ang), sb = sinf(ang);
  const float R = static_cast<float>(a.radius);
  const float* blur = blur_stack + static_cast<size_t>(plane) * a.plane;
  for (int w = 0; w < 8; ++w) {
    const int j = 32 * w + lane;
    float tap[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float px = pattern[j + 256 * h], py = pattern[512 + j + 256 * h];
      const float ro = fminf(fmaxf(rintf(__fadd_rn(__fmul_rn(px, sb), __fmul_rn(py, ca))), -R), R);
      const float co = fminf(fmaxf(rintf(__fsub_rn(__fmul_rn(px, ca), __fmul_rn(py, sb))), -R), R);
      tap[h] = rintf(blur[static_cast<size_t>(r + static_cast<int>(ro)) * a.stride
                          + c + static_cast<int>(co)]);
    }
    const unsigned word = __ballot_sync(0xffffffffu, tap[0] < tap[1]);
    if (lane == 0) desc[kp * 8 + w] = static_cast<int>(word);
  }
}

}  // namespace

// Pyramid and blur planes. img: float32 [B, in_H, in_W]; img_stack,
// blur_stack: float32 stacks with row stride `stride`; first, wts: the
// resize tap tables on the device; planes: host array of n x 13 ints (the
// fields of LevelPlane in order); gk: 7 floats. Returns cudaGetLastError(),
// or cudaErrorInvalidValue for a table the kernel does not take.
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
        p.tile0 != tiles) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    tiles += p.tiles_x * ((p.H + 2 * pad + kTile - 1) / kTile);
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

// Grid top-k of every plane. scores: float32 stack with row stride
// `stride`; planes: host array of n x 10 values (the fields of SelectPlane
// in order, the last the float32 bits of the scale); outputs of the total
// slot count. One block a plane.
extern "C" int tc2li_orb_select_grid(const float* scores, int* rows, int* cols,
                                     float* out_score, int* level, float* scale,
                                     const int* planes, int n, int stride, void* stream) {
  if (n < 1 || n > kMaxPlanes) return static_cast<int>(cudaErrorInvalidValue);
  SelectTable t;
  for (int i = 0; i < n; ++i) {
    const int* r = planes + 10 * i;
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
    if (p.m < 1 || p.m > 8 * 32 || static_cast<long long>(p.n_cells) * p.m > kMaxCand ||
        p.k < 0) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  t.n = n;
  t.stride = stride;
  select_grid_kernel<<<n, kSelectThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      scores, rows, cols, out_score, level, scale, t);
  return static_cast<int>(cudaGetLastError());
}

// Orientation and rBRIEF of n keypoints (per_image of each image in turn).
// pattern: float32 [2, 512] (x of the 512 taps, then y); umax: 16 ints.
extern "C" int tc2li_orb_describe(const float* img_stack, const float* blur_stack,
                                  const int* rows, const int* cols, const int* level,
                                  const float* pattern, float* angle, int* desc, int n,
                                  int per_image, int n_levels, int pad, int stride,
                                  int plane, int radius, const int* umax, void* stream) {
  if (n < 1 || per_image < 1 || n_levels < 1 || pad < kHalfPatch || pad < radius) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  DescArgs a;
  a.n = n;
  a.per_image = per_image;
  a.n_levels = n_levels;
  a.pad = pad;
  a.stride = stride;
  a.plane = plane;
  a.radius = radius;
  for (int i = 0; i <= kHalfPatch; ++i) a.umax[i] = umax[i];
  const int blocks = (n + kDescWarps - 1) / kDescWarps;
  describe_kernel<<<blocks, 32 * kDescWarps, 0, static_cast<cudaStream_t>(stream)>>>(
      img_stack, blur_stack, rows, cols, level, pattern, angle, desc, a);
  return static_cast<int>(cudaGetLastError());
}
