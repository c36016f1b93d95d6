// FAST-9/16 corner detection over a stack of image planes, in two launches.
//
// Replaces the Pallas kernel tc2li_slam_tpu/ops/kernels/fast.py
// (fast_score_pallas / _fast_kernel) and the XLA-fused body of
// tc2li_slam_tpu/ops/orb.py:detect_level around it: two threshold gates on
// one segment-test score, the 35-px cell fallback, 3x3 non-maximum
// suppression and the 16-px detection margin.
//
// Bound on the H100: operations, not bytes. The 8 pyramid levels of one
// 1241x376 image are 1.44 M pixels: one float read and one written each is
// 11.6 MB (3.4 us at 3.35 TB/s), while the segment test is ~175 float
// min/max/sub per pixel (~7.5 us at the card's float32 rate if every pixel
// paid it; min and max issue at half that rate on this card). What kept the
// earlier per-level kernel at 5-9% of that was not the arithmetic but 8
// launches per image, small grids on the upper levels and ~20 eager passes
// per level around it. The design here:
//
// - One launch covers every plane (all levels of one or two images). The
//   planes arrive as a small by-value table (offset, size, first tile), and
//   the grid is the flat list of 32x32 tiles of all planes (256 threads, 4
//   rows each), so the small upper levels ride along with level 0.
// - The segment test uses running minima by doubling: runs of 2, 4, 8, then
//   9 (4 steps of 16 min instead of 8), and the darker polarity is
//   -min over starts of max over the run of the same differences, which is
//   exact.
// - With the gate on, most pixels never pay it: every 9-run holds two
//   adjacent compass points of the circle, so four differences bound the
//   score, and a pixel whose bound is not above the gate stores 0 (the same
//   value the whole test would store). A warp would still pay for its one
//   surviving lane, so a block first collects its survivors in shared
//   memory (ballot + prefix count, row order kept) and then runs the whole
//   test on the list with every lane busy.
// - Interior pixels (3 <= y < H - 3) read only inside their own plane, so
//   the 16 taps are plain cached loads with no halo and no bounds test.
// - Pass 1 (fast_score_planes) stores the score gated at
//   min(ini_th, min_th) and raises one flag per cell that holds a pixel
//   above ini_th. Pass 2 (fast_nms_planes) picks the threshold per pixel by
//   its cell's flag, suppresses non-maxima over the 3x3 neighbourhood (only
//   a surviving pixel looks at its neighbours) and applies the margin. Cell
//   indices are a multiply and a shift, not a division.
// - Pass 2 is a stencil bound by bytes: pass 1's scores read once and the
//   map written once, 8 bytes a pixel (both images' 16 KITTI planes: 23 MB,
//   6.9 us at 3.35 TB/s). Its blocks take 120 x 32 pixel tiles (~800 for
//   both images, against ~2,800 32 x 32 tiles) and find their plane by a
//   binary search of the table, which stays in the parameter space
//   (__grid_constant__). A warp stages a row of the tile with its one-pixel
//   halo, a lane an aligned 16-byte chunk of the flat stack: a plane row
//   starts anywhere modulo 4 floats (1,241 px rows), so a row is staged
//   from its first aligned chunk with its offset kept, its partial end
//   chunks read by 4-byte loads. Each thread issues its five rows' loads
//   before it uses any; the block loads the tile's cell flags, thresholds
//   each staged pixel once by its cell's flag into shared memory, and the
//   suppression reads shared memory only. Each output row is stored as
//   aligned 16-byte chunks with 4-byte stores at its two partial ends.
//
// Every operation is a subtraction, a comparison or a min/max, so the
// result is bit-equal to the plain PyTorch version.

#include <cuda_runtime.h>
#include <math.h>

#ifdef TC2LI_LAPS   // clock laps of a phase split (laps.cuh, tools/orb_kernels.py)
#define TC2LI_LAP_TAG fast
#include "laps.cuh"
#else
#define TC2LI_LAP_START
#define TC2LI_LAP(k)
#endif

namespace {

constexpr int kBX = 32;             // threads per block: 32 x 8
constexpr int kBY = 8;
constexpr int kTile = 32;           // pixels per tile: 32 x 32, 4 rows a thread
constexpr int kRowsPerThread = kTile / kBY;
constexpr int kR = 3;
constexpr int kMaxPlanes = 32;
constexpr int kMaxDim = 65535;      // plane sides and cell, for cell_of()

// One image plane inside the input and output stacks. Offsets are in
// floats from the base pointers, to the plane's pixel (0, 0).
struct Plane {
  int in_off;
  int out_off;
  int H;
  int W;
  int cell_off;   // first cell flag of the plane
  int cells_x;    // cells per cell row
  int tile0;      // first tile of the plane in the flat grid
  int tiles_x;    // tiles per tile row
};

struct PlaneTable {
  Plane p[kMaxPlanes];
  int n;
};

// The block's plane and the origin of its tile in it.
struct Tile {
  Plane pl;
  int x0;
  int y0;
};

__device__ __forceinline__ Tile locate(const PlaneTable& t) {
  const int tile = blockIdx.x;
  int pi = 0;
  for (int i = 1; i < t.n; ++i) {
    if (tile >= t.p[i].tile0) pi = i;
  }
  Tile tl;
  tl.pl = t.p[pi];
  const int local = tile - tl.pl.tile0;
  const int ty = local / tl.pl.tiles_x;
  tl.x0 = (local - ty * tl.pl.tiles_x) * kTile;
  tl.y0 = ty * kTile;
  return tl;
}

// floor(v / cell) as a multiply and a shift: magic = ceil(2^32 / cell),
// exact for v, cell <= kMaxDim.
__device__ __forceinline__ int cell_of(int v, unsigned long long magic) {
  return static_cast<int>((static_cast<unsigned long long>(v) * magic) >> 32);
}

__device__ __forceinline__ int flag_index(const Plane& pl, int y, int x,
                                          unsigned long long magic) {
  return pl.cell_off + cell_of(y, magic) * pl.cells_x + cell_of(x, magic);
}

__device__ __forceinline__ float max4(float a, float b, float c, float d) {
  return fmaxf(fmaxf(a, b), fmaxf(c, d));
}

// Upper bound of the segment-test score from the four compass points of
// the circle: every 9-run holds two adjacent ones.
__device__ __forceinline__ float compass_bound(const float* __restrict__ c, int s) {
  const float v = c[0];
  const float n = c[-3 * s] - v, e = c[3] - v, so = c[3 * s] - v, w = c[-3] - v;
  const float up = max4(fminf(n, e), fminf(e, so), fminf(so, w), fminf(w, n));
  const float dn = -fminf(fminf(fmaxf(n, e), fmaxf(e, so)), fminf(fmaxf(so, w), fmaxf(w, n)));
  return fmaxf(up, dn);
}

// Segment-test score of the pixel at `c` (row stride `s`): the max over the
// 16 circular 9-runs of the min signed difference, brighter or darker.
__device__ __forceinline__ float segment_score(const float* __restrict__ c, int s) {
  const float v = c[0];
  float d[16];
  d[0] = c[-3 * s] - v;
  d[1] = c[-3 * s + 1] - v;
  d[2] = c[-2 * s + 2] - v;
  d[3] = c[-s + 3] - v;
  d[4] = c[3] - v;
  d[5] = c[s + 3] - v;
  d[6] = c[2 * s + 2] - v;
  d[7] = c[3 * s + 1] - v;
  d[8] = c[3 * s] - v;
  d[9] = c[3 * s - 1] - v;
  d[10] = c[2 * s - 2] - v;
  d[11] = c[s - 3] - v;
  d[12] = c[-3] - v;
  d[13] = c[-s - 3] - v;
  d[14] = c[-2 * s - 2] - v;
  d[15] = c[-3 * s - 1] - v;

  float lo2[16], hi2[16], lo4[16], hi4[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    lo2[i] = fminf(d[i], d[(i + 1) & 15]);
    hi2[i] = fmaxf(d[i], d[(i + 1) & 15]);
  }
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    lo4[i] = fminf(lo2[i], lo2[(i + 2) & 15]);
    hi4[i] = fmaxf(hi2[i], hi2[(i + 2) & 15]);
  }
  float brighter = -INFINITY;   // max over starts of min over the run
  float darker = INFINITY;      // min over starts of max over the run
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const float lo9 = fminf(fminf(lo4[i], lo4[(i + 4) & 15]), d[(i + 8) & 15]);
    const float hi9 = fmaxf(fmaxf(hi4[i], hi4[(i + 4) & 15]), d[(i + 8) & 15]);
    brighter = fmaxf(brighter, lo9);
    darker = fminf(darker, hi9);
  }
  return fmaxf(brighter, -darker);
}

// Pass 1, gated: out = score > gate ? score : 0, and flags[cell] |= score >
// ini_th; the 3-px ring of every plane is 0. Step 1 runs the compass test
// on the tile's pixels and collects those it cannot reject, row by row, in
// shared memory; step 2 runs the whole segment test on the collected pixels
// with all lanes busy.
__global__ void __launch_bounds__(kBX * kBY)
fast_score_gated_kernel(const float* __restrict__ in, float* __restrict__ out,
                        int* __restrict__ flags, const PlaneTable t, int in_stride,
                        int out_stride, float gate, float ini_th,
                        unsigned long long magic) {
  __shared__ unsigned short cand[kTile * kTile];
  __shared__ int n_cand;
  const Tile tl = locate(t);
  const Plane& pl = tl.pl;
  if (threadIdx.x == 0 && threadIdx.y == 0) n_cand = 0;
  __syncthreads();
  const float* base = in + pl.in_off;
  float* obase = out + pl.out_off;
  const int x = tl.x0 + threadIdx.x;
#pragma unroll
  for (int k = 0; k < kRowsPerThread; ++k) {
    const int ly = threadIdx.y + k * kBY;
    const int y = tl.y0 + ly;
    const bool inside = x < pl.W && y < pl.H;
    bool keep = false;
    if (inside && y >= kR && y < pl.H - kR && x >= kR && x < pl.W - kR) {
      keep = compass_bound(base + (size_t)y * in_stride + x, in_stride) > gate;
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, keep);
    int slot = 0;
    if (threadIdx.x == 0 && ballot != 0) slot = atomicAdd(&n_cand, __popc(ballot));
    slot = __shfl_sync(0xffffffffu, slot, 0);
    if (keep) {
      cand[slot + __popc(ballot & ((1u << threadIdx.x) - 1u))] =
          static_cast<unsigned short>(ly * kTile + threadIdx.x);
    } else if (inside) {
      obase[(size_t)y * out_stride + x] = 0.0f;
    }
  }
  __syncthreads();
  const int n = n_cand;
  for (int i = threadIdx.y * kBX + threadIdx.x; i < n; i += kBX * kBY) {
    const int c = cand[i];
    const int cy = tl.y0 + c / kTile;
    const int cx = tl.x0 + (c & (kTile - 1));
    const float score = segment_score(base + (size_t)cy * in_stride + cx, in_stride);
    if (score > ini_th) atomicOr(&flags[flag_index(pl, cy, cx, magic)], 1);
    obase[(size_t)cy * out_stride + cx] = score > gate ? score : 0.0f;
  }
}

// Pass 1, ungated: out = score (negative in flat regions), ring 0.
__global__ void __launch_bounds__(kBX * kBY)
fast_score_raw_kernel(const float* __restrict__ in, float* __restrict__ out,
                      const PlaneTable t, int in_stride, int out_stride) {
  const Tile tl = locate(t);
  const Plane& pl = tl.pl;
  const int x = tl.x0 + threadIdx.x;
  if (x >= pl.W) return;
#pragma unroll
  for (int k = 0; k < kRowsPerThread; ++k) {
    const int y = tl.y0 + threadIdx.y + k * kBY;
    if (y >= pl.H) break;
    float score = 0.0f;
    if (y >= kR && y < pl.H - kR && x >= kR && x < pl.W - kR) {
      score = segment_score(in + pl.in_off + (size_t)y * in_stride + x, in_stride);
    }
    out[pl.out_off + (size_t)y * out_stride + x] = score;
  }
}

// Pass 2: per-cell threshold choice, 3x3 non-maximum suppression, margin.
// `g` is pass 1's output and shares the output stack's layout (in_off ==
// out_off); offsets fit an int (the host checks). margin >= 1,
// so a pixel inside the margin has all 8 neighbours inside its plane and
// inside the tile's halo.
constexpr int kNX = 120;                 // tile: 120 x 32 pixels
constexpr int kNY = 32;
constexpr int kNThreads = 256;           // 8 warps
constexpr int kNWarps = kNThreads / 32;
constexpr int kNRows = kNY + 2;          // staged rows, halo included
constexpr int kNChunks = 32;             // a staged row: 32 aligned chunks of 4 floats
constexpr int kNRowFloats = 4 * kNChunks;
constexpr int kNStage = (kNRows + kNWarps - 1) / kNWarps;   // rows a warp stages
static_assert((kNX + 2 + 3 + 3) / 4 <= kNChunks, "a staged row spans at most 32 chunks");

// The last plane whose first tile is at or before `tile`.
__device__ __forceinline__ int plane_of(const PlaneTable& t, int tile) {
  int lo = 0, hi = t.n - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (t.p[mid].tile0 <= tile) lo = mid; else hi = mid - 1;
  }
  return lo;
}

__global__ void __launch_bounds__(kNThreads)
fast_nms_planes_kernel(const float* __restrict__ g, const int* __restrict__ flags,
                       float* __restrict__ out, const __grid_constant__ PlaneTable t,
                       int stride, float ini_th, float min_th,
                       unsigned long long magic, int margin) {
  extern __shared__ float4 nsm[];
  float* srow = reinterpret_cast<float*>(nsm);   // [kNRows][kNRowFloats], thresholded
  int* sflag = reinterpret_cast<int*>(srow + kNRows * kNRowFloats);   // the tile's cells
  __shared__ int scx[kNRowFloats + 3];   // the cell column of staged column u - 3
  __shared__ int scy[kNRows];            // the cell row of staged row r
  TC2LI_LAP_START
  const Plane& pl = t.p[plane_of(t, blockIdx.x)];
  const int local = blockIdx.x - pl.tile0;
  const int ty = local / pl.tiles_x;
  const int x0 = (local - ty * pl.tiles_x) * kNX, y0 = ty * kNY;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // the staged area, clipped to the plane: rows ya..yb, columns xa..xb; a
  // staged row r (y = y0 - 1 + r) starts at the aligned chunk that holds
  // (y, xa), so its pixel x sits at xa + q - shift(y) for q in 0..127
  const int ya = max(y0 - 1, 0), yb = min(y0 + kNY, pl.H - 1);
  const int xa = max(x0 - 1, 0), xb = min(x0 + kNX, pl.W - 1);
  const int cy0 = cell_of(ya, magic), cx0 = cell_of(xa, magic);
  const int ncx = cell_of(xb, magic) - cx0 + 1;
  const int n_cells = (cell_of(yb, magic) - cy0 + 1) * ncx;
  const int base = pl.in_off;
  auto row_at = [&](int y) { return base + y * stride; };
  auto shift = [&](int y) { return (row_at(y) + xa) & 3; };

  // 1. loads, all issued before any is used: a warp a row, a lane a chunk;
  // the tile's cell flags and the staged columns' and rows' cells
  float4 v[kNStage];
#pragma unroll
  for (int k = 0; k < kNStage; ++k) {
    const int y = y0 - 1 + warp + k * kNWarps;
    v[k] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (y >= ya && y <= yb) {
      const int rb = row_at(y);
      const int c = ((rb + xa) >> 2) + lane;      // this lane's chunk
      if (4 * c <= rb + xb) {
        if (4 * c >= rb + xa && 4 * c + 3 <= rb + xb) {
          v[k] = reinterpret_cast<const float4*>(g)[c];
        } else {   // a partial end chunk: its floats inside the row's staged span
          float e[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int i = 4 * c + j;
            if (i >= rb + xa && i <= rb + xb) e[j] = g[i];
          }
          v[k] = make_float4(e[0], e[1], e[2], e[3]);
        }
      }
    }
  }
  for (int i = threadIdx.x; i < n_cells; i += kNThreads) {
    sflag[i] = flags[pl.cell_off + (cy0 + i / ncx) * pl.cells_x + cx0 + i % ncx];
  }
  if (threadIdx.x < kNRowFloats + 3) {
    const int x = min(max(xa + static_cast<int>(threadIdx.x) - 3, xa), xb);
    scx[threadIdx.x] = cell_of(x, magic) - cx0;
  } else if (threadIdx.x - (kNRowFloats + 3) < kNRows) {
    const int r = threadIdx.x - (kNRowFloats + 3);
    scy[r] = cell_of(min(max(y0 - 1 + r, ya), yb), magic) - cy0;
  }
  __syncthreads();
  TC2LI_LAP(0);

  // 2. each staged pixel thresholded by its cell's flag, to shared memory
#pragma unroll
  for (int k = 0; k < kNStage; ++k) {
    const int r = warp + k * kNWarps;
    if (r < kNRows) {
      const int sh = shift(y0 - 1 + r);
      float e[4] = {v[k].x, v[k].y, v[k].z, v[k].w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (e[j] > 0.f) {   // (0 below any threshold; unstaged floats are 0)
          const int f = sflag[scy[r] * ncx + scx[4 * lane + j - sh + 3]];
          e[j] = e[j] > (f ? ini_th : min_th) ? e[j] : 0.f;
        }
      }
      reinterpret_cast<float4*>(srow + r * kNRowFloats)[lane] = make_float4(e[0], e[1], e[2], e[3]);
    }
  }
  __syncthreads();
  TC2LI_LAP(1);

  // 3. each output row: a warp a row, a lane an aligned chunk of 4 pixels,
  // its centres one 16-byte read of the staged row; a pixel above 0 looks
  // at its 8 neighbours (ties survive)
  const int x_end = min(x0 + kNX, pl.W);
  for (int ly = warp; ly < kNY; ly += kNWarps) {
    const int y = y0 + ly;
    if (y >= pl.H) break;
    const int rb = row_at(y);
    const int o0 = rb + x0, o1 = rb + x_end;    // the row's outputs [o0, o1)
    const int c = (o0 >> 2) + lane;
    if (4 * c >= o1) continue;
    const int r = ly + 1;
    const float4 ctr = reinterpret_cast<const float4*>(srow + r * kNRowFloats)[c - ((rb + xa) >> 2)];
    const float cs[4] = {ctr.x, ctr.y, ctr.z, ctr.w};
    const bool inner_y = y >= margin && y < pl.H - margin;
    float res[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int x = 4 * c + j - rb;
      res[j] = 0.f;
      const float s = cs[j];
      if (s > 0.f && inner_y && x >= x0 && x < x_end && x >= margin && x < pl.W - margin) {
        // neighbour (y + dy, x + dx) at row r + dy, column x + dx - xa + shift(y + dy)
        const float* up = srow + (r - 1) * kNRowFloats + x - xa + shift(y - 1);
        const float* mid = srow + r * kNRowFloats + x - xa + shift(y);
        const float* dn = srow + (r + 1) * kNRowFloats + x - xa + shift(y + 1);
        const float m = fmaxf(fmaxf(fmaxf(up[-1], up[0]), fmaxf(up[1], mid[-1])),
                              fmaxf(fmaxf(mid[1], dn[-1]), fmaxf(dn[0], dn[1])));
        res[j] = m > s ? 0.f : s;
      }
    }
    if (4 * c >= o0 && 4 * c + 4 <= o1) {
      reinterpret_cast<float4*>(out)[c] = make_float4(res[0], res[1], res[2], res[3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (4 * c + j >= o0 && 4 * c + j < o1) out[4 * c + j] = res[j];
      }
    }
  }
  TC2LI_LAP(2);
}

// Fills `t` from `n` rows of 8 ints (the fields of Plane in order) and
// returns the number of tiles, or -1 if the table does not fit.
int load_table(const int* planes, int n, PlaneTable* t) {
  if (n < 1 || n > kMaxPlanes) return -1;
  int tiles = 0;
  for (int i = 0; i < n; ++i) {
    const int* r = planes + 8 * i;
    if (r[2] < 1 || r[3] < 1 || r[2] > kMaxDim || r[3] > kMaxDim) return -1;
    t->p[i] = Plane{r[0], r[1], r[2], r[3], r[4], r[5], r[6], r[7]};
    const int tiles_y = (r[2] + kTile - 1) / kTile;
    tiles = r[6] + tiles_y * r[7];
  }
  t->n = n;
  return tiles;
}

unsigned long long cell_magic(int cell) {
  return (0x100000000ULL + cell - 1) / cell;
}

}  // namespace

// Pass 1 over `n` planes. `planes` is a host array of n x 8 ints (in_off,
// out_off, H, W, cell_off, cells_x, tile0, tiles_x; tiles are 32 x 32 and
// numbered plane after plane). in, out: float32 stacks on the device;
// flags: int32 cell flags, zeroed by the caller on the same stream (unused
// when gated == 0). Launches on `stream` and returns cudaGetLastError()
// (0 on success), or cudaErrorInvalidValue for a bad table or cell.
extern "C" int tc2li_fast_score_planes(const float* in, float* out, int* flags,
                                       const int* planes, int n, int in_stride,
                                       int out_stride, int gated, float gate,
                                       float ini_th, int cell, void* stream) {
  PlaneTable t;
  const int tiles = load_table(planes, n, &t);
  if (tiles <= 0 || cell < 1 || cell > kMaxDim) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 block(kBX, kBY);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (gated) {
    fast_score_gated_kernel<<<tiles, block, 0, s>>>(
        in, out, flags, t, in_stride, out_stride, gate, ini_th, cell_magic(cell));
  } else {
    fast_score_raw_kernel<<<tiles, block, 0, s>>>(in, out, t, in_stride, out_stride);
  }
  return static_cast<int>(cudaGetLastError());
}

// Pass 2 over the same table: g (pass 1's output) -> out, both with the
// output stack's layout and row stride, both 16-byte aligned (the tiles'
// fields of the table are not read: the pass tiles the planes its own way).
extern "C" int tc2li_fast_nms_planes(const float* g, const int* flags, float* out,
                                     const int* planes, int n, int stride,
                                     float ini_th, float min_th, int cell, int margin,
                                     void* stream) {
  PlaneTable t;
  if (load_table(planes, n, &t) <= 0 || cell < 1 || cell > kMaxDim || margin < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // this pass's own tiling of the planes; their extent in the stack must
  // fit the kernel's int offsets
  int tiles = 0;
  for (int i = 0; i < n; ++i) {
    Plane& pl = t.p[i];
    if (pl.in_off != pl.out_off || pl.in_off < 0) return static_cast<int>(cudaErrorInvalidValue);
    pl.tile0 = tiles;
    pl.tiles_x = (pl.W + kNX - 1) / kNX;
    tiles += pl.tiles_x * ((pl.H + kNY - 1) / kNY);
    if (pl.in_off + static_cast<long long>(pl.H - 1) * stride + pl.W >= (1LL << 31)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  // shared memory: the staged rows, then the flags of the cells a tile's
  // staged area meets (34.6 KB at most, at cell 1: under the 48 KB default)
  const int cells = ((kNRows + cell - 1) / cell + 1) * ((kNX + 2 + cell - 1) / cell + 1);
  const int smem = static_cast<int>(sizeof(float)) * kNRows * kNRowFloats
                   + static_cast<int>(sizeof(int)) * cells;
  fast_nms_planes_kernel<<<tiles, kNThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      g, flags, out, t, stride, ini_th, min_th, cell_magic(cell), margin);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* tc2li_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
