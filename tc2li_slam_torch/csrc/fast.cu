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
//   a surviving pixel looks at its neighbours, and at a neighbour's flag
//   only where the neighbour's stored score is larger) and applies the
//   margin. Cell indices are a multiply and a shift, not a division.
//
// Every operation is a subtraction, a comparison or a min/max, so the
// result is bit-equal to the plain PyTorch version.

#include <cuda_runtime.h>
#include <math.h>

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
// `g` is pass 1's output and shares the output stack's layout. margin >= 1,
// so a pixel inside the margin has all 8 neighbours inside its plane. A
// neighbour only matters if its gated score exceeds the centre's, so its
// cell flag is read only where its stored score does.
__global__ void __launch_bounds__(kBX * kBY)
fast_nms_planes_kernel(const float* __restrict__ g, const int* __restrict__ flags,
                       float* __restrict__ out, const PlaneTable t, int stride,
                       float ini_th, float min_th, unsigned long long magic,
                       int margin) {
  const Tile tl = locate(t);
  const Plane& pl = tl.pl;
  const int x = tl.x0 + threadIdx.x;
  if (x >= pl.W) return;
  const float* gb = g + pl.out_off;
#pragma unroll
  for (int k = 0; k < kRowsPerThread; ++k) {
    const int y = tl.y0 + threadIdx.y + k * kBY;
    if (y >= pl.H) break;
    float res = 0.0f;
    if (y >= margin && y < pl.H - margin && x >= margin && x < pl.W - margin) {
      const float v = gb[(size_t)y * stride + x];
      if (v > 0.0f && v > (flags[flag_index(pl, y, x, magic)] ? ini_th : min_th)) {
        bool is_max = true;
#pragma unroll
        for (int dy = -1; dy <= 1; ++dy) {
#pragma unroll
          for (int dx = -1; dx <= 1; ++dx) {
            if (dy == 0 && dx == 0) continue;
            const float vn = gb[(size_t)(y + dy) * stride + x + dx];
            if (vn > v
                && vn > (flags[flag_index(pl, y + dy, x + dx, magic)] ? ini_th : min_th)) {
              is_max = false;
            }
          }
        }
        if (is_max) res = v;
      }
    }
    out[pl.out_off + (size_t)y * stride + x] = res;
  }
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
// output stack's layout and row stride.
extern "C" int tc2li_fast_nms_planes(const float* g, const int* flags, float* out,
                                     const int* planes, int n, int stride,
                                     float ini_th, float min_th, int cell, int margin,
                                     void* stream) {
  PlaneTable t;
  const int tiles = load_table(planes, n, &t);
  if (tiles <= 0 || cell < 1 || cell > kMaxDim || margin < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  fast_nms_planes_kernel<<<tiles, dim3(kBX, kBY), 0, static_cast<cudaStream_t>(stream)>>>(
      g, flags, out, t, stride, ini_th, min_th, cell_magic(cell), margin);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* tc2li_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
