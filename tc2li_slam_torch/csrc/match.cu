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
// ~1.7 MB at 32768 x 2000 (0.5 us). Every (valid row, column) pair costs a
// mask test of ~8 simple operations; only a pair that passes it costs the
// 8 XOR + 8 __popc of a distance. A 15-px window in a 1241 x 376 image
// admits well under 1% of the pairs, and rows whose landmark is invalid
// are skipped whole, so the popcount unit, which bounds the matrix kernel
// (csrc/hamming.cu), is almost idle here. The design:
//
// - All of side 2 (descriptors word-major, so a warp's lanes hit distinct
//   banks; u, v, level, band or validity) is staged once per block in
//   dynamic shared memory: 44-48 bytes a column, 96 KB at M = 2000.
// - A grid of at most one 32-warp block per SM (64 registers a thread, so
//   the SM is full and side 2 is staged once per SM) walks groups of 4
//   rows. A warp owns a group: the rows' positions and windows sit in registers,
//   their descriptors in a 128-byte slot of shared memory that the warp
//   fills with one load, the lanes stride the columns, and each column's
//   data is read from shared memory once for the 4 rows.
// - The mask is tested first; XOR/__popc runs only on admitted pairs. An
//   invalid column carries u = NaN, so it fails the window or disparity
//   comparison at no extra cost.
// - Each lane keeps its two smallest keys (distance << 16 | column) per
//   row; keys are unique per column, so the smallest is the first column of
//   the minimum and the second smallest holds the minimum over the other
//   columns. A shuffle tree merges the lanes' pairs.
// - For the mutual test every admitted pair also does atomicMin on a packed
//   64-bit (distance << 32 | row) per column, which gives the first row of
//   the column's minimum whatever the block order.
//
// Comparisons, subtractions, XOR and popcount only (no multiply, so no
// fused multiply-add): every output is equal to the plain PyTorch chain.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWords = 8;
constexpr int kRows = 4;            // rows per warp
constexpr int kThreads = 1024;      // 32 warps: one block fills an SM
constexpr int kWarps = kThreads / 32;
constexpr int kBig = 1 << 20;       // distance of "no admitted column"
constexpr int kNoKey = INT_MAX;
constexpr int kMaxSmem = 232448;    // bytes a block may use on sm_90

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
  // descriptor words + (u, v, level[, band]) or validity
  return kWords + (mode == kWindow ? 3 : mode == kStereo ? 4 : 1);
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
  float* sband = reinterpret_cast<float*>(slvl + M);          // [M] stereo
  int* svalid = reinterpret_cast<int*>(smem + kWords * M);    // [M] dense

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
      if (MODE == kStereo) sband[m] = a.band[m];
    }
  }
  __syncthreads();

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
      float u1[kRows], v1[kRows], rad[kRows];
      int l1[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int row = rv[r] ? r0 + r : 0;   // an invalid row reads row 0, admits nothing
        if (MODE != kDense) {
          u1[r] = a.uv1[2 * row];
          v1[r] = a.uv1[2 * row + 1];
          l1[r] = a.lvl1[row];
          if (MODE == kWindow) rad[r] = a.radius[row];
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
          if (MODE == kStereo) bnd = sband[m];
        }
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          bool admit = rv[r];
          if (MODE == kWindow) {
            const int dl = l2 - l1[r];
            admit = admit && fabsf(u1[r] - u2) < rad[r] && fabsf(v1[r] - v2) < rad[r]
                    && dl >= a.lo && dl <= a.hi;
          } else if (MODE == kStereo) {
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
}

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
// (0 window, 1 stereo, 2 dense); also bounded by the 16-bit column key.
extern "C" int tc2li_match_max_columns(int mode) {
  const int fit = kMaxSmem / (words_per_column(mode) * (int)sizeof(uint32_t));
  return fit < 65535 ? fit : 65535;
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
    case 0: return launch<kWindow, false>(a, s);
    case 1: return launch<kWindow, true>(a, s);
    case 2: return launch<kStereo, false>(a, s);
    case 3: return launch<kStereo, true>(a, s);
    case 4: return launch<kDense, false>(a, s);
    default: return launch<kDense, true>(a, s);
  }
}
