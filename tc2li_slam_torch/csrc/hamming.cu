// Exact Hamming distance matrix between 256-bit descriptors.
//
// Replaces tc2li_slam_tpu/ops/kernels/hamming.py (hamming_matrix_mxu), the
// TPU's bf16 matrix-unit formulation |a| + |b| - 2 a.b over unpacked bits.
// On the H100 the direct form is cheaper: XOR and __popc over the 8 words
// of a pair, 16 integer instructions per distance.
//
// Bound on the H100: operations, the popcount unit. At 32768 x 2000 the
// matrix needs 524 M __popc; at 16 per clock per SM (132 SMs, ~1.755 GHz:
// ~3.7 T/s) that is ~141 us, more than the 262 MB int32 store (~78 us at
// 3.35 TB/s); the inputs are 1 MB. The kernel runs at that unit's rate, so
// as a matrix kernel it is done.
// A 32x8 block computes a 32x32 output tile: 32 descriptors of each side
// are staged in shared memory (rows padded to 9 words so the column-side
// reads hit distinct banks), each thread keeps its column descriptor in
// registers and writes 4 rows; a warp's 32 stores are contiguous.
// The matchers do not come here: they never need the matrix, and use the
// fused mask-first kernel of csrc/match.cu. This one serves callers that
// want all distances (slam/culling.fuse_duplicates).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 32;
constexpr int kRowsPerThread = 4;
constexpr int kWords = 8;

__global__ void hamming_kernel(const uint32_t* __restrict__ a,
                               const uint32_t* __restrict__ b,
                               int32_t* __restrict__ out, int N, int M) {
  __shared__ uint32_t sa[kTile][kWords + 1];
  __shared__ uint32_t sb[kTile][kWords + 1];
  const int r0 = blockIdx.y * kTile;
  const int c0 = blockIdx.x * kTile;
  const int tid = threadIdx.y * kTile + threadIdx.x;
  const int nthreads = kTile * (kTile / kRowsPerThread);
  for (int i = tid; i < kTile * kWords; i += nthreads) {
    const int r = i / kWords;
    const int w = i - r * kWords;
    sa[r][w] = (r0 + r < N) ? a[(size_t)(r0 + r) * kWords + w] : 0u;
    sb[r][w] = (c0 + r < M) ? b[(size_t)(c0 + r) * kWords + w] : 0u;
  }
  __syncthreads();

  const int c = c0 + threadIdx.x;
  if (c >= M) return;
  uint32_t bw[kWords];
#pragma unroll
  for (int w = 0; w < kWords; ++w) bw[w] = sb[threadIdx.x][w];
#pragma unroll
  for (int k = 0; k < kRowsPerThread; ++k) {
    const int rl = threadIdx.y + k * (kTile / kRowsPerThread);
    const int r = r0 + rl;
    if (r < N) {
      int s = 0;
#pragma unroll
      for (int w = 0; w < kWords; ++w) s += __popc(sa[rl][w] ^ bw[w]);
      out[(size_t)r * M + c] = s;
    }
  }
}

}  // namespace

// a: [N, 8] and b: [M, 8] uint32 words, out: int32 [N, M], all contiguous on
// the device; N, M > 0. Launches on `stream`, returns cudaGetLastError().
extern "C" int tc2li_hamming(const uint32_t* a, const uint32_t* b, int32_t* out,
                             int N, int M, void* stream) {
  const dim3 block(kTile, kTile / kRowsPerThread);
  const dim3 grid((M + kTile - 1) / kTile, (N + kTile - 1) / kTile);
  hamming_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      a, b, out, N, M);
  return static_cast<int>(cudaGetLastError());
}
