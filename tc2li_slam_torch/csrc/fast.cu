// FAST-9/16 segment-test score, one thread per output pixel.
//
// Replaces the Pallas kernel tc2li_slam_tpu/ops/kernels/fast.py
// (fast_score_pallas / _fast_kernel). For every pixel: the max over the 16
// circular 9-runs of the min signed neighbour difference, for brighter and
// darker runs; the 3-px border ring is 0. The score is ungated (negative in
// flat regions) because detect_level gates the same map twice.
//
// Bound on the H100: device memory. Each pixel reads its 7x7 neighbourhood
// and writes one float; the arithmetic is ~300 min/max per pixel. A 32x8
// block stages its tile plus a 3-px halo in shared memory (38x14 floats), so
// every image float is read from device memory ~1.7 times instead of 17;
// the 16 differences live in registers. The TPU version's [7, H, W]
// row-shift stack existed only for Mosaic's 8-row alignment and is gone.
//
// The float operations are the plain version's (one subtraction per
// neighbour, then exact min/max), so the result is bit-equal to it.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBX = 32;
constexpr int kBY = 8;
constexpr int kR = 3;
constexpr int kTW = kBX + 2 * kR;
constexpr int kTH = kBY + 2 * kR;

// FAST circle (dx, dy), radius 3, OpenCV ordering.
__constant__ int kDX[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};
__constant__ int kDY[16] = {-3, -3, -2, -1, 0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3};

__global__ void fast_score_kernel(const float* __restrict__ img,
                                  float* __restrict__ out, int H, int W) {
  __shared__ float tile[kTH][kTW];
  const int x0 = blockIdx.x * kBX;
  const int y0 = blockIdx.y * kBY;
  const int tid = threadIdx.y * kBX + threadIdx.x;
  for (int i = tid; i < kTH * kTW; i += kBX * kBY) {
    const int ty = i / kTW;
    const int tx = i - ty * kTW;
    const int gy = y0 + ty - kR;
    const int gx = x0 + tx - kR;
    tile[ty][tx] = (gy >= 0 && gy < H && gx >= 0 && gx < W)
                       ? img[(size_t)gy * W + gx] : 0.0f;
  }
  __syncthreads();

  const int x = x0 + threadIdx.x;
  const int y = y0 + threadIdx.y;
  if (x >= W || y >= H) return;
  float score = 0.0f;
  if (y >= kR && y < H - kR && x >= kR && x < W - kR) {
    const int cy = threadIdx.y + kR;
    const int cx = threadIdx.x + kR;
    const float c = tile[cy][cx];
    float d[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) d[k] = tile[cy + kDY[k]][cx + kDX[k]] - c;
    float sb = -INFINITY;
    float sd = -INFINITY;
#pragma unroll
    for (int s = 0; s < 16; ++s) {
      float run_p = d[s];
      float run_n = -d[s];
#pragma unroll
      for (int j = 1; j < 9; ++j) {
        const float v = d[(s + j) & 15];
        run_p = fminf(run_p, v);
        run_n = fminf(run_n, -v);
      }
      sb = fmaxf(sb, run_p);
      sd = fmaxf(sd, run_n);
    }
    score = fmaxf(sb, sd);
  }
  out[(size_t)y * W + x] = score;
}

}  // namespace

// img, out: contiguous float32 [H, W] on the device. Launches on `stream`
// and returns cudaGetLastError() (0 on success).
extern "C" int tc2li_fast_score(const float* img, float* out, int H, int W,
                                void* stream) {
  const dim3 block(kBX, kBY);
  const dim3 grid((W + kBX - 1) / kBX, (H + kBY - 1) / kBY);
  fast_score_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      img, out, H, W);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* tc2li_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
