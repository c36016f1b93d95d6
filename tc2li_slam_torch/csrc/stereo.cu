// The stereo half of a frame build after the descriptor match: the
// matcher's tail, the subpixel refinement and the depth of every left
// keypoint, in three launches around csrc/match.cu's.
//
// Replaces tc2li_slam_tpu/ops/stereo.py:62 (subpixel_refine, jit-compiled
// there) and the tails of match_stereo (:45) and build_frame
// (slam/tracking.py). Eager PyTorch ran them as ~140 small ops a frame, with
// two replicate-padded copies of the images.
//
// What it computes is the plain chain's (ops/kernels/stereo.py
// stereo_refine_plain): the mutual best with the ratio test, the disparity
// clamped at 0.01 px, the centres rounded half to even (rintf, as
// torch.round), the validity of the strip's centre and row before the
// clamp, replicate padding as clamped coordinates, the 11 x 11 left patch
// against 11 offsets of the 11 x 21 right strip (SAD of centred windows; the
// first offset of the minimum), the parabola through the best offset
// clamped to [1, 9] with one IEEE division, the median gate as the reference
// has it (the threshold is infinite unless every keypoint is ok, else 2.1
// times the median of all N best SADs), and depth = bf * (1 / max(d, 0.1))
// as PyTorch's scalar-over-tensor division computes it. Grey-level pixels
// make every SAD an exact integer in float32, so every output is bit-equal
// to the plain chain's.
//
// Bound on the H100: operations, ~5,500 a keypoint (121 x 11 absolute
// differences), ~11 M at N 2000; the bytes (the patches, the strips) are a
// few MB of L2 hits. Design: prep_kernel writes the right keypoints' row
// bands and the matcher's column-best buffer (so that the match needs no fill
// of its own); refine_kernel gives a keypoint to a warp, its patch and strip
// in shared memory, one lane an offset; gate_kernel is one block over all N:
// the all-ok test, the median by a radix select on the SADs' bits where
// every keypoint is ok, then each keypoint's flag, depth and (u, v, u_r).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kHalf = 5;                  // ops/stereo.py SAD_W
constexpr int kSlide = 5;                 // SAD_L
constexpr int kPatch = 2 * kHalf + 1;     // 11
constexpr int kStrip = 2 * (kHalf + kSlide) + 1;   // 21
constexpr int kOffsets = 2 * kSlide + 1;  // 11
constexpr int kWarps = 8;                 // keypoints a block in refine_kernel
constexpr int kGateThreads = 1024;
constexpr int kThHigh = 100;              // ops/matching.py TH_HIGH
constexpr long long kBig = 1 << 20;       // ops/kernels/match.py BIG

__global__ void prep_kernel(const int* __restrict__ lvl_r, const float* __restrict__ sf,
                            int n_levels, int M, float* __restrict__ band,
                            long long* __restrict__ colbest) {
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= M) return;
  int l = lvl_r[m];
  l = l < 0 ? 0 : (l >= n_levels ? n_levels - 1 : l);
  band[m] = __fmul_rn(2.0f, sf[l]);
  colbest[m] = kBig << 32;
}

__device__ __forceinline__ float pix(const uint8_t* img, long long i) {
  return static_cast<float>(img[i]);
}
__device__ __forceinline__ float pix(const float* img, long long i) { return img[i]; }

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// rint(x) clamped to [0, hi], as an int (x finite; NaN goes to 0)
__device__ __forceinline__ int centre(float rounded, int hi) {
  return static_cast<int>(fminf(fmaxf(rounded, 0.f), static_cast<float>(hi)));
}

template <typename Pix>
__global__ void __launch_bounds__(32 * kWarps)
refine_kernel(const Pix* __restrict__ img_l, const Pix* __restrict__ img_r, int H, int W,
              const float* __restrict__ xy_l, const uint8_t* __restrict__ valid_l,
              const float* __restrict__ xy_r, const long long* __restrict__ idx,
              const int* __restrict__ best, const int* __restrict__ second,
              const long long* __restrict__ colbest, int N, float* __restrict__ ur_out,
              float* __restrict__ sad_out, uint8_t* __restrict__ ok_out) {
  __shared__ float s_patch[kWarps][kPatch * kPatch];
  __shared__ float s_strip[kWarps][kPatch * kStrip];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n = blockIdx.x * kWarps + warp;
  if (n >= N) return;   // (whole warps; no block barrier below)

  // the matcher's tail (ops/matching.py match_descriptors, mutual, ratio 0.9)
  const float ul = xy_l[2 * n], vl = xy_l[2 * n + 1];
  const long long j = idx[n];
  const int b = best[n];
  bool ok = b <= kThHigh && valid_l[n] != 0;
  ok = ok && static_cast<float>(b) <= __fmul_rn(0.9f, static_cast<float>(second[n]));
  ok = ok && (static_cast<unsigned long long>(colbest[j]) & 0xFFFFFFFFull) ==
                 static_cast<unsigned long long>(n);
  float disp = __fsub_rn(ul, xy_r[2 * j]);
  disp = disp < 0.01f ? 0.01f : disp;          // torch.clamp(min=0.01); NaN stays
  const float ur0 = __fsub_rn(ul, disp);

  // subpixel_refine: centres half to even, validity before the clamp
  const float rf = rintf(vl), clf = rintf(ul), crf = rintf(ur0);
  ok = ok && crf >= 0.f && crf < static_cast<float>(W) && rf >= 0.f &&
       rf < static_cast<float>(H);
  const int r = centre(rf, H - 1), cl = centre(clf, W - 1), cr = centre(crf, W - 1);

  float* patch = s_patch[warp];
  float* strip = s_strip[warp];
  for (int k = lane; k < kPatch * kPatch; k += 32) {
    const int y = clampi(r - kHalf + k / kPatch, 0, H - 1);
    const int x = clampi(cl - kHalf + k % kPatch, 0, W - 1);
    patch[k] = pix(img_l, static_cast<long long>(y) * W + x);
  }
  for (int k = lane; k < kPatch * kStrip; k += 32) {
    const int y = clampi(r - kHalf + k / kStrip, 0, H - 1);
    const int x = clampi(cr - kHalf - kSlide + k % kStrip, 0, W - 1);
    strip[k] = pix(img_r, static_cast<long long>(y) * W + x);
  }
  __syncwarp();

  // one lane an offset: the SAD of the centred windows, row by row
  float sad = 0.f;
  if (lane < kOffsets) {
    const float pc = patch[kHalf * kPatch + kHalf];
    const float wc = strip[kHalf * kStrip + lane + kHalf];
    for (int i = 0; i < kPatch; ++i)
#pragma unroll
      for (int c = 0; c < kPatch; ++c) {
        const float w = __fsub_rn(strip[i * kStrip + lane + c], wc);
        const float p = __fsub_rn(patch[i * kPatch + c], pc);
        sad = __fadd_rn(sad, fabsf(__fsub_rn(w, p)));
      }
  }
  float s[kOffsets];
#pragma unroll
  for (int o = 0; o < kOffsets; ++o) s[o] = __shfl_sync(0xFFFFFFFFu, sad, o);
  if (lane != 0) return;

  int arg = 0;
#pragma unroll
  for (int o = 1; o < kOffsets; ++o)
    if (s[o] < s[arg]) arg = o;                // the first index of the minimum
  const int bc = clampi(arg, 1, kOffsets - 2);
  float sm = s[0], s0 = s[0], sp = s[0];
#pragma unroll
  for (int o = 0; o < kOffsets; ++o) {
    if (o == bc - 1) sm = s[o];
    if (o == bc) s0 = s[o];
    if (o == bc + 1) sp = s[o];
  }
  float denom = __fmul_rn(2.0f, __fsub_rn(__fadd_rn(sm, sp), __fmul_rn(2.0f, s0)));
  denom = denom < 1e-6f ? 1e-6f : denom;
  float delta = __fdiv_rn(__fsub_rn(sm, sp), denom);
  delta = delta < -1.f ? -1.f : (delta > 1.f ? 1.f : delta);
  ur_out[n] = __fadd_rn(__fadd_rn(static_cast<float>(cr), static_cast<float>(bc - kSlide)),
                        delta);
  sad_out[n] = s0;
  ok_out[n] = ok && fabsf(delta) <= 1.f;
}

// the SAD's bits as an unsigned key in the order of the floats
__device__ __forceinline__ unsigned order_key(float v) {
  const unsigned u = __float_as_uint(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}
__device__ __forceinline__ float from_key(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7FFFFFFFu) : ~k);
}

// the k-th smallest (0-based) of sad[0..N): four 8-bit digits, most
// significant first, an integer histogram a digit
__device__ float select_kth(const float* sad, int N, int k, int* hist, int* pick) {
  unsigned prefix = 0, mask = 0;
  for (int shift = 24; shift >= 0; shift -= 8) {
    for (int d = threadIdx.x; d < 256; d += blockDim.x) hist[d] = 0;
    __syncthreads();
    for (int i = threadIdx.x; i < N; i += blockDim.x) {
      const unsigned u = order_key(sad[i]);
      if ((u & mask) == prefix) atomicAdd(&hist[(u >> shift) & 255u], 1);
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      int acc = 0, d = 0;
      for (; d < 255 && acc + hist[d] <= k; ++d) acc += hist[d];
      pick[0] = d;
      pick[1] = k - acc;
    }
    __syncthreads();
    prefix |= static_cast<unsigned>(pick[0]) << shift;
    mask |= 255u << shift;
    k = pick[1];
    __syncthreads();
  }
  return from_key(prefix);
}

__global__ void __launch_bounds__(kGateThreads)
gate_kernel(const float* __restrict__ xy_l, const float* __restrict__ ur,
            const float* __restrict__ sad, int N, float bf, uint8_t* __restrict__ ok,
            float* __restrict__ depth, float* __restrict__ uvr) {
  __shared__ int hist[256];
  __shared__ int pick[2];
  int mine = 1;
  for (int i = threadIdx.x; i < N; i += blockDim.x) mine &= ok[i];
  const bool all_ok = __syncthreads_and(mine) != 0;
  float thr = __int_as_float(0x7F800000);    // +inf: the median is NaN
  if (all_ok && N > 0) {
    const float lo = select_kth(sad, N, (N - 1) / 2, hist, pick);
    const float hi = select_kth(sad, N, N / 2, hist, pick);
    thr = __fmul_rn(__fmul_rn(__fadd_rn(lo, hi), 0.5f), 2.1f);
  }
  for (int i = threadIdx.x; i < N; i += blockDim.x) {
    const bool k = ok[i] != 0 && sad[i] <= thr;
    const float ul = xy_l[2 * i], u = ur[i];
    const float d = __fsub_rn(ul, u);
    const bool has = k && d > 0.1f;
    ok[i] = k;
    depth[i] = has ? __fmul_rn(__frcp_rn(d < 0.1f ? 0.1f : d), bf) : 0.f;
    uvr[3 * i] = ul;
    uvr[3 * i + 1] = xy_l[2 * i + 1];
    uvr[3 * i + 2] = has ? u : -1.f;
  }
}

}  // namespace

// lvl_r [M] int32, sf [n_levels] float32 -> band [M] float32, colbest [M]
// int64 (BIG << 32, the column-best buffer csrc/match.cu's mutual mode fills).
extern "C" int tc2li_stereo_prep(const int* lvl_r, const float* sf, int n_levels, int M,
                                 float* band, long long* colbest, void* stream) {
  if (M > 0)
    prep_kernel<<<(M + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
        lvl_r, sf, n_levels, M, band, colbest);
  return static_cast<int>(cudaGetLastError());
}

// img_l, img_r [H, W] (pix_u8: uint8, else float32); xy_l [N, 2], valid_l [N]
// uint8, xy_r [M, 2]; the match's idx [N] int64, best, second [N] int32 and
// colbest [M] int64 as csrc/match.cu wrote them. Outputs: ur [N], ok [N]
// uint8, depth [N], uvr [N, 3]; scratch sad [N] float32. Two launches on
// `stream`; returns cudaGetLastError().
extern "C" int tc2li_stereo_refine(const void* img_l, const void* img_r, int pix_u8, int H, int W,
                                   const float* xy_l, const uint8_t* valid_l, const float* xy_r,
                                   const long long* idx, const int* best, const int* second,
                                   const long long* colbest, int N, float bf, float* ur,
                                   float* sad, uint8_t* ok, float* depth, float* uvr,
                                   void* stream) {
  if (H < 1 || W < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N > 0) {
    const int blocks = (N + kWarps - 1) / kWarps;
    if (pix_u8)
      refine_kernel<uint8_t><<<blocks, 32 * kWarps, 0, st>>>(
          static_cast<const uint8_t*>(img_l), static_cast<const uint8_t*>(img_r), H, W, xy_l,
          valid_l, xy_r, idx, best, second, colbest, N, ur, sad, ok);
    else
      refine_kernel<float><<<blocks, 32 * kWarps, 0, st>>>(
          static_cast<const float*>(img_l), static_cast<const float*>(img_r), H, W, xy_l,
          valid_l, xy_r, idx, best, second, colbest, N, ur, sad, ok);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  gate_kernel<<<1, kGateThreads, 0, st>>>(xy_l, ur, sad, N, bf, ok, depth, uvr);
  return static_cast<int>(cudaGetLastError());
}
