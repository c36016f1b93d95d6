// The stereo half of a frame build after the descriptor match: the
// matcher's tail, the subpixel refinement and the depth of every left
// keypoint, in two launches around csrc/match.cu's.
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
// few MB of L2 hits. The three launches of the stereo half (prep, the
// match, refine) are chained by programmatic dependent launch: each waits
// (griddepcontrol.wait) before it reads what the launch before it writes,
// so a launch is processed while its primary runs. Prep lets the match's
// blocks start right after its own wait (they load the keypoints, older
// than prep, before theirs); the match lets refine start only as its
// blocks exit: started early, refine's blocks crowded the few SMs that no
// match block holds (one 512-thread block of 114 registers a thread fills
// an SM's registers) and slowed their own tail (PERF.md, section 6). No launch
// triggers before its own wait: the waits chain the order back to every
// older launch.
//
// prep_kernel writes the right keypoints' row bands and the matcher's
// column-best buffer (so that the match needs no fill of its own).
//
// refine_kernel gives a keypoint to a warp: its inputs and the match's in
// one round of loads, then the left patch beside the right keypoint's u and
// the column best, then the right strip. On uint8 images the lanes load 4-byte
// words (a row of a window in 4 or 7 of them) where the window lies inside
// the image's columns, pixel by pixel where it is clamped at a border; all
// 32 lanes then take the 121 (offset, row) partial SADs as integers, and 11
// lanes add an offset's 11 partials: every SAD is an exact integer below
// 2^16, so the order of the sums changes no bit. Float images keep the
// plain chain's row-by-row float order, a lane an offset. Every block then
// writes its keypoints' outputs as the gate leaves them when the threshold
// is infinite and counts itself in at a device counter after a
// __threadfence, with its flag (a keypoint not ok; a NaN SAD leaves its
// keypoint not ok) in the same atomic: the low 16 bits count the blocks,
// the high bits the blocks with a keypoint not ok, so the last block takes
// both from the value its own atomicAdd returns. The last block to arrive
// resets the counter for the next call; where every keypoint is ok it takes
// the median of all N SADs by a radix select (two 8-bit digits of the
// integer SADs, four of a float's order key) and rewrites each keypoint's
// flag, depth and u_r. The median is an order statistic: block order
// changes no bit. The counter belongs to one stream: two refine launches
// may not run at once on one counter (ops/kernels/stereo.py keeps one a
// device and stream).

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#ifdef TC2LI_LAPS   // clock laps of a phase split (laps.cuh, tools/orb_kernels.py)
#define TC2LI_LAP_TAG stereo
#include "laps.cuh"
#else
#define TC2LI_LAP_START
#define TC2LI_LAP(k)
#endif

namespace {

constexpr int kHalf = 5;                  // ops/stereo.py SAD_W
constexpr int kSlide = 5;                 // SAD_L
constexpr int kPatch = 2 * kHalf + 1;     // 11
constexpr int kStrip = 2 * (kHalf + kSlide) + 1;   // 21
constexpr int kOffsets = 2 * kSlide + 1;  // 11
constexpr int kWarps = 8;                 // keypoints a block in refine_kernel
constexpr int kThHigh = 100;              // ops/matching.py TH_HIGH
constexpr long long kBig = 1 << 20;       // ops/kernels/match.py BIG
constexpr unsigned kFull = 0xffffffffu;
constexpr int kArrivedBits = 16;          // the gate counter's arrivals; its flag count above
constexpr int kMaxBlocks = 1 << 15;       // (both fit an int)
static_assert(kPatch * kPatch * 2 * 255 < (1 << 16), "an integer SAD has two 8-bit digits");

__device__ __forceinline__ void pdl_wait() { asm volatile("griddepcontrol.wait;" ::: "memory"); }
__device__ __forceinline__ void pdl_trigger() { asm volatile("griddepcontrol.launch_dependents;"); }

__global__ void prep_kernel(const int* __restrict__ lvl_r, const float* __restrict__ sf,
                            int n_levels, int M, float* __restrict__ band,
                            long long* __restrict__ colbest) {
  pdl_wait();      // the right keypoints' levels
  pdl_trigger();   // the match's blocks may start
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= M) return;
  int l = lvl_r[m];
  l = l < 0 ? 0 : (l >= n_levels ? n_levels - 1 : l);
  band[m] = __fmul_rn(2.0f, sf[l]);
  colbest[m] = kBig << 32;
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// rint(x) clamped to [0, hi], as an int (x finite; NaN goes to 0)
__device__ __forceinline__ int centre(float rounded, int hi) {
  return static_cast<int>(fminf(fmaxf(rounded, 0.f), static_cast<float>(hi)));
}

// The 11 rows r - 5 .. r + 5 (clamped) of image columns x0 .. x0 + LEN - 1
// (each clamped) into dst [11][LEN], by the lanes of a warp. uint8: 4-byte
// words where the columns lie inside the image (the image 4-byte aligned; a
// word never starts past the row's last byte), else pixel by pixel.
template <int LEN>
__device__ __forceinline__ void stage(const uint8_t* img, int H, int W, int r, int x0, int* dst,
                                      int lane) {
  constexpr int kWordsRow = (LEN + 3) / 4 + 1;
  if (x0 >= 0 && x0 + LEN <= W) {
    for (int t = lane; t < kPatch * kWordsRow; t += 32) {
      const int i = t / kWordsRow, k = t - i * kWordsRow;
      const long long b0 = static_cast<long long>(clampi(r - kHalf + i, 0, H - 1)) * W + x0;
      const long long w = (b0 >> 2) + k;
      if (4 * w <= b0 + LEN - 1) {
        const unsigned v = __ldg(reinterpret_cast<const unsigned*>(img) + w);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const long long pos = 4 * w + q - b0;
          if (pos >= 0 && pos < LEN) dst[i * LEN + pos] = static_cast<int>((v >> (8 * q)) & 255u);
        }
      }
    }
  } else {
    for (int t = lane; t < kPatch * LEN; t += 32) {
      const int i = t / LEN, c = t - i * LEN;
      dst[t] = img[static_cast<long long>(clampi(r - kHalf + i, 0, H - 1)) * W +
                   clampi(x0 + c, 0, W - 1)];
    }
  }
}

template <int LEN>
__device__ __forceinline__ void stage(const float* img, int H, int W, int r, int x0, float* dst,
                                      int lane) {
  for (int t = lane; t < kPatch * LEN; t += 32) {
    const int i = t / LEN, c = t - i * LEN;
    dst[t] = img[static_cast<long long>(clampi(r - kHalf + i, 0, H - 1)) * W +
                 clampi(x0 + c, 0, W - 1)];
  }
}

// the SAD of the lane's offset (lanes 0..10; the others 0): integers, the 32
// lanes over the (offset, row) pairs, then 11 partials an offset
__device__ __forceinline__ float lane_sad(const int* patch, const int* strip, int (*part)[kPatch],
                                          int lane) {
  const int pc = patch[kHalf * kPatch + kHalf];
  for (int t = lane; t < kOffsets * kPatch; t += 32) {
    const int o = t / kPatch, i = t - o * kPatch;
    const int dc = strip[kHalf * kStrip + o + kHalf] - pc;
    const int* w = strip + i * kStrip + o;
    const int* p = patch + i * kPatch;
    int acc = 0;
#pragma unroll
    for (int c = 0; c < kPatch; ++c) acc += abs((w[c] - p[c]) - dc);
    part[o][i] = acc;
  }
  __syncwarp();
  int sad = 0;
  if (lane < kOffsets) {
#pragma unroll
    for (int i = 0; i < kPatch; ++i) sad += part[lane][i];
  }
  return static_cast<float>(sad);
}

// float images: the plain chain's order, a lane an offset, row by row
__device__ __forceinline__ float lane_sad(const float* patch, const float* strip,
                                          int (*)[kPatch], int lane) {
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
  return sad;
}

// the SAD's bits as an unsigned key in the order of the floats
__device__ __forceinline__ unsigned order_key(float v) {
  const unsigned u = __float_as_uint(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}
__device__ __forceinline__ float from_key(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7FFFFFFFu) : ~k);
}

// The k-th smallest (0-based) of sad[0..N) by the whole block: 8-bit digits,
// most significant first (the integer SADs' two, a float's order key's
// four), a histogram a digit in shared memory, the digit found by warp 0 (8
// bins a lane, an inclusive scan over the lanes).
template <bool INT>
__device__ float select_kth(const float* sad, int N, int k, int* hist, int* pick) {
  unsigned prefix = 0, mask = 0;
  const int lane = threadIdx.x & 31;
  for (int shift = INT ? 8 : 24; shift >= 0; shift -= 8) {
    for (int d = threadIdx.x; d < 256; d += blockDim.x) hist[d] = 0;
    __syncthreads();
    for (int i = threadIdx.x; i < N; i += blockDim.x) {
      const float v = __ldcg(sad + i);
      const unsigned u = INT ? static_cast<unsigned>(v) : order_key(v);
      if ((u & mask) == prefix) atomicAdd(&hist[(u >> shift) & 255u], 1);
    }
    __syncthreads();
    if (threadIdx.x < 32) {
      int c[8], s = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        c[j] = hist[8 * lane + j];
        s += c[j];
      }
      int incl = s;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int o = __shfl_up_sync(kFull, incl, off);
        if (lane >= off) incl += o;
      }
      int acc = incl - s;   // keys below the lane's first bin
      if (acc <= k && k < incl) {
        int d = -1;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (d < 0) {
            if (acc + c[j] > k) {
              d = j;
            } else {
              acc += c[j];
            }
          }
        }
        pick[0] = 8 * lane + d;
        pick[1] = k - acc;
      }
    }
    __syncthreads();
    prefix |= static_cast<unsigned>(pick[0]) << shift;
    mask |= 255u << shift;
    k = pick[1];
    __syncthreads();
  }
  return INT ? static_cast<float>(prefix) : from_key(prefix);
}

struct RefineArgs {
  const void* img_l;
  const void* img_r;
  int H, W;
  const float* xy_l;        // [N, 2]
  const uint8_t* valid_l;   // [N]
  const float* xy_r;        // [M, 2]
  const long long* idx;     // [N] the match's
  const int* best;          // [N]
  const int* second;        // [N]
  const long long* colbest; // [M]
  int N;
  float bf;
  float* ur;                // [N] out
  float* sad;               // [N] the best SADs, published for the last block
  uint8_t* ok;              // [N] out
  float* depth;             // [N] out
  float* uvr;               // [N, 3] out
  int* sync;                // [1]: blocks arrived (low 16 bits), blocks with a keypoint not ok
};

// a keypoint's flag, depth and u_r under the threshold thr
__device__ __forceinline__ void gate_out(const RefineArgs& a, int n, bool ok, float s, float u,
                                         float ul, float thr) {
  const bool k = ok && s <= thr;
  const float d = __fsub_rn(ul, u);
  const bool has = k && d > 0.1f;
  a.ok[n] = k;
  a.depth[n] = has ? __fmul_rn(__frcp_rn(d < 0.1f ? 0.1f : d), a.bf) : 0.f;
  a.uvr[3 * n + 2] = has ? u : -1.f;
}

template <typename Pix>
__global__ void __launch_bounds__(32 * kWarps)
refine_kernel(const RefineArgs a) {
  constexpr bool kInt = std::is_same<Pix, uint8_t>::value;
  using Acc = typename std::conditional<kInt, int, float>::type;
  __shared__ Acc s_patch[kWarps][kPatch * kPatch];
  __shared__ Acc s_strip[kWarps][kPatch * kStrip];
  __shared__ int s_part[kInt ? kWarps : 1][kOffsets][kPatch];
  __shared__ int hist[256];
  __shared__ int pick[2];
  __shared__ int s_flags;
  const Pix* img_l = static_cast<const Pix*>(a.img_l);
  const Pix* img_r = static_cast<const Pix*>(a.img_r);
  const int H = a.H, W = a.W;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n = blockIdx.x * kWarps + warp;
  const bool live = n < a.N;
  Acc* patch = s_patch[warp];
  Acc* strip = s_strip[warp];
  TC2LI_LAP_START
  pdl_wait();      // the match's outputs
  pdl_trigger();
  // a keypoint's inputs and the match's, loaded together
  bool ok = false;
  float ul = 0.f, vl = 0.f, s0 = 0.f, u = 0.f;
  if (live) {
    ul = a.xy_l[2 * n];
    vl = a.xy_l[2 * n + 1];
    const long long j = a.idx[n];
    const int b = a.best[n], sec = a.second[n];
    const bool vld = a.valid_l[n] != 0;
    // then the left patch, with the right keypoint's u and the column best
    // in flight beside its loads
    const float xr = a.xy_r[2 * j];
    const long long cb = a.colbest[j];
    const int r = centre(rintf(vl), H - 1);
    stage<kPatch>(img_l, H, W, r, centre(rintf(ul), W - 1) - kHalf, patch, lane);
    TC2LI_LAP(0);

    // the matcher's tail (ops/matching.py match_descriptors, mutual, ratio 0.9)
    ok = b <= kThHigh && vld;
    ok = ok && static_cast<float>(b) <= __fmul_rn(0.9f, static_cast<float>(sec));
    ok = ok && (static_cast<unsigned long long>(cb) & 0xFFFFFFFFull) ==
                   static_cast<unsigned long long>(n);
    float disp = __fsub_rn(ul, xr);
    disp = disp < 0.01f ? 0.01f : disp;          // torch.clamp(min=0.01); NaN stays
    const float ur0 = __fsub_rn(ul, disp);

    // subpixel_refine: centres half to even, validity before the clamp
    const float rf = rintf(vl), crf = rintf(ur0);
    ok = ok && crf >= 0.f && crf < static_cast<float>(W) && rf >= 0.f &&
         rf < static_cast<float>(H);
    const int cr = centre(crf, W - 1);
    stage<kStrip>(img_r, H, W, r, cr - kHalf - kSlide, strip, lane);
    __syncwarp();
    TC2LI_LAP(1);

    const float sad = lane_sad(patch, strip, s_part[kInt ? warp : 0], lane);
    TC2LI_LAP(2);
    float s[kOffsets];
#pragma unroll
    for (int o = 0; o < kOffsets; ++o) s[o] = __shfl_sync(kFull, sad, o);
    int arg = 0;
    float lowest = s[0];
#pragma unroll
    for (int o = 1; o < kOffsets; ++o) {
      if (s[o] < lowest) {                       // the first index of the minimum
        lowest = s[o];
        arg = o;
      }
    }
    const int bc = clampi(arg, 1, kOffsets - 2);
    float sm = s[0], sp = s[0];
    s0 = s[0];
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
    u = __fadd_rn(__fadd_rn(static_cast<float>(cr), static_cast<float>(bc - kSlide)), delta);
    ok = ok && fabsf(delta) <= 1.f;
    if (lane == 0) {
      a.ur[n] = u;
      a.sad[n] = s0;
      a.uvr[3 * n] = ul;
      a.uvr[3 * n + 1] = vl;
      gate_out(a, n, ok, s0, u, ul, __int_as_float(0x7F800000));   // thr +inf
    }
  }
  TC2LI_LAP(3);

  // publish, then count this block in with its flag in the same atomic; the
  // last block to arrive gates
  const bool lead = live && lane == 0;
  __threadfence();   // this block's outputs and SADs before its arrival
  const int not_ok = __syncthreads_or(lead && !ok) ? 1 : 0;
  if (threadIdx.x == 0) {
    const int seen = atomicAdd(a.sync, 1 + (not_ok << kArrivedBits));
    const bool last = (seen & ((1 << kArrivedBits) - 1)) == static_cast<int>(gridDim.x) - 1;
    s_flags = last ? (seen >> kArrivedBits) + not_ok : -1;
    if (last) {
      __threadfence();   // every block's SADs and outputs before the last block reads them
      *a.sync = 0;       // for the next call
    }
  }
  __syncthreads();
  TC2LI_LAP(4);
  if (s_flags != 0) return;   // not last, or a keypoint not ok: the threshold is +inf
  const int N = a.N;
  const float lo = select_kth<kInt>(a.sad, N, (N - 1) / 2, hist, pick);
  const float hi = select_kth<kInt>(a.sad, N, N / 2, hist, pick);
  const float thr = __fmul_rn(__fmul_rn(__fadd_rn(lo, hi), 0.5f), 2.1f);
  for (int i = threadIdx.x; i < N; i += blockDim.x)
    gate_out(a, i, true, __ldcg(a.sad + i), __ldcg(a.ur + i), a.xy_l[2 * i], thr);
  TC2LI_LAP(5);
}

// programmatic dependent launch of `kernel` on `stream`
template <typename K, typename... Args>
int launch_pdl(K kernel, int blocks, int threads, cudaStream_t stream, Args... args) {
  cudaLaunchAttribute at;
  at.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  at.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.stream = stream;
  cfg.attrs = &at;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, args...);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

}  // namespace

// lvl_r [M] int32, sf [n_levels] float32 -> band [M] float32, colbest [M]
// int64 (BIG << 32, the column-best buffer csrc/match.cu's mutual mode
// fills). One launch on `stream`, a programmatic dependent of the launch
// before it; returns cudaGetLastError().
extern "C" int tc2li_stereo_prep(const int* lvl_r, const float* sf, int n_levels, int M,
                                 float* band, long long* colbest, void* stream) {
  if (M <= 0) return 0;
  return launch_pdl(prep_kernel, (M + 255) / 256, 256, static_cast<cudaStream_t>(stream), lvl_r,
                    sf, n_levels, M, band, colbest);
}

// img_l, img_r [H, W] (pix_u8: uint8, 4-byte aligned, else float32); xy_l
// [N, 2], valid_l [N] uint8, xy_r [M, 2]; the match's idx [N] int64, best,
// second [N] int32 and colbest [M] int64 as csrc/match.cu wrote them.
// Outputs: ur [N], ok [N] uint8, depth [N], uvr [N, 3]; scratch sad [N]
// float32; sync [1] int32, zero (the kernel leaves it so), used by no other
// launch while this one runs (one a stream). One launch on `stream`, a
// programmatic dependent of the match; returns cudaGetLastError().
extern "C" int tc2li_stereo_refine(const void* img_l, const void* img_r, int pix_u8, int H, int W,
                                   const float* xy_l, const uint8_t* valid_l, const float* xy_r,
                                   const long long* idx, const int* best, const int* second,
                                   const long long* colbest, int N, float bf, float* ur,
                                   float* sad, uint8_t* ok, float* depth, float* uvr, int* sync,
                                   void* stream) {
  if (H < 1 || W < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (N <= 0) return 0;
  const RefineArgs a{img_l, img_r, H, W, xy_l, valid_l, xy_r, idx, best, second, colbest,
                     N, bf, ur, sad, ok, depth, uvr, sync};
  const int blocks = (N + kWarps - 1) / kWarps;
  if (blocks >= kMaxBlocks) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return pix_u8 ? launch_pdl(refine_kernel<uint8_t>, blocks, 32 * kWarps, st, a)
                : launch_pdl(refine_kernel<float>, blocks, 32 * kWarps, st, a);
}
