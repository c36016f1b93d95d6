// IMU preintegration of one window, the whole chain over its samples in one
// launch.
//
// Replaces tc2li_slam_tpu/estimation/imu.py:83 (integrate): on the TPU one
// jit-compiled program whose samples are a lax.scan (:169). Eager PyTorch
// ran it as ~40 small ops a sample (estimation/imu.integrate), each a launch.
//
// What it computes is the plain version's (ops/kernels/imu_preint.py:
// integrate_plain): for every sample with dt > 0, at the linearization
// biases, w = gyro - bg and a = acc - ba, dRi = Exp(w dt), Jr = Jr(w dt);
// then, in sample order, dP and dV with the current dR, the five bias
// Jacobians (JPa, JPg, JVa, JVg, all before the rotation), the (dR, dV, dP)
// covariance C9 = A C9 A^T + (B N) B^T of the discrete A / B form, then JRg
// and last dR = dR dRi. A sample with dt <= 0 integrates w = a = 0 over
// dt = 0: dRi = Jr = I exactly, A = I and B = 0, so it changes nothing.
// The bias random-walk block is diag(walk) times the window's total time.
//
// Bound on the H100: latency. A sample reads 28 bytes and costs ~2,500
// float operations, a multiply-add counted as one (1,458 of them the two
// 9x9 products of the covariance, 540 (B N) B^T), so a window of a thousand
// samples is well under a microsecond of either; the chain over samples is
// serial.
// Design: one block of 256 threads. For a chunk of 256 samples each thread
// computes one sample's dRi, Jr, a and noise terms into shared memory (and
// adds its dt to its share of the total time); then warp 0 runs the chain
// over the chunk. Every lane of warp 0 holds dR, dV, dP and the five
// Jacobians in registers (each computes the same values); the 81 entries of
// C9 are three a lane on lanes 0..26, A and B are written to shared memory
// a step, and the product runs in the plain version's order: M = A C9, then
// M A^T and (B N) B^T, added. No atomics: the same bits on every call.

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;   // samples of a chunk: one a thread

// one sample's terms, computed in parallel before the chain
struct Sample {
  float dRiT[9];   // Exp(w dt)^T, row-major: A's (0, 0) block
  float dRi[9];
  float Jrdt[9];   // Jr(w dt) dt: B's (0, 0) block
  float a[3];      // acc - ba (0 for a padded sample)
  float dt, ng, na;   // dt (0 for padding), noise / max(dt, 1e-9)
};

struct Noise {
  float g2, a2, gw2, aw2;   // sigma_g^2, sigma_a^2, sigma_gw^2, sigma_aw^2
};

// W = hat(v) and W2 = W W (geom/lie.py hat and the dense 3x3 product)
__device__ __forceinline__ void hat_sq(const float v[3], float W[9], float W2[9]) {
  W[0] = 0.f;   W[1] = -v[2]; W[2] = v[1];
  W[3] = v[2];  W[4] = 0.f;   W[5] = -v[0];
  W[6] = -v[1]; W[7] = v[0];  W[8] = 0.f;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      W2[3 * i + j] = W[3 * i] * W[j] + W[3 * i + 1] * W[3 + j] + W[3 * i + 2] * W[6 + j];
}

// so3_exp(v) and so3_right_jacobian(v) = so3_left_jacobian(-v) (geom/lie.py)
__device__ void exp_and_jr(const float v[3], float R[9], float Jr[9]) {
  const float th2 = v[0] * v[0] + v[1] * v[1] + v[2] * v[2];
  const float th = sqrtf(th2 < 1e-24f ? 1e-24f : th2);
  const float sa = tc2li::sinc(th), ca = tc2li::cosc(th), s3 = tc2li::sinc3(th);
  float W[9], W2[9];
  hat_sq(v, W, W2);
  const float nv[3] = {-v[0], -v[1], -v[2]};
  float V[9], V2[9];
  hat_sq(nv, V, V2);
#pragma unroll
  for (int e = 0; e < 9; ++e) {
    const float I = (e % 4 == 0) ? 1.f : 0.f;
    R[e] = (I + sa * W[e]) + ca * W2[e];
    Jr[e] = (I + ca * V[e]) + s3 * V2[e];
  }
}

__device__ __forceinline__ void mat3(const float* A, const float* B, float* C) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      C[3 * i + j] = A[3 * i] * B[j] + A[3 * i + 1] * B[3 + j] + A[3 * i + 2] * B[6 + j];
}

__global__ void __launch_bounds__(kThreads, 1)
imu_preint_kernel(const float* __restrict__ gyro, const float* __restrict__ acc,
                  const float* __restrict__ dts, const float* __restrict__ bg,
                  const float* __restrict__ ba, int N, Noise nz, float* __restrict__ out) {
  __shared__ Sample smp[kThreads];
  __shared__ float sA[81];   // A [9, 9]: its fixed entries set once, the rest a step
  __shared__ float sB[54];   // B [9, 6]
  __shared__ float sC[81];   // C9
  __shared__ float sM[81];   // A C9
  __shared__ float tpart[kThreads / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float b_g[3] = {bg[0], bg[1], bg[2]}, b_a[3] = {ba[0], ba[1], ba[2]};
  for (int e = tid; e < 81; e += kThreads) {
    const int i = e / 9, j = e % 9;
    // the identity blocks (1, 1), (2, 2) and zeros; the rest is set a step
    sA[e] = (i == j && i >= 3) ? 1.f : 0.f;
    sC[e] = 0.f;
  }
  for (int e = tid; e < 54; e += kThreads) sB[e] = 0.f;

  // warp 0's chain state (every lane the same values)
  float dR[9] = {1.f, 0.f, 0.f, 0.f, 1.f, 0.f, 0.f, 0.f, 1.f};
  float dV[3] = {0.f, 0.f, 0.f}, dP[3] = {0.f, 0.f, 0.f};
  float JRg[9], JVg[9], JVa[9], JPg[9], JPa[9];
#pragma unroll
  for (int e = 0; e < 9; ++e) JRg[e] = JVg[e] = JVa[e] = JPg[e] = JPa[e] = 0.f;
  float creg[3] = {0.f, 0.f, 0.f};   // lane's C9 entries lane, lane + 27, lane + 54
  float t_mine = 0.f;                // this thread's share of the total time

  for (int base = 0; base < N; base += kThreads) {
    __syncthreads();   // the previous chunk's chain is done with smp
    const int s = base + tid;
    if (s < N) {
      Sample& q = smp[tid];
      const float d = dts[s];
      const bool act = d > 0.f;   // (a NaN dt is padding too)
      const float dt = act ? d : 0.f;
      float w[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        w[k] = (act ? gyro[3 * s + k] - b_g[k] : 0.f) * dt;
        q.a[k] = act ? acc[3 * s + k] - b_a[k] : 0.f;
      }
      float R[9], Jr[9];
      exp_and_jr(w, R, Jr);
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          q.dRi[3 * i + j] = R[3 * i + j];
          q.dRiT[3 * i + j] = R[3 * j + i];
          q.Jrdt[3 * i + j] = Jr[3 * i + j] * dt;
        }
      q.dt = dt;
      const float dc = dt < 1e-9f ? 1e-9f : dt;
      q.ng = nz.g2 / dc;
      q.na = nz.a2 / dc;
      t_mine += dt;
    }
    __syncthreads();
    if (warp != 0) continue;
    const int n_chunk = min(kThreads, N - base);
    for (int k = 0; k < n_chunk; ++k) {
      const Sample& q = smp[k];
      const float dt = q.dt, dt2 = dt * dt;
      float Ra[3], ah[9], Rah[9], RJ[9];
#pragma unroll
      for (int i = 0; i < 3; ++i)
        Ra[i] = dR[3 * i] * q.a[0] + dR[3 * i + 1] * q.a[1] + dR[3 * i + 2] * q.a[2];
      ah[0] = 0.f;     ah[1] = -q.a[2]; ah[2] = q.a[1];
      ah[3] = q.a[2];  ah[4] = 0.f;     ah[5] = -q.a[0];
      ah[6] = -q.a[1]; ah[7] = q.a[0];  ah[8] = 0.f;
      mat3(dR, ah, Rah);
      mat3(Rah, JRg, RJ);
      // A's and B's entries of this step, each lane its share (sA and sB
      // were last read before the previous step's final __syncwarp)
#pragma unroll
      for (int e = 0; e < 9; ++e) {
        const int i = e / 3, j = e % 3;
        const int slot = e * 6;   // six entries a 3x3 position, spread over the lanes
        if (lane == (slot & 31)) sA[9 * i + j] = q.dRiT[e];                          // (0, 0)
        if (lane == ((slot + 1) & 31)) sA[9 * (3 + i) + j] = -Rah[e] * dt;            // (1, 0)
        if (lane == ((slot + 2) & 31)) sA[9 * (6 + i) + j] = (-0.5f * Rah[e]) * dt2;  // (2, 0)
        if (lane == ((slot + 3) & 31)) sB[6 * i + j] = q.Jrdt[e];                     // (0, 0)
        if (lane == ((slot + 4) & 31)) sB[6 * (3 + i) + 3 + j] = dR[e] * dt;          // (1, 1)
        if (lane == ((slot + 5) & 31)) sB[6 * (6 + i) + 3 + j] = (0.5f * dR[e]) * dt2;  // (2, 1)
      }
      if (lane < 3) sA[9 * (6 + lane) + 3 + lane] = dt;   // (2, 1): I dt
      // position and velocity first, with the current dR; then the bias
      // Jacobians, all before the rotation update
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        dP[i] = (dP[i] + dV[i] * dt) + (0.5f * Ra[i]) * dt2;
        dV[i] = dV[i] + Ra[i] * dt;
      }
#pragma unroll
      for (int e = 0; e < 9; ++e) {
        JPa[e] = JPa[e] - (0.5f * dR[e]) * dt2;
        JPg[e] = (JPg[e] + JVg[e] * dt) - (0.5f * RJ[e]) * dt2;
        JVa[e] = JVa[e] - dR[e] * dt;
        JVg[e] = JVg[e] - RJ[e] * dt;
      }
      __syncwarp();
      // M = A C9
      if (lane < 27) {
#pragma unroll
        for (int r = 0; r < 3; ++r) {
          const int e = lane + 27 * r, i = e / 9, j = e % 9;
          float m = 0.f;
#pragma unroll
          for (int c = 0; c < 9; ++c) m += sA[9 * i + c] * sC[9 * c + j];
          sM[e] = m;
        }
      }
      __syncwarp();
      // C9 = M A^T + (B N) B^T
      if (lane < 27) {
        const float nv[6] = {q.ng, q.ng, q.ng, q.na, q.na, q.na};
#pragma unroll
        for (int r = 0; r < 3; ++r) {
          const int e = lane + 27 * r, i = e / 9, j = e % 9;
          float m = 0.f, b = 0.f;
#pragma unroll
          for (int c = 0; c < 9; ++c) m += sM[9 * i + c] * sA[9 * j + c];
#pragma unroll
          for (int c = 0; c < 6; ++c) b += (sB[6 * i + c] * nv[c]) * sB[6 * j + c];
          creg[r] = m + b;
        }
      }
      __syncwarp();
      if (lane < 27) {
#pragma unroll
        for (int r = 0; r < 3; ++r) sC[lane + 27 * r] = creg[r];
      }
      // then JRg and last the rotation
      float T1[9], T2[9];
      mat3(q.dRiT, JRg, T1);
#pragma unroll
      for (int e = 0; e < 9; ++e) JRg[e] = T1[e] - q.Jrdt[e];
      mat3(dR, q.dRi, T2);
#pragma unroll
      for (int e = 0; e < 9; ++e) dR[e] = T2[e];
      __syncwarp();
    }
  }

  // the total time: each thread's share, the lanes by a fixed shuffle tree,
  // the warps in order
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) t_mine += __shfl_xor_sync(0xffffffffu, t_mine, o);
  __syncthreads();
  if (lane == 0) tpart[warp] = t_mine;
  __syncthreads();
  if (warp != 0) return;
  float t_total = 0.f;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) t_total += tpart[w];
  if (lane == 0) {
#pragma unroll
    for (int e = 0; e < 9; ++e) {
      out[e] = dR[e];
      out[15 + e] = JRg[e];
      out[24 + e] = JVg[e];
      out[33 + e] = JVa[e];
      out[42 + e] = JPg[e];
      out[51 + e] = JPa[e];
    }
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      out[9 + i] = dV[i];
      out[12 + i] = dP[i];
    }
    out[285] = t_total;
  }
  // C [15, 15]: C9, diag(walk t_total), zeros
  for (int e = lane; e < 225; e += 32) {
    const int i = e / 15, j = e % 15;
    float v = 0.f;
    if (i < 9 && j < 9) {
      v = sC[9 * i + j];
    } else if (i == j) {
      v = (i < 12 ? nz.gw2 : nz.aw2) * t_total;
    }
    out[60 + e] = v;
  }
}

}  // namespace

// gyro, acc [N, 3], dts [N], bg, ba [3] float32; out [286] float32: dR [3, 3],
// dV, dP [3], JRg, JVg, JVa, JPg, JPa [3, 3], C [15, 15], dt; all contiguous
// on the device. The noise terms are the squared sigmas. Launches on
// `stream`, returns the first CUDA error code that is not cudaSuccess.
extern "C" int tc2li_imu_preintegrate(const float* gyro, const float* acc, const float* dts,
                                      const float* bg, const float* ba, int N, float g2, float a2,
                                      float gw2, float aw2, float* out, void* stream) {
  const Noise nz{g2, a2, gw2, aw2};
  imu_preint_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      gyro, acc, dts, bg, ba, N < 0 ? 0 : N, nz, out);
  return static_cast<int>(cudaGetLastError());
}
