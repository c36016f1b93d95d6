// IMU preintegration of one window in one launch: chunks of samples
// integrated side by side, one warp a chunk, then joined in a fixed tree.
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
// and last dR = dR dRi. A sample with dt <= 0 (or NaN) changes nothing
// there; here it is left out before the chunks are cut, so the result of a
// window does not depend on where its padding lies. The bias random-walk
// block is diag(walk) times the window's total time.
//
// Bound on the H100: latency. A sample reads 28 bytes and costs ~1,500
// float operations here, a multiply-add counted as one, so a window of a
// thousand samples is well under a microsecond of either; what takes the
// time is the chain over samples, which is serial in the plain version.
// Design: the recursion is affine. Integrated from the identity, a chunk of
// samples is a map of (dR, dV, dP, C9, the bias Jacobians): the deltas
// dR_c, dV_c, dP_c and time t_c, its covariance C_c, and its transition,
// which has the block form of a sample's A, Phi_c = [[dR_c^T, 0, 0],
// [-hat(dV_c), I, 0], [-hat(dP_c), t_c I, I]] (the sum of the samples'
// R a^ R^T dt terms). Chunk 2 after chunk 1 moves into chunk 1's frame by
// D = diag(I, dR_1, dR_1): Phi' = D Phi_2 D^-1, Q' = D C_2 D^T, and
//   dR = dR_1 dR_2, dV = dV_1 + dR_1 dV_2, dP = dP_1 + dV_1 t_2 + dR_1 dP_2,
//   C9 = Phi' C_1 Phi'^T + Q', [JRg; JVg; JPg] = Phi' J_1 + D J_2 (J follows
//   C's transition: J <- A J + [-Jr dt; 0; 0]),
//   JVa = JVa_1 + dR_1 JVa_2, JPa = JPa_1 + dR_1 JPa_2,
// the last without JVa_1 t_2: the reference's JPa update (imu.py:118) lacks
// ORB-SLAM3's + JVa dt, so JPa does not follow Phi, and the join keeps that.
// A C A^T uses A's block structure [[P, 0, 0], [X, I, 0], [Y, h I, I]]
// (about a third of a dense 9x9 product).
// Layout: the live samples are compacted (a block-wide scan of dt > 0); a
// chunk takes s = max(8, ceil(n / 64)) of them, chunk j warp j % 8 of block
// j / 8 of a cluster of up to 8 blocks of 256 threads (the host launches
// min(8, ceil(N / 64)) blocks). A warp's lanes compute 32 samples' Exp and
// Jr at a time into shared memory, then every lane runs the chunk's chain
// with the same values in registers (no barrier inside a chain; C9 as its
// six upper 3x3 blocks; spreading C9's rows over the lanes with shuffles
// measured no faster, PERF.md). The tree
// joins slots (2i, 2i + 1), then (4i, 4i + 2), ... over the 64 chunk slots:
// three levels inside a block, three over the cluster's blocks in block 0
// (through distributed shared memory). The order depends only on the live
// samples, never on the number of blocks or on the padding, and there are
// no atomics: the same bits on every call.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "common.cuh"

#ifdef TC2LI_LAPS   // clock laps of a phase split (laps.cuh, tools/vi_kernels.py)
#define TC2LI_LAP_TAG imu_preint
#include "laps.cuh"
#else
#define TC2LI_LAP_START
#define TC2LI_LAP(k)
#endif

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBlocks = 8;                 // blocks of the cluster at most
constexpr int kSlots = kWarps * kMaxBlocks;   // leaves of the tree: a chunk a warp
constexpr int kMinChunk = 8;                  // samples of a chunk at least

struct Noise {
  float g2, a2, gw2, aw2;   // sigma_g^2, sigma_a^2, sigma_gw^2, sigma_aw^2
};

// one sample's terms, computed by the lanes of its chunk's warp
struct Sample {
  float dRi[9];    // Exp(w dt), row-major
  float Jrdt[9];   // Jr(w dt) dt: B's (0, 0) block
  float a[3];      // acc - ba
  float dt, ng, na;   // noise / max(dt, 1e-9)
};

// A chunk's map. C9's upper blocks 00, 01, 02, 11, 12, 22, each a full 3x3.
struct Part {
  float dR[9], dV[3], dP[3], t;
  float JRg[9], JVg[9], JPg[9], JVa[9], JPa[9];
  float C[6][9];
  int n;   // samples
};

// C = A B, C = A B^T, row-major 3x3
__device__ __forceinline__ void mm(const float* A, const float* B, float* C) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      C[3 * i + j] = A[3 * i] * B[j] + A[3 * i + 1] * B[3 + j] + A[3 * i + 2] * B[6 + j];
}

__device__ __forceinline__ void mmt(const float* A, const float* B, float* C) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      C[3 * i + j] = A[3 * i] * B[3 * j] + A[3 * i + 1] * B[3 * j + 1] + A[3 * i + 2] * B[3 * j + 2];
}

__device__ __forceinline__ void hat(const float v[3], float W[9]) {
  W[0] = 0.f;   W[1] = -v[2]; W[2] = v[1];
  W[3] = v[2];  W[4] = 0.f;   W[5] = -v[0];
  W[6] = -v[1]; W[7] = v[0];  W[8] = 0.f;
}

__device__ __forceinline__ void tr(const float* A, float* T) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) T[3 * i + j] = A[3 * j + i];
}

// so3_exp(v) and so3_right_jacobian(v) = so3_left_jacobian(-v) (geom/lie.py)
__device__ void exp_and_jr(const float v[3], float R[9], float Jr[9]) {
  const float th2 = v[0] * v[0] + v[1] * v[1] + v[2] * v[2];
  const float th = sqrtf(th2 < 1e-24f ? 1e-24f : th2);
  const float sa = tc2li::sinc(th), ca = tc2li::cosc(th), s3 = tc2li::sinc3(th);
  float W[9], W2[9], V[9], V2[9];
  const float nv[3] = {-v[0], -v[1], -v[2]};
  hat(v, W);
  mm(W, W, W2);
  hat(nv, V);
  mm(V, V, V2);
#pragma unroll
  for (int e = 0; e < 9; ++e) {
    const float I = (e % 4 == 0) ? 1.f : 0.f;
    R[e] = (I + sa * W[e]) + ca * W2[e];
    Jr[e] = (I + ca * V[e]) + s3 * V2[e];
  }
}

// Cn = A C A^T for A = [[P, 0, 0], [X, I, 0], [Y, h I, I]] and symmetric C
// (its blocks 00, 01, 02, 11, 12, 22; C10 = C01^T and so on)
__device__ __forceinline__ void acat(const float (&C)[6][9], const float* P, const float* X,
                                     const float* Y, float h, float (&Cn)[6][9]) {
  float T01[9], T02[9], T12[9];
  tr(C[1], T01);
  tr(C[2], T02);
  tr(C[4], T12);
  float M0[9], M1[9], M2[9], U[9];
  // block row 0 of M = A C: P C0j
  mm(P, C[0], M0);
  mm(P, C[1], M1);
  mm(P, C[2], M2);
  mmt(M0, P, Cn[0]);
  mmt(M0, X, U);
#pragma unroll
  for (int e = 0; e < 9; ++e) Cn[1][e] = U[e] + M1[e];
  mmt(M0, Y, U);
#pragma unroll
  for (int e = 0; e < 9; ++e) Cn[2][e] = (U[e] + h * M1[e]) + M2[e];
  // block row 1: X C0j + C1j
  mm(X, C[0], M0);
  mm(X, C[1], M1);
  mm(X, C[2], M2);
#pragma unroll
  for (int e = 0; e < 9; ++e) {
    M0[e] += T01[e];
    M1[e] += C[3][e];
    M2[e] += C[4][e];
  }
  mmt(M0, X, U);
#pragma unroll
  for (int e = 0; e < 9; ++e) Cn[3][e] = U[e] + M1[e];
  mmt(M0, Y, U);
#pragma unroll
  for (int e = 0; e < 9; ++e) Cn[4][e] = (U[e] + h * M1[e]) + M2[e];
  // block row 2: Y C0j + h C1j + C2j (only C'22 is left to compute)
  mm(Y, C[0], M0);
  mm(Y, C[1], M1);
  mm(Y, C[2], M2);
#pragma unroll
  for (int e = 0; e < 9; ++e) {
    M0[e] = (M0[e] + h * T01[e]) + T02[e];
    M1[e] = (M1[e] + h * C[3][e]) + T12[e];
    M2[e] = (M2[e] + h * C[4][e]) + C[5][e];
  }
  mmt(M0, Y, U);
#pragma unroll
  for (int e = 0; e < 9; ++e) Cn[5][e] = (U[e] + h * M1[e]) + M2[e];
}

__device__ __forceinline__ void identity(Part& p) {
#pragma unroll
  for (int e = 0; e < 9; ++e) {
    p.dR[e] = (e % 4 == 0) ? 1.f : 0.f;
    p.JRg[e] = p.JVg[e] = p.JPg[e] = p.JVa[e] = p.JPa[e] = 0.f;
  }
#pragma unroll
  for (int b = 0; b < 6; ++b)
#pragma unroll
    for (int e = 0; e < 9; ++e) p.C[b][e] = 0.f;
#pragma unroll
  for (int k = 0; k < 3; ++k) p.dV[k] = p.dP[k] = 0.f;
  p.t = 0.f;
  p.n = 0;
}

// one sample into the chunk's map (every lane the same values), in the
// plain version's order
__device__ __forceinline__ void step(Part& p, const Sample& q) {
  const float dt = q.dt, dt2 = dt * dt;
  float Ra[3], ah[9], Rah[9], RJ[9];
#pragma unroll
  for (int i = 0; i < 3; ++i)
    Ra[i] = p.dR[3 * i] * q.a[0] + p.dR[3 * i + 1] * q.a[1] + p.dR[3 * i + 2] * q.a[2];
  hat(q.a, ah);
  mm(p.dR, ah, Rah);
  mm(Rah, p.JRg, RJ);
  // A's blocks (the plain version's entries) and the noise Q = (B N) B^T
  float P[9], X[9], Y[9], B1[9], B2[9];
  tr(q.dRi, P);
#pragma unroll
  for (int e = 0; e < 9; ++e) {
    X[e] = -Rah[e] * dt;
    Y[e] = (-0.5f * Rah[e]) * dt2;
    B1[e] = p.dR[e] * dt;
    B2[e] = (0.5f * p.dR[e]) * dt2;
  }
  // position and velocity first, with the current dR; then the bias
  // Jacobians, all before the rotation update
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    p.dP[i] = (p.dP[i] + p.dV[i] * dt) + (0.5f * Ra[i]) * dt2;
    p.dV[i] = p.dV[i] + Ra[i] * dt;
  }
#pragma unroll
  for (int e = 0; e < 9; ++e) {
    p.JPa[e] = p.JPa[e] - (0.5f * p.dR[e]) * dt2;
    p.JPg[e] = (p.JPg[e] + p.JVg[e] * dt) - (0.5f * RJ[e]) * dt2;
    p.JVa[e] = p.JVa[e] - p.dR[e] * dt;
    p.JVg[e] = p.JVg[e] - RJ[e] * dt;
  }
  float Cn[6][9];
  acat(p.C, P, X, Y, dt, Cn);
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      float q00 = 0.f, q11 = 0.f, q12 = 0.f, q22 = 0.f;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        q00 += (q.Jrdt[3 * i + c] * q.ng) * q.Jrdt[3 * j + c];
        q11 += (B1[3 * i + c] * q.na) * B1[3 * j + c];
        q12 += (B1[3 * i + c] * q.na) * B2[3 * j + c];
        q22 += (B2[3 * i + c] * q.na) * B2[3 * j + c];
      }
      const int e = 3 * i + j;
      p.C[0][e] = Cn[0][e] + q00;
      p.C[1][e] = Cn[1][e];
      p.C[2][e] = Cn[2][e];
      p.C[3][e] = Cn[3][e] + q11;
      p.C[4][e] = Cn[4][e] + q12;
      p.C[5][e] = Cn[5][e] + q22;
    }
  // then JRg and last the rotation
  float T1[9], T2[9];
  mm(P, p.JRg, T1);
#pragma unroll
  for (int e = 0; e < 9; ++e) p.JRg[e] = T1[e] - q.Jrdt[e];
  mm(p.dR, q.dRi, T2);
#pragma unroll
  for (int e = 0; e < 9; ++e) p.dR[e] = T2[e];
  p.t += dt;
  p.n += 1;
}

// the index of C9's upper block (bi, bj), bi <= bj, in Part::C
__device__ __forceinline__ int blk(int bi, int bj) { return bi == 0 ? bj : (bi == 1 ? bj + 2 : 5); }

// a copy of a Part in memory (local, shared or another block's shared)
// into shared memory, a word a lane of the warp
__device__ __forceinline__ void store_part(Part* dst, const Part& src) {
  const int lane = threadIdx.x & 31;
  const float* s = reinterpret_cast<const float*>(&src);
  float* d = reinterpret_cast<float*>(dst);
  for (int e = lane; e < static_cast<int>(sizeof(Part) / 4); e += 32) d[e] = s[e];
}

// L <- L then R (R a later chunk, in shared memory; every lane the same
// values)
__device__ __noinline__ void join(Part& L, const Part& R) {
  float R1[9], P[9], hv[9], hp[9], X[9], Y[9];
#pragma unroll
  for (int e = 0; e < 9; ++e) R1[e] = L.dR[e];
  tr(R.dR, P);
  hat(R.dV, hv);
  hat(R.dP, hp);
  mm(R1, hv, X);
  mm(R1, hp, Y);
#pragma unroll
  for (int e = 0; e < 9; ++e) {
    X[e] = -X[e];
    Y[e] = -Y[e];
  }
  const float h = R.t;
  // the Jacobians, from L's old values: J = Phi' J_1 + D J_2
  float a[9], b[9], c[9], d[9];
  mm(P, L.JRg, a);
  mm(X, L.JRg, b);
  mm(Y, L.JRg, c);
#pragma unroll
  for (int e = 0; e < 9; ++e) {
    b[e] += L.JVg[e];
    c[e] = (c[e] + h * L.JVg[e]) + L.JPg[e];
    L.JRg[e] = a[e] + R.JRg[e];
  }
  mm(R1, R.JVg, a);
  mm(R1, R.JPg, d);
#pragma unroll
  for (int e = 0; e < 9; ++e) {
    L.JVg[e] = b[e] + a[e];
    L.JPg[e] = c[e] + d[e];
  }
  // the accelerometer Jacobians: rotated, JPa without JVa_1 t_2 (the reference's)
  mm(R1, R.JVa, a);
  mm(R1, R.JPa, b);
#pragma unroll
  for (int e = 0; e < 9; ++e) {
    L.JVa[e] += a[e];
    L.JPa[e] += b[e];
  }
  // C9 = Phi' C_1 Phi'^T + D C_2 D^T, D = diag(I, R1, R1)
  float Cn[6][9];
  acat(L.C, P, X, Y, h, Cn);
  float Q[9];
#pragma unroll
  for (int e = 0; e < 9; ++e) Cn[0][e] += R.C[0][e];
  mmt(R.C[1], R1, Q);
#pragma unroll
  for (int e = 0; e < 9; ++e) Cn[1][e] += Q[e];
  mmt(R.C[2], R1, Q);
#pragma unroll
  for (int e = 0; e < 9; ++e) Cn[2][e] += Q[e];
#pragma unroll
  for (int b2 = 3; b2 < 6; ++b2) {
    mm(R1, R.C[b2], a);
    mmt(a, R1, Q);
#pragma unroll
    for (int e = 0; e < 9; ++e) Cn[b2][e] += Q[e];
  }
#pragma unroll
  for (int b2 = 0; b2 < 6; ++b2)
#pragma unroll
    for (int e = 0; e < 9; ++e) L.C[b2][e] = Cn[b2][e];
  // the deltas
  float v[3], pp[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    v[i] = R1[3 * i] * R.dV[0] + R1[3 * i + 1] * R.dV[1] + R1[3 * i + 2] * R.dV[2];
    pp[i] = R1[3 * i] * R.dP[0] + R1[3 * i + 1] * R.dP[1] + R1[3 * i + 2] * R.dP[2];
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    L.dP[i] = (L.dP[i] + L.dV[i] * h) + pp[i];
    L.dV[i] = L.dV[i] + v[i];
  }
  mm(R1, R.dR, a);
#pragma unroll
  for (int e = 0; e < 9; ++e) L.dR[e] = a[e];
  L.t = L.t + h;
  L.n = L.n + R.n;
}

// one level of the tree over slots[0 .. n): warp w joins slot w + span into
// slot w where w % (2 span) == 0; a block barrier after
__device__ __forceinline__ void tree_level(Part* slots, int n, int span) {
  const int warp = threadIdx.x >> 5;
  const int w = warp * 2 * span;
  if (w + span < n && slots[w + span].n > 0) {
    Part L = slots[w];
    join(L, slots[w + span]);
    __syncwarp();
    store_part(&slots[w], L);
  }
  __syncthreads();
}

struct Smem {
  Sample smp[kWarps][32];   // a warp's batch of samples
  Part slot[kWarps];        // the block's chunks, then its tree
  Part xslot[kMaxBlocks];   // block 0: the blocks' results, then their tree
  int wsum[kWarps];
  int n_live;
};

__global__ void __launch_bounds__(kThreads, 1)
imu_preint_kernel(const float* __restrict__ gyro, const float* __restrict__ acc,
                  const float* __restrict__ dts, const float* __restrict__ bg,
                  const float* __restrict__ ba, int N, Noise nz, float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  int* src = reinterpret_cast<int*>(smem_raw + sizeof(Smem));   // [kWarps * s]: live sample ids
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int nblocks = static_cast<int>(cluster.num_blocks());
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  TC2LI_LAP_START

  // the live samples: their count, then the ids of this block's share in order
  int cnt = 0;
  for (int i = tid; i < N; i += kThreads) cnt += dts[i] > 0.f;   // (a NaN dt is padding)
  cnt = __reduce_add_sync(0xffffffffu, cnt);
  if (lane == 0) sm.wsum[warp] = cnt;
  __syncthreads();
  int n_live = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) n_live += sm.wsum[w];
  const int s = max(kMinChunk, (n_live + kSlots - 1) / kSlots);
  const int lo = rank * kWarps * s, hi = min(lo + kWarps * s, n_live);
  for (int base = 0, done = 0; base < N && done < hi; base += kThreads) {
    __syncthreads();   // sm.wsum is read
    const int i = base + tid;
    const bool live = i < N && dts[i] > 0.f;
    const unsigned bal = __ballot_sync(0xffffffffu, live);
    if (lane == 0) sm.wsum[warp] = __popc(bal);
    __syncthreads();
    int before = done, tile = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      before += w < warp ? sm.wsum[w] : 0;
      tile += sm.wsum[w];
    }
    const int c = before + __popc(bal & ((1u << lane) - 1u));
    if (live && c >= lo && c < hi) src[c - lo] = i;
    done += tile;
  }
  __syncthreads();
  TC2LI_LAP(0);

  // this warp's chunk, from the identity, 32 samples' terms at a time
  const float b_g[3] = {bg[0], bg[1], bg[2]}, b_a[3] = {ba[0], ba[1], ba[2]};
  const int c0 = lo + warp * s, n_mine = max(0, min(s, hi - c0));
  Part p;
  identity(p);
  for (int base = 0; base < n_mine; base += 32) {
    if (base + lane < n_mine) {
      const int i = src[warp * s + base + lane];
      Sample& q = sm.smp[warp][lane];
      const float dt = dts[i];
      float w[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        w[k] = (gyro[3 * i + k] - b_g[k]) * dt;
        q.a[k] = acc[3 * i + k] - b_a[k];
      }
      float Jr[9];
      exp_and_jr(w, q.dRi, Jr);
#pragma unroll
      for (int e = 0; e < 9; ++e) q.Jrdt[e] = Jr[e] * dt;
      q.dt = dt;
      const float dc = dt < 1e-9f ? 1e-9f : dt;
      q.ng = nz.g2 / dc;
      q.na = nz.a2 / dc;
    }
    __syncwarp();
    TC2LI_LAP(1);
    const int m = min(32, n_mine - base);
    for (int k = 0; k < m; ++k) step(p, sm.smp[warp][k]);
    __syncwarp();
    TC2LI_LAP(2);
  }
  if (lane == 0) sm.slot[warp] = p;
  __syncthreads();
  TC2LI_LAP(2);

  // the tree: the block's chunks, then the blocks' results in block 0
#pragma unroll
  for (int span = 1; span < kWarps; span *= 2) tree_level(sm.slot, kWarps, span);
  TC2LI_LAP(3);
  if (nblocks > 1) {
    cluster.sync();   // every block's result is ready
    if (rank == 0 && warp < nblocks)
      store_part(&sm.xslot[warp], *cluster.map_shared_rank(&sm.slot[0], warp));
    cluster.sync();   // block 0 holds them: the others may leave
    if (rank != 0) return;
    for (int span = 1; span < nblocks; span *= 2) tree_level(sm.xslot, nblocks, span);
  }
  TC2LI_LAP(4);

  const Part& r = nblocks > 1 ? sm.xslot[0] : sm.slot[0];
  for (int e = tid; e < 60; e += kThreads) {
    float v;
    if (e < 9) v = r.dR[e];
    else if (e < 12) v = r.dV[e - 9];
    else if (e < 15) v = r.dP[e - 12];
    else if (e < 24) v = r.JRg[e - 15];
    else if (e < 33) v = r.JVg[e - 24];
    else if (e < 42) v = r.JVa[e - 33];
    else if (e < 51) v = r.JPg[e - 42];
    else v = r.JPa[e - 51];
    out[e] = v;
  }
  // C [15, 15]: C9 from its upper blocks, diag(walk t), zeros
  for (int e = tid; e < 225; e += kThreads) {
    const int i = e / 15, j = e % 15;
    float v = 0.f;
    if (i < 9 && j < 9) {   // the upper block and its entry
      const int b = blk(min(i, j) / 3, max(i, j) / 3);
      v = i / 3 <= j / 3 ? r.C[b][3 * (i % 3) + j % 3] : r.C[b][3 * (j % 3) + i % 3];
    } else if (i == j) {
      v = (i < 12 ? nz.gw2 : nz.aw2) * r.t;
    }
    out[60 + e] = v;
  }
  if (tid == 0) out[285] = r.t;
  TC2LI_LAP(5);
}

// the chunk size and the shared memory of a launch over N samples
int chunk_bound(int N) { return max(kMinChunk, (N + kSlots - 1) / kSlots); }
size_t smem_bytes(int N) { return sizeof(Smem) + sizeof(int) * kWarps * chunk_bound(N); }

}  // namespace

// gyro, acc [N, 3], dts [N], bg, ba [3] float32; out [286] float32: dR [3, 3],
// dV, dP [3], JRg, JVg, JVa, JPg, JPa [3, 3], C [15, 15], dt; all contiguous
// on the device. The noise terms are the squared sigmas. One launch of a
// cluster of min(8, ceil(N / 64)) blocks on `stream`; returns the first CUDA
// error code that is not cudaSuccess.
extern "C" int tc2li_imu_preintegrate(const float* gyro, const float* acc, const float* dts,
                                      const float* bg, const float* ba, int N, float g2, float a2,
                                      float gw2, float aw2, float* out, void* stream) {
  if (N < 0) return static_cast<int>(cudaErrorInvalidValue);
  const Noise nz{g2, a2, gw2, aw2};
  // chunks of at least kMinChunk live samples, kWarps a block
  const int blocks = max(1, min(kMaxBlocks, (N + kWarps * kMinChunk - 1) / (kWarps * kMinChunk)));
  const size_t smem = smem_bytes(N);
  int rc = static_cast<int>(cudaFuncSetAttribute(
      imu_preint_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)));
  if (rc != 0) return rc;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = blocks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  rc = static_cast<int>(cudaLaunchKernelEx(&cfg, imu_preint_kernel, gyro, acc, dts, bg, ba, N,
                                           nz, out));
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
