// The BALM eigen-factor's cost, exact gradient and Hessian over the window's
// LiDAR pose tangents, in one launch.
//
// Replaces tc2li_slam_tpu/solver/balm.py:303 (quadratic): on the TPU a
// jit-compiled jax.hessian of the closed-form cost sum_v N_v lambda_min(cov_v)
// (eigen_cost, :274) through _cost_of_tangent (:289); eager PyTorch ran it
// as torch.func.hessian, hundreds of small ops a call.
//
// What it computes is the plain version's (ops/kernels/balm.py:
// quadratic_plain): with right tangents xi_w = (rho, phi) of se3_exp at 0,
// T_w' = T_w exp(xi_w), the cost, g = dcost/dxi [6W] and H [6W, 6W]. The
// derivatives are written out in closed form, in local tangents through the
// world axes u_i = R_w e_i. To second order, exp(xi) gives
// R' = R (I + phi^ + phi^2 / 2) and t' = t + R (rho + phi x rho / 2), so a
// cluster's voxel-centred mean m_w = R mean + t - center moves by
// D = u_k for rho_k and D = u_i x M (M = R mean) for phi_i, with second
// derivatives (u_i x u_j) / 2 for (phi_i, rho_j) and
// (u_i mean_j + u_j mean_i - 2 M delta_ij) / 2 for (phi_i, phi_j); its
// rotated scatter Q = R Pc R^T moves by U_i Q + Q U_i^T (U_i = hat(u_i)),
// second (U_i Q U_j^T + U_j Q U_i^T) + sym((U_i U_j + U_j U_i) Q / 2). The
// covariance C = sum_w P_w / n - mu mu^T then has
//   dC_p = dQ_p / n + (N_w / n) (D_p d_w^T + d_w D_p^T),  d_w = m_w - mu,
//   d2C_pq = [a = b] (d2Q / n + (N_a / n) (D2 d^T + d D2^T + D_p D_q^T + D_q D_p^T))
//            - (N_a N_b / n^2) (D_p D_q^T + D_q D_p^T).
// lambda_min of C is the trigonometric closed form of ops/plane_fit.py
// smallest_eigval_sym3, its arccos clip and its p floor included; its
// gradient and Hessian with respect to C's six entries come from second-order
// forward-mode arithmetic (a value, 6 first and 21 second derivatives) on one
// thread. Then g_p = grad . dC_p and H_pq = grad . d2C_pq + dC_p^T Hess dC_q,
// each weighted by valid_v * N_v. An invalid voxel adds nothing (the
// reference gives it a fixed spectrum and the weight 0).
//
// Bound on the H100: neither bytes (160 KB in at V 512, W 6) nor operations
// (~2.5 M a call); latency: the eigenvalue jet of a voxel and the sum over
// the voxels. Design: two launches. The first gives each chunk of 4 voxel
// slots a block and each valid voxel two warps, all at once (an invalid one
// does no work): its per-pose moments one lane a pose, its covariance on
// every lane, the jet with lane t < 21 carrying second derivative t and every
// lane the value and the gradient (so no lane waits for another; each warp
// has its own), its 6W derivative rows and 9W pose terms over the lanes; the
// voxel's factors (dC_p, Hess dC_q, D_p, Lambda D_q, the gradient row, the
// pose-diagonal terms, N_w, n, the weight) stay in the block's shared
// memory. H is a sum of products over the voxels: the rank-6
// dC_p^T Hess dC_q, the rank-3 cross-pose term and the pose-diagonal rest;
// the block's threads add each entry's terms of the chunk's valid voxels in
// slot order and write the chunk's partial sums. The second launch gives
// each block 32 entries, a lane an entry, and each of its 32 warps a fixed
// run of chunks: a lane adds its entry's partial sums of the run's chunks in
// order, then warp 0 adds the 32 runs in order. Each launch is a
// programmatic dependent of the kernel before it, so its blocks are resident
// when that one ends. No float atomics, no block waits for another: the same
// inputs give the same bits on every call.

#include <cuda_runtime.h>
#include <stdint.h>

#ifndef TC2LI_LAP   // clock stamps and laps of a phase split (tools/balm_kernels.py)
#define TC2LI_STAMP(k)
#define TC2LI_LAP_START
#define TC2LI_LAP(k)
#endif

namespace {

constexpr int kMaxW = 16;
constexpr int kChunk = 4;          // first launch: voxel slots a block (a chunk),
constexpr int kWarpsPerVox = 2;    // ... warps a slot (each its own jet; the rows split)
constexpr int kVoxWarps = kChunk * kWarpsPerVox;
constexpr int kGroups = 32;        // second launch: chunk groups an entry's sum runs over
constexpr int kUnroll = 4;         // ... chunks a warp loads at once
constexpr int kWarpFloats = 16 * (3 + 3 + 9 + 1 + 3) + 36;   // a warp's moments, d, Hess

// a voxel's factors in the first launch's shared memory, floats from its
// start (16-byte aligned: read as float4)
struct Fac {
  int Nw, dC, Tq, Dv, LD, gp, Kpp, Kpr, stride;
};

__host__ __device__ inline Fac fac_layout(int W) {
  const int D = 6 * W;
  Fac f;
  f.Nw = 4;   // [0] weight valid * N_tot, [1] n, [2] lambda_min, [3] unused
  f.dC = f.Nw + ((W + 3) & ~3);   // [D][8] (6 used)
  f.Tq = f.dC + 8 * D;            // [D][8] Hess dC_q
  f.Dv = f.Tq + 8 * D;            // [D][4] dm / dxi_p
  f.LD = f.Dv + 4 * D;            // [D][4] Lambda D_q
  f.gp = f.LD + 4 * D;            // [D] gradient rows
  f.Kpp = f.gp + ((D + 3) & ~3);  // [W][9] (phi_i, phi_j) pose terms
  f.Kpr = f.Kpp + 9 * W;          // [W][9] (phi_i, rho_j)
  f.stride = (f.Kpr + 9 * W + 3) & ~3;
  return f;
}

// A second-order jet in the six entries of C, one lane's share: the value
// and the gradient (the same on every lane), the Hessian entry (i, j) of the
// lane, and the gradient's entries i and j carried beside it (gi, gj: the
// Hessian's product rule reads them without indexing the gradient)
struct Jet {
  float v;
  float g[6];
  float h, gi, gj;
};

__device__ Jet jvar(float x, int k, int i, int j) {
  Jet a;
  a.v = x;
#pragma unroll
  for (int m = 0; m < 6; ++m) a.g[m] = m == k ? 1.f : 0.f;
  a.h = 0.f;
  a.gi = i == k ? 1.f : 0.f;
  a.gj = j == k ? 1.f : 0.f;
  return a;
}

__device__ Jet jconst(float v) {
  Jet o;
  o.v = v;
#pragma unroll
  for (int m = 0; m < 6; ++m) o.g[m] = 0.f;
  o.h = o.gi = o.gj = 0.f;
  return o;
}

__device__ Jet jadd(const Jet& a, const Jet& b) {
  Jet o;
  o.v = a.v + b.v;
#pragma unroll
  for (int m = 0; m < 6; ++m) o.g[m] = a.g[m] + b.g[m];
  o.h = a.h + b.h;
  o.gi = a.gi + b.gi;
  o.gj = a.gj + b.gj;
  return o;
}

__device__ Jet jsub(const Jet& a, const Jet& b) {
  Jet o;
  o.v = a.v - b.v;
#pragma unroll
  for (int m = 0; m < 6; ++m) o.g[m] = a.g[m] - b.g[m];
  o.h = a.h - b.h;
  o.gi = a.gi - b.gi;
  o.gj = a.gj - b.gj;
  return o;
}

__device__ Jet jscale(const Jet& a, float s) {
  Jet o;
  o.v = a.v * s;
#pragma unroll
  for (int m = 0; m < 6; ++m) o.g[m] = a.g[m] * s;
  o.h = a.h * s;
  o.gi = a.gi * s;
  o.gj = a.gj * s;
  return o;
}

__device__ Jet jmul(const Jet& a, const Jet& b) {
  Jet o;
  o.v = a.v * b.v;
#pragma unroll
  for (int m = 0; m < 6; ++m) o.g[m] = a.g[m] * b.v + b.g[m] * a.v;
  o.h = a.h * b.v + b.h * a.v + (a.gi * b.gj + a.gj * b.gi);
  o.gi = a.gi * b.v + b.gi * a.v;
  o.gj = a.gj * b.v + b.gj * a.v;
  return o;
}

// phi(a) from phi, phi', phi'' at a.v
__device__ Jet jfn(const Jet& a, float f0, float f1, float f2) {
  Jet o;
  o.v = f0;
#pragma unroll
  for (int m = 0; m < 6; ++m) o.g[m] = f1 * a.g[m];
  o.h = f1 * a.h + f2 * (a.gi * a.gj);
  o.gi = f1 * a.gi;
  o.gj = f1 * a.gj;
  return o;
}

// smallest_eigval_sym3 of the symmetric matrix with entries
// c = (C00, C11, C22, C01, C02, C12), as a jet in c; (i, j) the lane's
// Hessian entry. Every branch is uniform: the value is the same on all lanes.
__device__ Jet lambda_min_jet(const float* c, int i, int j) {
  Jet x0 = jvar(c[0], 0, i, j), x1 = jvar(c[1], 1, i, j), x2 = jvar(c[2], 2, i, j);
  Jet x3 = jvar(c[3], 3, i, j), x4 = jvar(c[4], 4, i, j), x5 = jvar(c[5], 5, i, j);
  const Jet q = jscale(jadd(jadd(x0, x1), x2), 1.f / 3.f);
  x0 = jsub(x0, q);
  x1 = jsub(x1, q);
  x2 = jsub(x2, q);
  Jet p2 = jadd(jadd(jmul(x0, x0), jmul(x1, x1)), jmul(x2, x2));
  p2 = jadd(p2, jscale(jadd(jadd(jmul(x3, x3), jmul(x4, x4)), jmul(x5, x5)), 2.f));
  p2 = jscale(p2, 1.f / 6.f);
  Jet p;
  if (p2.v < 1e-30f) {   // jnp.maximum(p2, 1e-30): constant below the floor
    p = jconst(sqrtf(1e-30f));
  } else {
    const float sp = sqrtf(p2.v);
    p = jfn(p2, sp, 0.5f / sp, -0.25f / (sp * sp * sp));
  }
  const float ipv = 1.f / p.v;
  const Jet ip = jfn(p, ipv, -ipv * ipv, 2.f * ipv * ipv * ipv);
  x0 = jmul(x0, ip);
  x1 = jmul(x1, ip);
  x2 = jmul(x2, ip);
  x3 = jmul(x3, ip);
  x4 = jmul(x4, ip);
  x5 = jmul(x5, ip);
  // det(B) / 2 of the symmetric B
  Jet det = jmul(jmul(x0, x1), x2);
  det = jadd(det, jscale(jmul(jmul(x3, x4), x5), 2.f));
  det = jsub(det, jmul(x0, jmul(x5, x5)));
  det = jsub(det, jmul(x1, jmul(x4, x4)));
  det = jsub(det, jmul(x2, jmul(x3, x3)));
  const Jet r = jscale(det, 0.5f);
  const float lo = -1.f + 1e-6f, hi = 1.f - 1e-6f;
  Jet phi;
  if (r.v < lo || r.v > hi) {   // the clip: constant outside
    phi = jconst(acosf(r.v < lo ? lo : hi) / 3.f);
  } else {
    const float s = 1.f - r.v * r.v;
    const float rs = sqrtf(s);
    phi = jscale(jfn(r, acosf(r.v), -1.f / rs, -r.v / (s * rs)), 1.f / 3.f);
  }
  const float arg = phi.v + 2.f * 3.14159265358979323846f / 3.f;
  const Jet cs = jfn(phi, cosf(arg), -sinf(arg), -cosf(arg));
  return jadd(q, jscale(jmul(p, cs), 2.f));
}

__device__ __forceinline__ void cross3(const float* a, const float* b, float* o) {
  o[0] = a[1] * b[2] - a[2] * b[1];
  o[1] = a[2] * b[0] - a[0] * b[2];
  o[2] = a[0] * b[1] - a[1] * b[0];
}

__device__ __forceinline__ float dot3(const float* a, const float* b) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

// hat(u) as a row-major 3x3
__device__ __forceinline__ void hat3(const float* u, float* U) {
  U[0] = 0.f; U[1] = -u[2]; U[2] = u[1];
  U[3] = u[2]; U[4] = 0.f; U[5] = -u[0];
  U[6] = -u[1]; U[7] = u[0]; U[8] = 0.f;
}

__device__ __forceinline__ void mm3(const float* A, const float* B, float* O) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      O[3 * i + j] = A[3 * i] * B[j] + A[3 * i + 1] * B[3 + j] + A[3 * i + 2] * B[6 + j];
}

// the symmetric 3x3 X + X^T as its six entries (00, 11, 22, 01, 02, 12)
__device__ __forceinline__ void sym6_of_sum(const float* X, float* o) {
  o[0] = 2.f * X[0];
  o[1] = 2.f * X[4];
  o[2] = 2.f * X[8];
  o[3] = X[1] + X[3];
  o[4] = X[2] + X[6];
  o[5] = X[5] + X[7];
}

// Lambda : X for symmetric Lambda given as its gradient f (off-diagonals
// counted twice in f's convention), X any 3x3
__device__ __forceinline__ float lam_dot(const float* f, const float* X) {
  return f[0] * X[0] + f[1] * X[4] + f[2] * X[8] + 0.5f * f[3] * (X[1] + X[3]) +
         0.5f * f[4] * (X[2] + X[6]) + 0.5f * f[5] * (X[5] + X[7]);
}

// pose term e of the voxel's 9W: (phi_i, rho_j) and (phi_i, phi_j) of pose
// w = e / 9, (i, j) = (e % 9 / 3, e % 3), written to Kpr and Kpp
__device__ void pose_terms(float* F, const Fac& L, int e, const float* sT, const float* M,
                           const float* Q, const float* Nw, const float* d, const float* f,
                           float n, const float* vmean) {
  const int w = e / 9, i = (e % 9) / 3, j = e % 3;
  const float* R = sT + 12 * w;
  const float u_i[3] = {R[i], R[4 + i], R[8 + i]};
  const float u_j[3] = {R[j], R[4 + j], R[8 + j]};
  const float* dw = d + 3 * w;
  // h = Lambda d_w
  float h[3];
  h[0] = f[0] * dw[0] + 0.5f * f[3] * dw[1] + 0.5f * f[4] * dw[2];
  h[1] = 0.5f * f[3] * dw[0] + f[1] * dw[1] + 0.5f * f[5] * dw[2];
  h[2] = 0.5f * f[4] * dw[0] + 0.5f * f[5] * dw[1] + f[2] * dw[2];
  const float a2 = 2.f * Nw[w] / n;
  // (phi_i, rho_j): D2 = (u_i x u_j) / 2
  float ux[3];
  cross3(u_i, u_j, ux);
  F[L.Kpr + e] = a2 * (0.5f * dot3(ux, h));
  // (phi_i, phi_j): D2 = (u_i mean_j + u_j mean_i - 2 M [i == j]) / 2
  const float* mn = vmean + 3 * w;
  float d2h = 0.5f * (dot3(u_i, h) * mn[j] + dot3(u_j, h) * mn[i]);
  if (i == j) d2h -= dot3(M + 3 * w, h);
  // Lambda : d2Q / n
  float Ui[9], Uj[9], A[9], B[9], E2[9], X[9];
  hat3(u_i, Ui);
  hat3(u_j, Uj);
  mm3(Ui, Q + 9 * w, A);                    // U_i Q
  float UjT[9];
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int c = 0; c < 3; ++c) UjT[3 * r + c] = Uj[3 * c + r];
  mm3(A, UjT, X);                           // U_i Q U_j^T
  mm3(Ui, Uj, A);
  mm3(Uj, Ui, B);
#pragma unroll
  for (int k = 0; k < 9; ++k) E2[k] = 0.5f * (A[k] + B[k]);
  mm3(E2, Q + 9 * w, A);                    // E2 Q
#pragma unroll
  for (int k = 0; k < 9; ++k) X[k] += A[k];
  // Lambda : (X + X^T) = 2 Lambda : X for symmetric Lambda
  const float lq = 2.f * lam_dot(f, X);
  F[L.Kpp + e] = lq / n + a2 * d2h;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// where one lane's entry e of (H [D * D], g [D], cost) reads a voxel's
// factors: every offset lies inside the slot, whatever the entry's kind, so
// that a term is read without a branch (an unused value is dropped)
struct Entry {
  int kind;                       // 0 H, 1 g, 2 cost
  int Na, Nb, dC, Tq, Dv, LD, K;  // offsets; K that of the pose term, or of g's row
  bool diag, has_K;
};

__device__ Entry entry_of(const Fac& L, int e, int D) {
  const int DD = D * D;
  Entry x{};
  x.kind = e < DD ? 0 : (e < DD + D ? 1 : 2);
  const int p = e < DD ? e / D : 0, q = e < DD ? e % D : 0, a = p / 6, b = q / 6;
  const int kp = p % 6, kq = q % 6;
  x.Na = L.Nw + a;
  x.Nb = L.Nw + b;
  x.dC = L.dC + 8 * p;
  x.Tq = L.Tq + 8 * q;
  x.Dv = L.Dv + 4 * p;
  x.LD = L.LD + 4 * q;
  x.diag = a == b;
  x.has_K = x.diag && (kp >= 3 || kq >= 3);
  x.K = kp >= 3 && kq >= 3 ? L.Kpp + 9 * a + 3 * (kp - 3) + (kq - 3)
                           : (kp >= 3 ? L.Kpr + 9 * a + 3 * (kp - 3) + kq
                                      : L.Kpr + 9 * a + 3 * (kq >= 3 ? kq - 3 : 0) + kp);
  if (x.kind == 1) x.K = L.gp + e - DD;
  return x;
}

// one voxel's weighted term of the entry, from its factors F (16-byte aligned)
__device__ __forceinline__ float entry_term(const float* F, const Entry& x) {
  const float4 hd = ld4(F);   // weight, n, lambda_min
  const float n = hd.y, Na = F[x.Na], Nb = F[x.Nb], K = F[x.K];
  const float4 c0 = ld4(F + x.dC), c1 = ld4(F + x.dC + 4);
  const float4 t0 = ld4(F + x.Tq), t1 = ld4(F + x.Tq + 4);
  const float4 dp = ld4(F + x.Dv), lq = ld4(F + x.LD);
  const float DLD = dp.x * lq.x + dp.y * lq.y + dp.z * lq.z;
  float val = c0.x * t0.x + c0.y * t0.y + c0.z * t0.z + c0.w * t0.w + c1.x * t1.x + c1.y * t1.y;
  val -= 2.f * (Na * Nb) / (n * n) * DLD;
  if (x.diag) val += 2.f * Na / n * DLD;
  if (x.has_K) val += K;
  return hd.x * (x.kind == 0 ? val : (x.kind == 1 ? K : hd.z));
}

// (A) of the first launch: one warp's share of voxel v's factors, into F
// (the block's shared memory): the moments, the covariance and the jet (the
// same bits on the voxel's every warp), then every kWarpsPerVox-th row and
// pose term from `sub` on
__device__ void voxel_factors(const float* __restrict__ N, const float* __restrict__ mean,
                              const float* __restrict__ Pc, const float* __restrict__ center,
                              const float* sT, float* scratch, int v, int W, int sub,
                              const Fac& L, float* F) {
  const int lane = threadIdx.x & 31, D = 6 * W;
  TC2LI_LAP_START
  float* M = scratch;       // [W][3] R mean
  float* m = M + 48;        // [W][3] R mean + t - center
  float* Q = m + 48;        // [W][9] R Pc R^T
  float* Nw = Q + 144;      // [W]
  float* d = Nw + 16;       // [W][3] m - mu
  float* fh = d + 48;       // [6][6] Hessian of lambda_min in C's six entries
  // (a) each pose's cluster in voxel-centred world coordinates, a lane a pose
  if (lane < W) {
    const int w = lane;
    const float* R = sT + 12 * w;
    const float* mn = mean + (v * W + w) * 3;
    const float* P = Pc + (v * W + w) * 9;
    const float* c = center + 3 * v;
    float RP[9];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      M[3 * w + i] = R[4 * i] * mn[0] + R[4 * i + 1] * mn[1] + R[4 * i + 2] * mn[2];
      m[3 * w + i] = M[3 * w + i] + (R[4 * i + 3] - c[i]);
#pragma unroll
      for (int k = 0; k < 3; ++k)
        RP[3 * i + k] = R[4 * i] * P[k] + R[4 * i + 1] * P[3 + k] + R[4 * i + 2] * P[6 + k];
    }
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int l = 0; l < 3; ++l)
        Q[9 * w + 3 * i + l] = RP[3 * i] * R[4 * l] + RP[3 * i + 1] * R[4 * l + 1] +
                               RP[3 * i + 2] * R[4 * l + 2];
    Nw[w] = N[v * W + w];
  }
  __syncwarp();
  TC2LI_LAP(0);
  // (b) the covariance, the same on every lane
  float Nt = 0.f, St[3] = {0.f, 0.f, 0.f}, Pt[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) Pt[k] = 0.f;
  for (int w = 0; w < W; ++w) {
    const float nw = Nw[w];
    const float* mw = m + 3 * w;
    Nt += nw;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      St[i] += nw * mw[i];
#pragma unroll
      for (int j = 0; j < 3; ++j) Pt[3 * i + j] += Q[9 * w + 3 * i + j] + nw * (mw[i] * mw[j]);
    }
  }
  const float n = Nt < 1.f ? 1.f : Nt;
  float mu[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) mu[i] = St[i] / n;
  float C[9];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) C[3 * i + j] = Pt[3 * i + j] / n - mu[i] * mu[j];
  const float c6[6] = {C[0] + 1e-9f, C[4] + 1e-9f, C[8] + 1e-9f, C[1], C[2], C[5]};
  // (c) the jet: lane t < 21 the Hessian entry t of the upper triangle
  int hi = 0, hj = 0;
  {
    int t = lane < 21 ? lane : 20, row = 6;
    while (t >= row) {
      t -= row;
      --row;
      ++hi;
    }
    hj = hi + t;
  }
  const Jet lj = lambda_min_jet(c6, hi, hj);
  float f[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) f[k] = lj.g[k];
  if (lane < 21) {
    fh[6 * hi + hj] = lj.h;
    fh[6 * hj + hi] = lj.h;
  }
  if (lane < W) {
#pragma unroll
    for (int i = 0; i < 3; ++i) d[3 * lane + i] = m[3 * lane + i] - mu[i];
  }
  __syncwarp();
  TC2LI_LAP(1);
  // (d) a derivative row per tangent, (e) the pose terms: item i of the
  // voxel's D + 9W goes to lane i % 32 of warp (i / 32) % kWarpsPerVox
  for (int i = sub * 32 + lane; i < D + 9 * W; i += 32 * kWarpsPerVox) {
    if (i >= D) {
      pose_terms(F, L, i - D, sT, M, Q, Nw, d, f, n, mean + v * W * 3);
      continue;
    }
    const int p = i;
    const int w = p / 6, k = p % 6;
    const float* R = sT + 12 * w;
    const float nw = Nw[w];
    float Dp[3], dC[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (k < 3) {
      Dp[0] = R[k];
      Dp[1] = R[4 + k];
      Dp[2] = R[8 + k];
    } else {
      const float u[3] = {R[k - 3], R[4 + k - 3], R[8 + k - 3]};
      cross3(u, M + 3 * w, Dp);
      float U[9], UQ[9];
      hat3(u, U);
      mm3(U, Q + 9 * w, UQ);
      sym6_of_sum(UQ, dC);
#pragma unroll
      for (int e = 0; e < 6; ++e) dC[e] = dC[e] / n;
    }
    const float* dw = d + 3 * w;
    const float a = nw / n;
    dC[0] += a * (2.f * Dp[0] * dw[0]);
    dC[1] += a * (2.f * Dp[1] * dw[1]);
    dC[2] += a * (2.f * Dp[2] * dw[2]);
    dC[3] += a * (Dp[0] * dw[1] + dw[0] * Dp[1]);
    dC[4] += a * (Dp[0] * dw[2] + dw[0] * Dp[2]);
    dC[5] += a * (Dp[1] * dw[2] + dw[1] * Dp[2]);
    float gp = 0.f;
#pragma unroll
    for (int e = 0; e < 6; ++e) {
      F[L.dC + 8 * p + e] = dC[e];
      gp += f[e] * dC[e];
    }
#pragma unroll
    for (int e = 0; e < 6; ++e) {
      float t = 0.f;
#pragma unroll
      for (int g = 0; g < 6; ++g) t += fh[6 * e + g] * dC[g];
      F[L.Tq + 8 * p + e] = t;
    }
    // Lambda D_p
    F[L.LD + 4 * p] = f[0] * Dp[0] + 0.5f * f[3] * Dp[1] + 0.5f * f[4] * Dp[2];
    F[L.LD + 4 * p + 1] = 0.5f * f[3] * Dp[0] + f[1] * Dp[1] + 0.5f * f[5] * Dp[2];
    F[L.LD + 4 * p + 2] = 0.5f * f[4] * Dp[0] + 0.5f * f[5] * Dp[1] + f[2] * Dp[2];
#pragma unroll
    for (int c = 0; c < 3; ++c) F[L.Dv + 4 * p + c] = Dp[c];
    F[L.gp + p] = gp;
  }
  if (sub == 0 && lane == 0) {
    F[0] = Nt;   // valid * N_tot
    F[1] = n;
    F[2] = lj.v;
    F[3] = 0.f;
  }
  if (sub == 0 && lane < W) F[L.Nw + lane] = Nw[lane];
  TC2LI_LAP(3);
}

// First launch: a block a chunk of kChunk voxel slots, kWarpsPerVox warps a
// slot. (A) The warps of each valid voxel write its factors to the block's
// shared memory; (B) the block's threads then take the entries of (H, g,
// cost), each adding the chunk's valid voxels' terms in slot order: the
// chunk's partial sums, to scratch (a chunk without a valid voxel writes
// none: the second launch skips it).
__global__ void __launch_bounds__(32 * kVoxWarps)
voxel_kernel(const float* __restrict__ N, const float* __restrict__ mean,
             const float* __restrict__ Pc, const float* __restrict__ center,
             const uint8_t* __restrict__ valid, const float* __restrict__ T_wl, int V, int W,
             float* __restrict__ partial) {
  extern __shared__ float4 fsm4[];                 // [kChunk][stride] the voxels' factors
  __shared__ float sT[kMaxW * 12];                 // the poses' top rows
  __shared__ float swarp[kVoxWarps][kWarpFloats];
  __shared__ int live_s[kChunk];
  float* fsm = reinterpret_cast<float*>(fsm4);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // launched as a programmatic dependent too: the blocks start while the
  // stream's previous kernel runs, and wait here for it
  asm volatile("griddepcontrol.wait;" ::: "memory");
  asm volatile("griddepcontrol.launch_dependents;");   // the sum's blocks may start
  for (int e = tid; e < 12 * W; e += 32 * kVoxWarps) sT[e] = T_wl[(e / 12) * 16 + e % 12];
  const int u = warp / kWarpsPerVox, v = blockIdx.x * kChunk + u;
  const bool live = v < V && valid[v];
  if (warp % kWarpsPerVox == 0 && lane == 0) live_s[u] = live;
  __syncthreads();
  TC2LI_STAMP(20);
  const Fac L = fac_layout(W);
  if (live)
    voxel_factors(N, mean, Pc, center, sT, swarp[warp], v, W, warp % kWarpsPerVox, L,
                  fsm + u * L.stride);
  if (!__syncthreads_or(live)) return;
  TC2LI_STAMP(21);
  const int D = 6 * W, E = D * D + D + 1;
  for (int e = tid; e < E; e += 32 * kVoxWarps) {
    const Entry x = entry_of(L, e, D);
    float acc = 0.f;
    for (int k = 0; k < kChunk; ++k)
      if (live_s[k]) acc += entry_term(fsm + k * L.stride, x);
    partial[static_cast<size_t>(blockIdx.x) * E + e] = acc;
  }
  TC2LI_STAMP(22);
}

// Second launch: a block 32 entries of (H, g, cost), a lane an entry; warp
// w adds the partial sums of chunks [w G, (w + 1) G) (G = ceil(chunks /
// 32)) that hold a valid voxel, in chunk order, then warp 0 adds the 32
// groups in order. Launched as a programmatic dependent of the first: its
// blocks start while the first runs and wait for its writes.
__global__ void __launch_bounds__(32 * kGroups)
sum_kernel(const uint8_t* __restrict__ valid, int V, int W, const float* __restrict__ partial,
           float* __restrict__ H, float* __restrict__ g, float* __restrict__ cost) {
  __shared__ float part[kGroups][33];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int D = 6 * W, E = D * D + D + 1;
  const int e_own = blockIdx.x * 32 + lane, e = min(e_own, E - 1);
  const int chunks = (V + kChunk - 1) / kChunk, G = (chunks + kGroups - 1) / kGroups;
  const int c_end = min(chunks, (w + 1) * G);
  TC2LI_STAMP(30);
  asm volatile("griddepcontrol.wait;" ::: "memory");   // the first launch's partial sums
  asm volatile("griddepcontrol.launch_dependents;");   // the stream's next kernel may start
  TC2LI_STAMP(31);
  float acc = 0.f;
  for (int c0 = w * G; c0 < c_end; c0 += kUnroll) {
    float p[kUnroll];
    bool ok[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int c = c0 + u;
      bool any = false;
#pragma unroll
      for (int k = 0; k < kChunk; ++k) any = any || (c * kChunk + k < V && valid[c * kChunk + k]);
      ok[u] = c < c_end && any;
      // a chunk without a valid voxel wrote nothing: read anyway, dropped
      p[u] = __ldg(partial + static_cast<size_t>(c < c_end ? c : c_end - 1) * E + e);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) acc = ok[u] ? acc + p[u] : acc;
  }
  part[w][lane] = acc;
  TC2LI_STAMP(32);
  __syncthreads();
  if (w != 0 || e_own >= E) return;
  float tot = 0.f;
  for (int k = 0; k < kGroups; ++k) tot += part[k][lane];
  const int DD = D * D;
  if (e < DD) {
    H[e] = tot;
  } else if (e < DD + D) {
    g[e - DD] = tot;
  } else {
    *cost = tot;
  }
  TC2LI_STAMP(34);
}

}  // namespace

// floats of scratch a call takes: each chunk's partial sums of (H, g, cost)
extern "C" long long tc2li_balm_scratch(int V, int W) {
  const long long D = 6LL * W;
  return (V + kChunk - 1) / kChunk * (D * D + D + 1);
}

// N [V, W], mean [V, W, 3], Pc [V, W, 3, 3], center [V, 3], T_wl [W, 4, 4]
// float32; valid [V] uint8; partial tc2li_balm_scratch(V, W) float32 of
// scratch; outputs H [6W, 6W], g [6W], cost [1] float32. All contiguous on
// the device. Two launches on `stream`; returns cudaGetLastError().
extern "C" int tc2li_balm_quadratic(const float* N, const float* mean, const float* Pc,
                                    const float* center, const uint8_t* valid, const float* T_wl,
                                    int V, int W, float* partial, float* H, float* g, float* cost,
                                    void* stream) {
  if (W < 1 || W > kMaxW || V < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int D = 6 * W, E = D * D + D + 1;
  const int smem = static_cast<int>(sizeof(float)) * kChunk * fac_layout(W).stride;
  static int smem_set = 0;   // the first launch's dynamic shared memory, allowed once
  if (smem > smem_set) {
    const cudaError_t e =
        cudaFuncSetAttribute(voxel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(sizeof(float)) * kChunk * fac_layout(kMaxW).stride);
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_set = static_cast<int>(sizeof(float)) * kChunk * fac_layout(kMaxW).stride;
  }
  // both launches are programmatic dependents of the kernel before them:
  // each waits in its first lines for that kernel's writes
  cudaLaunchAttribute at;
  at.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  at.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = &at;
  cfg.numAttrs = 1;
  if (V > 0) {
    cfg.gridDim = dim3((V + kChunk - 1) / kChunk);
    cfg.blockDim = dim3(32 * kVoxWarps);
    cfg.dynamicSmemBytes = smem;
    const cudaError_t e = cudaLaunchKernelEx(&cfg, voxel_kernel, N, mean, Pc, center, valid,
                                             T_wl, V, W, partial);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  cfg.gridDim = dim3((E + 31) / 32);
  cfg.blockDim = dim3(32 * kGroups);
  cfg.dynamicSmemBytes = 0;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, sum_kernel, valid, V, W,
                                           static_cast<const float*>(partial), H, g, cost);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
