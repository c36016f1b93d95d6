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
// (~2.5 M a call); latency: the serial eigenvalue jet of each voxel.
// Design: a grid of up to 128 blocks of 256 threads; block b takes voxels
// b, b + grid, ... in order. A voxel's per-pose moments are one thread a
// pose, its covariance and jet one thread, its 6W derivative rows one thread
// a tangent, its (6W)^2 Hessian entries the whole block, each thread owning
// fixed entries of the block's sums in shared memory. Each block writes its
// partial sums; the last block to finish (a counter in device memory) adds
// the partials in block order. The same inputs give the same bits on every
// run.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 128;
constexpr int kMaxW = 16;

// second-order jet in six variables: value, gradient, upper-triangular Hessian
struct Jet {
  float v;
  float g[6];
  float h[21];
};

__device__ __forceinline__ int tri(int i, int j) { return i * (11 - i) / 2 + j; }  // i <= j

__device__ Jet jvar(float x, int k) {
  Jet a;
  a.v = x;
#pragma unroll
  for (int i = 0; i < 6; ++i) a.g[i] = i == k ? 1.f : 0.f;
#pragma unroll
  for (int i = 0; i < 21; ++i) a.h[i] = 0.f;
  return a;
}

__device__ Jet jadd(const Jet& a, const Jet& b) {
  Jet o;
  o.v = a.v + b.v;
#pragma unroll
  for (int i = 0; i < 6; ++i) o.g[i] = a.g[i] + b.g[i];
#pragma unroll
  for (int i = 0; i < 21; ++i) o.h[i] = a.h[i] + b.h[i];
  return o;
}

__device__ Jet jsub(const Jet& a, const Jet& b) {
  Jet o;
  o.v = a.v - b.v;
#pragma unroll
  for (int i = 0; i < 6; ++i) o.g[i] = a.g[i] - b.g[i];
#pragma unroll
  for (int i = 0; i < 21; ++i) o.h[i] = a.h[i] - b.h[i];
  return o;
}

__device__ Jet jscale(const Jet& a, float s) {
  Jet o;
  o.v = a.v * s;
#pragma unroll
  for (int i = 0; i < 6; ++i) o.g[i] = a.g[i] * s;
#pragma unroll
  for (int i = 0; i < 21; ++i) o.h[i] = a.h[i] * s;
  return o;
}

__device__ Jet jmul(const Jet& a, const Jet& b) {
  Jet o;
  o.v = a.v * b.v;
#pragma unroll
  for (int i = 0; i < 6; ++i) o.g[i] = a.g[i] * b.v + b.g[i] * a.v;
#pragma unroll
  for (int i = 0; i < 6; ++i) {
#pragma unroll
    for (int j = i; j < 6; ++j) {
      const int t = tri(i, j);
      o.h[t] = a.h[t] * b.v + b.h[t] * a.v + (a.g[i] * b.g[j] + a.g[j] * b.g[i]);
    }
  }
  return o;
}

// phi(a) from phi, phi', phi'' at a.v
__device__ Jet jfn(const Jet& a, float f0, float f1, float f2) {
  Jet o;
  o.v = f0;
#pragma unroll
  for (int i = 0; i < 6; ++i) o.g[i] = f1 * a.g[i];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
#pragma unroll
    for (int j = i; j < 6; ++j) {
      const int t = tri(i, j);
      o.h[t] = f1 * a.h[t] + f2 * (a.g[i] * a.g[j]);
    }
  }
  return o;
}

__device__ Jet jconst(float v) {
  Jet o;
  o.v = v;
#pragma unroll
  for (int i = 0; i < 6; ++i) o.g[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 21; ++i) o.h[i] = 0.f;
  return o;
}

// smallest_eigval_sym3 of the symmetric matrix with entries
// c = (C00, C11, C22, C01, C02, C12), as a jet in c
__device__ Jet lambda_min_jet(const float* c) {
  Jet x0 = jvar(c[0], 0), x1 = jvar(c[1], 1), x2 = jvar(c[2], 2);
  Jet x3 = jvar(c[3], 3), x4 = jvar(c[4], 4), x5 = jvar(c[5], 5);
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

struct Shared {
  // the block's sums, each entry owned by one thread
  float* accH;   // [D * D]
  float* accg;   // [D]
  // per voxel
  float* dC;     // [D][6]
  float* Tq;     // [D][6]  Hess . dC_q
  float* Dv;     // [D][3]  dm/dxi_p
  float* LD;     // [D][3]  Lambda D_p
  float* Kpp;    // [W][9]  pose-diagonal terms of (phi_i, phi_j)
  float* Kpr;    // [W][9]  ... of (phi_i, rho_j)
  float* M;      // [W][3]  R mean
  float* m;      // [W][3]  R mean + t - center
  float* d;      // [W][3]  m - mu
  float* Q;      // [W][9]  R Pc R^T
  float* Nw;     // [W]
  float* T;      // [W][12] the poses' top rows
};

__global__ void __launch_bounds__(kThreads)
balm_kernel(const float* __restrict__ N, const float* __restrict__ mean,
            const float* __restrict__ Pc, const float* __restrict__ center,
            const uint8_t* __restrict__ valid, const float* __restrict__ T_wl, int V, int W,
            float* __restrict__ partial, unsigned* __restrict__ counter, float* __restrict__ H,
            float* __restrict__ g, float* __restrict__ cost) {
  extern __shared__ float smem[];
  const int D = 6 * W;
  const int DD = D * D;
  const int tid = threadIdx.x;
  Shared s;
  float* ptr = smem;
  s.accH = ptr; ptr += DD;
  s.accg = ptr; ptr += D;
  s.dC = ptr; ptr += 6 * D;
  s.Tq = ptr; ptr += 6 * D;
  s.Dv = ptr; ptr += 3 * D;
  s.LD = ptr; ptr += 3 * D;
  s.Kpp = ptr; ptr += 9 * W;
  s.Kpr = ptr; ptr += 9 * W;
  s.M = ptr; ptr += 3 * W;
  s.m = ptr; ptr += 3 * W;
  s.d = ptr; ptr += 3 * W;
  s.Q = ptr; ptr += 9 * W;
  s.Nw = ptr; ptr += W;
  s.T = ptr; ptr += 12 * W;
  __shared__ float sf[6];       // gradient of lambda_min in C's six entries
  __shared__ float sfh[36];     // its Hessian, full
  __shared__ float sc[4];       // lambda_min, weight, n, the block's cost sum
  __shared__ float smu[3];
  __shared__ bool last;

  for (int e = tid; e < DD; e += kThreads) s.accH[e] = 0.f;
  for (int e = tid; e < D; e += kThreads) s.accg[e] = 0.f;
  for (int e = tid; e < 12 * W; e += kThreads) s.T[e] = T_wl[(e / 12) * 16 + e % 12];
  if (tid == 0) sc[3] = 0.f;
  __syncthreads();

  for (int v = blockIdx.x; v < V; v += gridDim.x) {
    if (!valid[v]) continue;   // uniform: every thread reads the same flag
    // (a) each pose's cluster in voxel-centred world coordinates
    if (tid < W) {
      const int w = tid;
      const float* R = s.T + 12 * w;
      const float* mn = mean + (v * W + w) * 3;
      const float* P = Pc + (v * W + w) * 9;
      const float* c = center + 3 * v;
      float RP[9];
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        s.M[3 * w + i] = R[4 * i] * mn[0] + R[4 * i + 1] * mn[1] + R[4 * i + 2] * mn[2];
        s.m[3 * w + i] = s.M[3 * w + i] + (R[4 * i + 3] - c[i]);
#pragma unroll
        for (int k = 0; k < 3; ++k)
          RP[3 * i + k] = R[4 * i] * P[k] + R[4 * i + 1] * P[3 + k] + R[4 * i + 2] * P[6 + k];
      }
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int l = 0; l < 3; ++l)
          s.Q[9 * w + 3 * i + l] = RP[3 * i] * R[4 * l] + RP[3 * i + 1] * R[4 * l + 1] +
                                   RP[3 * i + 2] * R[4 * l + 2];
      s.Nw[w] = N[v * W + w];
    }
    __syncthreads();
    // the covariance, its smallest eigenvalue as a jet, Lambda d_w
    if (tid == 0) {
      float Nt = 0.f, St[3] = {0.f, 0.f, 0.f}, Pt[9];
#pragma unroll
      for (int k = 0; k < 9; ++k) Pt[k] = 0.f;
      for (int w = 0; w < W; ++w) {
        const float nw = s.Nw[w];
        const float* mw = s.m + 3 * w;
        Nt += nw;
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          St[i] += nw * mw[i];
#pragma unroll
          for (int j = 0; j < 3; ++j) Pt[3 * i + j] += s.Q[9 * w + 3 * i + j] + nw * (mw[i] * mw[j]);
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
      const Jet lj = lambda_min_jet(c6);
#pragma unroll
      for (int i = 0; i < 6; ++i) {
        sf[i] = lj.g[i];
#pragma unroll
        for (int j = i; j < 6; ++j) sfh[6 * i + j] = sfh[6 * j + i] = lj.h[tri(i, j)];
      }
#pragma unroll
      for (int i = 0; i < 3; ++i) smu[i] = mu[i];
      sc[0] = lj.v;
      sc[1] = Nt;   // valid * N_tot
      sc[2] = n;
      sc[3] += Nt * lj.v;
    }
    __syncthreads();
    if (tid < W) {
#pragma unroll
      for (int i = 0; i < 3; ++i) s.d[3 * tid + i] = s.m[3 * tid + i] - smu[i];
    }
    __syncthreads();
    const float wv = sc[1], n = sc[2];
    // (b) a derivative row per tangent; the pose-diagonal second-order terms
    if (tid < D) {
      const int p = tid, w = p / 6, k = p % 6;
      const float* R = s.T + 12 * w;
      const float nw = s.Nw[w];
      float Dp[3], dC[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (k < 3) {
        Dp[0] = R[k];
        Dp[1] = R[4 + k];
        Dp[2] = R[8 + k];
      } else {
        const float u[3] = {R[k - 3], R[4 + k - 3], R[8 + k - 3]};
        cross3(u, s.M + 3 * w, Dp);
        float U[9], UQ[9];
        hat3(u, U);
        mm3(U, s.Q + 9 * w, UQ);
        sym6_of_sum(UQ, dC);
#pragma unroll
        for (int e = 0; e < 6; ++e) dC[e] = dC[e] / n;
      }
      const float* dw = s.d + 3 * w;
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
        s.dC[6 * p + e] = dC[e];
        gp += sf[e] * dC[e];
      }
#pragma unroll
      for (int e = 0; e < 6; ++e) {
        float t = 0.f;
#pragma unroll
        for (int f = 0; f < 6; ++f) t += sfh[6 * e + f] * dC[f];
        s.Tq[6 * p + e] = t;
      }
      // Lambda D_p
      s.LD[3 * p + 0] = sf[0] * Dp[0] + 0.5f * sf[3] * Dp[1] + 0.5f * sf[4] * Dp[2];
      s.LD[3 * p + 1] = 0.5f * sf[3] * Dp[0] + sf[1] * Dp[1] + 0.5f * sf[5] * Dp[2];
      s.LD[3 * p + 2] = 0.5f * sf[4] * Dp[0] + 0.5f * sf[5] * Dp[1] + sf[2] * Dp[2];
#pragma unroll
      for (int i = 0; i < 3; ++i) s.Dv[3 * p + i] = Dp[i];
      s.accg[p] += wv * gp;
    } else if (tid - D < 9 * W) {
      const int e = tid - D, w = e / 9, i = (e % 9) / 3, j = e % 3;
      const float* R = s.T + 12 * w;
      const float u_i[3] = {R[i], R[4 + i], R[8 + i]};
      const float u_j[3] = {R[j], R[4 + j], R[8 + j]};
      const float* dw = s.d + 3 * w;
      // h = Lambda d_w
      float h[3];
      h[0] = sf[0] * dw[0] + 0.5f * sf[3] * dw[1] + 0.5f * sf[4] * dw[2];
      h[1] = 0.5f * sf[3] * dw[0] + sf[1] * dw[1] + 0.5f * sf[5] * dw[2];
      h[2] = 0.5f * sf[4] * dw[0] + 0.5f * sf[5] * dw[1] + sf[2] * dw[2];
      const float a2 = 2.f * s.Nw[w] / n;
      // (phi_i, rho_j): D2 = (u_i x u_j) / 2
      float ux[3];
      cross3(u_i, u_j, ux);
      s.Kpr[e] = a2 * (0.5f * dot3(ux, h));
      // (phi_i, phi_j): D2 = (u_i mean_j + u_j mean_i - 2 M [i == j]) / 2
      const float* mn = mean + (v * W + w) * 3;
      float d2h = 0.5f * (dot3(u_i, h) * mn[j] + dot3(u_j, h) * mn[i]);
      if (i == j) d2h -= dot3(s.M + 3 * w, h);
      // Lambda : d2Q / n
      float Ui[9], Uj[9], A[9], B[9], E2[9], X[9];
      hat3(u_i, Ui);
      hat3(u_j, Uj);
      mm3(Ui, s.Q + 9 * w, A);                  // U_i Q
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
      mm3(E2, s.Q + 9 * w, A);                  // E2 Q
#pragma unroll
      for (int k = 0; k < 9; ++k) X[k] += A[k];
      // Lambda : (X + X^T) = 2 Lambda : X for symmetric Lambda
      const float lq = 2.f * lam_dot(sf, X);
      s.Kpp[e] = lq / n + a2 * d2h;
    }
    __syncthreads();
    // (c, d) the Hessian entries, each thread its own
    for (int e = tid; e < DD; e += kThreads) {
      const int p = e / D, q = e % D, a = p / 6, b = q / 6;
      const float* dCp = s.dC + 6 * p;
      const float* Tq = s.Tq + 6 * q;
      const float DLD = dot3(s.Dv + 3 * p, s.LD + 3 * q);
      float val = dCp[0] * Tq[0] + dCp[1] * Tq[1] + dCp[2] * Tq[2] + dCp[3] * Tq[3] +
                  dCp[4] * Tq[4] + dCp[5] * Tq[5];
      val -= 2.f * (s.Nw[a] * s.Nw[b]) / (n * n) * DLD;
      if (a == b) {
        const int kp = p % 6, kq = q % 6;
        val += 2.f * s.Nw[a] / n * DLD;
        if (kp >= 3 && kq >= 3) {
          val += s.Kpp[9 * a + 3 * (kp - 3) + (kq - 3)];
        } else if (kp >= 3) {
          val += s.Kpr[9 * a + 3 * (kp - 3) + kq];
        } else if (kq >= 3) {
          val += s.Kpr[9 * a + 3 * (kq - 3) + kp];
        }
      }
      s.accH[e] += wv * val;
    }
    __syncthreads();
  }

  // the block's partial sums, then the last block adds them in block order
  const int stride = DD + D + 1;
  float* mine = partial + static_cast<size_t>(blockIdx.x) * stride;
  for (int e = tid; e < DD; e += kThreads) mine[e] = s.accH[e];
  for (int e = tid; e < D; e += kThreads) mine[DD + e] = s.accg[e];
  if (tid == 0) mine[DD + D] = sc[3];
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(counter, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int e = tid; e < stride; e += kThreads) {
    float acc = 0.f;
    for (int b = 0; b < static_cast<int>(gridDim.x); ++b)
      acc += __ldcg(partial + static_cast<size_t>(b) * stride + e);
    if (e < DD) {
      H[e] = acc;
    } else if (e < DD + D) {
      g[e - DD] = acc;
    } else {
      *cost = acc;
    }
  }
  if (tid == 0) *counter = 0u;   // ready for the next call
}

}  // namespace

extern "C" int tc2li_balm_blocks(int V) { return V < kMaxBlocks ? (V < 1 ? 1 : V) : kMaxBlocks; }

// N [V, W], mean [V, W, 3], Pc [V, W, 3, 3], center [V, 3], T_wl [W, 4, 4]
// float32; valid [V] uint8; partial [tc2li_balm_blocks(V), 36 W^2 + 6 W + 1]
// float32 scratch; counter one uint32, 0 on entry and left 0; outputs H
// [6W, 6W], g [6W], cost [1] float32. All contiguous on the device.
// Launches on `stream`, returns cudaGetLastError().
extern "C" int tc2li_balm_quadratic(const float* N, const float* mean, const float* Pc,
                                    const float* center, const uint8_t* valid, const float* T_wl,
                                    int V, int W, float* partial, unsigned* counter, float* H,
                                    float* g, float* cost, void* stream) {
  if (W < 1 || W > kMaxW) return static_cast<int>(cudaErrorInvalidValue);
  const int D = 6 * W;
  // the Shared layout: accH, accg, dC, Tq, Dv, LD; Kpp, Kpr, M, m, d, Q, Nw, T
  const size_t smem = sizeof(float) * (static_cast<size_t>(D) * D + 19 * D + 49 * W);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        balm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  balm_kernel<<<tc2li_balm_blocks(V), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      N, mean, Pc, center, valid, T_wl, V, W, partial, counter, H, g, cost);
  return static_cast<int>(cudaGetLastError());
}
