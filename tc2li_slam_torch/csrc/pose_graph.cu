// The loop closure's pose-graph optimization (OptimizeEssentialGraph):
// every Gauss-Newton iteration of one call on the device, no host sync.
//
// Replaces tc2li_slam_tpu/solver/sim3.py:112 (pose_graph_optimize): on the
// TPU one jit-compiled program whose iterations are a lax.scan (:165).
// Eager PyTorch ran each iteration as torch.func.jacfwd over the edges,
// index_put_ scatter-adds of H and g and a dense LU solve of all 7K rows:
// ~28,700 device events a closure.
//
// What it computes is the plain version's (ops/kernels/pose_graph.py:
// pose_graph_plain). Poses S [K] packed Sim3 (the rotation block carries
// s R), edges e = (i, j, S_ij, weight, valid) with the residual
// r_e = log(S_ij S_j S_i^-1) sqrt(weight valid): the entry cost
// sum_e (w_e r_e) . r_e, then `iters` times
//   - r_e and its 7 x 14 Jacobian in the right-multiplicative tangents
//     (xi_i, xi_j) of S_i Exp(xi_i), S_j Exp(xi_j) at 0;
//   - H = J^T J + 1e-6 I and g = J^T r over the free poses;
//   - x = H^-1 g, S_new = S Exp(-x) on the free poses, the fixed ones kept;
//   - the candidate's cost, accepted when strictly lower (a NaN never is:
//     a non-finite edge, valid or not, makes every cost NaN and leaves the
//     poses as they came).
// The plain version solves all 7K rows, the fixed poses' rows being
// (1 + 1e-6) I with g 0, decoupled from the rest; here only the free rows
// are assembled and solved, which gives the free rows the same step up to
// rounding (other pivots) and the fixed rows exactly 0.
//
// The Jacobian is jacfwd's: forward-mode dual numbers (dual.cuh) through
// sim3_exp, sim3_inverse and sim3_log as geom/lie.py writes them, with
// _sim3_W's Taylor branches below kEps in theta and sigma, so3_log's
// branch near pi and its clamps, the adjugate solve3, the scale as a row
// norm. Thread (e, c) carries tangent c of edge e through the whole chain.
// Everything after the float32 inputs is float64: the state, residuals,
// Jacobians, H, the factorization and the costs; the result is rounded to
// float32 once a cost launch.
//
// Bound on the H100: at 4f's closure (49 slots, 48 free poses, 181 edges)
// latency: 15 iterations of a few tiny dependent steps; at a few thousand
// free rows the Cholesky's n^3 / 6 float64 multiply-adds a step.
// Design: a fixed sequence of launches on the caller's stream, every sum in
// an order that depends only on the inputs (the same bits on every call, no
// atomics in a float sum). The host plans the sequence from K alone; the
// free-row count n = 7 x (free poses) stays on the device, and a launch
// whose panel or tile lies past it returns at once:
//   setup (one block): the state in float64, each pose's free slot (a
//        prefix count over `fixed` in pose order), n;
//   cost (an edge a thread): the entry cost (see cost_kernel);
//   per iteration
//   edge (14 threads an edge): r_e and J_e by dual numbers, weighted;
//   assemble (a block a pose): the free pose's 7-row block-row of H (its
//        lower part, in place in a [7K + 1, 7K + 1] float64 matrix) and its
//        7 entries of g, which go in row n: a bordered matrix [[H], [g^T]]
//        whose Cholesky leaves y = L^-1 g in its last row. The block walks
//        the edge list in order, keeps the edges that touch its pose, and
//        adds each edge's blocks in edge order (a thread an entry), then
//        1e-6 on the diagonal;
//   Cholesky, a panel of kNB columns at a time, right-looking:
//     panel (rows below the panel, kPanelRows a block): every block factors
//        the panel's kNB x kNB diagonal block in one warp's registers (a
//        lane a row, shuffles), block 0 keeps it in Ldiag, and each thread
//        solves one row of the panel, x L^T = a;
//     update (a kTile x kTile tile of the trailing lower part a block):
//        A -= L_r L_c^T over the panel's columns, row n (the g row) with it;
//   back (one launch a panel, last to first): every block solves
//        L_kk^T x_k = y_k in one warp; block k writes x_k, block i < k
//        takes L_ki^T x_k off y_i;
//   poses (a thread a pose): S_new = S Exp(-x) on the free poses;
//   cost (an edge a thread): each edge's (w r) . r at S_new; the last block
//        to finish adds them in edge order by a fixed tree, decides, keeps
//        S_new and its cost where the cost fell, and writes the float32
//        result.
// Launches: 2 + iters x (4 + 3 ceil(7K / kNB)) (ops/kernels/pose_graph.py
// launches_per_call).

#include <cuda_runtime.h>
#include <stdint.h>

#include "dual.cuh"

namespace {

constexpr int kNB = 32;           // the Cholesky's panel width (a warp)
constexpr int kTile = 64;         // the trailing update's tile
constexpr int kPanelRows = 128;   // rows a panel block solves (a thread a row)
constexpr int kLanes = 14;        // tangents an edge: xi_i (0..6), xi_j (7..13)
constexpr int kThreads = 256;
constexpr int kSetupThreads = 1024;
constexpr unsigned kFull = 0xffffffffu;

struct Graph {
  const float* S_w;      // [K, 4, 4]
  const int *ei, *ej;    // [E]
  const float* S_ij;     // [E, 4, 4]
  const float* weight;   // [E]
  const uint8_t* valid;  // [E]
  const uint8_t* fixed;  // [K]
  int K, E;
  size_t ld;             // H's row stride: 7K + 1
  float* out;            // [K, 4, 4]
};

struct Work {
  double* H;         // [7K + 1, 7K + 1]: rows and columns below n, and row n (g, then y)
  double* Ldiag;     // [P, kNB, kNB]: each panel's factored diagonal block
  double* x;         // [7K]: H^-1 g on the free rows
  double* J;         // [E, 7, 14]
  double* r;         // [E, 7]
  double* S;         // [K, 16]: the state
  double* Sn;        // [K, 16]: the candidate
  double* cost_e;    // [max(E, 1)]
  double* cost;      // [1]: the state's cost
  int* slot;         // [K]: the free poses before pose p
  int* n;            // [1]: 7 x the free poses
  unsigned* done;    // [1]: blocks of a cost launch that finished
};

// ---------------------------------------------------------------------------
// geom/lie.py's Sim(3) chain over T (a packed Sim3 as the top three rows of
// its 4 x 4, row-major, the bottom row [0 0 0 1] implied)
// ---------------------------------------------------------------------------

// C = A B, torch's matmul with the bottom row of B written out
template <class T>
__device__ __forceinline__ void mul34(const T* A, const T* B, T* C) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      C[4 * i + j] = ((A[4 * i] * B[j] + A[4 * i + 1] * B[4 + j]) + A[4 * i + 2] * B[8 + j]) +
                     A[4 * i + 3] * (j == 3 ? 1.0 : 0.0);
}

template <class T>
__device__ __forceinline__ T safe_theta(const T w[3]) {
  return dsqrt(dclamp_min((w[0] * w[0] + w[1] * w[1]) + w[2] * w[2], 1e-24));
}

// _sim3_W: W = C I + A Phi + B Phi^2 with its Taylor limits
template <class T>
__device__ void sim3_W_t(T theta, T sigma, const T phi[3], T W[9]) {
  const T zero = lift<T>(0.0, false), one = lift<T>(1.0, false);
  const T P[9] = {zero, -phi[2], phi[1], phi[2], zero, -phi[0], -phi[1], phi[0], zero};
  T P2[9];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      P2[3 * i + j] = (P[3 * i] * P[j] + P[3 * i + 1] * P[3 + j]) + P[3 * i + 2] * P[6 + j];
  const T s = dexp(sigma);
  const bool small_sig = fabs(val(sigma)) < kEps;
  const bool small_th = val(theta) < kEps;
  const T sig_s = small_sig ? one : sigma;
  const T th_s = small_th ? one : theta;
  const T denom = sigma * sigma + theta * theta;
  const T denom_s = val(denom) < kEps * kEps ? one : denom;
  const T C = small_sig ? (1.0 + 0.5 * sigma) + sigma * sigma / 6.0 : (s - 1.0) / sig_s;
  T A, B;
  if (small_th) {
    A = small_sig ? 0.5 + sigma / 3.0 : ((sigma - 1.0) * s + 1.0) / (sig_s * sig_s);
    B = small_sig ? 1.0 / 6.0 + sigma / 8.0
                  : (s * ((1.0 - sigma) + 0.5 * sigma * sigma) - 1.0) / ((sig_s * sig_s) * sig_s);
  } else {
    const T a = s * dsin(theta), b = s * dcos(theta);
    A = (a * sigma + (1.0 - b) * theta) / (th_s * denom_s);
    B = (C - ((b - 1.0) * sigma + a * theta) / denom_s) / (th_s * th_s);
  }
#pragma unroll
  for (int e = 0; e < 9; ++e) W[e] = (C * (e % 4 == 0 ? 1.0 : 0.0) + A * P[e]) + B * P2[e];
}

// sim3_exp: (rho, phi, sigma) -> packed Sim3
template <class T>
__device__ void sim3_exp_t(const T xi[7], T S[12]) {
  const T phi[3] = {xi[3], xi[4], xi[5]};
  T W[9], R[9];
  sim3_W_t(safe_theta(phi), xi[6], phi, W);
  so3_exp_t(phi, R);
  const T s = dexp(xi[6]);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) S[4 * i + j] = s * R[3 * i + j];
    S[4 * i + 3] = (W[3 * i] * xi[0] + W[3 * i + 1] * xi[1]) + W[3 * i + 2] * xi[2];
  }
}

template <class T>
__device__ __forceinline__ T row_norm(const T* S) {   // sim3_scale
  return dsqrt((S[0] * S[0] + S[1] * S[1]) + S[2] * S[2]);
}

// sim3_inverse: (s_inv R^T, -s_inv R^T t)
template <class T>
__device__ void sim3_inverse_t(const T S[12], T Si[12]) {
  const T sc = row_norm(S);
  const T s_inv = 1.0 / sc;
  T Rt[9];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) Rt[3 * i + j] = S[4 * j + i] / sc;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) Si[4 * i + j] = s_inv * Rt[3 * i + j];
    Si[4 * i + 3] = -s_inv * ((Rt[3 * i] * S[3] + Rt[3 * i + 1] * S[7]) + Rt[3 * i + 2] * S[11]);
  }
}

template <class T>
__device__ __forceinline__ void cross_t(const T* a, const T* b, T* c) {
  c[0] = a[1] * b[2] - a[2] * b[1];
  c[1] = a[2] * b[0] - a[0] * b[2];
  c[2] = a[0] * b[1] - a[1] * b[0];
}

// sim3_log: sigma = log(scale), phi = so3_log(R), rho = solve3(W, t) by the
// adjugate (cross products of W's rows)
template <class T>
__device__ void sim3_log_t(const T E[12], T xi[7]) {
  const T sc = row_norm(E);
  const T sigma = dlog(sc);
  T R[9];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) R[3 * i + j] = E[4 * i + j] / sc;
  T phi[3], W[9];
  so3_log_t(R, phi);
  sim3_W_t(safe_theta(phi), sigma, phi, W);
  T c0[3], c1[3], c2[3];
  cross_t(W + 3, W + 6, c0);
  cross_t(W + 6, W, c1);
  cross_t(W, W + 3, c2);
  const T det = (W[0] * c0[0] + W[1] * c0[1]) + W[2] * c0[2];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    xi[k] = ((c0[k] * E[3] + c1[k] * E[7]) + c2[k] * E[11]) / det;
    xi[3 + k] = phi[k];
  }
  xi[6] = sigma;
}

// S Exp(xi) with the tangent on component c of xi at 0 (c < 0: S itself,
// which S Exp(0) equals to the bit)
template <class T>
__device__ void perturbed(const double* S, int c, T out[12]) {
  T St[12];
#pragma unroll
  for (int e = 0; e < 12; ++e) St[e] = lift<T>(S[e], false);
  if (c < 0) {
#pragma unroll
    for (int e = 0; e < 12; ++e) out[e] = St[e];
    return;
  }
  T xi[7], E[12];
#pragma unroll
  for (int k = 0; k < 7; ++k) xi[k] = lift<T>(0.0, k == c);
  sim3_exp_t(xi, E);
  mul34(St, E, out);
}

// edge residual log(S_ij (S_j Exp(xi_j)) (S_i Exp(xi_i))^-1), unweighted,
// with the tangent on local column `dir` (0..6 xi_i, 7..13 xi_j; -1 none)
template <class T>
__device__ void edge_residual(const double* Sij, const double* Si, const double* Sj, int dir,
                              T r[7]) {
  T A[12], B[12], Ai[12], M[12], Er[12], Mij[12];
  perturbed(Si, dir < 7 ? dir : -1, A);
  perturbed(Sj, dir >= 7 ? dir - 7 : -1, B);
#pragma unroll
  for (int e = 0; e < 12; ++e) Mij[e] = lift<T>(Sij[e], false);
  mul34(Mij, B, M);
  sim3_inverse_t(A, Ai);
  mul34(M, Ai, Er);
  sim3_log_t(Er, r);
}

// edge e's inputs in float64: S_ij's top rows, and whether both poses exist
__device__ __forceinline__ bool load_edge(const Graph& g, int e, double Sij[12], int& i, int& j) {
  i = g.ei[e];
  j = g.ej[e];
#pragma unroll
  for (int k = 0; k < 12; ++k) Sij[k] = g.S_ij[16 * static_cast<size_t>(e) + k];
  return i >= 0 && i < g.K && j >= 0 && j < g.K;
}

__device__ __forceinline__ double edge_weight(const Graph& g, int e) {
  return static_cast<double>(g.weight[e]) * (g.valid[e] ? 1.0 : 0.0);
}

// ---------------------------------------------------------------------------
// the kernels, in launch order
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kSetupThreads) setup_kernel(const Graph g, const Work w) {
  __shared__ int wsum[kSetupThreads / 32];
  __shared__ int carry;
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  for (int e = tid; e < 16 * g.K; e += kSetupThreads) w.S[e] = g.S_w[e];
  if (tid == 0) carry = 0;
  __syncthreads();
  for (int p0 = 0; p0 < g.K; p0 += kSetupThreads) {
    const int p = p0 + tid;
    const bool f = p < g.K && !g.fixed[p];
    const unsigned m = __ballot_sync(kFull, f);
    if (lane == 0) wsum[wid] = __popc(m);
    __syncthreads();
    int off = carry, tot = 0;
    for (int q = 0; q < kSetupThreads / 32; ++q) {
      off += q < wid ? wsum[q] : 0;
      tot += wsum[q];
    }
    if (p < g.K) w.slot[p] = off + __popc(m & ((1u << lane) - 1u));
    __syncthreads();
    if (tid == 0) carry += tot;
    __syncthreads();
  }
  if (tid == 0) {
    *w.n = 7 * carry;
    *w.done = 0u;
  }
}

// thread (e, c): edge e's residual and column c of its Jacobian, weighted
__global__ void __launch_bounds__(kThreads) edge_kernel(const Graph g, const Work w) {
  const int t = blockIdx.x * kThreads + threadIdx.x;
  const int e = t / kLanes, c = t % kLanes;
  if (e >= g.E) return;
  double Sij[12];
  int i, j;
  Dual r[7];
  if (load_edge(g, e, Sij, i, j)) {
    edge_residual<Dual>(Sij, w.S + 16 * i, w.S + 16 * j, c, r);
  } else {
#pragma unroll
    for (int k = 0; k < 7; ++k) r[k] = Dual{nan(""), nan("")};
  }
  const double sw = sqrt(edge_weight(g, e));
#pragma unroll
  for (int k = 0; k < 7; ++k) w.J[98 * static_cast<size_t>(e) + 14 * k + c] = r[k].d * sw;
  if (c == 0) {
#pragma unroll
    for (int k = 0; k < 7; ++k) w.r[7 * static_cast<size_t>(e) + k] = r[k].v * sw;
  }
}

// block p: the free pose p's block-row of H (lower part) and its g entries
__global__ void __launch_bounds__(kThreads) assemble_kernel(const Graph g, const Work w) {
  __shared__ int list[kThreads];
  __shared__ int warp_n[kThreads / 32];
  __shared__ double Js[98], rs[7];
  const int p = blockIdx.x, tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  if (g.fixed[p]) return;
  const int s = w.slot[p], n = *w.n, row0 = 7 * s, width = row0 + 7;
  double* H = w.H;
  for (int idx = tid; idx < 7 * width; idx += kThreads)
    H[(row0 + idx / width) * g.ld + idx % width] = 0.0;
  __syncthreads();
  // workers: thread a * 7 + b (< 49) entry (a, b) of each block of the row;
  // thread 49 + a entry a of g
  const int a = tid < 49 ? tid / 7 : tid - 49, b = tid % 7;
  double acc = 0.0;
  for (int c0 = 0; c0 < g.E; c0 += kThreads) {
    // the edges of this chunk that touch p, in edge order
    const int e = c0 + tid;
    const bool inc = e < g.E && (g.ei[e] == p || g.ej[e] == p);
    const unsigned m = __ballot_sync(kFull, inc);
    if (lane == 0) warp_n[wid] = __popc(m);
    __syncthreads();
    int off = 0, total = 0;
    for (int q = 0; q < kThreads / 32; ++q) {
      off += q < wid ? warp_n[q] : 0;
      total += warp_n[q];
    }
    if (inc) list[off + __popc(m & ((1u << lane) - 1u))] = e;
    __syncthreads();
    for (int q = 0; q < total; ++q) {
      const int ee = list[q];
      if (tid < 98) Js[tid] = w.J[98 * static_cast<size_t>(ee) + tid];
      else if (tid < 105) rs[tid - 98] = w.r[7 * static_cast<size_t>(ee) + tid - 98];
      __syncthreads();
      const int ie = g.ei[ee], je = g.ej[ee];
      // p's column block of J_e: J_i, J_j, or J_i + J_j where i = j = p
      const int pa = ie == p ? a : 7 + a;
      const bool both = ie == p && je == p;
      if (tid < 56) {
        double h = 0.0;
        if (tid < 49) {   // the diagonal block
          const int pb = ie == p ? b : 7 + b;
#pragma unroll
          for (int k = 0; k < 7; ++k) {
            const double ja = both ? Js[14 * k + a] + Js[14 * k + 7 + a] : Js[14 * k + pa];
            const double jb = both ? Js[14 * k + b] + Js[14 * k + 7 + b] : Js[14 * k + pb];
            h += ja * jb;
          }
        } else {          // g
#pragma unroll
          for (int k = 0; k < 7; ++k) {
            const double ja = both ? Js[14 * k + a] + Js[14 * k + 7 + a] : Js[14 * k + pa];
            h += ja * rs[k];
          }
        }
        acc += h;
      }
      // the block of the other pose, where it is free and left of p
      const int qp = ie == p ? je : ie;
      if (tid < 49 && !both && qp >= 0 && qp < g.K && !g.fixed[qp] && w.slot[qp] < s) {
        const int qb = ie == p ? 7 + b : b;
        double h = 0.0;
#pragma unroll
        for (int k = 0; k < 7; ++k) h += Js[14 * k + pa] * Js[14 * k + qb];
        H[(row0 + a) * g.ld + 7 * w.slot[qp] + b] += h;
      }
      __syncthreads();
    }
  }
  if (tid < 49) H[(row0 + a) * g.ld + row0 + b] = a == b ? acc + 1e-6 : acc;
  else if (tid < 56) H[n * g.ld + row0 + a] = acc;
}

// the panel's diagonal block (rows and columns k0..k0 + kNB, identity past
// n), factored in place in one warp: lane i holds row i
__device__ __forceinline__ void warp_cholesky(double a[kNB], int lane) {
#pragma unroll
  for (int j = 0; j < kNB; ++j) {
    const double ljj = sqrt(__shfl_sync(kFull, a[j], j));
    if (lane == j) a[j] = ljj;
    else if (lane > j) a[j] = a[j] / ljj;
#pragma unroll
    for (int m = j + 1; m < kNB; ++m) {
      const double lmj = __shfl_sync(kFull, a[j], m);
      if (lane >= m) a[m] -= a[j] * lmj;
    }
  }
}

// panel k: L_kk, then the rows below it (up to and with row n) solved
// against L_kk^T, kPanelRows a block
__global__ void __launch_bounds__(kPanelRows) panel_kernel(const Work w, size_t ld, int k) {
  __shared__ double Ls[kNB][kNB + 1];
  __shared__ double As[kPanelRows][kNB + 1];
  const int n = *w.n, k0 = kNB * k, tid = threadIdx.x;
  if (k0 >= n) return;
  const int wd = min(kNB, n - k0);
  const int r0 = k0 + wd + kPanelRows * blockIdx.x;
  if (r0 > n) return;
  const double* H = w.H;
  if (tid < 32) {
    double a[kNB];
#pragma unroll
    for (int m = 0; m < kNB; ++m)
      a[m] = tid < wd && m <= tid ? H[(k0 + tid) * ld + k0 + m] : (m == tid ? 1.0 : 0.0);
    warp_cholesky(a, tid);
#pragma unroll
    for (int m = 0; m < kNB; ++m) Ls[tid][m] = a[m];
  }
  for (int idx = tid; idx < kPanelRows * kNB; idx += kPanelRows) {
    const int rr = idx / kNB, cc = idx % kNB, r = r0 + rr;
    As[rr][cc] = r <= n && cc < wd ? H[r * ld + k0 + cc] : 0.0;
  }
  __syncthreads();
  if (blockIdx.x == 0)
    for (int idx = tid; idx < kNB * kNB; idx += kPanelRows)
      w.Ldiag[static_cast<size_t>(k) * kNB * kNB + idx] = Ls[idx / kNB][idx % kNB];
  double* row = As[tid];
  for (int c = 0; c < kNB; ++c) {
    double v = row[c];
    for (int m = 0; m < c; ++m) v -= row[m] * Ls[c][m];
    row[c] = v / Ls[c][c];
  }
  __syncthreads();
  for (int idx = tid; idx < kPanelRows * kNB; idx += kPanelRows) {
    const int rr = idx / kNB, cc = idx % kNB, r = r0 + rr;
    if (r <= n && cc < wd) w.H[r * ld + k0 + cc] = As[rr][cc];
  }
}

// the tiles of the lower part of the trailing matrix (rows t0..n, columns
// t0..n - 1) in one linear grid: block b is tile (I, J), J <= I
__device__ __forceinline__ void tile_of(int b, int& I, int& J) {
  I = static_cast<int>((sqrt(8.0 * b + 1.0) - 1.0) * 0.5);
  while ((I + 1) * (I + 2) / 2 <= b) ++I;
  while (I * (I + 1) / 2 > b) --I;
  J = b - I * (I + 1) / 2;
}

// panel k's trailing update: A[r][c] -= sum over the panel's columns of
// L[r][m] L[c][m], a kTile x kTile tile a block, 4 x 4 entries a thread
__global__ void __launch_bounds__(kThreads) update_kernel(const Work w, size_t ld, int k) {
  __shared__ double Ar[kTile][kNB + 1], Bc[kTile][kNB + 1];
  const int n = *w.n, k0 = kNB * k, t0 = k0 + kNB, tid = threadIdx.x;
  if (t0 >= n) return;   // the last panel: no trailing column
  int I, J;
  tile_of(blockIdx.x, I, J);
  const int ri0 = t0 + kTile * I, ci0 = t0 + kTile * J;
  if (ri0 > n || ci0 >= n) return;
  const double* H = w.H;
  for (int idx = tid; idx < kTile * kNB; idx += kThreads) {
    const int rr = idx / kNB, cc = idx % kNB;
    Ar[rr][cc] = ri0 + rr <= n ? H[(ri0 + rr) * ld + k0 + cc] : 0.0;
    Bc[rr][cc] = ci0 + rr < n ? H[(ci0 + rr) * ld + k0 + cc] : 0.0;
  }
  __syncthreads();
  const int tx = tid & 15, ty = tid >> 4;
  double acc[4][4];
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int v = 0; v < 4; ++v) acc[u][v] = 0.0;
#pragma unroll 4
  for (int m = 0; m < kNB; ++m) {
    double x[4], y[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      x[u] = Ar[ty + 16 * u][m];
      y[u] = Bc[tx + 16 * u][m];
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[u][v] += x[u] * y[v];
  }
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int r = ri0 + ty + 16 * u, c = ci0 + tx + 16 * v;
      if (r <= n && c < n && (I > J || r >= c)) w.H[r * ld + c] -= acc[u][v];
    }
}

// back-substitution, panel k (launched last to first): L_kk^T x_k = y_k in
// every block's warp; block k writes x_k, block i < k takes L_ki^T x_k off
// y_i (row n, columns 32 i..32 i + 31)
__global__ void __launch_bounds__(32) back_kernel(const Work w, size_t ld, int k) {
  __shared__ double xs[kNB];
  const int n = *w.n, k0 = kNB * k, lane = threadIdx.x;
  if (k0 >= n) return;
  const int wd = min(kNB, n - k0);
  double* H = w.H;
  const double* L = w.Ldiag + static_cast<size_t>(k) * kNB * kNB;
  double col[kNB];   // column `lane` of L_kk
#pragma unroll
  for (int m = 0; m < kNB; ++m) col[m] = L[m * kNB + lane];
  double y = lane < wd ? H[n * ld + k0 + lane] : 0.0, x = 0.0;
#pragma unroll
  for (int j = kNB - 1; j >= 0; --j) {
    const double xj = __shfl_sync(kFull, y / col[j], j);
    if (lane == j) x = xj;
    else if (lane < j) y -= col[j] * xj;
  }
  if (static_cast<int>(blockIdx.x) == k) {
    if (lane < wd) w.x[k0 + lane] = x;
    return;
  }
  xs[lane] = x;
  __syncwarp();
  const size_t c = static_cast<size_t>(kNB) * blockIdx.x + lane;
  double v = H[n * ld + c];
  for (int m = 0; m < wd; ++m) v -= H[(k0 + m) * ld + c] * xs[m];
  H[n * ld + c] = v;
}

// the candidate: S Exp(-x) on the free poses, the fixed ones copied
__global__ void __launch_bounds__(kThreads) poses_kernel(const Graph g, const Work w) {
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= g.K) return;
  const double* S = w.S + 16 * p;
  double* Sn = w.Sn + 16 * p;
  if (g.fixed[p]) {
    for (int e = 0; e < 16; ++e) Sn[e] = S[e];
    return;
  }
  const double* x = w.x + 7 * w.slot[p];
  double xi[7], E[12];
  for (int k = 0; k < 7; ++k) xi[k] = -x[k];
  sim3_exp_t<double>(xi, E);
  mul34<double>(S, E, Sn);
  for (int e = 12; e < 16; ++e) Sn[e] = S[e];
}

// the cost at the state (step 0, the entry) or at the candidate (step 1):
// an edge a thread, then the last block adds the edges' costs in a fixed
// order, keeps the candidate where its cost is strictly lower and writes
// the state, rounded to float32, to the output
__global__ void __launch_bounds__(kThreads) cost_kernel(const Graph g, const Work w, int step) {
  __shared__ double part[kThreads];
  __shared__ bool last;
  const int tid = threadIdx.x, e = blockIdx.x * kThreads + tid;
  const double* S = step ? w.Sn : w.S;
  if (e < g.E) {
    double Sij[12], r[7];
    int i, j;
    double c = nan("");
    if (load_edge(g, e, Sij, i, j)) {
      edge_residual<double>(Sij, S + 16 * i, S + 16 * j, -1, r);
      const double wt = edge_weight(g, e);
      c = 0.0;
      for (int k = 0; k < 7; ++k) c += (wt * r[k]) * r[k];
    }
    w.cost_e[e] = c;
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(w.done, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const volatile double* ce = w.cost_e;
  double acc = 0.0;
  for (int q = tid; q < g.E; q += kThreads) acc += ce[q];
  part[tid] = acc;
  __syncthreads();
  for (int h = kThreads / 2; h > 0; h >>= 1) {
    if (tid < h) part[tid] += part[tid + h];
    __syncthreads();
  }
  const double total = part[0];
  const bool keep = step && total < *w.cost;   // a NaN never passes
  __syncthreads();
  if (tid == 0) {
    if (!step || keep) *w.cost = total;
    *w.done = 0u;
  }
  for (int q = tid; q < 16 * g.K; q += kThreads) {
    const double v = keep ? w.Sn[q] : w.S[q];
    w.S[q] = v;
    g.out[q] = static_cast<float>(v);
  }
}

int panels(int K) { return (7 * K + kNB - 1) / kNB; }

// blocks of a launch planned from K (7K rows at most, and the row of g)
int panel_blocks(int K, int k) {
  const int rows = 7 * K + 1 - kNB * (k + 1);
  return rows > 0 ? (rows + kPanelRows - 1) / kPanelRows : 1;
}

int update_blocks(int K, int k) {
  const int rows = 7 * K + 1 - kNB * (k + 1);
  const int m = rows > 0 ? (rows + kTile - 1) / kTile : 1;
  return m * (m + 1) / 2;
}

struct Layout {
  size_t H, Ldiag, x, J, r, S, Sn, cost_e, cost, doubles;
};

Layout layout_of(int K, int E) {
  Layout l;
  const size_t D = 7 * static_cast<size_t>(K);
  size_t o = 0;
  l.H = o;      o += (D + 1) * (D + 1);
  l.Ldiag = o;  o += static_cast<size_t>(panels(K)) * kNB * kNB;
  l.x = o;      o += D;
  l.J = o;      o += 98 * static_cast<size_t>(E);
  l.r = o;      o += 7 * static_cast<size_t>(E);
  l.S = o;      o += 16 * static_cast<size_t>(K);
  l.Sn = o;     o += 16 * static_cast<size_t>(K);
  l.cost_e = o; o += E > 0 ? E : 1;
  l.cost = o;   o += 1;
  l.doubles = o;
  return l;
}

}  // namespace

// scratch bytes of a call with K poses and E edges: the doubles of
// layout_of, then slot [K], n and the done counter
extern "C" long long tc2li_pose_graph_scratch(int K, int E) {
  return static_cast<long long>(8 * layout_of(K, E).doubles + 4 * (static_cast<size_t>(K) + 2));
}

// S_w [K, 4, 4], S_ij [E, 4, 4], weight [E] float32; ei, ej [E] int32;
// valid [E], fixed [K] uint8 (0 or 1); work: tc2li_pose_graph_scratch(K, E)
// bytes, 8-byte aligned; out [K, 4, 4] float32. All contiguous on the
// device. 2 + iters (4 + 3 panels(K)) launches on `stream`; returns
// the first CUDA error code that is not cudaSuccess.
extern "C" int tc2li_pose_graph_gn(const float* S_w, const int* ei, const int* ej,
                                   const float* S_ij, const float* weight, const uint8_t* valid,
                                   const uint8_t* fixed, int K, int E, int iters, void* work,
                                   float* out, void* stream) {
  if (K < 1 || E < 0 || iters < 0) return static_cast<int>(cudaErrorInvalidValue);
  const Layout l = layout_of(K, E);
  double* base = static_cast<double*>(work);
  int* ints = reinterpret_cast<int*>(base + l.doubles);
  const Work w{base + l.H, base + l.Ldiag, base + l.x, base + l.J, base + l.r, base + l.S,
               base + l.Sn, base + l.cost_e, base + l.cost, ints, ints + K,
               reinterpret_cast<unsigned*>(ints + K + 1)};
  const Graph g{S_w, ei, ej, S_ij, weight, valid, fixed, K, E, 7 * static_cast<size_t>(K) + 1,
                out};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int edge_blocks = E > 0 ? (kLanes * E + kThreads - 1) / kThreads : 1;
  const int cost_blocks = E > 0 ? (E + kThreads - 1) / kThreads : 1;
  const int pose_blocks = (K + kThreads - 1) / kThreads;
  const int P = panels(K);
  int rc;
#define TC2LI_LAUNCH(...)                                              \
  do {                                                                 \
    __VA_ARGS__;                                                       \
    if ((rc = static_cast<int>(cudaGetLastError())) != 0) return rc;   \
  } while (0)
  TC2LI_LAUNCH(setup_kernel<<<1, kSetupThreads, 0, st>>>(g, w));
  TC2LI_LAUNCH(cost_kernel<<<cost_blocks, kThreads, 0, st>>>(g, w, 0));
  for (int it = 0; it < iters; ++it) {
    TC2LI_LAUNCH(edge_kernel<<<edge_blocks, kThreads, 0, st>>>(g, w));
    TC2LI_LAUNCH(assemble_kernel<<<K, kThreads, 0, st>>>(g, w));
    for (int k = 0; k < P; ++k) {
      TC2LI_LAUNCH(panel_kernel<<<panel_blocks(K, k), kPanelRows, 0, st>>>(w, g.ld, k));
      TC2LI_LAUNCH(update_kernel<<<update_blocks(K, k), kThreads, 0, st>>>(w, g.ld, k));
    }
    for (int k = P - 1; k >= 0; --k)
      TC2LI_LAUNCH(back_kernel<<<k + 1, 32, 0, st>>>(w, g.ld, k));
    TC2LI_LAUNCH(poses_kernel<<<pose_blocks, kThreads, 0, st>>>(g, w));
    TC2LI_LAUNCH(cost_kernel<<<cost_blocks, kThreads, 0, st>>>(g, w, 1));
  }
#undef TC2LI_LAUNCH
  return 0;
}
