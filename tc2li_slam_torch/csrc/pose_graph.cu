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
// free rows the Cholesky's n^3 / 6 float64 multiply-adds a step, and the
// trailing updates' traffic (each tile read and written once a panel).
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
//        lower part, in place in a [7K + 1, ld] float64 matrix, ld 7K + 1
//        padded to kTile) and its 7 entries of g, which go in row n: a
//        bordered matrix [[H], [g^T]] whose Cholesky leaves y = L^-1 g in its
//        last row. The block walks the edge list in order, keeps the edges
//        that touch its pose, and adds each edge's blocks in edge order (a
//        thread an entry), then 1e-6 on the diagonal;
//   the solve, right-looking over panels of kNB columns, each panel kW
//   columns at a time:
//     update (narrow; a kW-wide part after the first): its columns, rows
//        below its top, take the update of the panel's parts before it;
//     diag (one block): the part's kW x kW diagonal block factored once in
//        shared memory (diag_block: a warp a kSub-wide half, the rest on the
//        tensor cores), its inverse L^-1 formed there and kept in Linv;
//     panel (kTile rows below a block, row n with them): the rows times
//        L^-T, a tensor-core product (no division on any thread's path);
//     update (a kTile x kTile tile of the trailing lower part a block):
//        A -= L_r L_c^T over the panel's kNB columns on the float64 tensor
//        cores (mma.sync m16n8k8), operands staged by cp.async in kBK-column
//        chunks, double buffered; each tile read and written once a panel;
//   back (kW rows a launch, last to first): every block forms x_k =
//        L_kk^-T y_k, block 0 writes it, each block takes L_k.^T x_k off y
//        over kSolveThreads columns left of the part;
//   poses (a thread a pose): S_new = S Exp(-x) on the free poses;
//   cost (an edge a thread): each edge's (w r) . r at S_new; the last block
//        to finish adds them in edge order by a fixed tree, decides, keeps
//        S_new and its cost where the cost fell, and writes the float32
//        result.
// Launches (for_each_solve_launch, tc2li_pose_graph_launches): 2 + iters x
// (3 + 4 ceil(7K / kW)): a kW-wide part of the 7K rows has its diag, panel
// and back launches and, but for the first part of a panel, its update; a
// panel but the last its trailing update. (One cooperative launch an
// iteration for the solve, the same steps between grid barriers, took
// longer than these launches at 336 and 2,793 free rows, and a
// back-substitution launch a panel longer than one a part at 336 to 14,329;
// panels of 64 and 128 columns took longer than 256 at 14,329.)

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "dual.cuh"

namespace {

constexpr int kW = 64;            // a diagonal block's width (factored in shared memory)
constexpr int kNB = 256;          // a panel's width (the trailing update's), kW-wide parts
constexpr int kSub = 32;          // a warp's part of it
constexpr int kTile = 64;         // the tensor-core products' tiles (rows and columns)
constexpr int kBK = 16;           // columns of a staged operand chunk
constexpr int kStride = kBK + 4;  // doubles a staged row
constexpr int kSolveThreads = 128;
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
  size_t ld;             // H's row stride: 7K + 1 padded to kTile
  float* out;            // [K, 4, 4]
};

struct Work {
  double* H;         // [7K + 1, ld]: rows and columns below n, and row n (g, then y)
  double* Linv;      // [ceil(7K / kW), kW, kW]: each diagonal block's L^-1
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

// ---------------------------------------------------------------------------
// the bordered Cholesky and the back-substitution
// ---------------------------------------------------------------------------

// 16 bytes into shared memory by cp.async, the first `bytes` of them from
// `src` and the rest zeros (0 bytes: zeros, nothing read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// C (8 x 8) += A (8 x 4) B (4 x 8) on the float64 tensor cores: lane (g, t) =
// (lane / 4, lane % 4) gives A[g][t] and B[t][g] and holds C[g][2t], C[g][2t + 1]
__device__ __forceinline__ void dmma(double& c0, double& c1, double a, double b) {
  asm volatile("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, {%3}, {%0, %1};\n"
               : "+d"(c0), "+d"(c1)
               : "d"(a), "d"(b));
}

// C (16 x 8) += A (16 x 8) B (8 x 8) on the float64 tensor cores: lane (g, t)
// gives A[g][t], A[g + 8][t], A[g][t + 4], A[g + 8][t + 4] and B[t][g],
// B[t + 4][g], and holds C[g][2t], C[g][2t + 1], C[g + 8][2t], C[g + 8][2t + 1]
__device__ __forceinline__ void dmma16(double& c0, double& c1, double& c2, double& c3,
                                       const double (&a)[4], const double (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+d"(c0), "+d"(c1), "+d"(c2), "+d"(c3)
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
}

// one staged chunk of a tile product's two operands: kTile rows of kBK
// columns each, rows kStride doubles apart (the fragments' loads of a
// half-warp fall in 16 distinct bank pairs)
struct __align__(16) Stage {
  double P[kTile][kStride];
  double Q[kTile][kStride];
};

// columns [kc, kc + kBK) of rows [0, kTile) of P and Q into st by cp.async;
// zeros past an operand's rows and past column kdim
__device__ __forceinline__ void stage_chunk(Stage& st, const double* P, size_t ldp, int p_rows,
                                            const double* Q, size_t ldq, int q_rows, int kc,
                                            int kdim) {
  constexpr int kPieces = kTile * kBK / 2;   // 16-byte pieces an operand
  for (int idx = threadIdx.x; idx < 2 * kPieces; idx += kSolveThreads) {
    const bool q = idx >= kPieces;
    const int e = q ? idx - kPieces : idx, rr = e / (kBK / 2), cc = 2 * (e % (kBK / 2));
    const int col = kc + cc;
    const int bytes = rr < (q ? q_rows : p_rows) ? 8 * max(0, min(2, kdim - col)) : 0;
    const double* base = q ? Q : P;
    const double* src = bytes ? base + static_cast<size_t>(rr) * (q ? ldq : ldp) + col : base;
    cp_async16(q ? &st.Q[rr][cc] : &st.P[rr][cc], src, bytes);
  }
}

// acc = sum over m < kdim of P[r][m] Q[c][m] for a kTile x kTile tile on the
// tensor cores (m16n8k8), the operands staged kBK columns at a time into
// st[0] and st[1] in turns (the next chunk in flight while this one is
// multiplied).
// Warp (wm, wn) = (warp / 2, warp % 2) holds rows 32 wm + 8 i + g and columns
// 32 wn + 8 j + 2 t + e of the tile in acc[i][j][e]. Every thread of the
// block calls it; st is free again when it returns. The sum over m runs in
// the same order for every entry and every call.
__device__ void tile_product(Stage* st, const double* P, size_t ldp, int p_rows, const double* Q,
                             size_t ldq, int q_rows, int kdim, double acc[4][4][2]) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3, rm = 32 * (wid >> 1), cn = 32 * (wid & 1);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j][0] = acc[i][j][1] = 0.0;
  const int nk = (kdim + kBK - 1) / kBK;
  if (nk <= 0) return;
  stage_chunk(st[0], P, ldp, p_rows, Q, ldq, q_rows, 0, kdim);
  cp_async_commit();
  for (int kc = 0; kc < nk; ++kc) {
    if (kc + 1 < nk) {
      stage_chunk(st[(kc + 1) & 1], P, ldp, p_rows, Q, ldq, q_rows, (kc + 1) * kBK, kdim);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const Stage& s = st[kc & 1];
#pragma unroll
    for (int k8 = 0; k8 < kBK; k8 += 8) {
      double a[2][4], b[4][2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          a[i][q] = s.P[rm + 16 * i + 8 * (q & 1) + g][k8 + t + 4 * (q >> 1)];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int q = 0; q < 2; ++q) b[j][q] = s.Q[cn + 8 * j + g][k8 + t + 4 * q];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          dmma16(acc[2 * i][j][0], acc[2 * i][j][1], acc[2 * i + 1][j][0], acc[2 * i + 1][j][1],
                 a[i], b[j]);
    }
    __syncthreads();
  }
}

// the tiles of an update's rows [c0, n] (row n is g's) and columns [c0, c1):
// block b is tile (I, J); one column of tiles (J 0) where the columns are one
// kW-wide panel (narrow), else the lower triangle (J <= I) in one linear grid
__device__ __forceinline__ void tile_of(int b, bool narrow, int& I, int& J) {
  if (narrow) {
    I = b;
    J = 0;
    return;
  }
  I = static_cast<int>((sqrt(8.0 * b + 1.0) - 1.0) * 0.5);
  while ((I + 1) * (I + 2) / 2 <= b) ++I;
  while (I * (I + 1) / 2 > b) --I;
  J = b - I * (I + 1) / 2;
}

// tile b of an update of the lower part of rows [c0, n] and columns [c0, c1)
// by the solved panel columns [k0, k0 + kdim): A[r][c] -= sum_{m < kdim}
// A[r][k0 + m] A[c][k0 + m] (r >= c). The trailing update of a panel of kNB
// columns has c0 = k0 + kNB and c1 = n; inside the panel, the
// columns of its next kW-wide part take the update of the parts before it
// first (narrow: c0 = k0 + kdim, c1 = c0 + kW)
__device__ void update_tile(const Work& w, size_t ld, int n, int k0, int kdim, int c0, bool narrow,
                            int b, Stage* st) {
  int I, J;
  tile_of(b, narrow, I, J);
  const int c1 = narrow ? min(c0 + kW, n) : n;
  const int ri0 = c0 + kTile * I, ci0 = c0 + kTile * J;
  if (ri0 > n || ci0 >= c1) return;
  double* H = w.H;
  double acc[4][4][2];
  tile_product(st, H + static_cast<size_t>(ri0) * ld + k0, ld, n + 1 - ri0,
               H + static_cast<size_t>(ci0) * ld + k0, ld, c1 - ci0, kdim, acc);
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ri0 + 32 * (wid >> 1) + 8 * i + g;
    if (r > n) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = ci0 + 32 * (wid & 1) + 8 * j + 2 * t;
      double* h = H + static_cast<size_t>(r) * ld + c;
      if (c + 1 < c1 && r > c) {
        double2 v = __ldcg(reinterpret_cast<const double2*>(h));
        v.x -= acc[i][j][0];
        v.y -= acc[i][j][1];
        __stcg(reinterpret_cast<double2*>(h), v);
      } else {
        if (c < c1 && r >= c) __stcg(h, __ldcg(h) - acc[i][j][0]);
        if (c + 1 < c1 && r >= c + 1) __stcg(h + 1, __ldcg(h + 1) - acc[i][j][1]);
      }
    }
  }
}

// row block b below panel p's diagonal block (rows [kq + wd, n], kq = kW p):
// the panel's columns times L_pp^-T in place, X[r][c] = sum_{m <= c}
// A[r][kq + m] L_pp^-1[c][m] (a product, no division)
__device__ void panel_rows(const Work& w, size_t ld, int n, int p, int b, Stage* st) {
  const int kq = kW * p;
  if (kq >= n) return;
  const int wd = min(kW, n - kq), r0 = kq + wd + kTile * b;
  if (r0 > n) return;
  double* H = w.H;
  double acc[4][4][2];
  tile_product(st, H + static_cast<size_t>(r0) * ld + kq, ld, n + 1 - r0,
               w.Linv + static_cast<size_t>(p) * kW * kW, kW, wd, wd, acc);
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + 32 * (wid >> 1) + 8 * i + g;
    if (r > n) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = 32 * (wid & 1) + 8 * j + 2 * t;
      double* h = H + static_cast<size_t>(r) * ld + kq + c;
      if (c + 1 < wd) {
        __stcg(reinterpret_cast<double2*>(h), make_double2(acc[i][j][0], acc[i][j][1]));
      } else if (c < wd) {
        __stcg(h, acc[i][j][0]);
      }
    }
  }
}

// the kSub x kSub block at (s0, s0) of A factored in one warp by
// right-looking steps that scale each column by its pivot's reciprocal
// square root (no division), with L^-1 formed beside it. Lane i holds
// u[m] = L[i][m] for m <= i and, below the diagonal of column i of L^-1,
// u[m] = L^-1[m][i] for m > i: step j broadcasts column j of L (col, two
// buffers in turns) and every lane takes it off its row of L (lanes past j)
// or off its column of L^-1 (lanes up to j, times L^-1[j][i]) in one
// predicated loop. The next pivot comes from lane j + 1's own registers by
// a shuffle (the same fma as its loop's, so the same bits), ahead of the
// broadcast through shared memory. L goes into the lower part, L^-1 below
// its diagonal into the upper part transposed (L^-1[m][i] at A[s0 + i][s0 +
// m], m > i), its diagonal (the reciprocal roots) into dinv. col: 2 kSub
// doubles of shared memory
__device__ __forceinline__ void warp_factor(double (*A)[kW + 1], int s0, int lane, double* dinv,
                                            double* col) {
  double u[kSub];
#pragma unroll
  for (int m = 0; m < kSub; ++m) u[m] = m <= lane ? A[s0 + lane][s0 + m] : 0.0;
  double d = __shfl_sync(kFull, u[0], 0);
#pragma unroll
  for (int j = 0; j < kSub; ++j) {
    double* cj = col + kSub * (j & 1);
    const double rj = rsqrt(d);
    u[j] = lane == j ? d * rj : u[j] * rj;   // L[i][j] (i >= j), L^-1[j][i] (i < j)
    const double coef = lane == j ? rj : u[j];
    if (j + 1 < kSub) d = __shfl_sync(kFull, fma(-coef, u[j], u[j + 1]), j + 1);
    cj[lane] = u[j];
    __syncwarp();
#pragma unroll
    for (int m = j + 1; m < kSub; ++m)
      if (m <= lane || lane <= j) u[m] = fma(-coef, cj[m], u[m]);
    if (lane == 0) dinv[s0 + j] = rj;
  }
#pragma unroll
  for (int m = 0; m < kSub; ++m) A[s0 + lane][s0 + m] = u[m];
}

// doubles of shared memory of diag_block: A, dinv, the warp's broadcasts, T
constexpr int kDiagDoubles = kW * (kW + 1) + kW + 2 * kSub + kSub * (kSub + 1);

// panel p's diagonal block (rows and columns [kq, kq + wd), kq = kW p, the
// identity past wd), factored once, by one block in its shared memory, and
// its inverse written to Linv[p] (kW x kW row-major, zeros above the
// diagonal): the two kSub-wide halves by warp_factor, between them the lower
// half's rows times L_00^-T and its trailing update on the tensor cores (a
// warp 8 rows), then L^-1's lower-left block -L_11^-1 (L_10 L_00^-1)
__device__ void diag_block(const Work& w, size_t ld, int n, int p, double* sm) {
  const int kq = kW * p;
  if (kq >= n) return;
  double(*A)[kW + 1] = reinterpret_cast<double(*)[kW + 1]>(sm);
  double* dinv = sm + kW * (kW + 1);
  double* bc = dinv + kW;
  double(*T)[kSub + 1] = reinterpret_cast<double(*)[kSub + 1]>(bc + 2 * kSub);
  const int wd = min(kW, n - kq), tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  const int g = lane >> 2, t = lane & 3, r = kSub + 8 * wid + g;   // the warp's row below
  {   // every load of the block in flight at once, then into shared memory
    constexpr int kPer = kW * kW / kSolveThreads;
    double v[kPer];
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      const int i = (tid + kSolveThreads * q) / kW, j = tid % kW;
      v[q] = i < wd && j <= i ? __ldcg(w.H + static_cast<size_t>(kq + i) * ld + kq + j)
                              : (i == j ? 1.0 : 0.0);
    }
#pragma unroll
    for (int q = 0; q < kPer; ++q) A[(tid + kSolveThreads * q) / kW][tid % kW] = v[q];
  }
  __syncthreads();
  if (wid == 0) warp_factor(A, 0, lane, dinv, bc);
  __syncthreads();
  {   // rows kSub.. of columns 0..kSub: X = A L_00^-T
    double acc[4][2] = {};
#pragma unroll
    for (int k4 = 0; k4 < kSub; k4 += 4) {
      const int k = k4 + t;
      const double a = A[r][k];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = 8 * j + g;   // L_00^-1[c][k]
        dmma(acc[j][0], acc[j][1], a, k < c ? A[k][c] : (k == c ? dinv[c] : 0.0));
      }
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      A[r][8 * j + 2 * t] = acc[j][0];
      A[r][8 * j + 2 * t + 1] = acc[j][1];
    }
  }
  __syncthreads();
  {   // the lower half's trailing update: A[r][c] -= sum_k X[r][k] X[c][k], c <= r
    double acc[4][2] = {};
#pragma unroll
    for (int k4 = 0; k4 < kSub; k4 += 4) {
      const double a = A[r][k4 + t];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (j <= wid) dmma(acc[j][0], acc[j][1], a, A[kSub + 8 * j + g][k4 + t]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = kSub + 8 * j + 2 * t + e;
        if (j <= wid && c <= r) A[r][c] -= acc[j][e];
      }
  }
  __syncthreads();
  if (wid == 0) warp_factor(A, kSub, lane, dinv, bc);
  __syncthreads();
  {   // T = L_10 L_00^-1
    double acc[4][2] = {};
#pragma unroll
    for (int k4 = 0; k4 < kSub; k4 += 4) {
      const int k = k4 + t;
      const double a = A[r][k];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = 8 * j + g;   // L_00^-1[k][c]
        dmma(acc[j][0], acc[j][1], a, c < k ? A[c][k] : (c == k ? dinv[k] : 0.0));
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      T[8 * wid + g][8 * j + 2 * t] = acc[j][0];
      T[8 * wid + g][8 * j + 2 * t + 1] = acc[j][1];
    }
  }
  __syncthreads();
  {   // L^-1[kSub + a][c] = -(L_11^-1 T)[a][c], kept at A[c][kSub + a]
    double acc[4][2] = {};
    const int a_ = 8 * wid + g;
#pragma unroll
    for (int k4 = 0; k4 < kSub; k4 += 4) {
      const int k = k4 + t;   // L_11^-1[a_][k]
      const double a = k < a_ ? A[kSub + k][kSub + a_] : (k == a_ ? dinv[kSub + a_] : 0.0);
#pragma unroll
      for (int j = 0; j < 4; ++j) dmma(acc[j][0], acc[j][1], a, T[k][8 * j + g]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      A[8 * j + 2 * t][kSub + a_] = -acc[j][0];
      A[8 * j + 2 * t + 1][kSub + a_] = -acc[j][1];
    }
  }
  __syncthreads();
  double* L = w.Linv + static_cast<size_t>(p) * kW * kW;
  for (int idx = tid; idx < kW * kW; idx += kSolveThreads) {
    const int c = idx / kW, m = idx % kW;
    __stcg(L + idx, m < c ? A[m][c] : (m == c ? dinv[c] : 0.0));
  }
}

// back-substitution, panel p (rows [k0, k0 + wd), k0 = kW p; panels last to
// first): x_p = L_pp^-T y_p (y in row n) in every block, block 0 writes it,
// and block b takes L_p.^T x_p off y over the columns [kSolveThreads b,
// kSolveThreads (b + 1)) left of the panel. sm: 2 kW doubles
__device__ void back_cols(const Work& w, size_t ld, int n, int p, int b, double* sm) {
  const int k0 = kW * p;
  if (k0 >= n) return;
  const int wd = min(kW, n - k0), tid = threadIdx.x;
  double* H = w.H;
  double* yrow = H + static_cast<size_t>(n) * ld;
  double *y = sm, *x = sm + kW;
  if (tid < kW) y[tid] = tid < wd ? __ldcg(yrow + k0 + tid) : 0.0;
  __syncthreads();
  // the loops run over all kW rows, their loads in flight together: past wd
  // L^-1 is the identity and y 0 (x 0 there), and H's rows are not read
  if (tid < kW) {
    const double* L = w.Linv + static_cast<size_t>(p) * kW * kW;
    double Lc[kW];
#pragma unroll
    for (int m = 0; m < kW; ++m) Lc[m] = __ldcg(L + m * kW + tid);
    double s = 0.0;
#pragma unroll
    for (int m = 0; m < kW; ++m) s += Lc[m] * y[m];
    x[tid] = s;
  }
  const int c = kSolveThreads * b + tid;
  double Hc[kW];
#pragma unroll
  for (int m = 0; m < kW; ++m)
    Hc[m] = c < k0 && m < wd ? __ldcg(H + static_cast<size_t>(k0 + m) * ld + c) : 0.0;
  __syncthreads();
  if (b == 0 && tid < wd) __stcg(w.x + k0 + tid, x[tid]);
  if (c < k0) {
    double v = __ldcg(yrow + c);
#pragma unroll
    for (int m = 0; m < kW; ++m) v -= Hc[m] * x[m];
    __stcg(yrow + c, v);
  }
}

// the solve's launches, one step of the factorization each
__global__ void __launch_bounds__(kSolveThreads) diag_kernel(const Work w, size_t ld, int p) {
  __shared__ __align__(16) double sm[kDiagDoubles];
  diag_block(w, ld, *w.n, p, sm);
}

__global__ void __launch_bounds__(kSolveThreads) panel_kernel(const Work w, size_t ld, int p) {
  __shared__ Stage st[2];
  panel_rows(w, ld, *w.n, p, blockIdx.x, st);
}

__global__ void __launch_bounds__(kSolveThreads)
    update_kernel(const Work w, size_t ld, int k0, int kdim, int c0, int narrow) {
  __shared__ Stage st[2];
  update_tile(w, ld, *w.n, k0, kdim, c0, narrow != 0, blockIdx.x, st);
}

__global__ void __launch_bounds__(kSolveThreads) back_kernel(const Work w, size_t ld, int p) {
  __shared__ double sm[2 * kW];
  back_cols(w, ld, *w.n, p, blockIdx.x, sm);
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

// tiles of a column of rows [r0, D] (D = 7K, the plan's bound on n)
int row_tiles(int D, int r0) { return D + 1 > r0 ? (D + 1 - r0 + kTile - 1) / kTile : 1; }

struct Layout {
  size_t H, Linv, x, J, r, S, Sn, cost_e, cost, doubles;
};

// H's row stride: the 7K + 1 columns padded to the tile width (16-byte rows
// for cp.async)
size_t ld_of(int K) { return (7 * static_cast<size_t>(K) + 1 + kTile - 1) / kTile * kTile; }

Layout layout_of(int K, int E) {
  Layout l;
  const size_t D = 7 * static_cast<size_t>(K);
  size_t o = 0;
  l.H = o;      o += (D + 1) * ld_of(K);
  l.Linv = o;   o += (D + kW - 1) / kW * kW * kW;
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

// the solve's launches of an iteration, in order, planned from D = 7K alone
// (n <= D: no part or update past D): step(kind, k0, kq) for a part kq of
// the panel k0 (kNarrow but for its first part, kDiag, kPanel), the panel's
// kTrailing update but the last's; then a part's kBack launch, last to
// first
enum Step { kNarrow, kDiag, kPanel, kTrailing, kBack };

template <class F>
void for_each_solve_launch(int D, F step) {
  for (int k0 = 0; k0 < D; k0 += kNB) {
    for (int kq = k0; kq < std::min(k0 + kNB, D); kq += kW) {
      if (kq > k0) step(kNarrow, k0, kq);
      step(kDiag, k0, kq);
      step(kPanel, k0, kq);
    }
    if (k0 + kNB < D) step(kTrailing, k0, k0 + kNB);
  }
  for (int kq = (D - 1) / kW * kW; kq >= 0; kq -= kW) step(kBack, kq, kq);
}

}  // namespace

// scratch bytes of a call with K poses and E edges: the doubles of
// layout_of, then slot [K], n and the done counter
extern "C" long long tc2li_pose_graph_scratch(int K, int E) {
  return static_cast<long long>(8 * layout_of(K, E).doubles + 4 * (static_cast<size_t>(K) + 2));
}

// kernel launches of a tc2li_pose_graph_gn call over K >= 1 poses: setup
// and the entry cost, then an iteration's edge, assembly, pose and cost
// launches and its solve's (ops/kernels/pose_graph.py launches_per_call)
extern "C" long long tc2li_pose_graph_launches(int K, int iters) {
  long long solve = 0;
  for_each_solve_launch(7 * K, [&](Step, int, int) { ++solve; });
  return 2 + static_cast<long long>(iters) * (4 + solve);
}

// S_w [K, 4, 4], S_ij [E, 4, 4], weight [E] float32; ei, ej [E] int32;
// valid [E], fixed [K] uint8 (0 or 1); work: tc2li_pose_graph_scratch(K, E)
// bytes, 16-byte aligned; out [K, 4, 4] float32. All contiguous on the
// device. Launches tc2li_pose_graph_launches(K, iters) kernels on `stream`;
// returns the first CUDA error code that is not cudaSuccess.
extern "C" int tc2li_pose_graph_gn(const float* S_w, const int* ei, const int* ej,
                                   const float* S_ij, const float* weight, const uint8_t* valid,
                                   const uint8_t* fixed, int K, int E, int iters, void* work,
                                   float* out, void* stream) {
  if (K < 1 || E < 0 || iters < 0) return static_cast<int>(cudaErrorInvalidValue);
  const Layout l = layout_of(K, E);
  double* base = static_cast<double*>(work);
  int* ints = reinterpret_cast<int*>(base + l.doubles);
  const Work w{base + l.H, base + l.Linv, base + l.x, base + l.J, base + l.r, base + l.S,
               base + l.Sn, base + l.cost_e, base + l.cost, ints, ints + K,
               reinterpret_cast<unsigned*>(ints + K + 1)};
  size_t ld = ld_of(K);
  const Graph g{S_w, ei, ej, S_ij, weight, valid, fixed, K, E, ld, out};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int edge_blocks = E > 0 ? (kLanes * E + kThreads - 1) / kThreads : 1;
  const int cost_blocks = E > 0 ? (E + kThreads - 1) / kThreads : 1;
  const int pose_blocks = (K + kThreads - 1) / kThreads;
  const int D = 7 * K;
  int rc = 0;
  // the solve's steps; after a failed launch the rest do nothing
  const auto solve = [&](Step kind, int k0, int kq) {
    if (rc) return;
    if (kind == kNarrow) {
      update_kernel<<<row_tiles(D, kq), kSolveThreads, 0, st>>>(w, ld, k0, kq - k0, kq, 1);
    } else if (kind == kDiag) {
      diag_kernel<<<1, kSolveThreads, 0, st>>>(w, ld, kq / kW);
    } else if (kind == kPanel) {
      panel_kernel<<<row_tiles(D, kq + kW), kSolveThreads, 0, st>>>(w, ld, kq / kW);
    } else if (kind == kTrailing) {
      const int R = row_tiles(D, kq);
      update_kernel<<<R * (R + 1) / 2, kSolveThreads, 0, st>>>(w, ld, k0, kNB, kq, 0);
    } else {
      back_kernel<<<std::max(1, (kq + kSolveThreads - 1) / kSolveThreads), kSolveThreads, 0,
                    st>>>(w, ld, kq / kW);
    }
    rc = static_cast<int>(cudaGetLastError());
  };
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
    for_each_solve_launch(D, solve);
    if (rc) return rc;
    TC2LI_LAUNCH(poses_kernel<<<pose_blocks, kThreads, 0, st>>>(g, w));
    TC2LI_LAUNCH(cost_kernel<<<cost_blocks, kThreads, 0, st>>>(g, w, 1));
  }
#undef TC2LI_LAUNCH
  return 0;
}
