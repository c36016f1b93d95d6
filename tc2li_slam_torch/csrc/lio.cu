// The LiDAR-inertial scan step of the IMU mode (FAST-LIO2's per-scan
// iterated ESEKF update): four kernels.
//
// Replaces, in tc2li_slam_tpu, what the TPU runs inside the one jit of
// slam/lio.py:99 (lio_scan_step):
// - predict_kernel: estimation/esekf.py:192 (predict, its lax.scan :257);
// - the predict launch's fence blocks and rows_kernel: slam/lio.py:46
//   (make_h_fn, the measurement of an iterate) with ops/voxel_map.py:154
//   (knn, radius 2; its searchsorted) and ops/plane_fit.py:90
//   (fit_planes), and the normal-equation products of update_iterated;
// - step_kernel: estimation/esekf.py:266 (update_iterated, its lax.scan
//   :308) after the products, and the divergence guard of lio_scan_step.
// Eager PyTorch ran a scan step as ~5,000 small ops, each a launch.
//
// What they compute is the plain versions' (ops/kernels/lio.py:
// predict_plain, fences_plain, make_h_fn, scan_update_plain); a scan step
// at max_iters k is 1 + (k + 2) + (k + 1) launches:
//   predict with the fence table; rows(x_0), step, ..., rows(x_{k-1}),
//   step; rows(x_k), final; rows(guarded x, last)
// with the filter state packed as 36 float32 (pos, R, R_LI, t_LI, vel, bg,
// ba, grav) followed by P [23, 23]. The predict launch is an ordinary one:
// it starts after everything before it on the stream (the last scan step's
// map insert and recentring included), and the pool's keys do not change
// until the step's own insert, after its last rows launch. The rows and
// step launches are programmatic dependents of the launch before them:
// their blocks start while it ends. The rule they keep: each kernel runs
// griddepcontrol.wait before it reads anything and before it triggers its
// dependents. The wait orders a kernel after its immediate primary only;
// that primary completes only after its own wait, so waits chain the order
// back to every older launch (the first rows launch's primary is the last
// of the eager ops after the predict launch, which complete after it). A
// read before the wait, or a trigger before it, lets a launch read the
// fence table or the iterate before an older launch has written them (on
// the card: a garbage fence count, and shared memory indexed out of bounds,
// in a chain of bad-IMU scan steps).
//
// predict_kernel, two warps, the window in rounds of 32 slots, a sample
// with dt <= 0 skipped (an exact no-op at any launch size). Warp 1: (a) a
// lane a sample computes what needs no chain (phi = (gyro - bg) dt, dRi,
// Jr, a = acc - ba; bg and ba do not change inside predict); (b) lanes
// 0-8 run the chain of R, p and v over the round's live samples in
// registers, a lane an entry of the 3 x 3 products (R's rows by
// shuffles), and publish each sample's two blocks of F that read R
// (-R hat(a) dt, -R dt) by a counter in shared memory; every lane writes
// its slot's pose.
// Warp 0, meanwhile: P <- F P F^T + Fw Q Fw^T for each published sample
// (it waits on the counter with a back-off of 8 to 64 ns), a lane a
// column of P in registers: the rows of G = F P that differ from
// P's (POS, ROT, VEL: 9 of 23) on the lane's column, to shared memory (two
// buffers, one __syncwarp a sample); then P_new = G F^T, symmetric: a
// column outside those rows is G's, a column c inside them is row c of
// P_new, G's row c outside them and F's rows applied to G's row c inside.
// One block barrier a round. float32, as both packages are.
//
// The fence table, once a scan step (the pool does not change inside it):
// every 32nd pool key (more apart above 2^19 slots: the table stays within
// 64 KB) and the number of fences below the first kEmpty one, written by
// the predict launch's blocks after its first, 4 fences a thread with their
// loads side by side (64 blocks at 2^19 slots). A launch of its own cost
// ~1.5 us for a 39 ns bound: the floor of a launch. Beside the predict
// block (one SM, ~6 us) the fence blocks run on other SMs.
//
// rows_kernel: 256 blocks of 8 warps at most, a function of M alone; block
// b takes batches b, b + G, ... of 32 queries, so every sum's order is
// fixed. Each block copies the fences below kEmpty to shared memory. A
// warp searches 4 queries of a batch at once, a lane a voxel column of
// radius 2 (25 of them): the query's p_b and p_w; lower_bound of the
// column's first key as a branchless search of the fences in shared memory
// and then of the fence's bucket of 32 keys in L2 (its first probe brings
// the bucket's line, the others hit L1), equal to lower_bound over the
// whole pool for any key; the fixed run of 5 candidates, validated by the
// key range as knn does; the 5 nearest by (d^2, candidate index), the order
// of a stable sort, as 64-bit keys: each lane sorts its 5 by a network of 9
// exchanges, then five warp-wide minima of the lanes' heads (float32, as the
// plain version, so the neighbour sets are its own but where a query lies
// within an ulp of a voxel face); the neighbours' slots and points to
// shared memory. Then warp 0 takes the batch, a lane a query: in float64
// from the float32 neighbours, the closed-form plane fit of
// plane_fit.fit_planes, the gate s > 0.9 and dists[0] < 5, and the row (6
// non-zero columns, 12 with the extrinsic), the arithmetic of the form
// before (a fit of near-collinear points has its normal decided by
// rounding: float32 fits differ there from each other and from float64 by
// ~1e-3 of the normal equations' scale). Its lanes keep up to three entries
// each of sum h h^T (upper triangle), sum h z and the inlier count in
// float64, over the block's queries in order, and write the block's
// partial sums entry-major [E, G]. No atomics in a sum: the same bits on
// every call. The last evaluation (at the guarded state) writes p_w and
// counts its inliers (integer atomicAdd, exact in any order) instead.
//
// step_kernel, one block of 8 warps. First, side by side: the blocks'
// partials added in a fixed order (a warp an entry, its lanes over the
// blocks, coalesced) on five warps; the tangent terms at the iterate on
// the other three (boxminus: the inverse right Jacobians of the two SO(3)
// blocks on two warps; the 2x2 S2 block by forward-mode dual numbers
// through s2_boxplus / s2_boxminus, Taylor branch included, as jacfwd
// differentiates it, on a third). The first launch also inverts P0 + 1e-9 I
// on warps 0-3 (Gauss-Jordan, partial pivoting by a warp argmax that keeps
// a serial scan's pivots, rows left in place and their positions swapped)
// while warps 4-7 add the partials, and keeps P0^-1 in device memory for
// the later launches. Then A = H^T H / r + L^T P0^-1 L and b on the block;
// on warp 0 the Cholesky factor in registers (a column's entries broadcast
// through shared memory) and both triangular solves column by column across
// the lanes; boxplus under the convergence mask, its three rotations on
// three warps. The final launch forms P = (H^T H / r + L^T P0^-1 L)^-1
// symmetrised (the same Gauss-Jordan on the block) in the tangent of the
// state as written, runs the bad-state test (non-finite, or |v| > 60 m/s)
// and writes the filter, or the one from before the scan. float64 from the
// float32 inputs (H^T H / r ~1e7 beside P0^-1's 1e5); the iterate is kept
// in float64 between launches and rounded for the rows.
//
// Bound on the H100: latency. A scan step at 8,192 points reads ~2.5 MB of
// keys and points an evaluation and does ~1e7 float32 operations; the steps
// are a few 1e5 float64 operations on dependent phases of one block. What
// the design does about it: a search of few dependent loads (the fences in
// shared memory, one bucket in L2), 4 queries in flight a warp and two
// blocks an SM; a fit a lane; the step's terms that need no sums beside
// its reduction; no one-thread phase in the step; in the prediction only
// the chain of R, p and v on one lane, the rest a lane a sample or a
// column and no block barrier.

#include <cuda_runtime.h>
#include <stdint.h>

#ifdef TC2LI_LAPS   // clock laps of a phase split (laps.cuh, tools/lio_kernels.py)
#define TC2LI_LAP_TAG lio
#include "laps.cuh"
#else
#define TC2LI_LAP_START
#define TC2LI_LAP(k)
#endif

namespace {

constexpr int kErr = 23;
constexpr int kState = 36;
constexpr int kPacked = kState + kErr * kErr;   // 565
constexpr int kPos = 0, kR = 3, kRLI = 12, kTLI = 21, kVel = 24, kBg = 27, kBa = 30, kGrav = 33;
constexpr int kThreads = 256;
constexpr int kNb = 5;            // neighbours
constexpr int kCols = 25;         // voxel columns of radius 2
constexpr int kRun = 5;           // candidates a column
constexpr int kGridSize = 1024;   // voxels a grid axis
constexpr int kEmpty = 0x7fffffff;
constexpr int kMaxEntries = 96;   // >= n_entries(12) = 91
// the step's state in device memory: P0^-1, the iterate, converged,
// iterations
constexpr int kWorkIter = kErr * kErr, kWorkConv = kWorkIter + kState;
constexpr int kWork = kWorkConv + 2;
constexpr int kTangent = kErr + 9 + 9 + 4;   // the tangent terms: dx0, Lr, Le, Lg
constexpr double kEps = 5e-3;     // geom/lie.py _EPS
constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ constexpr int n_entries(int ncols) {
  return ncols * (ncols + 1) / 2 + ncols + 1;
}

// ---------------------------------------------------------------------------
// SO(3) and S2 helpers (geom/lie.py, estimation/esekf.py), float or double
// ---------------------------------------------------------------------------

template <typename T>
__device__ __forceinline__ T sinc_(T x) {
  const T x2 = x * x;
  return fabs(x) < T(kEps) ? T(1) - x2 / T(6) + x2 * x2 / T(120) : sin(x) / x;
}

template <typename T>
__device__ __forceinline__ T cosc_(T x) {
  const T x2 = x * x;
  return fabs(x) < T(kEps) ? T(0.5) - x2 / T(24) + x2 * x2 / T(720) : (T(1) - cos(x)) / (x * x);
}

template <typename T>
__device__ __forceinline__ T sinc3_(T x) {
  const T x2 = x * x;
  return fabs(x) < T(kEps) ? T(1) / T(6) - x2 / T(120) + x2 * x2 / T(5040)
                           : (x - sin(x)) / (x * x * x);
}

template <typename T>
__device__ __forceinline__ T safe_theta(const T* w) {
  const T s = w[0] * w[0] + w[1] * w[1] + w[2] * w[2];
  return sqrt(s < T(1e-24) ? T(1e-24) : s);
}

template <typename T>
__device__ __forceinline__ void hat3(const T* w, T* W) {
  W[0] = T(0); W[1] = -w[2]; W[2] = w[1];
  W[3] = w[2]; W[4] = T(0); W[5] = -w[0];
  W[6] = -w[1]; W[7] = w[0]; W[8] = T(0);
}

template <typename T>
__device__ __forceinline__ void mul3(const T* A, const T* B, T* C) {   // C = A B
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      C[3 * i + j] = A[3 * i] * B[j] + A[3 * i + 1] * B[3 + j] + A[3 * i + 2] * B[6 + j];
}

template <typename T>
__device__ __forceinline__ void mul3tn(const T* A, const T* B, T* C) {   // C = A^T B
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      C[3 * i + j] = A[i] * B[j] + A[3 + i] * B[3 + j] + A[6 + i] * B[6 + j];
}

template <typename T>
__device__ __forceinline__ void matvec3(const T* A, const T* v, T* out) {
#pragma unroll
  for (int i = 0; i < 3; ++i) out[i] = A[3 * i] * v[0] + A[3 * i + 1] * v[1] + A[3 * i + 2] * v[2];
}

template <typename T>
__device__ __forceinline__ void cross3(const T* a, const T* b, T* c) {
  c[0] = a[1] * b[2] - a[2] * b[1];
  c[1] = a[2] * b[0] - a[0] * b[2];
  c[2] = a[0] * b[1] - a[1] * b[0];
}

// I + c1 W + c2 W^2, W = hat(w)
template <typename T>
__device__ __forceinline__ void rodrigues(const T* w, T c1, T c2, T* E) {
  T W[9], W2[9];
  hat3(w, W);
  mul3(W, W, W2);
#pragma unroll
  for (int e = 0; e < 9; ++e) E[e] = ((e % 4 == 0) ? T(1) : T(0)) + c1 * W[e] + c2 * W2[e];
}

template <typename T>
__device__ __forceinline__ void so3_exp(const T* w, T* E) {
  const T th = safe_theta(w);
  rodrigues(w, sinc_(th), cosc_(th), E);
}

// right Jacobian J_r(w) = J_l(-w) = I + cosc hat(-w) + sinc3 hat(-w)^2
template <typename T>
__device__ __forceinline__ void so3_right_jacobian(const T* w, T* J) {
  const T m[3] = {-w[0], -w[1], -w[2]};
  const T th = safe_theta(m);
  rodrigues(m, cosc_(th), sinc3_(th), J);
}

// J_r^-1(w) = J_l^-1(-w) = I - hat(-w) / 2 + cot hat(-w)^2
__device__ void so3_right_jacobian_inv(const double* w, double* J) {
  const double m[3] = {-w[0], -w[1], -w[2]};
  const double th = safe_theta(m);
  const bool small = th < kEps;
  const double ts = small ? 1.0 : th;
  const double t2 = th * th;
  const double cot = small ? 1.0 / 12.0 + t2 / 720.0 + t2 * t2 / 30240.0
                           : (1.0 / (ts * ts)) - (sin(ts) / (2.0 * ts * (1.0 - cos(ts))));
  rodrigues(m, -0.5, cot, J);
}

// geom/lie.so3_log, the branch near pi included
__device__ void so3_log(const double* R, double* w) {
  const double tr = R[0] + R[4] + R[8];
  double c = (tr - 1.0) * 0.5;
  c = c < -1.0 ? -1.0 : (c > 1.0 ? 1.0 : c);
  const double ws[3] = {R[7] - R[5], R[2] - R[6], R[3] - R[1]};
  double s2 = ws[0] * ws[0] + ws[1] * ws[1] + ws[2] * ws[2];
  const double s = 0.5 * sqrt(s2 < 1e-24 ? 1e-24 : s2);
  const double th = atan2(s, c);
  if (!(th > 3.14159265358979323846 - 1e-3)) {
    const double f = 0.5 / sinc_(th);
#pragma unroll
    for (int k = 0; k < 3; ++k) w[k] = f * ws[k];
    return;
  }
  double Rp[9], dg[3], ax[3];
#pragma unroll
  for (int e = 0; e < 9; ++e) Rp[e] = (R[e] + ((e % 4 == 0) ? 1.0 : 0.0)) * 0.5;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    dg[k] = Rp[4 * k] < 0.0 ? 0.0 : Rp[4 * k];
    ax[k] = sqrt(dg[k]);
  }
  int k = 0;
  if (ax[1] > ax[k]) k = 1;
  if (ax[2] > ax[k]) k = 2;
  const double den = ax[k] < 1e-12 ? 1.0 : ax[k];
  double a[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) a[j] = (j == k ? dg[k] : Rp[3 * k + j]) / den;
  double n = sqrt(a[0] * a[0] + a[1] * a[1] + a[2] * a[2]);
  n = n < 1e-12 ? 1e-12 : n;
#pragma unroll
  for (int j = 0; j < 3; ++j) w[j] = a[j] / n * th;
}

// esekf.s2_basis: B [3, 2] row-major (B[2 a + m])
template <typename T>
__device__ void s2_basis(const T* g, T* B) {
  int k = 0;
  if (fabs(g[1]) < fabs(g[k])) k = 1;
  if (fabs(g[2]) < fabs(g[k])) k = 2;
  const T seed[3] = {T(k == 0), T(k == 1), T(k == 2)};
  T b1[3], b2[3], gn[3];
  cross3(g, seed, b1);
  T n1 = sqrt(b1[0] * b1[0] + b1[1] * b1[1] + b1[2] * b1[2]);
  n1 = n1 < T(1e-12) ? T(1e-12) : n1;
  T ng = sqrt(g[0] * g[0] + g[1] * g[1] + g[2] * g[2]);
  ng = ng < T(1e-12) ? T(1e-12) : ng;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    b1[j] = b1[j] / n1;
    gn[j] = g[j] / ng;
  }
  cross3(gn, b1, b2);
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    B[2 * j] = b1[j];
    B[2 * j + 1] = b2[j];
  }
}

// g + d = Exp(B(g) d) g
__device__ void s2_boxplus(const double* g, const double* d, double* out) {
  double B[6], u[3], E[9];
  s2_basis(g, B);
#pragma unroll
  for (int j = 0; j < 3; ++j) u[j] = B[2 * j] * d[0] + B[2 * j + 1] * d[1];
  so3_exp(u, E);
  matvec3(E, g, out);
}

// esekf.s2_boxminus(g1, g0) and, with dg1 != nullptr, its derivative along
// the two tangents dg1[k] of g1 (forward mode: each quantity with its two
// derivatives, the where-switched branches as jacfwd takes them)
__device__ void s2_boxminus(const double* g1, const double* g0, double* out,
                            double (*dg1)[3] = nullptr, double (*dout)[2] = nullptr) {
  double n0[3], n1[3], cr[3], B0[6];
  double m0 = sqrt(g0[0] * g0[0] + g0[1] * g0[1] + g0[2] * g0[2]);
  m0 = m0 < 1e-12 ? 1e-12 : m0;
  const double m1r = sqrt(g1[0] * g1[0] + g1[1] * g1[1] + g1[2] * g1[2]);
  const double m1 = m1r < 1e-12 ? 1e-12 : m1r;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    n0[j] = g0[j] / m0;
    n1[j] = g1[j] / m1;
  }
  cross3(n0, n1, cr);
  const double c = n0[0] * n1[0] + n0[1] * n1[1] + n0[2] * n1[2];
  const double s2 = cr[0] * cr[0] + cr[1] * cr[1] + cr[2] * cr[2];
  const bool small = s2 < 1e-6;
  const double ss = sqrt(small ? 1.0 : s2);
  const double at = atan2(ss, c);
  const double f = small ? 1.0 + s2 / 6.0 : at / ss;
  s2_basis(g0, B0);
  double v[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) v[j] = f * cr[j];
  out[0] = B0[0] * v[0] + B0[2] * v[1] + B0[4] * v[2];
  out[1] = B0[1] * v[0] + B0[3] * v[1] + B0[5] * v[2];
  if (dg1 == nullptr) return;
  for (int k = 0; k < 2; ++k) {
    // |g1|' = g1.dg1 / |g1| (the clamp passes it above 1e-12)
    const double dm1 = m1r < 1e-12 ? 0.0
                                   : (g1[0] * dg1[k][0] + g1[1] * dg1[k][1] + g1[2] * dg1[k][2]) / m1r;
    double dn1[3], dcr[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) dn1[j] = dg1[k][j] / m1 - g1[j] * dm1 / (m1 * m1);
    cross3(n0, dn1, dcr);
    const double dc = n0[0] * dn1[0] + n0[1] * dn1[1] + n0[2] * dn1[2];
    const double ds2 = 2.0 * (cr[0] * dcr[0] + cr[1] * dcr[1] + cr[2] * dcr[2]);
    double df;
    if (small) {
      df = ds2 / 6.0;
    } else {
      const double dss = ds2 / (2.0 * ss);
      const double dat = (c * dss - ss * dc) / (ss * ss + c * c);
      df = dat / ss - at * dss / (ss * ss);
    }
    double dv[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) dv[j] = df * cr[j] + f * dcr[j];
    dout[0][k] = B0[0] * dv[0] + B0[2] * dv[1] + B0[4] * dv[2];
    dout[1][k] = B0[1] * dv[0] + B0[3] * dv[1] + B0[5] * dv[2];
  }
}

// ---------------------------------------------------------------------------
// predict
// ---------------------------------------------------------------------------

struct Noise {
  float g, a, bg, ba;   // variances of the gyro, accel, and their walks
};

// esekf.predict's F = I but for F[POS, VEL] = I dt, F[ROT, ROT] = dRi^T,
// F[ROT, BG] = -Jr dt, F[VEL, ROT] = -R hat(a) dt, F[VEL, BA] = -R dt,
// F[VEL, GRAV] = gB dt; Fw's blocks: Fw[ROT] = -Jr dt, Fw[VEL] = -R dt,
// Fw[BG] = Fw[BA] = I dt. Only F's rows A = POS, ROT, VEL (0-5, 12-14)
// differ from the identity's.
constexpr int kRound = 32;     // samples a round: a lane a sample
constexpr int kRowsA = 9;      // F's rows A
__host__ __device__ constexpr int row_a(int a) { return a < 6 ? a : a + 6; }

// the per-sample terms of a round (a lane a sample), then the chain's; a
// 3 x 3 block takes 12 floats, three 16-byte words
struct __align__(16) PredictRound {
  float dri[kRound][12];   // dRi
  float frbg[kRound][12];  // F[ROT, BG] = -Jr dt
  float fvr[kRound][12];   // F[VEL, ROT] = -R hat(a) dt, R before the sample
  float fvba[kRound][12];  // F[VEL, BA] = -R dt
  float acc[kRound][3];    // a = acc - ba
  float dt[kRound];
  float pose[kRound + 1][12];   // R and p before the round, then after each live sample
  unsigned lives;          // the round's live slots
};

// a 3 x 3 block to and from its 12 floats of shared memory
__device__ __forceinline__ void put9(float* dst, const float* v) {
  float4* d = reinterpret_cast<float4*>(dst);
  d[0] = make_float4(v[0], v[1], v[2], v[3]);
  d[1] = make_float4(v[4], v[5], v[6], v[7]);
  d[2] = make_float4(v[8], 0.f, 0.f, 0.f);
}

__device__ __forceinline__ void get9(const float* src, float* v) {
  const float4* s4 = reinterpret_cast<const float4*>(src);
  const float4 a = s4[0], b = s4[1], c = s4[2];
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
  v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
  v[8] = c.x;
}

// a shared int written with release and read with acquire semantics at
// block scope: the reads after an acquire that sees a release's value see
// what preceded the release (the writer's own writes, and those ordered
// before it by a barrier)
__device__ __forceinline__ void store_release(int* p, int v) {
  asm volatile("st.release.cta.shared.b32 [%0], %1;"
               :
               : "r"(static_cast<unsigned>(__cvta_generic_to_shared(p))), "r"(v)
               : "memory");
}

__device__ __forceinline__ int load_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.cta.shared.b32 %0, [%1];"
               : "=r"(v)
               : "r"(static_cast<unsigned>(__cvta_generic_to_shared(p)))
               : "memory");
  return v;
}

// F's blocks of one sample in registers (broadcast reads)
struct FBlocks {
  float Frr[9], Frbg[9], Fvr[9], Fvba[9], Fvg[6], dt;
};

// row i of F applied to the column col(k), k over the error state
template <typename Col>
__device__ __forceinline__ float apply_F(const FBlocks& b, int i, Col col) {
  if (i < 3) return col(i) + b.dt * col(12 + i);
  if (i < 6) {
    const int a = i - 3;
    return b.Frr[3 * a] * col(3) + b.Frr[3 * a + 1] * col(4) + b.Frr[3 * a + 2] * col(5)
           + b.Frbg[3 * a] * col(15) + b.Frbg[3 * a + 1] * col(16) + b.Frbg[3 * a + 2] * col(17);
  }
  const int a = i - 12;
  return col(i) + b.Fvr[3 * a] * col(3) + b.Fvr[3 * a + 1] * col(4) + b.Fvr[3 * a + 2] * col(5)
         + b.Fvba[3 * a] * col(18) + b.Fvba[3 * a + 1] * col(19) + b.Fvba[3 * a + 2] * col(20)
         + b.Fvg[2 * a] * col(21) + b.Fvg[2 * a + 1] * col(22);
}

// (Fw Q Fw^T)_ij for i, j both in ROT or both in VEL, from the rows wi, wj
// of -Jr dt or -R dt (Frbg, Fvba)
__device__ __forceinline__ float block_noise(const float* wi, float q, const float (&wj)[3]) {
  return (wi[0] * q) * wj[0] + (wi[1] * q) * wj[1] + (wi[2] * q) * wj[2];
}

// The fence table of the pool keys, written by the predict launch's blocks
// after its first: F[j] = keys[j << lg] for j < nf = ceil(cap / 2^lg), and
// at F[nf] the number of fences below the first kEmpty one (exactly one
// thread writes it: the keys ascend). keys null: no table, no such blocks.
struct FenceArgs {
  const int* keys;   // [cap] ascending, kEmpty pad
  int cap, lg, nf;
  int* F;            // [nf + 1]
};
constexpr int kPredictThreads = 64;
constexpr int kFencesThread = 4;   // consecutive fences a thread, their loads side by side
constexpr int kFencesBlock = kPredictThreads * kFencesThread;

// fence block b (block b + 1 of the launch): fences j0 .. j0 + 3 of a
// thread, and the first fence of the next thread's run for the count
__device__ __forceinline__ void fence_blocks(const FenceArgs& fa, int b) {
  const int j0 = (b * kPredictThreads + static_cast<int>(threadIdx.x)) * kFencesThread;
  if (j0 >= fa.nf) return;
  int f[kFencesThread + 1];
#pragma unroll
  for (int q = 0; q <= kFencesThread; ++q) {
    const int j = j0 + q;
    f[q] = j < fa.nf ? __ldg(fa.keys + (static_cast<size_t>(j) << fa.lg)) : kEmpty;
  }
#pragma unroll
  for (int q = 0; q < kFencesThread; ++q) {
    const int j = j0 + q;
    if (j < fa.nf) {
      fa.F[j] = f[q];
      if (f[q] != kEmpty && f[q + 1] == kEmpty) fa.F[fa.nf] = j + 1;
    }
  }
  if (j0 == 0 && f[0] == kEmpty) fa.F[fa.nf] = 0;
}

// Two warps. Warp 1, the chain: a round's per-sample terms a lane a
// sample, then on lanes 0-8 the chain over the round's live samples, each
// published to warp 0 by a counter in shared memory, then every slot's pose.
// Warp 0, P: a lane a column of P in registers, each live sample's update
// as soon as the chain has published it. A barrier a round hands the
// round's terms over; the rounds' shared memory alternates between two
// buffers, so warp 1 fills the next round's while warp 0 reads this one's.
// Blocks 1 .. of the launch write the fence table (fence_blocks) beside it.
__global__ void __launch_bounds__(kPredictThreads)
predict_kernel(const float* __restrict__ xin, const float* __restrict__ gyro,
               const float* __restrict__ acc, const float* __restrict__ dts, int N, Noise q,
               float* __restrict__ xout, float* __restrict__ R_traj, float* __restrict__ p_traj,
               const FenceArgs fa) {
  if (blockIdx.x > 0) {
    fence_blocks(fa, blockIdx.x - 1);
    return;
  }
  __shared__ PredictRound rds[2];
  __shared__ __align__(16) float ga[2][kRowsA][32];   // G = F P's rows A, a column a lane (two buffers)
  __shared__ float s[kState];
  __shared__ int chained;               // live samples the chain has published
  const int lane = threadIdx.x & 31;
  const bool chain_warp = threadIdx.x >= 32;
  TC2LI_LAP_START
  if (chain_warp) {
    for (int e = lane; e < kState; e += 32) s[e] = xin[e];
    if (lane == 0) chained = 0;
  }
  // warp 0: lane c < 23 keeps column c of P in registers (lanes 23-31 a
  // copy of 22, written nowhere), and gB = -hat(grav) s2_basis(grav)
  const int c = lane < kErr ? lane : kErr - 1;
  float p[kErr], gB[6];
  if (!chain_warp) {
#pragma unroll
    for (int r = 0; r < kErr; ++r) p[r] = xin[kState + r * kErr + c];
    float B[6], H[9];
    s2_basis(xin + kGrav, B);
    hat3(xin + kGrav, H);
#pragma unroll
    for (int a = 0; a < 3; ++a)
#pragma unroll
      for (int m = 0; m < 2; ++m)
        gB[2 * a + m] = (-H[3 * a]) * B[m] + (-H[3 * a + 1]) * B[2 + m] + (-H[3 * a + 2]) * B[4 + m];
  }
  // warp 1, the chain: lane e < 9 holds R's entry e (row e / 3, column
  // e % 3), lane k < 3 p's and v's entry k; and the next round's samples,
  // loaded a round ahead
  float Re = 0.f, pk = 0.f, vk = 0.f, nd = 0.f, ng[3], na[3];
  int n_chained = 0;
  if (chain_warp) {
    if (lane < N) {
      nd = dts[lane];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        ng[k] = gyro[3 * lane + k];
        na[k] = acc[3 * lane + k];
      }
    }
    __syncwarp();
    if (lane < 9) Re = s[kR + lane];
    if (lane < 3) {
      pk = s[kPos + lane];
      vk = s[kVel + lane];
    }
  }
  TC2LI_LAP(46);
  int n_live = 0;   // warp 0: live samples updated so far
  int gbuf = 0;
  for (int i0 = 0, rnd = 0; i0 < N; i0 += kRound, ++rnd) {
    PredictRound& rd = rds[rnd & 1];
    const int i = i0 + lane;
    if (chain_warp) {
      // (a) a sample's terms that need no chain, a lane a sample
      const float dt = nd;
      float w[3], ac[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        w[k] = ng[k];
        ac[k] = na[k];
      }
      nd = 0.f;
      if (i + kRound < N) {
        nd = dts[i + kRound];
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          ng[k] = gyro[3 * (i + kRound) + k];
          na[k] = acc[3 * (i + kRound) + k];
        }
      }
      const bool live = dt > 0.f;
      if (live) {
        float phi[3], dRi[9], Jr[9];
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          phi[k] = (w[k] - s[kBg + k]) * dt;
          rd.acc[lane][k] = ac[k] - s[kBa + k];
        }
        so3_exp(phi, dRi);
        so3_right_jacobian(phi, Jr);
#pragma unroll
        for (int e = 0; e < 9; ++e) Jr[e] = -Jr[e] * dt;
        put9(rd.dri[lane], dRi);
        put9(rd.frbg[lane], Jr);
        rd.dt[lane] = dt;
      }
      const unsigned lives = __ballot_sync(kFull, live);
      if (lane == 0) rd.lives = lives;
    }
    __syncthreads();   // the round's terms, for both warps
    TC2LI_LAP(47);
    const unsigned lives = rd.lives;
    if (chain_warp) {
      // (b) the chain on lanes 0-8, a lane an entry of the 3 x 3 products
      // (each entry in mul3's and matvec3's order): R, p and v, F's two
      // blocks that read R and the pose after each live sample, published
      // one by one
      if (lane < 9) {
        constexpr unsigned kChain = 0x1ffu;
        const int er = lane / 3, ec = lane - 3 * er;   // this lane's entry of a 3 x 3
        rd.pose[0][lane] = Re;
        if (lane < 3) rd.pose[0][9 + lane] = pk;
        for (unsigned m = lives; m; m &= m - 1) {
          const int j = __ffs(m) - 1;
          const float dtj = rd.dt[j];
          const float a0 = rd.acc[j][0], a1 = rd.acc[j][1], a2 = rd.acc[j][2];
          // row er of R, and for lanes 0-2 row k = lane (a v's row)
          const float r0 = __shfl_sync(kChain, Re, 3 * er), r1 = __shfl_sync(kChain, Re, 3 * er + 1),
                      r2 = __shfl_sync(kChain, Re, 3 * er + 2);
          const int kr = lane < 3 ? lane : 0;
          const float k0 = __shfl_sync(kChain, Re, 3 * kr), k1 = __shfl_sync(kChain, Re, 3 * kr + 1),
                      k2 = __shfl_sync(kChain, Re, 3 * kr + 2);
          // column ec of hat(a)
          const float h0 = ec == 0 ? 0.f : (ec == 1 ? -a2 : a1);
          const float h1 = ec == 0 ? a2 : (ec == 1 ? 0.f : -a0);
          const float h2 = ec == 0 ? -a1 : (ec == 1 ? a0 : 0.f);
          rd.fvr[j][lane] = -(r0 * h0 + r1 * h1 + r2 * h2) * dtj;
          rd.fvba[j][lane] = -Re * dtj;
          __syncwarp(kChain);   // (orders the nine lanes' writes before lane 0's release)
          if (lane == 0) store_release(&chained, ++n_chained);   // sample j's blocks, to warp 0
          if (lane < 3) {
            const float aw = (k0 * a0 + k1 * a1 + k2 * a2) + s[kGrav + lane];
            pk = pk + vk * dtj + 0.5f * aw * dtj * dtj;
            vk = vk + aw * dtj;
            rd.pose[j + 1][9 + lane] = pk;
          }
          const float* dRi = rd.dri[j];
          Re = r0 * dRi[ec] + r1 * dRi[3 + ec] + r2 * dRi[6 + ec];
          rd.pose[j + 1][lane] = Re;
        }
      }
      __syncwarp();
      // every slot's pose: after the last live sample at or before it
      if (i < N) {
        const unsigned upto = lives & (0xffffffffu >> (31 - lane));
        const int k = upto ? 32 - __clz(upto) : 0;
#pragma unroll
        for (int e = 0; e < 9; ++e) R_traj[9 * i + e] = rd.pose[k][e];
#pragma unroll
        for (int r = 0; r < 3; ++r) p_traj[3 * i + r] = rd.pose[k][9 + r];
      }
      continue;
    }
    // (c) warp 0: P <- F P F^T + Fw Q Fw^T a live sample at a time
    for (unsigned m = lives; m; m &= m - 1, ++n_live) {
      const int j = __ffs(m) - 1;
      // (a back-off: the spin's loads leave shared memory to the chain)
      for (int ns = 8; load_acquire(&chained) <= n_live; ns = ns < 64 ? 2 * ns : ns) {
        __nanosleep(ns);
      }
      TC2LI_LAP(51);
      FBlocks b;
      b.dt = rd.dt[j];
      float dRi[9];
      get9(rd.dri[j], dRi);
#pragma unroll
      for (int r = 0; r < 3; ++r)
#pragma unroll
        for (int cc = 0; cc < 3; ++cc) b.Frr[3 * r + cc] = dRi[3 * cc + r];
      get9(rd.frbg[j], b.Frbg);
      get9(rd.fvr[j], b.Fvr);
      get9(rd.fvba[j], b.Fvba);
#pragma unroll
      for (int e = 0; e < 6; ++e) b.Fvg[e] = gB[e] * b.dt;
      // G = F P on this column: its rows A, to shared memory
      float g[kRowsA];
#pragma unroll
      for (int a = 0; a < kRowsA; ++a) {
        g[a] = apply_F(b, row_a(a), [&](int k) { return p[k]; });
        ga[gbuf][a][lane] = g[a];
      }
      __syncwarp();
      TC2LI_LAP(52);
      // P_new = G F^T, symmetric. A column c outside A is G's own (F's row
      // c is e_c). A column c in A is row c of P_new: outside A G's row c,
      // in A F's rows applied to G's row c.
      if (c < 6 || (c >= 12 && c < 15)) {
        const int ac = c < 6 ? c : c - 6;
        float Gc[24];
        const float4* row = reinterpret_cast<const float4*>(ga[gbuf][ac]);
#pragma unroll
        for (int k = 0; k < 6; ++k) {
          const float4 v4 = row[k];
          Gc[4 * k] = v4.x, Gc[4 * k + 1] = v4.y, Gc[4 * k + 2] = v4.z, Gc[4 * k + 3] = v4.w;
        }
        // this column's row of -Jr dt or -R dt, for the noise
        const float* w = c >= 3 && c < 6 ? rd.frbg[j] + 3 * (c - 3)
                                         : rd.fvba[j] + 3 * (c >= 12 ? c - 12 : 0);
        const float wc[3] = {w[0], w[1], w[2]};
#pragma unroll
        for (int r = 0; r < kErr; ++r) {
          if (r >= 6 && (r < 12 || r >= 15)) p[r] = Gc[r];
        }
#pragma unroll
        for (int a = 0; a < kRowsA; ++a) {
          const int r = row_a(a);
          float v = apply_F(b, r, [&](int k) { return Gc[k]; });
          if (a >= 3 && a < 6 && c >= 3 && c < 6) v += block_noise(b.Frbg + 3 * (a - 3), q.g, wc);
          if (a >= 6 && c >= 12) v += block_noise(b.Fvba + 3 * (a - 6), q.a, wc);
          p[r] = v;
        }
      } else {
#pragma unroll
        for (int a = 0; a < kRowsA; ++a) p[row_a(a)] = g[a];
#pragma unroll
        for (int r = 15; r < 21; ++r) {
          if (r == c) p[r] += r < 18 ? (b.dt * q.bg) * b.dt : (b.dt * q.ba) * b.dt;
        }
      }
      gbuf ^= 1;
      TC2LI_LAP(53);
    }
  }
  if (!chain_warp) {
    if (lane < kErr) {
#pragma unroll
      for (int r = 0; r < kErr; ++r) xout[kState + r * kErr + lane] = p[r];
    }
  } else {
    if (lane < 9) s[kR + lane] = Re;
    if (lane < 3) {
      s[kPos + lane] = pk;
      s[kVel + lane] = vk;
    }
    __syncwarp();
    for (int e = lane; e < kState; e += 32) xout[e] = s[e];
  }
  TC2LI_LAP(50);
}


// ---------------------------------------------------------------------------
// the step's terms that need no sums: P0^-1 and the tangent terms
// ---------------------------------------------------------------------------

constexpr int kAug = 2 * kErr + 1;   // a Gauss-Jordan row's stride in doubles
// the threads of a Gauss-Jordan (the first warps of the block, named
// barrier 1): 128 at the step's first launch (beside the reduction and the
// tangent chains), the whole block at the final launch
template <int NT>
__device__ __forceinline__ void gj_sync() { asm volatile("bar.sync 1, %0;" ::"n"(NT) : "memory"); }

// The inverse of the row-major 23 x 23 Mx (shared) into out (shared), on
// the first NT threads: Gauss-Jordan with partial pivoting, [Mx | I] in shared memory
// (aug, a row every kAug doubles; prow and piv its pivot row and lane). A
// row's place in the elimination order is its position, swapped with the
// pivot's where a serial elimination swaps the rows. For each column c,
// warp 0 finds the pivot, the row at position >= c with the largest |a_c|
// and the lowest position on ties (as a serial scan that replaces only on a
// larger value: a NaN at position c keeps it, a NaN elsewhere never wins),
// and copies its row; then the NT threads update the columns right of c:
// the pivot row scaled by the pivot's inverse, every other row less its a_c
// times that. Columns left of the pivot are never read again and are not
// updated.
template <int NT>
__device__ void block_gauss_jordan(const double* Mx, double* out, double* aug, double* prow,
                                   int* piv_s) {
  constexpr int KK = NT / kErr;                      // threads a row
  constexpr int NE = (2 * kErr - 1 + KK - 1) / KK;   // columns a thread, at most
  const int tid = threadIdx.x, lane = tid & 31;
  const bool row = lane < kErr;
  for (int e = tid; e < kErr * kErr; e += NT) {
    const int r = e / kErr, k = e % kErr;
    aug[r * kAug + k] = Mx[e];
    aug[r * kAug + kErr + k] = r == k ? 1.0 : 0.0;
  }
  int pos = lane;   // warp 0: the position of row `lane`
  const int r = tid / KK, kk = tid % KK;   // row r, columns c + 1 + kk + KK i
  gj_sync<NT>();
  for (int c = 0; c < kErr; ++c) {
    if (tid < 32) {
      // |a_c| as its bits (ordered as the values), a NaN at position c as
      // +inf and elsewhere as 0 (it never wins over position c's key); the
      // largest key, then the lowest position holding it
      const bool cand = row && pos >= c;
      unsigned long long key = 0;
      if (cand) {
        const double v = fabs(aug[lane * kAug + c]);
        key = isnan(v) ? (pos == c ? 0x7ff0000000000000ull : 0ull)
                       : static_cast<unsigned long long>(__double_as_longlong(v));
      }
      // the largest key by its two halves (warp reductions)
      const unsigned hi = static_cast<unsigned>(key >> 32), lo = static_cast<unsigned>(key);
      const unsigned hmax = __reduce_max_sync(kFull, hi);
      const unsigned lmax = __reduce_max_sync(kFull, hi == hmax ? lo : 0u);
      const bool tie = cand && hi == hmax && lo == lmax;
      const int p = __reduce_min_sync(kFull, tie ? pos : 64);
      const int piv = __ffs(__ballot_sync(kFull, row && pos == p)) - 1;
      if (row && pos == c) pos = p;
      if (lane == piv) pos = c;
      for (int k = c + lane; k < 2 * kErr; k += 32) prow[k] = aug[piv * kAug + k];
      if (lane == 0) *piv_s = piv;
    }
    gj_sync<NT>();
    if (r < kErr) {
      const double inv = __drcp_rn(prow[c]);   // 1 / p, rounded as the division
      double* ar = aug + r * kAug;
      const bool is_piv = r == *piv_s;
      const double f = is_piv ? 0.0 : ar[c];
      double pv[NE], av[NE];   // this thread's columns: loads, then stores
#pragma unroll
      for (int i = 0; i < NE; ++i) {
        const int k = c + 1 + kk + KK * i;
        pv[i] = k < 2 * kErr ? prow[k] : 0.0;
        av[i] = k < 2 * kErr ? ar[k] : 0.0;
      }
#pragma unroll
      for (int i = 0; i < NE; ++i) {
        const int k = c + 1 + kk + KK * i;
        if (k < 2 * kErr) ar[k] = is_piv ? pv[i] * inv : av[i] - f * (pv[i] * inv);
      }
    }
    gj_sync<NT>();
  }
  if (tid < kErr)
    for (int k = 0; k < kErr; ++k) out[pos * kErr + k] = aug[tid * kAug + kErr + k];
  gj_sync<NT>();
}

// boxminus(x, x0) into t[0, 23) and the transport Jacobian's blocks Lr, Le,
// Lg into t[23, 45), on warps 5, 6 and 7 side by side
// (one lane each, the differences on warp 5)
__device__ void tangent_terms(const double* x, const double* x0, double* t, int warp, int lane) {
  double* dx0 = t;
  if (warp == 5 && lane >= 1 && lane <= 15) {
    const int v = (lane - 1) / 3, k = (lane - 1) % 3;
    const int o[5] = {kPos, kTLI, kVel, kBg, kBa}, e[5] = {0, 9, 12, 15, 18};
    dx0[e[v] + k] = x[o[v] + k] - x0[o[v] + k];
  }
  if ((warp == 5 || warp == 6) && lane == 0) {
    const int o = warp == 5 ? kR : kRLI;
    double D[9], w[3];
    mul3tn(x0 + o, x + o, D);
    so3_log(D, w);
    so3_right_jacobian_inv(w, t + (warp == 5 ? kErr : kErr + 9));
    for (int k = 0; k < 3; ++k) dx0[(warp == 5 ? 3 : 6) + k] = w[k];
  } else if (warp == 7 && lane == 0) {
    // d/dd [(g + d) - g0] at d = 0: g + d = Exp(B(g) d) g moves g by
    // B_k x g along d_k
    const double* g = x + kGrav;
    double B[6], dg[2][3], dout[2][2], out[2];
    s2_basis(g, B);
    for (int k = 0; k < 2; ++k) {
      const double bk[3] = {B[k], B[2 + k], B[4 + k]};
      cross3(bk, g, dg[k]);
    }
    s2_boxminus(g, x0 + kGrav, out, dg, dout);
    dx0[21] = out[0];
    dx0[22] = out[1];
    for (int r = 0; r < 2; ++r)
      for (int k = 0; k < 2; ++k) t[kErr + 18 + 2 * r + k] = dout[r][k];
  }
}

// ---------------------------------------------------------------------------
// rows: kNN, plane fit, gate and the normal equations of one evaluation
// ---------------------------------------------------------------------------

constexpr int kRowsThreads = 256;
constexpr int kRowsWarps = kRowsThreads / 32;
constexpr int kQWarp = 4;                     // queries a warp searches in a batch, all at once
constexpr int kBatch = kRowsWarps * kQWarp;   // 32: a lane of warp 0 each in the fit
constexpr int kRowsMaxBlocks = 256;           // two blocks an SM, a few SMs left for the step
constexpr int kFenceLog2 = 5;                 // a fence every 32 keys, or more where the pool is
constexpr int kMaxFences = 16384;             // larger than 2^19 slots: 64 KB of shared memory
constexpr int kHz = 14;                       // h (12), z and ok of a query
constexpr unsigned long long kNoCand = ~0ull;

__device__ __forceinline__ void pdl_wait() { asm volatile("griddepcontrol.wait;" ::: "memory"); }
__device__ __forceinline__ void pdl_trigger() { asm volatile("griddepcontrol.launch_dependents;"); }

// lower_bound(keys[0, cap), key) of a warp's kQWarp keys side by side: the
// fence (the u fences below the first kEmpty one, in shared memory, F[j] =
// keys[j << lg]) by a branchless search whose iterations depend on u alone,
// then inside the fence's bucket of 2^lg keys by the same search over L2
// (the first probe brings the bucket's 128 bytes; the others hit L1; a
// slot at or past cap reads as kEmpty). Equal to lower_bound for any int32
// key: keys[(j - 1) << lg] < key <= keys[j << lg].
__device__ __forceinline__ void lower_bound2(const int* F, int u, const int* __restrict__ keys,
                                             int cap, int lg, const int (&key)[kQWarp],
                                             int (&pos)[kQWarp]) {
  int base[kQWarp];
#pragma unroll
  for (int t = 0; t < kQWarp; ++t) base[t] = 0;
  if (u > 0) {
    for (int n = u; n > 1;) {
      const int half = n >> 1;
#pragma unroll
      for (int t = 0; t < kQWarp; ++t) base[t] = F[base[t] + half] < key[t] ? base[t] + half : base[t];
      n -= half;
    }
#pragma unroll
    for (int t = 0; t < kQWarp; ++t) base[t] += F[base[t]] < key[t];
  }
  // base = j; the answer is 0 for j = 0, else in ((j - 1) 2^lg, j 2^lg]
#pragma unroll
  for (int t = 0; t < kQWarp; ++t) {
    pos[t] = base[t];
    base[t] = base[t] > 0 ? (base[t] - 1) << lg : 0;
  }
  for (int n = 1 << lg; n > 1;) {
    const int half = n >> 1;
#pragma unroll
    for (int t = 0; t < kQWarp; ++t) {
      const int i = base[t] + half;
      const int k = pos[t] > 0 && i < cap ? __ldg(keys + i) : kEmpty;
      base[t] = pos[t] > 0 && k < key[t] ? i : base[t];
    }
    n -= half;
  }
#pragma unroll
  for (int t = 0; t < kQWarp; ++t)
    pos[t] = pos[t] > 0 ? base[t] + (__ldg(keys + base[t]) < key[t]) : 0;
}

// (d2, candidate index) as one key whose integer order is that of a stable
// sort of d2 by candidate index, a NaN after every number
__device__ __forceinline__ unsigned long long cand_key(float d2, int c) {
  const unsigned b = isnan(d2) ? 0x7fc00000u : (d2 == 0.f ? 0u : __float_as_uint(d2));
  return (static_cast<unsigned long long>(b) << 32) | static_cast<unsigned>(c);
}

// plane_fit.smallest_eigvec_sym3 of the symmetric A (6 entries: 00 01 02 11 12 22)
__device__ void smallest_eigvec(const double* A6, double* n) {
  const double A[9] = {A6[0], A6[1], A6[2], A6[1], A6[3], A6[4], A6[2], A6[4], A6[5]};
  const double q = (A[0] + A[4] + A[8]) / 3.0;
  double Aq[9];
#pragma unroll
  for (int e = 0; e < 9; ++e) Aq[e] = A[e] - ((e % 4 == 0) ? q : 0.0);
  double p2 = 0.0;
#pragma unroll
  for (int e = 0; e < 9; ++e) p2 += Aq[e] * Aq[e];
  p2 = p2 / 6.0;
  const double p = sqrt(p2 < 1e-30 ? 1e-30 : p2);
  double B[9];
#pragma unroll
  for (int e = 0; e < 9; ++e) B[e] = Aq[e] / p;
  const double det = B[0] * (B[4] * B[8] - B[5] * B[7]) - B[1] * (B[3] * B[8] - B[5] * B[6])
                     + B[2] * (B[3] * B[7] - B[4] * B[6]);
  double r = det / 2.0;
  r = r < -1.0 ? -1.0 : (r > 1.0 ? 1.0 : r);
  const double phi = acos(r) / 3.0;
  const double lam = q + 2.0 * p * cos(phi + 2.0943951023931953);
  double M[9];
#pragma unroll
  for (int e = 0; e < 9; ++e) M[e] = A[e] - ((e % 4 == 0) ? lam : 0.0);
  double c0[3], c1[3], c2[3];
  cross3(M, M + 3, c0);
  cross3(M, M + 6, c1);
  cross3(M + 3, M + 6, c2);
  const double n0 = c0[0] * c0[0] + c0[1] * c0[1] + c0[2] * c0[2];
  const double n1 = c1[0] * c1[0] + c1[1] * c1[1] + c1[2] * c1[2];
  const double n2 = c2[0] * c2[0] + c2[1] * c2[1] + c2[2] * c2[2];
  const double* best = (n0 >= n1 && n0 >= n2) ? c0 : (n1 >= n2 ? c1 : c2);
  const double nrm = sqrt(best[0] * best[0] + best[1] * best[1] + best[2] * best[2]);
  if (nrm > 1e-20) {
#pragma unroll
    for (int j = 0; j < 3; ++j) n[j] = best[j] / nrm;
  } else {
    n[0] = 0.0;
    n[1] = 0.0;
    n[2] = 1.0;
  }
}

struct MapIn {
  const int* keys;       // [cap] ascending, kEmpty pad
  const float* pts;      // [cap, 3]
  const float* origin;   // [3] (device)
  int cap;
  float vs;
};

// a batch's queries as the search leaves them for the fit
struct RowsSmem {
  float st[kState + 3];          // the state, the map's origin
  float pw[kBatch][3], pb[kBatch][3], l[kBatch][3];
  float d0[kBatch];              // the nearest neighbour's d^2
  int slot[kBatch][kNb];         // pool slots of the valid neighbours, -1 elsewhere
  float nb[kBatch][kNb][3];      // their points
  int live[kBatch];
  double hz[kBatch][kHz];        // warp 0: each lane's h, z and ok
};

__global__ void __launch_bounds__(kRowsThreads, 2)
rows_kernel(const float* __restrict__ x, const float* __restrict__ pl,
            const uint8_t* __restrict__ valid, int M, MapIn m, const int* __restrict__ fences,
            int nf, int lg, float thr, int ncols, int last, double* __restrict__ partials, float* __restrict__ pw, int* __restrict__ n_eff,
            int* __restrict__ nbr) {
  extern __shared__ int fence_s[];   // the fences below the first kEmpty one [nf]
  __shared__ RowsSmem s;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  TC2LI_LAP_START
  // launched as a programmatic dependent of the kernel before it: the blocks
  // start while it ends and read nothing before its writes are done
  pdl_wait();
  pdl_trigger();
  const int G = gridDim.x;
  const int u = fences[nf];
  for (int j = tid; j < u; j += kRowsThreads) fence_s[j] = fences[j];
  if (tid < kState) s.st[tid] = x[tid];
  if (tid < 3) s.st[kState + tid] = m.origin[tid];
  __syncthreads();
  TC2LI_LAP(8);
  const float* pos = s.st + kPos;
  const float* R = s.st + kR;
  const float* RLI = s.st + kRLI;
  const float* tLI = s.st + kTLI;
  const float* org = s.st + kState;
  const int E = n_entries(ncols);
  const int T = ncols * (ncols + 1) / 2;
  // warp 0's lanes keep up to three entries each: (a, b) of sum h_a h_b,
  // (a, -1) of sum h_a z, (-1, -1) the count
  int ea[3], eb[3];
  double acc[3] = {0.0, 0.0, 0.0};
#pragma unroll
  for (int t = 0; t < 3; ++t) {
    const int e = lane + 32 * t;
    ea[t] = -2;
    eb[t] = -2;
    if (e < T) {
      int a = 0, rem = e;
      while (rem >= ncols - a) {
        rem -= ncols - a;
        ++a;
      }
      ea[t] = a;
      eb[t] = a + rem;
    } else if (e < T + ncols) {
      ea[t] = e - T;
      eb[t] = -1;
    } else if (e < E) {
      ea[t] = -1;
      eb[t] = -1;
    }
  }
  int count = 0;
  const int col_ox = lane / 5 - 2, col_oy = lane % 5 - 2;
  // block b takes batches b, b + G, ... of kBatch queries: the order of
  // every sum depends on M alone
  for (int b0 = blockIdx.x * kBatch; b0 < M; b0 += G * kBatch) {
    // (1) the search: warp w the batch's queries w kQWarp .. + kQWarp, all
    // at once, a lane a voxel column
    int key_lo[kQWarp], key_hi[kQWarp], pos0[kQWarp];
    bool live[kQWarp], ing[kQWarp];
    float pwq[kQWarp][3];
#pragma unroll
    for (int t = 0; t < kQWarp; ++t) {
      const int j = warp * kQWarp + t, qi = b0 + j;
      live[t] = false;
      ing[t] = false;
      key_lo[t] = 0;
      key_hi[t] = -1;
      pwq[t][0] = pwq[t][1] = pwq[t][2] = 0.f;
      if (qi < M) {
        const float l0 = pl[3 * qi], l1 = pl[3 * qi + 1], l2 = pl[3 * qi + 2];
        float pb[3];
#pragma unroll
        for (int i = 0; i < 3; ++i)
          pb[i] = l0 * RLI[3 * i] + l1 * RLI[3 * i + 1] + l2 * RLI[3 * i + 2] + tLI[i];
#pragma unroll
        for (int i = 0; i < 3; ++i)
          pwq[t][i] = pb[0] * R[3 * i] + pb[1] * R[3 * i + 1] + pb[2] * R[3 * i + 2] + pos[i];
        const float mine = lane == 0 ? pwq[t][0] : (lane == 1 ? pwq[t][1] : pwq[t][2]);
        if (lane < 3) {
          if (last) pw[3 * qi + lane] = mine;
          s.pw[j][lane] = mine;
          s.pb[j][lane] = lane == 0 ? pb[0] : (lane == 1 ? pb[1] : pb[2]);
          s.l[j][lane] = lane == 0 ? l0 : (lane == 1 ? l1 : l2);
        }
        live[t] = valid[qi] != 0 && isfinite(pwq[t][0]) && isfinite(pwq[t][1])
                  && isfinite(pwq[t][2]);
      }
      if (live[t]) {
        // the query's voxel; a value far outside the grid is clamped where
        // it stays outside
        int qv[3];
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          float tt = floorf(__fdiv_rn(__fsub_rn(pwq[t][i], org[i]), m.vs));
          tt = tt < -4.f ? -4.f : (tt > float(kGridSize + 4) ? float(kGridSize + 4) : tt);
          qv[i] = static_cast<int>(tt);
        }
        const int zlo = min(max(qv[2] - 2, 0), kGridSize - 1);
        const int zhi = min(max(qv[2] + 2, 0), kGridSize - 1);
        const int cx = qv[0] + col_ox, cy = qv[1] + col_oy;
        ing[t] = lane < kCols && cx >= 0 && cx < kGridSize && cy >= 0 && cy < kGridSize;
        if (ing[t]) {
          key_lo[t] = (cx << 20) | (cy << 10) | zlo;
          key_hi[t] = key_lo[t] + (zhi - zlo);
        }
      }
    }
    // lower_bound(keys, key_lo): the fence in shared memory, then its bucket
    lower_bound2(fence_s, u, m.keys, m.cap, lg, key_lo, pos0);
    TC2LI_LAP(9);
    // the fixed run of 5 candidates a column, validated by the key range
    float d2[kQWarp][kRun];
    unsigned vmask[kQWarp];
#pragma unroll
    for (int t = 0; t < kQWarp; ++t) {
      vmask[t] = 0;
#pragma unroll
      for (int r = 0; r < kRun; ++r) {
        const int c = min(pos0[t] + r, m.cap - 1);
        const int k = ing[t] ? __ldg(m.keys + c) : kEmpty;
        if (ing[t] && k >= key_lo[t] && k <= key_hi[t] && k != kEmpty) vmask[t] |= 1u << r;
      }
    }
#pragma unroll
    for (int t = 0; t < kQWarp; ++t) {
#pragma unroll
      for (int r = 0; r < kRun; ++r) {
        d2[t][r] = __int_as_float(0x7f800000);   // +inf
        if ((vmask[t] >> r) & 1u) {
          const int c = min(pos0[t] + r, m.cap - 1);
          const float dx = __fsub_rn(__ldg(m.pts + 3 * c), pwq[t][0]);
          const float dy = __fsub_rn(__ldg(m.pts + 3 * c + 1), pwq[t][1]);
          const float dz = __fsub_rn(__ldg(m.pts + 3 * c + 2), pwq[t][2]);
          d2[t][r] = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
        }
      }
    }
    TC2LI_LAP(10);
    // the 5 nearest by (d2, candidate index lane * 5 + r), the warp's
    // queries side by side: each lane sorts its 5 candidates' keys once;
    // then five warp-wide minima of the lanes' heads, the winner's head
    // moving on; lane k of the first five takes the k-th winner
    unsigned long long win[kQWarp];
    float d0[kQWarp];
#pragma unroll
    for (int t = 0; t < kQWarp; ++t) {
      unsigned long long ck[kRun];
#pragma unroll
      for (int r = 0; r < kRun; ++r) ck[r] = lane < kCols ? cand_key(d2[t][r], lane * kRun + r) : kNoCand;
      // a sorting network of 5 (9 exchanges)
      const int net[9][2] = {{0, 1}, {3, 4}, {2, 4}, {2, 3}, {0, 3}, {0, 2}, {1, 4}, {1, 3}, {1, 2}};
#pragma unroll
      for (int e = 0; e < 9; ++e) {
        const unsigned long long x0 = ck[net[e][0]], x1 = ck[net[e][1]];
        ck[net[e][0]] = x0 < x1 ? x0 : x1;
        ck[net[e][1]] = x0 < x1 ? x1 : x0;
      }
      win[t] = kNoCand;
#pragma unroll
      for (int k = 0; k < kNb; ++k) {
        // the smallest head by its two halves (warp reductions): d2's bits,
        // then the candidate index among the heads that tie on them
        const unsigned hi = static_cast<unsigned>(ck[0] >> 32);
        const unsigned hmin = __reduce_min_sync(kFull, hi);
        const unsigned lmin = __reduce_min_sync(kFull, hi == hmin ? static_cast<unsigned>(ck[0])
                                                                  : 0xffffffffu);
        const unsigned long long best = (static_cast<unsigned long long>(hmin) << 32) | lmin;
        if (best == ck[0]) {   // this lane's head won: the next one moves up
#pragma unroll
          for (int r = 0; r < kRun - 1; ++r) ck[r] = ck[r + 1];
          ck[kRun - 1] = kNoCand;
        }
        if (lane == k) win[t] = best;
        if (k == 0) d0[t] = __uint_as_float(static_cast<unsigned>(best >> 32));
      }
    }
    int sl[kQWarp];
#pragma unroll
    for (int t = 0; t < kQWarp; ++t) {
      const int bc = lane < kNb ? static_cast<int>(win[t] & 0xffffffffu) : 0;
      const int owner = bc / kRun, rr = bc - owner * kRun;
      const int p0 = __shfl_sync(kFull, pos0[t], owner);
      const unsigned om = __shfl_sync(kFull, vmask[t], owner);
      sl[t] = live[t] && ((om >> rr) & 1u) ? min(p0 + rr, m.cap - 1) : -1;
    }
    // lanes 0..4 take a neighbour each: its slot and its point for the fit
#pragma unroll
    for (int t = 0; t < kQWarp; ++t) {
      const int j = warp * kQWarp + t, qi = b0 + j;
      if (lane < kNb) {
        const int v = sl[t];
        s.slot[j][lane] = v;
        if (v >= 0)
#pragma unroll
          for (int i = 0; i < 3; ++i) s.nb[j][lane][i] = __ldg(m.pts + 3 * v + i);
        if (nbr != nullptr && qi < M) nbr[kNb * qi + lane] = v;
      }
      if (lane == 0) {
        s.d0[j] = d0[t];
        s.live[j] = live[t];
      }
    }
    TC2LI_LAP(11);
    __syncthreads();
    TC2LI_LAP(15);
    // (2) warp 0: plane_fit.fit_planes over the 5 (an invalid neighbour
    // weighs 0), the gate and the row of query `lane`, in float64 from the
    // float32 neighbours; then the ordered sums over the batch
    if (warp == 0) {
      const int j = lane, qi = b0 + j;
      bool ok = false;
      double h[12], z = 0.0;
#pragma unroll
      for (int k = 0; k < 12; ++k) h[k] = 0.0;
      if (qi < M && s.live[j]) {
        bool sv[kNb];
        int slot[kNb];
        double nb[kNb][3];
        double cnt = 0.0;
        int nvalid = 0;
#pragma unroll
        for (int k = 0; k < kNb; ++k) {
          slot[k] = s.slot[j][k];
          sv[k] = slot[k] >= 0;
#pragma unroll
          for (int i = 0; i < 3; ++i) nb[k][i] = sv[k] ? double(s.nb[j][k][i]) : 0.0;
          cnt += sv[k] ? 1.0 : 0.0;
          nvalid += sv[k];
        }
        cnt = cnt < 1.0 ? 1.0 : cnt;
        double mu[3], cen[kNb][3];
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          double sum = 0.0;
#pragma unroll
          for (int k = 0; k < kNb; ++k) sum += nb[k][i] * (sv[k] ? 1.0 : 0.0);
          mu[i] = sum / cnt;
        }
#pragma unroll
        for (int k = 0; k < kNb; ++k)
#pragma unroll
          for (int i = 0; i < 3; ++i) cen[k][i] = (nb[k][i] - mu[i]) * (sv[k] ? 1.0 : 0.0);
        double A6[6];
        const int ii[6] = {0, 0, 0, 1, 1, 2}, jj[6] = {0, 1, 2, 1, 2, 2};
#pragma unroll
        for (int e = 0; e < 6; ++e) {
          double sum = 0.0;
#pragma unroll
          for (int k = 0; k < kNb; ++k) sum += cen[k][ii[e]] * cen[k][jj[e]];
          A6[e] = sum / cnt + ((ii[e] == jj[e]) ? 1e-12 : 0.0);
        }
        double nrm[3];
        smallest_eigvec(A6, nrm);
        double d = -(nrm[0] * mu[0] + nrm[1] * mu[1] + nrm[2] * mu[2]);
        const bool finite = isfinite(nrm[0]) && isfinite(nrm[1]) && isfinite(nrm[2]) && isfinite(d);
        if (!finite) {
          nrm[0] = nrm[1] = nrm[2] = 0.0;
          d = 0.0;
        }
        bool plane_ok = finite && nvalid >= 3;
#pragma unroll
        for (int k = 0; k < kNb; ++k) {
          const double res = fabs(nb[k][0] * nrm[0] + nb[k][1] * nrm[1] + nb[k][2] * nrm[2] + d);
          if (sv[k] && !(res < double(thr))) plane_ok = false;
        }
        const float* pwq = s.pw[j];
        const double pd = double(pwq[0]) * nrm[0] + double(pwq[1]) * nrm[1]
                          + double(pwq[2]) * nrm[2] + d;
        const double lq[3] = {s.l[j][0], s.l[j][1], s.l[j][2]};
        const double np = sqrt(lq[0] * lq[0] + lq[1] * lq[1] + lq[2] * lq[2]);
        const double gate = sqrt(np < 1e-6 ? 1e-6 : np);
        const double sgate = 1.0 - 0.9 * fabs(pd) / gate;
        const float sd0 = s.d0[j];
        const float dist0 = sqrtf(sd0 < 0.f ? 0.f : sd0);
        ok = plane_ok && sgate > 0.9 && dist0 < 5.f;
        if (ok && !last) {
          // the row: n, p_b x R^T n, [p_l x R_LI^T R^T n, R^T n]
          double Rn[3], RLn[3], cr[3];
          const double pbd[3] = {s.pb[j][0], s.pb[j][1], s.pb[j][2]};
#pragma unroll
          for (int i = 0; i < 3; ++i)
            Rn[i] = nrm[0] * double(R[i]) + nrm[1] * double(R[3 + i]) + nrm[2] * double(R[6 + i]);
          cross3(pbd, Rn, cr);
#pragma unroll
          for (int i = 0; i < 3; ++i) {
            h[i] = nrm[i];
            h[3 + i] = cr[i];
          }
          if (ncols == 12) {
#pragma unroll
            for (int i = 0; i < 3; ++i)
              RLn[i] = Rn[0] * double(RLI[i]) + Rn[1] * double(RLI[3 + i])
                       + Rn[2] * double(RLI[6 + i]);
            cross3(lq, RLn, cr);
#pragma unroll
            for (int i = 0; i < 3; ++i) {
              h[6 + i] = cr[i];
              h[9 + i] = Rn[i];
            }
          }
#pragma unroll
          for (int k = 0; k < 12; ++k) h[k] = isfinite(h[k]) ? h[k] : 0.0;
          z = isfinite(pd) ? pd : 0.0;
        }
      }
      count += ok;
      TC2LI_LAP(12);
      if (!last) {
#pragma unroll
        for (int k = 0; k < 12; ++k) s.hz[j][k] = h[k];
        s.hz[j][12] = z;
        s.hz[j][13] = ok ? 1.0 : 0.0;
        __syncwarp();
        // each entry over the batch's queries in order: a query that is no
        // inlier has h, z and ok 0 and adds an exact 0 (the sums start at
        // +0 and are never -0)
#pragma unroll
        for (int t = 0; t < 3; ++t) {
          if (ea[t] == -2) continue;
          const int ia = ea[t] == -1 ? 13 : ea[t], ib = ea[t] == -1 ? 13 : (eb[t] == -1 ? 12 : eb[t]);
#pragma unroll 8
          for (int q = 0; q < kBatch; ++q) acc[t] += s.hz[q][ia] * s.hz[q][ib];
        }
        __syncwarp();
      }
      TC2LI_LAP(13);
    }
    __syncthreads();
  }
  if (warp != 0) return;
  if (last) {
    const int c = __reduce_add_sync(kFull, count);
    if (lane == 0 && c) atomicAdd(n_eff, c);
    return;
  }
  // the block's partial sums, entry-major [E, G]
#pragma unroll
  for (int t = 0; t < 3; ++t)
    if (lane + 32 * t < E) partials[static_cast<size_t>(lane + 32 * t) * G + blockIdx.x] = acc[t];
  TC2LI_LAP(14);
}

// ---------------------------------------------------------------------------
// step: the MAP step of an iterate, or the final covariance and the guard
// ---------------------------------------------------------------------------

struct StepSmem {
  double sums[kMaxEntries];
  double Pinv[kErr * kErr];
  double A[kErr * kErr];         // N / r + L^T P0^-1 L (P0 + 1e-9 I at the first launch);
                                 // then its Cholesky factor's rows
  double Tm[kErr * kErr];        // P0^-1 L; the final inverse
  double aug[kErr * kAug];       // the Gauss-Jordan's [M | I]
  double prow[2 * kErr];         // its pivot row
  double bc[kErr];               // a column of the Cholesky, broadcast on warp 0
  double x[kState], x0[kState];   // the iterate, the prediction
  double t[kTangent];            // boxminus(x, x0), then the transport Jacobian's blocks
                                 // Lr, Le, Lg (tangent_terms)
  double w[kErr], b[kErr], delta[kErr];
  double conv, iters;
  int now, piv;
};

// block index of an error-state coordinate: its first coordinate and size
__device__ __forceinline__ void block_of(int i, int& first, int& size) {
  if (i >= 21) {
    first = 21;
    size = 2;
  } else {
    first = (i / 3) * 3;
    size = 3;
  }
}

// L_ai of the block-diagonal transport Jacobian (a, i in one block)
__device__ __forceinline__ double L_at(const StepSmem& s, int a, int i) {
  if (a >= 3 && a < 6) return s.t[kErr + 3 * (a - 3) + (i - 3)];
  if (a >= 6 && a < 9) return s.t[kErr + 9 + 3 * (a - 6) + (i - 6)];
  if (a >= 21) return s.t[kErr + 18 + 2 * (a - 21) + (i - 21)];
  return a == i ? 1.0 : 0.0;
}

// s.A = N / r + L^T P0^-1 L (N: the reduced sums over the first ncols
// columns); with rhs, s.b = -(v / r + L^T P0^-1 dx0)
__device__ void assemble(StepSmem& s, int ncols, double r_inv, bool rhs) {
  const int tid = threadIdx.x;
  for (int e = tid; e < kErr * kErr; e += kThreads) {   // Tm = P0^-1 L
    const int a = e / kErr, j = e % kErr;
    int f, n;
    block_of(j, f, n);
    double v = 0.0;
    for (int b = f; b < f + n; ++b) v += s.Pinv[a * kErr + b] * L_at(s, b, j);
    s.Tm[e] = v;
  }
  if (rhs)
    for (int a = tid; a < kErr; a += kThreads) {
      double v = 0.0;
      for (int b = 0; b < kErr; ++b) v += s.Pinv[a * kErr + b] * s.t[b];
      s.w[a] = v;
    }
  __syncthreads();
  const int T = ncols * (ncols + 1) / 2;
  for (int e = tid; e < kErr * kErr; e += kThreads) {
    const int i = e / kErr, j = e % kErr;
    int f, n;
    block_of(i, f, n);
    double v = 0.0;
    for (int a = f; a < f + n; ++a) v += L_at(s, a, i) * s.Tm[a * kErr + j];
    if (i < ncols && j < ncols) {
      const int lo = i < j ? i : j, hi = i < j ? j : i;
      const int idx = lo * ncols - lo * (lo - 1) / 2 + (hi - lo);
      v += s.sums[idx] * r_inv;
    }
    s.A[e] = v;
  }
  if (rhs)
    for (int i = tid; i < kErr; i += kThreads) {
      int f, n;
      block_of(i, f, n);
      double v = 0.0;
      for (int a = f; a < f + n; ++a) v += L_at(s, a, i) * s.w[a];
      s.b[i] = -((i < ncols ? s.sums[T + i] * r_inv : 0.0) + v);
    }
  __syncthreads();
}

// warp 0: the Cholesky factor of s.A (lower triangle, right-looking, the
// column of each step broadcast through shared memory) and the two
// triangular solves of s.b, column-oriented across the lanes, into s.delta;
// returns whether every |delta_i| < eps (a NaN never converges)
__device__ bool warp_cholesky_solve(StepSmem& s, double eps) {
  const int lane = threadIdx.x & 31;
  const bool row = lane < kErr;
  double a[kErr];
#pragma unroll
  for (int k = 0; k < kErr; ++k) a[k] = row ? s.A[lane * kErr + k] : 0.0;
  double inv_own = 0.0;   // 1 / L_ii on lane i
#pragma unroll
  for (int c = 0; c < kErr; ++c) {
    const double dcc = sqrt(__shfl_sync(kFull, a[c], c));
    const double inv = __drcp_rn(dcc);
    if (lane == c) {
      a[c] = dcc;
      inv_own = inv;
    } else if (row && lane > c) {
      a[c] *= inv;
      s.bc[lane] = a[c];
    }
    __syncwarp();
#pragma unroll
    for (int j = c + 1; j < kErr; ++j)
      if (row && lane >= j) a[j] -= a[c] * s.bc[j];
    __syncwarp();
  }
  TC2LI_LAP(34);
  // L's rows to shared memory (the backward solve reads its columns)
  if (row)
#pragma unroll
    for (int k = 0; k < kErr; ++k) s.A[lane * kErr + k] = a[k];
  __syncwarp();
  // L y = b: y_j = v_j / L_jj on lane j, then v_i -= L_ij y_j below it
  double v = row ? s.b[lane] : 0.0;
#pragma unroll
  for (int j = 0; j < kErr; ++j) {
    const double yj = __shfl_sync(kFull, v * inv_own, j);
    if (lane == j) v = yj;
    else if (row && lane > j) v -= a[j] * yj;
  }
  // L^T delta = y, from the last row up
#pragma unroll
  for (int j = kErr - 1; j >= 0; --j) {
    const double dj = __shfl_sync(kFull, v * inv_own, j);
    if (lane == j) v = dj;
    else if (lane < j) v -= s.A[j * kErr + lane] * dj;
  }
  if (row) s.delta[lane] = v;
  return __all_sync(kFull, !row || fabs(v) < eps);
}

__global__ void __launch_bounds__(kThreads)
step_kernel(const double* __restrict__ partials, int blocks, int ncols, double r_inv, double eps,
            const float* __restrict__ xp, const float* __restrict__ x0p, int first, int final_,
            double* __restrict__ work, float* __restrict__ x_next,
            float* __restrict__ out, int* __restrict__ ints, uint8_t* __restrict__ bad) {
  __shared__ StepSmem s;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int E = n_entries(ncols);
  TC2LI_LAP_START
  // launched as a programmatic dependent of the rows launch: the block starts
  // while that launch ends and reads nothing before its writes are done
  pdl_wait();
  pdl_trigger();
  if (tid < kState) {
    // the final covariance is taken in the tangent of the state as it is
    // written (float32): S2's basis B(g) changes where the smallest |g_i|
    // changes hands, which rounding can decide near an axis
    double v = first ? double(xp[tid]) : work[kWorkIter + tid];
    s.x[tid] = final_ ? double(float(v)) : v;
    s.x0[tid] = double(xp[tid]);
  }
  if (tid == 0) {
    s.conv = first ? 0.0 : work[kWorkConv];
    s.iters = first ? 0.0 : work[kWorkConv + 1];
  }
  // P0 + 1e-9 I at the first launch; P0^-1 from it at the later ones
  for (int e = tid; e < kErr * kErr; e += kThreads) {
    if (first) s.A[e] = double(xp[kState + e]) + (e / kErr == e % kErr ? 1e-9 : 0.0);
    else s.Pinv[e] = work[e];
  }
  __syncthreads();
  if (first && warp < 4) {
    // P0^-1 on warps 0-3, beside the reduction and the tangent chains
    block_gauss_jordan<128>(s.A, s.Pinv, s.aug, s.prow, &s.piv);
  } else {
    // the blocks' partial sums in a fixed order on nw warps (4-7 at the
    // first launch, else 0-4): a warp an entry at a time, lane l adds
    // blocks l, l + 32, ... in four interleaved accumulators (added in
    // order), then the lanes by a fixed xor tree; which warp takes an entry
    // changes no bit of it
    const int w0 = first ? 4 : 0, nw = first ? 4 : 5, wi = warp - w0;
    if (wi >= 0 && wi < nw) {
      for (int e0 = wi; e0 < E; e0 += 2 * nw) {
        double a4[2][4];
#pragma unroll
        for (int h = 0; h < 2; ++h) {   // two entries' loads in flight
          const int e = min(e0 + h * nw, E - 1);
          const double* pe = partials + static_cast<size_t>(e) * blocks;
#pragma unroll
          for (int u = 0; u < 4; ++u) a4[h][u] = 0.0;
          int b = lane;
          for (; b + 96 < blocks; b += 128) {
#pragma unroll
            for (int u = 0; u < 4; ++u) a4[h][u] += pe[b + 32 * u];
          }
#pragma unroll
          for (int u = 0; u < 4; ++u)
            if (b + 32 * u < blocks) a4[h][u] += pe[b + 32 * u];
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          double sum = (a4[h][0] + a4[h][1]) + (a4[h][2] + a4[h][3]);
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(kFull, sum, off);
          if (lane == 0 && e0 + h * nw < E) s.sums[e0 + h * nw] = sum;
        }
      }
    }
    // the tangent terms at this iterate on warps 5-7 (after their share of
    // the reduction at the first launch)
    tangent_terms(s.x, s.x0, s.t, warp, lane);
  }
  __syncthreads();
  if (first)
    for (int e = tid; e < kErr * kErr; e += kThreads) work[e] = s.Pinv[e];
  TC2LI_LAP(32);
  if (!final_) {
    assemble(s, ncols, r_inv, true);
    TC2LI_LAP(33);
    if (warp == 0) {
      const bool now = warp_cholesky_solve(s, eps);
      if (lane == 0) s.now = now;
    }
    __syncthreads();
    TC2LI_LAP(35);
    // boxplus under the convergence mask, its three rotations on three warps
    if (s.conv == 0.0) {
      const double* d = s.delta;
      double* x = s.x;
      if ((warp == 0 || warp == 1) && lane == 0) {
        const int o = warp == 0 ? kR : kRLI;
        double E3[9], Rn[9];
        so3_exp(d + (warp == 0 ? 3 : 6), E3);
        mul3(x + o, E3, Rn);
        for (int e = 0; e < 9; ++e) x[o + e] = Rn[e];
      } else if (warp == 2 && lane == 0) {
        double g[3];
        s2_boxplus(x + kGrav, d + 21, g);
        for (int k = 0; k < 3; ++k) x[kGrav + k] = g[k];
      } else if (warp == 3 && lane < 15) {
        const int v = lane / 3, k = lane % 3;
        const int o[5] = {kPos, kTLI, kVel, kBg, kBa}, e[5] = {0, 9, 12, 15, 18};
        x[o[v] + k] += d[e[v] + k];
      }
    }
    __syncthreads();
    if (tid < kState) {
      work[kWorkIter + tid] = s.x[tid];
      x_next[tid] = float(s.x[tid]);
    }
    if (tid == 0) {
      work[kWorkConv] = s.now ? 1.0 : s.conv;
      work[kWorkConv + 1] = s.conv == 0.0 ? s.iters + 1.0 : s.iters;
    }
    TC2LI_LAP(36);
    return;
  }
  // the final covariance in the tangent at the converged state
  assemble(s, ncols, r_inv, false);
  TC2LI_LAP(33);
  block_gauss_jordan<kThreads>(s.A, s.Tm, s.aug, s.prow, &s.piv);
  __syncthreads();
  TC2LI_LAP(37);
  // float32 state and P; the guard on them: non-finite, or |v| > 60 m/s
  __shared__ float P32[kErr * kErr], x32[kState];
  __shared__ int nonfinite;
  if (tid == 0) nonfinite = 0;
  __syncthreads();
  for (int e = tid; e < kErr * kErr; e += kThreads) {
    const int r = e / kErr, c = e % kErr;
    P32[e] = float(0.5 * (s.Tm[e] + s.Tm[c * kErr + r]));
    if (!isfinite(P32[e])) nonfinite = 1;
  }
  if (tid < kState) {
    x32[tid] = float(s.x[tid]);
    // pos, vel, bg, ba, grav and R are tested; the extrinsic is not
    if (!isfinite(x32[tid]) && (tid < kRLI || tid >= kVel)) nonfinite = 1;
  }
  __syncthreads();
  const float v2 = __fadd_rn(__fadd_rn(__fmul_rn(x32[kVel], x32[kVel]),
                                       __fmul_rn(x32[kVel + 1], x32[kVel + 1])),
                             __fmul_rn(x32[kVel + 2], x32[kVel + 2]));
  const bool is_bad = nonfinite != 0 || v2 > 3600.f;
  for (int e = tid; e < kPacked; e += kThreads)
    out[e] = is_bad ? x0p[e] : (e < kState ? x32[e] : P32[e - kState]);
  if (tid == 0) {
    ints[0] = static_cast<int>(s.iters);
    ints[1] = 0;   // the last evaluation's inlier count adds into it
    bad[0] = is_bad;
  }
  TC2LI_LAP(38);
}

// programmatic dependent launch on `stream`
template <typename... Params, typename... Args>
cudaError_t launch_pdl(void (*kernel)(Params...), int grid, int threads, int smem,
                       void* stream, Args... args) {
  cudaLaunchAttribute at;
  at.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  at.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = &at;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, static_cast<Params>(args)...);
}

}  // namespace

extern "C" int tc2li_lio_rows_blocks(int M) {
  return max(1, min(kRowsMaxBlocks, (M + kBatch - 1) / kBatch));
}

extern "C" int tc2li_lio_work_doubles() { return kWork; }

// log2 of the fence stride for a pool of cap slots: 5, or more where the
// table would outgrow kMaxFences
extern "C" int tc2li_lio_fence_log2(int cap) {
  int lg = kFenceLog2;
  while (((static_cast<long long>(cap) + (1ll << lg) - 1) >> lg) > kMaxFences) ++lg;
  return lg;
}

// registers, local (spill) bytes, static shared bytes and the largest block
// of the scan step's kernels: which 0 predict (with the fence blocks), 1
// rows, 2 step
extern "C" int tc2li_lio_func_attrs(int which, int* out) {
  cudaFuncAttributes a;
  const void* fns[3] = {reinterpret_cast<const void*>(predict_kernel),
                        reinterpret_cast<const void*>(rows_kernel),
                        reinterpret_cast<const void*>(step_kernel)};
  if (which < 0 || which > 2) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t e = cudaFuncGetAttributes(&a, fns[which]);
  out[0] = a.numRegs;
  out[1] = static_cast<int>(a.localSizeBytes);
  out[2] = static_cast<int>(a.sharedSizeBytes);
  out[3] = a.maxThreadsPerBlock;
  return static_cast<int>(e);
}

// The prediction, one block; with keys (not null) the pool's fence table
// too, fences: int32 [ceil(cap / 2^lg) + 1], by blocks of their own in the
// same launch.
extern "C" int tc2li_esekf_predict(const float* xin, const float* gyro, const float* acc,
                                   const float* dts, int N, float qg, float qa, float qbg,
                                   float qba, float* xout, float* R_traj, float* p_traj,
                                   const int* keys, int cap, int lg, int* fences,
                                   void* stream) {
  if (N < 0) return static_cast<int>(cudaErrorInvalidValue);
  FenceArgs fa{keys, cap, lg, 0, fences};
  if (keys != nullptr) {
    if (cap < 1 || lg != tc2li_lio_fence_log2(cap) || fences == nullptr)
      return static_cast<int>(cudaErrorInvalidValue);
    fa.nf = static_cast<int>((static_cast<long long>(cap) + (1ll << lg) - 1) >> lg);
  }
  const Noise q{qg, qa, qbg, qba};
  predict_kernel<<<1 + (fa.nf + kFencesBlock - 1) / kFencesBlock, kPredictThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(xin, gyro, acc, dts, N, q, xout, R_traj,
                                                        p_traj, fa);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tc2li_lio_rows(const float* x, const float* pl, const uint8_t* valid, int M,
                              const int* keys, const float* mpts, const float* origin, int cap,
                              const int* fences, int lg, float vs, float thr, int ncols,
                              int last, double* partials, float* pw, int* n_eff, int* nbr,
                              void* stream) {
  if (M < 0 || cap < 1 || (ncols != 6 && ncols != 12) || lg != tc2li_lio_fence_log2(cap))
    return static_cast<int>(cudaErrorInvalidValue);
  const int nf = static_cast<int>((static_cast<long long>(cap) + (1ll << lg) - 1) >> lg);
  // the fence table in dynamic shared memory, up to 64 KB (set on every
  // call: the attribute belongs to the current device)
  cudaError_t e = cudaFuncSetAttribute(rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       kMaxFences * 4);
  if (e != cudaSuccess) return static_cast<int>(e);
  const MapIn m{keys, mpts, origin, cap, vs};
  e = launch_pdl(rows_kernel, tc2li_lio_rows_blocks(M), kRowsThreads, nf * 4, stream, x, pl,
                 valid, M, m, fences, nf, lg, thr, ncols, last, partials, pw, n_eff, nbr);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tc2li_esekf_step(const double* partials, int blocks, int ncols, double r_inv,
                                double eps, const float* xp, const float* x0p, int first,
                                int final_, double* work, float* x_next, float* out,
                                int* ints, uint8_t* bad, void* stream) {
  if (blocks < 1 || (ncols != 6 && ncols != 12)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t e = launch_pdl(step_kernel, 1, kThreads, 0, stream, partials, blocks, ncols,
                                   r_inv, eps, xp, x0p, first, final_, work, x_next, out,
                                   ints, bad);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
