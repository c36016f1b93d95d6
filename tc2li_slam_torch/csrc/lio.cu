// The LiDAR-inertial scan step of the IMU mode (FAST-LIO2's per-scan
// iterated ESEKF update): three kernels.
//
// Replaces, in tc2li_slam_tpu, what the TPU runs inside the one jit of
// slam/lio.py:99 (lio_scan_step):
// - predict_kernel: estimation/esekf.py:192 (predict, its lax.scan :257);
// - rows_kernel: slam/lio.py:46 (make_h_fn, the measurement of an iterate)
//   with ops/voxel_map.py:154 (knn, radius 2) and ops/plane_fit.py:90
//   (fit_planes), and the normal-equation products of update_iterated;
// - step_kernel: estimation/esekf.py:266 (update_iterated, its lax.scan
//   :308) after the products, and the divergence guard of lio_scan_step.
// Eager PyTorch ran a scan step as ~5,000 small ops, each a launch.
//
// What they compute is the plain versions' (ops/kernels/lio.py:
// predict_plain, make_h_fn, scan_update_plain); a scan step at max_iters k
// is 1 + (k + 2) + (k + 1) launches:
//   predict; rows(x_0), step, ..., rows(x_{k-1}), step; rows(x_k), final;
//   rows(guarded x, last)
// with the filter state packed as 36 float32 (pos, R, R_LI, t_LI, vel, bg,
// ba, grav) followed by P [23, 23].
//
// predict_kernel, one block: the serial chain over the window's samples, a
// sample with dt <= 0 skipped (an exact no-op at any launch size). Thread 0
// computes a sample's rotation increment, its Jacobian and F's six blocks;
// then P <- F P F^T + Fw Q Fw^T on the whole block from F's block
// structure (identity plus the blocks: a row of F P reads at most 9
// entries), P in shared memory, float32 as both packages are.
//
// rows_kernel, a warp a query point: its state from device memory, p_b and
// p_w; the 25 voxel columns of radius 2 on lanes 0..24, each a binary
// search of the sorted int32 pool keys and the fixed run of 5 candidates,
// validated by the key range as knn does; the 5 nearest by (d^2, candidate
// index), which is the order of a stable sort, by five warp-wide argmins
// (float32, as the plain version, so the neighbour sets are its own but
// where a query lies within an ulp of a voxel face); then, in float64 from
// the float32 neighbours, the closed-form plane fit of plane_fit.fit_planes,
// the gate s > 0.9 and dists[0] < 5, and the row (6 non-zero columns, 12
// with the extrinsic). A fit whose 5 points are near collinear has its
// normal decided by rounding in float32: float32 fits differ there from
// each other and from float64 by ~1e-3 of the normal equations' scale.
// Each lane keeps up to three entries of sum h h^T (upper triangle), sum h z
// and the inlier count in float64, over its warp's queries in order; the
// block adds its warps in order and writes its partial sums. No atomics in
// a sum: the same bits on every call. The last evaluation (at the guarded
// state) writes p_w and counts its inliers (integer atomicAdd, exact in any
// order) instead.
//
// step_kernel, one block: adds the blocks' partials in a fixed order; at the
// first launch forms P0^-1 = (P0 + 1e-9 I)^-1 (Gauss-Jordan, partial
// pivoting) and keeps it in device memory with the iterate; then boxminus,
// the transport Jacobian in closed blocks (the inverse right Jacobians of
// the two SO(3) blocks; the 2x2 S2 block by forward-mode dual numbers
// through s2_boxplus / s2_boxminus, Taylor branch included, as jacfwd
// differentiates it), A = H^T H / r + L^T P0^-1 L, b, a Cholesky solve, and
// boxplus under the convergence mask. The final launch forms
// P = (H^T H / r + L^T P0^-1 L)^-1 symmetrised, runs the bad-state test
// (non-finite, or |v| > 60 m/s) and writes the filter, or the one from
// before the scan. float64 from the float32 inputs (H^T H / r ~1e7 beside
// P0^-1's 1e5); the iterate is kept in float64 between launches and rounded
// for the rows.
//
// Bound on the H100: latency. A scan step at 8,192 points reads ~2.5 MB of
// keys and points an evaluation (binary searches: 25 x 19 dependent loads a
// query, L2-resident) and does ~1e7 float32 operations; the steps are a few
// 1e5 float64 operations on dependent phases of one block. Design: a warp a
// query keeps every lane's search in flight at once, 8 queries a block,
// up to 1024 blocks; the steps are single blocks between the evaluations.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kErr = 23;
constexpr int kState = 36;
constexpr int kPacked = kState + kErr * kErr;   // 565
constexpr int kPos = 0, kR = 3, kRLI = 12, kTLI = 21, kVel = 24, kBg = 27, kBa = 30, kGrav = 33;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsMaxBlocks = 1024;
constexpr int kNb = 5;            // neighbours
constexpr int kCols = 25;         // voxel columns of radius 2
constexpr int kRun = 5;           // candidates a column
constexpr int kGridSize = 1024;   // voxels a grid axis
constexpr int kEmpty = 0x7fffffff;
constexpr int kMaxEntries = 96;   // >= n_entries(12) = 91
constexpr int kWork = kErr * kErr + kState + 2;   // P0^-1, the iterate, converged, iterations
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

// F's blocks of one sample (esekf.predict): F = I but for
// F[POS, VEL] = I dt, F[ROT, ROT] = dRi^T, F[ROT, BG] = -Jr dt,
// F[VEL, ROT] = -R hat(a) dt, F[VEL, BA] = -R dt, F[VEL, GRAV] = gB dt; and
// Fw's: Fw[ROT] = -Jr dt, Fw[VEL] = -R dt, Fw[BG] = Fw[BA] = I dt
struct Blocks {
  float Frr[9], Frbg[9], Fvr[9], Fvba[9], Fvg[6], dt;
};

// row i of F applied to the column col(k), k over the error state
template <typename Col>
__device__ __forceinline__ float apply_F(const Blocks& b, int i, Col col) {
  if (i < 3) return col(i) + b.dt * col(12 + i);
  if (i < 6) {
    const int a = i - 3;
    return b.Frr[3 * a] * col(3) + b.Frr[3 * a + 1] * col(4) + b.Frr[3 * a + 2] * col(5)
           + b.Frbg[3 * a] * col(15) + b.Frbg[3 * a + 1] * col(16) + b.Frbg[3 * a + 2] * col(17);
  }
  if (i >= 12 && i < 15) {
    const int a = i - 12;
    return col(i) + b.Fvr[3 * a] * col(3) + b.Fvr[3 * a + 1] * col(4) + b.Fvr[3 * a + 2] * col(5)
           + b.Fvba[3 * a] * col(18) + b.Fvba[3 * a + 1] * col(19) + b.Fvba[3 * a + 2] * col(20)
           + b.Fvg[2 * a] * col(21) + b.Fvg[2 * a + 1] * col(22);
  }
  return col(i);
}

// (Fw Q Fw^T)_ij: -Jr dt and -R dt are Frbg and Fvba
__device__ __forceinline__ float process_noise(const Blocks& b, const Noise& q, int i, int j) {
  if (i >= 3 && i < 6 && j >= 3 && j < 6) {
    const int a = i - 3, c = j - 3;
    return (b.Frbg[3 * a] * q.g) * b.Frbg[3 * c] + (b.Frbg[3 * a + 1] * q.g) * b.Frbg[3 * c + 1]
           + (b.Frbg[3 * a + 2] * q.g) * b.Frbg[3 * c + 2];
  }
  if (i >= 12 && i < 15 && j >= 12 && j < 15) {
    const int a = i - 12, c = j - 12;
    return (b.Fvba[3 * a] * q.a) * b.Fvba[3 * c] + (b.Fvba[3 * a + 1] * q.a) * b.Fvba[3 * c + 1]
           + (b.Fvba[3 * a + 2] * q.a) * b.Fvba[3 * c + 2];
  }
  if (i == j && i >= 15 && i < 18) return (b.dt * q.bg) * b.dt;
  if (i == j && i >= 18 && i < 21) return (b.dt * q.ba) * b.dt;
  return 0.f;
}

__global__ void __launch_bounds__(kThreads)
predict_kernel(const float* __restrict__ xin, const float* __restrict__ gyro,
               const float* __restrict__ acc, const float* __restrict__ dts, int N, Noise q,
               float* __restrict__ xout, float* __restrict__ R_traj, float* __restrict__ p_traj) {
  __shared__ float P[kErr * kErr], G[kErr * kErr];
  __shared__ float s[kState];
  __shared__ float gB[6];
  __shared__ Blocks blk;
  __shared__ int live;
  const int tid = threadIdx.x;
  for (int e = tid; e < kErr * kErr; e += kThreads) P[e] = xin[kState + e];
  if (tid < kState) s[tid] = xin[tid];
  __syncthreads();
  if (tid == 0) {
    // gB = -hat(grav) s2_basis(grav); grav does not change inside predict
    float B[6], H[9];
    s2_basis(s + kGrav, B);
    hat3(s + kGrav, H);
    for (int a = 0; a < 3; ++a)
      for (int m = 0; m < 2; ++m)
        gB[2 * a + m] = (-H[3 * a]) * B[m] + (-H[3 * a + 1]) * B[2 + m] + (-H[3 * a + 2]) * B[4 + m];
  }
  for (int i = 0; i < N; ++i) {
    if (tid == 0) {
      const float dt = dts[i];
      live = dt > 0.f;
      if (dt > 0.f) {
        float phi[3], a[3], dRi[9], Jr[9], Ha[9], RHa[9], aw[3], Rn[9];
        const float* R = s + kR;
        for (int k = 0; k < 3; ++k) {
          phi[k] = (gyro[3 * i + k] - s[kBg + k]) * dt;
          a[k] = acc[3 * i + k] - s[kBa + k];
        }
        so3_exp(phi, dRi);
        so3_right_jacobian(phi, Jr);
        matvec3(R, a, aw);
        hat3(a, Ha);
        mul3(R, Ha, RHa);
        for (int r = 0; r < 3; ++r) {
          aw[r] = aw[r] + s[kGrav + r];
          for (int c = 0; c < 3; ++c) {
            blk.Frr[3 * r + c] = dRi[3 * c + r];
            blk.Frbg[3 * r + c] = -Jr[3 * r + c] * dt;
            blk.Fvr[3 * r + c] = -RHa[3 * r + c] * dt;
            blk.Fvba[3 * r + c] = -R[3 * r + c] * dt;
          }
          blk.Fvg[2 * r] = gB[2 * r] * dt;
          blk.Fvg[2 * r + 1] = gB[2 * r + 1] * dt;
        }
        blk.dt = dt;
        for (int r = 0; r < 3; ++r) {
          s[kPos + r] = s[kPos + r] + s[kVel + r] * dt + 0.5f * aw[r] * dt * dt;
          s[kVel + r] = s[kVel + r] + aw[r] * dt;
        }
        mul3(R, dRi, Rn);
        for (int e = 0; e < 9; ++e) s[kR + e] = Rn[e];
      }
      for (int e = 0; e < 9; ++e) R_traj[9 * i + e] = s[kR + e];
      for (int r = 0; r < 3; ++r) p_traj[3 * i + r] = s[kPos + r];
    }
    __syncthreads();
    const bool act = live;
    if (!act) {
      __syncthreads();   // (thread 0 writes live again next)
      continue;
    }
    for (int e = tid; e < kErr * kErr; e += kThreads) {
      const int r = e / kErr, c = e % kErr;
      G[e] = apply_F(blk, r, [&](int k) { return P[k * kErr + c]; });
    }
    __syncthreads();
    for (int e = tid; e < kErr * kErr; e += kThreads) {
      const int r = e / kErr, c = e % kErr;
      P[e] = apply_F(blk, c, [&](int k) { return G[r * kErr + k]; }) + process_noise(blk, q, r, c);
    }
    __syncthreads();
  }
  for (int e = tid; e < kErr * kErr; e += kThreads) xout[kState + e] = P[e];
  if (tid < kState) xout[tid] = s[tid];
}

// ---------------------------------------------------------------------------
// rows: kNN, plane fit, gate and the normal equations of one evaluation
// ---------------------------------------------------------------------------

__device__ __forceinline__ int lower_bound(const int* __restrict__ keys, int n, int key) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(keys + mid) < key) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// (d2, c) before (d2', c'): the order of a stable sort of d2 by candidate
// index, a NaN after every number
__device__ __forceinline__ bool before(float d, int c, float d2, int c2) {
  const bool na = isnan(d), nb = isnan(d2);
  if (na != nb) return nb;
  if (!na && d != d2) return d < d2;
  return c < c2;
}

__device__ __forceinline__ double pick(const double (&h)[12], int a) {
  double r = 0.0;
#pragma unroll
  for (int k = 0; k < 12; ++k) r = k == a ? h[k] : r;
  return r;
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

__global__ void __launch_bounds__(kThreads)
rows_kernel(const float* __restrict__ x, const float* __restrict__ pl,
            const uint8_t* __restrict__ valid, int M, MapIn m, float thr, int ncols, int last,
            double* __restrict__ partials, float* __restrict__ pw, int* __restrict__ n_eff,
            int* __restrict__ nbr) {
  __shared__ float st[kState + 3];
  __shared__ double red[kWarps][kMaxEntries];
  __shared__ int wcount[kWarps];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid < kState) st[tid] = x[tid];
  if (tid < 3) st[kState + tid] = m.origin[tid];
  __syncthreads();
  const float* pos = st + kPos;
  const float* R = st + kR;
  const float* RLI = st + kRLI;
  const float* tLI = st + kTLI;
  const float* org = st + kState;
  const int E = n_entries(ncols);
  const int T = ncols * (ncols + 1) / 2;
  // this lane's entries: (a, b) of sum h_a h_b, (a, -1) of sum h_a z, (-1, -1) the count
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
  const int nw = gridDim.x * kWarps;
  for (int qi = blockIdx.x * kWarps + warp; qi < M; qi += nw) {
    const float l0 = pl[3 * qi], l1 = pl[3 * qi + 1], l2 = pl[3 * qi + 2];
    float pb[3], pwq[3];
    for (int i = 0; i < 3; ++i)
      pb[i] = l0 * RLI[3 * i] + l1 * RLI[3 * i + 1] + l2 * RLI[3 * i + 2] + tLI[i];
    for (int i = 0; i < 3; ++i)
      pwq[i] = pb[0] * R[3 * i] + pb[1] * R[3 * i + 1] + pb[2] * R[3 * i + 2] + pos[i];
    if (last && lane < 3) pw[3 * qi + lane] = pwq[lane];
    const bool live = valid[qi] != 0 && isfinite(pwq[0]) && isfinite(pwq[1]) && isfinite(pwq[2]);
    if (!live) {   // (warp-uniform) ok is false: the row is zero
      if (nbr != nullptr && lane < kNb) nbr[kNb * qi + lane] = -1;
      continue;
    }
    // the query's voxel; a value far outside the grid is clamped where it
    // stays outside
    int qv[3];
    for (int i = 0; i < 3; ++i) {
      float t = floorf(__fdiv_rn(__fsub_rn(pwq[i], org[i]), m.vs));
      t = t < -4.f ? -4.f : (t > float(kGridSize + 4) ? float(kGridSize + 4) : t);
      qv[i] = static_cast<int>(t);
    }
    const int zlo = min(max(qv[2] - 2, 0), kGridSize - 1);
    const int zhi = min(max(qv[2] + 2, 0), kGridSize - 1);
    const int cx = qv[0] + col_ox, cy = qv[1] + col_oy;
    const bool in_grid = lane < kCols && cx >= 0 && cx < kGridSize && cy >= 0 && cy < kGridSize;
    const int key_lo = (cx << 20) | (cy << 10) | zlo;
    const int key_hi = key_lo + (zhi - zlo);
    const int pos0 = in_grid ? lower_bound(m.keys, m.cap, key_lo) : 0;
    float d2[kRun];
    unsigned vmask = 0;
#pragma unroll
    for (int r = 0; r < kRun; ++r) {
      d2[r] = __int_as_float(0x7f800000);   // +inf
      if (in_grid) {
        const int c = min(pos0 + r, m.cap - 1);
        const int k = __ldg(m.keys + c);
        if (k >= key_lo && k <= key_hi && k != kEmpty) {
          vmask |= 1u << r;
          const float dx = __fsub_rn(__ldg(m.pts + 3 * c), pwq[0]);
          const float dy = __fsub_rn(__ldg(m.pts + 3 * c + 1), pwq[1]);
          const float dz = __fsub_rn(__ldg(m.pts + 3 * c + 2), pwq[2]);
          d2[r] = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
        }
      }
    }
    // the 5 nearest by (d2, candidate index lane * 5 + r)
    unsigned taken = 0;
    float sd[kNb];
    bool sv[kNb];
    int slot[kNb];
#pragma unroll
    for (int k = 0; k < kNb; ++k) {
      float bd = __int_as_float(0x7f800000);
      int bc = 0x7fffffff;
      if (lane < kCols) {
#pragma unroll
        for (int r = 0; r < kRun; ++r)
          if (!((taken >> r) & 1u) && before(d2[r], lane * kRun + r, bd, bc)) {
            bd = d2[r];
            bc = lane * kRun + r;
          }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float od = __shfl_xor_sync(kFull, bd, off);
        const int oc = __shfl_xor_sync(kFull, bc, off);
        if (before(od, oc, bd, bc)) {
          bd = od;
          bc = oc;
        }
      }
      const int owner = bc / kRun, rr = bc % kRun;
      if (lane == owner) taken |= 1u << rr;
      const int p0 = __shfl_sync(kFull, pos0, owner);
      const unsigned om = __shfl_sync(kFull, vmask, owner);
      sd[k] = bd;
      sv[k] = (om >> rr) & 1u;
      slot[k] = min(p0 + rr, m.cap - 1);
    }
    if (nbr != nullptr && lane < kNb) {
      int v = -1;
#pragma unroll
      for (int k = 0; k < kNb; ++k)
        if (k == lane) v = sv[k] ? slot[k] : -1;
      nbr[kNb * qi + lane] = v;
    }
    // plane_fit.fit_planes over the 5 (an invalid neighbour weighs 0), the
    // gate and the row in float64 from the float32 neighbours
    double nb[kNb][3];
    double cnt = 0.0;
    int nvalid = 0;
#pragma unroll
    for (int k = 0; k < kNb; ++k) {
      for (int j = 0; j < 3; ++j) nb[k][j] = sv[k] ? double(__ldg(m.pts + 3 * slot[k] + j)) : 0.0;
      cnt += sv[k] ? 1.0 : 0.0;
      nvalid += sv[k];
    }
    cnt = cnt < 1.0 ? 1.0 : cnt;
    double mu[3], cen[kNb][3];
    for (int j = 0; j < 3; ++j) {
      double sum = 0.0;
#pragma unroll
      for (int k = 0; k < kNb; ++k) sum += nb[k][j] * (sv[k] ? 1.0 : 0.0);
      mu[j] = sum / cnt;
    }
#pragma unroll
    for (int k = 0; k < kNb; ++k)
      for (int j = 0; j < 3; ++j) cen[k][j] = (nb[k][j] - mu[j]) * (sv[k] ? 1.0 : 0.0);
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
    const double pd = double(pwq[0]) * nrm[0] + double(pwq[1]) * nrm[1]
                      + double(pwq[2]) * nrm[2] + d;
    const double lq[3] = {l0, l1, l2};
    const double np = sqrt(lq[0] * lq[0] + lq[1] * lq[1] + lq[2] * lq[2]);
    const double gate = sqrt(np < 1e-6 ? 1e-6 : np);
    const double sgate = 1.0 - 0.9 * fabs(pd) / gate;
    const float dist0 = sqrtf(sd[0] < 0.f ? 0.f : sd[0]);
    const bool ok = plane_ok && sgate > 0.9 && dist0 < 5.f;
    if (!ok) continue;
    // the row: n, p_b x R^T n, [p_l x R_LI^T R^T n, R^T n]
    double h[12];
    double Rn[3], RLn[3], cr[3];
    const double pbd[3] = {pb[0], pb[1], pb[2]};
    for (int j = 0; j < 3; ++j)
      Rn[j] = nrm[0] * double(R[j]) + nrm[1] * double(R[3 + j]) + nrm[2] * double(R[6 + j]);
    cross3(pbd, Rn, cr);
    for (int j = 0; j < 3; ++j) {
      h[j] = nrm[j];
      h[3 + j] = cr[j];
      h[6 + j] = 0.0;
      h[9 + j] = 0.0;
    }
    if (ncols == 12) {
      for (int j = 0; j < 3; ++j)
        RLn[j] = Rn[0] * double(RLI[j]) + Rn[1] * double(RLI[3 + j]) + Rn[2] * double(RLI[6 + j]);
      cross3(lq, RLn, cr);
      for (int j = 0; j < 3; ++j) {
        h[6 + j] = cr[j];
        h[9 + j] = Rn[j];
      }
    }
#pragma unroll
    for (int j = 0; j < 12; ++j) h[j] = isfinite(h[j]) ? h[j] : 0.0;
    const double z = isfinite(pd) ? pd : 0.0;
    ++count;
    if (last) continue;
#pragma unroll
    for (int t = 0; t < 3; ++t) {
      if (ea[t] == -2) continue;
      double term;
      if (ea[t] == -1) term = 1.0;
      else if (eb[t] == -1) term = pick(h, ea[t]) * z;
      else term = pick(h, ea[t]) * pick(h, eb[t]);
      acc[t] += term;
    }
  }
  if (last) {
    if (lane == 0) wcount[warp] = count;
    __syncthreads();
    if (tid == 0) {
      int c = 0;
      for (int w = 0; w < kWarps; ++w) c += wcount[w];
      if (c) atomicAdd(n_eff, c);
    }
    return;
  }
#pragma unroll
  for (int t = 0; t < 3; ++t)
    if (lane + 32 * t < E) red[warp][lane + 32 * t] = acc[t];
  __syncthreads();
  if (tid < E) {
    double sum = 0.0;
    for (int w = 0; w < kWarps; ++w) sum += red[w][tid];
    partials[static_cast<size_t>(blockIdx.x) * E + tid] = sum;
  }
}

// ---------------------------------------------------------------------------
// step: the MAP step of an iterate, or the final covariance and the guard
// ---------------------------------------------------------------------------

struct StepSmem {
  double sums[kMaxEntries];
  double Pinv[kErr * kErr];
  double A[kErr * kErr];
  double Tm[kErr * kErr];        // P0^-1 L
  double aug[kErr * 2 * kErr];   // Gauss-Jordan [M | I]
  double col[kErr];
  double x[kState], x0[kState];
  double Lr[9], Le[9], Lg[4];    // the transport Jacobian's blocks
  double dx0[kErr], w[kErr], b[kErr], delta[kErr];
  int piv;
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
  if (a >= 3 && a < 6) return s.Lr[3 * (a - 3) + (i - 3)];
  if (a >= 6 && a < 9) return s.Le[3 * (a - 6) + (i - 6)];
  if (a >= 21) return s.Lg[2 * (a - 21) + (i - 21)];
  return a == i ? 1.0 : 0.0;
}

// the inverse of M (row-major n x n in s.aug's left half on entry; the
// inverse lands in out), Gauss-Jordan with partial pivoting on the block
__device__ void gauss_jordan_inverse(StepSmem& s, double* out) {
  const int n = kErr, w = 2 * kErr, tid = threadIdx.x;
  for (int c = 0; c < n; ++c) {
    if (tid == 0) {
      int p = c;
      double best = fabs(s.aug[c * w + c]);
      for (int r = c + 1; r < n; ++r) {
        const double v = fabs(s.aug[r * w + c]);
        if (v > best) {
          best = v;
          p = r;
        }
      }
      s.piv = p;
    }
    __syncthreads();
    const int p = s.piv;
    if (p != c)
      for (int k = tid; k < w; k += kThreads) {
        const double t = s.aug[c * w + k];
        s.aug[c * w + k] = s.aug[p * w + k];
        s.aug[p * w + k] = t;
      }
    __syncthreads();
    const double inv = 1.0 / s.aug[c * w + c];
    __syncthreads();
    for (int k = tid; k < w; k += kThreads) s.aug[c * w + k] *= inv;
    for (int r = tid; r < n; r += kThreads) s.col[r] = s.aug[r * w + c];
    __syncthreads();
    for (int e = tid; e < n * w; e += kThreads) {
      const int r = e / w, k = e % w;
      if (r != c) s.aug[e] -= s.col[r] * s.aug[c * w + k];
    }
    __syncthreads();
  }
  for (int e = tid; e < n * n; e += kThreads) out[e] = s.aug[(e / n) * w + n + e % n];
  __syncthreads();
}

// boxminus(x, x0) into s.dx0 and the transport Jacobian's blocks: three
// threads of three warps side by side
__device__ void tangent_terms(StepSmem& s) {
  const int tid = threadIdx.x;
  if (tid == 0 || tid == 32) {
    const int o = tid == 0 ? kR : kRLI;
    double D[9], w[3];
    mul3tn(s.x0 + o, s.x + o, D);
    so3_log(D, w);
    so3_right_jacobian_inv(w, tid == 0 ? s.Lr : s.Le);
    for (int k = 0; k < 3; ++k) s.dx0[(tid == 0 ? 3 : 6) + k] = w[k];
  } else if (tid == 64) {
    // d/dd [(g + d) - g0] at d = 0: g + d = Exp(B(g) d) g moves g by
    // B_k x g along d_k
    const double* g = s.x + kGrav;
    double B[6], dg[2][3], dout[2][2], out[2];
    s2_basis(g, B);
    for (int k = 0; k < 2; ++k) {
      const double bk[3] = {B[k], B[2 + k], B[4 + k]};
      cross3(bk, g, dg[k]);
    }
    s2_boxminus(g, s.x0 + kGrav, out, dg, dout);
    s.dx0[21] = out[0];
    s.dx0[22] = out[1];
    for (int r = 0; r < 2; ++r)
      for (int k = 0; k < 2; ++k) s.Lg[2 * r + k] = dout[r][k];
  } else if (tid == 96) {
    for (int k = 0; k < 3; ++k) {
      s.dx0[k] = s.x[kPos + k] - s.x0[kPos + k];
      s.dx0[9 + k] = s.x[kTLI + k] - s.x0[kTLI + k];
      s.dx0[12 + k] = s.x[kVel + k] - s.x0[kVel + k];
      s.dx0[15 + k] = s.x[kBg + k] - s.x0[kBg + k];
      s.dx0[18 + k] = s.x[kBa + k] - s.x0[kBa + k];
    }
  }
  __syncthreads();
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
      for (int b = 0; b < kErr; ++b) v += s.Pinv[a * kErr + b] * s.dx0[b];
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

__global__ void __launch_bounds__(kThreads)
step_kernel(const double* __restrict__ partials, int blocks, int ncols, double r_inv, double eps,
            const float* __restrict__ xp, const float* __restrict__ x0p, int first, int final_,
            double* __restrict__ work, float* __restrict__ x_next, float* __restrict__ out,
            int* __restrict__ ints, uint8_t* __restrict__ bad) {
  __shared__ StepSmem s;
  __shared__ double conv, iters;
  const int tid = threadIdx.x;
  const int E = n_entries(ncols);
  // the blocks' partial sums in a fixed order: a warp an entry at a time,
  // lane l adds blocks l, l + 32, ... in four interleaved accumulators
  // (added in order), then the lanes by a fixed xor tree
  if (tid < kState) s.x0[tid] = double(xp[tid]);
  {
    const int lane = tid & 31, warp = tid >> 5;
    for (int e = warp; e < E; e += kWarps) {
      double a4[4] = {0.0, 0.0, 0.0, 0.0};
      int b = lane;
      for (; b + 96 < blocks; b += 128) {
#pragma unroll
        for (int u = 0; u < 4; ++u) a4[u] += partials[static_cast<size_t>(b + 32 * u) * E + e];
      }
      for (int u = 0; b < blocks; b += 32, ++u) a4[u] += partials[static_cast<size_t>(b) * E + e];
      double sum = (a4[0] + a4[1]) + (a4[2] + a4[3]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(kFull, sum, off);
      if (lane == 0) s.sums[e] = sum;
    }
  }
  if (first) {
    // P0^-1 = (P0 + 1e-9 I)^-1; the iterate starts at the prediction
    for (int e = tid; e < kErr * kErr; e += kThreads) {
      const int r = e / kErr, c = e % kErr;
      s.aug[r * 2 * kErr + c] = double(xp[kState + e]) + (r == c ? 1e-9 : 0.0);
      s.aug[r * 2 * kErr + kErr + c] = r == c ? 1.0 : 0.0;
    }
    if (tid < kState) s.x[tid] = s.x0[tid];
    if (tid == 0) {
      conv = 0.0;
      iters = 0.0;
    }
    __syncthreads();
    gauss_jordan_inverse(s, s.Pinv);
    for (int e = tid; e < kErr * kErr; e += kThreads) work[e] = s.Pinv[e];
  } else {
    for (int e = tid; e < kErr * kErr; e += kThreads) s.Pinv[e] = work[e];
    if (tid < kState) s.x[tid] = work[kErr * kErr + tid];
    if (tid == 0) {
      conv = work[kErr * kErr + kState];
      iters = work[kErr * kErr + kState + 1];
    }
  }
  // the final covariance is taken in the tangent of the state as it is
  // written (float32): S2's basis B(g) changes where the smallest |g_i|
  // changes hands, which rounding can decide near an axis
  if (final_ && tid < kState) s.x[tid] = double(float(s.x[tid]));
  __syncthreads();
  tangent_terms(s);
  if (!final_) {
    assemble(s, ncols, r_inv, true);
    // Cholesky of A's lower triangle, right-looking, a column a pass
    for (int c = 0; c < kErr; ++c) {
      if (tid == 0) s.A[c * kErr + c] = sqrt(s.A[c * kErr + c]);
      __syncthreads();
      const double inv = 1.0 / s.A[c * kErr + c];
      for (int i = c + 1 + tid; i < kErr; i += kThreads) s.A[i * kErr + c] *= inv;
      __syncthreads();
      const int m = kErr - 1 - c;
      for (int e = tid; e < m * m; e += kThreads) {
        const int i = c + 1 + e / m, j = c + 1 + e % m;
        if (j <= i) s.A[i * kErr + j] -= s.A[i * kErr + c] * s.A[j * kErr + c];
      }
      __syncthreads();
    }
    if (tid == 0) {
      double y[kErr];
      for (int i = 0; i < kErr; ++i) {
        double v = s.b[i];
        for (int j = 0; j < i; ++j) v -= s.A[i * kErr + j] * y[j];
        y[i] = v / s.A[i * kErr + i];
      }
      for (int i = kErr - 1; i >= 0; --i) {
        double v = y[i];
        for (int j = i + 1; j < kErr; ++j) v -= s.A[j * kErr + i] * s.delta[j];
        s.delta[i] = v / s.A[i * kErr + i];
      }
      // boxplus under the convergence mask; converged on max |delta| < eps (a
      // NaN never converges)
      const bool step_ok = conv == 0.0;
      bool now = true;
      for (int i = 0; i < kErr; ++i) now = now && fabs(s.delta[i]) < eps;
      if (step_ok) {
        const double* d = s.delta;
        double* x = s.x;
        double E3[9], Rn[9], g[3];
        for (int k = 0; k < 3; ++k) {
          x[kPos + k] += d[k];
          x[kTLI + k] += d[9 + k];
          x[kVel + k] += d[12 + k];
          x[kBg + k] += d[15 + k];
          x[kBa + k] += d[18 + k];
        }
        so3_exp(d + 3, E3);
        mul3(x + kR, E3, Rn);
        for (int e = 0; e < 9; ++e) x[kR + e] = Rn[e];
        so3_exp(d + 6, E3);
        mul3(x + kRLI, E3, Rn);
        for (int e = 0; e < 9; ++e) x[kRLI + e] = Rn[e];
        s2_boxplus(x + kGrav, d + 21, g);
        for (int k = 0; k < 3; ++k) x[kGrav + k] = g[k];
        iters += 1.0;
      }
      if (now) conv = 1.0;
    }
    __syncthreads();
    if (tid < kState) {
      work[kErr * kErr + tid] = s.x[tid];
      x_next[tid] = float(s.x[tid]);
    }
    if (tid == 0) {
      work[kErr * kErr + kState] = conv;
      work[kErr * kErr + kState + 1] = iters;
    }
    return;
  }
  // the final covariance in the tangent at the converged state
  assemble(s, ncols, r_inv, false);
  for (int e = tid; e < kErr * kErr; e += kThreads) {
    const int r = e / kErr, c = e % kErr;
    s.aug[r * 2 * kErr + c] = s.A[e];
    s.aug[r * 2 * kErr + kErr + c] = r == c ? 1.0 : 0.0;
  }
  __syncthreads();
  gauss_jordan_inverse(s, s.Tm);
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
    ints[0] = static_cast<int>(iters);
    ints[1] = 0;   // the last evaluation's inlier count adds into it
    bad[0] = is_bad;
  }
}

}  // namespace

extern "C" int tc2li_lio_rows_blocks(int M) {
  return max(1, min(kRowsMaxBlocks, (M + kWarps - 1) / kWarps));
}

extern "C" int tc2li_lio_work_doubles() { return kWork; }

extern "C" int tc2li_esekf_predict(const float* xin, const float* gyro, const float* acc,
                                   const float* dts, int N, float qg, float qa, float qbg,
                                   float qba, float* xout, float* R_traj, float* p_traj,
                                   void* stream) {
  if (N < 0) return static_cast<int>(cudaErrorInvalidValue);
  const Noise q{qg, qa, qbg, qba};
  predict_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      xin, gyro, acc, dts, N, q, xout, R_traj, p_traj);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tc2li_lio_rows(const float* x, const float* pl, const uint8_t* valid, int M,
                              const int* keys, const float* mpts, const float* origin, int cap,
                              float vs, float thr, int ncols, int last, double* partials,
                              float* pw, int* n_eff, int* nbr, void* stream) {
  if (M < 0 || cap < 1 || (ncols != 6 && ncols != 12))
    return static_cast<int>(cudaErrorInvalidValue);
  const MapIn m{keys, mpts, origin, cap, vs};
  rows_kernel<<<tc2li_lio_rows_blocks(M), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, pl, valid, M, m, thr, ncols, last, partials, pw, n_eff, nbr);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tc2li_esekf_step(const double* partials, int blocks, int ncols, double r_inv,
                                double eps, const float* xp, const float* x0p, int first,
                                int final_, double* work, float* x_next, float* out, int* ints,
                                uint8_t* bad, void* stream) {
  if (blocks < 1 || (ncols != 6 && ncols != 12)) return static_cast<int>(cudaErrorInvalidValue);
  step_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      partials, blocks, ncols, r_inv, eps, xp, x0p, first, final_, work, x_next, out, ints, bad);
  return static_cast<int>(cudaGetLastError());
}
