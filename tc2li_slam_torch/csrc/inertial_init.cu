// The visual-inertial initialization's Gauss-Newton (InertialOptimization):
// every iteration of one call on the device, in one launch, no host sync.
//
// Replaces tc2li_slam_tpu/solver/inertial_init.py:85 (inertial_optimization):
// on the TPU one jit-compiled program whose iterations are a lax.scan
// (:184). Eager PyTorch ran it as torch.func.jacfwd of the whitened
// residual vector in a Python loop, thousands of small ops a call.
//
// What it computes is the plain version's (ops/kernels/inertial_init.py:
// inertial_init_plain). Keyframe poses T_wb [K] are fixed; the unknowns x
// [9 + 3K] are the gravity tangent (x0, x1: R_wg = R_wg0 Exp([x0, x1, 0]),
// the absolute tangent, not re-anchored), the log-scale x2, one shared gyro
// and accel bias (x3..x5, x6..x8) and the K velocities. Factor f (f -> f + 1,
// K - 1 of them) is EdgeInertialGS's residual [er, ev, ep] with the
// preintegration corrected at the biases, whitened by L^T (L the Cholesky
// factor of C_inv + 1e-6 I) and multiplied by its validity (a product, not a
// selection: a non-finite input in an invalid factor gives NaN, as there);
// the bias priors add sqrt(prior_g) bg and sqrt(prior_a) ba. Then the
// entry cost, lam = 1e-4, and `iters` times: J and r at x; H = J^T J and g =
// J^T r; the frozen coordinates' rows and columns (the scale with
// fix_scale, the two gravity coordinates with fix_gravity) replaced by the
// identity with g 0 there; Haug = H + lam diag(H) + 1e-9 I; the Jacobi-scaled
// system (lm.precond_solve: d = sqrt(max(|diag|, 1e-12))) solved by
// Gauss-Jordan elimination with partial pivoting (schur.cuh gauss_jordan, in
// one block); x_new = x - dx; the candidate's cost; accepted when strictly
// lower (lam x 0.5), else lam x 4. The result R_wg0 Exp([x0, x1, 0]), the
// scale (1 with fix_scale, else exp(x2)), bg, ba, the velocities and the
// cost are rounded to float32 once.
//
// The Jacobian is jacfwd's: forward-mode dual numbers (a value and one
// tangent) through the residual as written, geom/lie.py's so3_exp and
// so3_log with their Taylor branches below kEps and their clamps included
// (a clamp passes the tangent where the value lies inside it, as torch's
// clamp does). A factor touches 15 of the 9 + 3K columns: gravity 2, scale
// 1, bg 3, ba 3, v_f 3, v_{f+1} 3; thread (f, j) evaluates factor f with
// the tangent on its local column j and writes column j of the factor's
// whitened 9 x 15 block (thread (f, 0) also its residual).
//
// Numbers: everything after the float32 inputs is float64 (the whitening's
// Cholesky, residuals, Jacobians, H, the scaling, the elimination, the
// costs). Whitened IMU Jacobians of 1e3 and more sit beside O(1) gravity
// columns, so the float32 plain version is farther from the float64 truth
// than this kernel (chip_smoke.vi_agreement's rule holds it).
//
// Bound on the H100: latency. A call at K 20, 20 iterations reads ~13 KB
// and does ~7 M float64 operations (under a microsecond of either); its
// iterations are serial, and in each the solve's 69 columns are too.
// Design: one block of kThreads threads for the whole call, the problem in
// shared memory. A call: the factors' rows loaded in float64 with R1, R1^T R2,
// p2 - p1 and L^T (a thread a factor, its Cholesky), the entry cost; then an
// iteration is: the Jacobian phase (a thread a factor and local column, the
// dual evaluation); H and g an entry a thread, each the sum over the
// factors that touch both columns in factor order (the 15 x 15 blocks, no
// atomics: the same bits on every call), plus the priors, the freezing and
// the damping; the scaling; Gauss-Jordan (warp 0 the pivot, a warp a row);
// the candidate; its cost (a thread a factor, added in factor order by
// thread 0); the accept test. The system of 9 + 3K rows and the factors
// must fit one block's shared memory: K above kMaxKF is refused.

#include <climits>
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "dual.cuh"
#include "imu_factor.cuh"
#include "schur.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 320;     // the block (10 warps)
constexpr int kSmemLimit = 232448;
constexpr double kGMag = 9.81;    // solver/inertial_init.py G_MAG
// a factor's row in shared memory (doubles)
constexpr int kQdR = 0, kQdV = 9, kQdP = 12, kQJRg = 15, kQJVg = 24, kQJVa = 33, kQJPg = 42,
              kQJPa = 51, kQdt = 60, kQLt = 61, kQbg = 142, kQba = 145, kQvalid = 148,
              kQR1 = 149, kQR12 = 158, kQdp = 167, kQ = 170;
constexpr int kJ = 135;           // a factor's whitened block: 9 rows x 15 local columns

// ---------------------------------------------------------------------------
// the factor
// ---------------------------------------------------------------------------

struct Problem {
  const float *T_wb, *dR, *dV, *dP, *JRg, *JVg, *JVa, *JPg, *JPa, *dt, *C_inv, *bg_lin, *ba_lin;
  const uint8_t* valid;
  const float *R_wg0, *vel0;
  int K, F, n, iters, fix_scale, fix_gravity;
  double sqrt_pg, sqrt_pa;
  float* out;   // R_wg [9], scale, bg [3], ba [3], vel [3K], cost
};

// factor f's whitened residual [9] at x (solver/inertial_init's residuals),
// with the tangent on the factor's local column `dir` (0..14; -1: none)
template <class T>
__device__ void factor_residual(const double* q, const double* Rwg0, const double* x, int f,
                                int dir, bool fix_scale, T r[9]) {
  const int v0 = 9 + 3 * f;
  T phi[3] = {lift<T>(x[0], dir == 0), lift<T>(x[1], dir == 1), lift<T>(0.0, false)};
  T E[9];
  so3_exp_t(phi, E);
  T gw[3];   // (R_wg0 Exp(phi)) (0, 0, -9.81)
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    T RE[3];
#pragma unroll
    for (int m = 0; m < 3; ++m)
      RE[m] = (Rwg0[3 * k] * E[m] + Rwg0[3 * k + 1] * E[3 + m]) + Rwg0[3 * k + 2] * E[6 + m];
    gw[k] = (RE[0] * 0.0 + RE[1] * 0.0) + RE[2] * (-kGMag);
  }
  const T s = fix_scale ? lift<T>(1.0, false) : dexp(lift<T>(x[2], dir == 2));
  T dbg[3], dba[3], v1[3], v2[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    dbg[k] = lift<T>(x[3 + k], dir == 3 + k) - q[kQbg + k];
    dba[k] = lift<T>(x[6 + k], dir == 6 + k) - q[kQba + k];
    v1[k] = lift<T>(x[v0 + k], dir == 9 + k);
    v2[k] = lift<T>(x[v0 + 3 + k], dir == 12 + k);
  }
  // the bias re-correction: dR Exp(JRg dbg), dV + JVg dbg + JVa dba, ...
  T wb[3], Eb[9], dVc[3], dPc[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const double* J = q + kQJRg + 3 * i;
    wb[i] = (J[0] * dbg[0] + J[1] * dbg[1]) + J[2] * dbg[2];
    const double *Vg = q + kQJVg + 3 * i, *Va = q + kQJVa + 3 * i;
    const double *Pg = q + kQJPg + 3 * i, *Pa = q + kQJPa + 3 * i;
    dVc[i] = (q[kQdV + i] + ((Vg[0] * dbg[0] + Vg[1] * dbg[1]) + Vg[2] * dbg[2])) +
             ((Va[0] * dba[0] + Va[1] * dba[1]) + Va[2] * dba[2]);
    dPc[i] = (q[kQdP + i] + ((Pg[0] * dbg[0] + Pg[1] * dbg[1]) + Pg[2] * dbg[2])) +
             ((Pa[0] * dba[0] + Pa[1] * dba[1]) + Pa[2] * dba[2]);
  }
  so3_exp_t(wb, Eb);
  T eR[9];   // (dR Eb)^T (R1^T R2)
  {
    T dRc[9];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j)
        dRc[3 * i + j] = (q[kQdR + 3 * i] * Eb[j] + q[kQdR + 3 * i + 1] * Eb[3 + j]) +
                         q[kQdR + 3 * i + 2] * Eb[6 + j];
    const double* R12 = q + kQR12;
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j)
        eR[3 * i + j] = (dRc[i] * R12[j] + dRc[3 + i] * R12[3 + j]) + dRc[6 + i] * R12[6 + j];
  }
  T r9[9];
  so3_log_t(eR, r9);
  const double dt = q[kQdt];
  const double* R1 = q + kQR1;
  T a[3], b[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    a[k] = s * (v2[k] - v1[k]) - gw[k] * dt;
    b[k] = s * (q[kQdp + k] - v1[k] * dt) - (0.5 * gw[k] * dt) * dt;
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) {   // R1^T a - dV_c, R1^T b - dP_c
    r9[3 + i] = ((R1[i] * a[0] + R1[3 + i] * a[1]) + R1[6 + i] * a[2]) - dVc[i];
    r9[6 + i] = ((R1[i] * b[0] + R1[3 + i] * b[1]) + R1[6 + i] * b[2]) - dPc[i];
  }
  const double w = q[kQvalid];
#pragma unroll
  for (int i = 0; i < 9; ++i) {   // L^T r9, every entry (0 x NaN is NaN, as there)
    T acc = q[kQLt + 9 * i] * r9[0];
#pragma unroll
    for (int j = 1; j < 9; ++j) acc = acc + q[kQLt + 9 * i + j] * r9[j];
    r[i] = acc * w;
  }
}

// the factors a column touches: [lo, hi)
__device__ __forceinline__ void factors_of(int col, int F, int& lo, int& hi) {
  if (col < 9) {
    lo = 0;
    hi = F;
  } else {
    const int v = (col - 9) / 3;
    lo = v > 0 ? v - 1 : 0;
    hi = v + 1 < F ? v + 1 : F;
  }
}

// column col's local index in factor f's block
__device__ __forceinline__ int local_of(int col, int f) { return col < 9 ? col : col - 3 * f; }

__device__ __forceinline__ bool frozen(const Problem& pr, int c) {
  return (c == 2 && pr.fix_scale) || (c < 2 && pr.fix_gravity);
}

// the cost at x: each factor's squared whitened residual (a thread a
// factor), then thread 0 adds them in factor order and the priors'
__device__ double cost_of(const Problem& pr, const double* fac, const double* Rwg0,
                          const double* x, double* cf, double* s_cost) {
  for (int f = threadIdx.x; f < pr.F; f += blockDim.x) {
    double r[9];
    factor_residual<double>(fac + static_cast<size_t>(f) * kQ, Rwg0, x, f, -1,
                            pr.fix_scale != 0, r);
    double c = 0.0;
    for (int i = 0; i < 9; ++i) c += r[i] * r[i];
    cf[f] = c;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    double c = 0.0;
    for (int f = 0; f < pr.F; ++f) c += cf[f];
    for (int k = 0; k < 3; ++k) {
      const double rg = pr.sqrt_pg * x[3 + k];
      c += rg * rg;
    }
    for (int k = 0; k < 3; ++k) {
      const double ra = pr.sqrt_pa * x[6 + k];
      c += ra * ra;
    }
    *s_cost = c;
  }
  __syncthreads();
  return *s_cost;
}

// dynamic shared memory of a call with K keyframes (bytes):
// ops/kernels/inertial_init.py smem_bytes
__host__ __device__ constexpr long long smem_of(int K) {
  return 8LL * ((9 + 3 * K) * (10 + 3 * K) + 3 * (9 + 3 * K) + (K - 1) * (kQ + kJ + 9 + 1) + 9) +
         4LL * 2 * (9 + 3 * K);
}

// the largest K whose call fits kSmemLimit beside the kernel's static shared
// memory (64 bytes counted): ops/kernels/inertial_init.py MAX_KF
constexpr int max_kf() {
  int K = 1;
  while (smem_of(K + 1) + 64 <= kSmemLimit) ++K;
  return K;
}
constexpr int kMaxKF = max_kf();
static_assert(kMaxKF >= 20, "System._initialize_imu always passes K = 20");

__global__ void __launch_bounds__(kThreads, 1) inertial_init_kernel(const Problem pr) {
  extern __shared__ double sm[];
  __shared__ double s_cost, s_cand;
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x, n = pr.n, F = pr.F, Wd = n + 1;
  double* M = sm;                 // [n, n + 1]: the scaled system and g
  double* x = M + n * Wd;         // [n] the state
  double* xn = x + n;             // [n] the candidate
  double* dsc = xn + n;           // [n] the Jacobi scaling
  double* fac = dsc + n;          // [F, kQ] the factors
  double* J = fac + F * kQ;       // [F, 9, 15] the whitened blocks
  double* rf = J + F * kJ;        // [F, 9] the whitened residuals
  double* cf = rf + F * 9;        // [F] their costs
  double* Rwg0 = cf + F;          // [9]
  int* pos2row = reinterpret_cast<int*>(Rwg0 + 9);
  int* row2pos = pos2row + n;

  // load: x, R_wg0, and a factor a thread in float64 (its rotations, p2 - p1
  // and L^T, the Cholesky factor of C_inv + 1e-6 I, transposed)
  for (int e = tid; e < n; e += blockDim.x) x[e] = e < 9 ? 0.0 : static_cast<double>(pr.vel0[e - 9]);
  for (int e = tid; e < 9; e += blockDim.x) Rwg0[e] = pr.R_wg0[e];
  for (int f = tid; f < F; f += blockDim.x) {
    double* q = fac + static_cast<size_t>(f) * kQ;
    for (int e = 0; e < 9; ++e) {
      q[kQdR + e] = pr.dR[9 * f + e];
      q[kQJRg + e] = pr.JRg[9 * f + e];
      q[kQJVg + e] = pr.JVg[9 * f + e];
      q[kQJVa + e] = pr.JVa[9 * f + e];
      q[kQJPg + e] = pr.JPg[9 * f + e];
      q[kQJPa + e] = pr.JPa[9 * f + e];
    }
    for (int k = 0; k < 3; ++k) {
      q[kQdV + k] = pr.dV[3 * f + k];
      q[kQdP + k] = pr.dP[3 * f + k];
      q[kQbg + k] = pr.bg_lin[3 * f + k];
      q[kQba + k] = pr.ba_lin[3 * f + k];
    }
    q[kQdt] = pr.dt[f];
    q[kQvalid] = pr.valid[f] ? 1.0 : 0.0;
    const float* T1 = pr.T_wb + 16 * f;
    const float* T2 = T1 + 16;
    for (int i = 0; i < 3; ++i) {
      for (int j = 0; j < 3; ++j) {
        q[kQR1 + 3 * i + j] = T1[4 * i + j];
        q[kQR12 + 3 * i + j] =
            (static_cast<double>(T1[i]) * T2[j] + static_cast<double>(T1[4 + i]) * T2[4 + j]) +
            static_cast<double>(T1[8 + i]) * T2[8 + j];
      }
      q[kQdp + i] = static_cast<double>(T2[4 * i + 3]) - static_cast<double>(T1[4 * i + 3]);
    }
    // Cholesky of the lower triangle (torch.linalg.cholesky's), L^T stored
    const float* C = pr.C_inv + 81 * f;
    double L[81];
    for (int e = 0; e < 81; ++e) L[e] = 0.0;
    for (int j = 0; j < 9; ++j) {
      double d = static_cast<double>(C[9 * j + j]) + 1e-6;
      for (int k = 0; k < j; ++k) d -= L[9 * j + k] * L[9 * j + k];
      const double ljj = sqrt(d);
      L[9 * j + j] = ljj;
      for (int i = j + 1; i < 9; ++i) {
        double a = C[9 * i + j];
        for (int k = 0; k < j; ++k) a -= L[9 * i + k] * L[9 * j + k];
        L[9 * i + j] = a / ljj;
      }
    }
    for (int i = 0; i < 9; ++i)
      for (int j = 0; j < 9; ++j) q[kQLt + 9 * i + j] = L[9 * j + i];
  }
  __syncthreads();
  double cost = cost_of(pr, fac, Rwg0, x, cf, &s_cost);
  double lam = 1e-4;

  for (int it = 0; it < pr.iters; ++it) {
    // the Jacobian: thread (f, j) factor f's column j, by dual numbers
    for (int t = tid; t < 15 * F; t += blockDim.x) {
      const int f = t / 15, j = t % 15;
      Dual r[9];
      factor_residual<Dual>(fac + static_cast<size_t>(f) * kQ, Rwg0, x, f, j,
                            pr.fix_scale != 0, r);
      double* Jf = J + static_cast<size_t>(f) * kJ;
      for (int i = 0; i < 9; ++i) Jf[15 * i + j] = r[i].d;
      if (j == 0)
        for (int i = 0; i < 9; ++i) rf[9 * f + i] = r[i].v;
    }
    __syncthreads();
    // H = J^T J and g = J^T r an entry a thread: the factors that touch the
    // entry's columns in factor order, then the priors; frozen rows and
    // columns the identity, g 0; the damping on the diagonal
    for (int e = tid; e < n * Wd; e += blockDim.x) {
      const int a = e / Wd, b = e % Wd;
      double h = 0.0;
      if (b == n) {   // g
        if (!frozen(pr, a)) {
          int lo, hi;
          factors_of(a, F, lo, hi);
          for (int f = lo; f < hi; ++f) {
            const double* Jf = J + static_cast<size_t>(f) * kJ;
            const double* r = rf + 9 * f;
            const int la = local_of(a, f);
            for (int i = 0; i < 9; ++i) h += Jf[15 * i + la] * r[i];
          }
          if (a >= 3 && a < 6) h += pr.sqrt_pg * (pr.sqrt_pg * x[a]);
          if (a >= 6 && a < 9) h += pr.sqrt_pa * (pr.sqrt_pa * x[a]);
        }
      } else if (frozen(pr, a) || frozen(pr, b)) {
        h = a == b ? 1.0 : 0.0;
      } else {
        int lo, hi, lo2, hi2;
        factors_of(a, F, lo, hi);
        factors_of(b, F, lo2, hi2);
        lo = lo > lo2 ? lo : lo2;
        hi = hi < hi2 ? hi : hi2;
        for (int f = lo; f < hi; ++f) {
          const double* Jf = J + static_cast<size_t>(f) * kJ;
          const int la = local_of(a, f), lb = local_of(b, f);
          for (int i = 0; i < 9; ++i) h += Jf[15 * i + la] * Jf[15 * i + lb];
        }
        if (a == b && a >= 3 && a < 6) h += pr.sqrt_pg * pr.sqrt_pg;
        if (a == b && a >= 6 && a < 9) h += pr.sqrt_pa * pr.sqrt_pa;
      }
      if (a == b) h = (h + lam * h) + 1e-9;   // H + lam diag(H) + 1e-9 I
      M[e] = h;
    }
    __syncthreads();
    // the Jacobi scaling (lm.precond_solve)
    for (int r = tid; r < n; r += blockDim.x) {
      const double d = fabs(M[r * Wd + r]);
      dsc[r] = sqrt(d < 1e-12 ? 1e-12 : d);
      pos2row[r] = r;
      row2pos[r] = r;
    }
    __syncthreads();
    for (int e = tid; e < n * Wd; e += blockDim.x) {
      const int a = e / Wd, b = e % Wd;
      M[e] = b < n ? M[e] / (dsc[a] * dsc[b]) : M[e] / dsc[a];
    }
    __syncthreads();
    gauss_jordan<kThreads, 1>(cluster, M, nullptr, pos2row, row2pos, n, n + 5, 0, n, false, 0);
    // x_new = x - y / d, row r's pivot in column row2pos[r]
    for (int r = tid; r < n; r += blockDim.x) {
      const int c = row2pos[r];
      xn[c] = x[c] - (M[r * Wd + n] / M[r * Wd + c]) / dsc[c];
    }
    __syncthreads();
    const double cand = cost_of(pr, fac, Rwg0, xn, cf, &s_cand);
    const bool acc = cand < cost;   // a NaN rejects
    for (int e = tid; e < n; e += blockDim.x)
      if (acc) x[e] = xn[e];
    lam = acc ? lam * 0.5 : lam * 4.0;
    cost = acc ? cand : cost;
    __syncthreads();
  }

  // the result, rounded to float32 once
  float* o = pr.out;
  for (int e = tid; e < 3 * pr.K; e += blockDim.x) o[16 + e] = static_cast<float>(x[9 + e]);
  if (tid == 0) {
    const double phi[3] = {x[0], x[1], 0.0};
    double E[9], R[9];
    so3_exp_t<double>(phi, E);
    mm(Rwg0, E, R);
    for (int e = 0; e < 9; ++e) o[e] = static_cast<float>(R[e]);
    o[9] = pr.fix_scale ? 1.0f : static_cast<float>(exp(x[2]));
    for (int k = 0; k < 6; ++k) o[10 + k] = static_cast<float>(x[3 + k]);
    o[16 + 3 * pr.K] = static_cast<float>(cost);
  }
}

}  // namespace

extern "C" long long tc2li_inertial_init_smem(int K) { return smem_of(K); }

extern "C" int tc2li_inertial_init_max_kf() { return kMaxKF; }

// T_wb [K, 4, 4]; dR, JRg, JVg, JVa, JPg, JPa [K - 1, 3, 3]; dV, dP, bg_lin,
// ba_lin [K - 1, 3]; dt [K - 1]; C_inv [K - 1, 9, 9]; R_wg0 [3, 3]; vel0
// [K, 3] float32; valid [K - 1] uint8 (0 or 1); out [17 + 3K] float32 (R_wg,
// scale, bg, ba, vel, cost). All contiguous on the device. One launch on
// `stream`; returns the first CUDA error code that is not cudaSuccess (K
// above kMaxKF refused).
extern "C" int tc2li_inertial_init_gn(const float* T_wb, const float* dR, const float* dV,
                                      const float* dP, const float* JRg, const float* JVg,
                                      const float* JVa, const float* JPg, const float* JPa,
                                      const float* dt, const float* C_inv, const float* bg_lin,
                                      const float* ba_lin, const uint8_t* valid,
                                      const float* R_wg0, const float* vel0, int K,
                                      double prior_g, double prior_a, int fix_scale,
                                      int fix_gravity, int iters, float* out, void* stream) {
  if (K < 1 || K > kMaxKF || iters < 0 || smem_of(K) > kSmemLimit)
    return static_cast<int>(cudaErrorInvalidValue);
  Problem pr{T_wb, dR, dV, dP, JRg, JVg, JVa, JPg, JPa, dt, C_inv, bg_lin, ba_lin, valid,
             R_wg0, vel0, K, K - 1, 9 + 3 * K, iters, fix_scale != 0, fix_gravity != 0,
             sqrt(prior_g), sqrt(prior_a), out};
  const size_t smem = static_cast<size_t>(smem_of(K));
  int rc;
  if ((rc = static_cast<int>(cudaFuncSetAttribute(
           inertial_init_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
           static_cast<int>(smem)))) != 0)
    return rc;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;   // gauss_jordan's cluster of one block
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(1);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if ((rc = static_cast<int>(cudaLaunchKernelEx(&cfg, inertial_init_kernel, pr))) != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
