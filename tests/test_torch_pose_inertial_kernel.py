"""The IMU mode's per-frame refinement: the dispatch of its two kernels
(``csrc/imu_preint.cu``, ``csrc/pose_inertial.cu``) by device, their plain
versions against the JAX package on cases ``test_torch_inertial.py`` lacks,
and numpy emulations of the kernels' orders of sums and solves against the
JAX package.

The kernels cannot run here. What they do differently from their plain
versions is the order of their sums, their types and the shape of their
solves, so (the kernels' present shapes, chunked preintegration and the
whole-block assembly and factor, are in ``test_torch_vi_emulation.py``):

- ``imu_preintegrate``: the sequential chain over samples in float64 with
  the covariance as M = A C9, then M A^T and (B N) B^T added, against
  ``estimation.imu.integrate`` of the JAX package;
- ``pose_inertial_lm``: every evaluation in float64, the rows' sums in the
  kernel's order (an eighth of the rows a block of the cluster, strided
  over its 256 threads, a warp reduce-scatter, the warps then the blocks in
  order), C9 inverted once, one pass an iteration (the candidate's H and g
  kept when it is accepted), the damped Jacobi-preconditioned system solved
  by Cholesky, the last evaluation gated and, at 30 free dims, prev
  Schur-marginalized by Cholesky; against ``optimize_last_kf`` /
  ``optimize_last_frame`` of the JAX package.

Tolerances follow ``test_torch_inertial.assert_vi_result_close``: the state
to 1e-4 (T_wb, vel, ba) and 1e-5 (bg), the cost to 1e-3 relative (absolute
below 1), and the next prior's H, stricter, to 1e-3 after diagonal scaling
(each entry against sqrt(H_ii H_jj), ``chip_smoke.diag_scale``): the
largest entry is the bias walk's ~1e12, which would leave the pose and
velocity blocks unchecked. A float32 solve differs from float64 by up to
~4e-5 in T_wb on these frames (the IMU information is O(1e6) beside the
visual O(1)). Inlier flags must be equal but where a row's chi2,
re-derived in float64, sits at its gate (``chip_smoke.vi_agreement``). The
preintegration's outputs are held to 1e-4 of their largest entry, its
covariance diagonally scaled (``chip_smoke.imu_distance``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from tc2li_slam_tpu.estimation import imu as jimu
from tc2li_slam_tpu.geom import camera as jcam
from tc2li_slam_tpu.solver import pose_inertial as jpi
from tc2li_slam_torch.estimation import imu as timu
from tc2li_slam_torch.geom import lie as tlie
from tc2li_slam_torch.ops.kernels import imu_preint as kimu, pose_inertial as kpi
from tc2li_slam_torch.solver import inertial_ba as tiba, pose_inertial as tpi
from test_torch_kernel_emulation import _reduce_scatter
from torch_parity import n, t

F64 = np.float64
BLOCKS, THREADS, WARPS = 8, 256, 8   # csrc/pose_inertial.cu's cluster
H_IDX = [(j, k) for j in range(6) for k in range(j, 6)]
NAMES = {15: "optimize_last_kf", 30: "optimize_last_frame"}


def vi_case(nf, case="full", n_rows=2000, seed=11):
    p = chip_smoke.vi_problem(np.random.default_rng(seed), n_rows, nf, case)
    return p, chip_smoke.vi_args(torch, p, "cpu")[1]


def to_jax(x):
    """The port's argument (a tensor, a NamedTuple of them, a camera) as
    the JAX package's."""
    if isinstance(x, torch.Tensor):
        return jnp.asarray(x.numpy())
    cls = {"FrameVIState": jpi.FrameVIState, "FramePrior": jpi.FramePrior,
           "Preintegrated": jimu.Preintegrated}.get(type(x).__name__)
    if cls is not None:
        return cls(*(to_jax(a) for a in x))
    if type(x).__name__ == "Pinhole":
        return jcam.Pinhole.create(x.fx, x.fy, x.cx, x.cy, bf=x.bf)
    return x


def jax_result(r):
    """A JAX ``PoseInertialResult`` as the port's, on the CPU."""
    tt = lambda a: t(np.asarray(a))
    s = tpi.FrameVIState(*(tt(a) for a in r.state))
    prior = tpi.FramePrior(tpi.FrameVIState(*(tt(a) for a in r.prior.state)), tt(r.prior.H),
                           tt(r.prior.weight))
    return tpi.PoseInertialResult(s, prior, tt(r.n_inliers), tt(r.inliers), tt(r.cost))


def run_jax(nf, args):
    return jax_result(getattr(jpi, NAMES[nf])(*(to_jax(a) for a in args)))


def assert_close(got, ref, args):
    agr = chip_smoke.vi_agreement(torch, args, got, ref)
    for k, tol in chip_smoke.VI_TOL.items():
        assert agr[k] <= tol, (k, agr)
    assert agr["flips"] == agr["near"], agr
    return agr


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------

def test_integrate_dispatch_by_device():
    """CPU tensors take the plain version (no launch); a device that is
    neither the CPU nor CUDA raises; the kernel's wrapper refuses the CPU."""
    p, _ = vi_case(15, n_rows=8)
    cal = timu.ImuCalib.create(*p["calib"])
    a = (cal, t(p["gyro"]), t(p["acc"]), t(p["dts"]), torch.zeros(3), torch.zeros(3))
    before = kimu.launches
    got = timu.integrate(*a)
    assert kimu.launches == before and got.dR.device.type == "cpu"
    assert all(torch.equal(x, y) for x, y in zip(got, kimu.integrate_plain(*a)))
    with pytest.raises(ValueError, match="unsupported device"):
        timu.integrate(cal, *(x.to("meta") for x in a[1:]))
    with pytest.raises(ValueError, match="CUDA"):
        kimu.imu_preintegrate(*a)


@pytest.mark.parametrize("nf", [15, 30])
def test_pose_inertial_dispatch_by_device(nf):
    _, args = vi_case(nf, n_rows=40)
    name = NAMES[nf]
    before = kpi.launches
    got = getattr(tpi, name)(*args)
    assert kpi.launches == before and got.state.T_wb.device.type == "cpu"
    ref = getattr(kpi, name + "_plain")(*args)
    assert torch.equal(got.state.T_wb, ref.state.T_wb) and torch.equal(got.prior.H, ref.prior.H)
    assert got.n_inliers.dtype == torch.int32
    meta = tuple(a.to("meta") if isinstance(a, torch.Tensor) else a for a in args)
    with pytest.raises(ValueError, match="unsupported device"):
        getattr(tpi, name)(*meta)
    prior = None if nf == 15 else args[4]
    with pytest.raises(ValueError, match="CUDA"):
        kpi.pose_inertial_lm(*args[:4], prior, *args[-9:])


# ---------------------------------------------------------------------------
# the plain versions against the JAX package
# ---------------------------------------------------------------------------

def _window(case):
    """gyro, acc, dts of a 1024-slot ring (32 windows of 32 slots, each
    ~10 live samples and padding, as System's ring before its trim) or of one
    window with padded samples among the live ones."""
    rng = np.random.default_rng(5)
    N = 1024 if case == "ring_1024" else 40
    gyro = rng.normal(0, 0.2, (N, 3))
    acc = rng.normal(0, 1.0, (N, 3)) + [0.0, 0.0, 9.81]
    if case == "ring_1024":
        dts = np.where(np.arange(N) % 32 < rng.integers(8, 12), 0.01, 0.0)
    else:
        dts = np.where(rng.random(N) < 0.3, 0.0, 0.005)
        dts[-5:] = 0.0
        gyro[dts == 0] = 50.0    # (what a padded slot holds does not matter)
    return tuple(a.astype(np.float32) for a in (gyro, acc, dts))


@pytest.mark.parametrize("case", ["ring_1024", "padded"])
def test_integrate_plain_matches_jax(case):
    g, a, d = _window(case)
    bg, ba = np.array([1e-3, -2e-3, 5e-4], np.float32), np.array([0.02, -0.01, 0.03], np.float32)
    sig = chip_smoke.VI_CALIB
    ref = jimu.integrate(jimu.ImuCalib.create(*sig), *map(jnp.asarray, (g, a, d, bg, ba)))
    got = timu.integrate(timu.ImuCalib.create(*sig), *map(t, (g, a, d, bg, ba)))
    # float32 chains of 1024 steps in two orders: within 1e-4 of each output's
    # largest entry, C diagonally scaled (chip_smoke.imu_distance; measured
    # under 3e-6)
    for f in timu.Preintegrated._fields:
        r = torch.as_tensor(np.asarray(getattr(ref, f), F64))
        assert chip_smoke.imu_distance(torch, f, getattr(got, f), r) <= 1e-4, f
    if case == "padded":
        # padding is an exact no-op of the chain: the same as the live samples
        # alone, but for the total time (a vectorized sum over other slots)
        live = d > 0
        alone = timu.integrate(timu.ImuCalib.create(*sig), *map(t, (g[live], a[live], d[live],
                                                                     bg, ba)))
        for f in timu.Preintegrated._fields:
            x, y = getattr(got, f), getattr(alone, f)
            if f == "C":
                assert torch.equal(x[:9, :9], y[:9, :9])
                x, y = x[9:, 9:], y[9:, 9:]
            if f in ("C", "dt"):
                torch.testing.assert_close(x, y, rtol=1e-6, atol=0.0)
            else:
                assert torch.equal(x, y), f


@pytest.mark.parametrize("nf", [15, 30])
def test_plain_matches_jax_full_width(nf):
    """O = 2000 rows, 5% of them at the chi2 gate, 5% outliers, 3% masked."""
    _, args = vi_case(nf)
    got = getattr(tpi, NAMES[nf])(*args)
    agr = assert_close(got, run_jax(nf, args), args)
    assert 1500 < agr["n_inliers"][0] < 2000


@pytest.mark.parametrize("nf", [15, 30])
def test_plain_masked_nan_row_matches_jax(nf):
    """A masked row whose point is NaN: its weight is multiplied in (0 x NaN),
    every sum is NaN and no step is accepted, in both packages."""
    _, args = vi_case(nf, "masked_nan")
    got, ref = getattr(tpi, NAMES[nf])(*args), run_jax(nf, args)
    assert np.isnan(float(got.cost)) and np.isnan(float(ref.cost))
    assert torch.equal(got.state.T_wb, args[2].T_wb) and torch.equal(ref.state.T_wb, args[2].T_wb)
    assert torch.equal(got.inliers, ref.inliers)


def test_prior_weight_zero_is_the_empty_prior():
    """``prior.weight`` 0 in the port against ``FramePrior.empty()`` in the
    JAX package: no prior either way. With no prior on prev, the marginal
    H's block of the frame's velocity is ~1e-6 (the 1e-6 I of the Schur
    step), the difference of terms of ~1e6 that float32 resolves to ~3e-5
    (28 times the entry in the float64 run): between these two float32 runs
    H is held to 1e-3 of its largest entry instead of diagonally scaled.
    The port's own run with ``FramePrior.empty()`` gives the same bits."""
    _, args = vi_case(30, "prior_off")
    assert float(args[4].weight) == 0.0
    got = tpi.optimize_last_frame(*args)
    jargs = [to_jax(a) for a in args]
    jargs[4] = jpi.FramePrior.empty()
    ref = jax_result(jpi.optimize_last_frame(*jargs))
    agr = chip_smoke.vi_agreement(torch, args, got, ref)
    for k, tol in chip_smoke.VI_TOL.items():
        assert k == "H" or agr[k] <= tol, (k, agr)
    assert agr["flips"] == agr["near"], agr
    d_H = float((got.prior.H - ref.prior.H).abs().max() / ref.prior.H.abs().max())
    assert d_H <= chip_smoke.VI_TOL["H"], d_H
    empty = tpi.optimize_last_frame(*args[:4], tpi.FramePrior.empty(), *args[5:])
    assert chip_smoke.bit_equal(torch, [got.state.T_wb, got.prior.H, got.cost, got.inliers],
                                [empty.state.T_wb, empty.prior.H, empty.cost, empty.inliers])


# ---------------------------------------------------------------------------
# the kernels' orders, emulated
# ---------------------------------------------------------------------------

def _integrate_emulated(cal, g, a, d, bg, ba):
    """The sequential chain in float64 (the plain version's order)."""
    g, a, d, bg, ba = (np.asarray(x, F64) for x in (g, a, d, bg, ba))
    act = d > 0
    dt_all = np.where(act, d, 0.0)
    w = np.where(act[:, None], g - bg, 0.0) * dt_all[:, None]
    acc = np.where(act[:, None], a - ba, 0.0)
    dRi = n(tlie.so3_exp(t(w))).astype(F64)
    Jr = n(tlie.so3_right_jacobian(t(w))).astype(F64)
    dR, dV, dP = np.eye(3), np.zeros(3), np.zeros(3)
    JRg, JVg, JVa, JPg, JPa = (np.zeros((3, 3)) for _ in range(5))
    C9 = np.zeros((9, 9))
    for k in range(len(d)):
        dt = dt_all[k]
        dt2 = dt * dt
        Ra = dR @ acc[k]
        Rah = dR @ n(tlie.hat(t(acc[k]))).astype(F64)
        RJ = Rah @ JRg
        A = np.eye(9)
        A[0:3, 0:3] = dRi[k].T
        A[3:6, 0:3] = -Rah * dt
        A[6:9, 0:3] = -0.5 * Rah * dt2
        A[6:9, 3:6] = np.eye(3) * dt
        B = np.zeros((9, 6))
        B[0:3, 0:3] = Jr[k] * dt
        B[3:6, 3:6] = dR * dt
        B[6:9, 3:6] = 0.5 * dR * dt2
        nv = np.repeat([cal.sigma_g ** 2, cal.sigma_a ** 2], 3) / max(dt, 1e-9)
        dP = dP + dV * dt + 0.5 * Ra * dt2
        dV = dV + Ra * dt
        JPa = JPa - 0.5 * dR * dt2
        JPg = JPg + JVg * dt - 0.5 * RJ * dt2
        JVa = JVa - dR * dt
        JVg = JVg - RJ * dt
        M = A @ C9
        C9 = M @ A.T + (B * nv) @ B.T
        JRg = dRi[k].T @ JRg - Jr[k] * dt
        dR = dR @ dRi[k]
    t_total = dt_all.sum()
    C = np.zeros((15, 15))
    C[:9, :9] = C9
    C[9:, 9:] = np.diag(np.repeat([cal.sigma_gw ** 2, cal.sigma_aw ** 2], 3) * t_total)
    return dict(dR=dR, dV=dV, dP=dP, C=C, JRg=JRg, JVg=JVg, JVa=JVa, JPg=JPg, JPa=JPa,
                dt=t_total)


@pytest.mark.parametrize("case", ["ring_1024", "padded"])
def test_integrate_order_matches_jax(case):
    g, a, d = _window(case)
    bg, ba = np.array([1e-3, -2e-3, 5e-4], np.float32), np.array([0.02, -0.01, 0.03], np.float32)
    cal = timu.ImuCalib.create(*chip_smoke.VI_CALIB)
    got = _integrate_emulated(cal, g, a, d, bg, ba)
    ref = jimu.integrate(jimu.ImuCalib.create(*chip_smoke.VI_CALIB),
                         *map(jnp.asarray, (g, a, d, bg, ba)))
    for f, v in got.items():
        r = torch.as_tensor(np.asarray(getattr(ref, f), F64))
        assert chip_smoke.imu_distance(torch, f, torch.as_tensor(v), r) <= 1e-4, f


def _row_sums(cam, T_cb, T_wb, X, uvr, s2, st, va, gate):
    """One pass: the rows' 28 sums in the kernel's order, and the inlier flags."""
    r, J, _, Xc = tiba.body_reprojection(cam, T_cb, tlie.se3_inverse(T_wb), X, uvr, st)
    r, J, Xc = n(r), n(J), n(Xc)
    s2n, stn, van = n(s2), n(st), n(va)
    rr = np.sum(r * r, -1)
    chi2 = s2n * rr
    thr = np.where(stn, F64(np.float32(7.815)), F64(np.float32(5.991)))
    act = van & (Xc[:, 2] > 0.05)
    inl = act & (chi2 <= thr)
    if gate:
        act = inl
    with np.errstate(invalid="ignore", divide="ignore"):
        hub = np.where(chi2 <= thr, 1.0, np.sqrt(thr / np.maximum(chi2, 1e-12)))
    w = s2n * hub * act
    Jw = J * w[:, None, None]
    rows = np.zeros((X.shape[0], 32))
    for i, (j, k) in enumerate(H_IDX):
        rows[:, i] = np.einsum("oi,oi->o", Jw[:, :, j], J[:, :, k])
    rows[:, 21:27] = np.einsum("oij,oi->oj", Jw, r)
    rows[:, 27] = w * rr
    O = X.shape[0]
    per = -(-O // BLOCKS)
    total = np.zeros(32)
    for q in range(BLOCKS):
        blk = rows[min(q * per, O):min(q * per + per, O)]
        acc = np.zeros((THREADS, 32))
        for base in range(0, len(blk), THREADS):
            m = min(THREADS, len(blk) - base)
            acc[:m] += blk[base:base + m]
        per_warp = _reduce_scatter(acc.reshape(WARPS, 32, 32))
        sq = np.zeros(32)
        for wp in range(WARPS):
            sq = sq + per_warp[wp]
        total = total + sq
    return total, inl


def _cholesky(A):
    """A right-looking factor, column by column, pivots scaled first."""
    A = A.copy()
    nn = A.shape[0]
    for c in range(nn):
        piv = np.sqrt(A[c, c])
        A[c + 1:, c] /= piv
        A[c, c] = piv
        for r in range(c + 1, nn):
            A[r, c + 1:r + 1] -= A[r, c] * A[c + 1:r + 1, c]
    return np.tril(A)


def _chol_solve(L, b):
    y = b.copy()
    for c in range(len(b)):
        y[c] /= L[c, c]
        y[c + 1:] -= L[c + 1:, c] * y[c]
    for c in range(len(b) - 1, -1, -1):
        y[c] /= L[c, c]
        y[:c] -= L[c, :c] * y[c]
    return y


def _pose_inertial_emulated(nf, args):
    """The LM's order of evaluations and steps in float64 from the float32
    arguments, the assembly through the JAX-shaped factor terms."""
    a64 = chip_smoke._vi_cast(torch, args, torch.float64)
    if nf == 15:
        cam, T_cb, s0, anchor, pre, grav, X, uvr, s2, st, va, ibg, iba = a64
        prior = None
    else:
        cam, T_cb, s0, anchor, prior, pre, grav, X, uvr, s2, st, va, ibg, iba = a64
    C9 = n(pre.C[:9, :9]) + 1e-10 * np.eye(9)
    info = torch.as_tensor(np.linalg.inv(C9))
    D = tpi.D

    def evaluate(sp, sc, gate):
        vis, inl = _row_sums(cam, T_cb, sc.T_wb, X, uvr, s2, st, va, gate)
        H11, H12, H22, g1, g2, ci = (n(x) for x in tpi._imu_pair_terms(
            sp, sc, pre, info, grav, ibg, iba))
        Hv = np.zeros((6, 6))
        for i, (j, k) in enumerate(H_IDX):
            Hv[j, k] = Hv[k, j] = vis[i]
        H22 = H22.copy()
        H22[:6, :6] += Hv
        g2 = g2.copy()
        g2[:6] += vis[21:27]
        cost = vis[27] + ci
        if nf == 15:
            return H22, g2, cost, inl
        Hp, gp, cp = (n(x) for x in tpi._prior_terms(sp, prior))
        H = np.block([[H11 + Hp, H12], [H12.T, H22]])
        return H, np.concatenate([g1 + gp, g2]), cost + cp, inl

    sp, sc = anchor, s0
    cost = 0.0
    for rnd in range(2):
        gate = rnd > 0
        lam = 1e-2
        H, g, cost, _ = evaluate(sp, sc, gate)
        for _ in range(6):
            Haug = H + np.diag(lam * np.diag(H)) + 1e-6 * np.eye(nf)
            d = np.sqrt(np.maximum(np.abs(np.diag(Haug)), 1e-12))
            x = _chol_solve(_cholesky(Haug / np.outer(d, d)), g / d)
            dx = torch.as_tensor(-(x / d))
            sp_n = tpi._apply(sp, dx[:D]) if nf == 30 else sp
            sc_n = tpi._apply(sc, dx[nf - D:])
            Hn, gn, cn, _ = evaluate(sp_n, sc_n, gate)
            if cn < cost:
                sp, sc, H, g, cost, lam = sp_n, sc_n, Hn, gn, cn, lam * 0.5
            else:
                lam *= 4.0
    H, _, _, inl = evaluate(sp, sc, True)
    if nf == 30:
        L = _cholesky(H[:D, :D] + 1e-6 * np.eye(D))
        Xs = np.stack([_chol_solve(L, H[:D, D + j]) for j in range(D)], 1)
        Hm = H[D:, D:] - H[:D, D:].T @ Xs
        H = 0.5 * (Hm + Hm.T)
    f32 = lambda x: x.float() if isinstance(x, torch.Tensor) else torch.as_tensor(x).float()
    s = tpi.FrameVIState(*(f32(x) for x in sc))
    inl_t = torch.as_tensor(inl)
    return tpi.PoseInertialResult(s, tpi.FramePrior(s, f32(H), torch.ones(())),
                                  inl_t.sum(dtype=torch.int32), inl_t, f32(cost))


@pytest.mark.parametrize("nf,case", [(15, "full"), (30, "full"), (30, "padded_imu"),
                                     (15, "nothing_valid")])
def test_pose_inertial_order_matches_jax(nf, case):
    _, args = vi_case(nf, case)
    got = _pose_inertial_emulated(nf, args)
    assert_close(got, run_jax(nf, args), args)


def test_chip_smoke_vi_phase_runs_on_the_cpu():
    """``chip_smoke.vi_phase`` (phase 5's checks of both kernels) on the
    CPU, with 4e-like saved inputs: both routes are the plain versions
    here, so every comparison holds exactly and the rows carry no time."""
    saved = {}
    for nf in (15, 30):
        saved[NAMES[nf]] = vi_case(nf, n_rows=200, seed=nf)[1]
    p, _ = vi_case(15, n_rows=8)
    cal = timu.ImuCalib.create(*p["calib"])
    window = (cal, t(p["gyro"]), t(p["acc"]), t(p["dts"]), torch.zeros(3), torch.zeros(3))
    saved["integrate:last"] = saved["integrate:longest"] = window
    rows = chip_smoke.vi_phase(torch, "cpu", saved, np.random.default_rng(0), log=lambda m: None)
    assert set(rows) == {"pose_inertial_lm", "imu_preintegrate"}
    assert rows["pose_inertial_lm"]["max_abs_err"] == 0.0
    assert rows["imu_preintegrate"]["max_abs_err"] == 0.0
    assert np.isnan(rows["pose_inertial_lm"]["ms"]) and rows["pose_inertial_lm"]["bound_ms"] > 0
