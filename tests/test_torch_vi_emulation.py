"""Numpy emulations of the IMU mode's two kernels in their present orders,
against the JAX package.

The kernels cannot run here. What they do differently from their plain
versions is the shape of their computation, so each is emulated in float64
with the kernel's own structure and held against the JAX function:

- ``csrc/imu_preint.cu``: the live samples compacted, cut into chunks of
  ``max(8, ceil(n / 64))``, each chunk integrated from the identity in its
  own frame, the chunks joined in the kernel's fixed tree over 64 slots
  (the transition's block form, the second chunk moved into the first's
  frame by diag(I, dR_1, dR_1), the reference's JPa rule); held against
  ``estimation.imu.integrate`` to 1e-4 (``chip_smoke.imu_distance``: C
  diagonally scaled, any other output over its largest entry);
- ``csrc/pose_inertial.cu``: the assembly from the IMU and prior factors'
  shared intermediates, entry by entry (J1, J2, Jp), the products over the
  Jacobians' non-zero rows and the symmetric blocks' upper triangles, the
  gradient as J^T (I r); the damped system's right-looking Cholesky with the
  pivots' scaling deferred, the solves by multiplication with the inverse
  pivots; the Schur step the same way; against ``optimize_last_kf`` /
  ``optimize_last_frame`` under ``chip_smoke.VI_TOL``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from tc2li_slam_tpu.estimation import imu as jimu
from tc2li_slam_torch.estimation import imu as timu
from tc2li_slam_torch.geom import lie as tlie
from tc2li_slam_torch.solver import pose_inertial as tpi
from test_torch_pose_inertial_kernel import (H_IDX, _row_sums, _window, assert_close, run_jax,
                                             vi_case)
from torch_parity import n, t

F64 = np.float64
SLOTS, MIN_CHUNK = 64, 8   # csrc/imu_preint.cu kSlots, kMinChunk


def _hat(v):
    return np.array([[0.0, -v[2], v[1]], [v[2], 0.0, -v[0]], [-v[1], v[0], 0.0]])


def _acat(C, P, X, Y, h):
    """A C A^T for A = [[P, 0, 0], [X, I, 0], [Y, h I, I]]."""
    A = np.eye(9)
    A[0:3, 0:3], A[3:6, 0:3], A[6:9, 0:3], A[6:9, 3:6] = P, X, Y, h * np.eye(3)
    return A @ C @ A.T


def _identity():
    z = np.zeros((3, 3))
    return dict(dR=np.eye(3), dV=np.zeros(3), dP=np.zeros(3), t=0.0, JRg=z, JVg=z, JPg=z,
                JVa=z, JPa=z, C=np.zeros((9, 9)), n=0)


def _step(p, dRi, Jrdt, a, dt, ng, na):
    """One sample into a chunk's map (the plain version's formulas)."""
    dt2 = dt * dt
    dR = p["dR"]
    Ra, Rah = dR @ a, dR @ _hat(a)
    RJ = Rah @ p["JRg"]
    B = np.zeros((9, 6))
    B[0:3, 0:3], B[3:6, 3:6], B[6:9, 3:6] = Jrdt, dR * dt, 0.5 * dR * dt2
    nv = np.repeat([ng, na], 3)
    q = dict(p)
    q["dP"] = p["dP"] + p["dV"] * dt + 0.5 * Ra * dt2
    q["dV"] = p["dV"] + Ra * dt
    q["JPa"] = p["JPa"] - 0.5 * dR * dt2
    q["JPg"] = p["JPg"] + p["JVg"] * dt - 0.5 * RJ * dt2
    q["JVa"] = p["JVa"] - dR * dt
    q["JVg"] = p["JVg"] - RJ * dt
    q["C"] = _acat(p["C"], dRi.T, -Rah * dt, -0.5 * Rah * dt2, dt) + (B * nv) @ B.T
    q["JRg"] = dRi.T @ p["JRg"] - Jrdt
    q["dR"] = dR @ dRi
    q["t"] = p["t"] + dt
    q["n"] = p["n"] + 1
    return q


def _join(L, R, jpa_follows_phi=False):
    """L then R: R moved into L's frame by D = diag(I, dR_L, dR_L)."""
    R1, h = L["dR"], R["t"]
    P, X, Y = R["dR"].T, -R1 @ _hat(R["dV"]), -R1 @ _hat(R["dP"])
    D = np.eye(9)
    D[3:6, 3:6] = D[6:9, 6:9] = R1
    out = dict(n=L["n"] + R["n"], t=L["t"] + h, dR=R1 @ R["dR"], dV=L["dV"] + R1 @ R["dV"],
               dP=L["dP"] + L["dV"] * h + R1 @ R["dP"],
               C=_acat(L["C"], P, X, Y, h) + D @ R["C"] @ D.T,
               JRg=P @ L["JRg"] + R["JRg"], JVg=X @ L["JRg"] + L["JVg"] + R1 @ R["JVg"],
               JPg=Y @ L["JRg"] + h * L["JVg"] + L["JPg"] + R1 @ R["JPg"],
               JVa=L["JVa"] + R1 @ R["JVa"], JPa=L["JPa"] + R1 @ R["JPa"])
    if jpa_follows_phi:   # ORB-SLAM3's rule, which the reference does not follow
        out["JPa"] = out["JPa"] + L["JVa"] * h
    return out


def integrate_chunked(cal, g, a, d, bg, ba, jpa_follows_phi=False):
    """csrc/imu_preint.cu in float64: compaction, chunks, the fixed tree."""
    g, a, d, bg, ba = (np.asarray(x, F64) for x in (g, a, d, bg, ba))
    live = np.flatnonzero(d > 0)
    n_live = len(live)
    s = max(MIN_CHUNK, -(-n_live // SLOTS))
    w = (g[live] - bg) * d[live, None]
    dRi = n(tlie.so3_exp(t(w))).astype(F64)
    Jr = n(tlie.so3_right_jacobian(t(w))).astype(F64)
    slots = []
    for j in range(SLOTS):
        p = _identity()
        for k in range(j * s, min((j + 1) * s, n_live)):
            dt = d[live[k]]
            p = _step(p, dRi[k], Jr[k] * dt, a[live[k]] - ba, dt,
                      cal.sigma_g ** 2 / max(dt, 1e-9), cal.sigma_a ** 2 / max(dt, 1e-9))
        slots.append(p)
    span = 1
    while span < SLOTS:   # (2i, 2i + 1), then (4i, 4i + 2), ...
        for w0 in range(0, SLOTS, 2 * span):
            if slots[w0 + span]["n"] > 0:
                slots[w0] = _join(slots[w0], slots[w0 + span], jpa_follows_phi)
        span *= 2
    r = slots[0]
    C = np.zeros((15, 15))
    C[:9, :9] = r["C"]
    C[9:, 9:] = np.diag(np.repeat([cal.sigma_gw ** 2, cal.sigma_aw ** 2], 3) * r["t"])
    return dict(dR=r["dR"], dV=r["dV"], dP=r["dP"], C=C, JRg=r["JRg"], JVg=r["JVg"],
                JVa=r["JVa"], JPg=r["JPg"], JPa=r["JPa"], dt=r["t"]), s, r["n"]


def _chunk_window(case):
    """gyro, acc, dts: ``_window``'s cases, and windows of N live samples
    (with padding among them where named) at and around the chunk sizes."""
    if case in ("ring_1024", "padded"):
        return _window(case)
    rng = np.random.default_rng(9)
    kind, N = case.split(":")
    N = int(N)
    gyro = rng.normal(0, 0.3, (N, 3))
    acc = rng.normal(0, 1.0, (N, 3)) + [0.0, 0.0, 9.81]
    dts = np.full(N, 0.005)
    if kind == "all_padding":
        dts[:] = 0.0
    elif kind == "gaps":   # every third slot padding, a NaN among them
        dts[::3] = 0.0
        dts[1::9] = np.nan
    return tuple(x.astype(np.float32) for x in (gyro, acc, dts))


def _jax_integrate(g, a, d, bg, ba):
    return jimu.integrate(jimu.ImuCalib.create(*chip_smoke.VI_CALIB),
                          *map(jnp.asarray, (g, a, d, bg, ba)))


def _distances(got, ref):
    return {f: chip_smoke.imu_distance(torch, f, torch.as_tensor(v),
                                       torch.as_tensor(np.asarray(getattr(ref, f), F64)))
            for f, v in got.items()}


@pytest.mark.parametrize("case,chunk", [("ring_1024", 8), ("padded", 8), ("live:1", 8),
                                        ("live:7", 8), ("live:8", 8), ("live:9", 8),
                                        ("live:60", 8), ("live:511", 8), ("live:512", 8),
                                        ("live:513", 9), ("gaps:1024", 9),
                                        ("live:1000", 16), ("live:1024", 16)])
def test_integrate_chunked_matches_jax(case, chunk):
    """The chunked chains and their tree against the JAX package: N 1, a
    chunk size's edges (8 samples one chunk, 9 two; 512 live samples the
    last at s 8, 513 the first at s 9), padding and a NaN dt among the
    samples, 4e's window length and the 1024-slot ring."""
    g, a, d = _chunk_window(case)
    bg, ba = np.array([1e-3, -2e-3, 5e-4], np.float32), np.array([0.02, -0.01, 0.03], np.float32)
    cal = timu.ImuCalib.create(*chip_smoke.VI_CALIB)
    got, s, n_live = integrate_chunked(cal, g, a, d, bg, ba)
    assert s == chunk and n_live == int((d > 0).sum())
    dist = _distances(got, _jax_integrate(g, a, d, bg, ba))
    assert max(dist.values()) <= 1e-4, dist


def test_integrate_chunked_all_padding_is_the_identity():
    g, a, d = _chunk_window("all_padding:40")
    z = np.zeros(3, np.float32)
    cal = timu.ImuCalib.create(*chip_smoke.VI_CALIB)
    got, _, n_live = integrate_chunked(cal, g, a, d, z, z)
    assert n_live == 0 and got["dt"] == 0.0
    assert np.array_equal(got["dR"], np.eye(3)) and not np.any(got["C"])
    assert not any(np.any(got[f]) for f in ("dV", "dP", "JRg", "JVg", "JVa", "JPg", "JPa"))
    dist = _distances(got, _jax_integrate(g, a, d, z, z))
    assert max(dist.values()) == 0.0, dist


@pytest.mark.parametrize("case", ["live:9", "live:60", "ring_1024"])
def test_integrate_chunked_pins_the_reference_jpa(case):
    """JVa is not 0 at a chunk's end, so a join that carried ORB-SLAM3's
    JPa += JVa t_2 (JPa following the transition) would leave the reference:
    the kernel's join omits it, as the reference's update does."""
    g, a, d = _chunk_window(case)
    z = np.zeros(3, np.float32)
    cal = timu.ImuCalib.create(*chip_smoke.VI_CALIB)
    ref = _jax_integrate(g, a, d, z, z)
    good, _, _ = integrate_chunked(cal, g, a, d, z, z)
    bad, _, _ = integrate_chunked(cal, g, a, d, z, z, jpa_follows_phi=True)
    assert _distances(good, ref)["JPa"] <= 1e-4
    assert _distances(bad, ref)["JPa"] > 1e-2
    assert np.array_equal(good["JVa"], bad["JVa"])


def test_integrate_chunked_padding_is_left_out():
    """A window and the same window with its padding removed give the same
    chunks, so the same map (the kernel's card test asserts the bits)."""
    g, a, d = _chunk_window("gaps:300")
    cal = timu.ImuCalib.create(*chip_smoke.VI_CALIB)
    z = np.zeros(3, np.float32)
    live = d > 0
    got, _, _ = integrate_chunked(cal, g, a, d, z, z)
    alone, _, _ = integrate_chunked(cal, g[live], a[live], d[live], z, z)
    for f in got:
        assert np.array_equal(got[f], alone[f]), f


# ---------------------------------------------------------------------------
# csrc/pose_inertial.cu: the whole-block assembly and step
# ---------------------------------------------------------------------------

def _so3(fn, x):
    return n(fn(torch.as_tensor(np.asarray(x, F64)))).astype(F64)


def _imu_pre(pre, gravity, a, s):
    """imu_pre: the IMU factor's residual and the intermediates of J1, J2."""
    T1, T2 = n(a.T_wb).astype(F64), n(s.T_wb).astype(F64)
    R1, p1, R2, p2 = T1[:3, :3], T1[:3, 3], T2[:3, :3], T2[:3, 3]
    q = {f: n(getattr(pre, f)).astype(F64) for f in ("dR", "dV", "dP", "JRg", "JVg", "JVa",
                                                      "JPg", "JPa", "bg", "ba", "dt")}
    bg, ba = n(s.bg).astype(F64), n(s.ba).astype(F64)
    dbg, dba = bg - q["bg"], ba - q["ba"]
    rw = np.concatenate([bg - n(a.bg), ba - n(a.ba)])
    dRc = q["dR"] @ _so3(tlie.so3_exp, q["JRg"] @ dbg)
    dVc = q["dV"] + q["JVg"] @ dbg + q["JVa"] @ dba
    dPc = q["dP"] + q["JPg"] @ dbg + q["JPa"] @ dba
    eR = dRc.T @ R1.T @ R2
    er = _so3(tlie.so3_log, eR)
    dt, grav = float(q["dt"]), n(gravity).astype(F64)
    va, vs = n(a.vel).astype(F64), n(s.vel).astype(F64)
    Rdv = R1.T @ (vs - va - grav * dt)
    Rdp = R1.T @ (p2 - p1 - va * dt - 0.5 * grav * dt * dt)
    iJ = _so3(tlie.so3_right_jacobian_inv, er)
    r = np.concatenate([er, Rdv - dVc, Rdp - dPc])
    return dict(R1=R1, R2=R2, eR=eR, iJ=iJ, Rdv=Rdv, Rdp=Rdp, r=r, rw=rw, dt=dt, q=q)


def _prior_pre(prior, s):
    T, Tl = n(s.T_wb).astype(F64), n(prior.state.T_wb).astype(F64)
    M = Tl[:3, :3].T @ T[:3, :3]
    er = _so3(tlie.so3_log, M)
    rp = np.concatenate([er, Tl[:3, :3].T @ (T[:3, 3] - Tl[:3, 3]),
                         *(n(getattr(s, f)).astype(F64) - n(getattr(prior.state, f))
                           for f in ("vel", "bg", "ba"))])
    return dict(rp=rp, Mp=M, iJp=_so3(tlie.so3_right_jacobian_inv, er))


def _jacobians(m, pp):
    """J1, J2 and Jp entry by entry, as j1_entry, j2_entry and jp_entry."""
    R1, R2, iJ, q = m["R1"], m["R2"], m["iJ"], m["q"]
    J1, J2 = np.zeros((9, 15)), np.zeros((9, 15))
    J1[6:9, 0:3] = -np.eye(3)
    J1[0:3, 3:6] = -(iJ @ (R2.T @ R1))
    J1[3:6, 3:6], J1[6:9, 3:6] = _hat(m["Rdv"]), _hat(m["Rdp"])
    J1[3:6, 6:9], J1[6:9, 6:9] = -R1.T, -R1.T * m["dt"]
    J2[6:9, 0:3], J2[0:3, 3:6], J2[3:6, 6:9] = R1.T @ R2, iJ, R1.T
    J2[0:3, 9:12] = (-iJ @ m["eR"].T) @ q["JRg"]
    J2[3:6, 9:12], J2[6:9, 9:12] = -q["JVg"], -q["JPg"]
    J2[3:6, 12:15], J2[6:9, 12:15] = -q["JVa"], -q["JPa"]
    Jp = None
    if pp is not None:
        Jp = np.eye(15)
        Jp[:6, :6] = 0.0
        Jp[0:3, 3:6], Jp[3:6, 0:3] = pp["iJp"], pp["Mp"]
    return J1, J2, Jp


J1_ROWS = {0: (6, 9), 1: (0, 9), 2: (3, 9), 3: (0, 0), 4: (0, 0)}   # j1_rows
J2_ROWS = {0: (6, 9), 1: (0, 3), 2: (3, 6), 3: (0, 9), 4: (3, 9)}   # j2_rows


def _jp_rows(j):
    return (3, 6) if j < 3 else ((0, 3) if j < 6 else (j, j + 1))


def _sparse_tn(J, rows, B):
    """J^T B over J's non-zero rows of each column's block (the kernel's
    ranges): the skipped rows must hold zeros."""
    out = np.zeros((J.shape[1], B.shape[1]))
    for i in range(J.shape[1]):
        lo, hi = rows(i)
        assert not np.any(np.delete(J[:, i], np.arange(lo, hi))), i
        out[i] = J[lo:hi, i] @ B[lo:hi]
    return out


def _assemble(nf, m, pp, info, Hw, vis, ibg, iba):
    """The whole-block assembly: H (upper triangles mirrored), g, cost."""
    J1, J2, Jp = _jacobians(m, pp)
    r1 = lambda i: J1_ROWS[i // 3]
    r2 = lambda i: J2_ROWS[i // 3]
    IJ1 = info @ J1
    IJ2 = info @ J2
    Ir = info @ m["r"]
    walk = np.concatenate([np.zeros(9), np.full(3, ibg), np.full(3, iba)])
    H22 = np.triu(_sparse_tn(J2, r2, IJ2)) + np.diag(walk)
    for i, (j, k) in enumerate(H_IDX):
        H22[j, k] += vis[i]
    H22 = np.triu(H22) + np.triu(H22, 1).T
    g2 = _sparse_tn(J2, r2, Ir[:, None])[:, 0] + walk * np.concatenate([np.zeros(9), m["rw"]])
    g2[:6] += vis[21:27]
    cost = vis[27] + m["r"] @ Ir + ibg * m["rw"][:3] @ m["rw"][:3] + iba * m["rw"][3:] @ m["rw"][3:]
    if nf == 15:
        return H22, g2, cost
    Hr = Hw @ pp["rp"]
    PH = _sparse_tn(Jp, _jp_rows, Hw)
    H11 = np.triu(_sparse_tn(J1, r1, IJ1) + _sparse_tn(Jp, _jp_rows, PH.T).T)
    H11 = H11 + np.triu(H11, 1).T
    H12 = _sparse_tn(J1, r1, IJ2)
    g1 = _sparse_tn(J1, r1, Ir[:, None])[:, 0] + _sparse_tn(Jp, _jp_rows, Hr[:, None])[:, 0]
    H = np.block([[H11, H12], [H12.T, H22]])
    return H, np.concatenate([g1, g2]), cost + pp["rp"] @ Hr


def factor_right_looking(A):
    """factor(): the trailing update a_ij -= a_ic (a_jc / a_cc), then the
    pivots' inverses and the columns scaled; returns (L strictly lower,
    1 / L_cc)."""
    A = np.tril(A).copy()
    N = A.shape[0]
    for c in range(N - 1):
        inv = 1.0 / A[c, c]
        for i in range(c + 1, N):
            A[i, c + 1:i + 1] -= A[i, c] * (A[c + 1:i + 1, c] * inv)
    linv = 1.0 / np.sqrt(np.diag(A))
    return np.tril(A, -1) * linv[None, :], linv


def solve_by_inverse_pivots(L, linv, b):
    """chol_solve(): the two triangular solves, multiplying by 1 / L_cc."""
    y = b.copy()
    for c in range(len(b)):
        y[c] *= linv[c]
        y[c + 1:] -= L[c + 1:, c] * y[c]
    for c in range(len(b) - 1, -1, -1):
        y[c] *= linv[c]
        y[:c] -= L[c, :c] * y[c]
    return y


def pose_inertial_block(nf, args):
    """csrc/pose_inertial.cu's LM in float64 from the float32 arguments."""
    a64 = chip_smoke._vi_cast(torch, args, torch.float64)
    if nf == 15:
        cam, T_cb, s0, anchor, pre, grav, X, uvr, s2, st, va, ibg, iba = a64
        prior = None
    else:
        cam, T_cb, s0, anchor, prior, pre, grav, X, uvr, s2, st, va, ibg, iba = a64
    info = np.linalg.inv(n(pre.C[:9, :9]).astype(F64) + 1e-10 * np.eye(9))
    Hw = None if prior is None else n(prior.H).astype(F64) * float(prior.weight)
    ibg, iba, D = float(ibg), float(iba), tpi.D

    def evaluate(sp, sc, gate):
        vis, inl = _row_sums(cam, T_cb, sc.T_wb, X, uvr, s2, st, va, gate)
        pp = None if prior is None else _prior_pre(prior, sp)
        H, g, cost = _assemble(nf, _imu_pre(pre, grav, sp, sc), pp, info, Hw, vis, ibg, iba)
        return H, g, cost, inl

    sp, sc = anchor, s0
    for rnd in range(2):
        gate = rnd > 0
        lam = 1e-2
        H, g, cost, _ = evaluate(sp, sc, gate)
        for _ in range(6):
            ha = np.diag(H) + lam * np.diag(H) + 1e-6
            dinv = 1.0 / np.sqrt(np.maximum(np.abs(ha), 1e-12))
            A = H + np.diag(lam * np.diag(H) + 1e-6)
            L, linv = factor_right_looking(A * dinv[:, None] * dinv[None, :])
            dx = torch.as_tensor(-(solve_by_inverse_pivots(L, linv, g * dinv) * dinv))
            sp_n = tpi._apply(sp, dx[:D]) if nf == 30 else sp
            sc_n = tpi._apply(sc, dx[nf - D:])
            Hn, gn, cn, _ = evaluate(sp_n, sc_n, gate)
            if cn < cost:
                sp, sc, H, g, cost, lam = sp_n, sc_n, Hn, gn, cn, lam * 0.5
            else:
                lam *= 4.0
    H, _, cost, inl = evaluate(sp, sc, True)
    if nf == 30:
        L, linv = factor_right_looking(H[:D, :D] + 1e-6 * np.eye(D))
        Xs = np.stack([solve_by_inverse_pivots(L, linv, H[:D, D + j]) for j in range(D)], 1)
        Hm = np.triu(H[D:, D:] - H[:D, D:].T @ Xs)
        H = Hm + np.triu(Hm, 1).T
    f32 = lambda x: x.float() if isinstance(x, torch.Tensor) else torch.as_tensor(x).float()
    s = tpi.FrameVIState(*(f32(x) for x in sc))
    inl_t = torch.as_tensor(inl)
    return tpi.PoseInertialResult(s, tpi.FramePrior(s, f32(H), torch.ones(())),
                                  inl_t.sum(dtype=torch.int32), inl_t, f32(cost))


def test_factor_right_looking_is_the_cholesky_factor():
    rng = np.random.default_rng(3)
    for N in (15, 30):
        B = rng.normal(size=(N, N))
        A = B @ B.T + N * np.eye(N)
        L, linv = factor_right_looking(A)
        Lf = L + np.diag(1.0 / linv)
        assert np.allclose(Lf, np.linalg.cholesky(A), rtol=1e-12, atol=1e-12)
        b = rng.normal(size=N)
        assert np.allclose(solve_by_inverse_pivots(L, linv, b), np.linalg.solve(A, b),
                           rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("nf,case", [(15, "full"), (30, "full"), (15, "padded_imu"),
                                     (30, "padded_imu"), (15, "nothing_valid"),
                                     (30, "nothing_valid")])
def test_pose_inertial_block_order_matches_jax(nf, case):
    """The whole-block assembly and step against optimize_last_kf /
    optimize_last_frame of the JAX package, under chip_smoke.VI_TOL. (Not
    ``prior_off``: with no prior the marginal's velocity block is ~1e-6, the
    difference of ~1e6 terms, which the JAX package's float32 resolves only
    to ~3e-5; the card tests hold that case against the float64 plain
    version.)"""
    _, args = vi_case(nf, case)
    assert_close(pose_inertial_block(nf, args), run_jax(nf, args), args)
