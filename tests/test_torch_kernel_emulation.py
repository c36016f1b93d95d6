"""The arithmetic orders of ``csrc/local_ba.cu`` and ``csrc/pose_lm.cu``,
emulated in numpy on the CPU and held against the JAX package.

The kernels cannot run here; what they do differently from their plain
versions is the order of their sums and the shape of their solves. So:

- the pair table (``ops/kernels/local_ba.pair_table``, the wrapper's own
  function on CPU tensors) and the reduction's order (a warp a chunk of
  ``CHUNK`` pairs or more, a lane every 32nd pair, the lanes added by a
  shuffle tree, the chunk rows in chunk order) give the reduced camera system S, g of the
  free poses, against the system rebuilt in float64 from the JAX
  ``_assemble_visual`` outputs as ``tc2li_slam_tpu/solver/lm.py:241-290``
  forms it, on ``chip_smoke.ba_problem``'s six cases;
- the solve over the free poses only (compacted; Gauss-Jordan elimination
  with the first-largest pivot, in one block up to 48 rows and on the
  cluster beyond) against ``lm.precond_solve`` on the full system in float64;
- the costs the window BA's accept test compares, evaluated in float64
  from the float32 state, against the plain version run in float64;
- the pose-only LM with the kernel's order of sums (rows in eight shares,
  one a block of the cluster, strided over its 512 threads, a warp
  reduce-scatter, the warps then the blocks in order) and its warp's 6x6
  step, in float32, against ``pose_only_optimize`` on
  ``chip_smoke.pose_problem``'s five cases.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from tc2li_slam_tpu.geom import camera as jcam
from tc2li_slam_tpu.solver import lm as jlmo
from tc2li_slam_torch.geom import camera as tcam, lie as tlie
from tc2li_slam_torch.ops.kernels import local_ba as klba
from tc2li_slam_torch.solver import factors as tfac
from torch_parity import t

F32, F64 = np.float32, np.float64
LAM = 1e-4          # the first iteration's damping
SHARED_ROWS = 48    # free rows up to which the kernel's block 0 solves alone


# ---------------------------------------------------------------------------
# the window BA: per-observation terms, the pair table, the reduction
# ---------------------------------------------------------------------------

def _ba_case(case):
    p = chip_smoke.ba_problem(np.random.default_rng(3), case)
    cam = jcam.Pinhole.create(*chip_smoke.BA_CAM[:4], bf=chip_smoke.BA_CAM[4],
                              width=chip_smoke.BA_CAM[5], height=chip_smoke.BA_CAM[6])
    obs = jlmo.BAObservations(*(jnp.asarray(p[k]) for k in (
        "pose_idx", "uv", "inv_sigma2", "stereo", "valid")))
    rr, w, _, _ = jlmo._assemble_visual(cam, jnp.asarray(p["T0"]), jnp.asarray(p["X0"]), obs,
                                        False)
    L, K = p["pose_idx"].shape
    arr = lambda x, *s: np.asarray(x, F32).reshape(L, K, *s)
    return p, arr(rr.J_pose, 3, 6), arr(rr.J_lm, 3, 3), arr(rr.r, 3), arr(w)


def _kernel_terms(J, Jl, r, w, vlm, lam=LAM):
    """What build_kernel keeps and writes: float32 per observation, float64
    sums, the damped 3x3 inverse, W = B Hll^-1 and gp - W gl, each selected
    to 0 where w == 0."""
    Jp = J * w[..., None, None]                                   # float32
    live = ~(w == 0)
    Hd = np.where(live[..., None, None], np.einsum("lkij,lkic->lkjc", Jp, J), F32(0))
    gp = np.einsum("lkij,lki->lkj", Jp, r).astype(F64)
    B = np.einsum("lkij,lkim->lkjm", Jp, Jl)                      # float32 [L, K, 6, 3]
    Jlw = Jl * w[..., None, None]
    Hll = np.einsum("lkij,lkim->lkjm", Jlw, Jl).astype(F64).sum(1)
    gl = np.einsum("lkij,lki->lkj", Jlw, r).astype(F64).sum(1)
    A = Hll + (lam * np.einsum("lii->li", Hll)[:, :, None] * np.eye(3) + 1e-6 * np.eye(3))
    det = np.linalg.det(A)
    Hi = np.linalg.inv(np.where(np.abs(det) > 1e-20, 1.0, np.nan)[:, None, None] * A)
    Hi = np.where(np.isnan(Hi), 0.0, Hi) * vlm[:, None, None]
    W = np.where((live & vlm[:, None])[..., None, None],
                 np.einsum("lkjm,lmn->lkjn", B.astype(F64), Hi), 0.0)
    gd = np.where(live[..., None], gp - np.einsum("lkjn,ln->lkj", W, gl), 0.0)
    return live, Hd, B, W, gd


def _reduce_table(tb, live, Hd, B, W, gd):
    """reduce_kernel in numpy: each chunk's 42 sums (S block, then g): lane l
    adds the chunk's pairs l, l + 32, ... in order (minus W B^T where the
    second observation's weight is not 0, then Hpp and g on a diagonal
    pair); the lanes are added by the kernel's shuffle tree."""
    K = live.shape[1]
    LK = live.size
    live, Hd, B, W, gd = (a.reshape(LK, *a.shape[2:]) for a in (live, Hd, B, W, gd))
    order = tb.order.numpy()
    o1, o2 = order // K, (order // (K * K)) * K + order % K
    start, cstart = tb.start.numpy(), tb.cstart.numpy()
    part = np.zeros((int(cstart[-1]), 42))
    idx = np.arange(32)
    for b in range(len(start) - 1):
        cnt = start[b + 1] - start[b]
        length = max(klba.CHUNK, -(-cnt // klba.MAX_CHUNKS))
        for j, ch in enumerate(range(cstart[b], cstart[b + 1])):
            e0 = start[b] + j * length
            e1 = min(e0 + length, start[b + 1])
            lanes = np.zeros((32, 42))
            for e in range(e0, e1):
                acc, a, c = lanes[(e - e0) % 32], o1[e], o2[e]
                if live[c]:
                    acc[:36] -= np.einsum("rm,cm->rc", W[a], B[c].astype(F64)).reshape(36)
                if a == c:
                    acc[:36] += Hd[a].reshape(36).astype(F64)
                    acc[36:] += gd[a]
            for o in (16, 8, 4, 2, 1):
                lanes = lanes + lanes[idx ^ o]
            part[ch] = lanes[0]
    return part


def _assemble(part, tb, fixed):
    """The solve's view: S and g of the free poses from the chunk sums,
    added in chunk order (free poses in pose order)."""
    P = fixed.shape[0]
    cstart = tb.cstart.numpy()
    fpose = np.flatnonzero(~fixed)
    Df = 6 * len(fpose)
    S, g = np.zeros((Df, Df)), np.zeros(Df)

    def blk(p1, p2):
        b = p1 * P - p1 * (p1 - 1) // 2 + (p2 - p1)
        s = np.zeros(42)
        for ch in range(cstart[b], cstart[b + 1]):
            s = s + part[ch]
        return s

    for i, pa in enumerate(fpose):
        for j, pb in enumerate(fpose):
            if pa <= pb:
                S[6 * i:6 * i + 6, 6 * j:6 * j + 6] = blk(pa, pb)[:36].reshape(6, 6)
            else:
                S[6 * i:6 * i + 6, 6 * j:6 * j + 6] = blk(pb, pa)[:36].reshape(6, 6).T
        g[6 * i:6 * i + 6] = blk(pa, pa)[36:]
    return S, g


def _reference_system(p, J, Jl, r, w):
    """S [P, 6, P, 6] -> [6P, 6P] and g [6P], as lm.py:241-290 forms them
    (before the fixed-pose masking), in float64 from the float32 terms."""
    L, K = w.shape
    P = p["T0"].shape[0]
    J, Jl, r, w = (a.astype(F64) for a in (J, Jl, r, w))
    oh = (np.clip(p["pose_idx"], 0, P - 1)[..., None] == np.arange(P)).astype(F64)
    Jp = J * w[..., None, None]
    Hpp = np.einsum("lkp,lkij,lkic->pjc", oh, Jp, J)
    gp = np.einsum("lkp,lkij,lki->pj", oh, Jp, r)
    Jlw = Jl * w[..., None, None]
    Hll = np.einsum("lkij,lkim->ljm", Jlw, Jl)
    gl = np.einsum("lkij,lki->lj", Jlw, r)
    B = np.einsum("lkij,lkim->lkjm", Jp, Jl)
    Hll_d = Hll + LAM * np.einsum("lii->li", Hll)[:, :, None] * np.eye(3) + 1e-6 * np.eye(3)
    Hi = np.linalg.inv(Hll_d) * p["valid_lm"][:, None, None]
    U = np.einsum("lkp,lkim,lmn->lpin", oh, B, Hi)
    V = np.einsum("lkp,lkjm->lpjm", oh, B)
    S = -np.einsum("lpim,lqjm->piqj", U, V)
    for q in range(P):
        S[q, :, q, :] += Hpp[q]
    g = gp - np.einsum("lpim,lm->pi", U, gl)
    return S.reshape(6 * P, 6 * P), g.reshape(-1)


@pytest.mark.parametrize("case", chip_smoke.BA_CASES)
def test_pair_table_sums_match_reference(case):
    p, J, Jl, r, w = _ba_case(case)
    fixed = p["fixed"]
    tb = klba.pair_table(t(p["pose_idx"]), t(p["valid"]), t(p["valid_lm"]), t(fixed))
    L, K = w.shape
    assert int(tb.cstart[-1]) <= tb.n_chunks
    if case == "masked_nan":
        # the masked rows' weights are NaN (0 * NaN) and enter the plain
        # system, making it NaN; no step is taken there (the entry cost is
        # NaN). The table leaves masked rows out: held to the system without them.
        S_nan, _ = _reference_system(p, J, Jl, r, w)
        assert np.isnan(S_nan).any()
        w = np.where(p["valid"], w, F32(0))
        J, Jl, r = (np.where(p["valid"].reshape(L, K, *[1] * (a.ndim - 2)), a, F32(0))
                    for a in (J, Jl, r))
    terms = _kernel_terms(J, Jl, r, w, p["valid_lm"])
    part = _reduce_table(tb, *terms)
    S, g = _assemble(part, tb, fixed)
    S_ref, g_ref = _reference_system(p, J, Jl, r, w)
    free6 = np.repeat(~fixed, 6)
    S_ref, g_ref = S_ref[free6][:, free6], g_ref[free6]
    assert S.shape == S_ref.shape and np.isfinite(S).all()
    if S.size:
        np.testing.assert_allclose(S, S_ref, rtol=1e-5, atol=1e-5 * np.abs(S_ref).max())
        np.testing.assert_allclose(g, g_ref, rtol=1e-5, atol=1e-5 * np.abs(g_ref).max())


# ---------------------------------------------------------------------------
# the solve over the free poses
# ---------------------------------------------------------------------------

def _damped(S, g, lam=LAM):
    """The kernel's entries: a + lam a + 1e-8 on the diagonal."""
    M = S.copy()
    d = np.diag(M)
    M[np.diag_indices_from(M)] = (d + lam * d) + 1e-8
    return M, g


def _first_largest(col):
    """The pivot rule: the first largest |a| (a NaN never wins, a NaN first
    entry keeps its row)."""
    best, bi = -1.0, 0
    a0 = abs(col[0])
    if a0 != a0:
        return 0
    best = a0
    for i in range(1, len(col)):
        if abs(col[i]) > best:
            best, bi = abs(col[i]), i
    return bi


def _kernel_solve(M, g):
    """solve_kernel: Jacobi scaling, Gauss-Jordan elimination with the
    first-largest pivot (rows swapped here; the kernel keeps the permutation,
    the same choice), x = b / diag; returns x / dsc (the step before its
    sign)."""
    D = M.shape[0]
    dsc = np.sqrt(np.maximum(np.abs(np.diag(M)), 1e-12))
    A = np.concatenate([M / (dsc[:, None] * dsc[None, :]), (g / dsc)[:, None]], 1)
    for c in range(D):
        piv = c + _first_largest(A[c:, c])
        A[[c, piv]] = A[[piv, c]]
        inv = 1.0 / A[c, c]
        for r in range(D):
            if r != c:
                A[r, c + 1:] -= (A[r, c] * inv) * A[c, c + 1:]
    return A[:, D] / np.diag(A[:, :D]) / dsc


def _full_plain(S_full, g_full, fixed, lam=LAM):
    """The plain version's full system: fixed rows and columns 0 but a unit
    diagonal, then lam diag + 1e-8 I (lm.py:273-276)."""
    free6 = np.repeat(~fixed, 6).astype(F64)
    Sd = S_full * free6[:, None] * free6[None, :] + np.diag(1.0 - free6)
    Sd = Sd + lam * np.diag(np.diag(Sd)) + 1e-8 * np.eye(len(free6))
    return Sd, g_full * free6


@pytest.mark.parametrize("case,fixed_at", [("global_p64", None), ("visual", (3,)),
                                           ("twelve_poses", (0,))])
def test_free_pose_solve_matches_precond_solve(case, fixed_at):
    """``global_p64``: 7 free poses of 64 (42 rows, block 0 alone); a 6-pose
    window with its fixed pose in the middle; a 12-pose window with one fixed
    (66 rows: the cluster's Gauss-Jordan)."""
    if case == "twelve_poses":
        cam, p = chip_smoke.dist_problem(torch, np.random.default_rng(2), Pn=12, L=600, K=6)
        p["valid_lm"] = np.ones(600, bool)
        jc = jcam.Pinhole.create(cam.fx, cam.fy, cam.cx, cam.cy, bf=cam.bf)
        obs = jlmo.BAObservations(*(jnp.asarray(p[k]) for k in (
            "pose_idx", "uv", "inv_sigma2", "stereo", "valid")))
        rr, w, _, _ = jlmo._assemble_visual(jc, jnp.asarray(p["T0"]), jnp.asarray(p["X0"]),
                                            obs, False)
        L, K = p["pose_idx"].shape
        arr = lambda x, *s: np.asarray(x, F32).reshape(L, K, *s)
        J, Jl, r, w = arr(rr.J_pose, 3, 6), arr(rr.J_lm, 3, 3), arr(rr.r, 3), arr(w)
    else:
        p, J, Jl, r, w = _ba_case(case)
    P = p["T0"].shape[0]
    fixed = p["fixed"].copy()
    if fixed_at is not None:
        fixed[:] = False
        fixed[list(fixed_at)] = True
    S_full, g_full = _reference_system(p, J, Jl, r, w)
    free6 = np.repeat(~fixed, 6)
    assert (free6.sum() > SHARED_ROWS) == (case == "twelve_poses")
    x = _kernel_solve(*_damped(S_full[free6][:, free6], g_full[free6]))
    with jax.enable_x64(True):
        ref = np.asarray(jlmo.precond_solve(*map(jnp.asarray, _full_plain(S_full, g_full, fixed))))
    assert ref.dtype == F64 and np.all(ref[~free6] == 0.0)
    np.testing.assert_allclose(x, ref[free6], rtol=0, atol=1e-9 * np.abs(ref).max())
    assert P == (64 if case == "global_p64" else 12 if case == "twelve_poses" else 6)


# ---------------------------------------------------------------------------
# the window BA's costs: float64 from the float32 state
# ---------------------------------------------------------------------------

def _kernel_cost(p, cam):
    """The visual cost as ``landmark_cost`` evaluates it: each observation
    in float64 from the float32 poses, landmarks and observations (the
    Huber weight and the depth gate included), the landmark's observations
    in order, then the landmarks (the kernel adds blocks of 128 in order)."""
    T = p["T0"].astype(F64)[np.clip(p["pose_idx"], 0, p["T0"].shape[0] - 1)]   # [L, K, 4, 4]
    X = p["X0"].astype(F64)
    xc = np.einsum("lkij,lj->lki", T[..., :3, :3], X) + T[..., :3, 3]
    z = np.where(np.abs(xc[..., 2]) < 1e-9, 1e-9, xc[..., 2])
    u = F64(cam.fx) * xc[..., 0] / z + F64(cam.cx)
    v = F64(cam.fy) * xc[..., 1] / z + F64(cam.cy)
    uv = p["uv"].astype(F64)
    st = p["stereo"]
    r2 = np.where(st, (u - F64(cam.bf) / z) - uv[..., 2], 0.0)
    rr = (u - uv[..., 0]) ** 2 + (v - uv[..., 1]) ** 2 + r2 ** 2
    is2 = p["inv_sigma2"].astype(F64)
    chi2 = is2 * rr
    thr = np.where(st, F64(F32(tfac.CHI2_STEREO)), F64(F32(tfac.CHI2_MONO)))
    hub = np.where(chi2 <= thr, 1.0, np.sqrt(thr / np.maximum(chi2, 1e-12)))
    active = p["valid"] & (xc[..., 2] > 0.05)
    per_lm = (is2 * hub * active * rr).sum(axis=1)
    blocks = [per_lm[b:b + 128].sum() for b in range(0, per_lm.size, 128)]
    return float(np.sum(blocks))


@pytest.mark.parametrize("case", chip_smoke.BA_CASES)
def test_cost_in_float64_matches_reference(case):
    """The kernel's costs (the entry's, each candidate's) are evaluated in
    float64: the emulation equals the plain version's visual cost run in
    float64 (``lm.local_ba``'s ``total_cost``, no step taken) to 1e-12
    relative, where a float32 evaluation is ~1e-6 relative off, the size of
    the cost changes that decide the last iterations on a BALM window
    (NaN where a masked landmark is NaN, in all three)."""
    p = chip_smoke.ba_problem(np.random.default_rng(3), case)
    cam = tcam.Pinhole.create(*chip_smoke.BA_CAM[:4], bf=chip_smoke.BA_CAM[4],
                              width=chip_smoke.BA_CAM[5], height=chip_smoke.BA_CAM[6])
    a, _ = chip_smoke.ba_torch(torch, {k: v for k, v in p.items() if k != "points"}, "cpu")
    a64, _ = chip_smoke.ba_float64(torch, a, {})
    ref64 = float(klba.local_ba_plain(*a64, iters=0).cost)
    ref32 = float(klba.local_ba_plain(*a, iters=0).cost)
    got = _kernel_cost(p, cam)
    if case == "masked_nan":
        assert np.isnan(got) and np.isnan(ref64) and np.isnan(ref32)
        return
    assert abs(got - ref64) <= 1e-12 * abs(ref64), (got, ref64)
    assert abs(ref32 - ref64) > 1e-9 * abs(ref64)


# ---------------------------------------------------------------------------
# the pose-only LM: the kernel's order of sums and its warp step, in float32
# ---------------------------------------------------------------------------

BLOCKS, THREADS, WARPS = 8, 512, 16   # csrc/pose_lm.cu's cluster
H_IDX = [(j, k) for j in range(6) for k in range(j, 6)]


def _reduce_scatter(v):
    """[warps, 32 lanes, 32 values] -> [warps, 32]: lane k's sum of value k,
    by the kernel's butterfly (keep + the partner's half)."""
    lanes = np.arange(32)
    for o in (16, 8, 4, 2, 1):
        up = (lanes & o) != 0
        idx = np.arange(o)[None, :] + o * up[:, None]               # [32, o]
        keep = np.take_along_axis(v, idx[None], axis=2)
        recv = np.take_along_axis(v[:, lanes ^ o], idx[None], axis=2)
        v = keep + recv
    return v[:, :, 0]


def _pass(cam, T, X, uv, s2, st, act):
    """One pass: the 28 sums (H upper, g, cost) in the kernel's order."""
    rr = tfac.reproj_residuals(cam, t(T).expand(X.shape[0], 4, 4), t(X), t(uv), t(s2), t(st))
    r, J = rr.r.numpy(), rr.J_pose.numpy()
    thr = np.where(st, F32(7.815), F32(5.991))
    chi2 = rr.chi2.numpy()
    depth_ok = rr.depth_ok.numpy()
    hub = np.where(chi2 <= thr, F32(1), np.sqrt(thr / np.maximum(chi2, F32(1e-12))))
    w = (s2 * hub * act.astype(F32) * depth_ok.astype(F32)).astype(F32)
    Jw = J * w[:, None, None]
    rowsum = np.zeros((X.shape[0], 32), F32)
    for i, (j, k) in enumerate(H_IDX):
        rowsum[:, i] = np.einsum("oi,oi->o", Jw[:, :, j], J[:, :, k])
    rowsum[:, 21:27] = np.einsum("oij,oi->oj", Jw, r)
    rowsum[:, 27] = w * np.einsum("oi,oi->o", r, r)
    n = X.shape[0]
    per = -(-n // BLOCKS)
    s = np.zeros(32, F32)
    for q in range(BLOCKS):   # block q: rows [q per, q per + per), in block order
        rows = rowsum[min(q * per, n):min(q * per + per, n)]
        acc = np.zeros((THREADS, 32), F32)
        for base in range(0, len(rows), THREADS):   # thread t: rows t, t + 512, ...
            m = min(THREADS, len(rows) - base)
            acc[:m] += rows[base:base + m]
        per_warp = _reduce_scatter(acc.reshape(WARPS, 32, 32))
        sq = np.zeros(32, F32)
        for wp in range(WARPS):
            sq = sq + per_warp[wp]
        s = s + sq
    return s, chi2, depth_ok, thr


def _warp_step(s, lam, T):
    """lm_step: [A | b] from the sums, the damped diagonal, elimination with
    the first-largest pivot, back-substitution, se3_exp(-x) T."""
    A = np.zeros((6, 6), F32)
    for i, (j, k) in enumerate(H_IDX):
        A[j, k] = A[k, j] = s[i]
    b = s[21:27].copy()
    for j in range(6):
        A[j, j] = A[j, j] + F32(lam) * A[j, j] + F32(1e-8)
    for c in range(6):
        p = c + _first_largest(A[c:, c])
        A[[c, p]], b[[c, p]] = A[[p, c]], b[[p, c]]
        inv = F32(1) / A[c, c]
        for r in range(c + 1, 6):
            lr = A[r, c] * inv
            A[r, c + 1:] -= lr * A[c, c + 1:]
            b[r] -= lr * b[c]
    x = np.zeros(6, F32)
    for r in range(5, -1, -1):
        acc = b[r]
        for k in range(r + 1, 6):
            acc = acc - A[r, k] * x[k]
        x[r] = acc / A[r, r]
    return (tlie.se3_exp(t(-x)) @ t(T)).numpy()


def _pose_lm_emulated(cam, T0, X, uv, s2, st, valid, rounds, iters):
    T = T0.astype(F32)
    s, _, _, _ = _pass(cam, T, X, uv, s2, st, valid)
    act, cost = valid.copy(), F32(0)
    for _ in range(rounds):
        cur, lam = s, F32(1e-3)
        for _ in range(iters):
            Tn = _warp_step(cur, lam, T)
            s, _, _, _ = _pass(cam, Tn, X, uv, s2, st, act)
            if s[27] < cur[27]:
                T, cur, lam = Tn, s, lam * F32(0.5)
            else:
                lam = lam * F32(4)
        cost = cur[27]
        s, chi2, depth_ok, thr = _pass(cam, T, X, uv, s2, st, valid)
        act = valid & (chi2 <= thr) & depth_ok
        s, _, _, _ = _pass(cam, T, X, uv, s2, st, act)
    return T, act, cost


@pytest.mark.parametrize("case", chip_smoke.POSE_CASES)
def test_pose_lm_order_matches_reference(case):
    cam_args, args, kw = chip_smoke.pose_problem(np.random.default_rng(7), 2000, case)
    rj = jlmo.pose_only_optimize(jcam.Pinhole.create(*cam_args), *map(jnp.asarray, args), **kw)
    with np.errstate(invalid="ignore", over="ignore"):
        T, act, cost = _pose_lm_emulated(tcam.Pinhole.create(*cam_args), *args, **kw)
    np.testing.assert_allclose(T, np.asarray(rj.T_cw), atol=1e-4)
    if case == "masked_nan":
        assert np.isnan(cost) and np.isnan(float(rj.cost)) and np.array_equal(T, args[0])
    else:
        np.testing.assert_allclose(cost, float(rj.cost), rtol=1e-3)
        assert abs(int(act.sum()) - int(rj.n_inliers)) <= 2
