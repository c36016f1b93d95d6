"""The LVI-BA's kernel sequence (``csrc/lvi_ba.cu``, ``ops/kernels/lvi_ba.py``)
on the CPU: the dispatch by device, and the kernel's arithmetic order
emulated in float64 torch against the plain version run in float64 and the
JAX ``lvi_ba`` (x64).

The kernels cannot run here; what they do differently from the plain
version is the shape of their sums and solve. The emulation (``_emulate``)
repeats them: the visual terms a landmark as ``build_kernel`` keeps them
(W = B Hll^-1 and gp - W gl, selected to 0 where w = 0), summed into the
6x6 visual blocks over ``local_ba.pair_table``'s pairs; each IMU factor's
three 15x15 blocks and two gradients on their own (J1 with the bias
columns, J2 without, info = C^-1 valid, the random walks folded in); the
reduced system over the free states only, each entry the IMU blocks, then
the visual block, then the BALM block, and only then ``lam |a| + 1e-8`` on
the diagonal; the Jacobi-scaled Gauss-Jordan elimination with the
first-largest pivot; the candidate ``T exp(dx)``, ``dl``, the costs in
float64 and the accept test. Cases (``chip_smoke.lvi_problem`` at P 6,
300 landmarks, K 4): no BALM, BALM over 4 poses, a padded window, a
non-finite landmark (the entry state comes back). Against the JAX package
the emulation is held to ``assert_lvi_close``'s tolerances; its check
against the ground truth (5e-3 on ``simulate_window``'s exact measurements)
does not fit these windows, whose optimum lies ~1-2 cm from the truth (3%
outliers under the Huber kernel, 300 landmarks seen 4 times; the plain
version in float64 run to 20 iterations stays there), so the poses are held
to 3e-2 of the truth, from ~7e-2 at the entry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from test_torch_inertial import assert_lvi_close
from test_torch_kernel_emulation import _first_largest
from tc2li_slam_tpu.geom import camera as jcam
from tc2li_slam_tpu.solver import balm as jbalm, inertial_ba as jiba, lm as jlm
from tc2li_slam_torch.geom import camera as tcam, lie as tlie
from tc2li_slam_torch.ops.kernels import local_ba as klba, lvi_ba as klvi
from tc2li_slam_torch.solver import balm as tbalm, factors, inertial_ba as tiba, lm as tlm
from tc2li_slam_torch.tensors import matvec

F64 = torch.float64
CASES = ("no_balm", "balm", "padded", "non-finite")
D = 15


def _case(case, with_jax=True):
    """(numpy problem, the port's float64 CPU arguments (a, kw), the JAX
    arguments (a, kw), float64 where x64 is on): the BALM clusters built by
    the JAX package at the initial LiDAR poses and handed to both (without
    ``with_jax``: the port's own, and no JAX arguments)."""
    kind = {"no_balm": "4e-like", "balm": "4e-like"}.get(case, case)
    p = chip_smoke.lvi_problem(np.random.default_rng(5), kind, L=300, K=4)
    if case == "no_balm":
        p["n_lidar"] = 0
    a, kw = chip_smoke.lvi_args(torch, p, "cpu", dtype=F64)
    if not with_jax:
        return p, a, kw, None, None
    cam = p["cam"]
    jc = jcam.Pinhole.create(cam[0], cam[1], cam[2], cam[3], bf=cam[4])
    J = lambda x: jnp.asarray(np.asarray(x, np.float64) if np.asarray(x).dtype.kind == "f" else x)
    ja = (jc, J(p["T_cb"]), jiba.InertialState(*(J(p[k]) for k in ("T_wb", "vel", "bg", "ba"))),
          J(p["X0"]), jlm.BAObservations(*(J(p[k]) for k in ("pose_idx", "uv", "inv_sigma2",
                                                              "stereo", "valid"))),
          jiba.ImuWindowFactors(*(J(p["fac"][k]) for k in jiba.ImuWindowFactors._fields)),
          J(p["fixed"]), J(p["valid_lm"]), J(p["gravity"]))
    jkw = dict(iters=p["iters"])
    if p["n_lidar"]:
        n = p["n_lidar"]
        T_wl0 = (p["T_wb"][:n].astype(np.float64) @ p["T_bl"].astype(np.float64)).astype(np.float32)
        cj = jbalm.build_clusters(jnp.asarray(p["points"]), jnp.asarray(p["pvalid"]),
                                  jnp.asarray(T_wl0), max_voxels=512)
        kw["balm_clusters"] = tbalm.VoxelClusters(*(torch.as_tensor(np.asarray(x)).to(
            F64 if np.asarray(x).dtype.kind == "f" else None) for x in cj))
        jkw.update(balm_clusters=jbalm.VoxelClusters(*(J(x) for x in cj)), T_bl=J(p["T_bl"]),
                   w_lidar=0.01, use_balm=True, n_lidar=n)
    return p, a, kw, ja, jkw


# ---------------------------------------------------------------------------
# the kernel's order in float64
# ---------------------------------------------------------------------------

def _factor_blocks(s, fac, gravity):
    """Each factor's blocks as a factor block of ``init_kernel`` /
    ``eval_kernel`` writes them: H [F, 3, 15, 15] ((i, i), (i, i + 1),
    (i + 1, i + 1)), g [F, 2, 15], cost [F]."""
    F = s.T_wb.shape[0] - 1
    if F == 0:
        z = torch.zeros
        return z((0, 3, D, D), dtype=F64), z((0, 2, D), dtype=F64), z(0, dtype=F64)
    R, p = tlie.rotation(s.T_wb), tlie.translation(s.T_wb)
    bg, ba = s.bg[:-1], s.ba[:-1]          # the residual corrected at state i's biases
    dbg, dba = bg - fac.bg_lin, ba - fac.ba_lin
    dR_c = fac.dR @ tlie.so3_exp(matvec(fac.JRg, dbg))
    dV_c = fac.dV + matvec(fac.JVg, dbg) + matvec(fac.JVa, dba)
    dP_c = fac.dP + matvec(fac.JPg, dbg) + matvec(fac.JPa, dba)
    o = factors.imu_residual(R[:-1], p[:-1], s.vel[:-1], R[1:], p[1:], s.vel[1:], bg, ba, dR_c,
                             dV_c, dP_c, fac.JRg, fac.JVg, fac.JVa, fac.JPg, fac.JPa, fac.dt,
                             fac.C_inv, gravity)
    J1 = torch.cat([tiba.reorder_pose(o.J1_pose), o.J1_vel, o.J_bg, o.J_ba], -1)   # bias columns
    J2 = torch.cat([tiba.reorder_pose(o.J2_pose), o.J2_vel, torch.zeros_like(o.J_bg),
                    torch.zeros_like(o.J_bg)], -1)
    w = fac.valid.to(F64)
    info = fac.C_inv * w[:, None, None]
    IJ1, IJ2 = info @ J1, info @ J2
    rb = torch.cat([s.bg[1:] - s.bg[:-1], s.ba[1:] - s.ba[:-1]], -1)
    wg, wa = fac.info_bg * w, fac.info_ba * w
    Hrw = torch.diag_embed(torch.cat([torch.zeros(F, 9, dtype=F64), wg[:, None].expand(F, 3),
                                      wa[:, None].expand(F, 3)], -1))
    grw = torch.cat([torch.zeros(F, 9, dtype=F64), wg[:, None] * rb[:, :3], wa[:, None] * rb[:, 3:]],
                    -1)
    T_ = lambda x: x.transpose(-1, -2)
    H = torch.stack([T_(J1) @ IJ1 + Hrw, T_(J1) @ IJ2 - Hrw, T_(J2) @ IJ2 + Hrw], 1)
    g = torch.stack([matvec(T_(IJ1), o.r) - grw, matvec(T_(IJ2), o.r) + grw], 1)
    c = ((o.r * matvec(info, o.r)).sum(-1) + wg * (rb[:, :3] ** 2).sum(-1)
         + wa * (rb[:, 3:] ** 2).sum(-1))
    return H, g, c


def _visual_blocks(cam, T_cb, s, X, obs, fixed, vlm, lam):
    """``build_kernel`` and ``reduce_kernel``: the per-observation terms and
    their sums over the pair table, block b's 6x6 entries and 6 of g [nb, 42];
    Hinv, gl and B for the back-substitution."""
    L, K = obs.pose_idx.shape
    r, J, Jl, w, _ = tiba._visual_residuals(cam, T_cb, s, X, obs)
    r, J, Jl, w = r.reshape(L, K, 3), J.reshape(L, K, 3, 6), Jl.reshape(L, K, 3, 3), w.reshape(L, K)
    live = ~(w == 0)
    Jp = J * w[..., None, None]
    Hd = torch.where(live[..., None, None], torch.einsum("lkij,lkic->lkjc", Jp, J), 0.0)
    gp = torch.einsum("lkij,lki->lkj", Jp, r)
    B = torch.einsum("lkij,lkim->lkjm", Jp, Jl)
    Jlw = Jl * w[..., None, None]
    Hll = torch.einsum("lkij,lkim->ljm", Jlw, Jl)
    gl = torch.einsum("lkij,lki->lj", Jlw, r)
    A = Hll + torch.diag_embed(lam * torch.diagonal(Hll, dim1=-2, dim2=-1) + 1e-6)
    Hi = tlm.inv3x3(A) * vlm.to(F64)[:, None, None]
    W = torch.where((live & vlm[:, None])[..., None, None],
                    torch.einsum("lkjm,lmn->lkjn", B, Hi), 0.0)
    gd = torch.where(live[..., None], gp - torch.einsum("lkjn,ln->lkj", W, gl), 0.0)
    tb = klba.pair_table(obs.pose_idx, obs.valid, vlm, fixed)
    P = fixed.shape[0]
    nb = P * (P + 1) // 2
    E = int(tb.start[-1])
    order = tb.order[:E]
    o1, o2 = order // K, (order // (K * K)) * K + order % K
    blk = torch.searchsorted(tb.start, torch.arange(E), right=True) - 1
    flat = lambda x: x.reshape(L * K, *x.shape[2:])
    Wf, Bf, Hdf, gdf, livef = flat(W), flat(B), flat(Hd), flat(gd), flat(live)
    term = -torch.einsum("erm,ecm->erc", Wf[o1], Bf[o2]) * livef[o2][:, None, None]
    diag = (o1 == o2)[:, None, None]
    term = term + torch.where(diag, Hdf[o1], 0.0)
    gterm = torch.where(diag[:, :, 0], gdf[o1], 0.0)
    part = torch.zeros(nb, 42, dtype=F64)
    part.index_add_(0, blk, torch.cat([term.reshape(E, 36), gterm], 1))
    return part, Hi, gl, B


def _assemble(part, Hf, gf, Hb, gb, xi, fixed, lam, NL):
    """``Assembly::M`` and ``rhs`` over the free states (in state order):
    IMU blocks, the visual block, the BALM block, then lam |a| + 1e-8 on the
    diagonal."""
    P = fixed.shape[0]
    fpose = [q for q in range(P) if not bool(fixed[q])]
    bof = lambda p1, p2: p1 * P - p1 * (p1 - 1) // 2 + (p2 - p1)
    n = len(fpose)
    M = torch.zeros(D * n, D * n, dtype=F64)
    g = torch.zeros(D * n, dtype=F64)
    for ia, pa in enumerate(fpose):
        gi = torch.zeros(D, dtype=F64)
        if pa < P - 1:
            gi = gi + gf[pa, 0]
        if pa > 0:
            gi = gi + gf[pa - 1, 1]
        gi[:6] = gi[:6] + part[bof(pa, pa), 36:]
        if Hb is not None and pa < NL:
            gi[:6] = gi[:6] + (gb[6 * pa:6 * pa + 6] + Hb[6 * pa:6 * pa + 6] @ xi)
        g[D * ia:D * ia + D] = gi
        for ib, pb in enumerate(fpose):
            blk = torch.zeros(D, D, dtype=F64)
            if pa == pb:
                if pa < P - 1:
                    blk = blk + Hf[pa, 0]
                if pa > 0:
                    blk = blk + Hf[pa - 1, 2]
            elif pb == pa + 1:
                blk = Hf[pa, 1].clone()
            elif pa == pb + 1:
                blk = Hf[pb, 1].T.clone()
            vis = (part[bof(pa, pb), :36].reshape(6, 6) if pa <= pb
                   else part[bof(pb, pa), :36].reshape(6, 6).T)
            blk[:6, :6] = blk[:6, :6] + vis
            if Hb is not None and pa < NL and pb < NL:
                blk[:6, :6] = blk[:6, :6] + Hb[6 * pa:6 * pa + 6, 6 * pb:6 * pb + 6]
            M[D * ia:D * ia + D, D * ib:D * ib + D] = blk
    d = torch.diagonal(M)
    M[range(D * n), range(D * n)] = (d + lam * d.abs()) + 1e-8
    return M, g, fpose


def _gauss_jordan(M, g):
    """``solve_kernel``: Jacobi scaling, Gauss-Jordan elimination with the
    first largest |a| at or below the diagonal as the pivot (rows swapped
    here; the kernel keeps the permutation), x = b / diag; returns x / dsc."""
    M, g = M.numpy(), g.numpy()
    n = M.shape[0]
    dsc = np.sqrt(np.maximum(np.abs(np.diag(M)), 1e-12))
    A = np.concatenate([M / (dsc[:, None] * dsc[None, :]), (g / dsc)[:, None]], 1)
    for c in range(n):
        piv = c + _first_largest(A[c:, c])
        A[[c, piv]] = A[[piv, c]]
        inv = 1.0 / A[c, c]
        for r in range(n):
            if r != c:
                A[r, c + 1:] -= (A[r, c] * inv) * A[c, c + 1:]
    return torch.as_tensor(A[:, n] / np.diag(A[:, :n]) / dsc)


def _emulate(cam, T_cb, state0, X0, obs, fac, fixed, vlm, gravity, balm_clusters=None,
             T_bl=None, w_lidar=0.01, iters=8, use_balm=False, n_lidar=0):
    """``lvi_ba_lm``'s launches in float64 torch, in the kernel's order."""
    P, L = state0.T_wb.shape[0], X0.shape[0]
    NL = n_lidar if use_balm else 0
    Hb = gb = None
    cb = 0.0
    if use_balm:   # the wrapper's entry term
        Hb, gb, cb = klvi.balm_entry_term(balm_clusters, state0.T_wb, T_bl, w_lidar, NL)

    def vis_cost(s, X):
        r, _, _, w, _ = tiba._visual_residuals(cam, T_cb, s, X, obs)
        return torch.sum(w * torch.sum(r * r, -1))

    def model(xi):
        return cb + gb @ xi + 0.5 * (xi @ (Hb @ xi)) if use_balm else 0.0

    s, X = state0, X0
    xi = torch.zeros(6 * max(NL, 1), dtype=F64)
    Hf, gf, cf = _factor_blocks(s, fac, gravity)        # init: IMU slot 0
    cost = vis_cost(s, X) + cf.sum() + cb
    lam = 1e-3
    for _ in range(iters):
        part, Hi, gl, B = _visual_blocks(cam, T_cb, s, X, obs, fixed, vlm, lam)
        M, g, fpose = _assemble(part, Hf, gf, Hb, gb, xi[:6 * NL], fixed, lam, NL)
        dx = torch.zeros(P, D, dtype=F64)
        if fpose:
            dx[fpose] = -_gauss_jordan(M, g).reshape(len(fpose), D)
        s_new = tiba.InertialState(s.T_wb @ tlie.se3_exp(dx[:, :6]), s.vel + dx[:, 6:9],
                                   s.bg + dx[:, 9:12], s.ba + dx[:, 12:15])
        xi_new = xi + dx[:NL, :6].reshape(-1) if NL else xi
        pidx = obs.pose_idx.long().clamp(0, P - 1)
        bt = torch.einsum("lkim,lki->lm", B, dx[:, :6][pidx])
        X_new = X - torch.einsum("lij,lj->li", Hi, gl + bt) * vlm.to(F64)[:, None]
        Hf_n, gf_n, cf_n = _factor_blocks(s_new, fac, gravity)   # eval: the other IMU slot
        cand = vis_cost(s_new, X_new) + cf_n.sum() + model(xi_new)
        if bool(cand < cost):   # a NaN rejects
            s, X, xi, cost = s_new, X_new, xi_new, cand
            Hf, gf = Hf_n, gf_n
            lam *= 0.5
        else:
            lam *= 4.0
    inlier = tiba._visual_residuals(cam, T_cb, s, X, obs)[4].reshape(obs.pose_idx.shape)
    return tiba.LviBaResult(s, X, cost, inlier)


@pytest.mark.parametrize("case", CASES)
def test_kernel_order_matches_plain_float64_and_jax(case):
    with jax.enable_x64(True):
        p, a, kw, ja, jkw = _case(case)
        jref = jiba.lvi_ba(*ja, **jkw)
    got = _emulate(*a, **kw)
    ref = klvi.lvi_ba_plain(*a, **kw)
    assert ref.X_w.dtype == F64
    # the same algorithm in float64: other orders of sums, Gauss-Jordan for LU
    for x, y, tol in ((got.state.T_wb, ref.state.T_wb, 1e-9), (got.state.vel, ref.state.vel, 1e-8),
                      (got.state.bg, ref.state.bg, 1e-10), (got.state.ba, ref.state.ba, 1e-9),
                      (got.X_w, ref.X_w, 1e-7)):
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=0, atol=tol)
    np.testing.assert_allclose(float(got.cost), float(ref.cost), rtol=1e-10)
    assert torch.equal(got.obs_inlier, ref.obs_inlier)
    assert_lvi_close(got, jref, p["T_gt"][:1])
    real = len(p["T_gt"]) - (2 if case == "padded" else 0)
    T_gt = torch.as_tensor(p["T_gt"][:real], dtype=F64)
    err = lambda T: float(tlie.se3_log(torch.linalg.inv(T_gt) @ T[:real]).abs().max())
    if case != "non-finite":   # (which returns its entry state)
        assert err(got.state.T_wb) < 3e-2 < err(a[2].T_wb)
    if case == "padded":   # the padded slots stay the identity, bit for bit
        assert torch.equal(got.state.T_wb[-2:], torch.eye(4, dtype=F64).expand(2, 4, 4))
    if case == "non-finite":   # the entry state comes back
        s0 = a[2]
        assert torch.isnan(got.cost)
        for x, y in ((got.state.T_wb, s0.T_wb), (got.state.vel, s0.vel), (got.X_w, a[3])):
            assert torch.equal(torch.nan_to_num(x), torch.nan_to_num(y))


def test_first_iteration_system_matches_the_plain_assembly():
    """The compacted system (IMU, visual, BALM blocks over the free states,
    then lam |diag| + 1e-8) against the plain version's dense [15P, 15P]
    system restricted to the free rows, at the entry state of the BALM case
    with a fixed state in the middle of the window."""
    p, a, kw, _, _ = _case("balm", with_jax=False)
    cam, T_cb, s, X, obs, fac, fixed, vlm, grav = a
    fixed = fixed.clone()
    fixed[3] = True
    lam = 1e-3
    Hf, gf, _ = _factor_blocks(s, fac, grav)
    part, _, _, _ = _visual_blocks(cam, T_cb, s, X, obs, fixed, vlm, lam)
    NL = kw["n_lidar"]
    Hb, gb, _ = klvi.balm_entry_term(kw["balm_clusters"], s.T_wb, kw["T_bl"], 0.01, NL)
    M, g, fpose = _assemble(part, Hf, gf, Hb, gb, torch.zeros(6 * NL, dtype=F64), fixed, lam, NL)
    # the plain version's assembly (lvi_ba_plain's assemble, float64)
    P, (L, K) = s.T_wb.shape[0], obs.pose_idx.shape
    H, gg, _ = tiba._imu_terms(s, fac, grav)
    r, J, Jl, w, _ = tiba._visual_residuals(cam, T_cb, s, X, obs)
    oh = (obs.pose_idx.long().clamp(0, P - 1).reshape(-1)[:, None] == torch.arange(P)).to(F64)
    Jpw = J * w[:, None, None]
    Hpp = torch.einsum("op,oij,oik->pjk", oh, Jpw, J)
    gp = torch.einsum("op,oij,oi->pj", oh, Jpw, r)
    Jlw = Jl * w[:, None, None]
    Hll = torch.einsum("oij,oik->ojk", Jlw, Jl).reshape(L, K, 3, 3).sum(1)
    gl = torch.einsum("oij,oi->oj", Jlw, r).reshape(L, K, 3).sum(1)
    B6 = torch.einsum("oij,oik->ojk", Jpw, Jl).reshape(L, K, 6, 3)
    Hi = tlm.inv3x3(Hll + torch.diag_embed(lam * torch.diagonal(Hll, dim1=-2, dim2=-1) + 1e-6))
    U = torch.einsum("lkp,lkim,lmn->lpin", oh.reshape(L, K, P), B6, Hi)
    V = torch.einsum("lkp,lkjm->lpjm", oh.reshape(L, K, P), B6)
    Hv = -torch.einsum("lpim,lqjm->pqij", U, V)
    Hv[range(P), range(P)] += Hpp
    H[:, :, :6, :6] += Hv
    gg[:, :6] += gp - torch.einsum("lpim,lm->pi", U, gl)
    Hd = H.permute(0, 2, 1, 3).reshape(D * P, D * P)
    gd = gg.reshape(-1)
    for q_ in range(NL):
        for q2 in range(NL):
            Hd[D * q_:D * q_ + 6, D * q2:D * q2 + 6] += Hb[6 * q_:6 * q_ + 6, 6 * q2:6 * q2 + 6]
        gd[D * q_:D * q_ + 6] += gb[6 * q_:6 * q_ + 6]
    rows = torch.cat([torch.arange(D * q, D * q + D) for q in fpose])
    Hd = Hd[rows][:, rows]
    Hd = Hd + lam * torch.diag(torch.diagonal(Hd).abs()) + 1e-8 * torch.eye(len(rows), dtype=F64)
    assert fpose == [1, 2, 4, 5]
    scale = chip_smoke.diag_scale(torch, Hd)
    assert float(((M - Hd).abs() / scale).max()) < 1e-10
    np.testing.assert_allclose(g.numpy(), gd[rows].numpy(), rtol=1e-9,
                               atol=1e-9 * float(gd.abs().max()))


def test_lvi_ba_routes_cpu_tensors_to_the_plain_version(monkeypatch):
    """``solver.inertial_ba.lvi_ba`` sends CPU tensors to ``lvi_ba_plain``;
    ``lvi_ba_lm`` refuses CPU tensors (it launches a kernel or raises) and a
    camera other than a pinhole; an unknown device is refused."""
    p, a, kw, _, _ = _case("no_balm", with_jax=False)
    a32 = chip_smoke._vi_cast(torch, a, torch.float32)
    seen = []
    plain = klvi.lvi_ba_plain
    monkeypatch.setattr(klvi, "lvi_ba_plain", lambda *x, **k: seen.append(1) or plain(*x, **k))
    res = tiba.lvi_ba(*a32, **kw)
    assert seen == [1] and res.state.T_wb.dtype == torch.float32
    with pytest.raises(ValueError, match="one CUDA device"):
        klvi.lvi_ba_lm(*a32, **kw)
    with pytest.raises(ValueError, match="Pinhole"):
        klvi.lvi_ba_lm(tcam.KannalaBrandt8.create(*([1.0] * 8)), *a32[1:], **kw)
    meta = a32[:3] + (a32[3].to("meta"),) + a32[4:]
    with pytest.raises(ValueError, match="unsupported device"):
        tiba.lvi_ba(*meta, **kw)


def test_max_poses_is_the_solve_shared_memory_limit():
    """``MAX_POSES`` is the largest window whose solve launch fits the H100's
    shared memory a block (its dynamic part, ``solve_smem``, with the widest
    BALM term, plus at most 1 KB of static arrays); the issue's 26 from
    ``local_ba.cu``'s layout fits, 28 does not."""
    static = 1024
    assert klvi.solve_smem(klvi.MAX_POSES, 16) + static <= klvi.SMEM_LIMIT
    assert klvi.solve_smem(klvi.MAX_POSES + 1, 0) > klvi.SMEM_LIMIT
    assert klvi.MAX_POSES >= 26 and 20 <= klvi.MAX_POSES   # the FullInertialBA's window
    assert klvi.launches_per_call(6) == 32 and klvi.launches_per_call(10) == 52
    assert sum(k for _, k in klvi.FACTOR_FIELDS) == 151


def test_factor_table_layout():
    """The factor table the kernel reads: a float32 row of ``FACTOR_FIELDS``
    a factor, in the ImuWindowFactors' own field order."""
    p, a, _, _, _ = _case("padded", with_jax=False)
    fac = chip_smoke._vi_cast(torch, a[5], torch.float32)
    tab = klvi.factor_table(fac)
    assert tab.shape == (5, 151) and tab.dtype == torch.float32
    assert [n for n, _ in klvi.FACTOR_FIELDS] == list(tiba.ImuWindowFactors._fields)
    off = 0
    for name, k in klvi.FACTOR_FIELDS:
        np.testing.assert_array_equal(tab[:, off:off + k].numpy(),
                                      getattr(fac, name).reshape(5, k).float().numpy())
        off += k
    assert tab[-2:, -1].tolist() == [0.0, 0.0]   # the padded factors are invalid


@pytest.mark.parametrize("window,imu,inertial_ba", [(27, True, True), (28, True, True),
                                                     (28, True, False), (28, False, False)])
def test_system_refuses_an_inertial_window_over_the_kernel_limit(window, imu, inertial_ba):
    """On the card ``System`` takes an IMU-mode window of at most 27 states
    (``lvi_ba_lm``'s solve) and says so at construction; without the LVI-BA
    (no IMU, or ``inertial_ba`` off) the window BA's limit of 67 applies; on
    the CPU any window."""
    import dataclasses
    from tc2li_slam_torch.slam import config as tcfg, system as tsys
    from torch_parity import small_config
    cfg = small_config(tcfg)
    cfg = dataclasses.replace(cfg, use_imu=imu, inertial_ba=inertial_ba,
                              tracking=dataclasses.replace(cfg.tracking, local_window=window))
    assert tsys.System(cfg, "cpu").cfg.tracking.local_window == window
    if imu and inertial_ba and window > klvi.MAX_POSES:
        with pytest.raises(ValueError, match="at most 27 states"):
            tsys.System(cfg, torch.device("cuda"))
    else:
        tsys.check_kernel_limits(cfg)
