"""Visual-inertial(-LiDAR) window bundle adjustment: one hand-written CUDA
kernel sequence + its plain version.

Replaces ``tc2li_slam_tpu/solver/inertial_ba.py:lvi_ba`` (line 191, its
``lax.scan`` :335), one jit-compiled program on the TPU: LocalLVIBA (and the
FullInertialBA) over a temporal window of P keyframe states of 15 dims
(pose, velocity, gyro and accel biases) with IMU preintegration and bias
random-walk factors, stereo and mono reprojection with Schur-eliminated
landmarks and the BALM eigen-factor over the first ``n_lidar`` poses.
Written as eager PyTorch (``lvi_ba_plain``) a pass is ~8,300 device events
on every keyframe of the IMU mode (4e's window: P 6, 6 iterations, the BALM
term), an iteration's around a [P, P, 15, 15] accumulate and a dense solve.

Bound on the H100: latency. At P 6, L 8192, K 8 an iteration reads ~1.4 MB of
observations and does ~60 M operations (a few microseconds of either); its
steps are serial. ``csrc/lvi_ba.cu`` runs a call as 2 + 5 ``iters`` launches
on the current stream with no host sync and no atomics in a float sum (the
same bits on every call): ``local_ba.cu``'s plan (the landmark pass, the
reduction of the visual blocks over ``local_ba.pair_table``, the solve on a
cluster of 8 blocks, the candidate's pass, the accept/reject) with the
body-frame observation, 15-dim blocks, and the IMU factors' blocks computed
in float64 by a block a factor inside the entry's and each candidate's
landmark launches. The plain version's order of assembly is kept: IMU
blocks, visual blocks, the BALM block, then ``lam |diag| + 1e-8``. Sums,
inverses, the IMU terms, the elimination and the costs are float64 from the
float32 state, so the kernel is nearer the float64 run of the plain version
than the float32 run is. The BALM term (``balm_quadratic`` at the entry,
transported by ``Adj(T_lb)``) is computed here before the launches, as the
plain version does at its entry; there is no exit revert (the plain version
has none). Windows of more than ``MAX_POSES`` states exceed the solve's
shared memory: their launch is refused and raises.

``lvi_ba_lm`` launches the kernels (CUDA tensors only);
``solver.inertial_ba.lvi_ba`` sends CUDA tensors there and CPU tensors to
``lvi_ba_plain``; there is no other route.
"""

from __future__ import annotations

import torch

from ...geom import camera as cam_mod, lie
from ...solver import balm as balm_mod, inertial_ba as iba
from ...solver.lm import inv3x3, precond_solve
from . import build
from .local_ba import CHUNK, MAX_CHUNKS, MAX_OBS, pair_table

launches = 0      # kernel launches by lvi_ba_lm (plain-version calls excluded)
MAX_POSES = 27    # states of a window: the solve's shared memory (csrc/lvi_ba.cu kMaxPoses)
SHARED_ROWS = 96  # free rows up to which the solve's block 0 works alone (kSharedD)
SMEM_LIMIT = 232448   # shared memory a block can use on the H100
# a factor's row of the table the kernel reads (csrc/lvi_ba.cu kF*): field, floats
FACTOR_FIELDS = (("dR", 9), ("dV", 3), ("dP", 3), ("JRg", 9), ("JVg", 9), ("JVa", 9),
                 ("JPg", 9), ("JPa", 9), ("dt", 1), ("C_inv", 81), ("bg_lin", 3), ("ba_lin", 3),
                 ("info_bg", 1), ("info_ba", 1), ("valid", 1))


def launches_per_call(iters: int) -> int:
    """Kernel launches of one ``lvi_ba_lm`` call: init and its commit, then
    build, reduce, solve, eval and commit an iteration."""
    return 2 + 5 * iters


def solve_smem(P: int, n_lidar: int = 0) -> int:
    """Bytes of dynamic shared memory of the solve launch (csrc/lvi_ba.cu
    solve_smem): its rows, the cluster's candidate slots, the scaling, x,
    the BALM tangent, the row permutation."""
    D, cluster = 15 * P, 8
    m_elems = max(SHARED_ROWS * (SHARED_ROWS + 1), -(-D // cluster) * (D + 1))
    return 8 * (m_elems + 2 * cluster * (D + 5) + 2 * D + 6 * max(n_lidar, 1)) + 4 * 2 * D


def balm_entry_term(balm_clusters, T_wb0, T_bl, w_lidar: float, n_lidar: int):
    """The BALM eigen-factor over the first ``n_lidar`` poses at the entry
    state, in the body poses' tangents: (H [6n, 6n], g [6n], cost), the
    quadratic of ``balm.quadratic`` transported by one adjoint ``Adj(T_lb)`` a
    pose and weighted by ``w_lidar``."""
    Adj_lb = lie.se3_adjoint(lie.se3_inverse(T_bl))     # tangent_b -> tangent_l
    q = balm_mod.quadratic(balm_clusters, T_wb0[:n_lidar] @ T_bl)
    A = torch.block_diag(*([Adj_lb] * n_lidar))         # [6n, 6n]
    return A.T @ q.H @ A * w_lidar, A.T @ q.g * w_lidar, q.cost * w_lidar


def lvi_ba_plain(cam: cam_mod.Pinhole, T_cb, state0, X_w0, obs,
                 imu_fac, fixed, valid_lm, gravity, balm_clusters=None,
                 T_bl=None, w_lidar: float = 0.01, iters: int = 8, use_balm: bool = False,
                 n_lidar: int = 0):
    """LocalLVIBA: temporal-window inertial BA + reprojection + the BALM
    edge (``solver.inertial_ba.lvi_ba``'s arguments), as eager tensor ops."""
    D, POSE = iba.D, iba.POSE
    InertialState, LviBaResult = iba.InertialState, iba.LviBaResult
    _visual_residuals, _imu_terms, _apply_delta = (iba._visual_residuals, iba._imu_terms,
                                                   iba._apply_delta)

    P = state0.T_wb.shape[0]
    L, K = obs.pose_idx.shape
    PD = P * D
    dt_, dev = X_w0.dtype, X_w0.device
    eye3 = torch.eye(3, dtype=dt_, device=dev)
    eyePD = torch.eye(PD, dtype=dt_, device=dev)
    arP = torch.arange(P, device=dev)
    free = (~fixed).to(dt_)
    free_d = free.repeat_interleave(D)
    lmw = valid_lm.to(dt_)
    oh = (torch.clamp(obs.pose_idx, 0, P - 1).reshape(-1)[:, None] == arP[None, :]).to(dt_)
    ohk = oh.reshape(L, K, P)

    # lazy relinearization: the eigen-Hessian once at the entry state; the
    # gradient and cost follow the quadratic model along the accumulated
    # pose tangent (see lm.local_ba)
    if use_balm:
        Hb0, gb0, cb0 = balm_entry_term(balm_clusters, state0.T_wb, T_bl, w_lidar, n_lidar)
        ar6 = torch.arange(n_lidar * 6, device=dev)
        bidx = (ar6 // 6) * D + (ar6 % 6)      # the BALM block in full pose coordinates
        fb = free_d[bidx]

    def visual_cost(r, w):
        return torch.sum(w * torch.sum(r * r, dim=-1))

    def assemble(s: InertialState, X_w, lam, xi):
        r, J_pose, J_lm, w, _ = _visual_residuals(cam, T_cb, s, X_w, obs)
        Jpw = J_pose * w[:, None, None]
        Hpp_blk = torch.einsum("oij,oik->ojk", Jpw, J_pose)
        gp_blk = torch.einsum("oij,oi->oj", Jpw, r)
        Hpp = torch.einsum("op,ojk->pjk", oh, Hpp_blk)
        gp6 = torch.einsum("op,oj->pj", oh, gp_blk)
        H, g, _ = _imu_terms(s, imu_fac, gravity)

        Jlw = J_lm * w[:, None, None]
        Hll = torch.einsum("oij,oik->ojk", Jlw, J_lm).reshape(L, K, 3, 3).sum(dim=1)
        gl = torch.einsum("oij,oi->oj", Jlw, r).reshape(L, K, 3).sum(dim=1)
        B6 = torch.einsum("oij,oik->ojk", Jpw, J_lm).reshape(L, K, 6, 3)
        Hll_d = Hll + (lam * torch.diag_embed(torch.diagonal(Hll, dim1=-2, dim2=-1))
                       + 1e-6 * eye3)
        Hll_inv = inv3x3(Hll_d) * lmw[:, None, None]
        BHinv6 = torch.einsum("lkij,ljm->lkim", B6, Hll_inv)
        U = torch.einsum("lkp,lkim->lpim", ohk, BHinv6)     # [L, P, 6, 3]
        V = torch.einsum("lkp,lkjm->lpjm", ohk, B6)
        corr_pq = torch.einsum("lpim,lqjm->pqij", U, V)     # [P, P, 6, 6]
        Hv = -corr_pq
        Hv[arP, arP] = Hv[arP, arP] + Hpp
        H[:, :, POSE, POSE] += Hv
        g[:, POSE] += gp6 - torch.einsum("lpim,lm->pi", U, gl)

        H = H * free[:, None, None, None] * free[None, :, None, None]
        Hd = H.permute(0, 2, 1, 3).reshape(PD, PD)
        g = g.reshape(-1)
        if use_balm:
            gb = gb0 + Hb0 @ xi.reshape(-1)
            Hd.index_put_((bidx[:, None], bidx[None, :]), Hb0 * fb[:, None] * fb[None, :],
                          accumulate=True)
            g.index_put_((bidx,), gb * fb, accumulate=True)
        Hd = Hd + torch.diag(1.0 - free_d)
        Hd = Hd + lam * torch.diag(torch.abs(torch.diagonal(Hd))) + 1e-8 * eyePD
        g = g * free_d
        # Jacobi-preconditioned: IMU information (1e6 and more) and visual
        # information (O(1)) share this float32 system
        dx = -precond_solve(Hd, g).reshape(P, D) * free[:, None]
        dp_per_obs = torch.einsum("lkp,pj->lkj", ohk, dx[:, :6])
        Bt_dp = torch.einsum("lkij,lki->lj", B6, dp_per_obs)
        dl = -torch.einsum("lij,lj->li", Hll_inv, gl + Bt_dp) * valid_lm[:, None]
        return dx, dl

    def total_cost(s: InertialState, X_w, xi):
        r, _, _, w, _ = _visual_residuals(cam, T_cb, s, X_w, obs)
        c = visual_cost(r, w) + _imu_terms(s, imu_fac, gravity)[2]
        if use_balm:
            x = xi.reshape(-1)
            c = c + cb0 + gb0 @ x + 0.5 * (x @ (Hb0 @ x))
        return c

    s, X_w = state0, X_w0
    xi = torch.zeros((max(n_lidar, 1), 6), dtype=dt_, device=dev)
    lam = torch.full((), 1e-3, dtype=dt_, device=dev)
    cost = total_cost(s, X_w, xi)
    for _ in range(iters):
        dx, dl = assemble(s, X_w, lam, xi)
        s_new = _apply_delta(s, dx)
        X_new = X_w + dl
        xi_new = xi + dx[:n_lidar, :6] if use_balm else xi
        cost_new = total_cost(s_new, X_new, xi_new)
        accept = cost_new < cost
        s = InertialState(*[torch.where(accept, a, b) for a, b in zip(s_new, s)])
        X_w = torch.where(accept, X_new, X_w)
        xi = torch.where(accept, xi_new, xi)
        lam = torch.where(accept, lam * 0.5, lam * 4.0)
        cost = torch.where(accept, cost_new, cost)

    inlier = _visual_residuals(cam, T_cb, s, X_w, obs)[4].reshape(L, K)
    return LviBaResult(s, X_w, cost, inlier)


def _check(name, x, shape, dtypes, dev):
    if tuple(x.shape) != tuple(shape) or x.dtype not in dtypes:
        raise ValueError(f"lvi_ba_lm: {name} must be {dtypes[0]} {tuple(shape)}, got "
                         f"{x.dtype} {tuple(x.shape)}")
    if x.device.type != "cuda" or x.device != dev:
        raise ValueError(f"lvi_ba_lm: every tensor must lie on one CUDA device, got "
                         f"{x.device} beside {dev}")


def factor_table(imu_fac) -> torch.Tensor:
    """The IMU factors as the kernel reads them: a float32 row of
    ``FACTOR_FIELDS`` a factor, [P - 1, 151] (two tensor ops)."""
    n = imu_fac.valid.shape[0]
    return torch.cat([getattr(imu_fac, name).reshape(n, k).to(torch.float32)
                      for name, k in FACTOR_FIELDS], dim=1)


def lvi_ba_lm(cam: cam_mod.Pinhole, T_cb, state0, X_w0, obs, imu_fac, fixed, valid_lm, gravity,
              balm_clusters=None, T_bl=None, w_lidar: float = 0.01, iters: int = 8,
              use_balm: bool = False, n_lidar: int = 0):
    """Launch ``csrc/lvi_ba.cu`` on the current stream: what ``lvi_ba_plain``
    computes, in ``launches_per_call(iters)`` launches (and, with the BALM
    term, ``balm.quadratic``'s at the entry)."""
    global launches
    if not isinstance(cam, cam_mod.Pinhole):
        raise ValueError(f"lvi_ba_lm takes a Pinhole camera, got {type(cam).__name__}")
    P = state0.T_wb.shape[0]
    L, K = obs.pose_idx.shape
    dev = X_w0.device
    f32, flag, idx = (torch.float32,), (torch.bool, torch.uint8), (torch.int32, torch.int64)
    F = P - 1
    for name, x, shape, dts in (
            ("T_wb", state0.T_wb, (P, 4, 4), f32), ("vel", state0.vel, (P, 3), f32),
            ("bg", state0.bg, (P, 3), f32), ("ba", state0.ba, (P, 3), f32),
            ("X_w0", X_w0, (L, 3), f32), ("T_cb", T_cb, (4, 4), f32),
            ("gravity", gravity, (3,), f32),
            ("pose_idx", obs.pose_idx, (L, K), idx), ("uv", obs.uv, (L, K, 3), f32),
            ("inv_sigma2", obs.inv_sigma2, (L, K), f32), ("stereo", obs.stereo, (L, K), flag),
            ("valid", obs.valid, (L, K), flag), ("fixed", fixed, (P,), flag),
            ("valid_lm", valid_lm, (L,), flag), ("imu valid", imu_fac.valid, (F,), flag)):
        _check(name, x, shape, dts, dev)
    for name, k in FACTOR_FIELDS[:-1]:
        x = getattr(imu_fac, name)
        _check(f"imu {name}", x, (F,) + ((3, 3) if k == 9 else (9, 9) if k == 81 else
                                        (3,) if k == 3 else ()), f32, dev)
    if not 1 <= K <= MAX_OBS or not 1 <= P <= MAX_POSES or iters < 0:
        raise ValueError(f"lvi_ba_lm: K {K} (1 to {MAX_OBS}), P {P} (1 to {MAX_POSES}), "
                         f"iters {iters}")
    if use_balm and not 1 <= n_lidar <= P:
        raise ValueError(f"lvi_ba_lm: n_lidar {n_lidar} with the BALM term (1 to {P})")
    Hb = gb = cb = None
    NL = 0
    if use_balm:
        Hb, gb, cb = balm_entry_term(balm_clusters, state0.T_wb, T_bl, w_lidar, n_lidar)
        Hb, gb, cb = Hb.contiguous(), gb.contiguous(), cb.reshape(1).contiguous()
        NL = n_lidar
        for name, x, shape in (("H", Hb, (6 * NL, 6 * NL)), ("g", gb, (6 * NL,)), ("cost", cb, (1,))):
            _check(f"the BALM term's {name}", x, shape, f32, dev)
    u8 = lambda x: x.contiguous().view(torch.uint8) if x.dtype == torch.bool else x.contiguous()
    T0, V0, BG0, BA0, X0, uv, s2, Tcb, grav = (x.contiguous() for x in (
        state0.T_wb, state0.vel, state0.bg, state0.ba, X_w0, obs.uv, obs.inv_sigma2, T_cb,
        gravity))
    pidx = obs.pose_idx.to(torch.int32).contiguous()
    st, va, fx_, vl = (u8(x) for x in (obs.stereo, obs.valid, fixed, valid_lm))
    fac = factor_table(imu_fac) if F > 0 else torch.empty((0, 151), device=dev)
    tb = pair_table(pidx, obs.valid, valid_lm, fixed)
    part = torch.empty((max(tb.n_chunks, 1), 42), dtype=torch.float64, device=dev)
    lib = build.library()
    scratch = torch.empty(int(lib.tc2li_lvi_ba_scratch(L, K, P, NL)), dtype=torch.uint8,
                          device=dev)
    T_out = torch.empty((P, 4, 4), dtype=torch.float32, device=dev)
    vec = [torch.empty((P, 3), dtype=torch.float32, device=dev) for _ in range(3)]
    X_out = torch.empty((L, 3), dtype=torch.float32, device=dev)
    scal = torch.empty(1, dtype=torch.float32, device=dev)
    inlier = torch.empty((L, K), dtype=torch.uint8, device=dev)
    ptr = lambda x: 0 if x is None else x.data_ptr()
    stream = torch.cuda.current_stream(dev).cuda_stream
    build.check(lib.tc2li_lvi_ba_lm(
        T0.data_ptr(), V0.data_ptr(), BG0.data_ptr(), BA0.data_ptr(), X0.data_ptr(),
        pidx.data_ptr(), uv.data_ptr(), s2.data_ptr(), st.data_ptr(), va.data_ptr(),
        fx_.data_ptr(), vl.data_ptr(), Tcb.data_ptr(), fac.data_ptr(), grav.data_ptr(),
        ptr(Hb), ptr(gb), ptr(cb), tb.order.data_ptr(), tb.start.data_ptr(),
        tb.cstart.data_ptr(), part.data_ptr(), L, K, P, NL, tb.n_chunks, CHUNK, MAX_CHUNKS,
        cam.fx, cam.fy, cam.cx, cam.cy, cam.bf, int(iters), scratch.data_ptr(),
        T_out.data_ptr(), vec[0].data_ptr(), vec[1].data_ptr(), vec[2].data_ptr(),
        X_out.data_ptr(), scal.data_ptr(), inlier.data_ptr(), stream), "lvi_ba_lm")
    launches += launches_per_call(iters)
    return iba.LviBaResult(iba.InertialState(T_out, *vec), X_out, scal[0],
                           inlier.view(torch.bool))
