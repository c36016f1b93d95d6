"""Visual-inertial refinement of one frame: one hand-written CUDA kernel +
its plain versions.

Replaces ``tc2li_slam_tpu/solver/pose_inertial.py:optimize_last_kf`` (line
205, its ``lax.scan`` :249) and ``optimize_last_frame`` (:263, :316), each
one jit-compiled program on the TPU. Written as eager PyTorch
(``optimize_last_kf_plain``, ``optimize_last_frame_plain``) a call is
12,000-17,000 small ops, each a launch, on every tracked frame of the IMU
mode.

Bound on the H100: latency. A call over 2,000 rows reads 60 KB and does
~6 M float64 operations (a multiply-add counted as one; ~200 a row a pass); its 2 x (1 + 6) + 1 evaluations are serial, each a
reduction over the rows and a 15- or 30-dim solve. ``csrc/pose_inertial.cu``
runs a call in one launch of a cluster of 8 blocks: the rows an eighth a
block, their sums exchanged through distributed shared memory, and the IMU
factor, the prior, the products (upper triangles, the Jacobians' non-zero
rows), the Cholesky factor (right-looking, an entry a thread) and the accept
test on the whole of every block, all in float64 from the float32 inputs (the IMU information is
O(1e6) beside the visual O(1); near convergence a float32 cost is noisier
than the changes the accept test decides). It therefore agrees with the
plain version run in float64 more closely than the float32 plain version
does; beside the float32 plain version it agrees to its rounding, and an
inlier flag can differ only where a row's chi2 sits at its gate. The
same bits on every call, no host sync; ``n_inliers`` is an int32 device
tensor.

``pose_inertial_lm`` launches the kernel (CUDA tensors only): 15 free dims
with ``prior=None`` (the last keyframe's state a fixed anchor), 30 with a
prior (prev free). ``solver/pose_inertial.optimize_last_kf`` and
``optimize_last_frame`` send CUDA tensors there and CPU tensors to the plain
versions; any other device raises. There is no other route.
"""

from __future__ import annotations

import ctypes

import torch

from ...geom import camera as cam_mod
from ...solver import lm as lm_mod, pose_inertial as pi
from ...tensors import count
from . import build

launches = 0   # kernel launches by pose_inertial_lm (plain-version calls excluded)
OUT_FLOATS = 252   # T_wb [16], vel, bg, ba [3], the prior's H [15, 15], cost, weight


def optimize_last_kf_plain(cam: cam_mod.Pinhole, T_cb, state0, kf_state, pre, gravity, X_w,
                           uvr, inv_sigma2, stereo, valid, info_bg, info_ba, rounds: int = 2,
                           iters: int = 6):
    """PoseInertialOptimizationLastKeyFrame: ``kf_state`` is the fixed
    anchor, ``pre`` the keyframe -> frame preintegration, X_w [O, 3] the
    matched landmarks with observations uvr [O, 3]."""
    dt_, dev = X_w.dtype, X_w.device
    eyeD = torch.eye(pi.D, dtype=dt_, device=dev)
    C9_inv = pi._pre_info(pre)

    def quad(s, gate):
        Hv, gv, cv, inl = pi._visual_terms(cam, T_cb, s, X_w, uvr, inv_sigma2, stereo, valid,
                                           gate)
        _, _, H22, _, g2, ci = pi._imu_pair_terms(kf_state, s, pre, C9_inv, gravity,
                                                  info_bg, info_ba)
        Hv, gv = pi._pad_pose(Hv, gv)
        return H22 + Hv, g2 + gv, cv + ci, inl

    s = state0
    cost = torch.zeros((), dtype=dt_, device=dev)
    for rnd in range(rounds):
        gate = rnd > 0
        lam = torch.full((), 1e-2, dtype=dt_, device=dev)
        cost = quad(s, gate)[2]
        for _ in range(iters):
            H, g, _, _ = quad(s, gate)
            Haug = H + lam * torch.diag(torch.diagonal(H)) + 1e-6 * eyeD
            s_new = pi._apply(s, -lm_mod.precond_solve(Haug, g))
            cost_new = quad(s_new, gate)[2]
            accept = cost_new < cost
            s = pi._select(accept, s_new, s)
            lam = torch.where(accept, lam * 0.5, lam * 4.0)
            cost = torch.where(accept, cost_new, cost)
    H, _, _, inl = quad(s, True)
    prior = pi.FramePrior(state=s, H=H, weight=torch.ones((), dtype=dt_, device=dev))
    return pi.PoseInertialResult(s, prior, count(inl), inl, cost)


def optimize_last_frame_plain(cam: cam_mod.Pinhole, T_cb, state0, prev_state, prev_prior, pre,
                              gravity, X_w, uvr, inv_sigma2, stereo, valid, info_bg, info_ba,
                              rounds: int = 2, iters: int = 6):
    """PoseInertialOptimizationLastFrame: joint 30-dim solve over
    [prev | cur] with the prior on prev, then prev is Schur-marginalized
    out of the final Hessian to form the next frame's prior."""
    dt_, dev = X_w.dtype, X_w.device
    eye2D = torch.eye(2 * pi.D, dtype=dt_, device=dev)
    C9_inv = pi._pre_info(pre)

    def quad(sp, sc, gate):
        Hv, gv, cv, inl = pi._visual_terms(cam, T_cb, sc, X_w, uvr, inv_sigma2, stereo, valid,
                                           gate)
        H11, H12, H22, g1, g2, ci = pi._imu_pair_terms(sp, sc, pre, C9_inv, gravity,
                                                       info_bg, info_ba)
        Hp, gp, cp = pi._prior_terms(sp, prev_prior)
        Hv, gv = pi._pad_pose(Hv, gv)
        return H11 + Hp, H12, H22 + Hv, g1 + gp, g2 + gv, cv + ci + cp, inl

    sp, sc = prev_state, state0
    cost = torch.zeros((), dtype=dt_, device=dev)
    for rnd in range(rounds):
        gate = rnd > 0
        lam = torch.full((), 1e-2, dtype=dt_, device=dev)
        cost = quad(sp, sc, gate)[5]
        for _ in range(iters):
            H11, H12, H22, g1, g2, _, _ = quad(sp, sc, gate)
            H = torch.cat([torch.cat([H11, H12], dim=1), torch.cat([H12.T, H22], dim=1)], dim=0)
            g = torch.cat([g1, g2])
            Haug = H + lam * torch.diag(torch.diagonal(H)) + 1e-6 * eye2D
            dx = -lm_mod.precond_solve(Haug, g)
            sp_n = pi._apply(sp, dx[:pi.D])
            sc_n = pi._apply(sc, dx[pi.D:])
            cost_new = quad(sp_n, sc_n, gate)[5]
            accept = cost_new < cost
            sp = pi._select(accept, sp_n, sp)
            sc = pi._select(accept, sc_n, sc)
            lam = torch.where(accept, lam * 0.5, lam * 4.0)
            cost = torch.where(accept, cost_new, cost)

    # marginalize prev out of the joint Hessian: H* = H22 - H21 H11^-1 H12
    H11, H12, H22, _, _, _, inl = quad(sp, sc, True)
    H11_r = H11 + 1e-6 * torch.eye(pi.D, dtype=dt_, device=dev)
    Hm = H22 - H12.T @ torch.linalg.solve_ex(H11_r, H12, check_errors=False)[0]
    prior = pi.FramePrior(state=sc, H=0.5 * (Hm + Hm.T),
                          weight=torch.ones((), dtype=dt_, device=dev))
    return pi.PoseInertialResult(sc, prior, count(inl), inl, cost)


def _operand(name, x, shape):
    if tuple(x.shape) != tuple(shape) or x.dtype != torch.float32:
        raise ValueError(f"pose_inertial_lm: {name} must be float32 {tuple(shape)}, got "
                         f"{x.dtype} {tuple(x.shape)}")
    return x.contiguous()


def pose_inertial_lm(cam: cam_mod.Pinhole, T_cb, state0, anchor, prior, pre, gravity, X_w,
                     uvr, inv_sigma2, stereo, valid, info_bg, info_ba, rounds: int = 2,
                     iters: int = 6):
    """Launch ``csrc/pose_inertial.cu`` on the current stream: what
    ``optimize_last_kf_plain`` computes with ``prior`` None (``anchor`` the
    keyframe's state), what ``optimize_last_frame_plain`` computes with a
    ``FramePrior`` (``anchor`` the previous frame's state), in one launch."""
    global launches
    if not isinstance(cam, cam_mod.Pinhole):
        raise ValueError(f"pose_inertial_lm takes a Pinhole camera, got {type(cam).__name__}")
    if rounds < 0 or iters < 0:
        raise ValueError(f"pose_inertial_lm: rounds {rounds}, iters {iters}")
    O = X_w.shape[0]
    dev = X_w.device
    keep = []   # the contiguous operands, alive until the launch is enqueued

    def ptr(name, x, shape):
        x = _operand(name, x, shape)
        if x.device.type != "cuda" or x.device != dev:
            raise ValueError(f"pose_inertial_lm: every tensor must lie on one CUDA device, "
                             f"got {x.device} beside {dev}")
        keep.append(x)
        return x.data_ptr()

    def state_ptrs(name, s):
        return [ptr(f"{name}.T_wb", s.T_wb, (4, 4)), ptr(f"{name}.vel", s.vel, (3,)),
                ptr(f"{name}.bg", s.bg, (3,)), ptr(f"{name}.ba", s.ba, (3,))]

    nf = 15 if prior is None else 30
    ptrs = [ptr("T_cb", T_cb, (4, 4))] + state_ptrs("state0", state0) + state_ptrs("anchor",
                                                                                     anchor)
    if prior is None:   # (not read at 15 free dims)
        ptrs += ptrs[5:9] + [ptrs[0], ptrs[0]]
    else:
        ptrs += state_ptrs("prior.state", prior.state) + [
            ptr("prior.H", prior.H, (15, 15)), ptr("prior.weight", prior.weight, ())]
    ptrs += [ptr("pre.dR", pre.dR, (3, 3)), ptr("pre.dV", pre.dV, (3,)),
             ptr("pre.dP", pre.dP, (3,))]
    ptrs += [ptr(f"pre.{n}", getattr(pre, n), (3, 3)) for n in ("JRg", "JVg", "JVa", "JPg", "JPa")]
    ptrs += [ptr("pre.dt", pre.dt, ()), ptr("pre.bg", pre.bg, (3,)), ptr("pre.ba", pre.ba, (3,)),
             ptr("pre.C", pre.C, (15, 15)), ptr("gravity", gravity, (3,)),
             ptr("info_bg", info_bg, ()), ptr("info_ba", info_ba, ()),
             ptr("X_w", X_w, (O, 3)), ptr("uvr", uvr, (O, 3)),
             ptr("inv_sigma2", inv_sigma2, (O,))]
    for name, x in (("stereo", stereo), ("valid", valid)):
        if tuple(x.shape) != (O,) or x.dtype not in (torch.bool, torch.uint8):
            raise ValueError(f"pose_inertial_lm: {name} must be bool [{O}], got {x.dtype} "
                             f"{tuple(x.shape)}")
        if x.device != dev:
            raise ValueError(f"pose_inertial_lm: {name} lies on {x.device}, not {dev}")
        x = x.contiguous().view(torch.uint8)
        keep.append(x)
        ptrs.append(x.data_ptr())
    table = (ctypes.c_uint64 * len(ptrs))(*ptrs)
    out = torch.empty(OUT_FLOATS, dtype=torch.float32, device=dev)
    inliers = torch.empty(O, dtype=torch.uint8, device=dev)
    n_inliers = torch.empty((), dtype=torch.int32, device=dev)
    lib = build.library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    build.check(lib.tc2li_pose_inertial_lm(
        table, len(ptrs), nf, O, cam.fx, cam.fy, cam.cx, cam.cy, cam.bf, int(rounds), int(iters),
        out.data_ptr(), inliers.data_ptr(), n_inliers.data_ptr(), stream), "pose_inertial_lm")
    launches += 1
    s = pi.FrameVIState(T_wb=out[0:16].view(4, 4), vel=out[16:19], bg=out[19:22], ba=out[22:25])
    nxt = pi.FramePrior(state=s, H=out[25:250].view(15, 15), weight=out[251])
    return pi.PoseInertialResult(s, nxt, n_inliers, inliers.view(torch.bool), out[250])
