"""Tightly-coupled visual-inertial single-frame pose tracking (port of
``tc2li_slam_tpu/solver/pose_inertial.py``).

In IMU mode every frame's pose is optimised against both the reprojection
factors and the IMU preintegration factor from an anchor state, so tracking
holds through visually starved stretches
(PoseInertialOptimizationLastKeyFrame / ...LastFrame with the
ConstraintPoseImu marginalization prior).

State per frame: x = [rho, phi, v, bg, ba] (15), right-multiplicative pose
update ``T_wb <- T_wb exp(xi)`` (the convention of ``solver/inertial_ba``).

- ``optimize_last_kf``: the anchor is the last keyframe's state, held
  fixed; only the frame's 15 dims are free. Used on the first frame after
  a map update.
- ``optimize_last_frame``: the anchor is the previous frame, free but held
  by its marginalization prior; the joint 30-dim system is solved and the
  previous frame is Schur-marginalized out of the final Hessian to give the
  next prior.

Both return the frame's information matrix at the solution, the next
frame's ``FramePrior``. On the card each call is one hand-written kernel
(``ops/kernels/pose_inertial.py``); on the CPU the plain version's loops
are Python loops of fixed length. Accept/reject stays on the device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..estimation import imu as imu_est
from ..geom import camera as cam_mod, lie
from ..ops.kernels import pose_inertial as kpi
from . import factors
from .inertial_ba import BA_, BG, D, POSE, VEL, body_reprojection, reorder_pose


class FrameVIState(NamedTuple):
    """15-dof frame state in the world/body convention of inertial_ba."""

    T_wb: torch.Tensor   # [4, 4]
    vel: torch.Tensor    # [3]
    bg: torch.Tensor     # [3]
    ba: torch.Tensor     # [3]


class FramePrior(NamedTuple):
    """ConstraintPoseImu: linearization state + information; ``weight``
    zeroes the prior when it is invalid or stale."""

    state: FrameVIState
    H: torch.Tensor       # [15, 15]
    weight: torch.Tensor  # [] 0.0 or 1.0

    @staticmethod
    def empty(dtype=torch.float32, device="cpu") -> "FramePrior":
        z3 = torch.zeros(3, dtype=dtype, device=device)
        return FramePrior(
            state=FrameVIState(torch.eye(4, dtype=dtype, device=device), z3, z3, z3),
            H=torch.zeros((D, D), dtype=dtype, device=device),
            weight=torch.zeros((), dtype=dtype, device=device))


def _apply(s: FrameVIState, dx: torch.Tensor) -> FrameVIState:
    return FrameVIState(T_wb=s.T_wb @ lie.se3_exp(dx[POSE]), vel=s.vel + dx[VEL],
                        bg=s.bg + dx[BG], ba=s.ba + dx[BA_])


def _select(accept, new: FrameVIState, old: FrameVIState) -> FrameVIState:
    return FrameVIState(*[torch.where(accept, a, b) for a, b in zip(new, old)])


def _prior_terms(s: FrameVIState, prior: FramePrior):
    """EdgePriorPoseImu: r = [Log(R_l^T R); R_l^T (p - p_l); v - v_l;
    bg - bg_l; ba - ba_l], J the identity up to the rotation log's Jr^-1 and
    the position block."""
    R, p = s.T_wb[:3, :3], s.T_wb[:3, 3]
    Rl, pl = prior.state.T_wb[:3, :3], prior.state.T_wb[:3, 3]
    er = lie.so3_log(Rl.T @ R)
    r = torch.cat([er, Rl.T @ (p - pl), s.vel - prior.state.vel,
                   s.bg - prior.state.bg, s.ba - prior.state.ba])
    # x = [rho, phi, ...] while r = [er, ep, ...]: rows er depend on phi
    # only (Jr^-1), rows ep on rho only (R_l^T R)
    z3 = torch.zeros((3, 3), dtype=r.dtype, device=r.device)
    J = torch.block_diag(
        torch.cat([torch.cat([z3, lie.so3_right_jacobian_inv(er)], dim=1),
                   torch.cat([Rl.T @ R, z3], dim=1)], dim=0),
        torch.eye(9, dtype=r.dtype, device=r.device))
    H = prior.H * prior.weight
    return J.T @ H @ J, J.T @ (H @ r), r @ H @ r


def _visual_terms(cam, T_cb, s: FrameVIState, X_w, uvr, inv_sigma2, stereo, valid, gate: bool):
    """Reprojection quadratic on the single body pose (OnlyPose edges)."""
    T_bw = lie.se3_inverse(s.T_wb)
    r, J_pose, _, X_c = body_reprojection(cam, T_cb, T_bw, X_w, uvr, stereo)
    chi2 = inv_sigma2 * torch.sum(r * r, dim=-1)
    thresh = torch.where(stereo, factors.CHI2_STEREO, factors.CHI2_MONO)
    active = valid & (X_c[:, 2] > 0.05)
    if gate:
        active = active & (chi2 <= thresh)
    w = inv_sigma2 * factors.huber_weight(chi2, thresh) * active.to(r.dtype)
    Jw = J_pose * w[:, None, None]
    H6 = torch.einsum("oij,oik->jk", Jw, J_pose)
    g6 = torch.einsum("oij,oi->j", Jw, r)
    cost = torch.sum(w * torch.sum(r * r, dim=-1))
    return H6, g6, cost, active & (chi2 <= thresh)


def _imu_pair_terms(anchor: FrameVIState, s: FrameVIState, pre: imu_est.Preintegrated,
                    C9_inv, gravity, info_bg, info_ba):
    """EdgeInertial + bias random walk for the (anchor -> frame) pair:
    H/g blocks of the 30-dim [anchor | frame] layout plus the cost. The
    preintegration is corrected at the frame's bias (the frame owns the
    bias vertices); ``C9_inv`` is the information of ``pre``."""
    R1, p1 = anchor.T_wb[:3, :3], anchor.T_wb[:3, 3]
    R2, p2 = s.T_wb[:3, :3], s.T_wb[:3, 3]
    dbg = s.bg - pre.bg
    dba = s.ba - pre.ba
    dR_c = pre.dR @ lie.so3_exp(pre.JRg @ dbg)
    dV_c = pre.dV + pre.JVg @ dbg + pre.JVa @ dba
    dP_c = pre.dP + pre.JPg @ dbg + pre.JPa @ dba
    out = factors.imu_residual(
        R1, p1, anchor.vel, R2, p2, s.vel, s.bg, s.ba, dR_c, dV_c, dP_c,
        pre.JRg, pre.JVg, pre.JVa, pre.JPg, pre.JPa, pre.dt, C9_inv, gravity)
    Z93 = torch.zeros((9, 3), dtype=R1.dtype, device=R1.device)
    # the anchor owns no bias dims in this factor
    J1 = torch.cat([reorder_pose(out.J1_pose), out.J1_vel, Z93, Z93], dim=-1)
    J2 = torch.cat([reorder_pose(out.J2_pose), out.J2_vel, out.J_bg, out.J_ba], dim=-1)
    IJ1 = out.info @ J1
    IJ2 = out.info @ J2
    # bias random walk between the anchor's bias and the frame's (the anchor
    # side is data: it adds to the frame diagonal only)
    rbg = s.bg - anchor.bg
    rba = s.ba - anchor.ba
    eye3 = torch.eye(3, dtype=R1.dtype, device=R1.device)
    z9 = torch.zeros(9, dtype=R1.dtype, device=R1.device)
    H22 = J2.T @ IJ2 + torch.block_diag(torch.zeros_like(out.info), info_bg * eye3,
                                        info_ba * eye3)
    g2 = IJ2.T @ out.r + torch.cat([z9, info_bg * rbg, info_ba * rba])
    cost = out.r @ out.info @ out.r + info_bg * (rbg @ rbg) + info_ba * (rba @ rba)
    return J1.T @ IJ1, J1.T @ IJ2, H22, IJ1.T @ out.r, g2, cost


def _pre_info(pre: imu_est.Preintegrated) -> torch.Tensor:
    C9 = pre.C[:9, :9] + 1e-10 * torch.eye(9, dtype=pre.C.dtype, device=pre.C.device)
    return torch.linalg.inv_ex(C9, check_errors=False)[0]


def _pad_pose(H6, g6):
    """[6, 6], [6] of the pose block as [15, 15], [15]."""
    return (torch.nn.functional.pad(H6, (0, D - 6, 0, D - 6)),
            torch.nn.functional.pad(g6, (0, D - 6)))


class PoseInertialResult(NamedTuple):
    state: FrameVIState
    prior: FramePrior        # marginalized prior for the next frame
    n_inliers: torch.Tensor
    inliers: torch.Tensor    # [O]
    cost: torch.Tensor


def optimize_last_kf(cam: cam_mod.Pinhole, T_cb, state0: FrameVIState, kf_state: FrameVIState,
                     pre: imu_est.Preintegrated, gravity, X_w, uvr, inv_sigma2, stereo, valid,
                     info_bg, info_ba, rounds: int = 2, iters: int = 6) -> PoseInertialResult:
    """PoseInertialOptimizationLastKeyFrame: ``kf_state`` is the fixed
    anchor, ``pre`` the keyframe -> frame preintegration, X_w [O, 3] the
    matched landmarks with observations uvr [O, 3].

    CUDA tensors go to the one-launch kernel (``ops/kernels/pose_inertial.py``,
    15 free dims), CPU tensors to its plain version; any other device raises."""
    args = (cam, T_cb, state0, kf_state, pre, gravity, X_w, uvr, inv_sigma2, stereo, valid,
            info_bg, info_ba)
    if X_w.device.type == "cuda":
        return kpi.pose_inertial_lm(cam, T_cb, state0, kf_state, None, *args[4:], rounds, iters)
    if X_w.device.type == "cpu":
        return kpi.optimize_last_kf_plain(*args, rounds, iters)
    raise ValueError(f"optimize_last_kf: unsupported device {X_w.device}")


def optimize_last_frame(cam: cam_mod.Pinhole, T_cb, state0: FrameVIState,
                        prev_state: FrameVIState, prev_prior: FramePrior,
                        pre: imu_est.Preintegrated, gravity, X_w, uvr, inv_sigma2, stereo,
                        valid, info_bg, info_ba, rounds: int = 2,
                        iters: int = 6) -> PoseInertialResult:
    """PoseInertialOptimizationLastFrame: joint 30-dim solve over
    [prev | cur] with the prior on prev, then prev is Schur-marginalized
    out of the final Hessian to form the next frame's prior.

    CUDA tensors go to the one-launch kernel (``ops/kernels/pose_inertial.py``,
    30 free dims), CPU tensors to its plain version; any other device raises."""
    args = (cam, T_cb, state0, prev_state, prev_prior, pre, gravity, X_w, uvr, inv_sigma2,
            stereo, valid, info_bg, info_ba)
    if X_w.device.type == "cuda":
        return kpi.pose_inertial_lm(*args, rounds, iters)
    if X_w.device.type == "cpu":
        return kpi.optimize_last_frame_plain(*args, rounds, iters)
    raise ValueError(f"optimize_last_frame: unsupported device {X_w.device}")
