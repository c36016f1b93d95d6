"""Visual-inertial(-LiDAR) local bundle adjustment over a temporal keyframe
window (port of ``tc2li_slam_tpu/solver/inertial_ba.py``; LocalInertialBA /
LocalLVIBA).

The window's last N keyframes carry a state ``[pose(6) | velocity(3) | gyro
bias(3) | accel bias(3)]`` = 15 dims each, connected by IMU preintegration
factors and bias random-walk factors between consecutive keyframes, mono and
stereo reprojection factors to the window's landmarks, and optionally the
BALM plane eigen-factor over the first ``n_lidar`` poses, injected as a dense
cross-pose quadratic.

The pose tangent is the right-multiplicative se3 (rho, phi), ``T_wb <- T_wb
exp(xi)``, so the BALM body-frame chain rule is one adjoint transport
``Adj(T_lb)`` a pose. Landmarks are Schur-eliminated; the reduced [15P, 15P]
system is dense. ``lvi_ba`` runs the LM loop as a fixed sequence of
hand-written kernels on the card (``ops/kernels/lvi_ba.py``), whose plain
version on the CPU is a Python loop of fixed length with the accept/reject
decision kept on the device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..geom import camera as cam_mod, lie
from ..ops.kernels import lvi_ba as lvi_ba_kernel
from ..tensors import matvec
from . import factors
from .lm import BAObservations

D = 15  # per-KF state dim
POSE = slice(0, 6)   # (rho, phi)
VEL = slice(6, 9)
BG = slice(9, 12)
BA_ = slice(12, 15)


class ImuWindowFactors(NamedTuple):
    """Preintegration between consecutive window KFs (i -> i+1), padded."""

    dR: torch.Tensor     # [P-1, 3, 3]
    dV: torch.Tensor     # [P-1, 3]
    dP: torch.Tensor     # [P-1, 3]
    JRg: torch.Tensor    # [P-1, 3, 3]
    JVg: torch.Tensor
    JVa: torch.Tensor
    JPg: torch.Tensor
    JPa: torch.Tensor
    dt: torch.Tensor     # [P-1]
    C_inv: torch.Tensor  # [P-1, 9, 9] information of (dR, dV, dP)
    bg_lin: torch.Tensor  # [P-1, 3] linearization gyro bias
    ba_lin: torch.Tensor  # [P-1, 3]
    info_bg: torch.Tensor  # [P-1] bias random-walk information scalars
    info_ba: torch.Tensor  # [P-1]
    valid: torch.Tensor  # [P-1]


class InertialState(NamedTuple):
    T_wb: torch.Tensor   # [P, 4, 4]
    vel: torch.Tensor    # [P, 3]
    bg: torch.Tensor     # [P, 3]
    ba: torch.Tensor     # [P, 3]


def _apply_delta(s: InertialState, dx: torch.Tensor) -> InertialState:
    """dx [P, 15] in (rho, phi, v, bg, ba)."""
    return InertialState(T_wb=s.T_wb @ lie.se3_exp(dx[:, POSE]), vel=s.vel + dx[:, VEL],
                         bg=s.bg + dx[:, BG], ba=s.ba + dx[:, BA_])


def body_reprojection(cam, T_cb, T_bw, X_w, uv, stereo):
    """Reprojection through body poses, X_c = T_cb T_bw X_w, for aligned
    [O] rows: (r [O, 3], J_pose [O, 3, 6] w.r.t. the right tangent of T_wb,
    J_lm [O, 3, 3], X_c)."""
    X_b = lie.se3_apply(T_bw, X_w)
    R_cb = lie.rotation(T_cb)
    X_c = X_b @ R_cb.T + lie.translation(T_cb)
    keep = stereo[:, None] | (torch.arange(3, device=X_w.device) < 2)   # mono: row 2 -> 0
    r = torch.where(keep, cam_mod.project_stereo(cam, X_c) - uv, 0.0)
    Jproj = torch.where(keep[:, :, None], cam_mod.project_stereo_jac(cam, X_c), 0.0)
    # dX_b/d(rho, phi) = [-I | hat(X_b)] (right perturbation of T_wb)
    eye = torch.eye(3, dtype=X_b.dtype, device=X_b.device).expand(X_b.shape[:-1] + (3, 3))
    dXb = torch.cat([-eye, lie.hat(X_b)], dim=-1)
    JR = Jproj @ R_cb
    return r, JR @ dXb, JR @ lie.rotation(T_bw), X_c


def _visual_residuals(cam, T_cb, s: InertialState, X_w, obs: BAObservations):
    L, K = obs.pose_idx.shape
    pidx = torch.clamp(obs.pose_idx, 0, s.T_wb.shape[0] - 1).reshape(-1).long()
    T_bw = lie.se3_inverse(s.T_wb)[pidx]
    stereo = obs.stereo.reshape(-1)
    r, J_pose, J_lm, X_c = body_reprojection(
        cam, T_cb, T_bw, X_w.repeat_interleave(K, dim=0), obs.uv.reshape(-1, 3), stereo)
    chi2 = obs.inv_sigma2.reshape(-1) * torch.sum(r * r, dim=-1)
    thresh = torch.where(stereo, factors.CHI2_STEREO, factors.CHI2_MONO)
    active = obs.valid.reshape(-1) & (X_c[:, 2] > 0.05)
    w = obs.inv_sigma2.reshape(-1) * factors.huber_weight(chi2, thresh) * active.to(r.dtype)
    return r, J_pose, J_lm, w, active & (chi2 <= thresh)


def reorder_pose(Jp: torch.Tensor) -> torch.Tensor:
    """[..., 9, 6] pose Jacobian from (phi, dp) to the state's (rho, phi)."""
    return torch.cat([Jp[..., 3:6], Jp[..., 0:3]], dim=-1)


def _imu_terms(s: InertialState, fac: ImuWindowFactors, gravity):
    """IMU + bias random-walk quadratic terms: H [P, P, 15, 15], g [P, 15], cost."""
    P = s.T_wb.shape[0]
    dt_, dev = s.vel.dtype, s.vel.device
    R = lie.rotation(s.T_wb)
    p = lie.translation(s.T_wb)
    bg, ba = s.bg[:-1], s.ba[:-1]
    dbg = bg - fac.bg_lin
    dba = ba - fac.ba_lin
    dR_c = fac.dR @ lie.so3_exp(matvec(fac.JRg, dbg))
    dV_c = fac.dV + matvec(fac.JVg, dbg) + matvec(fac.JVa, dba)
    dP_c = fac.dP + matvec(fac.JPg, dbg) + matvec(fac.JPa, dba)
    o = factors.imu_residual(
        R[:-1], p[:-1], s.vel[:-1], R[1:], p[1:], s.vel[1:], bg, ba, dR_c, dV_c, dP_c,
        fac.JRg, fac.JVg, fac.JVa, fac.JPg, fac.JPa, fac.dt, fac.C_inv, gravity)

    J1 = torch.cat([reorder_pose(o.J1_pose), o.J1_vel, o.J_bg, o.J_ba], dim=-1)  # [P-1, 9, 15]
    Z93 = torch.zeros_like(o.J_bg)
    J2 = torch.cat([reorder_pose(o.J2_pose), o.J2_vel, Z93, Z93], dim=-1)
    w = fac.valid.to(dt_)
    info = o.info * w[:, None, None]
    IJ1 = info @ J1
    IJ2 = info @ J2
    H12 = J1.transpose(-1, -2) @ IJ2
    i1 = torch.arange(P - 1, device=dev)
    i2 = i1 + 1
    H = torch.zeros((P, P, D, D), dtype=dt_, device=dev)
    g = torch.zeros((P, D), dtype=dt_, device=dev)
    # the bias random-walk factors fold into the same four blocks
    rbg = s.bg[1:] - s.bg[:-1]
    rba = s.ba[1:] - s.ba[:-1]
    wg = fac.info_bg * w
    wa = fac.info_ba * w
    Hrw = torch.zeros((P - 1, D, D), dtype=dt_, device=dev)
    Hrw[:, BG, BG] = wg[:, None, None] * torch.eye(3, dtype=dt_, device=dev)
    Hrw[:, BA_, BA_] = wa[:, None, None] * torch.eye(3, dtype=dt_, device=dev)
    grw = torch.zeros((P - 1, D), dtype=dt_, device=dev)
    grw[:, BG] = wg[:, None] * rbg
    grw[:, BA_] = wa[:, None] * rba
    H.index_put_((i1, i1), J1.transpose(-1, -2) @ IJ1 + Hrw, accumulate=True)
    H.index_put_((i1, i2), H12 - Hrw, accumulate=True)
    H.index_put_((i2, i1), H12.transpose(-1, -2) - Hrw, accumulate=True)
    H.index_put_((i2, i2), J2.transpose(-1, -2) @ IJ2 + Hrw, accumulate=True)
    g.index_put_((i1,), matvec(IJ1.transpose(-1, -2), o.r) - grw, accumulate=True)
    g.index_put_((i2,), matvec(IJ2.transpose(-1, -2), o.r) + grw, accumulate=True)
    cost = (torch.sum(o.r * matvec(info, o.r)) + torch.sum(wg * torch.sum(rbg * rbg, -1))
            + torch.sum(wa * torch.sum(rba * rba, -1)))
    return H, g, cost


class LviBaResult(NamedTuple):
    state: InertialState
    X_w: torch.Tensor
    cost: torch.Tensor
    obs_inlier: torch.Tensor


def lvi_ba(cam: cam_mod.Pinhole, T_cb, state0: InertialState, X_w0, obs: BAObservations,
           imu_fac: ImuWindowFactors, fixed, valid_lm, gravity, balm_clusters=None,
           T_bl=None, w_lidar: float = 0.01, iters: int = 8, use_balm: bool = False,
           n_lidar: int = 0) -> LviBaResult:
    """LocalLVIBA: temporal-window inertial BA + reprojection + the BALM
    edge. ``state0`` holds the [P] window states in temporal order, ``T_cb``
    the camera-from-body extrinsic, ``fixed`` [P] the anchored poses,
    ``balm_clusters`` the voxel clusters over the first ``n_lidar`` poses
    and ``T_bl`` the body-from-lidar extrinsic.

    CUDA tensors go to the kernel sequence (``ops/kernels/lvi_ba.py``), CPU
    tensors to its plain version; any other device raises."""
    args = (cam, T_cb, state0, X_w0, obs, imu_fac, fixed, valid_lm, gravity, balm_clusters,
            T_bl, w_lidar, iters, use_balm, n_lidar)
    if X_w0.device.type == "cuda":
        return lvi_ba_kernel.lvi_ba_lm(*args)
    if X_w0.device.type == "cpu":
        return lvi_ba_kernel.lvi_ba_plain(*args)
    raise ValueError(f"lvi_ba: unsupported device {X_w0.device}")
