"""Residuals with analytic Jacobians for the factor-graph optimizers (port
of ``tc2li_slam_tpu/solver/factors.py``): reprojection with the Huber
weight, the IMU preintegration factor and the bias random walk.

Visual problems parameterise T_cw with a left-multiplicative tangent update
``T <- exp(d) T``, d = (rho, phi); for Xc = T_cw Xw, dXc/dd = [I | -hat(Xc)].
Inertial problems parameterise the body pose T_wb with a
right-multiplicative update (``R <- R Exp(phi)``, ``p <- p + R dp``) plus
velocity and bias vectors.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..geom import camera as cam_mod, lie
from ..tensors import matvec

CHI2_MONO = 5.991
CHI2_STEREO = 7.815


def huber_weight(chi2: torch.Tensor, delta2) -> torch.Tensor:
    """rho'(chi2) for the Huber kernel with squared threshold ``delta2``."""
    return torch.where(chi2 <= delta2, torch.ones_like(chi2),
                       torch.sqrt(delta2 / torch.clamp(chi2, min=1e-12)))


class ReprojResult(NamedTuple):
    r: torch.Tensor        # [O, 3] residuals (third zero for mono)
    J_pose: torch.Tensor   # [O, 3, 6]
    J_lm: torch.Tensor     # [O, 3, 3]
    chi2: torch.Tensor     # [O]
    depth_ok: torch.Tensor  # [O]


def reproj_residuals(cam: cam_mod.Pinhole, T_cw, X_w, uv_obs, inv_sigma2, stereo) -> ReprojResult:
    """Mono + stereo reprojection residuals (predicted - observed)."""
    Xc = lie.se3_apply(T_cw, X_w)
    pred = cam_mod.project_stereo(cam, Xc)
    r = pred - uv_obs
    keep = stereo[:, None] | (torch.arange(3, device=r.device) < 2)   # mono: row 2 -> 0
    r = torch.where(keep, r, 0.0)
    Jproj = cam_mod.project_stereo_jac(cam, Xc)
    Jproj = torch.where(keep[:, :, None], Jproj, 0.0)
    eye = torch.eye(3, dtype=Xc.dtype, device=Xc.device).expand(Xc.shape[:-1] + (3, 3))
    dX_dpose = torch.cat([eye, -lie.hat(Xc)], dim=-1)
    J_pose = Jproj @ dX_dpose
    J_lm = Jproj @ lie.rotation(T_cw)
    chi2 = inv_sigma2 * torch.sum(r * r, dim=-1)
    depth_ok = Xc[..., 2] > 0.05
    return ReprojResult(r, J_pose, J_lm, chi2, depth_ok)


# ---------------------------------------------------------------------------
# IMU preintegration factor (T_wb parameterisation)
# ---------------------------------------------------------------------------

class ImuFactorResult(NamedTuple):
    r: torch.Tensor        # [..., 9] (er, ev, ep)
    J1_pose: torch.Tensor  # [..., 9, 6] w.r.t. (phi1, dp1)
    J1_vel: torch.Tensor   # [..., 9, 3]
    J_bg: torch.Tensor     # [..., 9, 3]
    J_ba: torch.Tensor     # [..., 9, 3]
    J2_pose: torch.Tensor  # [..., 9, 6]
    J2_vel: torch.Tensor   # [..., 9, 3]
    info: torch.Tensor     # [..., 9, 9] information (inverse preintegration cov)


def imu_residual(R1, p1, v1, R2, p2, v2, bg, ba, dR_c, dV_c, dP_c,
                 JRg, JVg, JVa, JPg, JPa, dt, C9_inv, gravity) -> ImuFactorResult:
    """EdgeInertial residual with its Jacobians, over any leading batch
    dimensions (``dt`` is [...], ``gravity`` [3]); dR_c, dV_c, dP_c are the
    bias-corrected preintegrated deltas:

        er = Log(dR_c^T R1^T R2)
        ev = R1^T (v2 - v1 - g dt) - dV_c
        ep = R1^T (p2 - p1 - v1 dt - 0.5 g dt^2) - dP_c
    """
    del bg, ba   # they enter through the corrected deltas
    R1t = R1.transpose(-1, -2)
    dt1 = dt[..., None]
    eR = dR_c.transpose(-1, -2) @ R1t @ R2
    er = lie.so3_log(eR)
    dv_w = v2 - v1 - gravity * dt1
    dp_w = p2 - p1 - v1 * dt1 - 0.5 * gravity * dt1 * dt1
    ev = matvec(R1t, dv_w) - dV_c
    ep = matvec(R1t, dp_w) - dP_c
    r = torch.cat([er, ev, ep], dim=-1)

    invJr = lie.so3_right_jacobian_inv(er)
    z3 = torch.zeros_like(R1)
    eye3 = torch.eye(3, dtype=R1.dtype, device=R1.device).expand(R1.shape)

    def rows(*blocks):      # three [..., 3, n] blocks stacked to [..., 9, n]
        return torch.cat(blocks, dim=-2)

    # phi1 (R1 <- R1 Exp(phi1)) and dp1 (p1 <- p1 + R1 dp1)
    J1_pose = torch.cat([
        rows(-invJr @ (R2.transpose(-1, -2) @ R1), lie.hat(matvec(R1t, dv_w)),
             lie.hat(matvec(R1t, dp_w))),
        rows(z3, z3, -eye3)], dim=-1)
    J1_vel = rows(z3, -R1t, -R1t * dt[..., None, None])
    # the biases act through the corrected deltas; the inner Jr(JRg db) is
    # ~I between relinearizations, as in the reference
    J_bg = rows(-invJr @ eR.transpose(-1, -2) @ JRg, -JVg, -JPg)
    J_ba = rows(z3, -JVa, -JPa)
    J2_pose = torch.cat([rows(invJr, z3, z3), rows(z3, z3, R1t @ R2)], dim=-1)
    J2_vel = rows(z3, R1t, z3)
    return ImuFactorResult(r, J1_pose, J1_vel, J_bg, J_ba, J2_pose, J2_vel, C9_inv)


def bias_rw_residual(bg1, ba1, bg2, ba2, info_g, info_a):
    """EdgeGyroRW / EdgeAccRW: random-walk residual between consecutive KFs."""
    return bg2 - bg1, ba2 - ba1, info_g, info_a
