"""Reprojection residuals with analytic Jacobians and the Huber weight
(port of the visual half of ``tc2li_slam_tpu/solver/factors.py``).

T_cw is parameterised with a left-multiplicative tangent update
``T <- exp(d) T``, d = (rho, phi); for Xc = T_cw Xw, dXc/dd = [I | -hat(Xc)].
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..geom import camera as cam_mod, lie

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
