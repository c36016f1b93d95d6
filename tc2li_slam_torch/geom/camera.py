"""Batched camera models on torch tensors: pinhole and Kannala-Brandt-8
fisheye (port of ``tc2li_slam_tpu/geom/camera.py``). The pinhole path
assumes rectified, undistorted keypoints; KB8 provides the fisheye math
(projection, iterative unprojection, Jacobian, two-camera triangulation) for
fisheye rigs.

The intrinsics are host scalars rounded to float32 at creation: the JAX
package stores them as f32 device scalars, and a torch op with a Python
scalar computes in the tensor's dtype, so the arithmetic matches without
a device tensor per intrinsic.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


def f32(v) -> float:
    """Round a host scalar to float32 (kept as a Python float)."""
    return float(np.float32(v))


@dataclass(frozen=True)
class Pinhole:
    fx: float
    fy: float
    cx: float
    cy: float
    bf: float      # stereo baseline [m] * fx
    width: float   # image bounds for frustum checks
    height: float

    @staticmethod
    def create(fx, fy, cx, cy, bf=0.0, width=None, height=None) -> "Pinhole":
        if width is None:
            width = 2.0 * float(cx)
        if height is None:
            height = 2.0 * float(cy)
        return Pinhole(*[f32(v) for v in (fx, fy, cx, cy, bf, width, height)])

    @property
    def baseline(self) -> float:
        return float(np.float32(self.bf) / np.float32(self.fx))


def in_image(cam: Pinhole, uv: torch.Tensor, margin: float = 0.0) -> torch.Tensor:
    return ((uv[..., 0] >= -margin) & (uv[..., 0] < cam.width + margin)
            & (uv[..., 1] >= -margin) & (uv[..., 1] < cam.height + margin))


def _z_safe(z):
    return torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)


def project(cam: Pinhole, p_cam: torch.Tensor) -> torch.Tensor:
    """Camera-frame points [..., 3] -> pixels [..., 2] (z <= 0 is garbage;
    callers mask on depth)."""
    z = _z_safe(p_cam[..., 2])
    u = cam.fx * p_cam[..., 0] / z + cam.cx
    v = cam.fy * p_cam[..., 1] / z + cam.cy
    return torch.stack([u, v], dim=-1)


def project_stereo(cam: Pinhole, p_cam: torch.Tensor) -> torch.Tensor:
    """(u_l, v_l, u_r = u_l - bf/z) [..., 3]."""
    uv = project(cam, p_cam)
    z = _z_safe(p_cam[..., 2])
    ur = uv[..., 0] - cam.bf / z
    return torch.cat([uv, ur[..., None]], dim=-1)


def unproject(cam: Pinhole, uv: torch.Tensor, depth: torch.Tensor) -> torch.Tensor:
    x = (uv[..., 0] - cam.cx) / cam.fx
    y = (uv[..., 1] - cam.cy) / cam.fy
    return torch.stack([x * depth, y * depth, depth], dim=-1)


def bearing(cam: Pinhole, uv: torch.Tensor) -> torch.Tensor:
    """Pixels -> unit bearing vectors [..., 3]."""
    d = unproject(cam, uv, torch.ones(uv.shape[:-1], dtype=uv.dtype, device=uv.device))
    return d / torch.linalg.norm(d, dim=-1, keepdim=True)


def project_jac(cam: Pinhole, p_cam: torch.Tensor) -> torch.Tensor:
    """d(u, v)/d(p_cam): [..., 2, 3]."""
    return project_stereo_jac(cam, p_cam)[..., :2, :]


def depth_from_disparity(cam: Pinhole, disparity: torch.Tensor) -> torch.Tensor:
    """Stereo disparity -> depth: z = bf / d."""
    return cam.bf / torch.clamp(disparity, min=1e-6)


def project_stereo_jac(cam: Pinhole, p_cam: torch.Tensor) -> torch.Tensor:
    """d(u_l, v_l, u_r)/d(p_cam): [..., 3, 3]."""
    x, y = p_cam[..., 0], p_cam[..., 1]
    inv_z = 1.0 / _z_safe(p_cam[..., 2])
    inv_z2 = inv_z * inv_z
    zero = torch.zeros_like(x)
    row_u = torch.stack([cam.fx * inv_z, zero, -cam.fx * x * inv_z2], dim=-1)
    row_v = torch.stack([zero, cam.fy * inv_z, -cam.fy * y * inv_z2], dim=-1)
    row_r = torch.stack([cam.fx * inv_z, zero, (-cam.fx * x + cam.bf) * inv_z2], dim=-1)
    return torch.stack([row_u, row_v, row_r], dim=-2)


# ---------------------------------------------------------------------------
# Kannala-Brandt 8-parameter fisheye
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class KannalaBrandt8:
    """Equidistant fisheye with 4 radial terms (host scalars, as ``Pinhole``)."""

    fx: float
    fy: float
    cx: float
    cy: float
    k: tuple[float, float, float, float]   # (k1, k2, k3, k4)

    @staticmethod
    def create(fx, fy, cx, cy, k1, k2, k3, k4) -> "KannalaBrandt8":
        return KannalaBrandt8(f32(fx), f32(fy), f32(cx), f32(cy),
                              tuple(f32(v) for v in (k1, k2, k3, k4)))


def _kb8_theta_d(cam: KannalaBrandt8, theta):
    k1, k2, k3, k4 = cam.k
    t2 = theta * theta
    return theta * (1 + t2 * (k1 + t2 * (k2 + t2 * (k3 + t2 * k4))))


def _kb8_dtheta_d(cam: KannalaBrandt8, theta):
    k1, k2, k3, k4 = cam.k
    t2 = theta * theta
    return 1 + t2 * (3 * k1 + t2 * (5 * k2 + t2 * (7 * k3 + 9 * t2 * k4)))


def kb8_project(cam: KannalaBrandt8, p_cam: torch.Tensor) -> torch.Tensor:
    """KB8 projection: a polynomial in the angle from the optical axis."""
    x, y, z = p_cam[..., 0], p_cam[..., 1], p_cam[..., 2]
    r = torch.sqrt(x * x + y * y)
    theta_d = _kb8_theta_d(cam, torch.atan2(r, z))
    on_axis = r < 1e-9
    scale = torch.where(on_axis, torch.zeros_like(r),
                        theta_d / torch.where(on_axis, torch.ones_like(r), r))
    return torch.stack([cam.fx * x * scale + cam.cx, cam.fy * y * scale + cam.cy], dim=-1)


def kb8_unproject(cam: KannalaBrandt8, uv: torch.Tensor, iters: int = 10) -> torch.Tensor:
    """Pixels -> rays on the unit plane by Newton inversion of the angle
    polynomial, ``iters`` fixed steps over the whole batch."""
    mx = (uv[..., 0] - cam.cx) / cam.fx
    my = (uv[..., 1] - cam.cy) / cam.fy
    theta_d = torch.clamp(torch.sqrt(mx * mx + my * my), max=torch.pi / 2)
    theta = theta_d
    for _ in range(iters):
        df = _kb8_dtheta_d(cam, theta)
        theta = theta - (_kb8_theta_d(cam, theta) - theta_d) / torch.where(
            torch.abs(df) < 1e-9, torch.ones_like(df), df)
    centre = theta_d < 1e-9
    scale = torch.where(centre, torch.ones_like(theta),
                        torch.tan(theta) / torch.where(centre, torch.ones_like(theta), theta_d))
    return torch.stack([mx * scale, my * scale, torch.ones_like(mx)], dim=-1)


def kb8_project_jac(cam: KannalaBrandt8, p_cam: torch.Tensor) -> torch.Tensor:
    """d(u, v)/d(p_cam): [..., 2, 3], in closed form (the reference
    differentiates ``kb8_project``; the same derivative). With
    s = theta_d / r: u = fx x s + cx, v = fy y s + cy. Zero on the optical
    axis, where ``kb8_project`` switches to its constant branch."""
    x, y, z = p_cam[..., 0], p_cam[..., 1], p_cam[..., 2]
    r2 = x * x + y * y
    r = torch.sqrt(r2)
    on_axis = r < 1e-9
    rs = torch.where(on_axis, torch.ones_like(r), r)
    theta = torch.atan2(r, z)
    theta_d = _kb8_theta_d(cam, theta)
    fd = _kb8_dtheta_d(cam, theta)
    d2 = torch.clamp(r2 + z * z, min=1e-24)
    dth_dr, dth_dz = z / d2, -rs / d2            # d theta / d r, d theta / d z
    s = theta_d / rs
    ds_dr = (fd * dth_dr - s) / rs
    ds_dx, ds_dy, ds_dz = ds_dr * x / rs, ds_dr * y / rs, fd * dth_dz / rs
    row_u = cam.fx * torch.stack([s + x * ds_dx, x * ds_dy, x * ds_dz], dim=-1)
    row_v = cam.fy * torch.stack([y * ds_dx, s + y * ds_dy, y * ds_dz], dim=-1)
    J = torch.stack([row_u, row_v], dim=-2)
    return torch.where(on_axis[..., None, None], torch.zeros_like(J), J)


def kb8_triangulate_matches(cam1: KannalaBrandt8, cam2: KannalaBrandt8, uv1, uv2, T_21,
                            sigma2_1, sigma2_2, min_parallax_cos: float = 0.9998,
                            chi2: float = 5.991):
    """Fisheye two-camera stereo triangulation (KannalaBrandt8::
    TriangulateMatches): unproject both views to rays, triangulate through
    the rig extrinsic ``T_21`` (camera 2 from camera 1), and keep a point
    with enough parallax, positive depth in both cameras and a reprojection
    error within ``chi2`` sigmas in both images. ``uv1``, ``uv2`` [N, 2]
    matched keypoints, ``sigma2_*`` [N]. Returns (p_cam1 [N, 3], ok [N])."""
    from . import triangulate as tri

    r1 = kb8_unproject(cam1, uv1)
    r2 = kb8_unproject(cam2, uv2)
    R21 = T_21[:3, :3]
    r2_in1 = r2 @ R21                           # R21^T r2
    cosp = torch.sum(r1 * r2_in1, dim=-1) / torch.clamp(
        torch.linalg.norm(r1, dim=-1) * torch.linalg.norm(r2_in1, dim=-1), min=1e-12)
    ok = cosp < min_parallax_cos
    eye = torch.eye(4, dtype=uv1.dtype, device=uv1.device)
    X1 = tri.triangulate_dlt(r1[:, :2] / r1[:, 2:], r2[:, :2] / r2[:, 2:], eye, T_21)
    X2 = X1 @ R21.T + T_21[:3, 3]
    ok = ok & (X1[:, 2] > 1e-3) & (X2[:, 2] > 1e-3)
    e1 = torch.sum((kb8_project(cam1, X1) - uv1) ** 2, dim=-1)
    e2 = torch.sum((kb8_project(cam2, X2) - uv2) ** 2, dim=-1)
    return X1, ok & (e1 <= chi2 * sigma2_1) & (e2 <= chi2 * sigma2_2)
