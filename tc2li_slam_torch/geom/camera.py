"""Pinhole camera model on torch tensors (port of the ``Pinhole`` half of
``tc2li_slam_tpu/geom/camera.py``; the KB8 fisheye model is not ported yet).

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
