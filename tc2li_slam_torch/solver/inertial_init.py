"""Visual-inertial initialization: gravity, scale and bias estimation (port
of ``tc2li_slam_tpu/solver/inertial_init.py``; LocalMapping::InitializeIMU).

1. ``estimate_gravity_direction``: closed-form gravity bootstrap from the
   preintegrated velocity deltas (dirG = -sum R_wb_i dV_i, rotated onto -z).
2. ``inertial_optimization``: Optimizer::InertialOptimization. Keyframe
   poses fixed; gravity direction (2-dof tangent), log-scale, one shared
   gyro and accel bias, and per-KF velocities are estimated from the IMU
   preintegration factors (EdgeInertialGS residuals) with bias priors, by
   damped Gauss-Newton on the Jacobian of the whitened residual vector (the
   problem has 9 + 3K unknowns): one hand-written kernel on the card
   (``ops/kernels/inertial_init.py``), whose plain version on the CPU runs
   ``torch.func.jacfwd`` in a Python loop with the same iteration count.
3. ``apply_scaled_rotation``: Map::ApplyScaledRotation, gravity-align and
   rescale every pose, landmark and velocity, leaving reprojection
   residuals invariant.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..geom import lie
from ..ops.kernels import inertial_init as inertial_init_kernel
from ..tensors import axis_vector, matvec

G_MAG = 9.81


def _rotation_onto(dirG: torch.Tensor) -> torch.Tensor:
    """R with R @ (0, 0, -1) = dirG (a unit vector)."""
    gI = axis_vector(2, -1.0, dirG.device, dirG.dtype)
    v = torch.linalg.cross(gI, dirG)
    nv = torch.linalg.norm(v)
    ang = torch.acos(torch.clamp(torch.dot(gI, dirG), -1.0, 1.0))
    x_axis = axis_vector(0, 1.0, dirG.device, dirG.dtype)
    axis = torch.where(nv > 1e-9, v / torch.clamp(nv, min=1e-9), x_axis)
    return lie.so3_exp(axis * ang)


def estimate_gravity_direction(R_wb, dV, valid) -> torch.Tensor:
    """Initial R_wg with gravity_w ~ R_wg @ (0, 0, -9.81), from body
    rotations R_wb [K, 3, 3] at the keyframes and the preintegrated velocity
    deltas dV [K-1, 3] (factor i: i -> i+1, validity [K-1]): while the mean
    acceleration is ~0, sum_i R_i dV_i ~ -g T."""
    contrib = matvec(R_wb[:-1], dV)
    dirG = -torch.sum(contrib * valid[:, None], dim=0)
    return _rotation_onto(dirG / torch.clamp(torch.linalg.norm(dirG), min=1e-9))


def gravity_to_rwg(g_w: torch.Tensor) -> torch.Tensor:
    """R_wg with g_w ~ R_wg @ (0, 0, -9.81): a known gravity vector (the
    ESEKF's estimate) as the optimization's frame."""
    return _rotation_onto(g_w / torch.clamp(torch.linalg.norm(g_w), min=1e-9))


class InertialInitResult(NamedTuple):
    R_wg: torch.Tensor    # [3, 3] gravity direction (g_w = R_wg @ (0, 0, -9.81))
    scale: torch.Tensor   # scalar
    bg: torch.Tensor      # [3] shared gyro bias
    ba: torch.Tensor      # [3] shared accel bias
    vel: torch.Tensor     # [K, 3] per-KF velocities (world)
    cost: torch.Tensor


def inertial_optimization(T_wb, dR, dV, dP, JRg, JVg, JVa, JPg, JPa, dt, C_inv, bg_lin,
                          ba_lin, valid, R_wg0, vel0, prior_g: float = 1e2,
                          prior_a: float = 1e6, fix_scale: bool = True,
                          fix_gravity: bool = False, iters: int = 20) -> InertialInitResult:
    """The EdgeInertialGS bundle over fixed body poses T_wb [K, 4, 4] and
    the K-1 factors between them (factor i: i -> i+1): gravity direction,
    (scale,) shared biases and velocities, from R_wg0 [3, 3] and vel0 [K, 3].

    ``fix_gravity`` freezes the gravity tangent at ``R_wg0``: with a
    LiDAR-inertial front end the filter's gravity is more accurate than
    what fixed visual poses support.

    CUDA tensors go to the one-launch kernel (``ops/kernels/inertial_init.py``),
    CPU tensors to its plain version; any other device raises."""
    args = (T_wb, dR, dV, dP, JRg, JVg, JVa, JPg, JPa, dt, C_inv, bg_lin, ba_lin, valid, R_wg0,
            vel0, prior_g, prior_a, fix_scale, fix_gravity, iters)
    if T_wb.device.type == "cuda":
        return inertial_init_kernel.inertial_init_gn(*args)
    if T_wb.device.type == "cpu":
        return inertial_init_kernel.inertial_init_plain(*args)
    raise ValueError(f"inertial_optimization: unsupported device {T_wb.device}")


def apply_scaled_rotation(T_cw, lm_pos, vel, R_yw, scale=1.0):
    """Gravity-align + rescale the map, x_y = s R_yw x_w, for camera poses
    T_cw [K, 4, 4], landmarks [L, 3] and velocities [K, 3]. Camera poses
    become R_cy = R_cw R_yw^T, t_cy = s t_cw, which leaves every reprojection
    residual invariant."""
    s = torch.as_tensor(scale, dtype=T_cw.dtype, device=T_cw.device)
    R_cy = T_cw[:, :3, :3] @ R_yw.T
    T_new = lie.se3(R_cy, s * T_cw[:, :3, 3])
    return T_new, s * lm_pos @ R_yw.T, s * vel @ R_yw.T
