"""Visual-inertial initialization: gravity, scale and bias estimation (port
of ``tc2li_slam_tpu/solver/inertial_init.py``; LocalMapping::InitializeIMU).

1. ``estimate_gravity_direction``: closed-form gravity bootstrap from the
   preintegrated velocity deltas (dirG = -sum R_wb_i dV_i, rotated onto -z).
2. ``inertial_optimization``: Optimizer::InertialOptimization. Keyframe
   poses fixed; gravity direction (2-dof tangent), log-scale, one shared
   gyro and accel bias, and per-KF velocities are estimated from the IMU
   preintegration factors (EdgeInertialGS residuals) with bias priors, by
   damped Gauss-Newton on the Jacobian of the whitened residual vector
   (``torch.func.jacfwd``: the problem has 9 + 3K unknowns).
3. ``apply_scaled_rotation``: Map::ApplyScaledRotation, gravity-align and
   rescale every pose, landmark and velocity, leaving reprojection
   residuals invariant.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..geom import lie
from ..tensors import axis_vector, matvec
from .lm import precond_solve

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
    what fixed visual poses support."""
    K = T_wb.shape[0]
    R_wb, p_wb = T_wb[:, :3, :3], T_wb[:, :3, 3]
    dtype, dev = T_wb.dtype, T_wb.device
    n_x = 9 + 3 * K
    # layout: x[0:2] gravity tangent, x[2] log-scale, x[3:6] bg, x[6:9] ba,
    # x[9:] velocities
    x = torch.cat([torch.zeros(9, dtype=dtype, device=dev), vel0.reshape(-1)])
    sqrt_pg, sqrt_pa = float(prior_g) ** 0.5, float(prior_a) ** 0.5
    g_I = axis_vector(2, -G_MAG, dev, dtype)
    eye9 = torch.eye(9, dtype=dtype, device=dev)
    eyeN = torch.eye(n_x, dtype=dtype, device=dev)
    # whitening by the Cholesky factor of the preintegration information
    Lt = torch.linalg.cholesky_ex(C_inv + 1e-6 * eye9, check_errors=False)[0].transpose(-1, -2)
    vw = valid.to(dtype)[:, None]
    R1t = R_wb[:-1].transpose(-1, -2)
    dp12 = p_wb[1:] - p_wb[:-1]
    dt1 = dt[:, None]
    # coordinates held fixed: their rows and columns of H become the identity
    frozen = ([2] if fix_scale else []) + ([0, 1] if fix_gravity else [])
    keep = torch.ones(n_x, dtype=dtype, device=dev)
    for c in frozen:
        keep[c:c + 1].fill_(0.0)   # (a scalar assigned to one slot is a host copy)

    def residuals(x):
        # (leading axes of one keep 0-d tensors out of the differentiated
        # code: under torch.func they take a Python scalar's float64)
        phi = torch.cat([x[0:2], torch.zeros(1, dtype=dtype, device=dev)])[None]
        g_w = (R_wg0 @ lie.so3_exp(phi)[0]) @ g_I        # VertexGDir 2-dof update
        s = 1.0 if fix_scale else torch.exp(x[2:3])
        bg, ba = x[3:6], x[6:9]
        vel = x[9:].reshape(K, 3)
        v1, v2 = vel[:-1], vel[1:]
        # exact bias re-correction of the preintegrated deltas
        dbg, dba = bg - bg_lin, ba - ba_lin
        dR_c = dR @ lie.so3_exp(matvec(JRg, dbg))
        dV_c = dV + matvec(JVg, dbg) + matvec(JVa, dba)
        dP_c = dP + matvec(JPg, dbg) + matvec(JPa, dba)
        er = lie.so3_log(dR_c.transpose(-1, -2) @ R1t @ R_wb[1:])
        ev = matvec(R1t, s * (v2 - v1) - g_w * dt1) - dV_c
        ep = matvec(R1t, s * (dp12 - v1 * dt1) - 0.5 * g_w * dt1 * dt1) - dP_c
        r_fac = matvec(Lt, torch.cat([er, ev, ep], dim=-1)) * vw
        return torch.cat([r_fac.reshape(-1), sqrt_pg * bg, sqrt_pa * ba])

    def cost_of(x):
        return torch.sum(residuals(x) ** 2)

    jac = torch.func.jacfwd(residuals)
    lam = torch.full((), 1e-4, dtype=dtype, device=dev)
    cost = cost_of(x)
    for _ in range(iters):
        r = residuals(x)
        J = jac(x)
        H = J.T @ J
        g = J.T @ r
        if frozen:
            H = H * keep[:, None] * keep[None, :] + torch.diag(1.0 - keep)
            g = g * keep
        Haug = H + lam * torch.diag(torch.diagonal(H)) + 1e-9 * eyeN
        # Jacobi-preconditioned: whitened IMU residual Jacobians are 1e3 and
        # more while the gravity-tangent columns are O(1)
        x_new = x - precond_solve(Haug, g)
        cost_new = cost_of(x_new)
        accept = cost_new < cost
        x = torch.where(accept, x_new, x)
        lam = torch.where(accept, lam * 0.5, lam * 4.0)
        cost = torch.where(accept, cost_new, cost)

    phi = torch.cat([x[0:2], torch.zeros(1, dtype=dtype, device=dev)])
    return InertialInitResult(
        R_wg=R_wg0 @ lie.so3_exp(phi),
        scale=torch.ones((), dtype=dtype, device=dev) if fix_scale else torch.exp(x[2]),
        bg=x[3:6], ba=x[6:9], vel=x[9:].reshape(K, 3), cost=cost)


def apply_scaled_rotation(T_cw, lm_pos, vel, R_yw, scale=1.0):
    """Gravity-align + rescale the map, x_y = s R_yw x_w, for camera poses
    T_cw [K, 4, 4], landmarks [L, 3] and velocities [K, 3]. Camera poses
    become R_cy = R_cw R_yw^T, t_cy = s t_cw, which leaves every reprojection
    residual invariant."""
    s = torch.as_tensor(scale, dtype=T_cw.dtype, device=T_cw.device)
    R_cy = T_cw[:, :3, :3] @ R_yw.T
    T_new = lie.se3(R_cy, s * T_cw[:, :3, 3])
    return T_new, s * lm_pos @ R_yw.T, s * vel @ R_yw.T
