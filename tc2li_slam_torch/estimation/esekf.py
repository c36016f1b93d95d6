"""Iterated error-state Kalman filter on the FAST-LIO2 compound manifold
(port of ``tc2li_slam_tpu/estimation/esekf.py``).

The state lives on R^3 x SO(3) x SO(3) x R^3 x R^3 x R^3 x R^3 x S^2:
position, orientation, LiDAR-IMU extrinsic rotation and translation,
velocity, gyro bias, accel bias, gravity, with a 23-dim error state (gravity
has the 2-dof S^2 tangent of MTK's ``S2`` type).

- ``predict`` sends CUDA tensors to the one-launch kernel
  ``ops/kernels/lio.esekf_predict`` and CPU tensors to its plain version, a
  Python loop over the IMU samples given (a sample with ``dt <= 0`` is an
  exact no-op); each step records the pose for scan undistortion.
- ``update_iterated`` is a fixed count of Gauss-Newton/MAP steps
  ``(H^T H / r + L^T P^-1 L) d = -(H^T z / r + L^T P^-1 (x_i - x_0))`` with a
  convergence mask kept on the device; the measurement closure is
  re-evaluated at each iterate (``map_step``, ``posterior_covariance``: a
  step and the final covariance from the normal equations, which the scan
  step's kernels also hold themselves against).
- ``transport_jacobian`` is L = d((x + d) - x0)/dd in closed blocks:
  identity on the Euclidean blocks, the inverse right Jacobian on the SO(3)
  blocks, and the 2x2 S^2 transport by forward-mode differentiation of this
  module's own ``s2_boxplus`` / ``s2_boxminus`` (the reference
  differentiates the whole 23-dim map; the blocks are the same function).

No call checks a solver status on the host (``inv_ex`` / ``solve_ex``).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..geom import lie
from ..ops.kernels import lio as klio
from ..tensors import axis_vector, matvec

ERR_DIM = 23
# error-state slices (pos, rot, extR, extT, vel, bg, ba, grav)
POS = slice(0, 3)
ROT = slice(3, 6)
EXT_R = slice(6, 9)
EXT_T = slice(9, 12)
VEL = slice(12, 15)
BG = slice(15, 18)
BA = slice(18, 21)
GRAV = slice(21, 23)


class State(NamedTuple):
    pos: torch.Tensor    # [3]
    R: torch.Tensor      # [3, 3] world-from-body
    R_LI: torch.Tensor   # [3, 3] body-from-lidar rotation
    t_LI: torch.Tensor   # [3]    body-from-lidar translation
    vel: torch.Tensor    # [3]
    bg: torch.Tensor     # [3]
    ba: torch.Tensor     # [3]
    grav: torch.Tensor   # [3], |grav| fixed (S2)


class Filter(NamedTuple):
    x: State
    P: torch.Tensor      # [23, 23]


def init_state(gravity_mag: float = 9.81, dtype=torch.float32, device="cpu") -> State:
    z3 = torch.zeros(3, dtype=dtype, device=device)
    eye3 = torch.eye(3, dtype=dtype, device=device)
    return State(pos=z3, R=eye3, R_LI=eye3, t_LI=z3, vel=z3, bg=z3, ba=z3,
                 grav=axis_vector(2, -gravity_mag, device, dtype))


def init_filter(gravity_mag: float = 9.81, P0: float = 1e-3, dtype=torch.float32,
                device="cpu") -> Filter:
    d = torch.full((ERR_DIM,), P0, dtype=dtype, device=device)
    # extrinsic and gravity start more certain (FAST-LIO defaults)
    d[EXT_R] = 1e-5
    d[EXT_T] = 1e-5
    d[GRAV] = 1e-4
    return Filter(init_state(gravity_mag, dtype, device), torch.diag(d))


# ---------------------------------------------------------------------------
# S2 manifold helpers (MTK S2 semantics)
# ---------------------------------------------------------------------------

def s2_basis(g: torch.Tensor) -> torch.Tensor:
    """Orthonormal tangent basis B(g) [..., 3, 2] with B^T g = 0, branch-free."""
    # the world axis least aligned with g seeds the basis (index_select: a
    # 0-d index tensor in brackets would be read on the host, a sync)
    k = torch.argmin(torch.abs(g), dim=-1)
    seed = torch.eye(3, dtype=g.dtype, device=g.device).index_select(0, k.reshape(-1)).reshape(
        g.shape)
    b1 = torch.linalg.cross(g, seed)
    b1 = b1 / torch.clamp(torch.linalg.norm(b1, dim=-1, keepdim=True), min=1e-12)
    gn = g / torch.clamp(torch.linalg.norm(g, dim=-1, keepdim=True), min=1e-12)
    b2 = torch.linalg.cross(gn, b1)
    return torch.stack([b1, b2], dim=-1)


def s2_boxplus(g: torch.Tensor, delta2: torch.Tensor) -> torch.Tensor:
    """g + d = Exp(B(g) d) g: rotate g [..., 3] by a tangent perturbation [..., 2]."""
    return matvec(lie.so3_exp(matvec(s2_basis(g), delta2)), g)


def s2_boxminus(g1: torch.Tensor, g0: torch.Tensor) -> torch.Tensor:
    """d such that g0 + d ~ g1: the rotation vector from g0 to g1 in B(g0)
    coordinates, written f(theta) (n0 x n1) with f = theta / sin(theta).

    f is Taylor-switched with a double ``where``, so both the value and the
    forward-mode derivative stay finite on the unselected branch (at
    g1 == g0 the derivative must not vanish: it carries the prior's gravity
    information through ``transport_jacobian``)."""
    n0 = g0 / torch.clamp(torch.linalg.norm(g0, dim=-1, keepdim=True), min=1e-12)
    n1 = g1 / torch.clamp(torch.linalg.norm(g1, dim=-1, keepdim=True), min=1e-12)
    cross = torch.linalg.cross(n0, n1)         # |cross| = sin(theta)
    c = torch.sum(n0 * n1, dim=-1, keepdim=True)
    s2 = torch.sum(cross * cross, dim=-1, keepdim=True)
    small = s2 < 1e-6
    s_safe = torch.sqrt(torch.where(small, torch.ones_like(s2), s2))
    f_exact = torch.atan2(s_safe, c) / s_safe
    f = torch.where(small, 1.0 + s2 / 6.0, f_exact)
    return matvec(s2_basis(g0).transpose(-1, -2), f * cross)


# ---------------------------------------------------------------------------
# boxplus / boxminus on the full state
# ---------------------------------------------------------------------------

def boxplus(x: State, dx: torch.Tensor) -> State:
    return State(
        pos=x.pos + dx[POS],
        R=x.R @ lie.so3_exp(dx[ROT]),
        R_LI=x.R_LI @ lie.so3_exp(dx[EXT_R]),
        t_LI=x.t_LI + dx[EXT_T],
        vel=x.vel + dx[VEL],
        bg=x.bg + dx[BG],
        ba=x.ba + dx[BA],
        grav=s2_boxplus(x.grav, dx[GRAV]),
    )


def boxminus(x1: State, x0: State) -> torch.Tensor:
    return torch.cat([
        x1.pos - x0.pos,
        lie.so3_log(x0.R.T @ x1.R),
        lie.so3_log(x0.R_LI.T @ x1.R_LI),
        x1.t_LI - x0.t_LI,
        x1.vel - x0.vel,
        x1.bg - x0.bg,
        x1.ba - x0.ba,
        s2_boxminus(x1.grav, x0.grav),
    ])


def transport_jacobian(x_new: State, x0: State) -> torch.Tensor:
    """L = d((x_new + d) - x0)/dd at d = 0, [23, 23]: the per-iteration
    tangent-basis re-projection of the reference ESEKF."""
    dtype, dev = x0.pos.dtype, x0.pos.device
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    J_R = lie.so3_right_jacobian_inv(lie.so3_log(x0.R.T @ x_new.R))
    J_RLI = lie.so3_right_jacobian_inv(lie.so3_log(x0.R_LI.T @ x_new.R_LI))
    # with a leading axis of one, so that no intermediate is 0-dimensional:
    # under torch.func a 0-d tensor combined with a Python scalar takes the
    # scalar's float64
    g_new, g0 = x_new.grav[None], x0.grav[None]
    J_g = torch.func.jacfwd(
        lambda d: s2_boxminus(s2_boxplus(g_new, d[None]), g0)[0]
    )(torch.zeros(2, dtype=dtype, device=dev))
    return torch.block_diag(eye3, J_R, J_RLI, eye3, eye3, eye3, eye3, J_g)


# ---------------------------------------------------------------------------
# Predict
# ---------------------------------------------------------------------------

class NoiseCfg(NamedTuple):
    gyr: float      # white gyro noise std
    acc: float      # white accel noise std
    bg_rw: float    # gyro bias random walk std
    ba_rw: float    # accel bias random walk std

    @staticmethod
    def create(gyr=0.1, acc=0.1, bg_rw=1e-4, ba_rw=1e-4) -> "NoiseCfg":
        return NoiseCfg(float(gyr), float(acc), float(bg_rw), float(ba_rw))


def predict(f: Filter, gyro, acc, dts, noise: NoiseCfg):
    """Propagate through an IMU window gyro [N, 3], acc [N, 3], dts [N]
    (<= 0 = padding), per sample. Returns (filter, body_R_traj [N, 3, 3],
    body_p_traj [N, 3]): the pose after each sample, for scan undistortion.

    CUDA tensors go to the one-launch kernel (``ops/kernels/lio.py``
    ``esekf_predict``), CPU tensors to its plain version; any other device
    raises."""
    if gyro.device.type == "cuda":
        return klio.esekf_predict(f, gyro, acc, dts, noise)
    if gyro.device.type == "cpu":
        return klio.predict_plain(f, gyro, acc, dts, noise)
    raise ValueError(f"predict: unsupported device {gyro.device}")


# ---------------------------------------------------------------------------
# Iterated update
# ---------------------------------------------------------------------------

def prior_information(P0: torch.Tensor) -> torch.Tensor:
    """P0^-1 of the iterated update's prior term, with a 1e-9 ridge."""
    eye = torch.eye(ERR_DIM, dtype=P0.dtype, device=P0.device)
    return torch.linalg.inv_ex(P0 + 1e-9 * eye, check_errors=False)[0]


def map_step(HtH, Htz, x_i: State, x0: State, P0_inv, converged, iters, eps: float = 1e-3):
    """One Gauss-Newton/MAP step of the iterated update from the normal
    equations at the iterate (HtH = H^T R^-1 H, Htz = H^T R^-1 z): returns
    (the next iterate, converged, iterations). A converged iterate stays."""
    dx0 = boxminus(x_i, x0)
    # the prior term ||x - x0||^2 linearized in the tangent at the iterate
    # is ||dx0 + L d||^2
    Lj = transport_jacobian(x_i, x0)
    LtP = Lj.T @ P0_inv
    A = HtH + LtP @ Lj
    b = -(Htz + LtP @ dx0)
    delta = torch.linalg.solve_ex(A, b[:, None], check_errors=False)[0][:, 0]
    step_ok = ~converged
    x_next = boxplus(x_i, torch.where(step_ok, delta, 0.0))
    return (x_next, converged | (torch.max(torch.abs(delta)) < eps),
            iters + step_ok.to(torch.int32))


def posterior_covariance(HtH, x_i: State, x0: State, P0_inv) -> torch.Tensor:
    """P = (H^T R^-1 H + L^T P0^-1 L)^-1 in the tangent at x_i, symmetrised."""
    Lf = transport_jacobian(x_i, x0)
    P_new = torch.linalg.inv_ex(HtH + Lf.T @ P0_inv @ Lf, check_errors=False)[0]
    return 0.5 * (P_new + P_new.T)


def update_iterated(f: Filter, h_fn: Callable, meas_noise: float, max_iters: int = 4,
                    eps: float = 1e-3):
    """Iterated MAP update. ``h_fn(state) -> (z [M], H [M, 23], valid [M])``
    re-evaluates the point-to-plane measurement at the current iterate
    (fresh kNN + plane fit each iteration). Returns the updated filter and
    the number of iterations used (a device int32)."""
    x0, P0 = f.x, f.P
    dev = P0.device
    P0_inv = prior_information(P0)
    r_inv = 1.0 / meas_noise

    x_i = x0
    converged = torch.zeros((), dtype=torch.bool, device=dev)
    iters = torch.zeros((), dtype=torch.int32, device=dev)
    for _ in range(max_iters):
        z, H, valid = h_fn(x_i)
        Hw = H * (valid.to(z.dtype) * r_inv)[:, None]
        x_i, converged, iters = map_step(H.T @ Hw, Hw.T @ z, x_i, x0, P0_inv, converged, iters,
                                         eps)

    # covariance in the tangent at the converged state
    z, H, valid = h_fn(x_i)
    HtH = H.T @ (H * (valid.to(z.dtype) * r_inv)[:, None])
    return Filter(x_i, posterior_covariance(HtH, x_i, x0, P0_inv)), iters


# ---------------------------------------------------------------------------
# Static initialization (ImuProcess::IMU_init)
# ---------------------------------------------------------------------------

def static_init(f: Filter, gyro, acc, valid, gravity_mag: float = 9.81) -> Filter:
    """Mean-acc gravity alignment + gyro-bias estimate from a static window."""
    v = valid.to(acc.dtype)
    wsum = torch.clamp(torch.sum(v), min=1)
    mean_acc = torch.sum(acc * v[:, None], dim=0) / wsum
    mean_gyr = torch.sum(gyro * v[:, None], dim=0) / wsum
    g_dir = -mean_acc / torch.clamp(torch.linalg.norm(mean_acc), min=1e-9)
    return f._replace(x=f.x._replace(grav=g_dir * gravity_mag, bg=mean_gyr))
