"""IMU preintegration on the manifold (port of
``tc2li_slam_tpu/estimation/imu.py``).

Delta rotation / velocity / position between two frames or keyframes, the
15x15 covariance of the preintegrated error (dR, dV, dP, bg, ba ordering,
the residual layout of ``EdgeInertial``) and the five bias Jacobians (JRg,
JVg, JVa, JPg, JPa) used for first-order bias correction without
re-integration.

The reference integrates a padded window in one ``lax.scan``; here the loop
is a Python loop of small device ops, one pass per sample given. A sample
with ``dt <= 0`` is an exact no-op (its inputs are zeroed first, and every
update term carries a factor ``dt``), so a caller that knows on the host
which samples are real passes only those and saves the launches.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..geom import lie
from ..tensors import axis_vector

GRAVITY = 9.81


class ImuCalib(NamedTuple):
    """Noise densities (discrete, per sample) and the body-from-camera
    extrinsic (``IMU::Calib``). The sigmas are host floats."""

    sigma_g: float    # gyro white noise [rad/s]
    sigma_a: float    # accel white noise [m/s^2]
    sigma_gw: float   # gyro bias random walk
    sigma_aw: float   # accel bias random walk
    Tbc: torch.Tensor  # [4, 4] camera -> body

    @staticmethod
    def create(sigma_g, sigma_a, sigma_gw, sigma_aw, Tbc=None, device="cpu") -> "ImuCalib":
        if Tbc is None:
            Tbc = torch.eye(4, dtype=torch.float32, device=device)
        return ImuCalib(float(sigma_g), float(sigma_a), float(sigma_gw), float(sigma_aw),
                        torch.as_tensor(Tbc, dtype=torch.float32).to(device))


class Preintegrated(NamedTuple):
    """Preintegrated deltas between t_i and t_j at linearization bias b."""

    dR: torch.Tensor    # [3, 3]
    dV: torch.Tensor    # [3]
    dP: torch.Tensor    # [3]
    C: torch.Tensor     # [15, 15] covariance (dR, dV, dP, bg, ba)
    JRg: torch.Tensor   # [3, 3] d dR / d bg
    JVg: torch.Tensor
    JVa: torch.Tensor
    JPg: torch.Tensor
    JPa: torch.Tensor
    dt: torch.Tensor    # [] total time
    bg: torch.Tensor    # [3] linearization gyro bias
    ba: torch.Tensor    # [3] linearization accel bias


def identity_preintegrated(dtype=torch.float32, device="cpu") -> Preintegrated:
    z3 = torch.zeros(3, dtype=dtype, device=device)
    z33 = torch.zeros((3, 3), dtype=dtype, device=device)
    return Preintegrated(
        dR=torch.eye(3, dtype=dtype, device=device), dV=z3, dP=z3,
        C=torch.zeros((15, 15), dtype=dtype, device=device),
        JRg=z33, JVg=z33, JVa=z33, JPg=z33, JPa=z33,
        dt=torch.zeros((), dtype=dtype, device=device), bg=z3, ba=z3)


def integrate(calib: ImuCalib, gyro, acc, dts, bg, ba) -> Preintegrated:
    """Integrate an IMU window (``IntegrateNewMeasurement``): gyro [N, 3]
    body rates, acc [N, 3] specific force, dts [N] (<= 0 for padding), at
    the linearization biases bg, ba [3].

    Covariance propagation is the discrete A/B form of Forster et al. on
    (dR, dV, dP); the bias random-walk block accumulates on its own."""
    dtype, dev = gyro.dtype, gyro.device
    Ng2, Na2 = calib.sigma_g ** 2, calib.sigma_a ** 2
    Ngw2, Naw2 = calib.sigma_gw ** 2, calib.sigma_aw ** 2
    active = dts > 0
    dts = torch.where(active, dts, 0.0)
    # a padded sample integrates at the bias itself: w_ub = a_ub = 0
    w_ub_all = torch.where(active[:, None], gyro - bg, 0.0)
    a_ub_all = torch.where(active[:, None], acc - ba, 0.0)
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    walk = torch.cat([torch.full((3,), Ngw2, dtype=dtype, device=dev),
                      torch.full((3,), Naw2, dtype=dtype, device=dev)])
    noise = torch.cat([torch.full((3,), Ng2, dtype=dtype, device=dev),
                       torch.full((3,), Na2, dtype=dtype, device=dev)])
    Nga_all = noise[None, :] / torch.clamp(dts, min=1e-9)[:, None]     # [N, 6]
    dRi_all = lie.so3_exp(w_ub_all * dts[:, None])                     # [N, 3, 3]
    Jr_all = lie.so3_right_jacobian(w_ub_all * dts[:, None])
    a_hat_all = lie.hat(a_ub_all)

    p = identity_preintegrated(dtype, dev)
    dR, dV, dP = p.dR, p.dV, p.dP
    JRg, JVg, JVa, JPg, JPa = p.JRg, p.JVg, p.JVa, p.JPg, p.JPa
    C9 = torch.zeros((9, 9), dtype=dtype, device=dev)
    for i in range(gyro.shape[0]):
        dt = dts[i]
        dt2 = dt * dt
        a_ub, dRi, Jr = a_ub_all[i], dRi_all[i], Jr_all[i]
        Ra = dR @ a_ub
        Rah = dR @ a_hat_all[i]
        # position and velocity first, with the current dR; then the bias
        # Jacobians, all before the rotation update (the reference's order)
        dP = dP + dV * dt + 0.5 * Ra * dt2
        dV = dV + Ra * dt
        JPa = JPa - 0.5 * dR * dt2
        JPg = JPg + JVg * dt - 0.5 * Rah @ JRg * dt2
        JVa = JVa - dR * dt
        JVg = JVg - Rah @ JRg * dt

        # covariance: x = (dR, dV, dP); A [9, 9], B [9, 6] with noise (g, a)
        A = torch.zeros((9, 9), dtype=dtype, device=dev)
        A[0:3, 0:3] = dRi.T
        A[3:6, 0:3] = -Rah * dt
        A[3:6, 3:6] = eye3
        A[6:9, 0:3] = -0.5 * Rah * dt2
        A[6:9, 3:6] = eye3 * dt
        A[6:9, 6:9] = eye3
        B = torch.zeros((9, 6), dtype=dtype, device=dev)
        B[0:3, 0:3] = Jr * dt
        B[3:6, 3:6] = dR * dt
        B[6:9, 3:6] = 0.5 * dR * dt2
        C9 = A @ C9 @ A.T + (B * Nga_all[i][None, :]) @ B.T

        JRg = dRi.T @ JRg - Jr * dt
        dR = dR @ dRi

    t_total = torch.sum(dts)
    C = torch.zeros((15, 15), dtype=dtype, device=dev)
    C[:9, :9] = C9
    C[9:15, 9:15] = torch.diag(walk * t_total)
    return Preintegrated(dR, dV, dP, C, JRg, JVg, JVa, JPg, JPa, t_total, bg, ba)


# --- bias-corrected getters (GetDeltaRotation / Velocity / Position) ---

def delta_rotation(p: Preintegrated, bg) -> torch.Tensor:
    return p.dR @ lie.so3_exp(p.JRg @ (bg - p.bg))


def delta_velocity(p: Preintegrated, bg, ba) -> torch.Tensor:
    return p.dV + p.JVg @ (bg - p.bg) + p.JVa @ (ba - p.ba)


def delta_position(p: Preintegrated, bg, ba) -> torch.Tensor:
    return p.dP + p.JPg @ (bg - p.bg) + p.JPa @ (ba - p.ba)


def predict_state(p: Preintegrated, Rwb, pw, vw, bg, ba, gravity=None):
    """Dead-reckon the state at t_j from world-from-body Rwb [3, 3],
    position pw and velocity vw at t_i (``PredictStateIMU``): (R2, p2, v2)."""
    if gravity is None:
        gravity = axis_vector(2, -GRAVITY, Rwb.device, Rwb.dtype)
    t = p.dt
    R2 = Rwb @ delta_rotation(p, bg)
    v2 = vw + gravity * t + Rwb @ delta_velocity(p, bg, ba)
    p2 = pw + vw * t + 0.5 * gravity * t * t + Rwb @ delta_position(p, bg, ba)
    return R2, p2, v2
