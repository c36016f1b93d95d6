"""IMU preintegration on the manifold (port of
``tc2li_slam_tpu/estimation/imu.py``).

Delta rotation / velocity / position between two frames or keyframes, the
15x15 covariance of the preintegrated error (dR, dV, dP, bg, ba ordering,
the residual layout of ``EdgeInertial``) and the five bias Jacobians (JRg,
JVg, JVa, JPg, JPa) used for first-order bias correction without
re-integration.

The reference integrates a padded window in one ``lax.scan``; here the
window is one hand-written kernel on the card (``ops/kernels/imu_preint.py``)
and a Python loop of small ops, one pass per sample, on the CPU. A sample
with ``dt <= 0`` is an exact no-op on both routes (its inputs are zeroed
first, and every update term carries a factor ``dt``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..geom import lie
from ..ops.kernels import imu_preint
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

    CUDA tensors go to the one-launch kernel (``ops/kernels/imu_preint.py``),
    CPU tensors to its plain version; any other device raises."""
    args = (calib, gyro, acc, dts, bg, ba)
    if gyro.device.type == "cuda":
        return imu_preint.imu_preintegrate(*args)
    if gyro.device.type == "cpu":
        return imu_preint.integrate_plain(*args)
    raise ValueError(f"integrate: unsupported device {gyro.device}")


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
