"""IMU-mode support: the per-keyframe inertial state and preintegration
store (port of ``tc2li_slam_tpu/slam/imu_mode.py``).

Per keyframe the IMU_STEREO_LIDAR pipeline needs the preintegrated IMU
factor from the previous keyframe, velocity and bias snapshots, and the
gravity vector in the visual world frame. This module owns those
fixed-capacity pools and assembles a temporal window's factors for
``inertial_ba.lvi_ba``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from ..estimation import imu as imu_mod
from ..solver import inertial_ba
from ..tensors import to_device

# Least credible preintegration sigmas (a floor for unmodelled error, see
# ImuKfStore.set_kf). Information caps at 1 / floor^2: 4e4 / 400 / 400; the
# float32 LM + Schur pipeline stalls on blocks above ~1e5 mixed with O(1)
# visual terms.
SIGMA_ROT_FLOOR = 5e-3   # [rad]
SIGMA_VEL_FLOOR = 5e-2   # [m/s]
SIGMA_POS_FLOOR = 5e-2   # [m]


def floor_cov9(C9: torch.Tensor) -> torch.Tensor:
    """The (dR, dV, dP) covariance with the sigma floors added."""
    d = torch.cat([torch.full((3,), s ** 2, dtype=C9.dtype, device=C9.device)
                   for s in (SIGMA_ROT_FLOOR, SIGMA_VEL_FLOOR, SIGMA_POS_FLOOR)])
    return C9 + torch.diag(d)


@dataclass(frozen=True)
class ImuKfStore:
    """Per-KF inertial data, indexed by keyframe id (factor i = KF i-1 -> i)."""

    dR: torch.Tensor      # [K, 3, 3]
    dV: torch.Tensor      # [K, 3]
    dP: torch.Tensor      # [K, 3]
    JRg: torch.Tensor     # [K, 3, 3]
    JVg: torch.Tensor
    JVa: torch.Tensor
    JPg: torch.Tensor
    JPa: torch.Tensor
    dt: torch.Tensor      # [K]
    C_inv: torch.Tensor   # [K, 9, 9]
    bg_lin: torch.Tensor  # [K, 3]
    ba_lin: torch.Tensor  # [K, 3]
    vel: torch.Tensor     # [K, 3] velocity snapshot at the KF (visual world)
    has_factor: torch.Tensor  # [K] bool (false for KF 0)
    bg: torch.Tensor      # [K, 3] per-KF gyro bias state (LVI-BA variables)
    ba: torch.Tensor      # [K, 3] per-KF accel bias state
    vel_opt: torch.Tensor  # [K] bool: the velocity came from an optimizer
    #                        (inertial init / LVI-BA), not the ESEKF snapshot

    @staticmethod
    def create(max_kf: int, device) -> "ImuKfStore":
        def z(*shape, dtype=torch.float32):
            return torch.zeros((max_kf,) + shape, dtype=dtype, device=device)
        return ImuKfStore(
            dR=torch.eye(3, dtype=torch.float32, device=device).repeat(max_kf, 1, 1),
            dV=z(3), dP=z(3), JRg=z(3, 3), JVg=z(3, 3), JVa=z(3, 3), JPg=z(3, 3),
            JPa=z(3, 3), dt=z(), C_inv=z(9, 9), bg_lin=z(3), ba_lin=z(3), vel=z(3),
            has_factor=z(dtype=torch.bool), bg=z(3), ba=z(3), vel_opt=z(dtype=torch.bool))

    def replace(self, **kw) -> "ImuKfStore":
        return dataclasses.replace(self, **kw)

    def _with_row(self, kf_id: int, **rows) -> "ImuKfStore":
        out = {}
        for name, row in rows.items():
            pool = getattr(self, name).clone()
            pool[kf_id] = row
            out[name] = pool
        return self.replace(**out)

    def set_kf(self, kf_id: int, pre: imu_mod.Preintegrated | None, vel, bg=None,
               ba=None) -> "ImuKfStore":
        rows = {"vel": vel}
        if bg is not None:
            rows["bg"] = bg
        if ba is not None:
            rows["ba"] = ba
        if pre is None:
            return self._with_row(kf_id, **rows)
        # covariance floor: a quiet IMU preintegrates to micrometre and
        # microradian sigmas, information ~1e8, beyond what systematic model
        # error supports and what float32 normal equations can balance
        # against O(1) visual terms
        C_inv = torch.linalg.inv_ex(floor_cov9(pre.C[:9, :9]), check_errors=False)[0]
        rows.update(dR=pre.dR, dV=pre.dV, dP=pre.dP, JRg=pre.JRg, JVg=pre.JVg, JVa=pre.JVa,
                    JPg=pre.JPg, JPa=pre.JPa, dt=pre.dt, C_inv=C_inv, bg_lin=pre.bg,
                    ba_lin=pre.ba,
                    # (a device scalar: a Python bool assigned to a slot is a host copy)
                    has_factor=torch.ones((), dtype=torch.bool, device=self.dt.device))
        return self._with_row(kf_id, **rows)


def factors_at(store: ImuKfStore, sl: torch.Tensor, valid: torch.Tensor,
               info_bg: float = 1e5, info_ba: float = 1e4) -> inertial_ba.ImuWindowFactors:
    """The factors stored at keyframe slots ``sl`` [P-1] (int64) as window
    factors with validity ``valid`` [P-1]."""
    n = sl.shape[0]
    dev = store.dt.device
    return inertial_ba.ImuWindowFactors(
        dR=store.dR[sl], dV=store.dV[sl], dP=store.dP[sl],
        JRg=store.JRg[sl], JVg=store.JVg[sl], JVa=store.JVa[sl],
        JPg=store.JPg[sl], JPa=store.JPa[sl], dt=store.dt[sl], C_inv=store.C_inv[sl],
        bg_lin=store.bg_lin[sl], ba_lin=store.ba_lin[sl],
        info_bg=torch.full((n,), info_bg, dtype=torch.float32, device=dev),
        info_ba=torch.full((n,), info_ba, dtype=torch.float32, device=dev),
        valid=valid)


def window_factors(store: ImuKfStore, window: list[int], info_bg: float = 1e5,
                   info_ba: float = 1e4, has_factor=None) -> inertial_ba.ImuWindowFactors:
    """Consecutive-pair factors of a temporal keyframe window: factor i
    connects window[i] -> window[i+1] and is valid only when the two are
    consecutive keyframes (the factor is stored at the later one's slot).

    ``has_factor`` is a host list mirroring ``store.has_factor``; without it
    the flags are read from the device (one transfer)."""
    if has_factor is None:
        has_factor = store.has_factor.tolist()
    idx = list(window[1:])
    valid = [b == a + 1 and bool(has_factor[b]) for a, b in zip(window[:-1], window[1:])]
    dev = store.dt.device
    return factors_at(store, to_device(idx, torch.int64, dev),
                      to_device(valid, torch.bool, dev), info_bg, info_ba)
