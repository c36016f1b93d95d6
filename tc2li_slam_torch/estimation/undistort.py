"""Scan motion compensation (de-skew) to the scan-end pose (port of
``tc2li_slam_tpu/estimation/undistort.py``).

``esekf.predict`` emits the body pose after each IMU sample; each point's
pose is interpolated between the two samples that bracket its time (a
batched ``searchsorted`` + SE3 interpolation over all points at once) and
the point is carried to the LiDAR frame at the last valid sample.
"""

from __future__ import annotations

import torch

from ..geom import lie
from ..tensors import count


def undistort(points_l, t_points, t_samples, R_traj, p_traj, R_LI, t_LI) -> torch.Tensor:
    """points_l [M, 3] raw points in the LiDAR frame, t_points [M] their
    times within the scan, t_samples [N] ascending IMU sample times padded
    with +inf, R_traj [N, 3, 3] / p_traj [N, 3] the body pose after each
    sample, (R_LI, t_LI) the body-from-lidar extrinsic. Returns the points
    in the LiDAR frame at scan end."""
    N = t_samples.shape[0]
    last = torch.clamp(count(torch.isfinite(t_samples)) - 1, min=0).long()
    # (index_select: a 0-d index tensor in brackets would be read on the host)
    R_end = R_traj.index_select(0, last.reshape(1))[0]
    p_end = p_traj.index_select(0, last.reshape(1))[0]

    # the pose of a point is interpolated between samples idx - 1 and idx
    # (index -1 wraps to the last slot, as in the reference)
    idx = torch.clamp(torch.searchsorted(t_samples, t_points), 1, max(N - 1, 1))
    idx = torch.minimum(idx, last)
    t0 = t_samples[idx - 1]
    t1 = t_samples[idx]
    alpha = torch.clamp((t_points - t0) / torch.clamp(t1 - t0, min=1e-9), 0.0, 1.0)
    T0 = lie.se3(R_traj[idx - 1], p_traj[idx - 1])
    T1 = lie.se3(R_traj[idx], p_traj[idx])
    T_p = lie.se3_interpolate(T0, T1, alpha)

    # lidar -> body -> world at t_p -> body at end -> lidar at end
    p_b = points_l @ R_LI.T + t_LI
    p_w = (lie.rotation(T_p) @ p_b[..., None])[..., 0] + lie.translation(T_p)
    p_bend = (p_w - p_end) @ R_end
    return (p_bend - t_LI) @ R_LI
