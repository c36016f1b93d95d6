"""Trajectory evaluation: ATE and KITTI-style RPE, in-repo (numpy; a copy of
``tc2li_slam_tpu/slam/evaluate.py``).

The reference has NO evaluation code — its validation model is "save
trajectories (``System::SaveTrajectoryKITTI``, System.cc:497-548) and run the
KITTI devkit / evo offline" (SURVEY §4). This package ships the evaluator so
ATE/RPE regression bounds can be asserted in tests and benchmarks without
external tools.

Metrics:

- ``ate_rmse``: absolute trajectory error after Umeyama alignment (SE3 or
  Sim3), the number evo reports as ``ape (trans)`` RMSE.
- ``kitti_rpe``: the KITTI odometry devkit's relative errors — average
  translational drift (%) and rotational drift (deg/m) over subsequences of
  100..800 m.

All inputs are [N, 4, 4] world-from-camera pose arrays (the framework's
trajectory convention; ``trajectory.load_kitti`` produces them).
"""

from __future__ import annotations

import numpy as np


def umeyama_alignment(
    src: np.ndarray, dst: np.ndarray, with_scale: bool = False
) -> tuple[np.ndarray, np.ndarray, float]:
    """Least-squares similarity transform (R, t, s) mapping src -> dst.

    Umeyama (1991); both inputs [N, 3]. Returns (R [3,3], t [3], s).
    """
    mu_s = src.mean(axis=0)
    mu_d = dst.mean(axis=0)
    xs = src - mu_s
    xd = dst - mu_d
    cov = xd.T @ xs / src.shape[0]
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1.0
    R = U @ S @ Vt
    if with_scale:
        var_s = (xs ** 2).sum() / src.shape[0]
        s = float(np.trace(np.diag(D) @ S) / max(var_s, 1e-12))
    else:
        s = 1.0
    t = mu_d - s * R @ mu_s
    return R, t, s


def ate_rmse(
    est_T_wc: np.ndarray, gt_T_wc: np.ndarray, with_scale: bool = False
) -> float:
    """Absolute trajectory error RMSE [m] after Umeyama alignment."""
    p_est = np.asarray(est_T_wc)[:, :3, 3]
    p_gt = np.asarray(gt_T_wc)[:, :3, 3]
    n = min(len(p_est), len(p_gt))
    p_est, p_gt = p_est[:n], p_gt[:n]
    R, t, s = umeyama_alignment(p_est, p_gt, with_scale)
    p_al = (s * (R @ p_est.T)).T + t
    err = np.linalg.norm(p_al - p_gt, axis=1)
    return float(np.sqrt(np.mean(err ** 2)))


def _trajectory_distances(p: np.ndarray) -> np.ndarray:
    d = np.zeros(len(p))
    d[1:] = np.cumsum(np.linalg.norm(np.diff(p, axis=0), axis=1))
    return d


def _last_frame_from_segment(dist: np.ndarray, first: int, length: float) -> int:
    target = dist[first] + length
    i = int(np.searchsorted(dist, target))
    return i if i < len(dist) else -1


def kitti_rpe(
    est_T_wc: np.ndarray,
    gt_T_wc: np.ndarray,
    lengths: tuple[float, ...] = (100, 200, 300, 400, 500, 600, 700, 800),
    step: int = 10,
) -> tuple[float, float]:
    """KITTI devkit relative errors.

    Returns (t_err, r_err): mean translational drift as a FRACTION of segment
    length (multiply by 100 for %), and mean rotational drift in rad/m.
    Falls back to shorter segments when the trajectory is shorter than 100 m
    (useful for synthetic tests); returns (nan, nan) if nothing fits.
    """
    est = np.asarray(est_T_wc)
    gt = np.asarray(gt_T_wc)
    n = min(len(est), len(gt))
    est, gt = est[:n], gt[:n]
    dist = _trajectory_distances(gt[:, :3, 3])
    if dist[-1] < min(lengths):
        lengths = (max(dist[-1] * 0.5, 1e-6),)

    t_errs, r_errs = [], []
    for first in range(0, n, step):
        for length in lengths:
            last = _last_frame_from_segment(dist, first, length)
            if last < 0:
                continue
            # relative motions est/gt between first and last
            dT_gt = np.linalg.inv(gt[first]) @ gt[last]
            dT_est = np.linalg.inv(est[first]) @ est[last]
            E = np.linalg.inv(dT_est) @ dT_gt
            t_errs.append(np.linalg.norm(E[:3, 3]) / length)
            ang = np.arccos(np.clip((np.trace(E[:3, :3]) - 1) / 2, -1, 1))
            r_errs.append(ang / length)
    if not t_errs:
        return float("nan"), float("nan")
    return float(np.mean(t_errs)), float(np.mean(r_errs))


def evaluate(
    est_T_wc: np.ndarray, gt_T_wc: np.ndarray, with_scale: bool = False
) -> dict:
    """One-call summary: ATE RMSE, KITTI t_err %, r_err deg/m."""
    t_err, r_err = kitti_rpe(est_T_wc, gt_T_wc)
    return {
        "ate_rmse_m": ate_rmse(est_T_wc, gt_T_wc, with_scale),
        "kitti_t_err_pct": t_err * 100.0,
        "kitti_r_err_deg_per_m": np.degrees(r_err),
        "n_frames": int(min(len(est_T_wc), len(gt_T_wc))),
    }
