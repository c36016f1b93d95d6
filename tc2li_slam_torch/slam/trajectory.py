"""Trajectory output in KITTI / TUM formats (numpy; a copy of
``tc2li_slam_tpu/slam/trajectory.py``).

KITTI: 12 floats a line (3x4 world-from-camera). TUM:
``t tx ty tz qx qy qz qw``.
"""

from __future__ import annotations

import numpy as np


def mat_to_quat(R: np.ndarray) -> np.ndarray:
    """Rotation matrix [3, 3] -> unit quaternion (w, x, y, z): of the four
    constructions, the one with the largest pivot."""
    m = np.asarray(R, np.float64)
    tr = m[0, 0] + m[1, 1] + m[2, 2]
    pivots = [tr, m[0, 0] - m[1, 1] - m[2, 2], -m[0, 0] + m[1, 1] - m[2, 2],
              -m[0, 0] - m[1, 1] + m[2, 2]]
    best = int(np.argmax(pivots))
    s = 0.5 * np.sqrt(max(1.0 + pivots[best], 1e-12))
    if best == 0:
        q = [s, (m[2, 1] - m[1, 2]) / (4 * s), (m[0, 2] - m[2, 0]) / (4 * s),
             (m[1, 0] - m[0, 1]) / (4 * s)]
    elif best == 1:
        q = [(m[2, 1] - m[1, 2]) / (4 * s), s, (m[0, 1] + m[1, 0]) / (4 * s),
             (m[0, 2] + m[2, 0]) / (4 * s)]
    elif best == 2:
        q = [(m[0, 2] - m[2, 0]) / (4 * s), (m[0, 1] + m[1, 0]) / (4 * s), s,
             (m[1, 2] + m[2, 1]) / (4 * s)]
    else:
        q = [(m[1, 0] - m[0, 1]) / (4 * s), (m[0, 2] + m[2, 0]) / (4 * s),
             (m[1, 2] + m[2, 1]) / (4 * s), s]
    q = np.asarray(q)
    return q / np.linalg.norm(q)


def save_kitti(path: str, T_wc_list) -> None:
    with open(path, "w") as f:
        for T in T_wc_list:
            row = np.asarray(T)[:3, :4].reshape(-1)
            f.write(" ".join(f"{v:.9e}" for v in row) + "\n")


def save_tum(path: str, times, T_wc_list) -> None:
    with open(path, "w") as f:
        for t, T in zip(times, T_wc_list):
            T = np.asarray(T)
            q = mat_to_quat(T[:3, :3])
            tx, ty, tz = T[:3, 3]
            f.write(f"{t:.6f} {tx:.7f} {ty:.7f} {tz:.7f} "
                    f"{q[1]:.7f} {q[2]:.7f} {q[3]:.7f} {q[0]:.7f}\n")


def load_kitti(path: str) -> np.ndarray:
    raw = np.loadtxt(path).reshape(-1, 3, 4)
    out = np.tile(np.eye(4), (len(raw), 1, 1))
    out[:, :3, :4] = raw
    return out
