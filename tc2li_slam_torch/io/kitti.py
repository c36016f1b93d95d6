"""KITTI odometry dataset loader (raw files, not rosbags; numpy, a copy of
``tc2li_slam_tpu/io/kitti.py``).

The reference consumes KITTI through ROS topics
(``src/examples/camera_lidar_inertial.cc`` subscribes image/points/imu topics
fed from a rosbag); here we read the odometry benchmark layout directly:

    sequences/NN/image_0|image_1/*.png   rectified grayscale stereo
    sequences/NN/velodyne/*.bin          [N, 4] float32 x, y, z, reflectance
    sequences/NN/times.txt               per-frame timestamps
    sequences/NN/calib.txt               P0..P3 projection matrices, Tr (velo->cam0)
    poses/NN.txt                         ground truth (for evaluation only)

Images load via cv2 (already rectified — matches the reference's precomputed
rectification path). Scans are padded to a static size.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np


class KittiCalib(NamedTuple):
    fx: float
    fy: float
    cx: float
    cy: float
    baseline: float   # meters
    T_cam_velo: np.ndarray  # [4, 4] cam0 <- velodyne

    @property
    def bf(self):
        return self.fx * self.baseline


def load_calib(seq_dir: str) -> KittiCalib:
    vals = {}
    with open(os.path.join(seq_dir, "calib.txt")) as f:
        for line in f:
            key, _, rest = line.partition(":")
            vals[key.strip()] = np.fromstring(rest, sep=" ")
    P0 = vals["P0"].reshape(3, 4)
    P1 = vals["P1"].reshape(3, 4)
    fx, fy, cx, cy = P0[0, 0], P0[1, 1], P0[0, 2], P0[1, 2]
    baseline = -(P1[0, 3] - P0[0, 3]) / fx
    T = np.eye(4)
    if "Tr" in vals:
        T[:3, :4] = vals["Tr"].reshape(3, 4)
    return KittiCalib(float(fx), float(fy), float(cx), float(cy),
                      float(baseline), T)


def load_times(seq_dir: str) -> np.ndarray:
    return np.loadtxt(os.path.join(seq_dir, "times.txt"), dtype=np.float64)


def load_poses(poses_file: str) -> np.ndarray:
    """GT poses [N, 4, 4] (cam0-from-world rows are world-from-cam0? KITTI
    convention: each row is T_w_cam0 as 3x4)."""
    raw = np.loadtxt(poses_file).reshape(-1, 3, 4)
    out = np.tile(np.eye(4), (len(raw), 1, 1))
    out[:, :3, :4] = raw
    return out


def load_image(seq_dir: str, cam: int, idx: int) -> np.ndarray:
    import cv2
    path = os.path.join(seq_dir, f"image_{cam}", f"{idx:06d}.png")
    img = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
    if img is None:
        raise FileNotFoundError(path)
    return img


def load_scan(seq_dir: str, idx: int, n_max: int = 131072,
              T_lc: np.ndarray | None = None):
    """Velodyne scan padded to ``n_max``: (points [n_max, 3], times, valid).

    Per-point relative time is reconstructed from the azimuth sweep (KITTI
    does not store per-point times; the HDL-64E sweeps 360 deg in 0.1 s —
    mirrors the reference's ``curvature``-encoded times, preprocess.cpp).
    Decoding goes through the native library when built (io.native).
    """
    from . import native
    path = os.path.join(seq_dir, "velodyne", f"{idx:06d}.bin")
    out, times, valid, _ = native.read_velodyne(path, n_max)
    return out, times, valid


class KittiSequence:
    """Iterator over a KITTI odometry sequence in FrameData-like tuples."""

    def __init__(self, root: str, seq: str, n_scan: int = 131072):
        self.seq_dir = os.path.join(root, "sequences", seq)
        self.calib = load_calib(self.seq_dir)
        self.times = load_times(self.seq_dir)
        self.n_scan = n_scan
        poses_file = os.path.join(root, "poses", f"{seq}.txt")
        self.gt = load_poses(poses_file) if os.path.exists(poses_file) else None

    def __len__(self):
        return len(self.times)

    def frame(self, i: int):
        img_l = load_image(self.seq_dir, 0, i)
        img_r = load_image(self.seq_dir, 1, i)
        scan, stimes, svalid = load_scan(self.seq_dir, i, self.n_scan)
        return {
            "t": float(self.times[i]),
            "img_l": img_l,
            "img_r": img_r,
            "scan": scan,
            "scan_times": stimes,
            "scan_valid": svalid,
            "T_gt": None if self.gt is None else self.gt[i],
        }
