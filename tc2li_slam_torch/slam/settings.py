"""Reference-format configuration loading (numpy and yaml; a copy of
``tc2li_slam_tpu/slam/settings.py``).

The reference splits configuration across (1) an OpenCV ``FileStorage`` YAML
settings file parsed by ``Tracking::Parse{Cam,ORB,LiDAR,IMU}ParamFile``
(``slam_framework/src/Tracking.cc:649-1487``) and (2) a ROS-param YAML for the
LiDAR front end (``config/kitti.yaml``, read at
``lidar_front_end/LidarFrontEnd.cpp:620-642``). This module reads BOTH formats
and unifies them into the framework's single typed ``SystemConfig`` tree
(SURVEY §5 "Config / flag system": four layers collapsed into one).

OpenCV FileStorage YAML is not quite YAML (``%YAML:1.0`` directive,
``!!opencv-matrix`` tags), so a small dedicated parser handles it rather than
pyyaml.
"""

from __future__ import annotations

import re
from typing import Any

import numpy as np

from . import config as cfg_mod


# ---------------------------------------------------------------------------
# OpenCV FileStorage YAML parser
# ---------------------------------------------------------------------------

def parse_opencv_yaml(path: str) -> dict[str, Any]:
    """Parse an OpenCV-FileStorage-style YAML into a flat {key: value} dict.

    Supports scalar ``Key.Sub: value`` entries, quoted strings, and
    ``!!opencv-matrix`` blocks (rows/cols/dt/data -> np.ndarray), matching
    what ``cv::FileStorage`` yields for the reference's settings files.
    """
    out: dict[str, Any] = {}
    with open(path) as f:
        lines = f.readlines()

    i = 0
    while i < len(lines):
        raw = lines[i]
        line = raw.split("#", 1)[0].rstrip()
        i += 1
        if not line or line.startswith("%YAML"):
            continue
        m = re.match(r"^([A-Za-z_][\w.]*)\s*:\s*(.*)$", line)
        if not m:
            continue
        key, val = m.group(1), m.group(2).strip()
        if val.startswith("!!opencv-matrix"):
            mat, i = _parse_matrix(lines, i)
            out[key] = mat
        elif val == "":
            continue  # section header / empty mapping
        else:
            out[key] = _parse_scalar(val)
    return out


def _parse_scalar(s: str):
    s = s.strip()
    if s.startswith('"') and s.endswith('"'):
        return s[1:-1]
    if s.startswith("'") and s.endswith("'"):
        return s[1:-1]
    if s.startswith("[") :
        body = s.strip("[]")
        return np.asarray([float(x) for x in body.split(",") if x.strip()])
    try:
        if re.fullmatch(r"[+-]?\d+", s):
            return int(s)
        return float(s)
    except ValueError:
        return s


def _parse_matrix(lines: list[str], i: int) -> tuple[np.ndarray, int]:
    rows = cols = None
    data: list[float] = []
    in_data = False
    while i < len(lines):
        line = lines[i].split("#", 1)[0].rstrip()
        stripped = line.strip()
        if not stripped:
            i += 1
            continue
        # end of block: a new top-level key (no leading whitespace)
        if not lines[i][0].isspace() and ":" in stripped and not in_data:
            break
        if stripped.startswith("rows:"):
            rows = int(stripped.split(":", 1)[1])
        elif stripped.startswith("cols:"):
            cols = int(stripped.split(":", 1)[1])
        elif stripped.startswith("dt:"):
            pass
        elif stripped.startswith("data:") or in_data:
            chunk = stripped.split("data:", 1)[-1]
            chunk = chunk.replace("[", " ").replace("]", " ")
            data += [float(x) for x in chunk.replace(",", " ").split()]
            in_data = not stripped.rstrip().endswith("]")
        i += 1
        if rows is not None and cols is not None and len(data) >= rows * cols:
            break
    assert rows is not None and cols is not None, "malformed opencv-matrix"
    return np.asarray(data[: rows * cols], np.float64).reshape(rows, cols), i


# ---------------------------------------------------------------------------
# ROS-param YAML (plain nested YAML, e.g. config/kitti.yaml)
# ---------------------------------------------------------------------------

def parse_rosparam_yaml(path: str) -> dict[str, Any]:
    """Parse the LiDAR front-end ROS-param file into {section.key: value}."""
    import yaml

    with open(path) as f:
        tree = yaml.safe_load(f)
    out: dict[str, Any] = {}

    def walk(prefix, node):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(f"{prefix}{k}." if prefix else f"{k}.", v)
        else:
            key = prefix.rstrip(".")
            if isinstance(node, list):
                node = np.asarray(node, np.float64)
            out[key] = node

    walk("", tree)
    return out


# ---------------------------------------------------------------------------
# Unified loading -> SystemConfig
# ---------------------------------------------------------------------------

def load_settings(
    settings_yaml: str,
    lidar_yaml: str | None = None,
    **overrides,
) -> cfg_mod.SystemConfig:
    """Build a SystemConfig from the reference's config files.

    ``settings_yaml`` is the ORB-SLAM3-style settings file (legacy
    ``Parse*ParamFile`` keys: Camera.*, ORBextractor.*, IMU.*, LiDAR.*, Tcl,
    Tbc, ThDepth, loopClosing); ``lidar_yaml`` is the optional FAST-LIO-style
    rosparam file (preprocess.*, mapping.*). Keyword overrides patch the
    resulting dataclasses (e.g. ``tracking=dict(max_kf=256)``).
    """
    s = parse_opencv_yaml(settings_yaml)

    fx = float(s["Camera.fx"])
    camera = cfg_mod.CameraConfig(
        fx=fx,
        fy=float(s["Camera.fy"]),
        cx=float(s["Camera.cx"]),
        cy=float(s["Camera.cy"]),
        width=int(s.get("Camera.width", 1241)),
        height=int(s.get("Camera.height", 376)),
        baseline=float(s.get("Camera.bf", 0.0)) / fx,
        fps=float(s.get("Camera.fps", 10.0)),
        th_depth=float(s.get("ThDepth", 35.0)) * float(s.get("Camera.bf", 0.0)) / fx,
    )
    orb = cfg_mod.OrbConfig(
        n_features=int(s.get("ORBextractor.nFeatures", 2000)),
        n_levels=int(s.get("ORBextractor.nLevels", 8)),
        scale_factor=float(s.get("ORBextractor.scaleFactor", 1.2)),
        ini_th_fast=float(s.get("ORBextractor.iniThFAST", 20)),
        min_th_fast=float(s.get("ORBextractor.minThFAST", 7)),
    )

    imu_kwargs = {}
    if "IMU.NoiseGyro" in s:
        imu_kwargs = dict(
            noise_gyro=float(s["IMU.NoiseGyro"]),
            noise_acc=float(s["IMU.NoiseAcc"]),
            gyro_walk=float(s["IMU.GyroWalk"]),
            acc_walk=float(s["IMU.AccWalk"]),
            frequency=float(s.get("IMU.Frequency", 100.0)),
        )
    if "Tbc" in s:
        imu_kwargs["T_bc"] = np.asarray(s["Tbc"], np.float64)
    imu = cfg_mod.ImuConfig(**imu_kwargs)

    lidar_kwargs: dict[str, Any] = dict(
        enabled=bool(int(s.get("LiDAR.enabled", 0))),
        w_lba=float(s.get("LiDAR.wLBA", 1.0)),
    )
    if "Tcl" in s:
        lidar_kwargs["T_cl"] = np.asarray(s["Tcl"], np.float64)
    if lidar_yaml is not None:
        r = parse_rosparam_yaml(lidar_yaml)
        if "preprocess.blind" in r:
            lidar_kwargs["blind"] = float(r["preprocess.blind"])
        if "mapping.det_range" in r:
            lidar_kwargs["det_range"] = float(r["mapping.det_range"])
    lidar = cfg_mod.LidarConfig(**lidar_kwargs)

    use_imu = "IMU.NoiseGyro" in s and "Tbc" in s

    kwargs: dict[str, Any] = dict(
        camera=camera, orb=orb, imu=imu, lidar=lidar, use_imu=use_imu,
        loop_closing=bool(int(s.get("loopClosing", 0))),
    )
    for k, v in overrides.items():
        if isinstance(v, dict):
            import dataclasses
            base = kwargs.get(k) or getattr(cfg_mod.SystemConfig(), k)
            kwargs[k] = dataclasses.replace(base, **v)
        else:
            kwargs[k] = v
    return cfg_mod.SystemConfig(**kwargs)


def build_rectifier(settings_yaml: str, device="cpu"):
    """StereoRectifier for an UNRECTIFIED stereo rig, or None.

    The reference detects the need to rectify from per-camera distortion +
    the inter-camera transform in its (new-format) settings
    (Settings::readCamera2 + precomputeRectificationMaps, Settings.h:76-129;
    applied in System.cc:241-253). Keys: Camera1.fx..k2/p1/p2(,k3),
    Camera2.*, Stereo.T_c1_c2 (camera-1-from-camera-2, ORB-SLAM3's Tlr).
    Pre-rectified configs (no Camera1.k1 / no stereo transform) return None
    — every KITTI config lands here. The maps are kept on ``device``.
    """
    s = parse_opencv_yaml(settings_yaml)
    if "Camera1.k1" not in s:
        return None
    T = None
    for key in ("Stereo.T_c1_c2", "Tlr"):
        if key in s:
            T = np.asarray(s[key], np.float64)
            break
    if T is None:
        return None

    def K_D(pfx):
        K = np.array([
            [float(s[f"{pfx}.fx"]), 0.0, float(s[f"{pfx}.cx"])],
            [0.0, float(s[f"{pfx}.fy"]), float(s[f"{pfx}.cy"])],
            [0.0, 0.0, 1.0],
        ])
        D = [float(s.get(f"{pfx}.{k}", 0.0))
             for k in ("k1", "k2", "p1", "p2", "k3")]
        return K, np.asarray(D)

    from ..geom.rectify import StereoRectifier
    K1, D1 = K_D("Camera1")
    K2, D2 = K_D("Camera2")
    W = int(s.get("Camera.width", s.get("Camera1.width", 1241)))
    H = int(s.get("Camera.height", s.get("Camera1.height", 376)))
    # T_c1_c2 -> cam2-from-cam1
    T12 = np.linalg.inv(np.vstack([T, [0, 0, 0, 1]]) if T.shape == (3, 4) else T)
    model = "equidistant" if "KannalaBrandt" in str(
        s.get("Camera.type", "")) else "radtan"
    return StereoRectifier(K1, D1, K2, D2, T12[:3, :3], T12[:3, 3],
                           (W, H), model=model, device=device)
