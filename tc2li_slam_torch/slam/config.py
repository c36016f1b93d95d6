"""Unified typed configuration tree.

Replaces the reference's four config layers (OpenCV YAML Settings + legacy
``Parse*ParamFile`` + rosparam for the LiDAR front end + compile-time macros —
see SURVEY §5) with one dataclass tree. Field defaults mirror the shipped
KITTI configs (``config/Camera-Lidar/KITTI00-02.yaml``, ``config/kitti.yaml``,
launch files)."""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass(frozen=True)
class CameraConfig:
    fx: float = 718.856
    fy: float = 718.856
    cx: float = 607.1928
    cy: float = 185.2157
    width: int = 1241
    height: int = 376
    baseline: float = 0.537        # Camera.bf / fx
    fps: float = 10.0
    th_depth: float = 35.0         # ThDepth * baseline = close-point cutoff [m]

    @property
    def bf(self):
        return self.fx * self.baseline


@dataclass(frozen=True)
class OrbConfig:
    n_features: int = 2000
    n_levels: int = 8
    scale_factor: float = 1.2
    ini_th_fast: float = 20.0
    min_th_fast: float = 7.0

    def scale_factors(self) -> np.ndarray:
        return self.scale_factor ** np.arange(self.n_levels)

    def sigma2(self) -> np.ndarray:
        return self.scale_factors() ** 2


@dataclass(frozen=True)
class ImuConfig:
    noise_gyro: float = 1.7e-4
    noise_acc: float = 2.0e-3
    gyro_walk: float = 1.9e-5
    acc_walk: float = 3.0e-3
    frequency: float = 100.0
    T_bc: np.ndarray = field(default_factory=lambda: np.eye(4))  # body<-cam


@dataclass(frozen=True)
class LidarConfig:
    enabled: bool = True
    w_lba: float = 0.01            # LiDAR.wLBA
    T_cl: np.ndarray = field(default_factory=lambda: np.eye(4))  # cam<-lidar
    scan_voxel: float = 0.5        # filter_size_surf
    map_voxel: float = 0.5
    blind: float = 2.0
    det_range: float = 100.0
    plane_thresh: float = 0.1
    feature_extract: bool = False  # LOAM-style surf/edge extraction
    #   (ops.scan_features, the give_feature analog). The reference ships
    #   this DISABLED in every KITTI config (feature_enabled=0) and
    #   voxel-downsamples raw points instead — same default here; enable
    #   for rigs that used it upstream, feeding ring-organized scans
    #   through scan_features.extract_features_rings in the app layer.
    max_iters: int = 3             # ESEKF NUM_MAX_ITERATIONS
    lio_work_cap: int = 8192       # ESEKF update-point budget per scan: the
    #   whole scan step scales with it (433 -> 152 ms measured 32k -> 8k,
    #   tools/probe_imu.py) and ~8k post-downsample points matches the
    #   reference's effective count (0.5 m filter + point_filter_num)
    meas_cov: float = 0.001
    map_capacity: int = 1 << 19
    insert_cap: int = 1 << 15      # max downsampled points inserted per scan
    insert_every: int = 4          # frames staged per batched map insert
    #   (the pool-sized sort dominates insert cost; staging amortizes it —
    #   the map lags <insert_every frames, like ikd-tree's deferred rebuild)
    scan_quant: float = 0.004      # meters/LSB for int16-quantized scan input
    kf_points: int = 2048          # stored surf points per keyframe
    balm_voxel: float = 1.0
    balm_max_voxels: int = 512
    balm_min_points: int = 15
    balm_window: int = 6           # LiDAR BA window (OptimizerWithLidar.cc:245)


@dataclass(frozen=True)
class TrackingConfig:
    match_radius: float = 15.0     # projection search window (px, x scale)
    match_radius_narrow: float = 7.0
    min_inliers: int = 30
    kf_track_ratio: float = 0.75   # NeedNewKeyFrame refKF ratio
    kf_min_interval: int = 0
    kf_max_interval: int = 10
    max_kf: int = 512
    max_lm: int = 32768
    max_obs: int = 12
    local_window: int = 8          # local BA covisible window
    ba_iters: int = 8
    ba_active_landmarks: int = 8192  # compacted landmark budget per solve
    ba_active_min: int = 4096      # adaptive-bucket floor: every distinct
    #   bucket size compiles its own XLA BA variant (minutes, cold); flooring
    #   keeps one variant per typical run — sized down only by the cap
    # mapping maintenance (LocalMapping::Run passes)
    triangulate: bool = True       # CreateNewMapPoints between covisible KFs
    tri_pairs: int = 3             # neighbor pairs triangulated per keyframe
    cull_kf_every: int = 3         # KeyFrameCulling cadence (keyframes)
    cull_kf_redundancy: float = 0.9  # 90% redundant-observation rule
    # Atlas recovery (Tracking.cc:2548,3698): frames of RECENTLY_LOST before
    # the active map is frozen and a new one starts; minimum keyframes for a
    # frozen map to be kept rather than discarded.
    recently_lost_frames: int = 15
    atlas_min_kf: int = 10


@dataclass(frozen=True)
class SystemConfig:
    camera: CameraConfig = field(default_factory=CameraConfig)
    orb: OrbConfig = field(default_factory=OrbConfig)
    imu: ImuConfig = field(default_factory=ImuConfig)
    lidar: LidarConfig = field(default_factory=LidarConfig)
    tracking: TrackingConfig = field(default_factory=TrackingConfig)
    use_imu: bool = False          # IMU_STEREO_LIDAR vs STEREO_LIDAR
    # DBoW2-path loop closing (the reference ships it excised and its configs
    # set loopClosing: 0, but BASELINE targets the capability; see SURVEY §0)
    loop_closing: bool = False
    loop_min_gap: int = 20   # min keyframe separation for a loop candidate
    loop_min_kf: int = 25    # keyframes before detection starts
    profile: bool = False          # per-stage StageTimer (REGISTER_TIMES)
    # Run the temporal-window inertial BA (LocalLVIBA) instead of the
    # covisibility visual BA in IMU mode, after the staged visual-inertial
    # initialization (gravity + bias + velocity bundle on the keyframe map,
    # LocalMapping::InitializeIMU) has converged. Until that point the
    # system falls back to the visual(-LiDAR) BA.
    inertial_ba: bool = True
