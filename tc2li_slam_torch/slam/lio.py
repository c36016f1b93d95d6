"""LiDAR odometry and mapping (port of ``tc2li_slam_tpu/slam/lio.py``).

IMU mode runs the per-scan FAST-LIO2 step ``lio_scan_step``:

    predict (IMU scan window) -> undistort -> voxel downsample ->
    iterated ESEKF point-to-plane update against the voxel map ->
    map insert

with the measurement model of ``h_share_model``: per point, 5-NN in the
map, plane fit with 0.1 threshold, the gate ``s = 1 - 0.9|pd|/sqrt(|p|)``
kept when > 0.9, residual ``-pd``, H columns for position, rotation and
(optionally) the LiDAR-IMU extrinsic.

STEREO_LIDAR mode is driven by the camera pose instead (the
LidarCameraProcess half): scan staging, the batched voxel-map flush with
recentring, and planar feature selection, no filter.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..estimation import esekf, undistort as undist
from ..geom import lie
from ..ops import plane_fit, pointcloud, voxel_map
from ..ops.kernels import lio as klio
from ..tensors import count


class LioConfig(NamedTuple):
    scan_voxel: float = 0.5
    map_voxel: float = 0.5
    plane_thresh: float = 0.1
    meas_cov: float = 0.001
    max_iters: int = 4
    det_range: float = 100.0
    blind: float = 4.0
    estimate_extrinsic: bool = False
    work_cap: int = 1 << 15


def iterated_update(filt0: esekf.Filter, filt: esekf.Filter, m: voxel_map.VoxelMap, points_l,
                    valid, cfg: LioConfig, fences=None) -> klio.ScanUpdate:
    """The scan step's iterated point-to-plane update of the prediction
    ``filt`` against the voxel map, the divergence guard back to ``filt0``
    and the inliers at the result. CUDA tensors go to the kernels
    (``ops/kernels/lio.py`` ``scan_update``: 2 max_iters + 3 launches,
    through ``fences``, the fence table of ``m``'s keys that the predict
    launch wrote), CPU tensors to their plain version; any other device
    raises."""
    args = (filt0, filt, m, points_l, valid, cfg)
    if points_l.device.type == "cuda":
        return klio.scan_update(*args, fences)
    if points_l.device.type == "cpu":
        return klio.scan_update_plain(*args)
    raise ValueError(f"iterated_update: unsupported device {points_l.device}")


def scan_points(filt: esekf.Filter, scan_l, t_points, scan_valid, t_samples, R_traj, p_traj,
                cfg: LioConfig):
    """The update's points: the raw scan carried to the LiDAR frame at scan
    end along the predicted trajectory, preprocessed and voxel-downsampled;
    (points [M, 3], valid [M])."""
    # 2. motion-compensate the points to scan end
    pts_end = undist.undistort(scan_l, t_points, t_samples, R_traj, p_traj,
                               filt.x.R_LI, filt.x.t_LI)
    # 3. preprocess + voxel downsample in the LiDAR frame. The downsample
    # compacts valid voxels to the front in key order, which is spatial
    # order, so the work_cap subset is strided over the whole valid range: a
    # prefix would keep one region of the scan and bias the update.
    keep = pointcloud.preprocess(pts_end, scan_valid, blind=cfg.blind)
    pts_ds, ds_valid = pointcloud.voxel_downsample(pts_end, keep, cfg.scan_voxel)
    if pts_ds.shape[0] > cfg.work_cap:
        n = count(ds_valid)
        step = torch.clamp(n, min=cfg.work_cap).to(torch.float32) / cfg.work_cap
        pos = torch.arange(cfg.work_cap, device=pts_ds.device).to(torch.float32) * step
        idx = torch.clamp(pos.to(torch.int32), max=pts_ds.shape[0] - 1)
        pts_ds = pts_ds[idx.long()]
        ds_valid = idx < n
    return pts_ds, ds_valid


class ScanResult(NamedTuple):
    filt: esekf.Filter
    map: voxel_map.VoxelMap
    points_world: torch.Tensor   # [M, 3] downsampled scan in the world frame
    points_valid: torch.Tensor   # [M]
    n_iters: torch.Tensor
    n_effective: torch.Tensor    # planar inliers matched at the final state
    bad: torch.Tensor            # scalar bool: diverged or non-finite state


def lio_scan_step(filt: esekf.Filter, m: voxel_map.VoxelMap, scan_l, t_points, scan_valid,
                  gyro, acc, dts, t_samples, noise: esekf.NoiseCfg, cfg: LioConfig,
                  map_insert: bool = True) -> ScanResult:
    """One FAST-LIO2 scan iteration: scan_l [Mraw, 3] raw scan in the LiDAR
    frame with per-point relative times, the IMU window that covers the scan
    (gyro, acc [N, 3], dts [N], t_samples [N] padded with +inf).

    The bad-IMU guard runs on the device: a non-finite or diverged
    (> 60 m/s) state after the update reverts the filter to its value
    before the scan and suppresses the map insert; ``bad`` is a device
    scalar for the caller to fetch when it next talks to the host."""
    filt0 = filt
    # 1. propagate through the scan's IMU samples; on the card the launch
    # also writes the fence table of the pool keys that the update searches
    # (the pool does not change before the insert)
    fences = None
    if gyro.device.type == "cuda":
        filt, R_traj, p_traj, fences = klio.predict_with_fences(filt, gyro, acc, dts, noise,
                                                                m.keys)
    else:
        filt, R_traj, p_traj = esekf.predict(filt, gyro, acc, dts, noise)
    # 2.-3. the scan at its end, downsampled
    pts_ds, ds_valid = scan_points(filt, scan_l, t_points, scan_valid, t_samples, R_traj,
                                   p_traj, cfg)
    # 4. iterated point-to-plane update, 5. divergence guard: back to the
    # filter before the scan on a bad state
    upd = iterated_update(filt0, filt, m, pts_ds, ds_valid, cfg, fences)
    # 6. map insert at the converged pose
    if map_insert:
        m = voxel_map.insert(m, upd.points_world, ds_valid & ~upd.bad)
    return ScanResult(upd.filt, m, upd.points_world, ds_valid, upd.n_iters, upd.n_effective,
                      upd.bad)


def camera_scan_stage(scan, scan_valid, T_cw, T_cl, blind: float, map_voxel: float,
                      insert_cap: int = 1 << 15):
    """Preprocess -> voxel downsample -> world transform of one scan, staged
    for a later batched ``camera_map_flush``: (points_w [cap, 3], valid [cap])."""
    keep = pointcloud.preprocess(scan, scan_valid, blind=blind)
    ds, dsv = pointcloud.voxel_downsample(scan, keep, map_voxel)
    ds, dsv = ds[:insert_cap], dsv[:insert_cap]
    T_wl = lie.se3_inverse(T_cw) @ T_cl
    return lie.se3_apply(T_wl, ds), dsv


def maybe_recenter(m: voxel_map.VoxelMap, pos, margin: float = 150.0):
    """Recentre the grid when ``pos`` nears its edge: (map, did_recenter).

    The re-keyed map is computed unconditionally and selected on the device,
    so the decision costs no host sync."""
    need = voxel_map.needs_recenter(m, pos, margin)
    m2 = voxel_map.recenter(m, pos)
    out = m.replace(
        points=torch.where(need, m2.points, m.points),
        keys=torch.where(need, m2.keys, m.keys),
        origin=torch.where(need, m2.origin, m.origin),
        count=torch.where(need, m2.count, m.count),
    )
    return out, need


def camera_map_flush(m: voxel_map.VoxelMap, pts_w, valid, center) -> voxel_map.VoxelMap:
    """Batched insert of staged scan points + recentre."""
    m = voxel_map.insert(m, pts_w, valid)
    m, _ = maybe_recenter(m, center)
    return m


def select_plane_features(m: voxel_map.VoxelMap, points_l, valid, T_wl,
                          cfg: LioConfig) -> torch.Tensor:
    """Planar-inlier mask of a scan against the map (feature_extraction)."""
    p_w = lie.se3_apply(T_wl, points_l)
    _, nbrs, nb_valid = voxel_map.knn(m, p_w, k=5, radius=1)
    normals, d, plane_ok = plane_fit.fit_planes(nbrs, nb_valid, cfg.plane_thresh)
    pd = plane_fit.point_to_plane(p_w, normals, d)
    norm_p = torch.linalg.norm(points_l, dim=-1)
    s = 1.0 - 0.9 * torch.abs(pd) / torch.sqrt(torch.clamp(norm_p, min=1e-6))
    return valid & plane_ok & (s > 0.9)
