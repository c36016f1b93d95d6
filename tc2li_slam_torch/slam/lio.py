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


def make_h_fn(m: voxel_map.VoxelMap, points_l, valid, cfg: LioConfig):
    """The measurement closure of the iterated update. ``points_l`` [M, 3]
    are undistorted, downsampled points in the LiDAR frame at scan end; the
    closure re-evaluates kNN + plane fit at the state it is given."""
    norm_p = torch.linalg.norm(points_l, dim=-1)
    gate_den = torch.sqrt(torch.clamp(norm_p, min=1e-6))

    def h_fn(x: esekf.State):
        p_b = points_l @ x.R_LI.T + x.t_LI          # body frame
        p_w = p_b @ x.R.T + x.pos                   # world frame
        dists, nbrs, nb_valid = voxel_map.knn(m, p_w, k=5, radius=2)
        normals, d, plane_ok = plane_fit.fit_planes(nbrs, nb_valid, cfg.plane_thresh)
        pd = plane_fit.point_to_plane(p_w, normals, d)
        # FAST-LIO inlier gate: s = 1 - 0.9 |pd| / sqrt(|p_l|)
        s = 1.0 - 0.9 * torch.abs(pd) / gate_den
        ok = valid & plane_ok & (s > 0.9) & (dists[:, 0] < 5.0)

        # d pd / d rot (right perturbation on R): n^T d(R Exp(d) p_b)/dd
        Rn = normals @ x.R                           # = R^T n, row convention
        z3 = torch.zeros_like(normals)
        if cfg.estimate_extrinsic:
            ext = [torch.linalg.cross(points_l, Rn @ x.R_LI), Rn]
        else:
            ext = [z3, z3]
        H = torch.cat([normals, torch.linalg.cross(p_b, Rn)] + ext
                      + [z3, z3, z3, z3[:, :2]], dim=-1)
        # masked rows are set to zero, so no non-finite value leaks through 0 * x
        z = torch.where(ok, pd, 0.0)
        z = torch.where(torch.isfinite(z), z, 0.0)
        H = torch.where(ok[:, None] & torch.isfinite(H), H, 0.0)
        return z, H, ok

    return h_fn


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
    # 1. propagate through the scan's IMU samples
    filt, R_traj, p_traj = esekf.predict(filt, gyro, acc, dts, noise)
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
    # 4. iterated point-to-plane update
    h_fn = make_h_fn(m, pts_ds, ds_valid, cfg)
    filt, n_iters = esekf.update_iterated(filt, h_fn, cfg.meas_cov, max_iters=cfg.max_iters)
    # 5. divergence guard: back to the filter before the scan on a bad state
    stx = filt.x
    flat = torch.cat([stx.pos, stx.vel, stx.bg, stx.ba, stx.grav, stx.R.reshape(-1),
                      filt.P.reshape(-1)])
    bad = ~torch.all(torch.isfinite(flat)) | (torch.sum(stx.vel * stx.vel) > 60.0 ** 2)
    filt = esekf.Filter(
        esekf.State(*[torch.where(bad, a, b) for a, b in zip(filt0.x, filt.x)]),
        torch.where(bad, filt0.P, filt.P))
    # 6. map insert at the converged pose
    p_b = pts_ds @ filt.x.R_LI.T + filt.x.t_LI
    p_w = p_b @ filt.x.R.T + filt.x.pos
    _, _, ok = h_fn(filt.x)
    if map_insert:
        m = voxel_map.insert(m, p_w, ds_valid & ~bad)
    return ScanResult(filt, m, p_w, ds_valid, n_iters, count(ok), bad)


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
