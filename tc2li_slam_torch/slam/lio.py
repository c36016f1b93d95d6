"""Camera-pose-driven LiDAR mapping of STEREO_LIDAR mode (port of the
LidarCameraProcess half of ``tc2li_slam_tpu/slam/lio.py``: scan staging,
the batched voxel-map flush with recentring, and planar feature selection).

The FAST-LIO2 scan step of IMU mode (``lio_scan_step`` / ``make_h_fn``) is
not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..geom import lie
from ..ops import plane_fit, pointcloud, voxel_map


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
