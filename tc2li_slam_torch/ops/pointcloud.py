"""LiDAR scan preprocessing: blind cut and centroid voxel downsample
(port of ``tc2li_slam_tpu/ops/pointcloud.py``)."""

from __future__ import annotations

import torch

BIG_KEY = torch.iinfo(torch.int32).max


def preprocess(points: torch.Tensor, valid: torch.Tensor, blind: float = 4.0) -> torch.Tensor:
    """Blind-radius cut; returns the updated validity."""
    r2 = torch.sum(points * points, dim=-1)
    return valid & (r2 > blind * blind)


def voxel_downsample(points: torch.Tensor, valid: torch.Tensor, voxel_size: float):
    """Centroid voxel downsample (PCL VoxelGrid), static shape: returns
    (points [N, 3], valid [N]) with one centroid per occupied voxel,
    compacted to the front in key order."""
    N = points.shape[0]
    inf = torch.full_like(points, float("inf"))
    mins = torch.amin(torch.where(valid[:, None], points, inf), dim=0)
    idx = torch.floor((points - mins) / voxel_size).to(torch.int32)
    # 10 bits per axis from the scan minimum: < 1024 voxels per axis for
    # scans within 200 m at >= 0.2 m voxels (the reference's packing)
    idx10 = torch.clamp(idx, 0, 1023)
    key = (idx10[:, 0] << 20) | (idx10[:, 1] << 10) | idx10[:, 2]
    key = torch.where(valid, key, BIG_KEY)
    key_s, order = torch.sort(key, stable=True)
    pts_s = points[order]
    valid_s = key_s != BIG_KEY
    is_head = torch.cat([torch.ones(1, dtype=torch.bool, device=points.device),
                         key_s[1:] != key_s[:-1]]) & valid_s
    seg_id = torch.clamp(torch.cumsum(is_head.to(torch.int32), 0) - 1, 0, N - 1).long()
    sums = torch.zeros((N, 3), dtype=points.dtype, device=points.device)
    sums.index_add_(0, seg_id, torch.where(valid_s[:, None], pts_s, 0.0))
    counts = torch.zeros(N, dtype=torch.int32, device=points.device)
    counts.index_add_(0, seg_id, valid_s.to(torch.int32))
    centroids = sums / torch.clamp(counts, min=1)[:, None]
    return centroids, counts > 0
