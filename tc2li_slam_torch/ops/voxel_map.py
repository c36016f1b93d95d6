"""Incremental LiDAR map: a fixed-capacity point pool sorted by packed
voxel key (port of ``tc2li_slam_tpu/ops/voxel_map.py``: create, insert,
knn, needs_recenter, recenter).

Keys pack 3 x 10-bit voxel indices into an int32 (a 1024^3 grid); empty
slots hold ``EMPTY_KEY`` = int32 max so they sort to the tail. The keys
stay int32 so ``torch.sort`` / ``torch.searchsorted`` order them exactly as
the reference does.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from ..tensors import count

GRID_BITS = 10
GRID_SIZE = 1 << GRID_BITS
EMPTY_KEY = torch.iinfo(torch.int32).max


@dataclass(frozen=True)
class VoxelMap:
    points: torch.Tensor   # [N, 3] world coords (undefined where empty)
    keys: torch.Tensor     # [N] int32 ascending, EMPTY_KEY pad
    origin: torch.Tensor   # [3] world position of voxel (0, 0, 0)'s corner
    voxel_size: float      # f32-rounded host scalar
    count: torch.Tensor    # [] int32

    @property
    def capacity(self) -> int:
        return self.points.shape[0]

    def replace(self, **kw) -> "VoxelMap":
        return dataclasses.replace(self, **kw)


def create(capacity: int, voxel_size: float, origin=(0.0, 0.0, 0.0), *,
           device: torch.device | str) -> VoxelMap:
    vs = np.float32(voxel_size)
    corner = np.asarray(origin, np.float32) - np.float32((GRID_SIZE / 2.0) * voxel_size)
    return VoxelMap(
        points=torch.zeros((capacity, 3), dtype=torch.float32, device=device),
        keys=torch.full((capacity,), EMPTY_KEY, dtype=torch.int32, device=device),
        origin=torch.as_tensor(corner).to(device),
        voxel_size=float(vs),
        count=torch.zeros((), dtype=torch.int32, device=device),
    )


def voxel_indices(m: VoxelMap, pts: torch.Tensor) -> torch.Tensor:
    return torch.floor((pts - m.origin) / m.voxel_size).to(torch.int32)


def pack_key(idx: torch.Tensor) -> torch.Tensor:
    in_grid = torch.all((idx >= 0) & (idx < GRID_SIZE), dim=-1)
    key = (idx[..., 0] << (2 * GRID_BITS)) | (idx[..., 1] << GRID_BITS) | idx[..., 2]
    return torch.where(in_grid, key, EMPTY_KEY)


def point_keys(m: VoxelMap, pts: torch.Tensor) -> torch.Tensor:
    return pack_key(voxel_indices(m, pts))


def insert(m: VoxelMap, pts: torch.Tensor, valid: torch.Tensor) -> VoxelMap:
    """Insert world points [B, 3]: at most one stored point per voxel, an
    occupied voxel keeps its point, overflow drops the largest keys."""
    B = pts.shape[0]
    N = m.capacity
    keys0 = torch.where(valid, point_keys(m, pts), EMPTY_KEY)
    comb_keys = torch.cat([m.keys, keys0])
    comb_pts = torch.cat([m.points, pts])
    # one stable sort: on equal keys the map entry precedes the batch, so
    # "equal to predecessor" marks both occupied voxels and in-batch repeats
    k_s, order = torch.sort(comb_keys, stable=True)
    p_s = comb_pts[order]
    dup = torch.cat([torch.zeros(1, dtype=torch.bool, device=pts.device),
                     k_s[1:] == k_s[:-1]]) & (k_s != EMPTY_KEY)
    keep = (~dup) & (k_s != EMPTY_KEY)
    rank = torch.cumsum(keep.to(torch.int32), 0) - 1
    idx = torch.where(keep, rank, N + B).long()
    out_keys = torch.full((N + B + 1,), EMPTY_KEY, dtype=torch.int32, device=pts.device)
    out_keys[idx] = torch.where(keep, k_s, EMPTY_KEY)
    out_pts = torch.zeros((N + B + 1, 3), dtype=torch.float32, device=pts.device)
    out_pts[idx] = p_s
    return m.replace(points=out_pts[:N], keys=out_keys[:N],
                     count=torch.clamp(count(keep), max=N))


def _column_offsets(radius: int, device) -> torch.Tensor:
    r = torch.arange(-radius, radius + 1, dtype=torch.int32, device=device)
    ox, oy = torch.meshgrid(r, r, indexing="ij")
    return torch.stack([ox.reshape(-1), oy.reshape(-1)], dim=-1)


def knn(m: VoxelMap, queries: torch.Tensor, k: int = 5, radius: int = 1,
        with_slots: bool = False):
    """k nearest stored points per query from the (2r+1)^3 voxel
    neighbourhood: one binary search per voxel column (a fixed-(x, y)
    column is contiguous in key space), a fixed candidate run per column,
    then top-k by distance. Returns (dists [Q, k] ascending,
    points [Q, k, 3], valid [Q, k]), and with ``with_slots`` the pool slot
    of each neighbour (-1 where not valid) [Q, k]."""
    Q = queries.shape[0]
    W = 2 * radius + 1
    dev = queries.device
    cols = _column_offsets(radius, dev)
    qidx = voxel_indices(m, queries)
    col_idx = qidx[:, None, :2] + cols[None, :, :]
    z_lo = torch.clamp(qidx[:, 2] - radius, 0, GRID_SIZE - 1)
    z_hi = torch.clamp(qidx[:, 2] + radius, 0, GRID_SIZE - 1)
    lo3 = torch.cat([col_idx, z_lo[:, None, None].expand(Q, cols.shape[0], 1)], dim=-1)
    key_lo = pack_key(lo3)
    key_hi = key_lo + (z_hi - z_lo)[:, None]
    pos0 = torch.searchsorted(m.keys, key_lo.reshape(-1)).reshape(key_lo.shape)
    run = torch.arange(W, device=dev)
    cand_pos = torch.clamp(pos0[..., None] + run, 0, m.capacity - 1).reshape(Q, -1)
    cand_keys = m.keys[cand_pos]
    lo_b = key_lo.repeat_interleave(W, dim=-1)
    hi_b = key_hi.repeat_interleave(W, dim=-1)
    cand_valid = ((cand_keys >= lo_b) & (cand_keys <= hi_b)
                  & (cand_keys != EMPTY_KEY) & (lo_b != EMPTY_KEY))
    cand_pts = m.points[cand_pos]
    d2 = torch.sum((cand_pts - queries[:, None, :]) ** 2, dim=-1)
    d2 = torch.where(cand_valid, d2, float("inf"))
    d2_s, sel = torch.sort(d2, dim=-1, stable=True)
    d2_s, sel = d2_s[:, :k], sel[:, :k]
    dists = torch.sqrt(torch.clamp(d2_s, min=0.0))
    sel_pts = torch.gather(cand_pts, 1, sel[..., None].expand(Q, k, 3))
    sel_valid = torch.gather(cand_valid, 1, sel)
    if with_slots:
        return dists, sel_pts, sel_valid, torch.where(sel_valid, torch.gather(cand_pos, 1, sel), -1)
    return dists, sel_pts, sel_valid


def recenter(m: VoxelMap, center: torch.Tensor) -> VoxelMap:
    """Shift the grid origin by whole voxels so ``center`` is mid-grid;
    re-key and re-sort (out-of-grid points become empty)."""
    vs = m.voxel_size
    target_corner = center - (GRID_SIZE / 2.0) * vs
    shift_vox = torch.round((target_corner - m.origin) / vs)
    m2 = m.replace(origin=m.origin + shift_vox * vs)
    new_keys = torch.where(m.keys != EMPTY_KEY, point_keys(m2, m.points), EMPTY_KEY)
    keys_s, order = torch.sort(new_keys, stable=True)
    return m2.replace(points=m.points[order], keys=keys_s,
                      count=count(new_keys != EMPTY_KEY))


def needs_recenter(m: VoxelMap, pos: torch.Tensor, margin: float) -> torch.Tensor:
    rel = (pos - m.origin) / m.voxel_size
    margin_vox = float(np.float32(margin) / np.float32(m.voxel_size))
    return torch.any((rel < margin_vox) | (rel > GRID_SIZE - margin_vox))
