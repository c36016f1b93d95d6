"""BALM2 plane eigen-factor for LiDAR bundle adjustment (port of
``tc2li_slam_tpu/solver/balm.py``: build_clusters, eigen_cost, quadratic).

Per-(voxel, keyframe) point clusters are built once in each keyframe's
LiDAR frame, stored centred (mean + scatter) around a per-voxel anchor.
The cost sum_v N_v lambda_min(cov_v) is a closed function of the window
pose tangents; ``quadratic`` gives its gradient and Hessian (``jax.hessian``
in the reference) through the closed-form ``smallest_eigval_sym3``: on the
card one hand-written kernel, on the CPU ``torch.func``
(``ops/kernels/balm.py``). Padded voxels get a fixed well-separated
spectrum so no repeated eigenvalue reaches the derivatives.
``build_clusters`` is one kernel on the card too (``ops/kernels/clusters.py``),
``build_clusters_plain`` on the CPU.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..geom import lie
from ..ops.kernels import balm as balm_kernel, clusters as clusters_kernel
from ..ops.plane_fit import smallest_eigval_sym3, smallest_two_eigvals_sym3
from ..tensors import count, sum_rows

BIG_KEY = torch.iinfo(torch.int32).max


class VoxelClusters(NamedTuple):
    N: torch.Tensor       # [V, W] point counts
    mean: torch.Tensor    # [V, W, 3] cluster mean, LiDAR frame
    Pc: torch.Tensor      # [V, W, 3, 3] centred scatter
    center: torch.Tensor  # [V, 3] build-time world voxel centre (f32 anchor)
    valid: torch.Tensor   # [V] voxel passes the plane test


def _cluster_pass(key, pts_l, pts_w, kf, W: int, max_voxels: int):
    """Accumulate centred per-(voxel, KF) clusters for one voxelisation.
    Returns (N, mean, Pc, centers, slot of each point in original order)."""
    dt, dev = pts_l.dtype, pts_l.device
    WM = key.shape[0]
    key_s, order = torch.sort(key, stable=True)
    head = torch.cat([torch.ones(1, dtype=torch.bool, device=dev), key_s[1:] != key_s[:-1]])
    head = head & (key_s != BIG_KEY)
    vox = torch.cumsum(head.to(torch.int32), 0) - 1
    vox = torch.clamp(torch.where(key_s != BIG_KEY, vox, max_voxels), 0, max_voxels).long()
    pts_l_s = pts_l[order]
    kf_s = kf[order].long()
    wgt = (key_s != BIG_KEY).to(dt)
    flat = vox * W + kf_s                                  # (voxel, KF) cell
    n_cells = (max_voxels + 1) * W
    # sums in a fixed order (sum_rows), so that the window is the same bits
    # on every run
    N = sum_rows(n_cells, flat, wgt)
    S = sum_rows(n_cells, flat, pts_l_s * wgt[:, None])
    mean = S / torch.clamp(N, min=1.0)[:, None]
    centered = (pts_l_s - mean[flat]) * wgt[:, None]
    Pc = sum_rows(n_cells, flat, centered[:, :, None] * centered[:, None, :])
    Sw = sum_rows(max_voxels + 1, vox, pts_w[order] * wgt[:, None])[:max_voxels]
    N = N.reshape(max_voxels + 1, W)[:max_voxels]
    mean = mean.reshape(max_voxels + 1, W, 3)[:max_voxels]
    Pc = Pc.reshape(max_voxels + 1, W, 3, 3)[:max_voxels]
    centers = Sw / torch.clamp(torch.sum(N, dim=1), min=1.0)[:, None]
    slot_orig = torch.zeros(WM, dtype=torch.long, device=dev)
    slot_orig[order] = vox
    return N, mean, Pc, centers, slot_orig


def _plane_test(N, mean, Pc, centers, T_wl, min_points, ratio):
    c = VoxelClusters(N, mean, Pc, centers,
                      torch.ones(N.shape[0], dtype=torch.bool, device=N.device))
    cov, n_tot = _total_cov(c, T_wl)
    # closed-form eigenvalues instead of the reference's eigvalsh: cuSOLVER's
    # eigen solver checks its status on the host, a device sync per keyframe
    lam0, lam1 = smallest_two_eigvals_sym3(cov)
    planar = (n_tot >= min_points) & (lam0 < ratio * torch.clamp(lam1, min=1e-9))
    return planar, n_tot


def world_points(points, valid, T_wl):
    """The tensor ops both routes of ``build_clusters`` share, so that both
    voxelise the same bits: the world points [W M, 3], the flat flags, and
    the sum [3] and count [] (int32) of the valid world points, whose
    quotient is the grid's centre."""
    pts = lie.se3_apply(T_wl, points).reshape(-1, 3)
    val = valid.reshape(-1)
    return pts, val, torch.sum(torch.where(val[:, None], pts, 0.0), dim=0), count(val)


def build_clusters(points, valid, T_wl, voxel_size: float = 1.0, max_voxels: int = 512,
                   min_points: int = 15, plane_ratio: float = 1.0 / 36.0,
                   child_ratio: float = 1.0 / 25.0) -> VoxelClusters:
    """cut_voxel + the adaptive two-level plane harvest: planar 1 m roots,
    and planar half-size children of big non-planar roots, compacted to
    ``max_voxels`` slots (planar roots first).

    CUDA tensors go to the one-launch kernel (``ops/kernels/clusters.py``),
    CPU tensors to ``build_clusters_plain``; any other device raises."""
    args = (points, valid, T_wl, voxel_size, max_voxels, min_points, plane_ratio, child_ratio)
    if points.device.type == "cuda":
        return clusters_kernel.balm_clusters(*args)
    if points.device.type == "cpu":
        return build_clusters_plain(*args)
    raise ValueError(f"build_clusters: unsupported device {points.device}")


def build_clusters_plain(points, valid, T_wl, voxel_size: float = 1.0, max_voxels: int = 512,
                         min_points: int = 15, plane_ratio: float = 1.0 / 36.0,
                         child_ratio: float = 1.0 / 25.0) -> VoxelClusters:
    """``build_clusters`` in tensor ops: the plain version of the kernel."""
    W, M, _ = points.shape
    dev = points.device
    pts, val, wsum, wcount = world_points(points, valid, T_wl)
    pts_l = points.reshape(-1, 3)
    kf = torch.arange(W, dtype=torch.int32, device=dev).repeat_interleave(M)
    center = wsum / torch.clamp(wcount, min=1)
    rel_f = (pts - center) / voxel_size
    rel = torch.floor(rel_f).to(torch.int32) + 256
    in_grid = torch.all((rel >= 0) & (rel < 512), dim=-1) & val
    key_root = (rel[:, 0] << 18) | (rel[:, 1] << 9) | rel[:, 2]
    key_root = torch.where(in_grid, key_root, BIG_KEY)

    N, mean, Pc, centers, slot_pt = _cluster_pass(key_root, pts_l, pts, kf, W, max_voxels)
    planar_root, n_tot = _plane_test(N, mean, Pc, centers, T_wl, min_points, plane_ratio)

    splittable = (~planar_root) & (n_tot >= min_points)
    pt_split = (slot_pt < max_voxels) & splittable[torch.clamp(slot_pt, 0, max_voxels - 1)]
    frac = rel_f - torch.floor(rel_f)
    octant = ((frac[:, 0] >= 0.5).to(torch.int32)
              | ((frac[:, 1] >= 0.5).to(torch.int32) << 1)
              | ((frac[:, 2] >= 0.5).to(torch.int32) << 2))
    key_child = torch.where(pt_split & (key_root != BIG_KEY), key_root * 8 + octant, BIG_KEY)
    Nc, meanc, Pcc, centersc, _ = _cluster_pass(key_child, pts_l, pts, kf, W, max_voxels)
    planar_child, _ = _plane_test(Nc, meanc, Pcc, centersc, T_wl, min_points, child_ratio)

    val2 = torch.cat([planar_root, planar_child])
    sel = torch.sort((~val2).to(torch.uint8), stable=True).indices[:max_voxels]
    return VoxelClusters(torch.cat([N, Nc])[sel], torch.cat([mean, meanc])[sel],
                         torch.cat([Pc, Pcc])[sel], torch.cat([centers, centersc])[sel],
                         val2[sel])


def _transform_moments(c: VoxelClusters, T_wl):
    """All (voxel, KF) clusters in voxel-centred world coordinates:
    (S_q [V, W, 3], P_q [V, W, 3, 3])."""
    R = lie.rotation(T_wl)
    t = lie.translation(T_wl)
    m_w = torch.einsum("wij,vwj->vwi", R, c.mean) + (t[None, :, :] - c.center[:, None, :])
    RPR = torch.einsum("wij,vwjk,wlk->vwil", R, c.Pc, R)
    S_q = c.N[..., None] * m_w
    P_q = RPR + c.N[..., None, None] * torch.einsum("vwi,vwj->vwij", m_w, m_w)
    return S_q, P_q


def _total_cov(c: VoxelClusters, T_wl):
    Sw, Pw = _transform_moments(c, T_wl)
    N_tot = torch.sum(c.N, dim=1)
    S_tot = torch.sum(Sw, dim=1)
    P_tot = torch.sum(Pw, dim=1)
    n = torch.clamp(N_tot, min=1.0)
    mu = S_tot / n[:, None]
    cov = P_tot / n[:, None, None] - torch.einsum("vi,vj->vij", mu, mu)
    safe = torch.diag(torch.arange(1, 4, dtype=cov.dtype, device=cov.device))
    cov = torch.where(c.valid[:, None, None], cov, safe)
    cov = cov + 1e-9 * torch.eye(3, dtype=cov.dtype, device=cov.device)
    return cov, N_tot


def eigen_cost(c: VoxelClusters, T_wl) -> torch.Tensor:
    """Window cost sum_v N_v lambda_min(cov_v)."""
    cov, N_tot = _total_cov(c, T_wl)
    w = c.valid.to(cov.dtype) * N_tot
    return torch.sum(w * smallest_eigval_sym3(cov))


def _cost_of_tangent(xi, c: VoxelClusters, T_wl0):
    W = T_wl0.shape[0]
    return eigen_cost(c, T_wl0 @ lie.se3_exp(xi.reshape(W, 6)))


class BalmQuad(NamedTuple):
    H: torch.Tensor     # [6W, 6W]
    g: torch.Tensor     # [6W]
    cost: torch.Tensor


def quadratic(c: VoxelClusters, T_wl) -> BalmQuad:
    """Exact gradient + Hessian of the eigen cost at the current poses
    (right perturbation per pose).

    CUDA tensors go to the one-launch kernel (``ops/kernels/balm.py``), CPU
    tensors to its plain version; any other device raises."""
    if T_wl.device.type == "cuda":
        return balm_kernel.balm_quadratic(c, T_wl)
    if T_wl.device.type == "cpu":
        return balm_kernel.quadratic_plain(c, T_wl)
    raise ValueError(f"quadratic: unsupported device {T_wl.device}")
