"""The BALM voxel clusters: one hand-written CUDA kernel + its plain version.

Replaces ``tc2li_slam_tpu/solver/balm.py:build_clusters`` (line 110, with
``_cluster_pass`` :62 and ``_plane_test`` :101), jit-compiled there. Eager
PyTorch (``solver/balm.build_clusters_plain``) runs it as hundreds of device
events a call: three sorts, the fixed-order scatter-adds of
``tensors.sum_rows``, the plane tests' einsums.

``balm_clusters`` runs the three tensor ops both routes share
(``solver/balm.world_points``: the world points, the sum and the count of
the valid ones), then ``csrc/clusters.cu`` in one launch of one thread-block
cluster (16 blocks of 1024 threads; 8 where 16 do not fit): the keys, two
stable sorts by counting passes over the cluster, the cell and voxel sums in
the plain version's order (a warp a voxel), the plane tests, the child keys
and the compaction. Bound on the H100: latency (the sorts' passes and the
longest voxel's run; see the source). N, mean, Pc and center are bit-equal
to the plain version on the card; the planar flags may differ only where
lambda0 / (ratio lambda1) rounds across 1. Any W, M and ``max_voxels``: the
scratch is sized by the call, in the same allocation as the outputs.

``solver/balm.build_clusters`` sends CUDA tensors here and CPU tensors to
``build_clusters_plain``; any other device raises. There is no other route.
"""

from __future__ import annotations

import numpy as np
import torch

from ...solver import balm as balm_mod
from . import build

launches = 0   # kernel launches by balm_clusters (plain-version calls excluded)


def balm_clusters(points, valid, T_wl, voxel_size: float = 1.0, max_voxels: int = 512,
                  min_points: int = 15, plane_ratio: float = 1.0 / 36.0,
                  child_ratio: float = 1.0 / 25.0):
    """Launch ``csrc/clusters.cu`` on the current stream: what
    ``build_clusters_plain`` computes, without a host sync."""
    global launches
    dev = points.device
    for x in (points, valid, T_wl):
        if x.device.type != "cuda" or x.device != dev:
            raise ValueError(f"balm_clusters: every tensor must lie on one CUDA device, got "
                             f"{x.device} beside {dev}")
    if points.ndim != 3 or points.shape[2] != 3 or points.dtype != torch.float32:
        raise ValueError(f"balm_clusters: points must be float32 [W, M, 3], got {points.dtype} "
                         f"{tuple(points.shape)}")
    W, M, _ = points.shape
    if tuple(valid.shape) != (W, M) or valid.dtype != torch.bool:
        raise ValueError(f"balm_clusters: valid must be bool [{W}, {M}], got {valid.dtype} "
                         f"{tuple(valid.shape)}")
    if tuple(T_wl.shape) != (W, 4, 4) or T_wl.dtype != torch.float32:
        raise ValueError(f"balm_clusters: T_wl must be float32 [{W}, 4, 4], got {T_wl.dtype} "
                         f"{tuple(T_wl.shape)}")
    V = int(max_voxels)
    if V < 1 or W * M > (2 ** 31 - 1) // 16:
        raise ValueError(f"balm_clusters: max_voxels {V} must be >= 1 and W M {W * M} below "
                         f"{(2 ** 31 - 1) // 16}")
    contig = lambda x: x if x.is_contiguous() else x.contiguous()
    pw, val, wsum, wcount = (contig(x) for x in balm_mod.world_points(points, valid, T_wl))
    pts_l, T = contig(points), contig(T_wl)
    # one allocation: the scratch (16-byte aligned at the start), then the outputs
    VW, sb = V * W, scratch_bytes(W * M, V, W) // 4
    scratch, N, mean, Pc, center, flags = torch.empty(
        sb + 13 * VW + 3 * V + (V + 3) // 4, dtype=torch.float32, device=dev).split(
        [sb, VW, 3 * VW, 9 * VW, 3 * V, (V + 3) // 4])
    flags = flags.view(torch.uint8)[:V]
    # the multiplier PyTorch's division by a Python scalar uses on the card
    inv_voxel = float(np.float32(1.0) / np.float32(voxel_size))
    build.check(build.library().tc2li_balm_clusters(
        pts_l.data_ptr(), pw.data_ptr(), val.view(torch.uint8).data_ptr(), wsum.data_ptr(),
        wcount.data_ptr(), T.data_ptr(), W, M, V, int(min_points), inv_voxel,
        float(plane_ratio), float(child_ratio), scratch.data_ptr(), N.data_ptr(),
        mean.data_ptr(), Pc.data_ptr(), center.data_ptr(), flags.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream), "balm_clusters")
    launches += 1
    return balm_mod.VoxelClusters(N.view(V, W), mean.view(V, W, 3), Pc.view(V, W, 3, 3),
                                  center.view(V, 3), flags.view(torch.bool))


def device_runs() -> int:
    """Launches of ``csrc/clusters.cu``'s kernel that ran to their end in this
    process, as the kernel counts them on the device (synchronises the
    device first). Beside ``launches``, the wrapper's count of launches
    enqueued, it shows that each launch ran, without the profiler, whose
    record has missed some of these cluster launches."""
    import ctypes
    torch.cuda.synchronize()
    n = ctypes.c_ulonglong(0)
    build.check(build.library().tc2li_clusters_ran(ctypes.byref(n)), "tc2li_clusters_ran")
    return int(n.value)


def scratch_bytes(P: int, V: int, W: int) -> int:
    """Bytes of ``csrc/clusters.cu``'s scratch for P points, V slots and W
    keyframes (its ``layout``: each array from a 16-byte boundary)."""
    sizes = (4 * P,) * 4 + (12 * P,) * 2 + (4 * P,) * 2 + (
        4 * (V + 1), 8 * V * W, 24 * V * W, 72 * V * W, 24 * V, 8 * V, 4 * V, 4 * V)
    return sum((b + 15) & ~15 for b in sizes)
