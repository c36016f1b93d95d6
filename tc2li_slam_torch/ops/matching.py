"""Batched binary-descriptor matching (port of ``tc2li_slam_tpu/ops/matching.py``).

Every matcher is a masked row-wise best/second-best over Hamming distances
with distance and ratio tests, and optional rotation-histogram consistency.
The mask and the reduction run fused in the CUDA kernel of
``ops.kernels.match`` (window, stereo-band, epipolar or dense masks), so no [N, M]
tensor is built on the card; on the CPU the same call runs the dense plain
chain. Thresholds mirror ORBmatcher: TH_LOW=50, TH_HIGH=100, HISTO_LENGTH=30.
"""

from __future__ import annotations

import math

import torch

from .kernels.hamming import hamming_matrix  # noqa: F401  (public: all distances)
from .kernels.match import (BIG, EpipolarMask, WindowMask, epipolar_gate,  # noqa: F401
                            epipolar_lines, level_mask, match_best2, window_mask)
from .orb import topk_stable

TH_LOW = 50
TH_HIGH = 100
HISTO_LENGTH = 30


def match_descriptors(d1, d2, valid1, valid2, mask=None, max_dist: int = TH_LOW,
                      ratio: float = 1.0, mutual: bool = False):
    """Guarded nearest-neighbour match: (idx2 [N], dist [N], matched [N]).

    ``mask`` is an extra pair predicate: a bool [N, M], or a ``WindowMask`` /
    ``StereoMask`` / ``EpipolarMask`` of ``ops.kernels.match`` that the
    kernel evaluates per pair without building it."""
    idx, best, second, back = match_best2(d1, d2, valid1, valid2, mask, mutual)
    ok = (best <= max_dist) & valid1
    if ratio < 1.0:
        ok = ok & (best.to(torch.float32) <= ratio * second.to(torch.float32))
    if mutual:
        ok = ok & (back[idx] == torch.arange(d1.shape[0], device=d1.device))
    return idx, best, ok


def rotation_consistency(angles1, angles2, idx, matched, keep_bins: int = 3):
    """Keep matches in the 3 dominant angle-difference bins
    (ORBmatcher::ComputeThreeMaxima, 30 bins over 2*pi)."""
    two_pi = 2 * math.pi
    diff = torch.remainder(angles1 - angles2[idx], two_pi)
    bins = torch.clamp((diff * (HISTO_LENGTH / two_pi)).to(torch.int32), 0, HISTO_LENGTH - 1)
    hist = torch.zeros(HISTO_LENGTH, dtype=torch.int32, device=angles1.device)
    hist.index_add_(0, bins, matched.to(torch.int32))
    top_vals, top_idx = topk_stable(hist, keep_bins)
    good_bin = (hist[bins] > 0) & torch.any(
        (bins[:, None] == top_idx[None, :])
        & (top_vals[None, :] >= (0.1 * top_vals[0]).to(torch.int32)), dim=-1)
    return matched & good_bin


def search_by_projection(uv_proj, pred_level, d_map, valid_map, kp_uv, kp_level,
                         kp_desc, kp_valid, radius, max_dist: int = TH_HIGH,
                         ratio: float = 0.9):
    """Map-point -> frame-keypoint guided match: (kp_idx, dist, matched)."""
    mask = WindowMask(uv_proj, radius, pred_level, kp_uv, kp_level)
    return match_descriptors(d_map, kp_desc, valid_map, kp_valid, mask, max_dist, ratio)


def resolve_duplicates(idx, dist, matched, m_size: int):
    """Keep only the best query per target; ties go to the lowest query."""
    d = torch.where(matched, dist, BIG)
    best_for_target = torch.full((m_size,), BIG, dtype=torch.int32, device=d.device)
    best_for_target.scatter_reduce_(0, idx, d.to(torch.int32), reduce="amin")
    is_best = d <= best_for_target[idx]
    N = idx.shape[0]
    qidx = torch.arange(N, dtype=torch.int32, device=d.device)
    q_big = torch.where(is_best & matched, qidx, N)
    first_q = torch.full((m_size,), N, dtype=torch.int32, device=d.device)
    first_q.scatter_reduce_(0, idx, q_big.to(torch.int32), reduce="amin")
    return matched & is_best & (first_q[idx] == qidx)


def epipolar_mask(uv1, uv2, F12, sigma2, thresh: float = 3.84) -> torch.Tensor:
    """Point-to-epiline distance gate (CheckDistEpipolarLine): bool [N, M].

    ``uv1`` [N, 2] keypoints in view 1, ``uv2`` [M, 2] in view 2, ``F12``
    [3, 3] the fundamental matrix view 1 -> view 2, ``sigma2`` [M] the
    squared level sigma of the view-2 keypoints. The matcher takes the same
    gate without the [N, M] tensor as ``EpipolarMask(epipolar_lines(uv1,
    F12), uv2, sigma2, thresh)``."""
    return epipolar_gate(epipolar_lines(uv1, F12), uv2, sigma2, thresh)
