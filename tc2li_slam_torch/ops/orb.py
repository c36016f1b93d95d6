"""Batched ORB extraction (pyramid FAST + oriented rBRIEF) on torch tensors.

Port of ``tc2li_slam_tpu/ops/orb.py:extract`` and the stages it runs:
pyramid resize, detection (adaptive two-threshold FAST + 3x3 NMS),
``select_topk_grid``, ``gaussian_blur7`` and the stacked orientation /
rBRIEF over all levels' keypoints. ``extract_images`` runs them on one or
two images (the two of a stereo pair) at once, in five launches on the
card: ``orb_level_planes`` (every level and its blur, edge-padded into two
plane stacks), the two FAST kernels of ``ops.kernels.fast`` on the whole
stack, ``orb_select_grid`` (every plane's grid top-k) and ``orb_describe``
(orientation and rBRIEF of every keypoint). ``level_stacks``,
``select_grid`` and ``describe`` send CUDA tensors to those kernels and CPU
tensors to their plain versions (``ops/kernels/orb.py``); any other device
raises.

Three deliberate differences in form, same results:

- Detection runs on the level stack after the pyramid is built, not level
  by level; ``detect_level`` is the one-plane entry of the same route.
- rBRIEF gathers its 512 taps directly from the edge-padded blurred level
  stack, after the reference's integer rounding of the patch values. The
  JAX package reads them through a one-hot bf16 contraction shaped for the
  TPU's matrix unit ([K, 512, 1521], 3.1 GB per image in eager torch).
- The pyramid resize is ``jax.image.resize(..., "linear")`` written out:
  the same antialiased triangle weights, each output the sum of its
  nonzero taps in a fixed order (rows, then columns), within 1e-3 grey
  levels of the reference's full weight-matrix products. The orientation's
  moments are float64 sums in a fixed order, rounded to float32.

Descriptors are [K, 8] int32 tensors holding the uint32 words.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .kernels import fast
from .kernels import orb as korb
from .kernels.fast import _on_cuda
# the plain versions' building blocks, by their names in the reference's module
from .kernels.orb import (PAD, compute_descriptors_stacked, compute_orientation_stacked,  # noqa: F401
                          gaussian_blur7, level_shape, pyramid, resize_linear, select_topk_grid,
                          topk_stable)


class Keypoints(NamedTuple):
    """Padded keypoint set for one image."""

    xy: torch.Tensor        # [N, 2] level-0 pixel coords (x, y)
    xy_level: torch.Tensor  # [N, 2] coords on the detection level
    level: torch.Tensor     # [N] int32 pyramid level
    angle: torch.Tensor     # [N] radians
    score: torch.Tensor     # [N] FAST score
    desc: torch.Tensor      # [N, 8] int32 rBRIEF words (uint32 bit patterns)
    valid: torch.Tensor     # [N] bool


def detect_level(img: torch.Tensor, ini_th: float = 20.0, min_th: float = 7.0,
                 cell: int = 35) -> torch.Tensor:
    """Adaptive-threshold FAST + 3x3 NMS score map (ComputeKeyPointsOctTree)
    of one image: ``fast.detect_planes`` on a one-plane stack."""
    f = img.to(torch.float32)
    return fast.detect_planes(f[None], (f.shape,), 0, ini_th, min_th, cell)[0]


def features_per_level(n_features: int, n_levels: int, scale: float) -> list[int]:
    factor = 1.0 / scale
    n_first = n_features * (1 - factor) / (1 - factor ** n_levels)
    per, acc = [], 0
    for i in range(n_levels - 1):
        k = int(round(n_first * factor ** i))
        per.append(k)
        acc += k
    per.append(max(n_features - acc, 0))
    return per


def level_stacks(fs, n_levels: int, scale: float):
    """Edge-padded pyramid stacks of equally sized float32 images:
    ``(img_stack, blur_stack, shapes, pad)``. Plane ``b * n_levels + lvl`` of
    both [B * n_levels, H + 2 pad, W + 2 pad] stacks holds level ``lvl`` of
    image ``b`` (resp. its 7-tap blur) with pixel (0, 0) at ``[pad, pad]``
    and a replicated border of ``pad``; ``shapes`` lists each plane's
    (Hl, Wl). Outside each plane's padded region the stacks hold no
    defined value."""
    H, W = fs[0].shape
    if any(f.shape != (H, W) for f in fs):
        raise ValueError(f"images of one size expected, got {[tuple(f.shape) for f in fs]}")
    imgs = torch.stack([f.to(torch.float32) for f in fs])
    if _on_cuda(imgs, "level_stacks"):
        img_stack, blur_stack, shapes = korb.orb_level_planes(imgs, n_levels, scale)
    else:
        img_stack, blur_stack, shapes = korb.level_planes_plain(imgs, n_levels, scale)
    return img_stack, blur_stack, shapes, PAD


def select_grid(scores: torch.Tensor, shapes, per_level, scale: float):
    """The grid top-k (``select_topk_grid``) of every plane of a score stack
    [B * L, H, W], concatenated level after level: (rows, cols, scores,
    level, level scale), each [B, sum(per_level)]."""
    if _on_cuda(scores, "select_grid"):
        return korb.orb_select_grid(scores, shapes, per_level, scale)
    return korb.select_grid_plain(scores, shapes, per_level, scale)


def describe(img_stack, blur_stack, rows, cols, level, n_levels: int, pad: int = PAD):
    """Angles [B, K] and rBRIEF words [B, K, 8] of keypoints [B, K]."""
    if _on_cuda(img_stack, "describe"):
        return korb.orb_describe(img_stack, blur_stack, rows, cols, level, n_levels, pad)
    return korb.describe_plain(img_stack, blur_stack, rows, cols, level, n_levels, pad)


def extract_images(imgs, n_features: int = 2000, n_levels: int = 8,
                   scale: float = 1.2, ini_th: float = 20.0,
                   min_th: float = 7.0) -> list[Keypoints]:
    """Full pyramid ORB extraction of equally sized images (one, or the two
    of a stereo pair), each padded to ``n_features`` keypoints."""
    per_level = features_per_level(n_features, n_levels, scale)
    img_stack, blur_stack, shapes, pad = level_stacks(imgs, n_levels, scale)
    scores = fast.detect_planes(img_stack, shapes, pad, ini_th, min_th)
    rows, cols, sel, level, s = select_grid(scores, shapes, per_level, scale)
    angles, desc = describe(img_stack, blur_stack, rows, cols, level, n_levels, pad)
    xy_level = torch.stack([cols, rows], -1).to(torch.float32)
    xy = xy_level * s[..., None]
    valid = sel > 0
    return [Keypoints(xy=xy[b], xy_level=xy_level[b], level=level[b], angle=angles[b],
                      score=sel[b], desc=desc[b], valid=valid[b])
            for b in range(len(imgs))]


def extract(img: torch.Tensor, n_features: int = 2000, n_levels: int = 8,
            scale: float = 1.2, ini_th: float = 20.0, min_th: float = 7.0) -> Keypoints:
    """Full pyramid ORB extraction of one image, padded to ``n_features``."""
    return extract_images([img], n_features, n_levels, scale, ini_th, min_th)[0]
