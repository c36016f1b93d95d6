"""Batched ORB extraction (pyramid FAST + oriented rBRIEF) on torch tensors.

Port of ``tc2li_slam_tpu/ops/orb.py:extract`` and the stages it runs:
pyramid resize, detection (adaptive two-threshold FAST + 3x3 NMS),
``select_topk_grid``, ``gaussian_blur7`` and the stacked orientation /
rBRIEF over all levels' keypoints. ``extract_images`` builds the padded
level stack of one or two images first and then detects on the whole stack
at once: two launches of the CUDA kernels of ``ops.kernels.fast`` for all
levels (and both images of a stereo pair), where the JAX package calls
``detect_level`` per level.

Three deliberate differences in form, same results:

- Detection runs on the level stack after the pyramid is built, not level
  by level; ``detect_level`` is the one-plane entry of the same route.

- rBRIEF gathers its 512 taps directly from the edge-padded blurred level
  stack, after the reference's integer rounding of the patch values. The
  JAX package reads them through a one-hot bf16 contraction shaped for the
  TPU's matrix unit ([K, 512, 1521], 3.1 GB per image in eager torch).
- The pyramid resize is ``jax.image.resize(..., "linear")`` written out:
  the same antialiased triangle weight matrices, applied as two matrix
  products (rows, then columns).

Descriptors are [K, 8] int32 tensors holding the uint32 words.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ._orb_pattern import PATTERN
from .kernels import fast

HALF_PATCH = 15


def _umax_table() -> np.ndarray:
    umax = np.zeros(HALF_PATCH + 2, np.int32)
    vmax = int(np.floor(HALF_PATCH * np.sqrt(2.0) / 2 + 1))
    vmin = int(np.ceil(HALF_PATCH * np.sqrt(2.0) / 2))
    for v in range(vmax + 1):
        umax[v] = int(np.round(np.sqrt(225.0 - v * v)))
    v0 = 0
    for v in range(HALF_PATCH, vmin - 1, -1):
        while umax[v0] == umax[v0 + 1]:
            v0 += 1
        umax[v] = v0
        v0 += 1
    return umax[: HALF_PATCH + 1]


def _ic_angle_weights():
    u = np.arange(-HALF_PATCH, HALF_PATCH + 1)
    U, V = np.meshgrid(u, u)
    mask = (np.abs(U) <= _umax_table()[np.abs(V)]).astype(np.float32)
    return mask, U.astype(np.float32), V.astype(np.float32)


def _gauss_kernel7(sigma: float = 2.0) -> np.ndarray:
    x = np.arange(-3, 4, dtype=np.float64)
    k = np.exp(-(x * x) / (2 * sigma * sigma))
    return (k / k.sum()).astype(np.float32)


_GK7 = [float(v) for v in _gauss_kernel7()]
_PATTERN_RADIUS = int(np.ceil(np.sqrt(
    np.maximum(PATTERN[:, 0] ** 2 + PATTERN[:, 1] ** 2,
               PATTERN[:, 2] ** 2 + PATTERN[:, 3] ** 2).max()) + 0.5))


@functools.lru_cache(maxsize=None)
def _constants(device: torch.device) -> dict[str, torch.Tensor]:
    """Orientation weights and the rBRIEF pattern, resident on ``device``."""
    mask, U, V = _ic_angle_weights()
    pat = PATTERN.astype(np.float32)
    c = {
        "ic_u": mask * U,
        "ic_v": mask * V,
        "px": np.concatenate([pat[:, 0], pat[:, 2]]),
        "py": np.concatenate([pat[:, 1], pat[:, 3]]),
        "shifts": np.arange(32, dtype=np.int64),
    }
    return {k: torch.as_tensor(v).to(device) for k, v in c.items()}


class Keypoints(NamedTuple):
    """Padded keypoint set for one image."""

    xy: torch.Tensor        # [N, 2] level-0 pixel coords (x, y)
    xy_level: torch.Tensor  # [N, 2] coords on the detection level
    level: torch.Tensor     # [N] int32 pyramid level
    angle: torch.Tensor     # [N] radians
    score: torch.Tensor     # [N] FAST score
    desc: torch.Tensor      # [N, 8] int32 rBRIEF words (uint32 bit patterns)
    valid: torch.Tensor     # [N] bool


# ---------------------------------------------------------------------------
# Pyramid
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _resize_weights_np(in_size: int, out_size: int) -> np.ndarray:
    """[in, out] float32 antialiased triangle weights, computed exactly as
    ``jax.image.resize(..., "linear")`` does (float32 throughout)."""
    scale = out_size / in_size
    inv_scale = np.float32(1.0 / scale)
    kernel_scale = np.maximum(inv_scale, np.float32(1.0))
    sample_f = ((np.arange(out_size, dtype=np.float32) + np.float32(0.5)) * inv_scale
                - np.float32(0.0) - np.float32(0.5))
    x = np.abs(sample_f[None, :] - np.arange(in_size, dtype=np.float32)[:, None]) / kernel_scale
    w = np.maximum(np.float32(0.0), np.float32(1.0) - np.abs(x))
    total = w.sum(axis=0, keepdims=True, dtype=np.float32)
    eps = np.float32(1000.0 * float(np.finfo(np.float32).eps))
    w = np.where(np.abs(total) > eps, w / np.where(total != 0, total, np.float32(1.0)),
                 np.float32(0.0))
    inside = (sample_f >= -0.5) & (sample_f <= np.float32(in_size - 0.5))
    return np.where(inside[None, :], w, np.float32(0.0)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _resize_weights(in_size: int, out_size: int, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(_resize_weights_np(in_size, out_size)).to(device)


def resize_linear(f: torch.Tensor, shape: tuple[int, int]) -> torch.Tensor:
    """Antialiased bilinear resize of a float32 [H, W] image."""
    H, W = f.shape
    Hl, Wl = shape
    wr = _resize_weights(H, Hl, f.device)   # [H, Hl]
    wc = _resize_weights(W, Wl, f.device)   # [W, Wl]
    return (wr.T @ f) @ wc


def level_shape(H: int, W: int, scale: float, lvl: int) -> tuple[int, int]:
    s = scale ** lvl
    return max(int(round(H / s)), 64), max(int(round(W / s)), 64)


def pyramid(f: torch.Tensor, n_levels: int, scale: float) -> list[torch.Tensor]:
    H, W = f.shape
    return [f if lvl == 0 else resize_linear(f, level_shape(H, W, scale, lvl))
            for lvl in range(n_levels)]


# ---------------------------------------------------------------------------
# Detection
# ---------------------------------------------------------------------------

def detect_level(img: torch.Tensor, ini_th: float = 20.0, min_th: float = 7.0,
                 cell: int = 35) -> torch.Tensor:
    """Adaptive-threshold FAST + 3x3 NMS score map (ComputeKeyPointsOctTree)
    of one image: ``fast.detect_planes`` on a one-plane stack."""
    f = img.to(torch.float32)
    return fast.detect_planes(f[None], (f.shape,), 0, ini_th, min_th, cell)[0]


def topk_stable(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last axis, ties to the lower index (``lax.top_k``)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def select_topk_grid(score: torch.Tensor, k: int, cell: int = 16):
    """Pick k keypoints: per-cell best first, then by score.

    Returns (rows [k], cols [k], scores [k]); empty slots have score 0."""
    H, W = score.shape
    Hc = -(-H // cell)
    Wc = -(-W // cell)
    n_cells = Hc * Wc
    m_cand = max(2, -(-k // n_cells) + 1)
    sp = F.pad(score, (0, Wc * cell - W, 0, Hc * cell - H), value=float("-inf"))
    cells = sp.reshape(Hc, cell, Wc, cell).permute(0, 2, 1, 3).reshape(n_cells, cell * cell)
    cvals, cidx = topk_stable(cells, m_cand)                # [n_cells, m]
    ci = torch.arange(n_cells, device=score.device)[:, None]
    rows_c = (ci // Wc) * cell + cidx // cell
    cols_c = (ci % Wc) * cell + cidx % cell
    boost = torch.zeros((n_cells, m_cand), dtype=score.dtype, device=score.device)
    boost[:, 0] = 1e6
    rank = torch.where(torch.isfinite(cvals) & (cvals > 0), cvals + boost,
                       torch.full_like(cvals, float("-inf")))
    vals, idx = topk_stable(rank.reshape(-1), k)
    rows = rows_c.reshape(-1)[idx]
    cols = cols_c.reshape(-1)[idx]
    sel = cvals.reshape(-1)[idx]
    ok = torch.isfinite(vals) & (vals > 0)
    return (torch.where(ok, rows, 0).to(torch.int32),
            torch.where(ok, cols, 0).to(torch.int32),
            torch.where(ok, sel, torch.zeros_like(sel)))


# ---------------------------------------------------------------------------
# Orientation + descriptors
# ---------------------------------------------------------------------------

def gaussian_blur7(img: torch.Tensor) -> torch.Tensor:
    """Separable 7-tap Gaussian (sigma 2), REFLECT_101 borders."""
    f = img.to(torch.float32)
    H, W = f.shape
    fp = F.pad(f[None, None], (0, 0, 3, 3), mode="reflect")[0, 0]
    acc = fp[0:H] * _GK7[0]
    for i in range(1, 7):
        acc = acc + fp[i:i + H] * _GK7[i]
    fp = F.pad(acc[None, None], (3, 3, 0, 0), mode="reflect")[0, 0]
    out = fp[:, 0:W] * _GK7[0]
    for i in range(1, 7):
        out = out + fp[:, i:i + W] * _GK7[i]
    return out


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


def compute_orientation_stacked(stack, lvl, rows, cols, pad: int):
    """Intensity-centroid angle from [K, 31, 31] patches of the padded
    level stack (IC_Angle)."""
    c = _constants(stack.device)
    ar = torch.arange(-HALF_PATCH, HALF_PATCH + 1, device=stack.device)
    r = (rows.long() + pad)[:, None, None] + ar[None, :, None]
    cc = (cols.long() + pad)[:, None, None] + ar[None, None, :]
    patches = stack[lvl.long()[:, None, None], r, cc]
    m10 = torch.sum(patches * c["ic_u"], dim=(1, 2))
    m01 = torch.sum(patches * c["ic_v"], dim=(1, 2))
    return torch.atan2(m01, m10)


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """[K, 256] {0,1} -> [K, 8] int32 words, LSB first (uint32 patterns)."""
    shifts = _constants(bits.device)["shifts"]
    w = torch.sum(bits.reshape(-1, 8, 32).to(torch.int64) << shifts, dim=-1)
    return torch.where(w >= 2 ** 31, w - 2 ** 32, w).to(torch.int32)


def compute_descriptors_stacked(blur_stack, lvl, rows, cols, angles, pad: int):
    """Steered BRIEF-256 -> [K, 8] int32 words (computeOrbDescriptor).

    Each of the 512 rotated taps is read directly from the padded blurred
    stack; tap offsets are clipped to the pattern radius and the values
    rounded to integers, as the reference does to its patches."""
    c = _constants(blur_stack.device)
    a = torch.cos(angles)[:, None]
    b = torch.sin(angles)[:, None]
    R = _PATTERN_RADIUS
    roff = torch.round(c["px"][None] * b + c["py"][None] * a).to(torch.int64)
    coff = torch.round(c["px"][None] * a - c["py"][None] * b).to(torch.int64)
    r = (rows.long() + pad)[:, None] + torch.clamp(roff, -R, R)
    cc = (cols.long() + pad)[:, None] + torch.clamp(coff, -R, R)
    vals = torch.round(blur_stack[lvl.long()[:, None], r, cc])   # [K, 512]
    bits = vals[:, :256] < vals[:, 256:]
    return pack_bits(bits)


def level_stacks(fs, n_levels: int, scale: float):
    """Edge-padded pyramid stacks of equally sized float32 images:
    ``(img_stack, blur_stack, shapes, pad)``. Plane ``b * n_levels + lvl`` of
    both [B * n_levels, H + 2 pad, W + 2 pad] stacks holds level ``lvl`` of
    image ``b`` (resp. its 7-tap blur) with pixel (0, 0) at ``[pad, pad]``
    and a replicated border of ``pad``; ``shapes`` lists each plane's
    (Hl, Wl)."""
    H, W = fs[0].shape
    if any(f.shape != (H, W) for f in fs):
        raise ValueError(f"images of one size expected, got {[tuple(f.shape) for f in fs]}")
    pad = max(HALF_PATCH, _PATTERN_RADIUS)
    img_stack = torch.zeros((len(fs) * n_levels, H + 2 * pad, W + 2 * pad),
                            dtype=torch.float32, device=fs[0].device)
    blur_stack = torch.zeros_like(img_stack)
    shapes = []
    for b, f in enumerate(fs):
        for lvl, lvl_img in enumerate(pyramid(f, n_levels, scale)):
            Hl, Wl = lvl_img.shape
            p = b * n_levels + lvl
            img_stack[p, :Hl + 2 * pad, :Wl + 2 * pad] = F.pad(
                lvl_img[None, None], (pad,) * 4, mode="replicate")[0, 0]
            blur_stack[p, :Hl + 2 * pad, :Wl + 2 * pad] = F.pad(
                gaussian_blur7(lvl_img)[None, None], (pad,) * 4, mode="replicate")[0, 0]
            shapes.append((Hl, Wl))
    return img_stack, blur_stack, shapes, pad


def extract_images(imgs, n_features: int = 2000, n_levels: int = 8,
                   scale: float = 1.2, ini_th: float = 20.0,
                   min_th: float = 7.0) -> list[Keypoints]:
    """Full pyramid ORB extraction of equally sized images (one, or the two
    of a stereo pair), each padded to ``n_features`` keypoints. All levels
    of all images are detected in one call of ``fast.detect_planes``."""
    fs = [img.to(torch.float32) for img in imgs]
    dev = fs[0].device
    per_level = features_per_level(n_features, n_levels, scale)
    img_stack, blur_stack, shapes, pad = level_stacks(fs, n_levels, scale)
    scores = fast.detect_planes(img_stack, shapes, pad, ini_th, min_th)

    out = []
    for b in range(len(fs)):
        planes = slice(b * n_levels, (b + 1) * n_levels)
        rows_l, cols_l, scores_l, lvl_l, s_l = [], [], [], [], []
        for lvl, (Hl, Wl) in enumerate(shapes[planes]):
            rows, cols, sel = select_topk_grid(scores[b * n_levels + lvl, :Hl, :Wl],
                                               per_level[lvl])
            k = rows.shape[0]
            rows_l.append(rows)
            cols_l.append(cols)
            scores_l.append(sel)
            lvl_l.append(torch.full((k,), lvl, dtype=torch.int32, device=dev))
            s_l.append(torch.full((k,), scale ** lvl, dtype=torch.float32, device=dev))
        rows_all = torch.cat(rows_l)
        cols_all = torch.cat(cols_l)
        scores_all = torch.cat(scores_l)
        lvl_all = torch.cat(lvl_l)
        s_all = torch.cat(s_l)
        angles = compute_orientation_stacked(img_stack[planes], lvl_all, rows_all,
                                             cols_all, pad)
        desc = compute_descriptors_stacked(blur_stack[planes], lvl_all, rows_all,
                                           cols_all, angles, pad)
        xy_level = torch.stack([cols_all, rows_all], -1).to(torch.float32)
        out.append(Keypoints(
            xy=xy_level * s_all[:, None], xy_level=xy_level, level=lvl_all,
            angle=angles, score=scores_all, desc=desc, valid=scores_all > 0,
        ))
    return out


def extract(img: torch.Tensor, n_features: int = 2000, n_levels: int = 8,
            scale: float = 1.2, ini_th: float = 20.0, min_th: float = 7.0) -> Keypoints:
    """Full pyramid ORB extraction of one image, padded to ``n_features``."""
    return extract_images([img], n_features, n_levels, scale, ini_th, min_th)[0]
