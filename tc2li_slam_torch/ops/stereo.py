"""Batched stereo keypoint matching with subpixel refinement
(port of ``tc2li_slam_tpu/ops/stereo.py``, Frame::ComputeStereoMatches).

``match_and_refine`` is the frame build's entry: CUDA tensors go to the
kernels of ``ops/kernels/stereo.py`` (the match, then ``csrc/stereo.cu``),
CPU tensors to its plain chain of ``match_stereo`` and ``subpixel_refine``
below; any other device raises."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from . import matching
from .kernels import stereo as stereo_kernel
from .kernels.match import StereoMask

SAD_W = 5      # half window (11x11 patches)
SAD_L = 5      # slide +-5 px


def match_stereo(kpl_uv, kpl_level, kpl_desc, kpl_valid, kpr_uv, kpr_level,
                 kpr_desc, kpr_valid, scale_factors, bf: float, min_z: float):
    """Descriptor stage: (right_idx [N], disparity [N], valid [N]).

    Row band |v_l - v_r| <= 2 scale(level_r), disparity in [-2, bf/min_z],
    octave gate, mutual best + ratio 0.9."""
    max_d = float(np.float32(bf) / np.float32(min_z))   # f32, as the reference
    band = 2.0 * scale_factors[kpr_level.long()]
    mask = StereoMask(kpl_uv, kpl_level, kpr_uv, kpr_level, band, max_d)
    idx, dist, ok = matching.match_descriptors(
        kpl_desc, kpr_desc, kpl_valid, kpr_valid, mask,
        max_dist=matching.TH_HIGH, ratio=0.9, mutual=True,
    )
    disparity = torch.clamp(kpl_uv[:, 0] - kpr_uv[idx, 0], min=0.01)
    return idx, disparity, ok


def median_nan(x: torch.Tensor) -> torch.Tensor:
    """``jnp.median`` of a 1-D tensor: NaN if any entry is NaN, the mean of
    the two middle values for an even count."""
    n = x.shape[0]
    if n == 0:
        return x.new_full((), float("nan"))
    s = torch.sort(x).values
    lo, hi = s[(n - 1) // 2], s[n // 2]
    med = (lo + hi) * 0.5
    return torch.where(torch.isnan(x).any(), torch.full_like(med, float("nan")), med)


def subpixel_refine(img_l, img_r, kpl_uv, ur0, valid):
    """Parabola-refined right u + SAD outlier gate (Frame.cc:900-960), on the
    level-0 images. Returns (u_r [N], ok [N])."""
    H, W = img_l.shape
    r = torch.round(kpl_uv[:, 1]).to(torch.int64)
    cl = torch.round(kpl_uv[:, 0]).to(torch.int64)
    cr = torch.round(ur0).to(torch.int64)
    valid = valid & (cr >= 0) & (cr < W) & (r >= 0) & (r < H)
    r = torch.clamp(r, 0, H - 1)
    cl = torch.clamp(cl, 0, W - 1)
    cr = torch.clamp(cr, 0, W - 1)

    W_L = SAD_W + SAD_L
    pad_l = F.pad(img_l.to(torch.float32)[None, None], (SAD_W,) * 4, mode="replicate")[0, 0]
    pad_r = F.pad(img_r.to(torch.float32)[None, None], (W_L,) * 4, mode="replicate")[0, 0]
    dev = img_l.device
    a11 = torch.arange(2 * SAD_W + 1, device=dev)
    a21 = torch.arange(2 * W_L + 1, device=dev)
    # padding shifts coordinates by +half and the slice starts at the top-left
    # corner: the two cancel, so the centre coordinate is the start index
    patch_l = pad_l[r[:, None, None] + a11[None, :, None], cl[:, None, None] + a11[None, None, :]]
    patch_l = patch_l - patch_l[:, SAD_W:SAD_W + 1, SAD_W:SAD_W + 1]
    strip = pad_r[(r + SAD_L)[:, None, None] + a11[None, :, None],
                  cr[:, None, None] + a21[None, None, :]]          # [N, 11, 21]

    sads = []
    for off in range(2 * SAD_L + 1):
        win = strip[:, :, off:off + 2 * SAD_W + 1]
        win = win - win[:, SAD_W:SAD_W + 1, SAD_W:SAD_W + 1]
        sads.append(torch.sum(torch.abs(win - patch_l), dim=(1, 2)))
    sad = torch.stack(sads, dim=-1)                                  # [N, 11]

    best = torch.argmin(sad, dim=-1)
    best_c = torch.clamp(best, 1, 2 * SAD_L - 1)
    s_m = torch.gather(sad, 1, (best_c - 1)[:, None])[:, 0]
    s_0 = torch.gather(sad, 1, best_c[:, None])[:, 0]
    s_p = torch.gather(sad, 1, (best_c + 1)[:, None])[:, 0]
    denom = torch.clamp(2.0 * (s_m + s_p - 2.0 * s_0), min=1e-6)
    delta = torch.clamp((s_m - s_p) / denom, -1.0, 1.0)
    ur = cr.to(torch.float32) + (best_c - SAD_L).to(torch.float32) + delta
    ok = valid & (torch.abs(delta) <= 1.0)

    best_sad = s_0
    med = median_nan(torch.where(ok, best_sad, torch.full_like(best_sad, float("nan"))))
    thr = 2.1 * torch.nan_to_num(med, nan=float("inf"))
    ok = ok & (best_sad <= thr)
    return ur, ok


def match_and_refine(img_l, img_r, kl, kr, scale_factors, bf: float, min_z: float):
    """Stereo match, subpixel refinement and depth of the left keypoints
    ``kl`` against ``kr`` (``orb.Keypoints``) on the level-0 images:
    ``StereoResult(ur, ok, depth, uvr)`` of ``ops/kernels/stereo.py``."""
    if kl.xy.device.type == "cuda":
        return stereo_kernel.stereo_refine(img_l, img_r, kl, kr, scale_factors, bf, min_z)
    if kl.xy.device.type == "cpu":
        return stereo_kernel.stereo_refine_plain(img_l, img_r, kl, kr, scale_factors, bf, min_z)
    raise ValueError(f"match_and_refine: unsupported device {kl.xy.device}")
