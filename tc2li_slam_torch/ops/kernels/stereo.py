"""The stereo half of a frame build: a hand-written CUDA kernel + its plain version.

Replaces ``tc2li_slam_tpu/ops/stereo.py:subpixel_refine`` (line 62,
jit-compiled there) with the tails of ``match_stereo`` and of
``slam/tracking.build_frame`` around it. Eager PyTorch ran that chain as
~140 device events a frame (two replicate-padded copies of both images,
[N, 11, 21] gathers, eleven SAD reductions, a sort for the median).

``stereo_refine`` computes, on CUDA tensors, what ``stereo_refine_plain``
computes: the descriptor match under the row band (``csrc/match.cu``,
its stereo mode), then ``csrc/stereo.cu`` for the rest. Three launches a
frame build, each the programmatic dependent of the one before it: the prep
launch (the right keypoints' bands and the matcher's column-best buffer),
the match, and the refinement with the gate (a warp a keypoint; the last
block to finish takes the median gate where every keypoint is ok). A side 2
wider than the stereo mode's columns is matched in column chunks, a launch
each. ``launches`` counts this module's two. Bound on the H100: operations,
121 x 11 absolute differences a keypoint (``chip_smoke.subpixel_bound``).
Every output is bit-equal to the plain chain on grey-level images (each SAD
is then an exact integer in float32).

``ops/stereo.match_and_refine`` sends CUDA tensors here and CPU tensors to
``stereo_refine_plain``; any other device raises. There is no other route.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import stereo as stereo_mod
from . import build, match

launches = 0   # kernel launches of csrc/stereo.cu (the match's are counted in match.py)
# the arrival counter of the refine launch's last-block gate, one int a
# (device, stream): launches on one stream run one at a time, and the
# kernel leaves it zero for the next call
_sync: dict[tuple[torch.device, int], torch.Tensor] = {}


class StereoResult(NamedTuple):
    ur: torch.Tensor      # [N] refined right u (defined for every keypoint)
    ok: torch.Tensor      # [N] bool: matched, refined and past the SAD gate
    depth: torch.Tensor   # [N] stereo depth, 0 where none
    uvr: torch.Tensor     # [N, 3] (u, v, u_r), u_r = -1 where no depth


def stereo_refine_plain(img_l, img_r, kl, kr, scale_factors, bf: float,
                        min_z: float) -> StereoResult:
    """The eager chain: ``match_stereo``, ``subpixel_refine`` on the level-0
    images, then the depth gate of ``build_frame``."""
    N = kl.xy.shape[0]
    if N == 0:
        e = kl.xy.new_empty(0)
        return StereoResult(e, torch.zeros(0, dtype=torch.bool, device=e.device), e,
                            kl.xy.new_empty((0, 3)))
    idx, disp, ok = stereo_mod.match_stereo(
        kl.xy, kl.level, kl.desc, kl.valid, kr.xy, kr.level, kr.desc, kr.valid,
        scale_factors, bf, min_z)
    return refine_plain(img_l, img_r, kl.xy, disp, ok, bf)


def refine_plain(img_l, img_r, xy, disp, ok, bf: float) -> StereoResult:
    """The eager chain after the match (``csrc/stereo.cu``'s work but the
    matcher's tail): ``subpixel_refine`` and the depth gate."""
    ur0 = xy[:, 0] - disp
    ur_ref, ok2 = stereo_mod.subpixel_refine(img_l.to(torch.float32), img_r.to(torch.float32),
                                             xy, ur0, ok)
    disparity = xy[:, 0] - ur_ref
    has_depth = ok & ok2 & (disparity > 0.1)
    depth = torch.where(has_depth, bf / torch.clamp(disparity, min=0.1), 0.0)
    uvr = torch.cat([xy, torch.where(has_depth, ur_ref, -1.0)[:, None]], dim=-1)
    return StereoResult(ur_ref, ok2, depth, uvr)


def _arg(x, shape, dtype, name):
    if tuple(x.shape) != tuple(shape) or x.dtype != dtype:
        raise ValueError(f"stereo_refine: {name} must be {dtype} {tuple(shape)}, got "
                         f"{x.dtype} {tuple(x.shape)}")
    return x.contiguous()


def stereo_refine(img_l, img_r, kl, kr, scale_factors, bf: float,
                  min_z: float) -> StereoResult:
    """Launch the match and ``csrc/stereo.cu`` on the current stream: what
    ``stereo_refine_plain`` computes, on CUDA tensors, without a host sync.
    The refine launch's gate counts its blocks in at a counter of the
    current stream's own; a refine launch that failed part way may leave it
    non-zero, and the calls after it on that stream are then wrong."""
    global launches
    dev = kl.xy.device
    tensors = (img_l, img_r, scale_factors, *kl, *kr)
    if any(x.device.type != "cuda" or x.device != dev for x in tensors):
        raise ValueError(f"stereo_refine: every tensor must lie on one CUDA device, got "
                         f"{sorted({str(x.device) for x in tensors})}")
    if img_l.ndim != 2 or img_l.shape != img_r.shape or img_l.dtype != img_r.dtype:
        raise ValueError(f"stereo_refine: two [H, W] images of one type, got "
                         f"{tuple(img_l.shape)} {img_l.dtype}, {tuple(img_r.shape)} {img_r.dtype}")
    if img_l.dtype not in (torch.uint8, torch.float32):
        img_l, img_r = img_l.to(torch.float32), img_r.to(torch.float32)
    H, W = img_l.shape
    N, M = kl.xy.shape[0], kr.xy.shape[0]
    f32, i32 = torch.float32, torch.int32
    xy_l, xy_r = _arg(kl.xy, (N, 2), f32, "left xy"), _arg(kr.xy, (M, 2), f32, "right xy")
    lvl_l, lvl_r = _arg(kl.level, (N,), i32, "left level"), _arg(kr.level, (M,), i32, "right level")
    valid_l = _arg(kl.valid, (N,), torch.bool, "left valid")
    valid_r = _arg(kr.valid, (M,), torch.bool, "right valid")
    desc_l, desc_r = _arg(kl.desc, (N, 8), i32, "left desc"), _arg(kr.desc, (M, 8), i32, "right desc")
    if scale_factors.ndim != 1 or scale_factors.shape[0] < 1:
        raise ValueError("stereo_refine: scale_factors must be float32 [n_levels]")
    sf = _arg(scale_factors, scale_factors.shape, f32, "scale_factors")
    img_l, img_r = img_l.contiguous(), img_r.contiguous()
    # (the uint8 route reads 4-byte words of the images; the match, 16-byte
    # descriptor words and 8-byte positions, aligned here: a copy launched
    # between prep and the match would break their chain)
    img_l, img_r = (match.aligned(x, 4) for x in (img_l, img_r))
    desc_l, desc_r = (match.aligned(x, 16) for x in (desc_l, desc_r))
    xy_l, xy_r = (match.aligned(x, 8) for x in (xy_l, xy_r))
    lib = build.library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    counter = _sync.get((dev, stream))
    if counter is None:   # (made before prep: a fill between two chained launches breaks them)
        counter = _sync[(dev, stream)] = torch.zeros(1, dtype=torch.int32, device=dev)

    band = torch.empty(M, dtype=f32, device=dev)
    colbest = torch.empty(M, dtype=torch.int64, device=dev)
    build.check(lib.tc2li_stereo_prep(lvl_r.data_ptr(), sf.data_ptr(), sf.shape[0], M,
                                      band.data_ptr(), colbest.data_ptr(), stream),
                "stereo_refine (prep)")
    launches += int(M > 0)
    max_d = float(np.float32(bf) / np.float32(min_z))   # f32, as match_stereo
    mask = match.StereoMask(xy_l, lvl_l, xy_r, lvl_r, band, max_d)
    idx, best, second, colbest = match.match_best2_packed(desc_l, desc_r, valid_l, valid_r,
                                                          mask, colbest)

    ur = torch.empty(N, dtype=f32, device=dev)
    sad = torch.empty(N, dtype=f32, device=dev)
    ok = torch.empty(N, dtype=torch.uint8, device=dev)
    depth = torch.empty(N, dtype=f32, device=dev)
    uvr = torch.empty((N, 3), dtype=f32, device=dev)
    build.check(lib.tc2li_stereo_refine(
        img_l.data_ptr(), img_r.data_ptr(), int(img_l.dtype == torch.uint8), H, W,
        xy_l.data_ptr(), valid_l.view(torch.uint8).data_ptr(), xy_r.data_ptr(), idx.data_ptr(),
        best.data_ptr(), second.data_ptr(), colbest.data_ptr(), N, float(bf), ur.data_ptr(),
        sad.data_ptr(), ok.data_ptr(), depth.data_ptr(), uvr.data_ptr(), counter.data_ptr(),
        stream), "stereo_refine")
    launches += int(N > 0)
    return StereoResult(ur, ok.view(torch.bool), depth, uvr)


def launches_per_call(n: int, m: int) -> int:
    """This module's launches for n left and m right keypoints (2 at n, m > 0:
    prep, then refine with the gate)."""
    return int(m > 0) + int(n > 0)
