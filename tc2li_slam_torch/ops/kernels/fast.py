"""FAST-9/16 score map: hand-written CUDA kernel + its plain PyTorch version.

Replaces ``tc2li_slam_tpu/ops/kernels/fast.py:fast_score_pallas`` (the only
Pallas kernel of the JAX package), reached through ``orb.fast_score_raw``
for 8 pyramid levels x 2 images per frame.

Bound on the H100: device memory. A pixel reads a 7x7 neighbourhood and
writes one float with ~300 min/max in between, so the plain version's 16
rolled copies and its run stacks are pure traffic. The kernel
(``csrc/fast.cu``) stages a 32x8 tile plus a 3-px halo in shared memory and
keeps the 16 differences in registers: one read of the level (plus halo)
and one write of the score map. Same float operations in the same order,
so it is bit-equal to ``fast_score_raw_plain``.

``fast_score_raw`` launches the kernel for CUDA tensors and runs the plain
version for CPU tensors; there is no other route.
"""

from __future__ import annotations

import torch

from . import build

# FAST circle (dx, dy), radius 3, OpenCV ordering (same as csrc/fast.cu).
FAST_OFFS = ((0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
             (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2), (-1, -3))

launches = 0   # kernel launches by fast_score_raw (plain-version calls excluded)


def fast_score_raw_plain(img: torch.Tensor) -> torch.Tensor:
    """Ungated FAST-16 score [H, W] (``orb._fast_score_raw_xla``)."""
    f = img.to(torch.float32)
    dpos = [torch.roll(f, (-dy, -dx), dims=(0, 1)) - f for dx, dy in FAST_OFFS]
    sb = sd = None
    for s in range(16):
        run_p = dpos[s]
        run_n = -dpos[s]
        for j in range(1, 9):
            d = dpos[(s + j) % 16]
            run_p = torch.minimum(run_p, d)
            run_n = torch.minimum(run_n, -d)
        sb = run_p if sb is None else torch.maximum(sb, run_p)
        sd = run_n if sd is None else torch.maximum(sd, run_n)
    score = torch.maximum(sb, sd)
    H, W = f.shape
    border = torch.zeros((H, W), dtype=torch.bool, device=f.device)
    border[3:H - 3, 3:W - 3] = True
    return torch.where(border, score, torch.zeros_like(score))


def fast_score_raw(img: torch.Tensor) -> torch.Tensor:
    """Ungated FAST-16 score [H, W] float32 of a 2-D image."""
    if img.ndim != 2:
        raise ValueError(f"fast_score_raw takes a 2-D image, got {tuple(img.shape)}")
    if img.device.type == "cpu":
        return fast_score_raw_plain(img)
    if img.device.type != "cuda":
        raise ValueError(f"fast_score_raw: unsupported device {img.device}")
    return fast_score_cuda(img)


def fast_score_cuda(img: torch.Tensor) -> torch.Tensor:
    """Launch ``csrc/fast.cu`` on the current stream."""
    global launches
    f = img.to(torch.float32).contiguous()
    H, W = f.shape
    out = torch.empty_like(f)
    if H == 0 or W == 0:
        return out
    lib = build.library()
    stream = torch.cuda.current_stream(f.device).cuda_stream
    build.check(lib.tc2li_fast_score(f.data_ptr(), out.data_ptr(), H, W, stream),
                "fast_score")
    launches += 1
    return out
