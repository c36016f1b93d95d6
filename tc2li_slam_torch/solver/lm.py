"""Levenberg-Marquardt core with Schur landmark elimination (port of
``tc2li_slam_tpu/solver/lm.py``: ``pose_only_optimize`` and ``local_ba``).

``pose_only_optimize``, on every tracked frame, is one hand-written kernel
on the card (``ops/kernels/pose_lm.py``); ``local_ba`` a fixed sequence of
hand-written kernels (``ops/kernels/local_ba.py``), whose plain version on
the CPU runs the ``lax.scan`` as a Python loop with the same fixed
iteration count. Accept/reject stays on the device either way, so an
optimisation issues no host sync. Small dense solves use
``torch.linalg.solve_ex`` without its host-side error check for the same
reason.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..geom import camera as cam_mod
from ..ops.kernels import local_ba as local_ba_kernel, pose_lm
from ..ops.kernels.pose_lm import PoseOnlyResult
from . import factors


def inv3x3(A: torch.Tensor) -> torch.Tensor:
    """Closed-form batched 3x3 inverse (adjugate / determinant)."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g_, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    A00 = e * i - f * h
    A01 = c * h - b * i
    A02 = b * f - c * e
    A10 = f * g_ - d * i
    A11 = a * i - c * g_
    A12 = c * d - a * f
    A20 = d * h - e * g_
    A21 = b * g_ - a * h
    A22 = a * e - b * d
    det = a * A00 + b * A10 + c * A20
    inv_det = 1.0 / torch.where(torch.abs(det) > 1e-20, det, torch.ones_like(det))
    adj = torch.stack([
        torch.stack([A00, A01, A02], -1),
        torch.stack([A10, A11, A12], -1),
        torch.stack([A20, A21, A22], -1),
    ], -2)
    return adj * inv_det[..., None, None]


def solve(H: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """H x = g without the host-side singularity check."""
    return torch.linalg.solve_ex(H, g[..., None], check_errors=False)[0][..., 0]


def precond_solve(H: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Solve H x = g with Jacobi (diagonal) preconditioning."""
    d = torch.sqrt(torch.clamp(torch.abs(torch.diagonal(H)), min=1e-12))
    Hn = H / (d[:, None] * d[None, :])
    return solve(Hn, g / d) / d


# ---------------------------------------------------------------------------
# Pose-only optimization
# ---------------------------------------------------------------------------

def pose_only_optimize(cam: cam_mod.Pinhole, T_cw0, X_w, uv_obs, inv_sigma2, stereo,
                       valid, rounds: int = 4, iters: int = 10) -> PoseOnlyResult:
    """PoseOptimization: LM on the frame pose with chi2 re-gating per round.

    CUDA tensors go to the one-launch kernel (``ops/kernels/pose_lm.py``),
    CPU tensors to its plain version; any other device raises."""
    args = (cam, T_cw0, X_w, uv_obs, inv_sigma2, stereo, valid, rounds, iters)
    if T_cw0.device.type == "cuda":
        return pose_lm.pose_only_lm(*args)
    if T_cw0.device.type == "cpu":
        return pose_lm.pose_only_plain(*args)
    raise ValueError(f"pose_only_optimize: unsupported device {T_cw0.device}")


# ---------------------------------------------------------------------------
# Local bundle adjustment (visual, T_cw blocks of 6)
# ---------------------------------------------------------------------------

class BAObservations(NamedTuple):
    """Landmark-major padded observation table."""

    pose_idx: torch.Tensor    # [L, K] into the window pose array
    uv: torch.Tensor          # [L, K, 3]
    inv_sigma2: torch.Tensor  # [L, K]
    stereo: torch.Tensor      # [L, K] bool
    valid: torch.Tensor       # [L, K] bool


class BAResult(NamedTuple):
    T_cw: torch.Tensor   # [P, 4, 4]
    X_w: torch.Tensor    # [L, 3]
    cost: torch.Tensor


def _assemble_visual(cam, T_cw, X_w, obs: BAObservations, gate: bool):
    L, K = obs.pose_idx.shape
    pidx = torch.clamp(obs.pose_idx, 0, T_cw.shape[0] - 1).reshape(-1).long()
    rr = factors.reproj_residuals(
        cam, T_cw[pidx], X_w.repeat_interleave(K, dim=0), obs.uv.reshape(-1, 3),
        obs.inv_sigma2.reshape(-1), obs.stereo.reshape(-1))
    thresh = torch.where(obs.stereo.reshape(-1), factors.CHI2_STEREO, factors.CHI2_MONO)
    w_huber = factors.huber_weight(rr.chi2, thresh)
    active = obs.valid.reshape(-1) & rr.depth_ok
    if gate:
        active = active & (rr.chi2 <= thresh)
    w = obs.inv_sigma2.reshape(-1) * w_huber * active.to(rr.r.dtype)
    return rr, w, active, pidx


def local_ba(cam: cam_mod.Pinhole, T_cw0, X_w0, obs: BAObservations, fixed_pose,
             valid_lm, iters: int = 10,
             extra_fn: Callable | None = None) -> BAResult:
    """LocalBundleAdjustment core with a dense reduced camera system.

    ``extra_fn(T_cw) -> (H [6P, 6P], g [6P], cost)`` injects dense cross-pose
    terms (the BALM eigen-factor); like the reference it is linearised once
    at the entry poses, and the whole update is reverted if the true total
    cost at the exit poses is higher than at entry.

    CUDA tensors go to the kernel sequence (``ops/kernels/local_ba.py``), CPU
    tensors to its plain version; any other device raises."""
    args = (cam, T_cw0, X_w0, obs, fixed_pose, valid_lm, iters, extra_fn)
    if T_cw0.device.type == "cuda":
        return local_ba_kernel.local_ba_lm(*args)
    if T_cw0.device.type == "cpu":
        return local_ba_kernel.local_ba_plain(*args)
    raise ValueError(f"local_ba: unsupported device {T_cw0.device}")
