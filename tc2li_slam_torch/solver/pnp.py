"""Batched-hypothesis PnP RANSAC (port of ``tc2li_slam_tpu/solver/pnp.py``).

All hypotheses run as one batch: each solves the 6-point DLT (the P matrix
from the SVD of the [2n, 12] design, its rotation snapped to SO(3) by a 3x3
SVD), inliers are counted for all hypotheses at once, and the winner is
polished by the pose-only LM. The SVDs check their status on the host; this
solver only runs on the recovery and relocalization paths, which the host
gates on a fetched inlier count anyway.

The reference draws each hypothesis' points by Gumbel top-k from a JAX key.
Here the caller passes either a ``torch.Generator`` on the tensors' device or
the index tensor ``sample_idx`` [n_hyp, min_pts] itself (what the parity
tests do, with the indices the JAX code drew).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..geom import camera as cam_mod, lie
from ..ops.orb import topk_stable
from ..tensors import count
from . import lm as lm_mod


def _dlt_pose(X: torch.Tensor, xn: torch.Tensor) -> torch.Tensor:
    """DLT pose from n >= 6 correspondences: world points [..., n, 3],
    normalized image coordinates [..., n, 2] -> T_cw [..., 4, 4]."""
    Xh = torch.cat([X, torch.ones_like(X[..., :1])], dim=-1)       # [..., n, 4]
    zero = torch.zeros_like(Xh)
    r1 = torch.cat([Xh, zero, -xn[..., 0:1] * Xh], dim=-1)
    r2 = torch.cat([zero, Xh, -xn[..., 1:2] * Xh], dim=-1)
    A = torch.cat([r1, r2], dim=-2)                                # [..., 2n, 12]
    # the SVD refuses non-finite input: such a design is solved as zeros and
    # its pose set to NaN below, so that it counts no inlier
    finite = torch.all(torch.isfinite(A), dim=(-2, -1))
    A = torch.where(finite[..., None, None], A, 0.0)
    _, _, Vh = torch.linalg.svd(A, full_matrices=True)
    p = Vh[..., -1, :].reshape(X.shape[:-2] + (3, 4))
    # scale and sign: det(R) > 0 and of unit size
    det = torch.linalg.det(p[..., :3])
    scale = torch.pow(torch.abs(det) + 1e-12, 1.0 / 3.0)
    p = p * (torch.sign(det) / torch.clamp(scale, min=1e-12))[..., None, None]
    T = lie.se3(lie.orthogonalize(p[..., :3]), p[..., 3])
    return torch.where(finite[..., None, None], T, torch.nan)


class PnPResult(NamedTuple):
    T_cw: torch.Tensor
    inliers: torch.Tensor    # [N] bool
    n_inliers: torch.Tensor  # [] int32
    ok: torch.Tensor         # [] bool


def draw_samples(valid: torch.Tensor, n_hyp: int, min_pts: int,
                 generator: torch.Generator) -> torch.Tensor:
    """[n_hyp, min_pts] indices, each row ``min_pts`` distinct valid points
    drawn uniformly (Gumbel top-k); where fewer are valid the row is filled
    with the first invalid ones, as in the reference."""
    u = torch.rand((n_hyp, valid.shape[0]), generator=generator, device=valid.device)
    gumbel = -torch.log(-torch.log(torch.clamp(u, 1e-20, 1.0 - 1e-7)))
    gumbel = torch.where(valid[None, :], gumbel, -torch.inf)
    return topk_stable(gumbel, min_pts)[1]


def pnp_ransac(cam: cam_mod.Pinhole, X_w, uv, valid, generator: torch.Generator | None = None,
               n_hyp: int = 64, min_pts: int = 6, thresh_px: float = 4.0,
               min_inliers: int = 12, sample_idx: torch.Tensor | None = None) -> PnPResult:
    """Batched RANSAC + DLT + pose-only polish.

    ``X_w`` [N, 3], ``uv`` [N, 2], ``valid`` [N]. Give ``sample_idx``
    [n_hyp, min_pts], or a ``generator`` to draw it."""
    N = X_w.shape[0]
    if sample_idx is None:
        if generator is None:
            raise ValueError("pnp_ransac needs a generator or sample_idx")
        sample_idx = draw_samples(valid, n_hyp, min_pts, generator)
    xn = torch.stack([(uv[:, 0] - cam.cx) / cam.fx, (uv[:, 1] - cam.cy) / cam.fy], dim=-1)
    idx = sample_idx.long()
    Ts = _dlt_pose(X_w[idx], xn[idx])                              # [H, 4, 4]

    # inliers of all hypotheses at once; a non-finite hypothesis fails every
    # comparison and counts none
    Xc = torch.einsum("hij,nj->hni", Ts[:, :3, :3], X_w) + Ts[:, None, :3, 3]
    z = Xc[..., 2]
    z_safe = torch.where(torch.abs(z) < 1e-6, torch.full_like(z, 1e-6), z)
    pred_u = cam.fx * Xc[..., 0] / z_safe + cam.cx
    pred_v = cam.fy * Xc[..., 1] / z_safe + cam.cy
    err2 = (pred_u - uv[None, :, 0]) ** 2 + (pred_v - uv[None, :, 1]) ** 2
    inl = (err2 < thresh_px ** 2) & (z > 0.1) & valid[None, :]
    counts = count(inl, dim=-1)                                    # [H]
    best = torch.argmax(counts).reshape(1)                         # first on ties
    T_best = Ts.index_select(0, best)[0]
    inliers = inl.index_select(0, best)[0]
    ok = counts.index_select(0, best)[0] >= min_inliers
    # the identity stands in for a winner that is not finite (it counted no
    # inlier, so ``ok`` is already False): the polish must not return NaN
    finite = torch.all(torch.isfinite(T_best))
    T_best = torch.where(finite, T_best, torch.eye(4, dtype=T_best.dtype, device=T_best.device))

    # polish with the pose-only LM on the inlier set (no stereo column)
    uvr = torch.cat([uv, -torch.ones_like(uv[:, :1])], dim=-1)
    res = lm_mod.pose_only_optimize(
        cam, T_best, X_w, uvr, torch.ones_like(uv[:, 0]),
        torch.zeros(N, dtype=torch.bool, device=uv.device), inliers, rounds=2, iters=8)
    return PnPResult(res.T_cw, res.inliers, res.n_inliers, ok)
