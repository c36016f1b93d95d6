"""Levenberg-Marquardt core with Schur landmark elimination (port of
``tc2li_slam_tpu/solver/lm.py``: ``pose_only_optimize`` and ``local_ba``).

``pose_only_optimize``, on every tracked frame, is one hand-written kernel
on the card (``ops/kernels/pose_lm.py``). ``local_ba``'s ``lax.scan``
becomes a Python loop with the same fixed iteration count; accept/reject
stays on the device (``torch.where``), so an optimisation issues no host
sync. Small dense solves use ``torch.linalg.solve_ex`` without its
host-side error check for the same reason.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..geom import camera as cam_mod, lie
from ..ops.kernels import pose_lm
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
    cost at the exit poses is higher than at entry."""
    P = T_cw0.shape[0]
    L, K = obs.pose_idx.shape
    D = 6 * P
    dt, dev = T_cw0.dtype, T_cw0.device
    eye3 = torch.eye(3, dtype=dt, device=dev)
    eyeD = torch.eye(D, dtype=dt, device=dev)
    free = (~fixed_pose).to(dt)
    mask_d = free.repeat_interleave(6)
    onehot = (torch.clamp(obs.pose_idx, 0, P - 1).reshape(-1)[:, None]
              == torch.arange(P, device=dev)[None, :]).to(dt)       # [O, P]
    oh = onehot.reshape(L, K, P)
    lmw = valid_lm.to(dt)
    if extra_fn is not None:
        H_e0, g_e0, c_e0 = extra_fn(T_cw0)

    def build_and_solve(T_cw, X_w, lam, xi):
        rr, w, _, _ = _assemble_visual(cam, T_cw, X_w, obs, False)
        Jp = rr.J_pose * w[:, None, None]
        Jl = rr.J_lm
        Hpp_blk = torch.einsum("oij,oik->ojk", Jp, rr.J_pose)
        gp_blk = torch.einsum("oij,oi->oj", Jp, rr.r)
        Hpp = torch.einsum("op,ojk->pjk", onehot, Hpp_blk)
        gp = torch.einsum("op,oj->pj", onehot, gp_blk)
        Jlw = rr.J_lm * w[:, None, None]
        Hll = torch.einsum("oij,oik->ojk", Jlw, rr.J_lm).reshape(L, K, 3, 3).sum(dim=1)
        gl = torch.einsum("oij,oi->oj", Jlw, rr.r).reshape(L, K, 3).sum(dim=1)
        B = torch.einsum("oij,oik->ojk", Jp, Jl).reshape(L, K, 6, 3)
        Hll_d = Hll + (lam * torch.diag_embed(torch.diagonal(Hll, dim1=-2, dim2=-1))
                       + 1e-6 * eye3)
        Hll_inv = inv3x3(Hll_d) * lmw[:, None, None]
        BHinv = torch.einsum("lkij,ljm->lkim", B, Hll_inv)
        U = torch.einsum("lkp,lkim->lpim", oh, BHinv)
        V = torch.einsum("lkp,lkjm->lpjm", oh, B)
        corr_pq = torch.einsum("lpim,lqjm->pqij", U, V)
        S = torch.zeros((P, P, 6, 6), dtype=dt, device=dev)
        ar = torch.arange(P, device=dev)
        S[ar, ar] = Hpp
        S = S - corr_pq
        gp_red = gp - torch.einsum("lpim,lm->pi", U, gl)
        S = S * free[:, None, None, None] * free[None, :, None, None]
        Sd = S.permute(0, 2, 1, 3).reshape(D, D)
        Sd = Sd + torch.diag((1.0 - free).repeat_interleave(6))
        Sd = Sd + lam * torch.diag(torch.diagonal(Sd)) + 1e-8 * eyeD
        gp_red = gp_red * free[:, None]
        if extra_fn is not None:
            g_e = g_e0 + H_e0 @ xi.reshape(-1)
            Sd = Sd + H_e0 * mask_d[:, None] * mask_d[None, :]
            gp_red = gp_red + (g_e * mask_d).reshape(P, 6)
        delta_p = -precond_solve(Sd, gp_red.reshape(-1)).reshape(P, 6) * free[:, None]
        dp_per_obs = torch.einsum("lkp,pj->lkj", oh, delta_p)
        Bt_dp = torch.einsum("lkij,lki->lj", B, dp_per_obs)
        delta_l = -torch.einsum("lij,lj->li", Hll_inv, gl + Bt_dp) * valid_lm[:, None]
        return delta_p, delta_l

    def total_cost(T_cw, X_w, xi):
        rr, w, _, _ = _assemble_visual(cam, T_cw, X_w, obs, False)
        c = torch.sum(w * torch.sum(rr.r * rr.r, dim=-1))
        if extra_fn is not None:
            x = xi.reshape(-1)
            c = c + c_e0 + g_e0 @ x + 0.5 * (x @ (H_e0 @ x))
        return c

    xi = torch.zeros((P, 6), dtype=dt, device=dev)
    cost0 = total_cost(T_cw0, X_w0, xi)
    T_cw, X_w, cost = T_cw0, X_w0, cost0
    lam = torch.full((), 1e-4, dtype=dt, device=dev)
    for _ in range(iters):
        dp, dl = build_and_solve(T_cw, X_w, lam, xi)
        T_new = lie.se3_exp(dp) @ T_cw
        X_new = X_w + dl
        xi_new = xi + dp
        cost_new = total_cost(T_new, X_new, xi_new)
        accept = cost_new < cost
        T_cw = torch.where(accept, T_new, T_cw)
        X_w = torch.where(accept, X_new, X_w)
        xi = torch.where(accept, xi_new, xi)
        lam = torch.where(accept, lam * 0.5, lam * 4.0)
        cost = torch.where(accept, cost_new, cost)

    if extra_fn is not None:
        rr_t, w_t, _, _ = _assemble_visual(cam, T_cw, X_w, obs, False)
        _, _, c_true = extra_fn(T_cw)
        true_total = torch.sum(w_t * torch.sum(rr_t.r * rr_t.r, dim=-1)) + c_true
        ok_true = true_total <= cost0
        T_cw = torch.where(ok_true, T_cw, T_cw0)
        X_w = torch.where(ok_true, X_w, X_w0)
        cost = torch.where(ok_true, true_total, cost0)
    return BAResult(T_cw, X_w, cost)
