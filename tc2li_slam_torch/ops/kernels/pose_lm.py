"""Pose-only Levenberg-Marquardt: one hand-written CUDA kernel + its plain version.

Replaces ``tc2li_slam_tpu/solver/lm.py:pose_only_optimize`` (line 92), which
the TPU runs as one jit-compiled program: 4 chi2 re-gating rounds of 10 LM
iterations in a ``lax.scan``. Written as eager PyTorch (``pose_only_plain``)
one call issues ~11,600 small ops, each a launch, on every tracked frame.

Bound on the H100: latency. A 4 x 10 call over 2000 observations reads
60 KB and does ~15 M float operations (well under a microsecond of either),
but its 45 passes are serial, each a block-wide reduction and a 6x6 solve.
The kernel (``csrc/pose_lm.cu``) runs the whole call in one launch of a
cluster of 8 blocks of 512 threads, an eighth of the rows each, staged
once in its shared memory (up to 7,096 rows a block; more stream from
device memory): one pass over them an iteration (the pass at the candidate
pose yields its cost and, if accepted, the next H and g), each warp's 28
sums reduced by a reduce-scatter, the blocks' sums exchanged through
distributed shared memory (one cluster barrier a pass), and the solve and
``se3_exp`` on one warp of every block, no host sync. Its sums run in another order than the plain
version's, so poses agree to ~1e-5 and an inlier can flip only where its
chi2 sits at the threshold.

``pose_only_lm`` launches the kernel (CUDA tensors only);
``solver.lm.pose_only_optimize`` sends CUDA tensors there and CPU tensors to
``pose_only_plain``; there is no other route.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ...geom import camera as cam_mod, lie
from ...solver import factors
from ...tensors import count
from . import build

launches = 0   # kernel launches by pose_only_lm (plain-version calls excluded)


class PoseOnlyResult(NamedTuple):
    T_cw: torch.Tensor
    inliers: torch.Tensor
    n_inliers: torch.Tensor
    cost: torch.Tensor


def pose_only_plain(cam: cam_mod.Pinhole, T_cw0, X_w, uv_obs, inv_sigma2, stereo, valid,
                    rounds: int = 4, iters: int = 10) -> PoseOnlyResult:
    """PoseOptimization: LM on the frame pose with chi2 re-gating per round."""
    thresh = torch.where(stereo, factors.CHI2_STEREO, factors.CHI2_MONO)
    eye6 = torch.eye(6, dtype=T_cw0.dtype, device=T_cw0.device)

    def residuals(T, active):
        rr = factors.reproj_residuals(
            cam, T.expand(X_w.shape[0], 4, 4), X_w, uv_obs, inv_sigma2, stereo)
        w = (inv_sigma2 * factors.huber_weight(rr.chi2, thresh)
             * active.to(rr.r.dtype) * rr.depth_ok.to(rr.r.dtype))
        return rr, w

    def cost_of(rr, w):
        return torch.sum(w * torch.sum(rr.r * rr.r, dim=-1))

    T = T_cw0
    active = valid
    cost = torch.zeros((), dtype=T_cw0.dtype, device=T_cw0.device)
    for _ in range(rounds):
        lam = torch.full((), 1e-3, dtype=T.dtype, device=T.device)
        rr0, w0 = residuals(T, active)
        cost = cost_of(rr0, w0)
        for _ in range(iters):
            rr, w = residuals(T, active)
            Jw = rr.J_pose * w[:, None, None]
            H = torch.einsum("oij,oik->jk", Jw, rr.J_pose)
            g = torch.einsum("oij,oi->j", Jw, rr.r)
            Haug = H + lam * torch.diag(torch.diagonal(H)) + 1e-8 * eye6
            # (without the host-side singularity check)
            delta = torch.linalg.solve_ex(Haug, g[:, None], check_errors=False)[0][:, 0]
            T_new = lie.se3_exp(-delta) @ T
            cost_new = cost_of(*residuals(T_new, active))
            accept = cost_new < cost
            T = torch.where(accept, T_new, T)
            lam = torch.where(accept, lam * 0.5, lam * 4.0)
            cost = torch.where(accept, cost_new, cost)
        rr, _ = residuals(T, valid)
        active = valid & (rr.chi2 <= thresh) & rr.depth_ok
    return PoseOnlyResult(T, active, count(active), cost)


def _flag(x: torch.Tensor, N: int, name: str) -> torch.Tensor:
    if tuple(x.shape) != (N,) or x.dtype not in (torch.bool, torch.uint8):
        raise ValueError(f"pose_only_lm: {name} must be bool [{N}], got {x.dtype} "
                         f"{tuple(x.shape)}")
    return x.contiguous().view(torch.uint8)


def pose_only_lm(cam: cam_mod.Pinhole, T_cw0, X_w, uv_obs, inv_sigma2, stereo, valid,
                 rounds: int = 4, iters: int = 10) -> PoseOnlyResult:
    """Launch ``csrc/pose_lm.cu`` on the current stream: what
    ``pose_only_plain`` computes, in one launch."""
    global launches
    if not isinstance(cam, cam_mod.Pinhole):
        raise ValueError(f"pose_only_lm takes a Pinhole camera, got {type(cam).__name__}")
    N = X_w.shape[0]
    dev = T_cw0.device
    for name, x, shape in (("T_cw0", T_cw0, (4, 4)), ("X_w", X_w, (N, 3)),
                           ("uv_obs", uv_obs, (N, 3)), ("inv_sigma2", inv_sigma2, (N,))):
        if tuple(x.shape) != shape or x.dtype != torch.float32:
            raise ValueError(f"pose_only_lm: {name} must be float32 {shape}, got {x.dtype} "
                             f"{tuple(x.shape)}")
    for x in (T_cw0, X_w, uv_obs, inv_sigma2, stereo, valid):
        if x.device.type != "cuda" or x.device != dev:
            raise ValueError(f"pose_only_lm: every tensor must lie on one CUDA device, got "
                             f"{x.device} beside {dev}")
    if rounds < 0 or iters < 0:
        raise ValueError(f"pose_only_lm: rounds {rounds}, iters {iters}")
    st, va = _flag(stereo, N, "stereo"), _flag(valid, N, "valid")
    T0, X, uv, s2 = (x.contiguous() for x in (T_cw0, X_w, uv_obs, inv_sigma2))
    T_out = torch.empty((4, 4), dtype=torch.float32, device=dev)
    inliers = torch.empty(N, dtype=torch.uint8, device=dev)
    n_inliers = torch.empty((), dtype=torch.int32, device=dev)
    cost = torch.empty((), dtype=torch.float32, device=dev)
    lib = build.library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    build.check(lib.tc2li_pose_only_lm(
        T0.data_ptr(), X.data_ptr(), uv.data_ptr(), s2.data_ptr(), st.data_ptr(),
        va.data_ptr(), N, cam.fx, cam.fy, cam.cx, cam.cy, cam.bf, int(rounds), int(iters),
        T_out.data_ptr(), inliers.data_ptr(), n_inliers.data_ptr(), cost.data_ptr(), stream),
        "pose_only_lm")
    launches += 1
    return PoseOnlyResult(T_out, inliers.view(torch.bool), n_inliers, cost)
