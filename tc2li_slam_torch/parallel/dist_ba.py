"""Distributed bundle adjustment over a ``torch.distributed`` process group
(port of ``tc2li_slam_tpu/parallel/dist_ba.py``).

Layout, as the reference's mesh axis ``"lm"``: landmarks and their
observation rows are sharded over the ranks, one contiguous slice each;
poses are replicated. Per rank: residuals and Jacobians, the per-landmark
3x3 elimination and this rank's part of the reduced camera system ``S``,
its gradient and the cost (``partial_system``). One ``all_reduce(SUM)`` of
the three in place of ``psum``; then the same dense ``6P`` solve on every
rank, with the replicated pose extras (the BALM eigen-factor quadratic)
added after the reduction, and the landmark back-substitution local to the
rank.

The "mesh" is a ``Mesh``: the process group with this rank and the world
size. Every rank runs the same program on the same replicated inputs, one
process per rank; with NCCL the ``all_reduce`` is ordered on the stream, so
an optimisation makes no host sync. The reference's damping schedule reads
two costs on the host per iteration; here the same accept/reject sequence
runs on the device with ``torch.where`` (costs added in float64, as the
host's Python floats are), and ``optimize`` returns the cost as a 0-d
tensor.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, NamedTuple

import torch
import torch.distributed as dist

from ..geom import camera as cam_mod, lie
from ..solver import factors
from ..solver.lm import BAObservations, inv3x3, precond_solve


@dataclass(frozen=True)
class Mesh:
    """A process group over which the landmark axis is sharded."""

    group: object     # torch.distributed ProcessGroup (None: the default group)
    rank: int
    size: int


def make_mesh(backend: str, init_method: str, rank: int, world_size: int) -> Mesh:
    """Initialise the default process group (``backend`` "nccl" for CUDA
    tensors, "gloo" for CPU tensors) and return it as a mesh."""
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world_size)
    return Mesh(None, rank, world_size)


def mesh_of(group) -> Mesh:
    """An existing process group as a mesh."""
    return Mesh(group, dist.get_rank(group), dist.get_world_size(group))


def shard_problem(mesh: Mesh, X_w, obs: BAObservations, valid_lm):
    """This rank's contiguous slice of the landmark-major arrays. The rows
    are padded to a multiple of the world size with copies of the last row
    whose ``valid_lm`` and ``obs.valid`` are False, so they enter neither the
    cost nor ``S``."""
    L = X_w.shape[0]
    per = -(-L // mesh.size)
    lo = mesh.rank * per
    take = torch.clamp(torch.arange(lo, lo + per, device=X_w.device), max=L - 1)
    real = torch.arange(lo, lo + per, device=X_w.device) < L
    obs_s = BAObservations(*(x.index_select(0, take) for x in obs))
    obs_s = obs_s._replace(valid=obs_s.valid & real[:, None])
    return X_w.index_select(0, take), obs_s, valid_lm.index_select(0, take) & real


def all_gather_rows(mesh: Mesh, x: torch.Tensor, n_rows: int) -> torch.Tensor:
    """The first ``n_rows`` rows of every rank's equal-size shard ``x``,
    concatenated in rank order (the inverse of ``shard_problem``)."""
    out = x.new_empty((x.shape[0] * mesh.size,) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(out, x.contiguous(), group=mesh.group)
    return out[:n_rows]


class PartialSystem(NamedTuple):
    """One shard's part of the reduced camera system, and what its
    landmark back-substitution needs."""

    S: torch.Tensor         # [P, P, 6, 6]
    g_red: torch.Tensor     # [P, 6]
    cost: torch.Tensor      # 0-d, at the input (no valid_lm mask, as the reference)
    Hll_inv: torch.Tensor   # [L, 3, 3], zero for inactive landmarks
    gl: torch.Tensor        # [L, 3]
    B: torch.Tensor         # [L, K, 6, 3]


def _weighted(cam, T_cw, X_w, obs: BAObservations, valid_lm=None):
    """Residuals and the Huber-weighted, gated observation weights."""
    P = T_cw.shape[0]
    K = obs.pose_idx.shape[1]
    pidx = torch.clamp(obs.pose_idx, 0, P - 1).reshape(-1).long()
    rr = factors.reproj_residuals(
        cam, T_cw[pidx], X_w.repeat_interleave(K, dim=0), obs.uv.reshape(-1, 3),
        obs.inv_sigma2.reshape(-1), obs.stereo.reshape(-1))
    thresh = torch.where(obs.stereo.reshape(-1), factors.CHI2_STEREO, factors.CHI2_MONO)
    w_hub = factors.huber_weight(rr.chi2, thresh)
    active = obs.valid.reshape(-1) & rr.depth_ok
    if valid_lm is not None:
        active = active & valid_lm.repeat_interleave(K)
    w = obs.inv_sigma2.reshape(-1) * w_hub * active.to(rr.r.dtype)
    return rr, w


def _onehot(obs: BAObservations, P: int, dtype) -> torch.Tensor:
    """[L, K, P] pose slot of each observation."""
    return (torch.clamp(obs.pose_idx, 0, P - 1)[..., None]
            == torch.arange(P, device=obs.pose_idx.device)).to(dtype)


def partial_system(cam: cam_mod.Pinhole, T_cw, X_w, obs: BAObservations, valid_lm,
                   lam) -> PartialSystem:
    """This shard's part of ``S``, ``g_red`` and the cost at the input."""
    P = T_cw.shape[0]
    L, K = obs.pose_idx.shape
    dt, dev = T_cw.dtype, T_cw.device
    rr, w = _weighted(cam, T_cw, X_w, obs)
    Jp = rr.J_pose * w[:, None, None]
    oh = _onehot(obs, P, dt)
    onehot = oh.reshape(L * K, P)
    Hpp = torch.einsum("op,ojk->pjk", onehot, torch.einsum("oij,oik->ojk", Jp, rr.J_pose))
    gp = torch.einsum("op,oj->pj", onehot, torch.einsum("oij,oi->oj", Jp, rr.r))
    Jlw = rr.J_lm * w[:, None, None]
    Hll = torch.einsum("oij,oik->ojk", Jlw, rr.J_lm).reshape(L, K, 3, 3).sum(dim=1)
    gl = torch.einsum("oij,oi->oj", Jlw, rr.r).reshape(L, K, 3).sum(dim=1)
    B = torch.einsum("oij,oik->ojk", Jp, rr.J_lm).reshape(L, K, 6, 3)
    Hll_d = (Hll + lam * torch.diag_embed(torch.diagonal(Hll, dim1=-2, dim2=-1))
             + 1e-6 * torch.eye(3, dtype=dt, device=dev))
    Hll_inv = inv3x3(Hll_d) * valid_lm.to(dt)[:, None, None]
    U = torch.einsum("lkp,lkim->lpim", oh, torch.einsum("lkij,ljm->lkim", B, Hll_inv))
    V = torch.einsum("lkp,lkjm->lpjm", oh, B)
    S = torch.zeros((P, P, 6, 6), dtype=dt, device=dev)
    ar = torch.arange(P, device=dev)
    S[ar, ar] = Hpp
    S = S - torch.einsum("lpim,lqjm->pqij", U, V)
    g_red = gp - torch.einsum("lpim,lm->pi", U, gl)
    cost = torch.sum(w * torch.sum(rr.r * rr.r, dim=-1))
    return PartialSystem(S, g_red, cost, Hll_inv, gl, B)


def all_reduce(mesh: Mesh, *xs: torch.Tensor) -> list[torch.Tensor]:
    """Sum each tensor over the ranks, in one collective."""
    flat = torch.cat([x.reshape(-1) for x in xs])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=mesh.group)
    out, i = [], 0
    for x in xs:
        out.append(flat[i:i + x.numel()].reshape(x.shape))
        i += x.numel()
    return out


def solve_poses(S, g_red, fixed_pose, lam, H_extra, g_extra) -> torch.Tensor:
    """The replicated dense solve of the reduced system: [P, 6] pose steps."""
    P = S.shape[0]
    D = 6 * P
    free = (~fixed_pose).to(S.dtype)
    S = S * free[:, None, None, None] * free[None, :, None, None]
    Sd = S.permute(0, 2, 1, 3).reshape(D, D)
    free_d = free.repeat_interleave(6)
    Sd = Sd + H_extra * free_d[:, None] * free_d[None, :]
    g_full = g_red.reshape(-1) * free_d + g_extra * free_d
    Sd = Sd + torch.diag(1.0 - free_d)
    Sd = Sd + lam * torch.diag(torch.abs(torch.diagonal(Sd))) \
        + 1e-8 * torch.eye(D, dtype=S.dtype, device=S.device)
    return -precond_solve(Sd, g_full).reshape(P, 6) * free[:, None]


def back_substitute(part: PartialSystem, obs: BAObservations, dp, valid_lm) -> torch.Tensor:
    """Landmark steps [L, 3] of this shard."""
    dp_obs = torch.einsum("lkp,pj->lkj", _onehot(obs, dp.shape[0], dp.dtype), dp)
    Bt_dp = torch.einsum("lkij,lki->lj", part.B, dp_obs)
    return -torch.einsum("lij,lj->li", part.Hll_inv, part.gl + Bt_dp) * valid_lm.to(dp.dtype)[:, None]


def gn_step_fn(mesh: Mesh, cam: cam_mod.Pinhole):
    """One LM iteration over the mesh: ``step(T_cw, X_w, obs, valid_lm,
    fixed_pose, lam, H_extra, g_extra) -> (T_new, X_new, cost_at_input)``,
    ``X`` this rank's shard, the rest replicated."""

    def step(T_cw, X_w, obs, valid_lm, fixed_pose, lam, H_extra, g_extra):
        part = partial_system(cam, T_cw, X_w, obs, valid_lm, lam)
        S, g_red, cost = all_reduce(mesh, part.S, part.g_red, part.cost)
        dp = solve_poses(S, g_red, fixed_pose, lam, H_extra, g_extra)
        dl = back_substitute(part, obs, dp, valid_lm)
        return lie.se3_exp(dp) @ T_cw, X_w + dl, cost

    return step


def _cost_fn(mesh: Mesh, cam: cam_mod.Pinhole):
    """The total cost over the mesh (for the accept/reject schedule)."""

    def cost_of(T_cw, X_w, obs, valid_lm):
        rr, w = _weighted(cam, T_cw, X_w, obs, valid_lm)
        (c,) = all_reduce(mesh, torch.sum(w * torch.sum(rr.r * rr.r, dim=-1)))
        return c

    return cost_of


def optimize(mesh: Mesh, cam: cam_mod.Pinhole, T_cw0, X_w0, obs: BAObservations, valid_lm,
             fixed_pose, iters: int = 10, extra_fn: Callable | None = None, lam0: float = 1e-4):
    """Damped multi-iteration solve; returns (T_cw, this rank's X_w, cost).

    ``extra_fn(T_cw) -> (H [6P, 6P], g [6P], cost)`` supplies the replicated
    dense pose quadratic (the BALM eigen-factor), evaluated at each
    iteration's input and again at its candidate. A candidate is accepted
    when its cost is below the last accepted one (the first: the step's cost
    at the input plus the extra's), and lambda halves (down to 1e-7) on
    accept, quadruples (up to 1e2) on reject."""
    P = T_cw0.shape[0]
    D = 6 * P
    dt, dev = T_cw0.dtype, T_cw0.device
    step = gn_step_fn(mesh, cam)
    cost_of = _cost_fn(mesh, cam)
    zeros = (torch.zeros((D, D), dtype=dt, device=dev), torch.zeros(D, dtype=dt, device=dev))

    T, X = T_cw0, X_w0
    lam = torch.full((), lam0, dtype=torch.float64, device=dev)
    cost_prev = None
    for _ in range(iters):
        if extra_fn is not None:
            H_e, g_e, c_e = extra_fn(T)
        else:
            H_e, g_e, c_e = zeros[0], zeros[1], torch.zeros((), dtype=dt, device=dev)
        T_new, X_new, cost_in = step(T, X, obs, valid_lm, fixed_pose, lam.to(dt), H_e, g_e)
        if cost_prev is None:
            cost_prev = cost_in.double() + c_e.double()
        cost_new = cost_of(T_new, X_new, obs, valid_lm).double()
        if extra_fn is not None:
            cost_new = cost_new + extra_fn(T_new)[2].double()
        accept = cost_new < cost_prev
        T = torch.where(accept, T_new, T)
        X = torch.where(accept, X_new, X)
        cost_prev = torch.where(accept, cost_new, cost_prev)
        lam = torch.where(accept, torch.clamp(lam * 0.5, min=1e-7), torch.clamp(lam * 4.0, max=1e2))
    return T, X, cost_prev
