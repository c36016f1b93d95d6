"""Window bundle adjustment: one hand-written CUDA kernel sequence + its plain version.

Replaces ``tc2li_slam_tpu/solver/lm.py:local_ba`` (line 194), which the TPU
runs as one jit-compiled program: ``iters`` Schur-complement LM iterations
in a ``lax.scan`` over the window poses, the landmarks and their [L, K]
observation table, with an optional dense pose quadratic (the BALM
eigen-factor) linearised at the entry poses. Written as eager PyTorch
(``local_ba_plain``) an iteration issues ~60 small ops and a dense solve.

Bound on the H100: latency. At L = 8192, K = 8, P = 6 an iteration reads
~1.4 MB of observations and does ~60 M operations (a few microseconds of
either); its steps are serial. ``csrc/local_ba.cu`` runs a call as
2 + 5 ``iters`` launches on the current stream (an iteration: the landmark
pass, the reduction of the reduced camera system over the pair table, the
solve over the free poses on a cluster of 8 blocks, the landmark pass that
back-substitutes and costs the candidate, the accept/reject), with no host
sync and no atomics: the same bits on every call. The pair table
(``pair_table``: for each upper 6x6 block of the reduced system, the
observation pairs of one landmark on those two free poses, in landmark
order) depends only on the observation table, ``valid_lm`` and
``fixed_pose``; the wrapper builds it once a call with a few tensor ops on
the device. Sums, 3x3 inverses and elimination run in float64 (the global
BA's 64 poses are too ill-conditioned for float32 sums in another order
than the plain version's). With ``extra_fn`` the
wrapper evaluates it at the entry poses before the launches and at the exit
poses after them, and reverts the update on the device where the true total
cost rose, as the plain version does. Windows of more than 67 poses exceed
the solve's shared memory: their launch is refused and raises.

``local_ba_lm`` launches the kernels (CUDA tensors only);
``solver.lm.local_ba`` sends CUDA tensors there and CPU tensors to
``local_ba_plain``; there is no other route.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ...geom import camera as cam_mod, lie
from ...solver import lm as lm_mod
from . import build

launches = 0   # kernel launches by local_ba_lm (plain-version calls excluded)
CHUNK = 32        # pairs a chunk at least: the reduction's unit of work (a warp)
MAX_CHUNKS = 32   # chunks a block of the reduced system at most
MAX_POSES = 67    # poses of a window: the solve's shared memory (csrc/local_ba.cu)


def launches_per_call(iters: int) -> int:
    """Kernel launches of one ``local_ba_lm`` call: init and its commit, then
    build, reduce, solve, eval and commit an iteration."""
    return 2 + 5 * iters


class PairTable(NamedTuple):
    """The observation pairs of the reduced camera system, by block.

    Block ``b`` of the upper 6x6 blocks ``(p1, p2)``, ``p1 <= p2``, numbered
    row by row (``p1 P - p1 (p1 - 1) / 2 + p2 - p1``), holds the pairs
    ``order[start[b]:start[b + 1]]`` (``l K K + k1 K + k2``: observations
    ``l K + k1`` and ``l K + k2``), in landmark order; its chunks,
    ``cstart[b]:cstart[b + 1]`` of at most ``n_chunks``, are
    ``max(CHUNK, ceil(n / MAX_CHUNKS))`` pairs long for its ``n`` pairs."""

    order: torch.Tensor    # [L K K] int64; the tail past start[-1] unused
    start: torch.Tensor    # [nb + 1] int64
    cstart: torch.Tensor   # [nb + 1] int64
    n_chunks: int          # a bound of cstart[-1] known from the shapes


_block_keys_cache: dict = {}


def _block_keys(P: int, dev) -> torch.Tensor:
    """The blocks' sort keys ``p1 P + p2`` (``p1 <= p2``) row by row, then the
    key of no block, ``P P``; made once a window size and device."""
    key = (P, str(dev))
    if key not in _block_keys_cache:
        iu = torch.triu_indices(P, P, device=dev)
        _block_keys_cache[key] = torch.cat(
            [iu[0] * P + iu[1], torch.full((1,), P * P, device=dev)]).to(torch.int32)
    return _block_keys_cache[key]


def pair_table(pose_idx, valid, valid_lm, fixed_pose) -> PairTable:
    """The pairs ``(l, k1, k2)`` whose term enters the reduced camera system:
    both observations valid and on free poses (``pose_idx`` clamped as the
    solver does), and either ``k1 == k2`` (the observation's own pose terms)
    or a valid landmark with ``p1 <= p2`` (both orders where ``p1 == p2``).
    Fixed-size tensor ops only: no host sync on a device. The flags may be
    bool or uint8 (0 or 1)."""
    L, K = pose_idx.shape
    P = fixed_pose.shape[0]
    dev = pose_idx.device
    nb = P * (P + 1) // 2
    flag = lambda x: x.view(torch.bool) if x.dtype == torch.uint8 else x
    pc = pose_idx.to(torch.int32).clamp(0, P - 1)
    use = flag(valid) & ~flag(fixed_pose)[pc]
    p1, p2 = pc[:, :, None], pc[:, None, :]
    keep = (use[:, :, None] & use[:, None, :]
            & (torch.eye(K, dtype=torch.bool, device=dev)
               | (flag(valid_lm)[:, None, None] & (p1 <= p2))))
    skey, order = torch.sort(torch.where(keep, p1 * P + p2, P * P).reshape(-1), stable=True)
    start = torch.searchsorted(skey, _block_keys(P, dev))
    cnt = start[1:] - start[:-1]
    length = torch.clamp((cnt + MAX_CHUNKS - 1) // MAX_CHUNKS, min=CHUNK)
    cstart = torch.nn.functional.pad(torch.cumsum((cnt + length - 1) // length, 0), (1, 0))
    return PairTable(order, start, cstart, min(MAX_CHUNKS * nb, -(-L * K * K // CHUNK) + nb))


def local_ba_plain(cam: cam_mod.Pinhole, T_cw0, X_w0, obs, fixed_pose, valid_lm,
                   iters: int = 10, extra_fn: Callable | None = None):
    """LocalBundleAdjustment core with a dense reduced camera system.

    ``extra_fn(T_cw) -> (H [6P, 6P], g [6P], cost)`` injects dense cross-pose
    terms (the BALM eigen-factor); like the reference it is linearised once
    at the entry poses, and the whole update is reverted if the true total
    cost at the exit poses is higher than at entry."""
    _assemble_visual, inv3x3, precond_solve, BAResult = (
        lm_mod._assemble_visual, lm_mod.inv3x3, lm_mod.precond_solve, lm_mod.BAResult)
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


def _check(name, x, shape, dtypes, dev):
    if tuple(x.shape) != tuple(shape) or x.dtype not in dtypes:
        raise ValueError(f"local_ba_lm: {name} must be {dtypes[0]} {tuple(shape)}, got "
                         f"{x.dtype} {tuple(x.shape)}")
    if x.device.type != "cuda" or x.device != dev:
        raise ValueError(f"local_ba_lm: every tensor must lie on one CUDA device, got "
                         f"{x.device} beside {dev}")


def local_ba_lm(cam: cam_mod.Pinhole, T_cw0, X_w0, obs, fixed_pose, valid_lm,
                iters: int = 10, extra_fn: Callable | None = None):
    """Launch ``csrc/local_ba.cu`` on the current stream: what
    ``local_ba_plain`` computes, in ``launches_per_call(iters)`` launches."""
    global launches
    if not isinstance(cam, cam_mod.Pinhole):
        raise ValueError(f"local_ba_lm takes a Pinhole camera, got {type(cam).__name__}")
    P = T_cw0.shape[0]
    L, K = obs.pose_idx.shape
    dev = T_cw0.device
    f32, flag, idx = (torch.float32,), (torch.bool, torch.uint8), (torch.int32, torch.int64)
    for name, x, shape, dts in (
            ("T_cw0", T_cw0, (P, 4, 4), f32), ("X_w0", X_w0, (L, 3), f32),
            ("pose_idx", obs.pose_idx, (L, K), idx), ("uv", obs.uv, (L, K, 3), f32),
            ("inv_sigma2", obs.inv_sigma2, (L, K), f32), ("stereo", obs.stereo, (L, K), flag),
            ("valid", obs.valid, (L, K), flag), ("fixed_pose", fixed_pose, (P,), flag),
            ("valid_lm", valid_lm, (L,), flag)):
        _check(name, x, shape, dts, dev)
    if not 1 <= K <= 32 or P < 1 or iters < 0:
        raise ValueError(f"local_ba_lm: K {K} (1 to 32), P {P}, iters {iters}")
    D = 6 * P
    He = ge = ce = None
    if extra_fn is not None:
        He, ge, ce = extra_fn(T_cw0)
        for name, x, shape in (("H", He, (D, D)), ("g", ge, (D,)), ("cost", ce, ())):
            _check(f"extra_fn's {name}", x, shape, f32, dev)
        He, ge, ce = He.contiguous(), ge.contiguous(), ce.reshape(1).contiguous()
    u8 = lambda x: x.contiguous().view(torch.uint8) if x.dtype == torch.bool else x.contiguous()
    T0, X0, uv, s2 = (x.contiguous() for x in (T_cw0, X_w0, obs.uv, obs.inv_sigma2))
    pidx = obs.pose_idx.to(torch.int32).contiguous()
    st, va, fx_, vl = (u8(x) for x in (obs.stereo, obs.valid, fixed_pose, valid_lm))
    tb = pair_table(pidx, obs.valid, valid_lm, fixed_pose)
    part = torch.empty((max(tb.n_chunks, 1), 42), dtype=torch.float64, device=dev)
    lib = build.library()
    scratch = torch.empty(int(lib.tc2li_local_ba_scratch(L, K, P)), dtype=torch.uint8,
                          device=dev)
    T_out = torch.empty((P, 4, 4), dtype=torch.float32, device=dev)
    X_out = torch.empty((L, 3), dtype=torch.float32, device=dev)
    scal = torch.empty(3, dtype=torch.float32, device=dev)   # cost, visual cost, entry cost
    ptr = lambda x: 0 if x is None else x.data_ptr()
    stream = torch.cuda.current_stream(dev).cuda_stream
    build.check(lib.tc2li_local_ba_lm(
        T0.data_ptr(), X0.data_ptr(), pidx.data_ptr(), uv.data_ptr(), s2.data_ptr(),
        st.data_ptr(), va.data_ptr(), fx_.data_ptr(), vl.data_ptr(), ptr(He), ptr(ge), ptr(ce),
        tb.order.data_ptr(), tb.start.data_ptr(), tb.cstart.data_ptr(),
        part.data_ptr(), L, K, P, tb.n_chunks, CHUNK, MAX_CHUNKS, cam.fx, cam.fy, cam.cx, cam.cy,
        cam.bf,
        int(iters), scratch.data_ptr(),
        T_out.data_ptr(), X_out.data_ptr(), scal.data_ptr(), stream), "local_ba_lm")
    launches += launches_per_call(iters)
    T_cw, X_w, cost = T_out, X_out, scal[0]
    if extra_fn is not None:
        # the true extra cost at the exit poses; the update reverted where the
        # true total rose (no host read)
        _, _, c_true = extra_fn(T_cw)
        true_total = scal[1] + c_true
        ok_true = true_total <= scal[2]
        T_cw = torch.where(ok_true, T_cw, T_cw0)
        X_w = torch.where(ok_true, X_w, X_w0)
        cost = torch.where(ok_true, true_total, scal[2])
    return lm_mod.BAResult(T_cw, X_w, cost)
