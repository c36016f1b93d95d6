"""The loop closure's pose-graph Gauss-Newton: a hand-written CUDA kernel
sequence + its plain version.

Replaces ``tc2li_slam_tpu/solver/sim3.py:pose_graph_optimize`` (line 112,
its ``lax.scan`` :165), one jit-compiled program on the TPU: Gauss-Newton
over Sim3 poses on the residuals log(S_ij S_j S_i^-1) of the essential
graph's edges, a step kept only where the cost falls. Written as eager
PyTorch (``pose_graph_plain``) an iteration is ``torch.func.jacfwd`` over
the edges, ``index_put_`` scatter-adds of H and g and a dense solve of all
7K rows: 28,748 device events at 4f's closure.

Launch plan (``csrc/pose_graph.cu``, all on the current stream, no host
sync, no atomics in a float sum: the same bits on every call): setup (the
state in float64, each pose's free slot by a prefix count over ``fixed``,
the free-row count n, which stays on the device) and the entry cost; then
an iteration is the edges' residuals and 7 x 14 Jacobians by forward-mode
dual numbers (jacfwd's derivative of the chain as ``geom/lie.py`` writes
it), H and g over the free rows only (a block a free pose summing its
edges' blocks in edge order; g bordered below H, so that the Cholesky
leaves L^-1 g in its last row), the solve, the candidate S Exp(-x) and its
cost (summed in edge order), the accept test. The solve is a blocked
right-looking Cholesky over panels of 256 columns, each taken 64 columns
at a time: the diagonal block factored once in one block's shared memory
with its inverse, the rows below times L^-T and the trailing update as
float64 tensor-core products (``mma.sync``), then the back-substitution
64 rows a launch. The plan is sized from K on the host:
``launches_per_call(K, iters)``; steps past the device's n return at once,
so callers hand in only the slots in use (``slam.loop_closing.close_loop``).

Bound on the H100: the free rows' Cholesky and substitutions (n^3 / 6 +
n^2 float64 multiply-adds an iteration, at the float64 tensor cores' 33.5
T/s) and the edges' chains (17 T/s outside the tensor cores); at 4f's
closure (336 free rows) latency, the dependent steps of an iteration (each
diagonal block's 64 reciprocal square roots in a row); at 2,048 keyframes
(14,329 free rows, H 1.65 GB) the factorization, ~4.9e11 multiply-adds,
~14.6 ms an iteration at that rate, and the trailing updates' traffic, each
tile read and written once a 256-column panel.

``pose_graph_gn`` launches the kernels (CUDA tensors only);
``solver.sim3.pose_graph_optimize`` sends CUDA tensors there and CPU
tensors to ``pose_graph_plain``; there is no other route.
"""

from __future__ import annotations

import torch

from ...geom import lie
from . import build

launches = 0   # kernel launches by pose_graph_gn (plain-version calls excluded)


def launches_per_call(K: int, iters: int) -> int:
    """Kernel launches of one ``pose_graph_gn`` call over K >= 1 poses, as
    ``csrc/pose_graph.cu`` plans them (``tc2li_pose_graph_launches``):
    setup and the entry cost, then an iteration's edge, assembly, pose and
    cost launches and its solve's."""
    return build.library().tc2li_pose_graph_launches(K, iters)


def _edge_residuals(S: torch.Tensor, edges, i, j) -> torch.Tensor:
    """Unweighted r_e = log(S_ij S_j S_i^-1), [E, 7]."""
    return lie.sim3_log(edges.S_ij @ S[j] @ lie.sim3_inverse(S[i]))


def normal_equations(S: torch.Tensor, edges, fixed: torch.Tensor) -> tuple:
    """H [7K, 7K] and g [7K] of one Gauss-Newton step at the poses S: the
    edges' [7, 2, 7] Jacobian blocks by ``torch.func.jacfwd`` (forward mode
    over one shared 14-vector, not over all 7K unknowns), ``J^T J + 1e-6 I``
    and ``J^T r`` assembled by scatter-add; a fixed pose's columns zero, its
    rows ``(1 + 1e-6) I`` and its g 0."""
    K = S.shape[0]
    D = 7 * K
    dt, dev = S.dtype, S.device
    i, j = edges.i.long(), edges.j.long()
    sw = torch.sqrt(edges.weight * edges.valid.to(dt))[:, None]   # [E, 1]
    free = (~fixed).to(dt)
    free_i, free_j = free[i][:, None, None], free[j][:, None, None]
    lanes = torch.arange(7, device=dev)
    rows_i = i[:, None] * 7 + lanes                               # [E, 7]
    rows_j = j[:, None] * 7 + lanes
    Si, Sj = S[i], S[j]

    def res_at(d):
        # one shared perturbation (xi_i, xi_j) [2, 7] for every edge: its
        # Jacobian is each edge's own block. The leading axis of one keeps
        # every intermediate at least 1-d under torch.func.
        err = edges.S_ij @ (Sj @ lie.sim3_exp(d[1:2])) @ lie.sim3_inverse(
            Si @ lie.sim3_exp(d[0:1]))
        r = lie.sim3_log(err) * sw
        return r, r

    J, r = torch.func.jacfwd(res_at, has_aux=True)(torch.zeros((2, 7), dtype=dt, device=dev))
    Ji = J[:, :, 0, :] * free_i                                   # [E, 7, 7]
    Jj = J[:, :, 1, :] * free_j
    H = torch.zeros((D, D), dtype=dt, device=dev)
    g = torch.zeros(D, dtype=dt, device=dev)
    for ra, Ja in ((rows_i, Ji), (rows_j, Jj)):
        g.index_put_((ra.reshape(-1),), torch.einsum("eki,ek->ei", Ja, r).reshape(-1),
                     accumulate=True)
        for rb, Jb in ((rows_i, Ji), (rows_j, Jj)):
            H.index_put_((ra[:, :, None], rb[:, None, :]),
                         torch.einsum("eki,ekj->eij", Ja, Jb), accumulate=True)
    H.diagonal().add_(1e-6 + (1.0 - free.repeat_interleave(7)))
    return H, g


def pose_graph_plain(S_w: torch.Tensor, edges, fixed: torch.Tensor,
                     iters: int = 20) -> torch.Tensor:
    """``solver.sim3.pose_graph_optimize`` as eager tensor ops: each step's
    system by ``normal_equations``, the dense 7K-row solve the library's."""
    K = S_w.shape[0]
    dt = S_w.dtype
    i, j = edges.i.long(), edges.j.long()
    w = (edges.weight * edges.valid.to(dt))[:, None]              # [E, 1]
    free7 = (~fixed).to(dt).repeat_interleave(7)

    def cost_of(S):
        r = _edge_residuals(S, edges, i, j)
        return torch.sum(w * r * r)

    S_cur, cost_prev = S_w, cost_of(S_w)
    for _ in range(iters):
        H, g = normal_equations(S_cur, edges, fixed)
        dx = -torch.linalg.solve_ex(H, g, check_errors=False).result * free7
        S_new = S_cur @ lie.sim3_exp(dx.reshape(K, 7))
        cost_new = cost_of(S_new)
        accept = cost_new < cost_prev
        S_cur = torch.where(accept, S_new, S_cur)
        cost_prev = torch.where(accept, cost_new, cost_prev)
    return S_cur


def pose_graph_gn(S_w: torch.Tensor, edges, fixed: torch.Tensor, iters: int = 20) -> torch.Tensor:
    """Launch ``csrc/pose_graph.cu`` on the current stream: what
    ``pose_graph_plain`` computes, in float64 after the float32 inputs,
    ``launches_per_call(K, iters)`` launches (the inputs read where they
    lie; the result a new float32 [K, 4, 4])."""
    global launches
    K, E = S_w.shape[0], edges.i.shape[0]
    if K < 1 or iters < 0:
        raise ValueError(f"pose_graph_gn: K {K} (at least 1), iters {iters}")
    dev = S_w.device
    for name, x, shape, dtypes in (
            ("S_w", S_w, (K, 4, 4), (torch.float32,)),
            ("edges.i", edges.i, (E,), (torch.int32,)),
            ("edges.j", edges.j, (E,), (torch.int32,)),
            ("edges.S_ij", edges.S_ij, (E, 4, 4), (torch.float32,)),
            ("edges.weight", edges.weight, (E,), (torch.float32,)),
            ("edges.valid", edges.valid, (E,), (torch.bool, torch.uint8)),
            ("fixed", fixed, (K,), (torch.bool, torch.uint8))):
        if tuple(x.shape) != shape or x.dtype not in dtypes:
            raise ValueError(f"pose_graph_gn: {name} must be {dtypes[0]} {shape}, got "
                             f"{x.dtype} {tuple(x.shape)}")
        if x.device.type != "cuda" or x.device != dev:
            raise ValueError(f"pose_graph_gn: every tensor must lie on one CUDA device, got "
                             f"{x.device} beside {dev}")
    as_u8 = lambda x: x.contiguous().view(torch.uint8) if x.dtype == torch.bool else x.contiguous()
    S, ei, ej = S_w.contiguous(), edges.i.contiguous(), edges.j.contiguous()
    Sij, wt = edges.S_ij.contiguous(), edges.weight.contiguous()
    val, fx = as_u8(edges.valid), as_u8(fixed)
    lib = build.library()
    work = torch.empty(-(-lib.tc2li_pose_graph_scratch(K, E) // 8), dtype=torch.float64,
                       device=dev)
    out = torch.empty((K, 4, 4), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    build.check(lib.tc2li_pose_graph_gn(
        S.data_ptr(), ei.data_ptr(), ej.data_ptr(), Sij.data_ptr(), wt.data_ptr(),
        val.data_ptr(), fx.data_ptr(), K, E, int(iters), work.data_ptr(),
        out.data_ptr(), stream), "pose_graph_gn")
    launches += launches_per_call(K, iters)
    return out
