"""Sim(3) estimation (Horn/Umeyama + batched RANSAC) and pose-graph
Gauss-Newton (port of ``tc2li_slam_tpu/solver/sim3.py``): loop-closure
geometric verification and the essential-graph relaxation that spreads a
loop correction along the keyframe chain.

- ``umeyama``: closed-form s, R, t between 3D point sets (batched). The
  reference takes the rotation from a 3x3 SVD; cuSOLVER's SVD reads its
  status on the host, and the minimal sets of the RANSAC have a rank-2
  covariance, which a Newton-Schulz polar iteration does not survive. Here
  the rotation is Horn's: the dominant eigenvector of the symmetric 4x4
  matrix built from the covariance, reached by repeated squaring of the
  shifted matrix (a fixed number of 4x4 products, no solver call). It is the
  same optimum as the SVD's with the determinant fix, reflections and planar
  sets included; the scale then comes from ``tr(R^T cov)``.
- ``sim3_ransac``: hypotheses from 3-point minimal sets, all evaluated in
  one batch; inliers by 3D distance. The triples come from a
  ``torch.Generator`` or are passed in (the parity tests pass the ones the
  reference's key draws).
- ``pose_graph_optimize``: Gauss-Newton on Sim3 poses with relative-pose
  constraints r = log(S_ij S_j S_i^-1). The residual of an edge depends on
  its two poses only, so the Jacobian is taken as [E, 7, 2, 7] blocks
  (forward mode over one shared 14-vector, not over all 7K unknowns) and
  ``H = J^T J``, ``g = J^T r`` are assembled by scatter-add; the dense
  solve is the library's.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..geom import lie
from ..tensors import count
from . import pnp


def _horn_rotation(cov: torch.Tensor, squarings: int = 24) -> torch.Tensor:
    """The proper rotation R maximising tr(R^T cov), cov [..., 3, 3] =
    sum_n dst_n src_n^T, as Horn's quaternion: the eigenvector of the largest
    eigenvalue of the symmetric traceless 4x4 matrix N(cov). N + |N|_F I is
    positive semi-definite; squaring it ``squarings`` times (renormalised by
    its trace) leaves the dominant eigenvector's outer product."""
    # Horn's S_ab = sum src_a dst_b = cov[b, a]
    Sxx, Sxy, Sxz = cov[..., 0, 0], cov[..., 1, 0], cov[..., 2, 0]
    Syx, Syy, Syz = cov[..., 0, 1], cov[..., 1, 1], cov[..., 2, 1]
    Szx, Szy, Szz = cov[..., 0, 2], cov[..., 1, 2], cov[..., 2, 2]
    N = torch.stack([
        torch.stack([Sxx + Syy + Szz, Syz - Szy, Szx - Sxz, Sxy - Syx], -1),
        torch.stack([Syz - Szy, Sxx - Syy - Szz, Sxy + Syx, Szx + Sxz], -1),
        torch.stack([Szx - Sxz, Sxy + Syx, -Sxx + Syy - Szz, Syz + Szy], -1),
        torch.stack([Sxy - Syx, Szx + Sxz, Syz + Szy, -Sxx - Syy + Szz], -1),
    ], dim=-2)
    eye4 = torch.eye(4, dtype=cov.dtype, device=cov.device)
    shift = torch.linalg.norm(N, dim=(-2, -1)) + 1e-30
    B = N + shift[..., None, None] * eye4
    for _ in range(squarings + 1):
        B = B / torch.sum(torch.diagonal(B, dim1=-2, dim2=-1), dim=-1)[..., None, None]
        B = B @ B
    # B ~ q q^T: its column of the largest diagonal entry is q up to scale
    k = torch.argmax(torch.diagonal(B, dim1=-2, dim2=-1), dim=-1)
    q = torch.gather(B, -1, k[..., None, None].expand(k.shape + (4, 1)))[..., 0]
    return lie.quat_to_mat(q)


def umeyama(src: torch.Tensor, dst: torch.Tensor, w: torch.Tensor,
            with_scale: bool = True) -> torch.Tensor:
    """Weighted closed-form Sim3 aligning src -> dst (packed 4x4 with sR):
    ``src``, ``dst`` [..., N, 3], weights ``w`` [..., N]."""
    wsum = torch.clamp(torch.sum(w, dim=-1, keepdim=True), min=1e-9)
    mu_s = torch.sum(src * w[..., None], dim=-2) / wsum
    mu_d = torch.sum(dst * w[..., None], dim=-2) / wsum
    cs = (src - mu_s[..., None, :]) * w[..., None]
    cd = dst - mu_d[..., None, :]
    cov = torch.einsum("...ni,...nj->...ij", cd, cs) / wsum[..., None]
    R = _horn_rotation(cov)
    if with_scale:
        var_s = torch.sum(cs * (src - mu_s[..., None, :]), dim=(-2, -1)) / wsum[..., 0]
        s = torch.sum(R * cov, dim=(-2, -1)) / torch.clamp(var_s, min=1e-12)
    else:
        s = torch.ones(R.shape[:-2], dtype=R.dtype, device=R.device)
    t = mu_d - s[..., None] * torch.einsum("...ij,...j->...i", R, mu_s)
    return lie.sim3(s, R, t)


class Sim3Result(NamedTuple):
    S: torch.Tensor          # [4, 4] packed Sim3 dst<-src
    inliers: torch.Tensor    # [N] bool
    n_inliers: torch.Tensor  # [] int32
    ok: torch.Tensor         # [] bool


def sim3_ransac(src: torch.Tensor, dst: torch.Tensor, valid: torch.Tensor,
                generator: torch.Generator | None = None, n_hyp: int = 128,
                thresh: float = 0.3, min_inliers: int = 12, with_scale: bool = False,
                sample_idx: torch.Tensor | None = None) -> Sim3Result:
    """Batched 3-point Sim3 RANSAC (Sim3Solver::iterate role): ``src`` [N, 3]
    points in frame A, ``dst`` [N, 3] their matches in frame B, ``valid`` [N].
    Stereo and LiDAR observe the scale, hence ``with_scale=False``. Give
    ``sample_idx`` [n_hyp, 3], or a ``generator`` to draw it."""
    if sample_idx is None:
        if generator is None:
            raise ValueError("sim3_ransac needs a generator or sample_idx")
        sample_idx = pnp.draw_samples(valid, n_hyp, 3, generator)
    idx = sample_idx.long()
    ones = torch.ones(idx.shape, dtype=src.dtype, device=src.device)
    Ss = umeyama(src[idx], dst[idx], ones, with_scale)            # [H, 4, 4]
    pred = torch.einsum("hij,nj->hni", Ss[:, :3, :3], src) + Ss[:, None, :3, 3]
    d = torch.linalg.norm(pred - dst[None], dim=-1)
    inl = (d < thresh) & valid[None]
    best = torch.argmax(count(inl, dim=-1)).reshape(1)            # first on ties
    inliers = inl.index_select(0, best)[0]
    # refine on all inliers
    S = umeyama(src, dst, inliers.to(src.dtype), with_scale)
    d2 = torch.linalg.norm(lie.sim3_apply(S, src) - dst, dim=-1)
    inliers2 = (d2 < thresh) & valid
    S = umeyama(src, dst, inliers2.to(src.dtype), with_scale)
    n = count(inliers2)
    return Sim3Result(S, inliers2, n, n >= min_inliers)


# ---------------------------------------------------------------------------
# Pose-graph optimization
# ---------------------------------------------------------------------------

class PoseGraphEdges(NamedTuple):
    i: torch.Tensor       # [E] int32
    j: torch.Tensor       # [E]
    S_ij: torch.Tensor    # [E, 4, 4] measured S_i S_j^-1 (world->frame convention)
    weight: torch.Tensor  # [E]
    valid: torch.Tensor   # [E] bool


def _edge_residuals(S: torch.Tensor, edges: PoseGraphEdges, i, j) -> torch.Tensor:
    """Unweighted r_e = log(S_ij S_j S_i^-1), [E, 7]."""
    return lie.sim3_log(edges.S_ij @ S[j] @ lie.sim3_inverse(S[i]))


def pose_graph_optimize(S_w: torch.Tensor, edges: PoseGraphEdges, fixed: torch.Tensor,
                        iters: int = 20) -> torch.Tensor:
    """Gauss-Newton on r_e = log(S_ij S_j S_i^-1) over Sim3 poses ``S_w``
    [K, 4, 4] (OptimizeEssentialGraph semantics; right-multiplicative tangent
    updates, forward-mode Jacobian blocks). A step is kept only if the cost
    falls; the decision stays on the device."""
    K = S_w.shape[0]
    D = 7 * K
    dt, dev = S_w.dtype, S_w.device
    i, j = edges.i.long(), edges.j.long()
    w = (edges.weight * edges.valid.to(dt))[:, None]              # [E, 1]
    sw = torch.sqrt(w)
    free = (~fixed).to(dt)
    free_i, free_j = free[i][:, None, None], free[j][:, None, None]
    lanes = torch.arange(7, device=dev)
    rows_i = i[:, None] * 7 + lanes                               # [E, 7]
    rows_j = j[:, None] * 7 + lanes
    diag = 1e-6 + (1.0 - free.repeat_interleave(7))

    def cost_of(S):
        r = _edge_residuals(S, edges, i, j)
        return torch.sum(w * r * r)

    S_cur, cost_prev = S_w, cost_of(S_w)
    for _ in range(iters):
        Si, Sj = S_cur[i], S_cur[j]

        def res_at(d):
            # one shared perturbation (xi_i, xi_j) [2, 7] for every edge: its
            # Jacobian is each edge's own block. The leading axis of one
            # keeps every intermediate at least 1-d under torch.func.
            err = edges.S_ij @ (Sj @ lie.sim3_exp(d[1:2])) @ lie.sim3_inverse(
                Si @ lie.sim3_exp(d[0:1]))
            r = lie.sim3_log(err) * sw
            return r, r

        J, r = torch.func.jacfwd(res_at, has_aux=True)(torch.zeros((2, 7), dtype=dt, device=dev))
        Ji = J[:, :, 0, :] * free_i                               # [E, 7, 7]
        Jj = J[:, :, 1, :] * free_j
        H = torch.zeros((D, D), dtype=dt, device=dev)
        g = torch.zeros(D, dtype=dt, device=dev)
        for ra, Ja in ((rows_i, Ji), (rows_j, Jj)):
            g.index_put_((ra.reshape(-1),), torch.einsum("eki,ek->ei", Ja, r).reshape(-1),
                         accumulate=True)
            for rb, Jb in ((rows_i, Ji), (rows_j, Jj)):
                H.index_put_((ra[:, :, None], rb[:, None, :]),
                             torch.einsum("eki,ekj->eij", Ja, Jb), accumulate=True)
        H.diagonal().add_(diag)
        dx = -torch.linalg.solve_ex(H, g, check_errors=False).result * free.repeat_interleave(7)
        S_new = S_cur @ lie.sim3_exp(dx.reshape(K, 7))
        cost_new = cost_of(S_new)
        accept = cost_new < cost_prev
        S_cur = torch.where(accept, S_new, S_cur)
        cost_prev = torch.where(accept, cost_new, cost_prev)
    return S_cur
