"""Batched k-point plane fitting and the closed-form symmetric-3x3 eigen
math (port of ``tc2li_slam_tpu/ops/plane_fit.py``)."""

from __future__ import annotations

import math

import torch


def _det3(B: torch.Tensor) -> torch.Tensor:
    return (
        B[..., 0, 0] * (B[..., 1, 1] * B[..., 2, 2] - B[..., 1, 2] * B[..., 2, 1])
        - B[..., 0, 1] * (B[..., 1, 0] * B[..., 2, 2] - B[..., 1, 2] * B[..., 2, 0])
        + B[..., 0, 2] * (B[..., 1, 0] * B[..., 2, 1] - B[..., 1, 1] * B[..., 2, 0])
    )


def _trig_parts(A: torch.Tensor, clip: float):
    q = torch.diagonal(A, dim1=-2, dim2=-1).sum(-1) / 3.0
    eye = torch.eye(3, dtype=A.dtype, device=A.device)
    Aq = A - q[..., None, None] * eye
    p2 = torch.sum(Aq * Aq, dim=(-2, -1)) / 6.0
    p = torch.sqrt(torch.clamp(p2, min=1e-30))
    B = Aq / p[..., None, None]
    r = _det3(B) / 2.0
    phi = torch.arccos(torch.clamp(r, -1.0 + clip, 1.0 - clip)) / 3.0
    return q, p, phi


def smallest_eigval_sym3(A: torch.Tensor) -> torch.Tensor:
    """Smallest eigenvalue of symmetric [..., 3, 3] (trigonometric solution;
    the arccos argument is clipped strictly inside (-1, 1) so its first and
    second derivatives stay finite)."""
    q, p, phi = _trig_parts(A, 1e-6)
    return q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)


def smallest_two_eigvals_sym3(A: torch.Tensor):
    """(lambda_min, lambda_mid) of symmetric [..., 3, 3], closed form."""
    q, p, phi = _trig_parts(A, 0.0)
    lam_max = q + 2.0 * p * torch.cos(phi)
    lam_min = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    return lam_min, 3.0 * q - lam_max - lam_min


def smallest_eigvec_sym3(A: torch.Tensor) -> torch.Tensor:
    """Unit eigenvector of the smallest eigenvalue (cross product of the
    rows of A - lambda I with the largest norm; +z where degenerate)."""
    q, p, phi = _trig_parts(A, 0.0)
    lam_min = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    eye = torch.eye(3, dtype=A.dtype, device=A.device)
    M = A - lam_min[..., None, None] * eye
    r0, r1, r2 = M[..., 0, :], M[..., 1, :], M[..., 2, :]
    c0 = torch.linalg.cross(r0, r1)
    c1 = torch.linalg.cross(r0, r2)
    c2 = torch.linalg.cross(r1, r2)
    n0 = torch.sum(c0 * c0, dim=-1)
    n1 = torch.sum(c1 * c1, dim=-1)
    n2 = torch.sum(c2 * c2, dim=-1)
    best = torch.where(((n0 >= n1) & (n0 >= n2))[..., None], c0,
                       torch.where((n1 >= n2)[..., None], c1, c2))
    nrm = torch.linalg.norm(best, dim=-1, keepdim=True)
    fallback = torch.zeros_like(best)
    fallback[..., 2] = 1.0
    return torch.where(nrm > 1e-20, best / torch.clamp(nrm, min=1e-20), fallback)


def fit_planes(neighbors: torch.Tensor, valid: torch.Tensor, threshold: float = 0.1):
    """Fit n.p + d = 0 (|n| = 1) through each neighbour set [Q, k, 3].

    Returns (normals [Q, 3], d [Q], ok [Q]): >= 3 valid neighbours, all
    within ``threshold`` of the plane, finite solution."""
    w = valid.to(neighbors.dtype)
    cnt = torch.clamp(torch.sum(w, dim=-1), min=1.0)
    mu = torch.sum(neighbors * w[..., None], dim=-2) / cnt[..., None]
    centered = (neighbors - mu[..., None, :]) * w[..., None]
    cov = torch.einsum("qki,qkj->qij", centered, centered) / cnt[..., None, None]
    eye = torch.eye(3, dtype=cov.dtype, device=cov.device)
    normals = smallest_eigvec_sym3(cov + 1e-12 * eye)
    d = -torch.einsum("qi,qi->q", normals, mu)
    finite = torch.all(torch.isfinite(normals), dim=-1) & torch.isfinite(d)
    normals = torch.where(finite[..., None], normals, 0.0)
    d = torch.where(finite, d, 0.0)
    resid = torch.abs(torch.einsum("qki,qi->qk", neighbors, normals) + d[..., None])
    ok = torch.all(torch.where(valid, resid < threshold, True), dim=-1)
    ok = ok & (torch.sum(valid.to(torch.int32), dim=-1) >= 3) & finite
    return normals, d, ok


def point_to_plane(points, normals, d):
    """Signed distances n.p + d."""
    return torch.einsum("qi,qi->q", points, normals) + d
