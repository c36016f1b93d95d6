"""Batched two-view triangulation (port of ``tc2li_slam_tpu/geom/triangulate.py``).

Each match contributes the 4x4 design matrix of the two projective rows per
view; the world point is its smallest right singular vector, divided by its
own ``w`` (so the vector's sign does not matter).

The reference takes that vector from a batched SVD. cuSOLVER's SVD checks
its status on the host, which would add a device sync to every mapping
pass, so ``null_vector`` computes it without a solver status: the smallest
eigenvector of ``A^T A`` by a fixed number of inverse iterations. Forming
``A^T A`` squares the condition number, so this one step runs in float64
(products of float32 entries are exact there); the result returns to
float32. ``tests/test_torch_triangulation.py`` holds it against the SVD.
"""

from __future__ import annotations

import torch

NULL_ITERS = 5


def null_vector(A: torch.Tensor) -> torch.Tensor:
    """Unit right singular vector of the smallest singular value of
    ``A`` [..., n, n], up to sign, without a host-side status check."""
    A64 = A.to(torch.float64)
    B = A64.transpose(-1, -2) @ A64
    n = B.shape[-1]
    eye = torch.eye(n, dtype=B.dtype, device=B.device)
    # a shift far below the second-smallest eigenvalue of any pair with
    # usable parallax keeps B invertible when A is exactly singular
    mu = 1e-12 * torch.diagonal(B, dim1=-2, dim2=-1).sum(-1) + 1e-300
    Bs = B + mu[..., None, None] * eye
    # a generic start, made on the device: a null vector nearly orthogonal
    # to it only converges an iteration later
    start = torch.cos(2.3 * torch.arange(n, dtype=B.dtype, device=B.device) + 0.4)
    x = start.expand(B.shape[:-1])[..., None]
    for _ in range(NULL_ITERS):
        x = torch.linalg.solve_ex(Bs, x, check_errors=False)[0]
        x = x / torch.clamp(torch.linalg.norm(x, dim=-2, keepdim=True), min=1e-300)
    return x[..., 0].to(A.dtype)


def design_matrix(xn1, xn2, T1w, T2w) -> torch.Tensor:
    """[N, 4, 4] DLT rows of both views."""
    P1 = T1w[..., :3, :].expand(xn1.shape[:-1] + (3, 4))
    P2 = T2w[..., :3, :].expand(xn2.shape[:-1] + (3, 4))
    rows = [
        xn1[..., 0, None] * P1[..., 2, :] - P1[..., 0, :],
        xn1[..., 1, None] * P1[..., 2, :] - P1[..., 1, :],
        xn2[..., 0, None] * P2[..., 2, :] - P2[..., 0, :],
        xn2[..., 1, None] * P2[..., 2, :] - P2[..., 1, :],
    ]
    return torch.stack(rows, dim=-2)


def triangulate_dlt(xn1, xn2, T1w, T2w) -> torch.Tensor:
    """World points [N, 3] minimising the algebraic error.

    ``xn1``, ``xn2`` [N, 2] normalized image coordinates in the two cameras;
    ``T1w``, ``T2w`` [4, 4] or [N, 4, 4] world -> camera."""
    Xh = null_vector(design_matrix(xn1, xn2, T1w, T2w))
    w = Xh[..., 3]
    w_safe = torch.where(torch.abs(w) < 1e-12, torch.full_like(w, 1e-12), w)
    return Xh[..., :3] / w_safe[..., None]


def parallax_cos(p_world, c1, c2) -> torch.Tensor:
    """cos of the ray parallax angle per point."""
    r1 = p_world - c1
    r2 = p_world - c2
    num = torch.sum(r1 * r2, dim=-1)
    den = torch.linalg.norm(r1, dim=-1) * torch.linalg.norm(r2, dim=-1)
    return num / torch.clamp(den, min=1e-12)
