"""Batched SO(3)/SE(3)/Sim(3) operations on torch tensors.

Port of ``tc2li_slam_tpu/geom/lie.py``: same conventions (4x4 homogeneous
SE(3), se3 tangent ordered (rho, phi), left Jacobian V of Barfoot; Sim(3)
packed as a 4x4 whose rotation block carries ``s R``, tangent ordered
(rho, phi, sigma)) and the same f32 Taylor switchovers below ``_EPS`` = 5e-3. Every function is written
with out-of-place ops only, so ``torch.func`` transforms (the BALM Hessian)
can run through it.
"""

from __future__ import annotations

import torch

_EPS = 5e-3


def _safe_theta(w: torch.Tensor) -> torch.Tensor:
    """|w| with a NaN-free gradient at w = 0 (the floor is far below _EPS)."""
    return torch.sqrt(torch.clamp(torch.sum(w * w, dim=-1), min=1e-24))


def hat(w: torch.Tensor) -> torch.Tensor:
    """so3 hat: [..., 3] -> skew-symmetric [..., 3, 3]."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zero = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([zero, -wz, wy], dim=-1),
            torch.stack([wz, zero, -wx], dim=-1),
            torch.stack([-wy, wx, zero], dim=-1),
        ],
        dim=-2,
    )


def vee(W: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`hat`: [..., 3, 3] -> [..., 3]."""
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], dim=-1)


def _sinc(x):
    small = torch.abs(x) < _EPS
    xs = torch.where(small, torch.ones_like(x), x)
    x2 = x * x
    return torch.where(small, 1.0 - x2 / 6.0 + x2 * x2 / 120.0, torch.sin(xs) / xs)


def _cosc(x):
    small = torch.abs(x) < _EPS
    xs = torch.where(small, torch.ones_like(x), x)
    x2 = x * x
    return torch.where(small, 0.5 - x2 / 24.0 + x2 * x2 / 720.0,
                       (1.0 - torch.cos(xs)) / (xs * xs))


def _sinc3(x):
    small = torch.abs(x) < _EPS
    xs = torch.where(small, torch.ones_like(x), x)
    x2 = x * x
    return torch.where(small, 1.0 / 6.0 - x2 / 120.0 + x2 * x2 / 5040.0,
                       (xs - torch.sin(xs)) / (xs * xs * xs))


def _eye3(like: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=like.dtype, device=like.device).expand(like.shape)


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues: [..., 3] -> [..., 3, 3]."""
    theta = _safe_theta(w)
    W = hat(w)
    W2 = W @ W
    return _eye3(W) + _sinc(theta)[..., None, None] * W + _cosc(theta)[..., None, None] * W2


def so3_left_jacobian(w: torch.Tensor) -> torch.Tensor:
    theta = _safe_theta(w)
    W = hat(w)
    W2 = W @ W
    return _eye3(W) + _cosc(theta)[..., None, None] * W + _sinc3(theta)[..., None, None] * W2


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix [..., 3, 3] -> so3 tangent [..., 3] (principal branch).

    theta comes from atan2(sin, cos), which is smooth at the identity; near
    pi the axis is recovered from the diagonal of (R + I) / 2. Both branches
    are computed and selected with ``torch.where``, so forward-mode
    derivatives stay finite on the unselected one."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    w_skew = vee(R - R.transpose(-1, -2))          # = 2 sin(theta) * axis
    sin_theta = 0.5 * torch.sqrt(torch.clamp(torch.sum(w_skew * w_skew, dim=-1), min=1e-24))
    theta = torch.atan2(sin_theta, cos_theta)
    generic = 0.5 / _sinc(theta)[..., None] * w_skew

    near_pi = theta > (torch.pi - 1e-3)
    Rp = (R + _eye3(R)) * 0.5
    diag = torch.clamp(torch.diagonal(Rp, dim1=-2, dim2=-1), min=0.0)
    axis_abs = torch.sqrt(diag)
    # the largest component takes the sign +, the others follow from the
    # symmetric off-diagonals: axis_i * axis_j = Rp_ij at theta = pi
    k = torch.argmax(axis_abs, dim=-1)
    off = Rp - torch.diag_embed(torch.diagonal(Rp, dim1=-2, dim2=-1)) + torch.diag_embed(diag)
    row_k = torch.gather(off, -2, k[..., None, None].expand(k.shape + (1, 3)))[..., 0, :]
    denom = torch.gather(axis_abs, -1, k[..., None])
    axis_pi = row_k / torch.where(denom < 1e-12, torch.ones_like(denom), denom)
    axis_pi = axis_pi / torch.clamp(torch.linalg.norm(axis_pi, dim=-1, keepdim=True), min=1e-12)
    return torch.where(near_pi[..., None], axis_pi * theta[..., None], generic)


def so3_right_jacobian(w: torch.Tensor) -> torch.Tensor:
    """Right Jacobian J_r(w) = J_l(-w)."""
    return so3_left_jacobian(-w)


def so3_left_jacobian_inv(w: torch.Tensor) -> torch.Tensor:
    """Inverse left Jacobian of SO(3)."""
    theta = _safe_theta(w)
    W = hat(w)
    W2 = W @ W
    small = theta < _EPS
    ts = torch.where(small, torch.ones_like(theta), theta)
    t2 = theta * theta
    cot_term = torch.where(
        small, 1.0 / 12.0 + t2 / 720.0 + t2 * t2 / 30240.0,
        (1.0 / (ts * ts)) - (torch.sin(ts) / (2.0 * ts * (1.0 - torch.cos(ts)))))
    return _eye3(W) - 0.5 * W + cot_term[..., None, None] * W2


def so3_right_jacobian_inv(w: torch.Tensor) -> torch.Tensor:
    return so3_left_jacobian_inv(-w)


def se3(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Pack rotation [..., 3, 3] + translation [..., 3] into [..., 4, 4]."""
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    R = R.expand(batch + (3, 3))
    t = t.expand(batch + (3,))
    top = torch.cat([R, t[..., :, None]], dim=-1)
    # [0, 0, 0, 1] built on the device (no host-to-device copy)
    bottom = torch.nn.functional.pad(
        torch.ones(batch + (1, 1), dtype=R.dtype, device=R.device), (3, 0))
    return torch.cat([top, bottom], dim=-2)


def se3_identity(batch: tuple = (), dtype=torch.float32, device=None) -> torch.Tensor:
    return torch.eye(4, dtype=dtype, device=device).expand(tuple(batch) + (4, 4))


def rotation(T: torch.Tensor) -> torch.Tensor:
    return T[..., :3, :3]


def translation(T: torch.Tensor) -> torch.Tensor:
    return T[..., :3, 3]


def se3_orthonormalize(T: torch.Tensor, iters: int = 6) -> torch.Tensor:
    """Project the rotation block back onto SO(3) (nearest in Frobenius).

    The reference takes U V^T from a 3x3 SVD. For the near-orthonormal
    rotations of f32 pose chains that is the polar factor, reached here by
    Newton-Schulz steps R <- R (3I - R^T R) / 2 (quadratic convergence), which
    needs no solver call: cuSOLVER's SVD checks its status on the host and
    would add a device sync to every frame."""
    R = T[..., :3, :3]
    eye3 = _eye3(R)
    for _ in range(iters):
        R = 0.5 * R @ (3.0 * eye3 - R.transpose(-1, -2) @ R)
    return torch.cat([torch.cat([R, T[..., :3, 3:]], dim=-1), T[..., 3:, :]], dim=-2)


def orthogonalize(R: torch.Tensor) -> torch.Tensor:
    """Project [..., 3, 3] onto SO(3) via SVD, for matrices that may be far
    from a rotation (PnP hypotheses), where the Newton-Schulz steps of
    ``se3_orthonormalize`` diverge. The SVD checks its status on the host:
    only for paths that are host-gated already."""
    U, _, Vh = torch.linalg.svd(R)
    det = torch.linalg.det(U @ Vh)
    D = torch.stack([torch.ones_like(det), torch.ones_like(det), det], dim=-1)
    return (U * D[..., None, :]) @ Vh


def se3_inverse(T: torch.Tensor) -> torch.Tensor:
    R = rotation(T)
    t = translation(T)
    Rt = R.transpose(-1, -2)
    return se3(Rt, -(Rt @ t[..., None])[..., 0])


def se3_apply(T: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Apply SE(3) to points: a point set per transform when
    ``p.ndim == T.ndim``, batch-aligned single points when one lower."""
    R = rotation(T)
    t = translation(T)
    if p.ndim == T.ndim:
        return p @ R.transpose(-1, -2) + t[..., None, :]
    return (R @ p[..., None])[..., 0] + t


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """se3 tangent [..., 6] (rho, phi) -> [..., 4, 4]."""
    rho, phi = xi[..., :3], xi[..., 3:]
    R = so3_exp(phi)
    V = so3_left_jacobian(phi)
    t = (V @ rho[..., None])[..., 0]
    return se3(R, t)


def se3_log(T: torch.Tensor) -> torch.Tensor:
    """[..., 4, 4] -> se3 tangent [..., 6] (rho, phi)."""
    phi = so3_log(rotation(T))
    Vinv = so3_left_jacobian_inv(phi)
    rho = (Vinv @ translation(T)[..., None])[..., 0]
    return torch.cat([rho, phi], dim=-1)


def se3_interpolate(T0: torch.Tensor, T1: torch.Tensor, alpha) -> torch.Tensor:
    """Geodesic interpolation T0 * exp(alpha * log(T0^-1 T1))."""
    dxi = se3_log(se3_inverse(T0) @ T1)
    alpha = torch.as_tensor(alpha, dtype=dxi.dtype, device=dxi.device)
    return T0 @ se3_exp(alpha[..., None] * dxi)


def se3_adjoint(T: torch.Tensor) -> torch.Tensor:
    """Adjoint of SE(3): [..., 6, 6] acting on (rho, phi) tangents."""
    R = rotation(T)
    t = translation(T)
    tR = hat(t) @ R
    z = torch.zeros_like(R)
    top = torch.cat([R, tR], dim=-1)
    bot = torch.cat([z, R], dim=-1)
    return torch.cat([top, bot], dim=-2)


# ---------------------------------------------------------------------------
# Sim(3)
# ---------------------------------------------------------------------------

def sim3(s: torch.Tensor, R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Pack scale [...], rotation [..., 3, 3], translation [..., 3] -> 4x4."""
    return se3(s[..., None, None] * R, t)


def sim3_scale(S: torch.Tensor) -> torch.Tensor:
    """Recover s from the packed 4x4 (the norm of the first row of sR)."""
    return torch.linalg.norm(S[..., 0, :3], dim=-1)


def sim3_rotation(S: torch.Tensor) -> torch.Tensor:
    return S[..., :3, :3] / sim3_scale(S)[..., None, None]


def sim3_inverse(S: torch.Tensor) -> torch.Tensor:
    s_inv = 1.0 / sim3_scale(S)
    Rt = sim3_rotation(S).transpose(-1, -2)
    t = translation(S)
    return sim3(s_inv, Rt, -s_inv[..., None] * (Rt @ t[..., None])[..., 0])


def _sim3_W(theta, sigma, phi):
    """Sim(3) translation matrix W = C I + A Phi + B Phi^2, the closed form
    of ``W = int_0^1 exp(sigma u) exp(u phi^) du``, so that
    ``exp(rho, phi, sigma)`` has translation ``t = W rho``:

        C = (s - 1) / sigma
        A = (a sigma + (1 - b) theta) / (theta (sigma^2 + theta^2))
        B = (C - ((b - 1) sigma + a theta) / (sigma^2 + theta^2)) / theta^2

    with ``s = e^sigma``, ``a = s sin(theta)``, ``b = s cos(theta)``. Taylor
    limits: theta -> 0: A = ((sigma - 1) s + 1) / sigma^2,
    B = (s (1 - sigma + sigma^2 / 2) - 1) / sigma^3; sigma -> 0 on top of
    that: C = 1 + sigma / 2, A = 1/2 + sigma / 3, B = 1/6 + sigma / 8."""
    Phi = hat(phi)
    Phi2 = Phi @ Phi
    s = torch.exp(sigma)
    one = torch.ones_like(sigma)

    small_sig = torch.abs(sigma) < _EPS
    sig_s = torch.where(small_sig, one, sigma)
    small_th = theta < _EPS
    th_s = torch.where(small_th, one, theta)
    denom = sigma * sigma + theta * theta
    denom_s = torch.where(denom < _EPS * _EPS, one, denom)

    C = torch.where(small_sig, 1.0 + 0.5 * sigma + sigma * sigma / 6.0, (s - 1.0) / sig_s)

    a_ = s * torch.sin(theta)
    b_ = s * torch.cos(theta)
    A_gen = (a_ * sigma + (1.0 - b_) * theta) / (th_s * denom_s)
    B_gen = (C - ((b_ - 1.0) * sigma + a_ * theta) / denom_s) / (th_s * th_s)

    A_th0 = torch.where(small_sig, 0.5 + sigma / 3.0,
                        ((sigma - 1.0) * s + 1.0) / (sig_s * sig_s))
    B_th0 = torch.where(
        small_sig, 1.0 / 6.0 + sigma / 8.0,
        (s * (1.0 - sigma + 0.5 * sigma * sigma) - 1.0) / (sig_s * sig_s * sig_s))

    A = torch.where(small_th, A_th0, A_gen)
    B = torch.where(small_th, B_th0, B_gen)
    return (C[..., None, None] * _eye3(Phi) + A[..., None, None] * Phi
            + B[..., None, None] * Phi2)


def sim3_exp(xi: torch.Tensor) -> torch.Tensor:
    """sim3 tangent [..., 7] (rho, phi, sigma) -> packed 4x4."""
    rho, phi, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6]
    W = _sim3_W(_safe_theta(phi), sigma, phi)
    return sim3(torch.exp(sigma), so3_exp(phi), (W @ rho[..., None])[..., 0])


def solve3(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x of A x = b for [..., 3, 3] systems by the adjugate (cross products
    of the rows): no solver call, so no status is read on the host."""
    r0, r1, r2 = A[..., 0, :], A[..., 1, :], A[..., 2, :]
    c0 = torch.linalg.cross(r1, r2)
    c1 = torch.linalg.cross(r2, r0)
    c2 = torch.linalg.cross(r0, r1)
    det = torch.sum(r0 * c0, dim=-1, keepdim=True)
    return (c0 * b[..., 0:1] + c1 * b[..., 1:2] + c2 * b[..., 2:3]) / det


def sim3_log(S: torch.Tensor) -> torch.Tensor:
    """Packed Sim(3) -> tangent [..., 7] (rho, phi, sigma)."""
    sigma = torch.log(sim3_scale(S))
    phi = so3_log(sim3_rotation(S))
    W = _sim3_W(_safe_theta(phi), sigma, phi)
    rho = solve3(W, translation(S))
    return torch.cat([rho, phi, sigma[..., None]], dim=-1)


def sim3_apply(S: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Apply Sim(3) to points (the packed form already contains sR)."""
    return se3_apply(S, p)


# ---------------------------------------------------------------------------
# Quaternions
# ---------------------------------------------------------------------------

def quat_to_mat(q: torch.Tensor) -> torch.Tensor:
    """Quaternion [..., 4] (w, x, y, z), normalised here -> rotation matrix."""
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack(
        [
            torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
            torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
            torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
        ],
        dim=-2,
    )


def mat_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> unit quaternion (w, x, y, z): of the four
    constructions, the one with the largest pivot, selected without a branch."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def half_root(x):
        return torch.sqrt(torch.clamp(1.0 + x, min=1e-12)) * 0.5

    pivots = torch.stack([tr, m00 - m11 - m22, -m00 + m11 - m22, -m00 - m11 + m22], -1)
    qw, qx, qy, qz = (half_root(pivots[..., i]) for i in range(4))
    c0 = torch.stack([qw, (m21 - m12) / (4 * qw), (m02 - m20) / (4 * qw), (m10 - m01) / (4 * qw)], -1)
    c1 = torch.stack([(m21 - m12) / (4 * qx), qx, (m01 + m10) / (4 * qx), (m02 + m20) / (4 * qx)], -1)
    c2 = torch.stack([(m02 - m20) / (4 * qy), (m01 + m10) / (4 * qy), qy, (m12 + m21) / (4 * qy)], -1)
    c3 = torch.stack([(m10 - m01) / (4 * qz), (m02 + m20) / (4 * qz), (m12 + m21) / (4 * qz), qz], -1)
    best = torch.argmax(pivots, dim=-1)
    cands = torch.stack([c0, c1, c2, c3], dim=-2)
    q = torch.gather(cands, -2, best[..., None, None].expand(best.shape + (1, 4)))[..., 0, :]
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)
