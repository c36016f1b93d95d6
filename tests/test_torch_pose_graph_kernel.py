"""The loop closure's pose-graph kernels (``csrc/pose_graph.cu``,
``ops/kernels/pose_graph.py``) on the CPU: the dispatch by device, and the
kernels' arithmetic emulated in float64 numpy against
``torch.func.jacfwd`` of the plain chain, ``pose_graph_plain`` and the JAX
``pose_graph_optimize``.

The kernels cannot run here. What they do differently from the plain
version is how they form the Jacobian and the shape of their sums and
solve, and the emulation repeats them: each edge's residual evaluated with
forward-mode dual numbers by the kernel's formulas (``edge_residual``:
``sim3_exp_t``, ``sim3_inverse_t``, ``sim3_log_t`` with ``_sim3_W``'s Taylor
branches, ``so3_log``'s branch near pi, the clamps, the adjugate solve),
one tangent a local column of (xi_i, xi_j); H and g over the free poses
only, a block-row a free pose summed over its edges in edge order, g
bordered below H; the blocked right-looking Cholesky of that bordered
matrix a panel of columns at a time and the back-substitution a part of
rows at a time, in the launch plan's order; S Exp(-x), the candidate's
cost and the accept test. Cases: residuals in each branch of ``geom/lie.py`` (generic, theta below ``_EPS``, |sigma|
below it, both, near pi, the identity), ``chip_smoke.pose_graph_problem``'s
graphs (``test_torch_sim3._drift_chain``'s: fixed poses, invalid and
zero-weight edges, scale drift, a non-finite edge), a duplicated (i, j)
pair and an edge from a pose to itself; and ``close_loop``'s call on the used slots against the call over
every slot.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from tc2li_slam_tpu.geom import lie as jlie
from tc2li_slam_tpu.solver import sim3 as jsim3
from tc2li_slam_torch import interop
from tc2li_slam_torch.geom import lie as tlie
from tc2li_slam_torch.ops.kernels import build
from tc2li_slam_torch.ops.kernels import pose_graph as kpg
from tc2li_slam_torch.slam import loop_closing as tlc
from tc2li_slam_torch.solver import sim3 as tsim3
from test_torch_loop_closing import build_dense_map
from torch_parity import n, t

F64 = torch.float64
EPS = 5e-3     # geom/lie.py _EPS (csrc/imu_factor.cuh kEps)
NT = 14        # tangents an edge: xi_i, xi_j
# a diagonal block's and a panel's widths, as the kernel's source states them
KW, KNB = (int(re.search(rf"constexpr int {k} = (\d+);",
                         (build.CSRC / "pose_graph.cu").read_text())[1]) for k in ("kW", "kNB"))


# ---------------------------------------------------------------------------
# forward-mode dual numbers over numpy: a value [E] and 14 tangents [E, 14]
# (the kernel's thread (e, c) holds the value and tangent c; each tangent's
# arithmetic is the same whether carried alone or beside the others)
# ---------------------------------------------------------------------------

class Dual:
    __slots__ = ("v", "d")
    __array_ufunc__ = None   # an array times a Dual is the Dual's product

    def __init__(self, v, d=None):
        self.v = np.asarray(v, np.float64)
        self.d = np.zeros(self.v.shape + (NT,)) if d is None else d

    @staticmethod
    def of(x):
        return x if isinstance(x, Dual) else Dual(x)

    def __add__(self, o):
        o = Dual.of(o)
        return Dual(self.v + o.v, self.d + o.d)

    __radd__ = __add__

    def __sub__(self, o):
        o = Dual.of(o)
        return Dual(self.v - o.v, self.d - o.d)

    def __rsub__(self, o):
        return Dual.of(o) - self

    def __neg__(self):
        return Dual(-self.v, -self.d)

    def __mul__(self, o):
        if not isinstance(o, Dual):
            o = np.asarray(o, np.float64)
            return Dual(self.v * o, self.d * o[..., None])
        return Dual(self.v * o.v, self.d * o.v[..., None] + self.v[..., None] * o.d)

    __rmul__ = __mul__

    def __truediv__(self, o):
        o = Dual.of(o)
        q = self.v / o.v
        return Dual(q, (self.d - o.d * q[..., None]) / o.v[..., None])

    def __rtruediv__(self, o):
        return Dual.of(o) / self


def dsin(x):
    return Dual(np.sin(x.v), x.d * np.cos(x.v)[..., None])


def dcos(x):
    return Dual(np.cos(x.v), -x.d * np.sin(x.v)[..., None])


def dsqrt(x):
    r = np.sqrt(x.v)
    return Dual(r, x.d / (2.0 * r)[..., None])


def dexp(x):
    e = np.exp(x.v)
    return Dual(e, x.d * e[..., None])


def dlog(x):
    return Dual(np.log(x.v), x.d / x.v[..., None])


def datan2(y, x):
    return Dual(np.arctan2(y.v, x.v), (y.d * x.v[..., None] - x.d * y.v[..., None])
                / (y.v * y.v + x.v * x.v)[..., None])


def dclamp(x, lo, hi=np.inf):
    """torch.clamp: the tangent passes where lo <= value <= hi; a NaN stays."""
    inside = (x.v >= lo) & (x.v <= hi)
    return Dual(np.where(x.v < lo, lo, np.where(x.v > hi, hi, x.v)), x.d * inside[..., None])


def dwhere(c, a, b):
    """The kernel's branch by value (both sides computed here, one kept)."""
    a, b = Dual.of(a), Dual.of(b)
    return Dual(np.where(c, a.v, b.v), np.where(c[..., None], a.d, b.d))


# ---------------------------------------------------------------------------
# csrc/pose_graph.cu's chain (dual.cuh's SO(3) functions included): 3 x 3
# matrices and packed Sim3s as nested lists of Duals, a Sim3 its top 3 rows
# ---------------------------------------------------------------------------

def _sinc(x):
    x2 = x * x
    small = np.abs(x.v) < EPS
    xs = dwhere(small, 1.0, x)
    return dwhere(small, (1.0 - x2 * (1.0 / 6.0)) + x2 * x2 * (1.0 / 120.0), dsin(xs) / xs)


def _cosc(x):
    x2 = x * x
    small = np.abs(x.v) < EPS
    xs = dwhere(small, 1.0, x)
    return dwhere(small, (0.5 - x2 * (1.0 / 24.0)) + x2 * x2 * (1.0 / 720.0),
                  (1.0 - dcos(xs)) / (xs * xs))


def hat(w):
    z = Dual(np.zeros_like(w[0].v))
    return [[z, -w[2], w[1]], [w[2], z, -w[0]], [-w[1], w[0], z]]


def mm3(A, B):
    return [[(A[i][0] * B[0][j] + A[i][1] * B[1][j]) + A[i][2] * B[2][j] for j in range(3)]
            for i in range(3)]


def mul34(A, B):
    return [[((A[i][0] * B[0][j] + A[i][1] * B[1][j]) + A[i][2] * B[2][j])
             + A[i][3] * (1.0 if j == 3 else 0.0) for j in range(4)] for i in range(3)]


def safe_theta(w):
    return dsqrt(dclamp((w[0] * w[0] + w[1] * w[1]) + w[2] * w[2], 1e-24))


def so3_exp_t(w):
    sa, ca = _sinc(safe_theta(w)), _cosc(safe_theta(w))
    W = hat(w)
    W2 = mm3(W, W)
    return [[((1.0 if i == j else 0.0) + sa * W[i][j]) + ca * W2[i][j] for j in range(3)]
            for i in range(3)]


def so3_log_t(R):
    tr = (R[0][0] + R[1][1]) + R[2][2]
    c = dclamp((tr - 1.0) * 0.5, -1.0, 1.0)
    ws = [R[2][1] - R[1][2], R[0][2] - R[2][0], R[1][0] - R[0][1]]
    s = 0.5 * dsqrt(dclamp((ws[0] * ws[0] + ws[1] * ws[1]) + ws[2] * ws[2], 1e-24))
    th = datan2(s, c)
    f = 0.5 / _sinc(th)
    generic = [f * ws[k] for k in range(3)]
    # near pi: the axis from the diagonal of (R + I) / 2, its largest entry
    # (the first of equals) taking the sign +
    dg = [dclamp((R[k][k] + 1.0) * 0.5, 0.0) for k in range(3)]
    ax = [dsqrt(d) for d in dg]
    kk = np.argmax(np.stack([a.v for a in ax], -1), -1)
    pick = lambda opts: dwhere(kk == 0, opts[0], dwhere(kk == 1, opts[1], opts[2]))
    row = [pick([dg[k] if j == k else R[k][j] * 0.5 for k in range(3)]) for j in range(3)]
    axk = pick(ax)
    den = dwhere(axk.v < 1e-12, 1.0, axk)
    row = [r / den for r in row]
    nd = dclamp(dsqrt((row[0] * row[0] + row[1] * row[1]) + row[2] * row[2]), 1e-12)
    near = th.v > np.pi - 1e-3
    return [dwhere(near, row[j] / nd * th, generic[j]) for j in range(3)]


def sim3_W_t(theta, sigma, phi):
    P = hat(phi)
    P2 = mm3(P, P)
    s = dexp(sigma)
    small_sig, small_th = np.abs(sigma.v) < EPS, theta.v < EPS
    sig_s, th_s = dwhere(small_sig, 1.0, sigma), dwhere(small_th, 1.0, theta)
    denom = sigma * sigma + theta * theta
    denom_s = dwhere(denom.v < EPS * EPS, 1.0, denom)
    C = dwhere(small_sig, (1.0 + 0.5 * sigma) + sigma * sigma / 6.0, (s - 1.0) / sig_s)
    A0 = dwhere(small_sig, 0.5 + sigma / 3.0, ((sigma - 1.0) * s + 1.0) / (sig_s * sig_s))
    B0 = dwhere(small_sig, 1.0 / 6.0 + sigma / 8.0,
                (s * ((1.0 - sigma) + 0.5 * sigma * sigma) - 1.0) / ((sig_s * sig_s) * sig_s))
    a, b = s * dsin(theta), s * dcos(theta)
    A = dwhere(small_th, A0, (a * sigma + (1.0 - b) * theta) / (th_s * denom_s))
    B = dwhere(small_th, B0, (C - ((b - 1.0) * sigma + a * theta) / denom_s) / (th_s * th_s))
    return [[(C * (1.0 if i == j else 0.0) + A * P[i][j]) + B * P2[i][j] for j in range(3)]
            for i in range(3)]


def sim3_exp_t(xi):
    phi = xi[3:6]
    W = sim3_W_t(safe_theta(phi), xi[6], phi)
    R = so3_exp_t(phi)
    s = dexp(xi[6])
    return [[s * R[i][j] for j in range(3)]
            + [(W[i][0] * xi[0] + W[i][1] * xi[1]) + W[i][2] * xi[2]] for i in range(3)]


def row_norm(S):
    return dsqrt((S[0][0] * S[0][0] + S[0][1] * S[0][1]) + S[0][2] * S[0][2])


def sim3_inverse_t(S):
    sc = row_norm(S)
    s_inv = 1.0 / sc
    Rt = [[S[j][i] / sc for j in range(3)] for i in range(3)]
    return [[s_inv * Rt[i][j] for j in range(3)]
            + [-s_inv * ((Rt[i][0] * S[0][3] + Rt[i][1] * S[1][3]) + Rt[i][2] * S[2][3])]
            for i in range(3)]


def cross(a, b):
    return [a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2], a[0] * b[1] - a[1] * b[0]]


def sim3_log_t(E):
    sc = row_norm(E)
    sigma = dlog(sc)
    phi = so3_log_t([[E[i][j] / sc for j in range(3)] for i in range(3)])
    W = sim3_W_t(safe_theta(phi), sigma, phi)
    c0, c1, c2 = cross(W[1], W[2]), cross(W[2], W[0]), cross(W[0], W[1])
    det = (W[0][0] * c0[0] + W[0][1] * c0[1]) + W[0][2] * c0[2]
    rho = [((c0[k] * E[0][3] + c1[k] * E[1][3]) + c2[k] * E[2][3]) / det for k in range(3)]
    return rho + phi + [sigma]


def const(M):
    """A stack of [E, 4, 4] matrices as a packed Sim3 of constants."""
    return [[Dual(M[:, i, j]) for j in range(4)] for i in range(3)]


def edge_chain(Sij, Si, Sj, w):
    """``edge_kernel`` over all edges: the weighted residuals [E, 7] and the
    Jacobians [E, 7, 14] (lanes 0..6 xi_i, 7..13 xi_j)."""
    E = len(Sij)
    tangents = []
    for base in (0, 7):
        xi = []
        for c in range(7):
            d = np.zeros((E, NT))
            d[:, base + c] = 1.0
            xi.append(Dual(np.zeros(E), d))
        tangents.append(xi)
    with np.errstate(all="ignore"):
        A = mul34(const(Si), sim3_exp_t(tangents[0]))
        B = mul34(const(Sj), sim3_exp_t(tangents[1]))
        r = sim3_log_t(mul34(mul34(const(Sij), B), sim3_inverse_t(A)))
    sw = np.sqrt(w)
    return (np.stack([x.v for x in r], -1) * sw[:, None],
            np.stack([x.d for x in r], 1) * sw[:, None, None])


def edge_cost(Sij, Si, Sj, w):
    """``cost_kernel``'s term of each edge: (w r) . r at the poses."""
    with np.errstate(all="ignore"):
        r = sim3_log_t(mul34(mul34(const(Sij), const(Sj)), sim3_inverse_t(const(Si))))
    c = np.zeros(len(Sij))
    for x in r:
        c = c + (w * x.v) * x.v
    return c


# ---------------------------------------------------------------------------
# csrc/pose_graph.cu's assembly, Cholesky and solves, in float64
# ---------------------------------------------------------------------------

def slots_of(fixed):
    """``setup_kernel``: each pose's free slot and the free-row count."""
    free = ~np.asarray(fixed, bool)
    return np.cumsum(free) - free, 7 * int(free.sum())


def assemble(ei, ej, J, r, fixed):
    """``assemble_kernel``: the bordered matrix [n + 1, n + 1] (lower part;
    row n is g), a block-row a free pose, its edges in edge order."""
    slot, n = slots_of(fixed)
    M = np.zeros((n + 1, n + 1))
    for p in np.flatnonzero(~np.asarray(fixed, bool)):
        s = slot[p]
        diag, g = np.zeros((7, 7)), np.zeros(7)
        for e in range(len(ei)):
            i, j = ei[e], ej[e]
            if p not in (i, j):
                continue
            Ji, Jj = J[e][:, :7], J[e][:, 7:]
            Jp = Ji + Jj if i == j == p else (Ji if i == p else Jj)
            diag += Jp.T @ Jp
            g += Jp.T @ r[e]
            q = j if i == p else i
            if q != p and not fixed[q] and slot[q] < s:
                Jq = Jj if i == p else Ji
                M[7 * s:7 * s + 7, 7 * slot[q]:7 * slot[q] + 7] += Jp.T @ Jq
        M[7 * s:7 * s + 7, 7 * s:7 * s + 7] = diag + 1e-6 * np.eye(7)
        M[n, 7 * s:7 * s + 7] = g
    return M


def warp_factor(A):
    """``warp_factor``: a 32 x 32 block's Cholesky by right-looking steps,
    each column scaled by its pivot's reciprocal square root, and its
    inverse formed beside it (step j takes column j of L off each column of
    L^-1 up to j, times its entry in row j). Returns L and L^-1."""
    a, z = np.tril(A).copy(), np.eye(len(A))
    for j in range(len(A)):
        rj = 1.0 / np.sqrt(a[j, j])
        a[j, j] *= rj
        a[j + 1:, j] *= rj
        z[j, :j + 1] *= rj
        for m in range(j + 1, len(A)):
            a[m:, m] -= a[m:, j] * a[m, j]
        z[j + 1:, :j + 1] -= a[j + 1:, j:j + 1] * z[j, :j + 1]
    return np.tril(a), z


def diag_block(A, w=KW):
    """``diag_block``: the inverse of the w x w diagonal block's Cholesky
    factor (the block's lower part read; the identity past its ``len``), by
    ``warp_factor`` on each 32-wide half, the lower half's rows times
    L_00^-T and its trailing update between them, and L^-1's lower-left block
    -L_11^-1 (L_10 L_00^-1)."""
    B = np.eye(w)
    B[:len(A), :len(A)] = np.tril(A)
    h = w // 2
    L00, Li0 = warp_factor(B[:h, :h])
    X = B[h:, :h] @ Li0.T
    L11, Li1 = warp_factor(np.tril(B[h:, h:] - X @ X.T))
    Linv = np.zeros((w, w))
    Linv[:h, :h], Linv[h:, h:] = Li0, Li1
    Linv[h:, :h] = -Li1 @ (X @ Li0)
    return Linv


def solve_plan(D):
    """``for_each_solve_launch``: the solve's launches of an iteration over
    D rows, in order, as (kind, k0, kq): for each panel k0 of KNB columns,
    each KW-wide part kq its update by the panel's parts before it (but the
    first), its diagonal block and its rows below; then the panel's trailing
    update (but the last's); then a back-substitution launch a part, last
    to first."""
    for k0 in range(0, D, KNB):
        for kq in range(k0, min(k0 + KNB, D), KW):
            if kq > k0:
                yield "narrow", k0, kq
            yield "diag", k0, kq
            yield "panel", k0, kq
        if k0 + KNB < D:
            yield "trailing", k0, k0 + KNB
    for kq in reversed(range(0, D, KW)):
        yield "back", kq, kq


def blocked_cholesky_solve(M):
    """The solve on the bordered matrix (lower part read only), launch by
    launch in ``solve_plan``'s order: a part's update by the panel's parts
    before it, ``diag_block``, the rows below (row n with them) times L^-T, a
    panel's trailing update; a part's back-substitution launch, x_k =
    L_kk^-T y_k, taken off y left of the part. Returns x, the factor L (each diagonal block the
    inverse of the L^-1 that the kernels keep) and the L^-1 blocks by their
    first row."""
    n = len(M) - 1
    A = np.tril(M).copy()
    y, x = A[n], np.zeros(n)                           # row n: g, then y
    lower = lambda r0, c0, c1: np.arange(r0, n + 1)[:, None] >= np.arange(c0, c1)[None, :]
    Linvs = {}
    for kind, k0, kq in solve_plan(n):
        wd = min(KW, n - kq)
        if kind == "narrow":
            c1 = kq + wd
            A[kq:, kq:c1] -= lower(kq, kq, c1) * (A[kq:, k0:kq] @ A[kq:c1, k0:kq].T)
        elif kind == "diag":
            Linvs[kq] = diag_block(A[kq:kq + wd, kq:kq + wd])
        elif kind == "panel":
            A[kq + wd:, kq:kq + wd] = A[kq + wd:, kq:kq + wd] @ Linvs[kq][:wd, :wd].T
        elif kind == "trailing":
            A[kq:, kq:n] -= lower(kq, kq, n) * (A[kq:, k0:kq] @ A[kq:n, k0:kq].T)
        else:
            x[kq:kq + wd] = Linvs[kq][:wd, :wd].T @ y[kq:kq + wd]
            y[:kq] -= A[kq:kq + wd, :kq].T @ x[kq:kq + wd]
    L = np.tril(A[:n, :n])                             # the factor: the rows below
    for kq, Linv in Linvs.items():                     # each block, L_kk from L_kk^-1
        wd = min(KW, n - kq)
        L[kq:kq + wd, kq:kq + wd] = np.linalg.inv(Linv[:wd, :wd])
    return x, L, Linvs


def emulate(p):
    """The whole call on ``graph_case``'s ``p`` as the kernels make it, in
    float64: the result [K, 4, 4] and the costs accepted."""
    S = np.asarray(p["S_w"], np.float64).copy()
    ei, ej = p["i"], p["j"]
    Sij = np.asarray(p["S_ij"], np.float64)
    w = np.asarray(p["weight"], np.float64) * p["valid"]
    fixed, iters = p["fixed"], p["iters"]
    slot, nrow = slots_of(fixed)
    cost = np.sum(edge_cost(Sij, S[ei], S[ej], w))
    costs = [cost]
    for _ in range(iters):
        r, J = edge_chain(Sij, S[ei], S[ej], w)
        x, _, _ = blocked_cholesky_solve(assemble(ei, ej, J, r, fixed))
        Sn = S.copy()
        for p in np.flatnonzero(~fixed):
            xi = [Dual(np.asarray([-x[7 * slot[p] + c]])) for c in range(7)]
            with np.errstate(all="ignore"):
                Ep = sim3_exp_t(xi)
            top = np.asarray([[v.v[0] for v in row] for row in
                              mul34(const(S[p:p + 1]), Ep)])
            Sn[p, :3] = top
        c_new = np.sum(edge_cost(Sij, Sn[ei], Sn[ej], w))
        if c_new < cost:
            S, cost = Sn, c_new
            costs.append(cost)
    return S, costs


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------

def _sim3_np(xi):
    return np.asarray(tlie.sim3_exp(torch.as_tensor(np.asarray(xi, np.float64))))


def _random_sim3(rng, k):
    xi = np.concatenate([rng.normal(0, 2.0, (k, 3)), rng.normal(0, 0.6, (k, 3)),
                         rng.normal(0, 0.3, (k, 1))], 1)
    return _sim3_np(xi)


def _axis(rng, k, angle):
    a = rng.normal(size=(k, 3))
    return a / np.linalg.norm(a, axis=1, keepdims=True) * np.asarray(angle)[..., None]


BRANCHES = ("generic", "theta below eps", "sigma below eps", "both below eps", "near pi",
            "identity")


def branch_edges(rng, branch, E=24):
    """Edges whose residual rotation and log-scale lie in one branch of
    ``geom/lie.py``: S_ij = Err S_i S_j^-1 for random poses S_i, S_j."""
    Si, Sj = _random_sim3(rng, E), _random_sim3(rng, E)
    angle, sigma = rng.uniform(0.2, 1.2, E), rng.uniform(0.05, 0.4, E) * rng.choice([-1, 1], E)
    if branch in ("theta below eps", "both below eps"):
        angle = rng.uniform(1e-5, 3e-3, E)
    if branch in ("sigma below eps", "both below eps"):
        sigma = rng.uniform(-3e-3, 3e-3, E)
    if branch == "near pi":
        angle = np.pi - rng.uniform(5e-5, 5e-4, E)
    rho = rng.normal(0, 0.5, (E, 3)) * (1e-3 if branch == "both below eps" else 1.0)
    err = _sim3_np(np.concatenate([rho, _axis(rng, E, angle), sigma[:, None]], 1))
    if branch == "identity":
        Si = Sj = np.tile(np.eye(4), (E, 1, 1))
        err = np.tile(np.eye(4), (E, 1, 1))
    Sij = err @ Si @ np.linalg.inv(Sj)
    return Sij, Si, Sj


def plain_jacobian(Sij, Si, Sj, w):
    """``pose_graph_plain``'s Jacobian blocks: torch.func.jacfwd of its
    res_at in float64, [E, 7, 14]."""
    Sij_t, Si_t, Sj_t = (torch.as_tensor(a) for a in (Sij, Si, Sj))
    sw = torch.sqrt(torch.as_tensor(w))[:, None]

    def res_at(d):
        err = Sij_t @ (Sj_t @ tlie.sim3_exp(d[1:2])) @ tlie.sim3_inverse(
            Si_t @ tlie.sim3_exp(d[0:1]))
        r = tlie.sim3_log(err) * sw
        return r, r

    J, r = torch.func.jacfwd(res_at, has_aux=True)(torch.zeros((2, 7), dtype=F64))
    return r.numpy(), J.reshape(len(Sij), 7, 14).numpy()


GRAPH_CASES = ("drift", "fixed and invalid", "scale drift", "duplicate pair", "non-finite")


def graph_case(rng, case):
    """``chip_smoke.pose_graph_problem``'s graphs (``test_torch_sim3``'s
    drift chain and its variants) as numpy inputs; ``duplicate pair`` is the
    drift chain with its loop edge repeated as a covisibility edge of weight
    1, a covisibility edge across the chain and an edge from a pose to
    itself."""
    p = chip_smoke.pose_graph_problem(rng, "drift" if case == "duplicate pair" else case)
    if case == "duplicate pair":
        S_w, K = p["S_w"], len(p["S_w"])
        rel = (S_w[3] @ np.linalg.inv(S_w[8])).astype(np.float32)
        p.update(i=np.append(p["i"], [K - 1, 3, 6]).astype(np.int32),
                 j=np.append(p["j"], [0, 8, 6]).astype(np.int32),
                 S_ij=np.concatenate([p["S_ij"], np.stack([p["S_ij"][-1], rel,
                                                           np.eye(4, dtype=np.float32)])]),
                 weight=np.append(p["weight"], [1.0, 1.0, 1.0]).astype(np.float32),
                 valid=np.append(p["valid"], [True, True, True]))
    return p


def torch_args(p, dtype=torch.float32):
    """``pose_graph_optimize``'s arguments on the CPU: (S_w, edges, fixed)."""
    return chip_smoke.pose_graph_args(torch, p, "cpu", dtype)[0]


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------

def test_dispatch_by_device():
    """CPU tensors run the plain version; another device raises; the wrapper
    refuses CPU tensors (no route from CUDA to the plain version exists)."""
    S_w, edges, fixed = torch_args(graph_case(np.random.default_rng(0), "drift"))
    got = tsim3.pose_graph_optimize(S_w, edges, fixed, iters=3)
    ref = kpg.pose_graph_plain(S_w, edges, fixed, iters=3)
    assert torch.equal(got, ref)
    with pytest.raises(ValueError, match="unsupported device"):
        tsim3.pose_graph_optimize(S_w.to("meta"), edges, fixed, iters=3)
    with pytest.raises(ValueError, match="CUDA device"):
        kpg.pose_graph_gn(S_w, edges, fixed, iters=3)
    with pytest.raises(ValueError, match="float32"):
        kpg.pose_graph_gn(S_w.double(), edges, fixed, iters=3)


def test_launches_per_call():
    """The launch plan the emulation walks (``solve_plan``, the kernel's
    ``for_each_solve_launch``; the card test holds ``launches_per_call`` to
    the same counts): setup and the entry cost, then per iteration edge,
    assembly, poses, cost and the solve's launches up to the 7K rows: each
    64-column part's diagonal block, rows below and back-substitution and,
    but for a panel's first part, its update; each panel's trailing update
    but the last's."""
    assert (KW, KNB) == (64, 256)
    per_call = lambda K, iters: 2 + iters * (4 + sum(1 for _ in solve_plan(7 * K)))
    # 4f's closure, 7 x 49 = 343 rows: 6 parts, 4 in the first panel and 2
    # in the second: 6 x 3 + (3 + 1) narrow updates + 1 trailing update
    assert per_call(49, 15) == 2 + 15 * (4 + 6 * 3 + 4 + 1) == 407
    assert per_call(256, 15) == 2 + 15 * (3 + 4 * 28) == 1727
    assert per_call(400, 15) == 2 + 15 * (3 + 4 * 44) == 2687
    assert per_call(2048, 2) == 2 + 2 * (3 + 4 * 224) == 1800
    assert per_call(2048, 0) == 2
    assert per_call(1, 1) == 2 + 4 + 3


@pytest.mark.parametrize("branch", BRANCHES)
def test_edge_blocks_equal_jacfwd(branch):
    """The dual-number blocks equal torch.func.jacfwd of the plain chain to
    1e-10 of each edge's largest entry, the residuals likewise, in each
    branch of geom/lie.py (checked: the branch the residual falls in)."""
    rng = np.random.default_rng(BRANCHES.index(branch))
    Sij, Si, Sj = branch_edges(rng, branch)
    w = rng.uniform(0.5, 5.0, len(Sij))
    r_e, J_e = edge_chain(Sij, Si, Sj, w)
    r_p, J_p = plain_jacobian(Sij, Si, Sj, w)
    # the branch: theta and sigma of the unweighted residual
    theta = np.linalg.norm(r_p[:, 3:6] / np.sqrt(w)[:, None], axis=1)
    sigma = np.abs(r_p[:, 6] / np.sqrt(w))
    want = {"generic": (theta >= EPS) & (sigma >= EPS),
            "theta below eps": (theta < EPS) & (sigma >= EPS),
            "sigma below eps": (theta >= EPS) & (sigma < EPS),
            "both below eps": (theta < EPS) & (sigma < EPS),
            "near pi": theta > np.pi - 1e-3,
            "identity": (theta < 1e-11) & (sigma < 1e-11)}[branch]
    assert want.all(), (theta, sigma)
    scale = np.maximum(np.abs(J_p).max(axis=(1, 2)), 1.0)
    assert np.all(np.abs(J_e - J_p).max(axis=(1, 2)) <= 1e-10 * scale)
    assert np.abs(r_e - r_p).max() <= 1e-10 * max(np.abs(r_p).max(), 1.0)


@pytest.mark.parametrize("case", ["drift", "fixed and invalid", "duplicate pair"])
def test_free_row_assembly_equals_plain(case):
    """The free rows' bordered system in edge order equals the plain H and g
    restricted to the free rows (lower part, 1e-12 of the largest entry); a
    duplicated pair and an edge from a pose to itself included."""
    p = graph_case(np.random.default_rng(1), case)
    S64, fixed = p["S_w"].astype(np.float64), p["fixed"]
    w = p["weight"].astype(np.float64) * p["valid"]
    r, J = edge_chain(p["S_ij"].astype(np.float64), S64[p["i"]], S64[p["j"]], w)
    M = assemble(p["i"], p["j"], J, r, fixed)
    H, g = chip_smoke.pose_graph_system(torch, torch_args(p))
    rows = np.flatnonzero(np.repeat(~fixed, 7))
    nfree = len(rows)
    Hf = H.numpy()[np.ix_(rows, rows)]
    scale = np.abs(Hf).max()
    assert np.abs(np.tril(M[:nfree, :nfree]) - np.tril(Hf)).max() <= 1e-12 * scale
    assert np.abs(M[nfree, :nfree] - g.numpy()[rows]).max() <= 1e-12 * scale
    # the fixed rows of the plain system: (1 + 1e-6) I, g 0, nothing coupled
    fr = np.flatnonzero(np.repeat(fixed, 7))
    np.testing.assert_array_equal(H.numpy()[np.ix_(fr, fr)], (1 + 1e-6) * np.eye(len(fr)))
    assert not H.numpy()[np.ix_(fr, rows)].any() and not g.numpy()[fr].any()


@pytest.mark.parametrize("n_poses", [9, 11, 30, 37, 40, 64, 73, 256])
def test_blocked_cholesky_solves_as_dense(n_poses):
    """The bordered blocked Cholesky and the back-substitution solve H x = g
    as torch.linalg.solve does (1e-9 relative) and L L^T = H (1e-9): n below
    one diagonal block (63 rows), a partial last part (77, 210, 259, 280,
    511 rows), n below one panel (63, 77, 210), a partial last panel (259,
    280, 448, 511: 3, 24, 192 and 255 rows in it), the last part filled
    exactly (448) and the last panel filled exactly (1,792). Each L^-1 is
    lower triangular and the identity past the rows it inverts."""
    rng = np.random.default_rng(n_poses)
    n = 7 * n_poses
    J = rng.normal(size=(3 * n, n)) * rng.uniform(0.1, 10.0, n)
    H = J.T @ J + 1e-6 * np.eye(n)
    g = rng.normal(size=n)
    M = np.zeros((n + 1, n + 1))
    M[:n, :n] = np.tril(H)
    M[n, :n] = g
    x, L, Linvs = blocked_cholesky_solve(M)
    ref = torch.linalg.solve(torch.as_tensor(H), torch.as_tensor(g)).numpy()
    assert np.abs(x - ref).max() <= 1e-9 * np.abs(ref).max()
    assert np.abs(np.tril(L @ L.T - H)).max() <= 1e-9 * np.abs(H).max()
    assert sorted(Linvs) == list(range(0, n, KW))
    for kq, Linv in Linvs.items():
        wd = min(KW, n - kq)
        assert not np.triu(Linv, 1).any() and not Linv[wd:, :wd].any()
        np.testing.assert_array_equal(Linv[wd:, wd:], np.eye(KW - wd))


@pytest.mark.parametrize("case", GRAPH_CASES)
def test_whole_call_matches_jax_and_plain(case):
    """The emulated call is within 1e-4 of the JAX pose_graph_optimize (and
    of pose_graph_plain in float32), within 1e-8 of pose_graph_plain run in
    float64, fixed poses unmoved; a non-finite edge leaves every pose as it
    came, as there."""
    p = graph_case(np.random.default_rng(2), case)
    S_w, fixed, iters = p["S_w"], p["fixed"], p["iters"]
    got, costs = emulate(p)
    jedges = jsim3.PoseGraphEdges(**{k: jnp.asarray(p[k]) for k in jsim3.PoseGraphEdges._fields})
    ref_j = np.asarray(jsim3.pose_graph_optimize(jnp.asarray(S_w), jedges, jnp.asarray(fixed),
                                                 iters=iters))
    ref32 = n(kpg.pose_graph_plain(*torch_args(p), iters=iters))
    ref64 = n(kpg.pose_graph_plain(*torch_args(p, F64), iters=iters))
    if case == "non-finite":
        np.testing.assert_array_equal(got.astype(np.float32), S_w)
        np.testing.assert_array_equal(ref_j, S_w)
        np.testing.assert_array_equal(ref64.astype(np.float32), S_w)
        assert np.isnan(costs[0]) and len(costs) == 1
        return
    np.testing.assert_allclose(got, ref_j, atol=1e-4)
    np.testing.assert_allclose(got, ref32, atol=1e-4)
    np.testing.assert_allclose(got, ref64, atol=1e-8)
    np.testing.assert_array_equal(got[fixed].astype(np.float32), S_w[fixed])
    assert len(costs) > 1 and costs[-1] < costs[0]


def test_whole_call_matches_jax_x64():
    """The drift case against the JAX pose_graph_optimize in x64 (1e-8)."""
    p = graph_case(np.random.default_rng(3), "drift")
    got, _ = emulate(p)
    with jax.enable_x64(True):
        jedges = jsim3.PoseGraphEdges(
            i=jnp.asarray(p["i"]), j=jnp.asarray(p["j"]), S_ij=jnp.asarray(p["S_ij"], jnp.float64),
            weight=jnp.asarray(p["weight"], jnp.float64), valid=jnp.asarray(p["valid"]))
        ref = np.asarray(jsim3.pose_graph_optimize(jnp.asarray(p["S_w"], jnp.float64), jedges,
                                                   jnp.asarray(p["fixed"]), iters=p["iters"]))
    np.testing.assert_allclose(got, ref, atol=1e-8)


def test_close_loop_hands_the_used_slots(monkeypatch):
    """``close_loop`` optimizes the n_kf used slots only: that call equals the
    call over every slot with the tail fixed (1e-6), which leaves the tail
    unmoved, and the map keeps its tail keyframes' poses."""
    _, mt, T = _dense_map()
    kf, n_kf, K = 13, 14, mt.K
    assert K > n_kf
    drift = np.asarray(jlie.se3_exp(jnp.asarray([0.3, -0.1, 0.2, 0.02, 0.05, -0.03], jnp.float32)))
    S = t((drift @ T[13] @ np.linalg.inv(T[0])).astype(np.float32))
    seen = []
    orig = tsim3.pose_graph_optimize

    def spy(S_w, edges, fixed, iters=20):
        seen.append((S_w, edges, fixed, iters))
        return orig(S_w, edges, fixed, iters=iters)

    monkeypatch.setattr(tlc.sim3_mod, "pose_graph_optimize", spy)
    out = tlc.close_loop(mt, kf, 0, S, iters=12, n_kf=n_kf)
    S_w, edges, fixed, iters = seen[0]
    assert S_w.shape == (n_kf, 4, 4) and fixed.shape == (n_kf,) and iters == 12
    assert fixed.tolist() == [True] + [False] * (n_kf - 1)
    assert int(torch.cat([edges.i, edges.j]).max()) < n_kf
    ids = torch.arange(K)
    full = orig(mt.kf_T_cw, edges, (ids == 0) | (ids >= n_kf), iters=12)
    np.testing.assert_allclose(n(orig(S_w, edges, fixed, iters=12)), n(full[:n_kf]), atol=1e-6)
    assert torch.equal(full[n_kf:], mt.kf_T_cw[n_kf:])
    assert torch.equal(out.kf_T_cw[n_kf:], mt.kf_T_cw[n_kf:])
    assert np.abs(n(out.kf_T_cw[1:n_kf]) - n(mt.kf_T_cw[1:n_kf])).max() > 1e-3


def _dense_map():
    """``test_torch_loop_closing``'s dense map (16 slots, 14 keyframes)."""
    m, T = build_dense_map(np.random.default_rng(3))
    return m, interop.mapstate_from_numpy(m), T


def test_pose_graph_problem_sizes():
    """chip_smoke's graphs: the 400-keyframe one has 2,793 free rows, the
    2,048-keyframe one 14,329 (run_kitti_torch.py's max_kf), each edge
    inside the graph and the loop edges true."""
    for case, K, n_edges in (("covisibility 400", 400, 399 + 398 + 397 + 395 + 8),
                             ("2048 keyframes", 2048, 2047 + 2046 + 2045 + 8)):
        p = chip_smoke.pose_graph_problem(np.random.default_rng(26), case)
        assert p["S_w"].shape == (K, 4, 4) and len(p["i"]) == n_edges
        assert 7 * int((~p["fixed"]).sum()) == 7 * (K - 1)
        assert p["i"].max() < K and p["j"].max() < K and np.isfinite(p["S_ij"]).all()
    assert p["iters"] == chip_smoke.PG_ITERS_2048


def test_pose_graph_phase_on_cpu():
    """``chip_smoke.pose_graph_phase`` on the CPU route (the plain version in
    float32 against itself in float64) over the small graphs; the limits
    it holds a graph to, finite at every size; the bound."""
    cases = [(case,) + chip_smoke.pose_graph_args(
        torch, chip_smoke.pose_graph_problem(np.random.default_rng(26), case), "cpu")
        for case in chip_smoke.PG_CASES[:4]]
    rows = chip_smoke.pose_graph_phase(torch, "cpu", cases, log=lambda m: None)
    row = rows["pose_graph_gn"]
    assert row["max_abs_err"] <= chip_smoke.PG_TOL
    assert row["replaces"] == "tc2li_slam_tpu/solver/sim3.py:112"
    assert set(row["ms_by_case"]["drift"]) >= {"ms", "plain_ms", "bound_ms", "library_ms"}
    assert chip_smoke.pose_graph_tol(49) == chip_smoke.pose_graph_tol(400) == chip_smoke.PG_TOL
    assert chip_smoke.PG_TOL < chip_smoke.pose_graph_tol(2048) == chip_smoke.PG_TOL_LARGE < 1e-2
    b = chip_smoke.pose_graph_bound(49, 48, 181, 15)
    assert b[1] == "operations" and 0 < b[0] < 0.1
