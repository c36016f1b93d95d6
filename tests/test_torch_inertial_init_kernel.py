"""The visual-inertial initialization's kernel (``csrc/inertial_init.cu``,
``ops/kernels/inertial_init.py``) on the CPU: the dispatch by device, and
the kernel's arithmetic emulated in float64 numpy against the plain version
run in float64, the JAX ``inertial_optimization`` (x64) and ``torch.func.jacfwd``.

The kernel cannot run here. What it does differently from the plain version
is how it forms the Jacobian and the shape of its sums and solve, and the
emulation (``_emulate``) repeats them: each factor's residual evaluated with
forward-mode dual numbers by the kernel's formulas (``factor_residual``:
``so3_exp_t`` and ``so3_log_t`` with their Taylor branches and clamps, L^T
from a Cholesky of the lower triangle in float64), one tangent a local
column, giving the factor's whitened 9 x 15 block; H and g summed block by
block in factor order, then the priors; the frozen rows and columns the
identity with g 0; ``(h + lam h) + 1e-9`` on the diagonal; the Jacobi
scaling; Gauss-Jordan with the kernel's pivot rule (the first largest |a|
among the rows not yet pivots, a NaN never wins); the candidate's cost and
the accept test. Cases: ``chip_smoke.init_problem``'s windows (20 keyframes
with free gravity and free scale, free gravity, 6 keyframes padded to 20 as
``System._initialize_imu`` pads them, a NaN in a valid and in an invalid
factor), the fixed-gravity and fixed-scale flags four ways, and each of
``System.VI_STAGE_PRIORS``; and ``test_torch_inertial.init_problem``'s
window against the JAX package.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from test_torch_inertial import init_problem as jax_init_problem, tt
from tc2li_slam_tpu.solver import inertial_init as jinit
from tc2li_slam_torch.ops.kernels import inertial_init as kii
from tc2li_slam_torch.slam import system as tsys
from tc2li_slam_torch.solver import inertial_init as tinit

F64 = torch.float64
EPS = 5e-3            # geom/lie.py _EPS (csrc/imu_factor.cuh kEps)
G = 9.81


# ---------------------------------------------------------------------------
# forward-mode dual numbers over numpy: a value [F] and 15 tangents [F, 15]
# (the kernel's thread (f, j) holds the value and tangent j; each tangent's
# arithmetic is the same whether carried alone or beside the others)
# ---------------------------------------------------------------------------

class Dual:
    __slots__ = ("v", "d")
    __array_ufunc__ = None   # an array times a Dual is the Dual's product

    def __init__(self, v, d=None):
        self.v = np.asarray(v, np.float64)
        self.d = np.zeros(self.v.shape + (15,)) if d is None else d

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


def datan2(y, x):
    return Dual(np.arctan2(y.v, x.v), (y.d * x.v[..., None] - x.d * y.v[..., None])
                / (y.v * y.v + x.v * x.v)[..., None])


def dclamp(x, lo, hi=np.inf):
    """torch.clamp: the tangent passes where lo <= value <= hi; a NaN stays."""
    inside = (x.v >= lo) & (x.v <= hi)
    return Dual(np.where(x.v < lo, lo, np.where(x.v > hi, hi, x.v)), x.d * inside[..., None])


def dwhere(c, a, b):
    a, b = Dual.of(a), Dual.of(b)
    return Dual(np.where(c, a.v, b.v), np.where(c[..., None], a.d, b.d))


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


def so3_exp_t(w):
    """csrc/inertial_init.cu so3_exp_t: w a list of 3 Duals -> R a 3 x 3 list."""
    th = dsqrt(dclamp((w[0] * w[0] + w[1] * w[1]) + w[2] * w[2], 1e-24))
    sa, ca = _sinc(th), _cosc(th)
    z = Dual(np.zeros_like(w[0].v))
    W = [[z, -w[2], w[1]], [w[2], z, -w[0]], [-w[1], w[0], z]]
    return [[((1.0 if i == j else 0.0) + sa * W[i][j])
             + ca * ((W[i][0] * W[0][j] + W[i][1] * W[1][j]) + W[i][2] * W[2][j])
             for j in range(3)] for i in range(3)]


def so3_log_t(R):
    """csrc/inertial_init.cu so3_log_t (the generic branch; the windows here
    keep the residual rotation far from pi)."""
    tr = (R[0][0] + R[1][1]) + R[2][2]
    c = dclamp((tr - 1.0) * 0.5, -1.0, 1.0)
    ws = [R[2][1] - R[1][2], R[0][2] - R[2][0], R[1][0] - R[0][1]]
    s = 0.5 * dsqrt(dclamp((ws[0] * ws[0] + ws[1] * ws[1]) + ws[2] * ws[2], 1e-24))
    th = datan2(s, c)
    assert not np.any(th.v > np.pi - 1e-3)
    f = 0.5 / _sinc(th)
    return [f * ws[k] for k in range(3)]


def _factors(a):
    """The kernel's load phase: a factor's fields in float64, R1, R1^T R2,
    p2 - p1, and L^T from a Cholesky of C_inv + 1e-6 I's lower triangle."""
    T = a[0].double().numpy()
    q = {k: a[i].double().numpy() for i, k in enumerate(chip_smoke.INIT_ARGS[:13]) if i}
    q["valid"] = a[13].numpy().astype(np.float64)
    R, p = T[:, :3, :3], T[:, :3, 3]
    q["R1"], q["R12"], q["dp"] = R[:-1], np.einsum("fki,fkj->fij", R[:-1], R[1:]), p[1:] - p[:-1]
    F = len(q["dt"])
    Lt = np.zeros((F, 9, 9))
    for f in range(F):
        C = q["C_inv"][f]
        L = np.zeros((9, 9))
        for j in range(9):
            d = C[j, j] + 1e-6
            for k in range(j):
                d -= L[j, k] * L[j, k]
            L[j, j] = np.sqrt(d)
            for i in range(j + 1, 9):
                s = C[i, j]
                for k in range(j):
                    s -= L[i, k] * L[j, k]
                L[i, j] = s / L[j, j]
        Lt[f] = L.T
    q["Lt"] = Lt
    return q


def factor_residual(q, Rwg0, x, fix_scale, seed=True):
    """csrc/inertial_init.cu factor_residual for every factor at x: the
    whitened residual [F, 9] and, with ``seed``, its tangents [F, 9, 15]
    along the factor's 15 local columns."""
    F = len(q["dt"])
    eye = np.eye(15)

    def inp(vals, col):   # a [F] input, seeded on local column col
        vals = np.broadcast_to(np.asarray(vals, np.float64), (F,)).copy()
        return Dual(vals, np.tile(eye[col], (F, 1)) if seed else None)

    phi = [inp(x[0], 0), inp(x[1], 1), Dual(np.zeros(F))]
    E = so3_exp_t(phi)
    gw = []
    for k in range(3):
        RE = [(Rwg0[k, 0] * E[0][m] + Rwg0[k, 1] * E[1][m]) + Rwg0[k, 2] * E[2][m]
              for m in range(3)]
        gw.append((RE[0] * 0.0 + RE[1] * 0.0) + RE[2] * (-G))
    s = Dual(np.ones(F)) if fix_scale else dexp(inp(x[2], 2))
    vi = 9 + 3 * np.arange(F)
    dbg = [inp(x[3 + k], 3 + k) - q["bg_lin"][:, k] for k in range(3)]
    dba = [inp(x[6 + k], 6 + k) - q["ba_lin"][:, k] for k in range(3)]
    v1 = [inp(x[vi + k], 9 + k) for k in range(3)]
    v2 = [inp(x[vi + 3 + k], 12 + k) for k in range(3)]
    mv = lambda M, i, u: (M[:, i, 0] * u[0] + M[:, i, 1] * u[1]) + M[:, i, 2] * u[2]
    wb = [mv(q["JRg"], i, dbg) for i in range(3)]
    dVc = [(q["dV"][:, i] + mv(q["JVg"], i, dbg)) + mv(q["JVa"], i, dba) for i in range(3)]
    dPc = [(q["dP"][:, i] + mv(q["JPg"], i, dbg)) + mv(q["JPa"], i, dba) for i in range(3)]
    Eb = so3_exp_t(wb)
    dR = q["dR"]
    dRc = [[(dR[:, i, 0] * Eb[0][j] + dR[:, i, 1] * Eb[1][j]) + dR[:, i, 2] * Eb[2][j]
            for j in range(3)] for i in range(3)]
    R12 = q["R12"]
    eR = [[(dRc[0][i] * R12[:, 0, j] + dRc[1][i] * R12[:, 1, j]) + dRc[2][i] * R12[:, 2, j]
           for j in range(3)] for i in range(3)]
    r9 = so3_log_t(eR)
    dt, R1 = q["dt"], q["R1"]
    av = [s * (v2[k] - v1[k]) - gw[k] * dt for k in range(3)]
    bv = [s * (q["dp"][:, k] - v1[k] * dt) - (0.5 * gw[k] * dt) * dt for k in range(3)]
    r9 += [((R1[:, 0, i] * av[0] + R1[:, 1, i] * av[1]) + R1[:, 2, i] * av[2]) - dVc[i]
           for i in range(3)]
    r9 += [((R1[:, 0, i] * bv[0] + R1[:, 1, i] * bv[1]) + R1[:, 2, i] * bv[2]) - dPc[i]
           for i in range(3)]
    out = []
    for i in range(9):
        acc = q["Lt"][:, i, 0] * r9[0]
        for j in range(1, 9):
            acc = acc + q["Lt"][:, i, j] * r9[j]
        out.append(acc * q["valid"])
    return (np.stack([o.v for o in out], 1),
            np.stack([o.d for o in out], 1) if seed else None)


def _first_largest(col):
    """gauss_jordan's pivot among the rows not yet pivots (in position
    order): the first largest |a|; a NaN never wins; the first row stands in
    where no row has a number."""
    best, bi = -1.0, 0
    for i, a in enumerate(np.abs(col)):
        if a > best:
            best, bi = a, i
    return bi


def _solve(M):
    """The scaled system [n, n + 1] by Gauss-Jordan (rows swapped here; the
    kernel keeps them in place and tracks positions, the same choices);
    returns y."""
    A = M.copy()
    n = A.shape[0]
    for c in range(n):
        piv = c + _first_largest(A[c:, c])
        A[[c, piv]] = A[[piv, c]]
        inv = 1.0 / A[c, c]
        for r in range(n):
            if r != c:
                A[r, c + 1:] -= (A[r, c] * inv) * A[c, c + 1:]
    return A[:, n] / np.diag(A[:, :n])


def _system(q, Rwg0, x, lam, kw):
    """The kernel's damped system [n, n + 1] (H | g) at x, before the
    scaling: each factor's 15 x 15 block and gradient added in factor order,
    then the priors; frozen rows and columns the identity with g 0; the
    diagonal (h + lam h) + 1e-9."""
    F, n = len(q["dt"]), len(x)
    r, J = factor_residual(q, Rwg0, x, kw["fix_scale"])
    H, g = np.zeros((n, n)), np.zeros(n)
    for f in range(F):
        cols = np.r_[0:9, 9 + 3 * f:15 + 3 * f]
        H[np.ix_(cols, cols)] += J[f].T @ J[f]
        g[cols] += J[f].T @ r[f]
    spg, spa = np.sqrt(kw["prior_g"]), np.sqrt(kw["prior_a"])
    H[range(3, 6), range(3, 6)] += spg * spg
    H[range(6, 9), range(6, 9)] += spa * spa
    g[3:6] += spg * (spg * x[3:6])
    g[6:9] += spa * (spa * x[6:9])
    frozen = ([2] if kw["fix_scale"] else []) + ([0, 1] if kw["fix_gravity"] else [])
    for c in frozen:
        H[c, :], H[:, c], g[c] = 0.0, 0.0, 0.0
        H[c, c] = 1.0
    d = np.diag(H).copy()
    H[range(n), range(n)] = (d + lam * d) + 1e-9
    return np.concatenate([H, g[:, None]], 1)


def _cost(q, Rwg0, x, kw):
    r, _ = factor_residual(q, Rwg0, x, kw["fix_scale"], seed=False)
    c = 0.0
    for f in range(len(r)):
        c += np.sum(r[f] ** 2)
    spg, spa = np.sqrt(kw["prior_g"]), np.sqrt(kw["prior_a"])
    for k in range(3):
        c += (spg * x[3 + k]) ** 2
    for k in range(3):
        c += (spa * x[6 + k]) ** 2
    return c


def _emulate(a, kw):
    """``inertial_init_gn``'s launch in float64 numpy, in the kernel's order."""
    q = _factors(a)
    Rwg0 = a[14].double().numpy()
    K = a[0].shape[0]
    x = np.concatenate([np.zeros(9), a[15].double().numpy().reshape(-1)])
    cost, lam = _cost(q, Rwg0, x, kw), 1e-4
    with np.errstate(invalid="ignore", divide="ignore", over="ignore"):
        for _ in range(kw["iters"]):
            M = _system(q, Rwg0, x, lam, kw)
            n = len(x)
            d = np.sqrt(np.maximum(np.abs(np.diag(M[:, :n])), 1e-12))
            M[:, :n] /= d[:, None] * d[None, :]
            M[:, n] /= d
            x_new = x - _solve(M) / d
            cand = _cost(q, Rwg0, x_new, kw)
            if cand < cost:   # a NaN rejects
                x, cost, lam = x_new, cand, lam * 0.5
            else:
                lam *= 4.0
    phi = torch.tensor([x[0], x[1], 0.0], dtype=F64)
    from tc2li_slam_torch.geom import lie
    return tinit.InertialInitResult(
        R_wg=torch.as_tensor(Rwg0) @ lie.so3_exp(phi),
        scale=torch.tensor(1.0 if kw["fix_scale"] else np.exp(x[2]), dtype=F64),
        bg=torch.as_tensor(x[3:6]), ba=torch.as_tensor(x[6:9]),
        vel=torch.as_tensor(x[9:]).reshape(K, 3), cost=torch.tensor(cost, dtype=F64))


def _case(case, seed=3, **kw):
    p = chip_smoke.init_problem(np.random.default_rng(seed), case)
    a, kw0 = chip_smoke.init_args(torch, p, "cpu", dtype=F64)
    return p, a, {**kw0, **kw}


def _close(got, ref, tol):
    """Emulation and plain version in float64: the same algorithm, other
    orders of sums and LU for Gauss-Jordan."""
    for x, y in zip(got, ref):
        x, y = x.double(), y.double()
        assert torch.equal(torch.isnan(x), torch.isnan(y))
        np.testing.assert_allclose(torch.nan_to_num(x).numpy(), torch.nan_to_num(y).numpy(),
                                   rtol=tol, atol=tol)


@pytest.mark.parametrize("case", chip_smoke.INIT_CASES)
def test_kernel_order_matches_plain_float64(case):
    p, a, kw = _case(case)
    got = _emulate(a, kw)
    ref = kii.inertial_init_plain(*a, **kw)
    assert ref.vel.dtype == F64
    _close(got, ref, 1e-8)
    if case.startswith("non-finite"):   # the entry state comes back, the cost NaN
        assert torch.isnan(got.cost) and torch.equal(got.vel, a[15])
        assert torch.equal(got.bg, torch.zeros(3, dtype=F64))
    else:
        assert float(got.cost) < float(_emulate(a, dict(kw, iters=0)).cost)


@pytest.mark.parametrize("fix_gravity,fix_scale", [(False, False), (False, True), (True, False),
                                                   (True, True)])
def test_kernel_order_flags(fix_gravity, fix_scale):
    """Each combination of the frozen coordinates on the free-gravity window
    (8 iterations): the frozen coordinates stay where they were."""
    p, a, kw = _case("free gravity and scale", fix_gravity=fix_gravity, fix_scale=fix_scale)
    got = _emulate(a, kw)
    _close(got, kii.inertial_init_plain(*a, **kw), 1e-8)
    if fix_gravity:
        assert torch.equal(got.R_wg, a[14])
    if fix_scale:
        assert float(got.scale) == 1.0


@pytest.mark.parametrize("stage", [0, 1, 2])
def test_kernel_order_stage_priors(stage):
    """The three rungs' bias priors (``System.VI_STAGE_PRIORS``) on the padded
    4e-like window, as ``_initialize_imu`` passes them with the filter's
    gravity."""
    prior_g, prior_a = tsys.System.VI_STAGE_PRIORS[stage]
    p, a, kw = _case("4e-like padded", prior_g=prior_g, prior_a=prior_a)
    _close(_emulate(a, kw), kii.inertial_init_plain(*a, **kw), 1e-8)


def test_kernel_order_matches_jax_x64():
    """The emulation against the JAX ``inertial_optimization`` in float64 on
    ``test_torch_inertial``'s window (8 keyframes, free gravity; free scale
    too), and the float32 run of the plain version against the same."""
    args, vel0, _ = jax_init_problem(np.random.default_rng(0))
    R_wg0 = jinit.estimate_gravity_direction(args[0][:, :3, :3], args[2], args[13])
    for kw in (dict(prior_g=1e2, prior_a=1e4, fix_scale=True, fix_gravity=False, iters=20),
               dict(prior_g=1.0, prior_a=1e4, fix_scale=False, fix_gravity=False, iters=8)):
        with jax.enable_x64(True):
            j64 = [jnp.asarray(np.asarray(x, np.float64) if np.asarray(x).dtype.kind == "f"
                               else np.asarray(x)) for x in (*args, R_wg0, vel0)]
            ref = jinit.inertial_optimization(*j64, **kw)
            ref = tinit.InertialInitResult(*(torch.as_tensor(np.asarray(x)) for x in ref))
        a = tuple(tt(x).double() if tt(x).is_floating_point() else tt(x)
                  for x in (*args, R_wg0, vel0))
        got = _emulate(a, kw)
        # (the JAX package's module constants, the gravity vector among
        # them, stay float32 under x64: test_torch_inertial's tolerances)
        agr = chip_smoke.init_agreement(torch, got, ref)
        assert all(agr[k] <= tol for k, tol in chip_smoke.INIT_TOL.items()), agr


def test_jacobian_matches_jacfwd_of_the_plain_residual(monkeypatch):
    """The emulated kernel's whitened blocks, scattered into the residual
    vector's Jacobian [9 (K - 1) + 6, 9 + 3K], against ``torch.func.jacfwd``
    of the plain version's own residual function (float64) at a point where
    the biases are off their linearization point and the gravity tangent is
    not 0, scale free."""
    p, a, kw = _case("free gravity and scale")
    K = a[0].shape[0]
    seen = []
    jacfwd = torch.func.jacfwd
    monkeypatch.setattr(torch.func, "jacfwd", lambda f: seen.append(f) or jacfwd(f))
    kii.inertial_init_plain(*a, **dict(kw, iters=0))
    residuals = seen[0]
    rng = np.random.default_rng(4)
    x = np.concatenate([[0.03, -0.02, 0.1], rng.normal(0, 0.01, 3), rng.normal(0, 0.05, 3),
                        a[15].double().numpy().reshape(-1) + rng.normal(0, 0.1, 3 * K)])
    ref = jacfwd(residuals)(torch.as_tensor(x)).numpy()
    r_ref = residuals(torch.as_tensor(x)).numpy()
    q = _factors(a)
    r, J = factor_residual(q, a[14].double().numpy(), x, kw["fix_scale"])
    got = np.zeros_like(ref)
    for f in range(K - 1):
        got[9 * f:9 * f + 9, np.r_[0:9, 9 + 3 * f:15 + 3 * f]] = J[f]
    F = K - 1
    got[9 * F + np.arange(3), 3 + np.arange(3)] = np.sqrt(kw["prior_g"])
    got[9 * F + 3 + np.arange(3), 6 + np.arange(3)] = np.sqrt(kw["prior_a"])
    # each entry against its column's scale: the same derivative, other
    # roundings of the products (R1^T R2 formed first)
    scale = np.maximum(np.abs(ref).max(0, keepdims=True), 1e-30)
    assert np.abs((got - ref) / scale).max() < 1e-9
    np.testing.assert_allclose(r.reshape(-1), r_ref[:9 * F], rtol=1e-9, atol=1e-9)
    # the bias block is the exact one, not EdgeInertial's approximation
    # -Jr^-1(er) eR^T JRg: the two differ here by more than the tolerance
    assert np.abs(ref[:9 * F, 3:6]).max() > 0


def test_inertial_optimization_routes_cpu_tensors_to_the_plain_version(monkeypatch):
    """``solver.inertial_init.inertial_optimization`` sends CPU tensors to
    ``inertial_init_plain``; ``inertial_init_gn`` refuses CPU tensors (it
    launches a kernel or raises), K over ``MAX_KF`` and other types; another
    device is refused."""
    p, a, kw = _case("4e-like padded")
    a32 = chip_smoke._vi_cast(torch, a, torch.float32)
    seen = []
    plain = kii.inertial_init_plain
    monkeypatch.setattr(kii, "inertial_init_plain", lambda *x, **k: seen.append(1) or plain(*x, **k))
    res = tinit.inertial_optimization(*a32, **kw)
    assert seen == [1] and res.vel.dtype == torch.float32
    with pytest.raises(ValueError, match="one CUDA device"):
        kii.inertial_init_gn(*a32, **kw)
    with pytest.raises(ValueError, match="torch.float32"):
        kii.inertial_init_gn(*a, **kw)
    big = chip_smoke.init_problem(np.random.default_rng(0), "4e-like padded", K=kii.MAX_KF + 1)
    ab, kwb = chip_smoke.init_args(torch, big, "cpu")
    assert ab[0].shape[0] == kii.MAX_KF + 1
    with pytest.raises(ValueError, match=f"K {kii.MAX_KF + 1}"):
        kii.inertial_init_gn(*ab, **kwb)
    meta = (a32[0].to("meta"),) + a32[1:]
    with pytest.raises(ValueError, match="unsupported device"):
        tinit.inertial_optimization(*meta, **kw)


def test_max_kf_is_the_shared_memory_limit():
    """``MAX_KF`` is the largest K whose call fits a block's shared memory on
    the H100 (the dynamic part, ``smem_bytes``, and the kernel's few static
    scalars); ``System``'s 20-keyframe window fits, and the JAX package's
    windows of any K are refused above it on the card."""
    assert kii.smem_bytes(kii.MAX_KF) + 64 <= kii.SMEM_LIMIT < kii.smem_bytes(kii.MAX_KF + 1)
    assert kii.MAX_KF >= 20
    assert kii.smem_bytes(20) == 8 * (69 * 70 + 3 * 69 + 19 * 315 + 9) + 8 * 69
