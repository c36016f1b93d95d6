"""The IMU mode's scan-step kernels (``ops/kernels/lio.py``,
``csrc/lio.cu``) on the CPU, where the kernels cannot run: their plain
versions against the JAX package, and a float64 numpy emulation of the
kernels' structure against the JAX ``lio_scan_step``, on the same numpy
inputs (``test_torch_esekf.lio_fixture``'s planar world).

The emulation repeats what the kernels do in their order: the prediction
from F's blocks; the fence table of the pool keys (every 32nd key) as the
predict launch's fence blocks write it, and the search of a fence, then of
its bucket, which equals ``searchsorted``; the
candidate order of the 25 voxel columns, the 5 nearest by (d^2, candidate
index) as 64-bit keys in float32 and the plane fit, gate and row in float64,
a lane a query; each block's partial sums over its batches of 32 queries in
the grid's static order (block b takes batches b, b + G, ..., G a function
of M alone), entry-major [E, G], and the step's fixed-order reduction of
them (four interleaved accumulators a lane, a xor tree over the lanes);
P0^-1 by Gauss-Jordan with partial pivoting (rows keep their places,
their positions swap; the pivot by a warp argmax that takes the lowest
position on ties), the transport Jacobian's closed blocks with the
S2 block by forward-mode dual numbers, the Cholesky step with both
triangular solves column by column (by the diagonal's inverses), the final
inverse and the guard. Tolerances against the JAX package are
``test_torch_esekf.test_lio_scan_step``'s: state 1e-3, P rtol 2e-2,
``n_iters`` equal, ``n_effective`` within 3. The rows' normal equations
against the JAX closure: N after diagonal scaling and v over sqrt(N_ii sum
z^2) to 2e-2, the inliers within 3 (a near-collinear 5-point fit takes
another normal in float32 in the two libraries; see ``csrc/lio.cu``).
"""

import math

import numpy as np
import pytest
import torch

from tc2li_slam_tpu.estimation import esekf as jesekf
from tc2li_slam_tpu.ops import voxel_map as jvm
from tc2li_slam_tpu.slam import lio as jlio
from tc2li_slam_torch import interop
from tc2li_slam_torch.estimation import esekf as tesekf
from tc2li_slam_torch.ops.kernels import lio as klio
from tc2li_slam_torch.slam import lio as tlio
from test_torch_esekf import (NOISE, assert_state_close, j, jax_state, lio_fixture,
                              random_state, to_jax_filter)
from torch_parity import n, t

CFG = dict(blind=0.5, scan_voxel=0.4, map_voxel=0.4)
EMPTY = np.iinfo(np.int32).max


def _cfgs(**kw):
    c = dict(CFG, **kw)
    return tlio.LioConfig(**c), jlio.LioConfig(**c)


def _scan_points(f, data, cfg):
    """The update's points of lio_fixture's scan at the plain prediction."""
    scan, t_pts, valid, gyro, acc, dts, trel = (t(a) for a in data)
    fp, R_traj, p_traj = klio.predict_plain(f, gyro, acc, dts, tesekf.NoiseCfg.create(*NOISE))
    pts, pv = tlio.scan_points(fp, scan, t_pts, valid, trel, R_traj, p_traj, cfg)
    return fp, pts, pv


def _jax_normal_equations(m, pts, pv, x, jcfg, nc):
    z, H, ok = jlio.make_h_fn(m, j(n(pts)), j(n(pv)), jcfg)(jax_state(x))
    z, H, ok = (np.asarray(a, np.float64) for a in (z, H, ok))
    Hk = H[:, :nc] * ok[:, None]
    return H[:, :nc].T @ Hk, Hk.T @ z, int(ok.sum()), float(np.sum(z * z))


def _scaled(a, b, N_ref, zz=None):
    """max |a - b| after diagonal scaling by N_ref (for v: sqrt(N_ii zz))."""
    d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    dg = np.maximum(np.diag(N_ref), 1e-30)
    sc = np.sqrt(dg[:, None] * dg[None, :]) if zz is None else np.sqrt(np.maximum(dg * zz, 1e-30))
    return float((d / sc).max()) if d.size else 0.0


# --- plain versions against the JAX package -------------------------------------------

def test_predict_plain_padded_window(rng):
    """The prediction's plain version against the JAX ``predict`` on a window
    with padded slots between and after its live samples; ``esekf.predict``
    on the CPU is the plain version."""
    f = tesekf.Filter(random_state(rng, 0.2), tesekf.init_filter().P)
    N = 20
    gyro = rng.normal(0, 0.4, (N, 3)).astype(np.float32)
    acc = (rng.normal(0, 1.0, (N, 3)) + [0, 0, 9.81]).astype(np.float32)
    dts = np.where(np.arange(N) % 3 == 1, 0.0, 0.01).astype(np.float32)
    dts[15:] = 0.0
    noise = (0.01, 0.1, 1e-5, 1e-4)
    ref_f, ref_R, ref_p = jesekf.predict(to_jax_filter(f), j(gyro), j(acc), j(dts),
                                         jesekf.NoiseCfg.create(*noise))
    got_f, got_R, got_p = klio.predict_plain(f, t(gyro), t(acc), t(dts),
                                             tesekf.NoiseCfg.create(*noise))
    assert_state_close(got_f.x, ref_f.x, 2e-6, "predict_plain")
    np.testing.assert_allclose(n(got_f.P), n(ref_f.P), rtol=1e-4, atol=1e-9)
    np.testing.assert_allclose(n(got_R), n(ref_R), atol=2e-6)
    np.testing.assert_allclose(n(got_p), n(ref_p), atol=2e-6)
    via = tesekf.predict(f, t(gyro), t(acc), t(dts), tesekf.NoiseCfg.create(*noise))
    assert torch.equal(via[0].P, got_f.P) and torch.equal(via[1], got_R)


@pytest.mark.parametrize("ext", [False, True])
def test_rows_plain_normal_equations(ext):
    """One evaluation's normal equations (``rows_plain``, what a ``lio_rows``
    launch sums) against the JAX ``make_h_fn``'s H^T H and H^T z at the
    prediction, with the extrinsic columns off and on."""
    f, m, data, _ = lio_fixture()
    cfg, jcfg = _cfgs(estimate_extrinsic=ext)
    fp, pts, pv = _scan_points(f, data, cfg)
    x = fp.x._replace(R_LI=fp.x.R_LI @ tesekf.lie.so3_exp(t(np.array([0.01, -0.02, 0.015],
                                                                      np.float32))),
                      t_LI=t(np.array([0.05, -0.02, 0.1], np.float32)))
    nc = 12 if ext else 6
    r = klio.rows_plain(interop.voxelmap_from_numpy(m), pts, pv, x, cfg, with_slots=True)
    N, v, cnt, zz = _jax_normal_equations(m, pts, pv, x, jcfg, nc)
    assert r.N.shape == (nc, nc) and r.v.shape == (nc,) and r.slots.shape == (pts.shape[0], 5)
    assert cnt > 500 and abs(int(r.n_ok) - cnt) <= 3
    assert _scaled(n(r.N), N, N) < 2e-2
    assert _scaled(n(r.v), v, N, zz) < 2e-2
    if ext:
        assert np.abs(N[6:, 6:]).max() > 0
    # the slots are those of valid neighbours, -1 elsewhere
    sl = n(r.slots)
    assert np.all((sl >= -1) & (sl < m.capacity)) and np.any(sl >= 0)


def test_rows_plain_empty_map():
    """Against an empty map no point has a neighbour: no inlier, zero sums,
    and the scan step keeps the prediction's state as the JAX package does."""
    f, m, data, _ = lio_fixture()
    cfg, jcfg = _cfgs()
    m0 = jvm.create(m.capacity, 0.4)
    fp, pts, pv = _scan_points(f, data, cfg)
    r = klio.rows_plain(interop.voxelmap_from_numpy(m0), pts, pv, fp.x, cfg, with_slots=True)
    N, v, cnt, _ = _jax_normal_equations(m0, pts, pv, fp.x, jcfg, 6)
    assert int(r.n_ok) == cnt == 0 and not np.any(n(r.N)) and not np.any(N)
    assert np.all(n(r.slots) == -1)
    got = tlio.lio_scan_step(f, interop.voxelmap_from_numpy(m0), *[t(a) for a in data],
                             tesekf.NoiseCfg.create(*NOISE), cfg)
    ref = jlio.lio_scan_step(to_jax_filter(f), m0, *[j(a) for a in data],
                             jesekf.NoiseCfg.create(*NOISE), jcfg)
    assert int(got.n_iters) == int(ref.n_iters) and int(got.n_effective) == 0
    assert_state_close(got.filt.x, ref.filt.x, 1e-3, "empty map")
    np.testing.assert_allclose(n(got.filt.P), n(ref.filt.P), rtol=2e-2, atol=1e-8)


def test_rows_plain_nan_point():
    """A NaN point is no inlier and adds nothing non-finite to the sums;
    its slots are -1."""
    f, m, data, _ = lio_fixture()
    cfg, jcfg = _cfgs()
    fp, pts, pv = _scan_points(f, data, cfg)
    k = int(np.nonzero(n(pv))[0][7])
    pts = pts.clone()
    pts[k, 1] = float("nan")
    r = klio.rows_plain(interop.voxelmap_from_numpy(m), pts, pv, fp.x, cfg, with_slots=True)
    N, v, cnt, zz = _jax_normal_equations(m, pts, pv, fp.x, jcfg, 6)
    assert np.all(np.isfinite(n(r.N))) and np.all(np.isfinite(n(r.v)))
    assert np.all(n(r.slots)[k] == -1) and abs(int(r.n_ok) - cnt) <= 3
    assert _scaled(n(r.N), N, N) < 2e-2 and _scaled(n(r.v), v, N, zz) < 2e-2


# --- a float64 emulation of the kernels' structure ----------------------------------------

ERR, STATE = 23, 36
POS, ROT, EXT_R, EXT_T, VEL, BG, BA, GRAV = 0, 3, 12, 21, 24, 27, 30, 33   # in the state
EPS_LIE = 5e-3


def _hat(w):
    return np.array([[0.0, -w[2], w[1]], [w[2], 0.0, -w[0]], [-w[1], w[0], 0.0]])


def _coefs(th):
    small = abs(th) < EPS_LIE
    x2 = th * th
    sinc = 1 - x2 / 6 + x2 * x2 / 120 if small else math.sin(th) / th
    cosc = 0.5 - x2 / 24 + x2 * x2 / 720 if small else (1 - math.cos(th)) / (th * th)
    sinc3 = 1 / 6 - x2 / 120 + x2 * x2 / 5040 if small else (th - math.sin(th)) / th ** 3
    return sinc, cosc, sinc3


def _theta(w):
    return math.sqrt(max(float(w @ w), 1e-24))


def _exp(w):
    s, c, _ = _coefs(_theta(w))
    W = _hat(w)
    return np.eye(3) + s * W + c * W @ W


def _jr(w):
    _, c, s3 = _coefs(_theta(-w))
    W = _hat(-w)
    return np.eye(3) + c * W + s3 * W @ W


def _jr_inv(w):
    th = _theta(-w)
    W = _hat(-w)
    small = th < EPS_LIE
    ts = 1.0 if small else th
    cot = 1 / 12 + th ** 2 / 720 + th ** 4 / 30240 if small else \
        1 / ts ** 2 - math.sin(ts) / (2 * ts * (1 - math.cos(ts)))
    return np.eye(3) - 0.5 * W + cot * W @ W


def _log(R):
    c = min(max((np.trace(R) - 1) * 0.5, -1.0), 1.0)
    ws = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    s = 0.5 * math.sqrt(max(float(ws @ ws), 1e-24))
    th = math.atan2(s, c)
    if not th > math.pi - 1e-3:
        return 0.5 / _coefs(th)[0] * ws
    Rp = (R + np.eye(3)) * 0.5
    dg = np.maximum(np.diag(Rp), 0.0)
    ax = np.sqrt(dg)
    k = int(np.argmax(ax))
    row = Rp[k].copy()
    row[k] = dg[k]
    a = row / (1.0 if ax[k] < 1e-12 else ax[k])
    return a / max(np.linalg.norm(a), 1e-12) * th


def _s2_basis(g):
    k = int(np.argmin(np.abs(g)))
    b1 = np.cross(g, np.eye(3)[k])
    b1 = b1 / max(np.linalg.norm(b1), 1e-12)
    b2 = np.cross(g / max(np.linalg.norm(g), 1e-12), b1)
    return np.stack([b1, b2], -1)


def _s2_boxminus(g1, g0, dg1=()):
    """The value and its derivatives along the tangents dg1 of g1, each
    quantity carried with its derivative (forward-mode dual numbers)."""
    m0, m1 = max(np.linalg.norm(g0), 1e-12), np.linalg.norm(g1)
    m1c = max(m1, 1e-12)
    n0, n1 = g0 / m0, g1 / m1c
    cr = np.cross(n0, n1)
    c, s2 = float(n0 @ n1), float(cr @ cr)
    small = s2 < 1e-6
    ss = math.sqrt(1.0 if small else s2)
    at = math.atan2(ss, c)
    f = 1 + s2 / 6 if small else at / ss
    B0 = _s2_basis(g0)
    out, douts = B0.T @ (f * cr), []
    for dg in dg1:
        dm1 = 0.0 if m1 < 1e-12 else float(g1 @ dg) / m1
        dn1 = dg / m1c - g1 * dm1 / (m1c * m1c)
        dcr = np.cross(n0, dn1)
        dc, ds2 = float(n0 @ dn1), 2 * float(cr @ dcr)
        if small:
            df = ds2 / 6
        else:
            dss = ds2 / (2 * ss)
            dat = (c * dss - ss * dc) / (ss * ss + c * c)
            df = dat / ss - at * dss / (ss * ss)
        douts.append(B0.T @ (df * cr + f * dcr))
    return out, np.stack(douts, -1) if douts else None


def _blocks(i):
    return (21, 2) if i >= 21 else ((i // 3) * 3, 3)


ROWS_A = [0, 1, 2, 3, 4, 5, 12, 13, 14]   # F's rows that differ from the identity's
ROWS_B = [r for r in range(ERR) if r not in ROWS_A]


def emu_predict(xin, gyro, acc, dts, q, dtype=np.float64):
    """``predict_kernel`` in ``dtype``: each live sample's terms (phi, dRi,
    Jr, a) apart from the chain, the chain of R, p and v, and P a column at
    a time: G = F P's rows A on every column, then P_new = G F^T, symmetric:
    a column outside A is G's own, a column c in A is P_new's row c, G's
    row c outside A and F's rows A applied to G's row c inside."""
    f = lambda a: np.asarray(a, dtype)
    s, P = f(xin[:STATE]).copy(), f(xin[STATE:]).reshape(ERR, ERR).copy()
    grav, bg, ba = s[GRAV:GRAV + 3], s[BG:BG + 3], s[BA:BA + 3]
    gB = f(-_hat(grav) @ _s2_basis(grav))
    dts = f(dts)
    live = dts > 0
    # (a) a sample's terms that need no chain
    terms = {i: (f(_exp(f((f(gyro[i]) - bg) * dts[i]))), f(_jr(f((f(gyro[i]) - bg) * dts[i]))),
                 f(f(acc[i]) - ba)) for i in np.nonzero(live)[0]}
    R_traj, p_traj = [], []
    for i, dt in enumerate(dts):
        if live[i]:
            dRi, Jr, a = terms[i]
            R = s[ROT:ROT + 9].reshape(3, 3).copy()
            # (b) the chain and F's blocks that read R
            aw = R @ a + grav
            F = np.eye(ERR, dtype=dtype)
            F[0:3, 12:15] = np.eye(3, dtype=dtype) * dt
            F[3:6, 3:6] = dRi.T
            F[3:6, 15:18] = -Jr * dt
            F[12:15, 3:6] = -(R @ _hat(a).astype(dtype)) * dt
            F[12:15, 18:21] = -R * dt
            F[12:15, 21:23] = gB * dt
            # (c) G's rows A, then P_new column by column
            GA = F[ROWS_A] @ P                              # [9, 23]
            Pn = P.copy()
            Pn[ROWS_A] = GA                                 # the columns outside A
            Pn[np.ix_(ROWS_B, ROWS_A)] = GA[:, ROWS_B].T    # rows outside A of a column in A
            Pn[np.ix_(ROWS_A, ROWS_A)] = (GA @ F[ROWS_A].T).T   # entry (r, c): F[r] . G[c]
            Wr, Wv = -Jr * dt, -R * dt
            Pn[3:6, 3:6] += (Wr * q[0]) @ Wr.T
            Pn[12:15, 12:15] += (Wv * q[1]) @ Wv.T
            Pn[15:18, 15:18] += np.eye(3, dtype=dtype) * (dt * q[2] * dt)
            Pn[18:21, 18:21] += np.eye(3, dtype=dtype) * (dt * q[3] * dt)
            P = Pn
            s[POS:POS + 3] = s[POS:POS + 3] + s[VEL:VEL + 3] * dt + dtype(0.5) * aw * dt * dt
            s[VEL:VEL + 3] = s[VEL:VEL + 3] + aw * dt
            s[ROT:ROT + 9] = (R @ dRi).reshape(-1)
        R_traj.append(s[ROT:ROT + 9].reshape(3, 3).copy())
        p_traj.append(s[POS:POS + 3].copy())
    return (np.concatenate([s, P.reshape(-1)]), np.array(R_traj, dtype).reshape(-1, 3, 3),
            np.array(p_traj, dtype).reshape(-1, 3))


def _predict_window(rng, n_live, padded):
    """A filter and an IMU window of n_live samples at 100 Hz; ``padded``
    puts padding slots (dt 0, NaN acc) before, between and after them."""
    f = tesekf.Filter(random_state(rng, 0.2), tesekf.init_filter().P)
    gyro = rng.normal(0, 0.4, (n_live, 3)).astype(np.float32)
    acc = (rng.normal(0, 1.0, (n_live, 3)) + [0, 0, 9.81]).astype(np.float32)
    dts = np.full(n_live, 0.01, np.float32)
    if padded:
        slots = 3 * n_live + 5
        at = 1 + 3 * np.arange(n_live)
        g2, a2, d2 = (np.zeros((slots, 3), np.float32), np.full((slots, 3), np.nan, np.float32),
                      np.zeros(slots, np.float32))
        g2[at], a2[at], d2[at] = gyro, acc, dts
        d2[at[-1] + 1] = -0.01
        gyro, acc, dts = g2, a2, d2
    x0p = np.concatenate([n(klio.state_vector(f.x)), n(f.P).reshape(-1)]).astype(np.float32)
    return f, x0p, gyro, acc, dts


def _split(xp):
    return xp[:STATE], xp[STATE:].reshape(ERR, ERR)


def _jax_state_vector(x):
    return np.concatenate([np.asarray(getattr(x, k)).reshape(-1) for k in tesekf.State._fields])


@pytest.mark.parametrize("n_live,padded", [(1, False), (10, False), (40, False), (1, True),
                                           (10, True), (40, True)])
def test_emulated_predict_matches_jax(n_live, padded):
    """The kernel's order against the JAX ``predict``: in float64 (the JAX
    package under x64, the noise in float64) to 1e-10, and in float32 to
    ``chip_smoke.LIO_TOL`` (state and trajectory 1e-4, P after diagonal
    scaling 1e-4). Padded slots repeat the pose before them."""
    import jax
    import jax.numpy as jnp

    import chip_smoke
    rng = np.random.default_rng(100 * n_live + padded)
    f, x0p, gyro, acc, dts = _predict_window(rng, n_live, padded)
    noise = NOISE
    tol = chip_smoke.LIO_TOL
    for dtype in (np.float64, np.float32):
        q = [dtype(v) ** 2 for v in noise]
        xp, R_traj, p_traj = emu_predict(x0p, gyro, acc, dts, q, dtype)
        s, P = _split(xp)
        if dtype == np.float64:
            with jax.enable_x64(True):
                jf = jesekf.Filter(jesekf.State(**{k: jnp.asarray(np.asarray(v, np.float64)) for k, v
                                                   in interop.filter_to_numpy(f)["x"].items()}),
                                   jnp.asarray(np.asarray(n(f.P), np.float64)))
                rf, rR, rp = jesekf.predict(jf, *(jnp.asarray(np.asarray(a, np.float64))
                                                 for a in (gyro, acc, dts)),
                                            jesekf.NoiseCfg(*[jnp.float64(v) for v in noise]))
                assert rf.P.dtype == jnp.float64
            atol_s, atol_p = 1e-10, 1e-10
        else:
            rf, rR, rp = jesekf.predict(to_jax_filter(f), j(gyro), j(acc), j(dts),
                                        jesekf.NoiseCfg.create(*noise))
            atol_s, atol_p = tol["predict_state"], tol["predict_P"]
        rs, rP = _jax_state_vector(rf.x), np.asarray(rf.P, np.float64)
        np.testing.assert_allclose(s, rs, rtol=0, atol=atol_s)
        np.testing.assert_allclose(R_traj, np.asarray(rR), rtol=0, atol=atol_s)
        np.testing.assert_allclose(p_traj, np.asarray(rp), rtol=0, atol=atol_s)
        dg = np.sqrt(np.maximum(np.abs(np.diag(rP)), 1e-30))
        assert np.abs((np.asarray(P, np.float64) - rP) / (dg[:, None] * dg[None, :])).max() \
            < atol_p, dtype
    if padded:   # a padded slot repeats the pose before it, in the emulation as in the kernel
        live = np.nonzero(dts > 0)[0]
        assert np.array_equal(R_traj[live[0] + 1], R_traj[live[0]])


def _n_entries(nc):
    return nc * (nc + 1) // 2 + nc + 1


BATCH, MAX_BLOCKS, MAX_FENCES = 32, 256, 16384   # csrc/lio.cu kBatch, kRowsMaxBlocks, kMaxFences


def emu_rows_blocks(M):
    """``tc2li_lio_rows_blocks``: a function of M alone."""
    return max(1, min(MAX_BLOCKS, -(-M // BATCH)))


def emu_fence_log2(cap):
    lg = 5
    while -(-cap // (1 << lg)) > MAX_FENCES:
        lg += 1
    return lg


PREDICT_THREADS, FENCES_THREAD = 64, 4   # csrc/lio.cu kPredictThreads, kFencesThread


def emu_fence_blocks(keys):
    """The predict launch's fence blocks (``fence_blocks``): blocks 1 .. of
    its grid, a thread 4 consecutive fences and the next one's key; the
    table as they write it [nf + 1] (-1 where nothing wrote), the grid
    size, and how many threads wrote the count."""
    cap = keys.shape[0]
    lg = emu_fence_log2(cap)
    nf = -(-cap // (1 << lg))
    per_block = PREDICT_THREADS * FENCES_THREAD
    grid = 1 + -(-nf // per_block)
    table = np.full(nf + 1, -1, np.int64)
    writers = 0
    for b in range(grid - 1):
        for tid in range(PREDICT_THREADS):
            j0 = (b * PREDICT_THREADS + tid) * FENCES_THREAD
            if j0 >= nf:
                continue
            f = [keys[(j0 + q) << lg] if j0 + q < nf else EMPTY
                 for q in range(FENCES_THREAD + 1)]
            for q in range(FENCES_THREAD):
                if j0 + q < nf:
                    table[j0 + q] = f[q]
                    if f[q] != EMPTY and f[q + 1] == EMPTY:
                        table[nf] = j0 + q + 1
                        writers += 1
            if j0 == 0 and f[0] == EMPTY:
                table[nf] = 0
                writers += 1
    return table, grid, writers


def emu_fences(keys):
    """The fence table as ``rows_kernel`` reads it: (F = every 2^lg-th key,
    u = the fences below the first kEmpty one, lg), from the predict
    launch's fence blocks."""
    table, _, _ = emu_fence_blocks(keys)
    return table[:-1], int(table[-1]), emu_fence_log2(keys.shape[0])


def emu_lower_bound(keys, fences, key):
    """The kernel's lower_bound: a branchless search of the u fences (the
    same iterations for every key), then the keys below ``key`` in the
    fence's bucket of 2^lg keys."""
    F, u, lg = fences
    key = np.asarray(key, np.int64)
    cap = keys.shape[0]
    j = np.zeros(key.shape, np.int64)
    if u:
        base = np.zeros(key.shape, np.int64)
        n = u
        while n > 1:
            half = n >> 1
            base = np.where(F[base + half] < key, base + half, base)
            n -= half
        j = base + (F[base] < key)
    b = np.maximum(j - 1, 0) << lg
    idx = b[..., None] + np.arange(1 << lg)
    below = (idx < cap) & (keys[np.minimum(idx, cap - 1)] < key[..., None])
    return np.where(j > 0, b + below.sum(-1), 0)


def emu_nearest5(d2):
    """The 5 warp-wide minima of the candidates' 64-bit keys (d^2's bits,
    0 for -0 and one NaN after every number, then the candidate index):
    the candidate indices [M, 5] in order."""
    bits = np.where(np.isnan(d2), np.uint32(0x7fc00000),
                    np.where(d2 == 0, np.uint32(0), d2.astype(np.float32).view(np.uint32)))
    key = (bits.astype(np.uint64) << np.uint64(32)) | np.arange(d2.shape[-1], dtype=np.uint64)
    return np.sort(key, -1)[:, :5].astype(np.uint64) & np.uint64(0xffffffff)


def emu_rows(keys, mpts, origin, vs, pl, valid, x32, thr, nc, last=False):
    """``rows_kernel``: the blocks' partial sums [E, B] (or, ``last``, p_w
    and the inliers), the neighbours' slots [M, 5]."""
    f32 = np.float32
    pl = pl.astype(f32)
    M, cap = pl.shape[0], keys.shape[0]
    R, RLI = x32[ROT:ROT + 9].reshape(3, 3), x32[EXT_R:EXT_R + 9].reshape(3, 3)
    pb = (pl @ RLI.T + x32[EXT_T:EXT_T + 3]).astype(f32)
    pw = (pb @ R.T + x32[POS:POS + 3]).astype(f32)
    with np.errstate(invalid="ignore"):
        live = valid & np.all(np.isfinite(pw), -1)
        qv = np.clip(np.floor(((pw - origin) / f32(vs)).astype(f32)), -4, 1028)
    qv = np.where(live[:, None], qv, 0).astype(np.int64)
    lane = np.arange(25)
    cx = qv[:, 0, None] + lane // 5 - 2
    cy = qv[:, 1, None] + lane % 5 - 2
    zlo = np.clip(qv[:, 2] - 2, 0, 1023)[:, None]
    zhi = np.clip(qv[:, 2] + 2, 0, 1023)[:, None]
    in_grid = (cx >= 0) & (cx < 1024) & (cy >= 0) & (cy < 1024)
    key_lo = (cx << 20) | (cy << 10) | zlo
    key_hi = key_lo + (zhi - zlo)
    pos0 = emu_lower_bound(keys, emu_fences(keys), np.where(in_grid, key_lo, 0))
    slot = np.minimum(pos0[..., None] + np.arange(5), cap - 1).reshape(M, 125)
    kk = keys[slot]
    cv = (np.repeat(in_grid, 5, -1) & (kk >= np.repeat(key_lo, 5, -1))
          & (kk <= np.repeat(key_hi, 5, -1)) & (kk != EMPTY))
    dd = (mpts[slot] - pw[:, None]).astype(f32)
    d2 = ((dd[..., 0] * dd[..., 0] + dd[..., 1] * dd[..., 1]) + dd[..., 2] * dd[..., 2])
    d2 = np.where(cv, d2, np.inf).astype(f32)
    sel = emu_nearest5(d2).astype(np.int64)                # (d2, candidate index)
    sv = np.take_along_axis(cv, sel, -1) & live[:, None]
    sslot = np.take_along_axis(slot, sel, -1)
    slots = np.where(sv, sslot, -1)
    d0 = np.sqrt(np.maximum(np.take_along_axis(d2, sel[:, :1], -1)[:, 0], 0)).astype(f32)
    # the plane fit, the gate and the row in float64
    w = sv.astype(np.float64)
    nb = np.where(sv[..., None], mpts[sslot].astype(np.float64), 0.0)
    cnt = np.maximum(w.sum(-1), 1.0)
    mu = (nb * w[..., None]).sum(1) / cnt[:, None]
    cen = (nb - mu[:, None]) * w[..., None]
    A = np.einsum("qki,qkj->qij", cen, cen) / cnt[:, None, None] + 1e-12 * np.eye(3)
    q = np.trace(A, axis1=1, axis2=2) / 3
    Aq = A - q[:, None, None] * np.eye(3)
    p = np.sqrt(np.maximum((Aq * Aq).sum((1, 2)) / 6, 1e-30))
    r = np.clip(np.linalg.det(Aq / p[:, None, None]) / 2, -1, 1)
    lam = q + 2 * p * np.cos(np.arccos(r) / 3 + 2 * np.pi / 3)
    Mm = A - lam[:, None, None] * np.eye(3)
    cs = np.stack([np.cross(Mm[:, 0], Mm[:, 1]), np.cross(Mm[:, 0], Mm[:, 2]),
                   np.cross(Mm[:, 1], Mm[:, 2])], 1)
    nn = (cs * cs).sum(-1)
    best = np.where(((nn[:, 0] >= nn[:, 1]) & (nn[:, 0] >= nn[:, 2]))[:, None], cs[:, 0],
                    np.where((nn[:, 1] >= nn[:, 2])[:, None], cs[:, 1], cs[:, 2]))
    nrm = np.linalg.norm(best, axis=-1)
    with np.errstate(invalid="ignore", divide="ignore"):
        nv = np.where((nrm > 1e-20)[:, None], best / nrm[:, None], [0.0, 0.0, 1.0])
        d = -(nv * mu).sum(-1)
        fin = np.all(np.isfinite(nv), -1) & np.isfinite(d)
        nv, d = np.where(fin[:, None], nv, 0.0), np.where(fin, d, 0.0)
        res = np.abs((nb * nv[:, None]).sum(-1) + d[:, None])
        plane_ok = np.all(~sv | (res < thr), -1) & (sv.sum(-1) >= 3) & fin
        pd = (pw.astype(np.float64) * nv).sum(-1) + d
        gate = np.sqrt(np.maximum(np.linalg.norm(pl.astype(np.float64), axis=-1), 1e-6))
        ok = live & plane_ok & (1 - 0.9 * np.abs(pd) / gate > 0.9) & (d0 < 5)
    if last:
        return pw, int(ok.sum()), slots
    Rn = nv @ R.astype(np.float64)
    H = np.zeros((M, 12))
    H[:, 0:3] = nv
    H[:, 3:6] = np.cross(pb.astype(np.float64), Rn)
    if nc == 12:
        H[:, 6:9] = np.cross(pl.astype(np.float64), Rn @ RLI.astype(np.float64))
        H[:, 9:12] = Rn
    H = np.where(ok[:, None] & np.isfinite(H), H, 0.0)[:, :nc]
    z = np.where(ok & np.isfinite(pd), pd, 0.0)
    iu = np.triu_indices(nc)
    terms = np.concatenate([(H[:, :, None] * H[:, None, :])[:, iu[0], iu[1]], H * z[:, None],
                            ok[:, None].astype(np.float64)], -1)        # [M, E]
    B = emu_rows_blocks(M)
    part = np.zeros((terms.shape[1], B))
    for b in range(B):                            # warp 0's lanes, an entry each
        acc = np.zeros(terms.shape[1])
        for b0 in range(b * BATCH, M, B * BATCH):     # the block's batches in order
            for q in range(b0, min(b0 + BATCH, M)):   # a batch's inliers in order
                if ok[q]:
                    acc = acc + terms[q]
        part[:, b] = acc
    return part, slots


def emu_reduce(part):
    """``step_kernel``'s sum of the blocks' entry-major partials [E, B]:
    lane l adds blocks l, l + 32, ... in four interleaved accumulators, then
    a xor tree."""
    part = part.T
    B, E = part.shape
    lanes = np.zeros((32, E))
    for lane in range(32):
        a4 = np.zeros((4, E))
        b = lane
        while b + 96 < B:
            for u in range(4):
                a4[u] += part[b + 32 * u]
            b += 128
        u = 0
        while b < B:
            a4[u] += part[b]
            b += 32
            u += 1
        lanes[lane] = (a4[0] + a4[1]) + (a4[2] + a4[3])
    for off in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[np.arange(32) ^ off]
    return lanes[0]


def emu_pivot(col, pos, c):
    """The pivot search of ``block_gauss_jordan``: lanes hold |a_c| of their
    row at position ``pos`` as its bits (ordered as the values), a NaN at
    position c as +inf and elsewhere as 0; a xor tree of maxima over 32
    lanes, then the lowest position among the candidates (positions >= c)
    holding the maximum. Returns the pivot's position."""
    n = col.shape[0]
    with np.errstate(invalid="ignore"):
        a = np.abs(np.asarray(col, np.float64))
    bits = a.view(np.uint64)
    key = np.where(np.isnan(a), np.where(pos == c, np.uint64(0x7ff0000000000000), np.uint64(0)),
                   bits)
    cand = pos >= c
    lanes = np.zeros(32, np.uint64)
    lanes[:n] = np.where(cand, key, np.uint64(0))
    for off in (16, 8, 4, 2, 1):
        lanes = np.maximum(lanes, lanes[np.arange(32) ^ off])
    assert np.all(lanes == lanes[0])
    return int(np.min(np.where(cand & (key == lanes[0]), pos, 64)))


def emu_gauss_jordan(M):
    """``block_gauss_jordan``: row r stays in place, its position swaps with
    the pivot's; the pivot row's copy is scaled by its inverse in every
    update."""
    n = M.shape[0]
    a = np.concatenate([M, np.eye(n)], 1)
    pos = np.arange(n)
    for c in range(n):
        p = emu_pivot(a[:, c], pos, c)
        piv = int(np.nonzero(pos == p)[0][0])
        pos[pos == c] = p
        pos[piv] = c
        bc = a[piv].copy()
        inv = 1.0 / bc[c]
        for r in range(n):
            if r == piv:
                a[r, c + 1:] *= inv
            else:
                a[r, c + 1:] -= a[r, c] * (bc[c + 1:] * inv)
    out = np.zeros((n, n))
    out[pos] = a[:, n:]
    return out


def emu_tangent(x, x0):
    """boxminus(x, x0) and the transport Jacobian L [23, 23]."""
    dx0, L = np.zeros(ERR), np.eye(ERR)
    for o, e in ((ROT, 3), (EXT_R, 6)):
        w = _log(x0[o:o + 9].reshape(3, 3).T @ x[o:o + 9].reshape(3, 3))
        dx0[e:e + 3] = w
        L[e:e + 3, e:e + 3] = _jr_inv(w)
    g, g0 = x[GRAV:GRAV + 3], x0[GRAV:GRAV + 3]
    B = _s2_basis(g)
    out, J = _s2_boxminus(g, g0, [np.cross(B[:, k], g) for k in range(2)])
    dx0[21:23], L[21:23, 21:23] = out, J
    for e, o in ((0, POS), (9, EXT_T), (12, VEL), (15, BG), (18, BA)):
        dx0[e:e + 3] = x[o:o + 3] - x0[o:o + 3]
    return dx0, L


def emu_boxplus(x, d):
    x = x.copy()
    for e, o in ((0, POS), (9, EXT_T), (12, VEL), (15, BG), (18, BA)):
        x[o:o + 3] += d[e:e + 3]
    for e, o in ((3, ROT), (6, EXT_R)):
        x[o:o + 9] = (x[o:o + 9].reshape(3, 3) @ _exp(d[e:e + 3])).reshape(-1)
    g = x[GRAV:GRAV + 3]
    x[GRAV:GRAV + 3] = _exp(_s2_basis(g) @ d[21:23]) @ g
    return x


def emu_normal(s, nc, r_inv):
    T = nc * (nc + 1) // 2
    N = np.zeros((ERR, ERR))
    iu = np.triu_indices(nc)
    N[iu[0], iu[1]] = s[:T]
    N[iu[1], iu[0]] = s[:T]
    v = np.zeros(ERR)
    v[:nc] = s[T:T + nc]
    return N * r_inv, v * r_inv


def emu_step(part, nc, r_inv, x, x0, Pinv, conv, iters, eps=1e-3):
    """A non-final ``step_kernel`` launch."""
    N, v = emu_normal(emu_reduce(part), nc, r_inv)
    dx0, L = emu_tangent(x, x0)
    A = N + L.T @ Pinv @ L
    b = -(v + L.T @ (Pinv @ dx0))
    Lc = np.tril(A).copy()                        # Cholesky, a column a pass
    inv = np.zeros(ERR)
    for c in range(ERR):
        Lc[c, c] = math.sqrt(Lc[c, c])
        inv[c] = 1.0 / Lc[c, c]
        Lc[c + 1:, c] *= inv[c]
        for i in range(c + 1, ERR):
            Lc[i, c + 1:i + 1] -= Lc[i, c] * Lc[c + 1:i + 1, c]
    v = b.copy()                                  # L y = b, a column a step
    for j in range(ERR):
        v[j] *= inv[j]
        v[j + 1:] -= Lc[j + 1:, j] * v[j]
    for j in reversed(range(ERR)):                # L^T delta = y, from the last row up
        v[j] *= inv[j]
        v[:j] -= Lc[j, :j] * v[j]
    delta = v
    if not conv:
        x = emu_boxplus(x, delta)
        iters += 1
    return x, conv or bool(np.all(np.abs(delta) < eps)), iters


def emu_scan_update(xp, x0p, keys, mpts, origin, vs, pl, valid, cfg):
    """The update's 2 k + 3 launches: (filter [565] float32, n_iters, bad,
    p_w, n_effective)."""
    nc = 12 if cfg.estimate_extrinsic else 6
    r_inv = 1.0 / cfg.meas_cov
    x0 = xp[:STATE].astype(np.float64)
    Pinv = emu_gauss_jordan(xp[STATE:].astype(np.float64).reshape(ERR, ERR) + 1e-9 * np.eye(ERR))
    x, conv, iters = x0.copy(), False, 0
    for _ in range(cfg.max_iters):
        part, _ = emu_rows(keys, mpts, origin, vs, pl, valid, x.astype(np.float32),
                           cfg.plane_thresh, nc)
        x, conv, iters = emu_step(part, nc, r_inv, x, x0, Pinv, conv, iters)
    part, _ = emu_rows(keys, mpts, origin, vs, pl, valid, x.astype(np.float32),
                       cfg.plane_thresh, nc)
    N, _ = emu_normal(emu_reduce(part), nc, r_inv)
    x = x.astype(np.float32).astype(np.float64)   # the tangent of the state as written
    _, L = emu_tangent(x, x0)
    P = emu_gauss_jordan(N + L.T @ Pinv @ L)
    P32, x32 = (0.5 * (P + P.T)).astype(np.float32), x.astype(np.float32)
    tested = np.concatenate([x32[:EXT_R], x32[VEL:], P32.reshape(-1)])
    with np.errstate(over="ignore", invalid="ignore"):
        bad = not np.all(np.isfinite(tested)) or \
            float((x32[VEL:VEL + 3] * x32[VEL:VEL + 3]).sum(dtype=np.float32)) > 3600
    out = x0p.copy() if bad else np.concatenate([x32, P32.reshape(-1)])
    pw, n_eff, _ = emu_rows(keys, mpts, origin, vs, pl, valid, out[:STATE], cfg.plane_thresh, nc,
                            last=True)
    return out, iters, bad, pw, n_eff


def emu_scan_step(f, m, data, cfg):
    """The emulated kernels in ``lio_scan_step``'s order, the eager parts
    (undistortion, downsample, insert) by the port's plain code."""
    scan, t_pts, valid, gyro, acc, dts, trel = data
    nz = tesekf.NoiseCfg.create(*NOISE)
    x0p = np.concatenate([n(klio.state_vector(f.x)), n(f.P).reshape(-1)]).astype(np.float32)
    xp, R_traj, p_traj = emu_predict(x0p.astype(np.float64), gyro.astype(np.float64),
                                     acc.astype(np.float64), dts.astype(np.float64),
                                     [nz.gyr ** 2, nz.acc ** 2, nz.bg_rw ** 2, nz.ba_rw ** 2])
    xp = xp.astype(np.float32)
    fp = klio.unpack(t(xp))
    pts, pv = tlio.scan_points(fp, t(scan), t(t_pts), t(valid), t(trel),
                               t(R_traj.astype(np.float32)), t(p_traj.astype(np.float32)), cfg)
    out, iters, bad, pw, n_eff = emu_scan_update(
        xp, x0p, np.asarray(m.keys), np.asarray(m.points), np.asarray(m.origin),
        np.float32(m.voxel_size), n(pts), n(pv), cfg)
    return klio.unpack(t(out)), iters, bad, pw, n_eff, n(pv), n(pts).astype(np.float64)


def _in_basis_of(P, g, g_ref):
    """P of the error tangent at gravity g, with its S2 block moved to the
    tangent basis of g_ref: the basis B(g) takes its seed from the smallest
    |g_i|, which rounding decides where gravity lies on an axis (this
    fixture's), so two libraries may express the same P in bases 90 degrees
    apart."""
    T = np.eye(ERR)
    T[21:23, 21:23] = _s2_basis(np.asarray(g_ref, np.float64)).T @ _s2_basis(np.asarray(g, np.float64))
    return T @ np.asarray(P, np.float64) @ T.T


@pytest.mark.parametrize("case", ["whole scan", "work_cap 512", "extrinsic"])
def test_emulation_matches_jax_scan_step(case):
    f, m, data, p_true = lio_fixture()
    kw = {"work_cap 512": dict(work_cap=512), "extrinsic": dict(estimate_extrinsic=True)}
    cfg, jcfg = _cfgs(max_iters=4, **kw.get(case, {}))
    filt, iters, bad, pw, n_eff, pv, pts_l = emu_scan_step(f, m, data, cfg)
    ref = jlio.lio_scan_step(to_jax_filter(f), m, *[j(a) for a in data],
                             jesekf.NoiseCfg.create(*NOISE), jcfg)
    assert not bad and not bool(ref.bad)
    assert iters == int(ref.n_iters)
    assert_state_close(filt.x, ref.filt.x, 1e-3, f"emulation {case}")
    np.testing.assert_allclose(_in_basis_of(n(filt.P), n(filt.x.grav), np.asarray(ref.filt.x.grav)),
                               n(ref.filt.P), rtol=2e-2, atol=1e-8)
    assert abs(n_eff - int(ref.n_effective)) <= 3
    # p_w of the last evaluation is the update's points at the state written
    xs = n(klio.state_vector(filt.x)).astype(np.float64)
    pb = pts_l @ xs[EXT_R:EXT_R + 9].reshape(3, 3).T + xs[EXT_T:EXT_T + 3]
    np.testing.assert_allclose(pw[pv], (pb @ xs[ROT:ROT + 9].reshape(3, 3).T + xs[:3])[pv],
                               atol=1e-4)
    assert np.linalg.norm(n(filt.x.pos) - p_true) < 0.1


def test_emulation_bad_imu_reverts():
    """A NaN accel sample: the emulated guard reverts to the filter before
    the scan, bit for bit, as the JAX package does."""
    f, m, data, _ = lio_fixture()
    data = list(data)
    data[4] = data[4].copy()
    data[4][3] = np.nan
    cfg, jcfg = _cfgs()
    filt, iters, bad, _, n_eff, _, _ = emu_scan_step(f, m, tuple(data), cfg)
    ref = jlio.lio_scan_step(to_jax_filter(f), m, *[j(a) for a in data],
                             jesekf.NoiseCfg.create(*NOISE), jcfg)
    assert bad and bool(ref.bad) and iters == int(ref.n_iters) and n_eff == int(ref.n_effective)
    assert torch.equal(filt.P, f.P) and all(torch.equal(a, b) for a, b in zip(filt.x, f.x))


@pytest.mark.parametrize("case", ["same", "small", "large", "near pi"])
def test_emulated_step_matches_float64_map_step(rng, case):
    """One emulated step (the closed blocks, the dual-number S2 block, the
    Cholesky solve) against ``esekf.map_step`` in float64 on the same normal
    equations: the transport Jacobian to 1e-9, the next iterate to 1e-9."""
    x0 = random_state(rng, 0.3)
    dx = {"same": np.zeros(23), "small": rng.normal(size=23) * 1e-3,
          "large": rng.normal(size=23) * 0.1, "near pi": rng.normal(size=23) * 0.05}[case]
    if case in ("large", "near pi"):
        dx[3:6], dx[6:9], dx[21:23] = [0.5, -0.4, 0.3], [-0.3, 0.2, 0.25], [0.2, -0.15]
    if case == "near pi":
        dx[3:6] = np.array([0.0, 0.0, math.pi - 3e-4])
    x64 = lambda x: tesekf.State(*[a.double() for a in x])
    xa, xb = x64(x0), x64(tesekf.boxplus(x64(x0), t(dx, torch.float64)))
    va, vb = (np.asarray(n(klio.state_vector(x)), np.float64) for x in (xa, xb))
    _, L = emu_tangent(vb, va)
    np.testing.assert_allclose(L, n(tesekf.transport_jacobian(xb, xa)), atol=1e-9)
    Hm = rng.normal(size=(40, 6))
    part = np.concatenate([(Hm.T @ Hm)[np.triu_indices(6)], Hm.T @ rng.normal(0, 0.01, 40),
                           [40.0]])[:, None]   # one block's entry-major partials
    P0 = np.diag(rng.uniform(1e-5, 1e-3, 23))
    Pinv = emu_gauss_jordan(P0 + 1e-9 * np.eye(23))
    got, conv, iters = emu_step(part, 6, 1e3, vb, va, Pinv, False, 0)
    N, v = emu_normal(emu_reduce(part), 6, 1e3)
    ref, _, rit = tesekf.map_step(t(N, torch.float64), t(v, torch.float64), xb, xa,
                                  t(Pinv, torch.float64), torch.tensor(False),
                                  torch.tensor(0, dtype=torch.int32))
    np.testing.assert_allclose(got, n(klio.state_vector(ref)), atol=1e-9)
    assert iters == int(rit) == 1


# --- the two-level key search and the warp's pivot choice -------------------------------

def _pool(case, rng):
    """Sorted int32 pool keys with kEmpty padding, and the probe keys."""
    if case == "duplicates across a fence":
        real = np.sort(np.repeat(rng.integers(0, 1 << 30, 150), 7)[:1000])
        real[28:40] = real[28]                     # a run over the fence at 32
        real[60:200] = real[60]                    # longer than a bucket
        cap = 1 << 12
    elif case == "kEmpty padding":
        real, cap = np.sort(rng.integers(0, 1 << 30, 333)), 1 << 12
    elif case == "below the first and above the last":
        real, cap = np.sort(rng.integers(1 << 20, 1 << 29, 64 * 5)), 64 * 5
    elif case == "capacity not a multiple of the stride":
        real, cap = np.sort(rng.integers(0, 1 << 30, 1001)), 1013
    elif case == "a full pool":
        real, cap = np.sort(rng.integers(0, 1 << 30, 1 << 12)), 1 << 12
    elif case == "a fence stride above 32":
        real, cap = np.sort(rng.integers(0, 1 << 30, 40_000)), MAX_FENCES * 32 + 5
    else:                                          # an empty pool
        real, cap = np.zeros(0, np.int64), 1 << 12
    keys = np.full(cap, EMPTY, np.int64)
    keys[:real.shape[0]] = real
    probes = np.concatenate([
        keys[rng.integers(0, cap, 200)], keys[rng.integers(0, cap, 200)] + 1,
        keys[rng.integers(0, cap, 200)] - 1, rng.integers(0, 1 << 30, 200),
        [np.iinfo(np.int32).min, -1, 0, 1, EMPTY - 1, EMPTY, (1 << 30) - 1],
        [keys[0] - 1, keys[0], keys[min(real.shape[0], cap) - 1] + 1]])
    return keys.astype(np.int32).astype(np.int64), np.clip(probes, np.iinfo(np.int32).min, EMPTY)


@pytest.mark.parametrize("case", ["duplicates across a fence", "kEmpty padding",
                                  "below the first and above the last",
                                  "capacity not a multiple of the stride", "a full pool",
                                  "a fence stride above 32", "an empty pool"])
def test_fence_search_equals_searchsorted(case):
    """``rows_kernel``'s lower_bound (the fence table, then one bucket)
    against ``torch.searchsorted`` on the same keys, for every probe."""
    keys, probes = _pool(case, np.random.default_rng(3))
    fences = emu_fences(keys)
    got = emu_lower_bound(keys, fences, probes)
    want = torch.searchsorted(torch.as_tensor(keys), torch.as_tensor(probes)).numpy()
    np.testing.assert_array_equal(got, want)
    F, u, lg = fences
    assert F.shape[0] <= MAX_FENCES and F.shape[0] == -(-keys.shape[0] // (1 << lg))
    assert u == int((F != EMPTY).sum()) and (lg > 5) == (case == "a fence stride above 32")


@pytest.mark.parametrize("case", ["2^19 + 1,000 slots", "2^19 slots", "an empty pool",
                                  "a full pool", "capacity not a multiple of the stride",
                                  "duplicates across a fence"])
def test_fence_blocks_of_the_predict_launch(case):
    """The fence table as the predict launch's blocks after its first write
    it (a thread 4 fences): every entry written once, equal to
    ``fences_plain``, the count by exactly one thread; 64 fence blocks at
    2^19 slots, 33 at 2^19 + 1,000 (a fence every 64 keys)."""
    rng = np.random.default_rng(4)
    if case == "2^19 + 1,000 slots":
        cap, n = (1 << 19) + 1000, 300_000
    elif case == "2^19 slots":
        cap, n = 1 << 19, 200_001
    elif case == "an empty pool":
        cap, n = 1 << 19, 0
    elif case == "a full pool":
        cap, n = (1 << 19) + 1000, (1 << 19) + 1000
    else:
        keys, _ = _pool(case, rng)
        cap, n = keys.shape[0], None
    if n is not None:
        keys = np.full(cap, EMPTY, np.int64)
        keys[:n] = np.sort(rng.integers(0, 1 << 30, n))
    table, grid, writers = emu_fence_blocks(keys)
    lg = emu_fence_log2(cap)
    want = klio.fences_plain(torch.as_tensor(keys.astype(np.int32)), lg).numpy()
    np.testing.assert_array_equal(table, want)
    assert writers == 1 and grid == 1 + -(-(want.shape[0] - 1) // 256)
    if cap >= 1 << 19:
        assert (grid, lg) == ((34, 6) if cap > 1 << 19 else (65, 5))
    assert table[-1] == {"an empty pool": 0, "a full pool": want.shape[0] - 1}.get(
        case, int((want[:-1] != EMPTY).sum()))


def _serial_pivot(col, c):
    """The serial pivot search of a one-thread Gauss-Jordan: rows c..n-1 in
    order, replaced only on a larger |value|."""
    p, best = c, abs(col[c])
    for r in range(c + 1, col.shape[0]):
        if abs(col[r]) > best:
            best, p = abs(col[r]), r
    return p


@pytest.mark.parametrize("case", ["tied rows", "tied with position c", "a NaN at position c",
                                  "a NaN below", "infinite entries", "random"])
def test_warp_argmax_pivot_matches_serial_scan(case, rng):
    """The warp argmax picks the serial scan's pivot: the lowest row on ties,
    a NaN at position c keeps it, a NaN elsewhere never wins."""
    for c in (0, 5, 21, 22):
        col = rng.normal(size=23)
        if case == "tied rows":
            col[c + 1:] = 2.0
            col[c] = 1.0
            col[-1] = -2.0
        elif case == "tied with position c":
            col[c:] = -3.0
        elif case == "a NaN at position c":
            col[c] = np.nan
            col[-1] = 1e9
        elif case == "a NaN below":
            col[c + 1:] = np.nan
            col[c] = 0.0
        elif case == "infinite entries":
            col[c:] = [np.inf if k % 2 else -np.inf for k in range(23 - c)]
        # positions are the serial elimination's row order: the identity here
        assert emu_pivot(col, np.arange(23), c) == _serial_pivot(col, c)
        # the same rows on other lanes: the choice follows positions, not lanes
        perm = rng.permutation(23)                 # row r on lane perm[r], at position r
        lanes, pos = np.empty(23), np.empty(23, np.int64)
        lanes[perm], pos[perm] = col, np.arange(23)
        assert emu_pivot(lanes, pos, c) == _serial_pivot(col, c)


@pytest.mark.parametrize("n_tied", [0, 4])
def test_emulated_gauss_jordan_is_the_inverse(rng, n_tied):
    """The warp Gauss-Jordan (positions swapped, not rows) inverts P0 + 1e-9
    I and a general matrix with tied pivot candidates to 1e-12."""
    X = rng.normal(size=(23, 23))
    P = X @ X.T * 1e-4 + 1e-9 * np.eye(23)
    Mg = rng.normal(size=(23, 23))
    Mg[:n_tied, 0] = 5.0
    for Mx in (P, Mg):
        inv = emu_gauss_jordan(Mx)
        np.testing.assert_allclose(inv @ Mx, np.eye(23), atol=1e-12 * np.abs(Mx).max() * np.abs(inv).max())
