"""Parity: the window bundle adjustment of tc2li_slam_torch (``solver/lm.local_ba``
and ``solver/balm.quadratic``; on the CPU the plain versions of
``ops/kernels/local_ba.py`` and ``ops/kernels/balm.py``) against
tc2li_slam_tpu's jit-compiled ``solver/lm.local_ba`` and ``solver/balm.quadratic``,
on the inputs of ``chip_smoke.ba_problem`` and ``chip_smoke.balm_case``; a
float32 emulation of ``csrc/balm.cu``'s derivative chain against
``jax.hessian``; and the dispatch by device. ``tests/test_torch_kernels_cuda.py``
holds the kernels to the plain versions on the same cases on a card."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from tc2li_slam_tpu.geom import camera as jcam
from tc2li_slam_tpu.slam import local_mapping as jlm
from tc2li_slam_tpu.solver import balm as jbalm, lm as jlmo
from tc2li_slam_torch.ops.kernels import balm as kbalm, local_ba as klba
from tc2li_slam_torch.solver import balm as tbalm, lm as tlmo
from torch_parity import n, t

# Iterated float32 solvers in two libraries (other summation orders in the
# normal equations), as tests/test_torch_mapping.py: poses to 1e-4,
# landmarks to 1e-3 m, costs to 1e-4 relative. Second derivatives through
# the closed-form smallest eigenvalue in float32: H and g to 1e-3 of their
# largest entry, the cost to 1e-3 relative.
POSE_ATOL, LM_ATOL, COST_RTOL = 1e-4, 1e-3, 1e-4
QUAD_REL = 1e-3


def _jax_clusters(b):
    c = jbalm.build_clusters(jnp.asarray(b["points"]), jnp.asarray(b["valid"]),
                             jnp.asarray(b["T_build"]), voxel_size=1.0, max_voxels=256,
                             min_points=15)
    return c._replace(valid=c.valid & ~jnp.asarray(b["kill"]))


def _jax_ba(p, clusters=None):
    cam = jcam.Pinhole.create(*chip_smoke.BA_CAM[:4], bf=chip_smoke.BA_CAM[4],
                              width=chip_smoke.BA_CAM[5], height=chip_smoke.BA_CAM[6])
    obs = jlmo.BAObservations(*(jnp.asarray(p[k]) for k in (
        "pose_idx", "uv", "inv_sigma2", "stereo", "valid")))
    extra = None
    if clusters is not None:
        extra = jax.tree_util.Partial(
            jlm._balm_extra, clusters=clusters, pos_in_win=jnp.asarray(p["pos_in_win"]),
            lvalid=jnp.asarray(p["lvalid"]), T_cl=jnp.asarray(p["T_cl"]),
            w_lba=jnp.asarray(p["w_lba"], jnp.float32))
    return jlmo.local_ba(cam, jnp.asarray(p["T0"]), jnp.asarray(p["X0"]), obs,
                         jnp.asarray(p["fixed"]), jnp.asarray(p["valid_lm"]),
                         iters=p["iters"], extra_fn=extra)


@pytest.mark.parametrize("case", chip_smoke.BA_CASES)
def test_local_ba_matches_reference(case):
    p = chip_smoke.ba_problem(np.random.default_rng(3), case)
    cj = ct = None
    if case == "balm":
        T0 = jnp.asarray(p["T0"])
        cj = jbalm.build_clusters(jnp.asarray(p["points"]), jnp.asarray(p["points_valid"]),
                                  jnp.linalg.inv(T0), voxel_size=1.0, max_voxels=256,
                                  min_points=15)
        assert int(cj.valid.sum()) > 20
        # both packages from the JAX clusters: only the solver differs
        ct = tbalm.VoxelClusters(*(t(np.asarray(a)) for a in cj))
    rj = _jax_ba(p, cj)
    args, kw = chip_smoke.ba_torch(torch, p, "cpu", ct)
    rt = tlmo.local_ba(*args, **kw)
    assert rt.T_cw.dtype == torch.float32 and rt.cost.shape == ()
    np.testing.assert_allclose(n(rt.T_cw), np.asarray(rj.T_cw), atol=POSE_ATOL)
    np.testing.assert_allclose(n(rt.X_w), np.asarray(rj.X_w), atol=LM_ATOL)
    np.testing.assert_allclose(float(rt.cost), float(rj.cost), rtol=COST_RTOL)
    moved = np.abs(n(rt.T_cw) - p["T0"]).max()
    if case in ("visual", "balm", "global_p64"):
        assert moved > 1e-4 and float(rt.cost) < float(_jax_ba({**p, "iters": 0}, cj).cost)
    if case == "all_fixed":
        assert moved == 0.0 and np.abs(n(rt.X_w) - p["X0"]).max() > 1e-3
    if case == "no_valid_landmark":
        assert np.array_equal(n(rt.X_w), p["X0"]) and moved > 1e-4
    if case == "global_p64":
        assert np.array_equal(n(rt.T_cw)[8:], p["T0"][8:])
    if case == "masked_nan":
        # the reference's defect, reproduced: the masked NaN landmark enters
        # every cost through 0 * NaN, no step is accepted
        assert np.isnan(float(rt.cost)) and np.isnan(float(rj.cost))
        assert np.array_equal(n(rt.T_cw), p["T0"])


@pytest.mark.parametrize("case", chip_smoke.BALM_CASES)
def test_quadratic_matches_reference(case):
    b = chip_smoke.balm_case(np.random.default_rng(4), case)
    cj = _jax_clusters(b)
    ct = tbalm.VoxelClusters(*(t(np.asarray(a)) for a in cj))
    qj = jbalm.quadratic(cj, jnp.asarray(b["T_eval"]))
    qt = tbalm.quadratic(ct, t(b["T_eval"]))
    if case == "all_invalid":
        assert not np.asarray(qj.H).any() and float(qt.cost) == 0.0
        assert not n(qt.H).any() and not n(qt.g).any()
        return
    scale_h, scale_g = np.abs(np.asarray(qj.H)).max(), np.abs(np.asarray(qj.g)).max()
    np.testing.assert_allclose(n(qt.H), np.asarray(qj.H), rtol=0, atol=QUAD_REL * scale_h)
    np.testing.assert_allclose(n(qt.g), np.asarray(qj.g), rtol=0, atol=QUAD_REL * scale_g)
    np.testing.assert_allclose(float(qt.cost), float(qj.cost), rtol=QUAD_REL)
    if case == "padded_poses":   # the padded slots' rows and columns are 0
        assert not n(qt.H)[24:].any() and not n(qt.H)[:, 24:].any() and not n(qt.g)[24:].any()


# ---------------------------------------------------------------------------
# csrc/balm.cu's derivative chain, emulated in numpy float32
# ---------------------------------------------------------------------------

F = np.float32


class _Jet:
    """A value with its gradient [.., 6] and Hessian [.., 6, 6] in six inputs
    (the kernel's second-order forward mode)."""

    def __init__(self, v, g, h):
        self.v, self.g, self.h = v, g, h

    @staticmethod
    def var(x, k):
        g = np.zeros(x.shape + (6,), F)
        g[..., k] = 1
        return _Jet(x, g, np.zeros(x.shape + (6, 6), F))

    def __add__(self, b):
        return _Jet(self.v + b.v, self.g + b.g, self.h + b.h)

    def __sub__(self, b):
        return _Jet(self.v - b.v, self.g - b.g, self.h - b.h)

    def __mul__(self, b):
        if not isinstance(b, _Jet):
            return _Jet(self.v * F(b), self.g * F(b), self.h * F(b))
        gg = self.g[..., :, None] * b.g[..., None, :]
        return _Jet(self.v * b.v, self.g * b.v[..., None] + b.g * self.v[..., None],
                    self.h * b.v[..., None, None] + b.h * self.v[..., None, None]
                    + gg + np.swapaxes(gg, -1, -2))

    def fn(self, f0, f1, f2, const=None):
        """phi(self) from phi, phi', phi''; constant where ``const``."""
        g = f1[..., None] * self.g
        h = f1[..., None, None] * self.h + f2[..., None, None] * (
            self.g[..., :, None] * self.g[..., None, :])
        if const is not None:
            g, h = np.where(const[..., None], 0, g), np.where(const[..., None, None], 0, h)
        return _Jet(f0, g.astype(F), h.astype(F))


def _lambda_min_jet(c):
    """smallest_eigval_sym3 of the symmetric matrix of c = (C00, C11, C22,
    C01, C02, C12) [V, 6], with its arccos clip and its p floor."""
    x = [_Jet.var(c[:, k], k) for k in range(6)]
    q = (x[0] + x[1] + x[2]) * (1.0 / 3.0)
    a = [x[0] - q, x[1] - q, x[2] - q] + x[3:]
    p2 = (a[0] * a[0] + a[1] * a[1] + a[2] * a[2]
          + (a[3] * a[3] + a[4] * a[4] + a[5] * a[5]) * 2.0) * (1.0 / 6.0)
    sp = np.sqrt(np.maximum(p2.v, F(1e-30)))
    p = p2.fn(sp, F(0.5) / sp, F(-0.25) / (sp * sp * sp), const=p2.v < F(1e-30))
    ip = p.fn(F(1) / p.v, -F(1) / (p.v * p.v), F(2) / (p.v * p.v * p.v))
    b = [ai * ip for ai in a]
    det = (b[0] * b[1] * b[2] + b[3] * b[4] * b[5] * 2.0 - b[0] * b[5] * b[5]
           - b[1] * b[4] * b[4] - b[2] * b[3] * b[3])
    r = det * 0.5
    lo, hi = F(-1.0 + 1e-6), F(1.0 - 1e-6)
    rv = np.clip(r.v, lo, hi)
    s = F(1) - rv * rv
    phi = r.fn(np.arccos(rv), -F(1) / np.sqrt(s), -rv / (s * np.sqrt(s)),
               const=(r.v < lo) | (r.v > hi)) * (1.0 / 3.0)
    arg = phi.v + F(2.0 * np.pi / 3.0)
    return q + p * phi.fn(np.cos(arg), -np.sin(arg), -np.cos(arg)) * 2.0


def _sym6(X):
    return np.stack([X[..., 0, 0], X[..., 1, 1], X[..., 2, 2], X[..., 0, 1], X[..., 0, 2],
                     X[..., 1, 2]], -1)


def _hat(v):
    z = np.zeros_like(v[..., 0])
    return np.stack([np.stack([z, -v[..., 2], v[..., 1]], -1),
                     np.stack([v[..., 2], z, -v[..., 0]], -1),
                     np.stack([-v[..., 1], v[..., 0], z], -1)], -2)


def balm_chain_f32(N, mean, Pc, center, valid, T):
    """(H, g, cost) by the kernel's chain: the closed-form first and second
    derivatives of the covariance in the 6W right tangents, the jet of
    lambda_min in the covariance's six entries, chained and weighted."""
    N, mean, Pc, center, T = (np.asarray(a, F) for a in (N, mean, Pc, center, T))
    V, W = N.shape
    R, tr = T[:, :3, :3], T[:, :3, 3]
    M = np.einsum("wij,vwj->vwi", R, mean)                        # R mean
    m = M + tr[None] - center[:, None]
    Q = np.einsum("wij,vwjk,wlk->vwil", R, Pc, R)
    n_tot = N.sum(1)
    n = np.maximum(n_tot, F(1))
    mu = (N[..., None] * m).sum(1) / n[:, None]
    C = (Q + N[..., None, None] * m[..., :, None] * m[..., None, :]).sum(1) / n[:, None, None] \
        - mu[:, :, None] * mu[:, None, :]
    C = np.where(valid[:, None, None], C, np.diag(np.array([1, 2, 3], F)))
    lam = _lambda_min_jet(_sym6(C + F(1e-9) * np.eye(3, dtype=F)))
    f, fh = lam.g, lam.h
    Lam = np.stack([np.stack([f[:, 0], f[:, 3] / 2, f[:, 4] / 2], -1),
                    np.stack([f[:, 3] / 2, f[:, 1], f[:, 5] / 2], -1),
                    np.stack([f[:, 4] / 2, f[:, 5] / 2, f[:, 2]], -1)], -2)
    d = m - mu[:, None]
    u = np.swapaxes(R, -1, -2)               # u[w, i]: the world axis of rho_i, phi_i
    U = _hat(u)
    Dp = np.zeros((V, W, 6, 3), F)           # d m_w / d xi
    Dp[:, :, :3] = u[None]
    Dp[:, :, 3:] = np.cross(u[None], M[:, :, None, :])
    dC = np.zeros((V, W, 6, 3, 3), F)
    UQ = np.einsum("wiab,vwbc->vwiac", U, Q)
    dC[:, :, 3:] = (UQ + np.swapaxes(UQ, -1, -2)) / n[:, None, None, None, None]
    Dd = Dp[..., :, None] * d[:, :, None, None, :]
    dC += (N / n[:, None])[..., None, None, None] * (Dd + np.swapaxes(Dd, -1, -2))
    dC6 = _sym6(dC).reshape(V, 6 * W, 6)
    Dflat = Dp.reshape(V, 6 * W, 3)
    DLD = np.einsum("vpi,vij,vqj->vpq", Dflat, Lam, Dflat)
    Nw = np.repeat(N, 6, axis=1)
    H = np.einsum("vpk,vkl,vql->vpq", dC6, fh, dC6) \
        - 2 * Nw[:, :, None] * Nw[:, None, :] / (n * n)[:, None, None] * DLD
    h = np.einsum("vij,vwj->vwi", Lam, d)    # Lambda d_w
    for w in range(W):
        blk = 2 * (N[:, w] / n)[:, None, None] * DLD[:, 6 * w:6 * w + 6, 6 * w:6 * w + 6]
        for i in range(3):
            for j in range(3):
                # (phi_i, rho_j): d2m = (u_i x u_j) / 2
                pr = (N[:, w] / n) * (h[:, w] @ np.cross(u[w, i], u[w, j]))
                blk[:, 3 + i, j] += pr
                blk[:, j, 3 + i] += pr
                # (phi_i, phi_j): d2m = (u_i mean_j + u_j mean_i - 2 M [i == j]) / 2
                d2h = (h[:, w] @ u[w, i]) * mean[:, w, j] + (h[:, w] @ u[w, j]) * mean[:, w, i] \
                    - 2 * (i == j) * np.einsum("vk,vk->v", M[:, w], h[:, w])
                blk[:, 3 + i, 3 + j] += (N[:, w] / n) * d2h
                # Lambda : d2Q
                X = U[w, i] @ Q[:, w] @ U[w, j].T + 0.5 * (U[w, i] @ U[w, j] + U[w, j] @ U[w, i]) @ Q[:, w]
                blk[:, 3 + i, 3 + j] += 2 * np.einsum("vab,vab->v", Lam, X) / n
        H[:, 6 * w:6 * w + 6, 6 * w:6 * w + 6] += blk
    wv = valid.astype(F) * n_tot
    return (np.einsum("v,vpq->pq", wv, H), np.einsum("v,vp->p", wv, np.einsum(
        "vk,vpk->vp", f, dC6)), np.sum(wv * lam.v))


@pytest.mark.parametrize("case", ("planar", "padded_poses"))
def test_balm_kernel_chain_matches_jax_hessian(case):
    """The derivation of ``csrc/balm.cu``, checked on the CPU before any card:
    its chain in float32 against ``jax.hessian`` of the eigen cost."""
    b = chip_smoke.balm_case(np.random.default_rng(0), case)
    cj = _jax_clusters(b)
    assert int(cj.valid.sum()) > 20
    qj = jbalm.quadratic(cj, jnp.asarray(b["T_eval"]))
    H, g, cost = balm_chain_f32(*(np.asarray(a) for a in cj), b["T_eval"])
    for got, ref in ((H, qj.H), (g, qj.g)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got, ref, rtol=0, atol=QUAD_REL * np.abs(ref).max())
    np.testing.assert_allclose(cost, float(qj.cost), rtol=QUAD_REL)


def test_dispatch_by_device():
    """CPU tensors take the plain versions (no launch); a device that is
    neither the CPU nor CUDA raises, and so do the kernel wrappers given CPU
    tensors."""
    p = chip_smoke.ba_problem(np.random.default_rng(5), "balm")
    args, kw = chip_smoke.ba_torch(torch, p, "cpu")
    before = (klba.launches, kbalm.launches)
    res = tlmo.local_ba(*args, **kw)
    assert (klba.launches, kbalm.launches) == before and res.T_cw.device.type == "cpu"
    ref = klba.local_ba_plain(*args, **kw)
    assert all(torch.equal(a, b) for a, b in zip(res, ref))
    b = chip_smoke.balm_case(np.random.default_rng(5), "planar")
    c = tbalm.build_clusters(t(b["points"]), t(b["valid"]), t(b["T_build"]), voxel_size=1.0,
                             max_voxels=256, min_points=15)
    q = tbalm.quadratic(c, t(b["T_eval"]))
    qp = kbalm.quadratic_plain(c, t(b["T_eval"]))
    assert kbalm.launches == before[1] and all(torch.equal(a, b) for a, b in zip(q, qp))
    meta = lambda x: x.to("meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tlmo.local_ba(args[0], *(meta(a) if isinstance(a, torch.Tensor) else a for a in args[1:]),
                      iters=2)
    with pytest.raises(ValueError, match="unsupported device"):
        tbalm.quadratic(tbalm.VoxelClusters(*map(meta, c)), meta(t(b["T_eval"])))
    with pytest.raises(ValueError, match="CUDA"):
        klba.local_ba_lm(*args, **kw)
    with pytest.raises(ValueError, match="CUDA"):
        kbalm.balm_quadratic(c, t(b["T_eval"]))


@pytest.mark.parametrize("window", [67, 68])
def test_system_refuses_a_window_over_the_kernel_limit(window):
    """On the card ``System`` takes a window BA of at most 67 poses, the
    kernel's limit, and says so at construction, before it allocates
    anything; on the CPU any window."""
    import dataclasses
    from tc2li_slam_torch.slam import config as tcfg, system as tsys
    from torch_parity import small_config
    cfg = small_config(tcfg)
    cfg = dataclasses.replace(cfg, tracking=dataclasses.replace(cfg.tracking,
                                                                local_window=window))
    assert tsys.System(cfg, "cpu").cfg.tracking.local_window == window
    if window > klba.MAX_POSES:
        with pytest.raises(ValueError, match="at most 67 poses"):
            tsys.System(cfg, torch.device("cuda"))
