"""Parity: the batched PnP RANSAC of tc2li_slam_torch vs tc2li_slam_tpu.

The JAX package draws each hypothesis' six points by Gumbel top-k from its
key; the port takes the indices. ``jax_sample_idx`` repeats the reference's
draw (the same ``split``, ``gumbel``, ``top_k`` lines) and the port is fed
its result, so both run the same hypotheses."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tc2li_slam_tpu.geom import camera as jcam, lie as jlie
from tc2li_slam_tpu.solver import pnp as jpnp
from tc2li_slam_torch.geom import camera as tcam, lie as tlie
from tc2li_slam_torch.solver import pnp as tpnp
from torch_parity import n, t

CAM = dict(fx=450.0, fy=450.0, cx=320.0, cy=240.0, bf=45.0)
POSE_ATOL = 1e-4


def jax_sample_idx(key, valid, n_hyp: int, min_pts: int = 6) -> np.ndarray:
    """The indices ``tc2li_slam_tpu.solver.pnp.pnp_ransac`` draws from ``key``."""
    N = valid.shape[0]
    logits = jnp.where(jnp.asarray(valid), 0.0, -jnp.inf)
    keys = jax.random.split(key, n_hyp)
    return np.asarray(jax.vmap(
        lambda k: jax.lax.top_k(jax.random.gumbel(k, (N,)) + logits, min_pts)[1])(keys))


def _scene(rng, N, n_out, noise=0.3):
    X = np.stack([rng.uniform(-10, 10, N), rng.uniform(-6, 6, N),
                  rng.uniform(5, 30, N)], -1).astype(np.float32)
    T_gt = np.asarray(jlie.se3_exp(jnp.asarray(rng.uniform(-0.3, 0.3, 6).astype(np.float32))))
    Xc = (T_gt[:3, :3] @ X.T).T + T_gt[:3, 3]
    uv = np.array(jcam.project(jcam.Pinhole.create(**CAM), jnp.asarray(Xc)))
    uv += rng.normal(0, noise, uv.shape)
    uv[:n_out] += rng.uniform(30, 120, (n_out, 2))
    return X, uv.astype(np.float32), T_gt


def test_dlt_pose_exact_correspondences(rng):
    """Exact correspondences: the pose to 1e-4, single and batched."""
    X, uv, T_gt = _scene(rng, 24, 0, noise=0.0)
    xn = np.stack([(uv[:, 0] - CAM["cx"]) / CAM["fx"], (uv[:, 1] - CAM["cy"]) / CAM["fy"]], -1)
    Tj = np.asarray(jpnp._dlt_pose(jnp.asarray(X), jnp.asarray(xn)))
    Tt = n(tpnp._dlt_pose(t(X), t(xn)))
    np.testing.assert_allclose(Tt, Tj, atol=POSE_ATOL)
    np.testing.assert_allclose(Tt, T_gt, atol=5e-4)
    idx = np.stack([rng.choice(24, 6, replace=False) for _ in range(5)])
    Tb = n(tpnp._dlt_pose(t(X)[idx], t(xn)[idx]))
    for i in range(5):
        np.testing.assert_allclose(
            Tb[i], np.asarray(jpnp._dlt_pose(jnp.asarray(X[idx[i]]), jnp.asarray(xn[idx[i]]))),
            atol=2e-3)   # six points: the design's null vector is less well separated


def test_orthogonalize_far_from_rotation(rng):
    """The SVD projection takes matrices far from SO(3), reflections included."""
    R = rng.normal(0, 1, (16, 3, 3)).astype(np.float32)
    Rj = np.asarray(jlie.orthogonalize(jnp.asarray(R)))
    Rt = n(tlie.orthogonalize(t(R)))
    np.testing.assert_allclose(Rt, Rj, atol=1e-5)
    np.testing.assert_allclose(np.linalg.det(Rt), 1.0, atol=1e-5)


@pytest.mark.parametrize("seed,n_hyp", [(0, 128), (3, 64)])
def test_pnp_ransac_with_outliers(rng, seed, n_hyp):
    """30% outliers, the JAX-drawn hypotheses: the same inlier mask, the
    pose to 1e-4."""
    N, n_out = 120, 36
    X, uv, T_gt = _scene(rng, N, n_out)
    valid = np.ones(N, bool)
    valid[-5:] = False
    key = jax.random.PRNGKey(seed)
    rj = jpnp.pnp_ransac(jcam.Pinhole.create(**CAM), jnp.asarray(X), jnp.asarray(uv),
                         jnp.asarray(valid), key, n_hyp=n_hyp)
    rt = tpnp.pnp_ransac(tcam.Pinhole.create(**CAM), t(X), t(uv), t(valid), n_hyp=n_hyp,
                         sample_idx=t(jax_sample_idx(key, valid, n_hyp)))
    assert bool(rj.ok) and bool(rt.ok)
    assert rt.n_inliers.dtype == torch.int32 and int(rt.n_inliers) == int(rj.n_inliers)
    np.testing.assert_array_equal(n(rt.inliers), np.asarray(rj.inliers))
    np.testing.assert_allclose(n(rt.T_cw), np.asarray(rj.T_cw), atol=POSE_ATOL)
    inl = n(rt.inliers)
    assert inl[:n_out].mean() < 0.2 and inl[n_out:-5].mean() > 0.9 and not inl[-5:].any()
    err = np.asarray(jlie.se3_log(jnp.asarray(np.linalg.inv(T_gt) @ n(rt.T_cw))))
    assert np.abs(err).max() < 1e-2


def test_pnp_winning_hypothesis(rng):
    """The same hypothesis wins in both: its inlier count over all
    hypotheses, from the port's own DLT poses, is the reference's."""
    N = 100
    X, uv, _ = _scene(rng, N, 30, noise=0.1)
    valid = np.ones(N, bool)
    key = jax.random.PRNGKey(5)
    idx = jax_sample_idx(key, valid, 64)
    xn = np.stack([(uv[:, 0] - CAM["cx"]) / CAM["fx"], (uv[:, 1] - CAM["cy"]) / CAM["fy"]], -1)

    def counts(Ts):
        Xc = np.einsum("hij,nj->hni", Ts[:, :3, :3], X) + Ts[:, None, :3, 3]
        z = np.where(np.abs(Xc[..., 2]) < 1e-6, 1e-6, Xc[..., 2])
        u = CAM["fx"] * Xc[..., 0] / z + CAM["cx"]
        v = CAM["fy"] * Xc[..., 1] / z + CAM["cy"]
        return (((u - uv[:, 0]) ** 2 + (v - uv[:, 1]) ** 2 < 16.0) & (Xc[..., 2] > 0.1)).sum(-1)

    Tj = np.stack([np.asarray(jpnp._dlt_pose(jnp.asarray(X[i]), jnp.asarray(xn[i]))) for i in idx])
    Tt = n(tpnp._dlt_pose(t(X)[t(idx)], t(xn)[t(idx)]))
    cj, ct = counts(Tj), counts(Tt)
    assert int(np.argmax(ct)) == int(np.argmax(cj)) and ct.max() == cj.max() >= 60


def test_pnp_garbage_and_generator(rng):
    """Garbage input: not ok in both, a finite pose; all-invalid input
    counts no inlier; the port's own draw takes distinct valid points and
    repeats under the same seed."""
    N = 50
    X = rng.normal(0, 10, (N, 3)).astype(np.float32)
    uv = rng.uniform(0, 640, (N, 2)).astype(np.float32)
    key = jax.random.PRNGKey(1)
    valid = np.ones(N, bool)
    rj = jpnp.pnp_ransac(jcam.Pinhole.create(**CAM), jnp.asarray(X), jnp.asarray(uv),
                         jnp.asarray(valid), key, n_hyp=64)
    cam_t = tcam.Pinhole.create(**CAM)
    rt = tpnp.pnp_ransac(cam_t, t(X), t(uv), t(valid), n_hyp=64,
                         sample_idx=t(jax_sample_idx(key, valid, 64)))
    assert not bool(rj.ok) and not bool(rt.ok)
    assert np.isfinite(n(rt.T_cw)).all()
    none = tpnp.pnp_ransac(cam_t, t(X), t(uv), torch.zeros(N, dtype=torch.bool),
                           generator=torch.Generator().manual_seed(0))
    assert not bool(none.ok) and int(none.n_inliers) == 0 and np.isfinite(n(none.T_cw)).all()
    # a hypothesis that is not finite must count zero inliers, never win
    Xbad = X.copy()
    Xbad[:6] = np.nan
    idx = np.tile(np.arange(6), (64, 1))
    idx[1] = np.arange(10, 16)
    assert not np.isfinite(n(tpnp._dlt_pose(t(Xbad)[:6], t(uv)[:6]))).any()
    bad = tpnp.pnp_ransac(cam_t, t(Xbad), t(uv), t(valid), sample_idx=t(idx))
    assert np.isfinite(n(bad.T_cw)).all() and not bool(bad.ok)

    valid[::3] = False
    draws = [tpnp.draw_samples(t(valid), 32, 6, torch.Generator().manual_seed(7)) for _ in range(2)]
    assert torch.equal(draws[0], draws[1]) and draws[0].shape == (32, 6)
    assert bool(t(valid)[draws[0]].all())
    assert all(len(set(row.tolist())) == 6 for row in draws[0])
    with pytest.raises(ValueError):
        tpnp.pnp_ransac(cam_t, t(X), t(uv), t(valid))
