"""Parity: two-view triangulation, the epipolar gate and new-map-point
creation of tc2li_slam_torch vs tc2li_slam_tpu, on the same numpy inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tc2li_slam_tpu.geom import camera as jcam, triangulate as jtri
from tc2li_slam_tpu.ops import matching as jm
from tc2li_slam_tpu.slam import mapstate as jms, triangulation as jtg
from tc2li_slam_torch import interop
from tc2li_slam_torch.geom import camera as tcam, triangulate as ttri
from tc2li_slam_torch.ops import matching as tm
from tc2li_slam_torch.slam import mapstate as tms, triangulation as ttg
from torch_parity import jax_midsequence, n, random_poses, t

FX = FY = 450.0
CX, CY = 320.0, 240.0
BF = 45.0   # baseline 0.1 m


def _project(T, X):
    Xc = (T[:3, :3] @ X.T).T + T[:3, 3]
    return np.stack([FX * Xc[:, 0] / Xc[:, 2] + CX, FY * Xc[:, 1] / Xc[:, 2] + CY], -1)


def _views(rng, n_pts, baseline):
    """Points in front of two cameras `baseline` apart, normalized coords."""
    X = np.stack([rng.uniform(-6, 6, n_pts), rng.uniform(-4, 4, n_pts),
                  rng.uniform(8, 40, n_pts)], -1)
    T1, T2 = random_poses(rng, 2, rot=0.05, trans=0.2).astype(np.float64)
    T2[:3, 3] += T2[:3, :3] @ np.array([-baseline, 0.0, 0.0])
    xn = []
    for T in (T1, T2):
        Xc = (T[:3, :3] @ X.T).T + T[:3, 3]
        xn.append((Xc[:, :2] / Xc[:, 2:]).astype(np.float32))
    return X, T1.astype(np.float32), T2.astype(np.float32), xn[0], xn[1]


@pytest.mark.parametrize("noise", [0.0, 1e-3])
def test_triangulate_dlt(rng, noise):
    """Points within 1e-3 of the depth of the JAX package's, on pairs with
    >= 1 degree of parallax; measured 6e-6 (the float32 SVD's own error)."""
    X, T1, T2, xn1, xn2 = _views(rng, 400, baseline=1.5)
    xn1 = xn1 + noise * rng.standard_normal(xn1.shape).astype(np.float32)
    Xj = np.asarray(jtri.triangulate_dlt(jnp.asarray(xn1), jnp.asarray(xn2),
                                         jnp.asarray(T1), jnp.asarray(T2)))
    Xt = n(ttri.triangulate_dlt(t(xn1), t(xn2), t(T1), t(T2)))
    assert Xt.dtype == np.float32
    c1, c2 = -T1[:3, :3].T @ T1[:3, 3], -T2[:3, :3].T @ T2[:3, 3]
    cosp = np.asarray(jtri.parallax_cos(jnp.asarray(X, jnp.float32), jnp.asarray(c1), jnp.asarray(c2)))
    np.testing.assert_allclose(n(ttri.parallax_cos(t(X.astype(np.float32)), t(c1), t(c2))),
                               cosp, atol=1e-6)
    wide = cosp < np.cos(np.deg2rad(1.0))
    assert wide.sum() > 300
    depth = np.linalg.norm(X - c1, axis=-1)
    rel = np.linalg.norm(Xt - Xj, axis=-1) / depth
    assert rel[wide].max() < 1e-3, rel[wide].max()
    if noise == 0.0:
        assert (np.linalg.norm(Xt - X, axis=-1) / depth)[wide].max() < 1e-3
    # per-match poses [N, 4, 4] take the same route
    Xb = n(ttri.triangulate_dlt(t(xn1), t(xn2), t(np.tile(T1, (400, 1, 1))), t(T2)))
    np.testing.assert_allclose(Xb, Xt, rtol=1e-5, atol=1e-5)


def test_null_vector_against_svd(rng):
    """The inverse iteration on A^T A (float64) against torch's own SVD, on
    the design matrices of noisy matches."""
    _, T1, T2, xn1, xn2 = _views(rng, 500, baseline=0.8)
    xn2 = xn2 + 2e-3 * rng.standard_normal(xn2.shape).astype(np.float32)
    A = ttri.design_matrix(t(xn1), t(xn2), t(T1), t(T2))
    v = ttri.null_vector(A)
    ref = torch.linalg.svd(A.to(torch.float64))[2][:, 3, :]
    dots = torch.abs(torch.sum(v.to(torch.float64) * ref, dim=-1))
    assert float(dots.min()) > 1.0 - 1e-6
    assert v.dtype == torch.float32 and bool(torch.isfinite(v).all())
    # an exactly singular matrix (both views the same) stays finite
    same = ttri.null_vector(ttri.design_matrix(t(xn1), t(xn1), t(T1), t(T1)))
    assert bool(torch.isfinite(same).all())


def test_epipolar_mask(rng):
    """Equal except for pairs within 1e-3 (relative) of the gate."""
    N, M = 300, 260
    uv1 = rng.uniform(0, 640, (N, 2)).astype(np.float32)
    uv2 = rng.uniform(0, 480, (M, 2)).astype(np.float32)
    uv2[:100] = uv1[:100] + rng.normal(0, 1.5, (100, 2)).astype(np.float32)
    F12 = (rng.normal(0, 1, (3, 3)) * np.array([1e-6, 1e-6, 1e-3])).astype(np.float32)
    F12[2, 2] = 0.3
    sigma2 = (1.2 ** (2 * rng.integers(0, 8, M))).astype(np.float32)
    mj = np.asarray(jm.epipolar_mask(jnp.asarray(uv1), jnp.asarray(uv2), jnp.asarray(F12),
                                     jnp.asarray(sigma2)))
    mt = n(tm.epipolar_mask(t(uv1), t(uv2), t(F12), t(sigma2)))
    assert mt.dtype == np.bool_ and mt.shape == (N, M) and 0 < mj.mean() < 1
    x1 = np.concatenate([uv1, np.ones((N, 1))], -1).astype(np.float64)
    lines = x1 @ F12.astype(np.float64).T
    num = np.abs(lines[:, None, 0] * uv2[None, :, 0] + lines[:, None, 1] * uv2[None, :, 1]
                 + lines[:, None, 2])
    d2 = num * num / np.maximum(lines[:, 0] ** 2 + lines[:, 1] ** 2, 1e-12)[:, None]
    gate = 3.84 * sigma2[None, :]
    off_gate = np.abs(d2 - gate) > 1e-3 * gate
    np.testing.assert_array_equal(mt[off_gate], mj[off_gate])
    assert (mt != mj).sum() <= 2


def _two_view_map(rng, baseline, n_pts=64, F=96):
    """The two-keyframe map of tests/test_triangulation.py: far points
    (beyond stereo), unmatched, as a JAX MapState."""
    X = np.stack([rng.uniform(-15, 15, n_pts), rng.uniform(-8, 8, n_pts),
                  rng.uniform(25, 45, n_pts)], -1)
    T2 = np.eye(4, dtype=np.float32)
    T2[0, 3] = -baseline
    m = jms.create(max_kf=8, max_feats=F, max_lm=256, max_obs=8)
    descs = rng.integers(0, 2 ** 32, (n_pts, 8), dtype=np.uint32)
    for k, T in enumerate((np.eye(4, dtype=np.float32), T2)):
        xy = np.zeros((F, 2), np.float32)
        xy[:n_pts] = _project(T, X)
        uvr = np.concatenate([xy, np.full((F, 1), -1.0, np.float32)], -1)
        desc = np.zeros((F, 8), np.uint32)
        desc[:n_pts] = descs
        m, _ = jms.add_keyframe(
            m, jnp.asarray(T), jnp.float32(k), jnp.asarray(xy), jnp.asarray(uvr),
            jnp.zeros(F, jnp.int32), jnp.zeros(F), jnp.asarray(desc),
            jnp.asarray(np.arange(F) < n_pts), jnp.full((F,), jms.NO_LM, jnp.int32))
    return m, X


def _cmp_maps(mt, mj):
    """Every field: dtype, integers equal, floats to 1e-3 (new landmark
    positions are triangulated in two libraries)."""
    for k, v in mj._asdict().items():
        a, b = interop._numpy(k, getattr(mt, k)), np.asarray(v)
        assert a.dtype == b.dtype, k
        if b.dtype.kind == "f":
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-3, err_msg=k)
        else:
            np.testing.assert_array_equal(a, b, err_msg=k)


@pytest.mark.parametrize("baseline,expect_some", [(1.5, True), (0.05, False)])
def test_pair_candidates(rng, baseline, expect_some):
    """`want` and `idx2` equal, `Xw` to 1e-3 m; a pair closer than the rig's
    own baseline (0.1 m) is rejected in both."""
    mj, X = _two_view_map(rng, baseline)
    mt = interop.mapstate_from_numpy(mj)
    cam_j = jcam.Pinhole.create(FX, FY, CX, CY, bf=BF)
    cam_t = tcam.Pinhole.create(FX, FY, CX, CY, bf=BF)
    sf = (1.2 ** np.arange(8)).astype(np.float32)
    sigma2 = np.ones(8, np.float32)
    cj = jtg._pair_candidates(mj, jnp.int32(1), jnp.int32(0), jnp.bool_(True), cam_j,
                              jnp.asarray(sigma2), jnp.asarray(sf))
    ct = ttg._pair_candidates(mt, 1, 0, cam_t, t(sigma2), t(sf))
    want = np.asarray(cj[0])
    np.testing.assert_array_equal(n(ct[0]), want)
    assert (want.sum() > 0.8 * 64) if expect_some else (want.sum() == 0)
    np.testing.assert_array_equal(n(ct[4]), np.asarray(cj[4]))
    for a, b in zip(ct[1:4], cj[1:4]):
        np.testing.assert_allclose(n(a)[want], np.asarray(b)[want], atol=1e-3, rtol=1e-4)
    # the one-pair entry: same slots, same observations in both keyframes
    _cmp_maps(ttg.triangulate_pair(mt, 1, 0, cam_t, t(sigma2), t(sf)),
              jtg.triangulate_pair(mj, jnp.int32(1), jnp.int32(0), jnp.bool_(True), cam_j,
                                   jnp.asarray(sigma2), jnp.asarray(sf)))
    # a padded pair allocates nothing, as the reference's pair_ok=False
    pad_t = ttg.triangulate_pair(mt, 1, tms.NO_KF, cam_t, t(sigma2), t(sf))
    pad_j = jtg.triangulate_pair(mj, jnp.int32(1), jnp.int32(jms.NO_KF), jnp.bool_(False), cam_j,
                                 jnp.asarray(sigma2), jnp.asarray(sf))
    assert int(pad_t.n_lm) == int(pad_j.n_lm) == int(mj.n_lm)


@pytest.fixture(scope="module")
def mid():
    s, _ = jax_midsequence(7)
    c = s.cfg.camera
    cam_t = tcam.Pinhole.create(c.fx, c.fy, c.cx, c.cy, bf=c.bf, width=c.width, height=c.height)
    return s, cam_t


@pytest.mark.parametrize("neighbors", [[1, 0, -1], [0, -1, -1], [-1, -1, -1], [1, -1, 0]])
def test_triangulate_batch(mid, neighbors):
    """A map carried over from the JAX System: same `n_lm`, same slots, same
    second observations, every container field's dtype."""
    s, cam_t = mid
    kf1 = int(s.map.n_kf) - 1
    assert kf1 >= 2
    mt = interop.mapstate_from_numpy(s.map)
    mj2 = jtg.triangulate_batch(s.map, jnp.int32(kf1), jnp.asarray(neighbors, jnp.int32), s.cam,
                                s.sigma2, s.scale_factors, max_pairs=3)
    mt2 = ttg.triangulate_batch(mt, kf1, neighbors, cam_t, t(np.asarray(s.sigma2)),
                                t(np.asarray(s.scale_factors)), max_pairs=3)
    n_new = int(mj2.n_lm) - int(s.map.n_lm)
    assert int(mt2.n_lm) - int(mt.n_lm) == n_new
    assert (n_new > 0) == any(nb >= 0 for nb in neighbors)
    _cmp_maps(mt2, mj2)
    if neighbors == [1, 0, -1]:
        mj3 = jtg.create_new_map_points(s.map, kf1, [1, kf1, 0, -1], s.cam, s.sigma2,
                                        s.scale_factors, max_pairs=3)
        mt3 = ttg.create_new_map_points(mt, kf1, [1, kf1, 0, -1], cam_t, t(np.asarray(s.sigma2)),
                                        t(np.asarray(s.scale_factors)), max_pairs=3)
        _cmp_maps(mt3, mj3)
