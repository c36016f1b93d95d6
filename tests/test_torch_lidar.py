"""Parity: LiDAR preprocessing, voxel map, plane fitting and the
camera-driven LiDAR mapping of tc2li_slam_torch vs tc2li_slam_tpu."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tc2li_slam_tpu.ops import plane_fit as jpf, pointcloud as jpc, voxel_map as jvm
from tc2li_slam_tpu.slam import lio as jlio
from tc2li_slam_torch import interop
from tc2li_slam_torch.ops import plane_fit as tpf, pointcloud as tpc, voxel_map as tvm
from tc2li_slam_torch.slam import lio as tlio
from torch_parity import n, random_poses, small_sequence, t

# centroids are float32 sums of a voxel's points, accumulated in the same
# (key-sorted) order; allow a few ulp of 50 m
PT_ATOL = 2e-5


@pytest.fixture(scope="module")
def scans():
    return [(np.asarray(fr.scan), np.asarray(fr.scan_valid)) for fr in small_sequence(3)]


def _vm_eq(mt, mj, pts_atol=0.0):
    np.testing.assert_array_equal(n(mt.keys), np.asarray(mj.keys))
    np.testing.assert_array_equal(n(mt.count), np.asarray(mj.count))
    assert mt.count.dtype == torch.int32 and mt.keys.dtype == torch.int32
    # recentring computes origin + shift * voxel; XLA contracts that into one
    # fused multiply-add, torch rounds twice: 1 ulp
    np.testing.assert_allclose(n(mt.origin), np.asarray(mj.origin), rtol=2.5e-7, atol=0)
    k = np.asarray(mj.keys) != jvm.EMPTY_KEY
    np.testing.assert_allclose(n(mt.points)[k], np.asarray(mj.points)[k], rtol=0, atol=pts_atol)


def test_preprocess_downsample(scans):
    scan, valid = scans[0]
    kj = jpc.preprocess(jnp.asarray(scan), jnp.zeros(len(scan)), jnp.asarray(valid), blind=1.0)
    kt = tpc.preprocess(t(scan), t(valid), blind=1.0)
    np.testing.assert_array_equal(n(kt), np.asarray(kj))
    pj, vj = jpc.voxel_downsample(jnp.asarray(scan), kj, 0.4)
    pt, vt = tpc.voxel_downsample(t(scan), kt, 0.4)
    np.testing.assert_array_equal(n(vt), np.asarray(vj))
    np.testing.assert_allclose(n(pt), np.asarray(pj), rtol=0, atol=PT_ATOL)


def test_voxel_map_insert_knn_recenter(rng, scans):
    mj = jvm.create(1 << 13, 0.4)
    mt = tvm.create(1 << 13, 0.4, device="cpu")
    _vm_eq(mt, mj)
    for scan, valid in scans:   # third insert overflows the 8k pool
        T = random_poses(rng, 1, rot=0.05, trans=0.5)[0]
        pw = (scan @ T[:3, :3].T + T[:3, 3]).astype(np.float32)
        mj = jvm.insert(mj, jnp.asarray(pw), jnp.asarray(valid))
        mt = tvm.insert(mt, t(pw), t(valid))
        _vm_eq(mt, mj)
    q = (scans[0][0][:300] + rng.normal(0, 0.3, (300, 3))).astype(np.float32)
    for k, r in ((5, 1), (5, 2)):
        dj, pj, vj = jvm.knn(mj, jnp.asarray(q), k=k, radius=r)
        dt, pt, vt = tvm.knn(mt, t(q), k=k, radius=r)
        np.testing.assert_array_equal(n(vt), np.asarray(vj))
        np.testing.assert_array_equal(n(pt), np.asarray(pj))
        np.testing.assert_allclose(n(dt), np.asarray(dj), rtol=1e-6, atol=1e-6)
    center = np.array([190.0, -3.0, 1.0], np.float32)
    for c in (center, np.zeros(3, np.float32)):
        assert bool(tvm.needs_recenter(mt, t(c), 150.0)) == bool(jvm.needs_recenter(mj, jnp.asarray(c), 150.0))
    _vm_eq(tvm.recenter(mt, t(center)), jvm.recenter(mj, jnp.asarray(center)))
    rt, nt = tlio.maybe_recenter(mt, t(center))
    rj, nj = jlio.maybe_recenter(mj, jnp.asarray(center))
    assert bool(nt) == bool(nj)
    _vm_eq(rt, rj)
    _vm_eq(interop.voxelmap_from_numpy(mj._asdict()), mj)
    back = interop.voxelmap_to_numpy(interop.voxelmap_from_numpy(mj._asdict()))
    np.testing.assert_array_equal(back["keys"], np.asarray(mj.keys))


def test_plane_fit(rng):
    Q = 400
    normal = rng.normal(0, 1, (Q, 3))
    normal /= np.linalg.norm(normal, axis=1, keepdims=True)
    base = rng.normal(0, 10, (Q, 1, 3))
    pts = base + rng.normal(0, 1, (Q, 5, 3))
    pts -= np.sum(pts * normal[:, None], -1, keepdims=True) * normal[:, None]   # onto planes
    pts += rng.normal(0, 0.02, (Q, 5, 1)) * normal[:, None]
    pts[:50] += rng.normal(0, 0.5, (50, 5, 3))    # non-planar sets
    pts = pts.astype(np.float32)
    valid = rng.random((Q, 5)) > 0.1
    nj, dj, okj = jpf.fit_planes(jnp.asarray(pts), jnp.asarray(valid), 0.1)
    nt, dt, okt = tpf.fit_planes(t(pts), t(valid), 0.1)
    np.testing.assert_array_equal(n(okt), np.asarray(okj))
    # A plane through (nearly) collinear neighbours has no defined normal:
    # compare where the two largest spreads differ by < 100x. There, up to
    # its arbitrary sign, a float32 3x3 eigenvector agrees to ~1e-5.
    w = valid[..., None]
    mu = (pts * w).sum(1, keepdims=True) / np.maximum(w.sum(1, keepdims=True), 1)
    ev = np.linalg.eigvalsh(np.einsum("qki,qkj->qij", (pts - mu) * w, (pts - mu) * w))
    ok = np.asarray(okj) & (ev[:, 1] > 1e-2 * ev[:, 2])
    sgn = np.sign(np.sum(n(nt) * np.asarray(nj), -1))[:, None]
    np.testing.assert_allclose((n(nt) * sgn)[ok], np.asarray(nj)[ok], atol=1e-4)
    np.testing.assert_allclose((n(dt) * sgn[:, 0])[ok], np.asarray(dj)[ok], atol=2e-3)
    cov = np.einsum("qki,qkj->qij", pts[:, :3] - pts[:, :3].mean(1, keepdims=True),
                    pts[:, :3] - pts[:, :3].mean(1, keepdims=True)).astype(np.float32)
    np.testing.assert_allclose(n(tpf.smallest_eigval_sym3(t(cov))),
                               np.asarray(jpf.smallest_eigval_sym3(jnp.asarray(cov))),
                               rtol=1e-3, atol=1e-3)
    # closed-form eigenvalues vs float64 eigvalsh: the trigonometric form
    # cancels to ~1e-4 of the largest eigenvalue in float32 near
    # repeated roots, where arccos is steep
    lam0, lam1 = tpf.smallest_two_eigvals_sym3(t(cov))
    ev = np.linalg.eigvalsh(cov.astype(np.float64))
    for lam, ref in ((lam0, ev[:, 0]), (lam1, ev[:, 1])):
        assert np.all(np.abs(n(lam) - ref) <= 2e-4 * ev[:, 2])
    x = rng.normal(0, 5, (Q, 3)).astype(np.float32)
    np.testing.assert_allclose(np.abs(n(tpf.point_to_plane(t(x), nt, dt)))[ok],
                               np.abs(np.asarray(jpf.point_to_plane(jnp.asarray(x), nj, dj)))[ok],
                               atol=2e-3)


def test_camera_scan_stage_flush_and_plane_features(rng, scans):
    T_cl = np.linalg.inv(np.array([[0, 0, 1, 0], [-1, 0, 0, 0], [0, -1, 0, 0], [0, 0, 0, 1]],
                                  np.float64)).astype(np.float32)
    mj = jvm.create(1 << 14, 0.4)
    mt = tvm.create(1 << 14, 0.4, device="cpu")
    staged_j, staged_t, poses = [], [], []
    for scan, valid in scans:
        T_cw = random_poses(rng, 1, rot=0.02, trans=0.2)[0]
        poses.append(T_cw)
        sj = jlio.camera_scan_stage(jnp.asarray(scan), jnp.asarray(valid), jnp.asarray(T_cw),
                                    jnp.asarray(T_cl), jnp.float32(1.0), jnp.float32(0.4))
        st = tlio.camera_scan_stage(t(scan), t(valid), t(T_cw), t(T_cl), 1.0, 0.4)
        np.testing.assert_array_equal(n(st[1]), np.asarray(sj[1]))
        np.testing.assert_allclose(n(st[0]), np.asarray(sj[0]), rtol=0, atol=1e-4)
        staged_j.append(sj)
        staged_t.append(st)
    # flush the JAX staging into both maps so the key tests are exact
    pts = jnp.concatenate([p for p, _ in staged_j])
    val = jnp.concatenate([v for _, v in staged_j])
    center = np.array([0.5, 0.1, 0.0], np.float32)
    mj = jlio.camera_map_flush(mj, pts, val, jnp.asarray(center))
    mt = tlio.camera_map_flush(mt, t(np.asarray(pts)), t(np.asarray(val)), t(center))
    _vm_eq(mt, mj)
    cfg = jlio.LioConfig(scan_voxel=0.4, map_voxel=0.4, blind=1.0)
    scan, valid = scans[1]
    T_wl = (np.linalg.inv(poses[1]) @ T_cl).astype(np.float32)
    pj = jlio.select_plane_features(mj, jnp.asarray(scan), jnp.asarray(valid), jnp.asarray(T_wl), cfg)
    pt = tlio.select_plane_features(mt, t(scan), t(valid), t(T_wl), tlio.LioConfig(*cfg))
    # a point on the 0.1 m plane-residual or the s > 0.9 gate boundary can
    # flip with float32 rounding of the plane normal
    agree = (n(pt) == np.asarray(pj)).mean()
    assert agree >= 0.995 and np.asarray(pj).sum() > 100, agree
