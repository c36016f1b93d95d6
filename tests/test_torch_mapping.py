"""Parity: solvers (pose-only LM, Schur local BA, BALM eigen-factor), local
mapping and culling of tc2li_slam_torch vs tc2li_slam_tpu."""

import jax.numpy as jnp
import numpy as np
import pytest

from tc2li_slam_tpu.geom import camera as jcam
from tc2li_slam_tpu.slam import culling as jcul, local_mapping as jlm
from tc2li_slam_tpu.solver import balm as jbalm, lm as jlmo
from tc2li_slam_torch import interop
from tc2li_slam_torch.geom import camera as tcam
from tc2li_slam_torch.slam import culling as tcul, local_mapping as tlm
from tc2li_slam_torch.solver import balm as tbalm, lm as tlmo
from torch_parity import jax_midsequence, n, random_poses, t

# Iterated float32 solvers in two libraries (other summation orders in the
# normal equations): poses to 1e-4, landmarks to 1e-3 m, costs to 1e-4 rel.
POSE_ATOL, LM_ATOL, COST_RTOL = 1e-4, 1e-3, 1e-4

CAM_ARGS = (320.0, 320.0, 320.0, 120.0)
CAM_KW = dict(bf=160.0, width=640, height=240)


def test_inv3x3_and_precond_solve(rng):
    A = rng.normal(0, 1, (50, 3, 3)).astype(np.float32)
    A = A @ A.transpose(0, 2, 1) + 0.1 * np.eye(3, dtype=np.float32)
    np.testing.assert_allclose(n(tlmo.inv3x3(t(A))), np.asarray(jlmo.inv3x3(jnp.asarray(A))),
                               rtol=1e-4, atol=1e-4)
    H = rng.normal(0, 1, (24, 24)).astype(np.float32)
    H = H @ H.T + np.diag(rng.uniform(1, 1e6, 24)).astype(np.float32)
    g = rng.normal(0, 1, 24).astype(np.float32)
    np.testing.assert_allclose(n(tlmo.precond_solve(t(H), t(g))),
                               np.asarray(jlmo.precond_solve(jnp.asarray(H), jnp.asarray(g))),
                               rtol=1e-3, atol=1e-7)


def _scene(rng, n_lm, T_true):
    X = np.concatenate([rng.uniform(-8, 8, (n_lm, 2)), rng.uniform(4, 30, (n_lm, 1))], 1)
    Xc = X @ T_true[:3, :3].T + T_true[:3, 3]
    uv = np.stack([320 * Xc[:, 0] / Xc[:, 2] + 320, 320 * Xc[:, 1] / Xc[:, 2] + 120,
                   320 * Xc[:, 0] / Xc[:, 2] + 320 - 160 / Xc[:, 2]], -1)
    uv += rng.normal(0, 0.5, uv.shape)
    uv[: n_lm // 10, :2] += rng.normal(0, 40, (n_lm // 10, 2))   # outliers
    return X.astype(np.float32), uv.astype(np.float32)


def test_pose_only_optimize(rng):
    T_true = random_poses(rng, 1, rot=0.05, trans=0.3)[0]
    X, uv = _scene(rng, 300, T_true)
    stereo = rng.random(300) > 0.3
    uv[~stereo, 2] = -1.0
    inv_s2 = (1.0 / 1.44 ** rng.integers(0, 4, 300)).astype(np.float32)
    valid = rng.random(300) > 0.05
    T0 = (T_true @ random_poses(rng, 1, rot=0.01, trans=0.05)[0]).astype(np.float32)
    rj = jlmo.pose_only_optimize(jcam.Pinhole.create(*CAM_ARGS, **CAM_KW), *map(jnp.asarray, (
        T0, X, uv, inv_s2, stereo, valid)))
    rt = tlmo.pose_only_optimize(tcam.Pinhole.create(*CAM_ARGS, **CAM_KW),
                                 *map(t, (T0, X, uv, inv_s2, stereo, valid)))
    np.testing.assert_allclose(n(rt.T_cw), np.asarray(rj.T_cw), atol=POSE_ATOL)
    np.testing.assert_array_equal(n(rt.inliers), np.asarray(rj.inliers))
    assert int(rt.n_inliers) == int(rj.n_inliers) > 200
    np.testing.assert_allclose(float(rt.cost), float(rj.cost), rtol=1e-3)


def _ba_problem(rng, P=4, L=300, K=4):
    T = random_poses(rng, P, rot=0.03, trans=0.5)
    X = np.concatenate([rng.uniform(-8, 8, (L, 2)), rng.uniform(4, 30, (L, 1))], 1).astype(np.float32)
    pose_idx = np.stack([rng.permutation(P)[:K] for _ in range(L)]).astype(np.int32)
    uv = np.zeros((L, K, 3), np.float32)
    for l in range(L):
        for k in range(K):
            Tp = T[pose_idx[l, k]]
            xc = Tp[:3, :3] @ X[l] + Tp[:3, 3]
            uv[l, k] = [320 * xc[0] / xc[2] + 320, 320 * xc[1] / xc[2] + 120,
                        320 * xc[0] / xc[2] + 320 - 160 / xc[2]]
    uv += rng.normal(0, 0.7, uv.shape).astype(np.float32)
    stereo = rng.random((L, K)) > 0.4
    uv[~stereo, 2] = -1.0
    obs = dict(pose_idx=pose_idx, uv=uv, inv_sigma2=np.ones((L, K), np.float32),
               stereo=stereo, valid=rng.random((L, K)) > 0.1)
    T0 = (T @ random_poses(rng, P, rot=0.003, trans=0.02)).astype(np.float32)
    X0 = (X + rng.normal(0, 0.05, X.shape)).astype(np.float32)
    fixed = np.array([True] + [False] * (P - 1))
    return T0, X0, obs, fixed, rng.random(L) > 0.02


def test_local_ba_visual(rng):
    T0, X0, obs, fixed, vlm = _ba_problem(rng)
    rj = jlmo.local_ba(jcam.Pinhole.create(*CAM_ARGS, **CAM_KW), jnp.asarray(T0), jnp.asarray(X0),
                       jlmo.BAObservations(**{k: jnp.asarray(v) for k, v in obs.items()}),
                       jnp.asarray(fixed), jnp.asarray(vlm), iters=6)
    rt = tlmo.local_ba(tcam.Pinhole.create(*CAM_ARGS, **CAM_KW), t(T0), t(X0),
                       tlmo.BAObservations(**{k: t(v) for k, v in obs.items()}),
                       t(fixed), t(vlm), iters=6)
    np.testing.assert_allclose(n(rt.T_cw), np.asarray(rj.T_cw), atol=POSE_ATOL)
    np.testing.assert_allclose(n(rt.X_w), np.asarray(rj.X_w), atol=LM_ATOL)
    np.testing.assert_allclose(float(rt.cost), float(rj.cost), rtol=COST_RTOL)
    assert float(rt.cost) < float(jlmo.local_ba(
        jcam.Pinhole.create(*CAM_ARGS, **CAM_KW), jnp.asarray(T0), jnp.asarray(X0),
        jlmo.BAObservations(**{k: jnp.asarray(v) for k, v in obs.items()}),
        jnp.asarray(fixed), jnp.asarray(vlm), iters=0).cost)


def _planar_window(rng, W=4, M=3000):
    """Per-KF LiDAR points of a few planes seen from W nearby poses."""
    T_wl = random_poses(rng, W, rot=0.02, trans=0.3)
    pts = []
    for _ in range(W):
        u, v = rng.uniform(-3, 3, M), rng.uniform(-3, 3, M)
        face = rng.integers(0, 3, M)
        p = np.stack([u, v, np.zeros(M)], 1)
        p[face == 1] = np.stack([u, np.full(M, 4.0), v], 1)[face == 1]
        p[face == 2] = np.stack([np.full(M, -3.0), u, v], 1)[face == 2]
        p += rng.normal(0, 0.01, p.shape)
        pts.append(p)
    pw = np.stack(pts)
    # express each KF's points in its own frame
    pl = np.einsum("wji,wmj->wmi", T_wl[:, :3, :3], pw - T_wl[:, None, :3, 3])
    valid = rng.random((W, M)) > 0.05
    T_pert = (T_wl @ random_poses(rng, W, rot=0.002, trans=0.01)).astype(np.float32)
    return pl.astype(np.float32), valid, T_wl, T_pert


def test_balm_clusters_cost_quadratic(rng):
    pl, valid, T_wl, T_pert = _planar_window(rng)
    cj = jbalm.build_clusters(jnp.asarray(pl), jnp.asarray(valid), jnp.asarray(T_wl),
                              voxel_size=1.0, max_voxels=256, min_points=15)
    ct = tbalm.build_clusters(t(pl), t(valid), t(T_wl), voxel_size=1.0, max_voxels=256,
                              min_points=15)
    np.testing.assert_array_equal(n(ct.valid), np.asarray(cj.valid))
    np.testing.assert_array_equal(n(ct.N), np.asarray(cj.N))
    for k in ("mean", "Pc", "center"):   # float32 moment sums, same order
        np.testing.assert_allclose(n(getattr(ct, k)), np.asarray(getattr(cj, k)),
                                   rtol=1e-4, atol=1e-4, err_msg=k)
    assert int(np.asarray(cj.valid).sum()) > 20
    # from here both sides use the JAX clusters, so only the cost differs
    cjt = tbalm.VoxelClusters(*[t(np.asarray(a)) for a in cj])
    cost_j = float(jbalm.eigen_cost(cj, jnp.asarray(T_pert)))
    np.testing.assert_allclose(float(tbalm.eigen_cost(cjt, t(T_pert))), cost_j, rtol=1e-3)
    qj = jbalm.quadratic(cj, jnp.asarray(T_pert))
    qt = tbalm.quadratic(cjt, t(T_pert))
    # second derivatives through the closed-form smallest eigenvalue in f32:
    # 1e-3 of the largest entry
    scale_h = np.abs(np.asarray(qj.H)).max()
    np.testing.assert_allclose(n(qt.H), np.asarray(qj.H), rtol=0, atol=1e-3 * scale_h)
    scale_g = np.abs(np.asarray(qj.g)).max()
    np.testing.assert_allclose(n(qt.g), np.asarray(qj.g), rtol=0, atol=1e-3 * scale_g)
    np.testing.assert_allclose(float(qt.cost), float(qj.cost), rtol=1e-3)


@pytest.fixture(scope="module")
def mid():
    s, _ = jax_midsequence(5)
    m_np = {k: np.asarray(v) for k, v in s.map._asdict().items()}
    c = s.cfg.camera
    return dict(s=s, m_np=m_np,
                cam_t=tcam.Pinhole.create(c.fx, c.fy, c.cx, c.cy, bf=c.bf, width=c.width,
                                          height=c.height))


def test_run_local_ba_with_balm(mid):
    s = mid["s"]
    kf = s.n_kf_host - 1
    lc, tc = s.cfg.lidar, s.cfg.tracking
    covis = [np.asarray(a) for a in jax_map_covis(s, kf)]
    window, fixed = tlm.select_window(tc.local_window, kf, s.n_kf_host, s.kf_alive, covis)
    wj, fj = jlm.select_window(s.map, kf, tc.local_window, n_kf=s.n_kf_host, alive=s.kf_alive)
    assert (window, fixed) == (wj, fj)
    kw = dict(balm_window=lc.balm_window, balm_voxel=lc.balm_voxel,
              balm_max_voxels=lc.balm_max_voxels, balm_min_points=lc.balm_min_points,
              w_lba=lc.w_lba, iters=tc.ba_iters)
    mj = jlm.run_local_ba(s.map, s.lidar_store, kf, s.cam, s.sigma2, s.T_cl,
                          n_window=tc.local_window, n_kf=s.n_kf_host, window=window,
                          fixed=fixed, max_active=4096, **kw)
    mt = tlm.run_local_ba(interop.mapstate_from_numpy(mid["m_np"]),
                          interop.lidarstore_from_numpy(s.lidar_store._asdict()), mid["cam_t"],
                          t(np.asarray(s.sigma2)), t(np.asarray(s.T_cl)), window, fixed,
                          max_active=4096, **kw)
    moved = np.abs(np.asarray(mj.kf_T_cw) - mid["m_np"]["kf_T_cw"]).max()
    assert moved > 1e-5   # the BA did move the window
    np.testing.assert_allclose(n(mt.kf_T_cw), np.asarray(mj.kf_T_cw), atol=POSE_ATOL)
    np.testing.assert_allclose(n(mt.lm_pos), np.asarray(mj.lm_pos), atol=LM_ATOL)


def jax_map_covis(s, kf):
    from tc2li_slam_tpu.slam import mapstate as jms
    return jms.top_covisible(s.map, jnp.int32(kf), s.cfg.tracking.local_window - 1, min_weight=10)


def test_culling_and_fuse(mid, rng):
    s = mid["s"]
    mj = s.map
    mt = interop.mapstate_from_numpy(mid["m_np"])
    kf = s.n_kf_host - 1

    def same(a, b):
        for k, v in interop.mapstate_to_numpy(a).items():
            ref = np.asarray(getattr(b, k))
            assert v.dtype == ref.dtype, (k, v.dtype, ref.dtype)
            if ref.dtype.kind == "f":
                np.testing.assert_allclose(v, ref, rtol=1e-5, atol=1e-5, err_msg=k)
            else:
                np.testing.assert_array_equal(v, ref, err_msg=k)

    same(tcul.cull_landmarks(mt, kf + 3), jcul.cull_landmarks(mj, jnp.int32(kf + 3)))
    np.testing.assert_allclose(n(tcul.keyframe_redundancy(mt)),
                               np.asarray(jcul.keyframe_redundancy(mj)), rtol=1e-6)
    protect = np.zeros(mj.K, bool)
    protect[0] = True
    for thresh in (0.9, 0.0):
        a, ka = tcul.cull_keyframes(mt, t(protect), thresh=thresh)
        b, kb = jcul.cull_keyframes(mj, jnp.asarray(protect), thresh=thresh)
        assert int(ka) == int(kb)
        same(a, b)
    assert int(kb) >= 0
    for k in (kf, kf - 1):
        same(tcul.fuse_into_keyframe(mt, k, mid["cam_t"], t(np.asarray(s.scale_factors))),
             jcul.fuse_into_keyframe(mj, jnp.int32(k), s.cam, s.scale_factors))
    same(tcul.fuse_duplicates(mt, radius=0.5), jcul.fuse_duplicates(mj, radius=0.5))
