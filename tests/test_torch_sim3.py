"""Parity: the Sim(3) group, Umeyama, the Sim3 RANSAC and the pose-graph
optimizer of tc2li_slam_torch vs tc2li_slam_tpu, on the same numpy inputs.

The port's ``umeyama`` takes the rotation from Horn's quaternion (no SVD);
its RANSAC takes the triples the JAX key draws (``jax_sample_idx``); its
pose graph assembles per-edge Jacobian blocks instead of one dense Jacobian.
Tolerances are stated per test."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tc2li_slam_tpu.geom import lie as jlie
from tc2li_slam_tpu.solver import sim3 as jsim3
from tc2li_slam_torch import interop
from tc2li_slam_torch.geom import lie as tlie
from tc2li_slam_torch.solver import sim3 as tsim3
from test_torch_pnp import jax_sample_idx
from torch_parity import n, t

GROUP_ATOL = 1e-5


def _tangents(rng, k=40):
    """sim3 tangents covering the three branches of W: generic, theta -> 0,
    and theta -> 0 with sigma -> 0 (and sigma -> 0 alone)."""
    xi = rng.uniform(-0.8, 0.8, (k, 7)).astype(np.float32)
    xi[:10, 3:6] *= 1e-3          # small rotation
    xi[5:15, 6] *= 1e-3           # small log-scale (rows 5..9: both small)
    xi[15] = 0.0                  # the identity
    return xi


def test_sim3_exp_log_round_trip(rng):
    """exp and log against the JAX package to 1e-5, and log(exp(xi)) = xi."""
    xi = _tangents(rng)
    Sj = np.asarray(jlie.sim3_exp(jnp.asarray(xi)))
    St = tlie.sim3_exp(t(xi))
    assert St.dtype == torch.float32 and St.shape == (40, 4, 4)
    np.testing.assert_allclose(n(St), Sj, atol=GROUP_ATOL)
    np.testing.assert_allclose(n(tlie.sim3_log(t(Sj))), np.asarray(jlie.sim3_log(jnp.asarray(Sj))),
                               atol=GROUP_ATOL)
    np.testing.assert_allclose(n(tlie.sim3_log(St)), xi, atol=GROUP_ATOL)


@pytest.mark.parametrize("rows", [slice(0, 5), slice(5, 10), slice(10, 15), slice(15, 40)],
                         ids=["theta0", "theta0_sigma0", "sigma0", "generic"])
def test_sim3_W_branches(rng, rows):
    """Each Taylor branch of the translation matrix W to 1e-6."""
    xi = _tangents(rng)[rows]
    phi, sigma = xi[:, 3:6], xi[:, 6]
    theta = np.linalg.norm(phi, axis=-1).astype(np.float32)
    Wj = np.asarray(jlie._sim3_W(jnp.asarray(theta), jnp.asarray(sigma), jnp.asarray(phi),
                                 jnp.float32))
    np.testing.assert_allclose(n(tlie._sim3_W(t(theta), t(sigma), t(phi))), Wj, atol=1e-6)


def test_sim3_parts_inverse_apply(rng):
    """scale, rotation, inverse and apply to 1e-5; S S^-1 = I."""
    S = np.asarray(jlie.sim3_exp(jnp.asarray(_tangents(rng))))
    p = rng.normal(0, 3, (40, 3)).astype(np.float32)
    np.testing.assert_allclose(n(tlie.sim3_scale(t(S))), np.asarray(jlie.sim3_scale(jnp.asarray(S))),
                               atol=1e-6)
    np.testing.assert_allclose(n(tlie.sim3_rotation(t(S))),
                               np.asarray(jlie.sim3_rotation(jnp.asarray(S))), atol=1e-6)
    Si = tlie.sim3_inverse(t(S))
    np.testing.assert_allclose(n(Si), np.asarray(jlie.sim3_inverse(jnp.asarray(S))), atol=GROUP_ATOL)
    np.testing.assert_allclose(n(t(S) @ Si), np.tile(np.eye(4, dtype=np.float32), (40, 1, 1)),
                               atol=GROUP_ATOL)
    np.testing.assert_allclose(n(tlie.sim3_apply(t(S), t(p))),
                               np.asarray(jlie.sim3_apply(jnp.asarray(S), jnp.asarray(p))),
                               atol=GROUP_ATOL)
    s = rng.uniform(0.5, 2.0, 40).astype(np.float32)
    np.testing.assert_allclose(
        n(tlie.sim3(t(s), t(S[:, :3, :3]), t(p))),
        np.asarray(jlie.sim3(jnp.asarray(s), jnp.asarray(S[:, :3, :3]), jnp.asarray(p))), atol=1e-6)


def test_solve3_and_quaternions(rng):
    """The adjugate 3x3 solve against numpy to 1e-5; quat_to_mat and
    mat_to_quat against the JAX package to 1e-6, each pivot branch hit."""
    A = (np.eye(3) + rng.normal(0, 0.3, (32, 3, 3))).astype(np.float32)
    b = rng.normal(0, 1, (32, 3)).astype(np.float32)
    np.testing.assert_allclose(n(tlie.solve3(t(A), t(b))),
                               np.linalg.solve(A.astype(np.float64), b[..., None])[..., 0], atol=1e-5)
    q = rng.normal(0, 1, (64, 4)).astype(np.float32)
    q[:4] = np.eye(4)             # pure w, x, y, z: the four pivots
    Rj = np.asarray(jlie.quat_to_mat(jnp.asarray(q)))
    np.testing.assert_allclose(n(tlie.quat_to_mat(t(q))), Rj, atol=1e-6)
    qt = n(tlie.mat_to_quat(t(Rj)))
    np.testing.assert_allclose(qt, np.asarray(jlie.mat_to_quat(jnp.asarray(Rj))), atol=1e-6)
    np.testing.assert_allclose(n(tlie.quat_to_mat(t(qt))), Rj, atol=1e-5)


def _aligned_sets(rng, batch=8, npts=30):
    src = rng.normal(0, 5, (batch, npts, 3)).astype(np.float32)
    xi = rng.uniform(-0.6, 0.6, (batch, 7)).astype(np.float32)
    S = np.asarray(jlie.sim3_exp(jnp.asarray(xi)))
    dst = np.einsum("bij,bnj->bni", S[:, :3, :3], src) + S[:, None, :3, 3]
    return src, dst.astype(np.float32), S


def _umeyama_both(src, dst, w, with_scale):
    Sj = np.asarray(jsim3.umeyama(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(w), with_scale))
    return n(tsim3.umeyama(t(src), t(dst), t(w), with_scale)), Sj


@pytest.mark.parametrize("with_scale", [True, False])
@pytest.mark.parametrize("kind", ["full_rank", "three_points", "planar", "mirrored", "weighted"])
def test_umeyama_matches_jax(rng, kind, with_scale):
    """Horn's rotation against the reference's SVD to 1e-4 (translations of
    ~10 m in float32): on full-rank sets with noise, on exact 3-point sets
    (rank-2 covariance), on a planar set, on a mirrored set (the reflection
    case: the best proper rotation) and with 0/1 weights."""
    src, dst, S = _aligned_sets(rng)
    w = np.ones(src.shape[:2], np.float32)
    if kind == "full_rank":
        dst = dst + rng.normal(0, 0.1, dst.shape).astype(np.float32)
    elif kind == "three_points":
        src, dst, w = src[:, :3], dst[:, :3], w[:, :3]
    elif kind == "planar":
        src = src.copy()
        src[..., 2] = 0.0
        dst = (np.einsum("bij,bnj->bni", S[:, :3, :3], src) + S[:, None, :3, 3]).astype(np.float32)
    elif kind == "mirrored":
        dst = dst.copy()
        dst[..., 0] *= -1.0
    else:
        w = (rng.uniform(0, 1, w.shape) > 0.4).astype(np.float32)
        dst = dst.copy()
        dst[w == 0] += 50.0       # what a zero weight must ignore
    St, Sj = _umeyama_both(src, dst, w, with_scale)
    assert St.dtype == np.float32
    np.testing.assert_allclose(St, Sj, atol=1e-4)
    R = St[:, :3, :3] / np.cbrt(np.linalg.det(St[:, :3, :3]))[:, None, None]
    np.testing.assert_allclose(np.linalg.det(R), 1.0, atol=1e-4)
    if kind in ("three_points", "planar", "weighted") and with_scale:
        np.testing.assert_allclose(St, S, atol=2e-3)   # the exact transform comes back


def test_umeyama_no_points():
    """All weights zero: the identity rotation, finite, in both."""
    src = np.zeros((5, 3), np.float32)
    St, Sj = _umeyama_both(src, src, np.zeros(5, np.float32), False)
    np.testing.assert_allclose(St, Sj, atol=1e-6)
    np.testing.assert_allclose(St, np.eye(4), atol=1e-6)


@pytest.mark.parametrize("seed,with_scale", [(0, True), (2, False)])
def test_sim3_ransac_matches_jax(rng, seed, with_scale):
    """25% outliers, the triples the JAX key draws: the same inlier mask and
    count, S to 1e-4."""
    N = 100
    src = rng.normal(0, 5, (N, 3)).astype(np.float32)
    xi = rng.uniform(-0.4, 0.4, 7).astype(np.float32)
    xi[6] = 0.2 if with_scale else 0.0
    S_gt = np.asarray(jlie.sim3_exp(jnp.asarray(xi)))
    dst = (src @ S_gt[:3, :3].T + S_gt[:3, 3] + rng.normal(0, 0.02, (N, 3))).astype(np.float32)
    dst[:25] += rng.uniform(3, 10, (25, 3)).astype(np.float32)
    valid = np.ones(N, bool)
    valid[-6:] = False
    key = jax.random.PRNGKey(seed)
    rj = jsim3.sim3_ransac(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(valid), key,
                           with_scale=with_scale)
    rt = tsim3.sim3_ransac(t(src), t(dst), t(valid), with_scale=with_scale,
                           sample_idx=t(jax_sample_idx(key, valid, 128, 3)))
    assert bool(rj.ok) and bool(rt.ok)
    assert rt.n_inliers.dtype == torch.int32 and int(rt.n_inliers) == int(rj.n_inliers)
    np.testing.assert_array_equal(n(rt.inliers), np.asarray(rj.inliers))
    np.testing.assert_allclose(n(rt.S), np.asarray(rj.S), atol=1e-4)
    inl = n(rt.inliers)
    assert inl[:25].mean() < 0.2 and inl[25:-6].mean() > 0.9 and not inl[-6:].any()
    np.testing.assert_allclose(n(rt.S), S_gt, atol=0.05)


def test_sim3_ransac_generator_and_garbage(rng):
    """The port's own draw (a generator) finds the same transform; garbage
    is not ok; neither generator nor indices raises."""
    N = 80
    src = rng.normal(0, 5, (N, 3)).astype(np.float32)
    S_gt = np.asarray(jlie.sim3_exp(jnp.asarray([0.5, -0.2, 0.3, 0.1, 0.2, -0.3, 0.0], jnp.float32)))
    dst = (src @ S_gt[:3, :3].T + S_gt[:3, 3]).astype(np.float32)
    dst[:20] += 5.0
    valid = torch.ones(N, dtype=torch.bool)
    res = tsim3.sim3_ransac(t(src), t(dst), valid, torch.Generator().manual_seed(1))
    assert bool(res.ok) and int(res.n_inliers) == 60
    np.testing.assert_allclose(n(res.S), S_gt, atol=1e-4)
    bad = tsim3.sim3_ransac(t(src), t(rng.normal(0, 5, (N, 3)).astype(np.float32)), valid,
                            torch.Generator().manual_seed(1))
    assert not bool(bad.ok) and np.isfinite(n(bad.S)).all()
    with pytest.raises(ValueError):
        tsim3.sim3_ransac(t(src), t(dst), valid)


def _drift_chain(rng, K=12):
    """tests/test_sim3_loop.py's drift case: a chain of K poses with drift
    in every relative motion, and an exact loop edge K-1 -> 0."""
    step = np.asarray(jlie.se3_exp(jnp.asarray([1.0, 0, 0, 0, 0, 2 * np.pi / K], jnp.float32)))
    T_gt = [np.eye(4, dtype=np.float32)]
    for _ in range(K - 1):
        T_gt.append((T_gt[-1] @ np.linalg.inv(step)).astype(np.float32))
    T_gt = np.stack(T_gt)
    T_est = [T_gt[0]]
    for i in range(K - 1):
        rel = T_gt[i + 1] @ np.linalg.inv(T_gt[i])
        noise = np.asarray(jlie.se3_exp(jnp.asarray(rng.normal(0, 0.02, 6).astype(np.float32))))
        T_est.append((noise @ rel @ T_est[-1]).astype(np.float32))
    T_est = np.stack(T_est)
    ii = list(range(K - 1)) + [K - 1]
    jj = list(range(1, K)) + [0]
    S_ij = [T_est[i] @ np.linalg.inv(T_est[i + 1]) for i in range(K - 1)]
    S_ij.append(T_gt[K - 1] @ np.linalg.inv(T_gt[0]))
    edges = jsim3.PoseGraphEdges(
        i=jnp.asarray(ii, jnp.int32), j=jnp.asarray(jj, jnp.int32),
        S_ij=jnp.asarray(np.stack(S_ij), jnp.float32),
        weight=jnp.asarray([1.0] * (K - 1) + [5.0], jnp.float32), valid=jnp.ones(K, bool))
    return T_gt, T_est, edges


def _loop_err(T, T_gt):
    K = len(T)
    rel = T[K - 1] @ np.linalg.inv(T[0])
    gt_rel = T_gt[K - 1] @ np.linalg.inv(T_gt[0])
    return np.linalg.norm(np.asarray(jlie.se3_log(jnp.asarray(np.linalg.inv(gt_rel) @ rel,
                                                              jnp.float32))))


def test_pose_graph_corrects_drift_like_jax(rng):
    """The drift case: poses to 1e-4 of the JAX optimizer's, and the loop
    edge's error falls below a fifth."""
    T_gt, T_est, edges = _drift_chain(rng)
    fixed = np.zeros(len(T_gt), bool)
    fixed[0] = True
    Sj = np.asarray(jsim3.pose_graph_optimize(jnp.asarray(T_est), edges, jnp.asarray(fixed), iters=15))
    et = interop.posegraph_edges_from_numpy(edges)
    assert et.i.dtype == torch.int32 and et.valid.dtype == torch.bool
    St = tsim3.pose_graph_optimize(t(T_est), et, t(fixed), iters=15)
    assert St.dtype == torch.float32
    np.testing.assert_allclose(n(St), Sj, atol=1e-4)
    np.testing.assert_array_equal(n(St)[0], T_est[0])
    assert _loop_err(n(St), T_gt) < 0.2 * _loop_err(T_est, T_gt) + 1e-3
    back = interop.posegraph_edges_to_numpy(et)
    np.testing.assert_array_equal(back["i"], np.asarray(edges.i))
    np.testing.assert_array_equal(back["S_ij"], np.asarray(edges.S_ij))


def test_pose_graph_fixed_and_invalid_edges(rng):
    """Two fixed poses, an edge switched off, an edge of weight zero and a
    wrong edge marked invalid: poses to 1e-4, fixed ones unmoved."""
    T_gt, T_est, edges = _drift_chain(rng, K=10)
    K = len(T_gt)
    wrong = np.asarray(jlie.se3_exp(jnp.asarray([3.0, 1, -2, 0.5, 0.2, -0.4], jnp.float32)))
    edges = jsim3.PoseGraphEdges(
        i=jnp.concatenate([edges.i, jnp.asarray([2, 7], jnp.int32)]),
        j=jnp.concatenate([edges.j, jnp.asarray([6, 3], jnp.int32)]),
        S_ij=jnp.concatenate([edges.S_ij, jnp.asarray(np.stack([wrong, wrong]))]),
        weight=jnp.concatenate([edges.weight.at[4].set(0.0), jnp.asarray([2.0, 2.0])]),
        valid=jnp.concatenate([edges.valid.at[1].set(False), jnp.asarray([False, False])]))
    fixed = np.zeros(K, bool)
    fixed[[0, 5]] = True
    Sj = np.asarray(jsim3.pose_graph_optimize(jnp.asarray(T_est), edges, jnp.asarray(fixed), iters=10))
    St = n(tsim3.pose_graph_optimize(t(T_est), interop.posegraph_edges_from_numpy(edges),
                                     t(fixed), iters=10))
    np.testing.assert_allclose(St, Sj, atol=1e-4)
    np.testing.assert_array_equal(St[[0, 5]], T_est[[0, 5]])
    assert np.abs(St - T_est).max() > 1e-3


def test_pose_graph_scale_drift(rng):
    """Sim3 poses with scale drift (the monocular case): to 1e-4 as well."""
    T_gt, T_est, edges = _drift_chain(rng, K=8)
    scales = np.exp(np.linspace(0.0, 0.15, 8)).astype(np.float32)
    S_est = T_est.copy()
    S_est[:, :3, :3] *= scales[:, None, None]
    fixed = np.zeros(8, bool)
    fixed[0] = True
    Sj = np.asarray(jsim3.pose_graph_optimize(jnp.asarray(S_est), edges, jnp.asarray(fixed), iters=12))
    St = n(tsim3.pose_graph_optimize(t(S_est), interop.posegraph_edges_from_numpy(edges),
                                     t(fixed), iters=12))
    np.testing.assert_allclose(St, Sj, atol=1e-4)
