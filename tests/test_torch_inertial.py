"""Parity: the port's inertial solvers (visual-inertial initialization,
LVI-BA, the per-frame pose-inertial optimizers) against the JAX package, on
the fixtures of tests/test_inertial_init.py, test_inertial_ba.py and
test_pose_inertial.py (made with numpy from a seed, converted for the port).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_inertial_ba import CAM as JCAM, GRAV, simulate_window
from test_inertial_init import simulate
from test_pose_inertial import _make_scene, _perturbed
from test_solver import make_balm_window
from tc2li_slam_tpu.estimation import imu as jimu
from tc2li_slam_tpu.geom import lie as jlie
from tc2li_slam_tpu.solver import balm as jbalm, inertial_ba as jiba, inertial_init as jinit, \
    pose_inertial as jpi
from tc2li_slam_torch import interop
from tc2li_slam_torch.geom import camera as tcam
from tc2li_slam_torch.solver import balm as tbalm, inertial_ba as tiba, inertial_init as tinit, \
    lm as tlm, pose_inertial as tpi
from torch_parity import n, t

TCAM = tcam.Pinhole.create(500.0, 500.0, 320.0, 240.0, bf=250.0)


def tt(a):
    """A JAX array or numpy array as a float32 / bool / int32 CPU tensor."""
    a = np.asarray(a)
    return t(a.astype(np.float32) if a.dtype == np.float64 else a)


def conv(tup, cls):
    """A JAX NamedTuple of arrays as the port's NamedTuple ``cls``."""
    return cls(*[tt(a) for a in tup])


# --- inertial_init --------------------------------------------------------------------

def init_problem(rng):
    T_wb, vels, gyr, acc, g_w, bg_true, ba_true, kf_dt = simulate(rng)
    calib = jimu.ImuCalib.create(1e-4, 1e-3, 1e-6, 1e-5)
    pres = [jimu.integrate(calib, jnp.asarray(g, jnp.float32), jnp.asarray(a, jnp.float32),
                           jnp.full(len(g), 0.01, jnp.float32), jnp.zeros(3), jnp.zeros(3))
            for g, a in zip(gyr, acc)]
    K = T_wb.shape[0]
    args = [jnp.asarray(T_wb, jnp.float32)]
    args += [jnp.stack([getattr(p, f) for p in pres])
             for f in ("dR", "dV", "dP", "JRg", "JVg", "JVa", "JPg", "JPa")]
    args += [jnp.full(K - 1, kf_dt, jnp.float32),
             jnp.stack([jnp.linalg.inv(p.C[:9, :9] + 1e-8 * jnp.eye(9)) for p in pres]),
             jnp.zeros((K - 1, 3)), jnp.zeros((K - 1, 3)), jnp.ones(K - 1, bool)]
    return args, jnp.asarray(vels, jnp.float32) + 0.3, (g_w, bg_true, ba_true, vels)


def test_gravity_direction_and_rwg(rng):
    args, _, (g_w, *_rest) = init_problem(rng)
    R_wb, dV, valid = args[0][:, :3, :3], args[2], args[13]
    valid = valid.at[2].set(False)
    np.testing.assert_allclose(
        n(tinit.estimate_gravity_direction(tt(R_wb), tt(dV), tt(valid))),
        n(jinit.estimate_gravity_direction(R_wb, dV, valid)), atol=1e-6)
    for g in (g_w, [0.0, 0.0, -9.81], [0.0, 0.0, 9.81], [3.0, -9.0, 1.0]):
        g = np.asarray(g, np.float32)
        np.testing.assert_allclose(n(tinit.gravity_to_rwg(t(g))),
                                   n(jinit.gravity_to_rwg(jnp.asarray(g))), atol=1e-6)


@pytest.mark.parametrize("fix_gravity,prior_a", [(False, 1e4), (True, 1e6)])
def test_inertial_optimization(rng, fix_gravity, prior_a):
    args, vel0, (g_w, bg_true, ba_true, vels) = init_problem(rng)
    R_wg0 = jinit.estimate_gravity_direction(args[0][:, :3, :3], args[2], args[13])
    kw = dict(prior_g=1e2, prior_a=prior_a, fix_scale=True, fix_gravity=fix_gravity)
    ref = jinit.inertial_optimization(*args, R_wg0, vel0, **kw)
    got = tinit.inertial_optimization(*[tt(a) for a in args], tt(R_wg0), tt(vel0), **kw)
    # 20 damped Gauss-Newton steps in float32 on whitened residuals of 1e3
    # and more; measured 1.4e-7 on R_wg, 5e-9 on bg, 1.5e-6 on ba, 3.6e-7 m/s,
    # the cost 1.2e-5 relative
    np.testing.assert_allclose(n(got.R_wg), n(ref.R_wg), atol=1e-5)
    np.testing.assert_allclose(n(got.bg), n(ref.bg), atol=1e-6)
    np.testing.assert_allclose(n(got.ba), n(ref.ba), atol=1e-4)
    np.testing.assert_allclose(n(got.vel), n(ref.vel), atol=1e-4)
    np.testing.assert_allclose(float(got.cost), float(ref.cost), rtol=1e-3, atol=1e-3)
    assert float(got.scale) == 1.0
    if fix_gravity:
        np.testing.assert_allclose(n(got.R_wg), n(R_wg0), atol=1e-6)
    else:
        # the port alone recovers the simulated truth, as the reference's test asks
        g_est = n(got.R_wg) @ np.array([0.0, 0.0, -9.81])
        ang = np.degrees(np.arccos(np.clip(g_est @ g_w / (9.81 * np.linalg.norm(g_w)), -1, 1)))
        assert ang < 1.0
        assert np.linalg.norm(n(got.bg) - bg_true) < 5e-4
        assert np.abs(n(got.vel) - vels).max() < 0.05


def test_inertial_optimization_free_scale(rng):
    args, vel0, _ = init_problem(rng)
    R_wg0 = jinit.estimate_gravity_direction(args[0][:, :3, :3], args[2], args[13])
    kw = dict(prior_g=1e2, prior_a=1e4, fix_scale=False, iters=8)
    ref = jinit.inertial_optimization(*args, R_wg0, vel0, **kw)
    got = tinit.inertial_optimization(*[tt(a) for a in args], tt(R_wg0), tt(vel0), **kw)
    np.testing.assert_allclose(float(got.scale), float(ref.scale), atol=2e-3)
    np.testing.assert_allclose(n(got.vel), n(ref.vel), atol=5e-3)


def test_apply_scaled_rotation(rng):
    from torch_parity import random_poses
    T = random_poses(rng, 6)
    X = rng.normal(0, 5, (50, 3)).astype(np.float32)
    v = rng.normal(0, 1, (6, 3)).astype(np.float32)
    R = random_poses(rng, 1)[0, :3, :3]
    ref = jinit.apply_scaled_rotation(jnp.asarray(T), jnp.asarray(X), jnp.asarray(v),
                                      jnp.asarray(R), 1.3)
    got = tinit.apply_scaled_rotation(t(T), t(X), t(v), t(R), 1.3)
    for g_, r_ in zip(got, ref):
        np.testing.assert_allclose(n(g_), n(r_), rtol=1e-5, atol=1e-5)


# --- inertial_ba ----------------------------------------------------------------------

def lvi_problem(rng, rot_noise, vel_noise, lm_noise):
    T_gt, vels, fac, X, obs = simulate_window(rng)
    P = len(T_gt)
    T0, v0 = T_gt.copy(), vels.copy()
    for i in range(1, P):
        T0[i] = T0[i] @ n(jlie.se3_exp(jnp.asarray(rng.normal(0, rot_noise, 6).astype(np.float32))))
        v0[i] += rng.normal(0, vel_noise, 3).astype(np.float32)
    X0 = X + rng.normal(0, lm_noise, X.shape).astype(np.float32)
    state0 = jiba.InertialState(T_wb=jnp.asarray(T0), vel=jnp.asarray(v0),
                                bg=jnp.zeros((P, 3)), ba=jnp.zeros((P, 3)))
    fixed = np.zeros(P, bool)
    fixed[0] = True
    return T_gt, vels, fac, X0, obs, state0, fixed


def assert_lvi_close(got, ref, T_gt):
    # 10 LM iterations in float32 with information up to 1e6 beside O(1)
    # visual terms; measured without BALM 5e-7 on poses, 1e-6 m/s, 4e-8 and
    # 8e-7 on the biases, 3e-5 m on landmarks
    np.testing.assert_allclose(n(got.state.T_wb), n(ref.state.T_wb), atol=1e-4)
    np.testing.assert_allclose(n(got.state.vel), n(ref.state.vel), atol=1e-3)
    np.testing.assert_allclose(n(got.state.bg), n(ref.state.bg), atol=1e-5)
    np.testing.assert_allclose(n(got.state.ba), n(ref.state.ba), atol=1e-3)
    np.testing.assert_allclose(n(got.X_w), n(ref.X_w), atol=2e-3)
    np.testing.assert_allclose(float(got.cost), float(ref.cost), rtol=0.05, atol=1e-3)
    assert np.mean(n(got.obs_inlier) == n(ref.obs_inlier)) > 0.99
    for i in range(1, len(T_gt)):
        err = n(jlie.se3_log(jnp.asarray(np.linalg.inv(T_gt[i]) @ n(got.state.T_wb)[i],
                                         dtype=jnp.float32)))
        assert np.abs(err).max() < 5e-3, f"KF {i}"


def test_imu_terms(rng):
    _, _, fac, _, _, state0, _ = lvi_problem(rng, 0.02, 0.1, 0.05)
    fac = fac._replace(valid=fac.valid.at[1].set(False))
    Hj, gj, cj = jiba._imu_terms(state0, fac, GRAV)
    Ht, gt_, ct = tiba._imu_terms(conv(state0, tiba.InertialState),
                                  conv(fac, tiba.ImuWindowFactors), tt(GRAV))
    scale = np.abs(n(Hj)).max()
    np.testing.assert_allclose(n(Ht), n(Hj), rtol=1e-3, atol=1e-5 * scale)
    np.testing.assert_allclose(n(gt_), n(gj), rtol=1e-3, atol=1e-5 * np.abs(n(gj)).max())
    np.testing.assert_allclose(float(ct), float(cj), rtol=1e-3)


def test_lvi_ba_visual_inertial(rng):
    T_gt, vels, fac, X0, obs, state0, fixed = lvi_problem(rng, 0.02, 0.1, 0.05)
    L = len(X0)
    ref = jiba.lvi_ba(JCAM, jnp.eye(4), state0, jnp.asarray(X0), obs, fac, jnp.asarray(fixed),
                      jnp.ones(L, bool), GRAV, iters=10)
    got = tiba.lvi_ba(TCAM, torch.eye(4), conv(state0, tiba.InertialState), t(X0),
                      conv(obs, tlm.BAObservations), conv(fac, tiba.ImuWindowFactors),
                      t(fixed), torch.ones(L, dtype=torch.bool), tt(GRAV), iters=10)
    assert_lvi_close(got, ref, T_gt)
    assert np.abs(n(got.state.vel) - vels).max() < 0.05


def test_lvi_ba_with_balm_edge(rng):
    T_gt, vels, fac, X0, obs, state0, fixed = lvi_problem(rng, 0.015, 0.05, 0.0)
    L = len(X0)
    pts, pvalid, _ = make_balm_window(rng, W=4, noise=0.005, poses=T_gt[:4])
    cj = jbalm.build_clusters(pts, pvalid, jnp.asarray(T_gt[:4]), max_voxels=256)
    ct = tbalm.VoxelClusters(*[tt(a) for a in cj])
    kw = dict(w_lidar=0.01, iters=10, use_balm=True, n_lidar=4)
    ref = jiba.lvi_ba(JCAM, jnp.eye(4), state0, jnp.asarray(X0), obs, fac, jnp.asarray(fixed),
                      jnp.ones(L, bool), GRAV, balm_clusters=cj, T_bl=jnp.eye(4), **kw)
    got = tiba.lvi_ba(TCAM, torch.eye(4), conv(state0, tiba.InertialState), t(X0),
                      conv(obs, tlm.BAObservations), conv(fac, tiba.ImuWindowFactors),
                      t(fixed), torch.ones(L, dtype=torch.bool), tt(GRAV), balm_clusters=ct,
                      T_bl=torch.eye(4), **kw)
    assert_lvi_close(got, ref, T_gt)


def test_lvi_ba_padded_window(rng):
    """The padded form System uses: the last slot invalid (fixed, identity
    state, no observation, invalid factor) changes nothing for the others."""
    T_gt, vels, fac, X0, obs, state0, fixed = lvi_problem(rng, 0.02, 0.1, 0.05)
    L, P = len(X0), len(T_gt)
    fixed[P - 1] = True
    state0 = state0._replace(T_wb=state0.T_wb.at[P - 1].set(jnp.eye(4)),
                             vel=state0.vel.at[P - 1].set(0.0))
    fac = fac._replace(valid=fac.valid.at[P - 2].set(False))
    obs = obs._replace(valid=obs.valid & (obs.pose_idx != P - 1))
    ref = jiba.lvi_ba(JCAM, jnp.eye(4), state0, jnp.asarray(X0), obs, fac, jnp.asarray(fixed),
                      jnp.ones(L, bool), GRAV, iters=6)
    got = tiba.lvi_ba(TCAM, torch.eye(4), conv(state0, tiba.InertialState), t(X0),
                      conv(obs, tlm.BAObservations), conv(fac, tiba.ImuWindowFactors),
                      t(fixed), torch.ones(L, dtype=torch.bool), tt(GRAV), iters=6)
    np.testing.assert_allclose(n(got.state.T_wb), n(ref.state.T_wb), atol=1e-4)
    np.testing.assert_array_equal(n(got.state.T_wb)[P - 1], np.eye(4, dtype=np.float32))
    np.testing.assert_allclose(n(got.state.vel), n(ref.state.vel), atol=1e-3)


# --- pose_inertial --------------------------------------------------------------------

def assert_vi_result_close(got, ref, pos_atol=2e-5):
    # 12 damped steps in float32; measured 6e-8 on the pose, 2e-8 m/s, 6e-8
    # and 1e-7 on the biases, 1e-6 of the prior's largest entry
    np.testing.assert_allclose(n(got.state.T_wb), n(ref.state.T_wb), atol=pos_atol)
    np.testing.assert_allclose(n(got.state.vel), n(ref.state.vel), atol=1e-4)
    np.testing.assert_allclose(n(got.state.bg), n(ref.state.bg), atol=1e-5)
    np.testing.assert_allclose(n(got.state.ba), n(ref.state.ba), atol=1e-4)
    assert int(got.n_inliers) == int(ref.n_inliers) and got.n_inliers.dtype == torch.int32
    np.testing.assert_array_equal(n(got.inliers), n(ref.inliers))
    Hr = n(ref.prior.H)
    np.testing.assert_allclose(n(got.prior.H), Hr, rtol=1e-3, atol=1e-4 * np.abs(Hr).max())
    assert float(got.prior.weight) == float(ref.prior.weight) == 1.0
    np.testing.assert_allclose(n(got.prior.state.T_wb), n(got.state.T_wb))


def vi_args(X, uv, valid=None):
    O = X.shape[0]
    valid = np.ones(O, bool) if valid is None else np.asarray(valid)
    j_args = (X, uv, jnp.ones(O), jnp.ones(O, bool), jnp.asarray(valid),
              jnp.float32(1e4), jnp.float32(1e3))
    t_args = (tt(X), tt(uv), torch.ones(O), torch.ones(O, dtype=torch.bool), t(valid),
              torch.tensor(1e4), torch.tensor(1e3))
    return j_args, t_args


@pytest.mark.parametrize("n_pts,seed", [(60, 0), (3, 1)])
def test_optimize_last_kf(n_pts, seed):
    rng = np.random.default_rng(seed)
    cal, cam, anchor, gt, pre, X, uv = _make_scene(rng, n_pts)
    s0 = _perturbed(gt, rng)
    j_args, t_args = vi_args(X, uv)
    ref = jpi.optimize_last_kf(cam, jnp.eye(4), s0, anchor, pre, GRAV, *j_args)
    got = tpi.optimize_last_kf(TCAM, torch.eye(4), conv(s0, tpi.FrameVIState),
                               conv(anchor, tpi.FrameVIState),
                               interop.preintegrated_from_numpy(pre), tt(GRAV), *t_args)
    assert_vi_result_close(got, ref)
    err = np.linalg.norm(n(got.state.T_wb)[:3, 3] - n(gt.T_wb)[:3, 3])
    assert err < (0.01 if n_pts > 3 else 0.05)


def test_optimize_last_frame_prior_chain():
    """Two hops: last-keyframe solve, then last-frame with the first hop's
    marginalization prior; then a third with the second's, in the port."""
    rng = np.random.default_rng(2)
    cal, cam, anchor, gt, pre, X, uv = _make_scene(rng, 40)
    s0 = _perturbed(gt, rng)
    j_args, t_args = vi_args(X, uv)
    ref1 = jpi.optimize_last_kf(cam, jnp.eye(4), s0, anchor, pre, GRAV, *j_args)
    got1 = tpi.optimize_last_kf(TCAM, torch.eye(4), conv(s0, tpi.FrameVIState),
                                conv(anchor, tpi.FrameVIState),
                                interop.preintegrated_from_numpy(pre), tt(GRAV), *t_args)
    _, _, _, _, pre2, _, _ = _make_scene(rng, 40)
    R2g, p2g, _ = jimu.predict_state(pre2, gt.T_wb[:3, :3], gt.T_wb[:3, 3], gt.vel,
                                     jnp.zeros(3), jnp.zeros(3), GRAV)
    T_gt2 = jnp.eye(4).at[:3, :3].set(R2g).at[:3, 3].set(p2g)
    X2w = np.stack([np.random.default_rng(5).uniform(-4, 4, 40),
                    np.random.default_rng(6).uniform(-2, 2, 40),
                    np.random.default_rng(7).uniform(6, 20, 40)], -1).astype(np.float32)
    from tc2li_slam_tpu.geom import camera as jcam
    Xc2 = jlie.se3_apply(jlie.se3_inverse(T_gt2), jnp.asarray(X2w))
    uv2 = jcam.project_stereo(cam, Xc2)
    ok2 = np.asarray(Xc2[:, 2] > 0.5)
    T0_2 = T_gt2 @ jlie.se3_exp(jnp.asarray([0.08, -0.05, 0.04, 0.01, -0.02, 0.015], jnp.float32))
    j_args, t_args = vi_args(jnp.asarray(X2w), uv2, ok2)
    # both packages continue from the reference's first hop, so the second
    # hop is compared on equal inputs
    s0_2 = jpi.FrameVIState(T_wb=T0_2, vel=ref1.state.vel, bg=jnp.zeros(3), ba=jnp.zeros(3))
    ref2 = jpi.optimize_last_frame(cam, jnp.eye(4), s0_2, ref1.state, ref1.prior, pre2, GRAV,
                                   *j_args)
    prior1 = tpi.FramePrior(conv(ref1.prior.state, tpi.FrameVIState), tt(ref1.prior.H),
                            tt(ref1.prior.weight))
    got2 = tpi.optimize_last_frame(
        TCAM, torch.eye(4), conv(s0_2, tpi.FrameVIState), conv(ref1.state, tpi.FrameVIState),
        prior1, interop.preintegrated_from_numpy(pre2), tt(GRAV), *t_args)
    assert_vi_result_close(got1, ref1)
    assert_vi_result_close(got2, ref2)
    assert np.linalg.norm(n(got2.state.T_wb)[:3, 3] - n(T_gt2)[:3, 3]) < 0.02
    Hm = n(got2.prior.H)
    assert np.isfinite(Hm).all() and np.allclose(Hm, Hm.T, atol=1e-3)
    w = np.linalg.eigvalsh(Hm)
    assert w.min() > -1e-2 * max(w.max(), 1.0)
    # a prior of weight 0 is no prior: same as an empty one
    off = tpi.FramePrior(prior1.state, prior1.H, torch.zeros(()))
    a = tpi.optimize_last_frame(
        TCAM, torch.eye(4), conv(s0_2, tpi.FrameVIState), conv(ref1.state, tpi.FrameVIState),
        off, interop.preintegrated_from_numpy(pre2), tt(GRAV), *t_args)
    b = tpi.optimize_last_frame(
        TCAM, torch.eye(4), conv(s0_2, tpi.FrameVIState), conv(ref1.state, tpi.FrameVIState),
        tpi.FramePrior.empty(), interop.preintegrated_from_numpy(pre2), tt(GRAV), *t_args)
    np.testing.assert_allclose(n(a.state.T_wb), n(b.state.T_wb), atol=1e-6)
