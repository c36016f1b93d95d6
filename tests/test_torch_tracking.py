"""Parity: frame build, tracking and the map pool of tc2li_slam_torch vs
tc2li_slam_tpu, both started from the same mid-sequence state (the JAX
System after 5 SMALL frames, carried over with ``tc2li_slam_torch.interop``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tc2li_slam_tpu.slam import mapstate as jms, tracking as jtr
from tc2li_slam_torch import interop
from tc2li_slam_torch.geom import camera as tcam
from tc2li_slam_torch.slam import mapstate as tms, tracking as ttr
from test_torch_pnp import jax_sample_idx
from torch_parity import jax_midsequence, n, t, words_u32

# poses after 40 LM iterations in float32 in two libraries
POSE_ATOL = 1e-4


@pytest.fixture(scope="module")
def mid():
    s, frames = jax_midsequence(5)
    m_np = {k: np.asarray(v) for k, v in s.map._asdict().items()}
    c = s.cfg.camera
    cam_t = tcam.Pinhole.create(c.fx, c.fy, c.cx, c.cy, bf=c.bf, width=c.width, height=c.height)
    fr = frames[5]
    frame_j = jtr.build_frame(jnp.asarray(fr.img_l), jnp.asarray(fr.img_r), s.cam,
                              s.scale_factors, n_features=512, n_levels=4)
    frame_t = ttr.Frame(*[t(np.asarray(a)) for a in frame_j])
    return dict(s=s, m_np=m_np, m_t=interop.mapstate_from_numpy(m_np), cam_t=cam_t,
                fr=fr, frame_j=frame_j, frame_t=frame_t,
                sf=n(s.scale_factors), sigma2=n(s.sigma2))


def test_interop_round_trip(mid):
    back = interop.mapstate_to_numpy(mid["m_t"])
    for k, v in mid["m_np"].items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    assert back["lm_desc"].dtype == np.uint32
    ls = mid["s"].lidar_store
    back = interop.lidarstore_to_numpy(interop.lidarstore_from_numpy(ls))
    for k, v in ls._asdict().items():
        np.testing.assert_array_equal(back[k], np.asarray(v), err_msg=k)


def test_build_frame(mid):
    """ORB on both images + stereo from the raw images: the same features
    (>= 99% of slots), and the same depths where the features agree."""
    fr, fj = mid["fr"], mid["frame_j"]
    ft = ttr.build_frame(t(fr.img_l), t(fr.img_r), mid["cam_t"], t(mid["sf"]),
                         n_features=512, n_levels=4)
    same = (np.all(n(ft.xy) == np.asarray(fj.xy), 1) & (n(ft.level) == np.asarray(fj.level))
            & (n(ft.valid) == np.asarray(fj.valid)))
    assert same.mean() >= 0.99
    dj, dt = np.asarray(fj.depth)[same], n(ft.depth)[same]
    both = (dj > 0) & (dt > 0)
    assert both.sum() > 100 and ((dj > 0) == (dt > 0)).mean() >= 0.98
    # subpixel depth: one f32 parabola division, z = bf / d
    np.testing.assert_allclose(dt[both], dj[both], rtol=1e-4)
    assert (np.all(words_u32(ft.desc) == np.asarray(fj.desc), 1)[same]).mean() >= 0.98


def test_track_step(mid):
    s = mid["s"]
    radius = float(s.cfg.tracking.match_radius_narrow)
    mj, rj, Tj, vj = jtr.track_step(s.map, mid["frame_j"], s.T_cw, s.velocity,
                                     jax.random.PRNGKey(0), s.cam, s.scale_factors,
                                     s.sigma2, jnp.float32(radius))
    mt, rt, Tt, vt = ttr.track_step(mid["m_t"], mid["frame_t"], t(np.asarray(s.T_cw, np.float32)),
                                    t(np.asarray(s.velocity, np.float32)), mid["cam_t"],
                                    t(mid["sf"]), t(mid["sigma2"]), radius)
    assert int(rt.n_matches) == int(rj.n_matches)
    assert int(rt.n_inliers) == int(rj.n_inliers) and int(rj.n_inliers) > 50
    np.testing.assert_array_equal(n(rt.feat_lm), np.asarray(rj.feat_lm))
    np.testing.assert_allclose(n(Tt), np.asarray(Tj), atol=POSE_ATOL)
    np.testing.assert_allclose(n(vt), np.asarray(vj), atol=POSE_ATOL)
    np.testing.assert_array_equal(n(mt.lm_found), np.asarray(mj.lm_found))
    np.testing.assert_array_equal(n(mt.lm_visible), np.asarray(mj.lm_visible))


def _global_samples(mid, key):
    """The hypotheses the JAX package draws in ``track_frame_global``: its
    draw repeated on the valid set of the port's (exact) global match."""
    from tc2li_slam_torch.ops import matching as tmatch
    mt, ft = mid["m_t"], mid["frame_t"]
    F = ft.xy.shape[0]
    kp_idx, dist_h, matched = tmatch.match_descriptors(
        mt.lm_desc, ft.desc, mt.lm_valid, ft.valid, max_dist=tmatch.TH_LOW, ratio=0.75,
        mutual=True)
    matched = tmatch.resolve_duplicates(kp_idx, dist_h, matched, F)
    has = ttr._assign_features(mt, kp_idx, matched, F) != tms.NO_LM
    return t(jax_sample_idx(key, n(has & ft.valid), 64))


def test_track_frame_global(mid):
    """Window-free tracking: no prediction goes in, so the pose comes out of
    the PnP hypotheses alone. Same matches, same inliers, pose to 1e-4."""
    s = mid["s"]
    key = jax.random.PRNGKey(11)
    rj = jtr.track_frame_global(s.map, mid["frame_j"], key, s.cam, s.sigma2)
    rt = ttr.track_frame_global(mid["m_t"], mid["frame_t"], mid["cam_t"], t(mid["sigma2"]),
                                sample_idx=_global_samples(mid, key))
    assert int(rt.n_matches) == int(rj.n_matches) > 50
    assert int(rt.n_inliers) == int(rj.n_inliers) > 30
    assert rt.n_inliers.dtype == rt.n_matches.dtype == torch.int32
    np.testing.assert_array_equal(n(rt.feat_lm), np.asarray(rj.feat_lm))
    np.testing.assert_allclose(n(rt.T_cw), np.asarray(rj.T_cw), atol=POSE_ATOL)


def test_track_step_recover_from_wrong_prediction(mid):
    """A motion model that points far away: ``track_step`` fails in both
    (dead reckoning, counters untouched), ``track_step_recover`` brings the
    same pose, matches and counters back."""
    from tc2li_slam_tpu.geom import lie as jlie
    s = mid["s"]
    radius = float(s.cfg.tracking.match_radius_narrow)
    vel = np.asarray(jlie.se3_exp(jnp.asarray([30.0, 20.0, -15.0, 0.6, -0.8, 0.9], jnp.float32)))
    T_prev = np.asarray(s.T_cw, np.float32)
    T_pred = vel @ T_prev
    key = jax.random.PRNGKey(4)
    sf, sigma2 = t(mid["sf"]), t(mid["sigma2"])
    _, rj0, Tj0, _ = jtr.track_step(s.map, mid["frame_j"], s.T_cw, jnp.asarray(vel), key, s.cam,
                                    s.scale_factors, s.sigma2, jnp.float32(radius))
    _, rt0, Tt0, _ = ttr.track_step(mid["m_t"], mid["frame_t"], t(T_prev), t(vel), mid["cam_t"],
                                    sf, sigma2, radius)
    assert int(rj0.n_inliers) < 10 and int(rt0.n_inliers) < 10
    np.testing.assert_allclose(n(Tt0), np.asarray(Tj0), atol=1e-3)   # both the prediction

    mj, rj, Tj, vj = jtr.track_step_recover(
        s.map, mid["frame_j"], s.T_cw, jnp.asarray(T_pred), jnp.asarray(vel), key, s.cam,
        s.scale_factors, s.sigma2, jnp.float32(radius))
    mt, rt, Tt, vt = ttr.track_step_recover(
        mid["m_t"], mid["frame_t"], t(T_prev), t(T_pred), t(vel), mid["cam_t"], sf, sigma2,
        radius, sample_idx=_global_samples(mid, key))
    assert int(rt.n_inliers) == int(rj.n_inliers) > 50
    assert int(rt.n_matches) == int(rj.n_matches)
    np.testing.assert_array_equal(n(rt.feat_lm), np.asarray(rj.feat_lm))
    np.testing.assert_allclose(n(Tt), np.asarray(Tj), atol=POSE_ATOL)
    np.testing.assert_allclose(n(vt), np.asarray(vj), atol=POSE_ATOL)
    np.testing.assert_array_equal(n(mt.lm_found), np.asarray(mj.lm_found))
    np.testing.assert_array_equal(n(mt.lm_visible), np.asarray(mj.lm_visible))
    # with its own generator the port recovers to the same place
    _, rg, Tg, _ = ttr.track_step_recover(
        mid["m_t"], mid["frame_t"], t(T_prev), t(T_pred), t(vel), mid["cam_t"], sf, sigma2,
        radius, generator=torch.Generator().manual_seed(0))
    assert int(rg.n_inliers) > 50
    np.testing.assert_allclose(n(Tg)[:3, 3], np.asarray(Tj)[:3, 3], atol=5e-3)


def test_landmark_gates(mid):
    s = mid["s"]
    T = np.asarray(s.T_cw, np.float32)
    nj = jtr.near_existing_landmark(s.map, mid["frame_j"], jnp.asarray(T), s.cam,
                                    jnp.float32(4.0), jnp.float32(0.15))
    nt = ttr.near_existing_landmark(mid["m_t"], mid["frame_t"], t(T), mid["cam_t"], 4.0, 0.15)
    np.testing.assert_array_equal(n(nt), np.asarray(nj))
    feat_lm = np.full(512, -1, np.int32)
    feat_lm[::3] = 7
    cj = jtr.stereo_landmark_candidates(mid["frame_j"], jnp.asarray(T), s.cam, jnp.asarray(feat_lm),
                                        jnp.float32(17.5), s.scale_factors)
    ct = ttr.stereo_landmark_candidates(mid["frame_t"], t(T), mid["cam_t"], t(feat_lm), 17.5,
                                        t(mid["sf"]))
    for a, b in zip(ct[:3], cj[:3]):
        np.testing.assert_allclose(n(a), np.asarray(b), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(n(ct[3]), np.asarray(cj[3]))


def _cmp_maps(mt, mj):
    for k, v in mj._asdict().items():
        a, b = getattr(mt, k), np.asarray(v)
        assert interop._numpy(k, a).dtype == b.dtype, k
        if b.dtype.kind == "f":
            np.testing.assert_allclose(n(a), b, rtol=1e-5, atol=1e-5, err_msg=k)
        else:
            np.testing.assert_array_equal(interop._numpy(k, a), b, err_msg=k)


def test_mapstate_ops(mid, rng):
    s, mt = mid["s"], mid["m_t"]
    mj = s.map
    fj, ft = mid["frame_j"], mid["frame_t"]
    T = np.asarray(s.T_cw, np.float32)
    feat_lm = np.full(512, -1, np.int32)
    live = np.nonzero(np.asarray(mj.lm_valid))[0]
    feat_lm[:40] = live[:40]
    mj2, _ = jms.add_keyframe(mj, jnp.asarray(T), jnp.float32(0.5), fj.xy, fj.uvr, fj.level,
                              fj.angle, fj.desc, fj.valid, jnp.asarray(feat_lm))
    mt2, _ = tms.add_keyframe(mt, t(T), torch.tensor(0.5), ft.xy, ft.uvr, ft.level, ft.angle,
                              ft.desc, ft.valid, t(feat_lm))
    _cmp_maps(mt2, mj2)
    kf = int(mj.n_kf)
    want = rng.random(512) > 0.6
    pos = rng.normal(0, 5, (512, 3)).astype(np.float32)
    nrm = rng.normal(0, 1, (512, 3)).astype(np.float32)
    dist = rng.uniform(1, 5, (512, 2)).astype(np.float32)
    feat = np.arange(512, dtype=np.int32)
    mj3, idj = jms.add_landmarks(mj2, jnp.int32(kf), jnp.asarray(feat), jnp.asarray(pos), fj.desc,
                                 jnp.asarray(nrm), jnp.asarray(dist), jnp.asarray(want))
    mt3, idt = tms.add_landmarks(mt2, kf, t(feat), t(pos), ft.desc, t(nrm), t(dist), t(want))
    np.testing.assert_array_equal(n(idt), np.asarray(idj))
    _cmp_maps(mt3, mj3)
    lm_ids = np.where(rng.random(512) > 0.5, live[rng.integers(0, len(live), 512)], -1).astype(np.int32)
    mask = rng.random(512) > 0.3
    _cmp_maps(tms.link_observations(mt3, kf - 1, t(feat), t(lm_ids), t(mask)),
              jms.link_observations(mj3, jnp.int32(kf - 1), jnp.asarray(feat),
                                    jnp.asarray(lm_ids), jnp.asarray(mask)))
    for k in range(kf + 1):
        np.testing.assert_array_equal(n(tms.covisibility_weights(mt3, k)),
                                      np.asarray(jms.covisibility_weights(mj3, jnp.int32(k))))
        for a, b in zip(tms.top_covisible(mt3, k, 5, min_weight=10),
                        jms.top_covisible(mj3, jnp.int32(k), 5, min_weight=10)):
            np.testing.assert_array_equal(n(a), np.asarray(b))
    window = np.array([0, 2, kf, -1, -1, -1], np.int32)
    for a, b in zip(tms.landmark_major_obs(mt3, t(window), t(mid["sigma2"])),
                    jms.landmark_major_obs(mj3, jnp.asarray(window), s.sigma2)):
        np.testing.assert_array_equal(n(a), np.asarray(b))
    kill = rng.random(mj3.L) > 0.7
    _cmp_maps(tms.remove_landmarks(mt3, t(kill)), jms.remove_landmarks(mj3, jnp.asarray(kill)))
    _cmp_maps(tms.update_landmark_stats(mt3), jms.update_landmark_stats(mj3))
