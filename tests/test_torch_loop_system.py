"""Loop closing through the two ``System``s: ``_try_close_loop`` and its
cooldown on the hand-built loop map, ``_global_ba`` after tracked frames,
the detection that rides in the port's per-frame transfer, and (slow) the
circle that revisits its start through both packages."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tc2li_slam_tpu.ops import bow as jbow
from tc2li_slam_tpu.slam import (config as jcfg, loop_closing as jlc, mapstate as jms,
                                 system as jsys)
from tc2li_slam_torch import interop
from tc2li_slam_torch.geom import lie as tlie
from tc2li_slam_torch.io import synthetic as syn
from tc2li_slam_torch.ops import bow as tbow, orb as torb
from tc2li_slam_torch.slam import config as tcfg, system as tsys
from test_loop_closing import build_loop_map
from torch_parity import n, random_words, small_config, small_sequence, t


def _loop_cfg(mod):
    c = small_config(mod, lidar=False)
    return dataclasses.replace(
        c, orb=mod.OrbConfig(n_features=64, n_levels=4), loop_closing=True, loop_min_gap=3,
        loop_min_kf=2, tracking=dataclasses.replace(c.tracking, max_kf=16, max_lm=256, max_obs=6))


@pytest.fixture(scope="module")
def loop_systems():
    """Both Systems holding the hand-built loop map, word rows in which
    keyframes 0 and K-1 share their words, and one vocabulary of ~1000 words."""
    rng = np.random.default_rng(0)
    m, T_gt, _ = build_loop_map(rng)
    K = len(T_gt)
    kw = np.full((m.K, m.F), -1, np.int32)
    shared = np.sort(rng.integers(0, 900, m.F))
    for k in range(K):
        kw[k] = shared if k in (0, K - 1) else np.sort(rng.integers(0, 900, m.F))
    vj = jbow.train_vocabulary(random_words(rng, (4000, 8)), k=10, depth=3, seed=0)
    sj = jsys.System(_loop_cfg(jcfg), voc=vj)
    st = tsys.System(_loop_cfg(tcfg), "cpu", voc=interop.vocabulary_from_numpy(vj))
    sj.map, sj.kf_words = m, jnp.asarray(kw)
    st.map, st.kf_words = interop.mapstate_from_numpy(m), t(kw)
    for s in (sj, st):
        s.n_kf_host = K
        s.kf_alive = [True] * m.K
        s._post_loop_ba = False
        s.state = tsys.TrackingState.OK
    return sj, st, K


def test_try_close_loop_matches_jax(loop_systems):
    """Both close the loop K-1 -> 0 with their own hypotheses: the same
    candidate, keyframe poses and landmarks to 1e-4, the pose reset to the
    keyframe's and the motion model to the identity, the counters set; a
    second call inside the cooldown changes nothing."""
    sj, st, K = loop_systems
    assert st.n_loops_closed == 0 and st._last_loop_kf == -100
    T_before = n(st.map.kf_T_cw).copy()
    sj._try_close_loop(K - 1)
    assert st._try_close_loop(K - 1) is True
    assert st.n_loops_closed == sj.n_loops_closed == 1
    assert st._last_loop_kf == sj._last_loop_kf == K - 1 and st.n_loop_verified == 1
    kf, cand = st.last_loop
    assert (kf, cand.kf_id) == (K - 1, 0) and cand.n_inliers >= 40
    np.testing.assert_allclose(n(st.map.kf_T_cw), np.asarray(sj.map.kf_T_cw), atol=1e-4)
    np.testing.assert_allclose(n(st.map.lm_pos), np.asarray(sj.map.lm_pos), atol=1e-4)
    assert np.abs(n(st.map.kf_T_cw) - T_before).max() > 1e-2
    np.testing.assert_array_equal(n(st.T_cw), n(st.map.kf_T_cw[K - 1]))
    np.testing.assert_array_equal(n(st.velocity), np.eye(4, dtype=np.float32))
    np.testing.assert_allclose(n(st.T_cw), np.asarray(sj.T_cw), atol=1e-4)
    # the cooldown: ten keyframes must pass before the next closure
    T_closed = n(st.map.kf_T_cw).copy()
    sj._try_close_loop(K - 1)
    assert st._try_close_loop(K - 1) is False and st._try_close_loop(K - 1, cands=[0]) is False
    assert st.n_loops_closed == sj.n_loops_closed == 1 and st.n_loop_verified == 1
    np.testing.assert_array_equal(n(st.map.kf_T_cw), T_closed)


def test_pending_loop_keeps_frame_relative_pose(loop_systems):
    """Candidates that arrive with a frame's transfer close the loop on that
    frame: its pose relative to the keyframe, the previous frame's and the
    motion model survive the correction."""
    _, st0, K = loop_systems
    rng = np.random.default_rng(1)
    m, _, _ = build_loop_map(np.random.default_rng(0))
    st = tsys.System(_loop_cfg(tcfg), "cpu", voc=st0.voc)
    st.map, st.kf_words, st.n_kf_host = interop.mapstate_from_numpy(m), st0.kf_words, K
    st._post_loop_ba = False
    rel = tlie.se3_exp(t(rng.normal(0, 0.05, 6).astype(np.float32)))
    vel = tlie.se3_exp(t(rng.normal(0, 0.05, 6).astype(np.float32)))
    st.T_cw = rel @ st.map.kf_T_cw[K - 1]
    st.last_T_cw = tlie.se3_inverse(vel) @ st.T_cw
    st.velocity = vel
    st._loop_cands = (K - 1, [])
    st._close_pending_loop()
    assert st.n_loops_closed == 0 and st._loop_cands is None and st.n_loop_verified == 0
    st._loop_cands = (K - 1, [4, 0])            # 4 shares nothing: verified, refused
    st._close_pending_loop()
    assert st.n_loops_closed == 1 and st.n_loop_verified == 2 and st.last_loop[1].kf_id == 0
    np.testing.assert_allclose(n(st.T_cw @ tlie.se3_inverse(st.map.kf_T_cw[K - 1])), n(rel),
                               atol=1e-5)
    np.testing.assert_allclose(n(st.T_cw @ tlie.se3_inverse(st.last_T_cw)), n(vel), atol=1e-5)
    np.testing.assert_array_equal(n(st.velocity), n(vel))


@pytest.fixture(scope="module")
def tracked_systems():
    """The JAX System after 10 SMALL frames with a vocabulary and loop
    closing on (no loop on this straight path), and the port started from its
    state; plus the port's own run of the same frames."""
    frames = small_sequence(13)
    descs = []
    for fr in frames[:4]:
        kp = torb.extract(torch.as_tensor(np.asarray(fr.img_l)), n_features=512, n_levels=4)
        descs.append(kp.desc.numpy().view(np.uint32)[kp.valid.numpy()])
    vj = jbow.train_vocabulary(np.concatenate(descs), k=6, depth=3, seed=0)
    vt = interop.vocabulary_from_numpy(vj)

    def cfg(mod):
        return dataclasses.replace(small_config(mod, lidar=False), loop_closing=True,
                                   loop_min_gap=2, loop_min_kf=1)

    sj = jsys.System(cfg(jcfg), voc=vj)
    st = tsys.System(cfg(tcfg), "cpu", voc=vt)
    log, arrived = [], []
    sync = st._sync

    def spy(n_inliers):
        out = sync(n_inliers)
        arrived.append(st._loop_cands)    # what this frame's transfer delivered
        return out

    st._sync = spy
    for fr in frames[:10]:
        sj.track(fr.img_l, fr.img_r, fr.t)
        n_kf = st.n_kf_host
        arrived.clear()
        st.track(fr.img_l, fr.img_r, fr.t)
        log.append(dict(
            state=st.state, new_kf=st.n_kf_host > n_kf, in_flight="loop_cands" in st._pending_fetch,
            kf=st._loop_kf_in_flight, arrived=arrived[-1] if arrived else None,
            n_syncs=len(arrived),
            want=None if "loop_cands" not in st._pending_fetch else [
                int(c) for c in jlc.detect_candidates(
                    jms.MapState(**{k: jnp.asarray(v)
                                    for k, v in interop.mapstate_to_numpy(st.map).items()}),
                    st._loop_kf_in_flight, jnp.asarray(n(st.kf_words)), min_gap=2, n_best=3,
                    word_weights=jnp.asarray(n(st._word_idf)))]))
    sj.flush_mapping()
    st.flush_mapping()
    return sj, st, log


def test_detection_rides_in_the_sync(tracked_systems):
    """Every keyframe past ``loop_min_kf`` leaves its candidates among the
    scalars of the next transfer, nothing is fetched at the keyframe, and
    what arrives a frame later is the reference's list for that map."""
    _, st, log = tracked_systems
    assert all(e["state"] == tsys.TrackingState.OK for e in log)
    assert st.n_loops_closed == 0 and st._loop_cands is None
    kf_frames = [i for i, e in enumerate(log) if e["new_kf"]]
    flights = [i for i, e in enumerate(log) if e["in_flight"]]
    assert len(flights) >= 2 and set(flights) <= set(kf_frames)
    assert all(e["n_syncs"] == 1 for e in log[1:])      # one transfer a tracked frame
    for i in flights:
        assert log[i]["kf"] > 1
        if i + 1 < len(log):
            assert log[i + 1]["arrived"] == (log[i]["kf"], log[i]["want"])
    assert all(e["arrived"] is None for i, e in enumerate(log) if i - 1 not in flights)
    assert st.n_loop_verified == sum(len(log[i]["want"]) for i in flights)


def test_global_ba_matches_jax(tracked_systems):
    """``_global_ba`` from the same map in both Systems: keyframe poses and
    landmarks to 1e-3 (float32 Schur solves of a 64-slot window; measured
    6e-7 on the poses, 4.4e-5 m on the landmarks), the anchor unmoved, and
    something did move."""
    sj, st0, _ = tracked_systems
    st = tsys.System(st0.cfg, "cpu", voc=st0.voc)
    st.map = interop.mapstate_from_numpy(sj.map)
    st.n_kf_host, st.kf_alive = sj.n_kf_host, list(sj.kf_alive)
    assert sj.n_kf_host >= 4
    before = np.asarray(sj.map.kf_T_cw).copy()
    lm_before = np.asarray(sj.map.lm_pos).copy()
    sj._global_ba(anchor=1)
    st._global_ba(anchor=1)
    Tj, Tt = np.asarray(sj.map.kf_T_cw), n(st.map.kf_T_cw)
    np.testing.assert_allclose(Tt, Tj, atol=1e-3)
    np.testing.assert_allclose(n(st.map.lm_pos), np.asarray(sj.map.lm_pos), atol=1e-3)
    np.testing.assert_array_equal(Tt[1], before[1])
    assert np.abs(n(st.map.lm_pos) - lm_before).max() > 1e-5
    print("global BA parity: poses", np.abs(Tt - Tj).max(), "landmarks",
          np.abs(n(st.map.lm_pos) - np.asarray(sj.map.lm_pos)).max())


def test_global_ba_small_map_is_a_no_op():
    """Fewer than three alive keyframes: nothing to adjust."""
    st = tsys.System(small_config(tcfg, lidar=False), "cpu")
    st.n_kf_host = 2
    m = st.map
    st._global_ba(anchor=0)
    assert st.map is m


# ---------------------------------------------------------------------------
# The circle that revisits its start (tests/test_loop_e2e.py), both packages
# ---------------------------------------------------------------------------

def inject_drift(slam, W):
    """The port's copy of ``tests/test_loop_e2e.py:inject_drift``: the recent
    map segment (last 8 keyframes + the landmarks they first observed) and
    the live pose move to the drifted gauge W."""
    slam.flush_mapping()
    W = torch.as_tensor(np.asarray(W, np.float32))
    W_inv = tlie.se3_inverse(W)
    cut = max(slam.n_kf_host - 8, 1)
    m = slam.map
    recent_kf = (torch.arange(m.K) >= cut) & m.kf_valid
    lm_recent = (m.lm_first_kf >= cut) & m.lm_valid
    slam.map = m.replace(
        kf_T_cw=torch.where(recent_kf[:, None, None], m.kf_T_cw @ W_inv, m.kf_T_cw),
        lm_pos=torch.where(lm_recent[:, None], tlie.se3_apply(W, m.lm_pos), m.lm_pos))
    slam.T_cw = slam.T_cw @ W_inv
    slam.last_T_cw = slam.last_T_cw @ W_inv


@pytest.mark.slow
def test_loop_closure_reduces_injected_drift_both_packages():
    """140 SMALL frames on a circle with a gauge ramp over frames 45..75:
    both packages close at least one loop, and the port's ATE with the
    closure is below its ATE without."""
    from test_loop_e2e import run_circle
    XI = (0.8, 0.0, 0.5, 0.0, 0.22, 0.0)
    traj = syn.CircleTrajectory(omega=0.5, speed=2.0)
    frames, _, _ = syn.generate_sequence(n_frames=140, cam=syn.SMALL, seed=0, n_scan=2048, traj=traj)
    descs = []
    for fr in frames[::5]:
        kp = torb.extract(torch.as_tensor(np.asarray(fr.img_l)), n_features=512, n_levels=4)
        descs.append(kp.desc.numpy().view(np.uint32)[kp.valid.numpy()])
    voc = tbow.train_vocabulary(np.concatenate(descs), k=8, depth=4, seed=0)
    T_bc = syn.body_from_cam()
    gt = np.stack([fr.T_wb_gt @ T_bc for fr in frames])
    ates = {}
    for on in (False, True):
        c = small_config(tcfg, lidar=False)
        c = dataclasses.replace(
            c, loop_closing=on, loop_min_gap=15, loop_min_kf=18,
            tracking=dataclasses.replace(c.tracking, kf_max_interval=3, max_kf=128,
                                         triangulate=True))
        slam = tsys.System(c, "cpu", voc=voc)
        for k, fr in enumerate(frames):
            if 45 <= k < 75:
                inject_drift(slam, n(tlie.se3_exp(t(np.asarray(XI, np.float32) / 30))))
            slam.track(fr.img_l, fr.img_r, fr.t)
        ates[on] = (syn.ate_rmse(slam.trajectory_world_from_cam(), gt), slam.n_loops_closed)
    assert ates[False][1] == 0 and ates[True][1] >= 1
    assert ates[False][0] > 0.3 and ates[True][0] < ates[False][0], ates
    slam_j, ate_j = run_circle(True, drift_at=(45, 75), drift_xi=XI)
    assert slam_j.n_loops_closed >= 1 and ates[True][0] < 2.0 * ate_j + 0.1, (ates, ate_j)
