"""The lost-frame ladder of the torch System against the JAX System and
against ground truth, on the SMALL synthetic sequence: RECENTLY_LOST with
dead reckoning, the atlas (freeze, discard, new map), the timestamp-jump
guard, localization-only mode, and recovery with a vocabulary."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tc2li_slam_tpu.ops import bow as jbow
from tc2li_slam_tpu.slam import (config as jcfg, relocalization as jreloc, system as jsys,
                                 tracking as jtr)
from tc2li_slam_torch import interop
from tc2li_slam_torch.geom import lie as tlie
from tc2li_slam_torch.io import synthetic as syn
from tc2li_slam_torch.ops import bow as tbow, orb as torb
from tc2li_slam_torch.slam import (config as tcfg, relocalization as treloc, system as tsys,
                                   tracking as ttr)
from test_torch_pnp import jax_sample_idx
from torch_parity import n, small_config, small_sequence, t

S = tsys.TrackingState
DT = 0.1


def _cfg(mod, lidar, **tracking):
    c = small_config(mod, lidar=lidar)
    return dataclasses.replace(c, tracking=dataclasses.replace(c.tracking, **tracking))


def _scenario():
    """(img_l, img_r, t) of: 7 structured frames; a 3-frame blackout of
    uniform noise at the sensor's rate; 4 structured frames; then the
    stream breaks (a 5 s gap) and 2 more follow."""
    frames = small_sequence(13)
    rng = np.random.default_rng(1)
    noise = [rng.integers(0, 255, frames[0].img_l.shape, dtype=np.uint8) for _ in range(3)]
    seq = [(fr.img_l, fr.img_r) for fr in frames[:7]] + [(x, x) for x in noise]
    seq += [(fr.img_l, fr.img_r) for fr in frames[7:13]]
    times = [DT * i for i in range(14)] + [DT * 13 + 5.0 + DT * i for i in range(2)]
    return [(a, b, t) for (a, b), t in zip(seq, times)]


def _drive(system, scenario):
    log = []
    for img_l, img_r, t in scenario:
        T = system.track(img_l, img_r, t)
        log.append(dict(state=system.state, map_id=system.map_id, n_kf=system.n_kf_host,
                        n_created=system.atlas.n_created, n_frozen=len(system.atlas.frozen),
                        n_discarded=system.atlas.n_discarded, n_lost=system.n_lost,
                        finite=bool(np.isfinite(np.asarray(T)).all())))
    return log


@pytest.fixture(scope="module")
def atlas_runs():
    scenario = _scenario()
    kw = dict(recently_lost_frames=3, atlas_min_kf=2)
    sj = jsys.System(_cfg(jcfg, False, **kw))
    st = tsys.System(_cfg(tcfg, False, **kw), "cpu")
    return sj, _drive(sj, scenario), st, _drive(st, scenario)


def test_atlas_blackout_matches_jax(atlas_runs):
    """Same state sequence, same atlas counters, the frozen map's keyframe
    count, frame by frame."""
    sj, log_j, st, log_t = atlas_runs
    assert log_t == log_j
    states = [e["state"] for e in log_t]
    assert states[:7] == [S.OK] * 7
    # two RECENTLY_LOST frames; the third lost frame turns LOST: map 0 is
    # frozen and map 1 waits for a frame it can initialise on
    assert states[7:10] == [S.RECENTLY_LOST, S.RECENTLY_LOST, S.NOT_INITIALIZED]
    assert [e["n_lost"] for e in log_t[7:10]] == [1, 2, 0]
    assert states[10:14] == [S.OK] * 4 and log_t[10]["map_id"] == 1 and log_t[10]["n_kf"] == 1
    assert all(e["finite"] for e in log_t)
    assert st.n_recover == 3 and st.n_reloc == 0
    kf_before = log_t[6]["n_kf"]
    assert kf_before >= 2 and log_t[9]["n_frozen"] == 1 and log_t[9]["n_created"] == 2
    assert st.atlas.frozen[0].n_kf == sj.atlas.frozen[0].n_kf == kf_before
    assert st.atlas.frozen[0].map_id == 0 and st.atlas.n_discarded == sj.atlas.n_discarded == 0
    assert int(st.atlas.frozen[0].map.n_kf) == int(sj.atlas.frozen[0].map.n_kf) == kf_before


def test_timestamp_jump_starts_new_map(atlas_runs):
    """A gap above 1 s freezes the active map, and the same frame
    initialises the next one; both packages agree. Time running backwards
    is a break too, and a map below atlas_min_kf is discarded."""
    sj, log_j, st, log_t = atlas_runs
    before, after = log_t[13], log_t[14]
    assert after["n_created"] == before["n_created"] + 1 == log_j[14]["n_created"] == 3
    assert after["map_id"] == before["map_id"] + 1 == 2
    assert after["state"] == S.OK and after["n_kf"] == 1
    assert after["n_frozen"] == 2 and st.atlas.frozen[1].n_kf == before["n_kf"] >= 2
    assert st.atlas.n_maps == sj.atlas.n_maps == 3
    assert [e[1] for e in st.traj] == [e[1] for e in sj.traj] == [0] * 9 + [1] * 5 + [2] * 2
    assert [e[2] for e in st.traj] == [e[2] for e in sj.traj]


def test_trajectory_across_sub_maps(atlas_runs, tmp_path):
    """One pose per tracked frame, finite, continuous across the recovery
    (the new map is anchored at the dead-reckoned pose), and within 5 mm of
    the JAX package's; the savers write one line a frame."""
    sj, _, st, _ = atlas_runs
    est_t, est_j = st.trajectory_world_from_cam(), sj.trajectory_world_from_cam()
    assert est_t.shape == (len(st.traj), 4, 4) and np.isfinite(est_t).all()
    dpos = np.linalg.norm(est_t[:, :3, 3] - est_j[:, :3, 3], axis=-1)
    assert dpos.max() < 5e-3, dpos
    step = np.linalg.norm(np.diff(est_t[:, :3, 3], axis=0), axis=-1)
    assert step.max() < 0.5, step
    from tc2li_slam_torch.slam import trajectory
    st.save_trajectory_kitti(str(tmp_path / "kitti.txt"))
    st.save_trajectory_tum(str(tmp_path / "tum.txt"))
    back = trajectory.load_kitti(str(tmp_path / "kitti.txt"))
    np.testing.assert_allclose(back, est_t, atol=1e-6)
    tum = np.loadtxt(tmp_path / "tum.txt")
    assert tum.shape == (len(st.traj), 8)
    np.testing.assert_allclose(np.linalg.norm(tum[:, 4:], axis=1), 1.0, atol=1e-5)
    from tc2li_slam_tpu.geom import lie as jlie
    q = np.asarray(jlie.mat_to_quat(np.asarray(est_t[5, :3, :3], np.float32)))
    np.testing.assert_allclose(tum[5, 4:], q[[1, 2, 3, 0]], atol=1e-5)


def test_atlas_discards_tiny_map():
    """A map below atlas_min_kf keyframes is discarded, not frozen."""
    frames = small_sequence(13)
    st = tsys.System(_cfg(tcfg, False, recently_lost_frames=2, atlas_min_kf=10), "cpu")
    for fr in frames[:4]:
        st.track(fr.img_l, fr.img_r, fr.t)
    rng = np.random.default_rng(2)
    noise = rng.integers(0, 255, frames[0].img_l.shape, dtype=np.uint8)
    for i in range(2):
        st.track(noise, noise, frames[3].t + DT * (i + 1))
    assert st.atlas.n_discarded == 1 and len(st.atlas.frozen) == 0
    assert st.state == S.NOT_INITIALIZED and st.n_recover == 2 and st.map_id == 1
    assert int(st.map.n_kf) == 0 and st.map.lm_pos.device == st.device
    # the next structured frame starts map 1; time running backwards breaks it
    st.track(frames[4].img_l, frames[4].img_r, frames[3].t + DT * 3)
    assert st.state == S.OK and st.n_kf_host == 1
    st.track(frames[5].img_l, frames[5].img_r, 0.0)
    assert st.atlas.n_created == 3 and st.atlas.n_discarded == 2 and st.map_id == 2
    assert np.isfinite(st.trajectory_world_from_cam()).all()


def _train_voc(frames):
    return tbow.train_vocabulary(_train_descs(frames), k=6, depth=3, seed=0)


def _train_descs(frames, n_frames=4):
    descs = []
    for fr in frames[:n_frames]:
        kp = torb.extract(torch.as_tensor(np.asarray(fr.img_l)), n_features=512, n_levels=4)
        descs.append(kp.desc.numpy().view(np.uint32)[kp.valid.numpy()])
    return np.concatenate(descs)


@pytest.fixture(scope="module")
def voc_runs():
    """Both Systems over 8 SMALL frames with one vocabulary, trained by the
    JAX package and carried over; and the JAX map, keyframe words and an
    earlier frame carried over, for calls that start from the same state."""
    frames = small_sequence(13)
    vj = jbow.train_vocabulary(_train_descs(frames), k=6, depth=3, seed=0)
    vt = interop.vocabulary_from_numpy(vj)
    sj = jsys.System(small_config(jcfg, lidar=False), voc=vj)
    st = tsys.System(small_config(tcfg, lidar=False), "cpu", voc=vt)
    for fr in frames[:8]:
        sj.track(fr.img_l, fr.img_r, fr.t)
        st.track(fr.img_l, fr.img_r, fr.t)
    sj.flush_mapping()
    st.flush_mapping()
    fr = frames[4]
    frame_j = jtr.build_frame(jnp.asarray(fr.img_l), jnp.asarray(fr.img_r), sj.cam,
                              sj.scale_factors, n_features=512, n_levels=4)
    frame_t = ttr.Frame(*[t(np.asarray(a)) for a in frame_j])
    return dict(sj=sj, st=st, vj=vj, vt=vt, frame_j=frame_j, frame_t=frame_t,
                m_t=interop.mapstate_from_numpy(sj.map), kf_words_t=t(np.asarray(sj.kf_words)))


def test_keyframe_words_match_jax(voc_runs):
    """The words each System stores per keyframe: the port's rows are what
    the JAX package's quantizer gives for the port's own keyframe
    descriptors, sorted, and culled keyframes are scrubbed in both. Row
    against row the two Systems agree wherever their ORB features do."""
    sj, st, vj = voc_runs["sj"], voc_runs["st"], voc_runs["vj"]
    kw_t, kw_j = st.kf_words.numpy(), np.asarray(sj.kf_words)
    assert kw_t.dtype == kw_j.dtype == np.int32 and kw_t.shape == kw_j.shape
    assert st.n_kf_host == sj.n_kf_host >= 4
    np.testing.assert_array_equal(st.map.kf_valid.numpy(), np.asarray(sj.map.kf_valid))
    desc = st.map.kf_desc.numpy().view(np.uint32)
    for k in range(st.n_kf_host):
        if not bool(st.map.kf_valid[k]):
            assert (kw_t[k] == -1).all() and (kw_j[k] == -1).all()
            continue
        want = jnp.sort(jbow.quantize(vj, jnp.asarray(desc[k]),
                                      jnp.asarray(st.map.kf_feat_valid[k].numpy()), vj.depth)[0])
        np.testing.assert_array_equal(kw_t[k], np.asarray(want))
        n_words = max(vj.n_words, 1)
        hist_t = np.bincount(kw_t[k][kw_t[k] >= 0], minlength=n_words)
        hist_j = np.bincount(kw_j[k][kw_j[k] >= 0], minlength=n_words)
        assert np.abs(hist_t - hist_j).sum() <= 0.04 * 512
    assert (kw_t[st.n_kf_host:] == -1).all() and (kw_j[sj.n_kf_host:] == -1).all()


def _reloc_samples(v, key, n_candidates=5):
    """The hypotheses the JAX package draws in ``relocalize``: one key split
    per candidate that reaches PnP, its draw repeated on the valid set of
    the port's (exact) frame x landmarks match."""
    from tc2li_slam_torch.ops import matching as tmatch
    from tc2li_slam_torch.slam import mapstate as tms
    m, frame, voc = v["m_t"], v["frame_t"], v["vt"]
    words, weights = tbow.quantize(voc, frame.desc, frame.valid, voc.depth)
    counts, scores = tbow.shared_word_scores(words, weights, v["kf_words_t"], m.kf_valid)
    cand, _ = tbow.reloc_candidates(counts, scores, n_candidates)
    out = []
    for kf_id in [c for c in cand.tolist() if c >= 0]:
        seen = torch.any(m.lm_obs_kf == kf_id, dim=1) & m.lm_valid
        _, _, okm = tmatch.match_descriptors(frame.desc, m.lm_desc, frame.valid, seen,
                                             max_dist=tmatch.TH_LOW, ratio=0.8, mutual=True)
        if int(okm.sum()) < 12:
            continue
        key, sub = jax.random.split(key)
        out.append(t(jax_sample_idx(sub, n(okm), 128)))
    return out


def test_relocalize_matches_jax(voc_runs):
    """``relocalize`` from the same map, keyframe words and frame, fed the
    hypotheses the JAX key draws: the same verdict, inliers and feature to
    landmark assignment, the pose to 1e-4. A frame of noise fails in both."""
    v = voc_runs
    sj, st = v["sj"], v["st"]
    key = jax.random.PRNGKey(5)
    rj = jreloc.relocalize(sj.map, v["frame_j"], sj.cam, v["vj"], sj.kf_words, sj.sigma2, key)
    samples = _reloc_samples(v, key)
    assert len(samples) >= 1
    rt = treloc.relocalize(v["m_t"], v["frame_t"], st.cam, v["vt"], v["kf_words_t"], st.sigma2,
                           sample_idx=samples)
    assert rt.ok == rj.ok is True
    assert rt.n_inliers == rj.n_inliers >= 30
    np.testing.assert_array_equal(n(rt.feat_lm), np.asarray(rj.feat_lm))
    np.testing.assert_allclose(n(rt.T_cw), np.asarray(rj.T_cw), atol=1e-4)
    rng = np.random.default_rng(5)
    x = rng.integers(0, 255, (240, 640), dtype=np.uint8)
    blank_j = jtr.build_frame(jnp.asarray(x), jnp.asarray(x), sj.cam, sj.scale_factors,
                              n_features=512, n_levels=4)
    v2 = dict(v, frame_j=blank_j, frame_t=ttr.Frame(*[t(np.asarray(a)) for a in blank_j]))
    bj = jreloc.relocalize(sj.map, blank_j, sj.cam, v["vj"], sj.kf_words, sj.sigma2, key)
    bt = treloc.relocalize(v["m_t"], v2["frame_t"], st.cam, v["vt"], v["kf_words_t"], st.sigma2,
                           sample_idx=_reloc_samples(v2, key))
    assert bt.ok == bj.ok is False and bt.n_inliers == bj.n_inliers


@pytest.fixture(scope="module")
def mapped():
    """The port's System with a vocabulary after 8 SMALL frames, LiDAR on."""
    frames = small_sequence(13)
    st = tsys.System(small_config(tcfg), "cpu", voc=_train_voc(frames))
    for fr in frames[:8]:
        st.track(fr.img_l, fr.img_r, fr.t, fr.scan, fr.scan_valid)
    assert st.state == S.OK
    return st, frames


def _gt_cw(frames, i):
    T_bc = syn.body_from_cam()
    return np.linalg.inv(frames[i].T_wb_gt @ T_bc) @ (frames[0].T_wb_gt @ T_bc)


def test_keyframe_words_and_relocalize(mapped):
    """Each keyframe's row of sorted words; `relocalize` on an earlier
    frame finds its pose within 0.3 m with no prediction at all."""
    st, frames = mapped
    kw = st.kf_words.numpy()
    n_kf = st.n_kf_host
    assert kw.dtype == np.int32 and (kw[n_kf:] == -1).all()
    assert all((np.diff(kw[k]) >= 0).all() and (kw[k] >= 0).sum() > 200 for k in range(n_kf))
    fr = frames[4]
    frame = ttr.build_frame(torch.as_tensor(np.asarray(fr.img_l)), torch.as_tensor(np.asarray(fr.img_r)),
                            st.cam, st.scale_factors, n_features=512, n_levels=4)
    rr = treloc.relocalize(st.map, frame, st.cam, st.voc, st.kf_words, st.sigma2,
                           generator=torch.Generator().manual_seed(3))
    assert rr.ok and rr.n_inliers >= 30
    err = np.linalg.norm(rr.T_cw.numpy()[:3, 3] - _gt_cw(frames, 4)[:3, 3])
    assert err < 0.3, err
    assert int((rr.feat_lm != -1).sum()) == rr.n_inliers
    # a frame of noise finds nothing
    rng = np.random.default_rng(5)
    x = torch.as_tensor(rng.integers(0, 255, np.asarray(fr.img_l).shape, dtype=np.uint8))
    blank = ttr.build_frame(x, x, st.cam, st.scale_factors, n_features=512, n_levels=4)
    assert not treloc.relocalize(st.map, blank, st.cam, st.voc, st.kf_words, st.sigma2,
                                 generator=torch.Generator().manual_seed(3)).ok


def test_teleport_recovers_then_localization_only(mapped):
    """A motion model pointing far away and an earlier viewpoint: the frame
    comes back OK within 0.3 m of ground truth. Then localization-only mode
    tracks on and adds no keyframe and no landmark."""
    st, frames = mapped
    st.velocity = tlie.se3_exp(torch.tensor([30.0, 20.0, -15.0, 0.6, -0.8, 0.9]))
    fr = frames[5]
    st.track(fr.img_l, fr.img_r, 0.9, fr.scan, fr.scan_valid)
    assert st.state == S.OK and st.n_recover == 1 and st.n_lost == 0
    err = np.linalg.norm(st.T_cw.numpy()[:3, 3] - _gt_cw(frames, 5)[:3, 3])
    assert err < 0.3, err

    st.flush_mapping()
    st.activate_localization_mode()
    n_kf, n_lm, host_kf = int(st.map.n_kf), int(st.map.n_lm), st.n_kf_host
    for i, k in enumerate((6, 7, 8)):
        fr = frames[k]
        st.track(fr.img_l, fr.img_r, 1.0 + DT * i, fr.scan, fr.scan_valid)
        assert st.state == S.OK
    assert (int(st.map.n_kf), int(st.map.n_lm), st.n_kf_host) == (n_kf, n_lm, host_kf)
    err = np.linalg.norm(st.T_cw.numpy()[:3, 3] - _gt_cw(frames, 8)[:3, 3])
    assert err < 0.3, err
    st.activate_localization_mode(False)
    assert not st.localization_only
