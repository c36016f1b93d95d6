"""Checkpoints of tc2li_slam_torch: save and load in the port, a file
written by the JAX package loaded by the port and the other way round (one
format), the vocabulary guard, and a resumed run against the uninterrupted
one, in STEREO_LIDAR with a frozen atlas map and once in IMU mode."""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tc2li_slam_tpu.ops import bow as jbow
from tc2li_slam_tpu.slam import checkpoint as jckpt, config as jcfg, system as jsys
from tc2li_slam_torch import interop
from tc2li_slam_torch.ops import orb as torb
from tc2li_slam_torch.slam import checkpoint as tckpt, config as tcfg, system as tsys
from test_torch_imu_system import imu_config, sequence as imu_sequence
from torch_parity import n, random_words, small_config, small_sequence

S = tsys.TrackingState


def _cfg(mod):
    c = small_config(mod)
    return dataclasses.replace(c, tracking=dataclasses.replace(
        c.tracking, recently_lost_frames=2, atlas_min_kf=2))


@pytest.fixture(scope="module")
def vocs():
    frames = small_sequence(13)
    descs = []
    for fr in frames[:4]:
        kp = torb.extract(torch.as_tensor(np.asarray(fr.img_l)), n_features=512, n_levels=4)
        descs.append(kp.desc.numpy().view(np.uint32)[kp.valid.numpy()])
    vj = jbow.train_vocabulary(np.concatenate(descs), k=6, depth=3, seed=0)
    return vj, interop.vocabulary_from_numpy(vj)


def _track(s, fr, t=None):
    return s.track(fr.img_l, fr.img_r, fr.t if t is None else t, fr.scan, fr.scan_valid)


@pytest.fixture(scope="module")
def port_ckpt(vocs, tmp_path_factory):
    """The port after 5 frames, a 2-frame blackout that freezes map 0 into
    the atlas, and 4 frames of map 1; its checkpoint; and the loaded copy."""
    frames = small_sequence(13)
    st = tsys.System(_cfg(tcfg), "cpu", voc=vocs[1])
    for fr in frames[:5]:
        _track(st, fr)
    rng = np.random.default_rng(1)
    noise = rng.integers(0, 255, frames[0].img_l.shape, dtype=np.uint8)
    for i in range(2):
        st.track(noise, noise, frames[4].t + 0.1 * (i + 1))
    for fr in frames[5:9]:
        _track(st, fr, fr.t + 0.2)
    assert st.state == S.OK and len(st.atlas.frozen) == 1 and st.map_id == 1
    path = str(tmp_path_factory.mktemp("ckpt") / "port.npz")
    tckpt.save_system(st, path)
    return st, path, tckpt.load_system(path, _cfg(tcfg), "cpu", voc=vocs[1])


def _assert_same_state(a, b):
    for k, v in interop.mapstate_to_numpy(a.map).items():
        w = interop.mapstate_to_numpy(b.map)[k]
        assert v.dtype == w.dtype
        np.testing.assert_array_equal(v, w, err_msg=k)
    for k, v in interop.voxelmap_to_numpy(a.vmap).items():
        np.testing.assert_array_equal(v, interop.voxelmap_to_numpy(b.vmap)[k], err_msg=k)
    np.testing.assert_array_equal(n(a.lidar_store.points), n(b.lidar_store.points))
    np.testing.assert_array_equal(n(a.lidar_store.valid), n(b.lidar_store.valid))
    np.testing.assert_array_equal(n(a.kf_words), n(b.kf_words))
    np.testing.assert_array_equal(n(a.T_cw), n(b.T_cw))
    np.testing.assert_array_equal(n(a.velocity), n(b.velocity))
    for f in ("state", "ref_kf", "n_kf_host", "ref_kf_tracked", "frames_since_kf", "frame_idx",
              "map_id", "n_lost", "kf_alive"):
        assert getattr(a, f) == getattr(b, f), f
    assert [e[:3] for e in a.traj] == [e[:3] for e in b.traj]
    np.testing.assert_array_equal(np.stack([n(e[3]) for e in a.traj]),
                                  np.stack([n(e[3]) for e in b.traj]))


def test_port_round_trip(port_ckpt):
    """Every pool, the pose, the counters, the trajectory and the frozen
    atlas map come back bit for bit, on the device asked for."""
    st, _, s2 = port_ckpt
    _assert_same_state(st, s2)
    assert s2.device == torch.device("cpu") and s2.map.lm_pos.device == s2.device
    assert (s2.atlas.n_created, s2.atlas.n_discarded) == (st.atlas.n_created, st.atlas.n_discarded)
    b, b2 = st.atlas.frozen[0], s2.atlas.frozen[0]
    assert (b2.n_kf, b2.map_id) == (b.n_kf, b.map_id) and b2.imu_store is None
    np.testing.assert_array_equal(n(b2.map.kf_T_cw), n(b.map.kf_T_cw))
    np.testing.assert_array_equal(n(b2.map.kf_desc), n(b.map.kf_desc))
    np.testing.assert_array_equal(n(b2.lidar_store.points), n(b.lidar_store.points))
    np.testing.assert_array_equal(n(b2.kf_words), n(b.kf_words))
    np.testing.assert_allclose(s2.trajectory_world_from_cam(), st.trajectory_world_from_cam(),
                               atol=1e-6)


def test_file_format_is_the_jax_packages(port_ckpt, vocs):
    """The keys, dtypes and header of the file: what the JAX package writes
    (descriptors uint32, one JSON header, format version 1)."""
    _, path, _ = port_ckpt
    data = np.load(path, allow_pickle=False)
    header = json.loads(bytes(data["__header__"].tobytes()).decode())
    assert header["format_version"] == jckpt.FORMAT_VERSION == tckpt.FORMAT_VERSION == 1
    assert data["map.kf_desc"].dtype == np.uint32 and data["atlas0.map.lm_desc"].dtype == np.uint32
    assert data["map.n_kf"].dtype == np.int32 and data["map.n_kf"].shape == ()
    assert data["vmap.voxel_size"].dtype == np.float32 and data["kf_words"].dtype == np.int32
    assert header["voc_md5"] == jckpt.vocabulary_checksum(vocs[0]) \
        == tckpt.vocabulary_checksum(vocs[1])
    assert header["atlas"]["frozen"] == [dict(n_kf=header["atlas"]["frozen"][0]["n_kf"], map_id=0,
                                              has_lidar=True, has_words=True)]
    sj = jsys.System(_cfg(jcfg), voc=vocs[0])
    want = {"__header__", "kf_words", "T_cw", "velocity", "traj.T_rel"}
    want |= {f"map.{f}" for f in sj.map._fields} | {f"atlas0.map.{f}" for f in sj.map._fields}
    want |= {f"vmap.{f}" for f in sj.vmap._fields}
    want |= {f"{p}lidar_store.{f}" for f in sj.lidar_store._fields for p in ("", "atlas0.")}
    assert set(data.files) == want | {"atlas0.kf_words"}


def test_resumed_run_matches_uninterrupted(port_ckpt):
    """Two more frames on the saved system and on the loaded one: poses to
    1e-4, the same keyframes."""
    st, _, s2 = port_ckpt
    frames = small_sequence(13)
    for fr in frames[9:11]:
        Ta, Tb = _track(st, fr, fr.t + 0.2), _track(s2, fr, fr.t + 0.2)
        np.testing.assert_allclose(n(Tb), n(Ta), atol=1e-4)
    assert s2.state == st.state == S.OK and s2.n_kf_host == st.n_kf_host
    np.testing.assert_allclose(s2.trajectory_world_from_cam(), st.trajectory_world_from_cam(),
                               atol=1e-4)


def test_port_checkpoint_loads_in_jax(port_ckpt, vocs):
    """port -> JAX: the JAX package loads the port's file; pools equal, the
    frozen map there, and it tracks on within the packages' 5 mm."""
    _, path, _ = port_ckpt
    sj = jckpt.load_system(path, _cfg(jcfg), vocs[0])
    st = s3 = tckpt.load_system(path, _cfg(tcfg), "cpu", voc=vocs[1])
    for k, v in interop.mapstate_to_numpy(st.map).items():
        np.testing.assert_array_equal(np.asarray(getattr(sj.map, k)), v, err_msg=k)
    np.testing.assert_array_equal(np.asarray(sj.vmap.keys), n(st.vmap.keys))
    np.testing.assert_array_equal(np.asarray(sj.kf_words), n(st.kf_words))
    assert sj.n_kf_host == st.n_kf_host and sj.state == st.state and sj.map_id == st.map_id
    assert len(sj.atlas.frozen) == 1 and sj.atlas.frozen[0].n_kf == st.atlas.frozen[0].n_kf
    np.testing.assert_array_equal(np.asarray(sj.atlas.frozen[0].map.kf_T_cw),
                                  n(st.atlas.frozen[0].map.kf_T_cw))
    fr = small_sequence(13)[9]
    Tj, Tt = _track(sj, fr, fr.t + 0.2), _track(s3, fr, fr.t + 0.2)
    assert sj.state == s3.state == S.OK
    d = np.linalg.norm(np.linalg.inv(np.asarray(Tj))[:3, 3] - np.linalg.inv(n(Tt))[:3, 3])
    assert d < 5e-3, d


def test_jax_checkpoint_loads_in_port(vocs, tmp_path):
    """JAX -> port: a file the JAX package wrote after 6 frames; the port's
    pools equal the JAX System's, dtypes the port's own; both track two more
    frames within 5 mm of each other."""
    frames = small_sequence(13)
    sj = jsys.System(small_config(jcfg), voc=vocs[0])
    for fr in frames[:6]:
        _track(sj, fr)
    path = str(tmp_path / "jax.npz")
    jckpt.save_system(sj, path)
    st = tckpt.load_system(path, small_config(tcfg), "cpu", voc=vocs[1])
    fresh = tsys.System(small_config(tcfg), "cpu", voc=vocs[1])
    for f in dataclasses.fields(st.map):
        a, b = getattr(st.map, f.name), getattr(fresh.map, f.name)
        assert a.dtype == b.dtype and a.shape == b.shape, f.name
    for k, v in interop.mapstate_to_numpy(st.map).items():
        np.testing.assert_array_equal(v, np.asarray(getattr(sj.map, k)), err_msg=k)
    np.testing.assert_array_equal(n(st.vmap.points), np.asarray(sj.vmap.points))
    assert st.vmap.voxel_size == float(np.asarray(sj.vmap.voxel_size))
    np.testing.assert_array_equal(n(st.lidar_store.valid), np.asarray(sj.lidar_store.valid))
    np.testing.assert_array_equal(n(st.kf_words), np.asarray(sj.kf_words))
    assert (st.state, st.ref_kf, st.n_kf_host, st.frame_idx, st.kf_alive) == \
        (sj.state, sj.ref_kf, sj.n_kf_host, sj.frame_idx, sj.kf_alive)
    assert len(st.traj) == len(sj.traj) == 6
    for fr in frames[6:8]:
        Tj, Tt = _track(sj, fr), _track(st, fr)
        d = np.linalg.norm(np.linalg.inv(np.asarray(Tj))[:3, 3] - np.linalg.inv(n(Tt))[:3, 3])
        assert d < 5e-3 and st.state == sj.state == S.OK, d


def test_vocabulary_guard(port_ckpt, vocs):
    """Another vocabulary, or none, is refused; so is another format version."""
    _, path, _ = port_ckpt
    rng = np.random.default_rng(0)
    other = interop.vocabulary_from_numpy(
        jbow.train_vocabulary(random_words(rng, (512, 8)), k=4, depth=3))
    with pytest.raises(ValueError, match="checksum"):
        tckpt.load_system(path, _cfg(tcfg), "cpu", voc=other)
    with pytest.raises(ValueError, match="checksum"):
        tckpt.load_system(path, _cfg(tcfg), "cpu")
    assert tckpt.vocabulary_checksum(other) != tckpt.vocabulary_checksum(vocs[1])


def test_format_version_and_missing_field(port_ckpt, vocs, tmp_path):
    _, path, _ = port_ckpt
    data = dict(np.load(path, allow_pickle=False))
    header = json.loads(bytes(data["__header__"].tobytes()).decode())
    header["format_version"] = 2
    bad = dict(data, __header__=np.frombuffer(json.dumps(header).encode(), dtype=np.uint8))
    np.savez_compressed(str(tmp_path / "v2.npz"), **bad)
    with pytest.raises(ValueError, match="format"):
        tckpt.load_system(str(tmp_path / "v2.npz"), _cfg(tcfg), "cpu", voc=vocs[1])
    del data["map.lm_first_kf"]
    np.savez_compressed(str(tmp_path / "cut.npz"), **data)
    with pytest.raises(KeyError):
        tckpt.load_system(str(tmp_path / "cut.npz"), _cfg(tcfg), "cpu", voc=vocs[1])


def _track_imu(s, fr):
    return s.track(fr.img_l, fr.img_r, fr.t, fr.scan, fr.scan_valid, gyro=fr.gyro, acc=fr.acc,
                   imu_dts=fr.imu_dts, imu_trel=fr.imu_trel, scan_times=fr.scan_times)


def test_imu_mode_round_trip_and_resume(tmp_path):
    """IMU mode: the filter, the inertial store and gravity come back; the
    refinement holds off until the next keyframe and the ladder clock
    restarts; two more frames on the
    loaded system stay within 1e-4 m of the saved one's (the filter's
    relative motion of the frame before the save is not in the file, so the
    first resumed frame predicts with the saved velocity; measured 4e-6 m)."""
    frames = imu_sequence()
    cfg = imu_config(tcfg, False)
    st = tsys.System(cfg, "cpu")
    for fr in frames[:7]:
        _track_imu(st, fr)
    path = str(tmp_path / "imu.npz")
    tckpt.save_system(st, path)
    s2 = tckpt.load_system(path, cfg, "cpu")
    for a, b in zip(st.filt.x, s2.filt.x):
        np.testing.assert_array_equal(n(a), n(b))
    np.testing.assert_array_equal(n(st.filt.P), n(s2.filt.P))
    for k, v in interop.imustore_to_numpy(st.imu_store).items():
        np.testing.assert_array_equal(v, interop.imustore_to_numpy(s2.imu_store)[k], err_msg=k)
    np.testing.assert_array_equal(n(st.gravity_vis), n(s2.gravity_vis))
    assert s2._imu_initialized and s2._has_factor_host == st._has_factor_host
    assert s2._imu_ring_overflow and s2._vi_stage == 0 and s2._vi_init_time is None
    assert s2._imu_ring == [] and s2._vi_initialized == st._vi_initialized
    for fr in frames[7:9]:
        Ta, Tb = _track_imu(st, fr), _track_imu(s2, fr)
        d = np.linalg.norm(np.linalg.inv(n(Ta))[:3, 3] - np.linalg.inv(n(Tb))[:3, 3])
        assert d < 1e-4 and s2.state == st.state == S.OK, d


def test_jax_imu_checkpoint_loads_in_port(tmp_path):
    """JAX -> port in IMU mode, from a fresh JAX System's file: the filter
    and the inertial store in the port's dtypes; and the port's file of the
    same state has the JAX file's keys, dtypes and shapes. (The JAX loader
    itself cannot rebuild its nested filter state, whoever wrote the file:
    ``Filter.x`` is annotated by a string there.)"""
    sj = jsys.System(imu_config(jcfg, True))
    path = str(tmp_path / "jax_imu.npz")
    jckpt.save_system(sj, path)
    st = tckpt.load_system(path, imu_config(tcfg, True), "cpu")
    tckpt.save_system(st, str(tmp_path / "port_imu.npz"))
    fj, ft = np.load(path), np.load(str(tmp_path / "port_imu.npz"))
    assert set(ft.files) == set(fj.files) and "filt.x.grav" in ft.files
    for k in fj.files:
        assert (ft[k].dtype, ft[k].shape) == (fj[k].dtype, fj[k].shape), k
        if k != "__header__":
            np.testing.assert_array_equal(ft[k], fj[k], err_msg=k)
    np.testing.assert_array_equal(n(st.filt.P), np.asarray(sj.filt.P))
    np.testing.assert_array_equal(n(st.imu_store.dR), np.asarray(sj.imu_store.dR))
    assert st.imu_store.has_factor.dtype == torch.bool and st.filt.x.grav.dtype == torch.float32
    assert st._has_factor_host == [False] * st.map.K and not st._imu_initialized
