"""End to end: the torch System vs the JAX System on the SMALL synthetic
stereo+LiDAR sequence of tests/test_e2e.py (640x240, 512 features, 4
levels), 8 frames with a keyframe every second frame so the mapping pass
(culling, fuse, local BA with the BALM eigen-factor) runs."""

import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tc2li_slam_tpu.io import synthetic as syn
from tc2li_slam_tpu.slam import config as jcfg, system as jsys
from tc2li_slam_torch.ops.kernels import fast, hamming, match
from tc2li_slam_torch.slam import config as tcfg, system as tsys
from torch_parity import small_config, small_sequence

N_FRAMES = 8
# per-frame camera positions of the two systems; measured ~0.2 mm apart
# (keypoints on upper pyramid levels and float32 solver sums differ)
POS_TOL_M = 5e-3
ATE_BOUND_M = 0.15


def _launches():
    return fast.score_launches, fast.nms_launches, hamming.launches, match.launches


def _run(sys_obj, frames):
    states = []
    for fr in frames:
        sys_obj.track(fr.img_l, fr.img_r, fr.t, fr.scan, fr.scan_valid)
        states.append(sys_obj.state)
    return states, sys_obj.trajectory_world_from_cam()


def test_system_matches_jax():
    frames = small_sequence(N_FRAMES)
    gt = np.stack([fr.T_wb_gt @ syn.body_from_cam() for fr in frames])
    sj = jsys.System(small_config(jcfg))
    states_j, est_j = _run(sj, frames)
    launches0 = _launches()
    st = tsys.System(small_config(tcfg), "cpu")
    states_t, est_t = _run(st, frames)

    assert states_t == states_j == [tsys.TrackingState.OK] * N_FRAMES
    assert int(st.map.n_kf) == int(sj.map.n_kf) >= 3
    assert st.n_ba_balm >= 1
    n_lm_j, n_lm_t = int(sj.map.n_lm), int(st.map.n_lm)
    assert abs(n_lm_t - n_lm_j) <= 0.02 * n_lm_j
    dpos = np.linalg.norm(est_t[:, :3, 3] - est_j[:, :3, 3], axis=-1)
    assert dpos.max() < POS_TOL_M, dpos
    ate_j, ate_t = syn.ate_rmse(est_j, gt), syn.ate_rmse(est_t, gt)
    assert ate_j < ATE_BOUND_M and ate_t < ATE_BOUND_M, (ate_j, ate_t)
    assert int(st.vmap.count) > 0
    # on the CPU the wrappers ran their plain versions: no kernel launches
    assert _launches() == launches0


def test_system_matches_jax_triangulate():
    """The JAX package's default: new map points triangulated between
    covisible keyframes at every mapping pass. Same keyframes, the same
    number of landmarks, per-frame positions within 5 mm."""
    n_frames = 10

    def cfg(mod):
        c = small_config(mod)
        return dataclasses.replace(
            c, tracking=dataclasses.replace(c.tracking, triangulate=True))

    assert jcfg.TrackingConfig().triangulate and tcfg.TrackingConfig().triangulate
    frames = small_sequence(n_frames)
    gt = np.stack([fr.T_wb_gt @ syn.body_from_cam() for fr in frames])
    sj = jsys.System(cfg(jcfg))
    states_j, est_j = _run(sj, frames)
    st = tsys.System(cfg(tcfg), "cpu")
    states_t, est_t = _run(st, frames)
    assert states_t == states_j == [tsys.TrackingState.OK] * n_frames
    assert int(st.map.n_kf) == int(sj.map.n_kf) >= 4
    np.testing.assert_array_equal(st.map.kf_valid.numpy(), np.asarray(sj.map.kf_valid))
    assert int(st.map.n_lm) == int(sj.map.n_lm)
    assert int(st.n_tri_landmarks) > 10 and st.n_tri_landmarks.dtype == torch.int32
    np.testing.assert_array_equal(st.map.lm_valid.numpy(), np.asarray(sj.map.lm_valid))
    np.testing.assert_array_equal(st.map.lm_n_obs.numpy(), np.asarray(sj.map.lm_n_obs))
    dpos = np.linalg.norm(est_t[:, :3, 3] - est_j[:, :3, 3], axis=-1)
    assert dpos.max() < POS_TOL_M, dpos
    assert syn.ate_rmse(est_t, gt) < ATE_BOUND_M


def test_synthetic_copy_matches_jax_package():
    """The port's numpy-only copies generate and configure identically."""
    from tc2li_slam_tpu.ops import _orb_pattern as jpat
    from tc2li_slam_torch.io import synthetic as tsyn
    from tc2li_slam_torch.ops import _orb_pattern as tpat
    # three frames: frames >= 1 carry non-empty IMU windows
    a = syn.generate_sequence(n_frames=3, cam=syn.SMALL, seed=3, n_scan=512)[0]
    b = tsyn.generate_sequence(n_frames=3, cam=tsyn.SMALL, seed=3, n_scan=512)[0]
    assert len(a) == len(b) == 3
    for fa, fb in zip(a, b):
        assert fa._fields == fb._fields
        for x, y in zip(fa, fb):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    for fb in b[1:]:
        live = fb.imu_dts > 0
        assert live.sum() >= 9 and np.all(np.isfinite(fb.imu_trel[live]))
        assert np.all(np.isinf(fb.imu_trel[~live])) and np.any(fb.gyro[live] != 0)
        assert np.all(np.abs(np.linalg.norm(fb.acc[live], axis=-1) - 9.81) < 1.0)
    np.testing.assert_array_equal(tsyn.body_from_cam(), syn.body_from_cam())
    np.testing.assert_array_equal(tpat.PATTERN, jpat.PATTERN)
    for name in ("CameraConfig", "OrbConfig", "ImuConfig", "LidarConfig",
                 "TrackingConfig", "SystemConfig"):
        a, b = getattr(tcfg, name)(), getattr(jcfg, name)()
        assert [f.name for f in dataclasses.fields(a)] == [f.name for f in dataclasses.fields(b)]
        for f in dataclasses.fields(a):
            if f.name not in ("camera", "orb", "imu", "lidar", "tracking"):
                np.testing.assert_array_equal(getattr(a, f.name), getattr(b, f.name))
    # an ImuConfig built from arguments, T_bc included
    kw = dict(noise_gyro=1e-4, noise_acc=1e-3, gyro_walk=1e-6, acc_walk=1e-5, frequency=200.0,
              T_bc=tsyn.body_from_cam())
    a, b = tcfg.ImuConfig(**kw), jcfg.ImuConfig(**kw)
    for f in dataclasses.fields(a):
        np.testing.assert_array_equal(getattr(a, f.name), getattr(b, f.name))


def test_port_import_loads_no_jax():
    root = Path(__file__).resolve().parents[1]
    code = ("import sys, pkgutil, importlib, tc2li_slam_torch as p\n"
            "for m in pkgutil.walk_packages(p.__path__, 'tc2li_slam_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "assert 'jax' not in sys.modules and 'tc2li_slam_tpu' not in sys.modules\n"
            "import torch; assert not torch.backends.cuda.matmul.allow_tf32\n"
            "assert not torch.backends.cudnn.allow_tf32\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr


@pytest.mark.parametrize("change", [
    dict(use_imu=True), dict(loop_closing=True), dict(use_imu=True, loop_closing=True),
])
def test_paths_outside_the_slice_raise(change):
    """No path raises any more: the IMU mode and loop closing both construct
    (every configuration switch of the JAX package is ported), with their
    counters at zero."""
    cfg = dataclasses.replace(small_config(tcfg), **change)
    system = tsys.System(cfg, "cpu")
    assert system.use_imu == cfg.use_imu and system.cfg.loop_closing == cfg.loop_closing
    assert (system.n_loops_closed, system.n_loop_verified, system._last_loop_kf) == (0, 0, -100)
    if cfg.use_imu:
        assert system.n_lvi_ba == 0


def test_default_tracking_config_constructs():
    """The JAX package's default TrackingConfig (triangulate=True) is taken."""
    cfg = dataclasses.replace(small_config(tcfg, lidar=False), tracking=tcfg.TrackingConfig(
        max_kf=8, max_lm=1024))
    assert cfg.tracking.triangulate
    s = tsys.System(cfg, "cpu")
    assert s.state == tsys.TrackingState.NOT_INITIALIZED and s.kf_words is None
    assert s.atlas.n_maps == 1 and s.map_id == 0 and not s.localization_only


def test_kernel_wrappers_take_no_other_route():
    """A tensor that is neither on the CPU nor on a CUDA card is refused,
    never sent to the plain version."""
    with pytest.raises(ValueError):
        fast.fast_score_raw(torch.zeros(16, 16, device="meta"))
    with pytest.raises(ValueError):
        fast.detect_planes(torch.zeros(1, 64, 64, device="meta"), [(64, 64)])
    meta8 = torch.zeros(4, 8, dtype=torch.int32, device="meta")
    metav = torch.zeros(4, dtype=torch.bool, device="meta")
    with pytest.raises(ValueError):
        match.match_best2(meta8, meta8, metav, metav)
    with pytest.raises(ValueError):
        hamming.hamming_matrix(torch.zeros(4, 8, dtype=torch.int32, device="meta"),
                               torch.zeros(4, 8, dtype=torch.int32, device="meta"))
