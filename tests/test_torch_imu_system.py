"""Parity of the IMU mode end to end: the JAX ``System`` and the port's on
the SMALL IMU sequence of tests/test_imu_mode.py (``imu_cfg()``, seed 3,
2048-point scans), frame by frame, with ``inertial_ba`` on (18 frames: the
staged visual-inertial initialization, one LVI-BA pass and the per-frame
pose-inertial refinement all run) and off (10 frames). One run of each
package per case, shared by the tests of the file. The tests from
``test_next_frame_reads_no_device_scalar`` on track three more frames with
the port's system alone, in the order of the file: a tracked frame, a frame
lost to blank images (dead reckoning), a frame past the IMU ring's capacity,
then the next rung of the initialization ladder."""

import dataclasses
import functools

import numpy as np
import pytest
from torch.utils._python_dispatch import TorchDispatchMode

from tc2li_slam_tpu.slam import config as jcfg, system as jsys
from tc2li_slam_torch import interop
from tc2li_slam_torch.io import synthetic as syn
from tc2li_slam_torch.slam import config as tcfg, system as tsys
from torch_parity import n, small_config

N_FRAMES = {True: 18, False: 10}


def imu_config(mod, inertial_ba: bool):
    """tests/test_imu_mode.py's ``imu_cfg()`` for either package."""
    cfg = small_config(mod, n_frames_kf=5)
    return dataclasses.replace(
        cfg, use_imu=True, inertial_ba=inertial_ba,
        tracking=dataclasses.replace(cfg.tracking, max_lm=8192, triangulate=True),
        imu=mod.ImuConfig(noise_gyro=1e-4, noise_acc=1e-3, gyro_walk=1e-6, acc_walk=1e-5,
                          T_bc=syn.body_from_cam()))


@functools.lru_cache(maxsize=None)
def sequence():
    # three frames more than the longest run, for the tests at the end of
    # the file that track on with the port's system alone
    return syn.generate_sequence(n_frames=max(N_FRAMES.values()) + 3, cam=syn.SMALL, seed=3,
                                 n_scan=2048)[0]


def run(system, frames):
    """Track the frames; per frame (state, keyframes, T_cw, filter state)."""
    log = []
    for fr in frames:
        T = system.track(fr.img_l, fr.img_r, fr.t, fr.scan, fr.scan_valid, gyro=fr.gyro,
                         acc=fr.acc, imu_dts=fr.imu_dts, imu_trel=fr.imu_trel,
                         scan_times=fr.scan_times)
        x = system.filt.x
        log.append(dict(state=system.state, n_kf=system.n_kf_host, T_cw=n(T).copy(),
                        vi=system._vi_initialized, pos=n(x.pos).copy(), vel=n(x.vel).copy(),
                        grav=n(x.grav).copy(), bg=n(x.bg).copy(), ba=n(x.ba).copy()))
    return log


@pytest.fixture(scope="module", params=[True, False], ids=["inertial_ba", "visual_ba"])
def both(request):
    inertial = request.param
    frames = sequence()[:N_FRAMES[inertial]]
    js = jsys.System(imu_config(jcfg, inertial))
    ts = tsys.System(imu_config(tcfg, inertial), "cpu")
    jlog, tlog = run(js, frames), run(ts, frames)
    gt = np.stack([fr.T_wb_gt @ syn.body_from_cam() for fr in frames])
    return inertial, js, ts, jlog, tlog, gt


def test_states_and_keyframes(both):
    inertial, js, ts, jlog, tlog, _ = both
    assert [r["state"] for r in tlog] == [r["state"] for r in jlog]
    assert all(r["state"] == tsys.TrackingState.OK for r in tlog)
    assert [r["n_kf"] for r in tlog] == [r["n_kf"] for r in jlog]
    assert [r["vi"] for r in tlog] == [r["vi"] for r in jlog]
    assert ts._imu_initialized and js._imu_initialized
    assert ts._vi_initialized == js._vi_initialized == inertial
    assert ts._has_factor_host == js._has_factor_host
    assert ts.n_imu_bad == 0 and ts.n_imu_reset == 0
    if inertial:
        # the initialization, an LVI-BA pass with the BALM term and both
        # per-frame optimizers ran
        assert ts.n_lvi_ba >= 1 and ts.n_lvi_ba_balm >= 1
        assert ts.n_vi_refine_kf >= 1 and ts.n_vi_refine_frame >= 2
        kf = ts.n_kf_host - 1
        assert bool(ts.imu_store.vel_opt[kf]) and bool(np.asarray(js.imu_store.vel_opt)[kf])
    else:
        assert ts.n_lvi_ba == 0 and ts.n_vi_refine_kf == ts.n_vi_refine_frame == 0
        assert ts.n_ba >= 1


def test_frame_positions(both):
    """Per-frame camera positions, within the 5 mm of test_torch_system.py
    but for frame 2. Measured: 6.9 mm at frame 2, at most 1.0 mm at the
    others (0.3 mm before the LVI-BA pass), rotation entries 5.4e-4.

    Frame 2 is the filter's first update: the static init took the moving
    body for a standing one (velocity 0, the yaw rate as gyro bias), so the
    update corrects 0.2 m at once and is ill-conditioned. On that frame's
    own inputs the two packages' scan steps end 2.4 mm and 2.8e-4 rad apart
    (a few plane fits through near-collinear neighbours give other normals,
    tests/test_torch_esekf.py), the motion prediction differs by as much,
    and the tracker matches in a window around it."""
    _, _, _, jlog, tlog, _ = both
    d = [float(np.linalg.norm(np.linalg.inv(a["T_cw"])[:3, 3] - np.linalg.inv(b["T_cw"])[:3, 3]))
         for a, b in zip(tlog, jlog)]
    assert max(d[:2] + d[3:]) < 5e-3 and d[2] < 1.5e-2, d
    rot = [float(np.abs(a["T_cw"][:3, :3] - b["T_cw"][:3, :3]).max()) for a, b in zip(tlog, jlog)]
    assert max(rot) < 2e-3, rot


def test_filter_gravity_and_biases(both):
    """The ESEKF's state frame by frame, and the stores' per-keyframe
    biases and velocities after the run. The filter starts from a wrong
    static init (see test_frame_positions) and its gravity, biases and
    velocity swing by 2 m/s^2, 0.2 m/s^2 and 1.7 m/s over the first frames
    while they converge; over that transient the two packages were measured
    at most 1.8 cm, 4.0 cm/s, 3.3e-2 m/s^2 (gravity), 4.0e-3 rad/s and
    2.8e-2 m/s^2 (biases) apart; the stores 1.2e-3, 8.4e-3, 1.0e-2 m/s and
    1.9e-3 m (bg, ba, vel, dP)."""
    inertial, js, ts, jlog, tlog, _ = both
    for a, b in zip(tlog, jlog):
        np.testing.assert_allclose(a["pos"], b["pos"], atol=5e-2)
        np.testing.assert_allclose(a["vel"], b["vel"], atol=0.1)
        np.testing.assert_allclose(a["grav"], b["grav"], atol=0.1)
        np.testing.assert_allclose(a["bg"], b["bg"], atol=1e-2)
        np.testing.assert_allclose(a["ba"], b["ba"], atol=6e-2)
        assert abs(np.linalg.norm(a["grav"]) - 9.81) < 0.2
    np.testing.assert_allclose(n(ts.gravity_vis), n(js.gravity_vis), atol=1e-3)
    store_t, store_j = interop.imustore_to_numpy(ts.imu_store), js.imu_store
    k = ts.n_kf_host
    np.testing.assert_array_equal(store_t["has_factor"], np.asarray(store_j.has_factor))
    np.testing.assert_array_equal(store_t["vel_opt"], np.asarray(store_j.vel_opt))
    assert int(store_t["has_factor"].sum()) >= k - 1
    np.testing.assert_allclose(store_t["bg"][:k], np.asarray(store_j.bg)[:k], atol=5e-3)
    np.testing.assert_allclose(store_t["ba"][:k], np.asarray(store_j.ba)[:k], atol=3e-2)
    np.testing.assert_allclose(store_t["vel"][:k], np.asarray(store_j.vel)[:k], atol=5e-2)
    np.testing.assert_allclose(store_t["dP"][:k], np.asarray(store_j.dP)[:k], atol=5e-3)
    np.testing.assert_allclose(store_t["dt"][:k], np.asarray(store_j.dt)[:k], atol=1e-6)


def test_trajectory_error(both):
    _, js, ts, _, _, gt = both
    ate_t = syn.ate_rmse(ts.trajectory_world_from_cam(), gt)
    ate_j = syn.ate_rmse(js.trajectory_world_from_cam(), gt)
    # measured 0.0211 and 0.0208 m with inertial_ba, 0.0171 and 0.0163 m without
    assert ate_t < 0.10 and ate_j < 0.10, (ate_t, ate_j)
    assert abs(ate_t - ate_j) < 5e-3
    assert int(ts.map.n_kf) == int(js.map.n_kf)
    assert abs(int(ts.vmap.count) - int(js.vmap.count)) <= 0.01 * int(js.vmap.count)


def test_dead_reckoning_pose(both):
    """``_predict_pose_imu`` (PredictStateIMU): the last keyframe's state
    carried through the IMU windows since, where the reference integrates
    its 1024-slot ring with the tail masked. Measured 0.9 mm and 1.5e-5
    (rotation entries) apart with ``inertial_ba``, 2.9 mm and 2.4e-4 without:
    the keyframe states differ by that much."""
    _, js, ts, _, _, gt = both
    assert ts._imu_ring and ts._imu_ring_n == js._imu_ring_n and not ts._imu_ring_overflow
    T_t, T_j = n(ts._predict_pose_imu()), np.asarray(js._predict_pose_imu())
    assert np.all(np.isfinite(T_t))
    assert np.linalg.norm(np.linalg.inv(T_t)[:3, 3] - np.linalg.inv(T_j)[:3, 3]) < 5e-3
    assert np.abs(T_t[:3, :3] - T_j[:3, :3]).max() < 2e-3


class ScalarReads(TorchDispatchMode):
    """Counts reads of a tensor's value by the host (``.item()``, ``int()``,
    ``bool()``, a 0-d tensor used as an index): each is a device sync on a card."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += "_local_scalar_dense" in str(func)
        return func(*args, **(kwargs or {}))


def test_next_frame_reads_no_device_scalar(both):
    """The IMU path adds no host read to a tracked frame: the one transfer a
    frame is ``System._sync``'s ``tolist`` (the last test of the file: it
    tracks one more frame on the port's system)."""
    inertial, _, ts, _, _, _ = both
    fr = sequence()[N_FRAMES[inertial]]
    refined = ts.n_vi_refine_kf + ts.n_vi_refine_frame
    with ScalarReads() as reads:
        ts.track(fr.img_l, fr.img_r, fr.t, fr.scan, fr.scan_valid, gyro=fr.gyro, acc=fr.acc,
                 imu_dts=fr.imu_dts, imu_trel=fr.imu_trel, scan_times=fr.scan_times)
    assert ts.state == tsys.TrackingState.OK
    assert ts.n_vi_refine_kf + ts.n_vi_refine_frame == refined + int(inertial)
    assert reads.n == 0


def track_next(ts, fr, blank=False):
    img_l, img_r = (np.zeros_like(fr.img_l),) * 2 if blank else (fr.img_l, fr.img_r)
    return ts.track(img_l, img_r, fr.t, fr.scan, fr.scan_valid, gyro=fr.gyro, acc=fr.acc,
                    imu_dts=fr.imu_dts, imu_trel=fr.imu_trel, scan_times=fr.scan_times)


def test_lost_frame_dead_reckons(both):
    """A frame with blank images is RECENTLY_LOST. With a matured inertial
    stack its pose is ``_predict_pose_imu``'s (the keyframe's state through
    the preintegration since then), else the motion model's prediction
    (measured 4.1 and 7.3 cm from the unaligned ground truth one frame on)."""
    inertial, _, ts, _, _, _ = both
    fr = sequence()[N_FRAMES[inertial] + 1]
    T = n(track_next(ts, fr, blank=True))
    assert ts.state == tsys.TrackingState.RECENTLY_LOST
    assert ts.n_imu_bad == 0 and ts._vi_initialized == inertial
    if inertial:
        np.testing.assert_array_equal(T, n(ts._predict_pose_imu()))
    else:
        np.testing.assert_allclose(T, n(ts.velocity) @ n(ts.last_T_cw), atol=1e-6)
    T_wc_gt = fr.T_wb_gt @ syn.body_from_cam()
    # the estimate lives in the first camera's frame
    T0 = sequence()[0].T_wb_gt @ syn.body_from_cam()
    assert np.linalg.norm(np.linalg.inv(T)[:3, 3] - (np.linalg.inv(T0) @ T_wc_gt)[:3, 3]) < 0.15


def test_ring_overflow_holds_the_refinement_off(both):
    """More IMU slots since the keyframe than the ring holds: the window is
    dropped and flagged, the per-frame refinement holds off and drops its
    prior chain until the next keyframe starts the ring again."""
    inertial, _, ts, _, _, _ = both
    fr = sequence()[N_FRAMES[inertial] + 2]
    ts.IMU_RING_CAP = ts._imu_ring_n + fr.imu_dts.shape[0] - 1
    n_kf, n_ring = ts.n_kf_host, len(ts._imu_ring)
    refined = ts.n_vi_refine_kf + ts.n_vi_refine_frame
    track_next(ts, fr)
    del ts.IMU_RING_CAP
    assert ts.state == tsys.TrackingState.OK
    if ts.n_kf_host > n_kf:
        # the frame made a keyframe: its factor took the whole buffer and the ring starts again
        assert not ts._imu_ring_overflow and ts._imu_ring_n == 0
        assert ts._has_factor_host[ts.n_kf_host - 1]
    else:
        assert ts._imu_ring_overflow and len(ts._imu_ring) == n_ring
        assert ts._frame_prior is None
        assert ts.n_vi_refine_kf + ts.n_vi_refine_frame == refined


def test_initialization_ladder_rung(both):
    """The ladder's next rung (VIBA 1: looser bias priors, then the inertial
    BA over the 20-slot window without BALM) opens 5 s after the first
    initialization and advances only when it ran: keyframe poses stay
    within 2 cm and velocities within 0.1 m/s of where they were (measured
    9.6 mm and 0.055 m/s). Without an initialization the ladder stays shut."""
    inertial, _, ts, _, _, _ = both
    kf = ts.n_kf_host - 1
    k = ts.n_kf_host
    T0, v0 = n(ts.map.kf_T_cw)[:k].copy(), n(ts.imu_store.vel)[:k].copy()
    ts._maybe_refine_imu_init(kf)
    assert ts._vi_stage == 0            # too early (or never initialised)
    if not inertial:
        assert ts._vi_init_time is None and not ts._initialize_imu(kf, stage=1)
        return
    ts._vi_init_time = ts._last_t - 5.5
    n_lvi = ts.n_lvi_ba
    ts._maybe_refine_imu_init(kf)
    assert ts._vi_stage == 1 and ts.n_lvi_ba == n_lvi     # the rung's BA is not a window pass
    T1, v1 = n(ts.map.kf_T_cw)[:k], n(ts.imu_store.vel)[:k]
    assert np.all(np.isfinite(T1)) and np.all(np.isfinite(v1))
    d = np.linalg.norm(np.linalg.inv(T1)[:, :3, 3] - np.linalg.inv(T0)[:, :3, 3], axis=-1)
    assert d.max() < 2e-2 and d.max() > 0.0, d
    assert np.abs(v1 - v0).max() < 0.1
    np.testing.assert_array_equal(T1[0], T0[0])            # the window's first pose is the anchor
    assert bool(ts.imu_store.vel_opt[:k].all())
