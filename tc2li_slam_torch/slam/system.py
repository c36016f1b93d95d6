"""System facade: the per-frame entry point and the host state machine
(port of ``tc2li_slam_tpu/slam/system.py``, STEREO_LIDAR and IMU_STEREO_LIDAR
modes; ``slam.checkpoint`` saves and restores it).

    per frame:  build_frame -> const-velocity predict -> track_step
                (guided match + pose-only LM) -> stage the scan at the
                tracked pose -> batched voxel-map insert every few frames
                -> keyframe decision
    per KF:     stereo landmarks gated by the LiDAR map, planar LiDAR
                features, BoW words when a vocabulary is given, and with
                ``cfg.loop_closing`` the loop candidates of the keyframe;
                on the next frame the loop closure if a candidate verifies
                (Sim3 RANSAC, pose graph, a global BA over the newest 64
                keyframes), then the mapping pass (landmark culling, new map
                points triangulated against the covisible neighbours, fuse,
                local BA with the BALM eigen-factor, keyframe culling)
    on loss:    window-free recovery (global match + PnP RANSAC), BoW
                relocalization, RECENTLY_LOST with dead reckoning, then
                LOST: the map is frozen into the atlas and a new one starts
                (also on a timestamp jump)

In IMU mode (``cfg.use_imu``, IMU samples passed to ``track``) the FAST-LIO2
scan step runs first: ESEKF predict over the frame's IMU window, scan
undistortion, the iterated point-to-plane update against the voxel map and
the map insert. The filter's relative motion replaces the constant-velocity
prediction. Keyframes carry the IMU preintegration since the previous one;
with ``cfg.inertial_ba`` the mapping pass runs the staged visual-inertial
initialization once four keyframes exist, then the temporal-window LVI-BA
in place of the covisibility BA, and every tracked frame's pose is refined
against its IMU factor (last keyframe or last frame with the
marginalization prior chain).

Every pool lives on the device given to ``System``. A frame makes one
device-to-host transfer: the tracker's inlier count, fetched together with
the scalars earlier keyframe events left pending (reference-KF tracked
count, covisibility window, culled keyframe, the scan step's bad-IMU flag).
A frame that fails to track
reads one more scalar per rung of the recovery ladder, as the reference
does. Host data goes to the device through pinned memory without a stream
sync.

Loop closing (``cfg.loop_closing`` and a vocabulary) detects at every
keyframe past ``cfg.loop_min_kf``: the candidate ladder runs on the device at
the keyframe event and its result rides in the next frame's transfer, so a
keyframe at which no loop closes costs no transfer of its own. The closure
itself (a rare event) reads one scalar pair per verified candidate and the
neighbour table of the edge list. ``_try_close_loop(kf_id)`` called by hand
detects, verifies and closes at once, as the reference does at the keyframe.
"""

from __future__ import annotations

import numpy as np
import torch

from ..estimation import esekf, imu as imu_est
from ..geom import camera as cam_mod, lie
from ..ops import bow, plane_fit, pointcloud, voxel_map
from ..ops.kernels import local_ba as local_ba_kernel
from ..solver import balm as balm_mod, inertial_ba, inertial_init, pose_inertial as pi_mod
from ..tensors import axis_vector, count, to_device
from . import (atlas as atlas_mod, config as cfg_mod, culling, imu_mode, lio, local_mapping,
               loop_closing, mapstate, profiling, relocalization, tracking, trajectory,
               triangulation)


class TrackingState:
    NOT_INITIALIZED = 0
    OK = 1
    RECENTLY_LOST = 2
    LOST = 3


class System:
    """Stereo+LiDAR(+IMU) SLAM system (System::TrackStereoLidar) on one device."""

    # slots a frame's IMU window may fill since the last keyframe before the
    # per-frame refinement holds off (the reference's ring capacity)
    IMU_RING_CAP = 1024
    # (priorG, priorA) bias-prior weights of the refinement stages, and the
    # time since the first initialization at which each stage opens (s)
    VI_STAGE_PRIORS = ((1e2, 1e6), (1.0, 1e4), (0.1, 1e3))
    VI_STAGE_TIMES = (0.0, 5.0, 15.0)
    GLOBAL_BA_KFS = 64   # keyframes of the global BA after a loop closure

    def __init__(self, cfg: cfg_mod.SystemConfig, device: torch.device | str,
                 voc: bow.Vocabulary | None = None, mesh=None):
        """``voc`` is the place-recognition vocabulary (``ops.bow``); with
        one, each keyframe stores its words, a lost frame relocalizes, and
        with ``cfg.loop_closing`` loops are detected and closed. ``mesh``
        (``parallel.dist_ba.Mesh``) sends the mapping pass's local BA through
        the distributed solver; every rank runs the whole frame loop."""
        self.cfg = cfg
        self.mesh = mesh
        self.device = torch.device(device)
        dev = self.device
        if dev.type == "cuda" and cfg.tracking.local_window > local_ba_kernel.MAX_POSES:
            raise ValueError(
                f"tracking.local_window {cfg.tracking.local_window}: the window BA's kernel "
                f"(local_ba_lm) takes at most {local_ba_kernel.MAX_POSES} poses on the card")
        self.voc = None if voc is None else voc.to(dev)
        c = cfg.camera
        self.cam = cam_mod.Pinhole.create(c.fx, c.fy, c.cx, c.cy, bf=c.bf,
                                          width=c.width, height=c.height)
        self.scale_factors = to_device(cfg.orb.scale_factors(), torch.float32, dev)
        self.sigma2 = to_device(cfg.orb.sigma2(), torch.float32, dev)
        t = cfg.tracking
        self.map = mapstate.create(max_kf=t.max_kf, max_feats=cfg.orb.n_features,
                                   max_lm=t.max_lm, max_obs=t.max_obs, device=dev)
        self.T_cl = to_device(cfg.lidar.T_cl, torch.float32, dev)
        self.lidar_enabled = cfg.lidar.enabled
        self.vmap = self.lidar_store = None
        if self.lidar_enabled:
            self.vmap = voxel_map.create(cfg.lidar.map_capacity, cfg.lidar.map_voxel, device=dev)
            self.lidar_store = local_mapping.LidarStore.create(t.max_kf, cfg.lidar.kf_points, dev)
            self.lio_cfg = lio.LioConfig(
                scan_voxel=cfg.lidar.scan_voxel, map_voxel=cfg.lidar.map_voxel,
                plane_thresh=cfg.lidar.plane_thresh, meas_cov=cfg.lidar.meas_cov,
                max_iters=cfg.lidar.max_iters, det_range=cfg.lidar.det_range,
                blind=cfg.lidar.blind, work_cap=cfg.lidar.lio_work_cap)

        eye = torch.eye(4, dtype=torch.float32, device=dev)
        self.state = TrackingState.NOT_INITIALIZED
        self.localization_only = False    # ActivateLocalizationMode
        self._last_t: float | None = None  # timestamp-jump guard
        self.T_cw = eye                   # current pose, world -> camera
        self.velocity = eye               # T_cw_k @ inv(T_cw_{k-1})
        self.last_T_cw = eye
        self.ref_kf = -1
        self.n_kf_host = 0                # host mirror of map.n_kf
        self.kf_alive = [True] * t.max_kf  # host mirror of kf_valid
        self.ref_kf_tracked = 0
        self.frames_since_kf = 0
        self.frame_idx = -1
        # atlas multi-map recovery (CreateMapInAtlas)
        self.atlas = atlas_mod.Atlas()
        self.map_id = 0
        self.n_lost = 0
        self.kf_words = self._new_kf_words()
        # draws the PnP hypotheses of the recovery and relocalization paths
        self._generator = torch.Generator(device=dev).manual_seed(0)
        # (timestamp, map_id, ref_kf, T_cur_wrt_ref on the device)
        self.traj: list[tuple[float, int, int, torch.Tensor]] = []
        self.timers = profiling.StageTimer(dev, enabled=cfg.profile)
        self._pending_mapping: int | None = None   # KF whose mapping pass is due
        self._pending_fetch: dict[str, torch.Tensor] = {}  # read at the next sync
        self._covis: tuple[list[int], list[int]] | None = None
        self._lidar_pending: list[tuple[torch.Tensor, torch.Tensor]] = []
        self._last_staged_scan = None
        self.n_ba = 0          # local BA passes run
        self.n_ba_balm = 0     # ... of which carried the BALM eigen-factor
        self.n_fuse = 0        # fuse_into_keyframe passes run
        self.n_recover = 0     # track_step_recover calls
        self.n_reloc = 0       # relocalization attempts
        # loop closing
        self.n_loops_closed = 0
        self.n_loop_verified = 0   # candidates that reached verify_candidate
        self.last_loop = None      # (kf_id, LoopCandidate) of the last closure
        self._last_loop_kf = -100  # closure cooldown
        self._post_loop_ba = True  # global BA after the pose graph
        self._word_idf = None if self.voc is None else bow.word_idf(self.voc)
        self._loop_kf_in_flight: int | None = None   # its candidates are in _pending_fetch
        self._loop_cands: tuple[int, list[int]] | None = None   # fetched, not yet tried
        # landmarks allocated by triangulation: a device counter, read it
        # with int() after a run
        self.n_tri_landmarks = torch.zeros((), dtype=torch.int32, device=dev)

        # --- IMU_STEREO_LIDAR mode (LidarInertialProcess + inertial BA) ---
        self.use_imu = cfg.use_imu
        if self.use_imu:
            if not self.lidar_enabled:
                raise ValueError("use_imu needs the LiDAR (cfg.lidar.enabled)")
            self.filt = esekf.init_filter(device=dev)
            self.imu_noise = esekf.NoiseCfg.create(
                gyr=cfg.imu.noise_gyro * 100.0, acc=cfg.imu.noise_acc * 100.0,
                bg_rw=cfg.imu.gyro_walk, ba_rw=cfg.imu.acc_walk)
            self.imu_cal = imu_est.ImuCalib.create(
                cfg.imu.noise_gyro, cfg.imu.noise_acc, cfg.imu.gyro_walk, cfg.imu.acc_walk,
                device=dev)
            self.T_bc = to_device(cfg.imu.T_bc, torch.float32, dev)
            self.T_cb = lie.se3_inverse(self.T_bc)
            self.imu_store = imu_mode.ImuKfStore.create(t.max_kf, dev)
            self.gravity_vis = axis_vector(1, 9.81, dev)   # set at the static init
            self._imu_initialized = False
            self._last_filt_Twc = None    # the filter's camera pose at the previous frame
            # staged visual-inertial initialization (InitializeIMU): True once
            # gravity, biases and velocities were optimised on the keyframe map
            self._vi_initialized = False
            self._vi_stage = 0            # 0 = first init, 1 = after 5 s, 2 = after 15 s
            self._vi_init_time = None     # timestamp of the first init
            self._has_factor_host = [False] * t.max_kf   # mirror of imu_store.has_factor
            # IMU windows since the last keyframe, live samples only, as
            # (gyro [n, 3], acc [n, 3], dts [n]) device tensors: the keyframe
            # factor integrates _imu_buf, the per-frame refinement _imu_ring
            # (which stops growing once IMU_RING_CAP slots were offered)
            self._imu_buf: list = []
            self._imu_ring: list = []
            self._imu_ring_n = 0           # slots offered since the last keyframe
            self._imu_ring_overflow = False
            self._last_imu_window = None
            # per-frame pose-inertial refinement: the marginalization-prior chain
            self._frame_prior = None       # FramePrior of the previous frame
            self._prev_vi_state = None
            self._vi_vel = torch.zeros(3, dtype=torch.float32, device=dev)
            self._last_frame = None
            self.n_lvi_ba = 0       # LVI-BA passes (the local window's; not a full one)
            self.n_lvi_ba_balm = 0  # ... of which carried the BALM term
            self.n_vi_refine_kf = 0     # frames refined by optimize_last_kf
            self.n_vi_refine_frame = 0  # frames refined by optimize_last_frame
            self.n_imu_init = 0     # static initializations of the filter
            self.n_imu_reset = 0    # _reset_imu calls
            self.n_imu_bad = 0      # scan steps that came back bad

    def _new_kf_words(self) -> torch.Tensor | None:
        """[K, F] sorted BoW word ids per keyframe (-1 pads), with a vocabulary."""
        if self.voc is None:
            return None
        return torch.full((self.cfg.tracking.max_kf, self.cfg.orb.n_features), -1,
                          dtype=torch.int32, device=self.device)

    def activate_localization_mode(self, on: bool = True):
        """Localization only: track against the frozen map, create no
        keyframes and no landmarks (System::ActivateLocalizationMode)."""
        self.localization_only = on

    # ------------------------------------------------------------------
    def _input(self, x, dtype=None) -> torch.Tensor:
        if isinstance(x, torch.Tensor):
            return x.to(self.device, dtype=dtype, non_blocking=True)
        return to_device(x, dtype, self.device)

    def track(self, img_l, img_r, t: float, scan=None, scan_valid=None, gyro=None, acc=None,
              imu_dts=None, imu_trel=None, scan_times=None) -> torch.Tensor:
        """Process one stereo(+LiDAR[+IMU]) frame; returns T_cw [4, 4] (device).

        Images are [H, W] (uint8 or float); ``scan`` is [N, 3] float32 in the
        LiDAR frame. Without ``scan_valid`` every point counts: padding slots
        are expected zeroed, inside the blind radius.

        In IMU mode ``gyro`` / ``acc`` [W, 3], ``imu_dts`` [W] (0 = padding)
        and ``imu_trel`` [W] (sample times within the scan, +inf padded) are
        the IMU window since the previous frame, as host arrays (the host
        reads which samples are live), and ``scan_times`` [N] the per-point
        times (zeros when absent). The scan step runs first and gives the
        motion prediction for visual tracking."""
        self.frame_idx += 1
        # a gap above 1 s, or time running backwards, means the sensor stream
        # broke: freeze the map into the atlas and restart tracking
        if self._last_t is not None and self.state != TrackingState.NOT_INITIALIZED:
            dt_frame = float(t) - self._last_t
            if dt_frame > 1.0 or dt_frame < 0.0:
                self._create_map_in_atlas()
                if self.use_imu:
                    self._reset_imu()
        self._last_t = float(t)
        img_l, img_r = self._input(img_l), self._input(img_r)
        if scan is not None:
            scan = self._input(scan, torch.float32)
            scan_valid = (torch.ones(scan.shape[0], dtype=torch.bool, device=self.device)
                          if scan_valid is None else self._input(scan_valid, torch.bool))
        with self.timers.stage("frame"):
            if self.use_imu and gyro is not None and scan is not None:
                with self.timers.stage("lio"):
                    self._lio_step(scan, scan_times, scan_valid, gyro, acc, imu_dts, imu_trel)
            with self.timers.stage("build_frame"):
                frame = tracking.build_frame(
                    img_l, img_r, self.cam, self.scale_factors,
                    n_features=self.cfg.orb.n_features, n_levels=self.cfg.orb.n_levels)
            if self.state == TrackingState.NOT_INITIALIZED:
                self._stereo_initialization(frame, t, scan, scan_valid)
            else:
                self._track_frame(frame, t, scan, scan_valid)
            self._record_pose(t)
        return self.T_cw

    # ------------------------------------------------------------------
    def _stereo_initialization(self, frame, t, scan, scan_valid):
        """StereoInitialization: first KF + stereo landmarks."""
        n_depth = int(torch.sum(frame.valid & (frame.depth > 0)))
        if n_depth < 100:
            return
        # map 0 starts at the origin; a recovery map is anchored at the
        # dead-reckoned pose, so the exported trajectory stays continuous
        if self.map_id == 0:
            self.T_cw = torch.eye(4, dtype=torch.float32, device=self.device)
        kf_id = self._create_keyframe(
            frame, t, scan, scan_valid, run_ba=False,
            feat_lm=torch.full((self.map.F,), mapstate.NO_LM, dtype=torch.int32,
                               device=self.device))
        self.state = TrackingState.OK
        self.ref_kf = kf_id
        self.ref_kf_tracked = n_depth
        self.velocity = torch.eye(4, dtype=torch.float32, device=self.device)

    # ------------------------------------------------------------------
    def _sync(self, n_inliers: torch.Tensor) -> int:
        """The frame's one device->host transfer: the inlier count plus the
        scalars pending from the last keyframe event."""
        names = list(self._pending_fetch)
        parts = [n_inliers.reshape(1).to(torch.int64)]
        parts += [self._pending_fetch[k].reshape(-1).to(torch.int64) for k in names]
        vals = torch.cat(parts).tolist()
        n_inl, off = vals[0], 1
        bad_imu = False
        for k in names:
            n = self._pending_fetch[k].numel()
            v = vals[off:off + n]
            off += n
            if k == "ref_kf_tracked":
                self.ref_kf_tracked = v[0]
            elif k == "killed":
                if v[0] >= 0:
                    self.kf_alive[v[0]] = False
            elif k == "covis":
                half = n // 2
                self._covis = (v[:half], v[half:])
            elif k == "imu_bad":
                bad_imu = bool(v[0])
            elif k == "loop_cands":
                self._loop_cands = (self._loop_kf_in_flight, [c for c in v if c >= 0])
        self._pending_fetch = {}
        if bad_imu:
            # a diverged or non-finite filter: the device side already
            # reverted the state and skipped the insert; re-arm the inertial
            # stack (the static init will converge again)
            self.n_imu_bad += 1
            self._reset_imu()
        return n_inl

    def _stage_scan(self, scan, scan_valid, T_cw):
        """Preprocess the scan at ``T_cw`` for the batched map insert."""
        with self.timers.stage("lidar_update"):
            staged = lio.camera_scan_stage(
                scan, scan_valid, T_cw, self.T_cl, self.cfg.lidar.blind,
                self.cfg.lidar.map_voxel, insert_cap=self.cfg.lidar.insert_cap)
            self._lidar_pending.append(staged)
            self._last_staged_scan = staged
        return staged

    def _track_frame(self, frame, t, scan, scan_valid):
        tc = self.cfg.tracking
        T_pred = self.velocity @ self.T_cw
        with self.timers.stage("track_step"):
            new_map, res, T_new, vel_new = tracking.track_step(
                self.map, frame, self.T_cw, self.velocity, self.cam,
                self.scale_factors, self.sigma2, tc.match_radius_narrow)
        # stage the scan at the un-synced tracked pose (UpdateMap): it needs
        # no host decision, and overlaps the frame's sync
        staged = None
        stage_scans = self.lidar_enabled and scan is not None and not self.use_imu
        if stage_scans:
            staged = self._stage_scan(scan, scan_valid, res.T_cw)
        with self.timers.stage("sync"):
            n_inl = self._sync(res.n_inliers)

        if n_inl < max(tc.min_inliers, 10):
            # the optimistic staging above used a failed pose: drop it
            if staged is not None and self._lidar_pending \
                    and self._lidar_pending[-1] is staged:
                self._lidar_pending.pop()
                staged = None
            # window-free global re-acquisition + refinement, gated on the
            # host so that a frame that tracks never pays for it
            with self.timers.stage("track_recover"):
                self.n_recover += 1
                new_map, res, T_new, vel_new = tracking.track_step_recover(
                    self.map, frame, self.T_cw, T_pred, self.velocity, self.cam,
                    self.scale_factors, self.sigma2, tc.match_radius_narrow,
                    generator=self._generator)
                n_inl = int(res.n_inliers)

        if n_inl < 10 and self.voc is not None:
            # relocalization: BoW candidates + PnP RANSAC
            with self.timers.stage("relocalize"):
                self.n_reloc += 1
                rr = relocalization.relocalize(
                    self.map, frame, self.cam, self.voc, self.kf_words, self.sigma2,
                    generator=self._generator)
            if rr.ok:
                n_dev = torch.full((), rr.n_inliers, dtype=torch.int32, device=self.device)
                res = tracking.TrackResult(rr.T_cw, rr.feat_lm, n_dev, n_dev)
                n_inl = rr.n_inliers
                T_new = rr.T_cw
                # the motion model is void after a relocalization
                vel_new = torch.eye(4, dtype=torch.float32, device=self.device)

        if n_inl < 10:
            self.state = TrackingState.RECENTLY_LOST
            self.n_lost += 1
            self.last_T_cw = self.T_cw
            # dead reckoning: the motion model's prediction, or with a matured
            # inertial stack the last keyframe's state carried through the
            # IMU preintegration since then (PredictStateIMU)
            if (self.use_imu and self._vi_initialized and self._imu_ring
                    and not self._imu_ring_overflow):
                T_new = self._predict_pose_imu()
            self.T_cw = T_new
            self.frames_since_kf += 1
            if self.n_lost >= tc.recently_lost_frames:
                # RECENTLY_LOST -> LOST: freeze the map, start a new one
                self._create_map_in_atlas()
            return

        self.state = TrackingState.OK
        self.n_lost = 0
        self.last_T_cw = self.T_cw
        self.T_cw = T_new
        self.velocity = vel_new
        self.map = new_map

        # the loop candidates of the keyframe created last frame arrived with
        # the sync: verify and close before that keyframe's mapping pass
        self._close_pending_loop()

        # the mapping pass for the keyframe created last frame (the
        # reference's LocalMapping thread runs it while tracking continues)
        if self._pending_mapping is not None:
            with self.timers.stage("mapping"):
                kf_q, self._pending_mapping = self._pending_mapping, None
                self._mapping_step(kf_q)

        # tightly-coupled pose refinement (reprojection + the IMU factor)
        # once the inertial stack is initialised
        if self.use_imu and self._imu_initialized and self._vi_initialized:
            self._last_frame = frame
            with self.timers.stage("vi_refine"):
                self._vi_frame_refine(res)

        # a recovered frame dropped its staging: stage at the recovered pose
        if staged is None and stage_scans:
            self._stage_scan(scan, scan_valid, self.T_cw)
        if len(self._lidar_pending) >= self.cfg.lidar.insert_every:
            with self.timers.stage("lidar_update"):
                self._lidar_flush()

        if self.localization_only:
            self.frames_since_kf += 1
            return

        if self._need_new_keyframe(n_inl):
            with self.timers.stage("keyframe"):
                self._create_keyframe(frame, t, scan, scan_valid, res.feat_lm, run_ba=True)
            self.frames_since_kf = 0
        else:
            self.frames_since_kf += 1

    def _need_new_keyframe(self, n_inliers: int) -> bool:
        """NeedNewKeyFrame: reference-KF track ratio + interval bounds."""
        t = self.cfg.tracking
        if self.frames_since_kf < t.kf_min_interval:
            return False
        if self.frames_since_kf >= t.kf_max_interval:
            return True
        return n_inliers < t.kf_track_ratio * max(self.ref_kf_tracked, 1)

    # ------------------------------------------------------------------
    def _kf_create(self, kf_id: int, frame, t, feat_lm, use_lidar: bool):
        """Keyframe snapshot + gated stereo landmark allocation: (map, rkt)."""
        m, T_cw, cam = self.map, self.T_cw, self.cam
        ts = torch.full((), float(t), dtype=torch.float32, device=self.device)
        m, _ = mapstate.add_keyframe(m, T_cw, ts, frame.xy, frame.uvr, frame.level,
                                     frame.angle, frame.desc, frame.valid, feat_lm)
        pos, normal, dist, want = tracking.stereo_landmark_candidates(
            frame, T_cw, cam, feat_lm, cam_mod.f32(self.cfg.camera.th_depth),
            self.scale_factors)
        want = want & ~tracking.near_existing_landmark(m, frame, T_cw, cam, 4.0, 0.15)
        if use_lidar:
            # tightly-coupled depth gate: a new stereo landmark must lie on a
            # LiDAR plane (the first 512 candidates are checked)
            sel_q = torch.sort((~want).to(torch.uint8), stable=True).indices[:512]
            pos_q = pos[sel_q]
            _, nbrs, nbv = voxel_map.knn(self.vmap, pos_q, k=5, radius=2)
            nrm, dpl, p_ok = plane_fit.fit_planes(nbrs, nbv, threshold=0.3)
            pd = torch.abs(plane_fit.point_to_plane(pos_q, nrm, dpl))
            cam_c = lie.translation(lie.se3_inverse(T_cw))
            tol = torch.clamp(0.06 * torch.linalg.norm(pos_q - cam_c, dim=-1), 0.3, 1.0)
            lidar_ok = torch.zeros(m.F, dtype=torch.bool, device=self.device)
            lidar_ok[sel_q] = p_ok & (pd < tol)
            want = want & lidar_ok
        m, _ = mapstate.add_landmarks(
            m, kf_id, torch.arange(m.F, dtype=torch.int32, device=self.device),
            pos, frame.desc, normal, dist, want)
        rkt = count(m.kf_feat_lm[kf_id] != mapstate.NO_LM)
        return m, rkt

    def _create_keyframe(self, frame, t, scan, scan_valid, feat_lm, run_ba: bool) -> int:
        if self.lidar_enabled and not self.use_imu:
            self._lidar_flush()   # the KF event reads the voxel map
        tc = self.cfg.tracking
        kf_id = min(self.n_kf_host, tc.max_kf - 1)
        self.n_kf_host = min(self.n_kf_host + 1, tc.max_kf)
        use_gate = self.lidar_enabled and scan is not None and self.frame_idx > 0
        self.map, rkt = self._kf_create(kf_id, frame, t, feat_lm, use_gate)
        if self.lidar_enabled and scan is not None:
            self._store_kf_lidar(kf_id, scan, scan_valid)
        if self.voc is not None:
            words, _ = bow.quantize(self.voc, frame.desc, frame.valid, self.voc.depth)
            self.kf_words = self.kf_words.index_copy(
                0, mapstate.as_index(kf_id, self.device), torch.sort(words).values[None])
        if self.use_imu:
            self._store_kf_imu(kf_id)
        self.ref_kf = kf_id
        # read at the next frame's sync (one-frame lag, no blocking)
        self._pending_fetch["ref_kf_tracked"] = rkt
        # loop detection (per keyframe, when place recognition is available,
        # the config enables it and the closure cooldown is over): the
        # candidates join the next sync
        if (self.voc is not None and self.cfg.loop_closing and run_ba
                and kf_id > self.cfg.loop_min_kf and kf_id >= self._last_loop_kf + 10):
            with self.timers.stage("loop_detect"):
                self._pending_fetch["loop_cands"] = loop_closing.detect_candidates_device(
                    self.map, kf_id, self.kf_words, min_gap=self.cfg.loop_min_gap, n_best=3,
                    word_weights=self._word_idf, n_kf=self.n_kf_host)
            self._loop_kf_in_flight = kf_id
        if run_ba and self.n_kf_host >= 3:
            self._pending_mapping = kf_id
            neigh, w = mapstate.top_covisible(self.map, kf_id, tc.local_window - 1,
                                              min_weight=10)
            self._pending_fetch["covis"] = torch.cat([neigh, w.to(torch.int32)])
        return kf_id

    def _store_kf_lidar(self, kf_id: int, scan, scan_valid):
        """Downsample + planar-select the keyframe's scan, best points first
        (BuildLidarFeat4KeyFrame); reuses this frame's staged scan."""
        lc = self.cfg.lidar
        T_wl = lie.se3_inverse(self.T_cw) @ self.T_cl
        if (not self.use_imu and self._last_staged_scan is not None
                and lc.scan_voxel == lc.map_voxel):
            src, dsv = self._last_staged_scan
            ds = lie.se3_apply(lie.se3_inverse(T_wl), src)
        else:
            keep = pointcloud.preprocess(scan, scan_valid, blind=lc.blind)
            ds, dsv = pointcloud.voxel_downsample(scan, keep, lc.scan_voxel)
        planar = lio.select_plane_features(self.vmap, ds, dsv, T_wl, self.lio_cfg)
        n = self.lidar_store.points.shape[1]
        order = torch.sort((~planar).to(torch.uint8), stable=True).indices
        self.lidar_store = self.lidar_store.set_kf(kf_id, ds[order][:n], planar[order][:n])

    def _lidar_flush(self):
        """Insert all staged scan batches into the voxel map at once."""
        if not self._lidar_pending:
            return
        pts = torch.cat([p for p, _ in self._lidar_pending])
        val = torch.cat([v for _, v in self._lidar_pending])
        self._lidar_pending = []
        center = lie.translation(lie.se3_inverse(self.T_cw) @ self.T_cl)
        self.vmap = lio.camera_map_flush(self.vmap, pts, val, center)

    def flush_mapping(self):
        """Run any deferred loop closure and mapping work and land staged
        scans now."""
        if self._pending_fetch:
            self._sync(torch.zeros((), dtype=torch.int32, device=self.device))
        self._close_pending_loop()
        if self._pending_mapping is not None:
            kf_q, self._pending_mapping = self._pending_mapping, None
            self._mapping_step(kf_q)
        if self.lidar_enabled and not self.use_imu:
            self._lidar_flush()
        if self._pending_fetch:
            self._sync(torch.zeros((), dtype=torch.int32, device=self.device))

    # ------------------------------------------------------------------
    def _mapping_step(self, kf_id: int):
        """LocalMapping pass for a new keyframe: MapPointCulling ->
        CreateNewMapPoints -> Fuse (both directions) -> landmark stats ->
        local BA -> KeyFrameCulling."""
        t = self.cfg.tracking
        lc = self.cfg.lidar
        covis, self._covis = self._covis, None
        window, fixed = local_mapping.select_window(
            t.local_window, kf_id, self.n_kf_host, self.kf_alive, covis)
        T_ref_old = self.map.kf_T_cw[kf_id]
        with self.timers.stage("maintain"):
            neighbors = sorted((w for w in window if w not in (kf_id, mapstate.NO_KF)),
                               reverse=True)
            m = culling.cull_landmarks(self.map, kf_id)
            if t.triangulate:
                nbs = neighbors[:t.tri_pairs]
                n_before = m.n_lm
                m = triangulation.triangulate_batch(
                    m, kf_id, nbs + [mapstate.NO_KF] * (t.tri_pairs - len(nbs)),
                    self.cam, self.sigma2, self.scale_factors, max_pairs=t.tri_pairs)
                self.n_tri_landmarks = self.n_tri_landmarks + (m.n_lm - n_before)
            for kf in [kf_id] + neighbors[:1]:
                m = culling.fuse_into_keyframe(m, kf, self.cam, self.scale_factors)
                self.n_fuse += 1
            self.map = mapstate.update_landmark_stats(m)
        with self.timers.stage("local_ba"):
            use_lvi = self.use_imu and self.cfg.inertial_ba
            if use_lvi and not self._vi_initialized:
                # the staged bootstrap needs a few consecutive keyframes with factors
                if self.n_kf_host >= 4:
                    self._initialize_imu(kf_id)
                use_lvi = self._vi_initialized
            if use_lvi:
                self._run_lvi_ba(kf_id)
                self.n_lvi_ba += 1
                self.n_lvi_ba_balm += int(self.lidar_enabled and lc.w_lba > 0)
                # the refinement ladder runs before the reference pose is
                # recomposed below, so the current frame follows its correction
                self._maybe_refine_imu_init(kf_id)
            else:
                self.map = local_mapping.run_local_ba(
                    self.map, self.lidar_store, self.cam, self.sigma2, self.T_cl,
                    window, fixed, balm_window=lc.balm_window, balm_voxel=lc.balm_voxel,
                    balm_max_voxels=lc.balm_max_voxels, balm_min_points=lc.balm_min_points,
                    w_lba=lc.w_lba if self.lidar_enabled else 0.0, iters=t.ba_iters,
                    max_active=t.ba_active_landmarks, mesh=self.mesh)
                self.n_ba_balm += int(self.lidar_enabled and lc.w_lba > 0)
            self.n_ba += 1
        # the current frame follows the BA's correction of its reference KF
        T_ref_new = self.map.kf_T_cw[kf_id]
        self.T_cw = (self.T_cw @ lie.se3_inverse(T_ref_old)) @ T_ref_new
        if (t.cull_kf_every > 0 and kf_id % t.cull_kf_every == 0
                and self.n_kf_host > t.local_window + 4):
            with self.timers.stage("cull_kf"):
                self._cull_keyframes(set(window) | {0, kf_id})

    def _cull_keyframes(self, protect: set[int]):
        """KeyFrameCulling: invalidate the most redundant keyframe on the
        device; the slot id reaches the host mirror at the next sync."""
        K = self.map.K
        pm = np.zeros(K, bool)
        pm[[k for k in protect if 0 <= k < K]] = True
        self.map, killed = culling.cull_keyframes(
            self.map, to_device(pm, torch.bool, self.device),
            thresh=self.cfg.tracking.cull_kf_redundancy)
        if self.lidar_enabled or self.voc is not None:
            kill_mask = torch.zeros(K, dtype=torch.bool, device=self.device).index_put(
                (torch.clamp(killed, 0, K - 1).reshape(1).long(),), (killed >= 0).reshape(1))
        if self.lidar_enabled:
            self.lidar_store = self.lidar_store.replace(
                valid=self.lidar_store.valid & ~kill_mask[:, None])
        if self.voc is not None:
            self.kf_words = torch.where(kill_mask[:, None], -1, self.kf_words)
        self._pending_fetch["killed"] = killed

    # ------------------------------------------------------------------
    # IMU mode
    # ------------------------------------------------------------------
    def _lio_step(self, scan, scan_times, scan_valid, gyro, acc, dts, trel):
        """Run the LiDAR-inertial scan step and refresh the motion
        prediction from the filter's relative motion."""
        dev = self.device
        dts_h = np.asarray(dts, np.float32)
        live = np.nonzero(dts_h > 0)[0]
        n_slots = dts_h.shape[0]
        if not self._imu_initialized and live.size < 3:
            return   # wait for a window with real IMU data (frame 0 has none)
        # the window's leading part up to its last live sample (at least two
        # slots, which is what scan undistortion needs): a padded slot is an
        # exact no-op in every loop over samples, and costs its launches
        n_keep = max(int(live[-1]) + 1 if live.size else 0, 2)
        g_dev = to_device(np.asarray(gyro, np.float32)[:n_keep], torch.float32, dev)
        a_dev = to_device(np.asarray(acc, np.float32)[:n_keep], torch.float32, dev)
        d_dev = to_device(dts_h[:n_keep], torch.float32, dev)
        trel_dev = to_device(np.asarray(trel, np.float32)[:n_keep], torch.float32, dev)
        if not self._imu_initialized:
            # static init: gravity + gyro bias from the first window
            self.filt = esekf.static_init(self.filt, g_dev, a_dev, d_dev > 0)
            # gravity in the visual world (the first camera's axes): the
            # first body's axes rotated by the camera-body extrinsic
            self.gravity_vis = lie.rotation(self.T_cb) @ self.filt.x.grav
            self._imu_initialized = True
            self.n_imu_init += 1
        st = (torch.zeros(scan.shape[0], dtype=torch.float32, device=dev)
              if scan_times is None else self._input(scan_times, torch.float32))
        res = lio.lio_scan_step(self.filt, self.vmap, scan, st, scan_valid, g_dev, a_dev,
                                d_dev, trel_dev, self.imu_noise, self.lio_cfg)
        self.filt, self.vmap = res.filt, res.map
        self.vmap, _ = lio.maybe_recenter(self.vmap, self.filt.x.pos)
        # the bad-IMU flag joins the scalars of this frame's one sync, where
        # the inertial stack is re-armed; frames that make no sync (a map
        # waiting for its first keyframe) accumulate it
        bad = res.bad
        if "imu_bad" in self._pending_fetch:
            bad = bad | self._pending_fetch["imu_bad"]
        self._pending_fetch["imu_bad"] = bad
        window = (g_dev, a_dev, d_dev)
        self._imu_buf.append(window)
        self._last_imu_window = window
        if self._imu_ring_n + n_slots > self.IMU_RING_CAP:
            # the since-keyframe window is no longer contiguous: the
            # per-frame refinement holds off until the next keyframe
            self._imu_ring_overflow = True
        else:
            self._imu_ring.append(window)
            self._imu_ring_n += n_slots
        # prediction: the filter's relative camera motion composed onto the
        # visual pose. On a bad scan the filter kept its state, the relative
        # motion would be the identity: keep the previous velocity instead.
        T_wc_lio = lie.se3(self.filt.x.R, self.filt.x.pos) @ self.T_bc
        if self._last_filt_Twc is not None:
            rel = lie.se3_inverse(T_wc_lio) @ self._last_filt_Twc
            self.velocity = torch.where(res.bad, self.velocity, rel)
        self._last_filt_Twc = T_wc_lio

    def _imu_ring_reset(self):
        self._imu_ring = []
        self._imu_ring_n = 0
        self._imu_ring_overflow = False

    def _integrate(self, windows, bg, ba) -> imu_est.Preintegrated:
        """Preintegration over a list of (gyro, acc, dts) windows."""
        g, a, d = (torch.cat(x) for x in zip(*windows))
        return imu_est.integrate(self.imu_cal, g, a, d, bg, ba)

    def _vi_frame_refine(self, res):
        """Per-frame tightly-coupled pose refinement: against the last
        keyframe right after a map update, against the previous frame and
        its marginalization prior otherwise. Adopts the refined pose and
        velocity and chains the prior; the adoption gate stays on the device."""
        if not self._imu_ring:
            return
        if self._imu_ring_overflow:
            # the preintegration since the keyframe would span a gap
            self._frame_prior = None
            return
        m, frame, cal = self.map, self._last_frame, self.imu_cal
        kf = max(self.ref_kf, 0)
        has_prev = self._prev_vi_state is not None
        use_last_frame = (self.frames_since_kf > 0 and self._frame_prior is not None
                          and has_prev)
        anchor = pi_mod.FrameVIState(
            T_wb=lie.se3_inverse(m.kf_T_cw[kf]) @ self.T_cb, vel=self.imu_store.vel[kf],
            bg=self.imu_store.bg[kf], ba=self.imu_store.ba[kf])
        # the landmarks matched to this frame (track_step's assignment)
        has = res.feat_lm != mapstate.NO_LM
        X_w = m.lm_pos[torch.clamp(res.feat_lm, 0, m.L - 1).long()]
        inv_s2 = 1.0 / self.sigma2[torch.clamp(frame.level, 0, self.sigma2.shape[0] - 1).long()]
        stereo = frame.uvr[:, 2] > 0
        valid = has & frame.valid
        T_wb0 = lie.se3_inverse(res.T_cw) @ self.T_cb
        state0 = pi_mod.FrameVIState(T_wb=T_wb0, vel=self._vi_vel if has_prev else anchor.vel,
                                     bg=anchor.bg, ba=anchor.ba)
        if use_last_frame:
            # this frame's window only, at the previous frame's biases
            prev = self._prev_vi_state
            pre = self._integrate([self._last_imu_window], prev.bg, prev.ba)
        else:
            pre = self._integrate(self._imu_ring, anchor.bg, anchor.ba)
        # the covariance floor of the keyframe store (imu_mode.set_kf)
        C = pre.C.clone()
        C[:9, :9] = imu_mode.floor_cov9(pre.C[:9, :9])
        pre = pre._replace(C=C)
        dt_c = torch.clamp(pre.dt, min=1e-3)
        info_bg = 1.0 / (cal.sigma_gw ** 2 * dt_c)
        info_ba = 1.0 / (cal.sigma_aw ** 2 * dt_c)
        if use_last_frame:
            out = pi_mod.optimize_last_frame(
                self.cam, self.T_cb, state0, prev, self._frame_prior, pre, self.gravity_vis,
                X_w, frame.uvr, inv_s2, stereo, valid, info_bg, info_ba)
            self.n_vi_refine_frame += 1
        else:
            out = pi_mod.optimize_last_kf(
                self.cam, self.T_cb, state0, anchor, pre, self.gravity_vis,
                X_w, frame.uvr, inv_s2, stereo, valid, info_bg, info_ba)
            self.n_vi_refine_kf += 1
        # adoption gate: a degenerate solve (few visual inliers behind it, or
        # a non-finite state) must not overwrite the accepted visual pose
        st_ok = torch.all(torch.isfinite(torch.cat(
            [out.state.T_wb.reshape(-1), out.state.vel, out.state.bg, out.state.ba])))
        good = (out.n_inliers >= 10) & st_ok
        T_cw_new = torch.where(good, lie.se3_inverse(out.state.T_wb @ self.T_bc), res.T_cw)
        fallback = pi_mod.FrameVIState(T_wb=T_wb0, vel=state0.vel, bg=state0.bg, ba=state0.ba)
        adopted = pi_mod.FrameVIState(
            *[torch.where(good, a, b) for a, b in zip(out.state, fallback)])
        self.T_cw = T_cw_new
        self.velocity = T_cw_new @ lie.se3_inverse(self.last_T_cw)
        self._vi_vel = adopted.vel
        # on failure the prior chain is dropped (weight 0 disables the factor)
        self._frame_prior = out.prior._replace(weight=out.prior.weight * good.to(torch.float32))
        self._prev_vi_state = adopted

    def _predict_pose_imu(self) -> torch.Tensor:
        """PredictStateIMU: dead-reckon the frame pose from the last
        keyframe's state and the IMU preintegration since then, when visual
        tracking failed."""
        kf = max(self.ref_kf, 0)
        T_wb_kf = lie.se3_inverse(self.map.kf_T_cw[kf]) @ self.T_cb
        pre = self._integrate(self._imu_ring, self.imu_store.bg[kf], self.imu_store.ba[kf])
        R1, p1 = T_wb_kf[:3, :3], T_wb_kf[:3, 3]
        # the state composition of the EdgeInertial model
        R2 = R1 @ pre.dR
        p2 = (p1 + self.imu_store.vel[kf] * pre.dt + 0.5 * self.gravity_vis * pre.dt * pre.dt
              + R1 @ pre.dP)
        return lie.se3_inverse(lie.se3(R2, p2) @ self.T_bc)

    def _reset_imu(self):
        """Re-arm the inertial stack after a bad-IMU or stream-break event."""
        self.n_imu_reset += 1
        self.filt = esekf.init_filter(device=self.device)
        self._imu_initialized = False
        self._vi_initialized = False
        self._imu_buf = []
        self._last_filt_Twc = None
        self.velocity = torch.eye(4, dtype=torch.float32, device=self.device)
        self._imu_ring_reset()
        self._frame_prior = None
        self._prev_vi_state = None
        self._pending_fetch.pop("imu_bad", None)
        self._vi_stage = 0
        self._vi_init_time = None

    def _store_kf_imu(self, kf_id: int):
        """The keyframe's inertial record: the preintegration since the
        previous keyframe, a velocity snapshot and the filter's biases."""
        pre = None
        if self._imu_buf and kf_id > 0:
            pre = self._integrate(self._imu_buf, self.filt.x.bg, self.filt.x.ba)
        self._imu_buf = []
        # velocity in visual-world axes; the per-frame refinement's estimate
        # once it runs (it lives in the visual frame)
        if self._prev_vi_state is not None and self._vi_initialized:
            v_vis = self._vi_vel
        else:
            v_vis = lie.rotation(self.T_cb) @ self.filt.x.vel
        self.imu_store = self.imu_store.set_kf(kf_id, pre, v_vis, bg=self.filt.x.bg,
                                               ba=self.filt.x.ba)
        if pre is not None:
            self._has_factor_host[kf_id] = True
        # the per-frame coupling restarts from the keyframe
        self._imu_ring_reset()
        self._frame_prior = None

    def _kf_body_poses(self, window_arr: torch.Tensor) -> torch.Tensor:
        """T_wb per window keyframe from the visual map, T_wb = inv(T_bc T_cw)."""
        return lie.se3_inverse(self.map.kf_T_cw[window_arr.long()]) @ self.T_cb

    def _seed_velocities(self, window_arr: torch.Tensor, T_wb_win: torch.Tensor):
        """Per-keyframe velocity seeds: an optimizer's output where there is
        one, else a finite difference of keyframe positions."""
        w = window_arr.long()
        pos_w = T_wb_win[:, :3, 3]
        dts = torch.clamp(self.imu_store.dt[w][1:], min=1e-2)
        v_mid = (pos_w[1:] - pos_w[:-1]) / dts[:, None]
        v_fd = torch.cat([v_mid[:1], v_mid], dim=0)
        return torch.where(self.imu_store.vel_opt[w][:, None], self.imu_store.vel[w], v_fd)

    def _initialize_imu(self, kf_id: int, stage: int = 0) -> bool:
        """Staged visual-inertial initialization (InitializeIMU): on fixed
        keyframe poses, estimate shared biases and per-keyframe velocities
        (and the gravity direction when no filter owns it) from the
        preintegration factors, and adopt them. Stereo fixes the scale.

        ``stage`` selects the refinement rung: later rungs loosen the bias
        priors, then a joint inertial BA over the whole recent window
        (FullInertialBA) refines poses, velocities, biases and structure
        together. Returns True iff the optimization ran; a caller must not
        advance the ladder otherwise."""
        dev = self.device
        # a consecutive temporal window, culled keyframes included: a culled
        # slot keeps its frozen pose and its factor, so the chain stays whole
        window = list(range(max(0, kf_id - 19), kf_id + 1))
        if len(window) < 4:
            return False
        if sum(self._has_factor_host[b] for b in window[1:]) < 3:
            return False
        # padded to 20 slots by repeating the last keyframe (real poses,
        # invalid factors), as the reference does
        n_real = len(window)
        window = window + [window[-1]] * (20 - n_real)
        window_arr = to_device(window, torch.int64, dev)
        fac = imu_mode.window_factors(self.imu_store, window, has_factor=self._has_factor_host)
        T_wb = self._kf_body_poses(window_arr)
        # with a running filter the ESEKF owns gravity at every stage: its S2
        # state is corrected by every point-to-plane update
        if self._imu_initialized:
            R_wg0 = inertial_init.gravity_to_rwg(self.gravity_vis)
        else:
            R_wg0 = inertial_init.estimate_gravity_direction(T_wb[:, :3, :3], fac.dV, fac.valid)
        prior_g, prior_a = self.VI_STAGE_PRIORS[min(stage, 2)]
        res = inertial_init.inertial_optimization(
            T_wb, fac.dR, fac.dV, fac.dP, fac.JRg, fac.JVg, fac.JVa, fac.JPg, fac.JPa, fac.dt,
            fac.C_inv, fac.bg_lin, fac.ba_lin, fac.valid, R_wg0,
            self._seed_velocities(window_arr, T_wb), prior_g=prior_g, prior_a=prior_a,
            fix_scale=True, fix_gravity=self._imu_initialized)
        self.gravity_vis = res.R_wg @ axis_vector(2, -9.81, dev)
        # the padded (repeated) slots are dropped from the write-back
        w = window_arr[:n_real]
        st = self.imu_store
        self.imu_store = st.replace(
            vel=st.vel.index_copy(0, w, res.vel[:n_real]),
            vel_opt=st.vel_opt.index_fill(0, w, True),
            bg=st.bg.index_copy(0, w, res.bg.expand(n_real, 3)),
            ba=st.ba.index_copy(0, w, res.ba.expand(n_real, 3)))
        if not self._vi_initialized:
            self._vi_init_time = self._last_t
        self._vi_initialized = True
        if stage >= 1:
            self._run_lvi_ba(kf_id, n_window=20, use_balm=False, iters=10)
        return True

    def _maybe_refine_imu_init(self, kf_id: int):
        """Advance the staged-initialization ladder (VIBA1 5 s and VIBA2
        15 s after the first init)."""
        if not self._vi_initialized or self._vi_stage >= 2 or self._last_t is None:
            return
        if self._vi_init_time is None:
            self._vi_init_time = self._last_t
            return
        nxt = self._vi_stage + 1
        if self._last_t - self._vi_init_time > self.VI_STAGE_TIMES[nxt]:
            # the ladder advances only when the rung ran; an early-out is
            # tried again at a later keyframe
            if self._initialize_imu(kf_id, stage=nxt):
                self._vi_stage = nxt

    def _run_lvi_ba(self, kf_id: int, n_window: int | None = None, use_balm: bool = True,
                    iters: int | None = None):
        """Temporal-window visual-inertial(-LiDAR) BA (LocalLVIBA) with
        write-back of poses, velocities, biases and landmarks. With
        ``n_window`` spanning the whole early map and ``use_balm=False`` it is
        the FullInertialBA."""
        dev, tc, lc = self.device, self.cfg.tracking, self.cfg.lidar
        m, st = self.map, self.imu_store
        P = n_window or tc.local_window
        n_real = min(P, self.n_kf_host, kf_id + 1)
        pad = P - n_real
        # the window is padded to P slots as in the reference: a padded slot
        # has an invalid factor, no observation and a fixed identity state
        window = list(range(kf_id - n_real + 1, kf_id + 1))
        window_arr = to_device(window + [0] * pad, torch.int64, dev)
        wvalid = to_device([True] * n_real + [False] * pad, torch.bool, dev)
        fac_valid = to_device([self._has_factor_host[b] for b in window[1:]] + [False] * pad,
                              torch.bool, dev)
        use_balm = use_balm and self.lidar_enabled and lc.w_lba > 0
        n_l = min(lc.balm_window, P) if use_balm else 0
        fac = imu_mode.factors_at(st, window_arr[1:], fac_valid)
        window_masked = torch.where(wvalid, window_arr, mapstate.NO_KF).to(torch.int32)
        obs, lm_active, sel, _, X0, _ = local_mapping._ba_prep(
            m, window_masked, self.sigma2, tc.ba_active_landmarks)
        eye4 = torch.eye(4, dtype=torch.float32, device=dev)
        T_wb_win = self._kf_body_poses(window_arr)
        # velocities and per-keyframe biases: an optimizer's output where
        # there is one, else finite differences and the filter's biases
        opt = st.vel_opt[window_arr][:, None]
        vel0 = self._seed_velocities(window_arr, T_wb_win)
        bg0 = torch.where(opt, st.bg[window_arr], self.filt.x.bg.expand(P, 3))
        ba0 = torch.where(opt, st.ba[window_arr], self.filt.x.ba.expand(P, 3))
        state0 = inertial_ba.InertialState(
            T_wb=torch.where(wvalid[:, None, None], T_wb_win, eye4),
            vel=vel0 * wvalid[:, None], bg=bg0, ba=ba0)
        fixed = to_device([True] + [False] * (n_real - 1) + [True] * pad, torch.bool, dev)
        balm_kw = {}
        if use_balm:
            # the BALM plane eigen-factor over the first n_l poses (EdgeLidar)
            lidx = window_arr[:n_l]
            lv = wvalid[:n_l]
            T_wl_init = lie.se3_inverse(
                torch.where(lv[:, None, None], m.kf_T_cw[lidx], eye4)) @ self.T_cl
            clusters = balm_mod.build_clusters(
                self.lidar_store.points[lidx], self.lidar_store.valid[lidx] & lv[:, None],
                T_wl_init, voxel_size=lc.balm_voxel, max_voxels=lc.balm_max_voxels,
                min_points=lc.balm_min_points)
            balm_kw = dict(balm_clusters=clusters, T_bl=self.T_bc @ self.T_cl,
                           w_lidar=lc.w_lba, use_balm=True, n_lidar=n_l)
        res = inertial_ba.lvi_ba(
            self.cam, self.T_cb, state0, X0, obs, fac, fixed, lm_active, self.gravity_vis,
            iters=iters if iters is not None else tc.ba_iters, **balm_kw)
        # write back: T_cw = inv(T_wb T_bc), velocities and biases
        w_sc = torch.where(wvalid, window_arr, m.K)
        new_X = m.lm_pos.clone()
        new_X[sel] = torch.where(lm_active[:, None], res.X_w, m.lm_pos[sel])
        self.map = m.replace(
            kf_T_cw=mapstate.set_rows_drop(m.kf_T_cw, w_sc,
                                           lie.se3_inverse(res.state.T_wb @ self.T_bc)),
            lm_pos=new_X)
        self.imu_store = st.replace(
            vel=mapstate.set_rows_drop(st.vel, w_sc, res.state.vel),
            vel_opt=mapstate.set_rows_drop(st.vel_opt, w_sc,
                                           torch.ones(P, dtype=torch.bool, device=dev)),
            bg=mapstate.set_rows_drop(st.bg, w_sc, res.state.bg),
            ba=mapstate.set_rows_drop(st.ba, w_sc, res.state.ba))

    # ------------------------------------------------------------------
    # Loop closing
    # ------------------------------------------------------------------
    def _close_pending_loop(self):
        """Try the loop candidates that the last sync delivered. The frame
        in flight is not the keyframe any more: it keeps its pose relative to
        the keyframe through the correction (the motion model is invariant
        under the common right factor)."""
        if self._loop_cands is None:
            return
        (kf_id, cands), self._loop_cands = self._loop_cands, None
        if not cands:
            return
        T_kf_inv = lie.se3_inverse(self.map.kf_T_cw[kf_id])
        rel, rel_last, vel = self.T_cw @ T_kf_inv, self.last_T_cw @ T_kf_inv, self.velocity
        if self._try_close_loop(kf_id, cands):
            T_kf = self.map.kf_T_cw[kf_id]
            self.T_cw, self.last_T_cw, self.velocity = rel @ T_kf, rel_last @ T_kf, vel

    def _try_close_loop(self, kf_id: int, cands: list[int] | None = None) -> bool:
        """Sim3 verification of up to three loop candidates of keyframe
        ``kf_id`` and the pose-graph correction for the first that verifies
        (the LoopClosing thread's job). Without ``cands`` the detection runs
        here and is read at once. On a closure the current pose becomes the
        corrected keyframe's and the motion model is reset. Returns whether a
        loop was closed."""
        # closure cooldown (LoopClosing::DetectLoop's mLastLoopKFid + 10
        # gate): closing again from the next keyframes re-solves the graph
        # against an already corrected chain and accumulates noise
        if kf_id < self._last_loop_kf + 10:
            return False
        with self.timers.stage("loop_closing"):
            if cands is None:
                cands = loop_closing.detect_candidates(
                    self.map, kf_id, self.kf_words, min_gap=self.cfg.loop_min_gap, n_best=3,
                    word_weights=self._word_idf, n_kf=self.n_kf_host)
            for cand in cands:
                # stereo gives metric scale: the relative transform is
                # verified as SE3 (mono would pass with_scale=True)
                ok, S, n_inl, _ = loop_closing.verify_candidate(
                    self.map, kf_id, cand, generator=self._generator, with_scale=False)
                self.n_loop_verified += 1
                if not ok:
                    continue
                self.map = loop_closing.close_loop(self.map, kf_id, cand, S,
                                                   n_kf=self.n_kf_host)
                # the pose graph only spreads the loop error along the poses;
                # a joint pose + structure solve welds the re-mapped
                # landmarks to the corrected poses
                if self._post_loop_ba:
                    self._global_ba(anchor=cand)
                # the current pose follows the corrected keyframe
                self.T_cw = self.map.kf_T_cw[kf_id]
                self.velocity = torch.eye(4, dtype=torch.float32, device=self.device)
                self.n_loops_closed += 1
                self._last_loop_kf = kf_id
                self.last_loop = (kf_id, loop_closing.LoopCandidate(cand, S, n_inl))
                return True
        return False

    def _global_ba(self, anchor: int, iters: int = 8):
        """Bundle adjustment after a loop closure (Optimizer::BundleAdjustment
        role) over the newest ``GLOBAL_BA_KFS`` alive keyframes, visual terms
        only, with the loop candidate fixed when it is in the window and the
        window's oldest keyframe otherwise."""
        alive = [k for k in range(self.n_kf_host) if self.kf_alive[k]]
        window = alive[-self.GLOBAL_BA_KFS:]
        if len(window) < 3:
            return
        fixed = [(w == anchor) if anchor in window else (w == window[0]) for w in window]
        pad = self.GLOBAL_BA_KFS - len(window)
        self.map = local_mapping.run_local_ba(
            self.map, None, self.cam, self.sigma2, self.T_cl,
            window + [mapstate.NO_KF] * pad, fixed + [True] * pad, w_lba=0.0, iters=iters,
            max_active=self.cfg.tracking.ba_active_landmarks)

    # ------------------------------------------------------------------
    def _create_map_in_atlas(self):
        """Freeze the active map and start a fresh one (atlas recovery).

        A map with fewer than ``atlas_min_kf`` keyframes is discarded
        (ResetActiveMap). The new map initialises, anchored at the current
        dead-reckoned pose, on the next frame with enough stereo depth."""
        self.flush_mapping()    # deferred mapping lands on the old map first
        t = self.cfg.tracking
        bundle = atlas_mod.MapBundle(
            map=self.map, lidar_store=self.lidar_store, kf_words=self.kf_words,
            imu_store=self.imu_store if self.use_imu else None,
            n_kf=self.n_kf_host, map_id=self.map_id)
        self.atlas.freeze_or_discard(bundle, min_kf=t.atlas_min_kf)
        self.map_id = self.atlas.n_created - 1
        self.map = mapstate.create(max_kf=t.max_kf, max_feats=self.cfg.orb.n_features,
                                   max_lm=t.max_lm, max_obs=t.max_obs, device=self.device)
        if self.lidar_enabled:
            self.lidar_store = local_mapping.LidarStore.create(
                t.max_kf, self.cfg.lidar.kf_points, self.device)
        self.kf_words = self._new_kf_words()
        if self.use_imu:
            self.imu_store = imu_mode.ImuKfStore.create(t.max_kf, self.device)
            self._vi_initialized = False
            self._vi_stage = 0
            self._vi_init_time = None
            self._has_factor_host = [False] * t.max_kf
            self._imu_ring_reset()
            self._frame_prior = None
            self._prev_vi_state = None
        self.n_kf_host = 0
        self.kf_alive = [True] * t.max_kf
        self.ref_kf = -1
        self.ref_kf_tracked = 0
        self._pending_mapping = None
        self._pending_fetch = {}
        self._covis = None
        self._loop_kf_in_flight = self._loop_cands = None
        self.frames_since_kf = 0
        self.n_lost = 0
        self.velocity = torch.eye(4, dtype=torch.float32, device=self.device)
        self._last_staged_scan = None
        self._lidar_pending = []
        self.state = TrackingState.NOT_INITIALIZED

    # ------------------------------------------------------------------
    def _record_pose(self, t):
        T_ref = self.map.kf_T_cw[max(self.ref_kf, 0)]
        self.traj.append((float(t), self.map_id, self.ref_kf,
                          self.T_cw @ lie.se3_inverse(T_ref)))

    def trajectory_world_from_cam(self) -> np.ndarray:
        """Per-frame world-from-camera [N, 4, 4], recomposed against the
        (BA-refined) keyframe poses (SaveTrajectoryKITTI logic).

        A frame's pose is stored relative to its reference keyframe within
        its sub-map. Frames of a discarded sub-map, and frames without a
        reference keyframe, keep their recorded pose (a dead-reckoned
        segment)."""
        self.flush_mapping()
        kf_T_by_map = {self.map_id: self.map.kf_T_cw.cpu().numpy()}
        for bundle in self.atlas.frozen:
            kf_T_by_map[bundle.map_id] = bundle.map.kf_T_cw.cpu().numpy()
        T_rels = torch.stack([T for *_, T in self.traj]).cpu().numpy()
        eye = np.eye(4, dtype=T_rels.dtype)
        out = []
        for (_, mid, ref, _), T_rel in zip(self.traj, T_rels):
            kf_T = kf_T_by_map.get(mid)
            T_ref = kf_T[ref] if (kf_T is not None and ref >= 0) else eye
            out.append(np.linalg.inv(T_rel @ T_ref))
        return np.stack(out)

    def save_trajectory_kitti(self, path: str):
        trajectory.save_kitti(path, self.trajectory_world_from_cam())

    def save_trajectory_tum(self, path: str):
        trajectory.save_tum(path, [t for t, *_ in self.traj], self.trajectory_world_from_cam())
