"""System facade for STEREO_LIDAR mode: the per-frame entry point and the
host state machine (port of ``tc2li_slam_tpu/slam/system.py`` in that mode,
without loop closing and checkpoints).

    per frame:  build_frame -> const-velocity predict -> track_step
                (guided match + pose-only LM) -> stage the scan at the
                tracked pose -> batched voxel-map insert every few frames
                -> keyframe decision
    per KF:     stereo landmarks gated by the LiDAR map, planar LiDAR
                features, BoW words when a vocabulary is given; on the
                next frame the mapping pass (landmark culling, new map
                points triangulated against the covisible neighbours, fuse,
                local BA with the BALM eigen-factor, keyframe culling)
    on loss:    window-free recovery (global match + PnP RANSAC), BoW
                relocalization, RECENTLY_LOST with dead reckoning, then
                LOST: the map is frozen into the atlas and a new one starts
                (also on a timestamp jump)

Every pool lives on the device given to ``System``. A frame makes one
device-to-host transfer: the tracker's inlier count, fetched together with
the scalars earlier keyframe events left pending (reference-KF tracked
count, covisibility window, culled keyframe). A frame that fails to track
reads one more scalar per rung of the recovery ladder, as the reference
does. Host data goes to the device through pinned memory without a stream
sync.

IMU mode and loop closing raise ``NotImplementedError`` naming the JAX
modules still to be ported.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from ..geom import camera as cam_mod, lie
from ..ops import bow, plane_fit, pointcloud, voxel_map
from ..tensors import count, to_device
from . import (atlas as atlas_mod, config as cfg_mod, culling, lio, local_mapping, mapstate,
               relocalization, tracking, trajectory, triangulation)


class TrackingState:
    NOT_INITIALIZED = 0
    OK = 1
    RECENTLY_LOST = 2
    LOST = 3


class StageTimer:
    """Per-stage timings: CUDA events on a CUDA device (device time between
    the stage's start and end on the current stream), the host clock on
    the CPU. ``stats`` synchronises once to read the events."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self._events: list[tuple[str, object, object]] = []
        self._total_ms: dict[str, float] = {}
        self._count: dict[str, int] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        self._count[name] = self._count.get(name, 0) + 1
        if self.cuda:
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            yield
            e1.record()
            self._events.append((name, e0, e1))
            # fold finished pairs into the totals (query() does not block)
            while self._events and self._events[0][2].query():
                self._fold(*self._events.pop(0))
        else:
            t0 = time.perf_counter()
            yield
            self._add(name, (time.perf_counter() - t0) * 1e3)

    def _add(self, name: str, ms: float):
        self._total_ms[name] = self._total_ms.get(name, 0.0) + ms

    def _fold(self, name, e0, e1):
        self._add(name, e0.elapsed_time(e1))

    def stats(self) -> dict[str, dict[str, float]]:
        """{stage: {"total_ms", "count"}}."""
        if self._events:
            torch.cuda.synchronize()
            while self._events:
                self._fold(*self._events.pop(0))
        return {k: {"total_ms": v, "count": self._count[k]}
                for k, v in sorted(self._total_ms.items())}

    def reset(self):
        self._events.clear()
        self._total_ms.clear()
        self._count.clear()


class System:
    """Stereo+LiDAR SLAM system (System::TrackStereoLidar) on one device."""

    def __init__(self, cfg: cfg_mod.SystemConfig, device: torch.device | str,
                 voc: bow.Vocabulary | None = None):
        """``voc`` is the place-recognition vocabulary (``ops.bow``); with
        one, each keyframe stores its words and a lost frame relocalizes."""
        if cfg.use_imu:
            raise NotImplementedError(
                "IMU_STEREO_LIDAR mode is not ported yet: tc2li_slam_tpu.slam.lio."
                "lio_scan_step, slam/imu_mode.py and solver/inertial_ba.py")
        if cfg.loop_closing:
            raise NotImplementedError(
                "loop closing is not ported yet: tc2li_slam_tpu.slam.loop_closing")
        self.cfg = cfg
        self.device = torch.device(device)
        dev = self.device
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
        self.timers = StageTimer(dev)
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
        # landmarks allocated by triangulation: a device counter, read it
        # with int() after a run
        self.n_tri_landmarks = torch.zeros((), dtype=torch.int32, device=dev)

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

    def track(self, img_l, img_r, t: float, scan=None, scan_valid=None) -> torch.Tensor:
        """Process one stereo(+LiDAR) frame; returns T_cw [4, 4] (device).

        Images are [H, W] (uint8 or float); ``scan`` is [N, 3] float32 in the
        LiDAR frame. Without ``scan_valid`` every point counts: padding slots
        are expected zeroed, inside the blind radius."""
        self.frame_idx += 1
        # a gap above 1 s, or time running backwards, means the sensor stream
        # broke: freeze the map into the atlas and restart tracking
        if self._last_t is not None and self.state != TrackingState.NOT_INITIALIZED:
            dt_frame = float(t) - self._last_t
            if dt_frame > 1.0 or dt_frame < 0.0:
                self._create_map_in_atlas()
        self._last_t = float(t)
        img_l, img_r = self._input(img_l), self._input(img_r)
        if scan is not None:
            scan = self._input(scan, torch.float32)
            scan_valid = (torch.ones(scan.shape[0], dtype=torch.bool, device=self.device)
                          if scan_valid is None else self._input(scan_valid, torch.bool))
        with self.timers.stage("frame"):
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
        self._pending_fetch = {}
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
        if self.lidar_enabled and scan is not None:
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
            self.T_cw = T_new       # the motion model's prediction (dead reckoning)
            self.frames_since_kf += 1
            if self.n_lost >= tc.recently_lost_frames:
                # RECENTLY_LOST -> LOST: freeze the map, start a new one
                self._create_map_in_atlas()
            return

        self.state = TrackingState.OK
        self.n_lost = 0
        self.T_cw = T_new
        self.velocity = vel_new
        self.map = new_map

        # the mapping pass for the keyframe created last frame (the
        # reference's LocalMapping thread runs it while tracking continues)
        if self._pending_mapping is not None:
            with self.timers.stage("mapping"):
                kf_q, self._pending_mapping = self._pending_mapping, None
                self._mapping_step(kf_q)

        # a recovered frame dropped its staging: stage at the recovered pose
        if staged is None and self.lidar_enabled and scan is not None:
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
        if self.lidar_enabled:
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
        self.ref_kf = kf_id
        # read at the next frame's sync (one-frame lag, no blocking)
        self._pending_fetch["ref_kf_tracked"] = rkt
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
        if self._last_staged_scan is not None and lc.scan_voxel == lc.map_voxel:
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
        """Run any deferred mapping work and land staged scans now."""
        if self._pending_mapping is not None:
            if self._pending_fetch:
                self._sync(torch.zeros((), dtype=torch.int32, device=self.device))
            kf_q, self._pending_mapping = self._pending_mapping, None
            self._mapping_step(kf_q)
        if self.lidar_enabled:
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
            self.map = local_mapping.run_local_ba(
                self.map, self.lidar_store, self.cam, self.sigma2, self.T_cl,
                window, fixed, balm_window=lc.balm_window, balm_voxel=lc.balm_voxel,
                balm_max_voxels=lc.balm_max_voxels, balm_min_points=lc.balm_min_points,
                w_lba=lc.w_lba if self.lidar_enabled else 0.0, iters=t.ba_iters,
                max_active=t.ba_active_landmarks)
            self.n_ba += 1
            self.n_ba_balm += int(self.lidar_enabled and lc.w_lba > 0)
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
    def _create_map_in_atlas(self):
        """Freeze the active map and start a fresh one (atlas recovery).

        A map with fewer than ``atlas_min_kf`` keyframes is discarded
        (ResetActiveMap). The new map initialises, anchored at the current
        dead-reckoned pose, on the next frame with enough stereo depth."""
        self.flush_mapping()    # deferred mapping lands on the old map first
        t = self.cfg.tracking
        bundle = atlas_mod.MapBundle(
            map=self.map, lidar_store=self.lidar_store, kf_words=self.kf_words,
            n_kf=self.n_kf_host, map_id=self.map_id)
        self.atlas.freeze_or_discard(bundle, min_kf=t.atlas_min_kf)
        self.map_id = self.atlas.n_created - 1
        self.map = mapstate.create(max_kf=t.max_kf, max_feats=self.cfg.orb.n_features,
                                   max_lm=t.max_lm, max_obs=t.max_obs, device=self.device)
        if self.lidar_enabled:
            self.lidar_store = local_mapping.LidarStore.create(
                t.max_kf, self.cfg.lidar.kf_points, self.device)
        self.kf_words = self._new_kf_words()
        self.n_kf_host = 0
        self.kf_alive = [True] * t.max_kf
        self.ref_kf = -1
        self.ref_kf_tracked = 0
        self._pending_mapping = None
        self._pending_fetch = {}
        self._covis = None
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
