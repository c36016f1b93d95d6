#!/usr/bin/env python3
"""Profile the PyTorch port's frame loop on one CUDA card.

    python3 tools/profile_torch_slice.py [--frames 14] [--warm 5] [--triangulate]
                                         [--voc] [--imu [--rungs]] [--loop]
                                         [--out build/profile] [--tree DIR]

Runs the sequence and configuration of ``chip_smoke.py`` (KITTI-shaped,
1241x376, 2000 features, 32768-point scans); with ``--triangulate`` the
configuration's default, new map points triangulated at every mapping pass
(the first slice ran with it off); with ``--voc`` a vocabulary trained on the
host from the first three frames' descriptors, as ``chip_smoke.py`` trains
it, so that every keyframe quantizes its descriptors to words; with ``--imu``
the IMU mode (``use_imu``, ``inertial_ba``, triangulation on, the IMU windows
and per-point scan times of the sequence; by default 24 frames of which 18
warm up, so that the visual-inertial initialization is over and the window
holds a keyframe and its LVI-BA pass), where the
device events of the ``lio`` and ``vi_refine`` stages are also counted a
frame and the run fails above 1.2 host syncs a frame; with ``--loop`` loop
closing on (``loop_closing=True``, ``loop_min_kf=1``, triangulation on, the
vocabulary of ``--voc``) on this straight path, where no loop closes: every
keyframe past the first two runs the candidate ladder on the device, whose
device events are counted a call, and the run fails above 1.2 host syncs a
frame (the candidates must ride in the frame's one transfer). With ``--imu``
the ``vi_refine`` stage is split into its preintegration
(``estimation/imu.integrate``) and its optimizer
(``solver/pose_inertial.optimize_last_kf`` / ``optimize_last_frame``), each
counted inside the stage only, and the ``lio`` stage into contiguous
segments (``lio:predict`` from ``ops/kernels/lio.predict_with_fences``, or
``esekf.predict`` in a tree without it, ``lio:undistort``, ``lio:downsample`` from
``pointcloud.preprocess`` with the ``work_cap`` subset, ``lio:update`` from
the update's entry to the map insert, ``lio:insert``, ``lio:recenter``),
the same on a tree from before the scan step's kernels. In every mode
the window BA's parts are named ranges too (``balm.build_clusters``,
``balm.quadratic``, ``lm.local_ba``, the last holding the quadratic's calls;
with ``--imu`` also ``inertial_ba.lvi_ba``, a keyframe's LVI-BA pass):
calls, host ms and device events a call of each (``ba_split``), each LVI-BA
pass apart (``ba_split["lvi_ba passes"]``: device events, device ms, host
ms, and device launches and ms by kernel name), with ``--imu`` each
``inertial_init.inertial_optimization`` call apart the same way
(``init_calls``, the range ``init:inertial_optimization``: the
visual-inertial initialization at the first mapping pass with four
keyframes, frame ~14, and each VIBA rung's), and the
device ms and launches a frame of each kernel of ``csrc/local_ba.cu``
(``ba_split["local_ba_lm kernels"]``). The frame build is split the same
way (``orb_split``): ``build_frame`` and its parts ``orb:level_stacks`` (the
pyramid and blur planes), ``orb:detect`` (the FAST pair), ``orb:select``
(the grid top-k), ``orb:describe`` (orientation and rBRIEF),
``stereo:match`` and ``stereo:subpixel`` (a checkout from before the stereo
kernel; on the card the current one calls neither) and
``stereo:match+refine`` (``ops/stereo.match_and_refine``: the match and
``csrc/stereo.cu``), each with host ms, device ms (the
kernels, copies and fills whose launch lies in the range, linked by the
profiler's correlation ids) and device events a frame. ``--rungs`` (with
``--imu``) ends the profiled window with the two VIBA rungs on the system,
``_initialize_imu(kf, stage=1)`` then ``stage=2`` at its last keyframe, as
``_maybe_refine_imu_init`` calls them 5 s and 15 s after the
initialization (ranges ``rung:1``, ``rung:2``: the rung's
``inertial_optimization`` call and its FullInertialBA); with ``--imu`` the
summary also gives the frames at which the ladder itself reached each rung
(``vi_stage_frames``; a sequence of ~170 frames or more reaches both), the
gravity's norm and the ATE over the run. ``--tree DIR`` runs
the package of another checkout (an unpacked parent, say) under this
script, so that two trees are split by the same code. Then over the
frames after the warm-up:

- host wall ms per frame (clock around ``track`` + a final synchronize);
- host syncs per frame, counted with ``torch.cuda.set_sync_debug_mode``,
  as a mean and frame by frame beside the frames that made a keyframe,
  with the line of the port each one was made from;
- a ``torch.profiler`` trace (CPU + CUDA): device busy share of the window,
  kernel launches per frame, the top kernels by device time and the top
  operators by host time. The gzipped chrome trace, the two tables and a
  JSON summary are written under ``--out``.
"""

from __future__ import annotations

import argparse
import gzip
import json
import os
import re
import shutil
import sys
import time
import traceback
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
LOCAL_BA_KERNELS = ("init_kernel", "build_kernel", "reduce_kernel", "solve_kernel",
                    "eval_kernel", "commit_kernel")   # csrc/local_ba.cu


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=None, help="14, or 24 with --imu")
    ap.add_argument("--warm", type=int, default=None, help="5, or 18 with --imu")
    ap.add_argument("--imu", action="store_true", help="IMU mode (IMU_STEREO_LIDAR)")
    ap.add_argument("--rungs", action="store_true",
                    help="with --imu: end the profiled window with the two VIBA rungs")
    ap.add_argument("--triangulate", action="store_true",
                    help="tracking.triangulate=True, the configuration's default")
    ap.add_argument("--voc", action="store_true",
                    help="give the system a vocabulary trained on the first three frames")
    ap.add_argument("--loop", action="store_true",
                    help="loop closing on (implies --voc and --triangulate)")
    ap.add_argument("--out", default=str(ROOT / "build" / "profile"))
    ap.add_argument("--tree", default=None,
                    help="import tc2li_slam_torch from this checkout (default: this one)")
    args = ap.parse_args()
    if args.loop:
        args.voc = args.triangulate = True
    if args.frames is None:
        args.frames = 24 if args.imu else 14
    if args.warm is None:
        args.warm = 18 if args.imu else 5

    import bisect
    import dataclasses

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    import chip_smoke   # (this checkout's helpers)
    if args.tree:
        sys.path.insert(0, str(Path(args.tree).resolve()))
    import tc2li_slam_torch
    from tc2li_slam_torch.estimation import esekf as esekf_mod, imu as imu_est, \
        undistort as undist_mod
    from tc2li_slam_torch.io import synthetic as syn
    from tc2li_slam_torch.ops import bow, orb, pointcloud as pc_mod, stereo, voxel_map as vm_mod
    from tc2li_slam_torch.ops.kernels import fast, lio as klio_mod, match
    from tc2li_slam_torch.slam import config as cfg_mod, lio as lio_mod, system as sys_mod, \
        tracking
    from tc2li_slam_torch.solver import balm as balm_mod, inertial_ba as iba_mod, \
        inertial_init as ii_mod, lm as lm_mod, pose_inertial as pi_mod

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    smi = chip_smoke.nvidia_smi_line()
    rng = np.random.default_rng(0)
    world = syn.make_world(rng, n_surf=300_000)
    traj = syn.Trajectory(w_body=(0, 0, 0.03), v_world=(1.5, 0.1, 0.0))
    frames, _, _ = syn.generate_sequence(
        n_frames=args.frames, cam=syn.KITTI_LIKE, seed=0, n_scan=1 << 17, world=world,
        traj=traj, stereo_pairs=chip_smoke.render_pairs(
            syn.KITTI_LIKE, world, syn.trajectory_poses(traj, args.frames)))
    scans = [np.where(fr.scan_valid[:, None], fr.scan, 0.0)[::4].astype(np.float32)
             for fr in frames]
    cfg = chip_smoke.kitti_config(cfg_mod, syn, triangulate=args.triangulate or args.imu)
    if args.imu:
        cfg = dataclasses.replace(
            cfg, use_imu=True, inertial_ba=True,
            imu=cfg_mod.ImuConfig(noise_gyro=1e-4, noise_acc=1e-3, gyro_walk=1e-6,
                                  acc_walk=1e-5, T_bc=syn.body_from_cam()))
    if args.loop:
        cfg = dataclasses.replace(cfg, loop_closing=True, loop_min_kf=1)
    dev = torch.device("cuda")
    voc = None
    if args.voc:
        descs = []
        for fr in frames[:3]:
            img = torch.as_tensor(np.clip(fr.img_l, 0, 255).astype(np.uint8)).to(dev)
            kp = orb.extract(img, 2000, 8)
            descs.append(kp.desc[kp.valid].cpu().numpy().view(np.uint32))
        voc = bow.train_vocabulary(np.concatenate(descs), k=8, depth=3, seed=0, device=dev)
    slam = sys_mod.System(cfg, dev, voc=voc)

    def track(fr, sc):
        if args.imu:
            return slam.track(fr.img_l, fr.img_r, fr.t, sc, None, gyro=fr.gyro, acc=fr.acc,
                              imu_dts=fr.imu_dts, imu_trel=fr.imu_trel,
                              scan_times=fr.scan_times[::4])
        return slam.track(fr.img_l, fr.img_r, fr.t, sc)

    if args.loop:
        # the detection is a function of the loop-closing module that System
        # calls at a keyframe: the same kind of named range around it
        STAGES = ("detect_candidates_device",)
        detect = sys_mod.loop_closing.detect_candidates_device

        def ranged_detect(*a, **kw):
            with record_function("stage:detect_candidates_device"):
                return detect(*a, **kw)
        sys_mod.loop_closing.detect_candidates_device = ranged_detect

    # vi_refine's two parts, as module attributes System calls: the
    # preintegration (also called outside the stage, at a keyframe and for
    # dead reckoning: counted inside the stage only) and the optimizers
    VI_PARTS = ((("integrate", imu_est), ("optimize_last_kf", pi_mod),
                 ("optimize_last_frame", pi_mod)) if args.imu else ())
    for name, mod in VI_PARTS:
        def ranged_vi(*a, _fn=getattr(mod, name), _name=name, **kw):
            with record_function(f"vi:{_name}"):
                return _fn(*a, **kw)
        setattr(mod, name, ranged_vi)
    # the lio stage's parts, each a contiguous segment of the scan step: a
    # named range opened where its first module attribute is called and
    # closed where the next segment opens or the stage ends. ``downsample``
    # runs from ``pointcloud.preprocess`` to the update (the voxel
    # downsample and the strided ``work_cap`` subset); ``update`` from the
    # update's entry (``lio.iterated_update``, or ``lio.make_h_fn`` in a tree
    # without it) to ``voxel_map.insert`` (the guard and the last evaluation
    # included). Counted inside ``stage:_lio_step`` only.
    class LioSegments:
        active, name, rf = False, None, None

        def start(self, name):
            if not self.active or self.name == name:
                return
            self.close()
            self.name, self.rf = name, record_function(f"lio:{name}")
            self.rf.__enter__()

        def close(self):
            if self.rf is not None:
                self.rf.__exit__(None, None, None)
            self.name, self.rf = None, None

    seg = LioSegments()
    LIO_PARTS = ()
    if args.imu:
        update_entry = "iterated_update" if hasattr(lio_mod, "iterated_update") else "make_h_fn"
        # the scan step predicts through predict_with_fences on the card (the
        # launch that also writes the fence table), esekf.predict in an older tree
        predict_entry = ((klio_mod, "predict_with_fences")
                         if hasattr(klio_mod, "predict_with_fences") else (esekf_mod, "predict"))
        LIO_PARTS = (("predict", *predict_entry, True),
                     ("undistort", undist_mod, "undistort", True),
                     ("downsample", pc_mod, "preprocess", False),
                     ("update", lio_mod, update_entry, False),
                     ("insert", vm_mod, "insert", True),
                     ("recenter", lio_mod, "maybe_recenter", True))
        lio_step = slam._lio_step

        def lio_stage(*a, **kw):
            seg.active = True
            try:
                return lio_step(*a, **kw)
            finally:
                seg.close()
                seg.active = False
        slam._lio_step = lio_stage
    for rname, mod, name, closes in LIO_PARTS:
        def ranged_lio(*a, _fn=getattr(mod, name), _rname=rname, _closes=closes, **kw):
            seg.start(_rname)
            out = _fn(*a, **kw)
            if _closes:
                seg.close()
            return out
        setattr(mod, name, ranged_lio)
    # the two IMU-mode stages as named ranges in the trace, so that the
    # launches the host makes inside them can be counted
    STAGES = ("_lio_step", "_vi_frame_refine") if args.imu else ()
    for name in STAGES:
        def ranged(*a, _fn=getattr(slam, name), _name=name, **kw):
            with record_function(f"stage:{_name}"):
                return _fn(*a, **kw)
        setattr(slam, name, ranged)
    # the window BA's parts, as module attributes the mapping pass calls; in
    # the IMU mode the LVI-BA pass (``inertial_ba.lvi_ba``, the kernel
    # sequence or, in an older tree, the eager loop)
    BA_PARTS = (("build_clusters", balm_mod), ("quadratic", balm_mod), ("local_ba", lm_mod)) + (
        (("lvi_ba", iba_mod),) if args.imu else ())
    for name, mod in BA_PARTS:
        def ranged_part(*a, _fn=getattr(mod, name), _name=name, **kw):
            with record_function(f"ba:{_name}"):
                return _fn(*a, **kw)
        setattr(mod, name, ranged_part)
    # in the IMU mode the visual-inertial initialization's optimization
    # (``inertial_init.inertial_optimization``, the kernel or, in an older
    # tree, the eager loop), at the initialization and at each rung
    if args.imu:
        def ranged_init(*a, _fn=ii_mod.inertial_optimization, **kw):
            with record_function("init:inertial_optimization"):
                return _fn(*a, **kw)
        ii_mod.inertial_optimization = ranged_init
    # the frame build's parts: each range wraps the module attributes that
    # compute it. ``select_topk_grid`` and ``compute_*_stacked`` are what a
    # checkout from before the ORB kernels calls (its ``orb`` lacks
    # ``select_grid`` and ``describe``); with ``--tree`` on such a checkout
    # they give the "before" split of PERF.md. The current tree never calls
    # them on the card, so there they wrap nothing that runs.
    ORB_PARTS = (("build_frame", ((tracking, "build_frame"),)),
                 ("orb:level_stacks", ((orb, "level_stacks"),)),
                 ("orb:detect", ((fast, "detect_planes"),)),
                 ("orb:select", ((orb, "select_topk_grid"), (orb, "select_grid"))),
                 ("orb:describe", ((orb, "compute_orientation_stacked"),
                                   (orb, "compute_descriptors_stacked"), (orb, "describe"))),
                 ("stereo:match", ((stereo, "match_stereo"),)),
                 ("stereo:subpixel", ((stereo, "subpixel_refine"),)),
                 ("stereo:match+refine", ((stereo, "match_and_refine"),)))
    for rname, attrs in ORB_PARTS:
        for mod, name in attrs:
            if hasattr(mod, name):
                def ranged_orb(*a, _fn=getattr(mod, name), _rname=rname, **kw):
                    with record_function(_rname):
                        return _fn(*a, **kw)
                setattr(mod, name, ranged_orb)

    # the frames at which the ladder reached each rung on its own clock
    vi_stage_frames = {}

    def note_stage(i):
        st = getattr(slam, "_vi_stage", 0)
        if args.imu and getattr(slam, "_vi_initialized", False) and st not in vi_stage_frames:
            vi_stage_frames[st] = i

    for i, (fr, sc) in enumerate(zip(frames[:args.warm], scans[:args.warm])):
        track(fr, sc)
        note_stage(i)
    torch.cuda.synchronize()
    slam.timers.reset()

    n_meas = args.frames - args.warm
    frame_ms, frame_syncs, frame_kf = [], [], []
    # the triangulation's match: "epipolar+mutual" (the dense mask's
    # "dense+mutual" in a tree from before its kernel)
    pairs_of = lambda: sum(match.launches_by_mode.get(k, 0)
                           for k in ("epipolar+mutual", "dense+mutual"))
    pairs0 = pairs_of()
    sync_lines = []

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        record = warnings.showwarning

        def showwarning(message, *a, **kw):
            # where in the port the host waited: the innermost frame of the
            # package on the stack when the sync warning fired
            if chip_smoke.is_sync_warning(message):
                inner = [f for f in traceback.extract_stack() if "tc2li_slam_torch" in f.filename]
                if inner:
                    f = inner[-1]
                    # (relative to this checkout; a --tree outside it gets "../")
                    where = os.path.relpath(f.filename, ROOT)
                    sync_lines.append(f"{where}:{f.lineno} {f.line}")
            record(message, *a, **kw)

        warnings.showwarning = showwarning
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t_win0 = time.perf_counter()
            for i, (fr, sc) in enumerate(zip(frames[args.warm:], scans[args.warm:])):
                t0 = time.perf_counter()
                n_warned, n_kf = len(caught), slam.n_kf_host
                torch.cuda.set_sync_debug_mode("warn")
                track(fr, sc)
                torch.cuda.set_sync_debug_mode("default")
                torch.cuda.synchronize()
                frame_ms.append(1e3 * (time.perf_counter() - t0))
                frame_syncs.append(chip_smoke.n_syncs(caught[n_warned:]))
                frame_kf.append(slam.n_kf_host > n_kf)
                note_stage(args.warm + i)
            rung_ran = []
            if args.imu and args.rungs:
                for stage in (1, 2):
                    t0 = time.perf_counter()
                    with record_function(f"rung:{stage}"):
                        rung_ran.append(slam._initialize_imu(slam.n_kf_host - 1, stage=stage))
                    torch.cuda.synchronize()
                    rung_ran.append(1e3 * (time.perf_counter() - t0))
            t_win = time.perf_counter() - t_win0
    syncs = [str(w.message).splitlines()[0] for w in caught
             if chip_smoke.is_sync_warning(w.message)]
    trace = out / "slice_trace.json"
    prof.export_chrome_trace(str(trace))
    with open(trace, "rb") as src, gzip.open(f"{trace}.gz", "wb") as dst:
        shutil.copyfileobj(src, dst)
    trace.unlink()

    events = prof.key_averages()
    RANGE_PREFIXES = ("stage:", "ba:", "orb:", "stereo:", "build_frame", "lio:", "vi:", "init:",
                      "rung:")
    dev_us = 0.0
    n_kernels = 0
    for e in prof.events():
        # (a named range has a device-side twin that spans its kernels)
        if e.device_type == torch.autograd.DeviceType.CUDA and \
                not e.name.startswith(RANGE_PREFIXES):
            dev_us += e.time_range.elapsed_us()
            n_kernels += 1
    # device events enqueued inside each named range: the host-side launch
    # calls (kernels, copies, memsets) whose start lies in one of its spans
    cpu_events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CPU]
    launch_events = [e for e in cpu_events
                     if e.name.startswith(("cudaLaunchKernel", "cudaMemcpyAsync",
                                           "cudaMemsetAsync", "cuLaunchKernel"))]
    launches = sorted(e.time_range.start for e in launch_events)
    # a device event and the runtime call that enqueued it share a
    # correlation id: the device time of each launch, by its start
    launch_at = {e.id: e.time_range.start for e in launch_events}
    dev_by_launch = []
    n_dev, n_linked = 0, 0
    kernel_of = lambda name: (re.search(r"([A-Za-z_]\w*)(?:<[^(]*>)?\(", name)
                              or re.search(r"(.*)", name)).group(1)
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA and \
                not e.name.startswith(RANGE_PREFIXES):
            n_dev += 1
            if e.id in launch_at:
                n_linked += 1
                dev_by_launch.append((launch_at[e.id], e.time_range.elapsed_us(),
                                      kernel_of(e.name)))
    dev_by_launch.sort()
    dev_starts = [t for t, _, _ in dev_by_launch]
    dev_cum = [0.0]
    for _, us, _ in dev_by_launch:
        dev_cum.append(dev_cum[-1] + us)

    def range_events(rname, within=None):
        spans = [(e.time_range.start, e.time_range.end) for e in cpu_events if e.name == rname]
        if within is not None:   # only the spans that start inside one of that range's
            outer = [(e.time_range.start, e.time_range.end) for e in cpu_events
                     if e.name == within]
            spans = [(a, b) for a, b in spans if any(c <= a <= d for c, d in outer)]
        n_in = sum(bisect.bisect_right(launches, b) - bisect.bisect_left(launches, a)
                   for a, b in spans)
        dev_in = sum(dev_cum[bisect.bisect_right(dev_starts, b)]
                     - dev_cum[bisect.bisect_left(dev_starts, a)] for a, b in spans)
        return {"calls": len(spans), "device_events_per_frame": n_in / n_meas,
                "device_ms_per_frame": dev_in / 1e3 / n_meas,
                "device_events_per_call": n_in / max(len(spans), 1),
                "host_ms_per_frame": sum(b - a for a, b in spans) / 1e3 / n_meas,
                "host_ms_per_call": sum(b - a for a, b in spans) / 1e3 / max(len(spans), 1)}

    stage_events = {name: range_events(f"stage:{name}") for name in STAGES}
    for rname, *_ in LIO_PARTS:
        stage_events[f"_lio_step/{rname}"] = range_events(f"lio:{rname}",
                                                          within="stage:_lio_step")
    for name, _ in VI_PARTS:
        stage_events[f"_vi_frame_refine/{name}"] = range_events(
            f"vi:{name}", within="stage:_vi_frame_refine")
    ba_split = {name: range_events(f"ba:{name}") for name, _ in BA_PARTS}
    def calls_of(rname):
        """Each span of a named range apart: its device events, device ms
        and host ms, and device ms and launches by kernel name."""
        out = []
        for e in cpu_events:
            if e.name != rname:
                continue
            a, b = e.time_range.start, e.time_range.end
            i0, i1 = bisect.bisect_left(dev_starts, a), bisect.bisect_right(dev_starts, b)
            by = {}
            for _, us, k in dev_by_launch[i0:i1]:
                n, t = by.get(k, (0, 0.0))
                by[k] = (n + 1, t + us)
            out.append({
                "device_events": bisect.bisect_right(launches, b) - bisect.bisect_left(launches, a),
                "device_ms": (dev_cum[i1] - dev_cum[i0]) / 1e3, "host_ms": (b - a) / 1e3,
                "by_kernel": {k: [n, round(t / 1e3, 4)] for k, (n, t) in
                              sorted(by.items(), key=lambda kv: -kv[1][1])[:12]}})
        return out

    init_calls = {}
    if args.imu:
        ba_split["lvi_ba passes"] = calls_of("ba:lvi_ba")
        # each inertial_optimization call apart, and the rungs whole
        init_calls = {"init:inertial_optimization": calls_of("init:inertial_optimization"),
                      **{f"rung:{st}": calls_of(f"rung:{st}") for st in (1, 2)}}
    orb_split = {rname: range_events(rname) for rname, _ in ORB_PARTS}
    orb_split["device events linked to their launch"] = f"{n_linked} of {n_dev}"
    # csrc/local_ba.cu's launches apart: device ms and launches a frame by kernel
    lba = {}
    for e in prof.events():
        m = re.search(r"([A-Za-z_]\w*)\(", e.name)
        k = m.group(1) if m else ""
        if e.device_type == torch.autograd.DeviceType.CUDA and k in LOCAL_BA_KERNELS:
            n, us = lba.get(k, (0, 0.0))
            lba[k] = (n + 1, us + e.time_range.elapsed_us())
    ba_split["local_ba_lm kernels"] = {
        k: {"launches_per_frame": n / n_meas, "device_ms_per_frame": us / 1e3 / n_meas}
        for k, (n, us) in lba.items()}
    sort_dev = "device_time_total" if hasattr(events[0], "device_time_total") else "cuda_time_total"
    table_dev = events.table(sort_by=sort_dev, row_limit=25)
    table_cpu = events.table(sort_by="self_cpu_time_total", row_limit=25)
    (out / "top_device.txt").write_text(table_dev)
    (out / "top_host.txt").write_text(table_cpu)
    summary = {
        "card": smi, "tree": str(Path(tc2li_slam_torch.__file__).resolve().parents[1]),
        "frames": n_meas, "triangulate": cfg.tracking.triangulate,
        "imu_mode": args.imu, "imu_stage_device_events": stage_events,
        "ba_split": ba_split, "orb_split": orb_split,
        "loop_closing": args.loop, "loops_closed": slam.n_loops_closed,
        "loop_candidates_verified": slam.n_loop_verified,
        "vi_initialized": bool(getattr(slam, "_vi_initialized", False)),
        "frames_refined": [getattr(slam, "n_vi_refine_kf", 0),
                           getattr(slam, "n_vi_refine_frame", 0)],
        "lvi_ba_passes": getattr(slam, "n_lvi_ba", 0),
        "init_calls": init_calls,
        "rungs_ran_and_host_ms": rung_ran,
        "vi_stage_frames": vi_stage_frames,
        "gravity_norm": ([float(torch.linalg.norm(slam.gravity_vis)),
                          float(torch.linalg.norm(slam.filt.x.grav))] if args.imu else None),
        "ate_m": syn.ate_rmse(slam.trajectory_world_from_cam(),
                              np.stack([fr.T_wb_gt @ syn.body_from_cam() for fr in frames])),
        "vocabulary_words": None if voc is None else voc.n_words,
        "keyframes": slam.n_kf_host,
        "triangulated_pairs": pairs_of() - pairs0,
        "triangulated_landmarks": int(slam.n_tri_landmarks),
        "host_ms_per_frame": frame_ms,
        "window_s": t_win,
        "device_busy_share": dev_us / 1e6 / t_win,
        "kernel_launches_per_frame": n_kernels / n_meas,
        "host_syncs_per_frame": len(syncs) / n_meas,
        "host_syncs_by_frame": frame_syncs,
        "frame_made_keyframe": frame_kf,
        "sync_sites": sorted(set(syncs))[:20],
        "sync_lines": {k: sync_lines.count(k) for k in sorted(set(sync_lines))},
        "stages_ms_per_frame": {k: 1e3 * v["total_s"] / n_meas
                                for k, v in slam.timers.stats().items()},
    }
    (out / "summary.json").write_text(json.dumps(summary, indent=1))
    print(json.dumps(summary, indent=1))
    print(table_dev[:6000])
    print(table_cpu[:6000])
    if (args.imu or args.loop) and summary["host_syncs_per_frame"] > 1.2:
        print(f"{'IMU mode' if args.imu else 'loop closing'} made "
              f"{summary['host_syncs_per_frame']:.2f} host syncs a frame (> 1.2)", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
