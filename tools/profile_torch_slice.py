#!/usr/bin/env python3
"""Profile the PyTorch port's frame loop on one CUDA card.

    python3 tools/profile_torch_slice.py [--frames 14] [--warm 5] [--triangulate]
                                         [--voc] [--imu] [--loop] [--out build/profile]
                                         [--tree DIR]

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
frame (the candidates must ride in the frame's one transfer). In every mode
the window BA's parts are named ranges too (``balm.build_clusters``,
``balm.quadratic``, ``lm.local_ba``, the last holding the quadratic's calls):
calls, host ms and device events a call of each (``ba_split``), and the
device ms and launches a frame of each kernel of ``csrc/local_ba.cu``
(``ba_split["local_ba_lm kernels"]``). The frame build is split the same
way (``orb_split``): ``build_frame`` and its parts ``orb:level_stacks`` (the
pyramid and blur planes), ``orb:detect`` (the FAST pair), ``orb:select``
(the grid top-k), ``orb:describe`` (orientation and rBRIEF),
``stereo:match`` and ``stereo:subpixel``, each with host ms, device ms (the
kernels, copies and fills whose launch lies in the range, linked by the
profiler's correlation ids) and device events a frame. ``--tree DIR`` runs
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
    from tc2li_slam_torch.io import synthetic as syn
    from tc2li_slam_torch.ops import bow, orb, stereo
    from tc2li_slam_torch.ops.kernels import fast, match
    from tc2li_slam_torch.slam import config as cfg_mod, system as sys_mod, tracking
    from tc2li_slam_torch.solver import balm as balm_mod, lm as lm_mod

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    smi = chip_smoke.nvidia_smi_line()
    rng = np.random.default_rng(0)
    world = syn.make_world(rng, n_surf=300_000)
    frames, _, _ = syn.generate_sequence(
        n_frames=args.frames, cam=syn.KITTI_LIKE, seed=0, n_scan=1 << 17, world=world,
        traj=syn.Trajectory(w_body=(0, 0, 0.03), v_world=(1.5, 0.1, 0.0)))
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

    # the two IMU-mode stages as named ranges in the trace, so that the
    # launches the host makes inside them can be counted
    STAGES = ("_lio_step", "_vi_frame_refine") if args.imu else ()
    for name in STAGES:
        def ranged(*a, _fn=getattr(slam, name), _name=name, **kw):
            with record_function(f"stage:{_name}"):
                return _fn(*a, **kw)
        setattr(slam, name, ranged)
    if args.loop:
        # the detection is a function of the loop-closing module that System
        # calls at a keyframe: the same kind of named range around it
        STAGES = ("detect_candidates_device",)
        detect = sys_mod.loop_closing.detect_candidates_device

        def ranged_detect(*a, **kw):
            with record_function("stage:detect_candidates_device"):
                return detect(*a, **kw)
        sys_mod.loop_closing.detect_candidates_device = ranged_detect

    # the window BA's parts, as module attributes the mapping pass calls
    BA_PARTS = (("build_clusters", balm_mod), ("quadratic", balm_mod), ("local_ba", lm_mod))
    for name, mod in BA_PARTS:
        def ranged_part(*a, _fn=getattr(mod, name), _name=name, **kw):
            with record_function(f"ba:{_name}"):
                return _fn(*a, **kw)
        setattr(mod, name, ranged_part)
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
                 ("stereo:subpixel", ((stereo, "subpixel_refine"),)))
    for rname, attrs in ORB_PARTS:
        for mod, name in attrs:
            if hasattr(mod, name):
                def ranged_orb(*a, _fn=getattr(mod, name), _rname=rname, **kw):
                    with record_function(_rname):
                        return _fn(*a, **kw)
                setattr(mod, name, ranged_orb)

    for fr, sc in zip(frames[:args.warm], scans[:args.warm]):
        track(fr, sc)
    torch.cuda.synchronize()
    slam.timers.reset()

    n_meas = args.frames - args.warm
    frame_ms, frame_syncs, frame_kf = [], [], []
    pairs0 = match.launches_by_mode.get("dense+mutual", 0)
    sync_lines = []

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        record = warnings.showwarning

        def showwarning(message, *a, **kw):
            # where in the port the host waited: the innermost frame of the
            # package on the stack when the sync warning fired
            if "synchroniz" in str(message).lower():
                inner = [f for f in traceback.extract_stack() if "tc2li_slam_torch" in f.filename]
                if inner:
                    f = inner[-1]
                    sync_lines.append(f"{Path(f.filename).relative_to(ROOT)}:{f.lineno} {f.line}")
            record(message, *a, **kw)

        warnings.showwarning = showwarning
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t_win0 = time.perf_counter()
            for fr, sc in zip(frames[args.warm:], scans[args.warm:]):
                t0 = time.perf_counter()
                n_warned, n_kf = len(caught), slam.n_kf_host
                torch.cuda.set_sync_debug_mode("warn")
                track(fr, sc)
                torch.cuda.set_sync_debug_mode("default")
                torch.cuda.synchronize()
                frame_ms.append(1e3 * (time.perf_counter() - t0))
                frame_syncs.append(sum("synchroniz" in str(w.message).lower()
                                       for w in caught[n_warned:]))
                frame_kf.append(slam.n_kf_host > n_kf)
            t_win = time.perf_counter() - t_win0
    syncs = [str(w.message).splitlines()[0] for w in caught
             if "synchroniz" in str(w.message).lower()]
    trace = out / "slice_trace.json"
    prof.export_chrome_trace(str(trace))
    with open(trace, "rb") as src, gzip.open(f"{trace}.gz", "wb") as dst:
        shutil.copyfileobj(src, dst)
    trace.unlink()

    events = prof.key_averages()
    RANGE_PREFIXES = ("stage:", "ba:", "orb:", "stereo:", "build_frame")
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
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA and \
                not e.name.startswith(RANGE_PREFIXES):
            n_dev += 1
            if e.id in launch_at:
                n_linked += 1
                dev_by_launch.append((launch_at[e.id], e.time_range.elapsed_us()))
    dev_by_launch.sort()
    dev_starts = [t for t, _ in dev_by_launch]
    dev_cum = [0.0]
    for _, us in dev_by_launch:
        dev_cum.append(dev_cum[-1] + us)

    def range_events(rname):
        spans = [(e.time_range.start, e.time_range.end) for e in cpu_events if e.name == rname]
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
    ba_split = {name: range_events(f"ba:{name}") for name, _ in BA_PARTS}
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
        "vocabulary_words": None if voc is None else voc.n_words,
        "keyframes": slam.n_kf_host,
        "triangulated_pairs": match.launches_by_mode.get("dense+mutual", 0) - pairs0,
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
