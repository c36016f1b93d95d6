#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``tc2li_slam_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each fatal on failure (non-zero exit, no result line):

1. require a CUDA device; print the card (nvidia-smi name, power limit),
   torch and CUDA versions;
2. build the CUDA kernels from ``tc2li_slam_torch/csrc`` (timed); the
   synthetic stereo pairs of every phase are rendered on the host by a few
   worker processes that end with the rendering;
3. the STEREO_LIDAR slice: 20 KITTI-shaped synthetic frames (1241x376
   stereo, 2000 ORB features over 8 levels, 131072-point scans decimated
   1-in-4) through ``System(cfg, cuda).track``, with the kernel launch
   counters reset just before and read just after; checks tracking state,
   keyframes, a BALM local-BA pass, the voxel map, finite poses, the ATE
   against ground truth (< 0.5 m), and that the launch counts equal what
   the run's own counts imply (one frame build per frame: the pyramid and
   blur planes, the FAST pair, the grid top-k and orientation with rBRIEF,
   one launch each, the grid top-k two, the stereo half's prep, refinement
   and gate (``csrc/stereo.cu``) three; a stereo match per
   frame, a tracking match per tracked frame, one match per fuse pass; one
   pose-only LM per tracked frame); prints ``track_step``'s stage ms a
   frame and ``local_ba``'s by pass. In this and every later phase that
   counts launches the pose-only LM kernel must have launched once per
   ``track_frame`` and once per ``pnp_ransac`` call of the phase's run (both
   counted where the port calls them), and at least once; the BALM
   clusters once per local-BA or LVI-BA pass with the BALM term (its
   ``build_clusters`` call; ``n_ba_balm``, ``n_lvi_ba_balm``, the mesh
   passes of 4g); the BALM
   quadratic twice per local-BA pass with the BALM term (``n_ba_balm``; 2 x
   iterations on the mesh path of 4g), once per LVI-BA pass with it
   (``n_lvi_ba_balm``); the window BA's kernels ``launches_per_call(iters)``
   times per ``run_local_ba`` call off the mesh (``_global_ba``'s included),
   counted where ``System`` calls it; the LVI-BA's kernels
   (``lvi_ba_lm``) ``launches_per_call(iters)`` times per
   ``inertial_ba.lvi_ba`` call, one a pass of ``n_lvi_ba`` (none in the
   STEREO_LIDAR phases); ``inertial_init_gn`` once per
   ``inertial_init.inertial_optimization`` call (none there either);
4. the duplicate-fusion pass (``culling.fuse_duplicates``, the caller of the
   Hamming-matrix kernel) over the slice's landmarks, counted the same way
   and held against the same call on the CPU;
4a. the default configuration (``triangulate=True``) with a vocabulary
   trained on the host from the first frames' descriptors: 14 of the same
   frames, every frame OK, new map points triangulated, the same ATE limit,
   launch counts by call shape against what the run implies (one
   epipolar match per triangulated keyframe pair); the cost and the host syncs of the batched
   4x4 SVD beside the null-vector iteration that replaces it;
4b. recovery: the motion model set far off and an earlier frame fed at the
   next timestamp: ``track_step`` fails, ``track_step_recover`` brings the
   state back to OK within 0.3 m of that frame's ground truth;
4c. ``relocalization.relocalize`` on the system's map, keyframe words and
   an earlier frame: ok, within 0.3 m;
4d. blackout and atlas: 3 uniform-noise stereo pairs (RECENTLY_LOST, then
   the map frozen into the atlas), structured frames that initialise map 1,
   a timestamp jump that starts another map; finite poses, one trajectory
   pose per frame; over a-d the matcher's launches are read by call shape
   from its wrapper and held against what the system's own counts imply;
4e. the IMU mode (IMU_STEREO_LIDAR, ``use_imu=True``, ``inertial_ba=True``,
   bench.py's IMU noise figures): a third ``System`` on 26 of the same
   frames at full width with their IMU windows and per-point scan times;
   every frame OK, the filter's static init, gravity of 9.81 m/s^2 within
   0.2, the staged visual-inertial initialization, at least one LVI-BA pass
   with the BALM term, at least three frames refined by the pose-inertial
   optimizers, an IMU factor at every keyframe but the first, no bad-IMU
   flag, finite poses, the same ATE limit, and the kernels' launch counts
   against what the run implies: ``imu_preintegrate`` once an
   ``estimation.imu.integrate`` call, ``pose_inertial_lm`` once a frame
   refined (``n_vi_refine_kf + n_vi_refine_frame``), the scan step's
   ``esekf_predict`` and ``lio_fences`` once (the fence table in the predict
   launch), ``lio_rows`` max_iters + 2 and ``esekf_step`` max_iters + 1
   times a ``lio_scan_step`` call, 2 max_iters + 4 device launches in all;
   ``lvi_ba_lm`` ``n_lvi_ba`` x ``launches_per_call(ba_iters)`` times;
   ``inertial_init_gn`` once for the one ``inertial_optimization`` call
   (the initialization, frame ~14); ``vi_refine``'s and
   ``lio``'s ms a frame; then the two VIBA rungs on that ``System``
   (``_initialize_imu(kf, stage=1)``, then ``stage=2``, as
   ``_maybe_refine_imu_init`` calls them 5 s and 15 s after the
   initialization, which 26 frames never reach): each runs, |gravity|
   within 0.2 of 9.81, velocities, biases and poses finite, the ATE limit,
   ``inertial_init_gn`` once and the FullInertialBA's ``lvi_ba_lm``
   ``launches_per_call(10)`` times at P 20; then a forced bad-IMU event (a
   window with non-finite samples): ``lio_scan_step`` returns ``bad`` with
   the filter and the voxel map as they were, and through ``track`` the
   inertial stack is re-armed at that frame's sync and initialises again on
   the next frame;
4f. loop closing at full width (1241x376, 2000 features, 8 levels,
   ``max_lm`` 32768, ``max_kf`` 256; LiDAR off, as the gauge ramp below moves
   the visual map only): a fourth ``System`` with ``loop_closing=True`` and a
   vocabulary (k=8, depth=4) trained on the host from every seventh frame,
   on 140 frames of a circle of radius 4 m that revisits its start after 126
   frames, with a gauge ramp (~1 m, ~13 degrees) injected over frames 45..75
   into the recent map segment as accumulated drift. Every frame OK; at least
   one loop closed through ``track`` (candidates from the device-side ladder
   in the frame's one transfer, Sim3 RANSAC, pose graph, global BA); the loop
   edge's residual after ``close_loop`` below 0.3 of what it was; the ATE of
   the frames so far lower after the closure than just before it; finite
   poses and landmarks; the matcher's unmasked mutual launches equal to the
   candidates verified; host syncs counted frame by frame; the pose graph's
   kernels (``pose_graph_gn``) launched ``launches_per_call(n_kf, iters)``
   times a closure (``close_loop`` hands the optimizer the n_kf used slots);
   the first closure's verification, closure and pose-graph optimization
   (the last beside its bound, ``pose_graph_bound``, and at most
   ``launches_per_call`` device events) replayed under the profiler
   (device events, device ms, host ms). Then a
   checkpoint round trip on the card: ``save_system``, ``load_system``, two
   more frames on both, poses equal to 1e-4;
4g. the modules off the frame loop: phase 3's ``System`` (stage timers on,
   ``profile=True``) prints its stage report; a disabled ``StageTimer``
   around a kernel launch records nothing; ``profiling.device_trace`` around
   one more of its frames writes a Chrome trace that names the FAST and
   matcher kernels; the three map exporters write as many vertices as the
   map holds (valid landmarks, stored voxel-map points up to 100000,
   keyframes) and ``draw_frame`` returns the frame's RGB image; LOAM scan
   features on a 64-ring x 2048-point organized scan (an HDL-64E sweep's
   size) equal to the CPU's but where a float gate sits within 1e-5 of its
   threshold; then distributed BA on a NCCL group of world size 1 (one card:
   NCCL takes one rank per device): the reference's test problem equal to a
   gloo group on the CPU to 1e-4 and to ``lm.local_ba`` to 5e-3, the
   KITTI-shaped window at full width (ms an iteration, no host sync, peak
   memory), and ``System(cfg, cuda, mesh=...)`` on phase 3's frames within
   the reference's ATE rule against phase 3, with its host syncs by frame;
5. each kernel against its plain PyTorch version on the card, exact, at
   the main path's shapes, with CUDA-event times and the least time the
   card could take (bytes over 3.35 TB/s, operations over the float32 rate):
   FAST detection on the real 8-level stacks of one and of two 1241x376
   images, per pass and fused, beside the per-level route it replaced; the
   three other ORB kernels on the same images (the pyramid and blur planes,
   the grid top-k, orientation and rBRIEF: bit-equal, the descriptors of
   every keypoint whose angle is), the first two also on the pair resampled
   to 1280x720 (7,200 grid candidates at level 0), and no host sync in one
   ``build_frame``;
   the fused matcher in its mask modes on the slice's own data (the
   last frame's stereo pair at 2000x2000; the landmark pool against a
   keyframe's features at 32768x2000), on a full pool, on a dense worst
   case and on edge rows, on the window mode's grid edge cases
   (``window_case``), the stereo mode's row bins (``stereo_bins_case``) and
   the epipolar mode's gate (``epipolar_case``: a pair on the gate, lines
   of l0^2 + l1^2 below 1e-12, non-finite inputs, no valid row, ties, side 2
   in two column chunks, one row), the dense mode's tiles (``dense_case``,
   300 x 12,037: no valid column or row, a tie across a tile boundary, a
   repeated column, a row whose only admitted column is in the last tile, a
   bool mask, one row), and in the three call shapes of 4a-4d on that run's
   data (a keyframe pair under its epipolar gate, the pool against a frame,
   a frame against the whole pool), and in the call shape of 4f (two
   keyframes' 2000 features, no mask, mutual), each case the same bits on a
   second call and a launch a call (a launch a column chunk); the Hamming
   matrix at 2000x2000 and 32768x2000; the pose-only LM on the inputs of
   phase 3's last ``pose_only_optimize`` call, on 4b's PnP polish, at N =
   5000, with nothing valid and with a masked NaN row
   (poses to 1e-4, costs to 1e-3 relative, inlier flags equal but where a
   row's chi2, re-derived in float64, sits at its threshold; times behind a
   device backlog beside the plain version's, and a pass's share); the
   pose-inertial LM (``pose_inertial_lm``) at 15 and 30 free dims on 4e's
   last call of each form, on it with nothing valid and with a masked NaN
   row, and on ``vi_problem``'s frames at O 3 and 60 (T_wb and vel to 1e-4,
   bg 1e-5, ba 1e-4, the next prior's H 1e-3 of its largest entry, the cost
   1e-3, or else no farther from the plain version run in float64; inlier
   flags equal but at a gate; the same bits on a second call; no host sync);
   the preintegration (``imu_preintegrate``) on 4e's last and longest
   windows and at N 1, 10 and 1024 with padded slots, against the plain
   version run in float64 (1e-4 of each output's largest entry, or 4x the
   float32 plain version's own distance); the scan step's four kernels
   (``lio_phase``) on 4e's last scan step, the same at ``work_cap`` 32768,
   with the extrinsic estimated, against an empty map and with a
   non-finite IMU sample: ``esekf_predict`` (also at 10, 20 and 40 live
   samples and 40 in 1,024 slots, ``predict_window``), the fence table
   that the predict launch's ``lio_fences`` blocks write (equal; the
   prediction bit-equal with and without them, and the launch timed both
   ways) and the neighbour sets of ``lio_rows`` against the
   plain versions, the rows' normal equations and
   the whole update against the plain version or else no farther from its
   float64 run, every ``esekf_step`` launch against ``esekf.map_step`` /
   ``posterior_covariance`` in float64 on the kernel's own sums
   (``LIO_TOL``), the same bits twice, no host sync in a scan step; the
   window BA's kernels on the inputs of phase 3's last local-BA pass with
   the BALM term, of 4f's global BA (64 poses) and on phase 3's pass with
   no valid landmark (poses to 1e-4, landmarks to 1e-3 m, cost to 1e-4
   relative, or else no farther from the plain version run in float64; the
   same bits on a second call; the device time of a call split by launch
   with ``torch.profiler``); the LVI-BA's kernels (``lvi_phase``) on 4e's
   last pass (the BALM term on) and on a synthetic FullInertialBA window
   (``lvi_problem``: P 20, 8192 landmarks, 10 iterations) to ``LVI_TOL`` or
   else no farther from the plain version run in float64 on the host, the
   inlier flags equal but at a gate, the same bits twice, no
   host sync, device ms by kernel, and on the second VIBA rung's
   FullInertialBA pass; the visual-inertial initialization's kernel
   (``init_phase``) on 4e's call, both rungs' and ``init_problem``'s
   windows (free gravity and scale, free gravity, 6 keyframes padded to
   20, a NaN in a valid and in an invalid factor) to ``INIT_TOL`` or else no
   farther from the plain version run in float64 on the host, the same
   bits twice, one launch a call, no host sync, device ms at 4e's call and
   the free-gravity and free-scale windows behind a backlog; the pose
   graph's kernels (``pose_graph_phase``) on 4f's closure and on
   ``pose_graph_problem``'s graphs (drift, two fixed poses with invalid and
   zero-weight edges, scale drift, a non-finite edge, 400 keyframes with
   covisibility edges: 2,793 free rows, 2,048 keyframes: 14,329 free rows
   at ``PG_ITERS_2048`` iterations) to ``PG_TOL`` (``PG_TOL_LARGE`` above
   ``PG_LARGE_K`` keyframes) on every pose entry of the plain version run
   in float64 on the card, the same bits twice, the wrapper's launches, no
   host sync, each case's seconds, device ms at 4f's closure and the two
   large graphs behind a backlog beside the bound, the plain version and
   the library's Cholesky and solve of the free rows' H, and the launches
   by kernel name; the BALM quadratic
   on phase 3's last clusters (H and g to 1e-3 of their largest entry, the
   cost to 1e-3 relative, the same bits on a second call) and with every
   voxel invalid (exactly 0); the stereo half of the frame build
   (``stereo_refine``) on phase 3's last pair, on its every-keypoint-ok
   case (the reference's median gate fires) and on keypoints at the image
   borders, and on ``STEREO_EDGE_CASES`` (no, one, an odd and an even count
   of keypoints; one not ok, so that the gate is off; SAD ties; float32
   images; the right keypoints in two column chunks), bit-equal to the plain
   chain (u_r, ok, depth, uvr), the same bits twice, its launches and the
   match's as ``launches_per_call`` and the chunks imply, no host sync, its
   two launches' device ms by kernel
   (``torch.profiler``) beside the bound and the plain chain after the
   match; the BALM clusters (``balm_clusters``) on the windows of phase 3's
   and 4e's last ``build_clusters`` calls and on six planar keyframes:
   N, mean, Pc and center bit-equal to the plain version, the planar flags
   equal but within 1e-5 of the threshold in float64
   (``clusters_agree``), the same bits twice, no host sync, device ms;
6. one JSON line of kernel rows, the nvidia-smi line, and last the result
   line {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

N_FRAMES = 20
N_WARM = 5          # frames before the steady-state timing window
N_TRI = 14          # frames of the triangulate=True run
N_IMU = 26          # frames of the IMU-mode run (the first N_FRAMES are phase 3's)
N_IMU_WARM = 16     # ... of which before its steady-state window (the VI init is over)
N_LOOP = 140        # frames of the loop-closing run (4f), plus 2 after the checkpoint
LOOP_PERIOD = 126   # frames per revolution: 2 pi / omega * fps
LOOP_DRIFT = (45, 75)                       # frames of the injected gauge ramp
LOOP_DRIFT_XI = (0.8, 0.0, 0.5, 0.0, 0.22, 0.0)   # its total, an se3 tangent
ATE_BOUND_M = 0.5
# the kernels of one frame build and their launches: ORB (ops/orb.extract_images)
# one each, the grid top-k two (its cell pass, then its selection); the stereo
# half two (csrc/stereo.cu: prep, refine with the gate; the match between
# them is match_best2's)
FRAME_LAUNCHES = {"orb_level_planes": 1, "fast_score_planes": 1, "fast_nms_planes": 1,
                  "orb_select_grid": 2, "orb_describe": 1, "stereo_refine": 2}
FRAME_KERNELS = tuple(FRAME_LAUNCHES)
RECOVER_BOUND_M = 0.3

# Published peaks of one H100 SXM: device memory, float32 outside the tensor
# cores (67 TFLOP/s counts a fused multiply-add as two, so a min, max,
# compare or subtract issues at half of it), and __popc at an eighth of that
# (16 a clock per SM against 128 simple lanes).
PEAK_BYTES_S = 3.35e12
PEAK_SIMPLE_S = 67e12 / 2
PEAK_POPC_S = PEAK_SIMPLE_S / 8
# operations per pixel of the segment test (csrc/fast.cu): 4 compass
# differences and their bound; then 12 more differences, the doubling steps
# and the final maxima
FAST_OPS_REJECT = 21
FAST_OPS_FULL = 174
# pose-only LM (csrc/pose_lm.cu): bytes read once (T_cw0, then per row the
# point, the observation, inv_sigma2 and two flags) and written once (the
# pose, an inlier flag per row, the count and the cost); operations per row
# and pass: the transform, the residual and its gates, the Huber weight,
# the 3x6 Jacobian and the 27 sums of (w J)^T [J | r] and the cost
POSE_BYTES_FIXED = 64 + 64 + 4 + 4
POSE_BYTES_ROW = 12 + 12 + 4 + 1 + 1 + 1
POSE_OPS_ROW = 180
# window BA (csrc/local_ba.cu), operations an iteration: per observation of
# non-zero weight the residual, both Jacobians, the weight, Hpp's 21 and gp's
# 6 sums, B and Hll, gl, B Hll^-1 and its gradient term, and the candidate's
# back-substitution and cost; per ordered pair of such observations of one
# valid landmark half of a 6x6 Schur block (S is symmetric); per landmark
# the damped 3x3 inverse; then the dense solve's multiply-adds, each one
# operation: D^3 / 3 for the elimination, D^2 for the substitutions, D^2 for
# the scaling
LBA_OPS_LIVE = 670
LBA_OPS_PAIR = 108
LBA_OPS_LANDMARK = 80
# BALM quadratic (csrc/balm.cu), per valid voxel: the eigenvalue's jet
# (~3,000), a derivative row per tangent (~130), the pose-diagonal second
# order terms (~150 each of 9 W) and ~20 per Hessian entry
BALM_OPS_JET = 3000
BALM_OPS_ROW = 130
BALM_OPS_POSE_TERM = 150
BALM_OPS_ENTRY = 20
# float64 outside the tensor cores: 34 TFLOP/s (NVIDIA's data sheet, H100
# SXM), a fused multiply-add counted as two
PEAK_F64_S = 34e12 / 2
# float64 on the tensor cores (DMMA): 67 TFLOP/s (the same data sheet), a
# fused multiply-add counted as two; a dense factorization's trailing update
# and its substitutions are their shape
PEAK_F64_TC_S = 67e12 / 2
# IMU preintegration (csrc/imu_preint.cu), float32 operations a sample, a
# fused multiply-add counted as one (as PEAK_SIMPLE_S): A C9 on A's block
# structure (9 3x3 products, 243) and C9's six upper blocks of (A C9) A^T
# (162), their block sums (~90), (B N) B^T's four non-zero blocks (216), the
# chain's 3x3 products, Jacobians and vectors (~250), the sample's own
# rotation and right Jacobian (~150); the chunks' joins add < 1% at N 60;
# bytes a sample: gyro, acc, dt
IMU_OPS_SAMPLE = 243 + 162 + 90 + 216 + 250 + 150
IMU_BYTES_SAMPLE = 28
# pose-inertial LM (csrc/pose_inertial.cu), float64 operations, a fused
# multiply-add counted as one (as PEAK_F64_S, and as POSE_OPS_ROW):
# - a row a pass: the two transforms (24), the projection and residual
#   (14), the projection's derivative (8) and its product with R_cb (27),
#   the 3x6 Jacobian (18), chi2, the gates, the Huber weight and w (10),
#   the cost (1), w J (18) and the 21 + 6 sums (81);
# - a pass's assembly by free dims, over the Jacobians' non-zero rows and
#   the symmetric blocks' upper triangles: the IMU factor's residual and
#   intermediates (~470), J1's and J2's entries (~250), I r (81), I J2
#   (648), J2^T I J2 (468), g2 and the costs (~100); at 30 also the prior's
#   terms (~160), Hw rp (225), I J1 (486), Jp^T Hw (405), J1^T I J1 and
#   (Jp^T Hw) Jp (720), J1^T I J2 (810), g1 and the prior's cost (~90);
# - a step's solve: the scaled system's lower triangle (n (n + 1)), its
#   Cholesky (n^3 / 6 and n divisions), the two triangular solves (n^2) and
#   the update through se3_exp (~150 a state);
# - at 30 once a call, the Schur complement: a 15x15 Cholesky, 15 column
#   solves and H12^T X's upper triangle (~5,700);
# bytes a row: X, uvr, inv_sigma2, two flags in, an inlier flag out
VI_OPS_ROW = 24 + 14 + 8 + 27 + 18 + 10 + 1 + 18 + 81
VI_OPS_ASSEMBLE = {15: 2_000, 30: 4_900}
VI_OPS_STEP = {15: 1_200, 30: 6_700}
VI_OPS_SCHUR = {15: 0, 30: 5_700}
VI_BYTES_ROW = 12 + 12 + 4 + 2 + 1
VI_BYTES_FIXED = 4 * (16 * 4 + 9 * 4 + 225 + 1 + 66 + 225 + 5) + 4 * 252 + 4


def fail(msg: str) -> int:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    return 1


def nvidia_smi_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if res.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, reps: int, backlog: bool = False) -> float:
    """Mean CUDA-event time of ``fn`` over ``reps`` calls after one warm-up.

    The events bracket the device's timeline, so where the host enqueues
    more slowly than the device executes (a wrapper around one short
    kernel) they would time the host. With ``backlog`` the device is first
    kept busy with a few large matrix products while the host enqueues all
    the calls; they then run back to back and the time is the device's."""
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    if backlog:
        a = torch.empty((4096, 4096), device="cuda").normal_()
        torch.cuda.synchronize()
        for _ in range(6):
            a @ a
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / reps


# device events ``kernel_split`` launches at the head of a profile window:
# torch.profiler drops the first events of a window from its record, more of
# them the older the process (one more about every 15 s on an H100 machine,
# PERF.md section 7), so spin kernels take those places
PROFILE_LEAD = 256


def kernel_split(torch, fn, calls: int) -> dict:
    """Device ms a call of each kernel name that ``fn`` launches, from a
    ``torch.profiler`` trace of ``calls`` calls after one warm-up: {name:
    {"launches_a_call", "ms_a_call", "ms_a_launch"}}, the largest first.
    Names are cut to the function's (``build_kernel`` for ``(anonymous
    namespace)::build_kernel(...)``). The window opens with
    ``PROFILE_LEAD`` spin kernels and a sync, left out of the result; the
    record is whole when one of them is in it (the profiler loses the
    window's first events), else the window is taken again with four times
    the lead, twice at most, and then RuntimeError."""
    import re
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for lead in (PROFILE_LEAD, 4 * PROFILE_LEAD, 16 * PROFILE_LEAD):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(lead):
                torch.cuda._sleep(1)
            torch.cuda.synchronize()
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        per = {}
        for e in prof.events():
            if e.device_type != torch.autograd.DeviceType.CUDA:
                continue
            m = re.search(r"([A-Za-z_]\w*)(?:<[^(]*>)?\(", e.name)
            k = m.group(1) if m else e.name
            n, us = per.get(k, (0, 0.0))
            per[k] = (n + 1, us + e.time_range.elapsed_us())
        if per.pop("spin_kernel", None):
            return {k: {"launches_a_call": n / calls, "ms_a_call": us / 1e3 / calls,
                        "ms_a_launch": us / 1e3 / n}
                    for k, (n, us) in sorted(per.items(), key=lambda kv: -kv[1][1])}
    raise RuntimeError(f"kernel_split: torch.profiler lost all {lead} lead events of the "
                       f"window, so the record of the calls may not be whole")


def counted(fn):
    """``fn`` with a count of its calls: ``(wrapped, calls)``, ``calls[0]``
    the calls made through ``wrapped`` (``kernel_split`` calls a function
    again whenever it retakes its window, so a test that counts launches
    across it compares them with the calls it counted)."""
    calls = [0]

    def wrapped():
        calls[0] += 1
        return fn()

    return wrapped, calls


def bound(n_bytes: float, simple_ops: float = 0.0, popc: float = 0.0):
    """(least ms on the card, what bounds it) for that much work."""
    t_bytes = n_bytes / PEAK_BYTES_S
    t_ops = max(simple_ops / PEAK_SIMPLE_S, popc / PEAK_POPC_S)
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def kitti_config(cfg_mod, syn, triangulate: bool = False, cam=None, **tracking):
    """bench.py's KITTI-shaped STEREO_LIDAR configuration, stage timers on
    (``profile=True``) as there; ``triangulate=True`` is its default, off is
    the first slice's. ``cam``, a ``syn.CameraRig``, replaces the KITTI-like
    camera. ``tracking`` overrides fields of the TrackingConfig."""
    import numpy as np
    cam = cam or syn.KITTI_LIKE
    return cfg_mod.SystemConfig(
        camera=cfg_mod.CameraConfig(
            fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy, width=cam.width,
            height=cam.height, baseline=cam.baseline, th_depth=35.0 * cam.baseline),
        orb=cfg_mod.OrbConfig(n_features=2000, n_levels=8),
        lidar=cfg_mod.LidarConfig(
            enabled=True, map_capacity=1 << 19, kf_points=2048, balm_max_voxels=512,
            scan_voxel=0.5, map_voxel=0.5, blind=2.0,
            T_cl=np.linalg.inv(syn.body_from_cam())),
        tracking=cfg_mod.TrackingConfig(
            max_kf=256, max_lm=32768, max_obs=8, kf_max_interval=5,
            local_window=6, ba_iters=6, triangulate=triangulate, **tracking),
        profile=True,
    )


def same(torch, got, ref) -> bool:
    """Tuples of tensors (or None) equal in dtype and every value."""
    return all((g is None and r is None) or
               (g is not None and r is not None and g.dtype == r.dtype and torch.equal(g, r))
               for g, r in zip(got, ref))


def bit_equal(torch, got, ref) -> bool:
    """Tuples of tensors with the same dtype and bits (float32 compared as
    int32: -0.0 is not 0.0, a NaN equals the same NaN)."""
    bits = lambda x: x.view(torch.int32) if x.dtype == torch.float32 else x
    return all(g.dtype == r.dtype and torch.equal(bits(g), bits(r)) for g, r in zip(got, ref))


def inject_drift(torch, lie, slam, W):
    """Accumulated odometric drift as a gauge jump: the recent map segment
    (the last 8 keyframes and the landmarks they first observed) and the
    live pose move to the drifted world gauge ``W`` [4, 4]. Older map entries
    keep the old gauge, so the revisit carries a real loop error."""
    slam.flush_mapping()   # deferred mapping lands in the old gauge
    W_inv = lie.se3_inverse(W)
    cut = max(slam.n_kf_host - 8, 1)
    m = slam.map
    recent_kf = (torch.arange(m.K, device=m.device) >= cut) & m.kf_valid
    lm_recent = (m.lm_first_kf >= cut) & m.lm_valid
    slam.map = m.replace(
        kf_T_cw=torch.where(recent_kf[:, None, None], m.kf_T_cw @ W_inv, m.kf_T_cw),
        lm_pos=torch.where(lm_recent[:, None], lie.se3_apply(W, m.lm_pos), m.lm_pos))
    slam.T_cw = slam.T_cw @ W_inv
    slam.last_T_cw = slam.last_T_cw @ W_inv


def dist_problem(torch, rng, Pn: int = 6, L: int = 512, K: int = 4, pose_noise: float = 0.03,
                 lm_noise: float = 0.10):
    """tests/test_dist_ba.py's ``make_problem`` with numpy and the port: a
    window of ``Pn`` poses (the first the gauge anchor) and ``L`` landmarks,
    each seen from min(K, Pn) distinct poses with 0.3 px of noise (the rest
    of its K observation slots padding), the initial poses and landmarks
    perturbed. The same draws from ``rng`` as the reference's ``make_problem``.
    Returns (camera, dict of numpy arrays)."""
    import numpy as np
    from tc2li_slam_torch.geom import camera as cam_mod, lie
    cam = cam_mod.Pinhole.create(500.0, 500.0, 320.0, 240.0, bf=250.0)
    exp = lambda xi: lie.se3_exp(torch.as_tensor(np.asarray(xi, np.float32))).numpy()
    X = np.stack([rng.uniform(-15, 15, L), rng.uniform(-8, 8, L), rng.uniform(10, 50, L)],
                 -1).astype(np.float32)
    T_gt = np.stack([exp(np.concatenate([[0.6 * p, 0.02 * p, 0.0], rng.uniform(-0.02, 0.02, 3)]))
                     for p in range(Pn)])
    n_obs = min(K, Pn)
    pose_idx = np.zeros((L, K), np.int32)
    pose_idx[:, :n_obs] = np.stack([rng.choice(Pn, n_obs, replace=False) for _ in range(L)])
    T = T_gt[pose_idx]
    Xc = np.einsum("lkij,lj->lki", T[..., :3, :3], X) + T[..., :3, 3]
    uv = cam_mod.project_stereo(cam, torch.as_tensor(Xc.astype(np.float32))).numpy()
    uv[..., :2] += rng.normal(0, 0.3, uv[..., :2].shape)
    T0 = [T_gt[0]]
    for p in range(1, Pn):
        T0.append(T_gt[p] @ exp(pose_noise * rng.standard_normal(6).astype(np.float32)))
    X0 = X + lm_noise * rng.standard_normal(X.shape).astype(np.float32)
    valid = np.broadcast_to(np.arange(K) < n_obs, (L, K)).copy()
    return cam, dict(T_gt=T_gt, X=X, T0=np.stack(T0), X0=X0, pose_idx=pose_idx, uv=uv,
                     inv_sigma2=np.ones((L, K), np.float32), stereo=np.ones((L, K), bool),
                     valid=valid, fixed=np.arange(Pn) == 0)


POSE_CASES = ("tracking", "pnp", "all_invalid", "behind_and_z0", "masked_nan")


def pose_problem(rng, n: int = 2000, case: str = "tracking"):
    """Inputs of ``pose_only_optimize`` (numpy, from ``rng``) for one of
    ``POSE_CASES``, with the KITTI-shaped camera. ``tracking``: a frame's
    ``n`` features, about half of them matched (``valid``; the rest padding
    that repeats point 0, as ``track_frame``'s clamp does), 60% stereo, 10%
    outliers of ~40 px, noise and ``inv_sigma2`` from 8 pyramid levels, the
    initial pose ~1 cm and ~0.6 degrees off. ``pnp``: PnP RANSAC's polish,
    2 rounds of 8 iterations, no stereo column, unit ``inv_sigma2``, 5%
    outliers among its inliers. ``all_invalid``: nothing valid.
    ``behind_and_z0``: an initial pose without rotation, and two valid
    stereo points: one 5 m behind it, one at depth exactly 0. ``masked_nan``:
    a masked row whose point is NaN. Returns (Pinhole.create arguments,
    (T_cw0, X_w, uv_obs, inv_sigma2, stereo, valid), dict(rounds, iters))."""
    import numpy as np
    from tc2li_slam_torch.io.synthetic import KITTI_LIKE as rig, so3_exp_np

    def pose(rot, trans):
        T = np.eye(4)
        T[:3, :3] = so3_exp_np(rng.normal(0, rot, 3))
        T[:3, 3] = rng.normal(0, trans, 3)
        return T

    fx, fy, cx, cy, bf = rig.fx, rig.fy, rig.cx, rig.cy, rig.fx * rig.baseline
    T0 = pose(0.05, 0.5)
    if case == "behind_and_z0":
        T0[:3, :3] = np.eye(3)
    T0 = T0.astype(np.float32)
    T_true = T0.astype(np.float64) @ pose(0.01, 0.01)
    z = rng.uniform(3.0, 40.0, n)
    u, v = rng.uniform(0, rig.width, n), rng.uniform(0, rig.height, n)
    Xc = np.stack([(u - cx) / fx * z, (v - cy) / fy * z, z], -1)
    X = ((Xc - T_true[:3, 3]) @ T_true[:3, :3]).astype(np.float32)
    level = rng.integers(0, 8, n)
    uv = np.stack([u, v, u - bf / z], -1)
    pnp = case == "pnp"
    uv[:, :2] += rng.normal(0, 0.7, (n, 2)) if pnp else \
        rng.normal(0, 0.5, (n, 2)) * 1.2 ** level[:, None]
    uv[:, 2] = uv[:, 0] - bf / z
    out = rng.random(n) < (0.05 if pnp else 0.1)
    uv[out, :2] += rng.normal(0, 40.0, (int(out.sum()), 2))
    stereo = np.zeros(n, bool) if pnp else rng.random(n) < 0.6
    uv[~stereo, 2] = -1.0
    inv_s2 = np.ones(n) if pnp else 1.0 / 1.44 ** level
    valid = rng.random(n) < (0.6 if pnp else 0.5)
    if not pnp:
        X[~valid] = X[0]
    if case == "all_invalid":
        valid[:] = False
    elif case == "behind_and_z0":
        valid[:2] = stereo[:2] = True
        X[0, 2] = -5.0 - T0[2, 3]
        X[1, 2] = -T0[2, 3]        # R = I: z = X_z + t_z is exactly 0 in float32
    elif case == "masked_nan":
        X[np.flatnonzero(~valid)[0]] = np.nan
    args = (T0, X, uv.astype(np.float32), inv_s2.astype(np.float32), stereo, valid)
    return (fx, fy, cx, cy, bf, rig.width, rig.height), args, \
        dict(rounds=2, iters=8) if pnp else dict(rounds=4, iters=10)


def pose_agreement(cam, args, got, ref) -> dict:
    """How two ``PoseOnlyResult``s on the inputs ``args`` (tensors) agree:
    ``pose`` the largest |T| difference, ``cost`` the relative cost
    difference (0 where both are NaN), ``flips`` the rows whose inlier flag
    differs and ``near`` those of them that sit at a gate: their chi2
    re-derived in float64 at either pose within 1e-3 relative of its
    threshold or on both sides of it, or their depth so at 0.05. Sums taken
    in another order move a row only there."""
    import numpy as np
    X, uv, s2, st = (np.asarray(a.detach().cpu(), np.float64) for a in args[1:5])
    st = st.astype(bool)
    thr = np.where(st, 7.815, 5.991)

    def gates(T):
        T = np.asarray(T.detach().cpu(), np.float64)
        Xc = X @ T[:3, :3].T + T[:3, 3]
        z = np.where(np.abs(Xc[:, 2]) < 1e-9, 1e-9, Xc[:, 2])
        u = cam.fx * Xc[:, 0] / z + cam.cx
        r = np.stack([u - uv[:, 0], cam.fy * Xc[:, 1] / z + cam.cy - uv[:, 1],
                      np.where(st, u - cam.bf / z - uv[:, 2], 0.0)], -1)
        return s2 * np.sum(r * r, -1), Xc[:, 2]

    with np.errstate(invalid="ignore", over="ignore"):
        (c1, z1), (c2, z2) = gates(got.T_cw), gates(ref.T_cw)
        near = ((np.minimum(np.abs(c1 - thr), np.abs(c2 - thr)) <= 1e-3 * thr)
                | ((c1 - thr) * (c2 - thr) <= 0)
                | (np.minimum(np.abs(z1 - 0.05), np.abs(z2 - 0.05)) <= 5e-5)
                | ((z1 - 0.05) * (z2 - 0.05) <= 0))
    flips = np.asarray((got.inliers != ref.inliers).cpu())
    cg, cr = float(got.cost), float(ref.cost)
    cost = 0.0 if np.isnan(cg) and np.isnan(cr) else abs(cg - cr) / max(abs(cr), 1e-30)
    return dict(pose=float((got.T_cw - ref.T_cw).abs().max()), cost=cost,
                flips=int(flips.sum()), near=int((flips & near).sum()),
                n_inliers=(int(got.n_inliers), int(ref.n_inliers)))


BA_CASES = ("visual", "balm", "global_p64", "all_fixed", "no_valid_landmark", "masked_nan")
BA_CAM = (320.0, 320.0, 320.0, 120.0, 160.0, 640, 240)   # fx fy cx cy bf width height
BALM_CASES = ("planar", "padded_poses", "invalid_voxels", "all_invalid")


def _np_poses(rng, k: int, rot: float, trans: float):
    """[k, 4, 4] float32 poses with N(0, rot) rotation vectors and N(0, trans)
    translations."""
    import numpy as np
    from tc2li_slam_torch.io.synthetic import so3_exp_np
    T = np.tile(np.eye(4), (k, 1, 1))
    for i in range(k):
        T[i, :3, :3] = so3_exp_np(rng.normal(0, rot, 3))
        T[i, :3, 3] = rng.normal(0, trans, 3)
    return T.astype(np.float32)


def planar_window(rng, W: int = 4, M: int = 3000):
    """Per-keyframe LiDAR points [W, M, 3] (each in its own frame) of three
    planes seen from W nearby poses T_wl, with 5% of them invalid, and the
    poses perturbed by a few mm (T_pert). Returns (points, valid, T_wl, T_pert)."""
    import numpy as np
    T_wl = _np_poses(rng, W, 0.02, 0.3)
    pts = []
    for _ in range(W):
        u, v = rng.uniform(-3, 3, M), rng.uniform(-3, 3, M)
        face = rng.integers(0, 3, M)
        p = np.stack([u, v, np.zeros(M)], 1)
        p[face == 1] = np.stack([u, np.full(M, 4.0), v], 1)[face == 1]
        p[face == 2] = np.stack([np.full(M, -3.0), u, v], 1)[face == 2]
        pts.append(p + rng.normal(0, 0.01, p.shape))
    pl = np.einsum("wji,wmj->wmi", T_wl[:, :3, :3], np.stack(pts) - T_wl[:, None, :3, 3])
    valid = rng.random((W, M)) > 0.05
    T_pert = (T_wl @ _np_poses(rng, W, 0.002, 0.01)).astype(np.float32)
    return pl.astype(np.float32), valid, T_wl, T_pert


def balm_case(rng, case: str = "planar"):
    """Inputs of the BALM quadratic, ``BALM_CASES``: the points, their flags
    and the poses to build the voxel clusters at (``build_clusters`` with 1 m
    voxels, 256 slots, 15 points), the poses to take the quadratic at, and
    the voxels to mark invalid after the build. ``planar``: a window of 4
    LiDAR keyframes of three planes; ``padded_poses``: 6 slots of which the
    last 2 are ``NO_KF`` padding (identity poses, no valid point);
    ``invalid_voxels``: every third voxel marked invalid; ``all_invalid``:
    every voxel."""
    import numpy as np
    W = 6 if case == "padded_poses" else 4
    pl, valid, T_wl, T_pert = planar_window(rng, W)
    if case == "padded_poses":
        valid[4:] = False
        T_wl[4:] = T_pert[4:] = np.eye(4, dtype=np.float32)
    kill = np.zeros(256, bool)
    if case == "invalid_voxels":
        kill[::3] = True
    if case == "all_invalid":
        kill[:] = True
    return dict(points=pl, valid=valid, T_build=T_wl, T_eval=T_pert, kill=kill)


def ba_problem(rng, case: str = "visual"):
    """A window bundle adjustment, ``BA_CASES``, as numpy arrays for
    ``lm.local_ba`` (``BA_CAM``, 6 iterations): landmarks seen by K = 4 of the
    window's real poses with 0.7 px noise, 10% of the observations and 2%
    of the landmarks masked, the first pose fixed, poses and landmarks
    perturbed. ``visual``: 6 poses, 400 landmarks. ``balm``: 4 poses that are
    also the LiDAR keyframes of ``planar_window`` (camera and LiDAR frames
    equal), with its points for a BALM term of weight 0.1 built at the
    perturbed poses. ``global_p64``: the global BA's shape, 8 real poses and 56
    ``NO_KF`` pads (identity, fixed, never observed). ``all_fixed``: every pose
    fixed. ``no_valid_landmark``: every landmark masked. ``masked_nan``: one
    landmark all of whose observations are masked has a NaN position.
    ``global_p64`` takes 3 iterations: its cost is at float32 rounding after
    the third, where whether a step is accepted depends on the order of a
    float32 sum, so two libraries can part by a step (1.6 mm on a 30 m
    landmark at the fourth)."""
    import numpy as np
    fx, fy, cx, cy, bf = BA_CAM[:5]
    Pr = {"balm": 4, "global_p64": 8}.get(case, 6)
    P = 64 if case == "global_p64" else Pr
    L, K = 400, 4
    out = {}
    if case == "balm":
        pl, pv, T_wl, T_pert = planar_window(rng, Pr)
        T_true, T0 = np.linalg.inv(T_wl), np.linalg.inv(T_pert)
        out.update(points=pl, points_valid=pv, T_cl=np.eye(4, dtype=np.float32), w_lba=0.1,
                   pos_in_win=np.arange(Pr), lvalid=np.ones(Pr, bool))
    else:
        T_true = _np_poses(rng, Pr, 0.03, 0.5)
        T0 = T_true @ _np_poses(rng, Pr, 0.003, 0.02)
    X = np.concatenate([rng.uniform(-8, 8, (L, 2)), rng.uniform(4, 30, (L, 1))], 1)
    pose_idx = np.stack([rng.permutation(Pr)[:K] for _ in range(L)]).astype(np.int32)
    Tp = T_true[pose_idx]
    xc = np.einsum("lkij,lj->lki", Tp[..., :3, :3], X) + Tp[..., :3, 3]
    uv = np.stack([fx * xc[..., 0] / xc[..., 2] + cx, fy * xc[..., 1] / xc[..., 2] + cy,
                   fx * xc[..., 0] / xc[..., 2] + cx - bf / xc[..., 2]], -1)
    uv = (uv + rng.normal(0, 0.7, uv.shape)).astype(np.float32)
    stereo = rng.random((L, K)) > 0.4
    uv[~stereo, 2] = -1.0
    valid = rng.random((L, K)) > 0.1
    X0 = (X + rng.normal(0, 0.05, X.shape)).astype(np.float32)
    valid_lm = rng.random(L) > 0.02
    T0 = np.concatenate([T0, np.tile(np.eye(4), (P - Pr, 1, 1))]).astype(np.float32)
    fixed = np.arange(P) == 0
    fixed[Pr:] = True
    if case == "all_fixed":
        fixed[:] = True
    if case == "no_valid_landmark":
        valid_lm[:] = False
    if case == "masked_nan":
        valid[3] = False
        X0[3] = np.nan
    out.update(T0=T0, X0=X0, pose_idx=pose_idx, uv=uv,
               inv_sigma2=(1.0 / 1.44 ** rng.integers(0, 3, (L, K))).astype(np.float32),
               stereo=stereo, valid=valid, fixed=fixed, valid_lm=valid_lm,
               iters=3 if case == "global_p64" else 6)
    return out


def ba_torch(torch, p, dev, clusters=None):
    """``ba_problem``'s arrays as the port's ``lm.local_ba`` arguments on
    ``dev``: (camera, T0, X0, BAObservations, fixed, valid_lm) and keywords
    (``iters``, and for ``balm`` the ``extra_fn`` of ``local_mapping._balm_extra``
    over ``clusters``, by default built with ``balm.build_clusters`` at the
    entry poses)."""
    from tc2li_slam_torch.geom import camera as cam_mod, lie
    from tc2li_slam_torch.slam import local_mapping
    from tc2li_slam_torch.solver import balm, lm
    t = lambda k: torch.as_tensor(p[k]).to(dev)
    cam = cam_mod.Pinhole.create(*BA_CAM[:4], bf=BA_CAM[4], width=BA_CAM[5], height=BA_CAM[6])
    obs = lm.BAObservations(*(t(k) for k in ("pose_idx", "uv", "inv_sigma2", "stereo", "valid")))
    kw = {"iters": p["iters"]}
    if "points" in p:
        T_cl, pos, lvalid = t("T_cl"), t("pos_in_win"), t("lvalid")
        if clusters is None:
            clusters = balm.build_clusters(t("points"), t("points_valid"),
                                           lie.se3_inverse(t("T0")[pos]) @ T_cl,
                                           voxel_size=1.0, max_voxels=256, min_points=15)
        kw["extra_fn"] = lambda T: local_mapping._balm_extra(T, clusters, pos, lvalid, T_cl,
                                                             p["w_lba"])
    return (cam, t("T0"), t("X0"), obs, t("fixed"), t("valid_lm")), kw


def ba_agreement(torch, got, ref) -> dict:
    """The largest differences of two ``BAResult``s: poses, landmarks (m),
    cost (relative); NaN positions must match."""
    def diff(a, b):
        a, b = a.double(), b.double()
        same_nan = bool(torch.equal(torch.isnan(a), torch.isnan(b)))
        d = (a - b).abs()
        d = torch.where(torch.isnan(a) & torch.isnan(b), torch.zeros_like(d), d)
        return float(d.max()) if same_nan and d.numel() else (0.0 if same_nan else float("inf"))
    c, cr = float(got.cost), float(ref.cost)
    cost = 0.0 if (c != c and cr != cr) else abs(c - cr) / max(abs(cr), 1e-12)
    return {"pose": diff(got.T_cw, ref.T_cw), "landmark": diff(got.X_w, ref.X_w), "cost": cost}


def ba_float64(torch, a, kw):
    """``lm.local_ba``'s arguments ``(a, kw)`` in float64 (an ``extra_fn``
    still evaluated in float32 at the rounded poses)."""
    from tc2li_slam_torch.solver import lm
    d = lambda x: x.double() if x.is_floating_point() else x
    cam, T0, X0, obs, fixed, vlm = a
    kw64 = dict(kw)
    if kw.get("extra_fn") is not None:
        kw64["extra_fn"] = lambda T, f=kw["extra_fn"]: tuple(x.double() for x in f(T.float()))
    return (cam, d(T0), d(X0), lm.BAObservations(*(d(x) for x in obs)), fixed, vlm), kw64


def ba_outside(torch, got, ref, ref64, pose_tol: float = 1e-4, lm_tol: float = 1e-3,
               cost_tol: float = 1e-4) -> dict:
    """Poses, landmarks and the cost of ``got`` (the kernel) against ``ref``
    (the plain version) within their tolerance, or else no farther from
    ``ref64`` (the plain version run in float64) than ``ref`` is: a window
    float32 cannot resolve to the tolerance is held to float32's own error.
    Returns the counts of each outside both, of each within only the second,
    and the largest distances."""
    def rows(x, n):
        return x.double().reshape(n, -1)
    out = {}
    for name, g, r, r64, tol in (("pose", got.T_cw, ref.T_cw, ref64.T_cw, pose_tol),
                                 ("landmark", got.X_w, ref.X_w, ref64.X_w, lm_tol),
                                 ("cost", got.cost, ref.cost, ref64.cost, None)):
        n = g.shape[0] if g.dim() else 1
        g, r, r64 = rows(g, n), rows(r, n), rows(r64, n)
        if tol is None:   # relative
            tol = cost_tol * r.abs().clamp(min=1e-12)
        else:
            tol = torch.full_like(r[:, :1], tol)
        both_nan = torch.isnan(g) & torch.isnan(r)
        d = torch.where(both_nan, torch.zeros_like(g), (g - r).abs()).amax(1)
        dg = torch.where(torch.isnan(g) & torch.isnan(r64), torch.zeros_like(g),
                         (g - r64).abs()).amax(1)
        dr = torch.where(torch.isnan(r) & torch.isnan(r64), torch.zeros_like(r),
                         (r - r64).abs()).amax(1)
        d = torch.where(torch.isnan(d), torch.full_like(d, float("inf")), d)
        within = d <= tol[:, 0]
        nearer = dg <= dr
        out[name] = {"outside": int((~within & ~nearer).sum()),
                     "nearer_float64": int((~within & nearer).sum()),
                     "max_vs_plain": float(d.max()) if d.numel() else 0.0,
                     "max_vs_float64": float(dg.max()) if dg.numel() else 0.0,
                     "plain_vs_float64": float(dr.max()) if dr.numel() else 0.0}
    return out


VI_CALIB = (1e-4, 1e-3, 1e-6, 1e-5)   # 4e's ImuConfig: gyro, acc noise; their walks
VI_GRAVITY = (0.0, 0.0, -9.81)


def _so3_np(w):
    import numpy as np
    th = np.linalg.norm(w)
    W = np.array([[0.0, -w[2], w[1]], [w[2], 0.0, -w[0]], [-w[1], w[0], 0.0]])
    if th < 1e-12:
        return np.eye(3) + W
    return np.eye(3) + np.sin(th) / th * W + (1.0 - np.cos(th)) / th ** 2 * W @ W


def vi_problem(rng, n: int = 2000, nf: int = 30, case: str = "full", n_imu: int = 20):
    """Inputs of the pose-inertial optimizers (numpy, from ``rng``): the
    KITTI-shaped camera, a body-from-camera extrinsic with a rotation, an
    IMU window of ``n_imu`` samples at 100 Hz (gyro and accelerometer with
    small biases, 4e's noise figures in ``VI_CALIB``) from the anchor's
    state, and ``n`` matched rows at the frame: 70% stereo, noise and
    ``inv_sigma2`` from 8 pyramid levels, 5% of them moved so that their chi2
    at the true state sits within 0.8-1.25 of the gate, 5% outliers of 20-50
    px, 3% masked. ``nf`` 15: the last-keyframe form (a fixed anchor); 30: the
    last-frame form (prev ~1 cm and ~0.1 degree off, a prior on it of
    pose-like information). The frame's initial state is ~5 cm, ~0.6 degrees
    and ~0.1 m/s off. Cases: ``full``; ``nothing_valid``; ``masked_nan`` (a
    masked row whose point is NaN); ``prior_off`` (the prior's weight 0);
    ``padded_imu`` (every third IMU slot padding, dt 0). Returns a dict of
    numpy arrays and host numbers."""
    import numpy as np
    from tc2li_slam_torch.io.synthetic import KITTI_LIKE as rig

    def se3(R, t):
        T = np.eye(4)
        T[:3, :3], T[:3, 3] = R, t
        return T

    def perturb(T, rot, trans):
        return T @ se3(_so3_np(rng.normal(0, rot, 3)), rng.normal(0, trans, 3))

    fx, fy, cx, cy, bf = rig.fx, rig.fy, rig.cx, rig.cy, rig.fx * rig.baseline
    g = np.asarray(VI_GRAVITY)
    T_bc = se3(np.array([[0.0, 0.0, 1.0], [-1.0, 0.0, 0.0], [0.0, -1.0, 0.0]])
               @ _so3_np(np.array([0.01, -0.02, 0.005])), np.array([0.2, 0.01, 0.1]))
    T_cb = np.linalg.inv(T_bc)
    # the IMU: a constant body rate and world acceleration from the anchor
    R1 = _so3_np(rng.normal(0, 0.3, 3))
    T1 = se3(R1, rng.normal(0, 2.0, 3))
    v1 = np.array([1.5, 0.1, 0.0]) + rng.normal(0, 0.1, 3)
    w_b = rng.normal(0, 0.05, 3)
    a_w = rng.normal(0, 0.3, 3)
    bg_t, ba_t = rng.normal(0, 2e-4, 3), rng.normal(0, 2e-3, 3)
    dt = 0.01
    t_all = dt * n_imu
    gyro = np.zeros((n_imu, 3))
    acc = np.zeros((n_imu, 3))
    dts = np.full(n_imu, dt)
    for k in range(n_imu):
        Rk = R1 @ _so3_np(w_b * dt * k)
        gyro[k] = w_b + bg_t + rng.normal(0, VI_CALIB[0], 3)
        acc[k] = Rk.T @ (a_w - g) + ba_t + rng.normal(0, VI_CALIB[1], 3)
    if case == "padded_imu":
        dts[::3] = 0.0
        gyro[::3], acc[::3] = 7.0, -3.0   # (what a padded slot holds does not matter)
        t_all = dt * int((dts > 0).sum())
    T2 = se3(R1 @ _so3_np(w_b * t_all), T1[:3, 3] + v1 * t_all + 0.5 * a_w * t_all ** 2)
    v2 = v1 + a_w * t_all
    # the rows, seen from the frame's true camera
    T_wc = T2 @ T_bc
    z = rng.uniform(4.0, 40.0, n)
    u, v = rng.uniform(0, rig.width, n), rng.uniform(0, rig.height, n)
    Xc = np.stack([(u - cx) / fx * z, (v - cy) / fy * z, z], -1)
    X = Xc @ T_wc[:3, :3].T + T_wc[:3, 3]
    level = rng.integers(0, 8, n)
    sig = 1.2 ** level
    uvr = np.stack([u, v, u - bf / z], -1) + rng.normal(0, 0.5, (n, 3)) * sig[:, None]
    stereo = rng.random(n) < 0.7
    uvr[~stereo, 2] = -1.0
    inv_s2 = 1.0 / sig ** 2
    gate = rng.random(n) < 0.05
    d = rng.normal(0, 1, (n, 3))
    d[~stereo, 2] = 0.0
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    thr = np.where(stereo, 7.815, 5.991)
    uvr[gate] = np.stack([u, v, np.where(stereo, u - bf / z, -1.0)], -1)[gate] + (
        d * (np.sqrt(thr * rng.uniform(0.8, 1.25, n) / inv_s2))[:, None])[gate]
    out = ~gate & (rng.random(n) < 0.05)
    uvr[out, :2] += d[out, :2] * rng.uniform(20.0, 50.0, (int(out.sum()), 1))
    valid = rng.random(n) >= 0.03
    if case == "nothing_valid":
        valid[:] = False
    if case == "masked_nan":
        valid[0] = False
        X[0] = np.nan
    f32 = lambda a: np.asarray(a, np.float32)

    def state(T, vel, bg, ba):
        return dict(T_wb=f32(T), vel=f32(vel), bg=f32(bg), ba=f32(ba))

    z3 = np.zeros(3)
    p = dict(cam=(fx, fy, cx, cy, bf), T_cb=f32(T_cb), gravity=f32(g), calib=VI_CALIB,
             gyro=f32(gyro), acc=f32(acc), dts=f32(dts), nf=nf,
             state0=state(perturb(T2, 0.01, 0.05), v2 + rng.normal(0, 0.1, 3), z3, z3),
             X=f32(X), uvr=f32(uvr), inv_s2=f32(inv_s2), stereo=stereo, valid=valid)
    if nf == 15:
        p["anchor"] = state(T1, v1, z3, z3)
    else:
        p["anchor"] = state(perturb(T1, 0.002, 0.01), v1 + rng.normal(0, 0.02, 3), z3, z3)
        A = rng.normal(0, 1, (15, 15))
        info = np.concatenate([np.full(6, 1e4), np.full(3, 1e3), np.full(3, 1e8),
                               np.full(3, 1e5)])
        H = np.sqrt(info)[:, None] * (np.eye(15) + 0.3 * A @ A.T / 15) * np.sqrt(info)[None]
        p["prior"] = dict(state=state(T1, v1, z3, z3), H=f32(H),
                          weight=f32(0.0 if case == "prior_off" else 1.0))
    return p


def _vi_cast(torch, x, dtype):
    """A tensor, or a NamedTuple (or tuple) of them, with every float tensor
    cast to ``dtype``."""
    if isinstance(x, tuple):
        parts = (_vi_cast(torch, a, dtype) for a in x)
        return type(x)(*parts) if hasattr(x, "_fields") else tuple(parts)
    return x.to(dtype) if torch.is_tensor(x) and x.is_floating_point() else x


def vi_args(torch, p, dev, dtype=None):
    """The optimizer's arguments for ``vi_problem``'s ``p`` on ``dev``: the
    preintegration by ``estimation.imu.integrate`` on ``dev`` (the kernel on
    the card), then the covariance floor and the random-walk information as
    ``System._vi_frame_refine`` forms them. With ``dtype`` (float64) every
    float tensor is cast after that, the same inputs in another type.
    Returns (function name, positional arguments)."""
    from tc2li_slam_torch.estimation import imu
    from tc2li_slam_torch.geom import camera as cam_mod
    from tc2li_slam_torch.slam import imu_mode
    from tc2li_slam_torch.solver import pose_inertial as pi
    up = lambda a: torch.as_tensor(a).to(dev)
    cal = imu.ImuCalib.create(*p["calib"], device=dev)
    z3 = torch.zeros(3, device=dev)
    st = lambda d: pi.FrameVIState(*(up(d[k]) for k in ("T_wb", "vel", "bg", "ba")))
    anchor = st(p["anchor"])
    pre = imu.integrate(cal, up(p["gyro"]), up(p["acc"]), up(p["dts"]), z3, z3)
    C = pre.C.clone()
    C[:9, :9] = imu_mode.floor_cov9(pre.C[:9, :9])
    pre = pre._replace(C=C)
    dt_c = torch.clamp(pre.dt, min=1e-3)
    info_bg = 1.0 / (cal.sigma_gw ** 2 * dt_c)
    info_ba = 1.0 / (cal.sigma_aw ** 2 * dt_c)
    tree = (lambda x: x) if dtype is None else (lambda x: _vi_cast(torch, x, dtype))

    cam = cam_mod.Pinhole.create(*p["cam"])
    rows = (up(p["X"]), up(p["uvr"]), up(p["inv_s2"]), up(p["stereo"]), up(p["valid"]),
            info_bg, info_ba)
    head = (cam, up(p["T_cb"]), st(p["state0"]), anchor)
    if p["nf"] == 15:
        return "optimize_last_kf", tree(head + (pre, up(p["gravity"])) + rows)
    pr = p["prior"]
    prior = pi.FramePrior(st(pr["state"]), up(pr["H"]), up(pr["weight"]))
    return "optimize_last_frame", tree(head + (prior, pre, up(p["gravity"])) + rows)


def diag_scale(torch, M):
    """sqrt(|M_ii M_jj|) of a square matrix (float64, on the CPU): a
    difference of information or covariance matrices divided by it is
    D^-1/2 (A - B) D^-1/2 with D = diag(M), each entry against the scale of
    its own two variables. A diagonal entry that is NaN or 0 (a frame whose
    rows' sums are NaN) counts as the largest finite entry of its row (and
    at least 1e-30)."""
    M = M.detach().double().cpu().abs()
    dg = M.diagonal().nan_to_num(0.0)
    dg = torch.where(dg > 0, dg, M.nan_to_num(0.0, 0.0, 0.0).amax(1)).clamp(min=1e-30)
    return torch.sqrt(dg[:, None] * dg[None, :])


def vi_agreement(torch, args, got, ref, ref64=None) -> dict:
    """How two ``PoseInertialResult``s on the same arguments agree: the
    largest difference of T_wb, vel, bg and ba, of the next prior's H after
    diagonal scaling (``diag_scale`` of ``ref64``'s H, or ``ref``'s), and of
    the cost relative; the inlier
    flags that differ (``flips``) and of them those at a gate (their chi2,
    re-derived in float64 at either state, within 1e-3 relative of its
    threshold or on both sides of it, or their depth so at 0.05). With
    ``ref64`` (the plain version run in float64), ``outside`` lists the
    quantities beyond the tolerances of ``VI_TOL`` that are also farther
    from ``ref64`` than ``ref`` is (the rule of ``ba_outside``)."""
    import numpy as np
    cam, T_cb = args[0], args[1]
    X, uvr, s2, st = (np.asarray(a.detach().cpu(), np.float64) for a in args[-7:-3])
    st = st.astype(bool)
    thr = np.where(st, 7.815, 5.991)
    Tcb = np.asarray(T_cb.detach().cpu(), np.float64)

    def gates(T_wb):
        T = np.linalg.inv(np.asarray(T_wb.detach().cpu(), np.float64))
        Xc = (X @ T[:3, :3].T + T[:3, 3]) @ Tcb[:3, :3].T + Tcb[:3, 3]
        zz = np.where(np.abs(Xc[:, 2]) < 1e-9, 1e-9, Xc[:, 2])
        u = cam.fx * Xc[:, 0] / zz + cam.cx
        r = np.stack([u - uvr[:, 0], cam.fy * Xc[:, 1] / zz + cam.cy - uvr[:, 1],
                      np.where(st, u - cam.bf / zz - uvr[:, 2], 0.0)], -1)
        return s2 * np.sum(r * r, -1), Xc[:, 2]

    with np.errstate(invalid="ignore", over="ignore"):
        (c1, z1), (c2, z2) = gates(got.state.T_wb), gates(ref.state.T_wb)
        near = ((np.minimum(np.abs(c1 - thr), np.abs(c2 - thr)) <= 1e-3 * thr)
                | ((c1 - thr) * (c2 - thr) <= 0)
                | (np.minimum(np.abs(z1 - 0.05), np.abs(z2 - 0.05)) <= 5e-5)
                | ((z1 - 0.05) * (z2 - 0.05) <= 0))
    flips = np.asarray((got.inliers.cpu() != ref.inliers.cpu()))

    def quantities(r):
        return {"T_wb": r.state.T_wb, "vel": r.state.vel, "bg": r.state.bg, "ba": r.state.ba,
                "H": r.prior.H, "cost": r.cost}

    h_scale = diag_scale(torch, (ref if ref64 is None else ref64).prior.H)

    def dist(a, b, key):
        a, b = a.detach().double().cpu(), b.detach().double().cpu()
        d = torch.where(torch.isnan(a) & torch.isnan(b), torch.zeros_like(a), (a - b).abs())
        if key == "H":
            d = d / h_scale
        d = float(d.max()) if d.numel() else 0.0
        if key == "cost":   # relative (a cost below 1: absolute)
            d /= max(float(b.abs().nan_to_num(0.0).max()), 1.0)
        return d if d == d else float("inf")

    qg, qr = quantities(got), quantities(ref)
    out = {k: dist(qg[k], qr[k], k) for k in qg}
    out.update(flips=int(flips.sum()), near=int((flips & near).sum()),
               n_inliers=(int(got.n_inliers), int(ref.n_inliers)))
    if ref64 is not None:
        q64 = quantities(ref64)
        out["outside"] = [k for k, tol in VI_TOL.items()
                          if out[k] > tol and dist(qg[k], q64[k], k) > dist(qr[k], q64[k], k)]
    return out


# the tolerances of the pose-inertial kernel against its plain version: the
# state, the next prior's H (diagonally scaled: ``diag_scale``), the cost
# (relative, absolute below 1)
VI_TOL = {"T_wb": 1e-4, "vel": 1e-4, "bg": 1e-5, "ba": 1e-4, "H": 1e-3, "cost": 1e-3}


def imu_distance(torch, field, a, ref) -> float:
    """The largest difference of one ``Preintegrated`` output ``field`` from
    ``ref``: the covariance C diagonally scaled (``diag_scale`` of ``ref``,
    so the walk block and C9's rotation block are held to their own scale),
    any other output over its largest entry."""
    a, ref = a.detach().double().cpu(), ref.detach().double().cpu()
    d = (a - ref).abs()
    if field == "C":
        return float((d / diag_scale(torch, ref)).max())
    return float(d.max()) / max(float(ref.abs().max()), 1e-30) if d.numel() else 0.0


LVI_CASES = ("4e-like", "full_inertial", "padded", "non-finite")
LVI_KERNELS = ("init_kernel", "build_kernel", "reduce_kernel", "solve_kernel", "eval_kernel",
               "commit_kernel")   # csrc/lvi_ba.cu
# the LVI-BA kernel against its plain version (vi_agreement's rule): the
# states as VI_TOL, landmarks to 1e-3 m (ba_outside's), the cost relative
LVI_TOL = {"T_wb": 1e-4, "vel": 1e-4, "bg": 1e-5, "ba": 1e-4, "X_w": 1e-3, "cost": 1e-3}
# float64 operations of csrc/lvi_ba.cu beyond the window BA's: a factor's
# residual chain (~1,000), J1 and J2 (~2,700), I J1, I J2 (~2,500), its
# three 15x15 blocks (~6,100) and gradients, a block a factor a pass
LVI_OPS_FACTOR = 12_000


def lvi_problem(rng, case: str = "4e-like", P: int | None = None, L: int = 2000, K: int = 8):
    """Inputs of the LVI-BA (numpy, from ``rng``): P keyframe body states of
    a KITTI-like rig (camera looking along body x, ``vi_problem``'s
    extrinsic) moving at ~1.5 m/s with a slow turn, their IMU windows at
    100 Hz with small biases (4e's noise figures in ``VI_CALIB``), preintegrated
    by the port's plain ``estimation.imu.integrate`` on the host with
    ``slam.imu_mode``'s covariance floor; L landmarks ahead, each seen from K
    consecutive states (70% stereo, 8 pyramid levels, 0.5 px of noise at
    level 0, 3% outliers of 20-50 px, 3% masked, out-of-image rows masked). The initial state: the first
    fixed and true, the others ~0.6 degrees, ~5 cm and ~0.1 m/s off, biases
    0; landmarks ~5 cm off. Cases: ``4e-like`` (P 6, the BALM term over the
    first 4 states: 3,000 points a LiDAR keyframe on three planes, 6
    iterations), ``full_inertial`` (P 20, no BALM, 10 iterations: the
    FullInertialBA's shape), ``padded`` (P 6, the last two slots padding as
    ``System._run_lvi_ba`` pads: fixed identity states, no observation, the
    store's empty factors, invalid), ``non-finite`` (P 6, a landmark NaN
    with valid observations). Returns a dict of numpy arrays and numbers."""
    import numpy as np
    import torch

    from tc2li_slam_torch.estimation import imu
    from tc2li_slam_torch.io.synthetic import KITTI_LIKE as rig
    from tc2li_slam_torch.slam import imu_mode

    P = P or (20 if case == "full_inertial" else 6)
    dt_kf = 0.4   # s between keyframes
    pad = 2 if case == "padded" else 0
    n_lidar = min(4, P) if case == "4e-like" else 0
    iters = 10 if case == "full_inertial" else 6

    def se3(R, t):
        T = np.eye(4)
        T[:3, :3], T[:3, 3] = R, t
        return T

    fx, fy, cx, cy, bf = rig.fx, rig.fy, rig.cx, rig.cy, rig.fx * rig.baseline
    g = np.asarray(VI_GRAVITY)
    T_bc = se3(np.array([[0.0, 0.0, 1.0], [-1.0, 0.0, 0.0], [0.0, -1.0, 0.0]])
               @ _so3_np(np.array([0.01, -0.02, 0.005])), np.array([0.2, 0.01, 0.1]))
    R0 = _so3_np(rng.normal(0, 0.02, 3))
    w_b = np.array([0.0, 0.0, 0.03]) + rng.normal(0, 0.01, 3)
    v0 = np.array([1.5, 0.1, 0.0]) + rng.normal(0, 0.1, 3)
    a_w = rng.normal(0, 0.1, 3)
    bg_t, ba_t = rng.normal(0, 2e-4, 3), rng.normal(0, 2e-3, 3)
    dt, n_sub = 0.01, int(round(dt_kf / 0.01))
    pose = lambda t: se3(R0 @ _so3_np(w_b * t), v0 * t + 0.5 * a_w * t * t)
    T_gt = np.stack([pose(i * dt_kf) for i in range(P)])
    v_gt = np.stack([v0 + a_w * i * dt_kf for i in range(P)])
    cal = imu.ImuCalib.create(*VI_CALIB)
    keys = ("dR", "dV", "dP", "JRg", "JVg", "JVa", "JPg", "JPa", "dt")
    fac = {k: [] for k in keys + ("C_inv",)}
    for i in range(P - 1):
        t0 = i * dt_kf
        gyro = np.stack([w_b + bg_t + rng.normal(0, VI_CALIB[0], 3) for _ in range(n_sub)])
        acc = np.stack([pose(t0 + k * dt)[:3, :3].T @ (a_w - g) + ba_t
                        + rng.normal(0, VI_CALIB[1], 3) for k in range(n_sub)])
        t = lambda a: torch.as_tensor(np.asarray(a, np.float32))
        pre = imu.integrate(cal, t(gyro), t(acc), t(np.full(n_sub, dt)), t(np.zeros(3)),
                            t(np.zeros(3)))
        for k in keys:
            fac[k].append(np.asarray(getattr(pre, k)))
        fac["C_inv"].append(np.asarray(torch.linalg.inv(imu_mode.floor_cov9(pre.C[:9, :9]))))
    shapes = {"dV": (3,), "dP": (3,), "dt": (), "C_inv": (9, 9)}
    fac = {k: np.stack(v).astype(np.float32) if v else np.zeros((0,) + shapes.get(k, (3, 3)),
                                                                np.float32)
           for k, v in fac.items()}
    F = P - 1
    fac.update(bg_lin=np.zeros((F, 3), np.float32), ba_lin=np.zeros((F, 3), np.float32),
               info_bg=np.full(F, 1e5, np.float32), info_ba=np.full(F, 1e4, np.float32),
               valid=np.ones(F, bool))
    # landmarks ahead of the path, each seen from K consecutive states
    X = np.stack([rng.uniform(6, 60, L) + v0[0] * dt_kf * P * 0.5, rng.uniform(-15, 15, L),
                  rng.uniform(-2, 6, L)], -1)
    Kp = min(K, P - pad)
    first = rng.integers(0, P - pad - Kp + 1, L)
    pose_idx = np.full((L, K), 0, np.int32)
    valid = np.zeros((L, K), bool)
    uvr = np.zeros((L, K, 3))
    level = rng.integers(0, 8, (L, K))
    sig = 1.2 ** level
    stereo = rng.random((L, K)) < 0.7
    for k in range(Kp):
        pi = first + k
        pose_idx[:, k] = pi
        T_cw = np.linalg.inv(T_gt[pi] @ T_bc)
        Xc = np.einsum("lij,lj->li", T_cw[:, :3, :3], X) + T_cw[:, :3, 3]
        z = Xc[:, 2]
        zs = np.where(np.abs(z) < 1e-9, 1e-9, z)
        u, v = fx * Xc[:, 0] / zs + cx, fy * Xc[:, 1] / zs + cy
        uvr[:, k] = (np.stack([u, v, u - bf / zs], -1)
                     + rng.normal(0, 0.5, (L, 3)) * sig[:, k, None])
        valid[:, k] = (z > 0.5) & (u > 0) & (u < rig.width) & (v > 0) & (v < rig.height)
    out = rng.random((L, K)) < 0.03
    uvr[out, :2] += rng.normal(0, 1, (int(out.sum()), 2)) * rng.uniform(20, 50, (int(out.sum()), 1))
    uvr[..., 2] = np.where(stereo, uvr[..., 2], -1.0)
    valid &= rng.random((L, K)) >= 0.03
    # the initial state
    T0 = T_gt.copy()
    v_0 = v_gt.copy()
    for i in range(1, P):
        T0[i] = T0[i] @ se3(_so3_np(rng.normal(0, 0.01, 3)), rng.normal(0, 0.05, 3))
        v_0[i] += rng.normal(0, 0.1, 3)
    X0 = X + rng.normal(0, 0.05, X.shape)
    fixed = np.zeros(P, bool)
    fixed[0] = True
    if pad:
        fixed[P - pad:] = True
        T0[P - pad:] = np.eye(4)
        v_0[P - pad:] = 0.0
        valid &= pose_idx < P - pad
        for k in keys + ("C_inv",):   # the store's row of a keyframe without a factor
            fac[k][P - pad - 1:] = np.eye(3) if k == "dR" else 0.0
        fac["valid"][P - pad - 1:] = False
    if case == "non-finite":
        X0[0] = np.nan
        valid[0, :Kp] = True
    f32 = lambda a: np.asarray(a, np.float32)
    p = dict(cam=(fx, fy, cx, cy, bf), T_cb=f32(np.linalg.inv(T_bc)), gravity=f32(g),
             T_wb=f32(T0), vel=f32(v_0), bg=np.zeros((P, 3), np.float32),
             ba=np.zeros((P, 3), np.float32), X0=f32(X0), pose_idx=pose_idx, uv=f32(uvr),
             inv_sigma2=f32(1.0 / sig ** 2), stereo=stereo, valid=valid, fixed=fixed,
             valid_lm=np.ones(L, bool), fac=fac, iters=iters, n_lidar=n_lidar,
             T_gt=f32(T_gt))
    if n_lidar:
        T_bl = se3(_so3_np(np.array([0.0, 0.01, -0.01])), np.array([0.3, 0.0, 0.5]))
        pts, pvalid = [], []
        for i in range(n_lidar):
            M = 3000
            a_, b_ = rng.uniform(-3, 12, M), rng.uniform(-6, 6, M)
            face = rng.integers(0, 3, M)
            pw = np.stack([a_, b_, np.full(M, -1.7)], 1)
            pw[face == 1] = np.stack([a_, np.full(M, 8.0), rng.uniform(-1.7, 4, M)], 1)[face == 1]
            pw[face == 2] = np.stack([a_, np.full(M, -8.0), rng.uniform(-1.7, 4, M)], 1)[face == 2]
            T_lw = np.linalg.inv(T_gt[i] @ T_bl)
            pts.append(pw @ T_lw[:3, :3].T + T_lw[:3, 3] + rng.normal(0, 0.01, pw.shape))
            pvalid.append(rng.random(M) > 0.05)
        p.update(T_bl=f32(T_bl), points=f32(np.stack(pts)), pvalid=np.stack(pvalid))
    return p


def lvi_args(torch, p, dev, dtype=None):
    """``solver.inertial_ba.lvi_ba``'s arguments ``(a, kw)`` for
    ``lvi_problem``'s ``p`` on ``dev``; the BALM clusters built by
    ``solver.balm.build_clusters`` on ``dev`` at the initial LiDAR poses, as
    ``System._run_lvi_ba`` builds them (1 m voxels, 512 slots). With
    ``dtype`` every float tensor is cast after that."""
    from tc2li_slam_torch.geom import camera as cam_mod
    from tc2li_slam_torch.solver import balm as balm_mod, inertial_ba as iba, lm

    up = lambda a: torch.as_tensor(a).to(dev)
    fac = iba.ImuWindowFactors(*(up(p["fac"][k]) for k in iba.ImuWindowFactors._fields))
    state0 = iba.InertialState(*(up(p[k]) for k in ("T_wb", "vel", "bg", "ba")))
    obs = lm.BAObservations(*(up(p[k]) for k in ("pose_idx", "uv", "inv_sigma2", "stereo",
                                                  "valid")))
    a = (cam_mod.Pinhole.create(*p["cam"]), up(p["T_cb"]), state0, up(p["X0"]), obs, fac,
         up(p["fixed"]), up(p["valid_lm"]), up(p["gravity"]))
    kw = dict(iters=p["iters"])
    if p["n_lidar"]:
        n = p["n_lidar"]
        T_bl = up(p["T_bl"])
        clusters = balm_mod.build_clusters(up(p["points"]), up(p["pvalid"]),
                                           state0.T_wb[:n] @ T_bl, voxel_size=1.0,
                                           max_voxels=512, min_points=15)
        kw.update(balm_clusters=clusters, T_bl=T_bl, w_lidar=0.01, use_balm=True, n_lidar=n)
    if dtype is not None:
        a, kw = _vi_cast(torch, a, dtype), {k: _vi_cast(torch, v, dtype) for k, v in kw.items()}
    return a, kw


def lvi_cpu64(torch, a, kw):
    """``lvi_ba``'s arguments ``(a, kw)`` on the CPU in float64: the plain
    version's float64 run (the reference the kernel's float64 sums are held
    to)."""
    def cpu(x):
        if isinstance(x, tuple):
            parts = (cpu(v) for v in x)
            return type(x)(*parts) if hasattr(x, "_fields") else tuple(parts)
        return x.cpu() if torch.is_tensor(x) else x
    return (_vi_cast(torch, cpu(a), torch.float64),
            {k: _vi_cast(torch, cpu(v), torch.float64) for k, v in kw.items()})


def lvi_agreement(torch, a, got, ref, ref64=None) -> dict:
    """How two ``LviBaResult``s on the arguments ``a`` agree
    (``vi_agreement``'s rule): the largest difference of T_wb, vel, bg, ba,
    the landmarks and the cost (relative, absolute below 1); the inlier
    flags that differ (``flips``) and of them those at a gate (``near``:
    their chi2, re-derived in float64 at either result, within 1e-3
    relative of its threshold or on both sides of it, or their depth so at
    0.05). With ``ref64`` (the plain version run in float64), ``outside``
    lists the quantities beyond ``LVI_TOL`` that are also farther from
    ``ref64`` than ``ref`` is."""
    import numpy as np
    cam, T_cb, obs = a[0], a[1], a[4]
    P = got.state.T_wb.shape[0]
    L, K = obs.pose_idx.shape
    host = lambda x: np.asarray(x.detach().cpu(), np.float64)
    pidx = np.clip(np.asarray(obs.pose_idx.cpu()), 0, P - 1).reshape(-1)
    uvr, s2 = host(obs.uv).reshape(-1, 3), host(obs.inv_sigma2).reshape(-1)
    st = np.asarray(obs.stereo.cpu()).reshape(-1).astype(bool)
    thr = np.where(st, 7.815, 5.991)
    Tcb = host(T_cb)

    def gates(r):
        T = np.linalg.inv(host(r.state.T_wb))[pidx]
        X = np.repeat(host(r.X_w), K, axis=0)
        Xb = np.einsum("oij,oj->oi", T[:, :3, :3], X) + T[:, :3, 3]
        Xc = Xb @ Tcb[:3, :3].T + Tcb[:3, 3]
        zz = np.where(np.abs(Xc[:, 2]) < 1e-9, 1e-9, Xc[:, 2])
        u = cam.fx * Xc[:, 0] / zz + cam.cx
        res = np.stack([u - uvr[:, 0], cam.fy * Xc[:, 1] / zz + cam.cy - uvr[:, 1],
                        np.where(st, u - cam.bf / zz - uvr[:, 2], 0.0)], -1)
        return s2 * np.sum(res * res, -1), Xc[:, 2]

    with np.errstate(invalid="ignore", over="ignore"):
        (c1, z1), (c2, z2) = gates(got), gates(ref)
        near = ((np.minimum(np.abs(c1 - thr), np.abs(c2 - thr)) <= 1e-3 * thr)
                | ((c1 - thr) * (c2 - thr) <= 0)
                | (np.minimum(np.abs(z1 - 0.05), np.abs(z2 - 0.05)) <= 5e-5)
                | ((z1 - 0.05) * (z2 - 0.05) <= 0))
    flips = np.asarray((got.obs_inlier.cpu() != ref.obs_inlier.cpu())).reshape(-1)

    def quantities(r):
        return {"T_wb": r.state.T_wb, "vel": r.state.vel, "bg": r.state.bg, "ba": r.state.ba,
                "X_w": r.X_w, "cost": r.cost}

    def dist(a, b, key):
        a, b = a.detach().double().cpu(), b.detach().double().cpu()
        d = torch.where(torch.isnan(a) & torch.isnan(b), torch.zeros_like(a), (a - b).abs())
        d = float(d.max()) if d.numel() else 0.0
        if key == "cost":
            d /= max(float(b.abs().nan_to_num(0.0).max()), 1.0)
        return d if d == d else float("inf")

    qg, qr = quantities(got), quantities(ref)
    out = {k: dist(qg[k], qr[k], k) for k in qg}
    out.update(flips=int(flips.sum()), near=int((flips & near).sum()))
    out["n_inliers"] = (int(got.obs_inlier.sum()), int(ref.obs_inlier.sum()))
    if ref64 is not None:
        q64 = quantities(ref64)
        out["vs_float64"] = {k: (dist(qg[k], q64[k], k), dist(qr[k], q64[k], k)) for k in qg}
        out["outside"] = [k for k, tol in LVI_TOL.items()
                          if out[k] > tol and out["vs_float64"][k][0] > out["vs_float64"][k][1]]
    return out


def lvi_bound(torch, a, kw) -> tuple:
    """(least ms on the card, what bounds it) of one ``lvi_ba_lm`` call on
    ``(a, kw)``: bytes read and written once (the observation table, the
    landmarks, the states, the factors, the BALM term); float32 operations a
    live observation an iteration (the window BA's) at the float32 rate and
    float64 ones at the float64 rate: the pairs of the reduced system, each
    landmark's inverse, the factors, the dense solve of the free rows."""
    from tc2li_slam_torch.solver import inertial_ba as iba

    cam, T_cb, s0, X0, obs, fac, fixed, vlm, grav = a
    P, (L, K), it = s0.T_wb.shape[0], obs.pose_idx.shape, kw["iters"]
    r, _, _, w, _ = iba._visual_residuals(cam, T_cb, s0, X0, obs)
    live = (w != 0).reshape(L, K).cpu()
    on_free = ~fixed.cpu()[obs.pose_idx.long().cpu().clamp(0, P - 1)]
    n_live = int(live.sum())
    n_pairs = int((((live & on_free).sum(1) ** 2) * vlm.cpu()).sum())
    Df = 15 * int((~fixed).sum())
    nl = kw.get("n_lidar", 0) if kw.get("use_balm") else 0
    n_bytes = (4 * 25 * P * 2 + L * (13 + 12) + 22 * L * K + K * L + 4 * 151 * (P - 1) + 64 + 12
               + (4 * 36 * nl * nl + 24 * nl + 4 if nl else 0))
    t_b = n_bytes / PEAK_BYTES_S
    f64 = it * (LBA_OPS_PAIR * n_pairs + LBA_OPS_LANDMARK * L + LVI_OPS_FACTOR * (P - 1)
                + Df ** 3 / 3 + 2 * Df ** 2)
    t_o = it * LBA_OPS_LIVE * n_live / PEAK_SIMPLE_S + f64 / PEAK_F64_S
    return (1e3 * max(t_b, t_o), "bytes" if t_b >= t_o else "operations"), n_live, n_pairs, Df


def lvi_phase(torch, dev, cases, log=print, sync=lambda: None, timer=None, split=None) -> dict:
    """Phase 5, the LVI-BA kernel against its plain version on ``dev``
    through the dispatcher a user calls (``solver.inertial_ba.lvi_ba``):
    ``cases`` lists ``(label, a, kw)``; each is held to ``LVI_TOL`` or else
    no farther from the plain version run in float64 on the CPU, the inlier
    flags equal but at a gate (``lvi_agreement``'s ``near``), the same
    bits on a second call, no host sync; a non-finite case returns its entry
    state. ``timer(fn, reps) -> ms`` times a call behind a device backlog for
    the first two cases (none: not taken), ``split(fn) -> {kernel: ...}``
    splits them by kernel name (the kernels' device ms: the six of
    ``csrc/lvi_ba.cu``). Returns the kernel's row; raises RuntimeError where
    a check fails."""
    from tc2li_slam_torch.ops.kernels import lvi_ba as klvi
    from tc2li_slam_torch.solver import inertial_ba as iba

    timer = timer or (lambda fn, reps: float("nan"))
    row, err = None, 0.0
    for n, (label, a, kw) in enumerate(cases):
        got, again = iba.lvi_ba(*a, **kw), iba.lvi_ba(*a, **kw)
        ref = klvi.lvi_ba_plain(*a, **kw)
        ref64 = klvi.lvi_ba_plain(*lvi_cpu64(torch, a, kw)[0], **lvi_cpu64(torch, a, kw)[1])
        sync()
        agr = lvi_agreement(torch, a, got, ref, ref64)
        twice = bit_equal(torch, [got.state.T_wb, got.state.vel, got.state.bg, got.state.ba,
                                  got.X_w, got.cost, got.obs_inlier],
                          [again.state.T_wb, again.state.vel, again.state.bg, again.state.ba,
                           again.X_w, again.cost, again.obs_inlier])
        P, (L, K) = a[2].T_wb.shape[0], a[4].pose_idx.shape
        log(f"lvi_ba_lm {label} (P {P}, L {L}, K {K}, {kw['iters']} iterations, BALM "
            f"{bool(kw.get('use_balm'))}, {int(a[6].sum())} fixed): cost {float(got.cost):.6f} / "
            f"plain {float(ref.cost):.6f} / plain in float64 {float(ref64.cost):.6f}; "
            + ", ".join(f"{k} {v:.2e}" for k, v in agr.items() if isinstance(v, float))
            + f"; inliers {agr['n_inliers']}, flags that differ {agr['flips']}, of which at a "
            f"gate {agr['near']}; |kernel - "
            f"float64|, |plain - float64| "
            + ", ".join(f"{k} {v[0]:.2e} / {v[1]:.2e}" for k, v in agr["vs_float64"].items())
            + f"; beyond tolerance and farther from float64 than the plain version "
            f"{agr['outside']}; the same bits on a second call {twice}")
        if agr["outside"] or agr["flips"] != agr["near"] or not twice:
            raise RuntimeError(f"lvi_ba_lm disagrees with its plain version on {label}: {agr}, "
                               f"the same bits twice {twice}")
        if "non-finite" in label and not (torch.equal(got.state.T_wb, a[2].T_wb)
                                           and torch.equal(got.state.vel, a[2].vel)
                                           and torch.equal(got.X_w[1:], a[3][1:])):
            raise RuntimeError(f"lvi_ba_lm on {label}: the state moved")
        fixed = a[6]
        if not torch.equal(got.state.T_wb[fixed], a[2].T_wb[fixed]):
            raise RuntimeError(f"lvi_ba_lm on {label}: a fixed state moved")
        err = max(err, agr["T_wb"])
        if n < 2:
            # the call enqueues ~100 tensor ops around its launches: its host
            # time outlasts a backlog, so the kernels' device ms come from the
            # profiler (the six of csrc/lvi_ba.cu, and the whole call's)
            call_ms = timer(lambda: iba.lvi_ba(*a, **kw), 20)
            ms_p = timer(lambda: klvi.lvi_ba_plain(*a, **kw), 3)
            b, n_live, n_pairs, Df = lvi_bound(torch, a, kw)
            parts = split(lambda: iba.lvi_ba(*a, **kw)) if split else {}
            ms_k = sum(v["ms_a_call"] for k, v in parts.items() if k in LVI_KERNELS) \
                if parts else call_ms
            dev_ms = sum(v["ms_a_call"] for v in parts.values()) if parts else call_ms
            log(f"lvi_ba_lm {label}: {klvi.launches_per_call(kw['iters'])} launches, "
                f"{n_live} observations of non-zero weight, {n_pairs} pairs, {Df} free rows: "
                f"kernels {ms_k:.4f} ms on the device (torch.profiler), the whole call "
                f"{dev_ms:.4f} device ms and {call_ms:.4f} ms a call behind a backlog, bound "
                f"{b[0]:.6f} ms ({b[1]}), plain {ms_p:.4f} ms"
                + ("; device ms a call by kernel (torch.profiler): "
                   + ", ".join(f"{k} {v['ms_a_call']:.4f} ({v['launches_a_call']:g})"
                               for k, v in parts.items()) if parts else ""))
            if n == 0:
                row = dict(source="tc2li_slam_torch/csrc/lvi_ba.cu",
                           replaces="tc2li_slam_tpu/solver/inertial_ba.py:191", ms=ms_k,
                           call_ms=dev_ms, plain_ms=ms_p, bound_ms=b[0], bound_by=b[1],
                           library_ms=None)
    n_sync = [syncs_of(torch, lambda: iba.lvi_ba(*a, **kw)) for _, a, kw in cases]
    log(f"lvi_ba_lm: host syncs in a call {n_sync}")
    if any(n_sync):
        raise RuntimeError(f"lvi_ba_lm synchronised the host in a call: {n_sync}")
    row["max_abs_err"] = err
    return {"lvi_ba_lm": row}


INIT_CASES = ("free gravity and scale", "free gravity", "4e-like padded", "non-finite valid",
              "non-finite invalid")
# the visual-inertial initialization's kernel against its plain version
# (vi_agreement's rule; tests/test_torch_inertial.py's tolerances): R_wg,
# the scale, the biases, the velocities, the cost (relative, absolute below 1)
INIT_TOL = {"R_wg": 1e-5, "scale": 2e-3, "bg": 1e-6, "ba": 1e-4, "vel": 1e-4, "cost": 1e-3}
# float64 operations of one iteration of csrc/inertial_init.cu a factor, a
# fused multiply-add counted as one (as PEAK_F64_S): its residual at x and
# at the candidate (INIT_OPS_RESIDUAL each: the bias correction 45, the three
# 3x3 products 81, exp and log ~50, ev and ep ~51, the whitening's upper
# triangle 45, the validity and the squares 18), its whitened 9 x 15
# Jacobian in closed form (~800: ~220 for the columns, ~580 for L^T on
# them), the upper triangle of its symmetric 15 x 15 block (120 x 9) and
# its gradient (15 x 9)
INIT_OPS_RESIDUAL = 290
INIT_OPS_FACTOR = 2 * INIT_OPS_RESIDUAL + 800 + 120 * 9 + 15 * 9


def init_problem(rng, case: str = "free gravity and scale", K: int = 20,
                 n_real: int | None = None):
    """Inputs of the visual-inertial initialization (numpy, from ``rng``):
    ``n_real`` keyframe body states 0.4 s apart on a slow turn with a small
    acceleration (``tests/test_inertial_init.simulate``'s kind: gravity ~3
    degrees off -z, biases of a few mrad/s and cm/s^2), their IMU windows at
    100 Hz with 4e's noise figures (``VI_CALIB``), preintegrated at zero
    biases by the port's plain ``estimation.imu.integrate`` on the host
    with ``slam.imu_mode``'s covariance floor; padded to K slots as
    ``System._initialize_imu`` pads (the last keyframe repeated, each padded
    factor the last real one's, invalid). R_wg0 is the bootstrap
    ``estimate_gravity_direction`` where gravity is free, the true gravity
    (the filter's) where it is fixed; vel0 the true velocities 0.3 m/s off.
    Cases (``INIT_CASES``): ``free gravity and scale`` (20 real keyframes,
    the first rung's priors, 8 iterations), ``free gravity`` (20 real, the
    initialization's priors and fixed scale, 20 iterations), ``4e-like
    padded`` (6 real, fixed gravity and scale), ``non-finite valid`` (the
    former with a NaN in a valid factor's dV), ``non-finite invalid`` (a
    NaN in a padded factor's dP). Returns a dict: the arrays of
    ``inertial_optimization``'s positional arguments and its keywords."""
    import numpy as np
    import torch

    from tc2li_slam_torch.estimation import imu
    from tc2li_slam_torch.slam import imu_mode
    from tc2li_slam_torch.solver import inertial_init

    padded = case in ("4e-like padded", "non-finite invalid")
    n_real = n_real or (6 if padded else K)
    dt_kf, dt = 0.4, 0.01
    n_sub = int(round(dt_kf / dt))
    g_w = np.array([0.05, -0.02, -1.0])
    g_w *= 9.81 / np.linalg.norm(g_w)
    R0 = _so3_np(rng.normal(0, 0.05, 3))
    w_b = np.array([0.0, 0.0, 0.12]) + rng.normal(0, 0.02, 3)
    v0 = np.array([1.2, 0.3, 0.05]) + rng.normal(0, 0.1, 3)
    a_w = rng.normal(0, 0.3, 3)
    bg_t = np.array([0.004, -0.002, 0.003])
    ba_t = np.array([0.05, -0.03, 0.08])
    rot = lambda t: R0 @ _so3_np(w_b * t)
    T_wb = np.tile(np.eye(4), (n_real, 1, 1))
    for i in range(n_real):
        t = i * dt_kf
        T_wb[i, :3, :3], T_wb[i, :3, 3] = rot(t), v0 * t + 0.5 * a_w * t * t
    vel = np.stack([v0 + a_w * i * dt_kf for i in range(n_real)])
    cal = imu.ImuCalib.create(*VI_CALIB)
    keys = ("dR", "dV", "dP", "JRg", "JVg", "JVa", "JPg", "JPa", "dt")
    fac = {k: [] for k in keys + ("C_inv",)}
    t32 = lambda a: torch.as_tensor(np.asarray(a, np.float32))
    for i in range(n_real - 1):
        t0 = i * dt_kf
        gyro = np.stack([w_b + bg_t + rng.normal(0, VI_CALIB[0], 3) for _ in range(n_sub)])
        acc = np.stack([rot(t0 + k * dt).T @ (a_w - g_w) + ba_t + rng.normal(0, VI_CALIB[1], 3)
                        for k in range(n_sub)])
        pre = imu.integrate(cal, t32(gyro), t32(acc), t32(np.full(n_sub, dt)), t32(np.zeros(3)),
                            t32(np.zeros(3)))
        for k in keys:
            fac[k].append(np.asarray(getattr(pre, k)))
        fac["C_inv"].append(np.asarray(torch.linalg.inv(imu_mode.floor_cov9(pre.C[:9, :9]))))
    shapes = {"dV": (3,), "dP": (3,), "dt": (), "C_inv": (9, 9)}
    fac = {k: np.stack(v).astype(np.float32) if v else np.zeros((0,) + shapes.get(k, (3, 3)),
                                                                np.float32)
           for k, v in fac.items()}
    valid = np.ones(K - 1, bool)
    if K > n_real:   # the last keyframe repeated; each padded factor the last real one's
        T_wb = np.concatenate([T_wb, np.repeat(T_wb[-1:], K - n_real, 0)])
        vel = np.concatenate([vel, np.repeat(vel[-1:], K - n_real, 0)])
        fac = {k: np.concatenate([v, np.repeat(v[-1:], K - n_real, 0)]) for k, v in fac.items()}
        valid[n_real - 1:] = False
    fac.update(bg_lin=np.zeros((K - 1, 3), np.float32), ba_lin=np.zeros((K - 1, 3), np.float32),
               valid=valid)
    T_wb = T_wb.astype(np.float32)
    if case == "non-finite valid":
        fac["dV"][3, 0] = np.nan
    if case == "non-finite invalid":
        fac["dP"][-1, 2] = np.nan
    free = case.startswith("free")
    if free:
        R_wg0 = inertial_init.estimate_gravity_direction(
            t32(T_wb[:, :3, :3]), t32(fac["dV"]), torch.as_tensor(valid)).numpy()
    else:
        R_wg0 = inertial_init.gravity_to_rwg(t32(g_w)).numpy()
    kw = dict(prior_g=1e2, prior_a=1e6, fix_scale=True, fix_gravity=not free, iters=20)
    if case == "free gravity and scale":
        kw.update(prior_g=1.0, prior_a=1e4, fix_scale=False, iters=8)
    vel0 = (vel + 0.3).astype(np.float32)
    return dict(T_wb=T_wb, **{k: fac[k] for k in keys + ("C_inv", "bg_lin", "ba_lin", "valid")},
                R_wg0=R_wg0.astype(np.float32), vel0=vel0, kw=kw, g_w=g_w, bg_true=bg_t,
                ba_true=ba_t, vel_true=vel, n_real=n_real)


INIT_ARGS = ("T_wb", "dR", "dV", "dP", "JRg", "JVg", "JVa", "JPg", "JPa", "dt", "C_inv",
             "bg_lin", "ba_lin", "valid", "R_wg0", "vel0")   # inertial_optimization's


def init_args(torch, p, dev, dtype=None):
    """``inertial_optimization``'s arguments ``(a, kw)`` for ``init_problem``'s
    ``p`` on ``dev`` (every float tensor cast to ``dtype`` where given)."""
    a = tuple(torch.as_tensor(p[k]).to(dev) for k in INIT_ARGS)
    if dtype is not None:
        a = _vi_cast(torch, a, dtype)
    return a, dict(p["kw"])


def init_cpu64(torch, a):
    """``inertial_optimization``'s positional arguments on the CPU in float64:
    the plain version's float64 run (the reference the kernel is held to)."""
    return tuple(x.detach().cpu().double() if x.is_floating_point() else x.cpu() for x in a)


def init_agreement(torch, got, ref64, ref32=None) -> dict:
    """How an ``InertialInitResult`` agrees with the plain version run in
    float64 (``ref64``; the kernel is float64 after its float32 inputs): the
    largest difference of R_wg, the scale, the biases, the velocities and
    the cost (relative, absolute below 1), a NaN beside a NaN 0; ``outside``
    lists the quantities beyond ``INIT_TOL``. With ``ref32`` (the float32
    plain run, a reference that is printed and gates nothing),
    ``float32_vs_float64`` gives its distance from ``ref64`` the same way."""
    def dist(a, b, key):
        a, b = a.detach().double().cpu(), b.detach().double().cpu()
        d = torch.where(torch.isnan(a) & torch.isnan(b), torch.zeros_like(a), (a - b).abs())
        d = float(d.max()) if d.numel() else 0.0
        if key == "cost":
            d /= max(float(b.abs().nan_to_num(0.0).max()), 1.0)
        return d if d == d else float("inf")

    q = lambda r: dict(zip(("R_wg", "scale", "bg", "ba", "vel", "cost"), r))
    qg, q64 = q(got), q(ref64)
    out = {k: dist(qg[k], q64[k], k) for k in qg}
    out["outside"] = [k for k, tol in INIT_TOL.items() if not out[k] <= tol]
    if ref32 is not None:
        q32 = q(ref32)
        out["float32_vs_float64"] = {k: dist(q32[k], q64[k], k) for k in qg}
    return out


def init_bound(K: int, iters: int) -> tuple:
    """(least ms on the card, what bounds it) of one ``inertial_init_gn``
    call: bytes read and written once (the poses, the K - 1 factors' fields
    and flags, R_wg0, vel0, the result) over the memory rate; float64
    operations over the float64 rate, a fused multiply-add counted as one:
    a factor's ``INIT_OPS_FACTOR`` an iteration, and the solve of the 9 + 3K
    rows (n^3 / 3 for the elimination, n^2 for the two substitutions, n^2 for
    the Jacobi scaling), the entry cost."""
    n, F = 9 + 3 * K, K - 1
    n_bytes = 4 * (16 * K + F * (9 * 6 + 3 * 4 + 1 + 81) + 9 + 3 * K) + F + 4 * (17 + 3 * K)
    f64 = iters * (INIT_OPS_FACTOR * F + n ** 3 / 3 + 2 * n ** 2) + INIT_OPS_RESIDUAL * F
    t_b, t_o = n_bytes / PEAK_BYTES_S, f64 / PEAK_F64_S
    return 1e3 * max(t_b, t_o), "bytes" if t_b >= t_o else "operations"


def init_phase(torch, dev, cases, log=print, sync=lambda: None, timer=None, split=None,
               timed=None) -> dict:
    """Phase 5, the visual-inertial initialization's kernel against its plain
    version on ``dev`` through the dispatcher a user calls
    (``solver.inertial_init.inertial_optimization``): ``cases`` lists
    ``(label, a, kw)``; each is held to ``INIT_TOL`` of the plain version
    run in float64 on the CPU (``init_agreement``; the float32 plain run is
    printed beside it), the same bits on a second call, one launch a call by
    the wrapper's counter, no host sync; a case with a NaN returns its entry
    state. ``timer(fn, reps) -> ms`` times a call behind a device backlog
    for the cases whose labels ``timed`` lists (default the first; none: not
    taken), the kernel's and the plain version's; ``split(fn) -> {kernel:
    ...}`` gives a call's device events by kernel name, which must be one
    ``inertial_init_kernel`` and the wrapper's copy of each input that is
    not contiguous, nothing else. Returns the kernel's row, its times
    those of the first timed case and ``ms_by_case`` every timed case's;
    raises RuntimeError where a check fails."""
    from tc2li_slam_torch.ops.kernels import inertial_init as kii
    from tc2li_slam_torch.solver import inertial_init as ii

    timer = timer or (lambda fn, reps: float("nan"))
    timed = timed or [cases[0][0]]
    row, err, by_case = None, 0.0, {}
    for label, a, kw in cases:
        n0 = kii.launches
        got, again = ii.inertial_optimization(*a, **kw), ii.inertial_optimization(*a, **kw)
        n_launch = kii.launches - n0
        ref = kii.inertial_init_plain(*a, **kw)
        ref64 = kii.inertial_init_plain(*init_cpu64(torch, a), **kw)
        sync()
        agr = init_agreement(torch, got, ref64, ref)
        if not a[0].is_cuda:   # the CPU route is the plain version itself
            agr["outside"] = [] if bit_equal(torch, list(got), list(ref)) else ["plain"]
        twice = bit_equal(torch, list(got), list(again))
        K = a[0].shape[0]
        log(f"inertial_init_gn {label} (K {K}, {int(a[13].sum())} valid factors, {kw['iters']} "
            f"iterations, priors {kw['prior_g']:g} / {kw['prior_a']:g}, fix_scale "
            f"{kw['fix_scale']}, fix_gravity {kw['fix_gravity']}): cost {float(got.cost):.6f} / "
            f"plain in float64 {float(ref64.cost):.6f} / plain in float32 {float(ref.cost):.6f}; "
            "|kernel - float64|, |plain in float32 - float64| "
            + ", ".join(f"{k} {agr[k]:.2e} / {v:.2e}" for k, v in agr["float32_vs_float64"].items())
            + f"; beyond tolerance {agr['outside']}; the same bits on a second call {twice}; "
            f"launches {n_launch}")
        want = 2 if a[0].is_cuda else 0
        if agr["outside"] or not twice or n_launch != want:
            raise RuntimeError(f"inertial_init_gn disagrees with its plain version run in float64 "
                               f"on {label}: {agr}, the same bits twice {twice}, launches "
                               f"{n_launch} for 2 calls (expected {want})")
        if bool(torch.isnan(ref64.cost)) and not (
                torch.equal(got.vel, a[15]) and bool(torch.isnan(got.cost))
                and torch.equal(got.R_wg, a[14])):
            raise RuntimeError(f"inertial_init_gn on {label}: the state moved on a NaN cost")
        err = max(err, agr["vel"])   # (beyond INIT_TOL, inf included, failed above)
        if label in timed:
            ms = timer(lambda: ii.inertial_optimization(*a, **kw), 20)
            ms_p = timer(lambda: kii.inertial_init_plain(*a, **kw), 3)
            b = init_bound(K, kw["iters"])
            parts = split(lambda: ii.inertial_optimization(*a, **kw)) if split else None
            log(f"inertial_init_gn {label}: {ms:.4f} ms a call behind a backlog, bound "
                f"{b[0]:.6f} ms ({b[1]}), plain {ms_p:.4f} ms"
                + ("; device events a call by kernel (torch.profiler): "
                   + ", ".join(f"{k} {v['launches_a_call']:g} x {v['ms_a_launch']:.4f} ms"
                               for k, v in parts.items()) if parts is not None else ""))
            # the wrapper's only other device events: a copy of each input
            # that is not contiguous (init_problem's C_inv where unpadded)
            n_copy = sum(not x.is_contiguous() for x in a)
            want = {"inertial_init_kernel": 1.0} | (
                {"direct_copy_kernel_cuda": float(n_copy)} if n_copy else {})
            if parts is not None and {k: v["launches_a_call"] for k, v in parts.items()} != want:
                raise RuntimeError(f"inertial_init_gn on {label}: the profiler's record of a "
                                   f"call is not {want}: {parts}")
            by_case[label] = dict(ms=ms, plain_ms=ms_p, bound_ms=b[0])
            if row is None:
                row = dict(source="tc2li_slam_torch/csrc/inertial_init.cu",
                           replaces="tc2li_slam_tpu/solver/inertial_init.py:85", ms=ms,
                           plain_ms=ms_p, bound_ms=b[0], bound_by=b[1], library_ms=None)
    n_sync = [syncs_of(torch, lambda: ii.inertial_optimization(*a, **kw)) for _, a, kw in cases]
    log(f"inertial_init_gn: host syncs in a call {n_sync}")
    if any(n_sync):
        raise RuntimeError(f"inertial_init_gn synchronised the host in a call: {n_sync}")
    row.update(max_abs_err=err, ms_by_case=by_case)
    return {"inertial_init_gn": row}


def vi_phase(torch, dev, vi_inputs, rng, log=print, sync=lambda: None, timer=None) -> dict:
    """Phase 5, the IMU mode's two kernels against their plain versions on
    ``dev``, through the dispatchers a user calls (``estimation.imu.integrate``,
    ``solver.pose_inertial.optimize_last_kf`` / ``optimize_last_frame``):
    ``vi_inputs`` holds 4e's saved arguments (the last call of each form,
    ``integrate:last`` and ``integrate:longest``). ``timer(fn, reps) -> ms``
    times a call on the device (none: the times are not taken). Returns the
    two kernel rows; raises RuntimeError where a check fails."""
    import numpy as np

    from tc2li_slam_torch.estimation import imu as imu_mod
    from tc2li_slam_torch.ops.kernels import imu_preint as kimu, pose_inertial as kpi
    from tc2li_slam_torch.solver import pose_inertial as pi_mod

    rows = {}
    timer = timer or (lambda fn, reps: float("nan"))
    saved = dict(vi_inputs)   # (the calls below pass through the run's spies)
    # the pose-inertial LM: 4e's last call of each form (its inputs as
    # System passed them), the same with nothing valid and with a masked NaN
    # row, and vi_problem's frames at O 3 and 60
    vi_cases = []
    for name, nf in (("optimize_last_kf", 15), ("optimize_last_frame", 30)):
        if name not in saved:
            raise RuntimeError(f"IMU mode: System never called {name}")
        a = saved[name]
        X_nan = a[-7].clone()
        X_nan[0] = float("nan")
        masked = a[-3].clone()
        masked[0] = False
        vi_cases += [(f"4e's last {name}", name, a),
                     (f"4e's last {name}, nothing valid", name,
                      a[:-3] + (torch.zeros_like(a[-3]),) + a[-2:]),
                     (f"4e's last {name}, a masked NaN row", name,
                      a[:-7] + (X_nan,) + a[-6:-3] + (masked,) + a[-2:])]
        for O in (3, 60):
            vi_cases.append((f"vi_problem O {O} ({nf} dims)", name,
                             vi_args(torch, vi_problem(np.random.default_rng(O), O, nf), dev)[1]))
    vi_err = 0.0
    for label, name, a in vi_cases:
        got, again = getattr(pi_mod, name)(*a), getattr(pi_mod, name)(*a)
        ref = getattr(kpi, name + "_plain")(*a)
        a64 = _vi_cast(torch, a, torch.float64)
        ref64 = getattr(kpi, name + "_plain")(*a64)
        sync()
        agr = vi_agreement(torch, a, got, ref, ref64)
        twice = bit_equal(torch, [got.state.T_wb, got.state.vel, got.prior.H, got.cost,
                                  got.inliers, got.n_inliers],
                          [again.state.T_wb, again.state.vel, again.prior.H, again.cost,
                           again.inliers, again.n_inliers])
        log(f"pose_inertial_lm {label} (O {a[-7].shape[0]}, {int(a[-3].sum())} valid): "
            + ", ".join(f"{k} {v:.2e}" for k, v in agr.items() if isinstance(v, float))
            + f"; inliers {agr['n_inliers']}, flags that differ {agr['flips']}, of which at a "
            f"gate {agr['near']}; beyond tolerance and farther from float64 than the plain "
            f"version {agr['outside']}; the same bits on a second call {twice}")
        if agr["outside"] or agr["flips"] != agr["near"] or not twice:
            raise RuntimeError(f"pose_inertial_lm disagrees with its plain version on {label}: "
                               f"{agr}, the same bits twice {twice}")
        if "NaN" in label and (not bool(torch.isnan(got.cost))
                               or not torch.equal(got.state.T_wb, a[2].T_wb)):
            raise RuntimeError(f"pose_inertial_lm on {label}: the cost is not NaN or the state "
                               f"moved")
        vi_err = max(vi_err, agr["T_wb"])
    n_sync = syncs_of(torch, lambda: pi_mod.optimize_last_frame(*saved["optimize_last_frame"]))
    log(f"pose_inertial_lm: {n_sync} host syncs in a call")
    if n_sync:
        raise RuntimeError(f"pose_inertial_lm synchronised the host {n_sync} times in a call")
    for name, nf in (("optimize_last_kf", 15), ("optimize_last_frame", 30)):
        a = saved[name]
        O = a[-7].shape[0]
        n_step = 2 * 6
        n_eval = n_step + 2 + 1   # a pass a step, a round's first, the last
        ms_k = timer(lambda: getattr(pi_mod, name)(*a), 30)
        ms_p = timer(lambda: getattr(kpi, name + "_plain")(*a), 3)
        b_v = bound(VI_BYTES_FIXED + VI_BYTES_ROW * O, 0.0)
        t_ops = 1e3 * (n_eval * (VI_OPS_ROW * O + VI_OPS_ASSEMBLE[nf])
                       + n_step * VI_OPS_STEP[nf] + VI_OPS_SCHUR[nf]) / PEAK_F64_S
        b_v = (t_ops, "operations") if t_ops > b_v[0] else b_v
        log(f"pose_inertial_lm, 4e's last {name} ({nf} free dims, O {O}, {n_eval} "
            f"evaluations): kernel {ms_k:.4f} ms on the device, bound {b_v[0]:.6f} ms "
            f"({b_v[1]}, float64), plain {ms_p:.4f} ms")
        if nf == 30:
            rows["pose_inertial_lm"] = dict(
                source="tc2li_slam_torch/csrc/pose_inertial.cu",
                replaces="tc2li_slam_tpu/solver/pose_inertial.py:205", max_abs_err=vi_err,
                ms=ms_k, plain_ms=ms_p, bound_ms=b_v[0], bound_by=b_v[1], library_ms=None)
    # the preintegration: 4e's last and longest windows; N 1, 10 and 1024 (the
    # IMU ring's size) with padded slots; a chunk's edges (9 live samples: two
    # chunks of 8 and 1; 513: the first window at 9 a chunk); N 1000; a window
    # of padding only
    imu_cases = [("4e's last window", saved["integrate:last"]),
                 ("4e's longest window", saved["integrate:longest"])]
    cal_e = saved["integrate:last"][0]
    for N, pad, what in ((1, 7, "every seventh slot padding"),
                         (10, 7, "every seventh slot padding"),
                         (1024, 7, "every seventh slot padding"),
                         (9, 0, "two chunks, 8 and 1"), (513, 0, "9 samples a chunk"),
                         (1000, 0, "no padding"), (60, 1, "every slot padding")):
        g_ = torch.as_tensor(rng.normal(0, 0.1, (N, 3)), dtype=torch.float32, device=dev)
        a_ = torch.as_tensor(rng.normal(0, 1, (N, 3)) + [0.0, 0.0, 9.81], dtype=torch.float32,
                             device=dev)
        padded = np.arange(N) % 7 == 3 if pad == 7 else np.full(N, pad == 1)
        d_ = torch.as_tensor(np.where(padded, 0.0, 0.01), dtype=torch.float32, device=dev)
        imu_cases.append((f"N {N}, {what}", (
            cal_e, g_, a_, d_, torch.full((3,), 1e-3, device=dev),
            torch.full((3,), -0.02, device=dev))))
    imu_err = 0.0
    for label, a in imu_cases:
        got, again = imu_mod.integrate(*a), imu_mod.integrate(*a)
        ref = kimu.integrate_plain(*a)
        ref64 = kimu.integrate_plain(a[0], *(x.double() for x in a[1:]))
        sync()
        worst = {}
        for f in ("dR", "dV", "dP", "JRg", "JVg", "JVa", "JPg", "JPa", "C", "dt"):
            g64, r32, r64 = (getattr(r, f).double() for r in (got, ref, ref64))
            worst[f] = (imu_distance(torch, f, g64, r64), imu_distance(torch, f, r32, r64),
                        float((g64 - r32).abs().max()))
        # float32 sums in another order than ATen's, judged against float64: no
        # farther from it than 1e-4 (imu_distance), nor more than 4x the float32
        # plain version's own distance where that is larger
        bad = [f for f, (dk, dp, _) in worst.items() if dk > max(1e-4, 4.0 * dp)]
        twice = bit_equal(torch, got[:10], again[:10])
        N = a[1].shape[0]
        log(f"imu_preintegrate {label} (N {N}, {int((a[3] > 0).sum())} live): relative "
            f"to float64 kernel / plain "
            + ", ".join(f"{f} {dk:.1e}/{dp:.1e}" for f, (dk, dp, _) in worst.items())
            + f"; the same bits on a second call {twice}")
        if bad or not twice:
            raise RuntimeError(f"imu_preintegrate on {label}: {bad} outside, same bits {twice}")
        if "every slot padding" in label and not (
                torch.equal(got.dR, torch.eye(3, device=dev)) and not bool(got.C.any())
                and float(got.dt) == 0.0):
            raise RuntimeError(f"imu_preintegrate on {label}: not the identity map")
        imu_err = max(imu_err, max(w[2] for w in worst.values()))
    n_sync = syncs_of(torch, lambda: imu_mod.integrate(*saved["integrate:longest"]))
    if n_sync:
        raise RuntimeError(f"imu_preintegrate synchronised the host {n_sync} times in a call")
    # timed by label (a case added above times nothing; a label renamed fails
    # here): the kernels line's row is 4e's last window
    timed = ("4e's last window", "4e's longest window", "N 1024, every seventh slot padding")
    for label in timed:
        a = dict(imu_cases)[label]
        N = a[1].shape[0]
        ms_k = timer(lambda: imu_mod.integrate(*a), 50)
        ms_p = timer(lambda: kimu.integrate_plain(*a), 3)
        b_i = bound(IMU_BYTES_SAMPLE * N + 24 + 4 * kimu.OUT_FLOATS, IMU_OPS_SAMPLE * N)
        log(f"imu_preintegrate {label} (N {N}): kernel {ms_k:.4f} ms on the device, "
            f"{1e3 * ms_k / max(N, 1):.3f} us a sample, bound {b_i[0]:.6f} ms ({b_i[1]}), "
            f"plain {ms_p:.4f} ms; host syncs in a call {n_sync}")
        if label == timed[0]:
            rows["imu_preintegrate"] = dict(
                source="tc2li_slam_torch/csrc/imu_preint.cu",
                replaces="tc2li_slam_tpu/estimation/imu.py:83", max_abs_err=imu_err, ms=ms_k,
                plain_ms=ms_p, bound_ms=b_i[0], bound_by=b_i[1], library_ms=None)
    return rows


# the LiDAR-inertial scan step's kernels (ops/kernels/lio.py): their bounds'
# operation counts, float32 (rows, prediction) and float64 (the step)
LIO_PREDICT_OPS_SAMPLE = 2 * 48 * 23 + 60 + 250   # F P and (F P) F^T a row block each,
#   the noise blocks, the sample's Exp / Jr / state chain
LIO_PREDICT_BYTES_SAMPLE = 28 + 48                 # gyro, acc, dt in; R, p out
LIO_ROWS_OPS_POINT = 25 * 19 + 125 * 10 + 5 * 40   # float32: the searches, the
#   candidates, the top-5
LIO_ROWS_OPS64_POINT = 300 + 80                    # float64: the plane fit, the row and its
#   products
LIO_STEP_OPS = {"step": 23 * 23 * 12 + 23 ** 3 // 3 + 2 * 23 * 23 + 600,
                "first": 2 * 23 ** 3, "final": 2 * 23 ** 3 + 23 * 23 * 8}
# the kernels against their plain versions: the prediction's state and P
# (diagonally scaled), the rows' normal equations (N diagonally scaled, v
# over its largest entry) and neighbour sets, the float64 step's iterate and
# P against the plain step run in float64, the scan step's end state and P
# (the CPU test's tolerances: state 1e-3, P rtol 2e-2, n_effective within 3)
LIO_TOL = {"predict_state": 1e-4, "predict_P": 1e-4, "rows": 1e-4, "nbr_equal": 0.999,
           "step_state": 1e-6, "step_P": 1e-5, "state": 1e-3, "P_rtol": 2e-2, "n_eff": 3}


def lio_problem(torch, dev, seed: int = 0, n_scan: int = 1 << 15, cap: int = 1 << 19):
    """A scan step's arguments (``lio.lio_scan_step``'s, the voxel map and
    the filter first) at the IMU mode's widths: ``io/synthetic``'s street
    world, a pool of ``cap`` slots (voxel 0.5 m) holding the downsampled scan
    at t = 0 placed at the true pose, the filter there with its velocity, the
    scan at t = 0.1 (``n_scan`` points, per-point times) and its IMU window
    (100 Hz, 16 slots), the System's LioConfig (``max_iters`` 3,
    ``work_cap`` 8192)."""
    import numpy as np

    from tc2li_slam_torch.estimation import esekf
    from tc2li_slam_torch.io import synthetic as syn
    from tc2li_slam_torch.ops import pointcloud, voxel_map
    from tc2li_slam_torch.slam import lio

    rng = np.random.default_rng(seed)
    world = syn.make_world(rng, n_surf=300_000)
    traj = syn.Trajectory(w_body=(0, 0, 0.03), v_world=(1.5, 0.1, 0.0))
    up = lambda a, dt_=torch.float32: torch.as_tensor(np.asarray(a)).to(dev, dt_)
    T0, T1 = syn.trajectory_poses(traj, 2)
    scan0, v0 = syn.lidar_scan(world, T0, rng, n_max=n_scan)
    pw0 = scan0 @ T0[:3, :3].T.astype(np.float32) + T0[:3, 3].astype(np.float32)
    ds, dsv = pointcloud.voxel_downsample(up(pw0), up(v0, torch.bool), 0.5)
    m = voxel_map.insert(voxel_map.create(cap, 0.5, device=dev), ds, dsv)
    x = esekf.init_state(device=dev)._replace(pos=up(T0[:3, 3]), R=up(T0[:3, :3]),
                                              vel=up(traj.v))
    filt = esekf.Filter(x, esekf.init_filter(device=dev).P)
    scan1, v1 = syn.lidar_scan(world, T1, rng, n_max=n_scan)
    gyro, acc, dts, trel = syn.imu_window(traj, 0.0, 0.1, n_max=16)
    cfg = lio.LioConfig(scan_voxel=0.5, map_voxel=0.5, max_iters=3, blind=2.0, work_cap=8192)
    noise = esekf.NoiseCfg.create(*VI_CALIB)
    return (filt, m, up(scan1), up(np.full(n_scan, 0.1, np.float32)), up(v1, torch.bool),
            up(gyro), up(acc), up(dts), up(trel), noise, cfg)


def predict_window(torch, n_live: int, slots: int = 0, seed: int = 0):
    """An IMU window for ``esekf_predict`` on the CPU: (gyro [N, 3], acc [N,
    3], dts [N]) float32, ``n_live`` samples at 100 Hz (seeded) and, with
    ``slots`` > n_live, N = slots with a live sample every slots // n_live
    slots from the third and padding between (dt 0, NaN acc) and after."""
    g = torch.Generator().manual_seed(seed)
    gyro = 0.3 * torch.randn((n_live, 3), generator=g)
    acc = torch.randn((n_live, 3), generator=g) + torch.tensor([0.0, 0.0, 9.81])
    dts = torch.full((n_live,), 0.01)
    if slots <= n_live:
        return gyro, acc, dts
    at = 3 + (slots // n_live) * torch.arange(n_live)
    out = (torch.zeros((slots, 3)), torch.full((slots, 3), float("nan")), torch.zeros(slots))
    for t, src in zip(out, (gyro, acc, dts)):
        t[at] = src
    return out


# the window mode's grid edge cases (csrc/match.cu window_grid_kernel)
WINDOW_CASES = ("border", "outside", "non-finite", "tie across cells", "cluster")


def window_case(rng, N: int, M: int, case: str | None = None, base: float = 15.0,
                width: float = 1241.0, height: float = 376.0) -> dict:
    """A window match's inputs as numpy arrays (descriptors uint32):
    keypoints over a width x height image, rows projected near them with
    ORB-SLAM3's window radius base x 1.2^level, 20% of rows and 10% of
    columns invalid; and one of ``WINDOW_CASES``: windows across the image
    border and outside it; columns far outside the image (their cells wrap
    onto the image's) or off the grid (invalid, or at a non-finite
    position), and rows near them; NaN and infinite row
    positions and radii, radii 0 and below, and huge finite ones; a tie
    across two cells where the lower column lies in the cell walked later
    (rows 0-4, columns 3 and 7); 40 columns in one 16-px cell (rows 0-49
    near them)."""
    import numpy as np
    d2 = rng.integers(0, 1 << 32, (M, 8), dtype=np.uint64).astype(np.uint32)
    src = rng.integers(0, M, N)
    d1 = d2[src].copy()
    d1[:, 0] ^= rng.integers(0, 1 << 12, N).astype(np.uint32)
    uv2 = np.stack([rng.uniform(0, width, M), rng.uniform(0, height, M)], -1).astype(np.float32)
    uv1 = (uv2[src] + rng.normal(0, 4, (N, 2))).astype(np.float32)
    lvl2 = rng.integers(0, 8, M).astype(np.int32)
    lvl1 = np.clip(lvl2[src] + rng.integers(-2, 3, N), 0, 7).astype(np.int32)
    c = dict(d1=d1, d2=d2, uv1=uv1, uv2=uv2, lvl1=lvl1, lvl2=lvl2,
             radius=(base * 1.2 ** lvl1).astype(np.float32),
             valid1=rng.random(N) > 0.2, valid2=rng.random(M) > 0.1)
    if case == "border":
        k = N // 4
        c["uv1"][:k, 0] = rng.uniform(-40, 20, k)
        c["uv1"][k:2 * k, 1] = rng.uniform(350, 420, k)
        c["uv1"][2 * k:2 * k + 8] = [[-500, -500], [2000, 200], [600, -90], [600, 900],
                                     [-5, -5], [1250, 380], [0, 0], [1241, 376]]
    elif case == "outside":
        c["uv2"][:6] = [[-5000, 10], [1e6, 200], [600, -3e4], [30, 1e7],
                        [np.inf, 100], [np.nan, 100]]
        c["valid2"][:6] = True
        c["uv2"][6:9] = [[-1e9, -1e9], [np.nan, np.nan], [3e38, -3e38]]
        c["valid2"][6:9] = False
        c["uv1"][:4] = [[-5000, 10], [1e6, 200], [600, -3e4], [30, 1e7]]
        c["radius"][:4] = 50.0
        c["valid1"][:4] = True
    elif case == "non-finite":
        vals = [(np.nan, 100, 20), (100, np.nan, 20), (np.inf, 100, 20), (100, -np.inf, 20),
                (100, 100, np.nan), (100, 100, np.inf), (100, 100, 0), (100, 100, -3),
                (np.inf, np.inf, np.inf), (1e9, 100, 1e9 - 100), (3e38, 0, 3e38),
                (-3e38, 10, np.inf)]
        for i, (u, v, r) in enumerate(vals):
            c["uv1"][i], c["radius"][i], c["valid1"][i] = (u, v), r, True
    elif case == "tie across cells":
        c["d2"][7] = c["d2"][3]
        c["uv2"][3], c["uv2"][7] = (430.0, 150.0), (400.0, 100.0)
        c["uv2"][0], c["uv2"][1] = (0.0, 0.0), (width, height)
        c["lvl2"][[3, 7]] = 2
        c["valid2"][[0, 1, 3, 7]] = True
        c["d1"][:5] = c["d2"][3]
        c["uv1"][:5] = (415.0, 125.0)
        c["radius"][:5] = 40.0
        c["lvl1"][:5] = 2
        c["valid1"][:5] = True
    elif case == "cluster":
        c["uv2"][:40] = rng.uniform(608.5, 623.5, (40, 2)).astype(np.float32)
        c["valid2"][:40] = True
        c["uv1"][:50] = c["uv2"][np.arange(50) % 40] + rng.normal(0, 2, (50, 2)).astype(np.float32)
        c["valid1"][:50] = True
    return c


# the stereo mode's row-bin edge cases (csrc/match.cu match_best2_bins_kernel)
STEREO_BIN_CASES = ("bin edges", "band equality", "one bin", "levels 0-7", "non-finite band",
                    "non-finite position", "invalid", "odd sizes", "full width",
                    "level gate", "far levels")
STEREO_MAX_COLUMNS = 5120   # tc2li_match_max_columns(1)


def stereo_bins_case(rng, case: str, N: int = 600, M: int = 700) -> dict:
    """A stereo match's inputs as numpy arrays (descriptors int32) on a
    1241 x 376 image: right keypoints with ORB-SLAM3's band 2 x 1.2^level,
    left keypoints 3 px left to 60 px right of a source column with a row
    offset of up to 1.2 bands, descriptors a few bits off the source's,
    5% of rows and columns invalid, ``max_d`` 718.856 (bf / baseline), the
    level gate -1..1; and one of ``STEREO_BIN_CASES``: right rows at a bin
    edge (bins of 0.5 px over the extent 0..376) and one ulp either side,
    left rows at exactly a band from them and one ulp beyond; left rows at
    a band's distance in float32 from their source; every right keypoint on
    one row; levels 0-7 at 2,000 x 2,000; bands NaN, +-inf, -0, negative,
    with rows far from the infinite ones and at non-finite v; non-finite u
    and v on both sides (some of the columns with an infinite band); a
    third of rows and a quarter of columns invalid; 1,003 x 517; 2,000 x
    ``STEREO_MAX_COLUMNS``; a level gate 0..2; levels outside 0..31 with a
    gate of -2000..2000. Keys: d1, d2, valid1, valid2, uv1, uv2, lvl1, lvl2,
    band, max_d, lo, hi."""
    import numpy as np
    f32 = np.float32
    N, M = {"odd sizes": (1003, 517), "full width": (2000, STEREO_MAX_COLUMNS),
            "levels 0-7": (2000, 2000)}.get(case, (N, M))
    sf = (1.2 ** np.arange(8)).astype(f32)
    lvl2 = rng.choice(8, M, p=0.2 * 0.8 ** np.arange(8) / (1 - 0.8 ** 8)).astype(np.int32)
    uv2 = np.stack([rng.uniform(0, 1241, M), rng.uniform(0, 376, M)], 1).astype(f32)
    d2 = rng.integers(-2 ** 31, 2 ** 31, (M, 8)).astype(np.int32)
    src = rng.integers(0, M, N)
    d1 = d2[src] ^ rng.integers(0, 1 << 5, (N, 8)).astype(np.int32)
    lvl1 = np.clip(lvl2[src] + rng.integers(-1, 2, N), 0, 7).astype(np.int32)
    band = (f32(2.0) * sf[lvl2]).astype(f32)
    off = np.stack([rng.uniform(-3, 60, N), rng.uniform(-1.2, 1.2, N) * band[src]], 1)
    uv1 = (uv2[src] + off).astype(f32)
    c = dict(d1=d1, d2=d2, valid1=rng.random(N) > 0.05, valid2=rng.random(M) > 0.05,
             uv1=uv1, uv2=uv2, lvl1=lvl1, lvl2=lvl2, band=band, max_d=718.856, lo=-1, hi=1)
    up, down = lambda x: np.nextafter(f32(x), f32(np.inf)), lambda x: np.nextafter(f32(x), f32(-np.inf))
    if case == "bin edges":
        c["uv2"][:2, 1] = (0.0, 376.0)   # the extent: scale 2, bins of 0.5 px
        c["valid2"][:2] = True
        edges = [f32(v) for e in (100.0, 100.5, 200.25, 201.0) for v in (down(e), e, up(e))]
        k = len(edges)
        c["uv2"][2:2 + k, 1] = edges
        c["lvl2"][2:2 + k] = 0
        c["band"][2:2 + k] = 2.0
        c["valid2"][2:2 + k] = True
        rows = [(j, v1) for j, e in enumerate(edges)
                for v1 in (f32(e - f32(2.0)), f32(e + f32(2.0)), down(f32(e - f32(2.0))),
                           up(f32(e + f32(2.0))), e)]
        for i, (j, v1) in enumerate(rows):
            c["uv1"][i] = (c["uv2"][2 + j, 0] + 5.0, v1)
            c["lvl1"][i], c["valid1"][i], c["d1"][i] = 0, True, c["d2"][2 + j]
    elif case == "band equality":
        sign = np.where(rng.random(N) < 0.5, f32(-1.0), f32(1.0))
        c["uv1"][:, 1] = (c["uv2"][src, 1] + sign * c["band"][src]).astype(f32)
        c["uv1"][::3, 1] = np.nextafter(c["uv1"][::3, 1], f32(np.inf) * sign[::3])
    elif case == "one bin":
        c["uv2"][:, 1] = 187.25
        c["uv1"][:, 1] = (187.25 + rng.uniform(-3, 3, N)).astype(f32)
    elif case == "non-finite band":
        for k, b in enumerate((np.nan, np.inf, -np.inf, -0.0, -1.0, 0.0)):
            c["band"][k::7] = b
        c["uv1"][:40, 1] = rng.uniform(-1e4, 1e4, 40).astype(f32)   # far from their sources
        c["uv1"][40:44, 1] = (np.nan, np.inf, -np.inf, 3e38)
        c["valid1"][:44] = True
    elif case == "non-finite position":
        bad = (np.nan, np.inf, -np.inf, 3e38, -3e38)
        for k, b in enumerate(bad):
            c["uv1"][k::11, 0] = b
            c["uv1"][5 + k::11, 1] = b
            c["uv2"][k::13, 0] = b
            c["uv2"][6 + k::13, 1] = b
        c["band"][::5] = np.inf
        c["max_d"] = float(np.inf)
    elif case == "invalid":
        c["valid1"][::3] = False
        c["valid2"][::4] = False
    elif case == "level gate":
        c["lo"], c["hi"] = 0, 2
    elif case == "far levels":
        far = np.array([40, -5, 1000, 31, 32, -2 ** 31, 2 ** 31 - 1], np.int32)
        c["lvl2"][:M // 2] = rng.choice(far, M // 2)
        c["lvl1"][:N // 2] = c["lvl2"][src[:N // 2]]
        c["band"][:M // 2] = rng.uniform(0.5, 9.0, M // 2).astype(f32)
        c["lo"], c["hi"] = -2000, 2000
    c["max_d"] = float(np.float32(c["max_d"]))
    return c


def stereo_bins_args(torch, match, c: dict, dev):
    """``match_best2``'s (d1, d2, valid1, valid2, StereoMask) on ``dev`` for a
    ``stereo_bins_case``."""
    u = {k: torch.as_tensor(c[k]).to(dev) for k in
         ("d1", "d2", "valid1", "valid2", "uv1", "uv2", "lvl1", "lvl2", "band")}
    return (u["d1"], u["d2"], u["valid1"], u["valid2"],
            match.StereoMask(u["uv1"], u["lvl1"], u["uv2"], u["lvl2"], u["band"], c["max_d"],
                             c["lo"], c["hi"]))


# the epipolar mode's edge cases (csrc/match.cu match_best2_epipolar_kernel)
EPI_CASES = ("pair", "on the gate", "tiny lines", "non-finite", "rows invalid", "ties",
             "wide", "one row")
EPI_MAX_COLUMNS = 14464   # tc2li_match_max_columns(3)


def epipolar_pair(rng, N: int, M: int, n_common: int | None = None):
    """Two keyframes of a KITTI-shaped rig ~1.5 m apart: ``n_common`` points
    seen by both (keypoints with 0.5 px noise, descriptors a few bits
    apart), the rest of each view's keypoints unrelated; 40% of the
    features already matched (invalid). As numpy: d1, d2 (uint32), valid1,
    valid2, uv1 [N, 2], uv2 [M, 2], F12 [3, 3] (view 1 -> view 2), sigma2
    [M] (1.2^(2 level)), thresh."""
    import numpy as np
    fx, cx, cy = 718.856, 607.1928, 185.2157
    K = np.array([[fx, 0, cx], [0, fx, cy], [0, 0, 1]])
    n_common = min(N, M) * 2 // 3 if n_common is None else n_common
    X = np.stack([rng.uniform(-20, 20, n_common), rng.uniform(-3, 2, n_common),
                  rng.uniform(6, 60, n_common)], -1)
    a = 0.03
    R21 = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]])
    t21 = np.array([-0.2, 0.02, -1.5])

    def proj(Xc):
        return (Xc[:, :2] / Xc[:, 2:]) * fx + np.array([cx, cy])
    uv1 = rng.uniform([0, 0], [1241, 376], (N, 2))
    uv2 = rng.uniform([0, 0], [1241, 376], (M, 2))
    i1, i2 = rng.permutation(N)[:n_common], rng.permutation(M)[:n_common]
    uv1[i1] = proj(X) + rng.normal(0, 0.5, (n_common, 2))
    uv2[i2] = proj(X @ R21.T + t21) + rng.normal(0, 0.5, (n_common, 2))
    d2 = rng.integers(0, 1 << 32, (M, 8), dtype=np.uint64).astype(np.uint32)
    d1 = rng.integers(0, 1 << 32, (N, 8), dtype=np.uint64).astype(np.uint32)
    d1[i1] = d2[i2]
    d1[i1, 0] ^= rng.integers(0, 1 << 10, n_common).astype(np.uint32)
    tx = np.array([[0, -t21[2], t21[1]], [t21[2], 0, -t21[0]], [-t21[1], t21[0], 0]])
    Ki = np.linalg.inv(K)
    F12 = (Ki.T @ tx @ R21 @ Ki).astype(np.float32)
    lvl2 = rng.integers(0, 8, M)
    return dict(d1=d1, d2=d2, valid1=rng.random(N) > 0.4, valid2=rng.random(M) > 0.4,
                uv1=uv1.astype(np.float32), uv2=uv2.astype(np.float32), F12=F12,
                sigma2=(1.2 ** (2 * lvl2)).astype(np.float32), thresh=3.84)


def epipolar_case(rng, case: str, N: int = 600, M: int = 700) -> dict:
    """An epipolar match's inputs as numpy arrays, ``EPI_CASES``: a keyframe
    pair (``epipolar_pair``); pairs exactly on the gate d2 == thresh x
    sigma2 and one float below it (rows 0-5); lines whose l0^2 + l1^2 is 0,
    below 1e-12, and just above it (rows 0-7); NaN and infinite positions,
    lines and sigma2; no valid row; tied distances across columns (rows
    0-3, columns 5, 9, 40); side 2 wider than one launch
    (``EPI_MAX_COLUMNS`` + 37 columns, 64 rows); a single row. A case with
    ``lines`` holds its rows' epipolar lines, else ``uv1`` and ``F12`` give
    them (``epipolar_args``)."""
    import numpy as np
    f32 = np.float32
    if case == "wide":
        N, M = 64, EPI_MAX_COLUMNS + 37
    if case == "one row":
        N = 1
    c = epipolar_pair(rng, N, M)
    if case in ("on the gate", "tiny lines", "non-finite", "ties", "wide"):
        x1 = np.concatenate([c["uv1"], np.ones((N, 1), f32)], -1)
        c["lines"] = (x1.astype(np.float64) @ c["F12"].T.astype(np.float64)).astype(f32)
    if case == "on the gate":
        # line u2 = 0 (l = (1, 0, 0), den2 1): d2 = u2^2; sigma2 s with
        # fl(3.84 s) == 4 exactly, so u2 = 2 lies on the gate (not admitted)
        # and the float below 2 inside it
        s = f32(4.0) / f32(3.84)
        while f32(3.84) * s != f32(4.0):
            s = np.nextafter(s, f32(np.inf) if f32(3.84) * s < 4 else f32(0))
        c["lines"][:6] = [1.0, 0.0, 0.0]
        c["lines"][3:6] *= f32(-8.0)      # l = (-8, 0, 0): d2 = 64 u2^2 / 64
        for k, m in enumerate((10, 11, 12)):
            c["uv2"][m] = [(f32(2.0), np.nextafter(f32(2.0), f32(0)), f32(-2.0))[k], 50.0]
            c["sigma2"][m] = s
            c["valid2"][m] = True
            c["d2"][m] = c["d1"][k]
            c["d2"][m, 1] ^= np.uint32(1 << k)
        c["valid1"][:6] = True
        c["d1"][3:6] = c["d1"][:3]
    elif case == "tiny lines":
        c["lines"][:8] = [[0, 0, 1], [0, 0, 0], [1e-7, 0, 2], [0, -9e-7, 1e-6],
                          [f32(1e-6), f32(0), f32(-1e-4)], [1.1e-6, 0, 0], [3e-7, 4e-7, 0],
                          [0, 0, -5e-7]]
        c["valid1"][:8] = True
        c["uv2"][:4] = [[0, 0], [1e-3, 2e-3], [-1e-2, 5], [100, 7e-4]]
        c["valid2"][:4] = True
    elif case == "non-finite":
        c["lines"][:6] = [[np.nan, 0, 1], [0, np.inf, 1], [1, 0, -np.inf], [np.inf, np.inf, 0],
                          [0, 0, np.nan], [-np.inf, 1, np.inf]]
        c["valid1"][:8] = True
        c["uv2"][:6] = [[np.nan, 10], [10, np.inf], [np.inf, np.inf], [-np.inf, 3],
                        [3e38, 3e38], [5, np.nan]]
        c["sigma2"][6:9] = [np.nan, np.inf, -1.0]
        c["valid2"][:9] = True
    elif case == "rows invalid":
        c["valid1"][:] = False
    elif case == "ties":
        for m in (5, 9, 40):
            c["d2"][m] = c["d2"][5]
            c["uv2"][m] = c["uv2"][5]
            c["sigma2"][m] = c["sigma2"][5]
            c["valid2"][m] = True
        c["d1"][:4] = c["d2"][5]
        c["lines"][:4] = [0.0, 1.0, -c["uv2"][5, 1]]   # the row v = v2 of column 5
        c["valid1"][:4] = True
    elif case == "wide":
        # the tie across the chunk boundary: a column in each chunk
        half = -(-M // 2)
        c["d2"][half + 3] = c["d2"][7]
        c["uv2"][half + 3] = c["uv2"][7]
        c["sigma2"][half + 3] = c["sigma2"][7]
        c["valid2"][[7, half + 3]] = True
        c["d1"][0] = c["d2"][7]
        c["lines"][0] = [0.0, 1.0, -c["uv2"][7, 1]]
        c["valid1"][0] = True
    elif case == "one row":
        c["valid1"][0] = True
    elif case != "pair":
        raise ValueError(case)
    return c


# the dense mode's edge cases (csrc/match.cu match_best2_dense_kernel)
DENSE_CASES = ("pool", "no valid column", "no valid row", "tie across tiles",
               "repeated column", "last tile only", "mask", "one row")


def dense_case(rng, case: str, tile: int, N: int = 300, M: int | None = None) -> dict:
    """An unmasked (or bool-masked) match's inputs as numpy arrays,
    ``DENSE_CASES``, side 2 of ``M`` columns (2 tile + 37 by default: two
    tiles of ``tile`` valid columns and a ragged third): a pool against a
    frame (the valid rows in the first slots, each a frame feature with a
    few bits flipped); no valid column; no valid row; a tie across the first tile boundary (all
    columns valid, columns tile - 1 and tile equal, rows 0 and 3 their
    copy); a column repeated in the same tile and in the last one (3, 5, M
    - 1); a mask under which row 1 admits only column M - 2, in the last
    tile; a random mask with rows that admit nothing; a single row. d1, d2
    uint32 words, valid1, valid2 and ``mask`` (a bool [N, M], or None)."""
    import numpy as np
    M = 2 * tile + 37 if M is None else M
    if case == "one row":
        N = 1
    d2 = rng.integers(0, 1 << 32, (M, 8), dtype=np.uint64).astype(np.uint32)
    src = rng.integers(0, M, N)
    d1 = d2[src] ^ (rng.integers(0, 1 << 6, (N, 8)).astype(np.uint32)
                    & rng.integers(0, 2, (N, 8)).astype(np.uint32) * np.uint32(0xffffffff))
    valid1 = np.arange(N) < max(1, (2 * N) // 5)
    valid1 &= rng.random(N) > 0.1
    valid2 = rng.random(M) > 0.3
    mask = None
    if case == "no valid column":
        valid2[:] = False
    elif case == "no valid row":
        valid1[:] = False
    elif case == "tie across tiles":
        valid2[:] = True
        d2[tile] = d2[tile - 1]
        d1[[0, 3]] = d2[tile - 1]
        valid1[[0, 3]] = True
    elif case == "repeated column":
        d2[[5, M - 1]] = d2[3]
        valid2[[3, 5, M - 1]] = True
        d1[0] = d2[3]
        valid1[0] = True
    elif case == "last tile only":
        mask = rng.random((N, M)) > 0.5
        mask[1] = False
        mask[1, M - 2] = valid1[1] = valid2[M - 2] = True
    elif case == "mask":
        mask = rng.random((N, M)) > 0.7
        mask[[2, 4]] = False
        valid1[[2, 4]] = True
    elif case not in ("pool", "one row"):
        raise ValueError(case)
    if case == "one row":
        valid1[0] = True
    return dict(d1=d1, d2=d2, valid1=valid1, valid2=valid2, mask=mask)


def dense_args(torch, c: dict, dev):
    """``match_best2``'s (d1, d2, valid1, valid2, mask) on ``dev`` for a
    ``dense_case``."""
    import numpy as np
    up = lambda a: torch.as_tensor(a.view(np.int32) if a.dtype == np.uint32 else a).to(dev)
    return (up(c["d1"]), up(c["d2"]), up(c["valid1"]), up(c["valid2"]),
            None if c["mask"] is None else up(c["mask"]))


def epipolar_args(torch, match, c: dict, dev):
    """``match_best2``'s (d1, d2, valid1, valid2, EpipolarMask) on ``dev`` for
    an ``epipolar_case``: its lines, or ``match.epipolar_lines`` of its
    keypoints and fundamental matrix."""
    import numpy as np
    up = lambda a: torch.as_tensor(a.view(np.int32) if a.dtype == np.uint32 else a).to(dev)
    lines = up(c["lines"]) if "lines" in c else match.epipolar_lines(up(c["uv1"]), up(c["F12"]))
    return (up(c["d1"]), up(c["d2"]), up(c["valid1"]), up(c["valid2"]),
            match.EpipolarMask(lines, up(c["uv2"]), up(c["sigma2"]), c["thresh"]))


def window_args(torch, match, c: dict, dev, lo: int = -1, hi: int = 1):
    """``match_best2``'s (d1, d2, valid1, valid2, WindowMask) on ``dev`` for a
    ``window_case``."""
    import numpy as np
    up = lambda a: torch.as_tensor(a.view(np.int32) if a.dtype == np.uint32 else a).to(dev)
    u = {k: up(v) for k, v in c.items()}
    return (u["d1"], u["d2"], u["valid1"], u["valid2"],
            match.WindowMask(u["uv1"], u["radius"], u["lvl1"], u["uv2"], u["lvl2"], lo, hi))


def lio_state64(torch, x):
    """A State with float64 fields."""
    return type(x)(*[t.double() for t in x])


def lio_phase(torch, dev, cases, log=print, sync=lambda: None, timer=None) -> dict:
    """Phase 5, the scan step's four kernels against their plain versions
    on ``dev`` (a CUDA device): ``cases`` is [(label, lio_scan_step's
    arguments)]. For each: ``esekf_predict`` against ``predict_plain``;
    ``lio_rows`` at the prediction against ``rows_plain`` (neighbour sets,
    the normal equations; or else no farther from ``rows_plain`` run in
    float64 than it); each ``esekf_step`` launch against ``esekf.map_step``
    / ``posterior_covariance`` run in float64 on the kernel's own sums and
    iterate; the whole update against ``scan_update_plain`` (``LIO_TOL``);
    the same bits on a second call; no host sync in a scan step. The first
    case is timed (``timer(fn, reps) -> ms``). Returns the three kernel
    rows; raises RuntimeError where a check fails."""
    import numpy as np

    from tc2li_slam_torch.estimation import esekf
    from tc2li_slam_torch.ops.kernels import lio as klio
    from tc2li_slam_torch.slam import lio

    timer = timer or (lambda fn, reps: float("nan"))
    rows, err = {}, {"esekf_predict": 0.0, "lio_fences": 0.0, "lio_rows": 0.0, "esekf_step": 0.0}

    def dmax(a, b, scale=None):
        a, b = a.detach().double().cpu(), b.detach().double().cpu()
        d = torch.where(torch.isnan(a) & torch.isnan(b), torch.zeros_like(a), (a - b).abs())
        if scale is not None:
            d = d / scale
        d = float(d.max()) if d.numel() else 0.0
        return d if d == d else float("inf")

    def vdist(a, b, r):
        # |v_i| <= sqrt(N_ii sum z^2): v over that scale (of the rows ``r``)
        sc = torch.sqrt(torch.clamp(r.N.diagonal().double().cpu() * float(r.zz), min=1e-30))
        return dmax(a, b, sc)

    def finite_dmax(a, b, scale=None):
        # where both are finite; and inf where one is finite and the other not
        # everywhere (a NaN spreads further through dense products than
        # through F's blocks)
        fa, fb = bool(torch.isfinite(a).all()), bool(torch.isfinite(b).all())
        if fa != fb:
            return float("inf")
        both = (torch.isfinite(a) & torch.isfinite(b)).cpu()
        return dmax(a.cpu()[both], b.cpu()[both], None if scale is None else scale[both])

    for ci, (label, args) in enumerate(cases):
        filt0, m, scan, t_pts, sv, gyro, acc, dts, trel, noise, cfg = args
        k = cfg.max_iters
        # the prediction, alone and with the pool's fence table in its launch
        fk, Rk, pk = klio.esekf_predict(filt0, gyro, acc, dts, noise)
        fk2, Rk2, pk2, fences = klio.predict_with_fences(filt0, gyro, acc, dts, noise, m.keys)
        fp, Rp, pp = klio.predict_plain(filt0, gyro, acc, dts, noise)
        sync()
        fenced_same = bit_equal(torch, [fk.P, *fk.x, Rk, pk], [fk2.P, *fk2.x, Rk2, pk2])
        d_pred = {"state": max(finite_dmax(a, b) for a, b in zip(fk.x, fp.x)),
                  "P": finite_dmax(fk.P, fp.P, diag_scale(torch, fp.P)),
                  "traj": max(dmax(Rk, Rp), dmax(pk, pp))}
        pts, pv = lio.scan_points(fk, scan, t_pts, sv, trel, Rk, pk, cfg)
        M = pts.shape[0]
        # the rows at the prediction
        w = klio.LioWork(filt0, fk, m, pts, pv, cfg, fences)
        slots = torch.empty((M, 5), dtype=torch.int32, device=dev)
        w.rows(0, slots)
        d_fence = dmax(fences, klio.fences_plain(m.keys, w.lg))
        Nk, vk, ck = w.sums()
        r32 = klio.rows_plain(m, pts, pv, fk.x, cfg, with_slots=True)
        r64 = klio.rows_plain(m.replace(points=m.points.double()), pts.double(), pv,
                              lio_state64(torch, fk.x), cfg)
        sync()
        live = (pv & torch.all(torch.isfinite(pts), -1)).cpu()
        same_nb = torch.all(torch.sort(slots.long().cpu(), -1)[0]
                            == torch.sort(r32.slots.cpu(), -1)[0], -1)
        nb_frac = float(same_nb[live].double().mean()) if bool(live.any()) else 1.0
        sc = diag_scale(torch, r64.N)
        d_rows = {"N": dmax(Nk, r32.N, sc), "v": vdist(vk, r32.v, r64),
                  "N64": dmax(Nk, r64.N, sc), "v64": vdist(vk, r64.v, r64),
                  "plain N64": dmax(r32.N, r64.N, sc), "plain v64": vdist(r32.v, r64.v, r64)}
        rows_out = [key for key in ("N", "v") if d_rows[key] > LIO_TOL["rows"]
                    and d_rows[key + "64"] > d_rows["plain " + key + "64"]]
        counts = (int(ck), int(r32.n_ok), int(r64.n_ok))
        # each step launch against the float64 plain step on its own sums
        r_inv = 1.0 / cfg.meas_cov
        x0_64 = lio_state64(torch, fk.x)
        P0i = esekf.prior_information(fk.P.double())
        x64, conv = x0_64, torch.zeros((), dtype=torch.bool, device=dev)
        iters = torch.zeros((), dtype=torch.int32, device=dev)
        d_step = 0.0
        for i in range(k):
            if i:
                w.rows(i)
            N, v, _ = w.sums()
            w.step(i)
            x64, conv, iters = esekf.map_step(*lio_full(torch, N, v, r_inv), x64, x0_64, P0i,
                                              conv, iters)
            d_step = max(d_step, dmax(w.iterate(), klio.state_vector(x64)))
            x64 = klio.state_of(w.iterate().clone())   # the next launch starts from the kernel's
        w.rows(k)
        N, v, _ = w.sums()
        w.step(k, final=True)
        x64r = klio.state_of(w.iterate().float().double())   # the state as written
        P64 = esekf.posterior_covariance(lio_full(torch, N, v, r_inv)[0], x64r, x0_64, P0i)
        res = w.result()
        f_fin, bad64 = klio.guard(filt0, esekf.Filter(klio.state_of(w.iterate().float()),
                                                      P64.float()))
        sync()
        d_fin = dmax(res.filt.P, f_fin.P, diag_scale(torch, P64)) if not bool(res.bad) else \
            (0.0 if torch.equal(res.filt.P, filt0.P) else float("inf"))
        # the whole update against the plain version, twice
        got = klio.scan_update(filt0, fk, m, pts, pv, cfg, fences)
        again = klio.scan_update(filt0, fk, m, pts, pv, cfg, fences)
        ref = klio.scan_update_plain(filt0, fk, m, pts, pv, cfg)
        f64 = lambda f: esekf.Filter(lio_state64(torch, f.x), f.P.double())
        ref64 = klio.scan_update_plain(f64(filt0), f64(fk), m.replace(points=m.points.double()),
                                       pts.double(), pv, cfg)
        sync()
        d_state = max(dmax(a, b) for a, b in zip(got.filt.x, ref.filt.x))
        Pg, Pr = got.filt.P.double().cpu(), ref.filt.P.double().cpu()
        p_out = bool(((Pg - Pr).abs() > LIO_TOL["P_rtol"] * Pr.abs() + 1e-8).any())
        # else no farther from the plain version run in float64 than it is
        sc64 = diag_scale(torch, ref64.filt.P)
        d_P64 = (dmax(got.filt.P, ref64.filt.P, sc64), dmax(ref.filt.P, ref64.filt.P, sc64))
        p_out = p_out and d_P64[0] > d_P64[1]
        twice = bit_equal(torch, [got.filt.P, *got.filt.x, got.points_world, got.n_iters,
                                  got.n_effective, got.bad],
                          [again.filt.P, *again.filt.x, again.points_world, again.n_iters,
                           again.n_effective, again.bad])
        whole = dict(n_iters=(int(got.n_iters), int(ref.n_iters)), bad=(bool(got.bad),
                     bool(ref.bad)), n_eff=(int(got.n_effective), int(ref.n_effective)))
        log(f"lio {label} (M {M}, {int(pv.sum())} valid, map {int(m.count)} points, "
            f"{w.ncols} columns, max_iters {k}): lio_fences (in the predict launch) against "
            f"the plain version {d_fence:g} ({w.n_fences} fences, stride 2^{w.lg}), the "
            f"prediction bit-equal with and without them {fenced_same}; esekf_predict state "
            f"{d_pred['state']:.2e}, P {d_pred['P']:.2e} (scaled), trajectory "
            f"{d_pred['traj']:.2e}; lio_rows neighbour sets equal {nb_frac:.5f}, "
            + ", ".join(f"{key} {val:.2e}" for key, val in d_rows.items())
            + f", inliers kernel / plain / float64 {counts}; esekf_step iterate against "
            f"the float64 plain step {d_step:.2e}, final P {d_fin:.2e} (scaled), bad "
            f"{bool(res.bad)} / {bool(bad64)}; the update against the plain version: state "
            f"{d_state:.2e}, P outside rtol {LIO_TOL['P_rtol']} and farther from float64 {p_out} "
            f"(scaled from float64: kernel {d_P64[0]:.2e}, plain {d_P64[1]:.2e}), {whole}; the same "
            f"bits on a second call {twice}")
        faults = []
        if d_pred["state"] > LIO_TOL["predict_state"] or d_pred["P"] > LIO_TOL["predict_P"] \
                or d_pred["traj"] > LIO_TOL["predict_state"]:
            faults.append("esekf_predict")
        if d_fence != 0.0 or not fenced_same:
            faults.append("lio_fences")
        if nb_frac < LIO_TOL["nbr_equal"] or rows_out:
            faults.append(f"lio_rows {rows_out}")
        if d_step > LIO_TOL["step_state"] or d_fin > LIO_TOL["step_P"] \
                or bool(res.bad) != bool(bad64):
            faults.append("esekf_step")
        if d_state > LIO_TOL["state"] or p_out or whole["n_iters"][0] != whole["n_iters"][1] \
                or whole["bad"][0] != whole["bad"][1] \
                or abs(whole["n_eff"][0] - whole["n_eff"][1]) > LIO_TOL["n_eff"] or not twice:
            faults.append("the update")
        if "bad" in label and not (bool(got.bad) and torch.equal(got.filt.P, filt0.P)
                                   and all(torch.equal(a, b) for a, b in
                                           zip(got.filt.x, filt0.x))):
            faults.append("the bad-IMU revert")
        if faults:
            raise RuntimeError(f"lio kernels disagree with their plain versions on {label}: "
                               f"{faults}")
        err["esekf_predict"] = max(err["esekf_predict"], d_pred["state"])
        err["lio_fences"] = max(err["lio_fences"], d_fence)
        err["lio_rows"] = max(err["lio_rows"], d_rows["N"])
        err["esekf_step"] = max(err["esekf_step"], d_step)
        if ci:
            continue
        n_sync = syncs_of(torch, lambda: lio.lio_scan_step(*args))
        log(f"lio: {n_sync} host syncs in a scan step")
        if n_sync:
            raise RuntimeError(f"lio_scan_step synchronised the host {n_sync} times")
        # times: the first case, behind a backlog
        n_live = int((dts > 0).sum())
        N_s = gyro.shape[0]
        ms_k = timer(lambda: klio.esekf_predict(filt0, gyro, acc, dts, noise), 50)
        ms_p = timer(lambda: klio.predict_plain(filt0, gyro, acc, dts, noise), 3)
        b_p = bound(2 * 4 * klio.PACKED_FLOATS + LIO_PREDICT_BYTES_SAMPLE * N_s,
                    LIO_PREDICT_OPS_SAMPLE * n_live)
        rows["esekf_predict"] = dict(
            source="tc2li_slam_torch/csrc/lio.cu",
            replaces="tc2li_slam_tpu/estimation/esekf.py:192", ms=ms_k, plain_ms=ms_p,
            bound_ms=b_p[0], bound_by=b_p[1], library_ms=None)
        # the prediction at 10, 20 and 40 live samples and in 1,024 slots
        by_window = {}
        for n_w, slots in ((10, 0), (20, 0), (40, 0), (40, 1024)):
            gw, aw, dw = (t.to(dev) for t in predict_window(torch, n_w, slots))
            fk_w, Rk_w, pk_w = klio.esekf_predict(filt0, gw, aw, dw, noise)
            fp_w, Rp_w, pp_w = klio.predict_plain(filt0, gw, aw, dw, noise)
            d_s = max(finite_dmax(a, b) for a, b in zip(list(fk_w.x) + [Rk_w, pk_w],
                                                        list(fp_w.x) + [Rp_w, pp_w]))
            d_P = finite_dmax(fk_w.P, fp_w.P, diag_scale(torch, fp_w.P))
            label_w = f"{n_w} live" + (f" in {slots} slots" if slots else "")
            if d_s > LIO_TOL["predict_state"] or d_P > LIO_TOL["predict_P"]:
                raise RuntimeError(f"esekf_predict at {label_w}: state {d_s:.2e}, P {d_P:.2e} "
                                   f"from predict_plain")
            by_window[label_w] = timer(lambda: klio.esekf_predict(filt0, gw, aw, dw, noise), 50)
        log("lio: esekf_predict ms on the device by window (within LIO_TOL of predict_plain): "
            + ", ".join(f"{k} {v:.4f}" for k, v in by_window.items()))
        # the fence table has no launch of its own: its row's ms is the
        # predict launch with its fence blocks, beside it without them, in
        # turns
        with_f = lambda: klio.predict_with_fences(filt0, gyro, acc, dts, noise, m.keys)
        alone = lambda: klio.esekf_predict(filt0, gyro, acc, dts, noise)
        ms_pf = [timer(fn, 50) for fn in (with_f, alone, alone, with_f)]
        ms_f, ms_alone = (ms_pf[0] + ms_pf[3]) / 2, (ms_pf[1] + ms_pf[2]) / 2
        ms_fp = timer(lambda: klio.fences_plain(m.keys, w.lg), 20)
        # the keys at the fences read, the table and its count written
        b_f = bound(4 * w.n_fences + 4 * (w.n_fences + 1))
        rows["lio_fences"] = dict(
            source="tc2li_slam_torch/csrc/lio.cu", replaces="tc2li_slam_tpu/ops/voxel_map.py:154",
            ms=ms_f, plain_ms=ms_fp, bound_ms=b_f[0], bound_by=b_f[1], library_ms=None,
            predict_alone_ms=ms_alone)
        ms_k = timer(lambda: w.rows(1), 30)
        ms_p = timer(lambda: klio.rows_plain(m, pts, pv, fk.x, cfg), 3)
        # the points and the occupied part of the pool read once; the live
        # points' operations at the float32 and float64 rates
        b_r = bound(M * 13 + 4 * 36 + int(m.count) * 16 + w.blocks * w.entries * 8)
        n_pts = int((pv & torch.all(torch.isfinite(pts), -1)).sum())
        t_ops = 1e3 * n_pts * (LIO_ROWS_OPS_POINT / PEAK_SIMPLE_S
                               + LIO_ROWS_OPS64_POINT / PEAK_F64_S)
        b_r = (t_ops, "operations") if t_ops > b_r[0] else b_r
        rows["lio_rows"] = dict(
            source="tc2li_slam_torch/csrc/lio.cu", replaces="tc2li_slam_tpu/slam/lio.py:46",
            ms=ms_k, plain_ms=ms_p, bound_ms=b_r[0], bound_by=b_r[1], library_ms=None)

        def steps():
            for i in range(k):
                w.step(i)
            w.step(k, final=True)

        ms_k = timer(steps, 30) / (k + 1)
        # the three kinds apart: the first starts from the prediction and
        # inverts P0, the final one inverts the posterior information and
        # runs the guard
        ms_kinds = {"first_ms": timer(lambda: w.step(0), 30),
                    "middle_ms": timer(lambda: w.step(1), 30),
                    "final_ms": timer(lambda: w.step(k, final=True), 30)}
        N, v, _ = w.sums()
        Nf, vf = (t.float() for t in lio_full(torch, N, v, r_inv))
        P0f = esekf.prior_information(fk.P)
        cf, itf = torch.zeros((), dtype=torch.bool, device=dev), torch.zeros(
            (), dtype=torch.int32, device=dev)
        ms_p = timer(lambda: esekf.map_step(Nf, vf, fk.x, fk.x, P0f, cf, itf), 3)
        t_ops = 1e3 * (k * LIO_STEP_OPS["step"] + LIO_STEP_OPS["first"]
                       + LIO_STEP_OPS["final"]) / (k + 1) / PEAK_F64_S
        b_s = bound(w.blocks * w.entries * 8 + 2 * 4 * klio.PACKED_FLOATS + 2 * 8 * 567)
        b_s = (t_ops, "operations") if t_ops > b_s[0] else b_s
        rows["esekf_step"] = dict(
            source="tc2li_slam_torch/csrc/lio.cu",
            replaces="tc2li_slam_tpu/estimation/esekf.py:266", ms=ms_k, plain_ms=ms_p,
            bound_ms=b_s[0], bound_by=b_s[1], library_ms=None, **ms_kinds)
        ms_u = timer(lambda: klio.scan_update(filt0, fk, m, pts, pv, cfg, fences), 20)
        ms_up = timer(lambda: klio.scan_update_plain(filt0, fk, m, pts, pv, cfg), 3)
        log(f"lio {label}: the predict launch with the lio_fences blocks {ms_f:.4f} ms on the "
            f"device, without them {ms_alone:.4f} (readings "
            + " / ".join(f"{v:.4f}" for v in ms_pf)
            + f"), the table's bound {b_f[0]:.6f} ({b_f[1]}), plain {ms_fp:.4f}; "
            f"esekf_predict {rows['esekf_predict']['ms']:.4f} ms on the device "
            f"(N {N_s}, {n_live} live), bound {b_p[0]:.6f} ({b_p[1]}), plain "
            f"{rows['esekf_predict']['plain_ms']:.4f}; lio_rows {rows['lio_rows']['ms']:.4f} "
            f"(M {M}, {w.blocks} blocks), bound {b_r[0]:.6f} ({b_r[1]}), plain "
            f"{rows['lio_rows']['plain_ms']:.4f}; esekf_step {ms_k:.4f} a launch (the mean of "
            f"a scan step's {k + 1}; first / middle / final "
            + " / ".join(f"{v:.4f}" for v in ms_kinds.values())
            + f"), bound {b_s[0]:.6f} ({b_s[1]}, float64), plain step "
            f"{ms_p:.4f}; the update's {2 * k + 3} launches {ms_u:.4f}, its plain version "
            f"{ms_up:.4f}")
    for name in rows:
        rows[name]["max_abs_err"] = err[name]
    return rows


def lio_full(torch, N, v, r_inv):
    """The 23-dim H^T R^-1 H and H^T R^-1 z of the rows' sums over their
    first nc columns."""
    nc = N.shape[0]
    Nf = torch.zeros((23, 23), dtype=N.dtype, device=N.device)
    vf = torch.zeros(23, dtype=N.dtype, device=N.device)
    Nf[:nc, :nc] = N * r_inv
    vf[:nc] = v * r_inv
    return Nf, vf


def scan_rings(n_rings: int, n_points: int, seed: int = 0):
    """An organized scan of ``n_rings`` azimuth rings, each
    tests/test_scan_features.py's ``ring_scene`` drawn from its own seed
    (a square room of half-extent 10 m, a thin pole at ~4 m) and lifted to
    an elevation between -24.8 and +2 degrees (an HDL-64E's span): the walls
    and the pole are vertical, so every ring sees the same planes.
    Returns float32 points [R, N, 3]."""
    import numpy as np
    out = []
    for e, elev in enumerate(np.linspace(np.deg2rad(-24.8), np.deg2rad(2.0), n_rings)):
        rng = np.random.default_rng(seed + e)
        ang = np.linspace(-np.pi, np.pi, n_points, endpoint=False)
        d = np.stack([np.cos(ang), np.sin(ang)], -1)
        t_wall = 10.0 / np.maximum(np.abs(d[:, 0]), np.abs(d[:, 1]))
        rng_w = t_wall + rng.normal(0, 0.003, n_points)
        pole = np.abs(ang - 0.7) < 2.2 * np.pi / n_points
        r = np.where(pole, 4.0 + rng.normal(0, 0.03, n_points), rng_w)
        out.append(np.stack([r * np.cos(ang), r * np.sin(ang), r * np.tan(elev)], -1))
    return np.stack(out).astype(np.float32)


def scan_gate_near(sf, points, valid, blind: float, rel: float = 1e-5):
    """[R, N] bool: points whose scan-feature masks could follow a float gate
    that lies within ``rel`` (relative) of its threshold while the other
    gates of its test pass: the gates of ``ops.scan_features`` re-derived in
    float64 with numpy, and each point within reach of such a gate (a plane
    window's G points, a neighbour). ``sf`` is the scan-features module."""
    import numpy as np
    p = np.asarray(points, np.float64)
    valid = np.asarray(valid, bool)
    sh = lambda x, s: np.roll(x, -s, axis=1)      # the point s slots ahead
    sq = lambda v: np.sum(v * v, -1)

    def gate(a, b, less=True):
        """(a < b or a > b, whether a lies within rel of b)"""
        close = np.abs(a - b) <= rel * np.maximum(np.maximum(np.abs(a), np.abs(b)), 1e-30)
        return (a < b) if less else (a > b), close

    def test(*gates):
        """the gates whose flip can flip their conjunction"""
        out = np.zeros(p.shape[:2], bool)
        for i, (_, close) in enumerate(gates):
            others = np.ones_like(out)
            for j, (ok, c) in enumerate(gates):
                if j != i:
                    others &= ok | c
            out |= close & others
        return out

    r = np.linalg.norm(p, axis=-1)
    hit = gate(r, blind, less=False)[1] & valid
    valid = valid & (r > blind)
    G = sf.GROUP_G
    chord = sh(p, G - 1) - p
    chord_n2 = np.maximum(sq(chord), 1e-12)
    max_p2l, max_sp, min_sp = np.zeros_like(r), np.zeros_like(r), np.full_like(r, np.inf)
    win_ok = valid.copy()
    for k in range(1, G - 1):
        max_p2l = np.maximum(max_p2l, sq(np.cross(sh(p, k) - p, chord)) / chord_n2)
        s = sq(sh(p, k) - sh(p, k - 1))
        max_sp, min_sp = np.maximum(max_sp, s), np.minimum(min_sp, s)
        win_ok &= sh(valid, k)
    win_ok &= sh(valid, G - 1)
    hit |= win_ok & test(gate(max_p2l * sf.P2L_RATIO, chord_n2),
                         gate(max_sp, (sf.DIS_A * r + sf.DIS_B) ** 2),
                         gate(max_sp, sf.LIMIT_MAXMID * np.maximum(min_sp, 1e-12)))
    nxt, prv = sh(p, 1), sh(p, -1)
    d_fwd = sq(nxt - p)
    d_prev = np.roll(d_fwd, 1, axis=1)
    a, b = p - prv, nxt - p
    cos_i = np.sum(a * b, -1) / (np.maximum(np.linalg.norm(a, axis=-1), 1e-9)
                                 * np.maximum(np.linalg.norm(b, axis=-1), 1e-9))
    hit |= valid & sh(valid, -1) & sh(valid, 1) & test(
        gate(180.0 - np.rad2deg(np.arccos(np.clip(cos_i, -1, 1))), sf.SMALLP_INTERSECT, False),
        gate(np.maximum(d_prev, d_fwd) / np.maximum(np.minimum(d_prev, d_fwd), 1e-12),
             sf.SMALLP_RATIO))
    d_min = np.minimum(np.maximum(d_prev, 1e-12), np.maximum(d_fwd, 1e-12))
    for s in (-1, 1):
        e = sh(p, s) - p
        d_n = sq(e)
        cos_b = np.sum(p / np.maximum(r, 1e-9)[..., None] * e, -1) / np.maximum(
            np.linalg.norm(e, axis=-1), 1e-9)
        up, down = gate(cos_b, sf.JUMP_UP_COS), gate(cos_b, sf.JUMP_DOWN_COS, False)
        hit |= valid & sh(valid, s) & test(
            gate(d_n, sf.EDGE_A * sf.EDGE_A * d_min, False), (up[0] | down[0], up[1] | down[1]),
            gate(d_n, sf.EDGE_B, False), gate(r, sh(r, s)))
    reach = np.zeros_like(hit)
    for s in range(-G - 1, G + 2):
        reach |= np.roll(hit, s, axis=1)
    return reach


RENDER_WORKERS = 7   # processes that render the synthetic stereo pairs


def _render_pair(args):
    """One stereo pair of the synthetic world (a worker of ``render_pairs``)."""
    planes, cam_rig, T_wb = args
    from tc2li_slam_torch.io import synthetic as syn
    return syn.render_stereo(syn.World(planes=planes, surf=None), cam_rig, T_wb)


def render_pairs(cam_rig, world, poses, workers: int = RENDER_WORKERS):
    """The (img_l, img_r) of each world-from-body pose, rendered by
    ``workers`` processes that end with this call (the renderer is numpy on
    one core, ~1.5-3 s a KITTI-sized pair)."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor
    with ProcessPoolExecutor(max_workers=workers,
                             mp_context=multiprocessing.get_context("spawn")) as pool:
        return list(pool.map(_render_pair, [(world.planes, cam_rig, T) for T in poses],
                             chunksize=2))


def loop_phase(torch, dev, cam_rig, cfg, n_frames=N_LOOP, world=None, voc_stride=7, log=print,
               reset_counts=lambda: None, read_counts=dict, workers=RENDER_WORKERS):
    """Phase 4f on ``dev``: the circle with the gauge ramp through
    ``System.track`` with loop closing on, then the checkpoint round trip.
    ``cfg`` is the configuration without loop closing (its camera must be
    ``cam_rig``'s); ``reset_counts`` is called just before the tracked run and
    ``read_counts`` just after it. Returns a dict of what was measured;
    raises RuntimeError where a check fails."""
    import inspect
    import tempfile
    import warnings

    import numpy as np

    from tc2li_slam_torch.geom import lie
    from tc2li_slam_torch.io import synthetic as syn
    from tc2li_slam_torch.ops import bow, orb
    from tc2li_slam_torch.ops.kernels import match
    from tc2li_slam_torch.slam import checkpoint, loop_closing, system as sys_mod

    S = sys_mod.TrackingState
    cuda = torch.device(dev).type == "cuda"
    t0 = time.perf_counter()
    if world is None:
        world = syn.make_world(np.random.default_rng(0))
    # the circle of radius 4 m that tests/test_loop_e2e.py drives, at 10 Hz
    poses = syn.trajectory_poses(syn.CircleTrajectory(omega=0.5, speed=2.0), n_frames + 2)
    frames = [(0.1 * i, img_l, img_r, T_wb) for i, ((img_l, img_r), T_wb) in enumerate(
        zip(render_pairs(cam_rig, world, poses, workers), poses))]
    gt = np.stack([T_wb @ syn.body_from_cam() for T_wb in poses])
    t_gen = time.perf_counter() - t0
    t0 = time.perf_counter()
    descs = []
    for _, img_l, _, _ in frames[:n_frames:voc_stride]:
        kp = orb.extract(torch.as_tensor(img_l).to(dev), cfg.orb.n_features, cfg.orb.n_levels)
        descs.append(kp.desc[kp.valid].cpu().numpy().view(np.uint32))
    voc = bow.train_vocabulary(np.concatenate(descs), k=8, depth=4, seed=0, device=dev)
    log(f"loop closing: {n_frames + 2} frames of the circle rendered in {t_gen:.1f} s by "
        f"{workers} processes; "
        f"vocabulary of {voc.n_words} words from {sum(len(d) for d in descs)} descriptors of "
        f"{len(descs)} frames, trained on the host in {time.perf_counter() - t0:.1f} s")

    cfg = dataclasses.replace(
        cfg, loop_closing=True, loop_min_gap=15, loop_min_kf=18,
        lidar=dataclasses.replace(cfg.lidar, enabled=False),
        tracking=dataclasses.replace(cfg.tracking, kf_max_interval=3, triangulate=True))
    slam = sys_mod.System(cfg, dev, voc=voc)

    def trajectory(kf_T, n):
        """World-from-camera poses of the first ``n`` frames against the
        keyframe poses ``kf_T`` (no flush: the map is read as it stands)."""
        T_rel = torch.stack([T for *_, T in slam.traj[:n]])
        ref = torch.as_tensor([max(r, 0) for _, _, r, _ in slam.traj[:n]], device=kf_T.device)
        return torch.linalg.inv(T_rel @ kf_T[ref]).cpu().numpy()

    def edge_residual(kf_T, kf, cand, S_loop):
        rel = kf_T[kf] @ lie.se3_inverse(kf_T[cand])
        return float(torch.linalg.norm(lie.se3_log(lie.se3_inverse(S_loop) @ rel)))

    closures = []
    close_loop = loop_closing.close_loop
    close_iters = inspect.signature(close_loop).parameters["iters"].default
    caught_now = [[]]    # the warnings list of the frame in flight

    def spy(m, kf_id, cand_id, S_loop, **kw):
        """``close_loop``, and what the phase reports of it (the syncs the
        report itself makes are counted apart)."""
        out = close_loop(m, kf_id, cand_id, S_loop, **kw)
        n0 = n_syncs(caught_now[0])
        n_done = len(slam.traj)
        closures.append(dict(
            frame=slam.frame_idx, kf=kf_id, cand=cand_id, n_traj=n_done, map_before=m,
            S=S_loop, n_kf=kw["n_kf"], iters=kw.get("iters", close_iters),
            edges=int(loop_closing.loop_edges(m, kf_id, cand_id, S_loop, kw["n_kf"]).i.shape[0]),
            residual=(edge_residual(m.kf_T_cw, kf_id, cand_id, S_loop),
                      edge_residual(out.kf_T_cw, kf_id, cand_id, S_loop)),
            ate_before=syn.ate_rmse(trajectory(m.kf_T_cw, n_done), gt[:n_done])))
        closures[-1]["report_syncs"] = n_syncs(caught_now[0]) - n0
        return out

    loop_closing.close_loop = spy
    states, syncs, frame_ms, busy = [], [], [], []
    reset_counts()
    xi = torch.as_tensor(np.asarray(LOOP_DRIFT_XI, np.float32) / (LOOP_DRIFT[1] - LOOP_DRIFT[0]))
    W_step = lie.se3_exp(xi.to(dev))
    try:
        for k, (t, img_l, img_r, _) in enumerate(frames[:n_frames]):
            if LOOP_DRIFT[0] <= k < LOOP_DRIFT[1]:
                inject_drift(torch, lie, slam, W_step)
            n_events = slam.n_loop_verified + slam.n_recover + slam.n_reloc
            t0 = time.perf_counter()
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                caught_now[0] = caught
                if cuda:
                    torch.cuda.set_sync_debug_mode("warn")
                try:
                    slam.track(img_l, img_r, t)
                finally:
                    if cuda:
                        torch.cuda.set_sync_debug_mode("default")
            if cuda:
                torch.cuda.synchronize()
            frame_ms.append(1e3 * (time.perf_counter() - t0))
            syncs.append(n_syncs(caught))
            states.append(slam.state)
            # a frame that verified a candidate, recovered or relocalized
            # reads more than its one transfer, and so does a ramp frame
            busy.append(slam.n_loop_verified + slam.n_recover + slam.n_reloc > n_events
                        or LOOP_DRIFT[0] <= k < LOOP_DRIFT[1])
            if closures and "ate_after" not in closures[-1]:
                c = closures[-1]
                c["ate_after"] = syn.ate_rmse(trajectory(slam.map.kf_T_cw, c["n_traj"]),
                                              gt[:c["n_traj"]])
                c["inliers"] = slam.last_loop[1].n_inliers
    finally:
        loop_closing.close_loop = close_loop
    counts, modes = read_counts(), dict(match.launches_by_mode)
    stats = slam.timers.stats()
    est = slam.trajectory_world_from_cam()
    out = dict(slam=slam, closures=closures, counts=counts, modes=modes, frame_ms=frame_ms,
               ate=syn.ate_rmse(est, gt[:n_frames]), n_kf=slam.n_kf_host)
    detect = stats.get("loop_detect", {"total_s": 0.0, "n": 0})
    closing = stats.get("loop_closing", {"total_s": 0.0, "n": 0})
    log(f"loop closing: {n_frames} frames, {slam.n_kf_host} keyframes, {int(slam.map.n_lm)} "
        f"landmarks; "
        f"loops closed {slam.n_loops_closed}, candidates verified {slam.n_loop_verified}, "
        f"detections {detect['n']} ({1e3 * detect['total_s'] / max(detect['n'], 1):.3f} ms each "
        f"by stage events), closing attempts {closing['n']} "
        f"({1e3 * closing['total_s'] / max(closing['n'], 1):.1f} ms each); ATE of all frames "
        f"{out['ate']:.4f} m; matcher launches by call shape {modes}")
    for c in closures:
        log(f"loop closing: closure at frame {c['frame']}: keyframe {c['kf']} -> candidate "
            f"{c['cand']}, {c['inliers']} inliers, {c['edges']} edges, loop edge residual "
            f"{c['residual'][0]:.4f} -> {c['residual'][1]:.4f}, ATE of the {c['n_traj']} frames "
            f"so far {c['ate_before']:.4f} m -> {c['ate_after']:.4f} m; host syncs at that frame "
            f"{syncs[c['frame']] - c['report_syncs']} (and {c['report_syncs']} by this report), "
            f"{frame_ms[c['frame']]:.1f} ms on the host clock")
    quiet = [n for n, b in zip(syncs, busy) if not b]
    log(f"loop closing: host syncs a frame (sync debug mode, its notice included) over the "
        f"{len(quiet)} frames that verified no candidate, recovered nothing and lie outside the "
        f"ramp: mean {np.mean(quiet):.3f}, max {max(quiet)}; over the {sum(busy)} others: mean "
        f"{np.mean([n for n, b in zip(syncs, busy) if b]):.3f}")

    if any(st != S.OK for st in states):
        raise RuntimeError(f"loop closing: tracking states {states}")
    if slam.n_loops_closed < 1 or not closures:
        raise RuntimeError("loop closing: no loop was closed")
    first = closures[0]
    if first["frame"] < LOOP_PERIOD - 25:
        raise RuntimeError(f"loop closing: a closure at frame {first['frame']}, before the revisit")
    if not first["residual"][1] < 0.3 * first["residual"][0]:
        raise RuntimeError(f"loop closing: loop edge residual {first['residual']}")
    if not first["ate_after"] < first["ate_before"]:
        raise RuntimeError(f"loop closing: ATE {first['ate_before']} -> {first['ate_after']}")
    if not np.all(np.isfinite(est)) or not bool(torch.isfinite(slam.map.lm_pos).all()) \
            or not bool(torch.isfinite(slam.map.kf_T_cw).all()):
        raise RuntimeError("loop closing: non-finite poses or landmarks")
    if cuda and modes.get("none+mutual", 0) != slam.n_loop_verified + slam.n_recover:
        raise RuntimeError(f"loop closing: {modes.get('none+mutual', 0)} unmasked mutual launches "
                           f"for {slam.n_loop_verified} candidates verified and "
                           f"{slam.n_recover} recoveries")
    if max(quiet) > 2:
        raise RuntimeError(f"loop closing: {max(quiet)} host syncs at a frame that verified no "
                           f"candidate")
    if cuda:
        # device events of one verification and one closure: the first
        # closure replayed on the map as it was, under the profiler; and of
        # the closure's pose-graph optimization alone (its arguments caught
        # on one replay), beside its bound
        from torch.profiler import ProfilerActivity, profile
        from tc2li_slam_torch.solver import sim3 as sim3_mod
        pgo, pgo_args = sim3_mod.pose_graph_optimize, []
        sim3_mod.pose_graph_optimize = lambda *a, **kw: pgo_args.append((a, kw)) or pgo(*a, **kw)
        try:
            close_loop(first["map_before"], first["kf"], first["cand"], first["S"],
                       n_kf=first["n_kf"])
        finally:
            sim3_mod.pose_graph_optimize = pgo
        (pg_S, pg_edges, pg_fixed), pg_kw = pgo_args[0]
        pg_iters = pg_kw.get("iters", 20)
        pg_bound = pose_graph_bound(pg_S.shape[0], int((~pg_fixed).sum()),
                                    int(pg_edges.valid.sum()), pg_iters)
        log(f"loop closing: the closure's pose_graph_optimize: K {pg_S.shape[0]} "
            f"({7 * pg_S.shape[0]} rows planned, {7 * int((~pg_fixed).sum())} free), "
            f"{int(pg_edges.valid.sum())} valid edges of {pg_edges.valid.shape[0]}, "
            f"{int((~pg_fixed).sum())} free poses, {pg_iters} iterations; bound "
            f"{pg_bound[0]:.4f} ms ({pg_bound[1]})")
        out["pose_graph_args"] = ((pg_S, pg_edges, pg_fixed), {"iters": pg_iters})
        replay = {
            "pose_graph_optimize": lambda: pgo(pg_S, pg_edges, pg_fixed, **pg_kw),
            "verify_candidate": lambda: loop_closing.verify_candidate(
                first["map_before"], first["kf"], first["cand"],
                generator=torch.Generator(device=dev).manual_seed(0)),
            "close_loop": lambda: close_loop(first["map_before"], first["kf"], first["cand"],
                                             first["S"], n_kf=first["n_kf"]),
            "detect_candidates_device": lambda: loop_closing.detect_candidates_device(
                slam.map, first["kf"], slam.kf_words, min_gap=cfg.loop_min_gap, n_best=3,
                word_weights=slam._word_idf, n_kf=slam.n_kf_host)}
        for name, fn in replay.items():
            fn()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(PROFILE_LEAD):   # (kernel_split's lead)
                    torch.cuda._sleep(1)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                ms = 1e3 * (time.perf_counter() - t0)
            dev_events = [e for e in prof.events()
                          if e.device_type == torch.autograd.DeviceType.CUDA
                          and "spin_kernel" not in e.name]
            log(f"loop closing: {name} replayed under the profiler: {len(dev_events)} device "
                f"events, {sum(e.time_range.elapsed_us() for e in dev_events) / 1e3:.3f} ms of "
                f"device time, {ms:.1f} ms on the host clock")
            out[f"replay:{name}"] = dict(
                events=len(dev_events), host_ms=ms,
                device_ms=sum(e.time_range.elapsed_us() for e in dev_events) / 1e3)

    # checkpoint round trip: save, load on the same device, two more frames on both
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "loop.npz")
        t0 = time.perf_counter()
        checkpoint.save_system(slam, path)
        t_save = time.perf_counter() - t0
        size_mb = Path(path).stat().st_size / 1e6
        t0 = time.perf_counter()
        slam_b = checkpoint.load_system(path, cfg, dev, voc=voc)
        t_load = time.perf_counter() - t0
    if slam_b.device != slam.device or slam_b.map.lm_pos.device != slam.map.lm_pos.device \
            or not torch.equal(slam_b.map.kf_T_cw, slam.map.kf_T_cw) \
            or not torch.equal(slam_b.map.kf_desc, slam.map.kf_desc) \
            or not torch.equal(slam_b.kf_words, slam.kf_words):
        raise RuntimeError("checkpoint: the loaded system differs from the saved one")
    worst = 0.0
    for t, img_l, img_r, _ in frames[n_frames:n_frames + 2]:
        Ta = slam.track(img_l, img_r, t)
        Tb = slam_b.track(img_l, img_r, t)
        worst = max(worst, float((Ta - Tb).abs().max()))
        if slam.state != S.OK or slam_b.state != S.OK:
            raise RuntimeError(f"checkpoint: states {slam.state}, {slam_b.state} after the resume")
    log(f"checkpoint round trip on {slam_b.device}: {size_mb:.1f} MB written in {t_save:.2f} s, "
        f"loaded in {t_load:.2f} s; two more frames on both, largest pose entry difference "
        f"{worst:.2e}")
    if not worst < 1e-4:
        raise RuntimeError(f"checkpoint: resumed poses differ by {worst}")
    return out


# the pose graph's cases (pose_graph_problem): test_torch_sim3's graphs, an
# essential graph of about 400 keyframes and one of 2,048 (run_kitti_torch's
# max_kf) with its iterations cut to PG_ITERS_2048
PG_CASES = ("drift", "fixed and invalid", "scale drift", "non-finite", "covisibility 400",
            "2048 keyframes")
PG_ITERS_2048 = 2
# the kernels against the plain version run in float64, on every pose entry:
# PG_TOL (test_torch_sim3's parity tolerance) up to PG_LARGE_K keyframes;
# above, PG_TOL_LARGE, where two float64 solves of the same steps already
# disagree by more (the 2,048-keyframe graph, whose 0.9 rad of accumulated
# drift moves poses ~500 m in 2 iterations, far from the origin, where the
# world-frame tangents leave H ill-conditioned: the kernels 3.59e-4 from the
# plain version's LU on all rows, the library's Cholesky on the free rows
# 3.53e-4 from it, on the H100)
PG_TOL = 1e-4
PG_TOL_LARGE = 2e-3
PG_LARGE_K = 1000
# float64 operations an edge an iteration that any implementation of the
# step does, a fused multiply-add counted as one: its residual chain at the
# state and at the candidate (~300 each), its two 7 x 7 Jacobian blocks
# (~600 in closed form) and its symmetric share of H and g (the two
# diagonal blocks' upper triangles 2 x 28 x 7, the off-diagonal block 49 x 7,
# the gradient 2 x 7 x 7)
PG_OPS_EDGE = 2 * 300 + 600 + 2 * 28 * 7 + 49 * 7 + 2 * 7 * 7
PG_KERNELS = ("setup_kernel", "cost_kernel", "edge_kernel", "assemble_kernel", "diag_kernel",
              "panel_kernel", "update_kernel", "back_kernel", "poses_kernel")   # csrc/pose_graph.cu


def pose_graph_problem(rng, case: str = "drift", K: int | None = None) -> dict:
    """Inputs of ``solver.sim3.pose_graph_optimize`` (numpy, from ``rng``):
    ``test_torch_sim3._drift_chain``'s graph at K keyframes: true poses
    1 m apart on a circle (T_{k+1} = T_k Exp(-(1, 0, 0, 0, 0, 2 pi / K))),
    estimates whose every relative motion carries noise (0.02 in each
    tangent component), the temporal chain's edges measured from the
    estimates, a loop edge K-1 -> 0 with the true relative pose and weight 5,
    pose 0 fixed. Cases (``PG_CASES``): ``drift`` (K 12, 15 iterations),
    ``fixed and invalid`` (K 10: poses 0 and 5 fixed, a chain edge invalid,
    one of weight 0, two wrong edges marked invalid; 10 iterations),
    ``scale drift`` (K 8, the scales growing to e^0.15; 12 iterations),
    ``non-finite`` (K 12, a NaN in a chain edge: every pose comes back
    unmoved), ``covisibility 400`` (K 400: as ``loop_closing.loop_edges``
    builds a closure's graph, covisibility edges of weight 1 from each
    keyframe to the ones 2, 3 and 5 ahead measured from the estimates, and
    loop edges from the last 8 keyframes to the first 8, true, weight 5;
    2,793 free rows, 15 iterations), ``2048 keyframes`` (K 2048, the same
    with covisibility to 2 and 3 ahead: 14,329 free rows, ``PG_ITERS_2048``
    iterations). ``K`` resizes a case's graph. Returns a dict: S_w, i, j,
    S_ij, weight, valid, fixed, iters (float32 poses and measurements)."""
    import numpy as np
    import torch

    from tc2li_slam_torch.geom import lie

    K = K or {"drift": 12, "fixed and invalid": 10, "scale drift": 8, "non-finite": 12,
              "covisibility 400": 400, "2048 keyframes": 2048}[case]
    exp = lambda xi: lie.se3_exp(torch.as_tensor(np.asarray(xi, np.float64))).numpy()
    step_inv = np.linalg.inv(exp([1.0, 0, 0, 0, 0, 2 * np.pi / K]))
    noise = exp(rng.normal(0, 0.02, (K - 1, 6)))
    T_gt, T_est = [np.eye(4)], [np.eye(4)]
    for k in range(K - 1):
        T_gt.append(T_gt[-1] @ step_inv)
        T_est.append(noise[k] @ (T_gt[k + 1] @ np.linalg.inv(T_gt[k])) @ T_est[-1])
    T_gt, T_est = np.stack(T_gt), np.stack(T_est).astype(np.float32)
    rel = lambda T, a, b: T[a] @ np.linalg.inv(T[b])
    ii, jj = list(range(K - 1)), list(range(1, K))
    S_ij = [rel(T_est, i, i + 1) for i in range(K - 1)]
    weight, valid = [1.0] * (K - 1), [True] * (K - 1)
    ahead = {"covisibility 400": (2, 3, 5), "2048 keyframes": (2, 3)}.get(case, ())
    for d in ahead:
        for i in range(K - d):
            ii.append(i)
            jj.append(i + d)
            S_ij.append(rel(T_est, i, i + d))
            weight.append(1.0)
            valid.append(True)
    n_loop = 8 if ahead else 1
    for q in range(n_loop):
        ii.append(K - 1 - q)
        jj.append(q)
        S_ij.append(rel(T_gt, K - 1 - q, q))
        weight.append(5.0)
        valid.append(True)
    p = dict(S_w=T_est.copy(), i=np.asarray(ii, np.int32), j=np.asarray(jj, np.int32),
             S_ij=np.stack(S_ij).astype(np.float32), weight=np.asarray(weight, np.float32),
             valid=np.asarray(valid), fixed=np.zeros(K, bool), iters=15)
    p["fixed"][0] = True
    if case == "fixed and invalid":
        wrong = exp([3.0, 1, -2, 0.5, 0.2, -0.4]).astype(np.float32)
        p.update(i=np.append(p["i"], [2, 7]).astype(np.int32),
                 j=np.append(p["j"], [6, 3]).astype(np.int32),
                 S_ij=np.concatenate([p["S_ij"], np.stack([wrong, wrong])]),
                 weight=np.append(p["weight"], [2.0, 2.0]).astype(np.float32),
                 valid=np.append(p["valid"], [False, False]), iters=10)
        p["weight"][4] = 0.0
        p["valid"][1] = False
        p["fixed"][5] = True
    if case == "scale drift":
        p["S_w"][:, :3, :3] *= np.exp(np.linspace(0.0, 0.15, K)).astype(np.float32)[:, None, None]
        p["iters"] = 12
    if case == "non-finite":
        p["S_ij"][3, 1, 2] = np.nan
    if case == "2048 keyframes":
        p["iters"] = PG_ITERS_2048
    return p


def pose_graph_args(torch, p, dev, dtype=None):
    """``pose_graph_optimize``'s arguments ``(a, kw)`` for
    ``pose_graph_problem``'s ``p`` on ``dev`` (the poses, measurements and
    weights cast to ``dtype`` where given)."""
    from tc2li_slam_torch.solver import sim3

    f = lambda x: torch.as_tensor(x).to(dev, dtype or torch.float32)
    edges = sim3.PoseGraphEdges(i=torch.as_tensor(p["i"]).to(dev), j=torch.as_tensor(p["j"]).to(dev),
                                S_ij=f(p["S_ij"]), weight=f(p["weight"]),
                                valid=torch.as_tensor(p["valid"]).to(dev))
    return (f(p["S_w"]), edges, torch.as_tensor(p["fixed"]).to(dev)), {"iters": p["iters"]}


def pose_graph_cast(torch, a, dtype):
    """``pose_graph_optimize``'s positional arguments with the poses,
    measurements and weights cast to ``dtype`` (on their device)."""
    S_w, e, fixed = a
    return S_w.to(dtype), e._replace(S_ij=e.S_ij.to(dtype), weight=e.weight.to(dtype)), fixed


def pose_graph_bound(K: int, n_free: int, n_edges: int, iters: int) -> tuple:
    """(least ms on the card, what bounds it) of one ``pose_graph_optimize``
    call over K poses, ``n_free`` of them free, and ``n_edges`` edges: bytes
    read and written once (the poses in and out, the edges' Sim3
    measurements, indices, weights and flags, the fixed flags) over the
    memory rate; float64 operations, a fused multiply-add counted as one:
    an iteration's Cholesky of the n = 7 n_free free rows (n^3 / 6) and its
    two triangular substitutions (n^2) over the tensor cores' float64 rate,
    each edge's ``PG_OPS_EDGE`` an iteration and the entry cost's residuals
    over the float64 rate outside them."""
    n = 7 * n_free
    n_bytes = 2 * 64 * K + K + n_edges * (64 + 4 + 4 + 4 + 1)
    t_b = n_bytes / PEAK_BYTES_S
    t_o = (iters * (n ** 3 / 6 + n ** 2) / PEAK_F64_TC_S
           + (iters * n_edges * PG_OPS_EDGE + 300 * n_edges) / PEAK_F64_S)
    return 1e3 * max(t_b, t_o), "bytes" if t_b >= t_o else "operations"


def pose_graph_system(torch, a):
    """H [7K, 7K] and g [7K] of the first step of the plain version run in
    float64 on ``a``'s device (``ops.kernels.pose_graph.normal_equations``):
    the free rows' part is what the library's Cholesky is timed on."""
    from tc2li_slam_torch.ops.kernels import pose_graph as kpg

    return kpg.normal_equations(*pose_graph_cast(torch, a, torch.float64))


def pose_graph_tol(K: int) -> float:
    """The kernels' limit on every pose entry from the plain version run in
    float64, for a graph of K poses."""
    return PG_TOL if K <= PG_LARGE_K else PG_TOL_LARGE


def pose_distance(torch, a, b) -> float:
    """The largest entry of |a - b| (a NaN beside a NaN 0, another NaN inf)."""
    d = (a.double() - b.double()).abs()
    d = float(torch.where(torch.isnan(a) & torch.isnan(b), torch.zeros_like(d), d).max())
    return d if d == d else float("inf")


def pose_graph_phase(torch, dev, cases, log=print, sync=lambda: None, timer=None, split=None,
                     timed=None) -> dict:
    """Phase 5, the pose graph's kernels against their plain version on
    ``dev`` through the dispatcher a user calls
    (``solver.sim3.pose_graph_optimize``): ``cases`` lists ``(label, a,
    kw)``; each is held to ``pose_graph_tol(K)`` on every pose entry of the
    plain version run in float64 on the same device (a NaN beside a NaN
    counts 0, another NaN fails), the same bits on a second call,
    ``launches_per_call(K, iters)`` launches a call by the wrapper's counter,
    no host sync; a case with a NaN comes back as it went in. Each case's
    seconds (two calls and their sync) are printed. ``timer(fn, reps) -> ms``
    times a call behind a device backlog for the cases whose labels
    ``timed`` lists (default the first): the kernels', the plain version's
    in float32, and the library's Cholesky and solve of the free rows' H of
    the first step in float64 (``library_ms``; ``torch.linalg.cholesky_ex``,
    the factorization without its host check, and ``torch.cholesky_solve``);
    ``split(fn)`` gives a call's device events
    by kernel name, which must be ``csrc/pose_graph.cu``'s and sum to
    ``launches_per_call``. Returns the
    kernels' row, its times those of the first timed case and
    ``ms_by_case`` every timed case's; raises RuntimeError where a check
    fails."""
    from tc2li_slam_torch.ops.kernels import pose_graph as kpg
    from tc2li_slam_torch.solver import sim3

    timer = timer or (lambda fn, reps: float("nan"))
    timed = timed or [cases[0][0]]
    row, err, by_case = None, 0.0, {}
    for label, a, kw in cases:
        K, E, iters = a[0].shape[0], a[1].i.shape[0], kw["iters"]
        n_free = int((~a[2]).sum())
        n0 = kpg.launches
        t0 = time.perf_counter()
        got = sim3.pose_graph_optimize(*a, **kw)
        again = sim3.pose_graph_optimize(*a, **kw)
        sync()
        secs = time.perf_counter() - t0
        n_launch = kpg.launches - n0
        ref64 = kpg.pose_graph_plain(*pose_graph_cast(torch, a, torch.float64), **kw)
        sync()
        dist, tol = pose_distance(torch, got, ref64), pose_graph_tol(K)
        twice = bit_equal(torch, got, again)
        want = 2 * kpg.launches_per_call(K, iters) if a[0].is_cuda else 0
        log(f"pose_graph_gn {label} (K {K}, {n_free} free poses, {7 * n_free} free rows, "
            f"{E} edges, {int(a[1].valid.sum())} valid, {iters} iterations): |kernel - plain in "
            f"float64| {dist:.2e} on the poses (limit {tol:g}); the same bits on a second call "
            f"{twice}; launches {n_launch} (expected {want}); two calls in {secs:.3f} s")
        if not dist <= tol or not twice or n_launch != want:
            raise RuntimeError(f"pose_graph_gn disagrees with its plain version run in float64 "
                               f"on {label}: {dist} (limit {tol}), the same bits twice {twice}, "
                               f"launches {n_launch} for 2 calls (expected {want})")
        if bool(torch.isnan(a[1].S_ij).any()) and not torch.equal(got, a[0]):
            raise RuntimeError(f"pose_graph_gn on {label}: the poses moved on a NaN cost")
        err = max(err, dist)
        if label in timed:
            fn = lambda: sim3.pose_graph_optimize(*a, **kw)
            ms = timer(fn, 5)
            ms_p = timer(lambda: kpg.pose_graph_plain(*a, **kw), 1)
            b = pose_graph_bound(K, n_free, int(a[1].valid.sum()), iters)
            H, g = pose_graph_system(torch, a)
            rows = torch.nonzero(~a[2].repeat_interleave(7))[:, 0]
            H, g = H[rows][:, rows], g[rows]
            lib_ms = timer(lambda: torch.cholesky_solve(
                g[:, None], torch.linalg.cholesky_ex(H, check_errors=False)[0]), 5)
            del H, g
            parts = split(fn) if split else None
            log(f"pose_graph_gn {label}: {ms:.4f} ms a call behind a backlog, bound "
                f"{b[0]:.6f} ms ({b[1]}), plain {ms_p:.4f} ms"
                + f", the library's Cholesky and solve of the free rows' H in float64 "
                f"{lib_ms:.4f} ms"
                + ("; device events a call by kernel (torch.profiler): "
                   + ", ".join(f"{k} {v['launches_a_call']:g} x {v['ms_a_launch']:.4f} ms"
                               for k, v in parts.items()) if parts is not None else ""))
            if parts is not None and (
                    set(parts) - set(PG_KERNELS) or sum(v["launches_a_call"] for v in parts.values())
                    != kpg.launches_per_call(K, iters)):
                raise RuntimeError(f"pose_graph_gn on {label}: the profiler's record of a call "
                                   f"is not csrc/pose_graph.cu's "
                                   f"{kpg.launches_per_call(K, iters)} launches: {parts}")
            by_case[label] = dict(ms=ms, plain_ms=ms_p, bound_ms=b[0], library_ms=lib_ms,
                                  seconds=secs)
            if row is None:
                row = dict(source="tc2li_slam_torch/csrc/pose_graph.cu",
                           replaces="tc2li_slam_tpu/solver/sim3.py:112", ms=ms, plain_ms=ms_p,
                           bound_ms=b[0], bound_by=b[1], library_ms=lib_ms)
    n_sync = [syncs_of(torch, lambda: sim3.pose_graph_optimize(*a, **kw)) for _, a, kw in cases]
    log(f"pose_graph_gn: host syncs in a call {n_sync}")
    if any(n_sync):
        raise RuntimeError(f"pose_graph_gn synchronised the host in a call: {n_sync}")
    row.update(max_abs_err=err, ms_by_case=by_case)
    return {"pose_graph_gn": row}


def ply_vertices(path) -> int:
    """The vertex count in a PLY header."""
    with open(path) as f:
        for line in f:
            if line.startswith("element vertex"):
                return int(line.split()[-1])
    raise RuntimeError(f"{path}: no vertex count")


def is_sync_warning(message) -> bool:
    """A host sync reported under ``set_sync_debug_mode("warn")``, not the
    notice PyTorch gives once a process that the mode is a prototype."""
    text = str(message).lower()
    return "synchroniz" in text and "prototype" not in text


def n_syncs(caught) -> int:
    """Host syncs among warnings caught under ``set_sync_debug_mode("warn")``."""
    return sum(is_sync_warning(w.message) for w in caught)


def syncs_of(torch, fn) -> int:
    """The host syncs ``fn()`` makes (on a CUDA card; 0 without one)."""
    import warnings
    if not torch.cuda.is_available():
        fn()
        return 0
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return n_syncs(caught)


def describe_pixels(torch, img_stack, rows, cols, level, angles, n_levels, pad):
    """What ``orb_describe`` must read of the stacks for keypoints [B, K] at
    ``angles``: the number of distinct pixels of ``img_stack`` in their
    masked 31x31 patches, of ``blur_stack`` at their rotated taps (each
    union over all keypoints of a plane), and the patch mask's size."""
    from tc2li_slam_torch.ops.kernels import orb as korb
    P, Hs, Ws = img_stack.shape
    B = rows.shape[0]
    dev = rows.device
    plane = (level.long() + n_levels * torch.arange(B, device=dev)[:, None]).reshape(-1, 1)
    r0, c0 = (x.reshape(-1, 1).long() + pad for x in (rows, cols))
    mask = torch.as_tensor(korb._ic_angle_weights()[0] > 0, device=dev)
    dv, du = (x - korb.HALF_PATCH for x in mask.nonzero().unbind(1))
    tr, tc = korb.tap_coords(rows.reshape(-1), cols.reshape(-1), angles.reshape(-1), pad)

    def distinct(r, c):
        seen = torch.zeros(P * Hs * Ws, dtype=torch.bool, device=dev)
        return int(seen.index_fill_(0, ((plane * Hs + r) * Ws + c).reshape(-1), True).sum())
    return distinct(r0 + dv, c0 + du), distinct(tr, tc), int(mask.sum())


def orb_level_check(torch, korb, imgs, n_levels, scale):
    """``orb_level_planes`` against its plain version on float32 images
    [B, H, W]: (img_stack, blur_stack, shapes, max |diff|); raises
    RuntimeError unless every plane's padded region is bit-equal."""
    st, bl, shapes = korb.orb_level_planes(imgs, n_levels, scale)
    st_p, bl_p, shapes_p = korb.level_planes_plain(imgs, n_levels, scale)
    pad = korb.PAD
    if shapes != shapes_p:
        raise RuntimeError(f"orb_level_planes: shapes {shapes} against {shapes_p}")
    err = 0.0
    for p, (h, w) in enumerate(shapes):
        for got, ref in ((st, st_p), (bl, bl_p)):
            g, r = got[p, :h + 2 * pad, :w + 2 * pad], ref[p, :h + 2 * pad, :w + 2 * pad]
            e = float((g - r).abs().max())
            err = max(err, e)
            if not torch.equal(g, r):
                raise RuntimeError(f"orb_level_planes disagrees with its plain version on "
                                   f"plane {p} of {tuple(imgs.shape)}: max |diff| {e}")
    return st, bl, shapes, err


def orb_select_check(torch, korb, scores, shapes, per, scale):
    """``orb_select_grid`` against its plain version: (outputs, max |diff|);
    raises RuntimeError unless every output is bit-equal."""
    sel = korb.orb_select_grid(scores, shapes, per, scale)
    sel_p = korb.select_grid_plain(scores, shapes, per, scale)
    err = max([0.0] + [float((a.double() - b.double()).abs().max()) for a, b in zip(sel, sel_p)
                       if a.numel()])
    if not all(torch.equal(a, b) for a, b in zip(sel, sel_p)):
        raise RuntimeError(f"orb_select_grid disagrees with its plain version on "
                           f"{len(shapes)} planes of {tuple(scores.shape)}: max |diff| {err}")
    return sel, err


def nms_row(torch, imgs, calls: int = 20) -> dict:
    """``fast_nms_planes`` on the two passes' stacks of ``imgs`` (float32
    [B, H, W] on the card) as the frame build makes them
    (``orb_level_planes``, 8 levels, then ``fast_score_planes``): bit-equal
    to ``nms_planes_plain`` and the same bits on a second call, one launch a
    call; device ms behind a backlog and by kernel name
    (``kernel_split``), the bound (pass 1's scores and the flags read once,
    the map written once, a compare or two a pixel), the plain version's
    ms. Raises RuntimeError on a disagreement."""
    from tc2li_slam_torch.ops.kernels import fast, orb as korb
    ini_th, min_th, cell = 20.0, 7.0, 35
    st, _, shapes = korb.orb_level_planes(imgs, 8, 1.2)
    gated, flags = fast.score_planes(st, shapes, korb.PAD, ini_th, min_th, cell)
    n0 = fast.nms_launches
    got = fast.nms_planes(gated, flags, shapes, ini_th, min_th, cell)
    again = fast.nms_planes(gated, flags, shapes, ini_th, min_th, cell)
    n_launch = (fast.nms_launches - n0) / 2
    ref = fast.nms_planes_plain(gated, flags, shapes, ini_th, min_th, cell)
    torch.cuda.synchronize()
    bits = lambda x, p, h, w: x[p, :h, :w].contiguous().view(torch.int32)
    for p, (h, w) in enumerate(shapes):
        if not (torch.equal(bits(got, p, h, w), bits(ref, p, h, w))
                and torch.equal(bits(got, p, h, w), bits(again, p, h, w))):
            raise RuntimeError(f"fast_nms_planes disagrees with its plain version or itself on "
                               f"plane {p} {(h, w)} of {tuple(imgs.shape)}")
    n_pix = sum(h * w for h, w in shapes)
    b = bound(8 * n_pix + 4 * flags.numel(), 3 * n_pix)
    call = lambda: fast.nms_planes(gated, flags, shapes, ini_th, min_th, cell)
    split = kernel_split(torch, call, calls)
    return dict(ms=cuda_ms(torch, call, 50, True),
                plain_ms=cuda_ms(torch, lambda: fast.nms_planes_plain(
                    gated, flags, shapes, ini_th, min_th, cell), 3),
                bound_ms=b[0], bound_by=b[1], max_abs_err=0.0, launches_a_call=n_launch,
                pixels=n_pix, corners=sum(int((ref[p, :h, :w] > 0).sum())
                                          for p, (h, w) in enumerate(shapes)),
                split={k: v["ms_a_launch"] for k, v in split.items()})


def orb_level_bound(korb, shapes, B, H, W, n_levels):
    """The least time of ``orb_level_planes``: the images read once, both
    stacks' padded regions written once; the resize's taps and the blur's 28
    operations a level pixel."""
    pad = korb.PAD
    n_pix = sum(h * w for h, w in shapes)
    n_padded = sum((h + 2 * pad) * (w + 2 * pad) for h, w in shapes)
    ops = 28 * n_pix
    for lvl in range(1, n_levels):
        h, w = shapes[lvl]
        tr = korb.resize_taps(H, h)[1].shape[1]
        tc = korb.resize_taps(W, w)[1].shape[1]
        ops += B * (2 * h * W * tr + 2 * h * w * tc)
    return bound(4 * B * H * W + 8 * n_padded, ops), n_padded


def orb_select_bound(torch, korb, scores, shapes, per, n_levels, K):
    """The least time of ``orb_select_grid``: every plane pixel read and
    compared for each of its cell's candidates, the positive candidates
    ordered, the K slots written (20 bytes each)."""
    import math
    import torch.nn.functional as F
    ops, n_pos = 0, 0
    for p, (h, w) in enumerate(shapes):
        hc, wc = -(-h // korb.CELL), -(-w // korb.CELL)
        m = korb.cell_candidates(hc * wc, per[p % n_levels])
        cells = F.pad(scores[p, :h, :w], (0, wc * korb.CELL - w, 0, hc * korb.CELL - h))
        cells = cells.reshape(hc, korb.CELL, wc, korb.CELL).permute(0, 2, 1, 3).reshape(hc * wc, -1)
        pos = int(torch.clamp((cells > 0).sum(1), max=m).sum())
        n_pos += pos
        ops += m * h * w + pos * max(1.0, math.log2(max(pos, 1)))
    return bound(4 * sum(h * w for h, w in shapes) + 20 * K, ops), n_pos


def subpixel_bound(n: int, m: int = 0):
    """The least time of the stereo half of a frame build after the match
    (``ops/kernels/stereo.stereo_refine``'s prep and refine launches) on n left and m
    right keypoints: each keypoint's 11 x 11 left patch and 11 x 21 right
    strip read once (uint8 pixels), its coordinates, flag and the match's
    index, best and second in (29 bytes), a right keypoint's level, the
    matcher's packed column best and the band (16 bytes) in and out; u_r, the
    flag, the depth and (u, v, u_r) out (25); per keypoint, for each of the
    11 offsets the centres' difference wc - pc and 121 terms of two
    subtractions, an absolute value and an add, |(w - p) - (wc - pc)| (the
    plain chain's centred windows, exact on grey levels), the matcher's tail,
    the arg-min, the parabola and the depth (~30), and the median's radix
    select, two 8-bit digits of two order statistics (~8)."""
    return bound(n * (121 + 231 + 29 + 25) + 16 * m, n * (11 + 11 * 4 * 121 + 30 + 8))


STEREO_CASES = ("frame", "all_ok", "borders")
# the refine launch's edge cases, each from ``all_ok``'s keypoints
STEREO_EDGE_CASES = ("no keypoint", "one keypoint", "odd", "even", "one not ok", "sad ties",
                     "float images", "wide right")


def stereo_case(rng, case: str, img_l, img_r, kl: dict, kr: dict, shift: int = 8):
    """Inputs of the stereo half of a frame build, ``STEREO_CASES``, as numpy:
    ``(img_l, img_r, kl, kr)``, uint8 [H, W] images and keypoints as dicts of
    ``xy`` [N, 2] float32, ``level`` [N] int32, ``desc`` [N, 8] int32 and
    ``valid`` [N] bool. ``frame``: the pair and its ORB keypoints as given.
    ``all_ok``: the valid left keypoints of distinct descriptors away from the
    border, matched by copies of themselves ``shift`` px to the left on a
    right image that is the left one shifted and noised by up to 3 grey
    levels, with the strip of every 20th overwritten by noise: every
    keypoint is ok before the SAD gate, so the reference's median is finite
    and the gate rejects the overwritten ones. ``borders``: 48 keypoints of
    distinct random descriptors on and next to the image borders (half
    pixels included, where rounding half to even matters) at disparities of
    0.5 to 12 px, some of whose strip centres fall outside the image.

    ``STEREO_EDGE_CASES``, from ``all_ok``'s keypoints (every keypoint ok, so
    the median gate fires, unless one is not): no left keypoint; one; an odd
    and an even count; one left keypoint invalid (the gate is off); every
    5th keypoint's patch and strip on a flat grey region of both images (all
    its SADs 0: ties in the arg-min and the median); the images as float32
    grey levels (the float route); the right keypoints padded with invalid
    and far-away ones to ``STEREO_MAX_COLUMNS`` + 880 (the match in two
    column chunks)."""
    import numpy as np
    H, W = img_l.shape
    if case == "frame":
        return img_l, img_r, kl, kr
    if case in STEREO_EDGE_CASES:
        il, ir, left, right = stereo_case(rng, "all_ok", img_l, img_r, kl, kr, shift)
        N = left["xy"].shape[0]
        take = lambda d, n: {k: v[:n] for k, v in d.items()}
        if case == "no keypoint":
            return il, ir, take(left, 0), right
        if case == "one keypoint":
            return il, ir, take(left, 1), right
        if case in ("odd", "even"):
            n = N - int(N % 2 == (0 if case == "odd" else 1))
            return il, ir, take(left, n), right
        if case == "one not ok":
            left["valid"] = left["valid"].copy()
            left["valid"][N // 2] = False
            return il, ir, left, right
        if case == "sad ties":
            il, ir = il.copy(), ir.copy()
            for (x, y), (xr, _) in zip(np.rint(left["xy"][::5]).astype(int),
                                       np.rint(right["xy"][::5]).astype(int)):
                il[max(y - 6, 0):y + 7, max(x - 6, 0):x + 7] = 120
                ir[max(y - 6, 0):y + 7, max(xr - 11, 0):xr + 12] = 120
            return il, ir, left, right
        if case == "float images":
            return il.astype(np.float32), ir.astype(np.float32), left, right
        extra = STEREO_MAX_COLUMNS + 880 - right["xy"].shape[0]   # "wide right"
        pad = dict(xy=np.stack([rng.uniform(0, W, extra) + 2 * W, rng.uniform(0, H, extra)],
                               1).astype(np.float32),
                   level=rng.integers(0, 8, extra).astype(np.int32),
                   desc=rng.integers(-2 ** 31, 2 ** 31, (extra, 8)).astype(np.int32),
                   valid=rng.random(extra) > 0.5)
        return il, ir, left, {k: np.concatenate([right[k], pad[k]]) for k in right}
    if case == "all_ok":
        xy, N = kl["xy"], kl["xy"].shape[0]
        inside = (kl["valid"] & (xy[:, 0] >= 20) & (xy[:, 0] < W - 20) & (xy[:, 1] >= 8)
                  & (xy[:, 1] < H - 8))
        _, first, counts = np.unique(kl["desc"], axis=0, return_index=True, return_counts=True)
        unique = np.zeros(N, bool)
        unique[first[counts == 1]] = True
        sel = np.nonzero(inside & unique)[0]
        left = {k: v[sel] for k, v in kl.items()}
        left["valid"] = np.ones(sel.size, bool)
        right = dict(left, xy=(left["xy"] - np.array([shift, 0], np.float32)).astype(np.float32))
        shifted = np.concatenate([img_l[:, shift:], np.repeat(img_l[:, -1:], shift, 1)], 1)
        noisy = shifted.astype(np.int32) + rng.integers(-3, 4, shifted.shape)
        for x, y in np.rint(right["xy"][::20]).astype(int):
            noisy[max(y - 6, 0):y + 7, max(x - 12, 0):x + 13] = rng.integers(0, 256, (13, 25))[
                :min(y + 7, H) - max(y - 6, 0), :min(x + 13, W) - max(x - 12, 0)]
        return img_l, np.clip(noisy, 0, 255).astype(np.uint8), left, right
    if case == "borders":
        ys = np.array([0.0, 0.4, 0.5, 1.5, 2.5, H / 2, H - 2.5, H - 1.5, H - 1.0, H - 0.5])
        xs = np.array([0.0, 0.5, 1.5, 4.5, 9.5, 10.5, 12.5, W / 2, W - 6.5, W - 1.5, W - 1.0,
                       W - 0.5])
        n = 48
        xy = np.stack([rng.choice(xs, n), rng.choice(ys, n)], 1).astype(np.float32)
        d = rng.choice(np.array([0.5, 3.0, 10.0, 12.0], np.float32), n)
        desc = rng.integers(-2 ** 31, 2 ** 31, (n, 8)).astype(np.int32)
        left = dict(xy=xy, level=np.zeros(n, np.int32), desc=desc, valid=np.ones(n, bool))
        right = dict(left, xy=np.stack([xy[:, 0] - d, xy[:, 1]], 1).astype(np.float32))
        return img_l, img_r, left, right
    raise ValueError(case)


def stereo_keypoints(torch, orb_mod, d: dict, dev):
    """An ``orb.Keypoints`` of the numpy dict ``d`` (``stereo_case``) on ``dev``."""
    up = lambda x: torch.as_tensor(x).to(dev)
    xy = up(d["xy"])
    zero = torch.zeros(xy.shape[0], dtype=torch.float32, device=dev)
    return orb_mod.Keypoints(xy=xy, xy_level=xy, level=up(d["level"]), angle=zero, score=zero,
                             desc=up(d["desc"]), valid=up(d["valid"]))


CLUSTER_CASES = ("full_width", "overflow", "no_valid_point", "no_kf_pads")


def cluster_case(rng, case: str, W: int = 6, M: int = 2048):
    """Inputs of ``balm.build_clusters`` (1 m voxels, 512 slots, 15 points),
    ``CLUSTER_CASES``, as numpy ``(points [W, M, 3], valid [W, M], T_wl)``:
    ``full_width``: a window of W keyframes of M points on three planes
    (``planar_window``); ``overflow``: the same points spread over a 60 m box
    (more occupied voxels than slots); ``no_valid_point``: every point invalid;
    ``no_kf_pads``: the last two keyframes ``NO_KF`` padding (identity
    poses, no valid point)."""
    import numpy as np
    pl, valid, T_wl, _ = planar_window(rng, W, M)
    if case == "overflow":
        pl = (pl * 10.0).astype(np.float32)
    if case == "no_valid_point":
        valid[:] = False
    if case == "no_kf_pads":
        valid[W - 2:] = False
        T_wl[W - 2:] = np.eye(4, dtype=np.float32)
    return pl, valid, T_wl


def plateau_image(H: int = 150, W: int = 203):
    """A float32 [H, W] image of flat plateaus for the FAST passes: small
    blocks on a black ground, each of whose pixels scores the block's grey
    level (its radius-3 circle leaves the block), so equal scores touch.
    Around the 35-px cell edges at x = 35 and 70 and y = 35 and 70: weak
    blocks (grey 15, above min_th 7 and below ini_th 20) across an edge
    between a cell with a strong block (its flag up) and one without, so
    the weak plateau survives on one side only; a strong block (30) across
    an edge between two flagged cells, so both halves tie and survive; two
    touching blocks of 40 and 50. Plain 0..255 grey levels."""
    import numpy as np
    img = np.zeros((H, W), np.float32)
    blocks = [
        (20, 20, 2, 2, 100.0),   # strong: cell (0, 0) flagged
        (25, 33, 2, 4, 15.0),    # weak across x = 35: cell (0, 0) flagged, (0, 1) not
        (33, 50, 4, 2, 15.0),    # weak across y = 35: cell (0, 1) not flagged, (1, 1) flagged
        (50, 50, 2, 2, 90.0),    # strong: cell (1, 1) flagged
        (45, 68, 2, 4, 30.0),    # strong across x = 70: cells (1, 1) and (1, 2) flagged
        (60, 90, 2, 2, 60.0),    # strong: cell (1, 2) flagged
        (100, 30, 2, 2, 40.0),   # two touching blocks of 40 and 50
        (100, 32, 2, 2, 50.0),
        (68, 120, 4, 3, 15.0),   # weak across y = 70: cells (1, 3) and (2, 3) not flagged
    ]
    for y, x, h, w, g in blocks:
        img[y:y + h, x:x + w] = g
    return img


def stereo_pair(torch, syn, orb_mod, dev, size=None):
    """Frame 0 of a synthetic KITTI-shaped sequence (1241x376, or resampled to
    ``size`` (H, W) and rounded to grey levels) as uint8 images on ``dev`` and
    the numpy keypoint dicts of its 2000-feature, 8-level ORB:
    ``(img_l, img_r, kl, kr)``, ``stereo_case``'s arguments."""
    import numpy as np
    import torch.nn.functional as F
    world = syn.make_world(np.random.default_rng(0), n_surf=20_000)
    fr = syn.generate_sequence(n_frames=1, cam=syn.KITTI_LIKE, seed=0, n_scan=256,
                               world=world)[0][0]
    imgs = [torch.as_tensor(np.clip(x, 0, 255).astype(np.float32)).to(dev)
            for x in (fr.img_l, fr.img_r)]
    if size is not None:
        imgs = list(F.interpolate(torch.stack(imgs)[:, None], size=size, mode="bilinear",
                                  antialias=True)[:, 0].round().clamp(0, 255))
    imgs = [x.to(torch.uint8) for x in imgs]
    kps = orb_mod.extract_images(imgs, 2000, 8)
    as_np = lambda k: {f: getattr(k, f).cpu().numpy() for f in ("xy", "level", "desc", "valid")}
    return imgs[0].cpu().numpy(), imgs[1].cpu().numpy(), as_np(kps[0]), as_np(kps[1])


def clusters_agree(torch, got, ref, T_wl, ratios=(1.0 / 36.0, 1.0 / 25.0), tol=1e-5):
    """``(agree, how)`` of two ``VoxelClusters``: bit-equal; or N, mean, Pc and
    center bit-equal and every slot whose planar flag differs with
    lambda0 / (ratio lambda1), re-derived in float64 from the slot's
    clusters and ``T_wl``, within ``tol`` of 1 for the root or the child
    ratio (the float32 plane test rounds there)."""
    import numpy as np
    bits = lambda x: x.view(torch.int32) if x.dtype == torch.float32 else x
    eq = [torch.equal(bits(a), bits(b)) for a, b in zip(got, ref)]
    if all(eq):
        return True, "bit-equal"
    if not all(eq[:4]):
        names = ("N", "mean", "Pc", "center")
        return False, "differ in " + ", ".join(k for k, e in zip(names, eq) if not e)
    c = [x.detach().cpu().numpy().astype(np.float64) for x in ref[:4]]
    T = T_wl.detach().cpu().numpy().astype(np.float64)
    R, t = T[:, :3, :3], T[:, :3, 3]
    m_w = np.einsum("wij,vwj->vwi", R, c[1]) + (t[None] - c[3][:, None])
    P = (np.einsum("wij,vwjk,wlk->vwil", R, c[2], R)
         + c[0][..., None, None] * np.einsum("vwi,vwj->vwij", m_w, m_w)).sum(1)
    n = np.maximum(c[0].sum(1), 1.0)
    mu = (c[0][..., None] * m_w).sum(1) / n[:, None]
    cov = P / n[:, None, None] - np.einsum("vi,vj->vij", mu, mu) + 1e-9 * np.eye(3)
    lam = np.linalg.eigvalsh(cov)
    flip = np.nonzero((got.valid != ref.valid).cpu().numpy())[0]
    margin = [min(abs(lam[v, 0] / (r * max(lam[v, 1], 1e-9)) - 1.0) for r in ratios) for v in flip]
    if max(margin) <= tol:
        return True, f"flags differ at {flip.tolist()} within {tol} of the threshold"
    return False, f"flags differ at {flip.tolist()}, {max(margin):.2e} from the threshold"


def clusters_bound(W: int, M: int, V: int, n_valid: int):
    """The least time of ``balm_clusters``: the points (LiDAR and world,
    12 + 12 bytes), a flag, the poses and the clusters written once ((1 + 3
    + 9) W + 4 floats and a flag a slot); per valid point the key (~12
    operations), its share of two 31-bit radix sorts (2 x 8 passes x ~6) and
    of the two passes' sums (3 + 9 products and adds, twice), per slot the
    plane test (~200 per cell)."""
    return bound(W * M * 25 + 64 * W + V * (4 * (13 * W + 3) + 1),
                 n_valid * (12 + 96 + 2 * 30) + 2 * V * 200 * W)


def save_balm_windows(path, cl_cases, quad_cases):
    """The BALM pass's inputs of this run, for ``tools/balm_kernels.py``:
    ``cl_cases`` ``[(name, ((points, valid, T_wl), kw))]`` of
    ``balm_clusters``, ``quad_cases`` ``[(name, clusters, T)]`` of
    ``balm_quadratic``, as one ``.npz``."""
    import numpy as np
    z = {"cluster_names": np.array([name for name, _ in cl_cases]),
         "quad_names": np.array([name for name, _, _ in quad_cases])}
    for i, (_, (a, kw)) in enumerate(cl_cases):
        for k, x in zip(("points", "valid", "T_wl"), a):
            z[f"c{i}_{k}"] = x.cpu().numpy()
        z[f"c{i}_kw"] = np.array([kw["voxel_size"], kw["max_voxels"], kw["min_points"]],
                                 np.float64)
    for i, (_, c, T) in enumerate(quad_cases):
        for f, x in zip(c._fields, c):
            z[f"q{i}_{f}"] = x.cpu().numpy()
        z[f"q{i}_T"] = T.cpu().numpy()
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, **z)


def balm_phase_split(root, build):
    """``tools/balm_kernels.py``'s ``PhaseSplit`` of this checkout: its two
    BALM sources rebuilt with clock stamps (into ``build/balm_kernels``),
    called as ``split(torch, "clusters" or "balm", fn)``."""
    import importlib.util
    spec = importlib.util.spec_from_file_location("balm_kernels",
                                                  root / "tools" / "balm_kernels.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.PhaseSplit(root, root / "build" / "balm_kernels", build)


def save_match_cases(torch, path, cases: dict) -> None:
    """``cases`` ({name: match_best2's arguments: d1, d2, valid1, valid2, a
    WindowMask, StereoMask or EpipolarMask or None, mutual}) to ``path``, on
    the CPU, for ``load_match_cases`` (``tools/match_kernels.py``)."""
    out = {name: {"d1": d1.cpu(), "d2": d2.cpu(), "valid1": v1.cpu(), "valid2": v2.cpu(),
                  "kind": "none" if mask is None else type(mask).__name__,
                  "mutual": bool(mutual),
                  "mask": {} if mask is None else {
                      k: v.cpu() if isinstance(v, torch.Tensor) else v
                      for k, v in mask._asdict().items()}}
           for name, (d1, d2, v1, v2, mask, mutual) in cases.items()}
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    torch.save(out, path)


def load_match_cases(torch, match, path, dev) -> dict:
    """What ``save_match_cases`` wrote, on ``dev``: {name: (d1, d2, valid1,
    valid2, mask, mutual)}; a case saved without a mask has mask None. An
    ``EpipolarMask`` case becomes the tree's own mask: the descriptor where
    ``match`` has it, else the dense bool [N, M] of the plain chain's gate
    (``epipolar_dense``)."""
    kinds = {"WindowMask": match.WindowMask, "StereoMask": match.StereoMask}
    up = lambda v: v.to(dev) if isinstance(v, torch.Tensor) else v
    out = {}
    for name, c in torch.load(path).items():
        fields = {k: up(v) for k, v in c["mask"].items()}
        if c["kind"] == "none":
            mask = None
        elif c["kind"] == "EpipolarMask":
            mask = (match.EpipolarMask(**fields) if hasattr(match, "EpipolarMask")
                    else epipolar_dense(torch, **fields))
        else:
            mask = kinds[c["kind"]](**fields)
        out[name] = (up(c["d1"]), up(c["d2"]), up(c["valid1"]), up(c["valid2"]), mask,
                     c["mutual"])
    return out


def epipolar_dense(torch, lines, uv2, sigma2, thresh: float = 3.84):
    """The plain chain's epipolar gate (``ops/matching.epipolar_mask`` after
    its lines) as a bool [N, M]."""
    num = torch.abs(lines[:, None, 0] * uv2[None, :, 0] + lines[:, None, 1] * uv2[None, :, 1]
                    + lines[:, None, 2])
    den2 = lines[:, 0] ** 2 + lines[:, 1] ** 2
    d2 = num * num / torch.clamp(den2[:, None], min=1e-12)
    return d2 < thresh * sigma2[None, :]


def epipolar_whole_call(torch, path, dev):
    """{name: a call of the triangulation match from its geometry} for the
    ``EpipolarMask`` cases that ``save_match_cases`` wrote with their
    keypoints ``uv1`` and fundamental matrix ``F12``: the gate's inputs and
    the matcher, by the importing tree's own route (an ``EpipolarMask`` of
    ``matching.epipolar_lines`` where it has one, else the dense mask of
    ``matching.epipolar_mask``)."""
    from tc2li_slam_torch.ops import matching
    from tc2li_slam_torch.ops.kernels import match
    calls = {}
    for name, c in torch.load(path).items():
        if c["kind"] != "EpipolarMask" or "F12" not in c:
            continue
        d1, d2, v1, v2, uv1, F12 = (c[k].to(dev) for k in ("d1", "d2", "valid1", "valid2",
                                                          "uv1", "F12"))
        uv2, s2, th = c["mask"]["uv2"].to(dev), c["mask"]["sigma2"].to(dev), c["mask"]["thresh"]
        if hasattr(match, "EpipolarMask"):
            calls[name] = lambda d1=d1, d2=d2, v1=v1, v2=v2, uv1=uv1, F12=F12, uv2=uv2, s2=s2, \
                th=th: match.match_best2(d1, d2, v1, v2, match.EpipolarMask(
                    matching.epipolar_lines(uv1, F12), uv2, s2, th), True)
        else:
            calls[name] = lambda d1=d1, d2=d2, v1=v1, v2=v2, uv1=uv1, F12=F12, uv2=uv2, s2=s2, \
                th=th: match.match_best2(d1, d2, v1, v2, matching.epipolar_mask(
                    uv1, uv2, F12, s2, th), True)
    return calls


def phase_text(phases: dict, ms: float) -> str:
    """A stamped call's phases as ms of ``ms`` by their share of its cycles,
    and its laps as cycles a lap."""
    rows = [(k, v) for k, v in phases.items() if isinstance(v, dict)]
    parts = [f"{k} {v['share'] * ms:.4f} ms ({100 * v['share']:.0f}%)" for k, v in rows
             if "share" in v]
    parts += [f"{k} {v['cycles a lap']:.0f} cycles x {v['laps']}" for k, v in rows
              if "laps" in v]
    return "; ".join(parts)


def orb_interp_ms(torch, imgs, shapes, n_levels):
    """``F.interpolate(..., "bilinear", antialias=True)`` of every level but
    0 of the images, one call a level (no blur): the library's yardstick."""
    import torch.nn.functional as F
    x = imgs[:, None]
    return cuda_ms(torch, lambda: [F.interpolate(x, size=shapes[lvl], mode="bilinear",
                                                 antialias=True)
                                   for lvl in range(1, n_levels)], 50, True)


def orb_hd_rows(torch, pair, size, log=print) -> dict:
    """The pyramid and the grid top-k of ``pair`` (float32 [H, W] on the
    card) resampled to ``size`` (H, W) and rounded to grey levels: both
    kernels bit-equal to their plain versions on one and on two images, then
    their device ms behind a backlog on two, beside the bound, the plain
    version and ``F.interpolate``. Raises RuntimeError on a disagreement."""
    import torch.nn.functional as F
    from tc2li_slam_torch.ops import orb
    from tc2li_slam_torch.ops.kernels import fast, orb as korb
    n_levels, scale = 8, 1.2
    per = orb.features_per_level(2000, n_levels, scale)
    H, W = size
    big = F.interpolate(torch.stack(pair)[:, None], size=size, mode="bilinear",
                        antialias=True)[:, 0].round().clamp(0, 255)
    err = {"level": 0.0, "select": 0.0}
    for B in (1, 2):
        imgs = big[:B].contiguous()
        st, bl, shapes, e = orb_level_check(torch, korb, imgs, n_levels, scale)
        err["level"] = max(err["level"], e)
        scores = fast.detect_planes(st, shapes, korb.PAD)
        sel, e = orb_select_check(torch, korb, scores, shapes, per, scale)
        err["select"] = max(err["select"], e)
    hc, wc = -(-H // korb.CELL), -(-W // korb.CELL)
    n_cand = hc * wc * korb.cell_candidates(hc * wc, per[0])
    b_level, n_padded = orb_level_bound(korb, shapes, 2, H, W, n_levels)
    b_sel, n_pos = orb_select_bound(torch, korb, scores, shapes, per, n_levels, sel[0].numel())
    ms_level = cuda_ms(torch, lambda: korb.orb_level_planes(imgs, n_levels, scale), 50, True)
    ms_sel = cuda_ms(torch, lambda: korb.orb_select_grid(scores, shapes, per, scale), 50, True)
    ms_level_p = cuda_ms(torch, lambda: korb.level_planes_plain(imgs, n_levels, scale), 3)
    ms_sel_p = cuda_ms(torch, lambda: korb.select_grid_plain(scores, shapes, per, scale), 3)
    ms_interp = orb_interp_ms(torch, imgs, shapes, n_levels)
    log(f"{W}x{H}, 2 images: orb_level_planes bit-equal, {n_padded} padded pixels a stack, "
        f"{ms_level:.4f} ms on the device (bound {b_level[0]:.4f} ms, {b_level[1]}; plain "
        f"{ms_level_p:.4f} ms; F.interpolate {ms_interp:.4f} ms); orb_select_grid bit-equal, "
        f"level 0 {n_cand} candidates, {n_pos} positive in all, "
        f"{int((sel[2] > 0).sum())} keypoints: {ms_sel:.4f} ms (bound {b_sel[0]:.6f} ms, "
        f"{b_sel[1]}; plain {ms_sel_p:.4f} ms)")
    return {"orb_level_planes": dict(ms=ms_level, plain_ms=ms_level_p, bound_ms=b_level[0],
                                     bound_by=b_level[1], library_ms=ms_interp,
                                     max_abs_err=err["level"]),
            "orb_select_grid": dict(ms=ms_sel, plain_ms=ms_sel_p, bound_ms=b_sel[0],
                                    bound_by=b_sel[1], max_abs_err=err["select"],
                                    level0_candidates=n_cand)}


def orb_kernel_rows(torch, pair, log=print, hd_size=(720, 1280)) -> dict:
    """Phase 5's rows of the three ORB kernels (``csrc/orb.cu``) on the real
    images ``pair`` (float32 [H, W] on the card): each against its plain
    version on one and on two images, bit for bit (the descriptors of every
    keypoint whose angle is equal; any other is printed and fails), then
    device ms behind a backlog beside the bound, the plain version and, for
    the pyramid, ``F.interpolate(..., "bilinear", antialias=True)`` of every
    level; then the pyramid and the grid top-k of the pair at ``hd_size``
    (``orb_hd_rows``; at 1280x720 level 0 holds 7,200 grid candidates), its
    errors joined to the rows', unless ``hd_size`` is None. Raises
    RuntimeError on a disagreement."""
    from tc2li_slam_torch.ops import orb
    from tc2li_slam_torch.ops.kernels import fast, orb as korb
    n_levels, scale, n_feat = 8, 1.2, 2000
    per = orb.features_per_level(n_feat, n_levels, scale)
    err = {"level": 0.0, "select": 0.0, "describe": 0.0}
    pad = korb.PAD
    for fs in (pair[:1], pair):
        imgs = torch.stack(fs)
        st, bl, shapes, e = orb_level_check(torch, korb, imgs, n_levels, scale)
        err["level"] = max(err["level"], e)
        scores = fast.detect_planes(st, shapes, pad)
        sel, e = orb_select_check(torch, korb, scores, shapes, per, scale)
        err["select"] = max(err["select"], e)
        rows, cols, score, level, _ = sel
        ang, desc = korb.orb_describe(st, bl, rows, cols, level, n_levels, pad)
        ang_p, desc_p = korb.describe_plain(st, bl, rows, cols, level, n_levels, pad)
        same_ang = ang.view(torch.int32) == ang_p.view(torch.int32)
        same_desc = (desc == desc_p).all(-1)
        bad = (~same_ang) | (same_ang & ~same_desc)
        err["describe"] = max(err["describe"], float((ang - ang_p).abs().max()))
        log(f"orb kernels, {len(fs)} image(s): {int(same_ang.sum())} of {same_ang.numel()} "
            f"angles bit-equal, descriptors equal on {int((same_ang & same_desc).sum())} of "
            f"them; {int((score > 0).sum())} keypoints")
        if bad.any():
            idx = bad.nonzero().tolist()[:10]
            raise RuntimeError(
                "orb_describe disagrees with its plain version at (image, keypoint) "
                + "; ".join(f"{b, i}: angle {float(ang[b, i])!r} vs {float(ang_p[b, i])!r}, "
                            f"words {desc[b, i].tolist()} vs {desc_p[b, i].tolist()}"
                            for b, i in idx))
    # timings and bounds on the two images, the main path's call
    B, H, W = imgs.shape
    K = rows.numel()
    b_level, n_padded = orb_level_bound(korb, shapes, B, H, W, n_levels)
    b_sel, n_pos = orb_select_bound(torch, korb, scores, shapes, per, n_levels, K)
    # the distinct pixels read on each plane (keypoints share them): the
    # masked patches' in img_stack and the rotated taps' in blur_stack; 3
    # ints in, an angle and 8 words out a keypoint; per keypoint the float64
    # multiply-adds of both moments over the masked patch counted twice (half
    # the float32 rate), 8 operations a tap, a compare a test
    n_img, n_blur, n_mask = describe_pixels(torch, st, rows, cols, level, ang, n_levels, pad)
    b_desc = bound(4 * (n_img + n_blur) + K * (12 + 36), K * (n_mask * 8 + 512 * 8 + 256))
    ms_level = cuda_ms(torch, lambda: korb.orb_level_planes(imgs, n_levels, scale), 50, True)
    ms_sel = cuda_ms(torch, lambda: korb.orb_select_grid(scores, shapes, per, scale), 50, True)
    ms_desc = cuda_ms(torch, lambda: korb.orb_describe(st, bl, rows, cols, level, n_levels, pad),
                      50, True)
    ms_level_p = cuda_ms(torch, lambda: korb.level_planes_plain(imgs, n_levels, scale), 5)
    ms_sel_p = cuda_ms(torch, lambda: korb.select_grid_plain(scores, shapes, per, scale), 5)
    ms_desc_p = cuda_ms(torch, lambda: korb.describe_plain(st, bl, rows, cols, level, n_levels,
                                                           pad), 5)
    ms_interp = orb_interp_ms(torch, imgs, shapes, n_levels)
    log(f"orb_level_planes, 2 images x {n_levels} levels ({n_padded} padded pixels a stack): "
        f"{ms_level:.4f} ms on the device (bound {b_level[0]:.4f} ms, {b_level[1]}; plain "
        f"{ms_level_p:.4f} ms; F.interpolate bilinear antialias, one call a level, "
        f"{ms_interp:.4f} ms); orb_select_grid, {len(shapes)} planes, {n_pos} positive "
        f"candidates: {ms_sel:.4f} ms (bound {b_sel[0]:.6f} ms, {b_sel[1]}; plain "
        f"{ms_sel_p:.4f} ms); orb_describe, {K} keypoints ({n_img} patch and {n_blur} tap "
        f"pixels): {ms_desc:.4f} ms (bound "
        f"{b_desc[0]:.6f} ms, {b_desc[1]}; plain {ms_desc_p:.4f} ms)")
    hd = orb_hd_rows(torch, pair, hd_size, log=log) if hd_size else {
        "orb_level_planes": {"max_abs_err": 0.0}, "orb_select_grid": {"max_abs_err": 0.0}}
    src, ref = "tc2li_slam_torch/csrc/orb.cu", "tc2li_slam_tpu/ops/orb.py"
    return {
        "orb_level_planes": dict(source=src, replaces=f"{ref}:425",
                                 max_abs_err=max(err["level"], hd["orb_level_planes"][
                                     "max_abs_err"]),
                                 ms=ms_level, plain_ms=ms_level_p, bound_ms=b_level[0],
                                 bound_by=b_level[1], library_ms=ms_interp),
        "orb_select_grid": dict(source=src, replaces=f"{ref}:204",
                                max_abs_err=max(err["select"], hd["orb_select_grid"][
                                    "max_abs_err"]),
                                ms=ms_sel, plain_ms=ms_sel_p, bound_ms=b_sel[0],
                                bound_by=b_sel[1]),
        "orb_describe": dict(source=src, replaces=f"{ref}:369", max_abs_err=err["describe"],
                             ms=ms_desc, plain_ms=ms_desc_p, bound_ms=b_desc[0],
                             bound_by=b_desc[1]),
    }


def profile_export_phase(torch, slam, frame, log=print):
    """4g, timers, trace and exporters, on phase 3's ``System`` (``profile``
    on) and one more of its frames ``frame = (img_l, img_r, t, scan)``: the
    stage report; a disabled ``StageTimer`` around a kernel launch records
    nothing; ``device_trace`` around that frame's ``track`` writes a Chrome
    trace that names the FAST and matcher kernels (on a CUDA device); the
    three exporters' vertex counts and ``draw_frame`` of that frame. Raises
    RuntimeError where a check fails."""
    import tempfile

    import numpy as np

    from tc2li_slam_torch.ops import orb, voxel_map
    from tc2li_slam_torch.slam import profiling, system as sys_mod, viewer

    dev = slam.device
    cuda = dev.type == "cuda"
    if not slam.timers.enabled or not slam.timers.stats().get("frame", {}).get("n"):
        raise RuntimeError("timers: phase 3's System recorded no frame with profile=True")
    log("stage timers of phase 3's System (profile=True; frames after the warm-up):\n"
        + slam.timers.report())
    img_l, img_r, t, scan = frame
    off = profiling.StageTimer(dev, enabled=False)
    with off.stage("orb.extract"):
        kp = orb.extract(torch.as_tensor(img_l).to(dev), slam.cfg.orb.n_features,
                         slam.cfg.orb.n_levels)
    if cuda:
        torch.cuda.synchronize()
    if off.stats() != {} or off._events:
        raise RuntimeError("timers: a disabled StageTimer recorded a stage")
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        with profiling.device_trace(tmp, dev) as path:
            slam.track(img_l, img_r, t, scan)
            if cuda:
                torch.cuda.synchronize()
        t0 = time.perf_counter()
        events = json.loads(path.read_text())["traceEvents"]
        kernels = [str(e.get("name", "")) for e in events if e.get("cat") == "kernel"]
        named = {k: sum(k in name for name in kernels) for k in ("fast_score", "fast_nms",
                                                                  "match_best2")}
        log(f"device_trace of one more frame of phase 3's System: {path.stat().st_size / 1e6:.1f} "
            f"MB of Chrome trace, {len(events)} events, {len(kernels)} kernels, parsed in "
            f"{time.perf_counter() - t0:.2f} s; kernels by name {named}")
        if slam.state != sys_mod.TrackingState.OK:
            raise RuntimeError(f"device_trace: the traced frame's state {slam.state}")
        if cuda and not (named["fast_score"] and named["match_best2"]):
            raise RuntimeError(f"device_trace: the trace does not name the kernels: {named}")

        m, vm = slam.map, slam.vmap
        stored = int((vm.keys != voxel_map.EMPTY_KEY).sum())
        want = {"map_points": int(m.lm_valid.sum()), "lidar_map": min(stored, 100_000),
                "keyframe_path": slam.n_kf_host}
        for name, fn in (("map_points", lambda p: viewer.export_map_points(slam, p)),
                         ("lidar_map", lambda p: viewer.export_lidar_map(slam, p,
                                                                         max_points=100_000)),
                         ("keyframe_path", lambda p: viewer.export_keyframe_path(slam, p))):
            p = str(Path(tmp) / f"{name}.ply")
            t0 = time.perf_counter()
            fn(p)
            out[name] = (ply_vertices(p), time.perf_counter() - t0)
        img = viewer.draw_frame(img_l, kp.xy.cpu().numpy(), kp.valid.cpu().numpy(),
                                state_text="OK")
    log(f"exporters: (vertices, seconds) {out} against {want} (voxel map {stored} points "
        f"stored); draw_frame {img.shape} {img.dtype}")
    if any(out[k][0] != want[k] for k in want):
        raise RuntimeError(f"exporters: vertex counts {out} against {want}")
    if img.shape != np.shape(img_l) + (3,):
        raise RuntimeError(f"draw_frame returned {img.shape}")
    return out


def scan_phase(torch, dev, n_rings: int = 64, n_points: int = 2048, log=print, timer=None):
    """4g, scan features: an organized ``n_rings`` x ``n_points`` scan
    (``scan_rings``) through ``extract_features_rings`` on ``dev`` and on the
    CPU; the masks must be equal but at points near a float gate
    (``scan_gate_near``). ``timer(fn) -> ms`` times one call. Returns the
    flips; raises RuntimeError where a check fails."""
    import numpy as np

    from tc2li_slam_torch.ops import scan_features as sf

    pts = scan_rings(n_rings, n_points)
    valid = np.ones(pts.shape[:2], bool)
    p_d, v_d = torch.as_tensor(pts).to(dev), torch.as_tensor(valid).to(dev)
    got = sf.extract_features_rings(p_d, v_d)
    ref = sf.extract_features_rings(torch.as_tensor(pts), torch.as_tensor(valid))
    near = scan_gate_near(sf, pts, valid, 2.0)
    flips = {k: (getattr(got, k).cpu() != getattr(ref, k)).numpy() for k in got._fields}
    outside = {k: int((f & ~near).sum()) for k, f in flips.items()}
    counts = {k: int(getattr(ref, k).sum()) for k in got._fields}
    ms = timer(lambda: sf.extract_features_rings(p_d, v_d)) if timer else None
    log(f"scan features, {n_rings} rings x {n_points} points on {dev}: {counts} on the CPU; "
        f"flips against the CPU {({k: int(f.sum()) for k, f in flips.items()})}, of them "
        f"away from a float gate {outside} ({int(near.sum())} points lie near one); "
        + (f"{ms:.4f} ms a call on the device" if ms is not None else "not timed"))
    if any(outside.values()):
        raise RuntimeError(f"scan features: masks differ away from a float gate: {outside}")
    if counts["plane"] < pts.shape[0] * pts.shape[1] // 2 or counts["edge"] < n_rings:
        raise RuntimeError(f"scan features: {counts}")
    return {k: int(f.sum()) for k, f in flips.items()}


def dist_phase(torch, dev, cfg, frames, gt, ref, backend: str = "nccl", log=print,
               reset_counts=lambda: None, read_counts=dict):
    """4g, distributed BA on a world-size-1 group of ``backend`` made from a
    file store: the reference's test problem through ``dist_ba.optimize`` on
    ``dev`` against a gloo group on the CPU and against ``lm.local_ba``; the
    KITTI-shaped window at full width (ms an iteration, host syncs, peak
    memory); then ``System(cfg, dev, mesh=...)`` on ``frames`` (tuples for
    ``track``) with ground truth ``gt``, held against ``ref`` (the run
    without a mesh: its ATE, ``local_ba`` stage statistics and per-pass ms).
    The group is destroyed at the end. Raises RuntimeError where a check
    fails."""
    import tempfile

    import numpy as np
    import torch.distributed as dist

    from tc2li_slam_torch.io import synthetic as syn
    from tc2li_slam_torch.parallel import dist_ba
    from tc2li_slam_torch.solver import lm as lm_mod
    from tc2li_slam_torch.slam import local_mapping, system as sys_mod

    cuda = torch.device(dev).type == "cuda"
    out = {}

    def tensors(p, d):
        obs = lm_mod.BAObservations(*(torch.as_tensor(p[k]).to(d) for k in (
            "pose_idx", "uv", "inv_sigma2", "stereo", "valid")))
        return (torch.as_tensor(p["T0"]).to(d), torch.as_tensor(p["X0"]).to(d), obs,
                torch.as_tensor(p["fixed"]).to(d))

    def solve(mesh, cam, args, iters):
        T0, X0, obs, fixed = args
        valid = torch.ones(X0.shape[0], dtype=torch.bool, device=X0.device)
        return dist_ba.optimize(mesh, cam, T0, *dist_ba.shard_problem(mesh, X0, obs, valid),
                                fixed, iters=iters)

    def single(cam, args, iters):
        T0, X0, obs, fixed = args
        valid = torch.ones(X0.shape[0], dtype=torch.bool, device=X0.device)
        return lm_mod.local_ba(cam, T0, X0, obs, fixed, valid, iters=iters)

    with tempfile.TemporaryDirectory() as tmp:
        mesh = dist_ba.make_mesh(backend, f"file://{tmp}/store", 0, 1)
        try:
            gloo = dist_ba.mesh_of(dist.new_group([0], backend="gloo"))
            # (1) the reference's test problem
            cam, p = dist_problem(torch, np.random.default_rng(0))
            T_d, X_d, c_d = solve(mesh, cam, tensors(p, dev), 10)
            T_c, X_c, c_c = solve(gloo, cam, tensors(p, "cpu"), 10)
            res = single(cam, tensors(p, dev), 10)
            d_cpu = float((T_d.cpu() - T_c).abs().max())
            d_lm = float((X_d.cpu() - X_c).abs().max())
            d_single = float((T_d - res.T_cw).abs().max())
            out["vs_cpu"], out["vs_local_ba"] = d_cpu, d_single
            log(f"dist_ba.optimize, {backend} world size 1 on {dev}, P 6, L 512, K 4, 10 "
                f"iterations: poses against a gloo group on the CPU {d_cpu:.2e} (landmarks "
                f"{d_lm:.2e} m, cost {float(c_d):.6f} / {float(c_c):.6f}); against lm.local_ba "
                f"on {dev} {d_single:.2e}")
            if not d_cpu <= 1e-4 or not d_lm <= 5e-3 or not d_single < 5e-3:
                raise RuntimeError(f"dist_ba: poses {d_cpu} from the CPU, landmarks {d_lm}, "
                                   f"{d_single} from lm.local_ba")

            # (2) the KITTI-shaped window: P 6, max_active 8192, K = max_obs 8
            t = cfg.tracking
            cam_w, pw = dist_problem(torch, np.random.default_rng(1), Pn=t.local_window,
                                     L=t.ba_active_landmarks, K=t.max_obs)
            if cuda:
                args = tensors(pw, dev)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                ms = cuda_ms(torch, lambda: solve(mesh, cam_w, args, t.ba_iters), 3)
                peak = torch.cuda.max_memory_allocated() / 2 ** 30
                ms_lm = cuda_ms(torch, lambda: single(cam_w, args, t.ba_iters), 3)
                syncs = [syncs_of(torch, lambda: solve(mesh, cam_w, args, t.ba_iters)),
                         syncs_of(torch, lambda: single(cam_w, args, t.ba_iters))]
                out["full_ms_per_iter"] = ms / t.ba_iters
                log(f"dist_ba.optimize at full width (P {t.local_window}, L "
                    f"{t.ba_active_landmarks}, K {t.max_obs}, {t.ba_iters} iterations, no BALM "
                    f"term): {ms / t.ba_iters:.3f} ms an iteration ({ms:.2f} ms a call), "
                    f"lm.local_ba {ms_lm / t.ba_iters:.3f} ms an iteration; host syncs a call "
                    f"{syncs[0]} (lm.local_ba {syncs[1]}); peak device memory {peak:.3f} GiB")
                if syncs[0] != 0:
                    raise RuntimeError(f"dist_ba.optimize synchronised the host {syncs[0]} times")

            # (3) the System through the mesh on the same frames, with the
            # BALM quadratic's evaluations counted
            slam = sys_mod.System(cfg, dev, mesh=mesh)
            states, syncs = [], []
            balm_extra, n_balm = local_mapping._balm_extra, [0]

            def counted(*a, **kw):
                n_balm[0] += 1
                return balm_extra(*a, **kw)

            local_mapping._balm_extra = counted
            reset_counts()
            try:
                for i, args in enumerate(frames):
                    if i == N_WARM:
                        if cuda:
                            torch.cuda.synchronize()
                        slam.timers.reset()
                    syncs.append(syncs_of(torch, lambda: slam.track(*args)))
                    states.append(slam.state)
                if cuda:
                    torch.cuda.synchronize()
                counts = read_counts()
                out.update(n_ba_balm=slam.n_ba_balm, n_balm_evals=n_balm[0])
                # the stages as phase 3 reads them: before the last mapping
                # pass, which the trajectory's flush runs
                ba = slam.timers.stats().get("local_ba", {"mean_ms": float("nan"), "n": 0})
                passes = [round(1e3 * x, 1) for x in slam.timers.samples.get("local_ba", [])]
                ate = syn.ate_rmse(slam.trajectory_world_from_cam(), gt)
            finally:
                local_mapping._balm_extra = balm_extra
            ba0 = ref["stats"].get("local_ba", {"mean_ms": float("nan"), "n": 0})
            out.update(ate=ate, syncs=syncs, local_ba_ms=ba["mean_ms"], counts=counts)
            log(f"System(mesh={backend} world size 1) on {len(frames)} frames: ATE {ate:.4f} m "
                f"(without a mesh {ref['ate']:.4f} m), keyframes {slam.n_kf_host}, local BA "
                f"passes {slam.n_ba} ({slam.n_ba_balm} with BALM), the BALM quadratic evaluated "
                f"{n_balm[0]} times in them; local_ba stage {ba['mean_ms']:.1f} ms a pass over {ba['n']} "
                f"passes after frame {N_WARM}, by pass {passes} (without a mesh "
                f"{ba0['mean_ms']:.1f} ms over {ba0['n']}, by pass {ref.get('local_ba_ms')}); "
                f"host syncs by frame {syncs}; kernel launches {counts}")
            if any(s != sys_mod.TrackingState.OK for s in states) or slam.n_ba < 1:
                raise RuntimeError(f"System(mesh): states {states}, {slam.n_ba} BA passes")
            if not ate < ATE_BOUND_M or not ate <= 1.5 * ref["ate"] + 0.02:
                raise RuntimeError(f"System(mesh): ATE {ate:.4f} m against {ref['ate']:.4f} m")
            if cuda and (max(syncs[1:]) > 2 or np.mean(syncs[1:]) > 1.2):
                raise RuntimeError(f"System(mesh): host syncs by frame {syncs}")
            n = len(frames)
            if cuda and any(counts[k] != n * FRAME_LAUNCHES[k] for k in FRAME_KERNELS):
                raise RuntimeError(f"System(mesh): launches {counts} for {n} frames")
        finally:
            dist.destroy_process_group()
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is false: this smoke run needs a CUDA card")
    root = Path(__file__).resolve().parent
    if not (root / "tc2li_slam_torch" / "csrc").is_dir():
        return fail(f"no tc2li_slam_torch package beside {__file__}")
    sys.path.insert(0, str(root))
    import numpy as np

    from tc2li_slam_torch.estimation import imu as imu_mod
    from tc2li_slam_torch.geom import camera as cam_mod, lie, triangulate as tri_geom
    from tc2li_slam_torch.io import synthetic as syn
    from tc2li_slam_torch.ops import bow, orb, stereo
    from tc2li_slam_torch.ops.kernels import (balm as kbalm, build, clusters as kcl, fast,
                                              hamming, imu_preint as kimu,
                                              inertial_init as kii, lio as klio,
                                              local_ba as klba, lvi_ba as klvi, match,
                                              orb as korb, pose_graph as kpg,
                                              pose_inertial as kpi, pose_lm, stereo as kst)
    from tc2li_slam_torch.slam import (config as cfg_mod, culling, lio, local_mapping,
                                       relocalization, system as sys_mod, tracking,
                                       triangulation)
    from tc2li_slam_torch.solver import (balm as balm_mod, inertial_ba as iba_mod,
                                         inertial_init as ii_mod, lm as lm_mod, pnp as pnp_mod,
                                         pose_inertial as pi_mod)

    t_script = time.perf_counter()
    dev = torch.device("cuda")
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    tag = f"[{kind} | {smi}]"
    print(f"card: {smi}", flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {kind}, "
          f"{torch.cuda.device_count()} device(s)", flush=True)

    # --- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    lib_path = build.build()
    build.library()
    print(f"kernels built in {time.perf_counter() - t0:.2f} s -> {lib_path.name}", flush=True)
    if build.ptxas_log:
        print("\n".join(ln for ln in build.ptxas_log.splitlines()
                        if "registers" in ln or "Compiling" in ln), flush=True)

    # --- data ----------------------------------------------------------------
    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    world = syn.make_world(rng, n_surf=300_000)
    # one sequence: phase 3 takes its first N_FRAMES frames, the IMU-mode
    # run (4e) N_IMU and the two after them for its bad-IMU event
    traj = syn.Trajectory(w_body=(0, 0, 0.03), v_world=(1.5, 0.1, 0.0))
    frames_all, _, _ = syn.generate_sequence(
        n_frames=N_IMU + 2, cam=syn.KITTI_LIKE, seed=0, n_scan=1 << 17, world=world, traj=traj,
        stereo_pairs=render_pairs(syn.KITTI_LIKE, world, syn.trajectory_poses(traj, N_IMU + 2)))
    scans = [np.where(fr.scan_valid[:, None], fr.scan, 0.0)[::4].astype(np.float32)
             for fr in frames_all]
    imgs = [(np.clip(fr.img_l, 0, 255).astype(np.uint8),
             np.clip(fr.img_r, 0, 255).astype(np.uint8)) for fr in frames_all]
    gt_all = np.stack([fr.T_wb_gt @ syn.body_from_cam() for fr in frames_all])
    frames = frames_all[:N_FRAMES]
    print(f"generated {N_IMU + 2} KITTI-shaped frames in {time.perf_counter() - t0:.1f} s "
          f"(scan {scans[0].shape[0]} points)", flush=True)

    # what the run implies of pose_only_lm's launches: one per track_frame
    # and one per pnp_ransac call, counted where the port calls them (their
    # module attributes); and the inputs of the last pose_only_optimize call
    # of each form (4 rounds: tracking; 2: PnP's polish), for phase 5
    calls = {"track_frame": 0, "pnp_ransac": 0}
    pose_inputs = {}
    # what the run implies of local_ba_lm's launches: launches_per_call(iters)
    # for each run_local_ba call off the mesh (the global BA's included),
    # counted where System calls it; and the inputs of the last local-BA call
    # with the BALM term, of the last 64-pose one (the global BA) and of the
    # last BALM quadratic, for phase 5
    ba_calls = {"run_local_ba": 0, "global_ba": 0, "implied": 0}
    ba_inputs = {}

    def spy(mod, name, record=None):
        fn = getattr(mod, name)

        def wrapped(*a, **kw):
            if record is None:
                calls[name] += 1
            else:
                form = {"rounds": 4, "iters": 10, **kw}   # the defaults made explicit
                record[form["rounds"]] = (a, form)
            return fn(*a, **kw)
        setattr(mod, name, wrapped)

    spy(tracking, "track_frame")
    spy(pnp_mod, "pnp_ransac")
    spy(lm_mod, "pose_only_optimize", pose_inputs)

    run_local_ba, global_ba = local_mapping.run_local_ba, sys_mod.System._global_ba
    local_ba, quadratic = lm_mod.local_ba, balm_mod.quadratic

    def run_local_ba_spy(*a, **kw):
        if kw.get("mesh") is None:
            ba_calls["run_local_ba"] += 1
            ba_calls["implied"] += klba.launches_per_call(kw.get("iters", 8))
        return run_local_ba(*a, **kw)

    def global_ba_spy(self, *a, **kw):
        ba_calls["global_ba"] += 1
        return global_ba(self, *a, **kw)

    def local_ba_spy(*a, **kw):
        if kw.get("extra_fn") is not None:
            ba_inputs["balm"] = (a, kw)
        if a[1].shape[0] == sys_mod.System.GLOBAL_BA_KFS:
            ba_inputs["global"] = (a, kw)
        return local_ba(*a, **kw)

    build_clusters = balm_mod.build_clusters

    def build_clusters_spy(*a, **kw):
        ba_inputs["clusters"] = (a, kw)
        return build_clusters(*a, **kw)

    def quadratic_spy(c, T_wl):
        ba_inputs["quadratic"] = (c, T_wl)
        ba_inputs.setdefault("valid_voxels", []).append(c.valid.sum())   # (read later)
        return quadratic(c, T_wl)

    # what the run implies of the IMU mode's two kernels: imu_preintegrate
    # once an estimation.imu.integrate call (System._integrate), and
    # pose_inertial_lm once a refined frame (System's n_vi_refine_kf and
    # n_vi_refine_frame); and the inputs of the last call of each form and
    # of the longest and the last preintegration, for phase 5
    vi_calls = {"integrate": 0}
    vi_inputs = {}
    integrate = imu_mod.integrate

    def integrate_spy(*a, **kw):
        vi_calls["integrate"] += 1
        vi_inputs["integrate:last"] = a
        if a[1].shape[0] >= vi_inputs.get("integrate:longest", a)[1].shape[0]:
            vi_inputs["integrate:longest"] = a
        return integrate(*a, **kw)

    imu_mod.integrate = integrate_spy
    # ... and of the scan step's four kernels: launches_per_scan(max_iters)
    # a lio_scan_step call, and its last call's arguments, for phase 5
    lio_calls = {"lio_scan_step": 0}
    lio_inputs = {}
    lio_scan_step = lio.lio_scan_step

    def lio_spy(*a, **kw):
        lio_calls["lio_scan_step"] += 1
        lio_inputs["last"] = a
        return lio_scan_step(*a, **kw)

    lio.lio_scan_step = lio_spy
    for name in ("optimize_last_kf", "optimize_last_frame"):
        def vi_spy(*a, _fn=getattr(pi_mod, name), _name=name, **kw):
            vi_inputs[_name] = a
            return _fn(*a, **kw)
        setattr(pi_mod, name, vi_spy)

    # ... and of the LVI-BA's kernels: launches_per_call(iters) an
    # inertial_ba.lvi_ba call (System's n_lvi_ba), and the last call's
    # arguments, for phase 5
    lvi_calls = {"lvi_ba": 0, "implied": 0}
    lvi_inputs = {}
    lvi_ba = iba_mod.lvi_ba

    def lvi_spy(*a, **kw):
        lvi_calls["lvi_ba"] += 1
        lvi_calls["implied"] += klvi.launches_per_call(kw.get("iters", 8))
        lvi_inputs["last"] = (a, kw)
        return lvi_ba(*a, **kw)

    iba_mod.lvi_ba = lvi_spy
    # ... and of the visual-inertial initialization's kernel: one launch an
    # inertial_init.inertial_optimization call (System._initialize_imu), and
    # every call's arguments, for the rungs' gates and phase 5
    init_calls = {"inertial_optimization": 0}
    init_inputs = []
    inertial_optimization = ii_mod.inertial_optimization

    def init_spy(*a, **kw):
        init_calls["inertial_optimization"] += 1
        init_inputs.append((a, kw))
        return inertial_optimization(*a, **kw)

    ii_mod.inertial_optimization = init_spy
    local_mapping.run_local_ba = run_local_ba_spy
    sys_mod.System._global_ba = global_ba_spy
    lm_mod.local_ba = local_ba_spy
    balm_mod.quadratic = quadratic_spy
    balm_mod.build_clusters = build_clusters_spy

    def reset_counts():
        fast.score_launches = fast.nms_launches = hamming.launches = match.launches = 0
        pose_lm.launches = calls["track_frame"] = calls["pnp_ransac"] = 0
        kbalm.launches = klba.launches = kst.launches = kcl.launches = 0
        kimu.launches = kpi.launches = vi_calls["integrate"] = 0
        klvi.launches = lvi_calls["lvi_ba"] = lvi_calls["implied"] = 0
        kii.launches = init_calls["inertial_optimization"] = kpg.launches = 0
        klio.predict_launches = klio.fence_launches = klio.rows_launches = 0
        klio.step_launches = 0
        lio_calls["lio_scan_step"] = 0
        korb.level_launches = korb.select_launches = korb.describe_launches = 0
        ba_calls.update(dict.fromkeys(ba_calls, 0))
        ba_inputs["valid_voxels"] = []
        match.launches_by_mode.clear()

    def read_counts():
        return {"orb_level_planes": korb.level_launches, "fast_score_planes": fast.score_launches,
                "fast_nms_planes": fast.nms_launches, "orb_select_grid": korb.select_launches,
                "orb_describe": korb.describe_launches,
                "hamming_matrix": hamming.launches, "match_best2": match.launches,
                "pose_only_lm": pose_lm.launches, "calls:track_frame": calls["track_frame"],
                "calls:pnp_ransac": calls["pnp_ransac"], "balm_quadratic": kbalm.launches,
                "stereo_refine": kst.launches, "balm_clusters": kcl.launches,
                "local_ba_lm": klba.launches, "calls:run_local_ba": ba_calls["run_local_ba"],
                "calls:global_ba": ba_calls["global_ba"],
                "implied:local_ba_lm": ba_calls["implied"],
                "imu_preintegrate": kimu.launches, "pose_inertial_lm": kpi.launches,
                "calls:integrate": vi_calls["integrate"],
                "lvi_ba_lm": klvi.launches, "calls:lvi_ba": lvi_calls["lvi_ba"],
                "implied:lvi_ba_lm": lvi_calls["implied"],
                "inertial_init_gn": kii.launches,
                "calls:inertial_optimization": init_calls["inertial_optimization"],
                "pose_graph_gn": kpg.launches,
                "esekf_predict": klio.predict_launches, "lio_fences": klio.fence_launches,
                "lio_rows": klio.rows_launches, "esekf_step": klio.step_launches,
                "calls:lio_scan_step": lio_calls["lio_scan_step"]}

    def ba_fault(counts, n_balm, n_lvi_balm=0, mesh_iters=0):
        """None if balm_clusters launched once a local-BA or LVI-BA pass with
        the BALM term (its build_clusters call), balm_quadratic twice a local-BA
        pass with it (2 x iters on the mesh path) and once an LVI-BA pass, and
        local_ba_lm launches_per_call(iters) times a run_local_ba call off
        the mesh."""
        want = n_balm * (2 * mesh_iters if mesh_iters else 2) + n_lvi_balm
        faults = []
        if counts["balm_clusters"] != n_balm + n_lvi_balm:
            faults.append(f"balm_clusters launched {counts['balm_clusters']} times for "
                          f"{n_balm + n_lvi_balm} passes with the BALM term (one a pass)")
        if counts["balm_quadratic"] != want:
            faults.append(f"balm_quadratic launched {counts['balm_quadratic']} times for "
                          f"{n_balm} BALM local-BA passes and {n_lvi_balm} LVI-BA passes with "
                          f"BALM (expected {want})")
        if counts["local_ba_lm"] != counts["implied:local_ba_lm"]:
            faults.append(f"local_ba_lm launched {counts['local_ba_lm']} times for "
                          f"{counts['calls:run_local_ba']} run_local_ba calls (expected "
                          f"{counts['implied:local_ba_lm']})")
        return "; ".join(faults) or None

    def pose_fault(counts):
        """None if pose_only_lm launched once per track_frame and pnp_ransac
        call, and at least once."""
        implied = counts["calls:track_frame"] + counts["calls:pnp_ransac"]
        if counts["pose_only_lm"] != implied or implied < 1:
            return (f"pose_only_lm launched {counts['pose_only_lm']} times for "
                    f"{counts['calls:track_frame']} track_frame and "
                    f"{counts['calls:pnp_ransac']} pnp_ransac calls")
        return None

    # --- 3. the slice --------------------------------------------------------
    cfg = kitti_config(cfg_mod, syn)
    slam = sys_mod.System(cfg, dev)
    gt = gt_all[:N_FRAMES]
    states = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t_start = time.perf_counter()
    t_warm = None
    lm_at_tri = None
    for i, fr in enumerate(frames):
        if i == N_WARM:
            torch.cuda.synchronize()
            slam.timers.reset()
            t_warm = time.perf_counter()
        slam.track(imgs[i][0], imgs[i][1], fr.t, scans[i])
        states.append(slam.state)
        if i == N_TRI - 1:     # device scalars, read after the run: no sync here
            lm_at_tri = (slam.map.n_lm, slam.n_kf_host)
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    launches, modes3 = read_counts(), dict(match.launches_by_mode)
    n_fuse, n_ba3, n_balm3 = slam.n_fuse, slam.n_ba, slam.n_ba_balm
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    stats = slam.timers.stats()
    est = slam.trajectory_world_from_cam()
    ate = syn.ate_rmse(est, gt)
    n_kf = int(slam.map.n_kf)
    n_lm = int(slam.map.n_lm)
    vcount = int(slam.vmap.count)
    n_steady = N_FRAMES - N_WARM
    fps_all = N_FRAMES / (t_end - t_start)
    fps_steady = n_steady / (t_end - t_warm)
    print(f"{tag} slice: {N_FRAMES} frames, ATE {ate:.4f} m, keyframes {n_kf}, "
          f"landmarks {n_lm}, voxel map {vcount} points, local BA passes {slam.n_ba} "
          f"({slam.n_ba_balm} with BALM), fuse passes {slam.n_fuse}", flush=True)
    print(f"{tag} frames/s: {fps_all:.3f} over all {N_FRAMES} frames, "
          f"{fps_steady:.3f} over frames {N_WARM}..{N_FRAMES - 1}; peak device memory "
          f"{peak_gib:.2f} GiB", flush=True)
    print(f"{tag} device ms/frame by stage (CUDA events, frames "
          f"{N_WARM}..{N_FRAMES - 1}): "
          + json.dumps({k: round(1e3 * v["total_s"] / n_steady, 3) for k, v in stats.items()}),
          flush=True)
    track_ms = 1e3 * stats["track_step"]["total_s"] / n_steady
    print(f"{tag} track_step stage: {track_ms:.3f} ms a frame over frames {N_WARM}..{N_FRAMES - 1} "
          f"(CUDA events, {stats['track_step']['n']} calls; pose_only_optimize is one "
          f"pose_only_lm launch in it)", flush=True)
    print(f"kernel launches during the slice: {launches}", flush=True)
    ba_ms = [round(1e3 * x, 1) for x in slam.timers.samples.get("local_ba", [])]
    print(f"{tag} local_ba stage by pass over frames {N_WARM}..{N_FRAMES - 1} (CUDA events, "
          f"ms): {ba_ms}; {n_ba3} mapping passes, {n_balm3} with BALM: balm_quadratic "
          f"{launches['balm_quadratic']} launches, local_ba_lm {launches['local_ba_lm']} "
          f"({klba.launches_per_call(cfg.tracking.ba_iters)} a call)", flush=True)
    track_case = pose_inputs[4]        # the slice's last frame
    balm_case3 = ba_inputs.get("balm")   # the slice's last BALM local-BA pass
    quad_case3 = ba_inputs.get("quadratic")
    clusters_case3 = ba_inputs.get("clusters")   # the slice's last build_clusters call
    print(f"valid voxels of the BALM quadratics of the slice, call by call: "
          f"{[int(v) for v in ba_inputs['valid_voxels']]} of "
          f"{cfg.lidar.balm_max_voxels} slots ({cfg.lidar.kf_points} points a LiDAR keyframe, "
          f"{cfg.lidar.balm_voxel} m voxels, at least {cfg.lidar.balm_min_points} points)",
          flush=True)

    if any(s != sys_mod.TrackingState.OK for s in states):
        return fail(f"tracking states {states}")
    if n_kf < 3:
        return fail(f"only {n_kf} keyframes")
    if slam.n_ba_balm < 1:
        return fail("no local BA pass with the BALM term ran")
    if vcount <= 0:
        return fail("voxel map is empty")
    if not np.all(np.isfinite(est)):
        return fail("non-finite poses")
    expected = {**{k: N_FRAMES * v for k, v in FRAME_LAUNCHES.items()}, "hamming_matrix": 0, "match_best2": N_FRAMES + (N_FRAMES - 1) + n_fuse,
                "pose_only_lm": N_FRAMES - 1, "calls:track_frame": N_FRAMES - 1,
                "calls:pnp_ransac": 0, "balm_quadratic": 2 * n_balm3, "balm_clusters": n_balm3,
                "local_ba_lm": klba.launches_per_call(cfg.tracking.ba_iters) * n_ba3,
                "calls:run_local_ba": n_ba3, "calls:global_ba": 0,
                "implied:local_ba_lm": klba.launches_per_call(cfg.tracking.ba_iters) * n_ba3,
                "imu_preintegrate": 0, "pose_inertial_lm": 0, "calls:integrate": 0,
                "lvi_ba_lm": 0, "calls:lvi_ba": 0, "implied:lvi_ba_lm": 0,
                "inertial_init_gn": 0, "calls:inertial_optimization": 0, "pose_graph_gn": 0,
                "esekf_predict": 0, "lio_fences": 0, "lio_rows": 0, "esekf_step": 0,
                "calls:lio_scan_step": 0}
    if launches != expected or slam.n_recover or slam.n_reloc:
        return fail(f"launches {launches} != {expected} (one detection per frame; a stereo "
                    f"match per frame, a tracking match and a pose-only LM per tracked frame, "
                    f"{n_fuse} fuse passes; two BALM quadratics and one local_ba_lm call a "
                    f"mapping pass, {n_ba3} passes; recoveries {slam.n_recover}, "
                    f"relocalizations {slam.n_reloc})")
    if modes3 != {"stereo+mutual": N_FRAMES, "window": N_FRAMES - 1 + n_fuse}:
        return fail(f"match_best2 launches by call shape {modes3}: a stereo match per frame, "
                    f"a window per tracked frame and per fuse pass")
    # the matcher's row in the result is its window shape; the stereo shape
    # (one a frame build, through stereo_refine) has a row of its own
    launches["match_best2"] = modes3["window"]
    launches["match_best2/stereo"] = modes3["stereo+mutual"]
    if n_balm3 < 1 or balm_case3 is None or quad_case3 is None or clusters_case3 is None:
        return fail("no local BA pass with the BALM term went through the kernels")
    if n_fuse < 1:
        return fail("no fuse pass ran")
    if not ate < ATE_BOUND_M:
        return fail(f"ATE {ate:.4f} m >= {ATE_BOUND_M} m")

    # --- 4. the duplicate-fusion pass (Hamming matrix) -----------------------
    # (phase 4g tracks more frames on this System: phase 5 reads the map and
    # the reference keyframe of the slice as they are here)
    m, kf_slice = slam.map, max(slam.ref_kf, 0)
    high_water = int(torch.nonzero(m.lm_valid).max()) + 1
    pool = max(2048, high_water)
    if pool > 8192:
        return fail(f"{high_water} landmark slots in use: too many for the O(L^2) fusion pass")
    lm_fields = {f.name: getattr(m, f.name)[:pool] for f in dataclasses.fields(m)
                 if f.name.startswith("lm_")}
    sub = m.replace(**lm_fields)
    sub_cpu = sub.replace(**{f.name: getattr(sub, f.name).cpu() for f in dataclasses.fields(sub)})
    reset_counts()
    fused = culling.fuse_duplicates(sub, radius=0.25)
    torch.cuda.synchronize()
    fuse_counts = read_counts()
    fused_cpu = culling.fuse_duplicates(sub_cpu, radius=0.25)
    if fuse_counts["hamming_matrix"] != 1:
        return fail(f"fuse_duplicates launched the Hamming kernel {fuse_counts['hamming_matrix']} times")
    for name in ("lm_valid", "kf_feat_lm", "lm_found", "lm_visible", "n_lm"):
        if not torch.equal(getattr(fused, name).cpu(), getattr(fused_cpu, name)):
            return fail(f"fuse_duplicates on the card disagrees with the CPU in {name}")
    launches["hamming_matrix"] = fuse_counts["hamming_matrix"]
    print(f"fuse_duplicates over {pool} landmark slots ({int(sub.n_lm)} valid): "
          f"{int(sub.n_lm) - int(fused.n_lm)} merged, equal to the CPU route; "
          f"Hamming launches {fuse_counts['hamming_matrix']}", flush=True)

    # --- 4a. the default configuration: triangulate=True, with a vocabulary ---
    S = sys_mod.TrackingState
    dt = float(frames[1].t - frames[0].t)

    # the matcher's wrapper counts its launches by call shape; the rows of
    # the three new shapes report the sum of the readings of phases 4a-4d
    shape_launches = dict.fromkeys(("match_best2/epipolar", "match_best2/global",
                                    "match_best2/reloc"), 0)

    def read_modes():
        return dict(match.launches_by_mode)

    def tally(modes, before, after):
        """A phase's launches of the three shapes: the epipolar ones; of the
        unmasked mutual ones, one a recovery (global tracking) and the rest
        relocalization candidates'."""
        n_global = min(modes.get("none+mutual", 0), after["n_recover"] - before["n_recover"])
        shape_launches["match_best2/epipolar"] += modes.get("epipolar+mutual", 0)
        shape_launches["match_best2/global"] += n_global
        shape_launches["match_best2/reloc"] += modes.get("none+mutual", 0) - n_global

    def snap(sl):
        return dict(n_recover=sl.n_recover, n_reloc=sl.n_reloc, n_fuse=sl.n_fuse, n_ba=sl.n_ba,
                    n_ba_balm=sl.n_ba_balm, n_lvi_ba=getattr(sl, "n_lvi_ba", 0),
                    n_lvi_ba_balm=getattr(sl, "n_lvi_ba_balm", 0))   # (IMU mode only)

    def cross_check(counts, modes, n_built, n_tracked, before, after, n_reloc_calls,
                    imu=False):
        """What the system's own counts say of the measured launches, or
        None: a detection and a stereo match per frame built; a windowed
        match per tracked frame, per recovery and per fuse pass, and one to
        three per relocalization (its refinement); an unmasked mutual match
        per recovery (global tracking) and per relocalization candidate, at
        most five candidates a relocalization, one launch each; at most
        ``tri_pairs`` epipolar matches a mapping pass; no other call shape;
        ``inertial_init_gn`` once an ``inertial_optimization`` call, which
        only the IMU mode (``imu``) makes."""
        d = {k: after[k] - before[k] for k in after}
        get = modes.get
        window_lo = n_tracked + d["n_recover"] + d["n_fuse"]
        faults = []
        if any(counts[k] != n_built * FRAME_LAUNCHES[k] for k in FRAME_KERNELS) \
                or counts["hamming_matrix"]:
            faults.append(f"{n_built} frames built")
        if sum(modes.values()) != counts["match_best2"]:
            faults.append("the shapes do not sum to the matcher's count")
        if get("stereo+mutual", 0) != n_built:
            faults.append(f"{n_built} stereo matches")
        if not window_lo <= get("window", 0) <= window_lo + 3 * n_reloc_calls:
            faults.append(f"{window_lo}..{window_lo + 3 * n_reloc_calls} windowed matches")
        if not d["n_recover"] <= get("none+mutual", 0) <= d["n_recover"] + 5 * n_reloc_calls:
            faults.append(f"{d['n_recover']} global matches and at most {5 * n_reloc_calls} "
                          f"relocalization candidates' matches")
        if get("epipolar+mutual", 0) > cfg2.tracking.tri_pairs * d["n_ba"]:
            faults.append(f"at most {cfg2.tracking.tri_pairs * d['n_ba']} epipolar matches")
        if set(modes) - {"stereo+mutual", "window", "none+mutual", "epipolar+mutual"}:
            faults.append("no other call shape")
        # a track_frame per tracked frame and per recovery, one to three per
        # relocalization; a pnp_ransac per recovery, at most five per
        # relocalization; pose_only_lm once per call of either
        tf, pr = counts["calls:track_frame"], counts["calls:pnp_ransac"]
        tf_lo = n_tracked + d["n_recover"]
        if not tf_lo <= tf <= tf_lo + 3 * n_reloc_calls or \
                not d["n_recover"] <= pr <= d["n_recover"] + 5 * n_reloc_calls:
            faults.append(f"{tf_lo}..{tf_lo + 3 * n_reloc_calls} track_frame and "
                          f"{d['n_recover']}..{d['n_recover'] + 5 * n_reloc_calls} pnp_ransac calls")
        if pose_fault(counts):
            faults.append(pose_fault(counts))
        # a local BA pass is a run_local_ba call unless it was an LVI-BA pass
        if ba_fault(counts, d["n_ba_balm"], d["n_lvi_ba_balm"]):
            faults.append(ba_fault(counts, d["n_ba_balm"], d["n_lvi_ba_balm"]))
        if counts["calls:run_local_ba"] != d["n_ba"] - d["n_lvi_ba"] + counts["calls:global_ba"]:
            faults.append(f"{d['n_ba'] - d['n_lvi_ba']} run_local_ba calls")
        # ... the visual-inertial initialization one launch a call
        n_init = counts["calls:inertial_optimization"]
        if counts["inertial_init_gn"] != n_init or (n_init and not imu):
            faults.append(f"inertial_init_gn launched {counts['inertial_init_gn']} times for "
                          f"{n_init} inertial_optimization calls (IMU mode {imu})")
        # ... and no loop closure: no pose graph
        if counts["pose_graph_gn"]:
            faults.append(f"pose_graph_gn launched {counts['pose_graph_gn']} times without "
                          f"loop closing")
        # ... and an inertial_ba.lvi_ba call, launches_per_call(iters) launches
        if counts["calls:lvi_ba"] != d["n_lvi_ba"] \
                or counts["lvi_ba_lm"] != counts["implied:lvi_ba_lm"]:
            faults.append(f"{d['n_lvi_ba']} lvi_ba calls, lvi_ba_lm launched "
                          f"{counts['implied:lvi_ba_lm']} times")
        if faults:
            return f"launches {counts} by shape {modes} against {d}: expected " + "; ".join(faults)
        return None

    def gt_cw(i):
        return np.linalg.inv(gt[i]) @ gt[0]

    def image_pair(i):
        return torch.as_tensor(imgs[i][0]).to(dev), torch.as_tensor(imgs[i][1]).to(dev)

    t0 = time.perf_counter()
    descs = []
    for i in range(3):
        kp = orb.extract(image_pair(i)[0], 2000, 8)
        descs.append(kp.desc[kp.valid].cpu().numpy().view(np.uint32))
    voc = bow.train_vocabulary(np.concatenate(descs), k=8, depth=3, seed=0, device=dev)
    print(f"vocabulary: {voc.n_words} words from {sum(len(d) for d in descs)} descriptors of 3 "
          f"frames, trained on the host in {time.perf_counter() - t0:.1f} s", flush=True)

    cfg2 = kitti_config(cfg_mod, syn, triangulate=True, recently_lost_frames=3, atlas_min_kf=2)
    slam2 = sys_mod.System(cfg2, dev, voc=voc)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = snap(slam2)
    reset_counts()
    states2 = []
    t_start = time.perf_counter()
    for i in range(N_TRI):
        if i == N_WARM:
            torch.cuda.synchronize()
            slam2.timers.reset()
            t_warm = time.perf_counter()
        slam2.track(imgs[i][0], imgs[i][1], frames[i].t, scans[i])
        states2.append(slam2.state)
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    counts_a, modes_a = read_counts(), read_modes()
    after = snap(slam2)
    tri_pairs_a = modes_a.get("epipolar+mutual", 0)
    n_lm2, n_kf2 = int(slam2.map.n_lm), slam2.n_kf_host
    stats2 = slam2.timers.stats()
    est2 = slam2.trajectory_world_from_cam()
    ate2 = syn.ate_rmse(est2, gt[:N_TRI])
    n_tri_lm = int(slam2.n_tri_landmarks)
    n_lm1, n_kf1 = int(lm_at_tri[0]), lm_at_tri[1]
    maintain = stats2.get("maintain", {"total_s": 0.0, "n": 0})
    print(f"{tag} triangulate=True: {N_TRI} frames, ATE {ate2:.4f} m, keyframes {n_kf2}, "
          f"landmarks {n_lm2} ({n_lm2 / max(n_kf2, 1):.1f} a keyframe; without triangulation "
          f"{n_lm1} landmarks, {n_lm1 / max(n_kf1, 1):.1f} a keyframe at the same frame), "
          f"{n_tri_lm} landmarks triangulated in {slam2.n_ba} mapping passes over "
          f"{tri_pairs_a} keyframe pairs (one epipolar match launch each)", flush=True)
    print(f"{tag} triangulate=True frames/s: {N_TRI / (t_end - t_start):.3f} over all {N_TRI} "
          f"frames, {(N_TRI - N_WARM) / (t_end - t_warm):.3f} over frames {N_WARM}..{N_TRI - 1}; "
          f"maintain stage {1e3 * maintain['total_s'] / max(maintain['n'], 1):.2f} ms a pass "
          f"({maintain['n']} passes, CUDA events); device ms/frame by stage: "
          + json.dumps({k: round(1e3 * v["total_s"] / (N_TRI - N_WARM), 3) for k, v in stats2.items()}),
          flush=True)
    print(f"kernel launches during the triangulate=True run: {counts_a}, the matcher's by "
          f"call shape {modes_a}", flush=True)
    if any(st != S.OK for st in states2):
        return fail(f"triangulate=True: tracking states {states2}")
    if n_tri_lm < 1 or tri_pairs_a < 1:
        return fail("triangulate=True: no mapping pass allocated a triangulated landmark")
    if not ate2 < ATE_BOUND_M:
        return fail(f"triangulate=True: ATE {ate2:.4f} m >= {ATE_BOUND_M} m")
    tally(modes_a, before, after)
    fault = cross_check(counts_a, modes_a, N_TRI, N_TRI - 1, before, after, 0)
    if fault:
        return fail(f"triangulate=True: {fault}")

    # the batched 4x4 SVD the reference takes the null vector from, beside
    # the iteration that replaces it, on the design matrices of noisy matches
    # at a mapping pass's size (3 pairs x 2000)
    g = torch.Generator(device=dev).manual_seed(2)
    X = torch.rand((6000, 3), generator=g, device=dev) * torch.tensor(
        [24.0, 10.0, 32.0], device=dev) + torch.tensor([-12.0, -5.0, 8.0], device=dev)
    T1 = torch.eye(4, device=dev)
    T2 = lie.se3(torch.eye(3, device=dev), torch.tensor([-1.0, 0.05, 0.1], device=dev))
    X2 = lie.se3_apply(T2, X)
    xn1 = X[:, :2] / X[:, 2:] + 1e-3 * torch.randn((6000, 2), generator=g, device=dev)
    xn2 = X2[:, :2] / X2[:, 2:] + 1e-3 * torch.randn((6000, 2), generator=g, device=dev)
    A = tri_geom.design_matrix(xn1, xn2, T1, T2)

    ms_svd = cuda_ms(torch, lambda: torch.linalg.svd(A), 10)
    ms_null = cuda_ms(torch, lambda: tri_geom.null_vector(A), 10)
    n_sync_svd = syncs_of(torch, lambda: torch.linalg.svd(A))
    n_sync_null = syncs_of(torch, lambda: tri_geom.null_vector(A))
    v_svd = torch.linalg.svd(A.to(torch.float64))[2][:, 3, :]
    agree = float(torch.abs(torch.sum(tri_geom.null_vector(A).to(torch.float64) * v_svd, -1)).min())
    print(f"{tag} null vector of [6000, 4, 4]: torch.linalg.svd {ms_svd:.3f} ms a call, "
          f"{n_sync_svd} host sync(s); null_vector (inverse iteration on A^T A, float64) "
          f"{ms_null:.3f} ms a call, {n_sync_null} host sync(s); least |cos| between the two "
          f"{agree:.9f}", flush=True)
    if n_sync_null != 0:
        return fail(f"null_vector synchronised the host {n_sync_null} times")
    if not agree > 1.0 - 1e-5:
        return fail(f"null_vector disagrees with the SVD: least |cos| {agree}")

    # --- 4b. recovery -----------------------------------------------------------
    i_back = 8
    t_now = float(frames[N_TRI - 1].t) + dt
    slam2.velocity = lie.se3_exp(torch.tensor([30.0, 20.0, -15.0, 0.6, -0.8, 0.9], device=dev))
    frame_b = tracking.build_frame(*image_pair(i_back), slam2.cam, slam2.scale_factors,
                                   n_features=2000, n_levels=8)
    _, res0, _, _ = tracking.track_step(
        slam2.map, frame_b, slam2.T_cw, slam2.velocity, slam2.cam, slam2.scale_factors,
        slam2.sigma2, cfg2.tracking.match_radius_narrow)
    n_before = int(res0.n_inliers)
    before = snap(slam2)
    reset_counts()
    slam2.track(imgs[i_back][0], imgs[i_back][1], t_now, scans[i_back])
    torch.cuda.synchronize()
    counts_b, modes_b = read_counts(), read_modes()
    after = snap(slam2)
    err_b = float(np.linalg.norm(slam2.T_cw.cpu().numpy()[:3, 3] - gt_cw(i_back)[:3, 3]))
    n_after = int(tracking.track_frame(
        slam2.map, frame_b, slam2.T_cw, slam2.cam, slam2.scale_factors, slam2.sigma2,
        cfg2.tracking.match_radius_narrow).n_inliers)
    print(f"{tag} recovery: motion model set far off, frame {i_back} fed again: track_step "
          f"{n_before} inliers, a windowed pass at the recovered pose {n_after}; state "
          f"{slam2.state}, position {err_b:.4f} m from that frame's ground truth; launches "
          f"{counts_b}, the matcher's by call shape {modes_b}", flush=True)
    if n_before >= max(cfg2.tracking.min_inliers, 10):
        return fail(f"recovery: track_step did not fail ({n_before} inliers)")
    if slam2.state != S.OK or after["n_recover"] != before["n_recover"] + 1 \
            or after["n_reloc"] != before["n_reloc"]:
        return fail(f"recovery: state {slam2.state}, counts {before} -> {after}")
    if not err_b < RECOVER_BOUND_M:
        return fail(f"recovery: {err_b:.4f} m from ground truth")
    if n_after < max(cfg2.tracking.min_inliers, 10):
        return fail(f"recovery: only {n_after} inliers at the recovered pose")
    tally(modes_b, before, after)
    fault = cross_check(counts_b, modes_b, 1, 1, before, after, 0)
    if fault or modes_b.get("none+mutual", 0) != 1:
        return fail(f"recovery: {fault or modes_b}")
    pnp_case = pose_inputs[2]          # the recovery's PnP polish

    # --- 4c. relocalization -----------------------------------------------------
    i_reloc = 5
    reset_counts()
    frame_c = tracking.build_frame(*image_pair(i_reloc), slam2.cam, slam2.scale_factors,
                                   n_features=2000, n_levels=8)
    rr = relocalization.relocalize(
        slam2.map, frame_c, slam2.cam, slam2.voc, slam2.kf_words, slam2.sigma2,
        generator=torch.Generator(device=dev).manual_seed(1))
    torch.cuda.synchronize()
    counts_c, modes_c = read_counts(), read_modes()
    err_c = float(np.linalg.norm(rr.T_cw.cpu().numpy()[:3, 3] - gt_cw(i_reloc)[:3, 3]))
    print(f"{tag} relocalize on frame {i_reloc}: ok {rr.ok}, {rr.n_inliers} inliers, position "
          f"{err_c:.4f} m from ground truth; launches {counts_c}, the matcher's by call shape "
          f"{modes_c}", flush=True)
    if not rr.ok or not err_c < RECOVER_BOUND_M:
        return fail(f"relocalize: ok {rr.ok}, {err_c:.4f} m from ground truth")
    tally(modes_c, after, after)
    fault = cross_check(counts_c, modes_c, 1, 0, after, after, 1)
    if fault or modes_c.get("none+mutual", 0) < 1 or modes_c.get("window", 0) < 1 \
            or counts_c["calls:pnp_ransac"] < 1:
        return fail(f"relocalize: {fault or modes_c}")
    # the map of this run, for the kernel cases of phase 5
    m2, kf_a = slam2.map, slam2.ref_kf

    # --- 4d. blackout and atlas -------------------------------------------------
    rng_n = np.random.default_rng(1)
    shape = imgs[0][0].shape
    kf_before = slam2.n_kf_host
    before = snap(slam2)
    reset_counts()
    states_d, poses_d = [], []
    feed = [(rng_n.integers(0, 255, shape, dtype=np.uint8),
             rng_n.integers(0, 255, shape, dtype=np.uint8), scans[i_back], dt) for _ in range(3)]
    feed += [(imgs[i][0], imgs[i][1], scans[i], dt) for i in (14, 15, 16)]
    feed += [(imgs[17][0], imgs[17][1], scans[17], 5.0), (imgs[18][0], imgs[18][1], scans[18], dt)]
    log_d = []
    n_tracked_d = 0
    for img_l, img_r, sc, step in feed:
        t_now += step
        # a frame goes through tracking unless the map waits to be
        # initialised or the timestamp jump starts a new one
        n_tracked_d += int(slam2.state != S.NOT_INITIALIZED and step <= 1.0)
        poses_d.append(slam2.track(img_l, img_r, t_now, sc))
        states_d.append(slam2.state)
        log_d.append((slam2.state, slam2.map_id, slam2.n_kf_host, slam2.atlas.n_created,
                      len(slam2.atlas.frozen), slam2.atlas.n_discarded))
    torch.cuda.synchronize()
    counts_d, modes_d = read_counts(), read_modes()
    after = snap(slam2)
    peak2_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    est_all = slam2.trajectory_world_from_cam()
    print(f"{tag} blackout and atlas: (state, map, keyframes, maps created, frozen, discarded) "
          f"per frame {log_d}; frozen map 0 holds {slam2.atlas.frozen[0].n_kf if slam2.atlas.frozen else None} "
          f"keyframes (before: {kf_before}); recoveries {after['n_recover'] - before['n_recover']}, "
          f"relocalization attempts {after['n_reloc'] - before['n_reloc']}; launches {counts_d}, "
          f"the matcher's by call shape {modes_d}; "
          f"peak device memory over 4a-4d {peak2_gib:.2f} GiB", flush=True)
    if states_d[:3] != [S.RECENTLY_LOST, S.RECENTLY_LOST, S.NOT_INITIALIZED]:
        return fail(f"blackout: states {states_d[:3]}")
    if len(slam2.atlas.frozen) < 1 or slam2.atlas.frozen[0].n_kf != kf_before \
            or log_d[2][3] != 2 or log_d[2][4] != 1:
        return fail(f"blackout: the map was not frozen with its {kf_before} keyframes: {log_d}")
    if states_d[3:6] != [S.OK] * 3 or log_d[3][1] != 1:
        return fail(f"structured frames did not initialise map 1: {log_d}")
    if log_d[6][3] != 3 or log_d[6][1] != 2 or states_d[6:] != [S.OK] * 2:
        return fail(f"the timestamp jump did not start another map: {log_d}")
    if not all(bool(torch.isfinite(T).all()) for T in poses_d) or not np.all(np.isfinite(est_all)):
        return fail("blackout and atlas: non-finite poses")
    if est_all.shape[0] != N_TRI + 1 + len(feed) or est_all.shape[0] != len(slam2.traj):
        return fail(f"trajectory has {est_all.shape[0]} poses for {N_TRI + 1 + len(feed)} frames")
    tally(modes_d, before, after)
    fault = cross_check(counts_d, modes_d, len(feed), n_tracked_d, before, after,
                        after["n_reloc"] - before["n_reloc"])
    if fault:
        return fail(f"blackout and atlas: {fault}")
    launches.update(shape_launches)
    pose_launches = {"3": launches["pose_only_lm"]}
    for name, c in (("4a", counts_a), ("4b", counts_b), ("4c", counts_c), ("4d", counts_d)):
        pose_launches[name] = c["pose_only_lm"]
    print(f"launches of the new call shapes over 4a-4d, as the wrapper counted them: "
          f"{shape_launches}", flush=True)
    for name, n_launched in shape_launches.items():
        if n_launched < 1:
            return fail(f"{name} was launched no time on the main path")

    # --- 4e. the IMU mode ----------------------------------------------------------
    cfg3 = dataclasses.replace(
        kitti_config(cfg_mod, syn, triangulate=True), use_imu=True, inertial_ba=True,
        imu=cfg_mod.ImuConfig(noise_gyro=1e-4, noise_acc=1e-3, gyro_walk=1e-6, acc_walk=1e-5,
                              T_bc=syn.body_from_cam()))
    slam3 = sys_mod.System(cfg3, dev)

    def track_imu(i, t=None, acc=None):
        fr = frames_all[i]
        return slam3.track(imgs[i][0], imgs[i][1], fr.t if t is None else t, scans[i], None,
                           gyro=fr.gyro, acc=fr.acc if acc is None else acc,
                           imu_dts=fr.imu_dts, imu_trel=fr.imu_trel,
                           scan_times=fr.scan_times[::4])

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = snap(slam3)
    reset_counts()
    states3, vi_at = [], None
    t_start = time.perf_counter()
    for i in range(N_IMU):
        if i == N_IMU_WARM:
            torch.cuda.synchronize()
            slam3.timers.reset()
            t_warm = time.perf_counter()
        track_imu(i)
        states3.append(slam3.state)
        if vi_at is None and slam3._vi_initialized:
            vi_at = i
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    counts_e, modes_e = read_counts(), dict(match.launches_by_mode)
    lio_case4e = lio_inputs.get("last")   # the IMU run's last scan step (before the bad event)
    after = snap(slam3)
    peak3_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    stats3 = slam3.timers.stats()
    est3 = slam3.trajectory_world_from_cam()
    ate3 = syn.ate_rmse(est3, gt_all[:N_IMU])
    n_kf3 = slam3.n_kf_host
    grav3 = float(torch.linalg.norm(slam3.filt.x.grav))
    n_fac3 = int(slam3.imu_store.has_factor.sum())
    n_steady3 = N_IMU - N_IMU_WARM
    print(f"{tag} IMU mode: {N_IMU} frames, ATE {ate3:.4f} m, keyframes {n_kf3}, landmarks "
          f"{int(slam3.map.n_lm)}, voxel map {int(slam3.vmap.count)} points; visual-inertial "
          f"initialization at frame {vi_at}, |gravity| {grav3:.4f} m/s^2, IMU factors at "
          f"{n_fac3} keyframes; LVI-BA passes {slam3.n_lvi_ba} ({slam3.n_lvi_ba_balm} with "
          f"BALM) of {slam3.n_ba} mapping passes; frames refined against the last keyframe "
          f"{slam3.n_vi_refine_kf}, against the last frame {slam3.n_vi_refine_frame}; bad-IMU "
          f"flags {slam3.n_imu_bad}, resets {slam3.n_imu_reset}", flush=True)
    print(f"{tag} IMU mode frames/s: {N_IMU / (t_end - t_start):.3f} over all {N_IMU} frames, "
          f"{n_steady3 / (t_end - t_warm):.3f} over frames {N_IMU_WARM}..{N_IMU - 1}; peak "
          f"device memory {peak3_gib:.2f} GiB; device ms/frame by stage (CUDA events, frames "
          f"{N_IMU_WARM}..{N_IMU - 1}): "
          + json.dumps({k: round(1e3 * v["total_s"] / n_steady3, 3) for k, v in stats3.items()}),
          flush=True)
    print(f"kernel launches during the IMU-mode run: {counts_e}, the matcher's by call shape "
          f"{modes_e}", flush=True)
    if any(st != S.OK for st in states3):
        return fail(f"IMU mode: tracking states {states3}")
    if not slam3._imu_initialized or not abs(grav3 - 9.81) < 0.2:
        return fail(f"IMU mode: static init {slam3._imu_initialized}, |gravity| {grav3}")
    if not slam3._vi_initialized:
        return fail("IMU mode: the visual-inertial initialization never ran")
    if slam3.n_lvi_ba_balm < 1:
        return fail("IMU mode: no LVI-BA pass with the BALM term ran")
    if slam3.n_vi_refine_kf + slam3.n_vi_refine_frame < 3 or slam3.n_vi_refine_frame < 1:
        return fail(f"IMU mode: frames refined {slam3.n_vi_refine_kf} + {slam3.n_vi_refine_frame}")
    if n_fac3 < n_kf3 - 1 or n_kf3 < 5:
        return fail(f"IMU mode: {n_fac3} IMU factors for {n_kf3} keyframes")
    if slam3.n_imu_bad or slam3.n_imu_reset:
        return fail(f"IMU mode: bad-IMU flags {slam3.n_imu_bad}, resets {slam3.n_imu_reset}")
    if not np.all(np.isfinite(est3)) or not ate3 < ATE_BOUND_M:
        return fail(f"IMU mode: ATE {ate3:.4f} m")
    fault = cross_check(counts_e, modes_e, N_IMU, N_IMU - 1, before, after, 0, imu=True)
    if fault or after["n_recover"] != before["n_recover"]:
        return fail(f"IMU mode: {fault or 'a frame went through recovery'}")
    n_refined = slam3.n_vi_refine_kf + slam3.n_vi_refine_frame
    print(f"{tag} IMU mode: imu_preintegrate launched {counts_e['imu_preintegrate']} times for "
          f"{counts_e['calls:integrate']} integrate calls, pose_inertial_lm "
          f"{counts_e['pose_inertial_lm']} times for {n_refined} refined frames; vi_refine "
          f"{1e3 * stats3['vi_refine']['total_s'] / n_steady3:.3f} ms a frame (frames "
          f"{N_IMU_WARM}..{N_IMU - 1})", flush=True)
    if counts_e["pose_inertial_lm"] != n_refined:
        return fail(f"IMU mode: pose_inertial_lm launched {counts_e['pose_inertial_lm']} times "
                    f"for {n_refined} refined frames")
    if counts_e["pose_graph_gn"]:
        return fail(f"IMU mode: pose_graph_gn launched {counts_e['pose_graph_gn']} times "
                    f"without loop closing")
    if counts_e["imu_preintegrate"] != counts_e["calls:integrate"]:
        return fail(f"IMU mode: imu_preintegrate launched {counts_e['imu_preintegrate']} times "
                    f"for {counts_e['calls:integrate']} integrate calls")
    n_lvi = after["n_lvi_ba"] - before["n_lvi_ba"]
    want_lvi = n_lvi * klvi.launches_per_call(cfg3.tracking.ba_iters)
    print(f"{tag} IMU mode: lvi_ba_lm launched {counts_e['lvi_ba_lm']} times for {n_lvi} LVI-BA "
          f"passes ({klvi.launches_per_call(cfg3.tracking.ba_iters)} a pass at "
          f"{cfg3.tracking.ba_iters} iterations; inertial_ba.lvi_ba called "
          f"{counts_e['calls:lvi_ba']} times); local_ba "
          f"{[round(1e3 * x, 3) for x in slam3.timers.samples.get('local_ba', [])]} ms by pass "
          f"over frames {N_IMU_WARM}..{N_IMU - 1} (CUDA events)", flush=True)
    if n_lvi < 1 or counts_e["lvi_ba_lm"] != want_lvi or counts_e["calls:lvi_ba"] != n_lvi:
        return fail(f"IMU mode: lvi_ba_lm launched {counts_e['lvi_ba_lm']} times for {n_lvi} "
                    f"LVI-BA passes (expected {want_lvi})")
    n_scans = counts_e["calls:lio_scan_step"]
    want_lio = {name: n * n_scans
                for name, n in klio.launches_per_scan(cfg3.lidar.max_iters).items()}
    # the fence table rides in the predict launch: no launch of its own
    n_device = sum(counts_e[name] for name in ("esekf_predict", "lio_rows", "esekf_step"))
    want_device = klio.device_launches_per_scan(cfg3.lidar.max_iters) * n_scans
    print(f"{tag} IMU mode: {n_scans} scan steps (max_iters {cfg3.lidar.max_iters}): "
          + ", ".join(f"{name} launched {counts_e[name]} times (implied {n})"
                      for name, n in want_lio.items())
          + f" (lio_fences in the predict launch); {n_device} device launches (implied "
          f"{want_device}); lio {1e3 * stats3['lio']['total_s'] / n_steady3:.3f} ms a frame "
          f"(frames {N_IMU_WARM}..{N_IMU - 1})", flush=True)
    if n_scans < N_IMU - 1 or any(counts_e[name] != n for name, n in want_lio.items()) \
            or n_device != want_device:
        return fail(f"IMU mode: the scan step's kernels launched "
                    f"{[counts_e[name] for name in want_lio]} times for {n_scans} scan steps, "
                    f"implied {list(want_lio.values())}; device launches {n_device}, implied "
                    f"{want_device}")
    launches["imu_preintegrate"] = counts_e["imu_preintegrate"]
    launches["pose_inertial_lm"] = counts_e["pose_inertial_lm"]
    launches["lvi_ba_lm"] = counts_e["lvi_ba_lm"]
    launches.update({name: counts_e[name] for name in want_lio})
    pose_launches["4e"] = counts_e["pose_only_lm"]
    clusters_case4e = ba_inputs.get("clusters")   # the IMU run's last LVI-BA window
    lvi_case4e = lvi_inputs.get("last")           # ... and the pass's arguments
    imu_launches = {**{k: counts_e[k] for k in FRAME_KERNELS},
                    "pose_only_lm": counts_e["pose_only_lm"],
                    "match_best2": modes_e.get("window", 0),
                    "match_best2/stereo": modes_e.get("stereo+mutual", 0),
                    "match_best2/epipolar": modes_e.get("epipolar+mutual", 0),
                    "balm_quadratic": counts_e["balm_quadratic"],
                    "balm_clusters": counts_e["balm_clusters"],
                    "local_ba_lm": counts_e["local_ba_lm"],
                    "imu_preintegrate": counts_e["imu_preintegrate"],
                    "pose_inertial_lm": counts_e["pose_inertial_lm"],
                    "lvi_ba_lm": counts_e["lvi_ba_lm"],
                    "inertial_init_gn": counts_e["inertial_init_gn"],
                    **{name: counts_e[name] for name in want_lio}}
    for name, n_launched in imu_launches.items():
        if n_launched < 1:
            return fail(f"IMU mode: {name} was launched no time")
    # the visual-inertial initialization: one inertial_optimization call (the
    # first mapping pass with four keyframes), inertial_init_gn once a call
    n_init_e = counts_e["calls:inertial_optimization"]
    print(f"{tag} IMU mode: inertial_init_gn launched {counts_e['inertial_init_gn']} times for "
          f"{n_init_e} inertial_optimization calls (the initialization at frame {vi_at})",
          flush=True)
    if n_init_e != 1 or counts_e["inertial_init_gn"] != n_init_e:
        return fail(f"IMU mode: inertial_init_gn launched {counts_e['inertial_init_gn']} times "
                    f"for {n_init_e} inertial_optimization calls (expected one)")
    init_case4e = init_inputs[-1]   # System._initialize_imu's arguments at stage 0

    # the VIBA rungs on 4e's System: the calls System._maybe_refine_imu_init
    # makes 5 s and 15 s after the initialization (26 frames reach neither),
    # _initialize_imu(kf, stage) with the stage's loosened bias priors, then
    # the FullInertialBA over a 20-slot window (10 iterations)
    kf_last, rung_cases, rung_launches = slam3.n_kf_host - 1, [], 0
    real_kf = torch.arange(slam3.n_kf_host, device=dev)
    for stage in (1, 2):
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        ran = slam3._initialize_imu(kf_last, stage=stage)
        torch.cuda.synchronize()
        rung_ms = 1e3 * (time.perf_counter() - t0)
        counts_r = read_counts()
        st_r = slam3.imu_store
        finite = all(bool(torch.isfinite(x).all()) for x in (
            st_r.vel[real_kf], st_r.bg[real_kf], st_r.ba[real_kf], slam3.map.kf_T_cw[real_kf]))
        est_r = slam3.trajectory_world_from_cam()
        ate_r = syn.ate_rmse(est_r, gt_all[:N_IMU])
        g_vis = float(torch.linalg.norm(slam3.gravity_vis))
        g_filt = float(torch.linalg.norm(slam3.filt.x.grav))
        lvi_a, lvi_kw = lvi_inputs["last"]
        P_r, want_r = lvi_a[2].T_wb.shape[0], klvi.launches_per_call(10)
        print(f"{tag} VIBA rung {stage} on 4e's System (keyframe {kf_last}, priors "
              f"{sys_mod.System.VI_STAGE_PRIORS[stage]}): ran {ran} in {rung_ms:.1f} ms host; "
              f"|gravity| {g_vis:.4f} (the visual frame's), {g_filt:.4f} (the filter's); bg "
              f"{st_r.bg[kf_last].tolist()}, ba {st_r.ba[kf_last].tolist()}; states finite "
              f"{finite}; ATE {ate_r:.4f} m; inertial_init_gn launched "
              f"{counts_r['inertial_init_gn']} times for {counts_r['calls:inertial_optimization']}"
              f" calls; the FullInertialBA: lvi_ba_lm {counts_r['lvi_ba_lm']} launches for "
              f"{counts_r['calls:lvi_ba']} lvi_ba calls (P {P_r}, {lvi_kw.get('iters')} "
              f"iterations, {want_r} a call)", flush=True)
        if not ran or not abs(g_vis - 9.81) < 0.2 or not abs(g_filt - 9.81) < 0.2 or not finite \
                or not np.all(np.isfinite(est_r)) or not ate_r < ATE_BOUND_M:
            return fail(f"VIBA rung {stage}: ran {ran}, |gravity| {g_vis} / {g_filt}, states "
                        f"finite {finite}, ATE {ate_r:.4f} m")
        if counts_r["inertial_init_gn"] != 1 or counts_r["calls:inertial_optimization"] != 1 \
                or counts_r["lvi_ba_lm"] != want_r or counts_r["calls:lvi_ba"] != 1 \
                or P_r != 20 or lvi_kw.get("iters") != 10:
            return fail(f"VIBA rung {stage}: launches {counts_r}, the FullInertialBA at P {P_r}, "
                        f"{lvi_kw.get('iters')} iterations (expected one inertial_init_gn "
                        f"launch, {want_r} of lvi_ba_lm at P 20, 10 iterations)")
        rung_cases.append((f"VIBA rung {stage}",) + tuple(init_inputs[-1]))
        rung_launches += counts_r["inertial_init_gn"]
        if stage == 2:
            lvi_rung = (lvi_a, lvi_kw)   # the second rung's FullInertialBA pass
    launches["inertial_init_gn"] = counts_e["inertial_init_gn"] + rung_launches

    # a forced bad-IMU event: a window with non-finite samples. First on the
    # scan step alone (it is functional), then through track.
    fr = frames_all[N_IMU]
    acc_bad = fr.acc.copy()
    acc_bad[2] = np.nan
    up = lambda a, dt_=torch.float32: torch.as_tensor(a).to(dev, dt_)
    filt0, vmap0 = slam3.filt, slam3.vmap
    bad_res = lio.lio_scan_step(
        filt0, vmap0, up(scans[N_IMU]), up(fr.scan_times[::4]),
        torch.ones(scans[N_IMU].shape[0], dtype=torch.bool, device=dev), up(fr.gyro),
        up(acc_bad), up(fr.imu_dts), up(fr.imu_trel), slam3.imu_noise, slam3.lio_cfg)
    kept = all(torch.equal(a, b) for a, b in zip(bad_res.filt.x, filt0.x)) \
        and torch.equal(bad_res.filt.P, filt0.P)
    if not bool(bad_res.bad) or not kept or int(bad_res.map.count) != int(vmap0.count):
        return fail(f"bad IMU: lio_scan_step bad {bool(bad_res.bad)}, filter kept {kept}, voxel "
                    f"map {int(vmap0.count)} -> {int(bad_res.map.count)}")
    count0, n_init0 = int(slam3.vmap.count), slam3.n_imu_init
    track_imu(N_IMU, acc=acc_bad)
    reset_at_sync = (slam3.n_imu_bad, slam3.n_imu_reset, slam3._imu_initialized,
                     slam3._vi_initialized, int(slam3.vmap.count), slam3.state)
    track_imu(N_IMU + 1)
    print(f"{tag} forced bad-IMU event: lio_scan_step bad, filter and voxel map kept; through "
          f"track (flags, resets, filter initialised, VI initialised, voxel map points, state) "
          f"after that frame {reset_at_sync} (voxel map before: {count0}); static inits "
          f"{n_init0} -> {slam3.n_imu_init} and state {slam3.state} after the next frame",
          flush=True)
    if reset_at_sync != (1, 1, False, False, count0, S.OK):
        return fail(f"bad IMU: after the frame's sync {reset_at_sync}")
    if slam3.n_imu_init != n_init0 + 1 or slam3.state != S.OK:
        return fail("bad IMU: the inertial stack did not initialise again on the next frame")

    # --- 4f. loop closing and the checkpoint round trip ----------------------------
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        lp = loop_phase(torch, dev, syn.KITTI_LIKE, kitti_config(cfg_mod, syn, triangulate=True),
                        world=world, log=lambda msg: print(f"{tag} {msg}", flush=True),
                        reset_counts=reset_counts, read_counts=read_counts)
    except RuntimeError as e:
        return fail(str(e))
    slam4, counts_f, modes_f = lp["slam"], lp["counts"], lp["modes"]
    print(f"{tag} loop closing phase: {time.perf_counter() - t0:.1f} s in all; frames/s over "
          f"frames {LOOP_PERIOD}..{N_LOOP - 1} {1e3 * (N_LOOP - LOOP_PERIOD) / sum(lp['frame_ms'][LOOP_PERIOD:]):.3f}; "
          f"peak device memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; kernel "
          f"launches {counts_f}", flush=True)
    if any(counts_f[k] != N_LOOP * FRAME_LAUNCHES[k] for k in FRAME_KERNELS) \
            or counts_f["hamming_matrix"] or counts_f["inertial_init_gn"] \
            or counts_f["calls:inertial_optimization"] \
            or modes_f.get("stereo+mutual", 0) != N_LOOP:
        return fail(f"loop closing: launches {counts_f} by shape {modes_f} for {N_LOOP} frames")
    if pose_fault(counts_f):
        return fail(f"loop closing: {pose_fault(counts_f)}")
    pose_launches["4f"] = counts_f["pose_only_lm"]
    global_case = ba_inputs.get("global")     # 4f's global BA, 64 poses
    if counts_f["balm_quadratic"] or ba_fault(counts_f, 0) or counts_f["calls:global_ba"] < 1 \
            or global_case is None:
        return fail(f"loop closing: {ba_fault(counts_f, 0)}; launches {counts_f} (LiDAR off: no "
                    f"BALM quadratic; at least one global BA)")
    print(f"window BA launches in the loop-closing run: local_ba_lm {counts_f['local_ba_lm']} "
          f"for {counts_f['calls:run_local_ba']} run_local_ba calls, of which "
          f"{counts_f['calls:global_ba']} from _global_ba (64 poses, 8 iterations: "
          f"{klba.launches_per_call(8)} launches each); balm_quadratic 0", flush=True)
    # the pose graph: launches_per_call(n_kf, iters) a closure (close_loop hands
    # it the n_kf used slots), and the first closure's call replayed under the
    # profiler: at most that many device events (28,748 for the eager call)
    want_pg = sum(kpg.launches_per_call(c["n_kf"], c["iters"]) for c in lp["closures"])
    pg_replay = lp["replay:pose_graph_optimize"]
    c0 = lp["closures"][0]
    print(f"{tag} loop closing: pose_graph_gn launched {counts_f['pose_graph_gn']} times for "
          f"{len(lp['closures'])} closures (implied {want_pg}; n_kf "
          f"{[c['n_kf'] for c in lp['closures']]}); the first closure's call replayed: "
          f"{pg_replay['events']} device events (launches_per_call "
          f"{kpg.launches_per_call(c0['n_kf'], c0['iters'])}; the eager call made 28,748), "
          f"{pg_replay['device_ms']:.3f} device ms, {pg_replay['host_ms']:.2f} host ms", flush=True)
    if counts_f["pose_graph_gn"] != want_pg or not want_pg \
            or not 0 < pg_replay["events"] <= kpg.launches_per_call(c0["n_kf"], c0["iters"]):
        return fail(f"loop closing: pose_graph_gn launched {counts_f['pose_graph_gn']} times for "
                    f"{want_pg} implied; replay events {pg_replay['events']}")
    launches["pose_graph_gn"] = counts_f["pose_graph_gn"]
    (pg_S, pg_e, pg_fixed), pg_kw = lp["pose_graph_args"]
    (root / "build").mkdir(exist_ok=True)
    torch.save({"S_w": pg_S.cpu(), "edges": tuple(x.cpu() for x in pg_e), "fixed": pg_fixed.cpu(),
                "iters": pg_kw["iters"]}, root / "build" / "pose_graph_4f.pt")
    launches["match_best2/loop"] = modes_f.get("none+mutual", 0) - slam4.n_recover
    if launches["match_best2/loop"] != slam4.n_loop_verified or slam4.n_loop_verified < 1:
        return fail(f"loop closing: {launches['match_best2/loop']} launches of the verification "
                    f"match for {slam4.n_loop_verified} candidates verified")

    # --- 4g. timers and trace, exporters, scan features, distributed BA -----------
    log = lambda msg: print(f"{tag} {msg}", flush=True)
    frame = lambda i: (imgs[i][0], imgs[i][1], frames_all[i].t, scans[i])
    t0 = time.perf_counter()
    try:
        profile_export_phase(torch, slam, frame(N_FRAMES), log=log)
        # phase 3's System on the frame after, its host syncs counted as the
        # mesh run's are below
        n_sync3 = syncs_of(torch, lambda: slam.track(*frame(N_FRAMES + 1)))
        log(f"host syncs of phase 3's System on one more frame: {n_sync3}")
        scan_phase(torch, dev, log=log,
                   timer=lambda fn: cuda_ms(torch, fn, 20, backlog=True))
        dp = dist_phase(torch, dev, cfg, [frame(i) for i in range(N_FRAMES)], gt,
                        ref=dict(ate=ate, stats=stats, local_ba_ms=[
                            round(1e3 * x, 1) for x in
                            slam.timers.samples["local_ba"][:stats["local_ba"]["n"]]]),
                        log=log, reset_counts=reset_counts, read_counts=read_counts)
    except RuntimeError as e:
        return fail(str(e))
    if dp["counts"]["pose_graph_gn"]:
        return fail(f"distributed BA: pose_graph_gn launched {dp['counts']['pose_graph_gn']} "
                    f"times without loop closing")
    if dp["counts"]["inertial_init_gn"] or dp["counts"]["calls:inertial_optimization"]:
        return fail(f"distributed BA: inertial_init_gn launched "
                    f"{dp['counts']['inertial_init_gn']} times without the IMU mode")
    if pose_fault(dp["counts"]):
        return fail(f"System(mesh): {pose_fault(dp['counts'])}")
    mesh_fault = ba_fault(dp["counts"], dp["n_ba_balm"], mesh_iters=cfg.tracking.ba_iters)
    if mesh_fault or dp["counts"]["balm_quadratic"] != dp["n_balm_evals"] or dp["n_ba_balm"] < 1:
        return fail(f"System(mesh): {mesh_fault}; {dp['n_balm_evals']} BALM evaluations, "
                    f"{dp['n_ba_balm']} BALM passes, launches {dp['counts']}")
    pose_launches["4g"] = dp["counts"]["pose_only_lm"]
    print(f"pose_only_lm launches by phase, each equal to the track_frame and pnp_ransac calls "
          f"of that phase's run: {pose_launches}", flush=True)
    print(f"phase 4g: {time.perf_counter() - t0:.1f} s", flush=True)

    # --- 5. kernels vs plain versions ----------------------------------------
    rows = {}

    # FAST: the real stacks of frame 0, one image and two
    f_l = torch.as_tensor(imgs[0][0]).to(dev).to(torch.float32)
    f_r = torch.as_tensor(imgs[0][1]).to(dev).to(torch.float32)
    ini_th, min_th, cell = 20.0, 7.0, 35
    fast_err = nms_err = 0.0
    for fs in ([f_l], [f_l, f_r]):
        stack, _, shapes, pad = orb.level_stacks(fs, 8, 1.2)
        gated, flags = fast.score_planes(stack, shapes, pad, ini_th, min_th, cell)
        gated_p, flags_p = fast.score_planes_plain(stack, shapes, pad, ini_th, min_th, cell)
        out = fast.nms_planes(gated, flags, shapes, ini_th, min_th, cell)
        out_p = fast.nms_planes_plain(gated_p, flags_p, shapes, ini_th, min_th, cell)
        fused_out = fast.detect_planes(stack, shapes, pad, ini_th, min_th, cell)
        torch.cuda.synchronize()
        if not torch.equal(flags, flags_p):
            return fail(f"fast_score_planes: cell flags disagree ({len(fs)} image(s))")
        for p, (Hl, Wl) in enumerate(shapes):
            plane = stack[p, pad:pad + Hl, pad:pad + Wl]
            e1 = float((gated[p, :Hl, :Wl] - gated_p[p, :Hl, :Wl]).abs().max())
            e2 = float((out[p, :Hl, :Wl] - out_p[p, :Hl, :Wl]).abs().max())
            ref = fast.detect_level_plain(plane, ini_th, min_th, cell)
            e3 = float((fused_out[p, :Hl, :Wl] - ref).abs().max())
            raw = fast.fast_score_raw(plane)
            e4 = float((raw - fast.fast_score_raw_plain(plane)).abs().max())
            if len(fs) == 2:
                print(f"FAST plane {p} {(Hl, Wl)}: max |kernel - plain| score {e1}, nms {e2}, "
                      f"fused vs detect_level_plain {e3}, raw {e4}; corners "
                      f"{int((ref > 0).sum())}", flush=True)
            if max(e1, e2, e3, e4) != 0.0:
                return fail(f"FAST kernels disagree with their plain versions on plane {p} "
                            f"({len(fs)} image(s)): {e1} {e2} {e3} {e4}")
            fast_err, nms_err = max(fast_err, e1, e4), max(nms_err, e2, e3)
    # `stack`, `shapes`, `gated`, `flags` are now the two-image call's
    n_pix = sum(h * w for h, w in shapes)
    n_int = sum((h - 6) * (w - 6) for h, w in shapes)
    # pixels whose compass bound does not reject them pay the whole segment test
    n_full = 0
    for p, (Hl, Wl) in enumerate(shapes):
        c = stack[p, pad + 3:pad + Hl - 3, pad + 3:pad + Wl - 3]
        d = [stack[p, pad + 3 + dy:pad + Hl - 3 + dy, pad + 3 + dx:pad + Wl - 3 + dx] - c
             for dx, dy in ((0, -3), (3, 0), (0, 3), (-3, 0))]
        pairs = [(d[i], d[(i + 1) % 4]) for i in range(4)]
        up = torch.stack([torch.minimum(a, b) for a, b in pairs]).amax(0)
        dn = -torch.stack([torch.maximum(a, b) for a, b in pairs]).amin(0)
        n_full += int((torch.maximum(up, dn) > min(ini_th, min_th)).sum())
    ms_score = cuda_ms(torch, lambda: fast.score_planes(stack, shapes, pad, ini_th, min_th, cell), 50, True)
    ms_fused = cuda_ms(torch, lambda: fast.detect_planes(stack, shapes, pad, ini_th, min_th, cell), 50, True)
    ms_fused_host = cuda_ms(torch, lambda: fast.detect_planes(stack, shapes, pad, ini_th, min_th, cell), 50)
    ms_score_p = cuda_ms(torch, lambda: fast.score_planes_plain(stack, shapes, pad, ini_th, min_th, cell), 5)
    planes = [stack[p, pad:pad + h, pad:pad + w].contiguous() for p, (h, w) in enumerate(shapes)]
    ms_level = cuda_ms(torch, lambda: [fast.gate_nms_plain(fast.fast_score_raw(pl), ini_th, min_th, cell)
                                       for pl in planes], 20)
    ms_raw = cuda_ms(torch, lambda: [fast.fast_score_raw(pl) for pl in planes], 20, True)
    b_score = bound(8 * n_pix + 4 * flags.numel(),
                    FAST_OPS_REJECT * (n_int - n_full) + FAST_OPS_FULL * n_full)
    # the NMS pass on the frame build's own stacks (orb_level_planes) of the
    # pair, bit-equal and the same bits twice
    try:
        nms = nms_row(torch, torch.stack([f_l, f_r]))
    except RuntimeError as e:
        return fail(str(e))
    print(f"{tag} FAST detection, 16 planes (8 levels of two 1241x376 images, {n_pix} pixels, "
          f"{n_full} past the compass test): fast_score_planes {ms_score:.4f} ms (bound "
          f"{b_score[0]:.4f} ms, {b_score[1]}; plain {ms_score_p:.4f} ms), fast_nms_planes "
          f"{nms['ms']:.4f} ms (bound {nms['bound_ms']:.4f} ms, {nms['bound_by']}; plain "
          f"{nms['plain_ms']:.4f} ms), both "
          f"passes {ms_fused:.4f} ms on the device, {ms_fused_host:.4f} ms a call when the host "
          f"enqueues one at a time; per-level route (16 one-plane launches + eager gates and "
          f"NMS) {ms_level:.4f} ms, its 16 launches alone {ms_raw:.4f} ms", flush=True)
    rows["fast_score_planes"] = dict(
        source="tc2li_slam_torch/csrc/fast.cu", replaces="tc2li_slam_tpu/ops/kernels/fast.py:80",
        max_abs_err=fast_err, ms=ms_score, plain_ms=ms_score_p, bound_ms=b_score[0],
        bound_by=b_score[1])
    rows["fast_nms_planes"] = dict(
        source="tc2li_slam_torch/csrc/fast.cu", replaces="tc2li_slam_tpu/ops/orb.py:182",
        max_abs_err=nms_err, **{k: nms[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")})

    # the rest of the frame build: the three ORB kernels on frame 0's real
    # images, and no host sync in one whole build_frame
    try:
        rows.update(orb_kernel_rows(torch, [f_l, f_r], log=lambda m: print(f"{tag} {m}",
                                                                          flush=True)))
    except RuntimeError as e:
        return fail(str(e))
    img_l0, img_r0 = (torch.as_tensor(im).to(dev) for im in imgs[0])
    n_sync_bf = syncs_of(torch, lambda: tracking.build_frame(
        img_l0, img_r0, slam.cam, slam.scale_factors, cfg.orb.n_features, cfg.orb.n_levels))
    print(f"host syncs in one build_frame: {n_sync_bf}", flush=True)
    if n_sync_bf:
        return fail(f"build_frame made {n_sync_bf} host syncs")

    # matching: cases on the slice's own data, a full pool, a dense worst
    # case, and edge rows
    match_inputs = {}   # the cases of a mask descriptor or none, for tools/match_kernels.py

    def match_case(name, d1, d2, v1, v2, mask, mutual, reps_plain=3):
        if not isinstance(mask, torch.Tensor):
            match_inputs[name] = (d1, d2, v1, v2, mask, mutual)
        N, M = d1.shape[0], d2.shape[0]
        n0 = match.launches
        got = match.match_best2(d1, d2, v1, v2, mask, mutual)
        n_launch = match.launches - n0
        ref = match.match_best2_plain(d1, d2, v1, v2, mask, mutual)
        torch.cuda.synchronize()
        if not same(torch, got, ref):
            raise RuntimeError(f"match_best2 disagrees with its plain version: {name}")
        if not same(torch, got, match.match_best2(d1, d2, v1, v2, mask, mutual)):
            raise RuntimeError(f"match_best2 gave other bits on a second call: {name}")
        if n_launch != len(match.chunk_bounds(M, mask)):
            raise RuntimeError(f"match_best2 launched {n_launch} times for "
                               f"{len(match.chunk_bounds(M, mask))} column chunks: {name}")
        full = v1[:, None] & v2[None, :]
        if mask is not None:
            full = full & (mask if isinstance(mask, torch.Tensor) else mask.dense())
        admitted, valid_rows, valid_cols = int(full.sum()), int(v1.sum()), int(v2.sum())
        del full
        ms_k = cuda_ms(torch, lambda: match.match_best2(d1, d2, v1, v2, mask, mutual), 50, True)
        ms_h = cuda_ms(torch, lambda: match.match_best2(d1, d2, v1, v2, mask, mutual), 50)
        ms_p = cuda_ms(torch, lambda: match.match_best2_plain(d1, d2, v1, v2, mask, mutual),
                       reps_plain)
        # the least work any route must do: every row's and column's valid
        # flag, a valid one's descriptor and mask inputs, the outputs; the
        # tests of the pairs a mask admits (a window's cells, a stereo band
        # in v prune the rest) or, for a dense mask, its entries of valid
        # pairs, or for an epipolar one its gate on every valid pair (no
        # band prunes a line); a distance for each admitted pair
        per_row = {match.WindowMask: 16, match.StereoMask: 12,
                   match.EpipolarMask: 12}.get(type(mask), 0)
        per_col = {match.WindowMask: 12, match.StereoMask: 16,
                   match.EpipolarMask: 12}.get(type(mask), 0)
        dense = isinstance(mask, torch.Tensor)
        tested = (valid_rows * valid_cols if dense or isinstance(mask, match.EpipolarMask)
                  else admitted)
        n_bytes = (N * 17 + valid_rows * (32 + per_row) + M + valid_cols * (32 + per_col)
                   + (8 * M if mutual else 0) + (tested if dense else 0))
        b = bound(n_bytes, 8 * tested + 10 * admitted, 8 * admitted)
        print(f"{tag} match_best2 {name} {N}x{M}{' mutual' if mutual else ''}: exact; "
              f"valid rows {valid_rows}, admitted pairs {admitted}; kernel {ms_k:.4f} ms on the "
              f"device ({ms_h:.4f} ms a call enqueued one at a time), bound "
              f"{b[0]:.4f} ms ({b[1]}), plain {ms_p:.4f} ms", flush=True)
        return dict(ms=ms_k, plain_ms=ms_p, bound_ms=b[0], bound_by=b[1])

    try:
        # (a) the slice's own data: the last frame's stereo pair ...
        kl, kr = orb.extract_images([torch.as_tensor(imgs[-1][0]).to(dev),
                                     torch.as_tensor(imgs[-1][1]).to(dev)], 2000, 8)
        band = 2.0 * slam.scale_factors[kr.level.long()]
        max_d = float(np.float32(slam.cam.bf) / np.float32(slam.cam.baseline))
        rows["match_best2/stereo"] = match_case(
            "stereo, last frame", kl.desc, kr.desc, kl.valid, kr.valid,
            match.StereoMask(kl.xy, kl.level, kr.xy, kr.level, band, max_d), True)
        # ... and the landmark pool projected into the reference keyframe
        kf = kf_slice
        Xc = lie.se3_apply(m.kf_T_cw[kf], m.lm_pos)
        uv = cam_mod.project(slam.cam, Xc)
        dist, dist_ok = tracking.scale_gate(m, Xc)
        cand = m.lm_valid & (Xc[:, 2] > 0.1) & cam_mod.in_image(slam.cam, uv) & dist_ok
        pred = tracking.predict_level(m, dist, slam.scale_factors)
        rad = cfg.tracking.match_radius_narrow * slam.scale_factors[pred.long()]
        window = match.WindowMask(uv, rad, pred, m.kf_xy[kf], m.kf_level[kf])
        rows["match_best2"] = match_case(
            "window, landmark pool x keyframe", m.lm_desc, m.kf_desc[kf], cand,
            m.kf_feat_valid[kf], window, False)
        # (b) a full pool: every row a valid landmark near some keypoint
        g = torch.Generator(device=dev).manual_seed(0)
        L, F_ = m.L, m.F
        src = torch.randint(0, F_, (L,), generator=g, device=dev)
        uv_full = m.kf_xy[kf][src] + 4.0 * torch.randn((L, 2), generator=g, device=dev)
        d_full = m.kf_desc[kf][src] ^ torch.randint(0, 1 << 10, (L, 8), generator=g, device=dev,
                                                    dtype=torch.int32)
        lvl_full = m.kf_level[kf][src]
        rad_full = cfg.tracking.match_radius_narrow * slam.scale_factors[lvl_full.long()]
        match_case("window, full pool", d_full, m.kf_desc[kf],
                   torch.ones(L, dtype=torch.bool, device=dev), m.kf_feat_valid[kf],
                   match.WindowMask(uv_full, rad_full, lvl_full, m.kf_xy[kf], m.kf_level[kf]),
                   False)
        # (c) dense worst case: all rows valid, every pair admitted
        ones = torch.ones(2000, dtype=torch.bool, device=dev)
        match_case("dense worst case", kl.desc, kr.desc, ones, ones, None, True)
        match_case("dense mask, random half", kl.desc, kr.desc, kl.valid, kr.valid,
                   torch.rand((2000, 2000), generator=g, device=dev) > 0.5, True)
        # (d) edge rows at sizes that are no multiple of the tile: a valid
        # row that admits nothing, an invalid row, a duplicated column
        N, M = 1003, 517
        d2 = torch.randint(-2 ** 31, 2 ** 31 - 1, (M, 8), generator=g, device=dev, dtype=torch.int32)
        d2[1] = d2[0]
        src = torch.randint(0, M, (N,), generator=g, device=dev)
        src[5] = 0
        d1 = d2[src] ^ torch.randint(0, 1 << 8, (N, 8), generator=g, device=dev, dtype=torch.int32)
        d1[5] = d2[0]
        uv2 = 300.0 * torch.rand((M, 2), generator=g, device=dev)
        uv2[1] = uv2[0]
        uv1 = uv2[src] + 3.0 * torch.randn((N, 2), generator=g, device=dev)
        lvl2 = torch.randint(0, 8, (M,), generator=g, device=dev, dtype=torch.int32)
        lvl2[1] = lvl2[0]
        lvl1 = lvl2[src]
        radius = 2.0 + 30.0 * torch.rand(N, generator=g, device=dev)
        uv1[5], radius[5], radius[7] = uv2[0], 30.0, 0.0
        v1 = torch.rand(N, generator=g, device=dev) > 0.2
        v1[5] = v1[7] = True
        v1[9] = False
        v2 = torch.rand(M, generator=g, device=dev) > 0.1
        v2[0] = v2[1] = True
        for mutual in (False, True):
            match_case("edge rows, window", d1, d2, v1, v2,
                       match.WindowMask(uv1, radius, lvl1, uv2, lvl2), mutual)
            match_case("edge rows, stereo", d1, d2, v1, v2,
                       match.StereoMask(uv1, lvl1, uv2, lvl2, 2.0 + radius[:M] / 8, 25.0), mutual)
            match_case("edge rows, dense", d1, d2, v1, v2,
                       torch.rand((N, M), generator=g, device=dev) > 0.6, mutual)
        # the window mode's grid walk on its edge cases (window_case), bit-equal
        for case in WINDOW_CASES:
            c_w = window_case(np.random.default_rng(WINDOW_CASES.index(case)), 300, 517, case)
            a_w = window_args(torch, match, c_w, dev)
            for mutual in (False, True):
                if not same(torch, match.match_best2(*a_w, mutual),
                            match.match_best2_plain(*a_w, mutual)):
                    raise RuntimeError(f"match_best2 disagrees with its plain version: window "
                                       f"grid case {case}{', mutual' if mutual else ''}")
        print(f"{tag} match_best2 window grid cases {', '.join(WINDOW_CASES)} (300x517, with "
              f"and without the mutual test): exact", flush=True)
        # the stereo mode's row bins on their edge cases (stereo_bins_case),
        # bit-equal and the same bits on a second call
        for case in STEREO_BIN_CASES:
            c_s = stereo_bins_case(np.random.default_rng(20 + STEREO_BIN_CASES.index(case)), case)
            a_s = stereo_bins_args(torch, match, c_s, dev)
            for mutual in (False, True):
                got_s = match.match_best2(*a_s, mutual)
                if not (same(torch, got_s, match.match_best2_plain(*a_s, mutual))
                        and same(torch, got_s, match.match_best2(*a_s, mutual))):
                    raise RuntimeError(f"match_best2 disagrees with its plain version or "
                                       f"itself: stereo bins case {case}"
                                       f"{', mutual' if mutual else ''}")
        print(f"{tag} match_best2 stereo bins cases {', '.join(STEREO_BIN_CASES)} (with and "
              f"without the mutual test): exact, the same bits twice", flush=True)
        idx, best, second, _ = match.match_best2(
            d1, d2, v1, v2, match.WindowMask(uv1, radius, lvl1, uv2, lvl2))
        edge = (int(idx[5]), int(best[5]), int(second[5]), int(idx[7]), int(best[7]),
                int(idx[9]), int(best[9]))
        if edge != (0, 0, 0, 0, match.BIG, 0, match.BIG):
            return fail(f"match_best2 edge rows (tie, none admitted, invalid): {edge}")
        # (e) the call shapes of the triangulate=True run, on its own map: a
        # keyframe pair under its epipolar gate; the whole pool against a
        # frame (global tracking); a frame against the landmarks seen from
        # one keyframe, the pool as side 2 (relocalization)
        kf1c, kf2c = max(kf_a, 1), max(kf_a, 1) - 1
        gates = triangulation.pair_gates(m2, kf1c, kf2c, slam2.cam, slam2.sigma2)
        rows["match_best2/epipolar"] = match_case(
            "epipolar gate, keyframe pair", m2.kf_desc[kf1c], m2.kf_desc[kf2c],
            gates.unm1, gates.unm2, gates.epi, True)
        # the epipolar mode on its edge cases (epipolar_case), bit-equal, the
        # same bits twice, a launch a call (a launch a column chunk)
        for case in EPI_CASES:
            c_e = epipolar_case(np.random.default_rng(40 + EPI_CASES.index(case)), case)
            a_e = epipolar_args(torch, match, c_e, dev)
            for mutual in (False, True):
                n0 = match.launches
                got_e = match.match_best2(*a_e, mutual)
                again_e = match.match_best2(*a_e, mutual)
                n_e = match.launches - n0
                want_e = 2 * len(match.chunk_bounds(a_e[1].shape[0], match.EpipolarMask))
                if not (same(torch, got_e, match.match_best2_plain(*a_e, mutual))
                        and same(torch, got_e, again_e)) or n_e != want_e:
                    raise RuntimeError(f"match_best2 disagrees with its plain version or "
                                       f"itself, or launched {n_e} times for {want_e}: "
                                       f"epipolar case {case}{', mutual' if mutual else ''}")
        print(f"{tag} match_best2 epipolar cases {', '.join(EPI_CASES)} (with and without the "
              f"mutual test): exact, the same bits twice, a launch a column chunk", flush=True)
        rows["match_best2/global"] = match_case(
            "no mask, landmark pool x frame", m2.lm_desc, frame_c.desc, m2.lm_valid,
            frame_c.valid, None, True)
        seen = torch.any(m2.lm_obs_kf == kf1c, dim=1) & m2.lm_valid
        rows["match_best2/reloc"] = match_case(
            f"no mask, frame x whole pool, landmarks of keyframe {kf1c}", frame_c.desc,
            m2.lm_desc, frame_c.valid, seen, None, True)
        # the dense mode on its edge cases (dense_case) over tiles of the
        # card's own size (12,037 columns): bit-equal, the same bits on a
        # second call, a launch a call
        tile = build.library().tc2li_match_dense_tile(12037)
        if not 0 < 2 * tile < 12037 < 3 * tile:
            raise RuntimeError(f"match_best2 dense mode: a tile of {tile} columns at 12,037")
        for case in DENSE_CASES:
            c_d = dense_case(np.random.default_rng(60 + DENSE_CASES.index(case)), case, tile,
                             M=12037)
            a_d = dense_args(torch, c_d, dev)
            for mutual in (False, True):
                n0 = match.launches
                got_d = match.match_best2(*a_d, mutual)
                again_d = match.match_best2(*a_d, mutual)
                n_d = match.launches - n0
                if not (same(torch, got_d, match.match_best2_plain(*a_d, mutual))
                        and same(torch, got_d, again_d)) or n_d != 2:
                    raise RuntimeError(f"match_best2 disagrees with its plain version or "
                                       f"itself, or launched {n_d} times for 2: dense case "
                                       f"{case}{', mutual' if mutual else ''}")
        print(f"{tag} match_best2 dense cases {', '.join(DENSE_CASES)} (300 x 12,037, tiles of "
              f"{tile} valid columns; with and without the mutual test): exact, the same bits "
              f"twice, a launch a call", flush=True)
        # (f) the call shape of loop verification, on the first closure's own
        # keyframes as the map held them: the features linked to a landmark
        c4 = lp["closures"][0]
        m4 = c4["map_before"]
        rows["match_best2/loop"] = match_case(
            f"no mask, keyframe {c4['kf']} x loop candidate {c4['cand']}",
            m4.kf_desc[c4["kf"]], m4.kf_desc[c4["cand"]],
            m4.kf_feat_valid[c4["kf"]] & (m4.kf_feat_lm[c4["kf"]] != -1),
            m4.kf_feat_valid[c4["cand"]] & (m4.kf_feat_lm[c4["cand"]] != -1), None, True)
    except RuntimeError as e:
        return fail(str(e))
    save_match_cases(torch, root / "build" / "match_cases.pt", match_inputs)
    for name in ("match_best2", "match_best2/stereo", "match_best2/epipolar",
                 "match_best2/global", "match_best2/reloc", "match_best2/loop"):
        rows[name].update(source="tc2li_slam_torch/csrc/match.cu",
                          replaces="tc2li_slam_tpu/ops/matching.py:62", max_abs_err=0.0)
    # (the epipolar mode evaluates epipolar_mask's gate too)
    rows["match_best2/epipolar"]["replaces"] = "tc2li_slam_tpu/ops/matching.py:185"

    g = torch.Generator(device=dev).manual_seed(0)
    ham_err = 0
    for n, mm in ((2000, 2000), (32768, 2000)):
        a = torch.randint(-2 ** 31, 2 ** 31 - 1, (n, 8), generator=g, device=dev, dtype=torch.int32)
        b = torch.randint(-2 ** 31, 2 ** 31 - 1, (mm, 8), generator=g, device=dev, dtype=torch.int32)
        got = hamming.hamming_matrix(a, b)
        ref = hamming.hamming_matrix_plain(a, b)
        torch.cuda.synchronize()
        e = int((got - ref).abs().max())
        if e != 0 or got.shape != (n, mm):
            return fail(f"Hamming kernel disagrees with its plain version at {n}x{mm}")
        ham_err = max(ham_err, e)
        ms_k = cuda_ms(torch, lambda: hamming.hamming_matrix(a, b), 50, True)
        ms_p = cuda_ms(torch, lambda: hamming.hamming_matrix_plain(a, b), 3)
        b_h = bound(32 * (n + mm) + 4 * n * mm, 8 * n * mm, 8 * n * mm)
        print(f"{tag} Hamming {n}x{mm}: exact; kernel {ms_k:.4f} ms, bound {b_h[0]:.4f} ms "
              f"({b_h[1]}), plain {ms_p:.4f} ms", flush=True)
    rows["hamming_matrix"] = dict(
        source="tc2li_slam_torch/csrc/hamming.cu",
        replaces="tc2li_slam_tpu/ops/kernels/hamming.py:33", max_abs_err=float(ham_err),
        ms=ms_k, plain_ms=ms_p, bound_ms=b_h[0], bound_by=b_h[1])

    # pose-only LM: phase 3's last frame (the inputs track_frame built), the
    # recovery's PnP polish of 4b, a length that is no multiple of the block,
    # nothing valid, and a masked row whose point is NaN
    (cam_t, *args_t), kw_t = track_case
    (cam_p, *args_p), kw_p = pnp_case
    X_nan = args_t[1].clone()
    X_nan[int(torch.nonzero(~args_t[5])[0, 0])] = float("nan")
    cam_args5, args5, kw5 = pose_problem(np.random.default_rng(5), 5000)
    cases = [("phase 3's last frame", cam_t, args_t, kw_t),
             ("4b's PnP polish", cam_p, args_p, kw_p),
             ("N 5000", cam_mod.Pinhole.create(*cam_args5),
              [torch.as_tensor(a).to(dev) for a in args5], kw5),
             ("nothing valid", cam_t, args_t[:5] + [torch.zeros_like(args_t[5])], kw_t),
             ("a masked NaN row", cam_t, [args_t[0], X_nan] + args_t[2:], kw_t)]
    pose_err = 0.0
    for name, cam_c, args_c, kw_c in cases:
        got = pose_lm.pose_only_lm(cam_c, *args_c, **kw_c)
        ref = pose_lm.pose_only_plain(cam_c, *args_c, **kw_c)
        torch.cuda.synchronize()
        agr = pose_agreement(cam_c, args_c, got, ref)
        print(f"{tag} pose_only_lm {name} (N {args_c[1].shape[0]}, {int(args_c[5].sum())} valid, "
              f"{kw_c['rounds']} x {kw_c['iters']}): |T - plain| {agr['pose']:.3e}, cost "
              f"{float(got.cost):.6f} / plain {float(ref.cost):.6f} (relative {agr['cost']:.2e}), "
              f"inliers {agr['n_inliers']}, flags that differ {agr['flips']}, of which at a "
              f"gate {agr['near']}", flush=True)
        if not (agr["pose"] <= 1e-4 and agr["cost"] <= 1e-3 and agr["flips"] == agr["near"]):
            return fail(f"pose_only_lm disagrees with its plain version on {name}: {agr}")
        if name in ("nothing valid", "a masked NaN row") and not torch.equal(got.T_cw, args_c[0]):
            return fail(f"pose_only_lm moved the pose on {name}")
        if name == "nothing valid" and (int(got.n_inliers) or float(got.cost) != 0.0):
            return fail(f"pose_only_lm with nothing valid: {int(got.n_inliers)} inliers, cost "
                        f"{float(got.cost)}")
        if name == "a masked NaN row" and not bool(torch.isnan(got.cost)):
            return fail("pose_only_lm: the masked NaN row did not make the cost NaN")
        pose_err = max(pose_err, agr["pose"])
    n_sync = syncs_of(torch, lambda: pose_lm.pose_only_lm(cam_t, *args_t, **kw_t))
    print(f"{tag} pose_only_lm: {n_sync} host syncs in a call", flush=True)
    if n_sync:
        return fail(f"pose_only_lm synchronised the host {n_sync} times in a call")
    for label, cam_c, args_c, kw_c in cases[:2]:
        N = args_c[1].shape[0]
        passes = 1 + kw_c["rounds"] * (kw_c["iters"] + 1)
        ms_k = cuda_ms(torch, lambda: pose_lm.pose_only_lm(cam_c, *args_c, **kw_c), 50, True)
        ms_h = cuda_ms(torch, lambda: pose_lm.pose_only_lm(cam_c, *args_c, **kw_c), 50)
        ms_p = cuda_ms(torch, lambda: pose_lm.pose_only_plain(cam_c, *args_c, **kw_c), 5)
        b_p = bound(POSE_BYTES_FIXED + POSE_BYTES_ROW * N, POSE_OPS_ROW * N * passes)
        # both float32 results beside the plain version run in float64
        T64 = pose_lm.pose_only_plain(
            cam_c, *(a.double() if a.is_floating_point() else a for a in args_c), **kw_c).T_cw
        d64 = [float((r.T_cw.double() - T64).abs().max()) for r in (
            pose_lm.pose_only_lm(cam_c, *args_c, **kw_c),
            pose_lm.pose_only_plain(cam_c, *args_c, **kw_c))]
        print(f"{tag} pose_only_lm {label}, N {N}, {kw_c['rounds']} x {kw_c['iters']} "
              f"({passes} passes): kernel {ms_k:.4f} ms on the device, {1e3 * ms_k / passes:.2f} "
              f"us a pass ({ms_h:.4f} ms a call "
              f"enqueued one at a time), bound {b_p[0]:.6f} ms ({b_p[1]}), plain {ms_p:.4f} ms; "
              f"|T - the plain version in float64| kernel {d64[0]:.3e}, plain {d64[1]:.3e}",
              flush=True)
        if label == cases[0][0]:
            rows["pose_only_lm"] = dict(
                source="tc2li_slam_torch/csrc/pose_lm.cu",
                replaces="tc2li_slam_tpu/solver/lm.py:92", max_abs_err=pose_err, ms=ms_k,
                plain_ms=ms_p, bound_ms=b_p[0], bound_by=b_p[1])

    try:
        rows.update(vi_phase(torch, dev, vi_inputs, rng, log=lambda m: print(f"{tag} {m}",
                                                                                flush=True),
                             sync=torch.cuda.synchronize,
                             timer=lambda fn, reps: cuda_ms(torch, fn, reps, True)))
    except RuntimeError as e:
        return fail(str(e))
    # the scan step's kernels: 4e's last scan step, the same at work_cap
    # 32768 (LioConfig's default, the whole downsampled scan), with the
    # extrinsic estimated, against an empty map and with a non-finite IMU
    # sample (the revert)
    la = lio_case4e
    acc_nan = la[6].clone()
    acc_nan[2] = float("nan")
    empty = la[1].replace(keys=torch.full_like(la[1].keys, torch.iinfo(torch.int32).max),
                          count=torch.zeros_like(la[1].count))
    lio_cases = [("4e's last scan step", la),
                 ("4e's last scan step, work_cap 32768", la[:10] + (la[10]._replace(
                     work_cap=1 << 15),)),
                 ("4e's last scan step, estimate_extrinsic", la[:10] + (la[10]._replace(
                     estimate_extrinsic=True),)),
                 ("4e's last scan step, an empty map", la[:1] + (empty,) + la[2:]),
                 ("4e's last scan step, bad IMU", la[:6] + (acc_nan,) + la[7:])]
    try:
        rows.update(lio_phase(torch, dev, lio_cases, log=lambda m: print(f"{tag} {m}",
                                                                          flush=True),
                              sync=torch.cuda.synchronize,
                              timer=lambda fn, reps: cuda_ms(torch, fn, reps, True)))
    except RuntimeError as e:
        return fail(str(e))

    # window BA: phase 3's last local-BA pass with the BALM term (its inputs as
    # System passed them), 4f's global BA (64 poses), and phase 3's pass with
    # no valid landmark; the BALM quadratic on phase 3's last clusters and on
    # them with every voxel invalid
    (a3, kw3), (ag, kwg) = balm_case3, global_case
    c3, T3 = quad_case3
    a3_none = a3[:5] + (torch.zeros_like(a3[5]),)
    lba_cases = [("phase 3's last BALM pass", a3, kw3), ("4f's global BA", ag, kwg),
                 ("phase 3's pass, no valid landmark", a3_none, kw3)]
    lba_err = 0.0
    for name, a, kw in lba_cases:
        got = klba.local_ba_lm(*a, **kw)
        again = klba.local_ba_lm(*a, **kw)
        ref = klba.local_ba_plain(*a, **kw)
        a64, kw64 = ba_float64(torch, a, kw)
        ref64 = klba.local_ba_plain(*a64, **kw64)
        torch.cuda.synchronize()
        agr = ba_outside(torch, got, ref, ref64)
        P_, (L_, K_) = a[1].shape[0], a[3].pose_idx.shape
        print(f"{tag} local_ba_lm {name} (P {P_}, L {L_}, K {K_}, {kw['iters']} iterations, "
              f"{int(a[5].sum())} valid landmarks, BALM {kw.get('extra_fn') is not None}): "
              f"cost {float(got.cost):.6f} / plain {float(ref.cost):.6f} / plain in float64 "
              f"{float(ref64.cost):.6f}; against the plain version (poses to 1e-4, landmarks to "
              f"1e-3 m, the cost to 1e-4 relative), or else no farther from its float64 run: "
              f"{json.dumps(agr)}", flush=True)
        if any(v["outside"] for v in agr.values()):
            return fail(f"local_ba_lm disagrees with its plain version on {name}: {agr}")
        same_bits = same(torch, got, again)
        print(f"{tag} local_ba_lm {name}: the same bits on a second call {same_bits}", flush=True)
        if not same_bits:
            return fail(f"local_ba_lm gave other bits on a second call ({name})")
        if a is a3_none and not torch.equal(got.X_w, a[2]):
            return fail("local_ba_lm moved a landmark with no valid landmark")
        lba_err = max(lba_err, agr["pose"]["max_vs_plain"], agr["landmark"]["max_vs_plain"])
    n_sync = [syncs_of(torch, lambda: klba.local_ba_lm(*a, **kw)) for _, a, kw in lba_cases]
    print(f"{tag} local_ba_lm: host syncs in a call {n_sync}", flush=True)
    if any(n_sync):
        return fail(f"local_ba_lm synchronised the host in a call: {n_sync}")
    # times with the BALM term held at its entry value (the kernels' own work:
    # the wrapper calls extra_fn before and after the launches)
    for label, a, kw in lba_cases[:2]:
        q0 = kw["extra_fn"](a[1]) if kw.get("extra_fn") is not None else None
        kwc = dict(kw, extra_fn=(lambda T, q0=q0: q0) if q0 is not None else None)
        P_, (L_, K_) = a[1].shape[0], a[3].pose_idx.shape
        D_, it = 6 * P_, kw["iters"]
        rr, w, _, _ = lm_mod._assemble_visual(a[0], a[1], a[2], a[3], False)
        live = (w != 0).reshape(L_, K_)
        n_live = int(live.sum())
        # the reduced system's pairs: live observations on free poses
        on_free = ~a[4][a[3].pose_idx.long().clamp(0, P_ - 1)]
        n_pairs = int((((live & on_free).sum(1) ** 2) * a[5]).sum())
        Df = 6 * int((~a[4]).sum())
        ms_k = cuda_ms(torch, lambda: klba.local_ba_lm(*a, **kwc), 20, True)
        ms_p = cuda_ms(torch, lambda: klba.local_ba_plain(*a, **kwc), 3)
        ms_full = cuda_ms(torch, lambda: klba.local_ba_lm(*a, **kw), 5)
        n_bytes = (128 * P_ + P_ + 24 * L_ + L_ + 22 * L_ * K_ + 12
                   + (4 * D_ * D_ + 4 * D_ + 4 if q0 is not None else 0))
        b_l = bound(n_bytes, it * (LBA_OPS_LIVE * n_live + LBA_OPS_PAIR * n_pairs
                                   + LBA_OPS_LANDMARK * L_ + Df ** 3 / 3 + 2 * Df ** 2))
        split = kernel_split(torch, lambda: klba.local_ba_lm(*a, **kwc), 5)
        print(f"{tag} local_ba_lm {label}, P {P_}, L {L_}, K {K_}, {it} iterations "
              f"({klba.launches_per_call(it)} launches; {n_live} observations of non-zero "
              f"weight, {n_pairs} pairs, {Df} free rows): kernels {ms_k:.4f} ms on the device, "
              f"bound {b_l[0]:.6f} ms ({b_l[1]}), plain {ms_p:.4f} ms; the whole call with its "
              f"BALM term evaluated twice {ms_full:.4f} ms; device ms a call by kernel "
              f"(torch.profiler): "
              + ", ".join(f"{k} {v['ms_a_call']:.4f} ({v['launches_a_call']:g})"
                          for k, v in split.items()), flush=True)
        if label == lba_cases[0][0]:
            rows["local_ba_lm"] = dict(
                source="tc2li_slam_torch/csrc/local_ba.cu",
                replaces="tc2li_slam_tpu/solver/lm.py:194", max_abs_err=lba_err, ms=ms_k,
                plain_ms=ms_p, bound_ms=b_l[0], bound_by=b_l[1])

    # the LVI-BA: 4e's last pass (its inputs as System passed them, the BALM
    # term on) and a synthetic FullInertialBA window (P 20, 10 iterations, no
    # BALM: the shape of System's full inertial BA at the VIBA rungs)
    lvi_cases = [("4e's last LVI-BA pass",) + tuple(lvi_case4e),
                 ("a FullInertialBA window",)
                 + lvi_args(torch, lvi_problem(np.random.default_rng(20), "full_inertial",
                                               L=8192), dev),
                 ("the second VIBA rung's FullInertialBA pass",) + tuple(lvi_rung)]
    try:
        rows.update(lvi_phase(torch, dev, lvi_cases,
                              log=lambda m: print(f"{tag} {m}", flush=True),
                              sync=torch.cuda.synchronize,
                              timer=lambda fn, reps: cuda_ms(torch, fn, reps, True),
                              split=lambda fn: kernel_split(torch, fn, 5)))
    except RuntimeError as e:
        return fail(str(e))

    # the visual-inertial initialization: 4e's call, the two rungs' (their
    # inputs as System passed them), and init_problem's windows (free gravity
    # and scale, free gravity, padded, non-finite); timed at 4e's call
    # (gravity fixed, 20 iterations), the free-gravity window's (20) and the
    # free-scale window's (8: the two give a call's cost an iteration)
    norm = lambda a, kw: (a, {"iters": 20, **kw})
    init_cases = ([("4e's initialization",) + norm(*init_case4e)]
                  + [(label,) + norm(a, kw) for label, a, kw in rung_cases]
                  + [(case,) + init_args(torch, init_problem(np.random.default_rng(25), case), dev)
                     for case in INIT_CASES])
    try:
        rows.update(init_phase(torch, dev, init_cases,
                               log=lambda m: print(f"{tag} {m}", flush=True),
                               sync=torch.cuda.synchronize,
                               timer=lambda fn, reps: cuda_ms(torch, fn, reps, True),
                               split=lambda fn: kernel_split(torch, fn, 5),
                               timed=["4e's initialization", "free gravity",
                                      "free gravity and scale"]))
    except RuntimeError as e:
        return fail(str(e))

    # the pose graph: 4f's closure (its arguments as close_loop passed them)
    # and pose_graph_problem's graphs up to 2,048 keyframes; timed at 4f's
    # closure, the 400- and the 2,048-keyframe graphs
    pg_cases = ([("4f's closure",) + lp["pose_graph_args"]]
                + [(case,) + pose_graph_args(torch, pose_graph_problem(
                    np.random.default_rng(26), case), dev) for case in PG_CASES])
    try:
        rows.update(pose_graph_phase(torch, dev, pg_cases,
                                     log=lambda m: print(f"{tag} {m}", flush=True),
                                     sync=torch.cuda.synchronize,
                                     timer=lambda fn, reps: cuda_ms(torch, fn, reps, True),
                                     split=lambda fn: kernel_split(torch, fn, 3),
                                     timed=["4f's closure", "covisibility 400",
                                            "2048 keyframes"]))
    except RuntimeError as e:
        return fail(str(e))

    # the BALM quadratic on phase 3's last clusters, on them with every voxel
    # invalid, and on a window of 6 LiDAR keyframes of 20000 points on three
    # planes (phase 3's keyframes hold 2048 points each, too few for a 1 m
    # voxel to pass the plane test: their clusters may hold no valid voxel)
    pl, pv, T_wl, T_pert = planar_window(np.random.default_rng(6), 6, 20000)
    up = lambda x: torch.as_tensor(x).to(dev)
    c_pl = balm_mod.build_clusters(up(pl), up(pv), up(T_wl), voxel_size=cfg.lidar.balm_voxel,
                                   max_voxels=cfg.lidar.balm_max_voxels,
                                   min_points=cfg.lidar.balm_min_points)
    quad_cases = [("phase 3's last clusters", c3, T3),
                  ("every voxel invalid", c3._replace(valid=torch.zeros_like(c3.valid)), T3),
                  ("6 keyframes on three planes", c_pl, up(T_pert))]
    quad_err = 0.0
    t0 = time.perf_counter()
    split_of = balm_phase_split(root, build)
    print(f"the BALM sources rebuilt with clock stamps in {time.perf_counter() - t0:.1f} s "
          f"(tools/balm_kernels.py)", flush=True)
    for name, c, T in quad_cases:
        got = kbalm.balm_quadratic(c, T)
        again = kbalm.balm_quadratic(c, T)
        ref = kbalm.quadratic_plain(c, T)
        torch.cuda.synchronize()
        rel = lambda x, y: float((x - y).abs().max() / y.abs().max().clamp(min=1e-30))
        e = (rel(got.H, ref.H), rel(got.g, ref.g),
             abs(float(got.cost) - float(ref.cost)) / max(abs(float(ref.cost)), 1e-30))
        same_bits = all(torch.equal(x, y) for x, y in zip(got, again))
        print(f"{tag} balm_quadratic {name} (V {c.N.shape[0]}, W {c.N.shape[1]}, "
              f"{int(c.valid.sum())} valid voxels): |H - plain| / max|H| {e[0]:.2e}, "
              f"|g - plain| / max|g| {e[1]:.2e}, cost {float(got.cost):.6f} / plain "
              f"{float(ref.cost):.6f}; the same bits on a second call {same_bits}", flush=True)
        if not same_bits:
            return fail(f"balm_quadratic gave other bits on a second call ({name})")
        if max(e) > 1e-3:
            return fail(f"balm_quadratic disagrees with its plain version on {name}: {e}")
        if name == "every voxel invalid" and (got.H.any() or got.g.any() or float(got.cost) != 0.0):
            return fail("balm_quadratic with every voxel invalid is not 0")
        quad_err = max(quad_err, float((got.H - ref.H).abs().max()),
                       float((got.g - ref.g).abs().max()))
    if int(c_pl.valid.sum()) < 50:
        return fail(f"the planar window holds {int(c_pl.valid.sum())} valid voxels")
    for name, c, T in quad_cases[::2]:
        V_, W_ = c.N.shape
        D_ = 6 * W_
        n_vox = int(c.valid.sum())
        ms_k = cuda_ms(torch, lambda: kbalm.balm_quadratic(c, T), 50, True)
        ms_p = cuda_ms(torch, lambda: kbalm.quadratic_plain(c, T), 3)
        b_q = bound(V_ * W_ * 52 + 13 * V_ + 64 * W_ + 4 * D_ * D_ + 4 * D_ + 4,
                    n_vox * (BALM_OPS_JET + BALM_OPS_ROW * D_ + BALM_OPS_POSE_TERM * 9 * W_
                             + BALM_OPS_ENTRY * D_ * D_))
        q_split = kernel_split(torch, lambda: kbalm.balm_quadratic(c, T), 10)
        q_phases = split_of(torch, "balm", lambda: kbalm.balm_quadratic(c, T))
        print(f"{tag} balm_quadratic {name}, V {V_}, W {W_}, {n_vox} valid voxels: kernel "
              f"{ms_k:.4f} ms on the device, bound {b_q[0]:.6f} ms ({b_q[1]}), plain "
              f"{ms_p:.4f} ms; device launches a call "
              f"{sum(v['launches_a_call'] for v in q_split.values()):g} ("
              + ", ".join(f"{k} {v['ms_a_call']:.4f} ms" for k, v in q_split.items())
              + f"); phases of the stamped build: {phase_text(q_phases, ms_k)}", flush=True)
    # the row: the planar window (the main path's shapes, V 512 and W 6)
    rows["balm_quadratic"] = dict(
        source="tc2li_slam_torch/csrc/balm.cu", replaces="tc2li_slam_tpu/solver/balm.py:303",
        max_abs_err=quad_err, ms=ms_k, plain_ms=ms_p, bound_ms=b_q[0], bound_by=b_q[1])

    # the stereo half of the frame build on phase 3's last frame pair, its
    # every-keypoint-ok case (the median gate fires) and a border case
    il3, ir3 = (torch.as_tensor(im).to(dev) for im in imgs[N_FRAMES - 1])
    kl3, kr3 = orb.extract_images([il3, ir3], cfg.orb.n_features, cfg.orb.n_levels)
    as_np = lambda k: {f: getattr(k, f).cpu().numpy() for f in ("xy", "level", "desc", "valid")}
    pair3 = (il3.cpu().numpy(), ir3.cpu().numpy(), as_np(kl3), as_np(kr3))
    st_args = {}
    for case in STEREO_CASES + STEREO_EDGE_CASES:
        il, ir, kl, kr = stereo_case(np.random.default_rng(1), case, *pair3)
        a = (torch.as_tensor(il).to(dev), torch.as_tensor(ir).to(dev),
             stereo_keypoints(torch, orb, kl, dev), stereo_keypoints(torch, orb, kr, dev),
             slam.scale_factors, slam.cam.bf, slam.cam.baseline)
        n0, m0 = kst.launches, match.launches
        got, again = kst.stereo_refine(*a), kst.stereo_refine(*a)
        n_st, n_m = kst.launches - n0, match.launches - m0
        ref = kst.stereo_refine_plain(*a)
        torch.cuda.synchronize()
        N_c, M_c = kl["xy"].shape[0], kr["xy"].shape[0]
        want = (2 * kst.launches_per_call(N_c, M_c),
                2 * int(N_c > 0) * len(match.chunk_bounds(M_c, match.StereoMask)))
        print(f"{tag} stereo_refine {case}: N {N_c}, M {M_c}, {int(ref.ok.sum())} ok, "
              f"{int((ref.depth > 0).sum())} with depth; bit-equal to the plain chain "
              f"{bit_equal(torch, got, ref)}, the same bits on a second call "
              f"{bit_equal(torch, got, again)}; launches in two calls {n_st} + {n_m} "
              f"(the match's), implied {want[0]} + {want[1]}", flush=True)
        if not bit_equal(torch, got, ref) or not bit_equal(torch, got, again):
            return fail(f"stereo_refine disagrees with its plain chain or itself ({case})")
        if (n_st, n_m) != want:
            return fail(f"stereo_refine launches ({case}): {n_st} + {n_m}, implied {want}")
        st_args[case] = a
    a = st_args["frame"]
    N_, M_ = a[2].xy.shape[0], a[3].xy.shape[0]
    n_sync = syncs_of(torch, lambda: kst.stereo_refine(*a))
    split = kernel_split(torch, lambda: kst.stereo_refine(*a), 10)
    own = ("prep_kernel", "refine_kernel")
    matcher = ("match_best2_stereo_kernel",)
    ms_k = sum(split[k]["ms_a_call"] for k in own if k in split)
    ms_call = cuda_ms(torch, lambda: kst.stereo_refine(*a), 50, True)
    _, disp, ok = stereo.match_stereo(a[2].xy, a[2].level, a[2].desc, a[2].valid, a[3].xy,
                                      a[3].level, a[3].desc, a[3].valid, a[4], a[5], a[6])
    ms_p = cuda_ms(torch, lambda: kst.refine_plain(a[0], a[1], a[2].xy, disp, ok, a[5]), 5)
    ms_route_p = cuda_ms(torch, lambda: kst.stereo_refine_plain(*a), 5)
    b_st = subpixel_bound(N_, M_)
    print(f"{tag} stereo_refine, phase 3's last pair (N {N_}, M {M_}): its two launches "
          f"{ms_k:.4f} ms on the device (" + ", ".join(
              f"{k} {split[k]['ms_a_call']:.4f}" for k in own if k in split)
          + f"), bound {b_st[0]:.6f} ms ({b_st[1]}), the plain chain after the match "
          f"{ms_p:.4f} ms; the whole stereo half (prep, the match, refine with the gate; "
          f"{sum(v['launches_a_call'] for v in split.values()):g} device launches: "
          + ", ".join(f"{k} {split[k]['ms_a_call']:.4f}" for k in matcher if k in split)
          + f") {ms_call:.4f} ms behind a backlog, the parent's eager route with its match "
          f"launch {ms_route_p:.4f} ms; host syncs in a call {n_sync}", flush=True)
    if n_sync:
        return fail(f"stereo_refine made {n_sync} host syncs")
    rows["stereo_refine"] = dict(
        source="tc2li_slam_torch/csrc/stereo.cu", replaces="tc2li_slam_tpu/ops/stereo.py:62",
        max_abs_err=0.0, ms=ms_k, plain_ms=ms_p, bound_ms=b_st[0], bound_by=b_st[1])

    # the BALM clusters on the windows of phase 3's and 4e's last calls and
    # on the planar window above
    cl_cases = [("phase 3's last window", clusters_case3), ("4e's last window", clusters_case4e),
                ("6 keyframes on three planes", ((up(pl), up(pv), up(T_wl)), dict(
                    voxel_size=cfg.lidar.balm_voxel, max_voxels=cfg.lidar.balm_max_voxels,
                    min_points=cfg.lidar.balm_min_points)))]
    save_balm_windows(root / "build" / "balm_windows.npz", cl_cases, quad_cases[::2])
    for name, (a, kw) in cl_cases:
        got, again = kcl.balm_clusters(*a, **kw), kcl.balm_clusters(*a, **kw)
        ref = balm_mod.build_clusters_plain(*a, **kw)
        torch.cuda.synchronize()
        agree, how = clusters_agree(torch, got, ref, a[2])
        W_, M_ = a[0].shape[:2]
        V_ = got.N.shape[0]
        n_valid = int(a[1].sum())
        n_sync = syncs_of(torch, lambda: kcl.balm_clusters(*a, **kw))
        runs, n0 = kcl.device_runs(), kcl.launches
        cl_fn, cl_calls = counted(lambda: kcl.balm_clusters(*a, **kw))
        split = kernel_split(torch, cl_fn, 5)
        if kcl.device_runs() - runs != cl_calls[0] or kcl.launches - n0 != cl_calls[0]:
            return fail(f"balm_clusters on {name}: {kcl.device_runs() - runs} launches ran to "
                        f"their end of {kcl.launches - n0} enqueued, {cl_calls[0]} calls")
        ms_k = split["clusters_kernel"]["ms_a_launch"]
        ms_call = cuda_ms(torch, lambda: kcl.balm_clusters(*a, **kw), 20, True)
        ms_p = cuda_ms(torch, lambda: balm_mod.build_clusters_plain(*a, **kw), 3)
        b_cl = clusters_bound(W_, M_, V_, n_valid)
        cl_phases = split_of(torch, "clusters", lambda: kcl.balm_clusters(*a, **kw))
        print(f"{tag} balm_clusters {name} (W {W_}, M {M_}, {n_valid} valid points, V {V_}): "
              f"{int(ref.valid.sum())} planar voxels, {int((ref.N.sum(1) > 0).sum())} slots "
              f"filled; {how} to the plain version, the same bits on a second call "
              f"{bit_equal(torch, got, again)}; kernel {ms_k:.4f} ms on the device, the call "
              f"with its three tensor ops {ms_call:.4f} ms behind a backlog, bound "
              f"{b_cl[0]:.6f} ms ({b_cl[1]}), plain {ms_p:.4f} ms; host syncs in a call "
              f"{n_sync}; device launches a call {sum(v['launches_a_call'] for v in split.values()):g}"
              f"; phases of the stamped build: {phase_text(cl_phases, ms_k)}", flush=True)
        if not agree or not bit_equal(torch, got, again) or n_sync:
            return fail(f"balm_clusters on {name}: {how}; host syncs {n_sync}")
        if name == "4e's last window":
            rows["balm_clusters"] = dict(
                source="tc2li_slam_torch/csrc/clusters.cu",
                replaces="tc2li_slam_tpu/solver/balm.py:110", max_abs_err=0.0, ms=ms_k,
                plain_ms=ms_p, bound_ms=b_cl[0], bound_by=b_cl[1])

    # --- 6. result -------------------------------------------------------------
    kernels = []
    for name in ("orb_level_planes", "fast_score_planes", "fast_nms_planes", "orb_select_grid",
                 "orb_describe", "stereo_refine", "hamming_matrix", "match_best2",
                 "match_best2/stereo", "match_best2/epipolar", "match_best2/global", "match_best2/reloc",
                 "match_best2/loop", "pose_only_lm", "balm_clusters", "balm_quadratic",
                 "local_ba_lm", "lvi_ba_lm", "inertial_init_gn", "pose_graph_gn",
                 "imu_preintegrate",
                 "pose_inertial_lm",
                 "esekf_predict", "lio_fences", "lio_rows", "esekf_step"):
        r = rows[name]
        kernels.append({"name": name, "route": "cuda", "source": r["source"],
                        "replaces": r["replaces"], "launches": launches[name],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"], "library_ms": r.get("library_ms"),
                        "launches_imu_mode": imu_launches.get(name, 0),
                        **{k: r[k] for k in ("first_ms", "middle_ms", "final_ms", "call_ms",
                                             "predict_alone_ms", "ms_by_case") if k in r}})
    print(f"chip_smoke: {time.perf_counter() - t_script:.1f} s in all", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
