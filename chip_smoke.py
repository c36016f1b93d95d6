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
   one launch each; a stereo match per
   frame, a tracking match per tracked frame, one match per fuse pass; one
   pose-only LM per tracked frame); prints ``track_step``'s stage ms a
   frame and ``local_ba``'s by pass. In this and every later phase that
   counts launches the pose-only LM kernel must have launched once per
   ``track_frame`` and once per ``pnp_ransac`` call of the phase's run (both
   counted where the port calls them), and at least once; the BALM
   quadratic twice per local-BA pass with the BALM term (``n_ba_balm``; 2 x
   iterations on the mesh path of 4g), once per LVI-BA pass with it
   (``n_lvi_ba_balm``); the window BA's kernels ``launches_per_call(iters)``
   times per ``run_local_ba`` call off the mesh (``_global_ba``'s included),
   counted where ``System`` calls it;
4. the duplicate-fusion pass (``culling.fuse_duplicates``, the caller of the
   Hamming-matrix kernel) over the slice's landmarks, counted the same way
   and held against the same call on the CPU;
4a. the default configuration (``triangulate=True``) with a vocabulary
   trained on the host from the first frames' descriptors: 14 of the same
   frames, every frame OK, new map points triangulated, the same ATE limit,
   launch counts by call shape against what the run implies (one
   epipolar-masked match per triangulated keyframe pair); the cost and the host syncs of the batched
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
   flag, finite poses, the same ATE limit, and the three kernels' launch
   counts against what the run implies; then a forced bad-IMU event (a
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
   candidates verified; host syncs counted frame by frame. Then a
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
   every keypoint whose angle is), and no host sync in one ``build_frame``;
   the fused matcher in its three mask modes on the slice's own data (the
   last frame's stereo pair at 2000x2000; the landmark pool against a
   keyframe's features at 32768x2000), on a full pool, on a dense worst
   case and on edge rows, and in the three call shapes of 4a-4d on that
   run's data (a keyframe pair under its epipolar mask, the pool against a
   frame, a frame against one column chunk of the pool and against all of
   it), and in the call shape of 4f (two keyframes' 2000 features, no mask,
   mutual); the Hamming matrix at 2000x2000 and 32768x2000; the pose-only
   LM on the inputs of phase 3's last ``pose_only_optimize`` call, on 4b's
   PnP polish, at N = 5000, with nothing valid and with a masked NaN row
   (poses to 1e-4, costs to 1e-3 relative, inlier flags equal but where a
   row's chi2, re-derived in float64, sits at its threshold; times behind a
   device backlog beside the plain version's, and a pass's share); the
   window BA's kernels on the inputs of phase 3's last local-BA pass with
   the BALM term, of 4f's global BA (64 poses) and on phase 3's pass with
   no valid landmark (poses to 1e-4, landmarks to 1e-3 m, cost to 1e-4
   relative, or else no farther from the plain version run in float64; the
   same bits on a second call; the device time of a call split by launch
   with ``torch.profiler``), the BALM quadratic
   on phase 3's last clusters (H and g to 1e-3 of their largest entry, the
   cost to 1e-3 relative, the same bits on a second call) and with every
   voxel invalid (exactly 0);
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
# the kernels of one frame build (ops/orb.extract_images): one launch each
ORB_KERNELS = ("orb_level_planes", "fast_score_planes", "fast_nms_planes", "orb_select_grid",
               "orb_describe")
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
# the damped 3x3 inverse; then the dense solve, (2/3) D^3 + 3 D^2
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


def kernel_split(torch, fn, calls: int) -> dict:
    """Device ms a call of each kernel name that ``fn`` launches, from a
    ``torch.profiler`` trace of ``calls`` calls after one warm-up: {name:
    {"launches_a_call", "ms_a_call"}}, the largest first. Names are cut to
    the function's (``build_kernel`` for ``(anonymous namespace)::
    build_kernel(...)``)."""
    import re
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
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
    return {k: {"launches_a_call": n / calls, "ms_a_call": us / 1e3 / calls}
            for k, (n, us) in sorted(per.items(), key=lambda kv: -kv[1][1])}


def bound(n_bytes: float, simple_ops: float = 0.0, popc: float = 0.0):
    """(least ms on the card, what bounds it) for that much work."""
    t_bytes = n_bytes / PEAK_BYTES_S
    t_ops = max(simple_ops / PEAK_SIMPLE_S, popc / PEAK_POPC_S)
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def kitti_config(cfg_mod, syn, triangulate: bool = False, **tracking):
    """bench.py's KITTI-shaped STEREO_LIDAR configuration, stage timers on
    (``profile=True``) as there; ``triangulate=True`` is its default, off is
    the first slice's. ``tracking`` overrides fields of the TrackingConfig."""
    import numpy as np
    cam = syn.KITTI_LIKE
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
    caught_now = [[]]    # the warnings list of the frame in flight

    def spy(m, kf_id, cand_id, S_loop, **kw):
        """``close_loop``, and what the phase reports of it (the syncs the
        report itself makes are counted apart)."""
        out = close_loop(m, kf_id, cand_id, S_loop, **kw)
        n0 = n_syncs(caught_now[0])
        n_done = len(slam.traj)
        closures.append(dict(
            frame=slam.frame_idx, kf=kf_id, cand=cand_id, n_traj=n_done, map_before=m,
            S=S_loop, n_kf=kw["n_kf"],
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
        # closure replayed on the map as it was, under the profiler
        from torch.profiler import ProfilerActivity, profile
        replay = {
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
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                ms = 1e3 * (time.perf_counter() - t0)
            dev_events = [e for e in prof.events()
                          if e.device_type == torch.autograd.DeviceType.CUDA]
            log(f"loop closing: {name} replayed under the profiler: {len(dev_events)} device "
                f"events, {sum(e.time_range.elapsed_us() for e in dev_events) / 1e3:.3f} ms of "
                f"device time, {ms:.1f} ms on the host clock")

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


def ply_vertices(path) -> int:
    """The vertex count in a PLY header."""
    with open(path) as f:
        for line in f:
            if line.startswith("element vertex"):
                return int(line.split()[-1])
    raise RuntimeError(f"{path}: no vertex count")


def n_syncs(caught) -> int:
    """Host syncs among warnings caught under ``set_sync_debug_mode("warn")``."""
    return sum("synchroniz" in str(w.message).lower() for w in caught)


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


def orb_kernel_rows(torch, pair, log=print) -> dict:
    """Phase 5's rows of the three ORB kernels (``csrc/orb.cu``) on the real
    images ``pair`` (float32 [H, W] on the card): each against its plain
    version on one and on two images, bit for bit (the descriptors of every
    keypoint whose angle is equal; any other is printed and fails), then
    device ms behind a backlog beside the bound, the plain version and, for
    the pyramid, ``F.interpolate(..., "bilinear", antialias=True)`` of every
    level. Raises RuntimeError on a disagreement."""
    import math
    import torch.nn.functional as F
    from tc2li_slam_torch.ops import orb
    from tc2li_slam_torch.ops.kernels import fast, orb as korb
    n_levels, scale, n_feat = 8, 1.2, 2000
    per = orb.features_per_level(n_feat, n_levels, scale)
    err = {"level": 0.0, "select": 0.0, "describe": 0.0}
    for fs in (pair[:1], pair):
        imgs = torch.stack(fs)
        st, bl, shapes = korb.orb_level_planes(imgs, n_levels, scale)
        st_p, bl_p, shapes_p = korb.level_planes_plain(imgs, n_levels, scale)
        pad = korb.PAD
        if shapes != shapes_p:
            raise RuntimeError(f"orb_level_planes: shapes {shapes} against {shapes_p}")
        for p, (h, w) in enumerate(shapes):
            for got, ref in ((st, st_p), (bl, bl_p)):
                e = float((got[p, :h + 2 * pad, :w + 2 * pad]
                           - ref[p, :h + 2 * pad, :w + 2 * pad]).abs().max())
                err["level"] = max(err["level"], e)
                if not torch.equal(got[p, :h + 2 * pad, :w + 2 * pad],
                                   ref[p, :h + 2 * pad, :w + 2 * pad]):
                    raise RuntimeError(f"orb_level_planes disagrees with its plain version on "
                                       f"plane {p} ({len(fs)} image(s)): max |diff| {e}")
        scores = fast.detect_planes(st, shapes, pad)
        sel = korb.orb_select_grid(scores, shapes, per, scale)
        sel_p = korb.select_grid_plain(scores, shapes, per, scale)
        err["select"] = max([err["select"]] + [float((a.double() - b.double()).abs().max())
                                               for a, b in zip(sel, sel_p) if a.numel()])
        if not all(torch.equal(a, b) for a, b in zip(sel, sel_p)):
            raise RuntimeError(f"orb_select_grid disagrees with its plain version "
                               f"({len(fs)} image(s))")
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
    n_pix = sum(h * w for h, w in shapes)
    n_padded = sum((h + 2 * pad) * (w + 2 * pad) for h, w in shapes)
    ops_level = 28 * n_pix
    for lvl in range(1, n_levels):
        h, w = shapes[lvl]
        tr = korb.resize_taps(H, h)[1].shape[1]
        tc = korb.resize_taps(W, w)[1].shape[1]
        ops_level += B * (2 * h * W * tr + 2 * h * w * tc)
    b_level = bound(4 * B * H * W + 8 * n_padded, ops_level)
    # the grid top-k: every pixel read and compared for each of its cell's
    # candidates, the positive candidates sorted, the slots written
    ops_sel, n_pos = 0, 0
    for p, (h, w) in enumerate(shapes):
        hc, wc = -(-h // korb.CELL), -(-w // korb.CELL)
        m = korb.cell_candidates(hc * wc, per[p % n_levels])
        cells = F.pad(scores[p, :h, :w], (0, wc * korb.CELL - w, 0, hc * korb.CELL - h))
        cells = cells.reshape(hc, korb.CELL, wc, korb.CELL).permute(0, 2, 1, 3).reshape(hc * wc, -1)
        pos = int(torch.clamp((cells > 0).sum(1), max=m).sum())
        n_pos += pos
        ops_sel += m * h * w + pos * max(1.0, math.log2(max(pos, 1)))
    b_sel = bound(4 * n_pix + 20 * K, ops_sel)
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
    x = imgs[:, None]
    ms_interp = cuda_ms(torch, lambda: [F.interpolate(x, size=shapes[lvl], mode="bilinear",
                                                      antialias=True)
                                        for lvl in range(1, n_levels)], 50, True)
    log(f"orb_level_planes, 2 images x {n_levels} levels ({n_padded} padded pixels a stack): "
        f"{ms_level:.4f} ms on the device (bound {b_level[0]:.4f} ms, {b_level[1]}; plain "
        f"{ms_level_p:.4f} ms; F.interpolate bilinear antialias, one call a level, "
        f"{ms_interp:.4f} ms); orb_select_grid, {len(shapes)} planes, {n_pos} positive "
        f"candidates: {ms_sel:.4f} ms (bound {b_sel[0]:.6f} ms, {b_sel[1]}; plain "
        f"{ms_sel_p:.4f} ms); orb_describe, {K} keypoints ({n_img} patch and {n_blur} tap "
        f"pixels): {ms_desc:.4f} ms (bound "
        f"{b_desc[0]:.6f} ms, {b_desc[1]}; plain {ms_desc_p:.4f} ms)")
    src, ref = "tc2li_slam_torch/csrc/orb.cu", "tc2li_slam_tpu/ops/orb.py"
    return {
        "orb_level_planes": dict(source=src, replaces=f"{ref}:425", max_abs_err=err["level"],
                                 ms=ms_level, plain_ms=ms_level_p, bound_ms=b_level[0],
                                 bound_by=b_level[1], library_ms=ms_interp),
        "orb_select_grid": dict(source=src, replaces=f"{ref}:204", max_abs_err=err["select"],
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
            if cuda and any(counts[k] != n for k in ORB_KERNELS):
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

    from tc2li_slam_torch.geom import camera as cam_mod, lie, triangulate as tri_geom
    from tc2li_slam_torch.io import synthetic as syn
    from tc2li_slam_torch.ops import bow, orb
    from tc2li_slam_torch.ops.kernels import (balm as kbalm, build, fast, hamming,
                                              local_ba as klba, match, orb as korb, pose_lm)
    from tc2li_slam_torch.slam import (config as cfg_mod, culling, lio, local_mapping,
                                       relocalization, system as sys_mod, tracking,
                                       triangulation)
    from tc2li_slam_torch.solver import balm as balm_mod, lm as lm_mod, pnp as pnp_mod

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

    def quadratic_spy(c, T_wl):
        ba_inputs["quadratic"] = (c, T_wl)
        ba_inputs.setdefault("valid_voxels", []).append(c.valid.sum())   # (read later)
        return quadratic(c, T_wl)

    local_mapping.run_local_ba = run_local_ba_spy
    sys_mod.System._global_ba = global_ba_spy
    lm_mod.local_ba = local_ba_spy
    balm_mod.quadratic = quadratic_spy

    def reset_counts():
        fast.score_launches = fast.nms_launches = hamming.launches = match.launches = 0
        pose_lm.launches = calls["track_frame"] = calls["pnp_ransac"] = 0
        kbalm.launches = klba.launches = 0
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
                "local_ba_lm": klba.launches, "calls:run_local_ba": ba_calls["run_local_ba"],
                "calls:global_ba": ba_calls["global_ba"],
                "implied:local_ba_lm": ba_calls["implied"]}

    def ba_fault(counts, n_balm, n_lvi_balm=0, mesh_iters=0):
        """None if balm_quadratic launched twice a local-BA pass with the BALM
        term (2 x iters on the mesh path) and once an LVI-BA pass with it, and
        local_ba_lm launches_per_call(iters) times a run_local_ba call off
        the mesh."""
        want = n_balm * (2 * mesh_iters if mesh_iters else 2) + n_lvi_balm
        faults = []
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
    launches = read_counts()
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
    expected = {**dict.fromkeys(ORB_KERNELS, N_FRAMES), "hamming_matrix": 0, "match_best2": N_FRAMES + (N_FRAMES - 1) + n_fuse,
                "pose_only_lm": N_FRAMES - 1, "calls:track_frame": N_FRAMES - 1,
                "calls:pnp_ransac": 0, "balm_quadratic": 2 * n_balm3,
                "local_ba_lm": klba.launches_per_call(cfg.tracking.ba_iters) * n_ba3,
                "calls:run_local_ba": n_ba3, "calls:global_ba": 0,
                "implied:local_ba_lm": klba.launches_per_call(cfg.tracking.ba_iters) * n_ba3}
    if launches != expected or slam.n_recover or slam.n_reloc:
        return fail(f"launches {launches} != {expected} (one detection per frame; a stereo "
                    f"match per frame, a tracking match and a pose-only LM per tracked frame, "
                    f"{n_fuse} fuse passes; two BALM quadratics and one local_ba_lm call a "
                    f"mapping pass, {n_ba3} passes; recoveries {slam.n_recover}, "
                    f"relocalizations {slam.n_reloc})")
    if n_balm3 < 1 or balm_case3 is None or quad_case3 is None:
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
    chunks = -(-cfg.tracking.max_lm // match.DENSE_MAX_COLUMNS)

    # the matcher's wrapper counts its launches by call shape; the rows of
    # the three new shapes report the sum of the readings of phases 4a-4d
    SHAPES = {"match_best2/epipolar": "dense+mutual", "match_best2/global": "none+mutual",
              "match_best2/reloc": "none+mutual+chunk"}
    shape_launches = dict.fromkeys(SHAPES, 0)

    def read_modes():
        modes = dict(match.launches_by_mode)
        for name, key in SHAPES.items():
            shape_launches[name] += modes.get(key, 0)
        return modes

    def snap(sl):
        return dict(n_recover=sl.n_recover, n_reloc=sl.n_reloc, n_fuse=sl.n_fuse, n_ba=sl.n_ba,
                    n_ba_balm=sl.n_ba_balm, n_lvi_ba=getattr(sl, "n_lvi_ba", 0),
                    n_lvi_ba_balm=getattr(sl, "n_lvi_ba_balm", 0))   # (IMU mode only)

    def cross_check(counts, modes, n_built, n_tracked, before, after, n_reloc_calls):
        """What the system's own counts say of the measured launches, or
        None: a detection and a stereo match per frame built; a windowed
        match per tracked frame, per recovery and per fuse pass, and one to
        three per relocalization (its refinement); a global match per
        recovery; whole sets of column chunks, at most five candidates a
        relocalization; at most ``tri_pairs`` epipolar matches a mapping
        pass; no other call shape."""
        d = {k: after[k] - before[k] for k in after}
        get = modes.get
        window_lo = n_tracked + d["n_recover"] + d["n_fuse"]
        faults = []
        if any(counts[k] != n_built for k in ORB_KERNELS) or counts["hamming_matrix"]:
            faults.append(f"{n_built} frames built")
        if sum(modes.values()) != counts["match_best2"]:
            faults.append("the shapes do not sum to the matcher's count")
        if get("stereo+mutual", 0) != n_built:
            faults.append(f"{n_built} stereo matches")
        if not window_lo <= get("window", 0) <= window_lo + 3 * n_reloc_calls:
            faults.append(f"{window_lo}..{window_lo + 3 * n_reloc_calls} windowed matches")
        if get("none+mutual", 0) != d["n_recover"]:
            faults.append(f"{d['n_recover']} global matches")
        if get("none+mutual+chunk", 0) % chunks or \
                get("none+mutual+chunk", 0) > 5 * chunks * n_reloc_calls:
            faults.append(f"sets of {chunks} chunk matches, at most {5 * n_reloc_calls}")
        if get("dense+mutual", 0) > cfg2.tracking.tri_pairs * d["n_ba"]:
            faults.append(f"at most {cfg2.tracking.tri_pairs * d['n_ba']} epipolar matches")
        if set(modes) - {"stereo+mutual", "window", "none+mutual", "none+mutual+chunk",
                         "dense+mutual"}:
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
    tri_pairs_a = modes_a.get("dense+mutual", 0)
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
          f"{tri_pairs_a} keyframe pairs (one epipolar-masked match launch each)", flush=True)
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
    fault = cross_check(counts_c, modes_c, 1, 0, after, after, 1)
    if fault or modes_c.get("none+mutual+chunk", 0) < chunks or modes_c.get("window", 0) < 1 \
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
    fault = cross_check(counts_e, modes_e, N_IMU, N_IMU - 1, before, after, 0)
    if fault or after["n_recover"] != before["n_recover"]:
        return fail(f"IMU mode: {fault or 'a frame went through recovery'}")
    pose_launches["4e"] = counts_e["pose_only_lm"]
    imu_launches = {**{k: counts_e[k] for k in ORB_KERNELS},
                    "pose_only_lm": counts_e["pose_only_lm"],
                    "match_best2": modes_e.get("stereo+mutual", 0) + modes_e.get("window", 0),
                    "match_best2/epipolar": modes_e.get("dense+mutual", 0),
                    "balm_quadratic": counts_e["balm_quadratic"],
                    "local_ba_lm": counts_e["local_ba_lm"]}
    for name, n_launched in imu_launches.items():
        if n_launched < 1:
            return fail(f"IMU mode: {name} was launched no time")

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
    if any(counts_f[k] != N_LOOP for k in ORB_KERNELS) or counts_f["hamming_matrix"] \
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
    ms_nms = cuda_ms(torch, lambda: fast.nms_planes(gated, flags, shapes, ini_th, min_th, cell), 50, True)
    ms_fused = cuda_ms(torch, lambda: fast.detect_planes(stack, shapes, pad, ini_th, min_th, cell), 50, True)
    ms_fused_host = cuda_ms(torch, lambda: fast.detect_planes(stack, shapes, pad, ini_th, min_th, cell), 50)
    ms_score_p = cuda_ms(torch, lambda: fast.score_planes_plain(stack, shapes, pad, ini_th, min_th, cell), 5)
    ms_nms_p = cuda_ms(torch, lambda: fast.nms_planes_plain(gated, flags, shapes, ini_th, min_th, cell), 5)
    planes = [stack[p, pad:pad + h, pad:pad + w].contiguous() for p, (h, w) in enumerate(shapes)]
    ms_level = cuda_ms(torch, lambda: [fast.gate_nms_plain(fast.fast_score_raw(pl), ini_th, min_th, cell)
                                       for pl in planes], 20)
    ms_raw = cuda_ms(torch, lambda: [fast.fast_score_raw(pl) for pl in planes], 20, True)
    b_score = bound(8 * n_pix + 4 * flags.numel(),
                    FAST_OPS_REJECT * (n_int - n_full) + FAST_OPS_FULL * n_full)
    b_nms = bound(8 * n_pix + 4 * flags.numel(), 3 * n_pix)
    print(f"{tag} FAST detection, 16 planes (8 levels of two 1241x376 images, {n_pix} pixels, "
          f"{n_full} past the compass test): fast_score_planes {ms_score:.4f} ms (bound "
          f"{b_score[0]:.4f} ms, {b_score[1]}; plain {ms_score_p:.4f} ms), fast_nms_planes "
          f"{ms_nms:.4f} ms (bound {b_nms[0]:.4f} ms, {b_nms[1]}; plain {ms_nms_p:.4f} ms), both "
          f"passes {ms_fused:.4f} ms on the device, {ms_fused_host:.4f} ms a call when the host "
          f"enqueues one at a time; per-level route (16 one-plane launches + eager gates and "
          f"NMS) {ms_level:.4f} ms, its 16 launches alone {ms_raw:.4f} ms", flush=True)
    rows["fast_score_planes"] = dict(
        source="tc2li_slam_torch/csrc/fast.cu", replaces="tc2li_slam_tpu/ops/kernels/fast.py:80",
        max_abs_err=fast_err, ms=ms_score, plain_ms=ms_score_p, bound_ms=b_score[0],
        bound_by=b_score[1])
    rows["fast_nms_planes"] = dict(
        source="tc2li_slam_torch/csrc/fast.cu", replaces="tc2li_slam_tpu/ops/orb.py:182",
        max_abs_err=nms_err, ms=ms_nms, plain_ms=ms_nms_p, bound_ms=b_nms[0], bound_by=b_nms[1])

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
    def match_case(name, d1, d2, v1, v2, mask, mutual, reps_plain=3):
        got = match.match_best2(d1, d2, v1, v2, mask, mutual)
        ref = match.match_best2_plain(d1, d2, v1, v2, mask, mutual)
        torch.cuda.synchronize()
        if not same(torch, got, ref):
            raise RuntimeError(f"match_best2 disagrees with its plain version: {name}")
        N, M = d1.shape[0], d2.shape[0]
        full = v1[:, None] & v2[None, :]
        if mask is not None:
            full = full & (mask if isinstance(mask, torch.Tensor) else mask.dense())
        admitted, valid_rows = int(full.sum()), int(v1.sum())
        del full
        ms_k = cuda_ms(torch, lambda: match.match_best2(d1, d2, v1, v2, mask, mutual), 50, True)
        ms_h = cuda_ms(torch, lambda: match.match_best2(d1, d2, v1, v2, mask, mutual), 50)
        ms_p = cuda_ms(torch, lambda: match.match_best2_plain(d1, d2, v1, v2, mask, mutual),
                       reps_plain)
        per_row = {match.WindowMask: 16, match.StereoMask: 12}.get(type(mask), 0)
        per_col = {match.WindowMask: 12, match.StereoMask: 16}.get(type(mask), 0)
        n_bytes = (N * (33 + per_row) + M * (33 + per_col) + 16 * N + (8 * M if mutual else 0)
                   + (N * M if isinstance(mask, torch.Tensor) else 0))
        b = bound(n_bytes, 8 * valid_rows * M + 10 * admitted, 8 * admitted)
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
        match_case("stereo, last frame", kl.desc, kr.desc, kl.valid, kr.valid,
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
        idx, best, second, _ = match.match_best2(
            d1, d2, v1, v2, match.WindowMask(uv1, radius, lvl1, uv2, lvl2))
        edge = (int(idx[5]), int(best[5]), int(second[5]), int(idx[7]), int(best[7]),
                int(idx[9]), int(best[9]))
        if edge != (0, 0, 0, 0, match.BIG, 0, match.BIG):
            return fail(f"match_best2 edge rows (tie, none admitted, invalid): {edge}")
        # (e) the call shapes of the triangulate=True run, on its own map: a
        # keyframe pair under its epipolar mask; the whole pool against a
        # frame (global tracking); a frame against the landmarks seen from
        # one keyframe, the pool as side 2 (relocalization)
        kf1c, kf2c = max(kf_a, 1), max(kf_a, 1) - 1
        gates = triangulation.pair_gates(m2, kf1c, kf2c, slam2.cam, slam2.sigma2)
        rows["match_best2/epipolar"] = match_case(
            "dense epipolar mask, keyframe pair", m2.kf_desc[kf1c], m2.kf_desc[kf2c],
            gates.unm1, gates.unm2, gates.epi, True)
        rows["match_best2/global"] = match_case(
            "no mask, landmark pool x frame", m2.lm_desc, frame_c.desc, m2.lm_valid,
            frame_c.valid, None, True)
        seen = torch.any(m2.lm_obs_kf == kf1c, dim=1) & m2.lm_valid
        # the kernel's own shape there is a frame against one column chunk of
        # the pool: the row times the chunk that holds the most of the
        # keyframe's landmarks; the whole call (all chunks, merged per row by
        # tensor operations the host enqueues) is held exact and timed beside it
        step = -(-m2.L // chunks)
        c0 = step * max(range(chunks), key=lambda c: int(seen[c * step:(c + 1) * step].sum()))
        c1 = min(c0 + step, m2.L)
        rows["match_best2/reloc"] = match_case(
            f"no mask, frame x column chunk [{c0}:{c1}] of the pool, landmarks of keyframe {kf1c}",
            frame_c.desc, m2.lm_desc[c0:c1], frame_c.valid, seen[c0:c1], None, True)
        match_case(f"no mask, frame x whole pool, landmarks of keyframe {kf1c} ({chunks} chunk "
                   f"launches and their merge)", frame_c.desc, m2.lm_desc, frame_c.valid, seen,
                   None, True)
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
    for name in ("match_best2", "match_best2/epipolar", "match_best2/global",
                 "match_best2/reloc", "match_best2/loop"):
        rows[name].update(source="tc2li_slam_torch/csrc/match.cu",
                          replaces="tc2li_slam_tpu/ops/matching.py:62", max_abs_err=0.0)

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
                                   + LBA_OPS_LANDMARK * L_ + 2 * Df ** 3 / 3 + 3 * Df ** 2))
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
        print(f"{tag} balm_quadratic {name}, V {V_}, W {W_}, {n_vox} valid voxels: kernel "
              f"{ms_k:.4f} ms on the device, bound {b_q[0]:.6f} ms ({b_q[1]}), plain "
              f"{ms_p:.4f} ms", flush=True)
    # the row: the planar window (the main path's shapes, V 512 and W 6)
    rows["balm_quadratic"] = dict(
        source="tc2li_slam_torch/csrc/balm.cu", replaces="tc2li_slam_tpu/solver/balm.py:303",
        max_abs_err=quad_err, ms=ms_k, plain_ms=ms_p, bound_ms=b_q[0], bound_by=b_q[1])

    # --- 6. result -------------------------------------------------------------
    kernels = []
    for name in ("orb_level_planes", "fast_score_planes", "fast_nms_planes", "orb_select_grid",
                 "orb_describe", "hamming_matrix", "match_best2",
                 "match_best2/epipolar", "match_best2/global", "match_best2/reloc",
                 "match_best2/loop", "pose_only_lm", "balm_quadratic", "local_ba_lm"):
        r = rows[name]
        kernels.append({"name": name, "route": "cuda", "source": r["source"],
                        "replaces": r["replaces"], "launches": launches[name],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"], "library_ms": r.get("library_ms"),
                        "launches_imu_mode": imu_launches.get(name, 0)})
    print(f"chip_smoke: {time.perf_counter() - t_script:.1f} s in all", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
