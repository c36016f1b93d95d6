#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``tc2li_slam_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each fatal on failure (non-zero exit, no result line):

1. require a CUDA device; print the card (nvidia-smi name, power limit),
   torch and CUDA versions;
2. build the CUDA kernels from ``tc2li_slam_torch/csrc`` (timed);
3. each kernel against its plain PyTorch version on the card, at the main
   path's shapes (FAST on the 8 pyramid levels of a 1241x376 frame, Hamming
   at 2000x2000 and 32768x2000): exact equality, and CUDA-event times;
4. the STEREO_LIDAR slice: 20 KITTI-shaped synthetic frames (1241x376
   stereo, 2000 ORB features over 8 levels, 131072-point scans decimated
   1-in-4) through ``System(cfg, cuda).track``, with the kernel launch
   counters reset just before and read just after; checks tracking state,
   keyframes, a BALM local-BA pass, the voxel map, finite poses, the launch
   counts and the ATE against ground truth (< 0.5 m);
5. one JSON line of kernel rows, the nvidia-smi line, and last the result
   line {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

N_FRAMES = 20
N_WARM = 5          # frames before the steady-state timing window
ATE_BOUND_M = 0.5


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


def cuda_ms(torch, fn, reps: int) -> float:
    """Mean CUDA-event time of ``fn`` over ``reps`` calls after one warm-up."""
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / reps


def kitti_config(cfg_mod, syn):
    """bench.py's KITTI-shaped STEREO_LIDAR configuration, triangulation off."""
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
            local_window=6, ba_iters=6, triangulate=False),
    )


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is false: this smoke run needs a CUDA card")
    root = Path(__file__).resolve().parent
    if not (root / "tc2li_slam_torch" / "csrc").is_dir():
        return fail(f"no tc2li_slam_torch package beside {__file__}")
    sys.path.insert(0, str(root))
    import numpy as np

    from tc2li_slam_torch.io import synthetic as syn
    from tc2li_slam_torch.ops import orb
    from tc2li_slam_torch.ops.kernels import build, fast, hamming
    from tc2li_slam_torch.slam import config as cfg_mod, system as sys_mod

    dev = torch.device("cuda")
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {smi}", flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {kind}, "
          f"{torch.cuda.device_count()} device(s)", flush=True)

    # --- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    lib_path = build.build()
    build.library()
    print(f"kernels built in {time.perf_counter() - t0:.2f} s -> {lib_path.name}", flush=True)
    if build.ptxas_log:
        print(build.ptxas_log.strip(), flush=True)

    # --- data (needed by the FAST check and the slice) ---------------------
    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    world = syn.make_world(rng, n_surf=300_000)
    frames, _, _ = syn.generate_sequence(
        n_frames=N_FRAMES, cam=syn.KITTI_LIKE, seed=0, n_scan=1 << 17, world=world,
        traj=syn.Trajectory(w_body=(0, 0, 0.03), v_world=(1.5, 0.1, 0.0)))
    scans = [np.where(fr.scan_valid[:, None], fr.scan, 0.0)[::4].astype(np.float32)
             for fr in frames]
    imgs = [(np.clip(fr.img_l, 0, 255).astype(np.uint8),
             np.clip(fr.img_r, 0, 255).astype(np.uint8)) for fr in frames]
    print(f"generated {N_FRAMES} KITTI-shaped frames in {time.perf_counter() - t0:.1f} s "
          f"(scan {scans[0].shape[0]} points)", flush=True)

    # --- 3. kernels vs plain versions --------------------------------------
    rows = {}
    img0 = torch.as_tensor(imgs[0][0]).to(dev).to(torch.float32)
    levels = orb.pyramid(img0, 8, 1.2)
    err = 0.0
    for lvl, li in enumerate(levels):
        got = fast.fast_score_raw(li)          # CUDA tensor: the kernel
        ref = fast.fast_score_raw_plain(li)
        torch.cuda.synchronize()
        e = float((got[3:-3, 3:-3] - ref[3:-3, 3:-3]).abs().max())
        ring_mask = torch.ones_like(got, dtype=torch.bool)
        ring_mask[3:-3, 3:-3] = False
        ring = float(got[ring_mask].abs().max())
        print(f"FAST level {lvl} {tuple(li.shape)}: max |kernel - plain| {e}, ring {ring}",
              flush=True)
        if e != 0.0 or ring != 0.0:
            return fail(f"FAST kernel disagrees with its plain version on level {lvl}")
        err = max(err, e)
    ms_k = cuda_ms(torch, lambda: [fast.fast_score_raw(li) for li in levels], 50)
    ms_p = cuda_ms(torch, lambda: [fast.fast_score_raw_plain(li) for li in levels], 10)
    print(f"FAST, 8 levels of one 1241x376 image: kernel {ms_k:.4f} ms, plain {ms_p:.4f} ms",
          flush=True)
    rows["fast"] = dict(name="fast_score", route="cuda", source="tc2li_slam_torch/csrc/fast.cu",
                        replaces="tc2li_slam_tpu/ops/kernels/fast.py:80",
                        max_abs_err=err, ms=ms_k, plain_ms=ms_p)

    g = torch.Generator(device=dev).manual_seed(0)
    ham_err = 0
    for n, m in ((2000, 2000), (32768, 2000)):
        a = torch.randint(-2 ** 31, 2 ** 31 - 1, (n, 8), generator=g, device=dev, dtype=torch.int32)
        b = torch.randint(-2 ** 31, 2 ** 31 - 1, (m, 8), generator=g, device=dev, dtype=torch.int32)
        got = hamming.hamming_matrix(a, b)
        ref = hamming.hamming_matrix_plain(a, b)
        torch.cuda.synchronize()
        e = int((got - ref).abs().max())
        if e != 0 or got.shape != (n, m):
            return fail(f"Hamming kernel disagrees with its plain version at {n}x{m}")
        ham_err = max(ham_err, e)
        ms_k = cuda_ms(torch, lambda: hamming.hamming_matrix(a, b), 50)
        ms_p = cuda_ms(torch, lambda: hamming.hamming_matrix_plain(a, b), 3)
        print(f"Hamming {n}x{m}: exact; kernel {ms_k:.4f} ms, plain {ms_p:.4f} ms", flush=True)
    rows["hamming"] = dict(name="hamming_matrix", route="cuda",
                           source="tc2li_slam_torch/csrc/hamming.cu",
                           replaces="tc2li_slam_tpu/ops/kernels/hamming.py:33",
                           max_abs_err=float(ham_err), ms=ms_k, plain_ms=ms_p)

    # --- 4. the slice --------------------------------------------------------
    cfg = kitti_config(cfg_mod, syn)
    slam = sys_mod.System(cfg, dev)
    gt = np.stack([fr.T_wb_gt @ syn.body_from_cam() for fr in frames])
    states = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fast.launches = 0
    hamming.launches = 0
    t_start = time.perf_counter()
    t_warm = None
    for i, fr in enumerate(frames):
        if i == N_WARM:
            torch.cuda.synchronize()
            slam.timers.reset()
            t_warm = time.perf_counter()
        slam.track(imgs[i][0], imgs[i][1], fr.t, scans[i])
        states.append(slam.state)
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    launches = {"fast": fast.launches, "hamming": hamming.launches}
    stats = slam.timers.stats()
    est = slam.trajectory_world_from_cam()
    ate = syn.ate_rmse(est, gt)
    n_kf = int(slam.map.n_kf)
    n_lm = int(slam.map.n_lm)
    vcount = int(slam.vmap.count)
    n_steady = N_FRAMES - N_WARM
    fps_all = N_FRAMES / (t_end - t_start)
    fps_steady = n_steady / (t_end - t_warm)
    print(f"[{kind} | {smi}] slice: {N_FRAMES} frames, ATE {ate:.4f} m, keyframes {n_kf}, "
          f"landmarks {n_lm}, voxel map {vcount} points, local BA passes {slam.n_ba} "
          f"({slam.n_ba_balm} with BALM)", flush=True)
    print(f"[{kind} | {smi}] frames/s: {fps_all:.3f} over all {N_FRAMES} frames, "
          f"{fps_steady:.3f} over frames {N_WARM}..{N_FRAMES - 1}; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    print(f"[{kind} | {smi}] device ms/frame by stage (CUDA events, frames "
          f"{N_WARM}..{N_FRAMES - 1}): "
          + json.dumps({k: round(v["total_ms"] / n_steady, 3) for k, v in stats.items()}),
          flush=True)
    print(f"kernel launches during the slice: {launches}", flush=True)

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
    if launches["fast"] != 16 * N_FRAMES:
        return fail(f"FAST launches {launches['fast']} != 16 x {N_FRAMES}")
    if launches["hamming"] <= 0:
        return fail("no Hamming kernel launch in the slice")
    if not ate < ATE_BOUND_M:
        return fail(f"ATE {ate:.4f} m >= {ATE_BOUND_M} m")

    kernels = []
    for key in ("fast", "hamming"):
        r = rows[key]
        kernels.append({"name": r["name"], "route": r["route"], "source": r["source"],
                        "replaces": r["replaces"], "launches": launches[key],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"]})
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
