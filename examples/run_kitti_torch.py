"""Run the PyTorch port of the SLAM system on a KITTI odometry sequence
(the counterpart of ``examples/run_kitti.py``, which runs the JAX package).

The app layer the reference implements as ROS nodes
(``src/examples/camera_lidar.cc`` / ``camera_lidar_inertial.cc``: subscribe
topics -> System::TrackStereoLidar -> SaveTrajectoryKITTI): here it reads the
odometry benchmark layout directly (no rosbags), prefetches velodyne scans on
native threads, tracks every frame, writes KITTI- and TUM-format
trajectories, and evaluates ATE/RPE against ground truth when available.
The last line of the standard output is one JSON object with the result;
the stage timings go to the standard error.

    python examples/run_kitti_torch.py --root /data/kitti_odometry --seq 04 \
        --out results/04 [--frames N] [--no-lidar] [--device cuda]

``--device`` defaults to ``cuda`` and the run fails without a card; pass
``--device cpu`` to run on the host (slow; what the tests do).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def build_config(calib, args):
    from tc2li_slam_torch.slam import config as cfg_mod

    kw = {}
    if args.imu_dir:
        # KITTI raw oxts IMU; noise densities follow the reference's
        # Camera-Inertial-Lidar configs (KITTI04-12.yaml:50-55)
        kw.update(
            use_imu=True,
            inertial_ba=True,
            imu=cfg_mod.ImuConfig(
                noise_gyro=1.7e-4, noise_acc=2.0e-3,
                gyro_walk=1.9e-5, acc_walk=3.0e-3,
                T_bc=np.asarray(calib.T_cam_velo) @ np.asarray(args_T_velo_imu(args)),
            ),
        )
    # camera-from-lidar: calib.txt's Tr is velo->cam0
    return cfg_mod.SystemConfig(
        camera=cfg_mod.CameraConfig(
            fx=calib.fx, fy=calib.fy, cx=calib.cx, cy=calib.cy,
            baseline=calib.baseline, th_depth=35.0 * calib.baseline,
        ),
        orb=cfg_mod.OrbConfig(n_features=args.features, n_levels=8),
        lidar=cfg_mod.LidarConfig(
            enabled=not args.no_lidar, map_capacity=1 << 19, kf_points=2048,
            balm_max_voxels=512, scan_voxel=0.5, map_voxel=0.5, blind=2.0,
            det_range=100.0, w_lba=args.w_lba, T_cl=calib.T_cam_velo,
        ),
        tracking=cfg_mod.TrackingConfig(
            max_kf=args.max_kf, max_lm=1 << 15, max_obs=8,
            kf_max_interval=5, local_window=6, ba_iters=6,
        ),
        loop_closing=args.loop_closing,
        profile=True,
        **kw,
    )


def args_T_velo_imu(args):
    """IMU(body)-from-velodyne extrinsic: KITTI raw calib_imu_to_velo when
    provided, else the nominal rig offset (the reference hard-codes the
    equivalent in its launch params, config/kitti.yaml extrinsic_T/R)."""
    if args.imu_calib and os.path.exists(args.imu_calib):
        vals = {}
        with open(args.imu_calib) as f:
            for line in f:
                if ":" in line:
                    k, v = line.split(":", 1)
                    vals[k.strip()] = np.fromstring(v, sep=" ")
        T = np.eye(4, dtype=np.float64)
        T[:3, :3] = vals["R"].reshape(3, 3)
        T[:3, 3] = vals["T"]
        return np.linalg.inv(T)  # file stores imu->velo
    T = np.eye(4)
    T[:3, 3] = (-0.81, 0.32, 0.8)  # nominal KITTI imu<-velo offset
    return T


def load_oxts_imu(imu_dir: str):
    """KITTI raw oxts -> (timestamps [M], gyro [M, 3], acc [M, 3]).

    Reads ``oxts/timestamps.txt`` + ``oxts/data/*.txt``; uses the body-frame
    rates (wx, wy, wz; fields 17-19) and accelerations (ax, ay, az; fields
    11-13) — the same signals the reference's imu_cbk consumes."""
    import datetime

    ts_file = os.path.join(imu_dir, "timestamps.txt")
    times = []
    with open(ts_file) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            dt = datetime.datetime.fromisoformat(line[:26])
            times.append(dt.timestamp())
    data_dir = os.path.join(imu_dir, "data")
    names = sorted(os.listdir(data_dir))
    gyro, acc = [], []
    for name in names:
        v = np.loadtxt(os.path.join(data_dir, name))
        acc.append(v[11:14])
        gyro.append(v[17:20])
    n = min(len(times), len(names))
    return (np.asarray(times[:n]) - times[0], np.asarray(gyro[:n]),
            np.asarray(acc[:n]))


def imu_window(imu, t0, t1, cap=64):
    """Samples with t0 < t <= t1 as fixed-shape (gyro, acc, dts, trel)."""
    times, gyro, acc = imu
    sel = np.where((times > t0) & (times <= t1))[0][:cap]
    g = np.zeros((cap, 3), np.float32)
    a = np.zeros((cap, 3), np.float32)
    d = np.zeros(cap, np.float32)
    tr = np.zeros(cap, np.float32)
    prev = t0
    for j, i in enumerate(sel):
        g[j] = gyro[i]
        a[j] = acc[i]
        d[j] = times[i] - prev
        tr[j] = times[i] - t0
        prev = times[i]
    return g, a, d, tr


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", required=True, help="KITTI odometry root")
    ap.add_argument("--seq", required=True, help="sequence id, e.g. 04")
    ap.add_argument("--out", default="results", help="output directory")
    ap.add_argument("--frames", type=int, default=0, help="frame limit (0=all)")
    ap.add_argument("--features", type=int, default=2000)
    ap.add_argument("--max-kf", type=int, default=2048)
    ap.add_argument("--w-lba", type=float, default=0.01)
    ap.add_argument("--no-lidar", action="store_true")
    ap.add_argument("--n-scan", type=int, default=1 << 17)
    ap.add_argument("--device", default="cuda",
                    help="torch device of every pool and kernel (cuda, cuda:1, cpu)")
    ap.add_argument("--voc", default=None,
                    help="ORBvoc.txt path (enables relocalization + place "
                         "recognition; required for --loop-closing)")
    ap.add_argument("--loop-closing", action="store_true",
                    help="enable loop detection + Sim3 pose-graph correction "
                         "(the 00-02 configs; needs --voc)")
    ap.add_argument("--imu-dir", default=None,
                    help="KITTI raw oxts directory (timestamps.txt + data/) "
                         "-> IMU_STEREO_LIDAR mode (the 04-12 CIL configs)")
    ap.add_argument("--imu-calib", default=None,
                    help="KITTI raw calib_imu_to_velo.txt (else nominal rig)")
    args = ap.parse_args(argv)
    if args.loop_closing and not args.voc:
        ap.error("--loop-closing requires --voc")

    import torch

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print(f"--device {args.device}: no CUDA device is available "
              "(pass --device cpu to run on the host)", file=sys.stderr)
        return 2

    from tc2li_slam_torch.io import kitti, native
    from tc2li_slam_torch.ops import bow
    from tc2li_slam_torch.slam import evaluate, system as sys_mod

    seq = kitti.KittiSequence(args.root, args.seq, n_scan=args.n_scan)
    cfg = build_config(seq.calib, args)
    voc = bow.load_orbvoc_txt(args.voc, device) if args.voc else None
    imu = load_oxts_imu(args.imu_dir) if args.imu_dir else None
    slam = sys_mod.System(cfg, device, voc=voc)

    n = len(seq) if args.frames <= 0 else min(args.frames, len(seq))
    scan_paths = [
        os.path.join(seq.seq_dir, "velodyne", f"{i:06d}.bin") for i in range(n)
    ]
    pre = native.ScanPrefetcher(scan_paths, n_max=args.n_scan)

    t0 = time.perf_counter()
    for i in range(n):
        img_l = kitti.load_image(seq.seq_dir, 0, i)
        img_r = kitti.load_image(seq.seq_dir, 1, i)
        if cfg.lidar.enabled:
            scan, stimes, svalid, _ = pre.get(i)
        else:
            scan = stimes = svalid = None
        t_i = float(seq.times[i])
        if imu is not None:
            t_prev = float(seq.times[i - 1]) if i > 0 else t_i - 0.1
            g, a, d, tr = imu_window(imu, t_prev, t_i)
            slam.track(img_l, img_r, t_i, scan, svalid,
                       gyro=g, acc=a, imu_dts=d, imu_trel=tr,
                       scan_times=stimes)
        else:
            slam.track(img_l, img_r, t_i, scan, svalid)
        if i % 100 == 0:
            print(f"frame {i}/{n} state={slam.state} kf={slam.n_kf_host}",
                  file=sys.stderr)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    pre.close()

    os.makedirs(args.out, exist_ok=True)
    kitti_path = os.path.join(args.out, f"{args.seq}.txt")
    tum_path = os.path.join(args.out, f"{args.seq}_tum.txt")
    slam.save_trajectory_kitti(kitti_path)
    slam.save_trajectory_tum(tum_path)

    result = {
        "seq": args.seq, "frames": n, "fps": round(n / wall, 3),
        "keyframes": slam.n_kf_host, "trajectory": kitti_path,
    }
    if seq.gt is not None:
        est = slam.trajectory_world_from_cam()
        gt = seq.gt[:n]
        ev = evaluate.evaluate(est, gt)
        result["ate_rmse_m"] = round(ev["ate_rmse_m"], 4)
        result["kitti_t_err_pct"] = round(ev["kitti_t_err_pct"], 3)
        result["kitti_r_err_deg_per_m"] = round(ev["kitti_r_err_deg_per_m"], 5)
    print(json.dumps(slam.timers.stats()), file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
