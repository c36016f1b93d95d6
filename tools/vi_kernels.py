#!/usr/bin/env python3
"""Where the IMU mode's two kernels spend their time, on one CUDA card.

    python3 tools/vi_kernels.py [--tree DIR]

``pose_inertial_lm`` (``csrc/pose_inertial.cu``) on ``chip_smoke.vi_problem``
frames at 15 and 30 free dims and at O 3 and 2000 rows, with (rounds,
iters) = (0, 0), (2, 0) and (2, 6): the differences split a call into its
fixed part (the constants, C9's inverse, one evaluation and, at 30 dims,
the Schur step), an evaluation (a pass over the rows and the IMU and prior
terms) and a step (the damped solve and the update), and O 3 against 2000
gives the rows' share. ``imu_preintegrate`` (``csrc/imu_preint.cu``) at N
10, 100 and 1000 samples gives the chain's time a sample. Device ms a call
behind a device backlog (``chip_smoke.cuda_ms``), with the card's name and
power limit. ``--tree DIR`` imports ``tc2li_slam_torch`` from another
checkout.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=None,
                    help="import tc2li_slam_torch from this checkout (default: this one)")
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs   # (this checkout's helpers)
    if args.tree:
        sys.path.insert(0, str(Path(args.tree).resolve()))
    from tc2li_slam_torch.estimation import imu
    from tc2li_slam_torch.ops.kernels import build, imu_preint as kimu, pose_inertial as kpi

    build.build()
    build.library()
    print(cs.nvidia_smi_line(), flush=True)
    dev = torch.device("cuda")
    for nf in (15, 30):
        for O in (3, 2000):
            p = cs.vi_problem(np.random.default_rng(1), O, nf)
            _, a = cs.vi_args(torch, p, dev)
            prior, rest = (a[4], a[5:]) if nf == 30 else (None, a[4:])
            ms = {}
            for r, it in ((0, 0), (2, 0), (2, 6)):
                ms[r, it] = cs.cuda_ms(
                    torch, lambda: kpi.pose_inertial_lm(*a[:4], prior, *rest, r, it), 30, True)
            evaluation = (ms[2, 0] - ms[0, 0]) / 2
            step = (ms[2, 6] - ms[2, 0]) / 12 - evaluation
            print(f"pose_inertial_lm {nf} free dims, O {O}: ms a call at (rounds, iters) "
                  + ", ".join(f"{k} {v:.4f}" for k, v in ms.items())
                  + f"; an evaluation {1e3 * evaluation:.1f} us, a step {1e3 * step:.1f} us, "
                  f"the fixed part {1e3 * (ms[0, 0] - evaluation):.1f} us", flush=True)
    cal = imu.ImuCalib.create(*cs.VI_CALIB, device=dev)
    rng = np.random.default_rng(0)
    z = torch.zeros(3, device=dev)
    for N in (10, 100, 1000):
        g = torch.as_tensor(rng.normal(0, 0.1, (N, 3)), dtype=torch.float32, device=dev)
        acc = torch.as_tensor(rng.normal(0, 1, (N, 3)), dtype=torch.float32, device=dev)
        d = torch.full((N,), 0.01, device=dev)
        ms = cs.cuda_ms(torch, lambda: kimu.imu_preintegrate(cal, g, acc, d, z, z), 30, True)
        print(f"imu_preintegrate N {N}: {ms:.4f} ms, {1e3 * ms / N:.3f} us a sample", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
