#!/usr/bin/env python3
"""Where the IMU mode's two kernels spend their time, on one CUDA card, for
one or several checkouts in turns.

    python3 tools/vi_kernels.py [--tree DIR ...] [--out DIR]

For each tree (default: this checkout; ``--tree A --tree B --tree B --tree
A`` compares two in turns on one card) a child process imports that tree's
``tc2li_slam_torch``, builds its kernels and measures:

- ``pose_inertial_lm`` (``csrc/pose_inertial.cu``) on ``chip_smoke.vi_problem``
  frames at 15 and 30 free dims and O 3 and 2000 rows, device ms a call
  behind a device backlog (``chip_smoke.cuda_ms``) at (rounds, iters) =
  (0, 0), (2, 0) and (2, 6): the differences give the fixed part (the
  constants, C9's inverse, one evaluation and, at 30 dims, the Schur step),
  an evaluation (a pass over the rows with the IMU and prior terms) and a
  step (the damped solve and the update); O 3 against 2000 gives the rows'
  share;
- ``imu_preintegrate`` (``csrc/imu_preint.cu``) at N 10, 60, 100, 1000 and
  1024: device ms a call and us a sample;
- where the tree builds a lapped library (``build.variant("-DTC2LI_LAPS")``:
  ``csrc/laps.cuh``, empty in the main build), the phase split: one call
  each through that library at 2 rounds of 6 iterations and at N 60 and
  1024, cycles a call by phase (thread 0 of block 0) and each phase's share.
  ``pose_inertial_lm``: the fixed part, C9's inverse (warp 0), the rows
  (with the IMU and prior terms' one-thread chains beside them), the
  cluster barrier and the slots' sum, the Jacobians' entries, the
  products, the factor (with the step's scaling), the solves and the
  update, the Schur step and the output. ``imu_preintegrate``: the
  compaction, the per-sample terms, the chunk chains, the block's tree
  joins, the cluster's joins, the output.

Prints one JSON object a tree, with the card's name and power limit, and
writes them to ``--out``.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
LAPS = {"pose_inertial": {0: "fixed part", 1: "C9 inverse (warp 0)",
                          2: "rows, beside the IMU and prior terms' chains",
                          3: "cluster barrier and sum",
                          4: "Jacobian entries, I r and Hw rp",
                          5: "products", 6: "factor", 7: "solves and update",
                          8: "Schur and output"},
        "imu_preint": {0: "compaction", 1: "per-sample terms", 2: "chunk chains",
                       3: "block tree joins", 4: "cluster tree joins", 5: "output"}}
N_SLOTS = 64   # laps.cuh kLapSlots


def measure(tree: Path) -> dict:
    sys.path.insert(0, str(tree))
    import numpy as np
    import torch

    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import tc2li_slam_torch
    from tc2li_slam_torch.estimation import imu
    from tc2li_slam_torch.ops.kernels import build, imu_preint as kimu, pose_inertial as kpi

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    build.library()
    dev = torch.device("cuda")
    res = {"tree": str(Path(tc2li_slam_torch.__file__).resolve().parents[1]),
           "card": cs.nvidia_smi_line(), "pose_inertial_lm": {}, "imu_preintegrate": {}}
    csrc = Path(tc2li_slam_torch.__file__).resolve().parent / "csrc"
    lapped = (build.variant("-DTC2LI_LAPS")
              if hasattr(build, "variant") and (csrc / "laps.cuh").exists() else None)

    def laps(tag, fn):
        """cycles a call by phase through the lapped library"""
        buf = (ctypes.c_longlong * (2 * N_SLOTS))()
        with build.routed_to(lapped):
            fn()
            torch.cuda.synchronize()
            getattr(lapped, f"tc2li_laps_reset_{tag}")()
            fn()
            torch.cuda.synchronize()
            getattr(lapped, f"tc2li_laps_read_{tag}")(buf)
        names = LAPS[tag]
        tot = sum(buf[k] for k in names)
        return {"total cycles": tot, **{
            v: {"cycles": buf[k], "laps": buf[N_SLOTS + k], "share": buf[k] / max(tot, 1)}
            for k, v in names.items() if buf[N_SLOTS + k]}}

    for nf in (15, 30):
        for O in (3, 2000):
            p = cs.vi_problem(np.random.default_rng(1), O, nf)
            _, a = cs.vi_args(torch, p, dev)
            prior, rest = (a[4], a[5:]) if nf == 30 else (None, a[4:])
            call = lambda r, it: kpi.pose_inertial_lm(*a[:4], prior, *rest, r, it)
            ms = {f"{r},{it}": cs.cuda_ms(torch, lambda r=r, it=it: call(r, it), 30, True)
                  for r, it in ((0, 0), (2, 0), (2, 6))}
            ev = (ms["2,0"] - ms["0,0"]) / 2
            row = {"ms a call at rounds,iters": ms, "evaluation us": 1e3 * ev,
                   "step us": 1e3 * ((ms["2,6"] - ms["2,0"]) / 12 - ev),
                   "fixed part us": 1e3 * (ms["0,0"] - ev)}
            if lapped is not None and O == 2000:
                row["phases"] = laps("pose_inertial", lambda: call(2, 6))
            res["pose_inertial_lm"][f"{nf} dims, O {O}"] = row
            print(f"pose_inertial_lm {nf} dims O {O}: {json.dumps(row)}", file=sys.stderr,
                  flush=True)
    cal = imu.ImuCalib.create(*cs.VI_CALIB, device=dev)
    rng = np.random.default_rng(0)
    z = torch.zeros(3, device=dev)
    for N in (10, 60, 100, 1000, 1024):
        g = torch.as_tensor(rng.normal(0, 0.1, (N, 3)), dtype=torch.float32, device=dev)
        acc = torch.as_tensor(rng.normal(0, 1, (N, 3)), dtype=torch.float32, device=dev)
        d = torch.full((N,), 0.01, device=dev)
        fn = lambda: kimu.imu_preintegrate(cal, g, acc, d, z, z)
        ms = cs.cuda_ms(torch, fn, 50, True)
        row = {"ms a call": ms, "us a sample": 1e3 * ms / N}
        if lapped is not None and N in (60, 1024):
            row["phases"] = laps("imu_preint", fn)
        res["imu_preintegrate"][f"N {N}"] = row
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", action="append", default=None,
                    help="a checkout whose tc2li_slam_torch to time (repeatable)")
    ap.add_argument("--out", default=str(ROOT / "build" / "vi_kernels"))
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args()
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    if args.child:
        print(json.dumps(measure(Path(args.child).resolve())), flush=True)
        return 0
    for i, tree in enumerate(args.tree or [str(ROOT)]):
        res = subprocess.run([sys.executable, __file__, "--out", str(out), "--child", tree],
                             capture_output=True, text=True, timeout=1200)
        if res.returncode != 0:
            print(res.stdout[-4000:], res.stderr[-8000:], file=sys.stderr)
            return 1
        r = json.loads(res.stdout.strip().splitlines()[-1])
        (out / f"vi_{i}.json").write_text(json.dumps(r, indent=1))
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
