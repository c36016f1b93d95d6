#!/usr/bin/env python3
"""Device time of the two LM kernels, whole and split by launch, on one card.

    python3 tools/kernel_split.py [--tree DIR ...] [--out DIR]

For each tree (default: this checkout; several are run in the order given,
so ``--tree A --tree B --tree B --tree A`` compares two trees in turns on one
card) it imports that tree's ``tc2li_slam_torch`` in a child process, builds
its kernels, and times on full-width synthetic problems
(``chip_smoke.dist_problem``: 8192 landmarks, each seen from up to 8 poses):

- ``local_ba_lm`` at P 6 (6 iterations), at P 64 with 40 real poses and 24
  ``NO_KF``-style pads (8 iterations, the global BA's shape) and at P 64
  with 8 real poses: the whole call by CUDA events behind a device backlog
  (``chip_smoke.cuda_ms(..., backlog=True)``), and the device time of each
  kernel name a call from a ``torch.profiler`` trace of a few calls;
- ``pose_only_lm`` on ``chip_smoke.pose_problem``'s tracking case at N 2000
  (4 x 10, 45 passes) and N 5000: ms a call and ms a pass.

Prints one JSON object a tree, with the card's name and power limit, and
writes them to ``--out``."""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def measure(tree: Path) -> dict:
    sys.path.insert(0, str(tree))
    import numpy as np
    import torch

    # this checkout's chip_smoke (its helpers), the tree's package
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    from tc2li_slam_torch.geom import camera as cam_mod
    from tc2li_slam_torch.ops.kernels import local_ba as klba, pose_lm
    from tc2li_slam_torch.solver import lm

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    dev = torch.device("cuda")
    out = {"tree": str(tree), "card": chip_smoke.nvidia_smi_line(), "local_ba_lm": {},
           "pose_only_lm": {}}

    for label, Pn, P, iters in (("P 6", 6, 6, 6), ("P 64, 40 real", 40, 64, 8),
                                ("P 64, 8 real", 8, 64, 8)):
        cam, p = chip_smoke.dist_problem(torch, np.random.default_rng(1), Pn=Pn, L=8192, K=8)
        if P > Pn:
            p["T0"] = np.concatenate([p["T0"], np.tile(np.eye(4, dtype=np.float32),
                                                       (P - Pn, 1, 1))])
            p["fixed"] = np.concatenate([p["fixed"], np.ones(P - Pn, bool)])
        t = lambda k: torch.as_tensor(p[k]).to(dev)
        obs = lm.BAObservations(*(t(k) for k in ("pose_idx", "uv", "inv_sigma2", "stereo",
                                                   "valid")))
        args = (cam, t("T0"), t("X0"), obs, t("fixed"),
                torch.ones(8192, dtype=torch.bool, device=dev))
        call = lambda: klba.local_ba_lm(*args, iters=iters)
        ms = chip_smoke.cuda_ms(torch, call, 20 if P == 6 else 5, backlog=True)
        r1, r2 = call(), call()
        same = all(torch.equal(a, b) for a, b in zip(r1, r2))
        out["local_ba_lm"][label] = {
            "P": P, "free_poses": int((~args[4]).sum()), "iters": iters, "ms": ms,
            "same_bits_on_a_second_call": same,
            "split": chip_smoke.kernel_split(torch, call, 5)}

    for N in (2000, 5000):
        cam_args, a, kw = chip_smoke.pose_problem(np.random.default_rng(5), N, "tracking")
        cam = cam_mod.Pinhole.create(*cam_args)
        ts = [torch.as_tensor(x).to(dev) for x in a]
        call = lambda: pose_lm.pose_only_lm(cam, *ts, **kw)
        ms = chip_smoke.cuda_ms(torch, call, 50, backlog=True)
        passes = 1 + kw["rounds"] * (kw["iters"] + 1)
        out["pose_only_lm"][f"N {N}"] = {"rounds": kw["rounds"], "iters": kw["iters"],
                                         "passes": passes, "ms": ms, "ms_a_pass": ms / passes,
                                         "split": chip_smoke.kernel_split(torch, call, 10)}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", action="append", default=None,
                    help="a checkout whose tc2li_slam_torch to time (repeatable)")
    ap.add_argument("--out", default=str(ROOT / "build" / "split"))
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        print(json.dumps(measure(Path(args.child).resolve())), flush=True)
        return 0
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    results = []
    for i, tree in enumerate(args.tree or [str(ROOT)]):
        res = subprocess.run([sys.executable, __file__, "--child", tree], capture_output=True,
                             text=True, timeout=1200)
        if res.returncode != 0:
            print(res.stdout[-4000:], res.stderr[-8000:], file=sys.stderr)
            return 1
        r = json.loads(res.stdout.strip().splitlines()[-1])
        results.append(r)
        (out / f"split_{i}.json").write_text(json.dumps(r, indent=1))
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
