#!/usr/bin/env python3
"""``local_ba_lm`` on many BALM windows against its plain version and the
plain version run in float64, on one card.

    python3 tools/balm_windows.py [--first 3] [--last 14]
    python3 tools/balm_windows.py --trace SEED

For each seed it draws ``chip_smoke.ba_problem(rng, "balm")`` (4 poses, 400
landmarks, the clusters of ``planar_window`` built on the card), runs the
kernel twice, the plain version in float32 and in float64, and prints one
JSON line: the seed, whether the second call gave the same bits, and
``chip_smoke.ba_outside``'s counts and largest distances for the poses, the
landmarks and the cost. The last line names the card and its power limit.
Exits 1 if a window has a pose, landmark or cost outside both of
``ba_outside``'s rules, or a second call with other bits.

``--trace SEED`` prints that one window's LM iterations instead, one JSON
line each: for the kernel, the float32 plain version and the float64 plain
version side by side, the candidate's cost, the cost after the decision,
``lam`` and whether the step was accepted; then the first iteration at
which the three do not take the same decision, and ``ba_outside``."""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--first", type=int, default=3)
    ap.add_argument("--last", type=int, default=14)
    ap.add_argument("--trace", type=int, default=None, metavar="SEED",
                    help="print one window's iterations for the three runs")
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from tc2li_slam_torch.ops.kernels import local_ba as klba

    cuda = torch.device("cuda")
    bits = lambda x: x.view(torch.int32) if x.dtype == torch.float32 else x
    if args.trace is not None:
        return trace(torch, np, chip_smoke, klba, args.trace, cuda)
    bad = 0
    for seed in range(args.first, args.last + 1):
        p = chip_smoke.ba_problem(np.random.default_rng(seed), "balm")
        a, kw = chip_smoke.ba_torch(torch, p, cuda)
        got = klba.local_ba_lm(*a, **kw)
        again = klba.local_ba_lm(*a, **kw)
        ref = klba.local_ba_plain(*a, **kw)
        a64, kw64 = chip_smoke.ba_float64(torch, a, kw)
        ref64 = klba.local_ba_plain(*a64, **kw64)
        torch.cuda.synchronize()
        out = chip_smoke.ba_outside(torch, got, ref, ref64)
        same = all(torch.equal(bits(x), bits(y)) for x, y in zip(got, again))
        bad += (not same) or any(v["outside"] for v in out.values())
        print(json.dumps({"seed": seed, "same_bits": same, **out}), flush=True)
    print(chip_smoke.nvidia_smi_line())
    return 1 if bad else 0


def trace(torch, np, chip_smoke, klba, seed: int, cuda) -> int:
    p = chip_smoke.ba_problem(np.random.default_rng(seed), "balm")
    a, kw = chip_smoke.ba_torch(torch, p, cuda)
    tk = torch.zeros((kw["iters"], 4), dtype=torch.float64, device=cuda)
    got = klba.local_ba_lm(*a, **kw, trace=tk)
    t32, t64 = [], []
    ref = klba.local_ba_plain(*a, **kw, trace=t32)
    a64, kw64 = chip_smoke.ba_float64(torch, a, kw)
    ref64 = klba.local_ba_plain(*a64, **kw64, trace=t64)
    torch.cuda.synchronize()
    runs = {"kernel": tk.tolist(), "plain_f32": [x.tolist() for x in t32],
            "plain_f64": [x.tolist() for x in t64]}
    first = None
    for it in range(kw["iters"]):
        row = {name: dict(zip(("candidate", "cost", "lam", "accepted"), r[it]))
               for name, r in runs.items()}
        for r in row.values():
            r["accepted"] = bool(r["accepted"])
        print(json.dumps({"seed": seed, "iteration": it, **row}), flush=True)
        if first is None and len({r["accepted"] for r in row.values()}) > 1:
            first = it
    print(json.dumps({"seed": seed, "first_iteration_apart": first,
                      **chip_smoke.ba_outside(torch, got, ref, ref64)}), flush=True)
    print(chip_smoke.nvidia_smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
