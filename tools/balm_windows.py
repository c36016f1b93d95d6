#!/usr/bin/env python3
"""``local_ba_lm`` on many BALM windows against its plain version and the
plain version run in float64, on one card.

    python3 tools/balm_windows.py [--first 3] [--last 14]

For each seed it draws ``chip_smoke.ba_problem(rng, "balm")`` (4 poses, 400
landmarks, the clusters of ``planar_window`` built on the card), runs the
kernel twice, the plain version in float32 and in float64, and prints one
JSON line: the seed, whether the second call gave the same bits, and
``chip_smoke.ba_outside``'s counts and largest distances for the poses, the
landmarks and the cost. The last line names the card and its power limit.
Exits 1 if a window has a pose, landmark or cost outside both of
``ba_outside``'s rules, or a second call with other bits."""

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


if __name__ == "__main__":
    sys.exit(main())
