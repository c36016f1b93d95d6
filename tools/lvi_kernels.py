#!/usr/bin/env python3
"""Time the LVI-BA's kernel sequence (``csrc/lvi_ba.cu``, ``lvi_ba_lm``) on
one CUDA card, for one or several checkouts in turns.

    python3 tools/lvi_kernels.py [--tree DIR ...] [--out DIR]

For each tree (default: this checkout; ``--tree A --tree B --tree B --tree
A`` compares two in turns on one card) a child process imports that tree's
``tc2li_slam_torch``, builds its kernels and measures on
``chip_smoke.lvi_problem``'s windows (this checkout's helpers): 4e's shape
(P 6, 8192 landmarks, K 8, the BALM term over 4 states, 6 iterations) and
the FullInertialBA's (P 20, 8192 landmarks, K 8, no BALM, 10 iterations):

- the call's device ms behind a device backlog (``chip_smoke.cuda_ms``);
- device ms a call by kernel name from ``torch.profiler``
  (``chip_smoke.kernel_split``), and the sum over ``csrc/lvi_ba.cu``'s six;
- the call's host ms (to its synchronize, the median of 20 calls)
  and device events a call;
- the bound (``chip_smoke.lvi_bound``) and the plain version's ms;
- the agreement with the plain version (``chip_smoke.lvi_agreement``, the
  plain version in float64 on the host).

Prints one JSON object a tree, with the card's name and power limit, and
writes them to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def measure(tree: Path) -> dict:
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs   # (this checkout's helpers)
    sys.path.insert(0, str(tree))
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from tc2li_slam_torch.ops.kernels import build, lvi_ba as klvi
    from tc2li_slam_torch.solver import inertial_ba as iba

    dev = torch.device("cuda")
    build.library()
    res = {"card": cs.nvidia_smi_line(), "tree": str(tree),
           "package": str(Path(klvi.__file__).resolve().parents[2])}
    for label, case in (("4e shape, P 6", "4e-like"), ("FullInertialBA, P 20", "full_inertial")):
        a, kw = cs.lvi_args(torch, cs.lvi_problem(np.random.default_rng(20), case, L=8192), dev)
        fn = lambda: iba.lvi_ba(*a, **kw)
        got, ref = fn(), klvi.lvi_ba_plain(*a, **kw)
        a64, kw64 = cs.lvi_cpu64(torch, a, kw)
        agr = cs.lvi_agreement(torch, a, got, ref, klvi.lvi_ba_plain(*a64, **kw64))
        ms = cs.cuda_ms(torch, fn, 20, True)
        split = cs.kernel_split(torch, fn, 5)
        host = []
        for _ in range(20):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            host.append(1e3 * (time.perf_counter() - t0))
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        n_events = sum(1 for e in prof.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA)
        b, n_live, n_pairs, Df = cs.lvi_bound(torch, a, kw)
        res[label] = {
            "ms": ms, "kernels_ms": sum(v["ms_a_call"] for k, v in split.items()
                                        if k in cs.LVI_KERNELS),
            "call_device_ms": sum(v["ms_a_call"] for v in split.values()),
            "by_kernel": {k: [v["launches_a_call"], round(v["ms_a_call"], 4)]
                          for k, v in split.items()},
            "host_ms_median": float(np.median(host)), "device_events": n_events,
            "bound_ms": b[0], "bound_by": b[1], "plain_ms": cs.cuda_ms(
                torch, lambda: klvi.lvi_ba_plain(*a, **kw), 3),
            "live": n_live, "pairs": n_pairs, "free_rows": Df,
            "launches": klvi.launches_per_call(kw["iters"]),
            "agreement": {k: v for k, v in agr.items() if k != "vs_float64"}}
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", action="append", default=None,
                    help="a checkout whose tc2li_slam_torch to time (repeatable)")
    ap.add_argument("--out", default=str(ROOT / "build" / "lvi_kernels"))
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
        (out / f"lvi_{i}.json").write_text(json.dumps(r, indent=1))
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
