#!/usr/bin/env python3
"""Time the pose graph's Gauss-Newton (``solver.sim3.pose_graph_optimize``:
``csrc/pose_graph.cu`` on the card, eager torch in a tree without it) on
one CUDA card, for one or several checkouts in turns.

    python3 tools/pose_graph_kernels.py [--tree DIR ...] [--cases PATH] [--large] [--out DIR]

For each tree (default: this checkout; ``--tree A --tree B --tree B --tree
A`` compares two in turns on one card) a child process imports that tree's
``tc2li_slam_torch``, builds its kernels and measures on these calls (this
checkout's ``chip_smoke`` helpers make them):

- 4f's closure, the arguments ``close_loop`` handed the optimizer
  (``chip_smoke.py`` saves them to ``build/pose_graph_4f.pt``; without the
  file, ``pose_graph_problem``'s covisibility graph at K 49), and the same
  call padded with fixed slots to the 256 of ``max_kf`` (what a
  ``close_loop`` that hands over every slot, as before the kernels, passed);
- ``pose_graph_problem``'s 400-keyframe graph (2,793 free rows, 15
  iterations), and with ``--large`` the 2,048-keyframe one (14,329 free rows,
  ``PG_ITERS_2048`` iterations).

For each: the call's device ms behind a device backlog (``chip_smoke.cuda_ms``),
device ms a call by kernel name from ``torch.profiler``
(``chip_smoke.kernel_split``, its window opened by ``PROFILE_LEAD`` spin
kernels; the ten largest), the device events and the host ms of one call
(the median of 5 calls to their synchronize), the launches the wrapper
counts, the bound (``chip_smoke.pose_graph_bound``) and the agreement with
the plain version run in float64. Prints one JSON object a tree, with the
card's name and power limit, and writes them to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def measure(tree: Path, cases_path: Path, large: bool) -> dict:
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs   # (this checkout's helpers)
    sys.path.insert(0, str(tree))
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from tc2li_slam_torch.ops.kernels import build
    from tc2li_slam_torch.solver import sim3

    try:
        from tc2li_slam_torch.ops.kernels import pose_graph as kpg
    except ImportError:   # a tree from before the kernels
        kpg = None
    dev = torch.device("cuda")
    build.library()
    res = {"card": cs.nvidia_smi_line(), "tree": str(tree), "kernels": kpg is not None,
           "package": str(Path(sim3.__file__).resolve().parents[1])}
    if cases_path.exists():
        saved = torch.load(cases_path)
        a4f = (saved["S_w"].to(dev), sim3.PoseGraphEdges(*(x.to(dev) for x in saved["edges"])),
               saved["fixed"].to(dev))
        kw4f = {"iters": saved["iters"]}
    else:
        a4f, kw4f = cs.pose_graph_args(torch, cs.pose_graph_problem(
            np.random.default_rng(26), "covisibility 400", K=49), dev)
    K4f, pad = a4f[0].shape[0], 256 - a4f[0].shape[0]
    eye = torch.eye(4, device=dev).expand(pad, 4, 4)
    a256 = (torch.cat([a4f[0], eye]), a4f[1],
            torch.cat([a4f[2], torch.ones(pad, dtype=torch.bool, device=dev)]))
    calls = [("4f's closure, K %d" % K4f, a4f, kw4f), ("4f's closure padded to K 256", a256, kw4f),
             ("covisibility 400",) + cs.pose_graph_args(torch, cs.pose_graph_problem(
                 np.random.default_rng(26), "covisibility 400"), dev)]
    if large:
        calls.append(("2048 keyframes",) + cs.pose_graph_args(torch, cs.pose_graph_problem(
            np.random.default_rng(26), "2048 keyframes"), dev))
    for label, a, kw in calls:
        fn = lambda: sim3.pose_graph_optimize(*a, **kw)
        got = fn()
        ref64 = sim3.pose_graph_optimize(*cs.pose_graph_cast(torch, a, torch.float64), **kw) \
            if kpg is None else kpg.pose_graph_plain(
                *cs.pose_graph_cast(torch, a, torch.float64), **kw)
        n0 = kpg.launches if kpg else 0
        ms = cs.cuda_ms(torch, fn, 3, True)
        n_launch = (kpg.launches - n0) / 4 if kpg else None
        split = cs.kernel_split(torch, fn, 2)
        host = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            host.append(1e3 * (time.perf_counter() - t0))
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(cs.PROFILE_LEAD):
                torch.cuda._sleep(1)
            torch.cuda.synchronize()
            fn()
            torch.cuda.synchronize()
        events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
                  and "spin_kernel" not in e.name]
        n_free = int((~a[2]).sum())
        b = cs.pose_graph_bound(a[0].shape[0], n_free, int(a[1].valid.sum()), kw["iters"])
        res[label] = {
            "ms": ms, "call_device_ms": sum(v["ms_a_call"] for v in split.values()),
            "by_kernel": {k: [v["launches_a_call"], round(v["ms_a_call"], 4)]
                          for k, v in list(split.items())[:10]},
            "device_events": len(events),
            "device_ms_one_call": sum(e.time_range.elapsed_us() for e in events) / 1e3,
            "host_ms_median": float(np.median(host)), "launches": n_launch,
            "launches_per_call": kpg.launches_per_call(a[0].shape[0], kw["iters"]) if kpg else None,
            "bound_ms": b[0], "bound_by": b[1], "K": a[0].shape[0], "free_rows": 7 * n_free,
            "edges": a[1].i.shape[0], "iters": kw["iters"],
            "vs_plain_float64": cs.pose_distance(torch, got, ref64)}
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", action="append", default=None,
                    help="a checkout whose tc2li_slam_torch to time (repeatable)")
    ap.add_argument("--cases", default=str(ROOT / "build" / "pose_graph_4f.pt"))
    ap.add_argument("--large", action="store_true", help="also the 2,048-keyframe graph")
    ap.add_argument("--out", default=str(ROOT / "build" / "pose_graph_kernels"))
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args()
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    if args.child:
        print(json.dumps(measure(Path(args.child).resolve(), Path(args.cases), args.large)),
              flush=True)
        return 0
    for i, tree in enumerate(args.tree or [str(ROOT)]):
        cmd = [sys.executable, __file__, "--out", str(out), "--cases", args.cases,
               "--child", tree] + (["--large"] if args.large else [])
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=1500)
        if res.returncode != 0:
            print(res.stdout[-4000:], res.stderr[-8000:], file=sys.stderr)
            return 1
        r = json.loads(res.stdout.strip().splitlines()[-1])
        (out / f"pose_graph_{i}.json").write_text(json.dumps(r, indent=1))
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
