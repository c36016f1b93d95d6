#!/usr/bin/env python3
"""How many device events ``torch.profiler`` leaves out of a window's record,
as the process ages, with and without ``chip_smoke.kernel_split``'s lead.

    python3 tools/profiler_loss.py [--rounds 7] [--gap 15]

Each round profiles five calls of ``inertial_init_gn`` on
``chip_smoke.init_problem``'s padded window, each call after a one-element
fill and add (15 device events a window), twice: alone, and after
``chip_smoke.PROFILE_LEAD`` spin kernels and a sync. It prints, a line a
window, the process's age, the spin kernels and the calls' events in the
record, and the record's last events in start order (S spin, F fill, A add,
K the kernel), so a loss at the head of the window shows as a short head.
Between rounds the card runs matrix products for ``--gap`` seconds. The
last line is one JSON object with the counts and the card's name and power
limit."""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=7)
    ap.add_argument("--gap", type=float, default=15.0)
    args = ap.parse_args()

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke
    from tc2li_slam_torch.ops.kernels import build
    from tc2li_slam_torch.solver import inertial_init as ii

    if not torch.cuda.is_available():
        print("profiler_loss: needs a CUDA device", file=sys.stderr)
        return 1
    card = chip_smoke.nvidia_smi_line()
    dev = torch.device("cuda")
    build.library()
    a, kw = chip_smoke.init_args(
        torch, chip_smoke.init_problem(np.random.default_rng(7), "4e-like padded"), dev)
    fn = lambda: ii.inertial_optimization(*a, **kw)
    x = torch.randn(2048, 2048, device=dev)
    t_start = time.perf_counter()
    tags = (("spin", "S"), ("inertial", "K"), ("ill", "F"), ("dd", "A"))

    def window(calls: int, lead: int) -> dict:
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(lead):
                torch.cuda._sleep(1)
            torch.cuda.synchronize()
            for _ in range(calls):
                torch.zeros(1, device=dev).add_(1)
                fn()
            torch.cuda.synchronize()
        names = [e.name for e in sorted(prof.events(), key=lambda e: e.time_range.start)
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        seq = "".join(next((t for k, t in tags if k in n), "?") for n in names)
        n_spin = seq.count("S")
        return dict(age_s=time.perf_counter() - t_start, lead=lead, spin_kept=n_spin,
                    calls_events_kept=len(seq) - n_spin, calls_events=3 * calls,
                    tail=seq[-24:])

    rows = []
    for _ in range(args.rounds):
        for lead in (0, chip_smoke.PROFILE_LEAD):
            r = window(5, lead)
            rows.append(r)
            print(f"[{card}] age {r['age_s']:.1f} s, lead {lead}: spin kernels kept "
                  f"{r['spin_kept']} of {lead}, the calls' events kept "
                  f"{r['calls_events_kept']} of {r['calls_events']}; record ends {r['tail']}",
                  flush=True)
        t_end = time.perf_counter() + args.gap
        while time.perf_counter() < t_end:
            for _ in range(50):
                x @ x
            torch.cuda.synchronize()
    print(json.dumps({"card": card, "windows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
