#!/usr/bin/env python3
"""Where ``match_best2`` (``csrc/match.cu``) spends its time on its window,
stereo, epipolar and dense call shapes, on one CUDA card, for one or
several checkouts in turns.

    python3 tools/match_kernels.py [--cases PATH] [--tree DIR ...] [--out DIR] [--times-only]

The cases are ``chip_smoke.py``'s own matches under a mask descriptor or
none, which it writes to ``build/match_cases.pt``
(``chip_smoke.save_match_cases``): the last frame's stereo pair, the
landmark pool projected into a keyframe, a full pool of 32,768 valid
landmarks, the edge rows (1,003 x 517, with and without the mutual test),
4a's keyframe pair under its epipolar gate, the dense worst case (2,000 x
2,000, every pair admitted) and the three unmasked shapes of 4a-4f: the
landmark pool against a frame (global tracking), a frame against the pool
with only one keyframe's landmarks valid (relocalization) and 4f's loop
keyframe pair (loop verification). Copy the file into ``proof/`` to reuse
it in a later chip call without running ``chip_smoke.py`` first. An
epipolar case runs as the tree's own route: an ``EpipolarMask`` where the
tree has one, else the dense mask the plain chain builds
(``chip_smoke.load_match_cases``); a case saved with its keypoints ``uv1`` and fundamental matrix ``F12`` is
also timed as the whole call from the pair's geometry, the gate's inputs
included (``chip_smoke.epipolar_whole_call``), with its device events.

For each tree (default: this checkout; ``--tree A --tree B --tree B --tree
A`` compares two in turns on one card) a child process imports that tree's
``tc2li_slam_torch``, builds its kernels and, on each case:

- holds the kernel's outputs equal to ``match_best2_plain``'s, bit for bit;
- counts the launches of a call (the wrapper's ``launches``), the valid
  rows, the valid columns and the admitted pairs;
- times a call behind a device backlog (``chip_smoke.cuda_ms``), device ms,
  and a call on the host clock up to its synchronize (host ms), with its
  device events (kernels of any kind, eager tensor ops included);
- the phase split through the lapped library (``build.variant(
  "-DTC2LI_LAPS")``, ``csrc/laps.cuh``): cycles a call by phase on thread 0
  of block 0, each phase's share (in the stereo mode: block 0's build of
  the row bins, its barrier, then its first warp's walk);
- device ms a call by kernel name (``chip_smoke.kernel_split``).

It also reports each matcher kernel's registers, local (spill) bytes and
static shared memory (``cudaFuncGetAttributes`` through
``tc2li_match_func_attrs``), and the registers and spill stores ``ptxas``
reported where this process built the library. ``--times-only`` leaves out
the lapped build and the attributes (a checkout from before ``match.cu``
had laps has neither). Prints one JSON object a tree, with the card's name
and power limit, and writes them to ``--out``.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# the lap slots of csrc/match.cu: the window mode's column grid (3, 5, 6),
# the stereo mode's row bins: block 0's build (7-10), the barrier after it
# (11), the walk of warp 0's row (12), the epipolar mode's staging of the
# valid columns (13) and warp 0's walk of its row (14), and the dense mode
# (15, 17-20: a phase of block 0, each tile's phases added up). Slots 0-1
# are those of the staged kernel the dense mode had before (side 2 staged
# whole, then warp 0's groups of 4 rows against every column), for a
# checkout that has it.
LAPS = {0: "staged: stage side 2", 1: "staged: rows of warp 0 (every column)",
        15: "dense: rows compacted, invalid rows written, column flags to bits and scanned",
        17: "dense: the tiles' valid columns staged, to the barrier after them",
        18: "dense: the tiles' walks and key merges, to the barrier after them",
        19: "dense: the tiles' column minima to device memory",
        20: "dense: the valid rows' outputs written",
        3: "columns and descriptors to shared memory, cells cleared",
        5: "columns to their cells' lists", 6: "rows of warp 0 (their cells)",
        7: "bins: columns loaded, classed, extent and band",
        8: "bins: columns counted into their bins", 9: "bins: scan, head",
        10: "bins: scatter to the CSR layout", 11: "barrier after the build",
        12: "walk of warp 0's row",
        13: "epipolar: the valid columns staged", 14: "epipolar: warp 0's row walked"}
N_SLOTS = 64   # laps.cuh kLapSlots


def ptxas_kernels(log: str) -> dict:
    """{matcher kernel: {ptxas_registers, spill_store_bytes}} from nvcc's
    -Xptxas=-v log (the entries whose mangled name holds ``match``)."""
    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = m.group(1) if "match" in m.group(1) else None
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and cur:
            out.setdefault(cur, {})["spill_store_bytes"] = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur:
            out.setdefault(cur, {})["ptxas_registers"] = int(m.group(1))
    return out


def host_ms(torch, fn, reps: int) -> float:
    """Mean host-clock ms of a call of ``fn`` up to the synchronize after it,
    after one warm-up."""
    import time
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def measure(tree: Path, cases_path: Path, times_only: bool = False) -> dict:
    sys.path.insert(0, str(tree))
    import torch

    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import tc2li_slam_torch
    from tc2li_slam_torch.ops.kernels import build, match

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    lib = build.library()
    dev = torch.device("cuda")
    res = {"tree": str(Path(tc2li_slam_torch.__file__).resolve().parents[1]),
           "card": cs.nvidia_smi_line(), "cases": {},
           "ptxas": ptxas_kernels(build.ptxas_log), "attributes": {}}
    lapped = None
    if not times_only:
        for which, name in enumerate(("window", "window mutual", "stereo mutual",
                                      "dense mutual", "epipolar mutual")):
            a = (ctypes.c_int * 4)()
            if lib.tc2li_match_func_attrs(which, a) == 0:
                res["attributes"][name] = dict(registers=a[0], local_bytes=a[1],
                                               static_shared_bytes=a[2], max_threads=a[3])
        lapped = build.variant("-DTC2LI_LAPS")

    def laps(fn):
        """cycles a call of ``fn`` by phase through the lapped library"""
        buf = (ctypes.c_longlong * (2 * N_SLOTS))()
        with build.routed_to(lapped):
            fn()
            torch.cuda.synchronize()
            lapped.tc2li_laps_reset_match()
            fn()
            torch.cuda.synchronize()
            lapped.tc2li_laps_read_match(buf)
        # (a slot this tool does not name, as a patched form may lap, by number)
        names = {k: LAPS.get(k, f"slot {k}") for k in range(N_SLOTS) if buf[N_SLOTS + k]}
        tot = sum(buf[k] for k in names)
        return {"total cycles": tot, **{
            v: {"cycles": buf[k], "laps": buf[N_SLOTS + k], "share": buf[k] / max(tot, 1)}
            for k, v in names.items()}}

    whole = cs.epipolar_whole_call(torch, cases_path, dev)
    for name, (d1, d2, v1, v2, mask, mutual) in cs.load_match_cases(
            torch, match, cases_path, dev).items():
        call = lambda: match.match_best2(d1, d2, v1, v2, mask, mutual)
        dense = isinstance(mask, torch.Tensor)
        n0 = match.launches
        got = call()
        n_launch = match.launches - n0
        ref = match.match_best2_plain(d1, d2, v1, v2, mask, mutual)
        torch.cuda.synchronize()
        full = v1[:, None] & v2[None, :]
        if mask is not None:
            full = full & (mask if dense else mask.dense())
        split = cs.kernel_split(torch, call, 20)
        row = {"N": d1.shape[0], "M": d2.shape[0],
               "mask": "none" if mask is None else "dense" if dense else type(mask).__name__,
               "mutual": mutual,
               "valid rows": int(v1.sum()), "valid columns": int(v2.sum()),
               "admitted pairs": int(full.sum()),
               "bit-equal to plain": cs.same(torch, got, ref),
               "same bits twice": cs.same(torch, got, call()), "launches a call": n_launch,
               "ms a call": cs.cuda_ms(torch, call, 50, True),
               "host ms a call": host_ms(torch, call, 20),
               "device events a call": sum(round(v["launches_a_call"]) for v in split.values()),
               "ms by kernel": {k: v["ms_a_launch"] for k, v in split.items()}}
        del full
        if name in whole:   # the call from the pair's geometry: the gate's inputs too
            row["whole call"] = {
                "ms": cs.cuda_ms(torch, whole[name], 50, True),
                "ms by kernel": {k: v["ms_a_launch"] for k, v in
                                 cs.kernel_split(torch, whole[name], 20).items()},
                "device events": sum(round(v["launches_a_call"]) for v in
                                     cs.kernel_split(torch, whole[name], 5).values()),
                "bit-equal to the mask's call": cs.same(torch, whole[name](), got)}
        if lapped is not None:
            row["phases"] = laps(call)
        res["cases"][name] = row
        print(f"{name}: {json.dumps(row)}", file=sys.stderr, flush=True)
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cases", default=str(ROOT / "build" / "match_cases.pt"),
                    help="the cases chip_smoke.py wrote (chip_smoke.save_match_cases)")
    ap.add_argument("--tree", action="append", default=None,
                    help="a checkout whose tc2li_slam_torch to time (repeatable)")
    ap.add_argument("--out", default=str(ROOT / "build" / "match_kernels"))
    ap.add_argument("--times-only", action="store_true",
                    help="no lapped build and no attributes")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args()
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    cases = Path(args.cases).resolve()
    if args.child:
        print(json.dumps(measure(Path(args.child).resolve(), cases, args.times_only)),
              flush=True)
        return 0
    if not cases.exists():
        print(f"no cases at {cases}: run chip_smoke.py first", file=sys.stderr)
        return 1
    for i, tree in enumerate(args.tree or [str(ROOT)]):
        res = subprocess.run([sys.executable, __file__, "--cases", str(cases), "--out", str(out),
                              "--child", tree] + (["--times-only"] if args.times_only else []),
                             capture_output=True, text=True, timeout=1200)
        if res.returncode != 0:
            print(res.stdout[-4000:], res.stderr[-8000:], file=sys.stderr)
            return 1
        r = json.loads(res.stdout.strip().splitlines()[-1])
        (out / f"match_{i}.json").write_text(json.dumps(r, indent=1))
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
