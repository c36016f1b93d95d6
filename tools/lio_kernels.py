#!/usr/bin/env python3
"""Where IMU mode's scan-step update spends its time, on one CUDA card, for
one or several checkouts in turns.

    python3 tools/lio_kernels.py [--tree DIR ...] [--out DIR]

For each tree (default: this checkout; ``--tree A --tree B --tree B --tree
A`` compares two in turns on one card) a child process imports that tree's
``tc2li_slam_torch``, builds its kernels and measures, on
``chip_smoke.lio_problem``'s street scan against its 2^19-slot pool, at the
prediction:

- ``lio_rows`` (``csrc/lio.cu``) at ``work_cap`` 8,192 and 32,768 points,
  with 6 and 12 columns (``estimate_extrinsic``): device ms a launch behind
  a device backlog (``chip_smoke.cuda_ms``), and where the tree has it the
  fence table's launch (``LioWork.fences``) apart;
- ``esekf_step``'s first launch (from the prediction; it inverts P0), a
  middle one and the final one (it inverts the posterior information and
  runs the guard), each timed apart behind a backlog (steps back to back),
  and the whole update (``scan_update``);
- where the tree builds a lapped library (``build.variant("-DTC2LI_LAPS")``:
  ``csrc/laps.cuh``, empty in the main build), the phase split: cycles a
  launch by phase on thread 0 of block 0, and each phase's share;
- each kernel's registers, local (spill) bytes and static shared memory
  (``cudaFuncGetAttributes`` through ``tc2li_lio_func_attrs``), and the
  spill stores ``ptxas`` reported for the build.

Prints one JSON object a tree, with the card's name and power limit, and
writes them to ``--out``.
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
# the lap slots of csrc/lio.cu: the two-level form (rows 8-15, step 32-38),
# and the older one-level form (a binary search of the pool a lane, a warp
# a query) as it was lapped for its split (rows 0-6, step 16-25). A tree of
# the one-level form may lack the fence launch, the attribute query and
# the laps: the tool times what a tree has.
LAPS = {"rows": {0: "state load", 1: "search of the 25 columns", 2: "candidate loads",
                 3: "5 warp argmins", 4: "float64 fit, gate and row", 5: "per-lane sums",
                 6: "block's write",
                 8: "state and fence table to shared memory", 9: "fence and bucket search",
                 10: "candidate loads", 11: "5 warp argmins", 12: "fit, gate and row (a lane a query)",
                 13: "warp's ordered sums", 14: "block's write",
                 15: "the batch's barrier (the slowest warp's search)"},
        "step": {16: "partials' reduction", 17: "Gauss-Jordan (first)",
                 18: "state and P0^-1 load", 19: "tangent_terms", 20: "assemble",
                 21: "Cholesky", 22: "thread-0 solves and boxplus", 23: "output",
                 24: "Gauss-Jordan (final)", 25: "guard and output",
                 32: "loads, the partials' reduction beside the tangent chains "
                     "(first: P0^-1)",
                 33: "assemble", 34: "Cholesky (warp 0)", 35: "solves (warp 0)",
                 36: "boxplus and output", 37: "Gauss-Jordan (final, the block)",
                 38: "guard and output"}}
N_SLOTS = 64   # laps.cuh kLapSlots
KERNELS = ("predict_kernel", "rows_kernel", "step_kernel", "fence_kernel")


def ptxas_spills(log: str) -> dict:
    """{kernel: (registers, spill store bytes)} from nvcc's -Xptxas=-v log."""
    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = next((k for k in KERNELS if k in m.group(1)), None)
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and cur:
            out.setdefault(cur, {})["spill_store_bytes"] = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur:
            out.setdefault(cur, {})["ptxas_registers"] = int(m.group(1))
    return out


def measure(tree: Path) -> dict:
    sys.path.insert(0, str(tree))
    import torch

    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import tc2li_slam_torch
    from tc2li_slam_torch.ops.kernels import build, lio as klio
    from tc2li_slam_torch.slam import lio

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    lib = build.library()
    dev = torch.device("cuda")
    res = {"tree": str(Path(tc2li_slam_torch.__file__).resolve().parents[1]),
           "card": cs.nvidia_smi_line(), "lio_rows": {}, "esekf_step": {}, "attributes": {}}
    csrc = Path(tc2li_slam_torch.__file__).resolve().parent / "csrc"
    lapped = (build.variant("-DTC2LI_LAPS")
              if hasattr(build, "variant") and "TC2LI_LAP" in (csrc / "lio.cu").read_text()
              else None)
    spills = ptxas_spills(getattr(build, "ptxas_log", ""))
    for i, name in enumerate(("predict_kernel", "rows_kernel", "step_kernel", "fence_kernel")):
        row = dict(spills.get(name, {}))
        if hasattr(lib, "tc2li_lio_func_attrs"):
            lib.tc2li_lio_func_attrs.argtypes = [ctypes.c_int, ctypes.c_void_p]
            a = (ctypes.c_int * 4)()
            if lib.tc2li_lio_func_attrs(i, a) == 0:
                row.update(registers=a[0], local_bytes=a[1], static_shared_bytes=a[2],
                           max_threads=a[3])
        if row:
            res["attributes"][name] = row
    ms = lambda fn, reps: cs.cuda_ms(torch, fn, reps, True)

    def laps(fn, prep=lambda: None):
        """cycles a call of ``fn`` by phase through the lapped library"""
        buf = (ctypes.c_longlong * (2 * N_SLOTS))()
        prep()
        fn()
        torch.cuda.synchronize()
        lapped.tc2li_laps_reset_lio()
        fn()
        torch.cuda.synchronize()
        lapped.tc2li_laps_read_lio(buf)
        names = {**LAPS["rows"], **LAPS["step"]}
        tot = sum(buf[k] for k in names if buf[N_SLOTS + k])
        return {"total cycles": tot, **{
            v: {"cycles": buf[k], "laps": buf[N_SLOTS + k], "share": buf[k] / max(tot, 1)}
            for k, v in names.items() if buf[N_SLOTS + k]}}

    a = cs.lio_problem(torch, dev)
    filt0, m, scan, t_pts, sv, gyro, acc, dts, trel, noise, cfg0 = a
    fk, Rk, pk = klio.esekf_predict(filt0, gyro, acc, dts, noise)
    for cap in (8192, 32768):
        for ext in (False, True):
            cfg = cfg0._replace(work_cap=cap, estimate_extrinsic=ext)
            pts, pv = lio.scan_points(fk, scan, t_pts, sv, trel, Rk, pk, cfg)

            def work():
                w = klio.LioWork(filt0, fk, m, pts, pv, cfg)
                if hasattr(w, "fences"):
                    w.fences()
                w.rows(0)
                w.step(0)
                return w

            w = work()
            k = cfg.max_iters
            row = {"M": pts.shape[0], "ncols": w.ncols, "blocks": w.blocks,
                   "ms a launch": ms(lambda: w.rows(1), 50)}
            if hasattr(w, "fences"):
                row["fence ms a launch"] = ms(w.fences, 50)
            srow = {}
            if cap == 8192 or ext:
                srow = {"first ms": ms(lambda: w.step(0), 50),
                        "middle ms": ms(lambda: w.step(1), 50),
                        "final ms": ms(lambda: w.step(k, final=True), 50),
                        "update ms (whole scan_update)": ms(
                            lambda: klio.scan_update(filt0, fk, m, pts, pv, cfg), 20)}
            if lapped is not None:
                with build.routed_to(lapped):
                    wl = work()
                    row["phases"] = laps(lambda: wl.rows(1))
                    if srow:
                        srow["phases first"] = laps(lambda: wl.step(0))
                        srow["phases middle"] = laps(lambda: wl.step(1), lambda: wl.step(0))
                        srow["phases final"] = laps(lambda: wl.step(k, final=True))
            label = f"M {pts.shape[0]}, {w.ncols} columns"
            res["lio_rows"][label] = row
            if srow:
                res["esekf_step"][label] = srow
            print(f"{label}: lio_rows {json.dumps(row)} esekf_step {json.dumps(srow)}",
                  file=sys.stderr, flush=True)
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", action="append", default=None,
                    help="a checkout whose tc2li_slam_torch to time (repeatable)")
    ap.add_argument("--out", default=str(ROOT / "build" / "lio_kernels"))
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
        (out / f"lio_{i}.json").write_text(json.dumps(r, indent=1))
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
