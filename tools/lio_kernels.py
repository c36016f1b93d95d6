#!/usr/bin/env python3
"""Where IMU mode's scan-step update spends its time, on one CUDA card, for
one or several checkouts in turns.

    python3 tools/lio_kernels.py [--tree DIR ...] [--out DIR] [--predict-only] [--calls N]

For each tree (default: this checkout; ``--tree A --tree B --tree B --tree
A`` compares two in turns on one card) a child process imports that tree's
``tc2li_slam_torch``, builds its kernels and measures, on
``chip_smoke.lio_problem``'s street scan against its 2^19-slot pool, at the
prediction:

- ``lio_rows`` (``csrc/lio.cu``) at ``work_cap`` 8,192 and 32,768 points,
  with 6 and 12 columns (``estimate_extrinsic``): device ms a launch behind
  a device backlog (``chip_smoke.cuda_ms``), and in an older tree whose
  fence table has a launch of its own (``LioWork.fences``) that launch
  apart;
- ``esekf_predict`` on ``lio_problem``'s filter at 1, 10, 20 and 40 live
  samples and at 40 live samples spread over 1,024 slots, the rest padding
  (``chip_smoke.predict_window``): device ms a call behind a backlog,
  and the slope in us a live sample between 10 and 40; and at 10, 20 and
  40 live samples the spread of ``--calls`` single calls (``call_times``:
  median, p99, largest, and the calls over twice the median);
- the prediction with the pool's fence table and without, on
  ``lio_problem``'s own window and pool: ``predict_with_fences`` (one
  launch: the fence blocks ride in the predict launch) where the tree has
  it, else ``esekf_predict`` followed by the fence table's own launch
  (``LioWork.fences``), device ms a call behind a backlog, two readings
  of each in turns;
- ``esekf_step``'s first launch (from the prediction; it inverts P0), a
  middle one and the final one (it inverts the posterior information and
  runs the guard), each timed apart behind a backlog (steps back to back),
  and the whole update (``scan_update``);
- the phase split through the lapped library (``build.variant(
  "-DTC2LI_LAPS")``: ``csrc/laps.cuh``, empty in the main build): cycles a
  launch by phase on thread 0 of block 0, and each phase's share (none for
  a kernel without laps);
- each kernel's registers, local (spill) bytes and static shared memory
  (``cudaFuncGetAttributes`` through ``tc2li_lio_func_attrs``), and the
  spill stores ``ptxas`` reported for the build.

``--predict-only`` measures ``esekf_predict`` alone, with and without the
fence table. Prints one JSON object
a tree, with the card's name and power limit, and writes them to ``--out``.
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
# a query) as it was lapped for its split (rows 0-6, step 16-25)
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
                 38: "guard and output"},
        # esekf_predict, on warp 0 (P's; the chain's warp 1 runs beside it)
        "predict": {46: "P load and gB (warp 0)",
                    47: "a round's barrier (warp 1's per-sample terms)",
                    51: "P: waiting for the chain", 52: "P: F's blocks and G's rows A",
                    53: "P: the new columns", 50: "output"}}
N_SLOTS = 64   # laps.cuh kLapSlots
KERNELS = ("predict_kernel", "rows_kernel", "step_kernel")


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


def call_times(torch, fn, calls: int) -> dict:
    """The device ms of each of ``calls`` calls of ``fn``, back to back
    behind a device backlog: an event after each call, the gaps between
    them. ``backlog held``: the backlog had not ended when the host had
    enqueued the last call, so no gap holds host time."""
    fn()
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(calls + 1)]
    a = torch.empty((4096, 4096), device="cuda").normal_()
    torch.cuda.synchronize()
    for _ in range(40):   # ~0.1 s of matrix products
        a @ a
    ev[0].record()
    for e in ev[1:]:
        fn()
        e.record()
    held = not ev[0].query()
    ev[-1].synchronize()
    t = sorted(ev[i].elapsed_time(ev[i + 1]) for i in range(calls))
    med = t[calls // 2]
    return {"calls": calls, "backlog held": held, "median ms": med,
            "p99 ms": t[min(calls - 1, (99 * calls) // 100)], "max ms": t[-1],
            "min ms": t[0], "over twice the median": sum(x > 2 * med for x in t)}


def measure(tree: Path, predict_only: bool = False, calls: int = 200) -> dict:
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
    lapped = build.variant("-DTC2LI_LAPS")
    spills = ptxas_spills(build.ptxas_log)
    for i, name in enumerate(KERNELS):
        row = dict(spills.get(name, {}))
        a = (ctypes.c_int * 4)()
        if lib.tc2li_lio_func_attrs(i, a) == 0:
            row.update(registers=a[0], local_bytes=a[1], static_shared_bytes=a[2],
                       max_threads=a[3])
        res["attributes"][name] = row
    ms = lambda fn, reps: cs.cuda_ms(torch, fn, reps, True)

    def laps(fn, prep=lambda: None, names=None):
        """cycles a call of ``fn`` by phase through the lapped library"""
        buf = (ctypes.c_longlong * (2 * N_SLOTS))()
        prep()
        fn()
        torch.cuda.synchronize()
        lapped.tc2li_laps_reset_lio()
        fn()
        torch.cuda.synchronize()
        lapped.tc2li_laps_read_lio(buf)
        names = names or {**LAPS["rows"], **LAPS["step"]}
        tot = sum(buf[k] for k in names if buf[N_SLOTS + k])
        return {"total cycles": tot, **{
            v: {"cycles": buf[k], "laps": buf[N_SLOTS + k], "share": buf[k] / max(tot, 1)}
            for k, v in names.items() if buf[N_SLOTS + k]}}

    a = cs.lio_problem(torch, dev)
    filt0, m, scan, t_pts, sv, gyro, acc, dts, trel, noise, cfg0 = a
    res["esekf_predict"] = {}
    windows = {f"{n} live": cs.predict_window(torch, n) for n in (1, 10, 20, 40)}
    windows["40 live in 1,024 slots"] = cs.predict_window(torch, 40, 1024)
    for label, window in windows.items():
        gw, aw, dw = (t.to(dev) for t in window)
        call = lambda: klio.esekf_predict(filt0, gw, aw, dw, noise)
        row = {"slots": dw.shape[0], "live": int((dw > 0).sum()), "ms a call": ms(call, 50)}
        if label in ("10 live", "20 live", "40 live"):
            row["single calls"] = call_times(torch, call, calls)
        with build.routed_to(lapped):
            row["phases"] = laps(call, names=LAPS["predict"])
        res["esekf_predict"][label] = row
        print(f"esekf_predict {label}: {json.dumps(row)}", file=sys.stderr, flush=True)
    p = res["esekf_predict"]
    res["esekf_predict"]["us a live sample, 10 to 40"] = (
        1e3 * (p["40 live"]["ms a call"] - p["10 live"]["ms a call"]) / 30)
    fk, Rk, pk = klio.esekf_predict(filt0, gyro, acc, dts, noise)
    # the prediction with the fence table and without; the update's work
    # (the table handed over, or built by its own launch in an older tree)
    pred = lambda: klio.esekf_predict(filt0, gyro, acc, dts, noise)
    if hasattr(klio, "predict_with_fences"):
        fenced = lambda: klio.predict_with_fences(filt0, gyro, acc, dts, noise, m.keys)
        form = "one launch: the fence blocks in the predict launch"
        fences = fenced()[3]
        new_work = lambda pts, pv, cfg: klio.LioWork(filt0, fk, m, pts, pv, cfg, fences)
        update = lambda pts, pv, cfg: klio.scan_update(filt0, fk, m, pts, pv, cfg, fences)
    else:
        def new_work(pts, pv, cfg):
            w = klio.LioWork(filt0, fk, m, pts, pv, cfg)
            w.fences()
            return w
        update = lambda pts, pv, cfg: klio.scan_update(filt0, fk, m, pts, pv, cfg)
        pts0, pv0 = lio.scan_points(fk, scan, t_pts, sv, trel, Rk, pk, cfg0)
        w0 = new_work(pts0, pv0, cfg0)

        def fenced():
            pred()
            w0.fences()
        form = "two launches: the prediction, then the fence table's own"
    readings = [(name, ms(fn, 50)) for name, fn in (("alone", pred), ("with", fenced),
                                                    ("with", fenced), ("alone", pred))]
    res["predict with fences"] = {
        "form": form, "slots": dts.shape[0], "live": int((dts > 0).sum()),
        "pool slots": m.capacity,
        "alone ms": [v for k, v in readings if k == "alone"],
        "with the fence table ms": [v for k, v in readings if k == "with"]}
    print(f"predict with fences: {json.dumps(res['predict with fences'])}", file=sys.stderr,
          flush=True)
    if predict_only:
        return res
    for cap in (8192, 32768):
        for ext in (False, True):
            cfg = cfg0._replace(work_cap=cap, estimate_extrinsic=ext)
            pts, pv = lio.scan_points(fk, scan, t_pts, sv, trel, Rk, pk, cfg)

            def work():
                w = new_work(pts, pv, cfg)
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
                        "update ms (whole scan_update)": ms(lambda: update(pts, pv, cfg), 20)}
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
    ap.add_argument("--predict-only", action="store_true",
                    help="time esekf_predict alone")
    ap.add_argument("--calls", type=int, default=200,
                    help="single calls of esekf_predict timed for their spread")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args()
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    if args.child:
        print(json.dumps(measure(Path(args.child).resolve(), args.predict_only, args.calls)),
              flush=True)
        return 0
    for i, tree in enumerate(args.tree or [str(ROOT)]):
        res = subprocess.run([sys.executable, __file__, "--out", str(out), "--child", tree,
                              "--calls", str(args.calls)]
                             + (["--predict-only"] if args.predict_only else []),
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
