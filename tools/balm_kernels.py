#!/usr/bin/env python3
"""Device time of the BALM pass's two kernels (``csrc/clusters.cu``,
``csrc/balm.cu``) on one card, split by phase, for one or several checkouts
in turns.

    python3 tools/balm_kernels.py [--windows build/balm_windows.npz]
                                  [--tree DIR ...] [--out DIR]

The windows are the inputs ``chip_smoke.py`` phase 5 saves (``--windows``,
written by every run of it): ``balm_clusters`` on phase 3's last window,
4e's last window and six planar keyframes of 20,000 points;
``balm_quadratic`` on phase 3's last clusters and the planar window's. For
each tree (default: this checkout; ``--tree A --tree B --tree B --tree A``
compares two trees in turns on one card) a child process imports that
tree's ``tc2li_slam_torch``, builds its kernels and measures on each window:

- device ms a call of each kernel name (``chip_smoke.kernel_split``, from
  ``torch.profiler``) and device launches a call;
- the call behind a device backlog (``chip_smoke.cuda_ms``);
- host us a call of the wrapper, and of each C call it makes, replayed
  alone (the launch and, in older trees, the scratch-size query);
  ``world_points`` (the three tensor ops before the cluster kernel) alone;
- the phase split: the tree's two sources rebuilt with ``clock64()`` stamps
  (``TC2LI_STAMP(k)``: block 0's thread 0 writes the clock to slot k after
  a barrier; ``TC2LI_LAP(k)``: lane 0 of every warp adds the cycles since
  its last lap to slot k) into a library of their own, one call a window,
  cycles a phase and each phase's share of the stamped call. A source
  without stamps (a tree from before them) gets them inserted at the
  anchors of ``PARENT_STAMPS`` first. The main build never holds a stamp.

Prints one JSON object a tree, with the card's name and power limit, and
writes them to ``--out``."""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import importlib.util
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
N_SLOTS = 4096
STAMP_HEADER = r"""
#include <cuda_runtime.h>
static __device__ long long tc2li_stamps[%(n)d];
#define TC2LI_STAMP(k) do { if (threadIdx.x == 0 && blockIdx.x == 0) tc2li_stamps[(k)] = clock64(); } while (0)
#define TC2LI_LAP_START long long tc2li_t0_ = clock64();
#define TC2LI_LAP(k) do { if ((threadIdx.x & 31) == 0) { const long long now_ = clock64(); \
  atomicAdd(reinterpret_cast<unsigned long long*>(&tc2li_stamps[64 + (k)]), \
            static_cast<unsigned long long>(now_ - tc2li_t0_)); \
  atomicAdd(reinterpret_cast<unsigned long long*>(&tc2li_stamps[128 + (k)]), 1ull); \
  tc2li_t0_ = now_; } } while (0)
extern "C" int tc2li_stamps_read_%(stem)s(long long* out) {
  return static_cast<int>(cudaMemcpyFromSymbol(out, tc2li_stamps, sizeof(tc2li_stamps)));
}
extern "C" int tc2li_stamps_reset_%(stem)s() {
  static long long zero[%(n)d];
  return static_cast<int>(cudaMemcpyToSymbol(tc2li_stamps, zero, sizeof(zero)));
}
"""

# Stamps inserted into the sources of a tree from before them (the one-block
# cluster kernel and the 128-block quadratic): (anchor, text put after it).
# Slots as the current sources use them: 0 start; 1 root keys; 2 root
# partition; 3 root sort; 4 root gather; 5 root runs; 6 root cells; 7 root
# voxels; 8 root plane tests; 11 child keys; 12..18 the child pass the same
# way; 21 compaction; 22 copy. Laps of the quadratic: 0 moments, 1 the
# covariance and the jet, 2 d, 3 rows and pose terms, 4 Hessian entries,
# 5 partial sums, 6 the last block's sum.
PARENT_STAMPS = {
    "clusters.cu": [
        ("const float ctr[3] = {centre(a, 0), centre(a, 1), centre(a, 2)};\n",
         "  TC2LI_STAMP(0);\n"),
        ("    s.vB[i] = static_cast<unsigned>(i);\n  }\n  __syncthreads();\n"
         "  cluster_pass(a, s, 0, a.plane_ratio, true, cnt);\n", None),
        ("  sort_pairs(s, partition_valid(s, P), cnt);\n", None),
        ("  for (long long e = t; e < 3LL * V; e += kT) cCenter[e] = 0.f;\n",
         "  __syncthreads();\n  TC2LI_STAMP(root ? 4 : 14);\n"),
        ("    s.vox_pos[n_vox] = n_in;\n  }\n  __syncthreads();\n",
         "  TC2LI_STAMP(root ? 5 : 15);\n"),
        ("    for (int e = 0; e < 9; ++e) cPc[9 * cell + e] = Q[e];\n  }\n",
         "  __syncthreads();\n  TC2LI_STAMP(root ? 6 : 16);\n"),
        ("    cCenter[3LL * v + 2] = __fdiv_rn(S2, n);\n  }\n  __syncthreads();\n",
         "  TC2LI_STAMP(root ? 7 : 17);\n"),
        ("    if (root) s.split[v] = !planar && n_tot >= static_cast<float>(a.min_points);\n"
         "  }\n  __syncthreads();\n", "  TC2LI_STAMP(root ? 8 : 18);\n"),
        ("    s.vB[i] = static_cast<unsigned>(i);\n  }\n  __syncthreads();\n"
         "  cluster_pass(a, s, V, a.child_ratio, false, cnt);\n", None),
        ("    if (pos < V) s.src[pos] = j;\n  }\n  __syncthreads();\n", "  TC2LI_STAMP(21);\n"),
        ("  for (int v = t; v < V; v += kT) a.valid[v] = static_cast<uint8_t>(s.planar[s.src[v]]);\n",
         "  __syncthreads();\n  TC2LI_STAMP(22);\n"),
    ],
    "balm.cu": [
        ("  if (tid == 0) sc[3] = 0.f;\n  __syncthreads();\n", "  TC2LI_LAP_START\n"),
        ("      s.Nw[w] = N[v * W + w];\n    }\n    __syncthreads();\n", "    TC2LI_LAP(0);\n"),
        ("      sc[3] += Nt * lj.v;\n    }\n    __syncthreads();\n", "    TC2LI_LAP(1);\n"),
        ("      for (int i = 0; i < 3; ++i) s.d[3 * tid + i] = s.m[3 * tid + i] - smu[i];\n"
         "    }\n    __syncthreads();\n", "    TC2LI_LAP(2);\n"),
        ("      s.Kpp[e] = lq / n + a2 * d2h;\n    }\n    __syncthreads();\n", "    TC2LI_LAP(3);\n"),
        ("      s.accH[e] += wv * val;\n    }\n    __syncthreads();\n", "    TC2LI_LAP(4);\n"),
        ("  if (tid == 0) last = atomicAdd(counter, 1u) == gridDim.x - 1;\n  __syncthreads();\n",
         "  TC2LI_LAP(5);\n"),
        ("  if (tid == 0) *counter = 0u;   // ready for the next call\n", None),
    ],
}
# the replacements the anchors above with None stand for
PARENT_REPLACE = {
    ("clusters.cu", 1): ("    s.vB[i] = static_cast<unsigned>(i);\n  }\n  __syncthreads();\n"
                         "  TC2LI_STAMP(1);\n  cluster_pass(a, s, 0, a.plane_ratio, true, cnt);\n"),
    ("clusters.cu", 2): ("  { const int nv_ = partition_valid(s, P);\n    TC2LI_STAMP(root ? 2 : 12);\n"
                         "    sort_pairs(s, nv_, cnt);\n    TC2LI_STAMP(root ? 3 : 13); }\n"),
    ("clusters.cu", 8): ("    s.vB[i] = static_cast<unsigned>(i);\n  }\n  __syncthreads();\n"
                         "  TC2LI_STAMP(11);\n  cluster_pass(a, s, V, a.child_ratio, false, cnt);\n"),
    ("balm.cu", 7): ("  __syncthreads();\n  TC2LI_LAP(6);\n"
                     "  if (tid == 0) *counter = 0u;   // ready for the next call\n"),
}
STAMP_NAMES = {1: "root keys", 2: "root partition", 3: "root sort", 4: "root gather",
               5: "root runs", 6: "root cells", 7: "root voxels", 8: "root plane tests",
               11: "child keys", 12: "child partition", 13: "child sort", 14: "child gather",
               15: "child runs", 16: "child cells", 17: "child voxels",
               18: "child plane tests", 21: "compaction", 22: "copy",
               9: "root rows (cells, voxels, plane tests)", 19: "child rows",
               23: "compaction and copy (block 0)",
               21: "first launch: the factors (block 0)",
               22: "first launch: the chunk's partial sums (block 0)",
               31: "second launch: waiting for the first (block 0)",
               32: "second launch: its runs of chunks", 34: "second launch: the runs added"}
GROUP_STARTS = {30}   # a stamp of another launch: no difference with the one before
LAP_NAMES = {"balm.cu": {0: "moments", 1: "covariance and jet", 2: "d", 3: "rows",
                         4: "Hessian entries", 5: "partial sums", 6: "last block's sum"},
             "clusters.cu": {0: "pass: count", 1: "pass: warp prefix",
                             2: "pass: cluster barrier 1", 6: "pass: the other blocks' counts",
                             7: "pass: scan over the digits", 3: "pass: offsets",
                             4: "pass: scatter", 5: "pass: cluster barrier 2",
                             8: "row: walk 1", 9: "row: walk 2", 10: "row: plane test",
                             11: "row: copy out"}}


def stamped_source(src: Path) -> str:
    """The source with its stamps live (inserted first where it has none)."""
    text = src.read_text()
    if "TC2LI_STAMP" not in text and "TC2LI_LAP" not in text:
        for i, (anchor, add) in enumerate(PARENT_STAMPS[src.name]):
            if text.count(anchor) != 1:
                raise SystemExit(f"{src}: anchor {i} found {text.count(anchor)} times")
            new = PARENT_REPLACE.get((src.name, i), anchor + (add or ""))
            text = text.replace(anchor, new)
    return STAMP_HEADER % {"n": N_SLOTS, "stem": src.stem} + text


def build_stamped(tree: Path, out: Path) -> dict:
    """{stem: ctypes.CDLL} of the tree's two BALM sources with stamps."""
    libs = {}
    out.mkdir(parents=True, exist_ok=True)
    csrc = tree / "tc2li_slam_torch" / "csrc"
    nvcc = "/usr/local/cuda/bin/nvcc" if os.path.exists("/usr/local/cuda/bin/nvcc") else "nvcc"
    jobs = []
    for stem in ("clusters", "balm"):
        text = stamped_source(csrc / f"{stem}.cu")
        h = hashlib.sha256(text.encode()).hexdigest()[:12]
        cu = out / f"stamped_{stem}_{h}.cu"
        so = out / f"libstamped_{stem}_{h}.so"
        cu.write_text(text)
        cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
               "-Xcompiler", "-fPIC", "-I", str(csrc), "-o", str(so), str(cu)]
        jobs.append((stem, so, cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                     stderr=subprocess.PIPE, text=True)))
    for stem, so, cmd, proc in jobs:
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed on the stamped {stem}.cu:\n{' '.join(cmd)}\n{err}")
        libs[stem] = ctypes.CDLL(str(so))
    return libs


class Proxy:
    """The tree's kernel library with some C functions taken from others, and
    a record of the calls made through it."""

    def __init__(self, base, swap=None):
        self._base, self._swap, self.calls = base, swap or {}, []

    def __getattr__(self, name):
        fn = self._swap.get(name) or getattr(self._base, name)

        def call(*args):
            self.calls.append((name, args))
            return fn(*args)
        return call


class PhaseSplit:
    """The stamped builds of a tree's two BALM sources, swapped into the
    loaded package's kernel library for one call at a time."""

    def __init__(self, tree: Path, out: Path, build):
        self.build, self.real = build, build.library()
        self.libs = build_stamped(Path(tree), Path(out))
        self.swap = {"tc2li_balm_clusters": self.libs["clusters"].tc2li_balm_clusters,
                     "tc2li_balm_quadratic": self.libs["balm"].tc2li_balm_quadratic}
        for name, fn in self.swap.items():
            fn.argtypes = getattr(self.real, name).argtypes
            fn.restype = getattr(self.real, name).restype

    def __call__(self, torch, stem: str, fn) -> dict:
        """Cycles a phase of one call of ``fn`` (its second, after a warm-up)
        through the stamped ``stem`` source: {phase: {"cycles", "share"}},
        "total cycles", and {"lap <phase>": {"cycles a lap", "laps"}}."""
        lib, build = self.libs[stem], self.build
        buf = (ctypes.c_longlong * N_SLOTS)()
        build._lib = Proxy(self.real, self.swap)
        try:
            fn()
            torch.cuda.synchronize()
            getattr(lib, f"tc2li_stamps_reset_{stem}")()
            fn()
            torch.cuda.synchronize()
            getattr(lib, f"tc2li_stamps_read_{stem}")(buf)
        finally:
            build._lib = self.real
        st = {k: buf[k] for k in range(64) if buf[k]}
        res = {}
        if st:
            ks = sorted(st)
            total = sum(st[k] - st[prev] for prev, k in zip(ks, ks[1:])
                        if k not in GROUP_STARTS)
            for prev, k in zip(ks, ks[1:]):
                if k in GROUP_STARTS:
                    continue
                res[STAMP_NAMES.get(k, f"stamp {k}")] = {
                    "cycles": st[k] - st[prev], "share": (st[k] - st[prev]) / max(total, 1)}
            res["total cycles"] = total
        names = LAP_NAMES.get(f"{stem}.cu", {})
        for k in range(64):
            if buf[128 + k]:
                res[f"lap {names.get(k, k)}"] = {"cycles a lap": buf[64 + k] / buf[128 + k],
                                                 "laps": buf[128 + k]}
        return res


def load_windows(torch, path: Path, dev, balm_mod):
    import numpy as np
    z = np.load(path)
    up = lambda k: torch.as_tensor(z[k]).to(dev)
    cl, quad = [], []
    for i, name in enumerate(str(x) for x in z["cluster_names"]):
        kw = z[f"c{i}_kw"]
        kw = dict(voxel_size=float(kw[0]), max_voxels=int(kw[1]), min_points=int(kw[2]))
        cl.append((name, (up(f"c{i}_points"), up(f"c{i}_valid"), up(f"c{i}_T_wl")), kw))
    for i, name in enumerate(str(x) for x in z["quad_names"]):
        c = balm_mod.VoxelClusters(*(up(f"q{i}_{f}") for f in balm_mod.VoxelClusters._fields))
        quad.append((name, c, up(f"q{i}_T")))
    return cl, quad


def host_us(fn, reps=200) -> float:
    fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return 1e6 * (time.perf_counter() - t0) / reps


def measure(tree: Path, windows: Path, out: Path) -> dict:
    sys.path.insert(0, str(tree))
    import torch

    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    import tc2li_slam_torch
    from tc2li_slam_torch.ops.kernels import balm as kbalm, build, clusters as kcl
    from tc2li_slam_torch.solver import balm as balm_mod

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    dev = torch.device("cuda")
    real = build.library()
    cl_cases, quad_cases = load_windows(torch, windows, dev, balm_mod)
    res = {"tree": str(Path(tc2li_slam_torch.__file__).resolve().parents[1]),
           "card": chip_smoke.nvidia_smi_line(), "clusters": {}, "quadratic": {}}
    stamps = PhaseSplit(tree, out, build)

    def replay(fn):
        """host us of the wrapper and of each C call it makes, replayed alone"""
        proxy = Proxy(real)
        build._lib = proxy
        try:
            keep = fn()   # its outputs stay allocated while the C calls replay into them
        finally:
            build._lib = real
        torch.cuda.synchronize()
        r = {"wrapper": host_us(fn)}
        for cname, args in proxy.calls:
            if cname == "tc2li_error_string":
                continue
            f = getattr(real, cname)
            r[f"C call {cname}"] = host_us(lambda f=f, args=args: f(*args))
        torch.cuda.synchronize()
        del keep
        return r

    x = cl_cases[0][1][0]
    res["host us of single ops"] = {
        "torch.empty": host_us(lambda: torch.empty((512, 6, 3, 3), device=dev)),
        "split into 6": host_us(lambda: x.split([1, 1, 1, 1, 1, x.shape[0] - 5])),
        "view": host_us(lambda: x.view(-1)),
        "contiguous() of a contiguous tensor": host_us(lambda: x.contiguous()),
        "current_stream().cuda_stream": host_us(
            lambda: torch.cuda.current_stream(dev).cuda_stream)}
    for name, a, kw in cl_cases:
        fn = lambda a=a, kw=kw: kcl.balm_clusters(*a, **kw)
        split = chip_smoke.kernel_split(torch, fn, 10)
        host = replay(fn)
        host["world_points"] = host_us(lambda a=a: balm_mod.world_points(*a))
        res["clusters"][name] = {
            "W": a[0].shape[0], "M": a[0].shape[1], "valid points": int(a[1].sum()),
            "V": kw["max_voxels"], "kernel_split": split,
            "device launches a call": sum(v["launches_a_call"] for v in split.values()),
            "call behind a backlog ms": chip_smoke.cuda_ms(torch, fn, 20, True),
            "host us": host, "phases": stamps(torch, "clusters", fn)}
    for name, c, T in quad_cases:
        fn = lambda c=c, T=T: kbalm.balm_quadratic(c, T)
        split = chip_smoke.kernel_split(torch, fn, 20)
        res["quadratic"][name] = {
            "V": c.N.shape[0], "W": c.N.shape[1], "valid voxels": int(c.valid.sum()),
            "kernel_split": split,
            "device launches a call": sum(v["launches_a_call"] for v in split.values()),
            "call behind a backlog ms": chip_smoke.cuda_ms(torch, fn, 50, True),
            "host us": replay(fn), "phases": stamps(torch, "balm", fn)}
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", action="append", default=None,
                    help="a checkout whose tc2li_slam_torch to time (repeatable)")
    ap.add_argument("--windows", default=str(ROOT / "build" / "balm_windows.npz"))
    ap.add_argument("--out", default=str(ROOT / "build" / "balm_kernels"))
    ap.add_argument("--child", nargs=2, help=argparse.SUPPRESS)
    args = ap.parse_args()
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    if args.child:
        print(json.dumps(measure(Path(args.child[0]).resolve(), Path(args.child[1]), out)),
              flush=True)
        return 0
    if not Path(args.windows).exists():
        print(f"no windows at {args.windows}: run chip_smoke.py first", file=sys.stderr)
        return 1
    for i, tree in enumerate(args.tree or [str(ROOT)]):
        res = subprocess.run([sys.executable, __file__, "--out", str(out), "--child", tree,
                              args.windows], capture_output=True, text=True, timeout=1200)
        if res.returncode != 0:
            print(res.stdout[-4000:], res.stderr[-8000:], file=sys.stderr)
            return 1
        r = json.loads(res.stdout.strip().splitlines()[-1])
        (out / f"balm_{i}.json").write_text(json.dumps(r, indent=1))
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
