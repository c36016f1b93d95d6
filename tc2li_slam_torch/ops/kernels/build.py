"""Build and load the port's CUDA kernels (``tc2li_slam_torch/csrc/*.cu``).

The sources are compiled at first use with ``nvcc`` for ``sm_90a`` (one
compiler process per source, side by side) into one shared library with a
plain C interface, loaded with ``ctypes``. The library
lands in ``build/tc2li_kernels/`` at the root of the checkout, keyed by a
hash of the sources and the headers they share (``csrc/*.cuh``), so a fresh
checkout builds it once and an edited source or header rebuilds. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "tc2li_kernels"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

_lib: ctypes.CDLL | None = None
ptxas_log = ""   # nvcc's register / shared-memory report of this process's build


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def headers() -> list[Path]:
    return sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    h = hashlib.sha256()
    for src in sources() + headers():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(ARCH_FLAGS).encode())
    return BUILD_DIR / f"libtc2li_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library if it is not there yet; returns its path.

    One ``nvcc -c`` per source, all started together, then one link."""
    global ptxas_log
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    # compile under private names, then rename: two processes building at
    # once never load a half-written library
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        jobs = []
        for src in sources():
            obj = os.path.join(tmp, src.stem + ".o")
            cmd = [nvcc, *ARCH_FLAGS, "-std=c++17", "-O3", "-c", "-Xcompiler", "-fPIC",
                   "-Xptxas=-v", "-o", obj, str(src)]
            jobs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
        logs = []
        for cmd, _, proc in jobs:
            stdout, stderr = proc.communicate()
            if proc.returncode != 0:
                for _, _, other in jobs:
                    if other.poll() is None:
                        other.kill()
                        other.communicate()
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{stdout}\n{stderr}")
            logs.append(stderr)
        lib = os.path.join(tmp, "lib.so")
        cmd = [nvcc, *ARCH_FLAGS, "-shared", "-o", lib, *(obj for _, obj, _ in jobs)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({res.returncode}):\n{' '.join(cmd)}\n{res.stdout}\n{res.stderr}")
        os.replace(lib, out)
        ptxas_log = "".join(logs)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.tc2li_fast_score_planes.argtypes = [vp, vp, vp, vp, i, i, i, i, f, f, i, vp]
        lib.tc2li_fast_score_planes.restype = i
        lib.tc2li_fast_nms_planes.argtypes = [vp, vp, vp, vp, i, i, f, f, i, i, vp]
        lib.tc2li_fast_nms_planes.restype = i
        lib.tc2li_hamming.argtypes = [vp, vp, vp, i, i, vp]
        lib.tc2li_hamming.restype = i
        lib.tc2li_match_max_columns.argtypes = [i]
        lib.tc2li_match_max_columns.restype = i
        lib.tc2li_match_best2.argtypes = [i, i] + [vp] * 11 + [i, i, f] + [vp] * 4 + [i, i, vp]
        lib.tc2li_match_best2.restype = i
        lib.tc2li_pose_only_lm.argtypes = [vp] * 6 + [i] + [f] * 5 + [i, i] + [vp] * 5
        lib.tc2li_pose_only_lm.restype = i
        lib.tc2li_balm_blocks.argtypes = [i]
        lib.tc2li_balm_blocks.restype = i
        lib.tc2li_balm_quadratic.argtypes = [vp] * 6 + [i, i] + [vp] * 6
        lib.tc2li_balm_quadratic.restype = i
        lib.tc2li_local_ba_scratch.argtypes = [i, i, i]
        lib.tc2li_local_ba_scratch.restype = ctypes.c_longlong
        lib.tc2li_local_ba_lm.argtypes = [vp] * 16 + [i] * 6 + [f] * 5 + [i] + [vp] * 5
        lib.tc2li_local_ba_lm.restype = i
        lib.tc2li_orb_level_planes.argtypes = [vp] * 6 + [i] * 5 + [vp, vp]
        lib.tc2li_orb_level_planes.restype = i
        lib.tc2li_orb_select_grid.argtypes = [vp] * 7 + [i, i, vp]
        lib.tc2li_orb_select_grid.restype = i
        lib.tc2li_orb_describe.argtypes = [vp] * 8 + [i] * 7 + [vp, vp]
        lib.tc2li_orb_describe.restype = i
        lib.tc2li_error_string.argtypes = [i]
        lib.tc2li_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(rc: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if rc != 0:
        msg = library().tc2li_error_string(rc).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {rc} ({msg})")
