"""Build and load the port's CUDA kernels (``tc2li_slam_torch/csrc/*.cu``).

The sources are compiled at first use with ``nvcc`` for ``sm_90a`` (one
compiler process per source, side by side) into one shared library with a
plain C interface, loaded with ``ctypes``. The library
lands in ``build/tc2li_kernels/`` at the root of the checkout, keyed by a
hash of the sources and the headers they share (``csrc/*.cuh``), so a fresh
checkout builds it once and an edited source or header rebuilds. Nothing here runs at import time.

``variant(flags)`` builds the same sources with extra ``nvcc`` flags (for
example ``-DTC2LI_LAPS``, the clock laps of ``csrc/laps.cuh``) into a library
of its own, and ``routed_to(lib)`` sends the wrappers' launches to it inside
a ``with`` block: a measuring tool's build is the main build with those
flags, nothing else.
"""

from __future__ import annotations

import contextlib
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


def library_path(flags: tuple[str, ...] = ()) -> Path:
    h = hashlib.sha256()
    for src in sources() + headers():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(ARCH_FLAGS + list(flags)).encode())
    return BUILD_DIR / f"libtc2li_kernels_{h.hexdigest()[:16]}.so"


def build(flags: tuple[str, ...] = ()) -> Path:
    """Compile the library (with extra ``nvcc`` ``flags``, a library of its
    own) if it is not there yet; returns its path.

    One ``nvcc -c`` per source, all started together, then one link."""
    global ptxas_log
    out = library_path(flags)
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
                   "-Xptxas=-v", *flags, "-o", obj, str(src)]
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
        if not flags:
            ptxas_log = "".join(logs)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        _lib = _load(build())
    return _lib


def variant(*flags: str) -> ctypes.CDLL:
    """The library built with extra ``nvcc`` flags, loaded beside the main
    one (built on first call)."""
    return _load(build(tuple(flags)))


@contextlib.contextmanager
def routed_to(lib: ctypes.CDLL):
    """The wrappers launch through ``lib`` (a ``variant``) inside the block."""
    global _lib
    main = library()
    _lib = lib
    try:
        yield lib
    finally:
        _lib = main


def _load(path: Path) -> ctypes.CDLL:
    """The library at ``path`` with its C functions' signatures."""
    lib = ctypes.CDLL(str(path))
    vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.tc2li_fast_score_planes.argtypes = [vp, vp, vp, vp, i, i, i, i, f, f, i, vp]
    lib.tc2li_fast_score_planes.restype = i
    lib.tc2li_fast_nms_planes.argtypes = [vp, vp, vp, vp, i, i, f, f, i, i, vp]
    lib.tc2li_fast_nms_planes.restype = i
    lib.tc2li_hamming.argtypes = [vp, vp, vp, i, i, vp]
    lib.tc2li_hamming.restype = i
    lib.tc2li_match_max_columns.argtypes = [i]
    lib.tc2li_match_max_columns.restype = i
    lib.tc2li_match_dense_tile.argtypes = [i]
    lib.tc2li_match_dense_tile.restype = i
    lib.tc2li_match_func_attrs.argtypes = [i, vp]
    lib.tc2li_match_func_attrs.restype = i
    lib.tc2li_match_best2.argtypes = [i, i, i] + [vp] * 13 + [i, i, f, f] + [vp] * 4 + [i, i, vp]
    lib.tc2li_match_best2.restype = i
    lib.tc2li_pose_only_lm.argtypes = [vp] * 6 + [i] + [f] * 5 + [i, i] + [vp] * 5
    lib.tc2li_pose_only_lm.restype = i
    lib.tc2li_balm_scratch.argtypes = [i, i]
    lib.tc2li_balm_scratch.restype = ctypes.c_longlong
    lib.tc2li_balm_quadratic.argtypes = [vp] * 6 + [i, i] + [vp] * 5
    lib.tc2li_balm_quadratic.restype = i
    lib.tc2li_local_ba_scratch.argtypes = [i, i, i]
    lib.tc2li_local_ba_scratch.restype = ctypes.c_longlong
    lib.tc2li_local_ba_lm.argtypes = [vp] * 16 + [i] * 6 + [f] * 5 + [i] + [vp] * 6
    lib.tc2li_local_ba_lm.restype = i
    lib.tc2li_lvi_ba_scratch.argtypes = [i, i, i, i]
    lib.tc2li_lvi_ba_scratch.restype = ctypes.c_longlong
    lib.tc2li_lvi_ba_lm.argtypes = [vp] * 22 + [i] * 7 + [f] * 5 + [i] + [vp] * 9
    lib.tc2li_lvi_ba_lm.restype = i
    lib.tc2li_inertial_init_smem.argtypes = [i]
    lib.tc2li_inertial_init_smem.restype = ctypes.c_longlong
    lib.tc2li_inertial_init_max_kf.argtypes = []
    lib.tc2li_inertial_init_max_kf.restype = i
    lib.tc2li_inertial_init_gn.argtypes = ([vp] * 16 + [i, ctypes.c_double, ctypes.c_double]
                                           + [i] * 3 + [vp, vp])
    lib.tc2li_inertial_init_gn.restype = i
    lib.tc2li_pose_graph_scratch.argtypes = [i, i]
    lib.tc2li_pose_graph_scratch.restype = ctypes.c_longlong
    lib.tc2li_pose_graph_launches.argtypes = [i, i]
    lib.tc2li_pose_graph_launches.restype = ctypes.c_longlong
    lib.tc2li_pose_graph_gn.argtypes = [vp] * 7 + [i] * 3 + [vp] * 3
    lib.tc2li_pose_graph_gn.restype = i
    lib.tc2li_orb_level_planes.argtypes = [vp] * 6 + [i] * 5 + [vp, vp]
    lib.tc2li_orb_level_planes.restype = i
    lib.tc2li_orb_select_grid.argtypes = [vp] * 9 + [i, i, vp]
    lib.tc2li_orb_select_grid.restype = i
    lib.tc2li_orb_describe.argtypes = [vp] * 8 + [i] * 7 + [vp, vp]
    lib.tc2li_orb_describe.restype = i
    lib.tc2li_stereo_prep.argtypes = [vp, vp, i, i, vp, vp, vp]
    lib.tc2li_stereo_prep.restype = i
    lib.tc2li_stereo_refine.argtypes = [vp, vp, i, i, i] + [vp] * 7 + [i, f] + [vp] * 7
    lib.tc2li_stereo_refine.restype = i
    lib.tc2li_clusters_scratch.argtypes = [i, i, i]
    lib.tc2li_clusters_scratch.restype = ctypes.c_longlong
    lib.tc2li_balm_clusters.argtypes = [vp] * 6 + [i] * 4 + [f] * 3 + [vp] * 6 + [vp]
    lib.tc2li_balm_clusters.restype = i
    lib.tc2li_clusters_ran.argtypes = [ctypes.POINTER(ctypes.c_ulonglong)]
    lib.tc2li_clusters_ran.restype = i
    lib.tc2li_imu_preintegrate.argtypes = [vp] * 5 + [i] + [f] * 4 + [vp, vp]
    lib.tc2li_imu_preintegrate.restype = i
    lib.tc2li_pose_inertial_lm.argtypes = ([ctypes.POINTER(ctypes.c_uint64)] + [i] * 3
                                           + [f] * 5 + [i, i] + [vp] * 4)
    lib.tc2li_pose_inertial_lm.restype = i
    d = ctypes.c_double
    lib.tc2li_lio_rows_blocks.argtypes = [i]
    lib.tc2li_lio_rows_blocks.restype = i
    lib.tc2li_lio_work_doubles.argtypes = []
    lib.tc2li_lio_work_doubles.restype = i
    lib.tc2li_lio_func_attrs.argtypes = [i, vp]
    lib.tc2li_lio_func_attrs.restype = i
    lib.tc2li_esekf_predict.argtypes = [vp] * 4 + [i] + [f] * 4 + [vp] * 4 + [i, i, vp, vp]
    lib.tc2li_esekf_predict.restype = i
    lib.tc2li_lio_fence_log2.argtypes = [i]
    lib.tc2li_lio_fence_log2.restype = i
    lib.tc2li_lio_rows.argtypes = [vp] * 3 + [i] + [vp] * 3 + [i, vp, i, f, f, i, i] + [vp] * 5
    lib.tc2li_lio_rows.restype = i
    lib.tc2li_esekf_step.argtypes = [vp, i, i, d, d, vp, vp, i, i] + [vp] * 6
    lib.tc2li_esekf_step.restype = i
    lib.tc2li_error_string.argtypes = [i]
    lib.tc2li_error_string.restype = ctypes.c_char_p
    return lib


def check(rc: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if rc != 0:
        msg = library().tc2li_error_string(rc).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {rc} ({msg})")
