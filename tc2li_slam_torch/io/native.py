"""ctypes bindings for the native runtime library (``native/``; a copy of
``tc2li_slam_tpu/io/native.py``).

Native code covers the host runtime around the device compute path: velodyne
decode with per-point time reconstruction, a threaded scan prefetcher that
overlaps disk IO/decode with device compute, and bulk trajectory writing.
Falls back to the numpy implementations transparently when the library has
not been built (``make -C native``).
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

_LIB = None
_LIB_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "native", "libtpu_slam_native.so",
)


def _load():
    global _LIB
    if _LIB is not None:
        return _LIB
    if not os.path.exists(_LIB_PATH):
        return None
    lib = ctypes.CDLL(_LIB_PATH)
    lib.read_velodyne.restype = ctypes.c_int
    lib.read_velodyne.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int,
    ]
    lib.prefetch_create.restype = ctypes.c_void_p
    lib.prefetch_create.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int,
    ]
    lib.prefetch_get.restype = ctypes.c_int
    lib.prefetch_get.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_uint8),
    ]
    lib.prefetch_destroy.restype = None
    lib.prefetch_destroy.argtypes = [ctypes.c_void_p]
    lib.write_kitti_trajectory.restype = ctypes.c_int
    lib.write_kitti_trajectory.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int,
    ]
    _LIB = lib
    return lib


def available() -> bool:
    return _load() is not None


def read_velodyne(path: str, n_max: int = 131072):
    """Decode one KITTI velodyne .bin: (xyz [n_max, 3], times [n_max],
    valid [n_max], n). Native when built, numpy otherwise."""
    lib = _load()
    xyz = np.zeros((n_max, 3), np.float32)
    times = np.zeros(n_max, np.float32)
    valid = np.zeros(n_max, np.uint8)
    if lib is not None:
        n = lib.read_velodyne(
            path.encode(), xyz.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            times.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            valid.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), n_max,
        )
        if n < 0:
            raise FileNotFoundError(path)
        return xyz, times, valid.astype(bool), n
    # numpy fallback (same semantics)
    pts = np.fromfile(path, dtype=np.float32).reshape(-1, 4)[:, :3]
    n = min(len(pts), n_max)
    if len(pts) > n_max:
        idx = (np.arange(n_max) * (len(pts) / n_max)).astype(np.int64)
        pts = pts[idx]
    az = np.arctan2(pts[:n, 1], pts[:n, 0])
    xyz[:n] = pts[:n]
    times[:n] = (np.pi - az) / (2 * np.pi) * 0.1
    valid[:n] = 1
    return xyz, times, valid.astype(bool), n


class ScanPrefetcher:
    """Threaded read-ahead over a list of velodyne files (native-backed)."""

    def __init__(self, paths: list[str], n_max: int = 131072,
                 n_threads: int = 2, ahead: int = 4):
        self.paths = paths
        self.n_max = n_max
        self._lib = _load()
        self._handle = None
        if self._lib is not None:
            arr = (ctypes.c_char_p * len(paths))(*[p.encode() for p in paths])
            self._keepalive = arr
            self._handle = self._lib.prefetch_create(
                arr, len(paths), n_max, n_threads, ahead
            )

    def get(self, i: int):
        if self._handle is not None:
            xyz = np.zeros((self.n_max, 3), np.float32)
            times = np.zeros(self.n_max, np.float32)
            valid = np.zeros(self.n_max, np.uint8)
            n = self._lib.prefetch_get(
                self._handle, i,
                xyz.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                times.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                valid.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            )
            return xyz, times, valid.astype(bool), n
        return read_velodyne(self.paths[i], self.n_max)

    def close(self):
        if self._handle is not None:
            self._lib.prefetch_destroy(self._handle)
            self._handle = None

    def __del__(self):
        self.close()


def write_kitti_trajectory(path: str, T_wc: np.ndarray) -> None:
    lib = _load()
    T = np.ascontiguousarray(T_wc[:, :4, :4], np.float32)
    if lib is not None:
        lib.write_kitti_trajectory(
            path.encode(), T.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            len(T),
        )
        return
    from ..slam import trajectory
    trajectory.save_kitti(path, T_wc)
