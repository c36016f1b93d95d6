"""State containers from and to numpy arrays.

The JAX package keeps its map, voxel map and keyframe LiDAR store as
NamedTuples of device arrays; ``*_from_numpy`` take the same fields as numpy
arrays (a mapping, or any NamedTuple via ``_asdict``) and build this
package's containers on ``device``, and ``*_to_numpy`` give the fields
back. Descriptor words travel as uint32 on the numpy side and int32 bit
patterns on the torch side. This is how a run starts from a saved map, and
how the tests start both packages from the same mid-sequence state. A
place-recognition vocabulary travels the same way
(``vocabulary_from_numpy``): one trained by the JAX package quantizes the
same descriptors to the same words here. The IMU mode's state does too: the
ESEKF ``Filter`` (``filter_from_numpy``), the per-keyframe inertial store
(``imustore_from_numpy``) and a preintegration (``preintegrated_from_numpy``).
So do the loop-closing containers: a pose graph's edges
(``posegraph_edges_from_numpy``) and a whole atlas bundle with its LiDAR
store, keyframe words and inertial store (``mapbundle_from_numpy``).
``slam.checkpoint`` writes and reads its files through these converters.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .estimation import esekf, imu as imu_est
from .ops import bow, voxel_map as vm_mod
from .slam import atlas as atlas_mod, imu_mode, local_mapping, mapstate
from .solver import sim3 as sim3_mod

_UINT32_FIELDS = ("kf_desc", "lm_desc")


def _fields(src) -> dict:
    return dict(src._asdict()) if hasattr(src, "_asdict") else dict(src)


def _tensor(name, a, device):
    a = np.asarray(a)
    if name in _UINT32_FIELDS:
        a = a.astype(np.uint32).view(np.int32)
    elif a.dtype == np.float64:
        a = a.astype(np.float32)
    elif a.dtype in (np.uint32, np.int64):
        a = a.astype(np.int32)
    return torch.as_tensor(np.array(a)).to(device)   # a writable copy, 0-d kept


def _numpy(name, t: torch.Tensor):
    a = t.detach().cpu().numpy()
    return a.view(np.uint32) if name in _UINT32_FIELDS else a


def mapstate_from_numpy(src, device="cpu") -> mapstate.MapState:
    f = _fields(src)
    return mapstate.MapState(**{k.name: _tensor(k.name, f[k.name], device)
                                for k in dataclasses.fields(mapstate.MapState)})


def mapstate_to_numpy(m: mapstate.MapState) -> dict[str, np.ndarray]:
    return {k.name: _numpy(k.name, getattr(m, k.name))
            for k in dataclasses.fields(mapstate.MapState)}


def voxelmap_from_numpy(src, device="cpu") -> vm_mod.VoxelMap:
    f = _fields(src)
    return vm_mod.VoxelMap(
        points=_tensor("points", f["points"], device),
        keys=_tensor("keys", f["keys"], device),
        origin=_tensor("origin", f["origin"], device),
        voxel_size=float(np.float32(f["voxel_size"])),
        count=_tensor("count", f["count"], device),
    )


def voxelmap_to_numpy(m: vm_mod.VoxelMap) -> dict[str, np.ndarray]:
    return {"points": _numpy("points", m.points), "keys": _numpy("keys", m.keys),
            "origin": _numpy("origin", m.origin),
            "voxel_size": np.float32(m.voxel_size), "count": _numpy("count", m.count)}


def lidarstore_from_numpy(src, device="cpu") -> local_mapping.LidarStore:
    f = _fields(src)
    return local_mapping.LidarStore(_tensor("points", f["points"], device),
                                    _tensor("valid", f["valid"], device))


def lidarstore_to_numpy(s: local_mapping.LidarStore) -> dict[str, np.ndarray]:
    return {"points": _numpy("points", s.points), "valid": _numpy("valid", s.valid)}


_VOC_TABLES = ("node_desc", "children", "is_leaf", "word_id", "weight")


def vocabulary_from_numpy(src, device="cpu") -> bow.Vocabulary:
    """A vocabulary's fields (the JAX package's ``Vocabulary`` or a mapping
    of its fields as numpy arrays and ints) -> ``bow.Vocabulary`` on ``device``."""
    f = _fields(src)
    return bow.vocabulary_from_arrays(
        *[np.asarray(f[k]) for k in _VOC_TABLES], f["k"], f["depth"], f["n_words"], device)


def vocabulary_to_numpy(voc: bow.Vocabulary) -> dict:
    out = {k: getattr(voc, k).detach().cpu().numpy() for k in _VOC_TABLES}
    out["node_desc"] = out["node_desc"].view(np.uint32)
    out.update(k=voc.k, depth=voc.depth, n_words=voc.n_words)
    return out


def filter_from_numpy(src, device="cpu") -> esekf.Filter:
    """An ESEKF filter from ``(x, P)`` where ``x`` has the fields of
    ``esekf.State`` (the JAX package's ``Filter``, or a mapping ``{"x": ..., "P": ...}``)."""
    f = _fields(src)
    x = _fields(f["x"])
    return esekf.Filter(esekf.State(**{k: _tensor(k, x[k], device) for k in esekf.State._fields}),
                        _tensor("P", f["P"], device))


def filter_to_numpy(f: esekf.Filter) -> dict:
    return {"x": {k: _numpy(k, v) for k, v in f.x._asdict().items()}, "P": _numpy("P", f.P)}


def imustore_from_numpy(src, device="cpu") -> imu_mode.ImuKfStore:
    f = _fields(src)
    return imu_mode.ImuKfStore(**{k.name: _tensor(k.name, f[k.name], device)
                                  for k in dataclasses.fields(imu_mode.ImuKfStore)})


def imustore_to_numpy(s: imu_mode.ImuKfStore) -> dict[str, np.ndarray]:
    return {k.name: _numpy(k.name, getattr(s, k.name))
            for k in dataclasses.fields(imu_mode.ImuKfStore)}


def preintegrated_from_numpy(src, device="cpu") -> imu_est.Preintegrated:
    f = _fields(src)
    return imu_est.Preintegrated(**{k: _tensor(k, f[k], device)
                                    for k in imu_est.Preintegrated._fields})


def posegraph_edges_from_numpy(src, device="cpu") -> sim3_mod.PoseGraphEdges:
    f = _fields(src)
    return sim3_mod.PoseGraphEdges(**{k: _tensor(k, f[k], device)
                                      for k in sim3_mod.PoseGraphEdges._fields})


def posegraph_edges_to_numpy(e: sim3_mod.PoseGraphEdges) -> dict[str, np.ndarray]:
    return {k: _numpy(k, v) for k, v in e._asdict().items()}


def mapbundle_from_numpy(src, device="cpu") -> atlas_mod.MapBundle:
    """An atlas bundle from the fields of the JAX package's ``MapBundle`` (or
    a mapping): ``map`` and the optional ``lidar_store``, ``kf_words`` and
    ``imu_store`` as numpy containers, ``n_kf`` and ``map_id`` as ints."""
    f = src if isinstance(src, dict) else {k: getattr(src, k) for k in (
        "map", "lidar_store", "kf_words", "imu_store", "n_kf", "map_id")}

    def opt(key, conv):
        return None if f.get(key) is None else conv(f[key], device)

    return atlas_mod.MapBundle(
        map=mapstate_from_numpy(f["map"], device),
        lidar_store=opt("lidar_store", lidarstore_from_numpy),
        kf_words=opt("kf_words", lambda a, d: _tensor("kf_words", a, d)),
        imu_store=opt("imu_store", imustore_from_numpy),
        n_kf=int(f["n_kf"]), map_id=int(f["map_id"]))


def mapbundle_to_numpy(b: atlas_mod.MapBundle) -> dict:
    return {"map": mapstate_to_numpy(b.map),
            "lidar_store": None if b.lidar_store is None else lidarstore_to_numpy(b.lidar_store),
            "kf_words": None if b.kf_words is None else _numpy("kf_words", b.kf_words),
            "imu_store": None if b.imu_store is None else imustore_to_numpy(b.imu_store),
            "n_kf": b.n_kf, "map_id": b.map_id}
