"""Checkpoint / resume: atlas serialization with an integrity checksum
(port of ``tc2li_slam_tpu/slam/checkpoint.py``).

The state is flat fixed-capacity pools, so a checkpoint is one ``.npz`` of
those pools plus a JSON header. The file format is the JAX package's
(``FORMAT_VERSION`` 1: the same keys, the same dtypes; descriptor words are
written as uint32), so a checkpoint written by either package loads in the
other. An MD5 of the vocabulary tables rejects a resume with another
vocabulary (LoadAtlas's guard).

``save_system`` captures what is needed to go on tracking: the active map
bundle, the frozen atlas maps, the LiDAR voxel map, the current pose and
velocity, the trajectory so far and the host counters. ``load_system``
restores into a fresh ``System`` built from the same configuration. The
random generator of the RANSAC draws is not saved. In IMU mode the IMU
windows since the last keyframe are not saved either: the per-frame
pose-inertial refinement holds off until the next keyframe, and the
refinement ladder of the visual-inertial initialization restarts its clock.
"""

from __future__ import annotations

import hashlib
import json

import numpy as np
import torch

from .. import interop
from . import atlas as atlas_mod

FORMAT_VERSION = 1


def vocabulary_checksum(voc) -> str:
    """MD5 over the vocabulary tables (node descriptors as uint32, children,
    weights): the same bytes as the JAX package hashes."""
    tables = interop.vocabulary_to_numpy(voc)
    h = hashlib.md5()
    for k in ("node_desc", "children", "weight"):
        h.update(np.ascontiguousarray(tables[k]).tobytes())
    return h.hexdigest()


def _flatten(prefix: str, tree: dict, out: dict[str, np.ndarray]):
    """Nested {name: array} -> flat {"prefix.name": array}."""
    for name, v in tree.items():
        if isinstance(v, dict):
            _flatten(f"{prefix}{name}.", v, out)
        else:
            out[f"{prefix}{name}"] = np.asarray(v)


def _subtree(data: dict, prefix: str) -> dict:
    """The arrays saved under ``prefix``, one level of nesting rebuilt
    (``filt.x.pos`` -> {"x": {"pos": ...}})."""
    tree: dict = {}
    for key, v in data.items():
        if not key.startswith(prefix):
            continue
        node = tree
        *parents, leaf = key[len(prefix):].split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def save_system(slam, path: str):
    """Write a resumable checkpoint of the full system state."""
    slam.flush_mapping()  # deferred mapping work lands first
    arrays: dict[str, np.ndarray] = {}
    _flatten("map.", interop.mapstate_to_numpy(slam.map), arrays)
    if slam.lidar_enabled:
        _flatten("vmap.", interop.voxelmap_to_numpy(slam.vmap), arrays)
        _flatten("lidar_store.", interop.lidarstore_to_numpy(slam.lidar_store), arrays)
    if slam.voc is not None:
        arrays["kf_words"] = slam.kf_words.cpu().numpy()
    if slam.use_imu:
        _flatten("filt.", interop.filter_to_numpy(slam.filt), arrays)
        _flatten("imu_store.", interop.imustore_to_numpy(slam.imu_store), arrays)
        arrays["gravity_vis"] = slam.gravity_vis.cpu().numpy()
    arrays["T_cw"] = slam.T_cw.cpu().numpy()
    arrays["velocity"] = slam.velocity.cpu().numpy()
    for i, b in enumerate(slam.atlas.frozen):
        bundle = interop.mapbundle_to_numpy(b)
        _flatten(f"atlas{i}.map.", bundle["map"], arrays)
        if bundle["lidar_store"] is not None:
            _flatten(f"atlas{i}.lidar_store.", bundle["lidar_store"], arrays)
        if bundle["kf_words"] is not None:
            arrays[f"atlas{i}.kf_words"] = bundle["kf_words"]
    if slam.traj:
        arrays["traj.T_rel"] = torch.stack([T for *_, T in slam.traj]).cpu().numpy()

    header = {
        "format_version": FORMAT_VERSION,
        "state": slam.state,
        "ref_kf": slam.ref_kf,
        "n_kf_host": slam.n_kf_host,
        "ref_kf_tracked": slam.ref_kf_tracked,
        "frames_since_kf": slam.frames_since_kf,
        "frame_idx": slam.frame_idx,
        "map_id": slam.map_id,
        "n_lost": slam.n_lost,
        "use_imu": slam.use_imu,
        "lidar_enabled": slam.lidar_enabled,
        "imu_initialized": getattr(slam, "_imu_initialized", False),
        "vi_initialized": getattr(slam, "_vi_initialized", False),
        "kf_alive": list(slam.kf_alive),
        "atlas": {
            "n_created": slam.atlas.n_created,
            "n_discarded": slam.atlas.n_discarded,
            "frozen": [
                {"n_kf": b.n_kf, "map_id": b.map_id,
                 "has_lidar": b.lidar_store is not None,
                 "has_words": b.kf_words is not None}
                for b in slam.atlas.frozen
            ],
        },
        "traj_meta": [(t, mid, ref) for t, mid, ref, _ in slam.traj],
        "voc_md5": vocabulary_checksum(slam.voc) if slam.voc is not None else None,
    }
    arrays["__header__"] = np.frombuffer(json.dumps(header).encode(), dtype=np.uint8)
    np.savez_compressed(path, **arrays)


def load_system(path: str, cfg, device, voc=None):
    """Rebuild a ``System`` on ``device`` from a checkpoint.

    Raises ``ValueError`` on a vocabulary checksum mismatch or a format
    version mismatch, ``KeyError`` on a missing field."""
    from . import system as sys_mod

    data = dict(np.load(path, allow_pickle=False))
    header = json.loads(bytes(data.pop("__header__").tobytes()).decode())
    if header["format_version"] != FORMAT_VERSION:
        raise ValueError(f"checkpoint format {header['format_version']} != {FORMAT_VERSION}")
    if header["voc_md5"] is not None:
        if voc is None or vocabulary_checksum(voc) != header["voc_md5"]:
            raise ValueError("vocabulary checksum mismatch (LoadAtlas MD5 guard)")

    slam = sys_mod.System(cfg, device, voc=voc)
    dev = slam.device
    slam.map = interop.mapstate_from_numpy(_subtree(data, "map."), dev)
    if slam.lidar_enabled and "vmap.points" in data:
        slam.vmap = interop.voxelmap_from_numpy(_subtree(data, "vmap."), dev)
        slam.lidar_store = interop.lidarstore_from_numpy(_subtree(data, "lidar_store."), dev)
    if voc is not None and "kf_words" in data:
        slam.kf_words = torch.as_tensor(data["kf_words"]).to(dev)
    if header["use_imu"] and slam.use_imu and "filt.P" in data:
        slam.filt = interop.filter_from_numpy(_subtree(data, "filt."), dev)
        slam.imu_store = interop.imustore_from_numpy(_subtree(data, "imu_store."), dev)
        slam.gravity_vis = torch.as_tensor(data["gravity_vis"]).to(dev)
        slam._imu_initialized = header["imu_initialized"]
        slam._vi_initialized = header.get("vi_initialized", False)
        # host mirror of has_factor (the frame loop never reads the device's)
        slam._has_factor_host = [bool(v) for v in data["imu_store.has_factor"]]
        # a resumed run earns the later rungs of the ladder again on fresh data
        slam._vi_stage = 0
        slam._vi_init_time = None
        # the IMU windows since the last keyframe are gone: preintegrating a
        # cut window against the keyframe before the save would be wrong, so
        # the per-frame refinement waits for the next keyframe
        slam._imu_ring_overflow = True
    slam.T_cw = torch.as_tensor(data["T_cw"]).to(dev)
    slam.velocity = torch.as_tensor(data["velocity"]).to(dev)

    slam.state = header["state"]
    slam.ref_kf = header["ref_kf"]
    slam.n_kf_host = header["n_kf_host"]
    slam.ref_kf_tracked = header["ref_kf_tracked"]
    slam.frames_since_kf = header["frames_since_kf"]
    slam.frame_idx = header["frame_idx"]
    slam.map_id = header["map_id"]
    slam.n_lost = header["n_lost"]
    if "kf_alive" in header:
        slam.kf_alive = list(header["kf_alive"])

    slam.atlas = atlas_mod.Atlas(n_created=header["atlas"]["n_created"],
                                 n_discarded=header["atlas"]["n_discarded"])
    for i, meta in enumerate(header["atlas"]["frozen"]):
        has_lidar = meta["has_lidar"] and slam.lidar_enabled
        has_words = meta["has_words"] and f"atlas{i}.kf_words" in data
        slam.atlas.frozen.append(interop.mapbundle_from_numpy({
            "map": _subtree(data, f"atlas{i}.map."),
            "lidar_store": _subtree(data, f"atlas{i}.lidar_store.") if has_lidar else None,
            "kf_words": data[f"atlas{i}.kf_words"] if has_words else None,
            "n_kf": meta["n_kf"], "map_id": meta["map_id"]}, dev))

    slam.traj = []
    if "traj.T_rel" in data:
        T_rels = torch.as_tensor(data["traj.T_rel"]).to(dev)
        for (t, mid, ref), T in zip(header["traj_meta"], T_rels):
            slam.traj.append((t, mid, ref, T))
    return slam
