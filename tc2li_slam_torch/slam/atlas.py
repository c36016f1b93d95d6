"""Atlas: the multi-map container of failure recovery (host side; a copy of
``tc2li_slam_tpu/slam/atlas.py``).

On unrecoverable tracking loss the system freezes the active map and starts
a fresh one (``Tracking::CreateMapInAtlas``); an active map with fewer than
``min_kf`` keyframes is discarded instead (``ResetActiveMap``). A "map" is
the bundle of fixed-capacity pools the system tracks; a frozen bundle keeps
its tensors on the system's device. The new map is anchored at the last
tracked pose, so the exported trajectory stays continuous across
recoveries.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

from . import mapstate


@dataclass
class MapBundle:
    """Everything that constitutes one sub-map."""

    map: mapstate.MapState
    lidar_store: Any = None       # local_mapping.LidarStore | None
    kf_words: Any = None          # [K, F] int32 | None
    imu_store: Any = None         # imu_mode.ImuKfStore | None (IMU mode)
    n_kf: int = 0                 # host mirror of map.n_kf
    map_id: int = 0               # creation index in the atlas


@dataclass
class Atlas:
    """Active map + frozen history."""

    frozen: list[MapBundle] = field(default_factory=list)
    n_created: int = 1            # maps ever created, the active one included
    n_discarded: int = 0

    def freeze_or_discard(self, bundle: MapBundle, min_kf: int = 10) -> bool:
        """Keep a map worth keeping: True if frozen, False if discarded."""
        self.n_created += 1
        if bundle.n_kf >= min_kf:
            self.frozen.append(bundle)
            return True
        self.n_discarded += 1
        return False

    @property
    def n_maps(self) -> int:
        """Live maps: the frozen ones and the active one."""
        return len(self.frozen) + 1
