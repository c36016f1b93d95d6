"""Shared helpers of the parity tests between ``tc2li_slam_tpu`` (JAX, the
reference) and ``tc2li_slam_torch`` (the PyTorch port).

Inputs are made with numpy from a seed and handed to both packages; JAX
runs on the CPU (tests/conftest.py), torch on the CPU with one thread so
the test workers do not oversubscribe the cores. On the CPU every port
kernel runs its plain PyTorch version. The synthetic sequences come from
the port's copy of the generator, so this module imports no jax (the
card-side tests use it too); ``test_torch_system`` checks the copy
against the JAX package's.
"""

from __future__ import annotations

import contextlib
import functools

import numpy as np
import torch

torch.set_num_threads(1)


def t(a, dtype=None) -> torch.Tensor:
    """numpy -> CPU torch tensor (uint32 words become int32 bit patterns)."""
    a = np.array(a)  # a writable copy (JAX hands out read-only buffers)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    out = torch.as_tensor(a)
    return out if dtype is None else out.to(dtype)


def n(x) -> np.ndarray:
    """torch tensor or JAX array -> numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def words_u32(x) -> np.ndarray:
    """Descriptor words of either package as uint32."""
    a = n(x)
    return a.view(np.uint32) if a.dtype == np.int32 else a.astype(np.uint32)


def random_words(rng, shape) -> np.ndarray:
    return rng.integers(0, 1 << 32, shape, dtype=np.uint64).astype(np.uint32)


def random_poses(rng, k: int, rot: float = 0.3, trans: float = 1.0) -> np.ndarray:
    """[k, 4, 4] float32 SE3 poses."""
    from tc2li_slam_torch.io.synthetic import so3_exp_np
    T = np.tile(np.eye(4), (k, 1, 1))
    for i in range(k):
        T[i, :3, :3] = so3_exp_np(rng.normal(0, rot, 3))
        T[i, :3, 3] = rng.normal(0, trans, 3)
    return T.astype(np.float32)


def small_config(mod, n_frames_kf: int = 2, lidar: bool = True):
    """tests/test_e2e.py's SMALL configuration (640x240, 512 features,
    4 levels) for either package, triangulation off, short keyframe interval."""
    from tc2li_slam_torch.io import synthetic as syn
    cam = syn.SMALL
    return mod.SystemConfig(
        camera=mod.CameraConfig(fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy, width=cam.width,
                                height=cam.height, baseline=cam.baseline, th_depth=17.5),
        orb=mod.OrbConfig(n_features=512, n_levels=4),
        lidar=mod.LidarConfig(enabled=lidar, map_capacity=1 << 16, kf_points=512,
                              balm_max_voxels=256, scan_voxel=0.4, map_voxel=0.4, blind=1.0,
                              w_lba=0.01, T_cl=np.linalg.inv(syn.body_from_cam())),
        tracking=mod.TrackingConfig(max_kf=64, max_lm=4096, max_obs=8,
                                    kf_max_interval=n_frames_kf, local_window=6, ba_iters=6,
                                    min_inliers=25, triangulate=False),
    )


@functools.lru_cache(maxsize=None)
def small_sequence(n_frames: int):
    from tc2li_slam_torch.io import synthetic as syn
    frames, _, _ = syn.generate_sequence(n_frames=n_frames, cam=syn.SMALL, seed=0, n_scan=2048)
    return frames


def jax_midsequence(n_frames: int = 5):
    """Run the JAX System over the first ``n_frames`` SMALL frames and
    return it (mapping flushed), for tests that start both packages from
    the same mid-sequence state."""
    from tc2li_slam_tpu.slam import config as jcfg, system as jsys
    frames = small_sequence(n_frames + 1)
    s = jsys.System(small_config(jcfg))
    for fr in frames[:n_frames]:
        s.track(fr.img_l, fr.img_r, fr.t, fr.scan, fr.scan_valid)
    s.flush_mapping()
    return s, frames


@contextlib.contextmanager
def gloo_mesh(tmpdir):
    """A world-size-1 gloo process group (``parallel.dist_ba.Mesh``) made
    from a file store in ``tmpdir`` (no TCP port), destroyed on exit."""
    from tc2li_slam_torch.parallel import dist_ba
    mesh = dist_ba.make_mesh("gloo", f"file://{tmpdir}/store", 0, 1)
    try:
        yield mesh
    finally:
        torch.distributed.destroy_process_group()
