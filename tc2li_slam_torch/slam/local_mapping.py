"""Local mapping: per-keyframe LiDAR store and the windowed LiDAR-visual
BA (port of the single-device half of ``tc2li_slam_tpu/slam/local_mapping.py``).

The local BA is ``LocalLVBundleAdjustment``: the covisibility window's
poses + landmarks with reprojection factors, plus the BALM eigen-factor over
the window's last ``balm_window`` keyframes, injected into the reduced
camera system as a dense quadratic. The landmark budget is the plain cap
``max_active`` (no power-of-2 buckets: nothing here compiles per shape).
With a ``mesh`` the same problem goes through ``parallel.dist_ba``: the
landmarks are sharded over the process group's ranks.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from ..geom import camera as cam_mod, lie
from ..parallel import dist_ba
from ..solver import balm as balm_mod, lm as lm_mod
from ..tensors import to_device
from . import mapstate


@dataclass(frozen=True)
class LidarStore:
    """Per-keyframe LiDAR surf points (LiDAR frame), fixed capacity."""

    points: torch.Tensor   # [K, Ms, 3]
    valid: torch.Tensor    # [K, Ms] bool

    @staticmethod
    def create(max_kf: int, n_points: int, device) -> "LidarStore":
        return LidarStore(
            torch.zeros((max_kf, n_points, 3), dtype=torch.float32, device=device),
            torch.zeros((max_kf, n_points), dtype=torch.bool, device=device))

    def set_kf(self, kf_id: int, pts, valid) -> "LidarStore":
        points = self.points.clone()
        points[kf_id] = pts
        v = self.valid.clone()
        v[kf_id] = valid
        return LidarStore(points, v)

    def replace(self, **kw) -> "LidarStore":
        return dataclasses.replace(self, **kw)


def select_window(n_window: int, kf_id: int, n_kf: int, alive, covis):
    """Covisibility window KF ids (host): the new KF + its best covisible
    neighbours (``covis`` = host lists (neigh, weight) of
    ``mapstate.top_covisible(m, kf_id, n_window - 1, min_weight=10)``), with
    a temporal fallback over alive keyframes. Returns (window, fixed), both
    of exactly ``n_window`` entries, NO_KF-padded; the oldest real KF and
    the padding are fixed."""
    neigh, w = covis
    neigh = [int(i) for i, ww in zip(neigh, w) if i >= 0 and ww > 0]
    if alive is not None:
        neigh = [i for i in neigh if alive[i]]
    window = sorted(set([kf_id] + neigh))
    want = min(n_window, n_kf)
    i = kf_id - 1
    while len(window) < want and i >= 0:
        if i not in window and (alive is None or alive[i]):
            window.append(i)
        i -= 1
    window = sorted(window)[:n_window]
    fixed = [w == window[0] for w in window]
    pad = n_window - len(window)
    return window + [mapstate.NO_KF] * pad, fixed + [True] * pad


def _balm_extra(T_cw_win, clusters, pos_in_win, lvalid, T_cl, w_lba: float):
    """BALM quadratic transported to window pose tangents:
    (H [6P, 6P], g [6P], cost)."""
    P = T_cw_win.shape[0]
    n_l = pos_in_win.shape[0]
    dt, dev = T_cw_win.dtype, T_cw_win.device
    # left tangent of T_cw -> right tangent of T_wl = T_cw^-1 T_cl: -Adj(T_lc)
    C1 = -lie.se3_adjoint(lie.se3_inverse(T_cl))
    T_wl = lie.se3_inverse(T_cw_win[pos_in_win]) @ T_cl
    q = balm_mod.quadratic(clusters, T_wl)
    Hq = q.H.reshape(n_l, 6, n_l, 6)
    gq = q.g.reshape(n_l, 6)
    Ht = torch.einsum("ki,akbl,lj->abij", C1, Hq, C1)
    gt = torch.einsum("ki,ak->ai", C1, gq)
    lw = lvalid.to(dt)
    Ht = Ht * lw[:, None, None, None] * lw[None, :, None, None]
    gt = gt * lw[:, None]
    rows = pos_in_win[:, None] * 6 + torch.arange(6, device=dev)[None, :]
    H = torch.zeros((6 * P, 6 * P), dtype=dt, device=dev)
    H.index_put_((rows[:, :, None, None], rows[None, None, :, :]),
                 Ht.permute(0, 2, 1, 3) * w_lba, accumulate=True)
    g = torch.zeros(6 * P, dtype=dt, device=dev)
    g.index_put_((rows.reshape(-1),), gt.reshape(-1) * w_lba, accumulate=True)
    return H, g, q.cost * w_lba


def _ba_prep(m: mapstate.MapState, window_arr, sigma2, max_active: int):
    """Window observation table + landmark compaction to ``max_active``."""
    wvalid = window_arr != mapstate.NO_KF
    win_pos, uvr, inv_sigma2, stereo, ok = mapstate.landmark_major_obs(m, window_arr, sigma2)
    lm_active_full = torch.any(ok, dim=1) & m.lm_valid
    sel = torch.sort((~lm_active_full).to(torch.uint8), stable=True).indices[:max_active]
    obs = lm_mod.BAObservations(pose_idx=win_pos[sel], uv=uvr[sel],
                                inv_sigma2=inv_sigma2[sel], stereo=stereo[sel],
                                valid=ok[sel])
    T0 = torch.where(wvalid[:, None, None],
                     m.kf_T_cw[torch.clamp(window_arr, 0, m.K - 1).long()],
                     torch.eye(4, dtype=m.kf_T_cw.dtype, device=m.device))
    return obs, lm_active_full[sel], sel, T0, m.lm_pos[sel], wvalid


def _balm_extra_fn(m, lidar: LidarStore, lidx, pos_in_win, T_cl, w_lba: float,
                   balm_voxel: float, balm_max_voxels: int, balm_min_points: int):
    """Clusters of the window's LiDAR keyframes, and the extra-term callable."""
    lvalid = lidx != mapstate.NO_KF
    lidx_c = torch.clamp(lidx, 0, m.K - 1).long()
    T_cw_l = torch.where(lvalid[:, None, None], m.kf_T_cw[lidx_c],
                         torch.eye(4, dtype=m.kf_T_cw.dtype, device=m.device))
    clusters = balm_mod.build_clusters(
        lidar.points[lidx_c], lidar.valid[lidx_c] & lvalid[:, None],
        lie.se3_inverse(T_cw_l) @ T_cl, voxel_size=balm_voxel,
        max_voxels=balm_max_voxels, min_points=balm_min_points)

    def extra_fn(T_cw_win):
        return _balm_extra(T_cw_win, clusters, pos_in_win, lvalid, T_cl, w_lba)

    return extra_fn


def run_local_ba(m: mapstate.MapState, lidar: LidarStore | None, cam: cam_mod.Pinhole,
                 sigma2, T_cl, window: list[int], fixed: list[bool],
                 balm_window: int = 6, balm_voxel: float = 1.0,
                 balm_max_voxels: int = 512, balm_min_points: int = 15,
                 w_lba: float = 0.01, iters: int = 8,
                 max_active: int = 8192, mesh: dist_ba.Mesh | None = None) -> mapstate.MapState:
    """One LocalLVBundleAdjustment pass over ``window`` (host list from
    ``select_window``); returns the map with refined poses and landmarks.

    With ``mesh`` the landmarks are sharded over its ranks and the reduced
    camera system is summed over them (``dist_ba.optimize``); every rank
    holds the same map and gets the same result."""
    dev = m.device
    window_arr = to_device(window, torch.int32, dev)
    fixed_arr = to_device(fixed, torch.bool, dev)
    use_balm = lidar is not None and w_lba > 0
    bw = min(balm_window, len(window))
    lidar_ids = [i for i in window if i != mapstate.NO_KF][-bw:]
    pos_list = [window.index(i) for i in lidar_ids]
    lidar_ids += [mapstate.NO_KF] * (bw - len(lidar_ids))
    pos_list += [0] * (bw - len(pos_list))

    obs, lm_active, sel, T0, X0, wvalid = _ba_prep(m, window_arr, sigma2, max_active)
    extra_fn = None
    if use_balm:
        extra_fn = _balm_extra_fn(
            m, lidar, to_device(lidar_ids, torch.int32, dev),
            to_device(pos_list, torch.int64, dev), T_cl, w_lba,
            balm_voxel, balm_max_voxels, balm_min_points)
    if mesh is None:
        res_T, res_X, _ = lm_mod.local_ba(cam, T0, X0, obs, fixed_arr, lm_active, iters=iters,
                                          extra_fn=extra_fn)
    else:
        X_s, obs_s, act_s = dist_ba.shard_problem(mesh, X0, obs, lm_active)
        res_T, X_s, _ = dist_ba.optimize(mesh, cam, T0, X_s, obs_s, act_s, fixed_arr,
                                         iters=iters, extra_fn=extra_fn)
        # every rank's replica takes the whole landmark result
        res_X = dist_ba.all_gather_rows(mesh, X_s, X0.shape[0])
    new_T = mapstate.set_rows_drop(m.kf_T_cw, torch.where(wvalid, window_arr, m.K), res_T)
    new_X = m.lm_pos.clone()
    new_X[sel] = torch.where(lm_active[:, None], res_X, m.lm_pos[sel])
    return m.replace(kf_T_cw=new_T, lm_pos=new_X)
