"""Array-pool SLAM map: keyframes, landmarks, observations, covisibility.

Port of ``tc2li_slam_tpu/slam/mapstate.py``: fixed-capacity tensor pools
with validity masks. Updates are functional (every mutation returns a new
``MapState``; the tensors it changes are fresh copies), because the
tracker builds a candidate map that the host adopts only when the frame
tracked. Scatters that the reference writes with ``mode="drop"`` send the
dropped lanes to one scratch row past the end (``set_rows_drop``).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from ..tensors import count

NO_LM = -1
NO_KF = -1


@dataclass(frozen=True)
class MapState:
    # --- keyframes ---
    kf_T_cw: torch.Tensor       # [K, 4, 4] world->camera
    kf_valid: torch.Tensor      # [K] bool
    kf_timestamp: torch.Tensor  # [K]
    kf_xy: torch.Tensor         # [K, F, 2]
    kf_uvr: torch.Tensor        # [K, F, 3] (u, v, u_r); u_r < 0: mono
    kf_level: torch.Tensor      # [K, F] int32
    kf_angle: torch.Tensor      # [K, F]
    kf_desc: torch.Tensor       # [K, F, 8] int32 (uint32 words)
    kf_feat_valid: torch.Tensor  # [K, F] bool
    kf_feat_lm: torch.Tensor    # [K, F] int32 landmark id or NO_LM
    # --- landmarks ---
    lm_pos: torch.Tensor        # [L, 3]
    lm_desc: torch.Tensor       # [L, 8] int32
    lm_normal: torch.Tensor     # [L, 3]
    lm_dist: torch.Tensor       # [L, 2] (min, max) scale-invariance range
    lm_valid: torch.Tensor      # [L] bool
    lm_obs_kf: torch.Tensor     # [L, Ko] int32 observing KF ids (NO_KF pad)
    lm_obs_feat: torch.Tensor   # [L, Ko] int32 feature index in that KF
    lm_n_obs: torch.Tensor      # [L] int32
    lm_visible: torch.Tensor    # [L] int32
    lm_found: torch.Tensor      # [L] int32
    lm_first_kf: torch.Tensor   # [L] int32
    # --- counters (0-dim int32) ---
    n_kf: torch.Tensor
    n_lm: torch.Tensor

    @property
    def K(self) -> int:
        return self.kf_T_cw.shape[0]

    @property
    def F(self) -> int:
        return self.kf_xy.shape[1]

    @property
    def L(self) -> int:
        return self.lm_pos.shape[0]

    @property
    def Ko(self) -> int:
        return self.lm_obs_kf.shape[1]

    @property
    def device(self) -> torch.device:
        return self.lm_pos.device

    def replace(self, **kw) -> "MapState":
        return dataclasses.replace(self, **kw)


def create(max_kf: int = 512, max_feats: int = 1024, max_lm: int = 16384,
           max_obs: int = 16, *, device: torch.device | str) -> MapState:
    K, F, L, Ko = max_kf, max_feats, max_lm, max_obs
    i32, f32 = torch.int32, torch.float32

    def z(shape, dtype=f32):
        return torch.zeros(shape, dtype=dtype, device=device)

    def full(shape, v, dtype=i32):
        return torch.full(shape, v, dtype=dtype, device=device)

    return MapState(
        kf_T_cw=torch.eye(4, device=device).repeat(K, 1, 1),
        kf_valid=z(K, torch.bool), kf_timestamp=z(K),
        kf_xy=z((K, F, 2)), kf_uvr=z((K, F, 3)), kf_level=z((K, F), i32),
        kf_angle=z((K, F)), kf_desc=z((K, F, 8), i32),
        kf_feat_valid=z((K, F), torch.bool), kf_feat_lm=full((K, F), NO_LM),
        lm_pos=z((L, 3)), lm_desc=z((L, 8), i32), lm_normal=z((L, 3)),
        lm_dist=z((L, 2)), lm_valid=z(L, torch.bool),
        lm_obs_kf=full((L, Ko), NO_KF), lm_obs_feat=z((L, Ko), i32),
        lm_n_obs=z(L, i32), lm_visible=full((L,), 1), lm_found=full((L,), 1),
        lm_first_kf=z(L, i32), n_kf=z((), i32), n_lm=z((), i32),
    )


# ---------------------------------------------------------------------------
# Scatter helpers
# ---------------------------------------------------------------------------

def set_rows_drop(target: torch.Tensor, idx: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """Copy of ``target`` with ``target[idx] = rows``; indices equal to
    ``target.shape[0]`` are dropped (``.at[idx].set(rows, mode="drop")``)."""
    ext = torch.cat([target, target[:1]])
    ext.index_copy_(0, idx.long(), rows.to(target.dtype))
    return ext[:-1]


def as_index(i, device) -> torch.Tensor:
    """A host int or device scalar as a 1-element int64 index tensor."""
    if isinstance(i, torch.Tensor):
        return i.reshape(1).long()
    return torch.full((1,), int(i), dtype=torch.long, device=device)


# ---------------------------------------------------------------------------
# Keyframe insertion
# ---------------------------------------------------------------------------

def add_keyframe(m: MapState, T_cw, timestamp, xy, uvr, level, angle, desc,
                 feat_valid, feat_lm):
    """Append a keyframe; returns (map, slot [1] int64). Overflow drops it."""
    ok = m.n_kf < m.K
    slot = torch.clamp(m.n_kf, max=m.K - 1).reshape(1).long()

    def put(pool, new):
        old = pool.index_select(0, slot)[0]
        val = torch.where(ok, new.to(pool.dtype), old)
        return pool.index_copy(0, slot, val[None])

    m = m.replace(
        kf_T_cw=put(m.kf_T_cw, T_cw),
        kf_valid=put(m.kf_valid, torch.ones((), dtype=torch.bool, device=m.device)),
        kf_timestamp=put(m.kf_timestamp, timestamp),
        kf_xy=put(m.kf_xy, xy), kf_uvr=put(m.kf_uvr, uvr),
        kf_level=put(m.kf_level, level), kf_angle=put(m.kf_angle, angle),
        kf_desc=put(m.kf_desc, desc), kf_feat_valid=put(m.kf_feat_valid, feat_valid),
        kf_feat_lm=put(m.kf_feat_lm, feat_lm),
        n_kf=m.n_kf + ok.to(torch.int32),
    )
    m = _add_observations(m, slot, feat_lm, feat_valid & (feat_lm != NO_LM) & ok)
    return m, slot


def _add_observations(m: MapState, kf_id, feat_lm, mask, feat_idx=None):
    """Append (kf_id, feat_idx) to each landmark's observer table."""
    F = feat_lm.shape[0]
    dev = m.device
    if feat_idx is None:
        feat_idx = torch.arange(F, dtype=torch.int32, device=dev)
    kf = as_index(kf_id, dev).to(torch.int32)
    lm = torch.clamp(feat_lm, 0, m.L - 1).long()
    n_obs_lm = m.lm_n_obs[lm]
    slot = torch.clamp(n_obs_lm, 0, m.Ko - 1).long()
    lm_scatter = torch.where(mask, lm, m.L - 1)
    can = mask & (n_obs_lm < m.Ko)
    obs_kf = m.lm_obs_kf.clone()
    obs_kf[lm_scatter, slot] = torch.where(can, kf, obs_kf[lm_scatter, slot])
    obs_feat = m.lm_obs_feat.clone()
    obs_feat[lm_scatter, slot] = torch.where(can, feat_idx.to(torch.int32),
                                             obs_feat[lm_scatter, slot])
    n_obs = m.lm_n_obs.index_add(0, lm_scatter, can.to(torch.int32))
    return m.replace(lm_obs_kf=obs_kf, lm_obs_feat=obs_feat, lm_n_obs=n_obs)


def _set_feat_links(m: MapState, kf_id, fslot, values) -> torch.Tensor:
    """kf_feat_lm with row ``kf_id`` updated at ``fslot`` (F = dropped)."""
    kf = as_index(kf_id, m.device)
    row = torch.cat([m.kf_feat_lm.index_select(0, kf)[0],
                     torch.zeros(1, dtype=torch.int32, device=m.device)])
    row.scatter_(0, fslot.long(), values.to(torch.int32))
    return m.kf_feat_lm.index_copy(0, kf, row[None, :m.F])


# ---------------------------------------------------------------------------
# Landmark insertion
# ---------------------------------------------------------------------------

def add_landmarks(m: MapState, kf_id, feat_idx, pos, desc, normal, dist, valid):
    """Allocate new landmarks observed by (kf_id, feat_idx), lowest free
    slots first. Returns (map, lm_ids [B]) with NO_LM where not allocated."""
    dev = m.device
    kf = as_index(kf_id, dev).to(torch.int32)
    offset = torch.cumsum(valid.to(torch.int32), 0) - 1
    free_order = torch.sort(m.lm_valid.to(torch.uint8), stable=True).indices
    n_free = m.L - count(m.lm_valid)
    can = valid & (offset < n_free)
    slot = free_order[torch.clamp(offset, 0, m.L - 1).long()]
    lm_ids = torch.where(can, slot, NO_LM).to(torch.int32)
    slot = torch.where(can, slot, m.L - 1)

    first = can[:, None] & (torch.arange(m.Ko, device=dev)[None, :] == 0)
    obs_kf_row = torch.where(first, kf, torch.where(
        can[:, None], torch.full_like(m.lm_obs_kf[slot], NO_KF), m.lm_obs_kf[slot]))
    obs_feat_row = torch.where(first, feat_idx.to(torch.int32)[:, None], torch.where(
        can[:, None], torch.zeros_like(m.lm_obs_feat[slot]), m.lm_obs_feat[slot]))
    c1 = can[:, None]

    def put(pool, new):
        out = pool.clone()
        out[slot] = new.to(pool.dtype)
        return out

    one = torch.ones_like(m.lm_visible[slot])
    m = m.replace(
        lm_pos=put(m.lm_pos, torch.where(c1, pos, m.lm_pos[slot])),
        lm_desc=put(m.lm_desc, torch.where(c1, desc, m.lm_desc[slot])),
        lm_normal=put(m.lm_normal, torch.where(c1, normal, m.lm_normal[slot])),
        lm_dist=put(m.lm_dist, torch.where(c1, dist, m.lm_dist[slot])),
        lm_valid=put(m.lm_valid, can | m.lm_valid[slot]),
        lm_obs_kf=put(m.lm_obs_kf, obs_kf_row),
        lm_obs_feat=put(m.lm_obs_feat, obs_feat_row),
        lm_n_obs=put(m.lm_n_obs, torch.where(can, one, m.lm_n_obs[slot])),
        lm_first_kf=put(m.lm_first_kf, torch.where(can, kf.expand_as(one), m.lm_first_kf[slot])),
        lm_visible=put(m.lm_visible, torch.where(can, one, m.lm_visible[slot])),
        lm_found=put(m.lm_found, torch.where(can, one, m.lm_found[slot])),
        n_lm=m.n_lm + count(can),
    )
    fslot = torch.where(can, feat_idx.long(), m.F)
    return m.replace(kf_feat_lm=_set_feat_links(m, kf_id, fslot, lm_ids)), lm_ids


def link_observations(m: MapState, kf_id, feat_idx, lm_ids, mask) -> MapState:
    """Register (kf_id, feat_idx) as observers of existing landmarks."""
    can = mask & (lm_ids != NO_LM)
    fslot = torch.where(can, feat_idx.long(), m.F)
    links = _set_feat_links(m, kf_id, fslot, torch.where(can, lm_ids, NO_LM))
    m = m.replace(kf_feat_lm=links)
    return _add_observations(m, kf_id, torch.where(can, lm_ids, NO_LM), can,
                             feat_idx=feat_idx)


# ---------------------------------------------------------------------------
# Covisibility
# ---------------------------------------------------------------------------

def covisibility_weights(m: MapState, kf_id) -> torch.Tensor:
    """Shared-landmark counts between ``kf_id`` and every other KF."""
    kf = as_index(kf_id, m.device)
    lm = m.kf_feat_lm.index_select(0, kf)[0]
    seen = m.kf_feat_valid.index_select(0, kf)[0] & (lm != NO_LM)
    lm_c = torch.clamp(lm, 0, m.L - 1).long()
    obs_kf = m.lm_obs_kf[lm_c]                          # [F, Ko]
    obs_ok = (obs_kf != NO_KF) & seen[:, None] & m.lm_valid[lm_c][:, None]
    kf_idx = torch.where(obs_ok, obs_kf, m.K).long()
    w = torch.zeros(m.K + 1, dtype=torch.int32, device=m.device)
    w.index_add_(0, kf_idx.reshape(-1), obs_ok.reshape(-1).to(torch.int32))
    w = w[:m.K].index_fill(0, kf, 0)
    return torch.where(m.kf_valid, w, 0)


def top_covisible(m: MapState, kf_id, n: int, min_weight: int = 15):
    """Best-covisibility neighbour list (GetBestCovisibilityKeyFrames)."""
    w = covisibility_weights(m, kf_id)
    vals, idx = torch.sort(w, descending=True, stable=True)
    vals, idx = vals[:n], idx[:n]
    ok = vals >= min_weight
    return torch.where(ok, idx, NO_KF).to(torch.int32), vals


# ---------------------------------------------------------------------------
# Solver views
# ---------------------------------------------------------------------------

def landmark_major_obs(m: MapState, window_kf: torch.Tensor, scale_sigma2: torch.Tensor):
    """Landmark-major observation table restricted to a window:
    (win_pos, uvr, inv_sigma2, stereo, ok), each [L, Ko(, 3)]."""
    P = window_kf.shape[0]
    dev = m.device
    wvalid = window_kf != NO_KF
    kf2win = torch.full((m.K + 1,), -1, dtype=torch.int32, device=dev)
    kf2win[torch.where(wvalid, window_kf, m.K).long()] = torch.where(
        wvalid, torch.arange(P, dtype=torch.int32, device=dev), -1)
    obs_kf = torch.clamp(m.lm_obs_kf, NO_KF, m.K - 1)
    win_pos = kf2win[torch.clamp(obs_kf, 0, m.K).long()]
    ok = (obs_kf != NO_KF) & (win_pos >= 0) & m.lm_valid[:, None]
    kfc = torch.clamp(obs_kf, 0, m.K - 1).long()
    fc = torch.clamp(m.lm_obs_feat, 0, m.F - 1).long()
    uvr = m.kf_uvr[kfc, fc]
    level = m.kf_level[kfc, fc]
    ok = ok & m.kf_feat_valid[kfc, fc]
    inv_sigma2 = 1.0 / scale_sigma2[torch.clamp(level, 0, scale_sigma2.shape[0] - 1).long()]
    stereo = uvr[..., 2] > 0
    return win_pos, uvr, inv_sigma2, stereo, ok


# ---------------------------------------------------------------------------
# Landmark maintenance
# ---------------------------------------------------------------------------

def remove_landmarks(m: MapState, kill: torch.Tensor) -> MapState:
    """Invalidate landmarks and clear every keyframe link to them."""
    lm_valid = m.lm_valid & ~kill
    pointed = torch.clamp(m.kf_feat_lm, 0, m.L - 1).long()
    links_bad = (m.kf_feat_lm != NO_LM) & kill[pointed]
    return m.replace(lm_valid=lm_valid,
                     kf_feat_lm=torch.where(links_bad, NO_LM, m.kf_feat_lm),
                     n_lm=count(lm_valid))


def update_landmark_stats(m: MapState) -> MapState:
    """Refresh view normals from the mean observer direction."""
    kfc = torch.clamp(m.lm_obs_kf, 0, m.K - 1).long()
    ok = (m.lm_obs_kf != NO_KF) & m.lm_valid[:, None]
    T = m.kf_T_cw[kfc]                                    # [L, Ko, 4, 4]
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    centers = -torch.einsum("lkij,lki->lkj", R, t)
    d = m.lm_pos[:, None, :] - centers
    d = d / torch.clamp(torch.linalg.norm(d, dim=-1, keepdim=True), min=1e-9)
    n = torch.sum(torch.where(ok[..., None], d, 0.0), dim=1)
    cnt = torch.clamp(count(ok, dim=1), min=1)[:, None]
    normal = n / cnt
    return m.replace(lm_normal=torch.where(m.lm_valid[:, None], normal, m.lm_normal))
