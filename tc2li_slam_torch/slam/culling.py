"""Map hygiene: landmark culling, keyframe culling, duplicate fusion
(port of ``tc2li_slam_tpu/slam/culling.py``)."""

from __future__ import annotations

import torch

from ..geom import camera as cam_mod, lie
from ..ops import matching
from ..tensors import count
from . import mapstate
from .tracking import predict_level, scale_gate


def cull_landmarks(m: mapstate.MapState, current_kf: int) -> mapstate.MapState:
    """MapPointCulling: found/visible < 0.25, or <= 2 observations three
    keyframes after birth; landmarks younger than 2 keyframes are kept."""
    ratio = m.lm_found.to(torch.float32) / torch.clamp(m.lm_visible, min=1)
    age = current_kf - m.lm_first_kf
    kill = m.lm_valid & ((ratio < 0.25) | ((age >= 3) & (m.lm_n_obs <= 2)))
    kill = kill & ~(age < 2)
    return mapstate.remove_landmarks(m, kill)


def keyframe_redundancy(m: mapstate.MapState) -> torch.Tensor:
    """[K] share of each KF's landmarks observed by >= 4 KFs."""
    lm = torch.clamp(m.kf_feat_lm, 0, m.L - 1).long()
    linked = (m.kf_feat_lm != mapstate.NO_LM) & m.kf_feat_valid & m.lm_valid[lm]
    redundant = linked & (m.lm_n_obs[lm] >= 4)
    return count(redundant, dim=1) / torch.clamp(count(linked, dim=1), min=1)


def cull_keyframes(m: mapstate.MapState, protect: torch.Tensor, thresh: float = 0.9):
    """Invalidate the most redundant unprotected keyframe (at most one).
    Returns (map', killed) with killed a device scalar, -1 for none."""
    red = keyframe_redundancy(m)
    cand = m.kf_valid & (red > thresh) & ~protect
    red_m = torch.where(cand, red, -1.0)
    best = torch.argmax(red_m).reshape(1)
    hit = red_m.gather(0, best) > 0
    kill = torch.zeros(m.K, dtype=torch.bool, device=m.device).index_put((best,), hit)
    killed = torch.where(hit, best, -1).to(torch.int32)[0]
    return remove_keyframes(m, kill), killed


def remove_keyframes(m: mapstate.MapState, kill: torch.Tensor) -> mapstate.MapState:
    obs_kf = m.lm_obs_kf
    obs_bad = (obs_kf != mapstate.NO_KF) & kill[torch.clamp(obs_kf, 0, m.K - 1).long()]
    new_obs_kf = torch.where(obs_bad, mapstate.NO_KF, obs_kf)
    n_obs = count(new_obs_kf != mapstate.NO_KF, dim=1)
    return m.replace(kf_valid=m.kf_valid & ~kill, lm_obs_kf=new_obs_kf, lm_n_obs=n_obs)


def fuse_duplicates(m: mapstate.MapState, radius: float = 0.25,
                    max_hamming: int = 50) -> mapstate.MapState:
    """Merge landmark duplicates (close in 3D + matching descriptors) into
    the oldest instance; O(L^2), for small pools."""
    L = m.L
    d2 = torch.sum((m.lm_pos[:, None, :] - m.lm_pos[None, :, :]) ** 2, dim=-1)
    both = m.lm_valid[:, None] & m.lm_valid[None, :]
    ham = matching.hamming_matrix(m.lm_desc, m.lm_desc)
    same = (d2 < radius * radius) & both & (ham <= max_hamming)
    ids = torch.arange(L, device=m.device)
    age = m.lm_first_kf
    older = (age[None, :] < age[:, None]) | ((age[None, :] == age[:, None])
                                             & (ids[None, :] < ids[:, None]))
    cand = same & older
    first = torch.argmax(cand.to(torch.uint8), dim=1)
    has = torch.any(cand, dim=1)
    target = torch.where(has, first, ids)
    linked = m.kf_feat_lm != mapstate.NO_LM
    lm_c = torch.clamp(m.kf_feat_lm, 0, L - 1).long()
    new_links = torch.where(linked, target[lm_c].to(torch.int32), m.kf_feat_lm)
    lm_valid = m.lm_valid & ~has
    found = m.lm_found.index_add(0, target, torch.where(has, m.lm_found, 0))
    visible = m.lm_visible.index_add(0, target, torch.where(has, m.lm_visible, 0))
    return m.replace(kf_feat_lm=new_links, lm_valid=lm_valid, lm_found=found,
                     lm_visible=visible, n_lm=count(lm_valid))


def fuse_into_keyframe(m: mapstate.MapState, kf_id: int, cam: cam_mod.Pinhole,
                       scale_factors) -> mapstate.MapState:
    """SearchInNeighbors' Fuse, keyframe-centric: project every landmark
    into ``kf_id`` and match; a match to a feature linked to another
    landmark merges the younger into the older, a match to an unlinked
    feature adds an observation."""
    kfc = min(max(int(kf_id), 0), m.K - 1)
    Xc = lie.se3_apply(m.kf_T_cw[kfc], m.lm_pos)
    uv = cam_mod.project(cam, Xc)
    dist, dist_ok = scale_gate(m, Xc)
    cand = m.lm_valid & (Xc[:, 2] > 0.1) & cam_mod.in_image(cam, uv) & dist_ok
    pred_level = predict_level(m, dist, scale_factors)
    rad = 3.0 * scale_factors[pred_level.long()]
    kp_idx, dist_h, matched = matching.search_by_projection(
        uv, pred_level, m.lm_desc, cand, m.kf_xy[kfc], m.kf_level[kfc], m.kf_desc[kfc],
        m.kf_feat_valid[kfc], rad, max_dist=matching.TH_LOW, ratio=1.0)
    matched = matching.resolve_duplicates(kp_idx, dist_h, matched, m.F)

    L = m.L
    ids = torch.arange(L, device=m.device)
    cur = m.kf_feat_lm[kfc][torch.clamp(kp_idx, 0, m.F - 1)]
    cur_c = torch.clamp(cur, 0, L - 1).long()
    conflict = matched & (cur != mapstate.NO_LM) & (cur_c != ids) & m.lm_valid[cur_c]
    self_older = (m.lm_first_kf < m.lm_first_kf[cur_c]) | (
        (m.lm_first_kf == m.lm_first_kf[cur_c]) & (ids < cur_c))
    dead = torch.where(self_older, cur_c, ids)
    surv = torch.where(self_older, ids, cur_c)
    drop = torch.where(conflict, dead, L)
    target = torch.cat([ids, ids[:1]])
    target[drop] = torch.where(conflict, surv, 0)
    target = target[:L]
    dead_mask = torch.zeros(L + 1, dtype=torch.bool, device=m.device)
    dead_mask[drop] = conflict
    dead_mask = dead_mask[:L]
    linked = m.kf_feat_lm != mapstate.NO_LM
    lm_links = torch.clamp(m.kf_feat_lm, 0, L - 1).long()
    new_links = torch.where(linked, target[lm_links].to(torch.int32), m.kf_feat_lm)
    found = m.lm_found.index_add(0, target, torch.where(dead_mask, m.lm_found, 0))
    visible = m.lm_visible.index_add(0, target, torch.where(dead_mask, m.lm_visible, 0))
    lm_valid = m.lm_valid & ~dead_mask
    m = m.replace(kf_feat_lm=new_links, lm_valid=lm_valid, lm_found=found,
                  lm_visible=visible, n_lm=count(lm_valid))
    extend = matched & (cur == mapstate.NO_LM) & lm_valid
    return mapstate.link_observations(m, kfc, kp_idx, ids.to(torch.int32), extend)
