"""Loop closing: detection, Sim3 verification, correction, pose graph
(port of ``tc2li_slam_tpu/slam/loop_closing.py``; the structure follows
ORB-SLAM's LoopClosing pipeline).

1. candidate detection: shared-word BoW scoring against all keyframes,
   excluding the current covisibility neighbourhood;
2. geometric verification: descriptor matching between the two keyframes'
   landmarks + batched Sim3/SE3 RANSAC on the 3D-3D pairs;
3. correction: essential-graph relaxation, a Sim3 pose graph over the
   temporal chain + strong covisibility edges + the loop edge, after which
   each landmark moves with its first observing keyframe.

Detection runs at every keyframe, so its whole gating ladder is tensor code
on the device (``detect_candidates_device``); ``detect_candidates`` reads the
result with one transfer. A closure is a rare event and reads what it needs
(the verdict of the verification, the neighbour table of the edge list) in
one transfer each.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..geom import lie
from ..ops import bow, matching
from ..solver import sim3 as sim3_mod
from ..tensors import to_device
from . import mapstate


class LoopCandidate(NamedTuple):
    kf_id: int
    S_cur_from_cand: torch.Tensor   # [4, 4] packed (scale * R | t)
    n_inliers: int


def detect_candidates_device(m: mapstate.MapState, kf_id: int, kf_words: torch.Tensor,
                             min_gap: int = 20, n_best: int = 3,
                             word_weights: torch.Tensor | None = None,
                             n_kf: int | None = None) -> torch.Tensor:
    """BoW loop candidates for keyframe ``kf_id`` as a device tensor
    [n_best] int32, best first, -1 where there is none; the gating ladder of
    KeyFrameDatabase::DetectLoopCandidates:

    1. shared-word counts against every keyframe, excluding the recent
       temporal neighbourhood and the query's covisibility neighbourhood;
    2. the min-common-words gate at 0.8 x the best count (at least 15);
    3. per candidate the score accumulated over its covisibility group (the
       candidate + those of its 10 best covisible keyframes that are
       candidates too), keeping the best keyframe of each group;
    4. groups must reach 0.75 x the best accumulated score.

    ``kf_words`` is [K, F] sorted word ids, ``word_weights`` [n_words] the
    idf per word id (a shared rare word is evidence of a revisit, a shared
    common one is not). ``n_kf`` (a host int, keyframe slots in use) bounds
    the covisibility table; every slot counts when it is None. Scores are
    accumulated in float64, as the reference does on the host."""
    K, dev = m.K, m.device
    wq = torch.sort(kf_words[kf_id]).values
    if word_weights is not None:
        qweights = torch.where(
            wq >= 0, word_weights[torch.clamp(wq, 0, word_weights.shape[0] - 1).long()], 0.0)
    else:
        qweights = (wq >= 0).to(torch.float32)
    counts, scores = bow.shared_word_scores(wq, qweights, kf_words, m.kf_valid)
    covis_w = mapstate.covisibility_weights(m, kf_id)
    ids = torch.arange(K, device=dev)
    # exclusions: self, temporal neighbourhood, covisible neighbourhood
    excl = (torch.abs(ids - kf_id) < min_gap) | (covis_w >= 15)
    counts = torch.where(excl, 0, counts)
    scores = torch.where(excl, 0.0, scores.to(torch.float64))
    max_common = torch.max(counts)
    # counts > 0.8 max_common, in integers
    cand = (5 * counts > 4 * max_common) & (max_common >= 15)

    # covisibility-group score accumulation over all keyframe rows at once
    R = K if n_kf is None else max(1, min(int(n_kf), K))
    nb, _ = mapstate.top_covisible_table(m, R, 10, min_weight=15)
    group = torch.cat([ids[:R, None], nb.long()], dim=1)           # [R, 11], self first
    member = group >= 0
    gc = torch.clamp(group, min=0)
    member[:, 1:] &= cand[gc[:, 1:]]
    gs = scores[gc]
    acc = torch.sum(torch.where(member, gs, 0.0), dim=1)
    # the first maximum in group order (the candidate itself wins a tie)
    pos = torch.argmax(torch.where(member, gs, -torch.inf), dim=1)
    best_kf = torch.gather(group, 1, pos[:, None])[:, 0]
    is_cand = cand[:R]
    best_acc = torch.max(torch.where(is_cand, acc, 0.0))
    keep_row = is_cand & (acc >= 0.75 * best_acc)
    keep = torch.zeros(K + 1, dtype=torch.bool, device=dev).index_fill(
        0, torch.where(keep_row, best_kf, K), True)[:K]
    # kept keyframes by falling score, ties to the lower id
    order = torch.sort(torch.where(keep, -scores, torch.inf), stable=True).indices[:n_best]
    return torch.where(keep[order], order, -1).to(torch.int32)


def detect_candidates(m: mapstate.MapState, kf_id: int, kf_words: torch.Tensor,
                      min_gap: int = 20, n_best: int = 3,
                      word_weights: torch.Tensor | None = None,
                      n_kf: int | None = None) -> list[int]:
    """``detect_candidates_device`` read to a host list (one transfer)."""
    out = detect_candidates_device(m, kf_id, kf_words, min_gap, n_best, word_weights, n_kf)
    return [c for c in out.tolist() if c >= 0]


def verify_candidate(m: mapstate.MapState, kf_id: int, cand_id: int,
                     generator: torch.Generator | None = None, with_scale: bool = False,
                     min_inliers: int = 20, sample_idx: torch.Tensor | None = None):
    """Descriptor match between the keyframes' landmarks + Sim3 RANSAC.

    Returns (ok, S_cur_from_cand [4, 4], n_inliers, (lm_a, lm_b, inliers));
    S maps candidate-camera coordinates to current-camera coordinates. The
    hypotheses are drawn from ``generator`` or given as ``sample_idx``
    [128, 3]. One transfer reads ok and the inlier count."""
    la, lb = m.kf_feat_lm[kf_id], m.kf_feat_lm[cand_id]
    va = m.kf_feat_valid[kf_id] & (la != mapstate.NO_LM)
    vb = m.kf_feat_valid[cand_id] & (lb != mapstate.NO_LM)
    idx, _, okm = matching.match_descriptors(
        m.kf_desc[kf_id], m.kf_desc[cand_id], va, vb, max_dist=matching.TH_LOW, ratio=0.75,
        mutual=True)
    lm_a = torch.clamp(la, 0, m.L - 1).long()
    lm_b = torch.clamp(lb[idx], 0, m.L - 1).long()
    pair_ok = okm & m.lm_valid[lm_a] & m.lm_valid[lm_b]
    # 3D positions in each keyframe's camera frame
    Xa = lie.se3_apply(m.kf_T_cw[kf_id], m.lm_pos[lm_a])
    Xb = lie.se3_apply(m.kf_T_cw[cand_id], m.lm_pos[lm_b])
    res = sim3_mod.sim3_ransac(Xb, Xa, pair_ok, generator, with_scale=with_scale,
                               min_inliers=min_inliers, sample_idx=sample_idx)
    ok, n_inl = torch.stack([res.ok.to(torch.int32), res.n_inliers]).tolist()
    return bool(ok), res.S, n_inl, (lm_a, lm_b, res.inliers)


def loop_edges(m: mapstate.MapState, kf_id: int, cand_id: int, S_cur_from_cand: torch.Tensor,
               n_kf: int) -> sim3_mod.PoseGraphEdges:
    """The essential graph of a closure: the temporal chain over every slot
    below ``n_kf`` (culled keyframes included), the covisible pairs of
    weight >= 100 among alive keyframes (each pair once, neighbours in the
    chain left out), and the loop edge with weight 5. The neighbour table
    and the alive mask come to the host in one transfer; the relative
    transforms are computed on the device."""
    nb, _ = mapstate.top_covisible_table(m, n_kf, 8, min_weight=100)
    host = torch.cat([m.kf_valid[:n_kf].to(torch.int32), nb.reshape(-1)]).tolist()
    alive, nb = host[:n_kf], host[n_kf:]
    ii = list(range(n_kf - 1))
    jj = list(range(1, n_kf))
    seen = set()
    for i in range(n_kf):
        if not alive[i]:
            continue
        for j in nb[8 * i:8 * i + 8]:
            if j < 0 or j == i or abs(j - i) == 1 or not alive[j]:
                continue
            pair = (min(i, j), max(i, j))
            if pair in seen:
                continue
            seen.add(pair)
            ii.append(i)
            jj.append(j)
    dev = m.device
    i_t = to_device(ii + [kf_id], torch.int32, dev)
    j_t = to_device(jj + [cand_id], torch.int32, dev)
    T = m.kf_T_cw
    S_ij = T[i_t[:-1].long()] @ lie.se3_inverse(T[j_t[:-1].long()])
    E = len(ii) + 1
    weight = torch.ones(E, dtype=torch.float32, device=dev)
    weight[-1:].fill_(5.0)
    return sim3_mod.PoseGraphEdges(
        i=i_t, j=j_t, S_ij=torch.cat([S_ij, S_cur_from_cand[None].to(T.dtype)]), weight=weight,
        valid=torch.ones(E, dtype=torch.bool, device=dev))


def close_loop(m: mapstate.MapState, kf_id: int, cand_id: int, S_cur_from_cand: torch.Tensor,
               iters: int = 15, n_kf: int | None = None) -> mapstate.MapState:
    """Correct the poses through a Sim3 pose graph and re-map the landmarks.

    ``S_cur_from_cand`` is the verified S_i S_j^-1 of the loop edge
    (kf_id, cand_id). After the optimization each landmark is re-expressed
    through its first observing keyframe. ``n_kf`` is the host's count of
    keyframe slots in use (read from the map when None)."""
    K = m.K
    if n_kf is None:
        n_kf = int(m.n_kf)
    S_w = m.kf_T_cw   # packed SE3 poses are Sim3 poses of scale 1
    edges = loop_edges(m, kf_id, cand_id, S_cur_from_cand, n_kf)
    # Only the loop candidate and the never-used tail slots are anchored.
    # Culled keyframes stay free vertices: they sit on the temporal chain and
    # their frozen poses still anchor the per-frame trajectory; holding them
    # fixed pins the whole drifted segment through their chain edges and
    # cancels the correction.
    ids = torch.arange(K, device=m.device)
    fixed = (ids == cand_id) | (ids >= n_kf)
    S_new = sim3_mod.pose_graph_optimize(S_w, edges, fixed, iters=iters)

    # landmarks through their first observing keyframe: X' = S'_ref^-1 S_ref X
    ref = torch.clamp(m.lm_first_kf, 0, K - 1).long()
    Xc = lie.sim3_apply(S_w[ref], m.lm_pos)
    X_new = lie.sim3_apply(lie.sim3_inverse(S_new[ref]), Xc)
    X_new = torch.where(m.lm_valid[:, None], X_new, m.lm_pos)

    # corrected Sim3 back to SE3: T = [R | t / s]
    s = lie.sim3_scale(S_new)
    t = lie.translation(S_new) / torch.clamp(s, min=1e-9)[:, None]
    T_new = lie.se3(lie.sim3_rotation(S_new), t)
    T_new = torch.where(m.kf_valid[:, None, None], T_new, m.kf_T_cw)
    return m.replace(kf_T_cw=T_new, lm_pos=X_new)
