"""Relocalization: BoW candidates + descriptor matching + batched PnP RANSAC
(port of ``tc2li_slam_tpu/slam/relocalization.py``; ``Tracking::Relocalization``).

Quantize the lost frame, take candidate keyframes from shared-word scoring,
match the frame against the landmarks seen from each candidate (the fused
matcher, mutual, the pool as side 2), solve PnP RANSAC per candidate, and
refine the best pose with windowed tracking passes. The path is host-gated:
it reads a scalar per candidate, as the reference does.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..geom import camera as cam_mod
from ..ops import bow, matching
from ..solver import pnp
from ..tensors import to_device
from . import mapstate, tracking


class RelocResult(NamedTuple):
    ok: bool
    T_cw: torch.Tensor
    feat_lm: torch.Tensor | None
    n_inliers: int


def relocalize(m: mapstate.MapState, frame: tracking.Frame, cam: cam_mod.Pinhole,
               voc: bow.Vocabulary, kf_words: torch.Tensor, sigma2,
               generator: torch.Generator | None = None, n_candidates: int = 5,
               min_inliers: int = 30, sample_idx=None) -> RelocResult:
    """Full relocalization attempt for a lost frame.

    ``kf_words`` [K, F] holds each keyframe's sorted word ids. The PnP
    hypotheses come from ``generator``, or from ``sample_idx``: a list with
    one [128, 6] index tensor per candidate that reaches PnP."""
    dev = m.device
    eye = torch.eye(4, dtype=torch.float32, device=dev)
    words, weights = bow.quantize(voc, frame.desc, frame.valid, voc.depth)
    counts, scores = bow.shared_word_scores(words, weights, kf_words, m.kf_valid)
    cand, _ = bow.reloc_candidates(counts, scores, n_candidates)
    cand_ids = [c for c in cand.tolist() if c >= 0]
    if not cand_ids:
        return RelocResult(False, eye, None, 0)

    best = None
    samples = iter(sample_idx) if sample_idx is not None else None
    for kf_id in cand_ids:
        # the landmarks observed from the candidate: their descriptors age
        # better across a viewpoint gap than the candidate's own features
        seen = torch.any(m.lm_obs_kf == kf_id, dim=1) & m.lm_valid
        lm_idx, _, okm = matching.match_descriptors(
            frame.desc, m.lm_desc, frame.valid, seen,
            max_dist=matching.TH_LOW, ratio=0.8, mutual=True)
        if int(torch.sum(okm)) < 12:
            continue
        lm_ids = torch.where(okm, lm_idx, mapstate.NO_LM).to(torch.int32)
        has = lm_ids != mapstate.NO_LM
        X = m.lm_pos[torch.clamp(lm_ids, 0, m.L - 1).long()]
        res = pnp.pnp_ransac(cam, X, frame.xy, has, generator, n_hyp=128,
                             min_inliers=min_inliers // 2,
                             sample_idx=None if samples is None else next(samples))
        n_inl, ok = torch.stack([res.n_inliers, res.ok.to(torch.int32)]).tolist()
        if ok and (best is None or n_inl > best[0]):
            best = (n_inl, res.T_cw, torch.where(res.inliers, lm_ids, mapstate.NO_LM))

    if best is None or best[0] < min_inliers // 2:
        return RelocResult(False, eye, None, 0 if best is None else best[0])

    # windowed refinement at the PnP pose: widen the window 10 -> 15 px and
    # re-optimise up to two more times while the inlier count improves
    sf = to_device([1.2 ** i for i in range(8)], torch.float32, dev)
    res2 = tracking.track_frame(m, frame, best[1], cam, sf, sigma2, 10.0)
    n2 = int(res2.n_inliers)
    if n2 < 50:
        for _ in range(2):
            T_seed = res2.T_cw if n2 >= min_inliers // 2 else best[1]
            res_w = tracking.track_frame(m, frame, T_seed, cam, sf, sigma2, 15.0)
            n_w = int(res_w.n_inliers)
            if n_w <= n2:
                break   # the same seed at the same radius would repeat itself
            res2, n2 = res_w, n_w
            if n2 >= 50:
                break
    if n2 >= min_inliers:
        return RelocResult(True, res2.T_cw, res2.feat_lm, n2)
    if best[0] >= min_inliers:
        return RelocResult(True, best[1], best[2], best[0])
    return RelocResult(False, best[1], best[2], best[0])
