"""New-map-point triangulation between covisible keyframe pairs (port of
``tc2li_slam_tpu/slam/triangulation.py``; ``LocalMapping::CreateNewMapPoints``).

For the new keyframe and each of its best covisible neighbours:
epipolar-gated mutual descriptor matching over the still unmatched
features, a parallax test, batched DLT triangulation, then reprojection,
positive-depth and scale-consistency checks before landmarks observed by
both views are allocated. The epipolar gate goes to the fused matcher
(``ops.kernels.match``) as an ``EpipolarMask``, the epipolar lines of the
first view's keypoints: on the card one launch a pair evaluates it per pair
and builds neither the [F, F] mask nor a distance matrix; on the CPU the
plain chain expands it. Keyframe ids are host ints, as everywhere in the
port's mapping pass.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..geom import camera as cam_mod, lie, triangulate as tri
from ..ops import matching
from ..tensors import to_device
from . import mapstate

# chi2 gate for a 2-dof reprojection residual at 95%
CHI2_MONO = 5.991
# rays closer to parallel than this triangulate badly
MIN_PARALLAX_COS = 0.9998


class PairGates(NamedTuple):
    """What a pair's matcher call takes, and what the checks after it reuse."""

    unm1: torch.Tensor         # [F] unmatched mono or far-stereo features of kf1
    unm2: torch.Tensor         # [F] ... of kf2
    epi: matching.EpipolarMask  # the epipolar gate, evaluated by the matcher per pair
    baseline_ok: torch.Tensor  # [] the keyframes are further apart than the rig's baseline
    z1s: torch.Tensor          # [F] stereo depth of kf1's features
    s2_kp2: torch.Tensor       # [F] squared level sigma of kf2's features
    c1w: torch.Tensor          # [3] camera centres in the world
    c2w: torch.Tensor


def pair_gates(m: mapstate.MapState, kf1c: int, kf2c: int, cam: cam_mod.Pinhole,
               sigma2) -> PairGates:
    """The gates of one keyframe pair: which features may match, and the
    epipolar mask between them."""
    T1, T2 = m.kf_T_cw[kf1c], m.kf_T_cw[kf2c]
    uv1, uv2 = m.kf_xy[kf1c], m.kf_xy[kf2c]
    unm1 = m.kf_feat_valid[kf1c] & (m.kf_feat_lm[kf1c] == mapstate.NO_LM)
    unm2 = m.kf_feat_valid[kf2c] & (m.kf_feat_lm[kf2c] == mapstate.NO_LM)

    # close stereo-depth features belong to stereo landmark creation; keep
    # only mono and far-stereo features
    th_close = cam_mod.f32(np.float32(12.0) * np.float32(cam.bf) / np.float32(cam.fx))
    ur1, ur2 = m.kf_uvr[kf1c][:, 2], m.kf_uvr[kf2c][:, 2]
    z1s = cam.bf / torch.clamp(uv1[:, 0] - ur1, min=1e-3)
    z2s = cam.bf / torch.clamp(uv2[:, 0] - ur2, min=1e-3)
    unm1 = unm1 & ((ur1 < 0) | (z1s > th_close))
    unm2 = unm2 & ((ur2 < 0) | (z2s > th_close))

    # fundamental matrix: x2^T F21 x1 = 0 with T21 = T2w inv(T1w)
    T21 = T2 @ lie.se3_inverse(T1)
    R21, t21 = T21[:3, :3], T21[:3, 3]
    Kinv = to_device(np.array([[1.0 / cam.fx, 0.0, -cam.cx / cam.fx],
                               [0.0, 1.0 / cam.fy, -cam.cy / cam.fy],
                               [0.0, 0.0, 1.0]]), torch.float32, m.device)
    F21 = Kinv.T @ (lie.hat(t21) @ R21) @ Kinv

    # a stereo rig only triangulates across a baseline longer than its own
    c1w = lie.translation(lie.se3_inverse(T1))
    c2w = lie.translation(lie.se3_inverse(T2))
    baseline_ok = torch.linalg.norm(c1w - c2w) > cam.baseline

    lvl2 = m.kf_level[kf2c]
    s2_kp2 = sigma2[torch.clamp(lvl2, 0, sigma2.shape[0] - 1).long()]
    epi = matching.EpipolarMask(matching.epipolar_lines(uv1, F21), uv2, s2_kp2)
    return PairGates(unm1, unm2, epi, baseline_ok, z1s, s2_kp2, c1w, c2w)


def _pair_candidates(m: mapstate.MapState, kf1: int, kf2: int, cam: cam_mod.Pinhole,
                     sigma2, scale_factors):
    """Candidates of one pair, no map writes: (want [F], Xw [F, 3],
    normal [F, 3], dist_rng [F, 2], idx2 [F])."""
    kf1c = min(max(int(kf1), 0), m.K - 1)
    kf2c = min(max(int(kf2), 0), m.K - 1)
    T1, T2 = m.kf_T_cw[kf1c], m.kf_T_cw[kf2c]
    uv1, uv2 = m.kf_xy[kf1c], m.kf_xy[kf2c]
    lvl1, lvl2 = m.kf_level[kf1c], m.kf_level[kf2c]
    ur1 = m.kf_uvr[kf1c][:, 2]
    g = pair_gates(m, kf1c, kf2c, cam, sigma2)
    z1s, s2_kp2, c1w, c2w = g.z1s, g.s2_kp2, g.c1w, g.c2w
    idx2, dist_h, ok = matching.match_descriptors(
        m.kf_desc[kf1c], m.kf_desc[kf2c], g.unm1, g.unm2, mask=g.epi, max_dist=40, ratio=0.8,
        mutual=True)
    ok = matching.resolve_duplicates(idx2, dist_h, ok, uv2.shape[0])
    ok = ok & g.baseline_ok

    # ray parallax in the world frame
    one = torch.ones_like(uv1[:, 0])
    xn1 = cam_mod.unproject(cam, uv1, one)
    xn2 = cam_mod.unproject(cam, uv2, one)[idx2]
    r1 = xn1 @ T1[:3, :3]
    r2 = xn2 @ T2[:3, :3]
    cosp = torch.sum(r1 * r2, dim=-1) / torch.clamp(
        torch.linalg.norm(r1, dim=-1) * torch.linalg.norm(r2, dim=-1), min=1e-12)
    ok = ok & (cosp > 0.0) & (cosp < MIN_PARALLAX_COS)

    # the parallax must beat what the rig itself gives at this depth
    z_hint = torch.where(ur1 > 0, z1s, 1e6)
    cos_stereo = torch.cos(2.0 * torch.atan2(
        torch.full_like(z_hint, 0.5 * cam.bf / cam.fx), z_hint))
    ok = ok & (cosp < cos_stereo)

    Xw = tri.triangulate_dlt(xn1[:, :2], xn2[:, :2], T1, T2)

    # validation in both views
    Xc1 = lie.se3_apply(T1, Xw)
    Xc2 = lie.se3_apply(T2, Xw)
    ok = ok & (Xc1[:, 2] > 0.05) & (Xc2[:, 2] > 0.05)
    e1 = torch.sum((cam_mod.project(cam, Xc1) - uv1) ** 2, dim=-1)
    e2 = torch.sum((cam_mod.project(cam, Xc2) - uv2[idx2]) ** 2, dim=-1)
    s2_1 = sigma2[torch.clamp(lvl1, 0, sigma2.shape[0] - 1).long()]
    ok = ok & (e1 <= CHI2_MONO * s2_1) & (e2 <= CHI2_MONO * s2_kp2[idx2])

    # scale consistency (ratioDist vs ratioOctave)
    dist1 = torch.linalg.norm(Xw - c1w, dim=-1)
    dist2 = torch.linalg.norm(Xw - c2w, dim=-1)
    ratio_dist = dist2 / torch.clamp(dist1, min=1e-9)
    n_sf = scale_factors.shape[0]
    lvl1c = torch.clamp(lvl1, 0, n_sf - 1).long()
    sf1 = scale_factors[lvl1c]
    sf2 = scale_factors[torch.clamp(lvl2, 0, n_sf - 1).long()][idx2]
    ratio_oct = sf1 / sf2
    factor = 1.5 * scale_factors[1]
    ok = ok & (ratio_dist * factor > ratio_oct) & (ratio_dist < ratio_oct * factor)
    want = ok & (dist1 > 1e-3) & (dist2 > 1e-3)

    # landmark attributes from the first (new keyframe's) view
    dmean = 0.5 * ((Xw - c1w) + (Xw - c2w))
    normal = dmean / torch.clamp(torch.linalg.norm(dmean, dim=-1, keepdim=True), min=1e-9)
    max_d = dist1 * sf1
    min_d = max_d / scale_factors[-1]
    return want, Xw, normal, torch.stack([min_d, max_d], -1), idx2


def triangulate_pair(m: mapstate.MapState, kf1: int, kf2: int, cam, sigma2,
                     scale_factors) -> mapstate.MapState:
    """Triangulate new landmarks between ``kf1`` and ``kf2`` (one pair); a
    ``NO_KF`` neighbour (a padded pair) adds nothing."""
    if int(kf2) == mapstate.NO_KF:
        return m
    want, Xw, normal, dist_rng, idx2 = _pair_candidates(
        m, kf1, kf2, cam, sigma2, scale_factors)
    kf1c = min(max(int(kf1), 0), m.K - 1)
    kf2c = min(max(int(kf2), 0), m.K - 1)
    m, lm_ids = mapstate.add_landmarks(
        m, kf1c, torch.arange(m.F, dtype=torch.int32, device=m.device), Xw,
        m.kf_desc[kf1c], normal, dist_rng, want)
    return mapstate.link_observations(m, kf2c, idx2, lm_ids, want)


def triangulate_batch(m: mapstate.MapState, kf1: int, neighbors, cam, sigma2,
                      scale_factors, max_pairs: int = 3) -> mapstate.MapState:
    """All neighbour pairs of ``kf1``, one allocation over their union.

    ``neighbors`` is a host list of keyframe ids, ``NO_KF``-padded to
    ``max_pairs``. Padded pairs contribute no candidate, so they are skipped
    here; the real pairs keep their order, and the first pair wins a
    ``kf1`` feature that two pairs triangulate, so landmarks get the slots
    the reference's padded batch gives them."""
    nbs = [int(nb) for nb in list(neighbors)[:max_pairs] if int(nb) != mapstate.NO_KF]
    if not nbs:
        return m
    kf1c = min(max(int(kf1), 0), m.K - 1)
    cands = [_pair_candidates(m, kf1, nb, cam, sigma2, scale_factors) for nb in nbs]
    want, Xw, normal, dist_rng, idx2 = (torch.stack(x) for x in zip(*cands))
    P, F = want.shape
    w32 = want.to(torch.int32)
    want = want & ((torch.cumsum(w32, dim=0) - w32) == 0)

    feat_idx = torch.arange(F, dtype=torch.int32, device=m.device).repeat(P)
    m, lm_ids = mapstate.add_landmarks(
        m, kf1c, feat_idx, Xw.reshape(-1, 3), m.kf_desc[kf1c].repeat(P, 1),
        normal.reshape(-1, 3), dist_rng.reshape(-1, 2), want.reshape(-1))
    lm_ids = lm_ids.reshape(P, F)
    for p, nb in enumerate(nbs):
        m = mapstate.link_observations(m, min(max(nb, 0), m.K - 1), idx2[p], lm_ids[p], want[p])
    return m


def create_new_map_points(m: mapstate.MapState, kf_id: int, neighbor_ids, cam, sigma2,
                          scale_factors, max_pairs: int = 4) -> mapstate.MapState:
    """Triangulate against the first ``max_pairs`` covisible neighbours."""
    nbs = [nb for nb in list(neighbor_ids)[:max_pairs]
           if nb != mapstate.NO_KF and nb != kf_id]
    return triangulate_batch(m, kf_id, nbs, cam, sigma2, scale_factors, max_pairs=max_pairs)
