"""Per-frame tracking: frame build, guided matching, pose tracking
(port of ``tc2li_slam_tpu/slam/tracking.py`` without the recovery path).

The window-free recovery (``track_frame_global`` / ``track_step_recover``,
global descriptor matching + PnP RANSAC) is not ported yet; the system
raises ``NotImplementedError`` where it would run.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..geom import camera as cam_mod, lie
from ..ops import matching, orb, stereo
from ..solver import lm as lm_mod
from ..tensors import count
from . import mapstate


class Frame(NamedTuple):
    """Processed stereo frame, padded to F features."""

    xy: torch.Tensor     # [F, 2]
    uvr: torch.Tensor    # [F, 3] (u, v, u_r); u_r = -1 for mono
    depth: torch.Tensor  # [F] stereo depth (0 invalid)
    level: torch.Tensor  # [F] int32
    angle: torch.Tensor  # [F]
    desc: torch.Tensor   # [F, 8] int32
    valid: torch.Tensor  # [F] bool


def build_frame(img_l, img_r, cam: cam_mod.Pinhole, scale_factors,
                n_features: int = 1024, n_levels: int = 8) -> Frame:
    """ORB extract L/R + stereo match + subpixel refine (Frame ctor)."""
    kl, kr = orb.extract_images([img_l, img_r], n_features=n_features, n_levels=n_levels)
    idx, disp, ok = stereo.match_stereo(
        kl.xy, kl.level, kl.desc, kl.valid, kr.xy, kr.level, kr.desc, kr.valid,
        scale_factors, cam.bf, cam.baseline)
    ur0 = kl.xy[:, 0] - disp
    ur_ref, ok2 = stereo.subpixel_refine(img_l.to(torch.float32), img_r.to(torch.float32),
                                         kl.xy, ur0, ok)
    disparity = kl.xy[:, 0] - ur_ref
    has_depth = ok & ok2 & (disparity > 0.1)
    depth = torch.where(has_depth, cam.bf / torch.clamp(disparity, min=0.1), 0.0)
    uvr = torch.cat([kl.xy, torch.where(has_depth, ur_ref, -1.0)[:, None]], dim=-1)
    return Frame(xy=kl.xy, uvr=uvr, depth=depth, level=kl.level, angle=kl.angle,
                 desc=kl.desc, valid=kl.valid)


class TrackResult(NamedTuple):
    T_cw: torch.Tensor       # [4, 4]
    feat_lm: torch.Tensor    # [F] matched landmark per feature (NO_LM none)
    n_inliers: torch.Tensor  # [] int32
    n_matches: torch.Tensor  # [] int32


def scale_gate(m: mapstate.MapState, Xc):
    """(distance, within the landmark's scale-invariance range) of camera-
    frame landmark positions (isInFrustum's distance test)."""
    dist = torch.linalg.norm(Xc, dim=-1)
    max_d = torch.clamp(m.lm_dist[:, 1], min=1e-3)
    return dist, (dist >= 0.5 * m.lm_dist[:, 0]) & (dist <= 1.5 * max_d)


def predict_level(m: mapstate.MapState, dist, scale_factors):
    """Predicted octave from distance (MapPoint::PredictScale)."""
    ratio = torch.clamp(m.lm_dist[:, 1], min=1e-3) / torch.clamp(dist, min=1e-3)
    lvl = torch.ceil(torch.log(torch.clamp(ratio, min=1.0)) / torch.log(scale_factors[1]))
    return torch.clamp(lvl, 0, scale_factors.shape[0] - 1).to(torch.int32)


def track_frame(m: mapstate.MapState, frame: Frame, T_cw_pred, cam, scale_factors,
                sigma2, radius: float) -> TrackResult:
    """TrackWithMotionModel + TrackLocalMap fused: project all valid
    landmarks at the predicted pose, guided-match, pose-only optimise."""
    Xc = lie.se3_apply(T_cw_pred, m.lm_pos)
    uv_proj = cam_mod.project(cam, Xc)
    dist, dist_ok = scale_gate(m, Xc)
    cand = m.lm_valid & (Xc[:, 2] > 0.1) & cam_mod.in_image(cam, uv_proj) & dist_ok
    pred_level = predict_level(m, dist, scale_factors)
    rad = radius * scale_factors[pred_level.long()]
    kp_idx, dist_h, matched = matching.search_by_projection(
        uv_proj, pred_level, m.lm_desc, cand, frame.xy, frame.level, frame.desc,
        frame.valid, rad, max_dist=matching.TH_HIGH, ratio=0.9)
    matched = matching.resolve_duplicates(kp_idx, dist_h, matched, frame.xy.shape[0])

    F = frame.xy.shape[0]
    lm_ids = torch.arange(m.L, dtype=torch.int32, device=m.device)
    buf = torch.full((F + 1,), mapstate.NO_LM, dtype=torch.int32, device=m.device)
    buf[torch.where(matched, kp_idx, F)] = torch.where(matched, lm_ids, mapstate.NO_LM)
    feat_lm = buf[:F]
    has_lm = feat_lm != mapstate.NO_LM

    X_obs = m.lm_pos[torch.clamp(feat_lm, 0, m.L - 1).long()]
    inv_s2 = 1.0 / sigma2[torch.clamp(frame.level, 0, sigma2.shape[0] - 1).long()]
    res = lm_mod.pose_only_optimize(cam, T_cw_pred, X_obs, frame.uvr, inv_s2,
                                    frame.uvr[:, 2] > 0, has_lm & frame.valid)
    feat_lm = torch.where(res.inliers, feat_lm, mapstate.NO_LM)
    return TrackResult(res.T_cw, feat_lm, res.n_inliers, count(matched))


def track_step(m: mapstate.MapState, frame: Frame, T_cw_prev, velocity, cam,
               scale_factors, sigma2, radius: float):
    """Motion-model guided tracking + found counters + motion update.

    Returns (map', TrackResult, T_cw', velocity'). With < 10 inliers T_cw'
    is the motion-model prediction and the velocity is unchanged."""
    T_pred = lie.se3_orthonormalize(velocity @ T_cw_prev)
    res = track_frame(m, frame, T_pred, cam, scale_factors, sigma2, radius)
    ok = res.n_inliers >= 10
    res = res._replace(T_cw=torch.where(ok, res.T_cw, T_pred),
                       feat_lm=torch.where(ok, res.feat_lm, mapstate.NO_LM))
    m = update_found_counters(m, res.feat_lm, res.T_cw, cam, ok)
    vel_new = torch.where(ok, res.T_cw @ lie.se3_inverse(T_cw_prev), velocity)
    return m, res, res.T_cw, vel_new


def update_found_counters(m: mapstate.MapState, feat_lm, T_cw, cam, frame_ok):
    """IncreaseVisible for every landmark in view at the final pose,
    IncreaseFound for the matched inliers."""
    Xc = lie.se3_apply(T_cw, m.lm_pos)
    uv = cam_mod.project(cam, Xc)
    _, dist_ok = scale_gate(m, Xc)
    in_view = m.lm_valid & (Xc[:, 2] > 0.1) & cam_mod.in_image(cam, uv) & dist_ok & frame_ok
    visible = m.lm_visible + in_view.to(torch.int32)
    tracked = feat_lm != mapstate.NO_LM
    lm_c = torch.where(tracked, feat_lm, m.L - 1).long()
    found = m.lm_found.index_add(0, lm_c, tracked.to(torch.int32))
    return m.replace(lm_found=found, lm_visible=visible)


def near_existing_landmark(m: mapstate.MapState, frame: Frame, T_cw, cam,
                           radius: float, rel_depth: float) -> torch.Tensor:
    """[F]: an existing valid landmark projects within ``radius`` px of the
    feature at compatible depth (duplicate suppression for new landmarks)."""
    Xc = lie.se3_apply(T_cw, m.lm_pos)
    uv = cam_mod.project(cam, Xc)
    ok = m.lm_valid & (Xc[:, 2] > 0.1)
    du = torch.abs(frame.xy[:, None, 0] - uv[None, :, 0])
    dv = torch.abs(frame.xy[:, None, 1] - uv[None, :, 1])
    close = (du < radius) & (dv < radius) & ok[None, :]
    zr = frame.depth[:, None] / torch.clamp(Xc[None, :, 2], min=1e-3)
    depth_compat = (zr > 1.0 - rel_depth) & (zr < 1.0 + rel_depth)
    has_depth = frame.depth[:, None] > 0
    return torch.any(close & (depth_compat | ~has_depth), dim=1)


def stereo_landmark_candidates(frame: Frame, T_cw, cam, feat_lm, th_depth: float,
                               scale_factors):
    """New stereo landmarks from unmatched close features:
    (pos_w [F, 3], normal [F, 3], dist_range [F, 2], want [F])."""
    want = frame.valid & (frame.depth > 0) & (frame.depth < th_depth)
    want = want & (feat_lm == mapstate.NO_LM)
    Xc = cam_mod.unproject(cam, frame.xy, frame.depth)
    T_wc = lie.se3_inverse(T_cw)
    Xw = lie.se3_apply(T_wc, Xc)
    d = Xw - lie.translation(T_wc)
    dist = torch.linalg.norm(d, dim=-1)
    normal = d / torch.clamp(dist, min=1e-9)[:, None]
    lvl = torch.clamp(frame.level, 0, scale_factors.shape[0] - 1).long()
    max_d = dist * scale_factors[lvl]
    min_d = max_d / scale_factors[-1]
    return Xw, normal, torch.stack([min_d, max_d], -1), want
