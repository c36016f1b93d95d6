"""Per-frame tracking: frame build, windowed matching, pose tracking and the
window-free recovery (port of ``tc2li_slam_tpu/slam/tracking.py``).

``track_step`` is the per-frame path; the host calls ``track_step_recover``
(global descriptor matching of the whole landmark pool + PnP RANSAC, then a
windowed pass) only when that came back with too few inliers.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..geom import camera as cam_mod, lie
from ..ops import matching, orb, stereo
from ..solver import lm as lm_mod, pnp as pnp_mod
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
    st = stereo.match_and_refine(img_l, img_r, kl, kr, scale_factors, cam.bf, cam.baseline)
    return Frame(xy=kl.xy, uvr=st.uvr, depth=st.depth, level=kl.level, angle=kl.angle,
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

    feat_lm = _assign_features(m, kp_idx, matched, frame.xy.shape[0])
    has_lm = feat_lm != mapstate.NO_LM

    X_obs = m.lm_pos[torch.clamp(feat_lm, 0, m.L - 1).long()]
    inv_s2 = 1.0 / sigma2[torch.clamp(frame.level, 0, sigma2.shape[0] - 1).long()]
    res = lm_mod.pose_only_optimize(cam, T_cw_pred, X_obs, frame.uvr, inv_s2,
                                    frame.uvr[:, 2] > 0, has_lm & frame.valid)
    feat_lm = torch.where(res.inliers, feat_lm, mapstate.NO_LM)
    return TrackResult(res.T_cw, feat_lm, res.n_inliers, count(matched))


def _assign_features(m: mapstate.MapState, kp_idx, matched, F: int) -> torch.Tensor:
    """[F] landmark id per frame feature from a landmark-major match."""
    lm_ids = torch.arange(m.L, dtype=torch.int32, device=m.device)
    buf = torch.full((F + 1,), mapstate.NO_LM, dtype=torch.int32, device=m.device)
    buf[torch.where(matched, kp_idx, F)] = torch.where(matched, lm_ids, mapstate.NO_LM)
    return buf[:F]


def track_frame_global(m: mapstate.MapState, frame: Frame, cam, sigma2,
                       generator: torch.Generator | None = None,
                       sample_idx: torch.Tensor | None = None) -> TrackResult:
    """Window-free descriptor tracking (TrackReferenceKeyFrame's role): the
    whole landmark pool against the frame, mutual, no window; the pose from
    batched PnP RANSAC, so it needs no initial guess. The hypotheses' points
    come from ``generator`` or are given as ``sample_idx`` [64, 6]."""
    F = frame.xy.shape[0]
    kp_idx, dist_h, matched = matching.match_descriptors(
        m.lm_desc, frame.desc, m.lm_valid, frame.valid,
        max_dist=matching.TH_LOW, ratio=0.75, mutual=True)
    matched = matching.resolve_duplicates(kp_idx, dist_h, matched, F)
    feat_lm = _assign_features(m, kp_idx, matched, F)
    has_lm = feat_lm != mapstate.NO_LM
    X_obs = m.lm_pos[torch.clamp(feat_lm, 0, m.L - 1).long()]
    res = pnp_mod.pnp_ransac(cam, X_obs, frame.xy, has_lm & frame.valid, generator,
                             n_hyp=64, min_inliers=12, sample_idx=sample_idx)
    feat_lm = torch.where(res.inliers, feat_lm, mapstate.NO_LM)
    return TrackResult(res.T_cw, feat_lm, res.n_inliers, count(matched))


def _select(cond, a: TrackResult, b: TrackResult) -> TrackResult:
    """Field-wise ``cond ? a : b`` (cond a device scalar)."""
    return TrackResult(*[torch.where(cond, x, y) for x, y in zip(a, b)])


def _finish_step(m, res: TrackResult, T_pred, T_cw_prev, velocity, cam):
    """Dead-reckon on failure, count found/visible, update the motion model."""
    ok = res.n_inliers >= 10
    res = res._replace(T_cw=torch.where(ok, res.T_cw, T_pred),
                       feat_lm=torch.where(ok, res.feat_lm, mapstate.NO_LM))
    m = update_found_counters(m, res.feat_lm, res.T_cw, cam, ok)
    vel_new = torch.where(ok, res.T_cw @ lie.se3_inverse(T_cw_prev), velocity)
    return m, res, res.T_cw, vel_new


def track_step_recover(m: mapstate.MapState, frame: Frame, T_cw_prev, T_pred, velocity,
                       cam, scale_factors, sigma2, radius: float,
                       generator: torch.Generator | None = None,
                       sample_idx: torch.Tensor | None = None):
    """Failure-path re-acquisition: global matching + PnP RANSAC, then a
    windowed pass from that pose; the better of the two is kept on the device.
    Returns what ``track_step`` returns."""
    res_g = track_frame_global(m, frame, cam, sigma2, generator, sample_idx)
    res2 = track_frame(m, frame, res_g.T_cw, cam, scale_factors, sigma2, radius)
    res = _select((res_g.n_inliers >= 10) & (res2.n_inliers >= res_g.n_inliers), res2, res_g)
    return _finish_step(m, res, T_pred, T_cw_prev, velocity, cam)


def track_step(m: mapstate.MapState, frame: Frame, T_cw_prev, velocity, cam,
               scale_factors, sigma2, radius: float):
    """Motion-model guided tracking + found counters + motion update.

    Returns (map', TrackResult, T_cw', velocity'). With < 10 inliers T_cw'
    is the motion-model prediction and the velocity is unchanged."""
    T_pred = lie.se3_orthonormalize(velocity @ T_cw_prev)
    res = track_frame(m, frame, T_pred, cam, scale_factors, sigma2, radius)
    return _finish_step(m, res, T_pred, T_cw_prev, velocity, cam)


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
