"""LOAM-style scan feature extraction (surf / edge) (port of
``tc2li_slam_tpu/ops/scan_features.py``).

Behavioral port of the reference's ``give_feature`` / ``plane_judge`` /
``edge_jump_judge`` (lidar_front_end/preprocess.cpp:200-470): classify each
point of an azimuth-ordered ring scan as planar (surf) or edge by LOCAL
geometry, emit a decimated surf set + the edge set. The reference walks each
ring sequentially with a group-growing state machine; here fixed-radius
sliding-window tests are evaluated for all points at once by rolling the
point axis — same quantities (chord point-to-line distances, range jumps,
neighbor-spacing ratios):

- ``plane``: the G-point window starting at i is planar when every interior
  point sits within ``p2l_ratio`` of the window chord (plane_judge's
  two-point-distance/vx-projection test, preprocess.cpp:482-563) and the
  spacing bounds disA/disB hold.
- ``edge_jump``: a range discontinuity to either neighbor whose local beam
  geometry passes the jump_up/jump_down cosine gates (edge_jump_judge,
  preprocess.cpp:565-603), excluding occlusion shadows.
- ``small_plane`` smoothing: near-equal neighbor spacing with a shallow
  intersection angle upgrades points to planar (preprocess.cpp:391-427).
- surf decimation: every ``point_filter_num``-th point of a planar run.

One code path over a leading ring axis: ``extract_features_rings`` takes an
organized scan [R, N, 3], ``extract_features`` is its R = 1 case. The
reference ships this path disabled for KITTI (``LidarConfig.feature_extract``
is off, and nothing reads it); it is off the frame loop.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

# reference defaults (preprocess.cpp ctor, :34-60)
DIS_A = 0.01
DIS_B = 0.1
P2L_RATIO = 225.0          # (point-to-line distance)^2 ratio gate
LIMIT_MAXMID = 6.25        # spacing-uniformity gates of plane_judge
LIMIT_MIDMIN = 6.25
JUMP_UP_COS = -0.9848      # cos(170 deg)
JUMP_DOWN_COS = 0.9397     # cos(20 deg)
EDGE_A = 2.0               # neighbor-distance ratio gates of edge_jump_judge
EDGE_B = 0.1
SMALLP_INTERSECT = 172.5   # degrees
SMALLP_RATIO = 1.2
GROUP_G = 8                # plane window size (group_size)


class ScanFeatures(NamedTuple):
    surf: torch.Tensor    # [..., N] bool decimated planar points
    edge: torch.Tensor    # [..., N] bool edge points
    plane: torch.Tensor   # [..., N] bool un-decimated planar classification


def _roll(x: torch.Tensor, s: int, vec: bool) -> torch.Tensor:
    """jnp.roll(x, s) along the point axis (the last, or the one before the
    coordinates when ``vec``)."""
    return torch.roll(x, s, dims=-2 if vec else -1)


def _shift(x: torch.Tensor, s: int, vec: bool = False) -> torch.Tensor:
    """The point ``s`` slots ahead (wrapping around the ring)."""
    return _roll(x, -s, vec)


def _sq(v: torch.Tensor) -> torch.Tensor:
    return torch.sum(v * v, dim=-1)


def extract_features_rings(points: torch.Tensor, valid: torch.Tensor, blind: float = 2.0,
                           point_filter_num: int = 2) -> ScanFeatures:
    """Classify every ring of an organized scan: ``points`` [R, N, 3]
    ring-major, each ring azimuth-ordered in the sensor frame; ``valid``
    [R, N]."""
    N = points.shape[-2]
    r = torch.linalg.norm(points, dim=-1)
    valid = valid & (r > blind)
    nxt = _shift(points, 1, True)
    d_fwd = _sq(nxt - points)                                # types[i].dista

    # --- plane test: window [i, i+G) against its chord
    G = GROUP_G
    chord = _shift(points, G - 1, True) - points
    chord_n2 = torch.clamp(_sq(chord), min=1e-12)
    max_p2l = torch.zeros_like(r)
    win_ok = valid
    max_spacing = torch.zeros_like(r)
    min_spacing = torch.full_like(r, float("inf"))
    for k in range(1, G - 1):
        off = _shift(points, k, True) - points
        # squared point-to-chord distance via the cross product
        cr = torch.linalg.cross(off, chord, dim=-1)
        max_p2l = torch.maximum(max_p2l, _sq(cr) / chord_n2)
        win_ok = win_ok & _shift(valid, k)
        sp = _sq(_shift(points, k, True) - _shift(points, k - 1, True))
        max_spacing = torch.maximum(max_spacing, sp)
        min_spacing = torch.minimum(min_spacing, sp)
    win_ok = win_ok & _shift(valid, G - 1)
    # disA/disB spacing bound scaled by range (plane_judge's two_dis gate)
    spacing_lim = (DIS_A * r + DIS_B) ** 2
    uniform = max_spacing <= LIMIT_MAXMID * torch.clamp(min_spacing, min=1e-12)
    plane_win = (win_ok
                 & (max_p2l * P2L_RATIO <= chord_n2)   # all interior pts near chord
                 & (max_spacing <= spacing_lim)
                 & uniform)
    # a point is planar if ANY window containing it is planar
    plane = torch.zeros_like(valid)
    for k in range(G):
        plane = plane | _roll(plane_win, k, False)
    plane = plane & valid

    # --- small-plane smoothing (preprocess.cpp:391-427): near-equal
    # neighbor spacing + shallow intersection angle
    d_prev = _roll(d_fwd, 1, False)
    ratio = torch.maximum(d_prev, d_fwd) / torch.clamp(torch.minimum(d_prev, d_fwd), min=1e-12)
    a = points - _roll(points, 1, True)
    b = nxt - points
    an = torch.clamp(torch.linalg.norm(a, dim=-1), min=1e-9)
    bn = torch.clamp(torch.linalg.norm(b, dim=-1), min=1e-9)
    cos_i = torch.sum(a * b, dim=-1) / (an * bn)
    intersect_deg = 180.0 - torch.rad2deg(torch.arccos(torch.clamp(cos_i, -1, 1)))
    smallp = (intersect_deg > SMALLP_INTERSECT) & (ratio < SMALLP_RATIO)
    smallp = smallp & valid & _roll(valid, 1, False) & _shift(valid, 1)
    plane = plane | smallp | _roll(smallp, 1, False) | _roll(smallp, -1, False)
    plane = plane & valid

    # --- edge jumps (edge_jump_judge): a near-radial range discontinuity
    # (the Nr_180 / Nr_zero direction classes) seen from the near side
    beam = points / torch.clamp(r, min=1e-9)[..., None]
    d_min = torch.minimum(torch.clamp(d_prev, min=1e-12), torch.clamp(d_fwd, min=1e-12))

    def jump(to_prev: bool):
        nb = _roll(points, 1, True) if to_prev else nxt
        nb_v = _roll(valid, 1, False) if to_prev else _shift(valid, 1)
        nb_r = _roll(r, 1, False) if to_prev else _shift(r, 1)
        e = nb - points
        en = torch.clamp(torch.linalg.norm(e, dim=-1), min=1e-9)
        cos_b = torch.sum(beam * e, dim=-1) / en
        d_n = _sq(e)
        big_jump = d_n > EDGE_A * EDGE_A * d_min
        radial = (cos_b < JUMP_UP_COS) | (cos_b > JUMP_DOWN_COS)
        return nb_v & big_jump & radial & (d_n > EDGE_B) & (r < nb_r)

    edge = valid & ~plane & (jump(True) | jump(False))

    # --- surf decimation: every point_filter_num-th point of a planar run
    if point_filter_num > 1:
        surf = plane & (torch.arange(N, device=points.device) % point_filter_num == 0)
    else:
        surf = plane
    return ScanFeatures(surf=surf, edge=edge, plane=plane)


def extract_features(points: torch.Tensor, valid: torch.Tensor, blind: float = 2.0,
                     point_filter_num: int = 2) -> ScanFeatures:
    """Classify one azimuth-ordered ring: ``points`` [N, 3], ``valid`` [N]."""
    f = extract_features_rings(points[None], valid[None], blind, point_filter_num)
    return ScanFeatures(*(x[0] for x in f))
