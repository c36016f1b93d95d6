"""Parity of the port's LOAM scan features (``ops/scan_features.py``) with
the JAX package's on the same numpy rings. The masks are booleans behind
float gates: each test counts the points where the two packages disagree
(flips) and holds the count to 0 on these inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from tc2li_slam_tpu.ops import scan_features as jsf
from tc2li_slam_torch.ops import scan_features as tsf
from test_scan_features import ring_scene
from torch_parity import n


def flips(j, t) -> list[int]:
    """Points where each of (surf, edge, plane) differs."""
    return [int((n(a) != n(b)).sum()) for a, b in zip(j, t)]


@pytest.mark.parametrize("n_pts,pf,blind_case", [
    (720, 1, False), (720, 2, False), (360, 1, False), (360, 2, False),
    (720, 2, True), (360, 1, True)])
def test_ring_matches_jax(n_pts, pf, blind_case):
    """``ring_scene`` at 720 and 360 points, ``point_filter_num`` 1 and 2,
    and the blind case (the first 50 points moved inside the blind radius):
    0 flips in any mask."""
    pts, _ = ring_scene(np.random.default_rng(0), n=n_pts)
    if blind_case:
        pts[:50] *= 0.05 / np.linalg.norm(pts[:50], axis=-1, keepdims=True)
    valid = np.ones(n_pts, bool)
    j = jsf.extract_features(jnp.asarray(pts), jnp.asarray(valid), blind=1.0,
                             point_filter_num=pf)
    t = tsf.extract_features(torch.as_tensor(pts), torch.as_tensor(valid), blind=1.0,
                             point_filter_num=pf)
    assert all(x.dtype == torch.bool and x.shape == (n_pts,) for x in t)
    assert flips(j, t) == [0, 0, 0]
    assert int(t.plane.sum()) > n_pts // 2 and int(t.edge.sum()) >= 2
    if blind_case:
        assert not n(t.plane)[:50].any()


def test_rings_match_jax_and_single_rings():
    """A 4-ring stack of the HDL-64E-like room (``chip_smoke.scan_rings``)
    with a tenth of the points invalid: ``extract_features_rings`` equals the
    JAX function (0 flips), and each of its rings equals the single-ring
    call. ``chip_smoke.scan_gate_near`` (the points where the card's run may
    flip) marks a point whose range sits on the blind radius and the plane
    window around it, and little of the scan otherwise."""
    pts = chip_smoke.scan_rings(4, 720, seed=3)
    valid = np.random.default_rng(1).random(pts.shape[:2]) > 0.1
    j = jsf.extract_features_rings(jnp.asarray(pts), jnp.asarray(valid), blind=1.0,
                                   point_filter_num=2)
    t = tsf.extract_features_rings(torch.as_tensor(pts), torch.as_tensor(valid), blind=1.0,
                                   point_filter_num=2)
    assert flips(j, t) == [0, 0, 0]
    for r in range(pts.shape[0]):
        one = tsf.extract_features(torch.as_tensor(pts[r]), torch.as_tensor(valid[r]),
                                   blind=1.0, point_filter_num=2)
        for a, b in zip(t, one):
            assert torch.equal(a[r], b)
    near = chip_smoke.scan_gate_near(tsf, pts, valid, 1.0)
    assert near.sum() < 0.01 * near.size
    pts[1, 100] = (1.0, 0.0, 0.0)
    valid[1, 100] = True
    near = chip_smoke.scan_gate_near(tsf, pts, valid, 1.0)
    G = tsf.GROUP_G
    assert near[1, 100 - G - 1:100 + G + 2].all() and not near[0].any()

