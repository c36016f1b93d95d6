"""The stereo half of the port's frame build (``ops/stereo.match_and_refine``,
whose CUDA route is ``ops/kernels/stereo.stereo_refine``) against the JAX
package's ``match_stereo`` + ``subpixel_refine`` + ``build_frame`` tail.

On the CPU the route is the plain chain (``stereo_refine_plain``), the
version the kernel is held to bit for bit on the card. Full width: a
synthetic KITTI-shaped 1241x376 pair, 2000 ORB features over 8 levels,
keypoints from the port's extractor handed to both packages. Flags and
(u, v) exact; u_r to 1e-4 px (the tolerance of
``test_torch_matching.test_stereo_match_and_subpixel``: SAD sums of grey
levels are exact, the parabola one float32 division); the depth to 1e-6
relative (the port computes bf / d as PyTorch's scalar over tensor does,
bf times the rounded reciprocal).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from tc2li_slam_tpu.ops import stereo as jst
from tc2li_slam_torch.io import synthetic as syn
from tc2li_slam_torch.ops import orb as torb, stereo as tst
from tc2li_slam_torch.ops.kernels import stereo as kst
from torch_parity import n, t

RIG = syn.KITTI_LIKE
BF = float(np.float32(RIG.fx) * np.float32(RIG.baseline))
SF = (1.2 ** np.arange(8)).astype(np.float32)


@functools.lru_cache(maxsize=1)
def _pair():
    """A 1241x376 pair of the synthetic world and its ORB keypoints (numpy)."""
    rng = np.random.default_rng(0)
    world = syn.make_world(rng, n_surf=20_000)
    fr = syn.generate_sequence(n_frames=1, cam=RIG, seed=0, n_scan=256, world=world)[0][0]
    il, ir = (np.clip(x, 0, 255).astype(np.uint8) for x in (fr.img_l, fr.img_r))
    kl, kr = torb.extract_images([torch.as_tensor(il), torch.as_tensor(ir)], 2000, 8)
    as_np = lambda k: {f: n(getattr(k, f)) for f in ("xy", "level", "desc", "valid")}
    return il, ir, as_np(kl), as_np(kr)


def _case(case):
    return chip_smoke.stereo_case(np.random.default_rng(1), case, *_pair())


def _jax_chain(il, ir, kl, kr):
    """``tc2li_slam_tpu/slam/tracking.build_frame`` after the extraction."""
    j = lambda d: (jnp.asarray(d["xy"]), jnp.asarray(d["level"]),
                   jnp.asarray(d["desc"].view(np.uint32)), jnp.asarray(d["valid"]))
    idx, disp, ok = jst.match_stereo(*j(kl), *j(kr), jnp.asarray(SF),
                                     jnp.asarray(np.float32(BF)), jnp.asarray(np.float32(RIG.baseline)))
    xy = jnp.asarray(kl["xy"])
    ur, ok2 = jst.subpixel_refine(jnp.asarray(il, jnp.float32), jnp.asarray(ir, jnp.float32), xy,
                                  xy[:, 0] - disp, ok)
    disparity = xy[:, 0] - ur
    has = ok & ok2 & (disparity > 0.1)
    depth = jnp.where(has, BF / jnp.maximum(disparity, 0.1), 0.0)
    uvr = jnp.concatenate([xy, jnp.where(has, ur, -1.0)[:, None]], axis=-1)
    return [np.asarray(a) for a in (ur, ok2, depth, uvr)]


def _port(il, ir, kl, kr):
    dev = torch.device("cpu")
    return tst.match_and_refine(t(il), t(ir), chip_smoke.stereo_keypoints(torch, torb, kl, dev),
                                chip_smoke.stereo_keypoints(torch, torb, kr, dev), t(SF), BF,
                                float(np.float32(RIG.baseline)))


@pytest.mark.parametrize("case", chip_smoke.STEREO_CASES)
def test_stereo_route_matches_jax(case):
    il, ir, kl, kr = _case(case)
    before = kst.launches
    got = _port(il, ir, kl, kr)
    assert kst.launches == before                     # CPU tensors: the plain chain
    ur, ok, depth, uvr = _jax_chain(il, ir, kl, kr)
    np.testing.assert_array_equal(n(got.ok), ok)
    np.testing.assert_array_equal(n(got.uvr)[:, :2], uvr[:, :2])
    np.testing.assert_array_equal(n(got.uvr)[:, 2] == -1.0, uvr[:, 2] == -1.0)
    np.testing.assert_allclose(n(got.ur), ur, rtol=1e-6, atol=1e-4)
    np.testing.assert_allclose(n(got.uvr)[:, 2], uvr[:, 2], rtol=1e-6, atol=1e-4)
    np.testing.assert_allclose(n(got.depth), depth, rtol=1e-6, atol=0)
    N = kl["xy"].shape[0]
    if case == "frame":
        assert N == 2000 and ok.sum() > 500
    if case == "all_ok":    # every keypoint ok before the gate: the median fires
        dev = torch.device("cpu")
        kp = lambda d: chip_smoke.stereo_keypoints(torch, torb, d, dev)
        L, R = kp(kl), kp(kr)
        _, _, matched = tst.match_stereo(L.xy, L.level, L.desc, L.valid, R.xy, R.level, R.desc,
                                         R.valid, t(SF), BF, RIG.baseline)
        assert bool(matched.all()) and 0 < ok.sum() < N and N > 1000
    if case == "borders":   # some strip centres outside the image, some refined
        assert 0 < ok.sum() < N


def test_median_gate_as_the_reference():
    """The reference's median is NaN (so the gate is off) as soon as one
    keypoint is not ok; with every keypoint ok it is the mean of the two
    middle SADs, so the all-ok case rejects keypoints the frame case keeps."""
    x = np.array([3.0, 1.0, 2.0, 10.0], np.float32)
    assert float(tst.median_nan(t(x))) == 2.5
    assert np.isnan(float(tst.median_nan(t(np.array([1.0, np.nan], np.float32)))))
    assert np.isnan(float(tst.median_nan(t(np.zeros(0, np.float32)))))


def test_stereo_route_on_empty_and_single_keypoints():
    il, ir, kl, kr = _pair()
    for N in (0, 1):
        left = {k: v[:N] for k, v in kl.items()}
        got = _port(il, ir, left, kr)
        assert got.ur.shape == (N,) and got.ok.shape == (N,) and got.uvr.shape == (N, 3)
        if N:
            ur, ok, depth, uvr = _jax_chain(il, ir, left, kr)
            np.testing.assert_array_equal(n(got.ok), ok)
            np.testing.assert_allclose(n(got.depth), depth, rtol=1e-6, atol=0)


def test_match_and_refine_dispatch():
    """CPU tensors run the plain chain, CUDA tensors the kernel (card tests),
    any other device raises."""
    il, ir, kl, kr = _case("borders")
    meta = torch.device("meta")
    with pytest.raises(ValueError):
        tst.match_and_refine(t(il).to(meta), t(ir).to(meta),
                             chip_smoke.stereo_keypoints(torch, torb, kl, meta),
                             chip_smoke.stereo_keypoints(torch, torb, kr, meta),
                             t(SF).to(meta), BF, RIG.baseline)
