"""Parity: ORB extraction of tc2li_slam_torch vs tc2li_slam_tpu.

FAST is compared with the Pallas kernel in interpret mode and with the XLA
path. The per-level checks feed both packages the JAX pyramid levels, so
they are exact; the pyramid resize itself and ``extract`` end to end are
held to stated tolerances (the two libraries' float32 matrix products
round the antialiased resize differently, by < 1e-3 grey levels).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tc2li_slam_tpu.ops import orb as jorb
from tc2li_slam_tpu.ops.kernels.fast import fast_score_pallas
from tc2li_slam_torch.ops import orb as torb
from tc2li_slam_torch.ops.kernels import fast as tfast
from torch_parity import n, small_sequence, t, words_u32


@pytest.fixture(scope="module")
def frame_img():
    return np.asarray(small_sequence(1)[0].img_l)


def _jax_levels(img, n_levels=4, scale=1.2):
    f = jnp.asarray(img, jnp.float32)
    H, W = img.shape
    out = []
    for lvl in range(n_levels):
        Hl, Wl = torb.level_shape(H, W, scale, lvl)
        out.append(np.asarray(f if lvl == 0 else jax.image.resize(f, (Hl, Wl), "linear")))
    return out


@pytest.mark.parametrize("kind", ["uint8", "level"])
def test_fast_plain_matches_pallas_and_xla(rng, frame_img, kind):
    if kind == "uint8":
        img = rng.integers(0, 255, (96, 200), dtype=np.uint8)
    else:
        img = _jax_levels(frame_img)[2]
    got = n(tfast.fast_score_raw(t(img)))
    pallas = np.asarray(fast_score_pallas(jnp.asarray(img), 0.0, interpret=True))
    xla = np.asarray(jorb._fast_score_raw_xla(jnp.asarray(img)))
    np.testing.assert_array_equal(got, xla)                       # exact, ring included
    np.testing.assert_array_equal(got[3:-3, 3:-3], pallas[3:-3, 3:-3])
    assert (got > 20).sum() > 0


def test_fast_wrapper_rejects_bad_input():
    with pytest.raises(ValueError):
        tfast.fast_score_raw(torch.zeros(2, 8, 8))


def test_resize_close_to_jax(frame_img):
    """Antialiased resize: the weight matrices are built exactly as JAX
    builds them; the float32 products differ by < 1e-3 grey levels."""
    img = np.asarray(frame_img, np.float32)
    for lvl, ref in enumerate(_jax_levels(frame_img, 4)):
        got = n(torb.resize_linear(t(img), ref.shape)) if lvl else img
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-3)


def test_detect_and_select_exact_per_level(frame_img):
    per = torb.features_per_level(512, 4, 1.2)
    assert per == jorb.features_per_level(512, 4, 1.2)
    for lvl, li in enumerate(_jax_levels(frame_img, 4)):
        sj = np.asarray(jorb.detect_level(jnp.asarray(li)))
        st = n(torb.detect_level(t(li)))
        np.testing.assert_array_equal(st, sj)
        for k in (per[lvl], 7, 3000):
            rj = [np.asarray(a) for a in jorb.select_topk_grid(jnp.asarray(sj), k)]
            rt = [n(a) for a in torb.select_topk_grid(t(sj), k)]
            for a, b in zip(rt, rj):
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("ini_th,min_th", [(20.0, 7.0), (5.0, 9.0), (60.0, 7.0)])
def test_detect_planes_stack_exact_per_level(rng, frame_img, ini_th, min_th):
    """The stack entry of detection (all planes in one call) against the JAX
    package's per-level ``detect_level``: ragged levels of two images inside
    one padded stack, a flat plane with no corner, ``ini_th < min_th``."""
    levels = _jax_levels(frame_img, 4)
    planes = levels + [np.full((80, 90), 128.0, np.float32),
                       np.asarray(small_sequence(1)[0].img_r, np.float32)]
    pad = 19
    H, W = frame_img.shape
    stack = rng.uniform(0, 255, (len(planes), H + 2 * pad, W + 2 * pad)).astype(np.float32)
    for p, li in enumerate(planes):
        stack[p, pad:pad + li.shape[0], pad:pad + li.shape[1]] = li
    shapes = [li.shape for li in planes]
    got = n(tfast.detect_planes(t(stack), shapes, pad, ini_th, min_th))
    gated, flags = tfast.score_planes(t(stack), shapes, pad, ini_th, min_th)
    assert gated.dtype == torch.float32 and flags.dtype == torch.int32
    assert flags.shape == (sum(-(-h // 35) * -(-w // 35) for h, w in shapes),)
    for p, li in enumerate(planes):
        Hl, Wl = li.shape
        ref = np.asarray(jorb.detect_level(jnp.asarray(li), ini_th, min_th))
        np.testing.assert_array_equal(got[p, :Hl, :Wl], ref)
        np.testing.assert_array_equal(n(tfast.detect_level_plain(t(li), ini_th, min_th)), ref)
        np.testing.assert_array_equal(n(torb.detect_level(t(li), ini_th, min_th)), ref)
    assert (got[4, :80, :90] > 0).sum() == 0 and (got[0] > 0).sum() > 50
    with pytest.raises(ValueError):
        tfast.detect_planes(t(stack), shapes[:-1], pad)
    with pytest.raises(ValueError):
        tfast.detect_planes(t(stack), shapes, pad, ini_th=-1.0)


def test_extract_images_pair_equals_single(frame_img):
    """Left and right through one stack give what two single calls give."""
    img_r = np.asarray(small_sequence(1)[0].img_r)
    kl, kr = torb.extract_images([t(frame_img), t(img_r)], n_features=512, n_levels=4)
    for pair, img in ((kl, frame_img), (kr, img_r)):
        single = torb.extract(t(img), n_features=512, n_levels=4)
        for a, b in zip(pair, single):
            assert a.dtype == b.dtype and torch.equal(a, b)
    with pytest.raises(ValueError):
        torb.extract_images([t(frame_img), t(img_r[:-2])])


def _jax_stacks(img, n_levels=4, n_features=512):
    """The edge-padded level/blur stacks and keypoints extract() builds."""
    H, W = img.shape
    pad = max(jorb.HALF_PATCH, jorb._PATTERN_RADIUS)
    img_stack = np.zeros((n_levels, H + 2 * pad, W + 2 * pad), np.float32)
    blur_stack = np.zeros_like(img_stack)
    per = jorb.features_per_level(n_features, n_levels, 1.2)
    rows, cols, lvls = [], [], []
    for lvl, li in enumerate(_jax_levels(img, n_levels)):
        Hl, Wl = li.shape
        r, c, _ = jorb.select_topk_grid(jorb.detect_level(jnp.asarray(li)), per[lvl])
        img_stack[lvl, :Hl + 2 * pad, :Wl + 2 * pad] = np.pad(li, pad, mode="edge")
        blur = np.asarray(jorb.gaussian_blur7(jnp.asarray(li)))
        blur_stack[lvl, :Hl + 2 * pad, :Wl + 2 * pad] = np.pad(blur, pad, mode="edge")
        rows.append(np.asarray(r)); cols.append(np.asarray(c))
        lvls.append(np.full(len(r), lvl, np.int32))
    return img_stack, blur_stack, np.concatenate(lvls), np.concatenate(rows), np.concatenate(cols), pad


def test_blur_orientation_descriptors(frame_img):
    img_stack, blur_stack, lvl, rows, cols, pad = _jax_stacks(frame_img)
    # separable blur: same taps and order; float32 sums to ~1 ulp of 255
    for li in _jax_levels(frame_img, 2):
        np.testing.assert_allclose(n(torb.gaussian_blur7(t(li))),
                                   np.asarray(jorb.gaussian_blur7(jnp.asarray(li))),
                                   rtol=0, atol=1e-4)
    args_j = [jnp.asarray(a) for a in (img_stack, lvl, rows, cols)]
    ang_j = np.asarray(jorb.compute_orientation_stacked(*args_j, pad))
    ang_t = n(torb.compute_orientation_stacked(t(img_stack), t(lvl), t(rows), t(cols), pad))
    # the moments are float32 sums of ~700 products taken in another order
    # (exact only on the integer level 0); their rounding, relative to a
    # small centroid, moves the angle by up to ~1e-4 rad
    np.testing.assert_allclose(ang_t, ang_j, rtol=0, atol=2e-4)
    np.testing.assert_allclose(ang_t[lvl == 0], ang_j[lvl == 0], rtol=0, atol=1e-6)
    # given the same angles the rBRIEF words are exact
    dj = jorb.compute_descriptors_stacked(jnp.asarray(blur_stack), *args_j[1:],
                                          jnp.asarray(ang_j), pad)
    dt = torb.compute_descriptors_stacked(t(blur_stack), t(lvl), t(rows), t(cols),
                                          t(ang_j), pad)
    np.testing.assert_array_equal(words_u32(dt), np.asarray(dj))


def test_extract_end_to_end(frame_img):
    """Whole extractor on one frame from the raw image. Keypoint positions
    and levels must agree on >= 99% of slots (upper pyramid levels differ
    by the resize rounding above); descriptor words on >= 98% of slots
    (a tap that rounds on a .5 boundary can flip one bit)."""
    kj = jorb.extract(jnp.asarray(frame_img), n_features=512, n_levels=4)
    kt = torb.extract(t(frame_img), n_features=512, n_levels=4)
    same_kp = (np.all(n(kt.xy) == np.asarray(kj.xy), axis=1)
               & (n(kt.level) == np.asarray(kj.level)))
    assert same_kp.mean() >= 0.99, same_kp.mean()
    np.testing.assert_array_equal(n(kt.valid), np.asarray(kj.valid))
    same_desc = np.all(words_u32(kt.desc) == np.asarray(kj.desc), axis=1)
    assert same_desc.mean() >= 0.98, same_desc.mean()
    assert kt.desc.dtype == torch.int32 and kt.level.dtype == torch.int32
