"""``csrc/stereo.cu``'s refine launch repeated in numpy: the matcher's tail,
the patch and strip staged from 4-byte words, the integer SADs split over
a warp's 32 lanes, the parabola, and the last-block gate's median by a
two-digit radix select; held bit for bit against ``stereo_refine_plain``
(the plain chain the kernel is held to on the card) and against the JAX
package's ``subpixel_refine`` + ``build_frame`` tail.

The kernel sums each (offset, row) pair's 11 absolute differences as
integers on a lane (lane L takes pairs L, L + 32, ...), then an offset's 11
row partials: every SAD of grey levels is an integer below 2^16, exact in
float32 in any order, so it equals the plain chain's float sum of centred
windows. The median over all N SADs (only where every keypoint is ok)
takes the two 8-bit digits of the integer keys, a histogram each, the digit
found by warp 0's lanes over 8 bins each with an inclusive scan.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from tc2li_slam_tpu.ops import stereo as jst
from tc2li_slam_torch.io import synthetic as syn
from tc2li_slam_torch.ops import orb as torb
from tc2li_slam_torch.ops.kernels import match, stereo as kst
from torch_parity import n, t

F32 = np.float32
RIG = syn.KITTI_LIKE
BF = float(np.float32(RIG.fx) * np.float32(RIG.baseline))
SF = (1.2 ** np.arange(8)).astype(np.float32)
HALF, SLIDE = 5, 5


@functools.lru_cache(maxsize=1)
def _pair():
    """A 1241x376 pair of the synthetic world and its ORB keypoints (numpy)."""
    rng = np.random.default_rng(2)
    world = syn.make_world(rng, n_surf=20_000)
    fr = syn.generate_sequence(n_frames=1, cam=RIG, seed=2, n_scan=256, world=world)[0][0]
    il, ir = (np.clip(x, 0, 255).astype(np.uint8) for x in (fr.img_l, fr.img_r))
    kl, kr = torb.extract_images([torch.as_tensor(il), torch.as_tensor(ir)], 2000, 8)
    as_np = lambda k: {f: n(getattr(k, f)) for f in ("xy", "level", "desc", "valid")}
    return il, ir, as_np(kl), as_np(kr)


def _case(case):
    return chip_smoke.stereo_case(np.random.default_rng(1), case, *_pair())


def stage(img, r, x0, length):
    """The rows r - 5 .. r + 5 (clamped) of columns x0 .. x0 + length - 1 of
    each keypoint, [N, 11, length], as the kernel stages them: inside the
    image's columns from the 4-byte words of the flat image (a word only if
    it starts at or before the row's last byte; each byte at its position in
    the row, every position filled once), else pixel by pixel, clamped."""
    H, W = img.shape
    flat = img.reshape(-1)
    N = r.shape[0]
    out = np.full((N, 11, length), -1, np.int64)
    fills = np.zeros((N, 11, length), np.int64)
    rows = np.clip(r[:, None] - HALF + np.arange(11)[None, :], 0, H - 1)           # [N, 11]
    inside = (x0 >= 0) & (x0 + length <= W)
    b0 = rows.astype(np.int64) * W + x0[:, None]                                     # [N, 11]
    words = (length + 3) // 4 + 1
    for k in range(words):
        w = (b0 >> 2) + k
        live = inside[:, None] & (4 * w <= b0 + length - 1)
        for q in range(4):
            pos = 4 * w + q - b0
            ok = live & (pos >= 0) & (pos < length)
            nn, ii = np.nonzero(ok)
            addr = np.minimum(4 * w[nn, ii] + q, flat.size - 1)
            out[nn, ii, pos[nn, ii]] = flat[addr]
            fills[nn, ii, pos[nn, ii]] += 1
    cols = np.clip(x0[:, None] + np.arange(length)[None, :], 0, W - 1)            # [N, length]
    clamped = img[rows[:, :, None], cols[:, None, :]].astype(np.int64)
    out[~inside] = clamped[~inside]
    assert (fills[inside] == 1).all()                  # the words cover each position once
    np.testing.assert_array_equal(out, clamped)        # ... with the clamped gather's pixels
    return out


def lane_sads(patch, strip):
    """[N, 11] SADs: lane L takes the (offset, row) pairs L, L + 32, ... of
    121, each 11 integer terms |(w - p) - (wc - pc)|; lanes 0..10 add an
    offset's row partials."""
    N = patch.shape[0]
    pc = patch[:, HALF, HALF]
    part = np.full((N, 11, 11), -1, np.int64)
    for lane in range(32):
        for tk in range(lane, 121, 32):
            o, i = divmod(tk, 11)
            dc = strip[:, HALF, o + HALF] - pc
            w, p = strip[:, i, o:o + 11], patch[:, i, :]
            part[:, o, i] = np.abs((w - p) - dc[:, None]).sum(1)
    assert (part >= 0).all()
    return part.sum(2)


def select_kth(keys, k):
    """The k-th smallest (0-based) of integer keys below 2^16 by two 8-bit
    digits, as the gate's block finds it."""
    prefix = mask = 0
    for shift in (8, 0):
        sel = keys[(keys & mask) == prefix]
        c = np.bincount((sel >> shift) & 255, minlength=256).reshape(32, 8)
        incl = np.cumsum(c.sum(1))
        excl = incl - c.sum(1)
        lane = np.nonzero((excl <= k) & (k < incl))[0]
        assert lane.size == 1
        lane = int(lane[0])
        acc, d = int(excl[lane]), -1
        for j in range(8):
            if acc + c[lane, j] > k:
                d = j
                break
            acc += int(c[lane, j])
        prefix |= (8 * lane + d) << shift
        mask |= 255 << shift
        k -= acc
    return prefix


def emulate(il, ir, kl, kr):
    """The refine launch's outputs (ur, ok, depth, uvr) after the match."""
    H, W = il.shape
    N = kl["xy"].shape[0]
    if N == 0:   # no refine launch
        e = np.zeros(0, F32)
        return e, np.zeros(0, bool), e, np.zeros((0, 3), F32)
    a = chip_smoke.stereo_keypoints(torch, torb, kl, "cpu"), \
        chip_smoke.stereo_keypoints(torch, torb, kr, "cpu")
    band = torch.as_tensor(F32(2.0) * SF[np.clip(kr["level"], 0, 7)])
    mask = match.StereoMask(a[0].xy, a[0].level, a[1].xy, a[1].level, band,
                            float(F32(BF) / F32(RIG.baseline)))
    idx, best, second, back = (n(x) for x in match.match_best2(
        a[0].desc, a[1].desc, a[0].valid, a[1].valid, mask, True))
    ul, vl = kl["xy"][:, 0], kl["xy"][:, 1]
    with np.errstate(invalid="ignore"):
        ok = (best <= 100) & kl["valid"]
        ok &= best.astype(F32) <= F32(0.9) * second.astype(F32)
        ok &= back[idx] == np.arange(N)
        disp = ul - kr["xy"][idx, 0]
        disp = np.where(disp < F32(0.01), F32(0.01), disp)
        ur0 = ul - disp
        rf, crf = np.rint(vl), np.rint(ur0)
        ok &= (crf >= 0) & (crf < W) & (rf >= 0) & (rf < H)
    centre = lambda x, hi: np.fmin(np.fmax(x, 0), hi).astype(np.int64)
    r, cl, cr = centre(rf, H - 1), centre(np.rint(ul), W - 1), centre(crf, W - 1)
    u8 = lambda img: img if img.dtype == np.uint8 else img.astype(np.uint8)
    patch = stage(u8(il), r, cl - HALF, 11)
    strip = stage(u8(ir), r, cr - HALF - SLIDE, 21)
    s = lane_sads(patch, strip).astype(F32)                          # exact integers
    arg = np.argmin(s, axis=1)
    bc = np.clip(arg, 1, 9)
    pick = lambda o: s[np.arange(N), o]
    sm, s0, sp = pick(bc - 1), pick(bc), pick(bc + 1)
    denom = F32(2.0) * ((sm + sp) - F32(2.0) * s0)
    denom = np.where(denom < F32(1e-6), F32(1e-6), denom)
    delta = np.clip((sm - sp) / denom, F32(-1), F32(1))
    u = (cr.astype(F32) + (bc - SLIDE).astype(F32)) + delta
    ok &= np.abs(delta) <= 1
    thr = F32(np.inf)
    if N and ok.all():
        keys = s0.astype(np.int64)
        lo, hi = (F32(select_kth(keys, k)) for k in ((N - 1) // 2, N // 2))
        assert (lo, hi) == (F32(np.sort(keys)[(N - 1) // 2]), F32(np.sort(keys)[N // 2]))
        thr = (F32(lo + hi) * F32(0.5)) * F32(2.1)
    k = ok & (s0 <= thr)
    d = ul - u
    has = k & (d > F32(0.1))
    depth = np.where(has, (F32(1) / np.where(d < F32(0.1), F32(0.1), d)) * F32(BF), F32(0))
    uvr = np.stack([ul, vl, np.where(has, u, F32(-1))], 1)
    return u, k, depth.astype(F32), uvr


def _plain(il, ir, kl, kr):
    dev = torch.device("cpu")
    return kst.stereo_refine_plain(t(il), t(ir), chip_smoke.stereo_keypoints(torch, torb, kl, dev),
                                   chip_smoke.stereo_keypoints(torch, torb, kr, dev), t(SF), BF,
                                   float(np.float32(RIG.baseline)))


@pytest.mark.parametrize("case", chip_smoke.STEREO_CASES + tuple(
    c for c in chip_smoke.STEREO_EDGE_CASES if c != "wide right"))
def test_refine_emulation_matches_the_plain_chain(case):
    """(``wide right`` changes only the match, whose column chunks
    ``test_torch_epipolar_emulation.test_chunks_above_one_launch`` holds.)"""
    il, ir, kl, kr = _case(case)
    got = emulate(il, ir, kl, kr)
    ref = _plain(il, ir, kl, kr)
    for g, r, name in zip(got, ref, ref._fields):
        r = n(r)
        assert g.dtype == r.dtype or name == "ok", name
        np.testing.assert_array_equal(g.view(np.int32) if g.dtype == F32 else g,
                                      r.view(np.int32) if r.dtype == F32 else r, err_msg=name)
    N = kl["xy"].shape[0]
    if case in ("all_ok", "odd", "even", "sad ties", "float images"):
        assert N > 1000 and 0 < got[1].sum() < N          # the median gate rejected some
    if case == "one not ok":                              # the gate is off: all but one
        assert got[1].sum() == N - 1


def test_select_kth_two_digits():
    """Every order statistic of tie-heavy and spread keys below 2^16, N odd
    and even, and N 1."""
    rng = np.random.default_rng(0)
    for keys in (rng.integers(0, 1 << 16, 999), rng.integers(0, 4, 1000),
                 np.full(7, 61710), np.array([5]), rng.integers(250, 262, 513)):
        srt = np.sort(keys)
        for k in sorted({0, (keys.size - 1) // 2, keys.size // 2, keys.size - 1}):
            assert select_kth(keys, k) == srt[k]


@pytest.mark.parametrize("case", ["all_ok", "one not ok", "sad ties"])
def test_refine_emulation_against_jax(case):
    """The JAX ``match_stereo`` + ``subpixel_refine`` + depth tail on the
    same numpy inputs: flags and (u, v) exact, u_r to 1e-4 px, depth to
    1e-6 relative (``test_torch_stereo_kernel.py``'s tolerances)."""
    il, ir, kl, kr = _case(case)
    ur_e, ok_e, depth_e, uvr_e = emulate(il, ir, kl, kr)
    j = lambda d: (jnp.asarray(d["xy"]), jnp.asarray(d["level"]),
                   jnp.asarray(d["desc"].view(np.uint32)), jnp.asarray(d["valid"]))
    idx, disp, ok = jst.match_stereo(*j(kl), *j(kr), jnp.asarray(SF), jnp.asarray(F32(BF)),
                                     jnp.asarray(F32(RIG.baseline)))
    xy = jnp.asarray(kl["xy"])
    ur, ok2 = jst.subpixel_refine(jnp.asarray(il, jnp.float32), jnp.asarray(ir, jnp.float32), xy,
                                  xy[:, 0] - disp, ok)
    disparity = xy[:, 0] - ur
    has = ok & ok2 & (disparity > 0.1)
    depth = np.asarray(jnp.where(has, BF / jnp.maximum(disparity, 0.1), 0.0))
    np.testing.assert_array_equal(ok_e, np.asarray(ok2))
    np.testing.assert_array_equal(uvr_e[:, :2], kl["xy"])
    np.testing.assert_allclose(ur_e, np.asarray(ur), rtol=1e-6, atol=1e-4)
    np.testing.assert_allclose(depth_e, depth, rtol=1e-6, atol=0)
