"""An emulation, in numpy on the CPU, of the order of ``orb_describe``
(``csrc/orb.cu``), which runs only on a card.

The kernel walks the keypoints two a warp, side by side (keypoints
2 w and 2 w + 1 in warp w; past the last one a warp repeats it and stores
nothing). For each keypoint a lane takes a patch column (lane 31 repeats
column 15, never read): its two moments' chains over the 31 rows in order,
``fma(p, u, s)`` in float64, where ``p u`` is exact (a float32 times an
integer of at most 15: 24 + 4 bits), so that the fma rounds once where the
plain version's add does. Then two lanes a keypoint add the 31 column sums
in column order from shared memory, the moments are rounded to float32
before ``atan2`` (evaluated, with the cosine and sine, an image a call as
the plain version evaluates them: torch's CPU functions round the last bit
by a value's place in a call). A lane holds its 32 pattern coordinates (taps
``32 w + lane`` and ``32 w + lane + 256``, w < 8) and gathers its 16 blurred
pixels a keypoint, clipped to the pattern radius 19, before any compare; a
ballot a word packs test ``32 w + lane`` at bit ``lane``, lane ``8 k + w``
stores word w of keypoint k.

Held bit-equal to ``describe_plain`` on the SMALL frames and on a rendered
1241x376 KITTI-shaped pair, with one and two images, a keypoint count that
is not a multiple of the warp's two, and keypoints at the patch edge of
every level; and within ``test_describe_plain_matches_jax``'s tolerance of
the JAX package's ``compute_orientation_stacked`` /
``compute_descriptors_stacked`` (angles to 2e-4 rad, 1e-6 on level 0;
words equal given the same angle). The fma's premise is checked over every
pixel of every level plane of the rendered pair and over float32's
extremes: ``float64(p) * u`` equals the integer product of ``p``'s
significand and ``u``, scaled by ``p``'s exponent.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tc2li_slam_tpu.ops import orb as jorb
from tc2li_slam_torch.io import synthetic as syn
from tc2li_slam_torch.ops import orb as torb
from tc2li_slam_torch.ops.kernels import fast, orb as korb
from test_torch_orb_kernels import _jax_stacks
from torch_parity import n, small_sequence, t, words_u32

KP = 2             # csrc/orb.cu kDescKp: keypoints a warp
TAP_RADIUS = 19    # kTapRadius: the pattern's clip radius
HALF = korb.HALF_PATCH


def describe_emulated(img_stack, blur_stack, rows, cols, level, n_levels: int, pad: int):
    """The kernel's order in numpy: (angles [B, K] float32, words [B, K, 8]
    int32) of the keypoints [B, K] on planes ``b * n_levels + level``."""
    img = np.asarray(img_stack, np.float32)
    blur = np.asarray(blur_stack, np.float32)
    B, K = rows.shape
    nk = B * K
    warps = -(-nk // KP)
    # the walk: warp w takes keypoints KP w + k, the last one repeated past nk
    kp = np.minimum(np.arange(warps)[:, None] * KP + np.arange(KP)[None], nk - 1)
    plane = (kp // K) * n_levels + np.asarray(level).reshape(-1)[kp]
    r = np.asarray(rows).reshape(-1)[kp].astype(np.int64) + pad
    c = np.asarray(cols).reshape(-1)[kp].astype(np.int64) + pad
    # a lane a column; the rows in order, the fma exact-product chains
    lane = np.arange(32)
    u = np.minimum(lane, 2 * HALF) - HALF
    dy = np.arange(-HALF, HALF + 1)
    p = img[plane[..., None, None], r[..., None, None] + dy[:, None],
            c[..., None, None] + u[None, :]].astype(np.float64)          # [warps, KP, 31, 32]
    inside = np.abs(u)[None, :] <= np.asarray(korb._UMAX)[np.abs(dy)][:, None]
    wu = np.where(inside, u[None, :], 0).astype(np.float64)
    wv = np.where(inside, dy[:, None], 0).astype(np.float64)
    s10 = np.zeros((warps, KP, 32))
    s01 = np.zeros((warps, KP, 32))
    for d in range(2 * HALF + 1):
        s10 = s10 + p[:, :, d] * wu[d]
        s01 = s01 + p[:, :, d] * wv[d]
    # the column sums added in column order (lanes 0..30)
    m10 = np.zeros((warps, KP))
    m01 = np.zeros((warps, KP))
    for dx in range(2 * HALF + 1):
        m10 = m10 + s10[..., dx]
        m01 = m01 + s01[..., dx]
    # atan2, cos and sin of one image's keypoints in one call, as the plain
    # version calls them: torch's CPU versions round the last bit by a
    # value's place in a call (vector body or scalar tail)
    m10k, m01k = np.zeros(nk), np.zeros(nk)
    m10k[kp], m01k[kp] = m10, m01
    ang_k, ca_k, sb_k = (np.zeros(nk, np.float32) for _ in range(3))
    for b in range(B):
        ib = slice(b * K, (b + 1) * K)
        a_b = torch.atan2(t(m01k[ib].astype(np.float32)), t(m10k[ib].astype(np.float32)))
        ang_k[ib], ca_k[ib], sb_k[ib] = n(a_b), n(torch.cos(a_b)), n(torch.sin(a_b))
    ca, sb = ca_k[kp][..., None], sb_k[kp][..., None]
    # the lanes' taps: tap j = 32 w + lane (+ 256) of each keypoint, gathered
    pat = n(korb._constants(torch.device("cpu"))["pattern"])             # [2, 512]
    x, y = pat[0][None, None], pat[1][None, None]
    R = np.float32(TAP_RADIUS)
    ro = np.clip(np.rint(x * sb + y * ca), -R, R).astype(np.int64)
    co = np.clip(np.rint(x * ca - y * sb), -R, R).astype(np.int64)
    tap = np.rint(blur[plane[..., None], r[..., None] + ro, c[..., None] + co])   # [warps, KP, 512]
    bits = (tap[..., :256] < tap[..., 256:]).reshape(warps, KP, 8, 32).astype(np.uint64)
    words = (bits << lane.astype(np.uint64)).sum(-1).astype(np.uint32).view(np.int32)
    # lane 8 k + w stores word w of keypoint KP w' + k; none past nk
    angles = ang_k[kp].reshape(-1)[:nk].reshape(B, K)
    return angles, words.reshape(-1, 8)[:nk].reshape(B, K, 8)


def _check(imgs, n_features, cut=None):
    """The pair's stacks and grid top-k through the plain versions, then the
    emulation against ``describe_plain`` bit for bit."""
    st, bl, shapes = korb.level_planes_plain(imgs, 8, 1.2)
    scores = fast.detect_planes(st, shapes, korb.PAD)
    rows, cols, _, level, _ = korb.select_grid_plain(
        scores, shapes, torb.features_per_level(n_features, 8, 1.2), 1.2)
    if cut is not None:
        rows, cols, level = (x[:, :cut].contiguous() for x in (rows, cols, level))
    ang, words = describe_emulated(st, bl, rows, cols, level, 8, korb.PAD)
    ref_ang, ref_words = korb.describe_plain(st, bl, rows, cols, level, 8, korb.PAD)
    np.testing.assert_array_equal(ang.view(np.int32), n(ref_ang).view(np.int32))
    np.testing.assert_array_equal(words, n(ref_words))
    return st, bl, shapes


@pytest.fixture(scope="module")
def kitti_pair():
    """Frame 0 of ``chip_smoke.py``'s KITTI-shaped sequence, float32 [2, 376, 1241]."""
    world = syn.make_world(np.random.default_rng(0), n_surf=1000)
    T_wb = syn.trajectory_poses(syn.Trajectory(w_body=(0, 0, 0.03), v_world=(1.5, 0.1, 0.0)), 1)[0]
    lr = syn.render_stereo(syn.World(planes=world.planes, surf=None), syn.KITTI_LIKE, T_wb)
    return torch.as_tensor(np.clip(np.stack(lr), 0, 255).astype(np.uint8)).float()


def _small_pair():
    fr = small_sequence(1)[0]
    return torch.as_tensor(np.stack([np.asarray(fr.img_l), np.asarray(fr.img_r)])).float()


@pytest.mark.parametrize("n_images", [1, 2])
@pytest.mark.parametrize("cut", [None, 1001])
def test_emulation_matches_plain_small(n_images, cut):
    """The SMALL frames at 512 features: every keypoint, and the first 1,001
    of each image (the last warp holds one)."""
    _check(_small_pair()[:n_images].contiguous(), 512, cut)


@pytest.mark.parametrize("n_images", [1, 2])
def test_emulation_matches_plain_kitti(kitti_pair, n_images):
    """The rendered 1241x376 pair at 2,000 features an image; with one
    image an odd count (1,999) as well."""
    _check(kitti_pair[:n_images].contiguous(), 2000)
    if n_images == 1:
        _check(kitti_pair[:1].contiguous(), 2000, cut=1999)


@pytest.mark.parametrize("n_images", [1, 2])
def test_emulation_at_the_patch_edge_of_every_level(kitti_pair, n_images):
    """Keypoints on every level's corners, edge midpoints and centre (9 a
    level) and one more on level 7, 73 an image (the last warp holds one):
    the patch and the taps reach the padded border."""
    imgs = kitti_pair[:n_images].contiguous()
    st, bl, shapes = korb.level_planes_plain(imgs, 8, 1.2)
    rs, cs, ls = [], [], []
    for lvl in range(8):
        Hl, Wl = shapes[lvl]
        for rr in (0, Hl // 2, Hl - 1):
            for cc in (0, Wl // 2, Wl - 1):
                rs.append(rr)
                cs.append(cc)
                ls.append(lvl)
    rs.append(shapes[7][0] - 1)
    cs.append(0)
    ls.append(7)
    mk = lambda v: torch.tensor([v] * n_images, dtype=torch.int32)
    rows, cols, level = mk(rs), mk(cs), mk(ls)
    ang, words = describe_emulated(st, bl, rows, cols, level, 8, korb.PAD)
    ref_ang, ref_words = korb.describe_plain(st, bl, rows, cols, level, 8, korb.PAD)
    np.testing.assert_array_equal(ang.view(np.int32), n(ref_ang).view(np.int32))
    np.testing.assert_array_equal(words, n(ref_words))


@pytest.mark.parametrize("n_images", [1, 2])
def test_emulation_close_to_jax(n_images):
    """Against the JAX package's orientation and descriptors on its own
    stacks and keypoints (SMALL frames, 4 levels, 512 features):
    ``test_describe_plain_matches_jax``'s tolerance."""
    fr = small_sequence(1)[0]
    imgs = [np.asarray(fr.img_l), np.asarray(fr.img_r)][:n_images]
    img_stack, blur_stack, rows, cols, lvl, pad = _jax_stacks(imgs)
    ang, words = describe_emulated(img_stack, blur_stack, rows.astype(np.int32),
                                   cols.astype(np.int32), lvl, 4, pad)
    for b in range(n_images):
        planes = slice(4 * b, 4 * b + 4)
        args_j = [jnp.asarray(a) for a in (img_stack[planes], lvl[b], rows[b], cols[b])]
        ang_j = np.asarray(jorb.compute_orientation_stacked(*args_j, pad))
        np.testing.assert_allclose(ang[b], ang_j, rtol=0, atol=2e-4)
        np.testing.assert_allclose(ang[b][lvl[b] == 0], ang_j[lvl[b] == 0], rtol=0, atol=1e-6)
        dj = np.asarray(jorb.compute_descriptors_stacked(jnp.asarray(blur_stack[planes]),
                                                         *args_j[1:], jnp.asarray(ang_j), pad))
        same = ang[b] == ang_j   # given the same angle, the same words
        np.testing.assert_array_equal(words_u32(torch.as_tensor(words[b]))[same], dj[same])


def _exact_product(p: np.ndarray, u: int) -> np.ndarray:
    """p u from the integer product of p's 24-bit significand and u, scaled
    by p's exponent (float64 holds it exactly: at most 28 bits)."""
    m, e = np.frexp(p.astype(np.float64))
    sig = (m * 2.0 ** 24).astype(np.int64)
    assert np.array_equal(np.ldexp(sig.astype(np.float64), e - 24), p.astype(np.float64))
    return np.ldexp((sig * u).astype(np.float64), e - 24)


def test_moment_products_are_exact_in_float64(kitti_pair):
    """``float64(p) * u`` for |u| <= 15 equals the exact product, for every
    pixel of every level plane of the rendered pair and at float32's
    extremes (largest, smallest normal, smallest subnormal, near 1 and
    255): so the kernel's fma(p, u, s) rounds once, as s + p u does."""
    st, _, shapes = korb.level_planes_plain(kitti_pair, 8, 1.2)
    pix = np.concatenate([n(st[p, :h, :w]).reshape(-1) for p, (h, w) in enumerate(shapes)])
    fi = np.finfo(np.float32)
    extremes = np.array([fi.max, -fi.max, fi.tiny, fi.smallest_subnormal, 1.0,
                         np.nextafter(np.float32(1), np.float32(2)), 254.99998, 255.0, 0.0],
                        np.float32)
    vals = np.unique(np.concatenate([pix, extremes]).astype(np.float32))
    assert vals.size > 1000
    for u in range(-HALF, HALF + 1):
        got = vals.astype(np.float64) * np.float64(u)
        np.testing.assert_array_equal(got, _exact_product(vals, u))
