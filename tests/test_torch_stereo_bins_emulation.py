"""The stereo mode of ``csrc/match.cu`` (``match_best2_stereo_kernel``: each
block sorts side 2 into row bins, then a warp a row walks them)
emulated in torch on the CPU, where the kernel cannot run, and held bit for
bit against the matcher's plain version (``match_best2_plain``) and,
through the matcher's tail, against the JAX ``match_stereo``.

The emulation repeats the kernel's steps in float32: the build's classes (a
valid column whose v and band are finite and band >= 0 is binned; a valid
column of band +inf goes to the list every valid row walks; any other
admits nothing), the v extent of the binned columns and its power-of-two
scale, each binned column's bin clamp(floor((v - vmin) x scale), 0, 1023),
the CSR layout (bins in order, the +inf list after them; inside a bin the
kernel's order is that of its atomics, here column order) and the reach
(the largest band of a binned column); then a row's bins, from the bounds
v1 -+ reach widened by 2^-20 (|v1| + reach), and the walk: a warp a row, a
lane every 32nd column of the row's CSR range and of the list, each lane's
two smallest keys (distance << 16 | column), the lanes merged as by the
kernel's shuffles.

Each case checks that every pair the plain mask admits is visited, that the
walk's (idx, best, second) and the columns' first best rows equal the plain
version's, and, where the bands are the frame build's 2 x 1.2^level, that
the match after the distance, ratio and mutual tests equals the JAX
package's ``match_stereo``.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from tc2li_slam_tpu.ops import stereo as jst
from tc2li_slam_torch.io import synthetic as syn
from tc2li_slam_torch.ops import matching as tm, orb as torb
from tc2li_slam_torch.ops.kernels import match as tmatch
from tc2li_slam_torch.ops.kernels.hamming import hamming_matrix_plain
from torch_parity import n, t

BINS_LOG2 = 10           # csrc/match.cu kBinsLog2
BINS = 1 << BINS_LOG2    # kBins
LANES = 32               # a warp a row
NO_KEY = 2 ** 31 - 1     # kNoKey
F32 = torch.float32
STEREO_SEED = {case: 20 + k for k, case in enumerate(chip_smoke.STEREO_BIN_CASES)}
RIG = syn.KITTI_LIKE
SF = (1.2 ** np.arange(8)).astype(np.float32)
BF = float(np.float32(RIG.fx) * np.float32(RIG.baseline))


def f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=F32)


def bin_scale(extent: float) -> float:
    """``bin_scale``: a power of two with extent x scale < 1024."""
    if not extent > 0:
        return 1.0
    if not np.isfinite(extent):
        return 2.0 ** -126
    _, ex = np.frexp(np.float32(extent))
    return float(np.ldexp(np.float32(1.0), max(-126, min(BINS_LOG2 - int(ex), 126))))


def bin_of(v: torch.Tensor, vmin: float, scale: float) -> torch.Tensor:
    """``bin_of``: clamp(floor((v - vmin) x scale), 0, 1023), NaN to 0."""
    f = torch.floor((v - f32(vmin)) * f32(scale))
    f = torch.where(torch.isnan(f), f32(0.0), f)
    return torch.clamp(f, 0, BINS - 1).to(torch.int64)


def build(mask: tmatch.StereoMask, valid2: torch.Tensor) -> dict:
    """A block's build: classes, bins, CSR start, the list, the reach."""
    v, band = mask.uv2[:, 1], mask.band
    binned = valid2 & torch.isfinite(v) & torch.isfinite(band) & (band >= 0)
    wide = valid2 & (band == float("inf"))
    if bool(binned.any()):
        vmin = float(v[binned].min())
        scale = bin_scale(float(f32(float(v[binned].max())) - f32(vmin)))
        reach = float((band[binned] + 0.0).max())
    else:
        vmin, scale, reach = 0.0, 1.0, -1.0
    b = torch.where(binned, bin_of(torch.where(binned, v, f32(0.0)), vmin, scale), -1)
    counts = torch.bincount(b[binned], minlength=BINS)
    start = torch.cat([torch.zeros(1, dtype=torch.int64), torch.cumsum(counts, 0)])
    cols = torch.arange(v.shape[0])
    order = torch.cat([cols[binned][torch.argsort(b[binned], stable=True)], cols[wide]])
    return dict(binned=binned, wide=wide, vmin=vmin, scale=scale, bin=b, start=start,
                order=order, n_binned=int(binned.sum()), reach=reach)


def row_ranges(mask: tmatch.StereoMask, valid1: torch.Tensor, bd: dict):
    """Each row's first and last bin (b0 > b1: none)."""
    v1 = mask.uv1[:, 1]
    r = f32(bd["reach"])
    has = valid1 & torch.isfinite(v1) & (r >= 0)
    v = torch.where(has, v1, f32(0.0))
    e = (torch.abs(v) + r) * f32(2.0 ** -20)
    b0 = bin_of((v - r) - e, bd["vmin"], bd["scale"])
    b1 = bin_of((v + r) + e, bd["vmin"], bd["scale"])
    return torch.where(has, b0, 1), torch.where(has, b1, 0)


def pair_test(mask, i, m) -> bool:
    """The kernel's comparisons for row i and column m, in float32 and
    int32 (the level difference wraps as the kernel's)."""
    dl = (int(mask.lvl2[m]) - int(mask.lvl1[i]) + 2 ** 31) % 2 ** 32 - 2 ** 31
    disp = mask.uv1[i, 0] - mask.uv2[m, 0]
    return bool((torch.abs(mask.uv1[i, 1] - mask.uv2[m, 1]) <= mask.band[m])
                & (disp >= -2.0) & (disp <= f32(mask.max_d))) and mask.lo <= dl <= mask.hi


def keep_two(k1, k2, k):
    return min(k1, k), min(k2, max(k1, k))


def emu_stereo(d1, d2, valid1, valid2, mask, mutual=False, walk_rows=None):
    """The kernels' outputs (idx, best, second, back or None) and the
    visited [N, M] pairs. Rows in ``walk_rows`` (default: all) take the
    literal walk; the others the same ranges and tests as one [N, M] step."""
    N, M = d1.shape[0], d2.shape[0]
    bd = build(mask, valid2)
    b0, b1 = row_ranges(mask, valid1, bd)
    b = bd["bin"]
    visited = ((bd["binned"][None, :] & (b[None, :] >= b0[:, None]) & (b[None, :] <= b1[:, None]))
               | (bd["wide"][None, :] & valid1[:, None]))
    dist = hamming_matrix_plain(d1, d2).to(torch.int64)
    tested = visited & mask.dense()
    keys = torch.where(tested, (dist << 16) | torch.arange(M)[None, :], NO_KEY)
    k1 = keys.min(1).values
    k2 = torch.where(keys == k1[:, None], NO_KEY, keys).min(1).values
    colbest = torch.full((M,), tmatch.BIG << 32, dtype=torch.int64)
    if mutual:
        both = torch.where(tested, (dist << 32) | torch.arange(N)[:, None], tmatch.BIG << 32)
        colbest = both.min(0).values
    start, order, n_binned = bd["start"], bd["order"], bd["n_binned"]
    n_wide = int(bd["wide"].sum())
    for i in (range(N) if walk_rows is None else walk_rows):
        if not bool(valid1[i]):
            assert int(k1[i]) == NO_KEY
            continue
        lo, hi = int(b0[i]), int(b1[i])
        p0 = int(start[lo]) if lo <= hi else 0
        n_bin = int(start[hi + 1]) - p0 if lo <= hi else 0
        lanes = [(NO_KEY, NO_KEY)] * LANES
        for sub in range(LANES):
            for tt in range(sub, n_bin + n_wide, LANES):
                m = int(order[p0 + tt if tt < n_bin else n_binned + tt - n_bin])
                if pair_test(mask, i, m):
                    lanes[sub] = keep_two(*lanes[sub], (int(dist[i, m]) << 16) | m)
        for off in (16, 8, 4, 2, 1):   # the shuffles: lane l takes lane l ^ off's pair
            lanes = [(min(a1, b1_), min(min(a2, b2), max(a1, b1_)))
                     for (a1, a2), (b1_, b2) in zip(lanes, [lanes[s ^ off] for s in range(LANES)])]
        assert lanes[0] == (int(k1[i]), int(k2[i]))
    none1, none2 = k1 == NO_KEY, k2 == NO_KEY
    idx = torch.where(none1, 0, k1 & 0xFFFF)
    best = torch.where(none1, tmatch.BIG, k1 >> 16).to(torch.int32)
    second = torch.where(none2, tmatch.BIG, k2 >> 16).to(torch.int32)
    back = (colbest & 0xFFFFFFFF) if mutual else None
    return (idx, best, second, back), visited


def check(args, mutual, walk_rows=None):
    """The emulation against the plain version; returns its outputs."""
    d1, d2, valid1, valid2, mask = args
    got, visited = emu_stereo(d1, d2, valid1, valid2, mask, mutual, walk_rows)
    full = valid1[:, None] & valid2[None, :] & mask.dense()
    assert not bool((full & ~visited).any()), "an admitted pair lies outside the walked range"
    ref = tmatch.match_best2_plain(d1, d2, valid1, valid2, mask, mutual)
    for g, r in zip(got, ref):
        assert (g is None) == (r is None)
        if g is not None:
            assert g.dtype == r.dtype and torch.equal(g, r)
    return got, visited


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


@pytest.mark.parametrize("case", chip_smoke.STEREO_CASES)
def test_bins_walk_frame_cases(case):
    """``chip_smoke.STEREO_CASES`` at full width, mutual as the frame build;
    the literal walk on every 7th row; the match after the matcher's tail
    equal to the JAX ``match_stereo``."""
    _, _, kl, kr = chip_smoke.stereo_case(np.random.default_rng(1), case, *_pair())
    max_d = float(np.float32(BF) / np.float32(RIG.baseline))
    band = (np.float32(2.0) * SF[kr["level"]]).astype(np.float32)
    mask = tmatch.StereoMask(t(kl["xy"]), t(kl["level"]), t(kr["xy"]), t(kr["level"]),
                             t(band), max_d)
    N = kl["xy"].shape[0]
    (idx, best, second, back), visited = check(
        (t(kl["desc"]), t(kr["desc"]), t(kl["valid"]), t(kr["valid"]), mask), True,
        walk_rows=range(0, N, 7))
    ok = (best <= tm.TH_HIGH) & t(kl["valid"]) & (best.to(F32) <= 0.9 * second.to(F32))
    ok = ok & (back[idx] == torch.arange(N))
    j = lambda d: (jnp.asarray(d["xy"]), jnp.asarray(d["level"]),
                   jnp.asarray(d["desc"].view(np.uint32)), jnp.asarray(d["valid"]))
    ridx, rdisp, rok = jst.match_stereo(*j(kl), *j(kr), jnp.asarray(SF),
                                        jnp.asarray(np.float32(BF)),
                                        jnp.asarray(np.float32(RIG.baseline)))
    np.testing.assert_array_equal(n(ok), np.asarray(rok))
    np.testing.assert_array_equal(n(idx)[n(ok)], np.asarray(ridx)[n(ok)])
    disp = torch.clamp(t(kl["xy"])[:, 0] - t(kr["xy"])[idx, 0], min=0.01)
    np.testing.assert_array_equal(n(disp)[n(ok)], np.asarray(rdisp)[n(ok)])
    assert int(ok.sum()) > (40 if case == "borders" else 300)
    # the bins' point: a row walks a few percent of the columns
    if case == "frame":
        assert float(visited.sum()) / visited.numel() < 0.1


@pytest.mark.parametrize("case", chip_smoke.STEREO_BIN_CASES)
@pytest.mark.parametrize("mutual", [False, True])
def test_bins_walk_edge_cases(case, mutual):
    """``chip_smoke.stereo_bins_case``'s edge cases; the literal walk on the
    rows the case edits and a sample of the rest."""
    c = chip_smoke.stereo_bins_case(np.random.default_rng(STEREO_SEED[case]), case)
    args = chip_smoke.stereo_bins_args(torch, tmatch, c, "cpu")
    N = args[0].shape[0]
    (idx, best, _, _), visited = check(args, mutual,
                                       walk_rows=sorted(set(range(64)) | set(range(0, N, 23))))
    mask = args[4]
    full = args[2][:, None] & args[3][None, :] & mask.dense()
    assert int(full.sum()) > 0
    if case == "bin edges":
        # rows 0-59: a band below and above each edge column are admitted,
        # one ulp beyond is not, the column itself is
        for i in range(60):
            j = 2 + i // 5
            assert bool(full[i, j]) == (i % 5 in (0, 1, 4)), i
    if case == "non-finite band":
        # a column of band +inf is walked by every valid row, whatever its v
        wide = args[3] & (mask.band == float("inf"))
        assert bool((visited[:, wide] == args[2][:, None]).all())
        # rows far from their sources and at non-finite v still meet them
        assert bool(full[:44][:, wide].any())
    if case == "non-finite position":
        # a row whose v is not finite walks the +inf list alone
        bad_v = args[2] & ~torch.isfinite(mask.uv1[:, 1])
        binned = args[3] & torch.isfinite(mask.uv2[:, 1]) & torch.isfinite(mask.band)
        assert bool(bad_v.any()) and not bool(visited[bad_v][:, binned].any())
    if case == "one bin":
        bd = build(mask, args[3])
        assert bd["scale"] == 1.0 and int(bd["bin"][args[3]].max()) == 0



def test_bins_walk_narrows_the_pairs():
    """At 2,000 x 2,000 with ORB-like levels a row walks under a tenth of
    the columns (the staged kernel tested them all)."""
    c = chip_smoke.stereo_bins_case(np.random.default_rng(5), "levels 0-7")
    args = chip_smoke.stereo_bins_args(torch, tmatch, c, "cpu")
    _, visited = check(args, True, walk_rows=range(0, 2000, 97))
    assert float(visited.sum()) / visited.numel() < 0.1


def test_bin_index_is_monotone():
    """bin_of orders any two floats as they are ordered, for coordinates of
    a few pixels to ~1e38 and any positive finite scale."""
    rng = np.random.default_rng(3)
    xs = np.sort(np.concatenate([rng.uniform(-1e3, 1e3, 2000), rng.normal(0, 1e30, 50),
                                 [0.0, -0.0, 1e-45, -1e-45, 3e38, -3e38, np.inf, -np.inf]])
                 .astype(np.float32))
    for vmin, scale in ((0.0, 2.0), (-37.5, 0.25), (1e-3, 2.0 ** 40), (-3e38, 2.0 ** -126)):
        b = bin_of(torch.as_tensor(xs), vmin, scale)
        assert bool((b[1:] >= b[:-1]).all()) and int(b.min()) >= 0 and int(b.max()) < BINS
    assert bin_scale(376.0) == 2.0 and bin_scale(0.0) == 1.0
    assert 1000.0 * bin_scale(1000.0) < BINS and 1e-30 * bin_scale(1e-30) < BINS
