"""``csrc/match.cu``'s epipolar mode (``match_best2_epipolar_kernel``)
repeated in numpy, and the triangulation match it serves against the JAX
package.

The kernel evaluates the epipolar gate per pair in place of the dense
[N, M] mask of ``ops/matching.epipolar_mask``: each block stages side 2's
valid columns (u2, v2, thresh x sigma2, the column) in any order, a warp
walks a valid row's staged columns on two warps, a lane every 64th, and
keeps the two smallest keys (distance << 16 | column) of the pairs the
gate admits; the lanes' pairs merge by a shuffle tree a warp, the two
warps' through shared memory, and the mutual test takes per column
the smallest (distance << 32 | row). The emulation repeats the gate's
rounding (each float32 operation alone, no multiply-add, the clamp of
l0^2 + l1^2 at 1e-12 that keeps NaN) and the walk, on
``chip_smoke.epipolar_case``'s edge cases, and holds it bit for bit against
``EpipolarMask``'s plain chain (the expanded gate and
``match_best2_plain``); the CPU route (``match_best2``) is that chain, in
column chunks above one launch's columns. Against the JAX
``epipolar_mask`` + ``match_descriptors`` the results are exact except at
pairs within one rounding of the gate (XLA may contract the line's
multiply-adds): the test names and counts them.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from tc2li_slam_tpu.ops import matching as jm
from tc2li_slam_torch.ops import matching as tm
from tc2li_slam_torch.ops.kernels import match
from torch_parity import n

F32 = np.float32
NO_KEY = np.iinfo(np.int64).max
ROW_WARPS = 2   # csrc/match.cu kEpiRowWarps: a row's warps


def test_row_split_is_the_kernels():
    """The emulation walks a row on as many warps as the kernel does."""
    src = (Path(__file__).resolve().parents[1] / "tc2li_slam_torch" / "csrc" /
           "match.cu").read_text()
    assert int(re.search(r"constexpr int kEpiRowWarps = (\d+);", src).group(1)) == ROW_WARPS


def _case(case):
    return chip_smoke.epipolar_case(np.random.default_rng(100 + chip_smoke.EPI_CASES.index(case)),
                                    case)


def _lines(c):
    """The rows' lines as the port computes them (``epipolar_lines``)."""
    if "lines" in c:
        return c["lines"]
    return n(match.epipolar_lines(torch.as_tensor(c["uv1"]), torch.as_tensor(c["F12"])))


def gate(lines, uv2, sigma2, thresh):
    """The kernel's gate of every (row, column) pair, [N, M] bool: float32
    operations one at a time, as ``epi_admits`` and the staged product."""
    with np.errstate(all="ignore"):
        l0, l1, l2 = (lines[:, k:k + 1].astype(F32) for k in range(3))
        u2, v2 = uv2[None, :, 0].astype(F32), uv2[None, :, 1].astype(F32)
        num = np.abs((l0 * u2 + l1 * v2) + l2)
        den2 = l0 * l0 + l1 * l1
        den = np.where(den2 < F32(1e-12), F32(1e-12), den2)   # NaN < x is False: NaN stays
        d2 = (num * num) / den
        t = F32(thresh) * sigma2.astype(F32)[None, :]
        assert d2.dtype == np.float32 and t.dtype == np.float32
        return d2 < t


def popcount_rows(a, b):
    """Hamming distances of uint32 words a [N, 8] and b [M, 8]: [N, M]."""
    x = a[:, None, :] ^ b[None, :, :]
    return np.unpackbits(x.view(np.uint8), axis=-1).sum(-1).astype(np.int64)


def staged_order(rng, valid2, threads=256, stage=4):
    """The columns in the order a block may stage them: each warp's ballot
    over 32 consecutive columns (of a loop step's ``stage`` loads) lands
    where its shared atomicAdd puts it, in any order of the warps."""
    M = valid2.shape[0]
    groups = [np.arange(w0, min(w0 + 32, M)) for w0 in range(0, M, 32)]
    order = rng.permutation(len(groups))
    cols = np.concatenate([groups[g] for g in order]) if groups else np.zeros(0, int)
    return cols[valid2[cols]]


def emulate(c, mask, mutual, rng):
    """The kernel's outputs (idx, best, second, back) for an epipolar case
    and its ``EpipolarMask``."""
    lines, d1, d2 = _lines(c), c["d1"], c["d2"]
    N, M = d1.shape[0], d2.shape[0]
    idx = np.zeros(N, np.int64)
    best = np.full(N, match.BIG, np.int32)
    second = np.full(N, match.BIG, np.int32)
    colbest = np.full(M, np.int64(match.BIG) << 32, np.int64)
    for c0, c1 in match.chunk_bounds(M, mask):
        cols = staged_order(rng, c["valid2"][c0:c1])            # chunk-local columns
        rows = np.nonzero(c["valid1"])[0]
        if rows.size == 0 or cols.size == 0:
            continue
        adm = gate(lines[rows], c["uv2"][c0:c1][cols], c["sigma2"][c0:c1][cols], c["thresh"])
        dist = popcount_rows(d1[rows], d2[c0:c1][cols])
        keys = np.where(adm, (dist << 16) | cols[None, :], NO_KEY)
        # a row's ROW_WARPS x 32 lanes: lane L of warp h the staged positions
        # t = 32 h + L (mod 32 ROW_WARPS), its two smallest keys
        width = 32 * ROW_WARPS
        pad = -keys.shape[1] % width
        lanes = np.concatenate([keys, np.full((keys.shape[0], pad), NO_KEY)], 1)
        lanes = lanes.reshape(keys.shape[0], -1, width)
        two = np.sort(lanes, axis=1)[:, :2, :]
        if two.shape[1] == 1:
            two = np.concatenate([two, np.full_like(two, NO_KEY)], 1)
        pairs = []
        for h in range(ROW_WARPS):                            # each warp's shuffle tree
            k1, k2 = two[:, 0, 32 * h:32 * h + 32], two[:, 1, 32 * h:32 * h + 32]
            off = 16
            while off:
                o1 = k1[:, np.arange(32) ^ off]
                o2 = k2[:, np.arange(32) ^ off]
                k2 = np.minimum(np.maximum(k1, o1), np.minimum(k2, o2))
                k1 = np.minimum(k1, o1)
                off >>= 1
            pairs.append((k1[:, 0], k2[:, 0]))
        k1, k2 = pairs[0]
        for o1, o2 in pairs[1:]:                              # merged on the first warp
            k2 = np.minimum(np.maximum(k1, o1), np.minimum(k2, o2))
            k1 = np.minimum(k1, o1)
        # the chunk's row results merged as match.py merges chunks
        i = np.where(k1 == NO_KEY, 0, k1 & 0xFFFF) + c0
        b = np.where(k1 == NO_KEY, match.BIG, k1 >> 16).astype(np.int32)
        s = np.where(k2 == NO_KEY, match.BIG, k2 >> 16).astype(np.int32)
        if c0 == 0:
            idx[rows], best[rows], second[rows] = i, b, s
        else:
            keep = best[rows] <= b
            second[rows] = np.where(keep, np.minimum(second[rows], b),
                                    np.minimum(best[rows], s))
            idx[rows] = np.where(keep, idx[rows], i)
            best[rows] = np.where(keep, best[rows], b)
        if mutual:   # atomicMin of (distance << 32 | row) per column
            packed = np.where(adm, (dist << 32) | rows[:, None], NO_KEY).min(0)
            colbest[c0 + cols] = np.minimum(colbest[c0 + cols], packed)
    return idx, best, second, (colbest & 0xFFFFFFFF) if mutual else None


@pytest.mark.parametrize("case", chip_smoke.EPI_CASES)
def test_gate_repeats_the_plain_chain(case):
    """The per-pair gate with its rounding pinned equals ``epipolar_gate``
    (and so ``epipolar_mask``) bit for bit."""
    c = _case(case)
    lines = _lines(c)
    want = n(match.epipolar_gate(torch.as_tensor(lines), torch.as_tensor(c["uv2"]),
                                 torch.as_tensor(c["sigma2"]), c["thresh"]))
    np.testing.assert_array_equal(gate(lines, c["uv2"], c["sigma2"], c["thresh"]), want)
    if "lines" not in c:
        np.testing.assert_array_equal(
            n(tm.epipolar_mask(*(torch.as_tensor(c[k]) for k in ("uv1", "uv2", "F12", "sigma2")),
                               c["thresh"])), want)


def test_gate_edges():
    """On the gate d2 == thresh x sigma2: not admitted, the float below it
    admitted; l0^2 + l1^2 below 1e-12 clamped, zero lines a finite
    distance; NaN lines, positions and sigma2 admit nothing."""
    c = _case("on the gate")
    g = gate(_lines(c), c["uv2"], c["sigma2"], c["thresh"])
    assert g[:6, 11].all() and not g[:6, 10].any() and not g[:6, 12].any()
    c = _case("tiny lines")
    lines = _lines(c)
    den2 = lines[:8, 0] * lines[:8, 0] + lines[:8, 1] * lines[:8, 1]
    assert (den2 < F32(1e-12)).sum() >= 5 and (den2 >= F32(1e-12)).sum() >= 1
    g = gate(lines, c["uv2"], c["sigma2"], c["thresh"])
    assert not g[0].any() and g[1, :4].all()   # |0| / 1e-12 = 0 is inside every gate
    c = _case("non-finite")
    g = gate(_lines(c), c["uv2"], c["sigma2"], c["thresh"])
    assert not g[[0, 1, 2, 3, 4, 5]].any()
    assert not g[:, [0, 1, 2, 3, 5, 6, 8]].any()


def test_gate_near_the_threshold():
    """Pairs a few float32 roundings either side of the gate (t moved by
    -8..8 ulps around d2), at lines and positions of every magnitude, tiny
    and huge den and t, subnormal and overflowing n2: the kernel's rounding
    is the plain chain's on every pair."""
    rng = np.random.default_rng(9)
    n_rows = 400
    lines = (rng.standard_normal((n_rows, 3)) * 10.0 ** rng.uniform(-8, 8, (n_rows, 1))).astype(F32)
    lines[:20, :2] = rng.uniform(-1, 1, (20, 2)) * F32(2.0 ** 52)     # den beyond 2^100
    lines[20:40, :2] *= F32(1e-30)                                    # den clamped at 1e-12
    uv2 = (rng.uniform(-1, 1, (300, 2)) * 10.0 ** rng.uniform(-3, 4, (300, 1))).astype(F32)
    uv2[:5] = [[3e19, 0], [0, 3e19], [1e-30, 1e-30], [0, 0], [1e30, 1e30]]
    # sigma2 so that t sits k ulps from row 0's d2 at each column
    l0, l1, l2 = lines[0]
    with np.errstate(all="ignore"):
        num = np.abs((l0 * uv2[:, 0] + l1 * uv2[:, 1]) + l2)
        d2 = (num * num) / max(l0 * l0 + l1 * l1, F32(1e-12))
        sig = (d2 / F32(3.84)).astype(F32)
    ks = rng.integers(-8, 9, 300)
    for m, k in enumerate(ks):
        for _ in range(abs(int(k))):
            sig[m] = np.nextafter(sig[m], F32(np.inf) if k > 0 else F32(0))
    sig[5:10] = [2.0 ** -110, 2.0 ** 110, np.inf, 0.0, 2.0 ** -99]
    g = gate(lines, uv2, sig, 3.84)
    want = n(match.epipolar_gate(torch.as_tensor(lines), torch.as_tensor(uv2),
                                 torch.as_tensor(sig), 3.84))
    np.testing.assert_array_equal(g, want)
    assert 0 < g[0].sum() < g.shape[1]      # row 0's near-gate pairs fall either side


@pytest.mark.parametrize("case", chip_smoke.EPI_CASES)
@pytest.mark.parametrize("mutual", [False, True])
def test_walk_matches_the_plain_chain(case, mutual):
    """The kernel's staging and walk, in two staging orders, bit-equal to
    ``match_best2_plain`` on the expanded gate and to the CPU route."""
    c = _case(case)
    args = chip_smoke.epipolar_args(torch, match, c, "cpu")
    ref = match.match_best2_plain(*args, mutual)
    route = match.match_best2(*args, mutual)
    for seed in (0, 1):
        got = emulate(c, args[4], mutual, np.random.default_rng(seed))
        for g, r, q in zip(got, ref, route):
            if r is None:
                assert g is None and q is None
                continue
            np.testing.assert_array_equal(g, n(r))
            np.testing.assert_array_equal(n(q), n(r))
    if case == "ties":     # the first of three tied columns
        assert n(ref[0])[:4].tolist() == [5] * 4
    if case == "wide":     # a tie across the chunk boundary: the earlier chunk
        assert len(match.chunk_bounds(c["d2"].shape[0], args[4])) == 2
        assert int(ref[0][0]) == 7
    if case == "rows invalid":
        assert (n(ref[1]) == match.BIG).all() and (n(ref[0]) == 0).all()


def test_pair_gates_hand_the_descriptor_over():
    """``triangulation.pair_gates`` gives the matcher an ``EpipolarMask``
    (no [F, F] tensor), whose lines are ``epipolar_lines`` of the first
    keyframe's keypoints; the match under it is the dense mask's."""
    from tc2li_slam_torch.geom import camera as tcam
    from tc2li_slam_torch.slam import mapstate as tms, triangulation as ttg
    c = chip_smoke.epipolar_pair(np.random.default_rng(3), 96, 96)
    m = tms.create(max_kf=4, max_feats=96, max_lm=64, max_obs=4, device="cpu")
    T2 = torch.eye(4)
    T2[:3, 3] = torch.tensor([-0.2, 0.02, -1.5])
    for T, uv, d, v in ((torch.eye(4), c["uv1"], c["d1"], c["valid1"]),
                        (T2, c["uv2"], c["d2"], c["valid2"])):
        uv = torch.as_tensor(uv)
        m, _ = tms.add_keyframe(
            m, T, torch.tensor(0.0), uv, torch.cat([uv, torch.full((96, 1), -1.0)], -1),
            torch.zeros(96, dtype=torch.int32), torch.zeros(96),
            torch.as_tensor(d.view(np.int32)), torch.as_tensor(v),
            torch.full((96,), tms.NO_LM, dtype=torch.int32))
    cam = tcam.Pinhole.create(718.856, 718.856, 607.1928, 185.2157, bf=386.1448, width=1241,
                              height=376)
    sigma2 = torch.as_tensor((1.2 ** (2 * np.arange(8))).astype(F32))
    g = ttg.pair_gates(m, 0, 1, cam, sigma2)
    assert isinstance(g.epi, match.EpipolarMask)
    assert torch.equal(g.epi.lines, match.epipolar_lines(m.kf_xy[0], _fundamental(m, cam)))
    dense = g.epi.dense()
    assert 0 < int(dense.sum()) < dense.numel()
    args = (m.kf_desc[0], m.kf_desc[1], g.unm1, g.unm2)
    for a, b in zip(tm.match_descriptors(*args, g.epi, max_dist=40, ratio=0.8, mutual=True),
                    tm.match_descriptors(*args, dense, max_dist=40, ratio=0.8, mutual=True)):
        assert torch.equal(a, b)


def _fundamental(m, cam):
    """F21 of keyframes 0 -> 1, as ``pair_gates`` builds it."""
    from tc2li_slam_torch.geom import lie
    T21 = m.kf_T_cw[1] @ lie.se3_inverse(m.kf_T_cw[0])
    Kinv = torch.as_tensor(np.array([[1.0 / cam.fx, 0.0, -cam.cx / cam.fx],
                                     [0.0, 1.0 / cam.fy, -cam.cy / cam.fy],
                                     [0.0, 0.0, 1.0]]), dtype=torch.float32)
    return Kinv.T @ (lie.hat(T21[:3, 3]) @ T21[:3, :3]) @ Kinv


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_triangulation_match_against_jax(seed):
    """The port's ``match_descriptors`` under the ``EpipolarMask`` against
    the JAX ``epipolar_mask`` + ``match_descriptors`` (max_dist 40, ratio
    0.8, mutual) on a keyframe pair's numpy inputs: the gates differ only
    at pairs within one rounding of the threshold (named and counted), and
    idx, best and ok are equal on every row that no such pair touches."""
    c = chip_smoke.epipolar_pair(np.random.default_rng(seed), 2000, 2000)
    args = chip_smoke.epipolar_args(torch, match, c, "cpu")
    ip, bp, okp = (n(x) for x in tm.match_descriptors(*args, max_dist=40, ratio=0.8,
                                                       mutual=True))
    j = {k: jnp.asarray(c[k]) for k in ("uv1", "uv2", "F12", "sigma2", "d1", "d2",
                                         "valid1", "valid2")}
    mj = np.asarray(jm.epipolar_mask(j["uv1"], j["uv2"], j["F12"], j["sigma2"]))
    ij, bj, okj = (np.asarray(x) for x in jm.match_descriptors(
        j["d1"], j["d2"], j["valid1"], j["valid2"], mask=jnp.asarray(mj), max_dist=40,
        ratio=0.8, mutual=True))
    mp = n(args[4].dense())
    # the distance of each differing pair from the gate, in float64
    x1 = np.concatenate([c["uv1"], np.ones((2000, 1), F32)], -1).astype(np.float64)
    lines = x1 @ c["F12"].astype(np.float64).T
    rows, cols = np.nonzero(mp != mj)
    num = np.abs(lines[rows, 0] * c["uv2"][cols, 0] + lines[rows, 1] * c["uv2"][cols, 1]
                 + lines[rows, 2])
    d2 = num * num / np.maximum(lines[rows, 0] ** 2 + lines[rows, 1] ** 2, 1e-12)
    t = 3.84 * c["sigma2"][cols].astype(np.float64)
    rel = np.abs(d2 - t) / t
    print(f"seed {seed}: {rows.size} of {mp.size} pairs differ at the gate "
          f"{list(zip(rows.tolist(), cols.tolist()))}, relative distance {rel.tolist()}")
    assert rows.size <= 4 and (rel < 1e-5).all()
    touched = np.zeros(2000, bool)
    touched[rows] = True
    touched |= np.isin(ip, cols) | np.isin(ij, cols)
    assert bp.sum() > 0 and okp.sum() > 300
    np.testing.assert_array_equal(ip[~touched], ij[~touched])
    np.testing.assert_array_equal(bp[~touched], bj[~touched])
    np.testing.assert_array_equal(okp[~touched], okj[~touched])


@pytest.mark.parametrize("mask_kind", ["window", "stereo", "epipolar"])
def test_chunks_above_one_launch(mask_kind):
    """Side 2 wider than one launch's columns (13,440 window, 5,120 stereo,
    14,464 epipolar) is matched in column chunks, a launch each on the card:
    the merged rows and the mutual test are the unchunked plain chain's."""
    rng = np.random.default_rng(7)
    M = {"window": match.WINDOW_MAX_COLUMNS, "stereo": match.STEREO_MAX_COLUMNS,
         "epipolar": match.EPI_MAX_COLUMNS}[mask_kind] + 11
    if mask_kind == "window":
        c = chip_smoke.window_case(rng, 48, M)
        args = chip_smoke.window_args(torch, match, c, "cpu")
    elif mask_kind == "stereo":
        c = chip_smoke.stereo_bins_case(rng, "level gate", N=48, M=M)
        args = chip_smoke.stereo_bins_args(torch, match, c, "cpu")
    else:
        args = chip_smoke.epipolar_args(torch, match, chip_smoke.epipolar_case(rng, "wide"), "cpu")
    M = args[1].shape[0]
    # a tie across the chunk boundary: the earlier chunk's column wins
    d2 = args[1].clone()
    last = match.chunk_bounds(M, args[4])[-1][0]
    d2[last + 1] = d2[2]
    mask = match.columns(args[4], 0, M)
    fields = {k: getattr(mask, k).clone() for k in mask.COLUMN_FIELDS}
    for k in mask.COLUMN_FIELDS:
        fields[k][last + 1] = fields[k][2]
    mask = mask._replace(**fields)
    v2 = args[3].clone()
    v2[[2, last + 1]] = True
    assert len(match.chunk_bounds(M, mask)) == 2
    for mutual in (False, True):
        got = match.match_best2(args[0], d2, args[2], v2, mask, mutual)
        ref = match.match_best2_plain(args[0], d2, args[2], v2, mask, mutual)
        for g, r in zip(got, ref):
            assert (g is None) == (r is None)
            if g is not None:
                assert torch.equal(g, r)
        assert int((got[1] < match.BIG).sum()) > 0
