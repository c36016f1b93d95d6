"""Parity: Hamming matrix, matchers and stereo matching of tc2li_slam_torch
vs tc2li_slam_tpu (MXU and XOR Hamming formulations)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tc2li_slam_tpu.ops import matching as jm, stereo as jst
from tc2li_slam_tpu.ops.kernels.hamming import hamming_matrix_mxu
from tc2li_slam_torch.ops import matching as tm, stereo as tst
from tc2li_slam_torch.ops.kernels import hamming as th, match as tmatch
from torch_parity import n, random_words, t


@pytest.mark.parametrize("shape", [(37, 53), (512, 300), (1, 9)])
def test_hamming_exact_vs_mxu_and_xor(rng, shape):
    d1, d2 = random_words(rng, (shape[0], 8)), random_words(rng, (shape[1], 8))
    got = n(th.hamming_matrix(t(d1), t(d2)))
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, np.asarray(jm.hamming_matrix_xor(jnp.asarray(d1), jnp.asarray(d2))))
    np.testing.assert_array_equal(got, np.asarray(hamming_matrix_mxu(jnp.asarray(d1), jnp.asarray(d2))))


def test_hamming_extremes_and_empty():
    zeros = torch.zeros((4, 8), dtype=torch.int32)
    ones = torch.full((4, 8), -1, dtype=torch.int32)
    assert bool((th.hamming_matrix(zeros, ones) == 256).all())
    assert bool((th.hamming_matrix(ones, ones) == 0).all())
    assert th.hamming_matrix(zeros[:0], ones).shape == (0, 4)
    with pytest.raises(ValueError):
        th.hamming_matrix(zeros.to(torch.int64), ones)


def _near_copies(rng, base, m, flip=20):
    """Descriptors near ``base`` rows: a few bits flipped each."""
    idx = rng.integers(0, len(base), m)
    out = base[idx].copy()
    for r in range(m):
        for _ in range(rng.integers(0, flip)):
            b = rng.integers(0, 256)
            out[r, b // 32] ^= np.uint32(1 << (b % 32))
    return out


@pytest.mark.parametrize("mutual,ratio", [(False, 1.0), (True, 0.9), (False, 0.75)])
def test_match_descriptors_exact(rng, mutual, ratio):
    d1 = random_words(rng, (200, 8))
    d2 = _near_copies(rng, d1, 150)
    v1, v2 = rng.random(200) > 0.1, rng.random(150) > 0.1
    mask = rng.random((200, 150)) > 0.3
    rj = jm.match_descriptors(jnp.asarray(d1), jnp.asarray(d2), jnp.asarray(v1), jnp.asarray(v2),
                              jnp.asarray(mask), max_dist=100, ratio=ratio, mutual=mutual)
    rt = tm.match_descriptors(t(d1), t(d2), t(v1), t(v2), t(mask), max_dist=100, ratio=ratio,
                              mutual=mutual)
    for a, b in zip(rt, rj):
        np.testing.assert_array_equal(n(a), np.asarray(b))
    assert n(rt[2]).sum() > 20


def test_search_by_projection_resolve_rotation(rng):
    N, M = 300, 120
    kp_desc = random_words(rng, (M, 8))
    d_map = _near_copies(rng, kp_desc, N, flip=40)
    uv_kp = rng.uniform(0, 640, (M, 2)).astype(np.float32)
    uv_proj = (uv_kp[rng.integers(0, M, N)] + rng.normal(0, 3, (N, 2))).astype(np.float32)
    lvl_kp = rng.integers(0, 4, M).astype(np.int32)
    pred = rng.integers(0, 4, N).astype(np.int32)
    radius = rng.uniform(3, 30, N).astype(np.float32)
    vm, vk = rng.random(N) > 0.05, rng.random(M) > 0.05
    args = (uv_proj, pred, d_map, vm, uv_kp, lvl_kp, kp_desc, vk, radius)
    rj = jm.search_by_projection(*map(jnp.asarray, args))
    rt = tm.search_by_projection(*map(t, args))
    for a, b in zip(rt, rj):
        np.testing.assert_array_equal(n(a), np.asarray(b))
    kj = jm.resolve_duplicates(*rj, M)
    kt = tm.resolve_duplicates(*rt, M)
    np.testing.assert_array_equal(n(kt), np.asarray(kj))
    a1 = rng.uniform(-np.pi, np.pi, N).astype(np.float32)
    a2 = rng.uniform(-np.pi, np.pi, M).astype(np.float32)
    cj = jm.rotation_consistency(jnp.asarray(a1), jnp.asarray(a2), rj[0], kj)
    ct = tm.rotation_consistency(t(a1), t(a2), rt[0], kt)
    np.testing.assert_array_equal(n(ct), np.asarray(cj))
    np.testing.assert_array_equal(n(tm.window_mask(t(uv_proj), t(uv_kp), t(radius))),
                                  np.asarray(jm.window_mask(*map(jnp.asarray, (uv_proj, uv_kp, radius)))))
    np.testing.assert_array_equal(n(tm.level_mask(t(pred), t(lvl_kp))),
                                  np.asarray(jm.level_mask(jnp.asarray(pred), jnp.asarray(lvl_kp))))


def _guided_case(rng, N=260, M=90):
    """Map points near frame keypoints, with the edge rows a matcher meets:
    a row no column passes, a duplicated column (tied minima), invalid rows
    and columns."""
    kp_desc = random_words(rng, (M, 8))
    kp_desc[1] = kp_desc[0]
    d_map = _near_copies(rng, kp_desc, N, flip=30)
    d_map[5] = kp_desc[0]                               # distance 0 to columns 0 and 1
    uv_kp = rng.uniform(0, 320, (M, 2)).astype(np.float32)
    uv_kp[1] = uv_kp[0]
    src = rng.integers(0, M, N)
    src[5] = 0
    uv_map = (uv_kp[src] + rng.normal(0, 3, (N, 2))).astype(np.float32)
    lvl_kp = rng.integers(0, 4, M).astype(np.int32)
    lvl_kp[1] = lvl_kp[0]
    lvl_map = np.clip(lvl_kp[src] + rng.integers(-1, 2, N), 0, 3).astype(np.int32)
    radius = rng.uniform(3, 30, N).astype(np.float32)
    radius[5] = 30.0
    radius[7] = 0.0                                     # valid, admits nothing
    vm, vk = rng.random(N) > 0.1, rng.random(M) > 0.1
    vm[[5, 7]] = True
    vk[[0, 1]] = True
    return dict(d_map=d_map, kp_desc=kp_desc, uv_map=uv_map, uv_kp=uv_kp, lvl_map=lvl_map,
                lvl_kp=lvl_kp, radius=radius, vm=vm, vk=vk)


def _same_ints(rt, rj):
    for a, b in zip(rt, rj):
        assert n(a).dtype.kind == np.asarray(b).dtype.kind
        np.testing.assert_array_equal(n(a), np.asarray(b))


@pytest.mark.parametrize("ratio,max_dist", [(0.9, 100), (1.0, 50)])
def test_window_entry_exact_with_edge_rows(rng, ratio, max_dist):
    c = _guided_case(rng)
    args = (c["uv_map"], c["lvl_map"], c["d_map"], c["vm"], c["uv_kp"], c["lvl_kp"],
            c["kp_desc"], c["vk"], c["radius"])
    rj = jm.search_by_projection(*map(jnp.asarray, args), max_dist=max_dist, ratio=ratio)
    rt = tm.search_by_projection(*map(t, args), max_dist=max_dist, ratio=ratio)
    _same_ints(rt, rj)
    assert rt[0].dtype == torch.int64 and rt[1].dtype == torch.int32 and rt[2].dtype == torch.bool
    idx, best, ok = (n(x) for x in rt)
    assert idx[5] == 0 and best[5] == 0                 # tie -> lowest column
    assert ok[5]                                        # second == best == 0: 0 <= ratio * 0
    assert idx[7] == 0 and best[7] == tm.BIG and not ok[7]


@pytest.mark.parametrize("mutual", [False, True])
def test_best2_plain_all_mask_kinds_exact(rng, mutual):
    """(idx, best, second, back) of the matcher's plain version for the
    window, stereo-band and dense masks against ``jm._masked_best2`` on the
    JAX package's dense masks; integer outputs and dtypes."""
    c = _guided_case(rng)
    band = rng.uniform(2, 8, len(c["vk"])).astype(np.float32)
    ta = {k: t(v) for k, v in c.items()}
    dense = rng.random((len(c["vm"]), len(c["vk"]))) > 0.5
    jw = (jm.window_mask(*map(jnp.asarray, (c["uv_map"], c["uv_kp"], c["radius"])))
          & jm.level_mask(jnp.asarray(c["lvl_map"]), jnp.asarray(c["lvl_kp"])))
    dv = np.abs(c["uv_map"][:, None, 1] - c["uv_kp"][None, :, 1])
    disp = c["uv_map"][:, None, 0] - c["uv_kp"][None, :, 0]
    js = ((dv <= band[None]) & (disp >= -2.0) & (disp <= np.float32(12.5))
          & np.asarray(jm.level_mask(jnp.asarray(c["lvl_map"]), jnp.asarray(c["lvl_kp"]))))
    cases = [
        (tmatch.WindowMask(ta["uv_map"], ta["radius"], ta["lvl_map"], ta["uv_kp"], ta["lvl_kp"]), jw),
        (tmatch.StereoMask(ta["uv_map"], ta["lvl_map"], ta["uv_kp"], ta["lvl_kp"], t(band), 12.5), js),
        (t(dense), dense),
        (None, np.ones_like(dense)),
    ]
    dist = jm.hamming_matrix_xor(jnp.asarray(c["d_map"]), jnp.asarray(c["kp_desc"]))
    for mask_t, mask_j in cases:
        full = jnp.asarray(c["vm"])[:, None] & jnp.asarray(c["vk"])[None, :] & jnp.asarray(mask_j)
        ij, bj, sj = jm._masked_best2(dist, full)
        it, bt, st, back = tmatch.match_best2(ta["d_map"], ta["kp_desc"], ta["vm"], ta["vk"],
                                              mask_t, mutual)
        _same_ints((it, bt, st), (ij, bj, sj))
        assert (it.dtype, bt.dtype, st.dtype) == (torch.int64, torch.int32, torch.int32)
        if mutual:
            bk = jnp.argmin(jnp.where(full, dist, tm.BIG), axis=0)
            np.testing.assert_array_equal(n(back), np.asarray(bk))
            assert back.dtype == torch.int64
        else:
            assert back is None
    with pytest.raises(ValueError):
        tmatch.match_best2(ta["d_map"].long(), ta["kp_desc"], ta["vm"], ta["vk"])
    with pytest.raises(ValueError):
        tmatch.match_best2(ta["d_map"], ta["kp_desc"], ta["vm"].to(torch.int32), ta["vk"])


@pytest.mark.parametrize("mutual", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_column_chunks_merge_exact(rng, monkeypatch, mutual, masked):
    """More columns than one launch of the kernel holds are matched chunk by
    chunk and merged per row (here through ``match_best2`` with the column
    limit lowered): equal to the one-piece match, with a
    duplicated column in a later chunk (the first must stay first) and rows
    whose only admitted column lies in the last chunk."""
    N, M = 200, 700
    d2 = random_words(rng, (M, 8))
    d2[450] = d2[3]
    d2[690] = d2[3]
    d1 = _near_copies(rng, d2, N, flip=6)
    d1[0] = d2[3]
    v1, v2 = rng.random(N) > 0.2, rng.random(M) > 0.3
    v1[0] = v2[3] = v2[450] = v2[690] = True
    mask = rng.random((N, M)) > 0.5 if masked else None
    if masked:
        mask[1] = False
        mask[1, 699] = v1[1] = v2[699] = True
        mask[0, [3, 450, 690]] = True
    args = (t(d1), t(d2), t(v1), t(v2), None if mask is None else t(mask), mutual)
    ref = tmatch.match_best2_plain(*args)
    for chunk in (256, 699, 64):
        monkeypatch.setattr(tmatch, "DENSE_MAX_COLUMNS", chunk)
        got = tmatch.match_best2(*args)
        for a, b in zip(got, ref):
            assert (a is None and b is None) or (a.dtype == b.dtype and torch.equal(a, b))
    assert int(ref[0][0]) == 3 and int(ref[1][0]) == 0 and int(ref[2][0]) == 0


@pytest.mark.parametrize("bf", [12.5, 300.0])
def test_stereo_entry_exact_synthetic(rng, bf):
    """``match_stereo`` (band, disparity range, level gate, mutual, ratio
    0.9) on synthetic keypoints with tied and all-masked rows."""
    c = _guided_case(rng)
    sf = (1.2 ** np.arange(4)).astype(np.float32)
    args = (c["uv_map"], c["lvl_map"], c["d_map"], c["vm"], c["uv_kp"], c["lvl_kp"],
            c["kp_desc"], c["vk"])
    rj = jst.match_stereo(*map(jnp.asarray, args), jnp.asarray(sf), jnp.float32(bf),
                          jnp.float32(1.0))
    rt = tst.match_stereo(*map(t, args), t(sf), bf, 1.0)
    for a, b in zip(rt, rj):
        np.testing.assert_array_equal(n(a), np.asarray(b))
    assert rt[0].dtype == torch.int64 and rt[2].dtype == torch.bool
    assert 0 < n(rt[2]).sum() < len(c["vm"])


@pytest.mark.parametrize("with_nan", [False, True])
def test_median_matches_jnp(rng, with_nan):
    for size in (7, 10):
        x = rng.normal(0, 5, size).astype(np.float32)
        if with_nan:
            x[3] = np.nan
        np.testing.assert_array_equal(n(tst.median_nan(t(x))), np.asarray(jnp.median(jnp.asarray(x))))


def test_stereo_match_and_subpixel(rng):
    from tc2li_slam_tpu.ops import orb as jorb
    from torch_parity import small_sequence
    fr = small_sequence(1)[0]
    kl = jorb.extract(jnp.asarray(fr.img_l), n_features=512, n_levels=4)
    kr = jorb.extract(jnp.asarray(fr.img_r), n_features=512, n_levels=4)
    sf = (1.2 ** np.arange(4)).astype(np.float32)
    bf, base = np.float32(320.0 * 0.5), np.float32(0.5)
    jargs = (kl.xy, kl.level, kl.desc, kl.valid, kr.xy, kr.level, kr.desc, kr.valid)
    rj = jst.match_stereo(*jargs, jnp.asarray(sf), jnp.asarray(bf), jnp.asarray(base))
    rt = tst.match_stereo(*[t(np.asarray(a)) for a in jargs], t(sf), float(bf), float(base))
    for a, b in zip(rt, rj):   # integer selections exact, disparities exact
        np.testing.assert_array_equal(n(a), np.asarray(b))
    assert n(rt[2]).sum() > 100
    ur0 = np.asarray(kl.xy[:, 0] - rj[1])
    img_l, img_r = (np.asarray(fr.img_l, np.float32), np.asarray(fr.img_r, np.float32))
    uj, okj = jst.subpixel_refine(jnp.asarray(img_l), jnp.asarray(img_r), kl.xy,
                                  jnp.asarray(ur0), rj[2])
    ut, okt = tst.subpixel_refine(t(img_l), t(img_r), t(np.asarray(kl.xy)), t(ur0), t(np.asarray(rj[2])))
    np.testing.assert_array_equal(n(okt), np.asarray(okj))
    # SAD sums of integer pixels are exact; the parabola step is one f32 division
    np.testing.assert_allclose(n(ut), np.asarray(uj), rtol=1e-6, atol=1e-4)
