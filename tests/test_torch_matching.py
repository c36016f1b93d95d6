"""Parity: Hamming matrix, matchers and stereo matching of tc2li_slam_torch
vs tc2li_slam_tpu (MXU and XOR Hamming formulations)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tc2li_slam_tpu.ops import matching as jm, stereo as jst
from tc2li_slam_tpu.ops.kernels.hamming import hamming_matrix_mxu
from tc2li_slam_torch.ops import matching as tm, stereo as tst
from tc2li_slam_torch.ops.kernels import hamming as th
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
