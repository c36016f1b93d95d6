"""Emulations, in numpy on the CPU, of the orders of the two redesigned
kernels of ``csrc/orb.cu``, which run only on a card.

- ``orb_select_grid``: the cell pass writes each candidate's key (rank
  descending, then candidate index ascending) at slot ``cell x m + slot``,
  then a block a plane takes the first k keys by a radix select of the
  k-th key, 8 bits a pass, and orders them by a rank count. Held bit-equal
  to ``select_grid_plain`` and to the reference's ``select_topk_grid`` on
  detected, flat, one-corner and tie-heavy scores, and on 1280x720 planes
  of more than 4,096 candidates.
- ``orb_level_planes``: the tiles of ``level_tiles`` write every pixel of
  every plane's padded region exactly once, each from a level pixel of the
  tile itself, and every tile's resize fits the kernel's row buffer; and a
  tile-by-tile emulation of the kernel's pipeline (level pixels in the
  halo's reflected coordinates, the vertical pass over the tile's image
  columns, then both blurs) is bit-equal to ``level_planes_plain``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tc2li_slam_tpu.ops import orb as jorb
from tc2li_slam_torch.ops import orb as torb
from tc2li_slam_torch.ops.kernels import orb as korb
from torch_parity import n, t

NO_KEY = np.uint64(2 ** 64 - 1)
SIZES = [(376, 1241), (720, 1280), (480, 752), (203, 101), (101, 203), (64, 64)]


# ---------------------------------------------------------------------------
# orb_select_grid
# ---------------------------------------------------------------------------

def cell_pass(score: np.ndarray, k: int):
    """Launch 1: each cell's top m (ties to the lower in-cell index) as keys
    and pixels at slot ``cell m + slot``; ``NO_KEY`` where a slot keeps no
    candidate (its value not > 0, or infinite)."""
    H, W = score.shape
    C = korb.CELL
    Hc, Wc = -(-H // C), -(-W // C)
    n_cells = Hc * Wc
    m = korb.cell_candidates(n_cells, k)
    sp = np.full((Hc * C, Wc * C), -np.inf, np.float32)
    sp[:H, :W] = score
    cells = sp.reshape(Hc, C, Wc, C).transpose(0, 2, 1, 3).reshape(n_cells, C * C)
    order = np.argsort(-cells, axis=1, kind="stable")[:, :m]
    vals = np.take_along_axis(cells, order, axis=1)
    emitted = np.cumprod(vals > 0, axis=1).astype(bool) & (vals < np.inf)
    rank = vals.copy()
    rank[:, 0] = vals[:, 0] + np.float32(1e6)
    bits = (~rank.astype(np.float32).view(np.uint32)).astype(np.uint64)
    cand = np.arange(n_cells * m, dtype=np.uint64).reshape(n_cells, m)
    keys = np.where(emitted, (bits << np.uint64(32)) | cand, NO_KEY).reshape(-1)
    return keys, order.reshape(-1).astype(np.uint8), m, Wc


def radix_select(keys: np.ndarray, k: int) -> np.ndarray:
    """Launch 2's selection: the keys no larger than the key of rank k - 1,
    found 8 bits a pass (the rank's 32 bits, then the candidate index's
    bits), stopping early where a digit's whole group is taken."""
    npos = int((keys != NO_KEY).sum())
    if npos <= k:
        return keys[keys != NO_KEY]
    rank, prefix, mask = k - 1, np.uint64(0), np.uint64(0)
    cb = (keys.size - 1).bit_length()
    for s in range(56, -1, -8):
        if s < 32 and s >= cb:
            continue
        group = keys[(keys & mask) == prefix]
        hist = np.bincount(((group >> np.uint64(s)) & np.uint64(255)).astype(np.int64),
                           minlength=256)
        cum = np.cumsum(hist)
        d = int(np.searchsorted(cum, rank, side="right"))
        rank -= int(cum[d] - hist[d])
        prefix |= np.uint64(d) << np.uint64(s)
        mask |= np.uint64(255) << np.uint64(s)
        if hist[d] == rank + 1:
            break
    sel = keys[(keys & mask) <= prefix]
    assert sel.size == k
    return sel


def select_emulated(score: np.ndarray, k: int):
    """Both launches on one plane: (rows, cols, scores) [k]."""
    keys, pix, m, Wc = cell_pass(score, k)
    sel = radix_select(keys, k)
    slot = np.array([(sel < key).sum() for key in sel], np.int64)   # the rank count
    assert np.array_equal(np.sort(slot), np.arange(sel.size))
    cand = (sel & np.uint64(0xFFFFFFFF)).astype(np.int64)
    cell, q = cand // m, pix[cand].astype(np.int64)
    rows, cols, out = (np.zeros(k, np.int32), np.zeros(k, np.int32), np.zeros(k, np.float32))
    rows[slot] = (cell // Wc) * korb.CELL + (q >> 4)
    cols[slot] = (cell % Wc) * korb.CELL + (q & 15)
    out[slot] = score[rows[slot], cols[slot]]
    return rows, cols, out


def _smooth(seed, shape):
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 255, shape).astype(np.float32)
    return ((img + np.roll(img, 1, 0) + np.roll(img, 1, 1)) / 3).round().astype(np.float32)


def _scores(kind, shape, seed=0):
    rng = np.random.default_rng(seed)
    H, W = shape
    if kind == "flat":
        return np.zeros(shape, np.float32)
    if kind == "one_corner":
        s = np.zeros(shape, np.float32)
        s[rng.integers(0, H), rng.integers(0, W)] = 25.0
        return s
    if kind == "ties":
        return np.where(rng.uniform(size=shape) < 0.3, rng.integers(1, 4, shape), 0).astype(
            np.float32)
    if kind == "dense":   # every cell holds m positive candidates
        return rng.integers(1, 200, shape).astype(np.float32)
    return n(torb.detect_level(t(_smooth(seed, shape))))   # "detected"


def _check_select(s, k):
    rows, cols, sel = select_emulated(s, k)
    rp, cp, sp = (n(x) for x in korb.select_topk_grid(t(s), k))
    rj, cj, sj = (np.asarray(x) for x in jorb.select_topk_grid(jnp.asarray(s), k))
    for got, plain, ref in ((rows, rp, rj), (cols, cp, cj), (sel, sp, sj)):
        np.testing.assert_array_equal(got, plain)
        np.testing.assert_array_equal(got, ref)
    return rows, sel


@pytest.mark.parametrize("kind", ["detected", "flat", "one_corner", "ties"])
@pytest.mark.parametrize("shape,k", [((376, 1241), 434), ((105, 346), 122), ((64, 64), 434),
                                     ((203, 101), 150)])
def test_select_emulation_matches_plain_and_jax(kind, shape, k):
    """The two launches' order on one plane: the plain version's and the
    reference's rows, columns and scores, bit for bit."""
    _, sel = _check_select(_scores(kind, shape), k)
    if kind == "flat":
        assert not sel.any()
    if kind == "one_corner":
        assert int((sel > 0).sum()) == 1


@pytest.mark.parametrize("kind", ["detected", "dense", "ties"])
def test_select_emulation_takes_more_than_4096_candidates(kind):
    """A 1280x720 level 0 (3,600 cells of 2 candidates: 7,200 keys) at the
    default 2,000 features: the first 434 as the plain version and the
    reference take them."""
    shape, k = (720, 1280), torb.features_per_level(2000, 8, 1.2)[0]
    s = _scores(kind, shape, seed=3)
    keys = cell_pass(s, k)[0]
    assert keys.size == 7200
    if kind == "dense":
        assert int((keys != NO_KEY).sum()) == 7200
    rows, sel = _check_select(s, k)
    assert int((sel > 0).sum()) == k


def test_select_emulation_every_plane_of_a_pair():
    """Every plane of a two-image 1280x720 stack against ``select_grid_plain``
    (the layout the kernel fills: level after level, image after image)."""
    H, W, n_levels = 720, 1280, 8
    per = torb.features_per_level(2000, n_levels, 1.2)
    shapes = [torb.level_shape(H, W, 1.2, lvl) for lvl in range(n_levels)] * 2
    planes = [_scores("detected" if p % 3 else "ties", hw, seed=p) for p, hw in
              enumerate(shapes)]
    stack = np.full((2 * n_levels, H, W), np.nan, np.float32)
    for p, s in enumerate(planes):
        stack[p, :s.shape[0], :s.shape[1]] = s
    rows, cols, sel, level, scale = (n(x) for x in korb.select_grid_plain(
        t(stack), shapes, per, 1.2))
    off = np.cumsum([0] + per)
    for p, s in enumerate(planes):
        b, lvl = divmod(p, n_levels)
        part = slice(off[lvl], off[lvl + 1])
        r, c, v = select_emulated(s, per[lvl])
        np.testing.assert_array_equal(rows[b, part], r)
        np.testing.assert_array_equal(cols[b, part], c)
        np.testing.assert_array_equal(sel[b, part], v)


# ---------------------------------------------------------------------------
# orb_level_planes
# ---------------------------------------------------------------------------

def _reflect101(i, size):
    i = np.asarray(i)
    return np.where(i < 0, -i, np.where(i >= size, 2 * (size - 1) - i, i))


def _level_shapes(H, W):
    return [(H, W) if lvl == 0 else korb.level_shape(H, W, 1.2, lvl) for lvl in range(8)]


@pytest.mark.parametrize("shape", SIZES)
def test_level_tiles_write_each_padded_pixel_once(shape):
    """Every pixel of every level's padded region is written by exactly one
    tile, from a level pixel (the edge clamp) inside that tile; every
    resized tile's columns read at most ``MAX_SPAN`` image columns and its
    halo's reflected columns lie among them; the wrapper's table has a
    block for each tile."""
    H, W = shape
    pad = korb.PAD
    for lvl, (Hl, Wl) in enumerate(_level_shapes(H, W)):
        hits = np.zeros((Hl + 2 * pad, Wl + 2 * pad), np.int32)
        if lvl:
            fc, wc = korb.resize_taps(W, Wl)
            assert wc.shape[1] <= korb.MAX_TAPS
        for (sy0, sy1, sx0, sx1), (ry0, ry1, rx0, rx1) in korb.level_tiles(Hl, Wl, pad):
            assert sy1 - sy0 <= korb.TILE_H and sx1 - sx0 <= korb.TILE_W
            hits[ry0:ry1, rx0:rx1] += 1
            ly = np.clip(np.arange(ry0, ry1) - pad, 0, Hl - 1)
            lx = np.clip(np.arange(rx0, rx1) - pad, 0, Wl - 1)
            assert ly.min() >= sy0 and ly.max() < sy1 and lx.min() >= sx0 and lx.max() < sx1
            if lvl:
                span = korb.tile_span(fc, wc.shape[1], Wl, sx0, sx1)
                assert span <= korb.MAX_SPAN, (lvl, sx0, span)
                halo = _reflect101(np.arange(sx0 - korb.HALO, sx1 + korb.HALO), Wl)
                lxa, lxb = max(0, sx0 - korb.HALO), min(Wl - 1, sx1 - 1 + korb.HALO)
                assert halo.min() >= lxa and halo.max() <= lxb
        assert (hits == 1).all(), (lvl, int(hits.min()), int(hits.max()))
    table = korb._level_table(2, H, W, 8, 1.2, torch.device("cpu"))
    rows = np.array(list(table.rows)).reshape(-1, 13)
    n_tiles = [len(korb.level_tiles(h, w, pad)) for h, w in rows[:, 1:3]]
    np.testing.assert_array_equal(rows[:, 11], np.cumsum([0] + n_tiles[:-1]))
    np.testing.assert_array_equal(rows[:, 12], -(-rows[:, 2] // korb.TILE_W))
    plane = rows[:, 10] // ((H + 2 * pad) * (W + 2 * pad))   # each plane once, its shape
    assert sorted(plane) == list(range(16))
    assert [tuple(r) for r in rows[np.argsort(plane), 1:3]] == list(table.shapes)


def _tile_pipeline(img, Hl, Wl, tile, taps, g):
    """One tile as the kernel computes it, float32 throughout: (L, B), the
    level pixels over the tile and its reflected halo, and the blur of the
    tile."""
    (sy0, sy1, sx0, sx1) = tile
    f32 = np.float32
    rr = _reflect101(np.arange(sy0 - korb.HALO, sy1 + korb.HALO), Hl)
    cc = _reflect101(np.arange(sx0 - korb.HALO, sx1 + korb.HALO), Wl)
    if taps is None:
        L = img[rr][:, cc]
    else:
        (fr, wr), (fc, wc) = taps
        lxa, lxb = max(0, sx0 - korb.HALO), min(Wl - 1, sx1 - 1 + korb.HALO)
        c0, nc = fc[lxa], fc[lxb] + wc.shape[1] - fc[lxa]
        tmp = wr[rr, 0:1] * img[fr[rr]][:, c0:c0 + nc]           # the warps' row buffers
        for k in range(1, wr.shape[1]):
            tmp = tmp + wr[rr, k:k + 1] * img[fr[rr] + k][:, c0:c0 + nc]
        j0 = fc[cc] - c0
        L = wc[cc, 0][None] * tmp[:, j0]
        for k in range(1, wc.shape[1]):
            L = L + wc[cc, k][None] * tmp[:, j0 + k]
    nsy, nsx = sy1 - sy0, sx1 - sx0
    V = L[0:nsy] * f32(g[0])
    for k in range(1, 7):
        V = V + L[k:k + nsy] * f32(g[k])
    B = V[:, 0:nsx] * f32(g[0])
    for k in range(1, 7):
        B = B + V[:, k:k + nsx] * f32(g[k])
    return L.astype(f32), B.astype(f32)


@pytest.mark.parametrize("shape", [(101, 203), (203, 101), (64, 64), (150, 300)])
def test_level_tile_pipeline_matches_plain(shape):
    """Two images through the emulated tiles, bit-equal to
    ``level_planes_plain`` over every plane's padded region."""
    H, W = shape
    imgs = np.stack([_smooth(7, shape), _smooth(8, shape)])
    st_p, bl_p, shapes = (n(x) if i < 2 else x
                          for i, x in enumerate(korb.level_planes_plain(t(imgs), 8, 1.2)))
    pad = korb.PAD
    for b in range(2):
        for lvl, (Hl, Wl) in enumerate(shapes[:8]):
            taps = None if lvl == 0 else (korb.resize_taps(H, Hl), korb.resize_taps(W, Wl))
            st = np.full((Hl + 2 * pad, Wl + 2 * pad), np.nan, np.float32)
            bl = st.copy()
            for tile, (ry0, ry1, rx0, rx1) in korb.level_tiles(Hl, Wl, pad):
                sy0, sy1, sx0, sx1 = tile
                L, B = _tile_pipeline(imgs[b], Hl, Wl, tile, taps, korb.GK7)
                ly = np.clip(np.arange(ry0, ry1) - pad, sy0, sy1 - 1) - sy0
                lx = np.clip(np.arange(rx0, rx1) - pad, sx0, sx1 - 1) - sx0
                st[ry0:ry1, rx0:rx1] = L[ly + korb.HALO][:, lx + korb.HALO]
                bl[ry0:ry1, rx0:rx1] = B[ly][:, lx]
            p = b * 8 + lvl
            region = np.s_[:Hl + 2 * pad, :Wl + 2 * pad]
            np.testing.assert_array_equal(st, st_p[p][region])
            np.testing.assert_array_equal(bl, bl_p[p][region])
