"""The orders of the BALM pass's two kernels, emulated in numpy on the CPU.

The kernels cannot run here; what they do differently from their plain
versions is the order of their work. So:

- ``csrc/clusters.cu``'s stable sort over a thread-block cluster: counting
  passes in which global warp g (block, then warp) owns the items
  [g S, (g + 1) S), S a multiple of 32, counts their digits, the counts
  are scanned per digit over the warps of a block and over the blocks in
  rank order, and each item goes to its digit's base plus its rank among
  the same digit before it in its warp; LSD passes of at most 10 bits over
  the keys with the key 2^bits for an item not kept (an invalid point; a
  point of no splittable root): the root key's rank in the box of the
  window's occupied cells, the children's root voxel id and octant
  (ceil(log2(8 V)) bits), each with that one more bit. Its
  permutation must be ``np.argsort(kind="stable")``'s, exactly, on the root
  keys and on the plain version's child keys of ``chip_smoke.cluster_case``'s
  windows, for 16 and 8 blocks, with ``BIG_KEY`` padding and empty blocks;
- ``csrc/balm.cu``'s sum of (H, g, cost) over the voxels: each voxel's
  terms by the kernel's chain (``test_torch_local_ba.balm_terms_f32``),
  weighted and added in float32 as the kernel adds them (each chunk of
  ``balm.CHUNK`` slots in slot order, then ``balm.GROUPS`` runs of chunks,
  each in order, then the runs in order), against the
  JAX package's ``quadratic`` on ``chip_smoke.balm_case``'s four cases:
  H and g to 1e-4 of their largest entry, the cost to 1e-5 relative (the
  float32 chain agrees with ``jax.hessian`` to ~1e-5; the order of 256
  float32 additions moves the sums by a few ulps).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from test_torch_local_ba import balm_terms_f32
from tc2li_slam_tpu.solver import balm as jbalm
from tc2li_slam_torch.ops.kernels import balm as kbalm
from tc2li_slam_torch.solver import balm as tbalm
from torch_parity import t

F32 = np.float32
BIG_KEY = int(tbalm.BIG_KEY)
WARPS = 32            # csrc/clusters.cu kWarps
DIGIT_BITS = 10       # ... kDigitBits
ROOT_BITS = 27        # ... kRootBits
KW = dict(voxel_size=1.0, max_voxels=512, min_points=15)
H_REL, COST_REL = 1e-4, 1e-5


# ---------------------------------------------------------------------------
# csrc/clusters.cu: the stable sort over the cluster
# ---------------------------------------------------------------------------

def counting_pass(keys, vals, digits, D, n_blocks):
    """One counting pass: (keys, vals) placed by digit, the kernel's order."""
    n = len(keys)
    G = n_blocks * WARPS
    S = 32 * -(-n // (32 * G))
    g = np.arange(n) // max(S, 1)                     # the item's global warp
    counts = np.zeros((G, D), np.int64)
    np.add.at(counts, (g, digits), 1)
    blk = counts.reshape(n_blocks, WARPS, D)
    warp_before = np.cumsum(blk, axis=1) - blk         # this block's earlier warps
    btot = blk.sum(1)
    block_before = np.cumsum(btot, axis=0) - btot      # earlier blocks (distributed smem)
    tot = btot.sum(0)
    base = (np.cumsum(tot) - tot)[None, None] + block_before[:, None] + warp_before
    base = base.reshape(G, D)
    # the rank among the same digit earlier in the warp's items
    order = np.lexsort((np.arange(n), digits, g))
    gd = g[order] * D + digits[order]
    first = np.r_[True, gd[1:] != gd[:-1]]
    start = np.maximum.accumulate(np.where(first, np.arange(n), 0))
    rank = np.empty(n, np.int64)
    rank[order] = np.arange(n) - start
    pos = base[g, digits] + rank
    assert np.array_equal(np.sort(pos), np.arange(n))
    out_k, out_v = np.empty_like(keys), np.empty_like(vals)
    out_k[pos], out_v[pos] = keys, vals
    return out_k, out_v, int(tot[0])


def sort_keys(keys, vals, keep, bits, n_blocks):
    """LSD passes of at most 10 bits over bits + 1 bits, the items not kept
    with the key 2^bits: (sorted keys, original indices) of the kept ones,
    their count."""
    k = np.where(keep, keys, 1 << bits)
    v = vals
    passes = -(-(bits + 1) // DIGIT_BITS)
    per = -(-(bits + 1) // passes)
    for shift in range(0, bits + 1, per):
        D = 1 << min(per, bits + 1 - shift)
        k, v, _ = counting_pass(k, v, (k >> shift) & (D - 1), D, n_blocks)
    kept = int(np.sum(k >> shift < (1 << bits) >> shift))   # the last digit below the cut
    return k[:kept], v[:kept], kept


def _plain_keys(pl, valid, T_wl):
    """The plain version's root keys, splittable roots and child keys (the
    port's ``build_clusters_plain`` on CPU tensors), as numpy."""
    pts, val, wsum, wcount = tbalm.world_points(t(pl), t(valid), t(T_wl))
    W, M, _ = pl.shape
    center = wsum / torch.clamp(wcount, min=1)
    rel_f = (pts - center) / KW["voxel_size"]
    rel = torch.floor(rel_f).to(torch.int32) + 256
    in_grid = torch.all((rel >= 0) & (rel < 512), dim=-1) & val
    key_root = torch.where(in_grid, (rel[:, 0] << 18) | (rel[:, 1] << 9) | rel[:, 2],
                           tbalm.BIG_KEY)
    kf = torch.arange(W, dtype=torch.int32).repeat_interleave(M)
    V = KW["max_voxels"]
    N, mean, Pc, centers, slot = tbalm._cluster_pass(key_root, t(pl).reshape(-1, 3), pts, kf,
                                                     W, V)
    planar, n_tot = tbalm._plane_test(N, mean, Pc, centers, t(T_wl), KW["min_points"],
                                      1.0 / 36.0)
    split = (~planar) & (n_tot >= KW["min_points"])
    frac = rel_f - torch.floor(rel_f)
    octant = ((frac[:, 0] >= 0.5).to(torch.int32) | ((frac[:, 1] >= 0.5).to(torch.int32) << 1)
              | ((frac[:, 2] >= 0.5).to(torch.int32) << 2))
    pt_split = (slot < V) & split[torch.clamp(slot, 0, V - 1)]
    key_child = torch.where(pt_split & (key_root != tbalm.BIG_KEY), key_root * 8 + octant,
                            tbalm.BIG_KEY)
    return (key_root.numpy().astype(np.int64), split.numpy(), octant.numpy().astype(np.int64),
            key_child.numpy().astype(np.int64))


@pytest.mark.parametrize("n_blocks", [16, 8])
@pytest.mark.parametrize("case,W,M", [("full_width", 6, 2048), ("overflow", 6, 2048),
                                      ("no_valid_point", 6, 512), ("no_kf_pads", 6, 2048),
                                      ("full_width", 2, 40)])
def test_cluster_sorts_are_the_stable_sorts(case, W, M, n_blocks):
    """The root sort and the child sort (by root voxel id and octant, from
    the root-sorted order) give ``argsort(kind="stable")``'s permutation of
    the plain version's keys."""
    pl, valid, T_wl = chip_smoke.cluster_case(np.random.default_rng(3), case, W, M)
    key_root, split, octant, key_child = _plain_keys(pl, valid, T_wl)
    P, V = key_root.size, KW["max_voxels"]
    idx = np.arange(P, dtype=np.int64)
    # the root key's rank in the box of the occupied cells, in as many bits
    # as the box has cells
    keep = key_root != BIG_KEY
    f = np.stack([key_root >> 18, key_root >> 9 & 511, key_root & 511], 1)
    lo, hi = (f[keep].min(0), f[keep].max(0)) if keep.any() else (np.zeros(3, int),) * 2
    n = hi - lo + 1
    compact = ((f[:, 0] - lo[0]) * n[1] + (f[:, 1] - lo[1])) * n[2] + (f[:, 2] - lo[2])
    bits = int(np.prod(n) - 1).bit_length()
    k, v, n_valid = sort_keys(np.where(keep, compact, 0), idx, keep, bits, n_blocks)
    ref = np.argsort(key_root, kind="stable")
    assert n_valid == int((key_root != BIG_KEY).sum())
    np.testing.assert_array_equal(v, ref[:n_valid])
    np.testing.assert_array_equal(k, compact[ref[:n_valid]])
    if case == "full_width" and M > 1000:
        assert bits + 1 <= 2 * DIGIT_BITS   # the box takes two passes, not three
    # voxel ids: the rank of the root key, the dump slot V past the slots
    head = np.r_[True, k[1:] != k[:-1]] if n_valid else np.zeros(0, bool)
    vox = np.minimum(np.cumsum(head) - 1, V)
    keep = (vox < V) & split[np.minimum(vox, V - 1)]
    ck = np.where(keep, vox * 8 + octant[v], BIG_KEY)
    bits = int(8 * V - 1).bit_length()
    _, cv, n_split = sort_keys(ck, v, keep, bits, n_blocks)
    ref_c = np.argsort(key_child, kind="stable")
    assert n_split == int((key_child != BIG_KEY).sum())
    np.testing.assert_array_equal(cv, ref_c[:n_split])
    if case == "full_width" and M > 1000:
        assert n_split > 1000 and n_valid > 10000   # both sorts do real work


@pytest.mark.parametrize("n,n_blocks", [(0, 16), (1, 16), (31, 8), (33, 16), (16385, 16),
                                        (40000, 8)])
def test_counting_passes_with_padding_and_empty_blocks(n, n_blocks):
    """Random 27-bit keys with ``BIG_KEY`` padding: no item, one, fewer than
    a warp (every other warp and block empty), past one item a thread of
    the cluster, several chunks a warp."""
    rng = np.random.default_rng(n)
    keys = rng.integers(0, 1 << ROOT_BITS, n)
    keys[rng.random(n) < 0.3] = BIG_KEY
    keys[: n // 3] = keys[n // 2: n // 2 + n // 3]          # repeated keys
    _, v, kept = sort_keys(keys, np.arange(n), keys != BIG_KEY, ROOT_BITS, n_blocks)
    ref = np.argsort(keys, kind="stable")
    assert kept == int((keys != BIG_KEY).sum())
    np.testing.assert_array_equal(v, ref[:kept])


# ---------------------------------------------------------------------------
# csrc/balm.cu: the sum over the voxels in slices
# ---------------------------------------------------------------------------

def sum_in_chunks(terms, wv, valid, chunk, groups):
    """sum_v wv_v terms_v in float32 as ``csrc/balm.cu`` adds it: each chunk
    of ``chunk`` slots over its valid voxels in slot order, each run of G =
    ceil(chunks / groups) chunks over those that hold a valid voxel, in
    order, then the runs in order."""
    V = terms.shape[0]
    chunks = -(-V // chunk)
    G = -(-chunks // groups)
    total = np.zeros(terms.shape[1:], F32)
    for w in range(groups):
        run = np.zeros(terms.shape[1:], F32)
        for c in range(w * G, min(chunks, (w + 1) * G)):
            slots = [v for v in range(c * chunk, min(V, (c + 1) * chunk)) if valid[v]]
            if not slots:
                continue
            part = np.zeros(terms.shape[1:], F32)
            for v in slots:
                part = (part + (wv[v] * terms[v]).astype(F32)).astype(F32)
            run = (run + part).astype(F32)
        total = (total + run).astype(F32)
    return total


@pytest.mark.parametrize("case", chip_smoke.BALM_CASES)
def test_quadratic_sum_order_matches_jax(case):
    b = chip_smoke.balm_case(np.random.default_rng(0), case)
    cj = jbalm.build_clusters(jnp.asarray(b["points"]), jnp.asarray(b["valid"]),
                              jnp.asarray(b["T_build"]), voxel_size=1.0, max_voxels=256,
                              min_points=15)
    cj = cj._replace(valid=cj.valid & ~jnp.asarray(b["kill"]))
    qj = jbalm.quadratic(cj, jnp.asarray(b["T_eval"]))
    valid = np.asarray(cj.valid)
    H_v, g_v, lam, wv = balm_terms_f32(*(np.asarray(a) for a in cj), b["T_eval"])
    H = sum_in_chunks(H_v, wv, valid, kbalm.CHUNK, kbalm.GROUPS)
    g = sum_in_chunks(g_v, wv, valid, kbalm.CHUNK, kbalm.GROUPS)
    cost = sum_in_chunks(lam, wv, valid, kbalm.CHUNK, kbalm.GROUPS)
    if case == "all_invalid":
        assert not H.any() and not g.any() and float(cost) == 0.0
        return
    assert int(valid.sum()) > 20
    for got, ref in ((H, qj.H), (g, qj.g)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got, ref, rtol=0, atol=H_REL * np.abs(ref).max())
    np.testing.assert_allclose(float(cost), float(qj.cost), rtol=COST_REL)
