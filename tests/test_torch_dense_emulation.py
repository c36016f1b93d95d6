"""``csrc/match.cu``'s dense mode (``match_best2_dense_kernel``) repeated in
numpy, and the unmasked match it serves against the JAX package.

The kernel takes the dense call shapes (no mask, or a bool [N, M]): the
landmark pool against a frame (global tracking), a frame against the pool
(relocalization), a keyframe pair (loop verification). Block b of G takes
rows b, b + G, ... a batch at a time and compacts the valid ones in row
order (their slots); every block packs side 2's valid flags into a bit a
column and scans the bits' counts, so that the r-th valid column is found
by a binary search over the counts and a select in its word; the valid
columns go through shared memory in tiles. A warp takes 4 of the batch's
valid rows and a slice of the tile (S slices a group, S spreading the
block's 16 warps over its groups), a lane every (32 S)th staged column,
keeps each row's two smallest keys (distance << 16 | column), merges its
lanes' pairs by a shuffle tree and inserts them into the rows' keys in
shared memory (an atomicMin on the first, the key it displaces or itself
offered to the second), which holds them across slices and tiles. For the
mutual test each lane takes its column's minimum of (distance << 16 | slot)
over the warp's rows, the block the minimum of those, and each column a
block admitted takes one atomicMin of (distance << 32 | row) in device
memory.

The emulation repeats these steps, with the block count, the tile and the
batch as parameters so that small inputs cross several tiles and batches,
the blocks in a random order and every insert's two atomics interleaved at
random with the others'. On ``chip_smoke.dense_case``'s edge cases it holds
the result bit for bit against ``match_best2_plain``, the CPU route and the
JAX package's ``_masked_best2`` (with its column argmin for the mutual
test) and, after the distance, ratio and mutual tests, ``match_descriptors``.
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

ROWS = 4                 # csrc/match.cu kRows: a warp's rows
WARPS = 16               # kDenseWarps
BATCH = 512              # kDenseBatch: rows a block compacts at once
NO_KEY = 2 ** 31 - 1     # kNoKey
NO_COL = 2 ** 32 - 1     # kNoCol
BIG = match.BIG
# (blocks, tile, batch): one block; a few blocks and tiles; batches of 16
# rows; a block an SM's worth of blocks over a ragged tile
LAYOUTS = [(1, 64, BATCH), (3, 64, BATCH), (7, 40, 16), (125, 33, BATCH)]
DENSE_SEED = {case: 60 + k for k, case in enumerate(chip_smoke.DENSE_CASES)}


def test_constants_are_the_kernels():
    """The emulation's constants are the kernel's; one launch takes every
    column the 16-bit key can name."""
    src = (Path(__file__).resolve().parents[1] / "tc2li_slam_torch" / "csrc" /
           "match.cu").read_text()
    const = lambda name: int(re.search(rf"constexpr int {name} = (\w+);", src).group(1))
    assert const("kRows") == ROWS
    assert const("kDenseThreads") == 32 * WARPS and "kDenseBatch = kDenseThreads" in src
    assert const("kDenseMaxColumns") == match.DENSE_MAX_COLUMNS == 65535
    assert match.max_columns(None) == match.max_columns(torch.zeros(1, 1, dtype=torch.bool)) \
        == 65535
    assert match.chunk_bounds(32768, None) == [(0, 32768)]


def _case(case, tile):
    return chip_smoke.dense_case(np.random.default_rng(DENSE_SEED[case]), case, tile)


def popcount_rows(a, b):
    """Hamming distances of uint32 words a [N, 8] and b [M, 8]: [N, M]."""
    x = a[:, None, :] ^ b[None, :, :]
    return np.unpackbits(x.view(np.uint8), axis=-1).sum(-1).astype(np.int64)


def nonzero_bytes(x):
    """``nonzero_bytes``: bit k of the result is byte k of each uint32 of x
    not 0, by the kernel's multiply (uint32 arithmetic)."""
    x = x.astype(np.uint32)
    ne = np.zeros_like(x)
    for k in range(4):   # __vcmpne4(x, 0): 0xff a byte that is not 0
        ne |= np.where((x >> np.uint32(8 * k)) & np.uint32(0xff), np.uint32(0xff << 8 * k),
                       np.uint32(0))
    with np.errstate(over="ignore"):
        return ((ne & np.uint32(0x01010101)) * np.uint32(0x10204080)) >> np.uint32(28)


def flag_words(valid2):
    """Side 2's flags as the kernel's words of 32 columns: eight 16-byte
    loads a thread, 16 columns each, the ragged tail by bytes."""
    M = valid2.shape[0]
    nw = -(-M // 32)
    raw = np.zeros(32 * nw, np.uint8)
    raw[:M] = valid2.view(np.uint8)
    words = raw.view(np.uint32).reshape(nw, 8)          # 8 little-endian words of 4 flags
    nib = nonzero_bytes(words)                          # 4 bits each
    out = np.zeros(nw, np.uint32)
    for k in range(8):
        out |= nib[:, k].astype(np.uint32) << np.uint32(4 * k)
    return out


def select_bit(b, k):
    """``select_bit``: the position of b's k-th set bit."""
    pos = 0
    for s in (16, 8, 4, 2, 1):
        c = bin(b & ((1 << s) - 1)).count("1")
        if k >= c:
            k -= c
            b >>= s
            pos += s
    return pos


def staged_columns(valid2):
    """The valid columns by rank, found as the kernel finds them: the last
    word whose prefix count is at most the rank, then the rank's bit in it."""
    bits = flag_words(valid2)
    pre = np.concatenate([[0], np.cumsum([bin(int(b)).count("1") for b in bits])])
    out = []
    for rank in range(int(pre[-1])):
        lo, hi = 0, bits.shape[0]
        while hi - lo > 1:
            mid = (lo + hi) // 2
            lo, hi = (mid, hi) if pre[mid] <= rank else (lo, mid)
        out.append(32 * lo + select_bit(int(bits[lo]), rank - int(pre[lo])))
    return np.array(out, np.int64)


def butterfly(k1, k2):
    """The shuffle tree over a warp's 32 lanes (the last axis): every lane
    ends with the warp's two smallest keys."""
    off = 16
    while off:
        o1, o2 = k1[..., np.arange(32) ^ off], k2[..., np.arange(32) ^ off]
        k2 = np.minimum(np.maximum(k1, o1), np.minimum(k2, o2))
        k1 = np.minimum(k1, o1)
        off >>= 1
    return k1[..., 0], k2[..., 0]


def run_inserts(rk1, rk2, inserts, rng):
    """Every ``insert_key`` (slot, key) applied as its two atomics, the
    atomics of all inserts interleaved in a random order."""
    pending = [[p, k, None] for p, k in inserts]   # slot, key, what the first atomic returned
    while pending:
        i = int(rng.integers(len(pending)))
        p, k, old = pending[i]
        if old is None:
            pending[i][2] = int(rk1[p])
            rk1[p] = min(rk1[p], k)
        else:
            rk2[p] = min(rk2[p], max(old, k))
            pending.pop(i)


def emulate(c, mutual, blocks, tile, batch, rng):
    """The kernel's (idx, best, second, back) for a ``dense_case``."""
    d1, d2, v1, v2, mask = c["d1"], c["d2"], c["valid1"], c["valid2"], c["mask"]
    N, M = d1.shape[0], d2.shape[0]
    dist = popcount_rows(d1, d2)
    idx = np.zeros(N, np.int64)
    best = np.full(N, BIG, np.int32)
    second = np.full(N, BIG, np.int32)
    colbest = np.full(M, np.int64(BIG) << 32, np.int64)
    staged = staged_columns(v2)
    V = staged.shape[0]
    for b in rng.permutation(blocks):
        for j0 in range(0, N, batch):
            rows = b + blocks * (j0 + np.arange(batch))
            rows = rows[rows < N]
            if rows.size == 0:
                break
            slots = rows[v1[rows]]                 # the batch's valid rows, in row order
            R = slots.size
            if R == 0:
                continue
            rk1, rk2 = np.full(R, NO_KEY, np.int64), np.full(R, NO_KEY, np.int64)
            groups = -(-R // ROWS)
            for base in range(0, V, tile):
                C = min(tile, V - base)
                cols = staged[base:base + C]
                S = max(1, min(-(-WARPS // groups), -(-C // 32)))
                tmin = np.full(C, NO_COL, np.int64)
                inserts = []
                for it in range(groups * S):
                    g, s = divmod(it, S)
                    p = np.arange(ROWS * g, min(ROWS * g + ROWS, R))
                    adm = np.ones((p.size, C), bool)
                    if mask is not None:
                        adm = mask[slots[p]][:, cols]
                    dd = dist[slots[p]][:, cols]
                    keys = np.where(adm, (dd << 16) | cols[None, :], NO_KEY)
                    # lane L of the item walks t = 32 s + L + 32 S k
                    k1 = np.full((p.size, 32), NO_KEY, np.int64)
                    k2 = np.full((p.size, 32), NO_KEY, np.int64)
                    for lane in range(32):
                        ts = np.arange(32 * s + lane, C, 32 * S)
                        if ts.size:
                            two = np.sort(keys[:, ts], axis=1)
                            k1[:, lane] = two[:, 0]
                            if ts.size > 1:
                                k2[:, lane] = two[:, 1]
                        if mutual and ts.size:
                            cm = np.where(adm[:, ts], (dd[:, ts] << 16) | p[:, None], NO_COL)
                            tmin[ts] = np.minimum(tmin[ts], cm.min(0))
                    c1, c2 = butterfly(k1, k2)
                    for j in range(p.size):
                        inserts += [(p[j], int(k)) for k in (c1[j], c2[j]) if k != NO_KEY]
                run_inserts(rk1, rk2, inserts, rng)
                if mutual:   # a device atomicMin a column the block admitted
                    hit = tmin != NO_COL
                    packed = ((tmin[hit] >> 16) << 32) | slots[tmin[hit] & 0xFFFF]
                    colbest[cols[hit]] = np.minimum(colbest[cols[hit]], packed)
            none = rk1 == NO_KEY
            idx[slots] = np.where(none, 0, rk1 & 0xFFFF)
            best[slots] = np.where(none, BIG, rk1 >> 16)
            second[slots] = np.where(rk2 == NO_KEY, BIG, rk2 >> 16)
    return idx, best, second, (colbest & 0xFFFFFFFF) if mutual else None


def jax_best2(c, mutual):
    """The JAX package's ``_masked_best2`` on the case, with the column
    argmin of its ``match_descriptors`` for the mutual test."""
    d1, d2 = jnp.asarray(c["d1"]), jnp.asarray(c["d2"])
    full = jnp.asarray(c["valid1"])[:, None] & jnp.asarray(c["valid2"])[None, :]
    if c["mask"] is not None:
        full = full & jnp.asarray(c["mask"])
    dist = jm.hamming_matrix_xor(d1, d2)
    out = [np.asarray(x) for x in jm._masked_best2(dist, full)]
    back = np.asarray(jnp.argmin(jnp.where(full, dist, BIG), axis=0)) if mutual else None
    return (*out, back)


def test_flag_bits_and_ranks():
    """The flags' bits (a byte that is not 0, whatever its value, by the
    kernel's multiply) and the rank search give the valid columns in order,
    at every ragged length around the 16-byte loads and the 32-column words."""
    rng = np.random.default_rng(5)
    x = rng.integers(0, 1 << 32, 4096, dtype=np.uint64).astype(np.uint32)
    x[::3] &= np.uint32(0x00ff00ff)
    want = sum(((x >> np.uint32(8 * k)) & np.uint32(0xff) != 0).astype(np.uint32) << np.uint32(k)
               for k in range(4))
    np.testing.assert_array_equal(nonzero_bytes(x), want)
    for M in (1, 15, 16, 17, 31, 32, 33, 63, 64, 65, 100, 1000):
        v = rng.random(M) > 0.6
        np.testing.assert_array_equal(staged_columns(v), np.nonzero(v)[0])
    assert staged_columns(np.ones(65535, bool)).tolist() == list(range(65535))


@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda x: "g%d-t%d-b%d" % x)
@pytest.mark.parametrize("mutual", [False, True])
@pytest.mark.parametrize("case", chip_smoke.DENSE_CASES)
def test_layout_matches_the_plain_chain_and_jax(case, mutual, layout):
    """The kernel's layout, bit for bit against ``match_best2_plain``, the
    CPU route and the JAX ``_masked_best2`` (and its column argmin)."""
    blocks, tile, batch = layout
    c = _case(case, tile)
    args = chip_smoke.dense_args(torch, c, "cpu")
    ref = match.match_best2_plain(*args, mutual)
    route = match.match_best2(*args, mutual)
    got = emulate(c, mutual, blocks, tile, batch, np.random.default_rng(blocks))
    for g, r, q, j in zip(got, ref, route, jax_best2(c, mutual)):
        if r is None:
            assert g is None and q is None and j is None
            continue
        np.testing.assert_array_equal(g, n(r))
        np.testing.assert_array_equal(n(q), n(r))
        np.testing.assert_array_equal(j, n(r))
    idx, best, second, back = (None if x is None else n(x) for x in ref)
    M = c["d2"].shape[0]
    if case == "tie across tiles":     # the first of two equal columns, in the earlier tile
        assert (idx[0], best[0], second[0]) == (tile - 1, 0, 0)
        assert (idx[3], best[3]) == (tile - 1, 0)
        if mutual:
            assert back[tile - 1] == 0 and back[tile] == 0
    if case == "repeated column":      # three equal columns, one in the last tile
        assert (idx[0], best[0], second[0]) == (3, 0, 0)
    if case == "last tile only":
        assert (idx[1], second[1]) == (M - 2, BIG) and best[1] < BIG
    if case in ("no valid column", "no valid row"):
        assert (best == BIG).all() and (idx == 0).all() and (second == BIG).all()
        if mutual:
            assert (back == 0).all()
    if case == "mask":
        assert (best[[2, 4]] == BIG).all()
    if case in ("pool", "mask"):
        assert (best < BIG).sum() > 20


@pytest.mark.parametrize("case", chip_smoke.DENSE_CASES)
def test_match_after_the_tests_against_jax(case):
    """The emulated layout's (idx, best) with the distance, ratio and mutual
    tests (``match_descriptors``' tail) equal the JAX ``match_descriptors``
    and the port's, at the loop verification's and relocalization's
    thresholds."""
    tile = 40
    c = _case(case, tile)
    args = chip_smoke.dense_args(torch, c, "cpu")
    idx, best, second, back = emulate(c, True, 5, tile, BATCH, np.random.default_rng(3))
    for max_dist, ratio in ((50, 0.75), (100, 0.9), (256, 1.0)):
        ok = (best <= max_dist) & c["valid1"]
        if ratio < 1.0:
            ok &= best.astype(np.float32) <= np.float32(ratio) * second.astype(np.float32)
        ok &= back[idx] == np.arange(idx.shape[0])
        mask = None if c["mask"] is None else jnp.asarray(c["mask"])
        ij, bj, okj = (np.asarray(x) for x in jm.match_descriptors(
            *(jnp.asarray(c[k]) for k in ("d1", "d2", "valid1", "valid2")), mask=mask,
            max_dist=max_dist, ratio=ratio, mutual=True))
        it, bt, okt = (n(x) for x in tm.match_descriptors(*args, max_dist=max_dist,
                                                           ratio=ratio, mutual=True))
        for g, j, q in ((idx, ij, it), (best, bj, bt), (ok, okj, okt)):
            np.testing.assert_array_equal(g, j)
            np.testing.assert_array_equal(q, j)
