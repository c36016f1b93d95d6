"""The window mode of ``csrc/match.cu`` (``window_grid_kernel``) emulated in
torch on the CPU, where the kernel cannot run, and held bit for bit against
the matcher's plain version (``match_best2_plain``) and, through the
matcher's tests, against the JAX ``search_by_projection``.

The emulation repeats the kernel's steps in float32: the columns a window
can admit (valid, u and v finite) in their cells' lists, floor(x / 16 px)
wrapped to the 128 x 32 grid (a list's order is the order of the kernel's
atomics: here descending column index); a row's cell range (the bounds
x -+ r widened by 2^-20 (|x| + r), which adds a cell where rounding could
move a bound across a cell's edge, wrapped; all cells once the range spans
the grid; a row whose position is not finite or whose radius is not
positive visits nothing); and the walk: 8 lanes a row, a lane every 8th
cell of the range (grid row by grid row) and each cell's list, each lane's two
smallest keys (distance << 16 | column), the lanes merged as by the
kernel's shuffles.

Each case checks that every pair the plain mask admits is visited, that the
walk's (idx, best, second) and, with the mutual test, the columns' first
best rows equal the plain version's, and that the match the walk gives
after the distance and ratio tests equals the JAX package's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from tc2li_slam_tpu.ops import matching as jm
from tc2li_slam_torch.ops import matching as tm
from tc2li_slam_torch.ops.kernels import match as tmatch
from tc2li_slam_torch.ops.kernels.hamming import hamming_matrix_plain
from torch_parity import n, t

GX, GY = 128, 32         # csrc/match.cu kGX, kGY
SCALE = 0.0625           # kCellScale: 16-px cells
ROW_LANES = 8            # kRowLanes
NO_KEY = 2 ** 31 - 1     # kNoKey
F32 = torch.float32


def cell_f(x):
    """floor(x / 16) in float32."""
    return torch.floor(x * torch.tensor(SCALE, dtype=F32))


def wrap(f, n_cells):
    """An integer-valued float32 cell index wrapped to [0, n_cells)."""
    n_f = torch.tensor(float(n_cells), dtype=F32)
    return (f - torch.floor(f / n_f) * n_f).to(torch.int64)


def grid_of(uv2, valid2):
    """Each column's cell (-1 off the grid) and each cell's list."""
    u, v = uv2[:, 0], uv2[:, 1]
    on = valid2 & torch.isfinite(u) & torch.isfinite(v)
    cell = torch.where(on, wrap(cell_f(torch.where(on, v, 0.0)), GY) * GX
                       + wrap(cell_f(torch.where(on, u, 0.0)), GX), -1)
    lists = [[] for _ in range(GX * GY)]
    for m in torch.arange(uv2.shape[0])[on].tolist():
        lists[int(cell[m])].insert(0, m)
    return cell, lists


def axis_range(p, r, n_cells):
    """(first cell wrapped, number of cells) of each row along one axis."""
    m = (torch.abs(p) + r) * torch.tensor(2.0 ** -20, dtype=F32)
    f0, f1 = cell_f((p - r) - m), cell_f((p + r) + m)
    all_ = ~(f1 - f0 < n_cells - 1)
    c0 = torch.where(all_, 0, wrap(torch.where(all_, 0.0, f0), n_cells))
    nc = torch.where(all_, n_cells, (torch.where(all_, 0.0, f1 - f0)).to(torch.int64) + 1)
    return c0, nc


def row_ranges(uv1, radius, valid1):
    """[N, 4] (cx0, ncx, cy0, ncy) of each row, and whether it visits any."""
    x, y, r = uv1[:, 0], uv1[:, 1], radius
    visits = valid1 & torch.isfinite(x) & torch.isfinite(y) & (r > 0)
    safe = lambda a: torch.where(visits, a, 1.0)
    cx0, ncx = axis_range(safe(x), safe(r), GX)
    cy0, ncy = axis_range(safe(y), safe(r), GY)
    return torch.stack([cx0, ncx, cy0, ncy], -1), visits


def pair_test(mask, i, m):
    """The kernel's comparisons for row i and column m."""
    dl = int(mask.lvl2[m]) - int(mask.lvl1[i])
    r = mask.radius[i]
    return bool((torch.abs(mask.uv1[i, 0] - mask.uv2[m, 0]) < r)
                & (torch.abs(mask.uv1[i, 1] - mask.uv2[m, 1]) < r)) \
        and mask.lo <= dl <= mask.hi


def keep_two(k1, k2, k):
    return min(k1, k), min(k2, max(k1, k))


def emu_window(d1, d2, valid1, valid2, mask, mutual=False, walk_rows=None):
    """The kernel's outputs: (idx, best, second, back or None), and the
    visited [N, M] pairs. Rows in ``walk_rows`` (default: all) take the
    literal walk; the others the same cells and tests as one [N, M] step."""
    N, M = d1.shape[0], d2.shape[0]
    cell, lists = grid_of(mask.uv2, valid2)
    rng_, visits = row_ranges(mask.uv1, mask.radius, valid1)
    cx, cy = cell % GX, cell // GX
    inside = lambda c, c0, nc, n_cells: torch.remainder(c[None, :] - c0[:, None], n_cells) < nc[:, None]
    visited = (visits[:, None] & (cell[None, :] >= 0)
               & inside(cx, rng_[:, 0], rng_[:, 1], GX) & inside(cy, rng_[:, 2], rng_[:, 3], GY))
    dist = hamming_matrix_plain(d1, d2).to(torch.int64)
    tested = visited & mask.dense()
    keys = torch.where(tested, (dist << 16) | torch.arange(M)[None, :], NO_KEY)
    k1 = keys.min(1).values
    k2 = torch.where(keys == k1[:, None], NO_KEY, keys).min(1).values
    walk_rows = range(N) if walk_rows is None else walk_rows
    colbest = torch.full((M,), tmatch.BIG << 32, dtype=torch.int64)
    if mutual:
        rows = torch.arange(N)[:, None].expand(N, M)
        both = torch.where(tested, (dist << 32) | rows, tmatch.BIG << 32)
        colbest = both.min(0).values
    for i in walk_rows:
        if not bool(visits[i]):
            assert int(k1[i]) == NO_KEY
            continue
        cx0, ncx, cy0, ncy = (int(c) for c in rng_[i])
        lanes = [(NO_KEY, NO_KEY)] * ROW_LANES

        def test(sub, m):
            if pair_test(mask, i, m):
                lanes[sub] = keep_two(*lanes[sub], (int(dist[i, m]) << 16) | m)

        for sub in range(ROW_LANES):
            for cell_t in range(sub, ncx * ncy, ROW_LANES):
                y, x = divmod(cell_t, ncx)
                for m in lists[((cy0 + y) % GY) * GX + (cx0 + x) % GX]:
                    test(sub, m)
        for off in (1, 2, 4):   # the shuffles: lane l takes lane l ^ off's pair
            lanes = [(min(a1, b1), min(min(a2, b2), max(a1, b1)))
                     for (a1, a2), (b1, b2) in zip(lanes, [lanes[s ^ off]
                                                           for s in range(ROW_LANES)])]
        assert lanes[0] == (int(k1[i]), int(k2[i]))
    none1, none2 = k1 == NO_KEY, k2 == NO_KEY
    idx = torch.where(none1, 0, k1 & 0xFFFF)
    best = torch.where(none1, tmatch.BIG, k1 >> 16).to(torch.int32)
    second = torch.where(none2, tmatch.BIG, k2 >> 16).to(torch.int32)
    back = (colbest & 0xFFFFFFFF) if mutual else None
    return (idx, best, second, back), visited


def _check(c, lo=-1, hi=1, mutual=False, walk_rows=None, jax_check=True):
    ta = {k: t(v) for k, v in c.items()}
    mask = tmatch.WindowMask(ta["uv1"], ta["radius"], ta["lvl1"], ta["uv2"], ta["lvl2"], lo, hi)
    args = (ta["d1"], ta["d2"], ta["valid1"], ta["valid2"], mask, mutual)
    got, visited = emu_window(*args, walk_rows=walk_rows)
    full = ta["valid1"][:, None] & ta["valid2"][None, :] & mask.dense()
    assert not bool((full & ~visited).any()), "an admitted pair lies in an unvisited cell"
    ref = tmatch.match_best2_plain(*args)
    for g, r in zip(got, ref):
        assert (g is None) == (r is None)
        if g is not None:
            assert g.dtype == r.dtype and torch.equal(g, r)
    if jax_check and (lo, hi) == (-1, 1) and not mutual:
        for max_dist, ratio in ((tm.TH_HIGH, 0.9), (tm.TH_LOW, 1.0)):
            idx, best, second, _ = got
            ok = (best <= max_dist) & ta["valid1"]
            if ratio < 1.0:
                ok = ok & (best.to(F32) <= ratio * second.to(F32))
            rj = jm.search_by_projection(*map(jnp.asarray, (
                c["uv1"], c["lvl1"], c["d1"], c["valid1"], c["uv2"], c["lvl2"], c["d2"],
                c["valid2"], c["radius"])), max_dist=max_dist, ratio=ratio)
            for a, b in zip((idx, best, ok), rj):
                np.testing.assert_array_equal(n(a), np.asarray(b))
    return got, visited


@pytest.mark.parametrize("case", chip_smoke.WINDOW_CASES)
@pytest.mark.parametrize("mutual", [False, True])
def test_grid_walk_edge_cases(case, mutual):
    """``chip_smoke.window_case``'s edge cases at 300 x 517."""
    rng = np.random.default_rng(chip_smoke.WINDOW_CASES.index(case))
    c = chip_smoke.window_case(rng, 300, 517, case)
    (idx, best, second, _), visited = _check(c, mutual=mutual)
    if case == "tie across cells":
        ta = {k: t(v) for k, v in c.items()}
        cell, _ = grid_of(ta["uv2"], ta["valid2"])
        assert int(cell[3]) > int(cell[7])     # the walk reaches column 7's cell first
        assert all(int(idx[i]) == 3 and int(best[i]) == 0 and int(second[i]) == 0 for i in range(5))
    if case == "non-finite":
        # NaN, non-finite positions and radii <= 0 visit nothing; an
        # infinite radius at a finite position, and a huge one, every column
        assert not bool(visited[[0, 1, 2, 3, 4, 6, 7, 8]].any())
        on = torch.as_tensor(c["valid2"]) & torch.isfinite(t(c["uv2"])).all(-1)
        for i in (5, 9, 10, 11):
            assert bool((visited[i] == on).all())


@pytest.mark.parametrize("lo,hi", [(-1, 1), (0, 3), (0, 0), (-8, 8)])
def test_grid_walk_level_gate(lo, hi):
    rng = np.random.default_rng(10 + hi)
    _check(chip_smoke.window_case(rng, 250, 333), lo, hi)


@pytest.mark.parametrize("N,M,base", [(1003, 517, 15.0), (33, 2001, 15.0), (1, 1, 15.0),
                                      (97, 65, 3.0), (200, 2000, 3.0), (64, 31, 100.0)])
def test_grid_walk_sizes(N, M, base):
    """M and N no multiple of the cell, warp or row-group sizes; the fuse
    pass's narrow windows (3 px x 1.2^level) and wide ones."""
    rng = np.random.default_rng(N + M)
    _check(chip_smoke.window_case(rng, N, M, base=base), walk_rows=range(min(N, 400)))


def test_grid_walk_full_pool():
    """A full pool: 32,768 valid rows against a keyframe; the literal walk
    on a sample of rows, every row through the same cells and tests."""
    rng = np.random.default_rng(7)
    c = chip_smoke.window_case(rng, 32768, 300)
    c["valid1"][:] = True
    (_, best, _, _), visited = _check(c, walk_rows=range(0, 32768, 97), jax_check=False)
    # the grid's point: a row tests a few percent of the columns
    assert float(visited.sum()) / (32768 * 300) < 0.1
    assert int((best < tmatch.BIG).sum()) > 15000


def test_cell_index_is_exact_and_monotone():
    """floor(x / 16) in float32 orders any two floats as they are ordered and
    equals the exact floor but for subnormals (x / 16 rounds there); the
    wrap equals the exact remainder, for coordinates of a few pixels to
    ~1e38."""
    rng = np.random.default_rng(3)
    xs = np.sort(np.concatenate([rng.uniform(-1e3, 1e3, 2000), rng.normal(0, 1e30, 50),
                                 rng.normal(0, 1e8, 50), [0.0, -0.0, 1e-45, -1e-45, 3e38,
                                                          -3e38]]).astype(np.float32))
    f = cell_f(torch.as_tensor(xs))
    assert bool((f[1:] >= f[:-1]).all())
    normal = np.abs(xs) >= np.finfo(np.float32).tiny * 16
    assert np.array_equal(n(f)[normal], np.floor(xs[normal].astype(np.float64) / 16))
    for n_cells in (GX, GY):
        w = wrap(f, n_cells)
        assert bool(((w >= 0) & (w < n_cells)).all())
        exact = [int(v) % n_cells for v in n(f).astype(np.float64)]
        assert w.tolist() == exact
