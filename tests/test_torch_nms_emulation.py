"""``fast_nms_planes`` (``csrc/fast.cu``, pass 2 of the FAST detection):
its plain version against the JAX ``detect_level`` on an image of flat
plateaus, and the kernel's tiling emulated in numpy on the CPU, where the
kernel cannot run, against the plain version.

The emulation repeats the kernel's index arithmetic on the flat stack: the
planes' 120 x 32 tiles in a row of the table; a tile's staged area (rows
y0 - 1 .. y0 + 32 and columns x0 - 1 .. x0 + 120, clipped to the plane),
each staged row from the aligned 4-float chunk that holds its first pixel,
a lane a chunk, whole chunks inside the row's span read as one and partial
end chunks float by float, each staged pixel thresholded by its cell's
flag through the tile's tables of cell columns and rows; then each output
row as aligned chunks of 4 pixels, the centres one 16-byte read of the
staged row, a neighbour at its own row's offset, whole chunks stored as one
and the partial ends float by float. It checks that every read hits a
staged pixel, that every pixel of every plane is written once and nothing
outside the planes, and that the output equals ``nms_planes_plain`` bit
for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from tc2li_slam_tpu.ops import orb as jorb
from tc2li_slam_torch.ops import orb as torb
from tc2li_slam_torch.ops.kernels import fast

NX, NY = 120, 32         # csrc/fast.cu kNX, kNY
ROW = 128                # kNRowFloats
LANES = 32
INI, MIN, CELL = 20.0, 7.0, 35


def emu_nms(gated: np.ndarray, flags: np.ndarray, shapes, ini_th, min_th, cell,
            margin=fast.MARGIN):
    """The kernel's output on a float32 [P, H, W] stack (NaN where it writes
    nothing) and the number of writes a float."""
    P, H, W = gated.shape
    flat = gated.reshape(-1)
    out = np.full(flat.size, np.nan, np.float32)
    writes = np.zeros(flat.size, np.int32)
    lanes = np.arange(LANES)
    ini, mn = np.float32(ini_th), np.float32(min_th)
    cell_off = 0
    for p, (Hl, Wl) in enumerate(shapes):
        base, cells_x = p * H * W, -(-Wl // cell)
        pf = flags[cell_off:cell_off + cells_x * -(-Hl // cell)]
        cell_off += cells_x * -(-Hl // cell)
        for y0 in range(0, Hl, NY):
            for x0 in range(0, Wl, NX):
                ya, yb = max(y0 - 1, 0), min(y0 + NY, Hl - 1)
                xa, xb = max(x0 - 1, 0), min(x0 + NX, Wl - 1)
                cy0, cx0 = ya // cell, xa // cell
                ncx = xb // cell - cx0 + 1
                sflag = np.array([pf[(cy0 + i // ncx) * cells_x + cx0 + i % ncx]
                                  for i in range((yb // cell - cy0 + 1) * ncx)])
                scx = np.clip(xa + np.arange(ROW + 3) - 3, xa, xb) // cell - cx0
                scy = np.clip(y0 - 1 + np.arange(NY + 2), ya, yb) // cell - cy0
                shift = lambda y: (base + y * W + xa) & 3
                srow = np.zeros((NY + 2) * ROW, np.float32)
                staged = np.zeros((NY + 2) * ROW, bool)
                for r in range(NY + 2):
                    y = y0 - 1 + r
                    if not ya <= y <= yb:
                        continue
                    rb = base + y * W
                    c = ((rb + xa) >> 2) + lanes
                    for j in range(4):   # whole chunks and partial ones alike, float by float
                        i = 4 * c + j
                        inside = (4 * c <= rb + xb) & (i >= rb + xa) & (i <= rb + xb)
                        q = 4 * lanes[inside] + j
                        val = flat[i[inside]]
                        f = sflag[scy[r] * ncx + scx[q - shift(y) + 3]]
                        srow[r * ROW + q] = np.where(val > np.where(f != 0, ini, mn), val, 0)
                        staged[r * ROW + q] = True
                x_end = min(x0 + NX, Wl)
                for y in range(y0, min(y0 + NY, Hl)):
                    rb, r = base + y * W, y - y0 + 1
                    o0, o1 = rb + x0, rb + x_end
                    c = (o0 >> 2) + lanes
                    c = c[4 * c < o1]
                    ctr = r * ROW + 4 * (c - ((rb + xa) >> 2))   # the centres' 16-byte read
                    assert (ctr >= r * ROW).all() and (ctr + 4 <= (r + 1) * ROW).all()
                    i = (4 * c)[:, None] + np.arange(4)[None, :]
                    at = ctr[:, None] + np.arange(4)[None, :]
                    keep = (i >= o0) & (i < o1)
                    i, at = i[keep], at[keep]
                    x = i - rb
                    s = srow[at]
                    res = np.zeros(i.size, np.float32)
                    test = (s > 0) & (margin <= y < Hl - margin) & (x >= margin) & (x < Wl - margin)
                    xt, st = x[test], s[test]
                    m = np.full(xt.size, -np.inf, np.float32)
                    for dy in (-1, 0, 1):
                        for dx in (-1, 0, 1):
                            if (dy, dx) != (0, 0):
                                nb = (r + dy) * ROW + xt + dx - xa + shift(y + dy)
                                assert staged[nb].all(), "a read of a pixel the tile did not stage"
                                m = np.maximum(m, srow[nb])
                    assert staged[at[test]].all()
                    res[test] = np.where(m > st, np.float32(0), st)
                    out[i] = res
                    writes[i] += 1
    return out.reshape(P, H, W), writes.reshape(P, H, W)


def _check(stack, shapes, pad=0, ini_th=INI, min_th=MIN, cell=CELL):
    gated, flags = fast.score_planes_plain(stack, shapes, pad, ini_th, min_th, cell)
    ref = fast.nms_planes_plain(gated, flags, shapes, ini_th, min_th, cell)
    got, writes = emu_nms(gated.numpy(), flags.numpy(), shapes, ini_th, min_th, cell)
    inside = np.zeros(writes.shape, bool)
    for p, (h, w) in enumerate(shapes):
        inside[p, :h, :w] = True
        assert np.array_equal(got[p, :h, :w].view(np.int32), ref[p, :h, :w].numpy().view(np.int32))
    assert (writes[inside] == 1).all() and (writes[~inside] == 0).all()
    return ref


def _stack(planes):
    H = max(p.shape[0] for p in planes)
    W = max(p.shape[1] for p in planes)
    stack = torch.zeros((len(planes), H, W))
    for k, p in enumerate(planes):
        stack[k, :p.shape[0], :p.shape[1]] = torch.as_tensor(p)
    return stack, [tuple(p.shape) for p in planes]


def test_plateau_plain_matches_jax():
    """``nms_planes_plain`` after ``score_planes_plain`` against the JAX
    ``detect_level`` on ``chip_smoke.plateau_image``: ties survive together,
    a weak plateau across a cell edge survives only where its cell holds no
    strong corner."""
    img = chip_smoke.plateau_image()
    stack, shapes = _stack([img])
    gated, flags = fast.score_planes_plain(stack, shapes, 0, INI, MIN, CELL)
    got = fast.nms_planes_plain(gated, flags, shapes, INI, MIN, CELL)[0].numpy()
    ref = np.asarray(jorb.detect_level(jnp.asarray(img), INI, MIN, CELL))
    np.testing.assert_array_equal(got, ref)
    assert (got[25:27, 33:35] == 0).all() and (got[25:27, 35:37] == 15).all()
    assert (got[33:35, 50:52] == 15).all() and (got[35:37, 50:52] == 0).all()
    assert (got[45:47, 68:72] == 30).all()             # a tie across two flagged cells
    assert (got[100:102, 32:34] == 50).all() and (got[100:102, 31] == 0).all()
    assert (got[68:72, 120:123] == 15).all()            # unflagged on both sides
    assert (got[20:22, 20:22] == 100).all() and (got[50:52, 50:52] == 90).all()


@pytest.mark.parametrize("W", [203, 204, 205, 206])
def test_tiling_on_plateaus(W):
    """The plateau image and shifted copies in one stack, every row offset
    modulo 4 floats and tiles cut across the plateaus."""
    img = chip_smoke.plateau_image(150, W)
    planes = [img, np.roll(img, (7, 61), (0, 1)), np.roll(img, (-19, 93), (0, 1))[:131, :W - 9]]
    _check(*_stack(planes))


@pytest.mark.parametrize("shape", [(376, 1241), (105, 346), (64, 33), (40, 40)])
def test_tiling_on_pyramids(shape):
    """The 8-level pyramid of a textured image (2 images at the small
    sizes), planes of the main path's shapes and of odd ones."""
    rng = np.random.default_rng(shape[0])
    imgs = [torch.as_tensor(rng.integers(0, 256, shape).astype(np.float32))
            for _ in range(1 if shape[0] > 300 else 2)]
    smooth = [(x + torch.roll(x, 1, 0) + torch.roll(x, 1, 1)) / 3 for x in imgs]
    planes = [lvl.numpy() for im in smooth for lvl in torb.pyramid(im.round(), 8, 1.2)]
    ref = _check(*_stack(planes))
    assert int((ref > 0).sum()) > 0


def test_tiling_thresholds_and_cells():
    """Other thresholds and cell sizes (the flags' staged area grows as the
    cell shrinks): cell 1, 16 and 200."""
    rng = np.random.default_rng(9)
    img = rng.integers(0, 256, (97, 251)).astype(np.float32)
    for ini_th, min_th, cell in ((40.0, 3.0, 16), (5.0, 9.0, 1), (20.0, 7.0, 200)):
        _check(*_stack([img]), 0, ini_th, min_th, cell)
