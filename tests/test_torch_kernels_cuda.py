"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Marked ``gpu``: they skip where torch sees no CUDA device (the decision is
taken inside the fixture, never at import). On a machine with one card:
``python -m pytest --noconftest -m gpu tests/test_torch_kernels_cuda.py``.
Every comparison is exact: the kernels only subtract, compare, take
min/max, XOR and count bits.
"""

import numpy as np
import pytest
import torch

from tc2li_slam_torch.ops import matching, orb, stereo
from tc2li_slam_torch.ops.kernels import fast, hamming, match

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _image(seed, shape, smooth=True):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, shape).astype(np.float32)
    if smooth:   # sparser corners, some cells without a strong one
        img = (img + np.roll(img, 1, 0) + np.roll(img, 1, 1) + np.roll(img, (1, 1), (0, 1))) / 4
    return torch.as_tensor(img)


@pytest.mark.parametrize("shape", [(376, 1241), (105, 346), (7, 7), (64, 33), (6, 40)])
def test_fast_kernel_matches_plain(cuda, shape):
    img = _image(1, shape, smooth=False).to(cuda)
    before = fast.score_launches
    got = fast.fast_score_raw(img)          # CUDA tensor -> kernel
    ref = fast.fast_score_raw_plain(img)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)            # exact, ring included (both 0)
    assert fast.score_launches - before == 1


@pytest.mark.parametrize("ini_th,min_th,cell", [(20.0, 7.0, 35), (5.0, 9.0, 35),
                                                (40.0, 3.0, 16), (300.0, 280.0, 35)])
def test_detect_planes_matches_plain_per_level(cuda, ini_th, min_th, cell):
    """Two images' ragged 8-level stacks in one call, against the plain
    per-level detection; and the one-plane entry ``orb.detect_level``."""
    imgs = [_image(2, (376, 1241)).to(cuda), _image(3, (376, 1241), smooth=False).to(cuda)]
    pad = 19
    stack = torch.full((16, 376 + 2 * pad, 1241 + 2 * pad), 1e9, device=cuda)
    shapes = []
    for b, img in enumerate(imgs):
        for lvl, li in enumerate(orb.pyramid(img, 8, 1.2)):
            Hl, Wl = li.shape
            stack[b * 8 + lvl, pad:pad + Hl, pad:pad + Wl] = li
            shapes.append((Hl, Wl))
    before = fast.score_launches, fast.nms_launches
    got = fast.detect_planes(stack, shapes, pad, ini_th, min_th, cell)
    torch.cuda.synchronize()
    assert (fast.score_launches - before[0], fast.nms_launches - before[1]) == (1, 1)
    n_corners = 0
    for p, (Hl, Wl) in enumerate(shapes):
        ref = fast.detect_level_plain(stack[p, pad:pad + Hl, pad:pad + Wl], ini_th, min_th, cell)
        assert torch.equal(got[p, :Hl, :Wl], ref), p
        n_corners += int((ref > 0).sum())
    assert (n_corners > 0) == (ini_th < 100)
    one = orb.detect_level(imgs[0], ini_th, min_th, cell)
    assert torch.equal(one, got[0, :376, :1241])


def test_detect_planes_refuses_what_the_kernel_does_not_take(cuda):
    stack = torch.zeros((1, 64, 64), device=cuda)
    with pytest.raises(ValueError):
        fast.detect_planes(stack, [(64, 64)], 0, -1.0, 7.0)
    with pytest.raises(ValueError):
        fast.detect_planes(torch.zeros((33, 64, 64), device=cuda), [(64, 64)] * 33)
    with pytest.raises(ValueError):
        fast.detect_planes(stack, [(65, 64)])


@pytest.mark.parametrize("n,m", [(2000, 2000), (37, 53), (1, 1), (0, 5), (4096, 31)])
def test_hamming_kernel_matches_plain(cuda, n, m):
    g = torch.Generator(device=cuda).manual_seed(n * 7 + m)
    a = torch.randint(-2 ** 31, 2 ** 31 - 1, (n, 8), generator=g, device=cuda, dtype=torch.int32)
    b = torch.randint(-2 ** 31, 2 ** 31 - 1, (m, 8), generator=g, device=cuda, dtype=torch.int32)
    got = hamming.hamming_matrix(a, b)
    assert got.shape == (n, m) and got.dtype == torch.int32
    assert torch.equal(got, hamming.hamming_matrix_plain(a, b))


def test_hamming_kernel_extremes(cuda):
    zeros = torch.zeros((40, 8), dtype=torch.int32, device=cuda)
    ones = torch.full((40, 8), -1, dtype=torch.int32, device=cuda)
    assert bool((hamming.hamming_matrix(zeros, ones) == 256).all())
    assert bool((hamming.hamming_matrix(ones, ones) == 0).all())


def _match_case(seed, n, m, dev, near=True):
    """Descriptors (side 1 near copies of side 2, so minima tie and ratio
    tests bite), positions, levels, validity; a few edge rows."""
    rng = np.random.default_rng(seed)
    d2 = rng.integers(-2 ** 31, 2 ** 31 - 1, (m, 8)).astype(np.int32)
    src = rng.integers(0, m, n)
    d1 = d2[src].copy() if near else rng.integers(-2 ** 31, 2 ** 31 - 1, (n, 8)).astype(np.int32)
    d1[:, 0] ^= rng.integers(0, 1 << 12, n).astype(np.int32)
    if m > 3:
        d2[1] = d2[0]                      # a duplicate column: tied minima
    uv2 = rng.uniform(0, 300, (m, 2)).astype(np.float32)
    uv1 = (uv2[src] + rng.normal(0, 4, (n, 2))).astype(np.float32)
    c = dict(d1=d1, d2=d2, uv1=uv1, uv2=uv2,
             lvl1=rng.integers(0, 8, n).astype(np.int32),
             lvl2=rng.integers(0, 8, m).astype(np.int32),
             radius=rng.uniform(2, 40, n).astype(np.float32),
             band=rng.uniform(2, 8, m).astype(np.float32),
             valid1=rng.random(n) > 0.2, valid2=rng.random(m) > 0.1)
    if n > 2:
        c["radius"][2] = 0.0               # a valid row that admits nothing
        c["valid1"][2] = True
    return {k: torch.as_tensor(v).to(dev) for k, v in c.items()}


def _same(got, ref):
    for g, r in zip(got, ref):
        assert (g is None) == (r is None)
        if g is not None:
            assert g.dtype == r.dtype and torch.equal(g, r)


@pytest.mark.parametrize("n,m", [(2000, 2000), (4099, 517), (3, 1), (1, 70), (33, 2001)])
@pytest.mark.parametrize("mutual", [False, True])
def test_match_best2_matches_plain(cuda, n, m, mutual):
    c = _match_case(n * 3 + m, n, m, cuda)
    masks = [
        match.WindowMask(c["uv1"], c["radius"], c["lvl1"], c["uv2"], c["lvl2"]),
        match.WindowMask(c["uv1"], c["radius"], c["lvl1"], c["uv2"], c["lvl2"], 0, 3),
        match.StereoMask(c["uv1"], c["lvl1"], c["uv2"], c["lvl2"], c["band"], 30.0),
        torch.as_tensor(np.random.default_rng(5).random((n, m)) > 0.7).to(cuda),
        None,
    ]
    for mask in masks:
        before = match.launches
        got = match.match_best2(c["d1"], c["d2"], c["valid1"], c["valid2"], mask, mutual)
        torch.cuda.synchronize()
        assert match.launches - before == 1
        _same(got, match.match_best2_plain(c["d1"], c["d2"], c["valid1"], c["valid2"],
                                           mask, mutual))


def test_match_best2_all_invalid_and_limits(cuda):
    c = _match_case(9, 64, 40, cuda)
    none1 = torch.zeros_like(c["valid1"])
    idx, best, second, back = match.match_best2(c["d1"], c["d2"], none1, c["valid2"],
                                                None, mutual=True)
    assert int(idx.abs().max()) == 0 and int(back.abs().max()) == 0
    assert bool((best == match.BIG).all()) and bool((second == match.BIG).all())
    wide = torch.zeros((8000, 8), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):        # side 2 does not fit shared memory
        match.match_best2(c["d1"], wide, c["valid1"],
                          torch.ones(8000, dtype=torch.bool, device=cuda))
    with pytest.raises(ValueError):        # wrong dtype for the kernel
        match.match_best2(c["d1"], c["d2"], c["valid1"], c["valid2"],
                          match.WindowMask(c["uv1"].double(), c["radius"], c["lvl1"],
                                           c["uv2"], c["lvl2"]))


def test_matchers_on_cuda_match_cpu(cuda):
    """The public matchers (kernel route) against themselves on the CPU
    (plain route), including the ratio and mutual tests around the kernel."""
    c = _match_case(11, 700, 300, cuda)
    h = {k: v.cpu() for k, v in c.items()}
    for t in (c, h):
        t["sf"] = (1.2 ** torch.arange(8, dtype=torch.float32)).to(t["d1"].device)
    outs = []
    for t in (c, h):
        a = matching.search_by_projection(t["uv1"], t["lvl1"], t["d1"], t["valid1"], t["uv2"],
                                          t["lvl2"], t["d2"], t["valid2"], t["radius"])
        b = stereo.match_stereo(t["uv1"], t["lvl1"], t["d1"], t["valid1"], t["uv2"], t["lvl2"],
                                t["d2"], t["valid2"], t["sf"], 40.0, 1.0)
        d = matching.match_descriptors(t["d1"], t["d2"], t["valid1"], t["valid2"], None,
                                       max_dist=100, ratio=0.9, mutual=True)
        outs.append([x.cpu() for x in (*a, *b, *d)])
    for g, r in zip(*outs):
        assert g.dtype == r.dtype and torch.equal(g, r)
    assert int(outs[0][2].sum()) > 50 and int(outs[0][5].sum()) > 5


def test_system_on_cuda_matches_cpu(cuda):
    """The whole slice on the card (kernels and device-side scatters, sorts
    and solves) against the same slice on the CPU, which the CPU tests hold
    to the JAX package: the same keyframes, per-frame positions within 5 mm."""
    from tc2li_slam_torch.io import synthetic as syn
    from tc2li_slam_torch.slam import config as tcfg, system as tsys
    from torch_parity import small_config, small_sequence

    frames = small_sequence(8)
    launches0 = fast.score_launches, fast.nms_launches, match.launches
    runs = {}
    for dev in ("cpu", "cuda"):
        s = tsys.System(small_config(tcfg), dev)
        for fr in frames:
            s.track(fr.img_l, fr.img_r, fr.t, fr.scan, fr.scan_valid)
            assert s.state == tsys.TrackingState.OK
        runs[dev] = (s, s.trajectory_world_from_cam())
    (sc, ec), (sg, eg) = runs["cpu"], runs["cuda"]
    assert int(sg.map.n_kf) == int(sc.map.n_kf) >= 3 and sg.n_ba_balm >= 1
    assert np.linalg.norm(eg[:, :3, 3] - ec[:, :3, 3], axis=-1).max() < 5e-3
    gt = np.stack([fr.T_wb_gt @ syn.body_from_cam() for fr in frames])
    assert syn.ate_rmse(eg, gt) < 0.15
    # one detection (two launches) per frame; a stereo match per frame, a
    # tracking match per frame after the first, one match per fuse pass
    assert fast.score_launches - launches0[0] == 8
    assert fast.nms_launches - launches0[1] == 8
    assert match.launches - launches0[2] == 8 + 7 + sg.n_fuse
