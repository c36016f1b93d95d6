"""``match_best2``'s stereo mode (``csrc/match.cu``: the row bins, then the
rows) and ``fast_nms_planes`` (``csrc/fast.cu``) against their plain PyTorch
versions, on a card.

Marked ``gpu``: they skip where torch sees no CUDA device (the decision is
taken inside the fixture, never at import). On a machine with one card:
``python -m pytest --noconftest -m gpu tests/test_torch_stereo_nms_cuda.py``.
Every comparison is exact: both kernels only subtract, compare, take
min/max, XOR and count bits. Each checks the same bits on a second call and
the launches a call.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from tc2li_slam_torch.ops import orb
from tc2li_slam_torch.ops.kernels import build, fast, match, orb as korb

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _same(got, ref):
    for g, r in zip(got, ref):
        assert (g is None) == (r is None)
        if g is not None:
            assert g.dtype == r.dtype and torch.equal(g, r)


def _stereo_match(args, mutual):
    before = match.launches, match.launches_by_mode.get("stereo" + "+mutual" * mutual, 0)
    got = match.match_best2(*args, mutual)
    again = match.match_best2(*args, mutual)
    ref = match.match_best2_plain(*args, mutual)
    torch.cuda.synchronize()
    assert match.launches - before[0] == 2
    assert match.launches_by_mode["stereo" + "+mutual" * mutual] - before[1] == 2
    _same(got, ref)
    _same(got, again)
    return got


# --- match_best2's stereo mode ----------------------------------------------

@pytest.mark.parametrize("case", chip_smoke.STEREO_BIN_CASES)
@pytest.mark.parametrize("mutual", [False, True])
def test_stereo_bins_edge_cases(cuda, case, mutual):
    """``chip_smoke.stereo_bins_case``'s cases, as the CPU emulation
    (``tests/test_torch_stereo_bins_emulation.py``) takes them."""
    seed = 20 + chip_smoke.STEREO_BIN_CASES.index(case)
    c = chip_smoke.stereo_bins_case(np.random.default_rng(seed), case)
    _stereo_match(chip_smoke.stereo_bins_args(torch, match, c, cuda), mutual)


_PAIRS = {}


@pytest.mark.parametrize("case", chip_smoke.STEREO_CASES)
def test_stereo_frame_cases(cuda, case):
    """``chip_smoke.STEREO_CASES``' keypoints at 1241x376, mutual, under the
    frame build's bands."""
    from tc2li_slam_torch.io import synthetic as syn
    if "kitti" not in _PAIRS:
        _PAIRS["kitti"] = chip_smoke.stereo_pair(torch, syn, orb, cuda)
    _, _, kl, kr = chip_smoke.stereo_case(np.random.default_rng(1), case, *_PAIRS["kitti"])
    up = lambda x: torch.as_tensor(x).to(cuda)
    sf = up((1.2 ** np.arange(8)).astype(np.float32))
    mask = match.StereoMask(up(kl["xy"]), up(kl["level"]), up(kr["xy"]), up(kr["level"]),
                            2.0 * sf[up(kr["level"]).long()],
                            float(np.float32(718.856 * np.float32(0.537)) / np.float32(0.537)))
    _, best, _, _ = _stereo_match((up(kl["desc"]), up(kr["desc"]), up(kl["valid"]),
                                   up(kr["valid"]), mask), True)
    assert int((best < match.BIG).sum()) > 40


def test_stereo_limits_and_unaligned_inputs(cuda):
    """The column limit (``tc2li_match_max_columns(1)``; one column more
    runs as two column chunks), a view whose positions and descriptors are
    not 16-byte aligned, N 1."""
    lib = build.library()
    assert lib.tc2li_match_max_columns(1) == chip_smoke.STEREO_MAX_COLUMNS
    c = chip_smoke.stereo_bins_case(np.random.default_rng(3), "full width")
    d1, d2, v1, v2, mask = chip_smoke.stereo_bins_args(torch, match, c, cuda)
    wide = (d1, torch.cat([d2, d2[:1]]), v1, torch.cat([v2, v2[:1]]), mask._replace(
        uv2=torch.cat([mask.uv2, mask.uv2[:1]]), lvl2=torch.cat([mask.lvl2, mask.lvl2[:1]]),
        band=torch.cat([mask.band, mask.band[:1]])))
    before = match.launches
    _same(match.match_best2(*wide, True), match.match_best2_plain(*wide, True))
    assert match.launches - before == 2
    # views 4 bytes into a buffer: positions and descriptors off their 8- and
    # 16-byte boundaries (the wrapper copies them)
    odd = lambda x: torch.cat([x.reshape(-1)[:1], x.reshape(-1)])[1:].view(x.shape)
    args = (odd(d1), odd(d2), v1, v2, mask._replace(uv1=odd(mask.uv1), uv2=odd(mask.uv2)))
    assert args[0].data_ptr() % 16 and args[4].uv1.data_ptr() % 8
    _stereo_match(args, True)
    _stereo_match((d1[:1], d2, v1[:1], v2, mask._replace(uv1=mask.uv1[:1],
                                                        lvl1=mask.lvl1[:1])), False)


def test_stereo_no_valid_column(cuda):
    c = chip_smoke.stereo_bins_case(np.random.default_rng(4), "invalid")
    c["valid2"][:] = False
    idx, best, second, back = _stereo_match(chip_smoke.stereo_bins_args(torch, match, c, cuda),
                                            True)
    assert bool((best == match.BIG).all()) and int(idx.abs().max()) == 0


# --- fast_nms_planes ----------------------------------------------------------

def _nms(gated, flags, shapes, ini_th=20.0, min_th=7.0, cell=35):
    before = fast.nms_launches
    got = fast.nms_planes(gated, flags, shapes, ini_th, min_th, cell)
    again = fast.nms_planes(gated, flags, shapes, ini_th, min_th, cell)
    ref = fast.nms_planes_plain(gated, flags, shapes, ini_th, min_th, cell)
    torch.cuda.synchronize()
    assert fast.nms_launches - before == 2
    bits = lambda x, p, h, w: x[p, :h, :w].contiguous().view(torch.int32)
    for p, (h, w) in enumerate(shapes):
        assert torch.equal(bits(got, p, h, w), bits(ref, p, h, w)), p
        assert torch.equal(bits(got, p, h, w), bits(again, p, h, w)), p
    return ref


@pytest.mark.parametrize("size", [None, (720, 1280), (1080, 1920)])
def test_nms_planes_camera_pyramids(cuda, size):
    """Both images' 8-level stacks of the KITTI-shaped pair, and of the pair
    resampled to 1280x720 and 1920x1080, as ``orb.extract_images`` makes
    them."""
    from tc2li_slam_torch.io import synthetic as syn
    if "kitti" not in _PAIRS:
        _PAIRS["kitti"] = chip_smoke.stereo_pair(torch, syn, orb, cuda)
    imgs = torch.stack([torch.as_tensor(x) for x in _PAIRS["kitti"][:2]]).to(cuda).float()
    if size is not None:
        imgs = torch.nn.functional.interpolate(imgs[:, None], size=size, mode="bilinear",
                                               antialias=True)[:, 0].round().clamp(0, 255)
    st, _, shapes = korb.orb_level_planes(imgs.contiguous(), 8, 1.2)
    gated, flags = fast.score_planes(st, shapes, korb.PAD)
    ref = _nms(gated, flags, shapes)
    assert int((ref > 0).sum()) > 1000


@pytest.mark.parametrize("W", [203, 204, 205, 206])
def test_nms_planes_plateaus(cuda, W):
    """``chip_smoke.plateau_image`` and shifted copies: ties across 35-px
    cell edges whose flags differ, every row offset modulo 4 floats."""
    img = chip_smoke.plateau_image(150, W)
    planes = [img, np.roll(img, (7, 61), (0, 1)), np.roll(img, (-19, 93), (0, 1))]
    stack = torch.as_tensor(np.stack(planes)).to(cuda)
    shapes = [(150, W), (150, W), (131, W - 9)]
    gated, flags = fast.score_planes(stack, shapes)
    ref = _nms(gated, flags, shapes)
    assert float(ref[0, 25, 35]) == 15.0 and float(ref[0, 25, 34]) == 0.0


def test_nms_planes_thresholds_cells_and_unaligned(cuda):
    """Cells of 1, 16 and 200 px with other thresholds, and pass 1's scores
    as a view that is not 16-byte aligned."""
    rng = np.random.default_rng(9)
    img = torch.as_tensor(rng.integers(0, 256, (2, 97, 251)).astype(np.float32)).to(cuda)
    shapes = [(97, 251), (90, 240)]
    for ini_th, min_th, cell in ((40.0, 3.0, 16), (5.0, 9.0, 1), (20.0, 7.0, 200)):
        gated, flags = fast.score_planes(img, shapes, 0, ini_th, min_th, cell)
        _nms(gated, flags, shapes, ini_th, min_th, cell)
    gated, flags = fast.score_planes(img, shapes)
    view = torch.cat([gated.reshape(-1)[:1], gated.reshape(-1)]).narrow(0, 1, gated.numel())
    _nms(view.view(gated.shape), flags, shapes)
