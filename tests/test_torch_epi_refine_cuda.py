"""``match_best2``'s epipolar mode (``csrc/match.cu``
``match_best2_epipolar_kernel``) and the stereo half's refine launch with
its last-block gate (``csrc/stereo.cu``) against their plain PyTorch
versions, on a card.

Marked ``gpu``: they skip where torch sees no CUDA device (the decision is
taken inside the fixture, never at import). On a machine with one card:
``python -m pytest --noconftest -m gpu tests/test_torch_epi_refine_cuda.py``.
Every comparison is exact and checks the same bits on a second call and
the launches a call: the epipolar gate rounds each float32 operation as the
plain chain does, and the SADs of grey-level images are exact integers.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from tc2li_slam_torch.ops import orb
from tc2li_slam_torch.ops.kernels import build, match, stereo as kst

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


# --- match_best2's epipolar mode --------------------------------------------

def test_epipolar_column_limit(cuda):
    assert build.library().tc2li_match_max_columns(3) == match.EPI_MAX_COLUMNS
    assert build.library().tc2li_match_max_columns(1) == match.STEREO_MAX_COLUMNS
    assert build.library().tc2li_match_max_columns(0) == match.WINDOW_MAX_COLUMNS
    assert chip_smoke.EPI_MAX_COLUMNS == match.EPI_MAX_COLUMNS


@pytest.mark.parametrize("case", chip_smoke.EPI_CASES)
@pytest.mark.parametrize("mutual", [False, True])
def test_epipolar_edge_cases(cuda, case, mutual):
    """``chip_smoke.epipolar_case``'s cases, as the CPU emulation
    (``tests/test_torch_epipolar_emulation.py``) takes them: a launch a
    column chunk, no [N, M] tensor."""
    c = chip_smoke.epipolar_case(np.random.default_rng(100 + chip_smoke.EPI_CASES.index(case)),
                                 case)
    args = chip_smoke.epipolar_args(torch, match, c, cuda)
    key = "epipolar" + "+mutual" * mutual + ("+chunk" if case == "wide" else "")
    before = match.launches, match.launches_by_mode.get(key, 0)
    got = match.match_best2(*args, mutual)
    again = match.match_best2(*args, mutual)
    torch.cuda.synchronize()
    n_chunks = len(match.chunk_bounds(args[1].shape[0], args[4]))
    assert n_chunks == (2 if case == "wide" else 1)
    assert match.launches - before[0] == 2 * n_chunks
    assert match.launches_by_mode[key] - before[1] == 2 * n_chunks
    _same(got, match.match_best2_plain(*args, mutual))
    _same(got, again)


def test_epipolar_pair_through_match_descriptors(cuda):
    """The triangulation match's call (max_dist 40, ratio 0.8, mutual) on a
    keyframe pair at 2,000 x 2,000: the card's results are the CPU route's
    on the same lines."""
    from tc2li_slam_torch.ops import matching
    c = chip_smoke.epipolar_pair(np.random.default_rng(5), 2000, 2000)
    args = chip_smoke.epipolar_args(torch, match, c, cuda)
    cpu = [x.cpu() for x in args[:4]] + [match.EpipolarMask(*(
        x.cpu() if isinstance(x, torch.Tensor) else x for x in args[4]))]
    got = matching.match_descriptors(*args, max_dist=40, ratio=0.8, mutual=True)
    ref = matching.match_descriptors(*cpu, max_dist=40, ratio=0.8, mutual=True)
    for g, r in zip(got, ref):
        assert torch.equal(g.cpu(), r)
    assert int(got[2].sum()) > 300


@pytest.mark.parametrize("kind", ["window", "stereo"])
def test_chunked_window_and_stereo(cuda, kind):
    """A side 2 wider than the window or stereo mode's columns runs as two
    column chunks, merged exactly (any keypoint count is taken)."""
    rng = np.random.default_rng(11)
    if kind == "window":
        c = chip_smoke.window_case(rng, 300, match.WINDOW_MAX_COLUMNS + 560)
        args = chip_smoke.window_args(torch, match, c, cuda)
    else:
        c = chip_smoke.stereo_bins_case(rng, "level gate", N=300, M=match.STEREO_MAX_COLUMNS + 880)
        args = chip_smoke.stereo_bins_args(torch, match, c, cuda)
    for mutual in (False, True):
        before = match.launches
        got = match.match_best2(*args, mutual)
        torch.cuda.synchronize()
        assert match.launches - before == 2
        _same(got, match.match_best2_plain(*args, mutual))


# --- the stereo half: prep, the match, refine with the gate ------------------

_PAIRS = {}


def _stereo_args(case, dev):
    from tc2li_slam_torch.io import synthetic as syn
    if "kitti" not in _PAIRS:
        _PAIRS["kitti"] = chip_smoke.stereo_pair(torch, syn, orb, dev)
    il, ir, kl, kr = chip_smoke.stereo_case(np.random.default_rng(1), case, *_PAIRS["kitti"])
    sf = torch.as_tensor((1.2 ** np.arange(8)).astype(np.float32)).to(dev)
    rig = syn.KITTI_LIKE
    bf = float(np.float32(rig.fx) * np.float32(rig.baseline))
    return (torch.as_tensor(il).to(dev), torch.as_tensor(ir).to(dev),
            chip_smoke.stereo_keypoints(torch, orb, kl, dev),
            chip_smoke.stereo_keypoints(torch, orb, kr, dev), sf, bf, rig.baseline)


@pytest.mark.parametrize("case", chip_smoke.STEREO_CASES + chip_smoke.STEREO_EDGE_CASES)
def test_stereo_refine_cases(cuda, case):
    """Bit-equal to ``stereo_refine_plain`` (u_r, ok, depth, uvr), the same
    bits twice, two launches of its own a call (one without left
    keypoints) and the match's, one a column chunk."""
    a = _stereo_args(case, cuda)
    N, M = a[2].xy.shape[0], a[3].xy.shape[0]
    n0, m0 = kst.launches, match.launches
    got, again = kst.stereo_refine(*a), kst.stereo_refine(*a)
    torch.cuda.synchronize()
    assert kst.launches - n0 == 2 * kst.launches_per_call(N, M)
    assert match.launches - m0 == 2 * int(N > 0) * len(match.chunk_bounds(M, match.StereoMask))
    ref = kst.stereo_refine_plain(*a)
    assert chip_smoke.bit_equal(torch, got, ref) and chip_smoke.bit_equal(torch, got, again)
    if case in ("all_ok", "odd", "even", "one keypoint", "sad ties"):
        assert bool(ref.ok.any())   # the median gate fired on a finite threshold


def test_stereo_refine_gate_counter_resets(cuda):
    """The last-block gate leaves its arrival counter at zero: calls of
    other sizes in a row stay bit-equal (a stale count would elect the wrong
    last block)."""
    for case in ("frame", "one keypoint", "all_ok", "one not ok", "frame"):
        a = _stereo_args(case, cuda)
        assert chip_smoke.bit_equal(torch, kst.stereo_refine(*a), kst.stereo_refine_plain(*a))
        torch.cuda.synchronize()
        stream = torch.cuda.current_stream(a[2].xy.device).cuda_stream
        assert kst._sync[(a[2].xy.device, stream)].tolist() == [0]


def test_stereo_refine_unaligned_keypoints_and_other_stream(cuda):
    """Keypoints whose positions and descriptors are views off their 8- and
    16-byte boundaries (aligned before the chain's first launch), and a call
    on a second stream with its own gate counter: both bit-equal. The
    chained match itself refuses inputs it would have to copy."""
    odd = lambda x: torch.cat([x.reshape(-1)[:1], x.reshape(-1)])[1:].view(x.shape)
    il, ir, kl, kr, sf, bf, min_z = _stereo_args("frame", cuda)
    kl2, kr2 = (k._replace(xy=odd(k.xy), desc=odd(k.desc)) for k in (kl, kr))
    assert kl2.xy.data_ptr() % 8 and kr2.desc.data_ptr() % 16
    ref = kst.stereo_refine_plain(il, ir, kl, kr, sf, bf, min_z)
    assert chip_smoke.bit_equal(torch, kst.stereo_refine(il, ir, kl2, kr2, sf, bf, min_z), ref)
    side = torch.cuda.Stream(cuda)
    side.wait_stream(torch.cuda.current_stream(cuda))
    with torch.cuda.stream(side):
        got = kst.stereo_refine(il, ir, kl, kr, sf, bf, min_z)
    torch.cuda.current_stream(cuda).wait_stream(side)
    assert chip_smoke.bit_equal(torch, got, ref)
    assert (kl.xy.device, side.cuda_stream) in kst._sync
    M = kr.xy.shape[0]
    band = torch.ones(M, dtype=torch.float32, device=cuda)
    mask = match.StereoMask(kl.xy, kl.level, odd(kr.xy), kr.level, band, 100.0)
    colbest = torch.full((M,), match.BIG << 32, dtype=torch.int64, device=cuda)
    with pytest.raises(ValueError, match="chained"):
        match.match_best2_packed(kl.desc, kr.desc, kl.valid, kr.valid, mask, colbest)
