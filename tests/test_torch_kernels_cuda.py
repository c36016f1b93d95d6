"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Marked ``gpu``: they skip where torch sees no CUDA device (the decision is
taken inside the fixture, never at import). On a machine with one card:
``python -m pytest --noconftest -m gpu tests/test_torch_kernels_cuda.py``.
The FAST, Hamming and matching comparisons are exact: those kernels only
subtract, compare, take min/max, XOR and count bits. The pose-only LM sums
in float32 in another order than its plain version: poses to 1e-4, costs to
1e-3 relative, inlier flags equal but at a gate. So do the window BA's two
kernels: ``local_ba_lm`` to 1e-4 in pose, 1e-3 m in landmarks and 1e-4 in
cost, relative (as the CPU tests against the JAX package);
``balm_quadratic`` H and g to 1e-3 of their largest entry, the cost to 1e-3
relative. The IMU mode's two kernels run in other types or orders than
their plain versions: ``pose_inertial_lm`` (float64) to
``chip_smoke.VI_TOL`` (T_wb and vel 1e-4, bg 1e-5, ba 1e-4, the next
prior's H 1e-3 after diagonal scaling, the cost 1e-3) or else no farther
from the plain version run in float64 than the float32 plain version is,
inlier flags equal but at a gate; ``imu_preintegrate`` (float32 sums in
another order than ATen's) within 1e-4 of the plain version run in float64
(``chip_smoke.imu_distance``: the covariance diagonally scaled, any other
output over its largest entry), or 4x the float32 plain version's own
distance. The scan step's four kernels (``chip_smoke.lio_phase``,
``LIO_TOL``): the prediction to 1e-4 (state; P diagonally scaled), the
neighbour sets 99.9% equal, the rows' normal equations (float64 plane fits)
to 1e-4 after diagonal scaling or else no farther from the plain version
run in float64, each step launch to 1e-6 of ``esekf.map_step`` in float64
on its own sums, the update to 1e-3 in state and rtol 2e-2 in P (or else
no farther from float64), ``n_iters`` and ``bad`` equal, ``n_effective``
within 3.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from tc2li_slam_torch.geom import camera as cam_mod
from tc2li_slam_torch.ops import matching, orb, stereo
from tc2li_slam_torch.ops.kernels import balm as kbalm, fast, hamming, local_ba as klba, match, pose_lm
from tc2li_slam_torch.ops.kernels import imu_preint as kimu, orb as korb, pose_inertial as kpi
from tc2li_slam_torch.estimation import imu as timu
from tc2li_slam_torch.solver import balm, lm, pose_inertial as tpi

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
    ones = torch.ones(8000, dtype=torch.bool, device=cuda)
    wider = 14000                          # above the window mode's 13,440 columns
    wmask = match.WindowMask(c["uv1"], c["radius"], c["lvl1"],
                             torch.zeros((wider, 2), device=cuda),
                             torch.zeros(wider, dtype=torch.int32, device=cuda))
    d2w = torch.zeros((wider, 8), dtype=torch.int32, device=cuda)
    v2w = torch.ones(wider, dtype=torch.bool, device=cuda)
    before = match.launches                # side 2 in two column chunks, a launch each
    _same(match.match_best2(c["d1"], d2w, c["valid1"], v2w, wmask),
          match.match_best2_plain(c["d1"], d2w, c["valid1"], v2w, wmask))
    assert match.launches - before == 2
    before = match.launches                # the dense mode takes it in one launch
    _same(match.match_best2(c["d1"], wide, c["valid1"], ones, None, True),
          match.match_best2_plain(c["d1"], wide, c["valid1"], ones, None, True))
    assert match.launches - before == 1
    with pytest.raises(ValueError):        # wrong dtype for the kernel
        match.match_best2(c["d1"], c["d2"], c["valid1"], c["valid2"],
                          match.WindowMask(c["uv1"].double(), c["radius"], c["lvl1"],
                                           c["uv2"], c["lvl2"]))


def test_match_best2_epipolar_mask_shape(cuda):
    """Triangulation's call: 2000 x 2000, a dense bool mask from the
    epipolar gate of a real fundamental matrix, mutual."""
    c = _match_case(21, 2000, 2000, cuda)
    F12 = torch.tensor([[0.0, -1e-5, 2e-3], [1e-5, 0.0, -4e-3], [-2e-3, 4e-3, 0.1]], device=cuda)
    sigma2 = (1.2 ** (2.0 * c["lvl2"].float()))
    epi = matching.epipolar_mask(c["uv1"], c["uv2"], F12, sigma2)
    assert epi.dtype == torch.bool and 0 < int(epi.sum()) < epi.numel()
    before = match.launches
    got = match.match_best2(c["d1"], c["d2"], c["valid1"], c["valid2"], epi, True)
    assert match.launches - before == 1
    _same(got, match.match_best2_plain(c["d1"], c["d2"], c["valid1"], c["valid2"], epi, True))


@pytest.mark.parametrize("n_valid", [32768, 700])
def test_match_best2_pool_against_frame_shape(cuda, n_valid):
    """Global tracking's call: the whole 32768-slot landmark pool against a
    frame's 2000 features, mutual, no mask."""
    c = _match_case(22, 32768, 2000, cuda)
    v1 = c["valid1"] & (torch.arange(32768, device=cuda) < n_valid)
    before = match.launches
    got = match.match_best2(c["d1"], c["d2"], v1, c["valid2"], None, True)
    assert match.launches - before == 1
    _same(got, match.match_best2_plain(c["d1"], c["d2"], v1, c["valid2"], None, True))
    a = matching.match_descriptors(c["d1"], c["d2"], v1, c["valid2"], max_dist=50, ratio=0.75,
                                   mutual=True)
    b = matching.match_descriptors(c["d1"].cpu(), c["d2"].cpu(), v1.cpu(), c["valid2"].cpu(),
                                   max_dist=50, ratio=0.75, mutual=True)
    for g, r in zip(a, b):
        assert torch.equal(g.cpu(), r)


@pytest.mark.parametrize("n_seen", [32768, 400])
def test_match_best2_frame_against_pool_shape(cuda, n_seen):
    """Relocalization's call: a frame's 2000 features against the 32768-slot
    pool as side 2 (only the landmarks seen from one keyframe valid),
    mutual: one launch over the whole pool (tiles of valid columns inside
    it), exact, first column on ties, the same bits on a second call."""
    c = _match_case(23, 2000, 32768, cuda)
    c["d2"][20000] = c["d2"][0]             # a tie across the old chunk boundary
    c["d2"][1] = c["d2"][0]
    seen = c["valid2"] & (torch.rand(32768, device=cuda) < n_seen / 32768)
    seen[0] = seen[1] = seen[20000] = True
    from tc2li_slam_torch.ops.kernels import build
    assert build.library().tc2li_match_max_columns(2) == match.DENSE_MAX_COLUMNS == 65535
    before = match.launches, match.launches_by_mode.get("none+mutual", 0)
    got = match.match_best2(c["d1"], c["d2"], c["valid1"], seen, None, True)
    assert match.launches - before[0] == 1
    assert match.launches_by_mode["none+mutual"] - before[1] == 1
    assert "none+mutual+chunk" not in match.launches_by_mode
    _same(got, match.match_best2_plain(c["d1"], c["d2"], c["valid1"], seen, None, True))
    _same(got, match.match_best2(c["d1"], c["d2"], c["valid1"], seen, None, True))


@pytest.mark.parametrize("mutual", [False, True])
@pytest.mark.parametrize("case", chip_smoke.DENSE_CASES)
def test_match_best2_dense_tiles(cuda, case, mutual):
    """The dense mode over more than one tile of valid columns
    (``chip_smoke.dense_case`` at 300 x 12,037, the card's own tile): a tie
    across a tile boundary, a column repeated in the last tile, a row whose
    only admitted column is in the last tile, no valid row or column, a bool
    mask: bit-equal to the plain version, the same bits on a second call,
    one launch a call."""
    from tc2li_slam_torch.ops.kernels import build
    tile = build.library().tc2li_match_dense_tile(12037)
    assert 0 < 2 * tile < 12037 < 3 * tile
    c = chip_smoke.dense_case(np.random.default_rng(60 + chip_smoke.DENSE_CASES.index(case)),
                              case, tile, M=12037)
    args = chip_smoke.dense_args(torch, c, cuda)
    before = match.launches
    got = match.match_best2(*args, mutual)
    again = match.match_best2(*args, mutual)
    assert match.launches - before == 2
    _same(got, match.match_best2_plain(*args, mutual))
    _same(got, again)
    if case == "tie across tiles":
        assert (int(got[0][0]), int(got[1][0])) == (tile - 1, 0)
    if case == "last tile only":
        assert int(got[0][1]) == 12037 - 2


# --- match_best2's window mode: the column grid (csrc/match.cu window_grid_kernel) ---

def _window_check(args, mutual):
    """One launch a call in the window shape, the same bits twice, bit-equal
    to the plain version."""
    key = "window+mutual" if mutual else "window"
    before = match.launches, match.launches_by_mode.get(key, 0)
    got = match.match_best2(*args, mutual)
    again = match.match_best2(*args, mutual)
    torch.cuda.synchronize()
    assert match.launches - before[0] == 2 and match.launches_by_mode[key] - before[1] == 2
    _same(got, again)
    _same(got, match.match_best2_plain(*args, mutual))
    return got


@pytest.mark.parametrize("case", chip_smoke.WINDOW_CASES)
@pytest.mark.parametrize("mutual", [False, True])
def test_match_window_grid_edge_cases(cuda, case, mutual):
    """``chip_smoke.window_case``'s edge cases of the grid walk: windows
    across the image border, columns that stretch the grid or stay off it,
    non-finite and huge positions and radii, a tie across two cells."""
    rng = np.random.default_rng(chip_smoke.WINDOW_CASES.index(case))
    c = chip_smoke.window_case(rng, 300, 517, case)
    idx, best, _, _ = _window_check(chip_smoke.window_args(torch, match, c, cuda), mutual)
    if case == "tie across cells":
        assert idx[:5].tolist() == [3] * 5 and best[:5].tolist() == [0] * 5


@pytest.mark.parametrize("N,M,base,lo,hi", [
    (32768, 2000, 15.0, -1, 1),     # a full pool against a keyframe
    (32768, 2000, 3.0, -1, 1),      # the fuse pass's narrow windows
    (4099, 4480, 15.0, -1, 1),      # the most columns whose descriptors shared memory holds
    (4099, 4481, 15.0, -1, 1),      # ... and one more: the descriptors from L2
    (700, 13440, 30.0, 0, 3),       # the window mode's column limit
    (1, 1, 15.0, -1, 1), (33, 2001, 15.0, -8, 8), (1003, 517, 100.0, 0, 0)])
def test_match_window_grid_sizes(cuda, N, M, base, lo, hi):
    from tc2li_slam_torch.ops.kernels import build
    assert build.library().tc2li_match_max_columns(0) == 13440
    rng = np.random.default_rng(N + M)
    c = chip_smoke.window_case(rng, N, M, base=base)
    if N == 32768:
        c["valid1"][:] = True
    _window_check(chip_smoke.window_args(torch, match, c, cuda, lo, hi), False)


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


def test_default_config_and_recovery_on_cuda(cuda):
    """triangulate=True and a vocabulary on the card against the CPU: the
    same keyframes and landmarks, positions within 5 mm; one more match
    launch per triangulated pair; a teleport recovers within 0.3 m."""
    import dataclasses
    from tc2li_slam_torch.geom import lie
    from tc2li_slam_torch.io import synthetic as syn
    from tc2li_slam_torch.ops import bow
    from tc2li_slam_torch.slam import config as tcfg, system as tsys
    from torch_parity import small_config, small_sequence

    frames = small_sequence(10)
    cfg = small_config(tcfg)
    cfg = dataclasses.replace(cfg, tracking=dataclasses.replace(cfg.tracking, triangulate=True))
    descs = []
    for fr in frames[:3]:
        kp = orb.extract(torch.as_tensor(np.asarray(fr.img_l)), n_features=512, n_levels=4)
        descs.append(kp.desc.numpy().view(np.uint32)[kp.valid.numpy()])
    voc = bow.train_vocabulary(np.concatenate(descs), k=6, depth=3, seed=0)
    launches0 = match.launches
    by_mode0 = dict(match.launches_by_mode)
    runs = {}
    for dev in ("cpu", "cuda"):
        s = tsys.System(cfg, dev, voc=voc)
        for fr in frames:
            s.track(fr.img_l, fr.img_r, fr.t, fr.scan, fr.scan_valid)
            assert s.state == tsys.TrackingState.OK
        runs[dev] = (s, s.trajectory_world_from_cam())
    (sc, ec), (sg, eg) = runs["cpu"], runs["cuda"]
    assert int(sg.map.n_kf) == int(sc.map.n_kf) >= 4
    assert int(sg.map.n_lm) == int(sc.map.n_lm)
    assert int(sg.n_tri_landmarks) == int(sc.n_tri_landmarks) > 0
    assert torch.equal(sg.kf_words.cpu(), sc.kf_words)
    assert np.linalg.norm(eg[:, :3, 3] - ec[:, :3, 3], axis=-1).max() < 5e-3
    by_mode = {k: v - by_mode0.get(k, 0) for k, v in match.launches_by_mode.items()}
    by_mode = {k: v for k, v in by_mode.items() if v}
    # a stereo match per frame; a windowed match per tracked frame and per
    # fuse pass; one epipolar match per triangulated keyframe pair
    n_pairs = by_mode.pop("epipolar+mutual")
    assert by_mode == {"stereo+mutual": 10, "window": 9 + sg.n_fuse}
    assert 3 <= n_pairs <= cfg.tracking.tri_pairs * sg.n_ba
    assert match.launches - launches0 == 10 + 9 + sg.n_fuse + n_pairs

    sg.velocity = lie.se3_exp(torch.tensor([30.0, 20.0, -15.0, 0.6, -0.8, 0.9], device=cuda))
    fr = frames[5]
    before = match.launches
    global0 = match.launches_by_mode.get("none+mutual", 0)
    sg.track(fr.img_l, fr.img_r, 1.0, fr.scan, fr.scan_valid)
    assert sg.state == tsys.TrackingState.OK and sg.n_recover == 1
    assert match.launches_by_mode["none+mutual"] - global0 == 1
    T_bc = syn.body_from_cam()
    gt_cw = np.linalg.inv(frames[5].T_wb_gt @ T_bc) @ (frames[0].T_wb_gt @ T_bc)
    assert np.linalg.norm(sg.T_cw.cpu().numpy()[:3, 3] - gt_cw[:3, 3]) < 0.3
    # stereo, the failed windowed match, the global match, the windowed retry,
    # plus whatever the deferred mapping pass of this frame launched
    assert match.launches - before >= 4


@pytest.mark.parametrize("case,N", [(c, 2000) for c in chip_smoke.POSE_CASES]
                         + [("tracking", 5000), ("pnp", 1)])
def test_pose_only_lm_matches_plain(cuda, case, N):
    """The cases of tests/test_torch_pose_lm.py, and a length that is no
    multiple of the block: one launch, the plain version's result."""
    cam_args, args, kw = chip_smoke.pose_problem(np.random.default_rng(7), N, case)
    cam = cam_mod.Pinhole.create(*cam_args)
    ts = [torch.as_tensor(a).to(cuda) for a in args]
    before = pose_lm.launches
    got = lm.pose_only_optimize(cam, *ts, **kw)
    ref = pose_lm.pose_only_plain(cam, *ts, **kw)
    torch.cuda.synchronize()
    assert pose_lm.launches - before == 1
    assert (got.T_cw.dtype, got.inliers.dtype, got.n_inliers.dtype, got.cost.dtype) == \
        (ref.T_cw.dtype, ref.inliers.dtype, ref.n_inliers.dtype, ref.cost.dtype)
    a = chip_smoke.pose_agreement(cam, ts, got, ref)
    assert a["pose"] <= 1e-4 and a["cost"] <= 1e-3 and a["flips"] == a["near"], a
    assert int(got.n_inliers) == int(got.inliers.sum())
    if case in ("all_invalid", "masked_nan"):
        assert torch.equal(got.T_cw, ts[0])
    if case == "masked_nan":
        assert bool(torch.isnan(got.cost))


@pytest.mark.parametrize("N", [0, 3, 56768, 56769, 70000])
def test_pose_only_lm_staged_and_streamed_rows(cuda, N):
    """No row; fewer rows than blocks; the rows the kernel's eight blocks
    stage in shared memory (7,096 each) exactly; one more, and many more,
    that stream from device memory."""
    cam_args, args, kw = chip_smoke.pose_problem(np.random.default_rng(8), max(N, 1), "tracking")
    cam = cam_mod.Pinhole.create(*cam_args)
    ts = [torch.as_tensor(a).to(cuda) for a in args]
    ts = ts[:1] + [a[:N] for a in ts[1:]]
    got = pose_lm.pose_only_lm(cam, *ts, **kw)
    ref = pose_lm.pose_only_plain(cam, *ts, **kw)
    again = pose_lm.pose_only_lm(cam, *ts, **kw)
    torch.cuda.synchronize()
    assert _same_bits(got, again)
    a = chip_smoke.pose_agreement(cam, ts, got, ref)
    assert a["pose"] <= 1e-4 and a["cost"] <= 1e-3 and a["flips"] == a["near"], a
    assert int(got.n_inliers) == int(got.inliers.sum())
    if N == 0:
        assert torch.equal(got.T_cw, ts[0]) and float(got.cost) == 0.0
    elif N > 100:
        assert int(got.n_inliers) > 0.4 * N


def test_pose_only_lm_refuses_what_it_does_not_take(cuda):
    cam_args, args, kw = chip_smoke.pose_problem(np.random.default_rng(7), 64, "tracking")
    cam = cam_mod.Pinhole.create(*cam_args)
    ts = [torch.as_tensor(a).to(cuda) for a in args]
    with pytest.raises(ValueError):                    # float64 points
        pose_lm.pose_only_lm(cam, ts[0], ts[1].double(), *ts[2:], **kw)
    with pytest.raises(ValueError):                    # a mask of the wrong length
        pose_lm.pose_only_lm(cam, *ts[:5], ts[5][:10], **kw)
    with pytest.raises(ValueError):                    # one tensor on the CPU
        pose_lm.pose_only_lm(cam, ts[0].cpu(), *ts[1:], **kw)
    res = pose_lm.pose_only_lm(cam, *ts, rounds=0, iters=10)
    assert torch.equal(res.T_cw, ts[0]) and torch.equal(res.inliers, ts[5])
    assert float(res.cost) == 0.0 and int(res.n_inliers) == int(ts[5].sum())


def _clusters(b, dev):
    t = lambda k: torch.as_tensor(b[k]).to(dev)
    c = balm.build_clusters(t("points"), t("valid"), t("T_build"), voxel_size=1.0,
                            max_voxels=256, min_points=15)
    return c._replace(valid=c.valid & ~t("kill"))


def _quad_agree(got, ref):
    """Largest differences: H and g over their largest entry, cost relative."""
    rel = lambda a, b: float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))
    return (rel(got.H, ref.H), rel(got.g, ref.g),
            abs(float(got.cost) - float(ref.cost)) / max(abs(float(ref.cost)), 1e-30))


@pytest.mark.parametrize("case", chip_smoke.BALM_CASES)
def test_balm_quadratic_matches_plain(cuda, case):
    """tests/test_torch_local_ba.py's cases: one launch, the plain
    version's H, g and cost; the same bits on a second call."""
    b = chip_smoke.balm_case(np.random.default_rng(4), case)
    c = _clusters(b, cuda)
    T = torch.as_tensor(b["T_eval"]).to(cuda)
    before = kbalm.launches
    got = balm.quadratic(c, T)
    ref = kbalm.quadratic_plain(c, T)
    again = kbalm.balm_quadratic(c, T)
    torch.cuda.synchronize()
    assert kbalm.launches - before == 2
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    if case == "all_invalid":
        assert not got.H.any() and not got.g.any() and float(got.cost) == 0.0
        return
    e = _quad_agree(got, ref)
    assert max(e) <= 1e-3, e


def test_balm_quadratic_full_width(cuda):
    """The main path's size: 512 voxel slots over a window of 6 keyframes."""
    pl, valid, T_wl, T_pert = chip_smoke.planar_window(np.random.default_rng(6), 6, 20000)
    t = lambda a: torch.as_tensor(a).to(cuda)
    c = balm.build_clusters(t(pl), t(valid), t(T_wl), voxel_size=0.5, max_voxels=512,
                            min_points=15)
    got = kbalm.balm_quadratic(c, t(T_pert))
    ref = kbalm.quadratic_plain(c, t(T_pert))
    torch.cuda.synchronize()
    assert int(c.valid.sum()) > 100
    e = _quad_agree(got, ref)
    assert max(e) <= 1e-3, e


@pytest.mark.parametrize("W,n_valid", [(6, 1), (16, None)])
def test_balm_quadratic_one_voxel_and_the_widest_window(cuda, W, n_valid):
    """One valid voxel of 512 slots; a window of 16 poses (``MAX_WINDOW``):
    the plain version's H, g and cost, the same bits twice, two device
    launches a call, no host sync."""
    pl, valid, T_wl, T_pert = chip_smoke.planar_window(np.random.default_rng(7), W, 3000)
    t = lambda a: torch.as_tensor(a).to(cuda)
    c = balm.build_clusters(t(pl), t(valid), t(T_wl), voxel_size=1.0, max_voxels=512,
                            min_points=15)
    if n_valid is not None:
        keep = torch.zeros_like(c.valid)
        keep[int(torch.nonzero(c.valid)[0])] = True
        c = c._replace(valid=keep)
    assert int(c.valid.sum()) == (n_valid or int(c.valid.sum())) and int(c.valid.sum()) > 0
    T = t(T_pert)
    got = kbalm.balm_quadratic(c, T)
    again = kbalm.balm_quadratic(c, T)
    ref = kbalm.quadratic_plain(c, T)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    e = _quad_agree(got, ref)
    assert max(e) <= 1e-3, e
    sites = _sync_sites(lambda: kbalm.balm_quadratic(c, T))
    assert not sites, sites
    split = chip_smoke.kernel_split(torch, lambda: kbalm.balm_quadratic(c, T), 10)
    assert {k: round(v["launches_a_call"]) for k, v in split.items()} == {
        "voxel_kernel": 1, "sum_kernel": 1}, split


def test_balm_quadratic_refuses_what_it_does_not_take(cuda):
    b = chip_smoke.balm_case(np.random.default_rng(4), "planar")
    c = _clusters(b, cuda)
    T = torch.as_tensor(b["T_eval"]).to(cuda)
    with pytest.raises(ValueError):                    # float64 poses
        kbalm.balm_quadratic(c, T.double())
    with pytest.raises(ValueError):                    # one tensor on the CPU
        kbalm.balm_quadratic(c._replace(N=c.N.cpu()), T)
    with pytest.raises(ValueError):                    # too many poses
        kbalm.balm_quadratic(c._replace(N=torch.zeros((c.N.shape[0], 17), device=cuda)),
                             torch.eye(4, device=cuda).expand(17, 4, 4))


@pytest.mark.parametrize("case", chip_smoke.BA_CASES)
def test_local_ba_lm_matches_plain(cuda, case):
    """tests/test_torch_local_ba.py's cases: ``launches_per_call(iters)``
    launches (and two of the BALM kernel with its term), the plain version's
    result."""
    p = chip_smoke.ba_problem(np.random.default_rng(3), case)
    args, kw = chip_smoke.ba_torch(torch, p, cuda)
    before = (klba.launches, kbalm.launches)
    got = lm.local_ba(*args, **kw)
    assert klba.launches - before[0] == klba.launches_per_call(p["iters"])
    assert kbalm.launches - before[1] == (2 if case == "balm" else 0)
    ref = klba.local_ba_plain(*args, **kw)   # (its extra_fn launches the BALM kernel)
    torch.cuda.synchronize()
    a = chip_smoke.ba_agreement(torch, got, ref)
    assert a["pose"] <= 1e-4 and a["landmark"] <= 1e-3 and a["cost"] <= 1e-4, a
    if case == "all_fixed":
        assert torch.equal(got.T_cw, args[1])
    if case == "no_valid_landmark":
        assert torch.equal(got.X_w, args[2])
    if case == "masked_nan":
        assert torch.equal(got.T_cw, args[1]) and bool(torch.isnan(got.cost))


@pytest.mark.parametrize("case", chip_smoke.BA_CASES)
def test_local_ba_lm_same_bits(cuda, case):
    """No atomics: a second call gives the same bits."""
    p = chip_smoke.ba_problem(np.random.default_rng(3), case)
    args, kw = chip_smoke.ba_torch(torch, p, cuda)
    got = klba.local_ba_lm(*args, **kw)
    again = klba.local_ba_lm(*args, **kw)
    torch.cuda.synchronize()
    assert _same_bits(got, again)


def test_local_ba_lm_balm_cluster_draws(cuda):
    """Six BALM windows (``ba_problem`` drawn from seeds 3 to 8), their
    clusters built on the card (the float32 plain version can land
    centimetres from its float64 run on a window). On every window the
    kernel is within tolerance of the plain version or no farther from the
    float64 run (chip_smoke.ba_outside), and gives the same bits on a
    second call."""
    for seed in range(3, 9):
        p = chip_smoke.ba_problem(np.random.default_rng(seed), "balm")
        args, kw = chip_smoke.ba_torch(torch, p, cuda)
        got = klba.local_ba_lm(*args, **kw)
        again = klba.local_ba_lm(*args, **kw)
        ref = klba.local_ba_plain(*args, **kw)
        a64, kw64 = chip_smoke.ba_float64(torch, args, kw)
        ref64 = klba.local_ba_plain(*a64, **kw64)
        torch.cuda.synchronize()
        out = chip_smoke.ba_outside(torch, got, ref, ref64)
        assert not any(v["outside"] for v in out.values()), out
        assert _same_bits(got, again)


def _same_bits(got, again):
    """Tuples of tensors with the same bits (a NaN equal to the same NaN)."""
    bits = lambda x: x.view(torch.int32) if x.dtype == torch.float32 else x
    return all(torch.equal(bits(a), bits(b)) for a, b in zip(got, again))


def _full_width(cuda, P, Pn, K=8, L=8192):
    """``chip_smoke.dist_problem``'s window of ``Pn`` real poses (the first
    fixed) padded to ``P`` with fixed identity poses, at full width."""
    cam, p = chip_smoke.dist_problem(torch, np.random.default_rng(1), Pn=Pn, L=L, K=K)
    if P > Pn:
        pad = P - Pn
        p["T0"] = np.concatenate([p["T0"], np.tile(np.eye(4, dtype=np.float32), (pad, 1, 1))])
        p["fixed"] = np.concatenate([p["fixed"], np.ones(pad, bool)])
    t = lambda k: torch.as_tensor(p[k]).to(cuda)
    obs = lm.BAObservations(*(t(k) for k in ("pose_idx", "uv", "inv_sigma2", "stereo", "valid")))
    return (cam, t("T0"), t("X0"), obs, t("fixed"), torch.ones(L, dtype=torch.bool, device=cuda))


@pytest.mark.parametrize("P,Pn", [(64, 8), (9, 9), (12, 12), (64, 40)])
def test_local_ba_lm_same_bits_full_width(cuda, P, Pn):
    """The global BA's 64 poses with pads; free rows 48 (block 0 alone), 66
    and 234 (the cluster's elimination): the same bits on a second call."""
    args = _full_width(cuda, P, Pn)
    got = klba.local_ba_lm(*args, iters=4)
    again = klba.local_ba_lm(*args, iters=4)
    torch.cuda.synchronize()
    assert _same_bits(got, again)


def test_local_ba_lm_refuses_a_window_too_large(cuda):
    """80 poses need more shared memory than a block has for the solve: the
    launch is refused and raises (no fallback)."""
    args = _full_width(cuda, 80, 8, L=256)
    with pytest.raises(RuntimeError, match="local_ba_lm launch failed"):
        klba.local_ba_lm(*args, iters=1)


@pytest.mark.parametrize("P,K", [(6, 8), (8, 8), (64, 8)])
def test_local_ba_lm_full_width(cuda, P, K):
    """The main path's shapes: 8192 landmarks, 8 views, a window of 6 or 8
    poses, and the global BA's 64 (8 real, 56 padded and fixed)."""
    args = _full_width(cuda, P, min(P, 8), K=K)
    got = klba.local_ba_lm(*args, iters=6)
    ref = klba.local_ba_plain(*args, iters=6)
    torch.cuda.synchronize()
    a = chip_smoke.ba_agreement(torch, got, ref)
    assert a["pose"] <= 1e-4 and a["landmark"] <= 1e-3 and a["cost"] <= 1e-4, a


@pytest.mark.parametrize("P,Pn", [(12, 12), (64, 40)])
def test_local_ba_lm_cluster_solve(cuda, P, Pn):
    """66 and 234 free rows, solved by the cluster: the plain version's
    result, or else no farther from its float64 run (chip_smoke.ba_outside:
    a window float32 cannot resolve to the tolerance)."""
    args = _full_width(cuda, P, Pn)
    got = klba.local_ba_lm(*args, iters=6)
    ref = klba.local_ba_plain(*args, iters=6)
    a64, kw64 = chip_smoke.ba_float64(torch, args, {"iters": 6})
    ref64 = klba.local_ba_plain(*a64, **kw64)
    torch.cuda.synchronize()
    out = chip_smoke.ba_outside(torch, got, ref, ref64)
    assert not any(v["outside"] for v in out.values()), out


def test_local_ba_lm_refuses_what_it_does_not_take(cuda):
    p = chip_smoke.ba_problem(np.random.default_rng(3), "visual")
    (cam, T0, X0, obs, fixed, vlm), kw = chip_smoke.ba_torch(torch, p, cuda)
    with pytest.raises(ValueError):                    # float64 landmarks
        klba.local_ba_lm(cam, T0, X0.double(), obs, fixed, vlm, **kw)
    with pytest.raises(ValueError):                    # a mask of the wrong length
        klba.local_ba_lm(cam, T0, X0, obs, fixed, vlm[:10], **kw)
    with pytest.raises(ValueError):                    # one tensor on the CPU
        klba.local_ba_lm(cam, T0, X0, obs, fixed.cpu(), vlm, **kw)
    res = klba.local_ba_lm(cam, T0, X0, obs, fixed, vlm, iters=0)
    assert torch.equal(res.T_cw, T0) and torch.equal(res.X_w, X0)


def test_build_clusters_and_voxel_downsample_same_bits(cuda):
    """The cluster sums and the scan centroids add in a fixed order on the
    card (``tensors.sum_rows``): a second call gives the same bits."""
    from tc2li_slam_torch.ops import pointcloud
    b = chip_smoke.balm_case(np.random.default_rng(4), "planar")
    c1, c2 = _clusters(b, cuda), _clusters(b, cuda)
    torch.cuda.synchronize()
    assert _same_bits(c1, c2)
    rng = np.random.default_rng(5)
    pts = torch.as_tensor(rng.normal(0, 20, (32768, 3)).astype(np.float32)).to(cuda)
    valid = torch.as_tensor(rng.uniform(size=32768) < 0.9).to(cuda)
    d1 = pointcloud.voxel_downsample(pts, valid, 0.5)
    d2 = pointcloud.voxel_downsample(pts, valid, 0.5)
    torch.cuda.synchronize()
    assert _same_bits(d1, d2) and int(d1[1].sum()) > 1000


ORB_SHAPES = [(376, 1241), (720, 1280), (1080, 1920), (64, 64), (101, 203)]


def _orb_images(shape, n):
    return torch.stack([_image(10 + i, shape, smooth=i == 0) for i in range(n)])


def _orb_regions(shapes, pad):
    return [(p, slice(0, h + 2 * pad), slice(0, w + 2 * pad)) for p, (h, w) in enumerate(shapes)]


@pytest.mark.parametrize("shape", ORB_SHAPES)
@pytest.mark.parametrize("n_images", [1, 2])
def test_orb_level_planes_matches_plain(cuda, shape, n_images):
    """Every plane's padded region bit-equal to the plain version's; the
    same bits on a second call; one launch."""
    imgs = _orb_images(shape, n_images).to(cuda)
    before = korb.level_launches
    st, bl, shapes, pad = orb.level_stacks(list(imgs), 8, 1.2)
    st2, bl2, _ = korb.orb_level_planes(imgs, 8, 1.2)
    ref_st, ref_bl, ref_shapes = korb.level_planes_plain(imgs, 8, 1.2)
    torch.cuda.synchronize()
    assert korb.level_launches - before == 2 and shapes == ref_shapes
    for p, ys, xs in _orb_regions(shapes, pad):
        for got, again, ref in ((st, st2, ref_st), (bl, bl2, ref_bl)):
            assert torch.equal(got[p, ys, xs], ref[p, ys, xs]), p
            assert torch.equal(got[p, ys, xs], again[p, ys, xs]), p


def _orb_scores(cuda, shape, n_images):
    imgs = _orb_images(shape, n_images).to(cuda)
    st, bl, shapes, pad = orb.level_stacks(list(imgs), 8, 1.2)
    return st, bl, shapes, pad, fast.detect_planes(st, shapes, pad)


@pytest.mark.parametrize("shape", ORB_SHAPES)
@pytest.mark.parametrize("n_images", [1, 2])
def test_orb_select_grid_matches_plain(cuda, shape, n_images):
    """The grid top-k of every plane equal to the plain version's, also on
    tie-heavy scores; the same bits on a second call; two launches a call
    (the cell pass, then the selection). At 1280x720 and 1920x1080 level 0
    holds 7,200 and 16,320 candidates."""
    _, _, shapes, _, scores = _orb_scores(cuda, shape, n_images)
    per = orb.features_per_level(2000 if shape[0] > 300 else 500, 8, 1.2)
    ties = torch.round(scores / 16)
    for s in (scores, ties):
        before = korb.select_launches
        got = orb.select_grid(s, shapes, per, 1.2)
        again = korb.orb_select_grid(s, shapes, per, 1.2)
        ref = korb.select_grid_plain(s, shapes, per, 1.2)
        torch.cuda.synchronize()
        assert korb.select_launches - before == 4
        assert _same_bits(got, ref) and _same_bits(got, again)
        assert int((got[2] > 0).sum()) > 0


@pytest.mark.parametrize("shape", ORB_SHAPES)
@pytest.mark.parametrize("n_images", [1, 2])
def test_orb_describe_matches_plain(cuda, shape, n_images):
    """Angles bit-equal to the plain version's, and the descriptors of every
    keypoint whose angle is; the same bits on a second call; one launch."""
    st, bl, shapes, pad, scores = _orb_scores(cuda, shape, n_images)
    per = orb.features_per_level(2000 if shape[0] > 300 else 500, 8, 1.2)
    rows, cols, sel, level, _ = orb.select_grid(scores, shapes, per, 1.2)
    before = korb.describe_launches
    ang, desc = orb.describe(st, bl, rows, cols, level, 8, pad)
    ang2, desc2 = korb.orb_describe(st, bl, rows, cols, level, 8, pad)
    ref_ang, ref_desc = korb.describe_plain(st, bl, rows, cols, level, 8, pad)
    torch.cuda.synchronize()
    assert korb.describe_launches - before == 2
    assert _same_bits((ang, desc), (ang2, desc2))
    assert torch.equal(ang.view(torch.int32), ref_ang.view(torch.int32))
    assert torch.equal(desc, ref_desc)


@pytest.mark.parametrize("shape", [(376, 1241), (64, 64), (101, 203)])
@pytest.mark.parametrize("n_images", [1, 2])
def test_orb_describe_odd_keypoint_counts(cuda, shape, n_images):
    """``orb_describe`` walks two keypoints a warp: with an odd count a
    warp (one image) holds one keypoint, and with two images a warp holds
    the last of one image and the first of the next (another plane); bit-
    equal to the plain version, the same bits twice, one launch a call."""
    st, bl, shapes, pad, scores = _orb_scores(cuda, shape, n_images)
    per = orb.features_per_level(2000 if shape[0] > 300 else 500, 8, 1.2)
    rows, cols, sel, level, _ = orb.select_grid(scores, shapes, per, 1.2)
    K = rows.shape[1] - (rows.shape[1] % 2 == 0)
    rows, cols, level = (x[:, :K].contiguous() for x in (rows, cols, level))
    before = korb.describe_launches
    got = korb.orb_describe(st, bl, rows, cols, level, 8, pad)
    again = korb.orb_describe(st, bl, rows, cols, level, 8, pad)
    ref_ang, ref_desc = korb.describe_plain(st, bl, rows, cols, level, 8, pad)
    torch.cuda.synchronize()
    assert K % 2 == 1 and korb.describe_launches - before == 2
    assert _same_bits(got, again)
    assert torch.equal(got[0].view(torch.int32), ref_ang.view(torch.int32))
    assert torch.equal(got[1], ref_desc)


def test_system_tracks_a_1280x720_pair_on_cuda(cuda):
    """A 1280x720 stereo camera at the default 2,000 features: level 0 holds
    7,200 grid candidates. Four frames are built and tracked on the card,
    two grid top-k launches a frame, and frame 0's grid top-k equal to its
    plain version."""
    import dataclasses
    from tc2li_slam_torch.io import synthetic as syn
    from tc2li_slam_torch.slam import config as tcfg, system as tsys
    rig = syn.CameraRig(fx=720.0, fy=720.0, cx=640.0, cy=360.0, baseline=0.537, width=1280,
                        height=720)
    frames, _, _ = syn.generate_sequence(
        n_frames=4, cam=rig, seed=0, n_scan=1 << 15,
        world=syn.make_world(np.random.default_rng(0), n_surf=300_000),
        traj=syn.Trajectory(w_body=(0, 0, 0.03), v_world=(1.5, 0.1, 0.0)))
    cfg = chip_smoke.kitti_config(tcfg, syn, cam=rig)
    imgs = torch.stack([torch.as_tensor(np.clip(x, 0, 255).astype(np.float32)).to(cuda)
                        for x in (frames[0].img_l, frames[0].img_r)])
    st, _, shapes, pad = orb.level_stacks(list(imgs), 8, 1.2)
    scores = fast.detect_planes(st, shapes, pad)
    per = orb.features_per_level(2000, 8, 1.2)
    assert _same_bits(korb.orb_select_grid(scores, shapes, per, 1.2),
                      korb.select_grid_plain(scores, shapes, per, 1.2))
    s = tsys.System(cfg, cuda)
    before = korb.select_launches
    for fr in frames:
        s.track(fr.img_l, fr.img_r, fr.t, fr.scan, fr.scan_valid)
        assert s.state == tsys.TrackingState.OK
    assert korb.select_launches - before == 2 * len(frames)
    est = s.trajectory_world_from_cam()
    gt = np.stack([fr.T_wb_gt @ syn.body_from_cam() for fr in frames])
    assert np.all(np.isfinite(est)) and syn.ate_rmse(est, gt) < 0.15


def test_orb_kernels_refuse_what_they_do_not_take(cuda):
    imgs = _orb_images((64, 64), 2).to(cuda)
    with pytest.raises(ValueError):                     # float64 images
        korb.orb_level_planes(imgs.double(), 8, 1.2)
    with pytest.raises(ValueError):                     # CPU images
        korb.orb_level_planes(imgs.cpu(), 8, 1.2)
    with pytest.raises(ValueError):                     # 40 planes
        korb.orb_level_planes(torch.zeros((5, 64, 64), device=cuda), 8, 1.2)
    with pytest.raises(ValueError):                     # a tile reading too many columns
        korb.orb_level_planes(torch.zeros((1, 64, 4000), device=cuda), 2, 6.0)
    st, bl, shapes, pad, scores = _orb_scores(cuda, (64, 64), 2)
    per = orb.features_per_level(500, 8, 1.2)
    with pytest.raises(ValueError):                     # shapes of another plane count
        korb.orb_select_grid(scores, shapes[:-1], per, 1.2)
    with pytest.raises(ValueError):                     # more candidates a cell than pixels
        korb.orb_select_grid(scores[:1], shapes[:1], [5000], 1.2)
    rows, cols, sel, level, _ = korb.orb_select_grid(scores, shapes, per, 1.2)
    with pytest.raises(ValueError):                     # int64 rows
        korb.orb_describe(st, bl, rows.long(), cols, level, 8, pad)
    with pytest.raises(ValueError):                     # a pad short of the pattern
        korb.orb_describe(st, bl, rows, cols, level, 8, 10)


# --- the stereo half of the frame build (csrc/stereo.cu) -----------------------

STEREO_BF = float(np.float32(718.856) * np.float32(0.537))
STEREO_BASE = float(np.float32(0.537))
_STEREO_PAIRS = {}


def _stereo_inputs(cuda, case, size=None):
    from tc2li_slam_torch.io import synthetic as syn
    if size not in _STEREO_PAIRS:
        _STEREO_PAIRS[size] = chip_smoke.stereo_pair(torch, syn, orb, cuda, size)
    il, ir, kl, kr = chip_smoke.stereo_case(np.random.default_rng(1), case, *_STEREO_PAIRS[size])
    up = lambda x: torch.as_tensor(x).to(cuda)
    kp = lambda d: chip_smoke.stereo_keypoints(torch, orb, d, cuda)
    sf = up((1.2 ** np.arange(8)).astype(np.float32))
    return up(il), up(ir), kp(kl), kp(kr), sf


def _stereo_check(cuda, il, ir, kl, kr, sf):
    """The kernel bit-equal to its plain version, the same bits on a second
    call, and this module's launches."""
    from tc2li_slam_torch.ops.kernels import stereo as kst
    args = (il, ir, kl, kr, sf, STEREO_BF, STEREO_BASE)
    before = kst.launches
    got = kst.stereo_refine(*args)
    again = kst.stereo_refine(*args)
    ref = kst.stereo_refine_plain(*args)
    torch.cuda.synchronize()
    N, M = kl.xy.shape[0], kr.xy.shape[0]
    assert kst.launches - before == 2 * kst.launches_per_call(N, M)
    assert _same_bits(got, ref), [f for f, a, b in zip(got._fields, got, ref) if not torch.equal(a, b)]
    assert _same_bits(got, again)
    return got


@pytest.mark.parametrize("case", chip_smoke.STEREO_CASES)
def test_stereo_refine_matches_plain(cuda, case):
    got = _stereo_check(cuda, *_stereo_inputs(cuda, case))
    N = got.ok.shape[0]
    assert 0 < int(got.ok.sum()) < N


def test_stereo_refine_1280x720(cuda):
    got = _stereo_check(cuda, *_stereo_inputs(cuda, "frame", (720, 1280)))
    assert int(got.ok.sum()) > 300


def test_stereo_refine_float_images(cuda):
    il, ir, kl, kr, sf = _stereo_inputs(cuda, "frame")
    _stereo_check(cuda, il.float(), ir.float(), kl, kr, sf)


@pytest.mark.parametrize("N", [0, 1, 2000])
def test_stereo_refine_sizes(cuda, N):
    """No keypoint, one, and 2000 (more than the gate block's 1024 threads)."""
    il, ir, kl, kr, sf = _stereo_inputs(cuda, "frame")
    kl = kl._replace(**{f: getattr(kl, f)[:N] for f in kl._fields})
    got = _stereo_check(cuda, il, ir, kl, kr, sf)
    assert got.uvr.shape == (N, 3)


def _sync_sites(fn):
    """The lines of the stack (innermost last) at each host sync ``fn()`` makes."""
    import traceback
    import warnings
    sites = []
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        shown = warnings.showwarning

        def record(message, *a, **kw):
            if chip_smoke.is_sync_warning(message):
                sites.append([f"{f.filename}:{f.lineno} {f.line}"
                              for f in traceback.extract_stack()[-8:-1]])
            else:
                shown(message, *a, **kw)
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
            warnings.showwarning = shown
    torch.cuda.synchronize()
    return sites


def test_stereo_refine_no_host_sync(cuda):
    from tc2li_slam_torch.ops.kernels import stereo as kst
    il, ir, kl, kr, sf = _stereo_inputs(cuda, "frame")
    kst.stereo_refine(il, ir, kl, kr, sf, STEREO_BF, STEREO_BASE)
    torch.cuda.synchronize()
    sites = _sync_sites(lambda: kst.stereo_refine(il, ir, kl, kr, sf, STEREO_BF, STEREO_BASE))
    assert not sites, sites


def test_stereo_refine_refuses_what_it_does_not_take(cuda):
    from tc2li_slam_torch.ops.kernels import stereo as kst
    il, ir, kl, kr, sf = _stereo_inputs(cuda, "frame")
    with pytest.raises(ValueError):                     # a CPU image
        kst.stereo_refine(il.cpu(), ir, kl, kr, sf, STEREO_BF, STEREO_BASE)
    with pytest.raises(ValueError):                     # int64 levels
        kst.stereo_refine(il, ir, kl._replace(level=kl.level.long()), kr, sf, STEREO_BF,
                          STEREO_BASE)
    with pytest.raises(ValueError):                     # images of two shapes
        kst.stereo_refine(il, ir[:, :-1], kl, kr, sf, STEREO_BF, STEREO_BASE)


# --- the BALM voxel clusters (csrc/clusters.cu) --------------------------------

def _cluster_inputs(cuda, case, W=6, M=2048):
    up = lambda x: torch.as_tensor(x).to(cuda)
    if case in chip_smoke.BALM_CASES:
        b = chip_smoke.balm_case(np.random.default_rng(4), case)
        return up(b["points"]), up(b["valid"]), up(b["T_build"]), 256
    pl, valid, T_wl = chip_smoke.cluster_case(np.random.default_rng(3), case, W, M)
    return up(pl), up(valid), up(T_wl), 512


def _cluster_check(cuda, pts, valid, T, V):
    """The kernel against the plain version, the same bits twice, one launch
    of its own a call (and none else than the three tensor ops'), no host
    sync."""
    from tc2li_slam_torch.ops.kernels import clusters as kcl
    kw = dict(voxel_size=1.0, max_voxels=V, min_points=15)
    before = kcl.launches
    got = kcl.balm_clusters(pts, valid, T, **kw)
    again = kcl.balm_clusters(pts, valid, T, **kw)
    ref = balm.build_clusters_plain(pts, valid, T, **kw)
    torch.cuda.synchronize()
    assert kcl.launches - before == 2
    agree, how = chip_smoke.clusters_agree(torch, got, ref, T)
    assert agree, how
    assert _same_bits(got, again)
    sites = _sync_sites(lambda: kcl.balm_clusters(pts, valid, T, **kw))
    assert not sites, sites
    # one launch a call, each run to its end: the wrapper's count of launches
    # enqueued and the kernel's own count of launches that ran, on the device
    # (torch.profiler's record can miss a launch of this cluster kernel)
    runs, n0 = kcl.device_runs(), kcl.launches
    fn, calls = chip_smoke.counted(lambda: kcl.balm_clusters(pts, valid, T, **kw))
    split = chip_smoke.kernel_split(torch, fn, 10)
    assert kcl.launches - n0 == calls[0] and kcl.device_runs() - runs == calls[0], split
    return got


@pytest.mark.parametrize("case", chip_smoke.CLUSTER_CASES + chip_smoke.BALM_CASES)
def test_balm_clusters_matches_plain(cuda, case):
    got = _cluster_check(cuda, *_cluster_inputs(cuda, case))
    if case == "no_valid_point":
        assert not got.valid.any() and not got.N.any()
    elif case != "overflow":
        assert int(got.valid.sum()) > 20


@pytest.mark.parametrize("W,M,V", [(1, 1, 1), (1, 2048, 1), (2, 300, 8), (6, 20000, 512),
                                   (12, 4096, 64), (6, 2048, 4096), (3, 40000, 2),
                                   (6, 40000, 512)])
def test_balm_clusters_sizes(cuda, W, M, V):
    """W 1 with one slot; six planar keyframes of 20,000 points (the main
    path's width at a dense cloud); 240,000 points, past the 232,000 whose
    sort keys and indices (16 bytes a point) 16 SMs' shared memory would
    hold (the kernel keeps them in device memory at every size); more slots
    than voxels; two slots."""
    pts, valid, T, _ = _cluster_inputs(cuda, "full_width", W, M)
    _cluster_check(cuda, pts, valid, T, V)


def test_balm_scratch_sizes_match_the_sources(cuda):
    """The wrappers size the kernels' scratch in Python; the sources' own
    layouts agree."""
    from tc2li_slam_torch.ops.kernels import build, clusters as kcl
    lib = build.library()
    for P, V, W in ((1, 1, 1), (12288, 512, 6), (240000, 512, 6), (8192, 4096, 12)):
        assert kcl.scratch_bytes(P, V, W) == lib.tc2li_clusters_scratch(P, V, W)
    for V, W in ((1, 1), (512, 6), (256, 16), (7, 3)):
        assert kbalm.scratch_floats(V, W) == lib.tc2li_balm_scratch(V, W)


def test_balm_clusters_no_host_sync(cuda):
    from tc2li_slam_torch.ops.kernels import clusters as kcl
    pts, valid, T, V = _cluster_inputs(cuda, "full_width")
    kcl.balm_clusters(pts, valid, T, max_voxels=V)
    torch.cuda.synchronize()
    for fn in (kcl.balm_clusters, balm.build_clusters):
        sites = _sync_sites(lambda: fn(pts, valid, T, max_voxels=V))
        assert not sites, sites


def test_balm_clusters_refuses_what_it_does_not_take(cuda):
    from tc2li_slam_torch.ops.kernels import clusters as kcl
    pts, valid, T, V = _cluster_inputs(cuda, "full_width")
    with pytest.raises(ValueError):                     # CPU flags
        kcl.balm_clusters(pts, valid.cpu(), T)
    with pytest.raises(ValueError):                     # float64 points
        kcl.balm_clusters(pts.double(), valid, T)
    with pytest.raises(ValueError):                     # no slot
        kcl.balm_clusters(pts, valid, T, max_voxels=0)


# --- the IMU mode's refinement: imu_preintegrate and pose_inertial_lm ---

def _vi_results_bits(r):
    return [r.state.T_wb, r.state.vel, r.state.bg, r.state.ba, r.prior.H, r.cost, r.inliers,
            r.n_inliers]


@pytest.mark.parametrize("nf", [15, 30])
@pytest.mark.parametrize("O,case", [(3, "full"), (60, "full"), (2000, "full"),
                                    (2000, "nothing_valid"), (2000, "masked_nan"),
                                    (2000, "prior_off"), (2000, "padded_imu")])
def test_pose_inertial_lm_matches_plain(cuda, nf, O, case):
    p = chip_smoke.vi_problem(np.random.default_rng(O), O, nf, case)
    name, args = chip_smoke.vi_args(torch, p, cuda)
    before = kpi.launches
    got = getattr(tpi, name)(*args)          # CUDA tensors -> the kernel
    again = getattr(tpi, name)(*args)
    assert kpi.launches - before == 2
    ref = getattr(kpi, name + "_plain")(*args)
    ref64 = getattr(kpi, name + "_plain")(*chip_smoke._vi_cast(torch, args, torch.float64))
    torch.cuda.synchronize()
    agr = chip_smoke.vi_agreement(torch, args, got, ref, ref64)
    assert not agr["outside"] and agr["flips"] == agr["near"], agr
    assert chip_smoke.bit_equal(torch, _vi_results_bits(got), _vi_results_bits(again))
    assert got.n_inliers.dtype == torch.int32 and got.n_inliers.device.type == "cuda"
    if case == "masked_nan":
        assert torch.isnan(got.cost) and torch.equal(got.state.T_wb, args[2].T_wb)
    if case == "nothing_valid":
        assert int(got.n_inliers) == 0 and not bool(got.inliers.any())


@pytest.mark.parametrize("nf", [15, 30])
def test_pose_inertial_lm_one_launch_a_call(cuda, nf):
    """One launch a call by the wrapper's count, and no other kernel in a
    profile of the calls (the profile's record can miss a cluster launch, so
    it counts none)."""
    p = chip_smoke.vi_problem(np.random.default_rng(5), 2000, nf)
    name, args = chip_smoke.vi_args(torch, p, cuda)
    n0 = kpi.launches
    fn, calls = chip_smoke.counted(lambda: getattr(tpi, name)(*args))
    split = chip_smoke.kernel_split(torch, fn, 10)
    assert kpi.launches - n0 == calls[0]
    assert set(split) <= {"pose_inertial_kernel"}, split


def test_pose_inertial_lm_no_host_sync(cuda):
    for nf in (15, 30):
        p = chip_smoke.vi_problem(np.random.default_rng(4), 2000, nf)
        name, args = chip_smoke.vi_args(torch, p, cuda)
        getattr(tpi, name)(*args)
        torch.cuda.synchronize()
        sites = _sync_sites(lambda: getattr(tpi, name)(*args))
        assert not sites, sites


def test_pose_inertial_lm_refuses_what_it_does_not_take(cuda):
    p = chip_smoke.vi_problem(np.random.default_rng(4), 60, 30)
    _, args = chip_smoke.vi_args(torch, p, cuda)
    lm_args = (*args[:4], args[4], *args[5:])
    with pytest.raises(ValueError, match="float32"):
        kpi.pose_inertial_lm(*chip_smoke._vi_cast(torch, lm_args, torch.float64))
    with pytest.raises(ValueError, match="CUDA"):
        kpi.pose_inertial_lm(*lm_args[:6], lm_args[6].cpu(), *lm_args[7:])


def _imu_window(cuda, N, seed=0):
    rng = np.random.default_rng(seed)
    up = lambda a: torch.as_tensor(np.asarray(a, np.float32)).to(cuda)
    return (timu.ImuCalib.create(*chip_smoke.VI_CALIB, device=cuda),
            up(rng.normal(0, 0.2, (N, 3))), up(rng.normal(0, 1, (N, 3)) + [0.0, 0.0, 9.81]),
            up(np.where(np.arange(N) % 7 == 3, 0.0, 0.01)), up([1e-3, -2e-3, 5e-4]),
            up([0.02, -0.01, 0.03]))


@pytest.mark.parametrize("N", [0, 1, 9, 10, 60, 513, 1000, 1024])
def test_imu_preintegrate_matches_plain(cuda, N):
    """Sizes across the kernel's layout (every seventh slot padding): one
    chunk; 8 live samples and 1 (two chunks); 4e's window length; 513 slots
    (440 live, 55 chunks of 8 over 7 blocks); 1000 and 1024 (8 blocks)."""
    a = _imu_window(cuda, N)
    before = kimu.launches
    got, again = timu.integrate(*a), timu.integrate(*a)   # CUDA tensors -> the kernel
    assert kimu.launches - before == 2
    ref = kimu.integrate_plain(*a)
    ref64 = kimu.integrate_plain(a[0], *(x.double() for x in a[1:]))
    torch.cuda.synchronize()
    for f in timu.Preintegrated._fields[:10]:
        g, r, r64 = (getattr(x, f) for x in (got, ref, ref64))
        dk = chip_smoke.imu_distance(torch, f, g, r64)
        dp = chip_smoke.imu_distance(torch, f, r, r64)
        assert dk <= max(1e-4, 4.0 * dp), (f, dk, dp)
    assert chip_smoke.bit_equal(torch, got[:10], again[:10])


@pytest.mark.parametrize("N,spread", [(40, False), (1024, True)])
def test_imu_preintegrate_padding_is_a_no_op(cuda, N, spread):
    """Padded slots leave the map's bits as they are: a 40-slot window
    against its live samples alone; and those samples spread over a 1024-slot
    window of padding (a launch of 8 blocks against one of 1)."""
    a = _imu_window(cuda, 40)
    live = a[3] > 0
    if spread:
        at = torch.as_tensor(np.sort(np.random.default_rng(2).choice(N, 40, replace=False)))
        a = (a[0], *(torch.zeros((N,) + x.shape[1:], device=cuda).index_copy_(0, at.to(cuda), x)
                     for x in a[1:4]), a[4], a[5])
    got = timu.integrate(*a)
    alone = timu.integrate(a[0], a[1][a[3] > 0], a[2][a[3] > 0], a[3][a[3] > 0], a[4], a[5])
    torch.cuda.synchronize()
    assert int((a[3] > 0).sum()) == int(live.sum())
    for f in ("dR", "dV", "dP", "JRg", "JVg", "JVa", "JPg", "JPa"):
        assert torch.equal(getattr(got, f), getattr(alone, f)), f
    assert torch.equal(got.C[:9, :9], alone.C[:9, :9])


@pytest.mark.parametrize("N", [1, 60, 1024])
def test_imu_preintegrate_all_padding_is_the_identity(cuda, N):
    a = _imu_window(cuda, N)
    a = (*a[:3], torch.zeros_like(a[3]), *a[4:])
    got, again = timu.integrate(*a), timu.integrate(*a)
    torch.cuda.synchronize()
    assert torch.equal(got.dR, torch.eye(3, device=cuda)) and float(got.dt) == 0.0
    assert not any(bool(getattr(got, f).any())
                   for f in ("dV", "dP", "JRg", "JVg", "JVa", "JPg", "JPa", "C"))
    assert chip_smoke.bit_equal(torch, got[:10], again[:10])


@pytest.mark.parametrize("N", [60, 1024])
def test_imu_preintegrate_one_launch_a_call(cuda, N):
    """As test_pose_inertial_lm_one_launch_a_call."""
    a = _imu_window(cuda, N)
    n0 = kimu.launches
    fn, calls = chip_smoke.counted(lambda: timu.integrate(*a))
    split = chip_smoke.kernel_split(torch, fn, 10)
    assert kimu.launches - n0 == calls[0]
    assert set(split) <= {"imu_preint_kernel"}, split


def test_imu_preintegrate_no_host_sync(cuda):
    a = _imu_window(cuda, 100)
    timu.integrate(*a)
    torch.cuda.synchronize()
    sites = _sync_sites(lambda: timu.integrate(*a))
    assert not sites, sites


def test_imu_preintegrate_refuses_what_it_does_not_take(cuda):
    a = _imu_window(cuda, 10)
    with pytest.raises(ValueError, match="float32"):
        kimu.imu_preintegrate(a[0], a[1].double(), *a[2:])
    with pytest.raises(ValueError, match="CUDA"):
        kimu.imu_preintegrate(a[0], a[1], a[2].cpu(), *a[3:])



# --- the LiDAR-inertial scan step (ops/kernels/lio.py) ---------------------------

def _lio_case(cuda, case):
    """chip_smoke.lio_problem's scan step, and its variants of phase 5."""
    a = chip_smoke.lio_problem(torch, cuda)
    if case == "work_cap":
        return a[:10] + (a[10]._replace(work_cap=1 << 15),)
    if case == "extrinsic":
        return a[:10] + (a[10]._replace(estimate_extrinsic=True),)
    if case == "empty_map":
        m = a[1].replace(keys=torch.full_like(a[1].keys, torch.iinfo(torch.int32).max),
                         count=torch.zeros_like(a[1].count))
        return a[:1] + (m,) + a[2:]
    if case == "bad_imu":
        acc = a[6].clone()
        acc[2] = float("nan")
        return a[:6] + (acc,) + a[7:]
    return a


@pytest.mark.parametrize("case", ["full", "work_cap", "extrinsic", "empty_map", "bad_imu"])
def test_lio_kernels_match_plain(cuda, case):
    """``chip_smoke.lio_phase``: each of the four kernels against its plain
    version (``chip_smoke.LIO_TOL``; the step against the plain step run in
    float64 on its own sums), the whole update against ``scan_update_plain``,
    the same bits on a second call, no host sync in a scan step."""
    rows = chip_smoke.lio_phase(torch, cuda, [(case, _lio_case(cuda, case))])
    assert set(rows) == {"esekf_predict", "lio_fences", "lio_rows", "esekf_step"}


@pytest.mark.parametrize("case", ["M 8192", "M 32768", "M 0", "M 1", "M 1000", "near-full pool",
                                  "12 columns", "full 2^19 pool", "pool above 2^19"])
def test_lio_rows_cases(cuda, case):
    """``lio_rows`` (with its fence table) on ``chip_smoke.lio_problem``'s scan
    at the prediction: the same bits on a second call, the fence table equal
    to ``fences_plain``, the neighbour sets 99.9% equal to ``rows_plain``'s,
    the inliers within 3 of the float64 plain version's and N within 1e-4
    of it after diagonal scaling (or no farther than the float32 plain
    version). M 0, 1 and 1000 take the first points; the near-full pool has
    11,850 slots (not a multiple of the fence stride) for ~11,800 points.
    The full pools fill every slot with a block of voxels 20-60 m below the
    scan, whose keys interleave with the scan's: 2^19 slots (the largest
    fence table, 64 KB of shared memory a block) and 2^19 + 1,000 (a fence
    every 64 keys, the capacity no multiple of it)."""
    from tc2li_slam_torch.ops import voxel_map
    from tc2li_slam_torch.ops.kernels import lio as klio
    from tc2li_slam_torch.slam import lio
    cap = {"near-full pool": 11_850, "pool above 2^19": (1 << 19) + 1000}.get(case, 1 << 19)
    filt0, m, scan, t_pts, sv, gyro, acc, dts, trel, noise, cfg = chip_smoke.lio_problem(
        torch, cuda, cap=cap)
    if case in ("full 2^19 pool", "pool above 2^19"):
        q = voxel_map.voxel_indices(m, filt0.x.pos[None])[0]
        g, gz = torch.arange(-41, 41, device=cuda), torch.arange(-120, -40, device=cuda)
        ii = torch.stack(torch.meshgrid(g, g, gz, indexing="ij"), -1).reshape(-1, 3)
        fill = m.origin + (q + ii + 0.5).float() * m.voxel_size
        m = voxel_map.insert(m, fill, torch.ones(fill.shape[0], dtype=torch.bool, device=cuda))
        assert int(m.count) == cap
    cfg = cfg._replace(work_cap=1 << 15 if case == "M 32768" else cfg.work_cap,
                       estimate_extrinsic=case == "12 columns")
    fk, Rk, pk = klio.esekf_predict(filt0, gyro, acc, dts, noise)
    pts, pv = lio.scan_points(fk, scan, t_pts, sv, trel, Rk, pk, cfg)
    n = {"M 0": 0, "M 1": 1, "M 1000": 1000}.get(case)
    if n is not None:
        pts, pv = pts[:n].contiguous(), pv[:n].contiguous()
    M = pts.shape[0]
    outs = []
    for _ in range(2):
        fences = klio.predict_with_fences(filt0, gyro, acc, dts, noise, m.keys)[3]
        w = klio.LioWork(filt0, fk, m, pts, pv, cfg, fences)
        slots = torch.empty((M, 5), dtype=torch.int32, device=cuda)
        w.rows(0, slots)
        outs.append((w.partials.clone(), slots, w.fence_table.clone()))
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(*outs)), "not the same bits twice"
    assert torch.equal(outs[0][2], klio.fences_plain(m.keys, w.lg))
    if case == "near-full pool":
        assert int(m.count) > 0.99 * cap and cap % (1 << w.lg)
    if case in ("full 2^19 pool", "pool above 2^19"):
        assert w.lg == (5 if cap == 1 << 19 else 6)
        assert int(w.fence_table[-1]) == w.n_fences   # no fence reads kEmpty
    N, v, c = w.sums()
    if M == 0:   # (the plain version's knn takes no empty input)
        assert int(c) == 0 and not bool(N.any()) and not bool(v.any())
        return
    r32 = klio.rows_plain(m, pts, pv, fk.x, cfg, with_slots=True)
    r64 = klio.rows_plain(m.replace(points=m.points.double()), pts.double(), pv,
                          chip_smoke.lio_state64(torch, fk.x), cfg)
    live = (pv & torch.all(torch.isfinite(pts), -1)).cpu()
    same = torch.all(torch.sort(slots.long().cpu(), -1)[0] == torch.sort(r32.slots.cpu(), -1)[0], -1)
    assert M == 0 or float(same[live].double().mean()) >= chip_smoke.LIO_TOL["nbr_equal"]
    assert abs(int(c) - int(r64.n_ok)) <= chip_smoke.LIO_TOL["n_eff"]
    if int(r64.n_ok) == 0:
        assert int(c) == 0 and not bool(N.any()) and not bool(v.any())
        return
    sc = chip_smoke.diag_scale(torch, r64.N)
    d = float(((N - r64.N).abs().cpu() / sc).max())
    d32 = float(((r32.N.double() - r64.N).abs().cpu() / sc).max())
    assert d <= max(chip_smoke.LIO_TOL["rows"], d32), (d, d32)


@pytest.mark.parametrize("max_iters", [1, 3, 4])
def test_lio_scan_step_launches(cuda, max_iters):
    """A scan step runs esekf_predict and lio_fences once, lio_rows k + 2
    and esekf_step k + 1 times, counted by the wrappers; the fence table
    rides in the predict launch, so the step makes 1 + (k + 2) + (k + 1)
    launches on the device, the predict, evaluations and steps alone."""
    from tc2li_slam_torch.ops.kernels import lio as klio
    from tc2li_slam_torch.slam import lio
    a = _lio_case(cuda, "full")
    a = a[:10] + (a[10]._replace(max_iters=max_iters),)
    counts = lambda: (klio.predict_launches, klio.fence_launches, klio.rows_launches,
                      klio.step_launches)
    n0 = counts()
    res = lio.lio_scan_step(*a)
    torch.cuda.synchronize()
    n1 = counts()
    want = klio.launches_per_scan(max_iters)
    got = tuple(b - c for b, c in zip(n1, n0))
    assert got == (want["esekf_predict"], want["lio_fences"], want["lio_rows"],
                   want["esekf_step"])
    assert got[0] + got[2] + got[3] == klio.device_launches_per_scan(max_iters) \
        == 1 + (max_iters + 2) + (max_iters + 1)
    assert not bool(res.bad) and 0 < int(res.n_iters) <= max_iters


@pytest.mark.parametrize("pool", ["2^19", "2^19 + 1,000", "near-full", "empty", "full"])
def test_lio_predict_launch_writes_the_fence_table(cuda, pool):
    """The predict launch's fence blocks write ``fences_plain``'s table of
    the pool keys (a capacity off the stride, no key, every slot a key);
    the prediction's state, P, R_traj and p_traj are bit-equal with and
    without the fence blocks; one predict launch and one fence table a
    call."""
    from tc2li_slam_torch.ops.kernels import build, lio as klio
    cap = {"2^19 + 1,000": (1 << 19) + 1000, "near-full": 11_850}.get(pool, 1 << 19)
    filt0, m, _, _, _, gyro, acc, dts, _, noise, _ = chip_smoke.lio_problem(torch, cuda, cap=cap)
    EMPTY = torch.iinfo(torch.int32).max
    if pool == "empty":
        m = m.replace(keys=torch.full_like(m.keys, EMPTY), count=torch.zeros_like(m.count))
    if pool == "full":
        gen = torch.Generator().manual_seed(5)
        keys = torch.randint(0, 1 << 30, (cap,), generator=gen, dtype=torch.int32)
        m = m.replace(keys=torch.sort(keys)[0].to(cuda))
    n0 = (klio.predict_launches, klio.fence_launches)
    fa, Ra, pa, table = klio.predict_with_fences(filt0, gyro, acc, dts, noise, m.keys)
    f1, R1, p1 = klio.esekf_predict(filt0, gyro, acc, dts, noise)
    torch.cuda.synchronize()
    assert (klio.predict_launches - n0[0], klio.fence_launches - n0[1]) == (2, 1)
    want = klio.fences_plain(m.keys, build.library().tc2li_lio_fence_log2(cap))
    assert torch.equal(table, want)
    assert int(table[-1]) == {"empty": 0, "full": table.shape[0] - 1}.get(
        pool, int((want[:-1] != EMPTY).sum()))
    assert chip_smoke.bit_equal(torch, [fa.P, *fa.x, Ra, pa], [f1.P, *f1.x, R1, p1])


def test_lio_predict_padding_is_a_no_op(cuda):
    """Padded slots (dt <= 0) between live samples change no bit of the
    prediction; their trajectory rows repeat the pose before them."""
    from tc2li_slam_torch.estimation import esekf
    a = _lio_case(cuda, "full")
    filt, gyro, acc, dts, noise = a[0], a[5], a[6], a[7], a[9]
    live = dts > 0
    n = int(live.sum())
    pad = torch.zeros(2 * n, dtype=torch.bool, device=cuda)
    pad[1::2] = True
    g2 = torch.zeros((2 * n, 3), device=cuda)
    a2 = torch.full((2 * n, 3), float("nan"), device=cuda)
    d2 = torch.full((2 * n,), -1.0, device=cuda)
    g2[~pad], a2[~pad], d2[~pad] = gyro[live], acc[live], dts[live]
    f1, R1, p1 = esekf.predict(filt, gyro[live], acc[live], dts[live], noise)
    f2, R2, p2 = esekf.predict(filt, g2, a2, d2, noise)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(f1.x, f2.x)) and torch.equal(f1.P, f2.P)
    assert torch.equal(R2[~pad], R1) and torch.equal(p2[~pad], p1)
    assert torch.equal(R2[pad], R1) and torch.equal(p2[pad], p1)


@pytest.mark.parametrize("n_live,slots", [(1, 0), (10, 0), (40, 0), (1, 1024), (40, 1024)])
def test_lio_predict_matches_plain_window_sizes(cuda, n_live, slots):
    """``esekf_predict`` against ``predict_plain`` (``chip_smoke.LIO_TOL``:
    state and trajectory 1e-4, P diagonally scaled 1e-4) on
    ``chip_smoke.predict_window``'s windows, one launch a call, the same
    bits twice; in 1,024 slots the same bits as the live samples alone."""
    from tc2li_slam_torch.estimation import esekf
    from tc2li_slam_torch.ops.kernels import lio as klio
    x = esekf.init_state(device=cuda)
    x = x._replace(vel=torch.tensor([1.5, 0.1, 0.0], device=cuda),
                   bg=torch.tensor([1e-3, -2e-3, 5e-4], device=cuda),
                   ba=torch.tensor([0.02, -0.01, 0.03], device=cuda))
    filt = esekf.Filter(x, esekf.init_filter(device=cuda).P)
    noise = esekf.NoiseCfg.create(*chip_smoke.VI_CALIB)
    gyro, acc, dts = (t.to(cuda) for t in chip_smoke.predict_window(torch, n_live, slots))
    n0 = klio.predict_launches
    fk, Rk, pk = klio.esekf_predict(filt, gyro, acc, dts, noise)
    again = klio.esekf_predict(filt, gyro, acc, dts, noise)
    fp, Rp, pp = klio.predict_plain(filt, gyro, acc, dts, noise)
    torch.cuda.synchronize()
    assert klio.predict_launches - n0 == 2
    assert all(torch.equal(a, b) for a, b in zip(list(fk.x) + [fk.P, Rk, pk],
                                                 list(again[0].x) + [again[0].P, *again[1:]]))
    tol = chip_smoke.LIO_TOL
    d = max(float((a - b).abs().max()) for a, b in zip(list(fk.x) + [Rk, pk],
                                                       list(fp.x) + [Rp, pp]))
    assert d <= tol["predict_state"], d
    dP = float(((fk.P - fp.P).double().abs().cpu() / chip_smoke.diag_scale(torch, fp.P)).max())
    assert dP <= tol["predict_P"], dP
    if slots:
        g1, a1, d1 = (t.to(cuda) for t in chip_smoke.predict_window(torch, n_live))
        f1, R1, p1 = klio.esekf_predict(filt, g1, a1, d1, noise)
        torch.cuda.synchronize()
        live = dts > 0
        assert all(torch.equal(a, b) for a, b in zip(f1.x, fk.x)) and torch.equal(f1.P, fk.P)
        assert torch.equal(Rk[live], R1) and torch.equal(pk[live], p1)


def test_lio_scan_step_no_host_sync(cuda):
    from tc2li_slam_torch.slam import lio
    a = _lio_case(cuda, "full")
    lio.lio_scan_step(*a)
    torch.cuda.synchronize()
    sites = _sync_sites(lambda: lio.lio_scan_step(*a))
    assert not sites, sites


def test_lio_kernels_refuse_what_they_do_not_take(cuda):
    from tc2li_slam_torch.ops.kernels import lio as klio
    a = _lio_case(cuda, "full")
    filt, m, gyro, acc, dts, noise = a[0], a[1], a[5], a[6], a[7], a[9]
    with pytest.raises(ValueError, match="float32"):
        klio.esekf_predict(filt, gyro.double(), acc, dts, noise)
    with pytest.raises(ValueError, match="CUDA"):
        klio.esekf_predict(filt, gyro, acc, dts.cpu(), noise)
    pts = torch.zeros((10, 3), device=cuda)
    fences = klio.predict_with_fences(filt, gyro, acc, dts, noise, m.keys)[3]
    with pytest.raises(ValueError, match="bool"):
        klio.LioWork(filt, filt, m, pts, torch.ones(10, device=cuda), a[10], fences)
    with pytest.raises(ValueError, match="fence"):   # a table of another pool's size
        klio.LioWork(filt, filt, m, pts, torch.ones(10, dtype=torch.bool, device=cuda), a[10],
                     torch.zeros(3, dtype=torch.int32, device=cuda))
    with pytest.raises(ValueError, match="int32"):   # pool keys of another type
        klio.predict_with_fences(filt, gyro, acc, dts, noise, m.keys.long())
