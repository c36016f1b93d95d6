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
relative.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from tc2li_slam_torch.geom import camera as cam_mod
from tc2li_slam_torch.ops import matching, orb, stereo
from tc2li_slam_torch.ops.kernels import balm as kbalm, fast, hamming, local_ba as klba, match, pose_lm
from tc2li_slam_torch.ops.kernels import orb as korb
from tc2li_slam_torch.solver import balm, lm

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
    with pytest.raises(ValueError):        # side 2 does not fit shared memory
        match.match_best2(c["d1"], wide, c["valid1"], ones, match.WindowMask(
            c["uv1"], c["radius"], c["lvl1"], torch.zeros((8000, 2), device=cuda),
            torch.zeros(8000, dtype=torch.int32, device=cuda)))
    before = match.launches                # the dense mode takes it in two chunks
    _same(match.match_best2(c["d1"], wide, c["valid1"], ones, None, True),
          match.match_best2_plain(c["d1"], wide, c["valid1"], ones, None, True))
    assert match.launches - before == 2
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
    mutual: six column chunks merged, exact, first column on ties."""
    c = _match_case(23, 2000, 32768, cuda)
    c["d2"][20000] = c["d2"][0]             # a tie across chunks
    c["d2"][1] = c["d2"][0]
    seen = c["valid2"] & (torch.rand(32768, device=cuda) < n_seen / 32768)
    seen[0] = seen[1] = seen[20000] = True
    from tc2li_slam_torch.ops.kernels import build
    assert build.library().tc2li_match_max_columns(2) == match.DENSE_MAX_COLUMNS
    before = match.launches, match.launches_by_mode.get("none+mutual+chunk", 0)
    got = match.match_best2(c["d1"], c["d2"], c["valid1"], seen, None, True)
    assert match.launches - before[0] == -(-32768 // match.DENSE_MAX_COLUMNS) == 6
    assert match.launches_by_mode["none+mutual+chunk"] - before[1] == 6
    _same(got, match.match_best2_plain(c["d1"], c["d2"], c["valid1"], seen, None, True))


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
    # fuse pass; one epipolar-masked match per triangulated keyframe pair
    n_pairs = by_mode.pop("dense+mutual")
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


ORB_SHAPES = [(376, 1241), (64, 64), (101, 203)]


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
    tie-heavy scores; the same bits on a second call; one launch."""
    _, _, shapes, _, scores = _orb_scores(cuda, shape, n_images)
    per = orb.features_per_level(2000 if shape[0] > 300 else 500, 8, 1.2)
    ties = torch.round(scores / 16)
    for s in (scores, ties):
        before = korb.select_launches
        got = orb.select_grid(s, shapes, per, 1.2)
        again = korb.orb_select_grid(s, shapes, per, 1.2)
        ref = korb.select_grid_plain(s, shapes, per, 1.2)
        torch.cuda.synchronize()
        assert korb.select_launches - before == 2
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
    with pytest.raises(ValueError):                     # more candidates than the kernel holds
        korb.orb_select_grid(scores[:1], shapes[:1], [5000], 1.2)
    rows, cols, sel, level, _ = korb.orb_select_grid(scores, shapes, per, 1.2)
    with pytest.raises(ValueError):                     # int64 rows
        korb.orb_describe(st, bl, rows.long(), cols, level, 8, pad)
    with pytest.raises(ValueError):                     # a pad short of the pattern
        korb.orb_describe(st, bl, rows, cols, level, 8, 10)
