"""Parity: the plain versions of ``ops/kernels/orb.py`` (the twins of the
three ORB kernels of ``csrc/orb.cu``) and the fixed-order sums of the
cluster and downsample passes, against the JAX package on the CPU.

- The resize adds each output's nonzero taps in a fixed order where
  ``jax.image.resize`` multiplies by the full weight matrices: within 1e-3
  grey levels of the reference, at every level shape of a 1241x376 and of
  a 240x320 image, and at 64x64 (every level the identity).
- The grid top-k of every plane in one call: the reference's
  ``select_topk_grid`` level by level, integers equal, on detected scores,
  a flat plane, one corner a plane and tie-heavy scores.
- Orientation and rBRIEF of one and of two images: angles to 2e-4 rad
  (1e-6 on level 0, whose moments are exact in both), descriptors equal
  given the same angles.
- ``balm._cluster_pass`` and ``pointcloud.voxel_downsample``, whose float
  sums now go through ``tensors.sum_rows``: the tolerances of
  ``test_torch_mapping.py`` and ``test_torch_lidar.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tc2li_slam_tpu.ops import orb as jorb, pointcloud as jpc
from tc2li_slam_tpu.solver import balm as jbalm
from tc2li_slam_torch.ops import orb as torb, pointcloud as tpc
from tc2li_slam_torch.ops.kernels import orb as korb
from tc2li_slam_torch.solver import balm as tbalm
from torch_parity import n, small_sequence, t, words_u32


def _smooth_image(seed, shape):
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 255, shape).astype(np.float32)
    return ((img + np.roll(img, 1, 0) + np.roll(img, 1, 1)) / 3).round().astype(np.float32)


def _reference_weights(n_in, n_out):
    """The reference's [in, out] resize weights (``jax.image.resize`` builds
    them with this function before its contraction)."""
    from jax._src.image import scale as jscale
    return np.asarray(jscale.compute_weight_mat(
        n_in, n_out, n_out / n_in, 0.0, jscale._kernels[jscale.ResizeMethod.LINEAR], True))


@pytest.mark.parametrize("shape,lvl", [((376, 1241), lvl) for lvl in range(1, 8)]
                         + [((240, 320), lvl) for lvl in range(1, 8)] + [((64, 64), 1)])
def test_resize_taps_close_to_jax(shape, lvl):
    """Within 1e-3 grey levels of the reference. At 240x320 (every level
    resized, 67x89 at level 7) and 64x64 (every level clamped to 64x64, the
    identity) that is ``jax.image.resize``. At 1241x376 it is the exact
    (float64) product of ``jax.image.resize``'s own weight matrices: XLA's
    CPU contraction inside ``jax.image.resize`` is itself up to 7.3e-3 grey
    levels from it there (the tap sums: ~3e-5)."""
    img = _smooth_image(lvl, shape)
    out_shape = torb.level_shape(*shape, 1.2, lvl)
    got = n(torb.resize_linear(t(img), out_shape))
    if shape != (376, 1241):
        ref = np.asarray(jax.image.resize(jnp.asarray(img), out_shape, "linear"))
    else:
        wr, wc = (_reference_weights(a, b).astype(np.float64) for a, b in zip(shape, out_shape))
        ref = (wr.T @ img.astype(np.float64)) @ wc
    for a, b in zip(shape, out_shape):   # the same weights, to an ulp of 1
        if a != b:
            np.testing.assert_allclose(korb._resize_weights_np(a, b), _reference_weights(a, b),
                                       rtol=0, atol=2.5e-7)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-3)
    first, w = korb.resize_taps(shape[1], out_shape[1])   # every nonzero weight is a tap
    assert w.shape[1] <= korb.MAX_TAPS and first.min() >= 0
    assert first.max() + w.shape[1] <= shape[1]
    np.testing.assert_allclose(w.sum(axis=1), 1.0, atol=1e-5)


def _level_scores(kind, rng, shapes):
    """One score plane a level shape, as ``fast.detect_planes`` leaves it."""
    out = []
    for p, (Hl, Wl) in enumerate(shapes):
        if kind == "flat":
            s = np.zeros((Hl, Wl), np.float32)
        elif kind == "one_corner":
            s = np.zeros((Hl, Wl), np.float32)
            s[rng.integers(16, Hl - 16), rng.integers(16, Wl - 16)] = 25.0 + p
        elif kind == "ties":
            s = np.where(rng.uniform(size=(Hl, Wl)) < 0.3, rng.integers(1, 4, (Hl, Wl)), 0)
        else:
            img = np.asarray(small_sequence(1)[0].img_l, np.float32)
            level = img if p == 0 else np.asarray(jax.image.resize(
                jnp.asarray(img), (Hl, Wl), "linear"))
            s = np.asarray(jorb.detect_level(jnp.asarray(level)))
        out.append(s.astype(np.float32))
    return out


@pytest.mark.parametrize("kind", ["detected", "flat", "one_corner", "ties"])
def test_select_grid_plain_matches_jax_per_level(rng, kind):
    """All planes of two images in one call against the reference's
    ``select_topk_grid`` of each level; what lies outside a plane is never
    read (it holds NaN here)."""
    img = np.asarray(small_sequence(1)[0].img_l)
    H, W = img.shape
    n_levels = 4
    shapes = [torb.level_shape(H, W, 1.2, lvl) for lvl in range(n_levels)]
    per = torb.features_per_level(512, n_levels, 1.2)
    planes = _level_scores(kind, rng, shapes) * 2
    stack = np.full((2 * n_levels, H, W), np.nan, np.float32)
    for p, s in enumerate(planes):
        stack[p, :s.shape[0], :s.shape[1]] = s
    rows, cols, sel, level, scale = korb.select_grid_plain(t(stack), shapes * 2, per, 1.2)
    assert rows.shape == (2, sum(per)) and rows.dtype == torch.int32
    off = np.cumsum([0] + per)
    for p, s in enumerate(planes):
        b, lvl = divmod(p, n_levels)
        rj, cj, sj = (np.asarray(a) for a in jorb.select_topk_grid(jnp.asarray(s), per[lvl]))
        part = slice(off[lvl], off[lvl + 1])
        np.testing.assert_array_equal(n(rows[b, part]), rj)
        np.testing.assert_array_equal(n(cols[b, part]), cj)
        np.testing.assert_array_equal(n(sel[b, part]), sj)
        assert (n(level[b, part]) == lvl).all()
        assert (n(scale[b, part]) == np.float32(1.2 ** lvl)).all()
    if kind == "flat":
        assert not sel.any()
    if kind == "one_corner":
        assert int((sel > 0).sum()) == 2 * n_levels


def _jax_stacks(imgs, n_levels=4, n_features=512):
    """The reference's edge-padded level and blur stacks of each image, one
    after the other, and its keypoints (rows, cols, levels [B, K])."""
    pad = max(jorb.HALF_PATCH, jorb._PATTERN_RADIUS)
    H, W = imgs[0].shape
    img_stack = np.zeros((len(imgs) * n_levels, H + 2 * pad, W + 2 * pad), np.float32)
    blur_stack = np.zeros_like(img_stack)
    per = jorb.features_per_level(n_features, n_levels, 1.2)
    rows, cols, lvls = [], [], []
    for b, img in enumerate(imgs):
        f = jnp.asarray(img, jnp.float32)
        r_b, c_b, l_b = [], [], []
        for lvl in range(n_levels):
            Hl, Wl = torb.level_shape(H, W, 1.2, lvl)
            li = f if lvl == 0 else jax.image.resize(f, (Hl, Wl), "linear")
            r, c, _ = jorb.select_topk_grid(jorb.detect_level(li), per[lvl])
            p = b * n_levels + lvl
            img_stack[p, :Hl + 2 * pad, :Wl + 2 * pad] = np.pad(np.asarray(li), pad, mode="edge")
            blur_stack[p, :Hl + 2 * pad, :Wl + 2 * pad] = np.pad(
                np.asarray(jorb.gaussian_blur7(li)), pad, mode="edge")
            r_b.append(np.asarray(r))
            c_b.append(np.asarray(c))
            l_b.append(np.full(len(r), lvl, np.int32))
        rows.append(np.concatenate(r_b))
        cols.append(np.concatenate(c_b))
        lvls.append(np.concatenate(l_b))
    return img_stack, blur_stack, np.stack(rows), np.stack(cols), np.stack(lvls), pad


@pytest.mark.parametrize("n_images", [1, 2])
def test_describe_plain_matches_jax(n_images):
    fr = small_sequence(1)[0]
    imgs = [np.asarray(fr.img_l), np.asarray(fr.img_r)][:n_images]
    img_stack, blur_stack, rows, cols, lvl, pad = _jax_stacks(imgs)
    ang, desc = torb.describe(t(img_stack), t(blur_stack), t(rows.astype(np.int32)),
                              t(cols.astype(np.int32)), t(lvl), 4, pad)
    assert ang.shape == rows.shape and desc.shape == (*rows.shape, 8)
    for b in range(n_images):
        planes = slice(4 * b, 4 * b + 4)
        args_j = [jnp.asarray(a) for a in (img_stack[planes], lvl[b], rows[b], cols[b])]
        ang_j = np.asarray(jorb.compute_orientation_stacked(*args_j, pad))
        # the reference's float32 moment sums, taken in another order, move
        # the angle by up to ~1e-4 rad off level 0 (exact on level 0)
        np.testing.assert_allclose(n(ang[b]), ang_j, rtol=0, atol=2e-4)
        np.testing.assert_allclose(n(ang[b])[lvl[b] == 0], ang_j[lvl[b] == 0], rtol=0, atol=1e-6)
        dj = jorb.compute_descriptors_stacked(jnp.asarray(blur_stack[planes]), *args_j[1:],
                                              jnp.asarray(ang_j), pad)
        dt = korb.compute_descriptors_stacked(t(blur_stack), t(lvl[b] + 4 * b), t(rows[b]),
                                              t(cols[b]), t(ang_j), pad)
        np.testing.assert_array_equal(words_u32(dt), np.asarray(dj))
        same = n(ang[b]) == ang_j   # given the same angle, the same words
        np.testing.assert_array_equal(words_u32(desc[b])[same], np.asarray(dj)[same])


@pytest.mark.parametrize("excluded", [0.0, 0.3])
def test_cluster_pass_matches_jax(rng, excluded):
    """Per-(voxel, keyframe) sums of long runs of equal keys, some points
    excluded (BIG key): counts and slots equal, moments to 1e-4."""
    W, M, max_voxels = 4, 3000, 64
    pts_l = rng.normal(0, 3, (W * M, 3)).astype(np.float32)
    pts_w = (pts_l + rng.normal(0, 0.1, (W * M, 3))).astype(np.float32)
    key = rng.integers(0, 80, W * M).astype(np.int32) * 997   # more voxels than slots
    key = np.where(rng.uniform(size=W * M) < excluded, np.iinfo(np.int32).max, key)
    kf = np.repeat(np.arange(W, dtype=np.int32), M)
    got = tbalm._cluster_pass(t(key), t(pts_l), t(pts_w), t(kf), W, max_voxels)
    ref = jbalm._cluster_pass(jnp.asarray(key), jnp.asarray(pts_l), jnp.asarray(pts_w),
                              jnp.asarray(kf), W, max_voxels, jnp.float32)
    np.testing.assert_array_equal(n(got[0]), np.asarray(ref[0]))
    for g, r, name in zip(got[1:4], ref[1:4], ("mean", "Pc", "centers")):
        np.testing.assert_allclose(n(g), np.asarray(r), rtol=1e-4, atol=1e-4, err_msg=name)
    np.testing.assert_array_equal(n(got[4]), np.asarray(ref[4]))


def test_voxel_downsample_matches_jax(rng):
    scan = np.asarray(small_sequence(1)[0].scan)
    valid = np.asarray(small_sequence(1)[0].scan_valid) & (rng.uniform(size=len(scan)) < 0.8)
    pj, vj = jpc.voxel_downsample(jnp.asarray(scan), jnp.asarray(valid), 0.4)
    pt, vt = tpc.voxel_downsample(t(scan), t(valid), 0.4)
    np.testing.assert_array_equal(n(vt), np.asarray(vj))
    # float32 sums of a voxel's points in the same key-sorted order: a few ulp of 50 m
    np.testing.assert_allclose(n(pt), np.asarray(pj), rtol=0, atol=2e-5)
    assert int(vt.sum()) > 100


def test_dispatch_by_device():
    """CPU tensors take the plain versions (no launch counted); another
    device raises; the launch wrappers refuse a CPU tensor."""
    img = t(_smooth_image(0, (64, 80)))
    before = (korb.level_launches, korb.select_launches, korb.describe_launches)
    kp = torb.extract(img, n_features=200, n_levels=3)
    assert (korb.level_launches, korb.select_launches, korb.describe_launches) == before
    assert kp.desc.shape == (200, 8) and bool(kp.valid.any())
    meta = torch.zeros((64, 80), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        torb.level_stacks([meta], 3, 1.2)
    with pytest.raises(ValueError, match="unsupported device"):
        torb.select_grid(torch.zeros((3, 64, 80), device="meta"), [(64, 80)] * 3, [50] * 3, 1.2)
    with pytest.raises(ValueError, match="unsupported device"):
        z = torch.zeros((1, 4), dtype=torch.int32, device="meta")
        torb.describe(torch.zeros((3, 102, 118), device="meta"),
                      torch.zeros((3, 102, 118), device="meta"), z, z, z, 3)
    with pytest.raises(ValueError, match="CUDA"):
        korb.orb_level_planes(img[None], 3, 1.2)


def _system_config(**orb):
    import dataclasses
    from tc2li_slam_torch.slam import config as tcfg
    from torch_parity import small_config
    cfg = small_config(tcfg)
    return dataclasses.replace(cfg, orb=dataclasses.replace(cfg.orb, **orb))


@pytest.mark.parametrize("n_levels", [16, 17])
def test_system_refuses_more_levels_than_the_kernels_take(n_levels):
    """A stereo pair's pyramids are one stack of 2 x n_levels planes, and the
    ORB kernels take at most 32: on the card ``System`` refuses more levels at
    construction; on the CPU it takes any. (At scale 1.1, where 16 levels of
    the 640 x 240 camera fit the pyramid kernel's level table: at 1.2 a tile
    of level 9 reads more image columns than it holds, refused by
    ``test_system_refuses_a_pyramid_over_the_level_kernel_limits``'s check.)"""
    from tc2li_slam_torch.slam import system as tsys
    cfg = _system_config(n_levels=n_levels, scale_factor=1.1)
    assert tsys.System(cfg, "cpu").cfg.orb.n_levels == n_levels
    if 2 * n_levels > korb.MAX_PLANES:
        with pytest.raises(ValueError, match="at most 32 planes"):
            tsys.System(cfg, torch.device("cuda"))
    else:
        tsys.check_kernel_limits(cfg)


@pytest.mark.parametrize("n_levels,scale,refused", [
    (9, 1.2, False), (10, 1.2, True), (6, 1.3, False), (7, 1.3, True),
    (5, 1.4, False), (6, 1.4, True), (3, 2.0, False), (4, 2.0, True), (8, 2.0, True)])
def test_system_refuses_a_pyramid_over_the_level_kernel_limits(n_levels, scale, refused):
    """``orb_level_planes`` reads at most ``MAX_SPAN`` image columns a tile
    and ``MAX_TAPS`` taps an output: at a 1241 x 376 camera 10 levels at
    scale 1.2, 7 at 1.3, 6 at 1.4 and 4 at 2.0 exceed them, and on the card
    ``System`` refuses each at construction from the same level table; the
    largest count below each builds; the CPU takes all."""
    import dataclasses
    from tc2li_slam_torch.slam import system as tsys
    cfg = _system_config(n_levels=n_levels, scale_factor=scale)
    cfg = dataclasses.replace(cfg, camera=dataclasses.replace(cfg.camera, width=1241, height=376))
    assert tsys.System(cfg, "cpu").cfg.orb.n_levels == n_levels
    if refused:
        with pytest.raises(ValueError, match="the kernel takes at most"):
            tsys.System(cfg, torch.device("cuda"))
        with pytest.raises(ValueError):
            korb.level_table(2, 376, 1241, n_levels, scale)
    else:
        tsys.check_kernel_limits(cfg)
        assert len(korb.level_table(2, 376, 1241, n_levels, scale).shapes) == 2 * n_levels


@pytest.mark.parametrize("n_features", [5120, 5121, 13440, 13441])
def test_system_takes_more_keypoints_than_a_match_launch(n_features):
    """A stereo pair's keypoints are padded to ``n_features``, side 2 of the
    stereo match (5,120 columns a launch) and of the tracking match (13,440):
    beyond either the matcher runs in column chunks, so ``System`` on the
    card takes the count (the check passes) and the chunks are the ones the
    CPU tests hold exact (``test_torch_epipolar_emulation.py``)."""
    from tc2li_slam_torch.ops.kernels import match
    from tc2li_slam_torch.slam import system as tsys
    cfg = _system_config(n_features=n_features)
    tsys.check_kernel_limits(cfg)
    padded = sum(torb.features_per_level(n_features, cfg.orb.n_levels, cfg.orb.scale_factor))
    assert padded == n_features
    assert len(match.chunk_bounds(padded, match.StereoMask)) == -(-padded // 5120)
    assert len(match.chunk_bounds(padded, match.WindowMask)) == -(-padded // 13440)
    assert len(match.chunk_bounds(padded, match.EpipolarMask)) == 1


@pytest.mark.parametrize("extra", [0, 1])
def test_system_refuses_a_level_over_the_grid_top_k_limit(extra):
    """``orb_select_grid`` orders at most 12,288 keypoints a level: the
    features at which the first of 4 levels gets exactly that many build on
    the card, one more level-0 keypoint is refused at construction; the CPU
    takes both."""
    from tc2li_slam_torch.slam import system as tsys
    n_feat = next(f for f in range(30000, 50000)
                  if torb.features_per_level(f, 4, 1.2)[0] == korb.MAX_LEVEL_K)
    while torb.features_per_level(n_feat + 1, 4, 1.2)[0] == korb.MAX_LEVEL_K:
        n_feat += 1
    n_feat += extra
    assert max(torb.features_per_level(n_feat, 4, 1.2)) == korb.MAX_LEVEL_K + extra
    cfg = _system_config(n_features=n_feat)
    assert tsys.System(cfg, "cpu").cfg.orb.n_features == n_feat
    if extra:
        with pytest.raises(ValueError, match="orders at most 12288"):
            tsys.System(cfg, torch.device("cuda"))
    else:
        tsys.check_kernel_limits(cfg)
