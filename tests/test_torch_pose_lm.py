"""Parity: the pose-only LM of tc2li_slam_torch (``solver/lm.pose_only_optimize``;
on the CPU the plain version of ``ops/kernels/pose_lm.py``) against
tc2li_slam_tpu's jit-compiled ``solver/lm.pose_only_optimize``, on the
inputs of ``chip_smoke.pose_problem``; and the dispatch by device.
``tests/test_torch_kernels_cuda.py`` holds the kernel to the plain version
on the same cases on a card."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from tc2li_slam_tpu.geom import camera as jcam
from tc2li_slam_tpu.solver import lm as jlmo
from tc2li_slam_torch.geom import camera as tcam
from tc2li_slam_torch.ops.kernels import pose_lm
from tc2li_slam_torch.solver import lm as tlmo
from torch_parity import n, t

# Iterated float32 solvers in two libraries (other summation orders in the
# normal equations), as tests/test_torch_mapping.py: poses to 1e-4, costs
# to 1e-3 relative; the inlier masks equal.
POSE_ATOL, COST_RTOL = 1e-4, 1e-3


def _both(case):
    cam_args, args, kw = chip_smoke.pose_problem(np.random.default_rng(7), 2000, case)
    rj = jlmo.pose_only_optimize(jcam.Pinhole.create(*cam_args), *map(jnp.asarray, args), **kw)
    rt = tlmo.pose_only_optimize(tcam.Pinhole.create(*cam_args), *map(t, args), **kw)
    return args, rj, rt


@pytest.mark.parametrize("case", chip_smoke.POSE_CASES)
def test_pose_only_matches_reference(case):
    args, rj, rt = _both(case)
    T0, valid = args[0], args[5]
    assert rt.T_cw.dtype == torch.float32 and rt.inliers.dtype == torch.bool
    assert rt.n_inliers.dtype == torch.int32 and rt.cost.shape == ()
    np.testing.assert_allclose(n(rt.T_cw), np.asarray(rj.T_cw), atol=POSE_ATOL)
    np.testing.assert_array_equal(n(rt.inliers), np.asarray(rj.inliers))
    assert int(rt.n_inliers) == int(rj.n_inliers) == int(n(rt.inliers).sum())
    np.testing.assert_allclose(float(rt.cost), float(rj.cost), rtol=COST_RTOL)
    assert not np.any(n(rt.inliers) & ~valid)
    if case in ("tracking", "pnp", "behind_and_z0"):
        assert int(rt.n_inliers) > 0.8 * valid.sum() and np.isfinite(float(rt.cost))
        assert np.abs(n(rt.T_cw) - T0).max() > 1e-3          # it moved
    if case == "behind_and_z0":
        assert not n(rt.inliers)[:2].any()                   # depth-gated out
    if case == "all_invalid":
        assert torch.equal(rt.T_cw, t(T0)) and int(rt.n_inliers) == 0 and float(rt.cost) == 0.0
    if case == "masked_nan":
        # the reference's defect, reproduced: the masked NaN row enters
        # every sum through 0 * NaN, no step is accepted
        assert torch.equal(rt.T_cw, t(T0)) and np.isnan(float(rt.cost))
        assert np.isnan(float(rj.cost)) and np.array_equal(np.asarray(rj.T_cw), T0)


def test_pose_only_dispatch_by_device():
    """CPU tensors take the plain version (no launch); a device that is
    neither the CPU nor CUDA raises."""
    cam_args, args, kw = chip_smoke.pose_problem(np.random.default_rng(7), 64, "tracking")
    cam = tcam.Pinhole.create(*cam_args)
    before = pose_lm.launches
    res = tlmo.pose_only_optimize(cam, *map(t, args), **kw)
    assert pose_lm.launches == before and res.T_cw.device.type == "cpu"
    ref = pose_lm.pose_only_plain(cam, *map(t, args), **kw)
    assert all(torch.equal(a, b) for a, b in zip(res, ref))
    with pytest.raises(ValueError, match="unsupported device"):
        tlmo.pose_only_optimize(cam, *(t(a).to("meta") for a in args), **kw)
    with pytest.raises(ValueError, match="CUDA"):
        pose_lm.pose_only_lm(cam, *map(t, args), **kw)
