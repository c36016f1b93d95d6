"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Marked ``gpu``: they skip where torch sees no CUDA device (the decision is
taken inside the test, never at import). On a machine with one card:
``python -m pytest tests/test_torch_kernels_cuda.py -m gpu``.
"""

import numpy as np
import pytest
import torch

from tc2li_slam_torch.ops import orb
from tc2li_slam_torch.ops.kernels import fast, hamming

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("shape", [(376, 1241), (105, 346), (7, 7), (64, 33)])
def test_fast_kernel_matches_plain(cuda, shape):
    rng = np.random.default_rng(1)
    img = torch.as_tensor(rng.integers(0, 256, shape).astype(np.float32)).to(cuda)
    got = fast.fast_score_raw(img)          # CUDA tensor -> kernel
    ref = fast.fast_score_raw_plain(img)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)            # exact, ring included (both 0)


def test_fast_kernel_on_pyramid(cuda):
    rng = np.random.default_rng(2)
    img = torch.as_tensor(rng.integers(0, 256, (376, 1241)).astype(np.float32)).to(cuda)
    before = fast.launches
    for li in orb.pyramid(img, 8, 1.2):
        assert torch.equal(fast.fast_score_raw(li), fast.fast_score_raw_plain(li))
    assert fast.launches - before == 8


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


def test_system_on_cuda_matches_cpu(cuda):
    """The whole slice on the card (kernels and device-side scatters, sorts
    and solves) against the same slice on the CPU, which the CPU tests hold
    to the JAX package: the same keyframes, per-frame positions within 5 mm."""
    from tc2li_slam_torch.io import synthetic as syn
    from tc2li_slam_torch.slam import config as tcfg, system as tsys
    from torch_parity import small_config, small_sequence

    frames = small_sequence(8)
    launches0 = fast.launches, hamming.launches
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
    assert fast.launches - launches0[0] == 8 * 4 * 2   # frames x levels x images
    assert hamming.launches > launches0[1]
