"""The LVI-BA's kernel sequence (``csrc/lvi_ba.cu``) against its plain
version, on a card.

Marked ``gpu``: the tests skip where torch sees no CUDA device (the decision
is taken inside the fixture, never at import). On a machine with one card:
``python -m pytest --noconftest -m gpu tests/test_torch_lvi_ba_cuda.py``
(~1 min). The kernel's sums, inverses, IMU terms, elimination and costs are
float64 where the plain version is float32, so it is held by
``chip_smoke.lvi_agreement``'s rule (``vi_agreement``'s): within
``chip_smoke.LVI_TOL`` of the plain version (T_wb and vel 1e-4, bg 1e-5, ba
1e-4, landmarks 1e-3 m, the cost 1e-3 relative) or else no farther from the
plain version run in float64 on the host; inlier flags equal but at a gate.
Cases (``chip_smoke.lvi_problem``): 4e's shape (P 6, 2000 landmarks, K 8,
the BALM term over 4 states, 6 iterations), the FullInertialBA's (P 20, no
BALM, 10 iterations), a padded window, a non-finite landmark; and the
largest window the solve takes (``MAX_POSES``).
"""

import numpy as np
import pytest
import torch

import chip_smoke
from tc2li_slam_torch.ops.kernels import lvi_ba as klvi
from tc2li_slam_torch.solver import inertial_ba as iba

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _args(case, dev, **kw):
    L = 3000 if case == "full_inertial" else 2000
    p = chip_smoke.lvi_problem(np.random.default_rng(7), case, L=L, **kw)
    return chip_smoke.lvi_args(torch, p, dev)


def _check(a, kw, got, ref):
    ref64 = klvi.lvi_ba_plain(*chip_smoke.lvi_cpu64(torch, a, kw)[0],
                              **chip_smoke.lvi_cpu64(torch, a, kw)[1])
    agr = chip_smoke.lvi_agreement(torch, a, got, ref, ref64)
    assert not agr["outside"], agr
    assert agr["flips"] == agr["near"], agr
    fixed = a[6]
    assert torch.equal(got.state.T_wb[fixed], a[2].T_wb[fixed])
    return agr


@pytest.mark.parametrize("case", chip_smoke.LVI_CASES)
def test_lvi_ba_lm_matches_plain(cuda, case):
    a, kw = _args(case, cuda)
    got = iba.lvi_ba(*a, **kw)
    ref = klvi.lvi_ba_plain(*a, **kw)
    torch.cuda.synchronize()
    _check(a, kw, got, ref)
    if case == "padded":   # the padded slots stay the identity, bit for bit
        assert torch.equal(got.state.T_wb[-2:], torch.eye(4, device=cuda).expand(2, 4, 4))
        assert torch.equal(got.state.vel[-2:], a[2].vel[-2:])
    if case == "non-finite":   # the entry state comes back
        assert bool(torch.isnan(got.cost))
        for x, y in ((got.state.T_wb, a[2].T_wb), (got.state.vel, a[2].vel),
                     (got.state.bg, a[2].bg), (got.state.ba, a[2].ba)):
            assert torch.equal(x, y)
        assert torch.equal(got.X_w[1:], a[3][1:]) and bool(torch.isnan(got.X_w[0]).all())


@pytest.mark.parametrize("case", chip_smoke.LVI_CASES)
def test_lvi_ba_lm_same_bits(cuda, case):
    a, kw = _args(case, cuda)
    r1, r2 = klvi.lvi_ba_lm(*a, **kw), klvi.lvi_ba_lm(*a, **kw)
    for x, y in zip([*r1.state, r1.X_w, r1.cost, r1.obs_inlier],
                    [*r2.state, r2.X_w, r2.cost, r2.obs_inlier]):
        assert torch.equal(torch.nan_to_num(x), torch.nan_to_num(y))


@pytest.mark.parametrize("case", ["4e-like", "full_inertial"])
def test_lvi_ba_lm_launches_a_call(cuda, case):
    """``launches_per_call(iters)`` by the wrapper's counter, and the
    profiler sees as many launches of the six kernels of ``csrc/lvi_ba.cu``
    (the wrapper's tensor ops and the BALM term's kernels aside)."""
    a, kw = _args(case, cuda)
    n0 = klvi.launches
    iba.lvi_ba(*a, **kw)
    assert klvi.launches - n0 == klvi.launches_per_call(kw["iters"])
    split = chip_smoke.kernel_split(torch, lambda: klvi.lvi_ba_lm(*a, **kw), 2)
    n = sum(v["launches_a_call"] for k, v in split.items() if k in chip_smoke.LVI_KERNELS)
    assert n == klvi.launches_per_call(kw["iters"]), split
    assert split["solve_kernel"]["launches_a_call"] == kw["iters"]


def test_lvi_ba_lm_no_host_sync(cuda):
    for case in ("4e-like", "padded"):
        a, kw = _args(case, cuda)
        assert chip_smoke.syncs_of(torch, lambda: iba.lvi_ba(*a, **kw)) == 0


@pytest.mark.parametrize("P,iters", [(klvi.MAX_POSES, 2), (7, 0), (1, 3)])
def test_lvi_ba_lm_window_sizes(cuda, P, iters):
    """The largest window the solve's shared memory takes (the cluster path,
    405 rows), no iteration (the entry state and its inlier flags), one
    state (no factor)."""
    a, kw = _args("full_inertial" if P > 6 else "4e-like", cuda, P=P, K=min(8, P))
    kw = dict(iters=iters)
    got = iba.lvi_ba(*a, **kw)
    ref = klvi.lvi_ba_plain(*a, **kw)
    torch.cuda.synchronize()
    _check(a, kw, got, ref)
    if iters == 0:
        assert torch.equal(got.state.T_wb, a[2].T_wb) and torch.equal(got.X_w, a[3])
        assert torch.equal(got.obs_inlier, ref.obs_inlier)


def test_lvi_ba_lm_refuses_what_it_does_not_take(cuda):
    a, kw = _args("4e-like", cuda)
    big = chip_smoke.lvi_problem(np.random.default_rng(7), "full_inertial",
                                 P=klvi.MAX_POSES + 1, L=200)
    ab, kwb = chip_smoke.lvi_args(torch, big, cuda)
    with pytest.raises(ValueError, match="P 28"):
        klvi.lvi_ba_lm(*ab, **kwb)
    a64 = chip_smoke._vi_cast(torch, a, torch.float64)
    with pytest.raises(ValueError, match="torch.float32"):
        klvi.lvi_ba_lm(*a64, iters=2)
    cpu = a[:3] + (a[3].cpu(),) + a[4:]
    with pytest.raises(ValueError, match="one CUDA device"):
        klvi.lvi_ba_lm(*cpu, iters=2)
    with pytest.raises(ValueError, match="n_lidar"):
        klvi.lvi_ba_lm(*a, **dict(kw, n_lidar=0))
