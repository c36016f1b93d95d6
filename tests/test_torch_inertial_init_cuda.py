"""The visual-inertial initialization's kernel (``csrc/inertial_init.cu``)
against its plain version, on a card.

Marked ``gpu``: the tests skip where torch sees no CUDA device (the decision
is taken inside the fixture, never at import). On a machine with one card:
``python -m pytest --noconftest -m gpu tests/test_torch_inertial_init_cuda.py``
(~1 min). Everything in the kernel after its float32 inputs is float64,
so it is held to the plain version run in float64 on the host from the same
float32 inputs, within ``chip_smoke.INIT_TOL`` (``test_torch_inertial``'s
tolerances: R_wg 1e-5, the scale 2e-3, bg 1e-6, ba 1e-4, velocities 1e-4,
the cost 1e-3 relative; ``chip_smoke.init_agreement``). Cases: ``chip_smoke.init_problem``'s windows (free
gravity and scale, free gravity, 6 keyframes padded to 20, a NaN in a
valid and in an invalid factor), the padded window under each of
``System.VI_STAGE_PRIORS``, the flags four ways, and the sizes the kernel
takes at its ends (``MAX_KF``, one keyframe, no iteration).
"""

import numpy as np
import pytest
import torch

import chip_smoke
from tc2li_slam_torch.ops.kernels import build, inertial_init as kii
from tc2li_slam_torch.slam import system as tsys
from tc2li_slam_torch.solver import inertial_init as ii

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _args(case, dev, seed=7, **kw):
    p = chip_smoke.init_problem(np.random.default_rng(seed), case, **kw)
    return chip_smoke.init_args(torch, p, dev)


def _check(a, kw, got):
    ref64 = kii.inertial_init_plain(*chip_smoke.init_cpu64(torch, a), **kw)
    agr = chip_smoke.init_agreement(torch, got, ref64)
    assert not agr["outside"], agr
    return agr


@pytest.mark.parametrize("case", chip_smoke.INIT_CASES)
def test_inertial_init_gn_matches_plain(cuda, case):
    a, kw = _args(case, cuda)
    got = ii.inertial_optimization(*a, **kw)
    torch.cuda.synchronize()
    _check(a, kw, got)
    if case.startswith("non-finite"):   # the entry state comes back, the cost NaN
        assert bool(torch.isnan(got.cost))
        assert torch.equal(got.vel, a[15]) and torch.equal(got.R_wg, a[14])
        assert not bool(got.bg.any()) and not bool(got.ba.any())


@pytest.mark.parametrize("stage", [0, 1, 2])
def test_inertial_init_gn_stage_priors(cuda, stage):
    prior_g, prior_a = tsys.System.VI_STAGE_PRIORS[stage]
    a, kw = _args("4e-like padded", cuda)
    kw.update(prior_g=prior_g, prior_a=prior_a)
    got = ii.inertial_optimization(*a, **kw)
    _check(a, kw, got)


@pytest.mark.parametrize("fix_gravity,fix_scale", [(False, False), (False, True), (True, False),
                                                   (True, True)])
def test_inertial_init_gn_flags(cuda, fix_gravity, fix_scale):
    a, kw = _args("free gravity and scale", cuda)
    kw.update(fix_gravity=fix_gravity, fix_scale=fix_scale)
    got = ii.inertial_optimization(*a, **kw)
    _check(a, kw, got)
    if fix_gravity:
        assert torch.equal(got.R_wg, a[14])
    if fix_scale:
        assert float(got.scale) == 1.0


@pytest.mark.parametrize("case", chip_smoke.INIT_CASES)
def test_inertial_init_gn_same_bits(cuda, case):
    a, kw = _args(case, cuda)
    r1, r2 = kii.inertial_init_gn(*a, **kw), kii.inertial_init_gn(*a, **kw)
    for x, y in zip(r1, r2):
        assert torch.equal(torch.nan_to_num(x), torch.nan_to_num(y))


def test_inertial_init_gn_one_launch_a_call(cuda):
    """One launch a call by the wrapper's counter, and in a profile of the
    calls one ``inertial_init_kernel`` a call and no other device event (the
    wrapper reads its inputs where they lie; ``kernel_split`` opens its
    window with spin kernels, so the profiler's loss of a window's first
    events cannot reach the calls)."""
    a, kw = _args("4e-like padded", cuda)
    n0 = kii.launches
    fn, calls = chip_smoke.counted(lambda: ii.inertial_optimization(*a, **kw))
    split = chip_smoke.kernel_split(torch, fn, 10)
    assert kii.launches - n0 == calls[0]
    assert {k: v["launches_a_call"] for k, v in split.items()} == {"inertial_init_kernel": 1.0}, \
        split


def test_inertial_init_gn_no_host_sync(cuda):
    for case in ("free gravity and scale", "4e-like padded"):
        a, kw = _args(case, cuda)
        assert chip_smoke.syncs_of(torch, lambda: ii.inertial_optimization(*a, **kw)) == 0


@pytest.mark.parametrize("K,iters", [(kii.MAX_KF, 3), (1, 4), (20, 0)])
def test_inertial_init_gn_sizes(cuda, K, iters):
    """The largest window the shared memory takes, one keyframe (no factor:
    the priors alone), no iteration (the entry state and cost)."""
    a, kw = _args("free gravity", cuda, K=K, n_real=K)
    kw["iters"] = iters
    got = ii.inertial_optimization(*a, **kw)
    torch.cuda.synchronize()
    _check(a, kw, got)
    if iters == 0:
        assert torch.equal(got.vel, a[15]) and torch.equal(got.R_wg, a[14])


def test_inertial_init_gn_refuses_what_it_does_not_take(cuda):
    assert build.library().tc2li_inertial_init_max_kf() == kii.MAX_KF
    assert build.library().tc2li_inertial_init_smem(20) == kii.smem_bytes(20)
    a, kw = _args("4e-like padded", cuda, K=kii.MAX_KF + 1)
    with pytest.raises(ValueError, match=f"K {kii.MAX_KF + 1}"):
        kii.inertial_init_gn(*a, **kw)
    a, kw = _args("4e-like padded", cuda)
    with pytest.raises(ValueError, match="torch.float32"):
        kii.inertial_init_gn(*chip_smoke._vi_cast(torch, a, torch.float64), **kw)
    with pytest.raises(ValueError, match="one CUDA device"):
        kii.inertial_init_gn(*a[:15], a[15].cpu(), **kw)
