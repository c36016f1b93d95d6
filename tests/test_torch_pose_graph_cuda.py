"""The pose graph's kernels (``csrc/pose_graph.cu``) against their plain
version, on a card.

Marked ``gpu``: the tests skip where torch sees no CUDA device (the decision
is taken inside the fixture, never at import). On a machine with one card:
``python -m pytest --noconftest -m gpu tests/test_torch_pose_graph_cuda.py``
(~1 min). Everything in the kernels after their float32 inputs is float64,
so they are held to the plain version run in float64 on the card from the
same float32 inputs, within ``chip_smoke.PG_TOL`` (1e-4, test_torch_sim3's
tolerance) on every pose entry. Cases: ``chip_smoke.pose_graph_problem``'s
graphs up to 400 keyframes (``chip_smoke.py`` runs the 2,048-keyframe one),
free-row counts that fill the last Cholesky panel and its last part and
that leave one row in them, no edge, every pose fixed, no iteration, one
pose; the same bits on a second call, the launches the wrapper counts and
the library's plan, no host sync.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from tc2li_slam_torch.ops.kernels import pose_graph as kpg
from tc2li_slam_torch.solver import sim3

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _args(case, dev, seed=26):
    return chip_smoke.pose_graph_args(
        torch, chip_smoke.pose_graph_problem(np.random.default_rng(seed), case), dev)


def _check(a, kw):
    n0 = kpg.launches
    got = sim3.pose_graph_optimize(*a, **kw)
    again = sim3.pose_graph_optimize(*a, **kw)
    ref64 = kpg.pose_graph_plain(*chip_smoke.pose_graph_cast(torch, a, torch.float64), **kw)
    torch.cuda.synchronize()
    assert kpg.launches - n0 == 2 * kpg.launches_per_call(a[0].shape[0], kw["iters"])
    assert torch.equal(got, again)
    assert chip_smoke.pose_distance(torch, got, ref64) <= chip_smoke.PG_TOL
    return got


@pytest.mark.parametrize("case", chip_smoke.PG_CASES[:-1])
def test_pose_graph_gn_matches_plain(cuda, case):
    a, kw = _args(case, cuda)
    got = _check(a, kw)
    fixed = a[2]
    assert torch.equal(got[fixed], a[0][fixed])
    if case == "non-finite":
        assert torch.equal(got, a[0])
    else:
        assert float((got - a[0]).abs().max()) > 1e-3


def test_launches_per_call(cuda):
    """The library's plan (``tc2li_pose_graph_launches``): 2 + iters (3 + 4 P)
    over the P 64-row parts of the 7K rows, the counts that
    ``test_torch_pose_graph_kernel.py``'s emulation walks."""
    for K, iters, want in ((49, 15, 407), (256, 15, 1727), (400, 15, 2687), (2048, 2, 1800),
                           (2048, 0, 2), (1, 1, 9)):
        P = -(-7 * K // 64)
        assert kpg.launches_per_call(K, iters) == 2 + iters * (3 + 4 * P) == want


@pytest.mark.parametrize("n_free", [256, 183, 64, 55, 9, 1])
def test_panel_edges(cuda, n_free):
    """Free rows (pose 0 fixed, K = n_free + 1) at the edges of the solve's
    plan: 7 x 256 = 1,792 (the last 256-column panel full, row n alone below
    it), 7 x 183 = 1,281 (one row in the last panel), 7 x 64 = 448 (the
    last 64-column part full), 7 x 55 = 385 (one row in the last part), 63
    (below one diagonal block) and 7."""
    a, kw = _args("covisibility 400", cuda)
    S_w, e, fixed = a
    K = n_free + 1
    keep = (e.i < K) & (e.j < K)
    e = e._replace(**{k: getattr(e, k)[keep] for k in ("i", "j", "S_ij", "weight", "valid")})
    _check((S_w[:K].contiguous(), e, fixed[:K].contiguous()), kw)


def test_degenerate_calls(cuda):
    """No edge, every pose fixed, no iteration: the poses come back as they
    went in; one pose alone."""
    a, kw = _args("drift", cuda)
    S_w, e, fixed = a
    none = e._replace(**{k: getattr(e, k)[:0] for k in ("i", "j", "S_ij", "weight", "valid")})
    assert torch.equal(_check((S_w, none, fixed), kw), S_w)
    assert torch.equal(_check((S_w, e, torch.ones_like(fixed)), kw), S_w)
    assert torch.equal(_check(a, {"iters": 0}), S_w)
    one = e._replace(**{k: getattr(e, k)[:0] for k in ("i", "j", "S_ij", "weight", "valid")})
    assert torch.equal(_check((S_w[:1], one, fixed[:1]), kw), S_w[:1])


def test_no_host_sync(cuda):
    a, kw = _args("covisibility 400", cuda)
    assert chip_smoke.syncs_of(torch, lambda: sim3.pose_graph_optimize(*a, **kw)) == 0


def test_wrapper_refuses(cuda):
    a, kw = _args("drift", cuda)
    S_w, e, fixed = a
    with pytest.raises(ValueError, match="float32"):
        kpg.pose_graph_gn(S_w.double(), e, fixed, **kw)
    with pytest.raises(ValueError, match="CUDA device"):
        kpg.pose_graph_gn(S_w, e, fixed.cpu(), **kw)
