"""Parity of the port's distributed BA (``parallel/dist_ba.py`` on
``torch.distributed``) with the JAX package's (``jax.shard_map`` over the
8-device CPU mesh of tests/conftest.py), on tests/test_dist_ba.py's problem.

In process the port runs a world-size-1 gloo group; the sum over 8 shards
is taken from ``partial_system`` directly, and a two-process gloo run in
subprocesses holds the collective path itself against the one-process
result."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from tc2li_slam_tpu.parallel import dist_ba as jdist
from tc2li_slam_torch.geom import lie as tlie
from tc2li_slam_torch.parallel import dist_ba as tdist
from tc2li_slam_torch.solver import lm as tlm
from test_dist_ba import CAM as JCAM, make_problem
from torch_parity import gloo_mesh, n, t

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def ba_problem_torch(p: dict):
    """The problem's numpy arrays as CPU tensors: (T0, X0, obs, fixed)."""
    obs = tlm.BAObservations(*(t(p[k]) for k in ("pose_idx", "uv", "inv_sigma2", "stereo",
                                                   "valid")))
    return t(p["T0"]), t(p["X0"]), obs, t(p["fixed"])


@pytest.fixture(scope="module")
def ws1(tmp_path_factory):
    with gloo_mesh(tmp_path_factory.mktemp("dist")) as mesh:
        yield mesh


@pytest.fixture(scope="module")
def problem():
    """The reference's problem (P 6, L 512, K 4, seed 0) as numpy arrays,
    and the port's camera."""
    T_gt, X, T0, X0, obs, fixed = make_problem(np.random.default_rng(0))
    p = dict(T_gt=T_gt, X=X, T0=n(T0), X0=n(X0), fixed=n(fixed),
             **{k: n(v) for k, v in obs._asdict().items()})
    cam, _ = chip_smoke.dist_problem(torch, np.random.default_rng(0), L=1)
    return p, (T0, X0, obs, fixed), cam


def test_port_problem_is_the_reference_problem(problem):
    """``chip_smoke.dist_problem`` (numpy and the port, for runs without
    jax) draws the reference's problem: equal indices, poses and landmarks
    to 1e-6, pixels to 2e-4 px (one float32 projection of all points against
    one a point; measured 6.1e-5)."""
    p, _, _ = problem
    _, q = chip_smoke.dist_problem(torch, np.random.default_rng(0))
    assert np.array_equal(q["pose_idx"], p["pose_idx"]) and np.array_equal(q["fixed"], p["fixed"])
    for k in ("T_gt", "T0", "X0"):
        np.testing.assert_allclose(q[k], p[k], rtol=0, atol=1e-6)
    np.testing.assert_allclose(q["uv"], p["uv"], rtol=0, atol=2e-4)


# measured: 3.9e-5 (poses), 2.5e-3 m (landmarks at 10-50 m), 3.3e-6 (cost)
POSE_TOL, LM_TOL, COST_RTOL = 2e-4, 5e-3, 1e-5


@pytest.mark.parametrize("iters", [5, 12, 15])
def test_optimize_matches_jax(ws1, problem, iters):
    """World size 1 against the reference on 8 devices: the same optimum,
    the same accepted cost."""
    p, (T0, X0, obs, fixed), cam = problem
    L = p["X0"].shape[0]
    mesh = jdist.make_mesh(jax.devices()[:8])
    Xs, obs_s, vs = jdist.shard_problem(mesh, X0, obs, jnp.ones(L, bool))
    Tj, Xj, cj = jdist.optimize(mesh, JCAM, T0, Xs, obs_s, vs, fixed, iters=iters)
    T0t, X0t, obst, fixt = ba_problem_torch(p)
    Xs_t, obs_t, vs_t = tdist.shard_problem(ws1, X0t, obst, torch.ones(L, dtype=torch.bool))
    Tt, Xt, ct = tdist.optimize(ws1, cam, T0t, Xs_t, obs_t, vs_t, fixt, iters=iters)
    assert ct.shape == () and Tt.dtype == torch.float32
    assert np.abs(n(Tj) - n(Tt)).max() < POSE_TOL
    assert np.abs(n(Xj) - n(Xt)).max() < LM_TOL
    assert float(ct) == pytest.approx(float(cj), rel=COST_RTOL)


@pytest.mark.parametrize("L,inactive", [(512, 0.0), (509, 0.1)])
def test_partial_systems_of_8_shards_sum_to_one(problem, L, inactive):
    """Mesh-size invariance without a process group: the 8 shards'
    ``partial_system`` summed equal the one-shard system (1e-4 of the
    largest entry), and the back-substituted landmark steps concatenate to
    the one-shard steps. L 509 pads the last shard with 3 rows; a tenth of
    the landmarks inactive."""
    p, _, cam = problem
    T0, X0, obs, _ = ba_problem_torch(p)
    X0, obs = X0[:L], tlm.BAObservations(*(x[:L] for x in obs))
    valid_lm = torch.as_tensor(np.random.default_rng(2).random(L) >= inactive)
    lam = torch.tensor(1e-4)
    parts, shards = [], []
    for rank in range(8):
        sh = tdist.shard_problem(tdist.Mesh(None, rank, 8), X0, obs, valid_lm)
        shards.append(sh)
        parts.append(tdist.partial_system(cam, T0, *sh, lam))
    whole = tdist.partial_system(cam, T0, X0, obs, valid_lm, lam)
    for k in ("S", "g_red", "cost"):
        total = sum(getattr(q, k) for q in parts)
        ref = getattr(whole, k)
        assert float((total - ref).abs().max()) <= 1e-4 * float(ref.abs().max()), k
    dp = tdist.solve_poses(whole.S, whole.g_red, torch.arange(6) == 0, lam,
                           torch.zeros(36, 36), torch.zeros(36))
    dl = torch.cat([tdist.back_substitute(q, sh[1], dp, sh[2]) for q, sh in zip(parts, shards)])
    dl_ref = tdist.back_substitute(whole, obs, dp, valid_lm)
    assert float((dl[:L] - dl_ref).abs().max()) <= 1e-4 * float(dl_ref.abs().max())
    assert not dl[L:].any()


def test_matches_single_device_local_ba(ws1, problem):
    """The distributed solver and ``lm.local_ba`` land on the same optimum
    (the reference's own bound, tests/test_dist_ba.py:84)."""
    p, _, cam = problem
    T0, X0, obs, fixed = ba_problem_torch(p)
    valid = torch.ones(X0.shape[0], dtype=torch.bool)
    Td, _, _ = tdist.optimize(ws1, cam, T0, *tdist.shard_problem(ws1, X0, obs, valid), fixed,
                              iters=15)
    res = tlm.local_ba(cam, T0, X0, obs, fixed, valid, iters=15)
    assert float((Td - res.T_cw).abs().max()) < 5e-3
    err = lambda T: np.linalg.norm(n(T)[1:, :3, 3] - p["T_gt"][1:, :3, 3], axis=-1).mean()
    e0 = np.linalg.norm(p["T0"][1:, :3, 3] - p["T_gt"][1:, :3, 3], axis=-1).mean()
    assert e0 > 0.02 and err(Td) < 0.15 * e0 and err(Td) < 1.3 * err(res.T_cw) + 1e-3


def test_extra_fn_prior_pins_pose(ws1, problem):
    """A replicated dense pose extra enters the solve (the BALM path's
    form): a strong quadratic prior at pose 1's ground truth pins it to
    < 2e-3 (tests/test_dist_ba.py:104-127), as in the reference."""
    p, _, cam = problem
    T0, X0, obs, fixed = ba_problem_torch(p)
    T_gt1 = t(p["T_gt"][1])
    D = 36

    def extra_fn(T_cw):
        xi = tlie.se3_log(T_cw[1] @ tlie.se3_inverse(T_gt1))
        w = 1e6
        H = torch.zeros((D, D))
        H[6:12, 6:12] = w * torch.eye(6)
        g = torch.zeros(D)
        g[6:12] = w * xi
        return H, g, w * torch.sum(xi * xi)

    valid = torch.ones(X0.shape[0], dtype=torch.bool)
    T1, _, cost = tdist.optimize(ws1, cam, T0, *tdist.shard_problem(ws1, X0, obs, valid), fixed,
                                 iters=12, extra_fn=extra_fn)
    assert np.linalg.norm(n(T1)[1, :3, 3] - p["T_gt"][1, :3, 3]) < 2e-3
    assert np.isfinite(float(cost))


WORKER = r"""
import sys
repo, rank, world, init, out = sys.argv[1:6]
sys.path.insert(0, repo)
import numpy as np
import torch
torch.set_num_threads(1)
import chip_smoke
from tc2li_slam_torch.parallel import dist_ba
from tc2li_slam_torch.solver.lm import BAObservations

mesh = dist_ba.make_mesh("gloo", init, int(rank), int(world))
cam, p = chip_smoke.dist_problem(torch, np.random.default_rng(0))
tt = lambda k: torch.as_tensor(p[k])
obs = BAObservations(*(tt(k) for k in ("pose_idx", "uv", "inv_sigma2", "stereo", "valid")))
L = p["X0"].shape[0]
Xs, obs_s, vs = dist_ba.shard_problem(mesh, tt("X0"), obs, torch.ones(L, dtype=torch.bool))
T1, X1, cost = dist_ba.optimize(mesh, cam, tt("T0"), Xs, obs_s, vs, tt("fixed"), iters=10)
X_all = dist_ba.all_gather_rows(mesh, X1, L)
np.savez(out, T=T1.numpy(), X=X_all.numpy(), cost=cost.numpy(), rows=Xs.shape[0])
torch.distributed.destroy_process_group()
"""


def test_two_process_gloo_matches_one_process(ws1, tmp_path):
    """Two gloo ranks in two processes, 256 landmarks each: the same poses
    and landmarks on both ranks (bitwise), and the world-size-1 result
    within the reference's own mesh-size bound (tests/test_dist_ba.py:100,
    rtol 1e-4, atol 2e-5; measured 3.0e-5 on the poses: the two halves are
    summed in another order than the whole)."""
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    init = f"file://{tmp_path}/store"
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, str(script), REPO, str(r), "2", init,
                               str(tmp_path / f"rank{r}.npz")],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
                              cwd=REPO) for r in range(2)]
    try:
        outs = [pr.communicate(timeout=120) for pr in procs]
    finally:
        for pr in procs:
            pr.kill()
    for pr, (so, se) in zip(procs, outs):
        assert pr.returncode == 0, f"worker failed:\n{so[-2000:]}\n{se[-2000:]}"
    r0, r1 = (np.load(tmp_path / f"rank{r}.npz") for r in range(2))
    assert int(r0["rows"]) == int(r1["rows"]) == 256
    assert np.array_equal(r0["T"], r1["T"]) and np.array_equal(r0["X"], r1["X"])
    cam, p = chip_smoke.dist_problem(torch, np.random.default_rng(0))
    T0, X0, obs, fixed = ba_problem_torch(p)
    valid = torch.ones(X0.shape[0], dtype=torch.bool)
    T1, X1, cost = tdist.optimize(ws1, cam, T0, *tdist.shard_problem(ws1, X0, obs, valid), fixed,
                                  iters=10)
    np.testing.assert_allclose(r0["T"], n(T1), rtol=1e-4, atol=2e-5)
    np.testing.assert_allclose(r0["X"], n(X1), rtol=1e-4, atol=2e-5)
    assert float(r0["cost"]) == pytest.approx(float(cost), rel=1e-5)
