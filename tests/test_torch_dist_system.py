"""``System(cfg, "cpu", mesh=...)`` routes the mapping pass's local BA
through the port's distributed solver (``parallel/dist_ba.py``), as the
reference's ``System(mesh=...)`` does: on 8 SMALL frames with a
world-size-1 gloo group the trajectory stays within the reference's rule
against the run without a mesh (tests/test_dist_ba.py:158-159)."""

import numpy as np
import pytest

from tc2li_slam_torch.io import synthetic as syn
from tc2li_slam_torch.parallel import dist_ba
from tc2li_slam_torch.slam import config as tcfg, system as tsys
from torch_parity import gloo_mesh, small_config, small_sequence

N_FRAMES = 8


def _run(mesh):
    slam = tsys.System(small_config(tcfg), "cpu", mesh=mesh)
    frames = small_sequence(N_FRAMES)
    for fr in frames:
        slam.track(fr.img_l, fr.img_r, fr.t, fr.scan, fr.scan_valid)
        assert slam.state == tsys.TrackingState.OK
    gt = np.stack([fr.T_wb_gt @ syn.body_from_cam() for fr in frames])
    return slam, syn.ate_rmse(slam.trajectory_world_from_cam(), gt)


def test_system_local_ba_through_mesh(tmp_path, monkeypatch):
    calls = []
    optimize = dist_ba.optimize

    def spy(mesh, *a, **kw):
        calls.append((mesh, kw.get("extra_fn") is not None))
        return optimize(mesh, *a, **kw)

    monkeypatch.setattr(dist_ba, "optimize", spy)
    with gloo_mesh(tmp_path) as mesh:
        slam_m, ate_mesh = _run(mesh)
    slam_s, ate_single = _run(None)
    assert slam_m.n_ba >= 1 and len(calls) == slam_m.n_ba
    assert all(m is mesh and balm for m, balm in calls)   # the BALM term rides along
    assert slam_s.n_ba == slam_m.n_ba and len(calls) == slam_m.n_ba
    assert ate_mesh < 0.2, ate_mesh
    assert ate_mesh < ate_single * 1.5 + 0.02, (ate_mesh, ate_single)
    assert np.isfinite(slam_m.map.lm_pos.numpy()).all()
