"""Parity of the port's stage timers, device trace and map exporters
(``slam/profiling.py``, ``slam/viewer.py``) with the JAX package's: the same
``add`` sequence gives the same statistics and report, the drawing and the
PLY writer are byte for byte the reference's, and the exporters read a port
``System`` into the files the reference's exporters write from it."""

import dataclasses
import json

import numpy as np
import pytest
import torch

from tc2li_slam_tpu.slam import profiling as jprof, viewer as jview
from tc2li_slam_torch.ops import voxel_map
from tc2li_slam_torch.slam import config as tcfg, profiling as tprof, system as tsys, viewer as tview
from torch_parity import small_config, small_sequence

SAMPLES = [("track", 0.0123), ("lio", 0.5), ("track", 0.0377), ("sync", 1e-5), ("track", 0.02),
           ("a_stage_with_a_long_name_x", 3.25), ("lio", 0.125)]


def test_stage_timer_stats_and_report_match_reference():
    """The same ``add`` sequence: equal ``stats()`` (1e-9 relative; the
    arithmetic is the same Python floats) and an identical ``report()``."""
    j, t = jprof.StageTimer(), tprof.StageTimer("cpu")
    for name, sec in SAMPLES:
        j.add(name, sec)
        t.add(name, sec)
    sj, st = j.stats(), t.stats()
    assert set(sj) == set(st)
    for name in sj:
        assert set(st[name]) == {"n", "mean_ms", "std_ms", "max_ms", "total_s"}
        assert st[name]["n"] == sj[name]["n"]
        for k in ("mean_ms", "std_ms", "max_ms", "total_s"):
            assert st[name][k] == pytest.approx(sj[name][k], rel=1e-9, abs=0.0)
    assert t.report() == j.report()
    t.reset()
    assert t.stats() == {} and t.report() == j.report().splitlines()[0]


def test_stage_timer_counts_calls_on_the_cpu():
    t = tprof.StageTimer(torch.device("cpu"))
    for _ in range(5):
        with t.stage("a"):
            torch.ones(3).sum()
    s = t.stats()["a"]
    assert s["n"] == 5 and s["max_ms"] >= s["mean_ms"] >= 0.0 and s["total_s"] < 1.0


@pytest.mark.parametrize("use", ["stage", "add"])
def test_stage_timer_disabled_records_nothing(use):
    t = tprof.StageTimer("cpu", enabled=False)
    if use == "stage":
        with t.stage("x"):
            pass
    else:
        t.add("x", 0.5)
    assert t.stats() == {} and not t.samples


def test_device_trace_writes_a_chrome_trace(tmp_path):
    with tprof.device_trace(tmp_path / "trace", "cpu") as path:
        torch.ones((64, 64)) @ torch.ones((64, 64))
    assert path.parent == tmp_path / "trace" and path.exists()
    events = json.loads(path.read_text())["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)


def _draw_inputs():
    """tests/test_viewer_profiling.py's image and keypoints, and a larger
    seeded case with keypoints near and past the border."""
    img = np.full((64, 96), 100, np.uint8)
    xy = np.array([[20.0, 30.0], [50.0, 10.0], [90.0, 60.0]])
    yield img, xy, np.array([True, True, False]), np.array([True, False, False]), "OK"
    rng = np.random.default_rng(0)
    img = rng.integers(0, 255, (120, 200), dtype=np.uint8)
    xy = rng.uniform(-5, 205, (300, 2))
    yield img, xy, rng.random(300) > 0.2, rng.random(300) > 0.5, "lost k9"


@pytest.mark.parametrize("case", [0, 1])
def test_draw_frame_bit_equal(case):
    img, xy, valid, tracked, text = list(_draw_inputs())[case]
    for tr, tx in ((tracked, text), (None, None)):
        got = tview.draw_frame(img, xy, valid, tr, state_text=tx)
        ref = jview.draw_frame(img, xy, valid, tr, state_text=tx)
        assert got.dtype == ref.dtype == np.uint8 and np.array_equal(got, ref)


@pytest.mark.parametrize("colors", [False, True])
def test_save_ply_byte_equal(tmp_path, colors):
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(17, 3)).astype(np.float32)
    col = rng.integers(0, 255, (17, 3), dtype=np.uint8) if colors else None
    tview.save_ply(str(tmp_path / "t.ply"), pts, col)
    jview.save_ply(str(tmp_path / "j.ply"), pts, col)
    assert (tmp_path / "t.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()


@pytest.fixture(scope="module")
def profiled_system():
    """A port System with ``profile=True`` after 6 SMALL frames."""
    cfg = dataclasses.replace(small_config(tcfg), profile=True)
    slam = tsys.System(cfg, "cpu")
    for fr in small_sequence(6)[:6]:
        slam.track(fr.img_l, fr.img_r, fr.t, fr.scan, fr.scan_valid)
    slam.flush_mapping()
    return slam


def test_system_timer_follows_cfg_profile(profiled_system):
    """``System`` builds its timer with ``enabled=cfg.profile``: the
    default (off) records nothing, on records every frame."""
    stats = profiled_system.timers.stats()
    assert stats["frame"]["n"] == 6 and stats["track_step"]["n"] == 5
    assert "local_ba" in stats and stats["frame"]["total_s"] > 0.0
    off = tsys.System(small_config(tcfg), "cpu")
    assert not off.cfg.profile and not off.timers.enabled
    fr = small_sequence(6)[0]
    off.track(fr.img_l, fr.img_r, fr.t, fr.scan, fr.scan_valid)
    assert off.timers.stats() == {}


def _ply_points(path) -> np.ndarray:
    lines = open(path).read().splitlines()
    return np.loadtxt(lines[lines.index("end_header") + 1:], ndmin=2).reshape(-1, 3)


def _vertex_count(path) -> int:
    return int(open(path).read().splitlines()[2].split()[-1])


@pytest.mark.parametrize("which", ["map_points", "lidar_map", "lidar_map_cut", "keyframe_path"])
def test_exporters_on_a_port_system(profiled_system, tmp_path, which):
    """Each exporter on the port System: the vertex count it must have, its
    coordinates to 1e-4 (the writer's ``%.4f``), and the same file as the
    reference's exporter writes from the same System's arrays."""
    slam = profiled_system
    fn, kw = {"map_points": ("export_map_points", {}),
              "lidar_map": ("export_lidar_map", {}),
              "lidar_map_cut": ("export_lidar_map", {"max_points": 500}),
              "keyframe_path": ("export_keyframe_path", {})}[which]
    got, ref = str(tmp_path / "t.ply"), str(tmp_path / "j.ply")
    getattr(tview, fn)(slam, got, **kw)
    getattr(jview, fn)(slam, ref, **kw)
    assert open(got).read() == open(ref).read()
    if which == "map_points":
        want = slam.map.lm_pos[slam.map.lm_valid].numpy()
        assert len(want) == int(slam.map.lm_valid.sum()) > 0
    elif which == "keyframe_path":
        T = slam.map.kf_T_cw[:slam.n_kf_host]
        want = torch.linalg.inv(T)[:, :3, 3].numpy()
        assert len(want) == slam.n_kf_host >= 2
    else:
        stored = slam.vmap.points[slam.vmap.keys != voxel_map.EMPTY_KEY].numpy()
        assert len(stored) == int(slam.vmap.count) > 500
        want = stored[np.linspace(0, len(stored) - 1, 500).astype(int)] if kw else stored
    assert _vertex_count(got) == len(want)
    np.testing.assert_allclose(_ply_points(got), want, atol=1e-4, rtol=0)


def test_export_lidar_map_refuses_a_system_without_lidar():
    slam = tsys.System(small_config(tcfg, lidar=False), "cpu")
    with pytest.raises(ValueError, match="LiDAR disabled"):
        tview.export_lidar_map(slam, "unused.ply")
