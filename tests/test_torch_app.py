"""The application layer of tc2li_slam_torch against the JAX package's:
settings, evaluation, the KITTI loader and the native reader (copies: equal
outputs), rectification maps and ``remap_bilinear``, the KB8 camera and the
pinhole helpers (to 1e-5 unless stated), and ``examples/run_kitti_torch.py``
on a few SMALL frames written in the KITTI layout."""

import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tc2li_slam_tpu.geom import camera as jcam, rectify as jrect
from tc2li_slam_tpu.io import kitti as jkitti, native as jnative
from tc2li_slam_tpu.slam import evaluate as jeval, settings as jset
from tc2li_slam_torch.geom import camera as tcam, rectify as trect
from tc2li_slam_torch.io import kitti as tkitti, native as tnative
from tc2li_slam_torch.io.synthetic import so3_exp_np
from tc2li_slam_torch.slam import evaluate as teval, settings as tset, trajectory as ttraj
from test_kitti_app import write_kitti_sequence
from test_settings_eval import ROSPARAM_YAML, SETTINGS_YAML
from torch_parity import n, random_poses, t

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

UNRECTIFIED_YAML = SETTINGS_YAML + """
Camera1.fx: 260.0
Camera1.fy: 258.0
Camera1.cx: 158.0
Camera1.cy: 122.0
Camera1.k1: -0.28
Camera1.k2: 0.07
Camera1.p1: 0.001
Camera1.p2: -0.0005
Camera2.fx: 255.0
Camera2.fy: 256.0
Camera2.cx: 162.0
Camera2.cy: 118.0
Camera2.k1: -0.25
Camera2.k2: 0.06
Camera2.p1: -0.0008
Camera2.p2: 0.0006
Stereo.T_c1_c2: !!opencv-matrix
  rows: 4
  cols: 4
  dt: f
  data: [ 0.9997, -0.0150, -0.0199, 0.54,
          0.0148, 0.9998, -0.0101, -0.004,
          0.0200, 0.0098, 0.9997, -0.01,
          0.0, 0.0, 0.0, 1.0 ]
"""


def _same_config(a, b):
    for part in ("camera", "orb", "imu", "lidar", "tracking"):
        da, db = vars(getattr(a, part)), vars(getattr(b, part))
        assert da.keys() == db.keys()
        for k in da:
            np.testing.assert_array_equal(np.asarray(da[k]), np.asarray(db[k]), err_msg=f"{part}.{k}")
    assert (a.use_imu, a.loop_closing, a.loop_min_gap) == (b.use_imu, b.loop_closing, b.loop_min_gap)


def test_settings_match_jax(tmp_path):
    """Both parsers on the same files: the same flat dictionary, the same
    configuration tree, overrides included."""
    p, r = tmp_path / "kitti.yaml", tmp_path / "lidar.yaml"
    p.write_text(SETTINGS_YAML)
    r.write_text(ROSPARAM_YAML)
    dj, dt = jset.parse_opencv_yaml(str(p)), tset.parse_opencv_yaml(str(p))
    assert dj.keys() == dt.keys()
    for k in dj:
        np.testing.assert_array_equal(np.asarray(dj[k]), np.asarray(dt[k]), err_msg=k)
    rj, rt = jset.parse_rosparam_yaml(str(r)), tset.parse_rosparam_yaml(str(r))
    assert rj.keys() == rt.keys() and rt["preprocess.blind"] == 2
    cj = jset.load_settings(str(p), str(r), tracking=dict(max_kf=256), loop_closing=True)
    ct = tset.load_settings(str(p), str(r), tracking=dict(max_kf=256), loop_closing=True)
    _same_config(cj, ct)
    assert ct.use_imu and ct.loop_closing and ct.tracking.max_kf == 256
    assert ct.camera.fx == pytest.approx(707.0912) and ct.lidar.blind == 2.0
    assert tset.build_rectifier(str(p)) is None


def test_build_rectifier_matches_jax(tmp_path):
    """An unrectified rig in the settings: the same rotations, projections
    and maps (1e-4 px) as the JAX package builds, kept on the device asked."""
    p = tmp_path / "rig.yaml"
    p.write_text(UNRECTIFIED_YAML)
    rj, rt = jset.build_rectifier(str(p)), tset.build_rectifier(str(p), device="cpu")
    assert isinstance(rt, trect.StereoRectifier) and rt.map1.device.type == "cpu"
    for a in ("R1", "R2", "P1", "P2"):
        np.testing.assert_allclose(getattr(rt, a), getattr(rj, a), atol=1e-12)
    np.testing.assert_allclose(n(rt.map1), np.asarray(rj.map1), atol=1e-4)
    np.testing.assert_allclose(n(rt.map2), np.asarray(rj.map2), atol=1e-4)
    assert rt.cam_params() == rj.cam_params() and rt.map1.dtype == torch.float32


@pytest.mark.parametrize("model", ["radtan", "equidistant"])
def test_rectify_and_remap_match_jax(rng, model):
    """``stereo_rectify`` and ``rectify_map`` are numpy in both (equal);
    ``remap_bilinear`` on the device to 1e-4 grey levels, border clamped,
    uint8 and float input."""
    W, H = 160, 120
    K1 = np.array([[130.0, 0, 79.0], [0, 129.0, 61.0], [0, 0, 1]])
    K2 = np.array([[128.0, 0, 81.0], [0, 128.0, 59.0], [0, 0, 1]])
    D1 = np.array([-0.2, 0.05, 1e-3, -5e-4, 0.0] if model == "radtan" else [0.02, -0.01, 0.003, 0.0])
    D2 = np.array([-0.18, 0.04, -8e-4, 6e-4, 0.0] if model == "radtan" else [0.015, -0.008, 0.002, 0.0])
    R = so3_exp_np(np.array([0.01, -0.02, 0.015]))
    tr = np.array([-0.54, 0.004, 0.01])
    outs_j = jrect.stereo_rectify(K1, D1, K2, D2, R, tr, (W, H))
    outs_t = trect.stereo_rectify(K1, D1, K2, D2, R, tr, (W, H))
    for a, b in zip(outs_t, outs_j):
        np.testing.assert_array_equal(a, b)
    mj = jrect.rectify_map(K1, D1, outs_j[0], outs_j[2], (W, H), model)
    mt = trect.rectify_map(K1, D1, outs_t[0], outs_t[2], (W, H), model)
    np.testing.assert_array_equal(mt, mj)
    assert mt.shape == (H, W, 2) and mt.dtype == np.float32
    with pytest.raises(ValueError):
        trect.rectify_map(K1, D1, outs_t[0], outs_t[2], (W, H), "other")
    img = rng.integers(0, 255, (H, W), dtype=np.uint8)
    mp = mt.copy()
    mp[:5] -= 30.0                      # samples outside the image: clamped
    mp[-5:, :, 0] += 400.0
    for im in (img, img.astype(np.float32) * 0.5):
        oj = np.asarray(jrect.remap_bilinear(jnp.asarray(im), jnp.asarray(mp)))
        ot = trect.remap_bilinear(t(im), t(mp))
        assert ot.dtype == torch.float32 and ot.shape == (H, W)
        np.testing.assert_allclose(n(ot), oj, atol=1e-4)
    rec_j = jrect.StereoRectifier(K1, D1, K2, D2, R, tr, (W, H), model=model)
    rec_t = trect.StereoRectifier(K1, D1, K2, D2, R, tr, (W, H), model=model)
    lj, rj = rec_j(img, img[:, ::-1].copy())
    lt, rt = rec_t(img, img[:, ::-1].copy())
    np.testing.assert_allclose(n(lt), np.asarray(lj), atol=1e-3)
    np.testing.assert_allclose(n(rt), np.asarray(rj), atol=1e-3)


KB8 = dict(fx=190.9, fy=190.9, cx=254.9, cy=256.9, k1=0.0034, k2=0.0007, k3=-0.002, k4=0.0002)


def _kb8_points(rng, k=200):
    p = np.stack([rng.uniform(-4, 4, k), rng.uniform(-3, 3, k), rng.uniform(0.5, 8, k)], -1)
    p[:10, 2] = rng.uniform(-0.5, 0.2, 10)       # beyond 90 degrees off the axis
    return p.astype(np.float32)


def test_kb8_project_unproject_match_jax(rng):
    """Projection to 1e-3 px (1e-5 relative), unprojection (10 Newton
    steps) to 1e-5, and the round trip back to the ray."""
    cj, ct = jcam.KannalaBrandt8.create(**KB8), tcam.KannalaBrandt8.create(**KB8)
    assert ct.k == tuple(float(v) for v in np.asarray(cj.k))
    p = _kb8_points(rng)
    p[20] = [0.0, 0.0, 2.0]                       # on the optical axis
    uv_j = np.asarray(jcam.kb8_project(cj, jnp.asarray(p)))
    uv_t = tcam.kb8_project(ct, t(p))
    assert uv_t.dtype == torch.float32
    np.testing.assert_allclose(n(uv_t), uv_j, atol=1e-3)
    np.testing.assert_allclose(n(uv_t)[20], [KB8["cx"], KB8["cy"]], atol=1e-4)
    uv = uv_j[10:]
    ray_j = np.asarray(jcam.kb8_unproject(cj, jnp.asarray(uv)))
    ray_t = n(tcam.kb8_unproject(ct, t(uv)))
    np.testing.assert_allclose(ray_t, ray_j, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(ray_t[:, :2], p[10:, :2] / p[10:, 2:], atol=2e-3, rtol=1e-3)
    assert np.asarray(jcam.kb8_unproject(cj, jnp.asarray(uv), iters=3)).shape == \
        n(tcam.kb8_unproject(ct, t(uv), iters=3)).shape


def test_kb8_project_jac_matches_autodiff(rng):
    """The closed-form Jacobian against the reference's forward-mode one,
    1e-4 relative to the largest entry (~1e2 px/m), batch shape kept."""
    cj, ct = jcam.KannalaBrandt8.create(**KB8), tcam.KannalaBrandt8.create(**KB8)
    p = _kb8_points(rng).reshape(20, 10, 3)
    Jj = np.asarray(jcam.kb8_project_jac(cj, jnp.asarray(p)))
    Jt = n(tcam.kb8_project_jac(ct, t(p)))
    assert Jt.shape == (20, 10, 2, 3)
    np.testing.assert_allclose(Jt, Jj, atol=1e-4 * np.abs(Jj).max(), rtol=1e-4)
    # against finite differences of the port's own projection, in float64
    q = torch.as_tensor(p.reshape(-1, 3)[10:20], dtype=torch.float64)
    eps = 1e-6
    for a in range(3):
        d = torch.zeros(3, dtype=torch.float64)
        d[a] = eps
        fd = (tcam.kb8_project(ct, q + d) - tcam.kb8_project(ct, q - d)) / (2 * eps)
        np.testing.assert_allclose(n(tcam.kb8_project_jac(ct, q))[..., a], n(fd), rtol=1e-5, atol=1e-5)
    on_axis = torch.tensor([[0.0, 0.0, 3.0]])
    assert float(tcam.kb8_project_jac(ct, on_axis).abs().max()) == 0.0


def test_kb8_triangulate_matches_jax(rng):
    """Two fisheye cameras 0.3 m apart: the same points (1e-3 m at ~5 m;
    the DLT's null vector comes from another solver) and the same verdicts
    on points with a clear margin; far and behind-camera points refused."""
    cj, ct = jcam.KannalaBrandt8.create(**KB8), tcam.KannalaBrandt8.create(**KB8)
    N = 120
    X1 = np.stack([rng.uniform(-3, 3, N), rng.uniform(-2, 2, N), rng.uniform(1.0, 6.0, N)],
                  -1).astype(np.float32)
    X1[:8, 2] = 400.0                              # no parallax
    T_21 = np.eye(4, dtype=np.float32)
    T_21[:3, 3] = [-0.3, 0.0, 0.0]
    X2 = X1 + T_21[:3, 3]
    uv1 = np.asarray(jcam.kb8_project(cj, jnp.asarray(X1)))
    uv2 = np.array(jcam.kb8_project(cj, jnp.asarray(X2)))
    uv2[8:16] += 25.0                              # wrong matches
    s2 = np.ones(N, np.float32)
    Pj, okj = jcam.kb8_triangulate_matches(cj, cj, jnp.asarray(uv1), jnp.asarray(uv2),
                                           jnp.asarray(T_21), jnp.asarray(s2), jnp.asarray(s2))
    Pt, okt = tcam.kb8_triangulate_matches(ct, ct, t(uv1), t(uv2), t(T_21), t(s2), t(s2))
    assert okt.dtype == torch.bool and Pt.shape == (N, 3)
    np.testing.assert_array_equal(n(okt), np.asarray(okj))
    good = n(okt)
    assert good[16:].mean() > 0.9 and not good[:16].any()
    np.testing.assert_allclose(n(Pt)[good], np.asarray(Pj)[good], atol=1e-3)
    np.testing.assert_allclose(n(Pt)[good], X1[good], atol=2e-2)


def test_pinhole_helpers_match_jax(rng):
    """``bearing``, ``project_jac`` and ``depth_from_disparity`` to 1e-5
    (1e-5 relative for the Jacobian)."""
    kw = dict(fx=450.0, fy=452.0, cx=320.0, cy=240.0, bf=45.0)
    cj, ct = jcam.Pinhole.create(**kw), tcam.Pinhole.create(**kw)
    uv = rng.uniform(0, 640, (50, 2)).astype(np.float32)
    np.testing.assert_allclose(n(tcam.bearing(ct, t(uv))),
                               np.asarray(jcam.bearing(cj, jnp.asarray(uv))), atol=1e-6)
    p = np.stack([rng.uniform(-5, 5, 50), rng.uniform(-3, 3, 50), rng.uniform(1, 30, 50)],
                 -1).astype(np.float32)
    Jj = np.asarray(jcam.project_jac(cj, jnp.asarray(p)))
    np.testing.assert_allclose(n(tcam.project_jac(ct, t(p))), Jj, rtol=1e-5, atol=1e-5)
    d = np.concatenate([rng.uniform(0.5, 80, 48), [0.0, -3.0]]).astype(np.float32)
    np.testing.assert_allclose(n(tcam.depth_from_disparity(ct, t(d))),
                               np.asarray(jcam.depth_from_disparity(cj, jnp.asarray(d))), rtol=1e-6)


def test_evaluate_matches_jax(rng):
    """ATE (SE3 and Sim3 alignment) and the KITTI relative errors: the
    copies return what the JAX package's module returns."""
    gt = np.tile(np.eye(4), (300, 1, 1))
    gt[:, 0, 3] = np.linspace(0, 450, 300)
    gt[:, 2, 3] = 5 * np.sin(np.linspace(0, 6, 300))
    W = random_poses(rng, 1, rot=0.5, trans=3.0)[0].astype(np.float64)
    est = W @ gt
    est[:, :3, 3] += rng.normal(0, 0.05, (300, 3))
    for ws in (False, True):
        assert teval.ate_rmse(est, gt, with_scale=ws) == jeval.ate_rmse(est, gt, with_scale=ws)
    assert teval.ate_rmse(est, gt) < 0.15
    ej, et = jeval.evaluate(est, gt), teval.evaluate(est, gt)
    assert ej.keys() == et.keys() and all(et[k] == ej[k] for k in ej)
    assert {"ate_rmse_m", "kitti_t_err_pct", "kitti_r_err_deg_per_m"} <= et.keys()
    Rj, tj, sj = jeval.umeyama_alignment(est[:, :3, 3], gt[:, :3, 3], True)
    Rt, tt, stt = teval.umeyama_alignment(est[:, :3, 3], gt[:, :3, 3], True)
    np.testing.assert_array_equal(Rt, Rj)
    assert stt == sj and np.array_equal(tt, tj)


@pytest.fixture(scope="module")
def kitti_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("kitti"))
    write_kitti_sequence(root, n_frames=6, n_scan=4096)
    return root


def test_kitti_loader_and_native_match_jax(kitti_root, tmp_path):
    """The loader and the velodyne reader (native library or numpy) return
    what the JAX package's copies return, on the same files."""
    sj = jkitti.KittiSequence(kitti_root, "99", n_scan=4096)
    st = tkitti.KittiSequence(kitti_root, "99", n_scan=4096)
    assert len(st) == len(sj) == 6 and st.calib.bf == sj.calib.bf
    for a, b in zip(st.calib, sj.calib):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(st.times, sj.times)
    np.testing.assert_array_equal(st.gt, sj.gt)
    fj, ft = sj.frame(2), st.frame(2)
    assert fj.keys() == ft.keys()
    for k in fj:
        np.testing.assert_array_equal(ft[k], fj[k], err_msg=k)
    assert ft["img_l"].dtype == np.uint8 and ft["scan_valid"].sum() > 1000
    assert tnative.available() == jnative.available()
    path = os.path.join(st.seq_dir, "velodyne", "000001.bin")
    for a, b in zip(tnative.read_velodyne(path, 2048), jnative.read_velodyne(path, 2048)):
        np.testing.assert_array_equal(a, b)
    pre = tnative.ScanPrefetcher([path], n_max=4096)
    xyz, times, valid, cnt = pre.get(0)
    pre.close()
    np.testing.assert_array_equal(xyz, tnative.read_velodyne(path, 4096)[0])
    assert cnt == int(valid.sum()) and times.shape == (4096,)
    T = random_poses(np.random.default_rng(0), 5)
    tnative.write_kitti_trajectory(str(tmp_path / "a.txt"), T)
    jnative.write_kitti_trajectory(str(tmp_path / "b.txt"), T)
    np.testing.assert_allclose(ttraj.load_kitti(str(tmp_path / "a.txt")), T, atol=1e-6)
    assert (tmp_path / "a.txt").read_text() == (tmp_path / "b.txt").read_text()
    with pytest.raises(FileNotFoundError):
        tkitti.load_image(st.seq_dir, 0, 99)


def test_run_kitti_torch_end_to_end(kitti_root, tmp_path):
    """``examples/run_kitti_torch.py --device cpu`` on 6 SMALL frames in the
    KITTI layout: the JSON result line with the reference entry's keys, ATE
    below 0.5 m, both trajectory files. Without a card the default device
    is refused, not replaced."""
    out = str(tmp_path / "results")
    script = os.path.join(REPO, "examples", "run_kitti_torch.py")
    args = [sys.executable, script, "--root", kitti_root, "--seq", "99", "--out", out,
            "--features", "512", "--n-scan", "4096", "--max-kf", "64"]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.run(args + ["--device", "cpu"], capture_output=True, text=True,
                          timeout=900, env=env, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert set(result) == {"seq", "frames", "fps", "keyframes", "trajectory", "ate_rmse_m",
                           "kitti_t_err_pct", "kitti_r_err_deg_per_m"}
    assert result["frames"] == 6 and result["keyframes"] >= 2 and result["ate_rmse_m"] < 0.5
    assert np.loadtxt(os.path.join(out, "99.txt")).shape == (6, 12)
    assert np.loadtxt(os.path.join(out, "99_tum.txt")).shape == (6, 8)
    stages = json.loads(proc.stderr.strip().splitlines()[-1])
    assert "track_step" in stages and stages["frame"]["count"] == 6
    if not torch.cuda.is_available():
        proc = subprocess.run(args, capture_output=True, text=True, timeout=300, env=env, cwd=REPO)
        assert proc.returncode == 2 and "no CUDA device" in proc.stderr and not proc.stdout.strip()
    proc = subprocess.run(args + ["--loop-closing"], capture_output=True, text=True, timeout=300,
                          env=env, cwd=REPO)
    assert proc.returncode == 2 and "--loop-closing requires --voc" in proc.stderr
