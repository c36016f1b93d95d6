"""Synthetic stereo + LiDAR + IMU sequence generator.

Stands in for KITTI in tests and benchmarks (no dataset ships with this
environment): a plane-rich world decorated with point "texture dots" is
rendered into stereo pairs (dots become corner features ORB can track),
sampled into LiDAR scans, and differentiated into exact IMU measurements
along an analytic trajectory. Ground truth poses come with every frame, so
end-to-end ATE is measurable offline exactly like the reference's
KITTI-devkit evaluation flow.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

GRAVITY = np.array([0.0, 0.0, -9.81])


def so3_exp_np(w):
    th = np.linalg.norm(w)
    if th < 1e-12:
        return np.eye(3)
    k = w / th
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K


class CameraRig(NamedTuple):
    fx: float
    fy: float
    cx: float
    cy: float
    baseline: float
    width: int
    height: int

    @property
    def bf(self):
        return self.fx * self.baseline


KITTI_LIKE = CameraRig(fx=718.856, fy=718.856, cx=607.19, cy=185.2,
                       baseline=0.537, width=1241, height=376)
SMALL = CameraRig(fx=320.0, fy=320.0, cx=320.0, cy=120.0,
                  baseline=0.5, width=640, height=240)


class Plane(NamedTuple):
    p0: np.ndarray      # [3] a point on the plane
    n: np.ndarray       # [3] unit normal
    ax_u: np.ndarray    # [3] in-plane axis (texture u)
    ax_v: np.ndarray    # [3] in-plane axis (texture v)
    lim_u: tuple        # (min, max) extent along ax_u
    lim_v: tuple
    seed: int


class World(NamedTuple):
    planes: list        # list[Plane] textured surfaces (render + LiDAR)
    surf: np.ndarray    # [S, 3] LiDAR sample points on the surfaces


def _hash01(ix, iy, seed):
    """Integer lattice hash -> [0, 1) floats, vectorized (value-noise base)."""
    h = (ix.astype(np.uint64) * np.uint64(374761393)
         + iy.astype(np.uint64) * np.uint64(668265263)
         + np.uint64(seed) * np.uint64(1442695040888963))
    h = (h ^ (h >> np.uint64(13))) * np.uint64(1274126177)
    h = h ^ (h >> np.uint64(16))
    return (h & np.uint64(0xFFFFFF)).astype(np.float64) / float(0x1000000)


def _value_noise(u, v, scale, seed):
    """Bilinear value noise at lattice pitch ``scale`` meters."""
    x = u / scale
    y = v / scale
    x0 = np.floor(x); y0 = np.floor(y)
    fx = x - x0; fy = y - y0
    fx = fx * fx * (3 - 2 * fx)   # smoothstep for C1 continuity
    fy = fy * fy * (3 - 2 * fy)
    n00 = _hash01(x0, y0, seed)
    n10 = _hash01(x0 + 1, y0, seed)
    n01 = _hash01(x0, y0 + 1, seed)
    n11 = _hash01(x0 + 1, y0 + 1, seed)
    return (n00 * (1 - fx) * (1 - fy) + n10 * fx * (1 - fy)
            + n01 * (1 - fx) * fy + n11 * fx * fy)


def _texture(u, v, seed):
    """Multi-octave surface texture in [0, 255] — view-consistent because it
    is a pure function of the surface point (this is what makes ORB
    descriptors repeatable across frames, unlike splatted sprites)."""
    t = (0.45 * _value_noise(u, v, 0.9, seed)
         + 0.35 * _value_noise(u, v, 0.35, seed + 1)
         + 0.20 * _value_noise(u, v, 0.13, seed + 2))
    return 25.0 + 215.0 * t


def make_world(rng, extent=60.0, n_dots=None, n_surf=24000) -> World:
    """Street-like scene: road strip + corridor walls + far walls, all as
    textured planes (rendered by ray casting; LiDAR samples the same
    surfaces so camera and LiDAR observe identical geometry)."""
    ex = np.array([1.0, 0, 0]); ey = np.array([0, 1.0, 0]); ez = np.array([0, 0, 1.0])
    planes = [
        # ground
        Plane(np.zeros(3), ez, ex, ey, (-extent, extent + 40), (-extent, extent), 7),
        # corridor walls
        Plane(np.array([0, -8.0, 0]), ey, ex, ez, (-12, extent + 40), (0, 5.0), 11),
        Plane(np.array([0, 8.0, 0]), -ey, ex, ez, (-12, extent + 40), (0, 5.0), 13),
        # far cross walls
        Plane(np.array([extent + 40, 0, 0]), -ex, ey, ez, (-extent, extent), (0, 8.0), 17),
        Plane(np.array([-12.0, 0, 0]), ex, ey, ez, (-extent, extent), (0, 8.0), 19),
    ]
    # LiDAR surf samples on the planes
    pts = []
    per = n_surf // len(planes)
    for p in planes:
        uu = rng.uniform(p.lim_u[0], p.lim_u[1], per)
        vv = rng.uniform(p.lim_v[0], p.lim_v[1], per)
        pts.append(p.p0 + uu[:, None] * p.ax_u + vv[:, None] * p.ax_v)
    return World(planes=planes, surf=np.concatenate(pts).astype(np.float32))


class Trajectory:
    """R(t) = Exp(w t); p(t) = p0 + v t — constant world velocity with
    optional turn rate, exact IMU."""

    def __init__(self, w_body=(0.0, 0.0, 0.04), v_world=(2.0, 0.2, 0.0), z0=1.6):
        self.w = np.asarray(w_body, np.float64)
        self.v = np.asarray(v_world, np.float64)
        self.p0 = np.array([0.0, 0.0, z0])

    def pose(self, t):
        """World-from-body (x forward, y left, z up)."""
        return so3_exp_np(self.w * t), self.p0 + self.v * t

    def imu(self, t):
        R, _ = self.pose(t)
        return self.w.copy(), R.T @ (-GRAVITY)


class CircleTrajectory:
    """Constant yaw rate + body-frame forward speed -> exact circle.

    Closed-form kinematics (exact IMU incl. centripetal specific force);
    used by the loop-closure tests: the platform revisits its start."""

    def __init__(self, omega=0.5, speed=2.0, z0=1.6, y0=None):
        self.w = np.asarray([0.0, 0.0, omega], np.float64)
        self.v_body = np.asarray([speed, 0.0, 0.0], np.float64)
        # default start: circle centered on y=0 (radius below the corridor
        # half-width) — starting at y=0 would graze the wall at y = 2r
        r = speed / max(abs(omega), 1e-9)
        self.p0 = np.array([0.0, -r if y0 is None else y0, z0])

    def pose(self, t):
        R = so3_exp_np(self.w * t)
        om = self.w[2]
        s = self.v_body[0]
        if abs(om) < 1e-9:
            p = self.p0 + np.array([s * t, 0.0, 0.0])
        else:
            p = self.p0 + np.array(
                [s / om * np.sin(om * t), s / om * (1.0 - np.cos(om * t)), 0.0]
            )
        return R, p

    def imu(self, t):
        R, _ = self.pose(t)
        a_w = np.cross(self.w, R @ self.v_body)   # centripetal
        return self.w.copy(), R.T @ (a_w - GRAVITY)


# Camera mounted looking along body +x: camera frame z=forward, x=right, y=down.
R_BC = np.array([
    [0.0, -1.0, 0.0],   # cam x = -body y (right)
    [0.0, 0.0, -1.0],   # cam y = -body z (down)
    [1.0, 0.0, 0.0],    # cam z =  body x (forward)
], np.float64).T  # body-from-camera rotation


def body_from_cam() -> np.ndarray:
    T = np.eye(4)
    T[:3, :3] = R_BC
    return T


def render_stereo(world: World, cam: CameraRig, T_wb: np.ndarray, rng=None):
    """Ray-cast the textured planes into a rectified stereo pair.

    Exact pinhole geometry per pixel; the texture is attached to the
    surfaces, so feature descriptors repeat across viewpoints (required for
    BoW/relocalization) and stereo disparity is subpixel-exact.
    """
    T_wc = T_wb @ body_from_cam()
    R = T_wc[:3, :3]
    H, W = cam.height, cam.width
    uu, vv = np.meshgrid(np.arange(W, dtype=np.float64),
                         np.arange(H, dtype=np.float64))
    dirs_c = np.stack([(uu - cam.cx) / cam.fx, (vv - cam.cy) / cam.fy,
                       np.ones_like(uu)], axis=-1)          # [H, W, 3]
    dirs_w = dirs_c @ R.T                                    # [H, W, 3]
    imgs = []
    for side in range(2):
        o = T_wc[:3, 3] + R @ np.array([side * cam.baseline, 0.0, 0.0])
        best_t = np.full((H, W), np.inf)
        img = np.full((H, W), 18.0)
        for p in world.planes:
            denom = dirs_w @ p.n
            denom = np.where(np.abs(denom) < 1e-9, 1e-9, denom)
            t = ((p.p0 - o) @ p.n) / denom
            hit = o + t[..., None] * dirs_w
            pu = (hit - p.p0) @ p.ax_u
            pv = (hit - p.p0) @ p.ax_v
            ok = ((t > 0.3) & (t < best_t)
                  & (pu >= p.lim_u[0]) & (pu <= p.lim_u[1])
                  & (pv >= p.lim_v[0]) & (pv <= p.lim_v[1]))
            tex = _texture(pu, pv, p.seed)
            img = np.where(ok, tex, img)
            best_t = np.where(ok, t, best_t)
        imgs.append(np.clip(img, 0, 255).astype(np.uint8))
    return imgs[0], imgs[1]


def lidar_scan(world: World, T_wb: np.ndarray, rng, max_range=60.0,
               n_max=4096, noise=0.015, T_bl: np.ndarray | None = None):
    """Surf points near the sensor, in the LiDAR frame, padded."""
    if T_bl is None:
        T_bl = np.eye(4)
    T_wl = T_wb @ T_bl
    R, t = T_wl[:3, :3], T_wl[:3, 3]
    d = np.linalg.norm(world.surf - t, axis=-1)
    sel = np.nonzero(d < max_range)[0]
    if len(sel) > n_max:
        sel = rng.choice(sel, n_max, replace=False)
    pw = world.surf[sel] + rng.normal(0, noise, (len(sel), 3))
    pl = (pw - t) @ R
    out = np.zeros((n_max, 3), np.float32)
    out[: len(pl)] = pl
    valid = np.zeros(n_max, bool)
    valid[: len(pl)] = True
    return out, valid


def imu_window(traj: Trajectory, t0, t1, rate=100.0, n_max=32,
               noise_g=0.0, noise_a=0.0, rng=None):
    """Padded IMU samples covering (t0, t1]."""
    ts = np.arange(np.ceil(t0 * rate), np.floor(t1 * rate) + 1) / rate
    ts = ts[(ts > t0) & (ts <= t1)]
    gyro = np.zeros((n_max, 3), np.float32)
    acc = np.zeros((n_max, 3), np.float32)
    dts = np.zeros(n_max, np.float32)
    trel = np.full(n_max, np.inf, np.float32)
    prev = t0
    k = 0
    for t in ts[:n_max]:
        g, a = traj.imu(t)
        if rng is not None:
            g = g + rng.normal(0, noise_g, 3)
            a = a + rng.normal(0, noise_a, 3)
        gyro[k], acc[k], dts[k], trel[k] = g, a, t - prev, t - t0
        prev = t
        k += 1
    if k < n_max and prev < t1 - 1e-9:
        g, a = traj.imu(t1)
        gyro[k], acc[k], dts[k], trel[k] = g, a, t1 - prev, t1 - t0
    return gyro, acc, dts, trel


class FrameData(NamedTuple):
    t: float
    img_l: np.ndarray
    img_r: np.ndarray
    scan: np.ndarray
    scan_valid: np.ndarray
    scan_times: np.ndarray
    gyro: np.ndarray
    acc: np.ndarray
    imu_dts: np.ndarray
    imu_trel: np.ndarray
    T_wb_gt: np.ndarray


def trajectory_poses(traj, n_frames: int, fps: float = 10.0) -> list:
    """World-from-body poses [4, 4] of ``n_frames`` frames at ``fps``."""
    poses = []
    for i in range(n_frames):
        R, p = traj.pose(i / fps)
        T_wb = np.eye(4)
        T_wb[:3, :3] = R
        T_wb[:3, 3] = p
        poses.append(T_wb)
    return poses


def generate_sequence(
    n_frames=30, fps=10.0, cam: CameraRig = SMALL, seed=0,
    traj: Trajectory | None = None, world: World | None = None,
    lidar_noise=0.015, n_scan=4096, stereo_pairs=None,
):
    """Yield FrameData for a full synthetic run (deterministic per seed).
    ``stereo_pairs`` takes the (img_l, img_r) of each frame rendered
    beforehand (``render_stereo`` at ``trajectory_poses``, which draws no
    random number), for callers that render in several processes."""
    rng = np.random.default_rng(seed)
    world = world or make_world(rng)
    traj = traj or Trajectory()
    dt = 1.0 / fps
    frames = []
    for i, T_wb in enumerate(trajectory_poses(traj, n_frames, fps)):
        t = i * dt
        img_l, img_r = (render_stereo(world, cam, T_wb, rng) if stereo_pairs is None
                        else stereo_pairs[i])
        scan, sv = lidar_scan(world, T_wb, rng, noise=lidar_noise, n_max=n_scan)
        gyro, acc, dts, trel = imu_window(traj, max(t - dt, 0.0), t) if i else (
            np.zeros((32, 3), np.float32), np.zeros((32, 3), np.float32),
            np.zeros(32, np.float32), np.full(32, np.inf, np.float32),
        )
        frames.append(FrameData(
            t=t, img_l=img_l, img_r=img_r, scan=scan, scan_valid=sv,
            scan_times=np.full(n_scan, 0.0, np.float32),
            gyro=gyro, acc=acc, imu_dts=dts, imu_trel=trel, T_wb_gt=T_wb,
        ))
    return frames, world, traj


def ate_rmse(T_est: np.ndarray, T_gt: np.ndarray) -> float:
    """Absolute trajectory error after SE3 (Umeyama, no scale) alignment —
    the KITTI-devkit/evo metric the reference is judged by."""
    p_est = T_est[:, :3, 3]
    p_gt = T_gt[:, :3, 3]
    mu_e = p_est.mean(0)
    mu_g = p_gt.mean(0)
    E = (p_est - mu_e).T @ (p_gt - mu_g)
    U, _, Vt = np.linalg.svd(E)
    S = np.eye(3)
    if np.linalg.det(U @ Vt) < 0:
        S[2, 2] = -1
    R = Vt.T @ S @ U.T
    t = mu_g - R @ mu_e
    p_al = p_est @ R.T + t
    return float(np.sqrt(np.mean(np.sum((p_al - p_gt) ** 2, axis=-1))))
