"""Visualization exporters: annotated frames, map point clouds, paths (port
of ``tc2li_slam_tpu/slam/viewer.py``).

The reference publishes its state to rviz (``RvizViewer``, Viewer.cc:134-330:
tracked/all map points as PointCloud2, KF + frame paths, pose TF, annotated
tracking image from ``FrameDrawer::DrawFrame``). Without ROS the same
artifacts are written as files: PLY point clouds (any viewer opens them),
annotated RGB frames as arrays, and the keyframe path. The drawing and the
writer are numpy; each exporter reads the port's ``System`` with one
device-to-host copy.
"""

from __future__ import annotations

import numpy as np

from ..ops import voxel_map


# ---------------------------------------------------------------------------
# Annotated tracking image (FrameDrawer::DrawFrame)
# ---------------------------------------------------------------------------

def draw_frame(
    img: np.ndarray,            # [H, W] uint8 grayscale
    kp_xy: np.ndarray,          # [F, 2]
    kp_valid: np.ndarray,       # [F]
    kp_tracked: np.ndarray | None = None,   # [F] matched to a landmark
    state_text: str | None = None,
) -> np.ndarray:
    """Return an RGB uint8 image with keypoints drawn: green boxes for
    tracked features, blue for detected-only (the reference's color scheme,
    FrameDrawer.cc)."""
    H, W = img.shape
    out = np.stack([img, img, img], axis=-1).astype(np.uint8)
    xy = np.asarray(kp_xy)
    valid = np.asarray(kp_valid).astype(bool)
    tracked = (
        np.asarray(kp_tracked).astype(bool)
        if kp_tracked is not None else np.zeros(len(xy), bool)
    )
    r = 2
    for i in np.flatnonzero(valid):
        u, v = int(round(xy[i, 0])), int(round(xy[i, 1]))
        if not (r <= u < W - r and r <= v < H - r):
            continue
        color = (0, 255, 0) if tracked[i] else (80, 80, 255)
        out[v - r:v + r + 1, [u - r, u + r]] = color
        out[[v - r, v + r], u - r:u + r + 1] = color
    if state_text:
        _stamp_text(out, state_text)
    return out


_FONT3x5 = {  # minimal 3x5 bitmap digits/letters for the status line
    c: np.array(bits, bool).reshape(5, 3)
    for c, bits in {
        "O": [1,1,1,1,0,1,1,0,1,1,0,1,1,1,1],
        "K": [1,0,1,1,0,1,1,1,0,1,0,1,1,0,1],
        "L": [1,0,0,1,0,0,1,0,0,1,0,0,1,1,1],
        "S": [1,1,1,1,0,0,1,1,1,0,0,1,1,1,1],
        "T": [1,1,1,0,1,0,0,1,0,0,1,0,0,1,0],
        " ": [0]*15,
    }.items()
}


def _stamp_text(img: np.ndarray, text: str, scale: int = 3):
    y0, x = 4, 4
    for ch in text.upper():
        glyph = _FONT3x5.get(ch)
        if glyph is None:
            x += 4 * scale
            continue
        g = np.kron(glyph, np.ones((scale, scale), bool))
        h, w = g.shape
        if x + w >= img.shape[1]:
            break
        img[y0:y0 + h, x:x + w][g] = (255, 220, 0)
        x += w + scale


# ---------------------------------------------------------------------------
# PLY export (PointCloud2 analog)
# ---------------------------------------------------------------------------

def save_ply(path: str, points: np.ndarray, colors: np.ndarray | None = None):
    """ASCII PLY writer for [N, 3] points (+ optional [N, 3] uint8 colors)."""
    pts = np.asarray(points, np.float32)
    n = len(pts)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {n}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if colors is not None:
            f.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
        f.write("end_header\n")
        if colors is None:
            for p in pts:
                f.write(f"{p[0]:.4f} {p[1]:.4f} {p[2]:.4f}\n")
        else:
            for p, c in zip(pts, np.asarray(colors, np.uint8)):
                f.write(f"{p[0]:.4f} {p[1]:.4f} {p[2]:.4f} {c[0]} {c[1]} {c[2]}\n")


def export_map_points(slam, path: str):
    """All valid landmarks as a PLY (the all-map-points topic)."""
    m = slam.map
    save_ply(path, m.lm_pos[m.lm_valid].cpu().numpy())


def export_lidar_map(slam, path: str, max_points: int | None = None):
    """The LiDAR voxel map's stored points as a PLY."""
    if slam.vmap is None:
        raise ValueError("LiDAR disabled")
    vm = slam.vmap
    pts = vm.points[vm.keys != voxel_map.EMPTY_KEY].cpu().numpy()
    if max_points is not None and len(pts) > max_points:
        sel = np.linspace(0, len(pts) - 1, max_points).astype(int)
        pts = pts[sel]
    save_ply(path, pts)


def export_keyframe_path(slam, path: str):
    """Keyframe trajectory as a PLY polyline-ish point set (KF path topic)."""
    n = slam.n_kf_host
    kf_T = slam.map.kf_T_cw[:n].cpu().numpy()
    centers = np.stack([
        -kf_T[i, :3, :3].T @ kf_T[i, :3, 3] for i in range(n)
    ]) if n else np.zeros((0, 3))
    save_ply(path, centers)
