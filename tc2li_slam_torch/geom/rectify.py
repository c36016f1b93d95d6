"""Stereo rectification: Bouguet alignment + undistort-rectify remapping
(port of ``tc2li_slam_tpu/geom/rectify.py``).

The reference precomputes cv::initUndistortRectifyMap pairs at startup
(Settings::precomputeRectificationMaps) and remaps both images per frame
when the rig needs it. The same split here:

- host, once (numpy): ``stereo_rectify`` (Bouguet's algorithm: split the
  inter-camera rotation, align the baseline with the rectified x-axis) and
  ``rectify_map`` (per-pixel source coordinates through the inverse
  rectification + the radtan or equidistant distortion model);
- device, per frame: ``remap_bilinear``, a gather and a lerp.

Distortion models: radtan (k1 k2 p1 p2 [k3]) for ``Pinhole`` cameras, and
equidistant (k1..k4) for ``KannalaBrandt8``. As in the JAX package, the
frame path of ``System`` does not apply a rectifier: the application hands
it rectified pairs.
"""

from __future__ import annotations

import numpy as np
import torch


def _rodrigues(r: np.ndarray) -> np.ndarray:
    th = np.linalg.norm(r)
    if th < 1e-12:
        return np.eye(3)
    k = r / th
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K


def _log_so3(R: np.ndarray) -> np.ndarray:
    c = np.clip((np.trace(R) - 1) / 2, -1.0, 1.0)
    th = np.arccos(c)
    if th < 1e-12:
        return np.zeros(3)
    w = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    return th / (2 * np.sin(th)) * w


def stereo_rectify(K1, D1, K2, D2, R, t, size, alpha: float = 0.0):
    """Bouguet stereo rectification (cv::stereoRectify semantics).

    ``R, t``: camera-2-from-camera-1 transform. Returns (R1, R2, P1, P2):
    per-camera rectifying rotations and the shared-intrinsics projection
    matrices (P2 carries the baseline term), pixel-aligned rows.
    """
    K1, K2, R = np.asarray(K1, float), np.asarray(K2, float), np.asarray(R, float)
    t = np.asarray(t, float).reshape(3)
    W, H = size
    # split the relative rotation evenly between the two views: with
    # R1 = R_row exp(r/2) and R2 = R_row exp(-r/2), R2 @ R == R1, so the
    # two rectified frames share one orientation (row alignment)
    r = _log_so3(R)
    R_half1 = _rodrigues(0.5 * r)
    R_half2 = _rodrigues(-0.5 * r)
    t_rect = R_half2 @ t
    # baseline alignment: rectified x-axis along the (negated) baseline
    e1 = t_rect / np.linalg.norm(t_rect)
    if e1[0] < 0:
        e1 = -e1
    e2 = np.cross(np.array([0.0, 0.0, 1.0]), e1)
    n2 = np.linalg.norm(e2)
    e2 = e2 / n2 if n2 > 1e-12 else np.array([0.0, 1.0, 0.0])
    e3 = np.cross(e1, e2)
    R_row = np.stack([e1, e2, e3])
    R1 = R_row @ R_half1
    R2 = R_row @ R_half2
    # shared pinhole intrinsics: geometric mean focal, centered principal pt
    f = 0.5 * (K1[0, 0] + K2[0, 0])
    cx, cy = (W - 1) / 2.0, (H - 1) / 2.0
    del alpha  # crop-free (alpha=0) behavior
    P1 = np.array([[f, 0, cx, 0], [0, f, cy, 0], [0, 0, 1, 0]])
    baseline = np.linalg.norm(t)
    P2 = P1.copy()
    P2[0, 3] = -f * baseline
    return R1, R2, P1, P2


def _distort_radtan(x, y, D):
    k1, k2, p1, p2 = D[0], D[1], D[2], D[3]
    k3 = D[4] if len(D) > 4 else 0.0
    r2 = x * x + y * y
    rad = 1 + k1 * r2 + k2 * r2 ** 2 + k3 * r2 ** 3
    xd = x * rad + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
    yd = y * rad + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
    return xd, yd


def _distort_equidistant(x, y, D):
    r = np.sqrt(np.maximum(x * x + y * y, 1e-18))
    th = np.arctan(r)
    thd = th * (1 + D[0] * th ** 2 + D[1] * th ** 4
                + D[2] * th ** 6 + D[3] * th ** 8)
    s = thd / r
    return x * s, y * s


def rectify_map(K, D, R_rect, P_new, size, model: str = "radtan"):
    """[H, W, 2] float32 source (x, y) per rectified pixel
    (cv::initUndistortRectifyMap semantics, CV_32FC2 layout)."""
    K = np.asarray(K, float)
    W, H = size
    xs, ys = np.meshgrid(np.arange(W, dtype=np.float64),
                         np.arange(H, dtype=np.float64))
    fx, fy = P_new[0, 0], P_new[1, 1]
    cx, cy = P_new[0, 2], P_new[1, 2]
    xn = (xs - cx) / fx
    yn = (ys - cy) / fy
    ones = np.ones_like(xn)
    ray = np.stack([xn, yn, ones], -1) @ R_rect  # rows: (R_rect^T @ p)^T
    x = ray[..., 0] / ray[..., 2]
    y = ray[..., 1] / ray[..., 2]
    if model == "radtan":
        xd, yd = _distort_radtan(x, y, np.asarray(D, float))
    elif model == "equidistant":
        xd, yd = _distort_equidistant(x, y, np.asarray(D, float))
    else:
        raise ValueError(f"unknown distortion model {model!r}")
    u = K[0, 0] * xd + K[0, 2]
    v = K[1, 1] * yd + K[1, 2]
    return np.stack([u, v], -1).astype(np.float32)


def remap_bilinear(img: torch.Tensor, mp: torch.Tensor) -> torch.Tensor:
    """Sample ``img`` [H, W] at map coordinates ``mp`` [Ho, Wo, 2] (x, y)
    with bilinear interpolation; out-of-range samples clamp to the border
    (cv::remap BORDER_REPLICATE). float32 [Ho, Wo]."""
    H, W = img.shape
    f = img.to(torch.float32)
    x = torch.clamp(mp[..., 0], 0.0, W - 1.0)
    y = torch.clamp(mp[..., 1], 0.0, H - 1.0)
    x0 = torch.floor(x).long()
    y0 = torch.floor(y).long()
    x1 = torch.clamp(x0 + 1, max=W - 1)
    y1 = torch.clamp(y0 + 1, max=H - 1)
    wx = x - x0
    wy = y - y0
    v00 = f[y0, x0]
    v01 = f[y0, x1]
    v10 = f[y1, x0]
    v11 = f[y1, x1]
    top = v00 * (1 - wx) + v01 * wx
    bot = v10 * (1 - wx) + v11 * wx
    return top * (1 - wy) + bot * wy


class StereoRectifier:
    """Precomputed rectification for a calibrated stereo rig.

    Both maps are computed on the host once and kept on ``device``;
    ``__call__`` remaps a stereo pair there. ``cam_params()`` returns the
    rectified (fx, fy, cx, cy, bf) for CameraConfig."""

    def __init__(self, K1, D1, K2, D2, R, t, size, model: str = "radtan", device="cpu"):
        R1, R2, P1, P2 = stereo_rectify(K1, D1, K2, D2, R, t, size)
        self.R1, self.R2, self.P1, self.P2 = R1, R2, P1, P2
        self.map1 = torch.as_tensor(rectify_map(K1, D1, R1, P1, size, model)).to(device)
        self.map2 = torch.as_tensor(rectify_map(K2, D2, R2, P2, size, model)).to(device)
        self.size = size

    def __call__(self, img_l, img_r):
        dev = self.map1.device
        return (remap_bilinear(torch.as_tensor(img_l).to(dev), self.map1),
                remap_bilinear(torch.as_tensor(img_r).to(dev), self.map2))

    def cam_params(self):
        f = self.P1[0, 0]
        return dict(fx=f, fy=self.P1[1, 1], cx=self.P1[0, 2],
                    cy=self.P1[1, 2], bf=-self.P2[0, 3])
