"""ORB after FAST: three hand-written CUDA kernels + their plain PyTorch versions.

Replaces the jit-compiled body of ``tc2li_slam_tpu/ops/orb.py:extract``
around the FAST kernel (``csrc/orb.cu`` says how each kernel works and
what bounds it on the H100):

- ``orb_level_planes``: the pyramid (``jax.image.resize(..., "linear")``,
  ``extract:425``), the 7-tap blur (``gaussian_blur7``, ``:275``) and the
  edge-padded stack writes (``:427-433``) of every level of one or two
  images, in one launch. Plain version: ``level_planes_plain``.
- ``orb_select_grid``: ``select_topk_grid`` (``:204``) of every plane and
  the concatenation of the levels, in one launch. Plain version:
  ``select_grid_plain``.
- ``orb_describe``: ``compute_orientation_stacked`` and
  ``compute_descriptors_stacked`` (``:369``, ``:377``) of every keypoint of
  one or two images, in one launch. Plain version: ``describe_plain``.

The plain versions fix the order of every float sum so that the kernels
can repeat it: the resize adds each output's nonzero taps in order (where
the reference multiplies by the full weight matrices), and the moments of
the orientation are float64 column sums added column by column, rounded to
float32 before ``atan2``. Each kernel is bit-equal to its plain version on
the card.

The launch wrappers take CUDA tensors only and count their launches;
``ops/orb.py`` sends CUDA tensors to them and CPU tensors to the plain
versions. There is no other route.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch
import torch.nn.functional as F

from .._orb_pattern import PATTERN
from . import build

HALF_PATCH = 15
MAX_PLANES = 32      # kMaxPlanes of csrc/orb.cu
MAX_SPAN = 192       # kMaxSpan: image columns a tile's resize reads
MAX_TAPS = 16        # kMaxTaps
MAX_CANDIDATES = 4096   # kMaxCand: candidates of one plane's grid top-k
CELL = 16            # the grid top-k's cell side
_TILE = 32
_HALO = 3

# kernel launches (plain-version calls excluded)
level_launches = 0      # orb_level_planes
select_launches = 0     # orb_select_grid
describe_launches = 0   # orb_describe


def _umax_table() -> np.ndarray:
    umax = np.zeros(HALF_PATCH + 2, np.int32)
    vmax = int(np.floor(HALF_PATCH * np.sqrt(2.0) / 2 + 1))
    vmin = int(np.ceil(HALF_PATCH * np.sqrt(2.0) / 2))
    for v in range(vmax + 1):
        umax[v] = int(np.round(np.sqrt(225.0 - v * v)))
    v0 = 0
    for v in range(HALF_PATCH, vmin - 1, -1):
        while umax[v0] == umax[v0 + 1]:
            v0 += 1
        umax[v] = v0
        v0 += 1
    return umax[: HALF_PATCH + 1]


def _ic_angle_weights():
    u = np.arange(-HALF_PATCH, HALF_PATCH + 1)
    U, V = np.meshgrid(u, u)
    mask = (np.abs(U) <= _umax_table()[np.abs(V)]).astype(np.float32)
    return mask, U.astype(np.float32), V.astype(np.float32)


def _gauss_kernel7(sigma: float = 2.0) -> np.ndarray:
    x = np.arange(-3, 4, dtype=np.float64)
    k = np.exp(-(x * x) / (2 * sigma * sigma))
    return (k / k.sum()).astype(np.float32)


GK7 = [float(v) for v in _gauss_kernel7()]
PATTERN_RADIUS = int(np.ceil(np.sqrt(
    np.maximum(PATTERN[:, 0] ** 2 + PATTERN[:, 1] ** 2,
               PATTERN[:, 2] ** 2 + PATTERN[:, 3] ** 2).max()) + 0.5))
PAD = max(HALF_PATCH, PATTERN_RADIUS)   # edge padding of every plane of the stacks
_UMAX = _umax_table().tolist()


@functools.lru_cache(maxsize=None)
def _constants(device: torch.device) -> dict[str, torch.Tensor]:
    """Orientation weights and the rBRIEF pattern, resident on ``device``."""
    mask, U, V = _ic_angle_weights()
    pat = PATTERN.astype(np.float32)
    c = {
        "ic_u": (mask * U).astype(np.float64),
        "ic_v": (mask * V).astype(np.float64),
        "px": np.concatenate([pat[:, 0], pat[:, 2]]),
        "py": np.concatenate([pat[:, 1], pat[:, 3]]),
        "shifts": np.arange(32, dtype=np.int64),
    }
    c = {k: torch.as_tensor(v).to(device) for k, v in c.items()}
    c["pattern"] = torch.stack([c["px"], c["py"]]).contiguous()   # [2, 512] for the kernel
    return c


# ---------------------------------------------------------------------------
# Pyramid and blur: plain versions
# ---------------------------------------------------------------------------

def level_shape(H: int, W: int, scale: float, lvl: int) -> tuple[int, int]:
    s = scale ** lvl
    return max(int(round(H / s)), 64), max(int(round(W / s)), 64)


@functools.lru_cache(maxsize=None)
def _resize_weights_np(in_size: int, out_size: int) -> np.ndarray:
    """[in, out] float32 antialiased triangle weights, computed exactly as
    ``jax.image.resize(..., "linear")`` does (float32 throughout)."""
    scale = out_size / in_size
    inv_scale = np.float32(1.0 / scale)
    kernel_scale = np.maximum(inv_scale, np.float32(1.0))
    sample_f = ((np.arange(out_size, dtype=np.float32) + np.float32(0.5)) * inv_scale
                - np.float32(0.0) - np.float32(0.5))
    x = np.abs(sample_f[None, :] - np.arange(in_size, dtype=np.float32)[:, None]) / kernel_scale
    w = np.maximum(np.float32(0.0), np.float32(1.0) - np.abs(x))
    total = w.sum(axis=0, keepdims=True, dtype=np.float32)
    eps = np.float32(1000.0 * float(np.finfo(np.float32).eps))
    w = np.where(np.abs(total) > eps, w / np.where(total != 0, total, np.float32(1.0)),
                 np.float32(0.0))
    inside = (sample_f >= -0.5) & (sample_f <= np.float32(in_size - 0.5))
    return np.where(inside[None, :], w, np.float32(0.0)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def resize_taps(in_size: int, out_size: int) -> tuple[np.ndarray, np.ndarray]:
    """The nonzero taps of each output of the resize: (first [out] int32,
    weights [out, T] float32), output o reading inputs first[o] .. first[o]
    + T - 1. T is the widest run of nonzero weights; a narrower run is
    padded with zero weights (first is moved down where the run would pass
    the last input)."""
    w = _resize_weights_np(in_size, out_size)
    nz = w != 0
    lo = np.where(nz.any(axis=0), nz.argmax(axis=0), 0)
    hi = np.where(nz.any(axis=0), in_size - 1 - nz[::-1].argmax(axis=0), 0)
    T = int(max(1, (hi - lo + 1).max()))
    first = np.minimum(lo, in_size - T).astype(np.int32)
    taps = w[first[:, None] + np.arange(T)[None, :], np.arange(out_size)[:, None]]
    return first, np.ascontiguousarray(taps, dtype=np.float32)


@functools.lru_cache(maxsize=None)
def _resize_taps_t(in_size: int, out_size: int, device: torch.device):
    first, w = resize_taps(in_size, out_size)
    first = torch.as_tensor(first.astype(np.int64)).to(device)
    return first, torch.as_tensor(w).to(device)


def resize_linear(f: torch.Tensor, shape: tuple[int, int]) -> torch.Tensor:
    """Antialiased bilinear resize of a float32 [H, W] image: rows, then
    columns, each output the sum of its nonzero taps in order."""
    H, W = f.shape
    Hl, Wl = shape
    fr, wr = _resize_taps_t(H, Hl, f.device)
    fc, wc = _resize_taps_t(W, Wl, f.device)
    tmp = wr[:, 0:1] * f[fr]
    for t in range(1, wr.shape[1]):
        tmp = tmp + wr[:, t:t + 1] * f[fr + t]
    out = wc[:, 0] * tmp[:, fc]
    for t in range(1, wc.shape[1]):
        out = out + wc[:, t] * tmp[:, fc + t]
    return out


def pyramid(f: torch.Tensor, n_levels: int, scale: float) -> list[torch.Tensor]:
    H, W = f.shape
    return [f if lvl == 0 else resize_linear(f, level_shape(H, W, scale, lvl))
            for lvl in range(n_levels)]


def gaussian_blur7(img: torch.Tensor) -> torch.Tensor:
    """Separable 7-tap Gaussian (sigma 2), REFLECT_101 borders."""
    f = img.to(torch.float32)
    H, W = f.shape
    fp = F.pad(f[None, None], (0, 0, 3, 3), mode="reflect")[0, 0]
    acc = fp[0:H] * GK7[0]
    for i in range(1, 7):
        acc = acc + fp[i:i + H] * GK7[i]
    fp = F.pad(acc[None, None], (3, 3, 0, 0), mode="reflect")[0, 0]
    out = fp[:, 0:W] * GK7[0]
    for i in range(1, 7):
        out = out + fp[:, i:i + W] * GK7[i]
    return out


def level_planes_plain(imgs: torch.Tensor, n_levels: int, scale: float):
    """``(img_stack, blur_stack, shapes)`` of float32 images [B, H, W]:
    plane ``b * n_levels + lvl`` of both [B * n_levels, H + 2 PAD, W + 2
    PAD] stacks holds level ``lvl`` of image ``b`` (resp. its 7-tap blur)
    with pixel (0, 0) at ``[PAD, PAD]`` and a replicated border of PAD;
    ``shapes`` lists each plane's (Hl, Wl)."""
    B, H, W = imgs.shape
    img_stack = torch.zeros((B * n_levels, H + 2 * PAD, W + 2 * PAD),
                            dtype=torch.float32, device=imgs.device)
    blur_stack = torch.zeros_like(img_stack)
    shapes = []
    for b in range(B):
        for lvl, lvl_img in enumerate(pyramid(imgs[b], n_levels, scale)):
            Hl, Wl = lvl_img.shape
            p = b * n_levels + lvl
            img_stack[p, :Hl + 2 * PAD, :Wl + 2 * PAD] = F.pad(
                lvl_img[None, None], (PAD,) * 4, mode="replicate")[0, 0]
            blur_stack[p, :Hl + 2 * PAD, :Wl + 2 * PAD] = F.pad(
                gaussian_blur7(lvl_img)[None, None], (PAD,) * 4, mode="replicate")[0, 0]
            shapes.append((Hl, Wl))
    return img_stack, blur_stack, shapes


# ---------------------------------------------------------------------------
# Grid top-k: plain versions
# ---------------------------------------------------------------------------

def topk_stable(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last axis, ties to the lower index (``lax.top_k``)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def cell_candidates(n_cells: int, k: int) -> int:
    """Candidates a cell of the grid top-k keeps (the reference's m_cand)."""
    return max(2, -(-k // n_cells) + 1)


def select_topk_grid(score: torch.Tensor, k: int, cell: int = CELL):
    """Pick k keypoints: per-cell best first, then by score.

    Returns (rows [k], cols [k], scores [k]); empty slots have score 0."""
    H, W = score.shape
    Hc = -(-H // cell)
    Wc = -(-W // cell)
    n_cells = Hc * Wc
    m_cand = cell_candidates(n_cells, k)
    sp = F.pad(score, (0, Wc * cell - W, 0, Hc * cell - H), value=float("-inf"))
    cells = sp.reshape(Hc, cell, Wc, cell).permute(0, 2, 1, 3).reshape(n_cells, cell * cell)
    cvals, cidx = topk_stable(cells, m_cand)                # [n_cells, m]
    ci = torch.arange(n_cells, device=score.device)[:, None]
    rows_c = (ci // Wc) * cell + cidx // cell
    cols_c = (ci % Wc) * cell + cidx % cell
    boost = torch.zeros((n_cells, m_cand), dtype=score.dtype, device=score.device)
    boost[:, 0] = 1e6
    rank = torch.where(torch.isfinite(cvals) & (cvals > 0), cvals + boost,
                       torch.full_like(cvals, float("-inf")))
    vals, idx = topk_stable(rank.reshape(-1), k)
    rows = rows_c.reshape(-1)[idx]
    cols = cols_c.reshape(-1)[idx]
    sel = cvals.reshape(-1)[idx]
    ok = torch.isfinite(vals) & (vals > 0)
    return (torch.where(ok, rows, 0).to(torch.int32),
            torch.where(ok, cols, 0).to(torch.int32),
            torch.where(ok, sel, torch.zeros_like(sel)))


def select_grid_plain(scores: torch.Tensor, shapes, per_level, scale: float):
    """``select_topk_grid`` of every plane of a score stack [B * L, H, W]
    (plane ``b * L + lvl`` holds level ``lvl`` of image ``b`` in ``[:Hl,
    :Wl]``), concatenated level after level: (rows, cols, scores, level,
    level scale), each [B, sum(per_level)]."""
    n_levels = len(per_level)
    B = len(shapes) // n_levels
    dev = scores.device
    out = []
    for b in range(B):
        parts = []
        for lvl in range(n_levels):
            Hl, Wl = shapes[b * n_levels + lvl]
            rows, cols, sel = select_topk_grid(scores[b * n_levels + lvl, :Hl, :Wl],
                                               per_level[lvl])
            k = rows.shape[0]
            parts.append((rows, cols, sel,
                          torch.full((k,), lvl, dtype=torch.int32, device=dev),
                          torch.full((k,), scale ** lvl, dtype=torch.float32, device=dev)))
        out.append([torch.cat(x) for x in zip(*parts)])
    return tuple(torch.stack(x) for x in zip(*out))


# ---------------------------------------------------------------------------
# Orientation + descriptors: plain versions
# ---------------------------------------------------------------------------

def compute_orientation_stacked(stack, lvl, rows, cols, pad: int):
    """Intensity-centroid angle from [K, 31, 31] patches of the padded
    plane stack (IC_Angle); ``lvl`` picks each keypoint's plane. The moments
    are float64 sums (every float32 product is exact there) in a fixed
    order: each column over its rows in order, then the columns in order;
    they are rounded to float32 before ``atan2``."""
    c = _constants(stack.device)
    ar = torch.arange(-HALF_PATCH, HALF_PATCH + 1, device=stack.device)
    r = (rows.long() + pad)[:, None, None] + ar[None, :, None]
    cc = (cols.long() + pad)[:, None, None] + ar[None, None, :]
    patches = stack[lvl.long()[:, None, None], r, cc].to(torch.float64)
    K = patches.shape[0]
    s10 = torch.zeros((K, 2 * HALF_PATCH + 1), dtype=torch.float64, device=stack.device)
    s01 = torch.zeros_like(s10)
    for dy in range(2 * HALF_PATCH + 1):
        s10 = s10 + patches[:, dy] * c["ic_u"][dy]
        s01 = s01 + patches[:, dy] * c["ic_v"][dy]
    m10 = torch.zeros(K, dtype=torch.float64, device=stack.device)
    m01 = torch.zeros_like(m10)
    for dx in range(2 * HALF_PATCH + 1):
        m10 = m10 + s10[:, dx]
        m01 = m01 + s01[:, dx]
    return torch.atan2(m01.to(torch.float32), m10.to(torch.float32))


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """[K, 256] {0,1} -> [K, 8] int32 words, LSB first (uint32 patterns)."""
    shifts = _constants(bits.device)["shifts"]
    w = torch.sum(bits.reshape(-1, 8, 32).to(torch.int64) << shifts, dim=-1)
    return torch.where(w >= 2 ** 31, w - 2 ** 32, w).to(torch.int32)


def tap_coords(rows, cols, angles, pad: int):
    """Rows and columns [K, 512] in the padded planes of the rotated rBRIEF
    taps of keypoints [K] at ``angles``, clipped to the pattern radius."""
    c = _constants(rows.device)
    a = torch.cos(angles)[:, None]
    b = torch.sin(angles)[:, None]
    R = PATTERN_RADIUS
    roff = torch.round(c["px"][None] * b + c["py"][None] * a).to(torch.int64)
    coff = torch.round(c["px"][None] * a - c["py"][None] * b).to(torch.int64)
    return ((rows.long() + pad)[:, None] + torch.clamp(roff, -R, R),
            (cols.long() + pad)[:, None] + torch.clamp(coff, -R, R))


def compute_descriptors_stacked(blur_stack, lvl, rows, cols, angles, pad: int):
    """Steered BRIEF-256 -> [K, 8] int32 words (computeOrbDescriptor).

    Each of the 512 rotated taps is read directly from the padded blurred
    stack; tap offsets are clipped to the pattern radius and the values
    rounded to integers, as the reference does to its patches."""
    r, cc = tap_coords(rows, cols, angles, pad)
    vals = torch.round(blur_stack[lvl.long()[:, None], r, cc])   # [K, 512]
    bits = vals[:, :256] < vals[:, 256:]
    return pack_bits(bits)


def describe_plain(img_stack, blur_stack, rows, cols, level, n_levels: int, pad: int):
    """Angles [B, K] and rBRIEF words [B, K, 8] of the keypoints [B, K] of B
    images, keypoint (b, i) on plane ``b * n_levels + level[b, i]``."""
    angles, desc = [], []
    for b in range(rows.shape[0]):   # one image at a time: the same shapes for 1 or 2
        plane = level[b].long() + b * n_levels
        angles.append(compute_orientation_stacked(img_stack, plane, rows[b], cols[b], pad))
        desc.append(compute_descriptors_stacked(blur_stack, plane, rows[b], cols[b],
                                                angles[-1], pad))
    return torch.stack(angles), torch.stack(desc)


# ---------------------------------------------------------------------------
# Kernels
# ---------------------------------------------------------------------------

def _require_cuda(what: str, *xs: torch.Tensor) -> torch.device:
    dev = xs[0].device
    for x in xs:
        if x.device.type != "cuda" or x.device != dev:
            raise ValueError(f"{what}: every tensor must lie on one CUDA device, got "
                             f"{x.device} beside {dev}")
    return dev


class _LevelTable:
    """``csrc/orb.cu``'s plane table of ``orb_level_planes`` and the resize
    tap tables on the device."""

    def __init__(self, rows: list[int], first: torch.Tensor, wts: torch.Tensor, shapes):
        self.rows = (ctypes.c_int * len(rows))(*rows)
        self.n = len(rows) // 13
        self.first, self.wts, self.shapes = first, wts, shapes


@functools.lru_cache(maxsize=16)
def _level_table(B: int, H: int, W: int, n_levels: int, scale: float,
                 device: torch.device) -> _LevelTable:
    Hs, Ws = H + 2 * PAD, W + 2 * PAD
    first, wts, per_level = [], [], []
    n_first = n_wts = 0
    for lvl in range(n_levels):
        Hl, Wl = (H, W) if lvl == 0 else level_shape(H, W, scale, lvl)
        if lvl == 0:
            per_level.append((Hl, Wl, 0, 0, 0, 0, 0, 1, 1))
            continue
        fr, wr = resize_taps(H, Hl)
        fc, wc = resize_taps(W, Wl)
        tr, tc = wr.shape[1], wc.shape[1]
        if max(tr, tc) > MAX_TAPS:
            raise ValueError(f"orb_level_planes: level {lvl} reads {max(tr, tc)} taps an "
                             f"output; the kernel takes at most {MAX_TAPS}")
        n_src = _TILE + 2 * _HALO
        span = int((fc[np.minimum(np.arange(Wl) + n_src - 1, Wl - 1)] + tc - fc).max())
        if span > MAX_SPAN:
            raise ValueError(f"orb_level_planes: a tile of level {lvl} reads {span} image "
                             f"columns; the kernel takes at most {MAX_SPAN}")
        per_level.append((Hl, Wl, 1, n_first, n_wts, n_first + Hl, n_wts + wr.size, tr, tc))
        first += [fr, fc]
        wts += [wr.reshape(-1), wc.reshape(-1)]
        n_first += Hl + Wl
        n_wts += wr.size + wc.size
    rows, shapes, tile0 = [], [], 0
    for b in range(B):
        for lvl, (Hl, Wl, resize, fr0, wr0, fc0, wc0, tr, tc) in enumerate(per_level):
            if min(Hl, Wl) < 4:
                raise ValueError(f"orb_level_planes: level {lvl} is {Hl} x {Wl}; the blur "
                                 f"takes planes of at least 4 x 4")
            tiles_x = -(-(Wl + 2 * PAD) // _TILE)
            rows += [b, Hl, Wl, resize, fr0, wr0, fc0, wc0, tr, tc,
                     (b * n_levels + lvl) * Hs * Ws, tile0, tiles_x]
            tile0 += tiles_x * -(-(Hl + 2 * PAD) // _TILE)
            shapes.append((Hl, Wl))
    cat = lambda xs, dt: np.concatenate(xs).astype(dt) if xs else np.zeros(1, dt)
    return _LevelTable(rows, torch.as_tensor(cat(first, np.int32)).to(device),
                       torch.as_tensor(cat(wts, np.float32)).to(device), tuple(shapes))


def orb_level_planes(imgs: torch.Tensor, n_levels: int, scale: float):
    """Launch ``orb_level_planes`` on the current stream: what
    ``level_planes_plain`` computes, in one launch. The stacks are not
    filled outside each plane's padded region."""
    global level_launches
    dev = _require_cuda("orb_level_planes", imgs)
    if imgs.ndim != 3 or imgs.dtype != torch.float32:
        raise ValueError(f"orb_level_planes takes float32 images [B, H, W], got "
                         f"{imgs.dtype} {tuple(imgs.shape)}")
    B, H, W = imgs.shape
    if B * n_levels > MAX_PLANES or n_levels < 1 or B < 1:
        raise ValueError(f"orb_level_planes: {B} images of {n_levels} levels; the kernel "
                         f"takes 1 to {MAX_PLANES} planes")
    Hs, Ws = H + 2 * PAD, W + 2 * PAD
    if B * n_levels * Hs * Ws >= 2 ** 31:
        raise ValueError("orb_level_planes: the stacks exceed the kernel's int32 offsets")
    t = _level_table(B, H, W, n_levels, float(scale), dev)
    imgs = imgs.contiguous()
    img_stack = torch.empty((B * n_levels, Hs, Ws), dtype=torch.float32, device=dev)
    blur_stack = torch.empty_like(img_stack)
    lib = build.library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    build.check(lib.tc2li_orb_level_planes(
        imgs.data_ptr(), img_stack.data_ptr(), blur_stack.data_ptr(), t.first.data_ptr(),
        t.wts.data_ptr(), t.rows, t.n, PAD, H, W, Ws, (ctypes.c_float * 7)(*GK7), stream),
        "orb_level_planes")
    level_launches += 1
    return img_stack, blur_stack, list(t.shapes)


class _SelectTable:
    def __init__(self, rows: list[int], n: int, k_total: int):
        self.rows = (ctypes.c_int * len(rows))(*rows)
        self.n, self.k_total = n, k_total


@functools.lru_cache(maxsize=16)
def _select_table(shapes, per_level, scale: float, H: int, W: int) -> _SelectTable:
    n_levels = len(per_level)
    k_total = sum(per_level)
    rows = []
    for p, (Hl, Wl) in enumerate(shapes):
        b, lvl = divmod(p, n_levels)
        cells_x = -(-Wl // CELL)
        n_cells = cells_x * -(-Hl // CELL)
        k = per_level[lvl]
        m = cell_candidates(n_cells, k)
        if n_cells * m > MAX_CANDIDATES or m > CELL * CELL:
            raise ValueError(f"orb_select_grid: plane {p} ({Hl} x {Wl}, k {k}) has "
                             f"{n_cells} cells of {m} candidates; the kernel takes at most "
                             f"{MAX_CANDIDATES} candidates a plane")
        s_bits = int(np.array([scale ** lvl], np.float32).view(np.int32)[0])
        rows += [p * H * W, Hl, Wl, cells_x, n_cells, m, k,
                 b * k_total + sum(per_level[:lvl]), lvl, s_bits]
    return _SelectTable(rows, len(shapes), k_total)


def orb_select_grid(scores: torch.Tensor, shapes, per_level, scale: float):
    """Launch ``orb_select_grid`` on the current stream: what
    ``select_grid_plain`` computes, in one launch."""
    global select_launches
    dev = _require_cuda("orb_select_grid", scores)
    shapes = tuple((int(h), int(w)) for h, w in shapes)
    per_level = tuple(int(k) for k in per_level)
    if scores.ndim != 3 or scores.dtype != torch.float32:
        raise ValueError(f"orb_select_grid takes a float32 [P, H, W] score stack, got "
                         f"{scores.dtype} {tuple(scores.shape)}")
    P, H, W = scores.shape
    n_levels = len(per_level)
    if n_levels < 1 or len(shapes) != P or P % n_levels or P > MAX_PLANES or any(
            not (0 < h <= H and 0 < w <= W) for h, w in shapes) or min(per_level) < 0 \
            or P * H * W >= 2 ** 31:
        raise ValueError(f"orb_select_grid: plane shapes {shapes} and {n_levels} levels "
                         f"do not fit a {tuple(scores.shape)} stack of at most {MAX_PLANES} "
                         f"planes")
    t = _select_table(shapes, per_level, float(scale), H, W)
    B = P // n_levels
    scores = scores.contiguous()
    rows = torch.empty((B, t.k_total), dtype=torch.int32, device=dev)
    cols = torch.empty_like(rows)
    level = torch.empty_like(rows)
    sel = torch.empty((B, t.k_total), dtype=torch.float32, device=dev)
    lvl_scale = torch.empty_like(sel)
    lib = build.library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    build.check(lib.tc2li_orb_select_grid(
        scores.data_ptr(), rows.data_ptr(), cols.data_ptr(), sel.data_ptr(), level.data_ptr(),
        lvl_scale.data_ptr(), t.rows, t.n, W, stream), "orb_select_grid")
    select_launches += 1
    return rows, cols, sel, level, lvl_scale


def orb_describe(img_stack, blur_stack, rows, cols, level, n_levels: int, pad: int = PAD):
    """Launch ``orb_describe`` on the current stream: what ``describe_plain``
    computes, in one launch. Keypoints must lie at least ``pad`` - the
    reach of the patch and the pattern inside each plane's padded region
    (FAST's margin keeps them there)."""
    global describe_launches
    dev = _require_cuda("orb_describe", img_stack, blur_stack, rows, cols, level)
    if img_stack.ndim != 3 or img_stack.dtype != torch.float32 \
            or blur_stack.shape != img_stack.shape or blur_stack.dtype != torch.float32:
        raise ValueError("orb_describe takes two float32 [P, Hs, Ws] stacks of one shape")
    if rows.ndim != 2 or any(x.shape != rows.shape or x.dtype != torch.int32
                             for x in (rows, cols, level)):
        raise ValueError("orb_describe takes int32 rows, cols and levels [B, K] of one shape")
    P, Hs, Ws = img_stack.shape
    B, K = rows.shape
    if B * n_levels > P or pad < max(HALF_PATCH, PATTERN_RADIUS) or K < 1 \
            or P * Hs * Ws >= 2 ** 31:
        raise ValueError(f"orb_describe: {B} images of {n_levels} levels with pad {pad} do "
                         f"not fit a {tuple(img_stack.shape)} stack")
    c = _constants(dev)
    img_stack, blur_stack = img_stack.contiguous(), blur_stack.contiguous()
    rows, cols, level = rows.contiguous(), cols.contiguous(), level.contiguous()
    angle = torch.empty((B, K), dtype=torch.float32, device=dev)
    desc = torch.empty((B, K, 8), dtype=torch.int32, device=dev)
    lib = build.library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    build.check(lib.tc2li_orb_describe(
        img_stack.data_ptr(), blur_stack.data_ptr(), rows.data_ptr(), cols.data_ptr(),
        level.data_ptr(), c["pattern"].data_ptr(), angle.data_ptr(), desc.data_ptr(), B * K,
        K, n_levels, pad, Ws, Hs * Ws, PATTERN_RADIUS,
        (ctypes.c_int * (HALF_PATCH + 1))(*_UMAX), stream), "orb_describe")
    describe_launches += 1
    return angle, desc
