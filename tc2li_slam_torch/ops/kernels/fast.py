"""FAST-9/16 detection: hand-written CUDA kernels + their plain PyTorch versions.

Replaces ``tc2li_slam_tpu/ops/kernels/fast.py:fast_score_pallas`` (the only
Pallas kernel of the JAX package) and the body of
``tc2li_slam_tpu/ops/orb.py:detect_level`` that XLA fused around it: the two
threshold gates, the 35-px cell fallback, 3x3 non-maximum suppression and
the detection margin.

Bound on the H100: operations (~175 float min/max/sub per pixel that pays
the whole segment test, against 3.4 us for the bytes of one 1241x376
image's 8 levels). The earlier per-level kernel sat at 5-9% of its bound
because of what surrounded it: 16 launches a frame, small grids on the upper
levels, ~20 eager passes per level. ``csrc/fast.cu`` therefore runs
detection for every plane of a stack (all levels of one or two images) in
two launches over one flat grid of tiles:

- ``fast_score_planes``: the segment-test score, stored gated at
  ``min(ini_th, min_th)``, plus one flag per cell that holds a pixel above
  ``ini_th``. Pixels that four compass differences already bound below the
  gate are rejected first and the rest are compacted per block, so the
  full test runs with all lanes busy. With one plane and the gate off the
  ungated variant of the same pass is ``fast_score_raw``.
- ``fast_nms_planes``: the per-cell threshold choice, 3x3 non-maximum
  suppression and the margin; a stencil bound by bytes, on 120 x 32 tiles
  staged with their halo in shared memory by aligned 16-byte loads.

All operations are subtractions, comparisons and min/max, so both are
bit-equal to their plain versions.

``fast_score_raw``, ``score_planes`` and ``nms_planes`` (and ``detect_planes``,
the two in a row) launch the kernels for CUDA tensors and run the plain
versions for CPU tensors; there is no other route. ``detect_level_plain`` is
the whole detection written as the JAX package writes it, the reference
that both routes are held to.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from . import build

# FAST circle (dx, dy), radius 3, OpenCV ordering (same as csrc/fast.cu).
FAST_OFFS = ((0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
             (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2), (-1, -3))
MARGIN = 16        # ORB-SLAM3 EDGE_THRESHOLD (19) - 3: patch + descriptor reach
MAX_PLANES = 32    # kMaxPlanes of csrc/fast.cu
MAX_DIM = 65535    # kMaxDim of csrc/fast.cu: plane sides and cell
_TILE = 32          # tile side of csrc/fast.cu

# kernel launches (plain-version calls excluded)
score_launches = 0   # fast_score_planes
nms_launches = 0     # fast_nms_planes


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def fast_score_raw_plain(img: torch.Tensor) -> torch.Tensor:
    """Ungated FAST-16 score [H, W] (``orb._fast_score_raw_xla``)."""
    f = img.to(torch.float32)
    dpos = [torch.roll(f, (-dy, -dx), dims=(0, 1)) - f for dx, dy in FAST_OFFS]
    sb = sd = None
    for s in range(16):
        run_p = dpos[s]
        run_n = -dpos[s]
        for j in range(1, 9):
            d = dpos[(s + j) % 16]
            run_p = torch.minimum(run_p, d)
            run_n = torch.minimum(run_n, -d)
        sb = run_p if sb is None else torch.maximum(sb, run_p)
        sd = run_n if sd is None else torch.maximum(sd, run_n)
    score = torch.maximum(sb, sd)
    H, W = f.shape
    border = torch.zeros((H, W), dtype=torch.bool, device=f.device)
    border[3:H - 3, 3:W - 3] = True
    return torch.where(border, score, torch.zeros_like(score))


def _cell_max(x: torch.Tensor, cell: int) -> torch.Tensor:
    """[ceil(H / cell), ceil(W / cell)] per-cell max (cells anchored at
    (0, 0), zero padding to whole cells)."""
    H, W = x.shape
    Hp = -(-H // cell) * cell
    Wp = -(-W // cell) * cell
    xp = F.pad(x, (0, Wp - W, 0, Hp - H))
    return xp.reshape(Hp // cell, cell, Wp // cell, cell).amax(dim=(1, 3))


def _cells_to_pixels(cells: torch.Tensor, cell: int, H: int, W: int) -> torch.Tensor:
    return cells.repeat_interleave(cell, 0).repeat_interleave(cell, 1)[:H, :W]


def _nms_margin(score: torch.Tensor) -> torch.Tensor:
    """3x3 non-maximum suppression of a score map, then the margin."""
    zero = torch.zeros_like(score)
    pooled = F.max_pool2d(score[None, None], 3, stride=1, padding=1)[0, 0]
    score = torch.where((score >= pooled) & (score > 0), score, zero)
    H, W = score.shape
    inner = torch.zeros((H, W), dtype=torch.bool, device=score.device)
    inner[MARGIN:H - MARGIN, MARGIN:W - MARGIN] = True
    return torch.where(inner, score, zero)


def gate_nms_plain(raw: torch.Tensor, ini_th: float = 20.0, min_th: float = 7.0,
                   cell: int = 35) -> torch.Tensor:
    """The detection stages after the raw score: both gates, the per-cell
    fallback to ``min_th``, 3x3 non-maximum suppression, the margin."""
    zero = torch.zeros_like(raw)
    s_ini = torch.where(raw > ini_th, raw, zero)
    s_min = torch.where(raw > min_th, raw, zero)
    H, W = raw.shape
    has_ini = _cells_to_pixels(_cell_max((s_ini > 0).to(torch.float32), cell), cell, H, W) > 0
    return _nms_margin(torch.where(has_ini, s_ini, s_min))


def detect_level_plain(img: torch.Tensor, ini_th: float = 20.0, min_th: float = 7.0,
                       cell: int = 35) -> torch.Tensor:
    """Adaptive-threshold FAST + 3x3 NMS score map of one image
    (``orb.detect_level`` of the JAX package, written as it is there)."""
    return gate_nms_plain(fast_score_raw_plain(img), ini_th, min_th, cell)


def score_planes_plain(stack, shapes, pad, ini_th, min_th, cell):
    """Plain version of ``fast_score_planes``: per plane the raw score gated
    at ``min(ini_th, min_th)``, and the cell flags of all planes in a row."""
    P, Hs, Ws = stack.shape
    gate = min(ini_th, min_th)
    gated = torch.zeros((P, Hs - 2 * pad, Ws - 2 * pad), dtype=torch.float32,
                        device=stack.device)
    flags = []
    for p, (Hl, Wl) in enumerate(shapes):
        raw = fast_score_raw_plain(stack[p, pad:pad + Hl, pad:pad + Wl])
        gated[p, :Hl, :Wl] = torch.where(raw > gate, raw, torch.zeros_like(raw))
        flags.append(_cell_max((raw > ini_th).to(torch.int32), cell).reshape(-1))
    return gated, torch.cat(flags)


def nms_planes_plain(gated, flags, shapes, ini_th, min_th, cell):
    """Plain version of ``fast_nms_planes``: the threshold of each pixel's
    cell, 3x3 non-maximum suppression, the margin."""
    out = torch.zeros_like(gated)
    off = 0
    for p, (Hl, Wl) in enumerate(shapes):
        cy, cx = -(-Hl // cell), -(-Wl // cell)
        has_ini = _cells_to_pixels(flags[off:off + cy * cx].reshape(cy, cx), cell, Hl, Wl) > 0
        off += cy * cx
        g = gated[p, :Hl, :Wl]
        zero = torch.zeros_like(g)
        score = torch.where(has_ini, torch.where(g > ini_th, g, zero),
                            torch.where(g > min_th, g, zero))
        out[p, :Hl, :Wl] = _nms_margin(score)
    return out


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------

def _on_cuda(x: torch.Tensor, what: str) -> bool:
    """True for a CUDA tensor, False for a CPU tensor, else raises."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {x.device}")
    return True


def fast_score_raw(img: torch.Tensor) -> torch.Tensor:
    """Ungated FAST-16 score [H, W] float32 of a 2-D image."""
    if img.ndim != 2:
        raise ValueError(f"fast_score_raw takes a 2-D image, got {tuple(img.shape)}")
    if not _on_cuda(img, "fast_score_raw"):
        return fast_score_raw_plain(img)
    f = img.to(torch.float32).contiguous()
    H, W = f.shape
    out = torch.empty_like(f)
    if H == 0 or W == 0:
        return out
    if max(H, W) > MAX_DIM or f.numel() >= 2 ** 31:
        raise ValueError(f"fast_score_raw: a {H} x {W} image exceeds the kernel's limits")
    _launch_score(f, out, None, _plane_table(((H, W),), 0, H, W, H, W, 1), W, W,
                  gated=False, gate=0.0, ini_th=0.0, cell=1)
    return out


def _check_planes(what: str, stack, shapes, pad: int, ini_th, min_th, cell: int):
    """Validated (shapes, H, W) of a plane stack [P, H + 2 pad, W + 2 pad]."""
    if stack.ndim != 3 or stack.dtype != torch.float32:
        raise ValueError(f"{what} takes a float32 [P, Hs, Ws] stack, got "
                         f"{stack.dtype} {tuple(stack.shape)}")
    P, Hs, Ws = stack.shape
    shapes = tuple((int(h), int(w)) for h, w in shapes)
    H, W = Hs - 2 * pad, Ws - 2 * pad
    if len(shapes) != P or pad < 0 or any(
            not (0 < h <= H and 0 < w <= W) for h, w in shapes):
        raise ValueError(f"{what}: plane shapes {shapes} do not fit a "
                         f"{tuple(stack.shape)} stack with pad {pad}")
    if cell < 1 or ini_th < 0 or min_th < 0:
        raise ValueError(f"{what} takes cell >= 1 and thresholds >= 0")
    if _on_cuda(stack, what):
        if P > MAX_PLANES:
            raise ValueError(f"{what}: {P} planes exceed the kernel's table ({MAX_PLANES})")
        if stack.numel() >= 2 ** 31 or max(H, W, cell) > MAX_DIM:
            raise ValueError(f"{what}: the stack exceeds the kernel's int32 offsets or "
                             f"its {MAX_DIM}-pixel side")
    return shapes, H, W


def score_planes(stack: torch.Tensor, shapes, pad: int = 0, ini_th: float = 20.0,
                 min_th: float = 7.0, cell: int = 35):
    """Pass 1 of the detection: ``(gated, flags)``.

    ``stack`` is float32 [P, Hs, Ws]; plane ``p`` is the ``shapes[p]`` =
    (Hl, Wl) image whose pixel (0, 0) sits at ``stack[p, pad, pad]`` (what
    surrounds it is never read). ``gated`` [P, Hs - 2 pad, Ws - 2 pad] holds
    in ``[p, :Hl, :Wl]`` the FAST score where it exceeds ``min(ini_th,
    min_th)``, else 0 (the rest of the plane is unspecified); ``flags``
    int32, one per ``cell`` x ``cell`` cell of every plane in turn, is 1
    where a pixel of the cell scores above ``ini_th``."""
    shapes, H, W = _check_planes("score_planes", stack, shapes, pad, ini_th, min_th, cell)
    if not _on_cuda(stack, "score_planes"):
        return score_planes_plain(stack, shapes, pad, ini_th, min_th, cell)
    stack = stack.contiguous()
    P, Hs, Ws = stack.shape
    table = _plane_table(shapes, pad, Hs, Ws, H, W, cell)
    gated = torch.empty((P, H, W), dtype=torch.float32, device=stack.device)
    flags = torch.zeros(table.n_cells, dtype=torch.int32, device=stack.device)
    _launch_score(stack, gated, flags, table, Ws, W, gated=True,
                  gate=min(ini_th, min_th), ini_th=ini_th, cell=cell)
    return gated, flags


def nms_planes(gated: torch.Tensor, flags: torch.Tensor, shapes, ini_th: float = 20.0,
               min_th: float = 7.0, cell: int = 35) -> torch.Tensor:
    """Pass 2 of the detection, on ``score_planes``' outputs: per pixel the
    threshold its cell's flag selects, 3x3 non-maximum suppression and the
    margin. ``out[p, :Hl, :Wl]`` is the plane's score map."""
    global nms_launches
    shapes, H, W = _check_planes("nms_planes", gated, shapes, 0, ini_th, min_th, cell)
    table = _plane_table(shapes, 0, H, W, H, W, cell)
    if flags.shape != (table.n_cells,) or flags.dtype != torch.int32 \
            or flags.device != gated.device:
        raise ValueError(f"nms_planes: flags must be int32 [{table.n_cells}] beside the scores")
    if not _on_cuda(gated, "nms_planes"):
        return nms_planes_plain(gated, flags, shapes, ini_th, min_th, cell)
    gated, flags = gated.contiguous(), flags.contiguous()
    if gated.data_ptr() % 16:   # the kernel reads and writes aligned 16-byte chunks
        gated = gated.clone()
    out = torch.empty_like(gated)
    lib = build.library()
    stream = torch.cuda.current_stream(gated.device).cuda_stream
    build.check(lib.tc2li_fast_nms_planes(
        gated.data_ptr(), flags.data_ptr(), out.data_ptr(), table.rows, len(shapes), W,
        ini_th, min_th, cell, MARGIN, stream), "fast_nms_planes")
    nms_launches += 1
    return out


def detect_planes(stack: torch.Tensor, shapes, pad: int = 0, ini_th: float = 20.0,
                  min_th: float = 7.0, cell: int = 35) -> torch.Tensor:
    """Adaptive-threshold FAST + NMS score maps of a stack of image planes
    (layout as for ``score_planes``): ``out[p, :Hl, :Wl]`` equals
    ``detect_level_plain`` of plane p. Two kernel launches on the card."""
    gated, flags = score_planes(stack, shapes, pad, ini_th, min_th, cell)
    return nms_planes(gated, flags, shapes, ini_th, min_th, cell)


class _PlaneTable:
    """Host-side plane table of ``csrc/fast.cu`` (n x 8 ints) and its totals."""

    def __init__(self, rows: list[int], n_cells: int):
        self.rows = (ctypes.c_int * len(rows))(*rows)
        self.n_cells = n_cells


@functools.lru_cache(maxsize=64)
def _plane_table(shapes, pad: int, Hs: int, Ws: int, H: int, W: int,
                 cell: int) -> _PlaneTable:
    rows, cell_off, tile0 = [], 0, 0
    for p, (Hl, Wl) in enumerate(shapes):
        cells_x = -(-Wl // cell)
        tiles_x = -(-Wl // _TILE)
        rows += [p * Hs * Ws + pad * Ws + pad, p * H * W, Hl, Wl, cell_off, cells_x,
                 tile0, tiles_x]
        cell_off += cells_x * -(-Hl // cell)
        tile0 += tiles_x * -(-Hl // _TILE)
    return _PlaneTable(rows, cell_off)


def _launch_score(src, out, flags, table: _PlaneTable, in_stride: int, out_stride: int,
                  gated: bool, gate: float, ini_th: float, cell: int) -> None:
    """Launch ``fast_score_planes`` on the current stream."""
    global score_launches
    lib = build.library()
    stream = torch.cuda.current_stream(src.device).cuda_stream
    build.check(lib.tc2li_fast_score_planes(
        src.data_ptr(), out.data_ptr(), None if flags is None else flags.data_ptr(),
        table.rows, len(table.rows) // 8, in_stride, out_stride, int(gated), gate,
        ini_th, cell, stream), "fast_score_planes")
    score_launches += 1
