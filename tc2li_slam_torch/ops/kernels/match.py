"""Masked best-two descriptor match: a fused CUDA kernel + its plain version.

Replaces ``tc2li_slam_tpu/ops/matching.py:_masked_best2`` / ``match_descriptors``
over ``hamming_matrix_mxu``: on the TPU a dense [N, M] Hamming matrix, a
dense [N, M] predicate and three row reductions, fused by XLA. Eager
PyTorch fuses nothing, so the 32768 x 2000 tracking match moved ~5 GB
through device memory around a 0.15 ms matrix kernel.

Bound on the H100: operations that depend on the data — a mask test of ~8
simple operations per tested (valid row, column) pair, 8 XOR + 8 popcounts
per admitted pair; the inputs are ~1.7 MB. The kernels (``csrc/match.cu``)
test the mask first, compute a distance only for admitted pairs, and write
per row the first column of the minimum, the minimum and the minimum over
the other columns; for the mutual test also, per column, the first row of
the column's minimum. [N, M] never reaches device memory. In the window
mode each block lists side 2's columns by 16-px cell in shared memory and
a row tests only the columns of the cells its window overlaps. In the
stereo mode each block sorts side 2's columns into row bins of v in its
shared memory, and a warp a row walks only the bins its band can reach. In
the epipolar mode each block stages side 2's valid columns and two warps
a row evaluate the gate on each. In the dense mode each block stages only
side 2's valid columns, in tiles of its shared memory, compacts its valid
rows, and gives a warp four of them and a slice of the tile; the mutual
test's column minima are merged over the block before one device atomic a
column.

The pair mask is one of:

- ``WindowMask``: ``|du| < r[n]``, ``|dv| < r[n]``, ``lo <= lvl2 - lvl1 <= hi``
  (``search_by_projection``);
- ``StereoMask``: ``|dv| <= band[m]``, ``-2 <= u1 - u2 <= max_d``, the level
  gate (``stereo.match_stereo``);
- ``EpipolarMask``: the squared distance of column m's keypoint from row
  n's epipolar line below ``thresh x sigma2[m]`` (``epipolar_gate``, the
  triangulation match); the card's kernel evaluates it per pair with the
  plain chain's rounding, two warps a row over each block's staged valid
  columns;
- a dense bool [N, M], or ``None`` (the public ``match_descriptors``);

each ANDed with ``valid1[n] & valid2[m]``. One launch takes at most
``max_columns(mask)`` columns of side 2 (13,440 in the window mode's shared
memory, 5,120 in the stereo mode's build registers, 14,464 in the epipolar
mode's shared memory, and 65,535 in the dense mode, the 16-bit column of
its keys: a frame against the whole landmark pool in relocalization is one
launch). A wider side 2 (a large ``n_features``) is matched one column
chunk at a time and the per-row pairs merged, which is exact: the earlier
chunk wins a tie, so the first column of the minimum stays the first, and a
column's mutual best lies in its own chunk. ``match_best2`` launches the
kernel for CUDA tensors and runs the plain chain (``hamming_matrix_plain``,
the dense mask, ``masked_best2_plain``) for CPU tensors, per chunk where it
chunks; there is no other route. Every output is equal between the two.

``launches`` counts the kernel's launches; ``launches_by_mode`` splits the
same count by call shape (``mode_key``: the mask kind, ``+mutual``, and
``+chunk`` for a launch that matched one column chunk of a larger side 2).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from . import build
from .hamming import hamming_matrix_plain

BIG = 1 << 20     # distance of a row or column with no admitted pair
# columns of side 2 that one launch takes, by mode (tc2li_match_max_columns
# of csrc/match.cu): the window grid's columns in shared memory, the stereo
# build's registers, the 16-bit column key (dense: the valid columns go
# through shared memory in tiles), the valid columns staged in shared memory
# (epipolar). A larger side 2 is matched in column chunks of at most that
# many.
WINDOW_MAX_COLUMNS = 13440
STEREO_MAX_COLUMNS = 5120
DENSE_MAX_COLUMNS = 65535
EPI_MAX_COLUMNS = 14464

launches = 0   # kernel launches by match_best2 (plain-version calls excluded)
launches_by_mode: dict[str, int] = {}   # the same launches, by ``mode_key``


def mode_key(mask, mutual: bool, chunk: bool = False) -> str:
    """Call shape of one launch: ``window``, ``stereo``, ``epipolar``,
    ``dense`` (a bool [N, M] mask) or ``none``, then ``+mutual``, then
    ``+chunk``."""
    kind = ("none" if mask is None else "dense" if isinstance(mask, torch.Tensor)
            else {WindowMask: "window", StereoMask: "stereo",
                  EpipolarMask: "epipolar"}[type(mask)])
    return kind + ("+mutual" if mutual else "") + ("+chunk" if chunk else "")


def max_columns(mask) -> int:
    """Columns of side 2 one launch takes under ``mask``'s kind (a mask, or
    the class of one)."""
    kind = mask if isinstance(mask, type) else type(mask)
    return {WindowMask: WINDOW_MAX_COLUMNS, StereoMask: STEREO_MAX_COLUMNS,
            EpipolarMask: EPI_MAX_COLUMNS}.get(kind, DENSE_MAX_COLUMNS)


def columns(mask, c0: int, c1: int):
    """``mask`` restricted to side 2's columns [c0, c1)."""
    if mask is None:
        return None
    if isinstance(mask, torch.Tensor):
        return mask[:, c0:c1]
    return mask._replace(**{k: getattr(mask, k)[c0:c1] for k in mask.COLUMN_FIELDS})


def window_mask(uv1, uv2, radius):
    """|du| < r and |dv| < r (SearchByProjection window)."""
    du = torch.abs(uv1[:, None, 0] - uv2[None, :, 0])
    dv = torch.abs(uv1[:, None, 1] - uv2[None, :, 1])
    r = radius[:, None]
    return (du < r) & (dv < r)


def level_mask(lvl1, lvl2, lo: int = -1, hi: int = 1):
    d = lvl2[None, :] - lvl1[:, None]
    return (d >= lo) & (d <= hi)


class WindowMask(NamedTuple):
    """Projection window around each row's predicted position + level gate."""

    uv1: torch.Tensor      # [N, 2] float32
    radius: torch.Tensor   # [N] float32
    lvl1: torch.Tensor     # [N] int32
    uv2: torch.Tensor      # [M, 2] float32
    lvl2: torch.Tensor     # [M] int32
    lo: int = -1
    hi: int = 1
    COLUMN_FIELDS = ("uv2", "lvl2")

    def dense(self) -> torch.Tensor:
        return (window_mask(self.uv1, self.uv2, self.radius)
                & level_mask(self.lvl1, self.lvl2, self.lo, self.hi))


class StereoMask(NamedTuple):
    """Row band of the right keypoint's level, disparity range, level gate."""

    uv1: torch.Tensor      # [N, 2] float32 left keypoints
    lvl1: torch.Tensor     # [N] int32
    uv2: torch.Tensor      # [M, 2] float32 right keypoints
    lvl2: torch.Tensor     # [M] int32
    band: torch.Tensor     # [M] float32
    max_d: float           # a float32 value
    lo: int = -1
    hi: int = 1
    COLUMN_FIELDS = ("uv2", "lvl2", "band")

    def dense(self) -> torch.Tensor:
        dv = torch.abs(self.uv1[:, None, 1] - self.uv2[None, :, 1])
        disp = self.uv1[:, None, 0] - self.uv2[None, :, 0]
        return ((dv <= self.band[None, :]) & (disp >= -2.0) & (disp <= self.max_d)
                & level_mask(self.lvl1, self.lvl2, self.lo, self.hi))


def epipolar_lines(uv1, F12) -> torch.Tensor:
    """The epipolar lines in view 2 of view 1's keypoints ``uv1`` [N, 2]
    under the fundamental matrix ``F12`` [3, 3]: [N, 3]."""
    x1 = torch.nn.functional.pad(uv1, (0, 1), value=1.0)   # (u, v, 1)
    return x1 @ F12.T


def epipolar_gate(lines, uv2, sigma2, thresh: float = 3.84) -> torch.Tensor:
    """Point-to-epiline distance gate (CheckDistEpipolarLine) of the lines
    [N, 3] against view 2's keypoints ``uv2`` [M, 2]: bool [N, M]. Each
    operation rounds alone; ``csrc/match.cu``'s epipolar mode repeats them."""
    num = torch.abs(lines[:, None, 0] * uv2[None, :, 0]
                    + lines[:, None, 1] * uv2[None, :, 1] + lines[:, None, 2])
    den2 = lines[:, 0] ** 2 + lines[:, 1] ** 2
    d2 = num * num / torch.clamp(den2[:, None], min=1e-12)
    return d2 < thresh * sigma2[None, :]


class EpipolarMask(NamedTuple):
    """The epipolar gate of a keyframe pair (``slam/triangulation``):
    ``d2 < thresh x sigma2[m]``, d2 the squared distance of column m's
    keypoint from row n's epipolar line."""

    lines: torch.Tensor    # [N, 3] float32, ``epipolar_lines``
    uv2: torch.Tensor      # [M, 2] float32 view-2 keypoints
    sigma2: torch.Tensor   # [M] float32 squared level sigma of view 2's keypoints
    thresh: float = 3.84   # chi2 at 95%, one dof
    COLUMN_FIELDS = ("uv2", "sigma2")

    def dense(self) -> torch.Tensor:
        return epipolar_gate(self.lines, self.uv2, self.sigma2, self.thresh)


def masked_best2_plain(dist: torch.Tensor, mask: torch.Tensor):
    """Per-row (best_idx, best, second) over masked columns (masked = BIG)."""
    d = torch.where(mask, dist, BIG)
    idx = torch.argmin(d, dim=1)           # first index on ties, as jnp.argmin
    best = torch.gather(d, 1, idx[:, None])[:, 0]
    cols = torch.arange(d.shape[1], device=d.device)
    d2 = torch.where(cols[None, :] == idx[:, None], BIG, d)
    second = torch.min(d2, dim=1).values
    return idx, best, second


def match_best2_plain(d1, d2, valid1, valid2, mask=None, mutual: bool = False):
    """The dense chain: Hamming matrix, [N, M] mask, row (and column) minima."""
    dist = hamming_matrix_plain(d1, d2)
    full_mask = valid1[:, None] & valid2[None, :]
    if mask is not None:
        full_mask = full_mask & (mask if isinstance(mask, torch.Tensor) else mask.dense())
    idx, best, second = masked_best2_plain(dist, full_mask)
    back = torch.argmin(torch.where(full_mask, dist, BIG), dim=0) if mutual else None
    return idx, best, second, back


def match_best2(d1, d2, valid1, valid2, mask=None, mutual: bool = False):
    """Row-wise best two admitted columns of the masked Hamming matrix.

    ``d1`` [N, 8], ``d2`` [M, 8] int32 descriptor words; ``valid1`` [N],
    ``valid2`` [M] bool; ``mask`` a ``WindowMask``, a ``StereoMask``, an
    ``EpipolarMask``, a bool [N, M] or None. Returns ``(idx, best, second,
    back)``: ``idx`` [N] int64
    the first column of the row's minimum (0 if no pair is admitted),
    ``best`` [N] int32 that minimum, ``second`` [N] int32 the minimum over
    the other columns (both ``BIG`` where there is none), and with
    ``mutual`` ``back`` [M] int64, the first row of each column's minimum
    (0 if none), else None."""
    for d in (d1, d2):
        if d.ndim != 2 or d.shape[1] != 8 or d.dtype != torch.int32:
            raise ValueError(f"match_best2 takes int32 [n, 8] descriptors, got "
                             f"{d.dtype} {tuple(d.shape)}")
    N, M = d1.shape[0], d2.shape[0]
    if valid1.shape != (N,) or valid2.shape != (M,) or valid1.dtype != torch.bool \
            or valid2.dtype != torch.bool:
        raise ValueError("match_best2: valid1 [N] and valid2 [M] must be bool")
    tensors = [d1, d2, valid1, valid2]
    tensors += [x for x in (mask if isinstance(mask, tuple) else (mask,))
                if isinstance(x, torch.Tensor)]
    if any(x.device != d1.device for x in tensors):
        raise ValueError("match_best2: operands on different devices")
    if d1.device.type not in ("cpu", "cuda"):
        raise ValueError(f"match_best2: unsupported device {d1.device}")
    cpu = d1.device.type == "cpu"
    if M > max_columns(mask) and N > 0:
        one = match_best2_plain if cpu else functools.partial(_match_best2_cuda, chunk=True)
        return _match_best2_chunked(one, d1, d2, valid1, valid2, mask, mutual)
    return (match_best2_plain if cpu else _match_best2_cuda)(d1, d2, valid1, valid2, mask, mutual)


def _arg(x: torch.Tensor, shape, dtype, name: str) -> torch.Tensor:
    if tuple(x.shape) != tuple(shape) or x.dtype != dtype:
        raise ValueError(f"match_best2: {name} must be {dtype} {tuple(shape)}, got "
                         f"{x.dtype} {tuple(x.shape)}")
    return x.contiguous()


def aligned(x: torch.Tensor | None, n: int) -> torch.Tensor | None:
    """``x`` where its data starts at an ``n``-byte boundary, else a copy."""
    return x if x is None or x.data_ptr() % n == 0 else x.clone()


def chunk_bounds(M: int, mask) -> list[tuple[int, int]]:
    """Side 2's column chunks [c0, c1) for a launch each under ``mask`` (or
    its class): as few as the mode's columns allow, of equal size but the
    last."""
    if M <= 0:
        return []
    n_chunks = -(-M // max_columns(mask))
    step = -(-M // n_chunks)
    return [(c0, min(c0 + step, M)) for c0 in range(0, M, step)]


def _match_best2_chunked(one, d1, d2, valid1, valid2, mask, mutual: bool, colbest=None):
    """A match against more columns than one launch takes: ``one`` (the
    kernel's launcher, or the plain version) matches each chunk of columns
    (into its slice of ``colbest`` where one is given), merged per row."""
    idx = best = second = None
    backs = []
    for c0, c1 in chunk_bounds(d2.shape[0], mask):
        extra = {} if colbest is None else {"colbest": colbest[c0:c1], "chained": c0 == 0}
        i, b, s, back = one(d1, d2[c0:c1], valid1, valid2[c0:c1], columns(mask, c0, c1),
                            mutual, **extra)
        i = i + c0
        if idx is None:
            idx, best, second = i, b, s
        else:
            keep = best <= b                      # the earlier chunk wins a tie
            idx = torch.where(keep, idx, i)
            second = torch.where(keep, torch.minimum(second, b), torch.minimum(best, s))
            best = torch.where(keep, best, b)
        backs.append(back)
    # (a row with no admitted column keeps the first chunk's idx 0)
    if colbest is not None:
        return idx, best, second, colbest
    return idx, best, second, torch.cat(backs) if mutual else None


def match_best2_packed(d1, d2, valid1, valid2, mask, colbest):
    """``match_best2(..., mutual=True)`` on CUDA tensors into ``colbest``,
    an int64 [M] buffer already filled with ``BIG << 32`` by the launch just
    before this one on the stream (``csrc/stereo.cu``'s prep launch): the
    match is that launch's programmatic dependent. Returns ``(idx, best,
    second, colbest)`` with ``colbest`` as the kernel leaves it, each
    column's ``best << 32 | first row`` (``back`` is its low 32 bits). One
    launch (one a column chunk where side 2 exceeds the mode's columns)."""
    if d2.shape[0] > max_columns(mask) and d1.shape[0] > 0:
        one = functools.partial(_match_best2_cuda, chunk=True)
        return _match_best2_chunked(one, d1, d2, valid1, valid2, mask, True, colbest)
    return _match_best2_cuda(d1, d2, valid1, valid2, mask, True, colbest=colbest,
                             chained=True)


def _match_best2_cuda(d1, d2, valid1, valid2, mask, mutual: bool, chunk: bool = False,
                      colbest=None, chained: bool = False):
    """Launch ``csrc/match.cu`` on the current stream; ``chunk`` says that
    side 2 is one column chunk of a larger one (for the launch counts);
    ``colbest`` is a filled buffer for ``match_best2_packed``, and
    ``chained`` launches the stereo mode as the programmatic dependent of
    the launch that filled it."""
    global launches
    N, M = d1.shape[0], d2.shape[0]
    dev = d1.device
    f32, i32 = torch.float32, torch.int32
    uv1 = lvl1 = radius = uv2 = lvl2 = band = dense = lines = sigma2 = None
    lo, hi, max_d, thresh = -1, 1, 0.0, 0.0
    if isinstance(mask, WindowMask):
        mode = 0
        uv1, radius = _arg(mask.uv1, (N, 2), f32, "uv1"), _arg(mask.radius, (N,), f32, "radius")
        lvl1 = _arg(mask.lvl1, (N,), i32, "lvl1")
        uv2, lvl2 = _arg(mask.uv2, (M, 2), f32, "uv2"), _arg(mask.lvl2, (M,), i32, "lvl2")
        lo, hi = int(mask.lo), int(mask.hi)
    elif isinstance(mask, StereoMask):
        mode = 1
        uv1, lvl1 = _arg(mask.uv1, (N, 2), f32, "uv1"), _arg(mask.lvl1, (N,), i32, "lvl1")
        uv2, lvl2 = _arg(mask.uv2, (M, 2), f32, "uv2"), _arg(mask.lvl2, (M,), i32, "lvl2")
        band = _arg(mask.band, (M,), f32, "band")
        lo, hi, max_d = int(mask.lo), int(mask.hi), float(mask.max_d)
    elif isinstance(mask, EpipolarMask):
        mode = 3
        lines = _arg(mask.lines, (N, 3), f32, "lines")
        uv2, sigma2 = _arg(mask.uv2, (M, 2), f32, "uv2"), _arg(mask.sigma2, (M,), f32, "sigma2")
        thresh = float(mask.thresh)
    elif mask is None or isinstance(mask, torch.Tensor):
        mode = 2
        if mask is not None:
            dense = _arg(mask, (N, M), torch.bool, "mask")
    else:
        raise ValueError(f"match_best2: unsupported mask {type(mask).__name__}")
    chained = chained and mode == 1

    idx = torch.empty(N, dtype=torch.int64, device=dev)
    best = torch.empty(N, dtype=i32, device=dev)
    second = torch.empty(N, dtype=i32, device=dev)
    unpack = mutual and colbest is None   # back = the low 32 bits of a buffer made here
    if colbest is not None and (tuple(colbest.shape) != (M,) or colbest.dtype != torch.int64
                                or not colbest.is_contiguous() or colbest.device != dev):
        raise ValueError(f"match_best2: colbest must be a contiguous int64 [{M}] on {dev}")
    if unpack:
        colbest = torch.full((M,), BIG << 32, dtype=torch.int64, device=dev)
    if N == 0:
        return idx, best, second, colbest & 0xFFFFFFFF if unpack else colbest
    lib = build.library()
    if M == 0 or M > lib.tc2li_match_max_columns(mode):
        raise ValueError(f"match_best2: M={M} columns do not fit one launch "
                         f"(1..{lib.tc2li_match_max_columns(mode)})")
    # the kernels read 16-byte descriptor words, 8-byte positions and (the
    # dense mode) 16-byte words of side 2's flags
    a, b = aligned(d1.contiguous(), 16), aligned(d2.contiguous(), 16)
    v1, v2 = valid1.contiguous(), valid2.contiguous()
    uv1, uv2 = aligned(uv1, 8), aligned(uv2, 8)
    if mode == 2:
        v2 = aligned(v2, 16)
    if chained:   # a copy made here would run between the match and its primary
        given = (d1, d2, valid1, valid2, mask.uv1, mask.lvl1, mask.uv2, mask.lvl2, mask.band)
        used = (a, b, v1, v2, uv1, lvl1, uv2, lvl2, band)
        if any(x.data_ptr() != y.data_ptr() for x, y in zip(given, used)):
            raise ValueError("match_best2: a chained stereo match takes its inputs contiguous "
                             "and aligned (16-byte descriptors, 8-byte positions) as given")
    stream = torch.cuda.current_stream(dev).cuda_stream

    def ptr(x):
        return None if x is None else x.data_ptr()

    build.check(lib.tc2li_match_best2(
        mode, int(mutual), int(chained), ptr(a), ptr(v1), ptr(b), ptr(v2), ptr(uv1), ptr(lvl1),
        ptr(radius), ptr(uv2), ptr(lvl2), ptr(band), ptr(dense), ptr(lines), ptr(sigma2), lo,
        hi, max_d, thresh, ptr(idx), ptr(best), ptr(second), ptr(colbest), N, M, stream),
        "match_best2")
    launches += 1
    key = mode_key(mask, mutual, chunk)
    launches_by_mode[key] = launches_by_mode.get(key, 0) + 1
    return idx, best, second, colbest & 0xFFFFFFFF if unpack else colbest
