"""Hamming distance matrix: hand-written CUDA kernel + its plain version.

Replaces ``tc2li_slam_tpu/ops/kernels/hamming.py:hamming_matrix_mxu`` (the
TPU's bf16 matrix-unit formulation over unpacked bits). The matchers of
``ops.matching`` no longer come here: they never need the matrix and use the
fused mask-first kernel of ``ops.kernels.match``. This one serves callers
that want all distances (``slam.culling.fuse_duplicates``).

Bound on the H100: operations, the popcount unit. 32768 x 2000 distances
are 524 M ``__popc`` at 16 per clock per SM (~3.7 T/s on 132 SMs), ~141 us,
more than the 262 MB int32 store (~78 us at 3.35 TB/s); the inputs are 32
bytes per descriptor. The kernel (``csrc/hamming.cu``) computes XOR +
``__popc`` over the 8 words of a pair from a 32 x 32 shared-memory tile of
each side, with coalesced row stores, and runs at that unit's rate.

Descriptors are int32 tensors holding the uint32 bit patterns (torch's
uint32 supports few ops). Torch has no popcount, so the plain version looks
bytes up in a 256-entry table on the uint8 view, in row chunks that bound
its memory. ``hamming_matrix`` launches the kernel for CUDA tensors and runs
the plain version for CPU tensors; there is no other route.
"""

from __future__ import annotations

import torch

from ...tensors import to_device
from . import build

launches = 0   # kernel launches by hamming_matrix (plain-version calls excluded)

_POPCOUNT8 = [bin(i).count("1") for i in range(256)]
_popcount_tables: dict[torch.device, torch.Tensor] = {}
_CHUNK_BYTES = 1 << 24   # byte lookups per chunk of the plain version


def popcount_table(device) -> torch.Tensor:
    """The 256-entry byte popcount table, int32, resident on ``device``: made
    once per device and copied there without a stream sync."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if device not in _popcount_tables:
        _popcount_tables[device] = to_device(_POPCOUNT8, torch.int32, device)
    return _popcount_tables[device]


def hamming_matrix_plain(d1: torch.Tensor, d2: torch.Tensor) -> torch.Tensor:
    """[N, 8] x [M, 8] int32 words -> [N, M] int32 distances."""
    N, M = d1.shape[0], d2.shape[0]
    lut = popcount_table(d1.device)
    out = torch.empty((N, M), dtype=torch.int32, device=d1.device)
    rows = max(1, _CHUNK_BYTES // max(32 * M, 1))
    for r0 in range(0, N, rows):
        x = torch.bitwise_xor(d1[r0:r0 + rows, None, :], d2[None, :, :])
        b = x.contiguous().view(torch.uint8)          # [n, M, 32]
        out[r0:r0 + rows] = lut[b.long()].sum(dim=-1, dtype=torch.int32)
    return out


def hamming_matrix(d1: torch.Tensor, d2: torch.Tensor) -> torch.Tensor:
    """[N, 8] x [M, 8] int32 descriptor words -> [N, M] int32 distances."""
    for d in (d1, d2):
        if d.ndim != 2 or d.shape[1] != 8 or d.dtype != torch.int32:
            raise ValueError(f"hamming_matrix takes int32 [n, 8], got "
                             f"{d.dtype} {tuple(d.shape)}")
    if d1.device != d2.device:
        raise ValueError("hamming_matrix: operands on different devices")
    if d1.device.type == "cpu":
        return hamming_matrix_plain(d1, d2)
    if d1.device.type != "cuda":
        raise ValueError(f"hamming_matrix: unsupported device {d1.device}")
    return hamming_matrix_cuda(d1, d2)


def hamming_matrix_cuda(d1: torch.Tensor, d2: torch.Tensor) -> torch.Tensor:
    """Launch ``csrc/hamming.cu`` on the current stream."""
    global launches
    N, M = d1.shape[0], d2.shape[0]
    out = torch.empty((N, M), dtype=torch.int32, device=d1.device)
    if N == 0 or M == 0:
        return out
    if N > 65535 * 32:
        raise ValueError(f"hamming_matrix: N={N} exceeds the kernel's grid")
    a = d1.contiguous()
    b = d2.contiguous()
    lib = build.library()
    stream = torch.cuda.current_stream(a.device).cuda_stream
    build.check(lib.tc2li_hamming(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                                  N, M, stream), "hamming")
    launches += 1
    return out
