"""Small tensor helpers shared across the port."""

from __future__ import annotations

import numpy as np
import torch


def to_device(x, dtype: torch.dtype | None, device) -> torch.Tensor:
    """Host data -> device tensor without a stream sync (pinned, async);
    ``dtype`` None keeps the data's own."""
    t = torch.as_tensor(np.asarray(x), dtype=dtype)
    if torch.device(device).type == "cuda":
        t = t.pin_memory()
    return t.to(device, non_blocking=True)


def count(mask: torch.Tensor, dim=None) -> torch.Tensor:
    """Number of True entries as int32, like the reference's counters
    (``torch.sum`` of an integer tensor returns int64)."""
    if dim is None:
        return torch.sum(mask, dtype=torch.int32)
    return torch.sum(mask, dim=dim, dtype=torch.int32)


def sum_rows(n: int, idx: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """[n, ...] sums of the rows of ``values`` by ``idx``, as ``index_add_``
    into zeros, in the same order on every call. On the card a float
    ``index_add_`` adds with atomics, whose order (and so the last bits of
    the sums) changes from run to run; ``index_put_`` with ``accumulate``
    sorts the indices stably and adds each run of equal indices in row
    order, one run at a time (it is not on the list of
    ``torch.use_deterministic_algorithms``)."""
    out = torch.zeros((n, *values.shape[1:]), dtype=values.dtype, device=values.device)
    return out.index_put_((idx,), values, accumulate=True)


def matvec(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Batched matrix-vector product: [..., n, m] x [..., m] -> [..., n]."""
    return (M @ v[..., None])[..., 0]


def axis_vector(axis: int, value: float, device, dtype=torch.float32, n: int = 3) -> torch.Tensor:
    """``value`` times the unit vector ``axis`` of R^n, built on the device
    (a constant made from a Python list, or a Python scalar assigned to one
    slot, would be a blocking host copy; a fill is not)."""
    v = torch.zeros(n, dtype=dtype, device=device)
    v[axis:axis + 1].fill_(value)
    return v
