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
