"""Plain PyTorch version of the dense triangle-count kernel (the CPU path
and the on-card oracle)."""
from __future__ import annotations

import torch


def triangle_count_dense_ref(a: torch.Tensor) -> torch.Tensor:
    """sum((A @ A) * A) over a 0/1 adjacency, in float64 (exact for
    counts below 2^53); a 0-d float64 tensor."""
    a = a.to(torch.float64)
    return ((a @ a) * a).sum()
