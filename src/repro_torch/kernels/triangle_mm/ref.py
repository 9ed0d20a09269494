"""Plain PyTorch version of the dense triangle-count kernel (the CPU path
and the on-card oracle)."""
from __future__ import annotations

import torch


def triangle_count_dense_ref(a: torch.Tensor) -> torch.Tensor:
    """sum((A @ A) * A) over a 0/1 adjacency, in float64 (exact for
    counts below 2^53); a 0-d float64 tensor."""
    a = a.to(torch.float64)
    return ((a @ a) * a).sum()


def tile_stats(a: torch.Tensor, tile: int = 32) -> tuple:
    """What the kernel's count pass visits on ``a`` (n a multiple of
    ``tile``): the number of occupied ``tile x tile`` tiles (I, J), and
    the number of tile triples (I, K, J) whose three tiles (I, J),
    (I, K) and (K, J) are all occupied."""
    nt = int(a.shape[0]) // tile
    occ = (a != 0).view(nt, tile, nt, tile).any(3).any(1).to(torch.float64)
    return int(occ.sum()), int(((occ @ occ) * occ).sum())
