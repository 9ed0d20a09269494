"""Plain PyTorch version of the uint-intersect kernel (the CPU path and
the on-card oracle): expand the smaller set of each pair, search its
elements in the larger one, sum the hits per pair."""
from __future__ import annotations

import torch

from repro_torch.core.intersect import segment_searchsorted


def intersect_count_csr_ref(offsets: torch.Tensor, neighbors: torch.Tensor,
                            u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    p = int(u.shape[0])
    off = offsets.to(torch.int64)
    u64, v64 = u.to(torch.int64), v.to(torch.int64)
    du, dv = off[u64 + 1] - off[u64], off[v64 + 1] - off[v64]
    swap = du > dv
    small = torch.where(swap, v64, u64)
    large = torch.where(swap, u64, v64)
    cnt = torch.minimum(du, dv)
    pair_id = torch.repeat_interleave(
        torch.arange(p, dtype=torch.int64, device=u.device), cnt)
    seg_start = torch.cumsum(cnt, 0) - cnt
    local = (torch.arange(pair_id.shape[0], dtype=torch.int64,
                          device=u.device) - seg_start[pair_id])
    q = neighbors[off[small][pair_id] + local]
    _, found = segment_searchsorted(neighbors, off[large][pair_id],
                                    off[large + 1][pair_id], q)
    return torch.zeros(p, dtype=torch.int32, device=u.device).index_add_(
        0, pair_id, found.to(torch.int32))
