"""Plain PyTorch version of the ELL SpMV kernel (the CPU path and the
on-card oracle): every ELL row's ``sum_k vals[r,k] * x[cols[r,k]]``,
then the rows of each vertex summed into ``y``."""
from __future__ import annotations

import torch


def spmv_ell_ref(cols: torch.Tensor, vals: torch.Tensor,
                 row_ptr: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    partial = (x[cols.long()] * vals).sum(dim=1)
    n = int(row_ptr.shape[0]) - 1
    owner = torch.repeat_interleave(
        torch.arange(n, device=x.device),
        (row_ptr[1:] - row_ptr[:-1]).long(), output_size=int(cols.shape[0]))
    return torch.zeros(n, dtype=torch.float32,
                       device=x.device).index_add_(0, owner, partial)
