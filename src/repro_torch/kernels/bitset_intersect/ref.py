"""Plain PyTorch version of the bitset AND+popcount kernel (the CPU path
and the on-card oracle)."""
from __future__ import annotations

import torch


def popcount_u32(x: torch.Tensor) -> torch.Tensor:
    """Popcount of 32-bit words held in int64 lanes (values in [0, 2^32))."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


def bitset_and_popcount_ref(words: torch.Tensor, pos_a: torch.Tensor,
                            pos_b: torch.Tensor) -> torch.Tensor:
    """out[i] = popcount(words[pos_a[i]] & words[pos_b[i]]) summed over the
    block's words; ``words`` is the int32 view of the uint32 table.  One
    word column at a time, so temporaries stay [P]."""
    out = torch.zeros(pos_a.shape[0], dtype=torch.int64, device=words.device)
    for k in range(words.shape[1]):
        col = words[:, k]
        x = (col.index_select(0, pos_a) & col.index_select(0, pos_b))
        out += popcount_u32(x.to(torch.int64) & 0xFFFFFFFF)
    return out.to(torch.int32)
