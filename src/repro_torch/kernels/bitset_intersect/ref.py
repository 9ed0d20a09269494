"""Plain PyTorch versions of the bitset kernels, the matched-pair AND +
popcount and the set-pair count (the CPU path and the on-card oracle)."""
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


def match_blocks_ref(offsets: torch.Tensor, block_ids: torch.Tensor,
                     a_slots: torch.Tensor, b_slots: torch.Tensor):
    """The block matching of a set-pair count, in torch on the tensors'
    device: ``(pair_id, pos_a, pos_b)`` int64 for every block id that
    both slots' lists hold, pair-major, with its row in each list.  The
    smaller list's ids are searched in the larger one's segment
    (``segment_searchsorted``), as the reference's
    ``intersect_pairs_uint`` does on the block-id lists."""
    from repro_torch.core.intersect import segment_searchsorted  # avoid cycle
    dev = block_ids.device
    off = offsets.long()
    a, b = a_slots.long(), b_slots.long()
    len_a, len_b = off[a + 1] - off[a], off[b + 1] - off[b]
    swap = len_a > len_b
    small, large = torch.where(swap, b, a), torch.where(swap, a, b)
    cnt = torch.minimum(len_a, len_b)
    total = int(cnt.sum())
    pair_id = torch.repeat_interleave(torch.arange(a.shape[0], device=dev),
                                      cnt, output_size=total)
    first = torch.cumsum(cnt, 0) - cnt
    elem = (off[small][pair_id] + torch.arange(total, device=dev)
            - first[pair_id])
    pos, found = segment_searchsorted(block_ids, off[large][pair_id],
                                      off[large + 1][pair_id],
                                      block_ids[elem])
    pair_id, small_pos, large_pos = pair_id[found], elem[found], pos[found]
    sw = swap[pair_id]
    large_pos = large_pos.long()
    return (pair_id, torch.where(sw, large_pos, small_pos),
            torch.where(sw, small_pos, large_pos))


def bitset_pair_count_ref(offsets: torch.Tensor, block_ids: torch.Tensor,
                          words: torch.Tensor, a_slots: torch.Tensor,
                          b_slots: torch.Tensor) -> torch.Tensor:
    """out[i] = |S_a ∩ S_b| for slot pairs of one blocked bitset: the
    block matching, the popcount of each matched pair's AND, and their
    sum per set pair (int64, returned as int32)."""
    pair_id, pos_a, pos_b = match_blocks_ref(offsets, block_ids, a_slots,
                                             b_slots)
    per_block = bitset_and_popcount_ref(words, pos_a, pos_b)
    out = torch.zeros(a_slots.shape[0], dtype=torch.int64,
                      device=words.device)
    return out.index_add_(0, pair_id, per_block.long()).to(torch.int32)
