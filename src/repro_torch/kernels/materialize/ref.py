"""Plain PyTorch version of the materializing bitset-intersection kernel
(the CPU path and the on-card oracle).

:func:`bitset_materialize_ref` mirrors the reference's plane oracle
(``repro.kernels.materialize.ref``): the AND of two bit planes and each
endpoint's exclusive prefix popcount along the bits.
:func:`materialize_ref` is the whole kernel's function on top of it — the
matched rows expanded to bit planes, the planes' set bits extracted with
``nonzero`` (row-major, so pair-major with bits ascending) — in chunks of
pairs so the planes stay small on the card too.

The kernel's buffer, which :func:`materialize_ref` writes too, is int32
``[HEADER + 4 * cap]``: the int64 total of matches in its first two
slots, two slots of 0, then ``cap`` records of 16 bytes, each (pair id,
value, rank in a, rank in b).
"""
from __future__ import annotations

import torch

HEADER = 4  # int32 slots before the records: the int64 total and padding


def buffer_total(buf: torch.Tensor) -> torch.Tensor:
    """The total of a materialize buffer: an int64 view ``[1]``."""
    return buf[:2].view(torch.int64)


def buffer_records(buf: torch.Tensor) -> torch.Tensor:
    """The records of a materialize buffer: an int32 view ``[cap, 4]`` of
    (pair id, value, rank a, rank b)."""
    return buf[HEADER:].view(-1, 4)


def bitset_materialize_ref(bits_a: torch.Tensor, bits_b: torch.Tensor):
    """(band, rank_a, rank_b) of int32 0/1 planes [P, B]: the AND-ed plane
    and per-endpoint exclusive prefix popcounts along the bit axis."""
    band = bits_a & bits_b
    ra = torch.cumsum(bits_a, dim=1, dtype=torch.int32) - bits_a
    rb = torch.cumsum(bits_b, dim=1, dtype=torch.int32) - bits_b
    return band, ra, rb


def expand_bits(rows: torch.Tensor) -> torch.Tensor:
    """int32 words [P, W] (views of uint32) -> int32 0/1 planes [P, W*32],
    bit t of word k at column 32k + t."""
    x = rows.to(torch.int64) & 0xFFFFFFFF
    shifts = torch.arange(32, dtype=torch.int64, device=rows.device)
    bits = (x[:, :, None] >> shifts) & 1
    return bits.reshape(rows.shape[0], -1).to(torch.int32)


def materialize_ref(words: torch.Tensor, block_ids: torch.Tensor,
                    index: torch.Tensor, pos_a: torch.Tensor,
                    pos_b: torch.Tensor, pair_id: torch.Tensor,
                    cap: int) -> torch.Tensor:
    """The kernel's function: int32 ``[HEADER + 4 * cap]`` holding the
    number of matches, then ``cap`` records of pair id, value, rank in a
    and rank in b, for every set bit of ``words[pos_a[p]] &
    words[pos_b[p]]`` in pair-major, bit-ascending order.  Slots past the
    total are 0; a total past ``cap`` raises ``ValueError``."""
    dev = words.device
    block_bits = int(words.shape[1]) * 32
    out = torch.zeros(HEADER + 4 * cap, dtype=torch.int32, device=dev)
    rec = buffer_records(out)
    chunk = max(1, (1 << 22) // block_bits)
    s = 0
    for c0 in range(0, int(pos_a.shape[0]), chunk):
        pa = pos_a[c0:c0 + chunk].long()
        pb = pos_b[c0:c0 + chunk].long()
        band, ra, rb = bitset_materialize_ref(expand_bits(words[pa]),
                                              expand_bits(words[pb]))
        row, bit = band.nonzero(as_tuple=True)
        n = int(row.numel())
        if s + n > cap:
            raise ValueError(f"{s + n} matches exceed the capacity {cap}")
        blk_a, blk_b = pa[row], pb[row]
        rec[s:s + n, 0] = pair_id[c0:c0 + chunk][row]
        rec[s:s + n, 1] = (block_ids[blk_a] * block_bits + bit).to(torch.int32)
        rec[s:s + n, 2] = index[blk_a] + ra[row, bit]
        rec[s:s + n, 3] = index[blk_b] + rb[row, bit]
        s += n
    buffer_total(out)[0] = s
    return out
