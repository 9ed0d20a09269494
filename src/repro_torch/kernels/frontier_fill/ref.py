"""Plain PyTorch versions of the frontier-fill and frontier-fold kernels
(the CPU path and the on-card oracles).

``fill_ref``: slots ``j`` in ``[start, start + n)`` invert the
exclusive-scan offsets back to source frontier rows, gather the seed
values, and probe every other constraining atom with the lockstep search
of ``core.intersect.segment_searchsorted``.  Slots at or past ``total_c``
come out masked: keep False, every other output 0.  All arithmetic is
int32, so the kernel must match this bit for bit.

``fold_ref``: the same expansion over every row's candidates, each kept
candidate's semiring contribution (one times the leaf annotations at its
positions) reduced onto its row, plus the per-row support count.  Integer,
min/max and boolean folds are order-free and bit-exact; a float sum may
differ from the kernel's reduction order in the last place.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch

from repro_torch.core.intersect import segment_searchsorted


def fill_ref(total_c: torch.Tensor, offs: torch.Tensor, lo0: torch.Tensor,
             seed: torch.Tensor, probes: Sequence[Tuple], start: int,
             n: int):
    dev = offs.device
    cap_in = int(offs.shape[0])
    n0 = int(seed.shape[0])
    j = start + torch.arange(n, dtype=torch.int64, device=dev)
    live = j < total_c
    j = torch.where(live, j, 0).to(torch.int32)
    row = (torch.searchsorted(offs, j, right=True, out_int32=True) - 1
           ).clamp(0, cap_in - 1)
    p0 = lo0[row] + (j - offs[row])
    vals = seed[p0.clamp(0, max(n0 - 1, 0))]
    keep = live
    poss = []
    for vk, lo_k, hi_k in probes:
        pk, fk = segment_searchsorted(vk, lo_k[row], hi_k[row], vals)
        poss.append(torch.where(live, pk, 0))
        keep = keep & fk

    def mask(x):
        return torch.where(live, x, 0)

    return mask(vals), mask(row), mask(p0), keep, tuple(poss)


def fold_ref(lo0: torch.Tensor, cnt: torch.Tensor, seed: torch.Tensor,
             probes: Sequence[Tuple], leaf_anns: Sequence, sr):
    dev = lo0.device
    cap_in = int(lo0.shape[0])
    n0 = int(seed.shape[0])
    counts = cnt.to(torch.int64)
    total = int(counts.sum())
    row = torch.repeat_interleave(
        torch.arange(cap_in, dtype=torch.int64, device=dev), counts,
        output_size=total)
    first = torch.cumsum(counts, 0) - counts
    p0 = (lo0.to(torch.int64)[row]
          + torch.arange(total, dtype=torch.int64, device=dev) - first[row])
    vals = seed[p0.clamp(0, max(n0 - 1, 0))]
    keep = torch.ones(total, dtype=torch.bool, device=dev)
    poss = [p0]
    for vk, lo_k, hi_k in probes:
        pk, fk = segment_searchsorted(vk, lo_k[row], hi_k[row], vals)
        poss.append(pk)
        keep = keep & fk
    contrib = sr.lift(total, device=dev)
    for la, pos in zip(leaf_anns, poss):
        if la is not None:
            contrib = sr.mul(contrib, la[pos.clamp(0, la.shape[0] - 1)])
    zero = torch.full((), sr.zero, dtype=sr.dtype, device=dev)
    contrib = torch.where(keep, contrib, zero)
    folded = sr.add(torch.full((cap_in,), sr.zero, dtype=sr.dtype,
                               device=dev),
                    sr.segment_reduce(contrib, row, cap_in))
    supp = torch.zeros(cap_in, dtype=torch.int32, device=dev).index_add_(
        0, row, keep.to(torch.int32))
    return folded, supp
