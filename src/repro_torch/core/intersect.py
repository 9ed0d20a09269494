"""Set-intersection operators (paper Section 4.2, Appendix B.2).

Counterpart of ``repro.core.intersect``.  EmptyHeaded's profiling showed
>95% of WCOJ runtime is set intersection.  Three intersection kinds, as
in the paper:

  * ``uint ∩ uint``     — the smaller set's elements are searched in the
    larger one with a lockstep branch-free binary search (cost ∝
    |smaller| · log|larger|, the **min property** of Section 2.1).
  * ``bitset ∩ bitset`` — intersect block offsets (as uint sets), then AND
    the matched 2^k-bit blocks and popcount.  On the device backend the
    whole count is the ``bitset_intersect`` CUDA kernel's
    ``bitset_pair_count``, injected into the layout store; the host oracle
    takes :func:`bitset_intersect_count`.
  * ``uint ∩ bitset``   — probe each uint element into the bitset blocks.

The data-dependent expansions run on the host in numpy, as in the
reference; the searches run on the caller's device in torch, with the
positions and membership flags brought back through ``host_get``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from repro_torch.kernels.common import IDX, host_get


# ----------------------------------------------------------------- popcount
def popcount_u32_np(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.uint32)
    x = x - ((x >> 1) & np.uint32(0x55555555))
    x = (x & np.uint32(0x33333333)) + ((x >> 2) & np.uint32(0x33333333))
    x = (x + (x >> 4)) & np.uint32(0x0F0F0F0F)
    return ((x * np.uint32(0x01010101)) >> 24).astype(np.int32)


# ------------------------------------------------- branch-free segment search
def segment_searchsorted(values: torch.Tensor, lo, hi, queries):
    """For each i: insertion index of ``queries[i]`` in the sorted segment
    ``values[lo[i]:hi[i]]`` (absolute index into ``values``), and whether
    ``values[pos] == queries[i]`` inside the segment.

    Every lane runs the same lockstep lower-bound loop as the reference
    (identical mid/clip/where updates), so positions and membership are
    bit-exact with it.  The reference always runs 34 steps; a segment of
    ``s`` values converges after ``s.bit_length()`` steps and stays put,
    so ``values.numel().bit_length() + 1`` steps give the same result.
    Returns ``(pos int32, found bool)`` on ``values``' device."""
    dev = values.device
    n = int(values.shape[0])
    lo = torch.as_tensor(lo, device=dev).to(IDX)
    hi0 = torch.as_tensor(hi, device=dev).to(IDX)
    q = torch.as_tensor(queries, device=dev)
    if n == 0:
        return lo, torch.zeros(lo.shape, dtype=torch.bool, device=dev)
    hi_ = hi0
    for _ in range(n.bit_length() + 1):
        mid = (lo + hi_) >> 1
        v = values[mid.clamp(0, n - 1)]
        open_ = lo < hi_
        right = v < q
        lo = torch.where(open_ & right, mid + 1, lo)
        hi_ = torch.where(open_ & ~right, mid, hi_)
    found = (lo < hi0) & (values[lo.clamp(0, n - 1)] == q)
    return lo, found


# --------------------------------------------------------- uint ∩ uint pairs
def _expand_smaller(offsets: np.ndarray, neighbors: np.ndarray,
                    u: np.ndarray, v: np.ndarray):
    """Expansion step: for each pair (u_i, v_i) pick the smaller endpoint set
    (min property) and flatten its elements, remembering the pair id and the
    search segment of the larger set."""
    deg = np.diff(offsets)
    du, dv = deg[u], deg[v]
    swap = du > dv
    small = np.where(swap, v, u)
    large = np.where(swap, u, v)
    cnt = deg[small]
    pair_id = np.repeat(np.arange(len(u), dtype=np.int64), cnt)
    starts = offsets[small]
    base = np.repeat(starts, cnt)
    local = np.arange(len(pair_id), dtype=np.int64)
    seg_start = np.repeat(np.concatenate([[0], np.cumsum(cnt)])[:-1], cnt)
    elem_idx = base + (local - seg_start)
    q = neighbors[elem_idx]
    lo = offsets[large][pair_id]
    hi = offsets[large + 1][pair_id]
    return pair_id, elem_idx, q, lo, hi


def intersect_count_uint(offsets: np.ndarray, neighbors: np.ndarray,
                         u: np.ndarray, v: np.ndarray,
                         neighbors_dev: torch.Tensor,
                         chunk: int = 1 << 22) -> np.ndarray:
    """|N(u_i) ∩ N(v_i)| for each pair of a CSR (host expansion, lockstep
    search against ``neighbors_dev``, the device copy of ``neighbors``),
    in chunks to bound memory."""
    u = np.asarray(u, dtype=np.int64)
    v = np.asarray(v, dtype=np.int64)
    out = np.zeros(len(u), dtype=np.int64)
    if len(u) == 0:
        return out
    pair_id, _, q, lo, hi = _expand_smaller(offsets, neighbors, u, v)
    for s in range(0, len(pair_id), chunk):
        e = min(s + chunk, len(pair_id))
        _, found = segment_searchsorted(neighbors_dev, lo[s:e], hi[s:e],
                                        q[s:e])
        np.add.at(out, pair_id[s:e], host_get(found).astype(np.int64))
    return out


def intersect_pairs_uint(offsets: np.ndarray, neighbors: np.ndarray,
                         u: np.ndarray, v: np.ndarray,
                         neighbors_dev: torch.Tensor):
    """Materializing variant: returns (pair_id, value, pos_u, pos_v) for every
    element of N(u_i) ∩ N(v_i). Positions are absolute indices into
    ``neighbors`` for descent into deeper trie levels."""
    u = np.asarray(u, dtype=np.int64)
    v = np.asarray(v, dtype=np.int64)
    if len(u) == 0:
        z = np.zeros(0, np.int64)
        return z, np.zeros(0, np.int32), z, z
    deg = np.diff(offsets)
    swap = deg[u] > deg[v]
    pair_id, elem_idx, q, lo, hi = _expand_smaller(offsets, neighbors, u, v)
    pos, found = host_get(segment_searchsorted(neighbors_dev, lo, hi, q))
    keep = found
    pair_id = pair_id[keep]
    vals = q[keep]
    small_pos = elem_idx[keep]
    large_pos = pos[keep].astype(np.int64)
    sw = swap[pair_id]
    pos_u = np.where(sw, large_pos, small_pos)
    pos_v = np.where(sw, small_pos, large_pos)
    return pair_id, vals, pos_u, pos_v


# -------------------------------------------------------------- blocked bitset
@dataclasses.dataclass
class BlockedBitset:
    """Paper Figure 6: a set is (offsets, bitvector-blocks, indices).

    ``block_ids`` play the role of the paper's offsets o_1..o_n (stored as a
    uint set, intersected with the uint algorithm); ``words`` are the
    bitvector blocks b_1..b_n; ``index`` mirrors the paper's i_1..i_n
    (cumulative cardinality before each block — used to address associated
    values / next-trie-level pointers).
    """

    block_bits: int
    set_ids: np.ndarray     # [S] original ids in this cohort, sorted
    offsets: np.ndarray     # [S+1] CSR over blocks
    block_ids: np.ndarray   # [B] int32 block numbers, sorted per set
    words: np.ndarray       # [B, block_bits//32] uint32
    index: np.ndarray       # [B] int64 cumulative cardinality before block
    card: np.ndarray        # [B] int64 cardinality of each block
    slot_of: np.ndarray     # [n_ids] int32 -> slot in set_ids, or -1

    def nbytes(self) -> int:
        """Bytes of the paper's layout (the reference's count): block ids,
        words, index, the block CSR and the set ids; not ``card`` or
        ``slot_of``, which only route."""
        return (self.block_ids.nbytes + self.words.nbytes + self.index.nbytes
                + self.offsets.nbytes + self.set_ids.nbytes)


def build_blocked_bitset(offsets: np.ndarray, neighbors: np.ndarray,
                         ids: np.ndarray, n_total: int,
                         block_bits: int = 256) -> BlockedBitset:
    """Render the neighbor sets of ``ids`` into the blocked-bitset layout."""
    ids = np.asarray(ids, dtype=np.int64)
    wpb = block_bits // 32
    deg = np.diff(offsets)
    cnt = deg[ids] if len(ids) else np.zeros(0, np.int64)
    set_idx = np.repeat(np.arange(len(ids), dtype=np.int64), cnt)
    starts = offsets[ids] if len(ids) else np.zeros(0, np.int64)
    base = np.repeat(starts, cnt)
    local = np.arange(len(set_idx), dtype=np.int64)
    seg_start = np.repeat(np.concatenate([[0], np.cumsum(cnt)])[:-1], cnt)
    elems = neighbors[base + (local - seg_start)].astype(np.int64)

    blk = elems // block_bits
    bit = elems % block_bits
    key = set_idx * ((n_total // block_bits) + 2) + blk
    uniq_key, block_of_elem = np.unique(key, return_inverse=True)
    n_blocks = len(uniq_key)
    words = np.zeros((n_blocks, wpb), dtype=np.uint32)
    w_idx = bit // 32
    mask = (np.uint32(1) << (bit % 32).astype(np.uint32)).astype(np.uint32)
    np.bitwise_or.at(words, (block_of_elem, w_idx), mask)

    blk_set = (uniq_key // ((n_total // block_bits) + 2)).astype(np.int64)
    blk_id = (uniq_key % ((n_total // block_bits) + 2)).astype(np.int32)
    counts = np.bincount(blk_set, minlength=len(ids))
    off = np.zeros(len(ids) + 1, dtype=np.int64)
    np.cumsum(counts, out=off[1:])
    # cumulative cardinality per block within each set
    card = popcount_u32_np(words).sum(axis=1).astype(np.int64)
    cum = np.cumsum(card) - card
    seg_base = np.repeat(cum[off[:-1]], counts) if n_blocks else cum
    index = cum - seg_base

    slot_of = np.full(n_total, -1, dtype=np.int32)
    slot_of[ids] = np.arange(len(ids), dtype=np.int32)
    return BlockedBitset(block_bits, ids, off, blk_id, words, index, card,
                         slot_of)


def bitset_intersect_count(bs: BlockedBitset, a_slots: np.ndarray,
                           b_slots: np.ndarray, word_and_popcount: Callable,
                           block_ids_dev: torch.Tensor,
                           words_dev: torch.Tensor) -> np.ndarray:
    """|S_a ∩ S_b| for slot pairs, both sets in the bitset cohort.

    Step 1 intersects the block-id lists with the uint machinery (the paper:
    "we pack the offsets contiguously, which allows us to regard the offsets
    as a uint layout"). Step 2 ANDs matched blocks and popcounts:
    ``word_and_popcount(words_dev, pos_a, pos_b)`` gathers the matched rows
    of the device word table itself.  The host oracle's route; the device
    backend's runs both steps in one kernel (``bitset_pair_count``).
    """
    pair_id, _, pos_a, pos_b = intersect_pairs_uint(
        bs.offsets, bs.block_ids, np.asarray(a_slots, np.int64),
        np.asarray(b_slots, np.int64), block_ids_dev)
    out = np.zeros(len(a_slots), dtype=np.int64)
    if len(pair_id) == 0:
        return out
    dev = words_dev.device
    per_block = word_and_popcount(
        words_dev, torch.as_tensor(pos_a.astype(np.int32), device=dev),
        torch.as_tensor(pos_b.astype(np.int32), device=dev))
    np.add.at(out, pair_id, host_get(per_block).astype(np.int64))
    return out


def bitset_intersect_materialize(bs: BlockedBitset, a_slots: np.ndarray,
                                 b_slots: np.ndarray,
                                 block_ids_dev: torch.Tensor):
    """Materializing bitset∩bitset on the host: every element of
    S_a ∩ S_b plus its RANK (position) within each endpoint's sorted set,
    from the per-block ``index`` plus a popcount of the endpoint's word
    bits below the element.

    Returns ``(pair_id, values, rank_a, rank_b)``, pair-major with values
    ascending within each pair (the canonical expansion order of the
    search path).
    """
    a_slots = np.asarray(a_slots, np.int64)
    b_slots = np.asarray(b_slots, np.int64)
    pair_id, _blk, pos_a, pos_b = intersect_pairs_uint(
        bs.offsets, bs.block_ids, a_slots, b_slots, block_ids_dev)
    z = np.zeros(0, np.int64)
    if len(pair_id) == 0:
        return z, np.zeros(0, np.int32), z, z
    wa = bs.words[pos_a]                      # [B', wpb] uint32
    wb = bs.words[pos_b]
    wand = wa & wb
    flat = np.unpackbits(wand.view(np.uint8), axis=1, bitorder="little")
    blk_row, bitpos = np.nonzero(flat)
    word_idx = bitpos >> 5
    bit_idx = bitpos & 31
    vals = (bs.block_ids[pos_a[blk_row]].astype(np.int64) * bs.block_bits
            + bitpos)
    below = (np.uint32(1) << bit_idx.astype(np.uint32)) - np.uint32(1)

    def rank(words, pos):
        per_word = popcount_u32_np(words)             # [B', wpb]
        cum = np.cumsum(per_word, axis=1) - per_word  # exclusive per word
        return (bs.index[pos[blk_row]]
                + cum[blk_row, word_idx]
                + popcount_u32_np(words[blk_row, word_idx] & below))

    return (pair_id[blk_row], vals.astype(np.int32),
            rank(wa, pos_a).astype(np.int64),
            rank(wb, pos_b).astype(np.int64))


def uint_bitset_intersect_count(offsets, neighbors, u: np.ndarray,
                                bs: BlockedBitset, b_slots: np.ndarray,
                                block_ids_dev: torch.Tensor) -> np.ndarray:
    """uint ∩ bitset (Section 4.2): probe each uint element into the bitset.

    Masks the low bits of each element to get its block id, searches the
    block-id (uint) list, then tests the bit. Min property holds with a
    constant set by the block size."""
    u = np.asarray(u, dtype=np.int64)
    b_slots = np.asarray(b_slots, dtype=np.int64)
    deg = np.diff(offsets)
    cnt = deg[u]
    pair_id = np.repeat(np.arange(len(u), dtype=np.int64), cnt)
    starts = offsets[u]
    base = np.repeat(starts, cnt)
    local = np.arange(len(pair_id), dtype=np.int64)
    seg_start = np.repeat(np.concatenate([[0], np.cumsum(cnt)])[:-1], cnt)
    elems = neighbors[base + (local - seg_start)].astype(np.int64)

    blk = (elems // bs.block_bits).astype(np.int32)
    lo = bs.offsets[b_slots][pair_id]
    hi = bs.offsets[b_slots + 1][pair_id]
    pos, found = host_get(segment_searchsorted(block_ids_dev, lo, hi, blk))
    bit = elems % bs.block_bits
    w = bs.words[np.clip(pos, 0, len(bs.block_ids) - 1), bit // 32]
    hit = found & (((w >> (bit % 32).astype(np.uint32)) & 1).astype(bool))
    out = np.zeros(len(u), dtype=np.int64)
    np.add.at(out, pair_id, hit.astype(np.int64))
    return out
