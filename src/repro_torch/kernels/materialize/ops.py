"""Wrapper of the materializing bitset-intersection CUDA kernel
(``csrc/materialize.cu``); counterpart of
``repro.kernels.materialize.ops``.

``bitset_pair_materialize(bs, a_slots, b_slots, words, block_ids,
index)`` is the ``materialize_kernel`` the device backend injects into
:class:`repro_torch.core.layouts.HybridSetStore`, with the reference's
contract: ``(pair_id, values, rank_a, rank_b)``, pair-major with values
ascending, bit for bit equal to
:func:`repro_torch.core.intersect.bitset_intersect_materialize`.  Block
matching stays on the host, as in the reference (``intersect_pairs_uint``
over block ids); the kernel (:func:`materialize`, one launch) ANDs the
matched blocks, ranks and compacts the surviving bits on the device, into
a buffer sized by a host bound, and :func:`fetch` brings back its total
and then only the total's records.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import common
from repro_torch.kernels.materialize.ref import (HEADER, buffer_records,
                                                 buffer_total,
                                                 materialize_ref)

NAME = "materialize"


def _lib():
    lib = common.library(NAME)
    fn, tiles = lib.materialize, lib.materialize_tiles
    if fn.argtypes is None:
        lib.materialize_max_words.argtypes = []
        lib.materialize_max_words.restype = ctypes.c_int32
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int32, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
        tiles.argtypes = [ctypes.c_int32, ctypes.c_int64]
        tiles.restype = ctypes.c_int64
    return fn, tiles, lib.materialize_max_words()


def materialize(words: torch.Tensor, block_ids: torch.Tensor,
                index: torch.Tensor, pos_a: torch.Tensor,
                pos_b: torch.Tensor, pair_id: torch.Tensor,
                cap: int) -> torch.Tensor:
    """Every set bit of ``words[pos_a[p]] & words[pos_b[p]]`` with its
    pair id, value and rank in both sets.

    words : [B, W] int32 view of the uint32 bitvector blocks (on the
        card, W up to the kernel's ``materialize_max_words``, 256, and
        16-byte aligned at W = 8, where a row is two 16-byte loads)
    block_ids, index : [B] int32 block number and cumulative cardinality
        of the set before the block (``BlockedBitset.block_ids/index``)
    pos_a, pos_b, pair_id : [P] int32 matched block rows and their pair
    cap : host upper bound on the number of matches
    Returns int32 ``[HEADER + 4 * cap]`` (``ref.buffer_total`` and
    ``ref.buffer_records`` read it): the int64 total, then ``cap``
    records (pair id, value, rank a, rank b), pair-major, values
    ascending.  On the card, records past the total are not written and
    a total past ``cap`` keeps only the first ``cap`` records (``fetch``
    raises); the call reads nothing back and sizes its scratch from P.
    """
    dev = words.device
    common.check_tensor(words, "words", torch.int32, dev, ndim=2)
    for t, name in ((block_ids, "block_ids"), (index, "index"),
                    (pos_a, "pos_a"), (pos_b, "pos_b"),
                    (pair_id, "pair_id")):
        common.check_tensor(t, name, torch.int32, dev)
    if not (pos_a.shape == pos_b.shape == pair_id.shape):
        raise ValueError("pos_a, pos_b and pair_id differ in shape")
    if not 0 <= cap <= common.COUNT_LIMIT:
        raise ValueError(f"cap {cap} outside [0, {common.COUNT_LIMIT}]")
    if not common.kernel_device(words, NAME):
        return materialize_ref(words, block_ids, index, pos_a, pos_b,
                               pair_id, cap)
    fn, tiles, max_words = _lib()
    w = int(words.shape[1])
    if not 1 <= w <= max_words:
        raise ValueError(f"words: the kernel takes rows of 1 to {max_words} "
                         f"words, got {w}")
    if w == 8 and words.data_ptr() % 16:
        raise ValueError("words: rows of 8 words must be 16-byte aligned")
    p = int(pos_a.shape[0])
    out = torch.empty(HEADER + 4 * cap, dtype=torch.int32, device=dev)
    if p == 0:
        out[:HEADER] = 0
        return out
    # the ticket and one status word a tile; freed on return, reused only
    # by work queued after this call on the same stream
    scratch = torch.empty(1 + tiles(w, p), dtype=torch.int64, device=dev)
    common.check_launch(fn(words.data_ptr(), w, block_ids.data_ptr(),
                           index.data_ptr(), pos_a.data_ptr(),
                           pos_b.data_ptr(), pair_id.data_ptr(), p, cap,
                           out.data_ptr(), scratch.data_ptr(),
                           scratch.numel(), common.stream_ptr(dev)), NAME)
    return out


def fetch(buf: torch.Tensor):
    """Host ``(pair_id, values, rank_a, rank_b)`` int32 arrays of a
    :func:`materialize` buffer: its total first (8 bytes), ``ValueError``
    when that passes the buffer's capacity, then only the total's
    records, in one copy."""
    cap = (int(buf.numel()) - HEADER) // 4
    n = int(common.host_get(buffer_total(buf))[0])
    if n > cap:
        raise ValueError(f"{n} matches exceed the capacity {cap}")
    rec = common.host_get(buffer_records(buf)[:n])
    return rec[:, 0], rec[:, 1], rec[:, 2], rec[:, 3]


def bitset_pair_materialize(bs, a_slots, b_slots, words: torch.Tensor,
                            block_ids: torch.Tensor, index: torch.Tensor):
    """Materializing dense-cohort intersection through :func:`materialize`.

    ``bs`` is a :class:`repro_torch.core.intersect.BlockedBitset`; slots
    index its cohort; ``words``, ``block_ids`` and ``index`` are its int32
    tables on the device the kernel runs on.  Returns ``(pair_id int64,
    values int32, rank_a int64, rank_b int64)``.

    Transfers: the block matching's one, and the closing fetch (the
    total, then its records).  The output is sized by ``sum over matched
    blocks of min(|a|, |b|)`` (the per-block popcounts ``bs.card``), so
    nothing is read before the kernel runs.
    """
    from repro_torch.core.intersect import intersect_pairs_uint  # avoid cycle
    a_slots = np.asarray(a_slots, np.int64)
    b_slots = np.asarray(b_slots, np.int64)
    pair_id, _blk, pos_a, pos_b = intersect_pairs_uint(
        bs.offsets, bs.block_ids, a_slots, b_slots, block_ids)
    z = np.zeros(0, np.int64)
    if len(pair_id) == 0:
        return z, np.zeros(0, np.int32), z, z
    cap = int(np.minimum(bs.card[pos_a], bs.card[pos_b]).sum())
    dev = words.device

    def up(x):
        return torch.as_tensor(np.ascontiguousarray(x, dtype=np.int32),
                               device=dev)

    pid, vals, ra, rb = fetch(materialize(words, block_ids, index, up(pos_a),
                                          up(pos_b), up(pair_id), cap))
    return (pid.astype(np.int64), vals.copy(), ra.astype(np.int64),
            rb.astype(np.int64))
