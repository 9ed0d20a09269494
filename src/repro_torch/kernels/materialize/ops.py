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
over block ids); the kernel (:func:`materialize`) ANDs the matched blocks,
ranks and compacts the surviving bits on the device, into a buffer sized
by a host bound, and one closing ``host_get`` brings the matches back.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import common
from repro_torch.kernels.materialize.ref import materialize_ref

NAME = "materialize"


def _lib():
    lib = common.library(NAME)
    count, fill = lib.materialize_count, lib.materialize_fill
    if count.argtypes is None:
        count.argtypes = [ctypes.c_void_p, ctypes.c_int32, ctypes.c_void_p,
                          ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                          ctypes.c_void_p]
        count.restype = ctypes.c_int
        fill.argtypes = [ctypes.c_void_p, ctypes.c_int32, ctypes.c_void_p,
                         ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                         ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                         ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p]
        fill.restype = ctypes.c_int
    return count, fill


def materialize(words: torch.Tensor, block_ids: torch.Tensor,
                index: torch.Tensor, pos_a: torch.Tensor,
                pos_b: torch.Tensor, pair_id: torch.Tensor,
                cap: int) -> torch.Tensor:
    """Every set bit of ``words[pos_a[p]] & words[pos_b[p]]`` with its
    pair id, value and rank in both sets.

    words : [B, W] int32 view of the uint32 bitvector blocks
    block_ids, index : [B] int32 block number and cumulative cardinality
        of the set before the block (``BlockedBitset.block_ids/index``)
    pos_a, pos_b, pair_id : [P] int32 matched block rows and their pair
    cap : host upper bound on the number of matches
    Returns int32 ``[1 + 4 * cap]``: the total, then ``cap`` slots each of
    pair id, value, rank a, rank b (pair-major, values ascending; slots
    past the total are not written by the kernel).
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
    p = int(pos_a.shape[0])
    out = torch.empty(1 + 4 * cap, dtype=torch.int32, device=dev)
    if p == 0:
        out[0] = 0
        return out
    count, fill = _lib()
    stream = common.stream_ptr(dev)
    w = int(words.shape[1])
    counts = torch.empty(p, dtype=torch.int32, device=dev)
    common.check_launch(count(words.data_ptr(), w, pos_a.data_ptr(),
                              pos_b.data_ptr(), p, counts.data_ptr(), stream),
                        NAME)
    incl = torch.cumsum(counts, 0, dtype=torch.int32)
    common.check_launch(fill(words.data_ptr(), w, block_ids.data_ptr(),
                             index.data_ptr(), pos_a.data_ptr(),
                             pos_b.data_ptr(), pair_id.data_ptr(), p,
                             incl.data_ptr(), cap, out.data_ptr(), stream),
                        NAME)
    return out


def unpack(buf: np.ndarray):
    """Host view of :func:`materialize`'s buffer: ``(pair_id, values,
    rank_a, rank_b)`` cut at the total."""
    cap = (len(buf) - 1) // 4
    n = int(buf[0])
    cols = buf[1:].reshape(4, cap)[:, :n]
    return cols[0], cols[1], cols[2], cols[3]


def bitset_pair_materialize(bs, a_slots, b_slots, words: torch.Tensor,
                            block_ids: torch.Tensor, index: torch.Tensor):
    """Materializing dense-cohort intersection through :func:`materialize`.

    ``bs`` is a :class:`repro_torch.core.intersect.BlockedBitset`; slots
    index its cohort; ``words``, ``block_ids`` and ``index`` are its int32
    tables on the device the kernel runs on.  Returns ``(pair_id int64,
    values int32, rank_a int64, rank_b int64)``.

    Transfers: the block matching's one, and the closing fetch.  The
    output is sized by ``sum over matched blocks of min(|a|, |b|)``
    (the per-block popcounts ``bs.card``), so no total is read first.
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

    buf = materialize(words, block_ids, index, up(pos_a), up(pos_b),
                      up(pair_id), cap)
    pid, vals, ra, rb = unpack(common.host_get(buf))
    return (pid.astype(np.int64), vals.copy(), ra.astype(np.int64),
            rb.astype(np.int64))
