"""Wrappers of the bitset-intersect CUDA kernels
(``csrc/bitset_intersect.cu``); counterpart of
``repro.kernels.bitset_intersect.ops``.

``bitset_pair_count(offsets, block_ids, words, a_slots, b_slots)`` is the
set-pair kernel the device backend injects into
:class:`repro_torch.core.layouts.HybridSetStore`: one launch matches the
block-id lists of every slot pair and ANDs and popcounts the matched
rows, the reference's ``bitset_pair_count`` in one kernel.
``bitset_and_popcount(words, pos_a, pos_b)`` is the TPU kernel's own
contract over already matched block pairs; the kernel gathers the rows
from the block table itself.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import common
from repro_torch.kernels.bitset_intersect.ref import (bitset_and_popcount_ref,
                                                      bitset_pair_count_ref)

NAME = "bitset_intersect"


_PTR, _I32, _I64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
# each C entry point's arguments; the last two are the output and the stream
_ARGTYPES = {
    "bitset_and_popcount": [_PTR, _I32, _PTR, _PTR, _I64, _PTR, _PTR],
    "bitset_pair_count": [_PTR, _PTR, _PTR, _I32, _PTR, _PTR, _I64, _PTR,
                          _PTR],
}


def _fn(attr: str):
    fn = getattr(common.library(NAME), attr)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[attr]
        fn.restype = ctypes.c_int
    return fn


def bitset_and_popcount(words: torch.Tensor, pos_a: torch.Tensor,
                        pos_b: torch.Tensor) -> torch.Tensor:
    """out[i] = |block[pos_a[i]] & block[pos_b[i]]| (popcount of the AND).

    words : [B, W] int32 view of the uint32 bitvector blocks
    pos_a, pos_b : [P] int32 rows of ``words``
    Returns int32 [P] on ``words``' device.
    """
    dev = words.device
    common.check_tensor(words, "words", torch.int32, dev, ndim=2)
    common.check_tensor(pos_a, "pos_a", torch.int32, dev)
    common.check_tensor(pos_b, "pos_b", torch.int32, dev)
    if pos_a.shape != pos_b.shape:
        raise ValueError(f"pos_a {tuple(pos_a.shape)} and pos_b "
                         f"{tuple(pos_b.shape)} differ")
    if not common.kernel_device(words, NAME):
        return bitset_and_popcount_ref(words, pos_a, pos_b)
    p = int(pos_a.shape[0])
    out = torch.empty(p, dtype=torch.int32, device=dev)
    if p == 0:
        return out
    err = _fn("bitset_and_popcount")(
        words.data_ptr(), int(words.shape[1]), pos_a.data_ptr(),
        pos_b.data_ptr(), p, out.data_ptr(), common.stream_ptr(dev))
    common.check_launch(err, NAME)
    return out


def bitset_pair_count(offsets: torch.Tensor, block_ids: torch.Tensor,
                      words: torch.Tensor, a_slots: torch.Tensor,
                      b_slots: torch.Tensor) -> torch.Tensor:
    """out[i] = |S_a ∩ S_b| for the slot pairs ``(a_slots[i],
    b_slots[i])`` of one blocked bitset: the sum, over the block ids both
    sets hold, of the popcount of the AND of their two block rows.

    On the card a warp stages one set of its pairs (``b``, or the set it
    staged for its previous pair) as a bitmap in shared memory, in slices
    of the kernel's staging range when its block ids span more, and looks
    the other set's ids up in it.

    offsets : [S+1] int32 block CSR of the sets
    block_ids : [B] int32 block numbers, sorted within each set
    words : [B, W] int32 view of the uint32 bitvector blocks
    a_slots, b_slots : [P] int32 slots
    Returns int32 [P] on ``words``' device.
    """
    dev = words.device
    common.check_tensor(offsets, "offsets", torch.int32, dev)
    common.check_tensor(block_ids, "block_ids", torch.int32, dev)
    common.check_tensor(words, "words", torch.int32, dev, ndim=2)
    common.check_tensor(a_slots, "a_slots", torch.int32, dev)
    common.check_tensor(b_slots, "b_slots", torch.int32, dev)
    if a_slots.shape != b_slots.shape:
        raise ValueError(f"a_slots {tuple(a_slots.shape)} and b_slots "
                         f"{tuple(b_slots.shape)} differ")
    if block_ids.shape[0] != words.shape[0]:
        raise ValueError(f"{int(block_ids.shape[0])} block ids for "
                         f"{int(words.shape[0])} blocks")
    if int(words.shape[0]) > common.COUNT_LIMIT:
        raise ValueError(f"{int(words.shape[0])} blocks: the block CSR "
                         "does not fit in int32")
    if not common.kernel_device(words, NAME):
        return bitset_pair_count_ref(offsets, block_ids, words, a_slots,
                                     b_slots)
    p = int(a_slots.shape[0])
    out = torch.empty(p, dtype=torch.int32, device=dev)
    if p == 0:
        return out
    err = _fn("bitset_pair_count")(
        offsets.data_ptr(), block_ids.data_ptr(), words.data_ptr(),
        int(words.shape[1]), a_slots.data_ptr(), b_slots.data_ptr(), p,
        out.data_ptr(), common.stream_ptr(dev))
    common.check_launch(err, NAME)
    return out
