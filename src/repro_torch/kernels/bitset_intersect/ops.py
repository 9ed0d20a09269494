"""Wrapper of the bitset AND+popcount CUDA kernel
(``csrc/bitset_intersect.cu``); counterpart of
``repro.kernels.bitset_intersect.ops``.

``bitset_and_popcount(words, pos_a, pos_b)`` is the ``word_kernel`` the
device backend injects into :class:`repro_torch.core.layouts.HybridSetStore`.
The kernel gathers the matched block rows from the block table itself.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import common
from repro_torch.kernels.bitset_intersect.ref import bitset_and_popcount_ref

NAME = "bitset_intersect"


def _lib():
    lib = common.library(NAME)
    fn = lib.bitset_and_popcount
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int32, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                       ctypes.c_void_p]
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
    err = _lib()(words.data_ptr(), int(words.shape[1]), pos_a.data_ptr(),
                 pos_b.data_ptr(), p, out.data_ptr(), common.stream_ptr(dev))
    common.check_launch(err, NAME)
    return out
