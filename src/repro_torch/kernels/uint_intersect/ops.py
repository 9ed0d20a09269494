"""Wrapper of the uint-intersect CUDA kernel (``csrc/uint_intersect.cu``);
counterpart of ``repro.kernels.uint_intersect.ops``.

``intersect_count_csr(offsets, neighbors, u, v)`` counts
``|N(u_i) ∩ N(v_i)|`` straight from a device-resident CSR: the kernel
gathers both rows itself, so there is no host gather or padding.  The
caller (``HybridSetStore._sparse_count``) routes only pairs whose larger
set has at most ``UINT_KERNEL_MAX_LEN`` elements here.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import common
from repro_torch.kernels.uint_intersect.ref import intersect_count_csr_ref

NAME = "uint_intersect"


def _lib():
    lib = common.library(NAME)
    fn = lib.uint_intersect_count
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def intersect_count_csr(offsets: torch.Tensor, neighbors: torch.Tensor,
                        u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """|N(u_i) ∩ N(v_i)| for int32 node pairs of an int32 CSR
    (``offsets [n+1]``, sorted ``neighbors [m]``).  Returns int32 [P]."""
    dev = offsets.device
    common.check_tensor(offsets, "offsets", torch.int32, dev)
    common.check_tensor(neighbors, "neighbors", torch.int32, dev)
    common.check_tensor(u, "u", torch.int32, dev)
    common.check_tensor(v, "v", torch.int32, dev)
    if u.shape != v.shape:
        raise ValueError(f"u {tuple(u.shape)} and v {tuple(v.shape)} differ")
    if not common.kernel_device(offsets, NAME):
        return intersect_count_csr_ref(offsets, neighbors, u, v)
    p = int(u.shape[0])
    out = torch.empty(p, dtype=torch.int32, device=dev)
    if p == 0:
        return out
    err = _lib()(offsets.data_ptr(), neighbors.data_ptr(), u.data_ptr(),
                 v.data_ptr(), p, out.data_ptr(), common.stream_ptr(dev))
    common.check_launch(err, NAME)
    return out
