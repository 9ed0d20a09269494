"""Wrapper of the dense triangle-count CUDA kernel
(``csrc/triangle_mm.cu``); counterpart of
``repro.kernels.triangle_mm.ops``.

``triangle_count_dense(a, symmetric=...)`` renders (a cohort of) an
adjacency into a padded 0/1 float32 matrix and counts triangles as
``sum((A @ A) * A)``.  For symmetric adjacencies the raw sum is 6x the
triangle count; for pruned DAGs (src > dst) it is exact.  The caller
states which via ``symmetric=``.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import common
from repro_torch.kernels.triangle_mm.ref import triangle_count_dense_ref

NAME = "triangle_mm"
_BLOCK = 256
# n must be a multiple of it on the card (half the pack pass's patch)
_TILE = 128


def _lib():
    lib = common.library(NAME)
    fn = lib.triangle_mm
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                       ctypes.c_int64, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def scratch_bytes(n: int) -> int:
    """Bytes of scratch the kernel takes for an ``[n, n]`` input: the bit
    planes of the rows and the columns of A (n^2 / 8 bytes each) and the
    two bitmaps of occupied 32 x 32 tiles (nt rows of ceil(nt / 32)
    words, nt = n / 32).  From n alone: nothing is read from the card."""
    nt = n // 32
    return n * n // 4 + 2 * nt * (-(-nt // 32)) * 4


def triangle_mm(a: torch.Tensor) -> torch.Tensor:
    """Exact ``sum((A @ A) * A)`` of a contiguous 0/1 float32 ``[n, n]``
    (n a multiple of 128 on the card) as a 0-d int64 tensor on ``a``'s
    device.  On the card: a pack pass to bit planes and tile bitmaps,
    then a count pass over the tile triples that hold work
    (``csrc/triangle_mm.cu``), with ``scratch_bytes(n)`` of scratch from
    the caching allocator and no host sync."""
    dev = a.device
    common.check_tensor(a, "a", torch.float32, dev, ndim=2)
    n = int(a.shape[0])
    if a.shape[1] != n:
        raise ValueError(f"a must be square, got {tuple(a.shape)}")
    if not common.kernel_device(a, NAME):
        return triangle_count_dense_ref(a).round().to(torch.int64)
    if n % _TILE:
        raise ValueError(f"n={n} is not a multiple of {_TILE}")
    if a.data_ptr() % 16:
        raise ValueError("a must be 16-byte aligned")
    # freed on return: the caching allocator hands it out again only to
    # work queued after this call on the same stream
    scratch = torch.empty(scratch_bytes(n), dtype=torch.uint8, device=dev)
    out = torch.empty((), dtype=torch.int64, device=dev)
    common.check_launch(_launch(a, scratch, out, PACK | COUNT), NAME)
    return out


PACK, COUNT = 1, 2


def run_passes(a: torch.Tensor, scratch: torch.Tensor, out: torch.Tensor,
               passes: int) -> None:
    """Launch ``triangle_mm``'s pack pass (``PACK``), its count pass over
    the bit planes a pack pass left in ``scratch`` (``COUNT``), or both,
    on the card, with ``a`` checked as ``triangle_mm`` checks it and no
    bump of ``LAUNCHES``: the passes timed apart.  ``scratch`` is a uint8
    tensor of at least ``scratch_bytes(n)``; ``out`` a 0-d int64 tensor
    that the count pass sets."""
    common.check_tensor(a, "a", torch.float32, a.device, ndim=2)
    n = int(a.shape[0])
    if (a.device.type != "cuda" or a.shape[1] != n or n % _TILE
            or a.data_ptr() % 16):
        raise ValueError("run_passes takes a square card tensor, n a "
                         f"multiple of {_TILE}, 16-byte aligned")
    common.check_tensor(scratch, "scratch", torch.uint8, a.device, ndim=1)
    common.check_tensor(out, "out", torch.int64, a.device, ndim=0)
    err = _launch(a, scratch, out, passes)
    if err:
        raise RuntimeError(f"{NAME}: CUDA launch failed with error {err}")


def _launch(a, scratch, out, passes: int) -> int:
    return _lib()(a.data_ptr(), int(a.shape[0]), scratch.data_ptr(),
                  scratch.numel(), out.data_ptr(), passes,
                  common.stream_ptr(a.device))


def triangle_count_dense(a, *, symmetric: bool, block: int = _BLOCK,
                         device=None) -> torch.Tensor:
    """Triangle count of a dense 0/1 adjacency matrix ``[n, n]``: a 0-d
    float32 tensor, ``raw / 6`` when ``symmetric`` else ``raw``.

    A tensor is counted on its own device; anything else (a numpy array)
    is uploaded to ``device``, the card unless the caller names another.
    The matrix is zero-padded to a multiple of ``block``."""
    if not isinstance(a, torch.Tensor):
        a = torch.as_tensor(np.asarray(a, dtype=np.float32),
                            device=common.default_device(
                                device, "triangle_count_dense"))
    a = a.to(torch.float32)
    n = int(a.shape[0])
    if block % _TILE:
        raise ValueError(f"block={block} is not a multiple of {_TILE}")
    npad = -(-max(n, block) // block) * block
    if npad != n:
        padded = torch.zeros((npad, npad), dtype=torch.float32,
                             device=a.device)
        padded[:n, :n] = a
        a = padded
    raw = triangle_mm(a.contiguous()).to(torch.float32)
    return raw / 6.0 if symmetric else raw


def densify_csr(offsets, neighbors, n: int) -> np.ndarray:
    """CSR -> dense 0/1 float32 (host-side; used for the dense cohort)."""
    out = np.zeros((n, n), dtype=np.float32)
    src = np.repeat(np.arange(n), np.diff(offsets))
    out[src, neighbors] = 1.0
    return out
