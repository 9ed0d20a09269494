"""Wrapper of the ELL SpMV CUDA kernel (``csrc/spmv_ell.cu``) and the CSR
to ELL packings; counterpart of ``repro.kernels.spmv_ell.ops``.

``spmv_ell(cols, vals, row_ptr, x)`` reads a packing as one flat run of
slots: ``y[i] = sum of vals.flat[s] * x[cols.flat[s]]`` for ``s`` in
``[row_ptr[i] * W, row_ptr[i+1] * W)``.  Three packings feed it:

* ``csr_to_ell``, the reference's (one row per vertex, width = the
  largest degree), kept so the two packages can be compared; on a
  power-law graph that width is the hub's degree for every row (45,468
  slots on ``powerlaw_graph(200_000, 20, 2.2)``, about 73 GB);
* ``csr_to_ell_split`` at a fixed width: a vertex of degree d takes
  ``ceil(d / width)`` consecutive rows, ``row_ptr[i]:row_ptr[i+1]``;
* ``csr_to_ell_split(..., width=1)``, the CSR itself (``cols`` the
  neighbours, ``row_ptr`` the offsets), with no padding slot:
  ``recursion.pagerank`` packs so.

The kernel balances the work over the merge of row ends and slots
(merge-path), reading each slot once, whatever the packing.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import common
from repro_torch.kernels.spmv_ell.ref import spmv_ell_ref

NAME = "spmv_ell"


def csr_to_ell(offsets, neighbors, values=None, k: int | None = None):
    """The reference's packing (cols [n,K] int32, vals [n,K] f32), padding
    with column 0 / weight 0: the split packing at width K, one row per
    vertex.  K defaults to the largest degree; a row longer than K raises
    (``csr_to_ell_split`` splits it instead)."""
    deg = np.diff(np.asarray(offsets))
    n = len(deg)
    top = int(deg.max()) if n else 0
    if k is None:
        k = top if n else 1
    if top > k:
        raise ValueError(f"a row of {top} exceeds ELL width {k}")
    cols = np.zeros((n, k), dtype=np.int32)
    vals = np.zeros((n, k), dtype=np.float32)
    if top:
        cols[deg > 0], vals[deg > 0], _ = csr_to_ell_split(
            offsets, neighbors, values, width=k)
    return cols, vals


def csr_to_ell_split(offsets, neighbors, values=None, *, width: int):
    """Fixed-width ELL packing with long rows split: returns ``(cols
    [R,width] int32, vals [R,width] f32, row_ptr [n+1] int32)``.  Vertex
    i's slots fill ELL rows ``row_ptr[i]:row_ptr[i+1]`` in CSR order, the
    last row padded with column 0 / weight 0; an isolated vertex takes no
    row.  At width 1 that is the CSR cast and reshaped, the same arrays
    ``_scatter_split`` makes, without its scatter of every entry
    (``chip_smoke.py`` times both on its 37M-entry graph); weights
    default to 1.0."""
    if width != 1:
        return _scatter_split(offsets, neighbors, values, width)
    offsets = np.asarray(offsets, dtype=np.int64)
    m = len(neighbors)
    if m > np.iinfo(np.int32).max:
        raise ValueError(f"{m} ELL rows exceed int32 slots")
    vals = (np.ones(m, dtype=np.float32) if values is None
            else np.asarray(values, dtype=np.float32))
    return (np.asarray(neighbors).astype(np.int32, copy=False).reshape(m, 1),
            vals.reshape(m, 1), offsets.astype(np.int32))


def _scatter_split(offsets, neighbors, values, width: int):
    """``csr_to_ell_split`` at any width, by scattering each entry into
    its slot."""
    offsets = np.asarray(offsets, dtype=np.int64)
    neighbors = np.asarray(neighbors)
    n = len(offsets) - 1
    deg = np.diff(offsets)
    row_ptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum((deg + width - 1) // width, out=row_ptr[1:])
    if row_ptr[-1] * width > np.iinfo(np.int32).max:
        raise ValueError(f"{int(row_ptr[-1])} ELL rows exceed int32 slots")
    rows = int(row_ptr[-1])
    cols = np.zeros(rows * width, dtype=np.int32)
    vals = np.zeros(rows * width, dtype=np.float32)
    # slot of edge e of vertex u: row_ptr[u] * width + (e - offsets[u])
    shift = np.repeat(row_ptr[:-1] * width - offsets[:-1], deg)
    flat = np.arange(len(neighbors), dtype=np.int64) + shift
    cols[flat] = neighbors
    vals[flat] = 1.0 if values is None else np.asarray(values, np.float32)
    return (cols.reshape(rows, width), vals.reshape(rows, width),
            row_ptr.astype(np.int32))


def _lib():
    lib = common.library(NAME)
    fn = lib.spmv_ell
    if fn.argtypes is None:
        p, i64 = ctypes.c_void_p, ctypes.c_int64
        fn.argtypes = [p, p, p, p, i64, i64, i64, p, p, p, p]
        fn.restype = ctypes.c_int
        lib.spmv_ell_tile_items.argtypes = []
        lib.spmv_ell_tile_items.restype = i64
    return lib


def tile_items() -> int:
    """Merge items (row ends and slots) one block of the kernel takes."""
    return int(_lib().spmv_ell_tile_items())


def spmv_ell(cols: torch.Tensor, vals: torch.Tensor, row_ptr: torch.Tensor,
             x: torch.Tensor) -> torch.Tensor:
    """``y [n]`` float32 from int32 ``cols [R,K]`` (each in ``[0, |x|)``),
    float32 ``vals [R,K]``, int32 ``row_ptr [n+1]`` (non-decreasing, from
    0 to R) and float32 ``x``; see the module docstring.  With no row
    (``n = 0``) or no slot (``R * K = 0``) it launches nothing and returns
    zeros."""
    dev = x.device
    common.check_tensor(cols, "cols", torch.int32, dev, ndim=2)
    common.check_tensor(vals, "vals", torch.float32, dev, ndim=2)
    common.check_tensor(row_ptr, "row_ptr", torch.int32, dev)
    common.check_tensor(x, "x", torch.float32, dev)
    if cols.shape != vals.shape:
        raise ValueError(f"cols {tuple(cols.shape)} and vals "
                         f"{tuple(vals.shape)} differ")
    if row_ptr.shape[0] < 1:
        raise ValueError("row_ptr needs at least one entry")
    if not common.kernel_device(x, NAME):
        return spmv_ell_ref(cols, vals, row_ptr, x)
    n, slots = int(row_ptr.shape[0]) - 1, cols.numel()
    if n == 0 or slots == 0:
        return torch.zeros(n, dtype=torch.float32, device=dev)
    blocks = -(-(n + slots) // tile_items())
    carry_row = torch.empty(blocks, dtype=torch.int64, device=dev)
    carry_val = torch.empty(blocks, dtype=torch.float32, device=dev)
    y = torch.empty(n, dtype=torch.float32, device=dev)
    err = _lib().spmv_ell(
        cols.data_ptr(), vals.data_ptr(), row_ptr.data_ptr(), x.data_ptr(),
        n, slots, int(cols.shape[1]), carry_row.data_ptr(),
        carry_val.data_ptr(), y.data_ptr(), common.stream_ptr(dev))
    common.check_launch(err, NAME)
    return y
