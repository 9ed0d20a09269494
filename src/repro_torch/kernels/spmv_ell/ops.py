"""Wrapper of the ELL SpMV CUDA kernel (``csrc/spmv_ell.cu``) and the CSR
to ELL packings; counterpart of ``repro.kernels.spmv_ell.ops``.

``csr_to_ell`` is the reference's packing (width = the largest degree),
kept so the two packages can be compared.  On a power-law graph that
width is the hub's degree for every row (45,468 slots on
``powerlaw_graph(200_000, 20, 2.2)``, about 73 GB), so the port's own
packing, ``csr_to_ell_split``, is fixed-width: a vertex of degree d takes
``ceil(d / width)`` consecutive ELL rows, ``row_ptr[i]:row_ptr[i+1]``.

``spmv_ell(cols, vals, row_ptr, x)`` returns ``y [n]`` with
``y[i] = sum over r in row_ptr[i]:row_ptr[i+1] of
sum_k vals[r,k] * x[cols[r,k]]``; ``row_ptr = arange(n + 1)`` reads the
reference's one-row-per-vertex packing.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import common
from repro_torch.kernels.spmv_ell.ref import spmv_ell_ref

NAME = "spmv_ell"
ELL_WIDTH = 32   # one warp lane per slot


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


def csr_to_ell_split(offsets, neighbors, values=None,
                     width: int = ELL_WIDTH):
    """Fixed-width ELL packing with long rows split: returns ``(cols
    [R,width] int32, vals [R,width] f32, row_ptr [n+1] int32)``.  Vertex
    i's slots fill ELL rows ``row_ptr[i]:row_ptr[i+1]`` in CSR order, the
    last row padded with column 0 / weight 0; an isolated vertex takes no
    row."""
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
    fn = common.library(NAME).spmv_ell
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [p, p, p, p, ctypes.c_int64, ctypes.c_int32,
                       ctypes.c_int64, p, p, p]
        fn.restype = ctypes.c_int
    return fn


def spmv_ell(cols: torch.Tensor, vals: torch.Tensor, row_ptr: torch.Tensor,
             x: torch.Tensor) -> torch.Tensor:
    """``y [n]`` float32 from int32 ``cols [R,K]`` (each in ``[0, |x|)``),
    float32 ``vals [R,K]``, int32 ``row_ptr [n+1]`` (non-decreasing, from
    0 to R) and float32 ``x``; see the module docstring."""
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
    rows, width = int(cols.shape[0]), int(cols.shape[1])
    n = int(row_ptr.shape[0]) - 1
    partial = torch.empty(rows, dtype=torch.float32, device=dev)
    y = torch.empty(n, dtype=torch.float32, device=dev)
    err = _lib()(cols.data_ptr(), vals.data_ptr(), row_ptr.data_ptr(),
                 x.data_ptr(), rows, width, n, partial.data_ptr(),
                 y.data_ptr(), common.stream_ptr(dev))
    common.check_launch(err, NAME)
    return y
