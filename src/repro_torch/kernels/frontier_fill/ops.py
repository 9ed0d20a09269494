"""Wrappers of the frontier-fill and frontier-fold CUDA kernels
(``csrc/frontier_fill.cu``); counterpart of
``repro.kernels.frontier_fill.ops``.

``fill(total_c, offs, lo0, seed, probes, start, n)`` runs the fill stage
of one count-then-fill extension (or of a terminal fold's expansion) over
the output slots ``[start, start + n)`` in ONE launch.  ``total_c`` stays
on the device: the kernel reads it there and masks the slots at or past
it, so the caller launches over a static slot count and never reads the
frontier size on the host.

Returns ``(vals, row, p0, keep, poss)``: int32 candidate values, source
rows and absolute seed positions, the bool keep mask (liveness AND every
probe's membership), and each probe atom's int32 absolute positions.

``fold(lo0, cnt, seed, probes, leaf_anns, sr)`` is the device terminal
fold: every row's ``cnt`` candidates from ``lo0`` are probed the same way
and their semiring contributions reduced onto the row in ONE launch (a
warp per row), with no output slots and so no size to know.
"""
from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from repro_torch.kernels import common
from repro_torch.kernels.frontier_fill.ref import fill_ref, fold_ref

NAME = "frontier_fill"
FOLD_NAME = "frontier_fold"
MAX_PROBES = 8   # FF_MAX_PROBES in the CUDA source
# semiring name -> (kernel entry suffix, ctypes scalar, op code)
_FOLD_OPS = {"count": ("i32", ctypes.c_int32, 0),
             "sum_f32": ("f32", ctypes.c_float, 0),
             "sum_f64": ("f32", ctypes.c_float, 0),
             "min_plus": ("f32", ctypes.c_float, 1),
             "max_min": ("f32", ctypes.c_float, 2),
             "boolean": ("u8", ctypes.c_uint8, 3)}


class _Probe(ctypes.Structure):
    _fields_ = [("vals", ctypes.c_void_p), ("lo", ctypes.c_void_p),
                ("hi", ctypes.c_void_p), ("n", ctypes.c_int32)]


class _Probes(ctypes.Structure):
    _fields_ = [("p", _Probe * MAX_PROBES), ("count", ctypes.c_int32)]


class _FoldAnns(ctypes.Structure):
    _fields_ = [("p", ctypes.c_void_p * (MAX_PROBES + 1)),
                ("n", ctypes.c_int32 * (MAX_PROBES + 1))]


def _probes_desc(probes) -> _Probes:
    desc = _Probes()
    desc.count = len(probes)
    for k, (vk, lo_k, hi_k) in enumerate(probes):
        desc.p[k] = _Probe(vk.data_ptr(), lo_k.data_ptr(), hi_k.data_ptr(),
                           int(vk.shape[0]))
    return desc


def _check_probes(probes, cap_in: int, dev) -> None:
    if len(probes) > MAX_PROBES:
        raise ValueError(f"at most {MAX_PROBES} probe atoms, got "
                         f"{len(probes)}")
    for k, (vk, lo_k, hi_k) in enumerate(probes):
        common.check_tensor(vk, f"probe{k}.values", torch.int32, dev)
        common.check_tensor(lo_k, f"probe{k}.lo", torch.int32, dev)
        common.check_tensor(hi_k, f"probe{k}.hi", torch.int32, dev)
        if lo_k.shape[0] != cap_in or hi_k.shape[0] != cap_in:
            raise ValueError(f"probe{k} bounds must have length {cap_in}")


def _lib():
    lib = common.library(NAME)
    fn = lib.frontier_fill
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [p, p, p, ctypes.c_int32, p, ctypes.c_int32,
                       ctypes.POINTER(_Probes), ctypes.c_int64,
                       ctypes.c_int64, p, p, p, p, p, p]
        fn.restype = ctypes.c_int
    return fn


def fill(total_c: torch.Tensor, offs: torch.Tensor, lo0: torch.Tensor,
         seed: torch.Tensor, probes: Sequence[Tuple], start: int, n: int):
    """Fill output slots ``[start, start + n)``; see the module docstring.

    total_c : int32 scalar (0-d) — live slots, read on the device
    offs, lo0 : int32 [cap_in] — exclusive-scan offsets, seed segment starts
    seed : int32 [n0] — the seed atom's level values
    probes : ``(values_k [nk], lo_k [cap_in], hi_k [cap_in])`` int32 each
    """
    dev = offs.device
    cap_in = int(offs.shape[0])
    common.check_tensor(total_c, "total_c", torch.int32, dev, ndim=0)
    common.check_tensor(offs, "offs", torch.int32, dev)
    common.check_tensor(lo0, "lo0", torch.int32, dev)
    common.check_tensor(seed, "seed", torch.int32, dev)
    if cap_in < 1 or lo0.shape[0] != cap_in:
        raise ValueError(f"offs/lo0 must share a length >= 1, got "
                         f"{cap_in} and {lo0.shape[0]}")
    _check_probes(probes, cap_in, dev)
    if not common.kernel_device(offs, NAME):
        return fill_ref(total_c, offs, lo0, seed, probes, start, n)

    vals = torch.empty(n, dtype=torch.int32, device=dev)
    row = torch.empty(n, dtype=torch.int32, device=dev)
    p0 = torch.empty(n, dtype=torch.int32, device=dev)
    keep = torch.empty(n, dtype=torch.bool, device=dev)
    pos = torch.empty((len(probes), n), dtype=torch.int32, device=dev)
    if n == 0:
        return vals, row, p0, keep, tuple(pos)
    desc = _probes_desc(probes)
    err = _lib()(total_c.data_ptr(), offs.data_ptr(), lo0.data_ptr(), cap_in,
                 seed.data_ptr(), int(seed.shape[0]), ctypes.byref(desc),
                 int(start), int(n), vals.data_ptr(), row.data_ptr(),
                 p0.data_ptr(), keep.data_ptr(), pos.data_ptr(),
                 common.stream_ptr(dev))
    common.check_launch(err, NAME)
    return vals, row, p0, keep, tuple(pos)


def _fold_lib(suffix: str, scalar):
    fn = getattr(common.library(NAME), f"frontier_fold_{suffix}")
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [p, p, ctypes.c_int32, p, ctypes.c_int32,
                       ctypes.POINTER(_Probes), ctypes.POINTER(_FoldAnns),
                       ctypes.c_int32, scalar, scalar, p, p, p]
        fn.restype = ctypes.c_int
    return fn


def fold(lo0: torch.Tensor, cnt: torch.Tensor, seed: torch.Tensor,
         probes: Sequence[Tuple], leaf_anns: Sequence, sr):
    """Terminal fold of every row's candidates; see the module docstring.

    lo0, cnt : int32 [cap_in] — each row's (clipped) seed segment start
        and candidate count (0 for dead rows)
    seed : int32 [n0]; probes as for :func:`fill`
    leaf_anns : one entry per constraining atom (seed first): None or the
        atom's leaf annotation vector in ``sr.dtype``
    sr : the semiring (name, dtype, zero, one, add, mul, segment_reduce)
    Returns ``(folded [cap_in] sr.dtype, support [cap_in] int32)``.
    """
    dev = lo0.device
    cap_in = int(lo0.shape[0])
    common.check_tensor(lo0, "lo0", torch.int32, dev)
    common.check_tensor(cnt, "cnt", torch.int32, dev)
    common.check_tensor(seed, "seed", torch.int32, dev)
    if cap_in < 1 or cnt.shape[0] != cap_in:
        raise ValueError(f"lo0/cnt must share a length >= 1, got "
                         f"{cap_in} and {cnt.shape[0]}")
    _check_probes(probes, cap_in, dev)
    if len(leaf_anns) != len(probes) + 1:
        raise ValueError("one leaf-annotation entry per constraining atom")
    for k, la in enumerate(leaf_anns):
        if la is not None:
            common.check_tensor(la, f"leaf_ann{k}", sr.dtype, dev)
    if sr.name not in _FOLD_OPS:
        raise ValueError(f"no fold kernel for semiring {sr.name!r}")
    if not common.kernel_device(lo0, FOLD_NAME):
        return fold_ref(lo0, cnt, seed, probes, leaf_anns, sr)

    suffix, scalar, op = _FOLD_OPS[sr.name]
    folded = torch.empty(cap_in, dtype=sr.dtype, device=dev)
    supp = torch.empty(cap_in, dtype=torch.int32, device=dev)
    anns = _FoldAnns()
    for k, la in enumerate(leaf_anns):
        if la is not None:
            anns.p[k] = la.data_ptr()
            anns.n[k] = int(la.shape[0])
    err = _fold_lib(suffix, scalar)(
        lo0.data_ptr(), cnt.data_ptr(), cap_in, seed.data_ptr(),
        int(seed.shape[0]), ctypes.byref(_probes_desc(probes)),
        ctypes.byref(anns), op, scalar(sr.zero), scalar(sr.one),
        folded.data_ptr(), supp.data_ptr(), common.stream_ptr(dev))
    common.check_launch(err, FOLD_NAME)
    return folded, supp
