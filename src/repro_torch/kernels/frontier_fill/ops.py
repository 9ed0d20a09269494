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

``fold(lo0, offs, total, seed, probes, leaf_anns, sr)`` is the device
terminal fold: the ``total`` candidates, row ``r``'s from ``lo0[r]`` on
and numbered from ``offs[r]``, are probed the same way and their semiring
contributions reduced onto their rows: a merge-path kernel over the row
ends and the candidates and a small fix-up for the rows that cross its
blocks, counted as one launch.  ``total`` stays on the device and the
grid and scratch come from the card, so the call reads nothing on the
host.

``fill_batched`` and ``fold_batched`` are their batched forms, for the
batched bag program of prepared queries re-bound B times: the levels
(seed, probe values, leaf annotations) are shared, every per-query input
carries a leading ``B`` (``[B, cap_in]`` per-row arrays, ``[B]`` totals),
and each launches once for the whole batch.  Each equals its plain
version stacked over the batch.  ``fill`` and ``fold`` hand rows with a
leading ``B`` to them, so a caller passes one query or a batch alike.
"""
from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from repro_torch.kernels import common
from repro_torch.kernels.frontier_fill.ref import (fill_batched_ref, fill_ref,
                                                   fold_batched_ref, fold_ref)

NAME = "frontier_fill"
FOLD_NAME = "frontier_fold"
BATCHED_NAME = "frontier_fill_batched"
FOLD_BATCHED_NAME = "frontier_fold_batched"
MAX_PROBES = 8   # FF_MAX_PROBES in the CUDA source
# Bytes a query of the batched fold may stage its probe segments in: a
# bitmap over each segment's value range (32 values a word, and a running
# count a word where the probe is annotated), read through L1.  A segment
# whose range needs more keeps the search in device memory.  A batch
# stages _STAGE_TOTAL bytes at most, so a large batch's queries get fewer
# each.
_STAGE_BYTES = 64 << 10
_STAGE_TOTAL = 64 << 20
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


def _check_probes(probes, shape: Tuple[int, ...], dev) -> None:
    """The probes' values and their ``shape`` bounds (``[cap_in]``, or
    ``[B, cap_in]`` for a batch)."""
    if len(probes) > MAX_PROBES:
        raise ValueError(f"at most {MAX_PROBES} probe atoms, got "
                         f"{len(probes)}")
    for k, (vk, lo_k, hi_k) in enumerate(probes):
        common.check_tensor(vk, f"probe{k}.values", torch.int32, dev)
        common.check_tensor(lo_k, f"probe{k}.lo", torch.int32, dev,
                            ndim=len(shape))
        common.check_tensor(hi_k, f"probe{k}.hi", torch.int32, dev,
                            ndim=len(shape))
        if tuple(lo_k.shape) != shape or tuple(hi_k.shape) != shape:
            raise ValueError(f"probe{k} bounds must have shape {shape}")


def _check_rows(offs, lo0, total, dev, names) -> Tuple[int, ...]:
    """Check the per-row arrays ``offs``/``lo0`` (``[cap_in]`` with a 0-d
    ``total``, or ``[B, cap_in]`` with a ``[B]`` one) and return their
    shape."""
    nd = offs.dim()
    common.check_tensor(total, names[0], torch.int32, dev, ndim=nd - 1)
    common.check_tensor(offs, names[1], torch.int32, dev, ndim=nd)
    common.check_tensor(lo0, names[2], torch.int32, dev, ndim=nd)
    shape = tuple(offs.shape)
    if min(shape) < 1 or tuple(lo0.shape) != shape \
            or tuple(total.shape) != shape[:-1]:
        raise ValueError(f"{names[1]}/{names[2]} must share a shape of "
                         f"sizes >= 1 and {names[0]} its leading one, got "
                         f"{shape}, {tuple(lo0.shape)} and "
                         f"{tuple(total.shape)}")
    return shape


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
    if offs.dim() == 2:
        if start:
            raise ValueError("a batch fills each query's slots from 0")
        return fill_batched(total_c, offs, lo0, seed, probes, n)
    dev = offs.device
    shape = _check_rows(offs, lo0, total_c, dev, ("total_c", "offs", "lo0"))
    common.check_tensor(seed, "seed", torch.int32, dev)
    _check_probes(probes, shape, dev)
    if not common.kernel_device(offs, NAME):
        return fill_ref(total_c, offs, lo0, seed, probes, start, n)

    outs = _outputs(len(probes), n, dev)
    if n == 0:
        return outs[:4] + (tuple(outs[4]),)
    common.check_launch(_launch(total_c, offs, lo0, seed, probes, start, n,
                                outs), NAME)
    return outs[:4] + (tuple(outs[4]),)


def _outputs(n_probes: int, n: int, dev, batch: Tuple[int, ...] = ()):
    """``fill``'s output buffers: ``(vals, row, p0, keep, pos)``, each
    ``[*batch, n]``, with ``pos`` one ``[n_probes, *batch, n]`` tensor."""
    def i32(*shape):
        return torch.empty(shape, dtype=torch.int32, device=dev)
    return (i32(*batch, n), i32(*batch, n), i32(*batch, n),
            torch.empty(*batch, n, dtype=torch.bool, device=dev),
            i32(n_probes, *batch, n))


def _launch(total_c, offs, lo0, seed, probes, start: int, n: int,
            outs) -> int:
    """Launch the fill kernel into ``outs`` (:func:`_outputs`) on the
    card, unchecked and uncounted; returns the launch error (0 if none).
    :func:`fill` checks the arguments, allocates and counts around it."""
    vals, row, p0, keep, pos = outs
    return _lib()(total_c.data_ptr(), offs.data_ptr(), lo0.data_ptr(),
                  int(offs.shape[0]), seed.data_ptr(), int(seed.shape[0]),
                  ctypes.byref(_probes_desc(probes)), int(start), int(n),
                  vals.data_ptr(), row.data_ptr(), p0.data_ptr(),
                  keep.data_ptr(), pos.data_ptr(),
                  common.stream_ptr(offs.device))


def _fold_lib(suffix: str, scalar):
    lib = common.library(NAME)
    fn = getattr(lib, f"frontier_fold_{suffix}")
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [p, p, p, p, ctypes.c_int64, ctypes.c_int32, p,
                       ctypes.c_int32, ctypes.POINTER(_Probes),
                       ctypes.POINTER(_FoldAnns), ctypes.c_int32, scalar,
                       scalar, p, p, p, ctypes.c_int32, p]
        fn.restype = ctypes.c_int
        lib.frontier_fold_scratch_bytes.restype = ctypes.c_int64
        lib.frontier_fold_batched_scratch_bytes.argtypes = [
            ctypes.c_int64, ctypes.c_int32, ctypes.c_int32]
        lib.frontier_fold_batched_scratch_bytes.restype = ctypes.c_int64
        lib.frontier_fold_batched_scan_max.restype = ctypes.c_int64
    return fn, lib


def fold(lo0: torch.Tensor, offs: torch.Tensor, total: torch.Tensor,
         seed: torch.Tensor, probes: Sequence[Tuple], leaf_anns: Sequence,
         sr):
    """Terminal fold of every row's candidates; see the module docstring.

    lo0, offs : int32 [cap_in] — each row's (clipped) seed segment start
        and the exclusive scan of the rows' candidate counts (0 for dead
        rows), so row ``r`` holds ``offs[r + 1] - offs[r]`` candidates
        (the last row ``total - offs[-1]``)
    total : int32 scalar (0-d) — the candidate count, read on the device
    seed : int32 [n0]; probes as for :func:`fill`
    leaf_anns : one entry per constraining atom (seed first): None or the
        atom's leaf annotation vector in ``sr.dtype``
    sr : the semiring (name, dtype, zero, one, add, mul, segment_reduce)
    Returns ``(folded [cap_in] sr.dtype, support [cap_in] int32)``.
    """
    if offs.dim() == 2:
        return fold_batched(lo0, offs, total, seed, probes, leaf_anns, sr)
    dev = lo0.device
    _check_fold(lo0, offs, total, seed, probes, leaf_anns, sr)
    if not common.kernel_device(lo0, FOLD_NAME):
        return fold_ref(lo0, offs, total, seed, probes, leaf_anns, sr)
    return _launch_fold(lo0, offs, total, None, seed, probes, leaf_anns, sr,
                        FOLD_NAME)


def _check_fold(lo0, offs, total, seed, probes, leaf_anns, sr) -> None:
    dev = lo0.device
    shape = _check_rows(offs, lo0, total, dev, ("total", "offs", "lo0"))
    common.check_tensor(seed, "seed", torch.int32, dev)
    _check_probes(probes, shape, dev)
    if len(leaf_anns) != len(probes) + 1:
        raise ValueError("one leaf-annotation entry per constraining atom")
    for k, la in enumerate(leaf_anns):
        if la is not None:
            common.check_tensor(la, f"leaf_ann{k}", sr.dtype, dev)
    if sr.name not in _FOLD_OPS:
        raise ValueError(f"no fold kernel for semiring {sr.name!r}")


def _launch_fold(lo0, offs, total, base, seed, probes, leaf_anns, sr,
                 name: str, stage_bytes: int = 0):
    """Launch the fold on the card over ``lo0``'s rows (one query's, or a
    batch's with its ``base`` for the scan of the totals and
    ``stage_bytes`` a query for its staged probe segments) and count it."""
    dev = lo0.device
    suffix, scalar, op = _FOLD_OPS[sr.name]
    fn, lib = _fold_lib(suffix, scalar)
    folded = torch.empty(lo0.shape, dtype=sr.dtype, device=dev)
    supp = torch.empty(lo0.shape, dtype=torch.int32, device=dev)
    nbytes = (lib.frontier_fold_scratch_bytes() if base is None else
              lib.frontier_fold_batched_scratch_bytes(
                  int(lo0.shape[0]), len(probes), stage_bytes))
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    if base is not None and int(lo0.shape[0]) > \
            lib.frontier_fold_batched_scan_max():
        # the kernel scans the totals of a batch of up to so many queries
        # (one block's work); a larger batch's are scanned here
        base[:1].zero_()
        torch.cumsum(total, 0, out=base[1:])
    anns = _FoldAnns()
    for k, la in enumerate(leaf_anns):
        if la is not None:
            anns.p[k] = la.data_ptr()
            anns.n[k] = int(la.shape[0])
    batch = int(lo0.shape[0]) if base is not None else 1
    err = fn(lo0.data_ptr(), offs.data_ptr(), total.data_ptr(),
             None if base is None else base.data_ptr(), batch,
             int(lo0.shape[-1]), seed.data_ptr(), int(seed.shape[0]),
             ctypes.byref(_probes_desc(probes)), ctypes.byref(anns), op,
             scalar(sr.zero), scalar(sr.one), folded.data_ptr(),
             supp.data_ptr(), scratch.data_ptr(), int(stage_bytes),
             common.stream_ptr(dev))
    common.check_launch(err, name)
    return folded, supp


def fill_batched(total_c: torch.Tensor, offs: torch.Tensor,
                 lo0: torch.Tensor, seed: torch.Tensor,
                 probes: Sequence[Tuple], n: int):
    """``fill`` of B queries over the same levels, in ONE launch: query
    ``b``'s output slots ``[0, n)`` from its ``total_c[b]``,
    ``offs[b]``, ``lo0[b]`` and probe bounds ``lo_k[b]``, ``hi_k[b]``
    (``[B, cap_in]`` each; the probes' values and ``seed`` shared).
    Returns ``(vals, row, p0, keep, poss)``, each ``[B, n]``."""
    dev = offs.device
    if offs.dim() != 2:
        raise ValueError("fill_batched takes [B, cap_in] rows")
    shape = _check_rows(offs, lo0, total_c, dev, ("total_c", "offs", "lo0"))
    common.check_tensor(seed, "seed", torch.int32, dev)
    _check_probes(probes, shape, dev)
    if not common.kernel_device(offs, BATCHED_NAME):
        return fill_batched_ref(total_c, offs, lo0, seed, probes, n)

    batch, cap_in = shape
    outs = _outputs(len(probes), n, dev, (batch,))
    if n > 0:
        fn = _lib_batched()
        vals, row, p0, keep, pos = outs
        common.check_launch(fn(
            total_c.data_ptr(), offs.data_ptr(), lo0.data_ptr(), cap_in,
            seed.data_ptr(), int(seed.shape[0]),
            ctypes.byref(_probes_desc(probes)), batch, int(n),
            vals.data_ptr(), row.data_ptr(), p0.data_ptr(), keep.data_ptr(),
            pos.data_ptr(), common.stream_ptr(dev)), BATCHED_NAME)
    return outs[:4] + (tuple(outs[4]),)


def _lib_batched():
    fn = common.library(NAME).frontier_fill_batched
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [p, p, p, ctypes.c_int32, p, ctypes.c_int32,
                       ctypes.POINTER(_Probes), ctypes.c_int64,
                       ctypes.c_int64, p, p, p, p, p, p]
        fn.restype = ctypes.c_int
    return fn


def fold_batched(lo0: torch.Tensor, offs: torch.Tensor, total: torch.Tensor,
                 seed: torch.Tensor, probes: Sequence[Tuple],
                 leaf_anns: Sequence, sr, *,
                 _stage_bytes: int = _STAGE_BYTES):
    """``fold`` of B queries over the same levels, in ONE launch:
    ``lo0``, ``offs`` and the probe bounds ``[B, cap_in]``, ``total``
    ``[B]``; returns ``(folded, support)``, each ``[B, cap_in]``.  The
    kernel folds the batch as one merge path over its ``B * cap_in``
    rows; the queries' totals are scanned in int64 on the card (their
    sum may pass 2^31), so the call reads nothing on the host.  The probe
    segments of each query's first row with a candidate are staged first,
    in ``_STAGE_BYTES`` a query (``_STAGE_TOTAL`` a batch at most), and a
    tile whose rows all probe them looks them up there: the result is the
    same.  ``_stage_bytes``, for the tests, sets another budget a query
    (0: nothing staged)."""
    if offs.dim() != 2:
        raise ValueError("fold_batched takes [B, cap_in] rows")
    _check_fold(lo0, offs, total, seed, probes, leaf_anns, sr)
    if not common.kernel_device(lo0, FOLD_BATCHED_NAME):
        return fold_batched_ref(lo0, offs, total, seed, probes, leaf_anns,
                                sr)
    if lo0.numel() > (1 << 31) - 1:
        raise ValueError(f"a batch of {lo0.numel()} rows passes int32")
    # the int64 scan of the totals (see _launch_fold)
    base = torch.empty(int(lo0.shape[0]) + 1, dtype=torch.int64,
                       device=lo0.device)
    stage = min(_stage_bytes, _STAGE_TOTAL // int(lo0.shape[0])) // 16 * 16
    return _launch_fold(lo0, offs, total, base, seed, probes, leaf_anns, sr,
                        FOLD_BATCHED_NAME, stage)
