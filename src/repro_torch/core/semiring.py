"""Semiring annotations (Green et al., provenance semirings).

Counterpart of ``repro.core.semiring``.  EmptyHeaded annotates trie values
with elements of a commutative semiring ``(K, add, mul, zero, one)`` and
folds annotations during projection — this is what makes early
aggregation (Section 3.2 of the paper) a *logical* plan property rather
than an executor special case.

The same semiring serves the host loop (numpy arrays) and the device
pipeline (torch tensors): ``add``/``mul`` take either, and
``segment_reduce`` takes either and returns a tensor on the data's device
(numpy input reduces on the CPU).  Dtypes follow the reference's x64-off
regime: COUNT is int32.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

Array = Any


def _either(np_fn, torch_fn):
    def fn(a, b):
        if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
            dev = a.device if isinstance(a, torch.Tensor) else b.device
            return torch_fn(torch.as_tensor(a, device=dev),
                            torch.as_tensor(b, device=dev))
        return np_fn(a, b)
    return fn


@dataclasses.dataclass(frozen=True)
class Semiring:
    """A commutative semiring with a vectorized segment reduction.

    Attributes:
      name: human-readable id.
      dtype: torch dtype of annotation arrays.
      zero: additive identity (scalar).
      one: multiplicative identity (scalar).
      add: elementwise ``a (+) b``.
      mul: elementwise ``a (*) b``.
      segment_reduce: ``(data, segment_ids, num_segments) -> reduced`` — the
        vectorized fold of ``add`` by key.
    """

    name: str
    dtype: torch.dtype
    zero: Any
    one: Any
    add: Callable[[Array, Array], Array]
    mul: Callable[[Array, Array], Array]
    segment_reduce: Callable[[Array, Array, int], torch.Tensor]

    @property
    def np_dtype(self) -> np.dtype:
        return torch.empty((), dtype=self.dtype).numpy().dtype

    def lift(self, n: int, value: Any = None, device=None) -> torch.Tensor:
        """An annotation vector of length ``n`` filled with ``one`` (or value)."""
        fill = self.one if value is None else value
        return torch.full((n,), fill, dtype=self.dtype, device=device)


def _segment(kind: str, dtype: torch.dtype, fill):
    """Segment reduction into ``n`` slots starting from ``fill`` (the
    semiring zero, so empty segments hold the identity as in the
    reference's ``jax.ops.segment_*``)."""
    def reduce(data, seg, n):
        data = torch.as_tensor(data)
        dev = data.device
        data = data.to(torch.int32 if dtype == torch.bool else dtype)
        seg = torch.as_tensor(seg, device=dev).to(torch.int64)
        out = torch.full((n,), fill, dtype=data.dtype, device=dev)
        if kind == "sum":
            out = out.index_add_(0, seg, data)
        else:
            out = out.scatter_reduce_(0, seg, data, kind, include_self=True)
        return out.to(dtype)
    return reduce


COUNT = Semiring(
    name="count",
    dtype=torch.int32,
    zero=0,
    one=1,
    add=lambda a, b: a + b,
    mul=lambda a, b: a * b,
    segment_reduce=_segment("sum", torch.int32, 0),
)

SUM_F32 = Semiring(
    name="sum_f32",
    dtype=torch.float32,
    zero=0.0,
    one=1.0,
    add=lambda a, b: a + b,
    mul=lambda a, b: a * b,
    segment_reduce=_segment("sum", torch.float32, 0.0),
)

# SUM_F64 narrows to float32, as the reference's does with x64 off.
SUM_F64 = Semiring(
    name="sum_f64",
    dtype=torch.float32,
    zero=0.0,
    one=1.0,
    add=lambda a, b: a + b,
    mul=lambda a, b: a * b,
    segment_reduce=_segment("sum", torch.float32, 0.0),
)

# Tropical / shortest-path semiring: add = min, mul = +.
MIN_PLUS = Semiring(
    name="min_plus",
    dtype=torch.float32,
    zero=np.float32(np.inf),
    one=0.0,
    add=_either(np.minimum, torch.minimum),
    mul=lambda a, b: a + b,
    segment_reduce=_segment("amin", torch.float32, float("inf")),
)

# Bottleneck semiring: add = max, mul = min.
MAX_MIN = Semiring(
    name="max_min",
    dtype=torch.float32,
    zero=np.float32(-np.inf),
    one=np.float32(np.inf),
    add=_either(np.maximum, torch.maximum),
    mul=_either(np.minimum, torch.minimum),
    segment_reduce=_segment("amax", torch.float32, float("-inf")),
)

BOOLEAN = Semiring(
    name="boolean",
    dtype=torch.bool,
    zero=False,
    one=True,
    add=_either(np.logical_or, torch.logical_or),
    mul=_either(np.logical_and, torch.logical_and),
    segment_reduce=_segment("amax", torch.bool, 0),
)

BY_NAME = {s.name: s for s in (COUNT, SUM_F32, SUM_F64, MIN_PLUS, MAX_MIN, BOOLEAN)}

# Aggregation-syntax name (<<SUM(x)>> etc.) -> semiring used to fold it.
AGG_TO_SEMIRING = {
    "count": COUNT,
    "sum": SUM_F32,
    "min": MIN_PLUS,
    "max": MAX_MIN,
    "or": BOOLEAN,
}
