"""Dictionary encoding (paper Section 2.2; counterpart of
``repro.graph.dictionary``).

Maps arbitrary input values to dense int32 ids in first-seen order.  The
order of id assignment is the node ordering — see
``repro_torch.graph.ordering`` for the orderings the paper studies
(degree/BFS/hybrid/...).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class Dictionary:
    """A bijection value <-> int32 id."""

    to_id: Dict[object, int]
    to_value: list

    @property
    def size(self) -> int:
        return len(self.to_value)

    @staticmethod
    def build(values: Iterable) -> "Dictionary":
        to_id: Dict[object, int] = {}
        to_value: list = []
        for v in values:
            if v not in to_id:
                to_id[v] = len(to_value)
                to_value.append(v)
        return Dictionary(to_id, to_value)

    def encode(self, values) -> np.ndarray:
        return np.fromiter((self.to_id[v] for v in values), dtype=np.int32,
                           count=len(values))

    def decode(self, ids: np.ndarray) -> list:
        return [self.to_value[int(i)] for i in ids]

    def remap(self, perm: np.ndarray) -> "Dictionary":
        """Apply a node permutation: new_id = perm[old_id]."""
        inv = np.empty_like(perm)
        inv[perm] = np.arange(len(perm))
        to_value = [self.to_value[int(inv[i])] for i in range(len(perm))]
        return Dictionary({v: i for i, v in enumerate(to_value)}, to_value)


def encode_edges(src, dst,
                 dictionary: Optional[Dictionary] = None
                 ) -> Tuple[np.ndarray, np.ndarray, Dictionary]:
    """Encode raw edge endpoints to dense int32 ids (first-seen order:
    every source, then every destination)."""
    if dictionary is None:
        dictionary = Dictionary.build(list(src) + list(dst))
    return dictionary.encode(src), dictionary.encode(dst), dictionary
