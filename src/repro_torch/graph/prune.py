"""Symmetric views of edge lists (counterpart of ``repro.graph.prune``).

For symmetric pattern queries on undirected graphs the engine loads both
directions of every edge; :func:`symmetrize` builds that view.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.trie import CSRGraph


def symmetrize(src, dst, n=None) -> CSRGraph:
    """Undirected view: add both directions, dedup, drop self-loops."""
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    keep = src != dst
    src, dst = src[keep], dst[keep]
    s = np.concatenate([src, dst])
    d = np.concatenate([dst, src])
    return CSRGraph.from_edges(s, d, n=n)
