"""Symmetric pruning and symmetric views of edge lists (paper Section
5.2.1 / Appendix C.2.2; counterpart of ``repro.graph.prune``).

For symmetric pattern queries on undirected graphs the engine loads both
directions of every edge (:func:`symmetrize`); :func:`prune_symmetric`
keeps each undirected edge once with src > dst, which counts each
triangle or clique exactly once and halves the data.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.trie import CSRGraph


def prune_symmetric(csr: CSRGraph) -> CSRGraph:
    """Keep only edges with src > dst ("symmetrically filtered" data)."""
    src = np.repeat(np.arange(csr.n), csr.degrees)
    dst = csr.neighbors.astype(np.int64)
    keep = src > dst
    return CSRGraph.from_edges(src[keep], dst[keep], n=csr.n,
                               annotation=csr.annotation[keep]
                               if csr.annotation is not None else None)


def symmetrize(src, dst, n=None) -> CSRGraph:
    """Undirected view: add both directions, dedup, drop self-loops."""
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    keep = src != dst
    src, dst = src[keep], dst[keep]
    s = np.concatenate([src, dst])
    d = np.concatenate([dst, src])
    return CSRGraph.from_edges(s, d, n=n)
