"""Node orderings (paper Appendix C.2.1; counterpart of
``repro.graph.ordering``).

Node ordering changes the ranges of the neighbor sets (and hence the layout
optimizer's decisions) and, for symmetric queries with pruning, the number of
comparisons. Orderings implemented, as in Table 11:

  random, bfs, degree (descending), revdegree (ascending), strongruns,
  shingle, hybrid (BFS then stable-sorted by descending degree).

The port's ``CSRGraph`` keeps host numpy arrays, so the orderings run on
the host in numpy as in the reference, and give the same permutations.
"""
from __future__ import annotations

from typing import Callable, Dict

import numpy as np

from repro_torch.core.trie import CSRGraph


def _perm_from_rank(rank: np.ndarray) -> np.ndarray:
    """rank[i] = sort key of node i -> perm[i] = new id of node i."""
    order = np.argsort(rank, kind="stable")
    perm = np.empty_like(order)
    perm[order] = np.arange(len(order))
    return perm


def order_random(csr: CSRGraph, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.permutation(csr.n)


def order_degree(csr: CSRGraph, seed: int = 0) -> np.ndarray:
    """Descending degree (the paper's default standard)."""
    return _perm_from_rank(-csr.degrees)


def order_revdegree(csr: CSRGraph, seed: int = 0) -> np.ndarray:
    return _perm_from_rank(csr.degrees)


def order_bfs(csr: CSRGraph, seed: int = 0) -> np.ndarray:
    """Breadth-first labeling from the highest-degree node of each component."""
    n = csr.n
    label = np.full(n, -1, dtype=np.int64)
    nxt = 0
    by_deg = np.argsort(-csr.degrees, kind="stable")
    for root in by_deg:
        if label[root] >= 0:
            continue
        frontier = np.array([root], dtype=np.int64)
        label[root] = nxt
        nxt += 1
        while len(frontier):
            nbrs = np.concatenate([csr.neighbors_of(int(u)) for u in frontier]) \
                if len(frontier) else np.zeros(0, np.int64)
            nbrs = np.unique(nbrs.astype(np.int64))
            new = nbrs[label[nbrs] < 0]
            label[new] = nxt + np.arange(len(new))
            nxt += len(new)
            frontier = new
    return label


def order_strongruns(csr: CSRGraph, seed: int = 0) -> np.ndarray:
    """Sort by degree, then assign continuous ids to each node's neighbors
    starting from the highest-degree node (approximates BFS; paper C.2.1)."""
    n = csr.n
    label = np.full(n, -1, dtype=np.int64)
    nxt = 0
    for u in np.argsort(-csr.degrees, kind="stable"):
        if label[u] < 0:
            label[u] = nxt
            nxt += 1
        for v in csr.neighbors_of(int(u)):
            if label[v] < 0:
                label[v] = nxt
                nxt += 1
    return label


def order_shingle(csr: CSRGraph, seed: int = 0) -> np.ndarray:
    """Shingle ordering [Chierichetti et al., KDD'09]: order nodes by the
    minhash of their neighborhood so similar neighborhoods get nearby ids."""
    rng = np.random.default_rng(seed)
    a = rng.integers(1, 1 << 31, dtype=np.int64)
    b = rng.integers(0, 1 << 31, dtype=np.int64)
    m = (1 << 31) - 1
    h = (a * csr.neighbors.astype(np.int64) + b) % m
    minhash = np.full(csr.n, np.iinfo(np.int64).max)
    src = np.repeat(np.arange(csr.n), csr.degrees)
    np.minimum.at(minhash, src, h)
    return _perm_from_rank(minhash)


def order_hybrid(csr: CSRGraph, seed: int = 0) -> np.ndarray:
    """Paper's proposed hybrid: BFS labels, then stable sort by descending
    degree (equal-degree nodes retain BFS order)."""
    bfs = order_bfs(csr, seed)
    # stable sort by (-degree, bfs)
    order = np.lexsort((bfs, -csr.degrees))
    perm = np.empty(csr.n, dtype=np.int64)
    perm[order] = np.arange(csr.n)
    return perm


ORDERINGS: Dict[str, Callable] = {
    "random": order_random,
    "bfs": order_bfs,
    "degree": order_degree,
    "revdegree": order_revdegree,
    "strongruns": order_strongruns,
    "shingle": order_shingle,
    "hybrid": order_hybrid,
}


def order_nodes(csr: CSRGraph, method: str, seed: int = 0) -> np.ndarray:
    return ORDERINGS[method](csr, seed)


def apply_ordering(csr: CSRGraph, perm: np.ndarray) -> CSRGraph:
    """Relabel nodes: new_id = perm[old_id]; neighbor sets stay sorted."""
    src = np.repeat(np.arange(csr.n), csr.degrees)
    new_src = perm[src].astype(np.int64)
    new_dst = perm[csr.neighbors].astype(np.int64)
    return CSRGraph.from_edges(new_src, new_dst, n=csr.n,
                               annotation=csr.annotation)
