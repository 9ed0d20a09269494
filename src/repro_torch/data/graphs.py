"""Synthetic graph generators (counterpart of ``repro.data.graphs``).

The paper's datasets (LiveJournal, Twitter, ...) are not available offline;
the engine runs on synthetic graphs matched to the paper's density-skew
regimes: power-law (App. C.2.1's Snap generator study) and Kronecker
(RMAT, Graph500 parameters; models real social-graph structure).  The
generators draw from numpy with a seed, so both packages build identical
graphs.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.trie import CSRGraph
from repro_torch.graph.prune import symmetrize


def powerlaw_graph(n: int, mean_deg: float = 8.0, exponent: float = 2.0,
                   seed: int = 0) -> CSRGraph:
    """Chung-Lu style power-law graph: P(edge ij) ∝ w_i w_j with
    w_i ~ i^{-1/(exponent-1)} (undirected, deduped, no self-loops)."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, n + 1, dtype=np.float64)
    w = ranks ** (-1.0 / (exponent - 1.0))
    w *= (mean_deg * n / 2) / w.sum()
    p = w / w.sum()
    m = int(mean_deg * n / 2)
    src = rng.choice(n, size=m, p=p)
    dst = rng.choice(n, size=m, p=p)
    return symmetrize(src, dst, n=n)


def kronecker_graph(scale: int, edge_factor: int = 16,
                    a: float = 0.57, b: float = 0.19, c: float = 0.19,
                    seed: int = 0) -> CSRGraph:
    """RMAT/Kronecker generator (Graph500 parameters by default):
    ``2**scale`` vertices, ``edge_factor * 2**scale`` drawn edges, each
    placed one bit a level by the quadrant probabilities ``(a | b / c |
    d)``, then symmetrized (deduped, no self-loops)."""
    rng = np.random.default_rng(seed)
    n = 1 << scale
    m = edge_factor * n
    src = np.zeros(m, dtype=np.int64)
    dst = np.zeros(m, dtype=np.int64)
    for lvl in range(scale):
        go_right = rng.random(m) > (a + c)          # dst high bit
        r2 = rng.random(m)
        # P(src high bit | the dst side drawn)
        go_down = np.where(go_right, r2 < c / (b + (1 - a - b - c) + 1e-12),
                           r2 < c / (a + c + 1e-12))
        src |= go_down.astype(np.int64) << lvl
        dst |= go_right.astype(np.int64) << lvl
    return symmetrize(src, dst, n=n)


def edge_list(g: CSRGraph):
    """``(src, dst)`` int64 arrays of every directed edge of ``g`` — the
    columns ``Engine.load_edges`` takes."""
    return (np.repeat(np.arange(g.n, dtype=np.int64), g.degrees),
            g.neighbors.astype(np.int64))
