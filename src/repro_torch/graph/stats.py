"""Graph and skew statistics (paper Table 3 and footnote 4; counterpart of
``repro.graph.stats``).

Density skew is Pearson's first coefficient of skewness,
3 * (mean - mode) / sigma, over the per-node neighbor-set densities.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from repro_torch.core.layouts import set_ranges
from repro_torch.core.trie import CSRGraph


def density_skew(csr: CSRGraph) -> float:
    """Pearson's first coefficient over per-set density (|S| / range)."""
    deg = csr.degrees
    rng = set_ranges(csr)
    nz = deg > 0
    if nz.sum() < 2:
        return 0.0
    density = deg[nz] / np.maximum(rng[nz], 1)
    sigma = float(density.std())
    if sigma == 0:
        return 0.0
    hist, edges = np.histogram(density, bins=64)
    mode = float((edges[np.argmax(hist)] + edges[np.argmax(hist) + 1]) / 2)
    return float(3.0 * (density.mean() - mode) / sigma)


def graph_stats(csr: CSRGraph) -> Dict[str, float]:
    deg = csr.degrees
    return {
        "nodes": int(csr.n),
        "edges": int(csr.m),
        "max_degree": int(deg.max()) if csr.n else 0,
        "mean_degree": float(deg.mean()) if csr.n else 0.0,
        "density_skew": density_skew(csr),
    }
