"""AGM bound / fractional edge cover (paper Section 2.1, Eq. 1).

``AGM(Q) = min Π_e |R_e|^{x_e}`` over feasible fractional covers x — found
by minimizing ``Σ_e x_e · log|R_e|`` subject to ``Σ_{e ∋ v} x_e ≥ 1`` per
vertex, ``x ≥ 0`` ("take the log of Eq. 1 and solve the linear program",
footnote 3).

Query hypergraphs are tiny (≤ ~8 edges), so instead of a general simplex we
enumerate basic feasible solutions exactly: every vertex of the polyhedron
{Ax ≥ b, x ≥ 0} is the solution of |E| tight constraints chosen among the
|V| cover rows and the |E| bounds. With |E|+|V| ≤ 16 that is ≤ C(16,8) ≈ 13k
tiny linear solves — exact, and free of pivot-degeneracy corner cases.
"""
from __future__ import annotations

import itertools
import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.hypergraph import Hypergraph


def fractional_cover(hg: Hypergraph,
                     edge_idxs: Optional[Sequence[int]] = None,
                     log_sizes: Optional[Dict[int, float]] = None,
                     ) -> Tuple[float, np.ndarray]:
    """Optimal fractional edge cover of the sub-hypergraph on ``edge_idxs``.

    Returns (objective, x) where objective = Σ x_e·w_e with w_e = log|R_e|
    (w_e = 1 when log_sizes is None — then the objective is the *fractional
    edge cover number*, i.e. the width exponent with all |R| = N).
    """
    if edge_idxs is None:
        edge_idxs = list(range(len(hg.edges)))
    edge_idxs = list(edge_idxs)
    E = len(edge_idxs)
    verts = sorted(hg.edge_vars(edge_idxs))
    V = len(verts)
    if E == 0 or V == 0:
        return 0.0, np.zeros(E)
    w = np.array([1.0 if log_sizes is None else log_sizes[e] for e in edge_idxs])
    # cover matrix A[v, e] = 1 if v in edge e
    A = np.zeros((V, E))
    for j, e in enumerate(edge_idxs):
        for i, v in enumerate(verts):
            if v in hg.edges[e].vars:
                A[i, j] = 1.0

    # Constraints: A x >= 1 (V rows) and x >= 0 (E rows).
    rows = [(A[i], 1.0) for i in range(V)] + \
           [(np.eye(E)[j], 0.0) for j in range(E)]
    best_obj, best_x = math.inf, None
    for combo in itertools.combinations(range(len(rows)), E):
        M = np.stack([rows[i][0] for i in combo])
        b = np.array([rows[i][1] for i in combo])
        try:
            x = np.linalg.solve(M, b)
        except np.linalg.LinAlgError:
            continue
        if np.any(x < -1e-9):
            continue
        if np.any(A @ x < 1.0 - 1e-9):
            continue
        obj = float(w @ x)
        if obj < best_obj - 1e-12:
            best_obj, best_x = obj, np.clip(x, 0.0, None)
    assert best_x is not None, "cover LP infeasible (isolated vertex?)"
    return best_obj, best_x


def agm_bound(hg: Hypergraph, sizes: Dict[int, int],
              edge_idxs: Optional[Sequence[int]] = None) -> float:
    """The AGM output-size bound Π |R_e|^{x_e} (data-aware)."""
    log_sizes = {e: math.log(max(2, sizes[e])) for e in
                 (edge_idxs if edge_idxs is not None else range(len(hg.edges)))}
    obj, _ = fractional_cover(hg, edge_idxs, log_sizes)
    return math.exp(obj)


def fractional_cover_number(hg: Hypergraph,
                            edge_idxs: Optional[Sequence[int]] = None) -> float:
    """ρ*: width exponent when all relations have size N (AGM = N^ρ*)."""
    obj, _ = fractional_cover(hg, edge_idxs, None)
    return obj
