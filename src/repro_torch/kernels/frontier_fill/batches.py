"""Seeded inputs of the batched fold shaped like an anchored query's, for
the tests and the smoke run: every row of a query probes one shared
segment, as ``triangle_at``'s ``T(0,z)`` does.

``anchored_batch`` builds one level of adjacency lists (sorted, distinct
values; each vertex's values drawn from a window of the value range, so
segments span very different ranges, the hub's the whole of it) and a
batch over it.  Query ``b`` is anchored at a vertex: its live rows are
the anchor's neighbours (up to ``cap_in``, the rest dead), each row's
seed segment that neighbour's list, and each probe's segment the
anchor's list for every live row.  Query 0 has no candidate, query 1 is
anchored at the hub (every row of the capacity live), and the others at
vertices of spread degrees; ``empty`` queries probe an empty segment,
``varied`` queries a segment that differs from row to row (another
vertex's list, as ``4clique_at``'s ``X(y,a)``).  Dead rows carry bounds of their own,
which no probe may read.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch


def adjacency_level(seed: int, vertices: int, universe: int, hub: int):
    """``(offsets, values)`` of ``vertices`` sorted lists over
    ``[0, universe)``: vertex 0 a hub of ``hub`` values over the whole
    range, the others Zipf degrees (some 0) in windows about 40 times
    their degree wide."""
    r = np.random.default_rng(seed)
    deg = np.minimum(r.zipf(1.7, vertices) * 3 - 3, hub)
    deg[0] = hub
    lists = []
    for v, d in enumerate(deg):
        width = universe if v == 0 else int(min(universe, max(64, 40 * d)))
        lo = int(r.integers(0, universe - width + 1))
        lists.append(np.unique(r.integers(lo, lo + width, int(d * 1.3) + 1))
                     [:d])
    sizes = np.array([len(x) for x in lists])
    offsets = np.concatenate([[0], np.cumsum(sizes)])
    return offsets, np.concatenate(lists)


def anchored_batch(seed: int, batch: int = 8, cap_in: int = 48,
                   n_probes: int = 1, vertices: int = 600,
                   universe: int = 20_000, hub: int = 400,
                   empty: Sequence[int] = (2,), varied: Sequence[int] = (),
                   device="cpu"):
    """A batch as the module docstring says; returns ``(total [B], offs,
    lo0 [B, cap_in], seed [n], probes)``, each probe ``(values, lo [B,
    cap_in], hi [B, cap_in])`` over the same level, int32 on ``device``."""
    offsets, values = adjacency_level(seed, vertices, universe, hub)
    r = np.random.default_rng(seed + 1)
    deg = np.diff(offsets)
    linked = np.flatnonzero(deg > 0)  # the vertices a neighbour may be
    by_degree = linked[np.argsort(-deg[linked], kind="stable")]
    # anchors: none, the hub, then vertices of spread degrees
    anchors = [0, 0] + [int(by_degree[int(i)]) for i in
                        np.linspace(1, len(linked) - 1, max(batch - 2, 0))]
    isolated = int(np.flatnonzero(deg == 0)[0]) if (deg == 0).any() else 0
    lo0 = np.zeros((batch, cap_in), np.int64)
    cnt = np.zeros((batch, cap_in), np.int64)
    los = np.zeros((n_probes, batch, cap_in), np.int64)
    his = np.zeros((n_probes, batch, cap_in), np.int64)
    for b in range(batch):
        a = anchors[b]
        nbr = linked[values[offsets[a]:offsets[a + 1]][:cap_in]
                     % len(linked)]
        live = len(nbr) if b else 0
        lo0[b, :live] = offsets[nbr[:live]]
        cnt[b, :live] = deg[nbr[:live]]
        # dead rows: bounds of their own (and a seed start), no candidate
        lo0[b, live:] = r.integers(0, len(values), cap_in - live)
        los[:, b, live:] = r.integers(0, len(values),
                                      (n_probes, cap_in - live))
        his[:, b, live:] = los[:, b, live:] + 1
        t = isolated if b in empty else a
        if b in varied:
            other = r.integers(0, vertices, (n_probes, live))
            los[:, b, :live] = offsets[other]
            his[:, b, :live] = offsets[other + 1]
        else:
            los[:, b, :live] = offsets[t]
            his[:, b, :live] = offsets[t + 1]
    offs = np.cumsum(cnt, 1) - cnt

    def t32(x):
        return torch.as_tensor(np.ascontiguousarray(x, dtype=np.int32),
                               device=device)

    level = t32(values)
    probes = tuple((level, t32(los[k]), t32(his[k]))
                   for k in range(n_probes))
    return t32(cnt.sum(1)), t32(offs), t32(lo0), level, probes
