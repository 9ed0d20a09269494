"""Generalized hypertree decompositions (paper Section 3.2, Definition 1).

A GHD of a query hypergraph H is a tree whose nodes ("bags") carry
``chi(t)`` (attributes) and ``lambda(t)`` (hyperedges) such that

  1. every hyperedge is contained in some bag's chi,
  2. every attribute's bag-set is connected in the tree (running
     intersection property, RIP),
  3. chi(t) is covered by lambda(t).

The *width* of a bag is the fractional edge-cover number of its
sub-hypergraph (AGM exponent); the GHD's width is the max over bags; the
optimizer picks a minimum-width GHD ("it is key that the optimizer selects
a GHD with the smallest value of w", Section 3.2) and then, as in the
paper, applies early aggregation over it.

Search strategy: queries are tiny (<= ~8 atoms), so we enumerate *set
partitions of the hyperedges* into bags (Bell(8) = 4140) and, per
partition, test whether the bags admit a join tree via the classical
maximum-spanning-tree characterization: a tree over the bags satisfies RIP
iff the max-weight spanning tree (weights = |chi_i cap chi_j|) attains
``sum_v (#bags containing v) - 1`` total weight (Tarjan & Yannakakis'
acyclicity test applied to the bag hypergraph). This enumerates exactly
the edge-partitioned GHDs, which include the minimum-fhw plans for every
query in the paper (Triangle, 4-Clique, Lollipop, Barbell, ...).
"""
from __future__ import annotations

import dataclasses
import itertools
import math
import warnings
from typing import Dict, FrozenSet, List, Optional, Sequence, Tuple

from repro_torch.core.agm import fractional_cover_number
from repro_torch.core.hypergraph import Hypergraph


@dataclasses.dataclass
class Bag:
    """One GHD node: lambda(t) = edge_idxs, chi(t) = attrs."""

    edge_idxs: Tuple[int, ...]
    attrs: Tuple[str, ...]          # chi(t), ordered by the global order later
    width: float                     # AGM exponent of the bag sub-query
    children: List["Bag"] = dataclasses.field(default_factory=list)
    parent: Optional["Bag"] = None

    # Filled by the planner --------------------------------------------------
    shared_with_parent: Tuple[str, ...] = ()

    def walk(self):
        yield self
        for c in self.children:
            yield from c.walk()

    def __repr__(self):
        return (f"Bag(edges={list(self.edge_idxs)}, chi={list(self.attrs)}, "
                f"w={self.width:.3g}, kids={len(self.children)})")


@dataclasses.dataclass
class GHD:
    root: Bag
    width: float                    # fractional hypertree width of this plan
    hypergraph: Hypergraph
    # True when decompose() hit its partition budget before exhausting the
    # search space — the returned GHD is best-so-far, not proven minimal.
    search_exhausted: bool = False

    def bags(self) -> List[Bag]:
        return list(self.root.walk())

    def num_bags(self) -> int:
        return len(self.bags())

    def pretty(self, bag: Optional[Bag] = None, depth: int = 0) -> str:
        bag = bag or self.root
        rels = ",".join(f"{self.hypergraph.edges[i].rel}" for i in bag.edge_idxs)
        line = "  " * depth + f"[{rels}] chi={{{','.join(bag.attrs)}}} w={bag.width:.3g}"
        return "\n".join([line] + [self.pretty(c, depth + 1) for c in bag.children])


# --------------------------------------------------------------- partitions
def _set_partitions(items: Sequence[int]):
    """All partitions of ``items`` into non-empty groups (restricted growth)."""
    items = list(items)
    n = len(items)
    if n == 0:
        yield []
        return
    codes = [0] * n

    def rec(i: int, maxc: int):
        if i == n:
            groups: Dict[int, List[int]] = {}
            for it, c in zip(items, codes):
                groups.setdefault(c, []).append(it)
            yield [tuple(g) for g in groups.values()]
            return
        for c in range(maxc + 2):
            codes[i] = c
            yield from rec(i + 1, max(maxc, c))

    yield from rec(1, 0) if n > 0 else iter([[]])


def _mst_rip_tree(chis: List[FrozenSet[str]]):
    """Max-weight spanning tree over bags; returns (parent[], ok) where ok
    says the tree satisfies the running intersection property."""
    k = len(chis)
    if k == 1:
        return [-1], True
    in_tree = [False] * k
    parent = [-1] * k
    best = [-1] * k
    in_tree[0] = True
    best_w = [len(chis[0] & chis[j]) for j in range(k)]
    for j in range(k):
        best[j] = 0
    total = 0
    for _ in range(k - 1):
        cand, cw = -1, -1
        for j in range(k):
            if not in_tree[j] and best_w[j] > cw:
                cand, cw = j, best_w[j]
        in_tree[cand] = True
        parent[cand] = best[cand]
        total += cw
        for j in range(k):
            if not in_tree[j]:
                w = len(chis[cand] & chis[j])
                if w > best_w[j]:
                    best_w[j], best[j] = w, cand
    # RIP iff total == sum_v (count(v) - 1)
    counts: Dict[str, int] = {}
    for chi in chis:
        for v in chi:
            counts[v] = counts.get(v, 0) + 1
    target = sum(c - 1 for c in counts.values())
    return parent, total == target


# ------------------------------------------------------------------- search
def _iter_valid_partitions(hg: Hypergraph, max_partitions: int,
                           state: Dict[str, bool]):
    """Stream RIP-valid edge partitions as ``(partition, chis, parent,
    widths)``; sets ``state["truncated"]`` when the budget runs out. The
    budget counts EVERY partition visited (valid or not), exactly as the
    original best-so-far loop did. Streaming keeps ``decompose()`` at
    O(1) memory — only ``decompose_candidates`` materializes the list."""
    E = len(hg.edges)
    assert E >= 1
    width_cache: Dict[Tuple[int, ...], float] = {}

    def bag_width(group: Tuple[int, ...]) -> float:
        key = tuple(sorted(group))
        if key not in width_cache:
            width_cache[key] = fractional_cover_number(hg, key)
        return width_cache[key]

    n_seen = 0
    for partition in _set_partitions(range(E)):
        n_seen += 1
        if n_seen > max_partitions:
            state["truncated"] = True
            return
        chis = [frozenset(hg.edge_vars(g)) for g in partition]
        parent, ok = _mst_rip_tree(chis)
        if not ok:
            continue
        widths = [bag_width(g) for g in partition]
        yield partition, chis, parent, widths


def _seed_root(chis, widths, out_set):
    """The decompose() root tie-break: a bag covering the output vars
    (elides the top-down pass, Appendix A.1); among covering bags prefer
    the *narrowest* — this tends to center the tree on connector bags
    (e.g. U in Barbell), making symmetric sub-queries siblings so the
    equivalent-bag elimination of Appendix A.1 can fire."""
    cands = [(widths[i], i) for i, chi in enumerate(chis) if out_set <= chi]
    if cands:
        return min(cands)[1], True
    return 0, False


def _partition_key(partition, chis, widths, out_set):
    """Tie-breaking (paper Section 3.2 + Example 3.1 behaviour):
      1. smallest width  (the theoretical guarantee),
      2. smallest sum of bag widths (prefer splitting a wide query into
         cheap bags -> early aggregation does more work),
      3. fewest bags (cheaper Yannakakis passes),
      4. root covers the output attributes if possible (lets the planner
         elide the top-down pass, Appendix A.1).
    """
    _root, covers_out = _seed_root(chis, widths, out_set)
    return (round(max(widths), 9), round(sum(widths), 9), len(partition),
            0 if covers_out else 1)


def decompose(hg: Hypergraph,
              output_vars: Sequence[str] = (),
              max_partitions: int = 200_000) -> GHD:
    """Enumerate edge-partition GHDs; return one of minimum width
    (tie-break: `_partition_key`, root: `_seed_root`)."""
    out_set = frozenset(output_vars)
    state = {"truncated": False}
    best_key, best = None, None
    for partition, chis, parent, widths in \
            _iter_valid_partitions(hg, max_partitions, state):
        key = _partition_key(partition, chis, widths, out_set)
        if best_key is None or key < best_key:
            best_key = key
            best = (partition, chis, parent, widths,
                    _seed_root(chis, widths, out_set)[0])

    assert best is not None, "no GHD found (disconnected RIP failure?)"
    truncated = state["truncated"]
    if truncated:
        # Best-so-far is returned, but silently truncating hid plan
        # quality regressions: record it on the GHD and warn.
        warnings.warn(
            f"GHD search truncated at max_partitions={max_partitions} "
            f"({len(hg.edges)} hyperedges): returning the best "
            f"decomposition seen so far (width {best_key[0]:.3g}); plan "
            f"may be suboptimal",
            RuntimeWarning, stacklevel=2)
    partition, chis, parent, widths, root_idx = best
    g = _build_tree(hg, partition, chis, parent, widths, root_idx)
    g.search_exhausted = truncated
    return g


def decompose_candidates(hg: Hypergraph,
                         output_vars: Sequence[str] = (),
                         k: int = 4,
                         max_roots: int = 4,
                         max_partitions: int = 200_000) -> List[GHD]:
    """Candidate GHDs for the cost-based plan search.

    Emits only MINIMUM-width partitions (the paper's hard constraint:
    "it is key that the optimizer selects a GHD with the smallest value
    of w", Section 3.2) — the top ``k`` of them by the ``decompose()``
    tie-break key — and, per partition, up to ``max_roots`` rootings
    (the seed root first, then other output-covering bags by width; for
    listing queries whose outputs no bag covers, any bag may root the
    tree and the top-down pass reassembles the result).

    The FIRST returned GHD is exactly ``decompose()``'s choice, so a
    cost model that breaks ties toward earlier candidates reproduces the
    seed plan when costs tie.
    """
    out_set = frozenset(output_vars)
    state = {"truncated": False}
    valid = list(_iter_valid_partitions(hg, max_partitions, state))
    truncated = state["truncated"]
    assert valid, "no GHD found (disconnected RIP failure?)"
    keyed = sorted(
        ((_partition_key(p, chis, widths, out_set), p, chis, parent, widths)
         for p, chis, parent, widths in valid),
        key=lambda t: t[0])
    min_width = keyed[0][0][0]
    keyed = [t for t in keyed if t[0][0] == min_width][:max(1, k)]

    ghds: List[GHD] = []
    for _key, partition, chis, parent, widths in keyed:
        seed_root, covers = _seed_root(chis, widths, out_set)
        roots = [seed_root]
        if covers:
            alt = sorted((widths[i], i) for i, chi in enumerate(chis)
                         if out_set <= chi)
        else:
            alt = sorted((widths[i], i) for i in range(len(chis)))
        for _w, i in alt:
            if i not in roots and len(roots) < max(1, max_roots):
                roots.append(i)
        for r in roots:
            g = _build_tree(hg, partition, chis, parent, widths, r)
            g.search_exhausted = truncated
            ghds.append(g)
    return ghds


def _build_tree(hg, partition, chis, parent, widths, root_idx) -> GHD:
    k = len(partition)
    # Re-root the MST at root_idx.
    adj: Dict[int, List[int]] = {i: [] for i in range(k)}
    for i, p in enumerate(parent):
        if p >= 0:
            adj[i].append(p)
            adj[p].append(i)
    bags = [Bag(tuple(partition[i]),
                tuple(sorted(chis[i])),
                widths[i]) for i in range(k)]
    seen = {root_idx}
    order = [root_idx]
    head = 0
    par = {root_idx: None}
    while head < len(order):
        u = order[head]
        head += 1
        for v in adj[u]:
            if v not in seen:
                seen.add(v)
                par[v] = u
                order.append(v)
    for v in order[1:]:
        p = par[v]
        bags[v].parent = bags[p]
        bags[p].children.append(bags[v])
        bags[v].shared_with_parent = tuple(
            sorted(chis[v] & chis[p]))
    return GHD(bags[root_idx], max(widths), hg)


# ----------------------------------------------------- global attribute order
def attribute_order(ghd: GHD, output_vars: Sequence[str] = ()) -> Tuple[str, ...]:
    """Pre-order traversal over the GHD, queueing each bag's attributes
    (paper Section 3.2 "Global Attribute Ordering").

    Within a bag, attributes shared with the parent come first (they are
    already bound when the bag runs), then output attributes, then the rest
    — this keeps retained attributes early, so aggregated attributes sit at
    the deepest loop levels where the terminal fold applies.

    Ties within each group break by QUERY-APPEARANCE order (the order the
    user wrote the variables), not alphabetically: on the symmetric K4
    query the alphabetical tie-break put the 4th clique vertex 'a' first
    and cost 7x vs the appearance order (caught by the Table 8 benchmark).
    """
    out_set = set(output_vars)
    appear = {v: i for i, v in enumerate(ghd.hypergraph.vertices)}
    order: List[str] = []
    seen = set()

    def visit(bag: Bag):
        def by_appearance(vs):
            return sorted(vs, key=lambda v: appear.get(v, 1 << 30))

        shared = [v for v in bag.shared_with_parent]
        outs = by_appearance(v for v in bag.attrs
                             if v in out_set and v not in shared)
        rest = by_appearance(v for v in bag.attrs
                             if v not in out_set and v not in shared)
        for v in shared + outs + rest:
            if v not in seen:
                seen.add(v)
                order.append(v)
        for c in bag.children:
            visit(c)

    visit(ghd.root)
    return tuple(order)


def candidate_orders(ghd: GHD, output_vars: Sequence[str] = (),
                     max_group: int = 4, limit: int = 64) -> List[Tuple[str, ...]]:
    """Candidate global attribute orders compatible with ``ghd``.

    Every candidate keeps the structural invariants of
    :func:`attribute_order` — pre-order over bags, shared-with-parent
    attributes inherited from the ancestor that introduced them, output
    attributes before aggregated-away attributes within a bag (so
    terminal folds stay terminal) — but permutes WITHIN each bag's
    output group and rest group, which is exactly the degree of freedom
    the appearance-order tie-break fixes arbitrarily.

    The FIRST order returned is exactly ``attribute_order(ghd,
    output_vars)``; groups larger than ``max_group`` attributes keep
    only their appearance order (bounding the product), and at most
    ``limit`` orders are emitted overall.
    """
    out_set = set(output_vars)
    appear = {v: i for i, v in enumerate(ghd.hypergraph.vertices)}

    def by_appearance(vs):
        return sorted(vs, key=lambda v: appear.get(v, 1 << 30))

    per_bag: List[List[Tuple[str, ...]]] = []
    for bag in ghd.root.walk():
        shared = set(bag.shared_with_parent)
        outs = by_appearance(v for v in bag.attrs
                             if v in out_set and v not in shared)
        rest = by_appearance(v for v in bag.attrs
                             if v not in out_set and v not in shared)
        outs_opts = ([tuple(outs)] if not 1 < len(outs) <= max_group
                     else [tuple(p) for p in itertools.permutations(outs)])
        rest_opts = ([tuple(rest)] if not 1 < len(rest) <= max_group
                     else [tuple(p) for p in itertools.permutations(rest)])
        per_bag.append([o + r for o in outs_opts for r in rest_opts])

    orders: List[Tuple[str, ...]] = []
    for combo in itertools.islice(itertools.product(*per_bag), max(1, limit)):
        order: List[str] = []
        seen = set()
        for seq in combo:
            for v in seq:
                if v not in seen:
                    seen.add(v)
                    order.append(v)
        order = tuple(order)
        if order not in orders:
            orders.append(order)
    return orders


def single_bag(hg: Hypergraph) -> GHD:
    """The no-GHD baseline (``-GHD`` ablation): one bag with every edge —
    exactly the generic worst-case optimal algorithm with no early
    aggregation across bags (what the paper says LogicBlox ships)."""
    g = tuple(range(len(hg.edges)))
    w = fractional_cover_number(hg, g)
    bag = Bag(g, tuple(sorted(hg.edge_vars(g))), w)
    return GHD(bag, w, hg)
