"""Trie-structured relations (paper Section 2.2).

A relation with attribute order (a_1, ..., a_k) is stored as k levels.
Level i holds the sorted, de-duplicated values of attribute a_i grouped by
their parent tuple in level i-1 — i.e. nested CSR ("tries are multi-level
data structures common in column stores and graph engines").

Values are 32-bit dictionary-encoded ids (paper: "tries currently support
sets containing 32-bit values"); the encoding itself lives in
``repro_torch.graph.dictionary``. Annotations (Section 2.2, "Trie Annotations")
are a 1-1 mapped value array on the last level and carry semiring elements.

Storage is host-side numpy (the trie is built once per query/dataset at load
time, like EmptyHeaded's loader); the execution engine moves the flat arrays
to device as needed.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class TrieLevel:
    """One trie level: CSR of values grouped by parent index."""

    values: np.ndarray   # [n_i] int32, sorted within each parent segment
    offsets: np.ndarray  # [n_{i-1} + 1] int64 — segment bounds per parent

    def __post_init__(self):
        assert self.offsets[0] == 0 and self.offsets[-1] == len(self.values)

    @property
    def size(self) -> int:
        return int(len(self.values))

    def segment(self, parent_pos: int) -> np.ndarray:
        return self.values[self.offsets[parent_pos]:self.offsets[parent_pos + 1]]

    def device_values(self, to_device, on_upload=None):
        """Device-resident copy of ``values``, uploaded once and cached.

        ``to_device`` is the backend's upload function (a torch upload),
        injected so trie storage itself stays numpy-pure. The cache keys
        on array identity, so a rebuilt level re-uploads while repeated
        queries / recursion rounds over the same relation reuse the
        resident copy. ``on_upload`` (if given) is called exactly when an
        actual upload happens — the backend's instrumentation hook.
        """
        cached = self.__dict__.get("_dev_values")
        if cached is None or cached[0] is not self.values:
            cached = (self.values, to_device(self.values))
            self._dev_values = cached
            if on_upload is not None:
                on_upload()
        return cached[1]

    def device_offsets(self, to_device, on_upload=None):
        """Device-resident copy of ``offsets`` (same identity-keyed cache
        discipline as :meth:`device_values`).  The zero-sync extension
        pipeline derives per-row candidate bounds on device
        (``lo = offsets[cursor]``), so segment offsets must be resident
        alongside the values they index."""
        cached = self.__dict__.get("_dev_offsets")
        if cached is None or cached[0] is not self.offsets:
            cached = (self.offsets, to_device(self.offsets))
            self._dev_offsets = cached
            if on_upload is not None:
                on_upload()
        return cached[1]


@dataclasses.dataclass
class Trie:
    """A k-level trie over ``attrs`` with an optional annotation column."""

    name: str
    attrs: Tuple[str, ...]
    levels: list  # list[TrieLevel]
    annotation: Optional[np.ndarray] = None  # aligned with levels[-1].values

    @property
    def arity(self) -> int:
        return len(self.attrs)

    @property
    def num_tuples(self) -> int:
        return self.levels[-1].size if self.levels else 0

    # ------------------------------------------------------------------ build
    @staticmethod
    def build(
        name: str,
        attrs: Sequence[str],
        columns: Sequence[np.ndarray],
        annotation: Optional[np.ndarray] = None,
        dedup: bool = True,
    ) -> "Trie":
        """Build a trie from column arrays (one per attribute, equal length).

        Tuples are lexicographically sorted by (columns[0], ..., columns[-1]);
        duplicate tuples are removed (annotations of duplicates are summed is
        NOT done here — callers pre-aggregate; we keep the first).
        """
        attrs = tuple(attrs)
        k = len(attrs)
        assert k >= 1 and len(columns) == k
        n = len(columns[0])
        cols = [np.asarray(c, dtype=np.int32) for c in columns]
        for c in cols:
            assert len(c) == n

        if n == 0:
            levels = [TrieLevel(np.zeros(0, np.int32), np.zeros(1, np.int64))]
            for _ in range(k - 1):
                levels.append(TrieLevel(np.zeros(0, np.int32), np.zeros(1, np.int64)))
            return Trie(name, attrs, levels, annotation)

        # np.lexsort sorts by the LAST key first.
        order = np.lexsort(tuple(reversed(cols)))
        cols = [c[order] for c in cols]
        ann = annotation[order] if annotation is not None else None

        if dedup:
            keep = np.ones(n, dtype=bool)
            same = np.ones(n - 1, dtype=bool)
            for c in cols:
                same &= c[1:] == c[:-1]
            keep[1:] = ~same
            cols = [c[keep] for c in cols]
            if ann is not None:
                ann = ann[keep]
            n = len(cols[0])

        levels = []
        # parent_ids: for each tuple, the index of its parent node in level i-1.
        parent_ids = np.zeros(n, dtype=np.int64)
        n_parents = 1
        for i in range(k):
            # A new node at level i starts where (parent_id, value) changes.
            v = cols[i]
            if i == 0:
                newnode = np.ones(n, dtype=bool)
                newnode[1:] = v[1:] != v[:-1]
            else:
                newnode = np.ones(n, dtype=bool)
                newnode[1:] = (v[1:] != v[:-1]) | (parent_ids[1:] != parent_ids[:-1])
            node_id = np.cumsum(newnode) - 1  # id of each tuple's level-i node
            n_nodes = int(node_id[-1]) + 1
            first = np.flatnonzero(newnode)
            values = v[first].astype(np.int32)
            # offsets: count of level-i nodes per parent.
            counts = np.bincount(parent_ids[first], minlength=n_parents)
            offsets = np.zeros(n_parents + 1, dtype=np.int64)
            np.cumsum(counts, out=offsets[1:])
            levels.append(TrieLevel(values, offsets))
            parent_ids = node_id
            n_parents = n_nodes

        if ann is not None:
            ann = np.asarray(ann)
        return Trie(name, attrs, levels, ann)

    @staticmethod
    def from_edges(
        name: str,
        src: np.ndarray,
        dst: np.ndarray,
        attrs: Tuple[str, str] = ("x", "y"),
        annotation: Optional[np.ndarray] = None,
    ) -> "Trie":
        return Trie.build(name, attrs, [src, dst], annotation)

    # ------------------------------------------------------------ navigation
    def level0_values(self) -> np.ndarray:
        return self.levels[0].values

    def child_bounds(self, depth: int, parent_pos: np.ndarray):
        """Vectorized segment bounds at ``depth`` for parent positions.

        depth: level index >= 1; parent_pos indexes levels[depth-1].values.
        Returns (lo, hi) int64 arrays.
        """
        off = self.levels[depth].offsets
        return off[parent_pos], off[parent_pos + 1]

    def edge_view(self):
        """Flat ``(src, dst, annotation)`` column view of a binary trie.

        This is the fixed-shape edge stream the device-resident recursion
        loops (``core.recursion``) consume instead of rebuilding a delta
        trie per round: uploaded once, it stays valid for every round
        because seminaive/naive deltas are annotation VECTORS over the
        vertex domain, not new tries.  Cached on the trie (identity-keyed
        like :meth:`TrieLevel.device_values`), so repeated recursive
        queries over the same relation pay the expansion once.
        """
        assert self.arity == 2, "edge_view is the binary fast path"
        token = (id(self.levels[0].values), id(self.levels[1].values))
        cached = self.__dict__.get("_edge_view")
        if cached is not None and cached[0] == token:
            return cached[1]
        counts = np.diff(self.levels[1].offsets)
        src = np.repeat(self.levels[0].values.astype(np.int64), counts)
        view = (src, self.levels[1].values.astype(np.int64), self.annotation)
        self._edge_view = (token, view)
        return view

    def device_annotation(self, to_device, on_upload=None):
        """Device-resident copy of the annotation column (identity-keyed
        like :meth:`TrieLevel.device_values`); ``None`` when the trie is
        unannotated.  The extension pipeline multiplies exhausted atoms'
        annotations into the device-resident frontier annotation."""
        if self.annotation is None:
            return None
        cached = self.__dict__.get("_dev_annotation")
        if cached is None or cached[0] is not self.annotation:
            cached = (self.annotation, to_device(self.annotation))
            self._dev_annotation = cached
            if on_upload is not None:
                on_upload()
        return cached[1]

    def reorder(self, attrs: Sequence[str]) -> "Trie":
        """Re-index this trie under a different attribute order.

        Materializes tuples and rebuilds — EmptyHeaded builds one trie per
        (relation, required index order); this is the "column (index) order"
        selection of Section 2.2.
        """
        attrs = tuple(attrs)
        if attrs == self.attrs:
            return self
        assert sorted(attrs) == sorted(self.attrs), (attrs, self.attrs)
        tuples, ann = self.materialize()
        perm = [self.attrs.index(a) for a in attrs]
        cols = [tuples[:, j] for j in perm]
        return Trie.build(self.name, attrs, cols, ann)

    def materialize(self):
        """Expand back to a dense tuple matrix [N, k] (+ annotation)."""
        k = self.arity
        n = self.num_tuples
        out = np.zeros((n, k), dtype=np.int32)
        # Walk levels from the bottom: each level-(k-1) value corresponds to a
        # tuple; propagate parents upward.
        idx = np.arange(n)
        out[:, k - 1] = self.levels[k - 1].values
        parent = _parent_of(self.levels[k - 1].offsets, idx)
        for i in range(k - 2, -1, -1):
            out[:, i] = self.levels[i].values[parent]
            if i > 0:
                parent = _parent_of(self.levels[i].offsets, parent)
        return out, (self.annotation.copy() if self.annotation is not None else None)

    def nbytes(self) -> int:
        total = 0
        for lv in self.levels:
            total += lv.values.nbytes + lv.offsets.nbytes
        if self.annotation is not None:
            total += self.annotation.nbytes
        return total

    # ------------------------------------------------------- device residency
    @property
    def device_resident(self) -> bool:
        """True if ANY level array (or the annotation, or a device layout
        store of this trie) currently holds a device-resident cached copy
        — the multi-tenant graph store's eviction accounting reads this."""
        if self.__dict__.get("_dev_annotation") is not None:
            return True
        if any(store._dev for _k, store in self.device_stores()):
            return True
        return any(lv.__dict__.get("_dev_values") is not None
                   or lv.__dict__.get("_dev_offsets") is not None
                   for lv in self.levels)

    def device_stores(self):
        """``(key, store)`` of the layout stores this trie caches for a
        device backend (every cache tag but the host oracle's ``host``),
        in key order."""
        stores = self.__dict__.get("_hybrid_stores") or {}
        return sorted(((k, s) for k, s in stores.items() if k[0] != "host"),
                      key=lambda ks: repr(ks[0]))

    def evict_device(self) -> int:
        """Drop every device-resident cached copy this trie holds.

        Host arrays are untouched; the next query touching the trie
        re-uploads on demand through the identity-keyed caches
        (``upload.levels`` counts it).  Returns the number of cache
        entries dropped — the serve layer's LRU eviction
        (``serve.query.GraphStore``) calls this on the coldest tenant
        when the resident-byte budget is exceeded.
        """
        dropped = 0
        for lv in self.levels:
            for key in ("_dev_values", "_dev_offsets"):
                if lv.__dict__.pop(key, None) is not None:
                    dropped += 1
        if self.__dict__.pop("_dev_annotation", None) is not None:
            dropped += 1
        # the blocked-bitset DIRECTORY uploads (the counting pass's
        # sideways block intersection) hang off the layout stores this
        # trie caches — byte-accurate eviction must drop those too, or
        # an "evicted" tenant would keep device memory pinned
        for store in (self.__dict__.get("_hybrid_stores") or {}).values():
            bs = getattr(store, "bitset", None)
            if bs is not None and bs.__dict__.pop(
                    "_dev_sideways_cache", None) is not None:
                dropped += 1
        # the device layout stores' own copies (CSR, bitset words,
        # directory, index: ``HybridSetStore.dev``), one entry a store —
        # the largest arrays a tenant holds on the card
        for _k, store in self.device_stores():
            if store._dev:
                store._dev.clear()
                dropped += 1
        return dropped


def _parent_of(offsets: np.ndarray, child_idx: np.ndarray) -> np.ndarray:
    """For CSR ``offsets``, the parent id of each child index."""
    return np.searchsorted(offsets, child_idx, side="right") - 1


# --------------------------------------------------------------------- graph
@dataclasses.dataclass
class CSRGraph:
    """Binary-relation fast path: an Edge(x, y) trie flattened over the full
    dictionary-encoded node-id space [0, n) (empty rows allowed).

    ``offsets[u]:offsets[u+1]`` bounds the sorted neighbor set N(u). This is
    the layout the execution engine's vectorized operators consume.
    """

    n: int
    offsets: np.ndarray  # [n+1] int64
    neighbors: np.ndarray  # [m] int32
    annotation: Optional[np.ndarray] = None  # [m] edge annotations

    @property
    def m(self) -> int:
        return int(len(self.neighbors))

    @property
    def degrees(self) -> np.ndarray:
        return np.diff(self.offsets).astype(np.int64)

    @staticmethod
    def from_trie(t: Trie, n: Optional[int] = None) -> "CSRGraph":
        assert t.arity == 2, "CSRGraph is the binary fast path"
        srcs = t.levels[0].values
        seg = t.levels[1].offsets  # [len(srcs)+1]
        if n is None:
            hi = 0
            if len(srcs):
                hi = int(srcs.max()) + 1
            if len(t.levels[1].values):
                hi = max(hi, int(t.levels[1].values.max()) + 1)
            n = hi
        offsets = np.zeros(n + 1, dtype=np.int64)
        counts = np.zeros(n, dtype=np.int64)
        counts[srcs] = np.diff(seg)
        np.cumsum(counts, out=offsets[1:])
        return CSRGraph(n, offsets, t.levels[1].values.copy(),
                        t.annotation.copy() if t.annotation is not None else None)

    @staticmethod
    def from_edges(src, dst, n=None, annotation=None) -> "CSRGraph":
        t = Trie.from_edges("E", np.asarray(src), np.asarray(dst), annotation=annotation)
        return CSRGraph.from_trie(t, n)

    def neighbors_of(self, u: int) -> np.ndarray:
        return self.neighbors[self.offsets[u]:self.offsets[u + 1]]

    def to_trie(self, name: str = "E", attrs=("x", "y")) -> Trie:
        src = np.repeat(np.arange(self.n, dtype=np.int32), self.degrees)
        return Trie.build(name, attrs, [src, self.neighbors], self.annotation)
