"""Set-layout selection (paper Section 4.1/4.3/4.4, Algorithm 3).

Counterpart of ``repro.core.layouts``.  EmptyHeaded chooses, **per set**,
between the ``uint`` layout (sorted 32-bit array) and the ``bitset``
layout (offset + bitvector blocks), using the rule of Algorithm 3::

    inverse_density = S.range / |S|
    bitset  if inverse_density < threshold else uint

The decision is executed at batch granularity: sets are partitioned into
a **dense cohort** (rendered into the blocked-bitset layout) and a
**sparse cohort** (kept in CSR/uint), and each pairwise intersection is
routed to the (bitset×bitset | uint×bitset | uint×uint) path by cohort
membership.  The threshold is the plan IR's statistics-driven value.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.core import intersect as I
from repro_torch.core import statistics
from repro_torch.core.trie import CSRGraph
from repro_torch.kernels.bitset_intersect.ref import bitset_and_popcount_ref
from repro_torch.kernels.common import host_get

# Paper default: the width of an AVX register (256 bits).
SIMD_REGISTER_BITS = 256


@dataclasses.dataclass
class LayoutDecision:
    """Outcome of the set-level optimizer over a CSR adjacency."""

    dense_ids: np.ndarray    # node ids whose sets use the bitset layout
    sparse_ids: np.ndarray   # node ids whose sets stay uint
    inverse_density: np.ndarray  # per-node range/|S| (inf for empty)
    threshold: float


def set_ranges(csr: CSRGraph) -> np.ndarray:
    """Per-set value range (max - min + 1); 0 for empty sets."""
    n = csr.n
    deg = csr.degrees
    lo = np.zeros(n, dtype=np.int64)
    hi = np.zeros(n, dtype=np.int64)
    nz = deg > 0
    starts = csr.offsets[:-1][nz]
    ends = csr.offsets[1:][nz] - 1
    lo[nz] = csr.neighbors[starts]
    hi[nz] = csr.neighbors[ends]
    rng = np.zeros(n, dtype=np.int64)
    rng[nz] = hi[nz] - lo[nz] + 1
    return rng


def decide_set_level(csr: CSRGraph, threshold: float = SIMD_REGISTER_BITS) -> LayoutDecision:
    """Algorithm 3, applied to every set of the relation."""
    deg = csr.degrees
    rng = set_ranges(csr)
    inv = np.full(csr.n, np.inf)
    nz = deg > 0
    inv[nz] = rng[nz] / deg[nz]
    dense = nz & (inv < threshold)
    return LayoutDecision(
        dense_ids=np.flatnonzero(dense).astype(np.int64),
        sparse_ids=np.flatnonzero(nz & ~dense).astype(np.int64),
        inverse_density=inv,
        threshold=threshold,
    )


# ----------------------------------------------------------- engine routing
def engine_store_for(trie, *, device: torch.device,
                     word_kernel: Optional[Callable] = None,
                     uint_kernel: Optional[Callable] = None,
                     uint_max_len: int = 256,
                     counter=None,
                     cache_tag: str = "host",
                     threshold: Optional[float] = None,
                     ) -> "HybridSetStore":
    """Per-trie cached HybridSetStore for the engine's binary terminal
    folds (built lazily on first use; index build time is excluded from
    query timing, as in the paper).

    ``threshold`` is the Algorithm-3 density threshold the plan IR
    passes from its TerminalFold annotation; when None, the same
    statistics profile is computed here
    (``statistics.layout_threshold_for``).  The threshold used is
    recorded in the dispatch counters (``layout.threshold_bits`` /
    ``layout.stats_driven``).

    Stores are cached per (cache_tag, threshold) so the host and device
    backends — which inject different intersection kernels and keep
    their arrays on different devices — each keep their own index on the
    same trie.  ``counter`` is rebound on every call so dispatch
    instrumentation always lands on the calling backend.
    """
    if threshold is None:
        threshold = statistics.layout_threshold_for(trie)
    thr_key = int(round(threshold))
    cache = getattr(trie, "_hybrid_stores", None)
    if cache is None:
        cache = trie._hybrid_stores = {}
    key = (cache_tag, thr_key)
    store = cache.get(key)
    if store is None:
        csr = CSRGraph.from_trie(trie)
        store = HybridSetStore.build(csr, device, threshold=threshold,
                                     word_kernel=word_kernel,
                                     uint_kernel=uint_kernel,
                                     uint_max_len=uint_max_len)
        cache[key] = store
    if counter is not None:
        counter["layout.stats_driven"] += 1
        counter["layout.threshold_bits"] = thr_key
    store.counter = counter
    return store


@dataclasses.dataclass
class HybridSetStore:
    """The execution-engine view of one relation's second trie level:
    CSR for the sparse cohort + blocked bitset for the dense cohort, with a
    router that dispatches pairwise intersections to the right kernel.
    Host arrays are the routing index; the arrays the intersections read
    are uploaded once to ``device`` and cached here.
    """

    csr: CSRGraph
    decision: LayoutDecision
    bitset: Optional[I.BlockedBitset]
    device: torch.device
    # injected word-AND-popcount (the CUDA kernel's wrapper); None -> the
    # plain PyTorch version
    word_kernel: Optional[Callable] = None
    # injected batched uint∩uint kernel ((offsets, neighbors, u, v) int32
    # device tensors -> counts) for short pairs; None -> lockstep search
    uint_kernel: Optional[Callable] = None
    # pairs whose larger set exceeds this stay on the search path
    uint_max_len: int = 256
    # Counter-like sink recording which kernel handled each pair
    counter: Optional[object] = None
    _dev: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)

    @staticmethod
    def build(csr: CSRGraph, device, threshold: float = SIMD_REGISTER_BITS,
              block_bits: int = SIMD_REGISTER_BITS,
              word_kernel: Optional[Callable] = None,
              uint_kernel: Optional[Callable] = None,
              uint_max_len: int = 256) -> "HybridSetStore":
        d = decide_set_level(csr, threshold)
        bs = None
        if len(d.dense_ids):
            bs = I.build_blocked_bitset(csr.offsets, csr.neighbors,
                                        d.dense_ids, csr.n, block_bits)
        return HybridSetStore(csr, d, bs, torch.device(device), word_kernel,
                              uint_kernel, uint_max_len)

    def _bump(self, key: str, n: int):
        if self.counter is not None:
            self.counter[key] += n

    def dev(self, name: str) -> torch.Tensor:
        """Device copy (int32) of one of the store's arrays, uploaded on
        first use: ``neighbors``/``offsets`` of the CSR, ``block_ids`` and
        ``words`` (the int32 view of the uint32 blocks) of the bitset."""
        t = self._dev.get(name)
        if t is None:
            src = {"neighbors": lambda: self.csr.neighbors,
                   "offsets": lambda: self.csr.offsets,
                   "block_ids": lambda: self.bitset.block_ids,
                   "words": lambda: self.bitset.words.view(np.int32)}[name]()
            t = torch.as_tensor(np.ascontiguousarray(src, dtype=np.int32),
                                device=self.device)
            self._dev[name] = t
        return t

    # ------------------------------------------------------------- dispatch
    def intersect_count(self, u: np.ndarray, v: np.ndarray) -> np.ndarray:
        """|N(u_i) ∩ N(v_i)| routed per-pair by the cohort of each endpoint.

        Routing: both dense -> bitset∩bitset; one dense -> uint∩bitset
        (probe the sparse side into the dense side — min property); both
        sparse -> uint kernel or lockstep search.
        """
        u = np.asarray(u, dtype=np.int64)
        v = np.asarray(v, dtype=np.int64)
        out = np.zeros(len(u), dtype=np.int64)
        if len(u) == 0:
            return out
        if self.bitset is None:
            return self._sparse_count(u, v)
        slot = self.bitset.slot_of
        ud = slot[u] >= 0
        vd = slot[v] >= 0

        both_d = ud & vd
        if both_d.any():
            idx = np.flatnonzero(both_d)
            out[idx] = I.bitset_intersect_count(
                self.bitset, slot[u[idx]], slot[v[idx]],
                self.word_kernel or bitset_and_popcount_ref,
                self.dev("block_ids"), self.dev("words"))
            self._bump("intersect.bitset_kernel" if self.word_kernel
                       else "intersect.bitset_plain", len(idx))

        mixed = ud ^ vd
        if mixed.any():
            idx = np.flatnonzero(mixed)
            uu, vv = u[idx], v[idx]
            sparse_side = np.where(ud[idx], vv, uu)
            dense_side = np.where(ud[idx], uu, vv)
            out[idx] = I.uint_bitset_intersect_count(
                self.csr.offsets, self.csr.neighbors, sparse_side,
                self.bitset, slot[dense_side], self.dev("block_ids"))
            self._bump("intersect.uint_bitset", len(idx))

        both_s = ~(ud | vd)
        if both_s.any():
            idx = np.flatnonzero(both_s)
            out[idx] = self._sparse_count(u[idx], v[idx])
        return out

    def _sparse_count(self, u: np.ndarray, v: np.ndarray) -> np.ndarray:
        """uint∩uint cohort: Algorithm 2's regime split — short
        similar-cardinality pairs take the uint kernel when one is
        injected, long/skewed pairs the lockstep binary search."""
        if self.uint_kernel is not None:
            deg = self.csr.degrees
            short = np.maximum(deg[u], deg[v]) <= self.uint_max_len
            out = np.zeros(len(u), dtype=np.int64)
            if short.any():
                idx = np.flatnonzero(short)
                counts = self.uint_kernel(
                    self.dev("offsets"), self.dev("neighbors"),
                    torch.as_tensor(u[idx].astype(np.int32),
                                    device=self.device),
                    torch.as_tensor(v[idx].astype(np.int32),
                                    device=self.device))
                out[idx] = host_get(counts)
                self._bump("intersect.uint_kernel", len(idx))
            if not short.all():
                idx = np.flatnonzero(~short)
                out[idx] = I.intersect_count_uint(
                    self.csr.offsets, self.csr.neighbors, u[idx], v[idx],
                    self.dev("neighbors"))
                self._bump("intersect.uint_search", len(idx))
            return out
        self._bump("intersect.uint_search", len(u))
        return I.intersect_count_uint(self.csr.offsets, self.csr.neighbors,
                                      u, v, self.dev("neighbors"))

    def intersect_materialize(self, u: np.ndarray, v: np.ndarray):
        """Materializing intersection, cohort-routed like
        ``intersect_count``: dense×dense pairs extract matches from the
        blocked bitset on the host (positions from the per-block
        ``index``), every other cohort takes the uint search path.
        Returns ``(pair_id, value, pos_u, pos_v)`` — positions are
        absolute indices into ``csr.neighbors``.  Pair counts land in
        ``intersect.materialize_{bitset,uint}``.
        """
        u = np.asarray(u, np.int64)
        v = np.asarray(v, np.int64)
        if self.bitset is None:
            self._bump("intersect.materialize_uint", len(u))
            return I.intersect_pairs_uint(self.csr.offsets,
                                          self.csr.neighbors, u, v,
                                          self.dev("neighbors"))
        slot = self.bitset.slot_of
        both_dense = (slot[u] >= 0) & (slot[v] >= 0)
        if both_dense.all():
            self._bump("intersect.materialize_bitset", len(u))
            pid, vals, ra, rb = I.bitset_intersect_materialize(
                self.bitset, slot[u], slot[v], self.dev("block_ids"))
            return (pid, vals,
                    self.csr.offsets[u[pid]] + ra,
                    self.csr.offsets[v[pid]] + rb)
        di = np.flatnonzero(both_dense)
        si = np.flatnonzero(~both_dense)
        self._bump("intersect.materialize_bitset", len(di))
        self._bump("intersect.materialize_uint", len(si))
        pid_d, vals_d, ra, rb = I.bitset_intersect_materialize(
            self.bitset, slot[u[di]], slot[v[di]], self.dev("block_ids"))
        pos_u_d = self.csr.offsets[u[di][pid_d]] + ra
        pos_v_d = self.csr.offsets[v[di][pid_d]] + rb
        pid_s, vals_s, pu_s, pv_s = I.intersect_pairs_uint(
            self.csr.offsets, self.csr.neighbors, u[si], v[si],
            self.dev("neighbors"))
        pair_id = np.concatenate([di[pid_d], si[pid_s]])
        vals = np.concatenate([vals_d, vals_s])
        pos_u = np.concatenate([pos_u_d, pu_s])
        pos_v = np.concatenate([pos_v_d, pv_s])
        # restore the canonical expansion order (pair-major, values
        # ascending within a pair) the search path produces
        order = np.lexsort((vals, pair_id))
        return pair_id[order], vals[order], pos_u[order], pos_v[order]
