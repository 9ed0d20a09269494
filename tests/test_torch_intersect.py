"""Port set algebra against the JAX package: the lockstep segment search,
the blocked-bitset build, ``bitset_intersect_count``,
``intersect_count_uint``, and the Algorithm-3 cohort router
``HybridSetStore.intersect_count`` must give the same counts and the same
cohort counters, on graphs whose pairs reach every cohort route (bitset,
uint x bitset, uint kernel, uint search)."""
import collections

import numpy as np
import pytest
import torch

from repro.core import intersect as jI
from repro.core import layouts as jL
from repro.core.trie import CSRGraph as jCSR
from repro.data.graphs import powerlaw_graph as j_powerlaw
from repro.kernels.bitset_intersect.ops import as_word_kernel
from repro.kernels.uint_intersect.ops import intersect_count_csr_batched
from repro_torch.core import intersect as tI
from repro_torch.core import layouts as tL
from repro_torch.core.trie import CSRGraph as tCSR
from repro_torch.kernels.bitset_intersect.ops import bitset_and_popcount
from repro_torch.kernels.uint_intersect.ops import intersect_count_csr

ROUTE_KEYS = ("intersect.bitset_kernel", "intersect.uint_bitset",
              "intersect.uint_kernel", "intersect.uint_search")


def hub_graph(seed=0, n=100_000, hubs=6):
    """Sparse random edges plus a few hubs whose ~300 neighbours spread
    over an id range of 100k (range/|S| > 256): at a 256-bit threshold
    the hubs stay in the uint cohort with sets longer than the uint
    kernel's 256 — the pairs among them take the lockstep search."""
    r = np.random.default_rng(seed)
    src = r.integers(0, n, 1500)
    dst = r.integers(0, n, 1500)
    for h in range(hubs):
        nb = r.choice(n, size=300 + 20 * h, replace=False)
        src = np.concatenate([src, np.full(len(nb), h), np.arange(hubs)])
        dst = np.concatenate([dst, nb, np.full(hubs, h)])
    keep = src != dst
    s = np.concatenate([src[keep], dst[keep]])
    d = np.concatenate([dst[keep], src[keep]])
    return s, d, n


def graph_arrays(name):
    if name == "hubs":
        s, d, n = hub_graph()
    else:
        n, deg, exp = {"pl300": (300, 8, 2.0), "pl5000": (5000, 3, 2.5)}[name]
        g = j_powerlaw(n, deg, exp, seed=0)
        s = np.repeat(np.arange(g.n), np.diff(g.offsets))
        d = g.neighbors
    return s, d, n


def pairs_of(s, d, n):
    r = np.random.default_rng(1)
    extra = r.integers(0, n, size=(2, 500))
    u = np.concatenate([s, extra[0], np.arange(6).repeat(6)])
    v = np.concatenate([d, extra[1], np.tile(np.arange(6), 6)])
    return u.astype(np.int64), v.astype(np.int64)


def test_segment_searchsorted_matches():
    r = np.random.default_rng(0)
    values = np.sort(r.integers(0, 500, 400)).astype(np.int32)
    lo = r.integers(0, 400, 1000)
    hi = np.minimum(lo + r.integers(-3, 80, 1000), 400)
    q = r.integers(-5, 505, 1000).astype(np.int32)
    jp, jf = jI.segment_searchsorted(values, lo, hi, q)
    tp, tf = tI.segment_searchsorted(torch.from_numpy(values), lo, hi, q)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    assert tp.dtype == torch.int32


@pytest.mark.parametrize("name", ["pl300", "pl5000"])
def test_blocked_bitset_build_matches(name):
    s, d, n = graph_arrays(name)
    jc, tc = jCSR.from_edges(s, d, n=n), tCSR.from_edges(s, d, n=n)
    ids = np.flatnonzero(np.diff(jc.offsets) > 2)
    jb = jI.build_blocked_bitset(jc.offsets, jc.neighbors, ids, n)
    tb = tI.build_blocked_bitset(tc.offsets, tc.neighbors, ids, n)
    for f in ("set_ids", "offsets", "block_ids", "words", "index",
              "slot_of"):
        np.testing.assert_array_equal(getattr(tb, f), getattr(jb, f))


@pytest.mark.parametrize("name", ["pl300", "pl5000"])
def test_bitset_intersect_count_matches(name):
    s, d, n = graph_arrays(name)
    jc, tc = jCSR.from_edges(s, d, n=n), tCSR.from_edges(s, d, n=n)
    ids = np.flatnonzero(np.diff(jc.offsets) > 0)
    jb = jI.build_blocked_bitset(jc.offsets, jc.neighbors, ids, n)
    tb = tI.build_blocked_bitset(tc.offsets, tc.neighbors, ids, n)
    r = np.random.default_rng(2)
    a = r.integers(0, len(ids), 600)
    b = r.integers(0, len(ids), 600)
    want = jI.bitset_intersect_count(jb, a, b, as_word_kernel(True))
    got = tI.bitset_intersect_count(
        tb, a, b, bitset_and_popcount, torch.from_numpy(tb.block_ids),
        torch.from_numpy(tb.words.view(np.int32)))
    np.testing.assert_array_equal(got, want)
    assert want.sum() > 0


@pytest.mark.parametrize("name", ["pl300", "hubs"])
def test_intersect_count_uint_matches(name):
    s, d, n = graph_arrays(name)
    jc, tc = jCSR.from_edges(s, d, n=n), tCSR.from_edges(s, d, n=n)
    u, v = pairs_of(s, d, n)
    want = jI.intersect_count_uint(jc.offsets, jc.neighbors, u, v)
    got = tI.intersect_count_uint(tc.offsets, tc.neighbors, u, v,
                                  torch.from_numpy(tc.neighbors))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got[:50], jI.intersect_count_uint_np(jc.offsets, jc.neighbors,
                                             u[:50], v[:50]))


@pytest.mark.parametrize("name,threshold", [
    ("pl300", None), ("pl5000", None), ("hubs", 256.0), ("hubs", 4096.0)])
def test_hybrid_store_routes_and_counts_match(name, threshold):
    s, d, n = graph_arrays(name)
    jc, tc = jCSR.from_edges(s, d, n=n), tCSR.from_edges(s, d, n=n)
    if threshold is None:
        from repro.core.statistics import layout_threshold_for
        from repro.core.trie import Trie
        threshold = layout_threshold_for(Trie.from_edges("E", s, d))
    js = jL.HybridSetStore.build(
        jc, threshold=threshold, word_kernel=as_word_kernel(True),
        uint_kernel=lambda o, nb, a, b: intersect_count_csr_batched(
            o, nb, a, b, interpret=True, max_len=256))
    ts = tL.HybridSetStore.build(
        tc, "cpu", threshold=threshold, word_kernel=bitset_and_popcount,
        uint_kernel=intersect_count_csr)
    js.counter, ts.counter = collections.Counter(), collections.Counter()
    u, v = pairs_of(s, d, n)
    want = js.intersect_count(u, v)
    got = ts.intersect_count(u, v)
    np.testing.assert_array_equal(got, want)
    for k in ROUTE_KEYS:
        assert ts.counter.get(k, 0) == js.counter.get(k, 0), k
    routes = {k for k in ROUTE_KEYS if js.counter.get(k, 0)}
    assert "intersect.bitset_kernel" in routes
    if name == "pl5000":
        assert "intersect.uint_kernel" in routes
    if threshold == 256.0:
        assert {"intersect.uint_search", "intersect.uint_kernel",
                "intersect.uint_bitset"} <= routes
