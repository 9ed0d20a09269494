"""Port set algebra against the JAX package: the lockstep segment search,
the blocked-bitset build, ``bitset_intersect_count``, the set-pair
kernel ``bitset_pair_count`` (its plain version here),
``intersect_count_uint``, and the Algorithm-3 cohort router
``HybridSetStore.intersect_count`` must give the same counts and the same
cohort counters, on graphs whose pairs reach every cohort route (bitset,
uint x bitset, uint kernel, uint search); and
``HybridSetStore.intersect_materialize`` the same matches, positions and
counters with the materialize kernel injected (its plain version here)
as without it.  The device backend's both-dense count makes one call of
its set-pair kernel and one fetch, with no host block matching."""
import collections

import numpy as np
import pytest
import torch

from repro.core import intersect as jI
from repro.core import layouts as jL
from repro.core.trie import CSRGraph as jCSR
from repro.data.graphs import powerlaw_graph as j_powerlaw
from repro.kernels.bitset_intersect.ops import as_word_kernel
from repro.kernels.bitset_intersect.ops import \
    bitset_pair_count as j_bitset_pair_count
from repro.kernels.materialize.ops import as_materialize_kernel
from repro.kernels.uint_intersect.ops import intersect_count_csr_batched
from repro_torch.core import intersect as tI
from repro_torch.core import layouts as tL
from repro_torch.core.trie import CSRGraph as tCSR
from repro_torch.kernels.bitset_intersect.ops import (bitset_and_popcount,
                                                      bitset_pair_count)
from repro_torch.kernels.materialize.ops import bitset_pair_materialize
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
    np.testing.assert_array_equal(
        tb.card, jI.popcount_u32_np(jb.words).sum(axis=1))


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


def t32(x):
    return torch.as_tensor(np.ascontiguousarray(x, dtype=np.int32))


def pair_count(tb, a, b):
    """The port's set-pair count on the CPU (its plain version)."""
    got = bitset_pair_count(t32(tb.offsets), t32(tb.block_ids),
                            t32(tb.words.view(np.int32)), t32(a), t32(b))
    assert got.dtype == torch.int32
    return got.numpy().astype(np.int64)


def both_bitsets(offsets, neighbors, ids, n):
    return (jI.build_blocked_bitset(offsets, neighbors, ids, n),
            tI.build_blocked_bitset(offsets, neighbors, ids, n))


@pytest.mark.parametrize("name", ["pl300", "pl5000", "hubs"])
def test_bitset_pair_count_matches(name):
    """Equal, exactly, to the reference's ``bitset_pair_count`` (Pallas in
    interpret mode) and ``bitset_intersect_count``, on random slot pairs,
    pairs of a set with itself, and the same pairs shuffled."""
    s, d, n = graph_arrays(name)
    jc = jCSR.from_edges(s, d, n=n)
    ids = np.flatnonzero(np.diff(jc.offsets) > 0)
    jb, tb = both_bitsets(jc.offsets, jc.neighbors, ids, n)
    r = np.random.default_rng(3)
    a = np.concatenate([r.integers(0, len(ids), 500), np.arange(50)])
    b = np.concatenate([r.integers(0, len(ids), 500), np.arange(50)])
    want = np.asarray(j_bitset_pair_count(jb, a, b, interpret=True))
    np.testing.assert_array_equal(want, jI.bitset_intersect_count(jb, a, b))
    np.testing.assert_array_equal(pair_count(tb, a, b), want)
    perm = r.permutation(len(a))
    np.testing.assert_array_equal(pair_count(tb, a[perm], b[perm]),
                                  want[perm])
    # a set with itself: its own size
    np.testing.assert_array_equal(want[500:], np.diff(jc.offsets)[ids[:50]])
    assert want[:500].sum() > 0


def _sets_bitset(sets, n):
    """Both packages' blocked bitsets over explicit sets, slot i = set i."""
    offs = np.concatenate([[0], np.cumsum([len(x) for x in sets])])
    nbr = np.concatenate([np.sort(np.asarray(x, np.int64))
                          for x in sets]).astype(np.int32)
    return both_bitsets(offs, nbr, np.arange(len(sets)), n)


@pytest.mark.parametrize("case", ["a_eq_b", "no_common_block",
                                  "single_block", "empty", "shuffled"])
def test_bitset_pair_count_cases(case):
    """Edge cases against the reference: a set with itself, block lists
    that share no id (sets interleaved block by block), sets of one block
    each, a call with no pair, and pairs in shuffled order."""
    r = np.random.default_rng(4)
    n = 8192
    if case == "no_common_block":
        # even blocks against odd blocks: no common block id, so 0 each
        even = [x for x in range(n) if (x // 256) % 2 == 0]
        odd = [x for x in range(n) if (x // 256) % 2 == 1]
        sets = [r.choice(even, 300, replace=False),
                r.choice(odd, 300, replace=False)] * 2
    elif case == "single_block":
        sets = [256 * (i % 4) + r.choice(256, int(r.integers(1, 200)),
                                         replace=False) for i in range(12)]
    else:
        sets = [r.choice(n, int(r.integers(1, 2000)), replace=False)
                for _ in range(12)]
    jb, tb = _sets_bitset(sets, n)
    k = len(sets)
    if case == "a_eq_b":
        a = b = np.arange(k)
    elif case == "empty":
        a = b = np.zeros(0, np.int64)
    elif case == "no_common_block":
        a, b = np.array([0, 1, 0, 2]), np.array([1, 0, 3, 3])
    else:
        a, b = np.repeat(np.arange(k), k), np.tile(np.arange(k), k)
    if case == "shuffled":
        perm = r.permutation(len(a))
        a, b = a[perm], b[perm]
    want = (np.asarray(j_bitset_pair_count(jb, a, b, interpret=True))
            if len(a) else np.zeros(0, np.int64))
    got = pair_count(tb, a, b)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jI.bitset_intersect_count(jb, a, b))
    truth = [len(np.intersect1d(sets[i], sets[j])) for i, j in zip(a, b)]
    np.testing.assert_array_equal(got, truth)
    if case == "a_eq_b":
        np.testing.assert_array_equal(got, [len(x) for x in sets])
    if case == "no_common_block":
        np.testing.assert_array_equal(got, [0, 0, 0, 0])
    if case == "single_block":
        assert (np.diff(tb.offsets) == 1).all()


class _NumpyWithoutAddAt:
    """``numpy`` with ``np.add.at`` raising: a module stand-in."""

    class _Add:
        def __call__(self, *args, **kwargs):
            return np.add(*args, **kwargs)

        def __getattr__(self, name):
            return getattr(np.add, name)

        @staticmethod
        def at(*args, **kwargs):
            raise AssertionError("np.add.at called")

    add = _Add()

    def __getattr__(self, name):
        return getattr(np, name)


def test_device_store_dense_count_has_no_host_matching(monkeypatch):
    """The device backend's both-dense count: one call of the injected
    set-pair kernel and one ``host_get`` of its P counts, with no
    ``intersect_pairs_uint`` and no ``np.add.at``; counts and counter
    equal to the reference store's."""
    from repro.core.trie import Trie as jTrie
    from repro_torch.core.backend import DeviceBackend
    from repro_torch.core.trie import Trie as tTrie
    from repro_torch.kernels.bitset_intersect import ops as bitset_ops

    s, d, n = graph_arrays("pl300")
    calls, fetches = [], []
    monkeypatch.setattr(
        bitset_ops, "bitset_pair_count",
        lambda *args: calls.append(int(args[3].shape[0]))
        or bitset_pair_count(*args))
    store = DeviceBackend(device="cpu")._pair_store(
        tTrie.from_edges("E", s, d))
    js = jL.engine_store_for(jTrie.from_edges("E", s, d),
                             word_kernel=as_word_kernel(True))
    slot = store.bitset.slot_of
    u, v = pairs_of(s, d, n)
    dense = (slot[u] >= 0) & (slot[v] >= 0)
    u, v = u[dense], v[dense]
    assert len(u) > 100

    def forbidden(*args, **kwargs):
        raise AssertionError("host block matching called")

    def counted_get(x):
        fetches.append(tuple(x.shape))
        return tI.host_get(x)

    monkeypatch.setattr(tI, "intersect_pairs_uint", forbidden)
    monkeypatch.setattr(tI, "np", _NumpyWithoutAddAt())
    monkeypatch.setattr(tL, "np", _NumpyWithoutAddAt())
    monkeypatch.setattr(tL, "host_get", counted_get)
    store.counter, js.counter = (collections.Counter(),
                                 collections.Counter())
    got = store.intersect_count(u, v)
    np.testing.assert_array_equal(got, js.intersect_count(u, v))
    assert calls == [len(u)]
    assert fetches == [(len(u),)]
    assert dict(store.counter) == dict(js.counter) == {
        "intersect.bitset_kernel": len(u)}


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
        tc, "cpu", threshold=threshold, pair_kernel=bitset_pair_count,
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


@pytest.mark.parametrize("name,threshold", [
    ("pl300", None), ("pl5000", None), ("hubs", 256.0)])
@pytest.mark.parametrize("injected", [True, False])
def test_hybrid_store_materialize_matches(name, threshold, injected):
    """Dense x dense pairs through the injected kernel (or the host
    extraction), the rest through the search path, merged back into the
    canonical pair-major order: equal to the JAX store's, with its
    ``intersect.materialize_*`` counters."""
    s, d, n = graph_arrays(name)
    jc, tc = jCSR.from_edges(s, d, n=n), tCSR.from_edges(s, d, n=n)
    if threshold is None:
        from repro.core.statistics import layout_threshold_for
        from repro.core.trie import Trie
        threshold = layout_threshold_for(Trie.from_edges("E", s, d))
    js = jL.HybridSetStore.build(
        jc, threshold=threshold,
        materialize_kernel=as_materialize_kernel(True) if injected else None)
    ts = tL.HybridSetStore.build(
        tc, "cpu", threshold=threshold,
        materialize_kernel=bitset_pair_materialize if injected else None)
    js.counter, ts.counter = collections.Counter(), collections.Counter()
    u, v = pairs_of(s, d, n)
    want = js.intersect_materialize(u, v)
    got = ts.intersect_materialize(u, v)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert dict(ts.counter) == dict(js.counter)
    dense = ("intersect.materialize_kernel" if injected
             else "intersect.materialize_bitset")
    assert ts.counter[dense] > 0
    if threshold == 256.0:
        assert ts.counter["intersect.materialize_uint"] > 0
