"""The relational serving path of the port against the JAX package's:
prepared queries re-bound through ``PreparedQuery.run_batch`` (the
batched bag program, each fill and fold step one batched launch) and the
sequential loop, ``QueryServer`` admission and draining, tenant
isolation and LRU eviction.  The port runs ``Engine(backend="device",
device="cpu")`` (every kernel's plain version), the reference
``Engine(backend="device")`` (Pallas in interpret mode).  Answers are
integer and equal exactly; so are the whole dispatch summaries."""
import numpy as np
import pytest

import repro.core.statistics as j_stats
import repro_torch.core.statistics as t_stats
from repro.core.engine import Engine as JEngine
from repro.data.graphs import powerlaw_graph
from repro.serve import QueryServer as JQueryServer
from repro_torch.core.engine import Engine as TEngine
from repro_torch.core.executor import BagResultCache
from repro_torch.core.trie import Trie
from repro_torch.serve import QueryServer

from conftest import random_undirected_graph

# the parameterized Table 2 pattern queries of the reference's serving
# tests, anchored at a bind-parameter vertex
PARAM_QUERIES = [
    ("triangle_at",
     "C(;w:long) :- R(0,y),S(y,z),T(0,z); w=<<COUNT(*)>>."),
    ("triangle_list_at",
     "L(y,z) :- R(0,y),S(y,z),T(0,z)."),
    ("4clique_at",
     "C(;w:long) :- R(0,y),S(y,z),T(0,z),U(0,a),X(y,a),Y(z,a); "
     "w=<<COUNT(*)>>."),
    ("lollipop_at",
     "C(;w:long) :- R(0,y),S(y,z),T(0,z),U(0,a); w=<<COUNT(*)>>."),
    ("barbell_at",
     "C(;w:long) :- R(0,y),S(y,z),T(0,z),U(0,a),R2(a,b),S2(b,c),T2(a,c); "
     "w=<<COUNT(*)>>."),
]
ALIASES = ("S", "T", "U", "X", "Y", "R2", "S2", "T2")
BINDINGS = [0, 1, 2, 5, 1]
QIDS = [n for n, _ in PARAM_QUERIES]


def load(eng, src, dst):
    eng.load_edges("R", src, dst)
    for al in ALIASES:
        eng.alias(al, "R")
    return eng


def engines(src, dst):
    """(port, reference) device engines over the same edges."""
    return (load(TEngine(backend="device", device="cpu"), src, dst),
            load(JEngine(backend="device"), src, dst))


def small_graph(seed=0):
    src, dst, _ = random_undirected_graph(24, 0.3, seed=seed)
    return src, dst


def hub_graph():
    """A power-law graph and its 4 highest-degree vertices: batches of
    hub bindings outgrow the statistics' frontier estimates, so the
    reference's own batched run overflows and retries."""
    g = powerlaw_graph(300, 8, 2.0, seed=0)
    src = np.repeat(np.arange(g.n), np.diff(g.offsets))
    hubs = np.argsort(-np.diff(g.offsets), kind="stable")[:4]
    return src, g.neighbors, [int(h) for h in hubs]


def assert_same_result(a, b):
    assert a.vars == b.vars
    for v in a.vars:
        np.testing.assert_array_equal(np.asarray(a.columns[v]),
                                      np.asarray(b.columns[v]))
    if b.annotation is None:
        assert a.annotation is None
    else:
        np.testing.assert_array_equal(np.asarray(a.annotation),
                                      np.asarray(b.annotation))


def delta(stats, before):
    return {k: stats.get(k, 0) - before.get(k, 0) for k in stats
            if stats.get(k, 0) != before.get(k, 0)}


# ------------------------------------------------- batched vs sequential
@pytest.mark.parametrize("backend", ("device", "numpy"))
@pytest.mark.parametrize("qname,query", PARAM_QUERIES, ids=QIDS)
def test_batched_equals_sequential_and_reference(backend, qname, query):
    src, dst = small_graph()
    kw = {"device": "cpu"} if backend == "device" else {}
    te = load(TEngine(backend=backend, **kw), src, dst)
    je = load(JEngine(backend=backend), src, dst)
    tpq, jpq = te.prepare(query), je.prepare(query)
    assert tpq.n_params == jpq.n_params == 1
    batched = tpq.run_batch(BINDINGS)
    want = jpq.run_batch(BINDINGS)
    sequential = [tpq.run(b) for b in BINDINGS]
    assert len(batched) == len(BINDINGS)
    for got, seq, ref in zip(batched, sequential, want):
        assert_same_result(got, seq)
        assert_same_result(got, ref)


@pytest.mark.parametrize("qname,query", PARAM_QUERIES, ids=QIDS)
def test_batch_dispatch_summary_equals_reference(qname, query):
    """The whole summary after a batch: which queries batch (triangle,
    listing and 4-clique do; lollipop and barbell take the sequential
    loop), their launches, folds, closing syncs and fill chunks."""
    te, je = engines(*small_graph())
    for eng in (te, je):
        eng.prepare(query).run_batch(BINDINGS)
    td, jd = te.dispatch_summary(), je.dispatch_summary()
    assert td == jd
    batched = qname in ("triangle_at", "triangle_list_at", "4clique_at")
    assert (td.get("pipeline.batched_launches", 0) > 0) == batched


def test_missing_vertex_degenerates_out_of_the_batch():
    te, je = engines(*small_graph())
    bindings = [1, 10_000, 2]   # 10_000 is not a vertex
    tpq, jpq = te.prepare(PARAM_QUERIES[0][1]), je.prepare(PARAM_QUERIES[0][1])
    got, want = tpq.run_batch(bindings), jpq.run_batch(bindings)
    assert te.dispatch_summary() == je.dispatch_summary()
    for g, w, s in zip(got, want, [tpq.run(b) for b in bindings]):
        assert_same_result(g, w)
        assert_same_result(g, s)
    assert int(np.asarray(got[1].scalar())) == 0


def test_batch_is_one_launch():
    te, _je = engines(*small_graph())
    pq = te.prepare(PARAM_QUERIES[0][1])
    pq.run(0)   # warm: plan
    before = dict(te.backend.stats)
    pq.run_batch([0, 1, 2, 3])
    d = delta(te.backend.stats, before)
    assert d["pipeline.batched_launches"] == 1
    assert d["pipeline.batched_queries"] == 4
    assert d["pipeline.launches"] == 1
    # one batched launch = one closing sync for the whole batch
    assert d["extend.closing_syncs"] == 1
    assert d.get("compile.plan_searches", 0) == 0


@pytest.mark.parametrize("qname,query", PARAM_QUERIES[:3], ids=QIDS[:3])
def test_batch_split_into_chunks(monkeypatch, qname, query):
    """``max_batch`` patched to 2 in both packages: five bindings run as
    three batched launches, read through the module at call time."""
    monkeypatch.setattr(t_stats, "max_batch", lambda cap, *a, **k: 2)
    monkeypatch.setattr(j_stats, "max_batch", lambda cap, *a, **k: 2)
    te, je = engines(*small_graph())
    got = te.prepare(query).run_batch(BINDINGS)
    want = je.prepare(query).run_batch(BINDINGS)
    for g, w in zip(got, want):
        assert_same_result(g, w)
    td, jd = te.dispatch_summary(), je.dispatch_summary()
    assert td == jd
    assert td["pipeline.batched_launches"] >= 3
    assert td["pipeline.batched_queries"] >= len(BINDINGS)


@pytest.mark.parametrize("qname,query", PARAM_QUERIES[:3], ids=QIDS[:3])
def test_batch_overflow_retry(qname, query):
    """Hub bindings outgrow the estimated buffers: the reference's batch
    overflows and retries at measured capacities, and so does the port's,
    counter for counter; the measurement lands in ``cap_feedback``."""
    src, dst, hubs = hub_graph()
    te, je = engines(src, dst)
    got = te.prepare(query).run_batch(hubs)
    want = je.prepare(query).run_batch(hubs)
    for g, w in zip(got, want):
        assert_same_result(g, w)
    td, jd = te.dispatch_summary(), je.dispatch_summary()
    assert td == jd
    assert td["pipeline.retries"] > 0
    assert td["pipeline.batched_launches"] == 1 + td["pipeline.retries"]
    assert te.backend.cap_feedback == {
        k: v for k, v in je.backend.cap_feedback.items()}
    # the same batch again sizes its buffers from the feedback
    before = dict(te.backend.stats)
    again = te.prepare(query).run_batch(hubs)
    for g, w in zip(again, want):
        assert_same_result(g, w)
    assert delta(te.backend.stats, before).get("pipeline.retries", 0) == 0


@pytest.mark.parametrize("qname,query",
                         [PARAM_QUERIES[0], PARAM_QUERIES[2]],
                         ids=[QIDS[0], QIDS[2]])
def test_batch_over_anchors_of_different_degree(qname, query):
    """One batch anchored at vertices from the hub (degree 138) down to
    degree 2 and an isolated vertex, so each query's shared probe segment
    (the anchor's adjacency) ranges from empty to the hub's: answers and
    the whole dispatch summary equal the reference's, and each answer the
    sequential one."""
    g = powerlaw_graph(300, 8, 2.0, seed=1)
    src = np.repeat(np.arange(g.n), np.diff(g.offsets))
    deg = np.diff(g.offsets)
    order = np.argsort(-deg, kind="stable")
    bindings = [int(order[i]) for i in (0, 3, 20, 80, 200)]
    bindings.append(int(order[-1]))
    assert deg[bindings[0]] >= 10 * max(1, deg[bindings[-2]])
    te, je = engines(src, g.neighbors)
    tpq, jpq = te.prepare(query), je.prepare(query)
    got, want = tpq.run_batch(bindings), jpq.run_batch(bindings)
    assert te.dispatch_summary() == je.dispatch_summary()
    assert te.dispatch_summary()["pipeline.batched_launches"] >= 1
    for gq, wq, b in zip(got, want, bindings):
        assert_same_result(gq, wq)
        assert_same_result(gq, tpq.run(b))


def test_rebind_zero_recompile():
    te, _ = engines(*small_graph())
    pq = te.prepare(PARAM_QUERIES[0][1])
    pq.run(1)
    before = dict(te.backend.stats)
    for v in (2, 3, 5, 2):
        pq.run(v)
    pq.run_batch([2, 3, 5])
    d = delta(te.backend.stats, before)
    for key in ("compile.plan_searches", "compile.logical_compiles",
                "compile.physical_builds"):
        assert d.get(key, 0) == 0, key
    assert d["compile.plan_cache_hits"] >= 5
    assert d["compile.physical_cache_hits"] >= 5


# -------------------------------------------------------- query server
@pytest.mark.parametrize("backend", ("device", "numpy"))
def test_query_server_drain_parity(backend):
    kw = {"device": "cpu"} if backend == "device" else {}
    srv, jsrv = QueryServer(backend=backend, **kw), JQueryServer(
        backend=backend)
    src, dst, _ = random_undirected_graph(24, 0.3, seed=1)
    for s in (srv, jsrv):
        s.load_graph("acme", "R", src, dst)
        for al in ALIASES:
            s.alias("acme", al, "R")
    q = PARAM_QUERIES[0][1]
    tickets = [srv.submit("acme", q, v) for v in (0, 1, 2, 3)]
    jtickets = [jsrv.submit("acme", q, v) for v in (0, 1, 2, 3)]
    assert srv.pending() == 4
    srv.drain()
    jsrv.drain()
    assert srv.pending() == 0
    pq = srv.prepare("acme", q)
    for t, jt, v in zip(tickets, jtickets, (0, 1, 2, 3)):
        assert t.done and t.params == (v,)
        assert_same_result(t.result, jt.result)
        assert_same_result(t.result, pq.run(v))
    assert srv.counters == jsrv.counters
    assert srv.counters["tenant.acme.queries"] == 4
    assert srv.counters["tenant.acme.batches"] == 1
    assert srv.counters["queue.admitted"] == 4
    assert srv.counters["queue.drained"] == 4


def test_query_server_tenant_isolation():
    srv = QueryServer(backend="numpy")
    srv.load_graph("a", "R", np.array([0, 1]), np.array([1, 2]))
    srv.load_graph("b", "R", np.array([5, 6]), np.array([6, 7]))
    ra = srv.run("a", "P(x,y) :- R(x,y).")
    rb = srv.run("b", "P(x,y) :- R(x,y).")
    assert set(ra.columns["x"].tolist()) == {0, 1}
    assert set(rb.columns["x"].tolist()) == {5, 6}
    # one shared backend instance across tenants
    assert srv.engine("a").backend is srv.engine("b").backend


# ------------------------------------------------------------- eviction
def _force_resident(srv, tenant, name="R"):
    """Backend-agnostic device-cache fill through the identity-keyed
    upload caches."""
    t = srv.engine(tenant).catalog.get(name)
    for lv in t.levels:
        lv.device_values(np.asarray)
        lv.device_offsets(np.asarray)
    return t


def test_graph_store_lru_eviction_three_graphs_capacity_two():
    srv = QueryServer(backend="numpy", max_graphs=2)
    for tenant, seed in (("a", 0), ("b", 1), ("c", 2)):
        src, dst, _ = random_undirected_graph(16, 0.3, seed=seed)
        srv.load_graph(tenant, "R", src, dst)
        _force_resident(srv, tenant)
    # LRU order is load order: a coldest. Touch a so b becomes coldest.
    srv.run("a", "P(x,y) :- R(x,y).")
    srv._evict_over_budget()
    store = srv.store
    assert not store.resident("b")
    assert store.resident("a") and store.resident("c")
    assert srv.counters["store.evictions"] == 1
    assert srv.counters["tenant.b.evictions"] == 1
    # eviction drops device caches only — the evicted tenant still answers
    res = srv.run("b", "P(x,y) :- R(x,y).")
    assert res.num_rows == srv.engine("b").catalog.get("R").num_tuples


def test_graph_store_byte_budget_eviction():
    srv = QueryServer(backend="numpy", capacity_bytes=1)
    for tenant, seed in (("a", 0), ("b", 1)):
        src, dst, _ = random_undirected_graph(16, 0.3, seed=seed)
        srv.load_graph(tenant, "R", src, dst)
        _force_resident(srv, tenant)
    srv._evict_over_budget()
    # over a 1-byte budget only the warmest survives (never evicted)
    assert not srv.store.resident("a")
    assert srv.store.resident("b")


def test_graph_store_never_evicts_last_resident():
    srv = QueryServer(backend="numpy", capacity_bytes=1)
    src, dst, _ = random_undirected_graph(16, 0.3, seed=0)
    srv.load_graph("only", "R", src, dst)
    _force_resident(srv, "only")
    srv._evict_over_budget()
    assert srv.store.resident("only")
    assert srv.counters.get("store.evictions", 0) == 0


def test_trie_evict_device_counts_and_clears():
    srv = QueryServer(backend="numpy")
    src, dst, _ = random_undirected_graph(16, 0.3, seed=0)
    t = srv.load_graph("a", "R", src, dst)
    assert not t.device_resident
    _force_resident(srv, "a")
    assert t.device_resident
    dropped = t.evict_device()
    assert dropped == 2 * len(t.levels)   # the reference's count
    assert not t.device_resident
    assert t.evict_device() == 0  # idempotent


def test_evict_device_drops_the_layout_stores_device_copies():
    """The port's device layout store caches the CSR and bitset arrays
    on the device (``HybridSetStore.dev``); eviction clears them too, one
    more dropped entry a store, and they re-upload on the next query."""
    te, _ = engines(*small_graph())
    q = "C(;w:long) :- R(x,y),S(y,z),T(x,z); w=<<COUNT(*)>>."
    first = int(te.query(q).scalar())
    t = te.catalog.get("R")
    stores = [s for k, s in t._hybrid_stores.items() if k[0] != "host"]
    assert stores and all(s._dev for s in stores)
    levels = sum(lv.__dict__.get(k) is not None for lv in t.levels
                 for k in ("_dev_values", "_dev_offsets"))
    dropped = t.evict_device()
    assert dropped == levels + len(stores)
    assert not t.device_resident
    assert all(not s._dev for s in stores)
    te.bag_cache = BagResultCache()
    assert int(te.query(q).scalar()) == first
    assert any(s._dev for s in stores)


def test_host_oracle_store_is_not_device_residency():
    """The host oracle's layout store (tag ``host``) keeps host copies:
    it neither makes a trie resident nor counts as an eviction."""
    eng = load(TEngine(backend="numpy"), *small_graph())
    eng.query("C(;w:long) :- R(x,y),S(y,z),T(x,z); w=<<COUNT(*)>>.")
    t = eng.catalog.get("R")
    assert isinstance(t, Trie) and not t.device_resident
    assert t.evict_device() == 0
