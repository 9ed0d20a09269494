"""The port's static device-memory model
(``repro_torch.analysis.memory_budget``) against its live device caches
and against the JAX package's model: every component the reference
models predicts the port's live bytes exactly and equals the reference's
bytes, the port-only layout-store component (the device copies of
``HybridSetStore.dev``) is counted, the frontier-buffer model of a
lowered program equals the reference's for the same query, and
``GraphStore`` budgets eviction on the model."""
import numpy as np
import pytest
import torch

from repro.analysis import memory_budget as JMB
from repro.core import workload as jW
from repro.core.engine import Engine as JEngine
from repro.data import powerlaw_graph
from repro_torch.analysis import memory_budget as MB
from repro_torch.core import backend as backend_mod
from repro_torch.core.engine import Engine as TEngine
from repro_torch.core.executor import BagResultCache
from repro_torch.serve import QueryServer

QUERIES = (jW.TRIANGLE_COUNT, jW.FOUR_CLIQUE)


def edges(n=80, deg=5, seed=0):
    g = powerlaw_graph(n, deg, 2.0, seed=seed)
    return np.repeat(np.arange(g.n), g.degrees), g.neighbors


def load(eng, src, dst):
    trie = eng.load_edges("Edge", src, dst)
    for al in jW.ALIASES:
        eng.alias(al, "Edge")
    return trie


@pytest.fixture(scope="module")
def both(request):
    """Port and reference device engines after TRIANGLE_COUNT and
    FOUR_CLIQUE on a graph dense enough that the counting pass routes a
    probe through the blocked bitset; with each one's lowered bag
    programs."""
    src, dst = edges()
    te = TEngine(backend="device", device="cpu")
    ttrie = load(te, src, dst)
    tprogs = []
    orig = backend_mod._bag_program

    def recording(arrays, cursors0, ann, *, prog, batch=None):
        tprogs.append(prog)
        return orig(arrays, cursors0, ann, prog=prog, batch=batch)

    backend_mod._bag_program = recording
    try:
        for q in QUERIES:
            te.query(q)
    finally:
        backend_mod._bag_program = orig
    je = JEngine(backend="device")
    jtrie = load(je, src, dst)
    records = []
    je.backend.audit_log = records
    try:
        for q in QUERIES:
            je.query(q)
    finally:
        je.backend.audit_log = None
    jprogs = [r[2] for r in records if r[0] == "bag"]
    return te, ttrie, tprogs, je, jtrie, jprogs


def kind(name):
    return name.split("[")[0]


# ---------------------------------------------------------- model vs live
def test_model_matches_live_exactly(both):
    _te, trie, *_ = both
    fp = MB.trie_footprint(trie)
    assert fp.components
    for c in fp.components:
        assert c.model_bytes == c.live_bytes, c
    assert fp.model_bytes == fp.live_bytes
    MB.check_tries([trie])


def test_reference_components_equal_the_reference(both):
    """Levels, offsets and bitset directories: the same components with
    the same bytes as the reference's model (int32 offsets on both)."""
    _te, ttrie, _tp, _je, jtrie, _jp = both
    ours = sorted((kind(c.name), c.model_bytes)
                  for c in MB.trie_footprint(ttrie).components
                  if kind(c.name) != "layout_store")
    ref = sorted((kind(c.name), c.model_bytes)
                 for c in JMB.trie_footprint(jtrie).components)
    assert ours == ref
    assert any(k == "bitset_dir" for k, _ in ours)
    assert MB.trie_footprint(ttrie).model_bytes != ttrie.nbytes()


def test_layout_store_component_is_counted(both):
    """The device layout store's copies (CSR, bitset words, directory,
    index) are a component of their own: counted in the resident model
    and in the full upload, and dropped by eviction."""
    _te, trie, *_ = both
    fp = MB.trie_footprint(trie)
    stores = [c for c in fp.components if kind(c.name) == "layout_store"]
    assert len(stores) == 1
    (store,) = [s for k, s in trie._hybrid_stores.items() if k[0] != "host"]
    assert stores[0].model_bytes == stores[0].live_bytes == sum(
        t.nbytes for t in store._dev.values()) > 0
    assert "words" in store._dev
    assert MB.trie_device_bytes(trie) == fp.model_bytes
    assert MB.trie_full_upload_bytes(trie) >= MB.trie_device_bytes(trie)
    # the full upload counts every array of the store, resident or not
    full = sum(int(np.asarray(store.host_array(n)).size) * 4
               for n in MB.STORE_ARRAYS)
    assert MB.trie_full_upload_bytes(trie) - full == \
        JMB.trie_full_upload_bytes(trie)


def test_drift_raises_with_component_breakdown(both):
    _te, trie, *_ = both
    lv = next(lv for lv in trie.levels
              if lv.__dict__.get("_dev_values") is not None)
    real = lv.__dict__["_dev_values"]
    # fake an unaccounted 4 KiB device buffer behind the cache key
    lv.__dict__["_dev_values"] = (real[0], torch.zeros(1024,
                                                       dtype=torch.int32))
    try:
        with pytest.raises(MB.MemoryBudgetError, match="drift"):
            MB.check_tries([trie])
    finally:
        lv.__dict__["_dev_values"] = real
    MB.check_tries([trie])


def test_check_counters_surface(both):
    te, trie, *_ = both
    before = te.backend.stats.get("analysis.memory_checks", 0)
    MB.check_tries([trie], counters=te.backend.stats)
    summary = te.dispatch_summary()
    assert summary["analysis.memory_checks"] == before + 1
    assert summary["analysis.memory_model_bytes"] > 0


# ------------------------------------------------------- transient buffers
def test_program_frontier_bytes_equals_reference(both):
    _te, _tt, tprogs, _je, _jt, jprogs = both
    assert len(tprogs) == len(jprogs) > 0
    for tp, jp in zip(tprogs, jprogs):
        got = MB.program_frontier_bytes(tp)
        assert got == JMB.program_frontier_bytes(jp)
        assert MB.program_frontier_bytes(tp, batch=4) == 4 * got
    assert any(MB.program_frontier_bytes(tp) > 0 for tp in tprogs)


def test_plan_frontier_bytes_equals_reference():
    src, dst = edges()
    te = TEngine(backend="device", device="cpu")
    je = JEngine(backend="device")
    for eng in (te, je):
        load(eng, src, dst)
        eng.query(jW.FOUR_CLIQUE)
    got = MB.plan_frontier_bytes(te.last_physical, batch=3)
    assert got == JMB.plan_frontier_bytes(je.last_physical, batch=3)


def test_fixpoint_state_bytes():
    assert MB.fixpoint_state_bytes(100, torch.float32) == 100 * 5
    assert MB.fixpoint_state_bytes(100, torch.float64) == 100 * 9


# -------------------------------------------------- GraphStore integration
def test_graphstore_budgets_on_model_bytes():
    src, dst = edges(40, 4, seed=1)
    srv = QueryServer(device="cpu")
    trie = srv.load_graph("a", "Edge", src, dst)
    for al in jW.ALIASES:
        srv.alias("a", al, "Edge")
    assert srv.store.resident_bytes() == 0    # nothing uploaded yet
    srv.run("a", jW.TRIANGLE_COUNT)
    model = MB.trie_device_bytes(trie)
    assert srv.store.resident_bytes() == model > 0
    assert model != trie.nbytes()
    report = MB.check_store(srv)
    assert report["a"]["model_bytes"] == report["a"]["live_bytes"] == model


def test_eviction_uses_model_budget():
    """A budget sized between one and two model footprints evicts the
    cold tenant, keeps the warm one, and the evicted tenant's re-query
    gives its first answer."""
    src, dst = edges(40, 4, seed=1)
    probe = QueryServer(device="cpu")
    t0 = probe.load_graph("x", "Edge", src, dst)
    for al in jW.ALIASES:
        probe.alias("x", al, "Edge")
    probe.run("x", jW.TRIANGLE_COUNT)
    one = MB.trie_device_bytes(t0)

    srv = QueryServer(device="cpu", capacity_bytes=int(1.5 * one))
    for tenant in ("a", "b"):
        srv.load_graph(tenant, "Edge", src, dst)
        for al in jW.ALIASES:
            srv.alias(tenant, al, "Edge")
    first = int(srv.run("a", jW.TRIANGLE_COUNT).scalar())
    assert srv.store.resident("a")
    srv.run("b", jW.TRIANGLE_COUNT)
    assert not srv.store.resident("a")
    assert srv.store.resident("b")
    assert srv.store.resident_bytes() <= int(1.5 * one)
    assert srv.counters.get("store.evictions", 0) >= 1
    MB.check_store(srv)
    srv.engine("a").bag_cache = BagResultCache()   # recompute, re-upload
    assert int(srv.query("a", jW.TRIANGLE_COUNT).scalar()) == first
    assert srv.store.resident("a")
