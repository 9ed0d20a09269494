"""The engine's three layout modes in the port against the JAX package's:
"set" (Algorithm 3's set-level cohorts, the paper's default), "uint" (one
uint layout for the whole relation, the "-R" ablation of Table 8) and
"off" (no layout store: the terminal fold runs in the device pipeline).
For each mode, TRIANGLE_COUNT and FOUR_CLIQUE on an unpruned power-law
graph and on its degree- and hybrid-ordered, symmetrically pruned forms
through the port's ``Engine(backend="device", device="cpu")`` (every
kernel's plain version) and the reference's ``Engine(backend="device")``
(Pallas in interpret mode): counts and whole dispatch summaries equal.
Pruning counts each triangle once and each 4-clique once, so the pruned
counts times 6 and 24 are the unpruned ones; a prepared ``triangle_at``
batch agrees in each mode too.  The mode is module state in both
packages; a fixture sets it in both and restores "set"."""
import numpy as np
import pytest

import repro.core.layouts as j_layouts
import repro_torch.core.layouts as t_layouts
from repro.core import workload as jW
from repro.core.engine import Engine as JEngine
from repro.data.graphs import powerlaw_graph
from repro.graph.ordering import apply_ordering, order_nodes
from repro.graph.prune import prune_symmetric
from repro_torch.core.engine import Engine as TEngine

MODES = ("set", "uint", "off")
GRAPHS = ("unpruned", "degree", "hybrid")
QUERIES = {"TRIANGLE_COUNT": 6, "FOUR_CLIQUE": 24}
TRIANGLE_AT = "C(;w:long) :- R(0,y),S(y,z),T(0,z); w=<<COUNT(*)>>."


@pytest.fixture
def mode(request):
    """Both packages in layout mode ``request.param``, "set" again after."""
    try:
        j_layouts.set_engine_layout_mode(request.param)
        t_layouts.set_engine_layout_mode(request.param)
        yield request.param
    finally:
        j_layouts.set_engine_layout_mode("set")
        t_layouts.set_engine_layout_mode("set")


def edges(kind):
    """Directed edge columns of the test graph: symmetric, or ordered by
    ``kind`` and pruned to src > dst."""
    g = powerlaw_graph(300, 8, 2.0, seed=0)
    if kind != "unpruned":
        g = prune_symmetric(apply_ordering(g, order_nodes(g, kind)))
    return np.repeat(np.arange(g.n), np.diff(g.offsets)), g.neighbors


def load(eng, src, dst):
    eng.load_edges("Edge", src, dst)
    for a in jW.ALIASES:
        eng.alias(a, "Edge")
    return eng


def engines(src, dst):
    return (load(TEngine(backend="device", device="cpu"), src, dst),
            load(JEngine(backend="device"), src, dst))


def routes(summary):
    return {k: v for k, v in summary.items() if k.startswith("intersect.")}


@pytest.mark.parametrize("mode", MODES, indirect=True)
@pytest.mark.parametrize("graph", GRAPHS)
@pytest.mark.parametrize("qname", sorted(QUERIES))
def test_counts_and_summary_match(mode, graph, qname):
    src, dst = edges(graph)
    q = getattr(jW, qname)
    te, je = engines(src, dst)
    got, want = int(te.query(q).scalar()), int(je.query(q).scalar())
    assert got == want
    td, jd = te.dispatch_summary(), je.dispatch_summary()
    assert td == jd
    if mode == "off":
        assert "fold.pair_count_calls" not in td
        assert not routes(td)
        assert "layout.stats_driven" not in td
    if mode == "uint":
        assert "layout.stats_driven" not in td
        assert "intersect.bitset_kernel" not in td
        assert "intersect.bitset_jnp" not in td


@pytest.mark.parametrize("mode", MODES, indirect=True)
def test_pruned_counts_are_the_unpruned_ones(mode):
    for qname, times in QUERIES.items():
        q = getattr(jW, qname)
        counts = {g: int(load(TEngine(backend="device", device="cpu"),
                              *edges(g)).query(q).scalar())
                  for g in GRAPHS}
        assert counts["unpruned"] > 0
        assert counts["degree"] * times == counts["unpruned"], (qname, counts)
        assert counts["hybrid"] * times == counts["unpruned"], (qname, counts)


@pytest.mark.parametrize("mode", MODES, indirect=True)
def test_routes_follow_the_mode(mode):
    """On the degree-ordered, pruned graph "set" sends TRIANGLE_COUNT's
    fold through the bitset kernel's route, "uint" through the uint
    kernel's, and "off" through no pair route at all: the device
    pipeline folds it."""
    te = load(TEngine(backend="device", device="cpu"), *edges("degree"))
    te.query(jW.TRIANGLE_COUNT)
    d = te.dispatch_summary()
    if mode == "set":
        assert d["intersect.bitset_kernel"] > 0, d
        assert d["layout.stats_driven"] > 0, d
    elif mode == "uint":
        assert d["intersect.uint_kernel"] > 0, d
        assert d["fold.pair_count_calls"] > 0, d
    else:
        assert not routes(d) and "fold.pair_count_calls" not in d, d
        assert d["pipeline.device_folds"] > 0, d


@pytest.mark.parametrize("mode", MODES, indirect=True)
def test_triangle_at_batch_matches(mode):
    src, dst = edges("unpruned")
    te, je = engines(src, dst)
    hubs = [int(h) for h in np.argsort(-np.bincount(src, minlength=300),
                                       kind="stable")[:4]] + [0, 7]
    got = [int(r.scalar()) for r in te.prepare(TRIANGLE_AT).run_batch(hubs)]
    want = [int(r.scalar()) for r in je.prepare(TRIANGLE_AT).run_batch(hubs)]
    assert got == want
    assert any(got)
    td, jd = te.dispatch_summary(), je.dispatch_summary()
    assert td == jd
    assert td["pipeline.batched_launches"] >= 1, td
    if mode == "off":
        assert "fold.pair_count_calls" not in td
