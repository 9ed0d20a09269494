"""The slice as a whole, on a sparse power-law graph: every Table 2
pattern query through ``repro_torch`` ``Engine(backend="device",
device="cpu")`` (every kernel's plain version) against the JAX
``Engine(backend="device")`` (Pallas in interpret mode).  Integer results
are identical, ``TRIANGLE_LIST`` rows match after sorting, and the
dispatch counters that carry the pipeline's invariants are equal.  Also
the interpreter lowering, prepared queries, and the host oracle."""
import numpy as np
import pytest

from repro.core import workload as jW
from repro.core.engine import Engine as JEngine
from repro.data.graphs import powerlaw_graph
from repro_torch.core.engine import Engine as TEngine

QUERIES = ("TRIANGLE_COUNT", "TRIANGLE_LIST", "FOUR_CLIQUE", "LOLLIPOP",
           "BARBELL")
COUNTERS = ("pipeline.launches", "extend.closing_syncs", "extend.host_syncs",
            "pipeline.morsels", "pipeline.device_folds",
            "pipeline.sideways_extends", "pipeline.retries",
            "fold.pair_count_calls", "intersect.bitset_kernel",
            "intersect.uint_kernel", "intersect.uint_search",
            "intersect.uint_bitset")


def edges():
    g = powerlaw_graph(300, 8, 2.0, seed=0)
    return np.repeat(np.arange(g.n), np.diff(g.offsets)), g.neighbors


def load(eng, src, dst):
    eng.load_edges("Edge", src, dst)
    for a in jW.ALIASES:
        eng.alias(a, "Edge")
    return eng


def sorted_rows(res):
    cols = np.stack([np.asarray(res.columns[v]) for v in res.vars], axis=1)
    return cols[np.lexsort(cols.T[::-1])]


def assert_same(tres, jres):
    assert tres.vars == jres.vars
    if tres.vars:
        np.testing.assert_array_equal(sorted_rows(tres), sorted_rows(jres))
    if jres.annotation is None:
        assert tres.annotation is None
    else:
        np.testing.assert_array_equal(np.asarray(tres.annotation),
                                      np.asarray(jres.annotation))


@pytest.mark.parametrize("qname", QUERIES)
def test_query_and_counters_match(qname):
    src, dst = edges()
    q = getattr(jW, qname)
    je = load(JEngine(backend="device"), src, dst)
    te = load(TEngine(backend="device", device="cpu"), src, dst)
    jres, tres = je.query(q), te.query(q)
    assert_same(tres, jres)
    jd, td = je.dispatch_summary(), te.dispatch_summary()
    for k in COUNTERS:
        assert td.get(k, 0) == jd.get(k, 0), k
    assert td["pipeline.launches"] >= 1
    assert td["pipeline.morsels"] > 0
    assert td.get("extend.host_syncs", 0) == 0
    # estimated vs actual rows per operator, plan-search verdict
    assert te.plan_metadata() == je.plan_metadata()


def test_interpreter_matches_codegen():
    src, dst = edges()
    out = {}
    for use_codegen in (True, False):
        te = load(TEngine(backend="device", device="cpu",
                          use_codegen=use_codegen), src, dst)
        out[use_codegen] = (int(te.query(jW.LOLLIPOP).scalar()),
                            te.dispatch_summary()["pipeline.morsels"])
    assert out[True] == out[False]


def test_host_oracle_matches_device():
    src, dst = edges()
    for qname in QUERIES:
        q = getattr(jW, qname)
        host = load(TEngine(backend="numpy"), src, dst).query(q)
        dev = load(TEngine(backend="device", device="cpu"), src, dst).query(q)
        assert_same(dev, host)


def test_prepared_query_rebinds():
    src, dst = edges()
    text = ("C(;w:long) :- R(5,y),S(y,z),T(5,z); w=<<COUNT(*)>>.")
    jp = load(JEngine(backend="device"), src, dst).prepare(text)
    te = load(TEngine(backend="device", device="cpu"), src, dst)
    tp = te.prepare(text)
    for node in (5, 7, 0):
        assert int(tp.run(node).scalar()) == int(jp.run(node).scalar())
    assert te.dispatch_summary()["compile.plan_searches"] == 1


def test_recursive_rule_names_the_roadmap():
    te = load(TEngine(backend="device", device="cpu"), *edges())
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        te.query(jW.sssp_program(0))


ANNOTATED = ("P(x;w:float) :- Edge(x,y); w=<<SUM(y)>>.",
             "M(x;w:float) :- Edge(x,y),R(y,z); w=<<MIN(z)>>.")


@pytest.mark.parametrize("q", ANNOTATED)
def test_annotated_folds_match(q):
    """Float semirings over an annotated relation: the device fold
    multiplies leaf annotations in and reduces per row."""
    src, dst = edges()
    w = np.random.default_rng(0).integers(1, 9, len(src)).astype(np.float32)
    out = []
    for eng in (JEngine(backend="device"),
                TEngine(backend="device", device="cpu")):
        eng.load_edges("Edge", src, dst, annotation=w)
        eng.alias("R", "Edge")
        res = eng.query(q)
        out.append((res, eng.dispatch_summary()))
    (jres, jd), (tres, td) = out
    assert_same(tres, jres)
    for k in COUNTERS:
        assert td.get(k, 0) == jd.get(k, 0), k


def test_materialize_route_is_not_ported_yet():
    """An annotated triangle routes its fold to the materializing pair
    store; the device backend refuses by name instead of routing around
    the missing kernel, and the host oracle answers."""
    src, dst = edges()
    w = np.ones(len(src), np.float32)
    q = ("T(x;w:float) :- Edge(x,y),R(y,z),S(x,z); w=<<SUM(z)>>.")
    dev = load(TEngine(backend="device", device="cpu"), src, dst)
    dev.load_edges("Edge", src, dst, annotation=w)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        dev.query(q)
    host = load(TEngine(backend="numpy"), src, dst)
    host.load_edges("Edge", src, dst, annotation=w)
    assert host.query(q).num_rows > 0
