"""The slice as a whole, on a sparse power-law graph: every Table 2
pattern query through ``repro_torch`` ``Engine(backend="device",
device="cpu")`` (every kernel's plain version) against the JAX
``Engine(backend="device")`` (Pallas in interpret mode).  Integer results
are identical, ``TRIANGLE_LIST`` rows match after sorting, and the whole
dispatch summaries are equal (plan verification, pipeline, cohort routes,
caches).  Also the materializing pair route (the ``materialize`` kernel's
plain version), the interpreter lowering, prepared queries, and the host
oracle."""
import numpy as np
import pytest

from repro.core import workload as jW
from repro.core.engine import Engine as JEngine
from repro.data.graphs import powerlaw_graph
from repro_torch.core.engine import Engine as TEngine

QUERIES = ("TRIANGLE_COUNT", "TRIANGLE_LIST", "FOUR_CLIQUE", "LOLLIPOP",
           "BARBELL")
# counters only the port keeps, each with its reason; every other counter
# of the two dispatch summaries must be equal
PORT_ONLY = {
    # eager PyTorch has no device while-loop: a data-dependent fixpoint
    # reads one device flag per block of rounds
    "recursion.host_reads",
}


def edges():
    g = powerlaw_graph(300, 8, 2.0, seed=0)
    return np.repeat(np.arange(g.n), np.diff(g.offsets)), g.neighbors


def load(eng, src, dst):
    eng.load_edges("Edge", src, dst)
    for a in jW.ALIASES:
        eng.alias(a, "Edge")
    return eng


def assert_same_summary(td, jd):
    td = {k: v for k, v in td.items() if k not in PORT_ONLY}
    assert td == jd


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
    assert_same_summary(td, jd)
    assert td["analysis.plans_verified"] >= 1
    assert td["analysis.candidates_verified"] >= 1
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
    """Recursion is ported now (ROADMAP queue 1 item 1): SSSP on this
    graph runs as one device fixpoint and equals the JAX engine's."""
    src, dst = edges()
    je = load(JEngine(backend="device"), src, dst)
    jres = je.query(jW.sssp_program(0))
    te = load(TEngine(backend="device", device="cpu"), src, dst)
    assert_same(te.query(jW.sssp_program(0)), jres)
    assert te.dispatch_summary()["recursion.device_fixpoints"] == 1
    assert_same_summary(te.dispatch_summary(), je.dispatch_summary())


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
    assert_same_summary(td, jd)


# Triangle-shaped queries whose fold is not a COUNT, or whose projection
# folds z: the extension of z routes to the materializing pair store, and
# its dense x dense pairs to the materialize kernel.  (query, annotated)
MATERIALIZING = {
    "TY": ("TY(x,y) :- R(x,y),S(y,z),T(x,z).", False),
    "SUM": ("SM(x;w:long) :- R(x,y),S(y,z),T(x,z); w=<<SUM(z)>>.", False),
    "MIN": ("MN(x;w:long) :- R(x,y),S(y,z),T(x,z); w=<<MIN(z)>>.", False),
    "lollipop_projection": ("P(y,a) :- R(x,y),S(y,z),T(x,z),U(x,a).",
                            False),
    "annotated_float_sum": (
        "T(x;w:float) :- Edge(x,y),R(y,z),S(x,z); w=<<SUM(z)>>.", True),
}


@pytest.mark.parametrize("name", list(MATERIALIZING))
def test_materializing_route_matches(name):
    """The pair store's materializing route on the device backend: rows
    (integers exact, float annotations within rtol 1e-6) and the whole
    dispatch summary equal to the JAX engine's, which routes the dense
    cohort to its Pallas kernel too."""
    q, annotated = MATERIALIZING[name]
    src, dst = edges()
    w = (np.random.default_rng(1).integers(1, 9, len(src)).astype(np.float32)
         if annotated else None)
    out = []
    for eng in (JEngine(backend="device"),
                TEngine(backend="device", device="cpu")):
        load(eng, src, dst)
        if annotated:
            eng.load_edges("Edge", src, dst, annotation=w)
        res = eng.query(q)
        out.append((res, eng.dispatch_summary()))
    (jres, jd), (tres, td) = out
    assert tres.vars == jres.vars
    np.testing.assert_array_equal(sorted_rows(tres), sorted_rows(jres))
    assert tres.num_rows == jres.num_rows > 0
    if jres.annotation is not None:
        if annotated:
            np.testing.assert_allclose(_by_key(tres), _by_key(jres),
                                       rtol=1e-6)
        else:
            np.testing.assert_array_equal(_by_key(tres), _by_key(jres))
    assert_same_summary(td, jd)
    assert td["extend.pair_materialize_calls"] >= 1
    assert td["intersect.materialize_kernel"] > 0
    assert td["analysis.plans_verified"] >= 1


def _by_key(res):
    """Annotation values in the order of the sorted key rows."""
    cols = np.stack([np.asarray(res.columns[v]) for v in res.vars], axis=1)
    return np.asarray(res.annotation)[np.lexsort(cols.T[::-1])]


def test_host_oracle_answers_the_materializing_queries():
    """The port's host oracle takes the host bitset extraction for the
    dense cohort and gives the device backend's rows."""
    src, dst = edges()
    for q, annotated in MATERIALIZING.values():
        if annotated:
            continue
        host = load(TEngine(backend="numpy"), src, dst)
        dev = load(TEngine(backend="device", device="cpu"), src, dst)
        assert_same(dev.query(q), host.query(q))
        assert host.dispatch_summary()["intersect.materialize_bitset"] > 0
        assert "intersect.materialize_kernel" not in host.dispatch_summary()
