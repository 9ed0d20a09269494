"""The slice as a whole on a dense graph (a 24-clique: every set in the
bitset cohort) and on a sparse graph whose uint cohort is non-empty (so
the uint kernel's route is compared too): the port's
``Engine(backend="device", device="cpu")`` against the JAX
``Engine(backend="device")``, results and dispatch counters equal."""
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


def edges(name):
    if name == "clique24":
        return np.nonzero(~np.eye(24, dtype=bool))
    g = powerlaw_graph(5000, 3, 2.5, seed=0)
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


def run_both(gname, qname):
    src, dst = edges(gname)
    q = getattr(jW, qname)
    je = load(JEngine(backend="device"), src, dst)
    te = load(TEngine(backend="device", device="cpu"), src, dst)
    jres, tres = je.query(q), te.query(q)
    assert_same(tres, jres)
    jd, td = je.dispatch_summary(), te.dispatch_summary()
    for k in COUNTERS:
        assert td.get(k, 0) == jd.get(k, 0), k
    assert te.plan_metadata() == je.plan_metadata()
    return td


@pytest.mark.parametrize("qname", QUERIES)
def test_clique_query_and_counters_match(qname):
    td = run_both("clique24", qname)
    assert td["pipeline.launches"] >= 1
    assert td["pipeline.morsels"] > 0
    assert td.get("extend.host_syncs", 0) == 0
    assert td.get("intersect.uint_kernel", 0) == 0


@pytest.mark.parametrize("qname", ["TRIANGLE_COUNT", "LOLLIPOP"])
def test_uint_cohort_query_and_counters_match(qname):
    td = run_both("powerlaw5000", qname)
    assert td["intersect.uint_kernel"] > 0
    assert td["intersect.uint_bitset"] > 0
    assert td["intersect.bitset_kernel"] > 0
