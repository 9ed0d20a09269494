"""The port's host oracle (``Engine(backend="numpy")``) against the
reference's, on the sparse power-law graph with the Table 2 aliases on
one ``Edge`` trie: equal results and equal whole dispatch summaries,
under the reference's counter names (the reference's baselines key on
them, e.g. ``intersect.bitset_jnp`` for the plain bitset count)."""
import numpy as np
import pytest

from repro.core import workload as jW
from repro.core.engine import Engine as JEngine
from repro.data.graphs import powerlaw_graph
from repro_torch.core.engine import Engine as TEngine

QUERIES = ("TRIANGLE_COUNT", "TRIANGLE_LIST", "FOUR_CLIQUE", "LOLLIPOP",
           "BARBELL")
# the binary COUNT terminal fold over two probes of the one trie: both
# sides dense go to the plain bitset count on the host oracle
BITSET_FOLDS = ("TRIANGLE_COUNT", "LOLLIPOP", "BARBELL")


def load(eng):
    g = powerlaw_graph(300, 8, 2.0, seed=0)
    eng.load_edges("Edge", np.repeat(np.arange(g.n), np.diff(g.offsets)),
                   g.neighbors)
    for a in jW.ALIASES:
        eng.alias(a, "Edge")
    return eng


def rows(res):
    cols = np.stack([np.asarray(res.columns[v]) for v in res.vars], axis=1)
    return cols[np.lexsort(cols.T[::-1])]


def assert_same_result(tres, jres):
    assert tres.vars == jres.vars
    if jres.vars:
        np.testing.assert_array_equal(rows(tres), rows(jres))
    if jres.annotation is None:
        assert tres.annotation is None
    else:
        np.testing.assert_array_equal(np.asarray(tres.annotation),
                                      np.asarray(jres.annotation))


@pytest.mark.parametrize("qname", QUERIES)
def test_host_oracle_summary_matches_reference(qname):
    q = getattr(jW, qname)
    je, te = load(JEngine(backend="numpy")), load(TEngine(backend="numpy"))
    assert_same_result(te.query(q), je.query(q))
    jd, td = je.dispatch_summary(), te.dispatch_summary()
    assert td == jd
    if qname in BITSET_FOLDS:
        assert td.get("intersect.bitset_jnp", 0) > 0, td


def test_host_oracle_summary_matches_reference_over_the_workload():
    """All five queries on one engine of each package: the summaries
    stay equal as the counters add up."""
    je, te = load(JEngine(backend="numpy")), load(TEngine(backend="numpy"))
    for qname in QUERIES:
        q = getattr(jW, qname)
        assert_same_result(te.query(q), je.query(q))
    jd, td = je.dispatch_summary(), te.dispatch_summary()
    assert td == jd
    assert td["intersect.bitset_jnp"] > 0
    assert "intersect.bitset_kernel" not in td
