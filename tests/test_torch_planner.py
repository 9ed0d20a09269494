"""Port planner against the JAX package: the copied front end (datalog,
hypergraph, agm, ghd, compile, statistics, plan_ir, plan_search, codegen)
must make the same decisions on every Table 2 query — the same GHD and
attribute order, the same plan-search verdict and ``plan_cost``, the same
per-operator ``est_rows``, the same ``BagHints`` — and emit the same
program, with ``repro_torch.core`` in place of ``repro.core``."""
import dataclasses

import numpy as np
import pytest

from repro.core import workload as jW
from repro.core.datalog import parse as j_parse
from repro.core.engine import Engine as JEngine
from repro.core.plan_ir import plan_cost as j_plan_cost
from repro.data.graphs import powerlaw_graph
from repro_torch.core import workload as tW
from repro_torch.core.datalog import parse as t_parse
from repro_torch.core.engine import Engine as TEngine
from repro_torch.core.plan_ir import plan_cost as t_plan_cost

QUERIES = {
    "triangle_count": "TRIANGLE_COUNT",
    "triangle_list": "TRIANGLE_LIST",
    "4clique": "FOUR_CLIQUE",
    "lollipop": "LOLLIPOP",
    "barbell": "BARBELL",
}
SELECTION = "SSSP(x;y:int) :- Edge(3,x); y=1."


def graph(name):
    if name == "clique24":
        a = ~np.eye(24, dtype=bool)
        return np.nonzero(a)
    g = powerlaw_graph(300, 8, 2.0, seed=0)
    return np.repeat(np.arange(g.n), np.diff(g.offsets)), g.neighbors


def engines(gname):
    src, dst = graph(gname)
    out = []
    for eng in (JEngine(backend="numpy"), TEngine(backend="numpy")):
        eng.load_edges("Edge", src, dst)
        for a in jW.ALIASES:
            eng.alias(a, "Edge")
        out.append(eng)
    return out


def test_workload_text_is_the_same():
    for attr in QUERIES.values():
        assert getattr(tW, attr) == getattr(jW, attr)
    assert tW.ALIASES == jW.ALIASES


@pytest.mark.parametrize("gname", ["powerlaw300", "clique24"])
@pytest.mark.parametrize("qname", sorted(QUERIES) + ["selection"])
def test_plans_match(gname, qname):
    text = SELECTION if qname == "selection" else getattr(jW, QUERIES[qname])
    je, te = engines(gname)
    jrule, trule = j_parse(text).rules[0], t_parse(text).rules[0]
    assert repr(trule) == repr(jrule)
    jplan, tplan = je._compile(jrule), te._compile(trule)
    # logical plan: GHD, attribute order, width, top-down need
    assert tplan.pretty() == jplan.pretty()
    assert tplan.order == jplan.order
    jp, jfn, jsrc, jmd = je._physical(jplan)
    tp, tfn, tsrc, tmd = te._physical(tplan)
    # plan-search verdict (candidates, chosen index/order, costs)
    assert tmd == jmd
    assert tp.logical.order == jp.logical.order
    assert t_plan_cost(tp) == j_plan_cost(jp)
    # per-operator est_rows / costs / routing, and the runtime hints
    assert tp.metadata() == jp.metadata()
    assert len(tp.bag_ops) == len(jp.bag_ops)
    for tb, jb in zip(tp.bag_ops, jp.bag_ops):
        assert dataclasses.asdict(tb.hints()) == dataclasses.asdict(
            jb.hints())
        assert tb.materialize.est_rows == jb.materialize.est_rows
    # the emitted program is the reference's, importing the port
    assert "from repro_torch.core." in tsrc
    assert "from repro.core." not in tsrc
    assert tsrc == jsrc.replace("repro.core.", "repro_torch.core.")
