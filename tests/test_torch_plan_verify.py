"""The port's plan verification against the JAX package's: every
paper-query plan validates in both, both engines count the same verified
plans and search candidates (``verify_plans`` on by default), both
validators raise the same violation codes on the same corrupted plans,
and the runtime dispatch sanitizer (``Engine(sanitize=True)``) counts the
same checks in both and rejects counters that contradict the plan."""
import collections
import math

import pytest

from conftest import random_undirected_graph
from repro import analysis as j_analysis
from repro.core import plan_ir as j_plan_ir
from repro.core import plan_search as j_plan_search
from repro.core import workload as jW
from repro.core.datalog import parse as j_parse
from repro.core.engine import Engine as JEngine
from repro.core.statistics import MAX_THRESHOLD_BITS
from repro_torch import analysis as t_analysis
from repro_torch.analysis import kernel_check as t_kernel_check
from repro_torch.core import plan_ir as t_plan_ir
from repro_torch.core import plan_search as t_plan_search
from repro_torch.core.datalog import parse as t_parse
from repro_torch.core.engine import Engine as TEngine

PAPER_QUERIES = {
    "triangle_count": jW.TRIANGLE_COUNT,
    "triangle_list": jW.TRIANGLE_LIST,
    "4clique": jW.FOUR_CLIQUE,
    "lollipop": jW.LOLLIPOP,
    "barbell": jW.BARBELL,
    "pagerank": jW.pagerank_program(iters=4),
    "sssp": jW.sssp_program("{s}"),
}
SPAN_QUERY = "P(y,a) :- R(x,y),S(y,z),T(x,z),U(x,a)."
# the two packages side by side: (engine class, analysis, plan_ir, backend
# kwargs); the port's host oracle needs no card
PACKAGES = {
    "jax": (JEngine, j_analysis, j_plan_ir, {"backend": "numpy"}),
    "port": (TEngine, t_analysis, t_plan_ir, {"backend": "numpy"}),
}


def make_engine(pkg, src, dst, **kw):
    eng_cls, _, _, base = PACKAGES[pkg]
    eng = eng_cls(**base, **kw)
    eng.load_edges("Edge", src, dst)
    for a in jW.ALIASES:
        eng.alias(a, "Edge")
    return eng


def planned(pkg, query, graph):
    src, dst, _ = random_undirected_graph(*graph)
    eng = make_engine(pkg, src, dst)
    eng.query(query)
    return eng, eng.last_physical


def codes(violations):
    return {v.code for v in violations}


@pytest.mark.parametrize("qname", sorted(PAPER_QUERIES))
def test_paper_query_plans_validate_and_counts_match(qname):
    src, dst, _ = random_undirected_graph(18, 0.3, 7)
    q = PAPER_QUERIES[qname].replace("{s}", str(int(src[0])))
    counts = {}
    for pkg in PACKAGES:
        eng = make_engine(pkg, src, dst)
        assert eng.verify_plans is True
        eng.query(q)
        if eng.last_physical is not None:
            assert PACKAGES[pkg][1].verify_physical_plan(
                eng.last_physical, eng.catalog, eng.stats_catalog) == []
        st = eng.dispatch_summary()
        counts[pkg] = (st.get("analysis.plans_verified", 0),
                       st.get("analysis.candidates_verified", 0))
    assert counts["port"] == counts["jax"]
    assert counts["port"][0] >= 1


def test_verify_plans_off_counts_nothing():
    src, dst, _ = random_undirected_graph(12, 0.3, 5)
    for pkg in PACKAGES:
        eng = make_engine(pkg, src, dst, verify_plans=False)
        assert eng.verify_plans is False
        eng.query(jW.TRIANGLE_COUNT)
        st = eng.dispatch_summary()
        assert st.get("analysis.plans_verified", 0) == 0
        assert st.get("analysis.candidates_verified", 0) == 0


def test_reload_reannotates_and_revalidates():
    """A reload re-plans against fresh statistics (new layout
    thresholds) and re-validates, in both packages alike."""
    src1, dst1, _ = random_undirected_graph(20, 0.3, 11)
    src2, dst2, _ = random_undirected_graph(40, 0.08, 5)
    out = {}
    for pkg in PACKAGES:
        eng = make_engine(pkg, src1, dst1)
        eng.query(jW.TRIANGLE_COUNT)
        thr1 = eng.last_physical.bag_ops[0].steps[-1].layout_threshold
        eng.load_edges("Edge", src2, dst2)
        eng.query(jW.TRIANGLE_COUNT)
        thr2 = eng.last_physical.bag_ops[0].steps[-1].layout_threshold
        assert thr1 != thr2
        assert PACKAGES[pkg][1].verify_physical_plan(
            eng.last_physical, eng.catalog, eng.stats_catalog) == []
        out[pkg] = (thr1, thr2,
                    eng.dispatch_summary()["analysis.plans_verified"])
    assert out["port"] == out["jax"]
    assert out["port"][2] == 2


def test_search_candidates_all_validated():
    """``plan_search.search(verify=True)`` validates every candidate and
    counts it; both packages see the same candidates."""
    src, dst, _ = random_undirected_graph(16, 0.3, 9)
    n = {}
    for pkg, search, parse in (("jax", j_plan_search.search, j_parse),
                               ("port", t_plan_search.search, t_parse)):
        eng = make_engine(pkg, src, dst)
        plan = eng._compile(parse(PAPER_QUERIES["4clique"]).rules[0])
        counter = collections.Counter()
        sr = search(plan, eng.stats_catalog, eng.catalog,
                    bag_cache=eng.bag_cache, verify=True, counter=counter)
        assert counter["analysis.candidates_verified"] == sr.candidates
        assert PACKAGES[pkg][1].verify_physical_plan(sr.physical,
                                                     eng.catalog) == []
        n[pkg] = sr.candidates
    assert n["port"] == n["jax"] > 1


# ------------------------------------------------------ corrupted plans
def _drop_child_connector(pp, eng, plan_ir):
    child = pp.bag_ops[0]
    ci = pp.bag_ops[-1].scan.child_inputs[0]
    child.materialize.output_vars = tuple(
        v for v in child.materialize.output_vars if v not in ci.vars)


def _drop_parent_connector(pp, eng, plan_ir):
    parent = pp.bag_ops[-1]
    ci = parent.scan.child_inputs[0]
    parent.materialize.output_vars = tuple(
        v for v in parent.materialize.output_vars if v not in ci.vars)


def _set(path, value):
    def mutate(pp, eng, plan_ir):
        obj = pp
        for step in path[:-1]:
            obj = obj[step] if isinstance(step, int) else getattr(obj, step)
        setattr(obj, path[-1], value(obj) if callable(value) else value)
    return mutate


def _pair_store_on_span(pp, eng, plan_ir):
    step = pp.bag_ops[-1].steps[0]
    assert isinstance(step, plan_ir.Extend)
    step.routing = "pair_store"


def _agm_exceeded(pp, eng, plan_ir):
    m = eng.catalog.get("Edge").num_tuples
    assert math.isfinite(m ** 1.5)
    pp.bag_ops[0].steps[-1].est_rows = float(m) ** 3


def _phantom_var(pp, eng, plan_ir):
    scan = pp.bag_ops[0].scan
    scan.var_order = scan.var_order + ("phantom",)


def _first_extend_sideways(value):
    def mutate(pp, eng, plan_ir):
        first = next(s for s in pp.bag_ops[0].steps
                     if isinstance(s, plan_ir.Extend))
        assert first.sideways is None
        first.sideways = value
    return mutate


def _drop_final_input(pp, eng, plan_ir):
    pp.final.inputs = pp.final.inputs[:1]


FOLD = ("bag_ops", 0, "steps", -1)
CORRUPTIONS = {
    # name: (plan, mutation, a code that must be among the violations)
    "dropped_child_connector": ("span", _drop_child_connector,
                                "dropped-connector"),
    "dropped_parent_connector": ("span", _drop_parent_connector,
                                 "dropped-connector"),
    "invalid_routing_cohort": ("triangle", _set(FOLD + ("routing",),
                                                "simd_gather"),
                               "routing-invalid"),
    "pair_routing_without_pair_structure": ("span", _pair_store_on_span,
                                            "routing-invalid"),
    "threshold_below_block": ("triangle",
                              _set(FOLD + ("layout_threshold",), 10.0),
                              "threshold-range"),
    "threshold_above_max": ("triangle", _set(
        FOLD + ("layout_threshold",), MAX_THRESHOLD_BITS * 2.0),
        "threshold-range"),
    "search_routing_with_threshold": ("triangle",
                                      _set(FOLD + ("routing",), "search"),
                                      "threshold-range"),
    "nonfinite_estimate": ("triangle", _set(("bag_ops", 0, "steps", 0,
                                             "est_rows"), float("nan")),
                           "est-invalid"),
    "agm_exceeded": ("triangle", _agm_exceeded, "agm-exceeded"),
    "wrong_n_constraining": ("triangle", _set(
        ("bag_ops", 0, "steps", 0, "n_constraining"),
        lambda step: step.n_constraining + 1), "step-shape"),
    "unconstrained_variable": ("triangle", _phantom_var, "step-shape"),
    "incomplete_reuse_rels": ("triangle", _set(
        ("bag_ops", 0, "materialize", "reuse_rels"), ()), "reuse-key"),
    "malformed_reuse_struct": ("triangle", _set(
        ("bag_ops", 0, "materialize", "reuse_struct"), ("not", "canonical")),
        "reuse-key"),
    "final_join_input_dropped": ("span", _drop_final_input,
                                 "unconstrained-var"),
    "sideways_unknown": ("triangle", _first_extend_sideways("bloom"),
                         "sideways-invalid"),
    "sideways_on_root_extension": ("triangle",
                                   _first_extend_sideways("bitset"),
                                   "sideways-invalid"),
}


@pytest.mark.parametrize("name", sorted(CORRUPTIONS))
def test_corrupted_plan_rejected_with_the_same_codes(name):
    which, mutate, code = CORRUPTIONS[name]
    query, graph = {"span": (SPAN_QUERY, (16, 0.3, 3)),
                    "triangle": (jW.TRIANGLE_COUNT, (20, 0.3, 1))}[which]
    found = {}
    for pkg in PACKAGES:
        _, analysis, plan_ir, _ = PACKAGES[pkg]
        eng, pp = planned(pkg, query, graph)
        assert analysis.verify_physical_plan(pp, eng.catalog,
                                             eng.stats_catalog) == []
        mutate(pp, eng, plan_ir)
        vs = analysis.verify_physical_plan(pp, eng.catalog,
                                           eng.stats_catalog)
        found[pkg] = codes(vs)
        with pytest.raises(analysis.PlanVerificationError):
            analysis.assert_valid(pp, eng.catalog, eng.stats_catalog)
    assert found["port"] == found["jax"]
    assert code in found["port"]


def test_structural_checks_run_without_catalog():
    _, pp = planned("port", jW.TRIANGLE_COUNT, (20, 0.3, 1))
    assert t_analysis.verify_physical_plan(pp, catalog=None,
                                           stats=None) == []


# ------------------------------------------------------------- sanitize
@pytest.mark.parametrize("backend", ["numpy", "device"])
def test_sanitize_checks_match(backend):
    """``Engine(sanitize=True)`` checks every executed rule against its
    plan in both packages, the same number of times; the port's device
    backend runs on the CPU here."""
    src, dst, _ = random_undirected_graph(24, 0.3, 2)
    checks = {}
    for pkg, eng_cls in (("jax", JEngine), ("port", TEngine)):
        kw = {"device": "cpu"} if pkg == "port" and backend == "device" \
            else {}
        eng = eng_cls(backend=backend, sanitize=True, **kw)
        eng.load_edges("Edge", src, dst)
        for a in jW.ALIASES:
            eng.alias(a, "Edge")
        for q in (jW.TRIANGLE_COUNT, jW.LOLLIPOP, SPAN_QUERY,
                  "SM(x;w:long) :- R(x,y),S(y,z),T(x,z); w=<<SUM(z)>>."):
            eng.query(q)
        checks[pkg] = eng.dispatch_summary()["analysis.sanitize_checks"]
    assert checks["port"] == checks["jax"] >= 4


def test_sanitizer_rejects_counters_the_plan_contradicts():
    eng, pp = planned("port", jW.TRIANGLE_LIST, (20, 0.3, 1))
    routes = t_kernel_check._routing_summary(pp)
    assert all(r != "pair_kernel" for r in routes.values())
    with pytest.raises(t_kernel_check.SanitizeError, match="pair-cohort"):
        t_kernel_check.check_dispatch(pp, {"fold.pair_count_calls": 1}, {},
                                      "numpy")
    with pytest.raises(t_kernel_check.SanitizeError, match="host syncs"):
        t_kernel_check.check_dispatch(
            pp, {"extend.calls": 1, "extend.host_syncs": 50}, {}, "numpy")
    t_kernel_check.check_dispatch(pp, {"extend.calls": 1}, {}, "numpy")
