"""The EmptyHeaded engine facade (paper Figure 1).

Counterpart of ``repro.core.engine``.  ``Engine`` wires the three phases
together:

  1. query compiler — datalog text -> GHD logical plan (``core.compile``),
     with the cost-based plan search (``core.plan_search``) on by default;
  2. code generation — physical plan -> executable joins (``core.codegen``
     emits Python source; the plan interpreter in ``core.executor`` is the
     differential-testing twin);
  3. execution engine — vectorized worst-case-optimal joins with
     layout/algorithm decisions made from data characteristics.

**Backend selection**: ``Engine(backend="numpy")`` (the default) is the
host oracle; ``Engine(backend="device")`` keeps trie levels
device-resident, runs each bag's extension chain on the device with one
closing transfer, and dispatches terminal-fold intersections to the
layout-cohort CUDA kernels.  The device backend runs on ``cuda`` unless
``device=`` names another device (``device="cpu"`` runs every kernel's
plain PyTorch version — the tests use it).  One backend instance lives per
Engine, so multi-rule programs reuse its device-resident uploads;
``Engine.dispatch_summary()`` reports which kernel handled each
intersection.

Recursive (Kleene-star) rules are not part of this port yet.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core import codegen as codegen_mod
from repro_torch.core import plan_ir
from repro_torch.core import plan_search as plan_search_mod
from repro_torch.core.backend import ExecBackend, make_backend
from repro_torch.core.compile import QueryPlan, compile_rule, parameterize
from repro_torch.core.datalog import AggRef, Param, Rule, eval_expr, parse
from repro_torch.core.executor import BagResultCache, Catalog, Executor
from repro_torch.core.gj import GJResult
from repro_torch.core.statistics import StatisticsCatalog
from repro_torch.core.trie import Trie

RECURSION_TODO = ("recursive rules are not ported yet "
                  "(ROADMAP, queue 1: recursion with spmv_ell)")


@dataclasses.dataclass
class QueryResult:
    vars: Tuple[str, ...]
    columns: Dict[str, np.ndarray]
    annotation: Optional[np.ndarray]

    @staticmethod
    def from_gj(res: GJResult) -> "QueryResult":
        return QueryResult(res.vars,
                           {k: np.asarray(v) for k, v in res.columns.items()},
                           np.asarray(res.annotation)
                           if res.annotation is not None else None)

    @property
    def num_rows(self) -> int:
        if self.vars:
            return len(self.columns[self.vars[0]])
        return 1

    def scalar(self):
        assert not self.vars, f"not a scalar result: vars={self.vars}"
        return self.annotation


@dataclasses.dataclass
class PreparedQuery:
    """A single rule compiled once, selection constants as bind slots.

    ``rule`` carries ``Const(Param(slot))`` placeholders (one slot per
    distinct constant in the source text, first-appearance order) and
    ``defaults`` the constants they replaced.  Because ``repr(rule)`` is
    binding-independent, every compile-side cache — logical plan, plan
    search decision, physical plan + emitted source — is shared across
    bindings: re-binding performs zero plan searches.
    """

    engine: "Engine"
    rule: Rule
    defaults: Tuple[object, ...]

    def _binding(self, params: Tuple) -> Tuple:
        if not params:
            return tuple(self.defaults)
        if len(params) != len(self.defaults):
            raise ValueError(
                f"expected {len(self.defaults)} parameters "
                f"(defaults {self.defaults}), got {len(params)}")
        return tuple(params)

    def run(self, *params) -> QueryResult:
        binding = self._binding(params)
        enc = self.engine._binding_encode(binding)
        return self.engine._eval_rule(self.rule, materialize=False,
                                      encode=enc)

    __call__ = run


class Engine:
    """Public API: load relations, run datalog programs."""

    def __init__(self, use_ghd: bool = True, use_codegen: bool = True,
                 backend=None, device=None, plan_search: bool = True):
        self.catalog = Catalog()
        self.use_ghd = use_ghd
        self.use_codegen = use_codegen
        # backend: ExecBackend | "numpy" | "device" | None (numpy);
        # ``device`` places a named device backend (default cuda)
        self.backend: ExecBackend = make_backend(backend, device=device)
        # cost-based GHD + attribute-order search (core.plan_search);
        # False pins the seed appearance-order plan
        self.plan_search = bool(plan_search)
        self.dictionary: Dict[object, int] = {}
        self.last_plan: Optional[QueryPlan] = None
        self.last_physical: Optional[plan_ir.PhysicalPlan] = None
        self.last_source: Optional[str] = None
        # plan cache: the GHD search is brute-force (NP-hard in #attrs) and
        # the paper excludes compilation from query timing — repeated
        # queries reuse the compiled plan
        self._plan_cache: Dict[Tuple[str, bool], QueryPlan] = {}
        # plan-SEARCH decision cache: the chosen (GHD, order) per rule,
        # made once per engine from the statistics at first execution
        self._search_cache: Dict[Tuple, Tuple] = {}
        # physical-plan (+ emitted codegen) cache, keyed additionally on
        # catalog versions: re-plans when the data a rule reads changes
        self._physical_cache: Dict[Tuple, Tuple] = {}
        # statistics catalog: sampled per-trie profiles driving the plan
        # IR's cardinality estimates and Algorithm-3 layout thresholds
        self.stats_catalog = StatisticsCatalog()
        # engine-lifetime Appendix-A.1 bag cache: sub-bags shared across
        # rules are computed once (version-invalidated)
        self.bag_cache = BagResultCache()
        # per-query() optimizer scorecard: one metadata dict per rule run
        self._program_metadata: List[dict] = []

    # ----------------------------------------------------------------- load
    def load_edges(self, name: str, src, dst, annotation=None):
        src = np.asarray(src)
        dst = np.asarray(dst)
        t = Trie.build(name, ("c0", "c1"), [src, dst], annotation=annotation)
        self.catalog.add(name, t)
        return t

    def alias(self, name: str, target: str):
        self.catalog.alias(name, target)

    def set_dictionary(self, mapping: Dict[object, int]):
        self.dictionary = dict(mapping)

    def encode(self, value) -> int:
        if isinstance(value, (int, np.integer)):
            return int(value)
        return int(self.dictionary[value])

    def _binding_encode(self, binding: Tuple):
        """Encode closure resolving ``Param`` slots against ``binding``.

        Carries ``binding_key`` so runtime result-reuse keys (the
        engine-lifetime bag cache) distinguish bindings even though the
        parameterized rule's STRUCTURAL keys are binding-invariant."""
        base = self.encode

        def enc(value):
            if isinstance(value, Param):
                return base(binding[value.slot])
            return base(value)

        enc.binding_key = tuple(binding)
        return enc

    # ---------------------------------------------------------------- query
    def query(self, text: str) -> QueryResult:
        """Run a datalog program; returns the result of the LAST head."""
        prog = parse(text)
        if any(rule.recursion is not None for rule in prog.rules):
            raise NotImplementedError(RECURSION_TODO)
        self._program_metadata = []
        result: Optional[QueryResult] = None
        for rule in prog.rules:
            result = self._eval_rule(rule, materialize=True)
        assert result is not None, "empty program"
        return result

    def prepare(self, text: str) -> PreparedQuery:
        """Compile ONE non-recursive rule with its selection constants
        rewritten into bind parameters (``compile.parameterize``); the
        returned :class:`PreparedQuery` re-binds without recompiling."""
        prog = parse(text)
        if len(prog.rules) != 1:
            raise ValueError("prepare() takes exactly one rule")
        rule = prog.rules[0]
        if rule.recursion is not None:
            raise NotImplementedError(RECURSION_TODO)
        rule_p, defaults = parameterize(rule)
        self._compile(rule_p)
        return PreparedQuery(self, rule_p, defaults)

    def generated_source(self) -> Optional[str]:
        return self.last_source

    def dispatch_summary(self) -> Dict[str, int]:
        """Instrumentation counters: which kernel handled each intersection
        (``intersect.*`` count pairs), extension-loop host-sync discipline
        (``extend.calls`` vs ``extend.host_syncs`` vs
        ``extend.closing_syncs``), pipeline launches and fill chunks,
        device uploads, statistics-driven layout routing
        (``layout.stats_driven`` / ``layout.threshold_bits``),
        engine-lifetime bag-cache traffic and reorder-index builds."""
        out = self.backend.dispatch_summary()
        out["bag_cache.hits"] = self.bag_cache.hits
        out["bag_cache.misses"] = self.bag_cache.misses
        out["reorder_cache.builds"] = self.catalog.reorder_builds
        out["reorder_cache.hits"] = self.catalog.reorder_hits
        return out

    def plan_metadata(self) -> List[dict]:
        """Optimizer choices of the last ``query()`` call: one record per
        executed rule — fhw, attribute order, per-operator estimated vs
        actual cardinalities (plus the geometric-mean q-error scorecard in
        ``est_error``), terminal-fold routing and layout thresholds, and
        the cost-based search verdict in ``plan_search``."""
        return list(self._program_metadata)

    # ------------------------------------------------------------ internals
    def _compile(self, rule: Rule) -> QueryPlan:
        key = (repr(rule), self.use_ghd)
        plan = self._plan_cache.get(key)
        if plan is None:
            self.backend.stats["compile.logical_compiles"] += 1
            plan = compile_rule(rule, use_ghd=self.use_ghd)
            if plan.semiring is not None and plan.needs_top_down:
                plan = compile_rule(rule, use_ghd=False)
            self._plan_cache[key] = plan
        else:
            self.backend.stats["compile.plan_cache_hits"] += 1
        self.last_plan = plan
        return plan

    def _physical(self, plan: QueryPlan):
        """Physical plan (+ emitted source) for ``plan`` against the
        CURRENT catalog contents, cached on (rule, use_ghd, use_codegen,
        plan_search, catalog versions of the body relations).  With the
        plan search on, the first execution of a rule runs the full
        candidate search; the chosen logical plan is pinned in
        ``_search_cache`` so later executions only re-annotate it."""
        rels = tuple(sorted({a.rel for a in plan.rule.body}))
        key = (repr(plan.rule), self.use_ghd, self.use_codegen,
               self.plan_search, self.catalog.version_key(rels))
        hit = self._physical_cache.get(key)
        if hit is None:
            self.backend.stats["compile.physical_builds"] += 1
            search_md = None
            if self.plan_search:
                dkey = (repr(plan.rule), self.use_ghd)
                decided = self._search_cache.get(dkey)
                if decided is None:
                    self.backend.stats["compile.plan_searches"] += 1
                    sr = plan_search_mod.search(
                        plan, self.stats_catalog, self.catalog,
                        bag_cache=self.bag_cache, use_ghd=self.use_ghd)
                    decided = (sr.chosen, sr.metadata())
                    if len(self._search_cache) >= 256:
                        self._search_cache.pop(
                            next(iter(self._search_cache)))
                    self._search_cache[dkey] = decided
                    pplan = sr.physical
                else:
                    pplan = plan_ir.build_physical_plan(
                        decided[0], self.stats_catalog, self.catalog)
                search_md = decided[1]
            else:
                pplan = plan_ir.build_physical_plan(plan, self.stats_catalog,
                                                    self.catalog)
            fn = src = None
            if self.use_codegen:
                fn, src = codegen_mod.emit(pplan)
            if len(self._physical_cache) >= 256:
                self._physical_cache.pop(next(iter(self._physical_cache)))
            hit = self._physical_cache[key] = (pplan, fn, src, search_md)
        else:
            self.backend.stats["compile.physical_cache_hits"] += 1
        return hit

    def _execute(self, plan: QueryPlan, encode=None) -> GJResult:
        pplan, fn, src, search_md = self._physical(plan)
        self.last_physical = pplan
        enc = encode if encode is not None else self.encode
        metrics: Dict[int, dict] = {}
        if self.use_codegen:
            self.last_source = src
            res = fn(self.catalog, enc, self.backend,
                     bag_cache=self.bag_cache, metrics=metrics)
        else:
            ex = Executor(self.catalog, enc, backend=self.backend,
                          bag_cache=self.bag_cache,
                          stats_catalog=self.stats_catalog)
            res = ex.run(pplan)
            metrics = ex.metrics
        md = pplan.metadata()
        for bag in md["bags"]:
            m = metrics.get(bag["op_id"])
            if m is None:
                continue
            bag["actual_rows"] = int(m["actual_rows"])
            # per-extension estimated-vs-actual frontier sizes
            actuals = dict(m.get("level_actuals") or [])
            for step in bag["steps"]:
                if step["var"] in actuals:
                    step["actual_rows"] = int(actuals[step["var"]])
        md["plan_search"] = (search_md if search_md is not None
                             else {"enabled": False})
        md["est_error"] = _est_error(md["bags"])
        self._program_metadata.append(md)
        return res

    def _eval_rule(self, rule: Rule, materialize: bool,
                   encode=None) -> QueryResult:
        agg = rule.agg
        if agg is not None and agg.op == "count" and agg.arg != "*":
            res = self._eval_count_distinct(rule, agg, encode=encode)
        else:
            plan = self._compile(rule)
            res = QueryResult.from_gj(self._execute(plan, encode=encode))
        if materialize:
            self._materialize_head(rule, res)
        return res

    def _eval_count_distinct(self, rule: Rule, agg: AggRef,
                             encode=None) -> QueryResult:
        """COUNT(v) = number of DISTINCT v per output group: evaluate the
        body with output keyvars+{v} under set semantics, then group-count."""
        ext_out = tuple(rule.head.keyvars) + ((agg.arg,)
                                              if agg.arg not in rule.head.keyvars else ())
        sub = dataclasses.replace(
            rule,
            head=dataclasses.replace(rule.head, keyvars=ext_out),
            agg_expr=None)
        plan = self._compile(sub)
        res = self._execute(plan, encode=encode)
        keyvars = tuple(rule.head.keyvars)
        if not keyvars:
            count = np.asarray(res.num_rows, dtype=np.int64)
            value = eval_expr(rule.agg_expr, count, self.catalog.scalars)
            return QueryResult((), {}, np.asarray(value))
        keys = np.stack([np.asarray(res.columns[v]) for v in keyvars], axis=1)
        uniq, inv = np.unique(keys, axis=0, return_inverse=True)
        counts = np.bincount(inv, minlength=len(uniq))
        value = eval_expr(rule.agg_expr, counts, self.catalog.scalars)
        cols = {v: uniq[:, i].astype(np.int32) for i, v in enumerate(keyvars)}
        return QueryResult(keyvars, cols, np.asarray(value))

    def _materialize_head(self, rule: Rule, res: QueryResult):
        name = rule.head.rel
        if not rule.head.keyvars:
            if res.annotation is not None:
                self.catalog.scalars[name] = np.asarray(res.annotation).item() \
                    if np.asarray(res.annotation).ndim == 0 else res.annotation
            return
        cols = [res.columns[v] for v in rule.head.keyvars]
        t = Trie.build(name, tuple(rule.head.keyvars), cols,
                       annotation=res.annotation)
        self.catalog.add(name, t)


def _est_error(bags: List[dict]) -> dict:
    """Optimizer scorecard: geometric-mean q-error (max(est,act)/min, >=1)
    of the per-bag cardinality estimates against the recorded actuals."""
    qs = []
    for bag in bags:
        actual = bag.get("actual_rows")
        if actual is None:
            continue
        est = max(float(bag["est_rows"]), 1.0)
        act = max(float(actual), 1.0)
        qs.append(max(est, act) / min(est, act))
    if not qs:
        return {"n_bags": 0, "geo_mean_q": None}
    return {"n_bags": len(qs),
            "geo_mean_q": float(np.exp(np.mean(np.log(qs))))}
