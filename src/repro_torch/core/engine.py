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

Multi-rule programs evaluate in order; Kleene-star rules run **naive**
recursion (fixed iterations / float tolerance — PageRank) or **seminaive**
recursion, selected automatically "if the aggregation is monotonically
increasing or decreasing with a MIN or MAX operator" (paper Section 3.3 —
SSSP), in which case only the delta relation is re-joined each round.

**Backend selection**: ``Engine()`` and ``Engine(backend="device")`` keep
trie levels device-resident, run each bag's extension chain on the device
with one closing transfer, dispatch terminal-fold intersections to the
layout-cohort CUDA kernels, and run a recursive rule whose body is a
semiring SpMV as one device fixpoint (``core.recursion``).  The device
backend runs on ``cuda`` and raises without a card unless ``device=``
names another device (``device="cpu"`` runs every kernel's plain PyTorch
version — the tests use it).  ``Engine(backend="numpy")`` is the host
oracle.  One backend instance lives per Engine, so multi-rule and
recursive programs reuse its device-resident uploads;
``Engine.dispatch_summary()`` reports which kernel handled each
intersection and how each fixpoint ran.

**Verification**: every lowered physical plan, and every plan-search
candidate, passes the static validator (``repro_torch.analysis``) before
it runs (``verify_plans=True``, the default); ``sanitize=True`` checks
each rule's dispatch counters against its plan after it runs.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import codegen as codegen_mod
from repro_torch.core import plan_ir
from repro_torch.core import plan_search as plan_search_mod
from repro_torch.core import recursion as recursion_mod
from repro_torch.core.backend import ExecBackend, make_backend
from repro_torch.core.compile import QueryPlan, compile_rule, parameterize
from repro_torch.core.datalog import (AggRef, Num, Param, Rule, ScalarRef,
                                      Var, eval_expr, parse)
from repro_torch.core.executor import (BagResultCache, Catalog, Executor,
                                       apply_expr)
from repro_torch.core.gj import GenericJoin, GJResult, run_batched
from repro_torch.core.semiring import AGG_TO_SEMIRING, MAX_MIN, MIN_PLUS, SUM_F32
from repro_torch.core.statistics import StatisticsCatalog
from repro_torch.core.trie import Trie


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

    def as_dict(self) -> Dict[int, object]:
        assert len(self.vars) == 1
        keys = self.columns[self.vars[0]]
        return dict(zip(keys.tolist(), self.annotation.tolist()))


@dataclasses.dataclass
class PreparedQuery:
    """A single rule compiled once, selection constants as bind slots.

    ``rule`` carries ``Const(Param(slot))`` placeholders (one slot per
    distinct constant in the source text, first-appearance order) and
    ``defaults`` the constants they replaced.  Because ``repr(rule)`` is
    binding-independent, every compile-side cache — logical plan, plan
    search decision, physical plan + emitted source — is shared across
    bindings: re-binding performs zero plan searches.

    ``run(*params)`` executes one binding; ``run_batch(bindings)``
    executes many, as ONE batched device launch per
    ``statistics.max_batch`` chunk where the plan shape allows, falling
    back to the sequential per-binding loop (the exact-parity oracle)
    otherwise.  Neither materializes the head relation.
    """

    engine: "Engine"
    rule: Rule
    defaults: Tuple[object, ...]

    @property
    def n_params(self) -> int:
        return len(self.defaults)

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

    def run_batch(self, bindings) -> List[QueryResult]:
        """Execute many bindings; results in submission order.  Each
        entry is a parameter tuple (a bare scalar binds a 1-slot rule)."""
        norm = [self._binding(tuple(b) if isinstance(b, (tuple, list))
                              else (b,)) for b in bindings]
        out = self.engine._execute_batch(self.rule, norm)
        if out is None:
            out = [self.run(*b) for b in norm]
        return out


class Engine:
    """Public API: load relations, run datalog programs."""

    def __init__(self, use_ghd: bool = True, use_codegen: bool = True,
                 backend=None, device=None, plan_search: bool = True,
                 verify_plans: bool = True, sanitize: bool = False):
        self.catalog = Catalog()
        self.use_ghd = use_ghd
        self.use_codegen = use_codegen
        # backend: ExecBackend | "numpy" | "device" | None (device);
        # ``device`` places the device backend (default cuda)
        self.backend: ExecBackend = make_backend(backend, device=device)
        # cost-based GHD + attribute-order search (core.plan_search);
        # False pins the seed appearance-order plan
        self.plan_search = bool(plan_search)
        # static plan verification (repro_torch.analysis.plan_verify) over
        # every lowered plan AND every plan-search candidate
        self.verify_plans = bool(verify_plans)
        # runtime dispatch sanitizer: after each rule execution, assert the
        # backend counters match the validated plan's predictions (off by
        # default — it snapshots the counters per rule)
        self.sanitize = bool(sanitize)
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

    def load_table(self, name: str, columns: Sequence[np.ndarray],
                   annotation=None):
        attrs = tuple(f"c{i}" for i in range(len(columns)))
        t = Trie.build(name, attrs, list(columns), annotation=annotation)
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
        self._program_metadata = []
        result: Optional[QueryResult] = None
        for rule in prog.rules:
            if rule.recursion is not None:
                result = self._eval_recursive(rule)
            else:
                # every head is materialized: later rules read it by
                # name, and a star rule's base rule seeds its fixpoint
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
            raise ValueError("prepare() does not support recursive rules")
        rule_p, defaults = parameterize(rule)
        self._compile(rule_p)
        return PreparedQuery(self, rule_p, defaults)

    def explain(self, text: str) -> str:
        """The logical plan (GHD bags, attribute order) of each rule of
        ``text``, pretty-printed."""
        prog = parse(text)
        out = []
        for rule in prog.rules:
            plan = self._compile(rule)
            out.append(plan.pretty())
        return "\n".join(out)

    def generated_source(self) -> Optional[str]:
        return self.last_source

    def dispatch_summary(self) -> Dict[str, int]:
        """Instrumentation counters: which kernel handled each intersection
        (``intersect.*`` count pairs), extension-loop host-sync discipline
        (``extend.calls`` vs ``extend.host_syncs`` vs
        ``extend.closing_syncs``), pipeline launches and fill chunks,
        device uploads, statistics-driven layout routing
        (``layout.stats_driven`` / ``layout.threshold_bits``),
        engine-lifetime bag-cache traffic, reorder-index builds, and the
        recursion sync discipline (``recursion.device_rounds`` /
        ``recursion.device_fixpoints`` / ``recursion.host_reads`` vs
        ``recursion.host_rounds`` / ``recursion.host_trie_rebuilds``)."""
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
                        bag_cache=self.bag_cache, use_ghd=self.use_ghd,
                        verify=self.verify_plans,
                        counter=self.backend.stats)
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
            if self.verify_plans:
                # static proof obligations on the plan execution is about
                # to consume — the search path verified candidates too;
                # this re-checks the final (re-annotated) lowering
                from repro_torch.analysis import assert_valid
                assert_valid(pplan, self.catalog, self.stats_catalog)
                self.backend.stats["analysis.plans_verified"] += 1
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
        # sanitize: snapshot AFTER planning (verification counters are not
        # execution dispatch) so the delta is exactly this rule's dispatch
        stats_before = dict(self.backend.stats) if self.sanitize else None
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
        if self.sanitize:
            from repro_torch.analysis.kernel_check import check_dispatch
            delta = {k: v - stats_before.get(k, 0)
                     for k, v in self.backend.stats.items()
                     if v != stats_before.get(k, 0)}
            check_dispatch(pplan, delta, metrics, self.backend.name)
            self.backend.stats["analysis.sanitize_checks"] += 1
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

    def _execute_batch(self, rule: Rule,
                       bindings: List[Tuple]) -> Optional[List[QueryResult]]:
        """Batched lowering of a prepared rule: one GenericJoin per
        binding over the SAME physical plan, handed to ``gj.run_batched``
        for batched device execution.  Returns None when the shape is
        outside the batchable envelope — multi-bag plans, top-down joins,
        count-distinct rewrites, host backends — and the caller falls
        back to the sequential per-binding loop, the exact-parity oracle.

        The engine-lifetime bag cache and the dispatch sanitizer are
        bypassed on purpose: per-binding probe results are cheaper to
        recompute than to cache, and the sanitizer's per-rule dispatch
        model does not describe a batched launch.
        """
        agg = rule.agg
        if agg is not None and agg.op == "count" and agg.arg != "*":
            return None
        plan = self._compile(rule)
        pplan, _fn, _src, _md = self._physical(plan)
        if len(pplan.bag_ops) != 1 or pplan.final is not None:
            return None
        bops = pplan.bag_ops[0]
        if bops.scan.child_inputs:
            return None
        lplan = pplan.logical
        joins: List[GenericJoin] = []
        for binding in bindings:
            enc = self._binding_encode(binding)
            gj_atoms = []
            selections: Dict[int, Dict[int, int]] = {}
            for acc in bops.scan.accesses:
                sel = acc.selection_map(enc)
                if sel:
                    selections[len(gj_atoms)] = sel
                gj_atoms.append((self.catalog.reordered(acc.rel, acc.perm),
                                 acc.vars))
            joins.append(GenericJoin(
                gj_atoms, bops.scan.var_order,
                bops.materialize.output_vars, semiring=lplan.semiring,
                selections=selections, backend=self.backend,
                hints=bops.hints()))
        results = run_batched(joins)
        if results is None:
            return None
        return [QueryResult.from_gj(
            apply_expr(lplan, res, self.catalog.scalars))
            for res in results]

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

    # ------------------------------------------------------------ recursion
    def _eval_recursive(self, rule: Rule) -> QueryResult:
        agg = rule.agg
        sr = AGG_TO_SEMIRING[agg.op] if agg is not None else None
        seminaive = sr in (MIN_PLUS, MAX_MIN)
        if seminaive:
            return self._seminaive(rule, sr)
        return self._naive(rule)

    # ----------------------------------------- device-resident fast path
    def _spmv_shape(self, rule: Rule):
        """Recognize the semiring-SpMV recursion shape the device loops
        execute: head ``Rec(h)``, body = ONE binary non-recursive atom
        over {h, r} + the recursive atom ``Rec(r)`` + optional unary
        non-recursive atoms ``A_i(r)``, aggregating over ``r``.  Returns
        ``(edge_atom, unary_atoms, h, r)`` or None (host loop)."""
        if len(rule.head.keyvars) != 1:
            return None
        h = rule.head.keyvars[0]
        agg = rule.agg
        if agg is None or agg.op == "count" or agg.arg in ("*", h):
            return None
        r = agg.arg
        name = self.catalog.resolve(rule.head.rel)
        rec_atoms = [a for a in rule.body
                     if self.catalog.resolve(a.rel) == name]
        if len(rec_atoms) != 1 or rec_atoms[0].terms != (Var(r),):
            return None
        others = [a for a in rule.body if a is not rec_atoms[0]]
        if any(not isinstance(t, Var) for a in others for t in a.terms):
            return None
        binary = [a for a in others if len(a.terms) == 2]
        unary = [a for a in others if len(a.terms) == 1]
        if len(binary) != 1 or len(binary) + len(unary) != len(others):
            return None
        e = binary[0]
        if set(e.vars) != {h, r} or e.rel not in self.catalog \
                or self.catalog.get(e.rel).arity != 2:
            return None
        for a in unary:
            if a.vars != (r,) or a.rel not in self.catalog \
                    or self.catalog.get(a.rel).arity != 1:
                return None
        return e, unary, h, r

    def _recursion_expr_fn(self, rule: Rule):
        """The annotation-expression applier with its scalars as Python
        floats, or None when the expression references something the
        device loop cannot bake in (e.g. a non-scalar "scalar"
        relation)."""
        names = _expr_scalar_names(rule.agg_expr)
        scalars = {}
        for nm in names:
            v = self.catalog.scalars.get(nm)
            if v is None or np.ndim(v) != 0:
                return None
            scalars[nm] = float(v)
        return recursion_mod.ExprFn(rule.agg_expr, scalars)

    def _record_device_recursion(self, rule: Rule, strategy: str,
                                 rounds: int):
        self.backend.stats["recursion.device_fixpoints"] += 1
        self.backend.stats["recursion.device_rounds"] += int(rounds)
        self._program_metadata.append({
            "head": rule.head.rel,
            "recursion": {"mode": "device", "strategy": strategy,
                          "rounds": int(rounds)},
            "bags": [],
            "plan_search": {"enabled": False},
            "est_error": {"n_bags": 0, "geo_mean_q": None},
        })

    def _seminaive_device(self, rule: Rule, sr) -> Optional[QueryResult]:
        """Seminaive recursion as ONE device fixpoint (fixed-shape masked
        delta over the vertex domain, mirroring ``recursion.sssp``)
        instead of a host delta-trie rebuild per round.  Returns None when
        the backend is the host oracle or the rule/data fall outside the
        SpMV shape — the host loop then runs, as in the reference."""
        if self.backend.name != "device":
            return None
        shape = self._spmv_shape(rule)
        if shape is None or shape[1]:   # unary extras: host loop
            return None
        e, _unary, h, r = shape
        apply_expr = self._recursion_expr_fn(rule)
        if apply_expr is None:
            return None
        name = rule.head.rel
        base = self.catalog.get(name)
        keys0 = base.levels[0].values.astype(np.int64)
        if base.annotation is None or len(keys0) == 0:
            return None
        ann0 = np.asarray(base.annotation, dtype=np.float64)
        zero = float(np.asarray(sr.zero))
        if not np.all(ann0 != zero):
            # a base tuple annotated with the semiring zero would be
            # indistinguishable from "underived" in the masked state
            return None
        src, dst, eann = self.catalog.get(e.rel).edge_view()
        gather_v, scatter_v = (src, dst) if e.vars == (r, h) else (dst, src)
        n = int(max(keys0.max(initial=0),
                    gather_v.max(initial=0), scatter_v.max(initial=0))) + 1
        max_rounds = (int(rule.recursion.value)
                      if rule.recursion.kind == "iterations" else 1 << 30)
        keys, ann, rounds = recursion_mod.seminaive_device_fixpoint(
            sr, apply_expr, gather_v, scatter_v, eann, n, keys0, ann0,
            max_rounds, self.backend)
        self._record_device_recursion(rule, "seminaive", rounds)
        keyvars = tuple(rule.head.keyvars)
        keys32 = keys.astype(np.int32)
        self.catalog.add(name, Trie.build(name, keyvars, [keys32],
                                          annotation=ann))
        return QueryResult(keyvars, {keyvars[0]: keys32}, ann)

    def _naive_device(self, rule: Rule, prev_keys: np.ndarray,
                      iters: Optional[int], tol: Optional[float],
                      max_iters: int) -> Optional[QueryResult]:
        """Naive recursion (every annotation rewritten every round) as ONE
        device fixpoint over the FIXED head key set: memberships and
        non-recursive annotation factors are resolved once on host, then
        every round is a gather → ⊗-chain → segment-⨁ → expression
        rewrite with no per-round host read (a tolerance is checked on
        the device, its flag read once per block of rounds)."""
        if self.backend.name != "device":
            return None
        agg = rule.agg
        if agg is None or AGG_TO_SEMIRING.get(agg.op) is not SUM_F32:
            return None
        shape = self._spmv_shape(rule)
        if shape is None:
            return None
        e, unary, h, r = shape
        sr = SUM_F32
        apply_expr = self._recursion_expr_fn(rule)
        if apply_expr is None:
            return None
        name = rule.head.rel
        base = self.catalog.get(name)
        if base.annotation is None or len(prev_keys) == 0:
            return None
        keys = np.asarray(prev_keys, dtype=np.int64)
        ann0 = np.asarray(base.annotation, dtype=np.float64)
        src, dst, eann = self.catalog.get(e.rel).edge_view()
        gather_v, scatter_v = (src, dst) if e.vars == (r, h) else (dst, src)

        def positions(sorted_keys, queries):
            if len(sorted_keys) == 0:
                return (np.zeros(len(queries), np.int64),
                        np.zeros(len(queries), bool))
            pos = np.searchsorted(sorted_keys, queries)
            pos = np.clip(pos, 0, len(sorted_keys) - 1)
            return pos, sorted_keys[pos] == queries

        out_idx, valid = positions(keys, scatter_v)
        rec_idx, ok = positions(keys, gather_v)
        valid = valid & ok
        # ⊗-factors in body-atom order (exactly the fold's mul order)
        factor_kinds: List[str] = []
        gathers: List[np.ndarray] = []
        for a in rule.body:
            if self.catalog.resolve(a.rel) == self.catalog.resolve(name):
                factor_kinds.append("rec")
            elif len(a.terms) == 2:
                if eann is not None:
                    factor_kinds.append("static")
                    gathers.append(np.asarray(eann))
            else:
                t = self.catalog.get(a.rel)
                upos, ok = positions(
                    t.levels[0].values.astype(np.int64), gather_v)
                valid = valid & ok
                if t.annotation is not None:
                    factor_kinds.append("static")
                    gathers.append(np.asarray(t.annotation)[upos])
        out_idx = out_idx[valid]
        rec_idx = rec_idx[valid]
        factor_anns = [g[valid] for g in gathers]
        if iters is None and tol is None:
            iters = max_iters   # bare-star naive: fixed round budget
        ann, rounds = recursion_mod.naive_device_fixpoint(
            sr, apply_expr, out_idx, rec_idx, tuple(factor_kinds),
            factor_anns, len(keys), ann0, iters, tol, max_iters,
            self.backend)
        self._record_device_recursion(rule, "naive", rounds)
        keyvars = tuple(rule.head.keyvars)
        keys32 = keys.astype(np.int32)
        self.catalog.add(name, Trie.build(name, keyvars, [keys32],
                                          annotation=ann))
        return QueryResult(keyvars, {keyvars[0]: keys32}, ann)

    def _naive(self, rule: Rule) -> QueryResult:
        """Naive recursion: re-evaluate the body against the full current
        relation each round (paper: used for PageRank)."""
        rec = rule.recursion
        iters = int(rec.value) if rec.kind == "iterations" else None
        tol = float(rec.value) if rec.kind == "tolerance" else None
        max_iters = iters if iters is not None else 10_000
        name = rule.head.rel
        keyvars = tuple(rule.head.keyvars)
        prev = self.catalog.get(name)
        prev_keys = prev.levels[0].values.copy()
        prev_ann = (prev.annotation.copy() if prev.annotation is not None
                    else None)
        assert len(keyvars) == 1, "naive recursion implemented for unary heads"

        fast = self._naive_device(rule, prev_keys, iters, tol, max_iters)
        if fast is not None:
            return fast

        default = None
        res = None
        for it in range(max_iters):
            self.backend.stats["recursion.host_rounds"] += 1
            res = self._eval_rule(rule_without_star(rule), materialize=False)
            if default is None:
                default = float(eval_expr(rule.agg_expr, np.zeros(1),
                                          self.catalog.scalars)[0]) \
                    if rule.agg_expr is not None else 0.0
            # keys persist across iterations (head keys = initialized keys);
            # missing keys fall back to expr(aggregate == zero).
            new_ann = np.full(len(prev_keys), default, dtype=np.float64)
            if res.num_rows and res.vars:
                lookup = np.searchsorted(prev_keys, res.columns[keyvars[0]])
                lookup = np.clip(lookup, 0, len(prev_keys) - 1)
                hit = prev_keys[lookup] == res.columns[keyvars[0]]
                new_ann[lookup[hit]] = np.asarray(res.annotation)[hit]
            if tol is not None and prev_ann is not None:
                if float(np.max(np.abs(new_ann - prev_ann))) <= tol:
                    prev_ann = new_ann
                    break
            prev_ann = new_ann
            self.backend.stats["recursion.host_trie_rebuilds"] += 1
            t = Trie.build(name, keyvars, [prev_keys], annotation=new_ann)
            self.catalog.add(name, t)
        t = Trie.build(name, keyvars, [prev_keys], annotation=prev_ann)
        self.catalog.add(name, t)
        return QueryResult(keyvars, {keyvars[0]: prev_keys}, prev_ann)

    def _seminaive(self, rule: Rule, sr) -> QueryResult:
        """Seminaive recursion: only the delta (tuples whose annotation
        improved last round) re-joins (paper: used for SSSP)."""
        name = rule.head.rel
        keyvars = tuple(rule.head.keyvars)
        assert len(keyvars) == 1, "seminaive implemented for unary heads"
        fast = self._seminaive_device(rule, sr)
        if fast is not None:
            return fast
        base = self.catalog.get(name)
        keys = base.levels[0].values.copy().astype(np.int64)
        ann = np.asarray(base.annotation, dtype=np.float64).copy()

        rec_atoms = [a for a in rule.body if a.rel == name]
        assert len(rec_atoms) == 1, "exactly one recursive atom supported"
        delta_name = f"@delta_{name}"
        sub = rewrite_atom(rule_without_star(rule), name, delta_name)

        delta_keys, delta_ann = keys, ann
        zero = float(np.asarray(sr.zero))
        max_rounds = int(rule.recursion.value) if \
            rule.recursion.kind == "iterations" else 1 << 30

        rounds = 0
        while len(delta_keys) and rounds < max_rounds:
            rounds += 1
            self.backend.stats["recursion.host_rounds"] += 1
            self.backend.stats["recursion.host_trie_rebuilds"] += 1
            self.catalog.add(delta_name, Trie.build(
                delta_name, keyvars, [delta_keys.astype(np.int32)],
                annotation=delta_ann))
            res = self._eval_rule(sub, materialize=False)
            if not res.num_rows or not res.vars:
                break
            cand_keys = np.asarray(res.columns[sub.head.keyvars[0]],
                                   dtype=np.int64)
            cand_ann = np.asarray(res.annotation, dtype=np.float64)
            # merge candidates into (keys, ann)
            all_keys = np.concatenate([keys, cand_keys])
            all_ann = np.concatenate([ann, cand_ann])
            uniq, inv = np.unique(all_keys, return_inverse=True)
            merged = np.full(len(uniq), zero, dtype=np.float64)
            if sr.name == "min_plus":
                np.minimum.at(merged, inv, all_ann)
            else:
                np.maximum.at(merged, inv, all_ann)
            old = np.full(len(uniq), zero, dtype=np.float64)
            pos = np.searchsorted(uniq, keys)
            old[pos] = ann
            improved = merged != old
            delta_keys = uniq[improved]
            delta_ann = merged[improved]
            keys, ann = uniq, merged
            self.backend.stats["recursion.host_trie_rebuilds"] += 1
            t = Trie.build(name, keyvars, [keys.astype(np.int32)],
                           annotation=ann)
            self.catalog.add(name, t)
        if delta_name in self.catalog.tries:
            del self.catalog.tries[delta_name]
        return QueryResult(keyvars, {keyvars[0]: keys.astype(np.int32)}, ann)


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


def _expr_scalar_names(e) -> set:
    """Scalar-relation names referenced by an annotation expression."""
    if e is None or isinstance(e, (Num, AggRef)):
        return set()
    if isinstance(e, ScalarRef):
        return {e.name}
    return _expr_scalar_names(e.lhs) | _expr_scalar_names(e.rhs)


def rule_without_star(rule: Rule) -> Rule:
    return dataclasses.replace(rule, recursion=None)


def rewrite_atom(rule: Rule, old: str, new: str) -> Rule:
    body = tuple(dataclasses.replace(a, rel=new) if a.rel == old else a
                 for a in rule.body)
    return dataclasses.replace(rule, body=body)
