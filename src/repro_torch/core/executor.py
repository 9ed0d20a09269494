"""Physical plan execution: Yannakakis over GHD bags (paper Section 3.3).

The executor is the *interpreter lowering* of the physical plan IR
(``core.plan_ir``) — the differential-testing oracle for the code
generator (``core.codegen``), which lowers the SAME IR to straight-line
source.  Neither lowering re-derives a physical decision: access paths,
layout thresholds, routing hints, and reuse keys are read off the IR.

Two phases, exactly as the paper describes:

  * **Within a node** — each bag runs the generic worst-case optimal join
    (``core.gj.GenericJoin``) over its relations, with early aggregation
    folding away attributes not retained above the bag.
  * **Across nodes** — a bottom-up pass (reverse level order): each bag
    passes its result projected onto the attributes shared with its parent
    ("Between nodes (t0, t1) we pass the relations projected onto the
    shared attributes chi(t0) cap chi(t1)"). For aggregate queries whose
    outputs live in the root, the annotation rides along and the top-down
    pass is elided (Appendix A.1). For listing queries, the final result
    is assembled by joining the reduced bag results (the "top-down walk"
    as one acyclic worst-case-optimal join) — the IR's ``TopDownJoin``
    operator, whose inputs reference every reduced bag structurally.

Appendix A.1 "Eliminating Redundant Work" operates at two scopes:

  * per-query: structurally equivalent bags (``BagPlan.dedup_key``) are
    computed once — the 2x saving on the Barbell query;
  * engine-lifetime: :class:`BagResultCache` keys a bag's result on its
    canonicalized structure PLUS the catalog versions of every relation
    its subtree reads (``MaterializeShared.reuse_struct/reuse_rels``), so
    shared sub-bags recur across *rules and iterations* without being
    recomputed, and are invalidated the moment an input relation is
    reloaded.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.compile import QueryPlan
from repro_torch.core.datalog import eval_expr
from repro_torch.core.gj import GenericJoin, GJResult
from repro_torch.core.trie import Trie

# backend dispatch counters snapshotted around each bag run; "syncs" in
# per-bag metrics is the delta of these (the zero-host-sync invariant is
# stated and gated per query, not per process)
_SYNC_KEYS = ("extend.calls", "extend.host_syncs", "extend.closing_syncs",
              "extend.pipeline_extends", "pipeline.device_folds",
              "pipeline.retries", "pipeline.morsels")


@dataclasses.dataclass
class ExecStats:
    bags_run: int = 0
    bags_deduped: int = 0          # per-query structural dedup (Appendix A.1)
    bags_cached: int = 0           # engine-lifetime BagResultCache hits
    intersect_rows: int = 0


class Catalog:
    """Relation storage: base tries + reorder cache + aliases.

    Every ``add`` bumps the relation's version counter; engine-lifetime
    bag-result reuse keys include these versions, so reloading a relation
    (or a recursion round rebuilding its delta) invalidates exactly the
    cached results that read it.
    """

    def __init__(self):
        self.tries: Dict[str, Trie] = {}
        self.aliases: Dict[str, str] = {}
        self._reordered: Dict[Tuple[str, Tuple[int, ...]], Trie] = {}
        self.scalars: Dict[str, object] = {}
        self.versions: Dict[str, int] = {}
        # reorder-cache instrumentation: ``reorder_builds`` counts REAL
        # index builds (a non-identity permutation materialized+rebuilt).
        # The plan search costs candidates from base-trie profiles, so
        # discarded candidates must build nothing — the engine surfaces
        # these as ``reorder_cache.*`` in ``dispatch_summary()`` and the
        # tests assert on them.
        self.reorder_builds = 0
        self.reorder_hits = 0

    def add(self, name: str, trie: Trie):
        self.tries[name] = trie
        self.versions[name] = self.versions.get(name, 0) + 1
        self._reordered = {k: v for k, v in self._reordered.items()
                           if k[0] != name}

    def alias(self, name: str, target: str):
        self.aliases[name] = target

    def resolve(self, name: str) -> str:
        seen = set()
        while name in self.aliases:
            assert name not in seen, f"alias cycle at {name}"
            seen.add(name)
            name = self.aliases[name]
        return name

    def get(self, name: str) -> Trie:
        return self.tries[self.resolve(name)]

    def __contains__(self, name: str) -> bool:
        return self.resolve(name) in self.tries

    def version(self, name: str) -> int:
        return self.versions.get(self.resolve(name), 0)

    def version_key(self, names: Tuple[str, ...]) -> Tuple:
        """(resolved name, version) per relation — the data-identity half
        of an engine-lifetime bag reuse key (generated code calls this at
        run time so stale emitted keys are impossible)."""
        return tuple((self.resolve(n), self.version(n)) for n in names)

    def reordered(self, name: str, perm: Tuple[int, ...]) -> Trie:
        """Trie for ``name`` with columns permuted by ``perm`` (an index
        order; paper Section 2.2 "Column (Index) Order")."""
        base_name = self.resolve(name)
        key = (base_name, perm)
        if key not in self._reordered:
            base = self.tries[base_name]
            attrs = [base.attrs[p] for p in perm]
            built = base.reorder(attrs)
            if built is not base:
                self.reorder_builds += 1
            self._reordered[key] = built
        else:
            self.reorder_hits += 1
        return self._reordered[key]


class BagResultCache:
    """Engine-lifetime Appendix-A.1 cache: bag reuse key -> GJResult.

    Bounded FIFO (recursion bumps relation versions every round, so stale
    keys age out instead of accumulating). Results are treated as
    immutable by every consumer.
    """

    def __init__(self, maxsize: int = 256):
        self.maxsize = maxsize
        self._data: Dict[Tuple, GJResult] = {}
        self.hits = 0
        self.misses = 0

    def get(self, key: Tuple) -> Optional[GJResult]:
        res = self._data.get(key)
        if res is None:
            self.misses += 1
        else:
            self.hits += 1
        return res

    def contains(self, key: Tuple) -> bool:
        """Peek WITHOUT touching the hit/miss counters — the plan search
        costs cached bags at zero but must not distort the instrumentation
        the benchmarks assert on."""
        return key in self._data

    def put(self, key: Tuple, res: GJResult):
        if len(self._data) >= self.maxsize:
            self._data.pop(next(iter(self._data)))
        self._data[key] = res

    def __len__(self) -> int:
        return len(self._data)


class Executor:
    """Interpreter lowering of the physical plan IR."""

    def __init__(self, catalog: Catalog,
                 encode: Optional[Callable[[object], int]] = None,
                 backend=None,
                 bag_cache: Optional[BagResultCache] = None,
                 stats_catalog=None):
        self.catalog = catalog
        self.encode = encode or (lambda v: int(v))
        self.backend = backend  # None -> GenericJoin resolves the default
        self.bag_cache = bag_cache
        self.stats_catalog = stats_catalog
        self.stats = ExecStats()
        # per-run optimizer scorecard: materialize op id -> {est, actual}
        self.metrics: Dict[int, dict] = {}

    # ------------------------------------------------------------------ api
    def run(self, plan) -> GJResult:
        """Execute a PhysicalPlan (or a QueryPlan, annotated on the fly)."""
        from repro_torch.core import plan_ir
        from repro_torch.core.statistics import StatisticsCatalog
        if isinstance(plan, QueryPlan):
            pplan = plan_ir.build_physical_plan(
                plan, self.stats_catalog or StatisticsCatalog(),
                self.catalog)
        else:
            pplan = plan
        lplan = pplan.logical

        self.stats = ExecStats()
        self.metrics = {}
        dedup_cache: Dict[Tuple, GJResult] = {}
        aggregate = lplan.semiring is not None
        if aggregate and lplan.needs_top_down:
            raise ValueError(
                "aggregate outputs must live in the root bag; recompile "
                "with use_ghd=False (engine does this automatically)")

        results: Dict[int, GJResult] = {}   # materialize op id -> result
        for bops in pplan.bag_ops:          # bottom-up: children first
            out_vars = bops.materialize.output_vars
            key = bops.logical.dedup_key
            if key in dedup_cache:
                self.stats.bags_deduped += 1
                res = rename_result(dedup_cache[key], out_vars)
            else:
                ck = self._reuse_key(bops.materialize)
                res = self.bag_cache.get(ck) if self.bag_cache else None
                if res is not None:
                    self.stats.bags_cached += 1
                    res = rename_result(res, out_vars)
                else:
                    res, level_actuals, syncs = self._run_bag(
                        bops, results, aggregate, lplan)
                    self.stats.bags_run += 1
                    if self.bag_cache is not None:
                        self.bag_cache.put(ck, res)
                    self.metrics[bops.materialize.op_id] = {
                        "est_rows": float(bops.materialize.est_rows),
                        "actual_rows": int(res.num_rows),
                        "level_actuals": level_actuals,
                        "syncs": syncs,
                    }
                dedup_cache[key] = res
            results[bops.materialize.op_id] = res
            self.metrics.setdefault(bops.materialize.op_id, {
                "est_rows": float(bops.materialize.est_rows),
                "actual_rows": int(res.num_rows),
            })

        root_res = results[pplan.root.materialize.op_id]
        if pplan.final is None:
            final = root_res
        else:
            final = self._final_join(pplan, results)
        return self._apply_expr(lplan, final)

    # ------------------------------------------------------------ internals
    def _reuse_key(self, mat) -> Tuple:
        # Parameterized rules (Engine.prepare) share one reuse_struct
        # across bindings — Param slots, not values, live in the dedup
        # key — so the binding itself must join the runtime key or
        # binding A's cached rows would answer binding B. Unparameterized
        # encodes carry no binding_key and contribute ().
        return (mat.reuse_struct,
                getattr(self.encode, "binding_key", ()),
                self.catalog.version_key(mat.reuse_rels))

    def _run_bag(self, bops, results: Dict[int, GJResult],
                 aggregate: bool, lplan: QueryPlan) -> GJResult:
        gj_atoms: List[Tuple[Trie, Tuple[str, ...]]] = []
        selections: Dict[int, Dict[int, int]] = {}
        for acc in bops.scan.accesses:
            sel = acc.selection_map(self.encode)
            if sel:
                selections[len(gj_atoms)] = sel
            gj_atoms.append((self.catalog.reordered(acc.rel, acc.perm),
                             acc.vars))
        for ci in bops.scan.child_inputs:
            t = _result_to_trie(results[ci.op_id], ci.vars,
                                keep_annotation=aggregate)
            gj_atoms.append((t, ci.vars))

        semiring = lplan.semiring if aggregate else None
        gj = GenericJoin(gj_atoms, bops.scan.var_order,
                         bops.materialize.output_vars,
                         semiring=semiring, selections=selections,
                         backend=self.backend, hints=bops.hints())
        # per-bag host-sync accounting: the zero-sync invariant is
        # per-query, so the bench artifact needs the delta, not the
        # backend's process-cumulative counters
        snap = {k: gj.backend.stats.get(k, 0) for k in _SYNC_KEYS}
        res = gj.run()
        syncs = {k: gj.backend.stats.get(k, 0) - snap[k]
                 for k in _SYNC_KEYS}
        self.stats.intersect_rows += res.num_rows
        return res, gj.level_actuals, syncs

    def _final_join(self, pplan, results: Dict[int, GJResult]) -> GJResult:
        """The IR's TopDownJoin: one acyclic WCO join over the reduced bag
        results, inputs referenced structurally by operator id."""
        td = pplan.final
        atoms: List[Tuple[Trie, Tuple[str, ...]]] = []
        for op_id in td.inputs:
            res = results[op_id]
            t = _result_to_trie(res, res.vars, keep_annotation=False)
            atoms.append((t, res.vars))
        gj = GenericJoin(atoms, td.var_order, td.output_vars, semiring=None,
                         backend=self.backend)
        return gj.run()

    def _apply_expr(self, plan: QueryPlan, res: GJResult) -> GJResult:
        return apply_expr(plan, res, self.catalog.scalars)


def apply_expr(plan: QueryPlan, res: GJResult, scalars: Dict) -> GJResult:
    """Evaluate the rule's annotation expression around the folded
    aggregate (e.g. ``y = 0.15 + 0.85*<<SUM(z)>>`` or ``y = 1/N``)."""
    expr = plan.rule.agg_expr
    if expr is None:
        return res
    agg_value = res.annotation
    if plan.semiring is None:
        # pure expression (no aggregation): one value per output tuple
        n = res.num_rows
        value = eval_expr(expr, None, scalars)
        ann = np.full((n,), value, dtype=np.float32) if res.vars else \
            np.asarray(value, dtype=np.float32)
        return GJResult(res.vars, res.columns, ann)
    value = eval_expr(expr, np.asarray(agg_value), scalars)
    return GJResult(res.vars, res.columns, np.asarray(value))


def rename_result(res: GJResult, vars_: Tuple[str, ...]) -> GJResult:
    """Re-label a reused bag result with this occurrence's variable names.

    Equivalent bags match on a variable-CANONICALIZED key, so a hit may
    carry the other occurrence's names (Barbell: the (x,y,z) triangle's
    result reused for (a,b,c)); the canonical output key guarantees
    positional correspondence. Columns are shared, never copied."""
    if res.vars == tuple(vars_):
        return res
    assert len(res.vars) == len(vars_), (res.vars, vars_)
    cols = {t: res.columns[s] for s, t in zip(res.vars, vars_)}
    return GJResult(tuple(vars_), cols, res.annotation)


def _result_to_trie(res: GJResult, vars_: Tuple[str, ...],
                    keep_annotation: bool) -> Trie:
    """Materialize a bag result as a trie over ``vars_`` (a subsequence of
    ``res.vars``), folding the annotation by summation is NOT done here —
    annotations are already folded by the bag's own projection."""
    assert set(vars_) <= set(res.vars), (vars_, res.vars)
    cols = [np.asarray(res.columns[v]) for v in vars_]
    ann = np.asarray(res.annotation) if (keep_annotation and
                                         res.annotation is not None) else None
    if vars_ != res.vars and ann is not None:
        # project with fold happens in the bag itself; reaching here with a
        # strict subset + annotation would double-count.
        raise AssertionError("annotated pass-up must use the bag's own "
                             "output projection")
    if not vars_:
        return Trie.build("@res", ("_",), [np.zeros(0, np.int32)])
    return Trie.build("@res", vars_, cols, annotation=ann)
