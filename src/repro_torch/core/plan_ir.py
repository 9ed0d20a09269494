"""Typed physical plan IR between ``compile.QueryPlan`` and execution.

The logical plan (rule -> hypergraph -> GHD, ``core.compile``) says *what*
to join; this module decides *how*, once, in one place.  A
:class:`PhysicalPlan` is an explicit operator DAG —

  * :class:`BagScan` — the physical access paths of one GHD bag: per-atom
    trie reorder permutation + leading equality selections, plus
    structural references to the child bags' materialized results,
  * :class:`Extend` — one Generic-Join attribute extension, annotated with
    the estimated fanout and cumulative cardinality,
  * :class:`TerminalFold` — the early-aggregation fold of the last
    non-retained attribute, annotated with the backend routing hint and
    the statistics-driven Algorithm-3 layout threshold,
  * :class:`MaterializeShared` — the bag's output projection passed up the
    GHD, carrying the engine-lifetime reuse key (Appendix A.1 dedup,
    generalized from per-query to cross-rule/cross-iteration),
  * :class:`TopDownJoin` — the final acyclic join of the reduced bag
    results for listing queries spanning bags, referencing its inputs
    *structurally* by operator id (this is what deleted the old
    ``codegen._bag_names`` source-text scraping).

Both lowerings — the interpreter (``core.executor``, the oracle) and the
code generator (``core.codegen``) — walk this DAG; neither re-derives a
physical decision.  ``GenericJoin`` and the backends consume the
annotations via :class:`BagHints`.  Estimated cardinalities come from the
:class:`~repro_torch.core.statistics.StatisticsCatalog` under an independence
model capped by the bag's AGM bound (``core.agm`` with real relation
sizes), and are written next to the *actual* cardinalities into the
benchmark artifact so optimizer mispredictions are visible per run.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

from repro_torch.core import agm
from repro_torch.core.compile import BagPlan, PlanAtom, QueryPlan
from repro_torch.core.statistics import StatisticsCatalog, TrieStats


# ------------------------------------------------------------ access paths
@dataclasses.dataclass(frozen=True)
class AtomAccess:
    """Physical access path for one atom: which trie index order to use
    (selected positions lead, live vars follow the bag attribute order)
    and the leading equality selections. This logic previously lived
    twice, in ``executor._atom_trie`` and inline in ``codegen``."""

    rel: str
    perm: Tuple[int, ...]                       # column permutation
    vars: Tuple[str, ...]                       # post-perm variable names
    selections: Tuple[Tuple[int, object], ...]  # (post-perm pos, raw const)

    @staticmethod
    def from_plan_atom(a: PlanAtom, var_order: Tuple[str, ...]) -> "AtomAccess":
        order_pos = {v: i for i, v in enumerate(var_order)}
        sel_positions = sorted(a.selections.keys())
        live_positions = [p for p in range(len(a.vars))
                          if p not in a.selections]
        live_positions.sort(key=lambda p: order_pos[a.vars[p]])
        perm = tuple(sel_positions + live_positions)
        vars_ = tuple(a.vars[p] for p in perm)
        sels = tuple((i, a.selections[p]) for i, p in enumerate(sel_positions))
        return AtomAccess(a.rel, perm, vars_, sels)

    @property
    def live_vars(self) -> Tuple[str, ...]:
        return self.vars[len(self.selections):]

    def selection_map(self, encode) -> Dict[int, int]:
        return {i: encode(v) for i, v in self.selections}


@dataclasses.dataclass(frozen=True)
class ChildInput:
    """Structural reference to a child bag's materialized result."""

    op_id: int                  # the child's MaterializeShared op id
    vars: Tuple[str, ...]       # shared attrs, ordered by the parent order


# ------------------------------------------------------------ operator DAG
@dataclasses.dataclass
class PlanOp:
    op_id: int
    est_rows: float             # estimated cardinality after this operator
    cost: float                 # modelled work of this operator (the
    #                             plan-search objective; statistics.py
    #                             cost-model weights, summed by plan_cost)


@dataclasses.dataclass
class BagScan(PlanOp):
    accesses: Tuple[AtomAccess, ...]
    child_inputs: Tuple[ChildInput, ...]
    var_order: Tuple[str, ...]


# Legal routing vocabularies — the cohort dispatch tables in
# ``core.layouts`` / ``core.gj`` only understand these values, and the
# runtime (``core.gj``) understands nothing else.
EXTEND_ROUTINGS = frozenset({"search", "pair_store"})
FOLD_ROUTINGS = frozenset({"search", "pair_kernel"})


@dataclasses.dataclass
class Extend(PlanOp):
    var: str
    n_constraining: int
    est_fanout: float
    # "pair_store" when this materializing extension is a binary self-join
    # the HybridSetStore can serve cohort-routed (bitset extraction for
    # dense pairs); "search" keeps the generic expand-and-probe path.
    routing: str = "search"
    # Zero-sync pipeline annotations (core.backend.DeviceBackend): the
    # stats-informed frontier-buffer allocation target (AGM-capped
    # est_rows with statistics.CAP_HEADROOM slack — the runtime clamps it
    # further to the exact cross-product bound of the live tries) and the
    # stats-chosen morsel (fill-chunk) size.  None = statistics were
    # unavailable; the pipeline then refuses to size a buffer from it.
    frontier_cap: Optional[float] = None
    morsel: Optional[int] = None
    # "bitset" when the pipelined counting pass should also intersect a
    # probe atom's bitset BLOCK directory with the candidate envelope
    # (sideways filtering: prune before expansion, not just clip) —
    # annotated only where the statistics density gate expects the probe
    # level's Algorithm-3 dense cohort to dominate.  None = envelope
    # clipping only.
    sideways: Optional[str] = None


@dataclasses.dataclass
class TerminalFold(PlanOp):
    var: str
    semiring: str
    routing: str                        # "pair_kernel" | "search"
    layout_threshold: Optional[float]   # Algorithm-3 threshold (stats-driven)


@dataclasses.dataclass
class MaterializeShared(PlanOp):
    source: int                          # BagScan op id
    output_vars: Tuple[str, ...]
    keep_annotation: bool
    reuse_struct: Tuple                  # canonicalized structural key
    reuse_rels: Tuple[str, ...]          # relations whose versions gate reuse


@dataclasses.dataclass
class TopDownJoin(PlanOp):
    inputs: Tuple[int, ...]              # MaterializeShared op ids
    var_order: Tuple[str, ...]
    output_vars: Tuple[str, ...]


@dataclasses.dataclass
class BagHints:
    """The IR annotations GenericJoin / the backend consume at run time."""

    layout_threshold: Optional[float] = None
    terminal_routing: Optional[str] = None
    est_rows: Optional[float] = None
    # var -> "pair_store" for materializing extensions routed through the
    # layout store (None/missing var = generic search path)
    extend_routing: Optional[Dict[str, str]] = None
    # var -> stats-informed frontier-buffer allocation target for the
    # zero-sync extension pipeline (Extend.frontier_cap); missing var or
    # None hints disengage the pipeline for that step.
    extend_caps: Optional[Dict[str, float]] = None
    # stats-chosen morsel size for the pipelined fill loop
    morsel: Optional[int] = None
    # var -> "bitset" where the pipelined counting pass should apply
    # sideways bitset-block filtering (Extend.sideways)
    extend_sideways: Optional[Dict[str, str]] = None


@dataclasses.dataclass
class BagOps:
    """One GHD bag's operator pipeline."""

    logical: BagPlan
    scan: BagScan
    steps: Tuple[PlanOp, ...]            # Extend | TerminalFold per attr
    materialize: MaterializeShared

    def hints(self) -> BagHints:
        thr = None
        routing = None
        ext_routing = {}
        ext_caps = {}
        ext_sideways = {}
        morsel = None
        for s in self.steps:
            if isinstance(s, TerminalFold):
                thr = s.layout_threshold
                routing = s.routing
            elif isinstance(s, Extend):
                if s.routing != "search":
                    ext_routing[s.var] = s.routing
                if s.frontier_cap is not None:
                    ext_caps[s.var] = s.frontier_cap
                if s.sideways is not None:
                    ext_sideways[s.var] = s.sideways
                if s.morsel is not None:
                    morsel = s.morsel
        return BagHints(layout_threshold=thr, terminal_routing=routing,
                        est_rows=self.materialize.est_rows,
                        extend_routing=ext_routing or None,
                        extend_caps=ext_caps or None,
                        morsel=morsel,
                        extend_sideways=ext_sideways or None)


@dataclasses.dataclass
class PhysicalPlan:
    logical: QueryPlan
    bag_ops: List[BagOps]                # bottom-up (children first)
    final: Optional[TopDownJoin]         # listing queries spanning bags
    ops: Dict[int, PlanOp]

    @property
    def root(self) -> BagOps:
        return self.bag_ops[-1]

    def pretty(self) -> str:
        lines = [f"physical plan: order={self.logical.order} "
                 f"out={self.logical.output_vars} "
                 f"fhw={self.logical.ghd.width:.3g}"]
        for b in self.bag_ops:
            atoms = ", ".join(f"{a.rel}({','.join(a.vars)})"
                              for a in b.scan.accesses)
            lines.append(f"  bag#{b.scan.op_id} [{atoms}] "
                         f"est_rows={b.materialize.est_rows:.3g}")
            for s in b.steps:
                if isinstance(s, Extend):
                    lines.append(f"    extend {s.var} "
                                 f"fanout~{s.est_fanout:.3g} "
                                 f"rows~{s.est_rows:.3g}")
                else:
                    lines.append(f"    fold {s.var} [{s.semiring}] "
                                 f"route={s.routing} "
                                 f"thr={s.layout_threshold}")
        if self.final is not None:
            lines.append(f"  top-down join over bags "
                         f"{list(self.final.inputs)}")
        return "\n".join(lines)

    def metadata(self) -> dict:
        """JSON-serializable optimizer-choice record (benchmark artifact)."""
        plan = self.logical
        bags = []
        for b in self.bag_ops:
            steps = []
            for s in b.steps:
                if isinstance(s, Extend):
                    steps.append({"op": "extend", "var": s.var,
                                  "est_fanout": float(s.est_fanout),
                                  "est_rows": float(s.est_rows),
                                  "routing": s.routing,
                                  "frontier_cap":
                                      float(s.frontier_cap)
                                      if s.frontier_cap is not None
                                      else None,
                                  "morsel": s.morsel,
                                  "sideways": s.sideways,
                                  "cost": float(s.cost)})
                else:
                    steps.append({"op": "terminal_fold", "var": s.var,
                                  "semiring": s.semiring,
                                  "routing": s.routing,
                                  "cost": float(s.cost),
                                  "layout_threshold":
                                      float(s.layout_threshold)
                                      if s.layout_threshold is not None
                                      else None})
            bags.append({
                "op_id": int(b.materialize.op_id),
                "atoms": [f"{a.rel}({','.join(a.vars)})"
                          for a in b.scan.accesses],
                "var_order": list(b.scan.var_order),
                "output_vars": list(b.materialize.output_vars),
                "est_rows": float(b.materialize.est_rows),
                "cost": float(b.scan.cost + sum(s.cost for s in b.steps)
                              + b.materialize.cost),
                "steps": steps,
            })
        return {
            "head": plan.rule.head.rel,
            "fhw": float(plan.ghd.width),
            "order": list(plan.order),
            "output_vars": list(plan.output_vars),
            "needs_top_down": bool(plan.needs_top_down),
            "search_exhausted": bool(getattr(plan.ghd, "search_exhausted",
                                             False)),
            "num_bags": len(self.bag_ops),
            "est_cost": float(plan_cost(self)),
            "top_down_inputs": (list(map(int, self.final.inputs))
                                if self.final is not None else []),
            "bags": bags,
        }


# ----------------------------------------------------------------- builder
def build_physical_plan(plan: QueryPlan, stats: StatisticsCatalog,
                        catalog, agm_memo: Optional[Dict] = None,
                        profile_tries: bool = True) -> PhysicalPlan:
    """Annotate the logical GHD plan into the physical operator DAG.

    ``catalog`` is the executor's relation catalog — the builder resolves
    each atom's reordered trie through it (the same identity-cached trie
    the lowering will run on) to profile real data.  ``agm_memo`` (an
    optional dict) memoizes the per-bag fractional-cover LPs across
    candidate lowerings of the SAME rule — the plan search lowers dozens
    of candidates whose bags repeat.

    ``profile_tries=False`` profiles each atom from its BASE trie instead
    of resolving ``catalog.reordered`` — candidate COSTING mode for the
    plan search, so discarded candidates never build reordered indexes
    in the engine-lifetime reorder cache (the base profile is the proxy
    for every index order; exact for symmetric relations, an
    approximation otherwise).  Routing hints are decided from
    ``(resolved relation, permutation)`` keys in both modes, which is
    exactly the reorder cache's identity.
    """
    from repro_torch.core import statistics as S
    aggregate = plan.semiring is not None
    counter = [0]
    ops: Dict[int, PlanOp] = {}
    bag_ops: List[BagOps] = []

    def new_id() -> int:
        counter[0] += 1
        return counter[0]

    def reg(op: PlanOp) -> PlanOp:
        ops[op.op_id] = op
        return op

    def build_bag(bp: BagPlan) -> BagOps:
        children = [build_bag(c) for c in bp.children]
        accesses = tuple(AtomAccess.from_plan_atom(a, bp.var_order)
                         for a in bp.atoms)
        atom_keys: List[Optional[Tuple]] = []
        atom_arity: List[Optional[int]] = []
        atom_stats: List[Optional[TrieStats]] = []
        for acc in accesses:
            try:
                base = catalog.get(acc.rel)
            except KeyError:
                atom_keys.append(None)
                atom_arity.append(None)
                atom_stats.append(None)
                continue
            atom_keys.append((catalog.resolve(acc.rel), acc.perm))
            atom_arity.append(base.arity)
            profiled = (catalog.reordered(acc.rel, acc.perm)
                        if profile_tries else base)
            atom_stats.append(stats.stats_for(profiled))

        child_inputs = []
        for cb in children:
            shared = tuple(v for v in bp.var_order
                           if v in set(cb.logical.bag.shared_with_parent))
            child_inputs.append(ChildInput(cb.materialize.op_id, shared))
        child_inputs = tuple(child_inputs)

        scan = reg(BagScan(new_id(), 1.0, 0.0, accesses, child_inputs,
                           bp.var_order))

        agm_cap = _bag_agm_bound(plan, bp, catalog, agm_memo)
        steps: List[PlanOp] = []
        frontier = 1.0
        rows_into_last = 1.0      # frontier entering the final step
        out_domain = 1.0          # product of output-var value universes
        out_domain_known = True
        # live descent state mirrored from GenericJoin: per-input depth
        depth = {i: len(acc.selections) for i, acc in enumerate(accesses)}
        cdepth = {i: 0 for i in range(len(child_inputs))}
        out_set = set(bp.output_vars)
        for vi, v in enumerate(bp.var_order):
            cons: List[Tuple] = []
            advancing_atoms, advancing_children = [], []
            for i, acc in enumerate(accesses):
                live = acc.live_vars
                d = depth[i] - len(acc.selections)
                if d < len(live) and live[d] == v:
                    cons.append((atom_stats[i], depth[i], 0.0))
                    advancing_atoms.append(i)
            for i, ci in enumerate(child_inputs):
                if cdepth[i] < len(ci.vars) and ci.vars[cdepth[i]] == v:
                    child_est = ops[ci.op_id].est_rows
                    cons.append((None, cdepth[i], child_est, len(ci.vars)))
                    advancing_children.append(i)
            fanout, min_cand, max_cand, universe = \
                stats.extension_profile(cons)
            if v in out_set:
                if any(c[0] is not None for c in cons):
                    out_domain *= universe
                else:
                    out_domain_known = False
            rows_into_last = frontier
            frontier = max(frontier * fanout, 1e-9)
            if agm_cap is not None:
                frontier = min(frontier, agm_cap)
            last = vi == len(bp.var_order) - 1
            terminal = aggregate and v not in out_set and last
            if terminal:
                routing, thr = _terminal_routing(
                    accesses, advancing_atoms, advancing_children,
                    atom_keys, atom_arity, atom_stats, depth, stats)
                set_stats = None
                if advancing_atoms:
                    st = atom_stats[advancing_atoms[0]]
                    if st is not None and st.levels:
                        set_stats = st.levels[-1]
                cost = S.fold_cost(rows_into_last, min_cand, max_cand,
                                   len(cons), routing, set_stats, thr,
                                   stats.block_bits)
                steps.append(reg(TerminalFold(
                    new_id(), frontier, cost, v, plan.semiring.name,
                    routing, thr)))
            else:
                ext_routing = _extend_routing(
                    accesses, advancing_atoms, advancing_children,
                    atom_keys, atom_arity, depth)
                # stats-informed allocation target for the zero-sync
                # pipeline's static frontier buffer (AGM-capped estimate
                # with headroom; the runtime clamps to the exact
                # cross-product bound of the live tries).  The buffer is
                # zeroed/scattered whole, so its size is costed — the
                # plan search prefers orders with tighter intermediates.
                cap = min(frontier * S.CAP_HEADROOM,
                          float(S.PIPELINE_MAX_BUFFER))
                sideways = None
                if ext_routing == "search":
                    sideways = _extend_sideways(
                        accesses, advancing_atoms, atom_arity,
                        atom_stats, depth, stats, len(cons))
                cost = (S.extension_cost(rows_into_last, min_cand,
                                         max_cand, len(cons))
                        * (S.SIDEWAYS_COST_CREDIT if sideways else 1.0)
                        + S.buffer_cost(cap))
                steps.append(reg(Extend(new_id(), frontier, cost, v,
                                        len(cons), fanout, ext_routing,
                                        frontier_cap=cap,
                                        sideways=sideways)))
            for i in advancing_atoms:
                depth[i] += 1
            for i in advancing_children:
                cdepth[i] += 1
        # stats-chosen morsel: one bag-wide chunk size scaled to the peak
        # estimated frontier (all of a bag's extension buffers share it)
        ext_steps = [s for s in steps if isinstance(s, Extend)]
        if ext_steps:
            morsel = S.default_morsel(max(s.est_rows for s in ext_steps))
            for s in ext_steps:
                s.morsel = morsel

        # a terminal fold never expands the frontier (it folds the
        # expansion away; support can only shrink rows), so the bag's
        # output estimate is the frontier ENTERING the fold — using the
        # post-fanout value inflated est_rows by the folded attribute's
        # fanout, which the plan search would propagate into the parent
        # bag's candidate model
        est_out = (rows_into_last
                   if steps and isinstance(steps[-1], TerminalFold)
                   else frontier)
        if agm_cap is not None:
            est_out = min(est_out, agm_cap)
        # a bag's output cannot exceed the product of its retained
        # attributes' value universes (distinct-value cap — without it,
        # AGM-inflated intermediate estimates leak into the parent bag's
        # candidate model and distort the plan search)
        if bp.output_vars and out_domain_known:
            est_out = min(est_out, out_domain)
        # projection shape at the bag's end: the frontier holds every
        # extended (non-folded) attribute; extras force a sort-based
        # group-by, scalar aggregates a segment reduce.
        extended = [s.var for s in steps if isinstance(s, Extend)]
        proj_rows = (rows_into_last
                     if steps and isinstance(steps[-1], TerminalFold)
                     else frontier)
        has_extra = bool(bp.output_vars) and bool(
            set(extended) - set(bp.output_vars))
        scalar_out = aggregate and not bp.output_vars
        proj_cost = S.projection_cost(proj_rows, has_extra, scalar_out)
        mat = reg(MaterializeShared(
            new_id(), est_out, proj_cost, scan.op_id, bp.output_vars,
            keep_annotation=aggregate,
            reuse_struct=_resolved_struct(bp.dedup_key, catalog.resolve),
            reuse_rels=tuple(sorted({catalog.resolve(r)
                                     for r in bp.subtree_rels()}))))
        bops = BagOps(bp, scan, tuple(steps), mat)
        # children appended themselves (and their subtrees) already, so the
        # list order is bottom-up: every child precedes its parent.
        bag_ops.append(bops)
        return bops

    root_ops = build_bag(plan.root)

    final = None
    if plan.root.children and not aggregate:
        inputs = tuple(b.materialize.op_id for b in bag_ops
                       if b.materialize.output_vars)
        in_vars = set()
        for b in bag_ops:
            if b.materialize.output_vars:
                in_vars |= set(b.materialize.output_vars)
        var_order = tuple(v for v in plan.order if v in in_vars)
        est = max((ops[i].est_rows for i in inputs), default=1.0)
        td_cost = sum(ops[i].est_rows for i in inputs) * len(inputs)
        final = TopDownJoin(counter[0] + 1, est, td_cost, inputs, var_order,
                            plan.output_vars)
        counter[0] += 1
        ops[final.op_id] = final

    assert bag_ops[-1] is root_ops
    return PhysicalPlan(plan, bag_ops, final, ops)


def plan_cost(pplan: "PhysicalPlan", bag_cache=None, catalog=None) -> float:
    """Total modelled cost of the plan — the plan-search objective.

    Structurally equivalent bags (Appendix A.1 dedup) are counted ONCE,
    and a bag whose engine-lifetime reuse key is already resident in
    ``bag_cache`` costs nothing (memoized bag costing: a candidate that
    reuses work other rules/iterations already paid for is preferred).
    """
    total = 0.0
    seen = set()
    for b in pplan.bag_ops:
        # alias-RESOLVED structural key: the same key the runtime bag cache
        # uses, so Barbell's R,S,T vs R2,S2,T2 triangles (all = Edge) are
        # costed once, exactly as they execute once
        key = b.materialize.reuse_struct
        if key in seen:
            continue
        seen.add(key)
        if (bag_cache is not None and catalog is not None
                and bag_cache.contains(
                    (b.materialize.reuse_struct,
                     catalog.version_key(b.materialize.reuse_rels)))):
            continue
        total += b.scan.cost + sum(s.cost for s in b.steps) \
            + b.materialize.cost
    if pplan.final is not None:
        total += pplan.final.cost
    return total


def _resolved_struct(dedup_key: Tuple, resolve) -> Tuple:
    """``BagPlan.dedup_key`` with relation names resolved through the
    catalog's alias table — so structurally equivalent bags over ALIASES
    of the same relation (Barbell's R,S,T vs R2,S2,T2, all = Edge) share
    one engine-lifetime cache entry."""
    atom_keys, out_key, sr_key, child_keys = dedup_key
    # key=repr: column keys mix canonical ints with ("$", const) selection
    # markers, which Python refuses to order when two atoms tie on the
    # resolved relation name — repr gives a deterministic total order
    atom_keys = tuple(sorted(((resolve(rel), cols)
                              for rel, cols in atom_keys), key=repr))
    child_keys = tuple(sorted((_resolved_struct(c, resolve)
                               for c in child_keys), key=repr))
    return (atom_keys, out_key, sr_key, child_keys)


def _bag_agm_bound(plan: QueryPlan, bp: BagPlan, catalog,
                   memo: Optional[Dict] = None) -> Optional[float]:
    """AGM bound of the bag sub-query with real relation sizes
    (``min prod |R_e|^{x_e}``, paper Eq. 1) — the cap on every estimate.
    ``memo`` (keyed on the variable-canonicalized bag structure) shares
    the LP solves across the plan search's candidate lowerings."""
    key = None
    if memo is not None:
        canon: Dict[str, int] = {}

        def cv(v: str) -> int:
            if v not in canon:
                canon[v] = len(canon)
            return canon[v]

        key = tuple(sorted(
            (catalog.resolve(plan.hg.edges[ei].rel),
             tuple(cv(v) for v in plan.hg.edges[ei].vars))
            for ei in bp.bag.edge_idxs))
        if key in memo:
            return memo[key]
    try:
        log_sizes = {}
        for ei in bp.bag.edge_idxs:
            rel = plan.hg.edges[ei].rel
            log_sizes[ei] = math.log(max(2, catalog.get(rel).num_tuples))
        obj, _x = agm.fractional_cover(plan.hg, list(bp.bag.edge_idxs),
                                       log_sizes)
        out = float(math.exp(min(obj, 700.0)))
    except Exception:
        out = None
    if memo is not None:
        memo[key] = out
    return out


def _pair_self_join(accesses, advancing_atoms, advancing_children,
                    atom_keys, atom_arity, depth) -> bool:
    """True when the advancing atoms are a binary self-join over the SAME
    reordered arity-2 index at depth 1 — ``(resolved relation, perm)``
    equality IS the reorder cache's identity, so this matches the trie
    identity the runtime (``gj._fold_count`` / ``_extend_pair_store``)
    checks, without requiring the index to be built."""
    if advancing_children or len(advancing_atoms) != 2:
        return False
    i, j = advancing_atoms
    a, b = accesses[i], accesses[j]
    return not (atom_keys[i] is None or atom_keys[i] != atom_keys[j]
                or atom_arity[i] != 2
                or a.selections or b.selections
                or depth[i] != 1 or depth[j] != 1)


def _extend_sideways(accesses, advancing_atoms, atom_arity, atom_stats,
                     depth, stats: StatisticsCatalog,
                     n_cons: int) -> Optional[str]:
    """"bitset" when the pipelined counting pass should sideways-filter
    through a probe atom's bitset block directory: some constraining
    arity-2 atom probes its SECOND trie level (depth 1, no selections)
    and the statistics density gate expects its set level to be
    dominated by the Algorithm-3 dense cohort
    (``dense_fraction >= SIDEWAYS_DENSITY_MIN``) — sparse-dominated
    levels would route most rows past the directory, paying the block
    searches for nothing.  Needs >= 2 constraining atoms (the seed
    alone has no probe to filter through)."""
    if n_cons < 2:
        return None
    from repro_torch.core.statistics import (SIDEWAYS_DENSITY_MIN,
                                       dense_fraction, layout_threshold)
    for i in advancing_atoms:
        if (atom_arity[i] != 2 or accesses[i].selections
                or depth[i] != 1):
            continue
        st = atom_stats[i]
        if st is None or len(st.levels) < 2:
            continue
        thr = layout_threshold(st, stats.block_bits)
        if dense_fraction(st.levels[1], thr) >= SIDEWAYS_DENSITY_MIN:
            return "bitset"
    return None


def _extend_routing(accesses, advancing_atoms, advancing_children,
                    atom_keys, atom_arity, depth) -> str:
    """Routing hint for a MATERIALIZING extension: "pair_store" when it is
    a binary self-join over the same reordered arity-2 trie at depth 1 —
    the condition under which ``HybridSetStore.intersect_materialize``
    can serve the expansion cohort-routed (bitset extraction for dense
    pairs) instead of the generic expand-and-probe search."""
    if _pair_self_join(accesses, advancing_atoms, advancing_children,
                       atom_keys, atom_arity, depth):
        return "pair_store"
    return "search"


def _terminal_routing(accesses, advancing_atoms, advancing_children,
                      atom_keys, atom_arity, atom_stats, depth,
                      stats: StatisticsCatalog):
    """Routing hint + statistics-driven layout threshold for the terminal
    fold.  The binary self-join pair-store path (Algorithm-3 cohorts,
    ``HybridSetStore``) applies when exactly two physical atoms resolve to
    the SAME reordered trie (aliases collapse through the catalog) with
    arity 2, no selections, folding at depth 1 — the condition
    ``gj._fold_count`` checks at run time, decided here once from the
    plan."""
    if not _pair_self_join(accesses, advancing_atoms, advancing_children,
                           atom_keys, atom_arity, depth):
        return "search", None
    from repro_torch.core.statistics import layout_threshold
    i = advancing_atoms[0]
    return "pair_kernel", layout_threshold(atom_stats[i], stats.block_bits)
