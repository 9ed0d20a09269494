"""Cost-based plan search: GHD + attribute-order selection (paper §4).

EmptyHeaded's compiler picks the GHD and the global attribute order to
minimize work; until now this reproduction broke every tie by
query-appearance order even though the plan IR carries statistics-driven
cardinality estimates per operator.  This module closes the loop, in the
classic Selinger shape (PAPERS.md: "Access Path Selection in a
Relational DBMS" — enumerate bounded candidates, cost each with the
statistics, pick the cheapest):

  1. **enumerate** — top-k minimum-fhw edge-partition GHDs
     (``ghd.decompose_candidates``; width stays a hard constraint, per
     the paper) x alternate rootings x per-bag attribute-order group
     permutations (``ghd.candidate_orders``).  The FIRST candidate is
     exactly the seed appearance-order plan, and every candidate is
     compiled through the ordinary ``compile.compile_rule``, so a
     candidate IS a real plan.
  2. **cost** — lower each candidate to the physical IR
     (``plan_ir.build_physical_plan``; per-bag fractional-cover LPs
     memoized across candidates) and take ``plan_ir.plan_cost``: the sum
     of per-operator modelled work (AGM-capped independence-model rows,
     ``statistics`` cost-model weights with layout-cohort terms so
     bitset-cohort folds cost less than search-path folds), counting
     Appendix-A.1-equivalent bags once and engine-lifetime-cached bags
     (``BagResultCache``) at zero.
  3. **choose** — strict argmin; ties keep the earliest candidate, so
     symmetric queries reproduce the seed plan bit-for-bit.

``Engine(plan_search=False)`` pins the seed appearance-order plan.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

from repro_torch.core import ghd as ghd_mod
from repro_torch.core import plan_ir
from repro_torch.core.compile import QueryPlan, compile_rule
from repro_torch.core.statistics import StatisticsCatalog

# Search bounds (the "beam"): top-k min-width partitions, alternate roots
# per partition, per-group order permutations, and a global candidate cap.
K_PARTITIONS = 4
MAX_ROOTS = 4
MAX_GROUP_PERM = 4
MAX_ORDERS_PER_GHD = 24
MAX_CANDIDATES = 96


@dataclasses.dataclass
class SearchResult:
    chosen: QueryPlan
    physical: plan_ir.PhysicalPlan
    cost: float
    baseline_cost: float
    candidates: int
    chosen_index: int            # 0 == the seed appearance-order plan
    baseline_order: Tuple[str, ...]

    @property
    def order_changed(self) -> bool:
        return self.chosen.order != self.baseline_order

    def metadata(self) -> dict:
        """JSON-serializable optimizer-search record for
        ``Engine.plan_metadata()`` / the benchmark artifact."""
        return {
            "enabled": True,
            "candidates": int(self.candidates),
            "chosen_index": int(self.chosen_index),
            "chosen_cost": float(self.cost),
            "baseline_cost": float(self.baseline_cost),
            "chosen_order": list(self.chosen.order),
            "baseline_order": list(self.baseline_order),
            "order_changed": bool(self.order_changed),
            "chosen_fhw": float(self.chosen.ghd.width),
        }


def enumerate_candidates(base_plan: QueryPlan,
                         use_ghd: bool = True,
                         k_partitions: int = K_PARTITIONS,
                         max_roots: int = MAX_ROOTS,
                         max_group: int = MAX_GROUP_PERM,
                         max_orders: int = MAX_ORDERS_PER_GHD,
                         max_candidates: int = MAX_CANDIDATES,
                         ) -> List[QueryPlan]:
    """All candidate query plans, the seed ``base_plan`` FIRST.

    Every candidate is compiled via ``compile_rule`` with an injected
    (GHD, order) pair; candidates that an aggregate query cannot execute
    (outputs spanning bags — the executor requires aggregate outputs in
    the root) are filtered out.  Deduplication is on the global order
    plus the GHD's bag/rooting structure, so the seed plan never appears
    twice.
    """
    rule = base_plan.rule
    aggregate = base_plan.semiring is not None
    out_vars = base_plan.output_vars

    def signature(plan: QueryPlan):
        bags = tuple(sorted(
            (tuple(sorted(b.bag.edge_idxs)),
             tuple(sorted(b.bag.shared_with_parent)))
            for b in plan.bags_bottom_up()))
        root = tuple(sorted(plan.root.bag.edge_idxs))
        return (bags, root, plan.order)

    cands: List[QueryPlan] = [base_plan]
    seen = {signature(base_plan)}

    def ghd_sig(g: ghd_mod.GHD):
        bags = tuple(sorted(
            (tuple(sorted(b.edge_idxs)),
             tuple(sorted(b.parent.edge_idxs)) if b.parent else None)
            for b in g.root.walk()))
        return (bags, tuple(sorted(g.root.edge_idxs)))

    # decompose_candidates()[0] is exactly the seed GHD base_plan was
    # compiled with (unless the engine fell back to a single bag), so
    # dedup at GHD level too — otherwise every order of the seed GHD
    # would be compiled twice and dropped only after compilation.
    ghds: List[ghd_mod.GHD] = [base_plan.ghd]
    ghd_seen = {ghd_sig(base_plan.ghd)}
    if use_ghd:
        for g in ghd_mod.decompose_candidates(
                base_plan.hg, out_vars, k=k_partitions,
                max_roots=max_roots):
            gs = ghd_sig(g)
            if gs not in ghd_seen:
                ghd_seen.add(gs)
                ghds.append(g)

    for g in ghds:
        if len(cands) >= max_candidates:
            break
        if aggregate and not set(out_vars) <= set(g.root.attrs):
            continue  # executor requires aggregate outputs in the root
        for order in ghd_mod.candidate_orders(g, out_vars,
                                              max_group=max_group,
                                              limit=max_orders):
            if len(cands) >= max_candidates:
                break
            plan = compile_rule(rule, ghd=g, order=order)
            sig = signature(plan)
            if sig in seen:
                continue
            seen.add(sig)
            cands.append(plan)
    return cands


def search(base_plan: QueryPlan,
           stats: StatisticsCatalog,
           catalog,
           bag_cache=None,
           use_ghd: bool = True,
           **bounds) -> SearchResult:
    """Cost every candidate against the CURRENT catalog statistics and
    return the cheapest (strict argmin — ties keep the seed plan).

    Candidates are lowered in PROFILE mode (``profile_tries=False``):
    every atom is costed from its base trie's statistics, so losing
    candidates leave NO reordered tries in the engine-lifetime reorder
    cache (a K-candidate search used to build up to K×atoms indexes; wide
    relations paid real materialize+sort work for plans that were then
    discarded).  Only the WINNER is re-lowered in full mode — building
    exactly the indexes execution is about to use anyway — which is also
    the plan whose routing annotations the runtime consumes.

    """
    cands = enumerate_candidates(base_plan, use_ghd=use_ghd, **bounds)
    agm_memo: dict = {}
    best = None
    best_cost = None
    best_idx = 0
    baseline_cost = None
    for i, plan in enumerate(cands):
        pplan = plan_ir.build_physical_plan(plan, stats, catalog,
                                            agm_memo=agm_memo,
                                            profile_tries=False)
        cost = plan_ir.plan_cost(pplan, bag_cache, catalog)
        if i == 0:
            baseline_cost = cost
        if best_cost is None or cost < best_cost:
            best, best_cost, best_idx = plan, cost, i
    chosen = best
    physical = plan_ir.build_physical_plan(chosen, stats, catalog,
                                           agm_memo=agm_memo)
    return SearchResult(chosen=chosen, physical=physical,
                        cost=float(best_cost),
                        baseline_cost=float(baseline_cost),
                        candidates=len(cands), chosen_index=best_idx,
                        baseline_order=base_plan.order)
