"""Logical query compilation: rule -> hypergraph -> GHD -> physical plan.

This is the paper's query compiler (Section 3): GHDs replace relational
algebra as the plan representation; the planner decides

  * which GHD (minimum fractional hypertree width, `ghd.decompose`),
  * the global attribute order (pre-order over the GHD, Section 3.2),
  * per-bag output attributes = (shared with parent) + (query outputs in
    the bag) — everything else is folded early with the semiring
    ("Aggregations over GHDs", Section 3.2),
  * whether the top-down Yannakakis pass can be elided (Appendix A.1:
    "if all the attributes appearing in the result also appear in the
    root node"),
  * equivalent-bag sharing keys (Appendix A.1 "Eliminating Redundant
    Work": identical join pattern + identical aggregations/selections +
    identical subtrees).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core import ghd as ghd_mod
from repro_torch.core.datalog import Atom, Const, Param, Rule, Var, expr_agg
from repro_torch.core.ghd import GHD, Bag
from repro_torch.core.hypergraph import Hypergraph
from repro_torch.core.semiring import AGG_TO_SEMIRING, COUNT, Semiring


@dataclasses.dataclass
class PlanAtom:
    """One body atom, normalized for execution."""

    idx: int                      # body position
    rel: str                      # relation name (pre-alias)
    vars: Tuple[str, ...]         # variable per position; "$selK" for consts
    selections: Dict[int, object]  # position -> constant (undecoded)

    @staticmethod
    def from_atom(idx: int, atom: Atom) -> "PlanAtom":
        vars_: List[str] = []
        sels: Dict[int, object] = {}
        for pos, t in enumerate(atom.terms):
            if isinstance(t, Var):
                vars_.append(t.name)
            else:
                vars_.append(f"$sel{idx}_{pos}")
                sels[pos] = t.value
        live = [v for v in vars_ if not v.startswith("$sel")]
        assert len(set(live)) == len(live), \
            f"repeated variable in one atom unsupported: {atom}"
        return PlanAtom(idx, atom.rel, tuple(vars_), sels)

    @property
    def live_vars(self) -> Tuple[str, ...]:
        return tuple(v for v in self.vars if not v.startswith("$sel"))


@dataclasses.dataclass
class BagPlan:
    """Physical plan for one GHD bag."""

    bag: Bag
    atoms: List[PlanAtom]          # relations in lambda(t)
    var_order: Tuple[str, ...]     # global order restricted to the bag
    output_vars: Tuple[str, ...]   # retained: shared-with-parent + query out
    children: List["BagPlan"]
    dedup_key: Tuple = ()          # Appendix A.1 equivalence key

    def describe(self) -> str:
        rels = ", ".join(f"{a.rel}({','.join(a.vars)})" for a in self.atoms)
        return (f"bag[{rels}] order={self.var_order} "
                f"out={self.output_vars} w={self.bag.width:.3g}")

    def subtree_rels(self) -> Tuple[str, ...]:
        """Every relation read anywhere in this bag's subtree — the set
        whose catalog versions gate engine-lifetime result reuse
        (``plan_ir.MaterializeShared.reuse_rels``)."""
        rels = {a.rel for a in self.atoms}
        for c in self.children:
            rels.update(c.subtree_rels())
        return tuple(sorted(rels))


@dataclasses.dataclass
class QueryPlan:
    rule: Rule
    hg: Hypergraph
    ghd: GHD
    order: Tuple[str, ...]         # global attribute order
    root: BagPlan
    semiring: Optional[Semiring]
    agg_arg: Optional[str]         # <<OP(arg)>> argument var ("*" = all)
    output_vars: Tuple[str, ...]
    needs_top_down: bool

    def bags_bottom_up(self) -> List[BagPlan]:
        out: List[BagPlan] = []

        def rec(b: BagPlan):
            for c in b.children:
                rec(c)
            out.append(b)

        rec(self.root)
        return out

    def pretty(self) -> str:
        lines = [f"order={self.order} out={self.output_vars} "
                 f"fhw={self.ghd.width:.3g} top_down={self.needs_top_down}"]

        def rec(b: BagPlan, d: int):
            lines.append("  " * (d + 1) + b.describe())
            for c in b.children:
                rec(c, d + 1)

        rec(self.root, 0)
        return "\n".join(lines)


def compile_rule(rule: Rule, use_ghd: bool = True,
                 ghd: Optional[GHD] = None,
                 order: Optional[Sequence[str]] = None) -> QueryPlan:
    """Compile one (non-recursive) rule body into a GHD query plan.

    ``ghd`` / ``order`` inject a candidate decomposition / global
    attribute order instead of the defaults (min-fhw ``ghd.decompose`` /
    appearance-order ``ghd.attribute_order``) — the entry point of the
    cost-based plan search (``core.plan_search``), which compiles each
    (GHD, order) candidate through this same function so candidates are
    real plans, not approximations of one.
    """
    atoms = [PlanAtom.from_atom(i, a) for i, a in enumerate(rule.body)]
    hg = ghd.hypergraph if ghd is not None else Hypergraph.from_rule(rule)
    output_vars = tuple(rule.head.keyvars)

    agg = rule.agg
    semiring = AGG_TO_SEMIRING[agg.op] if agg is not None else None
    agg_arg = agg.arg if agg is not None else None

    if ghd is not None:
        g = ghd
    elif use_ghd:
        g = ghd_mod.decompose(hg, output_vars)
    else:
        g = ghd_mod.single_bag(hg)
    if order is not None:
        order = tuple(order)
        assert set(order) == set(hg.vertices), (order, hg.vertices)
    else:
        order = ghd_mod.attribute_order(g, output_vars)

    out_set = set(output_vars)
    by_edge = {a.idx: a for a in atoms}

    def build(bag: Bag) -> BagPlan:
        children = [build(c) for c in bag.children]
        bag_atoms = [by_edge[i] for i in bag.edge_idxs]
        retained = set(bag.shared_with_parent) | (set(bag.attrs) & out_set)
        var_order = tuple(v for v in order if v in set(bag.attrs))
        bp = BagPlan(
            bag=bag,
            atoms=bag_atoms,
            var_order=var_order,
            output_vars=tuple(v for v in var_order if v in retained),
            children=children,
        )
        return bp

    root = build(g.root)
    root_attrs = set(g.root.attrs)
    needs_top_down = not out_set <= root_attrs
    if needs_top_down and semiring is None:
        # Listing query whose outputs span bags: the final acyclic join of
        # the reduced bag results (plan_ir.TopDownJoin) connects bags on
        # their shared attributes, so every bag must RETAIN the attrs it
        # shares with its children — projecting them away (the seed
        # behaviour) degenerated the final join into a cross product.
        _retain_connectors(root)
    # Dedup keys include output_vars, so assign them only after the
    # connector-retention pass above.
    def assign_keys(bp: BagPlan):
        for c in bp.children:
            assign_keys(c)
        bp.dedup_key = _dedup_key(bp, semiring)

    assign_keys(root)
    return QueryPlan(rule, hg, g, order, root, semiring, agg_arg,
                     output_vars, needs_top_down)


def parameterize(rule: Rule) -> Tuple[Rule, Tuple[object, ...]]:
    """Rewrite body selection constants into ``Param`` bind-slots.

    Returns ``(rule_p, defaults)`` where ``rule_p`` has every body
    ``Const(v)`` replaced by ``Const(Param(slot))`` and ``defaults[slot]``
    is the constant the slot replaced. Slots are assigned one per
    DISTINCT constant value in first-appearance order, so a query like
    "triangles through vertex v" — the same literal in two atoms — binds
    both occurrences with one argument. (Corollary: two occurrences of
    the same literal cannot be re-bound independently; write distinct
    literals in the template if you need distinct slots.)

    ``repr(rule_p)`` is binding-independent, which is the whole point:
    the engine's logical/search/physical caches key on it, so re-binding
    reuses all of them.
    """
    slots: Dict[object, int] = {}
    body: List[Atom] = []
    for atom in rule.body:
        terms: List[object] = []
        for t in atom.terms:
            if isinstance(t, Const) and not isinstance(t.value, Param):
                if t.value not in slots:
                    slots[t.value] = len(slots)
                terms.append(Const(Param(slots[t.value])))
            else:
                terms.append(t)
        body.append(Atom(atom.rel, tuple(terms)))
    rule_p = dataclasses.replace(rule, body=tuple(body))
    defaults = tuple(sorted(slots, key=slots.get))
    return rule_p, defaults


def _retain_connectors(bp: BagPlan):
    for c in bp.children:
        _retain_connectors(c)
    connectors = set()
    for c in bp.children:
        connectors |= set(c.bag.shared_with_parent)
    if connectors - set(bp.output_vars):
        retained = set(bp.output_vars) | connectors
        bp.output_vars = tuple(v for v in bp.var_order if v in retained)


def _dedup_key(bp: BagPlan, semiring) -> Tuple:
    """Appendix A.1: two bags produce equivalent bottom-up results iff
    (1) identical join patterns on the same input relations, (2) identical
    aggregations/selections/projections, (3) identical subtrees — all
    checked on a variable-canonicalized structural key."""
    canon: Dict[str, int] = {}

    def cv(v: str) -> int:
        if v not in canon:
            canon[v] = len(canon)
        return canon[v]

    # Canonicalize in var_order so positional roles match across renamings.
    for v in bp.var_order:
        cv(v)
    # key=repr: column keys mix canonical ints with ("$", const) selection
    # markers, which Python refuses to order when two atoms share a
    # relation name — repr gives a deterministic total order
    atom_keys = tuple(sorted(
        ((a.rel,
          tuple(cv(v) if not v.startswith("$sel") else ("$", a.selections[p])
                for p, v in enumerate(a.vars)))
         for a in bp.atoms), key=repr))
    out_key = tuple(cv(v) for v in bp.output_vars)
    child_keys = tuple(sorted((c.dedup_key for c in bp.children), key=repr))
    sr_key = semiring.name if semiring is not None else None
    return (atom_keys, out_key, sr_key, child_keys)
