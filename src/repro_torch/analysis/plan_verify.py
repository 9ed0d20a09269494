"""Plan-IR validator: structural proof obligations over a lowered DAG.

Counterpart of ``repro.analysis.plan_verify``, copied (pure Python over
the port's own plan IR).

Every :class:`repro_torch.core.plan_ir.PhysicalPlan` the engine is about to
execute (and every candidate the plan search costs) is checked against
the invariants both lowerings silently rely on.  Two of these invariants
have already been violated by shipped bugs — dropped connector
attributes (listing queries spanning bags degenerated into cross
products) and stale routing annotations would be equally silent — so the
checker turns them into *static* errors raised before any tuple moves.

Checks, each with a stable violation ``code``:

  * ``op-registry`` / ``child-order`` — operator ids unique, registered,
    and referenced bottom-up (children strictly before parents).
  * ``access-order`` — per-atom access paths: ``perm`` is a permutation,
    selections occupy a leading prefix, and live variables appear in the
    bag's attribute order (the ``GenericJoin.__init__`` induced-order
    assert, now decided without building anything).
  * ``unconstrained-var`` / ``step-shape`` — the descent simulation:
    every attribute is advanced by at least one atom or child input at
    its turn, one step per attribute, terminal folds only at the end of
    aggregate bags, and ``Extend.n_constraining`` matches the structure.
  * ``dropped-connector`` — connector-attribute retention: every child
    input's join variables must survive in the child's materialized
    output, and (for listing plans with a final top-down join) in the
    parent's output too — the cross-product bug class as a static error.
  * ``est-invalid`` / ``agm-exceeded`` — ``est_rows``/``cost`` finite and
    non-negative, and no estimate above the bag's AGM bound (paper Eq. 1
    with real relation sizes; recomputed here, memoizable).
  * ``routing-invalid`` / ``threshold-range`` — routing hints drawn from
    the legal vocabulary (``plan_ir.EXTEND_ROUTINGS`` /
    ``FOLD_ROUTINGS``), pair routing only where the binary-self-join
    structural condition actually holds, and Algorithm-3 layout
    thresholds inside ``[block_bits, MAX_THRESHOLD_BITS]`` — the cohort
    tables :mod:`repro_torch.core.layouts` dispatches on.
  * ``sideways-invalid`` — sideways bitset filtering only annotated on
    search-routed extensions with >= 2 constraining atoms where some
    arity-2 atom actually probes its second trie level (the shape the
    counting pass's block-directory intersection requires).
  * ``reuse-key`` — engine-lifetime bag-cache keys: hashable
    canonicalized structure, alias-resolved relation names, and
    ``reuse_rels`` covering every relation the bag's subtree reads (an
    incomplete set would let a stale cached result survive a reload).
  * ``param-selection`` — bind-parameter selections (prepared queries):
    every ``datalog.Param`` appearing as a selection constant must carry
    a non-negative integer slot, and the slots used across the whole
    plan must be contiguous from 0 — the shape
    ``compile.parameterize`` emits and ``PreparedQuery._binding``
    indexes into.  A gap would make some positional argument silently
    unused; a bad slot would crash (or worse, mis-bind) at encode time.
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.core import plan_ir
from repro_torch.core import statistics
from repro_torch.core.datalog import Param
from repro_torch.core.plan_ir import (BagOps, BagScan, Extend,
                                      MaterializeShared, PhysicalPlan,
                                      TerminalFold, TopDownJoin)
from repro_torch.core.statistics import BASE_BLOCK_BITS, MAX_THRESHOLD_BITS

# 0.1% slack on the AGM comparison: plan_ir and the checker both go
# through exp(min(obj, 700)) so they agree bit-for-bit today, but the cap
# is a float bound, not an identity.
_AGM_TOLERANCE = 1.001


@dataclasses.dataclass(frozen=True)
class PlanViolation:
    code: str       # stable machine-readable class, e.g. "dropped-connector"
    where: str      # "bag#<op_id>", "final", or "plan"
    message: str

    def __str__(self) -> str:
        return f"[{self.code}] {self.where}: {self.message}"


class PlanVerificationError(AssertionError):
    """Raised by :func:`assert_valid` with every violation attached."""

    def __init__(self, violations: list[PlanViolation]):
        self.violations = list(violations)
        lines = "\n  ".join(str(v) for v in violations)
        super().__init__(f"physical plan failed verification "
                         f"({len(violations)} violation(s)):\n  {lines}")


def assert_valid(pplan: PhysicalPlan, catalog=None, stats=None,
                 agm_memo: dict | None = None) -> PhysicalPlan:
    """Raise :class:`PlanVerificationError` unless ``pplan`` is valid."""
    violations = verify_physical_plan(pplan, catalog, stats,
                                      agm_memo=agm_memo)
    if violations:
        raise PlanVerificationError(violations)
    return pplan


def verify_physical_plan(pplan: PhysicalPlan, catalog=None, stats=None,
                         agm_memo: dict | None = None) -> list[PlanViolation]:
    """All violations of ``pplan`` (empty list = valid).

    ``catalog`` (the executor's relation catalog) enables the checks that
    need data identity — alias resolution, atom arity, AGM bounds; without
    it the purely structural checks still run (hand-built plans in tests).
    ``stats`` (a ``StatisticsCatalog``) supplies ``block_bits`` for the
    threshold range; ``agm_memo`` shares fractional-cover LP solves with
    the plan search's candidate loop.
    """
    out: list[PlanViolation] = []
    add = out.append

    # ---------------------------------------------------- operator registry
    seen_ids: set[int] = set()

    def check_registered(op, where: str):
        if op.op_id in seen_ids:
            add(PlanViolation("op-registry", where,
                              f"duplicate op_id {op.op_id}"))
        seen_ids.add(op.op_id)
        if pplan.ops.get(op.op_id) is not op:
            add(PlanViolation("op-registry", where,
                              f"op_id {op.op_id} not registered in plan.ops"))

    if not pplan.bag_ops:
        add(PlanViolation("op-registry", "plan", "plan has no bags"))
        return out
    if pplan.bag_ops[-1] is not pplan.root:
        add(PlanViolation("child-order", "plan",
                          "bag_ops is not bottom-up (root must be last)"))

    materialized: dict[int, BagOps] = {}
    aggregate = pplan.logical.semiring is not None

    for bops in pplan.bag_ops:
        where = f"bag#{bops.materialize.op_id}"
        check_registered(bops.scan, where)
        for s in bops.steps:
            check_registered(s, where)
        check_registered(bops.materialize, where)
        if bops.materialize.source != bops.scan.op_id:
            add(PlanViolation("op-registry", where,
                              "materialize.source does not reference the "
                              "bag's own scan"))
        for ci in bops.scan.child_inputs:
            if ci.op_id not in materialized:
                add(PlanViolation("child-order", where,
                                  f"child input {ci.op_id} does not "
                                  f"reference an earlier bag's materialize"))
        _verify_bag(bops, materialized, aggregate, pplan, catalog, stats,
                    agm_memo, add)
        materialized[bops.materialize.op_id] = bops

    _verify_final(pplan, materialized, add)
    if pplan.final is not None:
        check_registered(pplan.final, "final")
    _verify_params(pplan, add)
    return out


def _verify_params(pplan: PhysicalPlan, add) -> None:
    """Bind-parameter selections: Param slots valid and contiguous.

    ``compile.parameterize`` assigns slots ``0..n-1`` in first-appearance
    order, and ``engine.PreparedQuery`` binds positionally against that
    range — so any Param with a non-int / negative slot, or a slot set
    with gaps, is a plan that cannot have come from the prepared-query
    path and would mis-bind at encode time.
    """
    slots: set[int] = set()
    for bops in pplan.bag_ops:
        where = f"bag#{bops.materialize.op_id}"
        for acc in bops.scan.accesses:
            for pos, value in acc.selections:
                if not isinstance(value, Param):
                    continue
                if not isinstance(value.slot, int) or value.slot < 0:
                    add(PlanViolation(
                        "param-selection", where,
                        f"{acc.rel}[{pos}]: Param slot {value.slot!r} is "
                        f"not a non-negative int"))
                else:
                    slots.add(value.slot)
    if slots and slots != set(range(max(slots) + 1)):
        missing = sorted(set(range(max(slots) + 1)) - slots)
        add(PlanViolation(
            "param-selection", "plan",
            f"bind-parameter slots {sorted(slots)} are not contiguous "
            f"from 0 (missing {missing}) — positional binding would "
            f"leave arguments unused"))


# --------------------------------------------------------------- per bag
def _verify_bag(bops: BagOps, materialized: dict[int, BagOps],
                aggregate: bool, pplan: PhysicalPlan, catalog, stats,
                agm_memo: dict | None, add) -> None:
    scan: BagScan = bops.scan
    mat: MaterializeShared = bops.materialize
    where = f"bag#{mat.op_id}"
    var_order = scan.var_order
    order_pos = {v: i for i, v in enumerate(var_order)}

    if len(set(var_order)) != len(var_order):
        add(PlanViolation("step-shape", where,
                          f"duplicate attribute in var_order {var_order}"))
        return

    # ------------------------------------------------------- access paths
    atom_keys: list[tuple | None] = []
    atom_arity: list[int | None] = []
    for acc in scan.accesses:
        n = len(acc.vars)
        if sorted(acc.perm) != list(range(n)):
            add(PlanViolation("access-order", where,
                              f"{acc.rel}: perm {acc.perm} is not a "
                              f"permutation of range({n})"))
        sel_pos = [p for p, _ in acc.selections]
        if sel_pos != list(range(len(sel_pos))):
            add(PlanViolation("access-order", where,
                              f"{acc.rel}: selections {sel_pos} are not a "
                              f"leading prefix of the index order"))
        live = acc.live_vars
        missing = [v for v in live if v not in order_pos]
        if missing:
            add(PlanViolation("access-order", where,
                              f"{acc.rel}: live vars {missing} not in bag "
                              f"var_order {var_order}"))
        else:
            pos = [order_pos[v] for v in live]
            if pos != sorted(pos):
                add(PlanViolation("access-order", where,
                                  f"{acc.rel}: live vars {live} are not in "
                                  f"the bag attribute order {var_order}"))
        arity = None
        key = None
        if catalog is not None:
            try:
                arity = catalog.get(acc.rel).arity
                key = (catalog.resolve(acc.rel), acc.perm)
            except KeyError:
                pass
        if arity is None:
            arity = len(acc.vars)
        atom_keys.append(key)
        atom_arity.append(arity)

    # ------------------------------------------------- child input schema
    for ci in scan.child_inputs:
        child = materialized.get(ci.op_id)
        pos = [order_pos[v] for v in ci.vars if v in order_pos]
        if len(pos) != len(ci.vars) or pos != sorted(pos):
            add(PlanViolation("access-order", where,
                              f"child#{ci.op_id} vars {ci.vars} not ordered "
                              f"by the parent var_order {var_order}"))
        if child is not None:
            dropped = [v for v in ci.vars
                       if v not in child.materialize.output_vars]
            if dropped:
                add(PlanViolation(
                    "dropped-connector", where,
                    f"connector attrs {dropped} joined from child"
                    f"#{ci.op_id} but absent from the child's "
                    f"materialized output "
                    f"{child.materialize.output_vars}"))

    # Listing plans spanning bags: the final top-down join reconnects bags
    # on shared attributes, so the PARENT must also retain everything it
    # shares with its children (projecting these away degenerates the
    # final join into a cross product).
    if pplan.final is not None:
        out_set = set(mat.output_vars)
        for ci in scan.child_inputs:
            dropped = [v for v in ci.vars if v not in out_set]
            if dropped:
                add(PlanViolation(
                    "dropped-connector", where,
                    f"connector attrs {dropped} shared with child"
                    f"#{ci.op_id} but dropped from this bag's output "
                    f"{mat.output_vars} (top-down join would cross-product)"))

    # ------------------------------------------------- output projection
    out_pos = [order_pos[v] for v in mat.output_vars if v in order_pos]
    if len(out_pos) != len(mat.output_vars) or out_pos != sorted(out_pos):
        add(PlanViolation("step-shape", where,
                          f"output_vars {mat.output_vars} is not an ordered "
                          f"subsequence of var_order {var_order}"))

    # ------------------------------------------------ descent simulation
    if len(bops.steps) != len(var_order):
        add(PlanViolation("step-shape", where,
                          f"{len(bops.steps)} steps for {len(var_order)} "
                          f"attributes"))
        return
    depth = [len(acc.selections) for acc in scan.accesses]
    cdepth = [0] * len(scan.child_inputs)
    out_set = set(mat.output_vars)
    for vi, (v, step) in enumerate(zip(var_order, bops.steps)):
        if step.var != v:
            add(PlanViolation("step-shape", where,
                              f"step {vi} extends {step.var!r}, var_order "
                              f"says {v!r}"))
            return
        advancing_atoms = []
        for i, acc in enumerate(scan.accesses):
            live = acc.live_vars
            d = depth[i] - len(acc.selections)
            if d < len(live) and live[d] == v:
                advancing_atoms.append(i)
        advancing_children = [
            i for i, ci in enumerate(scan.child_inputs)
            if cdepth[i] < len(ci.vars) and ci.vars[cdepth[i]] == v]
        n_cons = len(advancing_atoms) + len(advancing_children)
        if n_cons == 0:
            add(PlanViolation("unconstrained-var", where,
                              f"attribute {v!r} has no constraining atom or "
                              f"child input at its turn"))
        last = vi == len(var_order) - 1
        if isinstance(step, TerminalFold):
            if not (aggregate and last and v not in out_set):
                add(PlanViolation("step-shape", where,
                                  f"terminal fold on {v!r} is only legal as "
                                  f"the last, non-retained attribute of an "
                                  f"aggregate bag"))
            _verify_fold_routing(step, scan, advancing_atoms,
                                 advancing_children, atom_keys, atom_arity,
                                 depth, stats, where, add)
        elif isinstance(step, Extend):
            if step.n_constraining != n_cons:
                add(PlanViolation("step-shape", where,
                                  f"extend {v!r}: n_constraining="
                                  f"{step.n_constraining} but the plan "
                                  f"structure gives {n_cons}"))
            _verify_extend_routing(step, scan, advancing_atoms,
                                   advancing_children, atom_keys, atom_arity,
                                   depth, where, add)
            # device-pipeline buffer annotations: a cap the runtime
            # cannot size a static frontier buffer from is a plan bug
            if step.frontier_cap is not None and not (
                    math.isfinite(step.frontier_cap)
                    and 0 < step.frontier_cap
                    <= statistics.PIPELINE_MAX_BUFFER):
                add(PlanViolation("est-invalid", where,
                                  f"extend {v!r}: frontier_cap="
                                  f"{step.frontier_cap!r} is not a "
                                  f"positive finite buffer size within "
                                  f"PIPELINE_MAX_BUFFER"))
            if step.morsel is not None and not (
                    isinstance(step.morsel, int) and step.morsel > 0):
                add(PlanViolation("est-invalid", where,
                                  f"extend {v!r}: morsel="
                                  f"{step.morsel!r} is not a positive "
                                  f"integer"))
        else:
            add(PlanViolation("step-shape", where,
                              f"unknown step operator {type(step).__name__}"))
        for i in advancing_atoms:
            depth[i] += 1
        for i in advancing_children:
            cdepth[i] += 1

    # ---------------------------------------------------- est/cost sanity
    agm_cap = None
    if catalog is not None:
        agm_cap = plan_ir._bag_agm_bound(pplan.logical, bops.logical,
                                         catalog, agm_memo)
    for op in (scan, *bops.steps, mat):
        if not (math.isfinite(op.est_rows) and op.est_rows >= 0):
            add(PlanViolation("est-invalid", where,
                              f"op#{op.op_id} est_rows={op.est_rows!r}"))
        if not (math.isfinite(op.cost) and op.cost >= 0):
            add(PlanViolation("est-invalid", where,
                              f"op#{op.op_id} cost={op.cost!r}"))
    if agm_cap is not None:
        limit = agm_cap * _AGM_TOLERANCE
        for op in (*bops.steps, mat):
            if math.isfinite(op.est_rows) and op.est_rows > limit:
                add(PlanViolation("agm-exceeded", where,
                                  f"op#{op.op_id} est_rows={op.est_rows:.4g} "
                                  f"exceeds the bag AGM bound "
                                  f"{agm_cap:.4g}"))

    _verify_reuse_key(bops, materialized, catalog, where, add)


# ----------------------------------------------------------- routing checks
def _verify_extend_routing(step: Extend, scan, advancing_atoms,
                           advancing_children, atom_keys, atom_arity,
                           depth, where, add) -> None:
    if step.routing not in plan_ir.EXTEND_ROUTINGS:
        add(PlanViolation("routing-invalid", where,
                          f"extend {step.var!r}: unknown routing "
                          f"{step.routing!r} (legal: "
                          f"{sorted(plan_ir.EXTEND_ROUTINGS)})"))
        return
    decidable = all(atom_keys[i] is not None for i in advancing_atoms)
    if step.routing == "pair_store" and decidable and \
            not plan_ir._pair_self_join(
            scan.accesses, advancing_atoms, advancing_children,
            atom_keys, atom_arity, dict(enumerate(depth))):
        add(PlanViolation("routing-invalid", where,
                          f"extend {step.var!r} routed 'pair_store' but is "
                          f"not a binary self-join over one arity-2 index "
                          f"at depth 1"))
    if step.sideways is None:
        return
    if step.sideways != "bitset":
        add(PlanViolation("sideways-invalid", where,
                          f"extend {step.var!r}: unknown sideways "
                          f"{step.sideways!r} (legal: 'bitset')"))
    elif step.routing != "search" or step.n_constraining < 2:
        add(PlanViolation("sideways-invalid", where,
                          f"extend {step.var!r}: sideways filtering needs "
                          f">= 2 constraining atoms on the 'search' "
                          f"routing (got routing={step.routing!r}, "
                          f"n_constraining={step.n_constraining})"))
    elif not any(atom_arity[i] == 2 and depth[i] == 1
                 and not scan.accesses[i].selections
                 for i in advancing_atoms):
        add(PlanViolation("sideways-invalid", where,
                          f"extend {step.var!r}: sideways 'bitset' but no "
                          f"constraining arity-2 atom probes its second "
                          f"trie level"))


def _verify_fold_routing(step: TerminalFold, scan, advancing_atoms,
                         advancing_children, atom_keys, atom_arity,
                         depth, stats, where, add) -> None:
    if step.routing not in plan_ir.FOLD_ROUTINGS:
        add(PlanViolation("routing-invalid", where,
                          f"fold {step.var!r}: unknown routing "
                          f"{step.routing!r} (legal: "
                          f"{sorted(plan_ir.FOLD_ROUTINGS)})"))
        return
    if step.routing == "pair_kernel":
        # atom_keys are None without a catalog — the pair-structure
        # predicate is undecidable then, so only flag when decidable
        decidable = all(atom_keys[i] is not None for i in advancing_atoms)
        if decidable and not plan_ir._pair_self_join(
                scan.accesses, advancing_atoms, advancing_children,
                atom_keys, atom_arity, dict(enumerate(depth))):
            add(PlanViolation("routing-invalid", where,
                              f"fold {step.var!r} routed 'pair_kernel' but "
                              f"is not a binary self-join over one arity-2 "
                              f"index at depth 1"))
        thr = step.layout_threshold
        block_bits = stats.block_bits if stats is not None \
            else BASE_BLOCK_BITS
        if thr is None or not math.isfinite(thr) \
                or not block_bits <= thr <= MAX_THRESHOLD_BITS:
            add(PlanViolation("threshold-range", where,
                              f"fold {step.var!r}: layout_threshold {thr!r} "
                              f"outside [{block_bits}, "
                              f"{MAX_THRESHOLD_BITS}]"))
    elif step.layout_threshold is not None:
        add(PlanViolation("threshold-range", where,
                          f"fold {step.var!r}: search routing must not carry "
                          f"a layout threshold "
                          f"(got {step.layout_threshold!r})"))


# --------------------------------------------------------- reuse-key checks
def _well_formed_struct(key) -> bool:
    """``MaterializeShared.reuse_struct`` shape: ``(atom_keys, out_key,
    sr_key, child_keys)`` of hashable primitives, recursively."""
    if not (isinstance(key, tuple) and len(key) == 4):
        return False
    atom_keys, out_key, sr_key, child_keys = key
    if not isinstance(atom_keys, tuple) or not isinstance(out_key, tuple) \
            or not isinstance(child_keys, tuple):
        return False
    for ak in atom_keys:
        if not (isinstance(ak, tuple) and len(ak) == 2
                and isinstance(ak[0], str) and isinstance(ak[1], tuple)):
            return False
    if not all(isinstance(p, int) for p in out_key):
        return False
    if sr_key is not None and not isinstance(sr_key, str):
        return False
    return all(_well_formed_struct(c) for c in child_keys)


def _verify_reuse_key(bops: BagOps, materialized: dict[int, BagOps],
                      catalog, where, add) -> None:
    mat = bops.materialize
    key = mat.reuse_struct
    try:
        hash((key, mat.reuse_rels))
    except TypeError:
        add(PlanViolation("reuse-key", where,
                          "reuse_struct/reuse_rels are not hashable"))
        return
    if not _well_formed_struct(key):
        add(PlanViolation("reuse-key", where,
                          f"reuse_struct {key!r} is not a canonicalized "
                          f"(atom_keys, out_key, sr_key, child_keys) tuple"))
        return
    rels = mat.reuse_rels
    if list(rels) != sorted(set(rels)) \
            or not all(isinstance(r, str) for r in rels):
        add(PlanViolation("reuse-key", where,
                          f"reuse_rels {rels!r} must be sorted unique "
                          f"relation names"))
    if catalog is not None:
        unresolved = [r for r in rels if catalog.resolve(r) != r]
        if unresolved:
            add(PlanViolation("reuse-key", where,
                              f"reuse_rels entries {unresolved} are not "
                              f"alias-resolved"))
        rel_set = set(rels)
        missing = sorted({catalog.resolve(a.rel) for a in bops.scan.accesses}
                         - rel_set)
        if missing:
            add(PlanViolation("reuse-key", where,
                              f"relations {missing} are read by this bag but "
                              f"absent from reuse_rels — a reload would not "
                              f"invalidate the cached result"))
        for ci in bops.scan.child_inputs:
            child = materialized.get(ci.op_id)
            if child is None:
                continue
            leaked = sorted(set(child.materialize.reuse_rels) - rel_set)
            if leaked:
                add(PlanViolation("reuse-key", where,
                                  f"child#{ci.op_id} reads {leaked} but the "
                                  f"parent's reuse_rels omits them"))


# ------------------------------------------------------------------- final
def _verify_final(pplan: PhysicalPlan, materialized: dict[int, BagOps],
                  add) -> None:
    final: TopDownJoin | None = pplan.final
    if final is None:
        return
    where = "final"
    if pplan.logical.semiring is not None:
        add(PlanViolation("step-shape", where,
                          "aggregate plans must elide the top-down join"))
    if not final.inputs:
        add(PlanViolation("topdown-cover", where,
                          "top-down join with no inputs"))
        return
    covered: set[str] = set()
    for op_id in final.inputs:
        child = materialized.get(op_id)
        if child is None:
            add(PlanViolation("op-registry", where,
                              f"input {op_id} is not a materialized bag"))
            continue
        out_vars = child.materialize.output_vars
        if not out_vars:
            add(PlanViolation("topdown-cover", where,
                              f"input bag#{op_id} materializes no "
                              f"attributes"))
        pos = [final.var_order.index(v) for v in out_vars
               if v in final.var_order]
        if len(pos) != len(out_vars) or pos != sorted(pos):
            add(PlanViolation("access-order", where,
                              f"bag#{op_id} output {out_vars} inconsistent "
                              f"with the final order {final.var_order}"))
        covered |= set(out_vars)
    unconstrained = [v for v in final.var_order if v not in covered]
    if unconstrained:
        add(PlanViolation("unconstrained-var", where,
                          f"final-join attrs {unconstrained} constrained by "
                          f"no input bag"))
    not_covered = [v for v in final.output_vars
                   if v not in final.var_order]
    if not_covered:
        add(PlanViolation("topdown-cover", where,
                          f"output attrs {not_covered} missing from the "
                          f"final join order"))
    if not (math.isfinite(final.est_rows) and final.est_rows >= 0
            and math.isfinite(final.cost) and final.cost >= 0):
        add(PlanViolation("est-invalid", where,
                          f"est_rows={final.est_rows!r} cost={final.cost!r}"))
