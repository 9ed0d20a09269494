"""Code generation: physical plan IR -> executable Python source.

The paper's compiler emits specialized C++ per query ("code generation
... has been shown to be an efficient technique to translate high-level
query plans into code optimized for modern hardware", Section 3.3); here
the generated artifact is Python that drives the vectorized trie
operators — one straight-line program per plan, with the Generic-Join
loop structure of Example 3.2 spelled out in comments:

    # for t_x in pi_x R  ∩  pi_x T:
    #   for t_y in pi_y R[t_x]  ∩  pi_y S:
    #     Q <- Q ∪ (t_x,t_y) x (pi_z S[t_y] ∩ pi_z T[t_x])

This module is a *lowering* of ``core.plan_ir.PhysicalPlan`` — the same
IR the interpreter (``core.executor``, the differential-testing oracle)
walks.  Every physical decision is read off the IR: access paths come
from ``BagScan``, layout/routing hints are emitted as ``BagHints``
literals, equivalent bags (Appendix A.1) reuse the first occurrence via
the IR's structural reuse keys, and the final top-down collect joins the
reduced bags referenced by ``TopDownJoin.inputs`` — emitted bag variables
are tracked structurally by operator id (the old ``_bag_names`` source-
text scraping is gone).  Generated programs also consult the engine's
lifetime :class:`~repro_torch.core.executor.BagResultCache` (keys computed
against catalog versions at RUN time, so a stale emitted key is
impossible) and report per-bag actual cardinalities through the
``metrics`` argument for the estimated-vs-actual benchmark artifact.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Tuple

from repro_torch.core.compile import BagPlan
from repro_torch.core.plan_ir import BagOps, PhysicalPlan


def _loop_comment(bp: BagPlan) -> List[str]:
    """Example 3.2-style nested-loop sketch for one bag."""
    lines = []
    bound: List[str] = []
    for depth, v in enumerate(bp.var_order):
        cons = []
        for a in bp.atoms:
            if v in a.live_vars:
                prior = [w for w in a.live_vars if w in bound]
                key = f"[{','.join('t_' + w for w in prior)}]" if prior else ""
                cons.append(f"pi_{v} {a.rel}{key}")
        indent = "#   " + "  " * depth
        last = depth == len(bp.var_order) - 1
        folded = v not in bp.output_vars
        op = "fold" if (last and folded) else "for t_%s in" % v
        lines.append(f"{indent}{op} {' ∩ '.join(cons)}"
                     + (":" if not (last and folded) else
                        f"   <- early aggregation of {v}"))
        bound.append(v)
    return lines


def _hints_src(bops: BagOps) -> str:
    h = bops.hints()  # the one place hint selection is defined
    return (f"BagHints(layout_threshold={h.layout_threshold!r}, "
            f"terminal_routing={h.terminal_routing!r}, "
            f"est_rows={h.est_rows!r}, "
            f"extend_routing={h.extend_routing!r}, "
            f"extend_caps={h.extend_caps!r}, "
            f"morsel={h.morsel!r}, "
            f"extend_sideways={h.extend_sideways!r})")


def emit_source(pplan: PhysicalPlan) -> str:
    plan = pplan.logical
    lines = [
        "# Auto-generated by repro_torch.core.codegen — do not edit.",
        f"# query: {plan.rule.head.rel}({','.join(plan.output_vars)}) "
        f"fhw={plan.ghd.width:.3g} order={plan.order}",
        "from repro_torch.core.gj import GenericJoin",
        "from repro_torch.core.datalog import Param",
        "from repro_torch.core.executor import _result_to_trie, rename_result",
        "from repro_torch.core.plan_ir import BagHints",
        "from repro_torch.core.semiring import BY_NAME",
        "",
        "def run(catalog, encode, backend=None, bag_cache=None,"
        " metrics=None):",
    ]
    sr_expr = (f"BY_NAME[{plan.semiring.name!r}]"
               if plan.semiring is not None else "None")
    aggregate = plan.semiring is not None

    body: List[str] = []
    # op id of each bag's MaterializeShared -> its emitted variable name;
    # structural — TopDownJoin and child inputs look names up here.
    name_of: Dict[int, str] = {}
    emitted: Dict[Tuple, str] = {}  # per-query dedup (Appendix A.1)

    for bops in pplan.bag_ops:
        bp = bops.logical
        mat = bops.materialize
        name = f"bag{mat.op_id}"
        name_of[mat.op_id] = name

        if bp.dedup_key in emitted:
            body.append(
                f"    {name} = rename_result({emitted[bp.dedup_key]}, "
                f"{mat.output_vars!r})"
                f"  # equivalent bag (Appendix A.1): reuse")
            body.append("    if metrics is not None:")
            body.append(f"        metrics[{mat.op_id}] = "
                        f"{{'est_rows': {mat.est_rows!r}, "
                        f"'actual_rows': {name}.num_rows}}")
            continue

        body.append(f"    # ---- {name}: "
                    + ", ".join(f"{a.rel}({','.join(a.vars)})"
                                for a in bp.atoms)
                    + f"  [est_rows~{mat.est_rows:.3g}]")
        body.extend("    " + c for c in _loop_comment(bp))

        atoms_src: List[str] = []
        sels_src: List[str] = []
        for acc in bops.scan.accesses:
            atoms_src.append(
                f"(catalog.reordered({acc.rel!r}, {acc.perm!r}), "
                f"{acc.vars!r})")
            if acc.selections:
                items = ", ".join(f"{i}: encode({v!r})"
                                  for i, v in acc.selections)
                sels_src.append(f"{len(atoms_src) - 1}: {{{items}}}")
        for ci in bops.scan.child_inputs:
            cn = name_of[ci.op_id]
            keep = "True" if aggregate else "False"
            atoms_src.append(
                f"(_result_to_trie({cn}, {ci.vars!r}, "
                f"keep_annotation={keep}), {ci.vars!r})")
        sels = "{" + ", ".join(sels_src) + "}"

        # engine-lifetime reuse: structural key is a literal; the data-
        # identity half (catalog versions) and the bind-parameter half
        # (Param selections resolve through the encode closure, so the
        # struct literal is binding-invariant) are computed at run time.
        body.append(f"    _k{mat.op_id} = ({mat.reuse_struct!r},")
        body.append("        getattr(encode, 'binding_key', ()),")
        body.append(f"        catalog.version_key({mat.reuse_rels!r}))")
        body.append(f"    {name} = (bag_cache.get(_k{mat.op_id})"
                    f" if bag_cache is not None else None)")
        body.append(f"    if {name} is not None:")
        body.append(f"        {name} = rename_result({name}, "
                    f"{mat.output_vars!r})")
        body.append("    else:")
        body.append(f"        _gj{mat.op_id} = GenericJoin(")
        body.append("            [" + ",\n             ".join(atoms_src)
                    + "],")
        body.append(f"            {bops.scan.var_order!r}, "
                    f"{mat.output_vars!r},")
        body.append(f"            semiring={sr_expr}, selections={sels},")
        body.append(f"            backend=backend,")
        body.append(f"            hints={_hints_src(bops)})")
        body.append(f"        {name} = _gj{mat.op_id}.run()")
        body.append("        if bag_cache is not None:")
        body.append(f"            bag_cache.put(_k{mat.op_id}, {name})")
        body.append("        if metrics is not None:")
        body.append(f"            metrics[{mat.op_id}] = "
                    f"{{'est_rows': {mat.est_rows!r}, "
                    f"'actual_rows': {name}.num_rows, "
                    f"'level_actuals': _gj{mat.op_id}.level_actuals}}")
        body.append("    if metrics is not None and "
                    f"{mat.op_id} not in metrics:")
        body.append(f"        metrics[{mat.op_id}] = "
                    f"{{'est_rows': {mat.est_rows!r}, "
                    f"'actual_rows': {name}.num_rows}}")
        emitted[bp.dedup_key] = name

    root_name = name_of[pplan.root.materialize.op_id]

    if pplan.final is not None:
        # final acyclic join of the reduced bag results: inputs are the
        # IR TopDownJoin's structural references, one per reduced bag.
        td = pplan.final
        body.append("    # ---- top-down: join reduced bag results "
                    f"(TopDownJoin over {list(td.inputs)})")
        atoms = ", ".join(
            f"(_result_to_trie({name_of[i]}, {name_of[i]}.vars, "
            f"keep_annotation=False), {name_of[i]}.vars)"
            for i in td.inputs)
        body.append(f"    _atoms = [{atoms}]")
        body.append(f"    return GenericJoin(_atoms, {td.var_order!r}, "
                    f"{td.output_vars!r}, semiring=None, "
                    f"backend=backend).run()")
    else:
        if not plan.root.children and not aggregate:
            body.append("    # single-bag plan: root result is final "
                        "(top-down pass elided, Appendix A.1)")
        elif aggregate:
            body.append("    # outputs live in the root bag: top-down pass "
                        "elided (Appendix A.1)")
        body.append(f"    return {root_name}")

    return "\n".join(lines + body) + "\n"


def emit(pplan: PhysicalPlan) -> Tuple[Callable, str]:
    """Compile the physical plan to source, exec it, wrap with the
    expression evaluation (which needs the catalog's scalar store at call
    time)."""
    plan = pplan.logical
    src = emit_source(pplan)
    ns: Dict = {}
    exec(compile(src, f"<codegen:{plan.rule.head.rel}>", "exec"), ns)
    inner = ns["run"]

    def fn(catalog, encode, backend=None, bag_cache=None, metrics=None):
        from repro_torch.core.executor import apply_expr
        res = inner(catalog, encode, backend, bag_cache=bag_cache,
                    metrics=metrics)
        return apply_expr(plan, res, catalog.scalars)

    return fn, src
