"""The runtime dispatch sanitizer ``Engine(sanitize=True)`` runs after
each rule (counterpart of the runtime half of
``repro.analysis.kernel_check``: :class:`SanitizeError`,
:func:`check_dispatch`, :func:`_routing_summary`, copied).

After each rule executes, the backend's dispatch-counter DELTA must match
what the validated physical plan predicted: pair-cohort kernels only fire
when some bag routed to them, and the host-sync budget holds (at most one
transfer per per-extension call on the device backend, one per probe
atom on the host oracle).  Violations raise :class:`SanitizeError` — a
counter mismatch means the plan annotations and the runtime disagreed
about what actually ran.
"""
from __future__ import annotations

from repro_torch.core.plan_ir import Extend, PhysicalPlan, TerminalFold


class SanitizeError(AssertionError):
    """Runtime dispatch counters contradict the validated plan."""


# ------------------------------------------------------- runtime sanitize
def check_dispatch(pplan: PhysicalPlan, delta: dict, metrics: dict,
                   backend_name: str) -> None:
    """Assert the dispatch-counter ``delta`` of one rule execution is
    consistent with the validated plan's routing annotations.

    Only SOUND assertions — ones no legitimate execution can trip:

      * no bag routes a fold to ``pair_kernel``  ⇒  zero
        ``fold.pair_count_calls`` (the binary-cohort kernels must not
        fire on plans that never routed to them);
      * additionally no ``pair_store`` extension  ⇒  zero
        ``extend.pair_materialize_calls``;
      * host-sync budget: the device backend syncs at most once per
        fused extension call; the numpy oracle at most once per probe
        atom per call (``TerminalFold``'s general path and the final
        top-down join also call ``extend`` internally, so the budget is
        per observed ``extend.calls``, not per planned step);
      * an executed bag (per-bag ``metrics`` carries ``level_actuals``
        only for bags actually run, not cache hits) that produced rows
        through a terminal fold must have registered >= 1 ``fold.calls``.
    """
    def fail(msg: str):
        raise SanitizeError(
            f"dispatch sanitizer: {msg}\n  plan routing: "
            f"{_routing_summary(pplan)}\n  delta: "
            f"{ {k: v for k, v in sorted(delta.items())} }")

    any_pair_fold = any(
        isinstance(s, TerminalFold) and s.routing == "pair_kernel"
        for b in pplan.bag_ops for s in b.steps)
    any_pair_extend = any(
        isinstance(s, Extend) and s.routing == "pair_store"
        for b in pplan.bag_ops for s in b.steps)
    if not any_pair_fold and delta.get("fold.pair_count_calls", 0):
        fail("pair-cohort fold kernel fired but no bag routed a fold to "
             "'pair_kernel'")
    if not any_pair_fold and not any_pair_extend \
            and delta.get("extend.pair_materialize_calls", 0):
        fail("pair-store materialize fired but no step routed to the "
             "layout store")

    ec = delta.get("extend.calls", 0)
    hs = delta.get("extend.host_syncs", 0)
    if backend_name == "device":
        # pipelined extensions NEVER sync per-extension (the frontier
        # lands once per join, counted as extend.closing_syncs); only
        # extensions served by the legacy per-extension path may sync
        budget = ec - delta.get("extend.pipeline_extends", 0)
        if (delta.get("extend.closing_syncs", 0)
                > delta.get("extend.pipeline_extends", 0)
                + delta.get("pipeline.device_folds", 0) + 1):
            fail("more closing syncs than pipelined steps + 1 — the "
                 "pipeline is landing more than once per join")
    else:
        # one sync per PROBE atom: every extension has at most
        # (constraining inputs - 1) probes; bound by the widest bag
        widest = max((len(b.scan.accesses) + len(b.scan.child_inputs)
                      for b in pplan.bag_ops), default=1)
        if pplan.final is not None:
            widest = max(widest, len(pplan.final.inputs))
        budget = ec * max(1, widest - 1)
    if hs > budget:
        fail(f"{hs} host syncs exceed the budget of {budget} for {ec} "
             f"extension calls on the {backend_name} backend (<=1 per "
             f"{'fused extension' if backend_name == 'device' else 'probe atom'})")

    executed = {op_id for op_id, m in metrics.items()
                if m and "level_actuals" in m}
    ran_fold_rows = any(
        b.materialize.op_id in executed
        and metrics[b.materialize.op_id].get("actual_rows", 0) > 0
        and any(isinstance(s, TerminalFold) for s in b.steps)
        for b in pplan.bag_ops)
    if ran_fold_rows and not delta.get("fold.calls", 0):
        fail("a terminal-fold bag executed and produced rows but no "
             "fold.calls were recorded")


def _routing_summary(pplan: PhysicalPlan) -> dict:
    out = {}
    for b in pplan.bag_ops:
        for s in b.steps:
            if isinstance(s, TerminalFold):
                out[f"bag#{b.materialize.op_id}.fold.{s.var}"] = s.routing
            elif isinstance(s, Extend) and s.routing != "search":
                out[f"bag#{b.materialize.op_id}.extend.{s.var}"] = s.routing
    return out
