"""Level-at-a-time (breadth-first) Generic-Join (paper Algorithm 1, adapted).

The paper's Generic-Join is a tuple-at-a-time recursion — control-flow bound
and unmappable to a GPU. The equivalent breadth-first formulation keeps the
*frontier* of partial bindings as a struct-of-arrays and performs each
attribute extension as ONE vectorized intersect-and-expand over the whole
frontier:

    for each attribute v in the global order:
        for every frontier row, intersect the candidate sets contributed by
        all relations whose next un-bound attribute is v  (min property:
        the smallest candidate set seeds the chain, the others are probed
        with branch-free binary search)
        expand the frontier by the intersection results

Early aggregation (the GHD payoff, Section 3.2): when the remaining
attributes are all aggregated away, the engine switches to a *terminal fold*
that never materializes the expansion — e.g. triangle counting folds
|N(x) ∩ N(y)| per frontier row directly.

Annotations follow Green et al. provenance semirings (`core.semiring`).

Where sets live and who intersects them is the *execution backend*'s
business (``core.backend``): this module owns the join logic only and
delegates every attribute extension and terminal-fold intersection to the
backend — ``NumpyBackend`` is the host oracle, ``DeviceBackend`` keeps
trie levels device-resident and routes intersections to the layout-cohort
CUDA kernels.  Counterpart of ``repro.core.gj``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import backend as backend_mod
from repro_torch.core import statistics as stats_mod
from repro_torch.core.semiring import COUNT, Semiring
from repro_torch.core.trie import Trie
from repro_torch.kernels.common import COUNT_LIMIT


@dataclasses.dataclass(eq=False)
class BoundAtom:
    """One relation occurrence in a bag, with live trie-descent state.

    ``eq=False``: atoms are identity-keyed live state. The generated
    dataclass equality deep-compared tries (numpy arrays -> ambiguous
    truth value) the moment one bag held two structurally identical
    child-bag inputs — e.g. ``R(v1,v0),S(v2,v0)`` decomposed into two
    single-atom bags both passing up ``(v0,)``."""

    trie: Trie
    vars: Tuple[str, ...]       # variables per attribute (post-selection)
    depth: int = 0              # how many attributes already bound
    # cursor: absolute positions into levels[depth-1].values per frontier row
    cursor: Optional[np.ndarray] = None

    def next_var(self) -> Optional[str]:
        return self.vars[self.depth] if self.depth < len(self.vars) else None

    def candidate_bounds(self, frontier_len: int):
        """Per-row (lo, hi) bounds of this relation's candidate set."""
        lv = self.trie.levels[self.depth]
        if self.depth == 0:
            lo = np.zeros(frontier_len, dtype=np.int64)
            hi = np.full(frontier_len, len(lv.values), dtype=np.int64)
        else:
            lo = lv.offsets[self.cursor]
            hi = lv.offsets[self.cursor + 1]
        return lv.values, lo, hi

    def annotation_at_leaf(self) -> Optional[np.ndarray]:
        return self.trie.annotation


@dataclasses.dataclass
class GJResult:
    vars: Tuple[str, ...]
    columns: Dict[str, np.ndarray]
    annotation: Optional[np.ndarray]  # semiring elements, None if no agg

    @property
    def num_rows(self) -> int:
        if not self.vars:
            return 1 if self.annotation is not None and self.annotation.ndim == 0 else (
                len(self.annotation) if self.annotation is not None else 1)
        return len(next(iter(self.columns.values())))

    def scalar(self):
        assert not self.vars
        return self.annotation


class _PipelineDriver:
    """Drives the backend's zero-sync extension pipeline for one run.

    Eligible steps are RECORDED and executed as one device chain
    (``backend.run_bag``) at :meth:`finish`; BoundAtom state is NOT
    mutated until the single closing sync succeeds — atom depths are
    shadowed here, so an overflow (undersized buffer) can abort with the
    join untouched and the caller re-runs with measured capacities.
    ``finish`` lands the device state back into the host loop's
    representation: frontier columns, atom cursors/depths, annotation,
    level actuals.
    """

    def __init__(self, gj: "GenericJoin", exact_caps: bool = False,
                 needed: Optional[Dict[str, int]] = None):
        self.gj = gj
        self.backend = gj.backend
        self.depth = {id(a): a.depth for a in gj.atoms}
        self.plans: List[Tuple] = []
        # overflow-retry mode: ignore the stats-informed targets and size
        # each buffer from the aborted attempt's counting-pass totals
        # (``needed``), or at the exact cross-product bound when no
        # measurement exists for the variable (steps whose bound exceeds
        # PIPELINE_MAX_BUFFER land instead)
        self.exact_caps = exact_caps
        self.needed = needed or {}
        # sound host-side bound on the live row count (min of the running
        # cross-product bound and each buffer capacity) — sizes the next
        # step's cross clamp and the int32 counting-overflow guard
        self.bound = 1
        h = gj.hints
        if h is not None and h.morsel:
            self.morsel = int(h.morsel)
        else:
            self.morsel = stats_mod.DEFAULT_MORSEL

    def _effective_morsel(self, cap: int) -> int:
        # doubled from the base morsel (so morsel sizes bucket)
        # until the chunk loop is at most 2^MORSEL_CHUNK_SHIFT long
        m = self.morsel
        target = cap >> stats_mod.MORSEL_CHUNK_SHIFT
        while m < target:
            m <<= 1
        # never exceed the buffer: capacities bucket to powers of two
        # with a small floor (PIPELINE_MIN_BUCKET), so a morsel larger
        # than cap would make the fill loop's chunk count round to ZERO
        # and silently drop rows.  The pow2 floor keeps cap % morsel == 0.
        m = min(m, cap)
        return 1 << (max(m, 1).bit_length() - 1)

    def _next_var(self, a: BoundAtom) -> Optional[str]:
        d = self.depth[id(a)]
        return a.vars[d] if d < len(a.vars) else None

    def _sideways(self, v: str, a: BoundAtom, d: int):
        """Bitset sideways spec ``(level0, blocked_bitset)`` for a probe
        atom of variable ``v``, or None.  Gated by the plan IR
        (``BagHints.extend_sideways`` — the statistics density gate
        decided dense cohorts dominate), and only where the runtime
        shape matches: a binary atom probing its SECOND level, whose
        layout store actually built a bitset cohort."""
        h = self.gj.hints
        if (h is None or d != 1 or a.trie.arity != 2
                or (getattr(h, "extend_sideways", None) or {})
                .get(v) != "bitset"):
            return None
        store = self.backend._pair_store(a.trie,
                                         threshold=h.layout_threshold)
        if store is None or store.bitset is None:
            return None
        return (a.trie.levels[0], store.bitset)

    def try_step(self, v: str, terminal: bool) -> bool:
        """Run one attribute extension (or terminal fold) on device if
        eligible; False means the caller must land and continue on the
        host path (pair-kernel-routed steps, or un-sizable buffers)."""
        gj = self.gj
        cons = [a for a in gj.atoms if self._next_var(a) == v]
        assert cons, f"variable {v} unconstrained at its turn"
        if terminal:
            return self._terminal_step(v, cons)
        h = gj.hints
        if h is not None and len(cons) == 2:
            # mirror _extend_pair_store's runtime guards against the SHADOW
            # depths: the layout store serves binary self-join expansions
            # from host cursors, so land first when this step would route
            # there.  (terminal_routing == "pair_kernel" only matters at
            # the terminal fold, which lands unconditionally above.)
            a, b = cons
            if ((h.extend_routing or {}).get(v) == "pair_store"
                    and a.trie is b.trie and a.trie.arity == 2
                    and self.depth[id(a)] == 1 and self.depth[id(b)] == 1
                    and self.backend.has_pair_store(
                        a.trie, threshold=h.layout_threshold)):
                return False
        # ---- exact cross-product bound from the live tries (sound: the
        # expansion of one row cannot exceed the smallest constraining
        # atom's worst-case segment)
        branch = None
        infos = []
        for a in cons:
            d = self.depth[id(a)]
            lv = a.trie.levels[d]
            if lv.size == 0:
                return False        # empty candidates: host path handles
            ts = stats_mod.collect_trie_stats(a.trie).levels[d]
            b = lv.size if d == 0 else int(ts.max_fanout)
            mass = float(lv.size) if d == 0 else float(ts.mean_fanout)
            branch = b if branch is None else min(branch, b)
            infos.append((a, d, mass))
        cross = self.bound * max(branch, 0)
        if cross > COUNT_LIMIT:
            return False            # int32 counting pass could wrap
        # the counting pass's measured output size — from this query's
        # aborted attempt or a previous execution of the same bag shape
        # (engine-lifetime feedback) — beats any stats estimate
        est = self.needed.get(v)
        if est is None and not self.exact_caps \
                and h is not None and h.extend_caps:
            est = h.extend_caps.get(v)
        if est is None:
            # no stats-informed target (direct construction, top-down
            # join): the exact cross bound is itself a sound capacity
            if cross > stats_mod.PIPELINE_MAX_BUFFER:
                return False
            est = float(cross)
        cap_out = stats_mod.frontier_capacity(est, cross, self.morsel)
        # ---- engage: estimated min-property seed first
        infos.sort(key=lambda t: t[2])
        cons_desc = [(id(a), a.trie.levels[d], d == 0,
                      None if i == 0 else self._sideways(v, a, d))
                     for i, (a, d, _m) in enumerate(infos)]
        morsel = self._effective_morsel(cap_out)
        self.plans.append(("extend", v, cons_desc, cap_out, morsel))
        self.bound = min(cross, cap_out)
        sr = gj.semiring
        for a, d, _m in infos:
            self.depth[id(a)] = d + 1
            if (sr is not None and d + 1 == len(a.trie.attrs)
                    and a.trie.annotation is not None):
                self.plans.append(("annmul", id(a), a.trie, sr))
        return True

    def _terminal_step(self, v: str, cons: List[BoundAtom]) -> bool:
        """Early-aggregate the terminal attribute on device when the
        host fold would otherwise materialize the expansion through a
        per-extension sync.  Lands (False) only for the pair-kernel
        routes — the AND+popcount / cohort-materialize paths need host
        cursors and are themselves extension-sync-free."""
        gj = self.gj
        sr = gj.semiring
        h = gj.hints
        if sr is None:
            return False
        has_ann = any(a.trie.annotation is not None for a in cons)
        if len(cons) == 2:
            a, b = cons
            pair_shape = (a.trie is b.trie and a.trie.arity == 2
                          and self.depth[id(a)] == 1
                          and self.depth[id(b)] == 1
                          and self.backend.has_pair_store(
                              a.trie,
                              threshold=(h.layout_threshold
                                         if h else None)))
            routed_off = h is not None and h.terminal_routing == "search"
            if pair_shape and sr is COUNT and not has_ann \
                    and not routed_off:
                return False        # host pair_count kernel (no sync)
            if pair_shape and h is not None \
                    and h.terminal_routing == "pair_kernel":
                return False        # host pair materialize route
        branch = None
        infos = []
        for a in cons:
            d = self.depth[id(a)]
            lv = a.trie.levels[d]
            if lv.size == 0:
                return False
            ts = stats_mod.collect_trie_stats(a.trie).levels[d]
            b = lv.size if d == 0 else int(ts.max_fanout)
            mass = float(lv.size) if d == 0 else float(ts.mean_fanout)
            branch = b if branch is None else min(branch, b)
            infos.append((a, d, mass))
        cross = self.bound * max(branch, 0)
        if cross > COUNT_LIMIT:
            return False            # int32 counting pass could wrap
        infos.sort(key=lambda t: t[2])
        cons_desc = [
            (id(a), a.trie.levels[d], d == 0,
             a.trie if a.trie.annotation is not None else None)
            for a, d, _m in infos]
        # the fold never allocates an output buffer, so its morsel is
        # sized off the candidate-total bound to keep the sequential
        # chunk loop short.  Float semirings are chunk-order-sensitive:
        # partial sums across fill chunks re-associate the reduction and
        # shift the last ulp vs the host fold's single segment reduce —
        # those fold in ONE chunk (bitwise-identical order) or land when
        # the candidate bound exceeds the buffer ceiling.
        if sr.dtype.is_floating_point:
            if cross > stats_mod.PIPELINE_MAX_BUFFER:
                return False
            morsel = 1 << max(3, (int(cross) - 1).bit_length())
        else:
            morsel = self._effective_morsel(
                min(cross, stats_mod.PIPELINE_MAX_BUFFER))
        self.plans.append(("fold", v, cons_desc, sr, morsel))
        return True

    def finish(self):
        """Land: one closing sync, then write the fetched state back into
        the host representation.  Raises PipelineOverflow (before any
        mutation) when a buffer was undersized."""
        gj = self.gj
        if not self.plans:
            ann = (np.asarray(gj.semiring.lift(1))
                   if gj.semiring is not None else None)
            return {}, ann, 1
        # execute the recorded chain now; atoms were never mutated
        # (depths are shadowed), so their cursors still describe the
        # pre-bag frontier
        cursors0 = {id(a): a.cursor for a in gj.atoms
                    if a.cursor is not None}
        ann0 = (np.asarray(gj.semiring.lift(1))
                if gj.semiring is not None else None)
        state = self.backend.run_bag(cursors0, ann0, self.plans)
        self.plans = []
        (count, overflow, cols, cursors, ann,
         levels, needed) = self.backend.pipeline_land(state)
        if overflow:
            raise backend_mod.PipelineOverflow(
                f"frontier buffer overflow landing {gj.var_order}",
                needed=needed)
        n = count
        frontier = {k: np.asarray(c)[:n] for k, c in cols.items()}
        for a in gj.atoms:
            k = id(a)
            if k in cursors:
                a.cursor = np.asarray(cursors[k])[:n].astype(np.int64)
            a.depth = self.depth[k]
        gj.level_actuals.extend(levels)
        ann = np.asarray(ann)[:n] if ann is not None else None
        return frontier, ann, n


class GenericJoin:
    """Vectorized worst-case-optimal join over one GHD bag."""

    def __init__(self, atoms: Sequence[Tuple[Trie, Sequence[str]]],
                 var_order: Sequence[str],
                 output_vars: Sequence[str],
                 semiring: Optional[Semiring] = None,
                 selections: Optional[Dict[int, Dict[int, int]]] = None,
                 backend=None,
                 hints=None):
        """
        atoms: (trie, vars) pairs; trie attr order must equal the global order
          restricted to its vars (callers re-index via Trie.reorder).
        var_order: bag-local global attribute order.
        output_vars: χ(t) — retained attributes (prefix of var_order is NOT
          required; non-retained attrs are folded with the semiring or
          deduped away).
        semiring: fold algebra for projected-away attributes; None = set
          semantics (dedup).
        selections: atom_idx -> {attr_pos: constant} equality selections.
        backend: ExecBackend carrying out extensions/intersections; None
          is ``make_backend(None)``, a device backend on the card.
        hints: plan_ir.BagHints — physical annotations decided by the plan
          IR (statistics-driven Algorithm-3 layout threshold, terminal-fold
          routing). None keeps the backend defaults.
        """
        self.backend = (backend if backend is not None
                        else backend_mod.make_backend(None))
        self.var_order = tuple(var_order)
        self.output_vars = tuple(output_vars)
        self.semiring = semiring
        self.hints = hints
        # per-extension actual frontier sizes [(var, rows)], written by
        # run(); both lowerings forward these through their metrics dicts
        # into Engine.plan_metadata()'s per-step actual_rows
        self.level_actuals: List[Tuple[str, int]] = []
        self.atoms: List[BoundAtom] = []
        selections = selections or {}
        for i, (trie, vars_) in enumerate(atoms):
            sel = selections.get(i, {})
            self.atoms.append(self._prebind(trie, tuple(vars_), sel))
        for a in self.atoms:
            # check induced-order consistency on live (unselected) variables
            pos = [self.var_order.index(v) for v in a.vars[a.depth:]]
            assert pos == sorted(pos), (
                f"trie order {a.vars} inconsistent with global {self.var_order}")

    @staticmethod
    def _prebind(trie: Trie, vars_: Tuple[str, ...], sel: Dict[int, int]) -> BoundAtom:
        """Apply equality selections by descending the trie at constants.

        Constants must be a prefix of the attribute order (the compiler
        reorders tries so selections lead). Produces an atom whose cursor is
        pinned at the selected subtree (or an empty relation)."""
        if not sel:
            return BoundAtom(trie, vars_)
        assert sorted(sel.keys()) == list(range(len(sel))), \
            "selections must be on a prefix of the trie order"
        depth = 0
        cursor = None  # scalar position during prebind
        for pos in range(len(sel)):
            lv = trie.levels[pos]
            if pos == 0:
                lo, hi = 0, len(lv.values)
            else:
                lo, hi = int(lv.offsets[cursor]), int(lv.offsets[cursor + 1])
            c = sel[pos]
            p = lo + int(np.searchsorted(lv.values[lo:hi], c))
            if p >= hi or lv.values[p] != c:
                # empty selection: an empty trie over the live suffix, so the
                # first live variable's extension yields an empty frontier.
                live = vars_[len(sel):]
                k = max(1, len(live))
                empty = Trie.build(trie.name, trie.attrs[len(sel):] or ("_",),
                                   [np.zeros(0, np.int32)] * k)
                return BoundAtom(empty, live or ("_",), depth=0, cursor=None)
            cursor = p
            depth += 1
        # vars_ keeps one name per trie attribute; selected positions carry
        # "$sel<i>" placeholders injected by the compiler, never in var_order.
        return BoundAtom(trie, vars_, depth=depth,
                         cursor=np.array([cursor], dtype=np.int64))

    # ------------------------------------------------------------------ run
    def run(self) -> GJResult:
        """Execute the join.  On the DeviceBackend, attribute extensions
        run device-resident with ONE closing sync; an undersized buffer
        (stats under-estimate) aborts before any state mutation and
        retries device-resident with count-informed capacities, using the
        per-extension-sync host path only as the last resort."""
        if self.backend.pipelined:
            # overflow-retry loop: an aborted attempt's closing sync
            # carries the counting pass's exact per-variable totals, so
            # the retry re-sizes each buffer from measured truth instead
            # of the (often wildly loose) cross-product bound.  A step
            # AFTER an overflowed one counted over a truncated frontier,
            # so its total is only a lower bound — but every retry's
            # counts are taken over fuller frontiers, so the measurements
            # grow monotonically and the loop converges device-resident
            # in at most one attempt per variable.
            # engine-lifetime cap feedback: a previous execution of this
            # same bag shape that overflowed recorded its measured
            # totals on the backend — seed from them so repeated queries
            # size their buffers right the FIRST time.  Stale entries
            # (relation reloaded under the same name) self-correct:
            # under-sized measurements re-overflow into this same loop,
            # over-sized ones are clamped by the live cross bound.
            fb_key = (self.var_order,
                      tuple((a.trie.name, tuple(a.vars))
                            for a in self.atoms))
            feedback = getattr(self.backend, "cap_feedback", None)
            needed: Dict[str, int] = {}
            if feedback is not None:
                needed.update(feedback.get(fb_key, {}))
            measured = False
            for attempt in range(len(self.var_order) + 1):
                try:
                    res = self._run(pipelined=True,
                                    exact_caps=attempt > 0,
                                    needed=needed or None)
                    if measured and feedback is not None:
                        feedback[fb_key] = dict(needed)
                    return res
                except backend_mod.PipelineOverflow as ovf:
                    self.backend.stats["pipeline.retries"] += 1
                    self.level_actuals = []
                    grew = False
                    for v, t in ovf.needed.items():
                        if t > needed.get(v, 0):
                            needed[v] = t
                            grew = True
                            measured = True
                    if not grew:  # pragma: no cover — measurement stuck
                        break
        return self._run(pipelined=False)

    def _run(self, pipelined: bool = False, exact_caps: bool = False,
             needed: Optional[Dict[str, int]] = None) -> GJResult:
        sr = self.semiring
        F = 1
        frontier: Dict[str, np.ndarray] = {}
        ann = sr.lift(1) if sr is not None else None
        ann = np.asarray(ann) if ann is not None else None
        atoms = self.atoms
        # broadcast pre-bound cursors to frontier length 1
        for a in atoms:
            if a.cursor is not None and len(a.cursor) != F:
                a.cursor = np.broadcast_to(a.cursor, (F,)).copy()

        pipe = (_PipelineDriver(self, exact_caps=exact_caps,
                                needed=needed)
                if pipelined else None)
        out_set = set(self.output_vars)
        for vi, v in enumerate(self.var_order):
            remaining = self.var_order[vi + 1:]
            # Early-aggregation fast path: the last attribute, not retained,
            # folds without materializing (e.g. |N(x) ∩ N(y)| for triangles).
            terminal = sr is not None and v not in out_set and not remaining
            if pipe is not None:
                if pipe.try_step(v, terminal):
                    continue
                # first host-needing step: land the device frontier (the
                # query's single closing sync) and continue below
                frontier, ann, F = pipe.finish()
                pipe = None
            cons = [a for a in atoms if a.next_var() == v]
            assert cons, f"variable {v} unconstrained at its turn"
            if terminal:
                fold, support = self._terminal_fold(cons, F)
                ann = sr.mul(ann, fold) if ann is not None else fold
                ann = np.asarray(ann)
                # rows with an EMPTY candidate intersection are NOT derived
                # (folding them to the semiring identity would leak e.g.
                # dist=inf tuples out of SSSP — caught by Table 7)
                if not support.all():
                    keep = np.flatnonzero(support)
                    frontier = {k: col[keep] for k, col in frontier.items()}
                    for a in atoms:
                        if a.cursor is not None and a not in cons:
                            a.cursor = a.cursor[keep]
                    ann = ann[keep]
                    F = len(keep)
                # frontier unchanged otherwise; v folded away
                self.level_actuals.append((v, int(F)))
                continue
            row_id, vals, pos = self._extend(cons, F)
            # rebuild frontier
            frontier = {k: col[row_id] for k, col in frontier.items()}
            frontier[v] = vals
            for a in atoms:
                if a in cons:
                    a.cursor = pos[id(a)]
                    a.depth += 1
                elif a.cursor is not None:
                    a.cursor = a.cursor[row_id]
            if ann is not None:
                ann = ann[row_id]
            # multiply in annotations of atoms that just exhausted their attrs
            if sr is not None:
                for a in cons:
                    if a.depth == len(a.trie.attrs) and a.trie.annotation is not None:
                        ann = sr.mul(ann, a.trie.annotation[a.cursor])
            F = len(vals)
            self.level_actuals.append((v, int(F)))
            if F == 0:
                # empty join: emit an empty result with all output columns
                empty_cols = {k: np.zeros(0, np.int32) for k in self.output_vars}
                empty_ann = None
                if sr is not None:
                    dt = self.backend.dtype_of(sr)
                    if self.output_vars:
                        empty_ann = np.zeros(0, dt)
                    else:
                        empty_ann = np.asarray(sr.zero, dtype=dt)
                return GJResult(self.output_vars, empty_cols, empty_ann)

        if pipe is not None:
            # every attribute extended on device: land once, project below
            frontier, ann, F = pipe.finish()
            pipe = None

        return self._finalize(frontier, ann, F)

    def _finalize(self, frontier: Dict[str, np.ndarray], ann,
                  F: int) -> GJResult:
        """Project a landed frontier to the output variables (group-by
        with the semiring fold, or dedup, where non-retained columns
        survived)."""
        out_set = set(self.output_vars)
        cols = {k: frontier[k] for k in self.output_vars if k in frontier}
        extra = [k for k in frontier if k not in out_set]
        if not extra and len(cols) == len(self.output_vars):
            return GJResult(self.output_vars, cols,
                            np.asarray(ann) if ann is not None else None)
        # group-by output vars, folding ann (or dedup)
        return self._project(cols, ann, F)

    # ------------------------------------------------------------ internals
    def _extend(self, cons: List[BoundAtom], F: int):
        """Intersect candidates of ``cons`` per frontier row; materialize.

        When the plan IR routed this extension to the layout store
        (``BagHints.extend_routing``), the binary self-join expansion is
        served cohort-routed by ``HybridSetStore.intersect_materialize``
        (bitset extraction for dense pairs). Otherwise: gathers each
        atom's per-row candidate bounds, orders by total candidate mass
        (the min-property seed first) and hands the whole extension to
        the backend — which expands the seed and probes every other atom
        (NumpyBackend: one search per atom; DeviceBackend: one fused
        device call for all atoms)."""
        routed = self._extend_pair_store(cons, F)
        if routed is not None:
            return routed
        infos = []
        for a in cons:
            values, lo, hi = a.candidate_bounds(F)
            infos.append((a, values, lo, hi, int((hi - lo).sum())))
        infos.sort(key=lambda t: t[4])
        return self.backend.extend(infos, F)

    def _extend_pair_store(self, cons: List[BoundAtom], F: int):
        """Layout-store fast path for a materializing binary self-join
        extension — applies only where the plan IR said so (hint), with
        the same runtime guards as the terminal-fold pair path.  Two
        hints route here: ``extend_routing`` for retained attributes, and
        ``terminal_routing == "pair_kernel"`` for the materialize inside
        an ANNOTATED terminal fold (which cannot take the count kernels
        but still profits from the cohort-routed expansion)."""
        h = self.hints
        if h is None or len(cons) != 2:
            return None
        a, b = cons
        routed = ((h.extend_routing or {}).get(a.next_var()) == "pair_store"
                  or h.terminal_routing == "pair_kernel")
        if not routed:
            return None
        thr = h.layout_threshold
        if (a.trie is not b.trie or a.trie.arity != 2
                or a.depth != 1 or b.depth != 1
                or a.cursor is None or b.cursor is None
                or not self.backend.has_pair_store(a.trie, threshold=thr)):
            return None
        u = a.trie.levels[0].values[a.cursor].astype(np.int64)
        v = b.trie.levels[0].values[b.cursor].astype(np.int64)
        out = self.backend.pair_materialize(a.trie, u, v, threshold=thr)
        if out is None:
            return None
        row_id, vals, pos_u, pos_v = out
        return row_id, np.asarray(vals, dtype=np.int32), \
            {id(a): pos_u, id(b): pos_v}

    def _terminal_fold(self, cons: List[BoundAtom], F: int):
        """Fold the last attribute without materializing the expansion.

        COUNT with no annotations on 2 relations is the common case
        (triangle counting): per-row intersection count. General case:
        materialize the per-row intersection *locally*, gather annotations,
        segment-reduce back to rows.

        Returns (folded [F], support [F] bool) — support marks rows whose
        candidate intersection was non-empty (only those are derived).
        """
        sr = self.semiring
        assert sr is not None
        self.backend.stats["fold.calls"] += 1
        has_ann = any(a.trie.annotation is not None for a in cons)
        if sr is COUNT and not has_ann:
            counts = self._fold_count(cons, F)
            return counts, counts > 0
        row_id, vals, pos = self._extend(cons, F)
        contrib = sr.lift(len(vals))
        contrib = np.asarray(contrib)
        for a in cons:
            if a.trie.annotation is not None and a.depth + 1 == len(a.trie.attrs):
                contrib = np.asarray(sr.mul(contrib, a.trie.annotation[pos[id(a)]]))
        folded = np.asarray(sr.segment_reduce(contrib, row_id.astype(np.int32), F))
        support = np.bincount(row_id, minlength=F) > 0
        return folded, support

    def _fold_count(self, cons: List[BoundAtom], F: int) -> np.ndarray:
        if len(cons) == 1:
            a, (values, lo, hi) = cons[0], cons[0].candidate_bounds(F)
            return (hi - lo).astype(np.int64)
        if len(cons) == 2:
            a, b = cons
            # Binary self-join terminal (the triangle hot path): route
            # through the backend's set-level layout store — bitset cohort
            # pairs take the AND+popcount kernel, sparse pairs the uint
            # kernel or lockstep search (paper Section 4). The plan IR's
            # TerminalFold annotation decides the route and the
            # statistics-driven Algorithm-3 threshold; without hints the
            # store falls back to its own statistics profile.
            thr = self.hints.layout_threshold if self.hints else None
            routed_off = (self.hints is not None
                          and self.hints.terminal_routing == "search")
            if (not routed_off
                    and a.trie is b.trie and a.trie.arity == 2
                    and a.depth == 1 and b.depth == 1
                    and a.cursor is not None and b.cursor is not None
                    and self.backend.has_pair_store(a.trie, threshold=thr)):
                u = a.trie.levels[0].values[a.cursor].astype(np.int64)
                v = b.trie.levels[0].values[b.cursor].astype(np.int64)
                out = self.backend.pair_count(a.trie, u, v, threshold=thr)
                if out is not None:
                    return out
        # chain: materialize smallest two's intersection per row, count others
        row_id, vals, _pos = self._extend(cons, F)
        return np.bincount(row_id, minlength=F).astype(np.int64)

    def _project(self, cols: Dict[str, np.ndarray], ann, F: int) -> GJResult:
        sr = self.semiring
        if not self.output_vars:
            if sr is None:
                return GJResult((), {}, None)
            total = np.asarray(sr.segment_reduce(
                np.asarray(ann), np.zeros(F, np.int32), 1))[0]
            return GJResult((), {}, np.asarray(total))
        key_cols = [cols[k] for k in self.output_vars]
        stacked = np.stack(key_cols, axis=1)
        uniq, inv = np.unique(stacked, axis=0, return_inverse=True)
        out_cols = {k: uniq[:, i].astype(np.int32)
                    for i, k in enumerate(self.output_vars)}
        if sr is None:
            return GJResult(self.output_vars, out_cols, None)
        folded = np.asarray(sr.segment_reduce(np.asarray(ann),
                                              inv.astype(np.int32), len(uniq)))
        return GJResult(self.output_vars, out_cols, folded)


# ------------------------------------------------------------- batched entry
def batch_signature(j: GenericJoin) -> Tuple:
    """Shape key deciding which GenericJoin instances may share one
    batched launch: same tries (by identity), same variable layout, same
    descent depths and cursor presence per atom.  Joins built from one
    prepared plan over one catalog differ only in their pre-bound cursor
    VALUES — except degenerate bindings (constant absent from the
    relation), whose ``_prebind`` substituted a fresh empty trie
    (distinct id) and which therefore fall out of the modal group."""
    return tuple((id(a.trie), a.vars, a.depth, a.cursor is not None)
                 for a in j.atoms)


def run_batched(joins: Sequence[GenericJoin]) -> Optional[List[GJResult]]:
    """Execute B same-shape GenericJoin instances as batched device
    launches — one ``run_bag_batched`` per ``statistics.max_batch``
    chunk, i.e. ONE launch for any batch whose buffers fit the device
    budget — returning results in submission order.

    Returns None when batching is ineligible (a backend without the
    pipeline, a step that must land on the host, or no bound cursor to
    carry the batch axis); the caller falls back to the sequential
    per-query loop.  Safe to fall back at any point: no atom state is
    mutated before the closing sync, and ``_finalize`` touches none
    after it.

    Joins outside the modal shape group (degenerate bindings) run
    through their own sequential ``run()`` — they are the rare case and
    already produce the canonical empty result.
    """
    joins = list(joins)
    if not joins:
        return []
    be = joins[0].backend
    if not (be.pipelined and hasattr(be, "run_bag_batched")):
        return None
    if any(j.backend is not be for j in joins[1:]):
        return None
    sigs = [batch_signature(j) for j in joins]
    tally: Dict[Tuple, int] = {}
    for s in sigs:
        tally[s] = tally.get(s, 0) + 1
    modal = max(tally, key=tally.get)
    group = [i for i, s in enumerate(sigs) if s == modal]
    rest = [i for i, s in enumerate(sigs) if s != modal]
    template = joins[group[0]]
    sr = template.semiring
    out_set = set(template.output_vars)
    cursor_atoms = [j for j, a in enumerate(template.atoms)
                    if a.cursor is not None]
    if not cursor_atoms:
        # nothing binds a batch axis: B identical unparameterized queries
        # are better served by the bag cache than by a batched launch
        return None

    def record(exact_caps: bool, needed: Dict[str, int]):
        """Re-run the driver's recording pass (binding-independent: caps
        come from trie statistics and plan hints, never cursor values) to
        produce the step chain at the given capacities."""
        pipe = _PipelineDriver(template, exact_caps=exact_caps,
                               needed=needed or None)
        for vi, v in enumerate(template.var_order):
            remaining = template.var_order[vi + 1:]
            terminal = (sr is not None and v not in out_set
                        and not remaining)
            if not pipe.try_step(v, terminal):
                return None
        return pipe

    fb_key = (template.var_order,
              tuple((a.trie.name, tuple(a.vars)) for a in template.atoms))
    feedback = getattr(be, "cap_feedback", None)
    needed: Dict[str, int] = {}
    if feedback is not None:
        needed.update(feedback.get(fb_key, {}))
    pipe = record(False, needed)
    if pipe is None or not pipe.plans:
        return None
    results: List[Optional[GJResult]] = [None] * len(joins)
    measured = False
    peak_cap = max((op[3] for op in pipe.plans if op[0] == "extend"),
                   default=1)
    chunk = stats_mod.max_batch(peak_cap)
    for start in range(0, len(group), chunk):
        idxs = group[start:start + chunk]
        counts = cols = ann_b = None
        for _attempt in range(len(template.var_order) + 1):
            cursors0 = {
                id(template.atoms[j]): np.stack(
                    [joins[i].atoms[j].cursor for i in idxs])
                for j in cursor_atoms}
            ann0 = np.asarray(sr.lift(1)) if sr is not None else None
            state = be.run_bag_batched(cursors0, ann0, list(pipe.plans))
            (counts, overflows, cols, _cursors, ann_b,
             step_needed) = be.pipeline_land_batched(state)
            if not overflows.any():
                break
            be.stats["pipeline.retries"] += 1
            grew = False
            for v, t in step_needed.items():
                if t > needed.get(v, 0):
                    needed[v] = t
                    grew = True
                    measured = True
            if not grew:  # pragma: no cover — measurement stuck
                return None
            pipe = record(True, needed)
            if pipe is None:
                return None
        else:  # pragma: no cover — retries exhausted
            return None
        for bi, i in enumerate(idxs):
            f = int(counts[bi])
            frontier = {k: np.asarray(c[bi])[:f] for k, c in cols.items()}
            ann_i = np.asarray(ann_b[bi])[:f] if ann_b is not None else None
            results[i] = template._finalize(frontier, ann_i, f)
    if measured and feedback is not None:
        feedback[fb_key] = dict(needed)
    for i in rest:
        results[i] = joins[i].run()
    return results
