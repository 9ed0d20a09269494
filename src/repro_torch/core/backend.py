"""Execution backends: where sets live and who intersects them.

Counterpart of ``repro.core.backend``.  EmptyHeaded's algorithm layer
(Generic-Join over GHD bags, ``core.gj``) is decoupled from the
data-placement/intersection layer:

  * :class:`NumpyBackend` — the host oracle: trie levels stay host numpy,
    each probe atom's lockstep binary search is a separate CPU call.
  * :class:`DeviceBackend` — trie levels are uploaded once to the device
    (``cuda`` unless the caller names another), each bag's attribute
    extensions run as one device-resident count-then-fill chain with ONE
    closing transfer, and terminal-fold intersections are partitioned
    into bitset/uint cohorts (Algorithm 3) and dispatched to the CUDA
    kernels.  On a CPU device every kernel wrapper takes its plain
    PyTorch version — that is how the tests run it.

Every backend carries ``stats``, a flat counter recording which kernel
handled each intersection (``intersect.*`` keys count pairs) and the
host-sync discipline of the extension loop (``extend.calls`` vs
``extend.host_syncs`` vs ``extend.closing_syncs``).

The device pipeline runs eagerly, so nothing in a bag's chain may read a
device value on the host: every data-dependent size is either bounded
statically on the host (the frontier capacity of an extension) with the
kernel masking what lies past the device-side total, handled inside one
kernel (a terminal fold reduces each row's candidates in place), or
counted on the device and read at the closing sync (``pipeline.morsels``,
the overflow flag, the counting-pass totals).
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import intersect as I
from repro_torch.core.layouts import engine_store_for
from repro_torch.core.semiring import Semiring
from repro_torch.kernels.bitset_intersect import ops as bitset_ops
from repro_torch.kernels.common import (IDX, IDX_NP, default_device,
                                        host_get)
from repro_torch.kernels.frontier_fill import ops as ff_ops
from repro_torch.kernels.materialize import ops as mat_ops
from repro_torch.kernels.uint_intersect import ops as uint_ops

# Pairs whose larger set exceeds this stay on the lockstep binary search
# (the SIMDGalloping analogue); shorter pairs take the uint kernel
# (the SIMDShuffling analogue) — Algorithm 2's regime split.
UINT_KERNEL_MAX_LEN = 256


class PipelineOverflow(RuntimeError):
    """A pipelined frontier buffer was undersized (the stats-informed
    capacity under-estimated the true expansion).  Raised at the single
    closing sync, BEFORE any join state was mutated.  ``needed`` carries
    the counting pass's exact per-variable output totals fetched with
    that same sync — the caller retries device-resident with buffers
    sized from the measured truth."""

    def __init__(self, msg: str, needed: Optional[Dict[str, int]] = None):
        super().__init__(msg)
        self.needed = needed or {}


class ExecBackend:
    """Protocol for the Generic-Join execution backend.

    ``extend(infos, F)`` receives the per-atom candidate descriptors of
    one attribute extension — ``infos`` is a list of
    ``(atom, values, lo, hi, mass)`` tuples sorted by total candidate
    mass (the min-property seed first) — and returns
    ``(row_id, vals, pos)``: ``pos`` maps ``id(atom)`` to absolute
    positions into that atom's current trie level.

    ``pair_count(trie, u, v)`` is the binary terminal-fold fast path:
    layout-routed ``|N(u_i) ∩ N(v_i)|`` counts, or ``None`` when the
    store is bypassed (layout mode "off"). ``has_pair_store(trie)`` lets
    the caller skip the frontier gathers entirely in the bypassed case.
    """

    name = "abstract"
    # True when GenericJoin should drive the device-resident pipeline
    # (``run_bag`` / ``pipeline_land``)
    pipelined = False

    def __init__(self, device):
        self.device = torch.device(device)
        self.stats: collections.Counter = collections.Counter()

    def dtype_of(self, sr: Semiring) -> np.dtype:
        return sr.np_dtype

    def extend(self, infos: Sequence[Tuple], F: int):
        raise NotImplementedError

    @staticmethod
    def _expand_seed(lo0: np.ndarray, hi0: np.ndarray, F: int):
        """Min-property seed expansion shared by both backends: flatten
        every frontier row's seed segment, returning (row_id, p0) with
        ``p0`` absolute positions into the seed level's values."""
        cnt = (hi0 - lo0).astype(np.int64)
        row_id = np.repeat(np.arange(F, dtype=np.int64), cnt)
        seg_start = np.repeat(np.concatenate([[0], np.cumsum(cnt)])[:-1], cnt)
        flat = np.arange(len(row_id), dtype=np.int64)
        p0 = np.repeat(lo0, cnt) + (flat - seg_start)
        return row_id, p0

    def _pair_store(self, trie, threshold: Optional[float] = None):
        raise NotImplementedError

    def has_pair_store(self, trie,
                       threshold: Optional[float] = None) -> bool:
        return self._pair_store(trie, threshold) is not None

    def pair_count(self, trie, u: np.ndarray, v: np.ndarray,
                   threshold: Optional[float] = None):
        """Binary terminal-fold fast path. ``threshold`` is the plan IR's
        statistics-driven Algorithm-3 density threshold (None lets the
        layout store profile the trie itself)."""
        store = self._pair_store(trie, threshold)
        if store is None:
            return None
        self.stats["fold.pair_count_calls"] += 1
        return store.intersect_count(u, v)

    def pair_materialize(self, trie, u: np.ndarray, v: np.ndarray,
                         threshold: Optional[float] = None):
        """Binary MATERIALIZING extension fast path (the plan IR's
        ``Extend.routing == "pair_store"``): cohort-routed
        ``N(u_i) ∩ N(v_i)`` with positions for trie descent, or ``None``
        when the layout store is bypassed (layout mode "off")."""
        store = self._pair_store(trie, threshold)
        if store is None:
            return None
        self.stats["extend.pair_materialize_calls"] += 1
        return store.intersect_materialize(u, v)

    def dispatch_summary(self) -> Dict[str, int]:
        return dict(self.stats)


class NumpyBackend(ExecBackend):
    """Host oracle: host-side expansion, one CPU search per probe atom,
    layout store on the binary terminal fold with the plain word kernel."""

    name = "numpy"

    def __init__(self):
        super().__init__("cpu")

    def extend(self, infos, F: int):
        a0, v0, lo0, hi0, _ = infos[0]
        row_id, p0 = self._expand_seed(lo0, hi0, F)
        vals = v0[p0]
        pos = {id(a0): p0}
        self.stats["extend.calls"] += 1
        for a, values, lo, hi, _m in infos[1:]:
            p, found = host_get(I.segment_searchsorted(
                torch.from_numpy(values), lo[row_id], hi[row_id], vals))
            self.stats["extend.host_syncs"] += 1
            keep = found
            row_id = row_id[keep]
            vals = vals[keep]
            for k in pos:
                pos[k] = pos[k][keep]
            pos[id(a)] = p[keep].astype(np.int64)
        return row_id, vals, pos

    def _pair_store(self, trie, threshold=None):
        return engine_store_for(trie, device=self.device, counter=self.stats,
                                cache_tag="host", threshold=threshold)


class DeviceBackend(ExecBackend):
    """Device-resident set store: upload trie levels once, run each bag's
    extension chain on the device with one closing transfer, and route
    terminal-fold intersections to the layout-cohort CUDA kernels.

    ``device`` defaults to ``cuda``; it raises when no card is present.
    Pass ``device="cpu"`` to run the same program with every kernel's
    plain PyTorch version (the tests do)."""

    name = "device"
    pipelined = True

    def __init__(self, device=None,
                 uint_max_len: int = UINT_KERNEL_MAX_LEN):
        super().__init__(default_device(device, "DeviceBackend"))
        self._uint_max_len = uint_max_len
        # engine-lifetime pipeline-cap feedback: bag shape -> the
        # counting pass's measured per-variable totals from an
        # overflow-retried execution, so repeated queries size their
        # frontier buffers right the first time (see GenericJoin.run)
        self.cap_feedback: Dict[Tuple, Dict[str, int]] = {}

    # ------------------------------------------------------------- uploads
    def _to_dev(self, arr) -> torch.Tensor:
        return torch.as_tensor(np.asarray(arr), device=self.device)

    def _up_idx(self, arr) -> torch.Tensor:
        return torch.as_tensor(np.asarray(arr, dtype=IDX_NP),
                               device=self.device)

    def _dev_values(self, atom) -> torch.Tensor:
        lv = atom.trie.levels[atom.depth]
        return lv.device_values(self._to_dev, on_upload=self._count_upload)

    def _count_upload(self):
        self.stats["upload.levels"] += 1

    def _dev_sideways(self, bs):
        """Device copies of a blocked bitset's DIRECTORY (slot router,
        block CSR, block ids) for the counting pass's sideways block
        intersection — the words themselves stay with the layout store.
        Cached on the bitset instance, invalidated if it was rebuilt."""
        cached = getattr(bs, "_dev_sideways_cache", None)
        if cached is not None and cached[0] is bs.block_ids:
            return cached[1]
        dev = (self._up_idx(bs.slot_of), self._up_idx(bs.offsets),
               self._up_idx(bs.block_ids))
        bs._dev_sideways_cache = (bs.block_ids, dev)
        self.stats["upload.bitset_dirs"] += 1
        return dev

    # ------------------------------------------------------------- extend
    def extend(self, infos, F: int):
        """Per-extension path (one host sync): the host expands the seed,
        the device probes every other atom in one pass."""
        self.stats["extend.calls"] += 1
        a0, v0, lo0, hi0, _ = infos[0]
        row_id, p0 = self._expand_seed(lo0, hi0, F)
        if len(row_id) == 0:
            z = np.zeros(0, np.int64)
            return z, np.zeros(0, np.int32), {id(a): z for a, *_ in infos}
        if len(infos) == 1:
            # unary extension: no probes, so the host copy already has the
            # answer — zero device traffic
            return row_id, v0[p0], {id(a0): p0}
        vals_dev = self._dev_values(a0)[self._up_idx(p0)]
        values_t = tuple(self._dev_values(a) for a, *_ in infos[1:])
        lo_t = tuple(info[2][row_id] for info in infos[1:])
        hi_t = tuple(info[3][row_id] for info in infos[1:])
        pos_t, found = _fused_probe(values_t, lo_t, hi_t, vals_dev)
        # the ONLY host round-trip of this extension: every probe atom's
        # positions + the combined membership mask come back together.
        pos_h, found_h, vals_h = host_get((pos_t, found, vals_dev))
        self.stats["extend.host_syncs"] += 1
        keep = found_h
        out_row = row_id[keep]
        out_vals = vals_h[keep]
        pos = {id(a0): p0[keep]}
        for (a, *_), p in zip(infos[1:], pos_h):
            pos[id(a)] = p[keep].astype(np.int64)
        return out_row, out_vals, pos

    # ------------------------------------------------------ terminal folds
    def _pair_store(self, trie, threshold=None):
        return engine_store_for(trie, device=self.device,
                                pair_kernel=bitset_ops.bitset_pair_count,
                                uint_kernel=uint_ops.intersect_count_csr,
                                materialize_kernel=(
                                    mat_ops.bitset_pair_materialize),
                                uint_max_len=self._uint_max_len,
                                counter=self.stats,
                                cache_tag=f"device:{self.device}",
                                threshold=threshold)

    # ---------------------------------------------- zero-sync pipeline
    # The frontier stays device-resident between attribute extensions:
    # a bag's recorded chain runs as count-then-fill steps (counting probe
    # -> exclusive scan -> frontier_fill over the static buffer ->
    # compaction) with NO host round-trip.  The join "lands" once per bag
    # (``pipeline_land``'s host_get) — so ``extend.host_syncs`` is zero
    # and ``extend.closing_syncs`` is one for non-materializing queries.

    def run_bag(self, cursors0: Dict[int, np.ndarray],
                ann0: Optional[np.ndarray],
                steps: Sequence[Tuple]) -> "DeviceFrontier":
        """Execute ONE bag's whole recorded extension chain on the device.

        ``steps`` is the host-recorded plan (one tuple per attribute:
        ``("extend", var, cons, cap_out, morsel)``,
        ``("fold", var, cons, sr, morsel)`` or
        ``("annmul", cursor_key, trie, sr)``).  The chain is lowered to a
        program over a flat deduplicated operand list and run eagerly;
        the closing ``pipeline_land`` stays the only transfer.
        """
        self.stats["pipeline.launches"] += 1
        return DeviceFrontier(**self._run_program(cursors0, ann0, steps))

    def run_bag_batched(self, cursors0: Dict[int, np.ndarray],
                        ann0: Optional[np.ndarray],
                        steps: Sequence[Tuple]) -> "BatchedFrontier":
        """Execute B same-shape bag instances as ONE batched launch.

        ``cursors0`` maps each pre-bound atom to a ``[B, 1]`` cursor
        stack, one row per query.  The chain is lowered through the same
        ``_lower_bag`` as the single-query path and run by the same
        ``_bag_program`` with a leading batch axis: the operand arrays
        (trie levels, shared by every query) stay unbatched, and each
        fill and fold step is one launch of the batched kernel for all B
        queries.  ``pipeline.launches`` and ``pipeline.batched_launches``
        rise by one, ``pipeline.batched_queries`` by B;
        ``pipeline_land_batched`` is the single closing transfer."""
        b = int(next(iter(cursors0.values())).shape[0])
        self.stats["pipeline.launches"] += 1
        self.stats["pipeline.batched_launches"] += 1
        self.stats["pipeline.batched_queries"] += b
        return BatchedFrontier(batch=b, **self._run_program(
            cursors0, ann0, steps, batch=b))

    def _run_program(self, cursors0, ann0, steps, batch=None) -> Dict:
        """Lower and run one bag chain; the frontier's fields."""
        prog_t, arrays, canon, cap = self._lower_bag(steps, cursors0)
        cur_canon = {canon[k]: self._up_idx(c)
                     for k, c in cursors0.items()}
        ann = self._to_dev(ann0) if ann0 is not None else None
        (count, overflow, morsels, lcounts, needs, cols, cursors,
         ann_o) = _bag_program(tuple(arrays), cur_canon, ann, prog=prog_t,
                               batch=batch)
        id_of = {v: k for k, v in canon.items()}
        lvars = [s[1] for s in prog_t if s[0] in ("extend", "fold")]
        evars = [s[1] for s in prog_t if s[0] == "extend"]
        return dict(
            cap=cap, count=count, overflow=overflow, morsels=morsels,
            cols=dict(cols),
            cursors={id_of[c]: cur for c, cur in cursors.items()},
            ann=ann_o, level_counts=list(zip(lvars, lcounts)),
            needed=list(zip(evars, needs)))

    def _lower_bag(self, steps: Sequence[Tuple],
                   cursors0: Dict[int, np.ndarray]):
        """Lower a host-recorded bag chain to the program ``_bag_program``
        consumes: ``(prog, arrays, canon, final cap)``.  Dispatch
        counters for the chain's steps are charged here."""
        canon: Dict[int, int] = {}

        def ckey(k):
            if k not in canon:
                canon[k] = len(canon)
            return canon[k]

        for k in cursors0:
            ckey(k)
        arrays: List = []
        seen: Dict[int, int] = {}

        def aref(x):
            if x is None:
                return -1
            i = seen.get(id(x))
            if i is None:
                i = len(arrays)
                arrays.append(x)
                seen[id(x)] = i
            return i

        def upload(lv, d0):
            vals_i = aref(lv.device_values(self._to_dev,
                                           on_upload=self._count_upload))
            offs_i = -1 if d0 else aref(lv.device_offsets(
                self._up_idx, on_upload=self._count_upload))
            return vals_i, offs_i

        prog = []
        cap = 1
        for step in steps:
            kind = step[0]
            if kind == "extend":
                _, var, cons, cap_out, morsel = step
                self.stats["extend.calls"] += 1
                self.stats["extend.pipeline_extends"] += 1
                if len(cons) > 1:
                    self.stats["pipeline.sip_extends"] += 1
                if any(c[3] is not None for c in cons[1:]):
                    self.stats["pipeline.sideways_extends"] += 1
                cdescs = []
                for i, (key, lv, d0, sw) in enumerate(cons):
                    vals_i, offs_i = upload(lv, d0)
                    swt = None
                    if sw is not None and i > 0:
                        l0, bs = sw
                        l0v = l0.device_values(
                            self._to_dev, on_upload=self._count_upload)
                        slot_d, boffs_d, bids_d = self._dev_sideways(bs)
                        swt = (aref(l0v), aref(slot_d), aref(boffs_d),
                               aref(bids_d), int(bs.block_bits))
                    cdescs.append((ckey(key), vals_i, offs_i, swt))
                prog.append(("extend", var, int(cap_out), int(morsel),
                             tuple(cdescs)))
                cap = int(cap_out)
            elif kind == "fold":
                _, var, cons, sr, morsel = step
                self.stats["fold.calls"] += 1
                self.stats["pipeline.device_folds"] += 1
                cdescs = []
                for key, lv, d0, ann_trie in cons:
                    vals_i, offs_i = upload(lv, d0)
                    ann_i = -1
                    if ann_trie is not None:
                        ann_i = aref(ann_trie.device_annotation(
                            self._to_dev, on_upload=self._count_upload))
                    cdescs.append((ckey(key), vals_i, offs_i, ann_i))
                prog.append(("fold", var, int(morsel), sr, tuple(cdescs)))
            elif kind == "annmul":
                _, key, trie, sr = step
                ann_i = aref(trie.device_annotation(
                    self._to_dev, on_upload=self._count_upload))
                prog.append(("annmul", ckey(key), ann_i, sr))
            else:
                raise ValueError(f"unknown bag step {kind!r}")
        return tuple(prog), arrays, canon, cap

    def pipeline_land(self, state: "DeviceFrontier"):
        """THE closing sync: fetch the compacted frontier (columns,
        cursors, annotation), the per-level counts, the fill-chunk count
        and the overflow flag in one transfer.  Counted as
        ``extend.closing_syncs``."""
        scal_h, packed_h, ann, col_keys, cur_keys = self._land(state)
        nl = len(state.level_counts)
        count, overflow, morsels = (int(scal_h[0]), bool(scal_h[1]),
                                    int(scal_h[2]))
        self.stats["pipeline.morsels"] += morsels
        levels = [(v, int(c)) for (v, _), c in
                  zip(state.level_counts, scal_h[3:3 + nl])]
        needed = {v: int(t) for (v, _), t in
                  zip(state.needed, scal_h[3 + nl:])}
        cols = {k: packed_h[i] for i, k in enumerate(col_keys)}
        cursors = {k: packed_h[len(col_keys) + i]
                   for i, k in enumerate(cur_keys)}
        return (count, overflow, cols, cursors, ann, levels, needed)

    def pipeline_land_batched(self, state: "BatchedFrontier"):
        """THE closing sync of a batched bag run: every query's compacted
        frontier, per-level counts and overflow flag in ONE transfer
        (``extend.closing_syncs`` += 1 for the whole batch).  Returns
        ``(counts [B], overflows [B], cols, cursors, ann, needed)`` with
        ``needed`` the worst case over the batch per variable: an
        overflow retry sizes one buffer shape for every query."""
        scal_h, packed_h, ann, col_keys, cur_keys = self._land(state)
        nl = len(state.level_counts)
        counts = np.asarray(scal_h[0], dtype=np.int64)
        overflows = np.asarray(scal_h[1]).astype(bool)
        self.stats["pipeline.morsels"] += int(np.asarray(scal_h[2]).sum())
        needed = {v: int(np.asarray(t).max(initial=0)) for (v, _), t in
                  zip(state.needed, scal_h[3 + nl:])}
        cols = {k: packed_h[i] for i, k in enumerate(col_keys)}
        cursors = {k: packed_h[len(col_keys) + i]
                   for i, k in enumerate(cur_keys)}
        return (counts, overflows, cols, cursors, ann, needed)

    def _land(self, state):
        """The one transfer of a landing, counted as a closing sync.  The
        payload is packed into three leaves (scalars, int vectors,
        annotation) first; every live vector shares the final capacity,
        so one stacked tensor carries them all ([n, cap], or [n, B, cap]
        for a batch, as the scalars are [n] or [n, B])."""
        scal = torch.stack(
            [state.count.to(IDX), state.overflow.to(IDX),
             state.morsels.to(IDX)]
            + [c.to(IDX) for _v, c in state.level_counts]
            + [t.to(IDX) for _v, t in state.needed])
        col_keys = list(state.cols)
        cur_keys = list(state.cursors)
        vecs = ([state.cols[k].to(IDX) for k in col_keys]
                + [state.cursors[k] for k in cur_keys])
        packed = torch.stack(vecs) if vecs else None
        scal_h, packed_h, ann = host_get((scal, packed, state.ann))
        self.stats["extend.closing_syncs"] += 1
        return scal_h, packed_h, ann, col_keys, cur_keys


@dataclasses.dataclass
class DeviceFrontier:
    """Device-resident Generic-Join frontier after a bag's chain.  All
    buffers are static-shaped ``[cap]``; ``count`` (a device scalar)
    marks the live prefix and slots past it hold zeros.  ``overflow`` is
    sticky: set when a counting pass found more rows than the buffer
    holds, read exactly once at the closing sync."""

    cap: int                            # static buffer capacity
    count: torch.Tensor                 # [] live rows
    overflow: torch.Tensor              # [] bool, sticky
    morsels: torch.Tensor               # [] fill chunks the reference runs
    cols: Dict[str, torch.Tensor]       # var -> int32 [cap]
    cursors: Dict[int, torch.Tensor]    # id(atom) -> positions [cap]
    ann: Optional[torch.Tensor]         # semiring annotation [cap]
    level_counts: List                  # [(var, count snapshot)]
    needed: List                        # [(var, counting-pass total)]


@dataclasses.dataclass
class BatchedFrontier(DeviceFrontier):
    """``DeviceFrontier`` of B same-shape bag instances run as one
    batched program: every per-query field gains a leading axis of
    extent ``batch`` (``count``/``overflow``/``morsels`` ``[B]``, the
    vectors ``[B, cap]``); ``cap`` stays the shared buffer capacity."""

    batch: int = 1


def _bounds(values, offsets, cursor, cap_in, valid):
    """Per-row candidate bounds [cap_in] of one atom, on device: the
    whole level at depth 0 (no cursor), else the cursor's CSR segment.
    Dead rows get an empty segment."""
    n = values.shape[0]
    dev = values.device
    if cursor is None:
        lo = torch.zeros(valid.shape, dtype=IDX, device=dev)
        hi = torch.full(valid.shape, n, dtype=IDX, device=dev)
    else:
        c = cursor.clamp(0, offsets.shape[0] - 2)
        lo = offsets[c]
        hi = offsets[c + 1]
    zero = torch.zeros((), dtype=IDX, device=dev)
    return torch.where(valid, lo, zero), torch.where(valid, hi, zero)


def _clip_index(x, n):
    return x.clamp(0, max(n - 1, 0))


def _envelope(seed, probes, cap_in, count):
    """Counting pass shared by extensions and folds: per-row seed bounds
    and every probe atom's bounds, the liveness mask (a probe with an
    empty segment kills the row) and the sideways min/max envelope of
    the probe atoms' candidate ranges.  Every per-row tensor here and in
    the steps below is ``[cap]`` for one query or ``[B, cap]`` for a
    batch (``count`` ``[]`` or ``[B]``); the steps act on the last axis."""
    seed_values, seed_offsets, seed_cursor = seed
    valid = torch.arange(cap_in, dtype=IDX,
                         device=seed_values.device) < count.unsqueeze(-1)
    lo0, hi0 = _bounds(seed_values, seed_offsets, seed_cursor, cap_in,
                       valid)
    bounds = []
    alive = valid
    gmin = gmax = None
    for vals_k, offs_k, cur_k in probes:
        nk = vals_k.shape[0]
        lo_k, hi_k = _bounds(vals_k, offs_k, cur_k, cap_in, valid)
        alive = alive & (lo_k < hi_k)
        mn = vals_k[_clip_index(lo_k, nk)]
        mx = vals_k[_clip_index(hi_k - 1, nk)]
        gmin = mn if gmin is None else torch.maximum(gmin, mn)
        gmax = mx if gmax is None else torch.minimum(gmax, mx)
        bounds.append((vals_k, lo_k, hi_k))
    return lo0, hi0, bounds, alive, gmin, gmax


def _clip_seed(seed_values, lo0, hi0, gmin, gmax):
    """Clip every seed segment to the [gmin, gmax] envelope — rows
    outside it would fail every probe anyway, so the result set (and its
    ordering) is unchanged while the expansion shrinks."""
    p_lo, _ = I.segment_searchsorted(seed_values, lo0, hi0, gmin)
    p_hi, f_hi = I.segment_searchsorted(seed_values, lo0, hi0, gmax)
    return p_lo, p_hi + f_hi.to(IDX)


def _scan(alive, lo0, hi0):
    """Counting pass + exclusive scan: per-row expansion sizes, output
    offsets and the total, all int32 on the device."""
    cnt = torch.where(alive, (hi0 - lo0).clamp(min=0),
                      torch.zeros((), dtype=IDX, device=lo0.device)).to(IDX)
    offs = torch.cumsum(cnt, -1, dtype=IDX) - cnt
    total = offs[..., -1] + cnt[..., -1]
    return cnt, offs, total


def _chunks(total, morsel: int):
    """Fill chunks the reference's morsel loop runs: ceil(total / morsel)."""
    return ((total + (morsel - 1)) // morsel).clamp(min=0).to(IDX)


def _compact(keep, xs, cap: int):
    """Order-preserving dense prefix of the kept slots of each ``x``
    (slots past the new count hold zeros), and the new count.  A batch
    compacts each query's row into its own ``cap + 1`` slots of one flat
    buffer."""
    widx = torch.cumsum(keep.to(IDX), -1, dtype=IDX) - 1
    new_count = widx[..., -1] + 1
    scat = torch.where(keep, widx, cap).to(torch.int64)
    rows = keep.shape[0] if keep.dim() > 1 else 1
    if keep.dim() > 1:
        scat = scat + (cap + 1) * torch.arange(
            rows, dtype=torch.int64, device=keep.device).unsqueeze(1)
    out = []
    for x in xs:
        buf = torch.zeros(rows * (cap + 1), dtype=x.dtype, device=x.device)
        buf.index_copy_(0, scat.reshape(-1), x.reshape(-1))
        out.append(buf.view(keep.shape[:-1] + (cap + 1,))[..., :cap])
    return new_count, out


def _take(x, idx):
    """``x``'s entries at the per-row positions ``idx`` (each query's own
    row of ``x`` for a batch)."""
    if x.dim() == 1:
        return x[idx]
    return torch.gather(x, 1, idx.to(torch.int64))


def _extend_body(count, overflow, seed, probes, sideways, carry, *,
                 cap_in: int, cap_out: int, morsel: int,
                 sideways_bits: Tuple):
    """One zero-sync attribute extension: count-then-fill.

    1. counting probe: per-row seed-segment sizes, narrowed by sideways
       min/max information from every later (probe) atom — and, for
       probe atoms with a ``sideways`` bitset directory, by intersecting
       the probe row's POPULATED bitset blocks with the envelope (dense
       cohorts prune before expansion, not just clip);
    2. exclusive scan -> per-row output offsets + total (the overflow
       check against the static capacity);
    3. fill: ONE ``frontier_fill`` launch over all ``cap_out`` slots; the
       kernel reads the capped total on the device and masks the slots
       past it, so no host read sizes the loop.  ``chunks`` is the number
       of morsel chunks the reference's fill loop runs;
    4. compaction: scatter surviving rows to a dense prefix and gather
       the previous frontier's columns/cursors/annotation through them.

    Output ordering (frontier-row-major, values ascending within a row)
    is identical to the host path's, so results match exactly.
    """
    seed_values = seed[0]
    lo0, hi0, bounds, alive, gmin, gmax = _envelope(seed, probes, cap_in,
                                                    count)

    # ---- bitset sideways pass: a dense-cohort probe atom's candidate
    # set is exactly the union of its POPULATED bitset blocks, so the
    # envelope can only contain matches inside blocks the directory
    # lists.  Search the row's block-id segment for the envelope's
    # block range: rows with no populated block in range die here, and
    # the envelope snaps inward to the first/last populated block.
    # Rows routed to the sparse cohort (slot_of < 0) pass through.
    for sw, bbits, (_v, _o, cur_k) in zip(sideways, sideways_bits, probes):
        if sw is None or cur_k is None:
            continue
        l0v, slot_of, boffs, bids = sw
        nid = slot_of.shape[0]
        ns = boffs.shape[0] - 1
        nb = bids.shape[0]
        ids = l0v[_clip_index(cur_k, l0v.shape[0])]
        slot = slot_of[_clip_index(ids, nid)]
        in_bs = alive & (ids >= 0) & (ids < nid) & (slot >= 0)
        s = _clip_index(slot, ns)
        zero = torch.zeros((), dtype=IDX, device=ids.device)
        blo = torch.where(in_bs, boffs[s], zero)
        bhi = torch.where(in_bs, boffs[s + 1], zero)
        qlo = (gmin // bbits).to(bids.dtype)
        qhi = (gmax // bbits).to(bids.dtype)
        p_lo, _ = I.segment_searchsorted(bids, blo, bhi, qlo)
        p_hi, f_hi = I.segment_searchsorted(bids, blo, bhi, qhi)
        last = p_hi + f_hi.to(IDX) - 1
        has = in_bs & (p_lo <= last)
        alive = alive & (~in_bs | has)
        fb = bids[_clip_index(p_lo, nb)]
        lb = bids[_clip_index(last, nb)]
        gmin = torch.where(has, torch.maximum(gmin, fb * bbits), gmin)
        gmax = torch.where(has, torch.minimum(gmax, (lb + 1) * bbits - 1),
                           gmax)

    if probes:
        lo0, hi0 = _clip_seed(seed_values, lo0, hi0, gmin, gmax)

    cnt, offs, total = _scan(alive, lo0, hi0)
    overflow = overflow | (total > cap_out)
    total_c = total.clamp(max=cap_out)
    chunks = _chunks(total_c, morsel)

    vals, row, p0, keep, poss = ff_ops.fill(
        total_c, offs, lo0, seed_values, tuple(bounds), 0, cap_out)

    new_count, (vals_c, row_c, p0_c, *pos_c) = _compact(
        keep, (vals, row, p0) + tuple(poss), cap_out)
    rowg = _clip_index(row_c, cap_in)
    carry_c = tuple(_take(g, rowg) for g in carry)
    # ``total`` is the UNCAPPED counting-pass truth: landed with the
    # closing sync so an overflow retry can size this buffer exactly
    return (new_count, overflow, chunks, total, vals_c, p0_c, tuple(pos_c),
            carry_c)


def _fold_body(count, seed, probes, ann, leaf_anns, carry, *,
               cap_in: int, morsel: int, sr: Semiring):
    """Terminal-fold companion of ``_extend_body``: identical counting
    pass, then ONE ``frontier_fold`` call, over the scan's offsets and
    its device-side total, reduces each row's candidates (probed like the
    fill's) straight onto the row with the semiring — nothing is
    materialized, so no output capacity, no overflow and no size to
    read.  ``chunks`` is the number of morsel chunks the
    reference's fold loop runs.  Returns the support-compacted frontier
    (rows with an empty candidate intersection are NOT derived — same
    rule as the host fold)."""
    seed_values = seed[0]
    dev = seed_values.device
    lo0, hi0, bounds, alive, gmin, gmax = _envelope(seed, probes, cap_in,
                                                    count)
    if probes:
        lo0, hi0 = _clip_seed(seed_values, lo0, hi0, gmin, gmax)
    cnt, offs, total = _scan(alive, lo0, hi0)

    plain = not probes and all(la is None for la in leaf_anns)
    if plain and sr.name == "count":
        # counting a bare segment needs no expansion at all: the
        # counting pass IS the fold (e.g. lollipop's pendant edge)
        folded = cnt.to(sr.dtype)
        supp = cnt
        chunks = torch.zeros(total.shape, dtype=IDX, device=dev)
    else:
        chunks = _chunks(total, morsel)
        anns = tuple(None if la is None else la.to(sr.dtype).contiguous()
                     for la in leaf_anns)
        folded, supp = ff_ops.fold(lo0, offs, total, seed_values,
                                   tuple(bounds), anns, sr)

    ann_new = sr.mul(ann, folded.to(ann.dtype))
    support = supp > 0
    new_count, compacted = _compact(support, (ann_new,) + tuple(carry),
                                    cap_in)
    return new_count, chunks, compacted[0], tuple(compacted[1:])


def _bag_program(arrays, cursors0, ann, *, prog: Tuple,
                 batch: Optional[int] = None):
    """ONE bag's whole extension chain, run eagerly on the device.

    ``prog`` is the lowering built by ``run_bag``: per step the
    constraining atoms reference operands by index into the flat
    deduplicated ``arrays`` tuple and cursors by canonical ordinal.
    With ``batch`` the chain runs B same-shape instances at once (the
    reference vmaps this program): the cursors are ``[B, 1]``, every
    frontier tensor gains a leading ``B`` and each fill and fold step is
    one batched launch.  Nothing here reads a device value on the host."""
    dev = next(iter(arrays)).device if arrays else torch.device("cpu")
    lead = () if batch is None else (batch,)
    count = torch.ones(lead, dtype=IDX, device=dev)
    overflow = torch.zeros(lead, dtype=torch.bool, device=dev)
    morsels = torch.zeros(lead, dtype=IDX, device=dev)
    if batch is not None and ann is not None:
        ann = ann.reshape(1, -1).expand(batch, -1).contiguous()
    cap = 1
    cols: Dict[str, torch.Tensor] = {}
    cursors = dict(cursors0)
    lcounts = []
    needs = []

    def trip(c):
        key, vi, oi = c[0], c[1], c[2]
        if oi < 0:
            return (arrays[vi], None, None)
        return (arrays[vi], arrays[oi], cursors[key])

    for step in prog:
        kind = step[0]
        if kind == "extend":
            _, var, cap_out, morsel, cons = step
            seed = trip(cons[0])
            probes = tuple(trip(c) for c in cons[1:])
            sideways = tuple(
                None if c[3] is None else
                (arrays[c[3][0]], arrays[c[3][1]], arrays[c[3][2]],
                 arrays[c[3][3]])
                for c in cons[1:])
            sideways_bits = tuple(None if c[3] is None else c[3][4]
                                  for c in cons[1:])
            cons_keys = {c[0] for c in cons}
            col_keys = list(cols)
            cur_keys = [k for k in cursors if k not in cons_keys]
            carry = (tuple(cols[k] for k in col_keys)
                     + tuple(cursors[k] for k in cur_keys)
                     + ((ann,) if ann is not None else ()))
            (count, overflow, chunks, total, vals_c, p0_c, pos_c,
             carry_c) = _extend_body(
                count, overflow, seed, probes, sideways, carry,
                cap_in=cap, cap_out=cap_out, morsel=morsel,
                sideways_bits=sideways_bits)
            it = iter(carry_c)
            cols = {k: next(it) for k in col_keys}
            cursors = {k: next(it) for k in cur_keys}
            if ann is not None:
                ann = next(it)
            cols[var] = vals_c
            cursors[cons[0][0]] = p0_c
            for c, p in zip(cons[1:], pos_c):
                cursors[c[0]] = p
            cap = cap_out
            morsels = morsels + chunks
            lcounts.append(count)
            needs.append(total)
        elif kind == "fold":
            _, var, morsel, sr, cons = step
            seed = trip(cons[0])
            probes = tuple(trip(c) for c in cons[1:])
            leaf_anns = tuple(None if c[3] < 0 else arrays[c[3]]
                              for c in cons)
            col_keys = list(cols)
            cur_keys = list(cursors)
            carry = (tuple(cols[k] for k in col_keys)
                     + tuple(cursors[k] for k in cur_keys))
            count, chunks, ann, carry_c = _fold_body(
                count, seed, probes, ann, leaf_anns, carry,
                cap_in=cap, morsel=morsel, sr=sr)
            it = iter(carry_c)
            cols = {k: next(it) for k in col_keys}
            cursors = {k: next(it) for k in cur_keys}
            morsels = morsels + chunks
            lcounts.append(count)
        else:  # annmul
            _, key, ai, sr = step
            la = arrays[ai]
            leaf = la[_clip_index(cursors[key], la.shape[0])]
            ann = sr.mul(ann, leaf.to(ann.dtype))
    return (count, overflow, morsels, tuple(lcounts), tuple(needs),
            cols, cursors, ann)


def _fused_probe(values_t, lo_t, hi_t, queries):
    """Probe ``queries`` into every atom's candidate segment.  Each atom's
    search is independent of the others' outcomes (positions don't
    depend on which rows survive), so computing all searches then
    AND-ing the membership masks equals the sequential filter — at one
    device round-trip instead of one per atom."""
    poss = []
    found_all = None
    for values, lo, hi in zip(values_t, lo_t, hi_t):
        pos, found = I.segment_searchsorted(values, lo, hi, queries)
        poss.append(pos)
        found_all = found if found_all is None else (found_all & found)
    return tuple(poss), found_all


# -------------------------------------------------------------- selection
def make_backend(spec=None, device=None) -> ExecBackend:
    """Resolve ``spec`` (instance | "numpy" | "device" | None) to a
    backend.  None is the device backend, as "device" is: it runs on
    ``device``, ``cuda`` unless the caller names another, and raises
    without a card.  "numpy" is the host oracle."""
    if isinstance(spec, ExecBackend):
        return spec
    spec = "device" if spec is None else str(spec).lower()
    if spec in ("numpy", "host"):
        return NumpyBackend()
    if spec == "device":
        return DeviceBackend(device=device)
    raise ValueError(f"unknown backend {spec!r}; expected 'numpy' or "
                     "'device'")
