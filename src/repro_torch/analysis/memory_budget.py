"""Static device-memory footprint model, cross-checked against live
allocations.  Counterpart of ``repro.analysis.memory_budget``.

The serving layer budgets device residency (``serve.GraphStore``), but
host-side ``Trie.nbytes()`` is the WRONG number on the device: trie
level offsets are int64 on the host and int32 (``kernels.common.IDX``)
on the device, the blocked-bitset block directories (uploaded for the
counting pass's sideways intersection) are invisible to the host view,
and so are the layout stores' device copies.  This module computes a
**model** of device bytes purely from host shapes and the dtypes each
upload uses, and cross-checks it against the **live** bytes of the
identity-keyed device caches — read as the tensors' ``.nbytes``, never by
a transfer.

Components of one trie:

* ``level<i>.values`` / ``level<i>.offsets`` / ``annotation`` — the
  pipeline's uploads (values and the annotation keep their host dtype,
  offsets go to int32);
* ``bitset_dir[<tag>:<threshold>]`` — a blocked bitset's slot router,
  block CSR and block ids, uploaded for the sideways pass;
* ``layout_store[<tag>:<threshold>]`` — a device layout store's cached
  copies (``HybridSetStore.dev``: the CSR's neighbors and offsets, the
  bitset's block offsets, block ids, words and index, int32 each).  The
  reference's store holds no device arrays; the port's does, and they
  are a full-size tenant's largest, so the model counts them.  The host
  oracle's store (tag ``host``) is host memory and is not counted.

Views:

* :func:`trie_footprint` — per-component ``(model, live)`` bytes of one
  trie's resident device caches;
* :func:`trie_device_bytes` — the model total of the RESIDENT
  components.  ``serve.GraphStore.resident_bytes`` budgets eviction on
  this instead of ``Trie.nbytes()``;
* :func:`trie_full_upload_bytes` — the model if every component were
  resident;
* :func:`program_frontier_bytes` / :func:`plan_frontier_bytes` — the
  static peak frontier-buffer bytes one bag launch allocates, from the
  lowered program or the plan IR, times the batch;
* :func:`fixpoint_state_bytes` — the dense fixpoint state one device
  recursion round carries.

Drift between model and live beyond :data:`DEFAULT_TOLERANCE` is a
modelling bug: :func:`check_tries` raises :class:`MemoryBudgetError`.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.kernels.common import IDX

# |model - live| <= tol * max(model, 1): the model predicts exact tensor
# nbytes, so any real drift means a component we failed to account for.
DEFAULT_TOLERANCE = 0.05
_IDX_BYTES = torch.empty(0, dtype=IDX).element_size()
# the layout store's device copies (``HybridSetStore.dev``), one int32 an
# element of the host array behind each
STORE_ARRAYS = ("neighbors", "offsets", "block_offsets", "block_ids",
                "words", "index")


class MemoryBudgetError(AssertionError):
    """Raised when the static model drifts from live device allocations."""


@dataclasses.dataclass(frozen=True)
class Component:
    """One device-cached array family of a trie."""

    name: str           # "level0.values" | "annotation" | "bitset_dir" ...
    model_bytes: int    # predicted from host shape + upload dtype
    live_bytes: int     # actual .nbytes of the cached (device) tensors


@dataclasses.dataclass(frozen=True)
class TrieFootprint:
    trie: str
    components: tuple

    @property
    def model_bytes(self) -> int:
        return sum(c.model_bytes for c in self.components)

    @property
    def live_bytes(self) -> int:
        return sum(c.live_bytes for c in self.components)


def _nbytes(x) -> int:
    return int(getattr(x, "nbytes", 0))


def _model_bytes(host_arr) -> int:
    """Bytes of a host array uploaded as it is (``torch.as_tensor``
    keeps its dtype)."""
    return int(np.asarray(host_arr).nbytes)


def _bitset_dir_bytes(bs) -> int:
    return sum(int(np.asarray(a).size)
               for a in (bs.slot_of, bs.offsets, bs.block_ids)) * _IDX_BYTES


def _store_bytes(store, names) -> int:
    return sum(int(np.asarray(store.host_array(n)).size) * 4 for n in names)


def trie_footprint(trie) -> TrieFootprint:
    """Per-component model-vs-live device bytes of one trie's RESIDENT
    caches.  Components with no device cache contribute nothing — the
    footprint is what eviction would actually reclaim."""
    comps: list[Component] = []
    for i, lv in enumerate(trie.levels):
        cached = lv.__dict__.get("_dev_values")
        if cached is not None:
            comps.append(Component(
                f"level{i}.values", _model_bytes(lv.values),
                _nbytes(cached[1])))
        cached = lv.__dict__.get("_dev_offsets")
        if cached is not None:
            # offsets upload through backend._up_idx: always IDX
            comps.append(Component(
                f"level{i}.offsets", int(lv.offsets.size) * _IDX_BYTES,
                _nbytes(cached[1])))
    cached = trie.__dict__.get("_dev_annotation")
    if cached is not None:
        comps.append(Component(
            "annotation", _model_bytes(trie.annotation), _nbytes(cached[1])))
    for key, store in sorted(
            (trie.__dict__.get("_hybrid_stores") or {}).items(), key=repr):
        bs = getattr(store, "bitset", None)
        sw = getattr(bs, "_dev_sideways_cache", None) if bs is not None \
            else None
        if sw is None or sw[0] is not bs.block_ids:
            continue
        comps.append(Component(f"bitset_dir[{key[0]}:{key[1]}]",
                               _bitset_dir_bytes(bs),
                               sum(_nbytes(a) for a in sw[1])))
    for key, store in trie.device_stores():
        if not store._dev:
            continue
        comps.append(Component(
            f"layout_store[{key[0]}:{key[1]}]",
            _store_bytes(store, list(store._dev)),
            sum(_nbytes(t) for t in store._dev.values())))
    return TrieFootprint(trie=trie.name, components=tuple(comps))


def trie_device_bytes(trie) -> int:
    """Model-side device bytes of the trie's resident caches — the number
    ``serve.GraphStore`` budgets eviction on (host ``nbytes()`` counts
    int64 offsets the device never holds)."""
    return trie_footprint(trie).model_bytes


def trie_full_upload_bytes(trie) -> int:
    """Model device bytes if every level, the annotation, every
    already-built bitset directory and every device layout store's
    arrays were resident — capacity planning for admission, independent
    of current caches."""
    total = 0
    for lv in trie.levels:
        total += _model_bytes(lv.values) + int(lv.offsets.size) * _IDX_BYTES
    if trie.annotation is not None:
        total += _model_bytes(trie.annotation)
    for store in (trie.__dict__.get("_hybrid_stores") or {}).values():
        bs = getattr(store, "bitset", None)
        if bs is not None:
            total += _bitset_dir_bytes(bs)
    for _key, store in trie.device_stores():
        total += _store_bytes(store, STORE_ARRAYS if store.bitset is not None
                              else STORE_ARRAYS[:2])
    return total


# ------------------------------------------------------ transient buffers
def program_frontier_bytes(prog, *, batch: int = 1) -> int:
    """Peak static frontier-buffer bytes of one lowered bag program: per
    extend step the fill writes ``cap`` rows of values (int32), source
    row, seed position and per-probe positions (IDX) and keep (bool), and
    the batched path allocates all of it ``batch`` times
    (``statistics.max_batch`` sizes B against the same ceiling)."""
    total = 0
    for step in prog:
        if step[0] != "extend":
            continue
        _, _var, cap_out, _morsel, cons = step
        nprobes = max(len(cons) - 1, 0)
        total += int(cap_out) * (4 + _IDX_BYTES * (2 + nprobes) + 1)
    return total * max(int(batch), 1)


def plan_frontier_bytes(pplan, *, batch: int = 1) -> int:
    """Same model from the plan IR (pre-lowering): each ``Extend`` step's
    ``frontier_cap`` estimate through ``statistics.frontier_capacity``
    with the morsel hint — the capacity the pipeline will declare unless
    the live cross-product bound clamps it further (an upper-bound
    model)."""
    from repro_torch.core import plan_ir as P
    from repro_torch.core import statistics as S
    total = 0
    for bag in pplan.bag_ops:
        morsel = bag.hints().morsel or S.DEFAULT_MORSEL
        for s in bag.steps:
            if not isinstance(s, P.Extend) or s.frontier_cap is None:
                continue
            cap = S.frontier_capacity(float(s.frontier_cap),
                                      S.PIPELINE_MAX_BUFFER, int(morsel))
            nprobes = max(int(s.n_constraining) - 1, 0)
            total += cap * (4 + _IDX_BYTES * (2 + nprobes) + 1)
    return total * max(int(batch), 1)


def fixpoint_state_bytes(n: int, dtype: torch.dtype) -> int:
    """Dense device fixpoint state: the annotation vector over [0, n) in
    the semiring's ``dtype`` plus the boolean frontier mask
    (``recursion.seminaive_device_fixpoint``)."""
    return int(n) * (torch.empty(0, dtype=dtype).element_size() + 1)


# ------------------------------------------------------------ cross-check
def check_tries(tries, *, tolerance: float = DEFAULT_TOLERANCE,
                counters=None) -> list[TrieFootprint]:
    """Cross-check model vs live for every trie; raise on drift.

    ``counters`` (e.g. ``backend.stats``) receives the
    ``analysis.memory_*`` tallies surfaced by ``dispatch_summary()``."""
    fps = []
    for t in tries:
        fp = trie_footprint(t)
        fps.append(fp)
        if counters is not None:
            counters["analysis.memory_checks"] += 1
            counters["analysis.memory_model_bytes"] += fp.model_bytes
        drift = abs(fp.model_bytes - fp.live_bytes)
        if drift > tolerance * max(fp.model_bytes, 1):
            comps = ", ".join(f"{c.name}: model={c.model_bytes} "
                              f"live={c.live_bytes}"
                              for c in fp.components)
            raise MemoryBudgetError(
                f"trie '{fp.trie}': static model {fp.model_bytes}B vs "
                f"live device {fp.live_bytes}B (drift {drift}B > "
                f"{tolerance:.0%}) — [{comps}]")
    return fps


def check_store(server, *, tolerance: float = DEFAULT_TOLERANCE
                ) -> dict[str, dict[str, int]]:
    """Per-tenant model-vs-live report over a ``QueryServer``'s store.
    Raises on drift."""
    out: dict[str, dict[str, int]] = {}
    for tenant in server.store.tenants():
        tries = [t for t in server.store.tries(tenant) if t.device_resident]
        fps = check_tries(tries, tolerance=tolerance,
                          counters=server.backend.stats)
        model = sum(fp.model_bytes for fp in fps)
        live = sum(fp.live_bytes for fp in fps)
        out[tenant] = {"model_bytes": model, "live_bytes": live,
                       "delta_bytes": live - model}
    return out
