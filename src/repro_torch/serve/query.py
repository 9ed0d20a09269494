"""Relational query serving: parameterized plans, batched execution,
multi-tenant graph store.  Counterpart of ``repro.serve.query``, over
:class:`repro_torch.core.engine.Engine`:

  * **Parameterized queries** — ``QueryServer.prepare`` compiles a rule
    ONCE with its selection constants rewritten into bind slots
    (``compile.parameterize``); re-binding reuses the cached logical
    plan, plan-search decision and physical plan + emitted source.  Zero
    plan searches per re-bind — the ``compile.*`` counters prove it (the
    port runs eagerly, so there is nothing to retrace).
  * **Batched execution** — ``submit`` + ``drain`` group admitted
    requests by prepared query and execute each group through
    ``PreparedQuery.run_batch``: B same-shape probes become ONE batched
    device launch per ``statistics.max_batch`` chunk
    (``pipeline.batched_launches``; each fill and fold step one launch of
    the batched kernel), with the sequential per-binding loop as the
    exact-parity fallback on the host oracle or non-batchable plan
    shapes.
  * **Multi-tenant graph store** — several graphs resident at once, one
    ``Engine`` (catalog + plan caches) per tenant over ONE shared
    backend, with LRU eviction over the tries' device caches: when the
    resident-byte budget (or graph count) is exceeded, the coldest
    tenant's tries drop their device-resident copies
    (``Trie.evict_device``).  Eviction is a cache policy, not data
    loss — the host tries stay loaded and re-upload lazily on the
    tenant's next query.

Per-tenant dispatch counters (``tenant.<t>.queries`` / ``.batches`` /
``.evictions``) and store-wide counters (``store.evictions``,
``queue.admitted`` / ``queue.drained``) live in ``QueryServer.counters``.
"""
from __future__ import annotations

import dataclasses
import threading
from collections import OrderedDict

from repro_torch.analysis.concurrency_lint import guarded_by
from repro_torch.core.backend import ExecBackend, make_backend
from repro_torch.core.engine import Engine, PreparedQuery, QueryResult
from repro_torch.core.trie import Trie


@dataclasses.dataclass
class Ticket:
    """Admission handle for one submitted query: filled by ``drain``."""

    tenant: str
    params: tuple[object, ...]
    result: QueryResult | None = None
    done: bool = False


@dataclasses.dataclass
class _Pending:
    ticket: Ticket
    prepared: PreparedQuery


class GraphStore:
    """LRU residency manager over the tries of several tenant graphs.

    Tracks which tenant was queried least recently and, when the
    device-resident byte budget (``capacity_bytes``) or the resident
    graph count (``max_graphs``) is exceeded, evicts the coldest
    tenant's device caches via
    :meth:`repro_torch.core.trie.Trie.evict_device`.  The most recently
    touched tenant is never evicted.

    The byte budget is accounted in MODEL device bytes
    (``analysis.memory_budget.trie_device_bytes``): host ``nbytes()``
    counts int64 offsets the device never holds (they upload as int32)
    and misses the bitset block directories and the layout stores'
    device copies entirely, so budgeting on it would over- or
    under-evict.

    Thread safety: every public method takes ``self._lock`` (re-entrant
    — ``enforce`` reads residency while holding it); the two
    ``@guarded_by`` helpers document that their callers must already
    hold it.
    """

    def __init__(self, capacity_bytes: int | None = None,
                 max_graphs: int | None = None):
        self.capacity_bytes = capacity_bytes
        self.max_graphs = max_graphs
        self._lock = threading.RLock()
        # tenant -> registered tries, in LRU order (first = coldest)
        self._tries: OrderedDict[str, list[Trie]] = OrderedDict()
        self.evictions = 0

    def register(self, tenant: str, trie: Trie) -> None:
        with self._lock:
            self._tries.setdefault(tenant, []).append(trie)
            self._tries.move_to_end(tenant)

    def touch(self, tenant: str) -> None:
        with self._lock:
            if tenant in self._tries:
                self._tries.move_to_end(tenant)

    def tenants(self) -> list[str]:
        """Tenants in LRU order (coldest first)."""
        with self._lock:
            return list(self._tries)

    def tries(self, tenant: str) -> list[Trie]:
        """The tries registered for ``tenant``."""
        with self._lock:
            return list(self._tries.get(tenant, ()))

    def resident(self, tenant: str) -> bool:
        with self._lock:
            return any(t.device_resident
                       for t in self._tries.get(tenant, ()))

    def resident_bytes(self) -> int:
        """MODEL device bytes of every resident trie (what eviction
        would actually reclaim), not host ``nbytes()``."""
        from repro_torch.analysis.memory_budget import trie_device_bytes
        with self._lock:
            return sum(trie_device_bytes(t) for ts in self._tries.values()
                       for t in ts if t.device_resident)

    @guarded_by("_lock")
    def _resident_tenants(self) -> list[str]:
        return [t for t in self._tries if self.resident(t)]

    @guarded_by("_lock")
    def _over_budget(self) -> bool:
        if self.max_graphs is not None \
                and len(self._resident_tenants()) > self.max_graphs:
            return True
        return self.capacity_bytes is not None \
            and self.resident_bytes() > self.capacity_bytes

    def enforce(self) -> list[str]:
        """Evict coldest-first until within budget; returns the evicted
        tenants.  The warmest resident tenant always survives (evicting
        the graph that was just queried would thrash)."""
        evicted: list[str] = []
        with self._lock:
            while self._over_budget():
                resident = self._resident_tenants()
                if len(resident) <= 1:
                    break
                cold = resident[0]
                for t in self._tries[cold]:
                    t.evict_device()
                self.evictions += 1
                evicted.append(cold)
        return evicted


class QueryServer:
    """Serve relational queries for several tenant graphs.

    One :class:`~repro_torch.core.engine.Engine` per tenant (separate
    catalogs and plan caches — tenants cannot read each other's
    relations) over ONE shared backend (shared kernel dispatch, overflow
    cap feedback and counters).  ``backend`` is an ``ExecBackend``,
    ``"device"`` or ``"numpy"``; None is the device backend on
    ``device`` (``cuda`` unless the caller names another: it raises
    without a card, and ``device="cpu"`` runs the kernels' plain
    versions).  ``prepare``/``run`` serve point queries with
    bind-parameter plan reuse; ``submit``/``drain`` run an admission
    queue whose per-prepared-query groups execute as fused batches.

    Thread safety: the server's own shared state (admission queue,
    per-tenant engine and prepared-query maps, counters) is guarded by
    ``self._lock`` (re-entrant: locked paths call ``_bump`` and
    ``prepare``).  ``drain`` swaps the queue out under the lock and
    executes OUTSIDE it, so a long batch never blocks admission.  The
    engines and backend themselves are single-threaded per instance —
    concurrent queries against the SAME tenant must be serialized by
    the caller; the lock here makes admission, preparation and the
    store's LRU/byte accounting safe across tenants.
    """

    def __init__(self, backend=None, device=None,
                 capacity_bytes: int | None = None,
                 max_graphs: int | None = None, **engine_opts):
        self.backend: ExecBackend = make_backend(backend, device=device)
        self.store = GraphStore(capacity_bytes=capacity_bytes,
                                max_graphs=max_graphs)
        self._engine_opts = dict(engine_opts)
        self._lock = threading.RLock()
        self._engines: dict[str, Engine] = {}
        self._prepared: dict[tuple[str, str], PreparedQuery] = {}
        self._queue: list[_Pending] = []
        self.counters: dict[str, int] = {}

    # ------------------------------------------------------------- tenants
    def _bump(self, key: str, n: int = 1) -> None:
        with self._lock:
            self.counters[key] = self.counters.get(key, 0) + n

    def engine(self, tenant: str) -> Engine:
        with self._lock:
            eng = self._engines.get(tenant)
            if eng is None:
                eng = Engine(backend=self.backend, **self._engine_opts)
                self._engines[tenant] = eng
            return eng

    def load_graph(self, tenant: str, name: str, src, dst,
                   annotation=None) -> Trie:
        t = self.engine(tenant).load_edges(name, src, dst,
                                           annotation=annotation)
        self.store.register(tenant, t)
        self._evict_over_budget()
        return t

    def load_table(self, tenant: str, name: str, columns,
                   annotation=None) -> Trie:
        t = self.engine(tenant).load_table(name, columns,
                                           annotation=annotation)
        self.store.register(tenant, t)
        self._evict_over_budget()
        return t

    def alias(self, tenant: str, name: str, target: str) -> None:
        self.engine(tenant).alias(name, target)

    def _evict_over_budget(self) -> None:
        for cold in self.store.enforce():
            self._bump(f"tenant.{cold}.evictions")
            self._bump("store.evictions")

    # ------------------------------------------------------------- queries
    def prepare(self, tenant: str, text: str) -> PreparedQuery:
        with self._lock:
            key = (tenant, text)
            pq = self._prepared.get(key)
            if pq is None:
                pq = self.engine(tenant).prepare(text)
                self._prepared[key] = pq
            return pq

    def run(self, tenant: str, text: str, *params) -> QueryResult:
        """Point query through the prepared-plan cache: the first call
        per (tenant, text) compiles; every later call only re-binds."""
        pq = self.prepare(tenant, text)
        self.store.touch(tenant)
        res = pq.run(*params)
        self._bump(f"tenant.{tenant}.queries")
        self._evict_over_budget()
        return res

    def query(self, tenant: str, text: str) -> QueryResult:
        """Unparameterized passthrough (multi-rule programs, recursion)."""
        self.store.touch(tenant)
        res = self.engine(tenant).query(text)
        self._bump(f"tenant.{tenant}.queries")
        self._evict_over_budget()
        return res

    # ---------------------------------------------------- admission queue
    def submit(self, tenant: str, text: str, *params) -> Ticket:
        """Admit one query; execution is deferred to :meth:`drain` so
        same-shape requests can share a fused batched launch."""
        pq = self.prepare(tenant, text)
        ticket = Ticket(tenant=tenant, params=pq._binding(params))
        with self._lock:
            self._queue.append(_Pending(ticket=ticket, prepared=pq))
        self._bump("queue.admitted")
        return ticket

    def pending(self) -> int:
        with self._lock:
            return len(self._queue)

    def drain(self) -> list[Ticket]:
        """Execute every admitted request, grouped by prepared query:
        each group runs through ``PreparedQuery.run_batch`` (one batched
        launch per same-shape chunk on the device backend, sequential
        parity loop elsewhere).  Tickets are filled in admission order.
        The queue is swapped out under the lock; execution happens
        outside it so a long batch never blocks admission."""
        with self._lock:
            queue, self._queue = self._queue, []
        groups: OrderedDict[int, list[_Pending]] = OrderedDict()
        for p in queue:
            groups.setdefault(id(p.prepared), []).append(p)
        for members in groups.values():
            pq = members[0].prepared
            tenant = members[0].ticket.tenant
            self.store.touch(tenant)
            results = pq.run_batch([p.ticket.params for p in members])
            for p, res in zip(members, results):
                p.ticket.result = res
                p.ticket.done = True
            self._bump(f"tenant.{tenant}.queries", len(members))
            if len(members) > 1:
                self._bump(f"tenant.{tenant}.batches")
            self._evict_over_budget()
        self._bump("queue.drained", len(queue))
        return [p.ticket for p in queue]

    # ------------------------------------------------------------- stats
    def dispatch_summary(self) -> dict[str, int]:
        """Shared-backend dispatch counters merged with the server's
        per-tenant and queue counters."""
        out = dict(self.backend.dispatch_summary())
        out.update(self.counters)
        return out
