"""Recursive query evaluation (paper Sections 3.1/3.3).

Counterpart of ``repro.core.recursion``.  EmptyHeaded supports
Kleene-star rules with two evaluation strategies:

  * **naive** — re-apply the rule body to the full relation each iteration
    (used when every iteration rewrites every annotation, e.g. PageRank);
    convergence = fixed iteration count or float differential.
  * **seminaive** — only propagate from tuples whose annotation changed in
    the previous iteration; selected automatically when the aggregation is
    monotone MIN/MAX (e.g. SSSP).

The shared primitive is the semiring SpMV ``y[u] = ⨁_v A(u,v) ⊗ x[v]`` — a
one-step join-aggregate `Out(x) :- Edge(x,z), X(z)`.  ``pagerank`` on the
card (or under the device backend) routes its inner loop through the ELL
CUDA kernel (``repro_torch.kernels.spmv_ell``); the datalog engine's
PageRank program evaluates through :func:`naive_device_fixpoint`
instead, as in the reference.

Every entry point runs on the card unless the caller asks for the CPU
(``device="cpu"``, or a backend placed there).

**Host reads.** PyTorch runs eagerly, so a loop whose end depends on the
data (a seminaive frontier running dry, a float differential falling
under its tolerance) must read a device flag on the host to stop.  The
loops here issue rounds in blocks of :data:`CHECK_EVERY` and read one flag
(with the round count) per block; a round issued after convergence changes nothing (an empty
frontier propagates nothing; a converged naive state is frozen with
``torch.where``), and the round count is kept on the device, so the
result and the count equal a per-round check's.  The reads are counted in
``recursion.host_reads``.  Fixed-iteration loops read nothing until the
closing ``host_get``.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.datalog import eval_expr
from repro_torch.core.semiring import MIN_PLUS, SUM_F32, Semiring
from repro_torch.core.trie import CSRGraph
from repro_torch.kernels.common import IDX_NP, default_device, host_get

# rounds issued between two host reads of a device loop's "still
# changing" flag (the reference fixpoint's ``check_every``)
CHECK_EVERY = 8


# ------------------------------------------------------------------- spmv
def csr_row_ids(csr: CSRGraph) -> np.ndarray:
    return np.repeat(np.arange(csr.n, dtype=np.int32), csr.degrees)


def semiring_spmv(sr: Semiring, n: int, row: torch.Tensor, col: torch.Tensor,
                  ann: Optional[torch.Tensor],
                  x: torch.Tensor) -> torch.Tensor:
    """y[u] = ⨁_{(u,v) in E} ann(u,v) ⊗ x[v] over any semiring."""
    contrib = x[col]
    if ann is not None:
        contrib = sr.mul(ann, contrib)
    return sr.segment_reduce(contrib, row, n)


# ---------------------------------------------------------------- pagerank
def pagerank(csr: CSRGraph, iters: int = 5, damping: float = 0.85,
             spmv_fn: Optional[Callable] = None, backend=None,
             device=None) -> np.ndarray:
    """Paper Table 2 PageRank: naive recursion, fixed iteration count.

        N(;w)        :- Edge(x,y); w=<<COUNT(x)>>
        PageRank(x;y):- Edge(x,z); y=1/N.
        PageRank(x;y)*[i=5] :- Edge(x,z),PageRank(z),InvDeg(z);
                               y=0.15+0.85*<<SUM(z)>>.

    The body is a (+,*) join-aggregate = SpMV with InvDeg folded into the
    propagated value.  Runs on ``backend.device`` when a backend is
    given, else on ``device`` (``cuda`` when None).  On the card, or under
    the device backend, the SpMV is the ELL kernel over the width-1
    packing, the CSR itself (a backend's ``spmv.ell_kernel`` counts its
    rounds); only on the CPU without the device backend is it the
    segment-sum SpMV, as in the reference.  No host read until the
    closing transfer.
    """
    dev = (backend.device if backend is not None
           else default_device(device, "recursion.pagerank"))
    n = csr.n
    out_deg = np.maximum(csr.degrees, 1).astype(np.float32)
    inv_deg = torch.as_tensor(1.0 / out_deg, device=dev)

    x = torch.full((n,), 1.0 / n, dtype=torch.float32, device=dev)
    base = (1.0 - damping) / n

    if spmv_fn is None and (dev.type == "cuda"
                            or getattr(backend, "name", None) == "device"):
        from repro_torch.kernels.spmv_ell.ops import (csr_to_ell_split,
                                                      spmv_ell)
        cols, vals, row_ptr = (torch.as_tensor(a, device=dev) for a in
                               csr_to_ell_split(csr.offsets, csr.neighbors,
                                                width=1))
        if backend is not None:
            backend.stats["spmv.ell_kernel"] += iters

        def spmv_fn(x_scaled):
            return spmv_ell(cols, vals, row_ptr, x_scaled)

    if spmv_fn is None:
        row = torch.as_tensor(csr_row_ids(csr), device=dev)
        col = torch.as_tensor(np.asarray(csr.neighbors, dtype=IDX_NP),
                              device=dev)

        def spmv_fn(x_scaled):
            return semiring_spmv(SUM_F32, n, row, col, None, x_scaled)

    for _ in range(iters):
        x = base + damping * spmv_fn(x * inv_deg)
    return host_get(x)


def pagerank_np(csr: CSRGraph, iters: int = 5, damping: float = 0.85) -> np.ndarray:
    """Numpy oracle."""
    n = csr.n
    row = csr_row_ids(csr)
    col = csr.neighbors
    inv_deg = 1.0 / np.maximum(csr.degrees, 1)
    x = np.full(n, 1.0 / n, dtype=np.float64)
    for _ in range(iters):
        y = np.zeros(n, dtype=np.float64)
        np.add.at(y, row, x[col] * inv_deg[col])
        x = (1 - damping) / n + damping * y
    return x.astype(np.float32)


# -------------------------------------------------------------------- sssp
def _run_blocks(step, state, changing, max_rounds: int,
                check_every: int = CHECK_EVERY):
    """Run ``state = step(*state)`` while ``changing(state)`` (a device
    bool) holds, for at most ``max_rounds`` rounds.  ``step`` must leave a
    state whose flag is False unchanged.  The rounds issued while the flag
    held are counted on the device; after every block of ``check_every``
    rounds ONE host read fetches the flag and that count together.
    Returns ``(state, rounds, reads)``, ``rounds`` a Python int."""
    count = torch.zeros((), dtype=torch.int32,
                        device=changing(state).device)
    issued = reads = rounds = 0
    while issued < max_rounds:
        block = min(check_every, max_rounds - issued)
        for _ in range(block):
            count = count + changing(state)
            state = step(*state)
        issued += block
        reads += 1
        still, rounds = (int(v) for v in host_get(torch.stack(
            (changing(state).to(torch.int32), count))))
        if not still:
            break
    return state, rounds, reads


def _inf_like(x: torch.Tensor) -> torch.Tensor:
    return torch.tensor(float("inf"), dtype=x.dtype, device=x.device)


def _frozen(round_body: Callable, tol: float) -> Callable:
    """A ``(x, diff) -> (x', diff')`` step for :func:`_run_blocks`: apply
    ``round_body`` and carry ``max|x' - x|`` while the differential is
    above ``tol``; once it is not, leave both as they are."""
    def step(x, diff):
        new = round_body(x)
        live = diff > tol
        return (torch.where(live, new, x),
                torch.where(live, (new - x).abs().max().to(diff.dtype), diff))
    return step


def sssp(csr: CSRGraph, source: int, weights: Optional[np.ndarray] = None,
         max_iters: Optional[int] = None, device=None) -> np.ndarray:
    """Paper Table 2 SSSP: seminaive evaluation of the (min,+) recursion.

        SSSP(x;y) :- Edge("start",x); y=1.
        SSSP(x;y)* :- Edge(w,x),SSSP(w); y=<<MIN(w)>>+1.

    Monotone MIN aggregation triggers seminaive mode: each round relaxes only
    edges out of the frontier (vertices whose distance improved last round),
    with non-frontier contributions masked to +inf so the shapes stay
    fixed.  Runs on ``device`` (``cuda`` when None); one host read per
    :data:`CHECK_EVERY` rounds.
    """
    dev = default_device(device, "recursion.sssp")
    n = csr.n
    row = torch.as_tensor(csr_row_ids(csr), device=dev)  # edge source u
    col = torch.as_tensor(np.asarray(csr.neighbors, dtype=IDX_NP),
                          device=dev)
    w = (torch.as_tensor(np.asarray(weights, dtype=np.float32), device=dev)
         if weights is not None
         else torch.ones(csr.m, dtype=torch.float32, device=dev))
    if max_iters is None:
        max_iters = n

    inf = float("inf")
    dist = torch.full((n,), inf, dtype=torch.float32, device=dev)
    dist[source] = 0.0
    frontier = torch.zeros(n, dtype=torch.bool, device=dev)
    frontier[source] = True

    def step(dist, frontier):
        # seminaive: only edges whose source is in the frontier contribute
        src_d = torch.where(frontier[row], dist[row], inf)
        cand = MIN_PLUS.segment_reduce(src_d + w, col, n)
        new = torch.minimum(dist, cand)
        return new, new < dist

    (dist, _), _rounds, _reads = _run_blocks(
        step, (dist, frontier), lambda s: s[1].any(), max_iters)
    return host_get(dist)


def sssp_np(csr: CSRGraph, source: int, weights: Optional[np.ndarray] = None) -> np.ndarray:
    """Numpy seminaive oracle with true work elimination (frontier gathers).

    Termination: Bellman–Ford shortest paths use at most ``n - 1`` edges,
    so improvements can only occur in rounds 1..n-1 (round k finds paths
    of exactly k edges). One extra round is allowed as the detection
    pass: any improvement there implies a negative cycle reachable from
    the source, and the oracle raises instead of relaxing forever.
    """
    n = csr.n
    w = weights if weights is not None else np.ones(csr.m, np.float32)
    dist = np.full(n, np.inf, dtype=np.float64)
    dist[source] = 0.0
    frontier = np.array([source])
    it = 0
    while len(frontier):
        if it >= n:
            # the frontier is non-empty after the round-n detection pass:
            # a path with >= n edges improved some distance
            raise ValueError(
                "sssp_np: improvements after round n imply a negative "
                "cycle reachable from the source")
        it += 1
        # gather out-edges of the frontier only (the seminaive delta)
        segs = [(csr.offsets[u], csr.offsets[u + 1]) for u in frontier]
        idx = np.concatenate([np.arange(a, b) for a, b in segs]) if segs else np.zeros(0, np.int64)
        if len(idx) == 0:
            break
        srcs = np.repeat(frontier, [b - a for a, b in segs])
        dsts = csr.neighbors[idx]
        cand = dist[srcs] + w[idx]
        order = np.argsort(dsts, kind="stable")
        dsts_s, cand_s = dsts[order], cand[order]
        first = np.ones(len(dsts_s), bool)
        first[1:] = dsts_s[1:] != dsts_s[:-1]
        seg_id = np.cumsum(first) - 1
        best = np.full(seg_id[-1] + 1 if len(seg_id) else 0, np.inf)
        np.minimum.at(best, seg_id, cand_s)
        uniq = dsts_s[first]
        improved = best < dist[uniq]
        dist[uniq[improved]] = best[improved]
        frontier = uniq[improved]
    return dist.astype(np.float32)


# ------------------------------------- engine device-resident recursion
# The datalog engine's recursive rules (``Engine._seminaive`` /
# ``Engine._naive``) run on the device whenever the rule body is a
# semiring SpMV — one binary atom E(h,r) or E(r,h), the recursive atom
# Rec(r), and optional unary annotated atoms A_i(r): the frontier/delta is
# a masked vector over the vertex domain (mirroring :func:`sssp`) and every
# round is a fixed-shape gather → ⊗ → segment-⨁.  The engine recognizes
# the shape and calls these entry points; any other shape takes the host
# loop, as in the reference.


class ExprFn:
    """The rule's annotation expression (``datalog.eval_expr``) with the
    scalar-relation environment snapshotted at construction as Python
    floats, so applying it in a round reads nothing from the device."""

    def __init__(self, expr, scalars):
        self.expr = expr
        self.scalars = {k: float(v) for k, v in scalars.items()}

    def __call__(self, agg_value):
        return eval_expr(self.expr, agg_value, self.scalars)


def seminaive_device_fixpoint(sr: Semiring, apply_expr: ExprFn,
                              gather: np.ndarray, scatter: np.ndarray,
                              edge_ann: Optional[np.ndarray], n: int,
                              keys0: np.ndarray, ann0: np.ndarray,
                              max_rounds: int, backend):
    """Whole seminaive fixpoint on ``backend.device``: densify the initial
    relation over [0, n), run the masked-delta loop, and sparsify the
    result back to ``(keys, ann, rounds)``.

    ``state`` is the annotation vector over the dense vertex domain
    (``sr.zero`` = "not derived"); ``frontier`` masks the vertices whose
    annotation improved last round (the seminaive delta).  One round:
    propagate frontier annotations along edges (gather → ⊗ edge
    annotation → segment-⨁ into the head vertex), apply the rule's
    annotation expression to derived candidates only, and merge with ⨁.
    An empty frontier propagates only ``sr.zero``, so a round issued
    after convergence leaves the state as it was.  One host read per
    :data:`CHECK_EVERY` rounds (``recursion.host_reads``) and one closing
    transfer."""
    dev, dt = backend.device, sr.dtype
    zero = torch.tensor(float(np.asarray(sr.zero)), dtype=dt, device=dev)
    k0 = torch.as_tensor(np.asarray(keys0, dtype=IDX_NP), device=dev)
    state = torch.full((n,), float(np.asarray(sr.zero)), dtype=dt,
                       device=dev)
    state[k0] = torch.as_tensor(np.asarray(ann0), device=dev).to(dt)
    frontier = torch.zeros(n, dtype=torch.bool, device=dev)
    frontier[k0] = True
    g = torch.as_tensor(np.asarray(gather, dtype=IDX_NP), device=dev)
    sc = torch.as_tensor(np.asarray(scatter, dtype=IDX_NP), device=dev)
    ea = (None if edge_ann is None else
          torch.as_tensor(np.asarray(edge_ann), device=dev).to(dt))

    def step(state, frontier):
        src = torch.where(frontier[g], state[g], zero)
        contrib = src if ea is None else sr.mul(ea, src)
        agg = sr.segment_reduce(contrib, sc, n)
        derived = agg != zero
        cand = torch.where(derived, apply_expr(agg).to(dt), zero)
        new = sr.add(state, cand)
        return new, new != state

    (state, _), rounds, reads = _run_blocks(
        step, (state, frontier), lambda s: s[1].any(), int(max_rounds))
    backend.stats["recursion.host_reads"] += reads
    state_h = np.asarray(host_get(state), dtype=np.float64)  # the closing transfer
    derived = state_h != float(np.asarray(sr.zero))
    keys = np.flatnonzero(derived).astype(np.int64)
    return keys, state_h[keys], rounds


def naive_device_fixpoint(sr: Semiring, apply_expr: ExprFn,
                          out_idx: np.ndarray, rec_idx: np.ndarray,
                          factor_kinds: Tuple[str, ...],
                          factor_anns: List[np.ndarray], k: int,
                          ann0: np.ndarray, iters: Optional[int],
                          tol: Optional[float], max_rounds: int, backend):
    """Whole naive fixpoint on ``backend.device``: the head key set is
    FIXED across rounds (naive recursion re-derives every annotation), so
    one round is a fixed-shape gather → ⊗-chain → segment-⨁ → expression
    rewrite over the key positions.  ``factor_kinds`` mirrors the
    body-atom order of every annotated atom ("rec" = the recursive atom's
    live state, "static" = a round-invariant annotation gather), so the
    ⊗-chain multiplies in exactly the order the Generic-Join fold would.

    Convergence: a fixed iteration count (no host read until the closing
    transfer), or the float differential ``max|new - ann| > tol``,
    computed on the device every round; once it falls to ``tol`` the
    state is frozen, so rounds issued past convergence change nothing.
    Returns ``(ann float64 [k], rounds)``."""
    if "rec" not in factor_kinds:
        raise ValueError("naive round needs the recursive factor")
    dev, dt = backend.device, sr.dtype
    anns = tuple(torch.as_tensor(np.asarray(a), device=dev).to(dt)
                 for a in factor_anns)
    oi = torch.as_tensor(np.asarray(out_idx, dtype=IDX_NP), device=dev)
    ri = torch.as_tensor(np.asarray(rec_idx, dtype=IDX_NP), device=dev)
    ann = torch.as_tensor(np.asarray(ann0), device=dev).to(dt)

    def round_body(ann):
        contrib = None
        si = 0
        for kind in factor_kinds:
            if kind == "rec":
                f = ann[ri]
            else:
                f = anns[si]
                si += 1
            contrib = f if contrib is None else sr.mul(contrib, f)
        agg = sr.segment_reduce(contrib, oi, k)
        return apply_expr(agg).to(dt)

    if iters is not None:
        for _ in range(iters):
            ann = round_body(ann)
        return np.asarray(host_get(ann), dtype=np.float64), int(iters)

    (ann, _), rounds, reads = _run_blocks(
        _frozen(round_body, tol), (ann, _inf_like(ann)), lambda s: s[1] > tol,
        int(max_rounds))
    backend.stats["recursion.host_reads"] += reads
    return np.asarray(host_get(ann), dtype=np.float64), rounds



# ----------------------------------------------------- generic fixpoint API
def fixpoint(step: Callable, x0, *, iters: Optional[int] = None,
             tol: Optional[float] = None, max_iters: int = 10_000,
             check_every: int = CHECK_EVERY, backend=None):
    """Driver matching the paper's convergence criteria: a fixed number of
    iterations (i=K) or a float differential (c=eps).  Runs where ``x0``
    lies: ``step`` is the caller's, and the differentials are computed
    beside the iterates.

    The tolerance path is :func:`_run_blocks` over the frozen step: the
    per-step differentials are computed on the device, an iterate at or
    past convergence is kept as it is, and ONE host read per block of
    ``check_every`` steps fetches the flag and the step count.  The
    result is the FIRST iterate at-or-past convergence, as a
    per-iteration check would give.  ``backend`` (an ``ExecBackend``)
    records the sync discipline in its dispatch counters
    (``fixpoint.host_syncs`` vs ``fixpoint.steps``).
    """
    stats = getattr(backend, "stats", None)

    def bump(key, v=1):
        if stats is not None:
            stats[key] += v

    if iters is not None:
        x = x0
        for _ in range(iters):
            x = step(x)
        bump("fixpoint.steps", iters)
        return x
    if tol is None:
        raise ValueError("fixpoint needs iters or tol")
    x0 = torch.as_tensor(x0)
    (x, _), steps, reads = _run_blocks(
        _frozen(step, tol), (x0, _inf_like(x0)), lambda s: s[1] > tol,
        int(max_iters), max(1, int(check_every)))
    bump("fixpoint.host_syncs", reads)
    bump("fixpoint.steps", steps)
    return x
