#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Run from the root of a checkout on a machine with a card:

    python3 chip_smoke.py [--profile]
    python3 chip_smoke.py --fold-cases [--repeat N] [--fold-profile]
                          [--src DIR]

``--profile`` adds a breakdown of one warm full-size TRIANGLE_COUNT and
one warm full-size ``TY`` (host functions by own time, device kernels by
time) after the main and the materializing path.

``--fold-cases`` runs the build and phase 8 alone, then times the batched
fold's cases (a)-(i) on its captured calls (``--repeat`` times) and the
single fold's cases (a)-(e) on phase 8's largest single-query call;
``--fold-profile`` then splits each batched case's block-cycles by phase
through a build of ``frontier_fill.cu`` with ``-DFOLD_PROFILE``.  The
package and its kernels come from ``--src`` (default: this checkout's
``src``), the cases from this script, so a checkout of another commit
given as ``--src OTHER/src`` runs the same cases on its own kernels.  The
last line is a JSON object of each run's median ms by case letter.

Phases (any failure ends the run with a non-zero exit and no result line):

1. build: compile every CUDA kernel of the port from ``src/repro_torch/csrc``
   with nvcc for sm_90a (one nvcc per source, in parallel), and print each
   kernel's ptxas line (registers, stack frame, spills); the fill's, the
   batched fill's and every instance of the batched fold's two kernels
   must show no stack frame and no spill;
2. main path, with every kernel launch counter set to 0 just before and
   read just after: ``Engine(backend="device")`` runs the Table 2 queries
   TRIANGLE_COUNT, LOLLIPOP and BARBELL (cold, then warm: plans, layout
   stores and uploads cached, the bag-result cache emptied) on
   ``powerlaw_graph(200_000, 20, 2.2, seed=0)`` (3,616,984 directed
   edges), then all five pattern queries on ``powerlaw_graph(2000, 12,
   2.0)`` (the size ``benchmarks/run.py`` uses; FOUR_CLIQUE's device fold
   runs there), each equal to the port's host oracle
   (``Engine(backend="numpy")``) with no per-extension host sync for the
   counting queries; the pipeline, both cohort kernels and every kernel
   must fire, ``bitset_intersect`` (the fused ``bitset_pair_count``) once
   a both-dense count and ``frontier_fill`` once a call with slots;
3. the full-size triangle count is held against the host oracle;
4. recursion path, with every launch counter set to 0 just before and read
   just after: on the full-size graph ``Engine(backend="device")`` runs
   ``pagerank_program(5)`` and ``sssp_program(hub)`` cold and warm (as
   in phase 2), held against ``Engine(backend="numpy")`` (SSSP exact,
   PageRank within relative 1e-4) with one device fixpoint, no host round
   and as many device rounds as the oracle's host rounds, and prints the
   wall split between each base rule, the fixpoint's host preparation and
   its device loop;
   ``recursion.pagerank(iters=5, backend=DeviceBackend())`` on
   ``powerlaw_graph(2_000_000, 20, 2.2, seed=0)`` (37,230,744 directed
   edges), packed at width 1 (the CSR itself, one slot an edge), through
   the merge-path ``spmv_ell`` (5 launches, ``spmv.ell_kernel`` 5), held
   against ``pagerank_np``, and that packing timed against the general
   scatter's arrays at width 1, which it must equal; ``recursion.sssp``
   on the full-size graph, exact against ``sssp_np``, and
   ``recursion.fixpoint`` with a tolerance (min-plus hop distances, one
   host read per 8 steps) equal to it;
5. materializing path, with every launch counter set to 0 just before
   and read just after: on the full-size graph ``Engine(backend="device")``
   runs ``TY(x,y)`` and ``SM(x; SUM(z))`` over the triangle (cold, then
   warm, as in phase 2), whose ``z`` extension routes to the pair store's
   materializing route and its dense pairs to ``materialize``; the same
   queries on ``MAT_ORACLE_GRAPH``, ``powerlaw_graph(50_000, 20, 2.2)``,
   are held against ``Engine(backend="numpy")`` there (the host oracle
   takes minutes at full size); the lollipop projection ``P(y,a)`` and
   ``MN(x; MIN(z))`` run on ``powerlaw_graph(2000, 12, 2.0)``, each equal
   to the host oracle; ``extend.pair_materialize_calls``,
   ``intersect.materialize_kernel`` and the kernel's launches must be
   non-zero, and ``materialize`` must launch once a call;
6. dense triangle path, with every launch counter set to 0 just before
   and read just after: ``triangle_count_dense`` of the dense 0/1
   adjacency of ``prune_symmetric(symmetrize(powerlaw_graph(16_384, 20,
   2.2)))`` (16,384^2 float32) through ``triangle_mm``, equal to the
   device engine's TRIANGLE_COUNT on the symmetric graph divided by 6;
7. recsys serving path, with every launch counter set to 0 just before
   and read just after: the ``fm`` config at full width (39 fields x
   1,000,000 rows x dim 10, a 1.56 GB float32 table, random weights from
   ``torch.Generator("cuda").manual_seed(0)``) serves
   ``RecsysBatchGen(39, 1_000_000, B, seed=0).batch_at(0)`` through
   ``fm.forward`` at B = 512 (``serve_p99``) and 262,144 (``serve_bulk``),
   warm walls from the host batch and with the ids on the card, one
   profiled bulk forward (gather against ``fm_interaction``), the bulk
   batch again through ``serve.batched_scores`` in chunks of 512, and
   ``retrieval_scores`` for 16 user rows against 1,000,000 candidates;
   logits (every p99 row, 4,096 bulk rows) and retrieval scores held
   against a float64 oracle on the card (the pairwise O(F^2)
   interaction) within ``rtol=1e-5, atol=1e-6``, every logit finite;
8. relational serving path, with every launch counter set to 0 just
   before and read just after: ``QueryServer()`` on the card serves the
   full-size graph as a tenant; ``triangle_at`` and ``triangle_list_at``
   (prepared queries anchored at a bind parameter) run over its 64
   highest-degree vertices one at a time (cold and warm wall, p50/p99;
   no plan search after warm-up), then through ``run_batch`` and through
   ``submit`` + ``drain``: every batched answer equals the sequential
   one, 4 of each equal the host oracle, the batched fill and fold launch
   once a batched step and chunk, and ``triangle_at`` must batch; a
   second tenant, ``powerlaw_graph(2000, 12, 2.0)``, under a byte budget
   below the two tenants' model bytes, serves ``4clique_at`` (batched)
   and ``lollipop_at`` (the sequential loop) over its 16 highest-degree
   vertices, evicts the full tenant (``torch.cuda.memory_allocated``
   printed around it), whose re-query equals its first answer, and
   ``check_store`` holds the memory model against the live bytes;
8b. preprocessing path, with every launch counter set to 0 just before
   and read just after, each kernel's launches equal to its calls with
   work and no kernel off the path launched: ``graph_stats`` of the
   full-size graph, then for each of the seven orderings of Appendix
   C.2.1 ``order_nodes``, ``apply_ordering`` and ``prune_symmetric``
   (each timed), the pruned graph in ``Engine(backend="device")``, its
   TRIANGLE_COUNT cold and warm equal to phase 2's divided by 6, with the
   largest pruned degree, the layout store's ``stats()`` and the warm
   run's counters; on the degree-ordered, pruned graph TRIANGLE_COUNT in
   each layout mode ("set", "uint", "off"), the three equal and each
   through its route (``bitset_intersect`` in "set", ``uint_intersect``
   and no bitset route in "uint", no pair route in "off", whose fold runs
   in ``frontier_fold`` with no per-extension host sync), then
   FOUR_CLIQUE in "set"; TRIANGLE_COUNT and FOUR_CLIQUE in each mode on
   the degree-ordered, pruned ``MAT_ORACLE_GRAPH`` equal to the host
   oracle; for each of ``KRON_RUNS`` ``kronecker_graph`` generated,
   ``graph_stats``, degree-ordered and pruned, TRIANGLE_COUNT in its
   modes, equal and each through its route, with the y frontier's rows
   measured by the engine equal to ``y_frontier_rows``: at
   ``KRON_PAPER_SCALE`` "set" against "uint" (the frontier exceeds the
   pipeline's buffer, checked), at ``KRON_SCALE`` "set" against "off"
   (it fits, checked), and at ``KRON_ORACLE_SCALE`` those against the
   host oracle; the mode is "set" again after the phase, whatever
   happened;
9. every kernel is run again on the largest inputs its path gave it and
   held against its plain PyTorch version — bit for bit (``materialize``
   up to its total, two launches equal, with the closing fetch of the
   whole buffer and of the total's records timed, and three more cases:
   every AND full, no match, and no match with every row from L1;
   ``frontier_fill`` with six cases built from its captured call, each
   bit-equal and timed with its min and max: the call as it is, with
   ``total_c = 0`` (the masked tail alone), cut to its live slots, that
   with no probe, one hub row of a million slots, and the call launched
   bare through the C entry beside the wrapper's host time a call and the
   L2 flush's device time, and lines for the call's outputs zeroed by
   PyTorch (the floor of its writes under the same timing) and for the
   extension's compaction (``core.backend._compact``) on its outputs;
   ``frontier_fold`` two launches equal, with the bytes alone beside its
   operation bound, four cases built from its captured call, each held
   and timed the same way: the call as it is, with no candidate, cut to
   its live prefix, and that prefix with one probe, and a fifth, one hub
   row of a million candidates;
   ``bitset_intersect``, the fused ``bitset_pair_count``, two launches
   equal, with seven cases from its captured call: as it is, its pairs
   shuffled, the matched-pair ``bitset_and_popcount`` on its matched
   blocks, that route's host wall, the largest set against every slot,
   its block matching alone, and the call through the any-width
   instance, and one more, a hub spanning two slices of the kernel's
   staging; ``uint_intersect`` with the captured call's shape (runs,
   set sizes, the rows read through L2 beside the bound) and six cases,
   each held and timed the same way, one launch a call: the call as it
   is, shuffled, with ``u`` and ``v`` swapped, 65,536 pairs of
   256-element sets, as many pairs as the call of a 1-element set
   against a 256-element one, and the call's pairs with every set
   empty; ``triangle_mm`` against the float64 count), or for
   ``spmv_ell`` within 1e-5 of each vertex's absolute sum of the plain
   version's sums taken in float64 (the float32 plain version's own
   distance from them is printed: on the width-1 packing it adds a hub's
   terms one by one) and for ``fm_interaction`` within 1e-5 of each
   row's absolute scale, their two launches bit-identical — and both are
   timed with CUDA events (L2 flushed before each run, the card kept
   busy while the host queues it: ``HOLD_CYCLES``); ``spmv_ell``
   (the merge-path kernel on the large graph's width-1 packing, whose
   slots are its entries) also beside one ``torch.sparse`` CSR product,
   and timed once more on the width-32 split packing of the same graph
   (a printed line, not a table row), and ``triangle_mm`` beside
   ``(torch.matmul(A, A) * A).sum()`` (``library_ms``, used nowhere in
   the port; no single PyTorch call computes the FM interaction), with
   printed lines for its tile statistics, scratch bytes and two passes
   timed apart (CUDA events), for the all-zero matrix of the same
   size (count 0), and for its worst case, a random 0/1 8,192^2 matrix
   at density 0.5 (exact against the float64 plain version, two launches
   equal, timed beside ``torch.matmul``); the batched fill and fold on
   their largest serving calls, bit-equal, two launches equal, timed
   beside the same rows launched as B single-query calls, the call's
   probe segments counted (distinct a query, their lengths), and the
   batched fold on six cases built from its call (as it is, with no
   candidate, cut to its live rows, those with no probe, with each probe
   segment cut to 64 values, and with segments that differ from row to
   row), each held and timed like the fold's, three more regimes (70,000
   anchored queries of 4 rows, the same rows with row-dependent segments,
   and the second tenant's ``4clique_at`` call) and the tests' anchored
   batch; and phase 8b's largest ``uint_intersect`` call of mode "uint"
   and ``frontier_fold`` call of mode "off", each bit-equal to its plain
   version, two launches equal, timed beside its bound (printed lines).

The last three lines of standard output are the kernel table (JSON), the
card's ``name, power.limit`` from nvidia-smi, and the result line
``{"ok": true, "device": {...}}``.  Imports nothing of jax or ``repro``.
"""
import argparse
import collections
import json
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

FULL_GRAPH = (200_000, 20, 2.2)
SMALL_GRAPH = (2000, 12, 2.0)
LARGE_GRAPH = (2_000_000, 20, 2.2)   # between Patents and LiveJournal
TRI_GRAPH = (16_384, 20, 2.2)        # its dense adjacency: 16,384^2 float32
TRI_WORST_N = 8192                   # triangle_mm's dense worst case
# materialize's write-bound case: this many of the captured call's pairs
# over all-ones blocks, 256 matches a pair (268M records, 4.3 GB)
MAT_FULL_PAIRS = 1 << 20
# the materializing path's host oracle runs on a graph of the full-size
# graph's shape with about a quarter of its edges, which the device engine
# answers too: at full size the oracle takes 210 s (TY) and 159 s (SUM
# over z) on the host of the H100 machine
MAT_ORACLE_GRAPH = (50_000, 20, 2.2)
MAT_QUERIES = (
    ("TY", "TY(x,y) :- R(x,y),S(y,z),T(x,z)."),
    ("SUM_Z", "SM(x;w:long) :- R(x,y),S(y,z),T(x,z); w=<<SUM(z)>>."))
SMALL_MAT_QUERIES = (
    ("P_YA", "P(y,a) :- R(x,y),S(y,z),T(x,z),U(x,a)."),
    ("MIN_Z", "MN(x;w:long) :- R(x,y),S(y,z),T(x,z); w=<<MIN(z)>>."))
PR_ITERS = 5
# PageRank on the card against a host answer: float32 sums over hub rows
# of up to ~10^5 terms, in an order that CUDA's atomic index_add_ changes
# from run to run (the engine) or that differs from a float64 oracle's
# (recursion.pagerank); relative error, largest over the vertices
PR_REL_LIMIT = 1e-4
# spmv_ell against its plain version's sums taken in float64: |y - ref|
# per vertex over the vertex's absolute sum (the same sums, in another
# order and in float32)
ELL_REL_LIMIT = 1e-5
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
INT32_OPS_PER_S = 67e12        # H100 SXM 32-bit rate outside the tensor cores
F32_OPS_PER_S = 67e12          # H100 SXM float32 rate outside the tensor cores
BF16_OPS_PER_S = 989e12        # H100 SXM dense bf16 tensor cores (0/1 exact)
# FM serving (phase 7): the full-width fm config, 1 warm run then at least
# 20 timed ones per wall; logits and retrieval scores against a float64
# oracle on the card (the pairwise O(F^2) form for the interaction)
FM_REPS = 21
FM_ORACLE_ROWS = 4096
FM_USERS = 16                  # user rows of a retrieval query
FM_RTOL, FM_ATOL = 1e-5, 1e-6
# fm_interaction against its plain version: |out - ref| per row over the
# row's absolute scale 0.5 * sum_d((sum_f |e|)^2 + sum_f e^2) (the same
# sums in another order; the sum-square form cancels, so the result
# itself may lie near 0)
FM_SCALE_REL = 1e-5
# before each timed run the card spins this many cycles (about 1 ms) ahead
# of the L2 flush, so the host has queued the run by the time the card
# reaches it: the events then time the device alone, not the wrapper's
# host time past the flush
HOLD_CYCLES = 2_000_000
KERNELS = {
    # name: (source, TPU kernel it replaces)
    "frontier_fill": ("src/repro_torch/csrc/frontier_fill.cu",
                      "src/repro/kernels/frontier_fill/kernel.py:45"),
    # the reference's device fold is a jnp while-loop over fill chunks
    # inside the bag program, not a Pallas kernel
    "frontier_fold": ("src/repro_torch/csrc/frontier_fill.cu",
                      "src/repro/core/backend.py:1091"),
    "bitset_intersect": ("src/repro_torch/csrc/bitset_intersect.cu",
                         "src/repro/kernels/bitset_intersect/kernel.py:45"),
    "uint_intersect": ("src/repro_torch/csrc/uint_intersect.cu",
                       "src/repro/kernels/uint_intersect/kernel.py:50"),
}
RECURSION_KERNELS = {
    "spmv_ell": ("src/repro_torch/csrc/spmv_ell.cu",
                 "src/repro/kernels/spmv_ell/kernel.py:38"),
}
MAT_KERNELS = {
    "materialize": ("src/repro_torch/csrc/materialize.cu",
                    "src/repro/kernels/materialize/kernel.py:57"),
}
TRI_KERNELS = {
    "triangle_mm": ("src/repro_torch/csrc/triangle_mm.cu",
                    "src/repro/kernels/triangle_mm/kernel.py:53"),
}
RECSYS_KERNELS = {
    "fm_interaction": ("src/repro_torch/csrc/fm_interaction.cu",
                       "src/repro/kernels/fm_interaction/kernel.py:33"),
}
# the relational serving path (phase 8): prepared queries anchored at a
# bind-parameter vertex, re-bound to the full-size graph's highest-degree
# vertices as benchmarks/serve_bench.py picks them
SERVE_BINDINGS = 64
SERVE_HOST_BINDINGS = 4        # of each query, held against the host oracle
SERVE_SMALL_BINDINGS = 16      # the second tenant's highest-degree vertices
SERVE_ALIASES = ("S", "T", "U", "X", "Y", "R2", "S2", "T2")
SERVE_QUERIES = {
    "triangle_at": "C(;w:long) :- R(0,y),S(y,z),T(0,z); w=<<COUNT(*)>>.",
    "triangle_list_at": "L(y,z) :- R(0,y),S(y,z),T(0,z).",
    "4clique_at": ("C(;w:long) :- R(0,y),S(y,z),T(0,z),U(0,a),X(y,a),"
                   "Y(z,a); w=<<COUNT(*)>>."),
    "lollipop_at": ("C(;w:long) :- R(0,y),S(y,z),T(0,z),U(0,a); "
                    "w=<<COUNT(*)>>."),
}
# the preprocessing path (phase 8b): the layout modes of the engine, and
# the Kronecker graphs (Graph500 parameters) it orders, prunes and counts,
# each scale in the modes it is held in.  Scale 20 is the paper's Patents
# and LiveJournal scale; its pruned y frontier exceeds the pipeline's
# PIPELINE_MAX_BUFFER (4,194,304 rows), so the pipeline lands that
# extension and mode "off" would count by materializing the fold on the
# host: it is held "set" against "uint".  Scale 18 is the largest whose
# frontier fits (from 19 on it does not): there "set" is held against
# "off", the pair kernels against frontier_fold
LAYOUT_MODES = ("set", "uint", "off")
KRON_PAPER_SCALE = 20
KRON_SCALE = 18
KRON_ORACLE_SCALE = 16         # held against the host oracle
KRON_RUNS = ((KRON_PAPER_SCALE, ("set", "uint")), (KRON_SCALE, ("set", "off")),
             (KRON_ORACLE_SCALE, ("set", "off")))
KRON_EDGE_FACTOR = 16
SERVE_KERNELS = {
    # the reference's batched bag program vmaps the fill's and the fold's
    # plain versions
    "frontier_fill_batched": ("src/repro_torch/csrc/frontier_fill.cu",
                              "src/repro/kernels/frontier_fill/kernel.py:45"),
    "frontier_fold_batched": ("src/repro_torch/csrc/frontier_fill.cu",
                              "src/repro/core/backend.py:827"),
}


def spmv_ell_f64(cols, vals, row_ptr, x):
    """The plain ELL SpMV's sums taken in float64: the exact value the
    float32 kernel is held against (the float32 plain version adds a
    hub's hundreds of thousands of terms one by one with atomics, so its
    own sums are off by more than the limit and differ from run to
    run)."""
    import torch
    part = (x.double()[cols.long()] * vals.double()).sum(dim=1)
    n = int(row_ptr.shape[0]) - 1
    owner = torch.repeat_interleave(
        torch.arange(n, device=x.device), (row_ptr[1:] - row_ptr[:-1]).long(),
        output_size=int(cols.shape[0]))
    return torch.zeros(n, dtype=torch.float64,
                       device=x.device).index_add_(0, owner, part)


def log(msg):
    print(msg, flush=True)


def fail(msg, code=1):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


class Capture:
    """Wrap a kernel wrapper to keep the arguments of its largest call and
    count its calls with work (size above 0).  With ``copy`` it keeps
    copies of the tensors, so the path's own (a tenant's levels) can be
    freed."""

    def __init__(self, module, attr, size_of, copy=False):
        self.module, self.attr = module, attr
        self.orig = getattr(module, attr)
        self.size, self.args, self.calls = -1, None, 0

        def wrapped(*args):
            n = size_of(*args)
            self.calls += n > 0
            if n > self.size:
                self.size, self.args = n, _copied(args) if copy else args
            return self.orig(*args)

        setattr(module, attr, wrapped)

    def restore(self):
        setattr(self.module, self.attr, self.orig)


def _copied(x):
    """``x`` with every tensor in it (tuples walked) cloned."""
    if isinstance(x, tuple):
        return tuple(_copied(v) for v in x)
    return x.clone() if hasattr(x, "clone") else x


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def device_events(prof, torch):
    """(device us, count, name) of each kind of device event in a
    ``torch.profiler`` run, longest first: device-side events only
    (kernels and copies), since the CPU-side op records carry the same
    device time again."""
    kernels = []
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0))
        if us > 0:
            kernels.append((us, ev.count, ev.key))
    return sorted(kernels, reverse=True)


def profile_query(eng, q, cache_cls, torch):
    """Where the time of one warm query goes: host functions by own time
    (cProfile) and device kernels by time (torch.profiler), beside the
    query's wall.  Launches made here come after the main path's counts
    were read."""
    import cProfile
    import io
    import pstats

    from torch.profiler import ProfilerActivity, profile

    eng.bag_cache = cache_cls()
    pr = cProfile.Profile()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pr.enable()
        eng.query(q)
        torch.cuda.synchronize()
        pr.disable()
        wall = time.perf_counter() - t0
    kernels = device_events(prof, torch)
    device_us = sum(k[0] for k in kernels)
    copy_us = sum(k[0] for k in kernels if k[2].startswith("Memcpy"))
    log(f"[profile] wall {wall} s under both profilers; device busy "
        f"{device_us / 1e6} s, of which copies {copy_us / 1e6} s "
        f"({len(kernels)} kinds of device event)")
    for us, count, key in kernels[:12]:
        log(f"[profile] device {us / 1e3:.3f} ms x{count} {key[:90]}")
    buf = io.StringIO()
    pstats.Stats(pr, stream=buf).sort_stats("tottime").print_stats(18)
    for line in buf.getvalue().splitlines():
        if line.strip() and ("/" in line or "{" in line):
            log(f"[profile] host {line.strip()[:150]}")


class WallSplit:
    """Wrap functions to add up their wall time by label (each wrapped
    call ends in a host transfer, so no extra synchronisation)."""

    def __init__(self):
        self.walls = collections.defaultdict(float)
        self.undo = []

    def wrap(self, obj, attr, label):
        """``label`` is a string or a function of the call's arguments."""
        orig = getattr(obj, attr)

        def timed(*args, **kw):
            t0 = time.perf_counter()
            try:
                return orig(*args, **kw)
            finally:
                key = label(*args, **kw) if callable(label) else label
                self.walls[key] += time.perf_counter() - t0

        setattr(obj, attr, timed)
        self.undo.append((obj, attr, orig))

    def restore(self):
        for obj, attr, orig in reversed(self.undo):
            setattr(obj, attr, orig)


def rel_err(got, want):
    import numpy as np
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want) / np.abs(want)))


def recursion_path(src, dst, g, torch):
    """Phase 4: the recursion entry points on the card.  Returns the
    launch counts of this path and the large graph (for the library
    yardstick of the kernel phase)."""
    import numpy as np

    from repro_torch.core import recursion
    from repro_torch.core import workload as W
    from repro_torch.core.backend import DeviceBackend
    from repro_torch.core.engine import Engine
    from repro_torch.core.executor import BagResultCache
    from repro_torch.core.semiring import MIN_PLUS
    from repro_torch.data.graphs import powerlaw_graph
    from repro_torch.kernels import common
    from repro_torch.kernels.spmv_ell import ops as ell_ops

    hub = int(np.argmax(g.degrees))
    programs = (("PAGERANK", W.pagerank_program(PR_ITERS), "naive"),
                ("SSSP", W.sssp_program(hub), "seminaive"))
    t0 = time.perf_counter()
    g2 = powerlaw_graph(*LARGE_GRAPH, seed=0)
    log(f"[recursion] powerlaw_graph{LARGE_GRAPH}: {g2.m} directed edges, "
        f"made in {time.perf_counter() - t0:.1f} s")

    common.reset_launches()
    eng = Engine(backend="device")
    eng.load_edges("Edge", src, dst)
    split = WallSplit()
    split.wrap(eng, "_eval_rule",
               lambda rule, *a, **kw: f"base rule {rule.head.rel}")
    split.wrap(eng, "_eval_recursive", "fixpoint")
    split.wrap(recursion, "naive_device_fixpoint", "fixpoint device loop")
    split.wrap(recursion, "seminaive_device_fixpoint",
               "fixpoint device loop")
    device_res, walls = {}, {}
    for name, q, strategy in programs:
        for run in ("cold", "warm"):
            # warm: plans and uploads cached, bag results not
            eng.bag_cache = BagResultCache()
            before = dict(eng.dispatch_summary())
            split.walls.clear()
            t0 = time.perf_counter()
            res = eng.query(q)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            after = eng.dispatch_summary()
            delta = {k: after.get(k, 0) - before.get(k, 0) for k in after
                     if k.startswith("recursion.")}
            walls[f"{name}.{run}"] = wall
            parts = dict(split.walls)
            parts["base rules"] = sum(v for k, v in parts.items()
                                      if k.startswith("base rule "))
            parts["fixpoint host preparation"] = (
                parts.get("fixpoint", 0.0)
                - parts.get("fixpoint device loop", 0.0))
            log(f"[recursion] {name} {run}: {res.num_rows} rows in {wall} s; "
                f"split {json.dumps(parts, sort_keys=True)}; "
                f"{json.dumps(delta, sort_keys=True)}; plan "
                f"{json.dumps([m['recursion'] for m in eng.plan_metadata() if 'recursion' in m])}")
            check(delta.get("recursion.device_fixpoints", 0) == 1,
                  f"{name} {run}: not one device fixpoint")
            check(delta.get("recursion.host_rounds", 0) == 0
                  and delta.get("recursion.host_trie_rebuilds", 0) == 0,
                  f"{name} {run}: a round ran on the host")
            check(eng.plan_metadata()[-1]["recursion"]["strategy"]
                  == strategy, f"{name}: not {strategy}")
        device_res[name] = (res, delta["recursion.device_rounds"])
    split.restore()
    del eng

    for name, q, _ in programs:
        host = Engine(backend="numpy")
        host.load_edges("Edge", src, dst)
        t0 = time.perf_counter()
        want = host.query(q)
        host_wall = time.perf_counter() - t0
        got, rounds = device_res[name]
        host_rounds = host.dispatch_summary()["recursion.host_rounds"]
        check(np.array_equal(got.columns["x"], want.columns["x"]),
              f"{name}: keys differ from the host engine")
        check(rounds == host_rounds, f"{name}: {rounds} device rounds, "
                                     f"{host_rounds} on the host")
        if name == "SSSP":
            check(np.array_equal(got.annotation, want.annotation),
                  "SSSP differs from the host engine")
            log(f"[recursion] SSSP from {hub}: {got.num_rows} reached, "
                f"{rounds} rounds; host engine {host_wall} s, equal")
        else:
            err = rel_err(got.annotation, want.annotation)
            log(f"[recursion] PAGERANK: host engine {host_wall} s, "
                f"{host_rounds} rounds; largest relative error "
                f"{err} (limit {PR_REL_LIMIT})")
            check(err <= PR_REL_LIMIT, f"PageRank relative error {err}")
        del host
    log(f"[recursion] walls_s {json.dumps(walls)}")

    b = DeviceBackend()
    t0 = time.perf_counter()
    ranks = recursion.pagerank(g2, iters=PR_ITERS, backend=b)
    wall = time.perf_counter() - t0
    err = rel_err(ranks, recursion.pagerank_np(g2, iters=PR_ITERS))
    log(f"[recursion] recursion.pagerank ({g2.n} vertices, {g2.m} edges): "
        f"{wall} s with packing and uploads; largest relative error vs "
        f"pagerank_np {err} (limit {PR_REL_LIMIT}); spmv.ell_kernel "
        f"{b.stats['spmv.ell_kernel']}")
    check(err <= PR_REL_LIMIT, f"recursion.pagerank relative error {err}")
    check(b.stats["spmv.ell_kernel"] == PR_ITERS, "spmv.ell_kernel != iters")
    check(common.LAUNCHES["spmv_ell"] == PR_ITERS,
          f"spmv_ell launched {common.LAUNCHES['spmv_ell']} times, not "
          f"{PR_ITERS}")
    # what the width-1 shortcut saves over the general packing's scatter
    # on the same graph (host only, no launch)
    pack_s = {}
    for name, pack in (("cast", lambda: ell_ops.csr_to_ell_split(
                           g2.offsets, g2.neighbors, width=1)),
                       ("scatter", lambda: ell_ops._scatter_split(
                           g2.offsets, g2.neighbors, None, 1))):
        took, packed = [], None
        for _ in range(3):
            t0 = time.perf_counter()
            packed = pack()
            took.append(time.perf_counter() - t0)
        pack_s[name] = (float(np.median(took)), packed)
    same = all(np.array_equal(a, b) for a, b in
               zip(pack_s["cast"][1], pack_s["scatter"][1]))
    check(same, "the width-1 packing differs from the general scatter's")
    log(f"[recursion] width-1 packing of the {g2.m}-edge graph (median of "
        f"3): {pack_s['cast'][0]} s as a cast of the CSR, "
        f"{pack_s['scatter'][0]} s through the general scatter; equal")
    del pack_s

    t0 = time.perf_counter()
    dist = recursion.sssp(g, hub)
    wall = time.perf_counter() - t0
    check(np.array_equal(dist, recursion.sssp_np(g, hub)),
          "recursion.sssp differs from sssp_np")
    log(f"[recursion] recursion.sssp from {hub}: "
        f"{int(np.isfinite(dist).sum())} reached in {wall} s; sssp_np equal")

    # recursion.fixpoint with a tolerance: hop distances by min-plus
    # relaxation (order-free, so exact); an unreached vertex holds n, not
    # inf, so the differential stays finite
    b = DeviceBackend()
    row = torch.as_tensor(recursion.csr_row_ids(g), device=b.device)
    col = torch.as_tensor(g.neighbors, device=b.device)
    ones = torch.ones(g.m, dtype=torch.float32, device=b.device)
    d0 = torch.full((g.n,), float(g.n), device=b.device)
    d0[hub] = 0.0
    t0 = time.perf_counter()
    d = recursion.fixpoint(
        lambda x: torch.minimum(x, recursion.semiring_spmv(
            MIN_PLUS, g.n, row, col, ones, x)), d0, tol=0.0, backend=b)
    hops = common.host_get(d)
    wall = time.perf_counter() - t0
    hops[hops == g.n] = np.inf
    check(np.array_equal(hops, dist), "recursion.fixpoint hop distances "
                                      "differ from sssp")
    steps, syncs = b.stats["fixpoint.steps"], b.stats["fixpoint.host_syncs"]
    check(syncs == -(-steps // 8), f"fixpoint: {syncs} host reads for "
                                   f"{steps} steps")
    log(f"[recursion] recursion.fixpoint (tol=0, min-plus) from {hub}: "
        f"{steps} steps, {syncs} host reads, {wall} s; equal to sssp")
    launches = dict(common.LAUNCHES)
    log(f"[recursion] launches {json.dumps(launches)}")
    return launches, g2


def load(eng, src, dst, aliases):
    eng.load_edges("Edge", src, dst)
    for a in aliases:
        eng.alias(a, "Edge")
    return eng


def canonical(res):
    """A query result as (key rows sorted, annotation in that order)."""
    import numpy as np
    if not res.vars:
        return np.zeros((0, 0), np.int64), np.asarray(res.annotation)
    rows = np.stack([np.asarray(res.columns[v]) for v in res.vars], 1)
    order = np.lexsort(rows.T[::-1])
    ann = (None if res.annotation is None
           else np.asarray(res.annotation)[order])
    return rows[order], ann


def same_result(got, want):
    import numpy as np
    (ga, gann), (wa, wann) = canonical(got), canonical(want)
    if ga.shape != wa.shape or not np.array_equal(ga, wa):
        return False
    if wann is None:
        return gann is None
    return gann is not None and np.array_equal(gann, wann)


def materialize_path(src, dst, torch):
    """Phase 5: triangle-shaped queries that materialize ``z`` on the
    card.  Returns the launch counts of this path and the full-size
    engine (for the profile)."""
    from repro_torch.core.engine import Engine
    from repro_torch.core import workload as W
    from repro_torch.core.executor import BagResultCache
    from repro_torch.data.graphs import edge_list, powerlaw_graph
    from repro_torch.kernels import common

    import numpy as np

    common.reset_launches()
    eng = load(Engine(backend="device"), src, dst, W.ALIASES)
    device_res, walls = {}, {}
    for name, q in MAT_QUERIES:
        runs = []
        for run in ("cold", "warm"):
            eng.bag_cache = BagResultCache()
            before = dict(eng.dispatch_summary())
            t0 = time.perf_counter()
            res = eng.query(q)
            torch.cuda.synchronize()
            walls[f"{name}.{run}"] = time.perf_counter() - t0
            after = eng.dispatch_summary()
            delta = {k: after[k] - before.get(k, 0) for k in after
                     if k.startswith(("intersect.materialize", "extend.",
                                      "analysis.", "pipeline.launches"))
                     and after[k] != before.get(k, 0)}
            log(f"[materialize] {name} {run}: {res.num_rows} rows in "
                f"{walls[f'{name}.{run}']} s; {json.dumps(delta, sort_keys=True)}")
            check(delta.get("extend.pair_materialize_calls", 0) >= 1,
                  f"{name} {run}: the pair store's materializing route "
                  "did not run")
            check(delta.get("intersect.materialize_kernel", 0) > 0,
                  f"{name} {run}: no pair took the materialize kernel")
            runs.append(res)
        check(same_result(*runs), f"{name}: the warm run differs from the "
                                  "cold one")
        device_res[name] = res
    # full size: the x of the triangles' SUM rows are the x of TY's rows
    check(np.array_equal(np.unique(device_res["TY"].columns["x"]),
                         np.unique(device_res["SUM_Z"].columns["x"])),
          "TY and SUM(z) disagree on which x lie on a triangle")
    log(f"[materialize] walls_s {json.dumps(walls)}")

    osrc, odst = edge_list(powerlaw_graph(*MAT_ORACLE_GRAPH, seed=0))
    oeng = load(Engine(backend="device"), osrc, odst, W.ALIASES)
    host = load(Engine(backend="numpy"), osrc, odst, W.ALIASES)
    for name, q in MAT_QUERIES:
        t0 = time.perf_counter()
        got = oeng.query(q)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        t0 = time.perf_counter()
        want = host.query(q)
        log(f"[materialize] {name} on powerlaw_graph{MAT_ORACLE_GRAPH}: "
            f"{got.num_rows} rows in {wall} s; host oracle "
            f"{want.num_rows} rows in {time.perf_counter() - t0} s")
        check(same_result(got, want), f"{name} differs from the host "
                                      "engine")
    del oeng, host

    s2, d2 = edge_list(powerlaw_graph(*SMALL_GRAPH, seed=0))
    for name, q in SMALL_MAT_QUERIES:
        dev_eng = load(Engine(backend="device"), s2, d2, W.ALIASES)
        t0 = time.perf_counter()
        got = dev_eng.query(q)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        want = load(Engine(backend="numpy"), s2, d2, W.ALIASES).query(q)
        d = dev_eng.dispatch_summary()
        log(f"[materialize] small {name}: {got.num_rows} rows in {wall} s; "
            f"materialize_kernel pairs "
            f"{d.get('intersect.materialize_kernel', 0)}")
        check(same_result(got, want), f"{name} on the small graph differs "
                                      "from the host engine")
        check(d.get("intersect.materialize_kernel", 0) > 0,
              f"{name}: no pair took the materialize kernel")
    launches = dict(common.LAUNCHES)
    log(f"[materialize] launches {json.dumps(launches)}")
    return launches, eng


def triangle_path(torch):
    """Phase 6: the dense triangle count through ``triangle_mm``, against
    the device engine's TRIANGLE_COUNT on the symmetric graph.  Returns
    the launch counts of this path."""
    from repro_torch.core import workload as W
    from repro_torch.core.engine import Engine
    from repro_torch.data.graphs import edge_list, powerlaw_graph
    from repro_torch.graph.prune import prune_symmetric, symmetrize
    from repro_torch.kernels import common, triangle_count_dense
    from repro_torch.kernels.triangle_mm.ops import densify_csr

    g = powerlaw_graph(*TRI_GRAPH, seed=0)
    sym = symmetrize(*edge_list(g), n=g.n)
    pruned = prune_symmetric(sym)
    common.reset_launches()
    t0 = time.perf_counter()
    dense = densify_csr(pruned.offsets, pruned.neighbors, g.n)
    tri = triangle_count_dense(dense, symmetric=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    del dense
    eng = load(Engine(backend="device"), *edge_list(sym), W.ALIASES)
    count = int(eng.query(W.TRIANGLE_COUNT).scalar())
    del eng
    log(f"[triangle] powerlaw_graph{TRI_GRAPH}: {sym.m} directed edges, "
        f"{pruned.m} after pruning; triangle_count_dense {float(tri)} in "
        f"{wall} s with densify and upload; engine TRIANGLE_COUNT {count}")
    check(count % 6 == 0 and float(tri) == count // 6,
          f"dense triangle count {float(tri)} != engine {count} / 6")
    launches = dict(common.LAUNCHES)
    log(f"[triangle] launches {json.dumps(launches)}")
    return launches


def triangle_mm_passes(a, tri_ops, time_stats, torch):
    """What ``triangle_mm``'s count pass visits on ``a``, its scratch, and
    its two passes timed apart (CUDA events, L2 flushed, median of 5
    launches of each): a clause of the kernel's printed line."""
    from repro_torch.kernels.triangle_mm.ref import tile_stats
    n = int(a.shape[0])
    nt = n // 32
    occupied, triples = tile_stats(a)
    scratch = torch.empty(tri_ops.scratch_bytes(n), dtype=torch.uint8,
                          device="cuda")
    out = torch.empty((), dtype=torch.int64, device="cuda")
    pack_ms = time_stats(
        lambda: tri_ops.run_passes(a, scratch, out, tri_ops.PACK), 5)[0]
    count_ms = time_stats(
        lambda: tri_ops.run_passes(a, scratch, out, tri_ops.COUNT), 5)[0]
    check(torch.equal(out, tri_ops.triangle_mm(a)),
          "triangle_mm's count pass alone differs from the whole call")
    del scratch
    return (f"{occupied} of {nt * nt} 32x32 tiles occupied, {triples} tile "
            f"triples visited of nt^3 = {nt ** 3} "
            f"({100 * triples / nt ** 3:.2f}%); pack pass {pack_ms:.4f} ms, "
            f"count pass {count_ms:.4f} ms (CUDA events, L2 flushed, median "
            f"of 5); scratch {tri_ops.scratch_bytes(n)} bytes")


def triangle_mm_cases(a, tri_ops, plain, time_stats, torch):
    """``triangle_mm`` on the all-zero matrix of ``a``'s size (count 0)
    and on its worst case, a dense random 0/1 matrix where every tile
    triple holds work, exact against the float64 plain version and timed
    beside ``torch.matmul``: printed lines, not table rows."""
    zero = torch.zeros_like(a)
    got = tri_ops.triangle_mm(zero)
    check(int(got) == 0, f"triangle_mm of the zero matrix gives {int(got)}")
    log(f"[kernel] triangle_mm on the zero {int(a.shape[0])}^2 matrix: "
        f"count 0; " + triangle_mm_passes(zero, tri_ops, time_stats, torch))
    del zero
    n = TRI_WORST_N
    gen = torch.Generator(device="cuda").manual_seed(0)
    d = (torch.rand((n, n), generator=gen, device="cuda") < 0.5).float()
    got = tri_ops.triangle_mm(d)
    check(torch.equal(got, tri_ops.triangle_mm(d)),
          "triangle_mm worst case: two launches differ")
    want = plain(d)
    check(float(want) == int(got), f"triangle_mm worst case {int(got)} != "
                                   f"plain {float(want)}")
    ms = time_stats(lambda: tri_ops.triangle_mm(d), 5)[0]
    mm_ms = time_stats(lambda: torch.matmul(d, d), 5)[0]
    log(f"[kernel] triangle_mm worst case, a random 0/1 {n}^2 float32 "
        f"matrix at density 0.5 (torch.Generator seed 0): raw count "
        f"{int(got)}, equal to the float64 plain version, two launches "
        f"equal; kernel {ms:.4f} ms, torch.matmul {mm_ms:.4f} ms; "
        + triangle_mm_passes(d, tri_ops, time_stats, torch))


def materialize_bytes(words, pa, pb, total, torch):
    """The bytes ``materialize`` must move, and the blocks it reads: each
    matched block read once (its words, block id and index), the three
    per-pair inputs, 16 bytes per match written and the total."""
    rows_read = int(torch.unique(torch.cat([pa, pb])).numel())
    moved = (rows_read * (int(words.shape[1]) * 4 + 8)
             + 12 * int(pa.shape[0]) + total * 16 + 4)
    return moved, rows_read


def materialize_fetch(buf, total, mat_ops, common, torch):
    """The closing fetch of ``bitset_pair_materialize`` on ``buf``: the
    whole buffer, as it was fetched before the cut at the total, against
    ``fetch`` (the total, then its records); bytes and host wall (median
    of 3) of each: a clause of the kernel's printed line."""
    import numpy as np

    def wall(fn):
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            times.append(time.perf_counter() - t0)
        return float(np.median(times)) * 1e3, out

    whole_ms, _ = wall(lambda: common.host_get(buf))
    cut_ms, cols = wall(lambda: mat_ops.fetch(buf))
    check(all(len(c) == total for c in cols),
          "materialize: fetch did not bring back the total's records")
    return (f"closing fetch of the whole buffer {buf.numel() * 4} bytes in "
            f"{whole_ms:.3f} ms, of the total and its records "
            f"{8 + 16 * total} bytes in {cut_ms:.3f} ms")


def materialize_cases(args, mat_ops, plain, time_stats, torch):
    """``materialize`` on the captured call's pairs over a zero words
    table (no match: the read-only floor), on as many pairs all on one
    zero block (no match, every row from L1: the floor without the rows'
    L2 traffic), and on its first ``MAT_FULL_PAIRS`` pairs over all-ones
    blocks (every AND full, 256 matches a pair: the write-bound worst
    case), each bit-equal to the plain version up to the total, two
    launches equal, timed: printed lines, not table rows."""
    from repro_torch.kernels.materialize.ref import HEADER, buffer_total
    words, block_ids, index, pa, pb, pid, _cap = args
    bits = int(words.shape[1]) * 32
    zero, one_block = torch.zeros_like(words), torch.zeros_like(pa)
    for label, table, ca, cb, per_pair in (
            ("no match (zero words table)", zero, pa, pb, 0),
            ("no match, every pair on one zero block", zero, one_block,
             one_block, 0),
            ("every AND full (all-ones words table)",
             torch.full_like(words, -1), pa[:MAT_FULL_PAIRS],
             pb[:MAT_FULL_PAIRS], bits)):
        n = int(ca.shape[0])
        case = (table, block_ids, index, ca, cb, pid[:n])
        cap = n * per_pair
        got = mat_ops.materialize(*case, cap)
        want = plain(*case, cap)
        total = int(buffer_total(want)[0])
        used = HEADER + 4 * total
        check(int(buffer_total(got)[0]) == total == cap,
              f"materialize, {label}: totals {int(buffer_total(got)[0])} / "
              f"{total} / {cap}")
        check(torch.equal(got[:used], want[:used]),
              f"materialize, {label}: differs from its plain version")
        check(torch.equal(got[:used], mat_ops.materialize(*case, cap)[:used]),
              f"materialize, {label}: two launches differ")
        del got, want
        ms = time_stats(lambda: mat_ops.materialize(*case, cap), 5)[0]
        moved, _ = materialize_bytes(table, ca, cb, total, torch)
        log(f"[kernel] materialize, {label}: pairs={n} matches={total}, "
            f"bit-equal to the plain version, two launches equal; kernel "
            f"{ms:.4f} ms (CUDA events, L2 flushed, median of 5), bound "
            f"{moved / HBM_BYTES_PER_S * 1e3:.4f} ms")


def bit_length(x, torch):
    """``int.bit_length`` of each element of the int64 tensor ``x``
    (0 for 0), on x's device."""
    bits = torch.zeros_like(x)
    for s in (32, 16, 8, 4, 2, 1):
        big = (x >> s) > 0
        bits += big * s
        x = torch.where(big, x >> s, x)
    return bits + (x > 0)


def nbytes_of(*ts):
    """The bytes of the tensors ``ts``."""
    return sum(t.numel() * t.element_size() for t in ts)


def probe_work(counts, probes, torch):
    """Search steps and probe-value bytes for ``counts[r]`` candidates of
    row ``r`` (int64, the per-row bounds flattened alike): each candidate
    searches its row's segment of each probe level, bit_length(L) steps
    (at least 1) for a segment of L values, reading at most one value a
    step; a level's values count at most once."""
    steps, moved = 0, 0
    for v, lo, hi in probes:
        seg = (hi.reshape(-1).long() - lo.reshape(-1).long()).clamp(min=0)
        s = int((counts * bit_length(seg, torch).clamp(min=1)).sum())
        steps += s
        moved += min(int(v.shape[0]), s) * v.element_size()
    return steps, moved


def fold_counts(args, torch):
    """Each row's candidates in a ``frontier_fold`` call (``[cap_in]``,
    or ``[B, cap_in]`` for ``frontier_fold_batched``)."""
    offs, total = args[1], args[2]
    return torch.cat([offs[..., 1:], total.unsqueeze(-1)], -1) - offs


def fold_work(args, torch):
    """Candidates, bytes and int32 operations of one ``frontier_fold``
    call (or ``frontier_fold_batched``, its per-row arrays ``[B, cap_in]``
    and totals ``[B]``), as this call's data needs them: each per-row
    array and output once; a seed value and each leaf annotation at most
    once, and no more of them than the candidates; the probes as
    :func:`probe_work` counts them; 4 operations a search step, and 2
    steps a candidate for its seed read and its reduction."""
    lo0, offs, total, seed, probes, anns, sr = args
    counts = fold_counts(args, torch).reshape(-1).long().clamp(min=0)
    cands = int(counts.sum())
    steps, probe_bytes = probe_work(counts, probes, torch)
    sr_bytes = torch.empty((), dtype=sr.dtype).element_size()
    moved = (nbytes_of(lo0, offs, total)
             + min(cands, int(seed.shape[0])) * seed.element_size()
             + sum(nbytes_of(lo, hi) for _v, lo, hi in probes) + probe_bytes
             + sum(min(cands, a.numel()) * a.element_size() for a in anns
                   if a is not None)
             + lo0.numel() * (4 + sr_bytes))
    return cands, moved, (cands * 2 + steps) * 4


def per_query(probes, b):
    """Query ``b``'s probes out of a batch's ``[B, cap_in]`` bounds."""
    return tuple((v, lo[b], hi[b]) for v, lo, hi in probes)


def fill_work(total_c, offs, lo0, seed, probes, start, n, torch):
    """Live slots, bytes and int32 operations of one ``frontier_fill``
    call over slots ``[start, start + n)`` (or ``frontier_fill_batched``,
    ``[B, cap_in]`` rows, ``[B]`` totals, ``start`` 0), as this call's
    data needs them: each per-row array once; a seed value at most once,
    and no more of them than the live slots; the probes as
    :func:`probe_work` counts them over each row's live slots; every
    output slot written once; each live slot's row search
    (bit_length(cap_in) steps) and probe searches, 4 operations a step."""
    cap_in = int(offs.shape[-1])
    end = (total_c.long().clamp(max=start + n)).unsqueeze(-1)
    first = offs.long().clamp(min=start)
    last = torch.cat([offs[..., 1:].long(), end], -1)
    counts = (torch.minimum(last, end) - torch.minimum(first, end)
              ).clamp(min=0).reshape(-1)
    live = int(counts.sum())
    steps, probe_bytes = probe_work(counts, probes, torch)
    queries = offs.numel() // cap_in
    moved = (nbytes_of(total_c, offs, lo0)
             + min(live, int(seed.shape[0])) * seed.element_size()
             + sum(nbytes_of(lo, hi) for _v, lo, hi in probes) + probe_bytes
             + queries * n * (3 * 4 + 1 + 4 * len(probes)))
    ops = (live * max(1, cap_in.bit_length()) + steps) * 4
    return live, moved, ops


def fill_batched_work(args, fill_ops, torch):
    """The shape line, bytes and int32 operations of one
    ``frontier_fill_batched`` call (:func:`fill_work`'s count), and a
    callable launching the same rows as B single-query ``fill`` calls."""
    total_c, offs, lo0, seed, probes, n = args
    batch, cap_in = (int(x) for x in offs.shape)
    live, moved, ops = fill_work(total_c, offs, lo0, seed, probes, 0, n,
                                 torch)
    shape = (f"batch={batch} slots={n} a query, live={live} "
             f"(largest {int(total_c.clamp(max=n).max())}) cap_in={cap_in} "
             f"n0={int(seed.shape[0])} probes={len(probes)}")

    def singles():
        outs = [fill_ops.fill(total_c[b], offs[b], lo0[b], seed,
                              per_query(probes, b), 0, n)
                for b in range(batch)]
        return [o[:4] + tuple(o[4]) for o in outs]

    return shape, moved, ops, singles


def fold_batched_work(args, fill_ops, torch):
    """``fill_batched_work`` for one ``frontier_fold_batched`` call
    (:func:`fold_work`'s count)."""
    lo0, offs, total, seed, probes, anns, sr = args
    batch, cap_in = (int(x) for x in offs.shape)
    cands, moved, ops = fold_work(args, torch)
    shape = (f"batch={batch} rows={cap_in} a query, candidates={cands} "
             f"(largest query {int(total.max())}) n0={int(seed.shape[0])} "
             f"probes={len(probes)} semiring={sr.name}")

    def singles():
        return [fill_ops.fold(lo0[b], offs[b], total[b], seed,
                              per_query(probes, b), anns, sr)
                for b in range(batch)]

    return shape, moved, ops, singles


def segment_stats(args, torch):
    """For each probe of a ``frontier_fold_batched`` call: how many
    distinct ``(lo, hi)`` segments each query's live rows hold (min /
    median / max over the queries) and those segments' lengths (min /
    median / max)."""
    _lo0, _offs, _total, _seed, probes, _anns, _sr = args
    live = (fold_counts(args, torch) > 0).flatten()
    parts = []
    for k, (_v, lo, hi) in enumerate(probes):
        batch, cap_in = lo.shape
        query = torch.arange(batch, device=lo.device).repeat_interleave(
            cap_in)
        seg = torch.unique(torch.stack([query, lo.flatten().long(),
                                        hi.flatten().long()], 1)[live],
                           dim=0)
        d = torch.bincount(seg[:, 0], minlength=batch).double()
        lengths = (seg[:, 2] - seg[:, 1]).clamp(min=0).double()
        shown = "none" if not lengths.numel() else (
            f"{int(lengths.min())} / {float(lengths.median()):.0f} / "
            f"{int(lengths.max())}")
        parts.append(f"probe {k}: distinct segments a query "
                     f"{int(d.min())} / {float(d.median()):.0f} / "
                     f"{int(d.max())}, their lengths {shown}")
    return "; ".join(parts) or "no probe"


def row_dependent_case(args, torch, seed=0):
    """The rows of a ``frontier_fold_batched`` call with one probe whose
    segment differs from row to row, as ``4clique_at``'s ``X(y,a)``
    builds it: probe level the seed level, live row ``r`` searching the
    seed segment of another live row of its query (a seeded permutation),
    dead rows an empty segment."""
    lo0, offs, total, seed_v, _probes, anns, sr = args
    counts = fold_counts(args, torch)
    g = torch.Generator().manual_seed(seed)
    lo, hi = torch.zeros_like(lo0), torch.zeros_like(lo0)
    for b in range(lo0.shape[0]):
        rows = torch.nonzero(counts[b] > 0).flatten()
        other = rows[torch.randperm(rows.numel(), generator=g).to(
            rows.device)]
        lo[b, rows] = lo0[b, other]
        hi[b, rows] = lo0[b, other] + counts[b, other]
    return (lo0, offs, total, seed_v, ((seed_v, lo, hi),), (anns[0], None),
            sr)


def fold_batched_case_args(args, torch, small_call=None):
    """The ``(label, arguments)`` of :func:`fold_batched_cases` (a)-(f)
    built from one ``frontier_fold_batched`` call's arguments, then (g)
    70,000 anchored queries of 4 rows over 5,000 adjacency lists
    (:mod:`frontier_fill.batches`; most too small to fill a tile of the
    fold), (h) those rows with segments that differ from row to row, and
    (i) ``small_call``, if given."""
    from repro_torch.kernels.frontier_fill.batches import anchored_batch
    lo0, offs, total, seed, probes, anns, sr = args
    live = fold_counts(args, torch) > 0
    at = torch.arange(offs.shape[1], device=offs.device)
    cut = max(int(torch.where(live, at, -1).max()) + 1, 1)

    def rows(x):
        return x[:, :cut].contiguous()

    cut_probes = tuple((v, rows(lo), rows(hi)) for v, lo, hi in probes)
    live_rows = (rows(lo0), rows(offs), total, seed, cut_probes, anns, sr)
    cases = [("(a) the captured call", args),
             ("(b) no candidate", (lo0, torch.zeros_like(offs),
                                   torch.zeros_like(total), seed, probes,
                                   anns, sr)),
             ("(c) live rows", live_rows)]
    if probes:
        short = tuple((v, lo, torch.minimum(hi, lo + 64))
                      for v, lo, hi in cut_probes)
        cases += [("(d) live rows, no probe",
                   live_rows[:4] + ((), anns[:1], sr)),
                  ("(e) live rows, probe segments cut to 64 values",
                   live_rows[:4] + (short, anns, sr))]
    cases.append(("(f) row-dependent probe segments",
                  row_dependent_case(live_rows, torch)))
    for label, varied in (("(g) 70,000 anchored queries of 4 rows", ()),
                          ("(h) 70,000 queries of 4 rows, row-dependent "
                           "segments", range(70_000))):
        total_m, offs_m, lo0_m, seed_m, probes_m = anchored_batch(
            0, batch=70_000, cap_in=4, vertices=5_000, universe=200_000,
            hub=2_000, varied=varied, device=offs.device)
        cases.append((label, (lo0_m, offs_m, total_m, seed_m, probes_m,
                              (None, None), sr)))
    if small_call is not None:
        cases.append(("(i) the second tenant's 4clique_at call",
                      small_call))
    return cases


def fold_batched_cases(args, fold, plain, time_stats, torch,
                       small_call=None):
    """``frontier_fold_batched`` (``fold``) on cases built from the
    captured call's own arguments (:func:`fold_batched_case_args`): (a)
    the call as it is; (b) no candidate (totals and offsets zero: the
    capacity rows alone); (c) each query cut to its live rows (``cap_in``
    cut to the largest query's last live row + 1); (d) case (c) with no
    probe (the seed reads and the merge alone); (e) case (c) with each
    probe segment cut to its first 64 values (the share of the search
    depth); (f) case (c)'s rows with a probe segment that differs from row
    to row (:func:`row_dependent_case`); (g)-(i) as
    :func:`fold_batched_case_args` says.  Each held against the plain
    version (bit for bit; a float sum within rtol 1e-5), two launches
    equal, timed (CUDA events, L2 flushed, median, min and max of 5):
    printed lines, not table rows.  Returns each case's median ms by its
    letter."""
    cases = fold_batched_case_args(args, torch, small_call)
    times = {}
    for label, case in cases:
        sr = case[6]
        got = fold(*case)
        check(fold_equal(got, plain(*case), sr, torch),
              f"frontier_fold_batched, {label}: differs from its plain "
              "version")
        again = fold(*case)
        check(all(torch.equal(x, y) for x, y in zip(got, again)),
              f"frontier_fold_batched, {label}: two launches differ")
        ms = time_stats(lambda: fold(*case), 5)
        times[label[1]] = ms[0]
        cands, moved, ops = fold_work(case, torch)
        log(f"[kernel] frontier_fold_batched, {label}: batch="
            f"{int(case[0].shape[0])} rows={int(case[0].shape[1])} a query "
            f"live_rows={int((fold_counts(case, torch) > 0).sum())} "
            f"candidates={cands} probes={len(case[4])} semiring={sr.name} "
            f"({segment_stats(case, torch)}); equal to the plain version, "
            f"two launches equal; kernel {ms[0]:.4f} ms (min {ms[1]:.4f}, "
            f"max {ms[2]:.4f}; CUDA events, L2 flushed, median of 5), bound "
            f"{max(moved / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S) * 1e3:.4f}"
            f" ms (bytes {moved / HBM_BYTES_PER_S * 1e3:.4f} ms; operations "
            f"{ops / INT32_OPS_PER_S * 1e3:.4f} ms)")
    return times


def anchored_fold_check(fill_ops, plain, time_stats, torch):
    """``frontier_fold_batched`` on the tests' anchored batch
    (``kernels.frontier_fill.batches``) at the serving call's width, 64
    queries of up to 4,096 rows over 50,000 adjacency lists: segments
    that stage beside the hub's 2,000,000-value range, which does not, an
    empty one and a row-dependent query.  Held against the plain version,
    two launches equal, and timed (CUDA events, L2 flushed, median of 5):
    a printed line."""
    from repro_torch.core import semiring as S
    from repro_torch.kernels.frontier_fill.batches import anchored_batch
    total, offs, lo0, seed, probes = anchored_batch(
        0, batch=64, cap_in=4096, vertices=50_000, universe=2_000_000,
        hub=20_000, empty=(2,), varied=(3,), device="cuda")
    args = (lo0, offs, total, seed, probes, (None, None), S.COUNT)
    got = fill_ops.fold_batched(*args)
    check(fold_equal(got, plain(*args), S.COUNT, torch),
          "frontier_fold_batched, anchored batch: differs from its plain "
          "version")
    check(all(torch.equal(x, y) for x, y in
              zip(got, fill_ops.fold_batched(*args))),
          "frontier_fold_batched, anchored batch: two launches differ")
    ms = time_stats(lambda: fill_ops.fold_batched(*args), 5)[0]
    log(f"[kernel] frontier_fold_batched, anchored batch (the tests' "
        f"builder): batch=64 rows=4096 a query candidates="
        f"{int(total.long().sum())} ({segment_stats(args, torch)}); equal "
        f"to the plain version, two launches equal; kernel {ms:.4f} ms "
        f"(CUDA events, L2 flushed, median of 5)")


def fold_equal(got, want, sr, torch):
    """Support bit for bit; the fold bit for bit, or for a float sum
    within float32 rounding of its terms' order (rtol 1e-5)."""
    if not torch.equal(got[1], want[1]):
        return False
    if sr.name.startswith("sum_f"):
        return torch.allclose(got[0], want[0], rtol=1e-5, atol=0)
    return torch.equal(got[0], want[0])


def hub_case(n_probes, sr, device, torch, n=1_000_000):
    """One row of ``n`` candidates, each probe a segment of ``n`` values:
    sorted distinct values drawn from [0, 4n) with a seeded generator."""
    g = torch.Generator().manual_seed(0)

    def level():
        v = torch.randperm(4 * n, generator=g)[:n].sort().values
        return v.to(device=device, dtype=torch.int32)

    zero = torch.zeros(1, dtype=torch.int32, device=device)
    probes = tuple((level(), zero, torch.full_like(zero, n))
                   for _ in range(n_probes + 1))
    return (zero, zero, torch.tensor(n, dtype=torch.int32, device=device),
            probes[0][0], probes[1:], (None,) * (n_probes + 1), sr)


def fold_cases(args, fill_ops, plain, time_stats, torch):
    """``frontier_fold`` on cases built from the captured call's own
    arguments: (a) the call as it is; (b) the same arrays with no
    candidate (the cost of the capacity alone); (c) the per-row arrays
    cut to the live prefix, the rows up to the last with a candidate
    (the cost of the candidates alone); (d) case (c) with only the first
    probe (the share of the searches); (e) one hub row
    (:func:`hub_case`) with as many probes, and (f) with two if the call
    has not two.  Each held against the plain
    version, two launches equal, timed (CUDA events, L2 flushed, median
    of 5): printed lines, not table rows.  Returns each case's ms by its
    letter."""
    lo0, offs, total, seed, probes, anns, sr = args
    live = torch.nonzero(fold_counts(args, torch)).flatten()
    cut = int(live[-1]) + 1 if live.numel() else 1
    cut_probes = tuple((v, lo[:cut], hi[:cut]) for v, lo, hi in probes)
    hub = hub_case(len(probes), sr, seed.device, torch)
    cases = (
        ("(a) the captured call", args),
        ("(b) no candidate", (lo0, torch.zeros_like(offs),
                              torch.zeros_like(total), seed, probes, anns,
                              sr)),
        ("(c) live prefix", (lo0[:cut], offs[:cut], total, seed, cut_probes,
                             anns, sr)),
        ("(d) live prefix, one probe", (lo0[:cut], offs[:cut], total, seed,
                                        cut_probes[:1], anns[:2], sr)),
        ("(e) one hub row", hub))
    if len(probes) != 2:  # the search loop of two probes in lockstep too
        cases += (("(f) one hub row, two probes",
                   hub_case(2, sr, seed.device, torch)),)
    times = {}
    for label, case in cases:
        if label.startswith("(d)") and not probes:
            continue
        got = fill_ops.fold(*case)
        check(fold_equal(got, plain(*case), sr, torch),
              f"frontier_fold, {label}: differs from its plain version")
        again = fill_ops.fold(*case)
        check(all(torch.equal(x, y) for x, y in zip(got, again)),
              f"frontier_fold, {label}: two launches differ")
        ms = time_stats(lambda: fill_ops.fold(*case), 5)[0]
        times[label[1]] = ms
        cands, moved, ops = fold_work(case, torch)
        log(f"[kernel] frontier_fold, {label}: rows={int(case[0].shape[0])} "
            f"live_rows={int((fold_counts(case, torch) > 0).sum())} "
            f"candidates={cands} probes={len(case[4])} semiring={sr.name}; "
            f"equal to the plain "
            f"version, two launches equal; kernel {ms:.4f} ms (CUDA events, "
            f"L2 flushed, median of 5), bound "
            f"{max(moved / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S) * 1e3:.4f}"
            f" ms (bytes {moved / HBM_BYTES_PER_S * 1e3:.4f} ms, {moved} "
            f"bytes; operations {ops / INT32_OPS_PER_S * 1e3:.4f} ms)")
    return times


def fill_hub_case(device, torch, n=1_000_000):
    """``frontier_fill`` over one hub row: ``cap_in = 1``, ``n`` sorted
    distinct candidates and one probe segment of ``n`` values
    (:func:`hub_case`'s levels), every slot live."""
    lo0, offs, total, seed, probes, _anns, _sr = hub_case(1, None, device,
                                                          torch, n)
    return total, offs, lo0, seed, probes, 0, n


def fill_cases(args, fill_ops, plain, time_stats, flat, torch):
    """``frontier_fill`` on cases built from the captured call's own
    arguments: (a) the call as it is; (b) ``total_c = 0`` (the masked
    tail alone); (c) ``n = total_c`` (the live slots alone); (d) case (c)
    with no probe (row finding, the seed gather and the writes); (e) one
    hub row (:func:`fill_hub_case`); (f) the call launched bare, through
    the C entry into outputs allocated beforehand, beside the wrapper's
    and the bare launch's host time a call and the L2 flush's device
    time.  Each held bit for bit against the plain version, two launches
    equal, timed (CUDA events, L2 flushed, median, min and max of 20;
    (f) also without the card held): printed lines, not table rows.  Then
    a line each for the call's rows, its outputs zeroed by PyTorch, and
    the extension's compaction (``core.backend._compact``) on case (a)'s
    outputs."""
    from repro_torch.core.backend import _compact
    total_c, offs, lo0, seed, probes, start, n = args
    dev = offs.device
    live = max(0, min(int(total_c), start + n) - start)
    cases = (
        ("(a) the captured call", args),
        ("(b) total_c = 0, the masked tail alone",
         (torch.zeros_like(total_c),) + args[1:]),
        ("(c) n = total_c, the live slots alone", args[:6] + (live,)),
        ("(d) the live slots alone, no probe",
         args[:4] + ((), start, live)),
        ("(e) one hub row", fill_hub_case(dev, torch)))

    def shape(case):
        tc, of, _lo0, sd, pr, st, nn = case
        return (f"slots={nn} live={max(0, min(int(tc), st + nn) - st)} "
                f"cap_in={int(of.shape[0])} n0={int(sd.shape[0])} "
                f"probes={len(pr)} start={st}")

    def stats(ms):
        return (f"{ms[0]:.4f} ms (min {ms[1]:.4f}, max {ms[2]:.4f}; median "
                f"of 20)")

    got_a = None
    for label, case in cases:
        got = flat("frontier_fill", fill_ops.fill(*case))
        want = flat("frontier_fill", plain(*case))
        check(all(torch.equal(x, y) for x, y in zip(got, want)),
              f"frontier_fill, {label}: differs from its plain version")
        again = flat("frontier_fill", fill_ops.fill(*case))
        check(all(torch.equal(x, y) for x, y in zip(got, again)),
              f"frontier_fill, {label}: two launches differ")
        got_a = got if got_a is None else got_a
        ms = time_stats(lambda: fill_ops.fill(*case), 20)
        log(f"[kernel] frontier_fill, {label}: {shape(case)}; bit-equal to "
            f"the plain version, two launches equal; kernel {stats(ms)}")

    # the call's rows: candidates a live row, each probe's segment a row
    rows = got_a[1][:live].long()
    per_row = torch.bincount(rows, minlength=int(offs.shape[0]))
    used = per_row > 0

    def pct(x):
        x = x.float()
        return "/".join(str(int(torch.quantile(x, q))) for q in (0.5, 0.9)) + \
            f"/{int(x.max())}"

    segs = "; ".join(f"probe {k}: {int(v.shape[0])} values, segments "
                     f"{pct((hi - lo)[used])}"
                     for k, (v, lo, hi) in enumerate(probes))
    log(f"[kernel] frontier_fill, the captured call's rows: {int(used.sum())}"
        f" of {int(offs.shape[0])} hold slots, {pct(per_row[used])} slots a "
        f"row (50th/90th percentile/max); {segs}")

    outs = fill_ops._outputs(len(probes), n, dev)
    check(fill_ops._launch(*args, outs) == 0, "frontier_fill: bare launch "
                                              "failed")
    bare = outs[:4] + tuple(outs[4])
    check(all(torch.equal(x, y) for x, y in zip(bare, got_a)),
          "frontier_fill, (f): the bare launch differs from (a)")
    ms = time_stats(lambda: fill_ops._launch(*args, outs), 20)
    unheld = time_stats(lambda: fill_ops._launch(*args, outs), 20,
                        hold=False)

    def host_us(fn, calls=200):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        wall = time.perf_counter() - t0
        torch.cuda.synchronize()
        return wall / calls * 1e6

    wrapper_us = host_us(lambda: fill_ops.fill(*args))
    bare_us = host_us(lambda: fill_ops._launch(*args, outs))
    buf = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    flush_ms = time_stats(buf.zero_, 20)
    del buf
    log(f"[kernel] frontier_fill, (f) the call launched bare (C entry, "
        f"outputs allocated beforehand, no checks): {shape(args)}; equal to "
        f"(a); kernel {stats(ms)}, card not held {stats(unheld)}; host time "
        f"a call (perf_counter over 200 "
        f"calls): the wrapper {wrapper_us:.1f} us, the bare launch "
        f"{bare_us:.1f} us; the L2 flush before each timed run, timed "
        f"alone, {flush_ms[0]:.4f} ms on the card (min {flush_ms[1]:.4f})")

    # the floor of the call's writes under this timing: its outputs zeroed
    # by PyTorch (one launch an output)
    out_bytes = sum(x.numel() * x.element_size() for x in bare)
    ms = time_stats(lambda: [x.zero_() for x in outs[:4] + outs[4:]], 20)
    log(f"[kernel] frontier_fill, the call's {out_bytes} output bytes zeroed "
        f"by torch.Tensor.zero_ ({4 + (len(probes) > 0)} launches): "
        f"{stats(ms)}; at the memory rate "
        f"{out_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms")

    keep, xs = got_a[3], got_a[:3] + got_a[4:]
    new_count, _ = _compact(keep, xs, n)
    ms = time_stats(lambda: _compact(keep, xs, n), 20)
    moved = n + 2 * sum(x.numel() * x.element_size() for x in xs)
    log(f"[kernel] extension compaction (core.backend._compact) on (a)'s "
        f"outputs: {n} slots, {int(new_count)} kept, {len(xs)} columns; "
        f"{stats(ms)}; its bytes (keep and the columns read, the columns "
        f"written) {moved}, {moved / HBM_BYTES_PER_S * 1e3:.4f} ms at the "
        f"memory rate")


def pair_count_work(args, torch):
    """What one ``bitset_pair_count`` call needs: its set pairs P, the
    ids of both lists of every pair (the merge steps), the matched block
    pairs, the slots it touches and their blocks, and the runs of
    consecutive pairs that share ``a`` and ``b``; its bytes (the slot
    ids and the count of each pair, two offsets a touched slot, each
    touched block's id and 32-byte row once) and its int32 operations (a
    merge step an id, an AND, a popcount and an add a word of each
    matched block)."""
    from repro_torch.kernels.bitset_intersect.ref import match_blocks_ref
    offs, bids, words, sa, sb = args
    off = offs.long()
    lens = off[1:] - off[:-1]
    p = int(sa.shape[0])
    ids = int((lens[sa.long()] + lens[sb.long()]).sum())
    matched = int(match_blocks_ref(offs, bids, sa, sb)[0].numel())
    slots = torch.unique(torch.cat([sa, sb])).long()
    touched = int(lens[slots].sum())
    w = int(words.shape[1])
    moved = 12 * p + 8 * int(slots.numel()) + (4 + 4 * w) * touched
    ops = ids + 3 * w * matched
    runs_a = int((sa[1:] != sa[:-1]).sum()) + min(p, 1)
    runs_b = int((sb[1:] != sb[:-1]).sum()) + min(p, 1)
    return (f"set_pairs={p} ids={ids} matched_blocks={matched} "
            f"touched_slots={int(slots.numel())} touched_blocks={touched} "
            f"runs_of_a={runs_a} runs_of_b={runs_b}", moved, ops)


def pair_count_cases(args, bitset_ops, plain, time_stats, torch):
    """``bitset_pair_count`` on cases built from the captured call: (a)
    the call as it is; (b) the same set pairs in a seeded shuffled order,
    so that no run of pairs shares a set (what the grouping buys); (c)
    the matched-pair kernel ``bitset_and_popcount`` on the call's matched
    block pairs, expanded on the card by the plain block matching (the
    route's kernel before the fused one); (d) that route's host wall for
    the call, as the engine ran it (``intersect.bitset_intersect_count``:
    host block matching with one search on the card, the uploads, the
    matched-pair kernel, the fetch of its per-block counts and their
    ``np.add.at``), one reading; (e) the dense set with the most blocks
    against every dense slot; (f) the call's block matching alone: the
    same pairs on a zero-width view of the rows, so no row is read and
    every count is 0; (g) a hub whose 15,625 blocks (n = 4,000,000 ids)
    span two slices of the kernel's staging, against 63 seeded sets on
    either side and itself; (h) the call through the kernel's any-width
    instance, on a copy of the table 4 bytes off 16-byte alignment.  Each
    equal to the plain version, the
    kernels' two launches equal, timed (CUDA events, L2 flushed, median
    of 20): printed lines, not table rows."""
    import types

    import numpy as np

    from repro_torch.core import intersect as I
    from repro_torch.kernels.bitset_intersect.ref import match_blocks_ref
    from repro_torch.kernels.common import host_get
    offs, bids, words, sa, sb = args
    want = plain(*args)

    def fused(label, case, want_case=None):
        got = bitset_ops.bitset_pair_count(*case)
        check(torch.equal(got, plain(*case) if want_case is None
                          else want_case),
              f"bitset_pair_count, {label}: differs from its plain version")
        check(torch.equal(got, bitset_ops.bitset_pair_count(*case)),
              f"bitset_pair_count, {label}: two launches differ")
        ms = time_stats(lambda: bitset_ops.bitset_pair_count(*case), 20)[0]
        work, moved, ops = pair_count_work(case, torch)
        log(f"[kernel] bitset_pair_count, {label}: {work}; equal to the "
            f"plain version, two launches equal; kernel {ms:.4f} ms (CUDA "
            f"events, L2 flushed, median of 20), bound "
            f"{max(moved / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S) * 1e3:.4f}"
            f" ms (bytes {moved / HBM_BYTES_PER_S * 1e3:.4f}, operations "
            f"{ops / INT32_OPS_PER_S * 1e3:.4f})")

    fused("(a) the captured call", args, want_case=want)
    perm = torch.randperm(int(sa.shape[0]),
                          generator=torch.Generator().manual_seed(0)
                          ).to(sa.device)
    fused("(b) shuffled", (offs, bids, words, sa[perm], sb[perm]),
          want_case=want[perm])
    pid, pos_a, pos_b = match_blocks_ref(offs, bids, sa, sb)
    pa, pb = pos_a.to(torch.int32), pos_b.to(torch.int32)
    per_block = bitset_ops.bitset_and_popcount(words, pa, pb)
    summed = torch.zeros(int(sa.shape[0]), dtype=torch.int64,
                         device=sa.device).index_add_(0, pid, per_block.long())
    check(torch.equal(summed.to(torch.int32), want),
          "bitset_and_popcount on the matched blocks: other counts")
    check(torch.equal(per_block, bitset_ops.bitset_and_popcount(words, pa, pb)),
          "bitset_and_popcount: two launches differ")
    ms = time_stats(lambda: bitset_ops.bitset_and_popcount(words, pa, pb),
                    20)[0]
    moved = (int(torch.unique(torch.cat([pa, pb])).numel()) * 4
             * int(words.shape[1]) + 12 * int(pa.shape[0]))
    log(f"[kernel] bitset_pair_count, (c) the matched-pair kernel "
        f"bitset_and_popcount on the call's {int(pa.shape[0])} matched "
        f"block pairs: equal after the sum per set pair, two launches "
        f"equal; kernel {ms:.4f} ms (CUDA events, L2 flushed, median of "
        f"20), bound {moved / HBM_BYTES_PER_S * 1e3:.4f} ms (bytes)")
    del pid, pos_a, pos_b, pa, pb, per_block, summed
    host = types.SimpleNamespace(offsets=host_get(offs).astype(np.int64),
                                 block_ids=host_get(bids))
    a_h, b_h = host_get(sa).astype(np.int64), host_get(sb).astype(np.int64)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    old = I.bitset_intersect_count(host, a_h, b_h,
                                   bitset_ops.bitset_and_popcount, bids,
                                   words)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(np.array_equal(old, host_get(want).astype(np.int64)),
          "the matched-pair route gives other counts")
    log(f"[kernel] bitset_pair_count, (d) the matched-pair route's host "
        f"wall for the call (block matching, uploads, kernel, fetch, "
        f"np.add.at): {wall:.4f} s (host clock, one reading)")
    every = torch.arange(int(offs.shape[0]) - 1, dtype=torch.int32,
                         device=sa.device)
    hub = int(torch.argmax(offs[1:] - offs[:-1]))
    fused("(e) the largest set against every slot",
          (offs, bids, words, torch.full_like(every, hub), every))
    fused("(f) the block matching alone (zero-width rows)",
          (offs, bids, words[:, :0], sa, sb))
    fused("(g) a hub beyond the staging", hub_pair_case(sa.device, torch))
    shifted = torch.empty(words.numel() + 1, dtype=words.dtype,
                          device=words.device)
    shifted[1:].copy_(words.reshape(-1))
    fused("(h) the any-width instance (the table 4 bytes off alignment)",
          (offs, bids, shifted[1:].view(words.shape), sa, sb), want_case=want)
    del shifted


def hub_pair_case(dev, torch):
    """``bitset_pair_count``'s arguments for a hub with an id in every one
    of the 15,625 blocks of n = 4,000,000 ids (and 100,000 more seeded
    ids), against 63 seeded sets of up to 20,000 ids on either side and
    against itself."""
    import numpy as np

    from repro_torch.core.intersect import build_blocked_bitset
    r = np.random.default_rng(0)
    n = 4_000_000
    hub = np.unique(np.concatenate([np.arange(0, n, 256),
                                    r.choice(n, 100_000, replace=False)]))
    sets = [hub] + [np.sort(r.choice(m, size=int(r.integers(1, 20_000)),
                                     replace=False))
                    for m in [n] * 40 + [1_000_000] * 23]
    offs = np.concatenate([[0], np.cumsum([len(x) for x in sets])])
    bs = build_blocked_bitset(offs, np.concatenate(sets).astype(np.int32),
                              np.arange(len(sets)), n)
    k = len(sets)
    a = np.concatenate([np.zeros(k, np.int64), np.arange(k), [0]])
    b = np.concatenate([np.arange(k), np.zeros(k, np.int64), [0]])

    def t32(x):
        return torch.as_tensor(np.ascontiguousarray(x, dtype=np.int32),
                               device=dev)
    return (t32(bs.offsets), t32(bs.block_ids),
            t32(bs.words.view(np.int32)), t32(a), t32(b))


def uint_work(args, torch):
    """What one ``intersect_count_csr`` call needs, and its shape: its
    bytes (each endpoint's row and two offsets once, ``u``, ``v`` and
    the counts) and its int32 operations (a binary search of the larger
    set, ceil(log2(|large| + 1)) steps of 4 operations, for every
    element of the smaller)."""
    offs, nbr, u, v = args
    p = int(u.shape[0])
    ends = torch.unique(torch.cat([u, v])).long()
    offs64 = offs.long()
    deg = offs64[ends + 1] - offs64[ends]
    du = offs64[u.long() + 1] - offs64[u.long()]
    dv = offs64[v.long() + 1] - offs64[v.long()]
    small, large = torch.minimum(du, dv), torch.maximum(du, dv)
    moved = int(deg.sum()) * 4 + int(ends.numel()) * 8 + 12 * p
    ops = int((small * torch.log2(large.float() + 1).ceil()
               .long()).sum()) * 4
    shape = f"pairs={p} endpoints={int(ends.numel())}"
    if p:
        q = torch.tensor([0.5, 0.9, 0.99], dtype=torch.float64,
                         device=u.device)

        def pct(x):
            return "/".join(str(int(t)) for t in torch.quantile(
                x.double(), q, interpolation="lower").tolist()) + \
                f"/{int(x.max())}"
        runs_u = int((u[1:] != u[:-1]).sum()) + 1
        runs_v = int((v[1:] != v[:-1]).sum()) + 1
        shape += (f" runs_of_u={runs_u} runs_of_v={runs_v} smaller_set "
                  f"p50/p90/p99/max={pct(small)} larger_set "
                  f"p50/p90/p99/max={pct(large)} probes={int(small.sum())}"
                  f" u_smaller={float((du <= dv).double().mean()):.4f}; "
                  f"rows read through L2, sum(|a|+|b|)*4 = "
                  f"{int((du + dv).sum()) * 4} bytes "
                  f"({int((du + dv).sum()) * 4 / HBM_BYTES_PER_S * 1e3:.4f}"
                  f" ms at the memory rate) beside the bound's {moved}")
    return shape, moved, ops


def uint_sets_case(dev, torch, n_pairs=65_536, size=256, universe=4096):
    """The routing cap's worst case: ``n_pairs`` pairs of distinct rows,
    each a sorted set of exactly ``size`` values drawn from
    ``universe``, made on the card from a seed; the pairs in a seeded
    order, so no two consecutive pairs share a row."""
    g = torch.Generator(device=dev).manual_seed(4)
    rows = []
    for _ in range(2 * n_pairs // 8192):
        keys = torch.rand(8192, universe, generator=g, device=dev)
        rows.append(keys.topk(size, dim=1).indices.sort(dim=1).values
                    .to(torch.int32))
    nbr = torch.cat(rows).reshape(-1)
    offs = torch.arange(0, nbr.numel() + 1, size, dtype=torch.int32,
                        device=dev)
    perm = torch.randperm(2 * n_pairs, generator=g, device=dev).to(
        torch.int32)
    return offs, nbr, perm[:n_pairs].contiguous(), perm[n_pairs:].contiguous()


def uint_skew_case(sets, n_pairs, dev, torch, universe=4096):
    """The skew the routing cap allows: ``n_pairs`` pairs of a 1-element
    set against one of the 256-element sets of ``sets`` (case (d)'s
    rows), the 1-element set on a seeded side of each pair; values and
    pairs from a seed on the card."""
    offs, nbr, _, _ = sets
    g = torch.Generator(device=dev).manual_seed(5)
    n_big = int(offs.shape[0]) - 1
    ones = torch.randint(0, universe, (n_pairs,), generator=g, device=dev,
                         dtype=torch.int32)
    nbr2 = torch.cat([nbr, ones])
    tail = torch.arange(1, n_pairs + 1, dtype=torch.int32,
                        device=dev) + int(nbr.numel())
    offs2 = torch.cat([offs, tail])
    big = torch.randint(0, n_big, (n_pairs,), generator=g, device=dev,
                        dtype=torch.int32)
    one = torch.arange(n_big, n_big + n_pairs, dtype=torch.int32,
                       device=dev)
    flip = torch.rand(n_pairs, generator=g, device=dev) < 0.5
    return (offs2, nbr2, torch.where(flip, one, big).contiguous(),
            torch.where(flip, big, one).contiguous())


def uint_cases(args, uint_ops, plain, time_stats, torch):
    """``intersect_count_csr`` on cases built from the captured call or
    from a seed on the card: (a) the call as it is; (b) its pairs in a
    seeded shuffled order, so no run of pairs shares ``v`` (what reuse
    of the shared row buys); (c) ``u`` and ``v`` swapped in every pair,
    so the runs share ``u``; (d) the routing cap's worst case, 65,536
    pairs of sorted 256-element sets from a universe of 4,096; (e) the
    skew the cap allows, as many pairs as the call of a 1-element set
    against a 256-element one, both orders mixed; (f) the call's pairs
    on offsets that are all 0, so every set is empty: the pairs' loads
    and the batches' bookkeeping alone, no row copied or searched.  Each
    bit-equal to the plain version, two launches equal, timed (CUDA
    events, L2 flushed, median of 20): printed lines, not table rows."""
    from repro_torch.kernels import common
    offs, nbr, u, v = args
    want = plain(*args)

    def run(label, case, want_case=None):
        before = common.LAUNCHES["uint_intersect"]
        got = uint_ops.intersect_count_csr(*case)
        check(common.LAUNCHES["uint_intersect"] == before + 1,
              f"intersect_count_csr, {label}: not one launch a call")
        check(torch.equal(got, plain(*case) if want_case is None
                          else want_case),
              f"intersect_count_csr, {label}: differs from its plain "
              "version")
        check(torch.equal(got, uint_ops.intersect_count_csr(*case)),
              f"intersect_count_csr, {label}: two launches differ")
        ms = time_stats(lambda: uint_ops.intersect_count_csr(*case), 20)[0]
        work, moved, ops = uint_work(case, torch)
        log(f"[kernel] intersect_count_csr, {label}: {work}; equal to the "
            f"plain version, one launch a call, two launches equal; kernel "
            f"{ms:.4f} ms (CUDA events, L2 flushed, median of 20), bound "
            f"{max(moved / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S) * 1e3:.4f}"
            f" ms (bytes {moved / HBM_BYTES_PER_S * 1e3:.4f}, operations "
            f"{ops / INT32_OPS_PER_S * 1e3:.4f})")

    run("(a) the captured call", args, want_case=want)
    perm = torch.randperm(int(u.shape[0]),
                          generator=torch.Generator().manual_seed(0)
                          ).to(u.device)
    run("(b) shuffled", (offs, nbr, u[perm], v[perm]), want_case=want[perm])
    run("(c) u and v swapped", (offs, nbr, v, u), want_case=want)
    sets = uint_sets_case(u.device, torch)
    run("(d) 65,536 pairs of 256-element sets", sets)
    run("(e) 1 against 256, both orders",
        uint_skew_case(sets, int(u.shape[0]), u.device, torch))
    run("(f) the pairs alone (every set empty)",
        (torch.zeros_like(offs), nbr, u, v))


def ptxas_lines(report):
    """One line for each entry function of an ``nvcc -Xptxas=-v``
    report: its (demangled) name, registers, stack frame and spills."""
    import re
    import shutil
    rows, name = {}, None
    for line in report.splitlines():
        m = re.search(r"(?:entry function|Function properties for) '?([\w$]+)",
                      line)
        if m:
            name = m.group(1)
            rows.setdefault(name, [])
        elif name and ("registers" in line or "stack frame" in line):
            rows[name].append(line.split(":", 1)[-1].strip()
                              if "registers" in line else line.strip())
    names = list(rows)
    if names and shutil.which("c++filt"):
        out = subprocess.run(["c++filt"], input="\n".join(names),
                             capture_output=True, text=True, timeout=60)
        if out.returncode == 0 and len(out.stdout.splitlines()) == len(names):
            names = out.stdout.splitlines()
    return [f"{shown}: {'; '.join(rows[raw])}"
            for shown, raw in zip(names, rows)]


def warm_wall(fn, torch, reps=FM_REPS):
    """Median host wall of ``reps`` calls of ``fn``, each ending in
    ``torch.cuda.synchronize()``, after one untimed call."""
    import numpy as np
    fn()
    torch.cuda.synchronize()
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return float(np.median(walls))


def recsys_path(torch):
    """Phase 7: FM serving at full width on the card.  Returns the launch
    counts of this path."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_arch
    from repro_torch.data import RecsysBatchGen
    from repro_torch.kernels import common
    from repro_torch.kernels.fm_interaction.ref import \
        fm_interaction_pairwise_ref
    from repro_torch.models.recsys import fm
    from repro_torch.serve import batched_scores

    t_phase = time.perf_counter()
    arch = get_arch("fm")
    cfg = arch.config
    p99 = arch.shape("serve_p99").params["batch"]
    bulk = arch.shape("serve_bulk").params["batch"]
    n_cand = arch.shape("retrieval_cand").params["n_candidates"]
    t0 = time.perf_counter()
    batches = {b: RecsysBatchGen(cfg.n_sparse, cfg.vocab_per_field, b,
                                 seed=0).batch_at(0) for b in (p99, bulk)}
    r = np.random.default_rng(0)
    users = r.integers(0, cfg.total_rows, FM_USERS).astype(np.int32)
    cands = r.integers(0, cfg.total_rows, n_cand).astype(np.int32)
    log(f"[recsys] batches of {p99} and {bulk} rows and {n_cand} "
        f"candidates made in {time.perf_counter() - t0:.2f} s")
    common.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = fm.init(cfg, torch.Generator("cuda").manual_seed(0))
    torch.cuda.synchronize()
    log(f"[recsys] fm init: emb {tuple(params['emb'].shape)} "
        f"{params['emb'].dtype}, {cfg.param_count()} parameters "
        f"({cfg.param_count() * 4} bytes) in "
        f"{time.perf_counter() - t0:.2f} s")

    logits = {}
    for b, batch in batches.items():
        on_card = {"ids": torch.as_tensor(batch["ids"], device="cuda")}
        host_s = warm_wall(lambda: fm.forward(params, batch, cfg), torch)
        card_s = warm_wall(lambda: fm.forward(params, on_card, cfg), torch)
        logits[b] = fm.forward(params, on_card, cfg)
        log(f"[recsys] forward B={b}: warm {card_s} s with the ids on the "
            f"card ({b / card_s:.0f} rows/s), {host_s} s from the host "
            f"batch with its upload ({b / host_s:.0f} rows/s); median of "
            f"{FM_REPS}")
    ids = torch.as_tensor(batches[bulk]["ids"], device="cuda")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fm.forward(params, {"ids": ids}, cfg)
        torch.cuda.synchronize()
    events = device_events(prof, torch)
    device_us = sum(e[0] for e in events)
    log(f"[recsys] profile of one forward B={bulk}: device busy "
        f"{device_us / 1e3:.4f} ms")
    for us, count, key in events[:8]:
        log(f"[recsys] device {us / 1e3:.4f} ms "
            f"({100 * us / device_us:.1f}%) x{count} {key[:90]}")

    t0 = time.perf_counter()
    chunked = batched_scores(lambda c: fm.forward(params, c, cfg),
                             {"ids": ids}, p99)
    chunk_s = time.perf_counter() - t0
    one = logits[bulk].cpu().numpy()
    same = bool(np.array_equal(chunked, one))
    log(f"[recsys] batched_scores: {bulk} rows in chunks of {p99} in "
        f"{chunk_s} s ({bulk / chunk_s:.0f} rows/s); "
        f"{'bit-equal to' if same else 'differs from'} the one-call "
        f"forward (max |diff| {float(np.abs(chunked - one).max())})")
    check(np.allclose(chunked, one, rtol=FM_RTOL, atol=FM_ATOL),
          "batched_scores differs from the one-call forward")

    users_t = torch.as_tensor(users, device="cuda")
    cands_t = torch.as_tensor(cands, device="cuda")
    ret_s = warm_wall(
        lambda: fm.retrieval_scores(params, users_t, cands_t, cfg), torch)
    scores = fm.retrieval_scores(params, users_t, cands_t, cfg)
    log(f"[recsys] retrieval_scores: {FM_USERS} user rows x {n_cand} "
        f"candidates, warm {ret_s} s ({n_cand / ret_s:.0f} candidates/s)")

    # float64 oracle on the card: every p99 row and FM_ORACLE_ROWS rows of
    # the bulk batch, the interaction by the pairwise O(F^2) form
    emb, w_lin = params["emb"], params["w_lin"]
    base = torch.arange(cfg.n_sparse, device="cuda") * cfg.vocab_per_field
    sample = {p99: np.arange(p99),
              bulk: np.sort(np.random.default_rng(1).choice(
                  bulk, FM_ORACLE_ROWS, replace=False))}
    for b, rows in sample.items():
        got = logits[b]
        check(got.shape == (b,) and got.dtype == torch.float32,
              f"forward B={b} gave {tuple(got.shape)} {got.dtype}")
        check(bool(torch.isfinite(got).all()),
              f"forward B={b} gave a value that is not finite")
        g = torch.as_tensor(batches[b]["ids"][rows], device="cuda").long() \
            + base
        want = (params["w0"].double() + w_lin[g].double().sum(dim=1)
                + fm_interaction_pairwise_ref(emb[g].double()))
        got = got[torch.as_tensor(rows, device="cuda")].double()
        err = float((got - want).abs().max())
        log(f"[recsys] forward B={b}: {len(rows)} rows against the float64 "
            f"oracle, max |err| {err}, logits in "
            f"[{float(want.min())}, {float(want.max())}]")
        check(torch.allclose(got, want, rtol=FM_RTOL, atol=FM_ATOL),
              f"forward B={b} differs from the float64 oracle")
    c64 = emb[cands_t.long()].double()
    want = c64 @ emb[users_t.long()].double().sum(dim=0) \
        + w_lin[cands_t.long()].double()
    err = float((scores.double() - want).abs().max())
    log(f"[recsys] retrieval against the float64 oracle: max |err| {err}")
    check(bool(torch.isfinite(scores).all()) and scores.shape == (n_cand,),
          "retrieval scores not finite or of the wrong shape")
    check(torch.allclose(scores.double(), want, rtol=FM_RTOL, atol=FM_ATOL),
          "retrieval scores differ from the float64 oracle")
    launches = dict(common.LAUNCHES)
    log(f"[recsys] phase {time.perf_counter() - t_phase:.2f} s; peak "
        f"device memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} "
        f"GiB; launches {json.dumps(launches)}")
    return launches


def same_exact(got, want):
    """Two query results equal as they are: variables, every column in
    order, the annotation."""
    import numpy as np
    if got.vars != want.vars:
        return False
    if any(not np.array_equal(np.asarray(got.columns[v]),
                              np.asarray(want.columns[v]))
           for v in got.vars):
        return False
    if want.annotation is None:
        return got.annotation is None
    return got.annotation is not None and np.array_equal(
        np.asarray(got.annotation), np.asarray(want.annotation))


def shown(res):
    return f"{res.num_rows} rows" if res.vars else str(int(res.scalar()))


def serving_path(src, dst, g, torch):
    """Phase 8, the relational serving path: a ``QueryServer`` on the card
    with the full-size graph as tenant ``full``; ``triangle_at`` and
    ``triangle_list_at`` prepared, run one binding at a time over the
    ``SERVE_BINDINGS`` highest-degree vertices (cold, warm, p50/p99; no
    plan search after warm-up), then the same bindings through
    ``run_batch`` and through ``submit`` + ``drain``, every answer equal
    to the sequential one and ``SERVE_HOST_BINDINGS`` of them to the host
    oracle; the batched fill and fold launch once a batched step and
    chunk.  Then a second tenant, ``powerlaw_graph(2000, 12, 2.0)``,
    under a byte budget below the two tenants' model bytes:
    ``4clique_at`` batches, ``lollipop_at`` takes the sequential loop,
    the full tenant is evicted and its re-query equals its first answer,
    and ``check_store`` holds the model against the live bytes.  Returns
    the phase's kernel launches and the captures of the batched fill and
    fold (and, as ``frontier_fold_batched.small``, of the second tenant's
    batched fold)."""
    import numpy as np
    from repro_torch.analysis.memory_budget import (check_store,
                                                    trie_device_bytes)
    from repro_torch.core.engine import Engine
    from repro_torch.core.executor import BagResultCache
    from repro_torch.data.graphs import edge_list, powerlaw_graph
    from repro_torch.kernels import common
    from repro_torch.kernels.frontier_fill import ops as fill_ops
    from repro_torch.serve import QueryServer

    t_phase = time.perf_counter()
    srv = QueryServer()
    stats = srv.backend.stats
    full = srv.load_graph("full", "R", src, dst)
    for al in SERVE_ALIASES:
        srv.alias("full", al, "R")
    hubs = [int(v) for v in np.argsort(g.degrees)[::-1][:SERVE_BINDINGS]]
    log(f"[serve] tenant full: powerlaw_graph{FULL_GRAPH}, {len(src)} "
        f"edges; bindings: the {len(hubs)} highest-degree vertices "
        f"(degrees {int(g.degrees[hubs[0]])} .. "
        f"{int(g.degrees[hubs[-1]])})")
    host = Engine(backend="numpy")
    host.load_edges("R", src, dst)
    for al in SERVE_ALIASES:
        host.alias(al, "R")
    captures = {
        "frontier_fill_batched": Capture(
            fill_ops, "fill_batched", lambda t, o, *a: o.shape[0] * a[-1],
            copy=True),
        "frontier_fold_batched": Capture(
            fill_ops, "fold_batched", lambda lo0, *a: lo0.numel(),
            copy=True),
    }
    common.reset_launches()

    def launched():
        return dict(common.LAUNCHES)

    def delta(before, after):
        return {k: after.get(k, 0) - before.get(k, 0) for k in after
                if after.get(k, 0) != before.get(k, 0)}

    def batch_checks(name, d, ld, seq, batched, label):
        check(len(batched) == len(seq) and all(
            same_exact(b, s) for b, s in zip(batched, seq)),
            f"{name} ({label}): a batched answer differs from the "
            "sequential one")
        if not d.get("pipeline.batched_launches"):
            return False
        # nothing fell back: every launch of this call was batched, each
        # batched step one launch of its kernel
        check(d.get("pipeline.launches", 0) == d["pipeline.batched_launches"]
              == d.get("extend.closing_syncs", 0),
              f"{name} ({label}): launches {d}")
        check(ld.get("frontier_fill_batched", 0)
              == d.get("extend.pipeline_extends", 0),
              f"{name} ({label}): {ld.get('frontier_fill_batched', 0)} "
              f"batched fills for {d.get('extend.pipeline_extends', 0)} "
              "batched extend steps")
        check(ld.get("frontier_fold_batched", 0)
              == d.get("pipeline.device_folds", 0),
              f"{name} ({label}): {ld.get('frontier_fold_batched', 0)} "
              f"batched folds for {d.get('pipeline.device_folds', 0)} "
              "batched fold steps")
        check(not ld.get("frontier_fill", 0) and not ld.get("frontier_fold",
                                                            0),
              f"{name} ({label}): single-query launches in a batch: {ld}")
        return True

    firsts, which = {}, {}
    for name in ("triangle_at", "triangle_list_at"):
        text = SERVE_QUERIES[name]
        pq = srv.prepare("full", text)
        eng = srv.engine("full")
        t0 = time.perf_counter()
        first = pq.run(hubs[0])
        torch.cuda.synchronize()
        cold = time.perf_counter() - t0
        eng.bag_cache = BagResultCache()
        t0 = time.perf_counter()
        warm_res = pq.run(hubs[0])
        torch.cuda.synchronize()
        warm = time.perf_counter() - t0
        check(same_exact(warm_res, first), f"{name}: warm run differs")
        firsts[name] = first
        searches = stats.get("compile.plan_searches", 0)
        eng.bag_cache = BagResultCache()
        lat, seq = [], []
        for v in hubs:
            t0 = time.perf_counter()
            seq.append(pq.run(v))
            torch.cuda.synchronize()
            lat.append(time.perf_counter() - t0)
        check(stats.get("compile.plan_searches", 0) == searches,
              f"{name}: a plan search after warm-up")
        p50, p99 = np.percentile(lat, [50, 99])
        log(f"[serve] {name} point queries: cold {cold:.4f} s, warm "
            f"{warm:.4f} s (binding {hubs[0]}: {shown(first)}); "
            f"{len(hubs)} bindings one at a time: p50 {p50:.4f} s, p99 "
            f"{p99:.4f} s, total {sum(lat):.3f} s; plan searches after "
            f"warm-up 0")

        s0, l0 = dict(stats), launched()
        t0 = time.perf_counter()
        batched = pq.run_batch(hubs)
        torch.cuda.synchronize()
        bwall = time.perf_counter() - t0
        d, ld = delta(s0, dict(stats)), delta(l0, launched())
        which[name] = batch_checks(name, d, ld, seq, batched, "run_batch")
        log(f"[serve] {name} run_batch of {len(hubs)}: {bwall:.4f} s "
            f"({len(hubs) / bwall:.1f} queries/s; one at a time "
            f"{len(hubs) / sum(lat):.1f}); batched={which[name]}; "
            f"counters {json.dumps(d, sort_keys=True)}; launches "
            f"{json.dumps(ld, sort_keys=True)}")

        s0, l0 = dict(stats), launched()
        t0 = time.perf_counter()
        tickets = [srv.submit("full", text, v) for v in hubs]
        srv.drain()
        torch.cuda.synchronize()
        dwall = time.perf_counter() - t0
        d, ld = delta(s0, dict(stats)), delta(l0, launched())
        check(all(t.done for t in tickets), f"{name}: a ticket not done")
        batch_checks(name, d, ld, seq, [t.result for t in tickets],
                     "submit + drain")
        log(f"[serve] {name} submit + drain of {len(hubs)}: {dwall:.4f} s; "
            f"counters {json.dumps(d, sort_keys=True)}")

        hq = host.prepare(text)
        t0 = time.perf_counter()
        spread = len(hubs) // SERVE_HOST_BINDINGS
        for v, res in list(zip(hubs, seq))[::spread]:
            want = hq.run(v)
            check(same_result(res, want),
                  f"{name} at {v}: {shown(res)} on the card, {shown(want)} "
                  "on the host")
        log(f"[serve] {name}: bindings {hubs[::spread]} equal to the host "
            f"oracle ({time.perf_counter() - t0:.1f} s), answers "
            f"{[shown(r) for r in seq[::spread]]}")
    check(which["triangle_at"], "triangle_at did not batch")
    del host

    # ---- a second tenant under a byte budget below both tenants' bytes
    full_bytes = trie_device_bytes(full)
    report = check_store(srv)
    log(f"[serve] check_store before the second tenant: "
        f"{json.dumps(report, sort_keys=True)}")
    srv.store.capacity_bytes = full_bytes
    g2 = powerlaw_graph(*SMALL_GRAPH, seed=0)
    s2, d2 = edge_list(g2)
    srv.load_graph("small", "R", s2, d2)
    for al in SERVE_ALIASES:
        srv.alias("small", al, "R")
    host2 = Engine(backend="numpy")
    host2.load_edges("R", s2, d2)
    for al in SERVE_ALIASES:
        host2.alias(al, "R")
    small_hubs = [int(v) for v in
                  np.argsort(g2.degrees)[::-1][:SERVE_SMALL_BINDINGS]]
    mem = {"before": torch.cuda.memory_allocated()}
    small_fold = Capture(fill_ops, "fold_batched",
                         lambda lo0, *a: lo0.numel(), copy=True)
    for name in ("4clique_at", "lollipop_at"):
        text = SERVE_QUERIES[name]
        s0, l0 = dict(stats), launched()
        tickets = [srv.submit("small", text, v) for v in small_hubs]
        srv.drain()
        torch.cuda.synchronize()
        if "after" not in mem:
            mem["after"] = torch.cuda.memory_allocated()
        d, ld = delta(s0, dict(stats)), delta(l0, launched())
        pq = srv.prepare("small", text)
        seq = [pq.run(v) for v in small_hubs]
        which[name] = batch_checks(name, d, ld, seq,
                                   [t.result for t in tickets],
                                   "submit + drain")
        hq = host2.prepare(text)
        for v, res in list(zip(small_hubs, seq))[:SERVE_HOST_BINDINGS]:
            check(same_result(res, hq.run(v)),
                  f"{name} at {v} on the small graph differs from the host")
        log(f"[serve] {name} on tenant small, {len(small_hubs)} bindings "
            f"through submit + drain: batched={which[name]}; equal to the "
            f"sequential answers and {SERVE_HOST_BINDINGS} to the host "
            f"({[shown(r) for r in seq[:SERVE_HOST_BINDINGS]]}); counters "
            f"{json.dumps(d, sort_keys=True)}")
    small_fold.restore()
    check(which["4clique_at"], "4clique_at did not batch on tenant small")
    check(not which["lollipop_at"], "lollipop_at batched")
    evictions = srv.counters.get("store.evictions", 0)
    check(evictions >= 1 and not srv.store.resident("full"),
          f"no eviction of tenant full under {full_bytes} bytes: "
          f"{srv.counters}")
    log(f"[serve] byte budget {full_bytes} (tenant full's model bytes): "
        f"tenant full evicted ({evictions} eviction(s)); "
        f"torch.cuda.memory_allocated {mem['before']} before the second "
        f"tenant's first drain, {mem['after']} after it "
        f"({mem['before'] - mem['after']} freed)")
    report = check_store(srv)
    again = srv.run("full", SERVE_QUERIES["triangle_at"], hubs[0])
    check(same_exact(again, firsts["triangle_at"]),
          "tenant full's re-query after its eviction differs")
    report2 = check_store(srv)
    log(f"[serve] re-query of tenant full after eviction: "
        f"{shown(again)}, equal to its first answer; store.evictions "
        f"{srv.counters.get('store.evictions', 0)}; check_store (model "
        f"against live) {json.dumps(report, sort_keys=True)}, after the "
        f"re-query {json.dumps(report2, sort_keys=True)}")
    launches = launched()
    for c in captures.values():
        c.restore()
    captures["frontier_fold_batched.small"] = small_fold
    summary = srv.dispatch_summary()
    log(f"[serve] batched: {json.dumps(which, sort_keys=True)}; launches "
        f"{json.dumps(launches, sort_keys=True)}")
    log(f"[serve] dispatch_summary {json.dumps(summary, sort_keys=True)}")
    log(f"[serve] phase {time.perf_counter() - t_phase:.1f} s")
    return launches, captures


def pattern_runs(eng, q, torch, runs=("cold", "warm")):
    """``q`` on ``eng`` once for each of ``runs`` (bag results emptied
    before each, as in phase 2).  Returns the count, each run's wall and
    the last run's dispatch-summary and launch deltas."""
    from repro_torch.core.executor import BagResultCache
    from repro_torch.kernels import common

    walls = {}
    for run in runs:
        eng.bag_cache = BagResultCache()
        before, launched0 = dict(eng.dispatch_summary()), dict(common.LAUNCHES)
        t0 = time.perf_counter()
        count = int(eng.query(q).scalar())
        torch.cuda.synchronize()
        walls[run] = time.perf_counter() - t0
    after = eng.dispatch_summary()
    delta = {k: after[k] - before.get(k, 0) for k in after
             if after[k] != before.get(k, 0)
             and not k.startswith("layout.threshold_bits")}
    launched = {k: n - launched0.get(k, 0) for k, n in common.LAUNCHES.items()
                if n != launched0.get(k, 0)}
    return count, walls, delta, launched


def route_counters(delta):
    return {k: v for k, v in sorted(delta.items())
            if k.startswith(("intersect.", "fold.", "pipeline.", "extend."))}


def check_route(mode, delta, launched, what):
    """The counters of one warm run show ``mode``'s route: the both-dense
    pairs through ``bitset_intersect`` in "set"; every pair on the uint
    route, through ``uint_intersect``, in "uint"; no pair route at all in
    "off", the fold on the card through ``frontier_fold`` with no
    per-extension host sync (so the pipeline, not the host chain, carried
    it)."""
    if mode == "set":
        check(delta.get("intersect.bitset_kernel", 0) > 0
              and launched.get("bitset_intersect", 0) > 0,
              f"{what}: no pair took the bitset kernel in mode set")
    elif mode == "uint":
        check(delta.get("intersect.uint_kernel", 0) > 0
              and launched.get("uint_intersect", 0) > 0,
              f"{what}: no pair took the uint kernel in mode uint")
        check(not any(k.startswith("intersect.bitset") for k in delta)
              and not launched.get("bitset_intersect"),
              f"{what}: a bitset route ran in mode uint")
    else:
        check("fold.pair_count_calls" not in delta
              and not any(k.startswith("intersect.") for k in delta),
              f"{what}: a pair route ran in mode off")
        check(launched.get("frontier_fold", 0) > 0
              and delta.get("pipeline.device_folds", 0) > 0
              and delta.get("extend.host_syncs", 0) == 0,
              f"{what}: mode off's fold did not run in the pipeline "
              f"({json.dumps(route_counters(delta))})")
        check(not launched.get("bitset_intersect")
              and not launched.get("uint_intersect"),
              f"{what}: a pair kernel launched in mode off")


def kron_pruned(scale):
    """``kronecker_graph(scale, KRON_EDGE_FACTOR, seed=0)`` degree-ordered
    and pruned, with a line of its statistics and each step's time."""
    from repro_torch.data.graphs import kronecker_graph
    from repro_torch.graph import (apply_ordering, graph_stats, order_nodes,
                                   prune_symmetric)

    t0 = time.perf_counter()
    kg = kronecker_graph(scale, KRON_EDGE_FACTOR, seed=0)
    t_gen = time.perf_counter() - t0
    t0 = time.perf_counter()
    kstats = graph_stats(kg)
    t_stats = time.perf_counter() - t0
    t0 = time.perf_counter()
    kh = apply_ordering(kg, order_nodes(kg, "degree"))
    t_order = time.perf_counter() - t0
    del kg
    t0 = time.perf_counter()
    kp = prune_symmetric(kh)
    t_prune = time.perf_counter() - t0
    return kp, (f"[prep] kronecker_graph({scale}, {KRON_EDGE_FACTOR}): "
                f"{json.dumps(kstats)}; generated in {t_gen:.2f} s, "
                f"graph_stats {t_stats:.2f} s, degree ordering {t_order:.2f} "
                f"s, prune_symmetric {t_prune:.2f} s; {kp.m} pruned edges, "
                f"largest pruned degree {int(kp.degrees.max())}")


def y_frontier_rows(p):
    """TRIANGLE_COUNT's y level on the pruned graph ``p``: the edges
    ``(x, y)`` whose ``y`` has an out-edge (``S(y, z)`` filters the
    extension sideways)."""
    return int((p.degrees[p.neighbors] > 0).sum())


def step_rows(eng, var):
    """The rows the engine's last query measured at ``var``'s level."""
    return next(step.get("actual_rows")
                for bag in eng.plan_metadata()[-1]["bags"]
                for step in bag["steps"] if step["var"] == var)


def kron_frontiers(scales):
    """``--kron-frontiers``: for each scale the degree-ordered, pruned
    Kronecker graph's line and its y frontier against the pipeline's
    buffer, on the host alone."""
    from repro_torch.core.statistics import PIPELINE_MAX_BUFFER

    for scale in scales:
        kp, line = kron_pruned(scale)
        log(f"{line}; y frontier {y_frontier_rows(kp)} rows, buffer "
            f"{PIPELINE_MAX_BUFFER}")
        del kp


def preprocessing_path(g, tc_full, torch):
    """Phase 8b, the preprocessing path: graph statistics, the seven node
    orderings of Appendix C.2.1, symmetric pruning and the three layout
    modes on the card.  ``g`` is the full-size graph and ``tc_full`` its
    TRIANGLE_COUNT from phase 2 (held against the host oracle in phase
    3).  Returns the phase's kernel launches, each held equal to its
    calls with work, and the captures of the largest ``uint_intersect``
    call of mode "uint" and ``frontier_fold`` call of mode "off"."""
    from repro_torch.core import layouts
    from repro_torch.core import statistics as stats_mod
    from repro_torch.core import workload as W
    from repro_torch.core.engine import Engine
    from repro_torch.data.graphs import edge_list, powerlaw_graph
    from repro_torch.graph import (ORDERINGS, apply_ordering, graph_stats,
                                   order_nodes, prune_symmetric)
    from repro_torch.kernels import common
    from repro_torch.kernels.bitset_intersect import ops as bitset_ops
    from repro_torch.kernels.frontier_fill import ops as fill_ops
    from repro_torch.kernels.uint_intersect import ops as uint_ops

    t_phase = time.perf_counter()

    def in_mode(m):
        return lambda n: n if layouts._ENGINE_LAYOUT_MODE == m else -1

    # every call with work of the path's kernels, then the two regimes'
    # largest calls (stacked on them, restored first)
    calls = {
        "frontier_fill": Capture(fill_ops, "fill", lambda *a: a[6]),
        # every fold call launches, rows or not
        "frontier_fold": Capture(fill_ops, "fold",
                                 lambda lo0, *a: int(lo0.shape[0]) + 1),
        "bitset_intersect": Capture(bitset_ops, "bitset_pair_count",
                                    lambda o, i, w, a, b: int(a.shape[0])),
        "uint_intersect": Capture(uint_ops, "intersect_count_csr",
                                  lambda o, nb, u, v: int(u.shape[0])),
    }
    is_uint, is_off = in_mode("uint"), in_mode("off")
    regimes = {
        "uint_intersect.uint": Capture(
            uint_ops, "intersect_count_csr",
            lambda o, nb, u, v: is_uint(int(u.shape[0])), copy=True),
        "frontier_fold.off": Capture(
            fill_ops, "fold", lambda lo0, *a: is_off(int(lo0.shape[0])),
            copy=True),
    }

    def load_pruned(p):
        s, d = edge_list(p)
        return load(Engine(backend="device"), s, d, W.ALIASES)

    def store_stats(eng):
        trie = eng.catalog.get("Edge")
        return {key[2]: store.stats() for key, store in trie.device_stores()}

    common.reset_launches()
    try:
        # ---- 1. the seven orderings of the full-size graph, pruned
        t0 = time.perf_counter()
        stats = graph_stats(g)
        log(f"[prep] graph_stats of powerlaw_graph{FULL_GRAPH} "
            f"{json.dumps(stats)} in {time.perf_counter() - t0:.3f} s")
        check(tc_full % 6 == 0, f"TRIANGLE_COUNT {tc_full} is not 6 x the "
                                "pruned count")
        degree_eng = None
        for method in ORDERINGS:
            t0 = time.perf_counter()
            perm = order_nodes(g, method)
            t_order = time.perf_counter() - t0
            t0 = time.perf_counter()
            h = apply_ordering(g, perm)
            t_apply = time.perf_counter() - t0
            t0 = time.perf_counter()
            p = prune_symmetric(h)
            t_prune = time.perf_counter() - t0
            eng = load_pruned(p)
            count, walls, delta, launched = pattern_runs(
                eng, W.TRIANGLE_COUNT, torch)
            log(f"[prep] {method}: order_nodes {t_order:.3f} s, "
                f"apply_ordering {t_apply:.3f} s, prune_symmetric "
                f"{t_prune:.3f} s; {p.m} edges, largest pruned degree "
                f"{int(p.degrees.max())}; TRIANGLE_COUNT {count} cold "
                f"{walls['cold']:.3f} s warm {walls['warm']:.3f} s; store "
                f"{json.dumps(store_stats(eng))}; warm "
                f"{json.dumps(route_counters(delta))} launches "
                f"{json.dumps(launched)}")
            check(count * 6 == tc_full,
                  f"{method}: pruned TRIANGLE_COUNT {count} x 6 != "
                  f"{tc_full}")
            if method == "degree":
                degree_eng = eng
            del eng, h, p

        # ---- 2. the degree-ordered, pruned graph in each layout mode
        counts = {}
        for m in LAYOUT_MODES:
            layouts.set_engine_layout_mode(m)
            count, walls, delta, launched = pattern_runs(
                degree_eng, W.TRIANGLE_COUNT, torch)
            log(f"[prep] degree-ordered, mode {m}: TRIANGLE_COUNT {count} "
                f"cold {walls['cold']:.3f} s warm {walls['warm']:.3f} s; "
                f"warm {json.dumps(route_counters(delta))} launches "
                f"{json.dumps(launched)}")
            check_route(m, delta, launched, f"full-size, mode {m}")
            counts[m] = count
        check(len(set(counts.values())) == 1,
              f"the layout modes disagree: {counts}")
        layouts.set_engine_layout_mode("set")
        count, walls, delta, launched = pattern_runs(
            degree_eng, W.FOUR_CLIQUE, torch)
        log(f"[prep] degree-ordered, mode set: FOUR_CLIQUE {count} cold "
            f"{walls['cold']:.3f} s warm {walls['warm']:.3f} s; warm "
            f"{json.dumps(route_counters(delta))} launches "
            f"{json.dumps(launched)}")
        del degree_eng

        # the host oracle on the 50k-vertex graph, degree-ordered, pruned
        og = powerlaw_graph(*MAT_ORACLE_GRAPH, seed=0)
        op = prune_symmetric(apply_ordering(og, order_nodes(og, "degree")))
        osrc, odst = edge_list(op)
        t0 = time.perf_counter()
        host = load(Engine(backend="numpy"), osrc, odst, W.ALIASES)
        want = {q: int(host.query(getattr(W, q)).scalar())
                for q in ("TRIANGLE_COUNT", "FOUR_CLIQUE")}
        log(f"[prep] host oracle on powerlaw_graph{MAT_ORACLE_GRAPH}, "
            f"degree-ordered, pruned ({op.m} edges): {json.dumps(want)} in "
            f"{time.perf_counter() - t0:.1f} s")
        del host
        for m in LAYOUT_MODES:
            layouts.set_engine_layout_mode(m)
            eng = load_pruned(op)
            for q, n in want.items():
                got, walls, delta, launched = pattern_runs(
                    eng, getattr(W, q), torch, ("cold",))
                log(f"[prep] oracle graph, mode {m}: {q} {got} in "
                    f"{walls['cold']:.3f} s")
                check(got == n, f"{q} on the oracle graph in mode {m}: "
                                f"{got} != host {n}")
            del eng

        # ---- 3. Kronecker graphs, degree-ordered and pruned
        for scale, modes in KRON_RUNS:
            layouts.set_engine_layout_mode("set")
            kp, line = kron_pruned(scale)
            rows = y_frontier_rows(kp)
            log(f"{line}; y frontier {rows} rows")
            fits = rows <= stats_mod.PIPELINE_MAX_BUFFER
            check(fits == (scale != KRON_PAPER_SCALE),
                  f"kronecker {scale}: a y frontier of {rows} rows "
                  f"{'fits' if fits else 'exceeds'} the pipeline's buffer")
            eng = load_pruned(kp)
            # past the buffer the cold run is the only one: the host path
            # makes it as long as a warm one
            runs = ("cold", "warm") if fits else ("cold",)
            kcounts = {}
            for m in modes:
                layouts.set_engine_layout_mode(m)
                count, walls, delta, launched = pattern_runs(
                    eng, W.TRIANGLE_COUNT, torch, runs)
                log(f"[prep] kronecker {scale}, mode {m}: TRIANGLE_COUNT "
                    f"{count} {json.dumps(walls)}; store "
                    f"{json.dumps(store_stats(eng))}; "
                    f"{json.dumps(route_counters(delta))} launches "
                    f"{json.dumps(launched)}")
                check_route(m, delta, launched, f"kronecker {scale}, mode {m}")
                got = step_rows(eng, "y")
                check(got == rows, f"kronecker {scale}, mode {m}: the y "
                                   f"frontier held {got} rows, not {rows}")
                kcounts[m] = count
            del eng
            check(len(set(kcounts.values())) == 1,
                  f"kronecker {scale}: the modes disagree {kcounts}")
            if scale == KRON_ORACLE_SCALE:
                layouts.set_engine_layout_mode("set")
                s, d = edge_list(kp)
                t0 = time.perf_counter()
                host = load(Engine(backend="numpy"), s, d, W.ALIASES)
                n = int(host.query(W.TRIANGLE_COUNT).scalar())
                log(f"[prep] kronecker {scale}: host oracle TRIANGLE_COUNT "
                    f"{n} in {time.perf_counter() - t0:.1f} s")
                check(n == kcounts["set"], f"kronecker {scale}: device "
                      f"{kcounts['set']} != host {n}")
                del host
            del kp
    finally:
        layouts.set_engine_layout_mode("set")
        for c in regimes.values():
            c.restore()
        for c in calls.values():
            c.restore()
    launches = dict(common.LAUNCHES)
    log(f"[prep] launches {json.dumps(launches)}")
    for name, cap in calls.items():
        check(launches.get(name, 0) == cap.calls,
              f"{name}: {launches.get(name, 0)} launches for {cap.calls} "
              "calls with work, not one a call")
    check(set(launches) <= set(calls), f"a kernel off the path launched: "
                                       f"{json.dumps(launches)}")
    for name in ("frontier_fill", "frontier_fold", "bitset_intersect",
                 "uint_intersect"):
        check(launches.get(name, 0) > 0, f"{name} never launched in the "
                                         "preprocessing path")
    for name, cap in regimes.items():
        check(cap.args is not None, f"no call of {name}")
    log(f"[prep] phase {time.perf_counter() - t_phase:.1f} s")
    return launches, regimes


def regime_calls(regimes, fill_ops, uint_ops, fold_ref, uint_ref,
                 time_stats, torch):
    """The preprocessing path's two new regimes on their largest calls
    (phase 8b's captures): ``uint_intersect`` in layout mode "uint" and
    ``frontier_fold`` in mode "off", each held against its plain version
    bit for bit, two launches equal, timed (CUDA events, L2 flushed, the
    card held, median of 20) beside its bound, with the call's shape:
    printed lines, not table rows."""
    args = regimes["uint_intersect.uint"].args
    got = uint_ops.intersect_count_csr(*args)
    check(torch.equal(got, uint_ref(*args)),
          "uint_intersect, mode uint: differs from its plain version")
    check(torch.equal(got, uint_ops.intersect_count_csr(*args)),
          "uint_intersect, mode uint: two launches differ")
    ms, lo, hi = time_stats(lambda: uint_ops.intersect_count_csr(*args), 20)
    shape, moved, ops = uint_work(args, torch)
    b_bytes, b_ops = moved / HBM_BYTES_PER_S * 1e3, ops / INT32_OPS_PER_S * 1e3
    log(f"[kernel] uint_intersect, mode uint's largest call: {shape}; "
        f"bit-equal, two launches equal; kernel {ms:.4f} ms (min {lo:.4f}, "
        f"max {hi:.4f}), bound {max(b_bytes, b_ops):.4f} ms (bytes "
        f"{b_bytes:.4f} ms, {moved} bytes; operations {b_ops:.4f} ms)")
    args = regimes["frontier_fold.off"].args
    sr = args[6]
    got = fill_ops.fold(*args)
    check(fold_equal(got, fold_ref(*args), sr, torch),
          "frontier_fold, mode off: differs from its plain version")
    check(all(torch.equal(x, y) for x, y in zip(got, fill_ops.fold(*args))),
          "frontier_fold, mode off: two launches differ")
    ms, lo, hi = time_stats(lambda: fill_ops.fold(*args), 20)
    cands, moved, ops = fold_work(args, torch)
    b_bytes, b_ops = moved / HBM_BYTES_PER_S * 1e3, ops / INT32_OPS_PER_S * 1e3
    log(f"[kernel] frontier_fold, mode off's largest call: rows="
        f"{int(args[0].shape[0])} live_rows="
        f"{int((fold_counts(args, torch) > 0).sum())} candidates={cands} "
        f"n0={int(args[3].shape[0])} probes={len(args[4])} "
        f"semiring={sr.name}; bit-equal, two launches equal; kernel "
        f"{ms:.4f} ms (min {lo:.4f}, max {hi:.4f}), bound "
        f"{max(b_bytes, b_ops):.4f} ms (bytes {b_bytes:.4f} ms, {moved} "
        f"bytes; operations {b_ops:.4f} ms)")


def kernel_timer(torch):
    """``time_stats(fn, reps, hold=True)``: the median, min and max over
    ``reps`` launches of ``fn`` (a 256 MB buffer zeroed before each to
    flush the L2; with ``hold``, the card held busy while the host queues
    it, see ``HOLD_CYCLES``), in ms, by CUDA events."""
    import numpy as np
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")

    def time_stats(fn, reps, hold=True):
        fn()
        torch.cuda.synchronize()
        ev = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
        for s, e in ev:
            if hold:
                torch.cuda._sleep(HOLD_CYCLES)
            flush.zero_()
            s.record()
            fn()
            e.record()
        torch.cuda.synchronize()
        ms = [s.elapsed_time(e) for s, e in ev]
        return float(np.median(ms)), min(ms), max(ms)

    return time_stats


def fold_profile(cases, common, fill_ops, plain, time_stats, torch):
    """Each batched fold case's block-cycles by phase, summed over the
    fold's blocks, through a build of ``frontier_fill.cu`` with
    ``-DFOLD_PROFILE`` (which the wrappers launch from then on): the
    merge path's share ends, the tile starts, the rows' staging and the
    tile's check, the probes, and the fold with the row writes.  The
    blocks stay resident from start to end, so a share of block-cycles is
    a share of the kernel's time; the marks add a few per cent."""
    import ctypes
    phases = ("share ends", "tile starts", "row staging and check",
              "probes", "fold and writes")
    lib = common.load_variant(fill_ops.NAME, ("FOLD_PROFILE",))
    sums = (ctypes.c_ulonglong * 8)()
    for label, case in cases:
        same = fold_equal(fill_ops.fold_batched(*case), plain(*case),
                          case[6], torch)
        check(same, f"frontier_fold_batched, {label}: the profiling build "
                    "differs from the plain version")
        torch.cuda.synchronize()
        check(lib.frontier_fold_profile_reset() == 0, "profile reset")
        fill_ops.fold_batched(*case)
        torch.cuda.synchronize()
        check(lib.frontier_fold_profile_read(sums) == 0, "profile read")
        total = max(1, sum(sums[:len(phases)]))
        ms = time_stats(lambda: fill_ops.fold_batched(*case), 5)[0]
        log(f"[profile] frontier_fold_batched, {label}: equal to the plain "
            f"version; {ms:.4f} ms with the marks (median of 5); "
            f"block-cycles {total:.4e}: " + ", ".join(
                f"{name} {sums[k] / total * 100:.1f}%"
                for k, name in enumerate(phases)))


def kernel_split(fn, torch, reps=3):
    """The device time a launch of each kernel that ``fn`` runs, by
    torch.profiler over ``reps`` calls: ``name us, ...``."""
    activity = torch.profiler.ProfilerActivity.CUDA
    with torch.profiler.profile(activities=[activity]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    parts = []
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", 0) or getattr(
            e, "cuda_time_total", 0)
        if us:
            name = e.key.split("(")[0].replace("void ", "")
            parts.append(f"{name} {us / max(e.count, 1):.2f} us")
    return ", ".join(parts) or "no device time"


def fold_cases_only(opts, torch):
    """``--fold-cases``: the build, phase 8 on the full-size graph, then
    the batched fold's cases (a)-(i) on its captured calls
    (:func:`fold_batched_cases`, ``opts.repeat`` times; then each case's
    device time by kernel, :func:`kernel_split`) and the single fold's
    (a)-(f) on phase 8's largest single-query call (:func:`fold_cases`);
    with ``--fold-profile``, :func:`fold_profile` last.  Prints each run's median ms by case letter as the last line."""
    from repro_torch.data.graphs import edge_list, powerlaw_graph
    from repro_torch.kernels import common
    from repro_torch.kernels.frontier_fill import ops as fill_ops
    from repro_torch.kernels.frontier_fill.ref import (fold_batched_ref,
                                                       fold_ref)
    log(f"card: {card_line()}; package {opts.src}")
    t0 = time.perf_counter()
    for name, report in common.build().items():
        for line in ptxas_lines(report):
            if "fold" in line:
                log(f"[build] {name}: {line}")
    g = powerlaw_graph(*FULL_GRAPH, seed=0)
    src, dst = edge_list(g)
    single = Capture(fill_ops, "fold", lambda lo0, *a: int(lo0.shape[0]),
                     copy=True)
    _launches, captures = serving_path(src, dst, g, torch)
    single.restore()
    args = captures["frontier_fold_batched"].args
    small = captures["frontier_fold_batched.small"].args
    log(f"[cases] the captured call's probe segments: "
        f"{segment_stats(args, torch)}")
    time_stats = kernel_timer(torch)
    runs = [fold_batched_cases(args, fill_ops.fold_batched,
                               fold_batched_ref, time_stats, torch, small)
            for _ in range(opts.repeat)]
    for label, case in fold_batched_case_args(args, torch, small):
        log(f"[split] frontier_fold_batched, {label}: "
            f"{kernel_split(lambda: fill_ops.fold_batched(*case), torch)}")
    single_ms = fold_cases(single.args, fill_ops, fold_ref, time_stats,
                           torch)
    if opts.fold_profile:
        fold_profile(fold_batched_case_args(args, torch, small), common,
                     fill_ops, fold_batched_ref, time_stats, torch)
    log(f"[cases] {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"src": opts.src, "batched_ms": runs,
                      "single_ms": single_ms}), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--fold-cases", action="store_true")
    ap.add_argument("--fold-profile", action="store_true")
    ap.add_argument("--repeat", type=int, default=1)
    ap.add_argument("--src", default=str(SRC))
    ap.add_argument("--kron-frontiers", type=int, nargs="+", metavar="SCALE")
    opts = ap.parse_args()
    src_dir = Path(opts.src).resolve()
    if not (src_dir / "repro_torch").is_dir():
        fail(f"no repro_torch under {src_dir}: run {Path(__file__).name} "
             "from the root of a checkout", 2)
    sys.path.insert(0, str(src_dir))
    import numpy as np
    import torch

    if opts.kron_frontiers:
        kron_frontiers(opts.kron_frontiers)
        return
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a card",
             3)
    if opts.fold_cases or opts.fold_profile:
        fold_cases_only(opts, torch)
        return

    from repro_torch.core import workload as W
    from repro_torch.core.engine import Engine
    from repro_torch.core.executor import BagResultCache
    from repro_torch.data.graphs import edge_list, powerlaw_graph
    from repro_torch.kernels import common
    from repro_torch.kernels.bitset_intersect import ops as bitset_ops
    from repro_torch.kernels.bitset_intersect.ref import \
        bitset_pair_count_ref
    from repro_torch.kernels.fm_interaction import ops as fm_ops
    from repro_torch.kernels.fm_interaction.ref import (fm_interaction_ref,
                                                        fm_interaction_scale)
    from repro_torch.kernels.frontier_fill import ops as fill_ops
    from repro_torch.kernels.frontier_fill.ref import (fill_batched_ref,
                                                       fill_ref,
                                                       fold_batched_ref,
                                                       fold_ref)
    from repro_torch.kernels.materialize import ops as mat_ops
    from repro_torch.kernels.materialize.ref import (HEADER, buffer_total,
                                                     materialize_ref)
    from repro_torch.kernels.spmv_ell import ops as ell_ops
    from repro_torch.kernels.spmv_ell.ref import spmv_ell_ref
    from repro_torch.kernels.triangle_mm import ops as tri_ops
    from repro_torch.kernels.triangle_mm.ref import triangle_count_dense_ref
    from repro_torch.kernels.uint_intersect import ops as uint_ops
    from repro_torch.kernels.uint_intersect.ref import \
        intersect_count_csr_ref

    t_start = time.perf_counter()
    card = card_line()
    log(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}")

    # ---------------------------------------------------------- 1. build
    t0 = time.perf_counter()
    reports = common.build()
    log(f"[build] {len(reports)} of {len(common.KERNEL_SOURCES)} kernels "
        f"compiled in {time.perf_counter() - t0:.2f} s")
    for name, rep in reports.items():
        for line in ptxas_lines(rep):
            log(f"[build] {name}: {line}")
    ff_lines = ptxas_lines(reports.get("frontier_fill", ""))
    fill_lines = [line for line in ff_lines
                  if line.startswith(("frontier_fill_kernel",
                                      "frontier_fill_batched_kernel"))]
    # the batched fold: 3 semiring types x 4 probe counts, and its staging
    # kernel's 4 probe counts
    fold_lines = [line for line in ff_lines if line.startswith((
        "void fold::fold_batched_kernel<", "void fold::fold_stage_kernel<"))]
    check("frontier_fill" not in reports or (len(fill_lines) == 2
                                             and len(fold_lines) == 16),
          f"{len(fill_lines)} ptxas lines of the fill and its batched form, "
          f"{len(fold_lines)} of the batched fold's instances (want 2, 16)")
    for line in fill_lines + fold_lines:
        check("0 bytes stack frame, 0 bytes spill stores, 0 bytes spill "
              "loads" in line, f"a stack frame or a spill: {line}")

    # ------------------------------------------------------ 2. main path
    captures = {
        "frontier_fill": Capture(fill_ops, "fill", lambda *a: a[6]),
        "frontier_fold": Capture(fill_ops, "fold",
                                 lambda lo0, *a: int(lo0.shape[0])),
        "bitset_intersect": Capture(bitset_ops, "bitset_pair_count",
                                    lambda o, i, w, a, b: int(a.shape[0])),
        "uint_intersect": Capture(uint_ops, "intersect_count_csr",
                                  lambda o, nb, u, v: int(u.shape[0])),
    }
    g = powerlaw_graph(*FULL_GRAPH, seed=0)
    src, dst = edge_list(g)
    log(f"[main] powerlaw_graph{FULL_GRAPH}: {len(src)} directed edges")
    eng = load(Engine(backend="device"), src, dst, W.ALIASES)
    queries = (("TRIANGLE_COUNT", W.TRIANGLE_COUNT),
               ("LOLLIPOP", W.LOLLIPOP), ("BARBELL", W.BARBELL))
    common.reset_launches()
    results, walls = {}, {}
    for name, q in queries:
        for run in ("cold", "warm"):
            # warm: plans, layout stores and uploads cached, bag results not
            eng.bag_cache = BagResultCache()
            t0 = time.perf_counter()
            res = eng.query(q)
            torch.cuda.synchronize()
            walls[f"{name}.{run}"] = time.perf_counter() - t0
        results[name] = int(res.scalar())
    summary = eng.dispatch_summary()
    # small graph: all five pattern queries against the host oracle
    g2 = powerlaw_graph(*SMALL_GRAPH, seed=0)
    s2, d2 = edge_list(g2)
    for name in ("TRIANGLE_COUNT", "TRIANGLE_LIST", "FOUR_CLIQUE",
                 "LOLLIPOP", "BARBELL"):
        q = getattr(W, name)
        dev_eng = load(Engine(backend="device"), s2, d2, W.ALIASES)
        t0 = time.perf_counter()
        got = dev_eng.query(q)
        wall = time.perf_counter() - t0
        ref = load(Engine(backend="numpy"), s2, d2, W.ALIASES).query(q)
        same = same_result(got, ref)
        shown = f"{got.num_rows} rows" if got.vars else int(got.scalar())
        d = dev_eng.dispatch_summary()
        log(f"[small] {name}: {shown} in {wall} s; host_syncs="
            f"{d.get('extend.host_syncs', 0)} closing_syncs="
            f"{d.get('extend.closing_syncs', 0)} launches="
            f"{d.get('pipeline.launches', 0)} morsels="
            f"{d.get('pipeline.morsels', 0)}")
        check(same, f"{name} on the small graph differs from the host")
        if name != "TRIANGLE_LIST":
            check(d.get("extend.host_syncs", 0) == 0,
                  f"{name} took a per-extension host sync")

    launches = dict(common.LAUNCHES)
    for c in captures.values():
        c.restore()
    log(f"[main] results {json.dumps(results)}")
    log(f"[main] walls_s {json.dumps(walls)}")
    log(f"[main] launches {json.dumps(launches)}")
    log(f"[main] dispatch_summary {json.dumps(summary, sort_keys=True)}")
    check(summary.get("pipeline.launches", 0) >= 1, "pipeline never engaged")
    check(summary.get("pipeline.morsels", 0) > 0, "no fill chunk ran")
    check(summary.get("intersect.bitset_kernel", 0) > 0,
          "no pair took the bitset kernel")
    check(summary.get("intersect.uint_kernel", 0) > 0,
          "no pair took the uint kernel")
    for name in KERNELS:
        check(launches.get(name, 0) > 0, f"kernel {name} never launched")
    check(launches["frontier_fill"] == captures["frontier_fill"].calls,
          f"frontier_fill: {launches['frontier_fill']} launches for "
          f"{captures['frontier_fill'].calls} calls with slots, not one a "
          "call")
    check(launches["bitset_intersect"] == captures["bitset_intersect"].calls,
          f"bitset_intersect: {launches['bitset_intersect']} launches for "
          f"{captures['bitset_intersect'].calls} both-dense counts, not one "
          "a call")
    if opts.profile:
        profile_query(eng, W.TRIANGLE_COUNT, BagResultCache, torch)
    del eng

    # ----------------------------------------- 3. full-size host oracle
    t0 = time.perf_counter()
    host = load(Engine(backend="numpy"), src, dst, W.ALIASES)
    want = int(host.query(W.TRIANGLE_COUNT).scalar())
    log(f"[oracle] host TRIANGLE_COUNT {want} in "
        f"{time.perf_counter() - t0:.1f} s")
    check(want == results["TRIANGLE_COUNT"],
          f"device triangle count {results['TRIANGLE_COUNT']} != host {want}")
    del host

    # ---------------------------------------------- 4. recursion path
    ell_capture = Capture(ell_ops, "spmv_ell",
                          lambda c, v, rp, x: int(c.shape[0]))
    rec_launches, g2 = recursion_path(src, dst, g, torch)
    ell_capture.restore()
    captures["spmv_ell"] = ell_capture
    for name in RECURSION_KERNELS:
        check(rec_launches.get(name, 0) > 0, f"kernel {name} never launched")

    # ------------------------------------------ 5. materializing path
    captures["materialize"] = Capture(
        mat_ops, "materialize", lambda w, b, i, pa, *a: int(pa.shape[0]))
    mat_launches, mat_eng = materialize_path(src, dst, torch)
    captures["materialize"].restore()
    for name in MAT_KERNELS:
        check(mat_launches.get(name, 0) > 0, f"kernel {name} never launched")
    check(mat_launches["materialize"] == captures["materialize"].calls,
          f"materialize: {mat_launches['materialize']} launches for "
          f"{captures['materialize'].calls} calls with pairs, not one a call")
    if opts.profile:
        # after the capture: the profiled query's launches are not the path's
        profile_query(mat_eng, MAT_QUERIES[0][1], BagResultCache, torch)
    del mat_eng

    # ----------------------------------------- 6. dense triangle path
    captures["triangle_mm"] = Capture(tri_ops, "triangle_mm",
                                      lambda a: int(a.shape[0]))
    tri_launches = triangle_path(torch)
    captures["triangle_mm"].restore()
    for name in TRI_KERNELS:
        check(tri_launches.get(name, 0) > 0, f"kernel {name} never launched")

    # ----------------------------------------------- 7. recsys serving path
    captures["fm_interaction"] = Capture(fm_ops, "fm_interaction",
                                         lambda e: int(e.shape[0]))
    fm_launches = recsys_path(torch)
    captures["fm_interaction"].restore()
    for name in RECSYS_KERNELS:
        check(fm_launches.get(name, 0) > 0, f"kernel {name} never launched")
    # ------------------------------------------ 8. relational serving path
    serve_launches, serve_captures = serving_path(src, dst, g, torch)
    captures.update(serve_captures)
    for name in SERVE_KERNELS:
        check(serve_launches.get(name, 0) > 0, f"kernel {name} never "
                                               "launched")
        check(serve_launches[name] == captures[name].calls,
              f"{name}: {serve_launches[name]} launches for "
              f"{captures[name].calls} calls with work, not one a call")
    # ------------------------------------------ 8b. preprocessing path
    prep_launches, prep_captures = preprocessing_path(
        g, results["TRIANGLE_COUNT"], torch)
    path_launches = collections.Counter()
    for counts in (launches, rec_launches, mat_launches, tri_launches,
                   fm_launches, serve_launches, prep_launches):
        path_launches.update(counts)

    # ---------------------------------- 9. kernels against plain versions
    time_stats = kernel_timer(torch)

    def nbytes(*ts):
        return sum(t.numel() * t.element_size() for t in ts)

    def max_err(a, b):
        a, b = list(a), list(b)
        check(len(a) == len(b), "output arity differs")
        err = 0
        for x, y in zip(a, b):
            check(x.shape == y.shape and x.dtype == y.dtype,
                  f"output {tuple(x.shape)}/{x.dtype} vs "
                  f"{tuple(y.shape)}/{y.dtype}")
            if x.numel():
                err = max(err, int((x.to(torch.int64) - y.to(torch.int64))
                                   .abs().max()))
        return err

    def flat(name, out):
        if name in ("frontier_fill", "frontier_fill_batched"):
            return out[:4] + tuple(out[4])
        return out if isinstance(out, tuple) else (out,)

    rows = []
    for name, (source, replaces) in {**KERNELS, **RECURSION_KERNELS,
                                     **MAT_KERNELS, **TRI_KERNELS,
                                     **RECSYS_KERNELS,
                                     **SERVE_KERNELS}.items():
        args = captures[name].args
        library_ms = None
        reps, plain_reps = 20, 5
        bound_ops_per_s = INT32_OPS_PER_S
        check(args is not None, f"no captured call of {name}")
        if name == "frontier_fill":
            total_c, offs, lo0, seed, probes, start, n = args
            kern = lambda: fill_ops.fill(*args)                   # noqa: E731
            plain = lambda: fill_ref(*args)                       # noqa: E731
            live, moved, ops = fill_work(*args, torch)
            shape = (f"slots={n} live={live} cap_in={int(offs.shape[0])} "
                     f"n0={int(seed.shape[0])} probes={len(probes)}")
            fill_cases(args, fill_ops, fill_ref, time_stats, flat, torch)
        elif name == "frontier_fold":
            lo0, offs, total, seed, probes, anns, sr = args
            kern = lambda: fill_ops.fold(*args)                   # noqa: E731
            plain = lambda: fold_ref(*args)                       # noqa: E731
            cands, moved, ops = fold_work(args, torch)
            shape = (f"rows={int(lo0.shape[0])} candidates={cands} "
                     f"n0={int(seed.shape[0])} probes={len(probes)} "
                     f"semiring={sr.name}; bytes alone "
                     f"{moved / HBM_BYTES_PER_S * 1e3:.4f} ms")
            fold_cases(args, fill_ops, fold_ref, time_stats, torch)
        elif name == "frontier_fill_batched":
            kern = lambda: fill_ops.fill_batched(*args)           # noqa: E731
            plain = lambda: fill_batched_ref(*args)               # noqa: E731
            shape, moved, ops, singles = fill_batched_work(args, fill_ops,
                                                           torch)
        elif name == "frontier_fold_batched":
            kern = lambda: fill_ops.fold_batched(*args)           # noqa: E731
            plain = lambda: fold_batched_ref(*args)               # noqa: E731
            shape, moved, ops, singles = fold_batched_work(args, fill_ops,
                                                           torch)
            shape += f" ({segment_stats(args, torch)})"
            fold_batched_cases(args, fill_ops.fold_batched,
                               fold_batched_ref, time_stats, torch,
                               captures["frontier_fold_batched.small"].args)
            anchored_fold_check(fill_ops, fold_batched_ref, time_stats,
                                torch)
        elif name == "bitset_intersect":
            kern = lambda: bitset_ops.bitset_pair_count(*args)    # noqa: E731
            plain = lambda: bitset_pair_count_ref(*args)          # noqa: E731
            shape, moved, ops = pair_count_work(args, torch)
            shape += (f" blocks={int(args[2].shape[0])} "
                      f"words={int(args[2].shape[1])}")
            pair_count_cases(args, bitset_ops, bitset_pair_count_ref,
                             time_stats, torch)
        elif name == "spmv_ell":
            cols, vals, row_ptr, x = args
            kern = lambda: ell_ops.spmv_ell(*args)                # noqa: E731
            plain = lambda: spmv_ell_ref(*args)                   # noqa: E731
            n_out = int(row_ptr.shape[0]) - 1
            # the work is the graph's entries, not the packing's padding
            # (weight-0 slots): (col, val) per entry, x, y and row_ptr once
            nnz = int((vals != 0).sum())
            moved = 8 * nnz + nbytes(row_ptr, x) + n_out * 4
            ops = 2 * nnz
            bound_ops_per_s = F32_OPS_PER_S
            padded = nbytes(cols, vals, row_ptr, x) + n_out * 4
            shape = (f"ell_rows={int(cols.shape[0])} width="
                     f"{int(cols.shape[1])} slots={cols.numel()} "
                     f"entries={nnz} outputs={n_out}; bound with the "
                     f"padding read {padded / HBM_BYTES_PER_S * 1e6:.2f} "
                     f"us ({padded} bytes)")
            # recursion.pagerank packs the CSR itself: no padding slot
            check(cols.numel() == nnz, "spmv_ell's largest call reads "
                                       "padding slots")
        elif name == "materialize":
            words, block_ids, index, pa, pb, pid, cap = args
            kern = lambda: mat_ops.materialize(*args)             # noqa: E731
            plain = lambda: materialize_ref(*args)                # noqa: E731
            p = int(pa.shape[0])
            w = int(words.shape[1])
            total = int(buffer_total(kern())[0])
            moved, rows_read = materialize_bytes(words, pa, pb, total, torch)
            ops = p * w * 8 + total * 12
            plain_reps = 3
            shape = (f"pairs={p} words={w} blocks={int(words.shape[0])} "
                     f"rows_read={rows_read} matches={total} cap={cap}; "
                     f"block rows read from L2 {p * 2 * w * 4} bytes")
        elif name == "triangle_mm":
            (a,) = args
            n = int(a.shape[0])
            kern = lambda: tri_ops.triangle_mm(a)                 # noqa: E731
            plain = lambda: triangle_count_dense_ref(a)           # noqa: E731
            nnz = int((a != 0).sum())
            moved = nbytes(a) + 8
            # Σ((A@A)⊙A) needs (A@A)_ij only where A_ij != 0: one length-n
            # dot product per nonzero of this input, not the dense 2n³
            ops = 2 * n * nnz
            bound_ops_per_s = BF16_OPS_PER_S
            reps, plain_reps = 5, 3
            shape = (f"n={n} nonzeros={nnz}; the dense product's 2n^3 "
                     f"at the bf16 rate would take "
                     f"{2 * n ** 3 / BF16_OPS_PER_S * 1e3:.4f} ms")
        elif name == "fm_interaction":
            (e,) = args
            kern = lambda: fm_ops.fm_interaction(e)               # noqa: E731
            plain = lambda: fm_interaction_ref(e)                 # noqa: E731
            # each element read once, each row's result written once; a
            # sum, a square and its sum per element
            moved = nbytes(e) + int(e.shape[0]) * 4
            ops = 3 * e.numel()
            bound_ops_per_s = F32_OPS_PER_S
            shape = (f"rows={int(e.shape[0])} fields={int(e.shape[1])} "
                     f"dim={int(e.shape[2])}")
        else:
            offs, nbr, u, v = args
            kern = lambda: uint_ops.intersect_count_csr(*args)    # noqa: E731
            plain = lambda: intersect_count_csr_ref(*args)        # noqa: E731
            shape, moved, ops = uint_work(args, torch)
            uint_cases(args, uint_ops, intersect_count_csr_ref, time_stats,
                       torch)
        if name == "spmv_ell":
            got, want = kern(), plain()
            check(torch.equal(got, kern()), "spmv_ell: two launches differ")
            abs_sum = spmv_ell_ref(cols, vals.abs(), row_ptr, x.abs())
            scale = abs_sum.double().clamp_min(1e-30)
            exact = spmv_ell_f64(cols, vals, row_ptr, x)
            err = float((got - want).abs().max())
            rel = float(((got.double() - exact).abs() / scale).max())
            plain_rel = float(((want.double() - exact).abs() / scale).max())
            check(rel <= ELL_REL_LIMIT,
                  f"spmv_ell differs from the plain version's sums in "
                  f"float64: {rel} of the absolute sum (limit "
                  f"{ELL_REL_LIMIT})")
            a = torch.sparse_csr_tensor(
                torch.as_tensor(g2.offsets, device="cuda"),
                torch.as_tensor(g2.neighbors.astype(np.int64),
                                device="cuda"),
                torch.ones(g2.m, dtype=torch.float32, device="cuda"),
                size=(g2.n, g2.n))
            check(n_out == g2.n, "spmv_ell's largest call is not the "
                                 "large graph's")
            lib = torch.mv(a, x)
            lib_rel = float(((lib.double() - exact).abs() / scale).max())
            library_ms = time_stats(lambda: torch.mv(a, x), 20)[0]
            shape += (f"; within {rel} of the absolute sum of the sums in "
                      f"float64 (limit {ELL_REL_LIMIT}; the float32 plain "
                      f"version {plain_rel}, max |kernel - plain| {err}), "
                      f"two launches bit-identical; torch.sparse "
                      f"{library_ms:.4f} ms ({lib_rel} of the absolute sum)")
            del a, lib, exact
            # the same graph packed at width 32 (long rows split, the last
            # row of each vertex padded): what the layout buys, apart from
            # the kernel; a printed line, not a row of the table
            split = [torch.as_tensor(t, device="cuda") for t in
                     ell_ops.csr_to_ell_split(g2.offsets, g2.neighbors,
                                              width=32)]
            split_rel = float(((ell_ops.spmv_ell(*split, x).double()
                                - spmv_ell_f64(*split, x)).abs()
                               / scale).max())
            split_ms = time_stats(lambda: ell_ops.spmv_ell(*split, x), 20)[0]
            log(f"[kernel] spmv_ell on the width-32 split packing of the "
                f"same graph ({split[0].numel()} slots for {nnz} entries): "
                f"{split_ms:.4f} ms, {split_rel} of the absolute sum")
            del split
        elif name == "materialize":
            got, want = kern(), plain()
            got_n, want_n = (int(buffer_total(x)[0]) for x in (got, want))
            check(got_n == want_n == total,
                  f"materialize: totals {got_n} / {want_n}")
            used = HEADER + 4 * total
            err = max_err((got[:used],), (want[:used],))
            check(err == 0, f"materialize differs from its plain version "
                            f"(max |err| {err})")
            check(torch.equal(got[:used], kern()[:used]),
                  "materialize: two launches differ")
            shape += ("; bit-equal up to the total, two launches equal; "
                      + materialize_fetch(got, total, mat_ops, common, torch))
            del got, want
            materialize_cases(args, mat_ops, materialize_ref, time_stats,
                              torch)
        elif name == "triangle_mm":
            got, want = kern(), plain()
            check(torch.equal(got, kern()), "triangle_mm: two launches "
                                            "differ")
            err = abs(int(got) - int(want))
            check(err == 0 and float(want) == int(want),
                  f"triangle_mm {int(got)} != plain {float(want)}")
            lib_fn = lambda: (torch.matmul(a, a) * a).sum()       # noqa: E731
            lib = float(lib_fn())
            library_ms = time_stats(lib_fn, reps)[0]
            shape += (f"; raw count {int(got)}, equal to the float64 plain "
                      f"version, two launches equal; torch.matmul "
                      f"{library_ms:.4f} ms (gives {lib}); "
                      + triangle_mm_passes(a, tri_ops, time_stats, torch))
            triangle_mm_cases(a, tri_ops, triangle_count_dense_ref, time_stats,
                              torch)
        elif name in SERVE_KERNELS:
            got = flat(name, kern())
            err = max_err(got, flat(name, plain()))
            check(err == 0, f"{name} differs from its plain version (max "
                            f"|err| {err})")
            check(all(torch.equal(x, y) for x, y in
                      zip(got, flat(name, kern()))),
                  f"{name}: two launches differ")
            single_out = singles()
            check(all(torch.equal(torch.stack([o[i] for o in single_out]),
                                  x) for i, x in
                      enumerate(got[:len(single_out[0])])),
                  f"{name}: the single-query calls differ from the batch")
            single_ms = time_stats(singles, 5)[0]
            shape += (f"; bit-equal, two launches equal; the same rows as "
                      f"{int(args[1].shape[0])} single-query calls "
                      f"{single_ms:.4f} ms (CUDA events around the host's "
                      f"loop of launches, median of 5), equal to the batch")
        elif name == "fm_interaction":
            got, want = kern(), plain()
            check(torch.equal(got, kern()), "fm_interaction: two launches "
                                            "differ")
            diff = (got - want).abs()
            err = float(diff.max())
            rel = float((diff / fm_interaction_scale(e).clamp_min(1e-30))
                        .max())
            check(rel <= FM_SCALE_REL,
                  f"fm_interaction differs from its plain version: {rel} of "
                  f"the row's absolute scale (limit {FM_SCALE_REL})")
            shape += (f"; max |err| {err} = {rel} of the row's absolute "
                      f"scale (limit {FM_SCALE_REL}), two launches "
                      "bit-identical; no single PyTorch call computes this "
                      "function, so library_ms is null")
        else:
            err = max_err(flat(name, kern()), flat(name, plain()))
            check(err == 0, f"{name} differs from its plain version (max "
                            f"|err| {err})")
            shape += "; bit-equal"
        ms = time_stats(kern, reps)[0]
        plain_ms = time_stats(plain, plain_reps)[0]
        b_bytes = moved / HBM_BYTES_PER_S * 1e3
        b_ops = ops / bound_ops_per_s * 1e3
        rows.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": int(path_launches.get(name, 0)),
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(b_bytes, b_ops),
            "bound_by": "bytes" if b_bytes >= b_ops else "operations",
            "library_ms": library_ms,
        })
        log(f"[kernel] {name}: {shape}; kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, bound {max(b_bytes, b_ops) * 1e3:.2f} us "
            f"(by {rows[-1]['bound_by']}; {moved} bytes {b_bytes * 1e3:.2f} "
            f"us, operations {b_ops * 1e3:.2f} us)")

    regime_calls(prep_captures, fill_ops, uint_ops, fold_ref,
                 intersect_count_csr_ref, time_stats, torch)
    del prep_captures

    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    try:
        main()
    except SystemExit:
        raise
    except BaseException:
        traceback.print_exc()
        fail("a phase failed (traceback above)")
