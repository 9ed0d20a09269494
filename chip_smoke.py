#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Run from the root of a checkout on a machine with a card:

    python3 chip_smoke.py [--profile]

``--profile`` adds a breakdown of one warm full-size TRIANGLE_COUNT
(host functions by own time, device kernels by time) after the main path.

Phases (any failure ends the run with a non-zero exit and no result line):

1. build: compile every CUDA kernel of the port from ``src/repro_torch/csrc``
   with nvcc for sm_90a (one nvcc per source, in parallel);
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
   must fire;
3. the full-size triangle count is held against the host oracle;
4. every kernel is run again on the largest inputs the main path gave it
   and held bit-for-bit against its plain PyTorch version, and both are
   timed with CUDA events (L2 flushed before each run).

The last three lines of standard output are the kernel table (JSON), the
card's ``name, power.limit`` from nvidia-smi, and the result line
``{"ok": true, "device": {...}}``.  Imports nothing of jax or ``repro``.
"""
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
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
INT32_OPS_PER_S = 67e12        # H100 SXM 32-bit rate outside the tensor cores
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


def log(msg):
    print(msg, flush=True)


def fail(msg, code=1):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


class Capture:
    """Wrap a kernel wrapper to keep the arguments of its largest call."""

    def __init__(self, module, attr, size_of):
        self.module, self.attr = module, attr
        self.orig = getattr(module, attr)
        self.size, self.args = -1, None

        def wrapped(*args):
            n = size_of(*args)
            if n > self.size:
                self.size, self.args = n, args
            return self.orig(*args)

        setattr(module, attr, wrapped)

    def restore(self):
        setattr(self.module, self.attr, self.orig)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


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
    # device-side events only (kernels and copies): the CPU-side op
    # records carry the same device time again
    kernels = []
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0))
        if us > 0:
            kernels.append((us, ev.count, ev.key))
    kernels.sort(reverse=True)
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


def load(eng, src, dst, aliases):
    eng.load_edges("Edge", src, dst)
    for a in aliases:
        eng.alias(a, "Edge")
    return eng


def main():
    if not (SRC / "repro_torch").is_dir():
        fail(f"no src/repro_torch beside {Path(__file__).name}: run it from "
             "the root of a checkout", 2)
    sys.path.insert(0, str(SRC))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a card",
             3)

    from repro_torch.core import workload as W
    from repro_torch.core.engine import Engine
    from repro_torch.core.executor import BagResultCache
    from repro_torch.data.graphs import edge_list, powerlaw_graph
    from repro_torch.kernels import common
    from repro_torch.kernels.bitset_intersect import ops as bitset_ops
    from repro_torch.kernels.bitset_intersect.ref import \
        bitset_and_popcount_ref
    from repro_torch.kernels.frontier_fill import ops as fill_ops
    from repro_torch.kernels.frontier_fill.ref import fill_ref, fold_ref
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
        for line in rep.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")

    # ------------------------------------------------------ 2. main path
    captures = {
        "frontier_fill": Capture(fill_ops, "fill", lambda *a: a[6]),
        "frontier_fold": Capture(fill_ops, "fold",
                                 lambda lo0, *a: int(lo0.shape[0])),
        "bitset_intersect": Capture(bitset_ops, "bitset_and_popcount",
                                    lambda w, a, b: int(a.shape[0])),
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
        if got.vars:
            a = np.stack([got.columns[v] for v in got.vars], 1)
            b = np.stack([ref.columns[v] for v in ref.vars], 1)
            same = (a.shape == b.shape and np.array_equal(
                a[np.lexsort(a.T[::-1])], b[np.lexsort(b.T[::-1])]))
            shown = f"{len(a)} rows"
        else:
            same = int(got.scalar()) == int(ref.scalar())
            shown = int(got.scalar())
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
    if "--profile" in sys.argv[1:]:
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

    # ---------------------------------- 4. kernels against plain versions
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")

    def time_ms(fn, reps):
        fn()
        torch.cuda.synchronize()
        ev = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
        for s, e in ev:
            flush.zero_()
            s.record()
            fn()
            e.record()
        torch.cuda.synchronize()
        return float(np.median([s.elapsed_time(e) for s, e in ev]))

    def nbytes(*ts):
        return sum(t.numel() * t.element_size() for t in ts)

    def sr_size(sr):
        return torch.empty((), dtype=sr.dtype).element_size()

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
        if name == "frontier_fill":
            return out[:4] + tuple(out[4])
        return out if isinstance(out, tuple) else (out,)

    rows = []
    for name, (source, replaces) in KERNELS.items():
        args = captures[name].args
        check(args is not None, f"no captured call of {name}")
        if name == "frontier_fill":
            total_c, offs, lo0, seed, probes, start, n = args
            kern = lambda: fill_ops.fill(*args)                   # noqa: E731
            plain = lambda: fill_ref(*args)                       # noqa: E731
            live = int(total_c)
            steps = (max(1, int(offs.shape[0]).bit_length())
                     + sum(max(1, int(v.shape[0]).bit_length())
                           for v, _l, _h in probes))
            moved = (nbytes(total_c, offs, lo0, seed)
                     + sum(nbytes(*p) for p in probes)
                     + n * (3 * 4 + 1 + 4 * len(probes)))
            ops = min(live, n) * steps * 4
            shape = (f"slots={n} live={live} cap_in={int(offs.shape[0])} "
                     f"n0={int(seed.shape[0])} probes={len(probes)}")
        elif name == "frontier_fold":
            lo0, cnt, seed, probes, anns, sr = args
            kern = lambda: fill_ops.fold(*args)                   # noqa: E731
            plain = lambda: fold_ref(*args)                       # noqa: E731
            cands = int(cnt.long().sum())
            steps = sum(max(1, int(v.shape[0]).bit_length())
                        for v, _l, _h in probes)
            moved = (nbytes(lo0, cnt, seed) + sum(nbytes(*p) for p in probes)
                     + sum(nbytes(a) for a in anns if a is not None)
                     + int(lo0.shape[0]) * (4 + sr_size(sr)))
            ops = cands * (steps + 2) * 4
            shape = (f"rows={int(lo0.shape[0])} candidates={cands} "
                     f"n0={int(seed.shape[0])} probes={len(probes)} "
                     f"semiring={sr.name}")
        elif name == "bitset_intersect":
            words, pa, pb = args
            kern = lambda: bitset_ops.bitset_and_popcount(*args)  # noqa: E731
            plain = lambda: bitset_and_popcount_ref(*args)        # noqa: E731
            rows_read = int(torch.unique(torch.cat([pa, pb])).numel())
            w = int(words.shape[1])
            moved = rows_read * w * 4 + nbytes(pa, pb) + int(pa.shape[0]) * 4
            ops = int(pa.shape[0]) * w * 3
            shape = (f"pairs={int(pa.shape[0])} blocks={int(words.shape[0])}"
                     f" words={w} rows_read={rows_read}")
        else:
            offs, nbr, u, v = args
            kern = lambda: uint_ops.intersect_count_csr(*args)    # noqa: E731
            plain = lambda: intersect_count_csr_ref(*args)        # noqa: E731
            ends = torch.unique(torch.cat([u, v])).long()
            offs64 = offs.long()
            deg = offs64[ends + 1] - offs64[ends]
            du = offs64[u.long() + 1] - offs64[u.long()]
            dv = offs64[v.long() + 1] - offs64[v.long()]
            small, large = torch.minimum(du, dv), torch.maximum(du, dv)
            moved = (int(deg.sum()) * 4 + int(ends.numel()) * 8
                     + nbytes(u, v) + int(u.shape[0]) * 4)
            ops = int((small * torch.log2(large.float() + 1).ceil()
                       .long()).sum()) * 4
            shape = (f"pairs={int(u.shape[0])} endpoints={int(ends.numel())}"
                     f" max_len={int(large.max())}")
        err = max_err(flat(name, kern()), flat(name, plain()))
        check(err == 0, f"{name} differs from its plain version (max |err| "
                        f"{err})")
        ms = time_ms(kern, 20)
        plain_ms = time_ms(plain, 5)
        b_bytes = moved / HBM_BYTES_PER_S * 1e3
        b_ops = ops / INT32_OPS_PER_S * 1e3
        rows.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": int(launches.get(name, 0)),
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(b_bytes, b_ops),
            "bound_by": "bytes" if b_bytes >= b_ops else "operations",
            "library_ms": None,
        })
        log(f"[kernel] {name}: {shape}; kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, bound {max(b_bytes, b_ops) * 1e3:.2f} us "
            f"({moved} bytes), bit-equal")

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
