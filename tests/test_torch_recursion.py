"""Recursion in the port against the JAX package, on the CPU.

The same seeded numpy inputs go through ``repro`` (Pallas in interpret
mode, as its own tests run it) and ``repro_torch`` on ``device="cpu"``
(every kernel's plain PyTorch version):

  * the ELL packings and ``spmv_ell``'s plain version against
    ``repro.kernels.spmv_ell``; the port's split-row packing against the
    reference's one-row-per-vertex packing, and its width-1 packing
    against the CSR itself;
  * ``recursion.pagerank`` / ``sssp`` / ``fixpoint`` and their numpy
    oracles;
  * ``Engine`` PageRank (``i=8``, ``c=0.0001``) and SSSP: results, the
    ``recursion.*`` counters and the ``plan_metadata()`` records; random
    weighted digraphs; a rule shape outside the SpMV form, which takes the
    host loop in both packages.

Tolerances: min-plus over integer weights is exact; the engine's PageRank
keeps the reference's own engine parity, ``rtol=1e-6, atol=1e-7``;
``recursion.pagerank`` and the ELL SpMV keep the reference's kernel
tolerance, ``rtol=1e-5, atol=1e-6`` (the ELL sums run in another order
than a segment sum).
"""
import numpy as np
import pytest
import torch

from conftest import random_undirected_graph
from repro.core import recursion as jrec
from repro.core import workload as jW
from repro.core.backend import DeviceBackend as JDeviceBackend
from repro.core.backend import NumpyBackend as JNumpyBackend
from repro.core.engine import Engine as JEngine
from repro.core.trie import CSRGraph as JCSRGraph
from repro.data.graphs import powerlaw_graph
from repro.kernels.spmv_ell import ops as jell
from repro_torch.core import recursion as trec
from repro_torch.core.backend import DeviceBackend, NumpyBackend
from repro_torch.core.engine import Engine as TEngine
from repro_torch.core.trie import CSRGraph
from repro_torch.kernels import common
from repro_torch.kernels.spmv_ell import ops as ell

SEEDS = range(5)
KERNEL_TOL = dict(rtol=1e-5, atol=1e-6)
ENGINE_TOL = dict(rtol=1e-6, atol=1e-7)
RECURSION_COUNTERS = ("recursion.device_fixpoints", "recursion.device_rounds",
                      "recursion.host_rounds", "recursion.host_trie_rebuilds")


def random_csr(seed: int, n: int = 60, hub: int = 0):
    """A CSR with ragged rows, isolated vertices, duplicate-free sorted
    neighbours, and ``hub`` rows of 70–130 neighbours (longer than an ELL
    row of 32)."""
    r = np.random.default_rng(seed)
    deg = r.integers(0, 9, n)
    deg[r.integers(0, n, 3)] = 0
    deg[:hub] = r.integers(70, 131, hub)
    rows = [np.sort(r.choice(max(n, 131), size=int(d), replace=False))
            for d in deg]
    offsets = np.concatenate([[0], np.cumsum(deg)]).astype(np.int64)
    neighbors = np.concatenate(rows).astype(np.int32)
    return offsets, neighbors, max(n, 131)


def graphs():
    """The graphs the reference's recursion tests use, one CSR each."""
    src, dst, _ = random_undirected_graph(24, 0.3, 12)
    yield "undirected24", src, dst
    g = powerlaw_graph(300, 8, 2.0, seed=0)
    yield "powerlaw300", np.repeat(np.arange(g.n), np.diff(g.offsets)), \
        g.neighbors


GRAPHS = {name: (src, dst) for name, src, dst in graphs()}


def both_csr(name):
    src, dst = GRAPHS[name]
    return JCSRGraph.from_edges(src, dst), CSRGraph.from_edges(src, dst)


# ------------------------------------------------------------- ELL packing
@pytest.mark.parametrize("seed", SEEDS)
def test_csr_to_ell_matches_reference(seed):
    offsets, neighbors, _ = random_csr(seed)
    vals = np.random.default_rng(seed).random(len(neighbors))
    for args in ((), (vals,), (None, 12)):
        want = jell.csr_to_ell(offsets, neighbors, *args)
        got = ell.csr_to_ell(offsets, neighbors, *args)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError, match="exceeds ELL width"):
        ell.csr_to_ell(offsets, neighbors, k=2)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("width", [1, 4, 32])
def test_split_packing_equals_unsplit(seed, width):
    """Each vertex's split rows, read in order, hold exactly its unsplit
    row's slots; padding is column 0 / weight 0."""
    offsets, neighbors, _ = random_csr(seed, hub=2)
    vals = np.random.default_rng(seed).random(len(neighbors))
    cols_u, vals_u = ell.csr_to_ell(offsets, neighbors, vals)
    cols_s, vals_s, row_ptr = ell.csr_to_ell_split(offsets, neighbors, vals,
                                                   width=width)
    deg = np.diff(offsets)
    assert row_ptr.dtype == np.int32 and cols_s.shape[1] == width
    np.testing.assert_array_equal(np.diff(row_ptr), -(-deg // width))
    for i, d in enumerate(deg):
        c = cols_s[row_ptr[i]:row_ptr[i + 1]].ravel()
        v = vals_s[row_ptr[i]:row_ptr[i + 1]].ravel()
        np.testing.assert_array_equal(c[:d], cols_u[i, :d])
        np.testing.assert_array_equal(v[:d], vals_u[i, :d])
        assert not c[d:].any() and not v[d:].any()


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("weighted", [False, True])
def test_width_one_packing_is_the_csr(seed, weighted):
    """At width 1 the packing is the CSR: one slot per entry, no padding,
    the neighbours as int32 columns and the offsets as int32 ``row_ptr``;
    the weights as given, or 1.0."""
    offsets, neighbors, _ = random_csr(seed, hub=2)
    vals = np.random.default_rng(seed).random(len(neighbors))
    cols, got_vals, row_ptr = ell.csr_to_ell_split(
        offsets, neighbors, vals if weighted else None, width=1)
    assert cols.dtype == row_ptr.dtype == np.int32
    assert got_vals.dtype == np.float32
    assert cols.shape == got_vals.shape == (len(neighbors), 1)
    np.testing.assert_array_equal(cols.ravel(), neighbors)
    np.testing.assert_array_equal(row_ptr, offsets)
    np.testing.assert_array_equal(
        got_vals.ravel(), vals.astype(np.float32) if weighted else 1.0)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("weighted", [False, True])
def test_width_one_shortcut_equals_scatter(seed, weighted):
    """The width-1 packing, a cast of the CSR, holds the same arrays as the
    general packing's scatter at width 1, with the same dtypes."""
    offsets, neighbors, _ = random_csr(seed, hub=2)
    vals = np.random.default_rng(seed).random(len(neighbors))
    vals = vals if weighted else None
    got = ell.csr_to_ell_split(offsets, neighbors, vals, width=1)
    want = ell._scatter_split(offsets, neighbors, vals, 1)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


# ------------------------------------------------------------ spmv_ell plain
def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("seed", SEEDS)
def test_spmv_plain_matches_jax_interpret(seed):
    """The wrapper's CPU path (its plain version) against the JAX
    package's ``spmv_ell`` in interpret mode, on the reference's packing
    and on the port's split (width 32) and width-1 packings of the same
    rows."""
    offsets, neighbors, nx = random_csr(seed, hub=2)
    r = np.random.default_rng(seed)
    vals = r.random(len(neighbors)).astype(np.float32)
    x = r.random(nx).astype(np.float32)
    cols_u, vals_u = ell.csr_to_ell(offsets, neighbors, vals)
    want = np.asarray(jell.spmv_ell(cols_u, vals_u, x, interpret=True))
    n = len(offsets) - 1
    before = common.LAUNCHES[ell.NAME]
    got_u = ell.spmv_ell(_t(cols_u), _t(vals_u),
                         torch.arange(n + 1, dtype=torch.int32), _t(x))
    got_s, got_1 = (ell.spmv_ell(*map(_t, ell.csr_to_ell_split(
        offsets, neighbors, vals, width=w)), _t(x)) for w in (32, 1))
    assert common.LAUNCHES[ell.NAME] == before   # the plain version
    for got in (got_u, got_s, got_1):
        assert got.dtype == torch.float32 and got.shape == (n,)
        np.testing.assert_allclose(got.numpy(), want, **KERNEL_TOL)


def test_spmv_wrapper_checks():
    cols = torch.zeros((3, 32), dtype=torch.int32)
    vals = torch.zeros((3, 32), dtype=torch.float32)
    row_ptr = torch.tensor([0, 1, 3], dtype=torch.int32)
    x = torch.ones(4)
    assert ell.spmv_ell(cols, vals, row_ptr, x).shape == (2,)
    with pytest.raises(TypeError):
        ell.spmv_ell(cols.long(), vals, row_ptr, x)
    with pytest.raises(TypeError):
        ell.spmv_ell(cols, vals.double(), row_ptr, x)
    with pytest.raises(ValueError, match="differ"):
        ell.spmv_ell(cols, vals[:2], row_ptr, x)
    with pytest.raises(ValueError, match="rank"):
        ell.spmv_ell(cols.ravel(), vals, row_ptr, x)
    with pytest.raises(ValueError, match="device"):
        ell.spmv_ell(cols, vals, row_ptr, x.to("meta"))


# ----------------------------------------------------------------- pagerank
@pytest.mark.parametrize("graph", sorted(GRAPHS))
@pytest.mark.parametrize("iters", [1, 4])
def test_pagerank_ell_under_device_backend(graph, iters):
    """Both packages' ``pagerank`` under their device backend take the
    ELL SpMV, count it the same, and agree with ``pagerank_np``."""
    jcsr, tcsr = both_csr(graph)
    jb, tb = JDeviceBackend(), DeviceBackend(device="cpu")
    want = jrec.pagerank(jcsr, iters=iters, backend=jb)
    got = trec.pagerank(tcsr, iters=iters, backend=tb)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, **KERNEL_TOL)
    np.testing.assert_allclose(got, trec.pagerank_np(tcsr, iters=iters),
                               **KERNEL_TOL)
    np.testing.assert_array_equal(trec.pagerank_np(tcsr, iters=iters),
                                  jrec.pagerank_np(jcsr, iters=iters))
    assert tb.stats["spmv.ell_kernel"] == jb.stats["spmv.ell_kernel"] == iters


@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_pagerank_packs_at_width_one(graph, monkeypatch):
    """Under the device backend ``pagerank`` hands the ELL SpMV the CSR
    itself (width 1, one slot per edge, ``row_ptr`` = the offsets), once
    per iteration, and still agrees with the reference."""
    jcsr, tcsr = both_csr(graph)
    calls = []

    def spy(cols, vals, row_ptr, x):
        calls.append((tuple(cols.shape), row_ptr.numpy().copy()))
        return spmv_ell(cols, vals, row_ptr, x)

    spmv_ell = ell.spmv_ell
    monkeypatch.setattr(ell, "spmv_ell", spy)
    tb = DeviceBackend(device="cpu")
    got = trec.pagerank(tcsr, iters=3, backend=tb)
    assert [shape for shape, _ in calls] == [(tcsr.m, 1)] * 3
    for _, row_ptr in calls:
        np.testing.assert_array_equal(row_ptr, tcsr.offsets)
    assert tb.stats["spmv.ell_kernel"] == 3
    np.testing.assert_allclose(
        got, jrec.pagerank(jcsr, iters=3, backend=JDeviceBackend()),
        **KERNEL_TOL)


@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_pagerank_segment_sum_path(graph):
    """Without a device backend both take the segment-sum SpMV (the port
    on the device it is given) and count no ELL round."""
    jcsr, tcsr = both_csr(graph)
    want = jrec.pagerank(jcsr, iters=5, backend=JNumpyBackend())
    tb = NumpyBackend()
    got = trec.pagerank(tcsr, iters=5, backend=tb)
    np.testing.assert_allclose(got, want, **KERNEL_TOL)
    np.testing.assert_allclose(trec.pagerank(tcsr, iters=5, device="cpu"),
                               want, **KERNEL_TOL)
    assert tb.stats.get("spmv.ell_kernel", 0) == 0


# --------------------------------------------------------------------- sssp
@pytest.mark.parametrize("graph", sorted(GRAPHS))
@pytest.mark.parametrize("weighted", [False, True])
def test_sssp_matches_reference(graph, weighted):
    jcsr, tcsr = both_csr(graph)
    w = (np.random.default_rng(1).integers(0, 4, tcsr.m).astype(np.float32)
         if weighted else None)
    for source in (int(tcsr.neighbors[0]), 0):
        want = np.asarray(jrec.sssp(jcsr, source, w))
        got = trec.sssp(tcsr, source, w, device="cpu")
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(trec.sssp_np(tcsr, source, w),
                                      jrec.sssp_np(jcsr, source, w))
        np.testing.assert_array_equal(got, trec.sssp_np(tcsr, source, w))


def test_sssp_long_line_reads_once_per_block():
    """A 30-vertex path needs 30 rounds (the last finds nothing): the
    distances are exact, and ``max_iters`` caps the rounds as the
    reference's does."""
    n = 30
    line = CSRGraph.from_edges(np.arange(n - 1), np.arange(1, n), n=n)
    jline = JCSRGraph.from_edges(np.arange(n - 1), np.arange(1, n), n=n)
    np.testing.assert_array_equal(trec.sssp(line, 0, device="cpu"),
                                  np.arange(n, dtype=np.float32))
    for cap in (3, 8, 9, 17):
        np.testing.assert_array_equal(
            trec.sssp(line, 0, max_iters=cap, device="cpu"),
            np.asarray(jrec.sssp(jline, 0, max_iters=cap)))


def test_sssp_np_oracle_cases():
    csr = CSRGraph.from_edges([0, 1, 2], [1, 2, 0], n=3)
    with pytest.raises(ValueError, match="negative cycle"):
        trec.sssp_np(csr, 0, np.array([1.0, -2.0, 0.5], np.float32))
    dag = CSRGraph.from_edges([0, 1, 0], [1, 2, 2], n=3)
    np.testing.assert_allclose(
        trec.sssp_np(dag, 0, np.array([2.0, -1.5, 1.0], np.float32)),
        [0.0, 2.0, -1.5])


# ----------------------------------------------------------------- fixpoint
def test_fixpoint_tolerance_counters_match_reference():
    import jax.numpy as jnp
    c = np.array([1.0, 2.0, 3.0, 4.0], np.float32)
    jb, tb = JDeviceBackend(), DeviceBackend(device="cpu")
    want = jrec.fixpoint(lambda x: 0.5 * (x + jnp.asarray(c)),
                         jnp.zeros(4), tol=1e-5, backend=jb)
    ct = torch.from_numpy(c)
    got = trec.fixpoint(lambda x: 0.5 * (x + ct), torch.zeros(4), tol=1e-5,
                        backend=tb)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for k in ("fixpoint.host_syncs", "fixpoint.steps"):
        assert tb.stats[k] == jb.stats[k], k
    assert tb.stats["fixpoint.host_syncs"] < tb.stats["fixpoint.steps"]


@pytest.mark.parametrize("check_every", [1, 3, 8])
def test_fixpoint_tolerance_blocks_return_first_converged(check_every):
    c = torch.tensor([1.0, 2.0, 3.0, 4.0])
    b = NumpyBackend()
    got = trec.fixpoint(lambda x: 0.5 * (x + c), torch.zeros(4), tol=1e-3,
                        check_every=check_every, backend=b)
    x, steps = torch.zeros(4), 0
    while True:
        nx = 0.5 * (x + c)
        steps += 1
        done = float((nx - x).abs().max()) <= 1e-3
        x = nx
        if done:
            break
    assert torch.equal(got, x)
    assert b.stats["fixpoint.steps"] == steps


def test_fixpoint_fixed_iters_counts_steps():
    jb, tb = JNumpyBackend(), NumpyBackend()
    want = jrec.fixpoint(lambda x: x + 1.0, np.float32(0.0), iters=5,
                         backend=jb)
    got = trec.fixpoint(lambda x: x + 1.0, np.float32(0.0), iters=5,
                        backend=tb)
    assert float(got) == float(want) == 5.0
    assert tb.stats["fixpoint.steps"] == jb.stats["fixpoint.steps"] == 5
    assert tb.stats.get("fixpoint.host_syncs", 0) == 0
    with pytest.raises(ValueError):
        trec.fixpoint(lambda x: x, np.float32(0.0))


# ------------------------------------------------------------------- engine
def make_engines(src, dst, annotation=None):
    out = []
    for eng in (JEngine(backend="device"),
                TEngine(backend="device", device="cpu"),
                TEngine(backend="numpy")):
        eng.load_edges("Edge", src, dst, annotation=annotation)
        for a in jW.ALIASES:
            eng.alias(a, "Edge")
        out.append(eng)
    return out


def assert_same(got, want, exact):
    assert got.vars == want.vars
    for v in got.vars:
        np.testing.assert_array_equal(got.columns[v], want.columns[v])
        assert got.columns[v].dtype == want.columns[v].dtype
    if exact:
        np.testing.assert_array_equal(got.annotation, want.annotation)
    else:
        np.testing.assert_allclose(got.annotation, want.annotation,
                                   **ENGINE_TOL)


PAGERANK_TOL = ("N(;w:int) :- Edge(x,y); w=<<COUNT(x)>>.\n"
                "InvDeg(x;y:float) :- Edge(x,z); y=1.0/<<COUNT(z)>>.\n"
                "PageRank(x;y:float) :- Edge(x,z); y=1.0/N.\n"
                "PageRank(x;y:float)*[c=0.0001] :- Edge(x,z),PageRank(z),"
                "InvDeg(z); y=0.15/N+0.85*<<SUM(z)>>.")
PROGRAMS = {"pagerank_i8": (jW.pagerank_program(iters=8), False, "naive"),
            "pagerank_c": (PAGERANK_TOL, False, "naive"),
            "sssp": (jW.sssp_program("{s}"), True, "seminaive")}


@pytest.mark.parametrize("graph", sorted(GRAPHS))
@pytest.mark.parametrize("prog", sorted(PROGRAMS))
def test_engine_recursion_matches_reference(graph, prog):
    """The port's device engine on the CPU against the JAX device engine:
    results, recursion counters and plan metadata equal; the port's host
    oracle agrees and ran its rounds on the host."""
    src, dst = GRAPHS[graph]
    text, exact, strategy = PROGRAMS[prog]
    q = text.replace("{s}", str(int(src[0])))
    je, te, he = make_engines(src, dst)
    jres, tres, hres = je.query(q), te.query(q), he.query(q)
    assert_same(tres, jres, exact)
    assert_same(hres, tres, exact)
    assert tres.as_dict().keys() == jres.as_dict().keys()
    jd, td, hd = (e.dispatch_summary() for e in (je, te, he))
    for k in RECURSION_COUNTERS:
        assert td.get(k, 0) == jd.get(k, 0), k
    assert td["recursion.device_fixpoints"] == 1
    assert td.get("recursion.host_rounds", 0) == 0
    assert hd["recursion.host_rounds"] == td["recursion.device_rounds"]
    assert hd.get("recursion.device_fixpoints", 0) == 0
    rounds = td["recursion.device_rounds"]
    if prog == "pagerank_i8":
        assert td.get("recursion.host_reads", 0) == 0
    else:
        assert td["recursion.host_reads"] == (rounds - 1) // trec.CHECK_EVERY + 1
    assert te.plan_metadata() == je.plan_metadata()
    rec = [m["recursion"] for m in te.plan_metadata() if "recursion" in m]
    assert rec == [{"mode": "device", "strategy": strategy,
                    "rounds": rounds}]


def random_weighted_digraph(seed: int, n: int):
    """Directed multigraph with self-loops, zero-weight and duplicate
    edges and vertices never drawn; integer-valued float32 weights keep
    min-plus arithmetic exact."""
    r = np.random.default_rng(seed)
    m = int(r.integers(1, 3 * n + 1))
    return (r.integers(0, n, m), r.integers(0, n, m),
            r.integers(0, 4, m).astype(np.float32))


@pytest.mark.parametrize("seed", range(8))
def test_engine_seminaive_on_random_weighted_digraphs(seed):
    n = 1 + seed * 3
    src, dst, w = random_weighted_digraph(seed, n)
    q = (f"D(x;y:float) :- Edge({int(src[0])},x); y=1.\n"
         "D(x;y:float)* :- Edge(u,x),D(u); y=<<MIN(u)>>.")
    je, te, he = make_engines(src, dst, annotation=w)
    jres, tres = je.query(q), te.query(q)
    assert_same(tres, jres, exact=True)
    assert_same(he.query(q), tres, exact=True)
    jd, td = je.dispatch_summary(), te.dispatch_summary()
    for k in RECURSION_COUNTERS:
        assert td.get(k, 0) == jd.get(k, 0), k
    assert td.get("recursion.host_trie_rebuilds", 0) == 0


@pytest.mark.parametrize("seed", range(6))
def test_engine_naive_on_random_digraphs(seed):
    src, dst, _ = random_weighted_digraph(seed, 2 + seed * 3)
    q = jW.pagerank_program(iters=1 + seed % 6)
    je, te, he = make_engines(src, dst)
    jres, tres = je.query(q), te.query(q)
    assert_same(tres, jres, exact=False)
    assert_same(he.query(q), tres, exact=False)
    assert (te.dispatch_summary()["recursion.device_rounds"]
            == je.dispatch_summary()["recursion.device_rounds"])


def test_engine_single_node_self_loop():
    je, te, he = make_engines(np.array([0]), np.array([0]))
    q = jW.sssp_program(0)
    jres = je.query(q)
    assert_same(te.query(q), jres, exact=True)
    assert_same(he.query(q), jres, exact=True)


def test_non_spmv_shape_takes_the_host_loop_in_both():
    """A seminaive rule with a unary extra atom is outside the SpMV shape:
    both device engines take the host loop and agree exactly."""
    src, dst, _ = random_undirected_graph(18, 0.3, 11)
    allowed = np.unique(src)[::2].astype(np.int64)
    q = (f"SSSP(x;y:int) :- Edge({int(src[0])},x); y=1.\n"
         "SSSP(x;y:int)* :- Edge(w,x),SSSP(w),Allowed(w); y=<<MIN(w)>>+1.")
    engines = make_engines(src, dst)
    for eng in engines:
        eng.load_table("Allowed", [allowed])
    jres, tres, hres = (e.query(q) for e in engines)
    assert_same(tres, jres, exact=True)
    assert_same(hres, jres, exact=True)
    jd, td = engines[0].dispatch_summary(), engines[1].dispatch_summary()
    assert td["recursion.host_rounds"] == jd["recursion.host_rounds"] > 0
    assert (td["recursion.host_trie_rebuilds"]
            == jd["recursion.host_trie_rebuilds"])
    assert td.get("recursion.device_fixpoints", 0) == 0


def test_prepare_refuses_a_recursive_rule():
    src, dst = GRAPHS["undirected24"]
    for eng in make_engines(src, dst)[:2]:
        with pytest.raises(ValueError, match="recursive"):
            eng.prepare("SSSP(x;y:int)* :- Edge(w,x),SSSP(w); "
                        "y=<<MIN(w)>>+1.")
