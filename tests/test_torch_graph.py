"""The port's graph preprocessing against the JAX package's, on the same
seeded inputs: the seven node orderings of Appendix C.2.1 and
``apply_ordering``, dictionary encoding, the graph and skew statistics,
the Kronecker generator, relation-level layout decisions and the layout
store's statistics.  All of it is host numpy in both packages, so every
array is equal bit for bit (``np.array_equal`` and equal dtypes) and
every statistic exactly."""
import numpy as np
import pytest

import repro.core.layouts as j_layouts
import repro.data.graphs as j_graphs
import repro.graph as j_graph
import repro_torch.core.layouts as t_layouts
import repro_torch.data.graphs as t_graphs
import repro_torch.graph as t_graph
from repro.core.trie import CSRGraph as JCSR
from repro_torch.core.trie import CSRGraph as TCSR

ORDERINGS = ("random", "bfs", "degree", "revdegree", "strongruns", "shingle",
             "hybrid")


def components_graph():
    """Isolated vertices (0, 9, 17, 39), a path, a star, a clique and a
    two-vertex component, with ids interleaved across components."""
    rng = np.random.default_rng(4)
    ids = rng.permutation(np.setdiff1d(np.arange(40), [0, 9, 17, 39]))
    path, star, clique, pair = ids[:8], ids[8:20], ids[20:34], ids[34:36]
    src = list(path[:-1]) + [star[0]] * 11 + [pair[0]]
    dst = list(path[1:]) + list(star[1:]) + [pair[1]]
    for i in range(len(clique)):
        for j in range(i + 1, len(clique)):
            src.append(clique[i])
            dst.append(clique[j])
    return np.asarray(src), np.asarray(dst), 40


def annotated_graph():
    g = j_graphs.powerlaw_graph(300, 6, 2.0, seed=3)
    src = np.repeat(np.arange(g.n), np.diff(g.offsets))
    ann = np.random.default_rng(5).integers(1, 100, size=g.m).astype(
        np.int64)
    return (JCSR.from_edges(src, g.neighbors, n=g.n, annotation=ann),
            TCSR.from_edges(src, g.neighbors, n=g.n, annotation=ann))


def graph_pair(name):
    """The same graph built by each package."""
    if name == "powerlaw":
        return (j_graphs.powerlaw_graph(2000, 12, 2.0, seed=0),
                t_graphs.powerlaw_graph(2000, 12, 2.0, seed=0))
    if name == "kronecker":
        return (j_graphs.kronecker_graph(10, 16, seed=0),
                t_graphs.kronecker_graph(10, 16, seed=0))
    if name == "components":
        src, dst, n = components_graph()
        return (j_graph.symmetrize(src, dst, n=n),
                t_graph.symmetrize(src, dst, n=n))
    return annotated_graph()


def assert_same_array(got, want):
    assert got.dtype == want.dtype
    assert got.shape == want.shape
    assert np.array_equal(got, want)


def assert_same_csr(got, want):
    assert got.n == want.n
    assert_same_array(got.offsets, want.offsets)
    assert_same_array(got.neighbors, want.neighbors)
    if want.annotation is None:
        assert got.annotation is None
    else:
        assert_same_array(got.annotation, want.annotation)


GRAPHS = ("powerlaw", "kronecker", "components", "annotated")


@pytest.mark.parametrize("graph", GRAPHS)
def test_orderings_and_relabel_match(graph):
    jg, tg = graph_pair(graph)
    assert_same_csr(tg, jg)
    assert sorted(t_graph.ORDERINGS) == sorted(j_graph.ORDERINGS) \
        == sorted(ORDERINGS)
    for method in ORDERINGS:
        for seed in (0, 7):
            want = j_graph.order_nodes(jg, method, seed)
            got = t_graph.order_nodes(tg, method, seed)
            assert_same_array(got, want)
            assert np.array_equal(np.sort(got), np.arange(tg.n)), method
        assert_same_csr(t_graph.apply_ordering(tg, got),
                        j_graph.apply_ordering(jg, want))


@pytest.mark.parametrize("graph", GRAPHS)
def test_stats_and_pruning_match(graph):
    jg, tg = graph_pair(graph)
    assert t_graph.graph_stats(tg) == j_graph.graph_stats(jg)
    assert t_graph.density_skew(tg) == j_graph.density_skew(jg)
    perm = t_graph.order_nodes(tg, "degree")
    jp = j_graph.prune_symmetric(j_graph.apply_ordering(jg, perm))
    tp = t_graph.prune_symmetric(t_graph.apply_ordering(tg, perm))
    assert_same_csr(tp, jp)
    assert t_graph.graph_stats(tp) == j_graph.graph_stats(jp)


@pytest.mark.parametrize("scale", [6, 7, 8, 9, 10])
def test_kronecker_graph_matches(scale):
    assert_same_csr(t_graphs.kronecker_graph(scale, 16, seed=scale),
                    j_graphs.kronecker_graph(scale, 16, seed=scale))


@pytest.mark.parametrize("abc,edge_factor", [((0.45, 0.15, 0.15), 8),
                                             ((0.25, 0.25, 0.25), 4),
                                             ((0.6, 0.3, 0.05), 12)])
def test_kronecker_graph_parameters_match(abc, edge_factor):
    a, b, c = abc
    got = t_graphs.kronecker_graph(8, edge_factor, a, b, c, seed=3)
    assert_same_csr(got, j_graphs.kronecker_graph(8, edge_factor, a, b, c,
                                                  seed=3))
    assert got.m > 0


@pytest.mark.parametrize("values", [
    [5, 3, 5, 9, 3, 100, -2, 0],
    ["carol", "alice", "bob", "alice", "dave", "carol"],
])
def test_dictionary_matches(values):
    jd, td = j_graph.Dictionary.build(values), t_graph.Dictionary.build(values)
    assert td.to_value == jd.to_value and td.to_id == jd.to_id
    assert td.size == jd.size
    assert_same_array(td.encode(values), jd.encode(values))
    ids = td.encode(values)
    assert td.decode(ids) == jd.decode(ids) == list(values)
    perm = np.random.default_rng(1).permutation(td.size)
    jr, tr = jd.remap(perm), td.remap(perm)
    assert tr.to_value == jr.to_value and tr.to_id == jr.to_id
    assert_same_array(tr.encode(values), jr.encode(values))


@pytest.mark.parametrize("src,dst", [
    ([10, 20, 10, 30], [20, 30, 40, 10]),
    (["b", "a", "c"], ["a", "d", "b"]),
])
def test_encode_edges_matches(src, dst):
    js, jt, jd = j_graph.encode_edges(src, dst)
    ts, tt, td = t_graph.encode_edges(src, dst)
    assert_same_array(ts, js)
    assert_same_array(tt, jt)
    assert td.to_value == jd.to_value
    # a given dictionary is used as it is
    rs, rt, rd = t_graph.encode_edges(dst, src, td)
    assert rd is td
    assert_same_array(rs, j_graph.encode_edges(dst, src, jd)[0])
    assert_same_array(rt, td.encode(src))


@pytest.mark.parametrize("force", ["uint", "bitset"])
@pytest.mark.parametrize("graph", GRAPHS)
def test_decide_relation_level_matches(graph, force):
    jg, tg = graph_pair(graph)
    want = j_layouts.decide_relation_level(jg, force)
    got = t_layouts.decide_relation_level(tg, force)
    for field in ("dense_ids", "sparse_ids", "inverse_density"):
        assert_same_array(getattr(got, field), getattr(want, field))
    assert got.threshold == want.threshold


@pytest.mark.parametrize("graph", GRAPHS)
def test_store_stats_match(graph):
    jg, tg = graph_pair(graph)
    for threshold in (16, 256, 4096):
        want = j_layouts.HybridSetStore.build(jg, threshold=threshold).stats()
        got = t_layouts.HybridSetStore.build(tg, "cpu",
                                             threshold=threshold).stats()
        assert got == want
    for force in ("uint", "bitset"):
        want = j_layouts.HybridSetStore.build(
            jg, decision=j_layouts.decide_relation_level(jg, force)).stats()
        got = t_layouts.HybridSetStore.build(
            tg, "cpu",
            decision=t_layouts.decide_relation_level(tg, force)).stats()
        assert got == want
        assert got["frac_dense"] == (force == "bitset")
