"""The dense triangle count of the port against the JAX package:
``repro_torch.kernels.triangle_count_dense`` (the ``triangle_mm``
kernel's plain version on CPU tensors) equals the JAX
``triangle_count_dense`` (Pallas in interpret mode) and
``trace(S^3) / 6`` of the symmetric adjacency exactly, on symmetric
adjacencies (raw / 6) and on their symmetric prunings (raw), with
``densify_csr`` and ``prune_symmetric`` equal to the reference's; and
the wrapper checks its arguments and launches nothing on the CPU."""
import numpy as np
import pytest
import torch

from repro.graph.prune import prune_symmetric as jax_prune
from repro.graph.prune import symmetrize as jax_symmetrize
from repro.kernels.triangle_mm import ops as jax_tri
from repro_torch.graph.prune import prune_symmetric, symmetrize
from repro_torch.kernels import common
from repro_torch.kernels import triangle_count_dense
from repro_torch.kernels.triangle_mm import ops as tri_ops


def random_graph(seed, n, m):
    r = np.random.default_rng(seed)
    return r.integers(0, n, m), r.integers(0, n, m)


def trace_triangles(sym):
    """Triangles of an undirected graph: trace(S^3) / 6 of its symmetric
    adjacency (a pruned DAG has no directed cycle, so its own trace is
    0)."""
    s = np.asarray(sym, np.float64)
    return np.trace(s @ s @ s) / 6.0


@pytest.mark.parametrize("n,m", [(60, 400), (300, 3000), (520, 9000)])
@pytest.mark.parametrize("pruned", [False, True])
def test_dense_count_matches_jax_and_trace(n, m, pruned):
    src, dst = random_graph(n + m, n, m)
    sym = symmetrize(src, dst, n=n)
    jsym = jax_symmetrize(src, dst, n=n)
    g, jg = ((prune_symmetric(sym), jax_prune(jsym)) if pruned
             else (sym, jsym))
    np.testing.assert_array_equal(g.offsets, jg.offsets)
    np.testing.assert_array_equal(g.neighbors, jg.neighbors)
    a = tri_ops.densify_csr(g.offsets, g.neighbors, n)
    np.testing.assert_array_equal(
        a, jax_tri.densify_csr(jg.offsets, jg.neighbors, n))
    symmetric = not pruned
    before = dict(common.LAUNCHES)
    got = triangle_count_dense(a, symmetric=symmetric, device="cpu")
    assert dict(common.LAUNCHES) == before
    assert got.dtype == torch.float32 and got.dim() == 0
    want = np.asarray(jax_tri.triangle_count_dense(a, symmetric=symmetric,
                                                   interpret=True))
    assert want.dtype == np.float32
    assert float(got) == float(want)
    assert float(got) == trace_triangles(
        tri_ops.densify_csr(sym.offsets, sym.neighbors, n))
    assert float(got) > 0


def test_pruned_count_is_the_symmetric_count():
    src, dst = random_graph(9, 400, 6000)
    sym = symmetrize(src, dst, n=400)
    a = tri_ops.densify_csr(sym.offsets, sym.neighbors, 400)
    p = prune_symmetric(sym)
    b = tri_ops.densify_csr(p.offsets, p.neighbors, 400)
    assert float(triangle_count_dense(a, symmetric=True, device="cpu")) == \
        float(triangle_count_dense(b, symmetric=False, device="cpu"))


@pytest.mark.parametrize("block", [128, 256, 512])
def test_padding_to_block_keeps_the_count(block):
    src, dst = random_graph(3, 200, 2500)
    sym = symmetrize(src, dst, n=200)
    a = tri_ops.densify_csr(sym.offsets, sym.neighbors, 200)
    got = triangle_count_dense(torch.from_numpy(a), symmetric=True,
                               block=block)
    want = jax_tri.triangle_count_dense(a, symmetric=True, interpret=True,
                                        block=256)
    assert float(got) == float(want)


def test_raw_count_is_exact_int64():
    a = torch.ones((256, 256), dtype=torch.float32)
    a.fill_diagonal_(0)
    raw = tri_ops.triangle_mm(a)
    assert raw.dtype == torch.int64
    assert int(raw) == 256 * 255 * 254      # ordered triangles of K_256


def test_wrapper_checks_its_arguments():
    with pytest.raises(TypeError):
        tri_ops.triangle_mm(torch.zeros((128, 128), dtype=torch.float64))
    with pytest.raises(ValueError, match="square"):
        tri_ops.triangle_mm(torch.zeros((128, 256), dtype=torch.float32))
    with pytest.raises(ValueError, match="block"):
        triangle_count_dense(torch.zeros((10, 10)), symmetric=True, block=100)

    with pytest.raises(ValueError, match="card"):
        tri_ops.run_passes(torch.zeros((128, 128)),
                           torch.empty(tri_ops.scratch_bytes(128),
                                       dtype=torch.uint8),
                           torch.empty((), dtype=torch.int64), tri_ops.PACK)


@pytest.mark.parametrize("n,want", [(128, 4128), (1152, 332_352),
                                    (16_384, 67_174_400)])
def test_kernel_scratch_is_sized_from_n(n, want):
    """Two bit planes of n^2 / 8 bytes and two bitmaps of occupied 32 x 32
    tiles, nt rows of ceil(nt / 32) words: from n alone."""
    assert tri_ops.scratch_bytes(n) == want


def test_tile_stats_count_what_the_count_pass_visits():
    from repro_torch.kernels.triangle_mm.ref import tile_stats
    r = np.random.default_rng(4)
    a = torch.from_numpy((r.random((256, 256)) < 0.002).astype(np.float32))
    occ = [[bool(a[32 * i:32 * i + 32, 32 * j:32 * j + 32].any())
            for j in range(8)] for i in range(8)]
    triples = sum(occ[i][j] and occ[i][k] and occ[k][j]
                  for i in range(8) for j in range(8) for k in range(8))
    assert tile_stats(a) == (sum(map(sum, occ)), triples)
    assert 0 < triples < 8 ** 3
