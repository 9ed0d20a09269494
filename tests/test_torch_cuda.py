"""The port's CUDA kernels on the card: each kernel bit-equal to its plain
PyTorch version, one launch counted per launch, no plain fallback for a
CUDA tensor, and the device engine on the card equal to the same engine
on the CPU.  Marked ``cuda``; every test skips without a card.  Run on a
machine with one: ``PYTHONPATH=src python -m pytest -q -m cuda
tests/test_torch_cuda.py``."""
import numpy as np
import pytest
import torch

from repro_torch.core import workload as W
from repro_torch.core.engine import Engine
from repro_torch.data.graphs import edge_list, powerlaw_graph
from repro_torch.kernels import common
from repro_torch.kernels.bitset_intersect import ops as bitset_ops
from repro_torch.kernels.bitset_intersect.ref import bitset_and_popcount_ref
from repro_torch.kernels.frontier_fill import ops as fill_ops
from repro_torch.kernels.frontier_fill.ref import fill_ref, fold_ref
from repro_torch.kernels.uint_intersect import ops as uint_ops
from repro_torch.kernels.uint_intersect.ref import intersect_count_csr_ref

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's kernels have no "
                    "interpret mode)")
    return torch.device("cuda")


def t32(x, dev):
    return torch.as_tensor(np.ascontiguousarray(x, dtype=np.int32),
                           device=dev)


@pytest.mark.parametrize("seed", range(4))
def test_bitset_kernel_matches_plain(dev, seed):
    r = np.random.default_rng(seed)
    words = r.integers(0, 1 << 32, size=(500, 8), dtype=np.uint32)
    pa, pb = r.integers(0, 500, (2, 10_000 + seed))
    args = (t32(words.view(np.int32), dev), t32(pa, dev), t32(pb, dev))
    before = common.LAUNCHES["bitset_intersect"]
    got = bitset_ops.bitset_and_popcount(*args)
    assert common.LAUNCHES["bitset_intersect"] == before + 1
    assert torch.equal(got, bitset_and_popcount_ref(*args))


@pytest.mark.parametrize("seed", range(4))
def test_uint_kernel_matches_plain(dev, seed):
    r = np.random.default_rng(seed)
    rows = [np.sort(r.choice(3000, size=int(r.integers(0, 257)),
                             replace=False)) for _ in range(300)]
    offs = np.concatenate([[0], np.cumsum([len(x) for x in rows])])
    nbr = np.concatenate(rows)
    u, v = r.integers(0, 300, (2, 5000))
    args = (t32(offs, dev), t32(nbr, dev), t32(u, dev), t32(v, dev))
    got = uint_ops.intersect_count_csr(*args)
    assert torch.equal(got, intersect_count_csr_ref(*args))
    want = [len(np.intersect1d(rows[a], rows[b])) for a, b in zip(u, v)]
    np.testing.assert_array_equal(got.cpu().numpy(), want)


@pytest.mark.parametrize("seed", range(4))
def test_fill_kernel_matches_plain(dev, seed):
    r = np.random.default_rng(seed)
    cap_in, n0 = 300, 5000
    seed_vals = np.sort(r.choice(20000, size=n0, replace=False))
    lo0 = r.integers(0, n0 - 50, cap_in)
    cnt = r.integers(0, 50, cap_in)
    offs = np.cumsum(cnt) - cnt
    total = int(cnt.sum()) - seed * 7
    probes = []
    for k in range(seed % 3 + 1):
        vk = np.sort(r.choice(20000, size=4000, replace=False))
        lo = r.integers(0, 3000, cap_in)
        probes.append((t32(vk, dev), t32(lo, dev),
                       t32(lo + r.integers(0, 1000, cap_in), dev)))
    args = (torch.tensor(total, dtype=torch.int32, device=dev),
            t32(offs, dev), t32(lo0, dev), t32(seed_vals, dev),
            tuple(probes), seed * 5, 16384)
    got = fill_ops.fill(*args)
    want = fill_ref(*args)
    for a, b in zip(got[:4], want[:4]):
        assert torch.equal(a, b)
    for a, b in zip(got[4], want[4]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("srname", ["count", "sum_f32", "min_plus",
                                    "boolean"])
def test_fold_kernel_matches_plain(dev, srname):
    from repro_torch.core import semiring as S

    sr = S.BY_NAME[srname]
    r = np.random.default_rng(3)
    cap_in, n0 = 2000, 8000
    seed_vals = np.sort(r.choice(30000, size=n0, replace=False))
    lo0 = r.integers(0, n0 - 400, cap_in)
    cnt = r.integers(0, 400, cap_in)
    probes, anns = [], [None]
    for _ in range(2):
        vk = np.sort(r.choice(30000, size=6000, replace=False))
        lo = r.integers(0, 3000, cap_in)
        probes.append((t32(vk, dev), t32(lo, dev),
                       t32(lo + r.integers(0, 3000, cap_in), dev)))
        anns.append(torch.as_tensor(r.integers(0, 3, 6000), device=dev)
                    .to(sr.dtype))
    args = (t32(lo0, dev), t32(cnt, dev), t32(seed_vals, dev),
            tuple(probes), tuple(anns), sr)
    before = common.LAUNCHES["frontier_fold"]
    folded, supp = fill_ops.fold(*args)
    assert common.LAUNCHES["frontier_fold"] == before + 1
    want, want_supp = fold_ref(*args)
    assert torch.equal(supp, want_supp)
    if srname == "sum_f32":   # reduction order differs: float tolerance
        torch.testing.assert_close(folded, want, rtol=1e-6, atol=0)
    else:
        assert torch.equal(folded, want)


def test_cuda_tensor_never_takes_the_plain_version(dev):
    words = torch.zeros((4, 8), dtype=torch.int64, device=dev)
    pos = torch.zeros(3, dtype=torch.int32, device=dev)
    with pytest.raises(TypeError):
        bitset_ops.bitset_and_popcount(words, pos, pos)


@pytest.mark.parametrize("graph", [(300, 8, 2.0), (5000, 3, 2.5)])
def test_engine_on_card_matches_cpu(dev, graph):
    src, dst = edge_list(powerlaw_graph(*graph, seed=0))
    common.reset_launches()
    for name in ("TRIANGLE_COUNT", "TRIANGLE_LIST", "FOUR_CLIQUE",
                 "LOLLIPOP", "BARBELL"):
        out = []
        for device in ("cuda", "cpu"):
            eng = Engine(backend="device", device=device)
            eng.load_edges("Edge", src, dst)
            for a in W.ALIASES:
                eng.alias(a, "Edge")
            res = eng.query(getattr(W, name))
            summary = {k: v for k, v in eng.dispatch_summary().items()
                       if not k.startswith("upload")}
            out.append((res, summary))
        (gres, gsum), (cres, csum) = out
        assert gsum == csum
        if gres.vars:
            for v in gres.vars:
                np.testing.assert_array_equal(gres.columns[v],
                                              cres.columns[v])
        else:
            assert int(gres.scalar()) == int(cres.scalar())
    assert common.LAUNCHES["frontier_fill"] > 0
    assert common.LAUNCHES["frontier_fold"] > 0
    assert common.LAUNCHES["bitset_intersect"] > 0
    if graph[0] == 5000:
        assert common.LAUNCHES["uint_intersect"] > 0


@pytest.mark.parametrize("q", [
    "P(x;w:float) :- Edge(x,y); w=<<SUM(y)>>.",
    "M(x;w:float) :- Edge(x,y),R(y,z); w=<<MIN(z)>>."])
def test_annotated_fold_on_card_matches_cpu(dev, q):
    """Leaf annotations through frontier_fold on the card: MIN is exact,
    a float SUM may differ in the last place (the warp's reduction order
    is not the CPU's)."""
    src, dst = edge_list(powerlaw_graph(2000, 12, 2.0, seed=0))
    w = np.random.default_rng(0).random(len(src)).astype(np.float32)
    out = []
    for device in ("cuda", "cpu"):
        eng = Engine(backend="device", device=device)
        eng.load_edges("Edge", src, dst, annotation=w)
        eng.alias("R", "Edge")
        out.append(eng.query(q))
    g, c = out
    np.testing.assert_array_equal(g.columns["x"], c.columns["x"])
    np.testing.assert_allclose(g.annotation, c.annotation, rtol=1e-6)
