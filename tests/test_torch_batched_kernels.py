"""The batched forms of the frontier fill and fold on the CPU: the
batched plain versions equal the single-query plain versions stacked
over the batch, on seeded random frontiers that include an empty query
and a query at full capacity, and on anchored batches (every row of a
query probing one shared segment, as the serving path's are); the
wrappers take them on a CPU tensor, check shapes, and a batch of one
equals the single-query entry."""
import numpy as np
import pytest
import torch

from repro_torch.core import semiring as S
from repro_torch.kernels.frontier_fill import ops as fill_ops
from repro_torch.kernels.frontier_fill.batches import anchored_batch
from repro_torch.kernels.frontier_fill.ref import (fill_batched_ref,
                                                   fill_ref,
                                                   fold_batched_ref, fold_ref)

N_OUT = 64   # the fill's output slots per query


def t32(x):
    return torch.as_tensor(np.asarray(x), dtype=torch.int32)


def batch_inputs(seed, batch=6, cap_in=12, n_probes=2, n0=300):
    """B frontiers over shared levels: per-query seed segments, probe
    bounds and exclusive-scan offsets; query 0 has no candidate, query 1
    exactly ``N_OUT`` (full capacity), the others random (some past
    capacity, some rows dead)."""
    r = np.random.default_rng(seed)
    seed_vals = np.sort(r.choice(2000, size=n0, replace=False))
    probes_v = [np.sort(r.choice(2000, size=int(r.integers(100, 900)),
                                 replace=False)) for _ in range(n_probes)]
    lo0 = r.integers(0, n0, (batch, cap_in))
    cnt = np.minimum(r.integers(0, 12, (batch, cap_in)), n0 - lo0)
    cnt[0] = 0
    cnt[1] = 0
    cnt[1, :N_OUT // 8] = 8
    lo0[1] = np.minimum(lo0[1], n0 - 8)
    cnt[2:, ::5] = 0                    # dead rows
    offs = np.cumsum(cnt, 1) - cnt
    total = cnt.sum(1)
    assert total[1] == N_OUT
    probes = []
    for vk in probes_v:
        lo = r.integers(0, len(vk), (batch, cap_in))
        hi = np.minimum(lo + r.integers(0, 400, (batch, cap_in)), len(vk))
        probes.append((t32(vk), t32(lo), t32(hi)))
    return (t32(total), t32(offs), t32(lo0), t32(seed_vals), probes)


def per_query(probes, b):
    return tuple((vk, lo[b], hi[b]) for vk, lo, hi in probes)


def stacked_fill(total, offs, lo0, seed, probes, n):
    outs = [fill_ref(total[b].clamp(max=n), offs[b], lo0[b], seed,
                     per_query(probes, b), 0, n)
            for b in range(offs.shape[0])]
    return ([torch.stack([o[i] for o in outs]) for i in range(4)]
            + [torch.stack([o[4][k] for o in outs])
               for k in range(len(probes))])


def flat_fill(out):
    return list(out[:4]) + list(out[4])


@pytest.mark.parametrize("n_probes", [0, 1, 2])
@pytest.mark.parametrize("seed", range(3))
def test_fill_batched_ref_equals_stacked_fill_ref(seed, n_probes):
    total, offs, lo0, seed_v, probes = batch_inputs(seed, n_probes=n_probes)
    total_c = total.clamp(max=N_OUT)
    got = fill_batched_ref(total_c, offs, lo0, seed_v, probes, N_OUT)
    want = stacked_fill(total, offs, lo0, seed_v, probes, N_OUT)
    for g, w in zip(flat_fill(got), want):
        assert g.shape == (offs.shape[0], N_OUT)
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert not bool(got[3][0].any())            # the empty query keeps none
    assert bool((got[2][1] != 0).any())         # the full one fills all slots
    # the wrapper takes the plain version on a CPU tensor
    via = fill_ops.fill_batched(total_c, offs, lo0, seed_v, probes, N_OUT)
    for g, w in zip(flat_fill(via), want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_fill_batched_of_one_equals_the_single_entry():
    total, offs, lo0, seed_v, probes = batch_inputs(7)
    total_c = total.clamp(max=N_OUT)
    b = 3
    one = fill_ops.fill_batched(total_c[b:b + 1], offs[b:b + 1],
                                lo0[b:b + 1], seed_v,
                                [(v, lo[b:b + 1], hi[b:b + 1])
                                 for v, lo, hi in probes], N_OUT)
    single = fill_ops.fill(total_c[b], offs[b], lo0[b], seed_v,
                           per_query(probes, b), 0, N_OUT)
    for g, w in zip(flat_fill(one), flat_fill(single)):
        torch.testing.assert_close(g[0], w, rtol=0, atol=0)


SEMIRINGS = {"count": S.COUNT, "sum_f32": S.SUM_F32,
             "min_plus": S.MIN_PLUS, "max_min": S.MAX_MIN,
             "boolean": S.BOOLEAN}


@pytest.mark.parametrize("srname", list(SEMIRINGS))
@pytest.mark.parametrize("seed", range(3))
def test_fold_batched_ref_equals_stacked_fold_ref(seed, srname):
    sr = SEMIRINGS[srname]
    total, offs, lo0, seed_v, probes = batch_inputs(seed,
                                                    n_probes=seed % 3)
    r = np.random.default_rng(100 + seed)
    anns = [None] * (len(probes) + 1)
    if seed != 1:
        anns[0] = torch.as_tensor(r.integers(1, 5, len(seed_v))).to(sr.dtype)
        if probes:
            anns[-1] = torch.as_tensor(
                r.integers(1, 5, len(probes[-1][0]))).to(sr.dtype)
    folded, supp = fold_batched_ref(lo0, offs, total, seed_v, probes, anns,
                                    sr)
    assert folded.shape == supp.shape == offs.shape
    for b in range(offs.shape[0]):
        f1, s1 = fold_ref(lo0[b], offs[b], total[b], seed_v,
                          per_query(probes, b), anns, sr)
        torch.testing.assert_close(folded[b], f1, rtol=0, atol=0)
        torch.testing.assert_close(supp[b], s1, rtol=0, atol=0)
    assert int(supp[0].sum()) == 0              # the empty query
    via = fill_ops.fold_batched(lo0, offs, total, seed_v, probes, anns, sr)
    torch.testing.assert_close(via[0], folded, rtol=0, atol=0)
    torch.testing.assert_close(via[1], supp, rtol=0, atol=0)


def test_fold_batched_of_one_equals_the_single_entry():
    total, offs, lo0, seed_v, probes = batch_inputs(5)
    anns = [None] * (len(probes) + 1)
    b = 4
    one = fill_ops.fold_batched(lo0[b:b + 1], offs[b:b + 1],
                                total[b:b + 1], seed_v,
                                [(v, lo[b:b + 1], hi[b:b + 1])
                                 for v, lo, hi in probes], anns, S.COUNT)
    single = fill_ops.fold(lo0[b], offs[b], total[b], seed_v,
                           per_query(probes, b), anns, S.COUNT)
    torch.testing.assert_close(one[0][0], single[0], rtol=0, atol=0)
    torch.testing.assert_close(one[1][0], single[1], rtol=0, atol=0)


def test_batched_wrappers_check_shapes():
    total, offs, lo0, seed_v, probes = batch_inputs(0)
    with pytest.raises(ValueError):          # one query's rows
        fill_ops.fill_batched(total[0], offs[0], lo0[0], seed_v,
                              per_query(probes, 0), N_OUT)
    with pytest.raises(ValueError):          # totals of another batch
        fill_ops.fill_batched(total[:2], offs, lo0, seed_v, probes, N_OUT)
    with pytest.raises(ValueError):          # probe bounds of one query
        fill_ops.fill_batched(total, offs, lo0, seed_v,
                              per_query(probes, 0), N_OUT)
    with pytest.raises(ValueError):          # a batch from a slot past 0
        fill_ops.fill(total, offs, lo0, seed_v, probes, 1, N_OUT)
    anns = [None] * (len(probes) + 1)
    with pytest.raises(ValueError):
        fill_ops.fold_batched(lo0, offs[:, :3], total, seed_v, probes, anns,
                              S.COUNT)
    with pytest.raises(ValueError):          # through the single entry too
        fill_ops.fold(lo0, offs[:, :3], total, seed_v, probes, anns, S.COUNT)


def test_single_entries_hand_a_batch_on():
    """``fill`` and ``fold`` given ``[B, cap_in]`` rows return what
    ``fill_batched`` and ``fold_batched`` return."""
    total, offs, lo0, seed_v, probes = batch_inputs(1)
    total_c = total.clamp(max=N_OUT)
    via = fill_ops.fill(total_c, offs, lo0, seed_v, probes, 0, N_OUT)
    want = fill_ops.fill_batched(total_c, offs, lo0, seed_v, probes, N_OUT)
    for x, y in zip(flat_fill(via), flat_fill(want)):
        assert x.shape[-2:] == (offs.shape[0], N_OUT)
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    anns = [None] * (len(probes) + 1)
    via = fill_ops.fold(lo0, offs, total, seed_v, probes, anns, S.COUNT)
    want = fill_ops.fold_batched(lo0, offs, total, seed_v, probes, anns,
                                 S.COUNT)
    for x, y in zip(via, want):
        torch.testing.assert_close(x, y, rtol=0, atol=0)


def live_segments(total, offs, probes, b):
    """Probe k's distinct (lo, hi) among query b's rows with a
    candidate."""
    ends = torch.cat([offs[b, 1:], total[b:b + 1]])
    live = ends > offs[b]
    return [set(zip(lo[b][live].tolist(), hi[b][live].tolist()))
            for _v, lo, hi in probes]


def test_anchored_batch_shapes():
    """The builder's batches: query 0 without candidate, query 1 at full
    capacity, the empty query's probe segment empty, each anchored query
    one segment a probe (the varied one several), segments of very
    different lengths, and dead rows with bounds of their own."""
    total, offs, lo0, seed_v, probes = anchored_batch(
        4, batch=8, cap_in=48, n_probes=2, varied=(5,))
    assert int(total[0]) == 0
    ends = torch.cat([offs[:, 1:], total[:, None]], 1)
    assert bool((ends[1] > offs[1]).all())              # every row live
    lengths = set()
    for b in range(1, 8):
        segs = live_segments(total, offs, probes, b)
        if b == 5:
            assert len(segs[0]) > 1
            continue
        assert all(len(s) <= 1 for s in segs)
        for s in segs:
            lengths |= {hi - lo for lo, hi in s}
    assert 0 in lengths and max(lengths) >= 100 * max(1, min(lengths - {0}))
    b = next(b for b in range(3, 8) if bool((ends[b] == offs[b]).any())
             and bool((ends[b] > offs[b]).any()))
    dead = ends[b] == offs[b]
    assert set(zip(probes[0][1][b][dead].tolist(),
                   probes[0][2][b][dead].tolist())) - \
        live_segments(total, offs, probes, b)[0]


@pytest.mark.parametrize("annotate", [False, True],
                         ids=["no-annotation", "annotated"])
@pytest.mark.parametrize("srname", list(SEMIRINGS))
def test_fold_batched_ref_on_anchored_batches(srname, annotate):
    """Anchored batches (two probes, one query's segments varied) through
    the batched plain version and the wrapper on the CPU equal the
    single-query plain version query by query, with and without leaf
    annotations on the seed and every probe."""
    sr = SEMIRINGS[srname]
    total, offs, lo0, seed_v, probes = anchored_batch(
        11, batch=7, cap_in=40, n_probes=2, varied=(4,))
    r = np.random.default_rng(7)
    anns = [None] * 3
    if annotate:
        anns = [torch.as_tensor(r.integers(1, 5, len(seed_v))).to(sr.dtype)
                for _ in range(3)]
    folded, supp = fold_batched_ref(lo0, offs, total, seed_v, probes, anns,
                                    sr)
    for b in range(offs.shape[0]):
        f1, s1 = fold_ref(lo0[b], offs[b], total[b], seed_v,
                          per_query(probes, b), anns, sr)
        torch.testing.assert_close(folded[b], f1, rtol=0, atol=0)
        torch.testing.assert_close(supp[b], s1, rtol=0, atol=0)
    assert int(supp[0].sum()) == 0 and int(supp[2].sum()) == 0  # empty probe
    assert int(supp[1].sum()) > 0
    via = fill_ops.fold_batched(lo0, offs, total, seed_v, probes, anns, sr)
    torch.testing.assert_close(via[0], folded, rtol=0, atol=0)
    torch.testing.assert_close(via[1], supp, rtol=0, atol=0)
