"""The materializing bitset intersection of the port against the JAX
package: ``repro_torch.kernels.materialize``'s plain version (the
wrapper's CPU path) equals the JAX ``bitset_pair_materialize`` (Pallas in
interpret mode) and both packages' host extraction exactly — pair ids,
values, both ranks, and their order — on ``BlockedBitset``s built from the
same seeded CSR; its plane oracle equals the JAX ``bitset_materialize_ref``;
and the wrapper checks its arguments and launches nothing on the CPU."""
import numpy as np
import pytest
import torch

from repro.core import intersect as jI
from repro.kernels.materialize import ops as jax_mat
from repro.kernels.materialize.ref import bitset_materialize_ref as jax_ref
from repro_torch.core import intersect as tI
from repro_torch.kernels import common
from repro_torch.kernels.materialize import ops as mat_ops
from repro_torch.kernels.materialize.ref import (HEADER,
                                                  bitset_materialize_ref,
                                                  buffer_records,
                                                  buffer_total,
                                                  materialize_ref)


def t32(x):
    return torch.as_tensor(np.ascontiguousarray(x, dtype=np.int32))


def random_csr(seed, n=400, max_deg=120, universe=None):
    """Sorted unique neighbour sets, denser for the first half of the ids
    (so the dense cohort spans several blocks per set)."""
    r = np.random.default_rng(seed)
    universe = universe or n
    rows = []
    for i in range(n):
        k = int(r.integers(0, max_deg if i < n // 2 else max_deg // 8))
        rows.append(np.sort(r.choice(universe, size=min(k, universe),
                                     replace=False)))
    offs = np.concatenate([[0], np.cumsum([len(x) for x in rows])])
    return offs.astype(np.int64), np.concatenate(rows).astype(np.int32)


def both_bitsets(offs, nbr, ids, n, block_bits):
    return (jI.build_blocked_bitset(offs, nbr, ids, n, block_bits),
            tI.build_blocked_bitset(offs, nbr, ids, n, block_bits))


def port_materialize(tbs, a, b):
    return mat_ops.bitset_pair_materialize(
        tbs, a, b, t32(tbs.words.view(np.int32)), t32(tbs.block_ids),
        t32(tbs.index))


def assert_equal_tuples(got, want):
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype, (g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("block_bits", [256, 1024, 2048])
@pytest.mark.parametrize("seed", range(3))
def test_plain_version_matches_jax(seed, block_bits):
    offs, nbr = random_csr(seed, universe=3000)
    n = len(offs) - 1
    ids = np.flatnonzero(np.diff(offs) > 0)
    jbs, tbs = both_bitsets(offs, nbr, ids, 3000, block_bits)
    np.testing.assert_array_equal(tbs.words, jbs.words)
    r = np.random.default_rng(100 + seed)
    a, b = r.integers(0, len(ids), (2, 600))
    before = dict(common.LAUNCHES)
    got = port_materialize(tbs, a, b)
    assert dict(common.LAUNCHES) == before     # CPU: no kernel launch
    want = jax_mat.bitset_pair_materialize(jbs, a, b, interpret=True)
    assert_equal_tuples(got, want)
    assert_equal_tuples(got, jI.bitset_intersect_materialize(jbs, a, b))
    assert_equal_tuples(got, tI.bitset_intersect_materialize(
        tbs, a, b, t32(tbs.block_ids)))
    assert len(got[0]) > 0 and n > 0


def test_order_is_pair_major_values_ascending():
    offs, nbr = random_csr(7, universe=2000)
    ids = np.flatnonzero(np.diff(offs) > 0)
    jbs, tbs = both_bitsets(offs, nbr, ids, 2000, 256)
    r = np.random.default_rng(7)
    a, b = r.integers(0, len(ids), (2, 300))
    pid, vals, ra, rb = port_materialize(tbs, a, b)
    assert np.all(np.diff(pid) >= 0)
    same = pid[1:] == pid[:-1]
    assert np.all(np.diff(vals)[same] > 0)
    # each match is an element of both sets, at its rank in each
    for i in range(len(pid)):
        sa = nbr[offs[ids[a[pid[i]]]]:offs[ids[a[pid[i]]] + 1]]
        sb = nbr[offs[ids[b[pid[i]]]]:offs[ids[b[pid[i]]] + 1]]
        assert sa[ra[i]] == vals[i] == sb[rb[i]]
    want = jax_mat.bitset_pair_materialize(jbs, a, b, interpret=True)
    assert_equal_tuples((pid, vals, ra, rb), want)


@pytest.mark.parametrize("case", ["no_pairs", "no_shared_block",
                                  "empty_intersection"])
def test_empty_cases(case):
    """No pairs at all, pairs whose sets share no block, and pairs whose
    shared blocks AND to nothing: empty results of the reference's dtypes
    from both packages."""
    # set 0: {0..9}, set 1: {1000..1009}, set 2: {10..19} (same block as 0)
    rows = [np.arange(10), np.arange(1000, 1010), np.arange(10, 20)]
    offs = np.concatenate([[0], np.cumsum([len(x) for x in rows])])
    nbr = np.concatenate(rows).astype(np.int32)
    ids = np.arange(3)
    jbs, tbs = both_bitsets(offs.astype(np.int64), nbr, ids, 1100, 256)
    a, b = {"no_pairs": ([], []), "no_shared_block": ([0, 1], [1, 2]),
            "empty_intersection": ([0, 2], [2, 0])}[case]
    a, b = np.asarray(a, np.int64), np.asarray(b, np.int64)
    got = port_materialize(tbs, a, b)
    want = jax_mat.bitset_pair_materialize(jbs, a, b, interpret=True)
    assert_equal_tuples(got, want)
    assert len(got[0]) == 0


@pytest.mark.parametrize("seed", range(3))
def test_plane_oracle_matches_jax(seed):
    r = np.random.default_rng(seed)
    ba = r.integers(0, 2, size=(64, 256)).astype(np.int32)
    bb = r.integers(0, 2, size=(64, 256)).astype(np.int32)
    got = bitset_materialize_ref(torch.from_numpy(ba), torch.from_numpy(bb))
    want = jax_ref(ba, bb)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_buffer_layout_and_capacity():
    """The plain version's buffer: the int64 total in its own slot, then
    ``cap`` records of 16 bytes (pair id, value, rank a, rank b), zero
    past the total; a bound below the total raises."""
    offs, nbr = random_csr(3, universe=1500)
    ids = np.flatnonzero(np.diff(offs) > 0)
    _, tbs = both_bitsets(offs, nbr, ids, 1500, 256)
    a, b = np.arange(len(ids)), np.arange(len(ids))[::-1].copy()
    pair_id, _, pa, pb = tI.intersect_pairs_uint(
        tbs.offsets, tbs.block_ids, a, b, t32(tbs.block_ids))
    cap = int(np.minimum(tbs.card[pa], tbs.card[pb]).sum())
    args = (t32(tbs.words.view(np.int32)), t32(tbs.block_ids),
            t32(tbs.index), t32(pa), t32(pb), t32(pair_id))
    buf = mat_ops.materialize(*args, cap)
    assert buf.dtype == torch.int32 and buf.shape == (HEADER + 4 * cap,)
    total = int(buffer_total(buf)[0])
    assert 0 < total <= cap
    assert int(buf[:2].numpy().view(np.int64)[0]) == total
    assert not buf[2:HEADER].any()
    rec = buffer_records(buf).numpy()
    assert rec.shape == (cap, 4) and rec.nbytes == 16 * cap
    assert not rec[total:].any()
    want = int(tI.popcount_u32_np(tbs.words[pa] & tbs.words[pb]).sum())
    assert total == want
    host = tI.bitset_intersect_materialize(tbs, a, b, t32(tbs.block_ids))
    assert_equal_tuples(tuple(rec[:total, i] for i in range(4)),
                        tuple(x.astype(np.int32) for x in host))
    with pytest.raises(ValueError, match="capacity"):
        materialize_ref(*args, total - 1)


def test_pair_materialize_checks_the_total_against_cap(monkeypatch):
    """``bitset_pair_materialize`` reads the total first and raises when
    it passes the buffer's capacity, as the plain version does; a
    capacity equal to the total is enough.  The buffers stand for what
    the kernel leaves at a capacity of ``cap``: the first ``cap`` records
    and the whole total."""
    offs, nbr = random_csr(5, universe=2000)
    ids = np.flatnonzero(np.diff(offs) > 0)
    _, tbs = both_bitsets(offs, nbr, ids, 2000, 256)
    r = np.random.default_rng(5)
    a, b = r.integers(0, len(ids), (2, 300))
    want = port_materialize(tbs, a, b)
    total = len(want[0])
    assert total > 0
    orig = mat_ops.materialize

    def kernel_with_cap(cap):
        def run(*args):
            return orig(*args)[:HEADER + 4 * cap].clone()
        return run

    monkeypatch.setattr(mat_ops, "materialize", kernel_with_cap(total))
    assert_equal_tuples(port_materialize(tbs, a, b), want)
    monkeypatch.setattr(mat_ops, "materialize", kernel_with_cap(total - 1))
    with pytest.raises(ValueError, match="capacity"):
        port_materialize(tbs, a, b)


def test_wrapper_checks_its_arguments():
    w = torch.zeros((4, 8), dtype=torch.int32)
    i = torch.zeros(3, dtype=torch.int32)
    blk = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(TypeError):
        mat_ops.materialize(w.long(), blk, blk, i, i, i, 8)
    with pytest.raises(ValueError, match="shape"):
        mat_ops.materialize(w, blk, blk, i, i[:2], i, 8)
    with pytest.raises(ValueError, match="cap"):
        mat_ops.materialize(w, blk, blk, i, i, i, -1)
