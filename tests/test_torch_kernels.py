"""Port kernels against the JAX kernels: each ``repro_torch`` kernel's plain
version (the wrapper's CPU path) must equal the JAX package's ``ops``
entry point (Pallas in interpret mode) exactly — every output is int32 —
on the JAX kernels' own contract inputs and on seeded random cases.
The set-pair count ``bitset_pair_count`` is held against the JAX
package's batched entry point of the same name.  Also: the wrappers'
argument checks, and that the CPU path launches no kernel."""
import numpy as np
import pytest
import torch

from repro.kernels.bitset_intersect import ops as jax_bitset
from repro.kernels.frontier_fill import ops as jax_fill
from repro.kernels.uint_intersect import ops as jax_uint
from repro_torch.kernels import common
from repro_torch.kernels.bitset_intersect import ops as bitset_ops
from repro_torch.kernels.frontier_fill import ops as fill_ops
from repro_torch.kernels.uint_intersect import ops as uint_ops

SEEDS = range(6)


def t32(x):
    return torch.as_tensor(np.ascontiguousarray(x, dtype=np.int32))


# ------------------------------------------------------------ bitset_intersect
def _bitset_both(words, pos_a, pos_b):
    want = np.asarray(jax_bitset.bitset_and_popcount(words, pos_a, pos_b,
                                                     interpret=True))
    got = bitset_ops.bitset_and_popcount(t32(words.view(np.int32)),
                                         t32(pos_a), t32(pos_b))
    assert got.dtype == torch.int32
    return got.numpy(), want


def test_bitset_contract_inputs():
    words, pa, pb = jax_bitset._contract_inputs()
    got, want = _bitset_both(words, pa, pb)
    np.testing.assert_array_equal(got, want)
    assert want.sum() > 0


@pytest.mark.parametrize("seed", SEEDS)
def test_bitset_random(seed):
    r = np.random.default_rng(seed)
    n_blocks = int(r.integers(1, 60))
    words = r.integers(0, 1 << 32, size=(n_blocks, 8), dtype=np.uint32)
    # sparse words too, so popcounts vary widely
    words &= r.integers(0, 1 << 32, size=words.shape, dtype=np.uint32)
    p = int(r.integers(1, 400))
    pa = r.integers(0, n_blocks, p)
    pb = r.integers(0, n_blocks, p)
    got, want = _bitset_both(words, pa, pb)
    np.testing.assert_array_equal(got, want)


def _random_bitset(r, n, n_sets):
    """Both packages' blocked bitsets over ``n_sets`` random sets of ids
    below ``n``, of 1 to 1,500 ids each (1 to n/256 blocks)."""
    from repro.core.intersect import build_blocked_bitset as j_build
    from repro_torch.core.intersect import build_blocked_bitset as t_build
    sets = [np.sort(r.choice(n, size=int(r.integers(1, 1500)),
                             replace=False)) for _ in range(n_sets)]
    offs = np.concatenate([[0], np.cumsum([len(x) for x in sets])])
    nbr = np.concatenate(sets).astype(np.int32)
    ids = np.arange(n_sets)
    return j_build(offs, nbr, ids, n), t_build(offs, nbr, ids, n)


@pytest.mark.parametrize("seed", SEEDS)
def test_bitset_pair_count_random(seed):
    """The set-pair count's plain version equal, exactly, to the
    reference's ``bitset_pair_count`` (block matching, then the Pallas
    kernel in interpret mode) on seeded random bitsets."""
    r = np.random.default_rng(seed)
    n = int(r.choice([4096, 20_000, 100_000]))
    jb, tb = _random_bitset(r, n, 40)
    p = int(r.integers(1, 300))
    a, b = r.integers(0, 40, (2, p))
    want = np.asarray(jax_bitset.bitset_pair_count(jb, a, b, interpret=True))
    got = bitset_ops.bitset_pair_count(
        t32(tb.offsets), t32(tb.block_ids), t32(tb.words.view(np.int32)),
        t32(a), t32(b))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.sum() > 0


# -------------------------------------------------------------- uint_intersect
def _csr_of_rows(rows):
    """CSR (int32 offsets, neighbors) whose row i is the valid (>= 0)
    prefix of ``rows[i]``."""
    sets = [r[r >= 0] for r in rows]
    offs = np.zeros(len(sets) + 1, np.int64)
    offs[1:] = np.cumsum([len(s) for s in sets])
    nbr = (np.concatenate(sets) if sets else np.zeros(0)).astype(np.int32)
    return offs, nbr


def test_uint_contract_inputs():
    a, b = jax_uint._contract_inputs()
    want = np.asarray(jax_uint.uint_intersect_count(a, b, interpret=True))
    offs, nbr = _csr_of_rows(list(a) + list(b))
    p = len(a)
    got = uint_ops.intersect_count_csr(t32(offs), t32(nbr),
                                       t32(np.arange(p)),
                                       t32(np.arange(p) + p))
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.sum() > 0


def _uint_random_rows(r):
    """Random sorted sets of up to 256 elements (the kernel's route) and
    random pairs of them, including self-pairs and empty sets."""
    n = int(r.integers(2, 80))
    universe = int(r.integers(8, 1200))
    rows = []
    for _ in range(n):
        k = int(r.integers(0, min(256, universe) + 1))
        rows.append(np.sort(r.choice(universe, size=k, replace=False)))
    p = int(r.integers(1, 300))
    return rows, r.integers(0, n, p), r.integers(0, n, p)


def _uint_runs_rows(r):
    """Shaped like the full-size TRIANGLE_COUNT's call: pairs sorted by
    ``v`` in runs of 1 to 12, the smaller set on either side, the larger
    at most 74 elements."""
    n = 400
    rows = [np.sort(r.choice(3000, size=int(r.integers(0, 75)),
                             replace=False)) for _ in range(n)]
    v = np.repeat(np.sort(r.choice(n, size=60, replace=False)),
                  r.integers(1, 13, 60))
    return rows, r.integers(0, n, len(v)), v


@pytest.mark.parametrize("seed", [*SEEDS, "runs"])
def test_uint_random_csr(seed):
    """Seeded pairs of sorted sets through the JAX CSR entry point and the
    port's: random sets and pairs, and (``runs``) pairs in runs sharing
    ``v`` as the engine's pair fold sends them."""
    if seed == "runs":
        rows, u, v = _uint_runs_rows(np.random.default_rng(100))
    else:
        rows, u, v = _uint_random_rows(np.random.default_rng(seed))
    offs, nbr = _csr_of_rows(rows)
    want = jax_uint.intersect_count_csr_batched(offs, nbr, u, v,
                                                interpret=True)
    got = uint_ops.intersect_count_csr(t32(offs), t32(nbr), t32(u), t32(v))
    np.testing.assert_array_equal(got.numpy(), want)
    expect = [len(np.intersect1d(rows[a], rows[b])) for a, b in zip(u, v)]
    np.testing.assert_array_equal(got.numpy(), expect)


# --------------------------------------------------------------- frontier_fill
def _fill_both(c_count, total, offs, lo0, seed, probes, morsel, c0=0):
    """JAX fill_chunk for chunks c0..c0+c_count-1 against the port's fill
    over the same slot range in one call.  Live slots (j < total) must
    agree in every output; keep must agree everywhere (dead slots:
    False)."""
    outs = [jax_fill.fill_chunk(np.int32(c), np.int32(total), offs, lo0,
                                seed, probes, morsel=morsel, interpret=True)
            for c in range(c0, c0 + c_count)]
    j_vals = np.concatenate([np.asarray(o[0]) for o in outs])
    j_row = np.concatenate([np.asarray(o[1]) for o in outs])
    j_p0 = np.concatenate([np.asarray(o[2]) for o in outs])
    j_keep = np.concatenate([np.asarray(o[3]) for o in outs])
    j_pos = [np.concatenate([np.asarray(o[4][k]) for o in outs])
             for k in range(len(probes))]
    vals, row, p0, keep, poss = fill_ops.fill(
        torch.tensor(total, dtype=torch.int32), t32(offs), t32(lo0),
        t32(seed), tuple((t32(v), t32(lo), t32(hi)) for v, lo, hi in probes),
        c0 * morsel, c_count * morsel)
    live = c0 * morsel + np.arange(c_count * morsel) < total
    np.testing.assert_array_equal(keep.numpy(), j_keep)
    np.testing.assert_array_equal(vals.numpy()[live], j_vals[live])
    np.testing.assert_array_equal(row.numpy()[live], j_row[live])
    np.testing.assert_array_equal(p0.numpy()[live], j_p0[live])
    for k in range(len(probes)):
        np.testing.assert_array_equal(poss[k].numpy()[live], j_pos[k][live])
    for x in (vals, row, p0) + tuple(poss):
        assert x.dtype == torch.int32 and not x.numpy()[~live].any()
    return j_keep


def test_fill_contract_inputs():
    (_c, tc, offs, lo0, seed, v1, l1, h1, v2, l2,
     h2) = jax_fill._contract_inputs()
    keep = _fill_both(1, int(tc), offs, lo0, seed,
                      ((v1, l1, h1), (v2, l2, h2)), jax_fill._CONTRACT_MORSEL)
    assert 0 < keep.sum() < int(tc)


@pytest.mark.parametrize("seed", SEEDS)
def test_fill_random(seed):
    """Random frontier geometry: depth-1 probes with per-row segments,
    a depth-0 probe (the whole level), several chunks, and a capped
    total below the counting-pass sum (the overflow case)."""
    r = np.random.default_rng(seed)
    cap_in = int(r.integers(1, 40))
    n0 = int(r.integers(20, 200))
    seed_vals = np.sort(r.choice(4 * n0, size=n0, replace=False))
    lo0 = r.integers(0, n0, cap_in)
    cnt = np.minimum(r.integers(0, 12, cap_in), n0 - lo0)
    offs = np.cumsum(cnt) - cnt
    total = int(cnt.sum())
    if seed % 2:
        total = max(0, total - int(r.integers(0, 10)))   # capped
    probes = []
    for k in range(1 + seed % 3):
        nk = int(r.integers(10, min(300, 4 * n0)))
        vk = np.sort(r.choice(4 * n0, size=nk, replace=False))
        if k == 0:
            lo = np.zeros(cap_in, np.int64)
            hi = np.full(cap_in, nk, np.int64)
        else:
            lo = r.integers(0, nk, cap_in)
            hi = np.minimum(lo + r.integers(0, 60, cap_in), nk)
        probes.append((vk, lo, hi))
    morsel = 16
    chunks = max(1, -(-total // morsel)) + 1
    _fill_both(chunks, total, offs, lo0, seed_vals, tuple(probes), morsel)


def test_fill_capped_hub_window():
    """A total capped inside a hub row, trailing empty rows and a window
    that starts past slot 0: rows ending past the total and before the
    window, whose slots the fill masks or never reaches."""
    r = np.random.default_rng(11)
    n0 = 400
    seed_vals = np.sort(r.choice(4 * n0, size=n0, replace=False))
    cnt = np.array([5, 0, 9, 150, 7, 0, 3, 12, 0, 0, 0])
    lo0 = np.minimum(r.integers(0, n0, cnt.size), n0 - cnt)
    lo0[3] = 100
    offs = np.cumsum(cnt) - cnt
    total = int(offs[3]) + 70              # capped inside the hub row
    vk = np.sort(r.choice(4 * n0, size=300, replace=False))
    lo = r.integers(0, 200, cnt.size)
    probes = ((vk, np.zeros(cnt.size, np.int64), np.full(cnt.size, 300)),
              (vk, lo, np.minimum(lo + r.integers(0, 120, cnt.size), 300)))
    morsel = 16
    keep = _fill_both(5, total, offs, lo0, seed_vals, probes, morsel, c0=2)
    assert 0 < keep.sum() < total - 2 * morsel


def test_fill_window_offset():
    """A window that starts past slot 0 (a fold's later window) computes
    the same slots as the corresponding slice of one big window."""
    r = np.random.default_rng(7)
    cap_in, n0 = 16, 100
    seed_vals = np.sort(r.choice(400, size=n0, replace=False))
    lo0 = r.integers(0, n0 - 10, cap_in)
    cnt = r.integers(0, 10, cap_in)
    offs = np.cumsum(cnt) - cnt
    total = int(cnt.sum())
    vk = np.sort(r.choice(400, size=150, replace=False))
    probes = ((t32(vk), t32(np.zeros(cap_in)), t32(np.full(cap_in, 150))),)
    args = (torch.tensor(total, dtype=torch.int32), t32(offs), t32(lo0),
            t32(seed_vals), probes)
    whole = fill_ops.fill(*args, 0, total + 8)
    part = fill_ops.fill(*args, 5, total + 3)
    for a, b in zip(whole[:4], part[:4]):
        np.testing.assert_array_equal(a.numpy()[5:], b.numpy())
    np.testing.assert_array_equal(whole[4][0].numpy()[5:],
                                  part[4][0].numpy())


# ----------------------------------------------------------- wrapper checks
def test_cpu_path_launches_no_kernel():
    common.reset_launches()
    words, pa, pb = jax_bitset._contract_inputs()
    bitset_ops.bitset_and_popcount(t32(words.view(np.int32)), t32(pa),
                                   t32(pb))
    _, tb = _random_bitset(np.random.default_rng(0), 4096, 4)
    bitset_ops.bitset_pair_count(t32(tb.offsets), t32(tb.block_ids),
                                 t32(tb.words.view(np.int32)), t32([0, 1]),
                                 t32([2, 3]))
    assert sum(common.LAUNCHES.values()) == 0


@pytest.mark.parametrize("case", ["dtype", "shape", "contiguity", "rank",
                                  "pair_dtype", "pair_shape", "pair_blocks"])
def test_wrappers_reject_bad_arguments(case):
    words = torch.zeros((4, 8), dtype=torch.int32)
    pos = torch.zeros(5, dtype=torch.int32)
    offs = torch.tensor([0, 2, 4], dtype=torch.int32)
    bids = torch.zeros(4, dtype=torch.int32)
    if case == "pair_dtype":
        with pytest.raises(TypeError):
            bitset_ops.bitset_pair_count(offs, bids, words, pos.long(), pos)
    elif case == "pair_shape":
        with pytest.raises(ValueError):
            bitset_ops.bitset_pair_count(offs, bids, words, pos, pos[:3])
    elif case == "pair_blocks":
        with pytest.raises(ValueError):
            bitset_ops.bitset_pair_count(offs, bids[:3], words, pos, pos)
    elif case == "dtype":
        with pytest.raises(TypeError):
            bitset_ops.bitset_and_popcount(words, pos.long(), pos)
    elif case == "shape":
        with pytest.raises(ValueError):
            bitset_ops.bitset_and_popcount(words, pos, pos[:3])
    elif case == "contiguity":
        offs = torch.zeros(10, dtype=torch.int32)[::2]
        with pytest.raises(ValueError):
            uint_ops.intersect_count_csr(offs, pos, pos, pos)
    else:
        with pytest.raises(ValueError):
            fill_ops.fill(torch.zeros(1, dtype=torch.int32), pos, pos, pos,
                          (), 0, 4)


# ---------------------------------------------------------------- the fold
def _fold_inputs(seed, with_anns):
    r = np.random.default_rng(seed)
    cap_in, n0 = int(r.integers(1, 30)), 150
    seed_vals = np.sort(r.choice(600, size=n0, replace=False))
    lo0 = r.integers(0, n0, cap_in)
    cnt = np.minimum(r.integers(0, 20, cap_in), n0 - lo0)
    probes = []
    for _ in range(1 + seed % 2):
        nk = int(r.integers(50, 400))
        vk = np.sort(r.choice(600, size=nk, replace=False))
        lo = r.integers(0, nk, cap_in)
        probes.append((vk, lo, np.minimum(lo + r.integers(0, 200, cap_in),
                                          nk)))
    anns = [None] * (len(probes) + 1)
    if with_anns:
        anns[0] = r.integers(1, 5, n0)
        anns[-1] = r.integers(1, 5, len(probes[-1][0]))
    return lo0, cnt, seed_vals, probes, anns


def _fold_naive(lo0, cnt, seed_vals, probes, anns, add, mul, zero, one):
    """Row by row, candidate by candidate, with np.searchsorted."""
    folded, supp = [], []
    for r in range(len(lo0)):
        acc, hits = zero, 0
        for p0 in range(lo0[r], lo0[r] + cnt[r]):
            v = seed_vals[p0]
            contrib = one if anns[0] is None else mul(one, anns[0][p0])
            keep = True
            for k, (vk, lo, hi) in enumerate(probes):
                pos = lo[r] + np.searchsorted(vk[lo[r]:hi[r]], v)
                keep &= bool(pos < hi[r] and vk[pos] == v)
                if anns[k + 1] is not None:
                    contrib = mul(contrib, anns[k + 1][min(pos, len(vk) - 1)])
            if keep:
                acc, hits = add(acc, contrib), hits + 1
        folded.append(acc)
        supp.append(hits)
    return np.asarray(folded), np.asarray(supp)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("srname", ["count", "min_plus", "boolean"])
def test_fold_plain_version_matches_row_loop(seed, srname):
    from repro_torch.core import semiring as S

    sr = {"count": S.COUNT, "min_plus": S.MIN_PLUS,
          "boolean": S.BOOLEAN}[srname]
    lo0, cnt, seed_vals, probes, anns = _fold_inputs(seed, seed % 2 == 0)
    if srname == "boolean":
        anns = [None if a is None else (a % 2).astype(bool) for a in anns]
    ops = {"count": (lambda a, b: a + b, lambda a, b: a * b, 0, 1),
           "min_plus": (min, lambda a, b: a + b, np.inf, 0.0),
           "boolean": (lambda a, b: a or b, lambda a, b: a and b,
                       False, True)}[srname]
    want, want_supp = _fold_naive(lo0, cnt, seed_vals, probes, anns, *ops)
    tanns = tuple(None if a is None else torch.as_tensor(a).to(sr.dtype)
                  for a in anns)
    offs = np.cumsum(cnt) - cnt
    folded, supp = fill_ops.fold(
        t32(lo0), t32(offs), torch.tensor(int(cnt.sum()), dtype=torch.int32),
        t32(seed_vals),
        tuple((t32(v), t32(lo), t32(hi)) for v, lo, hi in probes), tanns, sr)
    np.testing.assert_array_equal(supp.numpy(), want_supp)
    np.testing.assert_array_equal(folded.numpy(),
                                  want.astype(folded.numpy().dtype))
    assert folded.dtype == sr.dtype and supp.dtype == torch.int32
