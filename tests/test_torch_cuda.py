"""The port's CUDA kernels on the card: each integer kernel bit-equal to
its plain PyTorch version (``bitset_pair_count`` on sets inside its
shared-memory staging and spanning more, staged in one slice and in
several) (``materialize`` up to its total, ``triangle_mm``
to the plain float64 count) (``spmv_ell`` within 1e-5 of each vertex's
absolute sum of the plain version's sums in float64, and bit-equal to
itself from launch to launch; ``fm_interaction`` within 1e-5
of each row's absolute scale), one launch counted per launch,
no plain fallback for a CUDA tensor, the entry points on the card by
default, and the device engine and the FM serving path on the card equal
to the same code on the CPU (and the engine to the host oracle).  The
batched fill and fold equal their plain versions and the single-query
kernels, with more queries than ``gridDim.y`` holds and a batch whose
candidates pass 2^31, and the batched serving path on the card equals
its run on the CPU.  The three layout modes ("set", "uint", "off") agree
on the card, each through its own kernel.  Marked
``cuda``; every test skips without a card.  Run on a machine with one:
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py``."""
import numpy as np
import pytest
import torch

from repro_torch.core import workload as W
from repro_torch.core.engine import Engine
from repro_torch.data.graphs import edge_list, powerlaw_graph
from repro_torch.kernels import common
from repro_torch.kernels.bitset_intersect import ops as bitset_ops
from repro_torch.kernels.bitset_intersect.ref import (bitset_and_popcount_ref,
                                                      bitset_pair_count_ref)
from repro_torch.kernels.fm_interaction import ops as fm_kernel_ops
from repro_torch.kernels.fm_interaction.ref import (fm_interaction_ref,
                                                    fm_interaction_scale)
from repro_torch.kernels.frontier_fill import ops as fill_ops
from repro_torch.kernels.frontier_fill.ref import fill_ref, fold_ref
from repro_torch.kernels.materialize import ops as mat_ops
from repro_torch.kernels.materialize.ref import (HEADER, buffer_records,
                                                 buffer_total,
                                                 materialize_ref)
from repro_torch.kernels.spmv_ell import ops as ell_ops
from repro_torch.kernels.spmv_ell.ref import spmv_ell_ref
from repro_torch.kernels.triangle_mm import ops as tri_ops
from repro_torch.kernels.triangle_mm.ref import triangle_count_dense_ref
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


def _pair_bitset(sets, n):
    """A blocked bitset over explicit sets (slot i = set i)."""
    from repro_torch.core.intersect import build_blocked_bitset
    offs = np.concatenate([[0], np.cumsum([len(x) for x in sets])])
    nbr = np.concatenate([np.sort(x) for x in sets]).astype(np.int32)
    return build_blocked_bitset(offs, nbr, np.arange(len(sets)), n)


def _pair_args(bs, a, b, dev):
    return (t32(bs.offsets, dev), t32(bs.block_ids, dev),
            t32(bs.words.view(np.int32), dev), t32(a, dev), t32(b, dev))


def _check_pair_count(args):
    """The set-pair kernel: one launch, equal to the plain version, and
    two launches equal."""
    want = bitset_pair_count_ref(*args)
    before = common.LAUNCHES["bitset_intersect"]
    got = bitset_ops.bitset_pair_count(*args)
    torch.cuda.synchronize()
    assert common.LAUNCHES["bitset_intersect"] == before + 1
    assert torch.equal(got, want)
    assert torch.equal(bitset_ops.bitset_pair_count(*args), got)
    return want


@pytest.mark.parametrize("seed", range(4))
def test_bitset_pair_count_matches_plain(dev, seed):
    """Seeded sets of 1 to 3,000 ids over 20k to 3M ids (block ids inside
    and beyond the kernel's staging range), pairs in runs sharing b and
    shuffled, a set with itself."""
    r = np.random.default_rng(seed)
    n = (20_000, 200_000, 2_000_000, 3_000_000)[seed]
    sets = [r.choice(n, size=int(r.integers(1, 3000)), replace=False)
            for _ in range(200)]
    bs = _pair_bitset(sets, n)
    b = np.repeat(r.integers(0, 200, 250), 20)   # runs sharing b
    a = r.integers(0, 200, len(b))
    a[:200], b[:200] = np.arange(200), np.arange(200)
    want = _check_pair_count(_pair_args(bs, a, b, dev))
    truth = [len(np.intersect1d(sets[i], sets[j])) for i, j in
             zip(a[:300], b[:300])]
    np.testing.assert_array_equal(want.cpu().numpy()[:300], truth)
    perm = r.permutation(len(a))
    _check_pair_count(_pair_args(bs, a[perm], b[perm], dev))


@pytest.mark.parametrize("block_bits", [64, 128, 512])
def test_bitset_pair_count_other_block_widths(dev, block_bits):
    """Blocks of other widths than the engine's 256 bits (64-bit rows read
    a word at a time, the others 16 bytes at a time)."""
    from repro_torch.core.intersect import build_blocked_bitset
    r = np.random.default_rng(block_bits)
    n = 100_000
    sets = [np.sort(r.choice(n, size=int(r.integers(1, 3000)),
                             replace=False)) for _ in range(60)]
    offs = np.concatenate([[0], np.cumsum([len(x) for x in sets])])
    bs = build_blocked_bitset(offs, np.concatenate(sets).astype(np.int32),
                              np.arange(60), n, block_bits)
    a, b = r.integers(0, 60, (2, 2000))
    want = _check_pair_count(_pair_args(bs, a, b, dev)).cpu().numpy()
    np.testing.assert_array_equal(
        want[:200], [len(np.intersect1d(sets[i], sets[j]))
                     for i, j in zip(a[:200], b[:200])])


def test_bitset_pair_count_hub_beyond_staging(dev):
    """n = 4,000,000 ids and a hub with an id in every one of its 15,625
    blocks, more than the kernel's shared-memory staging holds: the hub
    against every set on either side, and against itself."""
    r = np.random.default_rng(0)
    n = 4_000_000
    hub = np.unique(np.concatenate([np.arange(0, n, 256),
                                    r.choice(n, 100_000, replace=False)]))
    sets = [hub] + [r.choice(m, size=int(r.integers(1, 20_000)),
                             replace=False)
                    for m in [n] * 40 + [1_000_000] * 23]
    bs = _pair_bitset(sets, n)
    assert int(bs.offsets[1] - bs.offsets[0]) == 15_625
    k = len(sets)
    a = np.concatenate([np.zeros(k, np.int64), np.arange(k), [0]])
    b = np.concatenate([np.arange(k), np.zeros(k, np.int64), [0]])
    want = _check_pair_count(_pair_args(bs, a, b, dev))
    got = want.cpu().numpy()
    assert got[-1] == len(hub)
    for i in (1, 2, 41, 63):
        assert got[i] == got[k + i] == len(np.intersect1d(hub, sets[i]))


@pytest.mark.parametrize("seed", range(2))
def test_bitset_pair_count_sets_far_from_zero(dev, seed):
    """Sets whose block ids start far from 0: narrow ones (one slice of the
    staging from their first id), sparse ones spanning two to five slices
    with gaps wider than a slice between their ids, and single blocks, on
    either side of a pair and against themselves."""
    r = np.random.default_rng(100 + seed)
    n = 8_000_000
    narrow = [r.integers(2_000_000, 6_000_000) + r.choice(
        2_000_000, size=int(r.integers(1, 4000)), replace=False)
        for _ in range(20)]
    sparse = [np.unique(np.concatenate([
        r.integers(0, n, int(r.integers(2, 40))),
        r.integers(0, 200, 50) + int(r.integers(0, n - 200))]))
        for _ in range(20)]
    spread = [np.arange(int(r.integers(0, 1000)), n, 256 * int(k))
              for k in (1, 2, 3)]
    single = [np.array([int(x)]) for x in r.integers(0, n, 5)]
    sets = narrow + sparse + spread + single
    bs = _pair_bitset(sets, n)
    k = len(sets)
    a = np.concatenate([r.integers(0, k, 3000), np.arange(k)])
    b = np.concatenate([np.sort(r.integers(0, k, 3000)), np.arange(k)])
    want = _check_pair_count(_pair_args(bs, a, b, dev)).cpu().numpy()
    np.testing.assert_array_equal(
        want[-2 * k:], [len(np.intersect1d(sets[i], sets[j]))
                        for i, j in zip(a[-2 * k:], b[-2 * k:])])


def test_bitset_pair_count_empty_call(dev):
    bs = _pair_bitset([np.arange(5), np.arange(3, 300)], 512)
    args = _pair_args(bs, np.zeros(0, np.int64), np.zeros(0, np.int64), dev)
    before = common.LAUNCHES["bitset_intersect"]
    got = bitset_ops.bitset_pair_count(*args)
    assert got.shape == (0,) and got.dtype == torch.int32
    assert got.device.type == "cuda"
    assert common.LAUNCHES["bitset_intersect"] == before


def _check_uint(rows, u, v, dev, shift=0):
    """The kernel on pairs of the sorted sets ``rows``: one launch, equal
    to the plain version and to ``np.intersect1d``.  ``shift``: the
    neighbors start that many elements past a 16-byte boundary."""
    offs = np.concatenate([[0], np.cumsum([len(x) for x in rows])])
    nbr = t32(np.concatenate([np.full(shift, -1), np.concatenate(rows)]),
              dev)[shift:]
    args = (t32(offs, dev), nbr, t32(u, dev), t32(v, dev))
    before = common.LAUNCHES["uint_intersect"]
    got = uint_ops.intersect_count_csr(*args)
    assert common.LAUNCHES["uint_intersect"] == before + 1
    assert got.dtype == torch.int32 and got.shape == (len(u),)
    assert torch.equal(got, intersect_count_csr_ref(*args))
    want = [len(np.intersect1d(rows[a], rows[b])) for a, b in zip(u, v)]
    np.testing.assert_array_equal(got.cpu().numpy(), want)


@pytest.mark.parametrize("seed", range(4))
def test_uint_kernel_matches_plain(dev, seed):
    r = np.random.default_rng(seed)
    rows = [np.sort(r.choice(3000, size=int(r.integers(0, 257)),
                             replace=False)) for _ in range(300)]
    u, v = r.integers(0, 300, (2, 5000))
    _check_uint(rows, u, v, dev)


def _uint_case(name, r):
    """Rows and pairs of one named case of ``test_uint_kernel_cases``."""
    def sets(count, size, universe=4096):
        return [np.sort(r.choice(universe, size=size, replace=False))
                for _ in range(count)]

    if name == "256_both_sides":
        rows = sets(600, 256)
        u, v = r.integers(0, 600, (2, 3000))
    elif name in ("1_against_256", "256_against_1"):
        rows = sets(200, 1) + sets(200, 256)
        u, v = r.integers(0, 200, 3000), r.integers(200, 400, 3000)
        if name == "256_against_1":
            u, v = v, u
    elif name in ("runs_share_u", "runs_share_v"):
        rows = [np.sort(r.choice(3000, size=int(r.integers(0, 75)),
                                 replace=False)) for _ in range(500)]
        shared = np.repeat(r.integers(0, 500, 400), r.integers(1, 47, 400))
        other = r.integers(0, 500, len(shared))
        u, v = (shared, other) if name == "runs_share_u" else (other, shared)
    elif name == "straddle":
        # many 1-element pairs, then 256-element ones, then both mixed:
        # batches and warp ranges end inside each stretch
        rows = sets(300, 1, 600) + sets(100, 256, 600)
        ones = r.integers(0, 300, 4000)
        big = r.integers(300, 400, 4000)
        u = np.concatenate([ones, big, r.integers(0, 400, 2000)])
        v = np.concatenate([r.integers(0, 300, 4000), big[::-1],
                            r.integers(0, 400, 2000)])
    elif name == "u_equals_v":
        rows = [np.sort(r.choice(1000, size=int(r.integers(0, 257)),
                                 replace=False)) for _ in range(200)]
        u = r.integers(0, 200, 2000)
        v = u
    elif name == "empty_rows":
        rows = [np.zeros(0, np.int64)] * 50 + sets(50, 30, 100)
        u, v = r.integers(0, 100, (2, 3000))
    elif name == "one_pair":
        rows = sets(2, 256)
        u, v = np.array([0]), np.array([1])
    else:  # "ragged": P neither a multiple of 32 nor of a warp's range
        rows = [np.sort(r.choice(3000, size=int(r.integers(0, 257)),
                                 replace=False)) for _ in range(300)]
        u, v = r.integers(0, 300, (2, 32 * 1000 + 17))
    return rows, u, v


@pytest.mark.parametrize("name", [
    "256_both_sides", "1_against_256", "256_against_1", "runs_share_u",
    "runs_share_v", "straddle", "u_equals_v", "empty_rows", "one_pair",
    "ragged"])
def test_uint_kernel_cases(dev, name):
    rows, u, v = _uint_case(name, np.random.default_rng(7))
    _check_uint(rows, u, v, dev)


@pytest.mark.parametrize("shift", [1, 2, 3])
def test_uint_kernel_neighbors_off_alignment(dev, shift):
    """The rows are copied as the 16-byte chunks that hold them, counted
    from the neighbors' own alignment."""
    rows, u, v = _uint_case("runs_share_v", np.random.default_rng(shift))
    _check_uint(rows, u, v, dev, shift)


def test_uint_kernel_empty_call(dev):
    offs = t32([0, 3, 5], dev)
    nbr = t32([1, 2, 3, 2, 3], dev)
    none = t32(np.zeros(0), dev)
    before = common.LAUNCHES["uint_intersect"]
    got = uint_ops.intersect_count_csr(offs, nbr, none, none)
    assert got.shape == (0,) and got.dtype == torch.int32
    assert got.device.type == "cuda"
    assert common.LAUNCHES["uint_intersect"] == before


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


def _check_fill(args):
    """One launch counted; every output bit-equal to the plain version;
    two launches bit-identical."""
    before = common.LAUNCHES["frontier_fill"]
    got = fill_ops.fill(*args)
    assert common.LAUNCHES["frontier_fill"] == before + 1
    want = fill_ref(*args)
    flat = lambda out: out[:4] + tuple(out[4])                # noqa: E731
    for a, b in zip(flat(got), flat(want), strict=True):
        assert a.dtype == b.dtype and torch.equal(a, b)
    for a, b in zip(flat(got), flat(fill_ops.fill(*args)), strict=True):
        assert torch.equal(a, b)
    return got


def _fill_args(dev, seed, cap_in, n0, max_cnt, n_probes, *, cut=0,
               start=0, extra=1001, live=None, hub=None, descending=False,
               counts=None, base=0, seg_len=None, past_level=False,
               band=False):
    """Seeded fill inputs: rows of up to ``max_cnt`` candidates (only the
    ``live`` ones, if given; ``counts``, if given, every row's; ``hub =
    (row, count)`` one long row), numbered from ``base``, the total
    ``cut`` below their sum, ``extra`` dead slots past it and the window
    from ``start``; the first probe the whole level (with ``past_level``
    a segment reaching 500 values past its end; with ``band`` a level of
    values from the middle half of the seeds' range only), the others a
    segment a row (``seg_len`` values each, if given); the seed level
    ascending, or descending (every row's candidates then fall, and each
    search takes the whole segment)."""
    r = np.random.default_rng(seed)
    seed_vals = np.sort(r.choice(4 * n0, size=n0, replace=False))
    if descending:
        seed_vals = seed_vals[::-1].copy()
    lo0 = r.integers(0, n0, cap_in)
    cnt = np.minimum(r.integers(0, max_cnt + 1, cap_in), n0 - lo0)
    if counts is not None:
        cnt = np.asarray(counts)
        lo0 = r.integers(0, n0 - int(cnt.max()) + 1, cap_in)
    if live is not None:
        cnt = np.where(live, cnt, 0)
    if hub is not None:
        lo0[hub[0]], cnt[hub[0]] = 0, hub[1]
    offs = np.cumsum(cnt) - cnt + base
    total = int(cnt.sum()) + base - cut
    probes = []
    for k in range(n_probes):
        nk = int(r.integers(n0 // 2, 2 * n0))
        vk = np.sort(r.choice(4 * n0, size=nk, replace=False))
        if k == 0 and band:
            vk = np.sort(r.choice(np.arange(n0, 3 * n0), size=nk,
                                  replace=False))
        if k == 0:
            lo, hi = np.zeros(cap_in), np.full(cap_in, nk)
            if past_level:
                lo, hi = lo + nk - 1000, hi + 500
        elif seg_len is not None:
            lo = r.integers(0, nk - seg_len + 1, cap_in)
            hi = lo + seg_len
        else:
            lo = r.integers(0, nk, cap_in)
            hi = np.minimum(lo + r.integers(0, 4 * max_cnt + 2, cap_in), nk)
        probes.append((t32(vk, dev), t32(lo, dev), t32(hi, dev)))
    return (torch.tensor(total, dtype=torch.int32, device=dev),
            t32(offs, dev), t32(lo0, dev), t32(seed_vals, dev),
            tuple(probes), start, total - start + extra)


@pytest.mark.parametrize("cut", [77, 300_001])
def test_fill_capped_total(dev, cut):
    """The total cut inside a row, at the end or far before it (the
    overflow clamp: rows past the total hold no live slot), rows
    straddling warp and block edges, a slot count that is no multiple of
    4 (a warp with live and dead slots at the end)."""
    args = _fill_args(dev, 21, 5000, 50_000, 300, 2, cut=cut)
    assert int(args[0]) not in set(args[1].tolist())   # inside a row
    assert args[6] % 4
    _check_fill(args)


@pytest.mark.parametrize("start", [1, 4097, 123_457])
def test_fill_window_start(dev, start):
    """A window from past slot 0: rows ending before it, the outputs
    numbered from it."""
    _check_fill(_fill_args(dev, 22, 3000, 40_000, 100, 1, cut=5,
                           start=start))


@pytest.mark.parametrize("where", ["zero", "before_start"])
def test_fill_all_slots_dead(dev, where):
    """total_c = 0, or at or below the window's start: every output 0."""
    args = _fill_args(dev, 23, 2000, 10_000, 40, 2)
    if where == "zero":
        args = (torch.zeros_like(args[0]),) + args[1:6] + (50_003,)
    else:
        args = args[:5] + (int(args[0]) + 3, 50_003)
    vals, row, p0, keep, poss = _check_fill(args)
    assert not keep.any() and not vals.any() and not row.any()
    assert not p0.any() and not any(p.any() for p in poss)


def test_fill_hub_row_spans_blocks(dev):
    """One row of 300,000 candidates among short rows: its slots span
    many blocks, each warp inside it narrowing its probe segments."""
    _check_fill(_fill_args(dev, 24, 4000, 400_000, 20, 2,
                           hub=(1234, 300_000), cut=1000))


def test_fill_empty_runs_around_tile_edges(dev):
    """Rows live in bands of 1,000 among dead ones: runs of empty rows
    cross warp and block edges and pass a warp's window of row ends,
    every slot's row the last with its offset."""
    live = (np.arange(60_000) // 1000) % 2 == 1
    _check_fill(_fill_args(dev, 25, 60_000, 20_000, 12, 1, live=live))


@pytest.mark.parametrize("n_probes", [0, fill_ops.MAX_PROBES])
def test_fill_probe_counts(dev, n_probes):
    """No probe, and the most probes a fill takes (the generic
    instance)."""
    _check_fill(_fill_args(dev, 26 + n_probes, 3000, 30_000, 60, n_probes,
                           cut=3))


def test_fill_descending_seed(dev):
    """Every row's seed values descend: no search may start where the
    previous round left its row, each takes the whole segment."""
    _check_fill(_fill_args(dev, 27, 2000, 20_000, 80, 2, cut=11,
                           descending=True))


@pytest.mark.parametrize("case", ["one_slot_a_row", "runs_past_the_window",
                                  "capacity_31", "capacity_32",
                                  "offsets_from_5"])
def test_fill_rows_from_the_warp_window(dev, case):
    """A warp finds its first slot's row and reads the next 31 row ends
    once: rows of one slot (32 rows a warp), live rows 40 empty rows apart
    (slots past the window's ends search the rest of offs), capacities at
    the window's size (no warp search at 31 rows), and offsets from 5
    (slots before the first offset take row 0, the reference's clamp)."""
    kw = {"one_slot_a_row": dict(cap_in=20_000, counts=np.ones(20_000,
                                                                int)),
          "runs_past_the_window": dict(
              cap_in=41_000, live=np.arange(41_000) % 41 == 0,
              counts=np.full(41_000, 3)),
          "capacity_31": dict(cap_in=31),
          "capacity_32": dict(cap_in=32),
          "offsets_from_5": dict(cap_in=3000, base=5)}[case]
    cap_in = kw.pop("cap_in")
    _check_fill(_fill_args(dev, 29, cap_in, 30_000, 60, 2, cut=7, **kw))


@pytest.mark.parametrize("case", ["past_the_level", "values_off_the_level",
                                  "segment_of_64", "segment_of_65"])
def test_fill_long_probe_segments(dev, case):
    """A probe segment that every lane of a warp searches is narrowed by
    the warp while it is longer than 64 values and inside the level: a
    segment reaching past the level's end (not narrowed: the clip rules),
    seed values below and above every value of the level (the first and
    the last bracket), and a hub row's segments of exactly 64 and 65
    values."""
    kw = {"past_the_level": dict(past_level=True),
          "values_off_the_level": dict(band=True),
          "segment_of_64": dict(seg_len=64, hub=(7, 40_000)),
          "segment_of_65": dict(seg_len=65, hub=(7, 40_000))}[case]
    _check_fill(_fill_args(dev, 30, 2000, 50_000, 40, 2, cut=13, **kw))


def test_fill_makes_no_host_sync(dev):
    """The call reads total_c on the card and sizes its grid from n and
    cap_in: no read of a device value."""
    args = _fill_args(dev, 28, 10_000, 50_000, 50, 2, cut=9)
    want = fill_ops.fill(*args)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = fill_ops.fill(*args)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    for a, b in zip(got[:4] + tuple(got[4]), want[:4] + tuple(want[4])):
        assert torch.equal(a, b)


FOLD_SEMIRINGS = ["count", "sum_f32", "min_plus", "max_min", "boolean"]


def _fold_args(dev, sr, lo0, cnt, seed_vals, probes, anns):
    """``fold``'s arguments on the card: offsets and the device-side total
    from the per-row counts, levels and annotations in their dtypes."""
    cnt = np.asarray(cnt, dtype=np.int64)
    total = torch.tensor(int(cnt.sum()), dtype=torch.int32, device=dev)
    tanns = []
    for a in anns:
        if a is not None and sr.name == "boolean":
            a = a > 0.5
        tanns.append(None if a is None else
                     torch.as_tensor(a, device=dev).to(sr.dtype))
    return (t32(lo0, dev), t32(np.cumsum(cnt) - cnt, dev), total,
            t32(seed_vals, dev),
            tuple((t32(v, dev), t32(lo, dev), t32(hi, dev))
                  for v, lo, hi in probes), tuple(tanns), sr)


def _plain_f64(args):
    """The plain version's sums taken in float64 (a float sum is held
    against these: the kernel and the plain version add in other
    orders)."""
    import dataclasses

    from repro_torch.core import semiring as S

    sr = args[-1]
    f64 = dataclasses.replace(sr, dtype=torch.float64,
                              segment_reduce=S._segment("sum", torch.float64,
                                                        0.0))
    anns = tuple(None if a is None else a.double() for a in args[5])
    return fold_ref(*args[:5], anns, f64)


def _check_fold(args, sum_rtol=1e-5):
    """One launch counted; support bit for bit and the fold bit for bit
    (count, min, max, boolean) or, for a float sum, within ``sum_rtol`` of
    the plain version's sums in float64 (the kernel adds in another
    order); two launches bit-identical."""
    sr = args[-1]
    before = common.LAUNCHES["frontier_fold"]
    folded, supp = fill_ops.fold(*args)
    assert common.LAUNCHES["frontier_fold"] == before + 1
    want, want_supp = fold_ref(*args)
    assert folded.dtype == sr.dtype and supp.dtype == torch.int32
    assert torch.equal(supp, want_supp)
    if sr.name == "sum_f32":
        exact, _ = _plain_f64(args)
        torch.testing.assert_close(folded.double(), exact, rtol=sum_rtol,
                                   atol=0)
    else:
        assert torch.equal(folded, want)
    again, again_supp = fill_ops.fold(*args)
    assert torch.equal(again, folded) and torch.equal(again_supp, supp)
    return folded, supp


def _random_fold(dev, sr, seed, cap_in, n0, max_cnt, n_probes, live=None,
                 annotated=(0, -1), hub=None):
    """Seeded fold inputs: sorted levels, rows of up to ``max_cnt``
    candidates (only the ``live`` ones, if given), probe segments inside
    their levels, leaf annotations in [0, 3) on the ``annotated`` atoms
    (whole numbers for count), and ``hub = (row, start, count)`` one long
    row."""
    r = np.random.default_rng(seed)
    seed_vals = np.sort(r.choice(4 * n0, size=n0, replace=False))
    lo0 = r.integers(0, n0, cap_in)
    cnt = np.minimum(r.integers(0, max_cnt + 1, cap_in), n0 - lo0)
    if live is not None:
        cnt = np.where(live, cnt, 0)
    if hub is not None:
        lo0[hub[0]], cnt[hub[0]] = hub[1], hub[2]
    probes = []
    for _ in range(n_probes):
        nk = int(r.integers(n0 // 2, 2 * n0))
        vk = np.sort(r.choice(4 * n0, size=nk, replace=False))
        lo = r.integers(0, nk, cap_in)
        probes.append((vk, lo, np.minimum(lo + r.integers(1, nk, cap_in),
                                          nk)))
    sizes = [n0] + [len(p[0]) for p in probes]
    anns = [None] * len(sizes)
    for k in annotated:
        if -len(sizes) <= k < len(sizes):
            a = r.random(sizes[k]).astype(np.float32) * 3
            anns[k] = np.floor(a) if sr.name == "count" else a
    return _fold_args(dev, sr, lo0, cnt, seed_vals, probes, anns)


@pytest.mark.parametrize("srname", FOLD_SEMIRINGS)
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
        probes.append((vk, lo, lo + r.integers(0, 3000, cap_in)))
        anns.append(r.integers(0, 3, 6000))
    args = _fold_args(dev, sr, lo0, cnt, seed_vals, probes, anns)
    folded, _ = _check_fold(args, sum_rtol=1e-6)
    if srname == "sum_f32":   # reduction order differs: float tolerance
        torch.testing.assert_close(folded, fold_ref(*args)[0], rtol=1e-6,
                                   atol=0)


@pytest.mark.parametrize("srname", FOLD_SEMIRINGS)
def test_fold_hub_row_spans_blocks(dev, srname):
    """One row of 1,200,000 candidates (longer than a block's share of the
    merge) between short rows."""
    from repro_torch.core import semiring as S

    _, supp = _check_fold(_random_fold(dev, S.BY_NAME[srname], 11, 3000,
                                       1_300_000, 40, 2,
                                       hub=(1500, 50_000, 1_200_000)))
    assert int(supp[1500]) > 0


@pytest.mark.parametrize("srname", FOLD_SEMIRINGS)
def test_fold_without_candidates(dev, srname):
    """total = 0 over a capacity of 2^21 rows: every row the zero, support
    0."""
    from repro_torch.core import semiring as S

    sr = S.BY_NAME[srname]
    cap_in = 1 << 21
    args = _random_fold(dev, sr, 5, cap_in, 5000, 10, 2,
                        live=np.zeros(cap_in, dtype=bool))
    folded, supp = _check_fold(args)
    assert int(args[2]) == 0 and int(supp.abs().sum()) == 0
    assert torch.equal(folded, torch.full_like(folded, sr.zero))


@pytest.mark.parametrize("srname", FOLD_SEMIRINGS)
def test_fold_live_rows_at_the_front(dev, srname):
    """5% live rows at the front of a 2^21-row capacity, as the planner's
    estimate leaves them."""
    from repro_torch.core import semiring as S

    cap_in = 1 << 21
    live = np.arange(cap_in) < cap_in // 20
    _check_fold(_random_fold(dev, S.BY_NAME[srname], 7, cap_in, 20_000, 60,
                             2, live=live))


@pytest.mark.parametrize("srname", FOLD_SEMIRINGS)
def test_fold_empty_runs_around_block_boundaries(dev, srname):
    """Runs of 1,000 empty rows between runs of live ones, over enough
    items that block boundaries fall inside both kinds of run."""
    from repro_torch.core import semiring as S

    cap_in = 400_000
    live = (np.arange(cap_in) // 1000) % 2 == 1
    _check_fold(_random_fold(dev, S.BY_NAME[srname], 9, cap_in, 3000, 12, 1,
                             live=live))


@pytest.mark.parametrize("srname", FOLD_SEMIRINGS)
@pytest.mark.parametrize("n_probes", [0, fill_ops.MAX_PROBES])
def test_fold_probe_counts(dev, srname, n_probes):
    """No probe with the seed's leaf annotation, and the most probes a
    fold takes, each annotated."""
    from repro_torch.core import semiring as S

    _check_fold(_random_fold(dev, S.BY_NAME[srname], 13 + n_probes, 5000,
                             4000, 30, n_probes,
                             annotated=(0,) if n_probes == 0 else
                             tuple(range(1, n_probes + 1))))


def test_fold_float_sum_is_deterministic(dev):
    """sum_f32 over non-integer annotations: two launches give the same
    bits, within 1e-5 of the sums in float64."""
    from repro_torch.core import semiring as S

    args = _random_fold(dev, S.SUM_F32, 17, 50_000, 100_000, 300, 2)
    assert not torch.equal(args[5][0], args[5][0].floor())
    folded, _ = _check_fold(args)
    for _ in range(3):
        assert torch.equal(fill_ops.fold(*args)[0], folded)


def test_fold_makes_no_host_sync(dev):
    """The call reads the total on the card and sizes its grid and scratch
    from the card: no read of a device value."""
    from repro_torch.core import semiring as S

    args = _random_fold(dev, S.COUNT, 19, 100_000, 20_000, 50, 2)
    want = fill_ops.fold(*args)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = fill_ops.fold(*args)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


# ------------------------------------------------------------ batched forms
def _batch(dev, seed, batch, cap_in, n0, max_cnt, n_probes):
    """Seeded batched fill/fold inputs over shared levels: per-query seed
    starts, counts, offsets, totals and probe bounds ``[batch, cap_in]``;
    query 0 has no candidate.  Returns ``(totals, offs, lo0, seed,
    probes)`` on the card, totals uncapped."""
    r = np.random.default_rng(seed)
    seed_vals = np.sort(r.choice(4 * n0, size=n0, replace=False))
    lo0 = r.integers(0, n0, (batch, cap_in))
    cnt = np.minimum(r.integers(0, max_cnt + 1, (batch, cap_in)), n0 - lo0)
    cnt[0] = 0
    probes = []
    for _ in range(n_probes):
        nk = int(r.integers(n0 // 2, 2 * n0))
        vk = np.sort(r.choice(4 * n0, size=nk, replace=False))
        lo = r.integers(0, nk, (batch, cap_in))
        hi = np.minimum(lo + r.integers(1, nk, (batch, cap_in)), nk)
        probes.append((t32(vk, dev), t32(lo, dev), t32(hi, dev)))
    return (t32(cnt.sum(1), dev), t32(np.cumsum(cnt, 1) - cnt, dev),
            t32(lo0, dev), t32(seed_vals, dev), tuple(probes))


def _one(probes, b):
    return tuple((v, lo[b], hi[b]) for v, lo, hi in probes)


def _check_fill_batched(total, offs, lo0, seed, probes, n, singles=True):
    """One launch counted, bit-equal to the plain version and (with
    ``singles``) to the single-query kernel query by query; two launches
    equal."""
    from repro_torch.kernels.frontier_fill.ref import fill_batched_ref

    args = (total.clamp(max=n), offs, lo0, seed, probes, n)
    before = common.LAUNCHES["frontier_fill_batched"]
    got = fill_ops.fill_batched(*args)
    assert common.LAUNCHES["frontier_fill_batched"] == before + 1
    want = fill_batched_ref(*args)
    flat = list(got[:4]) + list(got[4])
    for x, y in zip(flat, list(want[:4]) + list(want[4])):
        assert torch.equal(x, y)
    again = fill_ops.fill_batched(*args)
    assert all(torch.equal(x, y)
               for x, y in zip(flat, list(again[:4]) + list(again[4])))
    if singles:
        for b in range(offs.shape[0]):
            one = fill_ops.fill(args[0][b], offs[b], lo0[b], seed,
                                _one(probes, b), 0, n)
            for x, y in zip(flat, list(one[:4]) + list(one[4])):
                assert torch.equal(x[b], y)
    return got


@pytest.mark.parametrize("n_probes", [0, 1, 2, fill_ops.MAX_PROBES])
def test_fill_batched_matches_plain_and_single(dev, n_probes):
    total, offs, lo0, seed, probes = _batch(dev, 21 + n_probes, 40, 600,
                                            20_000, 40, n_probes)
    n = int(total.max()) // 2 + 37   # some queries past capacity
    _check_fill_batched(total, offs, lo0, seed, probes, n)


def test_fill_batched_of_one_is_the_single_entry(dev):
    total, offs, lo0, seed, probes = _batch(dev, 23, 2, 3000, 50_000, 60, 2)
    n = int(total[1])
    one = _check_fill_batched(total[1:], offs[1:], lo0[1:], seed,
                              tuple((v, lo[1:], hi[1:])
                                    for v, lo, hi in probes), n)
    single = fill_ops.fill(total[1], offs[1], lo0[1], seed,
                           _one(probes, 1), 0, n)
    for x, y in zip(list(one[:4]) + list(one[4]),
                    list(single[:4]) + list(single[4])):
        assert torch.equal(x[0], y)


def test_fill_batched_more_queries_than_grid_y(dev):
    """70,000 queries of 4 rows and 8 slots: more queries than gridDim.y
    holds (65,535), one launch."""
    total, offs, lo0, seed, probes = _batch(dev, 29, 70_000, 4, 5000, 4, 2)
    got = _check_fill_batched(total, offs, lo0, seed, probes, 8,
                              singles=False)
    assert got[0].shape == (70_000, 8)


def _check_fold_batched(args, sum_rtol=1e-5, singles=True):
    """One launch counted; support bit for bit and the fold bit for bit
    (or a float sum within ``sum_rtol`` of the plain version's sums in
    float64) against the plain version, and (with ``singles``) the same
    against the single-query kernel query by query; two launches
    equal."""
    import dataclasses

    from repro_torch.core import semiring as S
    from repro_torch.kernels.frontier_fill.ref import fold_batched_ref

    sr = args[-1]
    before = common.LAUNCHES["frontier_fold_batched"]
    folded, supp = fill_ops.fold_batched(*args)
    assert common.LAUNCHES["frontier_fold_batched"] == before + 1
    want, want_supp = fold_batched_ref(*args)
    assert torch.equal(supp, want_supp)
    if sr.name == "sum_f32":
        f64 = dataclasses.replace(
            sr, dtype=torch.float64,
            segment_reduce=S._segment("sum", torch.float64, 0.0))
        exact, _ = fold_batched_ref(
            *args[:5], tuple(None if a is None else a.double()
                             for a in args[5]), f64)
        torch.testing.assert_close(folded.double(), exact, rtol=sum_rtol,
                                   atol=0)
    else:
        assert torch.equal(folded, want)
    again = fill_ops.fold_batched(*args)
    assert torch.equal(again[0], folded) and torch.equal(again[1], supp)
    if singles:
        lo0, offs, total, seed, probes, anns, _sr = args
        for b in range(lo0.shape[0]):
            f1, s1 = fill_ops.fold(lo0[b], offs[b], total[b], seed,
                                   _one(probes, b), anns, sr)
            assert torch.equal(s1, supp[b])
            if sr.name == "sum_f32":
                torch.testing.assert_close(f1, folded[b], rtol=sum_rtol,
                                           atol=0)
            else:
                assert torch.equal(f1, folded[b])
    return folded, supp


def _fold_batch_args(dev, sr, batch_inputs, annotate):
    total, offs, lo0, seed, probes = batch_inputs
    r = np.random.default_rng(31)
    anns = [None] * (len(probes) + 1)
    if annotate:
        sizes = [int(seed.shape[0])] + [int(p[0].shape[0]) for p in probes]
        for k in (0, -1):
            a = r.random(sizes[k]).astype(np.float32) * 3
            a = np.floor(a) if sr.name == "count" else a
            if sr.name == "boolean":
                a = a > 0.5
            anns[k] = torch.as_tensor(a, device=dev).to(sr.dtype)
    return (lo0, offs, total, seed, probes, tuple(anns), sr)


@pytest.mark.parametrize("srname", FOLD_SEMIRINGS)
def test_fold_batched_matches_plain_and_single(dev, srname):
    from repro_torch.core import semiring as S

    sr = S.BY_NAME[srname]
    inputs = _batch(dev, 41, 24, 2000, 30_000, 200, 2)
    _check_fold_batched(_fold_batch_args(dev, sr, inputs, True))


@pytest.mark.parametrize("n_probes", [0, 1, fill_ops.MAX_PROBES])
def test_fold_batched_probe_counts(dev, n_probes):
    from repro_torch.core import semiring as S

    inputs = _batch(dev, 43 + n_probes, 12, 1500, 10_000, 60, n_probes)
    _check_fold_batched(_fold_batch_args(dev, S.COUNT, inputs, True))


def test_fold_batched_of_one_is_the_single_entry(dev):
    from repro_torch.core import semiring as S

    total, offs, lo0, seed, probes = _batch(dev, 47, 2, 5000, 40_000, 90, 2)
    args = (lo0[1:], offs[1:], total[1:], seed,
            tuple((v, lo[1:], hi[1:]) for v, lo, hi in probes),
            (None,) * 3, S.COUNT)
    folded, supp = _check_fold_batched(args)
    f1, s1 = fill_ops.fold(lo0[1], offs[1], total[1], seed, _one(probes, 1),
                           (None,) * 3, S.COUNT)
    assert torch.equal(folded[0], f1) and torch.equal(supp[0], s1)


def test_fold_batched_more_queries_than_grid_y(dev):
    """70,000 queries of 4 rows each: one launch, one merge path over
    280,000 rows."""
    from repro_torch.core import semiring as S

    inputs = _batch(dev, 53, 70_000, 4, 5000, 6, 1)
    _check_fold_batched(_fold_batch_args(dev, S.COUNT, inputs, True),
                        singles=False)


def test_fold_batched_total_past_int32(dev):
    """17 single-row queries, each over its own 2^27-value seed segment
    (query b from seed position b on), summing 17 * 2^27 > 2^31
    candidates; the count of each row is the sum of the seed's leaf
    annotations over its segment, so a position wrapped at 2^31 would
    show.  Held against the single-query plain version and kernel query
    by query (the batched plain version would expand every candidate at
    once)."""
    from repro_torch.core import semiring as S

    batch, seg = 17, 1 << 27
    n0 = seg + batch
    assert batch * seg > (1 << 31)
    seed = torch.arange(n0, dtype=torch.int32, device=dev)
    g = torch.Generator(device=dev).manual_seed(0)
    ann = torch.randint(0, 3, (n0,), generator=g, dtype=torch.int32,
                        device=dev)
    lo0 = torch.arange(batch, dtype=torch.int32, device=dev).reshape(-1, 1)
    offs = torch.zeros((batch, 1), dtype=torch.int32, device=dev)
    total = torch.full((batch,), seg, dtype=torch.int32, device=dev)
    args = (lo0, offs, total, seed, (), (ann,), S.COUNT)
    before = common.LAUNCHES["frontier_fold_batched"]
    folded, supp = fill_ops.fold_batched(*args)
    assert common.LAUNCHES["frontier_fold_batched"] == before + 1
    again = fill_ops.fold_batched(*args)
    assert torch.equal(again[0], folded) and torch.equal(again[1], supp)
    csum = torch.cumsum(ann.long(), 0)
    for b in range(batch):
        one = (lo0[b], offs[b], total[b], seed, (), (ann,), S.COUNT)
        want = fold_ref(*one)
        assert torch.equal(folded[b], want[0]) and torch.equal(supp[b],
                                                               want[1])
        single = fill_ops.fold(*one)
        assert torch.equal(folded[b], single[0])
        expect = int(csum[b + seg - 1] - (csum[b - 1] if b else 0))
        assert int(folded[b, 0]) == expect and int(supp[b, 0]) == seg


def _anchored(dev, seed, **kw):
    from repro_torch.kernels.frontier_fill.batches import anchored_batch
    return anchored_batch(seed, device=dev, **kw)


def _all_annotated(dev, sr, inputs, seed=37):
    """Fold arguments with a leaf annotation on the seed and on every
    probe, so each probe's position is needed."""
    total, offs, lo0, seed_v, probes = inputs
    r = np.random.default_rng(seed)
    anns = []
    for v in (seed_v,) + tuple(p[0] for p in probes):
        a = np.floor(r.random(int(v.shape[0])) * 3).astype(np.float32)
        if sr.name == "sum_f32":
            a = a + r.random(a.shape).astype(np.float32)
        if sr.name == "boolean":
            a = a > 0.5
        anns.append(torch.as_tensor(a, device=dev).to(sr.dtype))
    return (lo0, offs, total, seed_v, probes, tuple(anns), sr)


# anchored batches large enough that a query spans several of the fold's
# tiles (1,792 items): the staged path engages inside a query
BIG = dict(batch=10, cap_in=1500, vertices=20_000, universe=200_000,
           hub=3000)


def _same_at_every_budget(args, budgets=(0, 64, 4096)):
    """The batched fold at other staging budgets (0: every probe searched
    in device memory) gives the default budget's bits."""
    want = fill_ops.fold_batched(*args)
    for b in budgets:
        got = fill_ops.fold_batched(*args, _stage_bytes=b)
        assert torch.equal(got[0], want[0])
        assert torch.equal(got[1], want[1])


def test_fold_batched_staged_and_global_paths_in_one_launch(dev):
    """Anchored queries (their tiles staged) beside a query whose probe
    segments differ from row to row and tiles that span two queries
    (searched in device memory), in one launch; equal to the plain
    version, the single-query kernel and the all-global launch."""
    from repro_torch.core import semiring as S

    inputs = _anchored(dev, 61, n_probes=1, varied=(4,), **BIG)
    args = (inputs[2], inputs[1], inputs[0], inputs[3], inputs[4],
            (None, None), S.COUNT)
    _check_fold_batched(args)
    _same_at_every_budget(args)


def test_fold_batched_tiles_and_blocks_span_queries(dev):
    """300 small anchored queries: most tiles and blocks of the merge
    path hold rows of two or more queries, each with its own segment, and
    19 of them have enough candidates to be staged."""
    from repro_torch.core import semiring as S

    inputs = _anchored(dev, 67, batch=300, cap_in=160, n_probes=2,
                       empty=(2, 150))
    args = _all_annotated(dev, S.COUNT, inputs)
    _check_fold_batched(args, singles=False)
    _same_at_every_budget(args)


def test_fold_batched_segment_past_the_staging(dev):
    """A hub segment whose value range (2,000,000 values) passes the
    shared memory a block may take keeps the search in device memory,
    beside queries whose segments stage."""
    from repro_torch.core import semiring as S

    inputs = _anchored(dev, 71, n_probes=1, **dict(BIG, universe=2_000_000))
    hub_range = int(inputs[3][inputs[4][0][2][1, 0] - 1]
                    - inputs[3][inputs[4][0][1][1, 0]]) + 1
    assert hub_range > 8 * fill_ops._STAGE_BYTES
    args = (inputs[2], inputs[1], inputs[0], inputs[3], inputs[4],
            (None, None), S.COUNT)
    _check_fold_batched(args)
    _same_at_every_budget(args, (0, 160 << 10))


def test_fold_batched_empty_segments(dev):
    """Queries whose shared segment is empty (an isolated anchor), and a
    probe over an empty level: no candidate is kept there."""
    from repro_torch.core import semiring as S

    total, offs, lo0, seed, probes = _anchored(dev, 73, n_probes=1,
                                               empty=(2, 5), **BIG)
    none = torch.empty(0, dtype=torch.int32, device=dev)
    zero = torch.zeros_like(lo0)
    for pr in (probes, probes + ((none, zero, zero),)):
        args = (lo0, offs, total, seed, pr, (None,) * (len(pr) + 1),
                S.COUNT)
        folded, supp = _check_fold_batched(args)
        assert int(supp[2].sum()) == int(supp[5].sum()) == 0
    assert int(supp.sum()) == 0                  # the empty level


def test_fold_batched_staging_rounds(dev):
    """300,000 anchored queries of 2 rows, one in 997 with 8,000
    candidates (staged) among small ones (not staged): more queries
    than the staging kernel's blocks take in one round, and more than it
    scans (the wrapper scans their totals).  The probe level has gaps, so
    a staged bitmap holds misses; with and without an annotated probe,
    whose position is needed, and with no probe."""
    from repro_torch.core import semiring as S

    batch, m, n = 300_000, 250_000, 200_000
    r = np.random.default_rng(103)
    seed = np.arange(m)
    level = np.sort(r.choice(m, n, replace=False))
    big = np.arange(batch) % 997 == 5
    cnt = np.where(big[:, None], 4000, r.integers(0, 6, (batch, 2)))
    lo0 = r.integers(0, m - 4000, (batch, 2))
    # each query's segment: from the level's first value past its first
    # row's 200th candidate, 600 values for a big query
    seg = np.where(big, 600, r.integers(0, 300, batch))
    lo = np.minimum(np.searchsorted(level, lo0[:, 0] + 200), n - 600)
    bounds = [t32(np.repeat(x[:, None], 2, 1), dev) for x in (lo, lo + seg)]
    inputs = (t32(cnt.sum(1), dev), t32(np.cumsum(cnt, 1) - cnt, dev),
              t32(lo0, dev), t32(seed, dev),
              ((t32(level, dev), bounds[0], bounds[1]),))
    total, offs, lo0_t, seed_t, probes = inputs
    for args in ((lo0_t, offs, total, seed_t, probes, (None, None),
                  S.COUNT), _all_annotated(dev, S.COUNT, inputs)):
        folded, supp = _check_fold_batched(args, singles=False)
        assert int(supp[torch.as_tensor(big, device=dev)].sum()) \
            > 400 * int(big.sum())
        _same_at_every_budget(args, (0,))
    # no probe: nothing to stage, and the totals scanned by the wrapper
    _check_fold_batched((lo0_t, offs, total, seed_t, (), (None,), S.COUNT),
                        singles=False)


def test_fold_batched_row_dependent_probes(dev):
    """Every query's probe segments differ from row to row (as
    4clique_at's X(y,a)), one probe and two."""
    from repro_torch.core import semiring as S

    for n_probes in (1, 2):
        inputs = _anchored(dev, 79 + n_probes, n_probes=n_probes,
                           varied=range(10), **BIG)
        _check_fold_batched(_all_annotated(dev, S.COUNT, inputs))


@pytest.mark.parametrize("srname", FOLD_SEMIRINGS)
def test_fold_batched_annotated_probes(dev, srname):
    """Anchored queries with a leaf annotation on every probe: each staged
    probe's position comes from the running counts."""
    from repro_torch.core import semiring as S

    sr = S.BY_NAME[srname]
    inputs = _anchored(dev, 83, n_probes=2, **BIG)
    args = _all_annotated(dev, sr, inputs)
    _check_fold_batched(args)
    _same_at_every_budget(args)


def test_fold_batched_max_probes_anchored(dev):
    """MAX_PROBES anchored probes over one level, every one annotated:
    the smaller queries' segments stage together, the hub's pass the
    budget."""
    from repro_torch.core import semiring as S

    inputs = _anchored(dev, 89, n_probes=fill_ops.MAX_PROBES, **BIG)
    args = _all_annotated(dev, S.COUNT, inputs)
    _check_fold_batched(args)
    _same_at_every_budget(args, (0, 160 << 10))


def test_fold_batched_staged_float_sum_is_deterministic(dev):
    """A float sum over staged anchored queries: three launches give the
    same bits, within rtol 1e-5 of the plain version's sums in float64."""
    from repro_torch.core import semiring as S

    inputs = _anchored(dev, 97, n_probes=1, **BIG)
    args = _all_annotated(dev, S.SUM_F32, inputs)
    first = _check_fold_batched(args)
    for _ in range(2):
        again = fill_ops.fold_batched(*args)
        assert torch.equal(again[0], first[0])
        assert torch.equal(again[1], first[1])


def test_fold_batched_staged_makes_no_host_sync(dev):
    """An anchored batch, and 9,000 queries (more than the staging kernel
    scans: the wrapper scans their totals on the card)."""
    from repro_torch.core import semiring as S

    inputs = _anchored(dev, 101, n_probes=2, varied=(3,), **BIG)
    many = _batch(dev, 107, 9000, 4, 5000, 6, 1)
    for args in (_all_annotated(dev, S.COUNT, inputs),
                 _fold_batch_args(dev, S.COUNT, many, False)):
        want = fill_ops.fold_batched(*args)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = fill_ops.fold_batched(*args)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_batched_forms_make_no_host_sync(dev):
    from repro_torch.core import semiring as S

    total, offs, lo0, seed, probes = _batch(dev, 59, 16, 1000, 10_000, 30,
                                            2)
    fargs = (total.clamp(max=4096), offs, lo0, seed, probes, 4096)
    gargs = (lo0, offs, total, seed, probes, (None,) * 3, S.COUNT)
    want = (fill_ops.fill_batched(*fargs), fill_ops.fold_batched(*gargs))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = (fill_ops.fill_batched(*fargs), fill_ops.fold_batched(*gargs))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.equal(got[0][0], want[0][0])
    assert torch.equal(got[1][0], want[1][0])


def test_batched_serving_path_on_card_matches_cpu(dev):
    """Prepared triangle and 4-clique queries re-bound to a small
    power-law graph's hubs: the batched path on the card equals the same
    code on the CPU, answer and dispatch summary, and launches the
    batched kernels."""
    from repro_torch.serve import QueryServer

    g = powerlaw_graph(300, 8, 2.0, seed=0)
    src, dst = edge_list(g)
    hubs = [int(v) for v in np.argsort(g.degrees)[::-1][:8]]
    texts = ["C(;w:long) :- R(0,y),S(y,z),T(0,z); w=<<COUNT(*)>>.",
             "L(y,z) :- R(0,y),S(y,z),T(0,z).",
             "C(;w:long) :- R(0,y),S(y,z),T(0,z),U(0,a),X(y,a),Y(z,a); "
             "w=<<COUNT(*)>>."]
    out = []
    for device in ("cuda", "cpu"):
        srv = QueryServer(device=device)
        srv.load_graph("t", "R", src, dst)
        for al in ("S", "T", "U", "X", "Y"):
            srv.alias("t", al, "R")
        before = dict(common.LAUNCHES)
        res = [srv.prepare("t", q).run_batch(hubs) for q in texts]
        launched = {k: common.LAUNCHES[k] - before.get(k, 0)
                    for k in common.LAUNCHES}
        out.append((res, srv.dispatch_summary(), launched))
    (cres, cd, cl), (hres, hd, _hl) = out
    assert cd == hd and cd["pipeline.batched_launches"] >= 3
    for a, b in zip(cres, hres):
        for x, y in zip(a, b):
            assert x.vars == y.vars
            for v in x.vars:
                assert np.array_equal(x.columns[v], y.columns[v])
            if y.annotation is not None:
                assert np.array_equal(np.asarray(x.annotation),
                                      np.asarray(y.annotation))
    assert cl["frontier_fill_batched"] == cd["extend.pipeline_extends"]
    assert cl["frontier_fold_batched"] == cd["pipeline.device_folds"]


def test_layout_modes_agree_on_card(dev):
    """TRIANGLE_COUNT and FOUR_CLIQUE on a degree-ordered, pruned
    power-law graph in layout modes "set", "uint" and "off": the three
    counts on the card agree, each equals the same code on the CPU
    (dispatch summary too), and each mode launches its route's kernel:
    ``bitset_intersect`` in "set", ``uint_intersect`` in "uint", only
    ``frontier_fold`` in "off"."""
    from repro_torch.core import layouts
    from repro_torch.graph import apply_ordering, order_nodes, prune_symmetric

    g = powerlaw_graph(2000, 12, 2.0, seed=0)
    src, dst = edge_list(prune_symmetric(apply_ordering(
        g, order_nodes(g, "degree"))))
    counts = {}
    try:
        for mode in ("set", "uint", "off"):
            layouts.set_engine_layout_mode(mode)
            for qname in ("TRIANGLE_COUNT", "FOUR_CLIQUE"):
                out = []
                for device in ("cuda", "cpu"):
                    eng = Engine(backend="device", device=device)
                    eng.load_edges("Edge", src, dst)
                    for a in W.ALIASES:
                        eng.alias(a, "Edge")
                    before = dict(common.LAUNCHES)
                    n = int(eng.query(getattr(W, qname)).scalar())
                    launched = {k: common.LAUNCHES[k] - before.get(k, 0)
                                for k in common.LAUNCHES}
                    out.append((n, eng.dispatch_summary(), launched))
                (n, d, launched), (host_n, host_d, _) = out
                assert n == host_n and d == host_d, (mode, qname)
                counts[mode, qname] = n
                if qname == "TRIANGLE_COUNT":
                    route = {"set": "bitset_intersect",
                             "uint": "uint_intersect",
                             "off": "frontier_fold"}[mode]
                    assert launched.get(route, 0) > 0, (mode, launched)
                if mode == "off":
                    assert launched.get("bitset_intersect", 0) == 0
                    assert launched.get("uint_intersect", 0) == 0
    finally:
        layouts.set_engine_layout_mode("set")
    for qname in ("TRIANGLE_COUNT", "FOUR_CLIQUE"):
        assert counts["set", qname] == counts["uint", qname] \
            == counts["off", qname] > 0, counts


def test_cuda_tensor_never_takes_the_plain_version(dev):
    words = torch.zeros((4, 8), dtype=torch.int64, device=dev)
    pos = torch.zeros(3, dtype=torch.int32, device=dev)
    with pytest.raises(TypeError):
        bitset_ops.bitset_and_popcount(words, pos, pos)
    with pytest.raises(TypeError):
        bitset_ops.bitset_pair_count(pos, pos, words, pos, pos)
    with pytest.raises(TypeError):
        mat_ops.materialize(words, pos, pos, pos, pos, pos, 8)
    # the plain version takes blocks of any width; the kernel refuses
    # blocks wider than 8192 bits instead of falling back
    wide = torch.zeros((4, 257), dtype=torch.int32)
    blk = torch.zeros(4, dtype=torch.int32)
    assert int(materialize_ref(wide, blk, blk, pos.cpu(), pos.cpu(),
                               pos.cpu(), 8)[0]) == 0
    with pytest.raises(ValueError, match="words"):
        mat_ops.materialize(wide.to(dev), blk.to(dev), blk.to(dev), pos,
                            pos, pos, 8)
    # the plain version takes any square matrix; the kernel refuses a
    # size that is not a multiple of its tile instead of falling back
    a = torch.ones((100, 100), dtype=torch.float32)
    assert int(tri_ops.triangle_mm(a)) == 100 ** 3
    with pytest.raises(ValueError, match="multiple"):
        tri_ops.triangle_mm(a.to(dev))


def _random_bitset(seed, block_bits):
    from repro_torch.core.intersect import build_blocked_bitset
    r = np.random.default_rng(seed)
    rows = [np.sort(r.choice(6000, size=int(r.integers(0, 400)),
                             replace=False)) for _ in range(300)]
    offs = np.concatenate([[0], np.cumsum([len(x) for x in rows])])
    nbr = np.concatenate(rows).astype(np.int32)
    ids = np.flatnonzero(np.diff(offs) > 0)
    return build_blocked_bitset(offs, nbr, ids, 6000, block_bits), ids


@pytest.mark.parametrize("block_bits", [256, 1024, 2048, 4096])
@pytest.mark.parametrize("seed", range(2))
def test_materialize_kernel_matches_plain(dev, seed, block_bits):
    """Bit-equal to the plain version up to the total (a thread a pair at
    256-bit blocks, a group of lanes above), one launch per call, and the
    whole entry equal to the host extraction."""
    from repro_torch.core import intersect as I
    bs, ids = _random_bitset(seed, block_bits)
    r = np.random.default_rng(50 + seed)
    a, b = r.integers(0, len(ids), (2, 3000))
    bid = t32(bs.block_ids, dev)
    pair_id, _, pa, pb = I.intersect_pairs_uint(bs.offsets, bs.block_ids,
                                                a, b, bid)
    cap = int(np.minimum(bs.card[pa], bs.card[pb]).sum())
    args = (t32(bs.words.view(np.int32), dev), bid, t32(bs.index, dev),
            t32(pa, dev), t32(pb, dev), t32(pair_id, dev))
    before = common.LAUNCHES["materialize"]
    got = mat_ops.materialize(*args, cap)
    assert common.LAUNCHES["materialize"] == before + 1
    want = materialize_ref(*args, cap)
    _assert_same_matches(got, want)
    assert int(buffer_total(want)[0]) > 0
    out = mat_ops.bitset_pair_materialize(bs, a, b, args[0], bid, args[2])
    host = I.bitset_intersect_materialize(bs, a, b, bid)
    for x, y in zip(out, host):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


def _assert_same_matches(got, want):
    """Equal totals, and equal records up to the total."""
    total = int(buffer_total(want)[0])
    assert int(buffer_total(got)[0]) == total
    assert torch.equal(got[:HEADER + 4 * total], want[:HEADER + 4 * total])


def _random_blocks(dev, seed, p, w, density, n_blocks=5000):
    """Kernel arguments over ``n_blocks`` random blocks of ``w`` words
    (each bit set with probability ``density``) and ``p`` random pairs of
    them, with the capacity the engine would give them."""
    r = np.random.default_rng(seed)
    bits = r.random((n_blocks, w * 32), dtype=np.float32) < density
    words = np.packbits(bits, axis=1, bitorder="little").view(np.int32)
    card = bits.sum(axis=1)
    pa, pb = r.integers(0, n_blocks, (2, p))
    args = (t32(words, dev), t32(r.integers(0, 1 << 16, n_blocks), dev),
            t32(r.integers(0, 1 << 30, n_blocks), dev), t32(pa, dev),
            t32(pb, dev), t32(np.sort(r.integers(0, p, p)), dev))
    return args, int(np.minimum(card[pa], card[pb]).sum())


@pytest.mark.parametrize("p,w", [(1, 8), (1_000_003, 8), (1, 64),
                                 (1_000_003, 32)])
def test_materialize_look_back_across_tiles(dev, p, w):
    """One pair, and over a million pairs (thousands of tiles, the last
    one partial): every tile's base slot from the look-back equals the
    plain version's."""
    args, cap = _random_blocks(dev, p, p, w, 0.1)
    got = mat_ops.materialize(*args, cap)
    _assert_same_matches(got, materialize_ref(*args, cap))


def test_materialize_skewed_pairs(dev):
    """Pairs whose AND holds all 256 bits beside pairs whose AND is
    empty, in runs that straddle tiles; a capacity one short of the total
    keeps the first records and makes ``fetch`` raise."""
    r = np.random.default_rng(9)
    words = np.zeros((3, 8), np.int32)
    words[0] = -1                       # all 256 bits
    words[2] = r.integers(-(1 << 31), 1 << 31, 8)
    p = 5000
    pb = np.where(r.random(p) < 0.5, 0, 1)
    pb[r.random(p) < 0.1] = 2
    pb[1000:1300] = 0                   # a run of full pairs
    pb[2000:2600] = 1                   # a run of empty ones
    args = (t32(words, dev), t32(np.arange(3), dev),
            t32(np.array([0, 256, 512]), dev), t32(np.zeros(p), dev),
            t32(pb, dev), t32(np.arange(p), dev))
    cap = 256 * p
    want = materialize_ref(*args, cap)
    total = int(buffer_total(want)[0])
    assert total == 256 * int((pb == 0).sum()) + int(
        (pb == 2).sum()) * int(np.unpackbits(words[2].view(np.uint8)).sum())
    _assert_same_matches(mat_ops.materialize(*args, cap), want)
    short = mat_ops.materialize(*args, total - 1)
    assert int(buffer_total(short)[0]) == total
    assert torch.equal(short[HEADER:], want[HEADER:HEADER + 4 * (total - 1)])
    with pytest.raises(ValueError, match="capacity"):
        mat_ops.fetch(short)
    exact = mat_ops.fetch(mat_ops.materialize(*args, total))
    for x, y in zip(exact, buffer_records(want)[:total].T.cpu().numpy()):
        np.testing.assert_array_equal(x, y)


def test_materialize_two_launches_are_identical(dev):
    args, cap = _random_blocks(dev, 3, 300_001, 8, 0.2)
    first = mat_ops.materialize(*args, cap)
    _assert_same_matches(mat_ops.materialize(*args, cap), first)
    assert int(buffer_total(first)[0]) > 0


def test_materialize_makes_no_host_sync(dev):
    """The call sizes its scratch from P alone: no read of the card."""
    args, cap = _random_blocks(dev, 4, 100_000, 8, 0.2)
    want = mat_ops.materialize(*args, cap)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = mat_ops.materialize(*args, cap)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    _assert_same_matches(got, want)


@pytest.mark.parametrize("n,pruned", [(512, False), (1024, True),
                                      (1536, False)])
def test_triangle_mm_kernel_matches_plain(dev, n, pruned):
    """The exact raw count equals the plain float64 version's, twice the
    same, one launch per call; the entry's float32 count divides by 6 on
    a symmetric adjacency."""
    r = np.random.default_rng(n)
    a = np.triu(r.random((n, n)) < 0.05, 1)
    if not pruned:
        a = a | a.T
    t = torch.as_tensor(a.astype(np.float32), device=dev)
    before = common.LAUNCHES["triangle_mm"]
    got = tri_ops.triangle_mm(t)
    assert torch.equal(got, tri_ops.triangle_mm(t))
    assert common.LAUNCHES["triangle_mm"] == before + 2
    want = int(triangle_count_dense_ref(t))
    assert int(got) == want > 0
    ent = tri_ops.triangle_count_dense(t[: n - 5, : n - 5].contiguous(),
                                       symmetric=not pruned)
    sub = t[: n - 5, : n - 5].double()
    raw = float(((sub @ sub) * sub).sum())
    assert float(ent) == np.float32(raw / 6.0 if not pruned else raw)


def _block_diagonal(n, sizes):
    """Cliques (no self-loops) on consecutive vertex runs of ``sizes``:
    blocks 32, 64 and 96 wide from a tile edge, then blocks that begin and
    end inside tiles."""
    a = np.zeros((n, n), dtype=bool)
    start = 0
    for s in sizes:
        a[start:start + s, start:start + s] = True
        start += s
    np.fill_diagonal(a, False)
    return a


def _pruned_powerlaw(symmetric):
    from repro_torch.graph.prune import prune_symmetric, symmetrize
    g = powerlaw_graph(2048, 20, 2.2, seed=0)
    sym = symmetrize(*edge_list(g), n=g.n)
    csr = sym if symmetric else prune_symmetric(sym)
    return tri_ops.densify_csr(csr.offsets, csr.neighbors, g.n) != 0


def _corners(n):
    """A nonzero at each corner of A (bit 0 and bit 31 of the first and
    last words), and three on the inner edges of corner tiles."""
    a = np.zeros((n, n), dtype=bool)
    for i, j in [(0, 0), (0, n - 1), (n - 1, 0), (n - 1, n - 1),
                 (31, 31), (31, n - 32), (n - 32, 31)]:
        a[i, j] = True
    return a


TILE_CASES = {
    "n128": lambda: np.random.default_rng(0).random((128, 128)) < 0.3,
    "zeros_1024": lambda: np.zeros((1024, 1024), dtype=bool),
    "corners_1024": lambda: _corners(1024),
    "corners_1152": lambda: _corners(1152),
    # 1152 = 36 tiles: two words a bitmap row, the last one partial
    "block_diagonal_1152": lambda: _block_diagonal(
        1152, [32, 64, 96, 40, 70, 25, 100, 33, 31, 200, 1, 3, 457]),
    "block_diagonal_384": lambda: _block_diagonal(384, [96, 64, 32, 45, 147]),
    "powerlaw_2048_pruned": lambda: _pruned_powerlaw(False),
    "powerlaw_2048_symmetric": lambda: _pruned_powerlaw(True),
    # every tile occupied, every tile triple visited
    "dense_half_1024": lambda: np.random.default_rng(1).random((1024, 1024))
    < 0.5,
}


@pytest.mark.parametrize("case", sorted(TILE_CASES))
def test_triangle_mm_skips_only_empty_tiles(dev, case):
    """Matrices whose empty 32 x 32 tiles the count pass skips (and one
    with none): the exact raw count of the plain float64 version, twice
    the same, one launch counted per call."""
    a = TILE_CASES[case]()
    t = torch.as_tensor(a.astype(np.float32), device=dev)
    before = common.LAUNCHES["triangle_mm"]
    got = tri_ops.triangle_mm(t)
    assert common.LAUNCHES["triangle_mm"] == before + 1
    assert torch.equal(got, tri_ops.triangle_mm(t))
    assert common.LAUNCHES["triangle_mm"] == before + 2
    assert got.dtype == torch.int64 and got.device == t.device
    want = float(triangle_count_dense_ref(t))
    assert int(got) == want
    assert (want == 0) == (case == "zeros_1024")


def test_triangle_mm_makes_no_host_sync(dev):
    """The call sizes its scratch from n alone: no read of the card."""
    a = torch.as_tensor(_pruned_powerlaw(False).astype(np.float32),
                        device=dev)
    tri_ops.triangle_mm(a)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = tri_ops.triangle_mm(a)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert int(got) == float(triangle_count_dense_ref(a))


def test_triangle_mm_passes_run_apart_give_the_count(dev):
    """The pack pass, then the count pass alone over the planes it left,
    give the whole call's count, and neither bumps ``LAUNCHES``."""
    a = torch.as_tensor(_pruned_powerlaw(False).astype(np.float32),
                        device=dev)
    n = int(a.shape[0])
    scratch = torch.empty(tri_ops.scratch_bytes(n), dtype=torch.uint8,
                          device=dev)
    out = torch.empty((), dtype=torch.int64, device=dev)
    before = common.LAUNCHES["triangle_mm"]
    tri_ops.run_passes(a, scratch, out, tri_ops.PACK)
    tri_ops.run_passes(a, scratch, out, tri_ops.COUNT)
    first = out.clone()
    tri_ops.run_passes(a, scratch, out, tri_ops.COUNT)
    assert common.LAUNCHES["triangle_mm"] == before
    assert torch.equal(first, out)
    assert torch.equal(out, tri_ops.triangle_mm(a))
    with pytest.raises(RuntimeError):
        tri_ops.run_passes(a, scratch[:-1], out, tri_ops.COUNT)


@pytest.mark.parametrize("q", [
    "TY(x,y) :- R(x,y),S(y,z),T(x,z).",
    "SM(x;w:long) :- R(x,y),S(y,z),T(x,z); w=<<SUM(z)>>.",
    "MN(x;w:long) :- R(x,y),S(y,z),T(x,z); w=<<MIN(z)>>.",
    "P(y,a) :- R(x,y),S(y,z),T(x,z),U(x,a)."])
def test_materializing_query_on_card_matches_cpu(dev, q):
    """The materializing pair route on the card: rows and dispatch
    counters equal to the same engine on the CPU, through the kernel."""
    src, dst = edge_list(powerlaw_graph(2000, 12, 2.0, seed=0))
    common.reset_launches()
    out = []
    for device in ("cuda", "cpu"):
        eng = Engine(backend="device", device=device)
        eng.load_edges("Edge", src, dst)
        for a in W.ALIASES:
            eng.alias(a, "Edge")
        res = eng.query(q)
        summary = {k: v for k, v in eng.dispatch_summary().items()
                   if not k.startswith("upload")}
        out.append((res, summary))
    (g, gsum), (c, csum) = out
    assert gsum == csum
    assert gsum["intersect.materialize_kernel"] > 0
    for v in g.vars:
        np.testing.assert_array_equal(g.columns[v], c.columns[v])
    if c.annotation is not None:
        np.testing.assert_array_equal(g.annotation, c.annotation)
    assert common.LAUNCHES["materialize"] > 0


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


ELL_PACKINGS = ["width1", "width4", "width32", "one_row_per_vertex"]


def _ell_pack(offsets, neighbors, vals, packing):
    if packing == "one_row_per_vertex":   # the reference's packing
        cols, v = ell_ops.csr_to_ell(offsets, neighbors, vals)
        return cols, v, np.arange(len(offsets), dtype=np.int32)
    return ell_ops.csr_to_ell_split(offsets, neighbors, vals,
                                    width=int(packing[len("width"):]))


def _spmv_ell_f64(cols, vals, row_ptr, x):
    """The plain version's sums taken in float64 (the float32 plain version
    adds a hub's terms one by one with atomics, so its own rounding moves
    from run to run)."""
    part = (x.double()[cols.long()] * vals.double()).sum(dim=1)
    n = int(row_ptr.shape[0]) - 1
    owner = torch.repeat_interleave(
        torch.arange(n, device=x.device), (row_ptr[1:] - row_ptr[:-1]).long(),
        output_size=int(cols.shape[0]))
    return torch.zeros(n, dtype=torch.float64,
                       device=x.device).index_add_(0, owner, part)


def _check_spmv_ell(dev, packed, x):
    """Two launches, each counted, give the same bits; each vertex within
    1e-5 of its absolute sum of the plain version's sums in float64 (an
    isolated vertex exactly 0).  |kernel - float32 plain| is printed."""
    cols, vals, row_ptr = (torch.as_tensor(a, device=dev) for a in packed)
    before = common.LAUNCHES["spmv_ell"]
    got = ell_ops.spmv_ell(cols, vals, row_ptr, x)
    again = ell_ops.spmv_ell(cols, vals, row_ptr, x)
    assert common.LAUNCHES["spmv_ell"] == before + 2
    assert torch.equal(got, again)
    want = _spmv_ell_f64(cols, vals, row_ptr, x)
    abs_sum = _spmv_ell_f64(cols, vals.abs(), row_ptr, x.abs())
    assert got.shape == want.shape == (int(row_ptr.shape[0]) - 1,)
    assert bool(((got.double() - want).abs() <= 1e-5 * abs_sum).all())
    plain = spmv_ell_ref(cols, vals, row_ptr, x)
    print(f"max |kernel - float32 plain| {float((got - plain).abs().max())}")


def _csr(r, deg, nx):
    deg = np.asarray(deg, dtype=np.int64)
    offsets = np.concatenate([[0], np.cumsum(deg)])
    return offsets, r.integers(0, nx, int(offsets[-1])).astype(np.int32)


@pytest.mark.parametrize("packing", ELL_PACKINGS)
@pytest.mark.parametrize("seed", range(4))
def test_spmv_ell_kernel_matches_plain(dev, seed, packing):
    """Hubs up to 3,000 neighbours, in each packing the kernel reads: the
    CSR itself (width 1), split rows of width 4 and 32, and the
    reference's one row per vertex."""
    from repro_torch.core.trie import CSRGraph
    r = np.random.default_rng(seed)
    n = 5000
    src = np.concatenate([r.integers(0, n, 60_000), np.zeros(3000, int)])
    dst = np.concatenate([r.integers(0, n, 60_000), np.arange(3000)])
    csr = CSRGraph.from_edges(src, dst, n=n)
    vals = r.random(csr.m).astype(np.float32)
    x = torch.as_tensor(r.random(n).astype(np.float32), device=dev)
    _check_spmv_ell(dev, _ell_pack(csr.offsets, csr.neighbors, vals,
                                   packing), x)


@pytest.mark.parametrize("case", ["hub_300k", "tile_boundary",
                                  "isolated_runs", "single_row"])
def test_spmv_ell_kernel_edge_cases(dev, case):
    """A hub spanning many blocks of the merge, rows whose items end just
    before, at and after a block's boundary, runs of isolated vertices at
    both ends, and a single row; signed weights; widths 1 and 32."""
    r = np.random.default_rng(7)
    tile = ell_ops.tile_items()
    nx = 400_000
    if case == "hub_300k":
        deg = r.integers(0, 30, 1000)
        deg[17] = 300_000
    elif case == "tile_boundary":
        deg = []
        for d in (-2, -1, 0, 1, 2):
            deg += [tile + d, 5, 0, 2 * tile + d - 5, 0, 3]
    elif case == "isolated_runs":
        deg = np.concatenate([np.zeros(5000, int), r.integers(0, 9, 300),
                              np.zeros(7000, int)])
    else:
        deg = [40]
    offsets, neighbors = _csr(r, deg, nx)
    vals = (r.random(len(neighbors)) - 0.5).astype(np.float32)
    x = torch.as_tensor(r.random(nx).astype(np.float32) - 0.5, device=dev)
    for width in (1, 32):
        _check_spmv_ell(dev, ell_ops.csr_to_ell_split(
            offsets, neighbors, vals, width=width), x)


@pytest.mark.parametrize("n", [0, 5])
def test_spmv_ell_kernel_without_slots(dev, n):
    """No row (n = 0), or rows but no slot (R = 0): zeros of length n and
    no launch."""
    x = torch.ones(4, device=dev)
    for width in (1, 32):
        cols, vals, row_ptr = (torch.as_tensor(a, device=dev) for a in
                               ell_ops.csr_to_ell_split(
                                   np.zeros(n + 1, np.int64),
                                   np.zeros(0, np.int32), width=width))
        assert cols.shape == (0, width)
        before = common.LAUNCHES["spmv_ell"]
        got = ell_ops.spmv_ell(cols, vals, row_ptr, x)
        assert common.LAUNCHES["spmv_ell"] == before
        assert got.device.type == "cuda" and got.dtype == torch.float32
        assert torch.equal(got, torch.zeros(n, device=dev))


def test_entry_points_run_on_the_card(dev):
    from repro_torch.core import recursion
    from repro_torch.core.backend import DeviceBackend, make_backend
    assert make_backend(None).device.type == "cuda"
    assert Engine().backend.device.type == "cuda"
    csr = powerlaw_graph(3000, 10, 2.2, seed=1)
    b = DeviceBackend()
    before = common.LAUNCHES["spmv_ell"]
    ranks = recursion.pagerank(csr, iters=4, backend=b)
    assert common.LAUNCHES["spmv_ell"] == before + 4
    assert b.stats["spmv.ell_kernel"] == 4
    want = recursion.pagerank_np(csr, iters=4)
    np.testing.assert_allclose(ranks, want, rtol=1e-4, atol=1e-7)
    # no backend: still the card, and still the ELL kernel
    np.testing.assert_allclose(recursion.pagerank(csr, iters=4), want,
                               rtol=1e-4, atol=1e-7)
    assert common.LAUNCHES["spmv_ell"] == before + 8
    np.testing.assert_array_equal(recursion.sssp(csr, 0),
                                  recursion.sssp_np(csr, 0))


@pytest.mark.parametrize("prog", ["pagerank", "sssp"])
def test_engine_recursion_on_card_matches_host_oracle(dev, prog):
    """PageRank within relative 1e-4 of the host oracle (CUDA index_add_
    is atomic, so hub sums change order from run to run); SSSP exact;
    one device fixpoint with as many rounds as the oracle's host loop."""
    src, dst = edge_list(powerlaw_graph(3000, 10, 2.2, seed=1))
    q = W.pagerank_program(5) if prog == "pagerank" else W.sssp_program(0)
    out = []
    for backend in ("device", "numpy"):
        eng = Engine(backend=backend)
        eng.load_edges("Edge", src, dst)
        out.append((eng.query(q), eng.dispatch_summary()))
    (g, gd), (h, hd) = out
    np.testing.assert_array_equal(g.columns["x"], h.columns["x"])
    if prog == "sssp":
        np.testing.assert_array_equal(g.annotation, h.annotation)
    else:
        np.testing.assert_allclose(g.annotation, h.annotation, rtol=1e-4)
    assert gd["recursion.device_fixpoints"] == 1
    assert gd["recursion.device_rounds"] == hd["recursion.host_rounds"]
    assert gd.get("recursion.host_rounds", 0) == 0


@pytest.mark.parametrize("b,f,d", [(1, 2, 4), (33, 39, 10), (128, 16, 32),
                                   (7, 8, 8), (1000, 39, 10), (50, 3, 70)])
def test_fm_interaction_kernel_matches_plain(dev, b, f, d):
    """Within 1e-5 of each row's absolute scale of the plain version (the
    same float32 sums in another order), one launch, the same bits from
    launch to launch; a non-contiguous input is made contiguous."""
    r = np.random.default_rng(b + f + d)
    emb = torch.as_tensor(r.normal(size=(b, f, d)).astype(np.float32),
                          device=dev)
    before = common.LAUNCHES["fm_interaction"]
    got = fm_kernel_ops.fm_interaction(emb)
    assert common.LAUNCHES["fm_interaction"] == before + 1
    assert got.device.type == "cuda" and got.shape == (b,)
    assert torch.equal(got, fm_kernel_ops.fm_interaction(emb))
    want = fm_interaction_ref(emb)
    assert bool(((got - want).abs()
                 <= 1e-5 * fm_interaction_scale(emb)).all())
    t = emb.transpose(1, 2).contiguous().transpose(1, 2)
    assert not t.is_contiguous()
    assert torch.equal(fm_kernel_ops.fm_interaction(t), got)


def test_fm_interaction_kernel_edge_cases(dev):
    before = common.LAUNCHES["fm_interaction"]
    out = fm_kernel_ops.fm_interaction(torch.zeros((0, 39, 10), device=dev))
    assert out.shape == (0,) and out.device.type == "cuda"
    assert common.LAUNCHES["fm_interaction"] == before   # no empty grid
    # no backward yet: a raw launch would drop the gradient silently
    emb = torch.ones((4, 3, 2), device=dev, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        fm_kernel_ops.fm_interaction(emb)
    with torch.inference_mode():
        assert fm_kernel_ops.fm_interaction(emb).tolist() == [6.0] * 4


def test_fm_serving_on_card_matches_cpu(dev):
    """``forward``, ``retrieval_scores`` and ``batched_scores`` with the
    params on the card (the kernel) against the same calls on the CPU
    (the plain version), NaN in the same places for out-of-range ids;
    ``init`` goes to the card by default."""
    from repro_torch.data import RecsysBatchGen
    from repro_torch.models.recsys import fm
    from repro_torch.serve import batched_scores
    cfg = fm.FMConfig(name="t", n_sparse=39, vocab_per_field=1000,
                      embed_dim=10)
    p = fm.init(cfg, torch.Generator("cuda").manual_seed(0))
    assert p["emb"].device.type == "cuda"
    w = {k: v.cpu().numpy() for k, v in p.items()}
    cpu = fm.params_from_reference(w, device="cpu")
    card = fm.params_from_reference(w)
    ids = RecsysBatchGen(39, 1000, 3000, seed=1).batch_at(0)["ids"]
    ids[5, 0], ids[6, 38], ids[7, 1] = -1, 1000, -(10 ** 6)
    before = common.LAUNCHES["fm_interaction"]
    got = fm.forward(card, {"ids": ids}, cfg)
    assert common.LAUNCHES["fm_interaction"] == before + 1
    want = fm.forward(cpu, {"ids": ids}, cfg)
    assert torch.isnan(got).cpu().tolist() == torch.isnan(want).tolist()
    assert torch.isnan(want).sum() == 2
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-6,
                               equal_nan=True)
    bulk = batched_scores(lambda c: fm.forward(card, c, cfg),
                          {"ids": torch.as_tensor(ids, device=dev)}, 512)
    assert isinstance(bulk, np.ndarray)
    np.testing.assert_allclose(bulk, want.numpy(), rtol=1e-5, atol=1e-6)
    r = np.random.default_rng(2)
    users = r.integers(0, cfg.total_rows, 16).astype(np.int32)
    cands = r.integers(-cfg.total_rows - 5, cfg.total_rows + 5, 5000) \
        .astype(np.int32)
    torch.testing.assert_close(
        fm.retrieval_scores(card, users, cands, cfg).cpu(),
        fm.retrieval_scores(cpu, users, cands, cfg), rtol=1e-5, atol=1e-6,
        equal_nan=True)
