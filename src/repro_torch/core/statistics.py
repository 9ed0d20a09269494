"""Statistics catalog: sampled data profiles that drive the physical planner.

EmptyHeaded's claim is that the *compiler* closes the gap to hand-tuned
engines — but the seed planner made every physical choice from static
heuristics: a fixed ``SIMD_REGISTER_BITS`` density threshold for the
Algorithm-3 layout decision and no cardinality model at all.  This module
collects cheap, sampled statistics per trie level —

  * cardinality (level size, number of parent segments),
  * fanout (mean/max children per parent, i.e. degree for level 1),
  * skew (max/mean fanout ratio),
  * density (sampled per-segment ``range / |S|``, Algorithm 3's quantity),

and derives from them

  * per-level **extension fanout estimates** feeding the plan IR's
    ``est_rows`` annotations (``core.plan_ir``), and
  * a **data-driven Algorithm-3 threshold**: the bitset layout is chosen
    when ``range/|S| < threshold`` where the threshold sits at the
    estimated break-even between blocked AND+popcount (cost ``range /
    block_bits`` word ops) and per-element probing (cost ``|S| * log2(d)``
    comparisons), instead of the paper's fixed 256-bit register width.

Statistics are cached on the trie object itself (the codebase idiom for
derived per-trie indexes, cf. ``Trie._hybrid_stores``), so repeated
queries and recursion rounds over the same relation pay the profiling
cost once.  Index/statistics build time is excluded from query timing,
as in the paper.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np

# Baseline block width of the blocked-bitset layout (the paper's AVX
# register width); the data-driven threshold scales it by the estimated
# per-element probe cost. Mirrors layouts.SIMD_REGISTER_BITS without
# importing layouts (which imports this module).
BASE_BLOCK_BITS = 256
MAX_THRESHOLD_BITS = 4096  # the reference's block-width ceiling
SAMPLE_SEGMENTS = 512


@dataclasses.dataclass(frozen=True)
class LevelStats:
    """Profile of one trie level (a CSR of values grouped by parent)."""

    size: int                 # number of values at this level
    n_parents: int            # number of parent segments
    mean_fanout: float        # mean values per parent segment
    max_fanout: int           # largest segment
    skew: float               # max_fanout / mean_fanout (>= 1)
    mean_inv_density: float   # sampled mean of range/|S| per segment
    value_range: int          # max - min + 1 over the whole level
    # Evenly-spaced subsample of the per-segment range/|S| values (<= 64
    # entries) — lets the cost model estimate the Algorithm-3 dense-cohort
    # fraction at ANY threshold, not just the mean.
    inv_density_sample: Tuple[float, ...] = ()


@dataclasses.dataclass(frozen=True)
class TrieStats:
    """Per-level profiles of one trie."""

    name: str
    arity: int
    num_tuples: int
    levels: Tuple[LevelStats, ...]

    def candidates_at(self, depth: int) -> float:
        """Expected candidate-set size when an atom extends at ``depth``:
        the whole first level at depth 0, one parent segment after."""
        if depth >= len(self.levels):
            return 1.0
        if depth == 0:
            return float(max(1, self.levels[0].size))
        return max(self.levels[depth].mean_fanout, 1e-6)

    def universe_at(self, depth: int) -> float:
        """Domain size estimate for selectivity at ``depth`` (the value
        range of the level — dictionary-encoded ids are dense-ish)."""
        if depth >= len(self.levels):
            return 1.0
        return float(max(1, self.levels[depth].value_range))


def _level_stats(values: np.ndarray, offsets: np.ndarray,
                 sample: int = SAMPLE_SEGMENTS) -> LevelStats:
    size = int(len(values))
    n_parents = int(len(offsets) - 1)
    deg = np.diff(offsets)
    if size == 0 or n_parents == 0:
        return LevelStats(size, n_parents, 0.0, 0, 1.0, float("inf"), 0)
    mean_fanout = float(deg.mean())
    max_fanout = int(deg.max())
    skew = float(max_fanout / mean_fanout) if mean_fanout > 0 else 1.0
    # Sampled per-segment inverse density (Algorithm 3's range/|S|):
    # evenly-spaced non-empty segments, min/max read straight off the
    # sorted values.
    nz = np.flatnonzero(deg > 0)
    if len(nz) > sample:
        nz = nz[np.linspace(0, len(nz) - 1, sample).astype(np.int64)]
    lo = values[offsets[nz]]
    hi = values[offsets[nz + 1] - 1]
    inv = (hi.astype(np.int64) - lo.astype(np.int64) + 1) / deg[nz]
    mean_inv_density = float(inv.mean()) if len(inv) else float("inf")
    if len(inv) > 64:
        inv_sample = inv[np.linspace(0, len(inv) - 1, 64).astype(np.int64)]
    else:
        inv_sample = inv
    value_range = int(values.max()) - int(values.min()) + 1
    return LevelStats(size, n_parents, mean_fanout, max_fanout, skew,
                      mean_inv_density, value_range,
                      tuple(np.round(inv_sample, 4).tolist()))


def collect_trie_stats(trie, sample: int = SAMPLE_SEGMENTS) -> TrieStats:
    """Profile every level of ``trie``; cached on the trie object."""
    token = tuple(id(lv.values) for lv in trie.levels)
    cached = getattr(trie, "_trie_stats", None)
    if cached is not None and cached[0] == token:
        return cached[1]
    levels = tuple(_level_stats(lv.values, lv.offsets, sample)
                   for lv in trie.levels)
    stats = TrieStats(trie.name, trie.arity, trie.num_tuples, levels)
    trie._trie_stats = (token, stats)
    return stats


def layout_threshold(stats: TrieStats,
                     block_bits: int = BASE_BLOCK_BITS) -> float:
    """Data-driven Algorithm-3 threshold for the trie's set level.

    Break-even model: for a set S with range r and the probe side holding
    d elements, the bitset path costs ~``r / block_bits`` blocked word
    ops while the uint path costs ~``d * log2(d_max)`` branch-free
    searches — so bitset wins when ``r/|S| < block_bits * log2(d_max)``.
    The skew term widens the window further on skewed degree
    distributions, where the search cost is dominated by probes into hub
    sets.  Clamped to [block_bits, MAX_THRESHOLD_BITS] so the decision
    never regresses below the paper's constant.
    """
    ls = stats.levels[-1]
    if ls.size == 0:
        return float(block_bits)
    probe_cost = math.log2(2.0 + ls.mean_fanout)
    skew_bonus = 1.0 + math.log2(1.0 + ls.skew) / 8.0
    thr = block_bits * probe_cost * skew_bonus
    return float(min(max(thr, block_bits), MAX_THRESHOLD_BITS))


def layout_threshold_for(trie, block_bits: int = BASE_BLOCK_BITS) -> float:
    """Convenience entry point used by ``layouts.engine_store_for`` when
    no plan-IR annotation supplies a threshold."""
    return layout_threshold(collect_trie_stats(trie), block_bits)


class StatisticsCatalog:
    """Engine-lifetime facade over the per-trie profiles.

    One instance lives per :class:`~repro_torch.core.engine.Engine`; the plan-IR
    builder pulls all cardinality/fanout/layout inputs through it so every
    physical decision is attributable to a recorded statistic.
    """

    def __init__(self, sample: int = SAMPLE_SEGMENTS,
                 block_bits: int = BASE_BLOCK_BITS):
        self.sample = sample
        self.block_bits = block_bits

    def stats_for(self, trie) -> TrieStats:
        return collect_trie_stats(trie, self.sample)

    def threshold_for(self, trie) -> float:
        return layout_threshold(self.stats_for(trie), self.block_bits)

    # ------------------------------------------------------- estimation
    def extension_profile(self, cons: list,
                          universe_hint: Optional[float] = None):
        """Candidate-set profile of one attribute extension:
        ``(fanout, min_cand, max_cand, universe)``.

        ``cons`` lists ``(TrieStats | None, depth, est_rows)`` — or
        4-tuples ``(..., arity)`` for child-bag inputs — for every
        constraining input: physical atoms carry their profiled stats;
        child-bag pseudo relations are modelled as ``est_rows`` uniform
        tuples over the co-constraining atoms' value universe ``U``
        (level-0 distinct values ``min(rows, U)``, deeper fanout
        ``rows / U^depth``; without a universe, ``rows^(1/arity)`` per
        level).  Independence model: the smallest candidate set seeds
        (the min property), every other input keeps a candidate with
        probability ``|C_other| / U``.
        """
        atom_cands = []
        child_cons = []
        universes = [universe_hint] if universe_hint else []
        for con in cons:
            stats, depth, est_rows = con[0], con[1], con[2]
            arity = con[3] if len(con) > 3 else 2
            if stats is not None:
                atom_cands.append(stats.candidates_at(depth))
                universes.append(stats.universe_at(depth))
            else:
                child_cons.append((depth, max(1.0, float(est_rows)),
                                   max(1, int(arity))))
        universe = max(universes) if universes else None
        cands = list(atom_cands)
        for depth, rows, arity in child_cons:
            if universe is None:
                cands.append(rows ** (1.0 / arity))
            elif depth == 0:
                cands.append(min(rows, universe))
            else:
                cands.append(max(1.0, rows / universe ** depth))
        if not cands:
            return 1.0, 1.0, 1.0, 1.0
        if universe is None:
            universe = max(cands)
        universe = max(universe, 1.0)
        cands.sort()
        est = cands[0]
        for c in cands[1:]:
            est *= min(1.0, c / universe)
        return max(est, 1e-9), cands[0], cands[-1], universe

    def extension_estimate(self, cons: list, universe_hint: Optional[float]
                           = None) -> float:
        """Estimated per-frontier-row fanout of one attribute extension
        (the fanout component of :meth:`extension_profile`)."""
        return self.extension_profile(cons, universe_hint)[0]


# ------------------------------------------------------------- cost model
# Relative per-element op weights of the plan-search cost model
# (``plan_ir`` sums these into per-operator ``cost`` fields). The unit is
# "one vectorized element touch"; what matters for plan choice is the
# RATIO between layout cohorts — the blocked-bitset AND+popcount fold
# touches words (many set elements per op), the uint kernel touches
# elements, and the lockstep binary search pays a log factor per probe.
COST_PROBE = 0.25        # one branch-free binary-search probe, per log step
COST_BITSET_WORD = 0.04  # blocked AND+popcount, per 32-bit word
COST_UINT_PROBE = 0.5    # uint-kernel membership test, per element
COST_SORT = 1.0          # sort-based group-by (np.unique), per element-log
COST_REDUCE = 0.25       # segment reduce, per element
COST_COUNT_ONLY = 0.05   # single-atom fold: (hi - lo), per frontier row
COST_ALLOC = 0.002       # static frontier-buffer slot (zero/scatter traffic)

# ------------------------------------------------- pipeline buffer sizing
# The zero-sync extension pipeline (core.backend.DeviceBackend) fills a
# STATIC-shaped frontier buffer per extension; its capacity is decided
# here, once, from the statistics the plan IR already computed.
CAP_HEADROOM = 2.0           # slack over est_rows before the cross clamp
PIPELINE_MAX_BUFFER = 1 << 22  # rows; beyond this the pipeline disengages
PIPELINE_MIN_BUCKET = 8      # smallest frontier-buffer capacity bucket
DEFAULT_MORSEL = 256
MORSEL_CHUNK_SHIFT = 5       # fill loops run at most 2**5 = 32 chunks/buffer

# ---------------------------------------------- sideways bitset filtering
# The counting pass intersects a probe atom's bitset BLOCK directory with
# the candidate envelope when the plan IR expects its set level to be
# dominated by the Algorithm-3 dense cohort: pruning before expansion
# only pays where most probed rows actually own a bitset.
SIDEWAYS_DENSITY_MIN = 0.5
# plan-search credit for a sideways-annotated extension: the counting
# pass prunes rows (and snaps the envelope to populated blocks) before
# the expansion is sized, so the modelled expansion work shrinks.
SIDEWAYS_COST_CREDIT = 0.85


def default_morsel(est_peak_rows: float) -> int:
    """Stats-chosen morsel (fill-chunk) size: scale with the estimated
    peak frontier so tiny queries don't pay 4k-row chunks while large
    frontiers amortize the per-chunk loop overhead.  Power of two in
    [64, 2048]."""
    if not math.isfinite(est_peak_rows) or est_peak_rows <= 0:
        return DEFAULT_MORSEL
    target = max(64.0, min(2048.0, est_peak_rows / 8.0))
    return 1 << max(6, math.ceil(math.log2(target)))


def frontier_capacity(est_cap: Optional[float], cross_bound: int,
                      morsel: int,
                      max_buffer: int = PIPELINE_MAX_BUFFER) -> int:
    """Static buffer capacity for one pipelined extension.

    ``est_cap`` is the plan IR's stats-informed allocation target (the
    AGM-capped ``est_rows`` with :data:`CAP_HEADROOM` slack); it is
    clamped to ``cross_bound`` — the TRUE cross-product bound of the
    extension, computed exactly from the live tries — so a wildly
    inflated estimate can never oversize the buffer beyond what the data
    could produce, and to ``max_buffer``.  Degenerate estimates (missing,
    NaN, infinite or negative — i.e. statistics were absent when the plan
    was built) raise instead of silently sizing a wrong buffer: an
    undersized buffer would be caught by the overflow flag, but a
    garbage-sized one is a planner bug we want loud.

    The result is bucketed to a power of two (floor
    :data:`PIPELINE_MIN_BUCKET`) so repeated queries allocate from a small
    set of bucketed shapes.  The slack over the estimate scales WITH the
    estimate (half of it, at least 4 rows): sizing slack off the morsel
    made an est≈1 extension balloon to a full morsel-sized buffer, a
    256x over-allocation that the fill loop then zeroed and scattered
    every step (the fill morsel is clamped to the capacity downstream,
    so a small bucket never starves the chunk loop).  All arithmetic is
    Python-int: a pathological ``cross_bound`` (e.g. a dense trie
    squared) cannot overflow into a negative numpy capacity.
    """
    if morsel <= 0:
        raise ValueError(f"morsel size must be positive, got {morsel}")
    if cross_bound < 0:
        raise ValueError(f"negative cross-product bound {cross_bound}")
    if est_cap is None or not math.isfinite(est_cap) or est_cap < 0:
        raise ValueError(
            "frontier-buffer sizing needs a finite statistics-informed "
            f"estimate; got {est_cap!r} (statistics missing or degenerate "
            "when the physical plan was built)")
    cross = min(int(cross_bound), 1 << 62)
    slack = max(4, int(est_cap) >> 1)
    cap = min(int(est_cap) + slack, cross, int(max_buffer))
    cap = max(cap, 1)
    # bucket: power of two, so repeated queries over similar
    # cardinalities reuse the compiled step
    bucket = PIPELINE_MIN_BUCKET
    while bucket < cap:
        bucket <<= 1
    return bucket


def max_batch(cap_rows: int,
              max_buffer: int = PIPELINE_MAX_BUFFER) -> int:
    """How many same-shape query instances one vmapped bag launch may
    carry: the batched pipeline allocates every frontier buffer B times
    (leading batch axis), so B is sized to keep the LARGEST per-query
    buffer within the same total-row budget the single-query pipeline
    enforces.  Bigger batches split into consecutive launches."""
    return max(1, int(max_buffer) // max(int(cap_rows), 1))


def buffer_cost(cap: float) -> float:
    """Modelled cost of one extension's static frontier buffer: every
    slot is zeroed/scattered whether or not a row lands in it, so the
    plan search (``core.plan_search``) sees over-allocation — attribute
    orders with tighter intermediate estimates win ties."""
    return max(cap, 0.0) * COST_ALLOC


def _log2(x: float) -> float:
    return math.log2(2.0 + max(0.0, x))


def dense_fraction(ls: LevelStats, threshold: float) -> float:
    """Estimated fraction of the level's sets in the Algorithm-3 dense
    (bitset) cohort at ``threshold``, from the sampled inverse densities."""
    if ls.inv_density_sample:
        below = sum(1 for d in ls.inv_density_sample if d < threshold)
        return below / len(ls.inv_density_sample)
    if ls.size == 0:
        return 0.0
    return 1.0 if ls.mean_inv_density < threshold else 0.0


def extension_cost(frontier: float, min_cand: float, max_cand: float,
                   n_cons: int) -> float:
    """Modelled work of one materializing attribute extension: expand the
    min-property seed, then probe every other input with the lockstep
    binary search."""
    expanded = max(frontier, 1.0) * max(min_cand, 1.0)
    return expanded * (1.0 + COST_PROBE * max(0, n_cons - 1)
                       * _log2(max_cand))


def fold_cost(frontier: float, min_cand: float, max_cand: float,
              n_cons: int, routing: str,
              set_stats: Optional[LevelStats],
              threshold: Optional[float],
              block_bits: int = BASE_BLOCK_BITS) -> float:
    """Modelled work of the early-aggregation terminal fold.

    ``pair_kernel`` routes cost through the layout cohorts: bitset-cohort
    pairs pay word ops (``range / 32`` per pair), uint-cohort pairs pay
    per-element probes — so on dense data the SAME fold is modelled
    cheaper than the generic search path, which is the lever that lets
    the plan search prefer orders whose folds land on kernel-friendly
    cohorts."""
    F = max(frontier, 1.0)
    if n_cons <= 1:
        return F * COST_COUNT_ONLY
    if routing == "pair_kernel" and set_stats is not None:
        thr = threshold if threshold is not None else float(block_bits)
        df = dense_fraction(set_stats, thr)
        d = max(set_stats.mean_fanout, 1.0)
        per_bitset = max(1.0, d * min(set_stats.mean_inv_density, thr)
                         / 32.0) * COST_BITSET_WORD
        per_uint = d * COST_UINT_PROBE
        per_search = d * COST_PROBE * _log2(d)
        # mixed (uint x bitset) pairs probe element-wise; weight the three
        # cohort combinations by the dense fraction.
        per_pair = (df * df * per_bitset
                    + 2.0 * df * (1.0 - df) * per_uint
                    + (1.0 - df) * (1.0 - df) * min(per_uint, per_search))
        return F * per_pair
    # generic fold: materialize the expansion locally, then segment-reduce
    expanded = F * max(min_cand, 1.0)
    return (extension_cost(frontier, min_cand, max_cand, n_cons)
            + expanded * COST_REDUCE)


def projection_cost(rows: float, has_extra_vars: bool,
                    scalar_output: bool) -> float:
    """Modelled cost of a bag's final projection: sort-based group-by when
    non-output attributes survive in the frontier, a segment reduce for
    scalar aggregates, free when the frontier already matches the
    output."""
    R = max(rows, 1.0)
    if has_extra_vars:
        return R * _log2(R) * COST_SORT
    if scalar_output:
        return R * COST_REDUCE
    return 0.0
