// frontier_fill: the fill stage of the zero-sync count-then-fill extension.
//
// Replaces the TPU kernel src/repro/kernels/frontier_fill/kernel.py
// (make_fill_kernel, launched from ops.py::fill_chunk), which fills one
// morsel chunk per launch from inside the bag program's while-loop.
//
// For every output slot j in [start, start + n):
//   1. upper-bound search of j in the exclusive-scan offsets gives the
//      source frontier row;
//   2. p0 = lo0[row] + (j - offs[row]) and the seed value seed[p0];
//   3. per probe atom, a lower-bound search of the value in the row's
//      candidate segment [lo_k[row], hi_k[row]); membership is AND-ed
//      into keep and the position is written out.
// Slots at or past *total_c (read from device memory, so the host never
// learns the frontier size) are masked: keep = 0 and every other output 0.
// Every position and row equals what the reference's lockstep lower/upper-
// bound loops return, clip rules included, so the outputs are bit-exact.
//
// What bounds it on the H100: dependent loads.  A slot reads its row, its
// seed value and log2 of each probe segment in scattered 4-byte values;
// there is no arithmetic to speak of, so the chain of loads a warp waits
// on sets the time.  Design: one thread per slot, 256 threads a block,
// read-only loads through the texture path (__ldg), and two searches that
// the warp makes together to shorten each slot's chain:
//   * the row: the 32 lanes find the row of the warp's first slot at once,
//     32 probes of offs a step (3 dependent loads over 32,768 rows, where a
//     slot's own binary search takes 15); the next 31 row ends are read
//     once, a lane each, and each lane finds its slot's row among them by
//     five shuffles, its offset with it.  A warp inside one row skips the
//     shuffles; a slot past those ends (31 or more empty rows among the
//     warp's slots) searches the rest of offs alone.
//   * a long probe segment (past kNarrowMin, inside the level) that every
//     lane searches: 32 probes of it a step, each lane keeping the part
//     between the two that bracket its value, while every lane keeps the
//     same part; then each lane's own binary search.  The segment is
//     sorted (a trie level), so the lower bound is the reference's.  A hub
//     row of a million slots takes 3 such steps and 5 loads of its own, not
//     20.
// A merge-path design (the fold's, below: rows from staged row ends, each
// row's probes walked from where the warp's previous slots left them)
// found rows faster but searched the main path's short rows slower and
// lost its call on the H100; a slot a thread keeps 64 warps an SM in
// flight on 32 registers.
//
// The batched bag program (prepared queries re-bound B times, the serving
// path) launches frontier_fill_batched_kernel: B queries over the same
// levels, each with its own per-row arrays and total, once a step.  The
// reference vmaps the fill's plain version (src/repro/core/backend.py:827);
// here each query takes whole warps of a one-dimensional grid and runs this
// code as it is (a batch may hold more queries than gridDim.y's 65,535).
//
// The same source holds frontier_fold, the device terminal fold (its own
// header below), which folds a batch as one merge path over all its rows,
// with the probe segments its anchored queries share staged first.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#define FF_MAX_PROBES 8

struct FillProbe {
  const int32_t* vals;  // probe level values [n]
  const int32_t* lo;    // per-row candidate segment start [cap_in]
  const int32_t* hi;    // per-row candidate segment end [cap_in]
  int32_t n;
};

struct FillProbes {
  FillProbe p[FF_MAX_PROBES];
  int32_t count;
};

__device__ __forceinline__ int32_t clamp_i32(int32_t x, int32_t lo,
                                             int32_t hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

constexpr unsigned kFillFull = 0xffffffffu;
// A probe segment the warp narrows together is longer than this.
constexpr int32_t kNarrowMin = 64;

// The least x in [0, cap_in] with offs[x] > j (x = cap_in if none): the
// reference's upper bound over the sorted offs.  The whole warp searches,
// 32 probes a step; j is the same in every lane.
__device__ __forceinline__ int32_t warp_upper_bound(
    const int32_t* __restrict__ offs, int32_t cap_in, int32_t j) {
  const int lane = threadIdx.x & 31;
  int32_t lo = 0, hi = cap_in;
  while (lo < hi) {  // lo and hi are the same in every lane
    const int32_t p = lo + (int32_t)((int64_t)(hi - lo) * (lane + 1) / 33);
    const unsigned m = __ballot_sync(kFillFull, __ldg(offs + p) > j);
    const int k = m ? __ffs(m) - 1 : 32;  // first probe past j
    const int32_t at = __shfl_sync(kFillFull, p, k & 31);
    const int32_t before = __shfl_sync(kFillFull, p, (k + 31) & 31);
    hi = k < 32 ? at : hi;
    lo = k > 0 ? before + 1 : lo;
  }
  return lo;
}

// Output slot start + i of one query.  Its per-row arrays (offs, lo0 and
// the probes' lo and hi) start q_row rows in; probe k's position goes to
// pos_o[k * pos_stride + i].  The whole warp comes here for one query.
__device__ __forceinline__ void fill_slot(
    const int32_t* __restrict__ total_c, const int32_t* __restrict__ offs,
    const int32_t* __restrict__ lo0, int32_t cap_in,
    const int32_t* __restrict__ seed, int32_t n0, const FillProbes& probes,
    int64_t q_row, int64_t start, int64_t n, int64_t i, int64_t pos_stride,
    int32_t* __restrict__ vals_o, int32_t* __restrict__ row_o,
    int32_t* __restrict__ p0_o, bool* __restrict__ keep_o,
    int32_t* __restrict__ pos_o) {
  const int lane = threadIdx.x & 31;
  // the live slots end at the total or the window's end
  const int64_t live_end = min((int64_t)__ldg(total_c), start + n);
  const int64_t jj = start + i;
  if (jj - lane >= live_end) {  // every slot of the warp dead
    if (i >= n) return;
    vals_o[i] = 0;
    row_o[i] = 0;
    p0_o[i] = 0;
    keep_o[i] = false;
    for (int k = 0; k < probes.count; ++k) pos_o[k * pos_stride + i] = 0;
    return;
  }
  // Every lane of the warp runs on to its end (the grid rounds n up to
  // whole blocks) and joins the warp's shuffles; a dead lane works as the
  // warp's last live slot and writes 0.
  const int64_t last = min(jj - lane + 31, live_end - 1);
  const bool live = jj < live_end;
  const int32_t j = (int32_t)(live ? jj : last);
  // (the window from offs[-1] holds every end of up to 31 rows)
  const int32_t u =
      cap_in > 31 ? warp_upper_bound(offs, cap_in, (int32_t)(jj - lane)) : 0;
  // w_k = offs[u - 1 + k]: w_0 <= every j of the warp, and ascending
  const int32_t x = u - 1 + lane;
  const int32_t w = x < 0 ? INT32_MIN : (x < cap_in ? __ldg(offs + x)
                                                    : INT32_MAX);
  int c = 0;  // the last k with w_k <= j
  int32_t ub = u;
  int32_t off = __shfl_sync(kFillFull, w, 0);
  if (__shfl_sync(kFillFull, w, 1) <= (int32_t)last) {  // more than one row
#pragma unroll
    for (int s = 16; s > 0; s >>= 1)
      if (__shfl_sync(kFillFull, w, c + s) <= j) c += s;
    ub = u + c;
    off = __shfl_sync(kFillFull, w, c);
    if (__shfl_sync(kFillFull, w, 31) <= j) {  // past the window's ends
      int32_t lo = u + 31, hi = cap_in;
      while (lo < hi) {
        int32_t mid = lo + ((hi - lo) >> 1);
        if (__ldg(offs + mid) <= j) lo = mid + 1; else hi = mid;
      }
      ub = lo;
      off = __ldg(offs + ub - 1);
    }
  }
  const int32_t row = ub > 0 ? ub - 1 : 0;  // the reference's clamp
  if (ub == 0) off = __ldg(offs);
  const int32_t p0 = __ldg(lo0 + row) + (j - off);
  const int32_t v = __ldg(seed + clamp_i32(p0, 0, n0 > 0 ? n0 - 1 : 0));
  bool keep = live;

  for (int k = 0; k < probes.count; ++k) {
    const FillProbe pr = probes.p[k];
    int32_t plo = __ldg(pr.lo + q_row + row);
    int32_t phi = __ldg(pr.hi + q_row + row);
    const int32_t end = phi;
    // While the whole warp searches one long segment inside the level, it
    // narrows it together: 32 probes a step, each lane keeping the part
    // between the two that bracket its value.
    for (;;) {
      if (!__all_sync(kFillFull, plo >= 0 && phi <= pr.n &&
                                     phi - plo > kNarrowMin))
        break;
      // (every lane reaches each shuffle: none sits behind a short circuit)
      const int32_t lo_0 = __shfl_sync(kFillFull, plo, 0);
      const int32_t hi_0 = __shfl_sync(kFillFull, phi, 0);
      if (!__all_sync(kFillFull, plo == lo_0 && phi == hi_0)) break;
      const int32_t q =
          plo + (int32_t)((int64_t)(phi - plo) * (lane + 1) / 33);
      const int32_t at = __ldg(pr.vals + q);
      int b = 0;  // how many probes lie below v
#pragma unroll
      for (int s = 16; s > 0; s >>= 1)
        if (__shfl_sync(kFillFull, at, b + s - 1) < v) b += s;
      if (__shfl_sync(kFillFull, at, 31) < v) b = 32;
      const int32_t q_lo = __shfl_sync(kFillFull, q, (b + 31) & 31);
      const int32_t q_hi = __shfl_sync(kFillFull, q, b & 31);
      phi = b < 32 ? q_hi : phi;
      plo = b > 0 ? q_lo + 1 : plo;
    }
    while (plo < phi) {
      int32_t mid = plo + ((phi - plo) >> 1);
      if (__ldg(pr.vals + clamp_i32(mid, 0, pr.n - 1)) < v) plo = mid + 1;
      else phi = mid;
    }
    bool found = pr.n > 0 && plo < end &&
                 __ldg(pr.vals + clamp_i32(plo, 0, pr.n - 1)) == v;
    if (i < n) pos_o[k * pos_stride + i] = live ? plo : 0;
    keep = keep && found;
  }
  if (i < n) {
    vals_o[i] = live ? v : 0;
    row_o[i] = live ? row : 0;
    p0_o[i] = live ? p0 : 0;
    keep_o[i] = keep;
  }
}

__global__ void __launch_bounds__(256) frontier_fill_kernel(
    const int32_t* __restrict__ total_c, const int32_t* __restrict__ offs,
    const int32_t* __restrict__ lo0, int32_t cap_in,
    const int32_t* __restrict__ seed, int32_t n0, FillProbes probes,
    int64_t start, int64_t n, int32_t* __restrict__ vals_o,
    int32_t* __restrict__ row_o, int32_t* __restrict__ p0_o,
    bool* __restrict__ keep_o, int32_t* __restrict__ pos_o) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  fill_slot(total_c, offs, lo0, cap_in, seed, n0, probes, 0, start, n, i, n,
            vals_o, row_o, p0_o, keep_o, pos_o);
}

// The batched fill: `batch` queries over shared levels, each with its own
// total, offsets, seed starts and probe bounds ([batch, cap_in]) and its own
// n output slots ([batch, n]; the positions [n_probes, batch, n]).  Query b
// takes `per_query` threads (n rounded up to whole warps), so each warp
// serves one query and runs the single fill's code as it is; the grid is
// one-dimensional, since a batch may hold more queries than gridDim.y.
__global__ void __launch_bounds__(256) frontier_fill_batched_kernel(
    const int32_t* __restrict__ total_c, const int32_t* __restrict__ offs,
    const int32_t* __restrict__ lo0, int32_t cap_in,
    const int32_t* __restrict__ seed, int32_t n0, FillProbes probes,
    int64_t batch, int64_t n, int64_t per_query,
    int32_t* __restrict__ vals_o, int32_t* __restrict__ row_o,
    int32_t* __restrict__ p0_o, bool* __restrict__ keep_o,
    int32_t* __restrict__ pos_o) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t b = t / per_query;
  if (b >= batch) return;  // whole warps: per_query is a multiple of 32
  const int64_t i = t - b * per_query;
  const int64_t q_row = b * cap_in, q_out = b * n;
  fill_slot(total_c + b, offs + q_row, lo0 + q_row, cap_in, seed, n0, probes,
            q_row, 0, n, i, batch * n, vals_o + q_out, row_o + q_out,
            p0_o + q_out, keep_o + q_out, pos_o + q_out);
}

// ------------------------------------------------------------- the fold
// frontier_fold: the device terminal fold.  Replaces no Pallas kernel: the
// reference folds inside the bag program with a data-dependent jnp
// while-loop over fill chunks (src/repro/core/backend.py:1091,
// _fold_body): candidate j in [0, total) finds its row by searchsorted
// over the exclusive-scan offsets, is probed like a fill slot, and its
// semiring contribution (one times the leaf annotations at its positions)
// is segment-reduced onto the row with the support count.  Eagerly on the
// card that loop would need the total on the host, so the fold is one
// kernel here (and a small fix-up), reading the total on the device.
//
// What bounds it on the H100: loads, not bytes.  Each candidate reads its
// seed value and, for each probe, searches the row's probe segment for its
// lower bound: scattered 4-byte reads, log2 of the segment of them; the
// per-row arrays (offs, lo0, the probes' bounds, the outputs) are read or
// written once.  The capacity cap_in comes from the planner's estimate and
// most of its rows may be dead, so a design that pays per row (a warp
// each) pays for rows with nothing.
//
// Design: merge-path balancing over the live candidates (Merrill &
// Garland, SC'16), as in spmv_ell.cu.
//   1. The work is the merge of the cap_in row ends with the total
//      candidates: cap_in + total items, total read on the device.  The
//      grid is a fixed kBlocks, not sized from the data; block b takes
//      an equal share of the items, whole tiles of kTile, so a hub row
//      spans blocks and a run of empty rows costs one item a row.
//   2. Two warps find the share's ends on the merge path (32-way searches
//      of offs); then a thread each finds the block's tile boundaries
//      inside them.  A tile stages its rows' ends in shared memory.
//   3. The probes, warp by warp over 32 consecutive candidates at a time:
//      a lane finds its candidate's row among the staged ends (from its
//      previous row on, whose data it keeps), the seed values are read
//      coalesced, and the lanes of one row search the same segment.  A
//      row's candidates ascend, so their lower bounds do too: a lane's
//      search starts where the warp's previous 32 left its row, not at
//      the segment's start.  The searches of all probes advance together
//      in branch-free halving steps, kept to a few instructions: on the
//      H100 fewer instructions a candidate shortened this phase, more
//      warps in flight did not.  Every position equals the reference's
//      lockstep lower bound, clip rules included, because the segment is
//      sorted (a trie level); a candidate below the last of the previous
//      32 (never on a sorted seed segment) searches the whole segment.
//   4. Reduction without atomics.  Each thread takes kItems consecutive
//      items of the tile's merge and folds their contributions in order;
//      a row it ends after its first one goes straight to shared memory;
//      its first row may have begun in the threads before it, so a
//      block-wide segmented scan by row over the threads' carries (and the
//      carry of the block's previous tile) completes it.  The tile's rows
//      are then written coalesced.  The row still open at the share's end
//      leaves a (row, partial, hits) carry in scratch sized from
//      kBlocks; a second, small kernel adds to each row that a block
//      completed the carries of the blocks before it for that row, in a
//      fixed order.  Two launches on the same card give the same bits for
//      every semiring, float sums included; the order differs from a
//      sequential sum, so a float sum agrees with the plain version within
//      float32 rounding.
//   5. The probe count is a template parameter (0, 1, 2, and a path for
//      up to FF_MAX_PROBES); the descriptors are __grid_constant__ and
//      indexed only by unrolled constants, so no thread copies them.  The
//      semiring op is a uniform runtime argument (as fast as a template
//      parameter on the H100).
//   6. The batched fold (Rows = Batch, fold_batched_kernel) folds B
//      queries' rows as one merge path.  An anchored query (a prepared
//      query re-bound, the serving path) probes one segment from every
//      row: triangle_at's T(0,z) is the anchor's adjacency for each of its
//      y rows.  Searched in device memory, that cost a candidate about 13
//      dependent L2 reads.  So a first kernel (fold_stage_kernel: up to
//      kStageBlocks blocks taking the queries in turn, and one that scans
//      the totals into base) stages the segments of the first row with a
//      candidate of each query with kStageMin candidates, as a bitmap
//      over the value range (running counts too where the probe is
//      annotated), in device memory; the fold starts while it ends
//      (programmatic dependent launch) and waits for it.  Per tile, a
//      row's query is one 32-bit division while the row ends are staged,
//      beside each row's seed base (in s_supp's space until the fold) and
//      a check of each row with a candidate against its query's staged
//      bounds; a tile that passes reads a lane's kRounds seed values at
//      once and answers each probe by one read of the bitmap, which stays
//      in L1 while the SM's blocks fold that query.  A tile whose rows
//      differ, or span two queries, or whose segment is past the budget,
//      outside its level or not strictly ascending, keeps step 3.  Staging
//      in shared memory instead (a block's bitmap of each segment it
//      meets) lost on the H100: the reservation left 3 blocks an SM and
//      less L1, and the tiles that search in device memory slowed by a
//      quarter.  Steps 1, 2 and 4 and the carry kernel are the same, so
//      the reduction order and bits are too.
// A warp for each row is simpler and spends less on live candidates, but
// pays a warp for each dead row of the capacity and puts a hub row on one
// warp: on the H100 it lost the main path's call by 8%, and a row of a
// million candidates took 142 ms against 0.08 ms here.
// Rows with no candidate get the semiring's zero and support 0.

struct FoldAnns {
  const void* p[FF_MAX_PROBES + 1];  // [0]: seed atom, [k + 1]: probe k
  int32_t n[FF_MAX_PROBES + 1];
};

namespace fold {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// Items of the merge a thread walks: odd, so that lanes walking a run of
// candidates touch shared memory at an odd stride, free of bank conflicts.
constexpr int kItems = 7;
constexpr int kTile = kThreads * kItems;
// The blocks of every launch, whatever the data; the carries' scratch
// holds a slot each.  On the H100's 132 SMs that is several waves of
// resident blocks: smaller shares even out the blocks whose items cost
// more than others'.
constexpr int kBlocks = 4096;
constexpr unsigned kFull = 0xffffffffu;

// Semiring ops by code: 0 (+, *) count/sum, 1 (min, +) min_plus,
// 2 (max, min) max_min, 3 (or, and) boolean.
template <typename T>
__device__ __forceinline__ T sr_add(int op, T a, T b) {
  switch (op) {
    case 0: return a + b;
    case 1: return b < a ? b : a;
    case 2: return b > a ? b : a;
    default: return (T)(a || b);
  }
}

template <typename T>
__device__ __forceinline__ T sr_mul(int op, T a, T b) {
  switch (op) {
    case 0: return a * b;
    case 1: return a + b;
    case 2: return b < a ? b : a;
    default: return (T)(a && b);
  }
}

template <typename T>
__device__ __forceinline__ T shfl_up(T v, int o) {
  return __shfl_up_sync(kFull, v, o);
}

template <>
__device__ __forceinline__ uint8_t shfl_up<uint8_t>(uint8_t v, int o) {
  return (uint8_t)__shfl_up_sync(kFull, (int)v, o);
}

template <typename T>
__device__ __forceinline__ T shfl_xor(T v, int o) {
  return __shfl_xor_sync(kFull, v, o);
}

template <>
__device__ __forceinline__ uint8_t shfl_xor<uint8_t>(uint8_t v, int o) {
  return (uint8_t)__shfl_xor_sync(kFull, (int)v, o);
}

// Where the rows' candidates lie on the candidate axis.  One query: row x
// starts at offs[x] and ends at offs[x + 1] (the last at the total), in
// int32.  A batch (the batched fold): query b's cap_in rows are rows
// b * cap_in .. of the launch, each query's axis follows the queries'
// before it (base[b], the exclusive scan of the totals, in int64 since the
// sum of a batch's totals may pass 2^31), and base[batch] is the total.
// So a batch folds as one merge path over all its rows, and no carry
// crosses a query: rows of two queries are two rows.
// Each is built inside the kernel from its (restrict) parameters.
struct OneQuery {
  using Coord = int32_t;
  const int32_t* offs;
  const int32_t* total_c;
  int32_t cap_in;
  __device__ __forceinline__ OneQuery(const int32_t* o, const int32_t* t,
                                      int32_t c, const int64_t*, int64_t)
      : offs(o), total_c(t), cap_in(c) {}
  __device__ __forceinline__ int32_t rows() const { return cap_in; }
  __device__ __forceinline__ int32_t total() const { return __ldg(total_c); }
  __device__ __forceinline__ int32_t start(int64_t x) const {
    return __ldg(offs + x);
  }
  __device__ __forceinline__ int32_t end(int32_t total, int64_t x) const {
    return x + 1 < cap_in ? __ldg(offs + x + 1) : total;
  }
};

// A batch's rows number fewer than 2^31 (the entry checks it), so a row's
// query is a 32-bit division.
struct Batch {
  using Coord = int64_t;
  const int32_t* offs;    // [batch, cap_in]: each query's exclusive scan
  const int32_t* totals;  // [batch]
  int32_t cap_in;
  const int64_t* base;    // [batch + 1]
  int64_t batch;
  __device__ __forceinline__ Batch(const int32_t* o, const int32_t* t,
                                   int32_t c, const int64_t* b, int64_t n)
      : offs(o), totals(t), cap_in(c), base(b), batch(n) {}
  __device__ __forceinline__ int32_t rows() const {
    return (int32_t)(batch * cap_in);
  }
  __device__ __forceinline__ int64_t total() const {
    return __ldg(base + batch);
  }
  __device__ __forceinline__ uint32_t query(int64_t x) const {
    return (uint32_t)x / (uint32_t)cap_in;
  }
  // row x's end, given its query b and that query's base
  __device__ __forceinline__ int64_t end_in(uint32_t b, int64_t qbase,
                                            int64_t x) const {
    const int32_t xq = (int32_t)((uint32_t)x - b * (uint32_t)cap_in);
    return qbase + (xq + 1 < cap_in ? __ldg(offs + x + 1)
                                    : __ldg(totals + b));
  }
  __device__ __forceinline__ int64_t end(int64_t, int64_t x) const {
    const uint32_t b = query(x);
    return end_in(b, __ldg(base + b), x);
  }
};

// The batched fold stages, for each query, the probe segment that its
// first row with a candidate probes (an anchored query's rows all probe
// it): a bitmap over the segment's value range [first, first + bits), and
// where the probe is annotated (its position needed) a running count of
// the set bits before each word.  A segment of strictly ascending values
// (a trie level's) holds v at position lo + (its values below v), so bit
// v - first answers the search.  Each (query, probe) has kDesc int32 of
// descriptor: whether the lookup answers the search, the bounds, the
// value of bit 0, the bits, and the offsets of the bitmap and of the
// counts (-1: none) in the query's words.
enum { kDescOk, kDescLo, kDescHi, kDescFirst, kDescBits, kDescWords,
       kDescCounts, kDesc = 8 };

// Rounds of 32 candidates a warp takes in a tile (kTile / kWarps / 32).
constexpr int kRounds = kTile / kThreads;
static_assert(kRounds * kThreads == kTile, "a warp's share of a tile");

// The staging kernel's block: a query's segments are staged on the fold's
// critical path, so a block takes many threads.
constexpr int kStageThreads = 1024;
// Its blocks besides the scan's, at most: one resident on each of the
// H100's 132 SMs.  (Its launch bounds ask for one block an SM: without
// them ptxas held it to 32 registers for two, and spilled.)
constexpr int kStageBlocks = 132;
// Candidates a query needs to be staged: four of the fold's tiles.  A
// staged query costs its block a few microseconds, which the fold waits
// out; a query with fewer candidates saves less than that (70,000
// queries of 4 rows on the H100: staging each one with a tile's worth of
// candidates made the call 40% slower).
constexpr int kStageMin = 4 * kTile;
// The totals the staging kernel's scan takes, kScanPer a thread: a larger
// batch's totals come scanned by the caller (on the H100 one block's scan
// of 70,000 held the fold up longer than PyTorch's scan and the staging).
constexpr int kScanPer = 4;
constexpr int64_t kScanBatch = kScanPer * kStageThreads;

// Counts of the set bits before each of the words w[0, n), into cnt: a
// block-wide exclusive scan (s_part: an int a warp of scratch).
__device__ __forceinline__ void stage_counts(const uint32_t* w, uint32_t* cnt,
                                             int n, int32_t* s_part) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int per = (n + kStageThreads - 1) / kStageThreads;
  const int i0 = min(tid * per, n), i1 = min(i0 + per, n);
  int32_t sum = 0;
  for (int i = i0; i < i1; ++i) sum += __popc(w[i]);
  int32_t inc = sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int32_t t = __shfl_up_sync(kFull, inc, o);
    if (lane >= o) inc += t;
  }
  if (lane == 31) s_part[warp] = inc;
  __syncthreads();
  int32_t run = inc - sum;
  for (int k = 0; k < warp; ++k) run += s_part[k];
  for (int i = i0; i < i1; ++i) {
    cnt[i] = (uint32_t)run;
    run += __popc(w[i]);
  }
  __syncthreads();
}

// base[0, batch]: the exclusive scan of the queries' totals, in int64, by
// one block (batch <= kScanBatch), kScanPer totals a thread.
__device__ __forceinline__ void scan_totals(const int32_t* __restrict__ totals,
                                            int64_t* __restrict__ base,
                                            int64_t batch, int64_t* s_part) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int64_t v[kScanPer], sum = 0;
#pragma unroll
  for (int k = 0; k < kScanPer; ++k) {
    const int64_t i = kScanPer * tid + k;
    v[k] = i < batch ? __ldg(totals + i) : 0;
    sum += v[k];
  }
  int64_t inc = sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int64_t t = __shfl_up_sync(kFull, inc, o);
    if (lane >= o) inc += t;
  }
  if (lane == 31) s_part[warp] = inc;
  __syncthreads();
  int64_t run = inc - sum;
  for (int w = 0; w < warp; ++w) run += s_part[w];
  if (tid == 0) base[0] = 0;
#pragma unroll
  for (int k = 0; k < kScanPer; ++k) {
    const int64_t i = kScanPer * tid + k;
    run += v[k];
    if (i < batch) base[i + 1] = run;
  }
}

// The batched fold's first kernel.  Its last block scans the totals into
// base (a batch of up to kScanBatch queries); with probes, each other
// block j takes queries j, j + G, j + 2G, ...
// (G of them), kStageThreads at a time: a query with fewer than kStageMin
// candidates is marked not staged at once, and the block stages each of
// the others in turn: its first row with a candidate, each probe's segment
// there planned and staged in shared memory (qwords words: every
// segment's bitmap and counts, packed in probe order, or none of them),
// copied out to the query's words, and the descriptors written.  A
// segment that is empty needs no words; one past its level, past qwords
// or not strictly ascending is not staged.
template <int NP>
__global__ void __launch_bounds__(kStageThreads, 1) fold_stage_kernel(
    const int32_t* __restrict__ offs, const int32_t* __restrict__ totals,
    int32_t cap_in, const __grid_constant__ FillProbes probes,
    const __grid_constant__ FoldAnns anns, int64_t* __restrict__ base,
    int64_t batch, int32_t* __restrict__ desc, uint32_t* __restrict__ words,
    int32_t qwords) {
  constexpr int NPA = NP > 0 ? NP : 1;
  __shared__ int32_t s_first, s_used, s_broken, s_todo_n;
  __shared__ int32_t s_todo[kStageThreads];
  __shared__ int32_t s_plan[NPA][kDesc];
  __shared__ int32_t s_part[kStageThreads / 32];
  __shared__ int64_t s_part64[kStageThreads / 32];
  extern __shared__ uint32_t s_words[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int np = NP < FF_MAX_PROBES ? NP : probes.count;
  // the fold may start now: it waits for this grid before it reads these
  asm volatile("griddepcontrol.launch_dependents;");
  const bool scans = batch <= kScanBatch;  // else base came scanned
  if (scans && blockIdx.x == gridDim.x - 1) {
    scan_totals(totals, base, batch, s_part64);
    return;
  }
  const int64_t step = gridDim.x - scans;
  for (int64_t c0 = blockIdx.x; c0 < batch; c0 += step * kStageThreads) {
    __syncthreads();  // the last round's reads of s_todo are done
    if (tid == 0) s_todo_n = 0;
    __syncthreads();
    const int64_t bt = c0 + tid * step;
    if (bt < batch) {
      if (__ldg(totals + bt) < kStageMin) {
        for (int q = 0; q < np; ++q)
          desc[(bt * np + q) * kDesc + kDescOk] = 0;
      } else {
        s_todo[atomicAdd(&s_todo_n, 1)] = tid;
      }
    }
    __syncthreads();
    const int todo = s_todo_n;
    for (int i = 0; i < todo; ++i) {
      // (rows number fewer than 2^31: the entry checks it)
      const int32_t b = (int32_t)(c0 + s_todo[i] * step), row0 = b * cap_in;
      int32_t* const qdesc = desc + (int64_t)b * np * kDesc;
      __syncthreads();  // the last query's reads of the shared plan are done
      // the first row with a candidate: the least xq whose end on the
      // merge path passes 0 (the ends ascend from 0), 32 probes a step
      if (warp == 0) {
        int32_t lo = 0, hi = cap_in;
        while (lo < hi) {
          const int32_t p =
              lo + (int32_t)((int64_t)(hi - lo) * (lane + 1) / 33);
          const int32_t e = p + 1 < cap_in ? __ldg(offs + row0 + p + 1)
                                           : __ldg(totals + b);
          const unsigned m = __ballot_sync(kFull, e > 0);
          const int k = m ? __ffs(m) - 1 : 32;  // first probe past 0
          const int32_t at = __shfl_sync(kFull, p, k & 31);
          const int32_t before = __shfl_sync(kFull, p, (k + 31) & 31);
          hi = k < 32 ? at : hi;
          lo = k > 0 ? before + 1 : lo;
        }
        if (lane == 0) {
          s_first = lo;
          s_broken = 0;
        }
      }
      __syncthreads();
      const int32_t first = s_first;
      if (first == cap_in) {  // no candidate: nothing of it is read
        if (tid < np) qdesc[tid * kDesc + kDescOk] = 0;
        continue;
      }
      if (warp == 0) {  // the plan, a lane a probe
        int32_t d[kDesc] = {1, 0, 0, 0, 0, 0, -1, 0};
        int32_t need = 0, nw = 0;
        bool fit = true, pos = false;
        if (lane < np) {
          const FillProbe pr = probes.p[lane];
          pos = anns.p[lane + 1] != nullptr;
          d[kDescLo] = __ldg(pr.lo + row0 + first);
          d[kDescHi] = __ldg(pr.hi + row0 + first);
          if (pr.n > 0 && d[kDescLo] < d[kDescHi]) {
            if (d[kDescLo] < 0 || d[kDescHi] > pr.n) {
              fit = false;  // past the level: the search clips
            } else {
              d[kDescFirst] = __ldg(pr.vals + d[kDescLo]);
              const int64_t span = (int64_t)__ldg(pr.vals + d[kDescHi] - 1) -
                                   d[kDescFirst] + 1;
              if (span < 1 || span > 32 * (int64_t)qwords) {
                fit = false;
              } else {
                d[kDescBits] = (int32_t)span;
                nw = (int32_t)((span + 31) >> 5);
                need = pos ? 2 * nw : nw;
              }
            }
          }
        }
        int32_t at = need;  // inclusive scan of the words
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const int32_t t = __shfl_up_sync(kFull, at, o);
          if (lane >= o) at += t;
        }
        const int32_t used = __shfl_sync(kFull, at, 31);
        const bool all = __all_sync(kFull, fit) && used <= qwords;
        d[kDescOk] = all;
        d[kDescWords] = at - need;
        d[kDescCounts] = pos ? at - need + nw : -1;
        if (lane < np) {
#pragma unroll
          for (int k = 0; k < kDesc; ++k) s_plan[lane][k] = d[k];
        }
        if (lane == 0) s_used = all ? used : 0;
      }
      __syncthreads();
      const int32_t used = s_used;
      for (int j = tid; j < used; j += kStageThreads) s_words[j] = 0;
      __syncthreads();
      // the bits, 4 values a thread in flight
#pragma unroll
      for (int q = 0; q < NPA; ++q) {
        if (q >= np || !used || !s_plan[q][kDescBits]) continue;
        const int32_t lo = s_plan[q][kDescLo], hi = s_plan[q][kDescHi];
        const uint32_t first_v = (uint32_t)s_plan[q][kDescFirst];
        const uint32_t bits = (uint32_t)s_plan[q][kDescBits];
        uint32_t* const w = s_words + s_plan[q][kDescWords];
        const int32_t* vals = probes.p[q].vals;
        bool broken = false;  // not strictly ascending
        for (int32_t i0 = lo + tid; i0 < hi; i0 += 4 * kStageThreads) {
          int32_t v[4], before[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int32_t j = i0 + k * kStageThreads;
            v[k] = j < hi ? __ldg(vals + j) : 0;
            before[k] = j < hi && j > lo ? __ldg(vals + j - 1) : INT32_MIN;
          }
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            if (i0 + k * kStageThreads >= hi) continue;
            const uint32_t off = (uint32_t)v[k] - first_v;
            if (off < bits && before[k] < v[k])
              atomicOr(w + (off >> 5), 1u << (off & 31));
            else
              broken = true;
          }
        }
        if (broken) atomicOr(&s_broken, 1 << q);
      }
      __syncthreads();
#pragma unroll
      for (int q = 0; q < NPA; ++q) {
        if (q < np && used && s_plan[q][kDescCounts] >= 0 &&
            s_plan[q][kDescBits])
          stage_counts(s_words + s_plan[q][kDescWords],
                       s_words + s_plan[q][kDescCounts],
                       (s_plan[q][kDescBits] + 31) >> 5, s_part);
      }
      uint32_t* const qw = words + (int64_t)b * qwords;
      for (int j = tid; j < used; j += kStageThreads) qw[j] = s_words[j];
      if (tid < np) {
#pragma unroll
        for (int k = 0; k < kDesc; ++k)
          qdesc[tid * kDesc + k] =
              k == kDescOk ? s_plan[tid][k] && !((s_broken >> tid) & 1)
                           : s_plan[tid][k];
      }
    }
  }
}

// The merge-path coordinate on diagonal d: the least x in [lo, hi] with
// end(x) + x >= d (the row ends consumed; d - x candidates).  The whole
// warp searches, 32 probes a step.
template <typename Rows>
__device__ __forceinline__ int64_t warp_path_search(
    const Rows& rows, typename Rows::Coord total, int64_t d, int64_t lo,
    int64_t hi) {
  const int lane = threadIdx.x & 31;
  while (lo < hi) {  // lo and hi are the same in every lane
    const int64_t p = lo + (hi - lo) * (lane + 1) / 33;  // in [lo, hi)
    const bool right = (int64_t)rows.end(total, p) + p >= d;
    const unsigned m = __ballot_sync(kFull, right);
    const int k = m ? __ffs(m) - 1 : 32;  // first probe on the right
    const int64_t at = __shfl_sync(kFull, p, k & 31);
    const int64_t before = __shfl_sync(kFull, p, (k + 31) & 31);
    hi = k < 32 ? at : hi;
    lo = k > 0 ? before + 1 : lo;
  }
  return lo;
}

// The same coordinate by one thread's binary search.
template <typename Rows>
__device__ __forceinline__ int64_t path_search(const Rows& rows,
                                               typename Rows::Coord total,
                                               int64_t d, int64_t lo,
                                               int64_t hi) {
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if ((int64_t)rows.end(total, mid) + mid >= d) hi = mid;
    else lo = mid + 1;
  }
  return lo;
}

template <typename I>
__device__ __forceinline__ I imin(I a, I b) {
  return a < b ? a : b;
}

template <typename I>
__device__ __forceinline__ I imax(I a, I b) {
  return a < b ? b : a;
}

// A build with -DFOLD_PROFILE sums the fold's block-cycles by phase over
// its blocks (thread 0's clock64() at the block-wide barriers that end
// each phase) into g_fold_phase: share ends, tile starts, a batch's row
// staging and check, the probes, the fold and its writes.  Only a
// profiling build has it; the kernels of every other build are as if
// these marks were not there.
#ifdef FOLD_PROFILE
__device__ unsigned long long g_fold_phase[8];
#define FOLD_PHASE_START             \
  long long t_mark = clock64();      \
  unsigned long long t_sum[8] = {};
#define FOLD_PHASE(k)                  \
  {                                    \
    const long long t_now = clock64(); \
    t_sum[k] += t_now - t_mark;        \
    t_mark = t_now;                    \
  }
#define FOLD_PHASE_END \
  for (int k = 0; k < 8; ++k) atomicAdd(&g_fold_phase[k], t_sum[k]);
#else
#define FOLD_PHASE_START
#define FOLD_PHASE(k)
#define FOLD_PHASE_END
#endif

__device__ __forceinline__ int32_t level_at(const int32_t* __restrict__ vals,
                                            int32_t n, int32_t p) {
  return __ldg(vals + clamp_i32(p, 0, n - 1));
}

// A batch (Rows = Batch) passes batch_base and batch, and its queries'
// cap_in: the launch folds batch * cap_in rows.  It also passes the staged
// segments of fold_stage_kernel: their descriptors ([batch, np, kDesc])
// and words (qwords a query).
template <typename T, int NP, typename Rows>
__device__ __forceinline__ void fold_tiles(
    const int32_t* __restrict__ lo0, const int32_t* __restrict__ offs,
    const int32_t* __restrict__ total_c, int32_t q_cap_in,
    const int32_t* __restrict__ seed, int32_t n0, const FillProbes& probes,
    const FoldAnns& anns, int op, T zero, T one, T* __restrict__ folded,
    int32_t* __restrict__ supp, int32_t* __restrict__ carry_row,
    T* __restrict__ carry_val, int32_t* __restrict__ carry_hits,
    const int64_t* __restrict__ batch_base, int64_t batch,
    const int32_t* __restrict__ desc, const uint32_t* __restrict__ words,
    int32_t qwords) {
  constexpr bool kBatch = std::is_same<Rows, Batch>::value;
  constexpr int NPA = NP > 0 ? NP : 1;
  __shared__ int32_t s_end[kTile];   // the tile's row ends, less its ys
  __shared__ T s_contrib[kTile];     // per candidate: its contribution
  __shared__ uint8_t s_keep[kTile];  // and whether every probe holds it
  __shared__ T s_fold[kTile];        // per row: the fold and support of
  __shared__ int32_t s_supp[kTile];  // the rows the tile completes
  __shared__ int32_t s_tx[kThreads + 1];  // row coordinates of tile starts
  __shared__ int64_t s_path[2];
  __shared__ int32_t s_wkey[kWarps], s_whits[kWarps];
  __shared__ T s_wval[kWarps];
  __shared__ T s_cval;               // the open row's carry between tiles
  __shared__ int32_t s_chits;
  // a batch: each row's seed base (its seed start less its first
  // candidate's tile coordinate), until the fold needs s_supp; the tile's
  // staged segments (lo, value of bit 0, bits, bitmap and counts offsets)
  int32_t* const s_base = s_supp;
  __shared__ int32_t s_look[NPA][5];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int np = NP < FF_MAX_PROBES ? NP : probes.count;
  FOLD_PHASE_START
  using C = typename Rows::Coord;
  // a batch's base and staged segments come from fold_stage_kernel
  if constexpr (kBatch) asm volatile("griddepcontrol.wait;" ::: "memory");
  const Rows rows_at(offs, total_c, q_cap_in, batch_base, batch);
  const int32_t cap_in = rows_at.rows();
  const C total = rows_at.total();
  const int64_t items = (int64_t)cap_in + total;
  int64_t share = (items + gridDim.x - 1) / gridDim.x;
  share = (share + kTile - 1) / kTile * kTile;
  const int64_t d0 = imin((int64_t)blockIdx.x * share, items);
  const int64_t d1 = imin(d0 + share, items);

  // 1. the share's start x0 and end x1 on the merge path
  if (warp < 2) {
    const int64_t d = warp == 0 ? d0 : d1;
    const int64_t p = warp_path_search(rows_at, total, d,
                                       imax(d - total, (int64_t)0),
                                       imin(d, (int64_t)cap_in));
    if (lane == 0) s_path[warp] = p;
  }
  if (tid == 0) {
    s_cval = zero;
    s_chits = 0;
  }
  __syncthreads();
  FOLD_PHASE(0)
  const int64_t x0 = s_path[0], x1 = s_path[1];
  const int64_t tiles = (d1 - d0 + kTile - 1) / kTile;
  const T* ann0 = static_cast<const T*>(anns.p[0]);

  for (int64_t t0 = 0; t0 < tiles; t0 += kThreads) {
    // 2. the row coordinates of tile starts t0 .. t0 + nb (the last: d1)
    const int nb = (int)imin((int64_t)kThreads, tiles - t0);
    for (int i = tid; i <= nb; i += kThreads) {
      const int64_t d = imin(d0 + (t0 + i) * kTile, d1);
      s_tx[i] = (int32_t)path_search(rows_at, total, d,
                                     imax(x0, d - total), imin(x1, d));
    }
    __syncthreads();
    FOLD_PHASE(1)
    for (int t = 0; t < nb; ++t) {
      const int64_t ds = d0 + (t0 + t) * kTile;
      const int64_t de = imin(ds + kTile, d1);
      const int32_t xs = s_tx[t], xe = s_tx[t + 1];
      const C ys = (C)(ds - xs), ye = (C)(de - xe);
      const int rows = xe - xs, ncand = (int)(ye - ys);
      const int tile_items = rows + ncand;
      // A batch: each row's query by a 32-bit division, for its end and,
      // where the tile has candidates, its seed base (row xe too, whose
      // candidates may start here).  The tile takes the staged lookups of
      // its first row's query bq if every row with a candidate in it is
      // of bq and probes bq's staged segments.
      bool staged = false;
      uint32_t bq = 0;
      if constexpr (kBatch) {
        bq = rows_at.query(xs);
        int32_t klo[NPA] = {}, khi[NPA] = {};
        bool bad = false;
#pragma unroll
        for (int q = 0; q < NP; ++q) {
          if (q < np && ncand > 0) {
            const int32_t* d = desc + ((int64_t)bq * np + q) * kDesc;
            bad = bad || !__ldg(d + kDescOk);
            klo[q] = __ldg(d + kDescLo);
            khi[q] = __ldg(d + kDescHi);
          }
        }
        if (tid < np && ncand > 0) {
          const int32_t* d = desc + ((int64_t)bq * np + tid) * kDesc;
          s_look[tid][0] = __ldg(d + kDescLo);
          s_look[tid][1] = __ldg(d + kDescFirst);
          s_look[tid][2] = __ldg(d + kDescBits);
          s_look[tid][3] = __ldg(d + kDescWords);
          s_look[tid][4] = __ldg(d + kDescCounts);
        }
        // the ends: a thread's rows' loads in flight together
#pragma unroll
        for (int k = 0; k < kItems; ++k) {
          const int r = tid + k * kThreads;
          if (r < rows) {
            const int64_t x = xs + r;
            const uint32_t b = rows_at.query(x);
            s_end[r] =
                (int32_t)rows_at.end_in(b, __ldg(batch_base + b) - ys, x);
          }
        }
        // the seed bases, and the check, where the tile has candidates;
        // a thread reads back only the ends it wrote
        for (int r = tid; r <= rows && ncand > 0; r += kThreads) {
          const int64_t x = xs + r;
          if (x >= cap_in) break;
          const uint32_t b = rows_at.query(x);
          const int64_t qbase = __ldg(batch_base + b) - ys;
          const int32_t o = __ldg(offs + x);
          s_base[r] = (int32_t)((uint32_t)__ldg(lo0 + x) -
                                (uint32_t)(qbase + o));
          // where row x's candidates start (its query's first row: at
          // the query's base)
          const int64_t from =
              qbase + ((uint32_t)x != b * (uint32_t)q_cap_in ? o : 0);
          // (the bounds read beside the row's other values, not after)
          bool differs = b != bq;
#pragma unroll
          for (int q = 0; q < NP; ++q)
            if (q < np)
              differs |= (__ldg(probes.p[q].lo + x) != klo[q]) |
                         (__ldg(probes.p[q].hi + x) != khi[q]);
          if (differs && (r < rows ? (int64_t)s_end[r] : (int64_t)ncand) >
                             imax(from, (int64_t)0))
            bad = true;
        }
        staged = !__syncthreads_or(bad);
        FOLD_PHASE(2)
      } else {
        for (int r = tid; r < rows; r += kThreads)
          s_end[r] = (int32_t)(rows_at.end(total, xs + r) - ys);
        __syncthreads();
      }

      // this thread's items [dt, dt_end) start at (xr0, yc0) in the tile
      const int dt = imin(tid * kItems, tile_items);
      const int dt_end = imin(dt + kItems, tile_items);
      int lo = imax(dt - ncand, 0), hi = imin(dt, rows);
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (s_end[mid] + mid >= dt) hi = mid; else lo = mid + 1;
      }
      const int xr0 = lo, yc0 = dt - lo;

      // 3. the probes: each warp takes a contiguous part of the tile's
      // candidates, 32 consecutive ones a round (their seed values read
      // coalesced).  A batch's staged tile (or one with no probe) takes
      // its candidates' seed values a lane's rounds at once and answers
      // each probe from its query's bitmap.
      if constexpr (kBatch) {
        if (staged) {
          // a lane's rounds: its candidates' rows from the staged row
          // ends, then every seed value in flight at once
          const int per_warp = ((ncand + kWarps - 1) / kWarps + 31) & ~31;
          const int c_begin = imin(warp * per_warp, ncand);
          const int c_end = imin(c_begin + per_warp, ncand);
          const uint32_t* qw = words + (int64_t)bq * qwords;
          int r = rows;  // the least r with r == rows or s_end[r] > c
          int32_t p0[kRounds], v[kRounds];
#pragma unroll
          for (int u = 0; u < kRounds; ++u) {
            const int c = c_begin + lane + 32 * u;
            p0[u] = 0;
            if (c < c_end) {
              if (u == 0 || (r < rows && s_end[r] <= c)) {
                int lo_r = u == 0 ? 0 : r + 1, hi_r = rows;
                while (lo_r < hi_r) {
                  const int m = (lo_r + hi_r) >> 1;
                  if (s_end[m] > c) hi_r = m; else lo_r = m + 1;
                }
                r = lo_r;
              }
              p0[u] = (int32_t)((uint32_t)s_base[r] + (uint32_t)c);
            }
          }
#pragma unroll
          for (int u = 0; u < kRounds; ++u)
            v[u] = c_begin + lane + 32 * u < c_end
                       ? __ldg(seed + clamp_i32(p0[u], 0,
                                                n0 > 0 ? n0 - 1 : 0))
                       : 0;
#pragma unroll
          for (int u = 0; u < kRounds; ++u) {
            const int c = c_begin + lane + 32 * u;
            if (c >= c_end) continue;
            T contrib = one;
            if (ann0 != nullptr)
              contrib = sr_mul(op, contrib,
                               ann0[clamp_i32(p0[u], 0, anns.n[0] - 1)]);
            bool keep = true;
#pragma unroll
            for (int q = 0; q < NP; ++q) {
              if (q >= np) continue;
              const uint32_t off = (uint32_t)v[u] - (uint32_t)s_look[q][1];
              uint32_t w = 0;
              if (off < (uint32_t)s_look[q][2])
                w = __ldg(qw + s_look[q][3] + (off >> 5));
              keep = keep && ((w >> (off & 31)) & 1u);
              const T* an = static_cast<const T*>(anns.p[q + 1]);
              if (an != nullptr && keep) {  // then counts were staged
                const int32_t pos =
                    s_look[q][0] +
                    (int32_t)__ldg(qw + s_look[q][4] + (off >> 5)) +
                    __popc(w & ((1u << (off & 31)) - 1u));
                contrib = sr_mul(op, contrib,
                                 an[clamp_i32(pos, 0, anns.n[q + 1] - 1)]);
              }
            }
            s_contrib[c] = contrib;
            s_keep[c] = keep;
          }
        }
      }
      if (!staged) {
        const int per_warp = ((ncand + kWarps - 1) / kWarps + 31) & ~31;
        const int c_begin = imin(warp * per_warp, ncand);
        const int c_end = imin(c_begin + per_warp, ncand);
        int prev_row = -1;
        int32_t prev_v = 0, prev_pos[NPA] = {};
        // this lane's last row and that row's data, kept across rounds
        int my_row = -1;
        C my_base = 0;
        int32_t plo[NPA] = {}, phi[NPA] = {};
        for (int cb = c_begin; cb < c_end; cb += 32) {
          const int c = cb + lane;
          const bool act = c < c_end;
          // the candidate's row: the least r with r == rows or s_end[r] > c,
          // no earlier than this lane's last
          int r = my_row;
          if (act && (r < 0 || (r < rows && s_end[r] <= c))) {
            int rlo = r + 1, rhi = rows;
            while (rlo < rhi) {
              const int mid = (rlo + rhi) >> 1;
              if (s_end[mid] > c) rhi = mid; else rlo = mid + 1;
            }
            r = rlo;
          }
          if (act && r != my_row) {
            my_row = r;
            if constexpr (kBatch)
              my_base = (C)s_base[r] - ys;
            else
              my_base = __ldg(lo0 + xs + r) - rows_at.start(xs + r);
#pragma unroll
            for (int q = 0; q < NP; ++q) {
              if (q < np) {
                plo[q] = __ldg(probes.p[q].lo + xs + r);
                phi[q] = __ldg(probes.p[q].hi + xs + r);
              }
            }
          }
          const int32_t p0 = (int32_t)(my_base + ys + c);
          const int32_t v =
              act ? __ldg(seed + clamp_i32(p0, 0, n0 > 0 ? n0 - 1 : 0))
                  : INT32_MAX;
          T contrib = one;
          if (ann0 != nullptr && act)
            contrib = sr_mul(op, contrib,
                             ann0[clamp_i32(p0, 0, anns.n[0] - 1)]);
          // a candidate after the last of the previous round in its row has
          // its positions no earlier than that one's
          const bool carried = act && r == prev_row && v >= prev_v;
          // the lower bounds in every probe segment, searched in lockstep:
          // [pos, pos + len) holds the bound, or it is pos + len
          int32_t pos[NPA], len[NPA];
#pragma unroll
          for (int q = 0; q < NP; ++q) {
            if (q < np) {
              pos[q] = carried ? imax(prev_pos[q], plo[q]) : plo[q];
              len[q] = act && probes.p[q].n > 0 ? imax(phi[q] - pos[q], 0)
                                                : 0;
            }
          }
          for (;;) {
            bool more = false;
#pragma unroll
            for (int q = 0; q < NP; ++q) more = more || (q < np && len[q] > 1);
            if (!more) break;
#pragma unroll
            for (int q = 0; q < NP; ++q) {
              // a settled search reads nothing, so an empty level is
              // never read
              if (q < np && len[q] > 1) {
                const int32_t half = len[q] >> 1;
                if (level_at(probes.p[q].vals, probes.p[q].n,
                             pos[q] + half) < v)
                  pos[q] += half;
                len[q] -= half;
              }
            }
          }
          bool keep = act;
#pragma unroll
          for (int q = 0; q < NP; ++q) {
            if (q < np) {
              const int32_t* vals = probes.p[q].vals;
              const int32_t n = probes.p[q].n;
              if (len[q] == 1 && level_at(vals, n, pos[q]) < v) ++pos[q];
              keep = keep && n > 0 && pos[q] < phi[q] &&
                     level_at(vals, n, pos[q]) == v;
              const T* an = static_cast<const T*>(anns.p[q + 1]);
              if (an != nullptr && act)
                contrib = sr_mul(
                    op, contrib, an[clamp_i32(pos[q], 0, anns.n[q + 1] - 1)]);
              prev_pos[q] = __shfl_sync(kFull, pos[q], 31);
            }
          }
          prev_row = __shfl_sync(kFull, r, 31);
          prev_v = __shfl_sync(kFull, v, 31);
          if (act) {
            s_contrib[c] = contrib;
            s_keep[c] = keep;
          }
        }
      }
      __syncthreads();
      FOLD_PHASE(3)

      // 4. fold this thread's items in order
      int xr = xr0, yc = yc0;
      T acc = zero, first = zero;
      int32_t hits = 0, first_hits = 0;
      bool ended = false;
      for (int k = dt; k < dt_end; ++k) {
        if (xr < rows && s_end[xr] <= yc) {  // row xs + xr ends here
          if (!ended) {
            ended = true;
            first = acc;
            first_hits = hits;
          } else {
            s_fold[xr] = acc;
            s_supp[xr] = hits;
          }
          acc = zero;
          hits = 0;
          ++xr;
        } else {
          if (s_keep[yc]) {
            acc = sr_add(op, acc, s_contrib[yc]);
            ++hits;
          }
          ++yc;
        }
      }

      // the threads' carries (xr, acc, hits): a segmented inclusive scan
      // by row in the warp, then across the warps in order, after the
      // tile's carry (whose row is the tile's first, 0)
      T inc = acc;
      int32_t ih = hits;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int k2 = __shfl_up_sync(kFull, xr, o);
        const T v2 = shfl_up(inc, o);
        const int32_t h2 = __shfl_up_sync(kFull, ih, o);
        if (lane >= o && k2 == xr) {
          inc = sr_add(op, v2, inc);
          ih += h2;
        }
      }
      if (lane == 31) {
        s_wkey[warp] = xr;
        s_wval[warp] = inc;
        s_whits[warp] = ih;
      }
      int ek = __shfl_up_sync(kFull, xr, 1);
      T ev = shfl_up(inc, 1);
      int32_t eh = __shfl_up_sync(kFull, ih, 1);
      __syncthreads();
      int pk = 0;
      T pv = s_cval;
      int32_t ph = s_chits;
      for (int w = 0; w < warp; ++w) {
        if (pk == s_wkey[w]) {
          pv = sr_add(op, pv, s_wval[w]);
          ph += s_whits[w];
        } else {
          pv = s_wval[w];
          ph = s_whits[w];
        }
        pk = s_wkey[w];
      }
      if (lane == 0) {
        ek = pk;
        ev = pv;
        eh = ph;
      } else if (pk == ek) {
        ev = sr_add(op, pv, ev);
        eh += ph;
      }
      // (ek, ev, eh): the carry into this thread, whose first row is xr0
      if (ended) {
        s_fold[xr0] = ek == xr0 ? sr_add(op, ev, first) : first;
        s_supp[xr0] = (ek == xr0 ? eh : 0) + first_hits;
      }
      __syncthreads();
      if (tid == kThreads - 1) {  // the next tile's carry: row xe
        s_cval = pk == xr ? sr_add(op, pv, inc) : inc;
        s_chits = pk == xr ? ph + ih : ih;
      }
      for (int r = tid; r < rows; r += kThreads) {
        folded[xs + r] = s_fold[r];
        supp[xs + r] = s_supp[r];
      }
      __syncthreads();
      FOLD_PHASE(4)
    }
  }
  if (tid == 0) {
    carry_row[blockIdx.x] = (int32_t)x1;
    carry_val[blockIdx.x] = s_cval;
    carry_hits[blockIdx.x] = s_chits;
    FOLD_PHASE_END
  }
}

#define FOLD_PARAMS                                                          \
  const int32_t *__restrict__ lo0, const int32_t *__restrict__ offs,        \
      const int32_t *__restrict__ total_c, int32_t q_cap_in,                \
      const int32_t *__restrict__ seed, int32_t n0,                         \
      const __grid_constant__ FillProbes probes,                            \
      const __grid_constant__ FoldAnns anns, int op, T zero, T one,         \
      T *__restrict__ folded, int32_t *__restrict__ supp,                   \
      int32_t *__restrict__ carry_row, T *__restrict__ carry_val,           \
      int32_t *__restrict__ carry_hits,                                     \
      const int64_t *__restrict__ batch_base, int64_t batch,                \
      const int32_t *__restrict__ desc, const uint32_t *__restrict__ words, \
      int32_t qwords
#define FOLD_ARGS                                                         \
  lo0, offs, total_c, q_cap_in, seed, n0, probes, anns, op, zero, one,    \
      folded, supp, carry_row, carry_val, carry_hits, batch_base, batch, \
      desc, words, qwords

// One query's fold (Rows = OneQuery).
template <typename T, int NP, typename Rows>
__global__ void __launch_bounds__(kThreads) fold_kernel(FOLD_PARAMS) {
  fold_tiles<T, NP, Rows>(FOLD_ARGS);
}

// A batch's: registers for as many blocks an SM as leave no instance a
// stack frame or a spill on the H100 (5 without a probe, 4 with 1 or 2,
// 2 for the generic count).
template <int NP>
constexpr int batch_blocks() {
  return NP == 0 ? 5 : (NP < FF_MAX_PROBES ? 4 : 2);
}
template <typename T, int NP>
__global__ void __launch_bounds__(kThreads, batch_blocks<NP>())
    fold_batched_kernel(FOLD_PARAMS) {
  fold_tiles<T, NP, Batch>(FOLD_ARGS);
}
#undef FOLD_PARAMS
#undef FOLD_ARGS

// A warp for each block b >= 1: if b completed row r = x0(b), the row gets
// the carries of the blocks before b for r (a hub's run spans many), the
// lanes striding over the run and a fixed butterfly adding their parts.
template <typename T>
__global__ void fold_carry_kernel(const int32_t* __restrict__ carry_row,
                                  const T* __restrict__ carry_val,
                                  const int32_t* __restrict__ carry_hits,
                                  int blocks, int32_t cap_in, int op,
                                  T zero, T* __restrict__ folded,
                                  int32_t* __restrict__ supp) {
  const int b = (int)((blockIdx.x * blockDim.x + threadIdx.x) / 32) + 1;
  const int lane = threadIdx.x & 31;
  if (b >= blocks) return;  // uniform across the warp
  const int32_t r = carry_row[b - 1];        // x1 of block b - 1 = x0 of b
  if (r >= cap_in || carry_row[b] == r) return;  // b completed no row
  T sum = zero;
  int32_t hits = 0;
  for (int top = b - 1;; top -= 32) {        // carries top, top - 1, ...
    const int k = top - lane;
    const bool in_run = k >= 0 && carry_row[k] == r;
    if (in_run) {
      sum = sr_add(op, sum, carry_val[k]);
      hits += carry_hits[k];
    }
    if (__ballot_sync(kFull, in_run) != kFull) break;
  }
  for (int o = 16; o > 0; o >>= 1) {
    sum = sr_add(op, sum, shfl_xor(sum, o));
    hits += __shfl_xor_sync(kFull, hits, o);
  }
  if (lane == 0 && hits > 0) {
    folded[r] = sr_add(op, folded[r], sum);
    supp[r] += hits;
  }
}

// batch_base null: one query of cap_in rows; else a batch of `batch`,
// whose probe segments fold_stage_kernel stages first, stage_bytes a query
// (none without a probe).  The scratch holds the carries, then for a batch
// the descriptors and the staged words.
template <typename T, int NP>
static int launch(const int32_t* lo0, const int32_t* offs,
                  const int32_t* total_c, int64_t* batch_base,
                  int64_t batch, int32_t cap_in, const int32_t* seed,
                  int32_t n0, const FillProbes* probes, const FoldAnns* anns,
                  int op, T zero, T one, T* folded, int32_t* supp,
                  void* scratch, int32_t stage_bytes, cudaStream_t stream) {
  int32_t* carry_row = static_cast<int32_t*>(scratch);
  T* carry_val = reinterpret_cast<T*>(carry_row + kBlocks);
  int32_t* carry_hits = carry_row + 2 * kBlocks;
  if (batch_base == nullptr) {
    fold_kernel<T, NP, OneQuery><<<kBlocks, kThreads, 0, stream>>>(
        lo0, offs, total_c, cap_in, seed, n0, *probes, *anns, op, zero, one,
        folded, supp, carry_row, carry_val, carry_hits, nullptr, 1, nullptr,
        nullptr, 0);
  } else {
    int32_t* desc = carry_row + 3 * kBlocks;
    uint32_t* words = reinterpret_cast<uint32_t*>(
        desc + batch * probes->count * kDesc);
    const int32_t qwords = NP > 0 ? stage_bytes / 4 : 0;
    // up to kStageBlocks blocks to stage (with probes), and one to scan
    // (up to kScanBatch queries)
    const unsigned int blocks =
        (NP > 0 ? (unsigned int)(batch < kStageBlocks ? batch : kStageBlocks)
                : 0) +
        (batch <= kScanBatch ? 1 : 0);
    if (blocks > 0) {
      cudaError_t err = cudaFuncSetAttribute(
          fold_stage_kernel<NP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          qwords * 4);
      if (err != cudaSuccess) return (int)err;
      fold_stage_kernel<NP><<<blocks, kStageThreads, qwords * 4, stream>>>(
          offs, total_c, cap_in, *probes, *anns, batch_base, batch, desc,
          words, qwords);
      err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
    // launched to start while the staging kernel ends
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(kBlocks);
    cfg.blockDim = dim3(kThreads);
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[0].val.programmaticStreamSerializationAllowed = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    cudaError_t err = cudaLaunchKernelEx(
        &cfg, fold_batched_kernel<T, NP>, lo0, offs, total_c, cap_in, seed,
        n0, *probes, *anns, op, zero, one, folded, supp, carry_row,
        carry_val, carry_hits, batch_base, batch, (const int32_t*)desc,
        (const uint32_t*)words, qwords);
    if (err != cudaSuccess) return (int)err;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int threads = 256;  // 8 warps, one for each block b >= 1
  fold_carry_kernel<T><<<(kBlocks - 1 + 7) / 8, threads, 0, stream>>>(
      carry_row, carry_val, carry_hits, kBlocks,
      batch_base == nullptr ? cap_in : (int32_t)(batch * cap_in), op, zero,
      folded, supp);
  return (int)cudaGetLastError();
}

// The probe count picks the instance: each of 0, 1 and 2 probes has its
// own (on the H100 the generic one took 2.6 times as long on the main
// path's call, for its registers).
// One entry per semiring type: a single query's fold (batch_base null) or
// a batch's (its base, [batch + 1]; lo0, offs, the probes' bounds, folded
// and supp [batch, cap_in]; total_c [batch]).
template <typename T>
static int fold_entry(const int32_t* lo0, const int32_t* offs,
                      const int32_t* total_c, int64_t* batch_base,
                      int64_t batch, int32_t cap_in, const int32_t* seed,
                      int32_t n0, const FillProbes* probes,
                      const FoldAnns* anns, int op, T zero, T one,
                      T* folded, int32_t* supp, void* scratch,
                      int32_t stage_bytes, cudaStream_t stream) {
  if (batch_base != nullptr && (batch < 1 || batch * cap_in > INT32_MAX ||
                                 stage_bytes < 0 || stage_bytes % 16))
    return (int)cudaErrorInvalidValue;
  switch (probes->count) {
    case 0:
      return launch<T, 0>(lo0, offs, total_c, batch_base, batch, cap_in,
                          seed, n0, probes, anns, op, zero, one, folded, supp,
                          scratch, stage_bytes, stream);
    case 1:
      return launch<T, 1>(lo0, offs, total_c, batch_base, batch, cap_in,
                          seed, n0, probes, anns, op, zero, one, folded, supp,
                          scratch, stage_bytes, stream);
    case 2:
      return launch<T, 2>(lo0, offs, total_c, batch_base, batch, cap_in,
                          seed, n0, probes, anns, op, zero, one, folded, supp,
                          scratch, stage_bytes, stream);
    default:
      return launch<T, FF_MAX_PROBES>(lo0, offs, total_c, batch_base, batch,
                                      cap_in, seed, n0, probes, anns, op,
                                      zero, one, folded, supp, scratch,
                                      stage_bytes, stream);
  }
}

static bool bad_args(int32_t cap_in, const FillProbes* probes) {
  return cap_in < 1 || probes->count < 0 || probes->count > FF_MAX_PROBES;
}

}  // namespace fold

// Bytes of the carries' scratch a fold takes: a row, a value and a count
// for each of the kBlocks blocks.
extern "C" int64_t frontier_fold_scratch_bytes() {
  return 3 * 4 * (int64_t)fold::kBlocks;
}

// Bytes of the scratch a batch of `batch` queries with n_probes probes
// takes: the carries, each (query, probe)'s descriptor, and stage_bytes of
// staged segments a query.
extern "C" int64_t frontier_fold_batched_scratch_bytes(int64_t batch,
                                                       int32_t n_probes,
                                                       int32_t stage_bytes) {
  return frontier_fold_scratch_bytes() +
         batch * (4 * fold::kDesc * (int64_t)n_probes + stage_bytes);
}

// The most queries whose totals the batched fold scans itself.
extern "C" int64_t frontier_fold_batched_scan_max() {
  return fold::kScanBatch;
}

// lo0, offs: [cap_in] (each row's seed segment start and exclusive-scan
// candidate offset); total_c: the candidate total, on the device; seed:
// [n0]; scratch: frontier_fold_scratch_bytes(); folded, supp: [cap_in],
// every row written.  A batch of `batch` queries passes batch_base ([batch
// + 1] int64, the exclusive scan of the totals, see fold::Batch: written
// here for up to frontier_fold_batched_scan_max() queries, passed scanned
// for more) and every per-row
// array as [batch, cap_in], total_c as [batch], and stage_bytes of staged
// segments a query (a multiple of 16; scratch:
// frontier_fold_batched_scratch_bytes); one query passes null and 0.  op
// selects the float semiring (0 sum, 1 min_plus, 2 max_min).  Returns the
// first launch error, or 0.
extern "C" int frontier_fold_i32(const int32_t* lo0, const int32_t* offs,
                                 const int32_t* total_c,
                                 int64_t* batch_base, int64_t batch,
                                 int32_t cap_in, const int32_t* seed,
                                 int32_t n0, const FillProbes* probes,
                                 const FoldAnns* anns, int32_t op,
                                 int32_t zero, int32_t one, int32_t* folded,
                                 int32_t* supp, void* scratch,
                                 int32_t stage_bytes, cudaStream_t stream) {
  if (fold::bad_args(cap_in, probes) || op != 0)
    return (int)cudaErrorInvalidValue;
  return fold::fold_entry<int32_t>(lo0, offs, total_c, batch_base, batch,
                                   cap_in, seed, n0, probes, anns, op, zero,
                                   one, folded, supp, scratch, stage_bytes,
                                   stream);
}

extern "C" int frontier_fold_f32(const int32_t* lo0, const int32_t* offs,
                                 const int32_t* total_c,
                                 int64_t* batch_base, int64_t batch,
                                 int32_t cap_in, const int32_t* seed,
                                 int32_t n0, const FillProbes* probes,
                                 const FoldAnns* anns, int32_t op, float zero,
                                 float one, float* folded, int32_t* supp,
                                 void* scratch, int32_t stage_bytes,
                                 cudaStream_t stream) {
  if (fold::bad_args(cap_in, probes) || op < 0 || op > 2)
    return (int)cudaErrorInvalidValue;
  return fold::fold_entry<float>(lo0, offs, total_c, batch_base, batch,
                                 cap_in, seed, n0, probes, anns, op, zero,
                                 one, folded, supp, scratch, stage_bytes,
                                 stream);
}

extern "C" int frontier_fold_u8(const int32_t* lo0, const int32_t* offs,
                                const int32_t* total_c,
                                int64_t* batch_base, int64_t batch,
                                int32_t cap_in, const int32_t* seed,
                                int32_t n0, const FillProbes* probes,
                                const FoldAnns* anns, int32_t op,
                                uint8_t zero, uint8_t one, uint8_t* folded,
                                int32_t* supp, void* scratch,
                                int32_t stage_bytes, cudaStream_t stream) {
  if (fold::bad_args(cap_in, probes) || op != 3)
    return (int)cudaErrorInvalidValue;
  return fold::fold_entry<uint8_t>(lo0, offs, total_c, batch_base, batch,
                                   cap_in, seed, n0, probes, anns, op, zero,
                                   one, folded, supp, scratch, stage_bytes,
                                   stream);
}

extern "C" int frontier_fill(const int32_t* total_c, const int32_t* offs,
                             const int32_t* lo0, int32_t cap_in,
                             const int32_t* seed, int32_t n0,
                             const FillProbes* probes, int64_t start,
                             int64_t n, int32_t* vals_o, int32_t* row_o,
                             int32_t* p0_o, bool* keep_o, int32_t* pos_o,
                             cudaStream_t stream) {
  if (n <= 0) return 0;
  if (probes->count < 0 || probes->count > FF_MAX_PROBES)
    return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const int64_t blocks = (n + threads - 1) / threads;
  frontier_fill_kernel<<<(unsigned int)blocks, threads, 0, stream>>>(
      total_c, offs, lo0, cap_in, seed, n0, *probes, start, n, vals_o,
      row_o, p0_o, keep_o, pos_o);
  return (int)cudaGetLastError();
}

// The batched fill (frontier_fill_batched_kernel): total_c [batch]; offs,
// lo0 and the probes' bounds [batch, cap_in]; the outputs [batch, n] and
// pos_o [n_probes, batch, n].
extern "C" int frontier_fill_batched(const int32_t* total_c,
                                     const int32_t* offs, const int32_t* lo0,
                                     int32_t cap_in, const int32_t* seed,
                                     int32_t n0, const FillProbes* probes,
                                     int64_t batch, int64_t n,
                                     int32_t* vals_o, int32_t* row_o,
                                     int32_t* p0_o, bool* keep_o,
                                     int32_t* pos_o, cudaStream_t stream) {
  if (n <= 0 || batch <= 0) return 0;
  if (probes->count < 0 || probes->count > FF_MAX_PROBES || cap_in < 1)
    return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const int64_t per_query = (n + 31) / 32 * 32;
  const int64_t blocks = (batch * per_query + threads - 1) / threads;
  if (blocks > INT32_MAX) return (int)cudaErrorInvalidValue;
  frontier_fill_batched_kernel<<<(unsigned int)blocks, threads, 0, stream>>>(
      total_c, offs, lo0, cap_in, seed, n0, *probes, batch, n, per_query,
      vals_o, row_o, p0_o, keep_o, pos_o);
  return (int)cudaGetLastError();
}

#ifdef FOLD_PROFILE
// A profiling build's block-cycles of the fold by phase (g_fold_phase):
// read into out[8], and set to zero.
extern "C" int frontier_fold_profile_read(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, fold::g_fold_phase,
                                   sizeof(fold::g_fold_phase));
}
extern "C" int frontier_fold_profile_reset() {
  const unsigned long long zero[8] = {};
  return (int)cudaMemcpyToSymbol(fold::g_fold_phase, zero, sizeof(zero));
}
#endif
