// uint_intersect: out[i] = |N(u_i) ∩ N(v_i)| over the sorted neighbour
// sets of a CSR (paper Section 4.2, UINT ∩ UINT, the short
// similar-cardinality regime).
//
// Replaces the TPU kernel src/repro/kernels/uint_intersect/kernel.py:50
// (uint_intersect_kernel with _kernel), which compares -1-padded row tiles
// of both sets with a broadcast equality cube: the TPU has no cross-lane
// shuffle, and the host gathered and padded the rows first.
//
// What bounds it on the H100: the bytes, each endpoint's row and two
// offsets read once, u, v and the counts (0.0062 ms at 3.35 TB/s on the
// full-size TRIANGLE_COUNT's call, 982,416 pairs; the search's operations
// 0.0038 ms).  The pairs' rows read through L2 are far more,
// sum(|a| + |b|) * 4 = 161 MB on that call.  The engine routes here only
// pairs whose larger set has at most 256 elements, and that call's sets
// are short: the smaller has 9 elements at the median, the larger 25, so
// a warp a pair idled most lanes and spent its life on a chain of
// dependent loads through L2 (u, v, the offsets, a binary search).
//
// Design: a warp takes a fixed range of consecutive pairs and works
// through it in batches of up to 32 pairs, one a lane:
// 1. Each lane loads its pair's u, v and four offsets (independent loads
//    across the lanes) and picks the smaller set a and the larger set b.
// 2. The batch stages its rows in the warp's 4 KB of shared memory: each
//    row as the 16-byte chunks that hold it, copied with cp.async, the
//    whole batch's copies in flight at once, no register round trip.  A
//    row that the previous pair staged on the same side is not read
//    again, so a run of pairs sharing v (the fold's pairs are sorted by
//    v), or sharing u, reads the shared row once.  The batch is the
//    longest prefix of the 32 pairs whose rows fit.
// 3. The lanes then take the batch's probes (one element of a smaller set
//    each), 64 a step, several pairs a step: a lane finds the pair of each
//    of its two probes by a popcount of the bitmap of the pairs' first
//    probes in the probe's window of 32 (one __reduce_or_sync a window),
//    reads the element and searches b in shared memory, both searches in
//    lockstep so that their loads overlap; a hit adds one to the pair's
//    count in shared memory.  The rows are sets, so the hits are the
//    intersection size.
// 4. The lanes write their pairs' counts, coalesced.
// A larger set is searched where it lies in the CSR, not staged, when its
// probes would read less of it than it holds (8 |a| log2|b| < |b|, one
// element of the 1 against 256 pairs that the cap allows), and so is any
// set beyond 256 elements, which the engine never sends: such a pair takes
// a batch of its own.  The ranges: P over 8 times the warps the card holds
// at once (its SM count times this kernel's occupancy), about a batch a
// warp on the engine's calls, so that blocks that end early make room.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;  // 8 warps a block
constexpr int kWarps = kThreads / 32;
constexpr int kWaves = 8;
// staged 16-byte chunks a warp (4 KB): two 256-element sets and more
constexpr int32_t kStageChunks = 256;
// the longest set staged (the engine's uint_max_len)
constexpr int32_t kMaxStaged = 256;
// probes a lane takes a step
constexpr int kPerLane = 2;

// where a set of a pair lies: the staged position of its first element
// (>= 0), or ~start for a set searched where it lies in the CSR
struct Probe {    // a pair with a probe, by its ordinal in the batch
  int32_t a;      // its smaller set
  int32_t b;      // its larger set
  int32_t nb;     // |b|
  int32_t first;  // its first probe's index in the batch
};

struct WarpStage {
  int4 chunks[kStageChunks];
  int32_t delta[2 * 32];  // a staged row's first CSR chunk minus its
                          // staged chunk, by the row's ordinal
  Probe probe[32];
  int32_t hits[32];
};

__device__ __forceinline__ uint32_t lanes_upto(int lane) {
  return kFull >> (31 - lane);
}

__device__ __forceinline__ uint32_t lanes_below(int lane) {
  return (1u << lane) - 1u;
}

// the bit of pos in the window of 32 positions from base, or 0
__device__ __forceinline__ uint32_t window_bit(int32_t pos, int32_t base) {
  const uint32_t d = (uint32_t)(pos - base);
  return d < 32u ? 1u << d : 0u;
}

__device__ __forceinline__ int32_t warp_scan(int32_t x, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int32_t t = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += t;
  }
  return x;
}

__device__ __forceinline__ void copy_async16(int4* dst, const int4* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src));
}

// where a set lies: in the staging, or (kStaged false, where < 0) in the
// CSR
template <bool kStaged>
__device__ __forceinline__ const int32_t* set_at(const int32_t* elems,
                                                 const int32_t* nbr,
                                                 int32_t where) {
  return kStaged || where >= 0 ? elems + where : nbr + ~where;
}

// Whether each sorted row[t][0, n[t]) holds x[t] (n[t] >= 1), the
// searches in lockstep so that their loads overlap: the count of elements
// at most x in steps of a power of two (a step past the end reads the last
// element), keeping the last element at most x that a step read, so no
// compare is left after the last step.
__device__ __forceinline__ void contains(
    const int32_t* const (&row)[kPerLane], const int32_t (&n)[kPerLane],
    const int32_t (&x)[kPerLane], bool (&hit)[kPerLane]) {
  int32_t upto[kPerLane], last[kPerLane], top = 1;
#pragma unroll
  for (int t = 0; t < kPerLane; ++t) {
    upto[t] = 0;
    last[t] = ~x[t];
    top = max(top, n[t]);
  }
  for (int32_t step = 1 << (31 - __clz(top)); step > 0; step >>= 1) {
#pragma unroll
    for (int t = 0; t < kPerLane; ++t) {
      const int32_t j = min(upto[t] + step, n[t]);
      const int32_t y = row[t][j - 1];
      if (y <= x[t]) {
        upto[t] = j;
        last[t] = y;
      }
    }
  }
#pragma unroll
  for (int t = 0; t < kPerLane; ++t) hit[t] = last[t] == x[t];
}

// 3. The batch's probes, 32 * kPerLane consecutive ones a step, a lane's
// t-th in the t-th window of 32, each lane's pair the last one whose first
// probe is at or before its probe.  kStaged: every set of the batch is
// staged, so every load here is a shared-memory load; where a set may lie
// in the CSR the same loads take generic addresses, which are slower.
template <bool kStaged>
__device__ __forceinline__ void probe_batch(WarpStage& st,
                                            const int32_t* __restrict__ nbr,
                                            bool live, int32_t first_probe,
                                            int32_t n_probes, int lane) {
  const int32_t* elems = reinterpret_cast<const int32_t*>(st.chunks);
  int32_t pairs_before = 0;
  for (int32_t base = 0; base < n_probes; base += 32 * kPerLane) {  // uniform
    int q[kPerLane];
    bool active[kPerLane], hit[kPerLane];
    const int32_t* row[kPerLane];
    int32_t n[kPerLane], x[kPerLane];
#pragma unroll
    for (int t = 0; t < kPerLane; ++t) {
      const int32_t window = base + 32 * t;
      const uint32_t starts = __reduce_or_sync(
          kFull, live ? window_bit(first_probe, window) : 0u);
      // a lane past the last probe reads the last pair, which is live
      q[t] = pairs_before + __popc(starts & lanes_upto(lane)) - 1;
      pairs_before += __popc(starts);
      const Probe pr = st.probe[q[t]];
      const int32_t k = window + lane;
      active[t] = k < n_probes;
      row[t] = set_at<kStaged>(elems, nbr, pr.b);
      n[t] = active[t] ? pr.nb : 1;
      x[t] = active[t] ? set_at<kStaged>(elems, nbr, pr.a)[k - pr.first] : 0;
    }
    contains(row, n, x, hit);
#pragma unroll
    for (int t = 0; t < kPerLane; ++t)
      if (active[t] && hit[t]) atomicAdd(&st.hits[q[t]], 1);
  }
}

}  // namespace

__global__ void __launch_bounds__(kThreads) uint_intersect_kernel(
    const int32_t* __restrict__ offsets, const int32_t* __restrict__ nbr,
    const int32_t* __restrict__ u, const int32_t* __restrict__ v, int32_t p,
    int32_t per_warp, int32_t* __restrict__ out) {
  __shared__ WarpStage s_warp[kWarps];
  WarpStage& st = s_warp[threadIdx.x >> 5];
  const int lane = threadIdx.x & 31;
  // the CSR in 16-byte chunks: a row is copied as the chunks that hold
  // it, each of which holds one of its elements and so lies in nbr's
  // allocation; mis: nbr's words past the chunk boundary below it
  const int32_t mis = (int32_t)(((uintptr_t)nbr >> 2) & 3);
  const int4* csr_chunks = reinterpret_cast<const int4*>(nbr - mis);
  // p < 2^31 (the entry point checks), so pair indices are int32
  const int64_t first64 =
      (((int64_t)blockIdx.x * kThreads + threadIdx.x) >> 5) * per_warp;
  if (first64 >= p) return;  // uniform across the warp
  const int32_t end = (int32_t)min((int64_t)p, first64 + per_warp);
  for (int32_t s = (int32_t)first64; s < end;) {  // uniform: a batch
    // 1. a lane a pair: its sets, the smaller a and the larger b
    const int32_t i = s + lane;
    const bool in = i < end;
    int32_t ui = -1, vi = -1, a0 = 0, la = 0, b0 = 0, lb = 0;
    if (in) {
      ui = __ldg(u + i);
      vi = __ldg(v + i);
      a0 = __ldg(offsets + ui);
      la = __ldg(offsets + ui + 1) - a0;
      b0 = __ldg(offsets + vi);
      lb = __ldg(offsets + vi + 1) - b0;
    }
    const bool u_small = la <= lb;
    const int32_t na = u_small ? la : lb, nb = u_small ? lb : la;
    const bool stage_a = na <= kMaxStaged;
    const bool stage_b =
        nb <= kMaxStaged && 8 * na * (32 - __clz(nb)) >= nb;
    const bool need_u = in && (u_small ? stage_a : stage_b);
    const bool need_v = in && (u_small ? stage_b : stage_a);
    // a row the previous pair staged on the same side is not read again
    const int32_t u_prev = __shfl_up_sync(kFull, ui, 1);
    const int32_t v_prev = __shfl_up_sync(kFull, vi, 1);
    const uint32_t need_u_lanes = __ballot_sync(kFull, need_u);
    const uint32_t need_v_lanes = __ballot_sync(kFull, need_v);
    bool own_u = need_u && !(lane > 0 && u_prev == ui &&
                             ((need_u_lanes >> (lane - 1)) & 1u));
    bool own_v = need_v && !(lane > 0 && v_prev == vi &&
                             ((need_v_lanes >> (lane - 1)) & 1u));
    // each row's chunks
    const int32_t wu = a0 + mis, wv = b0 + mis;
    const int32_t cu = la > 0 ? ((wu + la + 3) >> 2) - (wu >> 2) : 0;
    const int32_t cv = lb > 0 ? ((wv + lb + 3) >> 2) - (wv >> 2) : 0;
    const int32_t staged = (own_u ? cu : 0) + (own_v ? cv : 0);
    const int32_t probes = in ? na : 0;
    const int32_t staged_incl = warp_scan(staged, lane);
    const int32_t probes_incl = warp_scan(probes, lane);
    // the batch: the longest prefix whose rows fit, a pair with a set
    // beyond the staging alone
    uint32_t fit = __ballot_sync(kFull, in && staged_incl <= kStageChunks);
    const uint32_t longs = __ballot_sync(kFull, in && nb > kMaxStaged);
    if (longs & 1u)
      fit = 1u;
    else if (longs)
      fit &= (longs & (0u - longs)) - 1u;
    const int n = __popc(fit);  // >= 1: a pair's rows fit the staging
    const bool take = lane < n;
    own_u = own_u && take;
    own_v = own_v && take;
    const int32_t n_staged = __shfl_sync(kFull, staged_incl, n - 1);
    const int32_t n_probes = __shfl_sync(kFull, probes_incl, n - 1);
    const int32_t chunk_u = staged_incl - staged;
    const int32_t chunk_v = chunk_u + (own_u ? cu : 0);
    // a needed row another pair staged: the nearest owner at or before
    // this lane (the lanes between share the row)
    const uint32_t own_u_lanes = __ballot_sync(kFull, own_u);
    const uint32_t own_v_lanes = __ballot_sync(kFull, own_v);
    const int32_t at_u = __shfl_sync(
        kFull, 4 * chunk_u + (wu & 3),
        (31 - __clz(own_u_lanes & lanes_upto(lane))) & 31);
    const int32_t at_v = __shfl_sync(
        kFull, 4 * chunk_v + (wv & 3),
        (31 - __clz(own_v_lanes & lanes_upto(lane))) & 31);
    // the rows to copy, by staged chunk
    const bool row_u = own_u && cu > 0, row_v = own_v && cv > 0;
    const int row_ord =
        __popc(__ballot_sync(kFull, row_u) & lanes_below(lane)) +
        __popc(__ballot_sync(kFull, row_v) & lanes_below(lane));
    if (row_u) st.delta[row_ord] = (wu >> 2) - chunk_u;
    if (row_v) st.delta[row_ord + row_u] = (wv >> 2) - chunk_v;
    // the pairs with a probe, by ordinal
    const bool live = take && na > 0;
    const uint32_t live_lanes = __ballot_sync(kFull, live);
    const int ord = __popc(live_lanes & lanes_below(lane));
    const int32_t first_probe = probes_incl - probes;
    if (live) {
      const int32_t where_u = need_u ? at_u : ~a0;
      const int32_t where_v = need_v ? at_v : ~b0;
      st.probe[ord] = Probe{u_small ? where_u : where_v,
                            u_small ? where_v : where_u, nb, first_probe};
      st.hits[ord] = 0;
    }
    const bool all_staged = !__any_sync(kFull, live && !(stage_a && stage_b));
    __syncwarp();
    // 2. stage the rows: 32 consecutive chunks a step, each lane's row the
    // last one starting at or before its chunk
    int32_t rows_before = 0;
    for (int32_t base = 0; base < n_staged; base += 32) {  // uniform
      const uint32_t starts = __reduce_or_sync(
          kFull, (row_u ? window_bit(chunk_u, base) : 0u) |
                     (row_v ? window_bit(chunk_v, base) : 0u));
      const int32_t k = base + lane;
      if (k < n_staged) {
        const int r = rows_before + __popc(starts & lanes_upto(lane)) - 1;
        copy_async16(st.chunks + k, csr_chunks + st.delta[r] + k);
      }
      rows_before += __popc(starts);
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncwarp();
    if (all_staged)
      probe_batch<true>(st, nbr, live, first_probe, n_probes, lane);
    else
      probe_batch<false>(st, nbr, live, first_probe, n_probes, lane);
    __syncwarp();
    // 4. the counts
    if (take) out[i] = live ? st.hits[ord] : 0;
    s += n;
    __syncwarp();  // the next batch overwrites the staging
  }
}

extern "C" int uint_intersect_count(const int32_t* offsets,
                                    const int32_t* nbr, const int32_t* u,
                                    const int32_t* v, int64_t p, int32_t* out,
                                    cudaStream_t stream) {
  if (p <= 0) return 0;
  if (p > INT32_MAX) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0, blocks_per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks_per_sm, uint_intersect_kernel, kThreads, 0);
  if (err != cudaSuccess) return (int)err;
  // kWaves times the warps the card holds at once, each an equal range
  const int64_t slots =
      (int64_t)sms * (int64_t)max(blocks_per_sm, 1) * kWarps * kWaves;
  const int64_t per_warp = (p + slots - 1) / slots;
  const int64_t warps = (p + per_warp - 1) / per_warp;
  const int64_t blocks = (warps + kWarps - 1) / kWarps;
  uint_intersect_kernel<<<(unsigned int)blocks, kThreads, 0, stream>>>(
      offsets, nbr, u, v, (int32_t)p, (int32_t)per_warp, out);
  return (int)cudaGetLastError();
}
