// bitset_intersect: BITSET ∩ BITSET counts (paper Section 4.2, Figure 6).
//
// Two entry points:
//
// bitset_pair_count: out[i] = |S_a ∩ S_b| for set pairs (a_slots[i],
// b_slots[i]) of one blocked bitset: the sum, over the block ids common
// to both sets' sorted block-id lists, of popc(row_a & row_b).  This is
// the engine's both-dense count.  It replaces the TPU kernel
// src/repro/kernels/bitset_intersect/kernel.py:45
// (bitset_and_popcount_kernel) together with the host block matching of
// the reference's src/repro/kernels/bitset_intersect/ops.py:75
// bitset_pair_count: there the host intersects the block-id lists with
// the uint machinery, an XLA gather copies the matched rows out and pads
// them to tiles ("per-block scalar gathers are not TPU-idiomatic"), the
// Pallas kernel ANDs and popcounts the copies, and the host sums the
// per-block counts into set-pair counts.  Here one warp takes a set pair
// and does all of it: the matched positions, the per-block counts and
// their sum never exist in device memory, and the host expands nothing.
//
// What bounds it on the H100: the block matching's latency, then the
// row gathers through L2.  Per set pair it reads two slot ids, four
// offsets and both block-id lists once and writes one int (the bytes
// bound); per matched block it reads two 32-byte rows.  At the full-size
// graph's call (745,312 pairs) the lists hold 410M ids and 65.5M blocks
// match: the rows are 4.19 GB of gathers out of a 22.7 MB table that
// stays in L2, the ids six for every matched block.  Design:
//
// 1. A warp takes up to kPairsPerWarp consecutive set pairs.  The
//    engine's pairs arrive in runs that share b (the fold's pairs are
//    sorted by their second vertex), so the warp stages one set and keeps
//    it while its pairs hold it: the set it staged last if the pair holds
//    it, else b.  The other set is walked.
// 2. Staged lookup: the warp writes the staged set as a bitmap over its
//    block-id range, from its first id, in shared memory with the row of
//    each 32-bit word's first id (2 KB a warp, kStageIds = 8,192 block
//    ids): 32 ids a step, the lanes of a word OR-ing their bits by
//    shuffles before one shared atomic, then a warp scan of the words'
//    popcounts.  The walked set's ids, two windows of 32 a step, each read
//    once and coalesced, are looked up: a bit test finds the common ids,
//    the word's row plus a popcount gives the id's row in the staged set,
//    and the walk stops at the staged set's last id.  No id is searched.
// 3. A set whose block ids span more than the staging (a hub of 15,625
//    blocks at n = 4M ids) is staged in slices of kStageIds block ids,
//    each from the set's next id (the slice's end found by a search of at
//    most 14 steps over the next kStageIds ids), and the walked set's ids
//    are looked up slice by slice, each read once: one path for every
//    input.
// 4. A lane that finds a common id ANDs the two rows (two 16-byte loads
//    each at the engine's 256-bit blocks, when w is a multiple of 4 and
//    the table 16-byte aligned) and popcounts them; a shuffle reduction
//    gives the pair's count and lane 0 writes it.
//
// bitset_and_popcount: out[i] = sum_k popc(words[pos_a[i]][k] &
// words[pos_b[i]][k]) over already matched block pairs, the direct
// counterpart of the TPU kernel's contract (kernel.py:45), a thread a
// pair gathering its two rows from the block table itself.  The engine
// no longer runs it; it is kept as that contract's kernel.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kPairThreads = 256;  // 8 warps a block
// the staged bitmap covers block ids below kStageIds: 2 KB a warp
constexpr int32_t kStageWords = 256;
constexpr int32_t kStageIds = kStageWords * 32;
// windows of 32 walked ids loaded together a lookup step
constexpr int kWindows = 2;
// a warp takes up to kPairsPerWarp consecutive pairs while the launch
// still gives every SM of the card as many warps as it holds
constexpr int32_t kPairsPerWarp = 4;

// popcount of (ra & rb) over the w words of a block row
__device__ __forceinline__ int32_t and_popc(const uint32_t* __restrict__ ra,
                                            const uint32_t* __restrict__ rb,
                                            int32_t w, bool vec) {
  int32_t acc = 0;
  if (vec) {
    const uint4* va = reinterpret_cast<const uint4*>(ra);
    const uint4* vb = reinterpret_cast<const uint4*>(rb);
    for (int32_t k = 0; k < (w >> 2); ++k) {
      uint4 x = __ldg(va + k);
      uint4 y = __ldg(vb + k);
      acc += __popc(x.x & y.x) + __popc(x.y & y.y) + __popc(x.z & y.z) +
             __popc(x.w & y.w);
    }
  } else {
    for (int32_t k = 0; k < w; ++k) acc += __popc(__ldg(ra + k) & __ldg(rb + k));
  }
  return acc;
}

__host__ __device__ __forceinline__ bool vector_rows(const uint32_t* words,
                                                    int32_t w) {
  return (w & 3) == 0 && (((uintptr_t)words) & 15) == 0;
}

// Stage the slice of one set's block ids that starts at s0 (its id lo)
// and ends before s1 or at the first id lo + kStageIds or more, as a
// bitmap over [lo, lo + kStageIds) with the row of each word's first id
// (s0 plus the word's exclusive rank).  Returns the slice's end.  The
// lanes of a window that share a bitmap word (the ids are sorted, so they
// are adjacent) OR their bits together first, and the last of them ORs
// the word in: one shared atomic a word, not a lane.
__device__ __forceinline__ int32_t stage_slice(
    const int32_t* __restrict__ block_ids, int32_t s0, int32_t s1,
    int32_t lo, uint32_t* bits, int32_t* rank, int lane) {
  int32_t e = s1;
  if (__ldg(block_ids + s1 - 1) - lo >= kStageIds) {  // uniform
    // the ids are distinct, so the slice ends by s0 + kStageIds
    int32_t h = min(s1, s0 + kStageIds);
    e = s0;
    while (e < h) {
      const int32_t m = (e + h) >> 1;
      if (__ldg(block_ids + m) - lo < kStageIds) e = m + 1;
      else h = m;
    }
  }
  const int32_t n_words = ((__ldg(block_ids + e - 1) - lo) >> 5) + 1;
  __syncwarp();  // the previous pair's lookups are done
  for (int32_t k = lane; k < n_words; k += 32) bits[k] = 0u;
  __syncwarp();
  for (int32_t k = 0; k < e - s0; k += 32) {  // uniform
    const bool in = lane < e - s0 - k;
    const int32_t d = in ? __ldg(block_ids + s0 + k + lane) - lo : -1;
    const int32_t word = d >> 5;
    uint32_t m = in ? 1u << (d & 31) : 0u;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const uint32_t t = __shfl_up_sync(kFull, m, o);
      const int32_t w_up = __shfl_up_sync(kFull, word, o);
      if (lane >= o && w_up == word) m |= t;
    }
    const int32_t w_next = __shfl_down_sync(kFull, word, 1);
    if (in && (lane == 31 || w_next != word)) atomicOr(bits + word, m);
  }
  __syncwarp();
  int32_t carry = 0;
  for (int32_t base = 0; base < n_words; base += 32) {  // uniform
    const int32_t k = base + lane;
    const int32_t c = k < n_words ? __popc(bits[k]) : 0;
    int32_t incl = c;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int32_t t = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += t;
    }
    if (k < n_words) rank[k] = s0 + carry + incl - c;
    carry += __shfl_sync(kFull, incl, 31);
  }
  __syncwarp();
  return e;
}

// The count of the walked set's ids from t (up to e) looked up in the
// staged slice's bitmap (its ids from lo to last): kWindows windows of 32
// ids a step, loaded together, up to the slice's last id.  Returns the
// count and where the walk stopped: past the ids up to last.
__device__ __forceinline__ int2 lookup_count(
    const int32_t* __restrict__ block_ids, const uint32_t* __restrict__ words,
    int32_t w, bool vec, int32_t lo, int32_t last, int32_t t,
    int32_t e, const uint32_t* bits, const int32_t* rank, int lane) {
  int32_t acc = 0;
  while (t < e) {  // uniform
    int32_t y[kWindows];
#pragma unroll
    for (int u = 0; u < kWindows; ++u)
      y[u] = lane + 32 * u < e - t ? __ldg(block_ids + t + 32 * u + lane)
                                   : INT32_MAX;
    int32_t row[kWindows];  // the id's row in the staged set, or -1
#pragma unroll
    for (int u = 0; u < kWindows; ++u) {
      row[u] = -1;
      if ((uint32_t)(y[u] - lo) <= (uint32_t)(last - lo)) {  // lo..last
        const int32_t d = y[u] - lo;
        const uint32_t word = bits[d >> 5];
        const int32_t bit = d & 31;
        if ((word >> bit) & 1u)
          row[u] = rank[d >> 5] + __popc(word & ((1u << bit) - 1u));
      }
    }
#pragma unroll
    for (int u = 0; u < kWindows; ++u)
      if (row[u] >= 0)
        acc += and_popc(words + (int64_t)row[u] * w,
                        words + (int64_t)(t + 32 * u + lane) * w, w, vec);
    // the ids up to last are a prefix of the sorted windows
    int32_t n = 0;
#pragma unroll
    for (int u = 0; u < kWindows; ++u)
      n += __popc(__ballot_sync(kFull, y[u] <= last));
    t += n;
    if (n < 32 * kWindows) break;  // an id passed last, or the list ended
  }
  return make_int2(acc, t);
}

}  // namespace

// kW: the words a block row, two 16-byte loads a row at kW = 8 (the
// engine's 256-bit blocks, a 16-byte aligned table), or 0 for any other
// width or alignment, read at run time.  At kW = 8 the row loads of both
// windows are issued together; in a loop over a width read at run time
// they are not (chip_smoke.py's case (h) times the kW = 0 instance on the
// engine's call).
template <int kW>
__global__ void __launch_bounds__(kPairThreads) bitset_pair_count_kernel(
    const int32_t* __restrict__ offsets, const int32_t* __restrict__ block_ids,
    const uint32_t* __restrict__ words, int32_t w_arg,
    const int32_t* __restrict__ a_slots, const int32_t* __restrict__ b_slots,
    int32_t p, int32_t pairs_per_warp, int32_t* __restrict__ out) {
  __shared__ uint32_t s_bits[kPairThreads / 32][kStageWords];
  __shared__ int32_t s_rank[kPairThreads / 32][kStageWords];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // p < 2^31 (the entry point checks), so pair indices are int32
  const int64_t first64 =
      (((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5) * pairs_per_warp;
  if (first64 >= p) return;  // uniform across the warp
  const int32_t first = (int32_t)first64;
  const int32_t last = min(first, p - pairs_per_warp) + pairs_per_warp;
  const int32_t w = kW ? kW : w_arg;
  const bool vec = kW ? true : vector_rows(words, w);
  uint32_t* bits = s_bits[warp];
  int32_t* rank = s_rank[warp];
  int32_t staged = -1;  // the slot whose whole list the bitmap holds
  for (int32_t pair = first; pair < last; ++pair) {  // uniform
    // ss: the set to stage (the staged one if the pair holds it, else b,
    // which the engine's pairs share in runs); ts: the set to walk
    int32_t ss = __ldg(b_slots + pair), ts = __ldg(a_slots + pair);
    if (ts == staged) {
      const int32_t x = ss;
      ss = ts;
      ts = x;
    }
    const int32_t s0 = __ldg(offsets + ss), s1 = __ldg(offsets + ss + 1);
    const int32_t t0 = __ldg(offsets + ts), t1 = __ldg(offsets + ts + 1);
    int32_t acc = 0;
    if (s0 < s1 && t0 < t1) {
      const int32_t lo = __ldg(block_ids + s0);
      const int32_t s_last = __ldg(block_ids + s1 - 1);
      if (s_last - lo < kStageIds) {  // the whole set in one slice
        if (ss != staged) {
          stage_slice(block_ids, s0, s1, lo, bits, rank, lane);
          staged = ss;
        }
        acc = lookup_count(block_ids, words, w, vec, lo, s_last, t0, t1, bits,
                           rank, lane).x;
      } else {  // a slice of the set a step
        staged = -1;
        for (int32_t s = s0, t = t0; s < s1 && t < t1;) {
          const int32_t slo = __ldg(block_ids + s);
          const int32_t e = stage_slice(block_ids, s, s1, slo, bits, rank,
                                        lane);
          const int2 r = lookup_count(block_ids, words, w, vec, slo,
                                      __ldg(block_ids + e - 1), t, t1, bits,
                                      rank, lane);
          acc += r.x;
          t = r.y;
          s = e;
        }
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) acc += __shfl_down_sync(kFull, acc, o);
    if (lane == 0) out[pair] = acc;
  }
}

__global__ void bitset_and_popcount_kernel(
    const uint32_t* __restrict__ words, int32_t w,
    const int32_t* __restrict__ pos_a, const int32_t* __restrict__ pos_b,
    int64_t p, int32_t* __restrict__ out) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p) return;
  out[i] = and_popc(words + (int64_t)__ldg(pos_a + i) * w,
                    words + (int64_t)__ldg(pos_b + i) * w, w,
                    vector_rows(words, w));
}

extern "C" int bitset_pair_count(const int32_t* offsets,
                                 const int32_t* block_ids,
                                 const uint32_t* words, int32_t w,
                                 const int32_t* a_slots,
                                 const int32_t* b_slots, int64_t p,
                                 int32_t* out, cudaStream_t stream) {
  if (p <= 0) return 0;
  if (p > INT32_MAX) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0, threads_per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &threads_per_sm, cudaDevAttrMaxThreadsPerMultiProcessor, dev);
  if (err != cudaSuccess) return (int)err;
  const int64_t resident_warps = (int64_t)sms * (threads_per_sm / 32);
  const int32_t per_warp = (int32_t)max(
      (int64_t)1, min((int64_t)kPairsPerWarp, p / resident_warps));
  const int64_t warps = (p + per_warp - 1) / per_warp;
  const int64_t blocks = (warps * 32 + kPairThreads - 1) / kPairThreads;
  if (w == 8 && vector_rows(words, w))
    bitset_pair_count_kernel<8><<<(unsigned int)blocks, kPairThreads, 0,
                                   stream>>>(offsets, block_ids, words, w,
                                             a_slots, b_slots, (int32_t)p,
                                             per_warp, out);
  else
    bitset_pair_count_kernel<0><<<(unsigned int)blocks, kPairThreads, 0,
                                   stream>>>(offsets, block_ids, words, w,
                                             a_slots, b_slots, (int32_t)p,
                                             per_warp, out);
  return (int)cudaGetLastError();
}

extern "C" int bitset_and_popcount(const uint32_t* words, int32_t w,
                                   const int32_t* pos_a,
                                   const int32_t* pos_b, int64_t p,
                                   int32_t* out, cudaStream_t stream) {
  if (p <= 0) return 0;
  const int threads = 256;
  const int64_t blocks = (p + threads - 1) / threads;
  bitset_and_popcount_kernel<<<(unsigned int)blocks, threads, 0, stream>>>(
      words, w, pos_a, pos_b, p, out);
  return (int)cudaGetLastError();
}
