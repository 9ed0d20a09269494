// materialize: the materializing BITSET ∩ BITSET of matched block pairs
// (paper Section 4.2 / Figure 6): every element of S_a ∩ S_b with its rank
// in both endpoint sets.
//
// Replaces the TPU kernel src/repro/kernels/materialize/kernel.py
// (bitset_materialize_kernel with _kernel) together with the jnp
// compaction _extract_pairs of src/repro/kernels/materialize/ops.py.  On
// the TPU the matched blocks are expanded to int32 0/1 bit planes
// [P, block_bits], the AND is a vector op and each bit's exclusive rank is
// a matmul against a triangular ones matrix on the MXU; a device cumsum
// over the whole P * block_bits plane then compacts the set bits.  Here
// the bits stay packed in 32-bit words and the ranks are popcounts: the
// exclusive rank of bit t of word k is the popcount of the words below k
// plus __popc(word & ((1 << t) - 1)).
//
// What bounds it on the H100: HBM bytes.  Each matched pair's pos_a, pos_b
// and pair id are read once (12 bytes a pair), each block once, and each
// match is written once as a 16-byte record.  The block rows themselves
// are read once a pair, P * 2 * w * 4 bytes (4.2 GB at 65.5M pairs of
// 256-bit blocks), but the words table (22.7 MB there) fits the 50 MB L2,
// so that is L2 traffic and not HBM traffic: the per-pair inputs are
// loaded, and the records stored, evict-first to keep the table there.
// Measured, a call lies well above that bound; chip_smoke.py's phase 8
// times the cases that split its time (PERF.md).
//
// One launch a call:
//
// 1. A group of G lanes takes one matched pair, each lane 8 words of the
//    two block rows in registers: G = 1 at 256-bit blocks (a thread a
//    pair, two 16-byte loads a row, so the words table must be 16-byte
//    aligned there), G = the power of two >= w / 8 above, chosen at
//    launch, up to 8192-bit blocks (MAX_W, which the wrapper reads from
//    materialize_max_words).  It ANDs and popcounts them, scans the
//    popcounts of a, b and a & b over the group's lanes (__shfl_up_sync
//    within the group), and keeps both rows in shared memory with each
//    lane's exclusive popcounts.  Each pair's inputs are read once: there
//    is no count array and no second pass.  The engine's blocks are 256
//    bits (SIMD_REGISTER_BITS), so only G = 1 runs on the query path;
//    G = 2..32 (the lane scans, the lane-chunk search and five of the six
//    instantiations) serve wider blocks, which only the tests use, and a
//    single looped path for wide blocks could replace that fan-out.
// 2. The block scans its 256 / G pairs' match counts and takes its base
//    slot by a single-pass decoupled look-back (Merrill & Garland, 2016):
//    it publishes its total, then its inclusive prefix, in one 64-bit
//    status word (flag in the top two bits), and its first warp sums back
//    over 32 predecessors at a time down to the nearest prefix.  Blocks
//    take their tile by an atomic ticket, not blockIdx.x, so every tile a
//    block waits on belongs to a block that is already running.  The
//    ticket and the statuses are one scratch array sized from P, zeroed on
//    the stream by cudaMemsetAsync: no cumsum, no host read.  While warp 0
//    looks back, warps 1..7 gather what the fill needs of the pairs with
//    matches (pair id, value base, both sets' ranks before the block).
// 3. The block's matches fill slots [base, base + n): a thread takes slots
//    j, j + 256, ..., finds its pair by a binary search over the block's
//    inclusive scan, its lane chunk by one over the pair's exclusive AND
//    counts, and its bit by selecting the r-th set bit of the AND words.
//    Adjacent threads write adjacent 16-byte records, so a pair with 256
//    matches costs its block more passes of the loop, not a stalled warp.
//    Slots follow the pair order and the bit order within a pair:
//    pair-major, values ascending.
// 4. Output: one int32 buffer [4 + 4 * cap].  Its first 8 bytes hold the
//    int64 total (the next 8 are 0), written by the last tile; record s,
//    (pair id, value, rank a, rank b), lies at [4 + 4s, 8 + 4s), one
//    16-byte store.  Slot positions are 64-bit; records at or past cap are
//    dropped but the total still counts them, so the caller reads the
//    total first, raises past cap, and fetches only the total's records.

#include <cuda_runtime.h>
#include <stdint.h>

#define FULL_MASK 0xffffffffu

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int GATHERERS = THREADS - 32;  // warps 1..7, during the look-back
constexpr int WPL = 8;                 // words of a block row a lane holds
constexpr int MAX_W = 32 * WPL;        // 8192-bit blocks
constexpr unsigned long long TOTAL = 1ull << 62;   // status: the tile's total
constexpr unsigned long long PREFIX = 1ull << 63;  // status: inclusive prefix
constexpr unsigned long long VALUE = TOTAL - 1;

int lanes_per_pair(int32_t w) {
  int g = 1;
  while (g * WPL < w) g <<= 1;
  return g;
}

// position of the r-th (from 0) set bit of x; x holds more than r set bits
__device__ __forceinline__ int select_bit(uint32_t x, int r) {
  int t = 0;
#pragma unroll
  for (int half = 16; half > 0; half >>= 1) {
    const int c = __popc(x & ((1u << half) - 1u));
    if (r >= c) {
      r -= c;
      t += half;
      x >>= half;
    }
  }
  return t;
}

__device__ __forceinline__ unsigned long long load_status(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p));
  return v;
}

__device__ __forceinline__ void store_status(unsigned long long* p,
                                             unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

// The exclusive prefix of tile `tile` (> 0) by decoupled look-back, run by
// one warp: lane l reads the status of tile top - l, 32 predecessors a
// round, waits until every one nearer than the nearest prefix holds a
// flag, and sums them down to that prefix.
__device__ long long look_back(const unsigned long long* status,
                               int64_t tile, int lane) {
  long long excl = 0;
  for (int64_t top = tile - 1;; top -= 32) {
    unsigned long long s;
    int stop;
    while (true) {
      s = PREFIX;  // before tile 0: an empty prefix
      if (top - lane >= 0) s = load_status(status + top - lane);
      const unsigned pre = __ballot_sync(FULL_MASK, (s & PREFIX) != 0);
      stop = pre ? __ffs(pre) - 1 : 32;
      if (!__any_sync(FULL_MASK, lane < stop && s == 0)) break;
      __nanosleep(20);
    }
    long long v = lane <= stop ? (long long)(s & VALUE) : 0;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_xor_sync(FULL_MASK, v, off);
    excl += v;
    if (stop < 32) return excl;
  }
}

template <int G>
__global__ void __launch_bounds__(THREADS) materialize_kernel(
    const uint32_t* __restrict__ words, int32_t w,
    const int32_t* __restrict__ block_ids, const int32_t* __restrict__ index,
    const int32_t* __restrict__ pos_a, const int32_t* __restrict__ pos_b,
    const int32_t* __restrict__ pair_id, int64_t p, int64_t cap,
    int64_t tiles, int32_t* __restrict__ out,
    unsigned long long* __restrict__ scratch) {
  constexpr int PAIRS = THREADS / G;
  constexpr int ROW = G * WPL;  // a pair's words in shared, zero-padded
  __shared__ uint4 s_a4[PAIRS * ROW / 4], s_b4[PAIRS * ROW / 4];
  __shared__ int32_t s_ex[G > 1 ? 3 : 1][G > 1 ? THREADS : 1];
  __shared__ int32_t s_pa[PAIRS], s_pb[PAIRS], s_cnt[PAIRS], s_incl[PAIRS];
  __shared__ int32_t s_pid[PAIRS], s_vbase[PAIRS], s_ia[PAIRS], s_ib[PAIRS];
  __shared__ int32_t s_warp[WARPS];
  __shared__ long long s_base;
  __shared__ unsigned int s_tile;
  const uint32_t* s_a = reinterpret_cast<const uint32_t*>(s_a4);
  const uint32_t* s_b = reinterpret_cast<const uint32_t*>(s_b4);

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  if (tid == 0) s_tile = atomicAdd(reinterpret_cast<unsigned int*>(scratch), 1u);
  __syncthreads();
  const int64_t tile = s_tile;
  unsigned long long* status = scratch + 1;

  // 1. a group of G lanes a pair, 8 words a lane
  const int q = tid / G, g = tid % G;
  const int64_t pr = tile * PAIRS + q;
  uint32_t a[WPL], b[WPL];
  int32_t pa = 0, pb = 0;
  if (pr < p) {
    pa = __ldcs(pos_a + pr);
    pb = __ldcs(pos_b + pr);
    const uint32_t* ra = words + (int64_t)pa * w + g * WPL;
    const uint32_t* rb = words + (int64_t)pb * w + g * WPL;
    if (G == 1 && w == WPL) {  // 32-byte rows: two 16-byte loads each
      const uint4 a0 = __ldg(reinterpret_cast<const uint4*>(ra));
      const uint4 a1 = __ldg(reinterpret_cast<const uint4*>(ra) + 1);
      const uint4 b0 = __ldg(reinterpret_cast<const uint4*>(rb));
      const uint4 b1 = __ldg(reinterpret_cast<const uint4*>(rb) + 1);
      a[0] = a0.x; a[1] = a0.y; a[2] = a0.z; a[3] = a0.w;
      a[4] = a1.x; a[5] = a1.y; a[6] = a1.z; a[7] = a1.w;
      b[0] = b0.x; b[1] = b0.y; b[2] = b0.z; b[3] = b0.w;
      b[4] = b1.x; b[5] = b1.y; b[6] = b1.z; b[7] = b1.w;
    } else {
#pragma unroll
      for (int k = 0; k < WPL; ++k) {
        const bool in = g * WPL + k < w;
        a[k] = in ? __ldg(ra + k) : 0u;
        b[k] = in ? __ldg(rb + k) : 0u;
      }
    }
  } else {
#pragma unroll
    for (int k = 0; k < WPL; ++k) a[k] = b[k] = 0u;
  }
  int ca = 0, cb = 0, cx = 0;
#pragma unroll
  for (int k = 0; k < WPL; ++k) {
    ca += __popc(a[k]);
    cb += __popc(b[k]);
    cx += __popc(a[k] & b[k]);
  }
  int n_pair = cx;
  if constexpr (G > 1) {  // exclusive scans over the pair's lanes
    int sa = ca, sb = cb, sx = cx;
#pragma unroll
    for (int off = 1; off < G; off <<= 1) {
      const int ta = __shfl_up_sync(FULL_MASK, sa, off, G);
      const int tb = __shfl_up_sync(FULL_MASK, sb, off, G);
      const int tx = __shfl_up_sync(FULL_MASK, sx, off, G);
      if (g >= off) {
        sa += ta;
        sb += tb;
        sx += tx;
      }
    }
    n_pair = __shfl_sync(FULL_MASK, sx, G - 1, G);
    s_ex[0][tid] = sa - ca;
    s_ex[1][tid] = sb - cb;
    s_ex[2][tid] = sx - cx;
  }
  uint4* sa4 = s_a4 + (q * ROW + g * WPL) / 4;
  uint4* sb4 = s_b4 + (q * ROW + g * WPL) / 4;
  sa4[0] = make_uint4(a[0], a[1], a[2], a[3]);
  sa4[1] = make_uint4(a[4], a[5], a[6], a[7]);
  sb4[0] = make_uint4(b[0], b[1], b[2], b[3]);
  sb4[1] = make_uint4(b[4], b[5], b[6], b[7]);
  if (g == 0) {
    s_pa[q] = pa;
    s_pb[q] = pb;
    s_cnt[q] = n_pair;
  }

  // 2. the tile's inclusive scan over its pairs (each pair's count held
  // by its first lane): a warp scan, then across the warps
  int incl = g == 0 ? n_pair : 0;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int t = __shfl_up_sync(FULL_MASK, incl, off);
    if (lane >= off) incl += t;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  int n_tile = 0;
#pragma unroll
  for (int v = 0; v < WARPS; ++v) {
    const int c = s_warp[v];
    if (v < warp) incl += c;
    n_tile += c;
  }
  if (g == 0) s_incl[q] = incl;
  __syncthreads();

  // 3. warp 0 takes the tile's base slot by look-back while the others
  // gather what the fill needs of the pairs with matches; then the matches
  // fill slots [base, base + n_tile), a slot a thread, adjacent slots
  // adjacent
  if (warp == 0) {
    long long excl = 0;
    if (tile > 0) {
      if (lane == 0) store_status(status + tile, TOTAL | (unsigned long long)n_tile);
      excl = look_back(status, tile, lane);
    }
    if (lane == 0) {
      store_status(status + tile, PREFIX | (unsigned long long)(excl + n_tile));
      s_base = excl;
      if (tile == tiles - 1) {
        const long long total = excl + n_tile;
        *reinterpret_cast<int4*>(out) =
            make_int4((int)(total & 0xffffffffll), (int)(total >> 32), 0, 0);
      }
    }
  } else {
    for (int u = tid - 32; u < PAIRS; u += GATHERERS) {
      if (s_cnt[u] > 0) {
        const int32_t ua = s_pa[u];
        s_pid[u] = __ldcs(pair_id + tile * PAIRS + u);
        s_vbase[u] = __ldg(block_ids + ua) * (w * 32);
        s_ia[u] = __ldg(index + ua);
        s_ib[u] = __ldg(index + s_pb[u]);
      }
    }
  }
  __syncthreads();
  const long long base = s_base;
  int4* rec = reinterpret_cast<int4*>(out + 4) + base;
  for (int j = tid; j < n_tile && base + j < cap; j += THREADS) {
    int lo = 0, hi = PAIRS - 1;  // the first pair whose inclusive scan > j
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (s_incl[mid] > j) hi = mid;
      else lo = mid + 1;
    }
    const int pq = lo;
    int r = j - (pq > 0 ? s_incl[pq - 1] : 0);
    int l = 0, before_a = 0, before_b = 0;
    if constexpr (G > 1) {  // the last lane chunk whose exclusive count <= r
      int clo = 0, chi = G - 1;
      while (clo < chi) {
        const int mid = (clo + chi + 1) >> 1;
        if (s_ex[2][pq * G + mid] <= r) clo = mid;
        else chi = mid - 1;
      }
      l = clo;
      r -= s_ex[2][pq * G + l];
      before_a = s_ex[0][pq * G + l];
      before_b = s_ex[1][pq * G + l];
    }
    const uint32_t* ra = s_a + pq * ROW + l * WPL;
    const uint32_t* rb = s_b + pq * ROW + l * WPL;
    int k = 0;
    uint32_t xa = ra[0], xb = rb[0], x = xa & xb;
    for (int c = __popc(x); r >= c && k < WPL - 1; c = __popc(x)) {
      r -= c;
      before_a += __popc(xa);
      before_b += __popc(xb);
      ++k;
      xa = ra[k];
      xb = rb[k];
      x = xa & xb;
    }
    const int t = select_bit(x, r);
    const uint32_t below = (1u << t) - 1u;
    __stcs(rec + j, make_int4(s_pid[pq], s_vbase[pq] + (l * WPL + k) * 32 + t,
                              s_ia[pq] + before_a + __popc(xa & below),
                              s_ib[pq] + before_b + __popc(xb & below)));
  }
}

template <int G>
cudaError_t launch(const uint32_t* words, int32_t w, const int32_t* block_ids,
                   const int32_t* index, const int32_t* pos_a,
                   const int32_t* pos_b, const int32_t* pair_id, int64_t p,
                   int64_t cap, int64_t tiles, int32_t* out,
                   unsigned long long* scratch, cudaStream_t stream) {
  materialize_kernel<G><<<(unsigned int)tiles, THREADS, 0, stream>>>(
      words, w, block_ids, index, pos_a, pos_b, pair_id, p, cap, tiles, out,
      scratch);
  return cudaGetLastError();
}

}  // namespace

// the widest block row the kernel takes, in 32-bit words
extern "C" int32_t materialize_max_words() { return MAX_W; }

// tiles (thread blocks) of a call: the scratch holds 1 + tiles int64
extern "C" int64_t materialize_tiles(int32_t w, int64_t p) {
  const int pairs = THREADS / lanes_per_pair(w);
  return (p + pairs - 1) / pairs;
}

extern "C" int materialize(const uint32_t* words, int32_t w,
                           const int32_t* block_ids, const int32_t* index,
                           const int32_t* pos_a, const int32_t* pos_b,
                           const int32_t* pair_id, int64_t p, int64_t cap,
                           int32_t* out, unsigned long long* scratch,
                           int64_t scratch_len, cudaStream_t stream) {
  if (p <= 0 || w <= 0 || w > MAX_W) return (int)cudaErrorInvalidValue;
  const int64_t tiles = materialize_tiles(w, p);
  if (scratch_len < 1 + tiles || tiles > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaMemsetAsync(scratch, 0, (1 + tiles) * 8, stream);
  if (e != cudaSuccess) return (int)e;
  switch (lanes_per_pair(w)) {
#define MATERIALIZE_CASE(G)                                                  \
  case G:                                                                    \
    e = launch<G>(words, w, block_ids, index, pos_a, pos_b, pair_id, p, cap, \
                  tiles, out, scratch, stream);                              \
    break;
    MATERIALIZE_CASE(1)
    MATERIALIZE_CASE(2)
    MATERIALIZE_CASE(4)
    MATERIALIZE_CASE(8)
    MATERIALIZE_CASE(16)
    MATERIALIZE_CASE(32)
#undef MATERIALIZE_CASE
    default:
      e = cudaErrorInvalidValue;
  }
  return (int)e;
}
