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
// over the whole P * block_bits plane then compacts the set bits.
//
// Here the bits stay packed in 32-bit words and the ranks are popcounts:
// the exclusive rank of bit t of word k is the popcount of the words
// before k (a warp scan) plus __popc(word & ((1 << t) - 1)).  Count then
// fill, one warp per matched block pair, lanes over the block's words
// (a loop over chunks of 32 words above block_bits 1024):
//
//   materialize_count: counts[p] = sum_k popc(a[k] & b[k]), a warp reduce;
//   (the caller takes the inclusive scan of counts: torch.cumsum, int32)
//   materialize_fill:  a __shfl_up_sync scan of the per-word popcounts of
//     a, b and a & b gives each surviving bit its compacted slot and both
//     ranks; the kernel writes, per match, pair_id[p], the value
//     block_ids[pos_a[p]] * block_bits + bit, and the set ranks
//     index[pos_x[p]] + in-block rank (index is the Figure-6 cumulative
//     cardinality before each block).  The pair with the last id writes
//     the total to out[0].
//
// The kernel writes the final (pair id, value, rank a, rank b) tuple and
// not the TPU's flat plane position p * block_bits + bit: that position
// passes 2^31 already at 8.4M matched pairs of 256-bit blocks (12.6M on
// powerlaw_graph(50_000, 20, 2.2)), and the host gathers that turned it
// into the tuple ran over every match.
//
// Output: one int32 buffer [1 + 4 * cap]: the total, then four arrays of
// cap slots.  The caller sizes cap from a host bound (sum over pairs of
// min(popcount a, popcount b)), so no transfer precedes the fill and the
// closing fetch is the call's only transfer after the block matching.
//
// What bounds it on the H100: bytes.  Each matched pair reads its two
// blocks (twice: once to count, once to fill), its two positions and its
// pair id, and each match writes 16 bytes; the popcounts and the scan are
// a few instructions per word.  No [P, block_bits] plane is allocated.

#include <cuda_runtime.h>
#include <stdint.h>

#define FULL_MASK 0xffffffffu

__global__ void materialize_count_kernel(const uint32_t* __restrict__ words,
                                         int32_t w,
                                         const int32_t* __restrict__ pos_a,
                                         const int32_t* __restrict__ pos_b,
                                         int64_t p,
                                         int32_t* __restrict__ counts) {
  int64_t warp = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  int lane = threadIdx.x & 31;
  if (warp >= p) return;  // uniform across the warp
  const uint32_t* ra = words + (int64_t)__ldg(pos_a + warp) * w;
  const uint32_t* rb = words + (int64_t)__ldg(pos_b + warp) * w;
  int32_t c = 0;
  for (int32_t k = lane; k < w; k += 32) c += __popc(__ldg(ra + k) & __ldg(rb + k));
  for (int off = 16; off > 0; off >>= 1) c += __shfl_down_sync(FULL_MASK, c, off);
  if (lane == 0) counts[warp] = c;
}

__global__ void materialize_fill_kernel(
    const uint32_t* __restrict__ words, int32_t w,
    const int32_t* __restrict__ block_ids, const int32_t* __restrict__ index,
    const int32_t* __restrict__ pos_a, const int32_t* __restrict__ pos_b,
    const int32_t* __restrict__ pair_id, int64_t p,
    const int32_t* __restrict__ incl, int64_t cap, int32_t* __restrict__ out) {
  int64_t warp = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  int lane = threadIdx.x & 31;
  if (warp >= p) return;  // uniform across the warp
  if (warp == p - 1 && lane == 0) out[0] = __ldg(incl + p - 1);
  const int32_t pa = __ldg(pos_a + warp), pb = __ldg(pos_b + warp);
  const uint32_t* ra = words + (int64_t)pa * w;
  const uint32_t* rb = words + (int64_t)pb * w;
  const int32_t pid = __ldg(pair_id + warp);
  const int32_t vbase = __ldg(block_ids + pa) * (w * 32);
  const int32_t ia = __ldg(index + pa), ib = __ldg(index + pb);
  int32_t* o_pid = out + 1;
  int32_t* o_val = o_pid + cap;
  int32_t* o_ra = o_val + cap;
  int32_t* o_rb = o_ra + cap;
  // popcounts of the words of earlier chunks, and the slot of the chunk
  int32_t carry_a = 0, carry_b = 0;
  int64_t carry_s = warp > 0 ? (int64_t)__ldg(incl + warp - 1) : 0;
  for (int32_t k0 = 0; k0 < w; k0 += 32) {
    const int32_t k = k0 + lane;
    const uint32_t xa = k < w ? __ldg(ra + k) : 0u;
    const uint32_t xb = k < w ? __ldg(rb + k) : 0u;
    uint32_t x = xa & xb;
    const int32_t ca = __popc(xa), cb = __popc(xb), cx = __popc(x);
    int32_t sa = ca, sb = cb, sx = cx;  // inclusive scans over the lanes
    for (int off = 1; off < 32; off <<= 1) {
      int32_t ta = __shfl_up_sync(FULL_MASK, sa, off);
      int32_t tb = __shfl_up_sync(FULL_MASK, sb, off);
      int32_t tx = __shfl_up_sync(FULL_MASK, sx, off);
      if (lane >= off) {
        sa += ta;
        sb += tb;
        sx += tx;
      }
    }
    const int32_t pre_a = ia + carry_a + sa - ca;
    const int32_t pre_b = ib + carry_b + sb - cb;
    int64_t s = carry_s + (sx - cx);
    while (x) {
      const int t = __ffs(x) - 1;
      const uint32_t below = (1u << t) - 1u;
      if (s < cap) {
        o_pid[s] = pid;
        o_val[s] = vbase + k * 32 + t;
        o_ra[s] = pre_a + __popc(xa & below);
        o_rb[s] = pre_b + __popc(xb & below);
      }
      ++s;
      x &= x - 1u;
    }
    carry_a += __shfl_sync(FULL_MASK, sa, 31);
    carry_b += __shfl_sync(FULL_MASK, sb, 31);
    carry_s += __shfl_sync(FULL_MASK, sx, 31);
  }
}

static unsigned int warp_blocks(int64_t p, int threads) {
  return (unsigned int)((p * 32 + threads - 1) / threads);
}

extern "C" int materialize_count(const uint32_t* words, int32_t w,
                                 const int32_t* pos_a, const int32_t* pos_b,
                                 int64_t p, int32_t* counts,
                                 cudaStream_t stream) {
  if (p <= 0) return 0;
  const int threads = 256;
  materialize_count_kernel<<<warp_blocks(p, threads), threads, 0, stream>>>(
      words, w, pos_a, pos_b, p, counts);
  return (int)cudaGetLastError();
}

extern "C" int materialize_fill(const uint32_t* words, int32_t w,
                                const int32_t* block_ids,
                                const int32_t* index, const int32_t* pos_a,
                                const int32_t* pos_b, const int32_t* pair_id,
                                int64_t p, const int32_t* incl, int64_t cap,
                                int32_t* out, cudaStream_t stream) {
  if (p <= 0) return 0;
  const int threads = 256;
  materialize_fill_kernel<<<warp_blocks(p, threads), threads, 0, stream>>>(
      words, w, block_ids, index, pos_a, pos_b, pair_id, p, incl, cap, out);
  return (int)cudaGetLastError();
}
