// triangle_mm: sum((A @ A) * A) over a dense 0/1 float32 adjacency, the
// engine's dense-cohort triangle count (exact, as a 64-bit integer).
//
// Replaces the TPU kernel src/repro/kernels/triangle_mm/kernel.py
// (triangle_mm_kernel with _kernel): a sequential (i, j, k) grid whose
// k steps accumulate the C_ij tile on the MXU in VMEM scratch, and whose
// last k step masks the tile by A_ij and adds it to one [1, 1] output
// that every grid step shares.  That computes all of C = A @ A, 2 n^3
// operations, and applies the mask only at the end.
//
// The count needs (A @ A)_ij only where A_ij != 0, and over a 0/1 matrix
// (A @ A)_ij is the popcount of (row i AND column j).  So the port packs
// A to bits and counts with AND and popcount, only where there is work:
//
//   1. Pack pass (triangle_pack_kernel).  A block reads a 256 x 256 patch
//      of A once, with 16-byte evict-first loads, and writes
//        rt[w][i]: bits 32w..32w+31 of row i      (word-major, n/32 x n)
//        ct[w][j]: bits 32w..32w+31 of column j   (word-major, n/32 x n)
//      and, for every 32 x 32 tile (I, J) of A, whether it holds a
//      nonzero: bit J of occ_r[I] and bit I of occ_c[J] (nt = n / 32
//      tiles a side, ow = ceil(nt / 32) words a bitmap row).  A lane
//      loads 8 rows of its 4 + 4 columns at a time and packs each 4 into
//      one word of 8 nibbles; three shuffles transpose those words
//      across 8 lanes into the rows' words, and shifts and masks pick
//      each column's 8 bits.  Every word and every bitmap byte is written
//      by exactly one block, so nothing needs clearing first (bytes past
//      the last tile are never written; the count pass masks them off).
//   2. Count pass (triangle_count_kernel).  A warp takes one tile (I, J)
//      and leaves at once unless bit J of occ_r[I] is set.  Lane i holds
//      the tile's mask row rt[J][32I + i].  The K with work are the set
//      bits of occ_r[I] AND occ_c[J]; for each, lane i loads rt[K][32I+i]
//      and ct[K][32J+i] (two coalesced 128-byte rows, eight K at a time
//      so that sixteen loads are in flight), then walks its mask bits j
//      in lockstep with the warp, adding popc(rt[K][i] & ct[K][j]) with
//      ct[K][j] fetched by a shuffle.  A lane's sum is at most 32 n, an
//      int32; warps and blocks reduce in int64 and each block adds its
//      sum with one 64-bit atomic.  Integer sums do not depend on order,
//      so two launches give the same count.
//
// What bounds it on the H100: bytes.  The inputs are the n^2 * 4 bytes
// of A, read once (the output is 8 bytes): 0.3205 ms at n = 16384 at
// 3.35 TB/s.  The operations the count needs are 2 n per nonzero of A,
// 0.0047 ms at the bf16 rate on the dense cell (141,110 nonzeros).  The
// pack pass moves those bytes plus n^2 / 4 bytes of bit planes written,
// so it should take about the bound; the count pass reads the bit planes
// only at the tile triples (I, K, J) whose three tiles are all occupied
// (0.89% of nt^3 on the cell, so a small share of the call), and on a
// dense matrix, where every triple holds work, it is bound by the popcount
// rate (16 a clock an SM): n^2/2 nonzeros x n/32 words at density 0.5.
//
// Scratch (the caller allocates it, kernels/triangle_mm/ops.scratch_bytes):
// rt and ct, n^2 / 8 bytes each, then occ_r and occ_c, nt * ow * 4
// bytes each: 67,174,400 bytes at n = 16384.  n must be a multiple of 128
// and A 16-byte aligned.  Entries other than 0 and 1 are outside the
// contract: the pack reads any entry != 0 as 1.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kPatch = 256;   // pack: a block's patch of A is kPatch^2
constexpr int kWarps = 8;     // both passes: 8 warps a block
constexpr int kBatch = 8;     // count: K words loaded together

__device__ __forceinline__ uint32_t nibble(float4 v) {
  return (uint32_t)(v.x != 0.f) | ((uint32_t)(v.y != 0.f) << 1) |
         ((uint32_t)(v.z != 0.f) << 2) | ((uint32_t)(v.w != 0.f) << 3);
}

// Bits c, c + 4, ..., c + 28 of x (column c of eight rows of nibbles) as
// bits 0..7.
__device__ __forceinline__ uint32_t column_of(uint32_t x, int c) {
  uint32_t v = (x >> c) & 0x11111111u;
  v = (v | (v >> 3)) & 0x03030303u;
  v = (v | (v >> 6)) & 0x000f000fu;
  return (v | (v >> 12)) & 0xffu;
}

// Lane 8g + p holds nibble r = columns 4p..4p+3 of row r; afterwards lane
// 8g + q holds row q, nibble p from lane 8g + p: its word of 32 columns.
// Three butterfly steps, each swapping half the nibbles with lane ^ d.
__device__ __forceinline__ uint32_t transpose_nibbles(uint32_t x, int lane) {
  const uint32_t keep[3] = {0x0f0f0f0fu, 0x00ff00ffu, 0x0000ffffu};
#pragma unroll
  for (int s = 0; s < 3; ++s) {
    const int d = 1 << s;
    const uint32_t t = __shfl_xor_sync(kFull, x, d);
    x = (lane & d) ? (x & ~keep[s]) | ((t >> (4 * d)) & keep[s])
                   : (x & keep[s]) | ((t << (4 * d)) & ~keep[s]);
  }
  return x;
}

// Block (bx, by) packs rows [256 by, +256) x columns [256 bx, +256);
// warp w its rows 32 w..32 w + 31, lane l columns 4l..4l+3 of each half
// (h = 0, 1: + 128 h).  n % 128 == 0, so a half or a warp lies wholly
// inside or wholly outside A.
__global__ void __launch_bounds__(kWarps * 32)
    triangle_pack_kernel(const float* __restrict__ a, int64_t n,
                         uint32_t* __restrict__ rt, uint32_t* __restrict__ ct,
                         uint8_t* __restrict__ occ_r,
                         uint8_t* __restrict__ occ_c, int64_t ow) {
  __shared__ uint8_t occ_of_warp[kWarps];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int64_t i0 = (int64_t)blockIdx.y * kPatch + 32 * w;
  const int64_t j0 = (int64_t)blockIdx.x * kPatch;
  const bool rows_in = i0 < n, half1_in = j0 + 128 < n;
  uint8_t occ = 0;
  if (rows_in) {
    uint32_t col_bits[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    uint32_t row_words[2][4];   // [half][row group]
    const float* base = a + i0 * n + j0 + 4 * lane;
#pragma unroll
    for (int r0 = 0; r0 < 32; r0 += 8) {
      float4 v[8][2];
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const float4* p = reinterpret_cast<const float4*>(base + (r0 + r) * n);
        v[r][0] = __ldcs(p);
        v[r][1] = half1_in ? __ldcs(p + 32) : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t x = 0;   // nibble r: row r0 + r, columns 4l..4l+3
#pragma unroll
        for (int r = 0; r < 8; ++r) x |= nibble(v[r][h]) << (4 * r);
#pragma unroll
        for (int c = 0; c < 4; ++c)
          col_bits[4 * h + c] |= column_of(x, c) << r0;
        // lane 8g + q keeps rows q, q + 8, q + 16, q + 24
        row_words[h][r0 / 8] = transpose_nibbles(x, lane);
      }
    }
    // rt[j0/32 + 4h + g][i0 + q + 8s] from lane 8g + q: 32-byte runs
    const int g = lane >> 3, q = lane & 7;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (h == 1 && !half1_in) break;
      uint32_t* dst = rt + (j0 / 32 + 4 * h + g) * n + i0 + q;
#pragma unroll
      for (int s = 0; s < 4; ++s) dst[8 * s] = row_words[h][s];
    }
    // ct[i0/32][j0 + 128h + 4l .. +3]: 512-byte runs
    uint32_t* cdst = ct + (i0 / 32) * n + j0 + 4 * lane;
    *reinterpret_cast<uint4*>(cdst) =
        make_uint4(col_bits[0], col_bits[1], col_bits[2], col_bits[3]);
    if (half1_in)
      *reinterpret_cast<uint4*>(cdst + 128) =
          make_uint4(col_bits[4], col_bits[5], col_bits[6], col_bits[7]);
    // tile J0 + 4h + g is occupied iff a lane of group g has a bit in h
    const unsigned b0 = __ballot_sync(
        kFull, (col_bits[0] | col_bits[1] | col_bits[2] | col_bits[3]) != 0);
    const unsigned b1 = __ballot_sync(
        kFull, (col_bits[4] | col_bits[5] | col_bits[6] | col_bits[7]) != 0);
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      occ |= (uint8_t)((((b0 >> (8 * t)) & 0xffu) != 0) << t);
      occ |= (uint8_t)((((b1 >> (8 * t)) & 0xffu) != 0) << (t + 4));
    }
    if (lane == 0) occ_r[(i0 / 32) * ow * 4 + blockIdx.x] = occ;
  }
  if (lane == 0) occ_of_warp[w] = occ;
  __syncthreads();
  // occ_c[J0 + t], byte blockIdx.y: bit w from warp w's bit t
  const int t = threadIdx.x;
  const int64_t nt = n / 32;
  if (t < 8 && (int64_t)blockIdx.x * 8 + t < nt) {
    uint8_t col = 0;
#pragma unroll
    for (int ww = 0; ww < kWarps; ++ww)
      col |= (uint8_t)(((occ_of_warp[ww] >> t) & 1u) << ww);
    occ_c[((int64_t)blockIdx.x * 8 + t) * ow * 4 + blockIdx.y] = col;
  }
}

// Block (bx, I): warp w takes the tile (I, J = 8 bx + w).
__global__ void __launch_bounds__(kWarps * 32)
    triangle_count_kernel(const uint32_t* __restrict__ rt,
                          const uint32_t* __restrict__ ct,
                          const uint32_t* __restrict__ occ_r,
                          const uint32_t* __restrict__ occ_c, int64_t n,
                          int64_t ow, unsigned long long* __restrict__ out) {
  __shared__ long long warp_sums[kWarps];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int64_t nt = n / 32;
  const int64_t I = blockIdx.y, J = (int64_t)blockIdx.x * kWarps + w;
  long long sum = 0;
  // warp-uniform: the warp stays converged for the shuffles below
  if (J < nt && ((__ldg(occ_r + I * ow + J / 32) >> (J % 32)) & 1u)) {
    const uint32_t mask = __ldg(rt + J * n + I * 32 + lane);
    const uint32_t* rrow = rt + I * 32 + lane;
    const uint32_t* crow = ct + J * 32 + lane;
    const int last_bits = (int)(nt - 32 * (ow - 1));
    const uint32_t last_mask = last_bits == 32 ? kFull : (1u << last_bits) - 1;
    int acc = 0;
    for (int64_t c0 = 0; c0 < ow; c0 += 32) {
      uint32_t cand = 0;
      if (c0 + lane < ow) {
        cand = __ldg(occ_r + I * ow + c0 + lane) &
               __ldg(occ_c + J * ow + c0 + lane);
        if (c0 + lane == ow - 1) cand &= last_mask;
      }
      unsigned vote = __ballot_sync(kFull, cand != 0);
      while (vote) {
        const int src = __ffs(vote) - 1;
        vote &= vote - 1;
        uint32_t bits = __shfl_sync(kFull, cand, src);
        const int64_t kbase = 32 * (c0 + src);
        while (bits) {
          uint32_t rw[kBatch], cw[kBatch];
#pragma unroll
          for (int u = 0; u < kBatch; ++u) {
            rw[u] = 0;
            cw[u] = 0;
            if (bits) {
              const int64_t k = kbase + __ffs(bits) - 1;
              bits &= bits - 1;
              rw[u] = __ldg(rrow + k * n);
              cw[u] = __ldg(crow + k * n);
            }
          }
          uint32_t m = mask;
          while (__any_sync(kFull, m != 0)) {
            const int j = (__ffs(m) - 1) & 31;
#pragma unroll
            for (int u = 0; u < kBatch; ++u) {
              const uint32_t cj = __shfl_sync(kFull, cw[u], j);
              if (m) acc += __popc(rw[u] & cj);
            }
            m &= m - 1;
          }
        }
      }
    }
    sum = acc;
  }
  for (int off = 16; off > 0; off >>= 1)
    sum += __shfl_down_sync(kFull, sum, off);
  if (lane == 0) warp_sums[w] = sum;
  __syncthreads();
  if (threadIdx.x == 0) {
    long long b = 0;
    for (int k = 0; k < kWarps; ++k) b += warp_sums[k];
    if (b != 0) atomicAdd(out, (unsigned long long)b);
  }
}

int64_t words_a_bitmap_row(int64_t n) { return (n / 32 + 31) / 32; }

int64_t scratch_needed(int64_t n) {
  return n * n / 4 + 2 * (n / 32) * words_a_bitmap_row(n) * 4;
}

}  // namespace

// passes: 1 the pack pass, 2 the count pass (over the bit planes a pack
// pass left in scratch), 3 both, as a count takes them; 1 and 2 alone let
// a caller time the passes apart.
extern "C" int triangle_mm(const float* a, int64_t n, void* scratch,
                           int64_t scratch_bytes, unsigned long long* out,
                           int passes, cudaStream_t stream) {
  if (n <= 0) return 0;
  if (n % 128 != 0 || scratch_bytes < scratch_needed(n) || passes < 1 ||
      passes > 3)
    return (int)cudaErrorInvalidValue;
  const int64_t nt = n / 32, ow = words_a_bitmap_row(n);
  uint32_t* rt = static_cast<uint32_t*>(scratch);
  uint32_t* ct = rt + n * n / 32;
  uint32_t* occ_r = ct + n * n / 32;
  uint32_t* occ_c = occ_r + nt * ow;
  if (passes & 1) {
    const unsigned patches = (unsigned)((n + kPatch - 1) / kPatch);
    triangle_pack_kernel<<<dim3(patches, patches), kWarps * 32, 0, stream>>>(
        a, n, rt, ct, reinterpret_cast<uint8_t*>(occ_r),
        reinterpret_cast<uint8_t*>(occ_c), ow);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (!(passes & 2)) return 0;
  const cudaError_t err =
      cudaMemsetAsync(out, 0, sizeof(unsigned long long), stream);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((nt + kWarps - 1) / kWarps), (unsigned)nt);
  triangle_count_kernel<<<grid, kWarps * 32, 0, stream>>>(
      rt, ct, occ_r, occ_c, n, ow, out);
  return (int)cudaGetLastError();
}
