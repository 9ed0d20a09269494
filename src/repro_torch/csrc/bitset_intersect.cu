// bitset_intersect: AND + popcount of matched bitset blocks
// (paper Section 4.2, BITSET ∩ BITSET).
//
// Replaces the TPU kernel src/repro/kernels/bitset_intersect/kernel.py
// (bitset_and_popcount_kernel with _kernel and _popcount_u32), which takes
// the matched block rows as padded copies gathered by ops.py and ANDs them
// tile by tile on the vector unit with a bit-twiddled popcount.
//
// out[i] = sum_k popc(words[pos_a[i]][k] & words[pos_b[i]][k]) over the W
// words of a block (W = 8 for the 256-bit blocks of the layout store).
//
// What bounds it on the H100: bytes.  Per pair it reads two 4-byte indices
// and two W-word rows and writes one int; the AND and __popc are a few
// instructions per word.  Design: one thread per pair gathers its two rows
// straight from the block table (no padded copies in device memory); a
// 256-bit row is one 32-byte sector, read as two 16-byte vector loads
// when W is a multiple of 4 and the table is 16-byte aligned.

#include <cuda_runtime.h>
#include <stdint.h>

__global__ void bitset_and_popcount_kernel(
    const uint32_t* __restrict__ words, int32_t w,
    const int32_t* __restrict__ pos_a, const int32_t* __restrict__ pos_b,
    int64_t p, int32_t* __restrict__ out) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p) return;
  const uint32_t* ra = words + (int64_t)__ldg(pos_a + i) * w;
  const uint32_t* rb = words + (int64_t)__ldg(pos_b + i) * w;
  int32_t acc = 0;
  if ((w & 3) == 0 && (((uintptr_t)words) & 15) == 0) {
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
  out[i] = acc;
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
