// uint_intersect: |N(u_i) ∩ N(v_i)| of sorted neighbour sets of a CSR
// (paper Section 4.2, UINT ∩ UINT, the short similar-cardinality regime).
//
// Replaces the TPU kernel src/repro/kernels/uint_intersect/kernel.py
// (uint_intersect_kernel with _kernel), which compares -1-padded row tiles
// of both sets with a broadcast equality cube: the TPU has no cross-lane
// shuffle, and the host gathered and padded the rows first.
//
// What bounds it on the H100: dependent loads.  A pair costs |a| binary
// searches of log2|b| steps each into one sorted row, plus the reads of
// both rows; the engine routes here only pairs whose larger set has at
// most 256 elements.  Design: one warp per pair.  The warp reads the two
// CSR segments itself (no padded copies), takes the smaller set as a
// (min property), each lane searches its strided elements of a in b, and
// a shuffle reduction sums the hits.  The rows are sets (unique values),
// so the hit count is the intersection size.

#include <cuda_runtime.h>
#include <stdint.h>

__global__ void uint_intersect_kernel(const int32_t* __restrict__ offsets,
                                      const int32_t* __restrict__ nbr,
                                      const int32_t* __restrict__ u,
                                      const int32_t* __restrict__ v,
                                      int64_t p, int32_t* __restrict__ out) {
  int64_t warp = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  int lane = threadIdx.x & 31;
  if (warp >= p) return;  // uniform across the warp
  int32_t ui = __ldg(u + warp), vi = __ldg(v + warp);
  int32_t a0 = __ldg(offsets + ui), a1 = __ldg(offsets + ui + 1);
  int32_t b0 = __ldg(offsets + vi), b1 = __ldg(offsets + vi + 1);
  if (a1 - a0 > b1 - b0) {
    int32_t t0 = a0, t1 = a1;
    a0 = b0; a1 = b1; b0 = t0; b1 = t1;
  }
  int32_t hits = 0;
  for (int32_t i = a0 + lane; i < a1; i += 32) {
    int32_t x = __ldg(nbr + i);
    int32_t lo = b0, hi = b1;
    while (lo < hi) {
      int32_t mid = lo + ((hi - lo) >> 1);
      if (__ldg(nbr + mid) < x) lo = mid + 1; else hi = mid;
    }
    hits += (lo < b1 && __ldg(nbr + lo) == x) ? 1 : 0;
  }
  for (int o = 16; o > 0; o >>= 1)
    hits += __shfl_down_sync(0xffffffffu, hits, o);
  if (lane == 0) out[warp] = hits;
}

extern "C" int uint_intersect_count(const int32_t* offsets,
                                    const int32_t* nbr, const int32_t* u,
                                    const int32_t* v, int64_t p, int32_t* out,
                                    cudaStream_t stream) {
  if (p <= 0) return 0;
  const int threads = 256;  // 8 pairs a block
  const int64_t blocks = (p * 32 + threads - 1) / threads;
  uint_intersect_kernel<<<(unsigned int)blocks, threads, 0, stream>>>(
      offsets, nbr, u, v, p, out);
  return (int)cudaGetLastError();
}
