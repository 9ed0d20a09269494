// fm_interaction: out[b] = 0.5 * sum_d((sum_f e[b,f,d])^2 - sum_f e[b,f,d]^2)
//                 for e [B, F, D] float32, contiguous  ->  out [B] float32
//
// Replaces the TPU kernel src/repro/kernels/fm_interaction/kernel.py
// (fm_interaction_kernel with _kernel): the Factorization Machine's
// second-order term by the sum-square trick, one VMEM pass over a
// (128, F, D) tile per grid step, its ops.py padding B to a multiple of
// 128.  Here B is taken as it is and the ragged edge is masked.
//
// What bounds it on the H100: bytes.  Every element is read once and used
// for three float operations (a sum, a square and its sum), about 0.75
// operations a byte, far under the float32 rate's 20 operations a byte of
// device memory.  Bytes bound: B*F*D*4 + B*4 over 3.35 TB/s (0.122 ms for
// the serve_bulk gather, B = 262,144, F = 39, D = 10).
//
// Design, simple first: a row's D columns go to a group of G = min(D, 32)
// lanes, so a warp takes R = max(1, 32 / D) rows at once (3 rows on 30
// lanes at D = 10).  Lane c of a group walks f = 0..F-1 over column c (and
// c + 32, c + 64, ... when D > 32), keeping s_d and sq_d in registers; at
// each f the group reads the D contiguous floats of e[b, f, :], and over
// the loop the warp reads its R rows once, from L1 where a 32-byte sector
// spans two fields.  A segmented __shfl_down_sync reduction then sums
// s_d^2 - sq_d over the group's lanes into the group's first lane, which
// writes the row.  Everything accumulates in float32 in a fixed order that
// does not depend on where the row sits in the batch, so a row gives the
// same bits in any batch.  The plain version sums in another order, so the
// two agree within float32 rounding of the terms the form cancels.  Later
// work: 16-byte loads, rows per warp tuned for D = 10.

#include <cuda_runtime.h>
#include <stdint.h>

__global__ void fm_interaction_kernel(const float* __restrict__ emb,
                                      int64_t b, int64_t f, int64_t d,
                                      int group, int rows_per_warp,
                                      float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int64_t warp = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int r = lane / group, c = lane - r * group;
  const int64_t row = warp * rows_per_warp + r;
  const bool live = r < rows_per_warp && row < b;
  float acc = 0.0f;
  if (live) {
    const float* e = emb + row * f * d;
    for (int64_t col = c; col < d; col += group) {
      float s = 0.0f, sq = 0.0f;
#pragma unroll 4
      for (int64_t k = 0; k < f; ++k) {
        const float v = __ldg(e + k * d + col);
        s += v;
        sq += v * v;
      }
      acc += s * s - sq;
    }
  }
  // lane r * group ends with the sum over its group's lanes: every value
  // it takes comes from a lane of the same group (lane + o < end)
  const int end = (r + 1) * group;
  for (int o = 16; o > 0; o >>= 1) {
    const float other = __shfl_down_sync(0xffffffffu, acc, o);
    if (lane + o < end) acc += other;
  }
  if (live && c == 0) out[row] = 0.5f * acc;
}

// emb: [b, f, d] contiguous float32; out: [b].  b, f, d >= 1.  Returns the
// launch error, or 0.
extern "C" int fm_interaction(const float* emb, int64_t b, int64_t f,
                              int64_t d, float* out, cudaStream_t stream) {
  const int threads = 256;  // 8 warps a block
  const int group = d < 32 ? (int)d : 32;
  const int rows_per_warp = 32 / group;
  const int64_t warps = (b + rows_per_warp - 1) / rows_per_warp;
  const int64_t blocks = (warps * 32 + threads - 1) / threads;
  fm_interaction_kernel<<<(unsigned int)blocks, threads, 0, stream>>>(
      emb, b, f, d, group, rows_per_warp, out);
  return (int)cudaGetLastError();
}
