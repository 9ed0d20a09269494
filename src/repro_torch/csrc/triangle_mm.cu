// triangle_mm: sum((A @ A) * A) over a dense 0/1 float32 adjacency, the
// engine's dense-cohort triangle count (exact, as a 64-bit integer).
//
// Replaces the TPU kernel src/repro/kernels/triangle_mm/kernel.py
// (triangle_mm_kernel with _kernel): a sequential (i, j, k) grid whose
// k steps accumulate the C_ij tile on the MXU in VMEM scratch, and whose
// last k step masks the tile by A_ij and adds it to one [1, 1] output
// that every grid step shares.  Hopper runs the blocks in parallel and in
// no order, so the k loop is inside the block, and the blocks' partial
// sums meet in one 64-bit integer atomic.
//
// Design: a classic register-tiled float32 product.  A block computes a
// 128 x 128 tile of C = A @ A over k in steps of 8 (both operand tiles
// staged in shared memory, A's transposed), each of its 256 threads an
// 8 x 8 sub-tile in registers; then the epilogue reads the same 8 x 8
// patch of A, sums the masked entries in 64-bit integers, and the block
// reduces by warp shuffles and shared memory to one atomicAdd.  Entries
// of C are integers of at most n, exact in float32 below 2^24, and
// integer sums are order-free, so the count is exact and the same from
// launch to launch.
//
// What bounds it on the H100: operations.  2 n^3 multiply-adds against
// n^2 * 4 bytes read; at n = 16384 that is 8.8e12 operations.  The floor
// is the bf16 tensor-core rate (0/1 is exact there), 989 TFLOP/s; this
// kernel uses the float32 cores (67 TFLOP/s peak), which is its first
// limit.  n must be a multiple of 128 (the entry pads to 256).

#include <cuda_runtime.h>
#include <stdint.h>

#define BM 128
#define BN 128
#define BK 8
#define TM 8
#define TN 8

__global__ void __launch_bounds__(256)
    triangle_mm_kernel(const float* __restrict__ a, int64_t n,
                       unsigned long long* __restrict__ out) {
  __shared__ float a_tile[BK][BM];  // A[i0 + r, k0 + c] at a_tile[c][r]
  __shared__ __align__(16) float b_tile[BK][BN];  // A[k0 + r, j0 + c]: b_tile[r][c]
  __shared__ long long warp_sums[8];
  const int tid = threadIdx.x;
  const int64_t i0 = (int64_t)blockIdx.y * BM, j0 = (int64_t)blockIdx.x * BN;
  const int tr = tid >> 4, tc = tid & 15;  // 16 x 16 threads, 8 x 8 each
  const int a_r = tid >> 1, a_c = (tid & 1) * 4;
  const int b_r = tid >> 5, b_c = (tid & 31) * 4;
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int64_t k0 = 0; k0 < n; k0 += BK) {
    const float4 va = __ldg(reinterpret_cast<const float4*>(
        a + (i0 + a_r) * n + k0 + a_c));
    a_tile[a_c + 0][a_r] = va.x;
    a_tile[a_c + 1][a_r] = va.y;
    a_tile[a_c + 2][a_r] = va.z;
    a_tile[a_c + 3][a_r] = va.w;
    *reinterpret_cast<float4*>(&b_tile[b_r][b_c]) = __ldg(
        reinterpret_cast<const float4*>(a + (k0 + b_r) * n + j0 + b_c));
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float ra[TM], rb[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) ra[i] = a_tile[kk][tr * TM + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) rb[j] = b_tile[kk][tc * TN + j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(ra[i], rb[j], acc[i][j]);
    }
    __syncthreads();
  }

  long long s = 0;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const float* mrow = a + (i0 + tr * TM + i) * n + j0 + tc * TN;
#pragma unroll
    for (int j = 0; j < TN; ++j)
      if (__ldg(mrow + j) != 0.f) s += (long long)acc[i][j];
  }
  for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
  if ((tid & 31) == 0) warp_sums[tid >> 5] = s;
  __syncthreads();
  if (tid == 0) {
    long long b = 0;
    for (int k = 0; k < 8; ++k) b += warp_sums[k];
    if (b != 0) atomicAdd(out, (unsigned long long)b);
  }
}

extern "C" int triangle_mm(const float* a, int64_t n, unsigned long long* out,
                           cudaStream_t stream) {
  if (n <= 0) return 0;
  if (n % BM != 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaMemsetAsync(out, 0, sizeof(unsigned long long), stream);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned int)(n / BN), (unsigned int)(n / BM));
  triangle_mm_kernel<<<grid, 256, 0, stream>>>(a, n, out);
  return (int)cudaGetLastError();
}
