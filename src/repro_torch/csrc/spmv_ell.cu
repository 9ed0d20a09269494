// spmv_ell: y[i] = sum over the ELL rows r of vertex i of
//           sum_k vals[r,k] * x[cols[r,k]]      (float32, int32 columns)
//
// Replaces the TPU kernel src/repro/kernels/spmv_ell/kernel.py
// (spmv_ell_kernel with _kernel): PageRank's SpMV over CSR rows packed
// into ELL, a grid over row tiles whose x gather is a VMEM take of the
// whole vector.  The TPU packing sets the ELL width to the largest degree;
// on a power-law graph that is tens of thousands of slots for every row,
// more than the card holds.  The port packs at a fixed width instead
// (kernels/spmv_ell/ops.py: csr_to_ell_split, width 32) and splits a
// longer row over consecutive ELL rows; row_ptr[i]..row_ptr[i+1] are the
// ELL rows of vertex i (none for an isolated vertex).
//
// What bounds it on the H100: bytes.  Each slot is 8 bytes of cols+vals
// read once, plus the x gather (random 4-byte reads, mostly from L2) and
// row_ptr and y; no arithmetic to speak of.  Bytes bound: 8 * slots +
// 4 * (2n + 1) + 4 * |x| over 3.35 TB/s.
//
// Design, simple first:
//   pass 1, a warp per ELL row: lane k loads slot k (one coalesced
//     128-byte load each of cols and vals at width 32), gathers x[col],
//     multiplies, and a __shfl_xor_sync butterfly sums the row into
//     partial[r];
//   pass 2, a warp per vertex: the lanes stride over the vertex's
//     partial sums in order and a second butterfly writes y[i].
// No atomics: every sum is taken in a fixed order, so two launches on the
// same inputs give the same bits.  The order differs from a sequential
// sum, so the plain version agrees within float32 rounding, not bit for
// bit.

#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void spmv_ell_rows_kernel(const int32_t* __restrict__ cols,
                                     const float* __restrict__ vals,
                                     const float* __restrict__ x,
                                     int64_t rows, int32_t width,
                                     float* __restrict__ partial) {
  int64_t r = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  int lane = threadIdx.x & 31;
  if (r >= rows) return;  // uniform across the warp
  const int64_t base = r * width;
  float acc = 0.0f;
  for (int32_t k = lane; k < width; k += 32)
    acc += __ldg(vals + base + k) * __ldg(x + __ldg(cols + base + k));
  acc = warp_sum(acc);
  if (lane == 0) partial[r] = acc;
}

__global__ void spmv_ell_segments_kernel(const int32_t* __restrict__ row_ptr,
                                         const float* __restrict__ partial,
                                         int64_t n, float* __restrict__ y) {
  int64_t i = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  int lane = threadIdx.x & 31;
  if (i >= n) return;  // uniform across the warp
  const int32_t a = __ldg(row_ptr + i), b = __ldg(row_ptr + i + 1);
  float acc = 0.0f;
  for (int32_t r = a + lane; r < b; r += 32) acc += __ldg(partial + r);
  acc = warp_sum(acc);
  if (lane == 0) y[i] = acc;
}

// cols, vals: [rows, width]; row_ptr: [n + 1]; x: [|x|]; partial: [rows]
// scratch; y: [n].  Returns the first launch error, or 0.
extern "C" int spmv_ell(const int32_t* cols, const float* vals,
                        const int32_t* row_ptr, const float* x, int64_t rows,
                        int32_t width, int64_t n, float* partial, float* y,
                        cudaStream_t stream) {
  const int threads = 256;  // 8 warps a block
  if (rows > 0) {
    const int64_t blocks = (rows * 32 + threads - 1) / threads;
    spmv_ell_rows_kernel<<<(unsigned int)blocks, threads, 0, stream>>>(
        cols, vals, x, rows, width, partial);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (n > 0) {
    const int64_t blocks = (n * 32 + threads - 1) / threads;
    spmv_ell_segments_kernel<<<(unsigned int)blocks, threads, 0, stream>>>(
        row_ptr, partial, n, y);
  }
  return (int)cudaGetLastError();
}
