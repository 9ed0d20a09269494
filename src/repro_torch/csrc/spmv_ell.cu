// spmv_ell: y[i] = sum over the slots s in [row_ptr[i] * W, row_ptr[i+1] * W)
//           of vals.flat[s] * x[cols.flat[s]]    (float32, int32 columns)
//
// Replaces the TPU kernel src/repro/kernels/spmv_ell/kernel.py:38
// spmv_ell_kernel (_kernel :29): PageRank's SpMV over CSR rows packed into
// ELL, a grid over row tiles whose x gather is a VMEM take of the whole
// vector.  The port reads any packing as one flat run of slots, R * W of
// them, vertex i owning rows row_ptr[i]..row_ptr[i+1]: the reference's one
// row per vertex (W = the largest degree), a split fixed width, or width
// 1, which is the CSR itself (cols = neighbors, row_ptr = offsets) and
// what recursion.pagerank packs.  Padding slots (column 0, weight 0) add
// 0 * x[0], as in the plain version.
//
// What bounds it on the H100: bytes.  Each of the graph's entries is 8
// bytes of cols + vals read once; beside them row_ptr, x and y once each:
// 8 * entries + 4 * (n + 1) + 4 * |x| + 4 * n over 3.35 TB/s.  The x
// gather is a random 4-byte read an entry, cheap only while x stays in L2
// (and its hot head in L1) as the entries stream past.
//
// Design: merge-path balancing (Merrill & Garland, SC'16).  The work is
// the merge of the n row ends with the S = R * W slots, n + S items; block
// b takes items [b * kTile, (b + 1) * kTile), so a hub row spans many
// blocks, a run of short or empty rows shares one, and the grid follows
// from the shapes alone (no host read, no plan made ahead).
//   1. Two warps find the block's start and end on the merge path, each
//      by a 32-way search of row_ptr (int64), about five dependent loads
//      for millions of rows.
//   2. The block streams its slots [y0, y1) once, coalesced, with
//      evict-first loads (__ldcs) so that the entries passing through do
//      not push x out of L2; it gathers x through the read-only path
//      (__ldg) and keeps the products and its rows' ends in shared memory,
//      one array of kTile words for both.  The gather is what costs: a
//      miss in L1 goes to L2 for 4 bytes, so the kernel asks for little
//      shared memory and leaves most of the SM's 256 KB to L1.
//   3. Each thread walks kItems items of the merge in shared memory: a
//      slot adds to the open row, a row end writes it.  A thread's first
//      row may have begun in earlier threads: a block-wide segmented scan
//      by row over the threads' carries completes it.
//   4. The row still open at the block's end leaves a (row, partial)
//      carry in scratch; a second, small kernel adds to y[r], for each row
//      r that a block completed, the carries of the blocks before it for
//      r (a warp a block, in a fixed order).
// No atomics: every sum is taken in an order fixed by the shapes, so two
// launches on the same inputs give the same bits.  The order differs from
// a sequential sum, so the plain version agrees within float32 rounding,
// not bit for bit.  All slot offsets are int64.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
// Items of the merge a thread walks.  Odd, so that on a run of slots the
// lanes of a warp read shared memory at an odd stride, free of bank
// conflicts.
constexpr int kItems = 7;
constexpr int kTile = kThreads * kItems;
constexpr unsigned kFull = 0xffffffffu;
// Shared memory the kernel asks for, in percent of the most an SM has:
// room for three blocks, and the rest of the SM's 256 KB left to L1, which
// holds the hot head of x (on the power-law graphs here the hubs have low
// ids, so most gathers fall in the first entries of x).
constexpr int kSharedCarveoutPercent = 25;

// The merge-path coordinate on diagonal d: the least x in [lo, hi] with
// row_ptr[x + 1] * width + x >= d, or hi (the row ends consumed; d - x is
// the slots consumed).  The whole warp searches, 32 probes a step.
__device__ __forceinline__ int64_t warp_path_search(
    const int32_t* __restrict__ row_ptr, int64_t width, int64_t d,
    int64_t lo, int64_t hi) {
  const int lane = threadIdx.x & 31;
  while (lo < hi) {  // lo and hi are the same in every lane
    const int64_t p = lo + (hi - lo) * (lane + 1) / 33;  // in [lo, hi)
    const bool right = (int64_t)__ldg(row_ptr + p + 1) * width + p >= d;
    const unsigned m = __ballot_sync(kFull, right);
    const int k = m ? __ffs(m) - 1 : 32;  // first probe on the right
    const int64_t at = __shfl_sync(kFull, p, k & 31);
    const int64_t before = __shfl_sync(kFull, p, (k + 31) & 31);
    hi = k < 32 ? at : hi;
    lo = k > 0 ? before + 1 : lo;
  }
  return lo;
}

__global__ void __launch_bounds__(kThreads)
    spmv_merge_kernel(const int32_t* __restrict__ cols,
                      const float* __restrict__ vals,
                      const int32_t* __restrict__ row_ptr,
                      const float* __restrict__ x, int64_t n, int64_t slots,
                      int64_t width, float* __restrict__ y,
                      int64_t* __restrict__ carry_row,
                      float* __restrict__ carry_val) {
  // the block's nnz products vals[s] * x[cols[s]] (at s - y0), then its
  // rows' ends (the end slot of row x0 + r, less y0): rows + nnz <= kTile
  __shared__ float s_items[kTile];
  __shared__ int64_t s_path[2];
  __shared__ int32_t s_wkey[kWarps];
  __shared__ float s_wval[kWarps];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t total = n + slots;
  const int64_t d0 = (int64_t)blockIdx.x * kTile;
  const int64_t d1 = d0 + kTile < total ? d0 + kTile : total;

  // 1. the block's start (x0, y0) and end (x1, y1) on the merge path
  if (warp < 2) {
    const int64_t d = warp == 0 ? d0 : d1;
    const int64_t lo = d > slots ? d - slots : 0;
    const int64_t p = warp_path_search(row_ptr, width, d, lo, d < n ? d : n);
    if (lane == 0) s_path[warp] = p;
  }
  __syncthreads();
  const int64_t x0 = s_path[0], x1 = s_path[1];
  const int64_t y0 = d0 - x0;
  const int rows = (int)(x1 - x0);
  const int nnz = (int)(d1 - x1 - y0);
  float* s_prod = s_items;
  int32_t* s_end = reinterpret_cast<int32_t*>(s_items + nnz);

  // 2. the block's rows' ends, and its slots' products
  for (int r = tid; r < rows; r += kThreads)
    s_end[r] = (int32_t)((int64_t)__ldg(row_ptr + x0 + r + 1) * width - y0);
  int32_t c[kItems];
  float v[kItems], g[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int i = k * kThreads + tid;
    c[k] = i < nnz ? __ldcs(cols + y0 + i) : 0;
    v[k] = i < nnz ? __ldcs(vals + y0 + i) : 0.0f;
  }
#pragma unroll
  for (int k = 0; k < kItems; ++k)
    g[k] = k * kThreads + tid < nnz ? __ldg(x + c[k]) : 0.0f;
#pragma unroll
  for (int k = 0; k < kItems; ++k)
    if (k * kThreads + tid < nnz) s_prod[k * kThreads + tid] = v[k] * g[k];
  __syncthreads();

  // 3. this thread's items: its start on the merge path inside the tile
  const int items = rows + nnz;
  const int dt = tid * kItems < items ? tid * kItems : items;
  const int de = dt + kItems < items ? dt + kItems : items;
  int lo = dt > nnz ? dt - nnz : 0, hi = dt < rows ? dt : rows;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (s_end[mid] + mid >= dt) hi = mid; else lo = mid + 1;
  }
  int xr = lo, ys = dt - lo;
  float acc = 0.0f, first = 0.0f;
  int first_row = -1;  // the first row this thread ends, if any
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    if (dt + k < de) {
      if (xr < rows && s_end[xr] <= ys) {  // row x0 + xr ends here
        if (first_row < 0) {
          first_row = xr;
          first = acc;
        } else {
          y[x0 + xr] = acc;
        }
        acc = 0.0f;
        ++xr;
      } else {
        acc += s_prod[ys];
        ++ys;
      }
    }
  }

  // the threads' carries (row xr, acc): a segmented inclusive scan by row,
  // in the warp, then across the warps in order
  float inc = acc;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int k2 = __shfl_up_sync(kFull, xr, o);
    const float v2 = __shfl_up_sync(kFull, inc, o);
    if (lane >= o && k2 == xr) inc = v2 + inc;
  }
  if (lane == 31) {
    s_wkey[warp] = xr;
    s_wval[warp] = inc;
  }
  int ek = __shfl_up_sync(kFull, xr, 1);
  float ev = __shfl_up_sync(kFull, inc, 1);
  __syncthreads();
  // the carry of the warps before this one
  int pk = -1;
  float pv = 0.0f;
  for (int w = 0; w < warp; ++w) {
    pv = pk == s_wkey[w] ? pv + s_wval[w] : s_wval[w];
    pk = s_wkey[w];
  }
  if (lane == 0) {
    ek = pk;
    ev = pv;
  } else if (pk == ek) {
    ev = pv + ev;
  }
  // ek / ev: the carry into this thread (ek < 0: none)
  if (first_row >= 0) y[x0 + first_row] = ek == first_row ? ev + first : first;
  if (tid == kThreads - 1) {
    carry_row[blockIdx.x] = x1;
    carry_val[blockIdx.x] = pk == xr ? pv + inc : inc;
  }
}

// 4. a warp for each block b: if b completed row r = x0(b), y[r] += the
// carries of the blocks before b for row r (a hub's run spans many), the
// lanes striding over the run and a fixed butterfly summing their parts.
__global__ void spmv_carry_kernel(const int64_t* __restrict__ carry_row,
                                  const float* __restrict__ carry_val,
                                  int64_t blocks, int64_t n,
                                  float* __restrict__ y) {
  const int64_t b = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) / 32 + 1;
  const int lane = threadIdx.x & 31;
  if (b >= blocks) return;  // uniform across the warp
  const int64_t r = carry_row[b - 1];       // x1 of block b - 1 = x0 of b
  if (r >= n || carry_row[b] == r) return;  // block b completed no row
  float sum = 0.0f;
  for (int64_t top = b - 1;; top -= 32) {   // carries top, top - 1, ...
    const int64_t k = top - lane;
    const bool in_run = k >= 0 && carry_row[k] == r;
    if (in_run) sum += carry_val[k];
    if (__ballot_sync(kFull, in_run) != kFull) break;
  }
  for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(kFull, sum, o);
  if (lane == 0) y[r] += sum;
}

}  // namespace

// Merge items (row ends and slots) a block takes.
extern "C" int64_t spmv_ell_tile_items() { return kTile; }

// cols, vals: [rows, width] (slots = rows * width); row_ptr: [n + 1];
// x: [|x|]; carry_row, carry_val: [ceil((n + slots) / kTile)] scratch;
// y: [n].  n > 0 and slots > 0.  Returns the first launch error, or 0.
extern "C" int spmv_ell(const int32_t* cols, const float* vals,
                        const int32_t* row_ptr, const float* x, int64_t n,
                        int64_t slots, int64_t width, int64_t* carry_row,
                        float* carry_val, float* y, cudaStream_t stream) {
  const int64_t blocks = (n + slots + kTile - 1) / kTile;
  cudaError_t err = cudaFuncSetAttribute(
      spmv_merge_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
      kSharedCarveoutPercent);
  if (err != cudaSuccess) return (int)err;
  spmv_merge_kernel<<<(unsigned int)blocks, kThreads, 0, stream>>>(
      cols, vals, row_ptr, x, n, slots, width, y, carry_row, carry_val);
  err = cudaGetLastError();
  if (err != cudaSuccess || blocks < 2) return (int)err;
  const int threads = 256;  // 8 warps, one for each block b >= 1
  spmv_carry_kernel<<<(unsigned int)((blocks - 1 + 7) / 8), threads, 0,
                      stream>>>(carry_row, carry_val, blocks, n, y);
  return (int)cudaGetLastError();
}
