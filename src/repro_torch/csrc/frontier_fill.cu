// frontier_fill: the fill stage of the zero-sync count-then-fill extension.
//
// Replaces the TPU kernel src/repro/kernels/frontier_fill/kernel.py
// (make_fill_kernel, launched from ops.py::fill_chunk), which fills one
// morsel chunk per launch from inside the bag program's while-loop.
//
// For every output slot j in [start, start + n):
//   1. upper-bound search of j in the exclusive-scan offsets gives the
//      source frontier row;
//   2. p0 = lo0[row] + (j - offs[row]) and the seed value seed[p0];
//   3. per probe atom, a lower-bound search of the value in the row's
//      candidate segment [lo_k[row], hi_k[row]); membership is AND-ed
//      into keep and the position is written out.
// Slots at or past *total_c (read from device memory, so the host never
// learns the frontier size) are masked: keep = 0 and every other output 0.
// The searches are the reference's lockstep lower/upper-bound loops with
// the same clip rules; a loop that stops once lo == hi returns what the
// fixed 34-step loop returns, so positions and membership are bit-exact.
//
// The same source holds frontier_fold, the device terminal fold's
// expansion.  The reference folds inside the bag program with a
// data-dependent jnp while-loop over fill chunks (src/repro/core/
// backend.py:1091, _fold_body); eagerly on the card that loop would need
// the expansion total on the host, so the fold is one kernel instead:
// one warp per frontier row walks the row's (clipped) seed segment, runs
// the same lockstep probe searches, multiplies the leaf annotations in
// and reduces the kept contributions with the semiring's add (lane-strided,
// then a fixed shuffle tree: deterministic), writing folded[row] and the
// support count.  No slot is materialized, so no size is needed at all.
//
// What bounds it on the H100: dependent loads.  Each slot does
// log2(cap_in) + sum_k log2(segment_k) scattered 4-byte reads; there is
// no arithmetic to speak of.  Design: one thread per slot, 256 threads a
// block, read-only loads through the texture path (__ldg), so neighbouring
// slots of one row share the cached top levels of each search.  No shared
// memory: segments are per row and of unbounded length.

#include <cuda_runtime.h>
#include <stdint.h>

#define FF_MAX_PROBES 8

struct FillProbe {
  const int32_t* vals;  // probe level values [n]
  const int32_t* lo;    // per-row candidate segment start [cap_in]
  const int32_t* hi;    // per-row candidate segment end [cap_in]
  int32_t n;
};

struct FillProbes {
  FillProbe p[FF_MAX_PROBES];
  int32_t count;
};

__device__ __forceinline__ int32_t clamp_i32(int32_t x, int32_t lo,
                                             int32_t hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

__global__ void frontier_fill_kernel(
    const int32_t* __restrict__ total_c, const int32_t* __restrict__ offs,
    const int32_t* __restrict__ lo0, int32_t cap_in,
    const int32_t* __restrict__ seed, int32_t n0, FillProbes probes,
    int64_t start, int64_t n, int32_t* __restrict__ vals_o,
    int32_t* __restrict__ row_o, int32_t* __restrict__ p0_o,
    bool* __restrict__ keep_o, int32_t* __restrict__ pos_o) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int64_t jj = start + i;
  if (jj >= (int64_t)__ldg(total_c)) {
    vals_o[i] = 0;
    row_o[i] = 0;
    p0_o[i] = 0;
    keep_o[i] = false;
    for (int k = 0; k < probes.count; ++k) pos_o[(int64_t)k * n + i] = 0;
    return;
  }
  int32_t j = (int32_t)jj;

  // upper bound of j over offs[0, cap_in)
  int32_t lo = 0, hi = cap_in;
  while (lo < hi) {
    int32_t mid = lo + ((hi - lo) >> 1);
    if (__ldg(offs + mid) <= j) lo = mid + 1; else hi = mid;
  }
  int32_t row = clamp_i32(lo - 1, 0, cap_in - 1);
  int32_t p0 = __ldg(lo0 + row) + (j - __ldg(offs + row));
  int32_t v = __ldg(seed + clamp_i32(p0, 0, n0 > 0 ? n0 - 1 : 0));
  bool keep = true;

  for (int k = 0; k < probes.count; ++k) {
    const FillProbe pr = probes.p[k];
    int32_t plo = __ldg(pr.lo + row);
    int32_t phi = __ldg(pr.hi + row);
    int32_t end = phi;
    while (plo < phi) {
      int32_t mid = plo + ((phi - plo) >> 1);
      if (__ldg(pr.vals + clamp_i32(mid, 0, pr.n - 1)) < v) plo = mid + 1;
      else phi = mid;
    }
    bool found = pr.n > 0 && plo < end &&
                 __ldg(pr.vals + clamp_i32(plo, 0, pr.n - 1)) == v;
    pos_o[(int64_t)k * n + i] = plo;
    keep = keep && found;
  }
  vals_o[i] = v;
  row_o[i] = row;
  p0_o[i] = p0;
  keep_o[i] = keep;
}

// ------------------------------------------------------------- the fold
struct FoldAnns {
  const void* p[FF_MAX_PROBES + 1];  // [0]: seed atom, [k + 1]: probe k
  int32_t n[FF_MAX_PROBES + 1];
};

// Semiring ops by code: 0 (+, *) count/sum, 1 (min, +) min_plus,
// 2 (max, min) max_min, 3 (or, and) boolean.
template <typename T>
__device__ __forceinline__ T sr_add(int op, T a, T b) {
  switch (op) {
    case 0: return a + b;
    case 1: return b < a ? b : a;
    case 2: return b > a ? b : a;
    default: return (T)(a || b);
  }
}

template <typename T>
__device__ __forceinline__ T sr_mul(int op, T a, T b) {
  switch (op) {
    case 0: return a * b;
    case 1: return a + b;
    case 2: return b < a ? b : a;
    default: return (T)(a && b);
  }
}

template <typename T>
__device__ __forceinline__ T shfl_down(T v, int o) {
  return __shfl_down_sync(0xffffffffu, v, o);
}

template <>
__device__ __forceinline__ uint8_t shfl_down<uint8_t>(uint8_t v, int o) {
  return (uint8_t)__shfl_down_sync(0xffffffffu, (int)v, o);
}

template <typename T>
__global__ void frontier_fold_kernel(
    const int32_t* __restrict__ lo0, const int32_t* __restrict__ cnt,
    int32_t cap_in, const int32_t* __restrict__ seed, int32_t n0,
    FillProbes probes, FoldAnns anns, int op, T zero, T one,
    T* __restrict__ folded, int32_t* __restrict__ supp) {
  int64_t warp = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  int lane = threadIdx.x & 31;
  if (warp >= cap_in) return;  // uniform across the warp
  int32_t row = (int32_t)warp;
  int32_t base = __ldg(lo0 + row);
  int32_t c = __ldg(cnt + row);
  T acc = zero;
  int32_t hits = 0;
  for (int32_t i = lane; i < c; i += 32) {
    int32_t p0 = base + i;
    int32_t v = __ldg(seed + clamp_i32(p0, 0, n0 > 0 ? n0 - 1 : 0));
    bool keep = true;
    T contrib = one;
    if (anns.p[0] != nullptr) {
      const T* a = static_cast<const T*>(anns.p[0]);
      contrib = sr_mul(op, contrib, a[clamp_i32(p0, 0, anns.n[0] - 1)]);
    }
    for (int k = 0; k < probes.count; ++k) {
      const FillProbe pr = probes.p[k];
      int32_t plo = __ldg(pr.lo + row);
      int32_t phi = __ldg(pr.hi + row);
      int32_t end = phi;
      while (plo < phi) {
        int32_t mid = plo + ((phi - plo) >> 1);
        if (__ldg(pr.vals + clamp_i32(mid, 0, pr.n - 1)) < v) plo = mid + 1;
        else phi = mid;
      }
      keep = keep && pr.n > 0 && plo < end &&
             __ldg(pr.vals + clamp_i32(plo, 0, pr.n - 1)) == v;
      if (anns.p[k + 1] != nullptr) {
        const T* a = static_cast<const T*>(anns.p[k + 1]);
        contrib = sr_mul(op, contrib,
                         a[clamp_i32(plo, 0, anns.n[k + 1] - 1)]);
      }
    }
    if (keep) {
      acc = sr_add(op, acc, contrib);
      hits += 1;
    }
  }
  for (int o = 16; o > 0; o >>= 1) {
    acc = sr_add(op, acc, shfl_down(acc, o));
    hits += __shfl_down_sync(0xffffffffu, hits, o);
  }
  if (lane == 0) {
    folded[row] = acc;
    supp[row] = hits;
  }
}

template <typename T>
static int launch_fold(const int32_t* lo0, const int32_t* cnt, int32_t cap_in,
                       const int32_t* seed, int32_t n0,
                       const FillProbes* probes, const FoldAnns* anns,
                       int32_t op, T zero, T one, T* folded, int32_t* supp,
                       cudaStream_t stream) {
  if (cap_in <= 0) return 0;
  if (probes->count < 0 || probes->count > FF_MAX_PROBES || op < 0 || op > 3)
    return (int)cudaErrorInvalidValue;
  const int threads = 256;  // 8 rows a block
  const int64_t blocks = ((int64_t)cap_in * 32 + threads - 1) / threads;
  frontier_fold_kernel<T><<<(unsigned int)blocks, threads, 0, stream>>>(
      lo0, cnt, cap_in, seed, n0, *probes, *anns, op, zero, one, folded,
      supp);
  return (int)cudaGetLastError();
}

extern "C" int frontier_fold_i32(const int32_t* lo0, const int32_t* cnt,
                                 int32_t cap_in, const int32_t* seed,
                                 int32_t n0, const FillProbes* probes,
                                 const FoldAnns* anns, int32_t op,
                                 int32_t zero, int32_t one, int32_t* folded,
                                 int32_t* supp, cudaStream_t stream) {
  return launch_fold<int32_t>(lo0, cnt, cap_in, seed, n0, probes, anns, op,
                              zero, one, folded, supp, stream);
}

extern "C" int frontier_fold_f32(const int32_t* lo0, const int32_t* cnt,
                                 int32_t cap_in, const int32_t* seed,
                                 int32_t n0, const FillProbes* probes,
                                 const FoldAnns* anns, int32_t op, float zero,
                                 float one, float* folded, int32_t* supp,
                                 cudaStream_t stream) {
  return launch_fold<float>(lo0, cnt, cap_in, seed, n0, probes, anns, op,
                            zero, one, folded, supp, stream);
}

extern "C" int frontier_fold_u8(const int32_t* lo0, const int32_t* cnt,
                                int32_t cap_in, const int32_t* seed,
                                int32_t n0, const FillProbes* probes,
                                const FoldAnns* anns, int32_t op,
                                uint8_t zero, uint8_t one, uint8_t* folded,
                                int32_t* supp, cudaStream_t stream) {
  return launch_fold<uint8_t>(lo0, cnt, cap_in, seed, n0, probes, anns, op,
                              zero, one, folded, supp, stream);
}

extern "C" int frontier_fill(const int32_t* total_c, const int32_t* offs,
                             const int32_t* lo0, int32_t cap_in,
                             const int32_t* seed, int32_t n0,
                             const FillProbes* probes, int64_t start,
                             int64_t n, int32_t* vals_o, int32_t* row_o,
                             int32_t* p0_o, bool* keep_o, int32_t* pos_o,
                             cudaStream_t stream) {
  if (n <= 0) return 0;
  if (probes->count < 0 || probes->count > FF_MAX_PROBES)
    return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const int64_t blocks = (n + threads - 1) / threads;
  frontier_fill_kernel<<<(unsigned int)blocks, threads, 0, stream>>>(
      total_c, offs, lo0, cap_in, seed, n0, *probes, start, n, vals_o,
      row_o, p0_o, keep_o, pos_o);
  return (int)cudaGetLastError();
}
