// Trust-weighted parameter aggregation (paper Eqns 6 and 19) for Hopper,
// sm_90a, with a plain C interface loaded through ctypes.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/trust_aggregate.py:
//   trust_aggregate_kernel         <- _kernel (:37) and _masked_kernel (:44),
//                                     reached through trust_aggregate (:67)
//   trust_aggregate_global_kernel  <- _global_kernel (:51), reached through
//                                     trust_aggregate_global (:99)
//
// What bounds them on an H100 (3.35 TB/s): bytes.  Every output column
// reads each input row once and does one multiply-add per element read, a
// quarter of a flop per byte (f32), far below the card's balance point.  At
// the federation's main-path shape (C = 99 members in the widest cluster,
// B = 16 clusters, N = 159,010 f32 values) the global kernel moves
// (99 + 15 + 1) * N * 4 B = 73.1 MB, a 21.83 us bound; the masked kernel
// (99 + 1) * N * 4 B = 63.6 MB, 18.99 us, and in bf16 half that, 9.49 us.
//
// Design.  The TPU kernel streams one (C, 8192) tile through VMEM per grid
// step.  Here one thread owns one output column, so each warp's load of a
// row is 128 contiguous bytes, and the rows are reduced by a loop inside
// the thread in f32: no cross-block reduction, no atomics, deterministic
// order.  Each block first compacts the rows whose mask is non-zero into
// shared memory (a warp ballot per 32 rows, in ascending row order, one
// chunk of rows at a time so C is unbounded), which keeps the reduction
// loop free of branches so the unrolled loads stay in flight together.
// Masked-out rows are never read, so padded rows may hold anything (the
// engine's 1e30 sentinels) and contribute exactly zero, whatever weight the
// caller left on them.  The staleness weights are read through the
// read-only cache; every thread of a warp reads the same one.  The cluster
// index c of the global kernel is read from device memory: the caller never
// syncs to choose it, and the launch can be captured in a CUDA graph.
//
// Measured on an H100 (L2 flushed between calls; PERF.md): the masked
// kernel takes ~27.7 us in f32 at that shape, level with a contiguous
// stream of the same bytes by as many threads (~27.5 us) and faster than
// cuBLAS's (w * m) @ x (~28.6 us); in bf16 ~19.1 us against ~42.4 us.  A
// design with 4 or 8 columns a thread and one 16-byte load a row (rows
// sorted by their offset in a 16-byte unit, realigned by shuffles) was no
// faster in f32 and 6 % faster in bf16, for ~240 more lines; this one
// stays.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;          // one output column per thread
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// Sum over rows r of w[r] * mask[r] * x[r, col], rows with mask[r] == 0
// skipped (mask == nullptr: every row counts).  Every thread of the block
// must call it, also those past the last column (they join the ballots).
template <typename T>
__device__ float masked_column_sum(const T* __restrict__ x,
                                   const float* __restrict__ w,
                                   const float* __restrict__ mask, int rows,
                                   int64_t n, int64_t col) {
  __shared__ int s_row[kThreads];
  __shared__ float s_w[kThreads];
  __shared__ int s_warp_count[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const bool in_range = col < n;
  float acc = 0.f;
  for (int base = 0; base < rows; base += kThreads) {
    const int r = base + threadIdx.x;
    float wr = 0.f;
    bool valid = false;
    if (r < rows) {
      const float m = mask == nullptr ? 1.f : __ldg(mask + r);
      valid = m != 0.f;
      wr = __ldg(w + r) * m;
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, valid);
    if (lane == 0) s_warp_count[warp] = __popc(ballot);
    __syncthreads();
    int offset = 0, count = 0;
    for (int i = 0; i < kWarps; ++i) {
      const int k = s_warp_count[i];
      offset += i < warp ? k : 0;
      count += k;
    }
    if (valid) {
      const int pos = offset + __popc(ballot & ((1u << lane) - 1u));
      s_row[pos] = r;
      s_w[pos] = wr;
    }
    __syncthreads();
    if (in_range) {
      const T* p = x + col;
#pragma unroll 8
      for (int k = 0; k < count; ++k)
        acc = fmaf(s_w[k], to_f32(p[static_cast<int64_t>(s_row[k]) * n]),
                   acc);
    }
    __syncthreads();                   // the next chunk reuses s_row / s_w
  }
  return acc;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
trust_aggregate_kernel(const T* __restrict__ x, const float* __restrict__ w,
                       const float* __restrict__ mask, T* __restrict__ out,
                       int rows, int64_t n) {
  const int64_t col = static_cast<int64_t>(blockIdx.x) * kThreads +
                      threadIdx.x;
  const float acc = masked_column_sum(x, w, mask, rows, n, col);
  if (col < n) store(out + col, acc);
}

__global__ void __launch_bounds__(kThreads)
trust_aggregate_global_kernel(const float* __restrict__ x,
                              const float* __restrict__ w,
                              const float* __restrict__ mask,
                              const float* __restrict__ stack,
                              const float* __restrict__ gw,
                              const int32_t* __restrict__ c_ptr,
                              float* __restrict__ out, int rows,
                              int clusters, int64_t n) {
  const int64_t col = static_cast<int64_t>(blockIdx.x) * kThreads +
                      threadIdx.x;
  const float agg = masked_column_sum(x, w, mask, rows, n, col);  // Eqn 6
  if (col >= n) return;
  const int c = __ldg(c_ptr);
  const bool hit = c >= 0 && c < clusters;
  const int split = hit ? c : clusters;
  const float* p = stack + col;
  float g = 0.f;                                                  // Eqn 19
#pragma unroll 4
  for (int b = 0; b < split; ++b)
    g = fmaf(__ldg(gw + b), p[static_cast<int64_t>(b) * n], g);
  if (hit) {
    g = fmaf(__ldg(gw + c), agg, g);   // row c of the stack is never read
#pragma unroll 4
    for (int b = c + 1; b < clusters; ++b)
      g = fmaf(__ldg(gw + b), p[static_cast<int64_t>(b) * n], g);
  }
  out[col] = g;
}

inline unsigned blocks_for(int64_t n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

template <typename T>
int launch_aggregate(const void* x, const void* w, const void* mask,
                     void* out, int rows, long long n, void* stream) {
  trust_aggregate_kernel<T><<<blocks_for(n), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const float*>(w),
      static_cast<const float*>(mask), static_cast<T*>(out), rows, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x: (rows, n) row-major; w, mask: (rows,) f32 (mask may be NULL);
// out: (n,).  Returns cudaGetLastError() after the launch.
int ta_aggregate_f32(const void* x, const void* w, const void* mask,
                     void* out, int rows, long long n, void* stream) {
  return launch_aggregate<float>(x, w, mask, out, rows, n, stream);
}

int ta_aggregate_bf16(const void* x, const void* w, const void* mask,
                      void* out, int rows, long long n, void* stream) {
  return launch_aggregate<__nv_bfloat16>(x, w, mask, out, rows, n, stream);
}

// x: (rows, n) member updates; w, mask: (rows,); stack: (clusters, n);
// gw: (clusters,); c: one int32 in device memory; out: (n,).  All f32.
int ta_aggregate_global_f32(const void* x, const void* w, const void* mask,
                            const void* stack, const void* gw, const void* c,
                            void* out, int rows, int clusters, long long n,
                            void* stream) {
  trust_aggregate_global_kernel<<<blocks_for(n), kThreads, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const float*>(mask), static_cast<const float*>(stack),
      static_cast<const float*>(gw), static_cast<const int32_t*>(c),
      static_cast<float*>(out), rows, clusters, n);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
