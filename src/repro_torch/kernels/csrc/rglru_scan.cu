// RG-LRU gated linear recurrence (recurrentgemma-2b) for Hopper, sm_90a,
// with a plain C interface loaded through ctypes.
//
// Replaces the Pallas TPU kernel of src/repro/kernels/rglru_scan.py:
//   rglru_scan_kernel  <- _kernel (:22), reached through rglru_scan (:38)
//
//   h_t = a_t * h_{t-1} + bx_t,  h_{-1} = 0,  elementwise over the width W.
//   a, bx: (B, S, W) f32 or bf16 -> hs: (B, S, W) in a's type, and the
//   final state h_last: (B, W) in f32.
//
// What bounds it on an H100 (3.35 TB/s): bytes.  One multiply and one add
// per 12 bytes moved (f32: a and bx read, hs written), far below the
// card's balance point.  At the serving path's shape (B = 4, S = 4096,
// W = 2560, f32) it moves 503 MB, a 150 us bound.
//
// Design.  The recurrence is serial in S and independent over (b, w).  The
// TPU kernel walks S with a (1, BW) channel tile in VMEM; here one thread
// owns one (b, w) channel and walks S in f32 registers, so each warp's
// load of a time step is 128 contiguous bytes.  The loads of kUnroll steps
// are issued before the multiply-adds that consume them, which keeps
// 2 * kUnroll loads of each thread in flight: with only B * W threads (10,240
// on the serving path) the latency of device memory, not the arithmetic,
// is what a thread waits on.  Any W works (the ragged tail of threads
// returns at once); the Pallas kernel needed W % BW == 0.  The products and
// sums are rounded one by one (__fmul_rn, __fadd_rn), as the plain
// PyTorch version rounds them, so the two agree bit for bit in f32.
// A chunked parallel scan over S would put more bytes in flight; that is
// work for the PR that makes this kernel fast.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 64;   // channels per block: 160 blocks at W = 2560, B = 4
constexpr int kUnroll = 16;    // time steps whose loads are in flight at once

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
rglru_scan_kernel(const T* __restrict__ a, const T* __restrict__ bx,
                  T* __restrict__ hs, float* __restrict__ h_last, int seq,
                  int width) {
  const int w = blockIdx.x * kThreads + threadIdx.x;
  if (w >= width) return;
  const int64_t b = blockIdx.y;
  const int64_t base = b * seq * width + w;
  const T* pa = a + base;
  const T* pb = bx + base;
  T* ph = hs + base;
  float h = 0.f;
  int t = 0;
  for (; t + kUnroll <= seq; t += kUnroll) {
    float av[kUnroll], bv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t off = static_cast<int64_t>(t + u) * width;
      av[u] = to_f32(pa[off]);
      bv[u] = to_f32(pb[off]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      h = __fadd_rn(__fmul_rn(av[u], h), bv[u]);
      store(ph + static_cast<int64_t>(t + u) * width, h);
    }
  }
  for (; t < seq; ++t) {
    const int64_t off = static_cast<int64_t>(t) * width;
    h = __fadd_rn(__fmul_rn(to_f32(pa[off]), h), to_f32(pb[off]));
    store(ph + off, h);
  }
  h_last[b * width + w] = h;
}

template <typename T>
int launch_scan(const void* a, const void* bx, void* hs, void* h_last,
                int batch, int seq, int width, void* stream) {
  const dim3 grid((width + kThreads - 1) / kThreads, batch);
  rglru_scan_kernel<T><<<grid, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(a), static_cast<const T*>(bx),
      static_cast<T*>(hs), static_cast<float*>(h_last), seq, width);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// a, bx, hs: (batch, seq, width) row-major in one type; h_last: (batch,
// width) f32.  Returns cudaGetLastError() after the launch.
int rglru_scan_f32(const void* a, const void* bx, void* hs, void* h_last,
                   int batch, int seq, int width, void* stream) {
  return launch_scan<float>(a, bx, hs, h_last, batch, seq, width, stream);
}

int rglru_scan_bf16(const void* a, const void* bx, void* hs, void* h_last,
                    int batch, int seq, int width, void* stream) {
  return launch_scan<__nv_bfloat16>(a, bx, hs, h_last, batch, seq, width,
                                    stream);
}

}  // extern "C"
