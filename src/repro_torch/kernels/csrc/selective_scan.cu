// Mamba-1 selective scan (falcon-mamba-7b) for Hopper, sm_90a, with a plain
// C interface loaded through ctypes.
//
// Replaces the Pallas TPU kernel of src/repro/kernels/selective_scan.py:
//   selective_scan_kernel  <- _kernel (:25), reached through
//                             selective_scan (:47, pallas_call :56)
//
//   h_t[d, n] = exp(dt_t[d] A[d, n]) h_{t-1}[d, n]
//               + (dt_t[d] x_t[d]) B_t[n],      h_{-1} = 0,
//   y_t[d]    = sum_n h_t[d, n] C_t[n].
//   xc, dt: (B, S, Di) and Bc, Cc: (B, S, N), f32 or bf16, all one type;
//   A: (Di, N) f32 -> y: (B, S, Di) in that type, and the final state
//   h_last: (B, Di, N) in f32.  The state is carried in f32.
//
// What bounds it on an H100.  At the serving path's shape (B = 4, S = 4096,
// Di = 8192, N = 16, f32) it moves 1.615e9 bytes (xc, dt read, y written,
// 12 bytes per (b, t, d); Bc, Cc, A read and h_last written are small): a
// 482 us bound at 3.35 TB/s.  It also takes one exponential per
// (b, t, d, n), 2.147e9 of them; the special-function units issue 16 a
// clock on each of the 132 SMs, a ~514 us bound at 1.98 GHz.  The flops
// (~6 per (b, t, d, n), ~0.22 ms at 67 TFLOP/s) come third.  Bytes and
// exponentials bound it about equally.
//
// Design.  The TPU kernel keeps a (512, N) state tile in VMEM for each
// step of a (B, Di / 512) grid and walks S with a fori_loop.  Here the
// state lives in registers and the grid runs in parallel: B x Di = 32,768
// channels with one thread each would be too few threads to cover the
// latency of device memory, so each channel's N states are spread over
// L lanes of one warp, kStates = 4 states a lane (L = 4 at N = 16,
// 131,072 threads on the serving path).  Holding 4 states a lane keeps
// the per-step sum over n mostly in registers: one step costs a lane 4
// exponentials and log2(L) shuffles.  A block owns kChannels = 64
// channels of one b and walks S in chunks of kChunk = 32 steps: it stages
// the chunk's xc and dt (32 x 64, read in rows of 64 contiguous channels)
// and Bc and Cc (32 x N) in shared memory in f32, runs the 32 steps, and
// stages y (32 x 64) there so that its stores are coalesced too.  h_last
// is written once at the end.  Any Di and S work: the ragged channels and
// lanes past N compute on zeros (their state stays 0) and store nothing.
// The Pallas kernel needed Di % 512 == 0.  Offsets are 64-bit (B S Di is
// 1.3e8 on the serving path).
//
// Numerics.  The exponential is expf (not __expf or fast math).  Products
// and sums of the state update are rounded one by one (__fmul_rn,
// __fadd_rn) as the plain PyTorch version rounds them, and dt x is
// rounded to the input type first, as the plain version computes it, so
// h matches the plain version up to the two expf implementations.  The
// sum over n runs in another order than the plain version's einsum.
// Double buffering the chunks (cp.async or TMA) and a chunked parallel
// scan over S are the work of the PR that makes this kernel fast.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kStates = 4;     // states of one channel held by one lane
constexpr int kChannels = 64;  // channels of one block
constexpr int kChunk = 32;     // time steps staged in shared memory at once
constexpr int kMaxLanes = 16;  // lanes per channel: N <= 64
constexpr int kThreadsPerSM = 1024;  // threads an SM must hold at once

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}
// v rounded to the input type, as a product computed in that type is
__device__ __forceinline__ float round_as(float v, const float*) { return v; }
__device__ __forceinline__ float round_as(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(v));
}

// Block: kChannels * L threads; thread c * L + lane holds states
// n = lane * kStates .. + kStates - 1 of channel d0 + c.  Grid: (Di / 64
// rounded up, B).  Registers are capped so that kThreadsPerSM threads fit
// an SM: at the serving shape (L = 4) the 512 blocks of 256 threads then
// run in one wave of 4 blocks per SM, where 78 registers allowed 3 (1.29
// waves).
template <typename T, int L>
__global__ void __launch_bounds__(kChannels * L,
                                  kThreadsPerSM / (kChannels * L))
selective_scan_kernel(const T* __restrict__ xc, const T* __restrict__ dt,
                      const T* __restrict__ bc, const T* __restrict__ cc,
                      const float* __restrict__ a_mat, T* __restrict__ y,
                      float* __restrict__ h_last, int seq, int d_inner,
                      int n_state) {
  constexpr int kThreads = kChannels * L;
  constexpr int kWidth = L * kStates;            // N padded to the lanes
  __shared__ float s_x[kChunk][kChannels];
  __shared__ float s_dt[kChunk][kChannels];
  __shared__ float s_y[kChunk][kChannels];
  __shared__ __align__(16) float s_b[kChunk][kWidth];
  __shared__ __align__(16) float s_c[kChunk][kWidth];

  const int tid = threadIdx.x;
  const int c = tid / L;
  const int lane = tid % L;
  const int d0 = blockIdx.x * kChannels;
  const int d = d0 + c;
  const int64_t b = blockIdx.y;
  const int64_t xbase = b * seq * d_inner;
  const int64_t nbase = b * seq * n_state;

  float a[kStates], h[kStates];
#pragma unroll
  for (int r = 0; r < kStates; ++r) {
    const int n = lane * kStates + r;
    a[r] = (d < d_inner && n < n_state)
               ? a_mat[static_cast<int64_t>(d) * n_state + n] : 0.f;
    h[r] = 0.f;
  }

  for (int t0 = 0; t0 < seq; t0 += kChunk) {
    const int steps = min(kChunk, seq - t0);
#pragma unroll 8
    for (int k = 0; k < kChunk * kChannels / kThreads; ++k) {
      const int i = tid + k * kThreads;
      const int tt = i / kChannels, ch = i % kChannels;
      const bool ok = tt < steps && d0 + ch < d_inner;
      const int64_t off = xbase + static_cast<int64_t>(t0 + tt) * d_inner
                          + d0 + ch;
      s_x[tt][ch] = ok ? to_f32(xc[off]) : 0.f;
      s_dt[tt][ch] = ok ? to_f32(dt[off]) : 0.f;
    }
    for (int i = tid; i < kChunk * kWidth; i += kThreads) {
      const int tt = i / kWidth, n = i % kWidth;
      const bool ok = tt < steps && n < n_state;
      const int64_t off = nbase + static_cast<int64_t>(t0 + tt) * n_state
                          + n;
      s_b[tt][n] = ok ? to_f32(bc[off]) : 0.f;
      s_c[tt][n] = ok ? to_f32(cc[off]) : 0.f;
    }
    __syncthreads();

    for (int tt = 0; tt < steps; ++tt) {
      const float dtv = s_dt[tt][c];
      const float dtx = round_as(__fmul_rn(dtv, s_x[tt][c]), xc);
      const float4 bv =
          *reinterpret_cast<const float4*>(&s_b[tt][lane * kStates]);
      const float4 cv =
          *reinterpret_cast<const float4*>(&s_c[tt][lane * kStates]);
      const float bn[kStates] = {bv.x, bv.y, bv.z, bv.w};
      const float cn[kStates] = {cv.x, cv.y, cv.z, cv.w};
      float p = 0.f;
#pragma unroll
      for (int r = 0; r < kStates; ++r) {
        const float da = expf(__fmul_rn(dtv, a[r]));
        h[r] = __fadd_rn(__fmul_rn(da, h[r]), __fmul_rn(dtx, bn[r]));
        p = fmaf(h[r], cn[r], p);
      }
#pragma unroll
      for (int off = L / 2; off > 0; off /= 2)
        p += __shfl_xor_sync(0xffffffffu, p, off);
      if (lane == 0) s_y[tt][c] = p;
    }
    __syncthreads();

#pragma unroll 8
    for (int k = 0; k < kChunk * kChannels / kThreads; ++k) {
      const int i = tid + k * kThreads;
      const int tt = i / kChannels, ch = i % kChannels;
      if (tt < steps && d0 + ch < d_inner)
        store(y + xbase + static_cast<int64_t>(t0 + tt) * d_inner + d0 + ch,
              s_y[tt][ch]);
    }
    // the next chunk's staging writes s_x, s_dt, s_b and s_c only; s_y is
    // written again after the next __syncthreads
  }

  if (d < d_inner) {
#pragma unroll
    for (int r = 0; r < kStates; ++r) {
      const int n = lane * kStates + r;
      if (n < n_state)
        h_last[(b * d_inner + d) * n_state + n] = h[r];
    }
  }
}

template <typename T, int L>
int launch_lanes(const void* xc, const void* dt, const void* bc,
                 const void* cc, const void* a, void* y, void* h_last,
                 int batch, int seq, int d_inner, int n_state,
                 cudaStream_t stream) {
  const dim3 grid((d_inner + kChannels - 1) / kChannels, batch);
  selective_scan_kernel<T, L><<<grid, kChannels * L, 0, stream>>>(
      static_cast<const T*>(xc), static_cast<const T*>(dt),
      static_cast<const T*>(bc), static_cast<const T*>(cc),
      static_cast<const float*>(a), static_cast<T*>(y),
      static_cast<float*>(h_last), seq, d_inner, n_state);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_scan(const void* xc, const void* dt, const void* bc,
                const void* cc, const void* a, void* y, void* h_last,
                int batch, int seq, int d_inner, int n_state, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int lanes = (n_state + kStates - 1) / kStates;
  if (lanes <= 1)
    return launch_lanes<T, 1>(xc, dt, bc, cc, a, y, h_last, batch, seq,
                              d_inner, n_state, s);
  if (lanes <= 2)
    return launch_lanes<T, 2>(xc, dt, bc, cc, a, y, h_last, batch, seq,
                              d_inner, n_state, s);
  if (lanes <= 4)
    return launch_lanes<T, 4>(xc, dt, bc, cc, a, y, h_last, batch, seq,
                              d_inner, n_state, s);
  if (lanes <= 8)
    return launch_lanes<T, 8>(xc, dt, bc, cc, a, y, h_last, batch, seq,
                              d_inner, n_state, s);
  if (lanes <= kMaxLanes)
    return launch_lanes<T, kMaxLanes>(xc, dt, bc, cc, a, y, h_last, batch,
                                      seq, d_inner, n_state, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// xc, dt, y: (batch, seq, d_inner) and bc, cc: (batch, seq, n_state)
// row-major in one type; a: (d_inner, n_state) f32; h_last: (batch,
// d_inner, n_state) f32.  n_state <= 64.  Returns cudaGetLastError() after
// the launch (cudaErrorInvalidValue for n_state > 64, without launching).
int selective_scan_f32(const void* xc, const void* dt, const void* bc,
                       const void* cc, const void* a, void* y, void* h_last,
                       int batch, int seq, int d_inner, int n_state,
                       void* stream) {
  return launch_scan<float>(xc, dt, bc, cc, a, y, h_last, batch, seq,
                            d_inner, n_state, stream);
}

int selective_scan_bf16(const void* xc, const void* dt, const void* bc,
                        const void* cc, const void* a, void* y, void* h_last,
                        int batch, int seq, int d_inner, int n_state,
                        void* stream) {
  return launch_scan<__nv_bfloat16>(xc, dt, bc, cc, a, y, h_last, batch, seq,
                                    d_inner, n_state, stream);
}

}  // extern "C"
