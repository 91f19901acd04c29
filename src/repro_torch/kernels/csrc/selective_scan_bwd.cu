// Backward of the Mamba-1 selective scan (falcon-mamba-7b) for Hopper,
// sm_90a, float32 or bfloat16, with a plain C interface loaded through
// ctypes.
//
// The TPU package has no backward kernel: its training differentiates the
// lax.scan of mamba_forward (src/repro/models/mamba.py:68-83), and
// jax.vjp of selective_scan_ref (src/repro/kernels/ref.py:37-55) is the
// reference here.  The forward is selective_scan.cu:
//   h_t = dA_t h_{t-1} + (dt_t x_t) B_t,  dA_t = exp(dt_t A),  h_{-1} = 0,
//   y_t = sum_n h_t C_t,
// over xc, dt: (B, S, Di), Bc, Cc: (B, S, N), A: (Di, N).
//
//   Given dy (B, S, Di) and d h_last (B, Di, N) (or none), the reverse
//   recurrence g_t = dy_t C_t + dA_{t+1} g_{t+1} (+ d h_last at S - 1)
//   gives, with h_{-1} = 0,
//     dxc_t = dt_t sum_n g_t B_t,
//     ddt_t = x_t sum_n g_t B_t + sum_n g_t A dA_t h_{t-1},
//     dBc_t = sum_d g_t dt_t x_t,       dCc_t = sum_d dy_t h_t,
//     dA    = sum_{b,t} g_t dt_t dA_t h_{t-1}.
//
// What bounds it on an H100.  At the training shape (1, 4096, 8192, 16) it
// must read xc, dt and dy and write dxc and ddt, 20 bytes a (b, t, d):
// 671 MB, and read the forward's chunk states (below), 67 MB more: a
// ~0.22 ms bound at 3.35 TB/s.  Its exponentials, 5.4e8 a pass over
// (b, t, d, n), take ~0.13 ms each at 16 a clock on 132 SMs, and its ~20
// flops a (b, t, d, n) ~0.16 ms at 67 TFLOP/s.
//
// Design.  The states are needed backward in time, and the recurrence is
// not inverted (h_{t-1} = (h_t - dBx_t) / dA_t divides by dA_t, which is 0
// wherever dt |A| is large).  The forward kernel writes the state entering
// each of its 32-step chunks (chunk_h, (n_chunks, B, N, Di)); here each
// chunk is recomputed from its entry state and walked back, the last chunk
// first:
//   1. a walk over the chunk's 32 steps computes dA_t = ex2(dt a2) (the
//      chunk's one exponential a (t, d, n)) into shared memory and keeps
//      the state entering each 8-step sub-chunk in registers;
//   2. for each sub-chunk, the last first, its 8 states are recomputed
//      into registers from the kept entry state and the stored dA_t (no
//      exponential), then walked back: g, the gradients of the step, and
//      the sums below.
// Both walks compute a state exactly as selective_scan.cu does
// (ex2.approx.ftz(dt a2) with a2 = A log2 e rounded to f32, then one FMA),
// so the states are the forward's bit for bit and dA_t is what the
// forward used; d dA_t / d dt = dA_t a2 ln 2 and d dA_t / d A = dA_t dt.
//   Filling the card: a lane holds kStates = 4 states of one channel, L =
// N / 4 lanes a channel (rounded up to a power of two; L = 4 at N = 16),
// and a block 256 threads (64 channels at N = 16; 2 KB of dA a channel
// and chunk: 128 KB a block, so one block of 8 warps an SM).  The grid is
// (Di / channels, B): at (1, 4096, 8192, 16) the 128 blocks fill 128 of
// 132 SMs with 8 warps each, where the design before this one had two.
// Each block walks all of S; g enters the last chunk as d h_last.
//   Sums across channels (dBc, dCc) and the batch (dA) use no atomics.
// Each step, a lane's 4 dBc and 4 dCc terms are summed over the warp's
// channels by shuffles that halve the values a lane holds each round (7
// shuffles at L = 4), the warps' sums of a sub-chunk are added in shared
// memory in warp order and written as the block's partial, (Di / channels,
// B, S, 2, N) floats, and each thread's dA over S goes to a (B, N, Di)
// partial.  A last kernel sums the partials over the blocks (and dA over
// b) in a fixed order, so two calls give
// the same bits.  sum_n g B and sum_n a2 u are summed over a channel's L
// lanes by butterfly shuffles.  dxc and ddt of a sub-chunk leave shared
// memory in rows.  The chunks of xc, dt, dy, Bc, Cc and the chunk states
// are copied to shared memory with cp.async in 16-byte units, the next
// chunk's during this one's work.
//   Any B, S, Di and N <= 64: steps past S (the last chunk is padded to
// 32 with dt = dy = 0, so dA = 1 and g and h pass through unchanged),
// channels past Di and states past N compute on zeros and store nothing;
// rows that are not whole 16-byte units take plain loads in place of
// cp.async.  Offsets are 64-bit.
//
// Measured on "NVIDIA H100 80GB HBM3, 700.00 W" (scripts/bwd_sweep.py
// --ssm, in turns, warm / cold, ms) at (1, 4096, 8192, 16) given the
// states: 1.374-1.395 / 1.373-1.393, where the design before it (its own
// forward walk, two warps an SM) took 3.05-3.07 in the same calls; 255
// registers, 28 bytes spilled, 8 warps resident an SM.  Timing-only
// variants place the time: the staging and walk 1 alone 0.39, walks 1 and
// 2 with the output phases but no backward step 0.80; without the channel
// sums' shuffles 1.18, without the output phases 1.25, without walk 2's
// FMAs 1.28, without the stores 1.30, without the sum kernel 1.36.  At
// ~150 instructions a thread and step it issues ~2 instructions a clock
// an SM; neither 16 warps an SM (2 states a lane, 128 registers: 1.385)
// nor two blocks of 4 warps (1.394) was faster, so more warps do not hide
// what holds it.
//
// Numerics.  Sums run in another order than the plain version's (the
// warp's channels pairwise, then the warps, then the blocks in order; a
// lane's states by FMAs, then its channel's lanes pairwise; dA over t
// backward, then b), on FMAs;
// each gradient stays within 1e-4 of its largest entry of the plain
// version (tests/test_torch_mamba_grad.py emulates these numerics on the
// CPU).

// bfloat16 (selective_scan_bwd_states_bf16, training at the plans'
// bfloat16): xc, dt, Bc, Cc and dy in bfloat16, A, d h_last and the chunk
// states float32 (the forward's selective_scan_states_bf16 writes them in
// float32); dxc, ddt, dBc and dCc are written in bfloat16 and dA in
// float32, the types of the JAX package's gradients.  The chunks are
// converted to float32 as they are staged (plain 8-byte loads of 4
// values in place of cp.async; the states still by cp.async) and the
// outputs as they leave, so the walk and every sum are the float32
// kernel's.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kStates = 4;     // states of one channel held by one lane
constexpr int kPairs = 1024;   // (d, n) pairs of a block
constexpr int kChunk = 32;     // steps of a chunk: the forward kernel's
constexpr int kSub = 8;        // steps of a sub-chunk, recomputed at once
constexpr int kSubs = kChunk / kSub;
constexpr int kMaxState = 64;  // largest N
constexpr int kMaxLanes = kMaxState / kStates;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 bytes from global to shared memory; src_bytes = 0 writes zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// rows [0, kRows) x cols [0, kCols) of src (row pitch src_pitch) into dst
// (row pitch kCols); entries at rows >= rows_ok or cols >= cols_ok are
// zeros.  vec: cols_ok and the pitch are whole 16-byte units and src is
// 16-byte aligned, so the copy is asynchronous; otherwise plain loads and
// stores.
template <int kThreads, int kRows, int kCols>
__device__ __forceinline__ void stage(float* dst, const float* src,
                                      int64_t src_pitch, int rows_ok,
                                      int cols_ok, bool vec) {
  if (vec) {
    constexpr int kPerRow = kCols / 4;
#pragma unroll
    for (int i = threadIdx.x; i < kRows * kPerRow; i += kThreads) {
      const int r = i / kPerRow, c = (i % kPerRow) * 4;
      const bool ok = r < rows_ok && c < cols_ok;
      cp_async16(dst + r * kCols + c, src + (ok ? r * src_pitch + c : 0),
                 ok ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < kRows * kCols; i += kThreads) {
      const int r = i / kCols, c = i % kCols;
      dst[i] = r < rows_ok && c < cols_ok ? src[r * src_pitch + c] : 0.f;
    }
  }
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 w = *reinterpret_cast<const uint2*>(p);
  __nv_bfloat162 lo, hi;
  memcpy(&lo, &w.x, 4);
  memcpy(&hi, &w.y, 4);
  const float2 a = __bfloat1622float2(lo), b = __bfloat1622float2(hi);
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 w;
  memcpy(&w.x, &lo, 4);
  memcpy(&w.y, &hi, 4);
  *reinterpret_cast<uint2*>(p) = w;
}
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// `stage` of a bfloat16 source: the same float32 tile by plain loads
// (vec: 4 values are one 8-byte unit)
template <int kThreads, int kRows, int kCols>
__device__ __forceinline__ void stage(float* dst, const __nv_bfloat16* src,
                                      int64_t src_pitch, int rows_ok,
                                      int cols_ok, bool vec) {
  if (vec) {
    constexpr int kPerRow = kCols / 4;
#pragma unroll
    for (int i = threadIdx.x; i < kRows * kPerRow; i += kThreads) {
      const int r = i / kPerRow, c = (i % kPerRow) * 4;
      const bool ok = r < rows_ok && c < cols_ok;
      *reinterpret_cast<float4*>(dst + r * kCols + c) =
          ok ? load4(src + r * src_pitch + c)
             : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  } else {
    for (int i = threadIdx.x; i < kRows * kCols; i += kThreads) {
      const int r = i / kCols, c = i % kCols;
      dst[i] = r < rows_ok && c < cols_ok
                   ? __bfloat162float(src[r * src_pitch + c])
                   : 0.f;
    }
  }
}

// a lane's states as one 16-byte vector
static_assert(kStates == 4, "a lane's states are one float4");
__device__ __forceinline__ void unpack(float4 w, float (&v)[kStates]) {
  v[0] = w.x;
  v[1] = w.y;
  v[2] = w.z;
  v[3] = w.w;
}
__device__ __forceinline__ float4 pack(const float (&v)[kStates]) {
  return make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void load_states(const float* p,
                                            float (&v)[kStates]) {
  unpack(*reinterpret_cast<const float4*>(p), v);
}

// Sums v (a lane's kStates dBc terms, then its kStates dCc terms) over the
// lanes of a warp that share lane % L (the warp's 32 / L channels): over
// the masks M = 16, 8, .., L, halving the values a lane holds while it
// holds more than one (send one half, keep the other: lanes with bit M set
// keep the upper half), then adding.  After R = min(log2(2 kStates),
// log2(32 / L)) halving rounds v[j] (j < 2 kStates >> R) holds entry
// (lane >> (5 - R) & (2^R - 1)) (2 kStates >> R) + j summed over the
// channels.  Each round is a template instance, so every index is a
// constant and v stays in registers.
template <int L, int M = 16, int kHeld = 2 * kStates>
__device__ __forceinline__ void warp_sum(float (&v)[2 * kStates], int lane) {
  if constexpr (M >= L) {
    if constexpr (kHeld > 1) {
      constexpr int kHalf = kHeld / 2;
      const bool up = (lane & M) != 0;
#pragma unroll
      for (int i = 0; i < kHalf; ++i) {
        const float send = up ? v[i] : v[i + kHalf];
        const float keep = up ? v[i + kHalf] : v[i];
        v[i] = keep + __shfl_xor_sync(0xffffffffu, send, M);
      }
      warp_sum<L, M / 2, kHalf>(v, lane);
    } else {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], M);
      warp_sum<L, M / 2, 1>(v, lane);
    }
  }
}

constexpr int log2i(int x) { return x > 1 ? 1 + log2i(x / 2) : 0; }

template <int L>
struct Layout {
  static constexpr int kThreads = 64 * L < kPairs / kStates ? 64 * L
                                                            : kPairs / kStates;
  static constexpr int kChannels = kThreads / L;   // channels of a block
  static constexpr int kWarps = kThreads / 32;
  static constexpr int kWidth = L * kStates;       // N padded to the lanes
  static constexpr int kXs = kChunk * kChannels;   // a chunk of xc, dt, dy
  static constexpr int kNs = kChunk * kWidth;      // a chunk of Bc or Cc
  static constexpr int kH0 = kWidth * kChannels;   // a chunk's entry states
  static constexpr int kStage = 3 * kXs + 2 * kNs + kH0;
  static constexpr int kDa = kChunk * kThreads * kStates;   // dA of a chunk
  // warp sums of a sub-chunk [warp][step][dBc, dCc][kWidth], then its dxc
  // and ddt [2][step][kChannels]; two buffers where they fit
  static constexpr int kRed = kWarps * kSub * 2 * kWidth;
  static constexpr int kOut = 2 * kSub * kChannels;
  static constexpr int kRedBufs =
      (kDa + 2 * kStage + 2 * (kRed + kOut)) * 4 <= 227 * 1024 ? 2 : 1;
  static constexpr int kFloats = kDa + 2 * kStage + kRedBufs * (kRed + kOut);
  // warp_sum's halving rounds and the values a lane keeps
  static constexpr int kRounds = log2i(2 * kStates) < log2i(32 / L)
                                     ? log2i(2 * kStates)
                                     : log2i(32 / L);
  static constexpr int kHeld = 2 * kStates >> kRounds;
  // the lanes that hold a copy of another lane's sums (butterfly rounds)
  static constexpr int kDupMask = ((32 >> kRounds) - 1) & ~(L - 1);
  static_assert(kFloats * 4 <= 227 * 1024, "shared memory");
};

// Block: Layout<L>::kThreads threads; thread c * L + sub holds states
// n = sub * 4 .. + 3 of channel d0 + c.  Grid: (Di / kChannels rounded up,
// B).
template <typename T, int L>
__global__ void __launch_bounds__(Layout<L>::kThreads, 1)
selective_scan_bwd_kernel(const T* __restrict__ xc, const T* __restrict__ dt,
                          const T* __restrict__ bc, const T* __restrict__ cc,
                          const float* __restrict__ a_mat,
                          const T* __restrict__ dy,
                          const float* __restrict__ dh_last,
                          const float* __restrict__ chunk_h,
                          T* __restrict__ dxc, T* __restrict__ ddt,
                          float* __restrict__ part_bc,
                          float* __restrict__ part_a, int batch, int seq,
                          int d_inner, int n_state, bool vec_x, bool vec_n) {
  using Lay = Layout<L>;
  constexpr int kThreads = Lay::kThreads, kChannels = Lay::kChannels;
  constexpr int kWidth = Lay::kWidth, kXs = Lay::kXs, kNs = Lay::kNs;
  constexpr int kStage = Lay::kStage;
  constexpr int kRounds = Lay::kRounds, kHeld = Lay::kHeld;
  extern __shared__ __align__(16) float smem[];
  float4* s_da = reinterpret_cast<float4*>(smem);   // [kChunk][kThreads]
  float* s_stage = smem + Lay::kDa;                 // [2][kStage]
  float* s_sum = s_stage + 2 * kStage;              // [kRedBufs][kRed + kOut]

  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int c = tid / L, sub = tid % L;
  const int d0 = blockIdx.x * kChannels;
  const int d = d0 + c;
  const bool d_ok = d < d_inner;
  const int cols_ok = min(kChannels, d_inner - d0);
  const int64_t b = blockIdx.y;
  const int n_chunks = (seq + kChunk - 1) / kChunk;
  const int64_t xoff0 = b * seq * d_inner + d0;
  const int64_t noff0 = b * seq * n_state;

  float a2[kStates], g[kStates], dan[kStates], dacc[kStates];
#pragma unroll
  for (int r = 0; r < kStates; ++r) {
    const int n = sub * kStates + r;
    const bool ok = d_ok && n < n_state;
    a2[r] = ok ? a_mat[static_cast<int64_t>(d) * n_state + n] * kLog2e : 0.f;
    g[r] = (ok && dh_last != nullptr)
               ? dh_last[(b * d_inner + d) * n_state + n]
               : 0.f;
    dan[r] = 1.f;    // d h_last enters g_{S-1} as it is
    dacc[r] = 0.f;
  }
  __syncthreads();

  auto stage_chunk = [&](int k, int buf) {
    float* st = s_stage + buf * kStage;
    const int t0 = k * kChunk;
    const int64_t xoff = xoff0 + static_cast<int64_t>(t0) * d_inner;
    const int64_t noff = noff0 + static_cast<int64_t>(t0) * n_state;
    stage<kThreads, kChunk, kChannels>(st, xc + xoff, d_inner, seq - t0,
                                       cols_ok, vec_x);
    stage<kThreads, kChunk, kChannels>(st + kXs, dt + xoff, d_inner,
                                       seq - t0, cols_ok, vec_x);
    stage<kThreads, kChunk, kChannels>(st + 2 * kXs, dy + xoff, d_inner,
                                       seq - t0, cols_ok, vec_x);
    stage<kThreads, kChunk, kWidth>(st + 3 * kXs, bc + noff, n_state,
                                    seq - t0, n_state, vec_n);
    stage<kThreads, kChunk, kWidth>(st + 3 * kXs + kNs, cc + noff, n_state,
                                    seq - t0, n_state, vec_n);
    if (k > 0)        // chunk 0 enters from h_{-1} = 0
      stage<kThreads, kWidth, kChannels>(
          st + 3 * kXs + 2 * kNs,
          chunk_h + (static_cast<int64_t>(k) * batch + b) * n_state *
                        d_inner + d0,
          d_inner, n_state, cols_ok, vec_x);
  };

  stage_chunk(n_chunks - 1, 0);
  cp_async_commit();
  int q = 0;                  // sub-chunks done, for the sums' buffers
  for (int k = n_chunks - 1, buf = 0; k >= 0; --k, buf ^= 1) {
    cp_async_wait_all();
    __syncthreads();          // this chunk landed; the other was consumed
    if (k > 0) stage_chunk(k - 1, buf ^ 1);
    cp_async_commit();
    const float* st = s_stage + buf * kStage;
    const float* xs = st + c;
    const float* dts = st + kXs + c;
    const float* dys = st + 2 * kXs + c;
    const float* bs = st + 3 * kXs + sub * kStates;
    const float* cs = bs + kNs;
    const float* h0 = st + 3 * kXs + 2 * kNs + sub * kStates * kChannels + c;

    // 1. the chunk's dA_t into shared memory (this thread's own slots), and
    // the state entering each sub-chunk
    float ck[kSubs][kStates];
    {
      float h[kStates];
#pragma unroll
      for (int r = 0; r < kStates; ++r)
        h[r] = k > 0 ? h0[r * kChannels] : 0.f;
#pragma unroll
      for (int j = 0; j < kSubs; ++j) {
#pragma unroll
        for (int r = 0; r < kStates; ++r) ck[j][r] = h[r];
#pragma unroll
        for (int u = 0; u < kSub; ++u) {
          const int tt = j * kSub + u;
          const float dtv = dts[tt * kChannels];
          const float dtx = dtv * xs[tt * kChannels];
          float bn[kStates], da[kStates];
          load_states(bs + tt * kWidth, bn);
#pragma unroll
          for (int r = 0; r < kStates; ++r) {
            da[r] = ex2(dtv * a2[r]);
            h[r] = fmaf(da[r], h[r], dtx * bn[r]);
          }
          s_da[tt * kThreads + tid] = pack(da);
        }
      }
    }

    // 2. the sub-chunks, the last first
#pragma unroll
    for (int j = kSubs - 1; j >= 0; --j) {
      float hs[kSub][kStates], das[kSub][kStates];
      {
        float h[kStates];
#pragma unroll
        for (int r = 0; r < kStates; ++r) h[r] = ck[j][r];
#pragma unroll
        for (int u = 0; u < kSub; ++u) {
          const int tt = j * kSub + u;
          const float dtv = dts[tt * kChannels];
          const float dtx = dtv * xs[tt * kChannels];
          float bn[kStates];
          load_states(bs + tt * kWidth, bn);
          unpack(s_da[tt * kThreads + tid], das[u]);
#pragma unroll
          for (int r = 0; r < kStates; ++r) {
            h[r] = fmaf(das[u][r], h[r], dtx * bn[r]);
            hs[u][r] = h[r];
          }
        }
      }
      float* red = s_sum + (q % Lay::kRedBufs) * (Lay::kRed + Lay::kOut);
      float* out = red + Lay::kRed;   // [dxc, ddt][kSub][kChannels]
#pragma unroll
      for (int u = kSub - 1; u >= 0; --u) {
        const int tt = j * kSub + u;
        const float dtv = dts[tt * kChannels];
        const float xv = xs[tt * kChannels];
        const float dyv = dys[tt * kChannels];
        const float dtx = dtv * xv;
        float bn[kStates], cn[kStates], v[2 * kStates];
        load_states(bs + tt * kWidth, bn);
        load_states(cs + tt * kWidth, cn);
        float gb = 0.f, s2 = 0.f;
#pragma unroll
        for (int r = 0; r < kStates; ++r) {
          const float hp = u > 0 ? hs[u - 1][r] : ck[j][r];   // h_{t-1}
          g[r] = fmaf(dan[r], g[r], dyv * cn[r]);
          v[r] = g[r] * dtx;                     // d Bc term
          v[kStates + r] = dyv * hs[u][r];       // d Cc term
          gb = fmaf(g[r], bn[r], gb);
          const float uu = g[r] * das[u][r] * hp;
          s2 = fmaf(a2[r], uu, s2);
          dacc[r] = fmaf(uu, dtv, dacc[r]);
          dan[r] = das[u][r];
        }
#pragma unroll
        for (int off = L / 2; off > 0; off /= 2) {
          gb += __shfl_xor_sync(0xffffffffu, gb, off);
          s2 += __shfl_xor_sync(0xffffffffu, s2, off);
        }
        if (sub == 0) {
          out[u * kChannels + c] = dtv * gb;
          out[(kSub + u) * kChannels + c] = fmaf(xv, gb, s2 * kLn2);
        }
        warp_sum<L>(v, lane);
        if ((lane & Lay::kDupMask) == 0) {
          const int base = ((lane >> (5 - kRounds)) & ((1 << kRounds) - 1)) *
                           kHeld;
          float* w = red + (warp * kSub + u) * 2 * kWidth;
#pragma unroll
          for (int i = 0; i < kHeld; ++i) {
            const int e = base + i;          // kind * kStates + r
            w[(e / kStates) * kWidth + sub * kStates + e % kStates] = v[i];
          }
        }
      }
      __syncthreads();        // the sub-chunk's sums and rows are written

      const int t0 = k * kChunk + j * kSub;
      // the block's partial sums of d Bc and d Cc: (blocks, B, S, 2, N)
      float* part = part_bc + ((static_cast<int64_t>(blockIdx.x) * batch +
                                b) * seq + t0) * 2 * n_state;
      constexpr int kSums = kSub * 2 * kWidth;   // (step, kind, n) of red
#pragma unroll
      for (int i0 = 0; i0 < kSums; i0 += kThreads) {
        const int i = i0 + tid;
        const int u = i / (2 * kWidth), kind = i / kWidth % 2;
        const int n = i % kWidth;
        if ((kSums % kThreads == 0 || i < kSums) && n < n_state &&
            t0 + u < seq) {
          float s = 0.f;
#pragma unroll
          for (int w = 0; w < Lay::kWarps; ++w) s += red[w * kSums + i];
          part[(2 * u + kind) * n_state + n] = s;
        }
      }
      if (vec_x) {
        constexpr int kUnits = kChannels / 4;
#pragma unroll
        for (int i = tid; i < 2 * kSub * kUnits; i += kThreads) {
          const int row = i / kUnits, ch = i % kUnits * 4;
          const int u = row % kSub;
          if (t0 + u < seq && ch < cols_ok)
            store4((row < kSub ? dxc : ddt) + xoff0 +
                       static_cast<int64_t>(t0 + u) * d_inner + ch,
                   *reinterpret_cast<const float4*>(out + row * kChannels +
                                                    ch));
        }
      } else {
        for (int i = tid; i < 2 * kSub * kChannels; i += kThreads) {
          const int row = i / kChannels, ch = i - row * kChannels;
          const int u = row % kSub;
          if (t0 + u < seq && ch < cols_ok)
            put((row < kSub ? dxc : ddt) + xoff0 +
                    static_cast<int64_t>(t0 + u) * d_inner + ch,
                out[i]);
        }
      }
      if (Lay::kRedBufs == 1) __syncthreads();   // the buffer is read
      ++q;
    }
  }

  if (d_ok) {       // dA of this b: (B, N, Di)
#pragma unroll
    for (int r = 0; r < kStates; ++r) {
      const int n = sub * kStates + r;
      if (n < n_state)
        part_a[(b * n_state + n) * d_inner + d] = dacc[r];
    }
  }
}

// d Bc and d Cc: the blocks' partials summed in order; dA: the partials of
// the batch summed in order.  One thread an output.
template <typename T>
__global__ void selective_scan_bwd_sum(const float* __restrict__ part_bc,
                                       const float* __restrict__ part_a,
                                       T* __restrict__ dbc,
                                       T* __restrict__ dcc,
                                       float* __restrict__ da, int blocks,
                                       int batch, int seq, int d_inner,
                                       int n_state) {
  const int64_t n_bc = static_cast<int64_t>(batch) * seq * 2 * n_state;
  const int64_t n_a = static_cast<int64_t>(d_inner) * n_state;
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                   threadIdx.x;
       i < n_bc + n_a; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    if (i < n_bc) {
      float s = 0.f;
      for (int k = 0; k < blocks; ++k) s += part_bc[k * n_bc + i];
      const int64_t bt = i / (2 * n_state);
      const int rem = static_cast<int>(i - bt * 2 * n_state);
      const int kind = rem / n_state, n = rem - kind * n_state;
      put((kind == 0 ? dbc : dcc) + bt * n_state + n, s);
    } else {
      const int64_t j = i - n_bc;
      const int64_t dd = j / n_state;
      const int n = static_cast<int>(j - dd * n_state);
      float s = 0.f;
      for (int p = 0; p < batch; ++p)
        s += part_a[(static_cast<int64_t>(p) * n_state + n) * d_inner + dd];
      da[j] = s;
    }
  }
}

template <typename T, int L>
int launch_lanes(const T* xc, const T* dt, const T* bc, const T* cc,
                 const float* a, const T* dy, const float* dh_last,
                 const float* chunk_h, T* dxc, T* ddt, T* dbc, T* dcc,
                 float* da, float* scratch, int batch, int seq, int d_inner,
                 int n_state, cudaStream_t stream) {
  using Lay = Layout<L>;
  const int blocks = (d_inner + Lay::kChannels - 1) / Lay::kChannels;
  const auto up = [](int64_t x) { return (x + 63) / 64 * 64; };
  float* part_bc = scratch;
  float* part_a =
      part_bc + up(static_cast<int64_t>(blocks) * batch * seq * 2 * n_state);
  // units of 4 values: 16 bytes (f32, and the states) or 8 (bf16)
  const auto aligned = [](const void* p, size_t unit) {
    return reinterpret_cast<uintptr_t>(p) % unit == 0;
  };
  constexpr size_t kUnit = 4 * sizeof(T);
  const bool vec_x = d_inner % 4 == 0 && aligned(xc, kUnit) &&
                     aligned(dt, kUnit) && aligned(dy, kUnit) &&
                     aligned(chunk_h, 16) && aligned(dxc, kUnit) &&
                     aligned(ddt, kUnit);
  const bool vec_n = n_state % 4 == 0 && aligned(bc, kUnit) &&
                     aligned(cc, kUnit);
  auto kernel = selective_scan_bwd_kernel<T, L>;
  constexpr size_t smem = sizeof(float) * Lay::kFloats;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(blocks, batch), Lay::kThreads, smem, stream>>>(
      xc, dt, bc, cc, a, dy, dh_last, chunk_h, dxc, ddt, part_bc, part_a,
      batch, seq, d_inner, n_state, vec_x, vec_n);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t total = static_cast<int64_t>(batch) * seq * 2 * n_state +
                        static_cast<int64_t>(d_inner) * n_state;
  const int64_t want = (total + 255) / 256;
  const int sum_blocks = static_cast<int>(want < 65535 ? want : 65535);
  selective_scan_bwd_sum<T><<<sum_blocks, 256, 0, stream>>>(
      part_bc, part_a, dbc, dcc, da, blocks, batch, seq, d_inner, n_state);
  return static_cast<int>(cudaGetLastError());
}

// the least power of two L >= lanes, up to kMaxLanes
template <typename T, int L = 1>
int launch_bwd(const T* xc, const T* dt, const T* bc, const T* cc,
               const float* a, const T* dy, const float* dh_last,
               const float* chunk_h, T* dxc, T* ddt, T* dbc, T* dcc,
               float* da, float* scratch, int batch, int seq, int d_inner,
               int n_state, int lanes, cudaStream_t stream) {
  if constexpr (L < kMaxLanes) {
    if (lanes > L)
      return launch_bwd<T, 2 * L>(xc, dt, bc, cc, a, dy, dh_last, chunk_h,
                                  dxc, ddt, dbc, dcc, da, scratch, batch,
                                  seq, d_inner, n_state, lanes, stream);
  }
  return launch_lanes<T, L>(xc, dt, bc, cc, a, dy, dh_last, chunk_h, dxc,
                            ddt, dbc, dcc, da, scratch, batch, seq, d_inner,
                            n_state, stream);
}

template <typename T>
int launch_checked(const void* xc, const void* dt, const void* bc,
                   const void* cc, const void* a, const void* dy,
                   const void* dh_last, const void* chunk_h, void* dxc,
                   void* ddt, void* dbc, void* dcc, void* da, void* scratch,
                   int batch, int seq, int d_inner, int n_state,
                   void* stream) {
  if (n_state < 1 || n_state > kMaxState || seq < 1 || batch > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto t = [](const void* p) { return static_cast<const T*>(p); };
  const auto w = [](void* p) { return static_cast<T*>(p); };
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  return launch_bwd<T>(t(xc), t(dt), t(bc), t(cc), f(a), t(dy), f(dh_last),
                       f(chunk_h), w(dxc), w(ddt), w(dbc), w(dcc),
                       static_cast<float*>(da), static_cast<float*>(scratch),
                       batch, seq, d_inner, n_state,
                       (n_state + kStates - 1) / kStates,
                       static_cast<cudaStream_t>(stream));
}

// warps of the walk kernel resident on one SM: the runtime's occupancy for
// its block and shared memory at the least power of two L >= lanes
template <int L = 1>
int warps_per_sm(int lanes) {
  if constexpr (L < kMaxLanes) {
    if (lanes > L) return warps_per_sm<2 * L>(lanes);
  }
  using Lay = Layout<L>;
  auto kernel = selective_scan_bwd_kernel<float, L>;
  constexpr size_t smem = sizeof(float) * Lay::kFloats;
  int blocks = 0;
  if (cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem)) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, kernel, Lay::kThreads, smem) != cudaSuccess)
    return -1;
  return blocks * Lay::kWarps;
}

}  // namespace

extern "C" {

// The warps of the backward's walk kernel that one SM of the current
// device holds at once for n_state (1 .. 64), or -1 if the runtime cannot
// say.
int selective_scan_bwd_warps_per_sm(int n_state) {
  if (n_state < 1 || n_state > kMaxState) return -1;
  return warps_per_sm((n_state + kStates - 1) / kStates);
}


// xc, dt, dy, dxc, ddt: (batch, seq, d_inner); bc, cc, dbc, dcc: (batch,
// seq, n_state); a, da: (d_inner, n_state); dh_last: (batch, d_inner,
// n_state) or null (no gradient reaches the final state); chunk_h: the
// state entering each 32-step chunk, (ceil(seq / 32), batch, n_state,
// d_inner), as selective_scan_states_f32 writes it (chunk 0's is not
// read); all float32, row-major.  scratch: floats of the blocks' partials
// of dbc and dcc (blocks, batch, seq, 2, n_state), then dA's of each b
// (batch, n_state, d_inner) from a multiple of 64 floats; blocks =
// ceil(d_inner / C), C = 64 channels a block for n_state <= 16, 32 for
// n_state <= 32, 16 for n_state <= 64.  Two launches (the walk, the sums).
// Returns cudaGetLastError() after them (cudaErrorInvalidValue for
// n_state > 64, seq < 1 or batch > 65535, without launching).
int selective_scan_bwd_states_f32(const void* xc, const void* dt,
                                  const void* bc, const void* cc,
                                  const void* a, const void* dy,
                                  const void* dh_last, const void* chunk_h,
                                  void* dxc, void* ddt, void* dbc, void* dcc,
                                  void* da, void* scratch, int batch, int seq,
                                  int d_inner, int n_state, void* stream) {
  return launch_checked<float>(xc, dt, bc, cc, a, dy, dh_last, chunk_h,
                               dxc, ddt, dbc, dcc, da, scratch, batch, seq,
                               d_inner, n_state, stream);
}

// selective_scan_bwd_states_f32 of bfloat16 xc, dt, bc, cc, dy (a,
// dh_last, chunk_h and the scratch float32): dxc, ddt, dbc, dcc written in
// bfloat16, da in float32 (the notes at the top).
int selective_scan_bwd_states_bf16(const void* xc, const void* dt,
                                   const void* bc, const void* cc,
                                   const void* a, const void* dy,
                                   const void* dh_last, const void* chunk_h,
                                   void* dxc, void* ddt, void* dbc,
                                   void* dcc, void* da, void* scratch,
                                   int batch, int seq, int d_inner,
                                   int n_state, void* stream) {
  return launch_checked<__nv_bfloat16>(xc, dt, bc, cc, a, dy, dh_last,
                                       chunk_h, dxc, ddt, dbc, dcc, da,
                                       scratch, batch, seq, d_inner, n_state,
                                       stream);
}

}  // extern "C"
