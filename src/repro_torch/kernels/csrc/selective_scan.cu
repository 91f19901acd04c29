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
// exponentials bound it about equally, so the design keeps every other
// instruction off the critical pipes and the copies in flight.
//
// Design.  The TPU kernel keeps a (512, N) state tile in VMEM for each
// step of a (B, Di / 512) grid and walks S with a fori_loop.  Here the
// state lives in registers and the grid runs in parallel: each channel's
// N states are spread over L lanes of one warp, kStates = 16 states a
// lane (L = 1 at N = 16: 32,768 threads on the serving path, no shuffles).
// A block owns kChannels = 64 channels of one b and walks S in chunks of
// kChunk = 32 steps.  The chunks of xc and dt (32 rows of 64 contiguous
// channels) and of Bc and Cc (32 rows of N) are double-buffered in shared
// memory with cp.async, 16 bytes a copy, so chunk i + 1 is in flight while
// chunk i is computed (49,152 bytes a block at L = 1 in f32: 4 blocks, the
// whole grid of 512 blocks in one wave).  y is staged there too and stored
// in 16-byte units.  One step costs a lane, per state: an FMUL (dt * a2),
// one MUFU.EX2, an FMUL (dt x * B), and two FFMAs (the update and the
// product with C), with the loads of dt, x, B and C shared by 16 states.
// Measured on an H100 against other shapes of the same design, each of
// these was slower: 8 states a lane, y stored straight from the lanes,
// deeper pipelines of shorter chunks (16 x 3, 16 x 4, 8 x 8), and loading
// each step's dt, x, B and C during the step before.  h_last is written
// once at the end.  Any Di and S work: the
// ragged channels and lanes past N compute on zeros (their state stays 0)
// and store nothing; rows that are not whole 16-byte units (Di or N not a
// multiple of 16 bytes) take plain loads and stores in place of cp.async
// and 16-byte stores.  The Pallas kernel needed Di % 512 == 0.  Offsets are
// 64-bit (B S Di is 1.3e8 on the serving path).
//   For training, an instance of its own (selective_scan_states_f32) also
// writes the state entering each chunk, (n_chunks, B, N, Di), for the
// backward kernel (selective_scan_bwd.cu): at the end of a chunk each
// thread puts its states in a shared-memory tile, and after the chunk's
// barrier the block stores the tile in rows of 16-byte units beside y.
// Serving's instance does not write them, so its code is the one before.
// Measured at (1, 4096, 8192, 16) on "NVIDIA H100 80GB HBM3, 700.00 W"
// (scripts/bwd_sweep.py --ssm, in turns): 0.733-0.746 ms with the states
// against 0.646-0.662 without; at B = 1 (two warps an SM) the kernel moves
// its bytes at ~0.6 TB/s, so the states' 67 MB cost ~85 us, not the ~20 us
// of the card's rate (stores from registers, streaming stores and stores
// spread over the next chunk's steps were no faster).
//
// Numerics.  A is pre-scaled once per state, a2 = A log2(e) (rounded to
// f32), and dA = ex2.approx.ftz(dt a2): relative error ~2^-22 in dA beside
// the rounding of dt a2, where the plain version takes expf(dt A).  The
// update is one FMA, h = fma(dA, h, (dt x) B), and y sums fma(h, C, p) in
// two partial sums, in another order than the plain version's einsum.  dt x
// is rounded to the input type first, as the plain version computes it.
// Against the plain version the f32 result stays within atol 1e-5 and
// rtol 0.05 (tests/test_torch_mamba.py emulates these numerics on the
// CPU).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kStates = 16;    // states of one channel held by one lane
constexpr int kChannels = 64;  // channels of one block
constexpr int kChunk = 32;     // time steps staged in shared memory at once
// chunk buffers, kStages - 1 chunks in flight; deeper pipelines of shorter
// chunks were slower, and this loop ran ~15 % faster on an H100 than the
// same double buffer written with a toggled buffer index
constexpr int kStages = 2;
constexpr int kMaxState = 64;  // largest N
constexpr int kMaxLanes = kMaxState / kStates;   // lanes per channel
constexpr float kLog2e = 1.4426950408889634f;

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

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// kStates values of one row of B or C from shared memory, in f32
__device__ __forceinline__ void load_row(const float* p,
                                         float (&v)[kStates]) {
#pragma unroll
  for (int i = 0; i < kStates / 4; ++i) {
    const float4 w = reinterpret_cast<const float4*>(p)[i];
    v[4 * i] = w.x;
    v[4 * i + 1] = w.y;
    v[4 * i + 2] = w.z;
    v[4 * i + 3] = w.w;
  }
}
__device__ __forceinline__ void load_row(const __nv_bfloat16* p,
                                         float (&v)[kStates]) {
#pragma unroll
  for (int i = 0; i < kStates / 8; ++i) {
    const uint4 w = reinterpret_cast<const uint4*>(p)[i];
    const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      v[8 * i + 2 * j] = __uint_as_float(u[j] << 16);
      v[8 * i + 2 * j + 1] = __uint_as_float(u[j] & 0xffff0000u);
    }
  }
}

// kVec = 16 / sizeof(T) values of y from shared memory, one 16-byte store
__device__ __forceinline__ void store16(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = *reinterpret_cast<const float4*>(v);
}
__device__ __forceinline__ void store16(__nv_bfloat16* p, const float* v) {
  const float4 a = reinterpret_cast<const float4*>(v)[0];
  const float4 b = reinterpret_cast<const float4*>(v)[1];
  const __nv_bfloat162 w[4] = {
      __floats2bfloat162_rn(a.x, a.y), __floats2bfloat162_rn(a.z, a.w),
      __floats2bfloat162_rn(b.x, b.y), __floats2bfloat162_rn(b.z, b.w)};
  *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(w);
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
// all but the kStages - 1 latest commit groups have landed
__device__ __forceinline__ void cp_async_wait_stage() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 1) : "memory");
}


// rows [0, kChunk) x cols [0, cols) of src (row pitch src_pitch) into dst
// (row pitch dst_pitch); entries at rows >= rows_ok or cols >= cols_ok are
// zeros.  vec: cols, cols_ok and the pitches are whole 16-byte units and
// src is 16-byte aligned, so the copy is asynchronous; otherwise plain
// loads and stores.
template <int kThreads, typename T>
__device__ __forceinline__ void stage(T* dst, int dst_pitch, const T* src,
                                      int64_t src_pitch, int rows_ok,
                                      int cols, int cols_ok, bool vec) {
  if (vec) {
    constexpr int kVec = 16 / sizeof(T);
    const int per_row = cols / kVec;
    for (int i = threadIdx.x; i < kChunk * per_row; i += kThreads) {
      const int r = i / per_row, c = (i - r * per_row) * kVec;
      const bool ok = r < rows_ok && c < cols_ok;
      cp_async16(dst + r * dst_pitch + c, src + (ok ? r * src_pitch + c : 0),
                 ok ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < kChunk * cols; i += kThreads) {
      const int r = i / cols, c = i - r * cols;
      dst[r * dst_pitch + c] =
          r < rows_ok && c < cols_ok ? src[r * src_pitch + c] : T(0.f);
    }
  }
}

// the chunks of xc, dt, Bc and Cc, y's chunk, and with kSave the state
// tile [N padded][kChannels]
template <typename T, int L, bool kSave>
constexpr size_t smem_bytes() {
  return sizeof(T) * kStages * kChunk * (2 * kChannels + 2 * kStates * L) +
         sizeof(float) * (kChunk + (kSave ? kStates * L : 0)) * kChannels;
}

// Block: kChannels * L threads; thread c * L + lane holds states
// n = lane * kStates .. + kStates - 1 of channel d0 + c.  Grid: (Di / 64
// rounded up, B).  kSave: also write the state entering each chunk to
// chunk_h (selective_scan_states_kernel; serving's selective_scan_kernel
// is this body without it, its code the one before the states output).
template <typename T, int L, bool kSave>
__device__ __forceinline__ void scan_body(
    const T* __restrict__ xc, const T* __restrict__ dt,
    const T* __restrict__ bc, const T* __restrict__ cc,
    const float* __restrict__ a_mat, T* __restrict__ y,
    float* __restrict__ h_last, float* __restrict__ chunk_h, int batch,
    int seq, int d_inner, int n_state, bool vec_x, bool vec_n) {
  constexpr int kThreads = kChannels * L;
  constexpr int kWidth = L * kStates;            // N padded to the lanes
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int kXs = kChunk * kChannels;        // one chunk of xc or dt
  constexpr int kNs = kChunk * kWidth;           // one chunk of Bc or Cc
  T* s_x = reinterpret_cast<T*>(smem_raw);       // [kStages][kChunk][64]
  T* s_dt = s_x + kStages * kXs;                 // [kStages][kChunk][64]
  T* s_b = s_dt + kStages * kXs;                 // [kStages][kChunk][kWidth]
  T* s_c = s_b + kStages * kNs;                  // [kStages][kChunk][kWidth]
  float* s_y = reinterpret_cast<float*>(s_c + kStages * kNs);
  float* s_h = s_y + kChunk * kChannels;   // [kWidth][64], kSave only

  const int tid = threadIdx.x;
  const int c = tid / L;
  const int lane = tid % L;
  const int d0 = blockIdx.x * kChannels;
  const int d = d0 + c;
  const int cols_ok = min(kChannels, d_inner - d0);
  const int64_t b = blockIdx.y;
  const T* xb = xc + b * seq * d_inner + d0;
  const T* dtb = dt + b * seq * d_inner + d0;
  const T* bb = bc + b * seq * n_state;
  const T* cb = cc + b * seq * n_state;
  T* yb = y + b * seq * d_inner + d0;

  // the columns n >= N of B and C stay zero: no copy writes them
  {
    float4* p = reinterpret_cast<float4*>(s_b);
    const int n16 = static_cast<int>(sizeof(T) * 2 * kStages * kNs / 16);
    for (int i = tid; i < n16; i += kThreads)
      p[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  float a2[kStates], h[kStates];
#pragma unroll
  for (int r = 0; r < kStates; ++r) {
    const int n = lane * kStates + r;
    a2[r] = (d < d_inner && n < n_state)
                ? a_mat[static_cast<int64_t>(d) * n_state + n] * kLog2e
                : 0.f;
    h[r] = 0.f;
  }
  // kSave: the state entering chunk k, (n_chunks, B, N, Di), for the
  // backward, from the tile s_h (zeros for chunk 0) in rows, 16 bytes a
  // store where rows are whole 16-byte units
  auto save_states = [&](int k) {
    float* dst = chunk_h + (static_cast<int64_t>(k) * batch + b) * n_state *
                               d_inner + d0;
    if (vec_x) {
      for (int i = tid * 4; i < kWidth * kChannels; i += kThreads * 4) {
        const int n = i / kChannels, ch = i % kChannels;
        if (n < n_state && ch < cols_ok)
          *reinterpret_cast<float4*>(dst + static_cast<int64_t>(n) * d_inner +
                                     ch) =
              k == 0 ? make_float4(0.f, 0.f, 0.f, 0.f)
                     : *reinterpret_cast<const float4*>(s_h + i);
      }
    } else {
      for (int i = tid; i < kWidth * kChannels; i += kThreads) {
        const int n = i / kChannels, ch = i % kChannels;
        if (n < n_state && ch < cols_ok)
          dst[static_cast<int64_t>(n) * d_inner + ch] = k == 0 ? 0.f : s_h[i];
      }
    }
  };
  __syncthreads();

  auto stage_chunk = [&](int t0, int buf) {
    const int rows_ok = seq - t0;
    const int64_t xoff = static_cast<int64_t>(t0) * d_inner;
    const int64_t noff = static_cast<int64_t>(t0) * n_state;
    stage<kThreads>(s_x + buf * kXs, kChannels, xb + xoff, d_inner, rows_ok,
                    kChannels, cols_ok, vec_x);
    stage<kThreads>(s_dt + buf * kXs, kChannels, dtb + xoff, d_inner,
                    rows_ok, kChannels, cols_ok, vec_x);
    stage<kThreads>(s_b + buf * kNs, kWidth, bb + noff, n_state, rows_ok,
                    n_state, n_state, vec_n);
    stage<kThreads>(s_c + buf * kNs, kWidth, cb + noff, n_state, rows_ok,
                    n_state, n_state, vec_n);
  };

  // one commit group per chunk (empty past S), so that waiting for all but
  // the kStages - 1 latest groups means: this chunk has landed
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i * kChunk < seq) stage_chunk(i * kChunk, i);
    cp_async_commit();
  }
  for (int t0 = 0, buf = 0; t0 < seq; t0 += kChunk) {
    // the buffer of the chunk kStages - 1 ahead was consumed last iteration
    const int ahead = t0 + (kStages - 1) * kChunk;
    if (ahead < seq) stage_chunk(ahead, (buf + kStages - 1) % kStages);
    cp_async_commit();
    cp_async_wait_stage();
    __syncthreads();

    const int steps = min(kChunk, seq - t0);
    const T* xs = s_x + buf * kXs + c;
    const T* dts = s_dt + buf * kXs + c;
    const T* bs = s_b + buf * kNs + lane * kStates;
    const T* cs = s_c + buf * kNs + lane * kStates;
#pragma unroll 2
    for (int tt = 0; tt < steps; ++tt) {
      const float dtv = to_f32(dts[tt * kChannels]);
      const float dtx = round_as(dtv * to_f32(xs[tt * kChannels]), xc);
      float bn[kStates], cn[kStates];
      load_row(bs + tt * kWidth, bn);
      load_row(cs + tt * kWidth, cn);
      float p[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < kStates; ++r) {
        const float da = ex2(dtv * a2[r]);
        h[r] = fmaf(da, h[r], dtx * bn[r]);
        p[r & 1] = fmaf(h[r], cn[r], p[r & 1]);
      }
      float pr = p[0] + p[1];
#pragma unroll
      for (int off = L / 2; off > 0; off /= 2)
        pr += __shfl_xor_sync(0xffffffffu, pr, off);
      if (lane == 0) s_y[tt * kChannels + c] = pr;
    }
    if constexpr (kSave) {   // the state entering the next chunk
#pragma unroll
      for (int r = 0; r < kStates; ++r)
        s_h[(lane * kStates + r) * kChannels + c] = h[r];
    }
    __syncthreads();         // s_y is complete; this buffer is consumed

    if constexpr (kSave) {
      if (t0 == 0) save_states(0);
      if (t0 + kChunk < seq) save_states(t0 / kChunk + 1);
    }

    if (vec_x) {             // rows of y are whole 16-byte units too
      constexpr int kVec = 16 / sizeof(T);
#pragma unroll 4
      for (int i = tid * kVec; i < kChunk * kChannels; i += kThreads * kVec) {
        const int tt = i / kChannels, ch = i % kChannels;
        if (tt < steps && ch < cols_ok)
          store16(yb + static_cast<int64_t>(t0 + tt) * d_inner + ch, s_y + i);
      }
    } else {
#pragma unroll 8
      for (int i = tid; i < kChunk * kChannels; i += kThreads) {
        const int tt = i / kChannels, ch = i % kChannels;
        if (tt < steps && ch < cols_ok)
          store(yb + static_cast<int64_t>(t0 + tt) * d_inner + ch, s_y[i]);
      }
    }
    buf = (buf + 1) % kStages;   // s_y is written again after a barrier
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
__global__ void __launch_bounds__(kChannels * L)
selective_scan_kernel(const T* __restrict__ xc, const T* __restrict__ dt,
                      const T* __restrict__ bc, const T* __restrict__ cc,
                      const float* __restrict__ a_mat, T* __restrict__ y,
                      float* __restrict__ h_last, int seq, int d_inner,
                      int n_state, bool vec_x, bool vec_n) {
  scan_body<T, L, false>(xc, dt, bc, cc, a_mat, y, h_last, nullptr, 0, seq,
                         d_inner, n_state, vec_x, vec_n);
}

template <typename T, int L>
__global__ void __launch_bounds__(kChannels * L)
selective_scan_states_kernel(const T* __restrict__ xc,
                             const T* __restrict__ dt,
                             const T* __restrict__ bc,
                             const T* __restrict__ cc,
                             const float* __restrict__ a_mat,
                             T* __restrict__ y, float* __restrict__ h_last,
                             float* __restrict__ chunk_h, int batch,
                             int seq, int d_inner, int n_state, bool vec_x,
                             bool vec_n) {
  scan_body<T, L, true>(xc, dt, bc, cc, a_mat, y, h_last, chunk_h, batch,
                        seq, d_inner, n_state, vec_x, vec_n);
}

template <typename T, int L, bool kSave>
int launch_kernel(const void* xc, const void* dt, const void* bc,
                  const void* cc, const void* a, void* y, void* h_last,
                  void* chunk_h, int batch, int seq, int d_inner,
                  int n_state, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<T, L, kSave>();
  const auto allow_smem = [](auto kernel) {
    return smem > 48 * 1024
               ? cudaFuncSetAttribute(
                     kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                     static_cast<int>(smem))
               : cudaSuccess;
  };
  constexpr int kVec = 16 / sizeof(T);
  const auto aligned = [](const void* p, const void* q) {
    return (reinterpret_cast<uintptr_t>(p) | reinterpret_cast<uintptr_t>(q))
           % 16 == 0;
  };
  const bool vec_x = d_inner % kVec == 0 && aligned(xc, dt) &&
                     aligned(y, kSave ? chunk_h : y);
  const bool vec_n = n_state % kVec == 0 && aligned(bc, cc);
  const dim3 grid((d_inner + kChannels - 1) / kChannels, batch);
  const auto x = static_cast<const T*>(xc);
  const auto t = static_cast<const T*>(dt);
  const auto b = static_cast<const T*>(bc);
  const auto c = static_cast<const T*>(cc);
  const auto af = static_cast<const float*>(a);
  cudaError_t err;
  if constexpr (kSave) {
    auto kernel = selective_scan_states_kernel<T, L>;
    if ((err = allow_smem(kernel)) != cudaSuccess)
      return static_cast<int>(err);
    kernel<<<grid, kChannels * L, smem, stream>>>(
        x, t, b, c, af, static_cast<T*>(y), static_cast<float*>(h_last),
        static_cast<float*>(chunk_h), batch, seq, d_inner, n_state, vec_x,
        vec_n);
  } else {
    auto kernel = selective_scan_kernel<T, L>;
    if ((err = allow_smem(kernel)) != cudaSuccess)
      return static_cast<int>(err);
    kernel<<<grid, kChannels * L, smem, stream>>>(
        x, t, b, c, af, static_cast<T*>(y), static_cast<float*>(h_last), seq,
        d_inner, n_state, vec_x, vec_n);
  }
  return static_cast<int>(cudaGetLastError());
}

// chunk_h selects the instance that writes the states
template <typename T, int L>
int launch_lanes(const void* xc, const void* dt, const void* bc,
                 const void* cc, const void* a, void* y, void* h_last,
                 void* chunk_h, int batch, int seq, int d_inner, int n_state,
                 cudaStream_t stream) {
  if (chunk_h == nullptr)
    return launch_kernel<T, L, false>(xc, dt, bc, cc, a, y, h_last, chunk_h,
                                      batch, seq, d_inner, n_state, stream);
  return launch_kernel<T, L, true>(xc, dt, bc, cc, a, y, h_last, chunk_h,
                                   batch, seq, d_inner, n_state, stream);
}

// the least power of two L >= lanes, up to kMaxLanes
template <typename T, int L = 1>
int launch_scan(const void* xc, const void* dt, const void* bc,
                const void* cc, const void* a, void* y, void* h_last,
                void* chunk_h, int batch, int seq, int d_inner, int n_state,
                int lanes, cudaStream_t stream) {
  if constexpr (L < kMaxLanes) {
    if (lanes > L)
      return launch_scan<T, 2 * L>(xc, dt, bc, cc, a, y, h_last, chunk_h,
                                   batch, seq, d_inner, n_state, lanes,
                                   stream);
  }
  return launch_lanes<T, L>(xc, dt, bc, cc, a, y, h_last, chunk_h, batch,
                            seq, d_inner, n_state, stream);
}

template <typename T>
int launch(const void* xc, const void* dt, const void* bc, const void* cc,
           const void* a, void* y, void* h_last, void* chunk_h, int batch,
           int seq, int d_inner, int n_state, void* stream) {
  if (n_state > kMaxState) return static_cast<int>(cudaErrorInvalidValue);
  return launch_scan<T>(xc, dt, bc, cc, a, y, h_last, chunk_h, batch, seq,
                        d_inner, n_state, (n_state + kStates - 1) / kStates,
                        static_cast<cudaStream_t>(stream));
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
  return launch<float>(xc, dt, bc, cc, a, y, h_last, nullptr, batch, seq,
                       d_inner, n_state, stream);
}

// selective_scan_f32 that also writes the state entering each chunk of
// kChunk = 32 steps to chunk_h, (ceil(seq / 32), batch, n_state, d_inner)
// f32 (chunk 0's is zero), for the backward kernel
// (selective_scan_bwd.cu).  y and h_last are bit for bit those of
// selective_scan_f32: only the stores differ.
int selective_scan_states_f32(const void* xc, const void* dt, const void* bc,
                              const void* cc, const void* a, void* y,
                              void* h_last, void* chunk_h, int batch,
                              int seq, int d_inner, int n_state,
                              void* stream) {
  return launch<float>(xc, dt, bc, cc, a, y, h_last, chunk_h, batch, seq,
                       d_inner, n_state, stream);
}

int selective_scan_bf16(const void* xc, const void* dt, const void* bc,
                        const void* cc, const void* a, void* y, void* h_last,
                        int batch, int seq, int d_inner, int n_state,
                        void* stream) {
  return launch<__nv_bfloat16>(xc, dt, bc, cc, a, y, h_last, nullptr, batch,
                               seq, d_inner, n_state, stream);
}

// selective_scan_bf16 that also writes the chunk states (float32, as
// selective_scan_states_f32 lays them out), for training at bfloat16:
// y and h_last bit for bit selective_scan_bf16's.
int selective_scan_states_bf16(const void* xc, const void* dt,
                               const void* bc, const void* cc, const void* a,
                               void* y, void* h_last, void* chunk_h,
                               int batch, int seq, int d_inner, int n_state,
                               void* stream) {
  return launch<__nv_bfloat16>(xc, dt, bc, cc, a, y, h_last, chunk_h, batch,
                               seq, d_inner, n_state, stream);
}

}  // extern "C"
