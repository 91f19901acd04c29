// Backward of the Mamba-1 selective scan (falcon-mamba-7b) for Hopper,
// sm_90a, float32, with a plain C interface loaded through ctypes.
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
// 671 MB, a ~0.20 ms bound at 3.35 TB/s (Bc, Cc, A and the small outputs
// add ~2 MB).  It takes at least one exponential a (b, t, d, n), 5.4e8,
// ~0.13 ms at 16 a clock on 132 SMs, and ~18 flops a (b, t, d, n) with the
// states' recomputation, ~0.15 ms at 67 TFLOP/s.  So bytes bound it, with
// the exponentials close behind.
//
// Design.  The states are needed backward in time, and the recurrence is
// not inverted (h_{t-1} = (h_t - dBx_t) / dA_t divides by dA_t, which is 0
// wherever dt |A| is large).  The kernel runs its own forward first: one
// block owns kThreads / L channels of one b (a channel's N states over L
// lanes, kStates = 16 a lane, as in the forward kernel; L = 1 at N = 16)
// and walks S forward in chunks of kChunk = 32 steps, writing the state
// that enters each chunk to scratch (67 MB at the training shape), then
// walks the chunks backward: each chunk's states are recomputed from its
// entry state into shared memory (128 KB a block), then walked back with
// g, dA_{t+1} and h_t in registers.  Both walks compute a state exactly as
// selective_scan.cu does (dA_t = ex2.approx.ftz(dt a2) with a2 = A log2 e
// rounded to f32, then one FMA), so the states are the forward's bit for
// bit and dA_t is what the forward used; d dA_t / d dt = dA_t a2 ln 2 and
// d dA_t / d A = dA_t dt.  The chunks of xc, dt, dy, Bc and Cc are copied
// to shared memory with cp.async in 16-byte units (double-buffered in the
// forward walk; in the backward walk the copy of the next chunk overlaps
// the stores of this one), and dxc and ddt leave it in rows.
//   Sums across channels (dBc, dCc) and the batch (dA) use no atomics.
// Each step, a warp reduces its 32 channels' 16 dBc and 16 dCc terms with
// a butterfly that halves the values a lane holds each round (31 shuffles
// for 32 sums at L = 1; lane l ends with sum l); the two warps' sums are
// added in shared memory and written as the block's partial, (Di / 64, B,
// S, 2, N) floats (33.5 MB each for dBc and dCc at the training shape), and
// each thread's dA over its b's steps goes to a (B, N, Di) partial.  A
// second kernel sums the partials over the blocks (and dA over b) in a
// fixed order, so two calls give the same bits.
//   The grid is small at B = 1: 64 channels a block give 128 blocks of 64
// threads for 132 SMs, one block an SM (its shared memory is 184 KB), two
// warps an SM, so each warp's latency shows; fewer channels a block would
// fill more SMs but write more partials.
//   Any B, S, Di and N <= 64: channels past Di and states past N compute
// on zeros and store nothing; rows that are not whole 16-byte units take
// plain loads in place of cp.async.  Offsets are 64-bit.
//
// Numerics.  Sums run in another order than the plain version's (the
// butterfly over a warp's channels, then the two warps, then the blocks in
// order; dA over t backward, then b), on FMAs; each gradient stays within
// 1e-4 of its largest entry of the plain version
// (tests/test_torch_mamba_grad.py emulates these numerics on the CPU).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kStates = 16;    // states of one channel held by one lane
constexpr int kThreads = 64;   // threads of one block (two warps)
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 32;     // time steps staged in shared memory at once
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
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// rows [0, kChunk) x cols [0, cols) of src (row pitch src_pitch) into dst
// (row pitch dst_pitch); entries at rows >= rows_ok or cols >= cols_ok are
// zeros.  vec: cols, cols_ok and the pitches are whole 16-byte units and
// src is 16-byte aligned, so the copy is asynchronous; otherwise plain
// loads and stores.
__device__ __forceinline__ void stage(float* dst, int dst_pitch,
                                      const float* src, int64_t src_pitch,
                                      int rows_ok, int cols, int cols_ok,
                                      bool vec) {
  if (vec) {
    const int per_row = cols / 4;
    for (int i = threadIdx.x; i < kChunk * per_row; i += kThreads) {
      const int r = i / per_row, c = (i - r * per_row) * 4;
      const bool ok = r < rows_ok && c < cols_ok;
      cp_async16(dst + r * dst_pitch + c, src + (ok ? r * src_pitch + c : 0),
                 ok ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < kChunk * cols; i += kThreads) {
      const int r = i / cols, c = i - r * cols;
      dst[r * dst_pitch + c] =
          r < rows_ok && c < cols_ok ? src[r * src_pitch + c] : 0.f;
    }
  }
}

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

// Sums v[i] over the lanes of a warp that share lane % L, for all 32 i,
// halving the values a lane holds each round: after the rounds of masks
// M = 16, 8, .., L, v[j] (j < L) holds the sum of entry (lane & ~(L - 1))
// + j.  A round is a template instance, so every index is a constant and
// v stays in registers.
template <int L, int M = 16>
__device__ __forceinline__ void reduce_scatter(float (&v)[32], int lane) {
  if constexpr (M >= L) {
    const bool up = (lane & M) != 0;
#pragma unroll
    for (int i = 0; i < M; ++i) {
      const float send = up ? v[i] : v[i + M];
      const float keep = up ? v[i + M] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, M);
    }
    reduce_scatter<L, M / 2>(v, lane);
  }
}

template <int L>
struct Layout {
  static constexpr int kChannels = kThreads / L;   // channels of a block
  static constexpr int kWidth = L * kStates;       // N padded to the lanes
  static constexpr int kXs = kChunk * kChannels;   // a chunk of xc, dt, dy
  static constexpr int kNs = kChunk * kWidth;      // a chunk of Bc or Cc
  static constexpr int kHs = kChunk * kThreads * kStates;   // the states
  static constexpr int kRed = kWarps * kChunk * 32 * L;     // warp sums
  // x, dt, dy, dxc, ddt; Bc, Cc; the states; the warp sums (floats)
  static constexpr int kFloats = 5 * kXs + 2 * kNs + kHs + kRed;
  // the forward walk's two stages of x, dt and Bc live in the states' room
  static_assert(2 * (2 * kXs + kNs) <= kHs, "forward stages do not fit");
};

// Block: kThreads threads; thread c * L + sub holds states n = sub * 16 ..
// + 15 of channel d0 + c.  Grid: (Di / kChannels rounded up, B).
template <int L>
__global__ void __launch_bounds__(kThreads)
selective_scan_bwd_kernel(const float* __restrict__ xc,
                          const float* __restrict__ dt,
                          const float* __restrict__ bc,
                          const float* __restrict__ cc,
                          const float* __restrict__ a_mat,
                          const float* __restrict__ dy,
                          const float* __restrict__ dh_last,
                          float* __restrict__ dxc, float* __restrict__ ddt,
                          float* chunk_h, float* __restrict__ part_bc,
                          float* __restrict__ part_a, int batch, int seq,
                          int d_inner, int n_state, bool vec_x, bool vec_n) {
  using Lay = Layout<L>;
  constexpr int kChannels = Lay::kChannels, kWidth = Lay::kWidth;
  constexpr int kXs = Lay::kXs, kNs = Lay::kNs;
  extern __shared__ __align__(16) float smem[];
  float* s_x = smem;                   // [kChunk][kChannels]
  float* s_dt = s_x + kXs;
  float* s_dy = s_dt + kXs;
  float* s_dx = s_dy + kXs;
  float* s_ddt = s_dx + kXs;
  float* s_b = s_ddt + kXs;            // [kChunk][kWidth]
  float* s_c = s_b + kNs;
  float4* s_h = reinterpret_cast<float4*>(s_c + kNs);  // [kChunk][4][kThreads]
  float* s_red = s_c + kNs + Lay::kHs; // [kWarps][kChunk][L][32]
  // the forward walk's stages: [2][x, dt, Bc], in the states' room
  float* f_stage = s_c + kNs;
  constexpr int kStage = 2 * kXs + kNs;

  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int c = tid / L, sub = tid % L;
  const int d0 = blockIdx.x * kChannels;
  const int d = d0 + c;
  const bool d_ok = d < d_inner;
  const int cols_ok = min(kChannels, d_inner - d0);
  const int64_t b = blockIdx.y;
  const int64_t xoff0 = b * seq * d_inner + d0;
  const int64_t noff0 = b * seq * n_state;
  const int n_chunks = (seq + kChunk - 1) / kChunk;

  // the columns n >= N of every B and C buffer stay zero
  for (int i = tid; i < 2 * kNs; i += kThreads) s_b[i] = 0.f;
  for (int s = 0; s < 2; ++s)
    for (int i = tid; i < kNs; i += kThreads)
      f_stage[s * kStage + 2 * kXs + i] = 0.f;

  float a2[kStates], h[kStates];
#pragma unroll
  for (int r = 0; r < kStates; ++r) {
    const int n = sub * kStates + r;
    a2[r] = (d_ok && n < n_state)
                ? a_mat[static_cast<int64_t>(d) * n_state + n] * kLog2e
                : 0.f;
    h[r] = 0.f;
  }
  __syncthreads();

  // where chunk k's entry state of (b, d, n) lives: (n_chunks, B, N, Di)
  auto chunk_at = [&](int k, int n) {
    return chunk_h + ((static_cast<int64_t>(k) * batch + b) * n_state + n) *
                         d_inner + d;
  };

  // ---- forward walk: the states entering chunks 1 .. n_chunks - 1 ------
  auto stage_fwd = [&](int k, int buf) {
    float* st = f_stage + buf * kStage;
    const int t0 = k * kChunk;
    const int64_t xoff = xoff0 + static_cast<int64_t>(t0) * d_inner;
    stage(st, kChannels, xc + xoff, d_inner, seq - t0, kChannels, cols_ok,
          vec_x);
    stage(st + kXs, kChannels, dt + xoff, d_inner, seq - t0, kChannels,
          cols_ok, vec_x);
    stage(st + 2 * kXs, kWidth, bc + noff0 + static_cast<int64_t>(t0) *
          n_state, n_state, seq - t0, n_state, n_state, vec_n);
  };
  const int n_fwd = n_chunks - 1;      // the last chunk's exit is not needed
  if (n_fwd > 0) stage_fwd(0, 0);
  cp_async_commit();
  for (int k = 0; k < n_fwd; ++k) {
    if (k + 1 < n_fwd) stage_fwd(k + 1, (k + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float* st = f_stage + (k & 1) * kStage;
    const float* xs = st + c;
    const float* dts = st + kXs + c;
    const float* bs = st + 2 * kXs + sub * kStates;
#pragma unroll 2
    for (int tt = 0; tt < kChunk; ++tt) {      // every step of k < n_fwd
      const float dtv = dts[tt * kChannels];
      const float dtx = dtv * xs[tt * kChannels];
      float bn[kStates];
      load_row(bs + tt * kWidth, bn);
#pragma unroll
      for (int r = 0; r < kStates; ++r)
        h[r] = fmaf(ex2(dtv * a2[r]), h[r], dtx * bn[r]);
    }
    if (d_ok) {
#pragma unroll
      for (int r = 0; r < kStates; ++r) {
        const int n = sub * kStates + r;
        if (n < n_state) *chunk_at(k + 1, n) = h[r];
      }
    }
    __syncthreads();          // this stage is consumed
  }

  // ---- backward walk, the last chunk first ------------------------------
  auto stage_bwd = [&](int k) {
    const int t0 = k * kChunk;
    const int64_t xoff = xoff0 + static_cast<int64_t>(t0) * d_inner;
    const int64_t noff = noff0 + static_cast<int64_t>(t0) * n_state;
    stage(s_x, kChannels, xc + xoff, d_inner, seq - t0, kChannels, cols_ok,
          vec_x);
    stage(s_dt, kChannels, dt + xoff, d_inner, seq - t0, kChannels, cols_ok,
          vec_x);
    stage(s_dy, kChannels, dy + xoff, d_inner, seq - t0, kChannels, cols_ok,
          vec_x);
    stage(s_b, kWidth, bc + noff, n_state, seq - t0, n_state, n_state,
          vec_n);
    stage(s_c, kWidth, cc + noff, n_state, seq - t0, n_state, n_state,
          vec_n);
  };

  // g_t, dA_{t+1} (1 past the end: g_{S-1} = dy C + d h_last), h_t and the
  // running dA of this thread's states
  float g[kStates], dan[kStates], hc[kStates], dacc[kStates];
#pragma unroll
  for (int r = 0; r < kStates; ++r) {
    const int n = sub * kStates + r;
    g[r] = (dh_last != nullptr && d_ok && n < n_state)
               ? dh_last[(b * d_inner + d) * n_state + n]
               : 0.f;
    dan[r] = 1.f;
    dacc[r] = 0.f;
  }

  __syncthreads();            // the forward walk's stages are consumed
  stage_bwd(n_chunks - 1);
  cp_async_commit();
  for (int k = n_chunks - 1; k >= 0; --k) {
    const int t0 = k * kChunk;
    const int steps = min(kChunk, seq - t0);
    cp_async_wait<0>();
    __syncthreads();

    // recompute the chunk's states from its entry state; s_h[tt] holds
    // h_{t0 + tt - 1}, each thread's own
#pragma unroll
    for (int r = 0; r < kStates; ++r) {
      const int n = sub * kStates + r;
      h[r] = (k > 0 && d_ok && n < n_state) ? *chunk_at(k, n) : 0.f;
    }
    const float* xs = s_x + c;
    const float* dts = s_dt + c;
    const float* dys = s_dy + c;
    const float* bs = s_b + sub * kStates;
    const float* cs = s_c + sub * kStates;
#pragma unroll 2
    for (int tt = 0; tt < steps; ++tt) {
      float4* hp = s_h + tt * 4 * kThreads + tid;
#pragma unroll
      for (int q = 0; q < 4; ++q)
        hp[q * kThreads] = make_float4(h[4 * q], h[4 * q + 1], h[4 * q + 2],
                                       h[4 * q + 3]);
      const float dtv = dts[tt * kChannels];
      const float dtx = dtv * xs[tt * kChannels];
      float bn[kStates];
      load_row(bs + tt * kWidth, bn);
#pragma unroll
      for (int r = 0; r < kStates; ++r)
        h[r] = fmaf(ex2(dtv * a2[r]), h[r], dtx * bn[r]);
    }
#pragma unroll
    for (int r = 0; r < kStates; ++r) hc[r] = h[r];

    for (int tt = steps - 1; tt >= 0; --tt) {
      const float dtv = dts[tt * kChannels];
      const float xv = xs[tt * kChannels];
      const float dyv = dys[tt * kChannels];
      const float dtx = dtv * xv;
      float bn[kStates], cn[kStates], hp[kStates];
      load_row(bs + tt * kWidth, bn);
      load_row(cs + tt * kWidth, cn);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float4 w = s_h[(tt * 4 + q) * kThreads + tid];
        hp[4 * q] = w.x;
        hp[4 * q + 1] = w.y;
        hp[4 * q + 2] = w.z;
        hp[4 * q + 3] = w.w;
      }
      float v[32];
      float gb[2] = {0.f, 0.f}, s2[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < kStates; ++r) {
        const float da = ex2(dtv * a2[r]);
        g[r] = fmaf(dan[r], g[r], dyv * cn[r]);
        v[r] = g[r] * dtx;                     // d Bc term
        v[kStates + r] = dyv * hc[r];          // d Cc term
        gb[r & 1] = fmaf(g[r], bn[r], gb[r & 1]);
        const float u = g[r] * da * hp[r];
        s2[r & 1] = fmaf(a2[r], u, s2[r & 1]);
        dacc[r] = fmaf(u, dtv, dacc[r]);
        dan[r] = da;
        hc[r] = hp[r];
      }
      float sgb = gb[0] + gb[1], ss2 = s2[0] + s2[1];
#pragma unroll
      for (int off = L / 2; off > 0; off /= 2) {
        sgb += __shfl_xor_sync(0xffffffffu, sgb, off);
        ss2 += __shfl_xor_sync(0xffffffffu, ss2, off);
      }
      if (sub == 0) {
        s_dx[tt * kChannels + c] = dtv * sgb;
        s_ddt[tt * kChannels + c] = fmaf(xv, sgb, ss2 * kLn2);
      }
      reduce_scatter<L>(v, lane);
      float* red = s_red + ((warp * kChunk + tt) * L + sub) * 32 +
                   (lane & ~(L - 1));
#pragma unroll
      for (int j = 0; j < L; ++j) red[j] = v[j];
    }
    __syncthreads();          // the chunk is consumed; its sums are written

    if (k > 0) stage_bwd(k - 1);
    cp_async_commit();
    for (int i = tid; i < steps * kChannels; i += kThreads) {
      const int tt = i / kChannels, ch = i - tt * kChannels;
      if (ch < cols_ok) {
        const int64_t o = xoff0 + static_cast<int64_t>(t0 + tt) * d_inner + ch;
        dxc[o] = s_dx[i];
        ddt[o] = s_ddt[i];
      }
    }
    // the block's partial sums of d Bc and d Cc: (blocks, B, S, 2, N)
    float* part = part_bc + ((static_cast<int64_t>(blockIdx.x) * batch + b) *
                                 seq + t0) * 2 * n_state;
    for (int i = tid; i < steps * 2 * n_state; i += kThreads) {
      const int tt = i / (2 * n_state), rem = i - tt * 2 * n_state;
      const int kind = rem / n_state, n = rem - kind * n_state;
      const int item = kind * kStates + n % kStates, sb = n / kStates;
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w)
        s += s_red[((w * kChunk + tt) * L + sb) * 32 + item];
      part[i] = s;
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

// d Bc and d Cc: the blocks' partials summed in order; dA: the batch's
// partials summed in order.  One thread an output.
__global__ void selective_scan_bwd_sum(const float* __restrict__ part_bc,
                                       const float* __restrict__ part_a,
                                       float* __restrict__ dbc,
                                       float* __restrict__ dcc,
                                       float* __restrict__ da, int blocks,
                                       int batch, int seq, int d_inner,
                                       int n_state) {
  const int64_t n_bc = static_cast<int64_t>(batch) * seq * 2 * n_state;
  const int64_t total = n_bc + static_cast<int64_t>(d_inner) * n_state;
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                   threadIdx.x;
       i < total; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    if (i < n_bc) {
      float s = 0.f;
      for (int k = 0; k < blocks; ++k) s += part_bc[k * n_bc + i];
      const int64_t bt = i / (2 * n_state);
      const int rem = static_cast<int>(i - bt * 2 * n_state);
      const int kind = rem / n_state, n = rem - kind * n_state;
      (kind == 0 ? dbc : dcc)[bt * n_state + n] = s;
    } else {
      const int64_t j = i - n_bc;
      const int64_t dd = j / n_state;
      const int n = static_cast<int>(j - dd * n_state);
      float s = 0.f;
      for (int bb = 0; bb < batch; ++bb)
        s += part_a[(static_cast<int64_t>(bb) * n_state + n) * d_inner + dd];
      da[j] = s;
    }
  }
}

template <int L>
int launch_lanes(const float* xc, const float* dt, const float* bc,
                 const float* cc, const float* a, const float* dy,
                 const float* dh_last, float* dxc, float* ddt, float* dbc,
                 float* dcc, float* da, float* scratch, int batch, int seq,
                 int d_inner, int n_state, cudaStream_t stream) {
  using Lay = Layout<L>;
  auto kernel = selective_scan_bwd_kernel<L>;
  constexpr size_t smem = sizeof(float) * Lay::kFloats;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (d_inner + Lay::kChannels - 1) / Lay::kChannels;
  const int n_chunks = (seq + kChunk - 1) / kChunk;
  const auto up = [](int64_t x) { return (x + 63) / 64 * 64; };
  const int64_t bdn = static_cast<int64_t>(batch) * d_inner * n_state;
  float* chunk_h = scratch;
  float* part_bc = chunk_h + up(n_chunks * bdn);
  float* part_a =
      part_bc + up(static_cast<int64_t>(blocks) * batch * seq * 2 * n_state);
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const bool vec_x = d_inner % 4 == 0 && aligned(xc) && aligned(dt) &&
                     aligned(dy);
  const bool vec_n = n_state % 4 == 0 && aligned(bc) && aligned(cc);
  kernel<<<dim3(blocks, batch), kThreads, smem, stream>>>(
      xc, dt, bc, cc, a, dy, dh_last, dxc, ddt, chunk_h, part_bc, part_a,
      batch, seq, d_inner, n_state, vec_x, vec_n);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t total = static_cast<int64_t>(batch) * seq * 2 * n_state +
                        static_cast<int64_t>(d_inner) * n_state;
  const int64_t want = (total + 255) / 256;
  const int sum_blocks = static_cast<int>(want < 65535 ? want : 65535);
  selective_scan_bwd_sum<<<sum_blocks, 256, 0, stream>>>(
      part_bc, part_a, dbc, dcc, da, blocks, batch, seq, d_inner, n_state);
  return static_cast<int>(cudaGetLastError());
}

// the least power of two L >= lanes, up to kMaxLanes
template <int L = 1>
int launch_bwd(const float* xc, const float* dt, const float* bc,
               const float* cc, const float* a, const float* dy,
               const float* dh_last, float* dxc, float* ddt, float* dbc,
               float* dcc, float* da, float* scratch, int batch, int seq,
               int d_inner, int n_state, int lanes, cudaStream_t stream) {
  if constexpr (L < kMaxLanes) {
    if (lanes > L)
      return launch_bwd<2 * L>(xc, dt, bc, cc, a, dy, dh_last, dxc, ddt, dbc,
                               dcc, da, scratch, batch, seq, d_inner, n_state,
                               lanes, stream);
  }
  return launch_lanes<L>(xc, dt, bc, cc, a, dy, dh_last, dxc, ddt, dbc, dcc,
                         da, scratch, batch, seq, d_inner, n_state, stream);
}

}  // namespace

extern "C" {

// xc, dt, dy, dxc, ddt: (batch, seq, d_inner); bc, cc, dbc, dcc: (batch,
// seq, n_state); a, da: (d_inner, n_state); dh_last: (batch, d_inner,
// n_state) or null (no gradient reaches the final state); all float32,
// row-major.  scratch: floats of the chunks' entry states (n_chunks, batch,
// n_state, d_inner), then the blocks' partials of dbc and dcc (blocks,
// batch, seq, 2, n_state), then dA's of each b (batch, n_state, d_inner),
// each region from a multiple of 64 floats; n_chunks = ceil(seq / 32),
// blocks = ceil(d_inner / (64 / L)), L = 1, 2 or 4 lanes a channel for
// n_state <= 16, 32 or 64.  Two launches (the scan, the sums).  Returns
// cudaGetLastError() after them (cudaErrorInvalidValue for n_state > 64,
// without launching).
int selective_scan_bwd_f32(const void* xc, const void* dt, const void* bc,
                           const void* cc, const void* a, const void* dy,
                           const void* dh_last, void* dxc, void* ddt,
                           void* dbc, void* dcc, void* da, void* scratch,
                           int batch, int seq, int d_inner, int n_state,
                           void* stream) {
  if (n_state < 1 || n_state > kMaxState)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  const auto w = [](void* p) { return static_cast<float*>(p); };
  return launch_bwd(f(xc), f(dt), f(bc), f(cc), f(a), f(dy), f(dh_last),
                    w(dxc), w(ddt), w(dbc), w(dcc), w(da), w(scratch), batch,
                    seq, d_inner, n_state, (n_state + kStates - 1) / kStates,
                    static_cast<cudaStream_t>(stream));
}

}  // extern "C"
