// Backward of causal flash attention (sliding window, tanh logit cap,
// grouped K/V heads) for Hopper, sm_90a, float32, with a plain C interface
// loaded through ctypes.
//
// The TPU package has no backward kernel: its training differentiates the
// jnp attention (jax.grad through _sdpa and causal_mask,
// src/repro/models/attention.py:72-96), and that is the reference here.
// The forward is flash_attention.cu, whose lse output (each query row's
// log-sum-exp) this backward reads.
//
//   s_ij  = cap(scale q_i . k_j)  over reachable pairs (j <= i, and
//           j > i - window when window > 0); cap(x) = c tanh(x / c)
//   p_ij  = exp(s_ij - lse_i)
//   D_i   = dO_i . o_i
//   dS_ij = p_ij (dO_i . v_j - D_i), times (1 - tanh^2) when softcap > 0
//   dQ_i  = scale sum_j dS_ij k_j,  dK_j = scale sum_i dS_ij q_i,
//   dV_j  = sum_i p_ij dO_i
//   with query head h reading K/V head h / (H / Kv), so dK and dV sum over
//   the H / Kv query heads of a group.
//   q, dq: (B, S, H, d); k, dk: (B, S, Kv, d); v, dv: (B, S, Kv, dv);
//   o, dO: (B, S, H, dv); lse, delta: (B, H, S).  d, dv <= 256.
//
// What bounds it on an H100: operations.  A reachable pair needs five
// products of its vectors, 2 (3 d + 2 dv) flops (S and dP recomputed, dV,
// dK, dQ).  At the training shape (B 1, S 4096, H 10, Kv 1, d = dv = 256,
// window 2048) the 62,924,800 reachable pairs are 1.611e11 flops: 2.40 ms
// on the f32 CUDA cores (67 TFLOP/s).  The bytes (q, k, v, o, dO, lse read
// once, dq, dk, dv written once) bound it at ~0.05 ms.
//
// Design: a simple kernel that is right, on the CUDA cores in full f32
// (FMA), no atomics, so the result is deterministic.  Three launches:
//   1. fa_bwd_delta_kernel: D_i, one warp a row.
//   2. fa_bwd_dkdv_kernel: one block per (key tile of 32, K/V head, b).  K
//      and V of the tile stay in shared memory; the block walks the
//      group's query heads and, for each, the query tiles of 32 that can
//      see the tile (from the tile's first key to its last key + window),
//      loading Q and dO, recomputing S and dP (each thread a 2 x 2 block of
//      the 32 x 32 tile), forming P and dS in shared memory, and adding
//      P^T dO and dS^T Q into dV and dK held in registers (each thread 4
//      keys x 8 columns of each, 32 lanes on consecutive columns).
//   3. fa_bwd_dq_kernel: one block per (query tile of 32, head, b), walking
//      the reachable key tiles the same way and adding dS K into dQ.
// So S and dP are computed twice (the pairs cost 2 (4 d + 3 dv) flops, 1.4
// times the bound's count).  Shared-memory rows have an odd pitch, so the
// 16 rows one warp reads at one column fall on distinct banks.  Rows past
// S load as zeros and masked pairs get p = dS = 0 exactly.  Any S, H a
// multiple of Kv, d and dv up to 256.  Tiles are loaded with plain loads
// and each block computes one tile at a time: making it fast (tensor cores
// as the forward's 3xTF32 split, double-buffered copies) is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kT = 32;               // queries of a query tile, keys of a key tile
constexpr int kThreads = 256;
constexpr int kMaxDim = 256;
constexpr int kCols = kMaxDim / 32;  // column slots of a thread (8)
constexpr int kPP = kT + 1;          // pitch of the P and dS tiles

// an odd row pitch: the rows of one column fall on distinct banks
__host__ __device__ inline int pitch_of(int n) { return n | 1; }

// rows [0, kT) x columns [0, n) of src (row stride `stride`) into dst (row
// pitch `pitch`); rows >= valid are zeros
__device__ __forceinline__ void load_tile(float* dst, int pitch,
                                          const float* src, int64_t stride,
                                          int valid, int n) {
  for (int i = threadIdx.x; i < kT * n; i += kThreads) {
    const int r = i / n, c = i - r * n;
    dst[r * pitch + c] = r < valid ? src[r * stride + c] : 0.f;
  }
}

// acc[a][b] = sum_k A[ti + 16 a][k] B[tj + 16 b][k]
__device__ __forceinline__ void dot2x2(float (&acc)[2][2], const float* A,
                                       int pa, const float* B, int pb, int n,
                                       int ti, int tj) {
  const float* a0 = A + ti * pa;
  const float* a1 = a0 + 16 * pa;
  const float* b0 = B + tj * pb;
  const float* b1 = b0 + 16 * pb;
#pragma unroll 4
  for (int k = 0; k < n; ++k) {
    const float x0 = a0[k], x1 = a1[k], y0 = b0[k], y1 = b1[k];
    acc[0][0] = fmaf(x0, y0, acc[0][0]);
    acc[0][1] = fmaf(x0, y1, acc[0][1]);
    acc[1][0] = fmaf(x1, y0, acc[1][0]);
    acc[1][1] = fmaf(x1, y1, acc[1][1]);
  }
}

// acc[r][m] += sum_i W(i, w + 8 r) X[i][lane + 32 m] over the kT rows i,
// where W(i, j) = W[i][j] when kTrans (P^T, dS^T) and W[j][i] otherwise
template <bool kTrans>
__device__ __forceinline__ void accumulate(float (&acc)[4][kCols],
                                           const float* W, const float* X,
                                           int px, int n, int w, int lane) {
#pragma unroll 2
  for (int i = 0; i < kT; ++i) {
    float wv[4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
      wv[r] = kTrans ? W[i * kPP + w + 8 * r] : W[(w + 8 * r) * kPP + i];
#pragma unroll
    for (int m = 0; m < kCols; ++m) {
      const int c = lane + 32 * m;
      const float x = c < n ? X[i * px + c] : 0.f;
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[r][m] = fmaf(wv[r], x, acc[r][m]);
    }
  }
}

// p and dS of this thread's 2 x 2 entries of the (query tile q0, key tile
// k0) pair, written to sP (if not null) and sdS
__device__ __forceinline__ void probs(const float (&s)[2][2],
                                      const float (&dp)[2][2], float* sP,
                                      float* sdS, const float* sL,
                                      const float* sD, int q0, int k0,
                                      int ti, int tj, int seq, float scale,
                                      int window, float softcap) {
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      const int r = ti + 16 * a, c = tj + 16 * b;
      const int i = q0 + r, j = k0 + c;
      const bool ok = i < seq && j <= i && (window <= 0 || j > i - window);
      float x = s[a][b] * scale, th = 0.f;
      if (softcap > 0.f) {
        th = tanhf(x / softcap);
        x = th * softcap;
      }
      const float p = ok ? expf(x - sL[r]) : 0.f;
      float ds = p * (dp[a][b] - sD[r]);
      if (softcap > 0.f) ds *= 1.f - th * th;
      if (sP != nullptr) sP[r * kPP + c] = p;
      sdS[r * kPP + c] = ds;
    }
}

// D = rowsum(dO * o): one warp a (b, i, h) row, rows in memory order
__global__ void __launch_bounds__(kThreads)
fa_bwd_delta_kernel(const float* __restrict__ o, const float* __restrict__ dout,
                    float* __restrict__ delta, int64_t rows, int seq,
                    int heads, int dv) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * (kThreads / 32) +
                      threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const float* po = o + row * dv;
  const float* pd = dout + row * dv;
  float acc = 0.f;
  for (int c = lane; c < dv; c += 32) acc = fmaf(po[c], pd[c], acc);
#pragma unroll
  for (int off = 16; off > 0; off /= 2)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const int h = static_cast<int>(row % heads);
    const int64_t bi = row / heads;
    const int i = static_cast<int>(bi % seq);
    const int64_t b = bi / seq;
    delta[(b * heads + h) * seq + i] = acc;
  }
}

struct Dims {
  int seq, heads, kv_heads, d, dv, window;
  float scale, softcap;
};

size_t dkdv_smem(int d, int dv) {
  return sizeof(float) * (2 * kT * (pitch_of(d) + pitch_of(dv)) +
                          2 * kT * kPP + 2 * kT);
}
size_t dq_smem(int d, int dv) {
  return sizeof(float) * (2 * kT * (pitch_of(d) + pitch_of(dv)) + kT * kPP +
                          2 * kT);
}

__global__ void __launch_bounds__(kThreads)
fa_bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v,
                   const float* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, float* __restrict__ dk,
                   float* __restrict__ dvo, Dims z) {
  extern __shared__ __align__(16) float smem[];
  const int pd = pitch_of(z.d), pv = pitch_of(z.dv);
  float* sK = smem;                    // [kT][pd]
  float* sV = sK + kT * pd;            // [kT][pv]
  float* sQ = sV + kT * pv;            // [kT][pd]
  float* sO = sQ + kT * pd;            // [kT][pv]  dO
  float* sP = sO + kT * pv;            // [kT][kPP]
  float* sS = sP + kT * kPP;           // [kT][kPP] dS
  float* sL = sS + kT * kPP;           // [kT] lse
  float* sD = sL + kT;                 // [kT] delta
  const int tid = threadIdx.x, ti = tid >> 4, tj = tid & 15;
  const int w = tid >> 5, lane = tid & 31;
  const int k0 = blockIdx.x * kT;
  const int kvh = blockIdx.y;
  const int64_t b = blockIdx.z;
  const int group = z.heads / z.kv_heads;
  const int64_t qs = static_cast<int64_t>(z.heads) * z.d;
  const int64_t os = static_cast<int64_t>(z.heads) * z.dv;
  const int64_t ks = static_cast<int64_t>(z.kv_heads) * z.d;
  const int64_t vs = static_cast<int64_t>(z.kv_heads) * z.dv;

  load_tile(sK, pd, k + (b * z.seq + k0) * ks + kvh * z.d, ks, z.seq - k0,
            z.d);
  load_tile(sV, pv, v + (b * z.seq + k0) * vs + kvh * z.dv, vs, z.seq - k0,
            z.dv);
  float acc_k[4][kCols], acc_v[4][kCols];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int m = 0; m < kCols; ++m) acc_k[r][m] = acc_v[r][m] = 0.f;

  // queries that can see a key of this tile: [k0, k0 + kT - 1 + window)
  const int q_end = z.window > 0 ? min(z.seq, k0 + kT - 1 + z.window)
                                 : z.seq;
  for (int hh = 0; hh < group; ++hh) {
    const int h = kvh * group + hh;
    const float* lrow = lse + (b * z.heads + h) * z.seq;
    const float* drow = delta + (b * z.heads + h) * z.seq;
    for (int q0 = k0; q0 < q_end; q0 += kT) {
      __syncthreads();                 // the last tile's Q, dO, P, dS used
      load_tile(sQ, pd, q + (b * z.seq + q0) * qs + h * z.d, qs, z.seq - q0,
                z.d);
      load_tile(sO, pv, dout + (b * z.seq + q0) * os + h * z.dv, os,
                z.seq - q0, z.dv);
      if (tid < kT) {
        const bool in = q0 + tid < z.seq;
        sL[tid] = in ? lrow[q0 + tid] : 0.f;
        sD[tid] = in ? drow[q0 + tid] : 0.f;
      }
      __syncthreads();
      float s[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
      float dp[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
      dot2x2(s, sQ, pd, sK, pd, z.d, ti, tj);
      dot2x2(dp, sO, pv, sV, pv, z.dv, ti, tj);
      probs(s, dp, sP, sS, sL, sD, q0, k0, ti, tj, z.seq, z.scale, z.window,
            z.softcap);
      __syncthreads();
      accumulate<true>(acc_v, sP, sO, pv, z.dv, w, lane);
      accumulate<true>(acc_k, sS, sQ, pd, z.d, w, lane);
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int j = k0 + w + 8 * r;
    if (j >= z.seq) continue;
    float* krow = dk + (b * z.seq + j) * ks + kvh * z.d;
    float* vrow = dvo + (b * z.seq + j) * vs + kvh * z.dv;
#pragma unroll
    for (int m = 0; m < kCols; ++m) {
      const int c = lane + 32 * m;
      if (c < z.d) krow[c] = acc_k[r][m] * z.scale;
      if (c < z.dv) vrow[c] = acc_v[r][m];
    }
  }
}

__global__ void __launch_bounds__(kThreads)
fa_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, float* __restrict__ dq,
                 Dims z) {
  extern __shared__ __align__(16) float smem[];
  const int pd = pitch_of(z.d), pv = pitch_of(z.dv);
  float* sQ = smem;                    // [kT][pd]
  float* sO = sQ + kT * pd;            // [kT][pv]  dO
  float* sK = sO + kT * pv;            // [kT][pd]
  float* sV = sK + kT * pd;            // [kT][pv]
  float* sS = sV + kT * pv;            // [kT][kPP] dS
  float* sL = sS + kT * kPP;           // [kT]
  float* sD = sL + kT;                 // [kT]
  const int tid = threadIdx.x, ti = tid >> 4, tj = tid & 15;
  const int w = tid >> 5, lane = tid & 31;
  const int q0 = blockIdx.x * kT;
  const int h = blockIdx.y;
  const int64_t b = blockIdx.z;
  const int kvh = h / (z.heads / z.kv_heads);
  const int64_t qs = static_cast<int64_t>(z.heads) * z.d;
  const int64_t os = static_cast<int64_t>(z.heads) * z.dv;
  const int64_t ks = static_cast<int64_t>(z.kv_heads) * z.d;
  const int64_t vs = static_cast<int64_t>(z.kv_heads) * z.dv;

  load_tile(sQ, pd, q + (b * z.seq + q0) * qs + h * z.d, qs, z.seq - q0,
            z.d);
  load_tile(sO, pv, dout + (b * z.seq + q0) * os + h * z.dv, os, z.seq - q0,
            z.dv);
  if (tid < kT) {
    const bool in = q0 + tid < z.seq;
    sL[tid] = in ? lse[(b * z.heads + h) * z.seq + q0 + tid] : 0.f;
    sD[tid] = in ? delta[(b * z.heads + h) * z.seq + q0 + tid] : 0.f;
  }
  float acc[4][kCols];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int m = 0; m < kCols; ++m) acc[r][m] = 0.f;

  // keys this tile's queries can see: [q0 - window + 1, q0 + kT)
  int k_begin = z.window > 0 ? max(0, q0 - z.window + 1) : 0;
  k_begin -= k_begin % kT;
  const int k_end = min(z.seq, q0 + kT);
  for (int k0 = k_begin; k0 < k_end; k0 += kT) {
    __syncthreads();                   // the last tile's K, V, dS used
    load_tile(sK, pd, k + (b * z.seq + k0) * ks + kvh * z.d, ks, z.seq - k0,
              z.d);
    load_tile(sV, pv, v + (b * z.seq + k0) * vs + kvh * z.dv, vs,
              z.seq - k0, z.dv);
    __syncthreads();
    float s[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
    float dp[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
    dot2x2(s, sQ, pd, sK, pd, z.d, ti, tj);
    dot2x2(dp, sO, pv, sV, pv, z.dv, ti, tj);
    probs(s, dp, nullptr, sS, sL, sD, q0, k0, ti, tj, z.seq, z.scale,
          z.window, z.softcap);
    __syncthreads();
    accumulate<false>(acc, sS, sK, pd, z.d, w, lane);
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = q0 + w + 8 * r;
    if (i >= z.seq) continue;
    float* row = dq + (b * z.seq + i) * qs + h * z.d;
#pragma unroll
    for (int m = 0; m < kCols; ++m) {
      const int c = lane + 32 * m;
      if (c < z.d) row[c] = acc[r][m] * z.scale;
    }
  }
}

}  // namespace

extern "C" {

// q: (batch, seq, heads, d), k: (batch, seq, kv_heads, d), v: (batch, seq,
// kv_heads, dv), o and dout: (batch, seq, heads, dv), lse: (batch, heads,
// seq), all f32 and row-major; delta: (batch, heads, seq) f32 scratch.
// Writes dq, dk, dv (the shapes of q, k, v).  Three launches on `stream`;
// returns the first CUDA error (0 on success).
int fa_backward_f32(const void* q, const void* k, const void* v,
                    const void* o, const void* dout, const void* lse,
                    void* delta, void* dq, void* dk, void* dv, int batch,
                    int seq, int heads, int kv_heads, int d, int dv_dim,
                    float scale, int window, float softcap, void* stream) {
  if (d < 1 || dv_dim < 1 || d > kMaxDim || dv_dim > kMaxDim ||
      kv_heads < 1 || heads % kv_heads != 0 || batch > 65535 ||
      heads > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0 || seq == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Dims z{seq, heads, kv_heads, d, dv_dim, window, scale, softcap};
  const int64_t rows = static_cast<int64_t>(batch) * seq * heads;
  const int per_block = kThreads / 32;
  fa_bwd_delta_kernel<<<static_cast<unsigned>((rows + per_block - 1) /
                                              per_block),
                        kThreads, 0, s>>>(
      static_cast<const float*>(o), static_cast<const float*>(dout),
      static_cast<float*>(delta), rows, seq, heads, dv_dim);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const size_t smem_kv = dkdv_smem(d, dv_dim), smem_q = dq_smem(d, dv_dim);
  err = cudaFuncSetAttribute(fa_bwd_dkdv_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_kv));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(fa_bwd_dq_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_q));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (seq + kT - 1) / kT;
  fa_bwd_dkdv_kernel<<<dim3(tiles, kv_heads, batch), kThreads, smem_kv, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dk), static_cast<float*>(dv), z);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  fa_bwd_dq_kernel<<<dim3(tiles, heads, batch), kThreads, smem_q, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dq), z);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
