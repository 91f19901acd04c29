// Causal flash attention (online softmax, optional sliding window and tanh
// logit cap) for Hopper, sm_90a, with a plain C interface loaded through
// ctypes.
//
// Replaces the Pallas TPU kernel of src/repro/kernels/flash_attention.py:
//   flash_attention_kernel  <- _kernel (:26), reached through
//                              flash_attention (:78, pallas_call :96)
//
//   out[b, i, h] = sum_j softmax_j(s_ij) v[b, j, h / (H / Kv)],
//   s_ij = cap(scale * q[b, i, h] . k[b, j, h / (H / Kv)]),
//   over keys j <= i (and j > i - window when window > 0).
//   q: (B, S, H, d), k: (B, S, Kv, d), v: (B, S, Kv, dv), f32 or bf16, all
//   one type; out: (B, S, H, dv) in that type.  d, dv <= 256.
//
// What bounds it on an H100: operations.  Each reachable (query, key) pair
// costs 2 d + 2 dv flops, and f32 products must stay out of the TF32
// tensor cores (the f32 tolerance, 2e-5, fails with TF32), so the bound is
// the f32 CUDA-core rate, 67 TFLOP/s.  At the serving path's shape (B = 4,
// S = 4096, H = 10, Kv = 1, d = dv = 256, window 2048) the 2.517e8
// reachable pairs are 2.58e11 flops, a 3.85 ms bound; the bytes (q, k, v
// read once, out written once) bound it at 0.11 ms.
//
// Design.  The TPU kernel walks KV blocks as the sequential last grid
// dimension, with the running max, sum and accumulator in VMEM scratch.
// Here one block of 256 threads owns a tile of kBQ = 64 queries of one
// (b, h) and walks the reachable KV tiles of kBK = 32 keys in a loop, so
// nothing crosses blocks.  Unreachable tiles (after the diagonal, or wholly
// outside the window) are never loaded.  The Q tile and each K and V tile
// are converted to f32 in shared memory (139,904 bytes at d = dv = 256,
// above the 48 KB default, so the launch raises the block's dynamic shared
// memory limit first).  Thread (tx, ty) of a 16 x 16 grid holds the scores
// of rows 4 ty .. 4 ty + 3 at keys tx and tx + 16, and the outputs of
// those rows at columns tx + 16 c: row statistics reduce over the 16 lanes
// of a half warp by shuffles, and every shared-memory read is either
// broadcast or conflict-free (the Q and K rows are padded by one word).
// K/V head h / (H / Kv) is indexed, never repeated in memory.  Masked
// entries get probability exactly 0 rather than exp(-2e38 - m): a row
// whose keys in a tile are all masked keeps l = 0 and acc = 0 and its
// running max at -2e38, so a later tile with valid keys takes over without
// ever forming a NaN, and the result equals the Pallas kernel's (which
// accumulates exp(0) for such rows and wipes it with alpha = 0).  Every
// row has at least its own key, so the final sum is positive.  Any S works
// (ragged tiles are masked); the Pallas kernel needed S % BQ == 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;        // queries per block
constexpr int kBK = 32;        // keys per tile
constexpr int kThreads = 256;  // a 16 x 16 grid of threads
constexpr int kRows = 4;       // query rows per thread (kBQ / 16)
constexpr int kMaxDim = 256;   // largest d and dv
constexpr float kNegInf = -2.0e38f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

inline size_t smem_bytes(int d, int dv) {
  return sizeof(float) * (static_cast<size_t>(kBQ + kBK) * (d + 1) +
                          static_cast<size_t>(kBK) * dv +
                          static_cast<size_t>(kBQ) * (kBK + 1));
}

// NC: output columns per thread, dv <= 16 * NC.
template <typename T, int NC>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int seq,
                       int heads, int kv_heads, int d, int dv, float scale,
                       int window, float softcap) {
  extern __shared__ float smem[];
  const int dp = d + 1;                  // padded row of Q and K
  float* sQ = smem;                      // [kBQ][dp]
  float* sK = sQ + kBQ * dp;             // [kBK][dp]
  float* sV = sK + kBK * dp;             // [kBK][dv]
  float* sP = sV + kBK * dv;             // [kBQ][kBK + 1]

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int lane = tid & 31;
  const int group = lane & 16;           // first lane of this half warp
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;   // late tiles first
  const int h = blockIdx.y;
  const int64_t b = blockIdx.z;
  const int kvh = h / (heads / kv_heads);

  const int64_t q_stride = static_cast<int64_t>(heads) * d;
  const int64_t k_stride = static_cast<int64_t>(kv_heads) * d;
  const int64_t v_stride = static_cast<int64_t>(kv_heads) * dv;
  const int64_t o_stride = static_cast<int64_t>(heads) * dv;
  const T* qb = q + b * seq * q_stride + static_cast<int64_t>(h) * d;
  const T* kb = k + b * seq * k_stride + static_cast<int64_t>(kvh) * d;
  const T* vb = v + b * seq * v_stride + static_cast<int64_t>(kvh) * dv;
  T* ob = out + b * seq * o_stride + static_cast<int64_t>(h) * dv;

  for (int i = tid; i < kBQ * d; i += kThreads) {
    const int r = i / d, c = i - r * d;
    const int pos = q0 + r;
    sQ[r * dp + c] = pos < seq ? to_f32(qb[pos * q_stride + c]) : 0.f;
  }

  float m[kRows], l[kRows], acc[kRows][NC];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  const int q_end = min(q0 + kBQ, seq);            // keys [k_begin, q_end)
  int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  k_begin -= k_begin % kBK;
  for (int k0 = k_begin; k0 < q_end; k0 += kBK) {
    __syncthreads();         // the Q tile is in; the last tile is consumed
    for (int i = tid; i < kBK * d; i += kThreads) {
      const int r = i / d, c = i - r * d;
      const int pos = k0 + r;
      sK[r * dp + c] = pos < seq ? to_f32(kb[pos * k_stride + c]) : 0.f;
    }
    for (int i = tid; i < kBK * dv; i += kThreads) {
      const int r = i / dv, c = i - r * dv;
      const int pos = k0 + r;
      sV[r * dv + c] = pos < seq ? to_f32(vb[pos * v_stride + c]) : 0.f;
    }
    __syncthreads();

    float s[kRows][2];
#pragma unroll
    for (int i = 0; i < kRows; ++i) s[i][0] = s[i][1] = 0.f;
    const float* k0row = sK + tx * dp;
    const float* k1row = sK + (tx + 16) * dp;
    const float* qrow = sQ + (ty * kRows) * dp;
#pragma unroll 4
    for (int c = 0; c < d; ++c) {
      const float ka = k0row[c], kc = k1row[c];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float qv = qrow[i * dp + c];
        s[i][0] = fmaf(qv, ka, s[i][0]);
        s[i][1] = fmaf(qv, kc, s[i][1]);
      }
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qpos = q0 + ty * kRows + i;
      bool ok[2];
      float mt = kNegInf;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int kpos = k0 + tx + 16 * j;
        ok[j] = kpos <= qpos && kpos < seq &&
                (window <= 0 || kpos > qpos - window);
        float x = s[i][j] * scale;
        if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
        s[i][j] = ok[j] ? x : kNegInf;
        mt = fmaxf(mt, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      const float mn = fmaxf(m[i], mt);
      const float p0 = ok[0] ? expf(s[i][0] - mn) : 0.f;
      const float p1 = ok[1] ? expf(s[i][1] - mn) : 0.f;
      float rs = p0 + p1;
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      rs = __shfl_sync(0xffffffffu, rs, group);   // one value for the row
      const float alpha = expf(m[i] - mn);
      l[i] = l[i] * alpha + rs;
      m[i] = mn;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
      float* prow = sP + (ty * kRows + i) * (kBK + 1);
      prow[tx] = p0;
      prow[tx + 16] = p1;
    }
    __syncwarp();            // a row's P is written and read by one half warp

    const float* prow = sP + (ty * kRows) * (kBK + 1);
#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      float p[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) p[i] = prow[i * (kBK + 1) + j];
      const float* vrow = sV + j * dv;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int col = tx + 16 * c;
        const float vv = col < dv ? vrow[col] : 0.f;
#pragma unroll
        for (int i = 0; i < kRows; ++i) acc[i][c] = fmaf(p[i], vv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qpos = q0 + ty * kRows + i;
    if (qpos >= seq) continue;
    const float den = fmaxf(l[i], 1e-30f);
    T* orow = ob + qpos * o_stride;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = tx + 16 * c;
      if (col < dv) store(orow + col, acc[i][c] / den);
    }
  }
}

template <typename T, int NC>
int launch_nc(const void* q, const void* k, const void* v, void* out,
              int batch, int seq, int heads, int kv_heads, int d, int dv,
              float scale, int window, float softcap, cudaStream_t stream) {
  auto kernel = flash_attention_kernel<T, NC>;
  const size_t smem = smem_bytes(d, dv);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((seq + kBQ - 1) / kBQ, heads, batch);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), seq, heads, kv_heads,
      d, dv, scale, window, softcap);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int batch,
           int seq, int heads, int kv_heads, int d, int dv, float scale,
           int window, float softcap, void* stream) {
  if (d < 1 || dv < 1 || d > kMaxDim || dv > kMaxDim || kv_heads < 1 ||
      heads % kv_heads != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dv <= 32)
    return launch_nc<T, 2>(q, k, v, out, batch, seq, heads, kv_heads, d, dv,
                           scale, window, softcap, s);
  if (dv <= 64)
    return launch_nc<T, 4>(q, k, v, out, batch, seq, heads, kv_heads, d, dv,
                           scale, window, softcap, s);
  if (dv <= 128)
    return launch_nc<T, 8>(q, k, v, out, batch, seq, heads, kv_heads, d, dv,
                           scale, window, softcap, s);
  return launch_nc<T, 16>(q, k, v, out, batch, seq, heads, kv_heads, d, dv,
                          scale, window, softcap, s);
}

}  // namespace

extern "C" {

// q: (batch, seq, heads, d), k: (batch, seq, kv_heads, d), v: (batch, seq,
// kv_heads, dv), out: (batch, seq, heads, dv), all row-major in one type.
// window <= 0: causal only; softcap <= 0: no cap.  Returns the CUDA error of
// the launch (0 on success).
int fa_forward_f32(const void* q, const void* k, const void* v, void* out,
                   int batch, int seq, int heads, int kv_heads, int d, int dv,
                   float scale, int window, float softcap, void* stream) {
  return launch<float>(q, k, v, out, batch, seq, heads, kv_heads, d, dv,
                       scale, window, softcap, stream);
}

int fa_forward_bf16(const void* q, const void* k, const void* v, void* out,
                    int batch, int seq, int heads, int kv_heads, int d,
                    int dv, float scale, int window, float softcap,
                    void* stream) {
  return launch<__nv_bfloat16>(q, k, v, out, batch, seq, heads, kv_heads, d,
                               dv, scale, window, softcap, stream);
}

}  // extern "C"
