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
//   Optionally also lse: (B, H, S) f32, the log-sum-exp of each query row's
//   (capped, masked) scores, m + log(l) from the online softmax's final
//   state: what the backward (flash_attention_bwd.cu) needs to rebuild the
//   probabilities.  With a null lse pointer nothing else changes: serving
//   passes null and its output is bit for bit what it was without it.
//
// What bounds it on an H100: operations.  Each reachable (query, key) pair
// costs 2 d + 2 dv flops.  At the serving path's shape (B = 4, S = 4096,
// H = 10, Kv = 1, d = dv = 256, window 2048) the 2.517e8 reachable pairs
// are 2.58e11 flops: 3.85 ms on the f32 CUDA cores (67 TFLOP/s), 1.56 ms
// as three TF32 tensor-core products each (3 x 2.58e11 over 495 TFLOP/s).
// The bytes (q, k, v read once, out written once) bound it at 0.11 ms.
//
// Numerics.  The products run on the tensor cores through mma.sync.  One
// TF32 product keeps 10 mantissa bits and misses the f32 tolerance (2e-5)
// by far, so f32 operands are split as they are loaded into fragments:
// hi = tf32(x), lo = tf32(x - hi), both rounded to nearest with ties away
// from zero (cvt.rna's rounding, done in two integer ops), and
// a.b = hi_a.hi_b + (hi_a.lo_b + lo_a.hi_b) with f32 accumulation (the
// 3xTF32 split; lo_a.lo_b and lo's own rounding, ~2^-22 |a b| each, are
// dropped).  In Q K^T the two small products go to an accumulator of their
// own, added to the big one after the last d-step; in P V a key tile's
// three products are summed from zero (the small ones first) and then
// added to the output in f32, so the output never rides the tensor core's
// accumulate from tile to tile (see pv).  bf16 operands go straight to
// m16n8k16 bf16 products with f32 accumulation; P is rounded to bf16 for
// P V.  The softmax is online and in f32, with expf on the scores.
//
// Design.  The TPU kernel walks KV blocks as the sequential last grid
// dimension, with the running max, sum and accumulator in VMEM scratch. Here
// one block owns kBQ = 64 queries of one (b, h) and walks the reachable KV
// tiles of kBK = 32 keys in a loop, so nothing crosses blocks. Unreachable
// tiles (after the diagonal, or wholly outside the window) are never loaded,
// and the warps of a group of 16 query rows skip the products of a tile that
// none of those rows can see.  In f32 the block's 8 warps form 4 pairs of 16
// query rows: the two warps of a pair take one half of d each for Q K^T, add
// their partial scores through shared memory (a 64-thread named barrier), both
// run the same online softmax, and take one half of dv each for P V. So a warp
// holds 16 rows x dv / 2 of the output in registers (64 a lane at dv = 256),
// and each of the 4 schedulers of an SM has two warps to switch between, where
// 4 warps of 16 rows x dv left each scheduler one warp and ran slower on an
// H100.  In bf16 a tile's products are cheap beside the exchange and the
// second softmax, so 4 warps own 16 rows each and two blocks share an SM.  Q
// stays in shared memory in its input type; K and V tiles are double-buffered
// there with cp.async (16-byte copies; rows past S are zero-filled), so the
// next tile's copy is in flight while this one is computed (222,208 bytes at
// d = dv = 256 in f32, one block per SM; 107,520 in bf16).  Scores stay in the
// mma accumulators: a row's max and sum reduce over the 4 lanes that share it
// by two shuffles, and P goes from the accumulator into the A fragment of P V
// with no data movement (f32: the 8 keys of an accumulator tile are taken in
// the order 0, 2, 4, 6 | 1, 3, 5, 7, and V's rows are read in the same order;
// bf16: the usual pairing of two accumulator tiles).  V's B fragments are two
// 32-bit loads (f32) or one ldmatrix.trans per two n-tiles (bf16).  Q and K
// rows are padded to 16 words mod 32 so that their 128-bit fragment loads are
// free of bank conflicts (each lane loads 4 consecutive d, which the mma takes
// in a permuted order, the same for Q and K), V rows to 4 words mod 32 (f32)
// or an odd number of 16-byte units (bf16).  K/V head h / (H / Kv) is indexed,
// never repeated in memory.  Masked entries get probability exactly 0 rather
// than exp(-2e38 - m): a row whose keys in a tile are all masked keeps l = 0
// and acc = 0 and its running max at -2e38, so a later tile with valid keys
// takes over without ever forming a NaN, and the result equals the Pallas
// kernel's (which accumulates exp(0) for such rows and wipes it with
// alpha = 0).  Every row has at least its own key, so the final sum is
// positive.  Any S works (ragged tiles are masked; the Pallas kernel needed
// S % BQ == 0); d and dv that are not a multiple of 16 bytes take plain loads
// in place of cp.async.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;        // queries per block
constexpr int kBK = 32;        // keys per tile
constexpr int kGroups = kBQ / 16;    // groups of 16 query rows
constexpr int kExchange = 16 * 32;   // floats of one warp's partial scores
constexpr int kMaxDim = 256;   // largest d and dv
constexpr float kNegInf = -2.0e38f;

// Per input type: the warps that share a group of 16 query rows, the d
// columns one 128-bit fragment load covers (two mma k-steps) and the
// shared-memory row pitches, in elements.
template <typename T> struct Layout;
template <> struct Layout<float> {
  static constexpr int kSplit = 2;           // pairs split d and dv
  static constexpr int kThreads = 32 * kGroups * kSplit;
  static constexpr int kChunk = 16;          // 2 k-steps of 8
  // Q and K rows: a multiple of kChunk, 16 words mod 32
  __host__ __device__ static int qk_pitch(int d) {
    const int p = (d + 15) / 16 * 16;
    return p % 32 == 0 ? p + 16 : p;
  }
  // V rows: 8 nt columns, 4 words mod 32
  __host__ __device__ static int v_pitch(int nt) { return 8 * nt + 4; }
};
template <> struct Layout<__nv_bfloat16> {
  static constexpr int kSplit = 1;           // one warp a group
  static constexpr int kThreads = 32 * kGroups * kSplit;
  static constexpr int kChunk = 32;          // 2 k-steps of 16
  __host__ __device__ static int qk_pitch(int d) {
    const int p = (d + 31) / 32 * 32;
    return p % 64 == 0 ? p + 32 : p;
  }
  // an odd number of 16-byte units: ldmatrix rows on distinct banks
  __host__ __device__ static int v_pitch(int nt) { return 8 * nt + 8; }
};

// Q, two K and two V tiles in the input type, then the partial scores of
// the warps of a split group
template <typename T>
size_t smem_bytes(int d, int nt) {
  constexpr int kSplit = Layout<T>::kSplit;
  return sizeof(T) * (static_cast<size_t>(kBQ + 2 * kBK) *
                          Layout<T>::qk_pitch(d) +
                      static_cast<size_t>(2 * kBK) * Layout<T>::v_pitch(nt)) +
         (kSplit > 1 ? sizeof(float) * kGroups * kSplit * kExchange : 0);
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
__device__ __forceinline__ void cp_async_wait_prior() {   // all but the last
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// rows [0, rows) x cols [0, cols) of src (row pitch src_pitch) into dst
// (row pitch dst_pitch); rows >= valid are zeros.  vec: cols and the
// pitches are whole 16-byte units and src is 16-byte aligned, so the copy
// is asynchronous; otherwise plain loads and stores.
template <int kThreads, typename T>
__device__ __forceinline__ void stage(T* dst, int dst_pitch, const T* src,
                                      int64_t src_pitch, int rows, int valid,
                                      int cols, bool vec) {
  if (vec) {
    constexpr int kVec = 16 / sizeof(T);
    const int per_row = cols / kVec;
    const int dr = kThreads / per_row;
    const int dc = (kThreads - dr * per_row) * kVec;
    int r = threadIdx.x / per_row;
    for (int i = threadIdx.x, cc = (threadIdx.x - r * per_row) * kVec;
         i < rows * per_row; i += kThreads) {
      const bool ok = r < valid;
      cp_async16(dst + r * dst_pitch + cc,
                 src + (ok ? r * src_pitch + cc : 0), ok ? 16 : 0);
      cc += dc;
      r += dr;
      if (cc >= cols) {
        cc -= cols;
        ++r;
      }
    }
  } else {
    for (int i = threadIdx.x; i < rows * cols; i += kThreads) {
      const int r = i / cols, c = i - r * cols;
      dst[r * dst_pitch + c] = r < valid ? src[r * src_pitch + c] : T(0.f);
    }
  }
}

// ---- tensor-core products --------------------------------------------- //

// hi = tf32(x), lo = tf32(x - hi), both rounded to nearest with ties away
// from zero as cvt.rna.tf32.f32 rounds, in integer ops: add half of the 13
// bits that TF32 drops.  hi's are cleared (x - hi needs the exact hi); lo's
// are left, since the mma reads only the top 19 bits of a TF32 operand.
// (cvt.rna itself compiles to ~7 instructions for the pair.)
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi)) + 0x1000u;
}

// c += a b, a: 16 x 8 (row), b: 8 x 8 (col), TF32 in, f32 accumulate
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// c += a b, a: 16 x 16 (row), b: 16 x 8 (col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// s[j] (keys 8 j .. 8 j + 7 of the tile) += Q K^T over d, for this warp's
// 16 rows.  Lane (g, t) = (lane / 4, lane % 4) loads d columns
// 4t .. 4t + 3 (f32) or 8t .. 8t + 7 (bf16) of a chunk as one 128-bit word
// from Q's rows g and g + 8 and from K's key 8 j + g; each k-step takes
// these columns in place of the mma's own k order, the same for A and B,
// which the sum over d does not see.
__device__ __forceinline__ void scores(float (&s)[4][4], const float* q_row,
                                       const float* k_row, int qk_pitch,
                                       int chunks) {
  float small[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) small[j][e] = 0.f;
#pragma unroll 2
  for (int ch = 0; ch < chunks; ++ch) {
    const float4 xa = *reinterpret_cast<const float4*>(q_row + ch * 16);
    const float4 xb =
        *reinterpret_cast<const float4*>(q_row + 8 * qk_pitch + ch * 16);
    uint32_t ah[2][4], al[2][4];
    split(xa.x, ah[0][0], al[0][0]);
    split(xb.x, ah[0][1], al[0][1]);
    split(xa.y, ah[0][2], al[0][2]);
    split(xb.y, ah[0][3], al[0][3]);
    split(xa.z, ah[1][0], al[1][0]);
    split(xb.z, ah[1][1], al[1][1]);
    split(xa.w, ah[1][2], al[1][2]);
    split(xb.w, ah[1][3], al[1][3]);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float4 kv = *reinterpret_cast<const float4*>(
          k_row + 8 * j * qk_pitch + ch * 16);
      uint32_t bh[4], bl[4];
      split(kv.x, bh[0], bl[0]);
      split(kv.y, bh[1], bl[1]);
      split(kv.z, bh[2], bl[2]);
      split(kv.w, bh[3], bl[3]);
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        mma_tf32(small[j], ah[ks], bl[2 * ks], bl[2 * ks + 1]);
        mma_tf32(small[j], al[ks], bh[2 * ks], bh[2 * ks + 1]);
        mma_tf32(s[j], ah[ks], bh[2 * ks], bh[2 * ks + 1]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] += small[j][e];
}

__device__ __forceinline__ void scores(float (&s)[4][4],
                                       const __nv_bfloat16* q_row,
                                       const __nv_bfloat16* k_row,
                                       int qk_pitch, int chunks) {
#pragma unroll 2
  for (int ch = 0; ch < chunks; ++ch) {
    const uint4 xa = *reinterpret_cast<const uint4*>(q_row + ch * 32);
    const uint4 xb =
        *reinterpret_cast<const uint4*>(q_row + 8 * qk_pitch + ch * 32);
    const uint32_t a0[4] = {xa.x, xb.x, xa.y, xb.y};
    const uint32_t a1[4] = {xa.z, xb.z, xa.w, xb.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint4 kv = *reinterpret_cast<const uint4*>(
          k_row + 8 * j * qk_pitch + ch * 32);
      mma_bf16(s[j], a0, kv.x, kv.y);
      mma_bf16(s[j], a1, kv.z, kv.w);
    }
  }
}

// o += P V for this warp's 16 rows; p[j] holds the probabilities of keys
// 8 j .. 8 j + 7 in the accumulator layout.  Each n-tile's product over
// the tile's 32 keys is summed from zero in the mma's accumulator and then
// added to o by an f32 add, which rounds to nearest.  Carrying o itself as
// the mma's C operand over every key tile let it drift: the tensor core's
// accumulate does not round to nearest, so o lost ~2^-24 of itself in one
// direction at each of the 12 accumulations a tile, ~4.5e-5 relative after
// 4096 keys where the values average to a large output (gemma-7b's first
// layer on its own inputs, scripts/fa_accuracy.py).
template <int NT>
__device__ __forceinline__ void pv(float (&o)[NT][4], const float (&p)[4][4],
                                   const float* sv, int v_pitch, int lane) {
  const int g = lane >> 2, t = lane & 3;
  // k-step j: mma k = t <-> key 8 j + 2 t, k = t + 4 <-> key 8 j + 2 t + 1
  uint32_t ah[4][4], al[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    split(p[j][0], ah[j][0], al[j][0]);
    split(p[j][2], ah[j][1], al[j][1]);
    split(p[j][1], ah[j][2], al[j][2]);
    split(p[j][3], ah[j][3], al[j][3]);
  }
  const float* v0 = sv + 2 * t * v_pitch + g;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t bh0, bl0, bh1, bl1;
      split(v0[8 * j * v_pitch + 8 * n], bh0, bl0);
      split(v0[(8 * j + 1) * v_pitch + 8 * n], bh1, bl1);
      mma_tf32(c, ah[j], bl0, bl1);
      mma_tf32(c, al[j], bh0, bh1);
      mma_tf32(c, ah[j], bh0, bh1);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] += c[e];
  }
}

template <int NT>
__device__ __forceinline__ void pv(float (&o)[NT][4], const float (&p)[4][4],
                                   const __nv_bfloat16* sv, int v_pitch,
                                   int lane) {
  // ldmatrix.x4.trans: lane i gives the row address of row i % 8 of matrix
  // i / 8; matrices (keys +0 | +8) x (columns +0 | +8)
  const __nv_bfloat16* base =
      sv + (((lane >> 3) & 1) * 8 + (lane & 7)) * v_pitch + (lane >> 4) * 8;
#pragma unroll
  for (int ks = 0; ks < 2; ++ks) {            // keys 16 ks .. 16 ks + 15
    const uint32_t a[4] = {pack_bf16(p[2 * ks][0], p[2 * ks][1]),
                           pack_bf16(p[2 * ks][2], p[2 * ks][3]),
                           pack_bf16(p[2 * ks + 1][0], p[2 * ks + 1][1]),
                           pack_bf16(p[2 * ks + 1][2], p[2 * ks + 1][3])};
#pragma unroll
    for (int n = 0; n < NT; n += 2) {
      uint32_t b0, b1, b2, b3;
      asm volatile(
          "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
          "[%4];\n"
          : "=r"(b0), "=r"(b1), "=r"(b2), "=r"(b3)
          : "r"(smem_addr(base + 16 * ks * v_pitch + 8 * n))
          : "memory");
      mma_bf16(o[n], a, b0, b1);
      mma_bf16(o[n + 1], a, b2, b3);
    }
  }
}

__device__ __forceinline__ void store2(float* p, float a, float b, bool both,
                                       bool pair) {
  if (both && pair) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  } else {
    p[0] = a;
    if (both) p[1] = b;
  }
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b,
                                       bool both, bool pair) {
  if (both && pair) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
  } else {
    p[0] = __float2bfloat16(a);
    if (both) p[1] = __float2bfloat16(b);
  }
}

// NT: 8-column tiles of the output, dv <= 8 NT; each warp of a split group
// holds NT / kSplit of them.  The second launch bound is the blocks an SM
// the registers must leave room for.  An f32 block of dv > 64 takes 124 KB
// of shared memory at d = dv = 128 (157 KB at MLA's d = 192), so it runs
// one an SM and its registers need no cap: left to its own choice, ptxas
// gave the dv <= 128 instance 138 registers and it took 97.1 ms at MLA's
// prefill; bounded to one block, 185 and 86.0 ms (scripts/fa_accuracy.py).
// Narrower f32 blocks and the bf16 ones run two an SM.
template <typename T, int NT>
__global__ void __launch_bounds__(Layout<T>::kThreads,
                                  Layout<T>::kSplit == 2 && NT >= 16 ? 1 : 2)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out,
                       float* __restrict__ lse, int seq, int heads,
                       int kv_heads, int d, int dv, float scale, int window,
                       float softcap, bool vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int qk_pitch = Layout<T>::qk_pitch(d);
  constexpr int kSplit = Layout<T>::kSplit;
  constexpr int kThreads = Layout<T>::kThreads;
  constexpr int kVPitch = 8 * NT + (sizeof(T) == 4 ? 4 : 8);
  constexpr int kOwn = NT / kSplit;                  // n-tiles of one warp
  T* sQ = reinterpret_cast<T*>(smem_raw);            // [kBQ][qk_pitch]
  T* sK = sQ + kBQ * qk_pitch;                       // [2][kBK][qk_pitch]
  T* sV = sK + 2 * kBK * qk_pitch;                   // [2][kBK][kVPitch]
  float* sX = reinterpret_cast<float*>(sV + 2 * kBK * kVPitch);
                                          // [kGroups * kSplit][16][32]
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int group = warp % kGroups;  // the group's 16 rows: 16 group ..
  const int part = warp / kGroups;   // this warp's part of d and of dv
  const int g = lane >> 2, t = lane & 3;
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

  // the pad columns of Q, K and V stay zero: no copy writes them
  {
    const int n16 = static_cast<int>(
        (sizeof(T) * ((kBQ + 2 * kBK) * qk_pitch + 2 * kBK * kVPitch)) / 16);
    float4* p = reinterpret_cast<float4*>(smem_raw);
    for (int i = tid; i < n16; i += kThreads)
      p[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __syncthreads();

  const int q_end = min(q0 + kBQ, seq);              // keys [k_begin, q_end)
  int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  k_begin -= k_begin % kBK;
  const int tiles = (q_end - k_begin + kBK - 1) / kBK;

  stage<kThreads>(sQ, qk_pitch, qb + q0 * q_stride, q_stride, kBQ,
                  seq - q0, d, vec);
  stage<kThreads>(sK, qk_pitch, kb + k_begin * k_stride, k_stride, kBK,
                  seq - k_begin, d, vec);
  stage<kThreads>(sV, kVPitch, vb + k_begin * v_stride, v_stride, kBK,
                  seq - k_begin, dv, vec);
  cp_async_commit();

  const int row0 = q0 + 16 * group;                  // the group's rows
  const int r_pos[2] = {row0 + g, row0 + g + 8};     // this lane's rows
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float o[kOwn][4];
#pragma unroll
  for (int n = 0; n < kOwn; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  // d chunks [c0, c1) of this warp's (partial) scores
  const int chunks = (d + Layout<T>::kChunk - 1) / Layout<T>::kChunk;
  const int per_part = (chunks + kSplit - 1) / kSplit;
  const int c0 = min(chunks, part * per_part);
  const int c1 = min(chunks, c0 + per_part);
  const int lane_col = c0 * Layout<T>::kChunk + (Layout<T>::kChunk / 4) * t;
  const T* q_row = sQ + (16 * group + g) * qk_pitch + lane_col;
  float* x_mine = sX + warp * kExchange + lane;
  const float* x_pair = sX + (warp ^ kGroups) * kExchange + lane;

  for (int it = 0; it < tiles; ++it) {
    const int k0 = k_begin + it * kBK;
    const int buf = it & 1;
    if (it + 1 < tiles) {
      const int k1 = k0 + kBK;
      stage<kThreads>(sK + (buf ^ 1) * kBK * qk_pitch, qk_pitch,
                      kb + k1 * k_stride, k_stride, kBK, seq - k1, d, vec);
      stage<kThreads>(sV + (buf ^ 1) * kBK * kVPitch, kVPitch,
                      vb + k1 * v_stride, v_stride, kBK, seq - k1, dv, vec);
    }
    cp_async_commit();
    cp_async_wait_prior();
    __syncthreads();

    // can any row of this group see a key of this tile?  (the same answer
    // for the warps of a pair, so both reach their barrier or neither)
    const bool live = row0 < seq && k0 <= row0 + 15 &&
                      (window <= 0 || k0 + kBK - 1 > row0 - window);
    if (live) {
      const T* sk = sK + buf * kBK * qk_pitch;
      float s[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
      scores(s, q_row, sk + g * qk_pitch + lane_col, qk_pitch, c1 - c0);

      if constexpr (kSplit == 2) {
        // a pair adds its two partial sums over d; both warps get the same
        // scores, so the same softmax
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) x_mine[(4 * j + e) * 32] = s[j][e];
        asm volatile("bar.sync %0, 64;\n" ::"r"(1 + group) : "memory");
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[j][e] += x_pair[(4 * j + e) * 32];
      }

      // s[j][2 r + e]: row r_pos[r], key k0 + 8 j + 2 t + e
      float mt[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qpos = r_pos[e >> 1];
          const int kpos = k0 + 8 * j + 2 * t + (e & 1);
          const bool ok = kpos <= qpos && kpos < seq &&
                          (window <= 0 || kpos > qpos - window);
          float x = s[j][e] * scale;
          if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
          s[j][e] = ok ? x : kNegInf;
          mt[e >> 1] = fmaxf(mt[e >> 1], s[j][e]);
        }
      float alpha[2], mn[2], rs[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 1));
        mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 2));
        mn[r] = fmaxf(m[r], mt[r]);
        alpha[r] = expf(m[r] - mn[r]);
        m[r] = mn[r];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const float p = s[j][e] > kNegInf ? expf(s[j][e] - mn[r]) : 0.f;
          s[j][e] = p;
          rs[r] += p;
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
        rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
        l[r] = l[r] * alpha[r] + rs[r];
      }
#pragma unroll
      for (int n = 0; n < kOwn; ++n) {
        o[n][0] *= alpha[0];
        o[n][1] *= alpha[0];
        o[n][2] *= alpha[1];
        o[n][3] *= alpha[1];
      }
      pv<kOwn>(o, s, sV + buf * kBK * kVPitch + part * 8 * kOwn, kVPitch,
               lane);
    }
    __syncthreads();   // this buffer (and the partial scores) are consumed
  }

  const bool pair = (dv & 1) == 0;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qpos = r_pos[r];
    if (qpos >= seq) continue;
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
    if (lse != nullptr && part == 0 && t == 0)
      lse[(b * heads + h) * static_cast<int64_t>(seq) + qpos] =
          m[r] + logf(l[r]);
    T* orow = ob + qpos * o_stride;
#pragma unroll
    for (int n = 0; n < kOwn; ++n) {
      const int col = 8 * (part * kOwn + n) + 2 * t;
      if (col < dv)
        store2(orow + col, o[n][2 * r] * inv, o[n][2 * r + 1] * inv,
               col + 1 < dv, pair);
    }
  }
}

template <typename T, int NT>
int launch_nt(const void* q, const void* k, const void* v, void* out,
              float* lse, int batch, int seq, int heads, int kv_heads, int d,
              int dv, float scale, int window, float softcap,
              cudaStream_t stream) {
  auto kernel = flash_attention_kernel<T, NT>;
  const size_t smem = smem_bytes<T>(d, NT);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  constexpr int kVec = 16 / sizeof(T);
  const bool vec = d % kVec == 0 && dv % kVec == 0 &&
                   (reinterpret_cast<uintptr_t>(q) |
                    reinterpret_cast<uintptr_t>(k) |
                    reinterpret_cast<uintptr_t>(v)) % 16 == 0;
  const dim3 grid((seq + kBQ - 1) / kBQ, heads, batch);
  kernel<<<grid, Layout<T>::kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), lse, seq, heads,
      kv_heads, d, dv, scale, window, softcap, vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, float* lse,
           int batch, int seq, int heads, int kv_heads, int d, int dv,
           float scale, int window, float softcap, void* stream) {
  if (d < 1 || dv < 1 || d > kMaxDim || dv > kMaxDim || kv_heads < 1 ||
      heads % kv_heads != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dv <= 32)
    return launch_nt<T, 4>(q, k, v, out, lse, batch, seq, heads, kv_heads,
                           d, dv, scale, window, softcap, s);
  if (dv <= 64)
    return launch_nt<T, 8>(q, k, v, out, lse, batch, seq, heads, kv_heads,
                           d, dv, scale, window, softcap, s);
  if (dv <= 128)
    return launch_nt<T, 16>(q, k, v, out, lse, batch, seq, heads, kv_heads,
                            d, dv, scale, window, softcap, s);
  return launch_nt<T, 32>(q, k, v, out, lse, batch, seq, heads, kv_heads,
                          d, dv, scale, window, softcap, s);
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
  return launch<float>(q, k, v, out, nullptr, batch, seq, heads, kv_heads,
                       d, dv, scale, window, softcap, stream);
}

// The same with lse: (batch, heads, seq) f32, each query row's log-sum-exp
// (training: the backward rebuilds the probabilities from it).
int fa_forward_lse_f32(const void* q, const void* k, const void* v,
                       void* out, void* lse, int batch, int seq, int heads,
                       int kv_heads, int d, int dv, float scale, int window,
                       float softcap, void* stream) {
  return launch<float>(q, k, v, out, static_cast<float*>(lse), batch, seq,
                       heads, kv_heads, d, dv, scale, window, softcap,
                       stream);
}

int fa_forward_bf16(const void* q, const void* k, const void* v, void* out,
                    int batch, int seq, int heads, int kv_heads, int d,
                    int dv, float scale, int window, float softcap,
                    void* stream) {
  return launch<__nv_bfloat16>(q, k, v, out, nullptr, batch, seq, heads,
                               kv_heads, d, dv, scale, window, softcap,
                               stream);
}

// fa_forward_bf16 with lse, (batch, heads, seq) f32: the forward of
// training at bfloat16 (flash_attention_bwd.cu's fa_backward_bf16 reads
// it).  out is bit for bit fa_forward_bf16's.
int fa_forward_lse_bf16(const void* q, const void* k, const void* v,
                        void* out, void* lse, int batch, int seq, int heads,
                        int kv_heads, int d, int dv, float scale, int window,
                        float softcap, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, out, static_cast<float*>(lse), batch,
                               seq, heads, kv_heads, d, dv, scale, window,
                               softcap, stream);
}

}  // extern "C"
