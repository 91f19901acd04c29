// Backward of causal flash attention (sliding window, tanh logit cap,
// grouped K/V heads) for Hopper, sm_90a, float32 or bfloat16, with a plain
// C interface loaded through ctypes.
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
//   o, dO: (B, S, H, dv); lse: (B, H, S).  d, dv <= 256.
//
// What bounds it on an H100: operations.  A reachable pair needs five
// products of its vectors, 2 (3 d + 2 dv) flops (S, dP, dV, dK, dQ).  At
// the training shape (B 1, S 4096, H 10, Kv 1, d = dv = 256, window 2048)
// the 62,924,800 reachable pairs are 1.611e11 flops: 0.98 ms as three
// TF32 tensor-core products each (3 x 1.611e11 over 495 TFLOP/s), 2.40 ms
// on the f32 CUDA cores.  This design computes S and dP twice, once in
// each pass (no atomics), 2.255e11 flops: 1.37 ms as 3xTF32.  The bytes
// (q, k, v, o, dO, lse read once, dq, dk, dv written once) bound it at
// ~0.05 ms.
//
// Numerics.  All five products run on the tensor cores through mma.sync
// m16n8k8 TF32 with the forward's 3xTF32 split (flash_attention.cu):
// hi = tf32(x), lo = tf32(x - hi), both rounded to nearest with ties away
// from zero, and a.b = hi_a.hi_b + (hi_a.lo_b + lo_a.hi_b) with f32
// accumulation.  In S and dP the two small products go to an accumulator
// of their own, added to the big one after the last d-step; in dV, dK and
// dQ a streamed tile's products are summed from zero, the small ones
// first, and added to the output in f32 (see outer_tiles).  D = rowsum(dO o), the softmax rebuilt from lse and dS = p (dP - D)
// stay in f32 on the CUDA cores.  Masked pairs get p = dS = 0 exactly.
//
// Design.  Three steps, no atomics (two calls on the same inputs give the
// same bits):
//   1. fa_bwd_delta_kernel: D_i, one warp a row.
//   2. fa_bwd_dkdv_kernel: one block per (key tile of 32, query head, b),
//      so that the grid fills the card when Kv = 1 and B = 1 (1,280 blocks
//      at the training shape, where one block per K/V head gave 128 on
//      132 SMs).  K and V of the tile stay in shared memory; the block
//      walks the query tiles of 32 that can see the tile (from the tile's
//      first key to its last key + window), Q and dO double-buffered with
//      cp.async, and adds P^T dO and dS^T Q into dV and dK held in the
//      mma accumulators.  When query heads share a K/V head, each block
//      writes its head's partial dK and dV into scratch, (B, H, S, d) and
//      (B, H, S, dv), and
//   2b. fa_bwd_sum_kernel adds each group's heads in head order (a fixed
//      order: the sum is deterministic).  With H = Kv the blocks write dK
//      and dV directly.
//   3. fa_bwd_dq_kernel: one block per (query tile of 32, head, b), late
//      tiles first, walking the reachable key tiles (K and V
//      double-buffered) and adding dS K into dQ.
// A block's 8 warps form 2 row groups of 16 (keys in step 2, queries in
// step 3) x 4 parts.  For S and dP the 4 warps of a group each take a
// quarter of d (of dv), like the forward's pairs, and add their partial
// scores through shared memory in one fixed order (a 128-thread named
// barrier), so all 4 hold the same 16 x 32 block of p and dS.  For the
// outputs each takes a quarter of the columns: p and dS go from the
// accumulator into the A fragment with no data movement (the forward's
// P V trick), and the streamed tile's rows are the B fragment.  So Q (K in
// step 3) and dO are read two ways: as 128-bit loads of 4 consecutive
// columns from one row (the scores' B fragment) and as 32-bit loads of one
// column from two rows (the outputs' B fragment).  Both are free of bank
// conflicts with rows padded to 8 words mod 16 and the n index g of an
// 8-row group standing for tile row perm(g) = {0, 6, 1, 7, 2, 4, 3, 5}[g]:
// a quarter-warp's 128-bit loads read rows perm(2m), perm(2m + 1), 16
// words apart mod 32, and an accumulator's columns 2t, 2t + 1 are rows t
// and t ^ 6, four rows 8 words apart for t = 0..3.  The A rows take the
// same permutation within each 8.  Shared memory at d = dv = 256: K and V
// 67.6 KB, two Q and dO tiles 135.2 KB, the partial scores 16 KB: 219,648
// bytes, one block an SM (and 255 registers a thread in step 2, with 44
// bytes of spill stores and 52 of loads, 207 in step 3, at d = 256: 8
// warps an SM either way).  Rows past S load as zeros; d and dv that are
// not a multiple of 16 bytes take plain loads in place of cp.async.  Any
// S, H a multiple of Kv, d and dv up to 256.
//
// Measured on "NVIDIA H100 80GB HBM3, 700.00 W" at the training shape
// (scripts/bwd_sweep.py and chip_smoke.py, in turns with the other
// version, ms warm / cold): 7.37-7.65 / 7.37-7.58, against the FMA kernel
// before it 26.9-27.6 / 26.9-27.6, SDPA's backward 12.96-13.08,
// the plain version 13.30-13.34: ~18 % of the two-pass 3xTF32 bound, each
// mma m16n8k8 taking ~6.5 SM cycles, as in the forward.  Summing each
// streamed tile from zero (outer_tiles) cost nothing measurable there:
// 7.33-7.37 against 7.40-7.52 in turns; at MLA's (1, 4096, 128 heads, d
// 192, dv 128) 106.1-106.7 against 106.4-107.0 (bound 10.83), at
// musicgen's (1, 4096, 32 heads, d 64) 16.60-16.61 against 16.39-16.47
// (scripts/fa_bwd_accuracy.py).  What lost:
//   - a thread-block cluster a (key tile, K/V head) in place of the
//     per-head partials, its blocks walking the group's heads in turn and
//     rank 0 adding their dK and dV through distributed shared memory:
//     2 blocks of 5 heads 8.60-8.83 / 8.58-8.61, 5 blocks of 2 heads
//     8.37-8.38 / 8.36-8.38 (this design 7.37-7.49 / 7.40-7.40);
//   - the output products with a branch per n-tile (before `kAll`):
//     9.36-9.56 / 9.36 (7.40-7.52 / 7.39); the dK/dV pass took 5.4 ms of
//     it and dQ 4.0.  With the branch in step 2 alone (240 registers, no
//     spills) 8.67-8.86 / 8.67 (7.39-7.51 / 7.37-7.38); with the n-tile
//     loop unrolled by 4 (its accumulators on the stack) 10.54-10.55 /
//     10.52-10.53;
//   - the output products in three phases over the n-tiles (hi lo, lo hi,
//     hi hi) 7.66-7.67 / 7.65-7.66, and with the scores' two small
//     products in accumulators of their own 7.63-7.64 / 7.62-7.65 (7.40);
//   - `#pragma unroll 4` over the score chunks 7.41-7.42 (7.45), dK's
//     products before dV's 7.38 (7.39): no difference; and the row
//     groups' named barriers removed (a timing-only variant) 9.31-9.32
//     against 9.36, ~0.5 %.

// bfloat16 (fa_backward_bf16, training at the plans' bfloat16).  q, k, v,
// o and dO are bfloat16, lse float32; dq, dk and dv are written in
// bfloat16, the type of the JAX package's gradient of bfloat16 inputs.
// The tiles are converted to float32 as they are staged (plain 8-byte
// loads in place of cp.async), so shared memory and the layouts are the
// float32 kernel's.  S = Q K^T and dP = dO V^T multiply two bfloat16
// inputs: they run on bfloat16 mma.sync m16n8k16 with f32 accumulators
// (scores_bf16), one instruction for the float32 kernel's six m16n8k8
// TF32 ones over 16 columns, the operands repacked exactly from the
// staged floats.  dV, dK and dQ multiply p or dS, computed in float32, by
// a staged bfloat16 tile: they keep the 3xTF32 split of p and dS, and
// drop the product with the tile's low part, which is zero (a bfloat16
// value is exact in TF32), so two m16n8k8 a k-step in place of three.
// So p and dS are not rounded to bfloat16 (the JAX package rounds them),
// every sum is f32, and the partial dK and dV of grouped heads stay
// float32 in the scratch; only the final stores round.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

namespace {

constexpr int kT = 32;                    // keys or queries of a tile
constexpr int kParts = 4;                 // warps of a row group of 16
constexpr int kWarps = 2 * kParts;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxDim = 256;
constexpr int kExchange = 16 * 32;        // floats of a warp's scores
constexpr int64_t kAlign = 64;            // floats: scratch regions

// d rounded up to the fragment loads' chunk of 16, plus 8: 8 words mod 16
__host__ __device__ inline int pitch_of(int n) {
  return (n + 15) / 16 * 16 + 8;
}
__host__ __device__ inline int64_t aligned(int64_t n) {
  return (n + kAlign - 1) / kAlign * kAlign;
}

// the tile row that n (or m) index g of an 8-row group stands for;
// perm(2t) = t, perm(2t + 1) = t ^ 6
__device__ __forceinline__ int perm(int g) {
  return (0x53427160 >> (4 * g)) & 15;
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

// rows [0, kT) x cols [0, cols) of src (row pitch src_pitch) into dst (row
// pitch dst_pitch); rows >= valid are zeros.  vec: cols and the pitches are
// whole 16-byte units and src is 16-byte aligned, so the copy is
// asynchronous; otherwise plain loads and stores.
__device__ __forceinline__ void stage(float* dst, int dst_pitch,
                                      const float* src, int64_t src_pitch,
                                      int valid, int cols, bool vec) {
  if (vec) {
    const int per_row = cols / 4;
    for (int i = threadIdx.x; i < kT * per_row; i += kThreads) {
      const int r = i / per_row, c = (i - r * per_row) * 4;
      const bool ok = r < valid;
      cp_async16(dst + r * dst_pitch + c, src + (ok ? r * src_pitch + c : 0),
                 ok ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < kT * cols; i += kThreads) {
      const int r = i / cols, c = i - r * cols;
      dst[r * dst_pitch + c] = r < valid ? src[r * src_pitch + c] : 0.f;
    }
  }
}

// four bfloat16 at p (8-byte aligned) as floats, and the reverse
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 w = *reinterpret_cast<const uint2*>(p);
  __nv_bfloat162 lo, hi;
  memcpy(&lo, &w.x, 4);
  memcpy(&hi, &w.y, 4);
  const float2 a = __bfloat1622float2(lo), b = __bfloat1622float2(hi);
  return make_float4(a.x, a.y, b.x, b.y);
}

// `stage` of a bfloat16 source: the same tile as float32, by plain loads
// (vec: cols and the source pitch are whole 8-byte units, src 8-byte
// aligned)
__device__ __forceinline__ void stage(float* dst, int dst_pitch,
                                      const __nv_bfloat16* src,
                                      int64_t src_pitch, int valid, int cols,
                                      bool vec) {
  if (vec) {
    const int per_row = cols / 4;
    for (int i = threadIdx.x; i < kT * per_row; i += kThreads) {
      const int r = i / per_row, c = (i - r * per_row) * 4;
      *reinterpret_cast<float4*>(dst + r * dst_pitch + c) =
          r < valid ? load4(src + r * src_pitch + c)
                    : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  } else {
    for (int i = threadIdx.x; i < kT * cols; i += kThreads) {
      const int r = i / cols, c = i - r * cols;
      dst[r * dst_pitch + c] =
          r < valid ? __bfloat162float(src[r * src_pitch + c]) : 0.f;
    }
  }
}

__device__ __forceinline__ float as_float(float x) { return x; }
__device__ __forceinline__ float as_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// lse and D of the kT rows from `row` into shared memory (zeros past seq)
__device__ __forceinline__ void stage_rows(float* sl, float* sd,
                                           const float* lrow,
                                           const float* drow, int row,
                                           int seq) {
  if (threadIdx.x < kT) {
    const int i = row + threadIdx.x;
    sl[threadIdx.x] = i < seq ? lrow[i] : 0.f;
    sd[threadIdx.x] = i < seq ? drow[i] : 0.f;
  }
}

// ---- tensor-core products --------------------------------------------- //

// hi = tf32(x), lo = tf32(x - hi), both rounded to nearest with ties away
// from zero as cvt.rna.tf32.f32 rounds, in integer ops (the forward's)
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

// c += a b, a: 16 x 16 (row), b: 16 x 8 (col), bfloat16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats that hold bfloat16 values as one bfloat16 pair, x in the low
// half: their high halves, exact (the low halves are zero)
__device__ __forceinline__ uint32_t pack_bf16(float x, float y) {
  return __byte_perm(__float_as_uint(x), __float_as_uint(y), 0x7632);
}

// s[j] (streamed rows 8 j + perm(n) of the tile) += A B^T over this warp's
// chunks of 16 columns, for its 16 A rows.  a_row: A's row perm(g) of the
// group at column 4t of its first chunk (row perm(g) + 8 is 8 rows on);
// b_row: B's row perm(g) at the same column.  Lane (g, t) loads columns
// 4t .. 4t + 3 of a chunk as one 128-bit word; each k-step takes these
// columns in place of the mma's own k order, the same for A and B, which
// the sum over columns does not see.
__device__ __forceinline__ void scores(float (&s)[4][4], const float* a_row,
                                       const float* b_row, int pitch,
                                       int chunks) {
  float small[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) small[j][e] = 0.f;
#pragma unroll 2
  for (int ch = 0; ch < chunks; ++ch) {
    const float4 xa = *reinterpret_cast<const float4*>(a_row + ch * 16);
    const float4 xb =
        *reinterpret_cast<const float4*>(a_row + 8 * pitch + ch * 16);
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
          b_row + 8 * j * pitch + ch * 16);
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

// `scores` of tiles that hold bfloat16 values, on bfloat16 m16n8k16: lane
// (g, t) holds columns 4t, 4t + 1 of a chunk as the mma's k = 2t, 2t + 1
// and columns 4t + 2, 4t + 3 as k = 2t + 8, 2t + 9, in A (rows g, g + 8)
// and B alike
__device__ __forceinline__ void scores_bf16(float (&s)[4][4],
                                            const float* a_row,
                                            const float* b_row, int pitch,
                                            int chunks) {
#pragma unroll 2
  for (int ch = 0; ch < chunks; ++ch) {
    const float4 xa = *reinterpret_cast<const float4*>(a_row + ch * 16);
    const float4 xb =
        *reinterpret_cast<const float4*>(a_row + 8 * pitch + ch * 16);
    const uint32_t a[4] = {pack_bf16(xa.x, xa.y), pack_bf16(xb.x, xb.y),
                           pack_bf16(xa.z, xa.w), pack_bf16(xb.z, xb.w)};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float4 kv = *reinterpret_cast<const float4*>(
          b_row + 8 * j * pitch + ch * 16);
      mma_bf16(s[j], a, pack_bf16(kv.x, kv.y), pack_bf16(kv.z, kv.w));
    }
  }
}

// the scores' products of tiles staged from T
template <typename T>
__device__ __forceinline__ void scores_of(float (&s)[4][4], const float* a_row,
                                          const float* b_row, int pitch,
                                          int chunks) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    scores_bf16(s, a_row, b_row, pitch, chunks);
  else
    scores(s, a_row, b_row, pitch, chunks);
}

// o[n] (columns 8 n .. 8 n + 7 from x) += W X over the tile's 32 streamed
// rows, for this warp's 16 rows.  w[j] holds the 16 x 8 block of streamed
// rows 8 j .. 8 j + 7 in the accumulator layout of `scores` (columns 2t,
// 2t + 1 stand for rows perm(2t) = t, perm(2t + 1) = t ^ 6); x: the
// streamed tile at this warp's first column, pitch px.  Each n-tile's
// product over the tile's 32 rows is summed from zero in the mma's
// accumulator (the small products first) and then added to o by an f32
// add, which rounds to nearest.  Carrying o itself as the mma's C operand
// over every tile let dK, dV and dQ drift, as the forward's output did:
// the tensor core's accumulate does not round to nearest, so a sum over
// 4096 rows lost ~5e-5 of itself in one direction (MLA's and musicgen's
// first layers on their own inputs, scripts/fa_bwd_accuracy.py; the
// plain f32 version ~3e-6).  kAll: all NT n-tiles are live, so the
// unrolled loop has no branch; otherwise n-tiles at or past `cols`
// columns are skipped.  kExact: x holds bfloat16 values, whose TF32 low
// part is zero, so the product with it is left out.
template <int NT, bool kAll, bool kExact>
__device__ __forceinline__ void outer_tiles(float (&o)[NT][4],
                                            const float (&w)[4][4],
                                            const float* x, int px, int cols,
                                            int lane) {
  const int g = lane >> 2, t = lane & 3;
  // k-step j: mma k = t <-> row 8 j + t, k = t + 4 <-> row 8 j + (t ^ 6)
  uint32_t ah[4][4], al[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    split(w[j][0], ah[j][0], al[j][0]);
    split(w[j][2], ah[j][1], al[j][1]);
    split(w[j][1], ah[j][2], al[j][2]);
    split(w[j][3], ah[j][3], al[j][3]);
  }
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    if (kAll || 8 * n < cols) {
      float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float* x0 = x + (8 * j + t) * px + g + 8 * n;
        const float* x1 = x + (8 * j + (t ^ 6)) * px + g + 8 * n;
        uint32_t bh0, bl0, bh1, bl1;
        if (kExact) {
          bh0 = __float_as_uint(*x0);
          bh1 = __float_as_uint(*x1);
        } else {
          split(*x0, bh0, bl0);
          split(*x1, bh1, bl1);
          mma_tf32(c, ah[j], bl0, bl1);
        }
        mma_tf32(c, al[j], bh0, bh1);
        mma_tf32(c, ah[j], bh0, bh1);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] += c[e];
    }
  }
}

template <typename T, int NT>
__device__ __forceinline__ void outer(float (&o)[NT][4], const float (&w)[4][4],
                                      const float* x, int px, int cols,
                                      int lane) {
  constexpr bool kExact = std::is_same<T, __nv_bfloat16>::value;
  if (cols >= 8 * NT)
    outer_tiles<NT, true, kExact>(o, w, x, px, cols, lane);
  else
    outer_tiles<NT, false, kExact>(o, w, x, px, cols, lane);
}

// the 4 warps of a row group (ids 1 and 2; __syncthreads is 0)
__device__ __forceinline__ void group_sync(int warp) {
  static_assert(kParts == 4, "a row group is 128 threads");
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + warp / kParts) : "memory");
}

// s = the sum of the partial scores of the row group's 4 warps, added in
// one order in all 4, so that they hold the same bits
__device__ __forceinline__ void exchange(float (&s)[4][4], float* sx,
                                         int warp, int lane) {
  float4* mine = reinterpret_cast<float4*>(sx + warp * kExchange) + lane;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    mine[32 * j] = make_float4(s[j][0], s[j][1], s[j][2], s[j][3]);
  group_sync(warp);
  const float4* first = reinterpret_cast<const float4*>(
                            sx + (warp / kParts) * kParts * kExchange) + lane;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float4 acc = first[32 * j];
#pragma unroll
    for (int p = 1; p < kParts; ++p) {
      const float4 x = first[p * kExchange / 4 + 32 * j];
      acc.x += x.x;
      acc.y += x.y;
      acc.z += x.z;
      acc.w += x.w;
    }
    s[j][0] = acc.x;
    s[j][1] = acc.y;
    s[j][2] = acc.z;
    s[j][3] = acc.w;
  }
}

// p and dS of this lane's 16 entries, in place of the scores s and dP dp:
// entry (j, e) is A row r_pos[e >> 1] against streamed row 8 j + (t or
// t ^ 6); keys_are_rows: A rows are keys (step 2) or queries (step 3)
__device__ __forceinline__ void probs(float (&s)[4][4], float (&dp)[4][4],
                                      const int (&a_pos)[2], int b0,
                                      bool keys_are_rows, const float* lb,
                                      const float* db, const float (&la)[2],
                                      const float (&da)[2], int t, int seq,
                                      float scale, int window,
                                      float softcap) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int br = 8 * j + ((e & 1) ? (t ^ 6) : t);
      const int ap = a_pos[e >> 1], bp = b0 + br;
      const int i = keys_are_rows ? bp : ap;    // query
      const int jk = keys_are_rows ? ap : bp;   // key
      const bool ok = i < seq && jk <= i && (window <= 0 || jk > i - window);
      const float L = keys_are_rows ? lb[br] : la[e >> 1];
      const float D = keys_are_rows ? db[br] : da[e >> 1];
      float x = s[j][e] * scale, th = 0.f;
      if (softcap > 0.f) {
        th = tanhf(x / softcap);
        x = th * softcap;
      }
      const float p = ok ? expf(x - L) : 0.f;
      float ds = p * (dp[j][e] - D);
      if (softcap > 0.f) ds *= 1.f - th * th;
      s[j][e] = p;
      dp[j][e] = ds;
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

// rows R and R + 8 of this warp's accumulators o into the rows of dst at
// positions pos[0], pos[1] (row stride `stride`), columns col0 + 8 n + 2t
// below `dim`, times `mul`
template <int NT, typename O>
__device__ __forceinline__ void store_rows(O* dst, int64_t stride,
                                           const float (&o)[NT][4],
                                           const int (&pos)[2], int seq,
                                           int col0, int dim, int t,
                                           float mul) {
  const bool pair = (dim & 1) == 0;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (pos[r] >= seq) continue;
    O* row = dst + pos[r] * stride;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int col = col0 + 8 * n + 2 * t;
      if (col < dim)
        store2(row + col, o[n][2 * r] * mul, o[n][2 * r + 1] * mul,
               col + 1 < dim, pair);
    }
  }
}

// D = rowsum(dO * o): one warp a (b, i, h) row, rows in memory order
template <typename T>
__global__ void __launch_bounds__(256)
fa_bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                    float* __restrict__ delta, int64_t rows, int seq,
                    int heads, int dv) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const T* po = o + row * dv;
  const T* pd = dout + row * dv;
  float acc = 0.f;
  for (int c = lane; c < dv; c += 32)
    acc = fmaf(as_float(po[c]), as_float(pd[c]), acc);
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

// K and V (or Q and dO), two tiles of the other pair, the partial scores,
// and (step 2) two tiles' lse and D
size_t bwd_smem(int d, int dv) {
  return sizeof(float) * (3 * kT * static_cast<size_t>(pitch_of(d) +
                                                       pitch_of(dv)) +
                          kWarps * kExchange + 4 * kT);
}

// where this warp's chunks of 16 columns of an n-column row begin and end
__device__ __forceinline__ void part_chunks(int n, int part, int& c0,
                                            int& c1) {
  const int chunks = (n + 15) / 16;
  const int per = (chunks + kParts - 1) / kParts;
  c0 = min(chunks, part * per);
  c1 = min(chunks, c0 + per);
}

// NT: 8-column tiles of dK and dV a warp holds; 4 parts x 8 NT >= d, dv
template <typename T, int NT>
__global__ void __launch_bounds__(kThreads, 1)
fa_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const T* __restrict__ dout,
                   const float* __restrict__ lse,
                   float* __restrict__ scratch, T* __restrict__ dk,
                   T* __restrict__ dvo, Dims z, bool vec) {
  extern __shared__ __align__(16) float smem[];
  const int pd = pitch_of(z.d), pv = pitch_of(z.dv);
  float* sK = smem;                    // [kT][pd]
  float* sV = sK + kT * pd;            // [kT][pv]
  float* sQ = sV + kT * pv;            // [2][kT][pd]
  float* sO = sQ + 2 * kT * pd;        // [2][kT][pv]  dO
  float* sX = sO + 2 * kT * pv;        // [kWarps][kExchange]
  float* sL = sX + kWarps * kExchange; // [2][kT] lse
  float* sD = sL + 2 * kT;             // [2][kT] delta
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rg = warp / kParts, part = warp % kParts;
  const int g = lane >> 2, t = lane & 3;
  const int kt = blockIdx.x / z.heads, h = blockIdx.x % z.heads;
  const int k0 = kt * kT;
  const int64_t b = blockIdx.y;
  const int group = z.heads / z.kv_heads, kvh = h / group;
  const int64_t qs = static_cast<int64_t>(z.heads) * z.d;
  const int64_t os = static_cast<int64_t>(z.heads) * z.dv;
  const int64_t ks = static_cast<int64_t>(z.kv_heads) * z.d;
  const int64_t vs = static_cast<int64_t>(z.kv_heads) * z.dv;
  const T* qb = q + b * z.seq * qs + static_cast<int64_t>(h) * z.d;
  const T* ob = dout + b * z.seq * os + static_cast<int64_t>(h) * z.dv;
  const float* lrow = lse + (b * z.heads + h) * z.seq;
  const float* drow = scratch + (b * z.heads + h) * z.seq;   // D

  // the pad columns stay zero: no copy writes them
  for (int i = tid; i < 3 * kT * (pd + pv); i += kThreads) smem[i] = 0.f;
  __syncthreads();

  stage(sK, pd, k + (b * z.seq + k0) * ks + kvh * z.d, ks, z.seq - k0, z.d,
        vec);
  stage(sV, pv, v + (b * z.seq + k0) * vs + kvh * z.dv, vs, z.seq - k0,
        z.dv, vec);
  // queries that can see a key of this tile: [k0, k0 + kT - 1 + window)
  const int q_end = z.window > 0 ? min(z.seq, k0 + kT - 1 + z.window)
                                 : z.seq;
  const int n_q = (q_end - k0 + kT - 1) / kT;
  stage(sQ, pd, qb + k0 * qs, qs, z.seq - k0, z.d, vec);
  stage(sO, pv, ob + k0 * os, os, z.seq - k0, z.dv, vec);
  stage_rows(sL, sD, lrow, drow, k0, z.seq);
  cp_async_commit();

  // this lane's A rows (keys of the tile): R0 and R0 + 8
  const int R0 = 16 * rg + perm(g);
  const int a_pos[2] = {k0 + R0, k0 + R0 + 8};
  int c0q, c1q, c0v, c1v;
  part_chunks(z.d, part, c0q, c1q);
  part_chunks(z.dv, part, c0v, c1v);
  const float* k_row = sK + R0 * pd + c0q * 16 + 4 * t;
  const float* v_row = sV + R0 * pv + c0v * 16 + 4 * t;
  const int bq = perm(g) * pd + c0q * 16 + 4 * t;   // in a Q tile
  const int bo = perm(g) * pv + c0v * 16 + 4 * t;   // in a dO tile
  const int col0 = part * 8 * NT;
  const float none[2] = {0.f, 0.f};
  float acc_k[NT][4], acc_v[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[n][e] = acc_v[n][e] = 0.f;

  const int kmin = k0 + 16 * rg, kmax = kmin + 15;   // the group's keys
  for (int it = 0; it < n_q; ++it) {
    const int q0 = k0 + it * kT, buf = it & 1;
    if (it + 1 < n_q) {
      const int q1 = q0 + kT, nb = buf ^ 1;
      stage(sQ + nb * kT * pd, pd, qb + q1 * qs, qs, z.seq - q1, z.d, vec);
      stage(sO + nb * kT * pv, pv, ob + q1 * os, os, z.seq - q1, z.dv, vec);
      stage_rows(sL + nb * kT, sD + nb * kT, lrow, drow, q1, z.seq);
    }
    cp_async_commit();
    cp_async_wait_prior();
    __syncthreads();

    // can a key of this row group see a query of this tile?  (one answer
    // for the group's 4 warps, so all reach their barriers or none)
    const int qmax = min(q0 + kT, z.seq) - 1;
    const bool live = kmin < z.seq && kmin <= qmax &&
                      (z.window <= 0 || kmax > q0 - z.window);
    if (live) {
      const float* sq = sQ + buf * kT * pd;
      const float* so = sO + buf * kT * pv;
      float s[4][4], dp[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
      scores_of<T>(s, k_row, sq + bq, pd, c1q - c0q);
      exchange(s, sX, warp, lane);
      scores_of<T>(dp, v_row, so + bo, pv, c1v - c0v);
      group_sync(warp);                // every warp has read the scores
      exchange(dp, sX, warp, lane);
      probs(s, dp, a_pos, q0, true, sL + buf * kT, sD + buf * kT, none,
            none, t, z.seq, z.scale, z.window, z.softcap);
      outer<T, NT>(acc_v, s, so + col0, pv, z.dv - col0, lane);
      outer<T, NT>(acc_k, dp, sq + col0, pd, z.d - col0, lane);
    }
    __syncthreads();   // this buffer (and the partial scores) are consumed
  }

  // H = Kv: dK and dV directly; otherwise this head's partials, (B, H, S,
  // d) and (B, H, S, dv) after D in the scratch
  const int64_t n_rows = static_cast<int64_t>(gridDim.y) * z.heads * z.seq;
  float* part_k = scratch + aligned(n_rows);
  float* part_v = part_k + aligned(n_rows * z.d);
  const int64_t head_row = (b * z.heads + h) * z.seq;
  if (group == 1) {
    store_rows<NT>(dk + b * z.seq * ks + kvh * z.d, ks, acc_k, a_pos,
                   z.seq, col0, z.d, t, z.scale);
    store_rows<NT>(dvo + b * z.seq * vs + kvh * z.dv, vs, acc_v, a_pos,
                   z.seq, col0, z.dv, t, 1.f);
  } else {
    store_rows<NT>(part_k + head_row * z.d, z.d, acc_k, a_pos, z.seq, col0,
                   z.d, t, z.scale);
    store_rows<NT>(part_v + head_row * z.dv, z.dv, acc_v, a_pos, z.seq,
                   col0, z.dv, t, 1.f);
  }
}

// out (B, S, Kv, dim) = the sum over each group's heads of part (B, H, S,
// dim), in head order
template <typename T>
__global__ void __launch_bounds__(256)
fa_bwd_sum_kernel(const float* __restrict__ part, T* __restrict__ out,
                  int64_t n, int seq, int heads, int kv_heads, int dim) {
  const int group = heads / kv_heads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int c = static_cast<int>(i % dim);
    int64_t r = i / dim;
    const int kvh = static_cast<int>(r % kv_heads);
    r /= kv_heads;
    const int j = static_cast<int>(r % seq);
    const int64_t b = r / seq;
    const float* p =
        part + ((b * heads + kvh * group) * seq + j) * dim + c;
    float acc = 0.f;
    for (int hh = 0; hh < group; ++hh)
      acc += p[static_cast<int64_t>(hh) * seq * dim];
    store2(out + i, acc, 0.f, false, false);
  }
}

template <typename T, int NT>
__global__ void __launch_bounds__(kThreads, 1)
fa_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, T* __restrict__ dq,
                 Dims z, bool vec) {
  extern __shared__ __align__(16) float smem[];
  const int pd = pitch_of(z.d), pv = pitch_of(z.dv);
  float* sQ = smem;                    // [kT][pd]
  float* sO = sQ + kT * pd;            // [kT][pv]  dO
  float* sK = sO + kT * pv;            // [2][kT][pd]
  float* sV = sK + 2 * kT * pd;        // [2][kT][pv]
  float* sX = sV + 2 * kT * pv;        // [kWarps][kExchange]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rg = warp / kParts, part = warp % kParts;
  const int g = lane >> 2, t = lane & 3;
  const int tiles = (z.seq + kT - 1) / kT;
  const int qt = tiles - 1 - static_cast<int>(blockIdx.x) / z.heads;
  const int h = blockIdx.x % z.heads;   // late query tiles first
  const int q0 = qt * kT;
  const int64_t b = blockIdx.y;
  const int kvh = h / (z.heads / z.kv_heads);
  const int64_t qs = static_cast<int64_t>(z.heads) * z.d;
  const int64_t os = static_cast<int64_t>(z.heads) * z.dv;
  const int64_t ks = static_cast<int64_t>(z.kv_heads) * z.d;
  const int64_t vs = static_cast<int64_t>(z.kv_heads) * z.dv;
  const T* kb = k + b * z.seq * ks + static_cast<int64_t>(kvh) * z.d;
  const T* vb = v + b * z.seq * vs + static_cast<int64_t>(kvh) * z.dv;

  for (int i = tid; i < 3 * kT * (pd + pv); i += kThreads) smem[i] = 0.f;
  __syncthreads();

  stage(sQ, pd, q + (b * z.seq + q0) * qs + h * z.d, qs, z.seq - q0, z.d,
        vec);
  stage(sO, pv, dout + (b * z.seq + q0) * os + h * z.dv, os, z.seq - q0,
        z.dv, vec);
  // keys this tile's queries can see: [q0 - window + 1, q0 + kT)
  int k_begin = z.window > 0 ? max(0, q0 - z.window + 1) : 0;
  k_begin -= k_begin % kT;
  const int k_end = min(z.seq, q0 + kT);
  const int n_k = (k_end - k_begin + kT - 1) / kT;
  stage(sK, pd, kb + k_begin * ks, ks, z.seq - k_begin, z.d, vec);
  stage(sV, pv, vb + k_begin * vs, vs, z.seq - k_begin, z.dv, vec);
  cp_async_commit();

  // this lane's A rows (queries of the tile), their lse and D
  const int R0 = 16 * rg + perm(g);
  const int a_pos[2] = {q0 + R0, q0 + R0 + 8};
  float la[2], da[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool in = a_pos[r] < z.seq;
    const int64_t o = (b * z.heads + h) * z.seq + a_pos[r];
    la[r] = in ? lse[o] : 0.f;
    da[r] = in ? delta[o] : 0.f;
  }
  int c0q, c1q, c0v, c1v;
  part_chunks(z.d, part, c0q, c1q);
  part_chunks(z.dv, part, c0v, c1v);
  const float* q_row = sQ + R0 * pd + c0q * 16 + 4 * t;
  const float* o_row = sO + R0 * pv + c0v * 16 + 4 * t;
  const int bk = perm(g) * pd + c0q * 16 + 4 * t;   // in a K tile
  const int bv = perm(g) * pv + c0v * 16 + 4 * t;   // in a V tile
  const int col0 = part * 8 * NT;
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  const int qmin = q0 + 16 * rg;                       // the group's queries
  const int qmax = min(qmin + 15, z.seq - 1);
  for (int it = 0; it < n_k; ++it) {
    const int k0 = k_begin + it * kT, buf = it & 1;
    if (it + 1 < n_k) {
      const int k1 = k0 + kT, nb = buf ^ 1;
      stage(sK + nb * kT * pd, pd, kb + k1 * ks, ks, z.seq - k1, z.d, vec);
      stage(sV + nb * kT * pv, pv, vb + k1 * vs, vs, z.seq - k1, z.dv, vec);
    }
    cp_async_commit();
    cp_async_wait_prior();
    __syncthreads();

    const bool live = qmin < z.seq && k0 <= qmax &&
                      (z.window <= 0 || k0 + kT - 1 > qmin - z.window);
    if (live) {
      const float* sk = sK + buf * kT * pd;
      const float* sv = sV + buf * kT * pv;
      float s[4][4], dp[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
      scores_of<T>(s, q_row, sk + bk, pd, c1q - c0q);
      exchange(s, sX, warp, lane);
      scores_of<T>(dp, o_row, sv + bv, pv, c1v - c0v);
      group_sync(warp);
      exchange(dp, sX, warp, lane);
      probs(s, dp, a_pos, k0, false, nullptr, nullptr, la, da, t, z.seq,
            z.scale, z.window, z.softcap);
      outer<T, NT>(acc, dp, sk + col0, pd, z.d - col0, lane);
    }
    __syncthreads();
  }

  store_rows<NT>(dq + b * z.seq * qs + static_cast<int64_t>(h) * z.d, qs,
                 acc, a_pos, z.seq, col0, z.d, t, z.scale);
}

template <typename T, int NT>
int launch_nt(const T* q, const T* k, const T* v, const T* dout,
              const float* lse, float* scratch, T* dq, T* dk, T* dv,
              int batch, const Dims& z, bool vec, cudaStream_t s) {
  const size_t smem = bwd_smem(z.d, z.dv);
  cudaError_t err = cudaFuncSetAttribute(
      fa_bwd_dkdv_kernel<T, NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(fa_bwd_dq_kernel<T, NT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (z.seq + kT - 1) / kT;
  const dim3 grid(static_cast<unsigned>(tiles) * z.heads, batch);
  fa_bwd_dkdv_kernel<T, NT><<<grid, kThreads, smem, s>>>(
      q, k, v, dout, lse, scratch, dk, dv, z, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (z.heads != z.kv_heads) {
    const int64_t n_rows = static_cast<int64_t>(batch) * z.heads * z.seq;
    const float* part_k = scratch + aligned(n_rows);
    const float* part_v = part_k + aligned(n_rows * z.d);
    const int64_t out_rows = static_cast<int64_t>(batch) * z.seq * z.kv_heads;
    for (int which = 0; which < 2; ++which) {
      const int dim = which == 0 ? z.d : z.dv;
      const int64_t n = out_rows * dim;
      const int64_t blocks = (n + 255) / 256 < (1 << 20) ? (n + 255) / 256
                                                         : (1 << 20);
      fa_bwd_sum_kernel<T><<<static_cast<unsigned>(blocks), 256, 0, s>>>(
          which == 0 ? part_k : part_v, which == 0 ? dk : dv, n, z.seq,
          z.heads, z.kv_heads, dim);
      err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
  }
  fa_bwd_dq_kernel<T, NT><<<grid, kThreads, smem, s>>>(
      q, k, v, dout, lse, scratch, dq, z, vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const void* lse, void* delta, void* dq,
           void* dk, void* dv, int batch, int seq, int heads, int kv_heads,
           int d, int dv_dim, float scale, int window, float softcap,
           void* stream) {
  if (d < 1 || dv_dim < 1 || d > kMaxDim || dv_dim > kMaxDim ||
      kv_heads < 1 || heads % kv_heads != 0 || batch > 65535 ||
      heads > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0 || seq == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Dims z{seq, heads, kv_heads, d, dv_dim, window, scale, softcap};
  const int64_t rows = static_cast<int64_t>(batch) * seq * heads;
  fa_bwd_delta_kernel<T><<<static_cast<unsigned>((rows + 7) / 8), 256, 0,
                           s>>>(static_cast<const T*>(o),
                                static_cast<const T*>(dout),
                                static_cast<float*>(delta), rows, seq, heads,
                                dv_dim);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  // 16-byte (f32) or 8-byte (bf16) units of 4 columns
  const bool vec = d % 4 == 0 && dv_dim % 4 == 0 &&
                   (reinterpret_cast<uintptr_t>(q) |
                    reinterpret_cast<uintptr_t>(k) |
                    reinterpret_cast<uintptr_t>(v) |
                    reinterpret_cast<uintptr_t>(dout)) % (4 * sizeof(T)) == 0;
  const auto* qf = static_cast<const T*>(q);
  const auto* kf = static_cast<const T*>(k);
  const auto* vf = static_cast<const T*>(v);
  const auto* df = static_cast<const T*>(dout);
  const auto* lf = static_cast<const float*>(lse);
  auto* sf = static_cast<float*>(delta);
  auto* dqf = static_cast<T*>(dq);
  auto* dkf = static_cast<T*>(dk);
  auto* dvf = static_cast<T*>(dv);
  const int widest = d > dv_dim ? d : dv_dim;
  if (widest <= 32)
    return launch_nt<T, 1>(qf, kf, vf, df, lf, sf, dqf, dkf, dvf, batch, z,
                           vec, s);
  if (widest <= 64)
    return launch_nt<T, 2>(qf, kf, vf, df, lf, sf, dqf, dkf, dvf, batch, z,
                           vec, s);
  if (widest <= 128)
    return launch_nt<T, 4>(qf, kf, vf, df, lf, sf, dqf, dkf, dvf, batch, z,
                           vec, s);
  return launch_nt<T, 8>(qf, kf, vf, df, lf, sf, dqf, dkf, dvf, batch, z,
                         vec, s);
}

}  // namespace

extern "C" {

// q: (batch, seq, heads, d), k: (batch, seq, kv_heads, d), v: (batch, seq,
// kv_heads, dv), o and dout: (batch, seq, heads, dv), lse: (batch, heads,
// seq), all f32 and row-major.  delta: f32 scratch of batch * heads * seq
// floats when heads == kv_heads; otherwise of
// a(n) + a(n d) + n dv floats, n = batch * heads * seq and a(x) = x
// rounded up to a multiple of 64 (D, then each head's partial dK and dV).
// Writes dq, dk, dv (the shapes of q, k, v).  Three or five launches on
// `stream`; returns the first CUDA error (0 on success).
int fa_backward_f32(const void* q, const void* k, const void* v,
                    const void* o, const void* dout, const void* lse,
                    void* delta, void* dq, void* dk, void* dv, int batch,
                    int seq, int heads, int kv_heads, int d, int dv_dim,
                    float scale, int window, float softcap, void* stream) {
  return launch<float>(q, k, v, o, dout, lse, delta, dq, dk, dv, batch, seq,
                       heads, kv_heads, d, dv_dim, scale, window, softcap,
                       stream);
}

// fa_backward_f32 of bfloat16 q, k, v, o, dout (lse and the scratch
// float32): dq, dk, dv written in bfloat16 (the notes at the top).
int fa_backward_bf16(const void* q, const void* k, const void* v,
                     const void* o, const void* dout, const void* lse,
                     void* delta, void* dq, void* dk, void* dv, int batch,
                     int seq, int heads, int kv_heads, int d, int dv_dim,
                     float scale, int window, float softcap, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, o, dout, lse, delta, dq, dk, dv,
                               batch, seq, heads, kv_heads, d, dv_dim, scale,
                               window, softcap, stream);
}

}  // extern "C"
