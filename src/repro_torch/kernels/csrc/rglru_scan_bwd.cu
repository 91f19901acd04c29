// Backward of the RG-LRU gated linear recurrence (recurrentgemma-2b) for
// Hopper, sm_90a, float32 or bfloat16, with a plain C interface loaded
// through ctypes.
//
// The TPU package has no backward kernel: its training differentiates the
// lax.scan of rglru_forward (src/repro/models/rglru.py:67), and that is the
// reference here.  The forward is rglru_scan.cu: h_t = a_t h_{t-1} + bx_t,
// h_{-1} = 0, over (B, S, W), returning hs and h_last = h_{S-1}.
//
//   Given d hs (B, S, W) and d h_last (B, W), the reverse scan
//     g_t = d hs_t + a_{t+1} g_{t+1},   g_{S-1} = d hs_{S-1} + d h_last,
//   gives d bx_t = g_t and d a_t = g_t h_{t-1} (h_{-1} = 0), with hs the
//   forward's output (saved by the wrapper).
//
// What bounds it on an H100 (3.35 TB/s): bytes.  It reads a, hs and d hs
// and writes d a and d bx, 20 bytes a step and channel: at the training
// shape (1, 4096, 2560) 209.7 MB, a 62.6 us bound.
//
// Design: the recurrence with time reversed is the forward's, so this is
// the forward's chunked scan (rglru_scan.cu) walking S from the end, one
// pass over device memory.  A block owns kChannels = 32 channels of one b
// (80 blocks of 256 threads at the training shape) and walks S in tiles of
// kTile = 32 kSteps = 128 steps, the last tile first.  Each
// warp owns 4 channels (one 16-byte unit of a row) and its 32 lanes own 32
// sub-chunks of kSteps steps of the tile.  A tile:
//   1. each lane scans its sub-chunk from zero, latest step first, keeping
//      the affine map g_after -> g_before as (prod a, G);
//   2. the warp combines the 32 maps, lane 31 (the latest) first, in a
//      Kogge-Stone scan of shuffles (shfl_down), and applies the exclusive
//      one to the carry from the later tile: the g entering each
//      sub-chunk;
//   3. each lane runs its sub-chunk again from that g (within a sub-chunk
//      the rounding is the serial one), writing d bx = g in place of d hs
//      and d a = g h_{t-1} in place of hs; lane 0's g is the carry into the
//      earlier tile.
// The tiles of a (rows t + 1: a_{t+1} is step t's multiplier), d hs (rows
// t) and hs (rows t - 1) are copied into shared memory with cp.async in
// 16-byte units along W, coalesced, kStages tiles in flight, and d a and
// d bx leave shared memory the same way.  So a, d hs and hs are each read
// once and d a and d bx written once (plus one row a tile of a and hs),
// the bound's 20 bytes a step and channel, where the two-pass design
// before it read a and d hs twice.  The 16-byte unit q of row r is stored
// at unit (r W' + q) ^ ((r / kSteps) & 7) of the tile (W' = kChannels / 4
// units a row): the lanes' loads of one step, kSteps rows apart, hit
// distinct banks, and so do the copies' stores.  Steps at or past S scan
// as a = 1 (a_S = 1: g_{S-1} = d hs_{S-1} + d h_last) with d hs = 0, so
// the carry d h_last passes through; channels past W compute on zeros and
// store nothing.  W not a multiple of 4, or a pointer not 16-byte aligned,
// takes plain loads and stores in place of the 16-byte copies.  Any B, S
// and W.
//
// Measured on "NVIDIA H100 80GB HBM3, 700.00 W" (scripts/bwd_sweep.py, in
// turns, warm from a CUDA graph / cold with the L2 flushed, us): 78.1-79.1
// / 83.8-84.5 at (1, 4096, 2560), 79-80 % of the bound, where the
// two-pass design before it took 175.6-190.5 / 175.6-175.9.  Fewer
// channels a block fill more SMs (160 or 320 blocks) but read rows of 64
// or 32 bytes, and lost: (channels, tiles in flight, kSteps) = (8, 3, 4)
// 123.3-128.9 / 122.5-127.1, (8, 2, 4) 109.7-109.8 / 110.0-110.2,
// (8, 4, 4) 123.2-128.9 / 127.1, (8, 3, 8) 118.4-119.6 / 110.4-110.6,
// (16, 3, 4) 104.3 / 95.5-95.9, (16, 4, 4) 103.1-103.5 / 102.4-102.8,
// (16, 2, 8) 98.8-99.4 / 97.0-97.1, (16, 3, 8) 102.9-103.5 /
// 106.7-107.1; at 32 channels, (32, 4, 4) 79.8-80.1 / 88.9, (32, 2, 4)
// 84.7-85.1 / 86.6, (32, 3, 2) 101.3-102.7 / 106.7-107.0; (32, 3, 8) and
// (64, 3, 4) need more than a block's 227 KB of shared memory.
//
// Numerics.  Products and sums are fused (fmaf) and a sub-chunk's entry g
// comes from the combine, not from the serial recurrence, so the result is
// not bit-identical to the plain version; it stays within the forward's
// tolerance (atol 1e-5, rtol 0.05) and within 1e-4 of each gradient's
// largest entry, also with a close to 1 (tests/test_torch_lm_kernels.py
// emulates this order on the CPU).

// bfloat16 (rglru_scan_bwd_bf16): a, hs and d hs in bfloat16 (d h_last
// float32, as the forward's h_last), d a and d bx written in bfloat16.  A
// tile is converted to float32 as it is staged (plain 8-byte loads of 4
// channels in place of cp.async) and back as it leaves, so the scan is the
// float32 kernel's.  Both packages' recurrentgemma-2b runs this scan on
// float32 gates whatever the parameter type, so training at bfloat16
// launches the float32 instance.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kLanes = 32;                   // sub-chunks of a tile
constexpr int kSteps = 4;                    // steps of a sub-chunk
constexpr int kTile = kLanes * kSteps;       // steps of a tile
constexpr int kStages = 3;                   // tiles in flight
constexpr int kChannels = 32;                // channels a block
constexpr int kVec = 4;                      // channels a warp (16 bytes)
constexpr int kUnits = kChannels / kVec;     // 16-byte units a row, warps
constexpr int kThreads = kLanes * kUnits;
constexpr int kElems = kTile * kChannels;    // floats of one tile
// a (rows t + 1), d hs (rows t), hs (rows t - 1)
constexpr size_t kSmem = sizeof(float) * 3 * kStages * kElems;
static_assert(kChannels % kVec == 0 && kUnits * kSteps >= 8,
              "the swizzle needs the 8 units of a 128-byte line to span at "
              "most one sub-chunk's rows");

// float offset of 16-byte unit q of row r (the swizzle)
__device__ __forceinline__ int slot(int r, int q) {
  return ((r * kUnits + q) ^ ((r / kSteps) & 7)) * kVec;
}

__device__ __forceinline__ void load_vec(const float* p, float (&v)[kVec]) {
  const float4 w = *reinterpret_cast<const float4*>(p);
  v[0] = w.x;
  v[1] = w.y;
  v[2] = w.z;
  v[3] = w.w;
}
__device__ __forceinline__ void store_vec(float* p, const float (&v)[kVec]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
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

// Rows row0 .. row0 + kTile - 1 x channels [0, kChannels) of src (row pitch
// `width`) into the swizzled tile dst; rows outside [0, seq) and channels
// >= cols_ok are zeros.  vec: asynchronous 16-byte copies; otherwise plain
// loads and stores.
__device__ __forceinline__ void stage(float* dst, const float* src, int row0,
                                      int seq, int64_t width, int cols_ok,
                                      bool vec) {
  if (vec) {
#pragma unroll
    for (int i = threadIdx.x; i < kTile * kUnits; i += kThreads) {
      const int r = i / kUnits, q = i % kUnits, row = row0 + r;
      const bool ok = row >= 0 && row < seq && q * kVec < cols_ok;
      cp_async16(dst + slot(r, q),
                 src + (ok ? row * width + q * kVec : 0), ok ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < kElems; i += kThreads) {
      const int r = i / kChannels, c = i % kChannels, row = row0 + r;
      dst[slot(r, c / kVec) + c % kVec] =
          row >= 0 && row < seq && c < cols_ok ? src[row * width + c] : 0.f;
    }
  }
}

// The swizzled tile src to rows t0 .. t0 + kTile - 1 (those below seq) x
// channels [0, cols_ok) of dst.
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 w = *reinterpret_cast<const uint2*>(p);
  __nv_bfloat162 lo, hi;
  memcpy(&lo, &w.x, 4);
  memcpy(&hi, &w.y, 4);
  const float2 a = __bfloat1622float2(lo), b = __bfloat1622float2(hi);
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 w;
  memcpy(&w.x, &lo, 4);
  memcpy(&w.y, &hi, 4);
  *reinterpret_cast<uint2*>(p) = w;
}

// `stage` and `unstage` of bfloat16 rows: the same tiles as float32, by
// plain loads and stores (vec: 4 channels are one 8-byte unit)
__device__ __forceinline__ void stage(float* dst, const __nv_bfloat16* src,
                                      int row0, int seq, int64_t width,
                                      int cols_ok, bool vec) {
  if (vec) {
#pragma unroll
    for (int i = threadIdx.x; i < kTile * kUnits; i += kThreads) {
      const int r = i / kUnits, q = i % kUnits, row = row0 + r;
      const bool ok = row >= 0 && row < seq && q * kVec < cols_ok;
      *reinterpret_cast<float4*>(dst + slot(r, q)) =
          ok ? load4(src + row * width + q * kVec)
             : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  } else {
    for (int i = threadIdx.x; i < kElems; i += kThreads) {
      const int r = i / kChannels, c = i % kChannels, row = row0 + r;
      dst[slot(r, c / kVec) + c % kVec] =
          row >= 0 && row < seq && c < cols_ok
              ? __bfloat162float(src[row * width + c])
              : 0.f;
    }
  }
}

__device__ __forceinline__ void unstage(__nv_bfloat16* dst, const float* src,
                                        int t0, int seq, int64_t width,
                                        int cols_ok, bool vec) {
  if (vec) {
#pragma unroll
    for (int i = threadIdx.x; i < kTile * kUnits; i += kThreads) {
      const int r = i / kUnits, q = i % kUnits;
      if (t0 + r < seq && q * kVec < cols_ok)
        store4(dst + (t0 + r) * width + q * kVec,
               *reinterpret_cast<const float4*>(src + slot(r, q)));
    }
  } else {
    for (int i = threadIdx.x; i < kElems; i += kThreads) {
      const int r = i / kChannels, c = i % kChannels;
      if (t0 + r < seq && c < cols_ok)
        dst[(t0 + r) * width + c] =
            __float2bfloat16(src[slot(r, c / kVec) + c % kVec]);
    }
  }
}

__device__ __forceinline__ void unstage(float* dst, const float* src, int t0,
                                        int seq, int64_t width, int cols_ok,
                                        bool vec) {
  if (vec) {
#pragma unroll
    for (int i = threadIdx.x; i < kTile * kUnits; i += kThreads) {
      const int r = i / kUnits, q = i % kUnits;
      if (t0 + r < seq && q * kVec < cols_ok)
        *reinterpret_cast<float4*>(dst + (t0 + r) * width + q * kVec) =
            *reinterpret_cast<const float4*>(src + slot(r, q));
    }
  } else {
    for (int i = threadIdx.x; i < kElems; i += kThreads) {
      const int r = i / kChannels, c = i % kChannels;
      if (t0 + r < seq && c < cols_ok)
        dst[(t0 + r) * width + c] = src[slot(r, c / kVec) + c % kVec];
    }
  }
}

// Block: kUnits warps; warp u owns channels w0 + 4 u .. + 3, lane k steps
// k kSteps .. + kSteps - 1 of every tile.  Grid: (W / kChannels rounded
// up, B).
template <typename T>
__global__ void __launch_bounds__(kThreads)
rglru_scan_bwd_kernel(const T* __restrict__ a, const T* __restrict__ hs,
                      const T* __restrict__ dhs,
                      const float* __restrict__ dh_last,
                      T* __restrict__ da, T* __restrict__ dbx, int seq,
                      int width, bool vec) {
  extern __shared__ __align__(16) float smem[];
  float* s_a = smem;                          // [kStages][kElems] a, rows t + 1
  float* s_d = s_a + kStages * kElems;        // d hs, then d bx
  float* s_h = s_d + kStages * kElems;        // hs, rows t - 1, then d a

  const int lane = threadIdx.x % kLanes;
  const int u = threadIdx.x / kLanes;
  const int w0 = blockIdx.x * kChannels;
  const int cols_ok = min(kChannels, width - w0);
  const int64_t base = static_cast<int64_t>(blockIdx.y) * seq * width + w0;
  const int tiles = (seq + kTile - 1) / kTile;

  // tile i of the walk is tile tiles - 1 - i of S
  auto stage_tile = [&](int i, int buf) {
    const int t0 = (tiles - 1 - i) * kTile;
    stage(s_a + buf * kElems, a + base, t0 + 1, seq, width, cols_ok, vec);
    stage(s_d + buf * kElems, dhs + base, t0, seq, width, cols_ok, vec);
    stage(s_h + buf * kElems, hs + base, t0 - 1, seq, width, cols_ok, vec);
  };

  float carry[kVec];
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    const int c = u * kVec + j;
    carry[j] = c < cols_ok
                   ? dh_last[static_cast<int64_t>(blockIdx.y) * width + w0 + c]
                   : 0.f;
  }

  // one commit group per tile (empty past the first), so that waiting for
  // all but the kStages - 1 latest groups means: this tile has landed
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < tiles) stage_tile(i, i);
    cp_async_commit();
  }
  for (int i = 0, buf = 0; i < tiles; ++i) {
    __syncthreads();         // the buffer refilled next was stored out
    const int ahead = i + kStages - 1;
    if (ahead < tiles) stage_tile(ahead, (buf + kStages - 1) % kStages);
    cp_async_commit();
    cp_async_wait_stage();
    __syncthreads();

    const int t0 = (tiles - 1 - i) * kTile;
    const float* ta = s_a + buf * kElems;
    float* td = s_d + buf * kElems;
    float* th = s_h + buf * kElems;
    float av[kSteps][kVec], dv[kSteps][kVec];
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      load_vec(ta + slot(lane * kSteps + s, u), av[s]);
      load_vec(td + slot(lane * kSteps + s, u), dv[s]);
    }
    if (t0 + kTile >= seq) {   // the last tile: a_{t+1} = 1 for t >= S - 1
#pragma unroll
      for (int s = 0; s < kSteps; ++s) {
        if (t0 + lane * kSteps + s + 1 >= seq) {
#pragma unroll
          for (int j = 0; j < kVec; ++j) av[s][j] = 1.f;
        }
      }
    }

    // 1. the sub-chunk from zero, latest step first: g_before = A g + G
    float A[kVec], G[kVec];
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      A[j] = av[kSteps - 1][j];
      G[j] = dv[kSteps - 1][j];
    }
#pragma unroll
    for (int s = kSteps - 2; s >= 0; --s) {
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        G[j] = fmaf(av[s][j], G[j], dv[s][j]);
        A[j] *= av[s][j];
      }
    }
    // 2. inclusive scan of the maps from lane 31 down, then the g that
    // enters this lane's sub-chunk
#pragma unroll
    for (int d = 1; d < kLanes; d *= 2) {
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const float Ap = __shfl_down_sync(0xffffffffu, A[j], d);
        const float Gp = __shfl_down_sync(0xffffffffu, G[j], d);
        if (lane + d < kLanes) {
          G[j] = fmaf(A[j], Gp, G[j]);
          A[j] *= Ap;
        }
      }
    }
    float g[kVec];
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const float Ae = __shfl_down_sync(0xffffffffu, A[j], 1);
      const float Ge = __shfl_down_sync(0xffffffffu, G[j], 1);
      g[j] = lane == kLanes - 1 ? carry[j] : fmaf(Ae, carry[j], Ge);
    }
    // 3. the sub-chunk again from that g; d bx and d a replace d hs and hs
#pragma unroll
    for (int s = kSteps - 1; s >= 0; --s) {
      const int o = slot(lane * kSteps + s, u);
      float hp[kVec], dav[kVec];
      load_vec(th + o, hp);
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        g[j] = fmaf(av[s][j], g[j], dv[s][j]);
        dav[j] = g[j] * hp[j];
      }
      store_vec(td + o, g);
      store_vec(th + o, dav);
    }
#pragma unroll
    for (int j = 0; j < kVec; ++j) carry[j] = __shfl_sync(0xffffffffu, g[j], 0);
    __syncthreads();         // the tile's d bx and d a are complete

    unstage(dbx + base, td, t0, seq, width, cols_ok, vec);
    unstage(da + base, th, t0, seq, width, cols_ok, vec);
    buf = (buf + 1) % kStages;
  }
}

template <typename T>
int launch(const void* a, const void* hs, const void* dhs,
           const void* dh_last, void* da, void* dbx, int batch, int seq,
           int width, void* stream) {
  if (batch > 65535) return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0 || seq == 0 || width == 0) return 0;
  // 4 channels a unit: 16 bytes (f32, cp.async) or 8 (bf16)
  const bool vec = width % kVec == 0 &&
                   ((reinterpret_cast<uintptr_t>(a) |
                     reinterpret_cast<uintptr_t>(hs) |
                     reinterpret_cast<uintptr_t>(dhs) |
                     reinterpret_cast<uintptr_t>(da) |
                     reinterpret_cast<uintptr_t>(dbx)) %
                    (kVec * sizeof(T))) == 0;
  const cudaError_t err = cudaFuncSetAttribute(
      rglru_scan_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((width + kChannels - 1) / kChannels, batch);
  rglru_scan_bwd_kernel<T><<<grid, kThreads, kSmem,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(a), static_cast<const T*>(hs),
      static_cast<const T*>(dhs), static_cast<const float*>(dh_last),
      static_cast<T*>(da), static_cast<T*>(dbx), seq, width, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// a, hs, dhs, da, dbx: (batch, seq, width) f32 row-major; dh_last: (batch,
// width) f32.  Returns the CUDA error of the launch (0 on success).
int rglru_scan_bwd_f32(const void* a, const void* hs, const void* dhs,
                       const void* dh_last, void* da, void* dbx, int batch,
                       int seq, int width, void* stream) {
  return launch<float>(a, hs, dhs, dh_last, da, dbx, batch, seq, width,
                       stream);
}

// rglru_scan_bwd_f32 of bfloat16 a, hs, d hs (d h_last float32): d a and
// d bx in bfloat16.
int rglru_scan_bwd_bf16(const void* a, const void* hs, const void* dhs,
                        const void* dh_last, void* da, void* dbx, int batch,
                        int seq, int width, void* stream) {
  return launch<__nv_bfloat16>(a, hs, dhs, dh_last, da, dbx, batch, seq,
                               width, stream);
}

}  // extern "C"
