// RG-LRU gated linear recurrence (recurrentgemma-2b) for Hopper, sm_90a,
// with a plain C interface loaded through ctypes.
//
// Replaces the Pallas TPU kernel of src/repro/kernels/rglru_scan.py:
//   rglru_scan_kernel  <- _kernel (:22), reached through rglru_scan (:38)
//
//   h_t = a_t * h_{t-1} + bx_t,  h_{-1} = 0,  elementwise over the width W.
//   a, bx: (B, S, W) f32 or bf16 -> hs: (B, S, W) in a's type, and the
//   final state h_last: (B, W) in f32.  The state is carried in f32.
//
// What bounds it on an H100 (3.35 TB/s): bytes.  One multiply and one add
// per 12 bytes moved (f32: a and bx read, hs written), far below the
// card's balance point.  At the serving path's shape (B = 4, S = 4096,
// W = 2560) it moves 503 MB in f32, a 150 us bound, and 252 MB in bf16,
// 75 us.  Reaching it takes ~2.3 MB of loads in flight at all times (3.35
// TB/s times ~0.7 us of latency).  One thread a channel walking S, the
// first design, kept at most ~1.3 MB in flight, and none while it stored.
//
// Design: a chunked scan over S, one pass over device memory.  A block owns
// kChannels = 32 channels of one b (320 blocks on the serving path, over
// two an SM) and walks S in tiles of kTile = 128 steps.  Each warp owns kVec = 16 / sizeof(T)
// channels (one 16-byte unit of a row) and its 32 lanes own 32 sub-chunks
// of kSteps = 4 steps of the tile.  A tile:
//   1. each lane scans its sub-chunk from zero, keeping (prod a, h);
//   2. the warp combines the 32 pairs with the associative operator
//      (A, H) o (A', H') = (A A', A' H + H') in a Kogge-Stone scan of
//      shuffles, and applies the exclusive prefix to the carry from the
//      previous tile: the state entering each sub-chunk;
//   3. each lane runs its sub-chunk's recurrence again from that state (so
//      within a sub-chunk the rounding is the serial one) and writes h in
//      place of bx; the last lane's h is the carry into the next tile.
// The tiles of a and bx are copied into shared memory with cp.async in
// 16-byte units along W, coalesced, double-buffered, so tile i + 1 is in
// flight while tile i is scanned, and hs leaves shared memory the same way
// (in f32 32 KB of loads in flight a block and 64 KB of shared memory:
// the whole serving grid resident at once, three blocks an SM).  Measured
// in turns on an H100 against other shapes of this design, none was
// faster by more than the ~3 % two builds of one source differ by: three
// stages in f32, four or six in bf16, sub-chunks of 2 steps with four
// stages, 16 or 64 channels a block at the serving shape.  Rows are
// stored with a swizzle (16-byte unit q of row r at q ^ (r / kSteps)) so
// that the lanes' reads of one step, 32 rows apart, hit distinct banks.
// Steps past S scan as a = 1, bx = 0 (the state passes through), channels
// past W compute on zeros and store nothing.  Rows that are not whole
// 16-byte units (W not a multiple of kVec) or pointers not 16-byte aligned
// take plain loads and stores in place of the 16-byte copies.  Offsets are
// 64-bit.  The Pallas kernel needed W % BW == 0; any B, S and W work here.
//
// Numerics.  The products and sums are fused (fmaf), and the state
// entering a sub-chunk comes from the combine, not from the serial
// recurrence, so the result is not bit-identical to the plain version: it
// stays within atol 1e-5 (f32) / 5e-2 (bf16) and rtol 0.05, also with a
// close to 1 (tests/test_torch_lm_kernels.py emulates this order on the
// CPU).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 32;                 // sub-chunks of a tile
constexpr int kSteps = 4;                  // steps of a sub-chunk
constexpr int kTile = kLanes * kSteps;     // steps of a tile
constexpr int kStages = 2;                 // tile buffers
constexpr int kChannels = 32;              // channels a block

// kVec values of one 16-byte unit in shared memory, in f32
__device__ __forceinline__ void load_vec(const float* p, float (&v)[4]) {
  const float4 w = *reinterpret_cast<const float4*>(p);
  v[0] = w.x;
  v[1] = w.y;
  v[2] = w.z;
  v[3] = w.w;
}
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p,
                                         float (&v)[8]) {
  const uint4 w = *reinterpret_cast<const uint4*>(p);
  const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    v[2 * j] = __uint_as_float(u[j] << 16);
    v[2 * j + 1] = __uint_as_float(u[j] & 0xffff0000u);
  }
}
__device__ __forceinline__ void store_vec(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store_vec(__nv_bfloat16* p,
                                          const float (&v)[8]) {
  __nv_bfloat162 w[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) w[j] = __floats2bfloat162_rn(v[2 * j],
                                                           v[2 * j + 1]);
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

template <typename T>
struct Shape {
  static constexpr int kVec = 16 / sizeof(T);          // channels a warp
  static constexpr int kWarps = kChannels / kVec;       // 16-byte units a row
  static constexpr int kThreads = kLanes * kWarps;
  static constexpr int kElems = kTile * kChannels;      // a tile of a or bx
  static constexpr size_t kSmem = sizeof(T) * 2 * kStages * kElems;
  // element offset of 16-byte unit q of row r (the swizzle)
  static __device__ __forceinline__ int slot(int r, int q) {
    return r * kChannels + ((q ^ ((r / kSteps) & (kWarps - 1))) * kVec);
  }
};

// Rows [0, kTile) x channels [0, kChannels) of src (row pitch `width`)
// into the swizzled tile dst; entries at rows >= rows_ok or channels >=
// cols_ok are zeros.  vec: asynchronous 16-byte copies; otherwise plain
// loads and stores.
template <typename T>
__device__ __forceinline__ void stage(T* dst, const T* src, int64_t width,
                                      int rows_ok, int cols_ok, bool vec) {
  using S = Shape<T>;
  if (vec) {
#pragma unroll
    for (int i = threadIdx.x; i < kTile * S::kWarps; i += S::kThreads) {
      const int r = i / S::kWarps, q = i % S::kWarps;
      const bool ok = r < rows_ok && q * S::kVec < cols_ok;
      cp_async16(dst + S::slot(r, q), src + (ok ? r * width + q * S::kVec : 0),
                 ok ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < S::kElems; i += S::kThreads) {
      const int r = i / kChannels, c = i % kChannels;
      dst[S::slot(r, c / S::kVec) + c % S::kVec] =
          r < rows_ok && c < cols_ok ? src[r * width + c] : T(0.f);
    }
  }
}

// The swizzled tile src (hs of the tile) to rows [0, rows_ok) x channels
// [0, cols_ok) of dst.
template <typename T>
__device__ __forceinline__ void unstage(T* dst, const T* src, int64_t width,
                                        int rows_ok, int cols_ok, bool vec) {
  using S = Shape<T>;
  if (vec) {
#pragma unroll
    for (int i = threadIdx.x; i < kTile * S::kWarps; i += S::kThreads) {
      const int r = i / S::kWarps, q = i % S::kWarps;
      if (r < rows_ok && q * S::kVec < cols_ok)
        *reinterpret_cast<uint4*>(dst + r * width + q * S::kVec) =
            *reinterpret_cast<const uint4*>(src + S::slot(r, q));
    }
  } else {
    for (int i = threadIdx.x; i < S::kElems; i += S::kThreads) {
      const int r = i / kChannels, c = i % kChannels;
      if (r < rows_ok && c < cols_ok)
        dst[r * width + c] = src[S::slot(r, c / S::kVec) + c % S::kVec];
    }
  }
}

// Block: kChannels / kVec warps; warp g owns channels w0 + g kVec .. + kVec
// - 1, lane k steps k kSteps .. + kSteps - 1 of every tile.  Grid: (W /
// kChannels rounded up, B).
template <typename T>
__global__ void __launch_bounds__(Shape<T>::kThreads)
rglru_scan_kernel(const T* __restrict__ a, const T* __restrict__ bx,
                  T* __restrict__ hs, float* __restrict__ h_last, int seq,
                  int width, bool vec) {
  using S = Shape<T>;
  constexpr int kVec = S::kVec;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s_a = reinterpret_cast<T*>(smem_raw);          // [kStages][kTile][kCh]
  T* s_b = s_a + kStages * S::kElems;                // [kStages][kTile][kCh]

  const int lane = threadIdx.x % kLanes;
  const int g = threadIdx.x / kLanes;
  const int w0 = blockIdx.x * kChannels;
  const int cols_ok = min(kChannels, width - w0);
  const int64_t base = static_cast<int64_t>(blockIdx.y) * seq * width + w0;
  const T* ab = a + base;
  const T* bb = bx + base;
  T* hb = hs + base;
  // this lane's 16-byte unit of each of its rows (r / kSteps = lane)
  const int off = lane * kSteps * kChannels +
                  ((g ^ (lane & (S::kWarps - 1))) * kVec);

  auto stage_tile = [&](int t0, int buf) {
    const int64_t o = static_cast<int64_t>(t0) * width;
    stage<T>(s_a + buf * S::kElems, ab + o, width, seq - t0,
                        cols_ok, vec);
    stage<T>(s_b + buf * S::kElems, bb + o, width, seq - t0,
                        cols_ok, vec);
  };

  float carry[kVec];
#pragma unroll
  for (int j = 0; j < kVec; ++j) carry[j] = 0.f;

  // one commit group per tile (empty past S), so that waiting for all but
  // the kStages - 1 latest groups means: this tile has landed
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i * kTile < seq) stage_tile(i * kTile, i);
    cp_async_commit();
  }
  for (int t0 = 0, buf = 0; t0 < seq; t0 += kTile) {
    __syncthreads();         // the buffer refilled next was stored out
    const int ahead = t0 + (kStages - 1) * kTile;
    if (ahead < seq) stage_tile(ahead, (buf + kStages - 1) % kStages);
    cp_async_commit();
    cp_async_wait_stage();
    __syncthreads();

    T* ta = s_a + buf * S::kElems + off;
    T* tb = s_b + buf * S::kElems + off;
    float av[kSteps][kVec], bv[kSteps][kVec];
#pragma unroll
    for (int i = 0; i < kSteps; ++i) {
      load_vec(ta + i * kChannels, av[i]);
      load_vec(tb + i * kChannels, bv[i]);
    }
    if (t0 + kTile > seq) {  // the last tile: steps past S pass h through
#pragma unroll
      for (int i = 0; i < kSteps; ++i) {
        if (t0 + lane * kSteps + i >= seq) {
#pragma unroll
          for (int j = 0; j < kVec; ++j) {
            av[i][j] = 1.f;
            bv[i][j] = 0.f;
          }
        }
      }
    }

    // 1. the sub-chunk from zero: (prod a, h)
    float A[kVec], H[kVec];
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      A[j] = av[0][j];
      H[j] = bv[0][j];
    }
#pragma unroll
    for (int i = 1; i < kSteps; ++i) {
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        H[j] = fmaf(av[i][j], H[j], bv[i][j]);
        A[j] *= av[i][j];
      }
    }
    // 2. inclusive scan of the pairs over the lanes, then the state that
    // enters this lane's sub-chunk
#pragma unroll
    for (int d = 1; d < kLanes; d *= 2) {
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const float Ap = __shfl_up_sync(0xffffffffu, A[j], d);
        const float Hp = __shfl_up_sync(0xffffffffu, H[j], d);
        if (lane >= d) {
          H[j] = fmaf(A[j], Hp, H[j]);
          A[j] *= Ap;
        }
      }
    }
    float h[kVec];
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const float Ae = __shfl_up_sync(0xffffffffu, A[j], 1);
      const float He = __shfl_up_sync(0xffffffffu, H[j], 1);
      h[j] = lane == 0 ? carry[j] : fmaf(Ae, carry[j], He);
    }
    // 3. the sub-chunk again from that state; h replaces bx
#pragma unroll
    for (int i = 0; i < kSteps; ++i) {
#pragma unroll
      for (int j = 0; j < kVec; ++j) h[j] = fmaf(av[i][j], h[j], bv[i][j]);
      store_vec(tb + i * kChannels, h);
    }
#pragma unroll
    for (int j = 0; j < kVec; ++j)
      carry[j] = __shfl_sync(0xffffffffu, h[j], kLanes - 1);
    __syncthreads();         // the tile's hs is complete

    unstage<T>(hb + static_cast<int64_t>(t0) * width,
                          s_b + buf * S::kElems, width, seq - t0, cols_ok,
                          vec);
    buf = (buf + 1) % kStages;
  }

  if (lane == 0) {
    float* hl = h_last + static_cast<int64_t>(blockIdx.y) * width + w0;
#pragma unroll
    for (int j = 0; j < kVec; ++j)
      if (g * kVec + j < cols_ok) hl[g * kVec + j] = carry[j];
  }
}

template <typename T>
int launch_scan(const void* a, const void* bx, void* hs, void* h_last,
                int batch, int seq, int width, void* stream) {
  using S = Shape<T>;
  const bool vec = width % S::kVec == 0 &&
                   ((reinterpret_cast<uintptr_t>(a) |
                     reinterpret_cast<uintptr_t>(bx) |
                     reinterpret_cast<uintptr_t>(hs)) & 15) == 0;
  auto kernel = rglru_scan_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(S::kSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((width + kChannels - 1) / kChannels, batch);
  kernel<<<grid, S::kThreads, S::kSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(a), static_cast<const T*>(bx),
      static_cast<T*>(hs), static_cast<float*>(h_last), seq, width, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// a, bx, hs: (batch, seq, width) row-major in one type; h_last: (batch,
// width) f32.  Returns the first CUDA error of the launch, 0 if none.
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
