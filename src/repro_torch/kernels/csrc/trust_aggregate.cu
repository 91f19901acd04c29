// Trust-weighted parameter aggregation (paper Eqns 6 and 19) for Hopper,
// sm_90a, with a plain C interface loaded through ctypes.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/trust_aggregate.py:
//   trust_aggregate_kernel         <- _kernel (:37) and _masked_kernel (:44),
//                                     reached through trust_aggregate (:67)
//   trust_aggregate_global_kernel  <- _global_kernel (:51), reached through
//                                     trust_aggregate_global (:99)
//
// What bounds them on an H100 (3.35 TB/s): bytes.  Every output column
// reads each input row once and does one multiply-add per element read, a
// quarter of a flop per byte (f32), far below the card's balance point.  At
// the federation's main-path shape (C = 99 members in the widest cluster,
// B = 16 clusters, N = 159,010 f32 values) the global kernel moves
// (99 + 15 + 1) * N * 4 B = 73.1 MB, a 21.83 us bound; at the anomaly
// task's (C = 111, B = 16, N = 5,288) 2.69 MB, 0.80 us, less than any
// launch takes.  The masked kernel moves (99 + 1) * N * 4 B = 63.6 MB,
// 18.99 us, and in bf16 half that, 9.49 us.
//
// The masked kernel.  One thread owns one output column, so each warp's
// load of a row is 128 contiguous bytes, and the rows are reduced by a loop
// inside the thread in f32: no cross-block reduction, no atomics,
// deterministic order.  Each block first compacts the rows whose mask is
// non-zero into shared memory (a warp ballot per 32 rows, in ascending row
// order, one chunk of rows at a time so C is unbounded), which keeps the
// reduction loop free of branches so the unrolled loads stay in flight
// together.  Masked-out rows are never read, so padded rows may hold
// anything (the engine's 1e30 sentinels) and contribute exactly zero,
// whatever weight the caller left on them.  Measured on an H100 (L2
// flushed between calls; PERF.md): ~27.7 us in f32 at the main-path shape,
// level with a contiguous stream of the same bytes by as many threads
// (~27.5 us) and faster than cuBLAS's (w * m) @ x (~28.6 us); in bf16
// ~19.1 us against ~42.4 us.  A design with 4 or 8 columns a thread and
// one 16-byte load a row was no faster in f32 and 6 % faster in bf16, for
// ~240 more lines; this one stays.
//
// The fused kernel.  The masked kernel's design, one column a thread
// walking all the rows, lost to cuBLAS's mv + addmv at N = 5,288: 21
// blocks for 132 SMs, each thread walking 126 rows in dependent groups of
// 8 loads, 16 trips to memory one after another (19 us cold against 15).
// Now:
// - One row table.  The result is one weighted sum over one list of rows:
//   the member rows r with mask[r] != 0, weight w[r] mask[r] gw[c], then
//   the stack rows b != c, weight gw[b] (c outside [0, B): no member row,
//   every stack row).  Each block builds it in shared memory (row pointer
//   and weight) from the device-resident c, w, mask and gw, loaded
//   together in one trip to memory, compacting with warp ballots in passes
//   of kChunk candidates, so C is unbounded.  Masked-out rows and stack
//   row c are never read.  The caller premultiplies nothing: one launch a
//   round, c read on the card, so a CUDA graph can capture it.
// - Rows split over a thread block cluster.  The grid is (column tile x
//   row split); the `split` blocks of one tile form a cluster
//   (cudaLaunchKernelEx, at most 8, the portable limit), and block k sums
//   the k-th contiguous share of each table pass in registers.  The blocks
//   then add their partial sums through distributed shared memory: block k
//   owns the k-th span of the tile's columns, every block sends its sums
//   of the others' spans with st.async, which counts the bytes on the
//   owner's mbarrier, and each owner adds the slots in rank order once its
//   bytes have arrived and writes its span.  No workspace, no atomics: the
//   result is bitwise the same from run to run.  (cluster.sync() in that
//   place compiles to a GPU-wide memory fence and a cluster barrier: the
//   exchange then cost ~0.9 us at both shapes, and st.async saves 0.5-0.9
//   of it.)
// - Loads.  Lane l of warp w owns the four columns 128 w + l + 32 e: every
//   warp load is 128 contiguous bytes whatever the row's alignment (N =
//   159,010 is 2 mod 4, so odd rows start 8 bytes off a 16-byte boundary;
//   the ragged test shapes have odd N).  Four consecutive columns a thread
//   with 16- or 8-byte loads was slower in one call of
//   scripts/fused_sweep.py: 38.6 us against 33.0 at N = 159,010, 11.9
//   against 10.6 at N = 5,288.  A thread keeps 8
//   rows' loads in flight (6 when bytes bound: 4 and 8 were 0.1-0.5 us
//   slower).
// - The plan comes from (C, B, N) and the SM count alone (plan_for), never
//   from the mask.  At N = 5,288: 21 tiles of 256 columns x a split of 8 =
//   168 blocks, ~16 rows each, two trips to memory.  At N = 159,010: 311
//   tiles of 512 x 2 = 622 blocks (a split of 1 or 4: 34-43 us; tiles
//   narrowed to a whole number of blocks an SM: no faster).
// - Numerics: gw[c] is folded into the member weights, so the sum is taken
//   in another order than the plain version's (within 1e-5 of it).
//
// Measured on "NVIDIA H100 80GB HBM3, 700.00 W" (chip_smoke.py
// --compare-with, two calls; PERF.md section 6): at N = 5,288 9.35-9.56 us
// cold (L2 flushed) and 4.70-4.86 warm (from a CUDA graph), against mv +
// addmv's 15.16-15.27 and 7.08-7.22 and the old kernel's 19.07-19.24 and
// 8.53-8.58; at N = 159,010 31.01-31.30 cold against the old kernel's
// 31.34-31.58 and mv + addmv's 40.29-40.71.  An empty launch takes ~5.3 us
// cold there, so the streaming part runs at ~2.8 TB/s, as PyTorch's
// contiguous sum of 63.6 MB does.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

namespace {

constexpr int kThreads = 256;          // one output column per thread
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// Sum over rows r of w[r] * mask[r] * x[r, col], rows with mask[r] == 0
// skipped (mask == nullptr: every row counts).  Every thread of the block
// must call it, also those past the last column (they join the ballots).
template <typename T>
__device__ float masked_column_sum(const T* __restrict__ x,
                                   const float* __restrict__ w,
                                   const float* __restrict__ mask, int rows,
                                   int64_t n, int64_t col) {
  __shared__ int s_row[kThreads];
  __shared__ float s_w[kThreads];
  __shared__ int s_warp_count[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const bool in_range = col < n;
  float acc = 0.f;
  for (int base = 0; base < rows; base += kThreads) {
    const int r = base + threadIdx.x;
    float wr = 0.f;
    bool valid = false;
    if (r < rows) {
      const float m = mask == nullptr ? 1.f : __ldg(mask + r);
      valid = m != 0.f;
      wr = __ldg(w + r) * m;
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, valid);
    if (lane == 0) s_warp_count[warp] = __popc(ballot);
    __syncthreads();
    int offset = 0, count = 0;
    for (int i = 0; i < kWarps; ++i) {
      const int k = s_warp_count[i];
      offset += i < warp ? k : 0;
      count += k;
    }
    if (valid) {
      const int pos = offset + __popc(ballot & ((1u << lane) - 1u));
      s_row[pos] = r;
      s_w[pos] = wr;
    }
    __syncthreads();
    if (in_range) {
      const T* p = x + col;
#pragma unroll 8
      for (int k = 0; k < count; ++k)
        acc = fmaf(s_w[k], to_f32(p[static_cast<int64_t>(s_row[k]) * n]),
                   acc);
    }
    __syncthreads();                   // the next chunk reuses s_row / s_w
  }
  return acc;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
trust_aggregate_kernel(const T* __restrict__ x, const float* __restrict__ w,
                       const float* __restrict__ mask, T* __restrict__ out,
                       int rows, int64_t n) {
  const int64_t col = static_cast<int64_t>(blockIdx.x) * kThreads +
                      threadIdx.x;
  const float acc = masked_column_sum(x, w, mask, rows, n, col);
  if (col < n) store(out + col, acc);
}

inline unsigned blocks_for(int64_t n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

template <typename T>
int launch_aggregate(const void* x, const void* w, const void* mask,
                     void* out, int rows, long long n, void* stream) {
  trust_aggregate_kernel<T><<<blocks_for(n), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const float*>(w),
      static_cast<const float*>(mask), static_cast<T*>(out), rows, n);
  return static_cast<int>(cudaGetLastError());
}


// ---------------------------------------------------------------------------
// The fused kernel (Eqn 6 into row c of the stack, then Eqn 19): one
// weighted sum over a table of rows, split over the blocks of a cluster.

namespace cg = cooperative_groups;

constexpr int kChunk = 256;            // candidate rows one table pass sees
constexpr int kWide = 4;               // columns a thread, 32 apart
constexpr int kMaxSplit = 8;           // blocks a cluster: the portable limit
constexpr int kMinRowsPerBlock = 8;    // the row split stops at this share
constexpr int kMaxDevices = 64;

// Rows whose loads a thread has in flight at once: 8 in the 64-thread
// blocks that few tiles need (bound by latency), 6 in the 128-thread
// blocks of many tiles (bound by bytes: 4 and 8 were slower).
__host__ __device__ constexpr int rows_in_flight(int threads) {
  return threads == 64 ? 8 : 6;
}

// acc[e] += s_wt[k] * s_row[k][col + 32 e] for e < len, over the table
// entries k in [lo, hi) in order; kRows rows' loads are issued before any
// is used.
template <int kRows>
__device__ __forceinline__ void sum_rows(const float* const* s_row,
                                         const float* s_wt, int lo, int hi,
                                         int64_t col, int len,
                                         float (&acc)[kWide]) {
  for (int k0 = lo; k0 < hi; k0 += kRows) {
    float v[kRows][kWide];
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      if (k0 + u < hi) {
        const float* __restrict__ p = s_row[k0 + u] + col;
#pragma unroll
        for (int e = 0; e < kWide; ++e)
          v[u][e] = e < len ? __ldg(p + 32 * e) : 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      if (k0 + u < hi) {
        const float wk = s_wt[k0 + u];
#pragma unroll
        for (int e = 0; e < kWide; ++e) acc[e] = fmaf(wk, v[u][e], acc[e]);
      }
    }
  }
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// The address of the same shared variable in block `rank` of the cluster.
__device__ __forceinline__ unsigned peer_addr(unsigned addr, int rank) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

// Block (tile, rank) of a cluster of `split` blocks.  Lane l of warp w owns
// the columns 32 (kWide w + e) + l (e < kWide) of the tile, so each warp
// load is 128 contiguous bytes at any row alignment, and sums rank's share
// of every table pass, kRows rows at a time.  The ranks deal out the
// tile's columns in spans of kCols / split: each block sends its partial
// sum of column j to slot `rank` of the block that owns j with st.async,
// which counts the bytes on the owner's mbarrier, and the owners add the
// slots in rank order once theirs have all arrived.  No cluster-wide
// barrier or memory fence follows the rows.
template <int kBlock>
__global__ void __launch_bounds__(kBlock)
trust_aggregate_global_kernel(const float* __restrict__ x,
                              const float* __restrict__ w,
                              const float* __restrict__ mask,
                              const float* __restrict__ stack,
                              const float* __restrict__ gw,
                              const int32_t* __restrict__ c_ptr,
                              float* __restrict__ out, int rows,
                              int clusters, int64_t n, int split) {
  constexpr int kPer = kChunk / kBlock;      // candidates a thread a pass
  constexpr int kWarpsB = kBlock / 32;
  constexpr int kCols = kWide * kBlock;      // columns a tile
  constexpr int kRows = rows_in_flight(kBlock);
  __shared__ const float* s_row[kChunk];     // the table: rows ...
  __shared__ float s_wt[kChunk];             // ... and their weights
  __shared__ unsigned s_bits[kChunk / 32];   // valid flags, 32 a word
  __shared__ float s_gw[kChunk];             // gw[0 .. kChunk)
  __shared__ float s_recv[kCols];            // the cluster's partial sums
  __shared__ unsigned long long s_bar;       // counts their bytes
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int rank =
      split > 1 ? static_cast<int>(cg::this_cluster().block_rank()) : 0;
  const int64_t first = static_cast<int64_t>(blockIdx.x / split) * kCols;
  const int own = warp * 32 * kWide + lane;  // the tile's column of e = 0
  const int64_t col = first + own;
  const int64_t left = (n - col + 31) / 32;  // own columns inside N
  const int len =
      col >= n ? 0 : left >= kWide ? kWide : static_cast<int>(left);
  // c, the first pass's weights and gw[0 .. kChunk) are loaded together,
  // so the table waits for one trip to memory, not for c and then gw[c]
  // (0.3-0.4 us at N = 5,288)
  const int c = __ldg(c_ptr);
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int b = j * kBlock + t;
    if (b < clusters) s_gw[b] = __ldg(gw + b);
  }
  const bool hit = c >= 0 && c < clusters;
  const int total = rows + clusters;
  float acc[kWide] = {};
  const unsigned bar = smem_addr(&s_bar);
  if (split > 1) {               // every mbarrier is ready before any push
    if (t == 0) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" :: "r"(bar));
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
  }
  for (int base = 0; base < total; base += kChunk) {
    // candidate i: member row i (weight w m gw[c], only with a hit and
    // m != 0), then stack row i - rows (weight gw[b], b != c)
    float m[kPer], wr[kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int i = base + j * kBlock + t;
      m[j] = 0.f;
      wr[j] = 0.f;
      if (i < rows) {
        m[j] = __ldg(mask + i);
        wr[j] = __ldg(w + i);
      } else if (i < total) {
        wr[j] = __ldg(gw + (i - rows));
      }
    }
    bool valid[kPer];
    unsigned ballot[kPer];
    int before[kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int i = base + j * kBlock + t;
      valid[j] = i < rows ? hit && m[j] != 0.f : i < total && i - rows != c;
      ballot[j] = __ballot_sync(0xffffffffu, valid[j]);
      if (lane == 0) s_bits[j * kWarpsB + warp] = ballot[j];
      before[j] = 0;
    }
    __syncthreads();
    const float gwc = !hit ? 0.f : c < kChunk ? s_gw[c] : __ldg(gw + c);
    int count = 0;
#pragma unroll
    for (int g = 0; g < kChunk / 32; ++g) {
#pragma unroll
      for (int j = 0; j < kPer; ++j)
        if (g == j * kWarpsB + warp) before[j] = count;
      count += __popc(s_bits[g]);
    }
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      if (valid[j]) {
        const int pos = before[j] + __popc(ballot[j] & ((1u << lane) - 1u));
        const int i = base + j * kBlock + t;
        s_row[pos] = i < rows ? x + static_cast<int64_t>(i) * n
                              : stack + static_cast<int64_t>(i - rows) * n;
        s_wt[pos] = i < rows ? wr[j] * m[j] * gwc : wr[j];
      }
    }
    __syncthreads();
    sum_rows<kRows>(s_row, s_wt, count * rank / split,
                    count * (rank + 1) / split, col, len, acc);
    if (base + kChunk < total) __syncthreads();  // the next pass rewrites
  }
  if (split == 1) {
#pragma unroll
    for (int e = 0; e < kWide; ++e)
      if (e < len) out[col + 32 * e] = acc[e];
    return;
  }
  const int span = kCols / split;
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
  if (t == 0)                    // the peers' bytes this block waits for
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 :: "r"(bar), "r"((split - 1) * span * 4) : "memory");
#pragma unroll
  for (int e = 0; e < kWide; ++e) {
    const int j = own + 32 * e;
    const int owner = j / span;
    const int slot = rank * span + j % span;
    if (owner == rank) {
      s_recv[slot] = acc[e];
    } else {
      asm volatile(
          "st.async.shared::cluster.mbarrier::complete_tx::bytes.f32 "
          "[%0], %1, [%2];"
          :: "r"(peer_addr(smem_addr(s_recv + slot), owner)), "f"(acc[e]),
             "r"(peer_addr(bar, owner)) : "memory");
    }
  }
  __syncthreads();               // this block's own slot is written
  for (unsigned polls = 0;; ++polls) {
    unsigned done;
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], 0;"
        "\n\tselp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done) : "r"(bar) : "memory");
    if (done) break;
    if (polls == 1u << 20) __trap();   // a lost push: fail, do not hang
  }
  for (int i = t; i < span; i += kBlock) {
    float sum = s_recv[i];
    for (int r = 1; r < split; ++r) sum += s_recv[r * span + i];
    const int64_t j = first + rank * span + i;
    if (j < n) out[j] = sum;
  }
}

struct Plan {
  int threads;       // a block: 64 or 128, kWide columns a thread
  int split;         // blocks a cluster, each summing 1 / split of the rows
  long long tiles;   // column tiles of kWide * threads columns
};

// The plan from host integers alone (never the mask): blocks of 64 threads
// until 128-thread tiles fill the SMs; then the row split.  Few tiles: the
// call is bound by latency, so the rows are split until the blocks cover
// the SMs (at most 8, and >= kMinRowsPerBlock rows a block).  Many: it is
// bound by bytes, so the least split whose blocks lie within 10 % of even
// over the SMs, else the most even.
Plan plan_for(int rows, int clusters, long long n, int sms) {
  Plan p;
  const long long owners = (n + kWide - 1) / kWide;   // threads N needs
  p.threads = (owners + 127) / 128 >= sms ? 128 : 64;
  p.tiles = (owners + p.threads - 1) / p.threads;
  const int table = rows + clusters - 1;     // the most rows a call reads
  int most = 1;
  while (most < kMaxSplit && 2 * most * kMinRowsPerBlock <= table) most *= 2;
  p.split = 1;
  if (p.tiles * most <= 2LL * sms) {
    while (p.split < most && p.tiles * p.split < sms) p.split *= 2;
    return p;
  }
  double best = 1e30;
  for (int s = 1; s <= most; s *= 2) {
    const double waves = static_cast<double>(p.tiles * s) / sms;
    const double uneven = std::ceil(waves) / waves;
    if (uneven < best) {
      best = uneven;
      p.split = s;
    }
    if (uneven <= 1.1) break;
  }
  return p;
}

cudaError_t sm_count(int* sms) {
  static int cached[kMaxDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < kMaxDevices && cached[dev] > 0) {
    *sms = cached[dev];
    return cudaSuccess;
  }
  e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess && dev < kMaxDevices) cached[dev] = *sms;
  return e;
}

using GlobalKernel = void (*)(const float*, const float*, const float*,
                              const float*, const float*, const int32_t*,
                              float*, int, int, int64_t, int);

GlobalKernel kernel_for(const Plan& p) {
  return p.threads == 64 ? trust_aggregate_global_kernel<64>
                         : trust_aggregate_global_kernel<128>;
}

// The launch configuration of a plan; attr receives the cluster dimension.
cudaLaunchConfig_t config_for(const Plan& p, cudaLaunchAttribute* attr,
                              cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(p.tiles * p.split));
  cfg.blockDim = dim3(p.threads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = p.split;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = p.split > 1 ? 1 : 0;
  return cfg;
}

}  // namespace

extern "C" {

// x: (rows, n) row-major; w, mask: (rows,) f32 (mask may be NULL);
// out: (n,).  Returns cudaGetLastError() after the launch.
int ta_aggregate_f32(const void* x, const void* w, const void* mask,
                     void* out, int rows, long long n, void* stream) {
  return launch_aggregate<float>(x, w, mask, out, rows, n, stream);
}

int ta_aggregate_bf16(const void* x, const void* w, const void* mask,
                      void* out, int rows, long long n, void* stream) {
  return launch_aggregate<__nv_bfloat16>(x, w, mask, out, rows, n, stream);
}

// x: (rows, n) member updates; w, mask: (rows,); stack: (clusters, n);
// gw: (clusters,); c: one int32 in device memory; out: (n,).  All f32.
// Returns the launch's CUDA error (0 on success).
int ta_aggregate_global_f32(const void* x, const void* w, const void* mask,
                            const void* stack, const void* gw, const void* c,
                            void* out, int rows, int clusters, long long n,
                            void* stream) {
  int sms = 0;
  cudaError_t e = sm_count(&sms);
  if (e != cudaSuccess) return static_cast<int>(e);
  const Plan p = plan_for(rows, clusters, n, sms);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      config_for(p, &attr, static_cast<cudaStream_t>(stream));
  e = cudaLaunchKernelEx(
      &cfg, kernel_for(p), static_cast<const float*>(x),
      static_cast<const float*>(w), static_cast<const float*>(mask),
      static_cast<const float*>(stack), static_cast<const float*>(gw),
      static_cast<const int32_t*>(c), static_cast<float*>(out), rows,
      clusters, static_cast<int64_t>(n), p.split);
  if (e != cudaSuccess) {
    cudaGetLastError();                // clear it for the next launch
    return static_cast<int>(e);
  }
  return static_cast<int>(cudaGetLastError());
}

// The plan of ta_aggregate_global_f32: plan[0..6] = threads a block,
// blocks a cluster (1: no cluster launch), columns a tile, column tiles,
// blocks in the grid, rows a thread loads at once, and the clusters the
// card holds at once (cudaOccupancyMaxActiveClusters; 0 without a
// cluster).  Returns the CUDA error of the queries.
int ta_global_plan(int rows, int clusters, long long n, int* plan) {
  int sms = 0;
  cudaError_t e = sm_count(&sms);
  if (e != cudaSuccess) return static_cast<int>(e);
  const Plan p = plan_for(rows, clusters, n, sms);
  plan[0] = p.threads;
  plan[1] = p.split;
  plan[2] = kWide * p.threads;
  plan[3] = static_cast<int>(p.tiles);
  plan[4] = static_cast<int>(p.tiles * p.split);
  plan[5] = rows_in_flight(p.threads);
  plan[6] = 0;
  if (p.split > 1) {
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = config_for(p, &attr, nullptr);
    e = cudaOccupancyMaxActiveClusters(
        &plan[6], reinterpret_cast<const void*>(kernel_for(p)), &cfg);
  }
  return static_cast<int>(e);
}

}  // extern "C"
