// Backward of the RG-LRU gated linear recurrence (recurrentgemma-2b) for
// Hopper, sm_90a, float32, with a plain C interface loaded through ctypes.
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
// Design: the recurrence with time reversed is the forward's, so it scans
// in chunks as the forward does, here with the chunk state in registers
// and the combine in shared memory.  A block owns 32 channels of one b
// (threadIdx.x, consecutive in memory: each warp's loads are 128-byte
// rows) and cuts S into 32 chunks of ceil(S / 32) steps (threadIdx.y).
//   1. each thread walks its chunk backwards from zero, keeping the affine
//      map g_hi -> g_lo as (A = prod a, G);
//   2. one warp combines the 32 maps of each channel from the last chunk
//      down, starting from d h_last: the g entering each chunk;
//   3. each thread walks its chunk again from that g, writing d bx and d a.
// Step 1 reads a and d hs, step 3 reads a, d hs and hs: 1.4 times the
// bound's bytes.  Products and sums are fused (fmaf) and a chunk's entry
// state comes from the combine, so the result is not bit-identical to the
// serial plain version; it stays within the forward's tolerance (atol
// 1e-5, rtol 0.05).  Any B, S and W.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCh = 32;       // channels a block
constexpr int kChunks = 32;   // chunks of S

__global__ void __launch_bounds__(kCh * kChunks)
rglru_scan_bwd_kernel(const float* __restrict__ a,
                      const float* __restrict__ hs,
                      const float* __restrict__ dhs,
                      const float* __restrict__ dh_last,
                      float* __restrict__ da, float* __restrict__ dbx,
                      int seq, int width) {
  __shared__ float sA[kChunks][kCh + 1];
  __shared__ float sG[kChunks][kCh + 1];
  const int lane = threadIdx.x, chunk = threadIdx.y;
  const int w = blockIdx.x * kCh + lane;
  const bool ok = w < width;
  const int64_t base = static_cast<int64_t>(blockIdx.y) * seq * width + w;
  const int len = (seq + kChunks - 1) / kChunks;
  const int lo = min(seq, chunk * len), hi = min(seq, lo + len);
  const float* pa = a + base;
  const float* pd = dhs + base;

  // 1. g_lo = A g_hi + G over this chunk; a_S counts as 1
  float A = 1.f, G = 0.f;
  if (ok) {
    float an = hi < seq ? pa[static_cast<int64_t>(hi) * width] : 1.f;
#pragma unroll 4
    for (int t = hi - 1; t >= lo; --t) {
      const int64_t o = static_cast<int64_t>(t) * width;
      G = fmaf(an, G, pd[o]);
      A *= an;
      an = pa[o];
    }
  }
  sA[chunk][lane] = A;
  sG[chunk][lane] = G;
  __syncthreads();

  // 2. the g entering each chunk (at its hi), from d h_last down
  if (chunk == 0) {
    float g = ok ? dh_last[static_cast<int64_t>(blockIdx.y) * width + w]
                 : 0.f;
    for (int c = kChunks - 1; c >= 0; --c) {
      const float Ac = sA[c][lane], Gc = sG[c][lane];
      sA[c][lane] = g;
      g = fmaf(Ac, g, Gc);
    }
  }
  __syncthreads();

  // 3. the chunk again from its entering g
  if (ok) {
    const float* ph = hs + base;
    float g = sA[chunk][lane];
    float an = hi < seq ? pa[static_cast<int64_t>(hi) * width] : 1.f;
#pragma unroll 4
    for (int t = hi - 1; t >= lo; --t) {
      const int64_t o = static_cast<int64_t>(t) * width;
      g = fmaf(an, g, pd[o]);
      an = pa[o];
      const float hp = t > 0 ? ph[o - width] : 0.f;
      dbx[base + o] = g;
      da[base + o] = g * hp;
    }
  }
}

}  // namespace

extern "C" {

// a, hs, dhs, da, dbx: (batch, seq, width) f32 row-major; dh_last: (batch,
// width) f32.  Returns the CUDA error of the launch (0 on success).
int rglru_scan_bwd_f32(const void* a, const void* hs, const void* dhs,
                       const void* dh_last, void* da, void* dbx, int batch,
                       int seq, int width, void* stream) {
  if (batch > 65535) return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0 || seq == 0 || width == 0) return 0;
  const dim3 grid((width + kCh - 1) / kCh, batch);
  rglru_scan_bwd_kernel<<<grid, dim3(kCh, kChunks), 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(hs),
      static_cast<const float*>(dhs), static_cast<const float*>(dh_last),
      static_cast<float*>(da), static_cast<float*>(dbx), seq, width);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
