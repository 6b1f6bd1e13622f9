// K1 on Hopper: the 64 -> 64 layer of the bordered SAME-3x3 conv chain as a
// persistent, warp-specialised wgmma kernel (sm_90a).
//
// Replaces upscale_video_tpu/ops/conv_chain.py:61 (_chain_kernel) for the
// layers with cin == cout == 64: the 16 body layers of the default Compact
// chain, ESRGAN's 64 -> 64 chain layers and the conv-body benches' direct
// row.  Every other shape stays on conv3x3_chain.cu (WMMA); the wrapper
// picks by shape (ops/conv_chain.py:sm90_takes).  Same contract and
// arithmetic as conv3x3_chain.cu: bordered bf16 NHWC src (N, H+2, W+2, 64)
// -> interior of dst (same shape, zero ring never written), bf16 x bf16
// products summed in f32, + f32 bias, activation in f32, one rounding to
// bf16 (__float2bfloat16_rn, conv_chain.py:117-127).  The sum runs in
// another order than the WMMA kernel's, so values may differ by a bf16 ulp.
//
// Bound on the H100: operations.  A 64 -> 64 layer over 4x1080p is
// 2*9*64*64*4*1080*1920 = 611.5 GFLOP, 0.618 ms at 989 TFLOP/s; its
// bordered buffers (1.065 GB read, the same written) take 0.636 ms at
// 3.35 TB/s, so both floors sit near 0.62-0.64 ms.
//
// Design (one block per SM, 384 threads: a producer warpgroup and two
// consumer warpgroups):
// - Persistent blocks: the grid is the SM count; block b walks tiles b,
//   b + grid, ...  A tile is kR = 4 output rows x 64 output columns x all
//   64 output channels of one frame (4x1080p: 4 x 270 x 30 = 32,400
//   tiles).  The two consumer warpgroups take alternate tiles of the walk,
//   so one's epilogue overlaps the other's MMAs.
// - Resident weights: the layer's (9*64, 64) matrix is copied into shared
//   memory once per block (73,728 B), transposed to wgmma's K-major B
//   layout (per tap: 64 cout rows of 64 cin, 128 bytes each) with the
//   128-byte swizzle, and read through descriptors for every tile.
// - Halo ring by TMA: a 4-D tensor map over the bordered buffer (C = 64,
//   W+2, H+2, N) with CU_TENSOR_MAP_SWIZZLE_128B (one pixel's 64 channels
//   are exactly the 128-byte swizzle span).  A tile's box is 64 ch x 66 px
//   x 6 rows = 50,688 B; boxes past the buffer fill with zero.  kStages = 3
//   stages, each 1024-aligned (51,200 B), with full/empty mbarriers: one
//   producer thread keeps the next tile in flight while both consumers
//   compute.  The producer warpgroup gives up registers (setmaxnreg 40) so
//   the consumers can hold 232.
// - wgmma with A from registers: A (64 pixels of one halo row shifted by
//   dx, 16 channels) is loaded with ldmatrix.x4 from the swizzled halo
//   (warp w holds pixels 16w..16w+15, the m16n8k16 A layout wgmma takes
//   from registers); B is one tap's 16 x 64 slice; m64n64k16 into f32
//   accumulators, 32 per thread per output row, 128 for the tile's 4 rows.
// - A-fragment reuse: an m64n64k16 reads 2 KB of A and 2 KB of B for 131
//   kFLOP, 32 FLOP/byte, which is exactly the SM's shared-memory rate at
//   the tensor-core peak (~4096 FLOP/clk against 128 B/clk).  So each
//   (halo row, dx) group of 4 fragments is loaded once and issued against
//   every output row it feeds (dy = 0..2): a tile loads 6 halo rows per
//   dx, not 12, and only B (2 KB per wgmma) streams from shared memory per
//   MMA.  A is double-buffered: group i+1's ldmatrix runs while group i's
//   wgmmas do (wgmma.wait_group 1).
// - Epilogue in registers: bias and activation in f32 on the accumulators,
//   one rounding, staged (swizzled, conflict-free) into the tile's own halo
//   stage, then written with 16-byte stores masked to the interior: a
//   ragged tile never writes column w+1 or row h+1, so the ring stays zero.
//
// Shared memory: 1,024 (alignment slack) + 73,728 (weights) + 3 x 51,200
// (halo stages) + 48 (barriers) + 512 (bias, slope) = 228,912 of the
// 232,448 bytes a block may take.  A fourth stage or kR = 6 would not fit
// beside the weights.  kR = 4 keeps a consumer's accumulators (128) plus
// its two A buffers (32) within 232 registers.  ptxas (CUDA 12.9) reports
// 168 registers per thread at launch (384 threads, one block per SM), no
// spill and no wgmma serialisation; setmaxnreg then moves the producer to
// 40 and the consumers to 232.  The first version (two warpgroups sharing
// each tile's rows, 288 threads, wait_group 0 per halo row) spilled 120
// bytes at 168 registers and ran ~1.2x slower (PERF.md).

#include "sm90_common.cuh"

namespace uvt_sm90 {

using namespace uvt_sm90_common;

constexpr int kC = 64;                    // cin == cout
constexpr int kR = 4;                     // output rows per tile
constexpr int kTW = 64;                   // output columns per tile (wgmma M)
constexpr int kHaloRows = kR + 2;
constexpr int kHaloCols = kTW + 2;
constexpr int kLine = kC * 2;             // one pixel: the 128-byte swizzle span
constexpr int kRowBytes = kHaloCols * kLine;                   // 8,448
constexpr int kStageTx = kHaloRows * kRowBytes;                // 50,688
constexpr int kStageBytes = (kStageTx + 1023) / 1024 * 1024;   // 51,200
constexpr int kStages = 3;
constexpr int kTapBytes = kC * kLine;     // 8,192: one tap's (cout, cin) block
constexpr int kWBytes = 9 * kTapBytes;    // 73,728
constexpr int kWGs = 2;                   // consumer warpgroups
constexpr int kThreads = (kWGs + 1) * 128;  // + the producer warpgroup
// alignment slack, weights, halo ring, full/empty barriers, bias + slope
constexpr int kSmem =
    1024 + kWBytes + kStages * kStageBytes + 2 * kStages * 8 + 2 * kC * 4;
static_assert(kSmem <= 232448, "shared memory plan exceeds the block limit");
static_assert(kR * kTW * kLine <= kStageTx,
              "a tile's output must fit in its own halo stage");

template <int ACT>
__global__ void __launch_bounds__(kThreads, 1)
chain_layer_sm90_kernel(const __grid_constant__ CUtensorMap src_map,
                        __nv_bfloat16* __restrict__ dst,
                        const __nv_bfloat16* __restrict__ wmat,
                        const float* __restrict__ bias,
                        const float* __restrict__ slope, int h, int w,
                        int ntiles) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* sm = smem_raw + (base - raw);
  const uint32_t ring = base + kWBytes;
  const uint32_t bars = ring + kStages * kStageBytes;  // full[s], then empty[s]
  float* bs_s = reinterpret_cast<float*>(sm + (bars - base) + 2 * kStages * 8);
  const int hp = h + 2;
  const int wp = w + 2;
  const int ncol = (w + kTW - 1) / kTW;
  const int nband = (h + kR - 1) / kR;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (kStages + s), 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // resident weights: row (tap*64 + cin), column cout of wmat -> tap block
  // line cout, channel cin (K-major), 8 channels per 16-byte chunk
  for (int i = tid; i < 9 * kC * 8; i += kThreads) {
    const int n = i % kC;
    const int kc = (i / kC) % 8;
    const int tap = i / (kC * 8);
    const __nv_bfloat16* src = wmat + (size_t)(tap * kC + kc * 8) * kC + n;
    __align__(16) __nv_bfloat16 v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = src[e * kC];
    *reinterpret_cast<uint4*>(sm + tap * kTapBytes + swz(n, kc)) =
        *reinterpret_cast<const uint4*>(v);
  }
  if (tid < kC) {
    bs_s[tid] = bias[tid];
    bs_s[kC + tid] = (ACT == kActPrelu || ACT == kActLeaky) ? slope[tid] : 0.0f;
  }
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncthreads();

  const int wg = tid >> 7;
  if (wg == 0) {  // producer warpgroup: one thread keeps the TMA ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;" ::: "memory");
    if (tid == 0) {
      int k = 0;
      for (int t = blockIdx.x; t < ntiles; t += gridDim.x, ++k) {
        const int s = k % kStages;
        if (k >= kStages) mbar_wait(bars + 8 * (kStages + s), ((k / kStages) - 1) & 1);
        const int col = t % ncol;
        const int band = (t / ncol) % nband;
        const int f = t / (ncol * nband);
        const uint32_t full = bars + 8 * s;
        mbar_expect_tx(full, kStageTx);
        tma_load_4d(ring + s * kStageBytes, &src_map, full, 0, col * kTW,
                    band * kR, f);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;" ::: "memory");

  // consumer warpgroup c takes every other tile of the block's walk
  const int c = wg - 1;
  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int q = lane & 3;
  const int wt = tid & 127;
  const uint64_t wdesc = desc_sw128(base);

  for (int k = c, t = blockIdx.x + c * gridDim.x; t < ntiles;
       k += kWGs, t += kWGs * gridDim.x) {
    const int s = k % kStages;
    const uint32_t stage = ring + s * kStageBytes;
    float acc[kR][32];
#pragma unroll
    for (int r = 0; r < kR; ++r) {
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[r][i] = 0.0f;
      fence_acc(acc[r]);
    }
    // the stage's previous tile (the other warpgroup's) was consumed, so
    // the full barrier is in this tile's phase: a parity wait alone cannot
    // tell a phase from the one two back
    if (k >= kStages) mbar_wait(bars + 8 * (kStages + s), ((k / kStages) - 1) & 1);
    mbar_wait(bars + 8 * s, (k / kStages) & 1);

    // one group per (halo row hr, dx): 4 A fragments (16 channels each),
    // issued against every output row hr - dy they feed.  A is double
    // buffered: group i+1 loads while group i's wgmmas run (wait_group 1).
    uint32_t a[2][4][4];
#pragma unroll
    for (int hr = 0; hr < kHaloRows; ++hr) {
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        const int b = (hr * 3 + dx) & 1;
        const uint32_t line = (uint32_t)hr * kHaloCols + warp * 16 + (lane & 15) + dx;
#pragma unroll
        for (int kc = 0; kc < 4; ++kc) {
          ldsm_x4(stage + swz(line, 2 * kc + (lane >> 4)), a[b][kc]);
        }
        wg_fence();
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
          const int r = hr - dy;
          if (r < 0 || r >= kR) continue;
#pragma unroll
          for (int kc = 0; kc < 4; ++kc) {
            wgmma_rs<64>(acc[r], a[b][kc],
                     wdesc + (uint64_t)(((dy * 3 + dx) * kTapBytes + kc * 32) >> 4));
          }
        }
        wg_commit();
        wg_wait1();
      }
    }
    wg_wait0();
#pragma unroll
    for (int r = 0; r < kR; ++r) fence_acc(acc[r]);

    // epilogue: bias + activation in f32, one rounding, staged (swizzled)
    // into this tile's own stage, which no other warpgroup reads
    bar_sync(1 + c, 128);  // every warp of this warpgroup is done with the halo
    unsigned char* stage_p = sm + (stage - base);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 bj = *reinterpret_cast<const float2*>(bs_s + 8 * j + 2 * q);
      const float2 sj = *reinterpret_cast<const float2*>(bs_s + kC + 8 * j + 2 * q);
#pragma unroll
      for (int r = 0; r < kR; ++r) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const uint32_t line = (uint32_t)r * kTW + warp * 16 + g + 8 * half;
          const float v0 = activate<ACT>(acc[r][4 * j + 2 * half] + bj.x, sj.x);
          const float v1 = activate<ACT>(acc[r][4 * j + 2 * half + 1] + bj.y, sj.y);
          *reinterpret_cast<__nv_bfloat162*>(stage_p + swz(line, j) + 4 * q) =
              __floats2bfloat162_rn(v0, v1);
        }
      }
    }
    bar_sync(1 + c, 128);
    const int col = t % ncol;
    const int band = (t / ncol) % nband;
    const int f = t / (ncol * nband);
    const int y0 = band * kR;
    const int x0 = col * kTW;
#pragma unroll
    for (int i = wt; i < kR * kTW * 8; i += 128) {
      const int line = i >> 3;
      const int ch = i & 7;
      const int oy = y0 + line / kTW;
      const int ox = x0 + line % kTW;
      if (oy < h && ox < w) {
        const uint4 v = *reinterpret_cast<const uint4*>(stage_p + swz(line, ch));
        *reinterpret_cast<uint4*>(
            dst + (((size_t)f * hp + oy + 1) * wp + ox + 1) * kC + ch * 8) = v;
      }
    }
    // the stage may now be refilled by TMA (async proxy) after this
    // warpgroup's generic reads and writes
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    mbar_arrive(bars + 8 * (kStages + s));
  }
}

template <int ACT>
static int launch(const CUtensorMap& map, void* dst, const void* wmat,
                  const void* bias, const void* slope, int h, int w, int ntiles,
                  int grid, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      chain_layer_sm90_kernel<ACT>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return (int)err;
  chain_layer_sm90_kernel<ACT><<<grid, kThreads, kSmem, stream>>>(
      map, static_cast<__nv_bfloat16*>(dst), static_cast<const __nv_bfloat16*>(wmat),
      static_cast<const float*>(bias), static_cast<const float*>(slope), h, w, ntiles);
  return (int)cudaGetLastError();
}

}  // namespace uvt_sm90

extern "C" {

// One 64 -> 64 chain layer; the same arguments as uvt_conv3x3_chain_layer.
// src (N, h+2, w+2, 64) bf16, dst (N, h+2, w+2, 64) bf16 with a zero ring,
// wmat (9*64, 64) bf16 in (dy, dx, cin) row order, bias and slope (64,)
// f32.  Returns a cudaError_t code (cudaErrorInvalidValue for a shape it
// does not take or a tensor map cuTensorMapEncodeTiled refuses).
int uvt_conv3x3_chain_layer_sm90(const void* src, void* dst, const void* wmat,
                                 const void* bias, const void* slope, int n, int h,
                                 int w, int cin, int cout, int act, void* stream) {
  using namespace uvt_sm90;
  if (n < 1 || h < 1 || w < 1 || cin != kC || cout != kC || act < kActNone ||
      act > kActRelu) {
    return (int)cudaErrorInvalidValue;
  }
  const long long tiles =
      (long long)n * ((h + kR - 1) / kR) * ((w + kTW - 1) / kTW);
  if (tiles > 0x7fffffff) return (int)cudaErrorInvalidValue;
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap map;
  const cuuint64_t dims[4] = {(cuuint64_t)kC, (cuuint64_t)w + 2, (cuuint64_t)h + 2,
                              (cuuint64_t)n};
  const cuuint64_t strides[3] = {(cuuint64_t)kLine, (cuuint64_t)(w + 2) * kLine,
                                 (cuuint64_t)(h + 2) * (w + 2) * kLine};
  const cuuint32_t box[4] = {(cuuint32_t)kC, (cuuint32_t)kHaloCols,
                             (cuuint32_t)kHaloRows, 1};
  const cuuint32_t estride[4] = {1, 1, 1, 1};
  if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(src), dims,
             strides, box, estride, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS) {
    return (int)cudaErrorInvalidValue;
  }
  int dev = 0;
  int sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err != cudaSuccess) return (int)err;
  const int grid = (int)(tiles < sms ? tiles : sms);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (act) {
    case kActPrelu: return launch<kActPrelu>(map, dst, wmat, bias, slope, h, w, (int)tiles, grid, s);
    case kActLeaky: return launch<kActLeaky>(map, dst, wmat, bias, slope, h, w, (int)tiles, grid, s);
    case kActRelu: return launch<kActRelu>(map, dst, wmat, bias, slope, h, w, (int)tiles, grid, s);
    default: return launch<kActNone>(map, dst, wmat, bias, slope, h, w, (int)tiles, grid, s);
  }
}

}  // extern "C"
