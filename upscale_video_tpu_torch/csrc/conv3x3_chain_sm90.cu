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

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace uvt_sm90 {

constexpr int kActNone = 0;
constexpr int kActPrelu = 1;
constexpr int kActLeaky = 2;
constexpr int kActRelu = 3;

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

// Byte offset of 16-byte chunk `chunk` of 128-byte line `line` under the
// 128-byte swizzle (TMA's CU_TENSOR_MAP_SWIZZLE_128B and wgmma's B128
// layout), relative to a 1024-aligned base.
__device__ __forceinline__ uint32_t swz(uint32_t line, uint32_t chunk) {
  return line * 128u + ((chunk ^ (line & 7u)) << 4);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

__device__ __forceinline__ bool mbar_try(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Wait for the phase of parity `parity` to complete.  A wait never lasts
// more than a tile's worth of work, so one that spins for ~10 s means a
// broken pipeline: trap (a launch error) rather than hang the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try(bar, parity)) {
    if (clock64() - t0 > 20000000000LL) __trap();
  }
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1, int c2,
                                            int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

__device__ __forceinline__ void wg_wait1() {
  asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
}

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma boundary (CUTLASS's warpgroup_fence_operand).
__device__ __forceinline__ void fence_acc(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// wgmma descriptor of a K-major, 128-byte-swizzled operand: start address,
// LBO 1 (unused by swizzled K-major), SBO 1024 bytes (8 rows of 128 B),
// layout B128.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// D(64x64, f32) += A(64x16, bf16, registers) * B(16x64, bf16, K-major smem).
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1)
      : "memory");
}

template <int ACT>
__device__ __forceinline__ float activate(float y, float s) {
  if (ACT == kActRelu) return fmaxf(y, 0.0f);
  if (ACT == kActPrelu || ACT == kActLeaky) return y >= 0.0f ? y : y * s;
  return y;
}

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
            wgmma_rs(acc[r], a[b][kc],
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

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled (libcuda) looked up through the runtime, so the
// library needs no -lcuda.
static EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p,
                                                     12000, cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &q);
#endif
    if (e != cudaSuccess || q != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
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
