// K8 on Hopper: the 64 -> 64 layer of the int8 bordered SAME-3x3 conv
// chain as a persistent, warp-specialised wgmma kernel (sm_90a).
//
// Replaces upscale_video_tpu/ops/conv_chain_q8.py:68 (_q8_chain_kernel)
// for the layers with cin == cout == 64: every layer of the conv-body
// bench's int8 body (tools/q8_bench.py).  Every other shape stays on
// conv_chain_q8.cu (mma.sync); the wrapper picks by shape
// (ops/conv_chain_q8.py:sm90_takes).  Same contract and arithmetic as
// conv_chain_q8.cu: bordered int8 NHWC src (N, H+2, W+2, 64) -> interior
// of dst (same shape, int8 to requantise or bf16 for the last layer, zero
// ring never written); int8 x int8 products summed exactly in int32
// (|sum| <= 9 * 64 * 128^2 < 2^31, so the order does not matter), then
//     y = __fadd_rn(__fmul_rn(__int2float_rn(acc), scale[k]), bias[k]),
// the activation, and either clamp(rintf(__fmul_rn(y, inv_out)), +-127)
// or __float2bfloat16_rn(y).  The kernel equals its plain version
// (conv3x3_chain_q8_plain) bit for bit.
//
// Bound on the H100: a 64 -> 64 layer over 4x1080p is 2*9*64*64*4*1080*1920
// = 611.5 G int8 operations, 0.309 ms at 1,979 TOP/s; its bordered int8
// buffers (532.4 MB read, the same written) take 0.318 ms at 3.35 TB/s, so
// both floors sit near 0.31-0.32 ms (0.477 ms of bytes for the bf16-out
// layer).
//
// Design: K1's sm90 kernel (conv3x3_chain_sm90.cu) in int8 (one block per
// SM, 512 threads: a producer warpgroup and three consumer warpgroups):
// - Persistent blocks: the grid is the SM count; block b walks tiles b,
//   b + grid, ...  A tile is kR = 3 output rows x 64 output columns x all
//   64 output channels of one frame; the consumer warpgroups take turns
//   along the walk, so two run MMAs while the third runs its epilogue.
// - The 64-byte pixel: one pixel's 64 int8 channels are 64 bytes, so the
//   halo and the weights use the 64-byte swizzle (TMA's
//   CU_TENSOR_MAP_SWIZZLE_64B, wgmma's B64 layout: 16-byte chunk c of
//   64-byte line l sits at chunk c ^ ((l >> 1) & 3)).  Any 8 consecutive
//   lines then cover the 32 banks once, so ldmatrix of 8 pixels at one
//   chunk is conflict-free whatever the dx shift.
// - Resident weights: the layer's packed image (ops/conv_chain_q8.py:
//   pack_q8_weights_sm90, made once per layer: per tap 64 cout lines of 64
//   cin bytes, K-major, swizzled) is copied into shared memory once per
//   block (36,864 B) and read through B64 descriptors.
// - Halo ring by TMA: a 4-D tensor map over the bordered buffer (C = 64,
//   W+2, H+2, N); a tile's box is 64 ch x 66 px x 5 rows = 21,120 B
//   (boxes past the buffer fill with zero); kStages = 8 stages with
//   full/empty mbarriers.  The producer warpgroup gives up registers
//   (setmaxnreg 24) so the consumers can hold 160.
// - wgmma m64n64k32 s8 x s8 -> s32 with A from registers: an m64k32 s8
//   fragment is the m64k16 b16 fragment of the same bytes, so A (64 pixels
//   of one halo row shifted by dx, 32 channels) is one ldmatrix.x4; B is
//   one tap's 32 x 64 slice.  One tap is two k32 steps.  Each (halo row,
//   dx) group of 2 fragments is loaded once and issued against every
//   output row it feeds (dy = 0..2); A is double-buffered (wait_group 1).
//   Per tile: 54 wgmmas (1,728 tensor clocks at 4,096 int8 MACs a clock)
//   read 108 KB of B and 60 KB of A from shared memory.
// - Why three consumers of 3 rows: one warpgroup's chain of small wgmmas
//   keeps the tensor cores well under their rate, and the int8 epilogue
//   (~10 instructions a value) does not hide behind one other
//   warpgroup's MMAs.  Two consumers of 4 rows (K1's plan) were slower;
//   6 rows run out of registers (ptxas serialises the wgmmas); 2-row
//   tiles reread more halo and gained nothing with three or four
//   consumers; 3 or 4 A buffers, 4-8 stages and another wgmma order moved
//   nothing (PERF.md, §6).
// - Epilogue in registers: each thread's accumulators cover 16 channels
//   (8j + 2q, +1), so their scale, bias and slope come from shared memory
//   as float2s; values are staged (swizzled, conflict-free) into the tile's
//   own halo stage, int8 as 64-byte lines in one pass, bf16 as 128-byte
//   lines in passes of 2 rows, then written with 16-byte stores masked to
//   the interior: a ragged tile never writes column w+1 or row h+1, so the
//   ring stays zero.
//
// Shared memory: 1,024 (alignment slack) + 36,864 (weights) + 8 x 21,504
// (halo stages) + 128 (barriers) + 768 (scale, bias, slope) = 210,816 of
// the 232,448 bytes a block may take.

#include "sm90_common.cuh"

namespace uvt_q8_sm90 {

using namespace uvt_sm90_common;

constexpr int kC = 64;                    // cin == cout
constexpr int kR = 3;                     // output rows per tile
constexpr int kTW = 64;                   // output columns per tile (wgmma M)
constexpr int kHaloRows = kR + 2;
constexpr int kHaloCols = kTW + 2;
constexpr int kLine = kC;                 // one int8 pixel: the 64-byte swizzle span
constexpr int kStageTx = kHaloRows * kHaloCols * kLine;        // 21,120
constexpr int kStageBytes = (kStageTx + 1023) / 1024 * 1024;   // 21,504
constexpr int kStages = 8;
constexpr int kTapBytes = kC * kLine;     // 4,096: one tap's (cout, cin) block
constexpr int kWBytes = 9 * kTapBytes;    // 36,864
constexpr int kWGs = 3;                   // consumer warpgroups
constexpr int kThreads = (kWGs + 1) * 128;  // + the producer warpgroup
constexpr int kProducerRegs = 24;         // setmaxnreg of each warpgroup
constexpr int kConsumerRegs = 160;
static_assert(128 * (kProducerRegs + kWGs * kConsumerRegs) <= 65536,
              "register plan exceeds the SM's register file");
// alignment slack, weights, halo ring, full/empty barriers, scale + bias +
// slope
constexpr int kSmem =
    1024 + kWBytes + kStages * kStageBytes + 2 * kStages * 8 + 3 * kC * 4;
static_assert(kSmem <= 232448, "shared memory plan exceeds the block limit");
// the epilogue stages a pass of output rows in the tile's own halo stage:
// all kR rows of int8, as many 128-byte bf16 lines as fit
static_assert(kR * kTW * kC <= kStageTx && kTW * kC * 2 <= kStageTx,
              "an epilogue pass must fit in its tile's own halo stage");

// Byte offset of 16-byte chunk `chunk` of 64-byte line `line` under the
// 64-byte swizzle (TMA's CU_TENSOR_MAP_SWIZZLE_64B and wgmma's B64 layout),
// relative to a 512-aligned base.
__device__ __forceinline__ uint32_t swz64(uint32_t line, uint32_t chunk) {
  return line * 64u + ((chunk ^ ((line >> 1) & 3u)) << 4);
}

// wgmma descriptor of a K-major, 64-byte-swizzled operand: start address,
// LBO 1 (unused by swizzled K-major), SBO 512 bytes (8 rows of 64 B),
// layout B64.
__device__ __forceinline__ uint64_t desc_sw64(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(512 >> 4) << 32) | ((uint64_t)2 << 62);
}

template <int M>
__device__ __forceinline__ void fence_acc_s32(int (&d)[M]) {
#pragma unroll
  for (int i = 0; i < M; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// D(64x64, s32) += A(64x32, s8, registers) * B(32x64, s8, K-major smem).
__device__ __forceinline__ void wgmma_s8(int (&d)[32], const uint32_t (&a)[4],
                                         uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, "
      "{%32, %33, %34, %35}, %36, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]),
        "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]),
        "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]),
        "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]),
        "+r"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1)
      : "memory");
}

// The f32 epilogue of one int32 sum, op for op as conv_chain_q8.cu's (and
// the plain version's): dequant multiply, bias add, activation.
template <int ACT>
__device__ __forceinline__ float dequant(int acc, float sc, float b, float s) {
  float y = __fadd_rn(__fmul_rn(__int2float_rn(acc), sc), b);
  if (ACT == kActRelu) {
    y = fmaxf(y, 0.0f);
  } else if (ACT == kActPrelu || ACT == kActLeaky) {
    y = y >= 0.0f ? y : __fmul_rn(y, s);
  }
  return y;
}

// Two values' clamp(rintf(y * inv_out), -127, 127) as int8, packed into
// the low 16 bits (y0 first).  The float max with -127 takes the lower
// clamp (a value in [-127.5, -127) rounds to -127 either way); cvt.rni
// rounds half to even as rintf does, and cvt.pack.sat saturates the
// upper end at 127.
__device__ __forceinline__ uint32_t requant2(float y0, float y1, float inv_out) {
  const int q0 = __float2int_rn(fmaxf(__fmul_rn(y0, inv_out), -127.0f));
  const int q1 = __float2int_rn(fmaxf(__fmul_rn(y1, inv_out), -127.0f));
  uint32_t d;
  asm("cvt.pack.sat.s8.s32.b32 %0, %1, %2, %3;" : "=r"(d) : "r"(q1), "r"(q0), "r"(0));
  return d;
}

template <int ACT, bool TO_INT8>
__global__ void __launch_bounds__(kThreads, 1)
q8_layer_sm90_kernel(const __grid_constant__ CUtensorMap src_map,
                     unsigned char* __restrict__ dst,
                     const uint4* __restrict__ wpack,
                     const float* __restrict__ scale,
                     const float* __restrict__ bias,
                     const float* __restrict__ slope, float inv_out, int h,
                     int w, int ntiles) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* sm = smem_raw + (base - raw);
  const uint32_t ring = base + kWBytes;
  const uint32_t bars = ring + kStages * kStageBytes;  // full[s], then empty[s]
  float* ps = reinterpret_cast<float*>(sm + (bars - base) + 2 * kStages * 8);
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
  // resident weights: the packed image is already in its shared-memory
  // (swizzled, K-major) order
  for (int i = tid; i < kWBytes / 16; i += kThreads) {
    reinterpret_cast<uint4*>(sm)[i] = wpack[i];
  }
  if (tid < kC) {
    ps[tid] = scale[tid];
    ps[kC + tid] = bias[tid];
    ps[2 * kC + tid] = ACT == kActPrelu ? slope[tid]
                       : ACT == kActLeaky ? slope[0] : 0.0f;
  }
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncthreads();

  const int wg = tid >> 7;
  if (wg == 0) {  // producer warpgroup: one thread keeps the TMA ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs) : "memory");
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
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs) : "memory");

  // consumer warpgroup c takes every kWGs-th tile of the block's walk
  const int c = wg - 1;
  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int q = lane & 3;
  const int wt = tid & 127;
  const uint64_t wdesc = desc_sw64(base);

  for (int k = c, t = blockIdx.x + c * gridDim.x; t < ntiles;
       k += kWGs, t += kWGs * gridDim.x) {
    const int s = k % kStages;
    const uint32_t stage = ring + s * kStageBytes;
    int acc[kR][32];
#pragma unroll
    for (int r = 0; r < kR; ++r) {
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[r][i] = 0;
      fence_acc_s32(acc[r]);
    }
    // the stage's previous tile was consumed, so the full barrier is in
    // this tile's phase: a parity wait alone cannot tell a phase from the
    // one two back
    if (k >= kStages) mbar_wait(bars + 8 * (kStages + s), ((k / kStages) - 1) & 1);
    mbar_wait(bars + 8 * s, (k / kStages) & 1);

    // one group per (halo row hr, dx): 2 A fragments (32 channels each),
    // issued against every output row hr - dy they feed.  A is double
    // buffered: group i+1 loads while group i's wgmmas run (wait_group 1).
    uint32_t a[2][2][4];
#pragma unroll
    for (int hr = 0; hr < kHaloRows; ++hr) {
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        const int b = (hr * 3 + dx) & 1;
        const uint32_t line = (uint32_t)hr * kHaloCols + warp * 16 + (lane & 15) + dx;
#pragma unroll
        for (int ks = 0; ks < 2; ++ks) {
          ldsm_x4(stage + swz64(line, 2 * ks + (lane >> 4)), a[b][ks]);
        }
        wg_fence();
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
          const int r = hr - dy;
          if (r < 0 || r >= kR) continue;
#pragma unroll
          for (int ks = 0; ks < 2; ++ks) {
            wgmma_s8(acc[r], a[b][ks],
                     wdesc + (uint64_t)(((dy * 3 + dx) * kTapBytes + ks * 32) >> 4));
          }
        }
        wg_commit();
        wg_wait1();
      }
    }
    wg_wait0();
#pragma unroll
    for (int r = 0; r < kR; ++r) fence_acc_s32(acc[r]);

    // epilogue: dequant, activation and the output rounding in f32,
    // staged (swizzled) into this tile's own stage, which no other
    // warpgroup reads; int8 in one pass of kR rows, bf16 in passes of as
    // many rows as the stage holds
    bar_sync(1 + c, 128);  // every warp of this warpgroup is done with the halo
    unsigned char* stage_p = sm + (stage - base);
    const int col = t % ncol;
    const int band = (t / ncol) % nband;
    const int f = t / (ncol * nband);
    const int x0 = col * kTW;
    constexpr int kOutLine = TO_INT8 ? kC : 2 * kC;  // bytes of one staged pixel
    constexpr int kChunks = kOutLine / 16;
    constexpr int kFit = kStageTx / (kTW * kOutLine);
    constexpr int kPassRows = kFit < kR ? kFit : kR;
#pragma unroll
    for (int pass = 0; pass < (kR + kPassRows - 1) / kPassRows; ++pass) {
      const int rows = kR - pass * kPassRows < kPassRows ? kR - pass * kPassRows : kPassRows;
      if (pass > 0) bar_sync(1 + c, 128);  // the previous pass was stored
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 sj = *reinterpret_cast<const float2*>(ps + 8 * j + 2 * q);
        const float2 bj = *reinterpret_cast<const float2*>(ps + kC + 8 * j + 2 * q);
        const float2 lj = *reinterpret_cast<const float2*>(ps + 2 * kC + 8 * j + 2 * q);
#pragma unroll
        for (int rr = 0; rr < kPassRows; ++rr) {
          const int r = pass * kPassRows + rr;
          if (r >= kR) continue;
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const uint32_t line = (uint32_t)rr * kTW + warp * 16 + g + 8 * half;
            const float v0 = dequant<ACT>(acc[r][4 * j + 2 * half], sj.x, bj.x, lj.x);
            const float v1 = dequant<ACT>(acc[r][4 * j + 2 * half + 1], sj.y, bj.y, lj.y);
            if (TO_INT8) {
              *reinterpret_cast<uint16_t*>(stage_p + swz64(line, j >> 1) + (j & 1) * 8 +
                                           2 * q) =
                  (uint16_t)requant2(v0, v1, inv_out);
            } else {
              __nv_bfloat162 v;
              v.x = __float2bfloat16_rn(v0);
              v.y = __float2bfloat16_rn(v1);
              *reinterpret_cast<__nv_bfloat162*>(stage_p + swz(line, j) + 4 * q) = v;
            }
          }
        }
      }
      bar_sync(1 + c, 128);
      const int y0 = band * kR + pass * kPassRows;
#pragma unroll
      for (int i = wt; i < rows * kTW * kChunks; i += 128) {
        const int line = i / kChunks;
        const int ch = i % kChunks;
        const int oy = y0 + line / kTW;
        const int ox = x0 + line % kTW;
        if (oy < h && ox < w) {
          const uint4 v = *reinterpret_cast<const uint4*>(
              stage_p + (TO_INT8 ? swz64(line, ch) : swz(line, ch)));
          *reinterpret_cast<uint4*>(
              dst + (((size_t)f * hp + oy + 1) * wp + ox + 1) * kOutLine + ch * 16) = v;
        }
      }
    }
    // the stage may now be refilled by TMA (async proxy) after this
    // warpgroup's generic reads and writes
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    mbar_arrive(bars + 8 * (kStages + s));
  }
}

template <int ACT, bool TO_INT8>
static int launch(const CUtensorMap& map, void* dst, const void* wpack,
                  const void* scale, const void* bias, const void* slope,
                  float inv_out, int h, int w, int ntiles, int grid,
                  cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(q8_layer_sm90_kernel<ACT, TO_INT8>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kSmem);
  if (err != cudaSuccess) return (int)err;
  q8_layer_sm90_kernel<ACT, TO_INT8><<<grid, kThreads, kSmem, stream>>>(
      map, static_cast<unsigned char*>(dst), static_cast<const uint4*>(wpack),
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<const float*>(slope), inv_out, h, w, ntiles);
  return (int)cudaGetLastError();
}

template <bool TO_INT8>
static int launch_act(int act, const CUtensorMap& map, void* dst, const void* wpack,
                      const void* scale, const void* bias, const void* slope,
                      float inv_out, int h, int w, int ntiles, int grid,
                      cudaStream_t s) {
  switch (act) {
    case kActPrelu:
      return launch<kActPrelu, TO_INT8>(map, dst, wpack, scale, bias, slope, inv_out,
                                        h, w, ntiles, grid, s);
    case kActLeaky:
      return launch<kActLeaky, TO_INT8>(map, dst, wpack, scale, bias, slope, inv_out,
                                        h, w, ntiles, grid, s);
    case kActRelu:
      return launch<kActRelu, TO_INT8>(map, dst, wpack, scale, bias, slope, inv_out,
                                       h, w, ntiles, grid, s);
    default:
      return launch<kActNone, TO_INT8>(map, dst, wpack, scale, bias, slope, inv_out,
                                       h, w, ntiles, grid, s);
  }
}

}  // namespace uvt_q8_sm90

extern "C" {

// One 64 -> 64 int8 chain layer; the same arguments as
// uvt_conv3x3_chain_q8_layer, with the packed weight image in place of
// wmat.  src (N, h+2, w+2, 64) int8, dst (N, h+2, w+2, 64) int8
// (to_int8 != 0) or bf16 with a zero ring, both 16-byte aligned; wpack
// the 36,864-byte image of pack_q8_weights_sm90; scale, bias and slope
// (64,) f32; inv_out is 1/s of the int8 output.  Returns a cudaError_t code
// (cudaErrorInvalidValue for a shape it does not take or a tensor map
// cuTensorMapEncodeTiled refuses).
int uvt_conv3x3_chain_q8_layer_sm90(const void* src, void* dst, const void* wpack,
                                    const void* scale, const void* bias,
                                    const void* slope, float inv_out, int n, int h,
                                    int w, int cin, int cout, int act, int to_int8,
                                    void* stream) {
  using namespace uvt_q8_sm90;
  if (n < 1 || h < 1 || w < 1 || cin != kC || cout != kC || act < kActNone ||
      act > kActRelu || reinterpret_cast<uintptr_t>(src) % 16 ||
      reinterpret_cast<uintptr_t>(dst) % 16 || reinterpret_cast<uintptr_t>(wpack) % 16) {
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
  if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 4, const_cast<void*>(src), dims,
             strides, box, estride, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_64B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
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
  if (to_int8) {
    return launch_act<true>(act, map, dst, wpack, scale, bias, slope, inv_out, h, w,
                            (int)tiles, grid, s);
  }
  return launch_act<false>(act, map, dst, wpack, scale, bias, slope, inv_out, h, w,
                           (int)tiles, grid, s);
}

}  // extern "C"
