// K1 on Hopper for the narrow shapes: one layer of the bordered SAME-3x3
// conv chain as a persistent, warp-specialised wgmma kernel (sm_90a), for
// 24->24, 3->64, 3->24, 24->3 and 64->3.
//
// Replaces upscale_video_tpu/ops/conv_chain.py:61 (_chain_kernel) for the
// layers ops/conv_chain.py:chain_kernel names "narrow": the nf-24 anime
// chain (3->24, 8 x 24->24, 24->3), the default Compact chain's 3->64 head
// and the RRDBNets' 64->3 conv_last at 4x.  64->64 runs on
// conv3x3_chain_sm90.cu, every other shape on conv3x3_chain.cu (WMMA).
// Same contract and arithmetic as those: bordered bf16 NHWC src -> the
// interior of a bordered dst whose zero ring is never written, bf16 x bf16
// products summed in f32, + f32 bias, the activation in f32, one rounding
// to bf16 (__float2bfloat16_rn, conv_chain.py:117-127).  The sum runs in
// another order than cuDNN's, so a value may differ by a bf16 ulp.
//
// 3-channel buffers are 8 channels wide on this path (16 bytes a pixel, so
// TMA's strides and ldmatrix's rows are 16-byte aligned): a 3-channel
// input's channels 3..7 are zero (ops/conv_chain.py:embed) and a 3-channel
// output's channels 3..7 are written as zero (their weights and bias are
// zero and every activation keeps 0 at 0).
//
// Bound on the H100: bytes.  A 24->24 layer does 2*9*24*24 = 10,368 FLOP
// per pixel for 96 bytes, 108 FLOP/byte, far under the bf16 ridge (~295);
// 3->64, 3->24, 24->3 and 64->3 do less per byte still.  At 4x1080p a
// 24->24 layer moves 0.80 GB, 0.238 ms at 3.35 TB/s.
//
// Design (one block per SM, 384 threads: a producer warpgroup and two
// consumer warpgroups, as conv3x3_chain_sm90.cu):
// - Persistent blocks walk tiles of R output rows x 64 output columns x
//   all output channels of one frame (R = 8, or 4 where the output or the
//   halo is wide: 3->64, 64->3); the two consumers take alternate tiles,
//   so one's epilogue overlaps the other's MMAs.
// - Halo ring by TMA: a 4-D tensor map over the bordered input (C, W+2,
//   H+2, N), box C x 66 x (R+2) x 1, zero-filled past the buffer; up to 6
//   stages (as many as fit beside the weights), full/empty mbarriers; one
//   producer thread keeps the ring full (setmaxnreg 40; consumers 232).
// - dx folded into K: in a bordered NHWC row the taps x-1, x, x+1 of
//   output pixel x are 3*C contiguous channels, so one output row needs,
//   per dy, K = 3*C (24 for an 8-wide input, 72 for 24 channels, 192 for
//   64), rounded up to 16 with zero weight rows: 2, 5 or 12 k16 steps.
//   ldmatrix takes A for 64 pixels with rows 2*C bytes apart (16 or 48 B:
//   16-byte aligned and free of bank conflicts; the 64-channel halo is
//   128-byte swizzled by TMA, as in conv3x3_chain_sm90.cu).  The 16-byte
//   chunk of a k step that lies wholly in the zero-weight padding is read
//   from the step's other chunk instead, so no read leaves the halo row.
// - A-fragment reuse: each halo row's fragments are loaded once and issued
//   against every output row they feed (dy = 0..2); A is double-buffered
//   across halo rows (wgmma.wait_group 1).
// - Resident weights in wgmma's K-major B layout: per dy, 64-wide K atoms
//   of N lines x 128 bytes with the 128-byte swizzle; N is cout rounded up
//   to 8 (n8, n24, n64), the padded rows and columns zero.  The host packs
//   the image once (ops/conv_chain.py:pack_narrow_weights); each block
//   copies it into shared memory (6-24 KB) and reads it through
//   descriptors for every tile.
// - Epilogue in registers: bias, activation and the one rounding on the
//   accumulators, staged in shared memory (the tile's own stage, or beside
//   its halo when the output tile is larger), then 16-byte stores masked
//   to the interior, so the ring is never written.

#include "sm90_common.cuh"

namespace uvt_narrow {

using namespace uvt_sm90_common;

constexpr int kTW = 64;                   // output columns per tile (wgmma M)
constexpr int kHaloCols = kTW + 2;
constexpr int kWGs = 2;                   // consumer warpgroups
constexpr int kThreads = (kWGs + 1) * 128;  // + the producer warpgroup
constexpr int kSmemLimit = 232448;
constexpr int kMaxStages = 6;

constexpr int round_up(int v, int m) { return (v + m - 1) / m * m; }
constexpr int max_of(int a, int b) { return a > b ? a : b; }
constexpr int min_of(int a, int b) { return a < b ? a : b; }

// The shared-memory plan of one shape: CS input channels (8 for a
// 3-channel input), NP output channels (cout rounded up to 8; wgmma's N),
// R output rows per tile.
template <int CS, int NP, int R>
struct Plan {
  static constexpr int kCSB = CS * 2;             // bytes per input pixel
  static constexpr bool kSwz = CS == 64;          // 128-byte swizzled halo
  static constexpr int kKS = (3 * CS + 15) / 16;  // k16 steps per dy
  static constexpr int kAtoms = (kKS + 3) / 4;    // 64-wide K atoms per dy
  static constexpr int kAtomBytes = NP * 128;
  static constexpr int kWBytes = 3 * kAtoms * kAtomBytes;
  static constexpr int kHaloRows = R + 2;
  static constexpr int kStageTx = kHaloRows * kHaloCols * kCSB;
  static constexpr int kOutBytes = R * kTW * NP * 2;
  // the output tile is staged over the halo when it fits, else beside it
  static constexpr int kOutOff = kOutBytes <= kStageTx ? 0 : round_up(kStageTx, 1024);
  static constexpr int kStageBytes = round_up(max_of(kStageTx, kOutOff + kOutBytes), 1024);
  // alignment slack, weights, bias + slope; per stage its bytes and two barriers
  static constexpr int kFixed = 1024 + kWBytes + 2 * NP * 4;
  static constexpr int kStages =
      min_of(kMaxStages, (kSmemLimit - kFixed) / (kStageBytes + 16));
  static constexpr int kSmem = kFixed + kStages * (kStageBytes + 16);
  static_assert(kStages >= 3, "the halo ring needs three stages");
  static_assert(kSmem <= kSmemLimit, "shared memory plan exceeds the block limit");
  static_assert(kAtomBytes % 1024 == 0, "weight atoms must stay 1024-aligned");
  static_assert((3 * CS) % 8 == 0, "K must fill whole 16-byte chunks");
};

template <int CS, int NP, int R, int ACT>
__global__ void __launch_bounds__(kThreads, 1)
chain_layer_narrow_kernel(const __grid_constant__ CUtensorMap src_map,
                          __nv_bfloat16* __restrict__ dst,
                          const __nv_bfloat16* __restrict__ wpack,
                          const float* __restrict__ bias,
                          const float* __restrict__ slope, int h, int w,
                          int cout, int ntiles) {
  using P = Plan<CS, NP, R>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* sm = smem_raw + (base - raw);
  const uint32_t ring = base + P::kWBytes;
  const uint32_t bars = ring + P::kStages * P::kStageBytes;  // full[s], then empty[s]
  float* bs_s = reinterpret_cast<float*>(sm + (bars - base) + 2 * P::kStages * 8);
  const int hp = h + 2;
  const int wp = w + 2;
  const int ncol = (w + kTW - 1) / kTW;
  const int nband = (h + R - 1) / R;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < P::kStages; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (P::kStages + s), 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // resident weights: the packed image, already in the swizzled B layout
  for (int i = tid; i < P::kWBytes / 16; i += kThreads) {
    reinterpret_cast<uint4*>(sm)[i] = reinterpret_cast<const uint4*>(wpack)[i];
  }
  if (tid < NP) {
    const bool real = tid < cout;
    bs_s[tid] = real ? bias[tid] : 0.0f;
    bs_s[NP + tid] =
        (real && (ACT == kActPrelu || ACT == kActLeaky)) ? slope[tid] : 0.0f;
  }
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncthreads();

  const int wg = tid >> 7;
  if (wg == 0) {  // producer warpgroup: one thread keeps the TMA ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;" ::: "memory");
    if (tid == 0) {
      int k = 0;
      for (int t = blockIdx.x; t < ntiles; t += gridDim.x, ++k) {
        const int s = k % P::kStages;
        if (k >= P::kStages) {
          mbar_wait(bars + 8 * (P::kStages + s), ((k / P::kStages) - 1) & 1);
        }
        const int col = t % ncol;
        const int band = (t / ncol) % nband;
        const int f = t / (ncol * nband);
        const uint32_t full = bars + 8 * s;
        mbar_expect_tx(full, P::kStageTx);
        tma_load_4d(ring + s * P::kStageBytes, &src_map, full, 0, col * kTW,
                    band * R, f);
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
  const uint32_t jx = (uint32_t)(warp * 16 + (lane & 15));  // this lane's A row
  const uint32_t hi = (uint32_t)(lane >> 4);                // its 16-byte chunk

  for (int k = c, t = blockIdx.x + c * gridDim.x; t < ntiles;
       k += kWGs, t += kWGs * gridDim.x) {
    const int s = k % P::kStages;
    const uint32_t stage = ring + s * P::kStageBytes;
    float acc[R][NP / 2];
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int i = 0; i < NP / 2; ++i) acc[r][i] = 0.0f;
      fence_acc(acc[r]);
    }
    // the stage's previous tile (the other warpgroup's) was consumed, so
    // the full barrier is in this tile's phase: a parity wait alone cannot
    // tell a phase from the one two back
    if (k >= P::kStages) {
      mbar_wait(bars + 8 * (P::kStages + s), ((k / P::kStages) - 1) & 1);
    }
    mbar_wait(bars + 8 * s, (k / P::kStages) & 1);

    // one group per halo row: its kKS A fragments (the dx-folded K of 64
    // pixels), issued against every output row hr - dy they feed
    uint32_t a[2][P::kKS][4];
#pragma unroll
    for (int hr = 0; hr < P::kHaloRows; ++hr) {
      const int b = hr & 1;
#pragma unroll
      for (int kk = 0; kk < P::kKS; ++kk) {
        uint32_t addr;
        if (P::kSwz) {
          addr = stage + swz((uint32_t)hr * kHaloCols + jx + kk / 4, 2 * (kk % 4) + hi);
        } else {
          uint32_t koff = 32u * kk + 16u * hi;
          // a chunk wholly in the zero-weight padding reads its neighbour
          if (32 * kk + 16 >= 3 * P::kCSB) koff -= 16u * hi;
          addr = stage + ((uint32_t)hr * kHaloCols + jx) * P::kCSB + koff;
        }
        ldsm_x4(addr, a[b][kk]);
      }
      wg_fence();
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        const int r = hr - dy;
        if (r < 0 || r >= R) continue;
#pragma unroll
        for (int kk = 0; kk < P::kKS; ++kk) {
          wgmma_rs<NP>(acc[r], a[b][kk],
                       wdesc + (uint64_t)(((dy * P::kAtoms + kk / 4) * P::kAtomBytes +
                                           (kk % 4) * 32) >> 4));
        }
      }
      wg_commit();
      wg_wait1();
    }
    wg_wait0();
#pragma unroll
    for (int r = 0; r < R; ++r) fence_acc(acc[r]);

    // epilogue: bias + activation in f32, one rounding, staged in this
    // tile's own stage (no other warpgroup reads it); a 64-channel pixel
    // is one 128-byte line, swizzled so the staging writes are free of
    // bank conflicts, narrower pixels pack densely
    bar_sync(1 + c, 128);  // every warp of this warpgroup is done with the halo
    unsigned char* out_p = sm + (stage - base) + P::kOutOff;
#pragma unroll
    for (int j = 0; j < NP / 8; ++j) {
      const float2 bj = *reinterpret_cast<const float2*>(bs_s + 8 * j + 2 * q);
      const float2 sj = *reinterpret_cast<const float2*>(bs_s + NP + 8 * j + 2 * q);
#pragma unroll
      for (int r = 0; r < R; ++r) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const uint32_t line = (uint32_t)r * kTW + warp * 16 + g + 8 * half;
          const uint32_t off = NP == 64 ? swz(line, j) : line * (NP * 2) + j * 16;
          const float v0 = activate<ACT>(acc[r][4 * j + 2 * half] + bj.x, sj.x);
          const float v1 = activate<ACT>(acc[r][4 * j + 2 * half + 1] + bj.y, sj.y);
          *reinterpret_cast<__nv_bfloat162*>(out_p + off + 4 * q) =
              __floats2bfloat162_rn(v0, v1);
        }
      }
    }
    bar_sync(1 + c, 128);
    const int col = t % ncol;
    const int band = (t / ncol) % nband;
    const int f = t / (ncol * nband);
    const int y0 = band * R;
    const int x0 = col * kTW;
    constexpr int kChunks = NP / 8;  // 16-byte chunks per output pixel
#pragma unroll 4
    for (int i = wt; i < R * kTW * kChunks; i += 128) {
      const int line = i / kChunks;
      const int ch = i % kChunks;
      const int oy = y0 + line / kTW;
      const int ox = x0 + line % kTW;
      if (oy < h && ox < w) {
        const uint32_t off = NP == 64 ? swz(line, ch) : line * (NP * 2) + ch * 16;
        const uint4 v = *reinterpret_cast<const uint4*>(out_p + off);
        *reinterpret_cast<uint4*>(
            dst + (((size_t)f * hp + oy + 1) * wp + ox + 1) * NP + ch * 8) = v;
      }
    }
    // the stage may now be refilled by TMA (async proxy) after this
    // warpgroup's generic reads and writes
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    mbar_arrive(bars + 8 * (P::kStages + s));
  }
}

template <int CS, int NP, int R, int ACT>
static int launch(const CUtensorMap& map, void* dst, const void* wpack,
                  const void* bias, const void* slope, int h, int w, int cout,
                  int ntiles, int grid, cudaStream_t stream) {
  auto kernel = chain_layer_narrow_kernel<CS, NP, R, ACT>;
  constexpr int smem = Plan<CS, NP, R>::kSmem;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, kThreads, smem, stream>>>(
      map, static_cast<__nv_bfloat16*>(dst), static_cast<const __nv_bfloat16*>(wpack),
      static_cast<const float*>(bias), static_cast<const float*>(slope), h, w, cout,
      ntiles);
  return (int)cudaGetLastError();
}

template <int CS, int NP, int R>
static int run(const void* src, void* dst, const void* wpack, const void* bias,
               const void* slope, int n, int h, int w, int cout, int act,
               cudaStream_t stream) {
  using P = Plan<CS, NP, R>;
  const long long tiles = (long long)n * ((h + R - 1) / R) * ((w + kTW - 1) / kTW);
  if (tiles > 0x7fffffff) return (int)cudaErrorInvalidValue;
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap map;
  const cuuint64_t dims[4] = {(cuuint64_t)CS, (cuuint64_t)w + 2, (cuuint64_t)h + 2,
                              (cuuint64_t)n};
  const cuuint64_t strides[3] = {(cuuint64_t)P::kCSB, (cuuint64_t)(w + 2) * P::kCSB,
                                 (cuuint64_t)(h + 2) * (w + 2) * P::kCSB};
  const cuuint32_t box[4] = {(cuuint32_t)CS, (cuuint32_t)kHaloCols,
                             (cuuint32_t)P::kHaloRows, 1};
  const cuuint32_t estride[4] = {1, 1, 1, 1};
  if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(src), dims,
             strides, box, estride, CU_TENSOR_MAP_INTERLEAVE_NONE,
             P::kSwz ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
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
  switch (act) {
    case kActPrelu: return launch<CS, NP, R, kActPrelu>(map, dst, wpack, bias, slope, h, w, cout, (int)tiles, grid, stream);
    case kActLeaky: return launch<CS, NP, R, kActLeaky>(map, dst, wpack, bias, slope, h, w, cout, (int)tiles, grid, stream);
    case kActRelu: return launch<CS, NP, R, kActRelu>(map, dst, wpack, bias, slope, h, w, cout, (int)tiles, grid, stream);
    default: return launch<CS, NP, R, kActNone>(map, dst, wpack, bias, slope, h, w, cout, (int)tiles, grid, stream);
  }
}

}  // namespace uvt_narrow

extern "C" {

// One narrow chain layer.  src (N, h+2, w+2, CS) bf16 and dst (N, h+2,
// w+2, NP) bf16 with a zero ring, where CS and NP are cin and cout with 3
// stored 8 wide; wpack the packed weight image (ops/conv_chain.py:
// pack_narrow_weights), 16-byte aligned; bias and slope (cout,) f32.
// Returns a cudaError_t code (cudaErrorInvalidValue for a shape it does not
// take or a tensor map cuTensorMapEncodeTiled refuses).
int uvt_conv3x3_chain_layer_narrow_sm90(const void* src, void* dst, const void* wpack,
                                        const void* bias, const void* slope, int n,
                                        int h, int w, int cin, int cout, int act,
                                        void* stream) {
  using namespace uvt_narrow;
  if (n < 1 || h < 1 || w < 1 || act < kActNone || act > kActRelu) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cin == 24 && cout == 24) return run<24, 24, 8>(src, dst, wpack, bias, slope, n, h, w, cout, act, s);
  if (cin == 3 && cout == 64) return run<8, 64, 4>(src, dst, wpack, bias, slope, n, h, w, cout, act, s);
  if (cin == 3 && cout == 24) return run<8, 24, 8>(src, dst, wpack, bias, slope, n, h, w, cout, act, s);
  if (cin == 24 && cout == 3) return run<24, 8, 8>(src, dst, wpack, bias, slope, n, h, w, cout, act, s);
  if (cin == 64 && cout == 3) return run<64, 8, 4>(src, dst, wpack, bias, slope, n, h, w, cout, act, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
