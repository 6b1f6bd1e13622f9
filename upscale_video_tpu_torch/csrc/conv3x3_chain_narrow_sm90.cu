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
// Design: the persistent TMA-ring mainloop of conv3x3_ring_sm90.cuh
// (shared with K2's Hopper kernel, sr_tail_sm90.cu): a producer warpgroup
// and two consumers, the bordered halo by TMA, dx folded into K, resident
// weights (N = cout rounded up to 8: n8, n24, n64) packed once by the host
// (ops/conv_chain.py:pack_narrow_weights, 6-24 KB), wgmma with A from
// registers; R = 8 output rows per tile, or 4 where the output or the halo
// is wide (3->64, 64->3).  This file holds the layer's epilogue: bias,
// activation and the one rounding on the accumulators, staged in shared
// memory (the tile's own stage, or beside its halo when the output tile is
// larger), then 16-byte stores masked to the interior, so the ring is
// never written.

#include "conv3x3_ring_sm90.cuh"

namespace uvt_narrow {

using namespace uvt_ring;

// The chain layer's epilogue on the ring (see conv3x3_ring_sm90.cuh).
template <int NP, int R, int ACT>
struct ChainEpi {
  static constexpr int kOutBytes = R * kTW * NP * 2;
  static constexpr int kSideBytes = 0;
  __nv_bfloat16* dst;
  const float* bias;
  const float* slope;
  int h, w, cout;

  __device__ __forceinline__ void consts(float* cs, int, int tid) const {
    if (tid < NP) {
      const bool real = tid < cout;
      cs[tid] = real ? bias[tid] : 0.0f;
      cs[NP + tid] =
          (real && (ACT == kActPrelu || ACT == kActLeaky)) ? slope[tid] : 0.0f;
    }
  }

  __device__ __forceinline__ void prefetch(unsigned char*, bool, TileAt, int, int) const {}

  // bias + activation in f32, one rounding, staged; a 64-channel pixel is
  // one 128-byte line, swizzled so the staging writes are free of bank
  // conflicts, narrower pixels pack densely
  __device__ __forceinline__ void store(float (&acc)[R][NP / 2], unsigned char*,
                                        unsigned char* out_p, const float* cs, int,
                                        TileAt at, int, int c, int warp, int lane,
                                        int wt) const {
    const int g = lane >> 2;
    const int q = lane & 3;
#pragma unroll
    for (int j = 0; j < NP / 8; ++j) {
      const float2 bj = *reinterpret_cast<const float2*>(cs + 8 * j + 2 * q);
      const float2 sj = *reinterpret_cast<const float2*>(cs + NP + 8 * j + 2 * q);
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
    const int hp = h + 2;
    const int wp = w + 2;
    constexpr int kChunks = NP / 8;  // 16-byte chunks per output pixel
#pragma unroll 4
    for (int i = wt; i < R * kTW * kChunks; i += 128) {
      const int line = i / kChunks;
      const int ch = i % kChunks;
      const int oy = at.y0 + line / kTW;
      const int ox = at.x0 + line % kTW;
      if (oy < h && ox < w) {
        const uint32_t off = NP == 64 ? swz(line, ch) : line * (NP * 2) + ch * 16;
        const uint4 v = *reinterpret_cast<const uint4*>(out_p + off);
        *reinterpret_cast<uint4*>(
            dst + (((size_t)at.f * hp + oy + 1) * wp + ox + 1) * NP + ch * 8) = v;
      }
    }
  }
};

template <int CS, int NP, int R, int ACT>
__global__ void __launch_bounds__(kThreads, 1)
chain_layer_narrow_kernel(const __grid_constant__ CUtensorMap src_map,
                          __nv_bfloat16* __restrict__ dst,
                          const __nv_bfloat16* __restrict__ wpack,
                          const float* __restrict__ bias,
                          const float* __restrict__ slope, int h, int w,
                          int cout, int ntiles) {
  const ChainEpi<NP, R, ACT> epi{dst, bias, slope, h, w, cout};
  ring_conv<CS, NP, R>(src_map, wpack, h, w, ntiles, epi);
}

template <int CS, int NP, int R, int ACT>
static int launch(const void* src, void* dst, const void* wpack, const void* bias,
                  const void* slope, int n, int h, int w, int cout,
                  cudaStream_t stream) {
  return launch_ring<CS, NP, R, ChainEpi<NP, R, ACT>>(
      chain_layer_narrow_kernel<CS, NP, R, ACT>, src, n, h, w, stream,
      static_cast<__nv_bfloat16*>(dst), static_cast<const __nv_bfloat16*>(wpack),
      static_cast<const float*>(bias), static_cast<const float*>(slope), h, w, cout);
}

template <int CS, int NP, int R>
static int run(const void* src, void* dst, const void* wpack, const void* bias,
               const void* slope, int n, int h, int w, int cout, int act,
               cudaStream_t stream) {
  switch (act) {
    case kActPrelu: return launch<CS, NP, R, kActPrelu>(src, dst, wpack, bias, slope, n, h, w, cout, stream);
    case kActLeaky: return launch<CS, NP, R, kActLeaky>(src, dst, wpack, bias, slope, n, h, w, cout, stream);
    case kActRelu: return launch<CS, NP, R, kActRelu>(src, dst, wpack, bias, slope, n, h, w, cout, stream);
    default: return launch<CS, NP, R, kActNone>(src, dst, wpack, bias, slope, n, h, w, cout, stream);
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
