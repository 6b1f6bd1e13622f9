// K4: one SAME 3x3 conv + bias + activation over plain NHWC, for Hopper
// (sm_90a).
//
// Replaces upscale_video_tpu/ops/conv_pallas.py:_kernel (reached via
// conv3x3_fused / conv3x3_fused_batch).  Same arithmetic: bf16 x bf16
// products accumulated in f32, + bias, activation (none / per-channel
// PReLU / leaky with one slope / ReLU) in f32, then ONE rounding to the
// output type, the rounding point of conv_pallas.py:99-109.
//
// Layout: x (N, H, W, cin) bf16, out (N, H, W, cout) bf16 or f32, both
// plain; the frame's zero border is predicated inside the kernel
// (conv3x3_plain.cuh), so no padded copy exists.  One launch covers the
// whole batch and every output channel: grid (W/16, H/16, N * chunks of
// at most 128 output channels).  cin runs to 512 and cout to 256.
//
// Bound on the H100: ESRGAN's dense convs do 9*cin*cout MACs per pixel
// against 2*(cin + cout) bytes of activation traffic: 192 -> 64 is 864
// FLOP/byte, above the bf16 ridge (~295), so operations bound it; 64 -> 32
// at 192 FLOP/byte is bound by bytes.  This first version stages each
// chunk's window and weights behind two barriers with plain loads and runs
// WMMA, not wgmma/TMA pipelines (later work).

#include "conv3x3_plain.cuh"

namespace uvt {

constexpr int kActNoneF = 0;
constexpr int kActPreluF = 1;
constexpr int kActLeakyF = 2;
constexpr int kActReluF = 3;

template <int NF>
__global__ void __launch_bounds__(kThreads)
conv3x3_fused_kernel(const __nv_bfloat16* __restrict__ x,
                     void* __restrict__ out,
                     const __nv_bfloat16* __restrict__ wmat,
                     const float* __restrict__ bias,
                     const float* __restrict__ slope, float leaky,
                     int h, int w, int cin, int cout, int chunks, int act,
                     int out_f32) {
  extern __shared__ __align__(128) unsigned char smem[];
  const PlainPlan p = plain_plan(cin, NF);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n = blockIdx.z / chunks;
  const int n0 = (blockIdx.z - n * chunks) * p.np;
  const int y0 = blockIdx.y * kTileH;
  const int x0 = blockIdx.x * kTileW;

  AccFrag acc[2][NF];
  conv_tile_plain<NF>(acc, smem, x, wmat, n, h, w, cin, cout, n0, y0, x0, p,
                      warp);
  __syncthreads();  // every warp is done with the window: reuse it as stage
  float* stage = reinterpret_cast<float*>(smem) + warp * 256;

  // each fragment goes through the warp's 16x16 f32 stage; lane owns pixel
  // (lane / 2) and 8 consecutive channels of it
  const int px = lane >> 1;
  const int t0 = (lane & 1) * 8;
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    const int oy = y0 + warp * 2 + m;
    const int ox = x0 + px;
#pragma unroll
    for (int f = 0; f < NF; ++f) {
      wmma::store_matrix_sync(stage, acc[m][f], 16, wmma::mem_row_major);
      __syncwarp();
      const int k0 = n0 + f * 16 + t0;
      if (oy < h && ox < w && k0 < cout) {
        float v[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int k = k0 + j;
          float y = 0.0f;
          if (k < cout) {
            y = stage[px * 16 + t0 + j] + bias[k];
            if (act == kActReluF) {
              y = fmaxf(y, 0.0f);
            } else if (act == kActPreluF) {
              y = y >= 0.0f ? y : y * slope[k];
            } else if (act == kActLeakyF) {
              y = y >= 0.0f ? y : y * leaky;
            }
          }
          v[j] = y;
        }
        const size_t o = (((size_t)n * h + oy) * w + ox) * cout + k0;
        if (out_f32) {
          float* of = static_cast<float*>(out) + o;
          for (int j = 0; j < 8 && k0 + j < cout; ++j) of[j] = v[j];
        } else {
          __nv_bfloat16* ob = static_cast<__nv_bfloat16*>(out) + o;
          if ((cout & 7) == 0) {
            __align__(16) __nv_bfloat16 pack[8];
#pragma unroll
            for (int j = 0; j < 8; ++j) pack[j] = __float2bfloat16_rn(v[j]);
            *reinterpret_cast<uint4*>(ob) = *reinterpret_cast<uint4*>(pack);
          } else {
            for (int j = 0; j < 8 && k0 + j < cout; ++j) {
              ob[j] = __float2bfloat16_rn(v[j]);
            }
          }
        }
      }
      __syncwarp();
    }
  }
}

template <int NF>
static int launch_conv3x3_fused(const void* x, void* out, const void* wmat,
                                const void* bias, const void* slope,
                                float leaky, int n, int h, int w, int cin,
                                int cout, int chunks, int act, int out_f32,
                                cudaStream_t stream) {
  const PlainPlan p = plain_plan(cin, NF);
  cudaError_t err = cudaFuncSetAttribute(
      conv3x3_fused_kernel<NF>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)p.total);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((w + kTileW - 1) / kTileW, (h + kTileH - 1) / kTileH,
                  n * chunks);
  conv3x3_fused_kernel<NF><<<grid, kThreads, p.total, stream>>>(
      static_cast<const __nv_bfloat16*>(x), out,
      static_cast<const __nv_bfloat16*>(wmat), static_cast<const float*>(bias),
      static_cast<const float*>(slope), leaky, h, w, cin, cout, chunks, act,
      out_f32);
  return (int)cudaGetLastError();
}

}  // namespace uvt

extern "C" {

// One conv layer.  Pointers: x (N, h, w, cin) bf16, out (N, h, w, cout)
// bf16 (out_f32 = 0) or f32 (1), wmat (9*cin, cout) bf16 in (dy, dx, cin)
// row order, bias (cout,) f32, slope (cout,) f32 read only for PReLU;
// leaky is the leaky-ReLU slope.  Returns a cudaError_t code.
int uvt_conv3x3_fused(const void* x, void* out, const void* wmat,
                      const void* bias, const void* slope, float leaky, int n,
                      int h, int w, int cin, int cout, int act, int out_f32,
                      void* stream) {
  if (n < 1 || h < 1 || w < 1 || cin < 1 || cin > 512 || cout < 1 ||
      cout > 256 || (h + uvt::kTileH - 1) / uvt::kTileH > 65535 ||
      act < uvt::kActNoneF || act > uvt::kActReluF || out_f32 < 0 ||
      out_f32 > 1) {
    return (int)cudaErrorInvalidValue;
  }
  // split the output channels evenly over the fewest blocks of <= 128
  const int chunks = (cout + 16 * uvt::kMaxNF - 1) / (16 * uvt::kMaxNF);
  const int nf = ((cout + chunks - 1) / chunks + 15) / 16;
  if ((long long)n * chunks > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (nf) {
    case 1: return uvt::launch_conv3x3_fused<1>(x, out, wmat, bias, slope, leaky, n, h, w, cin, cout, chunks, act, out_f32, s);
    case 2: return uvt::launch_conv3x3_fused<2>(x, out, wmat, bias, slope, leaky, n, h, w, cin, cout, chunks, act, out_f32, s);
    case 3: return uvt::launch_conv3x3_fused<3>(x, out, wmat, bias, slope, leaky, n, h, w, cin, cout, chunks, act, out_f32, s);
    case 4: return uvt::launch_conv3x3_fused<4>(x, out, wmat, bias, slope, leaky, n, h, w, cin, cout, chunks, act, out_f32, s);
    case 5: return uvt::launch_conv3x3_fused<5>(x, out, wmat, bias, slope, leaky, n, h, w, cin, cout, chunks, act, out_f32, s);
    case 6: return uvt::launch_conv3x3_fused<6>(x, out, wmat, bias, slope, leaky, n, h, w, cin, cout, chunks, act, out_f32, s);
    case 7: return uvt::launch_conv3x3_fused<7>(x, out, wmat, bias, slope, leaky, n, h, w, cin, cout, chunks, act, out_f32, s);
    default: return uvt::launch_conv3x3_fused<8>(x, out, wmat, bias, slope, leaky, n, h, w, cin, cout, chunks, act, out_f32, s);
  }
}

}  // extern "C"
