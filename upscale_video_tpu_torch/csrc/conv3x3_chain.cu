// K1: one layer of the bordered SAME-3x3 conv chain, for Hopper (sm_90a).
//
// Replaces upscale_video_tpu/ops/conv_chain.py:_chain_kernel (reached via
// _chain_step / conv3x3_chain).  Same arithmetic: bf16 x bf16 products
// accumulated in f32, + bias, activation (none / per-channel PReLU / leaky
// with the slope broadcast per channel / ReLU) in f32, then ONE rounding to
// bf16 (__float2bfloat16_rn), the rounding point of conv_chain.py:117-127.
//
// Layout: reads the bordered bf16 NHWC buffer src (N, H+2, W+2, cin) and
// writes only the interior of dst (N, H+2, W+2, cout).  dst's ring was
// zeroed once by the wrapper and is never written, so it stays zero across
// every layer of the stack: no pad, crop or mask pass runs between layers.
//
// Bound on the H100: compute (see conv3x3_core.cuh).  One launch per layer
// covers the whole frame batch (grid z = N).  Element offsets are 64-bit:
// a main-path buffer holds 4 x 1082 x 1922 x 64 bf16 values.

#include "conv3x3_core.cuh"

namespace uvt {

constexpr int kActNone = 0;
constexpr int kActPrelu = 1;
constexpr int kActLeaky = 2;
constexpr int kActRelu = 3;

template <int NF>
__global__ void __launch_bounds__(kThreads)
chain_layer_kernel(const __nv_bfloat16* __restrict__ src,
                   __nv_bfloat16* __restrict__ dst,
                   const __nv_bfloat16* __restrict__ wmat,
                   const float* __restrict__ bias,
                   const float* __restrict__ slope,
                   int h, int w, int cin, int cout, int act) {
  extern __shared__ __align__(128) unsigned char smem[];
  const SmemPlan p = smem_plan(cin, cout);
  __nv_bfloat16* in_s = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* w_s = reinterpret_cast<__nv_bfloat16*>(smem + p.in_bytes);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* stage = reinterpret_cast<float*>(smem + p.in_bytes + p.w_bytes) +
                 warp * 256;

  const int n = blockIdx.z;
  const int y0 = blockIdx.y * kTileH;
  const int x0 = blockIdx.x * kTileW;
  const int hp = h + 2;
  const int wp = w + 2;

  load_halo(in_s, src, n, hp, wp, cin, p, y0, x0);
  AccFrag acc[2][NF];
  conv_tile<NF>(acc, in_s, w_s, wmat, cin, cout, p, warp);

  // epilogue: each fragment goes through the warp's 16x16 f32 stage; lane
  // owns pixel (lane / 2) and 8 consecutive channels of it
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
      const int k0 = f * 16 + t0;
      if (oy < h && ox < w && k0 < cout) {
        float v[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int k = k0 + j;
          float y = 0.0f;
          if (k < cout) {
            y = stage[px * 16 + t0 + j] + bias[k];
            if (act == kActRelu) {
              y = fmaxf(y, 0.0f);
            } else if (act == kActPrelu || act == kActLeaky) {
              y = y >= 0.0f ? y : y * slope[k];
            }
          }
          v[j] = y;
        }
        __nv_bfloat16* o =
            dst + (((size_t)n * hp + oy + 1) * wp + ox + 1) * cout + k0;
        if ((cout & 7) == 0) {
          __align__(16) __nv_bfloat16 pack[8];
#pragma unroll
          for (int j = 0; j < 8; ++j) pack[j] = __float2bfloat16_rn(v[j]);
          *reinterpret_cast<uint4*>(o) = *reinterpret_cast<uint4*>(pack);
        } else {
          for (int j = 0; j < 8 && k0 + j < cout; ++j) {
            o[j] = __float2bfloat16_rn(v[j]);
          }
        }
      }
      __syncwarp();
    }
  }
}

template <int NF>
static int launch_chain_layer(const void* src, void* dst, const void* wmat,
                              const void* bias, const void* slope, int n,
                              int h, int w, int cin, int cout, int act,
                              cudaStream_t stream) {
  const SmemPlan p = smem_plan(cin, cout);
  cudaError_t err = cudaFuncSetAttribute(
      chain_layer_kernel<NF>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)p.total);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((w + kTileW - 1) / kTileW, (h + kTileH - 1) / kTileH, n);
  chain_layer_kernel<NF><<<grid, kThreads, p.total, stream>>>(
      static_cast<const __nv_bfloat16*>(src), static_cast<__nv_bfloat16*>(dst),
      static_cast<const __nv_bfloat16*>(wmat), static_cast<const float*>(bias),
      static_cast<const float*>(slope), h, w, cin, cout, act);
  return (int)cudaGetLastError();
}

}  // namespace uvt

extern "C" {

// One chain layer.  Pointers: src (N, h+2, w+2, cin) bf16, dst (N, h+2,
// w+2, cout) bf16 with a zero ring, wmat (9*cin, cout) bf16 in (dy, dx,
// cin) row order, bias and slope (cout,) f32.  Returns a cudaError_t code.
int uvt_conv3x3_chain_layer(const void* src, void* dst, const void* wmat,
                            const void* bias, const void* slope, int n,
                            int h, int w, int cin, int cout, int act,
                            void* stream) {
  if (n < 1 || h < 1 || w < 1 || cin < 1 || cin > 128 || cout < 1 ||
      cout > 128 || n > 65535 || (h + uvt::kTileH - 1) / uvt::kTileH > 65535 ||
      act < uvt::kActNone || act > uvt::kActRelu) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((cout + 15) / 16) {
    case 1: return uvt::launch_chain_layer<1>(src, dst, wmat, bias, slope, n, h, w, cin, cout, act, s);
    case 2: return uvt::launch_chain_layer<2>(src, dst, wmat, bias, slope, n, h, w, cin, cout, act, s);
    case 3: return uvt::launch_chain_layer<3>(src, dst, wmat, bias, slope, n, h, w, cin, cout, act, s);
    case 4: return uvt::launch_chain_layer<4>(src, dst, wmat, bias, slope, n, h, w, cin, cout, act, s);
    case 5: return uvt::launch_chain_layer<5>(src, dst, wmat, bias, slope, n, h, w, cin, cout, act, s);
    case 6: return uvt::launch_chain_layer<6>(src, dst, wmat, bias, slope, n, h, w, cin, cout, act, s);
    case 7: return uvt::launch_chain_layer<7>(src, dst, wmat, bias, slope, n, h, w, cin, cout, act, s);
    default: return uvt::launch_chain_layer<8>(src, dst, wmat, bias, slope, n, h, w, cin, cout, act, s);
  }
}

const char* uvt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
