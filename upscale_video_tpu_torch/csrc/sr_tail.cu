// K2: the fused SRVGG tail, for Hopper (sm_90a).
//
// Replaces upscale_video_tpu/ops/tail_pallas.py:_tail_chain_kernel (reached
// via sr_tail_fused_chain).  From the conv chain's bordered bf16 buffer
// (N, H+2, W+2, Cf) it computes, per low-res pixel, the tail conv
// Cf -> 3*s*s + bias in f32 (bf16 tensor-core products, f32 accumulate),
// adds the nearest-s skip of the bf16-rounded model-domain input (channel
// k = c*s*s + a*s + b takes skip channel c: the pixel shuffle's order,
// tail_pallas.py:203-209), and writes one of three layouts:
//
//   0 planar : uint8 (N, H, W, 3*s*s), (a, b, c) order with c fastest and
//              BGR->RGB folded in — exactly executor._planar_tail_u8's
//              output and planar_to_frames' input;
//   1 frames : uint8 (N, s*H, s*W, 3) RGB;
//   2 model  : float32 (N, s*H, s*W, 3) in the BGR model domain (tests).
//
// The u8 epilogue is clip(rint(v * 255), 0, 255): rintf rounds half to
// even like jnp.round (roundf would round half away from zero).
//
// Bound on the H100: the 64 -> 12 conv does 13,824 FLOP per low-res pixel
// against ~146 bytes (128 read from the chain buffer, 6 of skip, 12 u8
// written): ~95 FLOP/byte, below the bf16 ridge, so it is memory-bound.
// The design reads the chain's buffer once, in place (no crop, no pad, no
// separate shuffle, skip-add or quantize pass over the 4K output).  The
// conv core is shared with K1 (one 16-wide N fragment for s = 2, of which
// 12 columns are used); one launch covers the whole frame batch.

#include "conv3x3_core.cuh"

namespace uvt {

template <int NF>
__global__ void __launch_bounds__(kThreads)
sr_tail_kernel(const __nv_bfloat16* __restrict__ src,
               const __nv_bfloat16* __restrict__ skip,
               const __nv_bfloat16* __restrict__ wmat,
               const float* __restrict__ bias, void* __restrict__ out,
               int h, int w, int cin, int scale, int layout) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int s2 = scale * scale;
  const int cout = 3 * s2;
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

  load_halo(in_s, src, n, h + 2, w + 2, cin, p, y0, x0);
  AccFrag acc[2][NF];
  conv_tile<NF>(acc, in_s, w_s, wmat, cin, cout, p, warp);

  const int px = lane >> 1;
  const int t0 = (lane & 1) * 8;
  const size_t sh = (size_t)h * scale;
  const size_t sw = (size_t)w * scale;
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    const int oy = y0 + warp * 2 + m;
    const int ox = x0 + px;
#pragma unroll
    for (int f = 0; f < NF; ++f) {
      wmma::store_matrix_sync(stage, acc[m][f], 16, wmma::mem_row_major);
      __syncwarp();
      if (oy < h && ox < w) {
        const size_t pix = ((size_t)n * h + oy) * w + ox;
        for (int j = 0; j < 8; ++j) {
          const int k = f * 16 + t0 + j;
          if (k >= cout) break;
          const int c = k / s2;
          const int a = (k - c * s2) / scale;
          const int b = k - c * s2 - a * scale;
          const float v = stage[px * 16 + t0 + j] + bias[k] +
                          __bfloat162float(skip[pix * 3 + c]);
          const size_t hr = ((size_t)n * sh + (size_t)oy * scale + a) * sw +
                            (size_t)ox * scale + b;
          if (layout == 2) {
            static_cast<float*>(out)[hr * 3 + c] = v;
          } else {
            float q = rintf(v * 255.0f);
            q = fminf(fmaxf(q, 0.0f), 255.0f);
            const unsigned char u = static_cast<unsigned char>(q);
            unsigned char* o = static_cast<unsigned char*>(out);
            if (layout == 0) {
              o[pix * cout + (a * scale + b) * 3 + (2 - c)] = u;
            } else {
              o[hr * 3 + (2 - c)] = u;
            }
          }
        }
      }
      __syncwarp();
    }
  }
}

template <int NF>
static int launch_sr_tail(const void* src, const void* skip, const void* wmat,
                          const void* bias, void* out, int n, int h, int w,
                          int cin, int scale, int layout,
                          cudaStream_t stream) {
  const SmemPlan p = smem_plan(cin, 3 * scale * scale);
  cudaError_t err = cudaFuncSetAttribute(
      sr_tail_kernel<NF>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)p.total);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((w + kTileW - 1) / kTileW, (h + kTileH - 1) / kTileH, n);
  sr_tail_kernel<NF><<<grid, kThreads, p.total, stream>>>(
      static_cast<const __nv_bfloat16*>(src),
      static_cast<const __nv_bfloat16*>(skip),
      static_cast<const __nv_bfloat16*>(wmat), static_cast<const float*>(bias),
      out, h, w, cin, scale, layout);
  return (int)cudaGetLastError();
}

}  // namespace uvt

extern "C" {

// The fused tail.  Pointers: src (N, h+2, w+2, cin) bf16 with a zero ring,
// skip (N, h, w, 3) bf16, wmat (9*cin, 3*scale^2) bf16, bias (3*scale^2,)
// f32, out per layout (see above).  Returns a cudaError_t code.
int uvt_sr_tail(const void* src, const void* skip, const void* wmat,
                const void* bias, void* out, int n, int h, int w, int cin,
                int scale, int layout, void* stream) {
  if (n < 1 || h < 1 || w < 1 || cin < 1 || cin > 128 || scale < 1 ||
      scale > 6 || layout < 0 || layout > 2 || n > 65535 ||
      (h + uvt::kTileH - 1) / uvt::kTileH > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((3 * scale * scale + 15) / 16) {
    case 1: return uvt::launch_sr_tail<1>(src, skip, wmat, bias, out, n, h, w, cin, scale, layout, s);
    case 2: return uvt::launch_sr_tail<2>(src, skip, wmat, bias, out, n, h, w, cin, scale, layout, s);
    case 3: return uvt::launch_sr_tail<3>(src, skip, wmat, bias, out, n, h, w, cin, scale, layout, s);
    case 4: return uvt::launch_sr_tail<4>(src, skip, wmat, bias, out, n, h, w, cin, scale, layout, s);
    case 5: return uvt::launch_sr_tail<5>(src, skip, wmat, bias, out, n, h, w, cin, scale, layout, s);
    case 6: return uvt::launch_sr_tail<6>(src, skip, wmat, bias, out, n, h, w, cin, scale, layout, s);
    default: return uvt::launch_sr_tail<7>(src, skip, wmat, bias, out, n, h, w, cin, scale, layout, s);
  }
}

}  // extern "C"
