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
//
// K3 (uvt_sr_tail_plain) is the same tail from a plain bf16 activation
// (N, H, W, Cf), Cf up to 512: it replaces tail_pallas.py:_tail_kernel
// (reached via sr_tail_fused / sr_tail_fused_batch), which returns the f32
// model layout only; here it writes K2's three layouts with K2's epilogue.
// Its mainloop is K4's (conv3x3_plain.cuh: the frame border predicated,
// the input channels staged in chunks).  Bound: bytes, as K2's; a 160 ->
// 12 tail reads 320 bytes per low-res pixel for 34,560 FLOP.

#include "conv3x3_plain.cuh"

namespace uvt {

// The tail's epilogue for one block of 16x16 low-res pixels at (y0, x0) of
// frame n: each accumulator fragment goes through the warp's 16x16 f32
// stage, + bias + the skip, then the layout's store.  Shared by K2 and K3.
template <int NF>
__device__ inline void tail_epilogue(AccFrag (&acc)[2][NF], float* stage,
                                     const __nv_bfloat16* __restrict__ skip,
                                     const float* __restrict__ bias,
                                     void* __restrict__ out, int n, int h,
                                     int w, int scale, int layout, int y0,
                                     int x0, int warp, int lane) {
  const int s2 = scale * scale;
  const int cout = 3 * s2;
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
__global__ void __launch_bounds__(kThreads)
sr_tail_kernel(const __nv_bfloat16* __restrict__ src,
               const __nv_bfloat16* __restrict__ skip,
               const __nv_bfloat16* __restrict__ wmat,
               const float* __restrict__ bias, void* __restrict__ out,
               int h, int w, int cin, int scale, int layout) {
  extern __shared__ __align__(128) unsigned char smem[];
  const SmemPlan p = smem_plan(cin, 3 * scale * scale);
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
  conv_tile<NF>(acc, in_s, w_s, wmat, cin, 3 * scale * scale, p, warp);
  tail_epilogue<NF>(acc, stage, skip, bias, out, n, h, w, scale, layout, y0,
                    x0, warp, lane);
}

// K3: the same tail from a plain (N, h, w, cin) activation; the SAME
// border is predicated in the mainloop (conv3x3_plain.cuh), whose channel
// chunks take cin up to 512.
template <int NF>
__global__ void __launch_bounds__(kThreads)
sr_tail_plain_kernel(const __nv_bfloat16* __restrict__ u,
                     const __nv_bfloat16* __restrict__ skip,
                     const __nv_bfloat16* __restrict__ wmat,
                     const float* __restrict__ bias, void* __restrict__ out,
                     int h, int w, int cin, int scale, int layout) {
  extern __shared__ __align__(128) unsigned char smem[];
  const PlainPlan p = plain_plan(cin, NF);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n = blockIdx.z;
  const int y0 = blockIdx.y * kTileH;
  const int x0 = blockIdx.x * kTileW;

  AccFrag acc[2][NF];
  conv_tile_plain<NF>(acc, smem, u, wmat, n, h, w, cin, 3 * scale * scale,
                      0, y0, x0, p, warp);
  __syncthreads();  // every warp is done with the window: reuse it as stage
  tail_epilogue<NF>(acc, reinterpret_cast<float*>(smem) + warp * 256, skip,
                    bias, out, n, h, w, scale, layout, y0, x0, warp, lane);
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

template <int NF>
static int launch_sr_tail_plain(const void* u, const void* skip,
                                const void* wmat, const void* bias, void* out,
                                int n, int h, int w, int cin, int scale,
                                int layout, cudaStream_t stream) {
  const PlainPlan p = plain_plan(cin, NF);
  cudaError_t err = cudaFuncSetAttribute(
      sr_tail_plain_kernel<NF>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)p.total);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((w + kTileW - 1) / kTileW, (h + kTileH - 1) / kTileH, n);
  sr_tail_plain_kernel<NF><<<grid, kThreads, p.total, stream>>>(
      static_cast<const __nv_bfloat16*>(u),
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

// K3, the tail from a plain activation.  Pointers: u (N, h, w, cin) bf16,
// skip (N, h, w, 3) bf16, wmat (9*cin, 3*scale^2) bf16, bias (3*scale^2,)
// f32, out per layout (see above).  Returns a cudaError_t code.
int uvt_sr_tail_plain(const void* u, const void* skip, const void* wmat,
                      const void* bias, void* out, int n, int h, int w,
                      int cin, int scale, int layout, void* stream) {
  if (n < 1 || h < 1 || w < 1 || cin < 1 || cin > 512 || scale < 1 ||
      scale > 6 || layout < 0 || layout > 2 || n > 65535 ||
      (h + uvt::kTileH - 1) / uvt::kTileH > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((3 * scale * scale + 15) / 16) {
    case 1: return uvt::launch_sr_tail_plain<1>(u, skip, wmat, bias, out, n, h, w, cin, scale, layout, s);
    case 2: return uvt::launch_sr_tail_plain<2>(u, skip, wmat, bias, out, n, h, w, cin, scale, layout, s);
    case 3: return uvt::launch_sr_tail_plain<3>(u, skip, wmat, bias, out, n, h, w, cin, scale, layout, s);
    case 4: return uvt::launch_sr_tail_plain<4>(u, skip, wmat, bias, out, n, h, w, cin, scale, layout, s);
    case 5: return uvt::launch_sr_tail_plain<5>(u, skip, wmat, bias, out, n, h, w, cin, scale, layout, s);
    case 6: return uvt::launch_sr_tail_plain<6>(u, skip, wmat, bias, out, n, h, w, cin, scale, layout, s);
    default: return uvt::launch_sr_tail_plain<7>(u, skip, wmat, bias, out, n, h, w, cin, scale, layout, s);
  }
}

}  // extern "C"
