// Mainloop of the port's per-layer SAME 3x3 conv over *plain* NHWC input:
// K4 (conv3x3_fused.cu) and the plain-activation SR tail K3 (sr_tail.cu).
//
// Unlike the chain kernels' bordered layout (conv3x3_core.cuh), the input
// here is a plain bf16 (N, H, W, cin) tensor: reads outside the frame are
// predicated and give zero, so there is no padded copy, no embed and no
// crop around a launch.
//
// Implicit GEMM per block: M = 16x16 output pixels of one frame, N = up to
// 128 output channels (NF 16-wide WMMA fragments; wider layers split their
// channels over grid z), K = 9 taps x cin, looped in chunks of kChunkC
// input channels.  Per chunk the block stages the haloed input window
// (18 x 18 x chunk) and the chunk's weights for all 9 taps in shared
// memory, behind one pair of barriers; eight warps each own two output rows
// (two 16-pixel A fragments) and every N fragment.  Products are bf16 x bf16
// on the tensor cores (WMMA m16n16k16), accumulated in f32.  Chunking keeps
// a 192-channel layer (ESRGAN's widest input) at 31 KB of window instead of
// the 124 KB a whole 16x16 window would take; a chunk whose channels are
// not a multiple of 16 (cin 3, 12, 48) is zero-padded in shared memory,
// never in device memory.

#pragma once

#include "conv3x3_core.cuh"

namespace uvt {

constexpr int kChunkC = 32;  // input channels staged per pass
constexpr int kMaxNF = 8;    // N fragments per block: 128 output channels

// Shared-memory plan for a layer of cin input channels and NF N fragments.
// Every region starts on a 32-byte boundary, as WMMA loads require.
struct PlainPlan {
  int kc;          // channels per chunk: min(cin, kChunkC) rounded up to 16
  int cps;         // channel stride of the window: kc + 16 (shifts banks)
  int np;          // output channels per block: NF * 16
  size_t in_bytes;
  size_t w_bytes;  // the chunk's weights for all 9 taps: (9, kc, np)
  size_t total;
};

__host__ __device__ inline PlainPlan plain_plan(int cin, int nf) {
  PlainPlan p;
  p.kc = cin < kChunkC ? round16(cin) : kChunkC;
  p.cps = p.kc + 16;
  p.np = nf * 16;
  p.in_bytes = (size_t)kHaloH * kHaloW * p.cps * sizeof(__nv_bfloat16);
  p.w_bytes = (size_t)9 * p.kc * p.np * sizeof(__nv_bfloat16);
  // the epilogue's per-warp f32 stage reuses the window's bytes
  const size_t stage = (size_t)kWarps * 16 * 16 * sizeof(float);
  p.total = (p.in_bytes > stage ? p.in_bytes : stage) + p.w_bytes;
  return p;
}

// Stage input channels c0 .. c0+cw-1 of the window whose output origin is
// (y0, x0): frame rows y0-1 .. y0+16, cols x0-1 .. x0+16.  Pixels outside
// the frame and channels cw .. cwp-1 are written as zero.
__device__ inline void load_window(__nv_bfloat16* in_s,
                                   const __nv_bfloat16* __restrict__ src,
                                   int n, int h, int w, int cin, int c0,
                                   int cw, int cwp, const PlainPlan& p,
                                   int y0, int x0) {
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.0f);
  const size_t frame = (size_t)n * h * w;
  if ((cin & 7) == 0) {
    const int vecs = cw >> 3;  // 16-byte vectors of 8 channels
    const int total = kHaloH * kHaloW * vecs;
    for (int i = threadIdx.x; i < total; i += kThreads) {
      const int pix = i / vecs;
      const int v = i - pix * vecs;
      const int r = pix / kHaloW;
      const int c = pix - r * kHaloW;
      const int gy = y0 - 1 + r;
      const int gx = x0 - 1 + c;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (gy >= 0 && gy < h && gx >= 0 && gx < w) {
        val = *reinterpret_cast<const uint4*>(
            src + (frame + (size_t)gy * w + gx) * cin + c0 + v * 8);
      }
      *reinterpret_cast<uint4*>(in_s + pix * p.cps + v * 8) = val;
    }
    const int pad = cwp - cw;
    if (pad > 0) {
      for (int i = threadIdx.x; i < kHaloH * kHaloW * pad; i += kThreads) {
        const int pix = i / pad;
        in_s[pix * p.cps + cw + (i - pix * pad)] = zero;
      }
    }
  } else {
    const int total = kHaloH * kHaloW * cwp;
    for (int i = threadIdx.x; i < total; i += kThreads) {
      const int pix = i / cwp;
      const int ch = i - pix * cwp;
      const int r = pix / kHaloW;
      const int c = pix - r * kHaloW;
      const int gy = y0 - 1 + r;
      const int gx = x0 - 1 + c;
      __nv_bfloat16 val = zero;
      if (ch < cw && gy >= 0 && gy < h && gx >= 0 && gx < w) {
        val = src[(frame + (size_t)gy * w + gx) * cin + c0 + ch];
      }
      in_s[pix * p.cps + ch] = val;
    }
  }
}

// Stage the chunk's weights: for each tap, rows tap*cin + c0 .. +cw-1 of
// the (9*cin, cout) matrix, columns n0 .. n0+np-1, as w_s[tap][c][k]
// zero-padded to (cwp, np).
__device__ inline void load_weights(__nv_bfloat16* w_s,
                                    const __nv_bfloat16* __restrict__ wmat,
                                    int cin, int cout, int c0, int cw,
                                    int cwp, int n0, const PlainPlan& p) {
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.0f);
  if ((cout & 7) == 0) {
    const int kv = p.np >> 3;
    const int total = 9 * cwp * kv;
    for (int i = threadIdx.x; i < total; i += kThreads) {
      const int row = i / kv;  // tap * cwp + c
      const int k = (i - row * kv) * 8;
      const int tap = row / cwp;
      const int c = row - tap * cwp;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (c < cw && n0 + k < cout) {
        val = *reinterpret_cast<const uint4*>(
            wmat + (size_t)(tap * cin + c0 + c) * cout + n0 + k);
      }
      *reinterpret_cast<uint4*>(w_s + row * p.np + k) = val;
    }
  } else {
    const int total = 9 * cwp * p.np;
    for (int i = threadIdx.x; i < total; i += kThreads) {
      const int row = i / p.np;
      const int k = i - row * p.np;
      const int tap = row / cwp;
      const int c = row - tap * cwp;
      w_s[i] = (c < cw && n0 + k < cout)
                   ? wmat[(size_t)(tap * cin + c0 + c) * cout + n0 + k]
                   : zero;
    }
  }
}

// The block's implicit GEMM over all chunks.  On return acc[m][f] holds,
// for output row y0 + warp*2 + m, pixels x0 .. x0+15 (fragment rows) by
// output channels n0 + f*16 .. +15 (fragment cols), before bias and
// activation.  The caller synchronises before reusing shared memory.
template <int NF>
__device__ inline void conv_tile_plain(AccFrag (&acc)[2][NF],
                                       unsigned char* smem,
                                       const __nv_bfloat16* __restrict__ src,
                                       const __nv_bfloat16* __restrict__ wmat,
                                       int n, int h, int w, int cin, int cout,
                                       int n0, int y0, int x0,
                                       const PlainPlan& p, int warp) {
  __nv_bfloat16* in_s = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* w_s = reinterpret_cast<__nv_bfloat16*>(
      smem + (p.total - p.w_bytes));
#pragma unroll
  for (int m = 0; m < 2; ++m) {
#pragma unroll
    for (int f = 0; f < NF; ++f) wmma::fill_fragment(acc[m][f], 0.0f);
  }
  for (int c0 = 0; c0 < cin; c0 += p.kc) {
    const int cw = min(p.kc, cin - c0);
    const int cwp = round16(cw);
    __syncthreads();  // the previous chunk's window and weights consumed
    load_window(in_s, src, n, h, w, cin, c0, cw, cwp, p, y0, x0);
    load_weights(w_s, wmat, cin, cout, c0, cw, cwp, n0, p);
    __syncthreads();
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3;
      const int dx = tap - dy * 3;
      for (int k0 = 0; k0 < cwp; k0 += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> a[2];
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          const int row = warp * 2 + m + dy;
          wmma::load_matrix_sync(
              a[m], in_s + (row * kHaloW + dx) * p.cps + k0, p.cps);
        }
#pragma unroll
        for (int f = 0; f < NF; ++f) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                         wmma::row_major> b;
          wmma::load_matrix_sync(b, w_s + (tap * cwp + k0) * p.np + f * 16,
                                 p.np);
          wmma::mma_sync(acc[0][f], a[0], b, acc[0][f]);
          wmma::mma_sync(acc[1][f], a[1], b, acc[1][f]);
        }
      }
    }
  }
}

}  // namespace uvt
