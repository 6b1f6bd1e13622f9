// Shared core of the port's two 3x3 conv kernels (conv3x3_chain.cu, sr_tail.cu).
//
// Layout contract: activations live in a *bordered* bf16 NHWC buffer
// (N, H+2, W+2, C) whose one-pixel ring is zero and is never written; a
// SAME 3x3 conv of output pixel (y, x) reads buffer rows y..y+2 and columns
// x..x+2, so no pad, crop or mask pass runs between layers.  This is the
// port of the JAX chain's zero ring (upscale_video_tpu/ops/conv_chain.py),
// at pixel granularity and at the layer's real channel count: the TPU's
// 128-lane padding and tile-granular ring were Mosaic constraints.
//
// Implicit GEMM per block: M = 16x16 output pixels of one frame, N = cout
// (<= 128, in 16-wide WMMA fragments), K = 9 taps x cin.  The haloed input
// tile (18 x 18 x cin) is staged in shared memory once; the weights stream
// through shared memory one tap (cin x cout) at a time.  Eight warps each
// own two output rows (two 16-pixel A fragments) and every N fragment, so
// the A fragments are reused across N and B across the two rows.  Products
// are bf16 x bf16 on the tensor cores (WMMA m16n16k16), accumulated in f32.
//
// What bounds it on the H100: a main-path layer (64 -> 64 channels) does
// 73,728 FLOP per output pixel against 256 bytes of activation traffic
// (128 read, 128 written): 288 FLOP/byte, right at the bf16 ridge (~295),
// so at full speed one layer over 4x1080p would take ~10 ms by either
// bound.  This first version is far from both: it reaches the tensor cores
// through WMMA with two block-wide barriers per tap and scalar weight
// staging, not through wgmma/TMA pipelines (later work).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace uvt {

namespace wmma = nvcuda::wmma;

constexpr int kTileH = 16;              // output rows per block
constexpr int kTileW = 16;              // output cols per block (= WMMA M)
constexpr int kWarps = kTileH / 2;      // each warp owns two output rows
constexpr int kThreads = kWarps * 32;
constexpr int kHaloH = kTileH + 2;
constexpr int kHaloW = kTileW + 2;

__host__ __device__ inline int round16(int v) { return (v + 15) & ~15; }

// Shared-memory plan for one (cin, cout) layer.  Every region starts on a
// 32-byte boundary, as WMMA loads and stores require.
struct SmemPlan {
  int cpw;       // K rows per tap: cin rounded up to 16 (zero rows past cin)
  int cps;       // channel stride of the halo tile: cpw + 16 (shifts banks,
                 // keeps 32-byte alignment)
  int np;        // cout rounded up to 16 (zero columns past cout)
  size_t in_bytes;
  size_t w_bytes;
  size_t stage_bytes;
  size_t total;
};

__host__ __device__ inline SmemPlan smem_plan(int cin, int cout) {
  SmemPlan p;
  p.cpw = round16(cin);
  p.cps = p.cpw + 16;
  p.np = round16(cout);
  p.in_bytes = (size_t)kHaloH * kHaloW * p.cps * sizeof(__nv_bfloat16);
  p.w_bytes = (size_t)p.cpw * p.np * sizeof(__nv_bfloat16);
  p.stage_bytes = (size_t)kWarps * 16 * 16 * sizeof(float);
  p.total = p.in_bytes + p.w_bytes + p.stage_bytes;
  return p;
}

// Stage the haloed input tile: buffer rows y0..y0+17, cols x0..x0+17 of
// frame n (buffer coordinates; output pixel (y0, x0) is the tile origin).
// Positions past the buffer and channels cin..cpw are written as zero, so
// every value the MMAs read is defined.
__device__ inline void load_halo(__nv_bfloat16* in_s,
                                 const __nv_bfloat16* __restrict__ src,
                                 int n, int hp, int wp, int cin,
                                 const SmemPlan& p, int y0, int x0) {
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.0f);
  const size_t frame = (size_t)n * hp * wp;
  if ((cin & 7) == 0) {
    const int vecs = cin >> 3;  // 16-byte vectors of 8 channels
    const int total = kHaloH * kHaloW * vecs;
    for (int i = threadIdx.x; i < total; i += kThreads) {
      const int pix = i / vecs;
      const int v = i - pix * vecs;
      const int r = pix / kHaloW;
      const int c = pix - r * kHaloW;
      const int gy = y0 + r;
      const int gx = x0 + c;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (gy < hp && gx < wp) {
        val = *reinterpret_cast<const uint4*>(
            src + (frame + (size_t)gy * wp + gx) * cin + (size_t)v * 8);
      }
      *reinterpret_cast<uint4*>(in_s + pix * p.cps + v * 8) = val;
    }
    const int pad = p.cpw - cin;
    if (pad > 0) {
      for (int i = threadIdx.x; i < kHaloH * kHaloW * pad; i += kThreads) {
        const int pix = i / pad;
        in_s[pix * p.cps + cin + (i - pix * pad)] = zero;
      }
    }
  } else {
    const int total = kHaloH * kHaloW * p.cpw;
    for (int i = threadIdx.x; i < total; i += kThreads) {
      const int pix = i / p.cpw;
      const int ch = i - pix * p.cpw;
      const int r = pix / kHaloW;
      const int c = pix - r * kHaloW;
      const int gy = y0 + r;
      const int gx = x0 + c;
      __nv_bfloat16 val = zero;
      if (ch < cin && gy < hp && gx < wp) {
        val = src[(frame + (size_t)gy * wp + gx) * cin + ch];
      }
      in_s[pix * p.cps + ch] = val;
    }
  }
}

// Stage one tap's weights: rows tap*cin .. tap*cin+cin-1 of the
// (9*cin, cout) matrix, zero-padded to (cpw, np).
__device__ inline void load_tap(__nv_bfloat16* w_s,
                                const __nv_bfloat16* __restrict__ wmat,
                                int tap, int cin, int cout,
                                const SmemPlan& p) {
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.0f);
  const int total = p.cpw * p.np;
  for (int i = threadIdx.x; i < total; i += kThreads) {
    const int c = i / p.np;
    const int k = i - c * p.np;
    w_s[i] = (c < cin && k < cout)
                 ? wmat[(size_t)(tap * cin + c) * cout + k]
                 : zero;
  }
}

using AccFrag = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// The block's implicit GEMM.  On return acc[m][f] holds, for output row
// (warp*2 + m) of the tile, pixels x0..x0+15 (fragment rows) by output
// channels f*16..f*16+15 (fragment cols), before bias and activation.
// The halo tile must already be staged; the caller synchronises before
// reading shared memory again.
template <int NF>
__device__ inline void conv_tile(AccFrag (&acc)[2][NF],
                                 const __nv_bfloat16* in_s,
                                 __nv_bfloat16* w_s,
                                 const __nv_bfloat16* __restrict__ wmat,
                                 int cin, int cout, const SmemPlan& p,
                                 int warp) {
#pragma unroll
  for (int m = 0; m < 2; ++m) {
#pragma unroll
    for (int f = 0; f < NF; ++f) wmma::fill_fragment(acc[m][f], 0.0f);
  }
  for (int tap = 0; tap < 9; ++tap) {
    __syncthreads();  // halo staged / previous tap's weights consumed
    load_tap(w_s, wmat, tap, cin, cout, p);
    __syncthreads();
    const int dy = tap / 3;
    const int dx = tap - dy * 3;
    for (int c0 = 0; c0 < p.cpw; c0 += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> a[2];
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const int row = warp * 2 + m + dy;
        wmma::load_matrix_sync(a[m], in_s + (row * kHaloW + dx) * p.cps + c0,
                               p.cps);
      }
#pragma unroll
      for (int f = 0; f < NF; ++f) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> b;
        wmma::load_matrix_sync(b, w_s + c0 * p.np + f * 16, p.np);
        wmma::mma_sync(acc[0][f], a[0], b, acc[0][f]);
        wmma::mma_sync(acc[1][f], a[1], b, acc[1][f]);
      }
    }
  }
}

}  // namespace uvt
