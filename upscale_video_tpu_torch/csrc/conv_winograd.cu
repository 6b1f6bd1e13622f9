// K7: one layer of the row-wise Winograd F(2,3) conv chain, for Hopper (sm_90a).
//
// Replaces upscale_video_tpu/ops/conv_winograd.py:_wino_kernel (reached via
// _wino_step / winograd_chain).  Same arithmetic: per output-row pair
// (2i, 2i+1) the input rows d0..d3 (frame rows 2i-1 .. 2i+2) combine in bf16
// into V0 = d0-d2, V1 = d1+d2, V2 = d2-d1, V3 = d1-d3 (each difference taken
// in f32 and rounded once to bf16, as the JAX kernel's bf16 window
// arithmetic rounds); four products M_a = V_a (x) U_a over the three column
// taps, bf16 x bf16 accumulated in f32; then in f32
//     y_even = ((bias + M0) + M1) + M2,   y_odd = ((bias + M1) - M2) - M3,
// the activation, and ONE rounding to bf16 (__float2bfloat16_rn).  The
// 64 -> 64 layers run on conv_winograd_sm90.cu instead; the wrapper picks
// by shape (ops/conv_winograd.py:sm90_takes).
//
// Layout: K1's bordered bf16 NHWC buffers (conv3x3_core.cuh): reads src
// (N, H+2, W+2, cin), writes only the interior of dst (N, H+2, W+2, cout),
// whose zero ring is never written.  The 18 x 18 haloed tile is staged with
// K1's load_halo; an odd H's last pair reads buffer row H+2, past the
// buffer, which load_halo's gy < hp predicate stages as zero (it feeds only
// the dropped odd row).
//
// Block: 16 x 16 output pixels, 8 warps, each warp one output-row pair.  Per
// (column tap dx, 16-channel chunk) a warp loads the four row fragments
// d0..d3 of its pair, forms V0..V3 element-wise in registers (fragments of
// one type share their element mapping), and per 16-wide N fragment issues
// four MMAs, one into each of FOUR accumulator sets M0..M3: 4 MMAs per
// (dx, chunk, N fragment) against K1's 6 (3 row taps x 2 rows), the 1.5x
// saving.  Two signed sets (y_even, y_odd) would multiply M1 and M2 twice
// and lose it.  Four sets at 4 N fragments are 16 f32 fragments (128
// registers), so a block covers at most 64 output channels and wider cout
// splits over grid z (as K4 does).  U_a for one dx (4 x cin x 64 bf16)
// streams through shared memory per dx.
//
// What bounds it on the H100: a 64 -> 64 layer does 12 * 64 * 64 = 49,152
// FLOP per output pixel against 256 bytes of activation traffic (128 read,
// 128 written), 192 FLOP/byte, under the bf16 ridge (~295): at full speed
// one layer over 4x1080p would be bound by its HBM bytes (~0.63 ms) before
// its operations (~0.41 ms).  This first version is far from both: WMMA
// with two block-wide barriers per dx, scalar weight staging, one block per
// SM (the four accumulator sets), no TMA/wgmma pipeline.

#include "conv3x3_core.cuh"

namespace uvt {

constexpr int kWinoCols = 64;  // output channels per block (4 N fragments)

constexpr int kWinoActNone = 0;
constexpr int kWinoActPrelu = 1;
constexpr int kWinoActLeaky = 2;
constexpr int kWinoActRelu = 3;

struct WinoPlan {
  SmemPlan halo;     // cpw / cps / in_bytes of the 18 x 18 x cin tile
  size_t u_bytes;    // 4 x cpw x 64 bf16: U_a rows of one dx
  size_t stage_bytes;
  size_t total;
};

__host__ __device__ inline WinoPlan wino_plan(int cin) {
  WinoPlan p;
  p.halo = smem_plan(cin, kWinoCols);
  p.u_bytes = (size_t)4 * p.halo.cpw * kWinoCols * sizeof(__nv_bfloat16);
  p.stage_bytes = (size_t)kWarps * 4 * 16 * 16 * sizeof(float);
  p.total = p.halo.in_bytes + p.u_bytes + p.stage_bytes;
  return p;
}

__device__ inline __nv_bfloat16 bf16_sub(__nv_bfloat16 a, __nv_bfloat16 b) {
  return __float2bfloat16_rn(__bfloat162float(a) - __bfloat162float(b));
}

__device__ inline __nv_bfloat16 bf16_add(__nv_bfloat16 a, __nv_bfloat16 b) {
  return __float2bfloat16_rn(__bfloat162float(a) + __bfloat162float(b));
}

__device__ inline float wino_act(float y, int act, float slope) {
  if (act == kWinoActRelu) return fmaxf(y, 0.0f);
  if (act == kWinoActPrelu || act == kWinoActLeaky) {
    return y >= 0.0f ? y : y * slope;
  }
  return y;
}

using AFrag = wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                             wmma::row_major>;
using BFrag = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                             wmma::row_major>;

template <int NF>
__global__ void __launch_bounds__(kThreads)
wino_layer_kernel(const __nv_bfloat16* __restrict__ src,
                  __nv_bfloat16* __restrict__ dst,
                  const __nv_bfloat16* __restrict__ umat,
                  const float* __restrict__ bias,
                  const float* __restrict__ slope,
                  int h, int w, int cin, int cout, int act, int splits) {
  extern __shared__ __align__(128) unsigned char smem[];
  const WinoPlan p = wino_plan(cin);
  const int cpw = p.halo.cpw;
  const int cps = p.halo.cps;
  constexpr int np = NF * 16;
  __nv_bfloat16* in_s = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* u_s =
      reinterpret_cast<__nv_bfloat16*>(smem + p.halo.in_bytes);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* stage = reinterpret_cast<float*>(smem + p.halo.in_bytes + p.u_bytes) +
                 warp * 4 * 256;

  const int n = blockIdx.z / splits;
  const int k_base = (blockIdx.z - n * splits) * kWinoCols;
  const int cols = min(kWinoCols, cout - k_base);
  const int y0 = blockIdx.y * kTileH;
  const int x0 = blockIdx.x * kTileW;
  const int hp = h + 2;
  const int wp = w + 2;

  load_halo(in_s, src, n, hp, wp, cin, p.halo, y0, x0);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][NF];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
#pragma unroll
    for (int f = 0; f < NF; ++f) wmma::fill_fragment(acc[a][f], 0.0f);
  }

  const __nv_bfloat16 zero = __float2bfloat16_rn(0.0f);
  for (int dx = 0; dx < 3; ++dx) {
    __syncthreads();  // halo staged / previous dx's U consumed
    // U_a rows dx*cin .. dx*cin+cin-1, columns k_base .. k_base+np-1 of the
    // (4, 3*cin, cout) matrix, zero-padded to (4, cpw, np)
    for (int i = threadIdx.x; i < 4 * cpw * np; i += kThreads) {
      const int k = i % np;
      const int ac = i / np;
      const int c = ac % cpw;
      const int a = ac / cpw;
      u_s[i] = (c < cin && k < cols)
                   ? umat[((size_t)a * 3 * cin + dx * cin + c) * cout +
                          k_base + k]
                   : zero;
    }
    __syncthreads();
    for (int c0 = 0; c0 < cpw; c0 += 16) {
      // halo rows 2*warp .. 2*warp+3 are the pair's d0..d3 (buffer rows
      // y0+2*warp .. y0+2*warp+3 = frame rows 2i-1 .. 2i+2)
      AFrag d[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        wmma::load_matrix_sync(
            d[r], in_s + ((warp * 2 + r) * kHaloW + dx) * cps + c0, cps);
      }
      AFrag v[4];
#pragma unroll
      for (int i = 0; i < d[0].num_elements; ++i) {
        v[0].x[i] = bf16_sub(d[0].x[i], d[2].x[i]);
        v[1].x[i] = bf16_add(d[1].x[i], d[2].x[i]);
        v[2].x[i] = bf16_sub(d[2].x[i], d[1].x[i]);
        v[3].x[i] = bf16_sub(d[1].x[i], d[3].x[i]);
      }
#pragma unroll
      for (int f = 0; f < NF; ++f) {
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          BFrag b;
          wmma::load_matrix_sync(b, u_s + (a * cpw + c0) * np + f * 16, np);
          wmma::mma_sync(acc[a][f], v[a], b, acc[a][f]);
        }
      }
    }
  }

  // epilogue: the four fragments of one N fragment go through the warp's
  // 4 x 16 x 16 f32 stage; lane owns pixel (lane / 2) and 8 consecutive
  // channels of it, for both rows of the pair
  const int px = lane >> 1;
  const int t0 = (lane & 1) * 8;
  const int oy0 = y0 + warp * 2;
  const int ox = x0 + px;
#pragma unroll
  for (int f = 0; f < NF; ++f) {
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      wmma::store_matrix_sync(stage + a * 256, acc[a][f], 16,
                              wmma::mem_row_major);
    }
    __syncwarp();
    const int kl = f * 16 + t0;  // channel within the block's columns
    if (ox < w && kl < cols) {
      float ve[8], vo[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int k = k_base + kl + j;
        float ye = 0.0f, yo = 0.0f;
        if (kl + j < cols) {
          const int s = px * 16 + t0 + j;
          const float m0 = stage[s], m1 = stage[256 + s];
          const float m2 = stage[512 + s], m3 = stage[768 + s];
          const float b = bias[k];
          ye = __fadd_rn(__fadd_rn(__fadd_rn(b, m0), m1), m2);
          yo = __fsub_rn(__fsub_rn(__fadd_rn(b, m1), m2), m3);
          ye = wino_act(ye, act, slope[k]);
          yo = wino_act(yo, act, slope[k]);
        }
        ve[j] = ye;
        vo[j] = yo;
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int oy = oy0 + r;
        if (oy >= h) continue;
        const float* v = r ? vo : ve;
        __nv_bfloat16* o = dst + (((size_t)n * hp + oy + 1) * wp + ox + 1) *
                                     cout + k_base + kl;
        if ((cout & 7) == 0) {
          __align__(16) __nv_bfloat16 pack[8];
#pragma unroll
          for (int j = 0; j < 8; ++j) pack[j] = __float2bfloat16_rn(v[j]);
          *reinterpret_cast<uint4*>(o) = *reinterpret_cast<uint4*>(pack);
        } else {
          for (int j = 0; j < 8 && kl + j < cols; ++j) {
            o[j] = __float2bfloat16_rn(v[j]);
          }
        }
      }
    }
    __syncwarp();
  }
}

template <int NF>
static int launch_wino_layer(const void* src, void* dst, const void* umat,
                             const void* bias, const void* slope, int n,
                             int h, int w, int cin, int cout, int act,
                             cudaStream_t stream) {
  const WinoPlan p = wino_plan(cin);
  cudaError_t err = cudaFuncSetAttribute(
      wino_layer_kernel<NF>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)p.total);
  if (err != cudaSuccess) return (int)err;
  const int splits = (cout + kWinoCols - 1) / kWinoCols;
  const dim3 grid((w + kTileW - 1) / kTileW, (h + kTileH - 1) / kTileH,
                  n * splits);
  wino_layer_kernel<NF><<<grid, kThreads, p.total, stream>>>(
      static_cast<const __nv_bfloat16*>(src), static_cast<__nv_bfloat16*>(dst),
      static_cast<const __nv_bfloat16*>(umat), static_cast<const float*>(bias),
      static_cast<const float*>(slope), h, w, cin, cout, act, splits);
  return (int)cudaGetLastError();
}

}  // namespace uvt

extern "C" {

// One Winograd chain layer.  Pointers: src (N, h+2, w+2, cin) bf16, dst (N,
// h+2, w+2, cout) bf16 with a zero ring, umat (4, 3*cin, cout) bf16 in (a,
// dx, cin) row order, bias and slope (cout,) f32.  Returns a cudaError_t.
int uvt_conv_winograd_layer(const void* src, void* dst, const void* umat,
                            const void* bias, const void* slope, int n,
                            int h, int w, int cin, int cout, int act,
                            void* stream) {
  const int splits = (cout + uvt::kWinoCols - 1) / uvt::kWinoCols;
  if (n < 1 || h < 1 || w < 1 || cin < 1 || cin > 128 || cout < 1 ||
      cout > 128 || n * splits > 65535 ||
      (h + uvt::kTileH - 1) / uvt::kTileH > 65535 ||
      act < uvt::kWinoActNone || act > uvt::kWinoActRelu) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // N fragments per block: the widest block's columns (all but the last
  // split hold 64)
  switch (((cout < uvt::kWinoCols ? cout : uvt::kWinoCols) + 15) / 16) {
    case 1: return uvt::launch_wino_layer<1>(src, dst, umat, bias, slope, n, h, w, cin, cout, act, s);
    case 2: return uvt::launch_wino_layer<2>(src, dst, umat, bias, slope, n, h, w, cin, cout, act, s);
    case 3: return uvt::launch_wino_layer<3>(src, dst, umat, bias, slope, n, h, w, cin, cout, act, s);
    default: return uvt::launch_wino_layer<4>(src, dst, umat, bias, slope, n, h, w, cin, cout, act, s);
  }
}

}  // extern "C"
