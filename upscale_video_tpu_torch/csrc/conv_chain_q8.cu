// K8: one layer of the int8 bordered SAME-3x3 conv chain, for Hopper (sm_90a).
//
// Replaces upscale_video_tpu/ops/conv_chain_q8.py:_q8_chain_kernel (reached
// via _q8_chain_step / conv3x3_chain_q8).  Same arithmetic: int8 x int8
// products summed exactly in int32 (|sum| <= 9 * 128 * 127^2 < 2^31), then
// an f32 epilogue written out so that nvcc contracts nothing into an FMA:
//     y = __fadd_rn(__fmul_rn(__int2float_rn(acc), scale[k]), bias[k]),
// the activation (none / per-channel PReLU / leaky with slope[0] / ReLU),
// and either the requantisation to the next layer's int8,
//     q = clamp(rintf(__fmul_rn(y, inv_out)), -127, 127)   (half to even),
// or, for the last layer, one rounding to bf16 (__float2bfloat16_rn).  The
// integer part is exact, so the kernel equals its plain version
// (ops/conv_chain_q8.py:conv3x3_chain_q8_plain) bit for bit.
//
// Layout: K1's bordered NHWC layout in int8: src (N, H+2, W+2, cin) int8
// with a zero ring (zero-point 0 makes the ring exact conv padding); dst the
// interior of (N, H+2, W+2, cout), int8 (requant) or bf16 (last layer),
// whose zero ring is never written.
//
// Block: K1's tile, 16 x 16 output pixels, 8 warps, each warp two output
// rows.  The haloed 18 x 18 x cin int8 tile and all nine taps' weights
// (transposed to (tap, cout, cin), so a B fragment's four K values are one
// 32-bit word) are staged in shared memory once, behind one barrier.  The
// products are mma.sync.m16n8k32 s8 x s8 -> s32 on the tensor cores, with
// fragments loaded as 32-bit words: the channel strides are padded to
// cpw + 16 bytes (cpw = cin rounded up to the 32-wide K step, cin 3 padded
// with zeros), which keeps every fragment load free of bank conflicts.  The
// epilogue works on the accumulator registers directly (the m16n8 C layout
// is fixed by PTX), so no stage goes through shared memory.
//
// What bounds it on the H100: a 64 -> 64 layer does 73,728 int8 operations
// per output pixel against 128 bytes of activation traffic (64 read, 64
// written), 576 operations per byte, right at the int8 ridge (1,979 TOP/s
// over 3.35 TB/s, ~590): at full speed one layer over 4x1080p would take
// ~0.31 ms by either bound, half of the bf16 layer's.  This first version
// is far from both: mma.sync without a load pipeline, one block-wide tile
// per 256 output pixels, scattered 2-byte epilogue stores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace uvt_q8 {

constexpr int kTileH = 16;
constexpr int kTileW = 16;
constexpr int kWarps = kTileH / 2;  // each warp owns two output rows
constexpr int kThreads = kWarps * 32;
constexpr int kHaloH = kTileH + 2;
constexpr int kHaloW = kTileW + 2;

constexpr int kActNone = 0;
constexpr int kActPrelu = 1;
constexpr int kActLeaky = 2;
constexpr int kActRelu = 3;

struct Q8Plan {
  int cpw;  // K values per tap: cin rounded up to 32 (zeros past cin)
  int cps;  // byte stride of a halo pixel and of a weight row: cpw + 16
  int np;   // output channels staged: NF * 8
  size_t in_bytes;
  size_t w_bytes;
  size_t total;
};

__host__ __device__ inline Q8Plan q8_plan(int cin, int nf) {
  Q8Plan p;
  p.cpw = (cin + 31) & ~31;
  p.cps = p.cpw + 16;
  p.np = nf * 8;
  p.in_bytes = (size_t)kHaloH * kHaloW * p.cps;
  p.w_bytes = (size_t)9 * p.np * p.cps;
  p.total = p.in_bytes + p.w_bytes;
  return p;
}

__device__ inline void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                              uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ inline float epilogue(int acc, int k, const float* __restrict__ scale,
                                 const float* __restrict__ bias,
                                 const float* __restrict__ slope, int act) {
  float y = __fadd_rn(__fmul_rn(__int2float_rn(acc), scale[k]), bias[k]);
  if (act == kActRelu) {
    y = fmaxf(y, 0.0f);
  } else if (act == kActPrelu) {
    y = y >= 0.0f ? y : __fmul_rn(y, slope[k]);
  } else if (act == kActLeaky) {
    y = y >= 0.0f ? y : __fmul_rn(y, slope[0]);
  }
  return y;
}

__device__ inline signed char requant(float y, float inv_out) {
  float q = rintf(__fmul_rn(y, inv_out));
  q = fminf(fmaxf(q, -127.0f), 127.0f);
  return (signed char)__float2int_rn(q);
}

template <int NF>
__global__ void __launch_bounds__(kThreads)
q8_layer_kernel(const int8_t* __restrict__ src, void* __restrict__ dst,
                const int8_t* __restrict__ wmat,
                const float* __restrict__ scale,
                const float* __restrict__ bias,
                const float* __restrict__ slope, float inv_out,
                int h, int w, int cin, int cout, int act, int to_int8) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Q8Plan p = q8_plan(cin, NF);
  int8_t* in_s = reinterpret_cast<int8_t*>(smem);
  int8_t* w_s = reinterpret_cast<int8_t*>(smem + p.in_bytes);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;   // fragment row group
  const int t = lane & 3;    // thread in group

  const int n = blockIdx.z;
  const int y0 = blockIdx.y * kTileH;
  const int x0 = blockIdx.x * kTileW;
  const int hp = h + 2;
  const int wp = w + 2;
  const size_t frame = (size_t)n * hp * wp;

  // haloed tile: buffer rows y0..y0+17, cols x0..x0+17; positions past the
  // buffer and channels cin..cpw are zero
  if ((cin & 15) == 0) {
    const int vecs = cin >> 4;  // 16-byte vectors of 16 channels
    for (int i = threadIdx.x; i < kHaloH * kHaloW * vecs; i += kThreads) {
      const int pix = i / vecs;
      const int v = i - pix * vecs;
      const int r = pix / kHaloW;
      const int c = pix - r * kHaloW;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (y0 + r < hp && x0 + c < wp) {
        val = *reinterpret_cast<const uint4*>(
            src + (frame + (size_t)(y0 + r) * wp + x0 + c) * cin + v * 16);
      }
      *reinterpret_cast<uint4*>(in_s + pix * p.cps + v * 16) = val;
    }
    const int pad = p.cpw - cin;
    for (int i = threadIdx.x; i < kHaloH * kHaloW * pad; i += kThreads) {
      const int pix = i / pad;
      in_s[pix * p.cps + cin + (i - pix * pad)] = 0;
    }
  } else {
    for (int i = threadIdx.x; i < kHaloH * kHaloW * p.cpw; i += kThreads) {
      const int pix = i / p.cpw;
      const int ch = i - pix * p.cpw;
      const int r = pix / kHaloW;
      const int c = pix - r * kHaloW;
      int8_t val = 0;
      if (ch < cin && y0 + r < hp && x0 + c < wp) {
        val = src[(frame + (size_t)(y0 + r) * wp + x0 + c) * cin + ch];
      }
      in_s[pix * p.cps + ch] = val;
    }
  }
  // all nine taps' weights, (tap, cout, cin)-major, zero-padded to
  // (9, np, cpw); global reads run along cout
  for (int i = threadIdx.x; i < 9 * p.cpw * p.np; i += kThreads) {
    const int k = i % p.np;
    const int tc = i / p.np;
    const int c = tc % p.cpw;
    const int tap = tc / p.cpw;
    w_s[(tap * p.np + k) * p.cps + c] =
        (c < cin && k < cout) ? wmat[((size_t)tap * cin + c) * cout + k]
                              : (int8_t)0;
  }
  __syncthreads();

  int acc[2][NF][4];
#pragma unroll
  for (int m = 0; m < 2; ++m) {
#pragma unroll
    for (int j = 0; j < NF; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][j][e] = 0;
    }
  }
  for (int tap = 0; tap < 9; ++tap) {
    const int dy = tap / 3;
    const int dx = tap - dy * 3;
    for (int c0 = 0; c0 < p.cpw; c0 += 32) {
      // A: 16 pixels (halo cols dx..dx+15 of the row) x 32 channels
      uint32_t a[2][4];
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const int8_t* base =
            in_s + ((warp * 2 + m + dy) * kHaloW + dx) * p.cps + c0 + t * 4;
        a[m][0] = *reinterpret_cast<const uint32_t*>(base + g * p.cps);
        a[m][1] = *reinterpret_cast<const uint32_t*>(base + (g + 8) * p.cps);
        a[m][2] = *reinterpret_cast<const uint32_t*>(base + g * p.cps + 16);
        a[m][3] =
            *reinterpret_cast<const uint32_t*>(base + (g + 8) * p.cps + 16);
      }
#pragma unroll
      for (int j = 0; j < NF; ++j) {
        // B: 32 channels x 8 output channels, column g's K values in a row
        const int8_t* bb = w_s + (tap * p.np + j * 8 + g) * p.cps + c0 + t * 4;
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(bb);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(bb + 16);
        mma_s8(acc[0][j], a[0], b0, b1);
        mma_s8(acc[1][j], a[1], b0, b1);
      }
    }
  }

  // epilogue from the accumulators: element e of fragment (m, j) is pixel
  // g + 8 * (e >> 1) of output row warp*2 + m, channel j*8 + t*2 + (e & 1)
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    const int oy = y0 + warp * 2 + m;
    if (oy >= h) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int ox = x0 + g + half * 8;
      if (ox >= w) continue;
      const size_t pix = frame + (size_t)(oy + 1) * wp + ox + 1;
#pragma unroll
      for (int j = 0; j < NF; ++j) {
        const int k = j * 8 + t * 2;
        if (k >= cout) continue;
        const bool pair = k + 1 < cout;
        const float f0 =
            epilogue(acc[m][j][half * 2], k, scale, bias, slope, act);
        const float f1 = pair ? epilogue(acc[m][j][half * 2 + 1], k + 1,
                                         scale, bias, slope, act)
                              : 0.0f;
        if (to_int8) {
          int8_t* o = static_cast<int8_t*>(dst) + pix * cout + k;
          const signed char q0 = requant(f0, inv_out);
          if (pair && (cout & 1) == 0) {
            char2 v;
            v.x = q0;
            v.y = requant(f1, inv_out);
            *reinterpret_cast<char2*>(o) = v;
          } else {
            o[0] = q0;
            if (pair) o[1] = requant(f1, inv_out);
          }
        } else {
          __nv_bfloat16* o = static_cast<__nv_bfloat16*>(dst) + pix * cout + k;
          if (pair && (cout & 1) == 0) {
            *reinterpret_cast<__nv_bfloat162*>(o) =
                __floats2bfloat162_rn(f0, f1);
          } else {
            o[0] = __float2bfloat16_rn(f0);
            if (pair) o[1] = __float2bfloat16_rn(f1);
          }
        }
      }
    }
  }
}

template <int NF>
static int launch_q8_layer(const void* src, void* dst, const void* wmat,
                           const void* scale, const void* bias,
                           const void* slope, float inv_out, int n, int h,
                           int w, int cin, int cout, int act, int to_int8,
                           cudaStream_t stream) {
  const Q8Plan p = q8_plan(cin, NF);
  cudaError_t err = cudaFuncSetAttribute(
      q8_layer_kernel<NF>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)p.total);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((w + kTileW - 1) / kTileW, (h + kTileH - 1) / kTileH, n);
  q8_layer_kernel<NF><<<grid, kThreads, p.total, stream>>>(
      static_cast<const int8_t*>(src), dst, static_cast<const int8_t*>(wmat),
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<const float*>(slope), inv_out, h, w, cin, cout, act,
      to_int8);
  return (int)cudaGetLastError();
}

}  // namespace uvt_q8

extern "C" {

// One int8 chain layer.  Pointers: src (N, h+2, w+2, cin) int8, dst (N,
// h+2, w+2, cout) int8 (to_int8 != 0) or bf16 with a zero ring, wmat
// (9*cin, cout) int8 in (dy, dx, cin) row order, scale, bias and slope
// (cout,) f32; inv_out is 1/s of the int8 output.  Returns a cudaError_t.
int uvt_conv3x3_chain_q8_layer(const void* src, void* dst, const void* wmat,
                               const void* scale, const void* bias,
                               const void* slope, float inv_out, int n,
                               int h, int w, int cin, int cout, int act,
                               int to_int8, void* stream) {
  using namespace uvt_q8;
  if (n < 1 || h < 1 || w < 1 || cin < 1 || cin > 128 || cout < 1 ||
      cout > 128 || n > 65535 || (h + kTileH - 1) / kTileH > 65535 ||
      act < kActNone || act > kActRelu) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define UVT_Q8_CASE(NF)                                                    \
  case NF:                                                                 \
    return launch_q8_layer<NF>(src, dst, wmat, scale, bias, slope, inv_out, \
                               n, h, w, cin, cout, act, to_int8, s);
  // N fragments of 8: cout rounded up to 16
  switch (((cout + 15) / 16) * 2) {
    UVT_Q8_CASE(2)
    UVT_Q8_CASE(4)
    UVT_Q8_CASE(6)
    UVT_Q8_CASE(8)
    UVT_Q8_CASE(10)
    UVT_Q8_CASE(12)
    UVT_Q8_CASE(14)
    default: return launch_q8_layer<16>(src, dst, wmat, scale, bias, slope,
                                        inv_out, n, h, w, cin, cout, act,
                                        to_int8, s);
  }
#undef UVT_Q8_CASE
}

}  // extern "C"
