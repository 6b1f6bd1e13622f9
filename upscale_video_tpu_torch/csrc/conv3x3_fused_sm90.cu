// K4 on Hopper: one SAME 3x3 conv + bias + activation over plain NHWC as a
// persistent, warp-specialised wgmma kernel (sm_90a), reading and writing
// channel slices of wider buffers.
//
// Replaces upscale_video_tpu/ops/conv_pallas.py:56 (_kernel, reached via
// conv3x3_fused :116 and conv3x3_fused_batch :187) for bf16 output with cin
// a multiple of 32 in 32..192 and cout a multiple of 16 in 16..256: ESRGAN's
// five dense convs, conv_body and conv_up1, the -m r trunk and up1 convs and
// a wide SRVGG's 160 -> 160 body.  Every other shape (the 3- and 12-channel
// heads) and f32 output stay on conv3x3_fused.cu (WMMA); the wrapper picks
// by shape (ops/conv3x3.py:sm90_takes).  Same arithmetic as that kernel:
// bf16 x bf16 products summed in f32, + f32 bias, activation (none /
// per-channel PReLU / leaky with one slope / ReLU) in f32, one rounding to
// bf16 (__float2bfloat16_rn).  The f32 sum runs in another order, so a value
// may differ by one bf16 ulp.
//
// Channel slices: x holds channels [0, cin) of an NHWC buffer whose pixel
// stride is c_in_total >= cin channels; the output's cout channels go to
// channels [out_off, out_off + cout) of an NHWC buffer whose pixel stride is
// c_out_total, with 16-byte stores that touch no other channel.  An ESRGAN
// dense block so runs its five convs on one 192-channel buffer, each conv
// appending its 32 channels behind the ones it read, and no torch.cat is
// made (models/executor.py:_plan_dense_buffers).
//
// Bound on the H100: 64 -> 32 .. 160 -> 32 do 9*cin*32 MACs per pixel
// against 2*(cin + 32) bytes (192-216 FLOP/byte, under the bf16 ridge of
// ~295), so bytes bound them; 192 -> 64 (864 FLOP/byte), 64 -> 64 and
// 160 -> 160 are bound by operations.
//
// Design: the persistent TMA-halo mainloop of conv3x3_halo_sm90.cuh
// (shared with K3's Hopper kernel, sr_tail_sm90.cu), with two consumer
// warpgroups: the SAME border by TMA zero fill (a box starting at
// (x0 - 1, y0 - 1)), 64-channel swizzled slices (a last slice of 32
// channels issues only its valid k steps), a row-split halo double buffer
// per consumer, resident weights in cout chunks that fit: N = 32 where
// cout is a multiple of 32, else 16; 192 -> 64 runs as two 32-wide chunks
// (110,592 B of weights each) and 160 -> 160 as five.  Streaming the
// 221,184 B of 192 -> 64 per tile instead would cost ~3.9 TB/s of L2 reads
// at the tensor-core rate; a chunk's blocks reread the halo instead.  kR
// is the largest of 8, 6, 4 whose accumulators and four parts fit.
// This file holds the layer's epilogue, in registers: bias and activation
// in f32 on the accumulators, one rounding; a 4 x 4 word transpose within
// each quad (shuffles) gives each thread 8 channels of one pixel, written
// with one 16-byte store masked to the frame.  Nothing is staged, so both
// parts are free before it.
//
// Shared memory: 1,024 (alignment slack) + weights + 4 parts + 64
// (barriers) + 8 * N (bias, slopes): 64 -> 32 (kR 6): 36,864 + 4 x 34,816;
// 96/128 -> 32 (kR 6): 73,728 + 4 x 34,816; 160/192 -> 32-chunks (kR 4):
// 110,592 + 4 x 25,600; all within the 232,448 bytes a block may take.

#include "conv3x3_halo_sm90.cuh"

namespace uvt_k4_sm90 {

using namespace uvt_halo;

constexpr int kWGs = 2;                   // consumer warpgroups

// The conv layer's epilogue on the halo mainloop (conv3x3_halo_sm90.cuh).
template <int N, int KR>
struct ConvEpi {
  static constexpr int kOutBytes = 0;
  static constexpr int kSideBytes = 0;
  __nv_bfloat16* out;
  const float* bias;
  const float* slope;
  float leaky;
  int h, w, c_out_total, out_off, act;

  __device__ __forceinline__ void consts(float* cs, int chunk, int tid) const {
    if (tid < N) {
      cs[tid] = bias[chunk * N + tid];
      cs[N + tid] = act == kActPrelu ? slope[chunk * N + tid] : leaky;
    }
  }

  __device__ __forceinline__ void prefetch(unsigned char*, bool, TileAt, int, int) const {}

  // bias + activation in f32, one rounding; each quad's words are
  // transposed so that a thread holds 8 channels of one pixel and writes
  // them with one 16-byte store
  __device__ __forceinline__ void store(float (&acc)[KR][N / 2], unsigned char*,
                                        unsigned char*, const float* cs, int chunk,
                                        TileAt at, int, int, int warp, int lane,
                                        int) const {
    const int g = lane >> 2;
    const int q = lane & 3;
    __nv_bfloat16* dst = out + out_off + chunk * N;
    const int xw = at.x0 + warp * 16 + g;
#pragma unroll
    for (int r = 0; r < KR; ++r) {
      const int oy = at.y0 + r;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int ox = xw + 8 * half;
        __nv_bfloat16* px = dst + (((size_t)at.f * h + oy) * w + ox) * c_out_total;
        const bool inside = oy < h && ox < w;
#pragma unroll
        for (int j0 = 0; j0 < N / 8; j0 += 4) {
          uint32_t word[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int jn = j0 + k < N / 8 ? j0 + k : j0;
            const float2 bj = *reinterpret_cast<const float2*>(cs + 8 * jn + 2 * q);
            const float2 sj = *reinterpret_cast<const float2*>(cs + N + 8 * jn + 2 * q);
            const __nv_bfloat162 v = __floats2bfloat162_rn(
                activate(acc[r][4 * jn + 2 * half] + bj.x, sj.x, act),
                activate(acc[r][4 * jn + 2 * half + 1] + bj.y, sj.y, act));
            word[k] = *reinterpret_cast<const uint32_t*>(&v);
          }
          const uint4 v = quad_transpose(word, q, lane);
          if (inside && j0 + q < N / 8) {
            *reinterpret_cast<uint4*>(px + (j0 + q) * 8) = v;
          }
        }
      }
    }
  }
};

template <int N, int KR>
__global__ void __launch_bounds__(threads(kWGs), 1)
conv3x3_fused_sm90_kernel(const __grid_constant__ CUtensorMap x_map,
                          __nv_bfloat16* __restrict__ out,
                          const __nv_bfloat16* __restrict__ wmat,
                          const float* __restrict__ bias,
                          const float* __restrict__ slope, float leaky, int h,
                          int w, int cin, int cout, int c_out_total, int out_off,
                          int act, int slices, int chunks, int ntiles) {
  const ConvEpi<N, KR> epi{out, bias, slope, leaky, h, w, c_out_total, out_off, act};
  halo_conv<N, KR, kWGs>(x_map, wmat, h, w, cin, cout, slices, chunks, ntiles, epi);
}

template <int N, int KR>
static int launch(const void* x, void* out, const void* wmat, const void* bias,
                  const void* slope, float leaky, int n, int h, int w, int cin,
                  int c_in_total, int cout, int c_out_total, int out_off, int act,
                  int slices, int chunks, int ntiles, int grid, cudaStream_t stream) {
  return launch_halo<KR, kWGs>(
      conv3x3_fused_sm90_kernel<N, KR>, x, n, h, w, cin, c_in_total, grid,
      smem_bytes(N, KR, slices, kWGs, 0), stream, static_cast<__nv_bfloat16*>(out),
      static_cast<const __nv_bfloat16*>(wmat), static_cast<const float*>(bias),
      static_cast<const float*>(slope), leaky, h, w, cin, cout, c_out_total, out_off,
      act, slices, chunks, ntiles);
}

// The tile height for a chunk width and slice count: the largest of 8, 6,
// 4 whose accumulators (kR * N / 2) and four halo parts beside the weights
// fit.
static int tile_rows(int n, int slices) {
  for (int kr = 8; kr >= 4; kr -= 2) {
    if (kr * n / 2 <= kMaxAcc && smem_bytes(n, kr, slices, kWGs, 0) <= kSmemLimit) {
      return kr;
    }
  }
  return 0;
}

}  // namespace uvt_k4_sm90

extern "C" {

// One conv layer on the sm90 kernel.  x: channels [0, cin) of an NHWC bf16
// buffer (N, h, w, c_in_total); out: channels [out_off, out_off + cout) of
// an NHWC bf16 buffer (N, h, w, c_out_total), no other channel written;
// wmat (9*cin, cout) bf16 in (dy, dx, cin) row order; bias (cout,) f32;
// slope (cout,) f32 read only for PReLU; leaky the leaky-ReLU slope.  x and
// out 16-byte aligned, c_in_total, c_out_total and out_off multiples of 8.
// Returns a cudaError_t code (cudaErrorInvalidValue for a shape or layout
// it does not take or a tensor map cuTensorMapEncodeTiled refuses).
int uvt_conv3x3_fused_sm90(const void* x, void* out, const void* wmat,
                           const void* bias, const void* slope, float leaky, int n,
                           int h, int w, int cin, int c_in_total, int cout,
                           int c_out_total, int out_off, int act, void* stream) {
  using namespace uvt_k4_sm90;
  if (n < 1 || h < 1 || w < 1 || cin < 32 || cin % 32 != 0 ||
      cin > kMaxSlices * kSlice || c_in_total < cin || c_in_total % 8 != 0 ||
      cout < 16 || cout % 16 != 0 || cout > 256 || out_off < 0 ||
      out_off % 8 != 0 || c_out_total % 8 != 0 || out_off + cout > c_out_total ||
      act < kActNone || act > kActRelu ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int slices = (cin + kSlice - 1) / kSlice;
  const int nw = cout % 32 == 0 ? 32 : 16;
  const int kr = tile_rows(nw, slices);
  if (kr == 0) return (int)cudaErrorInvalidValue;
  const int chunks = cout / nw;
  const long long tiles = (long long)n * ((h + kr - 1) / kr) * ((w + kTW - 1) / kTW);
  if (tiles > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const int sms = sm_count();
  if (sms < 0) return -sms;
  // blocks per chunk: one per SM over all chunks, no more than the tiles
  long long lanes = sms / chunks > 0 ? sms / chunks : 1;
  if (lanes > tiles) lanes = tiles;
  const int grid = (int)lanes * chunks;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (nw * 100 + kr) {
    case 3206: return launch<32, 6>(x, out, wmat, bias, slope, leaky, n, h, w, cin, c_in_total, cout, c_out_total, out_off, act, slices, chunks, (int)tiles, grid, s);
    case 3204: return launch<32, 4>(x, out, wmat, bias, slope, leaky, n, h, w, cin, c_in_total, cout, c_out_total, out_off, act, slices, chunks, (int)tiles, grid, s);
    case 1608: return launch<16, 8>(x, out, wmat, bias, slope, leaky, n, h, w, cin, c_in_total, cout, c_out_total, out_off, act, slices, chunks, (int)tiles, grid, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
