// K7 on Hopper: the 64 -> 64 layer of the row-wise Winograd F(2,3) conv
// chain as a persistent, warp-specialised wgmma kernel (sm_90a).
//
// Replaces upscale_video_tpu/ops/conv_winograd.py:73 (_wino_kernel, via
// _wino_step / winograd_chain) for the layers with cin == cout == 64.
// Every other shape stays on conv_winograd.cu (WMMA); the wrapper picks by
// shape (ops/conv_winograd.py:sm90_takes).  Same contract and arithmetic
// as conv_winograd.cu: bordered bf16 NHWC src (N, H+2, W+2, 64) ->
// interior of dst (same shape, zero ring never written).  Per output-row
// pair (2i, 2i+1) the input rows d0..d3 (frame rows 2i-1 .. 2i+2) combine
// into V0 = d0-d2, V1 = d1+d2, V2 = d2-d1, V3 = d1-d3, each rounded once
// to bf16 (bf16x2 adds: row_transform); M_a = V_a (x) U_a over the three
// column taps and 64 channels, bf16 x bf16 summed in f32; then in f32
//     y_even = ((bias + M0) + M1) + M2,   y_odd = ((bias + M1) - M2) - M3,
// the activation, and ONE rounding to bf16 (__float2bfloat16_rn).  The
// sums run in another order than the WMMA kernel's, so values may differ
// by a bf16 ulp.
//
// Bound on the H100: bytes.  A 64 -> 64 layer over 4x1080p reads 1.065 GB
// of bordered buffer and writes as much, 0.636 ms at 3.35 TB/s; its
// 2*6*64*64 operations per pixel are 407.7 GFLOP, 0.412 ms at 989 TFLOP/s
// (K1's direct layer: 0.618 ms).  Measured (chip_smoke.py [K7_ab], NVIDIA
// H100 80GB HBM3, 700.00 W): 0.970 ms, 66% of the bytes bound, level with
// K1's sm90 layer (0.989 ms) and 21x the WMMA kernel.  What holds it is
// its MMA loop, not its bytes: 48 m64n64k16 a pair, each with a fresh
// register A, run at about half the tensor rate (PERF.md).
//
// Design: K1's sm90 layer (conv3x3_chain_sm90.cu) with the row transform
// folded into the A fragments.  One block per SM, 384 threads: a producer
// warpgroup and two consumer warpgroups.
// - Tiles: a row pair x 64 output columns x all 64 output channels of one
//   frame.  A stage holds one pair: the TMA box is 64 ch x 66 px x 4 rows
//   of the bordered buffer, starting at the pair's d0 row, and boxes past
//   the buffer fill with zero (an odd H's last pair reads buffer row H+2;
//   its odd row is dropped).  Three stages (34,816 B each) fit beside the
//   resident U; the consumers take alternate stages, so one's epilogue
//   overlaps the other's MMAs (K1's walk).  Two 6-row stages with one pair
//   per consumer (loading the middle rows once for both) timed level with
//   this plan on the H100 (PERF.md, PR 10) and were dropped.
// - Resident U: the layer's (4, 3*64, 64) matrix is copied into shared
//   memory once per block (98,304 B) as 12 K-major blocks, one per (a,
//   dx): line cout, channel cin, 128-byte swizzle (u_offset below).
// - wgmma with A formed in registers: per (dx, 16-channel chunk) each warp
//   loads d0..d3 for its 16 pixels with ldmatrix.x4 from the swizzled
//   stage (one element mapping for all four), forms V0..V3 element-wise
//   with bf16x2 adds (the same values as f32 differences rounded to bf16,
//   at a fifth of the instructions),
//   and issues one m64n64k16 into each of FOUR f32 accumulator sets M0..M3
//   (32 registers each): 48 wgmmas a pair against K1's 72 for two rows.
//   Two signed sets (y_even, y_odd) would pay for M1 and M2 twice.  V is
//   double-buffered (wgmma reads A asynchronously): group g+1's ldmatrix
//   and V run while group g's wgmmas do (wait_group 1); the pair ends with
//   wait_group 0 before any barrier wait, which keeps ptxas from
//   serialising the wgmmas (C7512).
// - Epilogue in registers: the four sets' fragments share (pixel, cout)
//   positions, so the output transform, bias and activation are
//   element-wise; one rounding, staged (swizzled) into rows of the pair's
//   own stage that no other consumer reads, then written with 16-byte
//   stores masked to the interior (never column W+1 or row H+1).
//
// Shared memory: 1,024 (alignment slack) + 98,304 (U) + 3 x 34,816 (the
// ring) + barriers + 512 (bias, slope) = 204,336 of the 232,448 bytes a
// block may take.  A consumer
// holds 128 accumulators, 32 V and 16 d registers: ptxas (CUDA 12.8)
// reports 168 registers a thread at launch and no spill, and setmaxnreg
// moves the producer to 40 and the consumers to 232.

#include "sm90_common.cuh"

namespace uvt_wino_sm90 {

using namespace uvt_sm90_common;

constexpr int kC = 64;                    // cin == cout
constexpr int kTW = 64;                   // output columns per tile (wgmma M)
constexpr int kHaloCols = kTW + 2;
constexpr int kLine = kC * 2;             // one pixel: the 128-byte swizzle span
constexpr int kRowBytes = kHaloCols * kLine;  // 8,448
constexpr int kBlockBytes = kC * kLine;   // 8,192: one (a, dx) block of U
constexpr int kUBytes = 12 * kBlockBytes; // 98,304
constexpr int kWGs = 2;                   // consumer warpgroups
constexpr int kThreads = (kWGs + 1) * 128;  // + the producer warpgroup
constexpr int kStages = 3;
constexpr int kRows = 4;                  // d0..d3 of one row pair
constexpr int kStageTx = kRows * kRowBytes;
constexpr int kStageBytes = (kStageTx + 1023) / 1024 * 1024;
// alignment slack, U, halo ring, full/empty barriers, bias + slope
constexpr int kSmem =
    1024 + kUBytes + kStages * kStageBytes + 2 * kStages * 8 + 2 * kC * 4;
static_assert(kSmem <= 232448, "shared memory plan exceeds the block limit");
// a pair's output (2 rows x 64 px x 128 B) is staged in its stage's halo
// rows 0-1, which only its own consumer reads
static_assert(2 * kTW * kLine <= 2 * kRowBytes, "output stage too small");

// Byte offset in the resident U of element (a, dx, cin, cout): block
// a * 3 + dx, line cout, 16-byte chunk cin / 8 under the 128-byte swizzle.
// tests/test_torch_winograd.py mirrors this map (and the copy below).
__device__ __forceinline__ uint32_t u_offset(int blk, int cout, int chunk) {
  return (uint32_t)blk * kBlockBytes + swz((uint32_t)cout, (uint32_t)chunk);
}

// V0..V3 of one A-fragment register from the four rows' registers, two
// bf16 lanes at a time.  A bf16x2 add or subtract rounds the exact result
// once; for bf16 operands that equals the plain version's f32 difference
// rounded to bf16: the f32 difference is exact unless the exponents differ
// by 16 or more, and then both round to the larger operand.
__device__ __forceinline__ uint32_t bf2(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

__device__ __forceinline__ void row_transform(const uint32_t (&d)[4][4], int i,
                                              uint32_t (&v)[4][4]) {
  const __nv_bfloat162 d0 = *reinterpret_cast<const __nv_bfloat162*>(&d[0][i]);
  const __nv_bfloat162 d1 = *reinterpret_cast<const __nv_bfloat162*>(&d[1][i]);
  const __nv_bfloat162 d2 = *reinterpret_cast<const __nv_bfloat162*>(&d[2][i]);
  const __nv_bfloat162 d3 = *reinterpret_cast<const __nv_bfloat162*>(&d[3][i]);
  v[0][i] = bf2(__hsub2(d0, d2));
  v[1][i] = bf2(__hadd2(d1, d2));
  v[2][i] = bf2(__hsub2(d2, d1));
  v[3][i] = bf2(__hsub2(d1, d3));
}

template <int ACT>
__global__ void __launch_bounds__(kThreads, 1)
wino_layer_sm90_kernel(const __grid_constant__ CUtensorMap src_map,
                       __nv_bfloat16* __restrict__ dst,
                       const __nv_bfloat16* __restrict__ umat,
                       const float* __restrict__ bias,
                       const float* __restrict__ slope, int h, int w,
                       int ntiles) {
  constexpr int S = kStages;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* sm = smem_raw + (base - raw);
  const uint32_t ring = base + kUBytes;
  const uint32_t bars = ring + S * kStageBytes;  // full[s], then empty[s]
  float* bs_s = reinterpret_cast<float*>(sm + (bars - base) + 2 * S * 8);
  const int hp = h + 2;
  const int wp = w + 2;
  const int ncol = (w + kTW - 1) / kTW;
  const int npair = (h + 1) / 2;
    const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (S + s), 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // resident U: umat is (12, 64 cin, 64 cout) blocks in (a, dx) order;
  // block blk, row cin, column cout -> u_offset(blk, cout, cin / 8)
  for (int i = tid; i < 12 * kC * 8; i += kThreads) {
    const int n = i % kC;
    const int kc = (i / kC) % 8;
    const int blk = i / (kC * 8);
    const __nv_bfloat16* src = umat + (size_t)(blk * kC + kc * 8) * kC + n;
    __align__(16) __nv_bfloat16 v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = src[e * kC];
    *reinterpret_cast<uint4*>(sm + u_offset(blk, n, kc)) =
        *reinterpret_cast<const uint4*>(v);
  }
  if (tid < kC) {
    bs_s[tid] = bias[tid];
    bs_s[kC + tid] = (ACT == kActPrelu || ACT == kActLeaky) ? slope[tid] : 0.0f;
  }
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncthreads();

  const int wg = tid >> 7;
  if (wg == 0) {  // producer warpgroup: one thread keeps the TMA ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;" ::: "memory");
    if (tid == 0) {
      int k = 0;
      for (int t = blockIdx.x; t < ntiles; t += gridDim.x, ++k) {
        const int s = k % S;
        if (k >= S) mbar_wait(bars + 8 * (S + s), ((k / S) - 1) & 1);
        const int col = t % ncol;
        const int pair = (t / ncol) % npair;
        const int f = t / (ncol * npair);
        const uint32_t full = bars + 8 * s;
        mbar_expect_tx(full, kStageTx);
        // d0 of the pair is frame row 2 * pair - 1, buffer row 2 * pair
        tma_load_4d(ring + s * kStageBytes, &src_map, full, 0, col * kTW,
                    2 * pair, f);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;" ::: "memory");

  // consumer c takes every other stage of the block's walk
  const int c = wg - 1;
  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int q = lane & 3;
  const int wt = tid & 127;
  const uint64_t udesc = desc_sw128(base);
  // this lane's ldmatrix line in halo row 0 (d0), column dx = 0
  const uint32_t line0 = warp * 16 + (lane & 15);
  const uint32_t hchunk = lane >> 4;

  for (int k = c, t = blockIdx.x + k * gridDim.x; t < ntiles;
       k += kWGs, t += kWGs * gridDim.x) {
    const int s = k % S;
    const uint32_t stage = ring + s * kStageBytes;
    float acc[4][32];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[a][i] = 0.0f;
      fence_acc(acc[a]);
    }
    // the stage's previous tile was the other consumer's, so wait for its
    // release before the full barrier (a parity wait alone cannot
    // tell a phase from the one two back)
    if (k >= S) mbar_wait(bars + 8 * (S + s), ((k / S) - 1) & 1);
    mbar_wait(bars + 8 * s, (k / S) & 1);

    // 12 groups (dx, 16-channel chunk kc): d0..d3 by ldmatrix, V0..V3 in
    // registers, four wgmmas (one per accumulator set) against U's
    // (a, dx) blocks.  d is loaded one group ahead; V is double-buffered.
    uint32_t d[4][4];
    uint32_t v[2][4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      ldsm_x4(stage + swz(line0 + r * kHaloCols, hchunk), d[r]);
    }
#pragma unroll
    for (int grp = 0; grp < 12; ++grp) {
      const int dx = grp >> 2;
      const int kc = grp & 3;
      const int b = grp & 1;
#pragma unroll
      for (int i = 0; i < 4; ++i) row_transform(d, i, v[b]);
      if (grp + 1 < 12) {
        const int ndx = (grp + 1) >> 2;
        const int nkc = (grp + 1) & 3;
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          ldsm_x4(stage + swz(line0 + r * kHaloCols + ndx, 2 * nkc + hchunk), d[r]);
        }
      }
      wg_fence();
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        wgmma_rs<64>(acc[a], v[b][a],
                     udesc + (uint64_t)(((a * 3 + dx) * kBlockBytes + kc * 32) >> 4));
      }
      wg_commit();
      wg_wait1();
    }
    wg_wait0();
#pragma unroll
    for (int a = 0; a < 4; ++a) fence_acc(acc[a]);

    // epilogue: output transform, bias + activation in f32, one rounding,
    // staged (swizzled) into the stage's halo rows 0-1
    bar_sync(1 + c, 128);  // every warp of this warpgroup is done with the halo
    unsigned char* out_p = sm + (stage - base);
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const float2 bj = *reinterpret_cast<const float2*>(bs_s + 8 * jj + 2 * q);
      const float2 sj = *reinterpret_cast<const float2*>(bs_s + kC + 8 * jj + 2 * q);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int i0 = 4 * jj + 2 * half;
        float ye[2], yo[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float bb = e ? bj.y : bj.x;
          const float ss = e ? sj.y : sj.x;
          const float m0 = acc[0][i0 + e], m1 = acc[1][i0 + e];
          const float m2 = acc[2][i0 + e], m3 = acc[3][i0 + e];
          ye[e] = activate<ACT>(__fadd_rn(__fadd_rn(__fadd_rn(bb, m0), m1), m2), ss);
          yo[e] = activate<ACT>(__fsub_rn(__fsub_rn(__fadd_rn(bb, m1), m2), m3), ss);
        }
        const uint32_t px = (uint32_t)(warp * 16 + g + 8 * half);
        *reinterpret_cast<__nv_bfloat162*>(out_p + swz(px, jj) + 4 * q) =
            __floats2bfloat162_rn(ye[0], ye[1]);
        *reinterpret_cast<__nv_bfloat162*>(out_p + swz(kTW + px, jj) + 4 * q) =
            __floats2bfloat162_rn(yo[0], yo[1]);
      }
    }
    bar_sync(1 + c, 128);
    const int col = t % ncol;
    const int pair = (t / ncol) % npair;
    const int f = t / (ncol * npair);
    const int y0 = 2 * pair;  // the pair's even frame row
    const int x0 = col * kTW;
#pragma unroll
    for (int i = wt; i < 2 * kTW * 8; i += 128) {
      const int line = i >> 3;
      const int ch = i & 7;
      const int oy = y0 + line / kTW;
      const int ox = x0 + line % kTW;
      if (oy < h && ox < w) {
        const uint4 val = *reinterpret_cast<const uint4*>(out_p + swz(line, ch));
        *reinterpret_cast<uint4*>(
            dst + (((size_t)f * hp + oy + 1) * wp + ox + 1) * kC + ch * 8) = val;
      }
    }
    // the stage may now be refilled by TMA (async proxy) after this
    // warpgroup's generic reads and writes
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    mbar_arrive(bars + 8 * (S + s));
  }
}

template <int ACT>
static int launch(const void* src, void* dst, const void* umat, const void* bias,
                  const void* slope, int n, int h, int w, cudaStream_t stream) {
  const long long tiles = (long long)n * ((h + 1) / 2) * ((w + kTW - 1) / kTW);
  if (tiles > 0x7fffffff) return (int)cudaErrorInvalidValue;
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap map;
  const cuuint64_t dims[4] = {(cuuint64_t)kC, (cuuint64_t)w + 2, (cuuint64_t)h + 2,
                              (cuuint64_t)n};
  const cuuint64_t strides[3] = {(cuuint64_t)kLine, (cuuint64_t)(w + 2) * kLine,
                                 (cuuint64_t)(h + 2) * (w + 2) * kLine};
  const cuuint32_t box[4] = {(cuuint32_t)kC, (cuuint32_t)kHaloCols,
                             (cuuint32_t)kRows, 1};
  const cuuint32_t estride[4] = {1, 1, 1, 1};
  if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(src), dims,
             strides, box, estride, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS) {
    return (int)cudaErrorInvalidValue;
  }
  int dev = 0;
  int sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(wino_layer_sm90_kernel<ACT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  }
  if (err != cudaSuccess) return (int)err;
  const int grid = (int)(tiles < sms ? tiles : sms);
  wino_layer_sm90_kernel<ACT><<<grid, kThreads, kSmem, stream>>>(
      map,
      static_cast<__nv_bfloat16*>(dst), static_cast<const __nv_bfloat16*>(umat),
      static_cast<const float*>(bias), static_cast<const float*>(slope), h, w,
      (int)tiles);
  return (int)cudaGetLastError();
}

}  // namespace uvt_wino_sm90

extern "C" {

// One 64 -> 64 Winograd chain layer, with the arguments of
// uvt_conv_winograd_layer.  src (N, h+2, w+2, 64) bf16, dst
// (N, h+2, w+2, 64) bf16 with a zero ring, umat (4, 3*64, 64) bf16 in (a,
// dx, cin) row order, bias and slope (64,) f32.  Returns a cudaError_t code
// (cudaErrorInvalidValue for a shape it does not take or a tensor map
// cuTensorMapEncodeTiled refuses).
int uvt_conv_winograd_layer_sm90(const void* src, void* dst, const void* umat,
                                 const void* bias, const void* slope, int n, int h,
                                 int w, int cin, int cout, int act, void* stream) {
  using namespace uvt_wino_sm90;
  if (n < 1 || h < 1 || w < 1 || cin != kC || cout != kC || act < kActNone ||
      act > kActRelu) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (act) {
    case kActPrelu: return launch<kActPrelu>(src, dst, umat, bias, slope, n, h, w, s);
    case kActLeaky: return launch<kActLeaky>(src, dst, umat, bias, slope, n, h, w, s);
    case kActRelu: return launch<kActRelu>(src, dst, umat, bias, slope, n, h, w, s);
    default: return launch<kActNone>(src, dst, umat, bias, slope, n, h, w, s);
  }
}

}  // extern "C"
