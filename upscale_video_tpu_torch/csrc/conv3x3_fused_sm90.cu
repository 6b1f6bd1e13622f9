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
// Design (one block per SM, 384 threads: a producer warpgroup and two
// consumer warpgroups, as csrc/conv3x3_chain_sm90.cu):
// - Halo by TMA with the SAME border free: a 4-D tensor map over the plain
//   buffer (channels = cin with row stride c_in_total, W, H, N) and
//   CU_TENSOR_MAP_SWIZZLE_128B.  A tile's box starts at (x0 - 1, y0 - 1):
//   TMA fills every element outside the frame with zero, so there is no
//   padded copy, no border ring and no predicate in the mainloop.  The
//   channel extent is cin, so channels past cin of a wider buffer read as
//   zero too.
// - cin in 64-channel slices: one pixel's 64 bf16 channels are the 128-byte
//   swizzle span, so a slice is 64 ch x 66 px x (kR + 2) rows.
//   The K loop runs over ceil(cin / 64) slices; a last slice of 32 channels
//   (cin = 96, 160) issues only its two valid k16 steps, so no MMA work is
//   spent on the zero-filled tail.
// - Tiles: kR output rows x 64 columns (wgmma's M) x a chunk of N output
//   channels.  wgmma m64nNk16 with A (one halo row shifted by dx, 16
//   channels) loaded by ldmatrix from the swizzled halo into registers, B one
//   tap's 16 x N slice of the resident weights; each (halo row, dx) group of
//   A fragments is loaded once and issued against every output row it feeds
//   (dy = 0..2), double-buffered under wgmma.wait_group 1.  Accumulators
//   take kR * N / 2 f32 per thread, at most 96: ptxas allocates the
//   consumers within the 168 registers of a 384-thread block, and 128
//   accumulators spilled.
// - Weights resident, cout in chunks that fit: a chunk's 9 * 64 * slices *
//   N bf16 are copied into shared memory once per block, transposed to
//   wgmma's K-major B layout with the 128-byte swizzle (zero past cin).
//   N = 32 where cout is a multiple of 32, else 16: 192 -> 64 runs as two
//   32-wide chunks (110,592 B of weights each) and 160 -> 160 as five.
//   Streaming the 221,184 B of 192 -> 64 per tile instead would cost ~3.9
//   TB/s of L2 reads at the tensor-core rate; a chunk's blocks reread the
//   halo instead.  Block b serves chunk b % chunks and walks tiles b /
//   chunks, + grid / chunks, ..., so the blocks that share a tile's halo run
//   side by side and L2 serves all but the first read.
// - A double-buffered halo per consumer, split by rows: each consumer
//   warpgroup walks every other tile of its block and owns two parts, the
//   top and the bottom (kR + 2) / 2 halo rows of its current slice, each
//   one TMA box with its own full and empty mbarrier and a producer thread
//   of its own (lanes 0 of warps 0 and 1), so every barrier has one reader
//   and its parity waits are exact.  A part goes back to the producer as
//   soon as its rows are read, so the next slice's (or tile's) top part
//   loads while the bottom part's MMAs and the epilogue run, and its bottom
//   part while the next top part's run.  Only two whole halos per consumer
//   would not fit beside the weights; the split gives the same overlap in
//   the memory of one.  kR is the largest of 8, 6, 4 whose accumulators
//   and four parts fit.
// - Epilogue in registers: bias and activation in f32 on the accumulators,
//   one rounding; a 4 x 4 word transpose within each quad (shuffles) gives
//   each thread 8 channels of one pixel, written with one 16-byte store
//   masked to the frame.  Nothing is staged, so both parts are free before
//   it.
//
// Shared memory: 1,024 (alignment slack) + weights + 4 parts + 64
// (barriers) + 8 * N (bias, slopes): 64 -> 32 (kR 6): 36,864 + 4 x 34,816;
// 96/128 -> 32 (kR 6): 73,728 + 4 x 34,816; 160/192 -> 32-chunks (kR 4):
// 110,592 + 4 x 25,600; all within the 232,448 bytes a block may take.

#include "sm90_common.cuh"

namespace uvt_k4_sm90 {

using namespace uvt_sm90_common;

constexpr int kSlice = 64;                // channels per slice
constexpr int kLine = kSlice * 2;         // one pixel of a slice: the 128-byte swizzle span
constexpr int kTW = 64;                   // output columns per tile (wgmma M)
constexpr int kHaloCols = kTW + 2;
constexpr int kWGs = 2;                   // consumer warpgroups
constexpr int kParts = 2;                 // halo parts per consumer (top, bottom rows)
constexpr int kThreads = (kWGs + 1) * 128;  // + the producer warpgroup
constexpr int kSmemLimit = 232448;
constexpr int kMaxSlices = 3;             // cin <= 192
constexpr int kMaxAcc = 96;               // accumulator registers per thread

// A tile of kr output rows reads kr + 2 halo rows, loaded as two parts of
// part_rows(kr) rows, each 1024-aligned.
__host__ __device__ constexpr int part_rows(int kr) { return (kr + 2) / 2; }
__host__ __device__ constexpr int part_tx(int kr) { return part_rows(kr) * kHaloCols * kLine; }
__host__ __device__ constexpr int part_bytes(int kr) { return (part_tx(kr) + 1023) / 1024 * 1024; }
__host__ __device__ constexpr int weight_bytes(int n, int slices) { return 9 * slices * n * kLine; }
__host__ __device__ constexpr int smem_bytes(int n, int kr, int slices) {
  return 1024 + weight_bytes(n, slices) + kWGs * kParts * part_bytes(kr) +
         2 * kWGs * kParts * 8 + 2 * n * 4;
}

// Halo rows [H0, H1) of one 64-channel slice of a tile's K loop, read from
// the part that holds them, straight-line (no branch between its wgmmas):
// one group per (halo row hr, dx) of KS k16 A fragments, issued against
// every output row hr - dy it feeds.  A is double buffered: group i+1
// loads while group i's wgmmas run (wait_group 1); the call ends with every
// wgmma retired, so none is in flight across the next barrier wait.
template <int N, int KR, int KS, int H0, int H1>
__device__ __forceinline__ void rows_mma(float (&acc)[KR][N / 2], uint32_t part,
                                         uint64_t wdesc, int warp, int lane) {
  constexpr int kTap = N * kLine;
#pragma unroll
  for (int r = 0; r < KR; ++r) fence_acc(acc[r]);
  uint32_t a[2][KS][4];
#pragma unroll
  for (int hr = H0; hr < H1; ++hr) {
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
      const int b = (hr * 3 + dx) & 1;
      const uint32_t line = (uint32_t)(hr - H0) * kHaloCols + warp * 16 + (lane & 15) + dx;
#pragma unroll
      for (int kc = 0; kc < KS; ++kc) {
        ldsm_x4(part + swz(line, 2 * kc + (lane >> 4)), a[b][kc]);
      }
      wg_fence();
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        const int r = hr - dy;
        if (r < 0 || r >= KR) continue;
#pragma unroll
        for (int kc = 0; kc < KS; ++kc) {
          wgmma_rs<N>(acc[r], a[b][kc],
                      wdesc + (uint64_t)(((dy * 3 + dx) * kTap + kc * 32) >> 4));
        }
      }
      wg_commit();
      wg_wait1();
    }
  }
  wg_wait0();
#pragma unroll
  for (int r = 0; r < KR; ++r) fence_acc(acc[r]);
}

// One halo part of one slice: KS = 2 for a last slice of 32 channels
// (cin = 96, 160), which so spends no MMA on the zero-filled tail.
template <int N, int KR, int H0, int H1>
__device__ __forceinline__ void part_mma(float (&acc)[KR][N / 2], uint32_t part,
                                         uint64_t wdesc, int warp, int lane, bool half) {
  if (half) {
    rows_mma<N, KR, 2, H0, H1>(acc, part, wdesc, warp, lane);
  } else {
    rows_mma<N, KR, 4, H0, H1>(acc, part, wdesc, warp, lane);
  }
}

// A 4 x 4 transpose of 32-bit words within a quad (lanes 4i..4i+3):
// thread q ends with word[q] of each of the quad's threads, in thread
// order.  Round i: each thread sends its word (q - i) & 3 and receives
// thread (q + i) & 3's word q.
__device__ __forceinline__ uint4 quad_transpose(const uint32_t (&word)[4], int q,
                                                int lane) {
  uint32_t got[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = (q - i) & 3;
    const int from = (q + i) & 3;
    const uint32_t send = k == 0 ? word[0] : k == 1 ? word[1] : k == 2 ? word[2] : word[3];
    const uint32_t v = __shfl_sync(0xffffffffu, send, (lane & ~3) | from);
#pragma unroll
    for (int m = 0; m < 4; ++m) got[m] = from == m ? v : got[m];
  }
  return make_uint4(got[0], got[1], got[2], got[3]);
}

template <int N, int KR>
__global__ void __launch_bounds__(kThreads, 1)
conv3x3_fused_sm90_kernel(const __grid_constant__ CUtensorMap x_map,
                          __nv_bfloat16* __restrict__ out,
                          const __nv_bfloat16* __restrict__ wmat,
                          const float* __restrict__ bias,
                          const float* __restrict__ slope, float leaky, int h,
                          int w, int cin, int cout, int c_out_total, int out_off,
                          int act, int slices, int chunks, int ntiles) {
  static_assert(KR * N / 2 <= kMaxAcc, "accumulators exceed the consumers' registers");
  constexpr int kPart = part_bytes(KR);
  constexpr int kRows = part_rows(KR);
  constexpr int kTap = N * kLine;         // one tap's (cout, 64 cin) block
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* sm = smem_raw + (base - raw);
  const uint32_t ring = base + weight_bytes(N, slices);
  // full[c][p], then empty[c][p]: one pair per consumer c and part p
  const uint32_t bars = ring + kWGs * kParts * kPart;
  float* bs_s = reinterpret_cast<float*>(sm + (bars - base) + 2 * kWGs * kParts * 8);
  const int chunk = blockIdx.x % chunks;
  const int first = blockIdx.x / chunks;   // the block's first tile
  const int step = gridDim.x / chunks;     // tiles between a block's turns
  const int ncol = (w + kTW - 1) / kTW;
  const int nband = (h + KR - 1) / KR;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int i = 0; i < kWGs * kParts; ++i) {
      mbar_init(bars + 8 * i, 1);
      mbar_init(bars + 8 * (kWGs * kParts + i), 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // resident weights: row (tap*cin + ci), column chunk*N + n of wmat ->
  // slice ci / 64, tap block line n, channel ci % 64 (K-major), 8 channels
  // per 16-byte chunk; zero past cin
  for (int i = tid; i < slices * 9 * N * 8; i += kThreads) {
    const int n = i % N;
    const int kc = (i / N) % 8;
    const int tap = (i / (N * 8)) % 9;
    const int sl = i / (N * 8 * 9);
    const int ci0 = sl * kSlice + kc * 8;
    const __nv_bfloat16* src = wmat + (size_t)(tap * cin) * cout + chunk * N + n;
    __align__(16) __nv_bfloat16 v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      v[e] = ci0 + e < cin ? src[(size_t)(ci0 + e) * cout] : __float2bfloat16(0.0f);
    }
    *reinterpret_cast<uint4*>(sm + (sl * 9 + tap) * kTap + swz(n, kc)) =
        *reinterpret_cast<const uint4*>(v);
  }
  if (tid < N) {
    bs_s[tid] = bias[chunk * N + tid];
    bs_s[N + tid] = act == kActPrelu ? slope[chunk * N + tid] : leaky;
  }
  fence_async_smem();
  __syncthreads();

  const int wg = tid >> 7;
  if (wg == 0) {  // producer warpgroup: lane 0 of warp c fills consumer c's parts
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;" ::: "memory");
    const int c = tid >> 5;
    if ((tid & 31) == 0 && c < kWGs) {
      int j = 0;
      for (int t = first + c * step; t < ntiles; t += kWGs * step) {
        const int col = t % ncol;
        const int band = (t / ncol) % nband;
        const int f = t / (ncol * nband);
        for (int sl = 0; sl < slices; ++sl, ++j) {
#pragma unroll
          for (int p = 0; p < kParts; ++p) {
            const int i = c * kParts + p;
            if (j > 0) mbar_wait(bars + 8 * (kWGs * kParts + i), (j - 1) & 1);
            mbar_expect_tx(bars + 8 * i, part_tx(KR));
            // the box starts one pixel up and left of the tile: TMA
            // zero-fills the border
            tma_load_4d(ring + i * kPart, &x_map, bars + 8 * i, sl * kSlice,
                        col * kTW - 1, band * KR - 1 + p * kRows, f);
          }
        }
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;" ::: "memory");

  // consumer warpgroup c takes every other tile of the block's walk
  const int c = wg - 1;
  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int q = lane & 3;
  const uint32_t top = ring + c * kParts * kPart;
  const uint32_t bottom = top + kPart;
  const uint32_t full = bars + 8 * c * kParts;             // top, then bottom
  const uint32_t empty = full + 8 * kWGs * kParts;
  __nv_bfloat16* dst = out + out_off + chunk * N;
  const uint64_t wdesc0 = desc_sw128(base);

  int j = 0;
  for (int t = first + c * step; t < ntiles; t += kWGs * step) {
    float acc[KR][N / 2];
#pragma unroll
    for (int r = 0; r < KR; ++r) {
#pragma unroll
      for (int i = 0; i < N / 2; ++i) acc[r][i] = 0.0f;
      fence_acc(acc[r]);
    }
    for (int sl = 0; sl < slices; ++sl, ++j) {
      const uint64_t wdesc = wdesc0 + (uint64_t)((sl * 9 * kTap) >> 4);
      const bool half = cin - sl * kSlice < kSlice;
      // each part goes back to the producer as soon as its rows are read
      // (by ldmatrix only; every wgmma has retired), so the top part of the
      // next slice or tile loads while the bottom one and the epilogue run
      mbar_wait(full, j & 1);
      part_mma<N, KR, 0, kRows>(acc, top, wdesc, warp, lane, half);
      fence_async_smem();
      mbar_arrive(empty);
      mbar_wait(full + 8, j & 1);
      part_mma<N, KR, kRows, KR + 2>(acc, bottom, wdesc, warp, lane, half);
      fence_async_smem();
      mbar_arrive(empty + 8);
    }

    // epilogue in registers: bias + activation in f32, one rounding; each
    // quad's words are transposed so that a thread holds 8 channels of one
    // pixel and writes them with one 16-byte store
    const int col = t % ncol;
    const int band = (t / ncol) % nband;
    const int f = t / (ncol * nband);
    const int y0 = band * KR;
    const int x0 = col * kTW + warp * 16 + g;
#pragma unroll
    for (int r = 0; r < KR; ++r) {
      const int oy = y0 + r;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int ox = x0 + 8 * half;
        __nv_bfloat16* px = dst + (((size_t)f * h + oy) * w + ox) * c_out_total;
        const bool inside = oy < h && ox < w;
#pragma unroll
        for (int j0 = 0; j0 < N / 8; j0 += 4) {
          uint32_t word[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int jn = j0 + k < N / 8 ? j0 + k : j0;
            const float2 bj = *reinterpret_cast<const float2*>(bs_s + 8 * jn + 2 * q);
            const float2 sj = *reinterpret_cast<const float2*>(bs_s + N + 8 * jn + 2 * q);
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
}

struct Args {
  void* out;
  const void* wmat;
  const void* bias;
  const void* slope;
  float leaky;
  int h, w, cin, cout, c_out_total, out_off, act, slices, chunks, ntiles, grid;
};

template <int N, int KR>
static int launch(const void* x, int n, int c_in_total, const Args& a,
                  cudaStream_t stream) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap map;
  const cuuint64_t row = (cuuint64_t)c_in_total * 2;
  const cuuint64_t dims[4] = {(cuuint64_t)a.cin, (cuuint64_t)a.w, (cuuint64_t)a.h,
                              (cuuint64_t)n};
  const cuuint64_t strides[3] = {row, row * a.w, row * a.w * a.h};
  const cuuint32_t box[4] = {(cuuint32_t)kSlice, (cuuint32_t)kHaloCols,
                             (cuuint32_t)part_rows(KR), 1};
  const cuuint32_t estride[4] = {1, 1, 1, 1};
  if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x), dims,
             strides, box, estride, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS) {
    return (int)cudaErrorInvalidValue;
  }
  const int smem = smem_bytes(N, KR, a.slices);
  if (smem > kSmemLimit) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      conv3x3_fused_sm90_kernel<N, KR>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  conv3x3_fused_sm90_kernel<N, KR><<<a.grid, kThreads, smem, stream>>>(
      map, static_cast<__nv_bfloat16*>(a.out),
      static_cast<const __nv_bfloat16*>(a.wmat), static_cast<const float*>(a.bias),
      static_cast<const float*>(a.slope), a.leaky, a.h, a.w, a.cin, a.cout,
      a.c_out_total, a.out_off, a.act, a.slices, a.chunks, a.ntiles);
  return (int)cudaGetLastError();
}

// The tile height for a chunk width and slice count: the largest of 8, 6,
// 4 whose accumulators (kR * N / 2) and four halo parts beside the weights
// fit.
static int tile_rows(int n, int slices) {
  for (int kr = 8; kr >= 4; kr -= 2) {
    if (kr * n / 2 <= kMaxAcc && smem_bytes(n, kr, slices) <= kSmemLimit) return kr;
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
  int dev = 0;
  int sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err != cudaSuccess) return (int)err;
  // blocks per chunk: one per SM over all chunks, no more than the tiles
  long long lanes = sms / chunks > 0 ? sms / chunks : 1;
  if (lanes > tiles) lanes = tiles;
  Args a{out, wmat, bias, slope, leaky, h, w, cin, cout, c_out_total, out_off, act,
         slices, chunks, (int)tiles, (int)lanes * chunks};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (nw * 100 + kr) {
    case 3206: return launch<32, 6>(x, n, c_in_total, a, s);
    case 3204: return launch<32, 4>(x, n, c_in_total, a, s);
    case 1608: return launch<16, 8>(x, n, c_in_total, a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
