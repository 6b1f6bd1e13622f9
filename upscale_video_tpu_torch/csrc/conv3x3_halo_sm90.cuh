// The persistent TMA-halo mainloop over a plain NHWC bf16 activation: one
// SAME 3x3 conv of cin input channels to a chunk of N output columns per
// tile of KR output rows x 64 output columns, its epilogue a template
// parameter.  Shared by K4's Hopper kernel (conv3x3_fused_sm90.cu, a conv
// layer's epilogue) and K3's (sr_tail_sm90.cu, the SRVGG tail's epilogue);
// K5's stage kernels (rdb_block_sm90.cu) walk their own slices with
// rows_mma, encode_halo and quad_transpose.
//
// One block per SM: a producer warpgroup and WGS consumer warpgroups (2, or
// 1 where two consumers' halo parts do not fit beside the weights).
// - Halo by TMA with the SAME border free: a 4-D tensor map over the plain
//   buffer (channels = cin with row stride c_in_total, W, H, N) and
//   CU_TENSOR_MAP_SWIZZLE_128B.  A tile's box starts at (x0 - 1, y0 - 1):
//   TMA fills every element outside the frame with zero, so there is no
//   padded copy, no border ring and no predicate in the mainloop.  The
//   channel extent is cin, so channels past cin of a wider buffer read as
//   zero too.
// - cin in 64-channel slices: one pixel's 64 bf16 channels are the 128-byte
//   swizzle span, so a slice is 64 ch x 66 px x (KR + 2) rows.
//   The K loop runs over ceil(cin / 64) slices; a last slice of 32 channels
//   (cin = 96, 160) issues only its two valid k16 steps, so no MMA work is
//   spent on the zero-filled tail.
// - wgmma m64nNk16 with A (one halo row shifted by dx, 16 channels) loaded
//   by ldmatrix from the swizzled halo into registers, B one tap's 16 x N
//   slice of the resident weights; each (halo row, dx) group of A fragments
//   is loaded once and issued against every output row it feeds
//   (dy = 0..2), double-buffered under wgmma.wait_group 1.  Accumulators
//   take KR * N / 2 f32 per thread, at most 96: ptxas allocates the
//   consumers within the 168 registers of a 384-thread block, and 128
//   accumulators spilled.
// - Weights resident, cout in chunks of N: a chunk's 9 * 64 * slices * N
//   bf16 are copied into shared memory once per block, transposed to
//   wgmma's K-major B layout with the 128-byte swizzle (zero past cin and
//   past cout).  Block b serves chunk b % chunks and walks tiles b /
//   chunks, + grid / chunks, ..., so the blocks that share a tile's halo
//   run side by side and L2 serves all but the first read.
// - A double-buffered halo per consumer, split by rows: each consumer
//   warpgroup walks every WGS-th tile of its block and owns two parts, the
//   top and the bottom (KR + 2) / 2 halo rows of its current slice, each
//   one TMA box with its own full and empty mbarrier and a producer thread
//   of its own (lane 0 of producer warp c), so every barrier has one reader
//   and its parity waits are exact.  A part goes back to the producer as
//   soon as its rows are read, so the next slice's (or tile's) top part
//   loads while the bottom part's MMAs and the epilogue run, and its bottom
//   part while the next top part's run.
//
// Shared memory: 1,024 (alignment slack) + weights + 2 * WGS parts + the
// barriers + 2 * N per-column constants + WGS epilogue areas of
// E::kSideBytes + E::kOutBytes.
//
// The epilogue type E supplies kOutBytes and kSideBytes (its stage and its
// side buffers per consumer; the halo mainloop keeps both apart from the
// halo), consts(cs, chunk, tid) (2 * N floats for the block's chunk),
// prefetch(side, valid, at, slot, wt) (a tile's own loads into side
// buffer slot by cp.async, one committed group a call, issued one tile
// ahead: the next tile's during this tile's epilogue) and store(acc,
// side, stage, cs, chunk, at, slot, c, warp, lane, wt), consumer c's
// epilogue of one tile.

#pragma once

#include "sm90_common.cuh"

namespace uvt_halo {

using namespace uvt_sm90_common;

constexpr int kSlice = 64;                // channels per slice
constexpr int kLine = kSlice * 2;         // one pixel of a slice: the 128-byte swizzle span
constexpr int kTW = 64;                   // output columns per tile (wgmma M)
constexpr int kHaloCols = kTW + 2;
constexpr int kParts = 2;                 // halo parts per consumer (top, bottom rows)
constexpr int kSmemLimit = 232448;
constexpr int kMaxSlices = 3;             // cin <= 192
constexpr int kMaxAcc = 96;               // accumulator registers per thread

__host__ __device__ constexpr int threads(int wgs) { return (wgs + 1) * 128; }

// A tile of kr output rows reads kr + 2 halo rows, loaded as two parts of
// part_rows(kr) rows, each 1024-aligned.
__host__ __device__ constexpr int part_rows(int kr) { return (kr + 2) / 2; }
__host__ __device__ constexpr int part_tx(int kr) { return part_rows(kr) * kHaloCols * kLine; }
__host__ __device__ constexpr int part_bytes(int kr) { return (part_tx(kr) + 1023) / 1024 * 1024; }
__host__ __device__ constexpr int weight_bytes(int n, int slices) { return 9 * slices * n * kLine; }
__host__ __device__ constexpr int smem_bytes(int n, int kr, int slices, int wgs,
                                             int epi_bytes) {
  return 1024 + weight_bytes(n, slices) + wgs * kParts * part_bytes(kr) +
         2 * wgs * kParts * 8 + 2 * n * 4 + wgs * epi_bytes;
}

// Halo rows [H0, H1) of one 64-channel slice of a tile's K loop, read from
// the part that holds them, straight-line (no branch between its wgmmas):
// one group per (halo row hr, dx) of KS k16 A fragments (the slice's k16
// steps KC0 .. KC0 + KS - 1), issued against
// every output row hr - dy it feeds.  A is double buffered: group i+1
// loads while group i's wgmmas run (wait_group 1); the call ends with every
// wgmma retired, so none is in flight across the next barrier wait.
template <int N, int KR, int KS, int H0, int H1, int KC0 = 0>
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
        ldsm_x4(part + swz(line, 2 * (KC0 + kc) + (lane >> 4)), a[b][kc]);
      }
      wg_fence();
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        const int r = hr - dy;
        if (r < 0 || r >= KR) continue;
#pragma unroll
        for (int kc = 0; kc < KS; ++kc) {
          wgmma_rs<N>(acc[r], a[b][kc],
                      wdesc + (uint64_t)(((dy * 3 + dx) * kTap + (KC0 + kc) * 32) >> 4));
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
// thread (q + i) & 3's word q.  An epilogue so turns the accumulators'
// channel pairs into 8 channels of one pixel (one 16-byte access), and back.
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

// The whole kernel body: every thread of the block calls it.  wmat is the
// (9 * cin, cout) weight matrix in (dy, dx, cin) row order.
template <int N, int KR, int WGS, class E>
__device__ __forceinline__ void halo_conv(const CUtensorMap& x_map,
                                          const __nv_bfloat16* __restrict__ wmat,
                                          int h, int w, int cin, int cout, int slices,
                                          int chunks, int ntiles, const E& epi) {
  static_assert(KR * N / 2 <= kMaxAcc, "accumulators exceed the consumers' registers");
  constexpr int kPart = part_bytes(KR);
  constexpr int kRows = part_rows(KR);
  constexpr int kTap = N * kLine;         // one tap's (cout, 64 cin) block
  constexpr int kThreads = threads(WGS);
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* sm = smem_raw + (base - raw);
  const uint32_t ring = base + weight_bytes(N, slices);
  // full[c][p], then empty[c][p]: one pair per consumer c and part p
  const uint32_t bars = ring + WGS * kParts * kPart;
  float* cs_s = reinterpret_cast<float*>(sm + (bars - base) + 2 * WGS * kParts * 8);
  unsigned char* stages = reinterpret_cast<unsigned char*>(cs_s + 2 * N);
  const int chunk = blockIdx.x % chunks;
  const int first = blockIdx.x / chunks;   // the block's first tile
  const int step = gridDim.x / chunks;     // tiles between a block's turns
  const int ncol = (w + kTW - 1) / kTW;
  const int nband = (h + KR - 1) / KR;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int i = 0; i < WGS * kParts; ++i) {
      mbar_init(bars + 8 * i, 1);
      mbar_init(bars + 8 * (WGS * kParts + i), 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // resident weights: row (tap*cin + ci), column chunk*N + n of wmat ->
  // slice ci / 64, tap block line n, channel ci % 64 (K-major), 8 channels
  // per 16-byte chunk; zero past cin and past cout
  for (int i = tid; i < slices * 9 * N * 8; i += kThreads) {
    const int n = i % N;
    const int kc = (i / N) % 8;
    const int tap = (i / (N * 8)) % 9;
    const int sl = i / (N * 8 * 9);
    const int ci0 = sl * kSlice + kc * 8;
    const int col = chunk * N + n;
    const __nv_bfloat16* src = wmat + (size_t)(tap * cin) * cout + col;
    __align__(16) __nv_bfloat16 v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      v[e] = ci0 + e < cin && col < cout ? src[(size_t)(ci0 + e) * cout]
                                         : __float2bfloat16(0.0f);
    }
    *reinterpret_cast<uint4*>(sm + (sl * 9 + tap) * kTap + swz(n, kc)) =
        *reinterpret_cast<const uint4*>(v);
  }
  epi.consts(cs_s, chunk, tid);
  fence_async_smem();
  __syncthreads();

  const int wg = tid >> 7;
  if (wg == 0) {  // producer warpgroup: lane 0 of warp c fills consumer c's parts
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;" ::: "memory");
    const int c = tid >> 5;
    if ((tid & 31) == 0 && c < WGS) {
      int j = 0;
      for (int t = first + c * step; t < ntiles; t += WGS * step) {
        const int col = t % ncol;
        const int band = (t / ncol) % nband;
        const int f = t / (ncol * nband);
        for (int sl = 0; sl < slices; ++sl, ++j) {
#pragma unroll
          for (int p = 0; p < kParts; ++p) {
            const int i = c * kParts + p;
            if (j > 0) mbar_wait(bars + 8 * (WGS * kParts + i), (j - 1) & 1);
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

  // consumer warpgroup c takes every WGS-th tile of the block's walk
  const int c = wg - 1;
  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int wt = tid & 127;
  const uint32_t top = ring + c * kParts * kPart;
  const uint32_t bottom = top + kPart;
  const uint32_t full = bars + 8 * c * kParts;             // top, then bottom
  const uint32_t empty = full + 8 * WGS * kParts;
  unsigned char* side = stages + c * (E::kSideBytes + E::kOutBytes);
  unsigned char* stage = side + E::kSideBytes;
  const uint64_t wdesc0 = desc_sw128(base);

  int j = 0;
  int t = first + c * step;
  const auto at = [&](int tile) {
    return TileAt{tile / (ncol * nband), (tile / ncol) % nband * KR, tile % ncol * kTW};
  };
  epi.prefetch(side, t < ntiles, at(t), 0, wt);
  for (int it = 0; t < ntiles; t += WGS * step, ++it) {
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
    const int tn = t + WGS * step;  // this consumer's next tile
    epi.prefetch(side, tn < ntiles, at(tn), (it + 1) & 1, wt);
    epi.store(acc, side, stage, cs_s, chunk, at(t), it & 1, c, warp, lane, wt);
  }
}

// Encodes the halo's 4-D tensor map over channels [0, cin) of a plain
// (N, h, w, c_in_total) bf16 buffer: boxes of 64 channels x 66 columns x
// part_rows(KR) rows, the 128-byte swizzle, zero fill outside.  Returns a
// cudaError_t code.
template <int KR>
static int encode_halo(CUtensorMap* map, const void* x, int n, int h, int w, int cin,
                       int c_in_total) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t row = (cuuint64_t)c_in_total * 2;
  const cuuint64_t dims[4] = {(cuuint64_t)cin, (cuuint64_t)w, (cuuint64_t)h,
                              (cuuint64_t)n};
  const cuuint64_t strides[3] = {row, row * w, row * w * h};
  const cuuint32_t box[4] = {(cuuint32_t)kSlice, (cuuint32_t)kHaloCols,
                             (cuuint32_t)part_rows(KR), 1};
  const cuuint32_t estride[4] = {1, 1, 1, 1};
  if (encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x), dims,
             strides, box, estride, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS) {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaSuccess;
}

// Encodes the halo's map over channels [0, cin) of a plain (N, h, w,
// c_in_total) bf16 buffer and launches `kernel` with WGS consumers on
// `grid` blocks, `smem` bytes each.  Returns a cudaError_t code.
template <int KR, int WGS, class K, class... A>
static int launch_halo(K kernel, const void* x, int n, int h, int w, int cin,
                       int c_in_total, int grid, int smem, cudaStream_t stream,
                       A... args) {
  CUtensorMap map;
  const int code = encode_halo<KR>(&map, x, n, h, w, cin, c_in_total);
  if (code != (int)cudaSuccess) return code;
  if (smem > kSmemLimit) return (int)cudaErrorInvalidValue;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, threads(WGS), smem, stream>>>(map, args...);
  return (int)cudaGetLastError();
}

// The number of SMs of the current device, or a negative cudaError_t.
static int sm_count() {
  int dev = 0;
  int sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return err == cudaSuccess ? sms : -(int)err;
}

}  // namespace uvt_halo
