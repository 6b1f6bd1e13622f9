// K5 on Hopper: one Valar residual dense block as five stage kernels
// (sm_90a), launched in turn on one stream by one C entry point.
//
// Replaces upscale_video_tpu/ops/rdb_pallas.py:253 (_rdb_kernel, reached
// via rdb_apply_canvas -> _rdb_run_canvas on the product path).  One call
// computes a whole dense block over a batch of (H, W, 64) bf16 frames:
//
//   c1 = lrelu(conv(x))
//   c2 = lrelu(conv(x, c1)) + conv1x1(x)
//   c3 = lrelu(conv(x, c1, c2))
//   c4 = lrelu(conv(x, c1, c2, c3)) + c2          (c2's f32 value)
//   c5 = conv(x, c1, c2, c3, c4)                  (no activation)
//   out = bf16(f32(x) + 0.2 * c5)
//
// Rounding points, kept from the TPU kernel (rdb_pallas.py:353-365,
// :412-452, :512-516) and held by ops/rdb.py:rdb_block_plain: target t is
// the sum, in source order x, c1, c2, ..., of f32(bf16(P_s,t)), P_s,t
// source s convolved with its weight slice and accumulated in f32; then +
// bias, lrelu, the c2 skip (+ its bias, summed in f32 unrounded) or c2's
// pre-rounding f32 value for c4, one rounding to bf16; outside the frame
// every stage reads zero.  Each (target, source) piece has its own f32
// accumulators, retired (wgmma.wait_group 0) before it is rounded and
// added; only the order of the sum inside a piece differs from the plain
// version.  Elementwise steps use __fadd_rn/__fmul_rn, as the plain version.
//
// Stage T = 1..5 is one launch of rdb_block_sm90_kernel<T> over the whole
// batch: K4's persistent TMA-halo mainloop (conv3x3_halo_sm90.cuh), a
// producer warpgroup and three consumer warpgroups (two in stage 2), each
// consumer on its own tiles of 2 output rows x 64 columns (a consumer's
// halo parts its own), the SAME border by TMA zero fill,
// 64-channel swizzled halo slices in a top/bottom row-split double buffer,
// the stage's weights resident in shared memory (one 32-column cout chunk;
// c5's 64 columns as two chunks served by alternate blocks), wgmma
// m64n32k16 with A from registers and A reused across dy.
//
// Slices.  x is read through its own tensor map; c1..c4 live in a bf16
// scratch of 128 channels (stage T appends its 32 at channel 32 (T - 1)),
// read through a map whose channel extent is 32 (T - 1), so nothing past
// what earlier stages wrote is read.  Stage T walks x, then (c1|c2), then
// (c3|c4) as 64-channel slices; a slice holding two sources is walked once
// per source (its k16 steps 0-1, then 2-3), each pass over all 9 taps into
// one accumulator set, drained and rounded at the 32-channel boundary.
// Stage 2 walks c1 before x (two pieces: f32 addition is commutative, so
// the sum is bit for bit the same) and then, with x's slice still resident,
// the 1x1 skip from its centre pixels into the piece accumulators.  A
// second scratch holds c2's pre-rounding f32 value (32 channels), written by
// stage 2 and read by stage 4.  Stage 5 reads x's centre pixels for the
// residual from device memory (x's slice is the first of five and its
// buffer is refilled by then; the tile's x rows were just read, so L2
// serves them).  The wrapper (ops/rdb.py:rdb_block) allocates both
// scratches with torch.empty on each call; every element is written before
// it is read.
//
// Bound on the H100, per stage at 8x576x512 (the tiles of a 1080p -m r
// frame, 2,359,296 pixels): stages 1-4 do 9*cin*32 MACs a pixel (cin 64 ..
// 160) against 192, 384 (c2 also in f32), 320 and 512 (c2's f32 read) bytes
// a pixel, 155-230 FLOP/byte, under the bf16 ridge of ~295, as K4's header
// works out for 64..160 -> 32: bytes bound them.  Stage 5 (192 -> 64,
// 110,592 MACs against 512 bytes a pixel) is bound by operations.  The
// floor is 1,408 B/px of stage 1-4 traffic at 3.35 TB/s (0.992 ms) plus
// stage 5's operations (0.528 ms): 1.52 ms a launch (1,920 B/px of stage
// traffic in all).  That is above k5_roofline's fused bound of 1.153 ms
// (operations: 241,664 MACs a pixel; the fused block moves only x, out and
// the weights), so this design tops out at ~76% of that metric.
//
// Registers and warpgroups: a consumer holds a piece's accumulators and
// the target's sum for its 2 rows (2 x 32 f32) beside its two A buffers
// (32).  ptxas allocates within the block's share of the register file,
// whatever setmaxnreg grants later (168 a thread at 384 threads, 128 at
// 512).  In A/Bs on the card (NVIDIA H100 80GB HBM3, 8x576x512): 4-row
// tiles (2 x 64 f32) spilled 200-436 bytes a stage at 384 threads and ran
// 3.97 ms against 3.21-3.27 for 2-row tiles without a spill, and with x in
// two 32-channel passes (16 A registers) still spilled (3.82 ms), so the
// halo is read 2x rather than 1.5x; three consumers (512 threads, at most
// 52 bytes spilled, in stage 5) ran 3.10-3.15 ms against two's 3.22-3.38,
// stage 2 excepted (0.64 ms against 0.47), which keeps two: 2.95-3.04 ms
// in all.  Two accumulator sets for a slice of two sources, or one wait
// for both halo parts and one wgmma chain over them, gained nothing.
// Shared memory: 1,024 (alignment slack) + the stage's weights (9 x 4,096
// B per slice, 64 channels of a slice's line even where only 32 are read;
// c2's skip 4,096) + two halo parts of 17,408 a consumer + their barriers
// + 256 (bias, skip bias): stages 4 and 5 216,416 B, within the 232,448 a
// block may take.

#include "conv3x3_halo_sm90.cuh"

namespace uvt_rdb_sm90 {

using namespace uvt_halo;

constexpr int kNF = 64;                 // trunk width (x, c5, out)
constexpr int kGC = 32;                 // growth channels (c1..c4)
constexpr int kN = 32;                  // output columns per chunk (wgmma N)
constexpr int kKR = 2;                  // output rows per tile
constexpr int kScratch = 4 * kGC;       // c1..c4 in bf16
constexpr int kRows = part_rows(kKR);   // halo rows per part
constexpr int kPart = part_bytes(kKR);
constexpr int kTap = kN * kLine;        // one tap's 32 lines of 64 channels

// Stage T = 1..5 computes c_T in chunks of 32 output columns.  Its consumer
// warpgroups, and the setmaxnreg of the producer warpgroup and of theirs:
// three, except stage 2 (see the head note).
__host__ __device__ constexpr int chunks(int T) { return T == 5 ? 2 : 1; }
__host__ __device__ constexpr int wgs(int T) { return T == 2 ? 2 : 3; }
__host__ __device__ constexpr int producer_regs(int T) { return wgs(T) == 2 ? 40 : 24; }
__host__ __device__ constexpr int consumer_regs(int T) { return wgs(T) == 2 ? 232 : 160; }
// Its slices, in the order it walks them: slice i's first source (0 = x,
// s >= 1 = c_s), the sources it holds (one or two), its k16 steps per
// source, and where its channels start in its buffer (x, or the c1..c4
// scratch).
__host__ __device__ constexpr int nslices(int T) { return 1 + T / 2; }
__host__ __device__ constexpr int slice_src(int T, int i) {
  return T == 2 ? 1 - i : (i == 0 ? 0 : 2 * i - 1);
}
__host__ __device__ constexpr int slice_pieces(int T, int i) {
  return slice_src(T, i) == 0 ? 1 : (T - slice_src(T, i) >= 2 ? 2 : 1);
}
__host__ __device__ constexpr int slice_ks(int T, int i) {
  return slice_src(T, i) == 0 ? kNF / 16 : kGC / 16;
}
__host__ __device__ constexpr int slice_channels(int T, int i) {
  return slice_src(T, i) == 0 ? kNF : kGC * slice_pieces(T, i);
}
__host__ __device__ constexpr int slice_offset(int T, int i) {
  return slice_src(T, i) == 0 ? 0 : (slice_src(T, i) - 1) * kGC;
}
// Elements of a cout chunk's weights in the pack (ops/rdb.py:sm90_blocks):
// per slice, per tap, 32 lines of the slice's channels; c2's skip after.
__host__ __device__ constexpr int slices_numel(int T, int i) {
  return i == nslices(T) ? 0 : 9 * kN * slice_channels(T, i) + slices_numel(T, i + 1);
}
__host__ __device__ constexpr int chunk_numel(int T) {
  return slices_numel(T, 0) + (T == 2 ? kN * kNF : 0);
}
__host__ __device__ constexpr int stage_offset(int T) {
  return T <= 1 ? 0 : stage_offset(T - 1) + chunks(T - 1) * chunk_numel(T - 1);
}
__host__ __device__ constexpr int wbytes(int T) {
  return nslices(T) * 9 * kTap + (T == 2 ? kTap : 0);
}
__host__ __device__ constexpr int smem(int T) {
  return 1024 + wbytes(T) + wgs(T) * kParts * kPart + 2 * wgs(T) * kParts * 8 +
         2 * kN * 4;
}
static_assert(stage_offset(6) == 241664, "the pack holds every weight once");
static_assert(chunks(5) * kN == kNF, "c5's chunks");
static_assert(slice_src(2, 0) == 1 && slice_src(2, 1) == 0 && slice_src(5, 2) == 3 &&
                  slice_pieces(4, 2) == 1 && slice_pieces(5, 2) == 2,
              "slice plan");
static_assert(smem(2) == 148800 && smem(4) == 216416 && smem(5) == 216416 &&
                  smem(5) <= kSmemLimit,
              "shared-memory plan over the 227 KB limit");

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float leaky(float v, float slope) {
  return v >= 0.0f ? v : __fmul_rn(v, slope);
}

__device__ __forceinline__ void zero(float (&acc)[kKR][kN / 2]) {
#pragma unroll
  for (int r = 0; r < kKR; ++r) {
#pragma unroll
    for (int i = 0; i < kN / 2; ++i) acc[r][i] = 0.0f;
    fence_acc(acc[r]);
  }
}

// A part's rows have been read (every wgmma retired): back to the producer.
__device__ __forceinline__ void release(uint32_t empty) {
  fence_async_smem();
  mbar_arrive(empty);
}

// tot = f32(bf16(P)) for the first piece of the target, else tot + it.
template <bool FIRST>
__device__ __forceinline__ void add_piece(float (&tot)[kKR][kN / 2],
                                          const float (&P)[kKR][kN / 2]) {
#pragma unroll
  for (int r = 0; r < kKR; ++r)
#pragma unroll
    for (int i = 0; i < kN / 2; ++i) {
      const float v = round_bf16(P[r][i]);
      tot[r][i] = FIRST ? v : __fadd_rn(tot[r][i], v);
    }
}

// c2's 1x1 skip over halo rows [H0, H1) of x's slice: the centre pixel of
// output row hr - 1 (column + 1), 4 k16 steps against the skip block, in
// groups of 2 (A double-buffered as in rows_mma).
template <int H0, int H1>
__device__ __forceinline__ void centre_mma(float (&acc)[kKR][kN / 2], uint32_t part,
                                           uint64_t sdesc, int warp, int lane) {
  constexpr int kLo = H0 > 1 ? H0 : 1;
  constexpr int kHi = H1 < kKR + 1 ? H1 : kKR + 1;
#pragma unroll
  for (int r = 0; r < kKR; ++r) fence_acc(acc[r]);
  uint32_t a[2][2][4];
#pragma unroll
  for (int hr = kLo; hr < kHi; ++hr) {
    const uint32_t line = (uint32_t)(hr - H0) * kHaloCols + warp * 16 + (lane & 15) + 1;
#pragma unroll
    for (int kh = 0; kh < 2; ++kh) {
      const int b = kh;
#pragma unroll
      for (int kc = 0; kc < 2; ++kc) {
        ldsm_x4(part + swz(line, 2 * (2 * kh + kc) + (lane >> 4)), a[b][kc]);
      }
      wg_fence();
#pragma unroll
      for (int kc = 0; kc < 2; ++kc) {
        wgmma_rs<kN>(acc[hr - 1], a[b][kc], sdesc + (uint64_t)(((2 * kh + kc) * 32) >> 4));
      }
      wg_commit();
      wg_wait1();
    }
  }
  wg_wait0();
#pragma unroll
  for (int r = 0; r < kKR; ++r) fence_acc(acc[r]);
}

// The consumer's halo parts of one slice and its barriers.
struct Parts {
  uint32_t top, bottom, full, empty;
};

// Slice I of stage T for one tile: each of its sources one piece over
// all 9 taps (top rows, then bottom rows), rounded and added into tot; a
// part goes back once its last pass has read it.  Stage 2's x slice then
// leaves c2's skip in P.
template <int T, int I>
__device__ __forceinline__ void slice(float (&tot)[kKR][kN / 2], float (&P)[kKR][kN / 2],
                                      const Parts& pt, int& j, uint64_t wdesc0, int warp,
                                      int lane) {
  constexpr int kPieces = slice_pieces(T, I);
  constexpr int kKS = slice_ks(T, I);
  constexpr bool kSkip = T == 2 && slice_src(T, I) == 0;
  constexpr bool kFree = kPieces == 1 && !kSkip;
  const uint64_t wd = wdesc0 + (uint64_t)((I * 9 * kTap) >> 4);
  zero(P);
  mbar_wait(pt.full, j & 1);
  rows_mma<kN, kKR, kKS, 0, kRows>(P, pt.top, wd, warp, lane);
  if (kFree) release(pt.empty);
  mbar_wait(pt.full + 8, j & 1);
  rows_mma<kN, kKR, kKS, kRows, kKR + 2>(P, pt.bottom, wd, warp, lane);
  if (kFree) release(pt.empty + 8);
  add_piece<I == 0>(tot, P);
  if constexpr (kPieces == 2) {
    zero(P);
    rows_mma<kN, kKR, 2, 0, kRows, 2>(P, pt.top, wd, warp, lane);
    release(pt.empty);
    rows_mma<kN, kKR, 2, kRows, kKR + 2, 2>(P, pt.bottom, wd, warp, lane);
    release(pt.empty + 8);
    add_piece<false>(tot, P);
  }
  if constexpr (kSkip) {
    const uint64_t sd = wdesc0 + (uint64_t)((nslices(T) * 9 * kTap) >> 4);
    zero(P);
    centre_mma<0, kRows>(P, pt.top, sd, warp, lane);
    release(pt.empty);
    centre_mma<kRows, kKR + 2>(P, pt.bottom, sd, warp, lane);
    release(pt.empty + 8);
  }
  ++j;
}

// Stage T's epilogue for one tile: per output pixel and channel pair (the
// accumulators' layout: row g + 8 * half of the warp's 16, columns 8 k + 2 q
// and + 1), bias, lrelu and the stage's adds in f32, one rounding; a quad
// transpose gives each thread 8 channels of one pixel for one 16-byte store,
// masked to the frame.  Stage 5 reads x the same way, transposed back.
template <int T>
__device__ __forceinline__ void epilogue(const float (&tot)[kKR][kN / 2],
                                         const float (&P)[kKR][kN / 2], const float* cs,
                                         float slope, int chunk, TileAt at, int h, int w,
                                         int warp, int lane,
                                         const __nv_bfloat16* __restrict__ x,
                                         __nv_bfloat16* __restrict__ scratch,
                                         float* __restrict__ c2f,
                                         __nv_bfloat16* __restrict__ out) {
  const int g = lane >> 2;
  const int q = lane & 3;
#pragma unroll
  for (int r = 0; r < kKR; ++r) {
    const int oy = at.y0 + r;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int ox = at.x0 + warp * 16 + g + 8 * half;
      const bool inside = oy < h && ox < w;
      const size_t pix = ((size_t)at.f * h + oy) * w + ox;
      uint4 xt = make_uint4(0u, 0u, 0u, 0u);
      if constexpr (T == 5) {
        uint4 xr = make_uint4(0u, 0u, 0u, 0u);
        if (inside) xr = *reinterpret_cast<const uint4*>(x + pix * kNF + chunk * kN + 8 * q);
        const uint32_t xw[4] = {xr.x, xr.y, xr.z, xr.w};
        xt = quad_transpose(xw, q, lane);
      }
      const uint32_t xs[4] = {xt.x, xt.y, xt.z, xt.w};
      uint32_t word[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int i0 = 4 * k + 2 * half;
        const int col = 8 * k + 2 * q;
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          v[e] = __fadd_rn(tot[r][i0 + e], cs[col + e]);
          if constexpr (T < 5) v[e] = leaky(v[e], slope);
          if constexpr (T == 2) v[e] = __fadd_rn(v[e], __fadd_rn(P[r][i0 + e], cs[kN + col + e]));
        }
        if constexpr (T == 2) {
          if (inside) {
            *reinterpret_cast<float2*>(c2f + pix * kGC + col) = make_float2(v[0], v[1]);
          }
        }
        if constexpr (T == 4) {
          if (inside) {
            const float2 c2 = *reinterpret_cast<const float2*>(c2f + pix * kGC + col);
            v[0] = __fadd_rn(v[0], c2.x);
            v[1] = __fadd_rn(v[1], c2.y);
          }
        }
        if constexpr (T == 5) {
          const __nv_bfloat162 xv = *reinterpret_cast<const __nv_bfloat162*>(&xs[k]);
          v[0] = __fadd_rn(__low2float(xv), __fmul_rn(0.2f, v[0]));
          v[1] = __fadd_rn(__high2float(xv), __fmul_rn(0.2f, v[1]));
        }
        const __nv_bfloat162 o = __floats2bfloat162_rn(v[0], v[1]);
        word[k] = *reinterpret_cast<const uint32_t*>(&o);
      }
      const uint4 o = quad_transpose(word, q, lane);
      if (inside) {
        if constexpr (T == 5) {
          *reinterpret_cast<uint4*>(out + pix * kNF + chunk * kN + 8 * q) = o;
        } else {
          *reinterpret_cast<uint4*>(scratch + pix * kScratch + (T - 1) * kGC + 8 * q) = o;
        }
      }
    }
  }
}

// Stage T over the batch.  x_map reads x (64 channels), s_map the scratch's
// first 32 (T - 1) channels; wpack is this stage's part of the pack.
template <int T>
__global__ void __launch_bounds__(threads(wgs(T)), 1)
rdb_block_sm90_kernel(const __grid_constant__ CUtensorMap x_map,
                      const __grid_constant__ CUtensorMap s_map,
                      const __nv_bfloat16* __restrict__ x,
                      __nv_bfloat16* __restrict__ scratch, float* __restrict__ c2f,
                      __nv_bfloat16* __restrict__ out, const uint4* __restrict__ wpack,
                      const float* __restrict__ bpack, float slope, int h, int w,
                      int ntiles) {
  constexpr int kWGs = wgs(T);
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* sm = smem_raw + (base - raw);
  const uint32_t parts = base + wbytes(T);
  // full[c][p], then empty[c][p]: one pair per consumer c and part p
  const uint32_t bars = parts + kWGs * kParts * kPart;
  float* cs = reinterpret_cast<float*>(sm + (bars - base) + 2 * kWGs * kParts * 8);
  const int chunk = blockIdx.x % chunks(T);
  const int first = blockIdx.x / chunks(T);  // the block's first tile
  const int step = gridDim.x / chunks(T);    // tiles between a block's turns
  const int ncol = (w + kTW - 1) / kTW;
  const int nband = (h + kKR - 1) / kKR;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int i = 0; i < kWGs * kParts; ++i) {
      mbar_init(bars + 8 * i, 1);
      mbar_init(bars + 8 * (kWGs * kParts + i), 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // resident weights: the chunk's pack, 16 bytes (8 channels of one line)
  // at a time, into each slice's tap blocks (K-major, 128-byte swizzle);
  // a 32-channel slice fills half of each line
  const uint4* src = wpack + chunk * (chunk_numel(T) / 8);
  for (int i = 0, off = 0; i <= nslices(T); ++i) {
    const bool skip = i == nslices(T);
    if (skip && T != 2) break;
    const int kv = (skip ? kNF : slice_channels(T, i)) / 8;
    const int count = (skip ? 1 : 9) * kN * kv;
    for (int e = tid; e < count; e += threads(kWGs)) {
      const int n = (e / kv) % kN;
      const int tap = e / (kv * kN);
      *reinterpret_cast<uint4*>(sm + (i * 9 + tap) * kTap + swz(n, e % kv)) = src[off + e];
    }
    off += count;
  }
  if (tid < kN) {
    cs[tid] = bpack[(T - 1) * kGC + chunk * kN + tid];
    cs[kN + tid] = T == 2 ? bpack[4 * kGC + kNF + tid] : 0.0f;
  }
  fence_async_smem();
  __syncthreads();

  if (tid >= kWGs * 128) {  // producer warpgroup: lane 0 of warp c fills consumer c's parts
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(producer_regs(T)) : "memory");
    const int c = (tid >> 5) & 3;
    if ((tid & 31) == 0 && c < kWGs) {
      int j = 0;
      for (int t = first + c * step; t < ntiles; t += kWGs * step) {
        const int col = t % ncol;
        const int band = (t / ncol) % nband;
        const int f = t / (ncol * nband);
        for (int i = 0; i < nslices(T); ++i, ++j) {
          const bool xs = slice_src(T, i) == 0;
          const CUtensorMap* map = xs ? &x_map : &s_map;
#pragma unroll
          for (int p = 0; p < kParts; ++p) {
            const int b = c * kParts + p;
            if (j > 0) mbar_wait(bars + 8 * (kWGs * kParts + b), (j - 1) & 1);
            mbar_expect_tx(bars + 8 * b, part_tx(kKR));
            // the box starts one pixel up and left of the tile: TMA
            // zero-fills the border
            tma_load_4d(parts + b * kPart, map, bars + 8 * b, slice_offset(T, i),
                        col * kTW - 1, band * kKR - 1 + p * kRows, f);
          }
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(consumer_regs(T)) : "memory");

  // consumer warpgroup c takes every kWGs-th tile of the block's walk
  const int c = tid >> 7;
  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  Parts pt;
  pt.top = parts + c * kParts * kPart;
  pt.bottom = pt.top + kPart;
  pt.full = bars + 8 * c * kParts;
  pt.empty = pt.full + 8 * kWGs * kParts;
  const uint64_t wdesc0 = desc_sw128(base);
  int j = 0;
  for (int t = first + c * step; t < ntiles; t += kWGs * step) {
    float tot[kKR][kN / 2];
    float P[kKR][kN / 2];
    slice<T, 0>(tot, P, pt, j, wdesc0, warp, lane);
    if constexpr (nslices(T) > 1) slice<T, 1>(tot, P, pt, j, wdesc0, warp, lane);
    if constexpr (nslices(T) > 2) slice<T, 2>(tot, P, pt, j, wdesc0, warp, lane);
    const TileAt at{t / (ncol * nband), (t / ncol) % nband * kKR, t % ncol * kTW};
    epilogue<T>(tot, P, cs, slope, chunk, at, h, w, warp, lane, x, scratch, c2f, out);
  }
}

// Stage T's launch: one block per SM over all chunks, no more than the
// tiles; s_map over the scratch's first 32 (T - 1) channels (stage 1 reads
// none).
template <int T>
static int launch_stage(const CUtensorMap& x_map, const void* x, void* scratch,
                        void* c2f, void* out, const void* wstream, const void* bpack,
                        int n, int h, int w, float slope, int sms, cudaStream_t stream) {
  CUtensorMap s_map = x_map;
  if (T > 1) {
    const int code = encode_halo<kKR>(&s_map, scratch, n, h, w, (T - 1) * kGC, kScratch);
    if (code != (int)cudaSuccess) return code;
  }
  const long long tiles = (long long)n * ((h + kKR - 1) / kKR) * ((w + kTW - 1) / kTW);
  long long lanes = sms / chunks(T) > 0 ? sms / chunks(T) : 1;
  if (lanes > tiles) lanes = tiles;
  const int grid = (int)lanes * chunks(T);
  cudaError_t err = cudaFuncSetAttribute(
      rdb_block_sm90_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem(T));
  if (err != cudaSuccess) return (int)err;
  rdb_block_sm90_kernel<T><<<grid, threads(wgs(T)), smem(T), stream>>>(
      x_map, s_map, static_cast<const __nv_bfloat16*>(x),
      static_cast<__nv_bfloat16*>(scratch), static_cast<float*>(c2f),
      static_cast<__nv_bfloat16*>(out),
      reinterpret_cast<const uint4*>(static_cast<const __nv_bfloat16*>(wstream) +
                                     stage_offset(T)),
      static_cast<const float*>(bpack), slope, h, w, (int)tiles);
  return (int)cudaGetLastError();
}

}  // namespace uvt_rdb_sm90

extern "C" {

// One dense block on the Hopper kernels: five launches on `stream`.  x and
// out (N, h, w, 64) bf16, contiguous, distinct; wstream the 241,664 bf16 of
// ops/rdb.py:pack_rdb_weights_sm90; bpack (224,) f32 as packed by
// ops/rdb.py; scratch (N, h, w, 128) bf16 and c2f (N, h, w, 32) f32, any
// contents; every pointer 16-byte aligned.  Returns a cudaError_t code
// (cudaErrorInvalidValue for a shape it does not take or a tensor map
// cuTensorMapEncodeTiled refuses).
int uvt_rdb_block_sm90(const void* x, void* out, const void* wstream,
                       const void* bpack, void* scratch, void* c2f, int n, int h,
                       int w, float slope, void* stream) {
  using namespace uvt_rdb_sm90;
  const long long tiles = (long long)n * ((h + kKR - 1) / kKR) * ((w + kTW - 1) / kTW);
  if (n < 1 || h < 1 || w < 1 || tiles > 0x7fffffff ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(wstream) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(scratch) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(c2f) % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int sms = sm_count();
  if (sms < 0) return -sms;
  CUtensorMap x_map;
  int code = encode_halo<kKR>(&x_map, x, n, h, w, kNF, kNF);
  if (code != (int)cudaSuccess) return code;
  const decltype(&launch_stage<1>) stages[5] = {launch_stage<1>, launch_stage<2>,
                                                 launch_stage<3>, launch_stage<4>,
                                                 launch_stage<5>};
  for (const auto launch : stages) {
    code = launch(x_map, x, scratch, c2f, out, wstream, bpack, n, h, w, slope, sms,
                  static_cast<cudaStream_t>(stream));
    if (code != (int)cudaSuccess) return code;
  }
  return code;
}

}  // extern "C"
