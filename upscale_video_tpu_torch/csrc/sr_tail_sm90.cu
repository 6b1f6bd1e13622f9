// K2 and K3 on Hopper: the fused SRVGG tail as persistent, warp-specialised
// wgmma kernels (sm_90a) with one shared epilogue.
//
// K2 (uvt_sr_tail_sm90) replaces upscale_video_tpu/ops/tail_pallas.py:155
// (_tail_chain_kernel, reached via sr_tail_fused_chain) for Cf = 64 at
// s = 2 and 4: from the conv chain's bordered bf16 buffer (N, H+2, W+2, 64)
// with its zero ring.  K3 (uvt_sr_tail_plain_sm90) replaces
// tail_pallas.py:31 (_tail_kernel, reached via sr_tail_fused /
// sr_tail_fused_batch) for cin a multiple of 32 in 32..192 at s = 2 and 4:
// from a plain (N, H, W, cin) bf16 activation.  Every other shape stays on
// sr_tail.cu (WMMA); ops/tail.py picks by shape.  Both compute what the
// WMMA kernels compute: per low-res pixel the tail conv Cf -> 3*s*s as
// bf16 x bf16 products summed in f32, + the f32 bias, + the bf16-rounded
// skip taken as f32 (channel k = c*s*s + a*s + b takes skip channel c: the
// pixel shuffle's order), then one of four layouts:
//
//   0 planar : uint8 (N, H, W, 3*s*s), (a, b, c) order with c fastest and
//              BGR->RGB folded in;
//   1 frames : uint8 (N, s*H, s*W, 3) RGB;
//   2 model  : float32 (N, s*H, s*W, 3) in the BGR model domain;
//   3 yuv420 : uint8 (N, H, W, s*s + 2*(s/2)^2), the packed 4:2:0 contract
//              of ops/yuv.py:yuv420_from_planar (BT.601, full or limited
//              range), from the planar u8 values.
//
// The u8 epilogue is clip(rint(v * 255), 0, 255) (rintf rounds half to even
// like torch.round).  The 4:2:0 arithmetic is yuv420_from_planar's, in its
// order, each step one f32 rounding (__fmul_rn / __fadd_rn / __fsub_rn, so
// nvcc contracts nothing into an FMA), its constants doubles rounded once
// to f32 as torch rounds a Python scalar; the 2x2 chroma mean sums in the
// order torch's mean takes on the card (see chroma_mean), then scales by
// 1/4.
//
// Bound on the H100.  K2 at s = 2: 13,824 FLOP per low-res pixel against
// ~146 bytes (128 read from the chain buffer, 6 of skip, 12 written), ~95
// FLOP/byte, under the bf16 ridge (~295): bytes.  The 4:2:0 layout writes 6
// bytes a pixel instead of 12.  K3 at 160 -> 48 (the nf-160 4x import):
// 138,240 FLOP per pixel against 374 bytes, ~370 FLOP/byte: operations.
//
// Design.
// - K2 runs K1's narrow mainloop (conv3x3_ring_sm90.cuh): persistent
//   blocks, a producer warpgroup keeping a TMA halo ring over the bordered
//   buffer full, two consumers with dx folded into K (K = 192 per dy),
//   resident weights in the B128 image (ops/conv_chain.py:pack_ring_weights,
//   packed once at plan time), wgmma m64n16k16 (s = 2, 12 columns used) or
//   m64n48k16 (s = 4) with A loaded by ldmatrix.  4 output rows per tile
//   at s = 2, 2 at s = 4 (its 48 accumulators beside the double-buffered A
//   of 12 k steps).
// - K3 runs K4's mainloop (conv3x3_halo_sm90.cuh): TMA boxes starting at
//   (x0 - 1, y0 - 1) so zero fill makes the SAME border, 64-channel
//   swizzled slices (a last slice of 32 channels issues only its valid k
//   steps), a row-split halo double buffer per consumer, every column's
//   weights resident (N = 16 at s = 2, 48 at s = 4: one chunk, so a block
//   holds whole output pixels for the 4:2:0 pack).  Plans within 232,448
//   bytes: s = 2 at 6 rows per tile, two consumers (8 rows spilled); s = 4
//   at 4 rows, two consumers up to cin 128 and one above (166 KB of
//   weights leave room for one consumer's two parts).
// - The epilogue (TailEpi) is shared: each consumer loads its next tile's
//   skip rows (6 bytes a pixel: no TMA-friendly pitch) during this tile's
//   epilogue, as coalesced 4-byte cp.async words into a double buffer of
//   its own (values held in registers across the MMAs measured slower);
//   then per output row it computes the row's values in registers
//   (every shared load before any store), stages the layout's row in
//   shared memory (planar u8; for f32 one high-res row at a time; for
//   yuv420 the 4:2:0 record straight from the values, quad shuffles
//   pairing the lanes of each 2x2 chroma box), and writes it with 16-byte
//   stores (bytes only at a row's unaligned ends).  K2 stages over
//   its tile's halo stage, K3 in a stage of its own; one kernel per layout.

#include "conv3x3_halo_sm90.cuh"
#include "conv3x3_ring_sm90.cuh"

namespace uvt_tail_sm90 {

using namespace uvt_sm90_common;

constexpr int kTW = 64;  // output columns per tile: both mainloops' wgmma M
constexpr int kPlanar = 0;
constexpr int kFrames = 1;
constexpr int kModel = 2;
constexpr int kYuv420 = 3;

// ops/yuv.py's BT.601 constants, each a double rounded once to f32
constexpr float kKr = (float)0.299;
constexpr float kKg = (float)0.587;
constexpr float kKb = (float)0.114;
constexpr float kCbK = (float)(0.5 / (1.0 - 0.114));
constexpr float kCrK = (float)(0.5 / (1.0 - 0.299));
constexpr float kYScale = (float)(219.0 / 255.0);
constexpr float kCScale = (float)(224.0 / 255.0);

constexpr int round16(int v) { return (v + 15) / 16 * 16; }
constexpr int max_of(int a, int b) { return a > b ? a : b; }

// clip(rint(v), 0, 255) as one convert (round half to even, saturating)
__device__ __forceinline__ unsigned char quant(float v) {
  unsigned short u;
  asm("cvt.rni.sat.u8.f32 %0, %1;" : "=h"(u) : "f"(v));
  return static_cast<unsigned char>(u);
}

// the BT.601 encode of one u8 RGB value (ops/yuv.py:_encode, its order):
// y, and the centred cb, cr (before the 2x2 mean and the +128)
__device__ __forceinline__ void encode(float r, float g, float b, bool full, float& y,
                                       float& cb, float& cr) {
  y = __fadd_rn(__fadd_rn(__fmul_rn(kKr, r), __fmul_rn(kKg, g)), __fmul_rn(kKb, b));
  cb = __fmul_rn(__fsub_rn(b, y), kCbK);
  cr = __fmul_rn(__fsub_rn(r, y), kCrK);
  if (!full) {
    y = __fadd_rn(__fmul_rn(y, kYScale), 16.0f);
    cb = __fmul_rn(cb, kCScale);
    cr = __fmul_rn(cr, kCScale);
  }
}

// The mean of a 2x2 chroma box (c00, c01 its top row) as torch's mean
// over the box's two axes takes it on the card (measured on an H100: equal
// for every box of 4x1080p at s = 2 and 4): each column's two rows summed,
// then the two columns, then scaled by 1/4.
__device__ __forceinline__ float chroma_mean(float c00, float c01, float c10, float c11) {
  return __fmul_rn(__fadd_rn(__fadd_rn(c00, c10), __fadd_rn(c01, c11)), 0.25f);
}

// Copies len bytes from shared memory to dst (any alignment): src[i] is
// dst[i], and src sits at the same offset modulo 16 as dst, so the middle
// goes as 16-byte loads and stores and only the ends byte by byte.  All
// 128 threads of the warpgroup call it.
__device__ __forceinline__ void copy_line(unsigned char* dst, const unsigned char* src,
                                          int len, int wt) {
  const int head =
      min((int)((16u - (reinterpret_cast<uintptr_t>(dst) & 15u)) & 15u), len);
  const int nv = (len - head) >> 4;
  for (int i = wt; i < nv; i += 128) {
    *reinterpret_cast<uint4*>(dst + head + 16 * i) =
        *reinterpret_cast<const uint4*>(src + head + 16 * i);
  }
  const int tail0 = head + 16 * nv;
  for (int i = wt; i < len - 16 * nv; i += 128) {
    const int b = i < head ? i : tail0 + (i - head);
    dst[b] = src[b];
  }
}

// The tail's epilogue for one tile of R output rows x 64 output columns,
// the accumulators holding NP >= 3*S*S columns in shuffle order (k =
// c*S*S + a*S + b), writing layout L one output row at a time (f32 one
// high-res row at a time).  Works on both mainloops (their E interface).
// The layout is a template parameter: one kernel per layout keeps each
// kernel's code small (the two consumers run different parts of it at
// once).
template <int S, int NP, int R, int L>
struct TailEpi {
  static constexpr int kS2 = S * S;
  static constexpr int kCout = 3 * kS2;
  static constexpr int kCs = S / 2;                   // chroma boxes per side
  static constexpr int kYuv = kS2 + 2 * kCs * kCs;    // 4:2:0 bytes per pixel
  // a row's skip: 64 pixels of 3 bf16 from the 4-byte word holding its
  // first byte, so 97 words
  static constexpr int kSkipWords = kTW * 3 / 2 + 1;
  static constexpr int kSkipRow = kSkipWords * 4;
  static constexpr int kSkipBuf = round16(R * kSkipRow);
  static constexpr int kSideBytes = 2 * kSkipBuf;     // the skip, double buffered
  static constexpr int kLineP = kTW * kCout + 16;     // one output row, planar u8
  static constexpr int kLineY = kTW * kYuv + 16;      // one output row, 4:2:0
  static constexpr int kLineM = kTW * S * 12 + 16;    // one high-res row, f32
  static constexpr int kRec = L == kYuv420 ? kYuv : kCout;  // bytes a pixel of L
  static constexpr int kOutBytes = round16(max_of(max_of(kLineP, kLineY), kLineM));
  static_assert(NP >= kCout && NP % 8 == 0, "the columns must hold the tail");
  static_assert(S % 2 == 0, "the 4:2:0 pack needs an even scale");

  const unsigned short* skip;  // (N, h, w, 3) bf16 bits
  const float* bias;
  unsigned char* out;
  int h, w, full;

  __device__ __forceinline__ void consts(float* cs, int, int tid) const {
    if (tid < NP) cs[tid] = tid < kCout ? bias[tid] : 0.0f;
  }

  // the byte offset of row y's skip segment (pixels x0.. of frame f)
  __device__ __forceinline__ size_t skip_at(int f, int y, int x0) const {
    return (((size_t)f * h + y) * w + x0) * 6;
  }

  // output row r's skip in side buffer sb (y = y0 + r)
  __device__ __forceinline__ const __nv_bfloat16* skip_row(const unsigned char* sb, int r,
                                                           int f, int y, int x0) const {
    return reinterpret_cast<const __nv_bfloat16*>(sb + r * kSkipRow +
                                                  (skip_at(f, y, x0) & 3));
  }

  // the tile's skip rows into side buffer slot: per row the 4-byte words
  // that hold its pixels inside the frame, by cp.async (coalesced; a word
  // at either end may hold a neighbour's bytes, never read)
  __device__ __forceinline__ void prefetch(unsigned char* side, bool valid, TileAt at,
                                           int slot, int wt) const {
    if (valid) {
      const uint32_t buf = smem_u32(side + slot * kSkipBuf);
      const unsigned char* base = reinterpret_cast<const unsigned char*>(skip);
      const int nv = min(kTW, w - at.x0);
      for (int i = wt; i < R * kSkipWords; i += 128) {
        const int r = i / kSkipWords;
        const int word = i - r * kSkipWords;
        if (at.y0 + r < h) {
          const size_t start = skip_at(at.f, at.y0 + r, at.x0);
          const size_t a = (start & ~(size_t)3) + 4 * word;
          if (a < start + nv * 6) cp_async4(buf + r * kSkipRow + 4 * word, base + a);
        }
      }
    }
    cp_async_commit();
  }

  // Accumulator column k = 8j + 2q + e (j < NP/8, e < 2) of lane q is
  // position k % S² (a = pos / S, b = pos % S) of colour c = k / S² (the
  // model domain's BGR order): at S = 4, pos = 8 (j & 1) + 2q + e and
  // c = j >> 1; at S = 2, pos = 2 (q & 1) + e and c = 2j + (q >> 1) (real
  // for j = 0, or q < 2).  Its planar byte pos * 3 + 2 - c splits into a
  // lane part and a compile-time part.
  static __device__ __forceinline__ bool real(int j, int q) {
    return S == 4 || j == 0 || q < 2;
  }
  static __device__ __forceinline__ int lane_byte(int q) {
    return S == 4 ? 6 * q + 2 : 6 * (q & 1) + 2 - (q >> 1);
  }
  static __host__ __device__ constexpr int col_byte(int j, int e) {
    return S == 4 ? 24 * (j & 1) + 3 * e - (j >> 1) : 3 * e - 2 * j;
  }

  // output row r's values of the thread's two pixels in registers: v =
  // (acc + bias) + skip, in the plain version's order.  Every shared load
  // (skip) is issued before any store of the row, so none waits behind a
  // possibly aliasing store.
  __device__ __forceinline__ void row_values(float (&v)[2][NP / 4],
                                             const float (&acc)[NP / 2],
                                             const float (&bj)[NP / 4],
                                             const __nv_bfloat16* sk, int pxa,
                                             int q) const {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const __nv_bfloat16* sp = sk + (pxa + 8 * half) * 3;
      const float s0 = __bfloat162float(sp[0]);
      const float s1 = __bfloat162float(sp[1]);
      const float s2 = __bfloat162float(sp[2]);
      const float sq = (q >> 1) ? s1 : s0;  // S = 2, j = 0: colour q >> 1
#pragma unroll
      for (int j = 0; j < NP / 8; ++j) {
        const float sv = S == 4 ? ((j >> 1) == 0 ? s0 : (j >> 1) == 1 ? s1 : s2)
                                : (j == 0 ? sq : s2);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          v[half][2 * j + e] =
              __fadd_rn(__fadd_rn(acc[4 * j + 2 * half + e], bj[2 * j + e]), sv);
        }
      }
    }
  }

  // The packed 4:2:0 records of the thread's two pixels from row values v,
  // into the stage row ys (kYuv bytes a pixel), straight from registers:
  // each colour value is quantised to u8 as the planar layout does, then
  // encoded; the 2x2 chroma boxes pair lanes by shuffle (S = 2: lane q ^ 2
  // holds green, lane q ^ 1 the box's other row; S = 4: lane q ^ 2 the
  // box's other row).
  __device__ __forceinline__ void pack_yuv(const float (&v)[2][NP / 4],
                                           unsigned char* ys, int pxa, int q) const {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      unsigned char* yp = ys + (pxa + 8 * half) * kYuv;
      float u8[NP / 4];  // the planar u8 values, as f32
#pragma unroll
      for (int i = 0; i < NP / 4; ++i) u8[i] = quant(__fmul_rn(v[half][i], 255.0f));
      if constexpr (S == 2) {
        // lanes 0 and 1 hold blue (j 0) and red (j 1) of positions 2q, 2q + 1;
        // green is lane q ^ 2's j 0
        float y[2], cb[2], cr[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float g = __shfl_xor_sync(0xffffffffu, u8[e], 2);
          encode(u8[2 + e], g, u8[e], full, y[e], cb[e], cr[e]);
        }
        float ob[2], orr[2];  // the box's other row (lane q ^ 1)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          ob[e] = __shfl_xor_sync(0xffffffffu, cb[e], 1);
          orr[e] = __shfl_xor_sync(0xffffffffu, cr[e], 1);
        }
        if (q < 2) {
#pragma unroll
          for (int e = 0; e < 2; ++e) yp[2 * q + e] = quant(y[e]);
        }
        if (q == 0) {
          yp[4] = quant(__fadd_rn(chroma_mean(cb[0], cb[1], ob[0], ob[1]), 128.0f));
          yp[5] = quant(__fadd_rn(chroma_mean(cr[0], cr[1], orr[0], orr[1]), 128.0f));
        }
      } else {
        // lane q holds every colour of positions 8m + 2q + e (row a = 2m +
        // (q >> 1), box (m, q & 1)); lane q ^ 2 holds the box's other row
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          float y[2], cb[2], cr[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            encode(u8[2 * (4 + m) + e], u8[2 * (2 + m) + e], u8[2 * m + e], full, y[e],
                   cb[e], cr[e]);
            yp[8 * m + 2 * q + e] = quant(y[e]);
          }
          float ob[2], orr[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            ob[e] = __shfl_xor_sync(0xffffffffu, cb[e], 2);
            orr[e] = __shfl_xor_sync(0xffffffffu, cr[e], 2);
          }
          if ((q >> 1) == 0) {  // the box's top row: c00, c01 its own
            const int box = 2 * m + (q & 1);
            yp[kS2 + box] =
                quant(__fadd_rn(chroma_mean(cb[0], cb[1], ob[0], ob[1]), 128.0f));
            yp[kS2 + 4 + box] =
                quant(__fadd_rn(chroma_mean(cr[0], cr[1], orr[0], orr[1]), 128.0f));
          }
        }
      }
    }
  }

  __device__ __forceinline__ void store(float (&acc)[R][NP / 2], unsigned char* side,
                                        unsigned char* row, const float* cs, int,
                                        TileAt at, int slot, int c, int warp, int lane,
                                        int wt) const {
    const int f = at.f;
    const int y0 = at.y0;
    const int x0 = at.x0;
    const unsigned char* sb = side + slot * kSkipBuf;
    const int g = lane >> 2;
    const int q = lane & 3;
    const int pxa = warp * 16 + g;    // the thread's pixels: pxa, pxa + 8
    const int nv = min(kTW, w - x0);  // the tile's pixels inside the frame
    float bj[NP / 4];                 // the bias of the thread's columns
#pragma unroll
    for (int i = 0; i < NP / 4; ++i) bj[i] = cs[8 * (i / 2) + 2 * q + i % 2];
    cp_async_wait<1>();  // this tile's skip (the next tile's may be in flight)
    bar_sync(1 + c, 128);
    if constexpr (L == kModel) {
      store_model(acc, sb, bj, f, y0, x0, c, pxa, q, nv, wt, row);
    } else {
      store_u8(acc, sb, bj, f, y0, x0, c, pxa, q, nv, wt, row);
    }
  }

 private:
  // f32: one high-res row a at a time: pixel px, b -> (px * S + b) * 3 + c
  __device__ __forceinline__ void store_model(float (&acc)[R][NP / 2],
                                              const unsigned char* sb,
                                              const float (&bj)[NP / 4], int f, int y0,
                                              int x0, int c, int pxa, int q, int nv,
                                              int wt, unsigned char* row) const {
    const size_t sw = (size_t)w * S;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int y = y0 + r;
      if (y >= h) continue;
      float v[2][NP / 4];
      row_values(v, acc[r], bj, skip_row(sb, r, f, y, x0), pxa, q);
      for (int a = 0; a < S; ++a) {
        unsigned char* dst =
            out + ((((size_t)f * h + y) * S + a) * sw + (size_t)x0 * S) * 12;
        float* ms =
            reinterpret_cast<float*>(row + (reinterpret_cast<uintptr_t>(dst) & 15u));
#pragma unroll
        for (int half = 0; half < 2; ++half) {
#pragma unroll
          for (int j = 0; j < NP / 8; ++j) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int ka = S == 4 ? 2 * (j & 1) + (q >> 1) : (q & 1);
              const int kb = S == 4 ? 2 * (q & 1) + e : e;
              const int kc = S == 4 ? (j >> 1) : 2 * j + (q >> 1);
              if (real(j, q) && ka == a) {
                ms[((pxa + 8 * half) * S + kb) * 3 + kc] = v[half][2 * j + e];
              }
            }
          }
        }
        bar_sync(1 + c, 128);
        copy_line(dst, reinterpret_cast<const unsigned char*>(ms), nv * S * 12, wt);
        bar_sync(1 + c, 128);
      }
    }
  }

  // u8: each output row into the stage at its output row's offset modulo
  // 16 (frames reads the planar row, so unshifted), then its stores
  __device__ __forceinline__ void store_u8(float (&acc)[R][NP / 2], const unsigned char* sb,
                                           const float (&bj)[NP / 4], int f, int y0,
                                           int x0, int c, int pxa, int q, int nv, int wt,
                                           unsigned char* row) const {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int y = y0 + r;
      if (y >= h) continue;
      float v[2][NP / 4];
      row_values(v, acc[r], bj, skip_row(sb, r, f, y, x0), pxa, q);
      unsigned char* dst = out + (((size_t)f * h + y) * w + x0) * kRec;
      unsigned char* st =
          row + (L == kFrames ? 0u : reinterpret_cast<uintptr_t>(dst) & 15u);
      if constexpr (L == kYuv420) {
        pack_yuv(v, st, pxa, q);
      } else {
        // the planar u8 row: pixel px, position (a, b), colour 2 - c
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          unsigned char* pp = st + (pxa + 8 * half) * kCout + lane_byte(q);
#pragma unroll
          for (int j = 0; j < NP / 8; ++j) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              if (real(j, q)) {
                pp[col_byte(j, e)] = quant(__fmul_rn(v[half][2 * j + e], 255.0f));
              }
            }
          }
        }
      }
      bar_sync(1 + c, 128);
      if constexpr (L != kFrames) {
        copy_line(dst, st, nv * kRec, wt);
      } else {
        gather_frames(st, f, y, x0, nv, wt);
      }
      bar_sync(1 + c, 128);
    }
  }

  // frames: high-res row a of output row y is, per pixel, the planar bytes
  // [a * 3S, (a + 1) * 3S) of its staged row st; gathered into 16-byte
  // stores (bytes only at the row's unaligned ends)
  __device__ __forceinline__ void gather_frames(const unsigned char* st, int f, int y,
                                                int x0, int nv, int wt) const {
    const size_t sw = (size_t)w * S;
    const int len = nv * S * 3;
    for (int a = 0; a < S; ++a) {
      unsigned char* fd = out + ((((size_t)f * h + y) * S + a) * sw + (size_t)x0 * S) * 3;
      const int head = min((int)((16u - (reinterpret_cast<uintptr_t>(fd) & 15u)) & 15u), len);
      const int n16 = (len - head) >> 4;
      for (int i = wt; i < len - 15 * n16; i += 128) {
        if (i < n16) {
          __align__(16) unsigned char b16[16];
#pragma unroll
          for (int t = 0; t < 16; ++t) {
            const int b = head + 16 * i + t;
            const int px = b / (3 * S);
            b16[t] = st[px * kCout + a * 3 * S + (b - px * 3 * S)];
          }
          *reinterpret_cast<uint4*>(fd + head + 16 * i) = *reinterpret_cast<const uint4*>(b16);
        } else {
          const int o = i - n16;
          const int b = o < head ? o : head + 16 * n16 + (o - head);
          const int px = b / (3 * S);
          fd[b] = st[px * kCout + a * 3 * S + (b - px * 3 * S)];
        }
      }
    }
  }
};

// K2: the ring over the bordered (N, h+2, w+2, 64) buffer.
template <int S, int NP, int R, int L>
__global__ void __launch_bounds__(uvt_ring::kThreads, 1)
sr_tail_sm90_kernel(const __grid_constant__ CUtensorMap src_map,
                    const __nv_bfloat16* __restrict__ wpack,
                    const unsigned short* __restrict__ skip,
                    const float* __restrict__ bias, unsigned char* __restrict__ out,
                    int h, int w, int full, int ntiles) {
  const TailEpi<S, NP, R, L> epi{skip, bias, out, h, w, full};
  uvt_ring::ring_conv<64, NP, R>(src_map, wpack, h, w, ntiles, epi);
}

template <int S, int NP, int R, int L>
static int launch_chain(const void* src, const void* skip, const void* wpack,
                        const void* bias, void* out, int n, int h, int w, int full,
                        cudaStream_t stream) {
  return uvt_ring::launch_ring<64, NP, R, TailEpi<S, NP, R, L>>(
      sr_tail_sm90_kernel<S, NP, R, L>, src, n, h, w, stream,
      static_cast<const __nv_bfloat16*>(wpack), static_cast<const unsigned short*>(skip),
      static_cast<const float*>(bias), static_cast<unsigned char*>(out), h, w, full);
}

template <int S, int NP, int R>
static int run_chain(const void* src, const void* skip, const void* wpack,
                     const void* bias, void* out, int n, int h, int w, int layout,
                     int full, cudaStream_t stream) {
  switch (layout) {
    case kPlanar: return launch_chain<S, NP, R, kPlanar>(src, skip, wpack, bias, out, n, h, w, full, stream);
    case kFrames: return launch_chain<S, NP, R, kFrames>(src, skip, wpack, bias, out, n, h, w, full, stream);
    case kModel: return launch_chain<S, NP, R, kModel>(src, skip, wpack, bias, out, n, h, w, full, stream);
    default: return launch_chain<S, NP, R, kYuv420>(src, skip, wpack, bias, out, n, h, w, full, stream);
  }
}

// K3: the halo over the plain (N, h, w, cin) activation; one chunk of N
// columns, WGS consumers.
template <int S, int N, int KR, int WGS, int L>
__global__ void __launch_bounds__(uvt_halo::threads(2), 1)
sr_tail_plain_sm90_kernel(const __grid_constant__ CUtensorMap x_map,
                          const __nv_bfloat16* __restrict__ wmat,
                          const unsigned short* __restrict__ skip,
                          const float* __restrict__ bias,
                          unsigned char* __restrict__ out, int h, int w, int cin,
                          int full, int slices, int ntiles) {
  const TailEpi<S, N, KR, L> epi{skip, bias, out, h, w, full};
  uvt_halo::halo_conv<N, KR, WGS>(x_map, wmat, h, w, cin, 3 * S * S, slices, 1,
                                  ntiles, epi);
}

template <int S, int N, int KR, int WGS>
static int smem_plain(int slices) {
  using E = TailEpi<S, N, KR, kPlanar>;
  return uvt_halo::smem_bytes(N, KR, slices, WGS, E::kSideBytes + E::kOutBytes);
}

template <int S, int N, int KR, int WGS, int L>
static int launch_plain(const void* u, const void* skip, const void* wmat,
                        const void* bias, void* out, int n, int h, int w, int cin,
                        int full, cudaStream_t stream) {
  const int slices = (cin + uvt_halo::kSlice - 1) / uvt_halo::kSlice;
  const long long tiles = (long long)n * ((h + KR - 1) / KR) * ((w + kTW - 1) / kTW);
  if (tiles > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const int sms = uvt_halo::sm_count();
  if (sms < 0) return -sms;
  const int grid = (int)(tiles < sms ? tiles : sms);
  return uvt_halo::launch_halo<KR, WGS>(
      sr_tail_plain_sm90_kernel<S, N, KR, WGS, L>, u, n, h, w, cin, cin, grid,
      smem_plain<S, N, KR, WGS>(slices), stream,
      static_cast<const __nv_bfloat16*>(wmat), static_cast<const unsigned short*>(skip),
      static_cast<const float*>(bias), static_cast<unsigned char*>(out), h, w, cin, full,
      slices, (int)tiles);
}

template <int S, int N, int KR, int WGS>
static int run_plain(const void* u, const void* skip, const void* wmat,
                     const void* bias, void* out, int n, int h, int w, int cin,
                     int layout, int full, cudaStream_t stream) {
  switch (layout) {
    case kPlanar: return launch_plain<S, N, KR, WGS, kPlanar>(u, skip, wmat, bias, out, n, h, w, cin, full, stream);
    case kFrames: return launch_plain<S, N, KR, WGS, kFrames>(u, skip, wmat, bias, out, n, h, w, cin, full, stream);
    case kModel: return launch_plain<S, N, KR, WGS, kModel>(u, skip, wmat, bias, out, n, h, w, cin, full, stream);
    default: return launch_plain<S, N, KR, WGS, kYuv420>(u, skip, wmat, bias, out, n, h, w, cin, full, stream);
  }
}

static bool bad_common(int n, int h, int w, int scale, int layout, const void* skip,
                       const void* out) {
  return n < 1 || h < 1 || w < 1 || (scale != 2 && scale != 4) || layout < kPlanar ||
         layout > kYuv420 || reinterpret_cast<uintptr_t>(skip) % 4 != 0 ||
         (layout == kModel && reinterpret_cast<uintptr_t>(out) % 4 != 0);
}

}  // namespace uvt_tail_sm90

extern "C" {

// K2 on Hopper.  src (N, h+2, w+2, 64) bf16 with a zero ring, 16-byte
// aligned; skip (N, h, w, 3) bf16, 4-byte aligned; wpack the tail's packed weight image
// (ops/conv_chain.py:pack_ring_weights: 3 dy x 3 K atoms x NP lines x 128
// bytes, NP = 16 at s = 2, 48 at s = 4); bias (3*scale^2,) f32; out per
// layout (see above), full_range for yuv420.  Returns a cudaError_t code
// (cudaErrorInvalidValue for a shape it does not take or a tensor map
// cuTensorMapEncodeTiled refuses).
int uvt_sr_tail_sm90(const void* src, const void* skip, const void* wpack,
                     const void* bias, void* out, int n, int h, int w, int scale,
                     int layout, int full_range, void* stream) {
  using namespace uvt_tail_sm90;
  if (bad_common(n, h, w, scale, layout, skip, out) ||
      reinterpret_cast<uintptr_t>(src) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(wpack) % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (scale == 2) {
    return run_chain<2, 16, 4>(src, skip, wpack, bias, out, n, h, w, layout,
                                  full_range, s);
  }
  return run_chain<4, 48, 2>(src, skip, wpack, bias, out, n, h, w, layout,
                                full_range, s);
}

// K3 on Hopper.  u (N, h, w, cin) bf16, contiguous, 16-byte aligned, cin a
// multiple of 32 in 32..192; skip (N, h, w, 3) bf16, 4-byte aligned; wmat (9*cin,
// 3*scale^2) bf16 in (dy, dx, cin) row order; bias (3*scale^2,) f32; out
// per layout, full_range for yuv420.  Returns a cudaError_t code.
int uvt_sr_tail_plain_sm90(const void* u, const void* skip, const void* wmat,
                           const void* bias, void* out, int n, int h, int w, int cin,
                           int scale, int layout, int full_range, void* stream) {
  using namespace uvt_tail_sm90;
  if (bad_common(n, h, w, scale, layout, skip, out) || cin < 32 || cin % 32 != 0 ||
      cin > uvt_halo::kMaxSlices * uvt_halo::kSlice ||
      reinterpret_cast<uintptr_t>(u) % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int slices = (cin + uvt_halo::kSlice - 1) / uvt_halo::kSlice;
  const int limit = uvt_halo::kSmemLimit;
  if (scale == 2) {
    return run_plain<2, 16, 6, 2>(u, skip, wmat, bias, out, n, h, w, cin, layout, full_range, s);
  }
  if (smem_plain<4, 48, 4, 2>(slices) <= limit) {
    return run_plain<4, 48, 4, 2>(u, skip, wmat, bias, out, n, h, w, cin, layout, full_range, s);
  }
  return run_plain<4, 48, 4, 1>(u, skip, wmat, bias, out, n, h, w, cin, layout, full_range, s);
}

}  // extern "C"
