// K5: one Valar/ESRGAN residual dense block, fused, for Hopper (sm_90a).
//
// Replaces upscale_video_tpu/ops/rdb_pallas.py:_rdb_kernel (reached via
// rdb_apply_canvas -> _rdb_run_canvas on the product path, and rdb_apply ->
// _rdb_run).  One launch computes a whole dense block over a batch of
// (H, W, 64) bf16 frames:
//
//   c1 = lrelu(conv(x))
//   c2 = lrelu(conv(x, c1)) + conv1x1(x)
//   c3 = lrelu(conv(x, c1, c2))
//   c4 = lrelu(conv(x, c1, c2, c3)) + c2          (c2's f32 value)
//   c5 = conv(x, c1, c2, c3, c4)                  (no activation)
//   out = bf16(f32(x) + 0.2 * c5)
//
// Rounding points, kept from the TPU kernel (rdb_pallas.py:353-365,
// :412-452, :512-516): target t is the sum, in source order x, c1, c2, ...,
// of f32(bf16(P_s,t)), where P_s,t is source s convolved with its weight
// slice and accumulated in f32; then + bias.  Each source is accumulated
// into its own f32 fragment set, rounded to bf16 and only then added.  c1..c4
// take lrelu in f32, the c2 skip (bf16 operands, f32 accumulation, + its
// bias), and for c4 the f32 value of c2 before its rounding; every position
// outside the frame is zeroed (each ncnn conv is zero-padded); then one
// rounding to bf16.  Elementwise steps use __fadd_rn/__fmul_rn so that nvcc
// contracts none of them into an FMA the plain version does not do.
//
// Design: one thread block (8 warps) per 14x16 output tile.  The haloed x
// window (24x26x64, halo 5 = five 3x3 convs) and c1..c4 on their shrinking
// regions (22x24, 20x22, 18x20, 16x18, x32 channels) are staged in dynamic
// shared memory in bf16, with the f32 copy of c2 on c4's region beside
// them: 220,160 bytes, under the 227 KB a block may take.  None of the
// four 32-channel intermediates reaches device memory.  A 16x16 tile would
// need 242 KB with the f32 c2, so the tile is 14 rows high.  The TPU
// canvas, 128-lane padding, 8-column alignment, row3/pack12 im2col and the
// slab/off masks are TPU layout and are not carried over.
//
// Each stage is an implicit GEMM over its region's pixels, flattened and
// cut into 16-pixel M fragments: ldmatrix takes one address per row, so a
// fragment may wrap a region row and no pixel is computed twice.  Products
// run on the tensor cores as mma.sync m16n8k16 (bf16 x bf16 -> f32).  The
// per-target weight slices (483 KB per block in bf16) are read from global
// memory, where they stay L2-resident; shared memory holds no weights.
// Shared rows are XOR-swizzled by 16-byte chunk, so the eight row addresses
// of an ldmatrix fall in distinct bank groups.  Each warp pass takes four M
// fragments (two for c5, whose N is twice as wide), so every B fragment
// loaded from L2 feeds four MMAs; with one block per SM (its shared
// memory) a thread may hold up to 255 registers, which
// __launch_bounds__(256, 1) tells ptxas (it otherwise capped them at 128).
// Against two fragments per pass and the default bound this took 12.15 ms
// instead of 21.6 ms per launch over the 8 tiles of a 1080p frame, with
// bit-identical output (NVIDIA H100 80GB HBM3, 700 W).
//
// What bounds it on the H100: compute.  The block does 241,664 MAC per
// output pixel (3x3 convs 64,96,128,160 -> 32 and 192 -> 64, the 1x1 skip
// 64 -> 32) against 256 bytes of device traffic (128 read, 128 written):
// ~1,900 FLOP/byte, far above the bf16 ridge (~295).  The shrinking regions
// cost 1.37x the useful MACs at 14x16 (22x24 ... 14x16 pixels per stage).
// This first version runs one block per SM (its shared memory), mma.sync
// instead of wgmma and 32-bit L2 weight loads: simple and right first.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace uvt_rdb {

constexpr int kNF = 64;                 // trunk width (x, c5, out)
constexpr int kGC = 32;                 // growth channels (c1..c4)
constexpr int kTH = 14;                 // output rows per block
constexpr int kTW = 16;                 // output cols per block
constexpr int kHalo = 5;                // five 3x3 convs
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

// Region of stage t: t = 0 is the x window, t = 1..5 are c1..c5 (c5's
// region is the output tile).  Region t starts at window row/col t.
__host__ __device__ constexpr int reg_h(int t) { return kTH + 2 * kHalo - 2 * t; }
__host__ __device__ constexpr int reg_w(int t) { return kTW + 2 * kHalo - 2 * t; }
__host__ __device__ constexpr int reg_px(int t) { return reg_h(t) * reg_w(t); }

__host__ __device__ constexpr int src_ch(int s) { return s == 0 ? kNF : kGC; }
__host__ __device__ constexpr int src_choff(int s) {
  return s == 0 ? 0 : kNF + (s - 1) * kGC;
}
__host__ __device__ constexpr int tgt_n(int t) { return t == 5 ? kNF : kGC; }
__host__ __device__ constexpr int tgt_cin(int t) { return kNF + (t - 1) * kGC; }

// Packed weights (ops/rdb.py pack_rdb_weights): per target t = 1..5 the
// matrix WT_t (tgt_n(t), 9 * tgt_cin(t)) in bf16, row n holding, for each
// source s in order, its 9 * src_ch(s) values in (tap, channel) order;
// then the 1x1 skip transposed, (32, 64).
__host__ __device__ constexpr int w_off(int t) {
  return t <= 1 ? 0 : w_off(t - 1) + tgt_n(t - 1) * 9 * tgt_cin(t - 1);
}
constexpr int kSkipWOff = w_off(6);
constexpr int kWPackElems = kSkipWOff + kGC * kNF;  // 241,664
// Packed biases (f32): b1..b4 (32 each), b5 (64), skip bias (32).
__host__ __device__ constexpr int b_off(int t) { return (t - 1) * kGC; }
constexpr int kSkipBOff = b_off(5) + kNF;

// Shared-memory plan (bytes).  Every region is a multiple of 128 bytes.
constexpr int kXBytes = reg_px(0) * kNF * 2;
__host__ __device__ constexpr int c_off(int t) {
  return t <= 1 ? kXBytes : c_off(t - 1) + reg_px(t - 1) * kGC * 2;
}
constexpr int kC2fOff = c_off(5);
constexpr int kSmemBytes = kC2fOff + reg_px(4) * kGC * 4;  // 220,160
static_assert(kSmemBytes <= 232448, "shared-memory plan over the 227 KB limit");
static_assert(kWPackElems == 241664, "packed weight size");

// Index of pixel p's 16-byte chunk j in a region of CPP chunks per pixel,
// XOR-swizzled so eight consecutive pixels put chunk j in distinct bank
// groups (CPP = 8: 128-byte pixels; CPP = 4: two 64-byte pixels a line).
template <int CPP>
__device__ __forceinline__ int chunk_index(int p, int j) {
  return p * CPP + (j ^ (CPP == 8 ? (p & 7) : ((p >> 1) & 3)));
}

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ldg_u32(const __nv_bfloat16* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// ldmatrix row of this lane within a 16x16 A fragment (rows 0-7 / 8-15 for
// lanes 0-7 / 8-15 and again for 16-31) and its 8-channel half.
__device__ __forceinline__ int lane_row(int lane) {
  return (lane & 7) + ((lane >> 3) & 1) * 8;
}

// acc = source S (region S) convolved with its slice of WT_T, for MF
// M fragments whose lane pixels are (pr, pc) in region-T coordinates.
template <int T, int S, int MF, int NFR>
__device__ __forceinline__ void conv_piece(float (&acc)[MF][NFR][4],
                                           const unsigned char* src,
                                           const __nv_bfloat16* __restrict__ wt,
                                           const int (&pr)[MF],
                                           const int (&pc)[MF], int lane) {
  constexpr int CS = src_ch(S);
  constexpr int CPP = CS / 8;
  constexpr int WS = reg_w(S);
  constexpr int KT = 9 * tgt_cin(T);
  constexpr int KOFF = 9 * src_choff(S);
  constexpr int SHIFT = T - 1 - S;  // region T -> region S, at tap (0, 0)
  const int g = lane >> 2;
  const int tig = lane & 3;
  const int half = lane >> 4;
#pragma unroll
  for (int mf = 0; mf < MF; ++mf)
#pragma unroll
    for (int nf = 0; nf < NFR; ++nf)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mf][nf][i] = 0.0f;
  int base[MF];
#pragma unroll
  for (int mf = 0; mf < MF; ++mf) {
    base[mf] = (pr[mf] + SHIFT) * WS + pc[mf] + SHIFT;
  }
#pragma unroll 1
  for (int tap = 0; tap < 9; ++tap) {
    const int dy = tap / 3;
    const int toff = dy * WS + (tap - dy * 3);
#pragma unroll
    for (int kc = 0; kc < CS / 16; ++kc) {
      uint32_t a[MF][4];
#pragma unroll
      for (int mf = 0; mf < MF; ++mf) {
        const int p = base[mf] + toff;
        ldmatrix_x4(a[mf], smem_u32(src + chunk_index<CPP>(p, kc * 2 + half) * 16));
      }
      const __nv_bfloat16* wk = wt + KOFF + tap * CS + kc * 16 + tig * 2;
#pragma unroll
      for (int nf = 0; nf < NFR; ++nf) {
        const __nv_bfloat16* wr = wk + (nf * 8 + g) * KT;
        const uint32_t b0 = ldg_u32(wr);
        const uint32_t b1 = ldg_u32(wr + 8);
#pragma unroll
        for (int mf = 0; mf < MF; ++mf) mma_bf16(acc[mf][nf], a[mf], b0, b1);
      }
    }
  }
}

// tot = sum over sources S.. T-1 of f32(bf16(P_S,T)), in source order.
template <int T, int S, int MF, int NFR>
__device__ __forceinline__ void sum_pieces(float (&tot)[MF][NFR][4],
                                           const unsigned char* smem,
                                           const __nv_bfloat16* __restrict__ wt,
                                           const int (&pr)[MF],
                                           const int (&pc)[MF], int lane) {
  float acc[MF][NFR][4];
  conv_piece<T, S, MF, NFR>(acc, smem + (S == 0 ? 0 : c_off(S)), wt, pr, pc,
                            lane);
#pragma unroll
  for (int mf = 0; mf < MF; ++mf)
#pragma unroll
    for (int nf = 0; nf < NFR; ++nf)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float piece = round_bf16(acc[mf][nf][i]);
        tot[mf][nf][i] = S == 0 ? piece : __fadd_rn(tot[mf][nf][i], piece);
      }
  if constexpr (S + 1 < T) {
    sum_pieces<T, S + 1, MF, NFR>(tot, smem, wt, pr, pc, lane);
  }
}

// The 1x1 skip of c2: x at the same pixel (region-0 offset 2), K = 64.
template <int MF, int NFR>
__device__ __forceinline__ void skip_conv(float (&acc)[MF][NFR][4],
                                          const unsigned char* xs,
                                          const __nv_bfloat16* __restrict__ ws,
                                          const int (&pr)[MF],
                                          const int (&pc)[MF], int lane) {
  const int g = lane >> 2;
  const int tig = lane & 3;
  const int half = lane >> 4;
#pragma unroll
  for (int mf = 0; mf < MF; ++mf)
#pragma unroll
    for (int nf = 0; nf < NFR; ++nf)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mf][nf][i] = 0.0f;
#pragma unroll
  for (int kc = 0; kc < kNF / 16; ++kc) {
    uint32_t a[MF][4];
#pragma unroll
    for (int mf = 0; mf < MF; ++mf) {
      const int p = (pr[mf] + 2) * reg_w(0) + pc[mf] + 2;
      ldmatrix_x4(a[mf], smem_u32(xs + chunk_index<8>(p, kc * 2 + half) * 16));
    }
#pragma unroll
    for (int nf = 0; nf < NFR; ++nf) {
      const __nv_bfloat16* wr = ws + (nf * 8 + g) * kNF + kc * 16 + tig * 2;
      const uint32_t b0 = ldg_u32(wr);
      const uint32_t b1 = ldg_u32(wr + 8);
#pragma unroll
      for (int mf = 0; mf < MF; ++mf) mma_bf16(acc[mf][nf], a[mf], b0, b1);
    }
  }
}

// One stage: target T (c_T) over region T.  T < 5 writes c_T (bf16) into
// shared memory; T = 5 writes the block output to device memory.
template <int T>
__device__ void stage(unsigned char* smem,
                      const __nv_bfloat16* __restrict__ wpack,
                      const float* __restrict__ bpack, float slope,
                      __nv_bfloat16* __restrict__ out, int n, int h, int w,
                      int y0, int x0, int warp, int lane) {
  constexpr int NFR = tgt_n(T) / 8;   // 8-column N fragments
  constexpr int MF = T == 5 ? 2 : 4;  // M fragments per warp pass
  constexpr int WT = reg_w(T);
  constexpr int PT = reg_px(T);
  constexpr int MFRAGS = (PT + 15) / 16;
  const __nv_bfloat16* wt = wpack + w_off(T);
  const float* bias = bpack + b_off(T);
  const int g = lane >> 2;
  const int tig = lane & 3;
  const int lrow = lane_row(lane);
  float* c2f = reinterpret_cast<float*>(smem + kC2fOff);

  for (int mb = warp * MF; mb < MFRAGS; mb += kWarps * MF) {
    int pr[MF], pc[MF];
#pragma unroll
    for (int mf = 0; mf < MF; ++mf) {
      int m = (mb + mf) * 16 + lrow;
      if (m >= PT) m = PT - 1;  // padding rows read a real pixel, never stored
      pr[mf] = m / WT;
      pc[mf] = m - pr[mf] * WT;
    }
    float tot[MF][NFR][4];
    sum_pieces<T, 0, MF, NFR>(tot, smem, wt, pr, pc, lane);
    float sk[MF][NFR][4];
    if constexpr (T == 2) {
      skip_conv<MF, NFR>(sk, smem, wpack + kSkipWOff, pr, pc, lane);
    }

#pragma unroll
    for (int mf = 0; mf < MF; ++mf) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int m = (mb + mf) * 16 + g + hf * 8;
        if (m >= PT) continue;
        const int r = m / WT;
        const int c = m - r * WT;
        // frame coordinates of this pixel (region T starts at window T)
        const int fy = y0 - kHalo + T + r;
        const int fx = x0 - kHalo + T + c;
        const bool inside = fy >= 0 && fy < h && fx >= 0 && fx < w;
#pragma unroll
        for (int nf = 0; nf < NFR; ++nf) {
          const int col = nf * 8 + tig * 2;
          float v[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            v[e] = __fadd_rn(tot[mf][nf][hf * 2 + e], bias[col + e]);
          }
          if constexpr (T < 5) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              float u = v[e] >= 0.0f ? v[e] : __fmul_rn(v[e], slope);
              if constexpr (T == 2) {
                u = __fadd_rn(u, __fadd_rn(sk[mf][nf][hf * 2 + e],
                                           bpack[kSkipBOff + col + e]));
              }
              if constexpr (T == 4) {
                u = __fadd_rn(u, c2f[(r * reg_w(4) + c) * kGC + col + e]);
              }
              v[e] = inside ? u : 0.0f;
            }
            if constexpr (T == 2) {
              const int r4 = r - 2;
              const int c4 = c - 2;
              if (r4 >= 0 && r4 < reg_h(4) && c4 >= 0 && c4 < reg_w(4)) {
                *reinterpret_cast<float2*>(
                    c2f + (r4 * reg_w(4) + c4) * kGC + col) =
                    make_float2(v[0], v[1]);
              }
            }
            __nv_bfloat162 pk = __floats2bfloat162_rn(v[0], v[1]);
            *reinterpret_cast<__nv_bfloat162*>(
                smem + c_off(T) + chunk_index<4>(m, col >> 3) * 16 +
                (col & 7) * 2) = pk;
          } else {
            if (!inside) continue;
            const int p0 = (r + kHalo) * reg_w(0) + c + kHalo;
            const __nv_bfloat162 xv = *reinterpret_cast<const __nv_bfloat162*>(
                smem + chunk_index<8>(p0, col >> 3) * 16 + (col & 7) * 2);
            const float o0 = __fadd_rn(__low2float(xv), __fmul_rn(0.2f, v[0]));
            const float o1 = __fadd_rn(__high2float(xv), __fmul_rn(0.2f, v[1]));
            *reinterpret_cast<__nv_bfloat162*>(
                out + (((size_t)n * h + fy) * w + fx) * kNF + col) =
                __floats2bfloat162_rn(o0, o1);
          }
        }
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
rdb_block_kernel(const __nv_bfloat16* __restrict__ x,
                 __nv_bfloat16* __restrict__ out,
                 const __nv_bfloat16* __restrict__ wpack,
                 const float* __restrict__ bpack, int h, int w, float slope) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n = blockIdx.z;
  const int y0 = blockIdx.y * kTH;
  const int x0 = blockIdx.x * kTW;

  // the haloed x window, zero outside the frame (the convs' zero padding)
  constexpr int W0 = reg_w(0);
  for (int i = threadIdx.x; i < reg_px(0) * 8; i += kThreads) {
    const int p = i >> 3;
    const int j = i & 7;
    const int r = p / W0;
    const int c = p - r * W0;
    const int fy = y0 - kHalo + r;
    const int fx = x0 - kHalo + c;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (fy >= 0 && fy < h && fx >= 0 && fx < w) {
      v = *reinterpret_cast<const uint4*>(
          x + (((size_t)n * h + fy) * w + fx) * kNF + j * 8);
    }
    *reinterpret_cast<uint4*>(smem + chunk_index<8>(p, j) * 16) = v;
  }
  __syncthreads();
  stage<1>(smem, wpack, bpack, slope, out, n, h, w, y0, x0, warp, lane);
  __syncthreads();
  stage<2>(smem, wpack, bpack, slope, out, n, h, w, y0, x0, warp, lane);
  __syncthreads();
  stage<3>(smem, wpack, bpack, slope, out, n, h, w, y0, x0, warp, lane);
  __syncthreads();
  stage<4>(smem, wpack, bpack, slope, out, n, h, w, y0, x0, warp, lane);
  __syncthreads();
  stage<5>(smem, wpack, bpack, slope, out, n, h, w, y0, x0, warp, lane);
}

}  // namespace uvt_rdb

extern "C" {

// One dense block.  Pointers: x and out (N, h, w, 64) bf16, contiguous and
// distinct; wpack (241,664,) bf16 and bpack (224,) f32 as packed by
// ops/rdb.py.  Returns a cudaError_t code.
int uvt_rdb_block(const void* x, void* out, const void* wpack,
                  const void* bpack, int n, int h, int w, float slope,
                  void* stream) {
  using namespace uvt_rdb;
  if (n < 1 || h < 1 || w < 1 || n > 65535 || (h + kTH - 1) / kTH > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaFuncSetAttribute(
      rdb_block_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((w + kTW - 1) / kTW, (h + kTH - 1) / kTH, n);
  rdb_block_kernel<<<grid, kThreads, kSmemBytes,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(out),
      static_cast<const __nv_bfloat16*>(wpack),
      static_cast<const float*>(bpack), h, w, slope);
  return (int)cudaGetLastError();
}

}  // extern "C"
