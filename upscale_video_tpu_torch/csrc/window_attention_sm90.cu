// K9: SwinIR's shifted-window attention for Hopper (sm_90a), one launch
// for every window of every frame of a step.
//
// Replaces no TPU kernel: the JAX package has no attention.  It was added
// because the port's first route for SwinIR's WindowAttention (ops/swin.py,
// now its `sdpa` route) spent most of its device time moving bytes that do
// no work: a gather of the 3C-wide qkv blob into window order, a permuted
// and zero-padded copy of q, k and v per head, a dense (windows, heads, 64,
// 64) bias-and-mask tensor on shifted blocks, a transposed copy of the
// output and a scatter back.  What it computes, per frame, window and head,
// as ops/swin.py:window_attention_plain does:
//
//   tokens  = the 64 tokens of an 8x8 window of the map rolled by -shift:
//             rolled (y', x') reads source ((y' + shift) % H, (x' + shift) % W)
//   S       = q k^T * d^-0.5 + B[idx] + M          (f32)
//   P       = exp(S - rowmax S)                     (f32), l = sum P
//   out     = (bf16(P) v) / l, written to each token's source position
//
// B is the ((2w-1)^2, heads) relative-position table (f32), idx the pair's
// offset (dy + 7) * 15 + (dx + 7); M is -100 between tokens of different
// regions of the rolled map (SwinIR's calculate_mask: the bands [0, n - 8),
// [n - 8, n - shift), [n - shift, n) of each axis), so only the windows of
// the last window row or column carry one.
//
// Bound on the H100: bytes.  A 1080p frame's block reads the qkv blob once
// (2,073,600 tokens x 1,440 B) and writes the output once (x 480 B): 3.98 GB,
// 1.19 ms at 3.35 TB/s, against 127 GFLOP of QK^T and PV (0.13 ms at 989
// TFLOP/s, 0.2 ms at mma.sync's rate) and 1.06 G exponentials (0.3 ms on the
// SFUs).  So the design streams the blob at close to the HBM rate and keeps
// everything else on the chip:
//
// - Persistent blocks, one warp a head (heads <= 8), walk the windows of
//   the whole batch.  A two-stage ring of window tiles in shared memory is
//   fed by cp.async (16-byte chunks where a token row allows, else 8 or 4):
//   window i + 1's 92 KB load while window i computes, so each SM always
//   has a window's bytes in flight.  The roll and the partition are the
//   load's own index arithmetic: each token row of a window (one 3C-wide
//   row of the blob, contiguous) is copied from its source token.
// - A token row sits at a stride of 4 mod 8 words, so the fragment loads
//   below (8 rows by 4 words a warp) hit 32 distinct banks.  A head slice
//   starts at a 4-byte but not 16-byte offset (60 B at d 30), so fragments
//   are built from 32-bit shared loads (q, k) and 16-bit pairs (v), not
//   ldmatrix.
// - mma.sync m16n8k16 (bf16 in, f32 sums): QK^T over the head dim padded
//   to 32 in registers (the pad lanes of q and k are zeroed, exact as the
//   old route's zero pad), PV with P taken straight from QK^T's
//   accumulators (the C fragment of two n-tiles is the A fragment of one
//   k-step).  A warp holds its head's k and v fragments for the window and
//   walks its 64 queries in four 16-row tiles, two at a time (two
//   independent chains of products, shuffles and exponentials in flight).
// - The bias is in registers for the kernel's life: a lane's query column
//   is fixed (g) and its key columns are 2t and 2t + 1, so it needs the 15
//   rows dy of two columns of its head's table, 30 floats, loaded once and
//   indexed by constants of the unrolled tile loops.  The mask is two band
//   comparisons on the edge windows alone (a second instantiation of the
//   tile loop), never a tensor.
// - Softmax is exact over the window's 64 keys: the row max and sum by two
//   quad shuffles, exp2 of (S * d^-0.5 log2e + B log2e + M log2e - max)
//   (the SFU's ex2), P rounded to bf16 for PV, the division by l after PV.
// - Output: a warp writes its head's 16 rows into the tile's q columns of
//   that head (its q fragments for those rows are already in registers;
//   no other warp reads them but as zeroed pad), then the block copies the
//   64 output rows (C wide, contiguous) to their source tokens with the
//   same chunk size as the load: the merge and the roll back.
//
// Measured on the H100 (700 W) at the SwinIR-L cell's step, 4 x 1080p, C
// 240: 7.97 ms, 60% of the bytes bound (4.75 ms).  The copies alone (no
// compute) take 5.65 ms; the compute and the stores alone 6.3 ms.  The
// head warps meet at three barriers a window, so their phases (fragment
// loads, products, exponentials) coincide rather than overlap, and the
// window's time is near the sum of its phases.  Two designs meant to
// decouple them were slower: one producer warp issuing every copy and
// the head warps on mbarriers (18 ms: one warp cannot keep the copies
// moving), and two blocks of four heads a window (10.3 ms: a token row
// cut into six pieces slows the copies to 7.4 ms).  One query tile at a
// time instead of two: 8.0 ms.
//
// The wrapper (ops/swin.py:window_attention_k9) checks what this entry
// cannot see (a CUDA bf16 qkv, contiguous, 16-byte aligned, of C = heads x
// d channels a third, window 8, the table's shape) and allocates the
// output; this entry point refuses any other map, head count, head dim or
// shift with cudaErrorInvalidValue.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>
#include <type_traits>
#include <vector>

namespace uvt_swin_sm90 {

constexpr int kWin = 8;             // window side
constexpr int kT = kWin * kWin;     // tokens a window
constexpr int kSpan = 2 * kWin - 1; // offsets a table axis
constexpr int kMaxHeads = 8;        // one warp a head
constexpr int kMaxD = 32;           // head dim padded to 32
constexpr int kStages = 2;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kMaskLog2 = -100.0f * kLog2e;  // SwinIR's -100, log2 units

struct Args {
  const __nv_bfloat16* qkv;  // (n, h, w, 3c)
  __nv_bfloat16* out;        // (n, h, w, c)
  const float* table;        // (kSpan * kSpan, heads)
  int h, w, c, heads, d, shift;
  int nwx, per_frame, windows;
  int row_words;  // a tile row's stride in 32-bit words (4 mod 8)
  float scale_log2;
};

template <int VEC>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src) {
  if constexpr (VEC == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst), "l"(src)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;" ::"r"(dst), "l"(src),
                 "n"(VEC)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

__device__ __forceinline__ void cp_wait_all_but_one() {
  asm volatile("cp.async.wait_group 1;" ::: "memory");
}

__device__ __forceinline__ void mma(float (&c)[4], uint32_t a0, uint32_t a1,
                                    uint32_t a2, uint32_t a3, uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// v - n where v >= n: the roll's wrap (v < 2n).
__device__ __forceinline__ int wrap(int v, int n) { return v >= n ? v - n : v; }

struct Window {
  int f, wy, wx;
};

__device__ __forceinline__ Window window_at(const Args& a, int wi) {
  Window r;
  r.f = wi / a.per_frame;
  const int k = wi - r.f * a.per_frame;
  r.wy = k / a.nwx;
  r.wx = k - r.wy * a.nwx;
  return r;
}

// Element offset of the source token of row `row` (row-major in the
// window) of window `win` of the rolled map.
__device__ __forceinline__ size_t token_of(const Args& a, const Window& win,
                                           int row) {
  const int ys = wrap(win.wy * kWin + (row >> 3) + a.shift, a.h);
  const int xs = wrap(win.wx * kWin + (row & 7) + a.shift, a.w);
  return (static_cast<size_t>(win.f) * a.h + ys) * a.w + xs;
}

// Window `wi`'s 64 token rows of qkv (3c wide) into the tile at `tile`,
// warp `warp` of `nwarps` copying rows warp, warp + nwarps, ...
template <int VEC>
__device__ __forceinline__ void load_window(const Args& a, int wi, uint32_t tile,
                                            int warp, int lane, int nwarps) {
  const Window win = window_at(a, wi);
  const int row_bytes = 6 * a.c;
  const int chunks = row_bytes / VEC;
  const char* base = reinterpret_cast<const char*>(a.qkv);
  for (int row = warp; row < kT; row += nwarps) {
    const char* src = base + token_of(a, win, row) * row_bytes;
    const uint32_t dst = tile + row * a.row_words * 4;
    for (int k = lane; k < chunks; k += 32) cp_async<VEC>(dst + k * VEC, src + k * VEC);
  }
}

// The tile's first c columns of each row (the output, written over q) to
// the rows' source tokens of out.
template <int VEC>
__device__ __forceinline__ void store_window(const Args& a, int wi,
                                             const unsigned char* tile, int warp,
                                             int lane, int nwarps) {
  using Chunk = typename std::conditional<
      VEC == 16, uint4, typename std::conditional<VEC == 8, uint2, uint32_t>::type>::type;
  const Window win = window_at(a, wi);
  const int row_bytes = 2 * a.c;
  const int chunks = row_bytes / VEC;
  char* base = reinterpret_cast<char*>(a.out);
  for (int row = warp; row < kT; row += nwarps) {
    char* dst = base + token_of(a, win, row) * row_bytes;
    const unsigned char* src = tile + row * a.row_words * 4;
    for (int k = lane; k < chunks; k += 32) {
      *reinterpret_cast<Chunk*>(dst + k * VEC) =
          *reinterpret_cast<const Chunk*>(src + k * VEC);
    }
  }
}

// Scores of query tile mi (rows 2 mi, 2 mi + 1 of the window) in log2
// units with bias and mask, then softmax's P in bf16 pairs and the row
// sums.  MASKED: ybits has bit l set where window row l lies in the rolled
// map's last band, xd0 / xd1 whether this lane's query column and key
// column 2t / 2t + 1 lie in different bands.
template <bool MASKED>
__device__ __forceinline__ void softmax_tile(float (&s)[8][4], uint32_t (&pf)[8][2],
                                             float& l0, float& l1, int mi,
                                             float scale_log2,
                                             const float2 (&bias)[kSpan],
                                             uint32_t ybits, bool xd0, bool xd1) {
#pragma unroll
  for (int nj = 0; nj < 8; ++nj) {
    const float2 b0 = bias[2 * mi - nj + 7];
    const float2 b1 = bias[2 * mi + 1 - nj + 7];
    s[nj][0] = fmaf(s[nj][0], scale_log2, b0.x);
    s[nj][1] = fmaf(s[nj][1], scale_log2, b0.y);
    s[nj][2] = fmaf(s[nj][2], scale_log2, b1.x);
    s[nj][3] = fmaf(s[nj][3], scale_log2, b1.y);
    if (MASKED) {
      const bool yk = (ybits >> nj) & 1u;
      const bool y0 = ((ybits >> (2 * mi)) & 1u) != yk;
      const bool y1 = ((ybits >> (2 * mi + 1)) & 1u) != yk;
      if (y0 || xd0) s[nj][0] += kMaskLog2;
      if (y0 || xd1) s[nj][1] += kMaskLog2;
      if (y1 || xd0) s[nj][2] += kMaskLog2;
      if (y1 || xd1) s[nj][3] += kMaskLog2;
    }
  }
  // row maxima as trees over the lane's 16 values, then over the quad
  float m0[8], m1[8];
#pragma unroll
  for (int nj = 0; nj < 8; ++nj) {
    m0[nj] = fmaxf(s[nj][0], s[nj][1]);
    m1[nj] = fmaxf(s[nj][2], s[nj][3]);
  }
#pragma unroll
  for (int w = 4; w >= 1; w >>= 1) {
#pragma unroll
    for (int nj = 0; nj < w; ++nj) {
      m0[nj] = fmaxf(m0[nj], m0[nj + w]);
      m1[nj] = fmaxf(m1[nj], m1[nj + w]);
    }
  }
  float mx0 = m0[0], mx1 = m1[0];
#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o));
  }
  float e0[8], e1[8];
#pragma unroll
  for (int nj = 0; nj < 8; ++nj) {
    const float p0 = ex2(s[nj][0] - mx0), p1 = ex2(s[nj][1] - mx0);
    const float p2 = ex2(s[nj][2] - mx1), p3 = ex2(s[nj][3] - mx1);
    e0[nj] = p0 + p1;
    e1[nj] = p2 + p3;
    pf[nj][0] = pack_bf16(p0, p1);
    pf[nj][1] = pack_bf16(p2, p3);
  }
#pragma unroll
  for (int w = 4; w >= 1; w >>= 1) {
#pragma unroll
    for (int nj = 0; nj < w; ++nj) {
      e0[nj] += e0[nj + w];
      e1[nj] += e1[nj + w];
    }
  }
  l0 = e0[0];
  l1 = e1[0];
#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, o);
    l1 += __shfl_xor_sync(0xffffffffu, l1, o);
  }
}

// One head (this warp's) of one window: its 64 rows of output over the
// tile's q columns of the head, two 16-row query tiles at a time so that
// each step has two independent chains of products, shuffles and
// exponentials in flight.
template <bool MASKED>
__device__ __forceinline__ void attend(const Args& a, unsigned char* tile, int head,
                                       int lane, const float2 (&bias)[kSpan],
                                       uint32_t ybits, bool xd0, bool xd1) {
  const int g = lane >> 2, t = lane & 3;
  const int rw = a.row_words, d = a.d;
  uint32_t* words = reinterpret_cast<uint32_t*>(tile);
  const uint16_t* halves = reinterpret_cast<const uint16_t*>(tile);
  const int qw = (head * d) >> 1;              // q's first word in a row
  const int kw = (a.c + head * d) >> 1;        // k's
  const int vh = 2 * a.c + head * d;           // v's first half-word
  // head-dim pairs 16 kk + 2t + 8 hi of q and k that lie inside the head
  bool in[2][2];
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) in[kk][hi] = 2 * (8 * kk + t + 4 * hi) < d;
  }

  // k as QK^T's B operand: key 8 nj + g, head-dim pair 16 kk + 2t (+ 8)
  uint32_t kf[8][2][2];
#pragma unroll
  for (int nj = 0; nj < 8; ++nj) {
    const uint32_t* row = words + (8 * nj + g) * rw + kw;
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        kf[nj][kk][hi] = in[kk][hi] ? row[8 * kk + t + 4 * hi] : 0u;
      }
    }
  }
  // v as PV's B operand: keys 16 kk + 2t, + 1 (and + 8, + 9), column 8 nd + g
  uint32_t vf[4][4][2];
#pragma unroll
  for (int nd = 0; nd < 4; ++nd) {
    if (8 * nd >= d) continue;
    const uint16_t* col = halves + vh + 8 * nd + g;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        const int key = 16 * kk + 2 * t + 8 * hi;
        const uint32_t lo = col[key * 2 * rw];
        const uint32_t up = col[(key + 1) * 2 * rw];
        vf[nd][kk][hi] = __byte_perm(lo, up, 0x5410);
      }
    }
  }

#pragma unroll
  for (int mp = 0; mp < 2; ++mp) {
    uint32_t qf[2][2][4];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const uint32_t* r0 = words + (16 * (2 * mp + u) + g) * rw + qw;
      const uint32_t* r1 = r0 + 8 * rw;
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const int j0 = 8 * kk + t, j1 = j0 + 4;
        qf[u][kk][0] = in[kk][0] ? r0[j0] : 0u;
        qf[u][kk][1] = in[kk][0] ? r1[j0] : 0u;
        qf[u][kk][2] = in[kk][1] ? r0[j1] : 0u;
        qf[u][kk][3] = in[kk][1] ? r1[j1] : 0u;
      }
    }
    float s[2][8][4];
#pragma unroll
    for (int nj = 0; nj < 8; ++nj) {
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        s[u][nj][0] = s[u][nj][1] = s[u][nj][2] = s[u][nj][3] = 0.f;
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          mma(s[u][nj], qf[u][kk][0], qf[u][kk][1], qf[u][kk][2], qf[u][kk][3],
              kf[nj][kk][0], kf[nj][kk][1]);
        }
      }
    }
    uint32_t pf[2][8][2];
    float l[2][2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      softmax_tile<MASKED>(s[u], pf[u], l[u][0], l[u][1], 2 * mp + u,
                           a.scale_log2, bias, ybits, xd0, xd1);
    }
    float acc[2][4][4];
#pragma unroll
    for (int nd = 0; nd < 4; ++nd) {
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        acc[u][nd][0] = acc[u][nd][1] = acc[u][nd][2] = acc[u][nd][3] = 0.f;
      }
      if (8 * nd >= d) continue;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          mma(acc[u][nd], pf[u][2 * kk][0], pf[u][2 * kk][1], pf[u][2 * kk + 1][0],
              pf[u][2 * kk + 1][1], vf[nd][kk][0], vf[nd][kk][1]);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      uint32_t* r0 = words + (16 * (2 * mp + u) + g) * rw + qw;
      uint32_t* r1 = r0 + 8 * rw;
      const float inv0 = __fdividef(1.f, l[u][0]), inv1 = __fdividef(1.f, l[u][1]);
#pragma unroll
      for (int nd = 0; nd < 4; ++nd) {
        const int j = 4 * nd + t;  // the output pair's word in the head
        if (2 * j < d) {
          r0[j] = pack_bf16(acc[u][nd][0] * inv0, acc[u][nd][1] * inv0);
          r1[j] = pack_bf16(acc[u][nd][2] * inv1, acc[u][nd][3] * inv1);
        }
      }
    }
  }
}

template <int VEC>
__global__ void __launch_bounds__(32 * kMaxHeads, 1)
    WindowAttentionKernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = a.heads, head = warp;
  const int tile_bytes = kT * a.row_words * 4;
  const uint32_t smem_base = static_cast<uint32_t>(__cvta_generic_to_shared(smem));

  // this lane's bias: rows dy 0..14 of its head's table at the column
  // offsets dx = g - 2t + 7 (key column 2t) and dx - 1 (key column 2t + 1)
  const int g = lane >> 2, t = lane & 3;
  const int dx = g - 2 * t + kWin - 1;
  float2 bias[kSpan];
#pragma unroll
  for (int dy = 0; dy < kSpan; ++dy) {
    bias[dy].x = a.table[(dy * kSpan + dx) * a.heads + head] * kLog2e;
    bias[dy].y = a.table[(dy * kSpan + dx - 1) * a.heads + head] * kLog2e;
  }
  const int last = a.shift ? kWin - a.shift : kWin;  // first column of the last band
  const bool xq = g >= last;
  const bool xd0 = xq != (2 * t >= last), xd1 = xq != (2 * t + 1 >= last);
  const uint32_t band_rows = (0xffu << last) & 0xffu;

  int wi = blockIdx.x;
  if (wi < a.windows) load_window<VEC>(a, wi, smem_base, warp, lane, nwarps);
  cp_commit();
  for (int it = 0; wi < a.windows; ++it, wi += gridDim.x) {
    const int s = it & 1;
    unsigned char* tile = smem + s * tile_bytes;
    __syncthreads();  // the other stage's last window is stored
    const int next = wi + gridDim.x;
    if (next < a.windows) {
      load_window<VEC>(a, next, smem_base + (s ^ 1) * tile_bytes, warp, lane, nwarps);
    }
    cp_commit();
    cp_wait_all_but_one();
    __syncthreads();  // window wi's tile is whole
    const Window win = window_at(a, wi);
    const bool last_row = win.wy == a.h / kWin - 1, last_col = win.wx == a.nwx - 1;
    if (a.shift && (last_row || last_col)) {
      attend<true>(a, tile, head, lane, bias, last_row ? band_rows : 0u,
                   last_col && xd0, last_col && xd1);
    } else {
      attend<false>(a, tile, head, lane, bias, 0u, false, false);
    }
    __syncthreads();  // every head's output is in the tile
    store_window<VEC>(a, wi, tile, warp, lane, nwarps);
  }
}

// The largest ring a launch takes: 8 heads of 32, a token row of 384 words.
constexpr int kMaxSmem = kStages * kT * ((3 * kMaxHeads * kMaxD / 2 + 7) / 8 * 8 + 4) * 4;

// The persistent grid of WindowAttentionKernel<VEC> at `threads` threads
// and `smem` bytes a block on the current device: its SMs times the blocks
// an SM holds.  Queried once per device and (threads, smem), the kernel's
// shared-memory limit set to kMaxSmem with a device's first query; later
// launches read the cache.  Returns the grid, or a negative cudaError_t.
template <int VEC>
int resident_grid(int threads, int smem) {
  struct Entry {
    int dev, threads, smem, grid;
  };
  static std::mutex mu;
  static std::vector<Entry> seen;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return -(int)e;
  std::lock_guard<std::mutex> lock(mu);
  bool limit_set = false;
  for (const Entry& en : seen) {
    if (en.dev != dev) continue;
    if (en.threads == threads && en.smem == smem) return en.grid;
    limit_set = true;
  }
  auto kernel = WindowAttentionKernel<VEC>;
  if (!limit_set && (e = cudaFuncSetAttribute(
                         kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         kMaxSmem)) != cudaSuccess) {
    return -(int)e;
  }
  int sms = 0, per_sm = 0;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) !=
          cudaSuccess ||
      (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                         smem)) != cudaSuccess) {
    return -(int)e;
  }
  if (per_sm < 1) return -(int)cudaErrorInvalidConfiguration;
  seen.push_back({dev, threads, smem, sms * per_sm});
  return sms * per_sm;
}

template <int VEC>
int launch(const Args& a, int smem_bytes, cudaStream_t stream) {
  const int threads = 32 * a.heads;
  const int resident = resident_grid<VEC>(threads, smem_bytes);
  if (resident < 0) return -resident;
  const int grid = a.windows < resident ? a.windows : resident;
  WindowAttentionKernel<VEC><<<grid, threads, smem_bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace uvt_swin_sm90

extern "C" {

// SwinIR's shifted-window attention over a batch, window 8.  qkv: (n, h,
// w, 3 heads d) bf16, contiguous, 16-byte aligned (channels s C + head d +
// i for s in q, k, v); table: ((2*8-1)^2, heads) f32; out: (n, h, w,
// heads d) bf16, contiguous, 16-byte aligned, not aliased.  h, w multiples
// of 8; 1 <= heads <= 8; d even, 2..32; 0 <= shift < 8; scale d^-0.5.
// Returns a cudaError_t code.
int uvt_window_attention_sm90(const void* qkv, void* out, const void* table, int n,
                              int h, int w, int heads, int d, int shift,
                              float scale, void* stream) {
  using namespace uvt_swin_sm90;
  if (n < 1 || h < kWin || w < kWin || h % kWin || w % kWin || heads < 1 ||
      heads > kMaxHeads || d < 2 || d > kMaxD || d % 2 || shift < 0 ||
      shift >= kWin) {
    return (int)cudaErrorInvalidValue;
  }
  const long long windows = static_cast<long long>(n) * (h / kWin) * (w / kWin);
  if (windows > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  Args a;
  a.qkv = static_cast<const __nv_bfloat16*>(qkv);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.table = static_cast<const float*>(table);
  a.h = h;
  a.w = w;
  a.c = heads * d;
  a.heads = heads;
  a.d = d;
  a.shift = shift;
  a.nwx = w / kWin;
  a.per_frame = (h / kWin) * a.nwx;
  a.windows = static_cast<int>(windows);
  const int words = 3 * a.c / 2;  // a token row of qkv, in 32-bit words
  a.row_words = (words + 7) / 8 * 8 + 4;
  a.scale_log2 = scale * kLog2e;
  const int smem_bytes = kStages * kT * a.row_words * 4;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a.c % 8 == 0) return launch<16>(a, smem_bytes, s);
  if (a.c % 4 == 0) return launch<8>(a, smem_bytes, s);
  return launch<4>(a, smem_bytes, s);
}

}  // extern "C"
