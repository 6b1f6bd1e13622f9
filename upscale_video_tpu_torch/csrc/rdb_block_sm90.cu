// K5 on Hopper: one Valar/ESRGAN residual dense block, fused, as a
// persistent, warp-specialised wgmma kernel (sm_90a).
//
// Replaces upscale_video_tpu/ops/rdb_pallas.py:253 (_rdb_kernel, reached
// via rdb_apply_canvas -> _rdb_run_canvas on the product path).  One launch
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
// source s convolved with its weight slice and accumulated in f32;
// then + bias, lrelu, the c2 skip (+ its bias) or c2's pre-rounding f32
// value for c4, zero outside the frame, one rounding to bf16.  Each
// (target, source) piece is one straight-line chain of wgmmas into its own
// accumulators, retired (wgmma.wait_group 0) before it is rounded and
// added.  Elementwise steps use __fadd_rn/__fmul_rn, as the plain version.
//
// What bounds it on the H100: operations.  The block does 241,664 MAC per
// output pixel against 256 bytes of device traffic (~1,900 FLOP/byte, far
// above the bf16 ridge of ~295).  An earlier mma.sync version ran at 9.3%
// of that bound; this design answers its four limits:
//
// 1. Weights through shared memory, once per tile, shared by every
//    consumer.  The host packs the weights (ops/rdb.py:
//    pack_rdb_weights_sm90) as a stream of 145 blocks in the order the
//    consumers use them (target, then source, then tap; c2's 1x1 skip after
//    c2's pieces), each block in the K-major image wgmma's B descriptor
//    reads: a block for an x tap into c1..c4 is 32 rows of 64 channels
//    (128-byte swizzle); every other block has 32-channel rows (64-byte
//    swizzle): a c1..c4 source's tap into c1..c4, a c1..c4 source's tap into
//    c5 (64 rows), and half of an x tap into c5 (64 rows), so each fits a
//    4 KB slot.  One producer thread keeps cp.async.bulk copies of the
//    blocks in flight through a ring of 8 slots guarded by full/empty
//    mbarriers.  A tile reads the 483 KB pack once (L2 about 5.9 GB per
//    8x576x512 launch, against ~34 GB of 32-bit __ldg fragments in the
//    earlier version).
// 2. wgmma m64nNk16 with A in registers (ldmatrix from the XOR-swizzled
//    activation regions; a 64-pixel M tile may wrap region rows, as the
//    earlier version's fragments did), B from the ring; N 32 for c1..c4 and
//    the skip, 64 for c5.  Within a block each k16 step is one group (its
//    A fragments double-buffered under wait_group 1); every block ends with
//    wait_group 0 and gives its slot back, so no wgmma is in flight across
//    the ring's barrier wait and ptxas does not serialise them (C7512).
//    Keeping a group in flight across that wait made ptxas serialise every
//    wgmma, and the kernel slower, in an A/B of the two variants on the
//    card.
// 3. The haloed x window by one 4-D TMA tile load, 128-byte swizzle (the
//    chunk_index<8> layout), its out-of-frame elements zero-filled (the
//    convs' zero padding).  It is loaded once per tile; the next tile's
//    window loads while c5's c1..c4 pieces run (the residual reads x from
//    device memory, so the window is free after c5's x piece).
// 4. Warp specialisation: a producer warpgroup (setmaxnreg 40; one thread
//    issues every copy) and two consumer warpgroups (setmaxnreg 232) that
//    split each stage's M tiles (c1..c5: 8/7/5/4/3 tiles of 64 pixels,
//    taken alternately, so at most 4 per warpgroup: a piece and a total
//    are up to 128 f32 a thread).  In A/Bs on the card this beat a producer
//    warp without setmaxnreg (more spills), and by far three consumer
//    warpgroups with the copies issued by one of their threads.
//
// Tile plan: 12x16 output pixels, halo 5.  Regions (rows x cols x bytes
// per pixel): x 22x26x128 (73,216 B), c1 20x24x64 (30,720), c2 18x22x64
// (25,344), c3 16x20x64 (20,480), c4 14x18x64 (16,128), c2 in f32 on c4's
// region 14x18x128 (32,256): 198,144 B; with the ring (32,768), 18
// mbarriers and 1 KB of alignment slack, 232,080 of the 232,448 bytes a
// block may take.  Recompute: the stages compute 1.406x the output's MACs
// (1.456x counting the M tiles' padding rows).  48 tile rows cover a 576-row
// tile of -m r exactly and 32 tile columns its 512 columns: 12,288 tiles
// per 8x576x512 launch, one persistent block per SM walking them.

#include "sm90_common.cuh"

namespace uvt_rdb_sm90 {

using namespace uvt_sm90_common;

constexpr int kNF = 64;                 // trunk width (x, c5, out)
constexpr int kGC = 32;                 // growth channels (c1..c4)
constexpr int kTH = 12;                 // output rows per tile
constexpr int kTW = 16;                 // output cols per tile
constexpr int kHalo = 5;                // five 3x3 convs
constexpr int kWGs = 2;                 // consumer warpgroups
constexpr int kConsumerThreads = kWGs * 128;
constexpr int kThreads = kConsumerThreads + 128;  // + the producer warpgroup
constexpr int kSlots = 8;               // weight ring
constexpr int kSlotBytes = 4096;
constexpr int kSmemLimit = 232448;

// Region of stage t: t = 0 is the x window, t = 1..5 are c1..c5 (c5's
// region is the output tile).  Region t starts at window row/col t.
__host__ __device__ constexpr int reg_h(int t) { return kTH + 2 * kHalo - 2 * t; }
__host__ __device__ constexpr int reg_w(int t) { return kTW + 2 * kHalo - 2 * t; }
__host__ __device__ constexpr int reg_px(int t) { return reg_h(t) * reg_w(t); }
__host__ __device__ constexpr int tgt_n(int t) { return t == 5 ? kNF : kGC; }
__host__ __device__ constexpr int mtiles(int t) { return (reg_px(t) + 63) / 64; }
// M tiles warpgroup g takes of stage t: tiles g, g + kWGs, ...
__host__ __device__ constexpr int wg_mtiles(int t, int g) {
  return (mtiles(t) - g + kWGs - 1) / kWGs;
}

// The weight stream (ops/rdb.py:sm90_blocks): per (target T, source S)
// piece its blocks, each k channels of one tap for tgt_n(T) outputs.
__host__ __device__ constexpr int piece_blocks(int t, int s) { return t == 5 && s == 0 ? 18 : 9; }
__host__ __device__ constexpr int block_k(int t, int s) { return t < 5 && s == 0 ? kNF : kGC; }
__host__ __device__ constexpr int block_bytes(int t, int s) { return tgt_n(t) * block_k(t, s) * 2; }
constexpr int kSkipBytes = kGC * kNF * 2;
__host__ __device__ constexpr int target_blocks(int t) {
  return t * 9 + (t == 5 ? 9 : 0) + (t == 2 ? 1 : 0);
}
__host__ __device__ constexpr int first_block(int t) {
  return t <= 1 ? 0 : first_block(t - 1) + target_blocks(t - 1);
}
__host__ __device__ constexpr int target_bytes(int t) {
  return (t == 5 ? 9 * 2 * block_bytes(5, 0) + 36 * block_bytes(5, 1)
                 : 9 * block_bytes(t, 0) + 9 * (t - 1) * block_bytes(t, 1)) +
         (t == 2 ? kSkipBytes : 0);
}
__host__ __device__ constexpr int first_byte(int t) {
  return t <= 1 ? 0 : first_byte(t - 1) + target_bytes(t - 1);
}
constexpr int kTileBlocks = first_block(6);  // 145
// the producer loads the next tile's x window before it issues this
// block, once the consumers have released it after c5's x piece (kSlots
// blocks after c5's x blocks, so the ring already holds c5's next blocks)
constexpr int kXReload = first_block(5) + 18 + kSlots;
static_assert(first_byte(6) == 241664 * 2, "weight stream bytes");
static_assert(kTileBlocks == 145, "weight blocks per tile");
static_assert(kXReload < kTileBlocks, "x reload point");

// Shared-memory plan (bytes from a 1024-aligned base).
constexpr int kRingOff = 0;
constexpr int kXOff = kRingOff + kSlots * kSlotBytes;
constexpr int kXBytes = reg_px(0) * kNF * 2;
__host__ __device__ constexpr int c_off(int t) {
  return t <= 1 ? kXOff + kXBytes : c_off(t - 1) + reg_px(t - 1) * kGC * 2;
}
constexpr int kC2fOff = c_off(5);
constexpr int kBarOff = kC2fOff + reg_px(4) * kGC * 4;
// full[kSlots], empty[kSlots], x_full, x_empty
constexpr int kBars = 2 * kSlots + 2;
constexpr int kSmemBytes = 1024 + kBarOff + kBars * 8;
static_assert(kXOff % 1024 == 0, "the TMA x window needs 1024-byte alignment");
static_assert(kBarOff - kRingOff - kSlots * kSlotBytes == 198144, "activation bytes");
static_assert(kSmemBytes == 232080 && kSmemBytes <= kSmemLimit,
              "shared-memory plan over the 227 KB limit");
static_assert(mtiles(1) == 8 && mtiles(2) == 7 && mtiles(3) == 5 && mtiles(4) == 4 &&
                  mtiles(5) == 3,
              "M tiles per stage");
static_assert(wg_mtiles(1, 0) == 4 && wg_mtiles(2, 1) == 3 && wg_mtiles(5, 1) == 1,
              "M tiles per warpgroup");

// Byte offset of 16-byte chunk j of pixel p in a region of CPP chunks per
// pixel: CPP 8 is the 128-byte swizzle TMA
// writes, CPP 4 puts two 64-byte pixels in a 128-byte line.
template <int CPP>
__device__ __forceinline__ uint32_t chunk_off(int p, int j) {
  return (uint32_t)(p * CPP + (j ^ (CPP == 8 ? (p & 7) : ((p >> 1) & 3)))) * 16u;
}

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(kConsumerThreads) : "memory");
}

// wgmma descriptor of a K-major B block whose rows hold K bf16: K 64 is
// the 128-byte swizzle (layout 1, 8-row groups 1024 B apart), K 32 the
// 64-byte swizzle (layout 2, 8-row groups 512 B apart); LBO 1 (unused by
// swizzled K-major operands).
template <int K>
__device__ __forceinline__ uint64_t bdesc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)((K == kNF ? 1024 : 512) >> 4) << 32) |
         ((uint64_t)(K == kNF ? 1 : 2) << 62);
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// The consumers' view of the weight ring: block `blk` (counted over the
// block's whole walk of tiles) sits in slot blk % kSlots, its fill the
// (blk / kSlots)-th.
struct Ring {
  uint32_t slots;
  uint32_t bars;
  int blk;
  __device__ __forceinline__ uint32_t full(int b) const { return bars + 8 * (b % kSlots); }
  __device__ __forceinline__ uint32_t empty(int b) const {
    return bars + 8 * (kSlots + b % kSlots);
  }
};

// What a consumer thread needs about itself and its tile.
struct Tile {
  uint32_t sm;
  unsigned char* smp;
  int wg, warp, lane;
  int f, y0, x0, h, w;
};

// P = source S convolved with its weight blocks into target T, for this
// warpgroup's MT M tiles, whose lane pixels are (pr, pc) in region T.  Per
// block: wait for it, then per k16 step the MT A fragments by ldmatrix and
// one wgmma per M tile as one group (wait_group 1 between steps, the A
// registers double-buffered); the block ends with every wgmma retired and
// its slot released.
template <int T, int S, int MT>
__device__ __forceinline__ void piece(float (&P)[MT][tgt_n(T) / 2], const Tile& tl,
                                      const int (&pr)[MT], const int (&pc)[MT],
                                      Ring& ring) {
  constexpr int N = tgt_n(T);
  constexpr int K = block_k(T, S);
  constexpr int KS = K / 16;
  constexpr int NB = piece_blocks(T, S);
  constexpr int CPP = S == 0 ? 8 : 4;
  constexpr int WS = reg_w(S);
  constexpr int SHIFT = T - 1 - S;
  const uint32_t src = tl.sm + (S == 0 ? kXOff : c_off(S));
  const int half = tl.lane >> 4;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int i = 0; i < N / 2; ++i) P[mt][i] = 0.0f;
    fence_acc(P[mt]);
  }
  int base[MT];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) base[mt] = (pr[mt] + SHIFT) * WS + pc[mt] + SHIFT;
  uint32_t a[2][MT][4];
#pragma unroll 1
  for (int i = 0; i < NB; ++i) {
    const int tap = NB == 18 ? i >> 1 : i;
    const int c0 = NB == 18 ? (i & 1) * 4 : 0;
    const int dy = tap / 3;
    const int toff = dy * WS + (tap - 3 * dy);
    const int b = ring.blk + i;
    mbar_wait(ring.full(b), (b / kSlots) & 1);
    const uint64_t desc = bdesc<K>(ring.slots + (b % kSlots) * kSlotBytes);
#pragma unroll
    for (int kc = 0; kc < KS; ++kc) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        ldsm_x4(src + chunk_off<CPP>(base[mt] + toff, c0 + 2 * kc + half), a[kc & 1][mt]);
      }
      wg_fence();
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) wgmma_rs<N>(P[mt], a[kc & 1][mt], desc + 2 * kc);
      wg_commit();
      wg_wait1();
    }
    wg_wait0();
    if (tl.lane == 0) mbar_arrive(ring.empty(b));
  }
  ring.blk += NB;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) fence_acc(P[mt]);
}

// tot = sum over sources S..T-1 of f32(bf16(P_S,T)), in source order.  After
// c5's x piece the x window is released to the producer.
template <int T, int S, int MT>
__device__ __forceinline__ void sum_pieces(float (&tot)[MT][tgt_n(T) / 2],
                                           float (&P)[MT][tgt_n(T) / 2],
                                           const Tile& tl, const int (&pr)[MT],
                                           const int (&pc)[MT], Ring& ring,
                                           uint32_t x_empty) {
  piece<T, S, MT>(P, tl, pr, pc, ring);
  if constexpr (T == 5 && S == 0) {
    fence_async_smem();
    __syncwarp();
    if (tl.lane == 0) mbar_arrive(x_empty);
  }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < tgt_n(T) / 2; ++i) {
      const float r = round_bf16(P[mt][i]);
      tot[mt][i] = S == 0 ? r : __fadd_rn(tot[mt][i], r);
    }
  if constexpr (S + 1 < T) sum_pieces<T, S + 1, MT>(tot, P, tl, pr, pc, ring, x_empty);
}

// The 1x1 skip of c2 (x at the same pixel, region-0 offset 2) into P: one
// 64-channel block.
template <int MT>
__device__ __forceinline__ void skip_piece(float (&P)[MT][kGC / 2], const Tile& tl,
                                           const int (&pr)[MT], const int (&pc)[MT],
                                           Ring& ring) {
  const uint32_t src = tl.sm + kXOff;
  const int half = tl.lane >> 4;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int i = 0; i < kGC / 2; ++i) P[mt][i] = 0.0f;
    fence_acc(P[mt]);
  }
  const int b = ring.blk;
  mbar_wait(ring.full(b), (b / kSlots) & 1);
  const uint64_t desc = bdesc<kNF>(ring.slots + (b % kSlots) * kSlotBytes);
  uint32_t a[2][MT][4];
#pragma unroll
  for (int kc = 0; kc < kNF / 16; ++kc) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int p = (pr[mt] + 2) * reg_w(0) + pc[mt] + 2;
      ldsm_x4(src + chunk_off<8>(p, 2 * kc + half), a[kc & 1][mt]);
    }
    wg_fence();
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) wgmma_rs<kGC>(P[mt], a[kc & 1][mt], desc + 2 * kc);
    wg_commit();
    wg_wait1();
  }
  wg_wait0();
  if (tl.lane == 0) mbar_arrive(ring.empty(b));
  ring.blk += 1;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) fence_acc(P[mt]);
}

// One stage: target T (c_T) over region T for this warpgroup's MT M tiles
// (tiles wg, wg + 2, ...).  T < 5 writes c_T (bf16) into shared memory; T =
// 5 writes the block output to device memory.  Accumulator element i of M
// tile mt is row g + 8 * ((i >> 1) & 1) of the warp's 16, column
// 8 * (i >> 2) + 2 * q + (i & 1).
template <int T, int MT>
__device__ __forceinline__ void stage(const Tile& tl, Ring& ring, uint32_t x_empty,
                                      const __nv_bfloat16* __restrict__ x,
                                      __nv_bfloat16* __restrict__ out,
                                      const float* __restrict__ bpack, float slope) {
  constexpr int N = tgt_n(T);
  constexpr int WT = reg_w(T);
  constexpr int PT = reg_px(T);
  const int g = tl.lane >> 2;
  const int q = tl.lane & 3;
  const float* bias = bpack + (T - 1) * kGC;
  float* c2f = reinterpret_cast<float*>(tl.smp + kC2fOff);

  int pr[MT], pc[MT];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    int m = (tl.wg + 2 * mt) * 64 + tl.warp * 16 + (tl.lane & 15);
    if (m >= PT) m = PT - 1;
    pr[mt] = m / WT;
    pc[mt] = m - pr[mt] * WT;
  }
  float tot[MT][N / 2];
  float P[MT][N / 2];
  sum_pieces<T, 0, MT>(tot, P, tl, pr, pc, ring, x_empty);
  if constexpr (T == 2) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int i = 0; i < N / 2; ++i) {
        const int col = 8 * (i >> 2) + 2 * q + (i & 1);
        const float v = __fadd_rn(tot[mt][i], __ldg(bias + col));
        tot[mt][i] = v >= 0.0f ? v : __fmul_rn(v, slope);
      }
    skip_piece<MT>(P, tl, pr, pc, ring);
  }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int m = (tl.wg + 2 * mt) * 64 + tl.warp * 16 + g + 8 * hf;
      if (m >= PT) continue;
      const int r = m / WT;
      const int c = m - r * WT;
      const int fy = tl.y0 - kHalo + T + r;
      const int fx = tl.x0 - kHalo + T + c;
      const bool inside = fy >= 0 && fy < tl.h && fx >= 0 && fx < tl.w;
#pragma unroll
      for (int j = 0; j < N / 8; ++j) {
        const int col = 8 * j + 2 * q;
        const int i0 = 4 * j + 2 * hf;
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if constexpr (T == 2) {
            v[e] = __fadd_rn(tot[mt][i0 + e],
                             __fadd_rn(P[mt][i0 + e], __ldg(bpack + 4 * kGC + kNF + col + e)));
          } else {
            v[e] = __fadd_rn(tot[mt][i0 + e], __ldg(bias + col + e));
            if constexpr (T < 5) v[e] = v[e] >= 0.0f ? v[e] : __fmul_rn(v[e], slope);
          }
        }
        if constexpr (T < 5) {
          if constexpr (T == 4) {
            const float2 c2 = *reinterpret_cast<const float2*>(
                c2f + (r * reg_w(4) + c) * kGC + col);
            v[0] = __fadd_rn(v[0], c2.x);
            v[1] = __fadd_rn(v[1], c2.y);
          }
          v[0] = inside ? v[0] : 0.0f;
          v[1] = inside ? v[1] : 0.0f;
          if constexpr (T == 2) {
            const int r4 = r - 2;
            const int c4 = c - 2;
            if (r4 >= 0 && r4 < reg_h(4) && c4 >= 0 && c4 < reg_w(4)) {
              *reinterpret_cast<float2*>(c2f + (r4 * reg_w(4) + c4) * kGC + col) =
                  make_float2(v[0], v[1]);
            }
          }
          *reinterpret_cast<__nv_bfloat162*>(tl.smp + c_off(T) + chunk_off<4>(m, col >> 3) +
                                             (col & 7) * 2) =
              __floats2bfloat162_rn(v[0], v[1]);
        } else {
          if (!inside) continue;
          const size_t px = (((size_t)tl.f * tl.h + fy) * tl.w + fx) * kNF + col;
          const __nv_bfloat162 xv = *reinterpret_cast<const __nv_bfloat162*>(x + px);
          const float o0 = __fadd_rn(__low2float(xv), __fmul_rn(0.2f, v[0]));
          const float o1 = __fadd_rn(__high2float(xv), __fmul_rn(0.2f, v[1]));
          *reinterpret_cast<__nv_bfloat162*>(out + px) = __floats2bfloat162_rn(o0, o1);
        }
      }
    }
  }
}

// Stage T for this consumer warpgroup, then a barrier of the consumers
// (the next stage reads both warpgroups' c_T).
template <int T>
__device__ __forceinline__ void run_stage(const Tile& tl, Ring& ring, uint32_t x_empty,
                                          const __nv_bfloat16* __restrict__ x,
                                          __nv_bfloat16* __restrict__ out,
                                          const float* __restrict__ bpack, float slope) {
  if (tl.wg == 0) {
    stage<T, wg_mtiles(T, 0)>(tl, ring, x_empty, x, out, bpack, slope);
  } else {
    stage<T, wg_mtiles(T, 1)>(tl, ring, x_empty, x, out, bpack, slope);
  }
  consumers_sync();
}

__global__ void __launch_bounds__(kThreads, 1)
rdb_block_sm90_kernel(const __grid_constant__ CUtensorMap x_map,
                      const __nv_bfloat16* __restrict__ x,
                      __nv_bfloat16* __restrict__ out,
                      const unsigned char* __restrict__ wstream,
                      const float* __restrict__ bpack, int h, int w, float slope,
                      int ntiles) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* sm = smem_raw + (base - raw);
  const uint32_t bars = base + kBarOff;
  const uint32_t x_full = bars + 8 * 2 * kSlots;
  const uint32_t x_empty = x_full + 8;
  const int tid = threadIdx.x;
  const int ncol = (w + kTW - 1) / kTW;
  const int nband = (h + kTH - 1) / kTH;

  if (tid == 0) {
    for (int i = 0; i < kSlots; ++i) {
      mbar_init(bars + 8 * i, 1);
      mbar_init(bars + 8 * (kSlots + i), kConsumerThreads / 32);
    }
    mbar_init(x_full, 1);
    mbar_init(x_empty, kConsumerThreads / 32);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumerThreads) {  // the producer warpgroup: one thread copies
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;" ::: "memory");
    if (tid != kConsumerThreads) return;
    auto load_x = [&](int t) {
      const int col = t % ncol;
      const int band = (t / ncol) % nband;
      const int f = t / (ncol * nband);
      mbar_expect_tx(x_full, kXBytes);
      // the box starts kHalo pixels up and left of the tile: TMA zero-fills
      // everything outside the frame
      tma_load_4d(base + kXOff, &x_map, x_full, 0, col * kTW - kHalo,
                  band * kTH - kHalo, f);
    };
    int blk = 0;
    int it = 0;
    for (int t = blockIdx.x; t < ntiles; t += gridDim.x, ++it) {
      if (it == 0) load_x(t);
      int off = 0;
      int b = 0;
      for (int tt = 1; tt <= 5; ++tt) {
        for (int s = 0; s <= tt; ++s) {
          if (s == tt && tt != 2) break;  // s == tt: c2's skip block
          const int nb = s == tt ? 1 : piece_blocks(tt, s);
          const int bytes = s == tt ? kSkipBytes : block_bytes(tt, s);
          for (int i = 0; i < nb; ++i, ++b, ++blk, off += bytes) {
            if (b == kXReload && t + (int)gridDim.x < ntiles) {
              mbar_wait(x_empty, it & 1);
              load_x(t + gridDim.x);
            }
            const int slot = blk % kSlots;
            if (blk >= kSlots) mbar_wait(bars + 8 * (kSlots + slot), ((blk / kSlots) - 1) & 1);
            mbar_expect_tx(bars + 8 * slot, bytes);
            bulk_load(base + kRingOff + slot * kSlotBytes, wstream + off, bytes,
                      bars + 8 * slot);
          }
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;" ::: "memory");
  Tile tl;
  tl.sm = base;
  tl.smp = sm;
  tl.wg = tid >> 7;
  tl.warp = (tid >> 5) & 3;
  tl.lane = tid & 31;
  tl.h = h;
  tl.w = w;
  Ring ring{base + kRingOff, bars, 0};
  int it = 0;
  for (int t = blockIdx.x; t < ntiles; t += gridDim.x, ++it) {
    const int col = t % ncol;
    const int band = (t / ncol) % nband;
    tl.f = t / (ncol * nband);
    tl.y0 = band * kTH;
    tl.x0 = col * kTW;
    mbar_wait(x_full, it & 1);
    run_stage<1>(tl, ring, x_empty, x, out, bpack, slope);
    run_stage<2>(tl, ring, x_empty, x, out, bpack, slope);
    run_stage<3>(tl, ring, x_empty, x, out, bpack, slope);
    run_stage<4>(tl, ring, x_empty, x, out, bpack, slope);
    run_stage<5>(tl, ring, x_empty, x, out, bpack, slope);
  }
}

}  // namespace uvt_rdb_sm90

extern "C" {

// One dense block on the Hopper kernel.  x and out (N, h, w, 64) bf16,
// contiguous, distinct, 16-byte aligned; wstream the 241,664 bf16 of
// ops/rdb.py:pack_rdb_weights_sm90; bpack (224,) f32 as packed by
// ops/rdb.py.  Returns a cudaError_t code (cudaErrorInvalidValue for a shape
// it does not take or a tensor map cuTensorMapEncodeTiled refuses).
int uvt_rdb_block_sm90(const void* x, void* out, const void* wstream,
                       const void* bpack, int n, int h, int w, float slope,
                       void* stream) {
  using namespace uvt_rdb_sm90;
  const long long tiles =
      (long long)n * ((h + kTH - 1) / kTH) * ((w + kTW - 1) / kTW);
  if (n < 1 || h < 1 || w < 1 || tiles > 0x7fffffff ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(wstream) % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap map;
  const cuuint64_t row = (cuuint64_t)kNF * 2;
  const cuuint64_t dims[4] = {(cuuint64_t)kNF, (cuuint64_t)w, (cuuint64_t)h,
                              (cuuint64_t)n};
  const cuuint64_t strides[3] = {row, row * w, row * w * h};
  const cuuint32_t box[4] = {(cuuint32_t)kNF, (cuuint32_t)reg_w(0),
                             (cuuint32_t)reg_h(0), 1};
  const cuuint32_t estride[4] = {1, 1, 1, 1};
  if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x), dims,
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
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(rdb_block_sm90_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const int grid = tiles < sms ? (int)tiles : sms;
  rdb_block_sm90_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      map, static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(out),
      static_cast<const unsigned char*>(wstream), static_cast<const float*>(bpack), h, w,
      slope, (int)tiles);
  return (int)cudaGetLastError();
}

}  // extern "C"
