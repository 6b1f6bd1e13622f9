// The persistent TMA-ring mainloop over a bordered NHWC bf16 buffer, with dx
// folded into K: one SAME 3x3 conv of CS input channels to NP output
// columns per tile of R output rows x 64 output columns, its epilogue a
// template parameter.  Shared by K1's narrow layers
// (conv3x3_chain_narrow_sm90.cu, the epilogue writing the next bordered
// buffer) and K2's Hopper kernel (sr_tail_sm90.cu, the SRVGG tail's
// epilogue).
//
// One block per SM, 384 threads: a producer warpgroup and two consumer
// warpgroups.
// - Persistent blocks walk tiles of R output rows x 64 output columns x all
//   output columns of one frame; the two consumers take alternate tiles,
//   so one's epilogue overlaps the other's MMAs.
// - Halo ring by TMA: a 4-D tensor map over the bordered input (C, W+2,
//   H+2, N), box C x 66 x (R+2) x 1, zero-filled past the buffer; up to 6
//   stages (as many as fit beside the weights), full/empty mbarriers; one
//   producer thread keeps the ring full (setmaxnreg 40; consumers 232).
// - dx folded into K: in a bordered NHWC row the taps x-1, x, x+1 of
//   output pixel x are 3*C contiguous channels, so one output row needs,
//   per dy, K = 3*C (24 for an 8-wide input, 72 for 24 channels, 192 for
//   64), rounded up to 16 with zero weight rows: 2, 5 or 12 k16 steps.
//   ldmatrix takes A for 64 pixels with rows 2*C bytes apart (16 or 48 B:
//   16-byte aligned and free of bank conflicts; the 64-channel halo is
//   128-byte swizzled by TMA, as in conv3x3_chain_sm90.cu).  The 16-byte
//   chunk of a k step that lies wholly in the zero-weight padding is read
//   from the step's other chunk instead, so no read leaves the halo row.
// - A-fragment reuse: each halo row's fragments are loaded once and issued
//   against every output row they feed (dy = 0..2); A is double-buffered
//   across halo rows (wgmma.wait_group 1).
// - Resident weights in wgmma's K-major B layout: per dy, 64-wide K atoms
//   of NP lines x 128 bytes with the 128-byte swizzle, padded rows and
//   columns zero.  The host packs the image once
//   (ops/conv_chain.py:pack_ring_weights); each block copies it into
//   shared memory and reads it through descriptors for every tile.
//
// The epilogue type E supplies:
//   kOutBytes                  shared memory it stages a tile in (over the
//                              tile's own halo stage when it fits, else
//                              beside it);
//   kSideBytes                 shared memory of its own per consumer, kept
//                              across tiles (0 for none);
//   consts(cs, chunk, tid)     fills 2*NP floats of per-column constants
//                              (bias, slope), before the block's first tile
//                              (chunk is 0: the ring computes every column);
//   prefetch(side, valid, at, slot, wt)
//                              starts a tile's own loads into side buffer
//                              slot (cp.async, one committed group a call;
//                              valid false commits an empty group), one tile
//                              ahead: the next tile's during this tile's
//                              epilogue;
//   store(acc, side, out, cs, chunk, at, slot, c, warp, lane, wt)
//                              the tile's epilogue, called by consumer c
//                              after every warp of it is done with the halo
//                              (named barrier 1 + c); out points at its
//                              stage.  When it returns, the halo stage goes
//                              back to the producer.

#pragma once

#include "sm90_common.cuh"

namespace uvt_ring {

using namespace uvt_sm90_common;

constexpr int kTW = 64;                   // output columns per tile (wgmma M)
constexpr int kHaloCols = kTW + 2;
constexpr int kWGs = 2;                   // consumer warpgroups
constexpr int kThreads = (kWGs + 1) * 128;  // + the producer warpgroup
constexpr int kSmemLimit = 232448;
constexpr int kMaxStages = 6;

constexpr int round_up(int v, int m) { return (v + m - 1) / m * m; }
constexpr int max_of(int a, int b) { return a > b ? a : b; }
constexpr int min_of(int a, int b) { return a < b ? a : b; }

// The shared-memory plan of one shape: CS input channels (8 for a
// 3-channel input), NP output columns (wgmma's N), R output rows per tile,
// OUT the epilogue's stage bytes per tile, SIDE its own bytes per consumer.
template <int CS, int NP, int R, int OUT, int SIDE>
struct Plan {
  static constexpr int kCSB = CS * 2;             // bytes per input pixel
  static constexpr bool kSwz = CS == 64;          // 128-byte swizzled halo
  static constexpr int kKS = (3 * CS + 15) / 16;  // k16 steps per dy
  static constexpr int kAtoms = (kKS + 3) / 4;    // 64-wide K atoms per dy
  static constexpr int kAtomBytes = NP * 128;
  static constexpr int kWBytes = 3 * kAtoms * kAtomBytes;
  static constexpr int kHaloRows = R + 2;
  static constexpr int kStageTx = kHaloRows * kHaloCols * kCSB;
  // the epilogue stages over the halo when it fits, else beside it
  static constexpr int kOutOff = OUT <= kStageTx ? 0 : round_up(kStageTx, 1024);
  static constexpr int kStageBytes = round_up(max_of(kStageTx, kOutOff + OUT), 1024);
  // alignment slack, weights, per-column constants, the epilogue's side
  // areas; per stage its bytes and two barriers
  static constexpr int kFixed = 1024 + kWBytes + 2 * NP * 4 + kWGs * SIDE;
  static constexpr int kStages =
      min_of(kMaxStages, (kSmemLimit - kFixed) / (kStageBytes + 16));
  static constexpr int kSmem = kFixed + kStages * (kStageBytes + 16);
  static_assert(kStages >= 3, "the halo ring needs three stages");
  static_assert(kSmem <= kSmemLimit, "shared memory plan exceeds the block limit");
  static_assert(kAtomBytes % 1024 == 0, "weight atoms must stay 1024-aligned");
  static_assert((3 * CS) % 8 == 0, "K must fill whole 16-byte chunks");
};

template <int CS, int NP, int R, class E>
using PlanOf = Plan<CS, NP, R, E::kOutBytes, E::kSideBytes>;

// The whole kernel body: every thread of the block calls it.
template <int CS, int NP, int R, class E>
__device__ __forceinline__ void ring_conv(const CUtensorMap& src_map,
                                          const __nv_bfloat16* __restrict__ wpack,
                                          int h, int w, int ntiles, const E& epi) {
  using P = PlanOf<CS, NP, R, E>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* sm = smem_raw + (base - raw);
  const uint32_t ring = base + P::kWBytes;
  const uint32_t bars = ring + P::kStages * P::kStageBytes;  // full[s], then empty[s]
  float* cs_s = reinterpret_cast<float*>(sm + (bars - base) + 2 * P::kStages * 8);
  unsigned char* sides = reinterpret_cast<unsigned char*>(cs_s + 2 * NP);
  const int ncol = (w + kTW - 1) / kTW;
  const int nband = (h + R - 1) / R;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < P::kStages; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (P::kStages + s), 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // resident weights: the packed image, already in the swizzled B layout
  for (int i = tid; i < P::kWBytes / 16; i += kThreads) {
    reinterpret_cast<uint4*>(sm)[i] = reinterpret_cast<const uint4*>(wpack)[i];
  }
  epi.consts(cs_s, 0, tid);
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncthreads();

  const int wg = tid >> 7;
  if (wg == 0) {  // producer warpgroup: one thread keeps the TMA ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;" ::: "memory");
    if (tid == 0) {
      int k = 0;
      for (int t = blockIdx.x; t < ntiles; t += gridDim.x, ++k) {
        const int s = k % P::kStages;
        if (k >= P::kStages) {
          mbar_wait(bars + 8 * (P::kStages + s), ((k / P::kStages) - 1) & 1);
        }
        const int col = t % ncol;
        const int band = (t / ncol) % nband;
        const int f = t / (ncol * nband);
        const uint32_t full = bars + 8 * s;
        mbar_expect_tx(full, P::kStageTx);
        tma_load_4d(ring + s * P::kStageBytes, &src_map, full, 0, col * kTW,
                    band * R, f);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;" ::: "memory");

  // consumer warpgroup c takes every other tile of the block's walk
  const int c = wg - 1;
  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int wt = tid & 127;
  const uint64_t wdesc = desc_sw128(base);
  const uint32_t jx = (uint32_t)(warp * 16 + (lane & 15));  // this lane's A row
  const uint32_t hi = (uint32_t)(lane >> 4);                // its 16-byte chunk

  unsigned char* side = sides + c * E::kSideBytes;
  int t = blockIdx.x + c * gridDim.x;
  const auto at = [&](int tile) {
    return TileAt{tile / (ncol * nband), (tile / ncol) % nband * R, tile % ncol * kTW};
  };
  epi.prefetch(side, t < ntiles, at(t), 0, wt);
  for (int k = c, it = 0; t < ntiles; k += kWGs, t += kWGs * gridDim.x, ++it) {
    const int s = k % P::kStages;
    const uint32_t stage = ring + s * P::kStageBytes;
    float acc[R][NP / 2];
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int i = 0; i < NP / 2; ++i) acc[r][i] = 0.0f;
      fence_acc(acc[r]);
    }
    // the stage's previous tile (the other warpgroup's) was consumed, so
    // the full barrier is in this tile's phase: a parity wait alone cannot
    // tell a phase from the one two back
    if (k >= P::kStages) {
      mbar_wait(bars + 8 * (P::kStages + s), ((k / P::kStages) - 1) & 1);
    }
    mbar_wait(bars + 8 * s, (k / P::kStages) & 1);

    // one group per halo row: its kKS A fragments (the dx-folded K of 64
    // pixels), issued against every output row hr - dy they feed
    uint32_t a[2][P::kKS][4];
#pragma unroll
    for (int hr = 0; hr < P::kHaloRows; ++hr) {
      const int b = hr & 1;
#pragma unroll
      for (int kk = 0; kk < P::kKS; ++kk) {
        uint32_t addr;
        if (P::kSwz) {
          addr = stage + swz((uint32_t)hr * kHaloCols + jx + kk / 4, 2 * (kk % 4) + hi);
        } else {
          uint32_t koff = 32u * kk + 16u * hi;
          // a chunk wholly in the zero-weight padding reads its neighbour
          if (32 * kk + 16 >= 3 * P::kCSB) koff -= 16u * hi;
          addr = stage + ((uint32_t)hr * kHaloCols + jx) * P::kCSB + koff;
        }
        ldsm_x4(addr, a[b][kk]);
      }
      wg_fence();
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        const int r = hr - dy;
        if (r < 0 || r >= R) continue;
#pragma unroll
        for (int kk = 0; kk < P::kKS; ++kk) {
          wgmma_rs<NP>(acc[r], a[b][kk],
                       wdesc + (uint64_t)(((dy * P::kAtoms + kk / 4) * P::kAtomBytes +
                                           (kk % 4) * 32) >> 4));
        }
      }
      wg_commit();
      wg_wait1();
    }
    wg_wait0();
#pragma unroll
    for (int r = 0; r < R; ++r) fence_acc(acc[r]);

    bar_sync(1 + c, 128);  // every warp of this warpgroup is done with the halo
    const int tn = t + kWGs * gridDim.x;  // this consumer's next tile
    epi.prefetch(side, tn < ntiles, at(tn), (it + 1) & 1, wt);
    epi.store(acc, side, sm + (stage - base) + P::kOutOff, cs_s, 0, at(t), it & 1, c,
              warp, lane, wt);
    // the stage may now be refilled by TMA (async proxy) after this
    // warpgroup's generic reads and writes
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    mbar_arrive(bars + 8 * (P::kStages + s));
  }
}

// Encodes the ring's 4-D tensor map over a bordered (N, h+2, w+2, CS) bf16
// buffer and launches `kernel` on one block per SM (no more than the
// tiles), with the tile count appended to `args`.  Returns a cudaError_t
// code.
template <int CS, int NP, int R, class E, class K, class... A>
static int launch_ring(K kernel, const void* src, int n, int h, int w,
                       cudaStream_t stream, A... args) {
  using P = PlanOf<CS, NP, R, E>;
  const long long tiles = (long long)n * ((h + R - 1) / R) * ((w + kTW - 1) / kTW);
  if (tiles > 0x7fffffff) return (int)cudaErrorInvalidValue;
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap map;
  const cuuint64_t dims[4] = {(cuuint64_t)CS, (cuuint64_t)w + 2, (cuuint64_t)h + 2,
                              (cuuint64_t)n};
  const cuuint64_t strides[3] = {(cuuint64_t)P::kCSB, (cuuint64_t)(w + 2) * P::kCSB,
                                 (cuuint64_t)(h + 2) * (w + 2) * P::kCSB};
  const cuuint32_t box[4] = {(cuuint32_t)CS, (cuuint32_t)kHaloCols,
                             (cuuint32_t)P::kHaloRows, 1};
  const cuuint32_t estride[4] = {1, 1, 1, 1};
  if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(src), dims,
             strides, box, estride, CU_TENSOR_MAP_INTERLEAVE_NONE,
             P::kSwz ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
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
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             P::kSmem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (int)(tiles < sms ? tiles : sms);
  kernel<<<grid, kThreads, P::kSmem, stream>>>(map, args..., (int)tiles);
  return (int)cudaGetLastError();
}

}  // namespace uvt_ring
