// K6: NL-means colour denoise (5x5 patch, 9x9 search), for Hopper (sm_90a).
//
// Replaces upscale_video_tpu/ops/nlmeans_pallas.py:_nlm_kernel (reached via
// nl_means_denoise_pallas) and computes what ops/nlmeans.py:nl_means_denoise
// computes, per frame of an NHWC f32 batch (C = 3):
//
//   xp      = numpy-'reflect' pad of the frame by 6 (no edge repeat)
//   D_t(q)  = mean over the 3 channels of (xp(q + 4) - xp(q + t))^2
//   d_t(p)  = (5x5 box sum of D_t around p) / 25
//   w_t(p)  = exp(-max(d_t(p) - 2 s^2, 0) / h^2)        (h, s in [0, 1] units)
//   out(p)  = sum_t w_t(p) xp(p + t + 2) / sum_t w_t(p)
//
// over the 81 offsets t = (dy, dx) in [0, 8]^2.  The centre offset has d = 0
// and weight exactly 1, so the denominator is at least 1.
//
// Bound on the H100: operations.  A 1080p frame is 168M (pixel, offset)
// pairs of ~26 f32 operations and one exp each; the frame in and out is
// 50 MB.  A kernel that stages D and its row sums in shared memory for
// every offset (the design this one replaced) spends ~25 shared-memory
// accesses a pair and is held by the shared-memory pipe (one warp-wide
// access per clock per SM).  This design keeps every value in registers
// from the window load to the accumulation, so it is held by instruction
// issue (four warp instructions per clock per SM); chip_smoke.py's
// [K6_time] counts its main loop's instructions from the built SASS.
//
// Design: a warp owns 32 adjacent patch columns and a strip of kRows (R)
// rows; lane l computes D and its 5-row sums for its column, and lanes
// 0..27 take the 5-column sum from lanes l..l+4 by warp shuffles and store
// output column l (lanes 28..31 are the box halo: they compute on
// reflected pixels like every lane and store nothing, so no lane leaves
// before a shuffle).  A block of kWarpsX x kWarpsY warps stages its haloed
// window once in shared memory, planar per channel, reflecting the indices
// while it loads, so no padded copy of the frame exists in device memory.
// Each thread keeps its R + 4 base values in registers for the whole
// kernel and, for each of the 9 column offsets dx, reads its shifted
// column (R + 12 rows) and its centre column (R + 8 rows) from shared
// memory into registers as the unrolled loop over the 9 row offsets dy
// needs them; the dy loop is unrolled so that every register array is
// indexed by a constant.  Per pair that is ~1.7 shared loads and 3
// shuffles where the staged design took ~25 accesses.  R = 6 with 4 warps
// a block (~128 registers, so 4 blocks an SM) was the fastest of the
// geometries tried on the H100: R from 4 to 10, 96 to 256 threads, one or
// two warps across.
//
// Arithmetic, cut to what the issue rate allows: D is 3x the channel mean
// (the 1/3 joins the box's 1/25); the 5-row sum is (D0 + D1) + (D2 + D3) +
// D4 with the pairs shared by neighbouring rows; the 5-column sum is
// ((v0 + v1) + (v2 + v3)) + v4 by three shuffles; the weight is one FFMA,
// a min and the SFU's ex2.approx.  Every sum is of non-negative terms, so
// each order is a few ulps of d from the plain version's (rows, then
// columns, left to right); the largest weight exponent that still counts
// (~20) turns that into ~1e-6 of the output, against K6's 1e-5 limit.
// The offsets accumulate dx-major, not in the JAX order (dy then dx).
// Nothing of the TPU kernel's (8, 128) DMA over-fetch, roll trick or
// planar transpose is carried over; wgmma has no product to take, and
// TF32 or bf16 distances would move the weights by ~1% (inv_h2 is 7225 at
// h = 3).

#include <cuda_runtime.h>

namespace uvt {
namespace nlm {

constexpr int kPatch = 2;                    // patch radius (5x5)
constexpr int kSearch = 4;                   // search radius (9x9)
constexpr int kPad = kPatch + kSearch;       // 6
constexpr int kOffsets = 2 * kSearch + 1;    // 9 per axis
constexpr int kLanes = 32;
constexpr int kOutCols = kLanes - 2 * kPatch;  // 28 output columns a warp
// the geometry (ops/nlmeans.py:nlm_launch_plan mirrors it): output rows
// a thread, warps of a block across and down
constexpr int kRows = 6;
constexpr int kWarpsX = 1;
constexpr int kWarpsY = 4;
constexpr int kThreads = kLanes * kWarpsX * kWarpsY;
constexpr int kTileW = kWarpsX * kOutCols;
constexpr int kTileH = kWarpsY * kRows;
// window columns: the tile, the pad on both sides, and 2 more that only
// the halo lanes' centre reads reach at dx = 8
constexpr int kWinW = kTileW + 2 * kPad + 2;
constexpr int kWinH = kTileH + 2 * kPad;
constexpr int kPlane = kWinH * kWinW;
constexpr unsigned kFull = 0xffffffffu;

static_assert(3 * kPlane * sizeof(float) <= 48 * 1024, "static shared memory");

// numpy's 'reflect' index for any i (also far outside [0, n)): the frame
// repeats with period 2(n - 1) as a triangle wave; a 1-pixel axis repeats.
__device__ __forceinline__ int reflect(int i, int n) {
  if (i >= 0 && i < n) return i;
  if (n == 1) return 0;
  const int period = 2 * (n - 1);
  i %= period;
  if (i < 0) i += period;
  return i < n ? i : period - i;
}

// 2^x by the SFU (ex2.approx: relative error ~2^-22), flushing denormals
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__global__ void __launch_bounds__(kThreads)
nl_means_sm90(const float* __restrict__ x, float* __restrict__ out, int h,
              int w, float inv_h2, float two_s2) {
  constexpr int R = kRows;
  // w = exp(-max(t / 75 - 2 s^2, 0) / h^2) = 2^min((2 s^2 - t / 75) k2, 0)
  // with k2 = log2(e) / h^2; t is 75 d (the 25 box terms of 3x the mean)
  const float k2 = inv_h2 * 1.44269504088896341f;
  const float k75 = k2 * (1.0f / 75.0f);
  const float s2k = two_s2 * k2;
  __shared__ float win[3 * kPlane];  // [3][kWinH][kWinW]
  const int n = blockIdx.z;
  const int y0 = blockIdx.y * kTileH;
  const int x0 = blockIdx.x * kTileW;
  const float* img = x + (size_t)n * h * w * 3;

  for (int i = threadIdx.x; i < kPlane; i += kThreads) {
    const int r = i / kWinW;
    const int c = i - r * kWinW;
    const int sy = reflect(y0 - kPad + r, h);
    const int sx = reflect(x0 - kPad + c, w);
    const float* p = img + ((size_t)sy * w + sx) * 3;
    win[i] = p[0];
    win[kPlane + i] = p[1];
    win[2 * kPlane + i] = p[2];
  }
  __syncthreads();

  const int lane = threadIdx.x % kLanes;
  const int warp = threadIdx.x / kLanes;
  const int wx = warp % kWarpsX;
  const int wy = warp / kWarpsX;
  // the strip's window origin: shifted row j at (row0 + j, col0 + dx),
  // base row i at (row0 + 4 + i, col0 + 4), centre row j at
  // (row0 + 2 + j, col0 + dx + 2)
  const int row0 = wy * R;
  const int col0 = wx * kOutCols + lane;

  float base[R + 2 * kPatch][3];
#pragma unroll
  for (int i = 0; i < R + 2 * kPatch; ++i) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      base[i][c] = win[c * kPlane + (row0 + kSearch + i) * kWinW + col0 + kSearch];
    }
  }
  float num[R][3];
  float den[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    num[r][0] = num[r][1] = num[r][2] = 0.0f;
    den[r] = 0.0f;
  }

#pragma unroll 1
  for (int dx = 0; dx < kOffsets; ++dx) {
    const float* sh = win + row0 * kWinW + col0 + dx;
    const float* ct = sh + kPatch * kWinW + kPatch;
    float s[R + 2 * kPad][3];
    float cen[R + 2 * kSearch][3];
#pragma unroll
    for (int dy = 0; dy < kOffsets; ++dy) {
      // the rows this dy reads first: s[dy .. dy + R + 3], cen[dy .. dy + R - 1]
#pragma unroll
      for (int j = (dy == 0 ? 0 : dy + R + 2 * kPatch - 1);
           j < dy + R + 2 * kPatch; ++j) {
#pragma unroll
        for (int c = 0; c < 3; ++c) s[j][c] = sh[c * kPlane + j * kWinW];
      }
#pragma unroll
      for (int j = (dy == 0 ? 0 : dy + R - 1); j < dy + R; ++j) {
#pragma unroll
        for (int c = 0; c < 3; ++c) cen[j][c] = ct[c * kPlane + j * kWinW];
      }

      float dist[R + 2 * kPatch];
#pragma unroll
      for (int i = 0; i < R + 2 * kPatch; ++i) {
        const float a0 = base[i][0] - s[i + dy][0];
        const float a1 = base[i][1] - s[i + dy][1];
        const float a2 = base[i][2] - s[i + dy][2];
        dist[i] = a0 * a0 + a1 * a1 + a2 * a2;  // 3x the channel mean
      }
      float pair[R + 3];  // D over 2 rows, shared by neighbouring row sums
#pragma unroll
      for (int i = 0; i < R + 3; ++i) pair[i] = dist[i] + dist[i + 1];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float v = (pair[r] + pair[r + 2]) + dist[r + 4];
        const float p2 = v + __shfl_down_sync(kFull, v, 1);
        const float p4 = p2 + __shfl_down_sync(kFull, p2, 2);
        const float t = p4 + __shfl_down_sync(kFull, v, 4);
        const float wt = ex2(fminf(fmaf(t, -k75, s2k), 0.0f));
        num[r][0] += wt * cen[r + dy][0];
        num[r][1] += wt * cen[r + dy][1];
        num[r][2] += wt * cen[r + dy][2];
        den[r] += wt;
      }
    }
  }

  const int ox = x0 + col0;
  if (lane < kOutCols && ox < w) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int oy = y0 + row0 + r;
      if (oy < h) {
        float* o = out + (((size_t)n * h + oy) * w + ox) * 3;
        o[0] = num[r][0] / den[r];
        o[1] = num[r][1] / den[r];
        o[2] = num[r][2] / den[r];
      }
    }
  }
}

}  // namespace nlm
}  // namespace uvt

extern "C" {

// NL-means over a batch.  x and out: (n, h, w, 3) f32, contiguous, not
// aliased; inv_h2 = 1 / max((h / 255)^2, 1e-12) and two_s2 = 2 (sigma /
// 255)^2, computed by the caller in f32.  Returns a cudaError_t code.
int uvt_nl_means_sm90(const void* x, void* out, int n, int h, int w,
                      float inv_h2, float two_s2, void* stream) {
  using namespace uvt::nlm;
  if (n < 1 || h < 1 || w < 1 || n > 65535 ||
      (h + kTileH - 1) / kTileH > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid((w + kTileW - 1) / kTileW, (h + kTileH - 1) / kTileH, n);
  nl_means_sm90<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), h, w, inv_h2,
      two_s2);
  return (int)cudaGetLastError();
}

}  // extern "C"
