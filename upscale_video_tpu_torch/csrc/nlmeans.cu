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
// over the 81 offsets t = (dy, dx) in [0, 8]^2, taken in the JAX order (dy
// then dx).  The centre offset has d = 0 and weight exactly 1, so the
// denominator is at least 1.
//
// Design: one block per 16x32 output tile of one frame, grid (tiles_x,
// tiles_y, N), so one launch covers the whole batch.  The block stages the
// haloed window (16+12) x (32+12) x 3 f32 in shared memory, reflecting the
// indices while it loads, so no padded copy of the frame exists in device
// memory.  Each of the 256 threads owns two output pixels and keeps their
// numerators and denominators in registers across the 81 offsets.  Per
// offset the block writes D over the tile's 20 x 36 patch region to shared
// memory, sums it over 5 rows, then each thread sums 5 columns for its
// pixels (the Pallas kernel's row-then-column order), applies expf (the
// accurate one, not __expf) and accumulates.  Nothing of the TPU kernel's
// (8, 128) DMA over-fetch, roll trick or planar transpose is carried over.
//
// Bound on the H100: operations.  A 1080p frame is 168M (pixel, offset)
// pairs of ~26 f32 operations and one exp each; the frame in and out is
// 50 MB.  This first version spends ~26 shared-memory accesses per pair,
// so shared-memory bandwidth, not the FP32 or SFU rate, limits it.

#include <cuda_runtime.h>

namespace uvt {
namespace nlm {

constexpr int kPatch = 2;                    // patch radius (5x5)
constexpr int kSearch = 4;                   // search radius (9x9)
constexpr int kPad = kPatch + kSearch;       // 6
constexpr int kOffsets = 2 * kSearch + 1;    // 9 per axis
constexpr int kTileH = 16;
constexpr int kTileW = 32;
constexpr int kThreads = 256;
constexpr int kPix = kTileH * kTileW / kThreads;   // output pixels per thread
constexpr int kWinH = kTileH + 2 * kPad;           // 28
constexpr int kWinW = kTileW + 2 * kPad;           // 44
constexpr int kDistH = kTileH + 2 * kPatch;        // 20
constexpr int kDistW = kTileW + 2 * kPatch;        // 36

static_assert(kTileH * kTileW % kThreads == 0, "tile must split evenly");

// numpy's 'reflect' index for any i (also far outside [0, n)): the frame
// repeats with period 2(n - 1) as a triangle wave; a 1-pixel axis repeats.
__device__ __forceinline__ int reflect(int i, int n) {
  if (n == 1) return 0;
  const int period = 2 * (n - 1);
  i %= period;
  if (i < 0) i += period;
  return i < n ? i : period - i;
}

__global__ void __launch_bounds__(kThreads)
nl_means_kernel(const float* __restrict__ x, float* __restrict__ out, int h,
                int w, float inv_h2, float two_s2) {
  __shared__ float win[3][kWinH][kWinW];
  __shared__ float dist[kDistH][kDistW];
  __shared__ float vsum[kTileH][kDistW];

  const int n = blockIdx.z;
  const int y0 = blockIdx.y * kTileH;
  const int x0 = blockIdx.x * kTileW;
  const float* img = x + (size_t)n * h * w * 3;

  for (int i = threadIdx.x; i < kWinH * kWinW; i += kThreads) {
    const int r = i / kWinW;
    const int c = i - r * kWinW;
    const int sy = reflect(y0 - kPad + r, h);
    const int sx = reflect(x0 - kPad + c, w);
    const float* p = img + ((size_t)sy * w + sx) * 3;
    win[0][r][c] = p[0];
    win[1][r][c] = p[1];
    win[2][r][c] = p[2];
  }

  float num[kPix][3];
  float den[kPix];
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    num[k][0] = num[k][1] = num[k][2] = 0.0f;
    den[k] = 0.0f;
  }
  __syncthreads();

  for (int dy = 0; dy < kOffsets; ++dy) {
    for (int dx = 0; dx < kOffsets; ++dx) {
      // D over the patch region: base at window (4 + r, 4 + c), the
      // search offset at (dy + r, dx + c)
      for (int i = threadIdx.x; i < kDistH * kDistW; i += kThreads) {
        const int r = i / kDistW;
        const int c = i - r * kDistW;
        const float a0 = win[0][kSearch + r][kSearch + c] - win[0][dy + r][dx + c];
        const float a1 = win[1][kSearch + r][kSearch + c] - win[1][dy + r][dx + c];
        const float a2 = win[2][kSearch + r][kSearch + c] - win[2][dy + r][dx + c];
        dist[r][c] = (a0 * a0 + a1 * a1 + a2 * a2) * (1.0f / 3.0f);
      }
      __syncthreads();
      for (int i = threadIdx.x; i < kTileH * kDistW; i += kThreads) {
        const int r = i / kDistW;
        const int c = i - r * kDistW;
        float s = dist[r][c];
#pragma unroll
        for (int m = 1; m <= 2 * kPatch; ++m) s += dist[r + m][c];
        vsum[r][c] = s;
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < kPix; ++k) {
        const int p = threadIdx.x + k * kThreads;
        const int r = p / kTileW;
        const int c = p - r * kTileW;
        float s = vsum[r][c];
#pragma unroll
        for (int m = 1; m <= 2 * kPatch; ++m) s += vsum[r][c + m];
        const float d = s * (1.0f / 25.0f);
        const float wt = expf(-fmaxf(d - two_s2, 0.0f) * inv_h2);
        num[k][0] += wt * win[0][dy + kPatch + r][dx + kPatch + c];
        num[k][1] += wt * win[1][dy + kPatch + r][dx + kPatch + c];
        num[k][2] += wt * win[2][dy + kPatch + r][dx + kPatch + c];
        den[k] += wt;
      }
      // dist is rewritten by the next offset only after every thread has
      // read vsum, which depends on it
      __syncthreads();
    }
  }

#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    const int p = threadIdx.x + k * kThreads;
    const int oy = y0 + p / kTileW;
    const int ox = x0 + p % kTileW;
    if (oy < h && ox < w) {
      float* o = out + (((size_t)n * h + oy) * w + ox) * 3;
      o[0] = num[k][0] / den[k];
      o[1] = num[k][1] / den[k];
      o[2] = num[k][2] / den[k];
    }
  }
}

}  // namespace nlm
}  // namespace uvt

extern "C" {

// NL-means over a batch.  x and out: (n, h, w, 3) f32, contiguous, not
// aliased; inv_h2 = 1 / max((h / 255)^2, 1e-12) and two_s2 = 2 (sigma /
// 255)^2, computed by the caller in f32.  Returns a cudaError_t code.
int uvt_nl_means(const void* x, void* out, int n, int h, int w, float inv_h2,
                 float two_s2, void* stream) {
  using namespace uvt::nlm;
  if (n < 1 || h < 1 || w < 1 || n > 65535 ||
      (h + kTileH - 1) / kTileH > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid((w + kTileW - 1) / kTileW, (h + kTileH - 1) / kTileH, n);
  nl_means_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), h, w, inv_h2,
      two_s2);
  return (int)cudaGetLastError();
}

}  // extern "C"
