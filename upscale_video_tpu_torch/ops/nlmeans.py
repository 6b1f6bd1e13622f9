"""K6: NL-means colour denoise — CUDA kernel wrapper + plain version.

Port of ``upscale_video_tpu/ops/nlmeans.py`` (``nl_means_denoise``, the
semantics) and of the TPU kernel ``upscale_video_tpu/ops/nlmeans_pallas.py:54``
``_nlm_kernel`` (replaced by ``csrc/nlmeans_sm90.cu``: register-blocked
column strips, 5-column box sums by warp shuffles).  Over a batch of
model-domain frames ``(N, H, W, C)`` f32 in [0, 1]:

- numpy ``reflect`` padding by 6 (no edge repeat; frames under 7 pixels
  on a side fold more than once);
- for each of the 81 offsets of the 9x9 search, in the JAX order (dy, then
  dx, from -4 to 4), the channel mean of the squared difference, its 5x5
  box sum (rows, then columns, as the Pallas kernel sums) divided by 25,
  and the weight ``exp(-max(d - 2 s^2, 0) / h^2)`` with ``h = K / 255``
  and ``s = sigma / 255``;
- ``num / den``, where the centre offset's weight is exactly 1.

:func:`nl_means_denoise` dispatches on the input's device: a CPU tensor
takes :func:`nl_means_denoise_plain`; a CUDA tensor launches the kernel (one
launch for the whole batch, 3 channels, on the grid that
:func:`nlm_launch_plan` gives) or raises.  ``nl_means_denoise.launches`` counts
kernel launches.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

PATCH_RADIUS = 2  # templateWindowSize = 5
SEARCH_RADIUS = 4  # searchWindowSize = 9
PAD = PATCH_RADIUS + SEARCH_RADIUS
# f32 operations per (pixel, offset) pair, beside one exp: the squared
# difference (3 sub, 3 mul, 2 add, 1 scale), the separable box sum (4 + 4
# adds, 1 scale), the weight (sub, max, mul) and the accumulation (3 mul,
# 4 add).  chip_smoke.py's bound for K6 counts these.
FLOPS_PER_PAIR = 26
# the kernel's geometry, as csrc/nlmeans_sm90.cu compiles it (kRows,
# kWarpsX, kWarpsY) and computes its grid:
# a warp's 32 lanes hold 32 patch columns, of which the first 28 store
# output (the last 4 only feed the 5-column box sum); each thread takes
# ROWS output rows of its column; a block is WARPS_X x WARPS_Y warps
LANES = 32
OUT_COLS = LANES - 2 * PATCH_RADIUS
ROWS, WARPS_X, WARPS_Y = 6, 1, 4
TILE_W, TILE_H = WARPS_X * OUT_COLS, WARPS_Y * ROWS  # a block's output
MAX_GRID_YZ = 65535  # CUDA's limit on gridDim.y and gridDim.z


def nlm_launch_plan(n: int, h: int, w: int) -> Tuple[int, int, int]:
    """The grid ``(x, y, z)`` of blocks of ``TILE_H x TILE_W`` output pixels
    that covers ``n`` frames of ``h x w`` once; raises where it would pass
    CUDA's limits on gridDim.y and gridDim.z."""
    if min(n, h, w) < 1:
        raise ValueError(f"nl_means_denoise: empty batch {n}x{h}x{w}")
    grid = (-(-w // TILE_W), -(-h // TILE_H), n)
    if grid[1] > MAX_GRID_YZ or n > MAX_GRID_YZ:
        raise ValueError(f"nl_means_denoise: {n}x{h}x{w} exceeds the grid "
                         f"limit ({grid[1]} rows of blocks, {n} frames)")
    return grid


def reflect_index(n: int, pad: int) -> np.ndarray:
    """Source index of each position of an axis of ``n`` padded by ``pad``
    on both sides in numpy's ``reflect`` mode (a triangle wave of period
    ``2 (n - 1)``; a 1-pixel axis repeats its pixel)."""
    i = np.arange(-pad, n + pad)
    if n == 1:
        return np.zeros_like(i)
    i = np.mod(i, 2 * (n - 1))
    return np.where(i < n, i, 2 * (n - 1) - i)


def filter_params(h: float, sigma: float = 0.0) -> Tuple[float, float]:
    """``(1 / h_eff^2, 2 s_eff^2)`` in f32, as ``nl_means_denoise`` computes
    them (``h_eff = h / 255``, ``s_eff = sigma / 255``, h_eff^2 floored at
    1e-12)."""
    f = np.float32
    h_eff = f(h) / f(255.0)
    s_eff = f(sigma) / f(255.0)
    inv_h2 = f(1.0) / max(h_eff * h_eff, f(1e-12))
    return float(inv_h2), float(f(2.0) * s_eff * s_eff)


def nl_means_denoise_plain(x: torch.Tensor, h: float,
                           sigma: float = 0.0) -> torch.Tensor:
    """The plain PyTorch version of K6 over ``(N, H, W, C)``; f32 result."""
    if x.ndim != 4:
        raise ValueError(f"frames must be (N, H, W, C), got {tuple(x.shape)}")
    n, hgt, wid, ch = x.shape
    pr, sr = PATCH_RADIUS, SEARCH_RADIUS
    inv_h2, two_s2 = filter_params(h, sigma)
    iy = torch.from_numpy(reflect_index(hgt, PAD)).to(x.device)
    ix = torch.from_numpy(reflect_index(wid, PAD)).to(x.device)
    xp = x.to(torch.float32)[:, iy][:, :, ix]
    base = xp[:, sr:sr + hgt + 2 * pr, sr:sr + wid + 2 * pr]
    num = torch.zeros((n, hgt, wid, ch), dtype=torch.float32, device=x.device)
    den = torch.zeros((n, hgt, wid), dtype=torch.float32, device=x.device)
    for dy in range(2 * sr + 1):
        for dx in range(2 * sr + 1):
            sh = xp[:, dy:dy + hgt + 2 * pr, dx:dx + wid + 2 * pr]
            diff2 = ((base - sh) ** 2).mean(dim=-1)
            rows = diff2[:, 0:hgt]
            for m in range(1, 2 * pr + 1):
                rows = rows + diff2[:, m:m + hgt]
            box = rows[:, :, 0:wid]
            for m in range(1, 2 * pr + 1):
                box = box + rows[:, :, m:m + wid]
            d = box * (1.0 / (2 * pr + 1) ** 2)
            w = torch.exp(-torch.clamp_min(d - two_s2, 0.0) * inv_h2)
            num = num + w[..., None] * sh[:, pr:pr + hgt, pr:pr + wid]
            den = den + w
    return num / den[..., None]


def nl_means_denoise(x: torch.Tensor, h: float,
                     sigma: float = 0.0) -> torch.Tensor:
    """Denoise a batch of model-domain frames ``(N, H, W, 3)``: ``h`` is the
    strength on the 0..255 scale (``-m n=K`` gives K), ``sigma`` the
    optional noise offset on the same scale."""
    if x.device.type == "cpu":
        return nl_means_denoise_plain(x, h, sigma)
    if x.device.type != "cuda":
        raise ValueError(f"nl_means_denoise: unsupported device {x.device}")
    if x.ndim != 4 or x.shape[-1] != 3:
        raise ValueError(f"nl_means_denoise takes (N, H, W, 3), got {tuple(x.shape)}")
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise TypeError(f"nl_means_denoise takes contiguous float32, got {x.dtype}")
    from upscale_video_tpu_torch.kernels import build

    n, hgt, wid, _ = x.shape
    nlm_launch_plan(n, hgt, wid)  # raises where the grid cannot hold the batch
    out = torch.empty_like(x)
    inv_h2, two_s2 = filter_params(h, sigma)
    build.launch(
        build.library().uvt_nl_means_sm90, x.device, "nl_means launch",
        x.data_ptr(), out.data_ptr(), n, hgt, wid, inv_h2, two_s2,
    )
    nl_means_denoise.launches += 1
    return out


nl_means_denoise.launches = 0
