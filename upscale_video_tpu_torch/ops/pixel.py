"""Pixel-domain ops: normalization, channel order, the planar interleave.

Port of ``upscale_video_tpu/ops/pixel.py:23-108``.  The models see **BGR
floats in [0, 1]** (the reference's cv2/ncnn feed); frames are uint8 RGB.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


def rgb_to_bgr(x: torch.Tensor) -> torch.Tensor:
    """Flip the channel axis (last dim). Involution: also bgr_to_rgb."""
    return x.flip(-1)


bgr_to_rgb = rgb_to_bgr


def frames_to_model(frames_u8: torch.Tensor,
                    channel_order: str = "bgr") -> torch.Tensor:
    """uint8 RGB frames (N, H, W, 3) -> model-domain float32 in [0, 1].

    Multiplies by the float32 reciprocal of 255, as the JAX original does,
    so both packages feed bit-identical inputs to the model."""
    x = frames_u8.to(torch.float32) * (1.0 / 255.0)
    if channel_order == "bgr":
        x = rgb_to_bgr(x)
    return x


def model_to_frames(y: torch.Tensor, channel_order: str = "bgr") -> torch.Tensor:
    """Model output float -> uint8 RGB frames: ``x255``, round half to
    even (``torch.round``, like ``jnp.round``), clamp."""
    if channel_order == "bgr":
        y = bgr_to_rgb(y)
    y = torch.clamp(torch.round(y.to(torch.float32) * 255.0), 0.0, 255.0)
    return y.to(torch.uint8)


def frames_to_planar(f: torch.Tensor, s: int) -> torch.Tensor:
    """The inverse of :func:`planar_to_frames` on the device: frames ``(N,
    H*s, W*s, C)`` -> shuffle-planar ``(N, H, W, s*s*C)`` in ``(i, j, c)``
    plane order."""
    n, hs, ws, c = f.shape
    h, w = hs // s, ws // s
    return (f.reshape(n, h, s, w, s, c).permute(0, 1, 3, 2, 4, 5)
            .reshape(n, h, w, s * s * c))


def pad_to_multiple(x: torch.Tensor, multiple_h: int, multiple_w: int
                    ) -> Tuple[torch.Tensor, Tuple[int, int]]:
    """Pad H/W (axes -3/-2) up to multiples by repeating the last row and
    column; returns (padded, (ph, pw)), ``x`` itself when no pad is due
    (``upscale_video_tpu/ops/pixel.py:111``, its ``edge`` mode)."""
    h, w = x.shape[-3], x.shape[-2]
    ph = (-h) % multiple_h
    pw = (-w) % multiple_w
    if ph == 0 and pw == 0:
        return x, (0, 0)
    rows = torch.clamp(torch.arange(h + ph, device=x.device), max=h - 1)
    cols = torch.clamp(torch.arange(w + pw, device=x.device), max=w - 1)
    return x.index_select(-3, rows).index_select(-2, cols), (ph, pw)


def planar_to_frames(p: np.ndarray, s: int,
                     out: Optional[np.ndarray] = None) -> np.ndarray:
    """Host-side pixel-shuffle interleave of a *shuffle-planar* frame.

    ``p`` is uint8 ``(H, W, 3*s*s)`` (or batched ``(N, H, W, 3*s*s)``) in
    ``(i, j, c)`` plane order — what the tail kernel's ``planar`` layout
    writes.  Returns ``(H*s, W*s, c)``.  Uses the repo's native threaded
    interleave (:mod:`upscale_video_tpu_torch.native.imgproc`) where it
    builds, else one numpy transpose-copy.
    """
    p = np.asarray(p)
    if p.ndim == 4:
        if out is None:
            return np.stack([planar_to_frames(f, s) for f in p])
        for i in range(p.shape[0]):
            planar_to_frames(p[i], s, out=out[i])
        return out
    h, w, c = p.shape
    if c % (s * s):
        raise ValueError(f"{c} planes not divisible by s*s for s={s}")
    co = c // (s * s)
    if p.dtype == np.uint8 and s > 1:
        from upscale_video_tpu_torch.native.imgproc import (
            native_available, planar_interleave,
        )

        if native_available():
            return planar_interleave(p, s, out=out, channels=co)
    v = p.reshape(h, w, s, s, co).transpose(0, 2, 1, 3, 4)
    if out is not None:
        np.copyto(out.reshape(h, s, w, s, co), v)
        return out
    return np.ascontiguousarray(v).reshape(h * s, w * s, co)


def psnr(a: np.ndarray, b: np.ndarray, peak: float = 255.0) -> float:
    """PSNR in dB between two arrays (``upscale_video_tpu/ops/pixel.py:140``)."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    mse = np.mean((a - b) ** 2)
    if mse == 0:
        return float("inf")
    return 10.0 * np.log10(peak * peak / mse)
