"""YUV 4:2:0 contract: the packed output and the flat I420 input.

Port of ``upscale_video_tpu/ops/yuv.py:50-205``.  Layout: one packed uint8
array per frame on the low-res grid, ``(N, H, W, s*s + 2*(s//2)**2)`` with
channels ``[Y(i,j) | Cb(p,q) | Cr(p,q)]``; conversion is BT.601 from the
final uint8 RGB, chroma box-averaged over each 2x2 (convert-then-average).
``full_range=True`` emits JPEG levels (Y4M ``C420jpeg``).

The device-side conversions (:func:`yuv420_from_planar`,
:func:`yuv420_from_frames`, :func:`i420_to_model`) are plain torch: the
JAX package runs them as XLA code, not as a kernel.
:func:`yuv420_from_planar` is also the plain version of the SRVGG tails'
``"yuv420"`` layout (:mod:`~upscale_video_tpu_torch.ops.tail`), whose
Hopper kernels compute it in their epilogue.  The host assembly
:func:`packed_to_i420` is numpy.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from upscale_video_tpu_torch.ops.pixel import planar_to_frames

# BT.601 luma; full-range chroma scale factors
_KR, _KG, _KB = 0.299, 0.587, 0.114
_CB_K = 0.5 / (1.0 - _KB)
_CR_K = 0.5 / (1.0 - _KR)
# limited (studio) range: Y 16..235, C 16..240
_Y_SCALE, _Y_OFF = 219.0 / 255.0, 16.0
_C_SCALE = 224.0 / 255.0


def _encode(r, g, b, full_range: bool):
    """RGB (f32, 0..255) -> (y, cb_centered, cr_centered) f32; chroma is
    returned WITHOUT the +128 offset so callers can average first."""
    y = _KR * r + _KG * g + _KB * b
    cb = (b - y) * _CB_K
    cr = (r - y) * _CR_K
    if not full_range:
        y = _Y_OFF + y * _Y_SCALE
        cb = cb * _C_SCALE
        cr = cr * _C_SCALE
    return y, cb, cr


def _quant(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(x), 0.0, 255.0).to(torch.uint8)


def yuv420_from_planar(p: torch.Tensor, s: int,
                       full_range: bool = False) -> torch.Tensor:
    """Shuffle-planar uint8 RGB ``(N, H, W, 3*s*s)`` ((i, j, c) order, c
    fastest) -> packed 4:2:0 ``(N, H, W, s*s + 2*(s//2)**2)``; even ``s``."""
    if s % 2:
        raise ValueError(f"yuv420 planar contract needs even s, got {s}")
    n, h, w, c = p.shape
    if c != 3 * s * s:
        raise ValueError(f"{c} channels != 3*{s}*{s}")
    cs = s // 2
    x = p.to(torch.float32).reshape(n, h, w, s * s, 3)
    y, cb, cr = _encode(x[..., 0], x[..., 1], x[..., 2], full_range)

    def pool(u):  # average each 2x2 block of shuffle positions (i, j)
        v = u.reshape(n, h, w, cs, 2, cs, 2).mean(dim=(4, 6))
        return v.reshape(n, h, w, cs * cs)

    return torch.cat(
        [_quant(y), _quant(pool(cb) + 128.0), _quant(pool(cr) + 128.0)],
        dim=-1,
    )


def yuv420_from_frames(f: torch.Tensor,
                       full_range: bool = False) -> torch.Tensor:
    """uint8 RGB frames ``(N, H, W, 3)`` (H, W even) -> packed 4:2:0 on the
    half-res grid ``(N, H//2, W//2, 6)`` = [Y 2x2 block | Cb | Cr]."""
    n, h, w, c = f.shape
    if c != 3 or h % 2 or w % 2:
        raise ValueError(f"yuv420 needs (N, even, even, 3); got {tuple(f.shape)}")
    x = f.to(torch.float32)
    y, cb, cr = _encode(x[..., 0], x[..., 1], x[..., 2], full_range)
    y = y.reshape(n, h // 2, 2, w // 2, 2).permute(0, 1, 3, 2, 4)
    y = y.reshape(n, h // 2, w // 2, 4)
    cb = cb.reshape(n, h // 2, 2, w // 2, 2).mean(dim=(2, 4))[..., None]
    cr = cr.reshape(n, h // 2, 2, w // 2, 2).mean(dim=(2, 4))[..., None]
    return torch.cat(
        [_quant(y), _quant(cb + 128.0), _quant(cr + 128.0)], dim=-1
    )


def packed_to_i420(packed: np.ndarray, s: int,
                   out: Optional[np.ndarray] = None) -> np.ndarray:
    """Host side: one packed frame ``(H, W, s*s + 2*(s//2)**2)`` ->
    contiguous I420 bytes ``(H*s*W*s*3//2,)`` (Y plane, Cb, Cr)."""
    from upscale_video_tpu_torch.native.imgproc import (
        native_available, planar_interleave_view,
    )

    h, w, c = packed.shape
    cs = s // 2
    if c != s * s + 2 * cs * cs:
        raise ValueError(f"{c} channels != packed 4:2:0 for s={s}")
    oh, ow = h * s, w * s
    total = oh * ow * 3 // 2
    if out is None:
        out = np.empty((total,), np.uint8)
    elif out.shape != (total,) or out.dtype != np.uint8:
        raise ValueError(f"out buffer {out.shape}/{out.dtype} mismatch")
    y = out[: oh * ow].reshape(oh, ow, 1)
    chw, cww = oh // 2, ow // 2
    cb = out[oh * ow: oh * ow + chw * cww].reshape(chw, cww, 1)
    cr = out[oh * ow + chw * cww:].reshape(chw, cww, 1)
    # the channel sections are strided views of the packed buffer: the
    # native stride-aware interleave reads them in place
    native = (native_available()
              if packed.dtype == np.uint8 and packed.flags.c_contiguous
              else False)
    if native:
        planar_interleave_view(packed[..., : s * s], s, 1, out=y)
    else:
        planar_to_frames(np.ascontiguousarray(packed[..., : s * s]), s, out=y)
    if cs == 1:
        np.copyto(cb, packed[..., s * s: s * s + 1])
        np.copyto(cr, packed[..., s * s + 1:])
    elif native:
        planar_interleave_view(
            packed[..., s * s: s * s + cs * cs], cs, 1, out=cb)
        planar_interleave_view(packed[..., s * s + cs * cs:], cs, 1, out=cr)
    else:
        planar_to_frames(
            np.ascontiguousarray(packed[..., s * s: s * s + cs * cs]),
            cs, out=cb)
        planar_to_frames(
            np.ascontiguousarray(packed[..., s * s + cs * cs:]), cs, out=cr)
    return out


def i420_to_model(flat: torch.Tensor, h: int, w: int,
                  full_range: bool = False,
                  channel_order: str = "bgr") -> torch.Tensor:
    """Flat I420 uint8 ``(N, h*w*3//2)`` -> float32 model-domain frames
    ``(N, h, w, 3)`` in [0, 1]: nearest 2x chroma upsample, BT.601
    inverse, ``/255`` and the BGR flip."""
    n = flat.shape[0]
    hw = h * w
    y = flat[:, :hw].reshape(n, h, w).to(torch.float32)
    cb = flat[:, hw:hw + hw // 4].reshape(n, h // 2, w // 2)
    cr = flat[:, hw + hw // 4:].reshape(n, h // 2, w // 2)

    def up(u):
        u = u.to(torch.float32)
        return u.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)

    cb = up(cb) - 128.0
    cr = up(cr) - 128.0
    if not full_range:
        y = (y - _Y_OFF) / _Y_SCALE
        cb = cb / _C_SCALE
        cr = cr / _C_SCALE
    r = y + cr / _CR_K
    b = y + cb / _CB_K
    g = (y - _KR * r - _KB * b) / _KG
    chans = (b, g, r) if channel_order == "bgr" else (r, g, b)
    rgb = torch.stack(chans, dim=-1)
    return torch.clamp(rgb / 255.0, 0.0, 1.0)
