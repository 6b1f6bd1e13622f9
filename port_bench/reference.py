"""The plain reference: what a cell's output frames should be.

Plain PyTorch in float32 with TF32 off, from the benchmark's own weights
and input frames; it imports nothing of the port and nothing of JAX.  It
works out again every step the port takes between the decoded frame and
the encoder: the I420 -> RGB conversion (BT.601, nearest chroma upsample,
studio or full range), the model (its family's ``forward``) over the whole
frame or over the configuration's haloed tile grid (under ``--tta`` the
average over the 8 dihedral transforms), the rounding to uint8
RGB and the RGB -> 4:2:0 packing (convert, then average each 2x2 of
chroma).  ``precision="fp8"`` is the comparison's control: the model's
input, and every conv's input and weights, rounded to float8 e4m3 with a
per-tensor scale, the nearest precision below the bfloat16 in which both
configurations run their convolutions.  (Below Valar's float32 residual
spine lies the program's own ``--precision bf16``, which ``calibrate``
reads: the port rounds each dense block's output to bfloat16 under
``mixed`` too, so the two differ at 24 adds of 93 and no number of the
output separates them.)
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

# BT.601 luma weights; studio range Y 16..235, chroma 16..240
KR, KG, KB = 0.299, 0.587, 0.114
CB_K, CR_K = 0.5 / (1.0 - KB), 0.5 / (1.0 - KR)
Y_SCALE, Y_OFF, C_SCALE = 219.0 / 255.0, 16.0, 224.0 / 255.0
FP8_MAX = 448.0  # the largest float8 e4m3 value


def fit_tile_grid(h: int, w: int, budget: int) -> Tuple[int, int]:
    """The tile for an ``(h, w)`` frame under ``budget``: the grid a square
    ``budget`` tile implies, each tile shrunk in multiples of 8 to just
    cover the frame (1080p at 544: (544, 480), a 2x4 grid)."""
    gy, gx = max(1, math.ceil(h / budget)), max(1, math.ceil(w / budget))
    th = min(budget, 8 * math.ceil(h / gy / 8))
    tw = min(budget, 8 * math.ceil(w / gx / 8))
    while gy > 1 and (gy - 1) * th >= h:
        gy -= 1
    while gx > 1 and (gx - 1) * tw >= w:
        gx -= 1
    return th, tw


def conv_f32(x, weight, bias, padding):
    return F.conv2d(x, weight, bias, padding=padding)


def _fp8(v: torch.Tensor) -> torch.Tensor:
    s = v.abs().amax().clamp_min(1e-30) / FP8_MAX
    return (v / s).to(torch.float8_e4m3fn).to(torch.float32) * s


def conv_fp8(x, weight, bias, padding):
    return F.conv2d(_fp8(x), _fp8(weight), bias, padding=padding)


CONVS: Dict[str, Callable] = {"f32": conv_f32, "fp8": conv_fp8}


def i420_to_model(flat: torch.Tensor, h: int, w: int,
                  full_range: bool) -> torch.Tensor:
    """Flat I420 uint8 ``(h*w*3//2,)`` -> model-domain BGR ``(1, 3, h, w)``
    in [0, 1]: chroma repeated over each 2x2, the BT.601 inverse."""
    hw = h * w
    y = flat[:hw].reshape(h, w).float()
    up = lambda c: c.reshape(h // 2, w // 2).float().repeat_interleave(  # noqa: E731
        2, 0).repeat_interleave(2, 1) - 128.0
    cb, cr = up(flat[hw:hw + hw // 4]), up(flat[hw + hw // 4:])
    if not full_range:
        y, cb, cr = (y - Y_OFF) / Y_SCALE, cb / C_SCALE, cr / C_SCALE
    r = y + cr / CR_K
    b = y + cb / CB_K
    g = (y - KR * r - KB * b) / KG
    return torch.clamp(torch.stack([b, g, r])[None] / 255.0, 0.0, 1.0)


def rgb_to_model(frame: torch.Tensor) -> torch.Tensor:
    """uint8 RGB ``(h, w, 3)`` -> model-domain BGR ``(1, 3, h, w)``."""
    return (frame.float() * (1.0 / 255.0)).flip(-1).permute(2, 0, 1)[None]


def model_to_rgb(y: torch.Tensor) -> torch.Tensor:
    """Model output BGR ``(1, 3, H, W)`` -> uint8 RGB ``(H, W, 3)``:
    x255, round half to even, clamp."""
    v = y[0].flip(0).permute(1, 2, 0)
    return torch.clamp(torch.round(v * 255.0), 0.0, 255.0).to(torch.uint8)


def _quant(v: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(v), 0.0, 255.0).to(torch.uint8)


def rgb_to_i420(rgb: torch.Tensor, full_range: bool) -> torch.Tensor:
    """uint8 RGB ``(H, W, 3)`` -> flat I420 ``(H*W*3//2,)``: BT.601 per
    pixel, then each chroma plane averaged over 2x2 before its offset."""
    x = rgb.float()
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    y = KR * r + KG * g + KB * b
    cb, cr = (b - y) * CB_K, (r - y) * CR_K
    if not full_range:
        y, cb, cr = Y_OFF + y * Y_SCALE, cb * C_SCALE, cr * C_SCALE
    hh, ww = y.shape
    pool = lambda c: c.reshape(hh // 2, 2, ww // 2, 2).mean(dim=(1, 3))  # noqa: E731
    return torch.cat([_quant(y).reshape(-1), _quant(pool(cb) + 128.0).reshape(-1),
                      _quant(pool(cr) + 128.0).reshape(-1)])


def tiled(fn: Callable, x: torch.Tensor, tile: Tuple[int, int], halo: int,
          scale: int) -> torch.Tensor:
    """``fn`` over haloed tiles of ``x`` ``(1, C, H, W)``: the frame padded
    with zeros by ``halo`` and up to whole tiles, each ``(th + 2*halo,
    tw + 2*halo)`` tile run alone, its scaled halo cropped."""
    _, _, h, w = x.shape
    th, tw = tile
    gy, gx = math.ceil(h / th), math.ceil(w / tw)
    xp = F.pad(x, (halo, halo + gx * tw - w, halo, halo + gy * th - h))
    out = x.new_zeros((1, 3, gy * th * scale, gx * tw * scale))
    hs = halo * scale
    for i in range(gy):
        for j in range(gx):
            t = xp[:, :, i * th:i * th + th + 2 * halo,
                   j * tw:j * tw + tw + 2 * halo]
            out[:, :, i * th * scale:(i + 1) * th * scale,
                j * tw * scale:(j + 1) * tw * scale] = \
                fn(t)[:, :, hs:hs + th * scale, hs:hs + tw * scale]
    return out[:, :, :h * scale, :w * scale]


class Reference:
    """The cell's output frames, worked out from its inputs; ``fam`` is the
    configuration's family module (``models/<family>.py``)."""

    def __init__(self, cfg: dict, traffic: dict, fam,
                 weights: Dict[str, Dict[str, torch.Tensor]],
                 precision: str = "f32"):
        self.cfg, self.traffic = cfg, traffic
        self.fam = fam
        self.conv = CONVS[precision]
        self.quantize = _fp8 if precision == "fp8" else (lambda v: v)
        self.w = weights

    def sr(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        fn = lambda t: self.fam.forward(  # noqa: E731
            cfg, self.w, self.quantize(t), self.conv)
        budget = self.traffic.get("tile_size") or cfg["tile"]
        if not budget:
            return fn(x)
        tile = fit_tile_grid(x.shape[2], x.shape[3], budget)
        return tiled(fn, x, tile, cfg["halo"], cfg["upscale"])

    def model(self, x: torch.Tensor) -> torch.Tensor:
        """The SR stage, under ``--tta`` averaged over the 8 dihedral
        transforms of ``x``: ``k % 4`` quarter turns in the (H, W) plane,
        then a flip of W for ``k >= 4``, undone on the output."""
        if not self.traffic.get("tta"):
            return self.sr(x)
        acc = 0.0
        for k in range(8):
            v = torch.rot90(x, k % 4, dims=(2, 3))
            v = v.flip(3) if k >= 4 else v
            y = self.sr(v.contiguous())
            y = y.flip(3) if k >= 4 else y
            acc = acc + torch.rot90(y, -(k % 4), dims=(2, 3))
        return acc / 8.0

    @torch.no_grad()
    def frame(self, frame: np.ndarray, device, in_i420: bool,
              out_i420: bool) -> np.ndarray:
        """One input frame as the source handed it out (flat I420 or uint8
        RGB) -> the output frame the sink should receive (flat I420 or
        uint8 RGB)."""
        t = self.traffic
        v = torch.from_numpy(np.ascontiguousarray(frame)).to(device)
        x = (i420_to_model(v, t["height"], t["width"], t["in_full_range"])
             if in_i420 else rgb_to_model(v))
        rgb = model_to_rgb(self.model(x))
        out = rgb_to_i420(rgb, t["out_full_range"]) if out_i420 else rgb
        return out.cpu().numpy()


def i420_to_rgb(flat: np.ndarray, traffic: dict) -> np.ndarray:
    """A decoder's uint8 RGB of a flat I420 frame (the rgb24 pipe)."""
    v = torch.from_numpy(np.ascontiguousarray(flat))
    x = i420_to_model(v, traffic["height"], traffic["width"],
                      traffic["in_full_range"])
    return model_to_rgb(x).numpy()


def tf32_off() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


