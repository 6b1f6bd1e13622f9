"""The source pool: seeded decoded frames, made on the device in bulk.

Each frame is smooth shading, a mid-frequency texture and fine grain, so
the model sees edges and flat areas alike and its output stays mostly
inside the 8-bit range.  ``i420`` gives flat studio-range (or full-range)
I420 buffers, as a decoder's rawvideo yuv420p pipe does; ``rgb24`` gives
uint8 RGB frames.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch
import torch.nn.functional as F


def _field(gen, n: int, c: int, h: int, w: int, cell: int, device):
    lo = torch.randn(n, c, h // cell + 2, w // cell + 2, generator=gen,
                     device=device)
    return F.interpolate(lo, size=(h, w), mode="bicubic", align_corners=False)


def _plane(gen, n, c, h, w, mid, amp, lo, hi, device):
    v = (mid + amp * _field(gen, n, c, h, w, 48, device)
         + 0.25 * amp * _field(gen, n, c, h, w, 4, device)
         + 0.08 * amp * torch.randn(n, c, h, w, generator=gen, device=device))
    return torch.clamp(torch.round(v), lo, hi).to(torch.uint8)


def pool(traffic: dict, seed: int, device) -> List[np.ndarray]:
    """``traffic["pool_frames"]`` distinct frames of the traffic's size and
    contract from ``seed``."""
    n, h, w = traffic["pool_frames"], traffic["height"], traffic["width"]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    if traffic["contract"] == "i420":
        full = traffic["in_full_range"]
        ylo, yhi, clo, chi = (0, 255, 0, 255) if full else (16, 235, 16, 240)
        y = _plane(gen, n, 1, h, w, 0.5 * (ylo + yhi), 45.0, ylo, yhi, device)
        c = _plane(gen, n, 2, h // 2, w // 2, 128.0, 30.0, clo, chi, device)
        flat = torch.cat([y.reshape(n, -1), c.reshape(n, -1)], dim=1)
    else:
        flat = _plane(gen, n, 3, h, w, 127.5, 50.0, 0, 255,
                      device).permute(0, 2, 3, 1)
    host = flat.contiguous().cpu().numpy()
    return [host[i] for i in range(n)]
