"""x8 self-ensemble (test-time augmentation) of the SR stage.

Port of ``upscale_video_tpu/ops/tta.py``: the SR forward averaged over the
8 dihedral transforms of the input (4 quarter-rotations, then optionally a
horizontal flip), accumulated in f32.  A non-square frame goes through the
forward at its own and at its transposed shape.  ``--tta`` takes the
ordinary full-frame output contract (no shuffle-planar step).
"""

from __future__ import annotations

from typing import Callable

import torch


def dihedral(x: torch.Tensor, k: int) -> torch.Tensor:
    """Dihedral transform ``k`` (0..7) of NHWC: ``k % 4`` quarter-rotations
    in the (H, W) plane (``np.rot90``'s direction), then a flip of W when
    ``k >= 4``."""
    r, f = k % 4, k >= 4
    if r:
        x = torch.rot90(x, r, dims=(1, 2))
    if f:
        x = x.flip(2)
    return x


def inverse_dihedral(y: torch.Tensor, k: int) -> torch.Tensor:
    r, f = k % 4, k >= 4
    if f:
        y = y.flip(2)
    if r:
        y = torch.rot90(y, -r, dims=(1, 2))
    return y


def tta_apply(fn: Callable[[torch.Tensor], torch.Tensor],
              x: torch.Tensor) -> torch.Tensor:
    """Average ``fn`` (NHWC -> NHWC, geometry-preserving up to an integer
    scale) over the 8 dihedral transforms of ``x``; f32 result."""
    acc = None
    for k in range(8):
        y = fn(dihedral(x, k).contiguous())
        y = inverse_dihedral(y, k).to(torch.float32)
        acc = y if acc is None else acc + y
    return acc / 8.0
