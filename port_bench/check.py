"""Which output frames are compared, and how.

The sample is drawn from the seed before the window opens: every position
of a step (every batch slot, and under dp every GPU's share) in a random
step, more steps' positions in turn where the reference has time, and the
last frame of the window.  Each sampled frame, as the sink received it, is compared
with the reference's frame for the same input by up to two numbers, both
in 8-bit levels: ``rmse`` over all its bytes, and ``block_rmse``, the
worst RMSE of a 32x32 block of its luma plane (of its RGB frame under the
rgb24 contract), which a fault confined to a small area moves.  A cell
compares the numbers its limits file lists; the worst sampled frame of
each must stay within its limit.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

# the reference's work per run: frames sampled is this over a frame's
# FLOPs (``Run.flops_per_frame``), from 2 to 16, and at least a step's
# frames (2 Valar frames of 1080p, 4 Compact ones under --tta), so that the
# float32 reference takes less time than the window
CHECK_FLOPS = 40e12
BLOCK = 32
NUMBERS = ("rmse", "block_rmse")


def n_check(flops_per_frame: float, frames_per_step: int = 1) -> int:
    return int(max(frames_per_step,
                   min(16, max(2, CHECK_FLOPS // flops_per_frame))))


def sample(n_frames: int, frames_per_step: int, count: int,
           seed: int) -> List[int]:
    """Frame indices of a window of ``n_frames``: position ``k %
    frames_per_step`` of a random step for each ``k < count``, and the
    last frame."""
    rng = np.random.default_rng(seed)
    steps = max(1, n_frames // frames_per_step)
    picked = {n_frames - 1}
    for k in range(count):
        pos = k % frames_per_step
        for _ in range(8):
            i = int(rng.integers(steps)) * frames_per_step + pos
            if i < n_frames and i not in picked:
                picked.add(i)
                break
    return sorted(picked)


def compare(out: np.ndarray, ref: np.ndarray, height: int, width: int,
            i420: bool) -> Dict[str, float]:
    """``rmse`` and ``block_rmse`` of one output frame against its
    reference (``height`` x ``width`` is the output's size)."""
    if out.shape != ref.shape:
        return {k: float("inf") for k in NUMBERS}
    d = out.astype(np.float32) - ref.astype(np.float32)
    rmse = float(np.sqrt(np.mean(d * d)))
    plane = (d[:height * width].reshape(height, width, 1) if i420
             else d.reshape(height, width, -1))
    b = min(BLOCK, height, width)
    hb, wb = height // b, width // b
    blocks = plane[:hb * b, :wb * b].reshape(hb, b, wb, b, -1)
    block = float(np.sqrt((blocks * blocks).mean(axis=(1, 3, 4)).max()))
    return {"rmse": rmse, "block_rmse": block}


def worst(per_frame: List[Dict[str, float]]) -> Dict[str, float]:
    return {k: max((f[k] for f in per_frame), default=float("inf"))
            for k in NUMBERS}
