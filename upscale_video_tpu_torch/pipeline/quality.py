"""Quality gate: frame-wise PSNR comparison between two videos/stores.

The north-star quality bar is a PSNR delta <= 1e-2 versus the ncnn
reference output (BASELINE.md).  The reference repo has no comparison
tooling (its verification was eyeballing ``test_images.py`` outputs);
this module adds a measurable gate usable in CI and release checks:

    from upscale_video_tpu_torch.pipeline.quality import compare_sources
    stats = compare_sources("ref.y4m", "ours.y4m")
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from upscale_video_tpu_torch.ops.pixel import psnr
from upscale_video_tpu_torch.video.io import open_source

log = logging.getLogger(__name__)


@dataclass
class QualityStats:
    frames: int
    mean_psnr: float
    min_psnr: float
    min_frame: int  # 1-indexed
    per_frame: List[float]

    def __str__(self) -> str:
        return (
            f"{self.frames} frames, mean PSNR {self.mean_psnr:.2f} dB, "
            f"min {self.min_psnr:.2f} dB at frame {self.min_frame}"
        )


def compare_sources(
    path_a: str, path_b: str, max_frames: Optional[int] = None, **src_kw
) -> QualityStats:
    """Frame-wise PSNR between two videos (y4m) or PNG directories."""
    a = open_source(path_a, **src_kw)
    b = open_source(path_b, **src_kw)
    scores: List[float] = []
    try:
        while max_frames is None or len(scores) < max_frames:
            fa = a.read()
            fb = b.read()
            if fa is None and fb is None:
                break
            if (fa is None) != (fb is None):
                raise ValueError(
                    f"frame count mismatch: one stream ended at frame {len(scores) + 1}"
                )
            if fa.shape != fb.shape:
                raise ValueError(
                    f"geometry mismatch at frame {len(scores) + 1}: "
                    f"{fa.shape} vs {fb.shape}"
                )
            scores.append(psnr(fa, fb))
    finally:
        a.close()
        b.close()
    if not scores:
        raise ValueError("no frames compared")
    finite = [s for s in scores if np.isfinite(s)]
    mean = float(np.mean(finite)) if finite else float("inf")
    mn = min(scores)
    stats = QualityStats(
        frames=len(scores),
        mean_psnr=mean,
        min_psnr=float(mn),
        min_frame=int(np.argmin(scores)) + 1,
        per_frame=[float(s) for s in scores],
    )
    log.info("quality: %s", stats)
    return stats
