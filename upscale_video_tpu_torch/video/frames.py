"""Frame store conventions: ranges, batches, stage tags, sentinels.

The reference's durable state is the temp working directory: files named by
convention encode per-frame progress ({frame}.{tag}.png where each stage
deletes its input — upscale_processing.py:295-296, 358-359, 521-522),
per-batch progress ({batch}.{ext} skip-if-exists — :925-926), and terminal
sentinels (completed/upscaled/merged.txt — :844-845, :964;
upscale_only.py:122,258; merge_only.py:75,144).  This module reimplements
those conventions so resumes interoperate with the reference's layout —
file-sentinel checkpointing is genuinely the right design for preemptible
TPU VMs (SURVEY.md §2.5).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Tuple

# stage tags in pipeline order (reference tags at upscale_processing.py:
# 881 'extract', 886 'denoise', 892 'anime'; final stage is untagged)
TAG_EXTRACT = "extract"
TAG_DENOISE = "denoise"
TAG_ANIME = "anime"
STAGE_TAGS = (TAG_EXTRACT, TAG_DENOISE, TAG_ANIME)

SENTINEL_COMPLETED = "completed.txt"
SENTINEL_UPSCALED = "upscaled.txt"
SENTINEL_MERGED = "merged.txt"


def parse_frame_ranges(spec: str) -> List[int]:
    """Parse ``"1,3,5-7"`` -> ``[1, 3, 5, 6, 7]`` (reference ``get_frames``,
    upscale_processing.py:27-37).  Validates order and positivity."""
    result: List[int] = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if "-" in part:
            a_s, _, b_s = part.partition("-")
            a, b = int(a_s), int(b_s)
            if b < a:
                raise ValueError(f"descending range {part!r}")
            result.extend(range(a, b + 1))
        else:
            result.append(int(part))
    if any(f < 1 for f in result):
        raise ValueError("frame numbers are 1-indexed")
    return result


def format_frame_ranges(frames: List[int]) -> str:
    """Inverse of :func:`parse_frame_ranges`: compact ``1,3,5-7`` form."""
    if not frames:
        return ""
    frames = sorted(set(frames))
    spans: List[Tuple[int, int]] = []
    start = prev = frames[0]
    for f in frames[1:]:
        if f == prev + 1:
            prev = f
        else:
            spans.append((start, prev))
            start = prev = f
    spans.append((start, prev))
    return ",".join(str(a) if a == b else f"{a}-{b}" for a, b in spans)


def calc_batches(frames_count: int, batch_size: int) -> Dict[int, List[int]]:
    """1-indexed inclusive frame ranges per batch (reference
    upscale_processing.py:184-200)."""
    if batch_size < 1:
        raise ValueError("batch_size must be >= 1")
    batches: Dict[int, List[int]] = {}
    batch = 1
    start = 1
    while start <= frames_count:
        end = min(batch * batch_size, frames_count)
        batches[batch] = [start, end]
        start = end + 1
        batch += 1
    return batches


def frames_per_batch(frame_rate: float, frames_count: int, batch_minutes: int) -> int:
    """Batch sizing: positive = minutes of video per batch; negative =
    split into ``|b|`` parts (reference upscale_processing.py:857-860)."""
    if batch_minutes > 0:
        return int(frame_rate * 60) * batch_minutes
    return int(frames_count / (-batch_minutes)) + 100


def frame_name(frame: int, tag: str = "") -> str:
    return f"{frame}.{tag}.png" if tag else f"{frame}.png"


def stage_progress(workdir: str, frames_count: int, tags=STAGE_TAGS) -> Dict[str, int]:
    """Count per-stage artifacts present (observability/resume reporting)."""
    out = {}
    names = set(os.listdir(workdir))
    for tag in tags:
        out[tag] = sum(
            1 for f in range(1, frames_count + 1) if frame_name(f, tag) in names
        )
    out["final"] = sum(
        1 for f in range(1, frames_count + 1) if frame_name(f) in names
    )
    return out


def write_sentinel(workdir: str, name: str, text: str = "done") -> None:
    with open(os.path.join(workdir, name), "w") as f:
        f.write(text)


def has_sentinel(workdir: str, name: str) -> bool:
    return os.path.exists(os.path.join(workdir, name))


def contiguous_range(frame_numbers: List[int]) -> Tuple[int, int]:
    """Validate frames form a contiguous run; return (min, max).

    Reference merge_only.py:105-123 hard-exits on gaps before encoding a
    fragment; here it raises with the missing frames listed.
    """
    if not frame_numbers:
        raise ValueError("no frames found")
    lo, hi = min(frame_numbers), max(frame_numbers)
    if hi - lo + 1 != len(set(frame_numbers)):
        missing = sorted(set(range(lo, hi + 1)) - set(frame_numbers))
        raise ValueError(
            f"frame gap: expected {hi - lo + 1} frames in [{lo},{hi}], "
            f"missing {format_frame_ranges(missing)}"
        )
    return lo, hi
