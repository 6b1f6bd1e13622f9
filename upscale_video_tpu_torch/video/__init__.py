"""The port's video layer: the JAX package's jax-free one, reused as is.

``upscale_video_tpu.video`` (backends, hermetic Y4M/PNG and ffmpeg-pipe
I/O, batch math, sentinels) imports no JAX, so the port does not copy it:
this module names what the port uses, in one place.  Reusing it keeps the
temp dir, ``metadata.json``, fragment and ``completed.txt`` layout
byte-compatible with the JAX package's.
"""

from upscale_video_tpu.video import ffmpeg
from upscale_video_tpu.video.backend import (
    FfmpegBackend, HermeticBackend, VideoBackend, make_backend,
)
from upscale_video_tpu.video.frames import (
    SENTINEL_COMPLETED, calc_batches, frames_per_batch, has_sentinel,
    write_sentinel,
)
from upscale_video_tpu.video.io import FrameSink, FrameSource, Y4MSink, Y4MSource

__all__ = [
    "ffmpeg", "FfmpegBackend", "HermeticBackend", "VideoBackend",
    "make_backend", "SENTINEL_COMPLETED", "calc_batches", "frames_per_batch",
    "has_sentinel", "write_sentinel", "FrameSink", "FrameSource", "Y4MSink",
    "Y4MSource",
]
