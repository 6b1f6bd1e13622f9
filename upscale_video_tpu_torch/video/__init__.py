"""The port's video layer: backends, hermetic Y4M/PNG and ffmpeg-pipe I/O,
batch math and sentinels.

``ffmpeg``, ``io``, ``backend`` and ``frames`` are copies of the JAX
package's jax-free ``video`` modules with their imports pointed at the
port (tests/test_torch_host.py holds them equal), so the temp dir,
``metadata.json``, fragment and ``completed.txt`` layout stays
byte-compatible with the JAX package's.  This module names what the port
uses, in one place.
"""

from upscale_video_tpu_torch.video import ffmpeg
from upscale_video_tpu_torch.video.backend import (
    FfmpegBackend, HermeticBackend, VideoBackend, make_backend,
)
from upscale_video_tpu_torch.video.frames import (
    SENTINEL_COMPLETED, calc_batches, frames_per_batch, has_sentinel,
    write_sentinel,
)
from upscale_video_tpu_torch.video.io import (
    FrameSink, FrameSource, Y4MSink, Y4MSource,
)

__all__ = [
    "ffmpeg", "FfmpegBackend", "HermeticBackend", "VideoBackend",
    "make_backend", "SENTINEL_COMPLETED", "calc_batches", "frames_per_batch",
    "has_sentinel", "write_sentinel", "FrameSink", "FrameSource", "Y4MSink",
    "Y4MSource",
]
