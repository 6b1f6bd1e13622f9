"""The benchmark's video backend: decoded frames in, received frames out.

It stands in for ffmpeg's decode and encode, which are not the port: the
source hands out frames of a seeded pool from host memory, cycled, and the
sink counts what it receives and keeps the frames the output check
samples.  Both stamp each frame with the host clock, so a frame's latency
is from the source handing it out to the sink receiving it.  The sink
leaves an empty fragment file for the loop to commit.
"""

from __future__ import annotations

import os
import time
from fractions import Fraction
from typing import Dict, List, Optional, Set

import numpy as np
from torch.profiler import record_function

from upscale_video_tpu_torch.video.backend import VideoBackend
from upscale_video_tpu_torch.video.io import FrameSink, FrameSource


class Recorder:
    """One loop call's frames: when each was handed out and received, and
    the received frames at the sampled indices."""

    def __init__(self, n_frames: int, keep: Set[int]):
        self.n_frames = n_frames
        self.keep = keep
        self.sent: List[float] = []
        self.received: List[float] = []
        self.kept: Dict[int, np.ndarray] = {}


class BenchSource(FrameSource):
    def __init__(self, pool: List[np.ndarray], rec: Recorder, width: int,
                 height: int, raw_i420: bool, full_range: bool):
        self.pool = pool
        self.rec = rec
        self.width, self.height = width, height
        self.frame_rate = Fraction(24000, 1001)
        self.num_frames = rec.n_frames
        self.raw_i420 = raw_i420
        self.i420_full_range = full_range
        self._next = 0

    def read(self) -> Optional[np.ndarray]:
        with record_function("bench.source.read"):
            if self._next >= self.num_frames:
                return None
            frame = self.pool[self._next % len(self.pool)]
            self._next += 1
            self.rec.sent.append(time.perf_counter())
            return frame


class BenchSink(FrameSink):
    def __init__(self, rec: Recorder, path: str):
        self.rec = rec
        open(path, "wb").close()

    def write(self, frame: np.ndarray) -> None:
        with record_function("bench.sink.write"):
            self.rec.received.append(time.perf_counter())
            i = len(self.rec.received) - 1
            if i in self.rec.keep:  # the loop reuses its output buffer
                self.rec.kept[i] = np.array(frame, copy=True)


class BenchBackend(VideoBackend):
    """A :class:`VideoBackend` over the traffic's pool; :meth:`begin` sets
    up the next loop call's :class:`Recorder`.  Where the loop does not ask
    an I420 pool for I420, the source hands out ``to_rgb`` of each frame."""

    def __init__(self, traffic: dict, pool: List[np.ndarray], to_rgb):
        self.traffic = traffic
        self.pool = pool
        self._to_rgb = to_rgb
        self._rgb: Optional[List[np.ndarray]] = None
        self.yuv_full_range = traffic["out_full_range"]
        self.rec: Optional[Recorder] = None
        self.raw_i420 = False  # whether the last source handed out I420
        self.yuv420_out = False  # whether the last sink took I420
        self.handed_out = pool  # the frames the last source cycled through

    def begin(self, n_frames: int, keep: Set[int] = frozenset()) -> Recorder:
        self.rec = Recorder(n_frames, set(keep))
        return self.rec

    def info(self) -> Dict:
        t = self.traffic
        return {"number_of_frames": self.rec.n_frames, "duration": 0.0,
                "frame_rate": 24000 / 1001, "frame_rate_fraction": "24000/1001",
                "width": t["width"], "height": t["height"],
                "pix_fmt": t["source_pix_fmt"]}

    def probe(self, input_file, workdir):
        return self.info()

    def crop_detect(self, input_file, duration, workdir):
        return ""

    def auto_yuv420(self, info):
        return self.traffic["encode_pix_fmt"] in ("yuv420p", "yuvj420p", "nv12")

    def open_source(self, input_file, info, crop, start_frame=1,
                    raw_i420=False):
        t = self.traffic
        raw = bool(raw_i420) and t["contract"] == "i420"
        pool = self.pool
        if t["contract"] == "i420" and not raw:
            if self._rgb is None:
                self._rgb = [self._to_rgb(f) for f in self.pool]
            pool = self._rgb
        self.raw_i420 = raw
        self.handed_out = pool
        return BenchSource(pool, self.rec, t["width"], t["height"], raw,
                           t["in_full_range"])

    def open_fragment_sink(self, batch, width, height, info, workdir,
                           yuv420=False):
        self.yuv420_out = bool(yuv420)
        return BenchSink(self.rec, os.path.join(workdir,
                                                self.fragment_name(batch)))

    def fragment_name(self, batch):
        return f"{batch}.frames"

    def concat(self, num_batches, output_file, workdir):
        raise NotImplementedError("the benchmark keeps no output file")
