"""Host-side pipelined execution helpers.

Started as a copy of ``upscale_video_tpu/parallel/executor.py`` (the
original's package ``__init__`` imports JAX meshes, so the port keeps a
jax-free module); the port's version adds an optional
:class:`~upscale_video_tpu_torch.utils.trace.LoopTrace`: the threads are
named (``uvt-prefetch``, ``uvt-sink``), each item carries the time it was
queued, and the wrappers record their spans and queue counters into the
trace.  Without a trace they behave as the original.

The reference overlapped decode/inference/encode only at the coarse batch
level (extract everything, then infer everything, then encode — SURVEY.md
§2.4 pipeline row).  The streaming plane overlaps at frame granularity:

- :class:`PrefetchSource` wraps any FrameSource with a decode-ahead thread
  and a bounded queue, so PNG/Y4M/pipe decoding proceeds while the host is
  dispatching device work (complements the C++ pipe ring, which overlaps
  at the byte level);
- :class:`AsyncSink` drains encodes on a writer thread so a slow encoder
  does not stall device dispatch.

Both preserve ordering and propagate errors/EOF.  Spans (with a trace):
``source.read`` (one per frame the inner source decodes, on the prefetch
thread), ``source.queue`` (each frame's wait from the prefetch thread's
``put`` to the consumer's ``get``), ``sink.queue`` (the same for the sink
queue), ``sink.interleave`` (``transform``), ``sink.write`` (the inner
write); counters ``source.queue_empty`` and ``sink.queue_full``.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Optional

import numpy as np

from upscale_video_tpu_torch.utils.trace import NO_TRACE
from upscale_video_tpu_torch.video import FrameSink, FrameSource

_SENTINEL = object()


class PrefetchSource(FrameSource):
    """Decode-ahead wrapper: reads ``depth`` frames ahead on a thread."""

    def __init__(self, inner: FrameSource, depth: int = 8, trace=None):
        self.inner = inner
        self.width = inner.width
        self.height = inner.height
        self.frame_rate = inner.frame_rate
        self.num_frames = inner.num_frames
        self._trace = NO_TRACE if trace is None else trace
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._err: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._run, name="uvt-prefetch",
                                        daemon=True)
        self._stop = threading.Event()
        self._thread.start()

    def _run(self) -> None:
        try:
            while not self._stop.is_set():
                with self._trace.span("source.read") as read:
                    frame = self.inner.read()
                    if frame is None:
                        read.drop()  # end of stream: no frame decoded
                if frame is None:
                    self._q.put(_SENTINEL)
                    return
                self._q.put((frame, time.perf_counter()))
        except BaseException as e:  # propagate to the consumer
            self._err = e
            self._q.put(_SENTINEL)

    def read(self) -> Optional[np.ndarray]:
        if self._q.empty():
            self._trace.count("source.queue_empty")
        item = self._q.get()
        if item is _SENTINEL:
            # sticky: the producer thread has exited, so every later read()
            # must see EOF/error again instead of blocking on an empty
            # queue forever (the stream plane reads across fragment gaps)
            self._q.put(_SENTINEL)
            if self._err is not None:
                raise self._err
            return None
        frame, queued_at = item
        self._trace.add_span("source.queue", time.perf_counter() - queued_at)
        return frame

    def close(self) -> None:
        self._stop.set()
        # unblock the producer if the queue is full
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5)
        self.inner.close()


class AsyncSink(FrameSink):
    """Writer-thread wrapper around any FrameSink (ordered, bounded).

    ``transform`` (optional) runs on the writer thread per frame before the
    inner write — the hook the stream plane uses for the shuffle-planar
    host interleave (ops/pixel.planar_to_frames), so that CPU work overlaps
    device compute instead of stalling dispatch."""

    def __init__(self, inner: FrameSink, depth: int = 8, transform=None,
                 trace=None):
        self.inner = inner
        self._transform = transform
        self._trace = NO_TRACE if trace is None else trace
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._err: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._run, name="uvt-sink",
                                        daemon=True)
        self._thread.start()

    def _run(self) -> None:
        trace = self._trace
        while True:
            item = self._q.get()
            if item is _SENTINEL:
                return
            frame, queued_at = item
            trace.add_span("sink.queue", time.perf_counter() - queued_at)
            if self._err is not None:
                continue  # drain without writing after an error
            try:
                if self._transform is not None:
                    with trace.span("sink.interleave"):
                        frame = self._transform(frame)
                with trace.span("sink.write"):
                    self.inner.write(frame)
            except BaseException as e:
                self._err = e

    def write(self, frame: np.ndarray) -> None:
        if self._err is not None:
            raise self._err
        if self._q.full():
            self._trace.count("sink.queue_full")
        self._q.put((frame, time.perf_counter()))

    def close(self) -> None:
        self._q.put(_SENTINEL)
        self._thread.join()
        self.inner.close()
        if self._err is not None:
            raise self._err
