"""Host-side pipelined execution helpers.

Host copy of ``upscale_video_tpu/parallel/executor.py`` (same code): the
original's package ``__init__`` imports JAX meshes, so the port keeps a
jax-free copy.

The reference overlapped decode/inference/encode only at the coarse batch
level (extract everything, then infer everything, then encode — SURVEY.md
§2.4 pipeline row).  The streaming plane overlaps at frame granularity:

- :class:`PrefetchSource` wraps any FrameSource with a decode-ahead thread
  and a bounded queue, so PNG/Y4M/pipe decoding proceeds while the host is
  dispatching device work (complements the C++ pipe ring, which overlaps
  at the byte level);
- :class:`AsyncSink` drains encodes on a writer thread so a slow encoder
  does not stall device dispatch.

Both preserve ordering and propagate errors/EOF.
"""

from __future__ import annotations

import queue
import threading
from typing import Optional

import numpy as np

from upscale_video_tpu_torch.video import FrameSink, FrameSource

_SENTINEL = object()


class PrefetchSource(FrameSource):
    """Decode-ahead wrapper: reads ``depth`` frames ahead on a thread."""

    def __init__(self, inner: FrameSource, depth: int = 8):
        self.inner = inner
        self.width = inner.width
        self.height = inner.height
        self.frame_rate = inner.frame_rate
        self.num_frames = inner.num_frames
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._err: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._stop = threading.Event()
        self._thread.start()

    def _run(self) -> None:
        try:
            while not self._stop.is_set():
                frame = self.inner.read()
                self._q.put(frame if frame is not None else _SENTINEL)
                if frame is None:
                    return
        except BaseException as e:  # propagate to the consumer
            self._err = e
            self._q.put(_SENTINEL)

    def read(self) -> Optional[np.ndarray]:
        item = self._q.get()
        if item is _SENTINEL:
            # sticky: the producer thread has exited, so every later read()
            # must see EOF/error again instead of blocking on an empty
            # queue forever (the stream plane reads across fragment gaps)
            self._q.put(_SENTINEL)
            if self._err is not None:
                raise self._err
            return None
        return item

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

    def __init__(self, inner: FrameSink, depth: int = 8, transform=None):
        self.inner = inner
        self._transform = transform
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._err: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while True:
            item = self._q.get()
            if item is _SENTINEL:
                return
            if self._err is not None:
                continue  # drain without writing after an error
            try:
                if self._transform is not None:
                    item = self._transform(item)
                self.inner.write(item)
            except BaseException as e:
                self._err = e

    def write(self, frame: np.ndarray) -> None:
        if self._err is not None:
            raise self._err
        self._q.put(frame)

    def close(self) -> None:
        self._q.put(_SENTINEL)
        self._thread.join()
        self.inner.close()
        if self._err is not None:
            raise self._err
