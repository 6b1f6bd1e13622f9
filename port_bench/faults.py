"""Faults planted under the timed path, for the check's own tests.

:func:`planted` swaps the stream loop's ``BatchedStepper`` for one whose
step results come back broken, as each fault would break them where the
frames are produced:

- ``stale``: each step hands back the previous step's frames (a step that
  leaves its output unchanged);
- ``half_batch``: the second half of each step's frames are copies of the
  first half (half of the batch left out);
- ``exchange``: the frames of the last GPU's share are the previous step's
  (that GPU's copy back left out; cells over several GPUs);
- ``altered``: a 256x256 patch of each step's first frame inverted, as
  the step hands it back (an answer altered).
"""

from __future__ import annotations

import contextlib

import numpy as np

from upscale_video_tpu_torch.pipeline import process

KINDS = ("stale", "half_batch", "exchange", "altered")


def _broken(kind: str, gpus: int):
    base = process.BatchedStepper

    class Broken(base):
        _prev = None

        def _collect(self):
            outs = [np.array(o, copy=True) for o in super()._collect()]
            if not outs:
                return outs
            prev, self._prev = self._prev, [o.copy() for o in outs]
            n = len(outs)
            if kind == "stale" and prev is not None and len(prev) == n:
                return prev
            if kind == "half_batch" and n > 1:
                return outs[:n // 2] + outs[:n - n // 2]
            if kind == "exchange" and prev is not None and len(prev) == n:
                share = max(1, n // gpus)
                return outs[:n - share] + prev[n - share:]
            if kind == "altered":
                outs[0][:256, :256] = 255 - outs[0][:256, :256]
            return outs

    return Broken


@contextlib.contextmanager
def planted(kind: str, gpus: int = 1):
    if kind not in KINDS:
        raise ValueError(f"unknown fault {kind!r} ({', '.join(KINDS)})")
    saved = process.BatchedStepper
    process.BatchedStepper = _broken(kind, gpus)
    try:
        yield
    finally:
        process.BatchedStepper = saved
