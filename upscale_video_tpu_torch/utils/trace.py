"""``--trace_dir``: a profiler trace of a whole run.

The port's counterpart of ``upscale_video_tpu/utils/profiling.py:trace``
(a ``jax.profiler`` trace), which the port's host copy of that module
leaves out: :func:`trace` runs the block under ``torch.profiler`` with the
CPU activity and, on a CUDA device, the CUDA one (the kernels' launches
and device times), and writes one Chrome trace (``chrome://tracing``,
Perfetto) into the directory.
"""

from __future__ import annotations

import contextlib
import logging
import os
from typing import Iterator, Optional

import torch

log = logging.getLogger(__name__)


def trace_path(trace_dir: str) -> str:
    """The trace file :func:`trace` writes into ``trace_dir``."""
    return os.path.join(trace_dir, f"upscale_video_torch.{os.getpid()}.pt.trace.json")


@contextlib.contextmanager
def trace(trace_dir: Optional[str], device: "str | torch.device" = "cuda"
          ) -> Iterator[None]:
    """Profile the block into ``trace_dir`` (no-op when None): CPU
    activity, plus CUDA activity unless ``device`` is the CPU."""
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    path = trace_path(trace_dir)
    prof.export_chrome_trace(path)
    log.info("profiler trace written to %s", path)
