"""Tracing and throughput observability.

The reference's only performance observability was wall-clock log lines in
the calibration tool (test_gpus.py:20-33, 96-112) and per-tile debug logs
(upscale_processing.py:506-508).  Here:

- :class:`StageTimer` accounts wall time per pipeline stage (decode /
  infer-dispatch / encode) and frames moved, so the host-vs-device balance
  is visible in the logs (the decode/encode threads are the usual
  bottleneck — SURVEY.md §7 hard part (c)).
"""

from __future__ import annotations

import contextlib
import logging
import time
from collections import defaultdict
from typing import Dict, Iterator, Optional

log = logging.getLogger(__name__)


class StageTimer:
    """Accumulates (seconds, items) per named stage."""

    def __init__(self) -> None:
        self.seconds: Dict[str, float] = defaultdict(float)
        self.items: Dict[str, int] = defaultdict(int)
        self._t0 = time.perf_counter()

    @contextlib.contextmanager
    def stage(self, name: str, items: int = 0) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.seconds[name] += time.perf_counter() - t0
            self.items[name] += items

    def add(self, name: str, seconds: float, items: int = 0) -> None:
        self.seconds[name] += seconds
        self.items[name] += items

    def summary(self) -> str:
        total = time.perf_counter() - self._t0
        parts = []
        for name in sorted(self.seconds):
            s = self.seconds[name]
            n = self.items[name]
            rate = f", {n / s:.1f}/s" if n and s > 0 else ""
            parts.append(f"{name}: {s:.2f}s ({100 * s / total:.0f}%{rate})")
        return f"wall {total:.2f}s | " + " | ".join(parts)

    def log_summary(self) -> None:
        log.info("stage timing: %s", self.summary())
