"""The device trace of a window: ``torch.profiler`` over the loop call.

:func:`profiled` runs the window under the profiler (CPU and CUDA
activity), inside a ``bench.window`` range on the calling thread, writes
the Chrome trace to the run's temporary directory, reads it back and
deletes it.  :class:`Trace` holds the kernels (device, name, start, end in
microseconds), the host's ranges and the window, and answers what the
metrics ask: kernel seconds by name, each device's busy time, and its
idle gaps with what the main thread was doing in each.
"""

from __future__ import annotations

import json
import os
import re
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Tuple

import torch

WINDOW = "bench.window"
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")


def short_name(name: str) -> str:
    """A kernel's name without ``void``, its arguments and, past 100
    characters, the rest of its template arguments."""
    name = re.sub(r"^void ", "", name).replace("(anonymous namespace)::", "")
    depth = 0
    for i, ch in enumerate(name):
        if ch in "<(":
            if ch == "(" and depth == 0 and i > 0:
                name = name[:i]
                break
            depth += 1
        elif ch in ">)":
            depth -= 1
    return name[:100]


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


class Trace:
    def __init__(self, events: List[dict]):
        self.kernels: List[Tuple[int, str, float, float]] = []
        self.host: List[Tuple[object, str, float, float]] = []
        self.window: Optional[Tuple[float, float]] = None
        self.main_tid = None
        for e in events:
            if e.get("ph") != "X":
                continue
            cat, ts, dur = e.get("cat"), float(e["ts"]), float(e.get("dur", 0))
            if cat == "kernel":
                self.kernels.append((int(e.get("args", {}).get("device", 0)),
                                     e["name"], ts, ts + dur))
            elif cat in HOST_CATS:
                if e["name"] == WINDOW and cat == "user_annotation":
                    self.window = (ts, ts + dur)
                    self.main_tid = e.get("tid")
                self.host.append((e.get("tid"), e["name"], ts, ts + dur))
        if self.window is None:
            raise RuntimeError(f"the trace holds no {WINDOW!r} range")
        a, b = self.window
        self.kernels = [(d, n, max(s, a), min(t, b))
                        for d, n, s, t in self.kernels if t > a and s < b]

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-6

    def kernel_seconds(self, match: Callable[[str], bool] = lambda n: True,
                       device: Optional[int] = None) -> float:
        return 1e-6 * sum(t - s for d, n, s, t in self.kernels
                          if match(n) and (device is None or d == device))

    def busy_s(self, device: int) -> float:
        """Seconds of the window in which a kernel ran on ``device``
        (copies and memsets are not kernels)."""
        spans = _union([(s, t) for d, _, s, t in self.kernels if d == device])
        return 1e-6 * sum(t - s for s, t in spans)

    def idle_gaps(self, device: int) -> List[Tuple[float, float]]:
        spans = _union([(s, t) for d, _, s, t in self.kernels if d == device])
        edges = [self.window[0]] + [x for s, t in spans for x in (s, t)] \
            + [self.window[1]]
        return [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]

    def host_label(self, at: float) -> str:
        """The innermost range the main thread was in at ``at``."""
        best = None
        for tid, name, s, t in self.host:
            if tid == self.main_tid and s <= at < t and name != WINDOW:
                if best is None or s >= best[1]:
                    best = (name, s)
        return best[0] if best else "main thread in Python, no torch op"

    def breakdown(self, devices: List[int]) -> Dict[str, list]:
        """The ten device operations that took most time, summed over the
        devices, and the ten longest idle gaps with the main thread's
        range at their middle."""
        by_name: Dict[str, float] = defaultdict(float)
        for _, n, s, t in self.kernels:
            by_name[short_name(n)] += (t - s) * 1e-6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        gaps = [(t - s, d, s, t) for d in devices for s, t in self.idle_gaps(d)]
        gaps.sort(key=lambda g: -g[0])
        return {
            "device_ops": [[n, v] for n, v in ops],
            "idle_gaps": [[f"cuda:{d} {self.host_label(0.5 * (s + t))}",
                           length * 1e-6] for length, d, s, t in gaps[:10]],
        }


def profiled(fn: Callable[[], object], tmpdir: str):
    """``fn()`` under ``torch.profiler``; returns its result and the
    :class:`Trace`."""
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with record_function(WINDOW):
            result = fn()
    path = os.path.join(tmpdir, "window.pt.trace.json")
    prof.export_chrome_trace(path)
    try:
        nbytes = os.path.getsize(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    trace = Trace(events)
    trace.nbytes = nbytes  # what the run wrote to disk for it
    return result, trace
