"""What the port's stream loop records of itself, for the metrics that
read it.

:func:`record` is the program's record of the window's loop (the port's
``utils/trace.py:last_loop``: each span's seconds and count, and the
counters), or None where the program keeps none.  :func:`idle_split`
splits a GPU's idle time in the device trace by the ``loop.*`` ranges the
main thread was in, which the port opens while a profiler records.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

from port_bench.trace import _union

# the main thread waits in these: on the prefetch queue, an upload, a
# download and the sink queue; anywhere else in the loop it is busy
WAITS = ("loop.decode", "loop.h2d_wait", "loop.d2h_wait", "loop.encode")
COPY_WAITS = ("loop.h2d_wait", "loop.d2h_wait")


def record() -> Optional[dict]:
    try:
        from upscale_video_tpu_torch.utils.trace import last_loop
    except ImportError:
        return None
    return last_loop()


def mean_ms(rec: Optional[dict], name: str) -> Optional[float]:
    """The mean of span ``name`` in ms, or None where it never ran."""
    span = (rec or {}).get("spans", {}).get(name)
    if not span or not span["count"]:
        return None
    return 1e3 * span["seconds"] / span["count"]


def overlap(a: Sequence[Tuple[float, float]],
            b: Sequence[Tuple[float, float]]) -> float:
    """Length of the intersection of two sorted lists of disjoint
    intervals."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def main_ranges(trace, names: Sequence[str]) -> List[Tuple[float, float]]:
    return _union([(s, t) for tid, n, s, t in trace.host
                   if tid == trace.main_tid and n in names])


def idle_split(run) -> Optional[Tuple[float, float, float]]:
    """``(idle, idle in WAITS, idle in COPY_WAITS)`` as shares of the
    window, of the GPU ``device_idle_share`` reads (the idlest); None
    without a trace or without the loop's ranges in it."""
    tr = run.trace
    if tr is None or not any(tid == tr.main_tid and n.startswith("loop.")
                             for tid, n, _, _ in tr.host):
        return None
    window = tr.window[1] - tr.window[0]
    dev = max(range(run.gpus), key=lambda d: 1.0 - tr.busy_s(d) / tr.window_s)
    gaps = tr.idle_gaps(dev)
    idle = sum(t - s for s, t in gaps)
    return (idle / window, overlap(gaps, main_ranges(tr, WAITS)) / window,
            overlap(gaps, main_ranges(tr, COPY_WAITS)) / window)
