"""``--trace_dir``, and the stream loop's spans and counters.

:func:`trace` is the port's counterpart of
``upscale_video_tpu/utils/profiling.py:trace`` (a ``jax.profiler`` trace),
which the port's host copy of that module leaves out: it runs the block
under ``torch.profiler`` with the CPU activity and, on a CUDA device, the
CUDA one (the kernels' launches and device times), and writes one Chrome
trace (``chrome://tracing``, Perfetto) into the directory.  Where the
installed torch can, it records every thread, so the sink's and the
prefetch thread's spans are in the trace beside the main thread's.

:class:`LoopTrace` is the stream loop's timer: ``StageTimer``'s three
stages (``decode``, ``infer``, ``encode``; the ``stage timing`` line is
unchanged) plus named spans and counters that the loop's components
record where their work happens.  Each span name is recorded by one
thread:

- main thread (``pipeline/process.py:_run_stream_plane``): ``loop.open``,
  ``loop.decode``, ``loop.infer``, ``loop.encode``, ``loop.close``; inside
  ``loop.infer`` (``pipeline/chain.py:BatchedStepper``): ``loop.pack``,
  ``loop.h2d_wait``, ``loop.dispatch``, ``loop.d2h_wait``; and
  ``source.queue``, each frame's wait in the prefetch queue;
- ``uvt-sink`` (``parallel/executor.py:AsyncSink``): ``sink.interleave``,
  ``sink.write``, ``sink.queue`` (each frame's wait in the sink queue);
- ``uvt-prefetch`` (``PrefetchSource``): ``source.read``.

Counters: ``sink.queue_full`` (writes that found the sink queue full) and
``source.queue_empty`` (reads that found the prefetch queue empty).

While a torch profiler records, each span is also a ``record_function``
range of the same name, on the clock of the device's kernels; otherwise
none is entered (one costs some 16 us even with the profiler off).  A
finished loop logs a ``loop spans:`` line, and :func:`last_loop` returns
its :meth:`LoopTrace.record`.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from collections import defaultdict
from typing import Dict, Iterator, Optional

import torch
import torch.autograd.profiler as _autograd_profiler
from torch.autograd.profiler import record_function

from upscale_video_tpu_torch.utils.profiling import StageTimer

log = logging.getLogger(__name__)

COUNTERS = ("sink.queue_full", "source.queue_empty")
_last_loop: Optional[dict] = None
_said_main_thread_only = False


def trace_path(trace_dir: str) -> str:
    """The trace file :func:`trace` writes into ``trace_dir``."""
    return os.path.join(trace_dir, f"upscale_video_torch.{os.getpid()}.pt.trace.json")


def all_threads_config():
    """An ``experimental_config`` that has the profiler record every
    thread, or None where the installed torch has no such option."""
    try:
        from torch._C._profiler import _ExperimentalConfig

        return _ExperimentalConfig(profile_all_threads=True)
    except (ImportError, TypeError):
        return None


@contextlib.contextmanager
def trace(trace_dir: Optional[str], device: "str | torch.device" = "cuda"
          ) -> Iterator[None]:
    """Profile the block into ``trace_dir`` (no-op when None): CPU
    activity, plus CUDA activity unless ``device`` is the CPU."""
    global _said_main_thread_only
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    config = all_threads_config()
    if config is None and not _said_main_thread_only:
        _said_main_thread_only = True
        log.info("this torch's profiler records the main thread only: the "
                 "sink and prefetch threads' spans are not in the trace")
    kwargs = {} if config is None else {"experimental_config": config}
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities, **kwargs) as prof:
        yield
    path = trace_path(trace_dir)
    prof.export_chrome_trace(path)
    log.info("profiler trace written to %s", path)


def profiling() -> bool:
    """Whether a torch profiler is recording.  The Python flag is set on
    every thread and under ``profile_all_threads``, where the C flag reads
    False; the C flag covers a profiler started without the Python one."""
    return (getattr(_autograd_profiler, "_is_profiler_enabled", False)
            or torch._C._autograd._profiler_enabled())


def last_loop() -> Optional[dict]:
    """:meth:`LoopTrace.record` of the last stream loop that finished in
    this process, or None."""
    return _last_loop


class _Span:
    """One occurrence of a span: its seconds into the trace's record (and,
    for a stage, into ``StageTimer``'s), and a profiler range of its name
    while a profiler records."""

    __slots__ = ("_trace", "_name", "_stage", "_items", "_t0", "_range",
                 "_kept")

    def __init__(self, trace: "LoopTrace", name: str,
                 stage: Optional[str] = None, items: int = 0):
        self._trace, self._name = trace, name
        self._stage, self._items = stage, items

    def __enter__(self) -> "_Span":
        self._range = None
        if profiling():
            self._range = record_function(self._name)
            self._range.__enter__()
        self._kept = True
        self._t0 = time.perf_counter()
        return self

    def drop(self) -> None:
        """Leave this occurrence out of the record (its range stays)."""
        self._kept = False

    def __exit__(self, *exc) -> bool:
        seconds = time.perf_counter() - self._t0
        if self._kept:
            self._trace.add_span(self._name, seconds)
            if self._stage is not None:
                self._trace.add(self._stage, seconds, self._items)
        if self._range is not None:
            self._range.__exit__(*exc)
        return False


class LoopTrace(StageTimer):
    """``StageTimer`` with spans and counters (see the module docstring).

    :meth:`stage` keeps ``StageTimer``'s seconds and items and is the span
    ``loop.<name>`` too; :meth:`span` and :meth:`add_span` record the other
    spans, which :meth:`summary` leaves out."""

    def __init__(self) -> None:
        super().__init__()
        self.spans: Dict[str, list] = {}  # name -> [seconds, count]
        self.counters: Dict[str, int] = defaultdict(int, dict.fromkeys(
            COUNTERS, 0))
        self._running: Dict[str, _Span] = {}

    def stage(self, name: str, items: int = 0) -> _Span:
        return _Span(self, f"loop.{name}", name, items)

    def span(self, name: str) -> _Span:
        return _Span(self, name)

    def add_span(self, name: str, seconds: float) -> None:
        """One occurrence of ``name`` timed by its caller (a queue wait,
        from a stamp that travelled with the item)."""
        entry = self.spans.get(name)
        if entry is None:
            entry = self.spans[name] = [0.0, 0]
        entry[0] += seconds
        entry[1] += 1

    def count(self, name: str, n: int = 1) -> None:
        self.counters[name] += n

    def begin(self, name: str) -> None:
        """Start span ``name``, unless it is running, where it cannot be a
        ``with`` block: :meth:`end` ends it."""
        if name not in self._running:
            self._running[name] = self.span(name).__enter__()

    def end(self, name: str) -> None:
        """End span ``name`` if :meth:`begin` started it."""
        span = self._running.pop(name, None)
        if span is not None:
            span.__exit__(None, None, None)

    def record(self) -> dict:
        """``{"wall_s", "spans": {name: {"seconds", "count"}}, "counters"}``
        as plain numbers."""
        spans = dict(self.spans)  # a copy: other threads may still add
        return {"wall_s": time.perf_counter() - self._t0,
                "spans": {n: {"seconds": spans[n][0], "count": spans[n][1]}
                          for n in sorted(spans)},
                "counters": dict(sorted(dict(self.counters).items()))}

    def log_summary(self) -> None:
        """The ``stage timing`` line, then the ``loop spans`` line (each
        span's seconds, count and mean ms, then the counters); the record
        becomes :func:`last_loop`'s."""
        global _last_loop
        super().log_summary()
        rec = self.record()
        _last_loop = rec
        parts = [f"{n}: {s['seconds']:.2f}s x{s['count']} "
                 f"({1e3 * s['seconds'] / max(s['count'], 1):.2f} ms)"
                 for n, s in rec["spans"].items()]
        parts += [f"{n}: {v}" for n, v in rec["counters"].items()]
        log.info("loop spans: %s", " | ".join(parts))


class _NoSpan:
    def __enter__(self) -> "_NoSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def drop(self) -> None:
        pass


class _NoTrace:
    """What a component given no trace records into: nothing."""

    _span = _NoSpan()

    def span(self, name: str) -> _NoSpan:
        return self._span

    def add_span(self, name: str, seconds: float) -> None:
        pass

    def count(self, name: str, n: int = 1) -> None:
        pass


NO_TRACE = _NoTrace()
