"""The port's stream-loop spans (``utils/trace.py:LoopTrace``) and its
traced host wrappers (``parallel/executor.py``) on the CPU: no profiler
range while no profiler records, ``StageTimer``'s line unchanged, the
``loop.*`` ranges on the main thread under ``torch.profiler``, the record
of a whole loop, ``--trace_dir`` over every thread, and the prefetch
source and sink on their own."""

import json
import os
import threading
import time
from fractions import Fraction

import numpy as np
import pytest
import torch

from upscale_video_tpu_torch.cli.upscale_video import main as cli_main
from upscale_video_tpu_torch.parallel.executor import AsyncSink, PrefetchSource
from upscale_video_tpu_torch.utils import trace as trace_mod
from upscale_video_tpu_torch.utils.profiling import StageTimer
from upscale_video_tpu_torch.utils.trace import LoopTrace, last_loop
from upscale_video_tpu_torch.video import FrameSink, FrameSource, Y4MSink
from tests.torch_fixtures import one_torch_thread  # noqa: F401

H, W = 12, 16
INFER_PARTS = ("loop.pack", "loop.h2d_wait", "loop.dispatch", "loop.d2h_wait")


def _clip(tmp_path, n):
    path = str(tmp_path / "in.y4m")
    rng = np.random.default_rng(5)
    with Y4MSink(path, W, H, "24/1") as sink:
        for _ in range(n):
            sink.write(rng.integers(0, 256, (H, W, 3), dtype=np.uint8))
    return path


def _upscale(tmp_path, n, *flags):
    """The CLI on an ``n``-frame clip, 2 frames a step, on the CPU."""
    src = _clip(tmp_path, n)
    assert cli_main(["-i", src, "-o", str(tmp_path / "out.y4m"), "-t",
                     str(tmp_path / "t"), "--synthetic_models", "--device",
                     "cpu", "--frames_per_step", "2", *flags]) == 0


def _refuse_ranges(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with no profiler")

    monkeypatch.setattr(trace_mod, "record_function", refuse)


def test_no_profiler_range_while_no_profiler_records(tmp_path, monkeypatch):
    _refuse_ranges(monkeypatch)
    assert not trace_mod.profiling()
    t = LoopTrace()
    t.begin("loop.open")
    t.end("loop.open")
    with t.stage("infer"), t.span("loop.dispatch"):
        pass
    _upscale(tmp_path, 3)
    assert last_loop()["spans"]["sink.interleave"]["count"] == 3


def _fake_clock(monkeypatch):
    ticks = iter(0.25 * i for i in range(10 ** 6))
    monkeypatch.setattr(time, "perf_counter", lambda: next(ticks))


def test_summary_is_stage_timers_and_the_harness_reads_it(monkeypatch):
    from port_bench.harness import parse_stage_line

    lines = []
    for cls in (StageTimer, LoopTrace):
        _fake_clock(monkeypatch)
        t = cls()
        for name, items in (("decode", 1), ("infer", 0), ("encode", 2),
                            ("decode", 1)):
            with t.stage(name, items):
                pass
        lines.append(t.summary())
    assert lines[0] == lines[1]
    # spans other than the stages stay out of the line
    t.add_span("sink.queue", 5.0)
    with t.span("loop.pack"):
        pass
    assert set(parse_stage_line(t.summary())) == {"wall", "decode", "infer",
                                                  "encode"}
    assert parse_stage_line(lines[1]) == {"wall": 2.25, "decode": 0.5,
                                           "encode": 0.25, "infer": 0.25}
    assert t.items["encode"] == 2 and t.spans["loop.decode"] == [0.5, 2]


def _events(path):
    with open(path) as f:
        return [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]


def test_profiler_trace_holds_the_loop_ranges_on_the_main_thread(tmp_path):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _upscale(tmp_path, 5)
    path = str(tmp_path / "t.json")
    prof.export_chrome_trace(path)
    main = threading.get_native_id()
    loop = [e for e in _events(path) if e["name"].startswith("loop.")]
    assert {e["tid"] for e in loop} == {main}
    names = {e["name"] for e in loop}
    assert {"loop.open", "loop.decode", "loop.infer", "loop.encode",
            "loop.close", *INFER_PARTS} <= names
    infer = [(e["ts"], e["ts"] + e["dur"]) for e in loop
             if e["name"] == "loop.infer"]
    for e in loop:
        if e["name"] in INFER_PARTS:
            assert any(a <= e["ts"] and e["ts"] + e["dur"] <= b + 1
                       for a, b in infer), e


@pytest.mark.parametrize("frames,steps", [(6, 3), (5, 3)])
def test_stream_loop_leaves_a_record_of_its_frames_and_steps(tmp_path, frames,
                                                             steps):
    _upscale(tmp_path, frames)
    rec = last_loop()
    count = {n: s["count"] for n, s in rec["spans"].items()}
    for name in ("loop.decode", "loop.pack", "source.read", "source.queue",
                 "sink.queue", "sink.interleave", "sink.write"):
        assert count[name] == frames, name
    for name in ("loop.dispatch", "loop.h2d_wait", "loop.d2h_wait"):
        assert count[name] == steps, name
    # one infer and one encode a frame, and one more of each for the flush
    assert count["loop.infer"] == count["loop.encode"] == frames + 1
    assert count["loop.open"] == count["loop.close"] == 1
    assert set(rec["counters"]) == {"sink.queue_full", "source.queue_empty"}
    assert rec["spans"]["loop.infer"]["seconds"] >= sum(
        rec["spans"][n]["seconds"] for n in INFER_PARTS) > 0
    assert rec["wall_s"] >= rec["spans"]["loop.infer"]["seconds"]


def test_trace_dir_holds_the_sink_thread_spans(tmp_path):
    if trace_mod.all_threads_config() is None:
        pytest.skip("this torch's profiler records the main thread only")
    _upscale(tmp_path, 3, "--trace_dir", str(tmp_path / "tr"))
    (name,) = os.listdir(tmp_path / "tr")
    events = _events(str(tmp_path / "tr" / name))
    main = threading.get_native_id()
    sink = {e["tid"] for e in events if e["name"] == "sink.interleave"}
    read = {e["tid"] for e in events if e["name"] == "source.read"}
    assert sink and main not in sink
    assert read and main not in read and not read & sink
    assert main in {e["tid"] for e in events if e["name"] == "loop.infer"}


def test_threads_recording_their_own_spans_lose_nothing():
    """Each span name is one thread's: many threads adding at once, and
    the record read while they do, lose no occurrence."""
    import sys

    t = LoopTrace()
    names = [f"thread{i}.span" for i in range(16)]

    def work(name):
        for _ in range(2000):
            t.add_span(name, 0.5)

    threads = [threading.Thread(target=work, args=(n,)) for n in names]
    saved = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for th in threads:
            th.start()
        while any(th.is_alive() for th in threads):
            t.record()
        for th in threads:
            th.join(timeout=60)
            assert not th.is_alive()
    finally:
        sys.setswitchinterval(saved)
    spans = t.record()["spans"]
    assert {n: spans[n]["count"] for n in names} == dict.fromkeys(names, 2000)
    assert all(spans[n]["seconds"] == 1000.0 for n in names)


# -- the host wrappers on their own -----------------------------------------

class ListSource(FrameSource):
    def __init__(self, n, fail_at=None):
        self.frames = [np.full((4, 6, 3), i, np.uint8) for i in range(n)]
        self.height, self.width = 4, 6
        self.frame_rate = Fraction(24, 1)
        self.num_frames = n
        self.fail_at = fail_at
        self.closed = False
        self.threads = set()
        self._i = 0

    def read(self):
        self.threads.add(threading.current_thread().name)
        if self._i == self.fail_at:
            raise IOError("synthetic decode failure")
        if self._i >= len(self.frames):
            return None
        self._i += 1
        return self.frames[self._i - 1]

    def close(self):
        self.closed = True


class ListSink(FrameSink):
    def __init__(self, fail_at=None, delay=0.0):
        self.frames = []
        self.fail_at = fail_at
        self.delay = delay
        self.closed = False
        self.threads = set()

    def write(self, frame):
        self.threads.add(threading.current_thread().name)
        if len(self.frames) == self.fail_at:
            raise IOError("synthetic encode failure")
        time.sleep(self.delay)
        self.frames.append(frame.copy())

    def close(self):
        self.closed = True


def _counts(t):
    return {n: c for n, (_, c) in t.spans.items()}


@pytest.mark.parametrize("traced", [False, True])
@pytest.mark.parametrize("n,depth", [(0, 2), (1, 2), (20, 4)])
def test_prefetch_source_order_eof_thread_and_spans(traced, n, depth):
    t = LoopTrace() if traced else None
    inner = ListSource(n)
    src = PrefetchSource(inner, depth=depth, trace=t)
    got = [src.read() for _ in range(n)]
    assert src.read() is None and src.read() is None  # EOF, and it sticks
    src.close()
    assert inner.closed and inner.threads == {"uvt-prefetch"}
    assert [int(f[0, 0, 0]) for f in got] == list(range(n))
    if traced:
        want = {"source.read": n, "source.queue": n} if n else {}
        assert _counts(t) == want


@pytest.mark.parametrize("traced", [False, True])
@pytest.mark.parametrize("n,depth,transform", [
    (0, 2, None), (7, 2, None), (15, 3, lambda f: 255 - f)])
def test_async_sink_order_thread_and_spans(traced, n, depth, transform):
    t = LoopTrace() if traced else None
    inner = ListSink(delay=0.002)
    sink = AsyncSink(inner, depth=depth, transform=transform, trace=t)
    frames = [np.full((4, 6, 3), i, np.uint8) for i in range(n)]
    for f in frames:
        sink.write(f)
    sink.close()
    assert inner.closed
    want = [transform(f) if transform else f for f in frames]
    assert all(np.array_equal(a, b) for a, b in zip(inner.frames, want))
    assert len(inner.frames) == n
    assert inner.threads <= {"uvt-sink"}
    if traced:
        want = {"sink.queue": n, "sink.write": n}
        if transform is not None:
            want["sink.interleave"] = n
        assert _counts(t) == ({} if not n else want)
        # a slow writer behind a short queue: writes found it full
        assert (t.counters["sink.queue_full"] > 0) == (n > 2 * depth)


@pytest.mark.parametrize("traced", [False, True])
@pytest.mark.parametrize("side", ["source", "sink"])
def test_errors_reach_the_main_thread(traced, side):
    t = LoopTrace() if traced else None
    if side == "source":
        src = PrefetchSource(ListSource(10, fail_at=3), depth=2, trace=t)
        got = []
        with pytest.raises(IOError, match="decode"):
            while True:
                f = src.read()
                if f is None:
                    break
                got.append(f)
        assert len(got) == 3
        with pytest.raises(IOError, match="decode"):
            src.read()  # the error sticks
        src.close()
    else:
        sink = AsyncSink(ListSink(fail_at=2), depth=2, trace=t)
        with pytest.raises(IOError, match="encode"):
            for i in range(10):
                sink.write(np.full((4, 6, 3), i, np.uint8))
                time.sleep(0.01)
            sink.close()
