"""The readers of the port's loop spans: ``sink_interleave_ms``,
``step_dispatch_ms`` and ``queue_wait_ms`` on synthetic records,
``idle_host_busy_share`` and ``idle_copy_wait_share`` on synthetic device
traces, and all five on a tiny traced run; none raises where the program
records nothing."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from port_bench import loop_spans, spec
from port_bench.tests.tiny import run_cell, tiny_cell
from port_bench.trace import Trace

NEW = ("sink_interleave_ms", "step_dispatch_ms", "queue_wait_ms",
       "idle_host_busy_share", "idle_copy_wait_share")
MAIN, OTHER = 7, 8


def reader(name):
    return spec.load_module(spec.BENCH_DIR / "metrics" / f"{name}.py", "test")


def _span(name, ts, dur, tid=MAIN):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts,
            "dur": dur, "tid": tid}


def _kernel(ts, dur, device=0):
    return {"ph": "X", "cat": "kernel", "name": "k", "ts": ts, "dur": dur,
            "args": {"device": device}}


def _trace(*events):
    return Trace([_span("bench.window", 0, 100), *events])


# GPU 0 idles over [0, 10), [40, 60) and [90, 100): 40% of the window
KERNELS = (_kernel(10, 30), _kernel(60, 30))
LOOP = (
    _span("loop.decode", 0, 6),        # most of the first gap waits
    _span("loop.infer", 40, 20),
    _span("loop.d2h_wait", 40, 10),    # the middle gap: half a copy wait,
    _span("loop.dispatch", 50, 10),    # half the host dispatching
    _span("loop.close", 90, 10),
    _span("loop.h2d_wait", 0, 10, tid=OTHER),  # not the main thread
)


def _run(trace, gpus=1):
    return SimpleNamespace(trace=trace, gpus=gpus)


def test_idle_split_by_the_main_threads_ranges():
    run = _run(_trace(*KERNELS, *LOOP))
    busy = reader("idle_host_busy_share").read(run)
    copy = reader("idle_copy_wait_share").read(run)
    idle = reader("device_idle_share").read(run)
    assert idle == pytest.approx(40.0)
    assert copy == pytest.approx(10.0)
    assert busy == pytest.approx(24.0)  # 4 + 10 + 10 of the 40 idle
    assert busy + copy <= idle
    labels = [g[0] for g in run.trace.breakdown([0])["idle_gaps"]]
    assert labels == ["cuda:0 loop.dispatch", "cuda:0 loop.decode",
                      "cuda:0 loop.close"]


def test_idle_split_reads_the_gpu_device_idle_share_reads():
    # GPU 1 runs one short kernel: the idlest, and the one read
    run = _run(_trace(*KERNELS, _kernel(0, 50, device=1), *LOOP), gpus=2)
    assert reader("device_idle_share").read(run) == pytest.approx(50.0)
    assert reader("idle_copy_wait_share").read(run) == pytest.approx(0.0)
    # [50, 100) idle: dispatch 10, close 10, 30 outside any range
    assert reader("idle_host_busy_share").read(run) == pytest.approx(50.0)


@pytest.mark.parametrize("trace", [
    None,                              # an untraced run
    _trace(*KERNELS),                  # a program that opens no loop range
    _trace(*KERNELS, _span("loop.infer", 0, 10, tid=OTHER)),
])
def test_idle_shares_read_nothing_without_the_loop_ranges(trace):
    for name in ("idle_host_busy_share", "idle_copy_wait_share"):
        assert reader(name).read(_run(trace)) is None


def test_overlap_of_interval_lists():
    assert loop_spans.overlap([(0, 10), (20, 30)], [(5, 25)]) == 10
    assert loop_spans.overlap([(0, 1)], [(1, 2)]) == 0
    assert loop_spans.overlap([], [(0, 5)]) == 0


RECORD = {"wall_s": 2.0, "counters": {"sink.queue_full": 3},
          "spans": {"sink.interleave": {"seconds": 0.06, "count": 10},
                    "loop.dispatch": {"seconds": 0.01, "count": 4},
                    "source.queue": {"seconds": 1.0, "count": 10},
                    "sink.queue": {"seconds": 0.5, "count": 10},
                    "loop.d2h_wait": {"seconds": 0.0, "count": 0}}}


def _with_record(monkeypatch, rec):
    from upscale_video_tpu_torch.utils import trace

    monkeypatch.setattr(trace, "_last_loop", rec)


def test_record_readers_take_each_spans_mean(monkeypatch):
    _with_record(monkeypatch, RECORD)
    run = _run(None)
    assert reader("sink_interleave_ms").read(run) == pytest.approx(6.0)
    assert reader("step_dispatch_ms").read(run) == pytest.approx(2.5)
    assert reader("queue_wait_ms").read(run) == pytest.approx(150.0)
    assert loop_spans.mean_ms(RECORD, "loop.d2h_wait") is None


@pytest.mark.parametrize("rec", [
    None, {"spans": {}, "counters": {}},
    {"spans": {"source.queue": {"seconds": 1.0, "count": 4}}},
])
def test_record_readers_read_nothing_without_their_spans(monkeypatch, rec):
    _with_record(monkeypatch, rec)
    for name in ("sink_interleave_ms", "step_dispatch_ms", "queue_wait_ms"):
        assert reader(name).read(_run(None)) is None


def test_record_readers_read_nothing_from_a_program_without_a_record(
        monkeypatch):
    import upscale_video_tpu_torch.utils.trace as trace

    monkeypatch.delattr(trace, "last_loop")
    assert loop_spans.record() is None


@pytest.mark.parametrize("workload,traffic", [
    ("compact2x-1080p-i420-tta", {"tta": False}),
    ("valar4x-1080p-i420-dp4", {"height": 24, "width": 40}),
])
def test_a_traced_run_reports_every_new_metric(workload, traffic):
    run = run_cell(tiny_cell(workload, **traffic), 2 ** 34 + 3, trace=True)
    got = {name: run.cell.readers[name].read(run) for name in NEW}
    assert all(v is not None and v >= 0 for v in got.values()), got
    assert got["sink_interleave_ms"] > 0 and got["step_dispatch_ms"] > 0
    idle = run.cell.readers["device_idle_share"].read(run)
    assert got["idle_host_busy_share"] + got["idle_copy_wait_share"] <= \
        idle + 1e-9
    labels = [g[0] for g in run.trace.breakdown(list(range(run.gpus)))[
        "idle_gaps"]]
    assert not any("main thread in Python" in lb for lb in labels), labels
