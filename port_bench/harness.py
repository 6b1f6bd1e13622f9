"""One run of a cell: set-up, warm-up, the timed window and the check.

The window is one call of the port's stream loop,
``upscale_video_tpu_torch.pipeline.process._run_stream_plane``, on one
fragment, with the engine built as ``process_file`` builds it (``ChainEngine
.build`` from model files the benchmark wrote, ``default_frames_per_step``,
``configure_chips``, ``_auto_pipe_pix``) and the benchmark's
:class:`~port_bench.backend.BenchBackend` as its video backend.  Warm-up
calls of the same loop build the kernels, fill the allocators and measure
the rate that sizes the window to ``seconds``.
"""

from __future__ import annotations

import gc
import logging
import math
import os
import re
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional

import numpy as np
import torch

from port_bench import check, frames, ncnn, reference
from port_bench.backend import BenchBackend, Recorder
from port_bench.flops import graph_conv_flops
from port_bench.spec import Cell
from port_bench.trace import Trace, profiled

from upscale_video_tpu_torch.pipeline import process
from upscale_video_tpu_torch.pipeline.chain import (
    ChainEngine, ChainSpec, default_frames_per_step, precision_dtypes,
)

STAGE_LOGGER = "upscale_video_tpu_torch.utils.profiling"
WARM_SECONDS = 1.0  # the warm-up call that measures the rate lasts about this


class _Lines(logging.Handler):
    def __init__(self):
        super().__init__(logging.INFO)
        self.lines: List[str] = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def parse_stage_line(line: str) -> Dict[str, float]:
    """``StageTimer``'s ``stage timing: wall 10.23s | decode: 0.01s (0%,
    ...) | ...`` -> ``{"wall": 10.23, "decode": 0.01, ...}``."""
    out = {"wall": float(re.search(r"wall ([\d.]+)s", line).group(1))}
    for name, sec in re.findall(r"\| (\w+): ([\d.]+)s", line):
        out[name] = float(sec)
    return out


class Run:
    """A cell's run; :meth:`setup`, :meth:`warmup`, :meth:`window` and
    :meth:`check` in that order.  Its attributes are what the metric
    readers read."""

    def __init__(self, cell: Cell, seed: int, seconds: float, trace: bool,
                 device: str = "cuda", t_start: Optional[float] = None):
        self.cell, self.seconds, self.traced = cell, seconds, trace
        self.cfg, self.traffic = cell.config, cell.traffic
        self.family = cell.family
        self.gpus = self.traffic["gpus"]
        self.dev = (torch.device(device, 0) if device == "cuda"
                    else torch.device(device))
        self.devices = ([torch.device("cuda", i) for i in range(self.gpus)]
                        if self.dev.type == "cuda" else [self.dev])
        self.t_start = time.perf_counter() if t_start is None else t_start
        w, f, s = np.random.SeedSequence(seed).generate_state(3, np.uint64)
        self.weight_seed, self.frame_seed = int(w), int(f)
        self.sample_seed = int(s)
        self.trace: Optional[Trace] = None
        self.stage: Dict[str, float] = {}
        self.phases: Dict[str, float] = {}  # set-up's parts, seconds since start

    def _mark(self, phase: str) -> None:
        self.phases[phase] = time.perf_counter() - self.t_start

    # -- set-up ---------------------------------------------------------
    def setup(self) -> None:
        cfg, t = self.cfg, self.traffic
        self._mark("imports")
        for d in self.devices:
            torch.zeros(1, device=d)
        self._mark("device_init")
        model_dir = self.write_model()
        self.pool = frames.pool(t, self.frame_seed, self.dev)
        if self.dev.type == "cuda":
            for d in self.devices:
                torch.cuda.synchronize(d)
                torch.cuda.reset_peak_memory_stats(d)
        self._mark("weights_and_files")

        spec = ChainSpec.parse(cfg["models"] or None)
        compute_dtype, residual_dtype = precision_dtypes(cfg["precision"], spec)
        self.engine = ChainEngine.build(
            spec, cfg["upscale"], self.dev, model_path=model_dir,
            compute_dtype=compute_dtype, residual_dtype=residual_dtype,
            tile=t.get("tile_size"), halo=cfg["halo"],
            tta=t.get("tta", False))
        fps = t["frames_per_step"] or default_frames_per_step(spec)
        chips = ",".join(map(str, range(self.gpus))) if self.gpus > 1 else None
        self.frames_per_step = self.engine.configure_chips(chips, fps,
                                                           t["parallel"])
        self.frames_per_launch = (self.frames_per_step // self.gpus
                                  if t["parallel"] == "dp" else
                                  self.frames_per_step)
        self.backend = BenchBackend(
            t, self.pool, lambda fr: reference.i420_to_rgb(fr, t))
        self.backend.begin(0)
        self.pipe_pix = process._auto_pipe_pix(
            self.backend, self.engine, self.backend.info(), "", "stream")
        self.workdir = os.path.join(self.tmp, "work")
        os.makedirs(self.workdir)
        self._mark("engine")
        self._stage_log = logging.getLogger(STAGE_LOGGER)
        self._lines = _Lines()
        self._stage_log.addHandler(self._lines)
        self._stage_log.setLevel(logging.INFO)
        self._stage_log.propagate = False

    def write_model(self) -> str:
        """The configuration's graph, its seeded weights, its ``.param`` and
        ``.bin`` in a new temporary directory, and the work of a frame
        (``flops_per_frame``: the family's ``flops(cfg, height, width)``
        where it defines one, else :func:`graph_conv_flops`; x8 under
        ``--tta``).  Returns the directory that holds the model files."""
        cfg, t = self.cfg, self.traffic
        self._tmp = tempfile.TemporaryDirectory(prefix="port_bench_")
        self.tmp = self._tmp.name
        self.layers = self.family.layers(cfg)
        self.weights = ncnn.seeded_weights(self.layers, self.weight_seed,
                                           self.dev, cfg["init"])
        model_dir = os.path.join(self.tmp, "models")
        os.makedirs(model_dir)
        stem = os.path.join(model_dir, f"{cfg['upscale']}{cfg['model_file']}")
        with open(stem + ".param", "w") as fh:
            fh.write(ncnn.param_text(self.layers))
        with open(stem + ".bin", "wb") as fh:
            fh.write(ncnn.bin_bytes(self.layers, self.weights))
        self.model_bytes = sum(os.path.getsize(stem + ext)
                               for ext in (".param", ".bin"))
        count = getattr(self.family, "flops", None)
        per_frame = (count(cfg, t["height"], t["width"]) if count else
                     graph_conv_flops(self.layers, t["height"], t["width"]))
        self.flops_per_frame = per_frame * (8 if t.get("tta") else 1)
        return model_dir

    def loop(self, n_frames: int, keep=()) -> Recorder:
        """One call of the stream loop over ``n_frames`` frames, as one
        fragment; its file is removed afterwards."""
        rec = self.backend.begin(n_frames, keep)
        process._run_stream_plane(
            self.engine, self.backend, "bench", self.backend.info(), "",
            self.workdir, {1: (1, n_frames)}, self.frames_per_step,
            pipe_pix=self.pipe_pix)
        os.remove(os.path.join(self.workdir, self.backend.fragment_name(1)))
        return rec

    def _timed(self, n_frames: int) -> float:
        t0 = time.perf_counter()
        self.loop(n_frames)
        return time.perf_counter() - t0

    def warmup(self) -> None:
        """Build and warm every shape the window uses, then size the window
        from the rate of a call of about :data:`WARM_SECONDS`."""
        step = self.frames_per_step
        self.loop(2 * step)
        self._mark("warm_first_call")
        n = 4 * step
        dt = self._timed(n)
        for _ in range(4):
            if dt >= 0.5 * WARM_SECONDS:
                break
            n = step * max(4, math.ceil(n / dt * WARM_SECONDS / step))
            dt = self._timed(n)
        self._mark("warm_rate_calls")
        self.warm_rate = n / dt
        self.n_frames = step * max(2, round(self.warm_rate * self.seconds / step))
        self.sampled = check.sample(self.n_frames, self.frames_per_step,
                                    check.n_check(self.flops_per_frame, step),
                                    self.sample_seed)

    # -- the window -----------------------------------------------------
    def window(self) -> None:
        def call():
            t0 = time.perf_counter()
            rec = self.loop(self.n_frames, self.sampled)
            return rec, t0, time.perf_counter()

        self._lines.lines.clear()
        if self.traced:
            (rec, t0, t1), self.trace = profiled(call, self.tmp)
        else:
            rec, t0, t1 = call()
        self.rec = rec
        self.setup_s = t0 - self.t_start
        self.window_s = t1 - t0
        self.frames = len(rec.received)
        n = min(len(rec.sent), len(rec.received))
        self.latencies_ms = [1e3 * (rec.received[i] - rec.sent[i])
                             for i in range(n)]
        line = next((ln for ln in reversed(self._lines.lines)
                     if ln.startswith("stage timing: ")), None)
        self.stage = parse_stage_line(line) if line else {}
        self.peak_bytes = (max(torch.cuda.max_memory_allocated(d)
                               for d in self.devices)
                           if self.dev.type == "cuda" else 0)

    def release(self) -> None:
        """Free the program's state before the reference runs."""
        self.engine = None
        self.backend.rec = None
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    # -- the check ------------------------------------------------------
    def reference_frames(self, precision: str = "f32") -> Dict[int, np.ndarray]:
        """The reference's output for each sampled frame's input, the
        distinct inputs spread over the run's GPUs, one thread each."""
        reference.tf32_off()
        inputs = self.backend.handed_out
        keys = sorted({i % len(inputs) for i in self.sampled})
        devices = self.devices[:len(keys)] or [self.dev]

        def on(dev, mine):
            w = {n: {k: v.to(dev) for k, v in p.items()}
                 for n, p in self.weights.items()}
            ref = reference.Reference(self.cfg, self.traffic, self.family, w,
                                      precision)
            return {k: ref.frame(inputs[k], dev, self.backend.raw_i420,
                                 self.backend.yuv420_out) for k in mine}

        jobs = [(d, keys[j::len(devices)]) for j, d in enumerate(devices)]
        with ThreadPoolExecutor(len(jobs)) as pool:
            by_pool = {}
            for part in pool.map(lambda job: on(*job), jobs):
                by_pool.update(part)
        return {i: by_pool[i % len(inputs)] for i in self.sampled}

    def out_hw(self):
        s = self.cfg["upscale"]
        return self.traffic["height"] * s, self.traffic["width"] * s

    def numbers(self, got: Dict[int, np.ndarray],
                want: Dict[int, np.ndarray]) -> List[Dict[str, float]]:
        h, w = self.out_hw()
        return [check.compare(got[i], want[i], h, w, self.backend.yuv420_out)
                if i in got else {k: float("inf") for k in check.NUMBERS}
                for i in self.sampled]

    def judge(self, per_frame: List[Dict[str, float]], received: int):
        """``(failed, worst, checks)`` of sampled frames' numbers: a frame
        fails where a number is over the cell's limit, and each frame the
        sink never received fails too.  ``correct`` is ``failed == 0``."""
        worst = check.worst(per_frame)
        limits = {k: v["limit"] for k, v in self.cell.limits.items()
                  if k in check.NUMBERS}
        bad = sum(1 for f in per_frame
                  if any(f[k] > lim for k, lim in limits.items()))
        checks = {"frames_received": {"value": received,
                                      "limit": self.n_frames}}
        for k, lim in limits.items():
            checks[k] = {"value": worst[k], "limit": lim}
        return bad + self.n_frames - received, worst, checks

    def check(self) -> None:
        """Compare the sampled frames the sink received with the
        reference's; ``correct`` needs every frame received and the worst
        sampled frame within each limit the cell lists."""
        self.ref = self.reference_frames()
        self.failed, self.worst, self.checks = self.judge(
            self.numbers(self.rec.kept, self.ref), self.frames)
        self.correct = self.failed == 0

    def close(self) -> None:
        if hasattr(self, "_lines"):
            self._stage_log.removeHandler(self._lines)
        if hasattr(self, "_tmp"):
            self._tmp.cleanup()
