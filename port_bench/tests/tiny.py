"""Cells of ``BENCHMARK.json`` cut to a size the CPU runs in seconds."""

from __future__ import annotations

import contextlib
import dataclasses

import torch

from port_bench import spec


def tiny_cell(workload: str, height: int = 32, width: int = 48,
              tile: int = 16, **traffic) -> spec.Cell:
    cell = spec.cell(spec.load_benchmark(), workload)
    t = dict(cell.traffic, height=height, width=width, pool_frames=6)
    t.update(traffic)
    cfg = dict(cell.config)
    if cfg["tile"]:
        cfg["tile"] = tile
    return dataclasses.replace(cell, traffic=t, config=cfg)


@contextlib.contextmanager
def threads(n: int = 2):
    saved = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(saved)


def run_cell(cell: spec.Cell, seed: int, seconds: float = 0.3,
             trace: bool = False):
    """A whole run on the CPU but the look for a GPU: set-up, warm-up,
    window, check.  Returns the closed :class:`Run`."""
    from port_bench.harness import Run

    run = Run(cell, seed, seconds, trace, "cpu")
    try:
        with threads():
            run.setup()
            run.warmup()
            run.window()
            run.release()
            run.check()
    finally:
        run.close()
    return run
