"""Calibration on one GPU: time candidate configurations of the chain step.

Port of ``upscale_video_tpu/pipeline/calibrate.py`` (the ``test-chips``
sweep) over the port's :class:`~upscale_video_tpu_torch.pipeline.chain.
ChainEngine`: the same tiles x batch depths, the same log lines and the
same closing ``best: --tile_size ... --frames_per_step ...`` line.  The
device line comes from ``torch.cuda.get_device_properties`` (the JAX
package's ``describe_devices`` lists its chips); a ``-g`` over more than
one GPU raises, as :meth:`ChainEngine.configure_chips` does.  Each point
is timed around :meth:`ChainEngine.process`, which returns host arrays,
so the wall clock covers the device's work.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np
import torch

from upscale_video_tpu_torch.cli.common import tile_spec
from upscale_video_tpu_torch.device import resolve_device
from upscale_video_tpu_torch.pipeline.chain import (
    ChainEngine, ChainSpec, parse_chips, precision_dtypes,
)

log = logging.getLogger(__name__)


@dataclass
class CalibrationPoint:
    frames_per_step: int
    seconds_per_step: float
    frames_per_second: float
    tile: Optional[str] = None  # the swept --tile_size spec, if any


def sample_image(height: int = 540, width: int = 960, seed: int = 0) -> np.ndarray:
    """Synthetic calibration frame (the JAX package's, value for value)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:height, 0:width]
    img = np.stack(
        [
            128 + 100 * np.sin(yy / 17.0) * np.cos(xx / 23.0),
            128 + 90 * np.cos(yy / 11.0 + xx / 31.0),
            (xx * 255.0 / width),
        ],
        axis=-1,
    )
    img += rng.normal(0, 8, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def describe_device(device: torch.device) -> List[str]:
    """One log line for the device the sweep runs on."""
    if device.type != "cuda":
        return [f"device {device} (the plain PyTorch versions)"]
    p = torch.cuda.get_device_properties(device)
    return [f"device {device}: {p.name}, {p.total_memory / 2**30:.1f} GiB, "
            f"{p.multi_processor_count} SMs, sm_{p.major}{p.minor}"]


def run_calibration(
    chips: Optional[str] = None,
    scale: int = 2,
    runs: int = 10,
    batch_depths: Sequence[int] = (1, 2, 4, 8),
    height: int = 540,
    width: int = 960,
    model_path: Optional[str] = None,
    synthetic_models: bool = False,
    precision: str = "auto",
    models: Optional[str] = None,
    tiles: Optional[Sequence[str]] = None,
    device: str = "cuda",
) -> List[CalibrationPoint]:
    """Time the chain step at each (tile, batch depth); returns points.

    ``models`` is the ``-m`` chain DSL.  ``tiles`` is a sequence of
    ``--tile_size`` specs (``auto`` / budget int / ``HxW``); None keeps
    the single product-default tile except for ``-m r``, where the default
    sweep is ``("auto", "480", "544x480")``.  Each tile is a fresh engine
    build.  ``device`` is where it runs (``cuda`` unless the caller asks
    for the CPU)."""
    dev = resolve_device(device)
    for line in describe_device(dev):
        log.info(line)

    chip_ids, multiplier = parse_chips(chips)
    log.info("chips %s (batch multiplier %d)", chip_ids, multiplier)

    spec = ChainSpec.parse(models)
    if tiles is None:
        tiles = ("auto", "480", "544x480") if spec.real_life else (None,)

    dtype, residual_dtype = precision_dtypes(precision, spec)
    img = sample_image(height, width)

    points: List[CalibrationPoint] = []
    for tile in tiles:
        engine = ChainEngine.build(
            spec, scale, dev, model_path=model_path,
            compute_dtype=dtype, synthetic=synthetic_models,
            tile=None if tile is None else tile_spec(str(tile)),
            residual_dtype=residual_dtype,
        )
        if tile is not None:
            log.info("tile_size %s -> engine tile %r", tile, engine.tile)
        for depth in batch_depths:
            n = engine.configure_chips(chips, depth)
            if not chips:
                n = depth * multiplier
            batch = np.broadcast_to(img, (n, *img.shape)).copy()
            engine.process(batch)  # warm-up: the kernels' build, the plans
            times = []
            for _ in range(runs):
                t0 = time.perf_counter()
                engine.process(batch)
                times.append(time.perf_counter() - t0)
            med = float(np.median(times))
            pt = CalibrationPoint(
                n, med, n / med, None if tile is None else str(tile)
            )
            points.append(pt)
            log.info(
                "%sframes_per_step=%d: %.4f s/step, %.2f frames/sec",
                "" if tile is None else f"tile_size={tile} ",
                pt.frames_per_step, pt.seconds_per_step,
                pt.frames_per_second,
            )
    best = max(points, key=lambda p: p.frames_per_second)
    rec = f"--frames_per_step {best.frames_per_step}"
    if best.tile is not None:
        rec = f"--tile_size {best.tile} " + rec
    log.info(
        "best: %s (%.2f frames/sec at %dx%d, scale %dx)",
        rec, best.frames_per_second, width, height,
        spec.effective_scale(scale),
    )
    return points
