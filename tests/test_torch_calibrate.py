"""Calibration on the CPU: the port's ``run_calibration`` (and
``test-chips-torch``) against the JAX package's.

- The sweep itself (which engines are built, which points are timed, the
  log lines, the closing ``best:`` line) is compared with both packages on
  the same stand-in engine, so only the sweep logic runs: equal points and
  equal lines once the timings are masked.
- On real engines (synthetic models, a tiny frame): the points and the
  ``best:`` line have the JAX function's form.
"""

import logging
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from upscale_video_tpu.pipeline import calibrate as jax_cal
from upscale_video_tpu_torch.cli import test_chips
from upscale_video_tpu_torch.pipeline import calibrate as port_cal
from upscale_video_tpu_torch.pipeline.chain import (
    ChainEngine, ChainSpec, parse_chips,
)
from tests.torch_fixtures import one_torch_thread, two_rrdbs  # noqa: F401


NUMBER = re.compile(r"\d+\.\d+")
# the best point of a stand-in sweep is whichever timing came out lowest
BEST = re.compile(r"(--tile_size) \S+|(--frames_per_step) \d+")


class StandIn:
    """An engine that returns its input: the sweep's logic alone."""

    def __init__(self, tile):
        self.tile = 0 if tile is None else tile
        self.calls = 0

    def configure_chips(self, chips, frames_per_step):
        return frames_per_step * parse_chips(chips)[1] if chips else frames_per_step

    def process(self, batch):
        self.calls += 1
        return batch


def _sweep(module, engine_cls, monkeypatch, caplog, **kw):
    built = []

    def build(spec, scale, *args, tile=None, **_):
        built.append((spec.real_life, tile))
        return StandIn(tile)

    monkeypatch.setattr(engine_cls, "build", staticmethod(build))
    caplog.clear()
    with caplog.at_level(logging.INFO, logger=module.__name__):
        points = module.run_calibration(synthetic_models=True, height=8,
                                        width=12, runs=2, **kw)
    lines = [BEST.sub(lambda m: (m.group(1) or m.group(2)) + " *",
                      NUMBER.sub("#", r.getMessage()))
             for r in caplog.records
             if r.name == module.__name__ and not r.getMessage().startswith(
                 ("device", "TPU", "CPU", "Total"))]
    return points, lines, built


@pytest.mark.parametrize("kw", [
    dict(), dict(models="r"), dict(tiles=["8", "8x12"], chips="0,0"),
    dict(models="r", tiles=["auto"], chips="0", batch_depths=(1, 2)),
], ids=["compact", "m_r_default_tiles", "tiles_and_depth", "m_r_auto"])
def test_sweep_equals_jax(monkeypatch, caplog, kw):
    from upscale_video_tpu.pipeline.chain import ChainEngine as JaxEngine

    monkeypatch.setattr(jax_cal, "describe_devices", lambda: [])
    monkeypatch.setattr(port_cal, "describe_devices", lambda *a: [])
    want, want_lines, want_built = _sweep(jax_cal, JaxEngine, monkeypatch,
                                          caplog, **kw)
    got, got_lines, got_built = _sweep(port_cal, ChainEngine, monkeypatch,
                                       caplog, device="cpu", **kw)
    assert [(p.frames_per_step, p.tile) for p in got] == \
        [(p.frames_per_step, p.tile) for p in want]
    assert got_built == want_built
    assert got_lines == want_lines
    assert got_lines[-1].startswith("best: ")


def test_sample_image_equals_jax():
    np.testing.assert_array_equal(port_cal.sample_image(20, 30, seed=3),
                                  jax_cal.sample_image(20, 30, seed=3))


def _best(caplog, name):
    (line,) = [r.getMessage() for r in caplog.records
               if r.name == name and r.getMessage().startswith("best: ")]
    return line


def test_points_and_best_line_have_the_jax_form(caplog):
    """On real engines (the synthetic Compact, f32, an 8x12 frame): the same
    points, each with a positive rate, and a ``best:`` line of the same
    form."""
    caplog.set_level(logging.INFO)
    kw = dict(synthetic_models=True, height=8, width=12, runs=1,
              batch_depths=(1, 2), precision="f32")
    want = jax_cal.run_calibration(**kw)
    got = port_cal.run_calibration(device="cpu", **kw)
    assert [(p.frames_per_step, p.tile) for p in got] == \
        [(p.frames_per_step, p.tile) for p in want] == [(1, None), (2, None)]
    assert all(p.frames_per_second > 0 and p.seconds_per_step > 0 for p in got)
    form = r"best: --frames_per_step [12] \(\d+\.\d\d frames/sec at 12x8, scale 2x\)"
    assert re.fullmatch(form, _best(caplog, jax_cal.__name__))
    assert re.fullmatch(form, _best(caplog, port_cal.__name__))


def test_m_r_tile_sweep_runs_on_cpu(caplog, two_rrdbs):
    """``-m r`` sweeps the tiles asked for on the Valar stand-in (mixed, 2
    RRDBs here), and the ``best:`` line names a tile and a depth."""
    caplog.set_level(logging.INFO)
    points = port_cal.run_calibration(models="r", synthetic_models=True,
                                      height=8, width=12, runs=1,
                                      batch_depths=(1,), tiles=["8", "8x12"],
                                      device="cpu")
    assert [(p.frames_per_step, p.tile) for p in points] == [(1, "8"), (1, "8x12")]
    assert re.fullmatch(r"best: --tile_size 8(x12)? --frames_per_step 1 "
                        r"\(\d+\.\d\d frames/sec at 12x8, scale 4x\)",
                        _best(caplog, port_cal.__name__))


def test_process_is_the_step_on_host_arrays():
    eng = ChainEngine.build(ChainSpec(), 2, "cpu", synthetic=True)
    x = np.random.default_rng(4).integers(0, 256, (2, 6, 10, 3), dtype=np.uint8)
    got = eng.process(x)
    assert isinstance(got, np.ndarray) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, eng.step(torch.from_numpy(x)).numpy())


@pytest.mark.parametrize("chips", ["0,1", "1,0,1"])
def test_cli_refuses_more_than_one_gpu(monkeypatch, chips):
    """More GPUs than the host has: ``-g`` naming a second GPU on a
    one-GPU host raises the JAX package's "out of range" before any engine
    is built."""
    monkeypatch.setattr(port_cal, "resolve_device",
                        lambda d: torch.device("cuda", 0))
    monkeypatch.setattr(port_cal, "describe_devices", lambda *a: [])
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(ChainEngine, "build", None)
    with pytest.raises(ValueError, match=r"chip ids \[1\] out of range"):
        test_chips.main(["-g", chips, "--synthetic_models"])


def test_jax_float32_is_what_f32_resolves_to():
    """The f32 points above compare like with like: both packages resolve
    ``--precision f32`` to float32 convs."""
    from upscale_video_tpu.pipeline.chain import precision_dtypes as jax_pd
    from upscale_video_tpu_torch.pipeline.chain import precision_dtypes

    assert jax_pd("f32")[0] == jnp.float32
    assert precision_dtypes("f32")[0] == torch.float32
