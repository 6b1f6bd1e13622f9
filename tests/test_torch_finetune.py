"""The ``vsr-finetune-torch`` workflow on the CPU against the JAX package's
``vsr-finetune`` (train/finetune.py, cli/finetune.py).

- The sampler: ``_sample_batch`` draws the same crops from one seed (the
  rng call order is the JAX one's), ``_load_hr_frames`` decodes the same
  frames.
- ``finetune(data="synthetic" | <y4m>, synthetic_model=True, seed=0)`` at
  the CLI's learning rate (1e-4), 8 steps: each loss within 1e-5 relative
  of JAX's; the exported ``.bin`` loads through both packages' loaders,
  every conv weight within 1 fp16 ulp of JAX's export or, where it sits
  so near zero that an ulp is smaller than Adam's noise, within one Adam
  step (``lr``), byte-identical for nearly all; every f32 bias and slope
  within ``lr``; a second emit is byte-identical.
- At 10x that rate the two runs part after ~3 steps: Adam turns the f32
  summation noise of its near-zero gradients into steps of up to ``lr``,
  and those spread through the next gradients (measured at lr 1e-3 on the
  Y4M clip: losses 1.8e-4 apart relative, weights up to 4.3e-3).  That run
  is held to Adam's own bound (``2 * steps * lr``) and the loss to 1e-3.
- The RRDB family (``-m x_<stem> -s 4``) trains and its loss decreases.
- Resume continues the uninterrupted run: the sampler's state is in the
  checkpoint (the JAX workflow redraws its first batches on resume).
- ``--mesh dp=2,sp=4`` on logical CPU shards against the single step.
- The CLI: ``main`` on ``--device cpu``, ``--resume`` without
  ``--ckpt_dir`` refused, no GPU without ``--device cpu`` raises.

The clip is tests/test_finetune.py's hermetic writer (4 frames of 40x48).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_finetune import _write_clip
from upscale_video_tpu.models.zoo import load_model as jax_load_model
from upscale_video_tpu.train import finetune as jax_ft
from upscale_video_tpu_torch.cli.finetune import main as cli_main
from upscale_video_tpu_torch.models.zoo import (
    load_model, make_synthetic_rrdb_model,
)
from upscale_video_tpu_torch.train import finetune as ft
from tests.torch_fixtures import one_torch_thread  # noqa: F401

CLI_LR = 1e-4
LOSS_RTOL = 1e-5      # per step at the CLI's rate: f32 summation noise
MAX_ULPS = 1          # fp16 export, per conv weight ...
ADAM_NOISE = CLI_LR   # ... or, near zero where an ulp is tiny, within one
# Adam step: a weight whose gradient passed near Adam's eps took a step of
# noise (measured on the synthetic pairs: ~1% of weights over 1 ulp, at
# most 2.3e-5 apart; biases and slopes at most 6.5e-6)
MAX_DIFFER = 0.1      # share of conv weights whose fp16 bytes differ at all
# (measured 5.6% on the synthetic pairs, 0.05% on the Y4M clip)
FAST_LR = 1e-3
FAST_LOSS_RTOL = 1e-3  # at 10x the rate Adam amplifies the noise (above)


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    path = tmp_path_factory.mktemp("clip") / "src.y4m"
    _write_clip(path)
    return str(path)


def _weights(stem):
    from upscale_video_tpu_torch.models.bin_loader import load_weights_file
    from upscale_video_tpu_torch.models.param_parser import parse_param_file

    return load_weights_file(parse_param_file(stem + ".param"), stem + ".bin")


def _ordered_f16(x):
    """fp16 bit patterns as integers ordered like the values (one apart =
    one ulp apart)."""
    bits = x.astype(np.float16).view(np.uint16).astype(np.int64)
    return np.where(bits & 0x8000, -(bits & 0x7FFF), bits)


def _both(tmp_path, data, **kw):
    kw = dict(data=data, steps=8, batch=2, patch=8, scale=2,
              synthetic_model=True, seed=0, **kw)
    want = jax_ft.finetune(output_dir=str(tmp_path / "jax"), **kw)
    got = ft.finetune(output_dir=str(tmp_path / "port"), device="cpu", **kw)
    assert got["steps"] == want["steps"] == 8
    return got, want


def test_sample_batch_equals_jax():
    frames = np.random.default_rng(0).integers(0, 256, (3, 40, 48, 3),
                                               dtype=np.uint8)
    r1, r2 = np.random.default_rng(11), np.random.default_rng(11)
    for _ in range(3):
        for a, b in zip(ft._sample_batch(frames, 3, 8, 2, r1),
                        jax_ft._sample_batch(frames, 3, 8, 2, r2)):
            np.testing.assert_array_equal(a, b)
    assert r1.integers(0, 1 << 30) == r2.integers(0, 1 << 30)


def test_sample_batch_too_small_raises():
    frames = np.zeros((1, 8, 8, 3), np.uint8)
    with pytest.raises(ValueError, match="smaller"):
        ft._sample_batch(frames, 1, 16, 2, np.random.default_rng(0))


def test_load_hr_frames_equals_jax(clip):
    got = ft._load_hr_frames(clip, 3, None)
    np.testing.assert_array_equal(got, jax_ft._load_hr_frames(clip, 3, None))
    assert got.shape == (3, 40, 48, 3)


@pytest.mark.parametrize("source", ["synthetic", "y4m"])
def test_finetune_equals_jax(tmp_path, clip, source):
    got, want = _both(tmp_path, "synthetic" if source == "synthetic" else clip,
                      learning_rate=CLI_LR)
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=LOSS_RTOL)
    port, jax = got["export_path"], want["export_path"]
    with open(port + ".param") as f1, open(jax + ".param") as f2:
        assert f1.read() == f2.read()
    pw, jw = _weights(port), _weights(jax)
    differ = total = 0
    for name in jw:
        for k in jw[name]:
            a, b = pw[name][k], jw[name][k]
            if k == "weight":
                ulps = np.abs(_ordered_f16(a) - _ordered_f16(b))
                near = np.abs(a.astype(np.float16).astype(np.float32)
                              - b.astype(np.float16).astype(np.float32))
                assert ((ulps <= MAX_ULPS) | (near <= ADAM_NOISE)).all(), (name, k)
                differ, total = differ + int((ulps > 0).sum()), total + ulps.size
            else:
                np.testing.assert_allclose(a, b, rtol=0, atol=ADAM_NOISE)
    assert differ <= MAX_DIFFER * total, (differ, total)

    # the export loads through both loaders; a second emit is byte-identical
    name = os.path.basename(port)
    m = load_model(name[1:], int(name[0]), "cpu", os.path.dirname(port),
                   torch.float32)
    again = m.save(str(tmp_path / "again"), stem=name)
    jm = jax_load_model(name[1:], int(name[0]), os.path.dirname(port),
                        jnp.float32)
    jagain = jm.save(str(tmp_path / "jagain"), stem=name)
    for stem in (again, jagain):
        for ext in (".bin", ".param"):
            with open(port + ext, "rb") as f1, open(stem + ext, "rb") as f2:
                assert f1.read() == f2.read(), (stem, ext)


def test_finetune_at_ten_times_the_rate_stays_within_adams_bound(tmp_path, clip):
    got, want = _both(tmp_path, clip, learning_rate=FAST_LR)
    np.testing.assert_allclose(got["losses"], want["losses"],
                               rtol=FAST_LOSS_RTOL)
    assert got["losses"][-1] < got["losses"][0]
    pw, jw = _weights(got["export_path"]), _weights(want["export_path"])
    for name in jw:
        for k in jw[name]:
            np.testing.assert_allclose(pw[name][k], jw[name][k], rtol=0,
                                       atol=2 * 8 * FAST_LR)


def test_finetune_rrdb_family(tmp_path, clip):
    """The 'r'-family (RRDBNet dense blocks, leaky ReLU, interp tail)
    fine-tunes through the graph walk: load -> train -> export -> reload."""
    base = make_synthetic_rrdb_model(scale=4, num_feat=16, num_grow=8,
                                     num_rrdb=1, compute_dtype=torch.float32)
    mdir = str(tmp_path / "models")
    base.save(mdir, stem="4x_tiny_rrdb")
    res = ft.finetune(data=clip, output_dir=str(tmp_path / "out"),
                      model="x_tiny_rrdb", scale=4, model_path=mdir, steps=6,
                      batch=2, patch=8, learning_rate=FAST_LR, seed=0,
                      device="cpu")
    assert res["steps"] == 6 and len(res["losses"]) == 6
    assert res["losses"][-1] < res["losses"][0]
    name = os.path.basename(res["export_path"])
    m2 = load_model(name[1:], 4, "cpu", str(tmp_path / "out"), torch.float32)
    y = m2.forward(torch.zeros(1, 8, 8, 3))
    assert y.shape == (1, 32, 32, 3)


def test_resume_continues_the_uninterrupted_run(tmp_path, clip):
    kw = dict(data=clip, steps=8, batch=2, patch=8, scale=2,
              synthetic_model=True, seed=0, learning_rate=FAST_LR,
              device="cpu")
    whole = ft.finetune(output_dir=str(tmp_path / "whole"), **kw)
    ck = str(tmp_path / "ck")
    first = ft.finetune(output_dir=str(tmp_path / "o1"), ckpt_dir=ck,
                        ckpt_every=2, **{**kw, "steps": 4})
    assert sorted(os.listdir(ck)) == ["step_2", "step_4"]
    res = ft.finetune(output_dir=str(tmp_path / "o2"), ckpt_dir=ck,
                      resume=True, **kw)
    assert res["steps"] == 8 and len(res["losses"]) == 4
    assert first["losses"] + res["losses"] == whole["losses"]
    with open(whole["export_path"] + ".bin", "rb") as f1, \
            open(res["export_path"] + ".bin", "rb") as f2:
        assert f1.read() == f2.read()


def test_finetune_mesh_on_logical_shards(tmp_path):
    kw = dict(data="synthetic", steps=3, batch=2, patch=8, scale=2,
              synthetic_model=True, seed=0, learning_rate=CLI_LR, device="cpu")
    single = ft.finetune(output_dir=str(tmp_path / "s"), **kw)
    mesh = ft.finetune(output_dir=str(tmp_path / "m"), mesh_spec="dp=2,sp=4", **kw)
    assert mesh["steps"] == 3 and len(mesh["losses"]) == 3
    np.testing.assert_allclose(mesh["losses"], single["losses"], rtol=LOSS_RTOL)


def test_cli_main_runs_on_cpu(tmp_path, clip):
    out = tmp_path / "out"
    assert cli_main(["-i", clip, "-o", str(out), "--steps", "2", "--batch",
                     "1", "--patch", "8", "--synthetic_models", "--device",
                     "cpu", "--ckpt_dir", str(tmp_path / "ck"), "--mesh",
                     "dp=1,sp=2"]) == 0
    assert sorted(os.listdir(out)) == ["2x_compact_finetuned.bin",
                                       "2x_compact_finetuned.param"]
    assert os.listdir(tmp_path / "ck") == ["step_2"]


def test_cli_resume_requires_ckpt_dir(tmp_path, capsys):
    with pytest.raises(SystemExit):
        cli_main(["-i", "synthetic", "-o", str(tmp_path), "--resume",
                  "--device", "cpu"])
    assert "--resume requires --ckpt_dir" in capsys.readouterr().err


def test_cli_without_a_gpu_raises(tmp_path):
    """No fallback: the default device is CUDA, and without one the run
    raises before it trains."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli_main(["-i", "synthetic", "-o", str(tmp_path), "--steps", "1",
                  "--synthetic_models"])
    assert not os.listdir(tmp_path)
