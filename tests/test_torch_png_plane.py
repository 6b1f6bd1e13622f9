"""The PNG data plane on the CPU: the port's ``process_file(data_plane=
"png")``, ``extract_only`` and ``ChainEngine.stage_fn`` against the JAX
package on the same seeded clip and byte-identical synthetic weights.

Tolerances, each with its reason:

- f32: within 1 u8 LSB of the JAX package, PARITY.md's contract; the png
  plane rounds to u8 between stages exactly where the JAX plane does.
- bf16 stages: each stage's PSNR against the JAX f32 stage no more than
  0.5 dB under the JAX bf16 stage's own (the band
  tests/test_torch_pipeline.py holds the bf16 step to).
- the port's stream and png planes agree byte for byte in f32, as the
  JAX package's own planes do (tests/test_pipeline.py::test_planes_agree):
  both run the same forward and differ only in the tail's store layout.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from upscale_video_tpu.ops.pixel import psnr
from upscale_video_tpu.pipeline.chain import ChainEngine as JaxEngine
from upscale_video_tpu.pipeline.chain import ChainSpec as JaxSpec
from upscale_video_tpu.pipeline.process import process_file as jax_process
from upscale_video_tpu.video.io import Y4MSink, Y4MSource
from upscale_video_tpu_torch.cli.upscale_video import main as cli_main
from upscale_video_tpu_torch.pipeline.chain import ChainEngine, ChainSpec
from upscale_video_tpu_torch.pipeline.process import process_file
from upscale_video_tpu_torch.video.png import read_png

N_FRAMES, H, W = 5, 12, 16


def _write_clip(path, seed=11):
    """3 frames a minute: ``batch_size=1`` gives fragments of 3 + 2."""
    yy, xx = np.mgrid[0:H, 0:W]
    rng = np.random.default_rng(seed)
    with Y4MSink(path, W, H, "1/20") as s:
        for t in range(N_FRAMES):
            base = np.stack([xx * 9 + t * 5, yy * 13, (xx + yy) * 6], -1)
            s.write(((base + rng.integers(0, 40, (H, W, 3))) % 256).astype(np.uint8))


def _raw(path):
    """(header, frame payloads as uint8) of a y4m file."""
    with open(path, "rb") as f:
        data = f.read()
    header, _, body = data.partition(b"\n")
    chunks = body.split(b"FRAME\n")[1:]
    return header, np.stack([np.frombuffer(c, np.uint8) for c in chunks])


def _max_lsb(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype == np.uint8
    return int(np.abs(a.astype(int) - b.astype(int)).max())


def _frames(seed, n=2, h=H, w=W):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([xx * 11, yy * 7 + 30, (xx * yy) % 200], -1)
    return np.stack([((base + rng.integers(0, 30, (h, w, 3))) % 256)
                     .astype(np.uint8) for _ in range(n)])


def _engines(models, scale, precision="f32", tta=False):
    jd, td = ((jnp.float32, torch.float32) if precision == "f32"
              else (jnp.bfloat16, torch.bfloat16))
    return (JaxEngine.build(JaxSpec.parse(models), scale, compute_dtype=jd,
                            synthetic=True, tta=tta),
            ChainEngine.build(ChainSpec.parse(models), scale, "cpu",
                              compute_dtype=td, synthetic=True, tta=tta))


CHAINS = [(None, 2), ("n=3,a", 2), ("n=3", 1)]


@pytest.fixture(scope="module")
def f32_engines():
    return {c: _engines(*c) for c in CHAINS}


def _run(tmp, name, src, runner, engine, **kw):
    out = str(tmp / f"{name}.y4m")
    work = tmp / f"work_{name}"
    res = runner(src, out, temp_dir=str(work), batch_size=1,
                 resume_processing=True, engine=engine, data_plane="png",
                 scale=engine.scale, **kw)
    return out, res, sorted(os.listdir(work / "upscale_video"))


@pytest.mark.parametrize("chain", CHAINS, ids=["default", "n=3,a", "s1_n=3"])
def test_png_plane_matches_jax_f32(tmp_path, f32_engines, chain):
    """The whole plane: extract, the stage passes (the rename path at
    ``-s 1``), the fragments and the concat, within 1 LSB of JAX."""
    jax_eng, port = f32_engines[chain]
    src = str(tmp_path / "in.y4m")
    _write_clip(src)
    jout, jres, jfiles = _run(tmp_path, "jax", src, jax_process, jax_eng,
                              models=chain[0])
    pout, pres, pfiles = _run(tmp_path, "port", src, process_file, port,
                              models=chain[0], device="cpu")
    assert pres.pipe_pix == jres.pipe_pix == "rgb24"
    assert pres.frames_processed == jres.frames_processed == N_FRAMES
    assert pfiles == jfiles == ["completed.txt", "metadata.json"]
    jh, jframes = _raw(jout)
    ph, pframes = _raw(pout)
    assert ph == jh and pframes.shape == jframes.shape
    assert _max_lsb(pframes, jframes) <= 1


@pytest.mark.parametrize("stage", ["denoise", "anime", "sr"])
def test_stage_fn_matches_jax_f32(f32_engines, stage):
    jax_eng, port = f32_engines[("n=3,a", 2)]
    frames = _frames(20)
    want = np.asarray(jax_eng.stage_fn(stage)(jnp.asarray(frames)))
    got = port.stage_fn(stage)(torch.from_numpy(frames)).numpy()
    assert got.shape == want.shape == ((2, 2 * H, 2 * W, 3) if stage == "sr"
                                       else frames.shape)
    assert _max_lsb(got, want) <= 1


def test_stage_fn_tta_sr_matches_jax_f32():
    """``--tta``: the SR stage averaged over the 8 dihedral transforms."""
    jax_eng, port = _engines(None, 2, tta=True)
    frames = _frames(21, h=12, w=20)
    want = np.asarray(jax_eng.stage_fn("sr")(jnp.asarray(frames)))
    got = port.stage_fn("sr")(torch.from_numpy(frames)).numpy()
    assert _max_lsb(got, want) <= 1


@pytest.mark.parametrize("stage", ["denoise", "anime", "sr"])
def test_stage_fn_bf16_band(f32_engines, stage):
    jax_f32, _ = f32_engines[("n=3,a", 2)]
    jax_bf16, port_bf16 = _engines("n=3,a", 2, precision="bf16")
    frames = _frames(22)
    ref = np.asarray(jax_f32.stage_fn(stage)(jnp.asarray(frames)))
    jb = np.asarray(jax_bf16.stage_fn(stage)(jnp.asarray(frames)))
    pb = port_bf16.stage_fn(stage)(torch.from_numpy(frames)).numpy()
    assert pb.shape == ref.shape
    assert psnr(pb, ref) >= psnr(jb, ref) - 0.5


@pytest.mark.parametrize("models,scale,stage", [
    (None, 2, "denoise"), (None, 2, "anime"), ("n=3", 1, "sr"),
    ("n=3,a", 2, "frames"),
])
def test_stage_fn_errors_equal_jax(f32_engines, models, scale, stage):
    jax_eng, port = f32_engines[(models, scale)]
    with pytest.raises(ValueError) as want:
        jax_eng.stage_fn(stage)
    with pytest.raises(ValueError) as got:
        port.stage_fn(stage)
    assert str(got.value) == str(want.value)


def test_planes_agree_f32(tmp_path, f32_engines):
    """The port's stream plane (shuffle-planar rgb24) and png plane write
    the same bytes."""
    _, port = f32_engines[(None, 2)]
    src = str(tmp_path / "in.y4m")
    _write_clip(src)
    outs = []
    for plane in ("stream", "png"):
        out = str(tmp_path / f"{plane}.y4m")
        process_file(src, out, temp_dir=str(tmp_path / plane), batch_size=1,
                     engine=port, data_plane=plane, pipe_pix="rgb24",
                     device="cpu")
        with open(out, "rb") as f:
            outs.append(f.read())
    assert outs[0] == outs[1]


def test_extract_only_matches_jax(tmp_path):
    src = str(tmp_path / "in.y4m")
    _write_clip(src)
    for name, runner, kw in (("jax", jax_process, {}),
                             ("port", process_file, {"device": "cpu"})):
        assert runner(src, temp_dir=str(tmp_path / name), extract_only=True,
                      resume_processing=True, synthetic_models=True, **kw) is None
    jdir, pdir = (tmp_path / n / "upscale_video" for n in ("jax", "port"))
    names = sorted(os.listdir(pdir))
    assert names == sorted(os.listdir(jdir))
    assert [f"{i}.extract.png" for i in range(1, N_FRAMES + 1)] == \
        sorted(n for n in names if n.endswith(".png"))
    with Y4MSource(src) as s:
        frames = list(s)
    for i in range(1, N_FRAMES + 1):
        got = read_png(str(pdir / f"{i}.extract.png"))
        np.testing.assert_array_equal(got, read_png(str(jdir / f"{i}.extract.png")))
        np.testing.assert_array_equal(got, frames[i - 1])


@pytest.mark.parametrize("flags", [
    ["--data_plane", "png"], ["-m", "n=3", "--data_plane", "png"],
    ["-s", "1", "-m", "a", "--data_plane", "png", "--pipe_pix", "yuv420p"],
])
def test_cli_png_plane_runs_on_cpu(tmp_path, flags):
    src = str(tmp_path / "in.y4m")
    _write_clip(src)
    out = str(tmp_path / "out.y4m")
    assert cli_main(["-i", src, "-o", out, "-t", str(tmp_path / "t"),
                     "--synthetic_models", "--device", "cpu", *flags]) == 0
    scale = 1 if "-s" in flags else 2
    with Y4MSource(out) as s:
        frames = list(s)
        assert s.colorspace.startswith("C444")
    assert len(frames) == N_FRAMES and frames[0].shape == (scale * H, scale * W, 3)


def test_cli_extract_only_runs_on_cpu(tmp_path):
    src = str(tmp_path / "in.y4m")
    _write_clip(src)
    tdir = tmp_path / "t"
    assert cli_main(["-i", src, "-t", str(tdir), "-x", "-r",
                     "--device", "cpu"]) == 0
    work = tdir / "upscale_video"
    assert sorted(os.listdir(work)) == sorted(
        ["metadata.json"] + [f"{i}.extract.png" for i in range(1, N_FRAMES + 1)])
    assert not os.path.exists(str(tmp_path / "in.2x.y4m"))
