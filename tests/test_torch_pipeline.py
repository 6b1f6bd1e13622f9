"""End to end on the CPU: the port's ``process_file`` (device="cpu",
synthetic models) against the JAX ``process_file`` on tiny hermetic Y4M
clips — a C444 source (the shuffle-planar rgb24 contract) and a C420jpeg
source (the 4:2:0 contract with I420 input).

Both run in f32 so the comparison is exact to 1 LSB per stored byte; the
port's bf16 run is held to the JAX bf16 run's own PSNR against JAX f32
(no more than 0.5 dB below it).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from upscale_video_tpu.ops.pixel import psnr
from upscale_video_tpu.ops.yuv import packed_to_i420, yuv420_from_frames
from upscale_video_tpu.pipeline.chain import ChainEngine as JaxEngine
from upscale_video_tpu.pipeline.chain import ChainSpec as JaxSpec
from upscale_video_tpu.pipeline.process import process_file as jax_process
from upscale_video_tpu.video.io import Y4MSink, Y4MSource
from upscale_video_tpu_torch.cli.upscale_video import main as cli_main
from upscale_video_tpu_torch.pipeline.chain import ChainEngine, ChainSpec
from upscale_video_tpu_torch.pipeline.process import process_file

N_FRAMES, H, W = 5, 12, 16


def _write_clip(path, c420):
    frames = np.random.default_rng(11).integers(
        0, 256, (N_FRAMES, H, W, 3), dtype=np.uint8)
    if c420:
        packed = np.asarray(yuv420_from_frames(jnp.asarray(frames), True))
        with Y4MSink(path, W, H, "24/1", colorspace="C420jpeg") as s:
            for p in packed:
                s.write(packed_to_i420(p, 2))
    else:
        with Y4MSink(path, W, H, "24/1") as s:
            for f in frames:
                s.write(f)


def _raw(path):
    """(header, frame payloads as uint8) of a y4m file."""
    with open(path, "rb") as f:
        data = f.read()
    header, _, body = data.partition(b"\n")
    chunks = body.split(b"FRAME\n")[1:]
    return header, np.stack([np.frombuffer(c, np.uint8) for c in chunks])


def _rgb(path):
    with Y4MSource(path) as src:
        return np.stack(list(src))


@pytest.fixture(scope="module")
def jax_engines():
    return {p: JaxEngine.build(JaxSpec(), 2, compute_dtype=dt, synthetic=True)
            for p, dt in (("f32", jnp.float32), ("bf16", jnp.bfloat16))}


@pytest.fixture(scope="module")
def port_engines():
    return {p: ChainEngine.build(ChainSpec(), 2, "cpu", compute_dtype=dt,
                                 synthetic=True)
            for p, dt in (("f32", torch.float32), ("bf16", torch.bfloat16))}


def _run(tmp, name, src, runner, engine, **kw):
    out = str(tmp / f"{name}.y4m")
    work = tmp / f"work_{name}"
    res = runner(src, out, temp_dir=str(work), batch_size=-2,
                 resume_processing=True, engine=engine, **kw)
    return out, res, sorted(os.listdir(work / "upscale_video"))


@pytest.mark.parametrize("c420", [False, True], ids=["c444", "c420jpeg"])
def test_port_matches_jax_f32(tmp_path, jax_engines, port_engines, c420):
    src = str(tmp_path / "in.y4m")
    _write_clip(src, c420)
    jout, jres, jfiles = _run(tmp_path, "jax", src, jax_process,
                              jax_engines["f32"])
    pout, pres, pfiles = _run(tmp_path, "port", src, process_file,
                              port_engines["f32"], device="cpu")
    assert pres.pipe_pix == jres.pipe_pix == ("yuv420p" if c420 else "rgb24")
    assert pres.frames_processed == jres.frames_processed == N_FRAMES
    assert pfiles == jfiles and "completed.txt" in pfiles \
        and "metadata.json" in pfiles
    jh, jframes = _raw(jout)
    ph, pframes = _raw(pout)
    assert ph == jh and pframes.shape == jframes.shape
    assert np.abs(pframes.astype(int) - jframes.astype(int)).max() <= 1


def test_port_bf16_psnr_band(tmp_path, jax_engines, port_engines):
    src = str(tmp_path / "in.y4m")
    _write_clip(src, c420=False)
    ref = _rgb(_run(tmp_path, "jf32", src, jax_process, jax_engines["f32"])[0])
    jb = _rgb(_run(tmp_path, "jbf16", src, jax_process, jax_engines["bf16"])[0])
    pb = _rgb(_run(tmp_path, "pbf16", src, process_file,
                   port_engines["bf16"], device="cpu")[0])
    assert pb.shape == ref.shape == (N_FRAMES, 2 * H, 2 * W, 3)
    assert psnr(pb, ref) >= psnr(jb, ref) - 0.5


def test_cli_runs_on_cpu(tmp_path):
    src = str(tmp_path / "in.y4m")
    _write_clip(src, c420=False)
    out = str(tmp_path / "out.y4m")
    assert cli_main(["-i", src, "-o", out, "-t", str(tmp_path / "t"),
                     "--synthetic_models", "--device", "cpu"]) == 0
    frames = _rgb(out)
    assert frames.shape == (N_FRAMES, 2 * H, 2 * W, 3)


@pytest.mark.parametrize("flags", [
    ["-m", "n=3", "--data_plane", "png"],
    ["-m", "a,sr=x_Foo", "--precision", "mixed"],
    ["--tta", "--tile_size", "480"], ["--tile_size", "480"],
    ["--conv_impl", "pallas"], ["-g", "0,1"], ["--parallel", "sp"],
    ["--trace_dir", "tr"], ["--data_plane", "png"], ["-x"],
    ["--precision", "mixed"], ["--precision", "f32", "--device", "cuda"],
    ["-m", "r,a", "--conv_impl", "xla"], ["-m", "sr=x_Foo", "--conv_impl", "xla"],
    ["-m", "a,n=3", "--precision", "mixed"],
    ["-m", "r", "--conv_impl", "xla"], ["--conv_impl", "rdb"],
    ["-m", "r", "--precision", "f32", "--device", "cuda"],
])
def test_cli_flags_outside_the_slice_raise(tmp_path, flags):
    src = str(tmp_path / "in.y4m")
    _write_clip(src, c420=False)
    argv = ["-i", src, "-t", str(tmp_path / "t"), "--synthetic_models"]
    if "--device" not in flags:
        argv += ["--device", "cpu"]
    with pytest.raises(NotImplementedError):
        cli_main(argv + flags)
