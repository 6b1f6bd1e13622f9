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
from tests.torch_fixtures import one_torch_thread, two_rrdbs  # noqa: F401

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
    ["-g", "0,1"], ["-g", "0,0,1"], ["--parallel", "sp"], ["--parallel", "tp"],
])
def test_cli_flags_outside_the_slice_raise(tmp_path, flags):
    """More than one GPU and ``--parallel sp|tp`` are all that the port
    refuses, before any work."""
    src = str(tmp_path / "in.y4m")
    _write_clip(src, c420=False)
    argv = ["-i", src, "-t", str(tmp_path / "t"), "--synthetic_models"]
    if "--device" not in flags:
        argv += ["--device", "cpu"]
    with pytest.raises(NotImplementedError):
        cli_main(argv + flags)
    assert not os.path.exists(tmp_path / "t")


@pytest.mark.parametrize("flags,scale", [
    (["-m", "a,sr=x_Foo", "--precision", "mixed"], 2),
    (["--tta", "--tile_size", "480"], 2), (["--tile_size", "8"], 2),
    (["--tile_size", "8x12", "--pipe_pix", "yuv420p"], 2),
    (["--conv_impl", "pallas"], 2), (["--trace_dir", "tr"], 2),
    (["--precision", "mixed"], 2), (["--precision", "f32"], 2),
    (["-m", "r,a", "--conv_impl", "xla"], 4),
    (["-m", "sr=x_Foo", "--conv_impl", "xla"], 2),
    (["-m", "a,n=3", "--precision", "mixed"], 2),
    (["-m", "r", "--conv_impl", "pallas"], 4), (["--conv_impl", "rdb"], 2),
    (["-m", "r", "--precision", "f32"], 4),
])
def test_cli_ported_flags_run(tmp_path, two_rrdbs, flags, scale):
    """Each flag the port once refused runs end to end on the CPU: every
    frame, at the chain's scale (``-m r`` at 2 RRDBs)."""
    src = str(tmp_path / "in.y4m")
    _write_clip(src, c420="yuv420p" in flags)
    out = str(tmp_path / "out.y4m")
    flags = [str(tmp_path / f) if f == "tr" else f for f in flags]
    assert cli_main(["-i", src, "-o", out, "-t", str(tmp_path / "t"),
                     "--synthetic_models", "--device", "cpu", *flags]) == 0
    with Y4MSource(out) as o:
        assert (o.width, o.height) == (scale * W, scale * H)
        assert sum(1 for _ in o) == N_FRAMES
    if "--trace_dir" in flags:
        assert os.listdir(tmp_path / "tr")


@pytest.mark.parametrize("flags", [
    ["--precision", "f32"], ["-m", "r", "--precision", "f32"],
    ["--conv_impl", "xla"],
])
def test_cli_cuda_runs_pass_the_slice_check(tmp_path, flags):
    """f32 and the routes on CUDA pass ``check_slice``; on a host without a
    GPU the run then fails on the device, not on the flag."""
    from upscale_video_tpu_torch.cli.upscale_video import build_parser, check_slice

    src = str(tmp_path / "in.y4m")
    _write_clip(src, c420=False)
    argv = ["-i", src, "-t", str(tmp_path / "t"), "--synthetic_models",
            "--device", "cuda", *flags]
    check_slice(build_parser().parse_args(argv))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli_main(argv)
