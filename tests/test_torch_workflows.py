"""The port's companion workflows and their CLIs on the CPU: split-machine
(``upscale_only`` then ``merge_only``), frame repair (``fix_frames``),
sampling (``process_image``) and ``vsr-compare-torch``, mirroring
tests/test_workflows.py, against the JAX package where both run a model
(f32, within 1 u8 LSB, PARITY.md's contract), and across the two packages:
either package's zips merge on the other to the same frames.
"""

import os
import shutil
import zipfile
from fractions import Fraction

import numpy as np
import pytest

from tests.test_pipeline import make_test_video
from upscale_video_tpu.pipeline import workflows as jax_wf
from upscale_video_tpu.pipeline.process import process_file as jax_process
from upscale_video_tpu_torch.cli import compare as port_compare_cli
from upscale_video_tpu_torch.cli import test_chips as port_chips_cli
from upscale_video_tpu_torch.cli import fix_frames as port_fix_cli
from upscale_video_tpu_torch.cli import merge_only as port_merge_cli
from upscale_video_tpu_torch.cli import test_images as port_images_cli
from upscale_video_tpu_torch.cli import upscale_only as port_upscale_cli
from upscale_video_tpu_torch.pipeline.process import process_file
from upscale_video_tpu_torch.pipeline.workflows import (
    fix_frames, merge_only, process_image, upscale_only,
)
from upscale_video_tpu_torch.video.io import Y4MSink, Y4MSource
from upscale_video_tpu_torch.video.png import read_png
from tests.torch_fixtures import one_torch_thread  # noqa: F401

W, H = 16, 12
CPU = dict(synthetic_models=True, precision="f32", device="cpu")
JAX = dict(synthetic_models=True, precision="f32")


def _video(tmp_path, n_frames=6):
    """A clip at 3 frames a minute: ``-b 1`` gives fragments of 3 frames."""
    vid = str(tmp_path / "in.y4m")
    make_test_video(vid, n_frames=n_frames, w=W, h=H, rate=Fraction(1, 20))
    return vid


def _frames(path):
    with Y4MSource(path) as src:
        return np.stack(list(src))


def _max_lsb(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype == np.uint8
    return int(np.abs(a.astype(int) - b.astype(int)).max())


def _copy_store(src_tdir, dst_tdir):
    shutil.copytree(os.path.join(src_tdir, "upscale_video"),
                    os.path.join(dst_tdir, "upscale_video"))


class TestSplitMachine:
    def test_upscale_then_merge(self, tmp_path):
        """Full split-machine round trip: upscale box -> zips -> encode box."""
        vid = _video(tmp_path)
        tdir = str(tmp_path / "t")

        n = upscale_only(vid, scale=2, temp_dir=tdir, batch_size=1,
                         frames_per_step=4, **CPU)
        assert n == 6
        workdir = os.path.join(tdir, "upscale_video")
        assert os.path.exists(os.path.join(workdir, "upscaled.txt"))
        assert sorted(f for f in os.listdir(workdir) if f.endswith(".zip")) \
            == ["1.zip", "2.zip"]
        with zipfile.ZipFile(os.path.join(workdir, "1.zip")) as zf:
            assert zf.namelist() == ["1.png", "2.png", "3.png"]

        out = merge_only(output_dir=str(tmp_path), temp_dir=tdir)
        assert out is not None and out.endswith(".upscaled.y4m")
        frames = _frames(out)
        assert frames.shape == (6, 2 * H, 2 * W, 3)
        assert os.path.exists(os.path.join(workdir, "merged.txt"))
        # rerun short-circuits on sentinel
        assert merge_only(output_dir=str(tmp_path), temp_dir=tdir) is None

    def test_upscale_only_sentinel(self, tmp_path):
        vid = _video(tmp_path, 3)
        tdir = str(tmp_path / "t")
        assert upscale_only(vid, scale=2, temp_dir=tdir, **CPU) == 3
        assert upscale_only(vid, scale=2, temp_dir=tdir, **CPU) is None

    def test_upscale_dir_handoff(self, tmp_path):
        vid = _video(tmp_path, 3)
        share = str(tmp_path / "share")
        os.makedirs(share)
        upscale_only(vid, scale=2, temp_dir=str(tmp_path / "t"),
                     upscale_dir=share, **CPU)
        assert os.path.exists(os.path.join(share, "1.zip"))
        assert os.path.exists(os.path.join(share, "metadata.json"))

    @pytest.mark.parametrize("models", [None, "n=3,a"])
    def test_round_trip_matches_jax(self, tmp_path, models):
        """Both halves on each package: the merged frames within 1 LSB."""
        vid = _video(tmp_path)
        outs = []
        for name, up, kw in (("jax", jax_wf.upscale_only, JAX),
                             ("port", upscale_only, CPU)):
            tdir = str(tmp_path / name)
            up(vid, scale=2, temp_dir=tdir, batch_size=1, models=models, **kw)
            merge = jax_wf.merge_only if name == "jax" else merge_only
            os.makedirs(tmp_path / f"out_{name}")
            outs.append(_frames(merge(output_dir=str(tmp_path / f"out_{name}"),
                                      temp_dir=tdir)))
        assert _max_lsb(outs[1], outs[0]) <= 1

    @pytest.mark.parametrize("direction", ["jax_zips_port_merge",
                                           "port_zips_jax_merge"])
    def test_zip_handoff_across_packages(self, tmp_path, direction):
        """One package upscales and zips, the other merges: the frames are
        those the upscaling package's own merge writes, byte for byte (the
        merge runs no model; PNGs decode exactly on either side)."""
        vid = _video(tmp_path)
        tdir = str(tmp_path / "t")
        if direction == "jax_zips_port_merge":
            jax_wf.upscale_only(vid, scale=2, temp_dir=tdir, batch_size=1, **JAX)
            own_merge, other_merge = jax_wf.merge_only, merge_only
        else:
            upscale_only(vid, scale=2, temp_dir=tdir, batch_size=1, **CPU)
            own_merge, other_merge = merge_only, jax_wf.merge_only
        _copy_store(tdir, str(tmp_path / "t_own"))
        outs = []
        for name, merge, t in (("own", own_merge, str(tmp_path / "t_own")),
                               ("other", other_merge, tdir)):
            os.makedirs(tmp_path / name)
            outs.append(merge(output_dir=str(tmp_path / name), temp_dir=t))
        with open(outs[0], "rb") as a, open(outs[1], "rb") as b:
            assert a.read() == b.read()
        assert _frames(outs[1]).shape == (6, 2 * H, 2 * W, 3)


class TestFixFrames:
    def test_repair_missing_frames(self, tmp_path):
        vid = _video(tmp_path)
        tdir = str(tmp_path / "t")
        workdir = os.path.join(tdir, "upscale_video")

        process_file(vid, scale=2, temp_dir=tdir, extract_only=True,
                     resume_processing=True, **CPU)
        os.remove(os.path.join(workdir, "2.extract.png"))
        os.remove(os.path.join(workdir, "5.extract.png"))

        assert fix_frames(vid, "2,5", scale=2, temp_dir=tdir, **CPU) == [2, 5]
        for f in (2, 5):
            assert os.path.exists(os.path.join(workdir, f"{f}.png"))
        # frames 1..5 were re-extracted and the unrequested ones pruned (ref
        # fix_frames.py:198-203); the requested ones went into the repair
        names = sorted(os.listdir(workdir))
        assert [n for n in names if n.endswith(".extract.png")] == \
            ["6.extract.png"]

    def test_repair_upscale_stage_only(self, tmp_path):
        """Frames with extract artifacts present are NOT re-extracted."""
        vid = _video(tmp_path, 4)
        tdir = str(tmp_path / "t")
        workdir = os.path.join(tdir, "upscale_video")
        process_file(vid, scale=2, temp_dir=tdir, extract_only=True,
                     resume_processing=True, **CPU)
        marker = os.path.getmtime(os.path.join(workdir, "1.extract.png"))
        fix_frames(vid, "3", scale=2, temp_dir=tdir, **CPU)
        assert os.path.exists(os.path.join(workdir, "3.png"))
        assert os.path.getmtime(os.path.join(workdir, "1.extract.png")) == marker

    @pytest.mark.parametrize("models", [None, "n=3"])
    def test_repair_matches_jax(self, tmp_path, models):
        vid = _video(tmp_path)
        got = {}
        for name, fix, kw in (("jax", jax_wf.fix_frames, JAX),
                              ("port", fix_frames, CPU)):
            tdir = str(tmp_path / name)
            jax_process(vid, scale=2, temp_dir=tdir, extract_only=True,
                        resume_processing=True, synthetic_models=True)
            work = os.path.join(tdir, "upscale_video")
            os.remove(os.path.join(work, "4.extract.png"))
            assert fix(vid, "1,4", scale=2, temp_dir=tdir, models=models,
                       **kw) == [1, 4]
            got[name] = [read_png(os.path.join(work, f"{f}.png")) for f in (1, 4)]
        assert _max_lsb(got["port"], got["jax"]) <= 1


class TestProcessImage:
    def test_sampling(self, tmp_path):
        vid = _video(tmp_path, 4)
        tdir = str(tmp_path / "t")
        outdir = str(tmp_path / "samples")  # not pre-created
        process_file(vid, scale=2, temp_dir=tdir, extract_only=True,
                     resume_processing=True, **CPU)
        outs = process_image("1,3", tdir, outdir, scale=2, models="n=5", **CPU)
        assert len(outs) == 2
        assert os.path.exists(os.path.join(outdir, "1.n=5.png"))
        # intermediates kept for eyeballing (remove=False semantics)
        assert os.path.exists(os.path.join(outdir, "1.extract.png"))
        assert os.path.exists(os.path.join(outdir, "1.denoise.png"))

    @pytest.mark.parametrize("models,scale", [("n=5,a", 2), ("a", 1)])
    def test_sampling_matches_jax(self, tmp_path, models, scale):
        vid = _video(tmp_path, 4)
        tdir = str(tmp_path / "t")
        jax_process(vid, scale=2, temp_dir=tdir, extract_only=True,
                    resume_processing=True, synthetic_models=True)
        got = {}
        for name, sample, kw in (("jax", jax_wf.process_image, JAX),
                                 ("port", process_image, CPU)):
            outdir = str(tmp_path / name)
            outs = sample("2,3", tdir, outdir, scale=scale, models=models, **kw)
            assert [os.path.basename(p) for p in outs] == \
                [f"{f}.{models.replace(',', '.')}.png" for f in (2, 3)]
            got[name] = [read_png(p) for p in outs]
            assert sorted(os.listdir(outdir)) == sorted(
                os.listdir(str(tmp_path / "jax")))
        assert _max_lsb(got["port"], got["jax"]) <= 1


class TestMergeOnlyCrashResume:
    def test_resume_after_last_encode_before_concat(self, tmp_path):
        """Crash window between the final fragment encode and concat: the
        rerun sees (fragment_frames.txt) that every frame is encoded and
        goes straight to concat, instead of dying on 'no more png files
        found'."""
        vid = _video(tmp_path)
        tdir = str(tmp_path / "t")
        upscale_only(vid, scale=2, temp_dir=tdir, batch_size=1, **CPU)
        workdir = os.path.join(tdir, "upscale_video")

        out = merge_only(output_dir=str(tmp_path), temp_dir=tdir)
        assert out is not None
        os.remove(os.path.join(workdir, "merged.txt"))
        with open(os.path.join(workdir, "fragment_frames.txt")) as f:
            ends = [int(line.split()[1]) for line in f.read().splitlines()]
        assert ends == [3, 6]
        frames = _frames(out)
        os.remove(out)
        start = 0
        for b, end in enumerate(ends, start=1):
            with Y4MSink(os.path.join(workdir, f"{b}.y4m"), 2 * W, 2 * H,
                         Fraction(24, 1)) as sink:
                for f in frames[start:end]:
                    sink.write(f)
            start = end

        out2 = merge_only(output_dir=str(tmp_path), temp_dir=tdir)
        assert out2 is not None
        # the fragments were rewritten through Y4M's YCbCr: 1 LSB of
        # RGB -> YCbCr -> RGB rounding
        assert _max_lsb(_frames(out2), frames) <= 1


# --- the CLIs ----------------------------------------------------------------

CLI_PAIRS = [
    ("upscale_only", port_upscale_cli),
    ("merge_only", port_merge_cli),
    ("fix_frames", port_fix_cli),
    ("test_images", port_images_cli),
    ("compare", port_compare_cli),
    ("test_chips", port_chips_cli),
]


def _parser_spec(parser):
    return {a.dest: (tuple(a.option_strings), a.default,
                     tuple(a.choices) if a.choices else None, a.required,
                     a.nargs, a.const, getattr(a.type, "__name__", a.type))
            for a in parser._actions if a.dest != "device"}


@pytest.mark.parametrize("name,port_mod", CLI_PAIRS, ids=[n for n, _ in CLI_PAIRS])
def test_cli_parser_equals_jax(name, port_mod):
    """Flags, defaults and choices equal the JAX CLI's, but for the port's
    ``--device`` (default cuda) on each CLI that runs a model."""
    import importlib

    jax_mod = importlib.import_module(f"upscale_video_tpu.cli.{name}")
    got, want = port_mod.build_parser(), jax_mod.build_parser()
    assert _parser_spec(got) == _parser_spec(want)
    runs_a_model = name in ("upscale_only", "fix_frames", "test_images",
                            "test_chips")
    devices = [a for a in got._actions if a.dest == "device"]
    assert [a.default for a in devices] == (["cuda"] if runs_a_model else [])


def test_cli_split_machine_fix_sample_compare(tmp_path, capsys):
    """Each new CLI end to end on the CPU: upscale-only-torch and
    merge-only-torch, upscale-video-torch -x then fix-frames-torch and
    test-images-torch, vsr-compare-torch of the merge against itself."""
    vid = _video(tmp_path, 4)
    tdir = str(tmp_path / "t")
    assert port_upscale_cli.main(["-i", vid, "-t", tdir, "-b", "1",
                                  "--synthetic_models", "--device", "cpu"]) == 0
    assert port_merge_cli.main(["-o", str(tmp_path), "-t", tdir]) == 0
    merged = str(tmp_path / "in.upscaled.y4m")
    assert _frames(merged).shape == (4, 2 * H, 2 * W, 3)

    xdir = str(tmp_path / "x")
    from upscale_video_tpu_torch.cli.upscale_video import main as video_main

    assert video_main(["-i", vid, "-t", xdir, "-x", "-r", "--device", "cpu"]) == 0
    samples = str(tmp_path / "samples")
    assert port_images_cli.main(["-i", "1,3", "-t", xdir, "-o", samples,
                                 "-m", "n=3", "--synthetic_models",
                                 "--device", "cpu"]) == 0
    assert sorted(os.listdir(samples)) == [
        "1.denoise.png", "1.extract.png", "1.n=3.png",
        "3.denoise.png", "3.extract.png", "3.n=3.png"]
    work = os.path.join(xdir, "upscale_video")
    os.remove(os.path.join(work, "2.extract.png"))
    assert port_fix_cli.main(["-i", vid, "-b", "2", "-t", xdir,
                              "--synthetic_models", "--device", "cpu"]) == 0
    assert read_png(os.path.join(work, "2.png")).shape == (2 * H, 2 * W, 3)

    capsys.readouterr()
    assert port_compare_cli.main(["-a", merged, "-b", merged, "--json"]) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert '"frames": 4' in line and '"identical": true' in line


MODEL_CLIS = [
    (port_upscale_cli, ["-i", "in.y4m"]),
    (port_fix_cli, ["-i", "in.y4m", "-b", "1"]),
    (port_images_cli, ["-i", "1", "-o", "out"]),
]


@pytest.mark.parametrize("flags", [
    ["-g", "0,1"], ["--parallel", "sp"], ["--parallel", "tp"],
])
@pytest.mark.parametrize("cli,argv", MODEL_CLIS,
                         ids=["upscale_only", "fix_frames", "test_images"])
def test_cli_flags_outside_the_port_raise(tmp_path, cli, argv, flags):
    """The flags the port's main CLI refuses, refused by check_slice before
    any work (no file is read or written)."""
    if "--device" not in flags:
        flags = flags + ["--device", "cpu"]
    with pytest.raises(NotImplementedError):
        cli.main(argv + ["-t", str(tmp_path / "t")] + flags)
    assert not os.path.exists(tmp_path / "t")


@pytest.mark.parametrize("flags", [
    ["--conv_impl", "pallas"], ["--conv_impl", "xla"],
    ["--precision", "f32", "--device", "cuda"], ["--tile_size", "480"],
    ["--precision", "mixed"],
])
@pytest.mark.parametrize("cli,argv", MODEL_CLIS,
                         ids=["upscale_only", "fix_frames", "test_images"])
def test_cli_ported_flags_pass_the_slice_check(cli, argv, flags):
    """What check_slice refused before, each model-running CLI now takes."""
    from upscale_video_tpu_torch.cli.upscale_video import check_slice

    check_slice(cli.build_parser().parse_args(argv + flags))


def test_workflows_take_conv_impl_and_tiles(tmp_path):
    """``upscale-only-torch --conv_impl xla --tile_size 8 --precision
    mixed`` on the CPU, then ``merge-only-torch``: every frame, 2x."""
    vid = _video(tmp_path, 3)
    tdir = str(tmp_path / "t")
    assert port_upscale_cli.main([
        "-i", vid, "-t", tdir, "-b", "1", "--synthetic_models", "--device",
        "cpu", "--conv_impl", "xla", "--tile_size", "8",
        "--precision", "mixed"]) == 0
    assert port_merge_cli.main(["-o", str(tmp_path), "-t", tdir]) == 0
    assert _frames(str(tmp_path / "in.upscaled.y4m")).shape == (3, 2 * H, 2 * W, 3)


def test_compare_cli_min_psnr_gate(tmp_path):
    """``--min_psnr`` fails the run when a frame falls below it."""
    a = str(tmp_path / "a.y4m")
    b = str(tmp_path / "b.y4m")
    make_test_video(a, n_frames=2, w=W, h=H, seed=0)
    make_test_video(b, n_frames=2, w=W, h=H, seed=1)
    assert port_compare_cli.main(["-a", a, "-b", b, "--min_psnr", "60"]) == 1
    assert port_compare_cli.main(["-a", a, "-b", a, "--min_psnr", "60"]) == 0
