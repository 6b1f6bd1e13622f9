"""The resume sweep: a run of the port killed at a seeded point, then
resumed with ``resume_processing=True``, writes the same bytes as a run
that was never killed, and leaves no partial fragment to be trusted.

Contracts: the stream plane's shuffle-planar rgb24 (the default chain),
its full-frame rgb24 (``--tta``), its 4:2:0 contract (a C420jpeg source,
I420 in), and the png plane (``-m n=3``: extraction, the denoise and SR
stage passes, the fragment encodes; at ``-s 1`` the denoise pass and the
rename of its artifacts to the final frames).  A kill is an exception raised at the
k-th write of a fragment frame (before it) or of a stage PNG (after it,
before the pass removes its input); each seed draws two kill points, each
in the run that resumes the one before.  A PNG is never seen half written
(tests/test_torch_png.py::test_write_png_is_atomic).
"""

import os
from fractions import Fraction

import numpy as np
import pytest
import torch

from upscale_video_tpu_torch.pipeline import stages
from upscale_video_tpu_torch.pipeline.chain import ChainEngine, ChainSpec
from upscale_video_tpu_torch.pipeline.process import process_file
from upscale_video_tpu_torch.video.io import Y4MSink, Y4MSource
from upscale_video_tpu_torch.ops.yuv import packed_to_i420, yuv420_from_frames
from tests.torch_fixtures import one_torch_thread  # noqa: F401

N_FRAMES, H, W = 7, 12, 16
RATE = Fraction(1, 20)  # 3 frames a minute: -b 1 gives fragments 3, 3, 1
FRAGMENTS = [3, 3, 1]

# name -> (models, scale, tta, process_file keywords, C420jpeg source)
CONTRACTS = {
    "stream_rgb24_planar": (None, 2, False, dict(pipe_pix="rgb24"), False),
    "stream_rgb24_full_frame": (None, 2, True, dict(pipe_pix="rgb24"), False),
    "stream_yuv420p": (None, 2, False, dict(pipe_pix="yuv420p"), True),
    "png": ("n=3", 2, False, dict(data_plane="png"), False),
    "png_scale1": ("n=3", 1, False, dict(data_plane="png"), False),
}
# the writes a run makes: each fragment frame, and on the png plane each
# frame's extract, denoise and (at 2x) SR PNG
WRITES = {"png": 4 * N_FRAMES, "png_scale1": 3 * N_FRAMES}


class Killed(Exception):
    """The simulated crash."""


class KillPoints:
    """Counts fragment-frame and stage-PNG writes; raises at the k-th."""

    def __init__(self, k=None):
        self.k, self.n = k, 0

    def __call__(self):
        self.n += 1
        return self.k is not None and self.n == self.k


@pytest.fixture
def hooked(monkeypatch):
    """Install a KillPoints on the fragment sink's and the stage passes'
    writes; returns a setter for the current one."""
    state = {"kp": KillPoints()}
    sink_write, png_write = Y4MSink.write, stages.write_png

    def write(self, frame):
        if state["kp"]():
            raise Killed("killed in a fragment write")
        sink_write(self, frame)

    def write_png(path, frame):
        png_write(path, frame)
        if state["kp"]():  # after the write, before the input's removal
            raise Killed(f"killed after writing {os.path.basename(path)}")

    monkeypatch.setattr(Y4MSink, "write", write)
    monkeypatch.setattr(stages, "write_png", write_png)

    def use(kp):
        state["kp"] = kp
        return kp
    return use


def _write_clip(path, c420):
    rng = np.random.default_rng(5)
    yy, xx = np.mgrid[0:H, 0:W]
    frames = np.stack([((np.stack([xx * 9 + t * 7, yy * 13, (xx + yy) * 5], -1)
                         + rng.integers(0, 40, (H, W, 3))) % 256).astype(np.uint8)
                       for t in range(N_FRAMES)])
    with Y4MSink(path, W, H, RATE, colorspace="C420jpeg" if c420 else "C444") as s:
        for f in frames:
            s.write(packed_to_i420(yuv420_from_frames(torch.from_numpy(f[None]),
                                                      True)[0].numpy(), 2)
                    if c420 else f)


@pytest.fixture(scope="module")
def engines():
    built = {}
    for name, (models, scale, tta, _, _) in CONTRACTS.items():
        built[name] = ChainEngine.build(ChainSpec.parse(models), scale, "cpu",
                                        compute_dtype=torch.float32,
                                        synthetic=True, tta=tta)
    return built


def _run(src, out, tdir, engine, name, resume):
    models, scale, _, kw, _ = CONTRACTS[name]
    return process_file(src, out, temp_dir=tdir, batch_size=1, models=models,
                        scale=scale,
                        resume_processing=resume, frames_per_step=2,
                        engine=engine, device="cpu", **kw)


def _frames_in(path):
    with Y4MSource(path) as s:
        return sum(1 for _ in s)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("name", list(CONTRACTS))
def test_killed_run_resumes_to_the_same_bytes(tmp_path, engines, hooked,
                                              name, seed):
    src = str(tmp_path / "in.y4m")
    _write_clip(src, CONTRACTS[name][4])
    ref_out = str(tmp_path / "ref.y4m")
    counter = hooked(KillPoints())
    res = _run(src, ref_out, str(tmp_path / "ref"), engines[name], name, False)
    assert res.frames_processed == N_FRAMES
    total = counter.n
    assert total == WRITES.get(name, N_FRAMES)
    with open(ref_out, "rb") as f:
        want = f.read()

    rng = np.random.default_rng(seed)
    out = str(tmp_path / "out.y4m")
    tdir = str(tmp_path / "t")
    work = os.path.join(tdir, "upscale_video")
    resume = False
    for _ in range(2):
        kp = hooked(KillPoints(int(rng.integers(1, total + 1))))
        try:
            _run(src, out, tdir, engines[name], name, resume)
        except Exception as e:  # the png plane wraps a failed encode
            assert isinstance(e, Killed) or isinstance(e.__cause__, Killed), e
        else:
            assert kp.n < kp.k  # the resumed run had fewer writes left
            break
        resume = True
        assert not os.path.exists(out)
        for b, n in enumerate(FRAGMENTS, start=1):
            frag = os.path.join(work, f"{b}.y4m")
            if os.path.exists(frag):  # only whole fragments survive a kill
                assert _frames_in(frag) == n, (b, sorted(os.listdir(work)))

    hooked(KillPoints())
    _run(src, out, tdir, engines[name], name, True)
    with open(out, "rb") as f:
        assert f.read() == want
    assert sorted(os.listdir(work)) == ["completed.txt", "metadata.json"]


class HardKill(BaseException):
    """A kill that no ``except Exception`` sees, as SIGKILL or a power loss
    leaves a run: nothing cleans up after it."""


@pytest.mark.parametrize("name", ["stream_rgb24_planar", "stream_yuv420p", "png"])
def test_hard_kill_leaves_no_partial_fragment(tmp_path, engines, monkeypatch,
                                              name):
    """Killed mid-fragment (the second frame of fragment 2), a run leaves
    fragment 1 whole and nothing under fragment 2's name (it was being
    written beside it), so the resumed run redoes fragment 2 and writes the
    uninterrupted run's bytes.  A fragment written in place would be left
    holding one frame, and resume would skip it."""
    src = str(tmp_path / "in.y4m")
    _write_clip(src, CONTRACTS[name][4])
    ref_out = str(tmp_path / "ref.y4m")
    _run(src, ref_out, str(tmp_path / "ref"), engines[name], name, False)
    with open(ref_out, "rb") as f:
        want = f.read()

    sink_write, writes = Y4MSink.write, {"n": 0}

    def write(self, frame):
        writes["n"] += 1
        if writes["n"] == FRAGMENTS[0] + 2:
            raise HardKill("killed in fragment 2")
        sink_write(self, frame)

    monkeypatch.setattr(Y4MSink, "write", write)
    out, tdir = str(tmp_path / "out.y4m"), str(tmp_path / "t")
    with pytest.raises(HardKill):
        _run(src, out, tdir, engines[name], name, False)
    work = os.path.join(tdir, "upscale_video")
    assert _frames_in(os.path.join(work, "1.y4m")) == FRAGMENTS[0]
    assert not os.path.exists(os.path.join(work, "2.y4m"))
    monkeypatch.setattr(Y4MSink, "write", sink_write)
    _run(src, out, tdir, engines[name], name, True)
    with open(out, "rb") as f:
        assert f.read() == want
    assert sorted(os.listdir(work)) == ["completed.txt", "metadata.json"]


def test_resume_skips_a_whole_jax_fragment(tmp_path, engines, monkeypatch):
    """A temp dir a JAX run left (killed at fragment 2's first frame; its
    cleanup removed that fragment) is resumed by the port: the JAX-made
    fragment 1 is skipped, not rewritten, and its bytes open the output."""
    import jax.numpy as jnp
    from upscale_video_tpu.pipeline.chain import ChainEngine as JaxEngine
    from upscale_video_tpu.pipeline.chain import ChainSpec as JaxSpec
    from upscale_video_tpu.pipeline.process import process_file as jax_process
    from upscale_video_tpu.video import io as jax_io

    src = str(tmp_path / "in.y4m")
    _write_clip(src, False)
    jax_write, writes = jax_io.Y4MSink.write, {"n": 0}

    def killed(self, frame):
        writes["n"] += 1
        if writes["n"] == FRAGMENTS[0] + 1:
            raise Killed("killed in fragment 2")
        jax_write(self, frame)

    monkeypatch.setattr(jax_io.Y4MSink, "write", killed)
    jeng = JaxEngine.build(JaxSpec(), 2, compute_dtype=jnp.float32,
                           synthetic=True)
    out, tdir = str(tmp_path / "out.y4m"), str(tmp_path / "t")
    with pytest.raises(Killed):
        jax_process(src, out, temp_dir=tdir, batch_size=1, frames_per_step=2,
                    engine=jeng, pipe_pix="rgb24")
    work = os.path.join(tdir, "upscale_video")
    assert sorted(os.listdir(work)) == ["1.y4m", "metadata.json"]
    with open(os.path.join(work, "1.y4m"), "rb") as f:
        jax_fragment = f.read()

    port_write, port_writes = Y4MSink.write, {"n": 0}

    def counted(self, frame):
        port_writes["n"] += 1
        port_write(self, frame)

    monkeypatch.setattr(Y4MSink, "write", counted)
    _run(src, out, tdir, engines["stream_rgb24_planar"], "stream_rgb24_planar",
         True)
    assert port_writes["n"] == N_FRAMES - FRAGMENTS[0]
    with open(out, "rb") as f:
        got = f.read()
    assert got.startswith(jax_fragment) and len(got) > len(jax_fragment)
    with Y4MSource(out) as s:
        assert sum(1 for _ in s) == N_FRAMES
