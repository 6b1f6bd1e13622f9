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
