"""Host-side guarantees of the port: its copies of jax-free host modules
equal the JAX package's originals, it imports and runs without jax and
without the JAX package, and its CUDA entries never quietly compute on the
CPU."""

import io
import os
import re
import subprocess
import sys
import textwrap
import tokenize
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from upscale_video_tpu.models import bin_loader as jax_bin
from upscale_video_tpu.models import param_parser as jax_pp
from upscale_video_tpu.models.zoo import make_rrdb_graph as jax_rrdb_graph
from upscale_video_tpu.models.zoo import make_srvgg_graph as jax_graph
from upscale_video_tpu.ops.yuv import packed_to_i420 as jax_packed_to_i420
from upscale_video_tpu.ops.yuv import yuv420_from_frames as jax_yuv_frames
from upscale_video_tpu.pipeline.chain import ChainSpec as JaxSpec
from upscale_video_tpu_torch import resolve_device
from upscale_video_tpu_torch.kernels import build
from upscale_video_tpu_torch.models import bin_loader, param_parser
from upscale_video_tpu_torch.models.zoo import (
    make_rrdb_graph, make_srvgg_graph, params_from_jax,
)
from upscale_video_tpu_torch.ops.conv_chain import (
    conv3x3_chain, launch_chain_layer, make_layer,
)
from upscale_video_tpu_torch.ops.tail import sr_tail_chain
from upscale_video_tpu_torch.ops.yuv import packed_to_i420, yuv420_from_frames
from upscale_video_tpu_torch.pipeline.chain import ChainSpec
from tests.torch_fixtures import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parent.parent


def _layers(g):
    return [(l.type, l.name, l.inputs, l.outputs, l.attrs) for l in g.layers]


@pytest.mark.parametrize("kw", [dict(), dict(scale=4, num_conv=3, num_feat=24),
                                dict(scale=1, num_conv=8, num_feat=24)])
def test_srvgg_graph_equals_jax(kw):
    assert _layers(make_srvgg_graph(**kw)) == _layers(jax_graph(**kw))


@pytest.mark.parametrize("kw", [
    dict(), dict(num_rrdb=23), dict(num_rrdb=1, scale=2),
    dict(num_rrdb=1, variant="esrgan"),
    dict(num_rrdb=3, num_feat=32, num_grow=16),
])
def test_rrdb_graph_equals_jax(kw):
    assert _layers(make_rrdb_graph(**kw)) == _layers(jax_rrdb_graph(**kw))


def test_params_from_jax_carries_rrdb_convs():
    """Every conv of the Valar graph crosses over: the bias-less 1x1 skips
    as (64, 32) matrices with zero bias, conv_last 64 -> 3 as (576, 3)."""
    g = jax_rrdb_graph(num_rrdb=1)
    params = jax_bin.synthesize_weights(g, seed=2)
    state = params_from_jax(params, "cpu", torch.float32)
    convs = [l.name for l in g.layers if l.type == "Convolution"]
    assert sorted(state.keys()) == sorted(convs)
    for name in convs:
        w = params[name]["weight"]
        np.testing.assert_array_equal(state[name].wmat.numpy(),
                                      w.reshape(-1, w.shape[-1]))
        b = params[name].get("bias", np.zeros(w.shape[-1], np.float32))
        np.testing.assert_array_equal(state[name].bias.numpy(), b)
    assert tuple(state["r0d0_c6"].wmat.shape) == (64, 32)
    assert "bias" not in params["r0d0_c6"]
    assert tuple(state["conv_last"].wmat.shape) == (576, 3)


def test_param_round_trip_equals_jax():
    text = jax_pp.emit_param(jax_graph(scale=2, num_conv=2, num_feat=8))
    assert param_parser.emit_param(param_parser.parse_param(text)) == text
    assert _layers(param_parser.parse_param(text)) == \
        _layers(jax_pp.parse_param(text))


@pytest.mark.parametrize("seed", [0, 3])
def test_synthesize_weights_byte_identical(seed):
    g = jax_graph(scale=2, num_conv=3, num_feat=16)
    want = jax_bin.synthesize_weights(g, seed=seed)
    got = bin_loader.synthesize_weights(param_parser.parse_param(
        jax_pp.emit_param(g)), seed=seed)
    assert got.keys() == want.keys()
    for name in want:
        assert got[name].keys() == want[name].keys()
        for k in want[name]:
            assert got[name][k].tobytes() == want[name][k].tobytes()


def test_load_weights_equals_jax():
    g = jax_graph(scale=2, num_conv=1, num_feat=8)
    blob = jax_bin.emit_bin(g, jax_bin.synthesize_weights(g, seed=1))
    want = jax_bin.load_weights(g, blob)
    got = bin_loader.load_weights(g, blob)
    for name in want:
        for k in want[name]:
            np.testing.assert_array_equal(got[name][k], want[name][k])


@pytest.mark.parametrize("text", [None, "", "a", "n=3,r", "n=99", "n=0,a",
                                  "sr=x_Foo"])
def test_chainspec_parse_equals_jax(text):
    got, want = ChainSpec.parse(text), JaxSpec.parse(text)
    assert (got.anime, got.denoise, got.real_life, got.sr_file) == \
        (want.anime, want.denoise, want.real_life, want.sr_file)
    assert got.stage_names() == want.stage_names()


@pytest.mark.parametrize("text", [None, "r", "a,n=3"])
def test_chain_policies_equal_jax(text):
    from upscale_video_tpu.pipeline import chain as jchain
    from upscale_video_tpu_torch.pipeline import chain as pchain

    got, want = pchain.ChainSpec.parse(text), jchain.ChainSpec.parse(text)
    assert pchain.default_tile(got) == jchain.default_tile(want)
    assert pchain.default_frames_per_step(got) == \
        jchain.default_frames_per_step(want)
    for prec in ("auto", "bf16", "mixed", "f32"):
        pc, pr = pchain.precision_dtypes(prec, got)
        jc, jr = jchain.precision_dtypes(prec, want)
        assert str(pc) == f"torch.{jnp.dtype(jc).name}"
        assert (pr is None and jr is None) or \
            str(pr) == f"torch.{jnp.dtype(jr).name}"


def test_packed_to_i420_equals_jax():
    f = np.random.default_rng(2).integers(0, 256, (1, 8, 12, 3), dtype=np.uint8)
    want_packed = np.asarray(jax_yuv_frames(jnp.asarray(f), True))
    got_packed = yuv420_from_frames(torch.from_numpy(f), True).numpy()
    np.testing.assert_array_equal(got_packed, want_packed)
    np.testing.assert_array_equal(packed_to_i420(got_packed[0], 2),
                                  jax_packed_to_i420(want_packed[0], 2))


def test_imports_and_runs_without_jax(tmp_path):
    """With jax made unimportable, the port's package, pipeline and CLI
    import, an engine builds on the CPU and steps a batch, and no kernel
    library was built or loaded on the way."""
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        import numpy as np, torch
        import upscale_video_tpu_torch
        import upscale_video_tpu_torch.pipeline.process
        import upscale_video_tpu_torch.cli.upscale_video
        import upscale_video_tpu_torch.models.ops
        import upscale_video_tpu_torch.ops.rdb
        import upscale_video_tpu_torch.ops.tiling
        from upscale_video_tpu_torch.kernels import build
        from upscale_video_tpu_torch.models.zoo import make_synthetic_rrdb_model
        from upscale_video_tpu_torch.pipeline.chain import ChainEngine, ChainSpec
        eng = ChainEngine.build(ChainSpec(), 2, "cpu", synthetic=True)
        out = eng.planar_step(torch.zeros((1, 8, 8, 3), dtype=torch.uint8))
        assert tuple(out.shape) == (1, 8, 8, 12), out.shape
        valar = ChainEngine(ChainSpec(real_life=True), 4,
                            make_synthetic_rrdb_model(num_rrdb=1,
                                                      residual_dtype=torch.float32),
                            torch.device("cpu"), tile=8, halo=2)
        out = valar.step(torch.zeros((1, 6, 10, 3), dtype=torch.uint8))
        assert tuple(out.shape) == (1, 24, 40, 3), out.shape
        assert build._lib is None
        assert not any(m == "jax" or m.startswith("jax.") for m in sys.modules
                       if sys.modules[m] is not None)
        print("OK")
    """)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(REPO), env.get("PYTHONPATH")) if p)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=str(tmp_path), env=env, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip().endswith("OK")


# the JAX package's jax-free host modules the port carries as copies
HOST_COPIES = [
    "video/ffmpeg.py", "video/io.py", "video/backend.py", "video/frames.py",
    "native/__init__.py", "native/buildlib.py", "native/imgproc.py",
    "native/pipeio.py", "cli/common.py", "utils/logsetup.py",
    "utils/profiling.py", "utils/wake.py", "pipeline/quality.py",
    "cli/merge_only.py", "cli/compare.py", "models/flops.py",
]


def _without_jax_trace(src: str) -> str:
    """``utils/profiling.py`` less ``trace`` (it imports jax) and the
    docstring line naming it: the one edit the port's copy makes."""
    src = re.sub(r"- :func:`trace` captures.*?section;\n", "", src, flags=re.S)
    return re.sub(r"@contextlib\.contextmanager\ndef trace\(.*?\n\n\n", "",
                  src, flags=re.S)


def _edit(src: str, edits) -> str:
    """``src`` with each (old, new) replacement made; each old text must
    occur exactly once."""
    for old, new in edits:
        assert src.count(old) == 1, old
        src = src.replace(old, new)
    return src


def _io_png_codec(src: str) -> str:
    """``video/io.py`` with the PNG directory source and sink on the port's
    codec (``video/png.py``) in place of PIL: the one edit its copy makes."""
    return _edit(src, [
        ("``{frame}.{tag}.png`` layout (PIL)",
         "``{frame}.{tag}.png`` layout (``video/png.py``)"),
        ("import numpy as np\n",
         "import numpy as np\n\nfrom upscale_video_tpu_torch.video.png import "
         "png_size, read_png, write_png\n"),
        ("        from PIL import Image  # lazy; PIL only needed for PNG mode\n"
         "\n        self._Image = Image\n", ""),
        ("        with Image.open(first) as im:\n"
         "            self.width, self.height = im.size\n",
         "        self.width, self.height = png_size(first)\n"),
        ("        with self._Image.open(p) as im:\n"
         "            arr = np.asarray(im.convert(\"RGB\"))\n",
         "        arr = read_png(p)\n"),
        ("        from PIL import Image\n\n        self._Image = Image\n", ""),
        ("        self._Image.fromarray(frame).save(os.path.join(self.dir, name))\n",
         "        write_png(os.path.join(self.dir, name), frame)\n"),
    ])


def _ffmpeg_png_verify(src: str) -> str:
    """``video/ffmpeg.py`` with the repair scan's PIL ``verify`` replaced by
    the port's CRC check (``video/png.py:verify_png``): its copy's one
    edit."""
    return _edit(src, [(
        '''    """PIL-verify scan used by the repair path (reference
    upscale_processing.py:658-667)."""
    from PIL import Image

    bad = []
    for frame in range(start_frame, end_frame + 1):
        path = f"{frame}.png"
        try:
            with Image.open(path) as im:
                im.verify()
        except Exception:
            bad.append(frame)
    return bad
''', '''    """CRC-verify scan (``video/png.py``) used by the repair path
    (reference upscale_processing.py:658-667)."""
    from upscale_video_tpu_torch.video.png import verify_png

    return [frame for frame in range(start_frame, end_frame + 1)
            if not verify_png(f"{frame}.png")]
''')])


@pytest.mark.parametrize("chain", ["", "a,n=3", "r", "sr", "tta"])
def test_flops_of_port_engines_equal_jax(chain):
    """``chain_step_flops`` (and ``graph_conv_flops`` per model) on port
    engines equal the JAX package's on engines of the same graphs: the
    default chain, ``a,n=3``, ``-m r`` (23 RRDBs), an ``sr=`` import of a
    basicsr RRDBNet state dict, and ``--tta`` (8x the SR stage)."""
    from tests.test_torch_sr_import import rrdb_sd
    from upscale_video_tpu.models.flops import chain_step_flops as jax_flops
    from upscale_video_tpu.models.flops import graph_conv_flops as jax_gflops
    from upscale_video_tpu.models.torch_import import (
        import_torch_checkpoint as jax_import,
    )
    from upscale_video_tpu.pipeline.chain import ChainEngine as JaxEngine
    from upscale_video_tpu_torch.models.flops import (
        chain_step_flops, graph_conv_flops,
    )
    from upscale_video_tpu_torch.models.torch_import import (
        import_torch_checkpoint,
    )
    from upscale_video_tpu_torch.pipeline.chain import ChainEngine

    if chain == "sr":
        sd = rrdb_sd(1)
        peng = ChainEngine(ChainSpec.parse("sr=x_e"), 4,
                           import_torch_checkpoint(sd), torch.device("cpu"))
        jeng = JaxEngine(JaxSpec.parse("sr=x_e"), 4,
                         jax_import(sd, compute_dtype=jnp.float32))
    else:
        text = "" if chain == "tta" else chain
        kw = dict(synthetic=True, tta=chain == "tta")
        peng = ChainEngine.build(ChainSpec.parse(text), 2, "cpu",
                                 compute_dtype=torch.float32, **kw)
        jeng = JaxEngine.build(JaxSpec.parse(text), 2,
                               compute_dtype=jnp.float32, **kw)
    for h, w in ((1080, 1920), (37, 53)):
        got = chain_step_flops(peng, h, w)
        assert got > 0 and got == jax_flops(jeng, h, w)
        for pm, jm in ((peng.sr_model, jeng.sr_model),
                       (peng.anime_model, jeng.anime_model)):
            if pm is not None:
                assert graph_conv_flops(pm.graph, h, w) \
                    == jax_gflops(jm.graph, h, w)


# the one named edit of each copy that is not its original verbatim
COPY_EDITS = {"utils/profiling.py": _without_jax_trace,
              "video/io.py": _io_png_codec,
              "video/ffmpeg.py": _ffmpeg_png_verify}


def _code(src: str) -> list:
    """The module's tokens, each with its line, less its ``#`` comments:
    code, docstrings and line layout, which a copy must keep."""
    toks = tokenize.generate_tokens(io.StringIO(src).readline)
    return [(t.type, t.string, t.start[0]) for t in toks
            if t.type != tokenize.COMMENT]


@pytest.mark.parametrize("rel", HOST_COPIES)
def test_host_copies_equal_jax_originals(rel):
    """Each copy is its original with ``upscale_video_tpu.`` mapped to
    ``upscale_video_tpu_torch.``, and nothing else changed but the wording
    of a comment (``video/ffmpeg.py`` names the invariant, not the notes
    file outside the package that states it) and the named edit of
    :data:`COPY_EDITS` (no jax in ``utils/profiling.py``, no PIL in
    ``video/io.py`` and ``video/ffmpeg.py``)."""
    want = (REPO / "upscale_video_tpu" / rel).read_text()
    want = want.replace("upscale_video_tpu.", "upscale_video_tpu_torch.")
    if rel in COPY_EDITS:
        edited = COPY_EDITS[rel](want)
        assert edited != want and "import jax" not in edited \
            and "PIL" not in edited.replace("PIL's", "")
        want = edited
    got = (REPO / "upscale_video_tpu_torch" / rel).read_text()
    assert _code(got) == _code(want)


def test_buildlib_copy_builds_from_the_repo_native_sources():
    from upscale_video_tpu_torch.native import buildlib

    assert Path(buildlib.NATIVE_DIR) == REPO / "native"
    assert (REPO / "native" / "imgproc.cpp").is_file()


def test_cli_runs_with_jax_and_the_jax_package_blocked(tmp_path):
    """A meta-path finder refuses ``jax`` and ``upscale_video_tpu``; the
    port's CLI still imports and runs ``process_file`` with ``-m a,n=3`` on
    a 16x12 Y4M clip on the CPU, and neither package was loaded."""
    code = textwrap.dedent("""
        import importlib.abc, sys

        BLOCKED = ("jax", "upscale_video_tpu")

        class Block(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path, target=None):
                if any(name == b or name.startswith(b + ".") for b in BLOCKED):
                    raise ImportError(f"blocked import of {name}")
                return None

        def loaded():
            return [m for m in sys.modules if sys.modules[m] is not None
                    and any(m == b or m.startswith(b + ".") for b in BLOCKED)]

        assert not loaded(), loaded()
        sys.meta_path.insert(0, Block())
        import numpy as np
        from upscale_video_tpu_torch.cli.upscale_video import main
        from upscale_video_tpu_torch.video import Y4MSink, Y4MSource
        rng = np.random.default_rng(0)
        with Y4MSink("in.y4m", 16, 12, "24/1") as sink:
            for _ in range(3):
                sink.write(rng.integers(0, 256, (12, 16, 3), dtype=np.uint8))
        assert main(["-i", "in.y4m", "-o", "out.y4m", "-t", "work", "-m",
                     "a,n=3", "--synthetic_models", "--device", "cpu"]) == 0
        with Y4MSource("out.y4m") as src:
            frames = list(src)
        assert len(frames) == 3 and frames[0].shape == (24, 32, 3)
        assert not loaded(), loaded()
        print("OK")
    """)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(REPO), env.get("PYTHONPATH")) if p)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=str(tmp_path), env=env, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip().endswith("OK")


def test_png_plane_and_workflows_run_without_pil(tmp_path):
    """A meta-path finder refuses ``jax``, ``upscale_video_tpu`` and
    ``PIL``: on the CPU the port's CLIs still run the png plane, ``-x``,
    the split-machine pair, the repair, the sampling and ``vsr-compare``
    over a 16x12 Y4M clip, and none of the three was loaded."""
    code = textwrap.dedent("""
        import importlib.abc, os, sys

        BLOCKED = ("jax", "upscale_video_tpu", "PIL")

        class Block(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path, target=None):
                if any(name == b or name.startswith(b + ".") for b in BLOCKED):
                    raise ImportError(f"blocked import of {name}")
                return None

        def loaded():
            return [m for m in sys.modules if sys.modules[m] is not None
                    and any(m == b or m.startswith(b + ".") for b in BLOCKED)]

        assert not loaded(), loaded()
        sys.meta_path.insert(0, Block())
        import numpy as np
        from upscale_video_tpu_torch.cli import (
            compare, fix_frames, merge_only, test_images, upscale_only,
            upscale_video,
        )
        from upscale_video_tpu_torch.video import Y4MSink, Y4MSource
        rng = np.random.default_rng(0)
        with Y4MSink("in.y4m", 16, 12, "1/20") as sink:
            for _ in range(4):
                sink.write(rng.integers(0, 256, (12, 16, 3), dtype=np.uint8))
        cpu = ["--synthetic_models", "--device", "cpu"]
        assert upscale_video.main(["-i", "in.y4m", "-o", "png.y4m", "-t", "w1",
                                   "-m", "n=3", "--data_plane", "png",
                                   "-b", "1", *cpu]) == 0
        assert upscale_only.main(["-i", "in.y4m", "-t", "w2", "-b", "1", *cpu]) == 0
        assert merge_only.main(["-o", ".", "-t", "w2"]) == 0
        assert upscale_video.main(["-i", "in.y4m", "-t", "w3", "-x", "-r",
                                   "--device", "cpu"]) == 0
        assert test_images.main(["-i", "1", "-t", "w3", "-o", "s", "-m", "n=3",
                                 *cpu]) == 0
        os.remove("w3/upscale_video/2.extract.png")
        assert fix_frames.main(["-i", "in.y4m", "-b", "2", "-t", "w3", *cpu]) == 0
        assert compare.main(["-a", "in.upscaled.y4m", "-b", "in.upscaled.y4m"]) == 0
        with Y4MSource("in.upscaled.y4m") as src:
            frames = list(src)
        assert len(frames) == 4 and frames[0].shape == (24, 32, 3)
        assert os.path.exists("w3/upscale_video/2.png")
        assert not loaded(), loaded()
        print("OK")
    """)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(REPO), env.get("PYTHONPATH")) if p)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=str(tmp_path), env=env, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip().endswith("OK")


def test_trace_dir_and_test_chips_run_with_jax_blocked(tmp_path):
    """With ``jax``, ``upscale_video_tpu`` and ``PIL`` refused:
    ``upscale-video-torch --trace_dir`` on the CPU leaves one readable
    Chrome trace naming the run's convs, and ``test-chips-torch`` runs its
    sweep on a tiny frame; none of the three was loaded."""
    code = textwrap.dedent("""
        import importlib.abc, json, os, sys

        BLOCKED = ("jax", "upscale_video_tpu", "PIL")

        class Block(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path, target=None):
                if any(name == b or name.startswith(b + ".") for b in BLOCKED):
                    raise ImportError(f"blocked import of {name}")
                return None

        def loaded():
            return [m for m in sys.modules if sys.modules[m] is not None
                    and any(m == b or m.startswith(b + ".") for b in BLOCKED)]

        sys.meta_path.insert(0, Block())
        import numpy as np
        from upscale_video_tpu_torch.cli import test_chips, upscale_video
        from upscale_video_tpu_torch.video import Y4MSink
        rng = np.random.default_rng(0)
        with Y4MSink("in.y4m", 16, 12, "24/1") as sink:
            for _ in range(2):
                sink.write(rng.integers(0, 256, (12, 16, 3), dtype=np.uint8))
        assert upscale_video.main(["-i", "in.y4m", "-o", "out.y4m", "-t", "w",
                                   "--synthetic_models", "--device", "cpu",
                                   "--trace_dir", "tr"]) == 0
        (name,) = os.listdir("tr")
        assert name.endswith(".pt.trace.json"), name
        with open(os.path.join("tr", name)) as f:
            events = json.load(f)["traceEvents"]
        assert any("conv" in str(e.get("name", "")) for e in events)
        assert test_chips.main(["--synthetic_models", "--device", "cpu",
                                "--height", "8", "--width", "12", "-r", "1",
                                "--batch_depths", "1,2"]) == 0
        assert not loaded(), loaded()
        print("OK")
    """)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(REPO), env.get("PYTHONPATH")) if p)
    env["OMP_NUM_THREADS"] = "2"  # beside the suite's other workers
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=str(tmp_path), env=env, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip().endswith("OK")


def test_finetune_runs_with_jax_blocked(tmp_path):
    """With ``jax``, ``optax``, ``orbax``, ``upscale_video_tpu`` and ``PIL``
    refused: ``vsr-finetune-torch`` on the CPU trains on a 40x48 Y4M clip,
    checkpoints, resumes, shards over a logical mesh and exports, and none
    of them was loaded."""
    code = textwrap.dedent("""
        import importlib.abc, os, sys

        BLOCKED = ("jax", "optax", "orbax", "upscale_video_tpu", "PIL")

        class Block(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path, target=None):
                if any(name == b or name.startswith(b + ".") for b in BLOCKED):
                    raise ImportError(f"blocked import of {name}")
                return None

        def loaded():
            return [m for m in sys.modules if sys.modules[m] is not None
                    and any(m == b or m.startswith(b + ".") for b in BLOCKED)]

        sys.meta_path.insert(0, Block())
        import numpy as np
        from upscale_video_tpu_torch.cli import finetune
        from upscale_video_tpu_torch.video import Y4MSink
        rng = np.random.default_rng(0)
        with Y4MSink("in.y4m", 48, 40, "24/1") as sink:
            for _ in range(3):
                sink.write(rng.integers(0, 256, (40, 48, 3), dtype=np.uint8))
        base = ["-i", "in.y4m", "-o", "out", "--batch", "2", "--patch", "8",
                "--synthetic_models", "--device", "cpu", "--ckpt_dir", "ck",
                "--ckpt_every", "1"]
        assert finetune.main([*base, "--steps", "2"]) == 0
        assert finetune.main([*base, "--steps", "3", "--resume",
                              "--mesh", "dp=2,sp=2"]) == 0
        assert sorted(os.listdir("ck")) == ["step_1", "step_2", "step_3"]
        assert sorted(os.listdir("out")) == ["2x_compact_finetuned.bin",
                                             "2x_compact_finetuned.param"]
        assert not loaded(), loaded()
        print("OK")
    """)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(REPO), env.get("PYTHONPATH")) if p)
    env["OMP_NUM_THREADS"] = "2"  # beside the suite's other workers
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=str(tmp_path), env=env, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip().endswith("OK")


def test_port_sources_never_import_the_jax_package():
    """No module of the port, and not chip_smoke.py, imports anything of
    ``upscale_video_tpu`` (its name stays only in comments and docs)."""
    paths = list((REPO / "upscale_video_tpu_torch").rglob("*.py"))
    for path in paths + [REPO / "chip_smoke.py"]:
        for line in path.read_text().splitlines():
            s = line.strip()
            assert not re.match(r"(import|from) upscale_video_tpu(\.|\s|$)", s), \
                (path, line)


def test_port_sources_never_import_jax():
    pkg = REPO / "upscale_video_tpu_torch"
    for path in pkg.rglob("*.py"):
        for line in path.read_text().splitlines():
            s = line.strip()
            assert not (s.startswith("import jax") or s.startswith("from jax")), path


def test_resolve_device_cuda_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def test_cuda_entries_never_compute_without_a_card():
    """Off the CPU the wrappers launch or raise: a tensor on another
    device is refused, and the launch path has no library to fall back
    from when nvcc is missing."""
    layer = make_layer(np.zeros((3, 3, 3, 4), np.float32))
    with pytest.raises(ValueError, match="unsupported device"):
        conv3x3_chain(torch.zeros(1, 4, 4, 3, device="meta"), [layer])
    with pytest.raises(ValueError, match="unsupported device"):
        sr_tail_chain(torch.zeros(1, 6, 6, 4, device="meta"),
                      torch.zeros(1, 4, 4, 3), torch.zeros(36, 12),
                      torch.zeros(12), 2)
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    buf = torch.zeros(1, 6, 6, 3, dtype=torch.bfloat16)
    with pytest.raises(RuntimeError):
        launch_chain_layer(buf, torch.zeros(1, 6, 6, 4, dtype=torch.bfloat16),
                           make_layer(np.zeros((3, 3, 3, 4), np.float32)))


def test_kernel_sources_ship_and_hash():
    for name in build.SOURCES + build.HEADERS:
        assert (build.CSRC_DIR / name).is_file()
    assert "sm_90a" in " ".join(build.NVCC_FLAGS)
    assert build.library_path().name.startswith("libuvt_kernels_")
    assert build._lib is None or torch.cuda.is_available()
