"""The ``-m sr=`` slice on the CPU: ``vsr-import-torch`` and the imported
models through the port, against ``vsr-import`` and the JAX package.

Checkpoints are basicsr-keyed state dicts made from a seed with numpy:
RRDBNet at 2 blocks (RealESRGAN_x4plus's widths, nf 64, gc 32), its x2
pixel-unshuffle variant (12-channel ``conv_first``), the same net under
old-architecture ESRGAN keys, and SRVGGNetCompact at nf 64 and nf 160.
Each package converts them with its own CLI; the slice tests then load
each package's own files.

Tolerances, each with its reason:

- ``.param`` text and ``.bin`` bytes: identical (same keys, folds, graphs
  and emitters).
- The port's f32 import against an independent torch functional forward of
  the checkpoint: within 1e-4 (f32 sums in another order, as the JAX
  package's tests/test_torch_import.py allows).
- f32 through ``ChainEngine`` and ``process_file`` (the port's aten route)
  against the JAX XLA f32 path: within 1 u8 LSB (PARITY.md's contract).
- bf16 (the kernel route) against JAX ``build_forward(pallas_conv=True,
  dense_scatter=False)`` and the JAX engine on its Pallas path (K4 and K3
  in interpret mode): within 1 u8 LSB; a K4 output one bf16 ulp
  apart (f32 sums in another order) moves the image by an ulp.  The share
  of bytes that differ is asserted under a cap and stated beside it.
"""

import filecmp
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from upscale_video_tpu.cli.import_model import main as jax_import_main
from upscale_video_tpu.models.executor import build_forward as jax_build_forward
from upscale_video_tpu.models.torch_import import (
    import_torch_checkpoint as jax_import_checkpoint,
)
from upscale_video_tpu.models.zoo import load_model as jax_load_model
from upscale_video_tpu.ops.pixel import frames_to_model as jax_frames_to_model
from upscale_video_tpu.ops.yuv import packed_to_i420, yuv420_from_frames
from upscale_video_tpu.pipeline.chain import ChainEngine as JaxEngine
from upscale_video_tpu.pipeline.chain import ChainSpec as JaxSpec
from upscale_video_tpu.pipeline.process import process_file as jax_process
from upscale_video_tpu.video.io import Y4MSink
from upscale_video_tpu_torch.cli.import_model import main as port_import_main
from upscale_video_tpu_torch.models.executor import GraphForward
from upscale_video_tpu_torch.models.torch_import import (
    detect_arch, import_torch_checkpoint,
)
from upscale_video_tpu_torch.models.zoo import load_model, params_from_jax
from upscale_video_tpu_torch.ops.pixel import frames_to_model, planar_to_frames
from upscale_video_tpu_torch.pipeline.chain import ChainEngine, ChainSpec
from upscale_video_tpu_torch.pipeline.process import process_file
from tests.torch_fixtures import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parent.parent


def _w(rng, *shape):
    fan_in = int(np.prod(shape[1:])) if len(shape) > 1 else 1
    return rng.normal(0, 0.6 / np.sqrt(fan_in), shape).astype(np.float32)


def rrdb_sd(seed, num_rrdb=2, nf=64, gc=32, in_ch=3, ups=2):
    """A basicsr RRDBNet state dict (RealESRGAN_x4plus's key layout)."""
    rng = np.random.default_rng(seed)
    sd = {"conv_first.weight": _w(rng, nf, in_ch, 3, 3),
          "conv_first.bias": _w(rng, nf) * 0.1}
    for i in range(num_rrdb):
        for j in (1, 2, 3):
            for k in range(1, 6):
                cout = nf if k == 5 else gc
                sd[f"body.{i}.rdb{j}.conv{k}.weight"] = _w(
                    rng, cout, nf + (k - 1) * gc, 3, 3)
                sd[f"body.{i}.rdb{j}.conv{k}.bias"] = _w(rng, cout) * 0.1
    for name in ["conv_body"] + [f"conv_up{n + 1}" for n in range(ups)] + ["conv_hr"]:
        sd[f"{name}.weight"] = _w(rng, nf, nf, 3, 3)
        sd[f"{name}.bias"] = _w(rng, nf) * 0.1
    sd["conv_last.weight"] = _w(rng, 3, nf, 3, 3)
    sd["conv_last.bias"] = _w(rng, 3) * 0.1 + 0.5
    return sd


def old_esrgan_keys(sd):
    """basicsr RRDBNet keys -> the old ESRGAN architecture's."""
    num_rrdb = 1 + max(int(k.split(".")[1]) for k in sd if k.startswith("body."))
    fixed = {"conv_first": "model.0", "conv_body": f"model.1.sub.{num_rrdb}",
             "conv_up1": "model.3", "conv_up2": "model.6", "conv_hr": "model.8",
             "conv_last": "model.10"}
    out = {}
    for k, v in sd.items():
        stem, wb = k.rsplit(".", 1)
        if stem.startswith("body."):
            _, i, rdb, conv = stem.split(".")
            out[f"model.1.sub.{i}.RDB{rdb[3:]}.conv{conv[4:]}.0.{wb}"] = v
        else:
            out[f"{fixed[stem]}.{wb}"] = v
    return out


def srvgg_sd(seed, num_conv=2, nf=64, scale=4):
    """An SRVGGNetCompact state dict (body.{2i} conv, body.{2i+1} PReLU)."""
    rng = np.random.default_rng(seed)
    sd, idx, cin = {}, 0, 3
    for _ in range(num_conv + 1):
        sd[f"body.{idx}.weight"] = _w(rng, nf, cin, 3, 3)
        sd[f"body.{idx}.bias"] = _w(rng, nf) * 0.1
        sd[f"body.{idx + 1}.weight"] = rng.uniform(0.05, 0.3, nf).astype(np.float32)
        idx, cin = idx + 2, nf
    sd[f"body.{idx}.weight"] = _w(rng, 3 * scale * scale, nf, 3, 3) * 0.3
    sd[f"body.{idx}.bias"] = _w(rng, 3 * scale * scale) * 0.1
    return sd


# name -> (state dict, the stem suffix vsr-import derives, net scale)
CHECKPOINTS = {
    "esrgan": (lambda: {"params_ema": rrdb_sd(1)}, "x_esrgan", 4),
    "esrgan_x2": (lambda: rrdb_sd(2, in_ch=12), "x_esrgan_x2", 2),
    "old_esrgan": (lambda: old_esrgan_keys(rrdb_sd(3)), "x_old_esrgan", 4),
    "srvgg64": (lambda: {"params": srvgg_sd(4, nf=64)}, "x_srvgg64", 4),
    "srvgg160": (lambda: srvgg_sd(5, nf=160), "x_srvgg160", 4),
}


@pytest.fixture(scope="module")
def imported(tmp_path_factory):
    """Every checkpoint through both CLIs: ``{name: (jax dir, port dir,
    the port CLI's stdout)}``."""
    root = tmp_path_factory.mktemp("sr_import")
    out = {}
    for name, (make, _, _) in CHECKPOINTS.items():
        pth = root / f"{name}.pth"
        torch.save({k: ({n: torch.from_numpy(a) for n, a in v.items()}
                        if isinstance(v, dict) else torch.from_numpy(v))
                    for k, v in make().items()}, str(pth))
        jdir, pdir = root / "jax", root / "port"
        assert jax_import_main(["-i", str(pth), "-o", str(jdir)]) == 0
        r = subprocess.run(
            [sys.executable, "-c", "import sys; from upscale_video_tpu_torch."
             "cli.import_model import main; sys.exit(main(sys.argv[1:]))",
             "-i", str(pth), "-o", str(pdir)],
            capture_output=True, text=True, cwd=str(REPO), timeout=300)
        assert r.returncode == 0, r.stderr[-2000:]
        out[name] = (str(jdir), str(pdir), r.stdout)
    return out


@pytest.mark.parametrize("name", list(CHECKPOINTS))
def test_vsr_import_torch_writes_the_same_files(imported, name):
    jdir, pdir, stdout = imported[name]
    _, suffix, scale = CHECKPOINTS[name]
    stem = f"{scale}{suffix}"
    for ext in (".param", ".bin"):
        assert filecmp.cmp(os.path.join(jdir, stem + ext),
                           os.path.join(pdir, stem + ext), shallow=False)
    assert f"upscale-video-torch --model_path {pdir} -m sr={suffix} -s {scale}" \
        in stdout


def test_vsr_import_torch_main_in_process(tmp_path, capsys):
    sd = srvgg_sd(6, num_conv=1, nf=8, scale=2)
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()},
               str(tmp_path / "tiny.pth"))
    assert port_import_main(["-i", str(tmp_path / "tiny.pth"), "-o",
                             str(tmp_path / "m"), "--stem", "mine"]) == 0
    assert sorted(os.listdir(tmp_path / "m")) == ["2x_mine.bin", "2x_mine.param"]
    assert "-m sr=x_mine -s 2" in capsys.readouterr().out


def _torch_rrdb(sd, x):
    lrelu = lambda t: F.leaky_relu(t, 0.2)  # noqa: E731
    conv = lambda n, t: F.conv2d(t, sd[f"{n}.weight"], sd[f"{n}.bias"],  # noqa: E731
                                 padding=1)
    in_ch = sd["conv_first.weight"].shape[1]
    if in_ch > 3:
        x = F.pixel_unshuffle(x, int((in_ch // 3) ** 0.5))
    feat = conv("conv_first", x)
    trunk, i = feat, 0
    while f"body.{i}.rdb1.conv1.weight" in sd:
        rin = trunk
        for j in (1, 2, 3):
            x0, feats = trunk, [trunk]
            for k in range(1, 5):
                feats.append(lrelu(conv(f"body.{i}.rdb{j}.conv{k}",
                                        torch.cat(feats, 1))))
            trunk = conv(f"body.{i}.rdb{j}.conv5", torch.cat(feats, 1)) * 0.2 + x0
        trunk = trunk * 0.2 + rin
        i += 1
    feat = feat + conv("conv_body", trunk)
    for n in (1, 2):
        feat = lrelu(conv(f"conv_up{n}", F.interpolate(feat, scale_factor=2,
                                                       mode="nearest")))
    return conv("conv_last", lrelu(conv("conv_hr", feat)))


def _torch_srvgg(sd, x, scale):
    feat, i = x, 0
    while f"body.{i}.weight" in sd:
        w = sd[f"body.{i}.weight"]
        feat = (F.conv2d(feat, w, sd[f"body.{i}.bias"], padding=1) if w.ndim == 4
                else F.prelu(feat, w))
        i += 1
    return F.pixel_shuffle(feat, scale) + F.interpolate(
        x, scale_factor=scale, mode="nearest")


@pytest.mark.parametrize("name", ["esrgan", "esrgan_x2", "srvgg160"])
def test_port_import_equals_the_torch_forward(name):
    """The port's f32 model of the checkpoint (BGR NHWC in) against the
    checkpoint's own torch forward (RGB NCHW) under the channel flip."""
    make, _, scale = CHECKPOINTS[name]
    raw = make()
    sd = {k: torch.from_numpy(v) for k, v in raw.get("params_ema", raw).items()}
    model = import_torch_checkpoint(raw, compute_dtype=torch.float32)
    assert model.scale == scale and detect_arch(raw.get("params_ema", raw)) in (
        "rrdb", "srvgg")
    x = np.random.default_rng(7).uniform(0, 1, (1, 3, 8, 12)).astype(np.float32)
    with torch.no_grad():
        want = (_torch_srvgg(sd, torch.from_numpy(x), scale) if "srvgg" in name
                else _torch_rrdb(sd, torch.from_numpy(x))).numpy()
    got = model(torch.from_numpy(x[:, ::-1].transpose(0, 2, 3, 1).copy()), "model")
    np.testing.assert_allclose(got.numpy(), want[:, ::-1].transpose(0, 2, 3, 1),
                               atol=1e-4, rtol=0)


@pytest.mark.parametrize("name", ["esrgan", "srvgg160"])
def test_params_from_jax_carries_imported_convs(name):
    """The JAX import's params cross into the port's state unchanged: every
    conv as its (9*cin, cout) matrix and bias, every PReLU slope."""
    make, _, _ = CHECKPOINTS[name]
    jm = jax_import_checkpoint(make(), compute_dtype=jnp.float32)
    state = params_from_jax(jm.params, "cpu", torch.float32)
    assert sorted(state.keys()) == sorted(jm.params)
    for layer, p in jm.params.items():
        if "weight" in p:
            w = np.asarray(p["weight"])
            np.testing.assert_array_equal(state[layer].wmat.numpy(),
                                          w.reshape(-1, w.shape[-1]))
            np.testing.assert_array_equal(state[layer].bias.numpy(), p["bias"])
        else:
            np.testing.assert_array_equal(state[layer].slope.numpy(), p["slope"])


def _max_lsb(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    return int(np.abs(a.astype(int) - b.astype(int)).max())


def _engines(imported, name, spec="sr={}", **kw):
    jdir, pdir, _ = imported[name]
    _, suffix, scale = CHECKPOINTS[name]
    text = spec.format(suffix)
    jeng = JaxEngine.build(JaxSpec.parse(text), scale, model_path=jdir,
                           compute_dtype=jnp.float32, **kw)
    peng = ChainEngine.build(ChainSpec.parse(text), scale, "cpu", model_path=pdir,
                             compute_dtype=torch.float32, **kw)
    return jeng, peng


@pytest.fixture(scope="module")
def engines(imported):
    return {name: _engines(imported, name)
            for name in ("esrgan", "esrgan_x2", "srvgg160")}


N_FRAMES, H, W = 2, 12, 16


def _write_clip(path, c420, h=H, w=W):
    frames = np.random.default_rng(11).integers(0, 256, (N_FRAMES, h, w, 3),
                                                dtype=np.uint8)
    if c420:
        packed = np.asarray(yuv420_from_frames(jnp.asarray(frames), True))
        with Y4MSink(path, w, h, "24/1", colorspace="C420jpeg") as s:
            for p in packed:
                s.write(packed_to_i420(p, 2))
    else:
        with Y4MSink(path, w, h, "24/1") as s:
            for f in frames:
                s.write(f)


def _raw(path):
    with open(path, "rb") as f:
        header, _, body = f.read().partition(b"\n")
    return header, np.stack([np.frombuffer(c, np.uint8)
                             for c in body.split(b"FRAME\n")[1:]])


@pytest.mark.parametrize("name,c420,contract", [
    ("esrgan", False, "rgb24"), ("esrgan", True, "yuv420p"),
    ("srvgg160", False, "rgb24"), ("srvgg160", True, "yuv420p"),
], ids=["esrgan-c444", "esrgan-c420jpeg", "srvgg160-c444", "srvgg160-c420jpeg"])
def test_process_file_sr_matches_jax(tmp_path, imported, engines, name, c420,
                                     contract):
    """``process_file -m sr=<stem>`` in f32: same contract, same work-dir
    files, frames within 1 LSB of the JAX package's."""
    jeng, peng = engines[name]
    _, suffix, scale = CHECKPOINTS[name]
    src = str(tmp_path / "in.y4m")
    _write_clip(src, c420)
    runs = {}
    for who, runner, eng, kw in (("jax", jax_process, jeng, {}),
                                 ("port", process_file, peng, {"device": "cpu"})):
        out = str(tmp_path / f"{who}.y4m")
        work = tmp_path / f"work_{who}"
        res = runner(src, out, temp_dir=str(work), batch_size=-1,
                     models=f"sr={suffix}", scale=scale, precision="f32",
                     resume_processing=True, engine=eng, **kw)
        runs[who] = (out, res, sorted(os.listdir(work / "upscale_video")))
    (jout, jres, jfiles), (pout, pres, pfiles) = runs["jax"], runs["port"]
    assert pres.pipe_pix == jres.pipe_pix == contract
    assert pres.frames_processed == jres.frames_processed == N_FRAMES
    assert pfiles == jfiles and "completed.txt" in pfiles
    jh, jframes = _raw(jout)
    ph, pframes = _raw(pout)
    assert ph == jh and f"W{W * scale} H{H * scale}".encode() in ph
    assert _max_lsb(pframes, jframes) <= 1


@pytest.mark.parametrize("hw", [(11, 15), (12, 16)], ids=["odd", "even"])
def test_unshuffle_import_step_matches_jax(engines, hw):
    """The x2 pixel-unshuffle import (Reorg): an odd frame is edge-padded to
    the stride and the output cropped back, as the JAX forward does."""
    jeng, peng = engines["esrgan_x2"]
    x = np.random.default_rng(12).integers(0, 256, (1, *hw, 3), dtype=np.uint8)
    want = np.asarray(jeng.step(jnp.asarray(x)))
    got = peng.step(torch.from_numpy(x)).numpy()
    assert got.shape == (1, 2 * hw[0], 2 * hw[1], 3) and peng.planar_scale is None
    assert _max_lsb(got, want) <= 1
    y = np.asarray(jeng.yuv_step(True, planar=False)(jnp.asarray(x)))
    assert _max_lsb(peng.yuv_step(True, planar=False)(torch.from_numpy(x)).numpy(),
                    y) <= 1


def test_wide_srvgg_keeps_the_planar_contract(engines):
    jeng, peng = engines["srvgg160"]
    assert peng.planar_scale == 4
    fwd = peng.sr_model.frames_forward("planar")
    # f32 takes the aten route: the planar layout made from its frames
    assert isinstance(fwd, GraphForward) and fwd.tail is None
    assert fwd.tail_scale == 4
    x = np.random.default_rng(13).integers(0, 256, (2, 6, 10, 3), dtype=np.uint8)
    want = np.asarray(jeng.planar_step(jnp.asarray(x)))
    assert _max_lsb(peng.planar_step(torch.from_numpy(x)).numpy(), want) <= 1


def test_wide_srvgg_bf16_planar_matches_the_jax_pallas_engine(imported):
    """The planar test's twin on the kernel route: bf16, the wide SRVGG's
    body on K4 and its tail on K3's planar layout, interleaved on the host,
    against the JAX engine's step on its Pallas path (which has no planar
    layout): within 1 LSB."""
    jdir, pdir, _ = imported["srvgg160"]
    _, suffix, scale = CHECKPOINTS["srvgg160"]
    spec = f"sr={suffix}"
    jeng = JaxEngine.build(JaxSpec.parse(spec), scale, model_path=jdir,
                           compute_dtype=jnp.bfloat16, conv_impl="pallas")
    peng = ChainEngine.build(ChainSpec.parse(spec), scale, "cpu",
                             model_path=pdir, compute_dtype=torch.bfloat16)
    fwd = peng.sr_model.frames_forward("planar")
    assert isinstance(fwd, GraphForward) and fwd.tail["scale"] == 4
    assert fwd.solos and not fwd.chains
    x = np.random.default_rng(13).integers(0, 256, (2, 6, 10, 3), dtype=np.uint8)
    want = np.asarray(jeng.step(jnp.asarray(x)))
    got = peng.planar_step(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 6, 10, 48)
    assert _max_lsb(planar_to_frames(got, 4), want) <= 1


@pytest.mark.parametrize("name,share", [("esrgan", 0.05), ("srvgg160", 0.05)])
def test_bf16_matches_the_jax_k4_k3_route(imported, name, share):
    """bf16 against JAX ``pallas_conv=True`` with ``dense_scatter=False``:
    every solo 3x3 conv on K4 (interpret mode) in both packages, the
    SRVGG tail on K3.  Measured share of differing bytes at these seeds:
    0 for the ESRGAN import, 0.37% for the nf-160 SRVGG; the cap is 5%."""
    jdir, pdir, _ = imported[name]
    _, suffix, scale = CHECKPOINTS[name]
    jm = jax_load_model(suffix, scale, jdir, jnp.bfloat16)
    pm = load_model(suffix, scale, "cpu", pdir, torch.bfloat16)
    x = np.random.default_rng(14).integers(0, 256, (1, 8, 12, 3), dtype=np.uint8)
    jf = jax_build_forward(jm.graph, jnp.bfloat16, pallas_conv=True,
                           dense_scatter=False, emit_frames=True)
    want = np.asarray(jf(jm.params, jax_frames_to_model(jnp.asarray(x))))
    got = pm(frames_to_model(torch.from_numpy(x)), "frames").numpy()
    assert _max_lsb(got, want) <= 1
    assert (got != want).mean() <= share


@pytest.mark.parametrize("name,spec,kw", [
    ("srvgg160", "sr={}", {"tta": True}), ("esrgan", "n=3,sr={}", {}),
], ids=["tta-srvgg160", "n3-esrgan"])
def test_sr_composes_with_tta_and_denoise(imported, name, spec, kw):
    jeng, peng = _engines(imported, name, spec, **kw)
    x = np.random.default_rng(15).integers(0, 256, (1, 8, 12, 3), dtype=np.uint8)
    want = np.asarray(jeng.step(jnp.asarray(x)))
    assert _max_lsb(peng.step(torch.from_numpy(x)).numpy(), want) <= 1


def test_engine_build_sr_policies(imported):
    """``sr=`` imports run whole-frame by default, 4 frames per step, take
    ``--tile_size`` and ``mixed`` on the graph walk; ``--synthetic_models``
    ignores the stem and builds the Compact, which runs ``mixed`` on K1 +
    K2 (whose skip add is f32 already)."""
    from upscale_video_tpu_torch.pipeline.chain import default_frames_per_step

    _, pdir, _ = imported["esrgan"]
    spec = ChainSpec.parse("sr=x_esrgan")
    assert default_frames_per_step(spec) == 4
    eng = ChainEngine.build(spec, 4, "cpu", model_path=pdir, tile=16, halo=4,
                            residual_dtype=torch.float32)
    assert eng.tile == 16 and eng.describe() == "sr(x_esrgan) (scale 4x)"
    x = torch.from_numpy(np.random.default_rng(16).integers(
        0, 256, (1, 20, 24, 3), dtype=np.uint8))
    assert tuple(eng.step(x).shape) == (1, 80, 96, 3)
    syn = ChainEngine.build(ChainSpec.parse("sr=x_missing"), 2, "cpu",
                            synthetic=True)
    assert syn.sr_model.name == "synthetic_2x_compact" and syn.planar_scale == 2
    mixed = ChainEngine.build(ChainSpec.parse("sr=x_missing"), 2, "cpu",
                              synthetic=True, residual_dtype=torch.float32)
    assert mixed.planar_scale == 2
    assert torch.equal(mixed.planar_step(x[:, :8, :12]),
                       syn.planar_step(x[:, :8, :12]))


def test_cli_imports_and_upscales_with_jax_blocked(tmp_path):
    """``vsr-import-torch`` then ``upscale-video-torch -m sr=<stem>
    --model_path <dir> --device cpu`` in a process whose meta-path finder
    refuses ``jax`` and ``upscale_video_tpu``; neither gets loaded."""
    sd = srvgg_sd(8, num_conv=1, nf=160, scale=2)
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()},
               str(tmp_path / "wide.pth"))
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

        sys.meta_path.insert(0, Block())
        import numpy as np
        from upscale_video_tpu_torch.cli.import_model import main as imp
        from upscale_video_tpu_torch.cli.upscale_video import main
        from upscale_video_tpu_torch.video import Y4MSink, Y4MSource
        assert imp(["-i", "wide.pth", "-o", "models"]) == 0
        rng = np.random.default_rng(0)
        with Y4MSink("in.y4m", 16, 12, "24/1") as sink:
            for _ in range(3):
                sink.write(rng.integers(0, 256, (12, 16, 3), dtype=np.uint8))
        assert main(["-i", "in.y4m", "-o", "out.y4m", "-t", "work", "-m",
                     "sr=x_wide", "-s", "2", "--model_path", "models",
                     "--device", "cpu"]) == 0
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
