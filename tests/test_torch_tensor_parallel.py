"""``--parallel tp``, ``--tta`` over a tiled SR stage under ``--parallel
sp``, and ``vsr-warmup-torch``, on the CPU: the port's logical CPU shards
against the JAX package's 8 host devices (tests/conftest.py).

- ``shard_params_channelwise`` splits exactly the leaves JAX's does.
- Each tp step (frames, planar, 4:2:0 with I420 in, tiled, ``--tta``,
  ``a,n=3``, ``-m r`` at 2 RRDBs, an ``sr=`` ESRGAN at 2 blocks) over 2 and
  4 shards, in f32 and bf16, equals the same tp forward on a one-entry
  mesh bit for bit (the CPU's ``F.conv2d`` sums each output channel in the
  same order whatever the cout, so no bound is needed), stays within the
  route-swap bound of the port's single-device ``auto`` step, and is
  within 1 LSB of JAX's ``use_chips(.., "tp")`` in f32.
- Receiving buffers filled with NaN: a channel no shard writes shows up.
- The narrow-tp warning, ``--conv_impl rdb`` under tp (K5 whole, warned).
- ``--tta`` with ``--tile_size`` under sp: bit-equal to the single step on
  the frame sp pads, within 1 LSB of JAX's sp.
- ``vsr-warmup-torch``: its parser equals JAX's but ``--device``, its
  contract resolution equals JAX's, and it runs on the CPU with ``jax``
  and ``upscale_video_tpu`` refused.
"""

import logging
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from upscale_video_tpu.models.bin_loader import (
    synthesize_weights as jax_synthesize,
)
from upscale_video_tpu.models.zoo import Model as JaxModel
from upscale_video_tpu.models.zoo import make_rrdb_graph as jax_rrdb_graph
from upscale_video_tpu.models.zoo import make_synthetic_model as jax_model
from upscale_video_tpu.models.zoo import make_synthetic_rrdb_model as jax_rrdb
from upscale_video_tpu.parallel import mesh as jax_mesh
from upscale_video_tpu.parallel.tensor import (
    shard_params_channelwise as jax_shard,
)
from upscale_video_tpu.pipeline.chain import ChainEngine as JaxEngine
from upscale_video_tpu.pipeline.chain import ChainSpec as JaxSpec
from upscale_video_tpu_torch.models import executor
from upscale_video_tpu_torch.models.zoo import Model
from upscale_video_tpu_torch.ops.pixel import pad_to_multiple, psnr
from upscale_video_tpu_torch.ops.yuv import packed_to_i420, yuv420_from_frames
from upscale_video_tpu_torch.parallel import mesh
from upscale_video_tpu_torch.parallel.data import ShardedStep
from upscale_video_tpu_torch.parallel.tensor import shard_params_channelwise
from upscale_video_tpu_torch.pipeline.chain import ChainEngine, ChainSpec
from tests.torch_fixtures import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
H, W = 12, 16
# a route swap (the kernels' plain versions against the aten route, K1 +
# K2 against K4 + K3): tests/test_torch_slice.py's and test_torch_valar.py's
# bound for --conv_impl xla against auto (a bf16 ulp moved by another
# summation order, propagated)
SWAP_MAX_LSB, SWAP_MIN_DB = 4, 50.0


def _lsb(a, b) -> int:
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    return int(np.abs(a.astype(int) - b.astype(int)).max())


def _frames(seed, n=2, h=H, w=W):
    return np.random.default_rng(seed).integers(0, 256, (n, h, w, 3),
                                                dtype=np.uint8)


def _port(m, dtype, residual=None, conv_impl="auto"):
    """The JAX model ``m``'s graph and weights as a port model."""
    return Model(m.name, m.scale, m.graph, m.params, CPU, dtype, residual,
                 conv_impl)


def _jax_models(which, dtype):
    """``(sr, anime)`` JAX models of one step form's chain."""
    if which == "valar":
        m = jax_rrdb(scale=4, num_rrdb=2, seed=0, compute_dtype=dtype)
        m.rdb_kernel = False
        return m, None
    if which == "esrgan":
        g = jax_rrdb_graph(scale=4, num_rrdb=2, variant="esrgan")
        return JaxModel("esrgan", 4, g, jax_synthesize(g, seed=3), dtype), None
    sr = jax_model(scale=2, seed=1, compute_dtype=dtype)  # nf 64, 16 convs
    anime = (jax_model(scale=1, num_conv=8, num_feat=24, seed=2,
                       compute_dtype=dtype) if which == "prelude" else None)
    return sr, anime


# step form -> (chain, model family, tile, tta, the step of an engine)
FORMS = {
    "frames": ("", "compact", 0, False, lambda e: e.step),
    "planar": ("", "compact", 0, False, lambda e: e.planar_step),
    "yuv_i420": ("", "compact", 0, False,
                 lambda e: e.yuv_step(True, planar=True, i420_in=(H, W, True))),
    "tiled": ("", "compact", 8, False, lambda e: e.step),
    "tta": ("", "compact", 0, True, lambda e: e.step),
    "prelude": ("a,n=3", "prelude", 0, False, lambda e: e.planar_step),
    "valar": ("r", "valar", 8, False, lambda e: e.step),
    "esrgan": ("sr=x_esrgan", "esrgan", 0, False, lambda e: e.step),
}


def _input(form):
    x = _frames(4, n=1 if form in ("valar", "esrgan", "tta") else 2)
    if form == "yuv_i420":
        packed = yuv420_from_frames(torch.from_numpy(x), True).numpy()
        x = np.stack([packed_to_i420(p, 2) for p in packed])
    return x


def _engines(form, dtype, jdtype):
    """``(make, jax_engine)``: ``make()`` a fresh port engine on the CPU
    (sharing one set of models), and the JAX engine of the same chain."""
    text, family, tile, tta, _ = FORMS[form]
    spec = ChainSpec.parse(text)
    jsr, janime = _jax_models(family, jdtype)
    residual = torch.float32 if family == "valar" and dtype != torch.float32 \
        else None
    sr = _port(jsr, dtype, residual)
    anime = _port(janime, dtype) if janime is not None else None
    scale = jsr.scale

    def make():
        return ChainEngine(spec=spec, scale=scale, sr_model=sr,
                           anime_model=anime, device=CPU, tile=tile, halo=4,
                           tta=tta)

    jeng = JaxEngine(spec=JaxSpec.parse(text), scale=scale, sr_model=jsr,
                     anime_model=janime, tile=tile, halo=4, tta=tta)
    return make, jeng


def _tp(make, n):
    eng = make()
    eng.use_mesh(mesh.make_mesh({"tp": n}, devices=[CPU] * n), "tp")
    return eng


# --- placement ------------------------------------------------------------

@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("family", ["compact", "prelude", "valar", "esrgan"])
def test_shard_params_channelwise_splits_what_jax_does(family, n):
    """Leaf by leaf: a split in JAX's placement (the output-channel axis on
    ``tp``) is the rank's column slice here, a replicated leaf is whole."""
    jsr, janime = _jax_models(family, jnp.float32)
    jm = janime if janime is not None else jsr
    placed = jax_shard(jm.params, jax_mesh.make_mesh({"tp": n}))
    state = _port(jm, torch.float32).state
    shards = shard_params_channelwise(
        state, mesh.make_mesh({"tp": n}, devices=[CPU] * n))
    assert len(shards) == n
    split_any = False
    for name, leaves in placed.items():
        for leaf, arr in leaves.items():
            key = {"weight": "wmat"}.get(leaf, leaf)
            whole = getattr(state[name], key)
            split = "tp" in tuple(arr.sharding.spec)
            split_any |= split
            c = whole.shape[-1] // n
            for r in range(n):
                got = getattr(shards[r][name], key)
                want = whole[..., r * c:(r + 1) * c] if split else whole
                assert torch.equal(got, want), (name, leaf, r)
    assert split_any


# --- tp steps ---------------------------------------------------------------

@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("form", list(FORMS))
def test_tp_step_equals_the_one_entry_forward(form, dtype, n):
    """Bit for bit the same tp forward on a one-entry mesh (every conv
    whole); within the route-swap bound of the single-device ``auto``
    step (K1 chains and K2, or K5, on the plain versions)."""
    make, _ = _engines(form, dtype, jnp.float32)
    get = FORMS[form][4]
    x = torch.from_numpy(_input(form))
    step = get(_tp(make, n))
    assert isinstance(step, ShardedStep)
    got = step(x).numpy()
    one = get(_tp(make, 1))(x).numpy()
    assert got.dtype == np.uint8 and _lsb(got, one) == 0
    auto = get(make())(x).numpy()
    assert _lsb(got, auto) <= SWAP_MAX_LSB and psnr(got, auto) >= SWAP_MIN_DB


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("form", list(FORMS))
def test_tp_step_matches_jax_f32(form, n):
    """Against the JAX package's ``use_chips(.., "tp")`` (GSPMD on its
    host devices): within 1 LSB in f32."""
    make, jeng = _engines(form, torch.float32, jnp.float32)
    chips = ",".join(str(i) for i in range(n))
    jeng.use_chips(chips, mode="tp")
    eng = make()
    eng.use_chips(chips, mode="tp")
    get = FORMS[form][4]
    x = _input(form)
    want = np.asarray(get(jeng)(jnp.asarray(x)))
    assert _lsb(get(eng)(torch.from_numpy(x)).numpy(), want) <= 1


@pytest.mark.parametrize("form", ["frames", "prelude", "valar", "esrgan"])
def test_tp_step_matches_jax_bf16(form):
    """bf16 against JAX's bf16 tp step (its convs on XLA, the port's on
    K4's plain version): within the route-swap bound, as the port's
    ``xla``-against-kernel comparisons."""
    make, jeng = _engines(form, torch.bfloat16, jnp.bfloat16)
    jeng.use_chips("0,1", mode="tp")
    eng = make()
    eng.use_chips("0,1", mode="tp")
    get = FORMS[form][4]
    x = _input(form)
    want = np.asarray(get(jeng)(jnp.asarray(x)))
    got = get(eng)(torch.from_numpy(x)).numpy()
    assert _lsb(got, want) <= SWAP_MAX_LSB and psnr(got, want) >= SWAP_MIN_DB


@pytest.mark.parametrize("form", ["frames", "valar", "esrgan"])
def test_tp_exchange_fills_every_channel(monkeypatch, form):
    """Every full-width output and dense buffer starts as NaN: a channel
    that neither its shard's conv nor the exchange wrote would reach the
    output.  The model-domain output is finite and equals the one-entry
    forward's."""
    def nan_buffer(shape, dtype, device):
        return torch.full(tuple(shape), float("nan"), dtype=dtype,
                          device=device)

    make, _ = _engines(form, torch.bfloat16, jnp.bfloat16)
    x = torch.from_numpy(_input(form))

    def model_out(n):
        eng = _tp(make, n)
        m = eng._tp.sr_model
        return m.frames_forward("model")(m.state, eng._to_model(x))

    want = model_out(1)
    monkeypatch.setattr(executor, "full_width", nan_buffer)
    before = executor.exchange_channels.bytes
    got = model_out(4)
    assert executor.exchange_channels.bytes > before
    assert torch.isfinite(got).all() and torch.equal(got, want)


def test_tp_narrow_model_warns(caplog):
    """As tests/test_parallel.py::test_tp_narrow_model_warns: a model
    under 128 channels per GPU gets the warning when a step is built."""
    make, _ = _engines("frames", torch.float32, jnp.float32)
    eng = make()
    eng.use_chips("0,1,2,3", mode="tp")
    with caplog.at_level(logging.WARNING):
        _ = eng.step
    assert any("--parallel tp" in r.getMessage() for r in caplog.records)


def test_conv_impl_rdb_under_tp_keeps_k5_whole(caplog):
    """``--conv_impl rdb`` under tp warns, plans each Valar dense block as
    one K5 launch (whole on every shard, its packed weights on each) and
    splits the other convs; equal to the one-entry forward."""
    from upscale_video_tpu_torch.models.zoo import make_synthetic_rrdb_model

    sr = make_synthetic_rrdb_model(num_rrdb=2, residual_dtype=torch.float32,
                                   conv_impl="rdb")

    def make():
        return ChainEngine(spec=ChainSpec(real_life=True), scale=4,
                           sr_model=sr, device=CPU, tile=8, halo=4,
                           conv_impl="rdb")

    with caplog.at_level(logging.WARNING):
        eng = _tp(make, 2)
    assert any("conv_impl=rdb under --parallel tp" in r.getMessage()
               for r in caplog.records)
    fwd = eng._tp.sr_model.frames_forward("model")
    assert len(fwd.plan.rdb_triggers) == 6 and not fwd.plan.solos
    assert {"conv_first", "conv_trunk", "conv_up1"} <= fwd.split
    for shard in eng._tp.sr_model.shards:
        for trig in fwd.plan.rdb_triggers:
            assert torch.equal(shard[trig].wpack, sr.state[trig].wpack)
    x = torch.from_numpy(_frames(6, n=1))
    assert _lsb(eng.step(x), _tp(make, 1).step(x)) == 0


def test_tp_takes_every_contract():
    """tp is rank-agnostic: flat I420 input and the full-frame packed
    4:2:0 layout, which sp refuses."""
    make, _ = _engines("frames", torch.bfloat16, jnp.bfloat16)
    eng = make()
    eng.use_chips("0,1", mode="tp")
    assert eng.input_rank_flexible and not eng.row_sharded
    x = torch.from_numpy(_frames(7))
    got = eng.yuv_step(True, planar=False)(x)
    assert _lsb(got, make().yuv_step(True, planar=False)(x)) <= SWAP_MAX_LSB


# --- --tta over tiles under sp ----------------------------------------------

@pytest.mark.parametrize("text,chips,h,w", [
    ("r", "0,1", 19, 12), ("n=3,r", "0,1,2", 20, 14), ("", "0,1,2,3", 26, 18),
])
def test_tta_tiled_under_sp_equals_the_padded_single_step(text, chips, h, w):
    """bf16 on the plain versions: each dihedral pass cut into bands of
    its own tile rows; bit for bit the single step on the frame sp pads
    (``step`` and the PNG plane's ``sr`` stage)."""
    from upscale_video_tpu_torch.models.zoo import (
        make_synthetic_model, make_synthetic_rrdb_model,
    )

    spec = ChainSpec.parse(text)
    sr = (make_synthetic_rrdb_model(num_rrdb=2, residual_dtype=torch.float32)
          if spec.real_life else make_synthetic_model(scale=2, num_conv=4))
    eng = ChainEngine(spec=spec, scale=sr.scale, sr_model=sr, device=CPU,
                      tile=8, halo=4, tta=True)
    x = torch.from_numpy(_frames(8, n=1, h=h, w=w))
    xp, _ = pad_to_multiple(x, len(chips.split(",")), 1)
    want, want_sr = eng.step(xp), eng.stage_fn("sr")(xp)
    s = want.shape[1] // xp.shape[1]
    eng.use_chips(chips, mode="sp")
    assert eng.row_sharded
    assert _lsb(eng.step(x), want[:, :h * s]) == 0
    assert _lsb(eng.stage_fn("sr")(x), want_sr[:, :h * s]) == 0


@pytest.mark.parametrize("chips,h", [("0,1", 14), ("0,1,2", 13)])
def test_tta_tiled_under_sp_matches_jax(chips, h):
    """f32 against JAX's sp (GSPMD partitions its whole tta program):
    within 1 LSB."""
    jm = jax_rrdb(scale=4, num_rrdb=2, seed=0, compute_dtype=jnp.float32)
    jm.rdb_kernel = False
    jeng = JaxEngine(spec=JaxSpec(real_life=True), scale=4, sr_model=jm,
                     tile=8, halo=4, tta=True)
    eng = ChainEngine(spec=ChainSpec(real_life=True), scale=4,
                      sr_model=_port(jm, torch.float32), device=CPU, tile=8,
                      halo=4, tta=True)
    jeng.use_chips(chips, mode="sp")
    eng.use_chips(chips, mode="sp")
    x = _frames(9, n=1, h=h, w=12)
    want = np.asarray(jeng.step(jnp.asarray(x)))
    assert _lsb(eng.step(torch.from_numpy(x)).numpy(), want) <= 1


# --- vsr-warmup-torch -------------------------------------------------------

def _parser_spec(parser):
    return {a.dest: (tuple(a.option_strings), a.default,
                     tuple(a.choices) if a.choices else None, a.required,
                     a.nargs, a.const, getattr(a.type, "__name__", a.type))
            for a in parser._actions if a.dest != "device"}


def test_warmup_parser_equals_jax():
    from upscale_video_tpu.cli import warmup as jax_warmup
    from upscale_video_tpu_torch.cli import warmup

    got = warmup.build_parser()
    assert _parser_spec(got) == _parser_spec(jax_warmup.build_parser())
    assert [a.default for a in got._actions if a.dest == "device"] == ["cuda"]


@pytest.mark.parametrize("mode", ["single", "sp", "tp"])
def test_warmup_contract_equals_jax(mode):
    """Over sizes (odd and even), ``-p``, ``--pipe_pix``, source pixel
    formats and ranges: the same ``(pipe_pix, yuv420, planar, i420_in)``
    as the JAX tool's, on engines of the same chain and mesh."""
    from upscale_video_tpu.cli import warmup as jax_warmup
    from upscale_video_tpu_torch.cli import warmup

    make, jeng = _engines("frames", torch.float32, jnp.float32)
    eng = make()
    if mode != "single":
        jeng.use_chips("0,1", mode=mode)
        eng.use_chips("0,1", mode=mode)
    checked = 0
    for size in ("16x12", "17x12", "16x13", "1920x1080"):
        for pix in ("yuv420p", "yuv444p", "p010le"):
            for pipe in ("auto", "rgb24", "yuv420p"):
                for src in ("yuv420p", "yuvj420p", "yuv444p"):
                    for rng in ("limited", "full"):
                        argv = ["--size", size, "-p", pix, "--pipe_pix", pipe,
                                "--source_pix_fmt", src, "--range", rng]
                        w, h = (int(v) for v in size.split("x"))
                        got = warmup._resolve_contract(
                            warmup.build_parser().parse_args(argv), eng, w, h)
                        want = jax_warmup._resolve_contract(
                            jax_warmup.build_parser().parse_args(argv), jeng,
                            w, h)
                        assert got == want, argv
                        checked += 1
    assert checked == 216


def test_warmup_runs_with_jax_blocked(tmp_path):
    """A meta-path finder refuses ``jax`` and ``upscale_video_tpu``:
    ``vsr-warmup-torch --device cpu`` builds the engine, resolves the
    contract and runs the step once at a small size, for the default chain
    and for ``-m r`` under ``-g 0,1 --parallel tp``."""
    code = textwrap.dedent("""
        import importlib.abc, sys

        BLOCKED = ("jax", "upscale_video_tpu")

        class Block(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path, target=None):
                if any(name == b or name.startswith(b + ".") for b in BLOCKED):
                    raise ImportError(f"blocked import of {name}")
                return None

        sys.meta_path.insert(0, Block())
        from upscale_video_tpu_torch.cli.warmup import main
        assert main(["--device", "cpu", "--synthetic_models",
                     "--size", "16x12"]) == 0
        from upscale_video_tpu_torch.pipeline import chain
        make = chain.make_synthetic_rrdb_model
        chain.make_synthetic_rrdb_model = (
            lambda **kw: make(**{**kw, "num_rrdb": 1}))
        assert main(["--device", "cpu", "--synthetic_models", "--size",
                     "16x12", "-m", "r", "-g", "0,1", "--parallel", "tp",
                     "--tile_size", "8", "--halo", "4"]) == 0
        assert not [m for m in sys.modules if sys.modules[m] is not None
                    and any(m == b or m.startswith(b + ".") for b in BLOCKED)]
        print("OK")
    """)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(REPO), env.get("PYTHONPATH")) if p)
    env["OMP_NUM_THREADS"] = "2"
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=str(tmp_path), env=env, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    out = r.stdout.splitlines()
    assert out[-1] == "OK"
    assert sum(line.startswith("ran step program in") for line in out) == 2
    assert any(line.startswith("contract: yuv420p") for line in out)
