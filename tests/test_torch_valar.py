"""The ``-m r`` slice on the CPU: the port against the JAX package on the
same synthetic RRDBNet graph (2 RRDBs: the random weights of the full
23-RRDB net grow large, tests/test_rdb_pallas.py:336-344) and
byte-identical weights (``params_from_jax``).

Tolerances, each with its reason:

- f32 (the port's generic ops, the JAX XLA f32 path): within 1 u8 LSB
  (PARITY.md's contract; observed 0).
- bf16 and mixed (K5's plain version per dense block against the JAX
  fused RDB kernel in interpret mode): within 1 u8 LSB.  Per-source pieces
  on a bf16 rounding boundary may land one ulp apart (f32 sums in another
  order, tests/test_torch_rdb.py), and the ulp travels to the output.
- The generic ops (conv, Interp, Eltwise, BinaryOp, Concat) and the tiling
  geometry: exact, or within f32 summation order for the convs.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from upscale_video_tpu.models import executor as jax_executor
from upscale_video_tpu.models.executor import build_forward as jax_build_forward
from upscale_video_tpu.models.zoo import make_synthetic_rrdb_model as jax_rrdb_model
from upscale_video_tpu.ops import tiling as jax_tiling
from upscale_video_tpu.ops.yuv import packed_to_i420, yuv420_from_frames
from upscale_video_tpu.pipeline.chain import ChainEngine as JaxEngine
from upscale_video_tpu.pipeline.chain import ChainSpec as JaxSpec
from upscale_video_tpu.pipeline.process import process_file as jax_process
from upscale_video_tpu.video.io import Y4MSink
from upscale_video_tpu_torch.models import ops as port_ops
from upscale_video_tpu_torch.models.executor import GraphForward, build_forward
from upscale_video_tpu_torch.models.param_parser import NcnnLayer
from upscale_video_tpu_torch.models.zoo import (
    make_rrdb_graph, make_synthetic_rrdb_model, params_from_jax,
)
from upscale_video_tpu_torch.ops import tiling
from upscale_video_tpu_torch.ops.rdb import rdb_block
from upscale_video_tpu_torch.pipeline.chain import ChainEngine, ChainSpec
from upscale_video_tpu_torch.pipeline.process import process_file
from tests.torch_fixtures import one_torch_thread, two_rrdbs  # noqa: F401

PRECISIONS = {
    # name: (JAX build_forward kwargs, port compute dtype, port residual dtype)
    "f32": (dict(compute_dtype=jnp.float32), torch.float32, None),
    "bf16": (dict(compute_dtype=jnp.bfloat16, rdb_kernel=True),
             torch.bfloat16, None),
    "mixed": (dict(compute_dtype=jnp.bfloat16, rdb_kernel=True,
                   residual_dtype=jnp.float32), torch.bfloat16, torch.float32),
}


def _u8(y):
    return np.clip(np.round(np.asarray(y, np.float32) * 255.0), 0, 255).astype(int)


def _max_lsb(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    return int(np.abs(a.astype(int) - b.astype(int)).max())


@pytest.fixture(scope="module")
def jax_model():
    return jax_rrdb_model(scale=4, num_rrdb=2, seed=0)


@pytest.mark.parametrize("precision", list(PRECISIONS))
def test_graph_forward_matches_jax(jax_model, precision):
    jkw, cd, rd = PRECISIONS[precision]
    x = np.random.default_rng(1).uniform(0, 1, (2, 10, 14, 3)).astype(np.float32)
    want = np.asarray(jax_build_forward(jax_model.graph, **jkw)(
        jax_model.params, jnp.asarray(x)))
    fwd = build_forward(make_rrdb_graph(num_rrdb=2), "cpu", cd, "model", rd)
    assert isinstance(fwd, GraphForward)
    assert len(fwd.rdb_triggers) == (0 if cd == torch.float32 else 6)
    state = params_from_jax(jax_model.params, "cpu", cd)
    fwd.prepare(state)
    before = rdb_block.launches
    got = fwd(state, torch.from_numpy(x))
    assert rdb_block.launches == before  # the CPU runs the plain version
    assert got.dtype == torch.float32 and got.shape == (2, 40, 56, 3)
    assert _max_lsb(_u8(got.numpy()), _u8(want)) <= 1


def test_mixed_spine_stays_f32_and_equals_jax(jax_model, monkeypatch):
    """``mixed`` upcasts at the residual adds only, and the combine results
    flow on in f32: every RRDB combine and the trunk add come out f32 in
    both packages, with equal values (within K5's piece-rounding ulps,
    carried through at most 6 dense blocks)."""
    seen = {"port": {}, "jax": {}}

    def spy(table, op, key):
        def run(layer, inputs, p, compute_dtype):
            out = op(layer, inputs, p, compute_dtype)
            if layer.name.startswith("r") and layer.name.endswith("_res") \
                    and "d" not in layer.name or layer.name == "trunk_add":
                seen[key][layer.name] = out
            return out
        return run

    for name in ("Eltwise", "BinaryOp"):
        monkeypatch.setitem(port_ops.OP_REGISTRY, name,
                            spy(port_ops.OP_REGISTRY, port_ops.OP_REGISTRY[name], "port"))
        monkeypatch.setitem(jax_executor.OP_REGISTRY, name,
                            spy(jax_executor.OP_REGISTRY,
                                jax_executor.OP_REGISTRY[name], "jax"))
    jkw, cd, rd = PRECISIONS["mixed"]
    x = np.random.default_rng(2).uniform(0, 1, (1, 9, 12, 3)).astype(np.float32)
    jax_build_forward(jax_model.graph, **jkw)(jax_model.params, jnp.asarray(x))
    fwd = build_forward(make_rrdb_graph(num_rrdb=2), "cpu", cd, "model", rd)
    state = params_from_jax(jax_model.params, "cpu", cd)
    fwd.prepare(state)
    fwd(state, torch.from_numpy(x))
    assert sorted(seen["port"]) == sorted(seen["jax"]) == \
        ["r0_res", "r1_res", "trunk_add"]
    for name, t in seen["port"].items():
        want = np.asarray(seen["jax"][name])
        assert t.dtype == torch.float32 and want.dtype == np.float32, name
        np.testing.assert_allclose(t.numpy(), want, rtol=2 ** -7, atol=2 ** -5)


@pytest.mark.parametrize("attrs,hw", [
    ({0: 1, 1: 1.5, 2: 1.5}, (6, 10)),      # non-integer scale: floor map
    ({0: 1, 1: 2.0, 2: 3.0}, (5, 7)),       # integer scales: repeat
    ({0: 1, 3: 7, 4: 11}, (5, 7)),          # fixed output size
    ({0: 0, 1: 2.5, 2: 1.25}, (4, 8)),
])
def test_nearest_interp_equals_jax(attrs, hw):
    layer = NcnnLayer("Interp", "up", ["a"], ["b"], attrs)
    x = np.random.default_rng(3).normal(0, 1, (2, *hw, 3)).astype(np.float32)
    want = np.asarray(jax_executor._op_interp(layer, [jnp.asarray(x)], {}, jnp.float32))
    got = port_ops.op_interp(layer, [torch.from_numpy(x)], None, torch.float32)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_generic_ops_equal_jax(dtype):
    """Eltwise with coefficients (bf16 coefficients on bf16 operands),
    BinaryOp, Eltwise max, Concat, and the 3x3 and 1x1 generic convs (the
    graph walk's route for convs outside its kernel plans) with bias and
    leaky activation, one rounding each."""
    jd, td = (jnp.float32, torch.float32) if dtype == "f32" else \
        (jnp.bfloat16, torch.bfloat16)
    rng = np.random.default_rng(4)
    a = rng.normal(0, 1, (1, 5, 6, 8)).astype(np.float32)
    b = rng.normal(0, 1, (1, 5, 6, 8)).astype(np.float32)
    ja, jb = jnp.asarray(a, jd), jnp.asarray(b, jd)
    ta, tb = torch.from_numpy(a).to(td), torch.from_numpy(b).to(td)

    def same(got, want, tol=0.0):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want).astype(np.float32),
                                   rtol=tol, atol=tol)

    for attrs in ({0: 1, 1: [0.2, 1.0]}, {0: 1, 1: [0.5, 1.5]}, {0: 1}):
        elt = NcnnLayer("Eltwise", "e", ["a", "b"], ["c"], attrs)
        same(port_ops.op_eltwise(elt, [ta, tb], None, td),
             jax_executor._op_eltwise(elt, [ja, jb], {}, jd))
    add = NcnnLayer("BinaryOp", "o", ["a", "b"], ["c"], {0: 0})
    same(port_ops.op_binaryop(add, [ta, tb], None, td),
         jax_executor._op_binaryop(add, [ja, jb], {}, jd))
    for layer in (NcnnLayer("BinaryOp", "o", ["a", "b"], ["c"], {0: 2}),
                  NcnnLayer("Eltwise", "e", ["a", "b"], ["c"], {0: 2})):
        same(port_ops.OP_REGISTRY[layer.type](layer, [ta, tb], None, td),
             jax_executor.OP_REGISTRY[layer.type](layer, [ja, jb], {}, jd))
    cat = NcnnLayer("Concat", "k", ["a", "b"], ["c"], {0: 0})
    same(port_ops.op_concat(cat, [ta, tb], None, td),
         jax_executor._op_concat(cat, [ja, jb], {}, jd))
    for k, pad, cout in ((3, 1, 12), (1, 0, 5)):
        attrs = {0: cout, 1: k, 4: pad, 5: 1, 6: cout * 8 * k * k, 9: 2,
                 10: [0.2]}
        conv = NcnnLayer("Convolution", "cv", ["a"], ["c"], attrs)
        p = {"weight": rng.normal(0, 0.2, (k, k, 8, cout)).astype(np.float32),
             "bias": rng.normal(0, 0.1, (cout,)).astype(np.float32)}
        state = params_from_jax({"cv": p}, "cpu", td)
        got = port_ops.op_convolution(conv, [ta], state["cv"], td)
        want = jax_executor._op_convolution(
            conv, [ja], {k_: jnp.asarray(v) for k_, v in p.items()}, jd)
        assert got.dtype == td
        # f32: summation order; bf16: the one rounding may land an ulp apart
        same(got, want, 1e-5 if dtype == "f32" else 2 ** -7)


@pytest.mark.parametrize("hw,budget", [((1080, 1920), 544), ((1080, 1920), 480),
                                       ((2160, 3840), 544), ((37, 53), 16),
                                       ((1000, 1020), 480), ((20, 24), 16)])
def test_fit_tile_grid_equals_jax(hw, budget):
    assert tiling.fit_tile_grid(*hw, budget) == jax_tiling.fit_tile_grid(*hw, budget)


def test_fit_tile_grid_1080p_default():
    assert tiling.fit_tile_grid(1080, 1920, 544) == (544, 480)


@pytest.mark.parametrize("tile,halo,scale", [((16, 16), 4, 4), ((8, 24), 3, 2),
                                             ((544, 480), 16, 1)])
def test_tiled_apply_geometry_equals_jax(tile, halo, scale):
    """Same tiles, padding and scaled-halo crop (a 4x edge tile padded out
    of the frame included): a position-dependent ``fn`` gives the same
    bytes in both packages."""
    h, w = (37, 53) if tile[0] < 100 else (1080, 600)
    img = np.random.default_rng(5).normal(0, 1, (h, w, 3)).astype(np.float32)

    def tfn(t):
        t = t + torch.roll(t, 1, dims=1) + 2 * torch.roll(t, 1, dims=2)
        return t.repeat_interleave(scale, 1).repeat_interleave(scale, 2)

    def jfn(t):
        t = t + jnp.roll(t, 1, axis=1) + 2 * jnp.roll(t, 1, axis=2)
        return jnp.repeat(jnp.repeat(t, scale, 1), scale, 2)

    want = np.asarray(jax_tiling.tiled_apply(jfn, jnp.asarray(img), tile, halo, scale))
    got = tiling.tiled_apply(tfn, torch.from_numpy(img), tile, halo, scale)
    assert got.shape == (h * scale, w * scale, 3)
    np.testing.assert_array_equal(got.numpy(), want)
    chunked = tiling.tiled_apply(tfn, torch.from_numpy(img), tile, halo, scale,
                                 tiles_per_step=3)
    np.testing.assert_array_equal(chunked.numpy(), want)


def _engines(precision, tile=16, halo=4):
    jkw, cd, rd = PRECISIONS[precision]
    jd = jkw["compute_dtype"]
    jm = jax_rrdb_model(scale=4, num_rrdb=2, seed=0, compute_dtype=jd)
    jm.rdb_kernel = jkw.get("rdb_kernel", False)
    jm.residual_dtype = jkw.get("residual_dtype")
    jeng = JaxEngine(spec=JaxSpec(real_life=True), scale=4, sr_model=jm,
                     tile=tile, halo=halo)
    pm = make_synthetic_rrdb_model(scale=4, num_rrdb=2, seed=0,
                                   compute_dtype=cd, residual_dtype=rd)
    peng = ChainEngine(spec=ChainSpec(real_life=True), scale=4, sr_model=pm,
                       device=torch.device("cpu"), tile=tile, halo=halo)
    return jeng, peng


@pytest.fixture(scope="module")
def engines():
    return {p: _engines(p) for p in ("f32", "mixed")}


@pytest.mark.parametrize("precision", ["f32", "mixed"])
def test_engine_step_matches_jax(engines, precision):
    jeng, peng = engines[precision]
    x = np.random.default_rng(6).integers(0, 256, (1, 20, 24, 3), dtype=np.uint8)
    assert peng.planar_scale is None and jeng.planar_scale is None
    want = np.asarray(jeng.step(jnp.asarray(x)))
    got = peng.step(torch.from_numpy(x)).numpy()
    assert got.shape == (1, 80, 96, 3) and got.dtype == np.uint8
    assert _max_lsb(got, want) <= 1


@pytest.mark.parametrize("i420", [False, True])
def test_engine_yuv_step_matches_jax(engines, i420):
    jeng, peng = engines["f32"]
    rng = np.random.default_rng(7)
    if i420:
        x = rng.integers(0, 256, (1, 20 * 24 * 3 // 2), dtype=np.uint8)
        i420_in = (20, 24, True)
    else:
        x = rng.integers(0, 256, (1, 20, 24, 3), dtype=np.uint8)
        i420_in = None
    want = np.asarray(jeng.yuv_step(True, planar=False, i420_in=i420_in)(jnp.asarray(x)))
    got = peng.yuv_step(True, planar=False, i420_in=i420_in)(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (1, 40, 48, 6)
    assert _max_lsb(got, want) <= 1


def test_engine_build_defaults_for_m_r():
    """``-m r`` takes the JAX defaults: 4x, tile budget 544, halo 16, and
    the 23-RRDB Valar stand-in (69 dense blocks) — planned, not run."""
    eng = ChainEngine.build(ChainSpec.parse("r"), 2, "cpu", synthetic=True,
                            residual_dtype=torch.float32)
    assert (eng.scale, eng.tile, eng.halo) == (4, 544, 16)
    assert eng.describe() == "valar-4x (scale 4x)"
    assert eng.planar_scale is None
    assert len(eng.sr_model.frames_forward("model").rdb_triggers) == 69
    from upscale_video_tpu_torch.models.executor import SRVGGForward

    # sr= with --synthetic_models builds the Compact: mixed runs on K1 + K2
    # (K2's skip add is f32 already), and reaches the anime model's adds
    for models in ("a,sr=x_Foo", None):
        mixed = ChainEngine.build(ChainSpec.parse(models), 2, "cpu",
                                  synthetic=True, residual_dtype=torch.float32)
        assert isinstance(mixed.sr_model.frames_forward("planar"), SRVGGForward)
        assert mixed.planar_scale == 2 and mixed.tile == 0
    assert mixed.sr_model.residual_dtype == torch.float32


N_FRAMES, H, W = 3, 12, 16


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
    with open(path, "rb") as f:
        header, _, body = f.read().partition(b"\n")
    return header, np.stack([np.frombuffer(c, np.uint8)
                             for c in body.split(b"FRAME\n")[1:]])


@pytest.mark.parametrize("c420", [False, True], ids=["c444", "c420jpeg"])
def test_process_file_m_r_matches_jax(tmp_path, engines, c420):
    """``process_file -m r`` with a 2-RRDB model injected into both
    packages (the JAX 23-RRDB f32 compile is too slow for the CPU suite):
    same contract, same work-dir files, frames within 1 LSB in f32."""
    jeng, peng = engines["f32"]
    src = str(tmp_path / "in.y4m")
    _write_clip(src, c420)
    runs = {}
    for name, runner, eng, kw in (("jax", jax_process, jeng, {}),
                                  ("port", process_file, peng,
                                   {"device": "cpu"})):
        out = str(tmp_path / f"{name}.y4m")
        work = tmp_path / f"work_{name}"
        res = runner(src, out, temp_dir=str(work), batch_size=-2, models="r",
                     resume_processing=True, engine=eng, **kw)
        runs[name] = (out, res, sorted(os.listdir(work / "upscale_video")))
    (jout, jres, jfiles), (pout, pres, pfiles) = runs["jax"], runs["port"]
    assert pres.pipe_pix == jres.pipe_pix == ("yuv420p" if c420 else "rgb24")
    assert pres.frames_processed == jres.frames_processed == N_FRAMES
    assert pfiles == jfiles and "completed.txt" in pfiles
    jh, jframes = _raw(jout)
    ph, pframes = _raw(pout)
    assert ph == jh and b"W64 H48" in ph
    assert _max_lsb(pframes, jframes) <= 1


def test_cli_m_r_runs_on_cpu(tmp_path):
    """``upscale-video-torch -m r --synthetic_models`` end to end on the
    CPU: the 23-RRDB stand-in, mixed, tiled; 4x geometry, every frame."""
    from upscale_video_tpu_torch.cli.upscale_video import main as cli_main

    src = str(tmp_path / "in.y4m")
    _write_clip(src, c420=True)
    out = str(tmp_path / "out.y4m")
    assert cli_main(["-i", src, "-o", out, "-t", str(tmp_path / "t"), "-m", "r",
                     "--synthetic_models", "--device", "cpu"]) == 0
    header, frames = _raw(out)
    assert b"W64 H48" in header and b"C420jpeg" in header
    assert frames.shape == (N_FRAMES, 64 * 48 * 3 // 2)


def test_dense_block_weights_packed_at_plan_time():
    """Building a model's RRDBNet forward packs each dense block's K5
    weights into its state once; the forward only reads them, and a state
    that was never packed is refused, not packed inside the walk."""
    m = make_synthetic_rrdb_model(num_rrdb=1, seed=0)
    fwd = m.frames_forward("model")
    assert len(fwd.rdb_triggers) == 3
    assert all(name in m.state for name in fwd.rdb_triggers)
    packed = dict(m.state.named_buffers())
    x = torch.rand(1, 6, 8, 3)
    m(x, "model")
    assert dict(m.state.named_buffers()).keys() == packed.keys()
    fresh = make_synthetic_rrdb_model(num_rrdb=1, seed=0)
    with pytest.raises(RuntimeError, match="prepare"):
        fwd(fresh.state, x)


def test_load_model_valar_role(tmp_path):
    """``load_model("valar", 4, ...)`` reads ``4x_Valar_v1.param/.bin``
    through ``MODEL_FILES`` and plans the RRDBNet forward (here a 1-RRDB
    graph written with the JAX package's emitters; fp16 storage)."""
    from upscale_video_tpu.models import bin_loader as jax_bin
    from upscale_video_tpu.models import param_parser as jax_pp
    from upscale_video_tpu.models.zoo import make_rrdb_graph as jax_rrdb_graph
    from upscale_video_tpu_torch.models.zoo import load_model

    g = jax_rrdb_graph(num_rrdb=1)
    (tmp_path / "4x_Valar_v1.param").write_text(jax_pp.emit_param(g))
    (tmp_path / "4x_Valar_v1.bin").write_bytes(
        jax_bin.emit_bin(g, jax_bin.synthesize_weights(g, seed=5)))
    m = load_model("valar", 4, "cpu", str(tmp_path),
                   residual_dtype=torch.float32)
    assert m.name == "4x_Valar_v1" and m.planar_scale is None
    fwd = m.frames_forward("model")
    assert isinstance(fwd, GraphForward) and len(fwd.rdb_triggers) == 3
    y = m(torch.rand(1, 6, 8, 3), "model")
    assert y.shape == (1, 24, 32, 3) and bool(torch.isfinite(y).all())


# --- --conv_impl on -m r ----------------------------------------------------

ROUTE_JAX = {
    # conv_impl: JAX build_forward kwargs (its ChainEngine.build mapping)
    "xla": dict(pallas_conv=False, rdb_kernel=False),
    "rdb": dict(pallas_conv=False, rdb_kernel=True),
    "pallas": dict(pallas_conv=True, rdb_kernel=False),
}


@pytest.mark.parametrize("impl,precision", [
    ("xla", "bf16"), ("xla", "f32"), ("rdb", "mixed"), ("pallas", "bf16"),
    ("pallas", "mixed"),
])
def test_conv_impl_routes_match_jax(jax_model, impl, precision):
    """Each ``--conv_impl`` plans what the JAX package runs for it, and
    matches it on the 2-RRDB graph: ``xla`` no kernel (every conv a
    generic ``F.conv2d``), ``rdb`` K5 alone, ``pallas`` no K5 but every
    dense conv on K4 over one 192-channel buffer per block.  Against JAX
    ``build_forward`` with the same route (Pallas in interpret mode):
    within 1 u8 LSB, the tolerance of the ``sr=`` ESRGAN test; in f32 the
    aten route equals JAX's XLA f32 within 1 LSB (observed 0)."""
    jd = jnp.float32 if precision == "f32" else jnp.bfloat16
    td = torch.float32 if precision == "f32" else torch.bfloat16
    rd = torch.float32 if precision == "mixed" else None
    x = np.random.default_rng(30).uniform(0, 1, (1, 12, 16, 3)).astype(np.float32)
    want = np.asarray(jax_build_forward(
        jax_model.graph, compute_dtype=jd, residual_dtype=(
            jnp.float32 if precision == "mixed" else None),
        **ROUTE_JAX[impl])(jax_model.params, jnp.asarray(x)))
    fwd = build_forward(make_rrdb_graph(num_rrdb=2), "cpu", td, "model", rd,
                        conv_impl=impl)
    assert len(fwd.rdb_triggers) == (6 if impl == "rdb" else 0)
    assert len(fwd.dense) == (30 if impl == "pallas" else 0)
    assert len(fwd.solos) == (33 if impl == "pallas" else 0)
    assert len(fwd.chains) == (1 if impl == "pallas" else 0)
    state = params_from_jax(jax_model.params, "cpu", td)
    fwd.prepare(state)
    got = fwd(state, torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (1, 48, 64, 3)
    assert _max_lsb(_u8(got.numpy()), _u8(want)) <= 1


@pytest.mark.parametrize("residual", [None, torch.float32], ids=["bf16", "mixed"])
def test_pallas_dense_buffer_equals_the_concat_path(monkeypatch, residual):
    """Under ``pallas`` each Valar dense block runs on one buffer: x, then
    c1, the add c2 = conv + conv1x1(x) written over its conv's channels,
    c3, the add c4 = conv + c2 likewise; c5 reads all 192 channels.  Bit
    for bit the forward with its Concats (the planner switched off), and
    no Concat of a block runs."""
    from upscale_video_tpu_torch.models import executor

    g = make_rrdb_graph(num_rrdb=1)
    m = make_synthetic_rrdb_model(num_rrdb=1, seed=3, residual_dtype=residual)
    x = torch.rand(1, 9, 13, 3, generator=torch.Generator().manual_seed(4))
    fwd = build_forward(g, "cpu", torch.bfloat16, "model", residual,
                        conv_impl="pallas")
    plans = [fwd.dense[f"r0d0_c{k}"] for k in (1, 4, 9, 12, 16)]
    assert [(p["cin"], p["out_off"], p["post_add"]) for p in plans] == [
        (64, 64, None), (96, 96, "r0d0_a7"), (128, 128, None),
        (160, 160, "r0d0_a14"), (192, None, None)]
    cats = {"n": 0}
    concat = port_ops.OP_REGISTRY["Concat"]

    def counted(*a):
        cats["n"] += 1
        return concat(*a)

    monkeypatch.setitem(port_ops.OP_REGISTRY, "Concat", counted)
    fwd.prepare(m.state)
    got = fwd(m.state, x)
    assert cats["n"] == 0
    monkeypatch.setattr(executor, "_plan_dense_buffers", lambda *a: ({}, set()))
    ref = build_forward(g, "cpu", torch.bfloat16, "model", residual,
                        conv_impl="pallas")
    assert ref.dense == {} and len(ref.solos) == 15 + 3
    want = ref(m.state, x)
    assert cats["n"] == 12
    assert torch.equal(got, want)


@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_routes_agree_with_the_default_route(impl):
    """``-m r`` at 2 RRDBs, mixed, one 32x48 frame tiled at 16: the
    ``pallas`` (K4 dense buffers) and ``xla`` (generic convs) routes
    against ``auto`` (K5): above 50 dB and within 4 LSB, chip_smoke.py's
    bound for 2 RRDBs on the plain versions (measured here: 2 LSB,
    57.1 dB at 64x96)."""
    from upscale_video_tpu_torch.ops.pixel import psnr

    x = torch.from_numpy(np.random.default_rng(32).integers(
        0, 256, (1, 32, 48, 3), dtype=np.uint8))
    outs = {}
    for name in ("auto", impl):
        m = make_synthetic_rrdb_model(num_rrdb=2, residual_dtype=torch.float32,
                                      conv_impl=name)
        eng = ChainEngine(spec=ChainSpec(real_life=True), scale=4, sr_model=m,
                          device=torch.device("cpu"), tile=16, halo=4)
        outs[name] = eng.step(x).numpy()
    assert _max_lsb(outs[impl], outs["auto"]) <= 4
    assert psnr(outs[impl], outs["auto"]) >= 50.0


def test_engine_conv_impl_reaches_the_models_and_denoise(monkeypatch, two_rrdbs):
    """``ChainEngine.build(conv_impl=...)`` plans the anime and SR models on
    that route; NL-means runs K6's wrapper unless ``xla`` or ``rdb``, which
    run its plain version (the JAX package runs its kernel only under
    ``pallas``)."""
    from upscale_video_tpu_torch.ops import nlmeans
    from upscale_video_tpu_torch.pipeline import chain

    calls = []
    monkeypatch.setattr(chain, "nl_means_denoise",
                        lambda x, h: calls.append("k6") or x)
    monkeypatch.setattr(chain, "nl_means_denoise_plain",
                        lambda x, h: calls.append("plain") or x)
    x = torch.from_numpy(np.random.default_rng(31).integers(
        0, 256, (1, 8, 12, 3), dtype=np.uint8))
    for impl, want in (("auto", "k6"), ("pallas", "k6"), ("rdb", "plain"),
                       ("xla", "plain")):
        eng = ChainEngine.build(ChainSpec.parse("a,n=3,r"), 4, "cpu",
                                synthetic=True, conv_impl=impl, tile=8, halo=2)
        calls.clear()
        eng._denoise(eng._to_model(x))
        assert calls == [want]
        afwd = eng.anime_model.frames_forward("model")
        vfwd = eng.sr_model.frames_forward("model")
        assert bool(afwd.chains) is (impl in ("auto", "pallas"))
        assert len(vfwd.rdb_triggers) == (6 if impl in ("auto", "rdb") else 0)
        assert bool(vfwd.dense) is (impl == "pallas")
    assert nlmeans.nl_means_denoise.launches == 0
