"""The whole SR stage of the slice on the CPU: the port against the JAX
executor, on the same synthetic graph and byte-identical weights
(``params_from_jax``).  bf16 takes the port's kernel route (K1 + K2 plain
versions under the planned SRVGG forward); f32 takes its aten route (the
generic graph walk, as the JAX package demotes its kernels under f32).

- bf16: the kernel route against the JAX Pallas path (``pallas_conv=True``
  / ``conv_impl="pallas"``, run in interpret mode), which rounds at the
  same points (once per conv, after bias and activation): within 1 u8
  LSB, in the frame, planar and 4:2:0 layouts and through the engine
  steps.  The JAX Pallas path has no planar layout, so the port's planar
  bytes are interleaved on the host (``planar_to_frames``) and held to its
  frames; its packed 4:2:0 step (``planar=False``) has the byte layout of
  the planar one at scale 2.
- f32: the aten route against the JAX XLA path in f32 (``build_forward``
  with ``planar_tail=True``, and the JAX ``ChainEngine``'s planar and
  4:2:0 steps): within 1 u8 LSB, the PARITY.md contract.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from upscale_video_tpu.models.executor import build_forward as jax_build_forward
from upscale_video_tpu.models.zoo import make_synthetic_model as jax_model
from upscale_video_tpu.ops.pixel import frames_to_model as jax_frames_to_model
from upscale_video_tpu.pipeline.chain import ChainEngine as JaxEngine
from upscale_video_tpu.pipeline.chain import ChainSpec as JaxSpec
from upscale_video_tpu_torch.models.executor import (
    SRVGGForward, build_forward, plan_srvgg, probe_srvgg_tail,
)
from upscale_video_tpu_torch.models.zoo import (
    make_srvgg_graph, params_from_jax,
)
from upscale_video_tpu_torch.ops.pixel import frames_to_model, planar_to_frames
from upscale_video_tpu_torch.pipeline.chain import ChainEngine, ChainSpec
from tests.torch_fixtures import one_torch_thread  # noqa: F401


def _max_lsb(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype == np.uint8
    return int(np.abs(a.astype(int) - b.astype(int)).max())


def _frames(seed, n=2, h=16, w=24):
    return np.random.default_rng(seed).integers(0, 256, (n, h, w, 3),
                                                dtype=np.uint8)


def _port_out(model, frames, dtype, emit):
    state = params_from_jax(model.params, "cpu", dtype)
    fwd = build_forward(model.graph, "cpu", dtype, emit)
    return fwd(state, frames_to_model(torch.from_numpy(frames))).numpy()


@pytest.mark.parametrize("num_conv", [3, 16])
def test_f32_planar_matches_jax_xla(num_conv):
    """(a) 3-conv and (c) full-depth Compact, num_feat 64, f32 (the aten
    route)."""
    m = jax_model(scale=2, num_conv=num_conv, num_feat=64, seed=7)
    frames = _frames(1)
    jf = jax_build_forward(m.graph, jnp.float32, emit_frames=True,
                           planar_tail=True)
    assert jf.planar_scale == 2
    want = np.asarray(jf(m.params, jax_frames_to_model(jnp.asarray(frames))))
    got = _port_out(m, frames, torch.float32, "planar")
    assert _max_lsb(got, want) <= 1


@pytest.mark.parametrize("num_conv", [3, 16])
def test_bf16_planar_matches_jax_pallas_path(num_conv):
    """The f32 test's twin on the kernel route: K2's planar layout in
    bf16, interleaved on the host, against the JAX Pallas path's frames."""
    m = jax_model(scale=2, num_conv=num_conv, num_feat=64, seed=7)
    frames = _frames(1)
    jf = jax_build_forward(m.graph, jnp.bfloat16, pallas_conv=True,
                           emit_frames=True)
    want = np.asarray(jf(m.params, jax_frames_to_model(jnp.asarray(frames))))
    state = params_from_jax(m.params, "cpu", torch.bfloat16)
    fwd = build_forward(m.graph, "cpu", torch.bfloat16, "planar")
    assert isinstance(fwd, SRVGGForward)
    got = fwd(state, frames_to_model(torch.from_numpy(frames))).numpy()
    assert got.shape == (2, 16, 24, 12)
    assert _max_lsb(planar_to_frames(got, 2), want) <= 1


def test_bf16_frames_match_jax_pallas_path():
    """(b) bf16 against the JAX kernel path (conv chain + fused tail)."""
    m = jax_model(scale=2, num_conv=3, num_feat=64, seed=8)
    frames = _frames(2)
    jf = jax_build_forward(m.graph, jnp.bfloat16, pallas_conv=True,
                           emit_frames=True)
    want = np.asarray(jf(m.params, jax_frames_to_model(jnp.asarray(frames))))
    got = _port_out(m, frames, torch.bfloat16, "frames")
    assert _max_lsb(got, want) <= 1


def test_model_layouts_agree():
    """The port's ``Model`` (an nn.Module) emits the same image in its f32
    model-domain, u8 frame and u8 planar layouts: on the kernel route in
    bf16 (K2's three epilogues), and on the aten route in f32 (which makes
    its planar layout from its frames)."""
    from upscale_video_tpu_torch.models.executor import GraphForward
    from upscale_video_tpu_torch.models.zoo import make_synthetic_model

    x = frames_to_model(torch.from_numpy(_frames(3, n=1, h=10, w=12)))
    for dtype, route in ((torch.bfloat16, SRVGGForward),
                         (torch.float32, GraphForward)):
        m = make_synthetic_model(scale=2, num_conv=2, num_feat=16, seed=9,
                                 compute_dtype=dtype)
        # 3 body convs + the tail conv (wmat, bias) and 3 PReLU slopes
        assert sum(1 for _ in m.buffers()) == 2 * 4 + 3
        assert all(isinstance(m.frames_forward(e), route)
                   for e in ("model", "frames", "planar"))
        y = m(x, "model").numpy()
        u8 = m(x, "frames").numpy()
        q = np.clip(np.round(y[..., ::-1] * 255.0), 0, 255).astype(np.uint8)
        np.testing.assert_array_equal(q, u8)
        np.testing.assert_array_equal(
            planar_to_frames(m(x, "planar").numpy(), 2), u8)


def test_plan_covers_compact_graph():
    plan = plan_srvgg(make_srvgg_graph(scale=2, num_conv=16, num_feat=64))
    assert len(plan["items"]) == 17
    assert all(it["prelu"] is not None for it in plan["items"])
    assert plan["tail"]["scale"] == 2 and plan["tail"]["conv"] == "conv_up"
    assert probe_srvgg_tail(make_srvgg_graph(scale=4)) == 4


def test_plan_rejects_other_graphs():
    from upscale_video_tpu.models.zoo import make_rrdb_graph

    with pytest.raises(NotImplementedError, match="Concat"):
        plan_srvgg(make_rrdb_graph(num_rrdb=1))


@pytest.fixture(scope="module")
def engines():
    """f32: the port's aten route against the JAX engine's XLA path."""
    jax_eng = JaxEngine.build(JaxSpec(), 2, compute_dtype=jnp.float32,
                              synthetic=True)
    port = ChainEngine.build(ChainSpec(), 2, "cpu",
                             compute_dtype=torch.float32, synthetic=True)
    return jax_eng, port


def test_planar_step_matches_jax(engines):
    jax_eng, port = engines
    frames = _frames(4)
    assert port.planar_scale == jax_eng.planar_scale == 2
    want = np.asarray(jax_eng.planar_step(jnp.asarray(frames)))
    got = port.planar_step(torch.from_numpy(frames)).numpy()
    assert _max_lsb(got, want) <= 1


def test_full_frame_step_matches_jax(engines):
    jax_eng, port = engines
    frames = _frames(6)
    want = np.asarray(jax_eng.step(jnp.asarray(frames)))
    got = port.step(torch.from_numpy(frames)).numpy()
    assert got.shape == (2, 32, 48, 3)
    assert _max_lsb(got, want) <= 1


@pytest.mark.parametrize("full_range", [True, False])
@pytest.mark.parametrize("i420", [False, True])
def test_yuv_step_matches_jax(engines, full_range, i420):
    """(d) the 4:2:0 contract, from RGB frames and from flat I420."""
    jax_eng, port = engines
    if i420:
        rng = np.random.default_rng(5)
        x = rng.integers(0, 256, (2, 16 * 24 * 3 // 2), dtype=np.uint8)
        i420_in = (16, 24, full_range)
    else:
        x = _frames(5)
        i420_in = None
    want = np.asarray(jax_eng.yuv_step(full_range, planar=True,
                                       i420_in=i420_in)(jnp.asarray(x)))
    got = port.yuv_step(full_range, planar=True,
                        i420_in=i420_in)(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 16, 24, 6)
    assert _max_lsb(got, want) <= 1


@pytest.fixture(scope="module")
def kernel_engines():
    """The engine tests' twins on the kernel route: bf16, the JAX engine on
    its Pallas path."""
    jax_eng = JaxEngine.build(JaxSpec(), 2, compute_dtype=jnp.bfloat16,
                              synthetic=True, conv_impl="pallas")
    port = ChainEngine.build(ChainSpec(), 2, "cpu",
                             compute_dtype=torch.bfloat16, synthetic=True)
    assert isinstance(port.sr_model.frames_forward("planar"), SRVGGForward)
    return jax_eng, port


def test_bf16_planar_step_matches_jax_pallas(kernel_engines):
    jax_eng, port = kernel_engines
    frames = _frames(4)
    assert port.planar_scale == 2
    want = np.asarray(jax_eng.step(jnp.asarray(frames)))
    got = port.planar_step(torch.from_numpy(frames)).numpy()
    assert _max_lsb(planar_to_frames(got, 2), want) <= 1


def test_bf16_full_frame_step_matches_jax_pallas(kernel_engines):
    jax_eng, port = kernel_engines
    frames = _frames(6)
    want = np.asarray(jax_eng.step(jnp.asarray(frames)))
    got = port.step(torch.from_numpy(frames)).numpy()
    assert got.shape == (2, 32, 48, 3)
    assert _max_lsb(got, want) <= 1


@pytest.mark.parametrize("full_range", [True, False])
@pytest.mark.parametrize("i420", [False, True])
def test_bf16_yuv_step_matches_jax_pallas(kernel_engines, full_range, i420):
    """K2's 4:2:0 epilogue (the planar step's), from RGB frames and from
    flat I420, against the JAX Pallas path's packed 4:2:0 step."""
    jax_eng, port = kernel_engines
    if i420:
        rng = np.random.default_rng(5)
        x = rng.integers(0, 256, (2, 16 * 24 * 3 // 2), dtype=np.uint8)
        i420_in = (16, 24, full_range)
    else:
        x = _frames(5)
        i420_in = None
    want = np.asarray(jax_eng.yuv_step(full_range, planar=False,
                                       i420_in=i420_in)(jnp.asarray(x)))
    got = port.yuv_step(full_range, planar=True,
                        i420_in=i420_in)(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 16, 24, 6)
    assert _max_lsb(got, want) <= 1


# --- the flags: --conv_impl xla, f32, --tile_size and mixed on Compact ------

def _jax_engine(precision, **kw):
    jd = jnp.float32 if precision == "f32" else jnp.bfloat16
    return JaxEngine.build(JaxSpec.parse(kw.pop("models", None)), 2,
                           compute_dtype=jd, synthetic=True,
                           residual_dtype=(jnp.float32 if precision == "mixed"
                                           else None), **kw)


def _port_engine(precision, **kw):
    pd = torch.float32 if precision == "f32" else torch.bfloat16
    return ChainEngine.build(ChainSpec.parse(kw.pop("models", None)), 2, "cpu",
                             compute_dtype=pd, synthetic=True,
                             residual_dtype=(torch.float32 if precision == "mixed"
                                             else None), **kw)


@pytest.mark.parametrize("precision", ["bf16", "f32"])
def test_xla_route_matches_jax_xla(precision):
    """``--conv_impl xla``: the aten graph walk (no chain, no K3 tail; the
    planar layout made from the quantized frames) against the JAX XLA path
    (``pallas_conv=False, rdb_kernel=False``) on the same graph and
    weights, planar and frames: within 1 u8 LSB in bf16 and in f32."""
    from upscale_video_tpu_torch.models.executor import GraphForward

    jd = jnp.float32 if precision == "f32" else jnp.bfloat16
    td = torch.float32 if precision == "f32" else torch.bfloat16
    m = jax_model(scale=2, num_conv=4, num_feat=64, seed=10)
    frames = _frames(20)
    state = params_from_jax(m.params, "cpu", td)
    for emit, planar in (("planar", True), ("frames", False)):
        jf = jax_build_forward(m.graph, jd, pallas_conv=False, rdb_kernel=False,
                               emit_frames=True, planar_tail=planar)
        want = np.asarray(jf(m.params, jax_frames_to_model(jnp.asarray(frames))))
        fwd = build_forward(m.graph, "cpu", td, emit, conv_impl="xla")
        assert isinstance(fwd, GraphForward) and fwd.tail is None
        assert not (fwd.chains or fwd.solos or fwd.rdb_triggers or fwd.dense)
        got = fwd(state, frames_to_model(torch.from_numpy(frames))).numpy()
        assert _max_lsb(got, want) <= 1


def test_xla_route_agrees_with_the_kernel_route():
    """The port's two routes on the default chain, bf16, a 64x96 frame:
    ``--conv_impl xla`` (generic convs, the tail's add in bf16) against
    ``auto`` (K1 + K2, the skip added in f32): within 4 LSB and above
    50 dB, the bound chip_smoke.py holds the same two routes to on the card
    (measured here: 1 LSB, 55.2 dB)."""
    from upscale_video_tpu_torch.ops.pixel import psnr

    frames = torch.from_numpy(_frames(26, n=1, h=64, w=96))
    auto = ChainEngine.build(ChainSpec(), 2, "cpu", synthetic=True)
    xla = ChainEngine.build(ChainSpec(), 2, "cpu", synthetic=True,
                            conv_impl="xla")
    got, want = xla.planar_step(frames).numpy(), auto.planar_step(frames).numpy()
    assert _max_lsb(got, want) <= 4 and psnr(got, want) >= 50.0


def test_xla_route_with_denoise_agrees_with_the_kernel_route():
    """``-m n=3``: the same two routes and bound as above, NL-means on its
    plain version in both here (K6's on the card under ``auto``)."""
    from upscale_video_tpu_torch.ops.pixel import psnr

    frames = torch.from_numpy(_frames(27, n=1, h=64, w=96))
    spec = ChainSpec.parse("n=3")
    auto = ChainEngine.build(spec, 2, "cpu", synthetic=True)
    xla = ChainEngine.build(spec, 2, "cpu", synthetic=True, conv_impl="xla")
    got, want = xla.planar_step(frames).numpy(), auto.planar_step(frames).numpy()
    assert _max_lsb(got, want) <= 4 and psnr(got, want) >= 50.0


def test_f32_takes_the_aten_route_whatever_the_flag(caplog):
    """f32 never plans a kernel: ``pallas`` and ``rdb`` log the JAX
    package's warning and take the aten route, whose bytes ``xla`` equals."""
    from upscale_video_tpu_torch.models.executor import GraphForward

    g = make_srvgg_graph(scale=2, num_conv=3, num_feat=16)
    m = jax_model(scale=2, num_conv=3, num_feat=16, seed=11)
    state = params_from_jax(m.params, "cpu", torch.float32)
    x = frames_to_model(torch.from_numpy(_frames(21)))
    outs = []
    for impl in ("auto", "pallas", "rdb", "xla"):
        caplog.clear()
        fwd = build_forward(g, "cpu", torch.float32, "planar", conv_impl=impl)
        assert isinstance(fwd, GraphForward) and fwd.tail is None
        assert not (fwd.chains or fwd.solos)
        warned = any("precision f32 requested" in r.message for r in caplog.records)
        assert warned is (impl in ("pallas", "rdb"))
        outs.append(fwd(state, x))
    assert all(torch.equal(o, outs[0]) for o in outs[1:])


@pytest.mark.parametrize("precision,tile", [
    ("bf16", 16), ("f32", 16), ("f32", (8, 12)),
], ids=["bf16-16", "f32-16", "f32-8x12"])
def test_tiled_step_matches_jax(precision, tile):
    """``--tile_size`` on the default chain: haloed tiles through K1 and
    K2's f32 model layout (their plain versions here), against the JAX
    engine with the same tile and halo; a 20x28 frame, which neither tile
    divides.  bf16 against the JAX kernel path (``conv_impl="pallas"``, same
    rounding points), f32 against its XLA path: within 1 LSB."""
    kw = dict(tile=tile, halo=4)
    jax_eng = _jax_engine(precision, conv_impl="auto" if precision == "f32"
                          else "pallas", **kw)
    port = _port_engine(precision, **kw)
    assert port.planar_scale is None and port.tile == tile
    frames = _frames(22, n=1, h=20, w=28)
    want = np.asarray(jax_eng.step(jnp.asarray(frames)))
    got = port.step(torch.from_numpy(frames)).numpy()
    assert got.shape == (1, 40, 56, 3)
    assert _max_lsb(got, want) <= 1


def test_tiled_tta_and_yuv_steps_match_jax():
    """``--tile_size`` with ``--tta`` (the dihedral passes each tiled), and
    the tiled step's 4:2:0 contract (frames then packed), in f32 against
    the JAX engine on a 12x20 frame that the 8 tile does not divide:
    within 1 LSB."""
    kw = dict(tile=8, halo=4)
    frames = _frames(23, n=1, h=12, w=20)
    jax_eng, port = _jax_engine("f32", tta=True, **kw), _port_engine("f32", tta=True, **kw)
    want = np.asarray(jax_eng.step(jnp.asarray(frames)))
    assert _max_lsb(port.step(torch.from_numpy(frames)).numpy(), want) <= 1
    jax_eng, port = _jax_engine("f32", **kw), _port_engine("f32", **kw)
    want = np.asarray(jax_eng.yuv_step(True, planar=False)(jnp.asarray(frames)))
    got = port.yuv_step(True, planar=False)(torch.from_numpy(frames)).numpy()
    assert got.shape == want.shape == (1, 12, 20, 6)
    assert _max_lsb(got, want) <= 1


@pytest.mark.parametrize("models", [None, "a"], ids=["compact", "a"])
def test_mixed_matches_jax_mixed(models):
    """``--precision mixed`` on the Compact family and ``a``: against the
    JAX engine under mixed on its kernel path (``conv_impl="pallas"``, the
    rounding points of K1 and K2), within 1 LSB."""
    jax_eng = _jax_engine("mixed", models=models, conv_impl="pallas")
    port = _port_engine("mixed", models=models)
    frames = _frames(24, n=1)
    want = np.asarray(jax_eng.step(jnp.asarray(frames)))
    got = port.step(torch.from_numpy(frames)).numpy()
    assert _max_lsb(got, want) <= 1


def test_mixed_compact_equals_bf16_byte_for_byte():
    """K2 adds the skip in f32 under bf16 already, so mixed computes the
    same bytes on K1 + K2: planar, 4:2:0 and tiled steps."""
    frames = torch.from_numpy(_frames(25, n=1, h=8, w=12))
    bf16, mixed = _port_engine("bf16"), _port_engine("mixed")
    assert torch.equal(mixed.planar_step(frames), bf16.planar_step(frames))
    assert torch.equal(mixed.yuv_step(False, planar=True)(frames),
                       bf16.yuv_step(False, planar=True)(frames))
    bf16, mixed = _port_engine("bf16", tile=4), _port_engine("mixed", tile=4)
    assert torch.equal(mixed.step(frames), bf16.step(frames))
