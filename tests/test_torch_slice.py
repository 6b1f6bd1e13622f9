"""The whole SR stage of the slice on the CPU: the port (K1 + K2 plain
versions under the planned SRVGG forward) against the JAX executor, on the
same synthetic graph and byte-identical weights (``params_from_jax``).

- f32: the port against the JAX XLA path in f32 (``build_forward`` with
  ``planar_tail=True``): within 1 u8 LSB, the PARITY.md contract.
- bf16: the port against the JAX Pallas path (``pallas_conv=True``, run
  in interpret mode), which rounds at the same points (once per conv,
  after bias and activation): within 1 u8 LSB.
- the engine steps (planar RGB and both 4:2:0 input forms) against the
  JAX ``ChainEngine`` in f32: within 1 LSB.
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
    build_forward, plan_srvgg, probe_srvgg_tail,
)
from upscale_video_tpu_torch.models.zoo import (
    make_srvgg_graph, params_from_jax,
)
from upscale_video_tpu_torch.ops.pixel import frames_to_model
from upscale_video_tpu_torch.pipeline.chain import ChainEngine, ChainSpec


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
    """(a) 3-conv and (c) full-depth Compact, num_feat 64, f32."""
    m = jax_model(scale=2, num_conv=num_conv, num_feat=64, seed=7)
    frames = _frames(1)
    jf = jax_build_forward(m.graph, jnp.float32, emit_frames=True,
                           planar_tail=True)
    assert jf.planar_scale == 2
    want = np.asarray(jf(m.params, jax_frames_to_model(jnp.asarray(frames))))
    got = _port_out(m, frames, torch.float32, "planar")
    assert _max_lsb(got, want) <= 1


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
    model-domain, u8 frame and u8 planar layouts."""
    from upscale_video_tpu_torch.models.zoo import make_synthetic_model
    from upscale_video_tpu_torch.ops.pixel import planar_to_frames

    m = make_synthetic_model(scale=2, num_conv=2, num_feat=16, seed=9,
                             compute_dtype=torch.float32)
    # 3 body convs + the tail conv (wmat, bias) and 3 PReLU slopes
    assert sum(1 for _ in m.buffers()) == 2 * 4 + 3
    x = frames_to_model(torch.from_numpy(_frames(3, n=1, h=10, w=12)))
    y = m(x, "model").numpy()
    u8 = m(x, "frames").numpy()
    q = np.clip(np.round(y[..., ::-1] * 255.0), 0, 255).astype(np.uint8)
    np.testing.assert_array_equal(q, u8)
    np.testing.assert_array_equal(planar_to_frames(m(x, "planar").numpy(), 2), u8)


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
