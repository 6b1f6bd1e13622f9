"""K4, K3 and the generic op registry on the CPU, against the JAX package.

- K4: the port's ``conv3x3_fused`` (CPU -> ``conv3x3_fused_plain``)
  against the JAX Pallas ``conv3x3_fused`` in interpret mode (``tile_h=8,
  tile_w=16``, as tests/test_conv_pallas.py runs it) on a ragged 13x21
  frame, bf16 out: within ``2**-10 + 2**-7 * |v|``, one bf16 rounding of
  the same f32 value summed in another order (atol for sums near 0).
- K3: ``sr_tail_fused`` (CPU -> ``sr_tail_fused_plain``) against the JAX
  Pallas ``sr_tail_fused`` in interpret mode (tile 8x16): the f32 model
  layout within ``1e-5 + 1e-5 * |v|`` (a few f32 ulps of the 9*Cf-term
  sum), the u8 layouts within 1 LSB of the JAX output quantized by
  ``model_to_frames`` (a value within those ulps of a rounding boundary).
- Each registry op against its JAX ``_op_*`` on the same random f32 NHWC
  input: exact, or within 1e-6 where the sum order differs (convs and
  resizes).
- K4's channel slices: reading a channel view of a wider NHWC buffer and
  writing at a channel offset of another equal the contiguous call bit
  for bit, every other channel untouched; the shape rule that sends a
  call to the sm90 kernel.
- The planner: which convs become K4 launches, which tail K3.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from upscale_video_tpu.models import executor as jax_executor
from upscale_video_tpu.ops.conv_pallas import conv3x3_fused as jax_conv3x3_fused
from upscale_video_tpu.ops.pixel import model_to_frames as jax_model_to_frames
from upscale_video_tpu.ops.tail_pallas import sr_tail_fused as jax_sr_tail_fused
from upscale_video_tpu_torch.models import ops as port_ops
from upscale_video_tpu_torch.models.executor import (
    GraphForward, SRVGGForward, build_forward,
)
from upscale_video_tpu_torch.models.param_parser import NcnnLayer
from upscale_video_tpu_torch.models.zoo import (
    make_rrdb_graph, make_srvgg_graph, params_from_jax,
)
from upscale_video_tpu_torch.ops.common import (
    ACT_LEAKY, ACT_NONE, ACT_PRELU, ACT_RELU,
)
from upscale_video_tpu_torch.ops.conv3x3 import (
    conv3x3_fused, conv3x3_fused_plain, sm90_takes,
)
from upscale_video_tpu_torch.ops.pixel import planar_to_frames
from upscale_video_tpu_torch.ops.tail import sr_tail_fused
from tests.torch_fixtures import one_torch_thread  # noqa: F401

ACTS = (ACT_NONE, ACT_PRELU, ACT_LEAKY, ACT_RELU)
# every conv_first and ESRGAN width in, every out width; the activations
# cycle so each meets several widths
K4_CASES = [(cin, cout, ACTS[i % 4]) for i, (cin, cout) in enumerate(
    (cin, cout) for cin in (3, 12, 64, 96, 160, 192) for cout in (3, 32, 64))]


def _bf16(a):
    return np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def _k4_inputs(cin, cout, act, seed):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (13, 21, cin)).astype(np.float32)
    w = rng.normal(0, 1.0 / np.sqrt(9 * cin), (3, 3, cin, cout)).astype(np.float32)
    b = rng.normal(0, 0.1, (cout,)).astype(np.float32)
    slope = (rng.uniform(0.1, 0.3, (cout,)).astype(np.float32)
             if act == ACT_PRELU else
             np.asarray([0.2], np.float32) if act == ACT_LEAKY else None)
    return x, w, b, slope


@pytest.mark.parametrize("cin,cout,act", K4_CASES)
def test_k4_plain_matches_jax_conv3x3_fused(cin, cout, act):
    x, w, b, slope = _k4_inputs(cin, cout, act, seed=cin * 7 + cout)
    want = np.asarray(jax_conv3x3_fused(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
        None if slope is None else jnp.asarray(slope), act=act,
        tile_h=8, tile_w=16, interpret=True, out_dtype=jnp.bfloat16,
    ).astype(jnp.float32))
    wmat = torch.from_numpy(w.reshape(9 * cin, cout)).to(torch.bfloat16)
    tslope = None if slope is None else (
        float(slope[0]) if act == ACT_LEAKY else torch.from_numpy(slope))
    before = conv3x3_fused.launches
    got = conv3x3_fused(torch.from_numpy(x)[None].to(torch.bfloat16), wmat,
                        torch.from_numpy(b), tslope, act)
    assert conv3x3_fused.launches == before  # the CPU runs the plain version
    assert got.shape == (1, 13, 21, cout) and got.dtype == torch.bfloat16
    got = got[0].float().numpy()
    assert np.all(np.abs(got - want) <= 2.0 ** -10 + 2.0 ** -7 * np.abs(want))


def test_k4_plain_f32_out_and_batch():
    """``out_dtype=float32`` skips the rounding; a batch equals its frames
    one by one (one launch covers the batch on the card)."""
    x, w, b, slope = _k4_inputs(32, 16, ACT_PRELU, seed=3)
    xs = np.stack([x, x[::-1].copy()])
    wmat = torch.from_numpy(w.reshape(-1, 16))
    got = conv3x3_fused_plain(torch.from_numpy(xs), wmat, torch.from_numpy(b),
                              torch.from_numpy(slope), ACT_PRELU, torch.float32)
    assert got.dtype == torch.float32
    for i in range(2):
        want = np.asarray(jax_conv3x3_fused(
            jnp.asarray(xs[i]), jnp.asarray(w), jnp.asarray(b),
            jnp.asarray(slope), act=ACT_PRELU, tile_h=8, tile_w=16,
            interpret=True, out_dtype=jnp.float32))
        np.testing.assert_allclose(got[i].numpy(), want, rtol=1e-5, atol=1e-5)


def test_k4_refuses_what_the_kernel_does_not_take():
    x = torch.zeros(1, 4, 4, 8)
    with pytest.raises(ValueError, match="outside"):
        conv3x3_fused(torch.zeros(1, 4, 4, 513), torch.zeros(9 * 513, 8),
                      torch.zeros(8))
    with pytest.raises(ValueError, match="outside"):
        conv3x3_fused(x, torch.zeros(72, 257), torch.zeros(257))
    with pytest.raises(ValueError, match="PReLU"):
        conv3x3_fused(x, torch.zeros(72, 4), torch.zeros(4), 0.2, ACT_PRELU)
    with pytest.raises(ValueError, match="unsupported device"):
        conv3x3_fused(x.to("meta"), torch.zeros(72, 4), torch.zeros(4))


# an ESRGAN dense block's five convs on its 192-channel buffer: (cin,
# c_in_total, cout, out_off); the last writes its own 64 channels
DENSE_SLICES = [(64, 192, 32, 64), (96, 192, 32, 96), (128, 192, 32, 128),
                (160, 192, 32, 160), (192, 192, 64, 0)]
SENTINEL = 7.0


@pytest.mark.parametrize("cin,total,cout,off", DENSE_SLICES)
def test_k4_plain_reads_and_writes_channel_slices(cin, total, cout, off):
    x, w, b, slope = _k4_inputs(total, cout, ACT_LEAKY, seed=cin + total)
    buf = torch.from_numpy(np.stack([x, -x])).to(torch.bfloat16)
    wmat = torch.from_numpy(w[:, :, :cin].reshape(9 * cin, cout)).to(torch.bfloat16)
    args = (wmat, torch.from_numpy(b), float(slope[0]), ACT_LEAKY)
    want = conv3x3_fused(buf[..., :cin].contiguous(), *args)
    out = torch.full((2, 13, 21, off + cout + 8), SENTINEL, dtype=torch.bfloat16)
    got = conv3x3_fused(buf[..., :cin], *args, out=out, out_off=off)
    assert got.data_ptr() == out[..., off:].data_ptr() and got.shape == want.shape
    assert torch.equal(got, want)
    assert bool((out[..., :off] == SENTINEL).all())
    assert bool((out[..., off + cout:] == SENTINEL).all())


def test_k4_refuses_an_output_buffer_without_room():
    x, w, b, _ = _k4_inputs(32, 16, ACT_NONE, seed=5)
    args = (torch.from_numpy(x)[None], torch.from_numpy(w.reshape(-1, 16)),
            torch.from_numpy(b))
    with pytest.raises(ValueError, match="no channels"):
        conv3x3_fused(*args, out=torch.zeros(1, 13, 21, 20, dtype=torch.bfloat16),
                      out_off=8)
    with pytest.raises(ValueError, match="contiguous"):
        conv3x3_fused(*args, out=torch.zeros(1, 13, 21, 16))  # f32, bf16 asked


@pytest.mark.parametrize("cin,cout,dtype,takes", [
    (64, 32, torch.bfloat16, True), (96, 32, torch.bfloat16, True),
    (160, 32, torch.bfloat16, True), (192, 64, torch.bfloat16, True),
    (64, 64, torch.bfloat16, True), (160, 160, torch.bfloat16, True),
    (32, 48, torch.bfloat16, True), (3, 64, torch.bfloat16, False),
    (12, 64, torch.bfloat16, False), (64, 3, torch.bfloat16, False),
    (48, 64, torch.bfloat16, False), (224, 64, torch.bfloat16, False),
    (64, 272, torch.bfloat16, False), (64, 32, torch.float32, False),
])
def test_k4_sm90_shape_rule(cin, cout, dtype, takes):
    """The sm90 kernel takes bf16 output, cin a multiple of 32 up to 192
    and cout a multiple of 16 up to 256: every product-path K4 conv but
    the 3- and 12-channel heads."""
    assert sm90_takes(cin, cout, dtype) is takes


@pytest.mark.parametrize("cf,s", [(64, 2), (64, 4), (160, 2), (160, 4)])
def test_k3_plain_matches_jax_sr_tail_fused(cf, s):
    rng = np.random.default_rng(cf + s)
    h, w = 13, 21
    u = _bf16(rng.normal(0, 0.5, (2, h, w, cf)).astype(np.float32))
    rgb = _bf16(rng.uniform(0, 1, (2, h, w, 3)).astype(np.float32))
    wt = _bf16(rng.normal(0, 0.3 / np.sqrt(9 * cf),
                          (3, 3, cf, 3 * s * s)).astype(np.float32))
    b = rng.normal(0, 0.05, (3 * s * s,)).astype(np.float32)
    want = np.stack([np.asarray(jax_sr_tail_fused(
        jnp.asarray(u[i]), jnp.asarray(rgb[i]), jnp.asarray(wt), jnp.asarray(b),
        scale=s, tile_h=8, tile_w=16, interpret=True)) for i in range(2)])
    args = (torch.from_numpy(u).to(torch.bfloat16),
            torch.from_numpy(rgb).to(torch.bfloat16),
            torch.from_numpy(wt.reshape(9 * cf, -1)).to(torch.bfloat16),
            torch.from_numpy(b), s)
    before = sr_tail_fused.launches
    model = sr_tail_fused(*args, "model").numpy()
    assert sr_tail_fused.launches == before
    assert model.shape == (2, h * s, w * s, 3)
    assert np.all(np.abs(model - want) <= 1e-5 + 1e-5 * np.abs(want))
    want_u8 = np.asarray(jax_model_to_frames(jnp.asarray(want))).astype(int)
    frames = sr_tail_fused(*args, "frames").numpy()
    planar = planar_to_frames(sr_tail_fused(*args, "planar").numpy(), s)
    assert frames.dtype == planar.dtype == np.uint8
    for got in (frames, planar):
        assert np.abs(got.astype(int) - want_u8).max() <= 1
    np.testing.assert_array_equal(frames, planar)


def _x(c=8, h=6, w=10, seed=0):
    return np.random.default_rng(seed).uniform(-1, 2, (2, h, w, c)).astype(np.float32)


def _same_op(layer, xs, params=None, tol=0.0):
    jp = {k: jnp.asarray(v) for k, v in (params or {}).items()}
    want = np.asarray(jax_executor.OP_REGISTRY[layer.type](
        layer, [jnp.asarray(x) for x in xs], jp, jnp.float32))
    state = params_from_jax({layer.name: params}, "cpu", torch.float32)[layer.name] \
        if params else None
    got = port_ops.OP_REGISTRY[layer.type](
        layer, [torch.from_numpy(x) for x in xs], state, torch.float32)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol)


@pytest.mark.parametrize("group,cout,act", [(8, 8, 0), (2, 6, 2), (4, 8, 1)])
def test_convolution_depthwise_equals_jax(group, cout, act):
    rng = np.random.default_rng(group)
    cin, k = 8, 3
    attrs = {0: cout, 1: k, 4: 1, 5: 1, 6: cout * (cin // group) * k * k,
             7: group, 9: act, 10: [0.1]}
    layer = NcnnLayer("ConvolutionDepthWise", "dw", ["a"], ["b"], attrs)
    params = {"weight": rng.normal(0, 0.3, attrs[6]).astype(np.float32),
              "group": np.array(group),
              "bias": rng.normal(0, 0.1, (cout,)).astype(np.float32)}
    _same_op(layer, [_x(cin)], params, tol=1e-6)


@pytest.mark.parametrize("r", [2, 4])
def test_reorg_equals_jax_and_torch_pixel_unshuffle(r):
    layer = NcnnLayer("Reorg", "re", ["a"], ["b"], {0: r})
    x = _x(3, 8, 12)
    _same_op(layer, [x])
    got = port_ops.op_reorg(layer, [torch.from_numpy(x)], None, torch.float32)
    want = torch.nn.functional.pixel_unshuffle(
        torch.from_numpy(x).permute(0, 3, 1, 2), r).permute(0, 2, 3, 1)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("rtype", [2, 3])
@pytest.mark.parametrize("attrs", [{1: 2.0, 2: 2.0}, {1: 1.5, 2: 2.5},
                                   {3: 4, 4: 7}],
                         ids=["up2", "non_integer", "down_fixed"])
def test_bilinear_bicubic_interp_equal_jax(rtype, attrs):
    layer = NcnnLayer("Interp", "up", ["a"], ["b"], {0: rtype, **attrs})
    _same_op(layer, [_x(3)], tol=1e-6)


@pytest.mark.parametrize("op", range(9))
def test_binaryop_equals_jax(op):
    a, b = _x(seed=1), _x(seed=2)
    if op in (3, 6, 8):  # divide, power: positive operands
        a, b = np.abs(a) + 0.5, np.abs(b) + 0.5
    layer = NcnnLayer("BinaryOp", "o", ["a", "b"], ["c"], {0: op})
    _same_op(layer, [a, b], tol=1e-6)
    scalar = NcnnLayer("BinaryOp", "o", ["a"], ["c"], {0: op, 1: 1, 2: 1.75})
    _same_op(scalar, [a], tol=1e-6)


@pytest.mark.parametrize("attrs", [{0: 0}, {0: 1}, {0: 1, 1: [0.5, -2.0, 1.0]},
                                   {0: 2}], ids=["prod", "sum", "sum_coeffs", "max"])
def test_eltwise_equals_jax(attrs):
    layer = NcnnLayer("Eltwise", "e", ["a", "b", "c"], ["d"], attrs)
    _same_op(layer, [_x(seed=1), _x(seed=2), _x(seed=3)], tol=1e-6)


@pytest.mark.parametrize("layer", [
    NcnnLayer("Clip", "c", ["a"], ["b"], {0: -0.25, 1: 0.75}),
    NcnnLayer("Sigmoid", "s", ["a"], ["b"], {}),
    NcnnLayer("ReLU", "r", ["a"], ["b"], {0: 0.1}),
    NcnnLayer("ReLU", "r", ["a"], ["b"], {}),
    NcnnLayer("Dropout", "d", ["a"], ["b"], {0: 0.5}),
    NcnnLayer("Dropout", "d", ["a"], ["b"], {}),
], ids=["clip", "sigmoid", "relu_slope", "relu", "dropout_scale", "dropout"])
def test_unary_ops_equal_jax(layer):
    _same_op(layer, [_x()], tol=1e-6)


def test_fused_conv_activations_equal_jax():
    """ncnn's fused conv activations 3..6 (clip, sigmoid, mish, hardswish)
    on the generic conv, which takes convs K4 does not."""
    rng = np.random.default_rng(9)
    p = {"weight": rng.normal(0, 0.3, (3, 3, 8, 5)).astype(np.float32),
         "bias": rng.normal(0, 0.1, (5,)).astype(np.float32)}
    for act, params in ((3, [-0.5, 0.5]), (4, []), (5, []), (6, [0.2, 0.5])):
        attrs = {0: 5, 1: 3, 4: 1, 5: 1, 6: 360, 9: act, 10: params}
        _same_op(NcnnLayer("Convolution", "cv", ["a"], ["b"], attrs),
                 [_x()], p, tol=1e-5)


def test_esrgan_plan_puts_every_solo_3x3_conv_on_k4():
    """RealESRGAN_x4plus's graph (basicsr RRDBNet, 23 RRDBs): 348 K4
    launches (conv_first, 345 dense convs, conv_body, conv_up1) and one K1
    chain (conv_up2 -> conv_hr -> conv_last), no dense block for K5."""
    fwd = build_forward(make_rrdb_graph(num_rrdb=23, variant="esrgan"), "cpu",
                        torch.bfloat16)
    assert isinstance(fwd, GraphForward) and not fwd.rdb_triggers
    assert len(fwd.solos) == 348
    assert {"conv_first", "conv_trunk", "conv_up1", "r0d0_c5"} <= set(fwd.solos)
    (chain,) = fwd.chains.values()
    assert [it["name"] for it in chain["items"]] == [
        "conv_up2", "conv_hr", "conv_last"]
    f32 = build_forward(make_rrdb_graph(num_rrdb=1, variant="esrgan"), "cpu",
                        torch.float32)
    assert not f32.solos  # f32 convs stay generic F.conv2d


def test_valar_plan_moves_the_three_solo_convs_to_k4():
    fwd = build_forward(make_rrdb_graph(num_rrdb=2), "cpu", torch.bfloat16)
    assert set(fwd.solos) == {"conv_first", "conv_trunk", "conv_up1"}
    assert len(fwd.rdb_triggers) == 6 and len(fwd.chains) == 1


@pytest.mark.parametrize("num_conv,num_feat,kind", [
    (16, 64, "chain"), (1, 160, "walk"), (0, 64, "walk"), (2, 129, "walk"),
])
def test_srvgg_plan_takes_k3_where_the_body_is_no_chain(num_conv, num_feat, kind):
    """A body of two or more chain-eligible convs is K1 + K2; a body wider
    than 128 or of one conv takes the graph walk, its convs (PReLU fused)
    on K4 and its tail on K3, with the planar layout."""
    g = make_srvgg_graph(scale=4, num_conv=num_conv, num_feat=num_feat)
    fwd = build_forward(g, "cpu", torch.bfloat16, "planar")
    if kind == "chain":
        assert isinstance(fwd, SRVGGForward)
        return
    assert isinstance(fwd, GraphForward) and fwd.tail["scale"] == 4
    assert fwd.tail["conv"] == "conv_up"
    assert sorted(fwd.solos) == [f"conv_{i}" for i in range(num_conv + 1)]
    assert all(s["prelu"] == f"prelu_{s['name'][5:]}" for s in fwd.solos.values())
    # mixed keeps the same plan (K2's skip add is f32 already)
    assert isinstance(build_forward(make_srvgg_graph(), "cpu", torch.bfloat16,
                                    "planar", torch.float32), SRVGGForward)
