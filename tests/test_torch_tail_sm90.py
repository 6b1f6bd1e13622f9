"""K2 and K3's Hopper contract on the CPU: the ``yuv420`` layout of both
tails' plain versions against the JAX package (the Pallas tails in
interpret mode, relaid as planar, then its ``yuv420_from_planar``), the
packed-4:2:0 emit of both forwards, K2's packed B image and both Hopper
routing rules.

Tolerances: the packed 4:2:0 bytes within 1 LSB (the port's plain tail and
the JAX tail sum in another order, so a planar byte may land one LSB away
at a rounding boundary, and the pack is computed from those bytes).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from upscale_video_tpu.ops.conv_chain import conv3x3_chain as jax_chain
from upscale_video_tpu.ops.pixel import model_to_frames as jax_model_to_frames
from upscale_video_tpu.ops.tail_pallas import (
    sr_tail_fused as jax_sr_tail_fused, sr_tail_fused_chain,
)
from upscale_video_tpu.ops.yuv import yuv420_from_planar as jax_yuv420
from upscale_video_tpu_torch.ops.common import ACT_PRELU
from upscale_video_tpu_torch.ops.conv_chain import (
    conv3x3_chain, make_layer, pack_ring_weights,
)
from upscale_video_tpu_torch.ops.tail import (
    chain_sm90_takes, fused_sm90_takes, pack_tail_weights, sr_tail_chain,
    sr_tail_chain_plain, sr_tail_fused, sr_tail_fused_plain, tail_columns,
)
from upscale_video_tpu_torch.ops.yuv import yuv420_from_planar
from tests.torch_fixtures import one_torch_thread  # noqa: F401

H, W, CF = 13, 21, 16


def _max_lsb(a, b):
    return int(np.abs(np.asarray(a).astype(int) - np.asarray(b).astype(int)).max())


def _frames_to_planar(f, s):
    """(N, s*H, s*W, 3) -> (N, H, W, 3*s*s) in (a, b, c) order."""
    n, sh, sw, _ = f.shape
    return (f.reshape(n, sh // s, s, sw // s, s, 3).transpose(0, 1, 3, 2, 4, 5)
            .reshape(n, sh // s, sw // s, 3 * s * s))


def _jax_pack(frames_u8, s, full_range):
    planar = _frames_to_planar(np.asarray(frames_u8), s)
    return np.asarray(jax_yuv420(jnp.asarray(planar), s, full_range))


def _chain_case(s, seed):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (2, H, W, 3)).astype(np.float32)
    specs = [{
        "weight": rng.normal(0, 0.15, (3, 3, cin, cout)).astype(np.float32),
        "bias": rng.normal(0, 0.05, (cout,)).astype(np.float32),
        "slope": rng.uniform(0.1, 0.3, (cout,)).astype(np.float32),
        "act": ACT_PRELU,
    } for cin, cout in ((3, CF), (CF, CF))]
    tw = rng.normal(0, 0.05, (3, 3, CF, 3 * s * s)).astype(np.float32)
    tb = rng.normal(0, 0.05, (3 * s * s,)).astype(np.float32)
    return x, specs, tw, tb


@pytest.mark.parametrize("full_range", [False, True])
@pytest.mark.parametrize("s", [2, 4])
def test_chain_tail_yuv420_matches_jax(s, full_range):
    x, specs, tw, tb = _chain_case(s, 400 + s)
    frames = np.stack([np.asarray(sr_tail_fused_chain(
        jax_chain(jnp.asarray(x[i]), specs, crop=False, interpret=True),
        jnp.asarray(x[i]), jnp.asarray(tw), jnp.asarray(tb), scale=s, hgt=H,
        wid=W, emit_u8=True, reverse_channels=True, interpret=True))
        for i in range(2)])
    want = _jax_pack(frames, s, full_range)
    layers = [make_layer(p["weight"], p["bias"], p["slope"], p["act"])
              for p in specs]
    xt = torch.from_numpy(x).to(torch.bfloat16)
    buf = conv3x3_chain(xt, layers, crop=False)
    wmat = torch.from_numpy(tw.reshape(9 * CF, -1)).to(torch.bfloat16)
    bias = torch.from_numpy(tb)
    got = sr_tail_chain(buf, xt, wmat, bias, s, "yuv420", full_range).numpy()
    assert got.dtype == np.uint8 and got.shape == want.shape == (
        2, H, W, s * s + 2 * (s // 2) ** 2)
    assert _max_lsb(got, want) <= 1
    # the layout is the port's own pack of its planar layout, exactly
    planar = sr_tail_chain_plain(buf, xt, wmat, bias, s, "planar")
    np.testing.assert_array_equal(got, yuv420_from_planar(planar, s, full_range))


@pytest.mark.parametrize("full_range", [False, True])
@pytest.mark.parametrize("cf,s", [(64, 2), (160, 4)])
def test_plain_input_tail_yuv420_matches_jax(cf, s, full_range):
    rng = np.random.default_rng(cf + s)
    u = rng.normal(0, 0.5, (2, H, W, cf)).astype(np.float32)
    rgb = rng.uniform(0, 1, (2, H, W, 3)).astype(np.float32)
    wt = rng.normal(0, 0.3 / np.sqrt(9 * cf), (3, 3, cf, 3 * s * s)).astype(np.float32)
    u, rgb, wt = (np.asarray(torch.from_numpy(a).to(torch.bfloat16).float())
                  for a in (u, rgb, wt))
    b = rng.normal(0, 0.05, (3 * s * s,)).astype(np.float32)
    model = np.stack([np.asarray(jax_sr_tail_fused(
        jnp.asarray(u[i]), jnp.asarray(rgb[i]), jnp.asarray(wt), jnp.asarray(b),
        scale=s, tile_h=8, tile_w=16, interpret=True)) for i in range(2)])
    want = _jax_pack(jax_model_to_frames(jnp.asarray(model)), s, full_range)
    args = (torch.from_numpy(u).to(torch.bfloat16),
            torch.from_numpy(rgb).to(torch.bfloat16),
            torch.from_numpy(wt.reshape(9 * cf, -1)).to(torch.bfloat16),
            torch.from_numpy(b), s)
    before = sr_tail_fused.launches
    got = sr_tail_fused(*args, "yuv420", full_range).numpy()
    assert sr_tail_fused.launches == before
    assert got.shape == want.shape and got.dtype == np.uint8
    assert _max_lsb(got, want) <= 1
    np.testing.assert_array_equal(got, sr_tail_fused_plain(
        *args, "yuv420", full_range).numpy())


def test_yuv420_needs_an_even_scale():
    buf = torch.zeros(1, 6, 7, 64)
    with pytest.raises(ValueError, match="even scale"):
        sr_tail_chain_plain(buf, torch.zeros(1, 4, 5, 3), torch.zeros(576, 27),
                            torch.zeros(27), 3, "yuv420")


def _unpack_ring(img, cs, n, cin, cout):
    """The inverse of pack_ring_weights: the (9*cin, cout) matrix its B
    image holds, read back as wgmma reads B (line col, K-major 16-byte
    chunk j of K atom a stored at chunk j ^ (col % 8))."""
    atoms = -(-3 * cs // 64)
    img = img.to(torch.float32).view(3, atoms, n, 8, 8)  # dy, atom, col, chunk, elem
    k = torch.arange(64 * atoms)
    col = torch.arange(n)
    chunk = (k % 64 // 8).view(-1, 1) ^ (col % 8).view(1, -1)
    b = img[:, (k // 64).view(-1, 1), col.view(1, -1), chunk, (k % 8).view(-1, 1)]
    b = b[:, :3 * cs].reshape(3, 3, cs, n)  # dy, dx, c, col
    assert not b[:, :, cin:].any() and not b[..., cout:].any()
    return b[:, :, :cin, :cout].reshape(9 * cin, cout)


@pytest.mark.parametrize("s", [2, 4])
def test_tail_pack_round_trips_to_wmat(s):
    rng = np.random.default_rng(s)
    wmat = torch.from_numpy(rng.normal(0, 1, (9 * 64, 3 * s * s)).astype(
        np.float32)).to(torch.bfloat16)
    img = pack_tail_weights(wmat, s)
    n = tail_columns(s)
    assert n == (16 if s == 2 else 48)
    assert img.dtype == torch.bfloat16 and img.numel() == 9 * n * 64
    torch.testing.assert_close(_unpack_ring(img, 64, n, 64, 3 * s * s),
                               wmat.float(), atol=0, rtol=0)
    assert torch.equal(img, pack_ring_weights(wmat, 64, n))


@pytest.mark.parametrize("cin,cs,cout,n", [(3, 8, 64, 64), (24, 24, 3, 8),
                                           (64, 64, 3, 8), (24, 24, 24, 24)])
def test_ring_pack_round_trips_for_the_narrow_shapes(cin, cs, cout, n):
    rng = np.random.default_rng(cin + cout)
    wmat = torch.from_numpy(rng.normal(0, 1, (9 * cin, cout)).astype(
        np.float32)).to(torch.bfloat16)
    torch.testing.assert_close(
        _unpack_ring(pack_ring_weights(wmat, cs, n), cs, n, cin, cout),
        wmat.float(), atol=0, rtol=0)


def test_tail_pack_is_none_off_the_hopper_shapes():
    assert pack_tail_weights(torch.zeros(9 * 64, 12, dtype=torch.bfloat16), 2) is not None
    assert pack_tail_weights(torch.zeros(9 * 48, 12, dtype=torch.bfloat16), 2) is None
    assert pack_tail_weights(torch.zeros(9 * 64, 27, dtype=torch.bfloat16), 3) is None
    assert pack_tail_weights(torch.zeros(9 * 64, 12, dtype=torch.float32), 2) is None


@pytest.mark.parametrize("cf,s,takes", [
    (64, 2, True), (64, 4, True), (64, 1, False), (64, 3, False),
    (48, 2, False), (128, 2, False), (16, 4, False), (24, 2, False),
])
def test_chain_sm90_shape_rule(cf, s, takes):
    """K2's Hopper kernel: the 64-wide chain buffer at s 2 or 4."""
    assert chain_sm90_takes(cf, s) is takes


@pytest.mark.parametrize("cf,s,takes", [
    (32, 2, True), (64, 4, True), (96, 2, True), (128, 4, True),
    (160, 4, True), (192, 2, True), (192, 4, True), (16, 2, False),
    (48, 4, False), (224, 2, False), (256, 4, False), (160, 3, False),
    (64, 1, False), (512, 2, False),
])
def test_fused_sm90_shape_rule(cf, s, takes):
    """K3's Hopper kernel: K4's Hopper cin set at s 2 or 4."""
    assert fused_sm90_takes(cf, s) is takes


def test_srvgg_forward_emits_yuv420_as_planar_then_pack():
    """The K1 + K2 forward's ``yuv420`` emit is its planar emit packed (the
    CPU path), for both ranges, and its plan packs the tail's B image."""
    from upscale_video_tpu_torch.models.zoo import make_synthetic_model

    model = make_synthetic_model(scale=2, num_conv=2, num_feat=64, seed=3)
    x = torch.rand(2, 9, 14, 3)
    planar = model.frames_forward("planar")(model.state, x)
    fwd = model.frames_forward("yuv420")
    tail = model.state[fwd.tail["conv"]]
    assert tail.wpack_tail.numel() == 9 * 16 * 64
    for full in (False, True):
        np.testing.assert_array_equal(fwd(model.state, x, full_range=full),
                                      yuv420_from_planar(planar, 2, full))


def test_graph_forward_emits_yuv420_through_k3():
    """A wide SRVGG (no K1 chain: the graph walk, its tail on K3) emits the
    packed layout from its tail, equal to its planar emit packed."""
    from upscale_video_tpu_torch.models.bin_loader import synthesize_weights
    from upscale_video_tpu_torch.models.zoo import Model, make_srvgg_graph

    g = make_srvgg_graph(scale=4, num_conv=1, num_feat=160)
    model = Model("wide", 4, g, synthesize_weights(g, seed=0), "cpu",
                  compute_dtype=torch.float32)
    x = torch.rand(1, 6, 7, 3)
    planar = model.frames_forward("planar")(model.state, x)
    got = model.frames_forward("yuv420")(model.state, x, full_range=True)
    assert got.shape == (1, 6, 7, 24)
    np.testing.assert_array_equal(got, yuv420_from_planar(planar, 4, True))
