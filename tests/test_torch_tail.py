"""K2 parity on the CPU: the port's ``sr_tail_chain`` (CPU -> its plain
version) fed by the port's bordered conv chain, against the JAX Pallas
``sr_tail_fused_chain`` fed by ``conv3x3_chain(crop=False)``, both in
interpret mode, on the same numpy inputs.

Tolerances: f32 model-domain output within 2e-2 (a bf16 ulp of the chain
output, as tests/test_conv_chain.py allows, times the tail's small
weights); uint8 within 1 LSB (a value within that ulp of a rounding
boundary may quantize to the neighbour).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from upscale_video_tpu.ops.conv_chain import conv3x3_chain as jax_chain
from upscale_video_tpu.ops.tail_pallas import sr_tail_fused_chain
from upscale_video_tpu_torch.ops.common import ACT_PRELU
from upscale_video_tpu_torch.ops.conv_chain import conv3x3_chain, make_layer
from upscale_video_tpu_torch.ops.pixel import planar_to_frames
from upscale_video_tpu_torch.ops.tail import (
    sr_tail_chain, sr_tail_chain_plain,
)

H, W, CF = 13, 21, 16


def _case(s, seed):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (2, H, W, 3)).astype(np.float32)
    specs = []
    for cin, cout in ((3, CF), (CF, CF)):
        specs.append({
            "weight": rng.normal(0, 0.15, (3, 3, cin, cout)).astype(np.float32),
            "bias": rng.normal(0, 0.05, (cout,)).astype(np.float32),
            "slope": rng.uniform(0.1, 0.3, (cout,)).astype(np.float32),
            "act": ACT_PRELU,
        })
    tw = rng.normal(0, 0.05, (3, 3, CF, 3 * s * s)).astype(np.float32)
    tb = rng.normal(0, 0.05, (3 * s * s,)).astype(np.float32)
    return x, specs, tw, tb


def _jax(x, specs, tw, tb, s, emit_u8):
    outs = []
    for i in range(x.shape[0]):
        arr = jax_chain(jnp.asarray(x[i]), specs, crop=False, interpret=True)
        outs.append(np.asarray(sr_tail_fused_chain(
            arr, jnp.asarray(x[i]), jnp.asarray(tw), jnp.asarray(tb),
            scale=s, hgt=H, wid=W, emit_u8=emit_u8,
            reverse_channels=emit_u8, interpret=True)))
    return np.stack(outs)


def _port(x, specs, tw, tb, s, layout):
    layers = [make_layer(p["weight"], p["bias"], p["slope"], p["act"])
              for p in specs]
    xt = torch.from_numpy(x).to(torch.bfloat16)
    buf = conv3x3_chain(xt, layers, crop=False)
    wmat = torch.from_numpy(tw.reshape(9 * CF, -1)).to(torch.bfloat16)
    return sr_tail_chain(buf, xt, wmat, torch.from_numpy(tb), s, layout)


@pytest.mark.parametrize("s", [2, 4])
def test_f32_model_domain(s):
    x, specs, tw, tb = _case(s, 100 + s)
    got = _port(x, specs, tw, tb, s, "model")
    want = _jax(x, specs, tw, tb, s, emit_u8=False)
    assert got.dtype == torch.float32
    assert tuple(got.shape) == want.shape == (2, H * s, W * s, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-2)


@pytest.mark.parametrize("s", [2, 4])
def test_u8_frames_with_bgr_flip(s):
    x, specs, tw, tb = _case(s, 200 + s)
    got = _port(x, specs, tw, tb, s, "frames").numpy()
    want = _jax(x, specs, tw, tb, s, emit_u8=True)
    assert got.dtype == want.dtype == np.uint8
    assert got.shape == want.shape
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


@pytest.mark.parametrize("s", [2, 4])
def test_planar_layout_is_frames_after_interleave(s):
    x, specs, tw, tb = _case(s, 300 + s)
    planar = _port(x, specs, tw, tb, s, "planar").numpy()
    frames = _port(x, specs, tw, tb, s, "frames").numpy()
    assert planar.shape == (2, H, W, 3 * s * s)
    np.testing.assert_array_equal(planar_to_frames(planar, s), frames)


def test_round_half_to_even():
    """u8 quantization rounds half to even (jnp.round), not half away."""
    buf = torch.zeros(1, 3, 4, 1)
    wmat = torch.zeros(9, 12)
    bias = torch.zeros(12)
    # skip values whose x255 lands exactly on .5: 0.5/255 -> 0, 1.5/255 -> 2
    skip = torch.tensor([0.5, 1.5, 2.5], dtype=torch.float64).div(255.0)
    skip = skip.to(torch.float32).view(1, 1, 1, 3).expand(1, 1, 2, 3).contiguous()
    y = sr_tail_chain_plain(buf, skip, wmat, bias, 2, "frames")
    # BGR -> RGB: channel c lands at 2 - c
    assert y[0, 0, 0].tolist() == [2, 2, 0]


def test_rejects_mismatched_shapes():
    buf = torch.zeros(1, 6, 7, 8)
    with pytest.raises(ValueError, match="skip"):
        sr_tail_chain(buf, torch.zeros(1, 6, 7, 3), torch.zeros(72, 12),
                      torch.zeros(12), 2)
    with pytest.raises(ValueError, match="layout"):
        sr_tail_chain(buf, torch.zeros(1, 4, 5, 3), torch.zeros(72, 12),
                      torch.zeros(12), 2, "nchw")
