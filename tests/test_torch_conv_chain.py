"""K1 parity on the CPU: the port's ``conv3x3_chain`` (CPU tensors take its
plain PyTorch version) against the JAX Pallas ``conv3x3_chain`` run in
interpret mode, on the same numpy inputs.

Tolerances are the ones ``tests/test_conv_chain.py:58,70`` holds the JAX
kernel to against its XLA reference: both sides round each layer once to
bf16 after an f32 accumulation whose order differs, so a value near a
rounding boundary may land one bf16 ulp apart and that ulp propagates.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from upscale_video_tpu.ops.conv_chain import conv3x3_chain as jax_chain
from upscale_video_tpu_torch.ops.common import (
    ACT_LEAKY, ACT_NONE, ACT_PRELU, ACT_RELU,
)
from upscale_video_tpu_torch.ops.conv_chain import (
    conv3x3_chain, conv3x3_chain_plain, make_layer, sm90_takes,
)


def _specs(rng, widths_acts):
    out = []
    for cin, cout, act in widths_acts:
        l = {
            "weight": rng.normal(0, 0.15, (3, 3, cin, cout)).astype(np.float32),
            "bias": rng.normal(0, 0.05, (cout,)).astype(np.float32),
            "act": act,
        }
        if act == ACT_LEAKY:
            l["slope"] = np.asarray([0.2], np.float32)
        elif act == ACT_PRELU:
            l["slope"] = rng.uniform(0.1, 0.3, (cout,)).astype(np.float32)
        out.append(l)
    return out


def _port_layers(specs):
    return [make_layer(s["weight"], s["bias"], s.get("slope"), s["act"])
            for s in specs]


def _run_both(rng, hw, widths_acts, n=2):
    h, w = hw
    x = rng.uniform(0, 1, (n, h, w, widths_acts[0][0])).astype(np.float32)
    specs = _specs(rng, widths_acts)
    want = np.stack([
        np.asarray(jax_chain(jnp.asarray(x[i]), specs, interpret=True))
        .astype(np.float32) for i in range(n)
    ])
    got = conv3x3_chain(torch.from_numpy(x), _port_layers(specs))
    assert got.dtype == torch.bfloat16
    return got.to(torch.float32).numpy(), want


@pytest.mark.parametrize("act", [ACT_NONE, ACT_PRELU, ACT_LEAKY, ACT_RELU])
def test_single_layer_each_activation(act):
    rng = np.random.default_rng(10 + act)
    got, want = _run_both(rng, (13, 21), [(3, 16, act)])
    assert got.shape == want.shape == (2, 13, 21, 16)
    np.testing.assert_allclose(got, want, atol=2e-2)


@pytest.mark.parametrize("hw", [(13, 21), (16, 24)])
def test_three_layer_mixed_activations(hw):
    rng = np.random.default_rng(20)
    got, want = _run_both(rng, hw, [(3, 16, ACT_PRELU), (16, 16, ACT_LEAKY),
                                    (16, 16, ACT_RELU)])
    np.testing.assert_allclose(got, want, atol=5e-2, rtol=2e-2)


def test_64_wide_compact_shape():
    """The Compact body's widths: 3 -> 64 -> 64 -> 12, PReLU between."""
    rng = np.random.default_rng(30)
    got, want = _run_both(rng, (13, 21), [(3, 64, ACT_PRELU),
                                          (64, 64, ACT_PRELU),
                                          (64, 12, ACT_NONE)])
    assert got.shape == (2, 13, 21, 12)
    np.testing.assert_allclose(got, want, atol=5e-2, rtol=2e-2)


def test_bordered_output_has_zero_ring():
    """crop=False hands the tail a (N, H+2, W+2, C) buffer whose ring is
    zero and whose interior is the cropped result."""
    rng = np.random.default_rng(40)
    x = torch.from_numpy(rng.uniform(0, 1, (1, 9, 11, 3)).astype(np.float32))
    layers = _port_layers(_specs(rng, [(3, 8, ACT_PRELU), (8, 8, ACT_NONE)]))
    buf = conv3x3_chain(x, layers, crop=False)
    assert buf.shape == (1, 11, 13, 8)
    ring = torch.ones(11, 13, dtype=torch.bool)
    ring[1:-1, 1:-1] = False
    assert torch.count_nonzero(buf[0][ring]) == 0
    assert torch.equal(buf[:, 1:-1, 1:-1], conv3x3_chain(x, layers))


def test_f32_compute_dtype_keeps_f32():
    """With f32 weights the plain version never rounds to bf16 (the CPU
    f32 quality path the slice tests use)."""
    rng = np.random.default_rng(50)
    specs = _specs(rng, [(3, 8, ACT_PRELU)])
    layers = [make_layer(s["weight"], s["bias"], s["slope"], s["act"],
                         dtype=torch.float32) for s in specs]
    x = torch.from_numpy(rng.uniform(0, 1, (1, 6, 7, 3)).astype(np.float32))
    y = conv3x3_chain_plain(x, layers)
    assert y.dtype == torch.float32
    ref = torch.nn.functional.conv2d(
        x.permute(0, 3, 1, 2), torch.from_numpy(specs[0]["weight"]).permute(3, 2, 0, 1),
        torch.from_numpy(specs[0]["bias"]), padding=1).permute(0, 2, 3, 1)
    ref = torch.where(ref >= 0, ref, ref * torch.from_numpy(specs[0]["slope"]))
    torch.testing.assert_close(y, ref, atol=1e-5, rtol=1e-5)


def test_rejects_bad_layers():
    rng = np.random.default_rng(60)
    layers = _port_layers(_specs(rng, [(4, 8, ACT_NONE)]))
    with pytest.raises(ValueError, match="cin"):
        conv3x3_chain(torch.zeros(1, 5, 5, 3), layers)
    with pytest.raises(ValueError, match="outside"):
        conv3x3_chain(torch.zeros(1, 5, 5, 129),
                      _port_layers(_specs(rng, [(129, 8, ACT_NONE)])))


@pytest.mark.parametrize("cin,cout,takes", [
    (64, 64, True), (3, 64, False), (24, 24, False), (64, 12, False),
    (128, 128, False), (64, 128, False), (32, 64, False), (64, 3, False),
])
def test_sm90_takes_exactly_64_to_64(cin, cout, takes):
    """The kernel choice is a pure function of the layer's shape: the sm90
    kernel's resident weights and halo ring are sized for 64 -> 64."""
    assert sm90_takes(cin, cout) is takes


def test_planned_chains_split_as_sm90_takes():
    """The default Compact chain puts its 16 body layers on the sm90
    kernel and its 3 -> 64 head on WMMA; the anime chain (nf 24) none;
    ESRGAN's and Valar's last chain (up2 -> hr -> last) two of three."""
    from upscale_video_tpu_torch.models.executor import chain_layers
    from upscale_video_tpu_torch.models.zoo import (
        make_synthetic_model, make_synthetic_rrdb_model,
    )

    def split(model, emit):
        fwd = model.frames_forward(emit)
        if hasattr(fwd, "chains"):
            (chain,) = fwd.chains.values()
            items = chain["items"]
        else:
            items = fwd.items
        return [sm90_takes(l.cin, l.cout)
                for l in chain_layers(items, model.state)]

    assert split(make_synthetic_model(scale=2), "planar") == [False] + [True] * 16
    anime = make_synthetic_model(scale=1, num_conv=8, num_feat=24)
    assert not any(split(anime, "model"))
    for variant in ("esrgan", "valar"):
        rrdb = make_synthetic_rrdb_model(num_rrdb=1, variant=variant)
        assert split(rrdb, "model") == [True, True, False]


def test_cpu_chain_launches_no_kernel():
    rng = np.random.default_rng(70)
    layers = _port_layers(_specs(rng, [(3, 64, ACT_PRELU), (64, 64, ACT_PRELU)]))
    before = (conv3x3_chain.launches, conv3x3_chain.launches_sm90)
    conv3x3_chain(torch.zeros(1, 5, 6, 3), layers)
    assert (conv3x3_chain.launches, conv3x3_chain.launches_sm90) == before
