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
    NARROW_SHAPES, ChainLayer, chain_kernel, conv3x3_chain,
    conv3x3_chain_plain, embed, in_width, make_layer, narrow_plan,
    out_width, pack_narrow_weights, sm90_takes,
)
from tests.torch_fixtures import one_torch_thread  # noqa: F401


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
    """The 64 -> 64 Hopper kernel (``csrc/conv3x3_chain_sm90.cu``) takes
    exactly 64 -> 64: its resident weights and halo ring are sized for it."""
    assert (chain_kernel(cin, cout) == "sm90") is takes


@pytest.mark.parametrize("cin,cout,kernel", [
    # the eight shapes the 64 -> 64 rule was pinned at
    (64, 64, "sm90"), (3, 64, "narrow"), (24, 24, "narrow"), (64, 12, "wmma"),
    (128, 128, "wmma"), (64, 128, "wmma"), (32, 64, "wmma"), (64, 3, "narrow"),
    # the narrow kernel's other product shapes
    (3, 24, "narrow"), (24, 3, "narrow"),
    # shapes that stay on WMMA: other heads and widths, imported odd widths
    (3, 16, "wmma"), (3, 32, "wmma"), (16, 16, "wmma"), (24, 64, "wmma"),
    (64, 24, "wmma"), (3, 3, "wmma"), (100, 3, "wmma"), (12, 12, "wmma"),
])
def test_chain_kernel_by_shape(cin, cout, kernel):
    """The kernel choice is a pure function of the layer's shape: 64 -> 64
    on the sm90 kernel, the five narrow product shapes on the narrow
    Hopper kernel, every other shape on WMMA; ``sm90_takes`` is either
    Hopper kernel."""
    assert chain_kernel(cin, cout) == kernel
    assert sm90_takes(cin, cout) is (kernel != "wmma")
    assert ((cin, cout) in NARROW_SHAPES) is (kernel == "narrow")


def test_planned_chains_split_as_sm90_takes():
    """The default Compact chain runs all 17 layers on Hopper (its 3 -> 64
    head on the narrow kernel, the body on the sm90 kernel); the anime
    chain (nf 24) all 10 on the narrow kernel; ESRGAN's and Valar's last
    chain (up2 -> hr -> last) all three, conv_last (64 -> 3) narrow.
    Planning packs every narrow layer's weights once."""
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
        layers = chain_layers(items, model.state)
        for l in layers:
            assert (l.wpack is not None) is (chain_kernel(l.cin, l.cout) == "narrow")
        assert [sm90_takes(l.cin, l.cout) for l in layers] == [True] * len(layers)
        return [chain_kernel(l.cin, l.cout) for l in layers]

    assert split(make_synthetic_model(scale=2), "planar") == ["narrow"] + ["sm90"] * 16
    anime = make_synthetic_model(scale=1, num_conv=8, num_feat=24)
    assert split(anime, "model") == ["narrow"] * 10
    for variant in ("esrgan", "valar"):
        rrdb = make_synthetic_rrdb_model(num_rrdb=1, variant=variant)
        assert split(rrdb, "model") == ["sm90", "sm90", "narrow"]


def _image_b(layer):
    """B as the narrow kernel's wgmma reads it from the packed image:
    ``(3, 16 * ks, n)`` f32.  Per dy, 64-wide K atoms of ``n`` lines of 128
    bytes (one per output channel, K-major), 16-byte chunk ``j`` of line
    ``col`` at chunk ``j ^ (col % 8)`` (the B128 swizzle of
    ``desc_sw128``); k step ``kk`` starts 32 bytes into atom ``kk // 4``."""
    return _image_read(layer)[0]


def _image_read(layer):
    """``(B, mask)``: :func:`_image_b` and which image entries it read."""
    _, n, ks, atoms = narrow_plan(layer.cin, layer.cout)
    img = layer.wpack.float()
    b = torch.empty((3, 16 * ks, n))
    read = torch.zeros(img.numel(), dtype=torch.bool)
    for dy in range(3):
        for k in range(16 * ks):
            a, kin = divmod(k, 64)
            for col in range(n):
                pos = ((dy * atoms + a) * n + col) * 64 + ((kin // 8) ^ (col % 8)) * 8
                b[dy, k, col] = img[pos + kin % 8]
                read[pos + kin % 8] = True
    return b, read


@pytest.mark.parametrize("cin,cout", sorted(NARROW_SHAPES))
def test_narrow_pack_unpacks_to_wmat(cin, cout):
    """The packed B (dx folded into K, K padded to 16, N padded to 8)
    read back as the kernel reads it is ``wmat``, every pad entry zero,
    and the image holds nothing else."""
    rng = np.random.default_rng(80 + cin + cout)
    layer = make_layer(rng.normal(0, 0.15, (3, 3, cin, cout)).astype(np.float32))
    cs, n, ks, atoms = narrow_plan(cin, cout)
    assert layer.wpack.dtype == torch.bfloat16
    assert layer.wpack.numel() == 3 * atoms * n * 64
    assert n == -(-cout // 8) * 8 and 16 * ks >= 3 * cs > 16 * (ks - 1)
    b, read = _image_read(layer)
    want = torch.zeros((3, 3, cs, n))
    want[:, :, :cin, :cout] = layer.wmat.float().view(3, 3, cin, cout)
    want = torch.cat([want.view(3, 3 * cs, n),
                      torch.zeros((3, 16 * ks - 3 * cs, n))], 1)
    assert torch.equal(b, want)
    assert int(read.sum()) == b.numel()  # each entry read once
    assert torch.count_nonzero(layer.wpack[~read]) == 0


def _folded_gemm(x, layer):
    """A CPU mirror of the narrow kernel's folded GEMM in f32: for output
    pixel (y, x) and each dy, the A row is the bordered buffer's contiguous
    run of 16 * ks values from pixel x of row y + dy (the taps x-1, x, x+1
    of all ``cs`` channels, then padding; a 16-byte chunk wholly in the
    padding reads the chunk before it, as the kernel does), times B read
    from the packed image; + bias, activation.  Returns all ``n`` output
    channels."""
    cs, n, ks, _ = narrow_plan(layer.cin, layer.cout)
    buf = embed(x.float(), torch.float32, width=cs)
    nb, hp, wp, _ = buf.shape
    h, w = hp - 2, wp - 2
    rows = buf.reshape(nb, hp, wp * cs)
    k = torch.arange(16 * ks)
    k = torch.where(k // 8 * 8 >= 3 * cs, k - 8, k)
    cols = (torch.arange(w) * cs).view(-1, 1) + k.view(1, -1)  # (w, 16 ks)
    b = _image_b(layer)
    out = torch.zeros((nb, h, w, n))
    for dy in range(3):
        a = rows[:, dy:dy + h][:, :, cols]  # (nb, h, w, 16 ks)
        out += a @ b[dy]
    bias = torch.zeros(n)
    bias[:layer.cout] = layer.bias
    slope = torch.zeros(n)
    slope[:layer.cout] = layer.slope
    y = out + bias
    if layer.act == ACT_RELU:
        return torch.clamp_min(y, 0.0)
    if layer.act in (ACT_PRELU, ACT_LEAKY):
        return torch.where(y >= 0, y, y * slope)
    return y


@pytest.mark.parametrize("cin,cout", sorted(NARROW_SHAPES))
@pytest.mark.parametrize("act", [ACT_NONE, ACT_PRELU])
def test_folded_gemm_mirror_equals_plain(cin, cout, act):
    """Windows of a bordered NHWC row times the packed B, in f32, equal
    ``conv3x3_chain_plain`` in f32 (same bf16 weights) at each narrow
    shape; the padded output channels are zero."""
    rng = np.random.default_rng(90 + cin + cout + act)
    spec = _specs(rng, [(cin, cout, act)])[0]
    layer = make_layer(spec["weight"], spec["bias"], spec.get("slope"), act)
    x = torch.from_numpy(rng.normal(0, 1, (2, 7, 11, cin)).astype(np.float32))
    got = _folded_gemm(x, layer)
    f32 = ChainLayer(layer.wmat.float(), layer.bias, layer.slope, act)
    want = conv3x3_chain_plain(x, [f32])
    torch.testing.assert_close(got[..., :cout], want, atol=1e-5, rtol=1e-5)
    assert torch.count_nonzero(got[..., cout:]) == 0


def test_only_narrow_bf16_layers_are_packed():
    """The packed image exists for the narrow kernel's shapes in bf16 and
    for nothing else (64 -> 64, WMMA shapes, the f32 CPU path)."""
    def pack(cin, cout, dtype=torch.bfloat16):
        w = np.ones((3, 3, cin, cout), np.float32)
        return make_layer(w, dtype=dtype).wpack

    assert all(pack(ci, co) is not None for ci, co in NARROW_SHAPES)
    assert pack(64, 64) is None and pack(3, 16) is None and pack(64, 12) is None
    assert pack(24, 24, torch.float32) is None
    assert pack_narrow_weights(make_layer(np.ones((3, 3, 3, 64), np.float32),
                                          dtype=torch.float32).wmat) is None


def test_narrow_buffers_are_8_wide():
    """On the kernel path a 3-channel buffer of the narrow kernel is 8 wide:
    the embed's channels 3..7 and ring are zero; every other width is the
    layer's own."""
    rng = np.random.default_rng(100)
    x = torch.from_numpy(rng.uniform(0.5, 1, (2, 5, 6, 3)).astype(np.float32))
    buf = embed(x, width=8)
    assert buf.shape == (2, 7, 8, 8) and buf.dtype == torch.bfloat16
    assert torch.count_nonzero(buf[..., 3:]) == 0
    ring = torch.ones(7, 8, dtype=torch.bool)
    ring[1:-1, 1:-1] = False
    assert torch.count_nonzero(buf[:, ring]) == 0
    assert torch.equal(buf[:, 1:-1, 1:-1, :3], x.to(torch.bfloat16))
    widths = {}
    for cin, cout in [(3, 64), (3, 24), (24, 3), (64, 3), (24, 24), (3, 16),
                      (16, 3), (64, 64)]:
        layer = make_layer(np.zeros((3, 3, cin, cout), np.float32))
        widths[(cin, cout)] = (in_width(layer), out_width(layer))
    assert widths == {(3, 64): (8, 64), (3, 24): (8, 24), (24, 3): (24, 8),
                      (64, 3): (64, 8), (24, 24): (24, 24), (3, 16): (3, 16),
                      (16, 3): (16, 3), (64, 64): (64, 64)}


def test_cpu_chain_launches_no_kernel():
    rng = np.random.default_rng(70)
    layers = _port_layers(_specs(rng, [(3, 64, ACT_PRELU), (64, 64, ACT_PRELU)]))
    before = (conv3x3_chain.launches, conv3x3_chain.launches_sm90,
              conv3x3_chain.launches_narrow)
    conv3x3_chain(torch.zeros(1, 5, 6, 3), layers)
    assert (conv3x3_chain.launches, conv3x3_chain.launches_sm90,
            conv3x3_chain.launches_narrow) == before
