"""K8 parity on the CPU: the port's int8 chain (CPU tensors take
``conv3x3_chain_q8_plain``, also the port's ``q8_oracle``) against the JAX
Pallas ``conv3x3_chain_q8`` in interpret mode and the JAX ``q8_oracle``, on
the same numpy inputs, and the port's ``q8_bench`` entry point with the JAX
packages refused.

The routing rule (64->64 on the sm90 kernel, every other shape on the
``mma.sync`` kernel) and the sm90 kernel's packed weight image are pinned
here too: the image is read back by index arithmetic as the kernel's
64-byte-swizzled B layout, and a launch is traced against a stand-in
library.

Tolerances are the JAX suite's (``tests/test_conv_chain_q8.py:58-60``):
the integer conv is exact on both sides, and the f32 epilogue on the JAX
side may contract ``y * scale + bias`` into an FMA, so a final bf16 value
may sit one ulp away on a rounding boundary; >99.9% must be bit-equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from upscale_video_tpu.ops.conv_chain_q8 import (
    conv3x3_chain_q8 as jax_q8, q8_oracle as jax_oracle,
)
from upscale_video_tpu_torch.ops.common import (
    ACT_LEAKY, ACT_NONE, ACT_PRELU, ACT_RELU,
)
from upscale_video_tpu_torch.ops.conv_chain import embed
from upscale_video_tpu_torch.ops.conv_chain_q8 import (
    SM90_WPACK_BYTES, conv3x3_chain_q8, conv3x3_chain_q8_plain,
    launch_q8_layer, make_q8_layer, pack_q8_weights_sm90, q8_layer_plain,
    q8_layers_from_jax, q8_oracle, requantize, sm90_takes,
)
from tests.test_torch_winograd import run_bench_blocked


def make_q8_layers(rng, specs):
    """The JAX suite's layer dicts (``tests/test_conv_chain_q8.py:18-29``)."""
    layers = []
    for cin, cout, act in specs:
        layers.append({
            "wq": rng.integers(-127, 128, (3, 3, cin, cout)).astype(np.int8),
            "scale": rng.uniform(1e-4, 3e-4, (cout,)).astype(np.float32),
            "bias": rng.normal(0, 0.05, (cout,)).astype(np.float32),
            "slope": rng.uniform(0.1, 0.3, (cout,)).astype(np.float32),
            "inv_out": np.float32(rng.uniform(80.0, 130.0)),
            "act": act,
        })
    return layers


def _port(x8, layers):
    out = conv3x3_chain_q8(torch.from_numpy(x8)[None], q8_layers_from_jax(layers))
    assert out.dtype == torch.bfloat16
    return out[0].float().numpy()


@pytest.mark.parametrize(
    "h,w,specs",
    [
        (16, 24, [(64, 64, ACT_PRELU)] * 3),
        (20, 40, [(3, 32, ACT_RELU), (32, 64, ACT_PRELU),
                  (64, 48, ACT_NONE)]),
        (13, 19, [(64, 64, ACT_PRELU)] * 2),
    ],
)
@pytest.mark.parametrize("reference", ["kernel", "oracle"])
def test_q8_plain_matches_jax(h, w, specs, reference):
    rng = np.random.default_rng(42)
    layers = make_q8_layers(rng, specs)
    x8 = rng.integers(-127, 128, (h, w, specs[0][0])).astype(np.int8)
    if reference == "kernel":
        want = jax_q8(jnp.asarray(x8), layers, tile_h=8, tile_w=16,
                      interpret=True)
    else:
        want = jax_oracle(jnp.asarray(x8), layers)
    want = np.asarray(want, np.float32)
    got = _port(x8, layers)
    assert got.shape == want.shape == (h, w, specs[-1][1])
    np.testing.assert_allclose(got, want, rtol=2**-7, atol=2**-6)
    exact = np.mean(got == want)
    assert exact > 0.999, f"only {exact:.4%} bit-equal"


def test_q8_rejects_non_int8():
    layers = q8_layers_from_jax(
        make_q8_layers(np.random.default_rng(0), [(64, 64, ACT_PRELU)]))
    with pytest.raises(ValueError):
        conv3x3_chain_q8(torch.zeros((1, 8, 8, 64), dtype=torch.bfloat16), layers)
    with pytest.raises(ValueError):
        conv3x3_chain_q8(torch.zeros((1, 8, 8, 64), dtype=torch.int8,
                                     device="meta"), layers)


def test_q8_requant_saturates():
    """Pre-requant values far past +-127 saturate instead of wrapping
    through the int8 cast: bit-equal to the JAX oracle."""
    rng = np.random.default_rng(7)
    layers = make_q8_layers(rng, [(64, 64, ACT_NONE), (64, 64, ACT_NONE)])
    layers[0]["scale"] = np.full((64,), 1.0, np.float32)  # huge dequant
    layers[0]["inv_out"] = np.float32(1.0)
    x8 = rng.integers(-127, 128, (8, 16, 64)).astype(np.int8)
    want = np.asarray(jax_oracle(jnp.asarray(x8), layers), np.float32)
    np.testing.assert_array_equal(_port(x8, layers), want)


def test_requantize_rounds_half_to_even_and_clips():
    y = torch.tensor([0.5, 1.5, 2.5, -0.5, -1.5, 126.5, 127.5, 300.0, -300.0])
    q = requantize(y, 1.0)
    assert q.dtype == torch.int8
    assert q.tolist() == [0, 2, 2, 0, -2, 126, 127, 127, -127]


def test_q8_batch_equals_single_frames():
    rng = np.random.default_rng(5)
    layers = q8_layers_from_jax(make_q8_layers(
        rng, [(3, 16, ACT_PRELU), (16, 8, ACT_LEAKY), (8, 5, ACT_NONE)]))
    x8 = torch.from_numpy(rng.integers(-127, 128, (3, 11, 9, 3)).astype(np.int8))
    both = conv3x3_chain_q8(x8, layers)
    assert both.shape == (3, 11, 9, 5)
    for i in range(3):
        assert torch.equal(both[i], conv3x3_chain_q8(x8[i:i + 1], layers)[0])


def test_q8_layer_fields_broadcast_like_jax():
    """A scalar scale and a leaky scalar slope broadcast per channel, and
    pre-flattened (9*cin, cout) weights equal the HWIO ones."""
    rng = np.random.default_rng(6)
    wq = rng.integers(-127, 128, (3, 3, 4, 6)).astype(np.int8)
    a = make_q8_layer(wq, np.float32(2e-3), None, np.float32(0.2), 100.0,
                      ACT_LEAKY)
    b = make_q8_layer(wq.reshape(36, 6), np.full(6, 2e-3, np.float32),
                      np.zeros(6, np.float32), np.full(6, 0.2, np.float32),
                      100.0, ACT_LEAKY)
    for f in ("wmat", "scale", "bias", "slope"):
        assert torch.equal(getattr(a, f), getattr(b, f))
    x8 = rng.integers(-127, 128, (9, 7, 4)).astype(np.int8)
    layer = {"wq": wq, "scale": np.float32(2e-3), "slope": np.float32(0.2),
             "inv_out": 100.0, "act": ACT_LEAKY}
    want = np.asarray(jax_oracle(jnp.asarray(x8), [layer]), np.float32)
    got = conv3x3_chain_q8_plain(torch.from_numpy(x8)[None], [a])[0].float()
    np.testing.assert_allclose(got.numpy(), want, rtol=2**-7, atol=2**-6)
    assert q8_oracle is conv3x3_chain_q8_plain


def test_q8_bench_runs_on_cpu_without_jax(tmp_path):
    out = run_bench_blocked("upscale_video_tpu_torch.tools.q8_bench", tmp_path)
    lines = out.splitlines()
    assert lines[0] == "[device] cpu"
    for impl in ("q8", "direct", "cudnn"):
        assert any(l.startswith(f"[{impl}] body ") and "ms/layer" in l
                   for l in lines), out
    assert "[launches] conv3x3_chain_q8=0 conv3x3_chain=0" in lines
    assert "[launches_sm90] conv3x3_chain_q8=0 conv3x3_chain=0" in lines
    parity = [l for l in lines if l.startswith("[parity] q8 kernel")]
    assert len(parity) == 1 and "differ=0 " in parity[0], out
    assert parity[0].endswith("ok=True"), out


# (cin, cout): the sm90 kernel takes exactly 64 -> 64
Q8_SHAPES = [(64, 64), (3, 64), (64, 3), (32, 64), (64, 48), (128, 128),
             (64, 128), (16, 24)]


@pytest.mark.parametrize("cin,cout", Q8_SHAPES)
def test_sm90_takes_exactly_64_to_64(cin, cout):
    assert sm90_takes(cin, cout) == (cin == cout == 64)


@pytest.mark.parametrize("cin,cout", Q8_SHAPES)
def test_make_q8_layer_packs_only_the_sm90_shape(cin, cout):
    rng = np.random.default_rng(cin * 131 + cout)
    layer = make_q8_layer(
        rng.integers(-127, 128, (3, 3, cin, cout)).astype(np.int8), 1e-4)
    if cin == cout == 64:
        assert layer.wpack.dtype == torch.int8
        assert layer.wpack.shape == (SM90_WPACK_BYTES,)
        assert layer.wpack.is_contiguous()
    else:
        assert layer.wpack is None


def _unpack_sm90(wpack: np.ndarray) -> np.ndarray:
    """The (9*64, 64) matrix the sm90 kernel's wgmma reads from its packed
    image: byte ``o`` is tap ``o // 4096``, output channel (line) ``n``,
    physical 16-byte chunk ``p`` whose logical chunk is ``p ^ ((n >> 1) &
    3)`` (the 64-byte swizzle), byte ``o % 16`` of it."""
    o = np.arange(wpack.size)
    tap, r = o // 4096, o % 4096
    n = r // 64
    k = (((r % 64) // 16) ^ ((n >> 1) & 3)) * 16 + r % 16
    wmat = np.full((9 * 64, 64), 99, np.int16)
    wmat[tap * 64 + k, n] = wpack
    return wmat


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sm90_weight_image_unpacks_to_wmat(seed):
    rng = np.random.default_rng(seed)
    wq = rng.integers(-128, 128, (3, 3, 64, 64)).astype(np.int8)
    layer = make_q8_layer(wq, 1e-4)
    np.testing.assert_array_equal(_unpack_sm90(layer.wpack.numpy()),
                                  layer.wmat.numpy().astype(np.int16))
    np.testing.assert_array_equal(layer.wmat.numpy(), wq.reshape(576, 64))
    assert torch.equal(pack_q8_weights_sm90(layer.wmat), layer.wpack)


def test_q8_layers_from_jax_carry_the_sm90_image():
    layers = q8_layers_from_jax(make_q8_layers(
        np.random.default_rng(3),
        [(3, 64, ACT_PRELU), (64, 64, ACT_PRELU), (64, 48, ACT_NONE)]))
    assert [l.wpack is not None for l in layers] == [False, True, False]
    assert torch.equal(layers[1].wpack, pack_q8_weights_sm90(layers[1].wmat))


class _FakeLib:
    """Stands in for the kernel library: records which entry point a launch
    called and with which weight pointer."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name, args[2]))
            return 0
        return entry


class _Stream:
    cuda_stream = 0


@pytest.mark.parametrize("specs", [
    [(3, 64, ACT_PRELU), (64, 64, ACT_PRELU), (64, 64, ACT_LEAKY)],
    [(64, 64, ACT_NONE), (64, 48, ACT_RELU)],
    [(16, 24, ACT_PRELU), (24, 5, ACT_NONE)],
])
def test_launch_routes_64_to_64_to_the_sm90_kernel(monkeypatch, specs):
    """Each layer's launch picks its kernel by shape alone: 64->64 on the
    sm90 entry point with the packed image, every other shape on the
    mma.sync one with ``wmat``; ``launches_sm90`` counts the first."""
    from upscale_video_tpu_torch.kernels import build

    fake = _FakeLib()
    monkeypatch.setattr(build, "library", lambda: fake)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: _Stream())
    layers = q8_layers_from_jax(make_q8_layers(np.random.default_rng(4), specs))
    launches = conv3x3_chain_q8.launches
    sm90 = conv3x3_chain_q8.launches_sm90
    for i, l in enumerate(layers):
        src = embed(torch.zeros((1, 5, 7, l.cin), dtype=torch.int8), torch.int8)
        dst = torch.zeros((1, 7, 9, l.cout),
                          dtype=torch.int8 if i + 1 < len(layers) else torch.bfloat16)
        launch_q8_layer(src, dst, l)
    want = [("uvt_conv3x3_chain_q8_layer_sm90", l.wpack.data_ptr())
            if sm90_takes(l.cin, l.cout)
            else ("uvt_conv3x3_chain_q8_layer", l.wmat.data_ptr())
            for l in layers]
    assert fake.calls == want
    assert conv3x3_chain_q8.launches - launches == len(layers)
    assert conv3x3_chain_q8.launches_sm90 - sm90 == sum(
        sm90_takes(l.cin, l.cout) for l in layers)


@pytest.mark.parametrize("wpack", ["missing", "wrong_size", "wrong_dtype"])
def test_sm90_layer_without_its_image_raises(monkeypatch, wpack):
    """A 64->64 layer whose packed weights are missing or malformed raises
    before anything is built or launched: no fallback to mma.sync."""
    from upscale_video_tpu_torch.kernels import build

    def no_library():
        raise AssertionError("the library was asked for")

    monkeypatch.setattr(build, "library", no_library)
    (layer,) = q8_layers_from_jax(make_q8_layers(
        np.random.default_rng(5), [(64, 64, ACT_PRELU)]))
    bad = {"missing": None, "wrong_size": layer.wpack[:-16],
           "wrong_dtype": layer.wpack.to(torch.uint8)}[wpack]
    src = embed(torch.zeros((1, 5, 7, 64), dtype=torch.int8), torch.int8)
    with pytest.raises(ValueError, match="packed weights"):
        launch_q8_layer(src, torch.zeros_like(src), layer._replace(wpack=bad))


@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16])
def test_q8_layer_plain_is_one_step_of_the_chain(dtype):
    """``q8_layer_plain`` (the kernels' per-launch reference) is the
    chain's plain step on bordered buffers: a zero ring, and chained it
    gives the plain chain bit for bit."""
    rng = np.random.default_rng(6)
    layers = q8_layers_from_jax(make_q8_layers(
        rng, [(64, 64, ACT_PRELU), (64, 64, ACT_LEAKY)]))
    x8 = torch.from_numpy(rng.integers(-127, 128, (2, 9, 13, 64)).astype(np.int8))
    mid = q8_layer_plain(embed(x8, torch.int8), layers[0], dtype)
    assert mid.dtype == dtype and mid.shape == (2, 11, 15, 64)
    ring = torch.ones((11, 15), dtype=torch.bool)
    ring[1:-1, 1:-1] = False
    assert int(torch.count_nonzero(mid[:, ring].float())) == 0
    if dtype == torch.int8:
        out = q8_layer_plain(mid, layers[1], torch.bfloat16)
        assert torch.equal(out[:, 1:-1, 1:-1],
                           conv3x3_chain_q8_plain(x8, layers))
    else:
        assert torch.equal(mid[:, 1:-1, 1:-1],
                           conv3x3_chain_q8_plain(x8, layers[:1]))
