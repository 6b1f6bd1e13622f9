"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: every test skips with a reason on a host without a CUDA
device (the decision is made inside the fixture, never at import).  This
file imports no jax, so on a GPU host without jax it runs on its own::

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

Tolerances: K1 (its WMMA and its sm90 kernel alike) rounds each layer
once to bf16 after an f32 accumulation whose order differs from cuDNN's,
so a value may land one bf16 ulp away and the ulp propagates (the JAX
suite's chain bounds, tests/test_conv_chain.py:58,70; one layer alone
``2**-10 + 2**-7 * |want|``); K2's uint8 outputs may differ by 1 LSB
where that ulp-level difference straddles a rounding boundary.  K5 rounds
each per-source piece to bf16 after a tensor-core f32 sum whose order
differs from cuDNN's, so a piece may land one bf16 ulp away and move the
output by ``2**-6 + 2**-7 * |want|`` at these weights (N(0, 0.05), whose
pieces stay under |4|).  K6 sums the 5x5 box and the channel mean in f32 in
another order than the plain version and scales by reciprocals, so its
outputs agree within ``1e-5 + 1e-5 * |want|`` (measured: a few 1e-7).
K7's sm90 layer, like K1's, rounds once to bf16 after f32 sums in another
order: ``2**-10 + 2**-7 * |want|``.
K4 (its WMMA and its sm90 kernel alike) rounds once to bf16 after an f32
sum in another order than the plain version's: ``2**-10 + 2**-7 *
|want|``; a call that reads a channel view and writes at a channel offset
equals the contiguous call bit for bit and leaves the rest untouched.  K3's f32 layout differs by f32
sum order (``1e-4``), its u8 layouts by 1 LSB at a rounding boundary.
"""

import numpy as np
import pytest
import torch

from upscale_video_tpu_torch.ops.common import (
    ACT_LEAKY, ACT_NONE, ACT_PRELU, ACT_RELU,
)
from upscale_video_tpu_torch.kernels import build
from upscale_video_tpu_torch.ops.conv3x3 import (
    conv3x3_fused, conv3x3_fused_plain,
)
from upscale_video_tpu_torch.ops.conv3x3 import sm90_takes as k4_sm90_takes
from upscale_video_tpu_torch.ops.conv_chain import (
    conv3x3_chain, conv3x3_chain_plain, embed, launch_chain_layer, make_layer,
    sm90_takes,
)
from upscale_video_tpu_torch.ops.nlmeans import (
    nl_means_denoise, nl_means_denoise_plain,
)
from upscale_video_tpu_torch.ops.rdb import (
    GC, NF, pack_rdb_weights, rdb_block, rdb_block_plain,
)
from upscale_video_tpu_torch.ops.tail import (
    sr_tail_chain, sr_tail_chain_plain, sr_tail_fused, sr_tail_fused_plain,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _layers(rng, specs, dev):
    out = []
    for cin, cout, act in specs:
        slope = (rng.uniform(0.1, 0.3, (cout,)).astype(np.float32)
                 if act == ACT_PRELU else
                 np.asarray([0.2], np.float32) if act == ACT_LEAKY else None)
        out.append(make_layer(
            rng.normal(0, 0.15, (3, 3, cin, cout)).astype(np.float32),
            rng.normal(0, 0.05, (cout,)).astype(np.float32), slope, act,
            device=dev))
    return out


def _ring_is_zero(buf):
    ring = torch.ones(buf.shape[1:3], dtype=torch.bool, device=buf.device)
    ring[1:-1, 1:-1] = False
    return int(torch.count_nonzero(buf[:, ring])) == 0


@pytest.mark.parametrize("specs", [
    [(3, 16, ACT_PRELU), (16, 64, ACT_LEAKY), (64, 64, ACT_RELU),
     (64, 12, ACT_NONE)],
    [(3, 64, ACT_PRELU)] + [(64, 64, ACT_PRELU)] * 2,
    [(128, 128, ACT_PRELU), (128, 100, ACT_NONE)],
    [(3, 64, ACT_PRELU), (64, 64, ACT_LEAKY), (64, 64, ACT_PRELU),
     (64, 12, ACT_NONE)],
])
def test_chain_kernel_matches_plain(dev, specs):
    """A stack mixing both kernels (sm90 for 64 -> 64, WMMA for the rest);
    the counters split as ``sm90_takes`` says."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.uniform(0, 1, (2, 37, 53, specs[0][0]))
                         .astype(np.float32)).to(dev, torch.bfloat16)
    layers = _layers(rng, specs, dev)
    before = (conv3x3_chain.launches, conv3x3_chain.launches_sm90)
    got = conv3x3_chain(x, layers, crop=False)
    torch.cuda.synchronize()
    assert conv3x3_chain.launches - before[0] == len(layers)
    assert conv3x3_chain.launches_sm90 - before[1] == sum(
        sm90_takes(ci, co) for ci, co, _ in specs)
    want = conv3x3_chain_plain(x, layers, crop=False)
    torch.testing.assert_close(got.float(), want.float(), atol=5e-2, rtol=2e-2)
    assert _ring_is_zero(got)


@pytest.mark.parametrize("s", [2, 4])
@pytest.mark.parametrize("layout", ["planar", "frames", "model"])
def test_tail_kernel_matches_plain(dev, s, layout):
    rng = np.random.default_rng(2)
    n, h, w, cf = 2, 37, 53, 64
    inner = torch.from_numpy(rng.normal(0, 0.5, (n, h, w, cf)).astype(np.float32))
    buf = torch.nn.functional.pad(inner, (0, 0, 1, 1, 1, 1)).to(dev, torch.bfloat16)
    skip = torch.from_numpy(rng.uniform(0, 1, (n, h, w, 3)).astype(np.float32)
                            ).to(dev, torch.bfloat16)
    wmat = torch.from_numpy(rng.normal(0, 0.05, (9 * cf, 3 * s * s))
                            .astype(np.float32)).to(dev, torch.bfloat16)
    bias = torch.from_numpy(rng.normal(0, 0.05, (3 * s * s,))
                            .astype(np.float32)).to(dev)
    got = sr_tail_chain(buf, skip, wmat, bias, s, layout)
    torch.cuda.synchronize()
    want = sr_tail_chain_plain(buf, skip, wmat, bias, s, layout)
    assert got.shape == want.shape and got.dtype == want.dtype
    diff = (got.float() - want.float()).abs().max().item()
    assert diff <= (1e-4 if layout == "model" else 1.0)


@pytest.mark.parametrize("shape", [(1, 64, 128), (2, 37, 53), (1, 67, 130)])
@pytest.mark.parametrize("act", [ACT_NONE, ACT_PRELU, ACT_LEAKY, ACT_RELU])
def test_sm90_layer_matches_plain(dev, shape, act):
    """One 64 -> 64 layer on the sm90 kernel, W no multiple of its 64-wide
    tile and H no multiple of its 4 rows: one rounding after an f32 sum in
    another order, so within one bf16 ulp (``2**-10 + 2**-7 * |v|``); the
    ring stays zero."""
    rng = np.random.default_rng(3 + act)
    (layer,) = _layers(rng, [(64, 64, act)], dev)
    x = torch.from_numpy(rng.normal(0, 1, (*shape, 64)).astype(np.float32)
                         ).to(dev, torch.bfloat16)
    want = conv3x3_chain_plain(x, [layer], crop=False).float()
    src = embed(x)
    dst = torch.zeros_like(src)
    before = (conv3x3_chain.launches, conv3x3_chain.launches_sm90)
    launch_chain_layer(src, dst, layer)
    torch.cuda.synchronize()
    assert conv3x3_chain.launches - before[0] == 1
    assert conv3x3_chain.launches_sm90 - before[1] == 1
    assert bool(((dst.float() - want).abs()
                 <= 2.0 ** -10 + 2.0 ** -7 * want.abs()).all())
    assert _ring_is_zero(dst)


def test_engine_step_launches_each_kernel(dev):
    from upscale_video_tpu_torch.pipeline.chain import ChainEngine, ChainSpec

    eng = ChainEngine.build(ChainSpec(), 2, dev, synthetic=True)
    frames = torch.randint(0, 256, (4, 24, 40, 3), dtype=torch.uint8)
    k1, k2 = conv3x3_chain.launches, sr_tail_chain.launches
    sm90 = conv3x3_chain.launches_sm90
    out = eng.planar_step(frames)
    torch.cuda.synchronize()
    assert tuple(out.shape) == (4, 24, 40, 12)
    assert conv3x3_chain.launches - k1 == 17
    assert conv3x3_chain.launches_sm90 - sm90 == 16  # the 64 -> 64 body
    assert sr_tail_chain.launches - k2 == 1


def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    layer = make_layer(np.zeros((3, 3, 3, 8), np.float32), device=dev)
    with pytest.raises(TypeError, match="bf16"):
        conv3x3_chain(torch.zeros(1, 5, 5, 3, device=dev), [layer])
    f32 = make_layer(np.zeros((3, 3, 3, 8), np.float32), dtype=torch.float32,
                     device=dev)
    with pytest.raises(TypeError, match="bf16"):
        conv3x3_chain(torch.zeros(1, 5, 5, 3, device=dev, dtype=torch.bfloat16),
                      [f32])


def _rdb_weights(rng, dev):
    ws, bs = [], []
    for t in range(5):
        cin, cout = NF + t * GC, (NF if t == 4 else GC)
        ws.append(rng.normal(0, 0.05, (3, 3, cin, cout)).astype(np.float32))
        bs.append(rng.normal(0, 0.05, (cout,)).astype(np.float32))
    return pack_rdb_weights(ws, bs, rng.normal(0, 0.05, (1, 1, NF, GC)),
                            rng.normal(0, 0.05, (GC,)), device=dev)


@pytest.mark.parametrize("shape", [(2, 37, 53), (1, 14, 16), (3, 5, 70),
                                   (8, 576, 512), (1, 5, 7), (1, 61, 70)])
def test_rdb_kernel_matches_plain(dev, shape):
    """The Hopper kernel against the plain version, among them chip_smoke's
    [K5_sm90] shapes: the -m r tiles of a 1080p frame, a frame smaller than
    one 12x16 tile, and one whose rows and columns fit no whole tile."""
    rng = np.random.default_rng(3)
    wts = _rdb_weights(rng, dev)
    x = torch.from_numpy(rng.normal(0, 0.5, shape + (NF,)).astype(np.float32)
                         ).to(dev, torch.bfloat16)
    before, before_sm90 = rdb_block.launches, rdb_block.launches_sm90
    got = rdb_block(x, wts)
    torch.cuda.synchronize()
    assert rdb_block.launches - before == 1
    assert rdb_block.launches_sm90 - before_sm90 == 1
    want = rdb_block_plain(x, wts)
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    assert bool(torch.isfinite(got.float()).all())
    d = (got.float() - want.float()).abs()
    assert bool((d <= 2.0 ** -6 + 2.0 ** -7 * want.float().abs()).all())


def test_rdb_kernel_refuses_bad_inputs(dev):
    wts = _rdb_weights(np.random.default_rng(4), dev)
    x = torch.zeros(1, 8, 8, NF, device=dev, dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="bfloat16"):
        rdb_block(x.float(), wts)
    with pytest.raises(ValueError, match="contiguous"):
        rdb_block(x.permute(0, 2, 1, 3), wts)
    with pytest.raises(ValueError, match="takes"):
        rdb_block(x[..., :32].contiguous(), wts)
    with pytest.raises(ValueError, match="contiguous on"):
        rdb_block(x, wts._replace(wpack_sm90=wts.wpack_sm90.cpu()))
    with pytest.raises(ValueError, match="Hopper stream"):
        rdb_block(x, wts._replace(wpack_sm90=None))
    with pytest.raises(TypeError, match="bfloat16"):
        rdb_block(x, wts._replace(wpack_sm90=wts.wpack_sm90.float()))
    with pytest.raises(ValueError, match="values"):
        rdb_block(x, wts._replace(wpack_sm90=wts.wpack_sm90[:-8]))


def test_valar_step_launches_k5_per_block(dev):
    from upscale_video_tpu_torch.models.zoo import make_synthetic_rrdb_model
    from upscale_video_tpu_torch.pipeline.chain import ChainEngine, ChainSpec

    model = make_synthetic_rrdb_model(num_rrdb=2, device=dev,
                                      residual_dtype=torch.float32)
    eng = ChainEngine(ChainSpec(real_life=True), 4, model, dev, tile=16, halo=4)
    frames = torch.randint(0, 256, (1, 20, 24, 3), dtype=torch.uint8)
    k5, k5_sm90 = rdb_block.launches, rdb_block.launches_sm90
    out = eng.step(frames)
    torch.cuda.synchronize()
    assert tuple(out.shape) == (1, 80, 96, 3)
    assert rdb_block.launches - k5 == 6  # per block, one launch for 4 tiles
    assert rdb_block.launches_sm90 - k5_sm90 == 6  # every one on the sm90 kernel


def _noisy_gradient(rng, n, h, w):
    yy, xx = np.mgrid[0:h, 0:w]
    base = (0.5 + 0.3 * np.sin(xx / 7.0 + yy / 11.0))[None, ..., None]
    return np.clip(base + rng.normal(0, 0.03, (n, h, w, 3)), 0, 1).astype(np.float32)


@pytest.mark.parametrize("shape", [(2, 37, 53), (1, 5, 4)])
@pytest.mark.parametrize("h", [3.0, 30.0])
def test_nl_means_kernel_matches_plain(dev, shape, h):
    x = torch.from_numpy(_noisy_gradient(np.random.default_rng(5), *shape)).to(dev)
    before = nl_means_denoise.launches
    got = nl_means_denoise(x, h)
    torch.cuda.synchronize()
    assert nl_means_denoise.launches - before == 1
    want = nl_means_denoise_plain(x, h)
    assert got.shape == want.shape and got.dtype == torch.float32
    assert bool((got - want).abs().le(1e-5 + 1e-5 * want.abs()).all())


def test_nl_means_wrapper_raises_when_the_build_fails(dev, monkeypatch, tmp_path):
    """No nvcc: the CUDA wrapper raises; it never runs the plain version."""
    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(build, "_lib", None)
    monkeypatch.setattr(build, "library_path", lambda: tmp_path / "missing.so")
    monkeypatch.setattr(build, "find_nvcc", no_nvcc)
    before = nl_means_denoise.launches
    with pytest.raises(RuntimeError, match="nvcc"):
        nl_means_denoise(torch.zeros(1, 8, 8, 3, device=dev), 3.0)
    assert nl_means_denoise.launches == before
    with pytest.raises(TypeError, match="float32"):
        nl_means_denoise(torch.zeros(1, 8, 8, 3, device=dev, dtype=torch.half), 3.0)


def test_prelude_step_launches_each_kernel(dev):
    """``-m a,n=3`` + 2x Compact: one K6 launch for the batch, the anime
    model's 10-layer K1 chain and Compact's 17 layers, one K2 launch."""
    from upscale_video_tpu_torch.pipeline.chain import ChainEngine, ChainSpec

    eng = ChainEngine.build(ChainSpec.parse("a,n=3"), 2, dev, synthetic=True)
    frames = torch.randint(0, 256, (4, 24, 40, 3), dtype=torch.uint8)
    k1, k2, k6 = (conv3x3_chain.launches, sr_tail_chain.launches,
                  nl_means_denoise.launches)
    out = eng.planar_step(frames)
    torch.cuda.synchronize()
    assert tuple(out.shape) == (4, 24, 40, 12)
    assert nl_means_denoise.launches - k6 == 1
    assert conv3x3_chain.launches - k1 == 10 + 17
    assert sr_tail_chain.launches - k2 == 1


@pytest.mark.parametrize("cin", [3, 12, 64, 96, 160, 192])
@pytest.mark.parametrize("cout", [3, 32, 64])
@pytest.mark.parametrize("act", [ACT_NONE, ACT_PRELU, ACT_LEAKY, ACT_RELU])
def test_conv3x3_kernel_matches_plain(dev, cin, cout, act):
    rng = np.random.default_rng(cin * 1000 + cout * 10 + act)
    x = torch.from_numpy(rng.uniform(-1, 1, (2, 37, 53, cin)).astype(np.float32)
                         ).to(dev, torch.bfloat16)
    wmat = torch.from_numpy(rng.normal(0, 1 / np.sqrt(9 * cin), (9 * cin, cout))
                            .astype(np.float32)).to(dev, torch.bfloat16)
    bias = torch.from_numpy(rng.normal(0, 0.1, (cout,)).astype(np.float32)).to(dev)
    slope = (torch.from_numpy(rng.uniform(0.1, 0.3, (cout,)).astype(np.float32)
                              ).to(dev) if act == ACT_PRELU
             else 0.2 if act == ACT_LEAKY else None)
    before = conv3x3_fused.launches
    got = conv3x3_fused(x, wmat, bias, slope, act)
    torch.cuda.synchronize()
    assert conv3x3_fused.launches - before == 1
    want = conv3x3_fused_plain(x, wmat, bias, slope, act)
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    d = (got.float() - want.float()).abs()
    assert bool((d <= 2.0 ** -10 + 2.0 ** -7 * want.float().abs()).all())


@pytest.mark.parametrize("cf", [64, 160, 512])
@pytest.mark.parametrize("s", [2, 4])
@pytest.mark.parametrize("layout", ["planar", "frames", "model"])
def test_plain_input_tail_kernel_matches_plain(dev, cf, s, layout):
    rng = np.random.default_rng(cf + s)
    u = torch.from_numpy(rng.normal(0, 0.5, (2, 37, 53, cf)).astype(np.float32)
                         ).to(dev, torch.bfloat16)
    skip = torch.from_numpy(rng.uniform(0, 1, (2, 37, 53, 3)).astype(np.float32)
                            ).to(dev, torch.bfloat16)
    wmat = torch.from_numpy(rng.normal(0, 0.3 / np.sqrt(9 * cf), (9 * cf, 3 * s * s))
                            .astype(np.float32)).to(dev, torch.bfloat16)
    bias = torch.from_numpy(rng.normal(0, 0.05, (3 * s * s,)).astype(np.float32)
                            ).to(dev)
    before = sr_tail_fused.launches
    got = sr_tail_fused(u, skip, wmat, bias, s, layout)
    torch.cuda.synchronize()
    assert sr_tail_fused.launches - before == 1
    want = sr_tail_fused_plain(u, skip, wmat, bias, s, layout)
    assert got.shape == want.shape and got.dtype == want.dtype
    diff = (got.float() - want.float()).abs().max().item()
    assert diff <= (1e-4 if layout == "model" else 1.0)


def test_esrgan_forward_runs_every_solo_3x3_conv_on_k4(dev, monkeypatch):
    """A 1-RRDB basicsr RRDBNet on the card: its 18 solo 3x3 convs are K4
    launches, its last three one K1 chain, and no SAME 3x3 conv reaches
    ``F.conv2d``."""
    import torch.nn.functional as F

    from upscale_video_tpu_torch.models import ops
    from upscale_video_tpu_torch.models.zoo import make_synthetic_rrdb_model

    seen = []
    real = F.conv2d

    def spy(x, w, *a, **k):
        seen.append((tuple(w.shape), x.device.type))
        return real(x, w, *a, **k)

    monkeypatch.setattr(ops.F, "conv2d", spy)
    model = make_synthetic_rrdb_model(num_rrdb=1, device=dev, variant="esrgan")
    k4, k1 = conv3x3_fused.launches, conv3x3_chain.launches
    k4_sm90 = conv3x3_fused.launches_sm90
    out = model(torch.rand(1, 12, 16, 3, device=dev), "frames")
    torch.cuda.synchronize()
    assert tuple(out.shape) == (1, 48, 64, 3)
    assert conv3x3_fused.launches - k4 == 1 + 15 + 2
    assert conv3x3_fused.launches_sm90 - k4_sm90 == 15 + 2  # all but conv_first
    assert conv3x3_chain.launches - k1 == 3
    assert not [s for s, d in seen if d == "cuda" and s[2:] == (3, 3)]


# chip_smoke.py's K4_SHAPES rows (cin, cout, act): conv_first, the five
# dense convs, conv_up1, a wide SRVGG body layer, the x2plus conv_first
K4_ROWS = [(3, 64, ACT_NONE), (64, 32, ACT_LEAKY), (96, 32, ACT_LEAKY),
           (128, 32, ACT_LEAKY), (160, 32, ACT_LEAKY), (192, 64, ACT_NONE),
           (64, 64, ACT_LEAKY), (160, 160, ACT_PRELU), (12, 64, ACT_NONE)]


@pytest.mark.parametrize("shape", [(2, 37, 53), (1, 67, 130)])
@pytest.mark.parametrize("cin,cout,act", K4_ROWS)
def test_k4_sm90_matches_plain_contiguous_and_sliced(dev, shape, cin, cout, act):
    """Each row on the kernel ``k4_sm90_takes`` names, against the plain
    version; then read from channels [0, cin) of a wider buffer (junk
    past cin) and written at channel offset 8 of a sentinel-filled one:
    the contiguous call's bits, every other channel untouched."""
    rng = np.random.default_rng(cin * 1000 + cout + shape[1])
    src = torch.from_numpy(rng.normal(0, 1, (*shape, cin + 32)).astype(np.float32)
                           ).to(dev, torch.bfloat16)
    src[..., cin:] *= 100
    x = src[..., :cin].contiguous()
    wmat = torch.from_numpy(rng.normal(0, 1 / np.sqrt(9 * cin), (9 * cin, cout))
                            .astype(np.float32)).to(dev, torch.bfloat16)
    bias = torch.from_numpy(rng.normal(0, 0.1, (cout,)).astype(np.float32)).to(dev)
    slope = (torch.from_numpy(rng.uniform(0.1, 0.3, (cout,)).astype(np.float32)
                              ).to(dev) if act == ACT_PRELU
             else 0.2 if act == ACT_LEAKY else None)
    sm90 = conv3x3_fused.launches_sm90
    got = conv3x3_fused(x, wmat, bias, slope, act)
    torch.cuda.synchronize()
    assert conv3x3_fused.launches_sm90 - sm90 == k4_sm90_takes(cin, cout, torch.bfloat16)
    want = conv3x3_fused_plain(x, wmat, bias, slope, act)
    d = (got.float() - want.float()).abs()
    assert bool((d <= 2.0 ** -10 + 2.0 ** -7 * want.float().abs()).all())
    out = torch.full((*shape, cout + 24), 7.0, dtype=torch.bfloat16, device=dev)
    view = conv3x3_fused(src[..., :cin], wmat, bias, slope, act, out=out, out_off=8)
    torch.cuda.synchronize()
    assert torch.equal(view, got)
    assert bool((out[..., :8] == 7).all()) and bool((out[..., 8 + cout:] == 7).all())


def test_esrgan_dense_buffer_equals_the_concat_path_on_the_card(dev, monkeypatch):
    """The dense blocks on one shared buffer read the bytes their Concats
    would have made, so the same kernels give the same output."""
    from upscale_video_tpu_torch.models import executor
    from upscale_video_tpu_torch.models.zoo import make_synthetic_rrdb_model

    model = make_synthetic_rrdb_model(num_rrdb=1, device=dev, variant="esrgan")
    x = torch.rand(1, 21, 35, 3, device=dev)
    got = model(x, "model")
    assert len(model.frames_forward("model").dense) == 15
    monkeypatch.setattr(executor, "_plan_dense_buffers", lambda *a: ({}, set()))
    cat_model = make_synthetic_rrdb_model(num_rrdb=1, device=dev, variant="esrgan")
    want = cat_model(x, "model")
    assert not cat_model.frames_forward("model").dense
    assert torch.equal(got, want)


def test_wide_srvgg_step_launches_k4_and_k3(dev):
    from upscale_video_tpu_torch.models.zoo import Model, make_srvgg_graph
    from upscale_video_tpu_torch.models.bin_loader import synthesize_weights

    g = make_srvgg_graph(scale=4, num_conv=2, num_feat=160)
    model = Model("wide", 4, g, synthesize_weights(g, seed=0), dev)
    k4, k3 = conv3x3_fused.launches, sr_tail_fused.launches
    out = model(torch.rand(2, 12, 16, 3, device=dev), "planar")
    torch.cuda.synchronize()
    assert tuple(out.shape) == (2, 12, 16, 48) and out.dtype == torch.uint8
    assert conv3x3_fused.launches - k4 == 3 and sr_tail_fused.launches - k3 == 1


def _wino_layers(rng, specs, dev):
    from upscale_video_tpu_torch.ops.conv_winograd import make_wino_layer

    out = []
    for cin, cout, act in specs:
        slope = (rng.uniform(0.1, 0.3, (cout,)).astype(np.float32)
                 if act == ACT_PRELU else
                 np.asarray([0.2], np.float32) if act == ACT_LEAKY else None)
        out.append(make_wino_layer(
            rng.normal(0, 0.15, (3, 3, cin, cout)).astype(np.float32),
            rng.normal(0, 0.05, (cout,)).astype(np.float32), slope, act,
            device=dev))
    return out


@pytest.mark.parametrize("shape,specs", [
    ((2, 37, 53), [(3, 64, ACT_PRELU), (64, 64, ACT_PRELU), (64, 64, ACT_PRELU)]),
    ((2, 19, 37), [(6, 8, ACT_PRELU), (8, 16, ACT_LEAKY), (16, 4, ACT_RELU)]),
    ((1, 33, 40), [(128, 128, ACT_PRELU), (128, 100, ACT_NONE)]),
    ((3, 1, 5), [(8, 24, ACT_NONE)]),
])
@pytest.mark.parametrize("crop", [True, False])
def test_winograd_kernel_matches_plain(dev, shape, specs, crop):
    """K7 vs its plain version: K1's stack bounds (one bf16 ulp per layer
    after an f32 sum in another order, propagating); odd heights drop the
    last pair's second row; cout 128 splits over two blocks.  The 64 -> 64
    layers launch the sm90 kernel and the rest the WMMA kernel (the first
    stack: its 3 -> 64 head on WMMA, two layers on sm90); the bordered
    output's ring stays zero."""
    from upscale_video_tpu_torch.ops.conv_winograd import (
        sm90_takes, winograd_chain, winograd_chain_plain,
    )

    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.uniform(0, 1, shape + (specs[0][0],))
                         .astype(np.float32)).to(dev, torch.bfloat16)
    layers = _wino_layers(rng, specs, dev)
    before = (winograd_chain.launches, winograd_chain.launches_sm90)
    got = winograd_chain(x, layers, crop=crop)
    torch.cuda.synchronize()
    assert winograd_chain.launches - before[0] == len(specs)
    assert winograd_chain.launches_sm90 - before[1] == sum(
        sm90_takes(ci, co) for ci, co, _ in specs)
    want = winograd_chain_plain(x, layers, crop=crop)
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    d = (got.float() - want.float()).abs()
    assert bool((d <= 5e-2 + 2e-2 * want.float().abs()).all()), d.max().item()
    assert crop or _ring_is_zero(got)


@pytest.mark.parametrize("shape", [(1, 5, 7), (2, 37, 53), (1, 61, 70),
                                   (4, 64, 128)])
@pytest.mark.parametrize("act", [ACT_NONE, ACT_PRELU, ACT_LEAKY, ACT_RELU])
def test_wino_sm90_layer_matches_plain(dev, shape, act):
    """One 64 -> 64 layer on K7's sm90 kernel, odd H and W no multiple of
    its 64-wide tile: one rounding after f32 sums in another order, so
    within one bf16 ulp (``2**-10 + 2**-7 * |v|``); finite, and the ring
    stays zero."""
    from upscale_video_tpu_torch.ops.conv_winograd import (
        launch_wino_layer, sm90_takes, winograd_chain, winograd_chain_plain,
    )

    assert sm90_takes(64, 64)
    rng = np.random.default_rng(13 + act)
    (layer,) = _wino_layers(rng, [(64, 64, act)], dev)
    x = torch.from_numpy(rng.normal(0, 1, (*shape, 64)).astype(np.float32)
                         ).to(dev, torch.bfloat16)
    want = winograd_chain_plain(x, [layer], crop=False).float()
    src = embed(x)
    dst = torch.zeros_like(src)
    before = (winograd_chain.launches, winograd_chain.launches_sm90)
    launch_wino_layer(src, dst, layer)
    torch.cuda.synchronize()
    assert winograd_chain.launches - before[0] == 1
    assert winograd_chain.launches_sm90 - before[1] == 1
    assert bool(torch.isfinite(dst.float()).all())
    assert bool(((dst.float() - want).abs()
                 <= 2.0 ** -10 + 2.0 ** -7 * want.abs()).all())
    assert _ring_is_zero(dst)


@pytest.mark.parametrize("shape,specs", [
    ((2, 37, 53), [(3, 64, ACT_PRELU), (64, 64, ACT_PRELU), (64, 64, ACT_PRELU)]),
    ((2, 20, 40), [(3, 32, ACT_RELU), (32, 64, ACT_PRELU), (64, 48, ACT_NONE)]),
    ((1, 13, 19), [(64, 64, ACT_LEAKY)] * 2),
    ((1, 33, 40), [(128, 128, ACT_PRELU), (128, 100, ACT_NONE)]),
    ((1, 9, 11), [(16, 24, ACT_PRELU), (24, 5, ACT_NONE)]),
])
def test_q8_kernel_equals_plain(dev, shape, specs):
    """K8 vs its plain version: exact int32 sums and the same f32 epilogue
    ops, so every value is bit-equal, requantised layers included."""
    from upscale_video_tpu_torch.ops.conv_chain_q8 import (
        conv3x3_chain_q8, conv3x3_chain_q8_plain, make_q8_layer,
    )

    rng = np.random.default_rng(12)
    layers = [make_q8_layer(
        rng.integers(-127, 128, (3, 3, cin, cout)).astype(np.int8),
        rng.uniform(1e-4, 3e-4, (cout,)).astype(np.float32),
        rng.normal(0, 0.05, (cout,)).astype(np.float32),
        rng.uniform(0.1, 0.3, (cout,)).astype(np.float32),
        np.float32(rng.uniform(80.0, 130.0)), act, device=dev)
        for cin, cout, act in specs]
    x8 = torch.from_numpy(rng.integers(-127, 128, shape + (specs[0][0],))
                          .astype(np.int8)).to(dev)
    before = conv3x3_chain_q8.launches
    got = conv3x3_chain_q8(x8, layers)
    torch.cuda.synchronize()
    assert conv3x3_chain_q8.launches - before == len(specs)
    want = conv3x3_chain_q8_plain(x8, layers)
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    assert torch.equal(got, want)
