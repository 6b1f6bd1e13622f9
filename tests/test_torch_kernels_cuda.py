"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: every test skips with a reason on a host without a CUDA
device (the decision is made inside the fixture, never at import).  This
file imports no jax, so on a GPU host without jax it runs on its own::

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

Tolerances: K1 (its WMMA and its two Hopper kernels alike) rounds each layer
once to bf16 after an f32 accumulation whose order differs from cuDNN's,
so a value may land one bf16 ulp away and the ulp propagates (the JAX
suite's chain bounds, tests/test_conv_chain.py:58,70; one layer alone
``2**-10 + 2**-7 * |want|``); K2's uint8 outputs may differ by 1 LSB
where that ulp-level difference straddles a rounding boundary.  K5 rounds
each per-source piece to bf16 after a tensor-core f32 sum whose order
differs from cuDNN's, so a piece may land one bf16 ulp away and move the
output by ``2**-6 + 2**-7 * |want|`` at these weights (N(0, 0.05), whose
pieces stay under |4|).  K6 sums the 5x5 box and the channel mean in f32 in
another order than the plain version, folds the scales into one and takes
the SFU's ex2, so its outputs agree within ``1e-5 + 1e-5 * |want|``
(measured: about 1e-6).
K7's sm90 layer, like K1's, rounds once to bf16 after f32 sums in another
order: ``2**-10 + 2**-7 * |want|``.
K8 (its mma.sync and its sm90 kernel alike) sums exactly in int32 and runs
the plain version's f32 epilogue op for op: bit-equal.
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
    NARROW_SHAPES, chain_kernel, conv3x3_chain, conv3x3_chain_plain, embed,
    in_width, launch_chain_layer, make_layer, out_width, sm90_takes,
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
    [(3, 24, ACT_PRELU), (24, 24, ACT_PRELU), (24, 3, ACT_NONE)],
    [(64, 64, ACT_LEAKY), (64, 3, ACT_NONE)],
    [(24, 3, ACT_RELU), (3, 16, ACT_PRELU), (16, 3, ACT_NONE),
     (3, 24, ACT_LEAKY)],
])
def test_chain_kernel_matches_plain(dev, specs):
    """A stack mixing the three kernels (sm90 for 64 -> 64, narrow for its
    five shapes, WMMA for the rest; a 3-channel buffer between the narrow
    kernel and WMMA changes width); the counters split as
    ``chain_kernel`` says."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.uniform(0, 1, (2, 37, 53, specs[0][0]))
                         .astype(np.float32)).to(dev, torch.bfloat16)
    layers = _layers(rng, specs, dev)
    before = (conv3x3_chain.launches, conv3x3_chain.launches_sm90,
              conv3x3_chain.launches_narrow)
    got = conv3x3_chain(x, layers, crop=False)
    torch.cuda.synchronize()
    assert conv3x3_chain.launches - before[0] == len(layers)
    assert conv3x3_chain.launches_sm90 - before[1] == sum(
        sm90_takes(ci, co) for ci, co, _ in specs)
    assert conv3x3_chain.launches_narrow - before[2] == sum(
        chain_kernel(ci, co) == "narrow" for ci, co, _ in specs)
    assert got.shape == (2, 39, 55, specs[-1][1])
    want = conv3x3_chain_plain(x, layers, crop=False)
    torch.testing.assert_close(got.float(), want.float(), atol=5e-2, rtol=2e-2)
    assert _ring_is_zero(got)


TAIL_LAYOUTS = [("planar", False), ("frames", False), ("model", False),
                ("yuv420", False), ("yuv420", True)]


def _tail_inputs(rng, n, h, w, cf, s, dev, bordered):
    inner = torch.from_numpy(rng.normal(0, 0.5, (n, h, w, cf)).astype(np.float32))
    x = torch.nn.functional.pad(inner, (0, 0, 1, 1, 1, 1)) if bordered else inner
    skip = torch.from_numpy(rng.uniform(0, 1, (n, h, w, 3)).astype(np.float32))
    wmat = torch.from_numpy(rng.normal(0, 0.3 / np.sqrt(9 * cf), (9 * cf, 3 * s * s))
                            .astype(np.float32))
    bias = torch.from_numpy(rng.normal(0, 0.05, (3 * s * s,)).astype(np.float32))
    return (x.to(dev, torch.bfloat16), skip.to(dev, torch.bfloat16),
            wmat.to(dev, torch.bfloat16), bias.to(dev))


def _tail_close(got, want, layout):
    assert got.shape == want.shape and got.dtype == want.dtype
    diff = (got.float() - want.float()).abs().max().item()
    assert diff <= (1e-4 if layout == "model" else 1.0)


@pytest.mark.parametrize("shape", [(2, 37, 53), (1, 1, 70), (3, 9, 130)])
@pytest.mark.parametrize("s", [2, 4])
@pytest.mark.parametrize("layout,full", TAIL_LAYOUTS)
def test_tail_kernel_matches_plain(dev, shape, s, layout, full):
    """K2 on its Hopper kernel (Cf 64) in every layout, ragged frames (W no
    multiple of the 64-wide tile, H none of its rows) and a one-row one."""
    from upscale_video_tpu_torch.ops.tail import pack_tail_weights

    buf, skip, wmat, bias = _tail_inputs(np.random.default_rng(2), *shape, 64, s, dev,
                                         bordered=True)
    before = (sr_tail_chain.launches, sr_tail_chain.launches_sm90)
    got = sr_tail_chain(buf, skip, wmat, bias, s, layout, full,
                        pack_tail_weights(wmat, s))
    torch.cuda.synchronize()
    assert (sr_tail_chain.launches - before[0],
            sr_tail_chain.launches_sm90 - before[1]) == (1, 1)
    _tail_close(got, sr_tail_chain_plain(buf, skip, wmat, bias, s, layout, full), layout)


@pytest.mark.parametrize("layout,full", TAIL_LAYOUTS)
def test_wmma_tail_composes_yuv420(dev, layout, full):
    """A Cf the Hopper kernel does not take runs the WMMA kernel; its
    ``yuv420`` is the planar launch then yuv420_from_planar, counted."""
    buf, skip, wmat, bias = _tail_inputs(np.random.default_rng(3), 2, 21, 35, 48, 2, dev,
                                         bordered=True)
    before = (sr_tail_chain.launches, sr_tail_chain.launches_sm90,
              sr_tail_chain.yuv_composed)
    got = sr_tail_chain(buf, skip, wmat, bias, 2, layout, full)
    torch.cuda.synchronize()
    assert (sr_tail_chain.launches - before[0], sr_tail_chain.launches_sm90 - before[1],
            sr_tail_chain.yuv_composed - before[2]) == (1, 0, int(layout == "yuv420"))
    _tail_close(got, sr_tail_chain_plain(buf, skip, wmat, bias, 2, layout, full), layout)


def test_hopper_tails_refuse_bad_shapes(dev):
    """The C entries refuse what their kernels do not take (the wrapper
    raises, nothing runs); K2's Hopper tail refuses a call without its
    packed weights."""
    lib = build.library()
    buf, skip, wmat, bias = _tail_inputs(np.random.default_rng(4), 1, 9, 20, 64, 2, dev,
                                         bordered=True)
    out = torch.empty((1, 9, 20, 12), dtype=torch.uint8, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    for scale, layout in ((3, 0), (2, 4)):
        code = lib.uvt_sr_tail_sm90(buf.data_ptr(), skip.data_ptr(), wmat.data_ptr(),
                                    bias.data_ptr(), out.data_ptr(), 1, 9, 20, scale,
                                    layout, 0, stream)
        with pytest.raises(RuntimeError, match="CUDA error"):
            build.check(code, "sr_tail_sm90")
    u = buf[:, 1:-1, 1:-1, :].contiguous()
    for cin in (48, 224):
        code = lib.uvt_sr_tail_plain_sm90(u.data_ptr(), skip.data_ptr(), wmat.data_ptr(),
                                          bias.data_ptr(), out.data_ptr(), 1, 9, 20, cin,
                                          2, 0, 0, stream)
        with pytest.raises(RuntimeError, match="CUDA error"):
            build.check(code, "sr_tail_plain_sm90")
    before = sr_tail_chain.launches
    with pytest.raises(ValueError, match="packed weights"):
        sr_tail_chain(buf, skip, wmat, bias, 2)
    assert sr_tail_chain.launches == before


def test_hopper_tails_raise_when_the_build_fails(dev, monkeypatch, tmp_path):
    """No nvcc: both Hopper tails raise; neither runs the WMMA kernel nor
    the plain version."""
    from upscale_video_tpu_torch.ops.tail import pack_tail_weights

    buf, skip, wmat, bias = _tail_inputs(np.random.default_rng(5), 1, 9, 20, 64, 2, dev,
                                         bordered=True)
    wpack = pack_tail_weights(wmat, 2)

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(build, "_lib", None)
    monkeypatch.setattr(build, "library_path", lambda: tmp_path / "missing.so")
    monkeypatch.setattr(build, "find_nvcc", no_nvcc)
    before = (sr_tail_chain.launches, sr_tail_fused.launches)
    with pytest.raises(RuntimeError, match="nvcc"):
        sr_tail_chain(buf, skip, wmat, bias, 2, "yuv420", True, wpack)
    with pytest.raises(RuntimeError, match="nvcc"):
        sr_tail_fused(buf[:, 1:-1, 1:-1, :].contiguous(), skip, wmat, bias, 2)
    assert (sr_tail_chain.launches, sr_tail_fused.launches) == before


def test_hopper_tails_raise_when_a_launch_fails(dev, monkeypatch):
    """A launch the runtime refuses raises: no quiet WMMA or plain retry."""
    from upscale_video_tpu_torch.ops.tail import pack_tail_weights

    lib = build.library()
    buf, skip, wmat, bias = _tail_inputs(np.random.default_rng(6), 1, 9, 20, 64, 4, dev,
                                         bordered=True)

    class Refusing:
        def __getattr__(self, name):
            if name.startswith("uvt_sr_tail"):
                return lambda *args: 1  # cudaErrorInvalidValue
            return getattr(lib, name)

    monkeypatch.setattr(build, "library", lambda: Refusing())
    before = (sr_tail_chain.launches, sr_tail_fused.launches)
    with pytest.raises(RuntimeError, match="uvt_sr_tail_sm90 launch"):
        sr_tail_chain(buf, skip, wmat, bias, 4, "planar", False, pack_tail_weights(wmat, 4))
    with pytest.raises(RuntimeError, match="uvt_sr_tail_plain_sm90 launch"):
        sr_tail_fused(buf[:, 1:-1, 1:-1, :].contiguous(), skip, wmat, bias, 4, "model")
    assert (sr_tail_chain.launches, sr_tail_fused.launches) == before


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


@pytest.mark.parametrize("shape", [(2, 37, 53), (1, 67, 130), (1, 5, 7)])
@pytest.mark.parametrize("cin,cout", sorted(NARROW_SHAPES))
@pytest.mark.parametrize("act", [ACT_NONE, ACT_PRELU, ACT_LEAKY, ACT_RELU])
def test_narrow_layer_matches_plain(dev, shape, cin, cout, act):
    """One layer of each narrow shape on the narrow kernel, W no multiple
    of its 64-wide tile, H none of its rows, one frame smaller than a
    tile: within one bf16 ulp (``2**-10 + 2**-7 * |v|``), finite, the ring
    zero, an 8-wide output's channels 3..7 zero, on the narrow kernel."""
    rng = np.random.default_rng(5 + act + cin + cout)
    (layer,) = _layers(rng, [(cin, cout, act)], dev)
    x = torch.from_numpy(rng.normal(0, 1, (*shape, cin)).astype(np.float32)
                         ).to(dev, torch.bfloat16)
    want = conv3x3_chain_plain(x, [layer], crop=False).float()
    src = embed(x, width=in_width(layer))
    dst = torch.zeros((*src.shape[:3], out_width(layer)), dtype=torch.bfloat16,
                      device=dev)
    before = (conv3x3_chain.launches_sm90, conv3x3_chain.launches_narrow)
    launch_chain_layer(src, dst, layer)
    torch.cuda.synchronize()
    assert conv3x3_chain.launches_sm90 - before[0] == 1
    assert conv3x3_chain.launches_narrow - before[1] == 1
    got = dst[..., :cout].float()
    assert bool(torch.isfinite(dst.float()).all())
    assert bool(((got - want).abs() <= 2.0 ** -10 + 2.0 ** -7 * want.abs()).all())
    assert _ring_is_zero(dst)
    assert int(torch.count_nonzero(dst[..., cout:])) == 0


def test_narrow_kernel_refuses_a_layer_without_its_pack(dev):
    """A narrow shape launches its kernel with the packed weights or
    raises: no fallback to another kernel."""
    rng = np.random.default_rng(6)
    (layer,) = _layers(rng, [(24, 24, ACT_PRELU)], dev)
    x = torch.zeros((1, 5, 7, 24), device=dev, dtype=torch.bfloat16)
    before = conv3x3_chain.launches
    with pytest.raises(ValueError, match="packed weights"):
        conv3x3_chain(x, [layer._replace(wpack=None)])
    with pytest.raises(ValueError, match="packed weights"):
        conv3x3_chain(x, [layer._replace(wpack=layer.wpack[:-8])])
    assert conv3x3_chain.launches == before


def test_engine_step_launches_each_kernel(dev):
    from upscale_video_tpu_torch.pipeline.chain import ChainEngine, ChainSpec

    eng = ChainEngine.build(ChainSpec(), 2, dev, synthetic=True)
    frames = torch.randint(0, 256, (4, 24, 40, 3), dtype=torch.uint8)
    k1, k2 = conv3x3_chain.launches, sr_tail_chain.launches
    sm90, narrow = conv3x3_chain.launches_sm90, conv3x3_chain.launches_narrow
    k2_sm90 = sr_tail_chain.launches_sm90
    out = eng.planar_step(frames)
    torch.cuda.synchronize()
    assert tuple(out.shape) == (4, 24, 40, 12)
    assert conv3x3_chain.launches - k1 == 17
    assert conv3x3_chain.launches_sm90 - sm90 == 17  # all on Hopper
    assert conv3x3_chain.launches_narrow - narrow == 1  # the 3 -> 64 head
    assert sr_tail_chain.launches - k2 == 1
    assert sr_tail_chain.launches_sm90 - k2_sm90 == 1  # the tail on Hopper


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
    """The Hopper stages against the plain version, among them chip_smoke's
    [K5_sm90] shapes: the -m r tiles of a 1080p frame, a frame smaller than
    one 2x64 tile's halo, and ones whose rows and columns fit no whole
    tile."""
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


def test_rdb_block_launches_its_five_stage_kernels_only(dev):
    """One ``rdb_block`` call under torch.profiler: exactly five kernels ran
    on the card, stages 1..5 in order, each a name that
    ``port_bench/metrics/k5_roofline.py`` counts as K5, and no fill or copy
    (the scratches come from ``torch.empty``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from port_bench.metrics.k5_roofline import KERNELS

    rng = np.random.default_rng(5)
    wts = _rdb_weights(rng, dev)
    x = torch.from_numpy(rng.normal(0, 0.5, (2, 37, 53, NF)).astype(np.float32)
                         ).to(dev, torch.bfloat16)
    rdb_block(x, wts)  # builds and loads the library outside the trace
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        rdb_block(x, wts)
        torch.cuda.synchronize()
    ran = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA),
                 key=lambda e: e.time_range.start)
    names = [e.name for e in ran]
    assert len(names) == 5, names
    assert all(KERNELS.search(n) for n in names), names
    assert [f"rdb_block_sm90_kernel<{t}>" in n for t, n in
            zip(range(1, 6), names)] == [True] * 5, names


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


@pytest.mark.parametrize("sigma", [0.0, 5.0])
@pytest.mark.parametrize(
    "shape", [(2, 37, 53), (1, 5, 4), (1, 1, 1), (1, 7, 33), (3, 70, 97)])
@pytest.mark.parametrize("h", [3.0, 30.0, 0.0])
def test_nl_means_kernel_matches_plain(dev, shape, h, sigma):
    """Ragged against the kernel's strips (6 rows a thread, 24 a block) and
    warps (28 output columns), narrower than a warp, one pixel; h = 0
    takes inv_h2's 1e12 floor."""
    x = torch.from_numpy(_noisy_gradient(np.random.default_rng(5), *shape)).to(dev)
    before = nl_means_denoise.launches
    got = nl_means_denoise(x, h, sigma)
    torch.cuda.synchronize()
    assert nl_means_denoise.launches - before == 1
    want = nl_means_denoise_plain(x, h, sigma)
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
    sm90, narrow = conv3x3_chain.launches_sm90, conv3x3_chain.launches_narrow
    out = eng.planar_step(frames)
    torch.cuda.synchronize()
    assert tuple(out.shape) == (4, 24, 40, 12)
    assert nl_means_denoise.launches - k6 == 1
    assert conv3x3_chain.launches - k1 == 10 + 17
    assert conv3x3_chain.launches_sm90 - sm90 == 10 + 17  # all on Hopper
    assert conv3x3_chain.launches_narrow - narrow == 10 + 1
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


@pytest.mark.parametrize("shape", [(2, 37, 53), (1, 1, 70)])
@pytest.mark.parametrize("cin", [64, 96, 160, 192])
@pytest.mark.parametrize("s", [2, 4])
@pytest.mark.parametrize("layout,full", TAIL_LAYOUTS)
def test_plain_input_tail_sm90_matches_plain(dev, shape, cin, s, layout, full):
    """K3 on its Hopper kernel at K4's Hopper cin set (half slices at 96
    and 160; one consumer at s 4 above cin 128) in every layout."""
    u, skip, wmat, bias = _tail_inputs(np.random.default_rng(cin * s), *shape, cin, s,
                                       dev, bordered=False)
    before = (sr_tail_fused.launches, sr_tail_fused.launches_sm90)
    got = sr_tail_fused(u, skip, wmat, bias, s, layout, full)
    torch.cuda.synchronize()
    assert (sr_tail_fused.launches - before[0],
            sr_tail_fused.launches_sm90 - before[1]) == (1, 1)
    _tail_close(got, sr_tail_fused_plain(u, skip, wmat, bias, s, layout, full), layout)


def test_yuv_step_runs_tail_and_pack_in_one_launch(dev, monkeypatch):
    """The default 4:2:0 step (I420 in, planar) ends in one K2 launch on
    its Hopper kernel writing the packed layout: no yuv420_from_planar."""
    from upscale_video_tpu_torch.ops import tail as tail_ops
    from upscale_video_tpu_torch.pipeline.chain import ChainEngine, ChainSpec

    def refused(*args, **kwargs):
        raise AssertionError("yuv420_from_planar ran on the default 4:2:0 step")

    eng = ChainEngine.build(ChainSpec(), 2, dev, synthetic=True)
    flat = torch.randint(0, 256, (4, 24 * 40 * 3 // 2), dtype=torch.uint8)
    monkeypatch.setattr(tail_ops, "yuv420_from_planar", refused)
    before = (sr_tail_chain.launches, sr_tail_chain.launches_sm90)
    out = eng.yuv_step(True, planar=True, i420_in=(24, 40, True))(flat)
    torch.cuda.synchronize()
    assert tuple(out.shape) == (4, 24, 40, 6) and out.dtype == torch.uint8
    assert (sr_tail_chain.launches - before[0],
            sr_tail_chain.launches_sm90 - before[1]) == (1, 1)


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
    k1_sm90, k1_narrow = conv3x3_chain.launches_sm90, conv3x3_chain.launches_narrow
    out = model(torch.rand(1, 12, 16, 3, device=dev), "frames")
    torch.cuda.synchronize()
    assert tuple(out.shape) == (1, 48, 64, 3)
    assert conv3x3_fused.launches - k4 == 1 + 15 + 2
    assert conv3x3_fused.launches_sm90 - k4_sm90 == 15 + 2  # all but conv_first
    assert conv3x3_chain.launches - k1 == 3
    assert conv3x3_chain.launches_sm90 - k1_sm90 == 3  # all on Hopper
    assert conv3x3_chain.launches_narrow - k1_narrow == 1  # conv_last, 64 -> 3
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
    k4, k3, k3_sm90 = (conv3x3_fused.launches, sr_tail_fused.launches,
                       sr_tail_fused.launches_sm90)
    out = model(torch.rand(2, 12, 16, 3, device=dev), "planar")
    torch.cuda.synchronize()
    assert tuple(out.shape) == (2, 12, 16, 48) and out.dtype == torch.uint8
    assert conv3x3_fused.launches - k4 == 3 and sr_tail_fused.launches - k3 == 1
    assert sr_tail_fused.launches_sm90 - k3_sm90 == 1  # 160 -> 48 on Hopper


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


def _q8_layers(rng, specs, dev, scale=(1e-4, 3e-4)):
    from upscale_video_tpu_torch.ops.conv_chain_q8 import make_q8_layer

    return [make_q8_layer(
        rng.integers(-127, 128, (3, 3, cin, cout)).astype(np.int8),
        rng.uniform(*scale, (cout,)).astype(np.float32),
        rng.normal(0, 0.05, (cout,)).astype(np.float32),
        rng.uniform(0.1, 0.3, (cout,)).astype(np.float32),
        np.float32(rng.uniform(80.0, 130.0)), act, device=dev)
        for cin, cout, act in specs]


@pytest.mark.parametrize("shape,specs", [
    ((2, 37, 53), [(3, 64, ACT_PRELU), (64, 64, ACT_PRELU), (64, 64, ACT_PRELU)]),
    ((2, 20, 40), [(3, 32, ACT_RELU), (32, 64, ACT_PRELU), (64, 48, ACT_NONE)]),
    ((1, 13, 19), [(64, 64, ACT_LEAKY)] * 2),
    ((1, 33, 40), [(128, 128, ACT_PRELU), (128, 100, ACT_NONE)]),
    ((1, 9, 11), [(16, 24, ACT_PRELU), (24, 5, ACT_NONE)]),
    # the sm90 kernel's 64->64 layers: a frame under 64 columns, rows no
    # multiple of its 3-row tile, N = 3, each activation, a chain ending in
    # the bf16 layer, 64->64 after a 3->64 mma.sync head
    ((1, 21, 40), [(64, 64, ACT_PRELU)] * 3),
    ((1, 67, 130), [(64, 64, ACT_RELU), (64, 64, ACT_PRELU)]),
    ((3, 18, 70), [(64, 64, ACT_PRELU), (64, 64, ACT_NONE)]),
    ((2, 37, 53), [(64, 64, ACT_NONE), (64, 64, ACT_PRELU), (64, 64, ACT_LEAKY),
                   (64, 64, ACT_RELU)]),
    ((1, 5, 7), [(3, 64, ACT_LEAKY), (64, 64, ACT_RELU), (64, 64, ACT_PRELU)]),
])
def test_q8_kernel_equals_plain(dev, shape, specs):
    """K8 vs its plain version: exact int32 sums and the same f32 epilogue
    ops, so every value is bit-equal, requantised layers included; each
    64->64 layer runs on the sm90 kernel."""
    from upscale_video_tpu_torch.ops.conv_chain_q8 import (
        conv3x3_chain_q8, conv3x3_chain_q8_plain, sm90_takes,
    )

    rng = np.random.default_rng(12)
    layers = _q8_layers(rng, specs, dev)
    x8 = torch.from_numpy(rng.integers(-127, 128, shape + (specs[0][0],))
                          .astype(np.int8)).to(dev)
    before = (conv3x3_chain_q8.launches, conv3x3_chain_q8.launches_sm90)
    got = conv3x3_chain_q8(x8, layers)
    torch.cuda.synchronize()
    assert conv3x3_chain_q8.launches - before[0] == len(specs)
    assert conv3x3_chain_q8.launches_sm90 - before[1] == sum(
        sm90_takes(cin, cout) for cin, cout, _ in specs)
    want = conv3x3_chain_q8_plain(x8, layers)
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    assert torch.equal(got, want)


@pytest.mark.parametrize("shape", [(1, 9, 40), (1, 67, 130), (3, 18, 70),
                                   (1, 5, 7), (2, 37, 53)])
@pytest.mark.parametrize("act", [ACT_NONE, ACT_PRELU, ACT_LEAKY, ACT_RELU])
@pytest.mark.parametrize("out", [torch.int8, torch.bfloat16])
def test_q8_sm90_layer_equals_plain(dev, shape, act, out):
    """One 64->64 K8 layer on the sm90 kernel, int8 (requantised) or bf16
    out, bit-equal to its plain step; the ring stays zero.  The dequant
    scales keep most int8 values inside +-127, so rounding, not the clip,
    decides them."""
    from upscale_video_tpu_torch.ops.conv_chain_q8 import (
        conv3x3_chain_q8, launch_q8_layer, q8_layer_plain,
    )

    rng = np.random.default_rng(14 + act)
    (layer,) = _q8_layers(rng, [(64, 64, act)], dev, scale=(2e-6, 6e-6))
    x8 = torch.from_numpy(rng.integers(-127, 128, shape + (64,))
                          .astype(np.int8)).to(dev)
    src = embed(x8, torch.int8)
    dst = torch.zeros(src.shape, dtype=out, device=dev)
    before = (conv3x3_chain_q8.launches, conv3x3_chain_q8.launches_sm90)
    launch_q8_layer(src, dst, layer)
    torch.cuda.synchronize()
    assert conv3x3_chain_q8.launches - before[0] == 1
    assert conv3x3_chain_q8.launches_sm90 - before[1] == 1
    assert torch.equal(dst, q8_layer_plain(src, layer, out))
    assert _ring_is_zero(dst)


def test_q8_sm90_layer_without_its_image_raises(dev):
    """A CUDA 64->64 layer without its packed weights raises: no fallback
    to the mma.sync kernel."""
    from upscale_video_tpu_torch.ops.conv_chain_q8 import conv3x3_chain_q8

    layers = _q8_layers(np.random.default_rng(15), [(64, 64, ACT_PRELU)], dev)
    x8 = torch.zeros((1, 8, 8, 64), dtype=torch.int8, device=dev)
    before = conv3x3_chain_q8.launches
    with pytest.raises(ValueError, match="packed weights"):
        conv3x3_chain_q8(x8, [layers[0]._replace(wpack=None)])
    assert conv3x3_chain_q8.launches == before


# --- the launch device ------------------------------------------------------

LAUNCH_SITES = ("conv_chain", "conv3x3", "tail", "rdb", "nlmeans",
                "conv_winograd", "conv_chain_q8", "swin")


@pytest.mark.parametrize("module", LAUNCH_SITES)
def test_every_launch_goes_through_the_device_helper(module):
    """CPU: each wrapper module hands its ctypes launches to
    ``build.launch`` (which enters the tensor's device) and reads no stream
    itself."""
    import importlib
    import inspect

    src = inspect.getsource(importlib.import_module(
        f"upscale_video_tpu_torch.ops.{module}"))
    assert "build.launch(" in src
    assert "current_stream" not in src and "cuda_stream" not in src
    assert "build.check(" not in src


def test_launch_helper_enters_the_tensor_device(monkeypatch):
    """CPU: ``build.launch`` runs the entry point under the given device
    with that device's current stream last, and raises on an error code."""
    from types import SimpleNamespace

    entered = []

    class Device:
        def __init__(self, d):
            self.d = d

        def __enter__(self):
            entered.append(("in", self.d))

        def __exit__(self, *exc):
            entered.append(("out", self.d))

    monkeypatch.setattr(torch.cuda, "device", Device)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d: SimpleNamespace(cuda_stream=100 + d.index))
    calls = []
    dev1 = torch.device("cuda", 1)
    build.launch(lambda *a: calls.append(a) or 0, dev1, "probe", 7, 8)
    assert calls == [(7, 8, 101)]
    assert entered == [("in", dev1), ("out", dev1)]
    monkeypatch.setattr(build, "library", lambda: SimpleNamespace(
        uvt_error_string=lambda code: b"invalid argument"))
    with pytest.raises(RuntimeError, match="probe: CUDA error 1"):
        build.launch(lambda *a: 1, dev1, "probe")


def test_launches_run_under_their_tensors_device(dev):
    """A K1 layer stack and a K6 call on ``cuda:0`` while the current device
    is another GPU: each launches on its tensor's device and matches its
    plain version."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two GPUs (the current device set elsewhere)")
    d0 = torch.device("cuda", 0)
    rng = np.random.default_rng(9)
    layers = _layers(rng, [(3, 64, ACT_PRELU), (64, 64, ACT_PRELU),
                           (64, 3, ACT_NONE)], d0)
    x = torch.from_numpy(rng.uniform(0, 1, (1, 37, 53, 3)).astype(np.float32))
    img = torch.from_numpy(_noisy_gradient(rng, 1, 37, 53)).to(d0)
    with torch.cuda.device(1):
        got = conv3x3_chain(x.to(d0, torch.bfloat16), layers, crop=False)
        den = nl_means_denoise(img, 3.0)
        torch.cuda.synchronize(d0)
    want = conv3x3_chain_plain(x.to(d0, torch.bfloat16), layers, crop=False)
    assert got.device == d0 and den.device == d0
    torch.testing.assert_close(got.float(), want.float(), atol=5e-2, rtol=2e-2)
    want_den = nl_means_denoise_plain(img, 3.0)
    assert bool((den - want_den).abs().le(1e-5 + 1e-5 * want_den.abs()).all())
