"""K9, SwinIR's shifted-window attention kernel
(``csrc/window_attention_sm90.cu``), against its plain PyTorch version on
the card.

Marked ``cuda``: every test skips with a reason on a host without a CUDA
device (the decision is made inside the fixture, never at import).  This
file imports no jax, so on a GPU host without jax it runs on its own::

    python -m pytest --noconftest -m cuda tests/test_torch_swin_cuda.py

Tolerance, in bf16 levels: K9 and the plain version both round ``P`` to
bf16 before ``P v`` and the output once, but their f32 scores differ in the
last bits (fused multiply-adds in log2 units and the SFU's ex2 against
``exp``), so a ``P`` element may land one bf16 level (2**-8 of ``P``'s
largest, 1) away and an output one level (2**-7 of it) away:
``2**-8 * max|v| + 2**-7 * |want|``.
"""

import numpy as np
import pytest
import torch

from port_bench import ncnn
from port_bench.spec import BENCH_DIR, load_module
from upscale_video_tpu_torch.models.zoo import load_model
from upscale_video_tpu_torch.ops import swin

pytestmark = pytest.mark.cuda

MAPS = ((1, 24, 40), (4, 40, 24), (1, 8, 48))  # n, h, w: not multiples of 16,
# non-square, one window tall


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _inputs(dev, n, h, w, heads, d, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    qkv = torch.randn((n, h, w, 3 * heads * d), generator=g, device=dev,
                      dtype=torch.bfloat16)
    table = torch.randn((225, heads), generator=g, device=dev)
    return qkv, table


def _close(got, want, qkv, c):
    vmax = qkv[..., 2 * c:].abs().max().float()
    d = (got.float() - want.float()).abs()
    return bool((d <= 2.0 ** -8 * vmax + 2.0 ** -7 * want.float().abs()).all())


@pytest.mark.parametrize("n,h,w", MAPS)
@pytest.mark.parametrize("shift", [0, 4])
@pytest.mark.parametrize("c,heads", [(240, 8), (180, 6), (60, 6)])
def test_k9_matches_plain(dev, c, heads, shift, n, h, w):
    qkv, table = _inputs(dev, n, h, w, heads, c // heads, seed=n * h + w)
    got = swin.window_attention_k9(qkv, table, heads, 8, shift)
    want = swin.window_attention_plain(qkv, table, heads, 8, shift)
    torch.cuda.synchronize()
    assert got.shape == (n, h, w, c) and got.dtype == torch.bfloat16
    assert _close(got, want, qkv, c)


def test_window_attention_counts_launches_and_routes(dev):
    qkv, table = _inputs(dev, 2, 16, 24, 8, 30)
    before = dict(swin.window_attention.routes)
    launches = swin.window_attention.launches
    got = swin.window_attention(qkv, table, 8, 8, 4)
    assert swin.window_attention.launches == launches + 1
    assert swin.window_attention.routes["k9"] == before["k9"] + 1
    swin.window_attention(qkv.float(), table, 8, 8, 4)
    assert swin.window_attention.routes["sdpa"] == before["sdpa"] + 1
    assert swin.window_attention.launches == launches + 1
    torch.cuda.synchronize()
    assert _close(got, swin.window_attention_plain(qkv, table, 8, 8, 4),
                  qkv, 240)


def test_k9_refuses_what_it_does_not_take(dev):
    qkv, table = _inputs(dev, 1, 16, 16, 8, 30)
    with pytest.raises(TypeError, match="bf16"):
        swin.window_attention_k9(qkv.float(), table, 8, 8, 0)
    with pytest.raises(ValueError, match="contiguous"):
        swin.window_attention_k9(qkv.transpose(1, 2), table, 8, 8, 0)
    with pytest.raises(ValueError, match="takes window 8"):
        swin.window_attention_k9(qkv, table[:49], 8, 4, 0)  # window 4
    # what the C entry refuses, raised by build.launch
    wide, wide_table = _inputs(dev, 1, 16, 16, 12, 30)
    with pytest.raises(RuntimeError, match="CUDA error 1 "):
        swin.window_attention_k9(wide, wide_table, 12, 8, 0)  # 12 heads
    with pytest.raises(RuntimeError, match="CUDA error 1 "):
        swin.window_attention_k9(qkv, table, 8, 8, 8)  # shift 8
    with pytest.raises(ValueError, match="table"):
        swin.window_attention_k9(qkv, table[:, :6], 8, 8, 0)
    with pytest.raises(ValueError, match="window attention"):
        swin.window_attention_k9(qkv[:, :12], table, 8, 8, 0)  # 12 rows


def test_entry_point_refuses_bad_shapes(dev):
    """The C entry's own checks: cudaErrorInvalidValue (1) for a map that
    is no whole number of windows, 9 heads, an odd head dim or a shift of a
    whole window."""
    from upscale_video_tpu_torch.kernels import build

    qkv, table = _inputs(dev, 1, 16, 16, 8, 30)
    out = torch.empty((1, 16, 16, 240), device=dev, dtype=torch.bfloat16)
    fn = build.library().uvt_window_attention_sm90
    stream = torch.cuda.current_stream().cuda_stream
    for h, w, heads, d, shift in ((12, 16, 8, 30, 0), (16, 16, 9, 30, 0),
                                  (16, 16, 8, 29, 0), (16, 16, 8, 30, 8)):
        assert fn(qkv.data_ptr(), out.data_ptr(), table.data_ptr(), 1, h, w,
                  heads, d, shift, 0.2, stream) == 1


def test_swinir_forward_runs_every_block_on_k9(dev, tmp_path):
    """A SwinIR at SwinIR-M's head dim (6 heads of 30, window 8, one
    shifted block of two) through the ``-m sr=`` path in bf16 on the card:
    every WindowAttention layer on K9, its output within two bf16 levels of
    its largest value (2**-6 of it) of the same model in f32 on the CPU.
    The token linears are drawn wide (N(0, 0.15)) so that attention is far
    from uniform; the CPU's own bf16 path reads about one level here."""
    fam = load_module(BENCH_DIR / "models" / "swinir.py", "swinir_family")
    cfg = {"embed_dim": 180, "depths": [2], "num_heads": [6], "window_size": 8,
           "mlp_ratio": 2, "upscale": 4, "num_feat": 16, "num_in_ch": 3,
           "num_out_ch": 3}
    layers = fam.layers(cfg)
    init = {"conv_gain": 1.0, "bias_gain": 0.5, "norm_std": 0.3,
            "data_std": 1.0,
            "rules": [{"match": "_(qkv|proj|fc1|fc2)$", "conv_std": 0.15}]}
    weights = ncnn.seeded_weights(layers, 2 ** 33 + 5, "cpu", init)
    (tmp_path / "4x_swin.param").write_text(ncnn.param_text(layers))
    (tmp_path / "4x_swin.bin").write_bytes(ncnn.bin_bytes(layers, weights))
    model = load_model("x_swin", 4, dev, str(tmp_path),
                       compute_dtype=torch.bfloat16)
    ref = load_model("x_swin", 4, "cpu", str(tmp_path),
                     compute_dtype=torch.float32)
    x = torch.from_numpy(np.random.default_rng(5).uniform(
        0, 1, (2, 24, 40, 3)).astype(np.float32))
    before = dict(swin.window_attention.routes)
    with torch.no_grad():
        got = model(x.to(dev), "model").float().cpu()
    routes = {k: v - before[k] for k, v in swin.window_attention.routes.items()}
    assert routes == {"k9": 2, "sdpa": 0, "plain": 0}
    with torch.no_grad():
        want = ref(x, "model")
    assert got.shape == want.shape == (2, 96, 160, 3)
    assert (got - want).abs().max() < 2.0 ** -6 * want.abs().max()
