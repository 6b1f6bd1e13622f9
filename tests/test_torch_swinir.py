"""SwinIR on the port's ``-m sr=`` graph walk, on the CPU, against the
benchmark's plain forward (``port_bench/models/swinir.py``, loaded by path:
plain float32 PyTorch that imports nothing of the port).

The model here is a small SwinIR with SwinIR-L's head dim of 30: 2 heads
(embed 60), window 4 (shift 2 on odd blocks), 2 RSTBs of 2 blocks, MLP
ratio 2, the 3conv residual and the nearest+conv 4x upsampler, run on a
non-square map with a batch of 2.  Its weights are the benchmark's seeded
ones, with token linears and bias tables drawn wide enough that attention
is far from uniform, so a wrong bias index, mask or shift shows.

Tolerances, each with its reason:

- f32 port against f32 plain forward: 5e-5 in the model domain (1/80 of
  an 8-bit level).  The two sum the same products in other orders (GEMM
  against 1x1 conv, fused attention against softmax of a matmul) through
  two RSTBs; observed below 5e-6.
- The importer's model against the plain forward with the state dict's
  own (RGB) weights: the same 5e-5, at SwinIR-L's widths; from its files,
  against those weights rounded to float16 as the ``.bin`` stores them.
- A part shown to matter (the RGB mean, LayerNorm's affine part, the bias
  table, the shift mask): the port without it differs from the plain
  forward by over 1e-2, 200 times the tolerance.
"""

import dataclasses
import itertools
import math

import numpy as np
import pytest
import torch

from port_bench import ncnn, reference, spec
from port_bench.tests.tiny import run_cell, tiny_cell
from upscale_video_tpu_torch.models import executor
from upscale_video_tpu_torch.models.bin_loader import emit_bin, load_weights
from upscale_video_tpu_torch.models.param_parser import (
    NcnnGraph, NcnnLayer, parse_param, parse_param_file,
)
from upscale_video_tpu_torch.models.torch_import import (
    detect_arch, import_torch_checkpoint,
)
from upscale_video_tpu_torch.models.zoo import (
    load_model, make_swinir_graph,
)
from upscale_video_tpu_torch.ops import swin
from tests.torch_fixtures import one_torch_thread  # noqa: F401

FAM = spec.load_module(spec.BENCH_DIR / "models" / "swinir.py", "family")
TOL = 5e-5
SMALL = {"embed_dim": 60, "depths": [2, 2], "num_heads": [2, 2],
         "window_size": 4, "mlp_ratio": 2, "upscale": 4, "num_feat": 16,
         "num_in_ch": 3, "num_out_ch": 3}
SMALL_INIT = {"conv_gain": 1.0, "bias_gain": 0.5, "norm_std": 0.3,
              "data_std": 1.0,
              "rules": [{"match": "_(qkv|proj|fc1|fc2)$", "conv_std": 0.15}]}
SWINIR_L = {"embed_dim": 240, "depths": [6] * 9, "num_heads": [8] * 9,
            "window_size": 8, "mlp_ratio": 2, "upscale": 4, "num_feat": 64,
            "num_in_ch": 3, "num_out_ch": 3}
RGB_MEAN = (0.4488, 0.4371, 0.4040)  # network_swinir.py


def _graph_kw(cfg: dict) -> dict:
    return dict(scale=cfg["upscale"], embed_dim=cfg["embed_dim"],
                depths=cfg["depths"], num_heads=cfg["num_heads"],
                window_size=cfg["window_size"], mlp_ratio=cfg["mlp_ratio"],
                num_feat=cfg["num_feat"])


def _layers(graph_layers) -> list:
    return [(l.type, l.name, list(l.inputs), list(l.outputs), dict(l.attrs))
            for l in graph_layers]


def _write(tmp_path, cfg, weights, stem="4x_swin"):
    layers = FAM.layers(cfg)
    (tmp_path / f"{stem}.param").write_text(ncnn.param_text(layers))
    (tmp_path / f"{stem}.bin").write_bytes(ncnn.bin_bytes(layers, weights))
    return str(tmp_path)


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    """The small model's seeded weights, its files, and the port's f32
    model loaded from them through ``load_model`` (the ``-m sr=`` path)."""
    d = tmp_path_factory.mktemp("swinir")
    layers = FAM.layers(SMALL)
    w = ncnn.seeded_weights(layers, 2 ** 33 + 3, "cpu", SMALL_INIT)
    _write(d, SMALL, w)
    return w, load_model("x_swin", 4, "cpu", str(d),
                         compute_dtype=torch.float32)


def _port(model, x):
    """NCHW in and out, through the port's NHWC forward."""
    with torch.no_grad():
        return model(x.permute(0, 2, 3, 1), "model").permute(0, 3, 1, 2)


def _plain(w, x, cfg=SMALL):
    with torch.no_grad():
        return FAM.forward(cfg, w, x, reference.conv_f32)


def _broken(model, case):
    """The model's state with one part removed, and a restore."""
    st = model.state
    if case == "mean":
        key, saved = ("mean", "data"), st["mean"].data.clone()
        st["mean"].data.zero_()
    elif case == "affine":
        saved = {n: (st[n].gamma.clone(), st[n].beta.clone())
                 for n in st.keys() if hasattr(st[n], "gamma")}
        for n in saved:
            st[n].gamma.fill_(1.0)
            st[n].beta.zero_()
    elif case == "bias_table":
        saved = {n: st[n].data.clone() for n in st.keys()
                 if n.endswith("_table")}
        for n in saved:
            st[n].data.zero_()

    def restore():
        if case == "mean":
            st[key[0]].data.copy_(saved)
        elif case == "affine":
            for n, (g, b) in saved.items():
                st[n].gamma.copy_(g)
                st[n].beta.copy_(b)
        else:
            for n, v in saved.items():
                st[n].data.copy_(v)
    return restore


@pytest.mark.parametrize("case", ["unshifted", "shifted", "resized", "padded",
                                  "mean", "affine", "bias_table",
                                  "shift_mask"])
def test_port_matches_plain_forward(small, case, monkeypatch):
    """The port's f32 graph walk equals the plain forward on both kinds of
    block (shift 0 and 2), on a second map size after a first (the shift
    mask is made again from the running size), on a size that needs
    reflect padding to whole windows; and without the RGB mean, the
    LayerNorm affine part, the bias tables or the shift mask it does not."""
    w, model = small
    g = torch.Generator().manual_seed(7)
    x = torch.rand(2, 3, 12, 20, generator=g)
    if case in ("unshifted", "shifted"):
        # one kind of block alone: every block of the model takes that shift
        graph = model.graph
        attn = [l for l in graph.layers if l.type == "WindowAttention"]
        shift = 2 if case == "shifted" else 0
        cfg = dict(SMALL)
        saved = [dict(l.attrs) for l in attn]
        for l in attn:
            l.attrs[2] = shift
        monkeypatch.setattr(FAM, "blocks", lambda c: [(2, shift)] * 4)
        model._forwards.clear()
        try:
            got, want = _port(model, x), _plain(w, x, cfg)
        finally:
            for l, a in zip(attn, saved):
                l.attrs.clear()
                l.attrs.update(a)
            model._forwards.clear()
        assert (got - want).abs().max() < TOL
        return
    if case == "resized":
        _port(model, x)
        x = torch.rand(2, 3, 16, 8, generator=g)
    if case == "padded":
        x = torch.rand(2, 3, 10, 14, generator=g)
    want = _plain(w, x)
    if case in ("mean", "affine", "bias_table"):
        restore = _broken(model, case)
        try:
            assert (_port(model, x) - want).abs().max() > 1e-2
        finally:
            restore()
    if case == "shift_mask":
        monkeypatch.setattr(swin, "shift_mask", lambda h, w_, ws, s, dev, dt:
                            torch.zeros((1, 1, ws * ws, ws * ws), dtype=dt))
        assert (_port(model, x) - want).abs().max() > 1e-2
        monkeypatch.undo()
    got = _port(model, x)
    assert got.shape == (2, 3, 4 * x.shape[2], 4 * x.shape[3])
    assert (got - want).abs().max() < TOL


MAPS = ((8, 12, 4, 2), (16, 24, 8, 4), (24, 8, 8, 4))  # h, w, window, shift


def test_shift_mask_and_index_as_swinir_computes_them():
    """The port's mask and relative index (``ops/swin.py``) against the
    plain forward's, which follow SwinIR's ``calculate_mask`` slices."""
    for h, w, ws, s in MAPS:
        got = swin.shift_mask(h, w, ws, s, torch.device("cpu"), torch.float32)
        assert torch.equal(got[:, 0], FAM._shift_mask(h, w, ws, s))
    for ws in (4, 8):
        assert torch.equal(swin.relative_position_index(ws, torch.device("cpu")),
                           FAM._relative_index(ws).flatten())


def k9_window_rows(h: int, w: int, window: int, shift: int) -> torch.Tensor:
    """``(h*w,)`` source token of each row K9
    (``csrc/window_attention_sm90.cu``) loads, window by window: window
    ``wi`` is ``(wi // (w/window), wi % (w/window))``, its row ``r`` reads
    source ``((wy*window + r // window + shift) mod h, (wx*window + r %
    window + shift) mod w)`` with the wrap as one subtraction.  The
    kernel's ``token_of`` in Python."""
    def wrap(v, n):
        return torch.where(v >= n, v - n, v)

    nwx = w // window
    wi = torch.arange((h // window) * nwx)[:, None]
    r = torch.arange(window * window)[None, :]
    ys = wrap((wi // nwx) * window + r // window + shift, h)
    xs = wrap((wi % nwx) * window + r % window + shift, w)
    return (ys * w + xs).flatten()


def k9_mask(h: int, w: int, window: int, shift: int) -> torch.Tensor:
    """``(nW, T, T)`` mask K9 adds, from its band arithmetic: on a shifted
    block a window of the last window row has its rows ``l >= window -
    shift`` in the last band (``band_rows``), one of the last column its
    columns; a (query, key) pair in different bands of either axis gets
    -100."""
    nwy, nwx = h // window, w // window
    last = window - shift if shift else window
    local = torch.arange(window) >= last  # in the last band
    tok = torch.arange(window * window)
    ly, lx = local[tok // window], local[tok % window]
    masks = torch.zeros(nwy, nwx, window * window, window * window)
    for wy in range(nwy):
        for wx in range(nwx):
            dy = (ly[:, None] != ly[None, :]) & (shift > 0) & (wy == nwy - 1)
            dx = (lx[:, None] != lx[None, :]) & (shift > 0) & (wx == nwx - 1)
            masks[wy, wx] = torch.where(dy | dx, swin.MASK_VALUE, 0.0)
    return masks.reshape(nwy * nwx, window * window, window * window)


def k9_bias_rows() -> torch.Tensor:
    """``(T, T)`` table row K9 adds to score ``(query, key)``, gathered the
    way its lanes hold them: lane ``(g, t)`` of query tile ``mi``, key row
    ``nj``, half ``hi`` and column ``e`` holds query ``16 mi + 8 hi + g``
    and key ``8 nj + 2t + e``, and adds its bias register ``dy = 2 mi + hi
    - nj + 7`` of column ``dx = g - 2t - e + 7``."""
    window = swin.K9_WINDOW
    t, span = window * window, 2 * window - 1
    rows = torch.full((t, t), -1, dtype=torch.long)
    for lane in range(32):
        g, tq = lane >> 2, lane & 3
        for mi, nj, hi, e in itertools.product(range(4), range(8), range(2),
                                               range(2)):
            dy = 2 * mi + hi - nj + window - 1
            dx = g - 2 * tq - e + window - 1
            rows[16 * mi + 8 * hi + g, 8 * nj + 2 * tq + e] = dy * span + dx
    return rows


@pytest.mark.parametrize("h,w,ws,s", MAPS + ((8, 48, 8, 4), (16, 16, 8, 0)))
def test_k9_rows_and_mask_mirror_window_order_and_shift_mask(h, w, ws, s):
    """K9's index arithmetic, mirrored in Python above: the source token
    of each row it loads is :func:`window_order`'s, and the mask its band
    comparisons add is :func:`shift_mask`'s (none unshifted),
    on maps one window tall, non-square and not a multiple of 16."""
    cpu = torch.device("cpu")
    assert torch.equal(k9_window_rows(h, w, ws, s),
                       swin.window_order(h, w, ws, s, cpu))
    want = (swin.shift_mask(h, w, ws, s, cpu, torch.float32)[:, 0] if s
            else torch.zeros((h // ws) * (w // ws), ws * ws, ws * ws))
    assert torch.equal(k9_mask(h, w, ws, s), want)


def test_k9_bias_registers_hold_the_relative_index():
    """The table row each lane's bias register adds to each score it holds
    (query tile, key row, half and column) is the pair's relative index."""
    rows = k9_bias_rows()
    assert (rows >= 0).all()
    assert torch.equal(rows.flatten(),
                       swin.relative_position_index(8, torch.device("cpu")))


@pytest.mark.parametrize("shape,heads,window,device,dtype,route", [
    ((4, 1080, 1920, 720), 8, 8, "cuda", torch.bfloat16, "k9"),  # SwinIR-L
    ((1, 64, 48, 540), 6, 8, "cuda", torch.bfloat16, "k9"),  # SwinIR-M
    ((2, 24, 40, 180), 6, 8, "cuda", torch.bfloat16, "k9"),  # lightweight
    ((1, 8, 8, 96), 1, 8, "cuda", torch.bfloat16, "k9"),  # one head of 32
    ((4, 1080, 1920, 720), 8, 8, "cpu", torch.bfloat16, "plain"),
    ((4, 1080, 1920, 720), 8, 8, "cuda", torch.float32, "sdpa"),
    ((4, 1080, 1920, 720), 8, 8, "cuda", torch.float16, "sdpa"),
    ((2, 12, 20, 180), 2, 4, "cuda", torch.bfloat16, "sdpa"),  # window 4
    ((1, 64, 64, 1080), 12, 8, "cuda", torch.bfloat16, "sdpa"),  # 12 heads
    ((1, 64, 64, 360), 8, 8, "cuda", torch.bfloat16, "sdpa"),  # d 15, odd
    ((1, 64, 64, 720), 6, 8, "cuda", torch.bfloat16, "sdpa"),  # d 40
])
def test_attention_route_by_shape(shape, heads, window, device, dtype, route):
    """The route follows from what the call can see: K9 takes a CUDA bf16
    blob at window 8 with at most 8 heads of an even head dim up to 32."""
    assert swin.attention_route(shape, heads, window, device, dtype) == route


@pytest.mark.parametrize("shape,heads,window", [
    ((1, 16, 16, 721), 8, 8), ((1, 16, 16, 720), 7, 8), ((1, 12, 16, 720), 8, 8),
])
def test_attention_route_refuses_what_is_no_blob_of_windows(shape, heads,
                                                            window):
    with pytest.raises(ValueError, match="window attention"):
        swin.attention_route(shape, heads, window, "cuda", torch.bfloat16)


@pytest.mark.parametrize("h,w,ws,s", MAPS)
def test_plain_version_equals_the_sdpa_route(h, w, ws, s):
    """K9's plain version (explicit scores, softmax and ``P v`` in f32) and
    the ``sdpa`` route (gather, pad, fused attention, scatter) agree in f32
    on the CPU, within f32 rounding of the reordered sums (1e-5)."""
    g = torch.Generator().manual_seed(h * w + s)
    qkv = torch.randn(2, h, w, 3 * 2 * 30, generator=g)
    table = torch.randn((2 * ws - 1) ** 2, 2, generator=g)
    got = swin.window_attention_plain(qkv, table, 2, ws, s)
    want = swin.window_attention_sdpa(qkv, table, 2, ws, s)
    assert (got - want).abs().max() < 1e-5


def test_cpu_calls_take_the_plain_route_and_k9_refuses_them():
    qkv = torch.randn(1, 8, 16, 3 * 8 * 30, dtype=torch.bfloat16)
    table = torch.randn(225, 8)
    before = dict(swin.window_attention.routes)
    launches = swin.window_attention.launches
    got = swin.window_attention(qkv, table, 8, 8, 4)
    assert torch.equal(got, swin.window_attention_plain(qkv, table, 8, 8, 4))
    assert swin.window_attention.routes["plain"] == before["plain"] + 1
    assert swin.window_attention.routes["k9"] == before["k9"]
    assert swin.window_attention.launches == launches
    with pytest.raises(ValueError, match="unsupported device"):
        swin.window_attention_k9(qkv, table, 8, 8, 4)


@pytest.mark.parametrize("cfg", [SMALL, SWINIR_L], ids=["small", "swinir_l"])
def test_port_graph_is_the_benchmarks(cfg):
    """``make_swinir_graph`` writes, layer for layer, the graph the
    benchmark's ``layers(cfg)`` does, and it parses back the same."""
    port = make_swinir_graph(**_graph_kw(cfg))
    bench = FAM.layers(cfg)
    assert _layers(port.layers) == _layers(bench)
    assert _layers(parse_param(ncnn.param_text(bench)).layers) == \
        _layers(port.layers)
    if cfg is SWINIR_L:
        types = port.count_types()
        assert types["WindowAttention"] == 54 and types["LayerNorm"] == 110
        assert sum(l.attr_i(2) == 4 for l in port.layers
                   if l.type == "WindowAttention") == 27


def test_bin_round_trip_is_the_benchmarks_layout():
    """The port reads the benchmark's ``.bin`` (LayerNorm's raw gamma and
    beta, MemoryData's raw data) and writes the same bytes back."""
    layers = FAM.layers(SMALL)
    w = ncnn.seeded_weights(layers, 5, "cpu", SMALL_INIT)
    data = ncnn.bin_bytes(layers, w)
    graph = parse_param(ncnn.param_text(layers))
    params = load_weights(graph, data)
    np.testing.assert_array_equal(params["mean"]["data"], w["mean"]["data"])
    assert params["l0b1_table"]["data"].shape == (49, 2)
    np.testing.assert_array_equal(params["norm"]["gamma"], w["norm"]["gamma"])
    assert emit_bin(graph, params) == data


def _swinir_state_dict(cfg: dict, seed: int = 0) -> dict:
    """A state dict with SwinIR's key names and shapes (``params_ema``),
    its buffers included, at ``cfg``'s widths."""
    g = torch.Generator().manual_seed(seed)
    dim, ws, nf = cfg["embed_dim"], cfg["window_size"], cfg["num_feat"]
    hidden, q = int(dim * cfg["mlp_ratio"]), dim // 4
    sd = {}

    def conv(name, cin, cout, k):
        sd[f"{name}.weight"] = torch.randn(cout, cin, k, k, generator=g) \
            / math.sqrt(cin * k * k)
        sd[f"{name}.bias"] = torch.randn(cout, generator=g) * 0.1

    def linear(name, cin, cout):
        sd[f"{name}.weight"] = torch.randn(cout, cin, generator=g) * 0.1
        sd[f"{name}.bias"] = torch.randn(cout, generator=g) * 0.1

    def norm(name):
        sd[f"{name}.weight"] = 1 + 0.2 * torch.randn(dim, generator=g)
        sd[f"{name}.bias"] = 0.2 * torch.randn(dim, generator=g)

    conv("conv_first", 3, dim, 3)
    norm("patch_embed.norm")
    for i, (depth, heads) in enumerate(zip(cfg["depths"], cfg["num_heads"])):
        for j in range(depth):
            pre = f"layers.{i}.residual_group.blocks.{j}"
            norm(f"{pre}.norm1")
            linear(f"{pre}.attn.qkv", dim, 3 * dim)
            sd[f"{pre}.attn.relative_position_bias_table"] = torch.randn(
                (2 * ws - 1) ** 2, heads, generator=g)
            sd[f"{pre}.attn.relative_position_index"] = torch.zeros(
                ws * ws, ws * ws, dtype=torch.long)
            if j % 2:
                sd[f"{pre}.attn_mask"] = torch.zeros(4, ws * ws, ws * ws)
            linear(f"{pre}.attn.proj", dim, dim)
            norm(f"{pre}.norm2")
            linear(f"{pre}.mlp.fc1", dim, hidden)
            linear(f"{pre}.mlp.fc2", hidden, dim)
        conv(f"layers.{i}.conv.0", dim, q, 3)
        conv(f"layers.{i}.conv.2", q, q, 1)
        conv(f"layers.{i}.conv.4", q, dim, 3)
    norm("norm")
    conv("conv_after_body.0", dim, q, 3)
    conv("conv_after_body.2", q, q, 1)
    conv("conv_after_body.4", q, dim, 3)
    conv("conv_before_upsample.0", dim, nf, 3)
    conv("conv_up1", nf, nf, 3)
    conv("conv_up2", nf, nf, 3)
    conv("conv_hr", nf, nf, 3)
    conv("conv_last", nf, 3, 3)
    return sd


def _plain_weights(sd: dict, f16: bool = False) -> dict:
    """The state dict as the plain forward's weights, in its own RGB; with
    ``f16`` the conv and linear weights rounded to float16, as the
    ``.bin`` stores them."""
    w = {"mean": {"data": torch.tensor(RGB_MEAN)}}
    for k, v in sd.items():
        stem, kind = k.rsplit(".", 1)
        if kind not in ("weight", "bias") or "index" in k:
            continue
        name = (stem.replace("patch_embed.norm", "patch_norm")
                .replace("conv_after_body.", "after_body")
                .replace("conv_before_upsample.0", "conv_before_upsample"))
        parts = name.split(".")
        if parts[0] == "layers" and parts[2] == "residual_group":
            name = f"l{parts[1]}b{parts[4]}_" + parts[-1]
        elif parts[0] == "layers":
            name = f"l{parts[1]}_conv{parts[3]}"
        if "norm" in name:
            w.setdefault(name, {})["gamma" if kind == "weight" else "beta"] = v
            continue
        if kind == "weight":
            v = v[:, :, None, None] if v.ndim == 2 else v
            v = v.half().float() if f16 else v
        w.setdefault(name, {})[kind] = v
    for k, v in sd.items():
        if k.endswith("relative_position_bias_table"):
            p = k.split(".")
            w[f"l{p[1]}b{p[4]}_table"] = {"data": v}
    return w


def test_import_swinir_state_dict(tmp_path):
    """``vsr-import-torch`` of a state dict with SwinIR-L's key names and
    widths (240, 8 heads of 30, window 8, MLP 480, 3conv 60, upsampler 64)
    at one RSTB of two blocks: detected as SwinIR, its ``.param`` the
    benchmark's graph for the same configuration, and the engine built
    from its files equal to the plain forward with the state dict's own
    RGB weights under the BGR flip."""
    from upscale_video_tpu_torch.cli.import_model import main as import_main

    cfg = dict(SWINIR_L, depths=[2], num_heads=[8])
    sd = _swinir_state_dict(cfg)
    assert detect_arch({k: v.numpy() for k, v in sd.items()}) == "swinir"
    torch.save({"params_ema": sd}, tmp_path / "swin.pth")
    assert import_main(["-i", str(tmp_path / "swin.pth"), "-o",
                        str(tmp_path / "models")]) == 0
    graph = parse_param_file(str(tmp_path / "models" / "4x_swin.param"))
    assert _layers(graph.layers) == _layers(FAM.layers(cfg))
    model = load_model("x_swin", 4, "cpu", str(tmp_path / "models"),
                       compute_dtype=torch.float32)
    x = torch.rand(1, 3, 16, 24, generator=torch.Generator().manual_seed(3))
    got = _port(model, x.flip(1)).flip(1)
    assert (got - _plain(_plain_weights(sd, f16=True), x, cfg)).abs().max() \
        < TOL
    # the same model straight from the checkpoint object, before any file
    direct = import_torch_checkpoint({"params_ema": sd},
                                     compute_dtype=torch.float32)
    assert (_port(direct, x.flip(1)).flip(1)
            - _plain(_plain_weights(sd), x, cfg)).abs().max() < TOL


def test_work_counts_at_1080p():
    """SwinIR-L's work a 1080p frame, by the convention of
    ``port_bench/flops.py``: 30.67 M multiply-adds a low-resolution pixel,
    127.19 TFLOP; token linears 103.2 TFLOP over ~645 GB, bytes-bound;
    attention 6.88 TFLOP over ~222 GB (q, k, v and the output in bf16,
    215 GB, and the 27 shifted blocks' masks)."""
    cfg = dict(SWINIR_L, num_in_ch=3, num_out_ch=3)
    px = 1080 * 1920
    assert FAM.flops(cfg, 1080, 1920) == 2 * 30_669_552 * px
    lin = FAM.token_linear_work(cfg, 1080, 1920)
    att = FAM.attention_work(cfg, 1080, 1920)
    assert len(lin) == 4 * 54 and len(att) == 54
    assert round(sum(f for f, _ in lin) / 1e12, 1) == 103.2
    assert round(sum(b for _, b in lin) / 1e9) == 645
    assert round(sum(f for f, _ in att) / 1e12, 2) == 6.88
    q_k_v_out = 2 * 4 * 240 * px * 54
    masks = 2 * 27 * (px // 64) * 64 * 64
    assert sum(b for _, b in att) == q_k_v_out + masks + 2 * 54 * 8 * 64 * 64
    from port_bench.flops import launch_bound_s

    assert all(b / 3.35e12 > f / 989e12 for f, b in lin + att)
    assert sum(launch_bound_s(f, b) for f, b in att) == \
        pytest.approx(0.0663, abs=5e-4)


def test_run_takes_the_familys_work():
    """The cell's ``flops_per_frame`` is the family's count, not the
    graph's (``graph_conv_flops`` cannot see attention)."""
    from port_bench.harness import Run

    cell = spec.cell(spec.load_benchmark(), "swinir4x-1080p-i420")
    run = Run(cell, 2 ** 33 + 1, 1.0, False, "cpu")
    cfg = dict(cell.config, depths=[1], num_heads=[8])
    run.cfg = cfg
    try:
        run.write_model()
    finally:
        run.close()
    assert run.flops_per_frame == FAM.flops(cfg, 1080, 1920)


def _cut_cell(**traffic):
    """The benchmark's cell cut to a CPU's size: 2 RSTBs of 2 blocks at
    the published widths, a 24x40 frame."""
    cell = tiny_cell("swinir4x-1080p-i420", height=24, width=40, **traffic)
    cfg = dict(cell.config, depths=[2, 2], num_heads=[8, 8])
    return dataclasses.replace(cell, config=cfg)


def test_cell_runs_through_the_stream_loop_and_the_control_fails():
    """The cell on the CPU: the port's stream loop against the reference,
    ``correct``; the reference in float8 (every conv and token linear)
    fails the cell's limits."""
    from port_bench.tests.tiny import threads

    run = run_cell(_cut_cell(), 2 ** 35 + 17)
    assert run.frames == run.n_frames > 0 and run.correct, run.checks
    with threads():
        failed, ctl, _ = run.judge(
            run.numbers(run.reference_frames("fp8"), run.ref), run.n_frames)
    assert failed > 0, ctl


@pytest.mark.parametrize("fault", ["stale", "half_batch", "altered"])
def test_planted_fault_fails_the_cell(fault):
    from port_bench import calibrate
    from port_bench.tests.tiny import threads

    with threads():
        row = calibrate.reading(_cut_cell(), 9, 0.3, "cpu", False, fault)
    assert row["correct"] is False, row


def test_spans_name_every_part_of_the_model(small):
    """Each layer runs in one ``swin.*`` range, the ranges recorded only
    while a profiler records."""
    _, model = small
    fwd = model.frames_forward("model")
    names = set(fwd.spans.values())
    assert names == {"swin.embed", "swin.norm", "swin.attn", "swin.mlp",
                     "swin.rstb_conv", "swin.tail"}
    by = {model.graph.layers[i].name: s for i, s in fwd.spans.items()}
    assert by["conv_first"] == "swin.embed" and by["l1b1_qkv"] == "swin.attn"
    assert by["l0b0_table"] == "swin.attn" and by["l0b0_add1"] == "swin.attn"
    assert by["l0b1_fc2"] == "swin.mlp" and by["l0b1_add2"] == "swin.mlp"
    assert by["l1_conv2"] == "swin.rstb_conv" and by["l1_add"] == \
        "swin.rstb_conv"
    assert by["patch_norm_map"] == "swin.norm" and by["conv_last"] == \
        "swin.tail"
    from torch.profiler import ProfilerActivity, profile

    x = torch.rand(1, 3, 8, 8)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _port(model, x)
    seen = {e.name for e in prof.events() if e.name.startswith("swin.")}
    assert seen == names


def test_parallel_sp_and_tp_refuse_window_attention(small):
    from upscale_video_tpu_torch.parallel.mesh import make_mesh
    from upscale_video_tpu_torch.pipeline.chain import ChainEngine, ChainSpec

    _, model = small
    eng = ChainEngine(ChainSpec.parse("sr=x_swin"), 4, model,
                      torch.device("cpu"))
    for mode in ("sp", "tp"):
        mesh = make_mesh({mode: 2}, devices=[torch.device("cpu")] * 2)
        with pytest.raises(ValueError, match="--parallel dp"):
            eng.use_mesh(mesh, mode)
    with pytest.raises(NotImplementedError, match="WindowAttention"):
        executor.TensorParallelForward(model.graph, ["cpu", "cpu"], [{}, {}],
                                       torch.float32, None, "model")


def test_permute_or_layernorm_outside_a_token_norm_is_refused():
    graph = make_swinir_graph(**_graph_kw(SMALL))
    layers = [dataclasses.replace(l) for l in graph.layers]
    i = next(k for k, l in enumerate(layers) if l.name == "norm_map")
    layers[i] = NcnnLayer("Permute", "norm_map", layers[i].inputs,
                          layers[i].outputs, {0: 1})
    bad = NcnnGraph(layers=layers, blob_count=graph.blob_count)
    with pytest.raises(NotImplementedError, match="norm_tok"):
        executor.GraphForward(bad, "cpu", torch.float32, None, "model")
