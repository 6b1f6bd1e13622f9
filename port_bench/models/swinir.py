"""SwinIR (``JingyunLiang/SwinIR``, ``models/network_swinir.py``) in its
real-world form (``resi_connection='3conv'``, ``upsampler='nearest+conv'``):
its ncnn graph, its plain forward, its own count of a frame's work and the
work of its attention and token linears, which the kernel metrics read.

The graph, in the dialect of the port's ``models/param_parser.py``:

- ``mean`` (MemoryData, 3 values) subtracted from the input and added to
  the output; ``conv_first``, 3x3 to ``embed_dim``;
- a token norm: ``Permute(3)`` to (h, w, c), ``LayerNorm`` over the
  channels (eps 1e-5), ``Permute(4)`` back;
- a Swin block: norm1, ``qkv`` (1x1 conv to 3C, bias), its bias table
  (MemoryData ``((2w-1)^2, heads)``), ``WindowAttention`` (attrs heads,
  window, shift: ``window // 2`` on odd blocks; the port's one layer type
  outside ncnn), ``proj`` (1x1), add; norm2, ``fc1`` (1x1 to
  ``mlp_ratio * C``), ``GELU`` (exact), ``fc2`` (1x1), add;
- an RSTB: its blocks, then 3x3 to C/4 + leaky 0.2, 1x1 + leaky 0.2, 3x3
  back to C, add the RSTB's input;
- the final norm, ``after_body`` (the same three convs), add the
  embedding; ``conv_before_upsample`` (3x3 to ``num_feat`` + leaky 0.01),
  nearest 2x + ``conv_up1`` (+ leaky 0.2) and at 4x again with
  ``conv_up2``, ``conv_hr`` (+ leaky 0.2), ``conv_last``, add the mean.

The forward is that arithmetic in plain PyTorch on NCHW tensors, written
from the architecture's description, not from the port: the input
reflect-padded to whole windows and the output cropped back, as SwinIR's
``check_image_size`` does.  Every convolution and every token linear goes
through ``conv``, so the float8 control lowers them all; attention's two
products and its softmax stay float32 in the control too.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import torch
import torch.nn.functional as F

from port_bench.ncnn import Layer

MASK_VALUE = -100.0  # SwinIR's shift mask between regions of a window


def layers(cfg: dict) -> List[Layer]:
    dim, ws, s = cfg["embed_dim"], cfg["window_size"], cfg["upscale"]
    nf, cin = cfg["num_feat"], cfg["num_in_ch"]
    out = [Layer("Input", "input", [], ["input"]),
           Layer("MemoryData", "mean", [], ["mean"], {0: cin}),
           Layer("BinaryOp", "sub_mean", ["input", "mean"], ["x0"], {0: 1})]

    def add(kind, name, srcs, attrs=None):
        out.append(Layer(kind, name, list(srcs), [name], dict(attrs or {})))
        return name

    def conv(name, src, ci, co, k=3, slope=None):
        attrs = {0: co, 1: k, 5: 1, 6: co * ci * k * k}
        if k == 3:
            attrs[4] = 1
        if slope is not None:
            attrs[9] = 2
            attrs[10] = [slope]
        return add("Convolution", name, [src], attrs)

    def norm(name, src):
        t = add("Permute", f"{name}_tok", [src], {0: 3})
        t = add("LayerNorm", name, [t], {0: dim, 1: 1e-5, 2: 1})
        return add("Permute", f"{name}_map", [t], {0: 4})

    def three_conv(tag, src):
        q = dim // 4
        y = conv(f"{tag}0", src, dim, q, slope=0.2)
        y = conv(f"{tag}2", y, q, q, k=1, slope=0.2)
        return conv(f"{tag}4", y, q, dim)

    feat = conv("conv_first", "x0", cin, dim)
    t = norm("patch_norm", feat)
    hidden = int(dim * cfg["mlp_ratio"])
    for i, (depth, heads) in enumerate(zip(cfg["depths"], cfg["num_heads"])):
        rin = t
        for j in range(depth):
            tag = f"l{i}b{j}"
            qkv = conv(f"{tag}_qkv", norm(f"{tag}_norm1", t), dim, 3 * dim, k=1)
            tb = add("MemoryData", f"{tag}_table", [],
                     {0: heads, 1: (2 * ws - 1) ** 2})
            a = add("WindowAttention", f"{tag}_attn", [qkv, tb],
                    {0: heads, 1: ws, 2: ws // 2 if j % 2 else 0})
            t = add("BinaryOp", f"{tag}_add1",
                    [t, conv(f"{tag}_proj", a, dim, dim, k=1)], {0: 0})
            h = conv(f"{tag}_fc1", norm(f"{tag}_norm2", t), dim, hidden, k=1)
            h = conv(f"{tag}_fc2", add("GELU", f"{tag}_gelu", [h]), hidden,
                     dim, k=1)
            t = add("BinaryOp", f"{tag}_add2", [t, h], {0: 0})
        t = add("BinaryOp", f"l{i}_add", [three_conv(f"l{i}_conv", t), rin],
                {0: 0})
    y = add("BinaryOp", "body_add",
            [three_conv("after_body", norm("norm", t)), feat], {0: 0})
    y = conv("conv_before_upsample", y, dim, nf, slope=0.01)
    for k in range(1, 2 if s == 2 else 3):
        y = add("Interp", f"up{k}", [y], {0: 1, 1: 2.0, 2: 2.0})
        y = conv(f"conv_up{k}", y, nf, nf, slope=0.2)
    y = conv("conv_hr", y, nf, nf, slope=0.2)
    y = conv("conv_last", y, nf, cfg["num_out_ch"])
    out.append(Layer("BinaryOp", "add_mean", [y, "mean"], ["output"], {0: 0}))
    return out


def blocks(cfg: dict) -> List[Tuple[int, int]]:
    """``(heads, shift)`` of every Swin block, in order."""
    ws = cfg["window_size"]
    return [(heads, ws // 2 if j % 2 else 0)
            for depth, heads in zip(cfg["depths"], cfg["num_heads"])
            for j in range(depth)]


def token_linears(cfg: dict) -> List[Tuple[int, int]]:
    """``(cin, cout)`` of one block's token linears: qkv, proj, fc1, fc2."""
    dim = cfg["embed_dim"]
    hidden = int(dim * cfg["mlp_ratio"])
    return [(dim, 3 * dim), (dim, dim), (dim, hidden), (hidden, dim)]


def attention_work(cfg: dict, height: int, width: int) -> List[Tuple[float, float]]:
    """``(flops, bytes)`` of each block's window attention over one frame:
    QK^T and AV, 2 x 2 x T x C a token; bytes as the algorithm needs them
    in bf16, q, k and v read once and the output written once (4 x C a
    token), the bias table gathered to ``(heads, T, T)`` once and, on a
    shifted block, the mask ``(nW, T, T)`` once."""
    ws, dim = cfg["window_size"], cfg["embed_dim"]
    t = ws * ws
    tokens = _padded(height, ws) * _padded(width, ws)
    windows = tokens // t
    out = []
    for heads, shift in blocks(cfg):
        nbytes = 2 * (4 * dim * tokens + heads * t * t
                      + (windows * t * t if shift else 0))
        out.append((4.0 * t * dim * tokens, float(nbytes)))
    return out


def token_linear_work(cfg: dict, height: int, width: int) -> List[Tuple[float, float]]:
    """``(flops, bytes)`` of each token linear of each block over one
    frame: 2 x cin x cout a token; its input, output and weights in bf16,
    each once."""
    tokens = (_padded(height, cfg["window_size"])
              * _padded(width, cfg["window_size"]))
    return [(2.0 * ci * co * tokens, 2.0 * ((ci + co) * tokens + ci * co))
            for _ in blocks(cfg) for ci, co in token_linears(cfg)]


def flops(cfg: dict, height: int, width: int) -> float:
    """2 x the multiply-adds of a frame, by ``port_bench/flops.py``'s
    convention: the convolutions (the upsampler's at 2x and 4x), the token
    linears and attention's two products, over the frame's pixels (padded
    to whole windows, as the model runs them)."""
    dim, nf, s = cfg["embed_dim"], cfg["num_feat"], cfg["upscale"]
    ws, cin, cout = cfg["window_size"], cfg["num_in_ch"], cfg["num_out_ch"]
    px = _padded(height, ws) * _padded(width, ws)
    q = dim // 4
    three = 9 * dim * q + q * q + 9 * q * dim
    macs = (9 * cin * dim + (len(cfg["depths"]) + 1) * three
            + 9 * dim * nf + 9 * nf * nf * (4 + (16 if s == 4 else 0))
            + 9 * nf * nf * s * s + 9 * nf * cout * s * s)
    per_frame = 2.0 * macs * px
    per_frame += sum(f for f, _ in attention_work(cfg, height, width))
    per_frame += sum(f for f, _ in token_linear_work(cfg, height, width))
    return per_frame


def _padded(n: int, window: int) -> int:
    return -(-n // window) * window


def _relative_index(ws: int) -> torch.Tensor:
    yx = torch.stack(torch.meshgrid(torch.arange(ws), torch.arange(ws),
                                    indexing="ij")).flatten(1)
    rel = yx[:, :, None] - yx[:, None, :] + (ws - 1)
    return rel[0] * (2 * ws - 1) + rel[1]


def _shift_mask(h: int, w: int, ws: int, shift: int) -> torch.Tensor:
    img = torch.zeros(h, w)
    cnt = 0
    for hs in (slice(0, h - ws), slice(h - ws, h - shift), slice(h - shift, h)):
        for wsl in (slice(0, w - ws), slice(w - ws, w - shift),
                    slice(w - shift, w)):
            img[hs, wsl] = cnt
            cnt += 1
    win = img.reshape(h // ws, ws, w // ws, ws).transpose(1, 2).reshape(-1, ws * ws)
    return torch.where(win[:, None, :] == win[:, :, None], 0.0, MASK_VALUE)


def _attention(qkv: torch.Tensor, table: torch.Tensor, heads: int, ws: int,
               shift: int) -> torch.Tensor:
    """NCHW ``qkv`` ``(n, 3C, h, w)`` -> ``(n, C, h, w)``: roll by
    ``-shift``, windows of ``ws`` x ``ws``, per window and head
    ``softmax(q k^T / sqrt(d) + B + M) v``, merge, roll back."""
    n, c3, h, w = qkv.shape
    c, t = c3 // 3, ws * ws
    d = c // heads
    x = qkv.permute(0, 2, 3, 1)
    if shift:
        x = torch.roll(x, (-shift, -shift), (1, 2))
    x = x.reshape(n, h // ws, ws, w // ws, ws, 3, heads, d)
    x = x.permute(5, 0, 1, 3, 6, 2, 4, 7).reshape(3, n, -1, heads, t, d)
    q, k, v = x[0], x[1], x[2]
    bias = table[_relative_index(ws).to(table.device)]  # (T, T, heads)
    score = (q * d ** -0.5) @ k.transpose(-2, -1) + bias.permute(2, 0, 1)
    if shift:
        score = score + _shift_mask(h, w, ws, shift).to(score)[:, None]
    y = torch.softmax(score, dim=-1) @ v  # (n, nW, heads, T, d)
    y = y.reshape(n, h // ws, w // ws, heads, ws, ws, d)
    y = y.permute(0, 1, 4, 2, 5, 3, 6).reshape(n, h, w, c)
    if shift:
        y = torch.roll(y, (shift, shift), (1, 2))
    return y.permute(0, 3, 1, 2)


def forward(cfg: dict, w: Dict[str, Dict[str, torch.Tensor]],
            x: torch.Tensor, conv: Callable) -> torch.Tensor:
    """Model-domain ``(N, 3, H, W)`` -> ``(N, 3, sH, sW)``.  ``conv(x,
    weight, bias, padding)`` is the convolution (float32, or the control's
    lower precision); a token linear is its 1x1 convolution."""
    dim, ws, s = cfg["embed_dim"], cfg["window_size"], cfg["upscale"]
    _, _, h, wd = x.shape
    x = F.pad(x, (0, (-wd) % ws, 0, (-h) % ws), mode="reflect")
    mean = w["mean"]["data"].view(1, -1, 1, 1)

    def c(name, v, slope=None):
        p = w[name]
        y = conv(v, p["weight"], p["bias"], p["weight"].shape[-1] // 2)
        return y if slope is None else F.leaky_relu(y, slope)

    def ln(name, v):
        p = w[name]
        return F.layer_norm(v.permute(0, 2, 3, 1), (dim,), p["gamma"],
                            p["beta"], 1e-5).permute(0, 3, 1, 2)

    def three_conv(tag, v):
        return c(f"{tag}4", c(f"{tag}2", c(f"{tag}0", v, 0.2), 0.2))

    feat = c("conv_first", x - mean)
    t = ln("patch_norm", feat)
    b = 0
    for i, depth in enumerate(cfg["depths"]):
        rin = t
        for j in range(depth):
            tag = f"l{i}b{j}"
            heads, shift = blocks(cfg)[b]
            b += 1
            a = _attention(c(f"{tag}_qkv", ln(f"{tag}_norm1", t)),
                           w[f"{tag}_table"]["data"], heads, ws, shift)
            t = t + c(f"{tag}_proj", a)
            t = t + c(f"{tag}_fc2", F.gelu(c(f"{tag}_fc1", ln(f"{tag}_norm2", t))))
        t = three_conv(f"l{i}_conv", t) + rin
    y = three_conv("after_body", ln("norm", t)) + feat
    y = c("conv_before_upsample", y, 0.01)
    for k in range(1, 2 if s == 2 else 3):
        y = c(f"conv_up{k}", F.interpolate(y, scale_factor=2, mode="nearest"), 0.2)
    y = c("conv_last", c("conv_hr", y, 0.2)) + mean
    return y[:, :, :h * s, :wd * s]
