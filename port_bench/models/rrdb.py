"""RRDBNet in the 4x_Valar_v1 form: its ncnn graph and its plain forward.

ESRGAN's RRDBNet (``num_block`` residual-in-residual dense blocks of three
dense blocks each, trunk conv and global skip, nearest-2x + conv
upsampling), with Valar's dense block: five 3x3 convs over growing
concatenations, a 1x1 skip conv added into the second output, the second
output added again into the fourth, and the block's output scaled by
``res_scale`` onto its input.  The graph is the one the port's
``make_rrdb_graph(variant="valar")`` docstring describes, written here
layer by layer; the forward is that arithmetic in plain PyTorch on NCHW
tensors.
"""

from __future__ import annotations

from typing import Callable, Dict, List

import torch
import torch.nn.functional as F

from port_bench.ncnn import Layer


def layers(cfg: dict) -> List[Layer]:
    nf, gc, rs = cfg["num_feat"], cfg["num_grow_ch"], cfg["res_scale"]
    slope = cfg["leaky_slope"]
    out = [Layer("Input", "input", [], ["input"])]
    uid = [0]

    def blob():
        uid[0] += 1
        return f"b{uid[0] - 1}"

    def conv(name, src, cin, cout, k=3, act=True):
        attrs = {0: cout, 1: k, 6: cout * cin * k * k}
        if k == 3:  # SAME padding and a bias; the 1x1 skips have neither
            attrs[4] = 1
            attrs[5] = 1
        if act:
            attrs[9] = 2
            attrs[10] = [slope]
        o = blob()
        out.append(Layer("Convolution", name, [src], [o], attrs))
        return o

    def op(kind, name, srcs, attrs):
        o = blob()
        out.append(Layer(kind, name, list(srcs), [o], attrs))
        return o

    def dense(tag, x0):
        x1 = conv(f"{tag}_c1", x0, nf, gc)
        c4 = conv(f"{tag}_c4", op("Concat", f"{tag}_cat1", [x0, x1], {0: 0}),
                  nf + gc, gc)
        sk = conv(f"{tag}_c6", x0, nf, gc, k=1, act=False)
        x2 = op("BinaryOp", f"{tag}_a7", [c4, sk], {0: 0})
        x3 = conv(f"{tag}_c9",
                  op("Concat", f"{tag}_cat2", [x0, x1, x2], {0: 0}),
                  nf + 2 * gc, gc)
        c12 = conv(f"{tag}_c12",
                   op("Concat", f"{tag}_cat3", [x0, x1, x2, x3], {0: 0}),
                   nf + 3 * gc, gc)
        x4 = op("BinaryOp", f"{tag}_a14", [c12, x2], {0: 0})
        c16 = conv(f"{tag}_c16",
                   op("Concat", f"{tag}_cat4", [x0, x1, x2, x3, x4], {0: 0}),
                   nf + 4 * gc, nf, act=False)
        return op("Eltwise", f"{tag}_res", [c16, x0], {0: 1, 1: [rs, 1.0]})

    fea = conv("conv_first", "input", cfg["num_in_ch"], nf, act=False)
    x = fea
    for i in range(cfg["num_block"]):
        rin = x
        for j in range(3):
            x = dense(f"r{i}d{j}", x)
        x = op("Eltwise", f"r{i}_res", [x, rin], {0: 1, 1: [rs, 1.0]})
    trunk = conv("conv_trunk", x, nf, nf, act=False)
    x = op("BinaryOp", "trunk_add", [fea, trunk], {0: 0})
    ups = 1
    while ups < cfg["upscale"]:
        x = op("Interp", f"up{ups}", [x], {0: 1, 1: 2.0, 2: 2.0})
        x = conv(f"conv_up{ups}", x, nf, nf)
        ups *= 2
    x = conv("conv_hr", x, nf, nf)
    conv("conv_last", x, nf, cfg["num_out_ch"], act=False)
    out[-1].outputs[0] = "output"
    return out


def dense_block_convs(cfg: dict) -> List[tuple]:
    """``(cin, cout, k)`` of one dense block's six convs, which the port
    runs as one K5 launch."""
    nf, gc = cfg["num_feat"], cfg["num_grow_ch"]
    return [(nf, gc, 3), (nf + gc, gc, 3), (nf, gc, 1), (nf + 2 * gc, gc, 3),
            (nf + 3 * gc, gc, 3), (nf + 4 * gc, nf, 3)]


def dense_blocks(cfg: dict) -> int:
    return 3 * cfg["num_block"]


def forward(cfg: dict, w: Dict[str, Dict[str, torch.Tensor]],
            x: torch.Tensor, conv: Callable) -> torch.Tensor:
    """Model-domain ``(N, 3, H, W)`` -> ``(N, 3, 4H, 4W)``.  ``conv(x,
    weight, bias, padding)`` is the convolution (float32, or the control's
    lower precision)."""
    slope, rs = cfg["leaky_slope"], cfg["res_scale"]

    def c(name, v, act=True):
        p = w[name]
        k = p["weight"].shape[-1]
        y = conv(v, p["weight"], p.get("bias"), k // 2)
        return F.leaky_relu(y, slope) if act else y

    def dense(tag, x0):
        x1 = c(f"{tag}_c1", x0)
        x2 = (c(f"{tag}_c4", torch.cat([x0, x1], 1))
              + c(f"{tag}_c6", x0, act=False))
        x3 = c(f"{tag}_c9", torch.cat([x0, x1, x2], 1))
        x4 = c(f"{tag}_c12", torch.cat([x0, x1, x2, x3], 1)) + x2
        return rs * c(f"{tag}_c16", torch.cat([x0, x1, x2, x3, x4], 1),
                      act=False) + x0

    fea = c("conv_first", x, act=False)
    h = fea
    for i in range(cfg["num_block"]):
        rin = h
        for j in range(3):
            h = dense(f"r{i}d{j}", h)
        h = rs * h + rin
    h = fea + c("conv_trunk", h, act=False)
    ups = 1
    while ups < cfg["upscale"]:
        h = c(f"conv_up{ups}", F.interpolate(h, scale_factor=2, mode="nearest"))
        ups *= 2
    return c("conv_last", c("conv_hr", h), act=False)
