"""The work a forward does, counted from the graph and the shapes.

A frozen copy of the arithmetic of the port's ``models/flops.py``
(``graph_conv_flops``: static shape propagation, ``2 * kh * kw * cin *
cout * oh * ow`` per conv, convolutions only) over the benchmark's own
graph, and the bound of one kernel launch: the larger of its operations
at the bf16 tensor-core peak and its bytes at the HBM peak, each input
byte read once and each output byte written once.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

from port_bench.ncnn import Layer, conv_shape

# One NVIDIA H100 SXM (data sheet, dense, 700 W): bf16 tensor cores and HBM3
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12


def _conv_out_hw(layer: Layer, h: int, w: int) -> Tuple[int, int]:
    kw = int(layer.attr(1))
    kh = int(layer.attr(11, kw))
    sw = int(layer.attr(3, 1))
    sh = int(layer.attr(13, sw))
    dw = int(layer.attr(2, 1))
    dh = int(layer.attr(12, dw))
    pad_l = int(layer.attr(4, 0))
    if pad_l == -233:  # ncnn SAME_UPPER
        return math.ceil(h / sh), math.ceil(w / sw)
    pad_t = int(layer.attr(14, pad_l))
    pad_r = int(layer.attr(15, pad_l))
    pad_b = int(layer.attr(16, pad_t))
    oh = (h + pad_t + pad_b - (kh - 1) * dh - 1) // sh + 1
    ow = (w + pad_l + pad_r - (kw - 1) * dw - 1) // sw + 1
    return oh, ow


def graph_conv_flops(layers: List[Layer], height: int, width: int,
                     in_channels: int = 3) -> float:
    """Conv FLOPs (2 x MACs) of one forward at ``height`` x ``width``."""
    shapes: Dict[str, Tuple[int, int, int]] = {}
    flops = 0.0
    for layer in layers:
        lt = layer.type
        if lt == "Input":
            for b in layer.outputs:
                shapes[b] = (height, width, in_channels)
            continue
        ins = [shapes[b] for b in layer.inputs]
        if lt == "Convolution":
            h, w, cin = ins[0]
            cout, _, kh, kw = conv_shape(layer)
            oh, ow = _conv_out_hw(layer, h, w)
            flops += 2.0 * kh * kw * cin * cout * oh * ow
            out = (oh, ow, cout)
        elif lt == "PixelShuffle":
            h, w, c = ins[0]
            r = int(layer.attr(0, 1))
            out = (h * r, w * r, c // (r * r))
        elif lt == "Interp":
            h, w, c = ins[0]
            out = (int(layer.attr(3, 0)) or int(h * float(layer.attr(1, 1.0))),
                   int(layer.attr(4, 0)) or int(w * float(layer.attr(2, 1.0))),
                   c)
        elif lt == "Concat":
            h, w, _ = ins[0]
            out = (h, w, sum(c for _, _, c in ins))
        else:  # Split, PReLU, BinaryOp, Eltwise: shape-preserving
            out = ins[0]
        for b in layer.outputs:
            shapes[b] = out
    return flops


def conv_flops(n: int, h: int, w: int, cin: int, cout: int, k: int) -> float:
    return 2.0 * k * k * cin * cout * n * h * w


def launch_bound_s(flops: float, nbytes: float) -> float:
    """The least time a launch of ``flops`` operations moving ``nbytes``
    can take on one H100."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES)


def conv_launch_bound_s(n: int, h: int, w: int, cin: int, cout: int, k: int,
                        elem_bytes: int = 2) -> float:
    """One 3x3 (or ``k`` x ``k``) SAME conv launch over ``n`` frames of
    ``h`` x ``w``: its input and output activations and its weights, each
    once, in bf16."""
    nbytes = elem_bytes * (n * h * w * (cin + cout) + k * k * cin * cout)
    return launch_bound_s(conv_flops(n, h, w, cin, cout, k), nbytes)
