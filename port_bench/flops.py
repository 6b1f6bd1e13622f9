"""The work a forward does, counted from the graph and the shapes.

The convention, for every family: the work of a frame is 2 x the
multiply-adds of its convolutions, its linear layers and attention's two
products (QK^T and AV), over the frame's useful pixels, with no tile
halos.  Norms, softmax, activations and elementwise ops are not counted.
It is the same work whatever implements it.

:func:`graph_conv_flops` counts it from an ncnn graph by static shape
propagation: a frozen copy of the arithmetic of the port's
``models/flops.py`` (``2 * kh * kw * cin / group * cout * oh * ow`` per
Convolution and ConvolutionDepthWise), with Deconvolution (its work per
input pixel), InnerProduct (ncnn's, over the whole blob: 2 x its weights)
and global Pooling (to ``(1, 1, c)``) added.  A family whose work the
graph does not show (attention's products) gives its own count as
``flops(cfg, height, width)`` in ``models/<family>.py``, and the harness
takes that.  Also here: the bound of one kernel launch, the larger of its
operations at the bf16 tensor-core peak and its bytes at the HBM peak,
each input byte read once and each output byte written once.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

from port_bench.ncnn import Layer, conv_shape

# One NVIDIA H100 SXM (data sheet, dense, 700 W): bf16 tensor cores and HBM3
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12


def _window(layer: Layer):
    """``(kh, kw, sh, sw, dh, dw, pad_t, pad_b, pad_l, pad_r)`` of a
    Convolution-like layer, ncnn's defaults filled in."""
    kw = int(layer.attr(1))
    sw = int(layer.attr(3, 1))
    dw = int(layer.attr(2, 1))
    pad_l = int(layer.attr(4, 0))
    pad_t = int(layer.attr(14, pad_l))
    return (int(layer.attr(11, kw)), kw, int(layer.attr(13, sw)), sw,
            int(layer.attr(12, dw)), dw, pad_t, int(layer.attr(16, pad_t)),
            pad_l, int(layer.attr(15, pad_l)))


def _conv_out_hw(layer: Layer, h: int, w: int) -> Tuple[int, int]:
    kh, kw, sh, sw, dh, dw, pad_t, pad_b, pad_l, pad_r = _window(layer)
    if pad_l == -233:  # ncnn SAME_UPPER
        return math.ceil(h / sh), math.ceil(w / sw)
    oh = (h + pad_t + pad_b - (kh - 1) * dh - 1) // sh + 1
    ow = (w + pad_l + pad_r - (kw - 1) * dw - 1) // sw + 1
    return oh, ow


def _deconv_out_hw(layer: Layer, h: int, w: int) -> Tuple[int, int]:
    """As ncnn's Deconvolution: the full output, cut by the positive pads,
    else by the output size (attrs 20, 21) where one is given."""
    kh, kw, sh, sw, dh, dw, pad_t, pad_b, pad_l, pad_r = _window(layer)
    opad_r = int(layer.attr(18, 0))
    oh = (h - 1) * sh + dh * (kh - 1) + 1 + int(layer.attr(19, opad_r))
    ow = (w - 1) * sw + dw * (kw - 1) + 1 + opad_r
    if max(pad_t, pad_b, pad_l, pad_r) > 0:
        return oh - pad_t - pad_b, ow - pad_l - pad_r
    out_w = int(layer.attr(20, 0))
    out_h = int(layer.attr(21, out_w))
    return (out_h, out_w) if out_w > 0 and out_h > 0 else (oh, ow)


def graph_conv_flops(layers: List[Layer], height: int, width: int,
                     in_channels: int = 3) -> float:
    """FLOPs (2 x MACs) of the convolutions and InnerProducts of one
    forward at ``height`` x ``width``.  A windowed Pooling raises: its
    shape is not followed here, so its family gives its own ``flops``."""
    shapes: Dict[str, Tuple[int, int, int]] = {}
    flops = 0.0
    for layer in layers:
        lt = layer.type
        if lt == "Input":
            for b in layer.outputs:
                shapes[b] = (height, width, in_channels)
            continue
        ins = [shapes[b] for b in layer.inputs]
        if lt in ("Convolution", "ConvolutionDepthWise"):
            h, w, cin = ins[0]
            cout, _, kh, kw = conv_shape(layer)
            groups = int(layer.attr(7, 1)) if lt == "ConvolutionDepthWise" else 1
            oh, ow = _conv_out_hw(layer, h, w)
            flops += 2.0 * kh * kw * (cin // groups) * cout * oh * ow
            out = (oh, ow, cout)
        elif lt == "Deconvolution":
            h, w, _ = ins[0]
            cout, cin, kh, kw = conv_shape(layer)
            flops += 2.0 * kh * kw * cin * cout * h * w
            out = (*_deconv_out_hw(layer, h, w), cout)
        elif lt == "InnerProduct":
            flops += 2.0 * int(layer.attr(2))
            out = (1, 1, int(layer.attr(0)))
        elif lt == "Pooling":
            if not int(layer.attr(4, 0)):
                raise ValueError(f"{layer.name}: a windowed Pooling is not "
                                 "counted here; give the family its flops")
            out = (1, 1, ins[0][2])
        elif lt == "MemoryData":
            out = (int(layer.attr(1)) or 1, int(layer.attr(0)) or 1,
                   int(layer.attr(2)) or 1)
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
        else:  # Split, PReLU, BinaryOp, Eltwise, LayerNorm: shape-preserving
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
