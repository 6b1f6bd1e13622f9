"""Analytic conv FLOP counts for ncnn graphs (static shape propagation).

The bench contract must carry ``tflops``/``mfu`` for every family, every
round (round-3 verdict): XLA's ``cost_analysis`` intermittently fails on
the remote platform, and for the 1,206-layer Valar graph even lowering a
second program just to read metadata costs minutes.  Conv MACs are fully
determined by the graph text (attr shapes) + the input geometry, so this
module walks the :class:`NcnnGraph` with a (h, w, c) shape map and sums
``2 * kh * kw * cin/groups * cout * oh * ow`` per conv.

Scope: convolutions only — they are >99% of the FLOPs in every zoo family
(SRVGG/RRDBNet are conv towers; elementwise/resize work is bandwidth, not
FLOPs).  The NL-means denoise stage is *not* counted (it is VPU-bound
elementwise work, reference upscale_processing.py:350-361); callers that
chain ``n=K`` get a conv-only count, which is the honest MXU-work figure
MFU prices.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

from upscale_video_tpu_torch.models.param_parser import NcnnGraph, NcnnLayer

Shape = Tuple[int, int, int]  # (h, w, c)


def _conv_out_hw(layer: NcnnLayer, h: int, w: int) -> Tuple[int, int]:
    kw = layer.attr_i(1)
    kh = layer.attr_i(11, kw)
    sw = layer.attr_i(3, 1)
    sh = layer.attr_i(13, sw)
    dw = layer.attr_i(2, 1)
    dh = layer.attr_i(12, dw)
    pad_l = layer.attr_i(4, 0)
    if pad_l == -233:  # ncnn SAME_UPPER (executor._op_convolution:87)
        return math.ceil(h / sh), math.ceil(w / sw)
    pad_t = layer.attr_i(14, pad_l)
    pad_r = layer.attr_i(15, pad_l)
    pad_b = layer.attr_i(16, pad_t)
    oh = (h + pad_t + pad_b - (kh - 1) * dh - 1) // sh + 1
    ow = (w + pad_l + pad_r - (kw - 1) * dw - 1) // sw + 1
    return oh, ow


def graph_conv_flops(graph: NcnnGraph, height: int, width: int,
                     in_channels: int = 3) -> float:
    """Total conv FLOPs (2*MACs) for one forward at the given input
    geometry, by static shape propagation over the graph."""
    shapes: Dict[str, Shape] = {}
    flops = 0.0
    for layer in graph.layers:
        lt = layer.type
        if lt == "Input":
            for blob in layer.outputs:
                shapes[blob] = (height, width, in_channels)
            continue
        ins = [shapes[b] for b in layer.inputs]
        if lt in ("Convolution", "ConvolutionDepthWise"):
            h, w, cin = ins[0]
            cout = layer.attr_i(0)
            kw = layer.attr_i(1)
            kh = layer.attr_i(11, kw)
            groups = layer.attr_i(7, 1) if lt == "ConvolutionDepthWise" else 1
            oh, ow = _conv_out_hw(layer, h, w)
            flops += 2.0 * kh * kw * (cin // groups) * cout * oh * ow
            out: Shape = (oh, ow, cout)
        elif lt == "PixelShuffle":
            h, w, c = ins[0]
            r = layer.attr_i(0, 1)
            out = (h * r, w * r, c // (r * r))
        elif lt == "Reorg":
            h, w, c = ins[0]
            r = layer.attr_i(0, 1)
            out = (h // r, w // r, c * r * r)
        elif lt == "Interp":
            h, w, c = ins[0]
            oh = layer.attr_i(3, 0) or int(h * layer.attr_f(1, 1.0))
            ow = layer.attr_i(4, 0) or int(w * layer.attr_f(2, 1.0))
            out = (oh, ow, c)
        elif lt == "Concat":
            h, w, _ = ins[0]
            out = (h, w, sum(c for _, _, c in ins))
        else:
            # Split/Noop/PReLU/ReLU/Clip/Sigmoid/Dropout/BinaryOp/Eltwise:
            # shape-preserving (broadcast binaries take the first operand's
            # shape — the zoo never broadcasts across spatial dims)
            out = ins[0]
        for blob in layer.outputs:
            shapes[blob] = out
    return flops


def chain_step_flops(engine, height: int, width: int) -> float:
    """Analytic conv FLOPs for ONE frame through a ChainEngine's fused
    step at the given input geometry (useful work: halo/tile recompute
    overhead of the tiled path is deliberately NOT counted — MFU prices
    delivered work, and the tiled path's ~1.16x pixel overhead is a cost,
    not throughput).  The x8 TTA ensemble multiplies the SR stage by 8."""
    total = 0.0
    if engine.anime_model is not None:
        total += graph_conv_flops(engine.anime_model.graph, height, width)
    if engine.sr_model is not None:
        sr = graph_conv_flops(engine.sr_model.graph, height, width)
        total += 8.0 * sr if engine.tta else sr
    return total
