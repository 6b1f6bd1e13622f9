"""SRVGGNetCompact (Real-ESRGAN, ``realesrgan/archs/srvgg_arch.py``): its
ncnn graph and its plain forward.

The graph is the published ``2x_Compact_Pretrain.param``'s structure: Input
-> Split -> ``num_conv + 1`` x (3x3 conv + PReLU) -> 3x3 conv to
``3 * upscale**2`` channels -> PixelShuffle -> add the input's nearest
upscale.  The forward is that arithmetic in plain PyTorch on NCHW tensors,
written from the architecture, not from the port.
"""

from __future__ import annotations

from typing import Callable, Dict, List

import torch
import torch.nn.functional as F

from port_bench.ncnn import Layer


def layers(cfg: dict) -> List[Layer]:
    feat, s = cfg["num_feat"], cfg["upscale"]
    out = [Layer("Input", "input", [], ["input"]),
           Layer("Split", "split_in", ["input"], ["in_skip", "in_body"])]
    prev, ch = "in_body", cfg["num_in_ch"]
    for i in range(cfg["num_conv"] + 1):
        out.append(Layer("Convolution", f"conv_{i}", [prev], [f"c{i}"],
                         {0: feat, 1: 3, 4: 1, 5: 1, 6: feat * ch * 9}))
        out.append(Layer("PReLU", f"prelu_{i}", [f"c{i}"], [f"p{i}"],
                         {0: feat}))
        prev, ch = f"p{i}", feat
    up = cfg["num_out_ch"] * s * s
    out += [
        Layer("Convolution", "conv_up", [prev], ["pre_shuffle"],
              {0: up, 1: 3, 4: 1, 5: 1, 6: up * ch * 9}),
        Layer("PixelShuffle", "shuffle", ["pre_shuffle"], ["shuffled"],
              {0: s}),
        Layer("Interp", "skip_up", ["in_skip"], ["skip"],
              {0: 1, 1: float(s), 2: float(s)}),
        Layer("BinaryOp", "residual", ["shuffled", "skip"], ["output"]),
    ]
    return out


def k1_layers(cfg: dict) -> List[str]:
    """The convs of the body, which the port runs as one K1 chain (the
    tail conv is K2's)."""
    return [f"conv_{i}" for i in range(cfg["num_conv"] + 1)]


def forward(cfg: dict, w: Dict[str, Dict[str, torch.Tensor]],
            x: torch.Tensor, conv: Callable) -> torch.Tensor:
    """Model-domain ``(N, 3, H, W)`` -> ``(N, 3, sH, sW)``.  ``conv(x,
    weight, bias, padding)`` is the convolution (float32, or the control's
    lower precision)."""
    h = x
    for i in range(cfg["num_conv"] + 1):
        h = conv(h, w[f"conv_{i}"]["weight"], w[f"conv_{i}"]["bias"], 1)
        h = F.prelu(h, w[f"prelu_{i}"]["slope"])
    h = conv(h, w["conv_up"]["weight"], w["conv_up"]["bias"], 1)
    s = cfg["upscale"]
    return F.pixel_shuffle(h, s) + F.interpolate(x, scale_factor=s,
                                                 mode="nearest")
