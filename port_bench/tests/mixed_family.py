"""A family for the benchmark's tests alone, outside ``models/`` so that no
entry of ``BENCHMARK.json`` can name it: a tiny graph with one of each
weighted layer type the harness writes beyond Convolution and PReLU
(ConvolutionDepthWise, Deconvolution, InnerProduct, LayerNorm,
MemoryData) and a channel gate behind a global Pooling, with its own count
of a frame's work.  The port does not load these types yet, so the tests
stop before the engine is built."""

from __future__ import annotations

from typing import List

from port_bench.ncnn import Layer

CONFIG = {
    "name": "mixed", "family": "mixed", "upscale": 2, "model_file": "x_mixed",
    "num_in_ch": 3, "num_feat": 8, "num_out_feat": 3, "num_gate": 2,
    "table": [4, 3, 2],
    "init": {"conv_gain": 1.0, "bias_gain": 0.5, "norm_std": 0.2,
             "data_std": 0.05,
             "rules": [{"match": "^fc$", "conv_std": 0.3, "zero_mean": True,
                        "bias": 0.25}]},
}


def layers(cfg: dict) -> List[Layer]:
    cin, f, g, r = (cfg["num_in_ch"], cfg["num_feat"], cfg["num_out_feat"],
                    cfg["num_gate"])
    w, h, c = cfg["table"]
    return [
        Layer("Input", "input", [], ["input"]),
        Layer("Convolution", "conv_in", ["input"], ["c0"],
              {0: f, 1: 3, 4: 1, 5: 1, 6: f * cin * 9}),
        Layer("ConvolutionDepthWise", "dw", ["c0"], ["c1"],
              {0: f, 1: 3, 4: 1, 5: 1, 6: f * 9, 7: f}),
        Layer("Deconvolution", "up", ["c1"], ["c2"],
              {0: g, 1: 2, 3: 2, 5: 1, 6: g * f * 4}),
        Layer("Split", "split", ["c2"], ["c2a", "c2b"]),
        Layer("Pooling", "gap", ["c2a"], ["p"], {0: 1, 4: 1}),
        Layer("Convolution", "squeeze", ["p"], ["q"], {0: r, 1: 1, 6: r * g}),
        Layer("LayerNorm", "ln", ["q"], ["n"], {0: r, 1: 1e-5, 2: 1}),
        Layer("InnerProduct", "fc", ["n"], ["e"], {0: g, 1: 1, 2: g * r}),
        Layer("Sigmoid", "gate", ["e"], ["s"]),
        Layer("BinaryOp", "scale", ["c2b", "s"], ["x"], {0: 2}),
        Layer("MemoryData", "table", [], ["t"], {0: w, 1: h, 2: c}),
        Layer("Convolution", "conv_out", ["x"], ["output"],
              {0: cin, 1: 3, 4: 1, 5: 1, 6: cin * g * 9}),
    ]


def flops(cfg: dict, height: int, width: int) -> float:
    """2 x the multiply-adds of the convs, the 2x deconvolution (per input
    pixel) and the gate's 1x1 conv and InnerProduct on the pooled
    ``(1, 1, c)``."""
    cin, f, g, r = (cfg["num_in_ch"], cfg["num_feat"], cfg["num_out_feat"],
                    cfg["num_gate"])
    hw = height * width
    return 2.0 * (9 * cin * f * hw + 9 * f * hw + 4 * f * g * hw
                  + g * r + r * g + 9 * g * cin * 4 * hw)
