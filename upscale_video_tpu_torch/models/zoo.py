"""Model zoo: resolution, loading, the Compact architecture, ``Model``.

Port of ``upscale_video_tpu/models/zoo.py:57-193, 196-245, 404-420``.
``make_srvgg_graph`` is a host copy (the same graph, layer for layer);
``Model`` is an ``nn.Module`` holding its weights as buffers in the
kernels' layout (:func:`params_from_jax`).  The on-disk stem is
``str(scale) + model_file`` as in the reference.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from upscale_video_tpu_torch.models.bin_loader import (
    load_weights_file, synthesize_weights,
)
from upscale_video_tpu_torch.models.executor import (
    SRVGGForward, build_forward, probe_srvgg_tail,
)
from upscale_video_tpu_torch.models.param_parser import (
    NcnnGraph, NcnnLayer, parse_param_file,
)

MODEL_FILES = {
    "compact": "x_Compact_Pretrain",
    "valar": "x_Valar_v1",
    "anime": "x_HurrDeblur_SubCompact_nf24-nc8_244k_net_g",
}

_ENV_MODEL_PATH = "UPSCALE_TPU_MODEL_PATH"


def resolve_model_path(model_path: Optional[str] = None) -> Optional[str]:
    """Locate the model directory: explicit arg > env var > ./models."""
    for c in (model_path, os.environ.get(_ENV_MODEL_PATH),
              os.path.join(os.getcwd(), "models")):
        if c and os.path.isdir(c):
            return c
    return None


class LayerWeights(nn.Module):
    """One ncnn layer's weights as buffers: ``wmat`` (9*cin, cout) in the
    compute dtype (the kernels' matrix, rows in (dy, dx, cin) order) and
    ``bias`` (cout,) f32 for a conv; ``slope`` (C,) f32 for a PReLU."""

    def __init__(self, **tensors: torch.Tensor):
        super().__init__()
        for k, v in tensors.items():
            self.register_buffer(k, v)


def params_from_jax(params: Dict[str, Dict[str, np.ndarray]],
                    device: "torch.device | str",
                    compute_dtype: torch.dtype = torch.bfloat16) -> nn.ModuleDict:
    """The JAX package's params (nested dicts of numpy arrays from
    ``synthesize_weights`` / ``load_weights``: HWIO ``weight``, ``bias``,
    ``slope``) -> the port's model state on ``device``."""
    state = {}
    for name, p in params.items():
        t = {}
        if "weight" in p:
            w = np.asarray(p["weight"], np.float32)
            if w.ndim != 4:
                raise NotImplementedError(f"{name}: weight {w.shape} is not HWIO")
            kh, kw, cin, cout = w.shape
            t["wmat"] = torch.from_numpy(
                np.ascontiguousarray(w.reshape(kh * kw * cin, cout))
            ).to(device=device, dtype=compute_dtype).contiguous()
            b = p.get("bias")
            t["bias"] = (torch.zeros(cout) if b is None
                         else torch.from_numpy(np.asarray(b, np.float32).copy())
                         ).to(device)
        if "slope" in p:
            t["slope"] = torch.from_numpy(
                np.asarray(p["slope"], np.float32).copy()).to(device)
        state[name] = LayerWeights(**t)
    return nn.ModuleDict(state)


class Model(nn.Module):
    """A loaded SRVGG-family model on one device."""

    def __init__(self, name: str, scale: int, graph: NcnnGraph,
                 params: Dict[str, Dict[str, np.ndarray]],
                 device: "torch.device | str",
                 compute_dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.name = name
        self.scale = scale
        self.graph = graph
        self.device = torch.device(device)
        self.compute_dtype = compute_dtype
        self.state = params_from_jax(params, self.device, compute_dtype)
        self._forwards: Dict[str, SRVGGForward] = {}

    def frames_forward(self, emit: str = "frames") -> SRVGGForward:
        """The built forward for one output layout (cached)."""
        if emit not in self._forwards:
            self._forwards[emit] = build_forward(
                self.graph, self.device, self.compute_dtype, emit)
        return self._forwards[emit]

    @property
    def planar_scale(self) -> Optional[int]:
        return probe_srvgg_tail(self.graph)

    def forward(self, x: torch.Tensor, emit: str = "model") -> torch.Tensor:
        """Model-domain float ``(N, H, W, 3)`` -> the ``emit`` layout."""
        return self.frames_forward(emit)(self.state, x)


def load_model(model_file: str, scale: int, device: "torch.device | str",
               model_path: Optional[str] = None,
               compute_dtype: torch.dtype = torch.bfloat16) -> Model:
    """Load ``{scale}{model_file}.param/.bin`` from a model directory."""
    stem_suffix = MODEL_FILES.get(model_file, model_file)
    base = resolve_model_path(model_path)
    if base is None:
        raise FileNotFoundError(
            f"no model directory found (set {_ENV_MODEL_PATH} or pass model_path)"
        )
    stem = os.path.join(base, f"{scale}{stem_suffix}")
    graph = parse_param_file(stem + ".param")
    params = load_weights_file(graph, stem + ".bin")
    return Model(f"{scale}{stem_suffix}", scale, graph, params, device,
                 compute_dtype)


def make_srvgg_graph(
    scale: int = 2,
    num_conv: int = 16,
    num_feat: int = 64,
    in_ch: int = 3,
    out_ch: int = 3,
) -> NcnnGraph:
    """SRVGGNetCompact graph (host copy of the JAX zoo's): Input -> Split ->
    [Conv3x3 + PReLU] x (num_conv+1) -> Conv3x3(out_ch*scale^2) ->
    PixelShuffle(scale) -> nearest-Interp(scale) skip -> Add.  With
    ``num_conv=16, num_feat=64`` it is FLOP-identical to
    ``2x_Compact_Pretrain``."""
    layers = [
        NcnnLayer("Input", "input", [], ["input"]),
        NcnnLayer("Split", "split_in", ["input"], ["in_skip", "in_body"]),
    ]
    prev = "in_body"
    ch = in_ch
    for i in range(num_conv + 1):
        cname, pname = f"conv_{i}", f"prelu_{i}"
        layers.append(
            NcnnLayer(
                "Convolution", cname, [prev], [f"c{i}"],
                {0: num_feat, 1: 3, 4: 1, 5: 1, 6: num_feat * ch * 9},
            )
        )
        layers.append(NcnnLayer("PReLU", pname, [f"c{i}"], [f"p{i}"], {0: num_feat}))
        prev, ch = f"p{i}", num_feat
    up_ch = out_ch * scale * scale
    layers.append(
        NcnnLayer(
            "Convolution", "conv_up", [prev], ["pre_shuffle"],
            {0: up_ch, 1: 3, 4: 1, 5: 1, 6: up_ch * ch * 9},
        )
    )
    layers.append(
        NcnnLayer("PixelShuffle", "shuffle", ["pre_shuffle"], ["shuffled"], {0: scale})
    )
    layers.append(
        NcnnLayer(
            "Interp", "skip_up", ["in_skip"], ["skip"],
            {0: 1, 1: float(scale), 2: float(scale)},
        )
    )
    layers.append(NcnnLayer("BinaryOp", "residual", ["shuffled", "skip"], ["output"]))
    blob_count = len({b for l in layers for b in l.outputs})
    return NcnnGraph(layers=layers, blob_count=blob_count)


def make_synthetic_model(
    scale: int = 2,
    num_conv: int = 16,
    num_feat: int = 64,
    seed: int = 0,
    device: "torch.device | str" = "cpu",
    compute_dtype: torch.dtype = torch.bfloat16,
) -> Model:
    """A Compact-architecture model with random weights (the JAX
    ``make_synthetic_model``'s graph and, byte for byte, its weights)."""
    graph = make_srvgg_graph(scale=scale, num_conv=num_conv, num_feat=num_feat)
    params = synthesize_weights(graph, seed=seed)
    return Model(f"synthetic_{scale}x_compact", scale, graph, params, device,
                 compute_dtype)
