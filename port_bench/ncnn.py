"""ncnn model files as the benchmark writes them, and their seeded weights.

A graph is a list of :class:`Layer` in file order, as a ``.param`` file
lists them.  :func:`param_text` and :func:`bin_bytes` write the two files
the port's ``load_model`` reads (the ``-m`` path users run);
:func:`seeded_weights` makes the weights on the device from a seed.  The
plain reference reads the same weights (``models/<family>.py``), never the
port's copy of them.

The weighted layer types and their ``.bin`` layout, in ncnn's order
(``ModelBin::load``: a tagged block is a 4-byte tag then float16 values
padded to 4 bytes; a raw block is float32 with no tag):

- ``Convolution``, ``ConvolutionDepthWise``, ``Deconvolution``: tagged
  ``weight`` ``(cout, cin / group, kh, kw)``, then with attr 5 a raw
  ``bias`` ``(cout,)``.  Deconvolution's weight keeps ncnn's own order,
  output channel first, which is not PyTorch's ``ConvTranspose2d`` order;
- ``InnerProduct``: tagged ``weight`` ``(out, in)`` (attr 0 out, attr 2
  its size), then with attr 1 a raw ``bias`` ``(out,)``;
- ``PReLU``: raw ``slope`` ``(attr 0,)``;
- ``LayerNorm``: with attr 2 (affine, 1 by default) raw ``gamma`` then
  raw ``beta``, each ``(attr 0,)``;
- ``MemoryData``: raw ``data``, attrs 0, 1, 2 its w, h, c (those not 0),
  stored ``(c, h, w)``.
"""

from __future__ import annotations

import math
import re
import struct
from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np
import torch

NCNN_MAGIC = 7767517
TAG_F16 = 0x01306B47  # ncnn's float16 weight block, as the published .bin files use


@dataclass
class Layer:
    type: str
    name: str
    inputs: List[str]
    outputs: List[str]
    attrs: Dict[int, object] = field(default_factory=dict)

    def attr(self, key: int, default=0):
        return self.attrs.get(key, default)


def blob_count(layers: List[Layer]) -> int:
    return len({b for layer in layers for b in layer.outputs})


def _fmt(v) -> str:
    return f"{v:e}" if isinstance(v, float) else str(v)


def param_text(layers: List[Layer]) -> str:
    """The ``.param`` text: magic, ``<layers> <blobs>``, one line a layer;
    an array attribute ``k`` is written as key ``-(k + 23300)``."""
    lines = [str(NCNN_MAGIC), f"{len(layers)} {blob_count(layers)}"]
    for layer in layers:
        parts = [layer.type, layer.name, str(len(layer.inputs)),
                 str(len(layer.outputs)), *layer.inputs, *layer.outputs]
        for k, v in layer.attrs.items():
            if isinstance(v, list):
                parts.append(f"{-(k + 23300)}={len(v)},"
                             + ",".join(_fmt(x) for x in v))
            else:
                parts.append(f"{k}={_fmt(v)}")
        lines.append(" ".join(parts))
    return "\n".join(lines) + "\n"


CONV_TYPES = ("Convolution", "ConvolutionDepthWise", "Deconvolution")
TAGGED = CONV_TYPES + ("InnerProduct",)  # the weight is a float16-tagged block


def conv_shape(layer: Layer):
    """``(cout, cin / group, kh, kw)`` of a Convolution,
    ConvolutionDepthWise or Deconvolution layer (its attrs 0, 1, 11, 6)."""
    cout, kw = int(layer.attr(0)), int(layer.attr(1))
    kh = int(layer.attr(11, kw))
    return cout, int(layer.attr(6)) // (cout * kh * kw), kh, kw


def weight_shapes(layers: List[Layer]) -> Dict[str, Dict[str, tuple]]:
    """Every weight the graph holds, by layer and key, in the order the
    ``.bin`` stores them (the module's docstring lists the types)."""
    out: Dict[str, Dict[str, tuple]] = {}
    for layer in layers:
        lt, shapes = layer.type, {}
        if lt in CONV_TYPES:
            shapes["weight"] = conv_shape(layer)
            if layer.attr(5):
                shapes["bias"] = (int(layer.attr(0)),)
        elif lt == "InnerProduct":
            n = int(layer.attr(0))
            shapes["weight"] = (n, int(layer.attr(2)) // n)
            if layer.attr(1):
                shapes["bias"] = (n,)
        elif lt == "PReLU":
            shapes["slope"] = (int(layer.attr(0, 1)),)
        elif lt == "LayerNorm":
            if layer.attr(2, 1):
                shapes["gamma"] = shapes["beta"] = (int(layer.attr(0)),)
        elif lt == "MemoryData":
            dims = tuple(int(layer.attr(k)) for k in (2, 1, 0)
                         if int(layer.attr(k)))
            if dims:
                shapes["data"] = dims
        if shapes:
            out[layer.name] = shapes
    return out


def conv_init(init: dict, name: str, fan_in: int) -> dict:
    """The initialisation of conv or InnerProduct ``name`` under ``init``:
    its top-level keys, then those of each rule whose ``match`` (a regular
    expression) finds the name, later rules winning.  Keys: ``conv_std``
    (the weights' standard deviation) or ``conv_gain`` (that over
    ``sqrt(fan_in)``); ``bias_gain`` likewise for the bias (the weights' own
    deviation by default), or ``bias``, a constant; ``zero_mean``, each
    output channel's weights less their mean."""
    r = {k: v for k, v in init.items() if k not in ("rules", "prelu_slope")}
    for rule in init.get("rules", []):
        if re.search(rule["match"], name):
            r.update({k: v for k, v in rule.items() if k != "match"})
    w_std = r["conv_std"] if "conv_std" in r \
        else r["conv_gain"] / math.sqrt(fan_in)
    b_std = (r["bias_gain"] / math.sqrt(fan_in) if "bias_gain" in r
             else w_std)
    return {"weight": w_std, "bias": b_std, "fill": r.get("bias"),
            "zero_mean": bool(r.get("zero_mean"))}


def seeded_weights(layers: List[Layer], seed: int, device, init: dict
                   ) -> Dict[str, Dict[str, torch.Tensor]]:
    """Weights of ``layers`` from ``seed`` on ``device``, in at most two
    calls of a generator there.  The first, normal, covers every weight
    but PReLU slopes, in file order: conv and InnerProduct weights and
    biases scaled per layer as :func:`conv_init` says over the weight's
    fan-in; LayerNorm ``gamma`` ``1 + N(0, norm_std)`` and ``beta`` ``N(0,
    norm_std)`` (``init["norm_std"]``, 0.1 by default: an affine part a
    program drops shows); MemoryData ``N(0, data_std)`` (``init
    ["data_std"]``, 0.02 by default).  The second, where the graph has a
    PReLU, draws the slopes uniform in ``init["prelu_slope"]``.  Tagged
    weights are rounded to float16, as the ``.bin`` stores them, so the
    port and the reference read the same numbers."""
    shapes = weight_shapes(layers)
    kinds = {layer.name: layer.type for layer in layers}
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    normal = [(n, k, s) for n, d in shapes.items() for k, s in d.items()
              if k != "slope"]
    slopes = [(n, k, s) for n, d in shapes.items() for k, s in d.items()
              if k == "slope"]
    out: Dict[str, Dict[str, torch.Tensor]] = {n: {} for n in shapes}
    total = sum(int(np.prod(s)) for _, _, s in normal)
    flat = torch.randn(total, generator=gen, device=device)
    pos = 0
    for name, key, shape in normal:
        size = int(np.prod(shape))
        v = flat[pos:pos + size].reshape(shape)
        if kinds[name] == "LayerNorm":
            v = v * init.get("norm_std", 0.1) + (1.0 if key == "gamma" else 0.0)
        elif kinds[name] == "MemoryData":
            v = v * init.get("data_std", 0.02)
        else:
            wshape = shapes[name]["weight"]
            how = conv_init(init, name, int(np.prod(wshape[1:])))
            if key == "weight":
                if how["zero_mean"]:
                    v = v - v.mean(dim=tuple(range(1, v.dim())), keepdim=True)
                v = (v * how["weight"]).to(torch.float16).to(torch.float32)
            elif how["fill"] is not None:
                v = torch.full_like(v, float(how["fill"]))
            else:
                v = v * how["bias"]
        out[name][key] = v
        pos += size
    if slopes:
        lo, hi = init["prelu_slope"]
        total = sum(int(np.prod(s)) for _, _, s in slopes)
        flat = torch.rand(total, generator=gen, device=device) * (hi - lo) + lo
        pos = 0
        for name, key, shape in slopes:
            size = int(np.prod(shape))
            out[name][key] = flat[pos:pos + size].reshape(shape)
            pos += size
    return out


def bin_bytes(layers: List[Layer], weights: Dict[str, Dict[str, torch.Tensor]]
              ) -> bytes:
    """The ``.bin`` bytes, layer by layer in file order and each layer's
    weights in the order :func:`weight_shapes` gives: a conv's or an
    InnerProduct's ``weight`` as a float16-tagged block (padded to 4
    bytes), every other weight raw float32."""
    out = bytearray()
    for layer in layers:
        for key in weight_shapes([layer]).get(layer.name, {}):
            v = weights[layer.name][key].detach().cpu().numpy()
            if key == "weight" and layer.type in TAGGED:
                payload = v.astype("<f2").tobytes()
                out += struct.pack("<I", TAG_F16) + payload
                out += b"\x00" * ((-len(payload)) % 4)
            else:
                out += v.astype("<f4").tobytes()
    return bytes(out)
