"""ncnn model files as the benchmark writes them, and their seeded weights.

A graph is a list of :class:`Layer` in file order, as a ``.param`` file
lists them.  :func:`param_text` and :func:`bin_bytes` write the two files
the port's ``load_model`` reads (the ``-m`` path users run);
:func:`seeded_weights` makes the weights on the device from a seed.  The
plain reference reads the same weights (``models/<family>.py``), never the
port's copy of them.
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


def conv_shape(layer: Layer):
    """``(cout, cin, k, k)`` of a Convolution layer (its attrs 0, 1, 6)."""
    cout, k = int(layer.attr(0)), int(layer.attr(1))
    return cout, int(layer.attr(6)) // (cout * k * k), k, k


def weight_shapes(layers: List[Layer]) -> Dict[str, Dict[str, tuple]]:
    """Every weight the graph holds: a conv's ``weight`` (OIHW) and, with
    attr 5, its ``bias``; a PReLU's ``slope``."""
    out: Dict[str, Dict[str, tuple]] = {}
    for layer in layers:
        if layer.type == "Convolution":
            shape = conv_shape(layer)
            out[layer.name] = {"weight": shape}
            if layer.attr(5):
                out[layer.name]["bias"] = (shape[0],)
        elif layer.type == "PReLU":
            out[layer.name] = {"slope": (int(layer.attr(0, 1)),)}
    return out


def conv_init(init: dict, name: str, fan_in: int) -> dict:
    """The initialisation of conv ``name`` under ``init``: its top-level
    keys, then those of each rule whose ``match`` (a regular expression)
    finds the name, later rules winning.  Keys: ``conv_std`` (the weights'
    standard deviation) or ``conv_gain`` (that over ``sqrt(fan_in)``);
    ``bias_gain`` likewise for the bias (the weights' own deviation by
    default), or ``bias``, a constant; ``zero_mean``, each output channel's
    weights less their mean."""
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
    """Weights of ``layers`` from ``seed`` on ``device``, in two calls of a
    generator there: conv weights and biases normal, scaled per conv as
    :func:`conv_init` says, PReLU slopes uniform in
    ``init["prelu_slope"]``.  Conv weights are rounded to float16, as the
    ``.bin`` stores them, so the port and the reference read the same
    numbers."""
    shapes = weight_shapes(layers)
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
        wshape = shapes[name]["weight"]
        how = conv_init(init, name, int(np.prod(wshape[1:])))
        v = flat[pos:pos + size].reshape(shape)
        if key == "weight":
            if how["zero_mean"]:
                v = v - v.mean(dim=(1, 2, 3), keepdim=True)
            v = (v * how["weight"]).to(torch.float16).to(torch.float32)
        elif how["fill"] is not None:
            v = torch.full_like(v, float(how["fill"]))
        else:
            v = v * how["bias"]
        out[name][key] = v
        pos += size
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
    """The ``.bin`` bytes: per conv a float16-tagged OIHW weight block
    (padded to 4 bytes) then its float32 bias; per PReLU its float32
    slopes."""
    out = bytearray()
    for layer in layers:
        w = weights.get(layer.name)
        if layer.type == "Convolution":
            payload = w["weight"].detach().cpu().numpy().astype("<f2").tobytes()
            out += struct.pack("<I", TAG_F16) + payload
            out += b"\x00" * ((-len(payload)) % 4)
            if "bias" in w:
                out += w["bias"].detach().cpu().numpy().astype("<f4").tobytes()
        elif layer.type == "PReLU":
            out += w["slope"].detach().cpu().numpy().astype("<f4").tobytes()
    return bytes(out)
