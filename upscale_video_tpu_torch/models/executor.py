"""Graph planner + forward module for the SRVGG (Compact) family.

Port of the parts of ``upscale_video_tpu/models/executor.py`` that the
Compact graph reaches with ``--conv_impl pallas``: ``_match_srvgg_tail``
(:884), ``probe_srvgg_tail`` (:935) and the chain assembly
(``_plan_pallas_fusion`` / ``_assemble_chains``, :705-881).  In the port
this plan is the only one: the whole body becomes one bordered conv chain
(kernel K1, :mod:`upscale_video_tpu_torch.ops.conv_chain`) and the tail one
fused tail launch (kernel K2, :mod:`upscale_video_tpu_torch.ops.tail`).

The JAX planner's TPU lane gate (``_pallas_fusable``'s ``cin >= 32``,
executor.py:723-730) is not copied: every SRVGG graph becomes chain + tail.
A graph outside the covered ops (Input, Split, SAME 3x3 stride-1
Convolution, PReLU, PixelShuffle mode 0, integer-scale nearest Interp,
BinaryOp add) raises ``NotImplementedError``; nothing falls back.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
from torch import nn

from upscale_video_tpu_torch.models.bin_loader import _infer_conv_in_channels
from upscale_video_tpu_torch.models.param_parser import NcnnGraph, NcnnLayer
from upscale_video_tpu_torch.ops.common import (
    ACT_LEAKY, ACT_NONE, ACT_PRELU, ACT_RELU,
)
from upscale_video_tpu_torch.ops.conv_chain import ChainLayer, conv3x3_chain
from upscale_video_tpu_torch.ops.tail import LAYOUTS, sr_tail_chain

SUPPORTED_OPS = frozenset({
    "Input", "Split", "Convolution", "PReLU", "PixelShuffle", "Interp",
    "BinaryOp",
})


def _consumers(graph: NcnnGraph) -> Dict[str, List[int]]:
    out: Dict[str, List[int]] = {}
    for idx, layer in enumerate(graph.layers):
        for b in layer.inputs:
            out.setdefault(b, []).append(idx)
    return out


def _chain_eligible(layer: NcnnLayer) -> bool:
    """SAME 3x3 / stride 1 / dilation 1 / pad 1 convs with both channel
    counts in 1..128 and a fused activation of none/relu/leaky
    (executor.py:733 ``_chain_eligible``)."""
    kw = layer.attr_i(1)
    kh = layer.attr_i(11, kw)
    sw = layer.attr_i(3, 1)
    sh = layer.attr_i(13, sw)
    dw = layer.attr_i(2, 1)
    dh = layer.attr_i(12, dw)
    p = layer.attr_i(4, 0)
    pads = {p, layer.attr_i(14, p), layer.attr_i(15, p), layer.attr_i(16, p)}
    cout = layer.attr_i(0)
    cin = _infer_conv_in_channels(layer) or 0
    return (kw, kh) == (3, 3) and (sw, sh) == (1, 1) and (dw, dh) == (1, 1) \
        and pads == {1} and layer.attr_i(9, 0) in (0, 1, 2) \
        and 0 < cin <= 128 and 0 < cout <= 128


def _match_srvgg_tail(graph: NcnnGraph, consumers, conv_idx: int):
    """Detect ``conv -> PixelShuffle(s) -> Add(<- nearest Interp(s) of the
    network input)``; returns a plan dict or None (executor.py:884)."""
    conv = graph.layers[conv_idx]
    if conv.attr_i(9, 0) != 0:
        return None
    cons = consumers.get(conv.outputs[0], [])
    if len(cons) != 1 or graph.layers[cons[0]].type != "PixelShuffle":
        return None
    shuffle = graph.layers[cons[0]]
    s = shuffle.attr_i(0, 1)
    if s < 2 or shuffle.attr_i(1, 0) != 0 or conv.attr_i(0) != 3 * s * s:
        return None
    sh_cons = consumers.get(shuffle.outputs[0], [])
    if len(sh_cons) != 1 or graph.layers[sh_cons[0]].type != "BinaryOp":
        return None
    add = graph.layers[sh_cons[0]]
    if add.attr_i(0, 0) != 0 or add.attr_i(1, 0) != 0 or len(add.inputs) != 2:
        return None
    other = [b for b in add.inputs if b != shuffle.outputs[0]][0]
    if len(consumers.get(other, [])) != 1:
        return None
    interp = next(
        (l for l in graph.layers if other in l.outputs and l.type == "Interp"),
        None,
    )
    if interp is None or interp.attr_i(0, 0) not in (0, 1):
        return None
    if interp.attr_f(1, 1.0) != float(s) or interp.attr_f(2, 1.0) != float(s):
        return None
    skip_src = interp.inputs[0]
    producer = next((l for l in graph.layers if skip_src in l.outputs), None)
    if producer is None or producer.type not in ("Input", "Split"):
        return None
    if producer.type == "Split" and producer.inputs[0] != graph.input_blobs[0]:
        return None
    return {
        "kind": "tail",
        "scale": s,
        "skip_blob": skip_src,
        "out": add.outputs[0],
        "absorbed": {shuffle.name, interp.name, add.name},
    }


def probe_srvgg_tail(graph: NcnnGraph) -> Optional[int]:
    """The SRVGG tail's shuffle factor when ``graph`` ends in it, else None
    (executor.py:935)."""
    outputs = graph.output_blobs
    if len(graph.input_blobs) != 1 or len(outputs) != 1:
        return None
    consumers = _consumers(graph)
    for idx, layer in enumerate(graph.layers):
        if layer.type != "Convolution":
            continue
        t = _match_srvgg_tail(graph, consumers, idx)
        if t is not None and t["out"] == outputs[0] \
                and not consumers.get(t["out"]):
            return t["scale"]
    return None


def plan_srvgg(graph: NcnnGraph) -> dict:
    """Plan ``graph`` as one conv chain + one fused tail.

    Returns ``{"items": [{"name", "prelu", "act", "slope_attr"}, ...],
    "tail": {"conv", "scale", "skip_blob", "out"}}``.  Raises
    ``NotImplementedError`` for any graph that is not exactly that."""
    unsupported = sorted({l.type for l in graph.layers}
                         - SUPPORTED_OPS)
    if unsupported:
        raise NotImplementedError(
            f"unsupported ncnn layer types for the port: {unsupported}")
    inputs, outputs = graph.input_blobs, graph.output_blobs
    if len(inputs) != 1 or len(outputs) != 1:
        raise NotImplementedError(
            f"one input and one output expected, got {inputs} / {outputs}")
    consumers = _consumers(graph)
    tail = None
    for idx, layer in enumerate(graph.layers):
        if layer.type == "Convolution":
            t = _match_srvgg_tail(graph, consumers, idx)
            if t is not None and t["out"] == outputs[0]:
                tail = dict(t, conv=layer.name)
                break
    if tail is None:
        raise NotImplementedError(
            "graph does not end in the SRVGG tail (conv -> PixelShuffle -> "
            "add of a nearest-upsampled input)")

    # walk the body from the network input: [conv (+PReLU)]* -> tail conv
    blob = inputs[0]
    split = [l for l in graph.layers if l.type == "Split"]
    for l in split:
        if l.inputs[0] != inputs[0]:
            raise NotImplementedError(f"Split {l.name} is not of the input")
        body = [b for b in l.outputs if b != tail["skip_blob"]]
        if len(body) != 1:
            raise NotImplementedError(f"Split {l.name}: expected one body branch")
        blob = body[0]
    items: List[dict] = []
    claimed = {l.name for l in split} | tail["absorbed"] | {tail["conv"]}
    while True:
        # without a Split the input also feeds the tail's skip Interp
        cons = [c for c in consumers.get(blob, [])
                if blob != tail["skip_blob"]
                or graph.layers[c].name not in tail["absorbed"]]
        if len(cons) != 1:
            raise NotImplementedError(
                f"blob {blob!r} has {len(cons)} consumers: not a linear chain")
        layer = graph.layers[cons[0]]
        if layer.type != "Convolution" or not _chain_eligible(layer):
            raise NotImplementedError(
                f"layer {layer.name} ({layer.type}) is not a SAME 3x3 "
                "stride-1 conv the chain kernel takes")
        if layer.name == tail["conv"]:
            break
        item = {"name": layer.name, "prelu": None,
                "act": layer.attr_i(9, 0),
                "slope_attr": layer.attr(10, [0.0])}
        claimed.add(layer.name)
        blob = layer.outputs[0]
        nxt = consumers.get(blob, [])
        if item["act"] == 0 and len(nxt) == 1 \
                and graph.layers[nxt[0]].type == "PReLU":
            prelu = graph.layers[nxt[0]]
            item["prelu"] = prelu.name
            claimed.add(prelu.name)
            blob = prelu.outputs[0]
        items.append(item)
    if not items:
        raise NotImplementedError("SRVGG graph with no body convolution")
    left = [l.name for l in graph.layers
            if l.type != "Input" and l.name not in claimed]
    if left:
        raise NotImplementedError(f"layers outside the chain + tail plan: {left}")
    return {"items": items, "tail": tail}


def _act_code(item: dict) -> int:
    if item["prelu"] is not None:
        return ACT_PRELU
    if item["act"] == 1:
        return ACT_RELU
    if item["act"] == 2:
        return ACT_LEAKY
    return ACT_NONE


class SRVGGForward(nn.Module):
    """Stateless forward of a planned SRVGG graph: ``fwd(state, x)`` runs
    K1 over the whole body then K2 once.

    ``state`` maps layer name -> a module with ``wmat`` (9*cin, cout),
    ``bias`` (cout,) f32 and, for PReLU layers, ``slope`` (see
    :func:`upscale_video_tpu_torch.models.zoo.params_from_jax`).  ``x`` is
    the model-domain float input ``(N, H, W, 3)`` (BGR, [0, 1]).  ``emit``
    is one of the tail layouts: ``"model"`` returns float32 model-domain
    ``(N, sH, sW, 3)``, ``"frames"`` uint8 RGB, ``"planar"`` uint8
    ``(N, H, W, 3*s*s)``.
    """

    def __init__(self, plan: dict, device: torch.device,
                 compute_dtype: torch.dtype, emit: str):
        super().__init__()
        if emit not in LAYOUTS:
            raise ValueError(f"emit {emit!r} not in {LAYOUTS}")
        self.items = plan["items"]
        self.tail = plan["tail"]
        self.scale = self.tail["scale"]
        self.compute_dtype = compute_dtype
        self.emit = emit
        self.device = torch.device(device)
        # fused leaky slopes come from the graph, not the weights
        self._leaky = {
            it["name"]: float(it["slope_attr"][0]) for it in self.items
            if it["prelu"] is None and it["act"] == 2
        }

    def chain_layers(self, state) -> List[ChainLayer]:
        layers = []
        for it in self.items:
            lw = state[it["name"]]
            cout = lw.wmat.shape[1]
            act = _act_code(it)
            if act == ACT_PRELU:
                slope = state[it["prelu"]].slope
            elif act == ACT_LEAKY:
                slope = torch.full((cout,), self._leaky[it["name"]],
                                   dtype=torch.float32, device=lw.wmat.device)
            else:
                slope = torch.zeros((cout,), dtype=torch.float32,
                                    device=lw.wmat.device)
            layers.append(ChainLayer(lw.wmat, lw.bias, slope, act))
        return layers

    def forward(self, state, x: torch.Tensor) -> torch.Tensor:
        squeeze = x.ndim == 3
        if squeeze:
            x = x[None]
        # the skip reads the input rounded to the compute dtype, as the
        # JAX executor's blobs[input] = x.astype(compute_dtype)
        x = x.to(device=self.device, dtype=self.compute_dtype).contiguous()
        buf = conv3x3_chain(x, self.chain_layers(state), crop=False)
        tw = state[self.tail["conv"]]
        y = sr_tail_chain(buf, x, tw.wmat, tw.bias, self.scale, self.emit)
        return y[0] if squeeze else y


def build_forward(graph: NcnnGraph, device: "torch.device | str",
                  compute_dtype: torch.dtype = torch.bfloat16,
                  emit: str = "model") -> SRVGGForward:
    """Plan ``graph`` and return its forward module (K1 then K2).

    ``compute_dtype`` bf16 runs the kernels on CUDA (held to the JAX
    Pallas path); float32 is accepted only on the CPU, where the plain
    versions run (held to the JAX XLA f32 path)."""
    device = torch.device(device)
    if compute_dtype not in (torch.bfloat16, torch.float32):
        raise NotImplementedError(f"compute dtype {compute_dtype}")
    if device.type == "cuda" and compute_dtype != torch.bfloat16:
        raise NotImplementedError(
            "the CUDA kernels compute in bf16; float32 runs on the CPU only")
    return SRVGGForward(plan_srvgg(graph), device, compute_dtype, emit)
