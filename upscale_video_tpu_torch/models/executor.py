"""Graph planners + forward modules: the SRVGG (Compact) family with its
shuffle tail, and the graph walk for everything else (the RRDBNet family,
Valar and ESRGAN; the 1x SRVGG anime deblur model; SRVGG imports whose
body is not one chain).

SRVGG: port of the parts of ``upscale_video_tpu/models/executor.py`` that
the Compact graph reaches with ``--conv_impl pallas``: ``_match_srvgg_tail``
(:884), ``probe_srvgg_tail`` (:935) and the chain assembly
(``_plan_pallas_fusion`` / ``_assemble_chains``, :705-881).  A graph whose
body is one run of two or more chain-eligible convs becomes one bordered
conv chain (kernel K1, :mod:`upscale_video_tpu_torch.ops.conv_chain`) and
the tail one fused tail launch (kernel K2, :mod:`upscale_video_tpu_torch.ops.tail`).
The JAX planner's TPU lane gate (``_pallas_fusable``'s ``cin >= 32``,
executor.py:723-730) is not copied.

Graph walk: port of ``_plan_rdb_blocks`` (:539-702, with
``_dense_conv_class`` :383), of ``_plan_pallas_fusion`` (:757-811) and the
bordered-chain assembly (``_assemble_chains`` :814), of the Reorg mod-pad
(:1222-1241) and of ``build_forward``'s graph walk (:1001-1570) for the
generic ops in :mod:`upscale_video_tpu_torch.models.ops`: every matched
dense block is one K5 launch (:mod:`upscale_video_tpu_torch.ops.rdb`), every
run of two or more linearly linked SAME 3x3 convs one K1 chain, every other
SAME 3x3 stride-1 conv one K4 launch (:mod:`upscale_video_tpu_torch.ops.conv3x3`,
with a PReLU that alone consumes it fused in; an ESRGAN dense block's convs
on one shared buffer instead of their Concats), an SRVGG tail one K3 launch
(:func:`~upscale_video_tpu_torch.ops.tail.sr_tail_fused`), every other
layer one op; blobs are freed at their last use, and ``mixed`` keeps the
residual spine (Eltwise/BinaryOp) in f32.

``--conv_impl`` picks among these routes as the JAX package reads the
flag (:func:`conv_routes`): ``xla`` (and every f32 forward) is the graph
walk on generic ops alone, the aten route; ``rdb`` adds K5 alone;
``pallas`` the conv kernels without K5; ``auto`` both.

:class:`TensorParallelForward` is the graph walk under ``--parallel tp``:
no K1 chain, each conv's output channels split over the GPUs of a mesh,
one K4 launch per GPU at its slice, then :func:`exchange_channels`.

A layer type outside the op set raises ``NotImplementedError``; nothing
falls back.
"""

from __future__ import annotations

import logging
from typing import Dict, List, Optional

import torch
from torch import nn

import torch.nn.functional as F

from upscale_video_tpu_torch.models.bin_loader import _infer_conv_in_channels
from upscale_video_tpu_torch.models.ops import OP_REGISTRY, conv_geometry
from upscale_video_tpu_torch.models.param_parser import NcnnGraph, NcnnLayer
from upscale_video_tpu_torch.ops.common import (
    ACT_LEAKY, ACT_NONE, ACT_PRELU, ACT_RELU,
)
from upscale_video_tpu_torch.ops.conv3x3 import conv3x3_fused
from upscale_video_tpu_torch.ops.conv_chain import (
    ChainLayer, conv3x3_chain, pack_narrow_weights,
)
from upscale_video_tpu_torch.ops.pixel import frames_to_planar, model_to_frames
from upscale_video_tpu_torch.ops.rdb import RDBWeights, pack_rdb_weights, rdb_block
from upscale_video_tpu_torch.ops.tail import (
    LAYOUTS, pack_tail_weights, sr_tail_chain, sr_tail_fused,
)
from upscale_video_tpu_torch.ops.yuv import yuv420_from_planar

log = logging.getLogger(__name__)

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
    kh, kw, stride, dil, pads = conv_geometry(layer)
    cout = layer.attr_i(0)
    cin = _infer_conv_in_channels(layer) or 0
    return (kh, kw) == (3, 3) and stride == (1, 1) and dil == (1, 1) \
        and set(pads) == {1} and layer.attr_i(9, 0) in (0, 1, 2) \
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


def _find_tail(graph: NcnnGraph, consumers) -> Optional[dict]:
    """The SRVGG tail that ends ``graph`` (its one output, consumed by no
    layer): :func:`_match_srvgg_tail`'s plan plus ``"conv"``, the tail
    conv's name; None where the graph does not end in one."""
    outputs = graph.output_blobs
    if len(graph.input_blobs) != 1 or len(outputs) != 1 \
            or consumers.get(outputs[0]):
        return None
    for idx, layer in enumerate(graph.layers):
        if layer.type == "Convolution":
            t = _match_srvgg_tail(graph, consumers, idx)
            if t is not None and t["out"] == outputs[0]:
                return dict(t, conv=layer.name)
    return None


def probe_srvgg_tail(graph: NcnnGraph) -> Optional[int]:
    """The SRVGG tail's shuffle factor when ``graph`` ends in it, else None
    (executor.py:935)."""
    tail = _find_tail(graph, _consumers(graph))
    return tail["scale"] if tail is not None else None


def _conv_item(graph: NcnnGraph, consumers, layer: NcnnLayer) -> dict:
    """A conv as a plan item ``{"name", "prelu", "act", "slope_attr",
    "out"}``: a conv with no fused activation takes in a PReLU that alone
    consumes it, and ``out`` is the blob the item ends in."""
    item = {"name": layer.name, "prelu": None, "act": layer.attr_i(9, 0),
            "slope_attr": layer.attr(10, [0.0]), "out": layer.outputs[0]}
    cons = consumers.get(item["out"], [])
    if item["act"] == 0 and len(cons) == 1 \
            and graph.layers[cons[0]].type == "PReLU":
        item["prelu"] = graph.layers[cons[0]].name
        item["out"] = graph.layers[cons[0]].outputs[0]
    return item


def plan_srvgg(graph: NcnnGraph) -> dict:
    """Plan ``graph`` as one conv chain of two or more layers + one fused
    tail.

    Returns ``{"items": [{"name", "prelu", "act", "slope_attr", "out"},
    ...], "tail": {"conv", "scale", "skip_blob", "out"}}``.  Raises
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
    tail = _find_tail(graph, consumers)
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
        item = _conv_item(graph, consumers, layer)
        claimed.update(n for n in (item["name"], item["prelu"]) if n)
        blob = item["out"]
        items.append(item)
    if len(items) < 2:
        raise NotImplementedError(
            f"SRVGG body of {len(items)} conv(s): no chain to run on K1")
    left = [l.name for l in graph.layers
            if l.type != "Input" and l.name not in claimed]
    if left:
        raise NotImplementedError(f"layers outside the chain + tail plan: {left}")
    return {"items": items, "tail": tail}


def _solo_args(item: dict, state):
    """A solo conv item -> K4's ``(wmat, bias, slope, act)``: the PReLU's
    slope tensor, the leaky slope as a float (no device read), else None."""
    lw = state[item["name"]]
    act = _act_code(item)
    slope = (state[item["prelu"]].slope if act == ACT_PRELU
             else float(item["slope_attr"][0]) if act == ACT_LEAKY else None)
    return lw.wmat, lw.bias, slope, act


def _act_code(item: dict) -> int:
    if item["prelu"] is not None:
        return ACT_PRELU
    if item["act"] == 1:
        return ACT_RELU
    if item["act"] == 2:
        return ACT_LEAKY
    return ACT_NONE


def chain_layers(items: List[dict], state) -> List[ChainLayer]:
    """A planned conv chain's items (``{"name", "prelu", "act",
    "slope_attr"}``) -> K1's layers from the model state: PReLU slopes from
    the PReLU layer's weights, a fused leaky slope from the graph."""
    layers = []
    for it in items:
        lw = state[it["name"]]
        cout = lw.wmat.shape[1]
        act = _act_code(it)
        if act == ACT_PRELU:
            slope = state[it["prelu"]].slope
        else:
            value = float(it["slope_attr"][0]) if act == ACT_LEAKY else 0.0
            slope = torch.full((cout,), value, dtype=torch.float32,
                               device=lw.wmat.device)
        layers.append(ChainLayer(lw.wmat, lw.bias, slope, act,
                                 getattr(lw, "wpack_narrow", None)))
    return layers


def pack_chain_weights(items: List[dict], state) -> None:
    """Add each chain layer's packed weights for K1's narrow kernel
    (``wpack_narrow``, :func:`~upscale_video_tpu_torch.ops.conv_chain.
    pack_narrow_weights`) to ``state`` where that kernel takes its shape
    in bf16, once: a second layout's forward finds them packed."""
    for it in items:
        lw = state[it["name"]]
        if not hasattr(lw, "wpack_narrow"):
            pack = pack_narrow_weights(lw.wmat)
            if pack is not None:
                lw.register_buffer("wpack_narrow", pack)


def _plan_chains(graph: NcnnGraph, consumers: Dict[str, List[int]],
                 exclude=frozenset()):
    """Maximal runs of two or more linearly linked chain-eligible convs,
    each conv with no fused activation absorbing a PReLU that alone
    consumes it (``_plan_pallas_fusion`` + ``_assemble_chains``,
    executor.py:757-864, without the solo-conv plans).  Returns ``({first
    conv name: {"items", "out"}}, absorbed layer names)``; ``exclude``
    holds convs another plan claims."""
    links = {layer.name: _conv_item(graph, consumers, layer)
             for layer in graph.layers
             if layer.type == "Convolution" and layer.name not in exclude
             and _chain_eligible(layer)}
    chains: Dict[str, dict] = {}
    absorbed: set = set()
    used: set = set()
    for layer in graph.layers:
        if layer.name not in links or layer.name in used:
            continue
        seq = [layer.name]
        while True:
            cons = consumers.get(links[seq[-1]]["out"], [])
            if len(cons) != 1:
                break
            nxt = graph.layers[cons[0]].name
            if nxt not in links or nxt in used or nxt in seq:
                break
            seq.append(nxt)
        if len(seq) < 2:
            continue
        items = [links[n] for n in seq]
        chains[seq[0]] = {"items": items, "out": items[-1]["out"]}
        used.update(seq)
        absorbed.update(seq[1:])
        absorbed.update(it["prelu"] for it in items if it["prelu"])
    return chains, absorbed


class SRVGGForward(nn.Module):
    """Stateless forward of a planned SRVGG graph: ``fwd(state, x)`` runs
    K1 over the whole body then K2 once.  Its one residual add is K2's
    skip add, which is f32 in every layout (bias, conv and the skip summed
    in f32 before the one quantization, as in the JAX Pallas tail,
    tail_pallas.py:196-200), so ``--precision mixed`` runs it unchanged.

    ``state`` maps layer name -> a module with ``wmat`` (9*cin, cout),
    ``bias`` (cout,) f32 and, for PReLU layers, ``slope`` (see
    :func:`upscale_video_tpu_torch.models.zoo.params_from_jax`).  ``x`` is
    the model-domain float input ``(N, H, W, 3)`` (BGR, [0, 1]).  ``emit``
    is one of the tail layouts: ``"model"`` returns float32 model-domain
    ``(N, sH, sW, 3)``, ``"frames"`` uint8 RGB, ``"planar"`` uint8
    ``(N, H, W, 3*s*s)``, ``"yuv420"`` the packed 4:2:0 uint8 ``(N, H, W,
    s*s + 2*(s//2)**2)`` (``forward``'s ``full_range``), tail and pack in
    one K2 launch.
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

    def prepare(self, state: nn.ModuleDict) -> None:
        """Pack the chain's narrow-kernel weights into ``state``
        (:func:`pack_chain_weights`) and the tail's Hopper weights
        (``wpack_tail``, :func:`~upscale_video_tpu_torch.ops.tail.
        pack_tail_weights`) where that kernel takes its shape in bf16, at
        plan time."""
        pack_chain_weights(self.items, state)
        tw = state[self.tail["conv"]]
        if not hasattr(tw, "wpack_tail"):
            pack = pack_tail_weights(tw.wmat, self.scale)
            if pack is not None:
                tw.register_buffer("wpack_tail", pack)

    def forward(self, state, x: torch.Tensor,
                full_range: bool = False) -> torch.Tensor:
        squeeze = x.ndim == 3
        if squeeze:
            x = x[None]
        # the skip reads the input rounded to the compute dtype, as the
        # JAX executor's blobs[input] = x.astype(compute_dtype)
        x = x.to(device=self.device, dtype=self.compute_dtype).contiguous()
        buf = conv3x3_chain(x, chain_layers(self.items, state), crop=False)
        tw = state[self.tail["conv"]]
        y = sr_tail_chain(buf, x, tw.wmat, tw.bias, self.scale, self.emit,
                          full_range, getattr(tw, "wpack_tail", None))
        return y[0] if squeeze else y


def _dense_conv_class(layer: NcnnLayer) -> Optional[str]:
    """``"3x3"`` for SAME 3x3 stride-1 dilation-1 convs, ``"1x1"`` for pad-0
    1x1 stride-1 convs, else None; the activation must be none/relu/leaky
    (executor.py:383)."""
    if layer.type != "Convolution" or len(layer.inputs) != 1:
        return None
    if layer.attr_i(9, 0) not in (0, 1, 2):
        return None
    kh, kw, stride, dil, pads = conv_geometry(layer)
    if stride != (1, 1) or dil != (1, 1):
        return None
    if (kh, kw) == (3, 3) and set(pads) == {1}:
        return "3x3"
    if (kh, kw) == (1, 1) and set(pads) == {0}:
        return "1x1"
    return None


def _blob_roots(graph: NcnnGraph):
    """``(root_of, producer)``: a blob through its Split/Noop aliases to the
    blob they copy, and the layer producing a blob's root (None for a
    network input)."""
    producers: Dict[str, int] = {}
    for i, layer in enumerate(graph.layers):
        for b in layer.outputs:
            producers[b] = i

    def root_of(blob: str) -> str:
        seen = set()
        while blob not in seen:
            seen.add(blob)
            pi = producers.get(blob)
            if pi is None:
                return blob
            layer = graph.layers[pi]
            if layer.type in ("Split", "Noop") and layer.inputs:
                blob = layer.inputs[0]
            else:
                return blob
        return blob

    def producer(blob: str) -> Optional[NcnnLayer]:
        pi = producers.get(root_of(blob))
        return graph.layers[pi] if pi is not None else None

    return root_of, producer


def _interior_splits(graph: NcnnGraph, consumers, interior: set,
                     names: set) -> Optional[set]:
    """The Split/Noop layers that alias a block's ``interior`` blobs
    (``interior`` grows by their outputs), or None where an interior blob
    reaches a consumer outside the block's layer ``names`` and those
    aliases: the leak guard."""
    splits: set = set()
    changed = True
    while changed:
        changed = False
        for l2 in graph.layers:
            if (l2.type in ("Split", "Noop") and l2.name not in splits
                    and any(b in interior for b in l2.inputs)):
                splits.add(l2.name)
                interior |= set(l2.outputs)
                changed = True
    leaked = any(
        graph.layers[ci].name not in names and graph.layers[ci].name not in splits
        for b in interior
        for ci in consumers.get(b, [])
    )
    return None if leaked else splits


def _plan_rdb_blocks(graph: NcnnGraph, consumers: Dict[str, List[int]]):
    """Match the Valar residual dense blocks (executor.py:539-702)::

        c1 = lrelu(conv3x3(x))                          Conv_1
        c2 = lrelu(conv3x3(cat(x,c1))) + conv1x1(x)     Conv_4/Conv_6/Add_7
        c3 = lrelu(conv3x3(cat(x,c1,c2)))               Conv_9
        c4 = lrelu(conv3x3(cat(x,c1,c2,c3))) + c2       Conv_12/Add_14
        c5 = conv3x3(cat(x,c1,c2,c3,c4))                Conv_16
        out = 0.2*c5 + x                                Eltwise Add_19

    Returns ``(blocks, absorbed)``: per block the root blob, output blob,
    the five 3x3 conv names, the 1x1 skip conv, the leaky slope and the
    trigger (Eltwise) name; ``absorbed`` holds every matched layer and the
    Split/Noop aliases of interior blobs.  A block whose interior blob
    reaches a consumer outside it is not claimed (the leak guard)."""
    by_name = {layer.name: layer for layer in graph.layers}
    root_of, producer = _blob_roots(graph)

    def is_conv(layer, k, n_out, leaky):
        if layer is None or layer.type != "Convolution":
            return False
        if layer.attr_i(0) != n_out or layer.attr_i(1) != k:
            return False
        if _dense_conv_class(layer) != ("3x3" if k == 3 else "1x1"):
            return False
        act = layer.attr_i(9, 0)
        return act == 2 if leaky else act == 0

    def cat_roots(layer):
        return [root_of(b) for b in layer.inputs]

    blocks = []
    absorbed: set = set()
    for layer in graph.layers:
        if layer.type != "Eltwise" or len(layer.inputs) != 2:
            continue
        coeffs = layer.attr(1, None)
        if not coeffs or list(coeffs)[:2] != [0.2, 1.0]:
            continue
        c5_conv = producer(layer.inputs[0])
        x_root = root_of(layer.inputs[1])
        if not is_conv(c5_conv, 3, 64, leaky=False):
            continue
        cat5 = producer(c5_conv.inputs[0])
        if cat5 is None or cat5.type != "Concat" or len(cat5.inputs) != 5:
            continue
        roots = cat_roots(cat5)
        if roots[0] != x_root:
            continue
        c1_conv = producer(roots[1])
        if not (is_conv(c1_conv, 3, 32, leaky=True)
                and root_of(c1_conv.inputs[0]) == x_root):
            continue
        add7 = producer(roots[2])
        if add7 is None or add7.type != "BinaryOp" or add7.attr_i(0, 0) != 0:
            continue
        c4a, c6a = producer(add7.inputs[0]), producer(add7.inputs[1])
        if is_conv(c6a, 3, 32, leaky=True):  # argument order can flip
            c4a, c6a = c6a, c4a
        if not (is_conv(c4a, 3, 32, leaky=True)
                and is_conv(c6a, 1, 32, leaky=False)
                and root_of(c6a.inputs[0]) == x_root):
            continue
        cat2 = producer(c4a.inputs[0])
        if (cat2 is None or cat2.type != "Concat" or len(cat2.inputs) != 2
                or cat_roots(cat2) != [x_root, roots[1]]):
            continue
        c9 = producer(roots[3])
        if not is_conv(c9, 3, 32, leaky=True):
            continue
        cat3 = producer(c9.inputs[0])
        if cat3 is None or cat3.type != "Concat" or cat_roots(cat3) != roots[:3]:
            continue
        add14 = producer(roots[4])
        if (add14 is None or add14.type != "BinaryOp"
                or add14.attr_i(0, 0) != 0):
            continue
        c12, c2b = producer(add14.inputs[0]), add14.inputs[1]
        if not is_conv(c12, 3, 32, leaky=True):
            c12, c2b = producer(add14.inputs[1]), add14.inputs[0]
        if not (is_conv(c12, 3, 32, leaky=True) and root_of(c2b) == roots[2]):
            continue
        cat4 = producer(c12.inputs[0])
        if cat4 is None or cat4.type != "Concat" or cat_roots(cat4) != roots[:4]:
            continue
        block_names = {
            c1_conv.name, c4a.name, c6a.name, c9.name, c12.name,
            c5_conv.name, add7.name, add14.name, cat2.name, cat3.name,
            cat4.name, cat5.name, layer.name,
        }
        # interior blobs are never materialized: absorb their Split/Noop
        # aliases with the block, and decline a block whose interior
        # reaches a consumer outside it
        interior: set = set()
        for nm in block_names - {layer.name}:
            interior |= set(by_name[nm].outputs)
        splits = _interior_splits(graph, consumers, interior, block_names)
        if splits is None:
            continue
        blocks.append({
            "root": x_root,
            "out": layer.outputs[0],
            "convs": [c1_conv.name, c4a.name, c9.name, c12.name,
                      c5_conv.name],
            "skip_conv": c6a.name,
            "slope": float(c1_conv.attr(10, [0.2])[0]),
            "trigger": layer.name,
        })
        absorbed |= block_names | splits
    return blocks, absorbed


def _plan_solos(graph: NcnnGraph, consumers: Dict[str, List[int]],
                claimed) -> Dict[str, dict]:
    """Every SAME 3x3 stride-1 conv with a none/relu/leaky activation that
    no other plan claims, as one K4 launch; a PReLU that alone consumes a
    conv with no fused activation joins it (``_plan_pallas_fusion``'s
    per-layer plans, executor.py:786-798, without the ``cin >= 32`` gate).
    Returns ``{conv name: {"name", "prelu", "act", "slope_attr", "out"}}``."""
    return {layer.name: _conv_item(graph, consumers, layer)
            for layer in graph.layers
            if layer.name not in claimed and _dense_conv_class(layer) == "3x3"}


def _plan_dense_buffers(graph: NcnnGraph, consumers: Dict[str, List[int]],
                        solos: Dict[str, dict]):
    """Match dense blocks whose sources can share one buffer (basicsr's
    ``rdb_esrgan``, and Valar's blocks, zoo.py)::

        o1 = conv_1(x)
        o2 = conv_2(cat(x, o1))
        ...
        ok = conv_k(cat(x, o1, .., o(k-1)))
        y  = conv_last(cat(x, o1, .., ok))

    Every conv a K4 solo (``solos``), every cat a channel Concat whose parts
    are the previous cat's plus the newest conv's output, all widths
    multiples of 8, and no longer such chain through the same convs.  A
    part may also be an add (BinaryOp 0) of a conv's output, which that add
    alone consumes, and another blob (Valar's ``c2 = conv(..) + conv1x1(x)``
    and ``c4 = conv(..) + c2``).  Such a block runs on one NHWC buffer of
    ``conv_last``'s input width: x is copied into its first channels, each
    conv reads the channels before its own and appends its output behind
    them (an add's conv: the add's result, written over it after the add),
    and no Concat runs.  A block whose cat output reaches a consumer
    outside it is not claimed (the leak guard).

    Returns ``({conv name: {"block", "first", "cin", "out_off", "total",
    "post_add"}}, absorbed)``: ``out_off`` is where the conv writes in the
    buffer (None for ``conv_last``, which writes a tensor of its own),
    ``post_add`` the add whose result goes there in its place (or None),
    ``absorbed`` the Concats and their Split/Noop aliases."""
    root_of, producer = _blob_roots(graph)
    conv_of = {root_of(s["out"]): name for name, s in solos.items()}
    layers = {layer.name: layer for layer in graph.layers}
    post_add: Dict[str, str] = {}  # conv -> the add that alone consumes it
    for layer in graph.layers:
        if (layer.type != "BinaryOp" or layer.attr_i(0, 0) != 0
                or layer.attr_i(1, 0) or len(layer.inputs) != 2):
            continue
        mine = [conv_of[root_of(b)] for b in layer.inputs
                if root_of(b) in conv_of
                and len(consumers.get(solos[conv_of[root_of(b)]]["out"], [])) == 1]
        if len(mine) == 1:
            post_add[mine[0]] = layer.name
    part_of = {name: root_of(s["out"]) for name, s in solos.items()}
    for name, add in post_add.items():
        part_of[name] = root_of(layers[add].outputs[0])
    conv_of.update({root_of(layers[add].outputs[0]): name
                    for name, add in post_add.items()})

    def channel_cat(layer) -> bool:
        return (layer is not None and layer.type == "Concat"
                and layer.attr_i(0, 0) == 0 and len(layer.outputs) == 1)

    cat_parts = {tuple(root_of(b) for b in l.inputs)
                 for l in graph.layers if channel_cat(l)}
    plan: Dict[str, dict] = {}
    absorbed: set = set()
    for last in reversed([l.name for l in graph.layers if l.name in solos]):
        if last in plan:
            continue
        cat = producer(layers[last].inputs[0])
        if not channel_cat(cat):
            continue
        parts = [root_of(b) for b in cat.inputs]
        convs = [conv_of.get(p) for p in parts[1:]]
        if len(parts) < 2 or None in convs or any(c in plan for c in convs):
            continue
        if tuple(parts + [part_of[last]]) in cat_parts:
            continue  # not the block's last conv: a longer block was declined
        cats, ok = [cat], True
        for k in range(len(convs) - 1, 0, -1):  # conv k+1 reads cat k
            prev = producer(layers[convs[k]].inputs[0])
            ok = (channel_cat(prev)
                  and [root_of(b) for b in prev.inputs] == parts[:k + 1])
            if not ok:
                break
            cats.append(prev)
        if not ok or root_of(layers[convs[0]].inputs[0]) != parts[0]:
            continue
        cin = [_infer_conv_in_channels(layers[c]) or 0 for c in convs + [last]]
        widths = [cin[0]] + [layers[c].attr_i(0) for c in convs]
        offs = [sum(widths[:k + 1]) for k in range(len(widths))]
        if cin != offs or any(v % 8 for v in widths):
            continue
        names = {c.name for c in cats} | set(convs) | {last}
        interior = {c.outputs[0] for c in cats}
        splits = _interior_splits(graph, consumers, interior, names)
        if splits is None:
            continue
        block = len({d["block"] for d in plan.values()})
        for k, name in enumerate(convs + [last]):
            plan[name] = {"block": block, "first": k == 0, "cin": cin[k],
                          "out_off": offs[k] if name != last else None,
                          "total": offs[-1],
                          "post_add": post_add.get(name) if name != last
                          else None}
        absorbed |= {c.name for c in cats} | splits
    return plan, absorbed


class GraphForward(nn.Module):
    """Stateless forward of a graph that is not one K1 chain + K2 tail (the
    RRDBNet family, the 1x SRVGG anime model, wide or one-conv SRVGG
    imports): ``fwd(state, x)`` walks the layers in order, as the JAX
    ``build_forward`` does.

    - Every run of two or more linearly linked SAME 3x3 convs (with their
      PReLUs) is one K1 chain over the run's input cast to the compute
      dtype (:func:`_plan_chains`; on the CPU K1's plain version).  The 1x
      anime model's whole conv stack is one chain; its ``PixelShuffle(1)``,
      ``Interp(1)`` and skip add run as generic ops.
    - With ``rdb`` every matched Valar dense block is one K5 launch on the
      block's input cast to bf16; its output comes back in bf16.  Its
      packed weights live in ``state`` under the trigger's name, put there
      once by :meth:`prepare`.
    - Every other SAME 3x3 stride-1 conv is one K4 launch
      (:func:`_plan_solos`), a PReLU that alone consumes it fused in.
    - A dense block of K4 convs linked by growing Concats
      (:func:`_plan_dense_buffers`: basicsr's ESRGAN block, and Valar's
      where K5 does not take it) runs on one shared buffer: its input is
      copied in once, each conv reads a channel prefix and writes its
      channels behind it (Valar's interior adds write their result over
      their conv's), no Concat runs.  The conv outputs are channel views
      of the buffer; the bytes each conv reads are the ones its Concat
      would have made.
    - Without ``chains`` (``--parallel tp``, :class:`TensorParallelForward`)
      no K1 chain is planned: each of its convs is a K4 solo.
    - Without ``kernels`` (``--conv_impl xla`` or ``rdb``, and every f32
      forward, :func:`conv_routes`) no chain, solo, dense buffer or K3
      tail is planned: each conv is a generic ``F.conv2d`` (TF32 off), the
      SRVGG tail its generic ops, and the ``planar`` and ``yuv420``
      layouts are made from the quantized frames (the aten route).
      Without ``rdb`` (``pallas``, ``xla``) no dense block goes to K5.
    - A graph ending in the SRVGG tail (``probe_srvgg_tail``) runs its tail
      conv, shuffle, skip Interp and add as one K3 launch, which writes the
      ``emit`` layout itself (``planar`` and ``yuv420`` too); ``tail`` is
      that plan, None on the aten route.
    - ``residual_dtype=torch.float32`` with bf16 compute is ``mixed``: the
      inputs of every Eltwise and BinaryOp are upcast to f32 and their
      results flow on in f32 (``_spine_cast``, executor.py:1214); the next
      conv or dense block rounds its own input to bf16.
    - A graph with a Reorg of stride r edge-pads the input's H and W to
      multiples of r and crops the output back (executor.py:1222-1241).
    - The JAX executor's canvas-eltwise branch (executor.py:1492) needs a
      canvas on every combine operand; an RRDB's skip operand never has
      one, so on the Valar graph every combine takes the generic path,
      which is the one ported (pinned by tests/test_torch_valar.py).

    ``x``: model-domain ``(N, H, W, 3)`` (BGR, [0, 1]).  ``emit="model"``
    returns float32 ``(N, sH, sW, 3)``; ``"frames"`` uint8 RGB;
    ``"planar"`` (SRVGG tail only) uint8 ``(N, H, W, 3*s*s)``; ``"yuv420"``
    (SRVGG tail only) the packed 4:2:0 uint8 of ``forward``'s
    ``full_range``.
    """

    EMITS = LAYOUTS

    def __init__(self, graph: NcnnGraph, device: torch.device,
                 compute_dtype: torch.dtype, residual_dtype, emit: str,
                 kernels: bool = True, rdb: bool = True, chains: bool = True):
        super().__init__()
        if emit not in self.EMITS:
            raise ValueError(f"emit {emit!r} not in {self.EMITS}")
        unsupported = sorted({l.type for l in graph.layers} - set(OP_REGISTRY))
        if unsupported:
            raise NotImplementedError(
                f"unsupported ncnn layer types for the port: {unsupported}")
        if len(graph.input_blobs) != 1 or len(graph.output_blobs) != 1:
            raise NotImplementedError(
                f"one input and one output expected, got "
                f"{graph.input_blobs} / {graph.output_blobs}")
        consumers = _consumers(graph)
        fused = compute_dtype != torch.float32
        self.kernels = kernels and fused
        found = _find_tail(graph, consumers)
        if emit in ("planar", "yuv420") and found is None:
            raise ValueError(f"emit {emit!r} needs the SRVGG shuffle tail")
        self.tail_scale = found["scale"] if found else None
        self.tail = found if self.kernels else None  # K3's, else generic ops
        tail_names = (self.tail["absorbed"] | {self.tail["conv"]}
                      if self.tail else set())
        blocks, absorbed = (_plan_rdb_blocks(graph, consumers)
                            if rdb and fused else ([], set()))
        self.chains, self.chain_absorbed = (
            _plan_chains(graph, consumers, absorbed | tail_names)
            if self.kernels and chains else ({}, set()))
        self.graph = graph
        self.device = torch.device(device)
        self.compute_dtype = compute_dtype
        self.emit = emit
        self.residual_f32 = (residual_dtype == torch.float32
                             and compute_dtype != torch.float32)
        self.rdb_triggers = {b["trigger"]: b for b in blocks}
        self.rdb_absorbed = absorbed
        self.solos = (_plan_solos(graph, consumers,
                                  self.rdb_absorbed | set(self.chains)
                                  | self.chain_absorbed | tail_names)
                      if self.kernels else {})
        self.dense, dense_absorbed = _plan_dense_buffers(graph, consumers,
                                                         self.solos)
        # add -> (block, channel offset): its result goes into the buffer
        self.dense_adds = {d["post_add"]: (d["block"], d["out_off"])
                           for d in self.dense.values() if d.get("post_add")}
        self.absorbed = (self.rdb_absorbed | self.chain_absorbed
                         | dense_absorbed
                         | (tail_names - {self.tail["conv"]} if self.tail
                            else set())
                         | {s["prelu"] for s in self.solos.values()
                            if s["prelu"]})
        self.reorg_mod = max([l.attr_i(0, 1) for l in graph.layers
                              if l.type == "Reorg"] or [1])
        self.last_use: Dict[str, int] = {}
        for i, layer in enumerate(graph.layers):
            for b in layer.inputs:
                self.last_use[b] = i
        if self.tail:
            # the skip is read at the tail conv, wherever its Interp sits
            conv_idx = next(i for i, l in enumerate(graph.layers)
                            if l.name == self.tail["conv"])
            blob = self.tail["skip_blob"]
            self.last_use[blob] = max(self.last_use.get(blob, -1), conv_idx)

    def prepare(self, state: nn.ModuleDict) -> None:
        """Add each dense block's packed K5 weights to ``state`` under its
        trigger's name (the trigger Eltwise has no weights of its own), and
        each chain's narrow-kernel weights (:func:`pack_chain_weights`).
        Called at plan time (``Model.frames_forward``), where a second
        layout's forward finds them packed; :meth:`forward` only reads them."""
        from upscale_video_tpu_torch.models.zoo import LayerWeights

        for chain in self.chains.values():
            pack_chain_weights(chain["items"], state)
        for name, block in self.rdb_triggers.items():
            if name in state:
                continue
            cv = [state[c] for c in block["convs"]]
            sk = state[block["skip_conv"]]
            rw = pack_rdb_weights([c.wmat for c in cv], [c.bias for c in cv],
                                  sk.wmat, sk.bias, block["slope"],
                                  dtype=self.compute_dtype, device=self.device)
            state[name] = LayerWeights(wpack=rw.wpack, bpack=rw.bpack,
                                       wpack_sm90=rw.wpack_sm90)

    def forward(self, state, x: torch.Tensor,
                full_range: bool = False) -> torch.Tensor:
        squeeze = x.ndim == 3
        if squeeze:
            x = x[None]
        unpacked = [n for n in self.rdb_triggers if n not in state]
        if unpacked:
            raise RuntimeError(
                f"{len(unpacked)} dense blocks have no packed K5 weights in "
                f"this state (first: {unpacked[0]}): call prepare(state)")
        cd = self.compute_dtype
        graph = self.graph
        x, in_hw = self.pad_input(x.to(self.device))
        blobs: Dict[str, torch.Tensor] = {graph.input_blobs[0]: x.to(cd)}
        dense_bufs: Dict[int, torch.Tensor] = {}  # block -> its shared buffer

        for i, layer in enumerate(graph.layers):
            if layer.type == "Input":
                continue
            block = self.rdb_triggers.get(layer.name)
            if block is not None:
                pw = state[layer.name]
                blobs[block["out"]] = rdb_block(
                    blobs[layer.inputs[1]].to(cd).contiguous(),
                    RDBWeights(pw.wpack, pw.bpack, block["slope"],
                               pw.wpack_sm90))
            elif layer.name in self.chains:
                chain = self.chains[layer.name]
                blobs[chain["out"]] = conv3x3_chain(
                    blobs[layer.inputs[0]].to(cd).contiguous(),
                    chain_layers(chain["items"], state))
            elif layer.name in self.dense:
                d = self.dense[layer.name]
                if d["first"]:  # the block's input, rounded as .to(cd) does
                    x0 = blobs[layer.inputs[0]]
                    buf = torch.empty((*x0.shape[:3], d["total"]), dtype=cd,
                                      device=x0.device)
                    buf[..., :d["cin"]] = x0
                    dense_bufs[d["block"]] = buf
                buf = dense_bufs[d["block"]]
                if d["out_off"] is None:
                    del dense_bufs[d["block"]]
                blobs[self.solos[layer.name]["out"]] = conv3x3_fused(
                    buf[..., :d["cin"]], *_solo_args(self.solos[layer.name], state),
                    out_dtype=cd, out=None if d["out_off"] is None else buf,
                    out_off=d["out_off"] or 0)
            elif layer.name in self.solos:
                solo = self.solos[layer.name]
                blobs[solo["out"]] = conv3x3_fused(
                    blobs[layer.inputs[0]].to(cd).contiguous(),
                    *_solo_args(solo, state), out_dtype=cd)
            elif self.tail is not None and layer.name == self.tail["conv"]:
                tw = state[layer.name]
                blobs[self.tail["out"]] = sr_tail_fused(
                    blobs[layer.inputs[0]].to(cd).contiguous(),
                    blobs[self.tail["skip_blob"]].to(cd).contiguous(),
                    tw.wmat, tw.bias, self.tail["scale"], self.emit,
                    full_range)
            elif layer.name not in self.absorbed:
                self.run_op(layer, blobs, state, dense_bufs)
            self.free(i, layer, blobs)
        y = self.finish(blobs[graph.output_blobs[0]], tuple(x.shape[1:3]),
                        in_hw, full_range)
        return y[0] if squeeze else y

    def pad_input(self, x: torch.Tensor):
        """``x`` edge-padded to the Reorg stride's multiples, and its
        ``(H, W)`` before (executor.py:1222-1241)."""
        in_h, in_w = x.shape[1], x.shape[2]
        mod_h, mod_w = (-in_h) % self.reorg_mod, (-in_w) % self.reorg_mod
        if mod_h or mod_w:
            x = F.pad(x.permute(0, 3, 1, 2), (0, mod_w, 0, mod_h),
                      mode="replicate").permute(0, 2, 3, 1)
        return x, (in_h, in_w)

    def free(self, i: int, layer: NcnnLayer, blobs: dict) -> None:
        """Drop the blobs whose last use is layer ``i``."""
        for b in layer.inputs:
            if self.last_use.get(b) == i and b in blobs:
                del blobs[b]

    def run_op(self, layer: NcnnLayer, blobs: dict, state, dense_bufs: dict):
        """One layer outside every kernel plan as its generic op, the
        residual spine in f32 under ``mixed``; an add a dense block takes
        in writes its result over its conv's channels of the buffer."""
        ins = [blobs[b] for b in layer.inputs]
        if self.residual_f32 and layer.type in ("Eltwise", "BinaryOp"):
            ins = [t.to(torch.float32) if t.is_floating_point() else t
                   for t in ins]
        p = state[layer.name] if layer.name in state else None
        out = OP_REGISTRY[layer.type](layer, ins, p, self.compute_dtype)
        if isinstance(out, list):
            for name, t in zip(layer.outputs, out):
                blobs[name] = t
        else:
            blobs[layer.outputs[0]] = out
        if layer.name in self.dense_adds:  # over its conv's channels
            block, off = self.dense_adds[layer.name]
            dense_bufs[block][..., off:off + out.shape[-1]] = out

    def finish(self, y: torch.Tensor, padded_hw, in_hw,
               full_range: bool) -> torch.Tensor:
        """The graph's output in the ``emit`` layout: a K3 tail's as it
        is; otherwise f32, the Reorg padding cropped (``padded_hw`` the
        input's size after :meth:`pad_input`, ``in_hw`` before), then
        quantized and packed as ``emit`` asks."""
        if self.tail is not None:
            return y
        y = y.to(torch.float32)
        if tuple(padded_hw) != tuple(in_hw):
            r = y.shape[1] // padded_hw[0]
            y = y[:, :in_hw[0] * r, :in_hw[1] * r]
        if self.emit != "model":
            y = model_to_frames(y)
        if self.emit in ("planar", "yuv420"):
            y = frames_to_planar(y, self.tail_scale)
        if self.emit == "yuv420":
            y = yuv420_from_planar(y, self.tail_scale, full_range)
        return y


def full_width(shape, dtype: torch.dtype,
               device: torch.device) -> torch.Tensor:
    """A split conv's full-width output on one rank (or a dense block's
    buffer there), uninitialized: its slice is written by the rank's own
    conv, every other channel by :func:`exchange_channels`."""
    return torch.empty(tuple(shape), dtype=dtype, device=device)


def exchange_channels(parts: List[torch.Tensor]) -> None:
    """The all-gather after a split conv: ``parts[r]`` is rank r's
    full-width ``(N, H, W, C)`` output (a tensor, or a channel view of a
    dense block's buffer) in which rank r wrote channels ``[r*C/n,
    (r+1)*C/n)``; every other rank's slice is copied in, so each rank then
    holds the whole output.  ``exchange_channels.bytes`` counts the bytes
    received, ``(n-1)`` times the output's size a call.

    Ordering, from one thread: every rank's work is queued on its device's
    current stream.  A copy between two devices (``Tensor.copy_``) runs on
    the source device's current stream after its device waits on the
    destination's current stream, and the destination's stream then waits
    on the copy.  So the copy reads a slice only after the source rank's
    conv wrote it, writes only after the destination's earlier work, the
    destination's next layer reads it only after it landed, and the
    source's next layer (queued behind the copy on its stream) cannot
    overwrite the slice before it was read.  Between entries of one device
    stream order alone does all of it."""
    n = len(parts)
    c = parts[0].shape[-1] // n
    for r, dst in enumerate(parts):
        for q, src in enumerate(parts):
            if q != r:
                dst[..., q * c:(q + 1) * c].copy_(src[..., q * c:(q + 1) * c])
    exchange_channels.bytes += (n - 1) * parts[0].numel() * parts[0].element_size()


exchange_channels.bytes = 0


class TensorParallelForward(nn.Module):
    """``--parallel tp``: the graph walk of :class:`GraphForward` with each
    conv's output channels split over the devices of a ``tp`` mesh (the
    program GSPMD makes of ``upscale_video_tpu/parallel/tensor.py:23-46``'s
    placement, chain.py:541-559).

    Every activation is replicated: rank r (entry r of the mesh, on
    ``devices[r]``) holds a whole copy of each blob.  A conv whose cout
    divides the mesh size n (the JAX package's placement rule,
    :func:`~upscale_video_tpu_torch.parallel.tensor.shard_params_channelwise`,
    whose per-rank states ``shards`` are) runs on every rank over its slice
    of the weights, writing channels ``[r*C/n, (r+1)*C/n)`` of a full-width
    output on its device; :func:`exchange_channels` then gives every rank
    the other slices before the next layer.

    - The kernel route (``kernels``, :func:`conv_routes`): each SAME 3x3
      conv is one K4 launch per rank, reading the replicated input and
      writing its slice at its offset (``out=``/``out_off``).  No K1 chain
      is planned: a chain holds a whole stack in one launch and tp
      exchanges after every conv.  A dense block keeps
      :func:`_plan_dense_buffers`: each rank holds the block's buffer, and
      each conv's growth slice lands at ``out_off + r*g/n``.  An SRVGG tail
      is one K3 launch, on the first device.
    - ``rdb`` (``--conv_impl rdb``): each matched dense block is one K5
      launch, whole, on every rank.
    - 1x1 convs, and every conv of the aten route, are ``F.conv2d`` on the
      rank's weight slice (:func:`~upscale_video_tpu_torch.models.ops.
      op_convolution`), placed at its offset; a PReLU that alone consumes
      such a conv is applied to its slice.
    - A conv whose cout does not divide n runs whole on every rank; every
      other op runs on every rank (elementwise ops, Interp, the f32 spine
      of ``mixed``).
    - After the last split conv's exchange only rank 0 runs on (the SRVGG
      tail's K3 launch, the last whole convs, the shuffle): the output is
      the first device's.

    ``forward(state, x)``: ``state`` is the model's whole state on
    ``devices[0]`` (the K3 tail reads it); ``x`` is broadcast from the
    first device to every rank.  The output is on ``devices[0]``."""

    def __init__(self, graph: NcnnGraph, devices, shards,
                 compute_dtype: torch.dtype, residual_dtype, emit: str,
                 kernels: bool = True, rdb: bool = False):
        super().__init__()
        self.plan = plan = GraphForward(graph, devices[0], compute_dtype,
                                        residual_dtype, emit, kernels, rdb,
                                        chains=False)
        self.devices = [torch.device(d) for d in devices]
        self.shards = shards
        n = len(self.devices)
        consumers = _consumers(graph)
        self.index = {layer.name: i for i, layer in enumerate(graph.layers)}
        tail_conv = plan.tail["conv"] if plan.tail else None
        # convs the walk runs as generic ops -> the PReLU that alone
        # consumes one (or None), applied to its slice
        self.generic = {
            layer.name: _conv_item(graph, consumers, layer)["prelu"]
            for layer in graph.layers
            if layer.type == "Convolution" and layer.name not in plan.absorbed
            and layer.name not in plan.solos and layer.name != tail_conv}
        self.absorbed = plan.absorbed | {p for p in self.generic.values() if p}
        self.split = {name for name in [*plan.solos, *self.generic]
                      if graph.layers[self.index[name]].attr_i(0) % n == 0}
        self.last_split = max([self.index[name] for name in self.split]
                              or [-1])
        for i, layer in enumerate(graph.layers):
            if (layer.type == "PReLU" and layer.name not in self.absorbed
                    and n > 1 and layer.attr_i(0, 1) % n == 0):
                raise NotImplementedError(
                    f"{layer.name}: a PReLU that no conv alone feeds has no "
                    "whole slope under --parallel tp")
            if layer.name == tail_conv and i <= self.last_split:
                raise NotImplementedError(
                    f"{layer.name}: the SRVGG tail comes before a split conv")

    def forward(self, state, x: torch.Tensor,
                full_range: bool = False) -> torch.Tensor:
        plan = self.plan
        squeeze = x.ndim == 3
        if squeeze:
            x = x[None]
        unpacked = [t for t in plan.rdb_triggers if t not in self.shards[0]]
        if unpacked:
            raise RuntimeError(
                f"{len(unpacked)} dense blocks have no packed K5 weights in "
                f"the shards (first: {unpacked[0]})")
        cd = plan.compute_dtype
        graph = plan.graph
        x, in_hw = plan.pad_input(x.to(self.devices[0]))
        n = len(self.devices)
        blobs = [{graph.input_blobs[0]: x.to(d).to(cd)} for d in self.devices]
        dense_bufs: List[Dict[int, torch.Tensor]] = [{} for _ in range(n)]
        for i, layer in enumerate(graph.layers):
            if layer.type == "Input":
                continue
            ranks = range(n) if i <= self.last_split else range(1)
            name = layer.name
            block = plan.rdb_triggers.get(name)
            if block is not None:
                for r in ranks:
                    pw = self.shards[r][name]
                    blobs[r][block["out"]] = rdb_block(
                        blobs[r][layer.inputs[1]].to(cd).contiguous(),
                        RDBWeights(pw.wpack, pw.bpack, block["slope"],
                                   pw.wpack_sm90))
            elif name in plan.solos:
                self._solo(layer, ranks, blobs, dense_bufs)
            elif plan.tail is not None and name == plan.tail["conv"]:
                tw = state[name]
                blobs[0][plan.tail["out"]] = sr_tail_fused(
                    blobs[0][layer.inputs[0]].to(cd).contiguous(),
                    blobs[0][plan.tail["skip_blob"]].to(cd).contiguous(),
                    tw.wmat, tw.bias, plan.tail["scale"], plan.emit,
                    full_range)
            elif name in self.generic:
                self._generic_conv(layer, ranks, blobs)
            elif name not in self.absorbed:
                for r in ranks:
                    plan.run_op(layer, blobs[r], self.shards[r], dense_bufs[r])
            for r in ranks:
                plan.free(i, layer, blobs[r])
        y = plan.finish(blobs[0][graph.output_blobs[0]], tuple(x.shape[1:3]),
                        in_hw, full_range)
        return y[0] if squeeze else y

    def _solo(self, layer: NcnnLayer, ranks, blobs, dense_bufs) -> None:
        """A K4 conv on every rank in ``ranks``: its slice at its offset of
        a full-width output (or of the dense block's buffer), then the
        exchange; whole where its cout does not divide the mesh."""
        plan, cd = self.plan, self.plan.compute_dtype
        solo = plan.solos[layer.name]
        d = plan.dense.get(layer.name)
        split = layer.name in self.split
        cout = layer.attr_i(0)
        c = cout // len(self.devices) if split else cout
        outs = []
        for r in ranks:
            wmat, bias, slope, act = _solo_args(solo, self.shards[r])
            dst, base = None, 0
            if d is not None:
                if d["first"]:  # the block's input, rounded as .to(cd) does
                    x0 = blobs[r][layer.inputs[0]]
                    buf = full_width((*x0.shape[:3], d["total"]), cd, x0.device)
                    buf[..., :d["cin"]] = x0
                    dense_bufs[r][d["block"]] = buf
                buf = dense_bufs[r][d["block"]]
                src = buf[..., :d["cin"]]
                if d["out_off"] is None:
                    del dense_bufs[r][d["block"]]
                else:
                    dst, base = buf, d["out_off"]
            else:
                src = blobs[r][layer.inputs[0]].to(cd).contiguous()
            if split and dst is None:
                dst = full_width((*src.shape[:3], cout), cd, src.device)
            if dst is None:
                outs.append(conv3x3_fused(src, wmat, bias, slope, act,
                                          out_dtype=cd))
                continue
            conv3x3_fused(src, wmat, bias, slope, act, out_dtype=cd, out=dst,
                          out_off=base + (r * c if split else 0))
            outs.append(dst[..., base:base + cout])
        if split and len(outs) > 1:
            exchange_channels(outs)
        for r, y in zip(ranks, outs):
            blobs[r][solo["out"]] = y

    def _generic_conv(self, layer: NcnnLayer, ranks, blobs) -> None:
        """A conv outside the K4 plan (1x1, strided; every conv of the aten
        route) as ``F.conv2d`` on every rank's weights, its PReLU on the
        slice, the slice placed in a full-width output, then the exchange."""
        plan, cd = self.plan, self.plan.compute_dtype
        prelu = self.generic[layer.name]
        prelu = plan.graph.layers[self.index[prelu]] if prelu else None
        split = layer.name in self.split and len(self.devices) > 1
        cout = layer.attr_i(0)
        c = cout // len(self.devices)
        outs = []
        for r in ranks:
            y = OP_REGISTRY["Convolution"](
                layer, [blobs[r][layer.inputs[0]]], self.shards[r][layer.name], cd)
            if prelu:
                y = OP_REGISTRY["PReLU"](prelu, [y],
                                         self.shards[r][prelu.name], cd)
            if split:
                full = full_width((*y.shape[:3], cout), y.dtype, y.device)
                full[..., r * c:(r + 1) * c] = y
                y = full
            outs.append(y)
        if split:
            exchange_channels(outs)
        out = (prelu or layer).outputs[0]
        for r, y in zip(ranks, outs):
            blobs[r][out] = y


CONV_IMPLS = ("auto", "pallas", "rdb", "xla")


def conv_routes(conv_impl: str, compute_dtype: torch.dtype):
    """``--conv_impl`` -> ``(kernels, rdb)``: whether the conv kernels (K1
    chains, K4 solos and dense buffers, the K2/K3 tails) run, and whether
    K5 takes the Valar dense blocks, as the JAX package reads the flag
    (chain.py:225-237): ``pallas`` is the conv kernels without K5,
    ``rdb`` K5 alone, ``xla`` neither, ``auto`` (the port's product
    route) both.  float32 takes neither, whatever the flag (the kernels
    compute in bf16), with the JAX package's warning when a kernel route
    was asked for (executor.py:1041-1051)."""
    if conv_impl not in CONV_IMPLS:
        raise ValueError(f"conv_impl {conv_impl!r} not in {CONV_IMPLS}")
    if compute_dtype == torch.float32:
        if conv_impl in ("pallas", "rdb"):
            log.warning(
                "precision f32 requested: the CUDA conv kernels compute in "
                "bf16, using the aten conv path (true-f32, TF32 off) instead")
        return False, False
    return conv_impl in ("auto", "pallas"), conv_impl in ("auto", "rdb")


def build_forward(graph: NcnnGraph, device: "torch.device | str",
                  compute_dtype: torch.dtype = torch.bfloat16,
                  emit: str = "model", residual_dtype=None,
                  conv_impl: str = "auto"):
    """Plan ``graph`` and return its forward module: a graph that is one
    conv chain ending in the SRVGG shuffle tail gets :class:`SRVGGForward`
    (K1 then K2), any other :class:`GraphForward` (K5 per Valar dense
    block, K1 per conv chain, K4 per other SAME 3x3 conv, K3 for an SRVGG
    tail, generic ops between); a layer type outside the op set raises.

    ``conv_impl`` picks the kernels (:func:`conv_routes`): without the
    conv kernels every graph takes the graph walk, each conv a generic
    ``F.conv2d`` (the aten route), and without K5 a Valar dense block runs
    its convs on K4 over one shared buffer (``pallas``) or as generic ops.
    ``compute_dtype`` bf16 runs the kernels on CUDA (held to the JAX
    Pallas path); float32 runs the aten route on either device (held to
    the JAX XLA f32 path).  ``residual_dtype=torch.float32`` is
    ``--precision mixed``: the graph walk's Eltwise/BinaryOp adds run in
    f32 (the JAX package gives the 1x anime model the same residual dtype
    under ``-m a,r``, chain.py:248); an SRVGG on K1 + K2 already adds its
    skip in f32 in K2's epilogue, so there mixed computes what bf16 does."""
    device = torch.device(device)
    if compute_dtype not in (torch.bfloat16, torch.float32):
        raise NotImplementedError(f"compute dtype {compute_dtype}")
    kernels, rdb = conv_routes(conv_impl, compute_dtype)
    plan = None
    if kernels and probe_srvgg_tail(graph) is not None:
        try:
            plan = plan_srvgg(graph)
        except NotImplementedError:
            pass  # no single K1 chain: the graph walk, the tail on K3
    if plan is not None:
        return SRVGGForward(plan, device, compute_dtype, emit)
    return GraphForward(graph, device, compute_dtype, residual_dtype, emit,
                        kernels, rdb)
