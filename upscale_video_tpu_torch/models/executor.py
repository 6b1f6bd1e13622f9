"""Graph planners + forward modules: the SRVGG (Compact) family with its
shuffle tail, and the graph walk for everything else (the RRDBNet / Valar
family, and the 1x SRVGG anime deblur model).

SRVGG: port of the parts of ``upscale_video_tpu/models/executor.py`` that
the Compact graph reaches with ``--conv_impl pallas``: ``_match_srvgg_tail``
(:884), ``probe_srvgg_tail`` (:935) and the chain assembly
(``_plan_pallas_fusion`` / ``_assemble_chains``, :705-881).  In the port
this plan is the only one for the family: the whole body becomes one
bordered conv chain (kernel K1, :mod:`upscale_video_tpu_torch.ops.conv_chain`)
and the tail one fused tail launch (kernel K2,
:mod:`upscale_video_tpu_torch.ops.tail`).  The JAX planner's TPU lane gate
(``_pallas_fusable``'s ``cin >= 32``, executor.py:723-730) is not copied.

Graph walk: port of ``_plan_rdb_blocks`` (:539-702, with
``_dense_conv_class`` :383), of the bordered-chain assembly
(``_assemble_chains`` :814) and of ``build_forward``'s graph walk
(:1001-1570) for the generic ops in
:mod:`upscale_video_tpu_torch.models.ops`: every matched dense block is
one K5 launch (:mod:`upscale_video_tpu_torch.ops.rdb`), every run of two or
more linearly linked SAME 3x3 convs one K1 chain, every other layer one
op; blobs are freed at their last use, and ``mixed`` keeps the residual
spine (Eltwise/BinaryOp) in f32.  A 1x SRVGG graph (``PixelShuffle(1)``,
``Interp(1)``: no tail for K2) is one K1 chain plus three generic ops.

A layer type outside the op set raises ``NotImplementedError``; nothing
falls back.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
from torch import nn

from upscale_video_tpu_torch.models.bin_loader import _infer_conv_in_channels
from upscale_video_tpu_torch.models.ops import OP_REGISTRY, conv_geometry
from upscale_video_tpu_torch.models.param_parser import NcnnGraph, NcnnLayer
from upscale_video_tpu_torch.ops.common import (
    ACT_LEAKY, ACT_NONE, ACT_PRELU, ACT_RELU,
)
from upscale_video_tpu_torch.ops.conv_chain import ChainLayer, conv3x3_chain
from upscale_video_tpu_torch.ops.pixel import model_to_frames
from upscale_video_tpu_torch.ops.rdb import RDBWeights, pack_rdb_weights, rdb_block
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
        layers.append(ChainLayer(lw.wmat, lw.bias, slope, act))
    return layers


def _plan_chains(graph: NcnnGraph, consumers: Dict[str, List[int]],
                 exclude=frozenset()):
    """Maximal runs of two or more linearly linked chain-eligible convs,
    each conv with no fused activation absorbing a PReLU that alone
    consumes it (``_plan_pallas_fusion`` + ``_assemble_chains``,
    executor.py:757-864, without the solo-conv plans).  Returns ``({first
    conv name: {"items", "out"}}, absorbed layer names)``; ``exclude``
    holds convs another plan claims."""
    links = {}  # conv name -> (chain item, blob the item ends in)
    for layer in graph.layers:
        if (layer.type != "Convolution" or layer.name in exclude
                or not _chain_eligible(layer)):
            continue
        item = {"name": layer.name, "prelu": None, "act": layer.attr_i(9, 0),
                "slope_attr": layer.attr(10, [0.0])}
        out = layer.outputs[0]
        cons = consumers.get(out, [])
        if item["act"] == 0 and len(cons) == 1 \
                and graph.layers[cons[0]].type == "PReLU":
            item["prelu"] = graph.layers[cons[0]].name
            out = graph.layers[cons[0]].outputs[0]
        links[layer.name] = (item, out)
    chains: Dict[str, dict] = {}
    absorbed: set = set()
    used: set = set()
    for layer in graph.layers:
        if layer.name not in links or layer.name in used:
            continue
        seq = [layer.name]
        while True:
            cons = consumers.get(links[seq[-1]][1], [])
            if len(cons) != 1:
                break
            nxt = graph.layers[cons[0]].name
            if nxt not in links or nxt in used or nxt in seq:
                break
            seq.append(nxt)
        if len(seq) < 2:
            continue
        items = [links[n][0] for n in seq]
        chains[seq[0]] = {"items": items, "out": links[seq[-1]][1]}
        used.update(seq)
        absorbed.update(seq[1:])
        absorbed.update(it["prelu"] for it in items if it["prelu"])
    return chains, absorbed


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

    def forward(self, state, x: torch.Tensor) -> torch.Tensor:
        squeeze = x.ndim == 3
        if squeeze:
            x = x[None]
        # the skip reads the input rounded to the compute dtype, as the
        # JAX executor's blobs[input] = x.astype(compute_dtype)
        x = x.to(device=self.device, dtype=self.compute_dtype).contiguous()
        buf = conv3x3_chain(x, chain_layers(self.items, state), crop=False)
        tw = state[self.tail["conv"]]
        y = sr_tail_chain(buf, x, tw.wmat, tw.bias, self.scale, self.emit)
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
    producers: Dict[str, int] = {}
    by_name: Dict[str, NcnnLayer] = {}
    for i, layer in enumerate(graph.layers):
        by_name[layer.name] = layer
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

    def producer(blob):
        pi = producers.get(root_of(blob))
        return graph.layers[pi] if pi is not None else None

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
            graph.layers[ci].name not in block_names
            and graph.layers[ci].name not in splits
            for b in interior
            for ci in consumers.get(b, [])
        )
        if leaked:
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


class GraphForward(nn.Module):
    """Stateless forward of a graph without the SRVGG shuffle tail (the
    RRDBNet / Valar family, the 1x SRVGG anime model): ``fwd(state, x)``
    walks the layers in order, as the JAX ``build_forward`` does.

    - Every run of two or more linearly linked SAME 3x3 convs (with their
      PReLUs) is one K1 chain over the run's input cast to the compute
      dtype (:func:`_plan_chains`; on the CPU K1's plain version, in the
      compute dtype).  The 1x anime model's whole conv stack is one chain;
      its ``PixelShuffle(1)``, ``Interp(1)`` and skip add run as generic ops.
    - Under a bf16 compute dtype every matched dense block is one K5
      launch on the block's input cast to bf16; its output comes back in
      bf16.  Its packed weights live in ``state`` under the trigger's name,
      put there once by :meth:`prepare`.  Under f32 (the CPU parity path) the blocks run as
      generic ops, as the JAX package's f32 path does.
    - ``residual_dtype=torch.float32`` with bf16 compute is ``mixed``: the
      inputs of every Eltwise and BinaryOp are upcast to f32 and their
      results flow on in f32 (``_spine_cast``, executor.py:1214); the next
      conv or dense block rounds its own input to bf16.
    - The JAX executor's canvas-eltwise branch (executor.py:1492) needs a
      canvas on every combine operand; an RRDB's skip operand never has
      one, so on the Valar graph every combine takes the generic path,
      which is the one ported (pinned by tests/test_torch_valar.py).

    ``x``: model-domain ``(N, H, W, 3)`` (BGR, [0, 1]).  ``emit="model"``
    returns float32 ``(N, sH, sW, 3)``; ``"frames"`` uint8 RGB.
    """

    EMITS = ("model", "frames")

    def __init__(self, graph: NcnnGraph, device: torch.device,
                 compute_dtype: torch.dtype, residual_dtype, emit: str):
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
        blocks, absorbed = _plan_rdb_blocks(graph, consumers)
        self.chains, self.chain_absorbed = _plan_chains(graph, consumers,
                                                        absorbed)
        self.graph = graph
        self.device = torch.device(device)
        self.compute_dtype = compute_dtype
        self.emit = emit
        self.residual_f32 = (residual_dtype == torch.float32
                             and compute_dtype != torch.float32)
        fused = compute_dtype != torch.float32
        self.rdb_triggers = {b["trigger"]: b for b in blocks} if fused else {}
        self.rdb_absorbed = absorbed if fused else set()
        self.last_use: Dict[str, int] = {}
        for i, layer in enumerate(graph.layers):
            for b in layer.inputs:
                self.last_use[b] = i

    def prepare(self, state: nn.ModuleDict) -> None:
        """Add each dense block's packed K5 weights to ``state`` under its
        trigger's name (the trigger Eltwise has no weights of its own).
        Called at plan time (``Model.frames_forward``), where a second
        layout's forward finds them packed; :meth:`forward` only reads them."""
        from upscale_video_tpu_torch.models.zoo import LayerWeights

        for name, block in self.rdb_triggers.items():
            if name in state:
                continue
            cv = [state[c] for c in block["convs"]]
            sk = state[block["skip_conv"]]
            rw = pack_rdb_weights([c.wmat for c in cv], [c.bias for c in cv],
                                  sk.wmat, sk.bias, block["slope"],
                                  dtype=self.compute_dtype, device=self.device)
            state[name] = LayerWeights(wpack=rw.wpack, bpack=rw.bpack)

    def forward(self, state, x: torch.Tensor) -> torch.Tensor:
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
        blobs: Dict[str, torch.Tensor] = {
            graph.input_blobs[0]: x.to(device=self.device, dtype=cd)}

        def free(i, layer):
            for b in layer.inputs:
                if self.last_use.get(b) == i and b in blobs:
                    del blobs[b]

        for i, layer in enumerate(graph.layers):
            if layer.type == "Input":
                continue
            block = self.rdb_triggers.get(layer.name)
            if block is not None:
                pw = state[layer.name]
                blobs[block["out"]] = rdb_block(
                    blobs[layer.inputs[1]].to(cd).contiguous(),
                    RDBWeights(pw.wpack, pw.bpack, block["slope"]))
                free(i, layer)
                continue
            chain = self.chains.get(layer.name)
            if chain is not None:
                blobs[chain["out"]] = conv3x3_chain(
                    blobs[layer.inputs[0]].to(cd).contiguous(),
                    chain_layers(chain["items"], state))
                free(i, layer)
                continue
            if layer.name in self.rdb_absorbed or \
                    layer.name in self.chain_absorbed:
                free(i, layer)
                continue
            ins = [blobs[b] for b in layer.inputs]
            if self.residual_f32 and layer.type in ("Eltwise", "BinaryOp"):
                ins = [t.to(torch.float32) if t.is_floating_point() else t
                       for t in ins]
            p = state[layer.name] if layer.name in state else None
            out = OP_REGISTRY[layer.type](layer, ins, p, cd)
            if isinstance(out, list):
                for name, t in zip(layer.outputs, out):
                    blobs[name] = t
            else:
                blobs[layer.outputs[0]] = out
            free(i, layer)
        y = blobs[graph.output_blobs[0]].to(torch.float32)
        if self.emit == "frames":
            y = model_to_frames(y)
        return y[0] if squeeze else y


def build_forward(graph: NcnnGraph, device: "torch.device | str",
                  compute_dtype: torch.dtype = torch.bfloat16,
                  emit: str = "model", residual_dtype=None):
    """Plan ``graph`` and return its forward module: a graph ending in the
    SRVGG shuffle tail gets :class:`SRVGGForward` (K1 then K2), any other
    :class:`GraphForward` (K5 per Valar dense block, K1 per conv chain,
    generic ops between); a layer type outside the op set raises.

    ``compute_dtype`` bf16 runs the kernels on CUDA (held to the JAX
    Pallas path); float32 is accepted only on the CPU, where the plain
    versions and generic ops run (held to the JAX XLA f32 path).
    ``residual_dtype=torch.float32`` is ``--precision mixed`` and applies
    to :class:`GraphForward` only: its Eltwise/BinaryOp adds run in f32
    (the JAX package gives the 1x anime model the same residual dtype
    under ``-m a,r``, chain.py:248)."""
    device = torch.device(device)
    if compute_dtype not in (torch.bfloat16, torch.float32):
        raise NotImplementedError(f"compute dtype {compute_dtype}")
    if device.type == "cuda" and compute_dtype != torch.bfloat16:
        raise NotImplementedError(
            "the CUDA kernels compute in bf16; float32 runs on the CPU only")
    if probe_srvgg_tail(graph) is not None:
        if residual_dtype is not None:
            raise NotImplementedError(
                "--precision mixed is ported for graphs without the "
                "SRVGG shuffle tail only (-m r and its pre-SR stages)")
        return SRVGGForward(plan_srvgg(graph), device, compute_dtype, emit)
    return GraphForward(graph, device, compute_dtype, residual_dtype, emit)
