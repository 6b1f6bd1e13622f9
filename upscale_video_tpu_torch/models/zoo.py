"""Model zoo: resolution, loading, the Compact and RRDBNet architectures, ``Model``.

Port of ``upscale_video_tpu/models/zoo.py:57-193, 196-420``.
``make_srvgg_graph`` and ``make_rrdb_graph`` are host copies (the same
graphs, layer for layer); ``Model`` is an ``nn.Module`` holding its weights
as buffers in the kernels' layout (:func:`params_from_jax`) and its host
weights for :meth:`Model.save`.  The on-disk stem is ``str(scale) +
model_file`` as in the reference.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from upscale_video_tpu_torch.models.bin_loader import (
    emit_bin, load_weights_file, synthesize_weights,
)
from upscale_video_tpu_torch.models.executor import (
    build_forward, probe_srvgg_tail,
)
from upscale_video_tpu_torch.models.param_parser import (
    NcnnGraph, NcnnLayer, emit_param, parse_param_file,
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
    """One ncnn layer's weights as buffers: ``wmat`` (kh*kw*cin, cout) in
    the compute dtype (the kernels' matrix, rows in (dy, dx, cin) order;
    a 1x1 conv's is (cin, cout)) and ``bias`` (cout,) f32 for a conv
    (zeros when the layer has none); ``slope`` (C,) f32 for a PReLU; and,
    added by the RRDBNet forward, a dense block's packed K5 weights
    ``wpack``/``bpack`` (and ``wpack_sm90``, the Hopper kernel's stream,
    for a bf16 pack) under its trigger's name; added by any forward, a
    chain conv's ``wpack_narrow`` (K1's narrow kernel, bf16, its shapes);
    added by the SRVGG forward, its tail conv's ``wpack_tail`` (K2's
    Hopper kernel, bf16, its shapes)."""

    def __init__(self, **tensors: torch.Tensor):
        super().__init__()
        for k, v in tensors.items():
            self.register_buffer(k, v)


def params_from_jax(params: Dict[str, Dict[str, np.ndarray]],
                    device: "torch.device | str",
                    compute_dtype: torch.dtype = torch.bfloat16) -> nn.ModuleDict:
    """The JAX package's params (nested dicts of numpy arrays from
    ``synthesize_weights`` / ``load_weights``: HWIO ``weight``, ``bias``,
    ``slope``; a ConvolutionDepthWise's flat ``weight``; a LayerNorm's
    ``gamma`` and ``beta`` and a MemoryData's ``data``, f32 as they are)
    -> the port's model state on ``device``."""
    state = {}
    for name, p in params.items():
        t = {}
        if "weight" in p:
            w = np.asarray(p["weight"], np.float32)
            if w.ndim == 1:  # ConvolutionDepthWise: ncnn's grouped OIHW
                t["wflat"] = torch.from_numpy(w.copy()).to(
                    device=device, dtype=compute_dtype)
                if "bias" in p:
                    t["bias"] = torch.from_numpy(
                        np.asarray(p["bias"], np.float32).copy()).to(device)
                state[name] = LayerWeights(**t)
                continue
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
        for key in ("slope", "gamma", "beta", "data"):
            if key in p:
                t[key] = torch.from_numpy(
                    np.asarray(p[key], np.float32).copy()).to(device)
        state[name] = LayerWeights(**t)
    return nn.ModuleDict(state)


class Model(nn.Module):
    """A loaded model on one device: an SRVGG with its shuffle tail (K1 +
    K2, or the graph walk with K4 and K3 where its body is no chain), a 1x
    SRVGG (one K1 chain + generic ops) or an RRDBNet (the graph walk: K5
    per Valar dense block, K4 per other 3x3 conv, K1 chains).
    ``residual_dtype=torch.float32`` is ``--precision mixed``: the graph
    walk's residual adds run in f32 (K2's skip add is f32 already).
    ``conv_impl`` is ``--conv_impl``, which its forwards are built for
    (:func:`~upscale_video_tpu_torch.models.executor.conv_routes`).
    ``params`` keeps the host weights (f32 numpy) for :meth:`save`."""

    def __init__(self, name: str, scale: int, graph: NcnnGraph,
                 params: Dict[str, Dict[str, np.ndarray]],
                 device: "torch.device | str",
                 compute_dtype: torch.dtype = torch.bfloat16,
                 residual_dtype: Optional[torch.dtype] = None,
                 conv_impl: str = "auto"):
        super().__init__()
        self.name = name
        self.scale = scale
        self.graph = graph
        self.device = torch.device(device)
        self.compute_dtype = compute_dtype
        self.residual_dtype = residual_dtype
        self.conv_impl = conv_impl
        self.params = params
        self.state = params_from_jax(params, self.device, compute_dtype)
        self._forwards: Dict[str, nn.Module] = {}

    def frames_forward(self, emit: str = "frames") -> nn.Module:
        """The built forward for one output layout (cached).  Building a
        forward packs its K1 chains' narrow-kernel weights into ``state``,
        and an RRDBNet's its dense blocks' K5 weights."""
        if emit not in self._forwards:
            fwd = build_forward(self.graph, self.device, self.compute_dtype,
                                emit, self.residual_dtype, self.conv_impl)
            fwd.prepare(self.state)
            self._forwards[emit] = fwd
        return self._forwards[emit]

    def replicate(self, device: "torch.device | str") -> "Model":
        """This model on ``device``: its weights made there from the host
        copy, and every forward built so far built there too, with its
        packed weight images (a replica of ``--parallel dp|sp``; ``tp``
        slices the weights instead, ``parallel/tensor.py``)."""
        m = Model(self.name, self.scale, self.graph, self.params, device,
                  self.compute_dtype, self.residual_dtype, self.conv_impl)
        for emit in self._forwards:
            m.frames_forward(emit)
        return m

    @property
    def planar_scale(self) -> Optional[int]:
        return probe_srvgg_tail(self.graph)

    def forward(self, x: torch.Tensor, emit: str = "model") -> torch.Tensor:
        """Model-domain float ``(N, H, W, 3)`` -> the ``emit`` layout."""
        return self.frames_forward(emit)(self.state, x)

    def save(self, model_dir: str, stem: Optional[str] = None) -> str:
        """Write the model to ncnn ``.param``/``.bin`` files (fp16 weight
        tag), as the JAX ``Model.save`` does byte for byte.  Returns the
        file stem path."""
        os.makedirs(model_dir, exist_ok=True)
        path = os.path.join(model_dir, stem or self.name)
        host = {name: {k: np.asarray(v, dtype=np.float32) for k, v in p.items()}
                for name, p in self.params.items()}
        with open(path + ".param", "w", encoding="utf-8") as f:
            f.write(emit_param(self.graph))
        with open(path + ".bin", "wb") as f:
            f.write(emit_bin(self.graph, host))
        return path


def load_model(model_file: str, scale: int, device: "torch.device | str",
               model_path: Optional[str] = None,
               compute_dtype: torch.dtype = torch.bfloat16,
               residual_dtype: Optional[torch.dtype] = None,
               conv_impl: str = "auto") -> Model:
    """Load ``{scale}{model_file}.param/.bin`` from a model directory;
    ``model_file`` is a role of :data:`MODEL_FILES` (``"compact"``,
    ``"valar"``, ``"anime"`` at scale 1) or a raw stem suffix."""
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
                 compute_dtype, residual_dtype, conv_impl)


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
    residual_dtype: Optional[torch.dtype] = None,
    conv_impl: str = "auto",
) -> Model:
    """A Compact-architecture model with random weights (the JAX
    ``make_synthetic_model``'s graph and, byte for byte, its weights).
    ``scale=1, num_conv=8, num_feat=24`` stands in for the anime deblur
    model (the JAX chain's synthetic ``a`` stage, chain.py:241)."""
    graph = make_srvgg_graph(scale=scale, num_conv=num_conv, num_feat=num_feat)
    params = synthesize_weights(graph, seed=seed)
    return Model(f"synthetic_{scale}x_compact", scale, graph, params, device,
                 compute_dtype, residual_dtype, conv_impl)


def make_rrdb_graph(
    scale: int = 4,
    num_feat: int = 64,
    num_grow: int = 32,
    num_rrdb: int = 2,
    variant: str = "valar",
    unshuffle: int = 1,
) -> NcnnGraph:
    """RRDBNet graph (host copy of the JAX zoo's, zoo.py:248).

    ``variant="valar"`` mirrors ``4x_Valar_v1.param``: ``num_rrdb`` RRDBs
    of 3 dense blocks (5 dense 3x3 convs over growing concats, a 1x1 skip
    into c2, c2 re-added into c4, residual scale 0.2), trunk conv + global
    skip, then nearest-2x + conv upsampling to ``scale``.  ``num_rrdb=23``
    is layer-count and FLOP-identical to the real Valar graph (modulo
    ncnn Split bookkeeping).  ``variant="esrgan"`` is basicsr's plain
    RRDBNet (no 1x1 skip, no interior adds): the RealESRGAN_x4plus family
    that ``vsr-import-torch`` converts.  ``unshuffle > 1`` prepends a Reorg
    of that stride (basicsr's x2/x1 variants); the model's net scale is
    then ``scale / unshuffle``."""
    if variant not in ("valar", "esrgan"):
        raise ValueError(f"unknown RRDB variant {variant!r}")
    layers = [NcnnLayer("Input", "input", [], ["input"])]
    uid = [0]

    def blob():
        out = f"b{uid[0]}"
        uid[0] += 1
        return out

    def conv(name, src, cin, cout, k=3, act=None):
        # real graph: 3x3 convs carry bias (5=1), the 1x1 skips do not
        attrs = {0: cout, 1: k, 6: cout * cin * k * k}
        if k == 3:
            attrs[4] = 1
            attrs[5] = 1
        if act is not None:
            attrs[9] = 2
            attrs[10] = [act]
        out = blob()
        layers.append(NcnnLayer("Convolution", name, [src], [out], attrs))
        return out

    def cat(name, srcs):
        out = blob()
        layers.append(NcnnLayer("Concat", name, list(srcs), [out], {0: 0}))
        return out

    def add(name, a, b):
        out = blob()
        layers.append(NcnnLayer("BinaryOp", name, [a, b], [out], {0: 0}))
        return out

    def residual(name, body, skip):  # 0.2*body + skip
        out = blob()
        layers.append(NcnnLayer(
            "Eltwise", name, [body, skip], [out], {0: 1, 1: [0.2, 1.0]}
        ))
        return out

    def rdb_valar(tag, x0):
        x1 = conv(f"{tag}_c1", x0, num_feat, num_grow, act=0.2)
        c4 = conv(f"{tag}_c4", cat(f"{tag}_cat1", [x0, x1]),
                  num_feat + num_grow, num_grow, act=0.2)
        sk = conv(f"{tag}_c6", x0, num_feat, num_grow, k=1)
        x2 = add(f"{tag}_a7", c4, sk)
        x3 = conv(f"{tag}_c9", cat(f"{tag}_cat2", [x0, x1, x2]),
                  num_feat + 2 * num_grow, num_grow, act=0.2)
        c12 = conv(f"{tag}_c12", cat(f"{tag}_cat3", [x0, x1, x2, x3]),
                   num_feat + 3 * num_grow, num_grow, act=0.2)
        x4 = add(f"{tag}_a14", c12, x2)
        c16 = conv(f"{tag}_c16", cat(f"{tag}_cat4", [x0, x1, x2, x3, x4]),
                   num_feat + 4 * num_grow, num_feat)
        return residual(f"{tag}_res", c16, x0)

    def rdb_esrgan(tag, x0):
        feats = [x0]
        for k in range(1, 5):
            nxt = conv(
                f"{tag}_c{k}",
                feats[0] if k == 1 else cat(f"{tag}_cat{k - 1}", feats),
                num_feat + (k - 1) * num_grow, num_grow, act=0.2,
            )
            feats.append(nxt)
        x5 = conv(f"{tag}_c5", cat(f"{tag}_cat4", feats),
                  num_feat + 4 * num_grow, num_feat)
        return residual(f"{tag}_res", x5, x0)

    rdb = rdb_valar if variant == "valar" else rdb_esrgan

    first_in = "input"
    if unshuffle > 1:
        layers.append(NcnnLayer(
            "Reorg", "unshuffle", ["input"], ["unshuffled"], {0: unshuffle}
        ))
        first_in = "unshuffled"
    fea = conv("conv_first", first_in, 3 * unshuffle * unshuffle, num_feat)
    x = fea
    for i in range(num_rrdb):
        rin = x
        for j in range(3):
            x = rdb(f"r{i}d{j}", x)
        x = residual(f"r{i}_res", x, rin)
    trunk = conv("conv_trunk", x, num_feat, num_feat)
    x = add("trunk_add", fea, trunk)
    ups = 1
    while ups < scale:
        out = blob()
        layers.append(NcnnLayer(
            "Interp", f"up{ups}", [x], [out], {0: 1, 1: 2.0, 2: 2.0}
        ))
        x = conv(f"conv_up{ups}", out, num_feat, num_feat, act=0.2)
        ups *= 2
    x = conv("conv_hr", x, num_feat, num_feat, act=0.2)
    conv("conv_last", x, num_feat, 3)
    layers[-1].outputs[0] = "output"
    blob_count = len({b for l in layers for b in l.outputs})
    return NcnnGraph(layers=layers, blob_count=blob_count)


def make_synthetic_rrdb_model(
    scale: int = 4,
    num_feat: int = 64,
    num_grow: int = 32,
    num_rrdb: int = 2,
    seed: int = 0,
    device: "torch.device | str" = "cpu",
    compute_dtype: torch.dtype = torch.bfloat16,
    residual_dtype: Optional[torch.dtype] = None,
    variant: str = "valar",
    conv_impl: str = "auto",
) -> Model:
    """An RRDBNet model with random weights: for the ``valar`` variant the
    JAX ``make_synthetic_rrdb_model``'s graph and, byte for byte, its
    weights; ``variant="esrgan"`` gives basicsr's plain RRDBNet."""
    graph = make_rrdb_graph(scale=scale, num_feat=num_feat,
                            num_grow=num_grow, num_rrdb=num_rrdb,
                            variant=variant)
    params = synthesize_weights(graph, seed=seed)
    return Model(f"synthetic_{scale}x_rrdb{num_rrdb}", scale, graph, params,
                 device, compute_dtype, residual_dtype, conv_impl)


def make_swinir_graph(
    scale: int = 4,
    embed_dim: int = 240,
    depths=(6,) * 9,
    num_heads=(8,) * 9,
    window_size: int = 8,
    mlp_ratio: float = 2.0,
    num_feat: int = 64,
    in_ch: int = 3,
    out_ch: int = 3,
) -> NcnnGraph:
    """SwinIR (``JingyunLiang/SwinIR`` ``models/network_swinir.py``) with
    ``resi_connection='3conv'`` and ``upsampler='nearest+conv'``, the
    real-world SR models' form, as an ncnn graph in the port's dialect
    (``models/param_parser.py``).  The defaults are SwinIR-L's
    (``003_realSR_BSRGAN_DFOWMFC_s64w8_SwinIR-L_x4_GAN``).  The layer
    names follow the state dict's (``l{i}b{j}_qkv`` for
    ``layers.{i}.residual_group.blocks.{j}.attn.qkv``); the benchmark's
    ``port_bench/models/swinir.py:layers`` writes the same graph.

    - ``mean`` (MemoryData, the RGB mean, 3 values) is subtracted from the
      input and added to the output; ``conv_first`` (3x3) embeds.
    - A token norm is ``Permute(3) -> LayerNorm(eps 1e-5) -> Permute(4)``.
    - Each Swin block: norm1, ``qkv`` (1x1 conv), its bias table
      (MemoryData ``((2w-1)^2, heads)``), ``WindowAttention`` (shift
      ``window // 2`` on odd blocks), ``proj`` (1x1), add; norm2, ``fc1``
      (1x1), GELU (exact), ``fc2`` (1x1), add.
    - Each RSTB: its blocks, then 3x3 conv to ``dim/4`` + leaky 0.2, 1x1 +
      leaky 0.2, 3x3 conv back to ``dim``, add the RSTB's input.
    - Then the final norm, ``after_body`` (the same three convs), add the
      embedding, ``conv_before_upsample`` (3x3 + leaky 0.01), nearest 2x
      + ``conv_up1`` (+ leaky 0.2; and ``conv_up2`` at 4x), ``conv_hr`` (+
      leaky 0.2), ``conv_last``, add the mean."""
    if scale not in (2, 4):
        raise ValueError(f"SwinIR nearest+conv upsamples 2x or 4x, not {scale}x")
    layers = [NcnnLayer("Input", "input", [], ["input"]),
              NcnnLayer("MemoryData", "mean", [], ["mean"], {0: in_ch}),
              NcnnLayer("BinaryOp", "sub_mean", ["input", "mean"], ["x0"],
                        {0: 1})]

    def add(kind, name, srcs, attrs=None):
        layers.append(NcnnLayer(kind, name, list(srcs), [name],
                                dict(attrs or {})))
        return name

    def conv(name, src, cin, cout, k=3, slope=None):
        attrs = {0: cout, 1: k, 5: 1, 6: cout * cin * k * k}
        if k == 3:
            attrs[4] = 1
        if slope is not None:
            attrs[9] = 2
            attrs[10] = [slope]
        return add("Convolution", name, [src], attrs)

    def norm(name, src):
        t = add("Permute", f"{name}_tok", [src], {0: 3})
        t = add("LayerNorm", name, [t], {0: embed_dim, 1: 1e-5, 2: 1})
        return add("Permute", f"{name}_map", [t], {0: 4})

    def three_conv(tag, src):
        q = embed_dim // 4
        y = conv(f"{tag}0", src, embed_dim, q, slope=0.2)
        y = conv(f"{tag}2", y, q, q, k=1, slope=0.2)
        return conv(f"{tag}4", y, q, embed_dim)

    feat = conv("conv_first", "x0", in_ch, embed_dim)
    t = norm("patch_norm", feat)
    hidden = int(embed_dim * mlp_ratio)
    table = (2 * window_size - 1) ** 2
    for i, (depth, heads) in enumerate(zip(depths, num_heads)):
        rin = t
        for j in range(depth):
            tag = f"l{i}b{j}"
            qkv = conv(f"{tag}_qkv", norm(f"{tag}_norm1", t), embed_dim,
                       3 * embed_dim, k=1)
            tb = add("MemoryData", f"{tag}_table", [], {0: heads, 1: table})
            a = add("WindowAttention", f"{tag}_attn", [qkv, tb],
                    {0: heads, 1: window_size,
                     2: window_size // 2 if j % 2 else 0})
            t = add("BinaryOp", f"{tag}_add1",
                    [t, conv(f"{tag}_proj", a, embed_dim, embed_dim, k=1)],
                    {0: 0})
            h = conv(f"{tag}_fc1", norm(f"{tag}_norm2", t), embed_dim,
                     hidden, k=1)
            h = conv(f"{tag}_fc2", add("GELU", f"{tag}_gelu", [h]), hidden,
                     embed_dim, k=1)
            t = add("BinaryOp", f"{tag}_add2", [t, h], {0: 0})
        t = add("BinaryOp", f"l{i}_add", [three_conv(f"l{i}_conv", t), rin],
                {0: 0})
    y = add("BinaryOp", "body_add",
            [three_conv("after_body", norm("norm", t)), feat], {0: 0})
    y = conv("conv_before_upsample", y, embed_dim, num_feat, slope=0.01)
    for k in range(1, 2 if scale == 2 else 3):
        y = add("Interp", f"up{k}", [y], {0: 1, 1: 2.0, 2: 2.0})
        y = conv(f"conv_up{k}", y, num_feat, num_feat, slope=0.2)
    y = conv("conv_hr", y, num_feat, num_feat, slope=0.2)
    y = conv("conv_last", y, num_feat, out_ch)
    layers.append(NcnnLayer("BinaryOp", "add_mean", [y, "mean"], ["output"],
                            {0: 0}))
    blob_count = len({b for l in layers for b in l.outputs})
    return NcnnGraph(layers=layers, blob_count=blob_count)
