"""Import torch ``.pth`` checkpoints (Real-ESRGAN ecosystem) as Models.

Port of ``upscale_video_tpu/models/torch_import.py``: the same key
detection, old-ESRGAN key translation, BGR folds and graphs, building the
port's :class:`~upscale_video_tpu_torch.models.zoo.Model`, whose
:meth:`~upscale_video_tpu_torch.models.zoo.Model.save` writes the same
``.param``/``.bin`` bytes as the JAX package's (``vsr-import-torch``).

Supported architectures (detected from state_dict keys):

- **SRVGGNetCompact** (``body.{2i}``/``body.{2i+1}`` conv/PReLU pairs +
  final conv + PixelShuffle + nearest skip) at any width: the Compact
  family, ``realesr-animevideov3.pth`` and its kin.
- **SwinIR** (``JingyunLiang/SwinIR`` naming: ``conv_first``,
  ``patch_embed.norm``, ``layers.{i}.residual_group.blocks.{j}.{norm1,
  attn.qkv, attn.relative_position_bias_table, attn.proj, norm2, mlp.fc1,
  mlp.fc2}``, ``layers.{i}.conv.{0,2,4}``, ``norm``, ``conv_after_body
  .{0,2,4}``, ``conv_before_upsample.0``, ``conv_up1/2``, ``conv_hr``,
  ``conv_last``) with ``resi_connection='3conv'`` and ``upsampler=
  'nearest+conv'``, the real-world SR models (SwinIR-L x4 among them), as
  ``make_swinir_graph``'s graph; the ``attn_mask`` and
  ``relative_position_index`` buffers are not weights (the graph walk
  computes both), and the RGB mean, an attribute outside the state dict,
  is SwinIR's ``(0.4488, 0.4371, 0.4040)``.
- **RRDBNet** (basicsr naming: ``conv_first``, ``body.{i}.rdb{j}.conv{k}``,
  ``conv_body``, ``conv_up1/2``, ``conv_hr``, ``conv_last``), e.g.
  ``RealESRGAN_x4plus.pth``, including the pixel-unshuffle x2/x1 variants
  (12/48-channel ``conv_first``), which map onto a Reorg layer run in torch
  ``pixel_unshuffle`` channel order; and old-architecture ESRGAN keys
  (``model.1.sub.N.RDBx``), translated to basicsr's.

Channel domain: torch checkpoints are trained on RGB tensors, while the
model domain is BGR (ncnn ``from_pixels(PIXEL_BGR)``).  The import folds
the swap into the weights: the first conv's input channels and the last
conv's output channels (per PixelShuffle block of ``r*r`` for SRVGG) are
permuted, so the model equals the torch forward under the BGR<->RGB flip
(SwinIR's mean too).
"""

from __future__ import annotations

import logging
import math
import os
import re
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from upscale_video_tpu_torch.models.zoo import (
    Model, make_rrdb_graph, make_srvgg_graph, make_swinir_graph,
)

log = logging.getLogger(__name__)

_BGR = [2, 1, 0]


def _extract_state_dict(obj) -> Dict[str, "np.ndarray"]:
    """Unwrap the common checkpoint containers and strip DataParallel
    prefixes; values are converted to float32 numpy."""
    sd = obj
    for key in ("params_ema", "params", "state_dict", "model_state_dict"):
        if isinstance(sd, dict) and key in sd and isinstance(sd[key], dict):
            sd = sd[key]
            break
    if not isinstance(sd, dict) or not sd:
        raise ValueError("checkpoint does not contain a state_dict")
    out = {}
    for k, v in sd.items():
        if k.startswith("module."):
            k = k[len("module."):]
        if hasattr(v, "detach"):  # torch.Tensor
            v = v.detach().cpu().float().numpy()
        out[k] = np.asarray(v, dtype=np.float32)
    return out


def _oihw_to_hwio(w: np.ndarray) -> np.ndarray:
    if w.ndim != 4:
        raise ValueError(f"expected 4-D conv weight, got shape {w.shape}")
    return np.ascontiguousarray(w.transpose(2, 3, 1, 0))


_OLD_ESRGAN_RE = re.compile(
    r"model\.1\.sub\.(\d+)\.RDB(\d)\.conv(\d)\.0\.(weight|bias)$"
)


def _translate_old_esrgan(sd: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Old-architecture ESRGAN naming (pre-basicsr: ``model.0``,
    ``model.1.sub.N.RDB{j}.conv{k}.0``, ``model.3/6/8/10``) -> basicsr
    RRDBNet keys.  The structure is identical (vanilla 5-conv dense
    blocks, x4 nearest+conv upsampling), only the registry names differ —
    most community 4x models on the upscale wikis still ship this form."""
    out: Dict[str, np.ndarray] = {}
    trunk_idx = 1 + max(int(m.group(1)) for k in sd
                        if (m := _OLD_ESRGAN_RE.match(k)))
    fixed = {
        "model.0": "conv_first",
        f"model.1.sub.{trunk_idx}": "conv_body",
        "model.3": "conv_up1",
        "model.6": "conv_up2",
        "model.8": "conv_hr",
        "model.10": "conv_last",
    }
    for k, v in sd.items():
        m = _OLD_ESRGAN_RE.match(k)
        if m:
            i, j, c, wb = m.groups()
            out[f"body.{i}.rdb{j}.conv{c}.{wb}"] = v
            continue
        stem, wb = k.rsplit(".", 1)
        if stem in fixed and wb in ("weight", "bias"):
            out[f"{fixed[stem]}.{wb}"] = v
            continue
        raise ValueError(f"unrecognized old-ESRGAN key {k!r}")
    return out


_SWIN_TABLE_RE = re.compile(
    r"layers\.(\d+)\.residual_group\.blocks\.(\d+)\.attn\."
    r"relative_position_bias_table$")
SWINIR_RGB_MEAN = (0.4488, 0.4371, 0.4040)  # network_swinir.py, 3 channels


def detect_arch(sd: Dict[str, np.ndarray]) -> str:
    if any(_SWIN_TABLE_RE.match(k) for k in sd):
        return "swinir"
    if any(re.match(r"body\.\d+\.rdb\d\.conv\d\.weight$", k) for k in sd):
        return "rrdb"
    if any(_OLD_ESRGAN_RE.match(k) for k in sd):
        return "rrdb_old"
    if "body.0.weight" in sd and "body.1.weight" in sd:
        return "srvgg"
    raise ValueError(
        "unrecognized checkpoint: expected SRVGGNetCompact (body.N conv/"
        "PReLU pairs), basicsr RRDBNet (body.N.rdbM.convK), old-arch "
        "ESRGAN (model.1.sub.N.RDBx) or SwinIR (layers.N.residual_group."
        f"blocks.M.attn...) keys; got {sorted(sd)[:8]}..."
    )


def _fold_bgr_first(w: np.ndarray, block: int = 1) -> np.ndarray:
    """Swap the input-channel order (HWIO axis 2) of the first conv, in
    ``block``-sized groups (block = r*r after a Reorg/pixel-unshuffle,
    whose channel order is c*r*r + i*r + j)."""
    if w.shape[2] != 3 * block:
        raise ValueError(
            f"first conv takes {w.shape[2]} input channels, "
            f"expected {3 * block}"
        )
    perm = np.concatenate([np.arange(c * block, (c + 1) * block) for c in _BGR])
    return w[:, :, perm, :]


def _fold_bgr_last(w: np.ndarray, b: Optional[np.ndarray], block: int):
    """Permute the output channels (HWIO axis 3) in ``block``-sized groups
    (block = r*r before a PixelShuffle, 1 for a direct 3-channel conv)."""
    perm = np.concatenate([np.arange(c * block, (c + 1) * block) for c in _BGR])
    return w[:, :, :, perm], (None if b is None else b[perm])


def _import_srvgg(sd: Dict[str, np.ndarray], compute_dtype, device) -> Model:
    conv_idx = sorted(
        int(m.group(1)) for k in sd
        if (m := re.match(r"body\.(\d+)\.weight$", k)) and sd[k].ndim == 4
    )
    prelu_idx = sorted(
        int(m.group(1)) for k in sd
        if (m := re.match(r"body\.(\d+)\.weight$", k)) and sd[k].ndim == 1
    )
    if not conv_idx or conv_idx != [*range(0, 2 * len(prelu_idx), 2),
                                    2 * len(prelu_idx)]:
        raise ValueError(
            f"unexpected SRVGG body layout: convs at {conv_idx}, "
            f"activations at {prelu_idx}"
        )
    last = conv_idx[-1]
    num_feat = int(sd["body.0.weight"].shape[0])
    in_ch = int(sd["body.0.weight"].shape[1])
    out_total = int(sd[f"body.{last}.weight"].shape[0])
    out_ch = 3
    s2, rem = divmod(out_total, out_ch)
    scale = math.isqrt(s2)
    if in_ch != 3 or rem or scale * scale != s2:
        raise ValueError(
            f"cannot infer scale from SRVGG tail conv ({in_ch} in, "
            f"{out_total} out)"
        )
    num_conv = len(prelu_idx) - 1  # make_srvgg_graph emits num_conv+1 pairs
    graph = make_srvgg_graph(scale=scale, num_conv=num_conv,
                             num_feat=num_feat)

    params: Dict[str, Dict[str, Any]] = {}
    for i, idx in enumerate(conv_idx[:-1]):
        w = _oihw_to_hwio(sd[f"body.{idx}.weight"])
        if i == 0:
            w = _fold_bgr_first(w)
        params[f"conv_{i}"] = {"weight": w, "bias": sd[f"body.{idx}.bias"]}
        params[f"prelu_{i}"] = {"slope": sd[f"body.{idx + 1}.weight"]}
    w, b = _fold_bgr_last(
        _oihw_to_hwio(sd[f"body.{last}.weight"]), sd[f"body.{last}.bias"],
        block=scale * scale,
    )
    params["conv_up"] = {"weight": w, "bias": b}
    return Model(
        name=f"{scale}x_torch_srvgg", scale=scale, graph=graph,
        params=params, device=device, compute_dtype=compute_dtype,
    )


def _import_rrdb(sd: Dict[str, np.ndarray], compute_dtype, device) -> Model:
    num_rrdb = 1 + max(
        int(m.group(1)) for k in sd
        if (m := re.match(r"body\.(\d+)\.rdb", k))
    )
    num_feat = int(sd["conv_first.weight"].shape[0])
    num_grow = int(sd["body.0.rdb1.conv1.weight"].shape[0])
    in_ch = int(sd["conv_first.weight"].shape[1])
    # basicsr's x2/x1 variants pixel-unshuffle the input before conv_first
    # (12 = 3*2*2 channels, 48 = 3*4*4); the graph gets a Reorg layer and
    # the net scale is the upsampler's 4x divided by the unshuffle stride
    unshuffle = {3: 1, 12: 2, 48: 4}.get(in_ch)
    if unshuffle is None:
        raise ValueError(
            f"conv_first takes {in_ch} input channels — expected 3 "
            "(or 12/48 for the pixel-unshuffle x2/x1 variants)"
        )
    ups = sorted(
        int(m.group(1)) for k in sd if (m := re.match(r"conv_up(\d+)\.weight$", k))
    )
    upscale = 2 ** len(ups)
    scale, rem = divmod(upscale, unshuffle)
    if rem:
        raise ValueError(
            f"upsampler x{upscale} not divisible by unshuffle x{unshuffle}"
        )
    graph = make_rrdb_graph(scale=upscale, num_feat=num_feat,
                            num_grow=num_grow, num_rrdb=num_rrdb,
                            variant="esrgan", unshuffle=unshuffle)

    def conv_entry(torch_name, ours, first=False, last=False):
        w = _oihw_to_hwio(sd[f"{torch_name}.weight"])
        b = sd[f"{torch_name}.bias"]
        if first:
            w = _fold_bgr_first(w, block=unshuffle * unshuffle)
        if last:
            w, b = _fold_bgr_last(w, b, block=1)
        params[ours] = {"weight": w, "bias": b}

    params: Dict[str, Dict[str, Any]] = {}
    conv_entry("conv_first", "conv_first", first=True)
    for i in range(num_rrdb):
        for j in range(3):
            for k in range(1, 6):
                conv_entry(f"body.{i}.rdb{j + 1}.conv{k}", f"r{i}d{j}_c{k}")
    conv_entry("conv_body", "conv_trunk")
    for n, _ in enumerate(ups):
        conv_entry(f"conv_up{n + 1}", f"conv_up{2 ** n}")
    conv_entry("conv_hr", "conv_hr")
    conv_entry("conv_last", "conv_last", last=True)
    return Model(
        name=f"{scale}x_torch_rrdb", scale=scale, graph=graph,
        params=params, device=device, compute_dtype=compute_dtype,
    )


def _import_swinir(sd: Dict[str, np.ndarray], compute_dtype, device) -> Model:
    blocks: Dict[int, int] = {}
    for k in sd:
        m = _SWIN_TABLE_RE.match(k)
        if m:
            i, j = int(m.group(1)), int(m.group(2))
            blocks[i] = max(blocks.get(i, 0), j + 1)
    if sorted(blocks) != list(range(len(blocks))):
        raise ValueError(f"SwinIR layers {sorted(blocks)} are not 0..n-1")
    depths = [blocks[i] for i in range(len(blocks))]
    first = "layers.{}.residual_group.blocks.0."
    tables = [sd[first.format(i) + "attn.relative_position_bias_table"]
              for i in range(len(depths))]
    num_heads = [int(t.shape[1]) for t in tables]
    window = (math.isqrt(int(tables[0].shape[0])) + 1) // 2
    if (2 * window - 1) ** 2 != tables[0].shape[0]:
        raise ValueError(f"bias table of {tables[0].shape[0]} rows is no "
                         "(2w-1)^2")
    dim = int(sd["conv_first.weight"].shape[0])
    hidden = int(sd[first.format(0) + "mlp.fc1.weight"].shape[0])
    if "layers.0.conv.4.weight" not in sd:
        raise ValueError("SwinIR import takes resi_connection='3conv' only")
    if "conv_before_upsample.0.weight" not in sd or "conv_up1.weight" not in sd:
        raise ValueError("SwinIR import takes upsampler='nearest+conv' only")
    if sd["conv_first.weight"].shape[1] != 3:
        raise ValueError("SwinIR import takes 3-channel models only")
    scale = 4 if "conv_up2.weight" in sd else 2
    num_feat = int(sd["conv_before_upsample.0.weight"].shape[0])
    graph = make_swinir_graph(scale=scale, embed_dim=dim, depths=depths,
                              num_heads=num_heads, window_size=window,
                              mlp_ratio=hidden / dim, num_feat=num_feat)
    params: Dict[str, Dict[str, Any]] = {
        "mean": {"data": np.asarray(SWINIR_RGB_MEAN[::-1], np.float32)}}

    def conv(torch_name, ours, first=False, last=False):
        w = _oihw_to_hwio(sd[f"{torch_name}.weight"])
        b = sd[f"{torch_name}.bias"]
        if first:
            w = _fold_bgr_first(w)
        if last:
            w, b = _fold_bgr_last(w, b, block=1)
        params[ours] = {"weight": w, "bias": b}

    def linear(torch_name, ours):  # (out, in) -> a 1x1 conv's HWIO
        params[ours] = {"weight": sd[f"{torch_name}.weight"].T[None, None],
                        "bias": sd[f"{torch_name}.bias"]}

    def norm(torch_name, ours):
        params[ours] = {"gamma": sd[f"{torch_name}.weight"],
                        "beta": sd[f"{torch_name}.bias"]}

    conv("conv_first", "conv_first", first=True)
    norm("patch_embed.norm", "patch_norm")
    for i, depth in enumerate(depths):
        for j in range(depth):
            pre, tag = f"layers.{i}.residual_group.blocks.{j}.", f"l{i}b{j}"
            norm(pre + "norm1", f"{tag}_norm1")
            linear(pre + "attn.qkv", f"{tag}_qkv")
            params[f"{tag}_table"] = {
                "data": sd[pre + "attn.relative_position_bias_table"]}
            linear(pre + "attn.proj", f"{tag}_proj")
            norm(pre + "norm2", f"{tag}_norm2")
            linear(pre + "mlp.fc1", f"{tag}_fc1")
            linear(pre + "mlp.fc2", f"{tag}_fc2")
        for k in (0, 2, 4):
            conv(f"layers.{i}.conv.{k}", f"l{i}_conv{k}")
    norm("norm", "norm")
    for k in (0, 2, 4):
        conv(f"conv_after_body.{k}", f"after_body{k}")
    conv("conv_before_upsample.0", "conv_before_upsample")
    for k in range(1, 2 if scale == 2 else 3):
        conv(f"conv_up{k}", f"conv_up{k}")
    conv("conv_hr", "conv_hr")
    conv("conv_last", "conv_last", last=True)
    return Model(
        name=f"{scale}x_torch_swinir", scale=scale, graph=graph,
        params=params, device=device, compute_dtype=compute_dtype,
    )


_IMPORTERS = {"srvgg": _import_srvgg, "rrdb": _import_rrdb,
              "swinir": _import_swinir}


def import_torch_checkpoint(
    path_or_state: Any, compute_dtype: torch.dtype = torch.bfloat16,
    device: "torch.device | str" = "cpu",
) -> Model:
    """Load a ``.pth`` checkpoint (path or already-loaded object) as a
    :class:`Model` on ``device`` in the framework's BGR model domain."""
    obj = path_or_state
    if isinstance(obj, (str, os.PathLike)):
        obj = torch.load(obj, map_location="cpu", weights_only=True)
    sd = _extract_state_dict(obj)
    arch = detect_arch(sd)
    if arch == "rrdb_old":
        sd = _translate_old_esrgan(sd)
        arch = "rrdb"
    model = _IMPORTERS[arch](sd, compute_dtype, device)
    log.info(
        "imported torch %s checkpoint: %s (scale %dx, %d layers)",
        arch, model.name, model.scale, len(model.graph.layers),
    )
    return model
