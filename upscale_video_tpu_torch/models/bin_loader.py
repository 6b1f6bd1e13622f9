"""Loader for ncnn ``.bin`` weight files -> numpy arrays keyed by layer name.

Host copy of ``upscale_video_tpu/models/bin_loader.py`` (same code, jax-free
either way; the original is reachable only through a package that imports
JAX).  ``synthesize_weights`` must stay byte-identical to the original:
``tests/test_torch_host.py`` pins it.  The port converts these HWIO numpy
arrays to device tensors in :func:`upscale_video_tpu_torch.models.zoo.params_from_jax`.

The reference loads weights through ``net.load_model(...bin)`` in the ncnn
C++ engine (reference: upscale/upscale_processing.py:71).  This is a
from-scratch reimplementation of the on-disk format, reverse-checked against
the shipped model zoo: for ``2x_Compact_Pretrain.bin`` the byte count
decomposes exactly as ``sum(4 + align4(2*weight_count))`` over Convolution
layers (fp16 tag 0x01306B47) plus raw fp32 biases and PReLU slopes.

Tagged weight blocks (ncnn "auto" storage, used for conv weights):

- 4-byte little-endian tag, then payload:
  - ``0x00000000``: raw float32
  - ``0x01306B47``: float16, padded to 4-byte alignment
  - ``0x000D4B38``: int8 (quantized inference; not supported here)
  - ``0x0002C056``: raw float32 (alternate tag)
  - anything else: uint8 indices into a 1024-byte (256 x f32) dequant table

Untagged blocks (biases, PReLU slopes, LayerNorm's gamma and beta,
MemoryData) are raw float32.

Weights are returned in **HWIO layout** (kh, kw, in_ch, out_ch) — the native
layout for NHWC convolutions on TPU — converted from ncnn's flattened
(out_ch, in_ch, kh, kw) storage.
"""

from __future__ import annotations

import struct
from typing import Dict, Optional

import numpy as np

from upscale_video_tpu_torch.models.param_parser import NcnnGraph, NcnnLayer

TAG_F32 = 0x00000000
TAG_F16 = 0x01306B47
TAG_I8 = 0x000D4B38
TAG_F32_ALT = 0x0002C056


def _align4(n: int) -> int:
    return (n + 3) & ~3


class _BinReader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def read_raw_f32(self, count: int) -> np.ndarray:
        end = self.pos + count * 4
        if end > len(self.data):
            raise ValueError(f"bin underrun: need {end}, have {len(self.data)}")
        out = np.frombuffer(self.data, dtype="<f4", count=count, offset=self.pos)
        self.pos = end
        return out.astype(np.float32)

    def read_tagged(self, count: int) -> np.ndarray:
        (tag,) = struct.unpack_from("<I", self.data, self.pos)
        self.pos += 4
        if tag in (TAG_F32, TAG_F32_ALT):
            return self.read_raw_f32(count)
        if tag == TAG_F16:
            nbytes = _align4(count * 2)
            out = np.frombuffer(self.data, dtype="<f2", count=count, offset=self.pos)
            self.pos += nbytes
            return out.astype(np.float32)
        if tag == TAG_I8:
            raise NotImplementedError("int8 ncnn weights are not supported")
        # uint8 quantized with 256-entry dequant table
        table = np.frombuffer(self.data, dtype="<f4", count=256, offset=self.pos)
        self.pos += 1024
        idx = np.frombuffer(self.data, dtype=np.uint8, count=count, offset=self.pos)
        self.pos += _align4(count)
        return table[idx].astype(np.float32)

    @property
    def remaining(self) -> int:
        return len(self.data) - self.pos


def _conv_weight_to_hwio(flat: np.ndarray, out_ch: int, in_ch: int, kh: int, kw: int) -> np.ndarray:
    w = flat.reshape(out_ch, in_ch, kh, kw)
    return np.ascontiguousarray(w.transpose(2, 3, 1, 0))  # HWIO


def _infer_conv_in_channels(layer: NcnnLayer) -> Optional[int]:
    out_ch = layer.attr_i(0)
    kw = layer.attr_i(1, 0)
    kh = layer.attr_i(11, kw)
    wsize = layer.attr_i(6)
    denom = out_ch * kh * kw
    if denom == 0 or wsize % denom:
        return None
    return wsize // denom


def _memorydata_shape(layer: NcnnLayer) -> tuple:
    """A MemoryData's ``(c, h, w)`` (attrs 2, 1, 0), less the sizes that
    are 0."""
    return tuple(layer.attr_i(k) for k in (2, 1, 0) if layer.attr_i(k))


def load_weights(graph: NcnnGraph, data: bytes, strict: bool = True) -> Dict[str, Dict[str, np.ndarray]]:
    """Read a .bin byte string against ``graph``; returns params pytree.

    ``params[layer_name]`` maps:
      - Convolution / Deconvolution: ``{"weight": HWIO f32, "bias": [O] f32?}``
      - ConvolutionDepthWise: ``{"weight": HWIO-grouped, "bias"}``
      - PReLU: ``{"slope": [C] f32}``
      - InnerProduct: ``{"weight": [in, out] f32, "bias": [out]?}``
      - LayerNorm (affine): ``{"gamma": [C] f32, "beta": [C] f32}``, raw
      - MemoryData: ``{"data": (c, h, w) f32}`` (sizes 0 dropped), raw

    With ``strict=True`` raises if trailing bytes remain unconsumed.
    """
    r = _BinReader(data)
    params: Dict[str, Dict[str, np.ndarray]] = {}

    for layer in graph.layers:
        if layer.type in ("Convolution", "Deconvolution"):
            out_ch = layer.attr_i(0)
            kw = layer.attr_i(1)
            kh = layer.attr_i(11, kw)
            wsize = layer.attr_i(6)
            in_ch = _infer_conv_in_channels(layer)
            if in_ch is None:
                raise ValueError(f"{layer.name}: cannot infer input channels")
            flat = r.read_tagged(wsize)
            entry: Dict[str, np.ndarray] = {}
            if layer.type == "Deconvolution":
                # ncnn stores deconv weights as (in, out, kh, kw) flattened
                w = flat.reshape(in_ch, out_ch, kh, kw).transpose(2, 3, 0, 1)
                entry["weight"] = np.ascontiguousarray(w)
            else:
                entry["weight"] = _conv_weight_to_hwio(flat, out_ch, in_ch, kh, kw)
            if layer.attr_i(5):
                entry["bias"] = r.read_raw_f32(out_ch)
            params[layer.name] = entry
        elif layer.type == "ConvolutionDepthWise":
            out_ch = layer.attr_i(0)
            kw = layer.attr_i(1)
            kh = layer.attr_i(11, kw)
            wsize = layer.attr_i(6)
            group = layer.attr_i(7, 1)
            flat = r.read_tagged(wsize)
            entry = {"weight": flat.copy(), "group": np.array(group)}
            if layer.attr_i(5):
                entry["bias"] = r.read_raw_f32(out_ch)
            params[layer.name] = entry
        elif layer.type == "PReLU":
            n = layer.attr_i(0, 1)
            params[layer.name] = {"slope": r.read_raw_f32(n)}
        elif layer.type == "InnerProduct":
            out_n = layer.attr_i(0)
            wsize = layer.attr_i(2)
            flat = r.read_tagged(wsize)
            in_n = wsize // out_n
            params[layer.name] = {"weight": flat.reshape(out_n, in_n).T.copy()}
            if layer.attr_i(1):
                params[layer.name]["bias"] = r.read_raw_f32(out_n)
        elif layer.type == "LayerNorm" and layer.attr_i(2, 1):
            n = layer.attr_i(0)
            params[layer.name] = {"gamma": r.read_raw_f32(n),
                                  "beta": r.read_raw_f32(n)}
        elif layer.type == "MemoryData":
            dims = _memorydata_shape(layer)
            if dims:
                params[layer.name] = {
                    "data": r.read_raw_f32(int(np.prod(dims))).reshape(dims)}
        # all other layer types carry no weights

    if strict and r.remaining:
        raise ValueError(f"{r.remaining} unconsumed bytes in .bin")
    return params


def load_weights_file(graph: NcnnGraph, path: str, strict: bool = True):
    with open(path, "rb") as f:
        return load_weights(graph, f.read(), strict=strict)


def synthesize_weights(
    graph: NcnnGraph, seed: int = 0, scale: float = 0.05
) -> Dict[str, Dict[str, np.ndarray]]:
    """Random weights matching ``graph``'s shapes (for tests and FLOP-true
    benchmarking when real ``.bin`` files are unavailable, e.g. the
    ``4x_Valar_v1.bin`` blob absent from the reference snapshot)."""
    rng = np.random.default_rng(seed)
    params: Dict[str, Dict[str, np.ndarray]] = {}
    for layer in graph.layers:
        if layer.type == "Convolution":
            out_ch = layer.attr_i(0)
            kw = layer.attr_i(1)
            kh = layer.attr_i(11, kw)
            in_ch = _infer_conv_in_channels(layer)
            entry = {
                "weight": rng.normal(0, scale, (kh, kw, in_ch, out_ch)).astype(np.float32)
            }
            if layer.attr_i(5):
                entry["bias"] = rng.normal(0, scale, (out_ch,)).astype(np.float32)
            params[layer.name] = entry
        elif layer.type == "PReLU":
            n = layer.attr_i(0, 1)
            params[layer.name] = {
                "slope": rng.uniform(0.1, 0.3, (n,)).astype(np.float32)
            }
    return params


def emit_bin(
    graph: NcnnGraph,
    params: Dict[str, Dict[str, np.ndarray]],
    tag: int = TAG_F16,
) -> bytes:
    """Serialize params back into ncnn .bin bytes (test fixture generator).

    Inverse of :func:`load_weights` for the Convolution, PReLU, LayerNorm
    and MemoryData subset; used to synthesize loader test fixtures without
    copying reference binaries, and by ``vsr-import-torch``.
    """
    out = bytearray()
    for layer in graph.layers:
        if layer.type == "Convolution":
            entry = params[layer.name]
            w = entry["weight"]  # HWIO
            flat = np.ascontiguousarray(w.transpose(3, 2, 0, 1)).reshape(-1)
            out += struct.pack("<I", tag)
            if tag == TAG_F16:
                payload = flat.astype("<f2").tobytes()
                out += payload + b"\x00" * (_align4(len(payload)) - len(payload))
            elif tag in (TAG_F32, TAG_F32_ALT):
                out += flat.astype("<f4").tobytes()
            else:
                raise ValueError(f"unsupported emit tag {tag:#x}")
            if "bias" in entry:
                out += entry["bias"].astype("<f4").tobytes()
        elif layer.type == "PReLU":
            out += params[layer.name]["slope"].astype("<f4").tobytes()
        elif layer.type in ("LayerNorm", "MemoryData") \
                and layer.name in params:
            for v in params[layer.name].values():  # gamma, beta; data
                out += np.asarray(v).astype("<f4").tobytes()
    return bytes(out)
