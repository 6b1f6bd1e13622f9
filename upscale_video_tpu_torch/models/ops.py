"""The generic ncnn op set the graph walk runs outside its kernels' plans
(the Valar graph outside its dense blocks; the 1x anime model's shuffle,
resize and skip add).

Port of ``upscale_video_tpu/models/executor.py:42-104, 151-267``: each op
takes ``(layer, inputs, p, compute_dtype)`` as its JAX counterpart does,
with NHWC tensors, and ``p`` is the layer's weight module from
:func:`upscale_video_tpu_torch.models.zoo.params_from_jax` (``wmat`` in
the compute dtype, ``bias`` f32).

A Convolution computes in f32 from compute-dtype operands, adds the f32
bias, applies its fused activation in f32 and rounds once to the compute
dtype (``_op_convolution``).  A SAME 3x3 stride-1 conv goes through K1's
single-layer launch (:func:`~upscale_video_tpu_torch.ops.conv_chain.conv3x3_chain`),
which computes exactly that; any other conv is an ``F.conv2d`` in f32
with TF32 off.  Neither path rounds anywhere the JAX path does not.
"""

from __future__ import annotations

from typing import Callable, Dict, Sequence

import torch
import torch.nn.functional as F

from upscale_video_tpu_torch.models.param_parser import NcnnLayer
from upscale_video_tpu_torch.ops.common import ACT_LEAKY, ACT_NONE, ACT_RELU
from upscale_video_tpu_torch.ops.conv_chain import (
    ChainLayer, conv3x3_chain, no_tf32,
)

# CHW axis -> NHWC axis (Concat attribute 0)
_CHW_TO_NHWC = {0: 3, 1: 1, 2: 2}
_ACT_CODES = {0: ACT_NONE, 1: ACT_RELU, 2: ACT_LEAKY}


def apply_activation(x: torch.Tensor, act_type: int,
                     act_params: Sequence[float]) -> torch.Tensor:
    """ncnn fused conv activations 0 none, 1 relu, 2 leaky(slope)
    (``_apply_activation``, executor.py:42)."""
    if act_type == 0:
        return x
    if act_type == 1:
        return torch.clamp_min(x, 0)
    if act_type == 2:
        slope = torch.tensor(act_params[0], dtype=x.dtype, device=x.device)
        return torch.where(x >= 0, x, x * slope)
    raise NotImplementedError(f"activation type {act_type} is not ported")


def conv_geometry(layer: NcnnLayer):
    """``(kh, kw, (sh, sw), (dh, dw), (pad_t, pad_b, pad_l, pad_r))``."""
    kw = layer.attr_i(1)
    kh = layer.attr_i(11, kw)
    sw = layer.attr_i(3, 1)
    sh = layer.attr_i(13, sw)
    dw = layer.attr_i(2, 1)
    dh = layer.attr_i(12, dw)
    pad_l = layer.attr_i(4, 0)
    pad_t = layer.attr_i(14, pad_l)
    pad_r = layer.attr_i(15, pad_l)
    pad_b = layer.attr_i(16, pad_t)
    return kh, kw, (sh, sw), (dh, dw), (pad_t, pad_b, pad_l, pad_r)


def k1_layer(layer: NcnnLayer, p) -> ChainLayer:
    """A SAME 3x3 conv's weights and fused activation as K1's one layer."""
    act = layer.attr_i(9, 0)
    slope = torch.full((p.wmat.shape[1],), float(layer.attr(10, [0.0])[0])
                       if act == 2 else 0.0,
                       dtype=torch.float32, device=p.wmat.device)
    return ChainLayer(p.wmat, p.bias, slope, _ACT_CODES[act])


def op_convolution(layer: NcnnLayer, inputs, p, compute_dtype):
    (x,) = inputs
    kh, kw, stride, dil, pads = conv_geometry(layer)
    act = layer.attr_i(9, 0)
    if act not in _ACT_CODES:
        raise NotImplementedError(f"{layer.name}: activation type {act}")
    cin, cout = p.wmat.shape[0] // (kh * kw), p.wmat.shape[1]
    if (kh, kw, stride, dil, pads) == (3, 3, (1, 1), (1, 1), (1, 1, 1, 1)) \
            and cin <= 128 and cout <= 128 and p.wmat.dtype == compute_dtype:
        return conv3x3_chain(x.to(compute_dtype).contiguous(),
                             [k1_layer(layer, p)])
    if pads[0] == -233:
        raise NotImplementedError(f"{layer.name}: SAME_UPPER auto-pad")
    w = (p.wmat.to(torch.float32).reshape(kh, kw, cin, cout)
         .permute(3, 2, 0, 1))
    xin = x.to(compute_dtype).to(torch.float32).permute(0, 3, 1, 2)
    xin = F.pad(xin, (pads[2], pads[3], pads[0], pads[1]))
    with no_tf32():
        y = F.conv2d(xin, w, stride=stride, dilation=dil)
    y = y.permute(0, 2, 3, 1) + p.bias.to(torch.float32)
    y = apply_activation(y, act, layer.attr(10, []))
    return y.to(compute_dtype)


def op_prelu(layer: NcnnLayer, inputs, p, compute_dtype):
    """Per-channel PReLU in the input's dtype (``_op_prelu``, executor.py:151)."""
    (x,) = inputs
    slope = p.slope.to(x.dtype)
    return torch.where(x >= 0, x, x * slope)


def op_pixelshuffle(layer: NcnnLayer, inputs, p, compute_dtype):
    """ncnn PixelShuffle (attr 0 factor r, attr 1 mode) over NHWC: mode 0
    takes channel ``c*r*r + i*r + j`` to pixel ``(y*r + i, x*r + j)``,
    mode 1 channel ``(i*r + j)*c_out + c`` (``_op_pixelshuffle``, :157)."""
    (x,) = inputs
    r = layer.attr_i(0, 1)
    if r == 1:
        return x
    n, h, w, c_in = x.shape
    c_out = c_in // (r * r)
    if layer.attr_i(1, 0) == 0:
        x = x.reshape(n, h, w, c_out, r, r).permute(0, 1, 4, 2, 5, 3)
    else:
        x = x.reshape(n, h, w, r, r, c_out).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, h * r, w * r, c_out)


def op_interp(layer: NcnnLayer, inputs, p, compute_dtype):
    """Nearest ncnn Interp: integer scales as a repeat, else the floor map
    ``src = (dst * h) // out_h`` (``_op_interp``, executor.py:180)."""
    (x,) = inputs
    rtype = layer.attr_i(0, 0)
    n, h, w, c = x.shape
    out_h = layer.attr_i(3, 0) or int(h * layer.attr_f(1, 1.0))
    out_w = layer.attr_i(4, 0) or int(w * layer.attr_f(2, 1.0))
    if (out_h, out_w) == (h, w):
        return x
    if rtype not in (0, 1):
        raise NotImplementedError(f"Interp resize_type {rtype} is not ported")
    if out_h % h == 0 and out_w % w == 0:
        return (x.repeat_interleave(out_h // h, dim=1)
                .repeat_interleave(out_w // w, dim=2))
    ys = torch.clamp((torch.arange(out_h, device=x.device) * h) // out_h, 0, h - 1)
    xs = torch.clamp((torch.arange(out_w, device=x.device) * w) // out_w, 0, w - 1)
    return x[:, ys][:, :, xs]


def _scalar(v: float, like: torch.Tensor) -> torch.Tensor:
    """A coefficient in ``like``'s dtype, as ``jnp.asarray(v, dtype)``: a
    bf16 operand is multiplied by bf16(v), not by an f32 scalar."""
    return torch.tensor(v, dtype=like.dtype, device=like.device)


def op_binaryop(layer: NcnnLayer, inputs, p, compute_dtype):
    """ncnn BinaryOp add of two blobs (``_op_binaryop`` op 0)."""
    if layer.attr_i(0, 0) != 0 or layer.attr_i(1, 0):
        raise NotImplementedError(
            f"{layer.name}: BinaryOp op {layer.attr_i(0, 0)} "
            f"(with_scalar={layer.attr_i(1, 0)}) is not ported")
    a, b = inputs
    return a + b


def op_eltwise(layer: NcnnLayer, inputs, p, compute_dtype):
    """ncnn Eltwise sum, with optional coefficients (``_op_eltwise`` op 1)."""
    if layer.attr_i(0, 0) != 1:
        raise NotImplementedError(
            f"{layer.name}: Eltwise op {layer.attr_i(0, 0)} is not ported")
    coeffs = layer.attr(1, [])
    out = inputs[0]
    if coeffs:
        out = out * _scalar(coeffs[0], out)
        for t, c in zip(inputs[1:], coeffs[1:]):
            out = out + t * _scalar(c, t)
        return out
    for t in inputs[1:]:
        out = out + t
    return out


def op_concat(layer: NcnnLayer, inputs, p, compute_dtype):
    return torch.cat(list(inputs), dim=_CHW_TO_NHWC[layer.attr_i(0, 0)])


def op_split(layer: NcnnLayer, inputs, p, compute_dtype):
    return [inputs[0]] * len(layer.outputs)


def op_identity(layer: NcnnLayer, inputs, p, compute_dtype):
    return inputs[0]


OP_REGISTRY: Dict[str, Callable] = {
    "Input": op_identity,
    "Split": op_split,
    "Noop": op_identity,
    "Convolution": op_convolution,
    "PReLU": op_prelu,
    "PixelShuffle": op_pixelshuffle,
    "Interp": op_interp,
    "BinaryOp": op_binaryop,
    "Eltwise": op_eltwise,
    "Concat": op_concat,
}
