"""The generic ncnn op set the graph walk runs outside its kernels' plans
(the RRDBNet graphs outside their dense blocks and conv plans; the 1x anime
model's shuffle, resize and skip add; whatever else a ``vsr-import`` graph
holds).

Port of ``upscale_video_tpu/models/executor.py:42-333`` (``OP_REGISTRY``):
each op takes ``(layer, inputs, p, compute_dtype)`` as its JAX counterpart
does, with NHWC tensors, and ``p`` is the layer's weight module from
:func:`upscale_video_tpu_torch.models.zoo.params_from_jax` (``wmat`` in the
compute dtype, ``bias`` f32; ``wflat`` for a ConvolutionDepthWise).

A Convolution here is an ``F.conv2d`` in f32 (TF32 off) from compute-dtype
operands, + the f32 bias and its fused activation in f32, rounded once to
the compute dtype (``_op_convolution``).  The graph walk reaches it only
for convs no kernel plan claims: 1x1 and strided convs, and under f32 (the
CPU parity path) every conv; under bf16 every SAME 3x3 stride-1 conv is a
K4 launch planned in :mod:`upscale_video_tpu_torch.models.executor`.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from upscale_video_tpu_torch.models.param_parser import NcnnLayer
from upscale_video_tpu_torch.ops.conv_chain import no_tf32

# CHW axis -> NHWC axis (Concat attribute 0)
_CHW_TO_NHWC = {0: 3, 1: 1, 2: 2}


def apply_activation(x: torch.Tensor, act_type: int,
                     act_params: Sequence[float]) -> torch.Tensor:
    """ncnn fused conv activations: 0 none, 1 relu, 2 leaky(slope), 3
    clip(min, max), 4 sigmoid, 5 mish, 6 hardswish (``_apply_activation``,
    executor.py:42)."""
    if act_type == 0:
        return x
    if act_type == 1:
        return torch.clamp_min(x, 0)
    if act_type == 2:
        return torch.where(x >= 0, x, x * _scalar(act_params[0], x))
    if act_type == 3:
        return torch.clamp(x, act_params[0], act_params[1])
    if act_type == 4:
        return torch.sigmoid(x)
    if act_type == 5:
        return x * torch.tanh(F.softplus(x))
    if act_type == 6:
        return x * torch.clamp(x * act_params[0] + act_params[1], 0.0, 1.0)
    raise NotImplementedError(f"activation type {act_type}")


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


def same_pads(size: int, k: int, s: int, d: int):
    """XLA's ``padding="SAME"`` along one axis: ``ceil(size / s)`` outputs,
    the total pad split with the odd pixel at the bottom/right."""
    total = max((-(-size // s) - 1) * s + (k - 1) * d + 1 - size, 0)
    return total // 2, total - total // 2


def _conv(layer, x, w_oihw, bias, compute_dtype, groups=1):
    """f32 conv over compute-dtype operands + bias + activation, rounded
    once to the compute dtype.  ncnn's ``4=-233`` (SAME_UPPER) pads as
    XLA's SAME, as the JAX executor does."""
    kh, kw, stride, dil, pads = conv_geometry(layer)
    if pads[2] == -233:
        pads = (*same_pads(x.shape[1], kh, stride[0], dil[0]),
                *same_pads(x.shape[2], kw, stride[1], dil[1]))
    xin = x.to(compute_dtype).to(torch.float32).permute(0, 3, 1, 2)
    xin = F.pad(xin, (pads[2], pads[3], pads[0], pads[1]))
    with no_tf32():
        y = F.conv2d(xin, w_oihw.to(compute_dtype).to(torch.float32),
                     stride=stride, dilation=dil, groups=groups)
    y = y.permute(0, 2, 3, 1)
    if bias is not None:
        y = y + bias.to(torch.float32)
    y = apply_activation(y, layer.attr_i(9, 0), layer.attr(10, []))
    return y.to(compute_dtype)


def op_convolution(layer: NcnnLayer, inputs, p, compute_dtype):
    (x,) = inputs
    kh, kw = conv_geometry(layer)[:2]
    cin, cout = p.wmat.shape[0] // (kh * kw), p.wmat.shape[1]
    w = p.wmat.reshape(kh, kw, cin, cout).permute(3, 2, 0, 1)
    return _conv(layer, x, w, p.bias, compute_dtype)


def op_convolution_depthwise(layer: NcnnLayer, inputs, p, compute_dtype):
    """ncnn ConvolutionDepthWise: ``group`` blocks of (out/g, in/g, kh, kw)
    weights, which is ``F.conv2d``'s grouped OIHW layout
    (``_op_convolution_depthwise``, executor.py:107)."""
    (x,) = inputs
    group = layer.attr_i(7, 1)
    kh, kw = conv_geometry(layer)[:2]
    cout, cin = layer.attr_i(0), x.shape[-1]
    w = p.wflat.reshape(cout, cin // group, kh, kw)
    return _conv(layer, x, w, getattr(p, "bias", None), compute_dtype, group)


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


def op_reorg(layer: NcnnLayer, inputs, p, compute_dtype):
    """ncnn Reorg (attr 0 stride r), space-to-depth in torch
    ``pixel_unshuffle`` order: channel ``c`` at pixel ``(y*r + i, x*r + j)``
    lands in channel ``c*r*r + i*r + j`` (``_op_reorg``, executor.py:299)."""
    (x,) = inputs
    r = layer.attr_i(0, 1)
    if r == 1:
        return x
    n, h, w, c = x.shape
    x = x.reshape(n, h // r, r, w // r, r, c).permute(0, 1, 3, 5, 2, 4)
    return x.reshape(n, h // r, w // r, c * r * r)


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    """Keys' cubic kernel with a = -0.5 (``jax.image``'s; torch's bicubic
    takes -0.75)."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out).astype(np.float32)


def _triangle(x: np.ndarray) -> np.ndarray:
    return np.maximum(0.0, 1.0 - np.abs(x)).astype(np.float32)


def resize_weights(size_in: int, size_out: int, kernel) -> np.ndarray:
    """The (size_in, size_out) f32 sampling matrix of ``jax.image.resize``
    along one axis (``compute_weight_mat`` with no translation and
    antialiasing on): half-pixel centres, the kernel widened by the
    downscale factor, columns normalised, samples outside the input zero."""
    f32 = np.float32
    inv = f32(1.0 / (size_out / size_in))
    sample = (np.arange(size_out, dtype=f32) + f32(0.5)) * inv - f32(0.5)
    dist = np.abs(sample[None, :] - np.arange(size_in, dtype=f32)[:, None])
    w = kernel(dist / max(inv, f32(1.0)))
    total = w.sum(axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, 1), 0.0)
    inside = (sample >= -0.5) & (sample <= size_in - 0.5)
    return np.where(inside[None, :], w, 0.0).astype(f32)


@functools.lru_cache(maxsize=256)
def resize_weights_on(size_in: int, size_out: int, kernel,
                      device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """:func:`resize_weights` rounded to ``dtype`` and held in f32 on
    ``device``, made once per ``(size_in, size_out, kernel, device,
    dtype)``: a blocking host-to-device copy at every resize would
    synchronise the host with the device inside each step."""
    return (torch.from_numpy(resize_weights(size_in, size_out, kernel))
            .to(device, dtype).float())


def _resize(x: torch.Tensor, out_h: int, out_w: int, kernel) -> torch.Tensor:
    """``jax.image.resize`` with a separable kernel: one contraction per
    resized axis.  f32 keeps f32 weights throughout.  Lower precisions take
    what JAX's einsum does: weights in the input's dtype, the two axes in
    the order with fewer multiply-adds in all (its path optimiser's
    choice), each contraction summed in f32 and rounded to the input's
    dtype."""
    n, h, w, c = x.shape
    axes = []
    if out_h != h:
        axes.append(("nhwc,ho->nowc", h, out_h))
    if out_w != w:
        axes.append(("nhwc,wo->nhoc", w, out_w))
    if (x.dtype != torch.float32 and len(axes) == 2
            and h * out_w * (w + out_h) < w * out_h * (h + out_w)):
        axes.reverse()  # H then W costs w*oh*(h+ow), W then H h*ow*(w+oh)
    y = x
    for eq, size_in, size_out in axes:
        wt = resize_weights_on(size_in, size_out, kernel, x.device, x.dtype)
        y = torch.einsum(eq, y.float(), wt).to(x.dtype)
    return y


def op_interp(layer: NcnnLayer, inputs, p, compute_dtype):
    """ncnn Interp (``_op_interp``, executor.py:180).  Nearest: integer
    scales as a repeat, else the floor map ``src = (dst * h) // out_h``;
    bilinear (2) and bicubic (3) as ``jax.image.resize``."""
    (x,) = inputs
    rtype = layer.attr_i(0, 0)
    n, h, w, c = x.shape
    out_h = layer.attr_i(3, 0) or int(h * layer.attr_f(1, 1.0))
    out_w = layer.attr_i(4, 0) or int(w * layer.attr_f(2, 1.0))
    if (out_h, out_w) == (h, w):
        return x
    if rtype == 2:
        return _resize(x, out_h, out_w, _triangle)
    if rtype == 3:
        return _resize(x, out_h, out_w, _keys_cubic)
    if rtype not in (0, 1):
        raise NotImplementedError(f"Interp resize_type {rtype}")
    if out_h % h == 0 and out_w % w == 0:
        return (x.repeat_interleave(out_h // h, dim=1)
                .repeat_interleave(out_w // w, dim=2))
    ys = torch.clamp((torch.arange(out_h, device=x.device) * h) // out_h, 0, h - 1)
    xs = torch.clamp((torch.arange(out_w, device=x.device) * w) // out_w, 0, w - 1)
    return x[:, ys][:, :, xs]


def _scalar(v: float, like: torch.Tensor) -> torch.Tensor:
    """A coefficient in ``like``'s dtype, as ``jnp.asarray(v, dtype)``: a
    bf16 operand is multiplied by bf16(v), not by an f32 scalar.  It stays a
    0-dim host tensor, which a CUDA op takes by value: made on the device,
    its blocking copy would synchronise the host with the device at every
    residual of a step."""
    return torch.tensor(v, dtype=like.dtype)


_BINARY_OPS = {
    0: torch.add,
    1: torch.sub,
    2: torch.mul,
    3: torch.div,
    4: torch.maximum,
    5: torch.minimum,
    6: torch.pow,
    7: lambda a, b: b - a,
    8: lambda a, b: b / a,
}


def op_binaryop(layer: NcnnLayer, inputs, p, compute_dtype):
    """ncnn BinaryOp (attr 0 op, attr 1 with_scalar, attr 2 the scalar)
    (``_op_binaryop``, executor.py:226)."""
    op = _BINARY_OPS[layer.attr_i(0, 0)]
    if layer.attr_i(1, 0):
        return op(inputs[0], _scalar(layer.attr_f(2), inputs[0]))
    a, b = inputs
    return op(a, b)


def op_eltwise(layer: NcnnLayer, inputs, p, compute_dtype):
    """ncnn Eltwise: 0 prod, 1 sum (optional coefficients), 2 max
    (``_op_eltwise``, executor.py:234)."""
    op = layer.attr_i(0, 0)
    coeffs = layer.attr(1, [])
    out = inputs[0]
    if op == 0:
        for t in inputs[1:]:
            out = out * t
        return out
    if op == 2:
        for t in inputs[1:]:
            out = torch.maximum(out, t)
        return out
    if op != 1:
        raise NotImplementedError(f"Eltwise op {op}")
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


def op_relu(layer: NcnnLayer, inputs, p, compute_dtype):
    """ReLU, leaky when attr 0 (the slope) is set (``_op_relu``, :278)."""
    (x,) = inputs
    slope = layer.attr_f(0, 0.0)
    if slope:
        return torch.where(x >= 0, x, x * _scalar(slope, x))
    return torch.clamp_min(x, 0)


def op_clip(layer: NcnnLayer, inputs, p, compute_dtype):
    return torch.clamp(inputs[0], layer.attr_f(0, -3.4e38), layer.attr_f(1, 3.4e38))


def op_sigmoid(layer: NcnnLayer, inputs, p, compute_dtype):
    return torch.sigmoid(inputs[0])


def op_dropout(layer: NcnnLayer, inputs, p, compute_dtype):
    scale = layer.attr_f(0, 1.0)
    return inputs[0] if scale == 1.0 else inputs[0] * _scalar(scale, inputs[0])


OP_REGISTRY: Dict[str, Callable] = {
    "Input": op_identity,
    "Split": op_split,
    "Convolution": op_convolution,
    "ConvolutionDepthWise": op_convolution_depthwise,
    "PReLU": op_prelu,
    "PixelShuffle": op_pixelshuffle,
    "Interp": op_interp,
    "BinaryOp": op_binaryop,
    "Eltwise": op_eltwise,
    "Concat": op_concat,
    "ReLU": op_relu,
    "Clip": op_clip,
    "Sigmoid": op_sigmoid,
    "Dropout": op_dropout,
    "Noop": op_identity,
    "Reorg": op_reorg,
}
